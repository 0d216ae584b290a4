"""pbrt-v4-style BSDF: evaluate / pdf / sample.

Batched, branch-free (mask-selected) re-architecture of the reference's
``bsdf_evaluate`` (geometric.cuh:419-456), ``bsdf_pdf`` (:458-484) and
``bsdf_sample`` (:486-562).  Every lane evaluates all three sampling branches
(smooth dielectric, smooth conductor, rough mix) and selects with ``where`` —
the idiomatic way to keep XLA fusing elementwise work instead of diverging
like the CUDA megakernels do.

Semantic notes preserved from the reference (these matter for RMSE parity):
- smooth dielectrics (eta>0, roughness<0.001) have zero eval/pdf (delta),
- the rough lobe is a 50/50 (or 100% if metallic>0) mix of cosine-diffuse and
  GGX-VNDF, with the pdf mixed the same way,
- the conductor-delta branch requires metallic>0.99 AND roughness<0.001,
- the dielectric-delta branch additionally requires metallic<0.01,
- dielectric refraction tracks the current medium eta and assumes exiting
  into air (new_eta = 1.0), geometric.cuh:520.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp

from ..scene.types import Material
from .frame import (abs_cos_theta, build_local_frame, cos2_theta, cos_theta,
                    local_to_world, world_to_local)
from .fresnel import fr_dielectric, fr_schlick
from .math3 import PI, dot, normalize, safe_normalize
from .microfacet import (roughness_to_alpha, sample_tr_visible_normal, tr_d,
                         tr_g, tr_g1)


class BsdfSample(NamedTuple):
    wi: jnp.ndarray        # (..., 3) sampled world-space direction
    value: jnp.ndarray     # (..., 3) BSDF value (delta lobes: weight/|cos|)
    pdf: jnp.ndarray       # (...,)   solid-angle pdf (delta lobes: lobe prob)
    is_delta: jnp.ndarray  # (...,)   bool
    new_eta: jnp.ndarray   # (...,)   medium IOR after the event


def _half_vector(wo: jnp.ndarray, wi: jnp.ndarray):
    wh_vec = wo + wi
    wh_len = jnp.sqrt(jnp.sum(wh_vec * wh_vec, axis=-1))
    wh = wh_vec / jnp.maximum(wh_len, 1e-20)[..., None]
    wh = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    valid = wh_len >= 1e-6
    return wh, valid


def _eval_local(mtl: Material, wo, wi, alpha, wh, wh_valid) -> jnp.ndarray:
    """bsdf_evaluate's local-space core (geometric.cuh:419-456)."""
    zero_cos = (cos_theta(wo) == 0.0) | (cos_theta(wi) == 0.0)
    smooth_dielectric = (mtl.eta > 0.0) & (mtl.roughness < 0.001)

    same_side = wo[..., 2] * wi[..., 2] > 0.0
    diffuse = mtl.base_color / PI * (1.0 - mtl.metallic)[..., None]
    diffuse = jnp.where((wo[..., 2] * wi[..., 2] < 0.0)[..., None], 0.0, diffuse)

    d = tr_d(wh, alpha)
    g = tr_g(wo, wi, alpha)

    f_schlick = fr_schlick(abs_cos_theta(wo), mtl.base_color)
    fr = fr_dielectric(dot(wo, wh), 1.0, mtl.eta)
    f = jnp.where((mtl.metallic > 0.0)[..., None], f_schlick, fr[..., None])

    denom = jnp.maximum(4.0 * abs_cos_theta(wo) * abs_cos_theta(wi), 1e-4)
    specular = f * (d * g / denom)[..., None]

    out = jnp.where(same_side[..., None], diffuse + specular, diffuse)
    kill = zero_cos | smooth_dielectric | ~wh_valid
    return jnp.where(kill[..., None], 0.0, out)


def _pdf_local(mtl: Material, wo, wi, alpha, wh, wh_valid) -> jnp.ndarray:
    """bsdf_pdf's local-space core (geometric.cuh:458-484)."""
    opposite = cos_theta(wo) * cos_theta(wi) <= 0.0
    smooth_dielectric = (mtl.eta > 0.0) & (mtl.roughness < 0.001)

    pdf_diffuse = abs_cos_theta(wi) / PI
    g1 = tr_g1(wo, alpha)
    pdf_wh = tr_d(wh, alpha) * g1 * jnp.maximum(0.0, dot(wo, wh)) / jnp.maximum(
        abs_cos_theta(wo), 1e-20)
    pdf_specular = pdf_wh / (4.0 * dot(wo, wh) + 1e-7)

    spec_weight = jnp.where(mtl.metallic > 0.0, 1.0, 0.5)
    pdf = (1.0 - spec_weight) * pdf_diffuse + spec_weight * pdf_specular
    kill = opposite | smooth_dielectric | ~wh_valid
    return jnp.where(kill, 0.0, pdf)


def _to_local(mtl, wo_w, wi_w, n):
    t, b = build_local_frame(n)
    wo = world_to_local(wo_w, t, b, n)
    wi = world_to_local(wi_w, t, b, n)
    alpha = roughness_to_alpha(mtl.roughness)
    wh, wh_valid = _half_vector(wo, wi)
    return wo, wi, alpha, wh, wh_valid


def bsdf_evaluate(mtl: Material, wo_w: jnp.ndarray, wi_w: jnp.ndarray,
                  n: jnp.ndarray) -> jnp.ndarray:
    """f(wo, wi): diffuse*(1-metallic)/pi + GGX specular. geometric.cuh:419-456."""
    wo, wi, alpha, wh, wh_valid = _to_local(mtl, wo_w, wi_w, n)
    return _eval_local(mtl, wo, wi, alpha, wh, wh_valid)


def bsdf_pdf(mtl: Material, wo_w: jnp.ndarray, wi_w: jnp.ndarray,
             n: jnp.ndarray) -> jnp.ndarray:
    """Solid-angle pdf of `bsdf_sample`'s rough branch. geometric.cuh:458-484."""
    wo, wi, alpha, wh, wh_valid = _to_local(mtl, wo_w, wi_w, n)
    return _pdf_local(mtl, wo, wi, alpha, wh, wh_valid)


def bsdf_eval_pdf(mtl: Material, wo_w: jnp.ndarray, wi_w: jnp.ndarray,
                  n: jnp.ndarray):
    """Fused evaluate + pdf sharing one local-frame/half-vector build.

    The hot loops (NEE, BDPT connections) need both; building the frame and
    wh twice costs as much as the whole microfacet math.
    """
    wo, wi, alpha, wh, wh_valid = _to_local(mtl, wo_w, wi_w, n)
    return (_eval_local(mtl, wo, wi, alpha, wh, wh_valid),
            _pdf_local(mtl, wo, wi, alpha, wh, wh_valid))


def bsdf_sample(mtl: Material, wo_w: jnp.ndarray, n: jnp.ndarray,
                u_rr: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray,
                current_eta: jnp.ndarray) -> BsdfSample:
    """Sample an outgoing direction.  geometric.cuh:486-562.

    Three branches evaluated for every lane, selected by material masks:

    1. smooth dielectric (delta): Fresnel-weighted reflect/refract, tracks the
       medium IOR through ``current_eta``/``new_eta`` (geometric.cuh:500-528),
    2. smooth conductor (delta): mirror with Schlick weight (:530-537),
    3. rough: VNDF-or-cosine lobe by ``spec_weight`` (:539-561).
    """
    t, b = build_local_frame(n)
    wo = world_to_local(wo_w, t, b, n)

    m_dielectric = (mtl.eta > 0.0) & (mtl.roughness < 0.001) & (mtl.metallic < 0.01)
    m_conductor = ~m_dielectric & (mtl.metallic > 0.99) & (mtl.roughness < 0.001)
    is_delta = m_dielectric | m_conductor

    # ---- branch 1: smooth dielectric ------------------------------------
    f = fr_dielectric(cos_theta(wo), current_eta, mtl.eta)
    reflect_l = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)

    entering = cos_theta(wo) > 0.0
    eta_ratio = jnp.where(entering, current_eta / mtl.eta, mtl.eta / current_eta)
    sin2_i = jnp.maximum(0.0, 1.0 - cos2_theta(wo))
    sin2_t = eta_ratio * eta_ratio * sin2_i
    tir = sin2_t >= 1.0
    cos_t_refr = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    cos_t_refr = jnp.where(entering, -cos_t_refr, cos_t_refr)
    refract_l = jnp.stack(
        [-eta_ratio * wo[..., 0], -eta_ratio * wo[..., 1], cos_t_refr], axis=-1)

    take_reflect = u_rr < f
    diel_wi = jnp.where(take_reflect[..., None], reflect_l, refract_l)
    diel_abs_cos = jnp.maximum(jnp.abs(diel_wi[..., 2]), 1e-20)
    diel_pdf = jnp.where(take_reflect, f, 1.0 - f)
    refr_val = mtl.base_color * ((1.0 - f) / diel_abs_cos)[..., None]
    refl_val = (f / diel_abs_cos)[..., None] * jnp.ones_like(mtl.base_color)
    diel_val = jnp.where(take_reflect[..., None], refl_val, refr_val)
    # TIR reaching the refract branch is a measure-zero event in the
    # reference (F==1 there); kill the lane cleanly instead of using garbage.
    refr_dead = ~take_reflect & tir
    diel_pdf = jnp.where(refr_dead, 0.0, diel_pdf)
    diel_val = jnp.where(refr_dead[..., None], 0.0, diel_val)
    diel_new_eta = jnp.where(
        take_reflect, current_eta, jnp.where(entering, mtl.eta, jnp.ones_like(mtl.eta)))

    # ---- branch 2: smooth conductor --------------------------------------
    cond_wi = reflect_l
    cond_val = fr_schlick(abs_cos_theta(wo), mtl.base_color) / jnp.maximum(
        jnp.abs(cond_wi[..., 2]), 1e-20)[..., None]
    cond_pdf = jnp.ones_like(f)

    # ---- branch 3: rough (VNDF specular or cosine diffuse) ---------------
    alpha = roughness_to_alpha(mtl.roughness)
    spec_weight = jnp.where(mtl.metallic > 0.0, 1.0, 0.5)

    wo_up = jnp.where((wo[..., 2] > 0.0)[..., None], wo, -wo)
    wh = sample_tr_visible_normal(wo_up, alpha, u1, u2)
    wh = jnp.where((wo[..., 2] < 0.0)[..., None], -wh, wh)
    spec_wi = -wo - wh * (2.0 * dot(wh, -wo))[..., None]  # reflect(-wo, wh)
    spec_bad = wo[..., 2] * spec_wi[..., 2] <= 0.0

    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    diff_wi = jnp.stack(
        [r * jnp.cos(phi), r * jnp.sin(phi),
         jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))], axis=-1)
    diff_wi = jnp.where((wo[..., 2] < 0.0)[..., None],
                        diff_wi * jnp.array([1.0, 1.0, -1.0]), diff_wi)

    take_spec = u_rr < spec_weight
    rough_wi_l = jnp.where(take_spec[..., None], spec_wi, diff_wi)
    rough_dead = take_spec & spec_bad
    # evaluate + pdf directly in the already-built local frame
    wh_r, wh_r_valid = _half_vector(wo, rough_wi_l)
    rough_pdf = jnp.where(
        rough_dead, 0.0,
        _pdf_local(mtl, wo, rough_wi_l, alpha, wh_r, wh_r_valid))
    rough_val = jnp.where(
        rough_dead[..., None], 0.0,
        _eval_local(mtl, wo, rough_wi_l, alpha, wh_r, wh_r_valid))

    # ---- select ----------------------------------------------------------
    wi_l = jnp.where(m_dielectric[..., None], diel_wi,
                     jnp.where(m_conductor[..., None], cond_wi, rough_wi_l))
    wi_w = local_to_world(wi_l, t, b, n)  # non-delta lanes: wi_l IS rough_wi_l
    value = jnp.where(m_dielectric[..., None], diel_val,
                      jnp.where(m_conductor[..., None], cond_val, rough_val))
    pdf = jnp.where(m_dielectric, diel_pdf,
                    jnp.where(m_conductor, cond_pdf, rough_pdf))
    new_eta = jnp.where(m_dielectric, diel_new_eta, current_eta)
    return BsdfSample(wi=wi_w, value=value, pdf=pdf, is_delta=is_delta,
                      new_eta=new_eta)
