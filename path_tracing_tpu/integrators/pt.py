"""Unidirectional path tracing with NEE + power-heuristic MIS.

Batched re-architecture of the reference's ``cuda_path_trace_kernel``
(reference ``src/pt_cu.cu:20-250``).  Instead of one CUDA thread per pixel
running an unbounded, divergent depth loop, every sample is a lane of a flat
batch and the bounce loop is a bounded ``lax`` loop with active-lane masks,
compiled once by XLA.

Semantics preserved for RMSE parity (each tagged with the reference line):
- light-ball hits convert flux to radiance as illum/(area*cone_ratio) with
  the depth==0 full-cone exception and the behind-the-cone zero
  (pt_cu.cu:59-102),
- the MIS "strategy A" branch (BSDF ray hits a light from a non-delta vertex)
  is a stub in the reference — ``pdf_light_dir`` stays 0 so it contributes
  nothing (pt_cu.cu:104-119, SURVEY.md quirk 2).  ``cfg.pt_stub_mis_strategy_a
  = False`` enables the fixed full-MIS estimator,
- NEE runs on surfaces with eta<=0 and (metallic<0.99 or roughness>0.01)
  (pt_cu.cu:125), samples lights uniformly, samples sphere lights uniformly
  on the surface with area->solid-angle pdf and squared power-heuristic MIS
  (pt_cu.cu:151-199); parallel lights use the no-pdf direct form
  (pt_cu.cu:130-149),
- delta bounces do not consume depth (pt_cu.cu:228); we budget
  ``cfg.delta_budget`` extra scan iterations instead of looping forever
  (quirk 11),
- every contribution is validity-checked and firefly-clamped at 15
  (pt_cu.cu:100,116,145,195).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import rng
from ..ops.bsdf import bsdf_eval_pdf, bsdf_evaluate, bsdf_pdf, bsdf_sample
from ..ops.intersect import find_closest_hit, shadow_factor
from ..ops.math3 import (EPSILON, PI, clamp_radiance, dot, is_valid_color,
                         normalize)
from ..ops.sampling import uniform_sphere_dir
from ..scene.camera import primary_ray_dirs
from ..scene.types import Camera, Scene


def _take_light(scene: Scene, li: jnp.ndarray):
    """Gather every field of light ``li`` per lane (exact row gathers)."""
    return dict(pos=scene.light_pos[li], dir=scene.light_dir[li],
                illum=scene.light_illum[li], cutoff=scene.light_cutoff[li],
                is_par=scene.light_is_parallel[li] != 0,
                r=scene.light_ball_r[li])


def _light_emission_radiance(scene: Scene, hit_pos, depth):
    """Flux -> radiance for a light-ball hit.  pt_cu.cu:59-94.

    Finds the first light whose ball surface matches the hit position within
    1e-2, computes area = 4*pi*r^2 and the spot-cone ratio (full cone at
    depth 0; zero behind the cone).  Returns (emission (B,3), matched light
    index (B,), valid (B,)).
    """
    nl = scene.num_lights
    c2h = hit_pos[:, None, :] - scene.light_pos[None, :, :]      # (B, Nl, 3)
    c2h_len = jnp.sqrt(jnp.sum(c2h * c2h, axis=-1))
    match = jnp.abs(c2h_len - scene.light_ball_r[None, :]) < 1e-2
    valid = jnp.any(match, axis=1)
    li = jnp.argmax(match, axis=1)                               # first match

    lt = _take_light(scene, li)
    r = lt["r"]
    area = 4.0 * PI * r * r
    cutoff = lt["cutoff"]
    is_par = lt["is_par"]
    spot = (cutoff > 0.0) & ~is_par

    main_dir = normalize(lt["dir"])
    c2h_sel = hit_pos - lt["pos"]
    c2h_dir = c2h_sel / jnp.maximum(
        jnp.sqrt(jnp.sum(c2h_sel * c2h_sel, axis=-1)), 1e-20)[:, None]
    behind = dot(main_dir, c2h_dir) < jnp.cos(cutoff)

    cone_ratio = jnp.where(spot, (1.0 - jnp.cos(cutoff)) / 2.0, 1.0)
    cone_ratio = jnp.where(spot & (depth == 0), 1.0, cone_ratio)
    cone_ratio = jnp.where(spot & (depth != 0) & behind, 0.0, cone_ratio)

    ok = valid & (cone_ratio > 0.0)
    emission = jnp.where(
        ok[:, None],
        lt["illum"] / jnp.maximum(area * cone_ratio, 1e-20)[:, None],
        0.0)
    return emission, li, ok


def _nee(scene: Scene, cfg: RenderConfig, hit, wo, throughput,
         u_pick, u1, u2):
    """Next-event estimation at a non-delta vertex.  pt_cu.cu:125-201.

    Returns the (unmasked) NEE radiance contribution per lane — INCLUDING
    the path ``throughput`` factor (``contrib = throughput * brdf * illum *
    ...``, pt_cu.cu:142-143 and :193-195), so callers validity-check/clamp
    the same quantity the reference does.  Callers gate by eligibility.
    """
    nl = scene.num_lights
    li = jnp.minimum((u_pick * nl).astype(jnp.int32), nl - 1)
    lt = _take_light(scene, li)
    l_pos, l_dir, l_illum = lt["pos"], lt["dir"], lt["illum"]
    l_cutoff, l_par, l_r = lt["cutoff"], lt["is_par"], lt["r"]

    # Both light kinds share one BSDF eval and ONE shadow-ray sweep by
    # selecting the sampled direction/endpoint first (the reference's two
    # branches, pt_cu.cu:130-149 and :151-199, fused per-lane).

    # parallel direction
    pdir = normalize(-l_dir)
    # sphere light: uniform surface point
    d_local = uniform_sphere_dir(u1, u2)
    lp = l_pos + d_local * l_r[:, None]
    wi_vec = lp - hit.pos
    dist2 = jnp.sum(wi_vec * wi_vec, axis=-1)
    dist = jnp.sqrt(dist2)
    wi_sph = wi_vec / jnp.maximum(dist, 1e-20)[:, None]

    wi = jnp.where(l_par[:, None], pdir, wi_sph)
    cos_surf = jnp.maximum(0.0, dot(hit.normal, wi))
    cos_light = jnp.maximum(0.0, dot(d_local, -wi_sph))
    inside_cone = l_par | jnp.where(
        l_cutoff > 0.0, dot(normalize(l_dir), -wi_sph) >= jnp.cos(l_cutoff),
        True)

    # single shadow sweep: parallel lights target a far point along wi
    p2 = jnp.where(l_par[:, None], hit.pos + pdir * 1e4,
                   lp + d_local * EPSILON)
    # (B,3): RGB when the scene carries legacy Ks materials, a broadcast
    # binary factor otherwise (geometric.cuh:293-325)
    tr = shadow_factor(scene, hit.pos + hit.normal * EPSILON, p2,
                       dielectrics_block=cfg.shadow_dielectrics_block)
    tr_pos = jnp.any(tr > 0.0, axis=-1)

    brdf, pdf_b = bsdf_eval_pdf(hit.mtl, wo, wi, hit.normal)

    # parallel-light contribution (no pdf/MIS, pt_cu.cu:142-143)
    contrib_par = (throughput * brdf * l_illum * tr
                   * (cos_surf * float(nl))[:, None])

    # sphere-light contribution with area->solid-angle pdf + squared power
    # heuristic (pt_cu.cu:179-192)
    area = 4.0 * PI * l_r * l_r
    pdf_area = 1.0 / (nl * area)
    pdf_light_dir = pdf_area * dist2 / jnp.maximum(cos_light, 1e-6)
    p_l = pdf_light_dir * pdf_light_dir
    p_b = pdf_b * pdf_b
    mis_w = p_l / jnp.maximum(p_l + p_b, 1e-8)
    contrib_sph = (throughput * brdf * l_illum * tr
                   * (cos_surf / pdf_light_dir * mis_w)[:, None])

    gate_par = (cos_surf > 0.0) & tr_pos
    gate_sph = ((cos_surf > 0.0) & (cos_light > 0.0) & inside_cone
                & tr_pos)
    return jnp.where(l_par[:, None],
                     jnp.where(gate_par[:, None], contrib_par, 0.0),
                     jnp.where(gate_sph[:, None], contrib_sph, 0.0))


def trace_paths(scene: Scene, cam: Camera, cfg: RenderConfig,
                px: jnp.ndarray, py: jnp.ndarray, key) -> jnp.ndarray:
    """Trace one camera path per lane; returns per-lane radiance (B, 3)."""
    B = px.shape[0]
    jx, jy = rng.uniforms(jax.random.fold_in(key, 0xC0FFEE), (B,), 2)
    rd0 = primary_ray_dirs(cam, px, py, jx, jy)
    ro0 = jnp.broadcast_to(cam.eye, (B, 3))

    state = dict(
        ro=ro0, rd=rd0,
        throughput=jnp.ones((B, 3)),
        radiance=jnp.zeros((B, 3)),
        eta=jnp.ones((B,)),
        depth=jnp.zeros((B,), jnp.int32),
        alive=jnp.ones((B,), bool),
        last_is_delta=jnp.ones((B,), bool),
        last_pdf=jnp.ones((B,)),
    )

    def body(state):
        it = state["it"]
        k = rng.iter_key(key, it)
        u = rng.uniforms(k, (B,), 6)
        hit = find_closest_hit(scene, state["ro"], state["rd"])
        act = state["alive"] & hit.hit
        wo = -state["rd"]

        # --- 1. BSDF ray hit a light ball (pt_cu.cu:59-121) ---
        emission, li, okl = _light_emission_radiance(
            scene, hit.pos, state["depth"])
        has_e = jnp.any(emission > 0.0, axis=-1)
        c_delta = state["throughput"] * emission
        c_delta = jnp.where(is_valid_color(c_delta)[:, None],
                            clamp_radiance(c_delta, cfg.clamp), 0.0)
        if cfg.pt_stub_mis_strategy_a:
            c_mis = jnp.zeros((B, 3))  # quirk 2: pdf_light_dir stays 0
        else:
            # fixed full MIS: light-direction pdf of the hit point
            r = scene.light_ball_r[li]
            area = 4.0 * PI * r * r
            cos_l = jnp.maximum(dot(hit.normal, wo), 1e-6)
            pdf_l = (1.0 / (scene.num_lights * area)) * hit.t * hit.t / cos_l
            p_b = state["last_pdf"] ** 2
            p_l = pdf_l ** 2
            mis_w = p_b / jnp.maximum(p_b + p_l, 1e-8)
            c_mis = state["throughput"] * emission * mis_w[:, None]
            c_mis = jnp.where((okl & is_valid_color(c_mis))[:, None],
                              clamp_radiance(c_mis, cfg.clamp), 0.0)
        light_contrib = jnp.where(state["last_is_delta"][:, None],
                                  c_delta, c_mis)
        add_light = act & hit.is_light & has_e
        radiance = state["radiance"] + jnp.where(
            add_light[:, None], light_contrib, 0.0)

        # lanes that hit a light terminate (pt_cu.cu:121)
        alive = state["alive"] & hit.hit & ~hit.is_light

        # --- 2. NEE (pt_cu.cu:125-201) ---
        elig = (act & ~hit.is_light & (hit.mtl.eta <= 0.0)
                & ((hit.mtl.metallic < 0.99) | (hit.mtl.roughness > 0.01)))
        if scene.num_lights > 0:
            nee = _nee(scene, cfg, hit, wo, state["throughput"],
                       u[0], u[1], u[2])
            nee = jnp.where(is_valid_color(nee)[:, None],
                            clamp_radiance(nee, cfg.clamp), 0.0)
            radiance = radiance + jnp.where(elig[:, None], nee, 0.0)

        # --- 3. BSDF sample & bounce (pt_cu.cu:204-241) ---
        s = bsdf_sample(hit.mtl, wo, hit.normal, u[3], u[4], u[5], state["eta"])
        dead = (s.pdf <= 0.0) & ~s.is_delta
        alive = alive & ~dead

        cos_wi = jnp.abs(dot(hit.normal, s.wi))
        tp_delta = state["throughput"] * s.value
        tp_rough = state["throughput"] * s.value * (
            cos_wi / jnp.maximum(s.pdf, 1e-20))[:, None]
        new_tp = jnp.where(s.is_delta[:, None], tp_delta, tp_rough)
        alive = alive & is_valid_color(new_tp)

        off = jnp.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                        -hit.normal, hit.normal) * EPSILON
        new_ro_delta = hit.pos + off
        new_ro_rough = hit.pos + hit.normal * EPSILON
        new_ro = jnp.where(s.is_delta[:, None], new_ro_delta, new_ro_rough)

        new_depth = state["depth"] + jnp.where(s.is_delta, 0, 1)
        alive = alive & (s.is_delta | (new_depth < cfg.eye_depth))

        upd = act[:, None]
        new_state = dict(
            it=it + 1,
            ro=jnp.where(upd, new_ro, state["ro"]),
            rd=jnp.where(upd, s.wi, state["rd"]),
            throughput=jnp.where(upd, new_tp, state["throughput"]),
            radiance=radiance,
            eta=jnp.where(act, s.new_eta, state["eta"]),
            depth=jnp.where(act, new_depth, state["depth"]),
            alive=jnp.where(act, alive, state["alive"] & hit.hit),
            last_is_delta=jnp.where(act, s.is_delta, state["last_is_delta"]),
            last_pdf=jnp.where(act & ~s.is_delta, s.pdf, state["last_pdf"]),
        )
        return new_state

    # early-exit bounce loop: a scan would run the delta-bounce budget at
    # full width even after every lane died (e.g. scenes with no delta
    # materials die by eye_depth); while_loop stops at the true path horizon
    state["it"] = jnp.zeros((), jnp.int32)
    state = jax.lax.while_loop(
        lambda s: (s["it"] < cfg.max_eye_iters) & jnp.any(s["alive"]),
        body, state)
    final = state["radiance"]
    # final whole-path validity check (pt_cu.cu:243)
    return jnp.where(is_valid_color(final)[:, None], final, 0.0)


def wavefront_pt(scene: Scene, cam: Camera, cfg: RenderConfig,
                 px: jnp.ndarray, py: jnp.ndarray, spp: int, key,
                 start=0, total: int | None = None) -> jnp.ndarray:
    """Wavefront PT with path regeneration: one persistent lane per pixel;
    when a lane's path terminates it immediately starts the pixel's next
    sample, so the batch stays ~fully occupied instead of burning full-width
    iterations on dead lanes (the reference megakernel's warps idle the same
    way its divergent threads do — this is the wavefront re-architecture
    SURVEY.md §2.2 calls for).  Returns the per-pixel radiance SUM over
    ``spp`` samples (callers divide).

    ``start``/``total``: these lanes are rows [start, start+B) of a GLOBAL
    ``total``-lane render — per-lane RNG comes from the global Threefry
    counters (``rng.uniforms_g``), so a sharded render is per-pixel
    bit-exact against single-device.  Defaults reproduce the unsharded
    call exactly.
    """
    B = px.shape[0]
    state = dict(
        it=jnp.zeros((), jnp.int32),
        image=jnp.zeros((B, 3)),
        sample=jnp.zeros((B,), jnp.int32),   # samples started so far
        path_it=jnp.zeros((B,), jnp.int32),  # iterations used by this path
        ro=jnp.broadcast_to(cam.eye, (B, 3)),
        rd=jnp.zeros((B, 3)),
        throughput=jnp.ones((B, 3)),
        radiance=jnp.zeros((B, 3)),
        eta=jnp.ones((B,)),
        depth=jnp.zeros((B,), jnp.int32),
        alive=jnp.zeros((B,), bool),
        last_is_delta=jnp.ones((B,), bool),
        last_pdf=jnp.ones((B,)),
    )
    # generous global cap; the while cond exits as soon as work runs dry
    max_total = spp * cfg.max_eye_iters + cfg.max_eye_iters
    def cond(s):
        return ((s["it"] < max_total)
                & (jnp.any(s["alive"]) | jnp.any(s["sample"] < spp)))

    def body(state):
        it = state["it"]
        k = rng.iter_key(key, it)
        u = rng.uniforms_g(k, B, 8, start, total)

        # ---- regenerate dead lanes that still owe samples ----
        regen = ~state["alive"] & (state["sample"] < spp)
        rd_new = primary_ray_dirs(cam, px, py, u[6], u[7])
        ro = jnp.where(regen[:, None], cam.eye[None], state["ro"])
        rd = jnp.where(regen[:, None], rd_new, state["rd"])
        throughput = jnp.where(regen[:, None], 1.0, state["throughput"])
        radiance = jnp.where(regen[:, None], 0.0, state["radiance"])
        eta = jnp.where(regen, 1.0, state["eta"])
        depth = jnp.where(regen, 0, state["depth"])
        path_it = jnp.where(regen, 0, state["path_it"])
        last_is_delta = jnp.where(regen, True, state["last_is_delta"])
        last_pdf = jnp.where(regen, 1.0, state["last_pdf"])
        sample = state["sample"] + regen.astype(jnp.int32)
        alive = state["alive"] | regen

        # ---- one bounce for every live lane ----
        hit = find_closest_hit(scene, ro, rd)
        act = alive & hit.hit
        wo = -rd

        emission, li, okl = _light_emission_radiance(scene, hit.pos, depth)
        has_e = jnp.any(emission > 0.0, axis=-1)
        c_delta = throughput * emission
        c_delta = jnp.where(is_valid_color(c_delta)[:, None],
                            clamp_radiance(c_delta, cfg.clamp), 0.0)
        if cfg.pt_stub_mis_strategy_a:
            c_mis = jnp.zeros((B, 3))  # quirk 2
        else:
            r = scene.light_ball_r[li]
            area = 4.0 * PI * r * r
            cos_l = jnp.maximum(dot(hit.normal, wo), 1e-6)
            pdf_l = (1.0 / (scene.num_lights * area)) * hit.t * hit.t / cos_l
            p_b = last_pdf ** 2
            p_l = pdf_l ** 2
            mis_w = p_b / jnp.maximum(p_b + p_l, 1e-8)
            c_mis = throughput * emission * mis_w[:, None]
            c_mis = jnp.where((okl & is_valid_color(c_mis))[:, None],
                              clamp_radiance(c_mis, cfg.clamp), 0.0)
        light_contrib = jnp.where(last_is_delta[:, None], c_delta, c_mis)
        add_light = act & hit.is_light & has_e
        radiance = radiance + jnp.where(add_light[:, None], light_contrib, 0.0)

        new_alive = alive & hit.hit & ~hit.is_light

        elig = (act & ~hit.is_light & (hit.mtl.eta <= 0.0)
                & ((hit.mtl.metallic < 0.99) | (hit.mtl.roughness > 0.01)))
        if scene.num_lights > 0:
            nee = _nee(scene, cfg, hit, wo, throughput, u[0], u[1], u[2])
            nee = jnp.where(is_valid_color(nee)[:, None],
                            clamp_radiance(nee, cfg.clamp), 0.0)
            radiance = radiance + jnp.where(elig[:, None], nee, 0.0)

        s = bsdf_sample(hit.mtl, wo, hit.normal, u[3], u[4], u[5], eta)
        dead = (s.pdf <= 0.0) & ~s.is_delta
        new_alive = new_alive & ~dead

        cos_wi = jnp.abs(dot(hit.normal, s.wi))
        tp_delta = throughput * s.value
        tp_rough = throughput * s.value * (
            cos_wi / jnp.maximum(s.pdf, 1e-20))[:, None]
        new_tp = jnp.where(s.is_delta[:, None], tp_delta, tp_rough)
        new_alive = new_alive & is_valid_color(new_tp)

        off = jnp.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                        -hit.normal, hit.normal) * EPSILON
        new_ro = jnp.where(s.is_delta[:, None], hit.pos + off,
                           hit.pos + hit.normal * EPSILON)
        new_depth = depth + jnp.where(s.is_delta, 0, 1)
        new_path_it = path_it + 1
        new_alive = new_alive & (s.is_delta | (new_depth < cfg.eye_depth)) \
            & (new_path_it < cfg.max_eye_iters)

        upd = act[:, None]
        alive_out = jnp.where(act, new_alive, alive & hit.hit)
        # ---- flush paths that terminated this iteration ----
        died = alive & ~alive_out
        final = jnp.where(is_valid_color(radiance)[:, None], radiance, 0.0)
        image = state["image"] + jnp.where(died[:, None], final, 0.0)
        radiance = jnp.where(died[:, None], 0.0, radiance)

        return dict(
            it=it + 1,
            image=image,
            sample=sample,
            path_it=jnp.where(act, new_path_it, path_it),
            ro=jnp.where(upd, new_ro, ro),
            rd=jnp.where(upd, s.wi, rd),
            throughput=jnp.where(upd, new_tp, throughput),
            radiance=radiance,
            eta=jnp.where(act, s.new_eta, eta),
            depth=jnp.where(act, new_depth, depth),
            alive=alive_out,
            last_is_delta=jnp.where(act, s.is_delta, last_is_delta),
            last_pdf=jnp.where(act & ~s.is_delta, s.pdf, last_pdf),
        )

    state = jax.lax.while_loop(cond, body, state)
    # paths cut by the global cap still contribute what they gathered
    leftover = jnp.where(
        (state["alive"] & is_valid_color(state["radiance"]))[:, None],
        state["radiance"], 0.0)
    return state["image"] + leftover


@partial(jax.jit, static_argnames=("width", "height", "spp", "cfg"))
def render_pt(scene: Scene, cam: Camera, width: int, height: int, spp: int,
              cfg: RenderConfig, key) -> jnp.ndarray:
    """Render one PT frame: mean radiance over ``spp`` paths/pixel, (H*W, 3).

    Equivalent of ``pt_render_wrapper`` (pt_cu.cu:255-297) minus its per-call
    scene re-upload — the Scene pytree is already device-resident — and
    re-architected as a regenerating wavefront (see ``wavefront_pt``).
    """
    B = width * height
    idx = jnp.arange(B, dtype=jnp.int32)
    px = idx % width
    py = idx // width
    return wavefront_pt(scene, cam, cfg, px, py, spp, key) / spp
