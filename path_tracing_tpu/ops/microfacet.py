"""Trowbridge-Reitz (GGX) microfacet model with VNDF sampling.

Batched equivalents of reference ``include/geometric.cuh:173-221``.
All directions are in the local shading frame (+z = normal).
"""
from __future__ import annotations

import jax.numpy as jnp

from .frame import abs_cos_theta, cos2_theta, tan2_theta, tan_theta
from .math3 import PI, cross, normalize


def roughness_to_alpha(roughness: jnp.ndarray) -> jnp.ndarray:
    """Perceptual roughness -> alpha (squared, floored at 1e-3). geometric.cuh:173-176."""
    x = jnp.maximum(roughness, 1e-3)
    return x * x


def tr_d(wh: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """GGX normal distribution D(wh). geometric.cuh:178-185.

    PARITY QUIRK: the reference computes the denominator as
    ``cos^4(theta) * (alpha^2 + tan^4(theta))`` (note ``tan2Theta*tan2Theta``
    at geometric.cuh:182) instead of textbook GGX's
    ``cos^4(theta) * (alpha^2 + tan^2(theta))^2``.  This D is therefore NOT
    normalized — analytically ``integral D cos dw = pi*alpha/2`` — and the
    VNDF pdf built from it does not integrate to 1 either.  Converged images
    depend on this shape, so we reproduce it exactly (see
    tests/test_math_core.py::test_ggx_d_reference_quirk_normalization).
    """
    t2 = tan2_theta(wh)
    cos4 = cos2_theta(wh) * cos2_theta(wh)
    e = cos4 * (alpha * alpha + t2 * t2)
    d = (alpha * alpha) / (PI * e)
    bad = jnp.isinf(t2) | (e < 1e-12)
    return jnp.where(bad, 0.0, d)


def tr_lambda(w: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Smith Lambda for GGX. geometric.cuh:187-192."""
    abs_tan = jnp.abs(tan_theta(w))
    a2t2 = (alpha * abs_tan) * (alpha * abs_tan)
    lam = (-1.0 + jnp.sqrt(1.0 + a2t2)) / 2.0
    return jnp.where(jnp.isinf(abs_tan), 0.0, lam)


def tr_g(wo: jnp.ndarray, wi: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Smith height-correlated-ish G (reference uses separable sum form).

    geometric.cuh:194-197.
    """
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_g1(w: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Masking term G1 used by the VNDF pdf. geometric.cuh:476."""
    return 1.0 / (1.0 + tr_lambda(w, alpha))


def sample_tr_visible_normal(wo: jnp.ndarray, alpha: jnp.ndarray,
                             u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Heitz VNDF sampling of a visible GGX microfacet normal.

    geometric.cuh:200-221.  ``wo`` must be in the upper hemisphere (callers
    flip it first, matching the reference's call site at geometric.cuh:545).
    """
    a = alpha[..., None]
    v = normalize(jnp.concatenate([a * wo[..., 0:1], a * wo[..., 1:2], wo[..., 2:3]], axis=-1))

    z_axis = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], wo.dtype), v.shape)
    x_axis = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], wo.dtype), v.shape)
    use_cross = (v[..., 2] < 0.9999)[..., None]
    # safe normalize: when use_cross is False the cross product may be ~0
    cz = cross(z_axis, v)
    cz_len = jnp.maximum(jnp.sqrt(jnp.sum(cz * cz, axis=-1, keepdims=True)), 1e-20)
    t1 = jnp.where(use_cross, cz / cz_len, x_axis)
    t2 = cross(v, t1)

    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2

    nh = (t1 * p1[..., None] + t2 * p2[..., None]
          + v * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[..., None])
    wh = jnp.concatenate(
        [a * nh[..., 0:1], a * nh[..., 1:2], jnp.maximum(0.0, nh[..., 2:3])], axis=-1)
    return normalize(wh)
