"""Fresnel terms: exact dielectric and Schlick approximation.

Batched equivalents of reference ``include/geometric.cuh:145-167``.
"""
from __future__ import annotations

import jax.numpy as jnp


def fr_dielectric(cos_theta_i: jnp.ndarray, eta_i, eta_t) -> jnp.ndarray:
    """Exact unpolarized dielectric Fresnel reflectance. geometric.cuh:145-160.

    Handles the "exiting" case by swapping eta_i/eta_t when cos_theta_i < 0,
    and returns 1.0 on total internal reflection.
    """
    cos_i = jnp.clip(cos_theta_i, -1.0, 1.0)
    eta_i = jnp.broadcast_to(jnp.asarray(eta_i, cos_i.dtype), cos_i.shape)
    eta_t = jnp.broadcast_to(jnp.asarray(eta_t, cos_i.dtype), cos_i.shape)
    entering = cos_i > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    cos_i = jnp.abs(cos_i)

    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_i * cos_i))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))

    r_parl = ((et * cos_i) - (ei * cos_t)) / ((et * cos_i) + (ei * cos_t))
    r_perp = ((ei * cos_i) - (et * cos_t)) / ((ei * cos_i) + (et * cos_t))
    fr = (r_parl * r_parl + r_perp * r_perp) / 2.0
    return jnp.where(tir, 1.0, fr)


def fr_schlick(cos_theta_i: jnp.ndarray, r0: jnp.ndarray) -> jnp.ndarray:
    """Schlick approximation with RGB F0 (``(..., 3)``). geometric.cuh:163-167."""
    c = jnp.maximum(0.0, 1.0 - cos_theta_i)
    c5 = c * c * c * c * c
    return r0 + (1.0 - r0) * c5[..., None]
