"""Batched 3-vector math on ``(..., 3)`` arrays.

Batched replacement for the reference's float3 operator set
(reference ``include/geometric.cuh:90-112``).  All functions are pure,
broadcast over leading batch dimensions, and are safe to use inside ``jit`` /
``lax.scan`` (no data-dependent shapes, no Python branching on traced values).
"""
from __future__ import annotations

import jax.numpy as jnp

EPSILON = 1e-4  # geometric.cuh:6
PI = 3.14159265358979323846


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis. geometric.cuh:95"""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product. geometric.cuh:96"""
    return jnp.cross(a, b)


def length(a: jnp.ndarray) -> jnp.ndarray:
    """Euclidean norm over the trailing axis. geometric.cuh:97"""
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Unit vector; mirrors raw division in geometric.cuh:98 (no epsilon)."""
    return a / length(a)[..., None]


def safe_normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Unit vector with a tiny floor so unselected `where` branches never NaN."""
    return a / jnp.maximum(length(a), eps)[..., None]


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of incident direction ``i`` about normal ``n``.

    geometric.cuh:99 (GLSL convention: ``i`` points toward the surface).
    """
    return i - n * (2.0 * dot(n, i))[..., None]


def refract(i: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction; returns 0 on total internal reflection.

    geometric.cuh:102-107.
    """
    dot_ni = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - dot_ni * dot_ni)
    refr = i * eta[..., None] - n * (eta * dot_ni + jnp.sqrt(jnp.maximum(k, 0.0)))[..., None]
    return jnp.where((k < 0.0)[..., None], 0.0, refr)


def is_valid_color(c: jnp.ndarray) -> jnp.ndarray:
    """NaN/Inf/negative rejection mask (True = valid). geometric.cuh:223-227."""
    bad = jnp.isnan(c) | jnp.isinf(c) | (c < 0.0)
    return ~jnp.any(bad, axis=-1)


def clamp_radiance(c: jnp.ndarray, max_val: float) -> jnp.ndarray:
    """Firefly clamp: scale so the max channel is <= max_val. geometric.cuh:229-235."""
    max_channel = jnp.max(c, axis=-1)
    scale = jnp.where(max_channel > max_val, max_val / max_channel, 1.0)
    return c * scale[..., None]


def vmax3(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(c, axis=-1)


def any_positive(c: jnp.ndarray) -> jnp.ndarray:
    """True where any RGB channel is > 0 (the reference's `x>0 || y>0 || z>0`)."""
    return jnp.any(c > 0.0, axis=-1)
