"""Local shading frames and pbrt-v4 local-space trigonometry.

Batched equivalents of reference ``include/geometric.cuh:119-142``.
All directions are ``(..., 3)``; local space puts the shading normal at +z.
"""
from __future__ import annotations

import jax.numpy as jnp

from .math3 import cross, dot, normalize


def build_local_frame(n: jnp.ndarray):
    """Tangent/bitangent for normal ``n``. geometric.cuh:119-123.

    Uses cross with +z unless |n.z| >= 0.999, then +y — matching the
    reference's branch exactly (selected per-lane with `where`).
    """
    z_axis = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], n.dtype), n.shape)
    y_axis = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], n.dtype), n.shape)
    use_z = (jnp.abs(n[..., 2]) < 0.999)[..., None]
    t = normalize(jnp.where(use_z, cross(z_axis, n), cross(y_axis, n)))
    b = cross(n, t)
    return t, b


def world_to_local(v: jnp.ndarray, t: jnp.ndarray, b: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """geometric.cuh:124-126"""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def local_to_world(v: jnp.ndarray, t: jnp.ndarray, b: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """geometric.cuh:127-133"""
    return (
        t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]
    )


# pbrt-v4 style local-space trig (geometric.cuh:136-142)
def cos_theta(w: jnp.ndarray) -> jnp.ndarray:
    return w[..., 2]


def cos2_theta(w: jnp.ndarray) -> jnp.ndarray:
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(w[..., 2])


def sin2_theta(w: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(sin2_theta(w))


def tan_theta(w: jnp.ndarray) -> jnp.ndarray:
    return sin_theta(w) / (cos_theta(w) + 1e-7)


def tan2_theta(w: jnp.ndarray) -> jnp.ndarray:
    return sin2_theta(w) / (cos2_theta(w) + 1e-7)
