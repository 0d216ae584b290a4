"""Texture atlas sampling for mesh materials (BASELINE config 3).

The reference has no texture machinery at all — its vendored
tiny_obj_loader.h parses ``map_Kd`` into ``material_t::diffuse_texname``
(include/tiny_obj_loader.h) but nothing consumes it, and its ``Material``
(object.h:28-33) is a flat color.  This module activates that latent
capability as batched array programs:

- every texture image is padded into one device-resident atlas
  ``(NT, TH, TW, 3)`` uploaded once with the scene (no per-frame I/O),
- texture fetches are batched XLA gathers over the whole ray wavefront
  (one fused gather per bounce, not per-lane pointer chasing),
- sampling is bilinear with wrap (repeat) addressing in the same
  convention as tinyobj/OpenGL: ``v`` points up, texel centers at
  half-integer coordinates.

``ops/intersect.find_closest_hit`` interpolates the winning triangle's UVs
and fetches the atlas for textured scenes (``Scene.has_textures``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def interpolate_uv(uv6: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Barycentric UV interpolation.

    ``uv6``: (B, 6) per-triangle vertex UVs ``[u0,v0,u1,v1,u2,v2]``;
    ``u, v``: (B,) Moller-Trumbore barycentrics (weight of v1 and v2).
    Returns (B, 2).
    """
    w0 = 1.0 - u - v
    iu = w0 * uv6[:, 0] + u * uv6[:, 2] + v * uv6[:, 4]
    iv = w0 * uv6[:, 1] + u * uv6[:, 3] + v * uv6[:, 5]
    return jnp.stack([iu, iv], axis=-1)


def sample_bilinear(atlas: jnp.ndarray, size: jnp.ndarray,
                    tex_id: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear texture fetch.

    ``atlas``: (NT, TH+1, TW+1, 3) float32 in [0, 1], each texture
    occupying the top-left ``size[t] = (h, w)`` texels of its slice PLUS
    a one-texel wrapped border (row h = row 0, col w = col 0 — built by
    the scene loader).  The border lets the whole 2x2 footprint come from
    ONE ``lax.gather`` per ray instead of four independent taps — the
    taps were the dominant cost of a textured bounce (169 -> 71 ms per
    2.07M-ray wavefront on a v5e chip) — while keeping exact wrap
    addressing at the seam;
    ``tex_id``: (B,) int32 (callers mask id < 0 themselves);
    ``uv``: (B, 2) wrap-addressed.
    Returns (B, 3) linear RGB.
    """
    t = jnp.clip(tex_id, 0, atlas.shape[0] - 1)
    h = size[t, 0].astype(jnp.float32)
    w = size[t, 1].astype(jnp.float32)
    # wrap to [0,1); flip v (image row 0 is the top, uv v=0 the bottom)
    fu = uv[:, 0] - jnp.floor(uv[:, 0])
    fv = uv[:, 1] - jnp.floor(uv[:, 1])
    x = fu * w - 0.5
    y = (1.0 - fv) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    ax = (x - x0)[:, None]
    ay = (y - y0)[:, None]

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), jnp.maximum(n.astype(jnp.int32), 1))

    # footprint start (wrapped into [0, n-1]); +1 lands in the border copy
    x0i = wrap(x0, w)
    y0i = wrap(y0, h)
    starts = jnp.stack([t, y0i, x0i], axis=-1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2, 3), collapsed_slice_dims=(0,),
        start_index_map=(0, 1, 2))
    quad = jax.lax.gather(atlas, starts, dn, (1, 2, 2, 3),
                          mode=jax.lax.GatherScatterMode.CLIP)  # (B,2,2,3)
    top = quad[:, 0, 0] * (1 - ax) + quad[:, 0, 1] * ax
    bot = quad[:, 1, 0] * (1 - ax) + quad[:, 1, 1] * ax
    return top * (1 - ay) + bot * ay
