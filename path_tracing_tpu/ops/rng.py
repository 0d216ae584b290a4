"""Counter-based RNG streams (Threefry via jax.random).

Replaces the reference's per-thread curand state arrays seeded from
``time(NULL)`` (pt_cu.cu:10-15,282; bdpt_cu.cu:6-11,597,634;
ppm_cu.cu:10-15,358), which made every render irreproducible
(SURVEY.md quirk 15).  Here every random number is a pure function of
``(seed, stream, iteration, lane)`` so renders are bit-reproducible and
shards can draw independent, overlap-free streams without any state.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Stream ids keep the integrators' draws decorrelated.
STREAM_PT = 1
STREAM_BDPT_LIGHT = 2
STREAM_BDPT_EYE = 3
STREAM_PPM_EYE = 4
STREAM_PPM_PHOTON = 5
STREAM_ORACLE_LIGHT = 6
STREAM_ORACLE_EYE = 7


def make_key(seed: int, stream: int) -> jax.Array:
    return jax.random.fold_in(jax.random.PRNGKey(seed), stream)


def iter_key(key: jax.Array, iteration) -> jax.Array:
    """Per-scan-iteration subkey (safe inside lax.scan: fold_in is traceable)."""
    return jax.random.fold_in(key, iteration)


def uniforms(key: jax.Array, shape, n: int):
    """Draw ``n`` independent uniform arrays of ``shape`` on (0, 1].

    curand_uniform's support is (0, 1] (zero excluded); jax.random.uniform's
    is [0, 1).  The reference's math divides by and takes acos of these draws
    assuming 0 never occurs, so we map ``u -> 1 - u`` for parity.
    """
    u = jax.random.uniform(key, shape=(n,) + tuple(shape), dtype=jnp.float32)
    u = 1.0 - u
    return tuple(u[i] for i in range(n))


def _windowed_ok(key) -> bool:
    """The windowed path mirrors jax's PARTITIONABLE threefry bit layout
    (element (j, i) of ``uniform(key, (n, total))`` is a pure function of
    the flat 64-bit counter ``j*total + i``).  Any other configuration
    falls back to generate-then-slice."""
    if not jax.config.jax_threefry_partitionable:
        return False
    try:
        impl = jax.random.key_impl(key)
        return "threefry" in str(impl)
    except Exception:  # raw uint32[2] legacy key arrays
        return False


def uniforms_g(key: jax.Array, P: int, n: int, start=0,
               total: int | None = None):
    """Global-counter variant of :func:`uniforms` for mesh-invariant lanes.

    The ``P`` lanes are rows ``[start, start+P)`` of a GLOBAL ``total``-lane
    draw: a shard draws bit-identical values to the matching slice of the
    ``(n, total)`` Threefry array a single-device run draws, which is what
    makes sharded renders per-pixel bit-exact against single-device
    (``__graft_entry__`` gate / tests/test_sharding.py).  ``total=None``
    reproduces ``uniforms(key, (P,), n)`` exactly (the unsharded path is
    unchanged).

    Under jax's default PARTITIONABLE threefry the window is generated
    directly from its own counters — O(P) work per shard instead of the
    O(total) generate-then-slice (review r5; pinned bit-equal to the
    slice form by tests/test_rng.py).  ``start`` may be traced
    (``mesh_linear_index * P`` inside ``shard_map``).  Mesh-rounding pad
    lanes (``start + i >= total``) draw counters that alias the next
    row's prefix; callers already gate those lanes off.
    """
    if total is None:
        return uniforms(key, (P,), n)
    threefry2x32_p = None
    if _windowed_ok(key) and n * total < 2**32:
        try:  # private jax API: fall through to the slice path if it moves
            from jax._src.prng import threefry2x32_p
        except ImportError:
            pass
    if threefry2x32_p is not None:
        kd = jax.random.key_data(key).astype(jnp.uint32)
        lanes = jnp.uint32(start) + jnp.arange(P, dtype=jnp.uint32)
        rows = (jnp.arange(n, dtype=jnp.uint32)
                * jnp.uint32(total))[:, None]
        flat = rows + lanes[None, :]                    # (n, P) counters
        hi = jnp.zeros_like(flat)                       # flat < 2^32
        o1, o2 = threefry2x32_p.bind(kd[0], kd[1], hi, flat)
        bits = o1 ^ o2
        fb = (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
        u = jax.lax.bitcast_convert_type(fb, jnp.float32) - 1.0
        u = 1.0 - u
        return tuple(u[i] for i in range(n))
    u = jax.random.uniform(key, shape=(n, total), dtype=jnp.float32)
    u = 1.0 - u
    W = ((total + P - 1) // P) * P
    if W > total:
        u = jnp.pad(u, ((0, 0), (0, W - total)), constant_values=1.0)
    u = jax.lax.dynamic_slice_in_dim(u, start, P, axis=1)
    return tuple(u[i] for i in range(n))
