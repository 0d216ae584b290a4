"""Batched ray-scene intersection and shadow transmittance.

Batched re-architecture of ``find_closest_hit`` (geometric.cuh:327-388),
``intersect_sphere`` (:240-259), ``intersect_triangle`` (:261-291) and
``check_visibility`` (:293-325).  Instead of a per-thread linear scan, every
ray tests every primitive as one ``(B, N)`` elementwise computation that XLA
fuses into its reductions, and the nearest hit is an argmin.

The reference scans spheres, then light balls, then triangles, keeping
strictly-closer hits (ties go to the earliest category); concatenating the
per-category ``t`` arrays in that order and taking ``argmin`` (first minimum
wins) reproduces the exact same tie-breaking.

Brute force matches the reference's GPU behavior (it ignores its AABB groups
entirely, SURVEY.md quirk 1).  A BVH path for large mesh scenes plugs in
behind the same API (see ops/bvh.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..scene.types import Material, Scene
from .math3 import EPSILON, cross, dot, normalize

INF = 1e20  # miss sentinel, matches best.t init (geometric.cuh:335)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass
class Hit:
    """Batched ``CudaHit`` (geometric.cuh:44-51)."""

    hit: jnp.ndarray       # (B,) bool
    t: jnp.ndarray         # (B,)
    pos: jnp.ndarray       # (B, 3)
    normal: jnp.ndarray    # (B, 3) flipped to face the ray
    mtl: Material          # (B, ...) light hits use Material.light_ball
    is_light: jnp.ndarray  # (B,) bool


def sphere_ts(ro, rd, centers, radii, max_dist) -> jnp.ndarray:
    """Per-(ray, sphere) hit distance or INF. geometric.cuh:240-259.

    ``ro, rd``: (B, 3); ``centers``: (N, 3); ``radii``: (N,);
    ``max_dist``: scalar or (B, 1).  Tries the near root first, then the far
    root — each must lie in (EPSILON, max_dist).
    """
    oc = ro[:, None, :] - centers[None, :, :]          # (B, N, 3)
    # an elementwise product summed over xyz, not a contraction: a float32
    # dot may run in TF32 on a GPU, which would round hit distances
    b = jnp.sum(oc * rd[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    h = b * b - c
    sh = jnp.sqrt(jnp.maximum(h, 0.0))
    t1 = -b - sh
    t2 = -b + sh
    ok = h >= 0.0
    v1 = ok & (t1 > EPSILON) & (t1 < max_dist)
    v2 = ok & (t2 > EPSILON) & (t2 < max_dist)
    return jnp.where(v1, t1, jnp.where(v2, t2, INF))


def triangle_ts(ro, rd, v0, v1, v2, max_dist) -> jnp.ndarray:
    """Per-(ray, triangle) Moller-Trumbore hit distance or INF.

    geometric.cuh:261-291 (same 1e-6 determinant window and EPSILON t-window).
    """
    e1 = (v1 - v0)[None, :, :]                          # (1, N, 3)
    e2 = (v2 - v0)[None, :, :]
    rdn = rd[:, None, :]                                # (B, 1, 3)
    h = jnp.cross(rdn, e2)                              # (B, N, 3)
    a = jnp.sum(e1 * h, axis=-1)
    parallel = (a > -1e-6) & (a < 1e-6)
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = ro[:, None, :] - v0[None, :, :]
    u = f * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, e1)
    v = f * jnp.sum(rdn * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)
    ok = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > EPSILON) & (t < max_dist))
    return jnp.where(ok, t, INF)


def find_closest_hit(scene: Scene, ro: jnp.ndarray, rd: jnp.ndarray) -> Hit:
    """Nearest hit over spheres, light balls and triangles. geometric.cuh:327-388."""
    B = ro.shape[0]
    ns, nl, nt = scene.num_spheres, scene.num_lights, scene.num_triangles

    if not (ns or nl or nt):
        zeros3 = jnp.zeros((B, 3))
        return Hit(hit=jnp.zeros(B, bool), t=jnp.full(B, INF), pos=zeros3,
                   normal=zeros3, mtl=Material.light_ball(zeros3),
                   is_light=jnp.zeros(B, bool))

    ts = []
    if ns:
        ts.append(sphere_ts(ro, rd, scene.sph_center, scene.sph_radius, INF))
    if nl:
        ts.append(sphere_ts(ro, rd, scene.light_pos, scene.light_ball_r, INF))
    if nt:
        ts.append(triangle_ts(ro, rd, scene.tri_v0, scene.tri_v1,
                              scene.tri_v2, INF))
    all_t = jnp.concatenate(ts, axis=1)             # (B, Ns+Nl+Nt)
    idx = jnp.argmin(all_t, axis=1)
    best_t = jnp.take_along_axis(all_t, idx[:, None], axis=1)[:, 0]
    hit = best_t < INF

    # combined per-primitive tables (built once per traced program; static)
    centers = jnp.concatenate(
        [scene.sph_center, scene.light_pos, jnp.zeros((nt, 3))], axis=0)
    tri_n = (normalize(cross(scene.tri_v1 - scene.tri_v0,
                             scene.tri_v2 - scene.tri_v0))
             if nt else jnp.zeros((0, 3)))
    tri_normals = jnp.concatenate(
        [jnp.zeros((ns + nl, 3)), tri_n], axis=0)
    mtl_table = jax.tree.map(
        lambda *xs: jnp.concatenate(xs, axis=0),
        scene.sph_mtl, Material.light_ball(scene.light_illum), scene.tri_mtl)
    is_light_table = jnp.concatenate(
        [jnp.zeros(ns, bool), jnp.ones(nl, bool), jnp.zeros(nt, bool)])
    is_tri_table = jnp.concatenate(
        [jnp.zeros(ns + nl, bool), jnp.ones(nt, bool)])

    pos = ro + rd * best_t[:, None]
    n_sphere = normalize(pos - centers[idx])
    normal = jnp.where(is_tri_table[idx][:, None], tri_normals[idx], n_sphere)
    # flip toward the ray (geometric.cuh:350,365,383)
    normal = jnp.where((dot(normal, rd) > 0.0)[:, None], -normal, normal)

    mtl = mtl_table.gather(idx)
    if scene.has_textures:
        # map_Kd modulation (ops/texture.py): recompute the winning
        # triangle's Moller-Trumbore barycentrics (B-sized, vs the (B, Nt)
        # sweep above), interpolate vertex UVs, bilinear-fetch the atlas
        from .texture import interpolate_uv, sample_bilinear

        ti = jnp.clip(idx - (ns + nl), 0, nt - 1)
        v0, v1, v2 = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]
        e1, e2 = v1 - v0, v2 - v0
        hv = cross(rd, e2)
        a = jnp.sum(e1 * hv, axis=-1)
        f = 1.0 / jnp.where(jnp.abs(a) < 1e-12, 1.0, a)
        s = ro - v0
        bu = f * jnp.sum(s * hv, axis=-1)
        q = cross(s, e1)
        bv = f * jnp.sum(rd * q, axis=-1)
        uv = interpolate_uv(scene.tri_uv[ti], bu, bv)
        tex_id = scene.tri_tex[ti]
        texel = sample_bilinear(scene.tex_atlas, scene.tex_size, tex_id, uv)
        textured = is_tri_table[idx] & (tex_id >= 0)
        mtl = dataclasses.replace(
            mtl, base_color=jnp.where(textured[:, None],
                                      mtl.base_color * texel,
                                      mtl.base_color))

    return Hit(hit=hit, t=best_t, pos=pos, normal=normal,
               mtl=mtl, is_light=is_light_table[idx])


_SHADOW_EPS = 1e-3  # endpoint clearance on both ends of a shadow ray


def _shadow_ray(p1: jnp.ndarray, p2: jnp.ndarray):
    """Endpoint pair -> (direction (B,3), max_d (B,1)).

    The single source of the shadow-ray epsilon rules shared by the binary
    and RGB transmittance paths (a drift between them would silently give
    the same scene two different shadow geometries).
    """
    diff = p2 - p1
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    rd = diff / jnp.maximum(dist, 1e-20)[:, None]
    return rd, (dist - _SHADOW_EPS)[:, None]


def transmittance(scene: Scene, p1: jnp.ndarray, p2: jnp.ndarray,
                  dielectrics_block: bool) -> jnp.ndarray:
    """Shadow-ray transmittance between two points, returned as (B,).

    ``dielectrics_block=True`` reproduces the GPU ``check_visibility``
    (geometric.cuh:293-325): with the legacy material fields zero-initialized
    (SURVEY.md quirk 12) every occluder — glass included — blocks fully.

    ``dielectrics_block=False`` reproduces the CPU oracle's
    ``cpu_check_visibility`` (cpu_bdpt.cpp:82-107): only eta<=0 materials
    block; dielectric occluders pass light unattenuated.

    Light balls never occlude in either implementation.
    """
    rd, max_d = _shadow_ray(p1, p2)
    min_d = _SHADOW_EPS

    blocked = jnp.zeros(p1.shape[0], bool)
    if scene.num_triangles:
        t = triangle_ts(p1, rd, scene.tri_v0, scene.tri_v1, scene.tri_v2, max_d)
        occludes = (t < INF) & (t > min_d)
        if not dielectrics_block:
            occludes &= (scene.tri_mtl.eta <= 0.0)[None, :]
        blocked |= jnp.any(occludes, axis=1)
    if scene.num_spheres:
        t = sphere_ts(p1, rd, scene.sph_center, scene.sph_radius, max_d)
        occludes = (t < INF) & (t > min_d)
        if not dielectrics_block:
            occludes &= (scene.sph_mtl.eta <= 0.0)[None, :]
        blocked |= jnp.any(occludes, axis=1)
    return jnp.where(blocked, 0.0, 1.0)


def transmittance_rgb(scene: Scene, p1: jnp.ndarray,
                      p2: jnp.ndarray) -> jnp.ndarray:
    """RGB shadow transmittance, returned as (B, 3).

    The reference's full ``check_visibility`` machinery (geometric.cuh:
    293-325): every occluder between the endpoints either blocks the ray
    completely (``mtl_old.refract <= 0``) or multiplies its legacy ``Ks``
    into the transmission.  With the legacy tables all zero — the only state
    the reference can reach, since ``to_cmtl_old`` is never called (quirk
    12) — this reduces exactly to the binary ``transmittance``; scenes
    activate it with the ``K`` record (scene/parser.py).

    Light balls never occlude (they are not in the sphere/triangle tables),
    matching the reference, which only scans spheres and triangles here.

    The batch axis is chunked (``lax.map``) so the per-(ray, primitive)
    transient stays bounded: a 1080p wavefront against even a ~1k-primitive
    scene would otherwise materialize multi-GB ``(B, N, 3)`` intermediates.
    """
    B = p1.shape[0]
    n_prims = max(scene.num_triangles + scene.num_spheres, 1)
    # ~16M-element (chunk, N) budget; triangle_ts peaks at 3x that in f32.
    # floor 8 (not 1024: a 250k-tri mesh would make the floor the binding
    # term and re-materialize the multi-GB transient this chunking exists
    # to prevent)
    chunk = max(8, min(65536, (1 << 24) // n_prims))
    if B <= chunk:
        return _transmittance_rgb_block(scene, p1, p2)
    pad = -B % chunk
    # padded lanes have p1 == p2 == 0 -> max_d < 0 -> no occluder passes the
    # t-window, so they fold to transmittance 1 and are sliced away below.
    p1p = jnp.pad(p1, ((0, pad), (0, 0)))
    p2p = jnp.pad(p2, ((0, pad), (0, 0)))
    out = jax.lax.map(
        lambda ab: _transmittance_rgb_block(scene, ab[0], ab[1]),
        (p1p.reshape(-1, chunk, 3), p2p.reshape(-1, chunk, 3)))
    return out.reshape(-1, 3)[:B]


def _transmittance_rgb_block(scene: Scene, p1: jnp.ndarray,
                             p2: jnp.ndarray) -> jnp.ndarray:
    """One batch chunk of :func:`transmittance_rgb` (materializes (B, N))."""
    rd, max_d = _shadow_ray(p1, p2)
    min_d = _SHADOW_EPS

    trans = jnp.ones((p1.shape[0], 3))

    def fold(trans, occ, ks, refract):
        # per-occluder factor: 1 if missed, Ks if refractive, 0 if opaque.
        # Reduced per color component so the transient stays (B, N) — a
        # (B, N, 3) tensor would be ~1 GB at a 2M-lane wavefront.
        occf = occ.astype(jnp.float32)
        cols = []
        for c in range(3):
            ks_c = jnp.where(refract > 0.0, ks[:, c], 0.0)[None, :]
            cols.append(jnp.prod(1.0 - occf * (1.0 - ks_c), axis=1))
        return trans * jnp.stack(cols, axis=-1)

    if scene.num_triangles:
        t = triangle_ts(p1, rd, scene.tri_v0, scene.tri_v1, scene.tri_v2,
                        max_d)
        trans = fold(trans, (t < INF) & (t > min_d),
                     scene.tri_ks, scene.tri_refract)
    if scene.num_spheres:
        t = sphere_ts(p1, rd, scene.sph_center, scene.sph_radius, max_d)
        trans = fold(trans, (t < INF) & (t > min_d),
                     scene.sph_ks, scene.sph_refract)
    return trans


def shadow_factor(scene: Scene, p1: jnp.ndarray, p2: jnp.ndarray,
                  dielectrics_block: bool) -> jnp.ndarray:
    """Shadow transmittance as (B, 3), RGB when the scene carries legacy
    Ks/refract materials (GPU-parity rule only; the CPU oracle's
    ``dielectrics_block=False`` rule is binary in the reference,
    cpu_bdpt.cpp:82-107).  Scenes without legacy data keep the binary
    any-blocker path and broadcast."""
    if dielectrics_block and scene.has_legacy_ks:
        return transmittance_rgb(scene, p1, p2)
    return jnp.broadcast_to(
        transmittance(scene, p1, p2, dielectrics_block)[:, None],
        (p1.shape[0], 3))
