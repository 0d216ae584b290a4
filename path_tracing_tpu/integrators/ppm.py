"""Progressive photon mapping (fixed-radius) with a sort-based photon grid.

Batched re-architecture of the reference's four CUDA kernels (ppm_cu.cu):
``ppm_eye_trace`` (:64-150), ``reset/build_hash_grid`` (:40-58),
``ppm_photon_trace`` (:156-295), ``ppm_resolve_image`` (:300-322).

The reference builds a linked-list-in-arrays spatial hash over *hitpoints*
with ``atomicExch`` head insertion, then each photon walks 27 neighbor cells
and ``atomicAdd``s flux into hitpoints.  Here the join is inverted into a
deterministic sort-and-gather instead:

1. photon tracing *records* every deposit event (position, surface normal,
   incoming direction, flux) into a fixed-shape ``(P, iters)`` tensor,
2. events are sorted by their spatial-hash cell id (same hash function:
   ``(gx*73856093 ^ gy*19349663 ^ gz*83492791) mod 1000003``, ppm_cu.cu:27-30,
   including its collision behavior — colliding neighbor cells double-count
   in the reference and here alike),
3. each hitpoint gathers from its 27 neighbor cells via two
   ``searchsorted``s + a bounded per-cell budget of ``cfg.ppm_max_per_cell``
   candidates (the overflow count is returned so callers can raise the
   budget; the reference's chains are unbounded but its cells are small).

Deposits are race-free by construction (pure gather + sum) — the
``atomicAdd`` nondeterminism of the reference disappears.

Semantics preserved: flux = illum*Nl/spl (ppm_cu.cu:213) — note this means
each light emits Nl x its nominal flux (spl photons per light, each carrying
illum*Nl/spl), so reference PPM renders ~num_lights x brighter than
reference BDPT; reproduced faithfully and pinned by test; deposit only on
eta<=0 and (metallic<0.99 or roughness>0.01) surfaces (:225); the eye pass
chases delta chains only and writes direct light hits straight to the image
(:106-111); normal-agreement gate dot>0.01 (:244); radius never shrinks
(quirk 13); resolve = flux/(pi r^2), clamp 15 (:300-322).

Multi-chip: photons shard over the mesh; per-shard flux images merge with a
``psum`` (see parallel/shard.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import rng
from ..ops.bsdf import bsdf_evaluate, bsdf_sample
from ..ops.intersect import find_closest_hit
from ..ops.math3 import (EPSILON, PI, clamp_radiance, dot, is_valid_color)
from ..ops.sampling import sample_light_emission
from ..scene.camera import primary_ray_dirs
from ..scene.types import Camera, Material, Scene


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass
class HitPoints:
    """Batched ``CudaHitPoint`` (geometric.cuh:53-65), minus the mutable
    accumulation fields (flux is produced functionally by the gather)."""

    pos: jnp.ndarray        # (B, 3)
    normal: jnp.ndarray     # (B, 3)
    wo: jnp.ndarray         # (B, 3) toward the camera chain
    mtl: Material
    throughput: jnp.ndarray  # (B, 3)
    valid: jnp.ndarray      # (B,)


@_register
@dataclass
class PhotonEvents:
    pos: jnp.ndarray      # (E, 3)
    normal: jnp.ndarray   # (E, 3) surface normal at the deposit
    wi: jnp.ndarray       # (E, 3) direction toward the light (== -ray dir)
    flux: jnp.ndarray     # (E, 3)
    valid: jnp.ndarray    # (E,)


def hash_cell(ix, iy, iz, table_size: int):
    """ppm_cu.cu:27-30 with C int32 wraparound then unsigned modulo."""
    h = (ix * jnp.int32(73856093)) ^ (iy * jnp.int32(19349663)) \
        ^ (iz * jnp.int32(83492791))
    return (h.astype(jnp.uint32) % jnp.uint32(table_size)).astype(jnp.int32)


def _cell_coords(pos, origin, cell_size):
    rel = (pos - origin) / cell_size
    return jnp.floor(rel).astype(jnp.int32)


def ppm_eye_trace(scene: Scene, cam: Camera, cfg: RenderConfig, px, py, key,
                  start=0, total: int | None = None):
    """Delta-chase eye pass -> (direct image (B,3), HitPoints).

    ppm_cu.cu:64-150: follow perfect reflect/refract chains only; stop and
    deposit a hitpoint at the first rough surface; light hits through delta
    chains write direct radiance.

    ``start``/``total``: global-lane RNG for sharded bit-exactness
    (``rng.uniforms_g``); defaults reproduce the unsharded draws exactly.
    """
    B = px.shape[0]
    jx, jy = rng.uniforms_g(jax.random.fold_in(key, 0x9E1), B, 2,
                            start, total)
    rd0 = primary_ray_dirs(cam, px, py, jx, jy)

    zero3 = jnp.zeros((B, 3))
    state = dict(
        ro=jnp.broadcast_to(cam.eye, (B, 3)), rd=rd0,
        tp=jnp.ones((B, 3)), eta=jnp.ones((B,)),
        alive=jnp.ones((B,), bool),
        direct=zero3,
        hp=HitPoints(pos=zero3, normal=zero3, wo=zero3,
                     mtl=Material(base_color=zero3,
                                  roughness=jnp.zeros(B),
                                  metallic=jnp.zeros(B),
                                  eta=jnp.zeros(B)),
                     throughput=zero3, valid=jnp.zeros(B, bool)),
    )

    def body(state, it):
        k = rng.iter_key(jax.random.fold_in(key, 0x9E2), it)
        u = rng.uniforms_g(k, B, 3, start, total)
        hit = find_closest_hit(scene, state["ro"], state["rd"])
        act = state["alive"] & hit.hit
        wo = -state["rd"]

        # direct light hit through a delta chain (:106-111); the reference
        # assigns (not accumulates) — each pass contributes one value
        light_hit = act & hit.is_light
        contrib = state["tp"] * hit.mtl.base_color
        contrib = jnp.where(is_valid_color(contrib)[:, None],
                            clamp_radiance(contrib, cfg.clamp), 0.0)
        direct = jnp.where(light_hit[:, None], contrib, state["direct"])

        s = bsdf_sample(hit.mtl, wo, hit.normal, u[0], u[1], u[2], state["eta"])
        surf = act & ~hit.is_light
        delta = surf & s.is_delta & (s.pdf > 0.0)
        deposit = surf & ~s.is_delta

        hp = state["hp"]
        put3 = lambda a, v: jnp.where(deposit[:, None], v, a)
        put1 = lambda a, v: jnp.where(deposit, v, a)
        hp = HitPoints(
            pos=put3(hp.pos, hit.pos), normal=put3(hp.normal, hit.normal),
            wo=put3(hp.wo, wo),
            mtl=Material(base_color=put3(hp.mtl.base_color, hit.mtl.base_color),
                         roughness=put1(hp.mtl.roughness, hit.mtl.roughness),
                         metallic=put1(hp.mtl.metallic, hit.mtl.metallic),
                         eta=put1(hp.mtl.eta, hit.mtl.eta)),
            throughput=put3(hp.throughput, state["tp"]),
            valid=hp.valid | deposit,
        )

        new_tp = state["tp"] * s.value
        off = jnp.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                        -hit.normal, hit.normal) * EPSILON
        alive = delta & is_valid_color(new_tp)
        return dict(
            ro=jnp.where(delta[:, None], hit.pos + off, state["ro"]),
            rd=jnp.where(delta[:, None], s.wi, state["rd"]),
            tp=jnp.where(delta[:, None], new_tp, state["tp"]),
            eta=jnp.where(delta, s.new_eta, state["eta"]),
            alive=jnp.where(act, alive, jnp.zeros_like(alive)),
            direct=direct,
            hp=hp,
        ), None

    state, _ = jax.lax.scan(body, state, jnp.arange(cfg.max_eye_iters))
    return state["direct"], state["hp"]


def ppm_photon_trace(scene: Scene, cfg: RenderConfig, num_photons: int,
                     spl: int, key, start=0, total: int | None = None
                     ) -> PhotonEvents:
    """Photon pass recording deposit events.  ppm_cu.cu:156-295.

    ``start``/``total`` support sharding: photon lanes here are rows
    [start, start+num_photons) of a GLOBAL ``total``-photon pass, so the
    light assignment ``global_index % num_lights`` matches the
    single-device sequence (each light gets exactly spl photons across
    the whole mesh) and lanes past ``total`` (mesh-rounding pad) emit
    nothing.  Defaults reproduce the unsharded call exactly.
    """
    P = num_photons
    nl = scene.num_lights
    gi = start + jnp.arange(P, dtype=jnp.int32)
    li = gi % nl
    real = jnp.ones((P,), bool) if total is None else gi < total

    u1, u2 = rng.uniforms_g(jax.random.fold_in(key, 0x407), P, 2,
                            start, total)
    emit = sample_light_emission(
        scene.light_pos[li], scene.light_dir[li], scene.light_cutoff[li],
        scene.light_is_parallel[li], scene.light_ball_r[li],
        scene.scene_min, scene.scene_max, u1, u2)

    flux0 = scene.light_illum[li] * (float(nl) / max(float(spl), 1.0))
    iters = cfg.max_light_iters

    state = dict(ro=emit.origin, rd=emit.direction, flux=flux0,
                 eta=jnp.ones((P,)), depth=jnp.zeros((P,), jnp.int32),
                 alive=real)

    def body(state, it):
        k = rng.iter_key(jax.random.fold_in(key, 0x408), it)
        u = rng.uniforms_g(k, P, 3, start, total)
        hit = find_closest_hit(scene, state["ro"], state["rd"])
        act = state["alive"] & hit.hit & ~hit.is_light \
            & (state["depth"] < cfg.light_depth)

        wi_light = -state["rd"]
        depositable = act & (hit.mtl.eta <= 0.0) \
            & ((hit.mtl.metallic < 0.99) | (hit.mtl.roughness > 0.01))

        ev = PhotonEvents(pos=hit.pos, normal=hit.normal, wi=wi_light,
                          flux=state["flux"], valid=depositable)

        s = bsdf_sample(hit.mtl, wi_light, hit.normal, u[0], u[1], u[2],
                        state["eta"])
        ok = act & (s.pdf > 0.0)  # photon pass: pdf<=0 kills even deltas (:276)
        cos_wi = jnp.abs(dot(hit.normal, s.wi))
        new_flux = state["flux"] * s.value * jnp.where(
            s.is_delta, 1.0, cos_wi / jnp.maximum(s.pdf, 1e-20))[:, None]
        alive = ok & is_valid_color(new_flux)

        off = jnp.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                        -hit.normal, hit.normal) * EPSILON
        new_depth = state["depth"] + jnp.where(s.is_delta, 0, 1)
        return dict(
            ro=jnp.where(ok[:, None], hit.pos + off, state["ro"]),
            rd=jnp.where(ok[:, None], s.wi, state["rd"]),
            flux=jnp.where(ok[:, None], new_flux, state["flux"]),
            eta=jnp.where(ok, s.new_eta, state["eta"]),
            depth=new_depth,
            alive=jnp.where(act, alive, jnp.zeros_like(alive)),
        ), ev

    _, events = jax.lax.scan(body, state, jnp.arange(iters))
    # (iters, P, ...) -> flat (E, ...)
    return jax.tree.map(
        lambda x: x.reshape((-1,) + x.shape[2:]), events)


def ppm_radius_scale(pass_index: int, alpha: float) -> float:
    """Progressive-PPM radius schedule: r_i^2 = r0^2 * prod_{k=1..i}
    (k+alpha)/(k+1) (Hachisuka et al.); alpha=0 or pass 0 -> 1.0 (the
    reference's fixed-radius behavior, quirk 13)."""
    if alpha <= 0.0 or pass_index <= 0:
        return 1.0
    scale = 1.0
    for k in range(1, pass_index + 1):
        scale *= (k + alpha) / (k + 1.0)
    return scale


def gather_flux(scene: Scene, cfg: RenderConfig, hp: HitPoints,
                events: PhotonEvents, r2_scale=1.0):
    """Per-hitpoint flux gather over 27 neighbor cells (sort + searchsorted).

    Returns (accum_flux (B,3), photon_count (B,), overflow (,)) where
    ``overflow`` counts candidate events dropped by the per-cell budget —
    0 means the gather was exact.  It is a float32 sum: a dense pass drops
    more than 2^31 candidates, which an int32 count would wrap.
    """
    # radius may shrink progressively (r2_scale <= 1) while the grid cell
    # stays at r0, so the 27-cell neighborhood always covers the search ball
    r2 = cfg.ppm_radius * cfg.ppm_radius * r2_scale
    cell = cfg.ppm_radius
    table = cfg.ppm_hash_size
    K = cfg.ppm_max_per_cell
    origin = scene.scene_min

    e_cells = _cell_coords(events.pos, origin, cell)
    e_hash = hash_cell(e_cells[:, 0], e_cells[:, 1], e_cells[:, 2], table)
    # push invalid events to the end of the sort with an out-of-range key
    e_key = jnp.where(events.valid, e_hash, jnp.int32(table))
    order = jnp.argsort(e_key)
    se = jax.tree.map(lambda x: x[order], events)

    h_cells = _cell_coords(hp.pos, origin, cell)           # (B, 3)
    offs = jnp.stack(jnp.meshgrid(*([jnp.arange(-1, 2)] * 3),
                                  indexing="ij"), -1).reshape(27, 3)
    n_cells = h_cells[:, None, :] + offs[None, :, :]       # (B, 27, 3)
    n_hash = hash_cell(n_cells[..., 0], n_cells[..., 1], n_cells[..., 2],
                       table)                              # (B, 27)

    # dense per-cell ranges via bincount + exclusive prefix sum over the hash
    # domain — much cheaper than binary-searching an 8M-key array per query
    counts = jnp.zeros((table + 1,), jnp.int32).at[e_key].add(1)
    ex = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                          jnp.cumsum(counts)[:-1]])
    start = ex[n_hash]
    end = start + counts[n_hash]
    counts_q = end - start
    M = cfg.ppm_cell_samples
    if M > 0:
        # unbiased stratified subsample: stride through each cell's events
        # and scale by count/M (exact when count <= M)
        overflow = jnp.zeros((), jnp.float32)
        kmax = jnp.minimum(jnp.max(counts_q), M)
    else:
        overflow = jnp.sum(jnp.maximum(counts_q - K, 0), dtype=jnp.float32)
        # dynamic bound: iterate only to the true max cell occupancy (<= K)
        kmax = jnp.minimum(jnp.max(counts_q), K)

    E = e_key.shape[0]
    B = hp.pos.shape[0]

    # hoist the per-hitpoint BSDF frame out of the candidate loop: only the
    # photon direction varies per pair, so build the local frame, wo_local
    # and alpha once per hitpoint and evaluate in local space per candidate
    from ..ops.bsdf import _eval_local, _half_vector
    from ..ops.frame import build_local_frame, world_to_local
    from ..ops.microfacet import roughness_to_alpha

    tf_, bf_ = build_local_frame(hp.normal)
    wo_l = world_to_local(hp.wo, tf_, bf_, hp.normal)      # (B, 3)
    alpha = roughness_to_alpha(hp.mtl.roughness)
    hp_mtl_b = jax.tree.map(lambda x: x[:, None], hp.mtl)

    # one packed (E, 12) matrix -> a single gather per loop step
    se_packed = jnp.concatenate([se.pos, se.normal, se.wi, se.flux], axis=1)

    if M > 0:
        stride = jnp.maximum(counts_q.astype(jnp.float32) / M, 1.0)
        weight = stride[..., None]                         # (B, 27, 1)
    else:
        stride = jnp.ones_like(end, jnp.float32)
        weight = jnp.ones(end.shape + (1,), jnp.float32)

    def body(k, carry):
        flux, count = carry
        off = (k * stride).astype(jnp.int32)
        idx = jnp.minimum(start + off, E - 1)              # (B, 27)
        live = off < counts_q
        rows = se_packed[idx]                              # (B, 27, 12)
        ev_pos = rows[..., 0:3]
        ev_n = rows[..., 3:6]
        ev_wi = rows[..., 6:9]
        ev_flux = rows[..., 9:12]

        d = hp.pos[:, None, :] - ev_pos
        dist2 = jnp.sum(d * d, axis=-1)
        ok = (live & (jnp.sum(hp.normal[:, None, :] * ev_n, -1) > 0.01)
              & (dist2 < r2) & hp.valid[:, None])

        wi_l = world_to_local(ev_wi, tf_[:, None], bf_[:, None],
                              hp.normal[:, None])          # (B, 27, 3)
        wh, wh_ok = _half_vector(wo_l[:, None], wi_l)
        brdf = _eval_local(hp_mtl_b, jnp.broadcast_to(wo_l[:, None],
                                                      wi_l.shape),
                           wi_l, alpha[:, None], wh, wh_ok)
        ok &= is_valid_color(brdf)
        energy = ev_flux * brdf * hp.throughput[:, None] * weight
        flux = flux + jnp.sum(jnp.where(ok[..., None], energy, 0.0), axis=1)
        count = count + jnp.sum(ok, axis=1)
        return (flux, count)

    flux, count = jax.lax.fori_loop(
        0, kmax, body, (jnp.zeros((B, 3)), jnp.zeros((B,), jnp.int32)))
    return flux, count, overflow


@partial(jax.jit, static_argnames=("width", "height", "spl", "cfg"))
def render_ppm_with_stats(scene: Scene, cam: Camera, width: int, height: int,
                          spl: int, cfg: RenderConfig, key, r2_scale=1.0):
    """One PPM pass: (image (B,3), photon_count (B,), overflow ()).

    Equivalent of one ``ppm_render_wrapper`` call (ppm_cu.cu:328-400):
    image = direct (delta-chain light hits) + flux/(pi r^2) clamped at 15.
    Progressive accumulation across passes is the caller's frame averaging,
    exactly like the reference GUI (main.cpp:440-452).
    """
    B = width * height
    idx = jnp.arange(B, dtype=jnp.int32)
    px = idx % width
    py = idx // width

    direct, hp = ppm_eye_trace(scene, cam, cfg, px, py,
                               jax.random.fold_in(key, 1))
    num_photons = scene.num_lights * spl
    events = ppm_photon_trace(scene, cfg, num_photons, spl,
                              jax.random.fold_in(key, 2))
    flux, count, overflow = gather_flux(scene, cfg, hp, events, r2_scale)

    radiance = flux / jnp.maximum(
        PI * cfg.ppm_radius * cfg.ppm_radius * r2_scale, 1e-6)
    radiance = jnp.where(
        (hp.valid & is_valid_color(radiance))[:, None],
        clamp_radiance(radiance, cfg.clamp), 0.0)
    return direct + radiance, count, overflow


def render_ppm(scene: Scene, cam: Camera, width: int, height: int, spl: int,
               cfg: RenderConfig, key, pass_index: int = 0) -> jnp.ndarray:
    img, _, _ = render_ppm_with_stats(
        scene, cam, width, height, spl, cfg, key,
        r2_scale=ppm_radius_scale(pass_index, cfg.ppm_alpha))
    return img
