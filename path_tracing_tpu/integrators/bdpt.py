"""Bidirectional path tracing with balance-heuristic MIS.

Batched re-architecture of the reference's two CUDA megakernels
(``cuda_light_trace`` bdpt_cu.cu:15-201, ``cuda_eye_trace_and_connect``
:289-536, ``calculate_mis_weight`` :204-284) and of the CPU oracle
(``cpu_bdpt.cpp:173-488``).  One implementation serves both: the GPU-parity
path and the deterministic CPU-oracle path differ only in documented
normalization/visibility flags (see ``render_bdpt`` / ``render_oracle``).

Architecture:

- **Light subpaths** are traced as a bounded masked ``lax.scan`` over a flat
  path batch, scattering vertices into a fixed-shape ``(P, L)`` tensor with
  validity masks (the reference's stride layout, bdpt_cu.cu:31,113).

- **MIS is O(1) per connection.**  The reference walks both subpaths per
  connection (O(depth) with divergent loops).  Both ratio walks are *linear*
  in the connection pdfs: the light-side walk satisfies

      sum_light(t) = pdf_s_to_t * A[t],
      A[0] = 0
      A[t] = 1/max(pdf_fwd[t], 1e-8)                        if is_light_source
           = 0                                              if eta[t] > 0
           = (1 + pdf_rev[t]*A[t-1]) / max(pdf_fwd[t],1e-8) otherwise

  precomputed once per light vertex after tracing, and the eye-side walk

      sum_eye(s) = pdf_t_to_s * F,   F = 0                  if s == 0 or eta_s>0
                   pdf_t_to_s * 1e8 * (1 + G[s-1])          otherwise

  where ``G`` follows the same recurrence over *finalized* eye vertices and
  is carried as a single scalar in the eye scan (no eye-vertex buffer at
  all).  The 1e8 factor is the faithful image of the reference's placeholder
  semantics: the current eye vertex's ``pdf_fwd`` is still the 0.0
  placeholder during connection (cpu_bdpt.cpp:385, clamped by
  ``fmaxf(...,1e-8)`` at :145), which suppresses eye-depth>=1 connections —
  a real, converged-image-visible property of the reference.

- **Connections** run as chunked pairwise ``(B, C)`` tensor ops with batched
  shadow rays, instead of an O(V) inner loop per thread.

- **Connection-end MIS pdfs are dist-scaled (reference quirk).**  Both
  references pass the UNNORMALIZED connection vector ``d_vec`` into
  ``bsdf_pdf`` (bdpt_cu.cu:443-449, cpu_bdpt.cpp:130-137) and ``bsdf_pdf``
  never normalizes its inputs (geometric.cuh:458-484), so the diffuse lobe
  scales by ``dist`` and the specular half-vector skews toward ``wi``; the
  area-measure conversion then uses ``dot(n, d_vec)`` cosines (another
  ``dist`` factor).  Net effect: the diffuse-lobe ratio terms carry NO
  1/dist^2 falloff.  We reproduce this exactly by feeding ``wi * dist``
  into the (scale-transparent) ``_pdf_local`` and multiplying the
  conversion cosines by ``dist`` — pinned by a literal NumPy transcription
  test (tests/test_bdpt.py::test_connection_matches_reference_transcription).

Multi-chip: light paths shard over the mesh and the vertex tensor is
all-gathered (small) before the pixel-sharded eye pass — see parallel/shard.py.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import rng
from ..ops.bsdf import bsdf_evaluate, bsdf_pdf, bsdf_sample
from ..ops.intersect import find_closest_hit, shadow_factor
from ..ops.math3 import (EPSILON, PI, clamp_radiance, dot, is_valid_color,
                         normalize)
from ..ops.sampling import sample_light_emission
from ..scene.camera import primary_ray_dirs
from ..scene.types import Camera, Material, Scene

PDF_FWD_FLOOR = 1e-8   # fmaxf clamp in both MIS walks (cpu_bdpt.cpp:145,155,160)
PDF_OMEGA_FLOOR = 1e-6  # fmaxf on connection pdfs (cpu_bdpt.cpp:133-134)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass
class LightVertices:
    """Fixed-shape ``(P, L)`` light-subpath vertex tensor.

    Mirrors ``CudaLightVertex`` (bdpt_cu.cuh:6-17) plus precomputed
    connection quantities: ``wo`` (direction toward the previous vertex /
    emission direction), ``mis_a`` (the light-side MIS suffix factor A), and
    ``emit_dir`` (the owning light's normalized direction, for the emitter
    cone gate the reference re-derives from the flat index,
    bdpt_cu.cu:407-415).
    """

    pos: jnp.ndarray          # (P, L, 3)
    normal: jnp.ndarray       # (P, L, 3)
    throughput: jnp.ndarray   # (P, L, 3)
    mtl: Material             # (P, L, ...)
    pdf_fwd: jnp.ndarray      # (P, L)
    pdf_rev: jnp.ndarray      # (P, L)
    is_light_source: jnp.ndarray  # (P, L) bool
    source_cutoff: jnp.ndarray    # (P, L)
    is_parallel: jnp.ndarray      # (P, L) bool
    emit_dir: jnp.ndarray     # (P, L, 3)
    wo: jnp.ndarray           # (P, L, 3)
    mis_a: jnp.ndarray        # (P, L)
    valid: jnp.ndarray        # (P, L) bool

    def flat(self) -> "LightVertices":
        return jax.tree.map(
            lambda x: x.reshape((-1,) + x.shape[2:]), self)


def trace_light_paths(scene: Scene, cfg: RenderConfig, num_paths: int,
                      spl: int, key, start=0, total: int | None = None
                      ) -> LightVertices:
    """Trace ``num_paths`` light subpaths (path i uses light ``i % Nl``).

    bdpt_cu.cu:15-201 / cpu_bdpt.cpp:218-325 semantics: vertex 0 is the
    emitter sample; bounce vertices are stored only for successful non-delta
    bounces; hitting another light ball stores a terminal light vertex;
    delta bounces don't consume depth (budgeted by cfg.delta_budget).

    ``start``/``total`` support sharding: these lanes are rows
    [start, start+num_paths) of a GLOBAL ``total``-path trace, so the
    light assignment ``global_index % Nl`` matches the single-device
    sequence (each light keeps its exact share of subpaths across the
    whole mesh) and lanes past ``total`` (mesh-rounding pad) store no
    vertices at all.  Defaults reproduce the unsharded call exactly.
    """
    P, L = num_paths, cfg.light_depth
    nl = scene.num_lights
    gi = start + jnp.arange(P, dtype=jnp.int32)
    li = gi % nl
    real = jnp.ones((P,), bool) if total is None else gi < total

    k_emit = jax.random.fold_in(key, 0xE817)
    u1, u2 = rng.uniforms_g(k_emit, P, 2, start, total)
    emit = sample_light_emission(
        scene.light_pos[li], scene.light_dir[li], scene.light_cutoff[li],
        scene.light_is_parallel[li], scene.light_ball_r[li],
        scene.scene_min, scene.scene_max, u1, u2)

    tp0 = scene.light_illum[li] / max(float(spl), 1.0)

    def zeros(*s, dtype=jnp.float32):
        return jnp.zeros(s, dtype)

    lv = LightVertices(
        pos=zeros(P, L, 3), normal=zeros(P, L, 3), throughput=zeros(P, L, 3),
        mtl=Material(base_color=zeros(P, L, 3), roughness=zeros(P, L),
                     metallic=zeros(P, L), eta=zeros(P, L)),
        pdf_fwd=zeros(P, L), pdf_rev=zeros(P, L),
        is_light_source=jnp.zeros((P, L), bool),
        source_cutoff=zeros(P, L),
        is_parallel=jnp.zeros((P, L), bool),
        emit_dir=zeros(P, L, 3), wo=zeros(P, L, 3), mis_a=zeros(P, L),
        valid=jnp.zeros((P, L), bool),
    )
    # vertex 0: the emitter (bdpt_cu.cu:93-99).  normal := emission direction.
    lv = dataclasses.replace(
        lv,
        pos=lv.pos.at[:, 0].set(emit.origin),
        normal=lv.normal.at[:, 0].set(emit.direction),
        throughput=lv.throughput.at[:, 0].set(tp0),
        is_light_source=lv.is_light_source.at[:, 0].set(True),
        source_cutoff=lv.source_cutoff.at[:, 0].set(scene.light_cutoff[li]),
        is_parallel=lv.is_parallel.at[:, 0].set(
            scene.light_is_parallel[li] != 0),
        emit_dir=lv.emit_dir.at[:, 0].set(normalize(scene.light_dir[li])),
        valid=lv.valid.at[:, 0].set(real),
    )

    state = dict(
        lv=lv,
        ro=emit.origin, rd=emit.direction, tp=tp0,
        eta=jnp.ones((P,)),
        slot=jnp.ones((P,), jnp.int32),
        alive=real & (L > 1),
        last_normal=emit.direction, last_pos=emit.origin,
        last_pdf=jnp.full((P,), 1.0 / PI),  # bdpt_cu.cu:103
    )

    lane = jnp.arange(P)

    def body(state, it):
        k = rng.iter_key(jax.random.fold_in(key, 0x11F7), it)
        u = rng.uniforms_g(k, P, 3, start, total)
        lv = state["lv"]
        hit = find_closest_hit(scene, state["ro"], state["rd"])
        act = state["alive"] & hit.hit
        slot = state["slot"]

        # terminal light-ball hit: store a light vertex, end path
        # (bdpt_cu.cu:120-131; pdf_fwd/pdf_rev stay zero-initialized)
        store_light = act & hit.is_light
        # ordering quirk: the throughput/dist guards run AFTER the light
        # check (bdpt_cu.cu:132-135)
        tp_len = jnp.sqrt(jnp.sum(state["tp"] ** 2, axis=-1))
        d_vec = hit.pos - state["last_pos"]
        dist2 = jnp.sum(d_vec * d_vec, axis=-1)
        ok = act & ~hit.is_light & (tp_len >= 1e-4) & (dist2 >= 1e-6)

        cos_at_hit = jnp.abs(dot(hit.normal, -state["rd"]))
        cos_at_prev = jnp.abs(dot(state["last_normal"], state["rd"]))
        pdf_fwd = state["last_pdf"] * cos_at_hit / jnp.maximum(dist2, 1e-20)

        wo = -state["rd"]
        s = bsdf_sample(hit.mtl, wo, hit.normal, u[0], u[1], u[2], state["eta"])
        sample_ok = (s.pdf > 0.0) | s.is_delta
        store_surf = ok & sample_ok & ~s.is_delta
        delta = ok & sample_ok & s.is_delta

        pdf_rev = (bsdf_pdf(hit.mtl, s.wi, wo, hit.normal)
                   * cos_at_prev / jnp.maximum(dist2, 1e-20))

        store = store_light | store_surf

        def put(arr, val, mask):
            return arr.at[lane, slot].set(
                jnp.where(mask[..., None] if val.ndim > 1 else mask,
                          val, arr[lane, slot]))

        lv = dataclasses.replace(
            lv,
            pos=put(lv.pos, hit.pos, store),
            normal=put(lv.normal, hit.normal, store),
            throughput=put(lv.throughput, state["tp"], store),
            mtl=Material(
                base_color=put(lv.mtl.base_color, hit.mtl.base_color, store),
                roughness=put(lv.mtl.roughness, hit.mtl.roughness, store),
                metallic=put(lv.mtl.metallic, hit.mtl.metallic, store),
                eta=put(lv.mtl.eta, hit.mtl.eta, store),
            ),
            pdf_fwd=put(lv.pdf_fwd, jnp.where(store_surf, pdf_fwd, 0.0), store),
            pdf_rev=put(lv.pdf_rev, jnp.where(store_surf, pdf_rev, 0.0), store),
            is_light_source=put(lv.is_light_source, store_light, store),
            source_cutoff=put(lv.source_cutoff, jnp.zeros((P,)), store),
            is_parallel=put(lv.is_parallel, jnp.zeros((P,), bool), store),
            wo=put(lv.wo, wo, store),
            valid=put(lv.valid, store, store),
        )

        # advance
        new_tp = state["tp"] * s.value * jnp.where(
            s.is_delta, 1.0, jnp.abs(dot(hit.normal, s.wi))
            / jnp.maximum(s.pdf, 1e-20))[..., None]
        tp_valid = is_valid_color(new_tp)

        off_delta = jnp.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                              -hit.normal, hit.normal) * EPSILON
        new_ro = jnp.where(delta[:, None], hit.pos + off_delta,
                           hit.pos + hit.normal * EPSILON)
        new_slot = slot + jnp.where(store_surf, 1, 0)

        alive = (delta | (store_surf & tp_valid & (new_slot < L)))
        upd = (delta | store_surf)

        new_state = dict(
            lv=lv,
            ro=jnp.where(upd[:, None], new_ro, state["ro"]),
            rd=jnp.where(upd[:, None], s.wi, state["rd"]),
            tp=jnp.where(upd[:, None], new_tp, state["tp"]),
            eta=jnp.where(upd, s.new_eta, state["eta"]),
            slot=new_slot,
            alive=jnp.where(act, alive, state["alive"] & hit.hit),
            # the light-trace delta branch does NOT update last_* (:157-171)
            last_normal=jnp.where(store_surf[:, None], hit.normal,
                                  state["last_normal"]),
            last_pos=jnp.where(store_surf[:, None], hit.pos,
                               state["last_pos"]),
            last_pdf=jnp.where(store_surf, s.pdf, state["last_pdf"]),
        )
        return new_state, None

    state, _ = jax.lax.scan(body, state, jnp.arange(cfg.max_light_iters))
    lv = state["lv"]

    # CPU-oracle skip rule: vertices with |throughput| < 1e-6 never connect
    # (cpu_bdpt.cpp:391); GPU gets the same result via tp==0.
    tp_len = jnp.sqrt(jnp.sum(lv.throughput ** 2, axis=-1))
    lv = dataclasses.replace(lv, valid=lv.valid & (tp_len >= 1e-6))

    # wo per vertex: emission dir at t=0, direction to previous vertex else
    prev_pos = jnp.concatenate([lv.pos[:, :1], lv.pos[:, :-1]], axis=1)
    to_prev = prev_pos - lv.pos
    to_prev = to_prev / jnp.maximum(
        jnp.sqrt(jnp.sum(to_prev ** 2, axis=-1, keepdims=True)), 1e-20)
    # the reference recomputes wo from the previous *stored* vertex position
    # (cpu_bdpt.cpp:131), which differs from the incoming ray direction when
    # delta bounces intervened — use the reference's rule.  t=0 uses the
    # emission direction (== stored normal, already unit).
    wo = jnp.where(
        (jnp.arange(L) == 0)[None, :, None], lv.normal, to_prev)

    # light-side MIS suffix factor A (linear-walk precomputation, see module
    # docstring).  A[:, 0] = 0 (the walk never visits t=0).
    a = [jnp.zeros((lv.pos.shape[0],))]
    for t in range(1, L):
        inv_fwd = 1.0 / jnp.maximum(lv.pdf_fwd[:, t], PDF_FWD_FLOOR)
        a_t = jnp.where(
            lv.is_light_source[:, t], inv_fwd,
            jnp.where(lv.mtl.eta[:, t] > 0.0, 0.0,
                      inv_fwd * (1.0 + lv.pdf_rev[:, t] * a[t - 1])))
        a.append(a_t)
    mis_a = jnp.stack(a, axis=1)

    return dataclasses.replace(lv, wo=wo, mis_a=mis_a)


def compact_flat(lv_flat: LightVertices):
    """Sort valid vertices to the front; returns (sorted flat LV, n_valid).

    Lets the connection loop stop at the true vertex count instead of
    sweeping every padded/dead slot (the reference iterates the full buffer,
    bdpt_cu.cu:384, wasting the same way its warps do)."""
    order = jnp.argsort(~lv_flat.valid, stable=True)
    return jax.tree.map(lambda x: x[order], lv_flat), \
        jnp.sum(lv_flat.valid.astype(jnp.int32))


# uniform-mixture weight of the RIS proposal: unbiased for any value in
# (0, 1] because the RIS weight divides by the exact mixture p
RIS_DEFENSIVE_WEIGHT = 0.5


def resample_light_vertices(lv_flat: LightVertices, n_valid, K: int, key):
    """Importance-cull the compacted vertex table to ``K`` rows by
    contribution-proportional resampling (unbiased).

    Draw ``K`` iid rows with probability ``p_i = 0.5/n_valid + 0.5 *
    lum(throughput_i)/sum lum`` (defensive uniform mixture keeps every
    potentially contributing vertex in the support) and bake the RIS weight
    ``1/(K * p_i)`` into the resampled throughput — connection contributions
    are linear in it, so the connection sweep is automatically an unbiased
    estimator of the exact O(V) sweep at O(K) cost.  This is the
    scaling answer to the reference's all-pairs loop (bdpt_cu.cu:384-457)
    once V >> K; ``cfg.bdpt_resample_vertices`` opts in.

    Returns (resampled flat LightVertices, K).
    """
    V = lv_flat.pos.shape[0]
    nv = jnp.maximum(n_valid, 1)
    in_prefix = jnp.arange(V) < n_valid
    lum = jnp.sum(lv_flat.throughput
                  * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1)
    contrib = (in_prefix & lv_flat.valid & (lum > 0.0)
               & jnp.isfinite(lum))
    w = jnp.where(contrib, lum, 0.0)
    wsum = jnp.sum(w)
    # support restriction (round 3): connection contributions are linear in
    # the (non-negative) throughput, so lum == 0 <=> the vertex contributes
    # exactly zero to EVERY connection — unbiasedness does not require it
    # in the support, and defensive draws landing on it are pure waste.
    # The uniform half of the mixture therefore runs over the CONTRIBUTING
    # rows only (falling back to the valid prefix when all rows are zero,
    # where any support is unbiased because the estimate is zero).
    nc = jnp.sum(contrib.astype(jnp.int32))
    has = nc > 0
    dw = RIS_DEFENSIVE_WEIGHT
    base = jnp.where(has, jnp.where(contrib, dw / jnp.maximum(nc, 1), 0.0),
                     jnp.where(in_prefix, 1.0 / nv, 0.0))
    p = base + jnp.where(wsum > 0.0,
                         (1.0 - dw) * w / jnp.maximum(wsum, 1e-30), 0.0)
    cdf = jnp.cumsum(p)
    # stratified uniforms lower resampling variance at identical expectation
    u = (jnp.arange(K) + jax.random.uniform(key, (K,))) / K
    idx = jnp.clip(jnp.searchsorted(cdf, u * cdf[-1], side="right"), 0, V - 1)
    out = jax.tree.map(lambda x: x[idx], lv_flat)
    scale = 1.0 / (K * jnp.maximum(p[idx], 1e-30))
    out = dataclasses.replace(
        out, throughput=out.throughput * scale[:, None])
    return out, jnp.asarray(K, jnp.int32)


def _connect(scene: Scene, cfg: RenderConfig, lv_flat: LightVertices,
             n_valid, ev_pos, ev_normal, ev_tp, ev_mtl, wo_e, wo_s, eye_f,
             chunk: int):
    """Connect every eye lane against every (valid) light vertex, chunked.

    Pairwise re-architecture of the O(V) inner loops at bdpt_cu.cu:384-457 /
    cpu_bdpt.cpp:389-439.  ``eye_f`` is the per-lane eye-side MIS factor F.
    Local shading frames are hoisted: the eye endpoint's frame is built once
    per lane and the light endpoints' frames once per vertex — only the
    per-pair direction transforms and microfacet terms run at (B, C) width.
    Returns the summed contribution per lane (B, 3).
    """
    from ..ops.bsdf import _eval_local, _half_vector, _pdf_local
    from ..ops.frame import build_local_frame, world_to_local
    from ..ops.microfacet import roughness_to_alpha

    B = ev_pos.shape[0]
    V = lv_flat.pos.shape[0]
    # a table smaller than one chunk (e.g. a K-row RIS table) is swept in
    # one chunk of its own size, not padded out to ``chunk`` dead rows
    chunk = max(1, min(chunk, V))
    pad = (-V) % chunk
    lvp = jax.tree.map(
        lambda x: jnp.concatenate(
            [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], 0), lv_flat)
    nchunks = (V + pad) // chunk

    # per-vertex (light-side) frames, hoisted out of the pair loop
    lt, lb = build_local_frame(lvp.normal)
    wo_t_l = world_to_local(lvp.wo, lt, lb, lvp.normal)
    alpha_l = roughness_to_alpha(lvp.mtl.roughness)
    lv_all = dict(lv=lvp, lt=lt, lb=lb, wo_t_l=wo_t_l, alpha_l=alpha_l)
    lvc = jax.tree.map(
        lambda x: x.reshape((nchunks, chunk) + x.shape[1:]), lv_all)

    # per-lane (eye-side) frame, hoisted
    et, eb = build_local_frame(ev_normal)
    wo_e_l = world_to_local(wo_e, et, eb, ev_normal)[:, None]   # (B,1,3)
    wo_s_l = world_to_local(wo_s, et, eb, ev_normal)[:, None]
    alpha_e = roughness_to_alpha(ev_mtl.roughness)[:, None]
    ev_mtl_b = jax.tree.map(lambda x: x[:, None], ev_mtl)       # (B,1,...)

    def to_local_pairs(w, t, b, n):
        """(B,C,3) world -> local with (X,3) frames broadcast."""
        return jnp.stack([jnp.sum(w * t, -1), jnp.sum(w * b, -1),
                          jnp.sum(w * n, -1)], axis=-1)

    def chunk_body(c, acc):
        ch = jax.tree.map(
            lambda x: jax.lax.dynamic_index_in_dim(x, c, 0, keepdims=False),
            lvc)
        lv = ch["lv"]
        d_vec = lv.pos[None, :, :] - ev_pos[:, None, :]          # (B, C, 3)
        dist2 = jnp.sum(d_vec * d_vec, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
        wi = d_vec / dist[..., None]

        cos_e = jnp.maximum(0.0, jnp.sum(ev_normal[:, None] * wi, -1))
        cos_l = jnp.maximum(0.0, jnp.sum(-lv.normal[None] * wi, -1))

        gate = (lv.valid[None, :] & (dist2 >= 1e-6)
                & (cos_e > 0.0) & (cos_l > 0.0))
        # emitter spot-cone gate (bdpt_cu.cu:407-415)
        cone_bad = (lv.is_light_source & (lv.source_cutoff > 0.0)
                    & ~lv.is_parallel)[None, :] & (
            jnp.sum(lv.emit_dir[None] * (-wi), -1)
            < jnp.cos(lv.source_cutoff)[None, :])
        gate &= ~cone_bad

        # eye side: one eval (wo_e) + one pdf (wo_s) in the hoisted frame.
        # MIS-pdf quirk: the reference passes the UNNORMALIZED connection
        # vector d_vec into bsdf_pdf and converts with dist-scaled cosines
        # (bdpt_cu.cu:443-449 / cpu_bdpt.cpp:130-137; bsdf_pdf never
        # normalizes, geometric.cuh:458-484) — feed wi*dist so the skewed
        # half-vector and the dist-scaled diffuse pdf match exactly
        lv_mtl_b = jax.tree.map(lambda x: x[None], lv.mtl)       # (1,C,...)
        wi_e_l = to_local_pairs(wi, et[:, None], eb[:, None],
                                ev_normal[:, None])
        wh_e, ok_e = _half_vector(wo_e_l, wi_e_l)
        f_e = _eval_local(ev_mtl_b, jnp.broadcast_to(wo_e_l, wi_e_l.shape),
                          wi_e_l, alpha_e, wh_e, ok_e)
        wi_s_l = wi_e_l * dist[..., None]
        wh_s, ok_s = _half_vector(wo_s_l, wi_s_l)
        pdf_s = jnp.maximum(
            _pdf_local(ev_mtl_b, jnp.broadcast_to(wo_s_l, wi_s_l.shape),
                       wi_s_l, alpha_e, wh_s, ok_s), PDF_OMEGA_FLOOR)

        # light side: eval uses the unit wi (bdpt_cu.cu:430), the MIS pdf
        # the dist-scaled one (same quirk)
        wi_l_l = to_local_pairs(-wi, ch["lt"][None], ch["lb"][None],
                                lv.normal[None])
        wo_t_b = jnp.broadcast_to(ch["wo_t_l"][None], wi_l_l.shape)
        wh_l, ok_l = _half_vector(wo_t_b, wi_l_l)
        f_l = jnp.where(
            lv.is_light_source[None, :, None],
            jnp.ones((B, chunk, 3)),
            _eval_local(lv_mtl_b, wo_t_b, wi_l_l, ch["alpha_l"][None],
                        wh_l, ok_l))
        wi_t_l = wi_l_l * dist[..., None]
        wh_t, ok_t = _half_vector(wo_t_b, wi_t_l)
        pdf_t = jnp.maximum(
            _pdf_local(lv_mtl_b, wo_t_b, wi_t_l, ch["alpha_l"][None],
                       wh_t, ok_t), PDF_OMEGA_FLOOR)
        gate &= jnp.any(f_e > 0.0, -1) & jnp.any(f_l > 0.0, -1)

        p1 = jnp.broadcast_to(
            ev_pos[:, None] + ev_normal[:, None] * EPSILON,
            (B, chunk, 3)).reshape(-1, 3)
        p2 = jnp.broadcast_to(
            lv.pos[None] + lv.normal[None] * EPSILON,
            (B, chunk, 3)).reshape(-1, 3)
        trans = shadow_factor(
            scene, p1, p2,
            dielectrics_block=cfg.shadow_dielectrics_block,
        ).reshape(B, chunk, 3)
        gate &= jnp.any(trans > 0.0, axis=-1)

        g_term = cos_e * cos_l / jnp.maximum(dist2, 1e-4)

        # O(1) MIS (module docstring); cos_t/cos_s are the reference's
        # dist-scaled dot(n, d_vec) forms (bdpt_cu.cu:217-218,236-237)
        pdf_s_to_t = pdf_s * cos_l * dist / jnp.maximum(dist2, 1e-20)
        pdf_t_to_s = pdf_t * cos_e * dist / jnp.maximum(dist2, 1e-20)
        sum_ratios = (1.0 + pdf_t_to_s * eye_f[:, None]
                      + pdf_s_to_t * lv.mis_a[None, :])
        mis_ok = jnp.isfinite(sum_ratios) & (sum_ratios > 0.0)
        mis_w = jnp.where(mis_ok, 1.0 / jnp.maximum(sum_ratios, 1e-30), 0.0)

        contrib = (ev_tp[:, None] * f_e * f_l * lv.throughput[None]
                   * trans * (g_term * mis_w)[..., None])
        contrib = jnp.where(
            (gate & is_valid_color(contrib))[..., None],
            clamp_radiance(contrib, cfg.clamp), 0.0)
        return acc + jnp.sum(contrib, axis=1)

    # dynamic chunk count: stop at the last chunk holding a valid vertex
    n_chunks_live = jnp.minimum((n_valid + chunk - 1) // chunk, nchunks)
    return jax.lax.fori_loop(0, n_chunks_live, chunk_body,
                             jnp.zeros((B, 3)))


def _connect_sampled(scene: Scene, cfg: RenderConfig, lv_flat: LightVertices,
                     n_valid, ev_pos, ev_normal, ev_tp, ev_mtl, wo_e, wo_s,
                     eye_f, key, start=0, total: int | None = None):
    """Unbiased stratified connection subsampling: each eye vertex connects
    to ``cfg.bdpt_connection_samples`` light vertices (stratified over the
    compacted valid prefix) and scales by ``n_valid / M``.

    Same expectation as the exact all-pairs sweep (the estimator is a
    stratified Monte Carlo sum over the vertex axis); O(M) instead of O(V)
    per eye vertex, which is what makes slice-scale BDPT (BASELINE config 5)
    tractable.  Light-vertex fields are gathered per (lane, sample) — the
    win over chunked broadcast appears once V >> M.
    """
    from ..ops.bsdf import _eval_local, _half_vector, _pdf_local
    from ..ops.frame import build_local_frame, world_to_local
    from ..ops.microfacet import roughness_to_alpha

    B = ev_pos.shape[0]
    M = cfg.bdpt_connection_samples
    nv = jnp.maximum(n_valid, 1)

    # per-lane stratified vertex indices (global counters: uniforms_g with
    # n=M draws the same flat (M, B) Threefry block as the old
    # uniforms(key, (M, B), 1)[0] when unsharded)
    u = jnp.stack(rng.uniforms_g(jax.random.fold_in(key, 0x5E1),
                                 B, M, start, total))              # (M, B)
    j = jnp.arange(M, dtype=jnp.float32)[:, None]
    vidx = jnp.minimum(((j + u) * (nv.astype(jnp.float32) / M))
                       .astype(jnp.int32), nv - 1)                   # (M, B)
    vidx = vidx.T                                                    # (B, M)
    scale = nv.astype(jnp.float32) / M

    # hoisted eye frame
    et, eb = build_local_frame(ev_normal)
    wo_e_l = world_to_local(wo_e, et, eb, ev_normal)[:, None]
    wo_s_l = world_to_local(wo_s, et, eb, ev_normal)[:, None]
    alpha_e = roughness_to_alpha(ev_mtl.roughness)[:, None]
    ev_mtl_b = jax.tree.map(lambda x: x[:, None], ev_mtl)

    # chunk the sample axis: the (B, M, ...) pair tensors and the B*M
    # shadow rays of the one-shot form OOM HBM at 512^2 x M=64; lax.map
    # serializes M/mc chunks of bounded footprint
    mc = M
    for cand in (8, 4, 2, 1):
        if M % cand == 0:
            mc = cand
            break

    def _chunk(vidx_c):
        return _connect_sampled_chunk(
            scene, cfg, lv_flat, ev_pos, ev_normal, ev_tp, ev_mtl_b,
            wo_e_l, wo_s_l, alpha_e, eye_f, et, eb, vidx_c)

    vchunks = vidx.reshape(B, M // mc, mc).transpose(1, 0, 2)
    csum = jax.lax.map(_chunk, vchunks)                  # (M/mc, B, 3)
    return jnp.sum(csum, axis=0) * scale


def _connect_sampled_chunk(scene, cfg, lv_flat, ev_pos, ev_normal, ev_tp,
                           ev_mtl_b, wo_e_l, wo_s_l, alpha_e, eye_f,
                           et, eb, vidx):
    """One (B, mc) slice of the stratified connection sum (the body of
    ``_connect_sampled``'s sample-axis loop)."""
    from ..ops.bsdf import _eval_local, _half_vector, _pdf_local
    from ..ops.frame import build_local_frame, world_to_local
    from ..ops.microfacet import roughness_to_alpha

    B, M = vidx.shape

    lvg = jax.tree.map(lambda x: x[vidx], lv_flat)                   # (B, mc, ..)

    # light frames per sampled vertex
    lt, lb = build_local_frame(lvg.normal)
    wo_t_l = world_to_local(lvg.wo, lt, lb, lvg.normal)
    alpha_l = roughness_to_alpha(lvg.mtl.roughness)

    d_vec = lvg.pos - ev_pos[:, None, :]                             # (B, M, 3)
    dist2 = jnp.sum(d_vec * d_vec, axis=-1)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    wi = d_vec / dist[..., None]

    cos_e = jnp.maximum(0.0, jnp.sum(ev_normal[:, None] * wi, -1))
    cos_l = jnp.maximum(0.0, jnp.sum(-lvg.normal * wi, -1))
    gate = lvg.valid & (dist2 >= 1e-6) & (cos_e > 0.0) & (cos_l > 0.0)
    cone_bad = (lvg.is_light_source & (lvg.source_cutoff > 0.0)
                & ~lvg.is_parallel) & (
        jnp.sum(lvg.emit_dir * (-wi), -1) < jnp.cos(lvg.source_cutoff))
    gate &= ~cone_bad

    def to_local(w, t, b, n):
        return jnp.stack([jnp.sum(w * t, -1), jnp.sum(w * b, -1),
                          jnp.sum(w * n, -1)], axis=-1)

    # MIS pdfs take the dist-scaled wi (reference passes the unnormalized
    # d_vec into bsdf_pdf — see _connect); evals take the unit wi
    wi_e_l = to_local(wi, et[:, None], eb[:, None], ev_normal[:, None])
    wh_e, ok_e = _half_vector(wo_e_l, wi_e_l)
    f_e = _eval_local(ev_mtl_b, jnp.broadcast_to(wo_e_l, wi_e_l.shape),
                      wi_e_l, alpha_e, wh_e, ok_e)
    wi_s_l = wi_e_l * dist[..., None]
    wh_s, ok_s = _half_vector(wo_s_l, wi_s_l)
    pdf_s = jnp.maximum(
        _pdf_local(ev_mtl_b, jnp.broadcast_to(wo_s_l, wi_s_l.shape),
                   wi_s_l, alpha_e, wh_s, ok_s), PDF_OMEGA_FLOOR)

    wi_l_l = to_local(-wi, lt, lb, lvg.normal)
    wh_l, ok_l = _half_vector(wo_t_l, wi_l_l)
    f_l = jnp.where(lvg.is_light_source[..., None],
                    jnp.ones((B, M, 3)),
                    _eval_local(lvg.mtl, wo_t_l, wi_l_l, alpha_l, wh_l, ok_l))
    wi_t_l = wi_l_l * dist[..., None]
    wh_t, ok_t = _half_vector(wo_t_l, wi_t_l)
    pdf_t = jnp.maximum(
        _pdf_local(lvg.mtl, wo_t_l, wi_t_l, alpha_l, wh_t, ok_t),
        PDF_OMEGA_FLOOR)
    gate &= jnp.any(f_e > 0.0, -1) & jnp.any(f_l > 0.0, -1)

    p1 = jnp.broadcast_to(ev_pos[:, None] + ev_normal[:, None] * EPSILON,
                          (B, M, 3)).reshape(-1, 3)
    p2 = (lvg.pos + lvg.normal * EPSILON).reshape(-1, 3)
    trans = shadow_factor(scene, p1, p2,
                          dielectrics_block=cfg.shadow_dielectrics_block
                          ).reshape(B, M, 3)
    gate &= jnp.any(trans > 0.0, axis=-1)

    g_term = cos_e * cos_l / jnp.maximum(dist2, 1e-4)
    pdf_s_to_t = pdf_s * cos_l * dist / jnp.maximum(dist2, 1e-20)
    pdf_t_to_s = pdf_t * cos_e * dist / jnp.maximum(dist2, 1e-20)
    sum_ratios = (1.0 + pdf_t_to_s * eye_f[:, None]
                  + pdf_s_to_t * lvg.mis_a)
    mis_ok = jnp.isfinite(sum_ratios) & (sum_ratios > 0.0)
    mis_w = jnp.where(mis_ok, 1.0 / jnp.maximum(sum_ratios, 1e-30), 0.0)

    contrib = (ev_tp[:, None] * f_e * f_l * lvg.throughput
               * trans * (g_term * mis_w)[..., None])
    contrib = jnp.where((gate & is_valid_color(contrib))[..., None],
                        clamp_radiance(contrib, cfg.clamp), 0.0)
    return jnp.sum(contrib, axis=1)


def eye_trace_and_connect(scene: Scene, cam: Camera, cfg: RenderConfig,
                          lv_flat: LightVertices, n_valid, px, py, key,
                          light_hit_scale: float, chunk: int,
                          start=0, total: int | None = None) -> jnp.ndarray:
    """One eye path per lane, connecting at every non-delta vertex.

    bdpt_cu.cu:289-536 / cpu_bdpt.cpp:336-473 (CPU semantics: defined light
    material for eye hits on light balls at depth>0, which then connect and
    bounce like diffuse surfaces — SURVEY.md quirk 6).

    ``start``/``total``: global-lane RNG for sharded bit-exactness (see
    ``wavefront_pt``); defaults reproduce the unsharded draws exactly.
    """
    B = px.shape[0]
    # lv_flat arrives pre-compacted (eye_pass hoists the O(V log V) argsort
    # out of the per-spp scan); the RIS re-draw stays per-sample
    if cfg.bdpt_resample_vertices > 0:
        lv_flat, n_valid = resample_light_vertices(
            lv_flat, n_valid, cfg.bdpt_resample_vertices,
            jax.random.fold_in(key, 0x5E5A))
    jx, jy = rng.uniforms_g(jax.random.fold_in(key, 0xA11CE), B, 2,
                            start, total)
    rd0 = primary_ray_dirs(cam, px, py, jx, jy)

    state = dict(
        ro=jnp.broadcast_to(cam.eye, (B, 3)), rd=rd0,
        tp=jnp.ones((B, 3)),
        radiance=jnp.zeros((B, 3)),
        eta=jnp.ones((B,)),
        depth=jnp.zeros((B,), jnp.int32),
        alive=jnp.ones((B,), bool),
        last_normal=rd0, last_pos=jnp.broadcast_to(cam.eye, (B, 3)),
        last_pdf=jnp.ones((B,)),
        g_mis=jnp.zeros((B,)),
        prev_vpos=jnp.broadcast_to(cam.eye, (B, 3)),
    )

    def body(state, it):
        k = rng.iter_key(jax.random.fold_in(key, 0xE7E), it)
        u = rng.uniforms_g(k, B, 3, start, total)
        hit = find_closest_hit(scene, state["ro"], state["rd"])
        act = state["alive"] & hit.hit
        depth = state["depth"]

        # depth-0 direct light hit (bdpt_cu.cu:350-361)
        light0 = act & hit.is_light & (depth == 0)
        radiance = state["radiance"] + jnp.where(
            light0[:, None], hit.mtl.base_color * light_hit_scale, 0.0)
        act = act & ~light0
        alive = state["alive"] & hit.hit & ~light0

        # ---- connection at the current vertex ----
        wo_e = -state["rd"]
        wo_s = jnp.where((depth == 0)[:, None],
                         normalize(cam.eye[None] - hit.pos),
                         normalize(state["prev_vpos"] - hit.pos))
        eye_f = jnp.where(
            (depth == 0) | (hit.mtl.eta > 0.0), 0.0,
            (1.0 / PDF_FWD_FLOOR) * (1.0 + state["g_mis"]))
        if cfg.bdpt_connection_samples > 0:
            total_c = _connect_sampled(
                scene, cfg, lv_flat, n_valid, hit.pos, hit.normal,
                state["tp"], hit.mtl, wo_e, wo_s, eye_f, k, start, total)
        else:
            total_c = _connect(scene, cfg, lv_flat, n_valid, hit.pos,
                               hit.normal, state["tp"], hit.mtl, wo_e, wo_s,
                               eye_f, chunk)
        radiance = radiance + jnp.where(act[:, None], total_c, 0.0)

        # ---- bounce (bdpt_cu.cu:460-526) ----
        d_vec = hit.pos - state["last_pos"]
        dist2 = jnp.sum(d_vec * d_vec, axis=-1)
        ok = act & (dist2 >= 1e-6)

        cos_at_hit = jnp.abs(dot(hit.normal, -state["rd"]))
        cos_at_prev = jnp.abs(dot(state["last_normal"], state["rd"]))
        pdf_fwd = state["last_pdf"] * cos_at_hit / jnp.maximum(dist2, 1e-20)

        s = bsdf_sample(hit.mtl, wo_e, hit.normal, u[0], u[1], u[2],
                        state["eta"])
        sample_ok = (s.pdf > 0.0) | s.is_delta
        delta = ok & sample_ok & s.is_delta
        rough = ok & sample_ok & ~s.is_delta

        pdf_rev = (bsdf_pdf(hit.mtl, s.wi, wo_e, hit.normal)
                   * cos_at_prev / jnp.maximum(dist2, 1e-20))
        # finalize the vertex: fold it into the streaming G recurrence
        g_new = jnp.where(
            depth == 0, 0.0,
            jnp.where(hit.mtl.eta > 0.0, 0.0,
                      (1.0 + pdf_rev * state["g_mis"])
                      / jnp.maximum(pdf_fwd, PDF_FWD_FLOOR)))

        new_tp = state["tp"] * s.value * jnp.where(
            s.is_delta, 1.0,
            jnp.abs(dot(hit.normal, s.wi)) / jnp.maximum(s.pdf, 1e-20)
        )[..., None]
        tp_valid = is_valid_color(new_tp)

        off_delta = jnp.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                              -hit.normal, hit.normal) * EPSILON
        new_ro = jnp.where(delta[:, None], hit.pos + off_delta,
                           hit.pos + hit.normal * EPSILON)
        new_depth = depth + jnp.where(rough, 1, 0)

        upd = delta | rough
        alive = jnp.where(act, upd & (delta | (tp_valid
                                               & (new_depth < cfg.eye_depth))),
                          alive)
        alive = alive & jnp.where(delta, tp_valid, True)

        new_state = dict(
            ro=jnp.where(upd[:, None], new_ro, state["ro"]),
            rd=jnp.where(upd[:, None], s.wi, state["rd"]),
            tp=jnp.where(upd[:, None], new_tp, state["tp"]),
            radiance=radiance,
            eta=jnp.where(upd, s.new_eta, state["eta"]),
            depth=new_depth,
            alive=alive,
            # eye delta branch DOES update last_* with pdf=1 (:492-494)
            last_normal=jnp.where(upd[:, None], hit.normal,
                                  state["last_normal"]),
            last_pos=jnp.where(upd[:, None], hit.pos, state["last_pos"]),
            last_pdf=jnp.where(delta, 1.0,
                               jnp.where(rough, s.pdf, state["last_pdf"])),
            g_mis=jnp.where(rough, g_new, state["g_mis"]),
            prev_vpos=jnp.where(rough[:, None], hit.pos, state["prev_vpos"]),
        )
        return new_state, None

    state, _ = jax.lax.scan(body, state, jnp.arange(cfg.max_eye_iters))
    final = state["radiance"]
    return jnp.where(is_valid_color(final)[:, None], final, 0.0)


@partial(jax.jit, static_argnames=("width", "height", "spp", "spl",
                                   "light_sample", "cfg", "oracle", "chunk"))
def render_bdpt(scene: Scene, cam: Camera, width: int, height: int, spp: int,
                spl: int, cfg: RenderConfig, key, light_sample: int = 0,
                oracle: bool = False, chunk: int = 128) -> jnp.ndarray:
    """Render one BDPT frame, (H*W, 3) mean radiance over spp.

    GPU-parity mode (``oracle=False``) mirrors the CLI call chain
    (main_cli.cpp:202,212 -> bdpt_cu_helper.cpp:61-67 -> bdpt_render_wrapper):
    ``light_sample`` defaults to ``spl``; light flux is divided by
    ``light_sample`` at marshal time AND per-path throughput by ``spl``
    in-kernel (quirk 4); total paths = Nl*light_sample*spl; a depth-0 eye hit
    on a light adds base_color*light_sample (bdpt_cu.cu:359).

    Oracle mode reproduces ``run_cpu_bdpt`` (cpu_bdpt.cpp:173-488): raw flux,
    Nl*spl paths, depth-0 light hit adds base_color, and shadow rays that
    dielectrics do not block.  Combined with a fixed key this is the
    deterministic ground truth the reference only had on CPU.
    """
    if oracle:
        cfg = cfg.with_(shadow_dielectrics_block=False)
        num_paths = scene.num_lights * spl
        light_hit_scale = 1.0
        scene_used = scene
    else:
        ls = light_sample or spl
        scene_used = scene.with_illum_scaled(1.0 / ls)
        num_paths = scene.num_lights * ls * spl
        light_hit_scale = float(ls)

    B = width * height
    idx = jnp.arange(B, dtype=jnp.int32)
    px = idx % width
    py = idx // width

    lv = trace_light_paths(scene_used, cfg, num_paths, spl,
                           jax.random.fold_in(key, 0x0101))
    return eye_pass(scene_used, lv, cam, cfg, px, py, spp, key,
                    light_hit_scale, chunk)


def eye_pass(scene_used: Scene, lv, cam: Camera, cfg: RenderConfig,
             px, py, spp: int, key, light_hit_scale: float,
             chunk: int = 128, start=0,
             total: int | None = None) -> jnp.ndarray:
    """Mean-over-spp eye trace + connect against a (possibly all-gathered)
    light-vertex tensor, shared by ``render_bdpt`` and
    ``parallel.shard.render_bdpt_sharded``.

    ``start``/``total``: global-lane RNG so a sharded eye pass draws the
    exact bits of the matching single-device lane slice."""
    B = px.shape[0]
    # hoist the O(V log V) compaction out of the per-spp scan (the vertex
    # set is sample-invariant; only the RIS re-draw is per-sample)
    lv_flat, n_valid = compact_flat(lv.flat())

    def body(acc, sidx):
        c = eye_trace_and_connect(
            scene_used, cam, cfg, lv_flat, n_valid, px, py,
            jax.random.fold_in(jax.random.fold_in(key, 0x0202), sidx),
            light_hit_scale, chunk, start, total)
        return acc + c, None

    acc, _ = jax.lax.scan(body, jnp.zeros((B, 3)), jnp.arange(spp))
    return acc / spp


def render_oracle(scene: Scene, cam: Camera, width: int, height: int,
                  spp: int, spl: int, cfg: RenderConfig, seed: int = 1337,
                  chunk: int = 128) -> jnp.ndarray:
    """Deterministic BDPT ground truth (the ``run_cpu_bdpt`` replacement).

    Bit-reproducible for a given seed on any backend — the reference's
    deterministic path only existed on CPU with OpenMP thread seeds
    (cpu_bdpt.cpp:213,338).
    """
    return render_bdpt(scene, cam, width, height, spp, spl, cfg,
                       jax.random.PRNGKey(seed), oracle=True, chunk=chunk)
