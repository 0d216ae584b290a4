"""Literal-semantics NumPy transcription of the reference PT kernel.

An INDEPENDENT implementation of ``cuda_path_trace_kernel``
(reference src/pt_cu.cu:20-250) and the device math it calls
(geometric.cuh), written directly from the CUDA source, lane-vectorized in
NumPy.  It shares no code with ``path_tracing_tpu`` — it exists so
tests/test_pt_oracle.py can catch structural estimator bugs (e.g. a missing
throughput factor) that backend-vs-backend A/B tests are blind to because
both backends share the integrator logic.

Scope: rough (non-delta) materials including metals (FrSchlick, VNDF-only
sampling), sphere lights with spot-cone gates (scene keys ``light_dir`` /
``light_cutoff``; omitted = cutoff 0), stub MIS (quirk 2), binary shadow
blocking (quirk 12).
"""
from __future__ import annotations

import numpy as np

PI = np.float32(np.pi)
EPS = 1e-4
CLAMP = 15.0


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _isect_spheres(ro, rd, centers, radii, max_dist):
    """(B, Ns) hit t, inf on miss.  geometric.cuh:240-259."""
    oc = ro[:, None, :] - centers[None, :, :]
    b = _dot(oc, rd[:, None, :])
    c = _dot(oc, oc) - radii[None, :] ** 2
    h = b * b - c
    ok = h >= 0.0
    sh = np.sqrt(np.maximum(h, 0.0))
    t0, t1 = -b - sh, -b + sh
    in0 = ok & (t0 > EPS) & (t0 < max_dist)
    in1 = ok & (t1 > EPS) & (t1 < max_dist)
    t = np.where(in0, t0, np.where(in1, t1, np.inf))
    return t


def _isect_tris(ro, rd, v0, v1, v2, max_dist):
    """(B, Nt) hit t, inf on miss.  Moller-Trumbore, geometric.cuh:261-291."""
    e1 = (v1 - v0)[None]
    e2 = (v2 - v0)[None]
    h = np.cross(rd[:, None, :], e2)
    a = _dot(e1, h)
    ok = np.abs(a) > 1e-6
    f = 1.0 / np.where(ok, a, 1.0)
    s = ro[:, None, :] - v0[None]
    u = f * _dot(s, h)
    q = np.cross(s, e1)
    v = f * _dot(rd[:, None, :], q)
    t = f * _dot(e2, q)
    ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    ok &= (t > EPS) & (t < max_dist)
    return np.where(ok, t, np.inf)


def find_closest_hit(scene, ro, rd):
    """geometric.cuh:327-388: spheres, then light balls, then triangles;
    later categories win only on strictly smaller t; normals flip to face
    the ray."""
    B = ro.shape[0]
    best_t = np.full(B, 1e20, np.float64)
    normal = np.zeros((B, 3))
    mtl = np.zeros((B, 6))  # base_color3, roughness, metallic, eta
    is_light = np.zeros(B, bool)

    ts = _isect_spheres(ro, rd, scene["sph_c"], scene["sph_r"], 1e20)
    i = np.argmin(ts, axis=1) if ts.shape[1] else np.zeros(B, int)
    t = ts[np.arange(B), i] if ts.shape[1] else np.full(B, np.inf)
    upd = t < best_t
    best_t = np.where(upd, t, best_t)
    pos = ro + rd * best_t[:, None]
    if ts.shape[1]:
        n = _norm(pos - scene["sph_c"][i])
        normal = np.where(upd[:, None], n, normal)
        mtl = np.where(upd[:, None], scene["sph_m"][i], mtl)

    tl = _isect_spheres(ro, rd, scene["light_pos"], scene["light_r"], 1e20)
    i = np.argmin(tl, axis=1)
    t = tl[np.arange(B), i]
    upd = t < best_t
    best_t = np.where(upd, t, best_t)
    pos = ro + rd * best_t[:, None]
    n = _norm(pos - scene["light_pos"][i])
    normal = np.where(upd[:, None], n, normal)
    lm = np.concatenate([scene["light_illum"][i],
                         np.zeros((B, 3))], axis=1)  # mtl fields unused
    mtl = np.where(upd[:, None], lm, mtl)
    is_light = np.where(upd, True, is_light)

    tt = _isect_tris(ro, rd, scene["tri_v0"], scene["tri_v1"],
                     scene["tri_v2"], 1e20)
    i = np.argmin(tt, axis=1)
    t = tt[np.arange(B), i]
    upd = t < best_t
    best_t = np.where(upd, t, best_t)
    pos = ro + rd * best_t[:, None]
    n = _norm(np.cross(scene["tri_v1"][i] - scene["tri_v0"][i],
                       scene["tri_v2"][i] - scene["tri_v0"][i]))
    normal = np.where(upd[:, None], n, normal)
    mtl = np.where(upd[:, None], scene["tri_m"][i], mtl)
    is_light = np.where(upd, False, is_light)

    flip = _dot(normal, rd) > 0.0
    normal = np.where(flip[:, None], -normal, normal)
    hit = best_t < 1e20
    return hit, best_t, pos, normal, mtl, is_light


def check_visibility(scene, p1, p2):
    """Binary shadow (quirk 12: mtl_old.refract == 0 on device, so any
    occluder blocks).  geometric.cuh:293-325 with min_d/max_d margins."""
    diff = p2 - p1
    dist = np.linalg.norm(diff, axis=-1)
    d = diff / np.maximum(dist, 1e-20)[:, None]
    max_d = dist - 1e-3
    blocked = np.zeros(p1.shape[0], bool)
    tt = _isect_tris(p1, d, scene["tri_v0"], scene["tri_v1"],
                     scene["tri_v2"], max_d[:, None])
    blocked |= np.any(np.isfinite(tt) & (tt > 1e-3), axis=1)
    ts = _isect_spheres(p1, d, scene["sph_c"], scene["sph_r"],
                        max_d[:, None])
    if ts.shape[1]:
        blocked |= np.any(np.isfinite(ts) & (ts > 1e-3), axis=1)
    return np.where(blocked, 0.0, 1.0)


def _frame(n):
    """build_local_frame, geometric.cuh:119-124."""
    use_z = np.abs(n[:, 2]) < 0.999
    up = np.where(use_z[:, None], np.array([0.0, 0.0, 1.0]),
                  np.array([0.0, 1.0, 0.0]))
    t = _norm(np.cross(up, n))
    b = np.cross(n, t)
    return t, b


def _to_local(v, t, b, n):
    return np.stack([_dot(v, t), _dot(v, b), _dot(v, n)], axis=-1)


def _to_world(v, t, b, n):
    return t * v[:, 0:1] + b * v[:, 1:2] + n * v[:, 2:3]


def _fr_dielectric(cos_i, eta_i, eta_t):
    """geometric.cuh:146-160 (scalars eta_i/eta_t broadcast per lane)."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    cos_i = np.abs(np.where(entering, cos_i, np.abs(cos_i)))
    sin_i = np.sqrt(np.maximum(0.0, 1.0 - cos_i * cos_i))
    with np.errstate(divide="ignore", invalid="ignore"):
        sin_t = ei / et * sin_i
    tir = ~(sin_t < 1.0)  # catches nan and >= 1
    sin_t = np.where(tir, 0.0, sin_t)
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin_t * sin_t))
    rp = (et * cos_i - ei * cos_t) / np.maximum(et * cos_i + ei * cos_t,
                                                1e-20)
    rs = (ei * cos_i - et * cos_t) / np.maximum(ei * cos_i + et * cos_t,
                                                1e-20)
    fr = 0.5 * (rp * rp + rs * rs)
    return np.where(tir, 1.0, fr)


def _tr_d(wh, alpha):
    """TrowbridgeReitzD WITH the reference's tan2^2 quirk
    (geometric.cuh:180-187)."""
    c2 = wh[:, 2] ** 2
    s2 = np.maximum(0.0, 1.0 - c2)
    tan2 = s2 / (c2 + 1e-7)
    cos4 = c2 * c2
    e = cos4 * (alpha * alpha + tan2 * tan2)
    d = (alpha * alpha) / (PI * e)
    return np.where(e < 1e-12, 0.0, d)


def _tr_lambda(w, alpha):
    c2 = w[:, 2] ** 2
    s2 = np.maximum(0.0, 1.0 - c2)
    abs_tan = np.abs(np.sqrt(s2) / (w[:, 2] + 1e-7))
    a2t2 = (alpha * abs_tan) ** 2
    return (-1.0 + np.sqrt(1.0 + a2t2)) / 2.0


def _bsdf_eval_pdf(mtl, wo_w, wi_w, n):
    """bsdf_evaluate + bsdf_pdf (geometric.cuh:419-484), rough branch."""
    t, b = _frame(n)
    wo = _to_local(wo_w, t, b, n)
    wi = _to_local(wi_w, t, b, n)
    base, rough, metal, eta = (mtl[:, 0:3], mtl[:, 3], mtl[:, 4], mtl[:, 5])
    alpha = np.maximum(rough, 1e-3) ** 2

    wh_vec = wo + wi
    wh_len = np.linalg.norm(wh_vec, axis=-1)
    wh = wh_vec / np.maximum(wh_len, 1e-20)[:, None]
    wh = np.where((wh[:, 2] < 0.0)[:, None], -wh, wh)

    diffuse = base / PI * (1.0 - metal)[:, None]
    same_hemi = wo[:, 2] * wi[:, 2] > 0.0
    diffuse = np.where((wo[:, 2] * wi[:, 2] < 0.0)[:, None], 0.0, diffuse)
    D = _tr_d(wh, alpha)
    G = 1.0 / (1.0 + _tr_lambda(wo, alpha) + _tr_lambda(wi, alpha))
    # Fresnel (geometric.cuh:444-450): Schlick with base_color as F0 for
    # metals, exact dielectric otherwise
    fr = _fr_dielectric(_dot(wo, wh), 1.0, eta)[:, None]
    cos5 = (1.0 - np.abs(wo[:, 2]))[:, None] ** 5
    fr_s = base + (1.0 - base) * cos5
    F = np.where((metal > 0.0)[:, None], fr_s, fr)
    spec = F * (D * G / np.maximum(
        4.0 * np.abs(wo[:, 2]) * np.abs(wi[:, 2]), 1e-4))[:, None]
    f = np.where(same_hemi[:, None], diffuse + spec, diffuse)
    zero = (wo[:, 2] == 0.0) | (wi[:, 2] == 0.0) | (wh_len < 1e-6)
    f = np.where(zero[:, None], 0.0, f)

    pdf_diff = np.abs(wi[:, 2]) / PI
    g1 = 1.0 / (1.0 + _tr_lambda(wo, alpha))
    pdf_wh = _tr_d(wh, alpha) * g1 * np.maximum(0.0, _dot(wo, wh)) / \
        np.maximum(np.abs(wo[:, 2]), 1e-20)
    pdf_spec = pdf_wh / (4.0 * _dot(wo, wh) + 1e-7)
    # spec_weight (geometric.cuh:481-483,543): metals sample VNDF only
    sw = np.where(metal > 0.0, 1.0, 0.5)
    pdf = (1.0 - sw) * pdf_diff + sw * pdf_spec
    pdf = np.where(same_hemi & ~zero, pdf, 0.0)
    return f, pdf


def _bsdf_sample(mtl, wo_w, n, u_rr, u1, u2):
    """bsdf_sample rough branch (geometric.cuh:539-561); spec_weight 0.5,
    or 1.0 for metals."""
    t, b = _frame(n)
    wo = _to_local(wo_w, t, b, n)
    alpha = np.maximum(mtl[:, 3], 1e-3) ** 2

    # VNDF (geometric.cuh:200-221)
    woz = np.where((wo[:, 2] < 0.0)[:, None], -wo, wo)
    V = _norm(np.stack([alpha * woz[:, 0], alpha * woz[:, 1], woz[:, 2]],
                       axis=-1))
    t1 = np.where((V[:, 2] < 0.9999)[:, None],
                  _norm(np.cross(np.array([0.0, 0.0, 1.0]), V)),
                  np.array([1.0, 0.0, 0.0]))
    t2 = np.cross(V, t1)
    r = np.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * np.cos(phi)
    p2 = r * np.sin(phi)
    s = 0.5 * (1.0 + V[:, 2])
    p2 = (1.0 - s) * np.sqrt(np.maximum(0.0, 1.0 - p1 * p1)) + s * p2
    nh = (t1 * p1[:, None] + t2 * p2[:, None]
          + V * np.sqrt(np.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[:, None])
    wh = _norm(np.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                         np.maximum(0.0, nh[:, 2])], axis=-1))
    wh = np.where((wo[:, 2] < 0.0)[:, None], -wh, wh)
    d = -wo
    wi_spec = d - 2.0 * _dot(d, wh)[:, None] * wh
    bad_spec = wo[:, 2] * wi_spec[:, 2] <= 0.0

    # cosine lobe
    rr = np.sqrt(u1)
    wi_cos = np.stack([rr * np.cos(phi), rr * np.sin(phi),
                       np.sqrt(np.maximum(0.0, 1.0 - u1))], axis=-1)
    wi_cos[:, 2] = np.where(wo[:, 2] < 0.0, -wi_cos[:, 2], wi_cos[:, 2])

    sw = np.where(mtl[:, 4] > 0.0, 1.0, 0.5)  # metals sample VNDF only
    take_spec = u_rr < sw
    wi = np.where(take_spec[:, None], wi_spec, wi_cos)
    dead = take_spec & bad_spec
    wi_w = _to_world(wi, t, b, n)
    f, pdf = _bsdf_eval_pdf(mtl, wo_w, wi_w, n)
    pdf = np.where(dead, 0.0, pdf)
    return wi_w, f, pdf


def _valid(c):
    return np.isfinite(c).all(axis=-1) & (c >= 0.0).all(axis=-1)


def _clamp(c):
    mx = c.max(axis=-1)
    scale = np.where(mx > CLAMP, CLAMP / np.maximum(mx, 1e-20), 1.0)
    return c * scale[:, None]


def render_pt_numpy(scene, cam, W, H, spp, max_depth, seed=0):
    """Mean radiance (W*H, 3) by the reference PT estimator (stub MIS)."""
    rng = np.random.default_rng(seed)
    B = W * H * spp
    idx = np.arange(W * H)
    px = np.tile(idx % W, spp).astype(np.float64)
    py = np.tile(idx // W, spp).astype(np.float64)

    pix = (cam["ul"][None] + cam["dx"][None] * (px + rng.random(B))[:, None]
           + cam["dy"][None] * (py + rng.random(B))[:, None])
    ro = np.broadcast_to(cam["eye"], (B, 3)).copy()
    rd = _norm(pix - cam["eye"][None])

    tp = np.ones((B, 3))
    color = np.zeros((B, 3))
    alive = np.ones(B, bool)
    last_delta = np.ones(B, bool)
    nl = scene["light_pos"].shape[0]

    for _depth in range(max_depth):
        hit, t, pos, normal, mtl, is_light = find_closest_hit(scene, ro, rd)
        act = alive & hit
        wo = -rd

        # light hit: emission = illum / (area * cone_ratio), only credited
        # through a delta history (stub MIS); path terminates.  Cone logic
        # pt_cu.cu:62-94: depth 0 sees the whole ball, deeper hits from
        # behind the cone are dark
        c2l = pos[:, None, :] - scene["light_pos"][None]
        match = np.abs(np.linalg.norm(c2l, axis=-1)
                       - scene["light_r"][None]) < 1e-2
        li = np.argmax(match, axis=1)
        has_match = match.any(axis=1)
        area = 4.0 * PI * scene["light_r"][li] ** 2
        cutoff = scene.get("light_cutoff",
                           np.zeros(scene["light_pos"].shape[0]))[li]
        cone_ratio = np.ones(B)
        if "light_dir" in scene:
            main = _norm(scene["light_dir"])[li]
            c2h = _norm(pos - scene["light_pos"][li])
            behind = _dot(main, c2h) < np.cos(cutoff)
            cr = (1.0 - np.cos(cutoff)) / 2.0
            cone_ratio = np.where(cutoff > 0.0,
                                  np.where(_depth == 0, 1.0,
                                           np.where(behind, 0.0, cr)),
                                  1.0)
        emission = np.where((has_match & (cone_ratio > 0.0))[:, None],
                            scene["light_illum"][li]
                            / (area * np.maximum(cone_ratio, 1e-20))[:, None],
                            0.0)
        contrib = tp * emission
        add = act & is_light & last_delta & (emission > 0).any(axis=-1) \
            & _valid(contrib)
        color += np.where(add[:, None], _clamp(contrib), 0.0)
        alive = act & ~is_light

        # NEE (pt_cu.cu:125-199; contrib INCLUDES throughput)
        elig = alive & (mtl[:, 5] <= 0.0) & ((mtl[:, 4] < 0.99)
                                             | (mtl[:, 3] > 0.01))
        l_idx = np.minimum((rng.random(B) * nl).astype(int), nl - 1)
        par_flag = scene.get("light_parallel",
                             np.zeros(nl, np.int64))[l_idx] != 0

        # parallel branch (pt_cu.cu:130-149): no pdf, no MIS — just
        # brdf * illum * transmittance * cos * num_lights
        if par_flag.any():
            pdir = _norm(-scene["light_dir"])[l_idx]
            cos_p = np.maximum(0.0, _dot(normal, pdir))
            tr_p = check_visibility(scene, pos + normal * EPS,
                                    pos + pdir * 1e4)
            f_p, _ = _bsdf_eval_pdf(mtl, wo, pdir, normal)
            contrib = tp * f_p * scene["light_illum"][l_idx] \
                * (tr_p * cos_p * float(nl))[:, None]
            gate = elig & par_flag & (cos_p > 0) & (tr_p > 0) \
                & _valid(contrib)
            color += np.where(gate[:, None], _clamp(contrib), 0.0)
        elig = elig & ~par_flag
        zc = 1.0 - 2.0 * rng.random(B)
        ph = 2.0 * PI * rng.random(B)
        sr = np.sqrt(np.maximum(0.0, 1.0 - zc * zc))
        d_loc = np.stack([sr * np.cos(ph), sr * np.sin(ph), zc], axis=-1)
        lp = scene["light_pos"][l_idx] + d_loc * scene["light_r"][l_idx][:, None]
        wi_v = lp - pos
        dist2 = _dot(wi_v, wi_v)
        wi_l = wi_v / np.maximum(np.sqrt(dist2), 1e-20)[:, None]
        cos_s = np.maximum(0.0, _dot(normal, wi_l))
        cos_l = np.maximum(0.0, _dot(d_loc, -wi_l))
        tr = check_visibility(scene, pos + normal * EPS, lp + d_loc * EPS)
        f, pdf_b = _bsdf_eval_pdf(mtl, wo, wi_l, normal)
        area_l = 4.0 * PI * scene["light_r"][l_idx] ** 2
        pdf_ld = (1.0 / (nl * area_l)) * dist2 / np.maximum(cos_l, 1e-6)
        mis = pdf_ld ** 2 / np.maximum(pdf_ld ** 2 + pdf_b ** 2, 1e-8)
        contrib = (tp * f * scene["light_illum"][l_idx]
                   * (tr * cos_s / pdf_ld * mis)[:, None])
        # spot-cone gate (pt_cu.cu:166-171): the sample direction must lie
        # inside the light's cone when cutoff > 0
        inside = np.ones(B, bool)
        if "light_dir" in scene:
            cut = scene.get(
                "light_cutoff",
                np.zeros(scene["light_pos"].shape[0]))[l_idx]
            main = _norm(scene["light_dir"])[l_idx]
            inside = (cut <= 0.0) | (_dot(main, -wi_l) >= np.cos(cut))
        gate = elig & (cos_s > 0) & (cos_l > 0) & (tr > 0) & inside \
            & _valid(contrib)
        color += np.where(gate[:, None], _clamp(contrib), 0.0)

        # bounce
        wi_w, f, pdf = _bsdf_sample(mtl, wo, normal,
                                    rng.random(B), rng.random(B),
                                    rng.random(B))
        alive &= pdf > 0.0
        cw = np.abs(_dot(normal, wi_w))
        tp = np.where(alive[:, None],
                      tp * f * (cw / np.maximum(pdf, 1e-20))[:, None], tp)
        alive &= _valid(tp)
        ro = np.where(alive[:, None], pos + normal * EPS, ro)
        rd = np.where(alive[:, None], wi_w, rd)
        last_delta = np.where(act, False, last_delta)
        if not alive.any():
            break

    color = np.where(_valid(color)[:, None], color, 0.0)
    return color.reshape(spp, W * H, 3).mean(axis=0)
