"""Literal NumPy transcription of the reference PPM estimator.

Source semantics: reference ``src/ppm_cu.cu`` — ``ppm_eye_trace``
(:64-150), ``ppm_photon_trace`` (:156-295), ``ppm_resolve_image``
(:300-322) and the wrapper's photon count (``num_lights * spl``, :353).
The one deliberate difference mirrors the framework's documented choice
(integrators/ppm.py): the gather is an EXACT all-pairs ball query instead
of the reference's spatial hash, i.e. reference semantics minus the hash's
rare in-neighborhood collision double-counts.

Scope (same as ``pt_numpy_oracle``): materials with eta == 0 and
metallic == 0 (the rough branch of ``bsdf_sample``), spot-sphere lights
(``is_parallel == 0``).  Completely independent of the framework: NumPy
float64, its own RNG — comparisons are statistical (two estimators of the
same integral).
"""
from __future__ import annotations

import numpy as np

from pt_numpy_oracle import (EPS, PI, _bsdf_eval_pdf, _bsdf_sample, _clamp,
                             _dot, _norm, _valid, find_closest_hit)


def _emit_spot(light_pos, light_dir, light_r, cutoff, li, rng):
    """Cone-uniform spot-sphere emission (ppm_cu.cu:195-211; the same
    branch BDPT uses, bdpt_cu.cu:64-89)."""
    n = li.shape[0]
    w = _norm(light_dir[li])
    u0 = np.where((np.abs(w[:, 0]) > 0.9)[:, None],
                  np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    v = _norm(np.cross(w, u0))
    u = _norm(np.cross(v, w))
    u1 = rng.random(n)
    u2 = rng.random(n)
    theta = np.arccos(1.0 - u1 * (1.0 - np.cos(cutoff[li])))
    phi = 2.0 * PI * u2
    local = np.stack([np.sin(theta) * np.cos(phi),
                      np.sin(theta) * np.sin(phi),
                      np.cos(theta)], axis=-1)
    d = _norm(u * local[:, 0:1] + v * local[:, 1:2] + w * local[:, 2:3])
    o = light_pos[li] + d * light_r[li][:, None]
    return o, d


def render_ppm_numpy(scene, cam, W, H, spl, radius, eye_depth, light_depth,
                     seed=0):
    """One PPM pass -> (W*H, 3) radiance (direct delta-chain light hits +
    flux/(pi r^2)), by the reference estimator."""
    rng = np.random.default_rng(seed)
    B = W * H
    nl = scene["light_pos"].shape[0]
    image = np.zeros((B, 3))

    # ---- eye pass (ppm_cu.cu:64-150): delta chains only; the first rough
    # hit deposits a hitpoint and the ray stops.  In this oracle's material
    # scope nothing is delta, so one intersection decides every pixel.
    idx = np.arange(B)
    fx = (idx % W) + rng.random(B)
    fy = (idx // W) + rng.random(B)
    ro = np.tile(cam["eye"], (B, 1))
    rd = _norm(cam["ul"] + cam["dx"] * fx[:, None]
               + cam["dy"] * fy[:, None] - cam["eye"])
    tp = np.ones((B, 3))
    hit, t, pos, n, mtl, is_light = find_closest_hit(scene, ro, rd)
    light0 = hit & is_light          # last_is_delta == True at depth 0
    contrib = tp * mtl[:, 0:3]       # light-ball mtl.base_color = illum
    ok = light0 & _valid(contrib)
    image = np.where(ok[:, None], _clamp(contrib), image)

    hp_valid = hit & ~is_light
    hp_pos, hp_n, hp_mtl = pos, n, mtl
    hp_wo = -rd
    hp_tp = tp
    hp_flux = np.zeros((B, 3))

    # ---- photon pass (ppm_cu.cu:156-295) ----
    N = nl * spl
    li = np.arange(N) % nl
    p_ro, p_rd = _emit_spot(scene["light_pos"], scene["light_dir"],
                            scene["light_r"], scene["light_cutoff"], li, rng)
    flux = scene["light_illum"][li] * float(nl) / max(float(spl), 1.0)
    alive = np.ones(N, bool)

    r2 = radius * radius
    for _ in range(light_depth):
        if not alive.any():
            break
        hit, t, pos, n, mtl, is_light = find_closest_hit(scene, p_ro, p_rd)
        alive &= hit & ~is_light

        # splat gate (ppm_cu.cu:228): eta <= 0 and not a smooth conductor
        splat = alive & (mtl[:, 5] <= 0.0) & ((mtl[:, 4] < 0.99)
                                              | (mtl[:, 3] > 0.01))
        ev = np.nonzero(splat)[0]
        if ev.size and hp_valid.any():
            hv = np.nonzero(hp_valid)[0]
            d2 = np.sum((hp_pos[hv][:, None, :] - pos[ev][None, :, :]) ** 2,
                        axis=-1)
            ndot = hp_n[hv] @ n[ev].T
            pair = (d2 < r2) & (ndot > 0.01)
            bi, ei = np.nonzero(pair)
            if bi.size:
                h = hv[bi]
                e = ev[ei]
                wi_light = -p_rd[e]
                brdf, _ = _bsdf_eval_pdf(hp_mtl[h], hp_wo[h], wi_light,
                                         hp_n[h])
                good = _valid(brdf)
                energy = flux[e] * brdf * hp_tp[h]
                np.add.at(hp_flux, h[good], energy[good])

        # bounce (ppm_cu.cu:268-293); wo := wi_light, rough branch
        wi_light = -p_rd
        wi, f, pdf = _bsdf_sample(mtl, wi_light, n,
                                  rng.random(N), rng.random(N),
                                  rng.random(N))
        alive &= pdf > 0.0
        cos_wi = np.abs(_dot(n, wi))
        flux = np.where(alive[:, None],
                        flux * f * (cos_wi / np.maximum(pdf, 1e-300))[:, None],
                        flux)
        alive &= _valid(flux)
        off = np.where(_dot(wi, n)[:, None] < 0.0, -n, n) * 1e-4
        p_ro = np.where(alive[:, None], pos + off, p_ro)
        p_rd = np.where(alive[:, None], wi, p_rd)

    # ---- resolve (ppm_cu.cu:300-322) ----
    radiance = hp_flux / max(PI * r2, 1e-6)
    ok = hp_valid & _valid(radiance)
    image = image + np.where(ok[:, None], _clamp(radiance), 0.0)
    return image
