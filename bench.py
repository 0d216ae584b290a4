"""Benchmarks of the render configurations, on one NVIDIA GPU.

Default (no args): the headline — Mpaths/s at 1080p unidirectional PT on the
MIS scene, spp 4.  Prints ONE JSON line:

  {"metric": ..., "value": N, "unit": "Mpaths/s", "platform": ..., ...}

``--config N`` runs one of the five configurations (each prints its own
single JSON line).  Defaults are the full shapes (config 2 spp 256, config 3
spp 1024, config 4 ten 1M-photon passes); ``--spp``/``--fast`` shrink them
for smoke runs:
  1  deterministic BDPT oracle, cornell.txt, 256x256, 16 spp (ground truth)
  2  PT + NEE + MIS, mis.txt, 512x512, 256 spp
  3  OBJ mesh + clusters, 1080p PT, 1024 spp (sphere fixture unless --obj)
  4  PPM, cornell.txt, 512x512, 10 passes x 1M photons
  5  BDPT, cornell.txt, 1080p, RIS light-vertex resampling K=32
     (--resample 0 --res 512x512 recovers the exact all-pairs sweep)
  rmse  seconds for a progressive BDPT render to reach 8-bit RMSE < 13
        against a converged oracle fixture

Every record names the device it ran on (platform, device kind and count,
JAX version, XLA_FLAGS, the card's name and power limit).  A run that finds
no GPU prints an error record and exits non-zero: it does not fall back to
the CPU.  Timed regions end in ``block_until_ready``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _timeit(fn, iters=3):
    import jax

    jax.block_until_ready(fn(0))  # compile + warm
    t0 = time.perf_counter()
    for i in range(iters):
        jax.block_until_ready(fn(i + 1))
    return (time.perf_counter() - t0) / iters


def run(args) -> dict:
    """Run the selected config and return the result record."""
    import jax
    import numpy as np

    from path_tracing_tpu.config import RenderConfig
    from path_tracing_tpu.scene import scene_path
    from path_tracing_tpu.scene.camera import make_camera
    from path_tracing_tpu.scene.obj_loader import load_any_scene

    key = jax.random.PRNGKey(0)
    cornell, mis = scene_path("cornell.txt"), scene_path("mis.txt")

    def setup(path, W, H, **cfg_kw):
        p = load_any_scene(path)
        scene = p.to_device()
        cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
        return scene, cam, RenderConfig(width=W, height=H, **cfg_kw)

    if args.config == "rmse":
        # wall seconds for a fresh progressive BDPT render to reach 8-bit
        # RMSE < 13 against a converged deterministic oracle (committed
        # fixture; --regen-rmse-target rebuilds it by averaging 256
        # independent oracle-mode passes)
        from path_tracing_tpu.film import tonemap_u8
        from path_tracing_tpu.integrators.bdpt import render_bdpt

        W = H = 128
        scene, cam, cfg = setup(cornell, W, H, eye_depth=4, light_depth=4,
                                delta_budget=4)
        # progressive estimator: oracle mode (the GPU-parity estimator
        # differs from the oracle by the dielectric shadow rule and
        # plateaus above the target — a real reference property, not noise)
        f = lambda k, i: render_bdpt(scene, cam, W, H, 4, 16, cfg,
                                     jax.random.fold_in(k, i), oracle=True)
        fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures", "rmse_target_128.npy")
        if args.regen_rmse_target or not os.path.exists(fixture):
            print("regenerating converged target (256 passes)...",
                  file=sys.stderr)
            tkey = jax.random.PRNGKey(0xA5A5)  # disjoint from measure keys
            tacc = np.zeros((W * H, 3))
            for i in range(256):
                tacc += np.asarray(f(tkey, i))
            np.save(fixture, (tacc / 256).astype(np.float32))
        target = tonemap_u8(np.load(fixture), W, H).astype(np.float32)

        jax.block_until_ready(f(key, 0))  # warm compile outside the timing
        acc = np.zeros((W * H, 3))
        t0 = time.perf_counter()
        rmse = 1e9
        for i in range(1, 129):
            acc += np.asarray(f(key, i))
            u8 = tonemap_u8(acc / i, W, H)
            rmse = float(np.sqrt(np.mean(
                (u8.astype(np.float32) - target) ** 2)))
            if rmse < 13.0:
                break
        dt = time.perf_counter() - t0
        return {"metric": f"time-to-RMSE<13 (8-bit) vs converged oracle, "
                          f"BDPT 128^2 (reached {rmse:.1f} after {i} passes)",
                "value": dt, "unit": "s"}

    c = int(args.config)
    if c in (0, 2, 3):
        from path_tracing_tpu.integrators.pt import render_pt

        if c == 3:
            W, H, spp = 1920, 1080, args.spp or 1024
            if args.gen_tris:
                from path_tracing_tpu.scene.synth import icosphere_scene

                p = icosphere_scene(args.gen_tris, textured=args.gen_tex)
                scene = p.to_device()
                cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
                cfg = RenderConfig(width=W, height=H, eye_depth=4,
                                   delta_budget=4)
                kind = "synthetic icosphere" + (" textured" if args.gen_tex
                                                else "")
            else:
                scene, cam, cfg = setup(args.obj, W, H, eye_depth=4,
                                        delta_budget=4)
                kind = "OBJ mesh" + (" textured" if scene.has_textures
                                     else "")
            name = (f"config3 1080p PT over {kind} "
                    f"({scene.num_triangles} tris), spp={spp}")
        elif c == 2:
            W, H, spp = 512, 512, args.spp or 256
            scene, cam, cfg = setup(mis, W, H, eye_depth=4, delta_budget=4)
            name = f"config2 PT+NEE+MIS mis.txt 512^2 spp={spp}"
        else:
            W, H, spp = 1920, 1080, args.spp or 4
            path = args.scene or mis
            scene, cam, cfg = setup(path, W, H, eye_depth=4, delta_budget=4)
            name = (f"1080p unidirectional PT (NEE+MIS), "
                    f"{os.path.basename(path)}, spp={spp}, eye_depth=4")
        # big shapes: one timed pass is plenty (the estimator is a spp loop)
        iters = 1 if W * H * spp > 600_000_000 else 3
        # bound the work of one launch: split a large spp into equal chunks
        # (the same estimator, accumulated on the host side of the loop)
        chunk = spp
        if W * H * spp > 600_000_000:
            for cand in (16, 8, 4, 2, 1):
                if spp % cand == 0:
                    chunk = cand
                    break

        if chunk == spp:
            dt = _timeit(lambda i: render_pt(scene, cam, W, H, spp, cfg,
                                             jax.random.fold_in(key, i)),
                         iters=iters)
        else:
            # warm/compile with ONE chunk launch, then time the full
            # chunked accumulation once (the loop reuses the compiled fn)
            jax.block_until_ready(render_pt(scene, cam, W, H, chunk, cfg,
                                            jax.random.fold_in(key, 0)))
            t0 = time.perf_counter()
            acc = None
            for j in range(spp // chunk):
                img = render_pt(scene, cam, W, H, chunk, cfg,
                                jax.random.fold_in(key, j + 1))
                acc = img if acc is None else acc + img
            jax.block_until_ready(acc)
            dt = time.perf_counter() - t0
        rec = {"metric": name, "value": W * H * spp / dt / 1e6,
               "unit": "Mpaths/s"}
        if chunk != spp:
            rec["chunked_spp"] = chunk
        return rec
    elif c == 1:
        from path_tracing_tpu.integrators.bdpt import render_oracle

        W = H = 256
        scene, cam, cfg = setup(cornell, W, H, eye_depth=4, light_depth=4,
                                delta_budget=4)
        dt = _timeit(lambda i: render_oracle(scene, cam, W, H, 16, 8, cfg,
                                             seed=1337), iters=1)
        return {"metric": "config1 BDPT oracle cornell.txt 256^2 spp=16 "
                          "spl=8 (deterministic)",
                "value": W * H * 16 / dt / 1e6, "unit": "Mpaths/s"}
    elif c == 4:
        from path_tracing_tpu.integrators.ppm import render_ppm_with_stats

        W = H = 512
        photons = 1_000_000
        passes = 1 if args.fast else 10
        # stratified subsampling of 32 events per cell: unbiased, and the
        # gather never overflows its budget
        scene, cam, cfg = setup(cornell, W, H, eye_depth=4, light_depth=4,
                                delta_budget=4, ppm_max_per_cell=128,
                                ppm_cell_samples=32)
        spl = photons // max(scene.num_lights, 1)

        def one_pass(i):
            img, _count, _overflow = render_ppm_with_stats(
                scene, cam, W, H, spl, cfg, jax.random.fold_in(key, i))
            return img

        jax.block_until_ready(one_pass(0))  # compile + warm
        t0 = time.perf_counter()
        acc = None
        for i in range(passes):
            img = one_pass(i + 1)
            acc = img if acc is None else acc + img
        jax.block_until_ready(acc)
        dt = time.perf_counter() - t0
        return {"metric": f"config4 PPM cornell.txt 512^2, {passes} "
                          f"pass(es) x 1M photons, 32 samples per cell",
                "value": photons * passes / dt / 1e6, "unit": "Mphotons/s"}
    elif c == 5:
        from path_tracing_tpu.integrators.bdpt import render_bdpt

        W, H = (1920, 1080) if not args.res else tuple(
            int(v) for v in args.res.split("x"))
        spp, spl = args.spp or 4, 8
        resample = 32 if args.resample is None else args.resample
        scene, cam, cfg = setup(cornell, W, H, eye_depth=4, light_depth=4,
                                delta_budget=4,
                                bdpt_connection_samples=args.conn_samples,
                                bdpt_resample_vertices=resample)
        dt = _timeit(lambda i: render_bdpt(scene, cam, W, H, spp, spl, cfg,
                                           jax.random.fold_in(key, i)),
                     iters=2)
        cs, rs = args.conn_samples, resample
        return {"metric": f"config5 BDPT cornell.txt {W}x{H} spp={spp} "
                          f"spl={spl}"
                          + (f" conn_samples={cs}" if cs else "")
                          + (f" resample_K={rs}" if rs else ""),
                "value": W * H * spp / dt / 1e6, "unit": "Mpaths/s"}
    raise ValueError(f"unknown config {args.config!r}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="0",
                    help="0 = headline 1080p PT; 1-5 = the configurations "
                         "above; 'rmse' = time-to-target-RMSE vs the oracle")
    ap.add_argument("--scene", default="",
                    help="config 0: scene file override (default "
                         "scenes/mis.txt)")
    ap.add_argument("--obj", default="tests/fixtures/sphere.obj")
    ap.add_argument("--gen-tris", type=int, default=0,
                    help="config 3: render a synthetic icosphere with >= N "
                         "triangles instead of --obj")
    ap.add_argument("--gen-tex", action="store_true",
                    help="config 3 with --gen-tris: add spherical UVs + a "
                         "checker texture (the textured-mesh benchmark)")
    ap.add_argument("--spp", type=int, default=0)
    ap.add_argument("--res", default="",
                    help="config 5: WxH override (e.g. 1920x1080)")
    ap.add_argument("--fast", action="store_true",
                    help="config 4: one pass instead of ten")
    ap.add_argument("--conn-samples", type=int, default=0,
                    help="config 5: unbiased per-eye-vertex connection "
                         "subsample (0 = exact all-pairs)")
    ap.add_argument("--resample", type=int, default=None,
                    help="config 5: importance-cull the light-vertex table "
                         "to K rows by unbiased RIS resampling (0 = full "
                         "table; default 32)")
    ap.add_argument("--regen-rmse-target", action="store_true",
                    help="rebuild the committed converged-oracle fixture "
                         "used by --config rmse")
    args = ap.parse_args()

    from path_tracing_tpu.runtime import device_record, setup_jax_cache

    setup_jax_cache()
    device = device_record()
    if device["platform"] != "gpu":
        print(json.dumps({"metric": f"bench --config {args.config}",
                          "error": f"no GPU: JAX's default device is "
                                   f"{device['platform']}", **device}))
        return 1
    try:
        rec = run(args)
    except Exception as e:  # noqa: BLE001 — report the failure as the record
        print(json.dumps({"metric": f"bench --config {args.config}",
                          "error": f"{type(e).__name__}: {e}", **device}))
        raise
    print(json.dumps({**rec, **device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
