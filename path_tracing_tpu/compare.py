"""Comparator app: all three integrators side by side with convergence
telemetry.

Headless re-creation of the reference GUI's *function* (SURVEY.md §7 step 7):
each iteration renders PPM, BDPT and PT (main.cpp:399-419), accumulates
linear radiance, tracks four RMS histories — per-integrator frame-to-frame
8-bit RMS plus the PPM-vs-BDPT cross RMS ``diff_rms`` (main.cpp:502-531) —
and emits a side-by-side ``3W x H`` PNG (the GUI's packed texture,
main.cpp:433-437) plus a convergence CSV/plot (replacing the gnuplot pipe,
main.cpp:275-282,533-559).

Quirk 10 fixed: the reference's saved "combined" PNG actually contained the
PT image; ours really is the three-up frame.

    python -m path_tracing_tpu.compare --input scenes/cornell.txt \
        --iters 8 --width 64 --height 64 --out-dir cmp_out
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .scene import scene_path


def rms_8bit(a_u8: np.ndarray, b_u8: np.ndarray) -> float:
    """Frame-to-frame RMS on 8-bit frames, as main.cpp:502-528 computes it."""
    d = a_u8.astype(np.float32) - b_u8.astype(np.float32)
    return float(np.sqrt(np.mean(d * d)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="path_tracing_tpu.compare")
    ap.add_argument("--input", default=scene_path("cornell.txt"))
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--spl", type=int, default=4)
    ap.add_argument("--ppm-photons", type=int, default=10000,
                    help="photons per PPM pass (GUI used spl=1e6)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--eye-depth", type=int, default=4)
    ap.add_argument("--light-depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="compare_out")
    ap.add_argument("--live-http", nargs="?", const=8000, type=int,
                    default=None, metavar="PORT",
                    help="serve the accumulating [ppm|bdpt|pt] 3-up frame "
                         "at http://host:PORT/ after every iteration — the "
                         "reference GUI's live side-by-side window "
                         "(main.cpp:489-500) in a browser")
    args = ap.parse_args(argv)

    import jax

    from .runtime import setup_jax_cache
    setup_jax_cache()
    from .config import RenderConfig
    from .film import tonemap_u8, write_png
    from .integrators.bdpt import render_bdpt
    from .integrators.ppm import render_ppm_with_stats
    from .integrators.pt import render_pt
    from .profiling import Telemetry
    from .scene.camera import make_camera
    from .scene.parser import load_scene

    os.makedirs(args.out_dir, exist_ok=True)
    parsed = load_scene(args.input)
    W = args.width or parsed.width
    H = args.height or parsed.height
    scene = parsed.to_device()
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=args.eye_depth,
                       light_depth=args.light_depth, seed=args.seed)
    tel = Telemetry(os.path.join(args.out_dir, "telemetry.jsonl"))
    key = jax.random.PRNGKey(args.seed)

    acc = {k: np.zeros((W * H, 3)) for k in ("ppm", "bdpt", "pt")}
    prev_u8 = {k: None for k in ("ppm", "bdpt", "pt")}
    hist: list[dict] = []

    live_http = None
    if args.live_http is not None:
        from .runtime.live_http import LiveServer

        live_http = LiveServer(args.live_http)
        print(f"[Live] serving http://{live_http.host}:{live_http.port}/")

    try:
        for it in range(args.iters):
            k = jax.random.fold_in(key, it)
            with tel.phase("ppm", paths=args.ppm_photons, iter=it):
                img, _, _ = render_ppm_with_stats(
                    scene, cam, W, H, args.ppm_photons, cfg,
                    jax.random.fold_in(k, 1))
                img.block_until_ready()
            acc["ppm"] += np.asarray(img)
            with tel.phase("bdpt", paths=W * H * args.spp, iter=it):
                img = render_bdpt(scene, cam, W, H, args.spp, args.spl,
                                  cfg, jax.random.fold_in(k, 2))
                img.block_until_ready()
            acc["bdpt"] += np.asarray(img)
            with tel.phase("pt", paths=W * H * args.spp, iter=it):
                img = render_pt(scene, cam, W, H, args.spp, cfg,
                                jax.random.fold_in(k, 3))
                img.block_until_ready()
            acc["pt"] += np.asarray(img)

            row = {"iter": it}
            u8 = {}
            for name in ("ppm", "bdpt", "pt"):
                u8[name] = tonemap_u8(acc[name] / (it + 1), W, H)
                row[f"rms_{name}"] = (
                    rms_8bit(u8[name], prev_u8[name])
                    if prev_u8[name] is not None else float("nan"))
                prev_u8[name] = u8[name]
            row["diff_rms"] = rms_8bit(u8["ppm"], u8["bdpt"])
            hist.append(row)
            tel.emit(**row)
            print(f"iter {it}: " + "  ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))
            if live_http is not None:
                from .film import encode_png

                # stream the four RMS histories too — the live page plots
                # them as sparklines (the GUI's gnuplot window,
                # main.cpp:533-559, during the render instead of after it)
                live_http.update(encode_png(np.concatenate(
                    [u8["ppm"], u8["bdpt"], u8["pt"]], axis=1)), it + 1,
                    stats={k: v for k, v in row.items() if k != "iter"})
    finally:
        # close even when an iteration raises — a leaked LiveServer keeps
        # its port bound for the rest of the (possibly library) process
        if live_http is not None:
            live_http.close()

    # side-by-side 3W x H frame: [ppm | bdpt | pt] (main.cpp:489-500 layout)
    combined = np.concatenate([u8["ppm"], u8["bdpt"], u8["pt"]], axis=1)
    write_png(os.path.join(args.out_dir, "combined.png"), combined)
    for name in ("ppm", "bdpt", "pt"):
        write_png(os.path.join(args.out_dir, f"{name}.png"), u8[name])

    # convergence CSV (+ plot when matplotlib exists)
    csv_path = os.path.join(args.out_dir, "convergence.csv")
    with open(csv_path, "w") as f:
        cols = ["iter", "rms_ppm", "rms_bdpt", "rms_pt", "diff_rms"]
        f.write(",".join(cols) + "\n")
        for row in hist:
            f.write(",".join(str(row[c]) for c in cols) + "\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        its = [r["iter"] for r in hist]
        for name in ("ppm", "bdpt", "pt", "diff"):
            col = f"rms_{name}" if name != "diff" else "diff_rms"
            ax.plot(its, [r[col] for r in hist], label=col)
        ax.set_xlabel("iteration")
        ax.set_ylabel("RMS (8-bit)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(args.out_dir, "convergence.png"), dpi=110)
    except Exception as e:  # matplotlib is optional
        print(f"[plot skipped: {e}]")

    print(f"[done] wrote {args.out_dir}/combined.png, {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
