"""Headless CLI — the equivalent of the reference's ``pt_cli``
(``src/main_cli.cpp:42-257``) with the same flags plus determinism/parity
extras.

    python -m path_tracing_tpu.cli --input scene.txt --mode pt --spp 8 \
        --output out.png

Flags mirror main_cli.cpp:54-73: ``--spp --spl --mode(pt|bdpt|ppm) \
--device(gpu|cpu|oracle) --output --input``; additions: ``--seed``,
``--iters`` (progressive passes), ``--checkpoint`` (save/resume accumulation
state), ``--eye-depth --light-depth``, ``--force-fov``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .scene import scene_path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="path_tracing_tpu",
                                 description=__doc__)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--spl", type=int, default=8)
    ap.add_argument("--mode", choices=["pt", "bdpt", "ppm"], default="pt")
    ap.add_argument("--device", choices=["gpu", "cpu", "oracle"],
                    default="gpu",
                    help="'gpu' fails unless JAX finds a GPU; 'cpu' renders "
                         "on the CPU; 'oracle' runs the deterministic "
                         "CPU-semantics BDPT ground truth (cpu_bdpt.cpp "
                         "equivalent) on the CPU")
    ap.add_argument("--output", default="output.png")
    ap.add_argument("--input", default=scene_path("cornell.txt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=1,
                    help="progressive accumulation passes")
    ap.add_argument("--checkpoint", default=None,
                    help="npz path; resumed if it exists, saved after render")
    ap.add_argument("--eye-depth", type=int, default=4)
    ap.add_argument("--light-depth", type=int, default=4)
    ap.add_argument("--force-fov", type=float, default=None,
                    help="override scene fov (the reference front-ends "
                         "hard-code 50; default honors the file)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--ppm-alpha", type=float, default=0.0,
                    help="progressive-PPM radius shrink factor (0 = the "
                         "reference's fixed radius)")
    ap.add_argument("--resample", type=int, default=0, metavar="K",
                    help="BDPT: importance-cull the light-vertex table to "
                         "K rows by contribution-proportional RIS "
                         "resampling (unbiased; 0 = the reference's exact "
                         "all-pairs sweep, bdpt_cu.cu:384-457)")
    ap.add_argument("--fix-pt-mis", action="store_true",
                    help="enable the full MIS light-hit term the reference "
                         "stubbed out (quirk 2)")
    ap.add_argument("--debug-nan", action="store_true",
                    help="enable jax_debug_nans: abort with a traceback the "
                         "moment any kernel produces a NaN (the debug-mode "
                         "sanitizer SURVEY.md §5 calls for; the release "
                         "path relies on is_valid_color rejection like the "
                         "reference)")
    ap.add_argument("--live", default=None, metavar="PATH",
                    help="progressive viewing: after every iteration write "
                         "the current accumulated image to PATH (atomically "
                         "replaced — point an image viewer at it).  If PATH "
                         "contains '{i}' it is formatted with the iteration "
                         "number instead, keeping per-pass history.  The "
                         "headless equivalent of the reference GUI's live "
                         "window (main.cpp:399-500)")
    ap.add_argument("--live-term", nargs="?", const=80, type=int,
                    default=None, metavar="COLS",
                    help="progressive viewing IN the terminal: after every "
                         "iteration redraw the accumulated image as 24-bit "
                         "ANSI half-blocks, COLS cells wide (default 80) — "
                         "the reference GUI's live window (main.cpp:399-500) "
                         "for a headless box / SSH session")
    ap.add_argument("--live-http", nargs="?", const=8000, type=int,
                    default=None, metavar="PORT",
                    help="progressive viewing IN the browser: serve the "
                         "accumulated frame at http://host:PORT/ (auto-"
                         "refreshing page + /frame.png), updated after "
                         "every iteration (runtime/live_http.py).  PORT 0 "
                         "picks a free port (printed).  The interactive "
                         "counterpart of the reference GUI window "
                         "(main.cpp:60-600) for a display-less host")
    ap.add_argument("--retries", type=int, default=1,
                    help="per-iteration retry budget for transient device "
                         "faults: on an exception the accumulated state is "
                         "checkpointed (if --checkpoint is set), jax caches "
                         "are cleared and the iteration re-runs "
                         "(runtime/resilience.py; the reference loses the "
                         "whole render on any CUDA fault).  0 disables")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the render loop to "
                         "DIR (view with TensorBoard/XProf) — the "
                         "structured replacement for the reference's "
                         "chrono couts")
    return ap


def install_signal_handlers(handlers: dict) -> dict:
    """Install ``{signal: handler}`` and return the handlers they replace.

    If an installation fails part way (not the main thread, a platform
    without that signal), the handlers already installed are put back and
    nothing is returned to restore."""
    import signal

    old = {}
    try:
        for sig, handler in handlers.items():
            old[sig] = signal.signal(sig, handler)
    except (ValueError, OSError):
        for sig, handler in old.items():
            signal.signal(sig, handler)
        return {}
    return old


def make_config(args, width: int, height: int):
    """The RenderConfig a parsed command line renders with."""
    from .config import RenderConfig, oracle_config

    cfg = RenderConfig(width=width, height=height, spp=args.spp,
                       spl=args.spl, eye_depth=args.eye_depth,
                       light_depth=args.light_depth, seed=args.seed,
                       pt_stub_mis_strategy_a=not args.fix_pt_mis,
                       ppm_alpha=args.ppm_alpha,
                       bdpt_resample_vertices=max(0, args.resample))
    return oracle_config(cfg) if args.device == "oracle" else cfg


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.live_term is not None and args.live_term < 2:
        parser.error("--live-term COLS must be >= 2")

    import jax
    import numpy as np

    if args.device in ("cpu", "oracle"):
        # before the first backend use; a no-op once backends are up
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        print(f"[Error] --device gpu: JAX found no GPU (default platform "
              f"{jax.devices()[0].platform}); use --device cpu",
              file=sys.stderr)
        return 1
    from .runtime import setup_jax_cache
    setup_jax_cache()
    if args.debug_nan:
        jax.config.update("jax_debug_nans", True)

    from .film import (AccumState, load_checkpoint, save_checkpoint,
                       save_image)
    from .scene.camera import make_camera
    from .scene.obj_loader import load_any_scene as load_scene

    if not os.path.exists(args.input):
        print(f"[Error] Cannot open input file: {args.input}", file=sys.stderr)
        return 1
    parsed = load_scene(args.input)
    W = args.width or parsed.width
    H = args.height or parsed.height
    scene = parsed.to_device()
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      W, H, force_fov=args.force_fov)

    cfg = make_config(args, W, H)
    mode = "bdpt" if args.device == "oracle" else args.mode

    print("====================================")
    print(f" Device : {args.device} ({jax.devices()[0].platform})")
    print(f" Mode   : {mode}")
    print(f" SPP    : {args.spp}")
    print(f" SPL    : {args.spl} (used in BDPT/PPM)")
    print(f" Input  : {args.input}")
    print(f" Output : {args.output}")
    print(f" Res    : {W}x{H}  seed={args.seed}  iters={args.iters}")
    print("====================================")
    print(f"Ball: {scene.num_spheres}  Triangle: {scene.num_triangles}  "
          f"Light: {scene.num_lights}")

    state = AccumState.zeros(W, H)
    start_iter = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        state, meta = load_checkpoint(args.checkpoint)
        ck_mode = str(meta.get("mode", mode))
        if state.radiance_sum.shape[0] != W * H or ck_mode != mode:
            print(f"[Error] checkpoint {args.checkpoint} is for "
                  f"{meta.get('width')}x{meta.get('height')} mode={ck_mode}, "
                  f"not {W}x{H} mode={mode}", file=sys.stderr)
            return 1
        start_iter = int(state.n_iters)
        print(f"[Resume] {args.checkpoint}: {start_iter} iters accumulated")

    key = jax.random.PRNGKey(args.seed)

    def frame(i):
        k = jax.random.fold_in(key, i)
        if mode == "pt":
            from .integrators.pt import render_pt
            return render_pt(scene, cam, W, H, args.spp, cfg, k)
        elif mode == "bdpt":
            from .integrators.bdpt import render_bdpt
            return render_bdpt(scene, cam, W, H, args.spp, args.spl, cfg, k)
        else:
            from .integrators.ppm import (ppm_radius_scale,
                                          render_ppm_with_stats)
            img, _, overflow = render_ppm_with_stats(
                scene, cam, W, H, args.spl, cfg, k,
                r2_scale=ppm_radius_scale(i, cfg.ppm_alpha))
            ov = int(overflow)
            if ov:
                print(f"[Warn] PPM gather dropped {ov} candidate events "
                      f"(raise ppm_max_per_cell or use ppm_cell_samples)",
                      file=sys.stderr)
            return img

    print("[Render] Starting Render...")
    import contextlib
    import signal

    # interactive in-render control for a headless host (the reference
    # GUI's ImGui "Save Image" button, main.cpp:386-391, re-imagined):
    #   SIGUSR1 -> snapshot the accumulation to <output>.snapN.png (+
    #              checkpoint) at the end of the current iteration
    #   SIGUSR2 -> save + stop gracefully (final image/checkpoint written
    #              through the normal exit path)
    _sig = {"snap": False, "stop": False}
    try:
        wanted = {signal.SIGUSR1: lambda *_: _sig.__setitem__("snap", True),
                  signal.SIGUSR2: lambda *_: _sig.__setitem__("stop", True)}
    except AttributeError:  # platform without SIGUSR1/2
        wanted = {}
    _old_handlers = install_signal_handlers(wanted)

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if args.profile:
            try:  # best-effort: failure to START tracing must not kill the render
                stack.enter_context(jax.profiler.trace(args.profile))
            except Exception as e:
                print(f"[Warn] jax.profiler unavailable: {e}", file=sys.stderr)
        live_http = None
        if args.live_http is not None:
            from .runtime.live_http import LiveServer
            live_http = LiveServer(args.live_http)
            stack.callback(live_http.close)
            print(f"[Live] serving http://{live_http.host}:"
                  f"{live_http.port}/")

        prev_u8 = None  # last tonemapped frame, for the live RMS series

        def on_frame(i, f):
            nonlocal state
            f.block_until_ready()
            # accumulate into a LOCAL and commit at the end: the live
            # outputs below can raise, and committing first would make a
            # RenderSupervisor retry re-run frame(i) AND re-add it
            # (iteration double-counted)
            new_state = state.add(f)
            dt = time.perf_counter() - t0
            print(f"[Render] iter {i + 1}: {dt * 1000:.1f} ms cumulative")
            any_live = (args.live or args.live_term is not None
                        or live_http is not None)
            if any_live:
                # ONE device->host transfer + tonemap shared by all sinks
                linear = (np.asarray(new_state.radiance_sum)
                          / max(int(new_state.n_iters), 1))
            if args.live:
                # substitute only the literal {i} token — .format() would
                # raise on paths with any other brace construct
                live = args.live.replace("{i}", str(i + 1))
                tmp = live + ".tmp"
                save_image(tmp, linear, W, H)
                os.replace(tmp, live)
                print(f"[Live] wrote {live}")
            if args.live_term is not None or live_http is not None:
                from .film import tonemap_u8

                u8 = tonemap_u8(linear, W, H)
            if args.live_term is not None:
                from .film import ansi_preview

                pre = ansi_preview(u8, max_cols=int(args.live_term))
                nl = pre.count("\n") + 1
                # redraw in place: the previous block was nl+1 lines
                # (preview + status), and since then this iteration printed
                # its '[Render] iter' line plus '[Live] wrote' when --live
                # is also on — climb past all of them
                up = nl + 2 + (1 if args.live else 0)
                lead = f"\x1b[{up}A" if i > start_iter else ""
                print(f"{lead}{pre}\n[Live] iter {i + 1}", flush=True)
            if live_http is not None:
                from .film import encode_png

                # frame-to-frame 8-bit RMS of the accumulation — the
                # GUI's per-integrator convergence series (main.cpp:502-528)
                # for the one integrator this CLI run renders; the live
                # page sparklines it
                nonlocal prev_u8
                rms = None
                if prev_u8 is not None:
                    d = u8.astype(np.float32) - prev_u8.astype(np.float32)
                    rms = float(np.sqrt(np.mean(d * d)))
                prev_u8 = u8
                live_http.update(encode_png(u8), i + 1,
                                 stats={"rms": rms} if rms is not None
                                 else None)
            state = new_state

            # ---- signal-driven in-render control ----
            if _sig["snap"]:
                _sig["snap"] = False
                snap = f"{args.output}.snap{i + 1}.png"
                save_image(snap, np.asarray(state.radiance_sum)
                           / max(int(state.n_iters), 1), W, H)
                if args.checkpoint:
                    save_checkpoint(args.checkpoint, state,
                                    {"mode": mode, "width": W, "height": H})
                print(f"[Signal] SIGUSR1: snapshot -> {snap}", flush=True)
            if _sig["stop"]:
                print("[Signal] SIGUSR2: stopping after iteration "
                      f"{i + 1}; saving", flush=True)
                raise StopRender

        from .runtime.resilience import RenderSupervisor, StopRender

        def salvage_checkpoint():
            if args.checkpoint:
                save_checkpoint(args.checkpoint, state,
                                {"mode": mode, "width": W, "height": H})

        try:
            RenderSupervisor(
                max_retries=max(args.retries, 0), backoff_s=2.0,
                checkpoint=salvage_checkpoint,
                log=lambda m: print(m, file=sys.stderr),
            ).run(frame, start_iter, args.iters, on_frame)
        except StopRender:
            pass  # SIGUSR2: fall through to the normal save path
        finally:
            for s, h in _old_handlers.items():
                signal.signal(s, h)
    total = time.perf_counter() - t0
    # completed iterations, not args.iters — a SIGUSR2 early stop would
    # otherwise overstate the printed throughput (review r5)
    done_iters = int(state.n_iters) - start_iter
    paths = W * H * args.spp * done_iters
    print(f"[Render] Finished in {total * 1000:.1f} ms "
          f"({paths / max(total, 1e-9) / 1e6:.2f} Mpaths/s, "
          f"{done_iters} iters)")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, state,
                        {"mode": mode, "width": W, "height": H})
        print(f"[Checkpoint] saved {args.checkpoint}")

    print(f"[Save] Writing to {args.output}...")
    save_image(args.output,
               np.asarray(state.radiance_sum)
               / max(int(state.n_iters), 1), W, H)
    print("[Success] Image saved!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
