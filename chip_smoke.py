"""Start-up proof on NVIDIA GPUs: the renderer's main path at full size.

    python chip_smoke.py             # one card: phases a-d below
    python chip_smoke.py --cards 4   # only the sharded renders over 4 cards

a. Device: fail unless JAX's default device is a GPU.  Prints the device,
   the JAX version, XLA_FLAGS, and the card's name and power limit as
   ``nvidia-smi`` reports them (a child process that does not use JAX).
b. Main path, through ``cli.main`` in this process with ``--device gpu
   --retries 0``, at the sizes users render:
     PT    scenes/mis.txt      1920x1080, spp 4
     BDPT  scenes/cornell.txt  1920x1080, spp 4, spl 4, RIS K=32
     PPM   scenes/cornell.txt  512x512, 1M photons per pass, 2 passes
   Before each CLI run the same jitted render is compiled ahead of time and
   timed (compile, then two renders ending in ``block_until_ready``), with
   its memory analysis and the process's peak device memory; the PPM run
   prints the gather's overflow count.  The CLI run must write a finite
   image with a nonzero mean.
c. Against the plain reference: each integrator at 64x64 under one key, on
   the GPU and on the CPU backend of this process, compared with
   ``imagecmp.agreement`` (tolerances in ``TOLERANCE``); and PT under
   ``jax.default_matmul_precision("highest")``, which must be bit-equal to
   the default render: no float32 contraction is left to run in TF32.
d. The last line of output is ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero and prints no ok line.  With ``--cards N``
the script renders PT and BDPT at 1920x1080 and PPM at 512x512 (250K
photons, exact gather) sharded over a flat N-card mesh, compares each with
the single-card render under the same key, and runs no other phase.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# GPU-against-CPU tolerance, per integrator: the largest fraction of pixels
# allowed to flip (imagecmp), with the median per-pixel relative error at
# most 1e-5 and the total energy within 1%.  The two backends draw the same
# random numbers; they differ only where FMA contraction, another
# summation order or another libm rounding pushes a branch across a
# threshold.  PPM moves a whole photon between neighbouring pixels when
# that happens, hence its larger share.
TOLERANCE = {"pt": 0.01, "bdpt": 0.01, "ppm": 0.05}


def check_render(label: str, linear) -> float:
    """Assert a linear (pixels, 3) render is finite with a nonzero mean;
    returns the mean."""
    import numpy as np

    linear = np.asarray(linear)
    if not np.all(np.isfinite(linear)):
        raise AssertionError(f"{label}: non-finite pixels")
    mean = float(linear.mean())
    if not mean > 0.0:
        raise AssertionError(f"{label}: mean {mean} is not positive")
    return mean


def _mib(n) -> str:
    return f"{n / 2**20:.1f} MiB"


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory analysis: not available"
    return (f"memory analysis: arguments {_mib(m.argument_size_in_bytes)}, "
            f"outputs {_mib(m.output_size_in_bytes)}, temporaries "
            f"{_mib(m.temp_size_in_bytes)}, code "
            f"{_mib(m.generated_code_size_in_bytes)}")


def _peak_line(device) -> str:
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return ("peak device memory so far: "
            + (_mib(peak) if peak is not None else "not reported"))


def _load(name: str, width: int, height: int):
    from path_tracing_tpu.scene import scene_path
    from path_tracing_tpu.scene.camera import make_camera
    from path_tracing_tpu.scene.obj_loader import load_any_scene

    p = load_any_scene(scene_path(name))
    scene = p.to_device()
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, width, height)
    return scene, cam


# (label, integrator, scene, width, height, CLI arguments)
MAIN_RUNS = [
    ("PT", "pt", "mis.txt", 1920, 1080, ["--spp", "4"]),
    ("BDPT", "bdpt", "cornell.txt", 1920, 1080,
     ["--spp", "4", "--spl", "4", "--resample", "32"]),
    # 4 lights x 250000 photons = 1M photons per pass
    ("PPM", "ppm", "cornell.txt", 512, 512,
     ["--spl", "250000", "--iters", "2"]),
]


def _jitted_call(mode: str, scene, cam, W: int, H: int, cfg, args, key):
    """(jitted render, positional arguments, dynamic arguments): the exact
    program the CLI's first iteration runs."""
    if mode == "pt":
        from path_tracing_tpu.integrators.pt import render_pt
        return (render_pt, (scene, cam, W, H, args.spp, cfg, key),
                (scene, cam, key))
    if mode == "bdpt":
        from path_tracing_tpu.integrators.bdpt import render_bdpt
        return (render_bdpt, (scene, cam, W, H, args.spp, args.spl, cfg, key),
                (scene, cam, key))
    from path_tracing_tpu.integrators.ppm import render_ppm_with_stats
    return (render_ppm_with_stats, (scene, cam, W, H, args.spl, cfg, key, 1.0),
            (scene, cam, key, 1.0))


def phase_main_path(card: str, runs=MAIN_RUNS) -> None:
    import jax
    import numpy as np

    from path_tracing_tpu import cli
    from path_tracing_tpu.film import load_checkpoint, read_png

    dev = jax.devices()[0]
    os.makedirs(OUT_DIR, exist_ok=True)
    for label, mode, scene_name, W, H, extra in runs:
        from path_tracing_tpu.scene import scene_path

        argv = ["--input", scene_path(scene_name), "--mode", mode,
                "--width", str(W), "--height", str(H), "--device", "gpu",
                "--retries", "0"] + extra
        args = cli.build_parser().parse_args(argv)
        cfg = cli.make_config(args, W, H)
        scene, cam = _load(scene_name, W, H)
        # the CLI's first frame key: fold_in(PRNGKey(seed), 0)
        key = jax.random.fold_in(jax.random.PRNGKey(args.seed), 0)
        fn, call_args, dyn_args = _jitted_call(mode, scene, cam, W, H, cfg,
                                               args, key)
        t0 = time.perf_counter()
        compiled = fn.lower(*call_args).compile()
        t_compile = time.perf_counter() - t0
        print(f"[{label}] {W}x{H} compile {t_compile:.2f} s  [{card}]",
              flush=True)
        print(f"[{label}] {_memory_line(compiled)}")
        for rep in range(2):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(*dyn_args))
            dt = time.perf_counter() - t0
            print(f"[{label}] {W}x{H} render {dt:.4f} s (run {rep + 1})  "
                  f"[{card}]", flush=True)
        if mode == "ppm":
            img, _count, overflow = out
            print(f"[{label}] gather overflow count {int(overflow)} "
                  f"(candidate events past ppm_max_per_cell="
                  f"{cfg.ppm_max_per_cell}; 0 = exact gather)")
        else:
            img = out
        check_render(f"{label} timed render", img)
        print(f"[{label}] {_peak_line(dev)}")

        png = os.path.join(OUT_DIR, f"{mode}.png")
        ck = os.path.join(OUT_DIR, f"{mode}.npz")
        if os.path.exists(ck):
            os.remove(ck)  # the CLI would resume from it
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--output", png, "--checkpoint", ck])
        if rc != 0:
            raise AssertionError(f"{label}: cli.main returned {rc}")
        print(f"[{label}] cli.main wall {time.perf_counter() - t0:.2f} s "
              f"[{card}]")
        state, _meta = load_checkpoint(ck)
        os.remove(ck)  # tens of MB at 1080p; the PNG is kept
        mean = check_render(f"{label} CLI image",
                            np.asarray(state.radiance_sum)
                            / max(int(state.n_iters), 1))
        png_mean = float(read_png(png).mean())
        if not png_mean > 0.0:
            raise AssertionError(f"{label}: PNG mean {png_mean}")
        print(f"[{label}] CLI image OK: linear mean {mean:.5f}, "
              f"8-bit mean {png_mean:.2f}, {png}")


# photons per pass of the 64x64 PPM comparison, and a per-cell budget above
# its densest cell: the gather is exact on both backends
REF_PHOTONS = 65536
REF_PPM_CELL_BUDGET = 4096


def _small_renders(size: int = 64):
    """{name: (render fn of (scene, cam, key) -> (image, overflow), scene
    file)} at size^2; overflow is 0 except for PPM."""
    from path_tracing_tpu.config import RenderConfig
    from path_tracing_tpu.integrators.bdpt import render_bdpt
    from path_tracing_tpu.integrators.ppm import render_ppm_with_stats
    from path_tracing_tpu.integrators.pt import render_pt

    W = H = size
    cfg = RenderConfig(width=W, height=H)
    cfg_ppm = cfg.with_(ppm_max_per_cell=REF_PPM_CELL_BUDGET)
    spl = REF_PHOTONS // 4  # the Cornell scene has 4 lights

    def ppm(s, c, k):
        img, _, overflow = render_ppm_with_stats(s, c, W, H, spl, cfg_ppm, k)
        return img, overflow

    return {
        "pt": (lambda s, c, k: (render_pt(s, c, W, H, 4, cfg, k), 0),
               "mis.txt"),
        "bdpt": (lambda s, c, k: (render_bdpt(s, c, W, H, 4, 4, cfg, k), 0),
                 "cornell.txt"),
        "ppm": (ppm, "cornell.txt"),
        "pt_cornell": (lambda s, c, k: (render_pt(s, c, W, H, 4, cfg, k), 0),
                       "cornell.txt"),
    }


def _render_on(device, fn, scene_name: str, size: int):
    import jax
    import numpy as np

    with jax.default_device(device):
        scene, cam = _load(scene_name, size, size)
        img, overflow = fn(scene, cam, jax.random.PRNGKey(7))
        if int(overflow):
            raise AssertionError(f"{scene_name}: gather overflow "
                                 f"{int(overflow)} on {device.platform}")
        return np.asarray(img)


def _photon_divergence(accel, cpu) -> str:
    """How many photon deposit events the two backends place differently:
    identical random numbers, but transcendental functions round differently
    and specular bounces (mirror, glass, diamond) amplify the difference."""
    import jax
    import numpy as np

    from path_tracing_tpu.config import RenderConfig
    from path_tracing_tpu.integrators.ppm import ppm_photon_trace

    out = []
    for dev in (accel, cpu):
        with jax.default_device(dev):
            scene, _ = _load("cornell.txt", 8, 8)
            ev = jax.jit(lambda s, k: ppm_photon_trace(
                s, RenderConfig(), REF_PHOTONS, REF_PHOTONS // 4, k))(
                    scene, jax.random.fold_in(jax.random.PRNGKey(7), 2))
            out.append((np.asarray(ev.pos), np.asarray(ev.valid)))
    (pa, va), (pb, vb) = out
    close = va & vb & (np.abs(pa - pb).max(axis=-1) <= 1e-4)
    return (f"{int(va.sum())} / {int(vb.sum())} valid deposit events; "
            f"{float(close.sum()) / max(int(va.sum()), 1):.2%} at the same "
            f"place to 1e-4, validity differs for "
            f"{float((va != vb).mean()):.3%} of event slots")


def phase_reference(size: int = 64, accel=None) -> None:
    import jax
    import numpy as np

    from path_tracing_tpu.imagecmp import agreement

    accel = accel or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    renders = _small_renders(size)
    for name in ("pt", "bdpt", "ppm"):
        fn, scene_name = renders[name]
        a = _render_on(accel, fn, scene_name, size)
        b = _render_on(cpu, fn, scene_name, size)
        check_render(f"{name} {accel.platform}", a)
        ag = agreement(a, b)
        ok = ag.ok(TOLERANCE[name])
        print(f"[{name.upper()}] {size}x{size} {accel.platform} vs cpu: {ag} "
              f"(limit: flipped <= {TOLERANCE[name]:.0%}, median rel <= "
              f"1e-5, energy rel <= 1%) -> {'OK' if ok else 'FAIL'}",
              flush=True)
        if name == "ppm":
            print(f"[PPM] photon trace {accel.platform} vs cpu: "
                  f"{_photon_divergence(accel, cpu)}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: {accel.platform} and cpu disagree")

    fn, scene_name = renders["pt_cornell"]
    default = _render_on(accel, fn, scene_name, size)
    with jax.default_matmul_precision("highest"):
        highest = _render_on(accel, fn, scene_name, size)
    same = bool(np.array_equal(default, highest))
    print(f"[PT] {size}x{size} cornell, default vs HIGHEST matmul precision: "
          f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("PT differs under HIGHEST precision: a float32 "
                             "contraction is left on the path")


# (label, scene, width, height) of the sharded renders
CARD_RUNS = [("pt", "mis.txt", 1920, 1080), ("bdpt", "cornell.txt", 1920, 1080),
             ("ppm", "cornell.txt", 512, 512)]


def phase_cards(n: int, card: str, runs=CARD_RUNS) -> None:
    import jax
    import numpy as np

    from path_tracing_tpu.config import RenderConfig
    from path_tracing_tpu.imagecmp import agreement
    from path_tracing_tpu.integrators.bdpt import render_bdpt
    from path_tracing_tpu.integrators.ppm import render_ppm_with_stats
    from path_tracing_tpu.integrators.pt import render_pt
    from path_tracing_tpu.parallel.shard import (make_mesh,
                                                 render_bdpt_sharded,
                                                 render_ppm_sharded,
                                                 render_pt_sharded)

    mesh = make_mesh(n)
    mesh_devs = set(mesh.devices.flat)
    key = jax.random.PRNGKey(3)
    for mode, scene_name, W, H in runs:
        scene, cam = _load(scene_name, W, H)
        if mode == "pt":
            cfg = RenderConfig(width=W, height=H)
            sharded = jax.jit(lambda s, c, k: render_pt_sharded(
                s, c, W, H, 4, cfg, k, mesh))
            single = lambda s, c, k: render_pt(s, c, W, H, 4, cfg, k)
        elif mode == "bdpt":
            cfg = RenderConfig(width=W, height=H, bdpt_resample_vertices=32)
            sharded = jax.jit(lambda s, c, k: render_bdpt_sharded(
                s, c, W, H, 4, 4, cfg, k, mesh, chunk=128))
            single = lambda s, c, k: render_bdpt(s, c, W, H, 4, 4, cfg, k,
                                                 chunk=128)
        else:
            # 250K photons per pass, and a per-cell budget above the
            # densest cell (about 8,100 events on the Cornell scene), so that
            # both gathers are exact: with overflow, each shard (holding 1/n
            # of the photons) would drop fewer events than one card does
            cfg = RenderConfig(width=W, height=H, ppm_max_per_cell=16384)
            spl = 250000 // scene.num_lights
            sharded = jax.jit(lambda s, c, k: render_ppm_sharded(
                s, c, W, H, spl, cfg, k, mesh))

            def single(s, c, k):
                img, _, overflow = render_ppm_with_stats(s, c, W, H, spl,
                                                         cfg, k)
                if int(overflow):
                    raise AssertionError(f"ppm: one-card gather overflowed "
                                         f"by {int(overflow)} events")
                return img

        times = {}
        for name, fn in (("sharded", sharded), ("single", single)):
            jax.block_until_ready(fn(scene, cam, key))  # compile + warm
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(scene, cam, key))
            times[name] = time.perf_counter() - t0
            if name == "sharded":
                img = out
            else:
                ref = out
        shard_devs = {s.device for s in img.addressable_shards}
        if shard_devs != mesh_devs or img.sharding.device_set != mesh_devs:
            raise AssertionError(f"{mode}: output lives on {shard_devs}, "
                                 f"not on the {n}-card mesh")
        rows = {s.data.shape[0] for s in img.addressable_shards}
        if rows != {W * H // n}:
            raise AssertionError(f"{mode}: shard rows {rows}")
        check_render(f"{mode} sharded", img)
        ag = agreement(np.asarray(img), np.asarray(ref))
        ok = ag.ok(TOLERANCE[mode])
        print(f"[{mode.upper()}] {W}x{H} sharded over {n} cards vs one card, "
              f"same key: {ag} (limit: flipped <= {TOLERANCE[mode]:.0%}) "
              f"-> {'OK' if ok else 'FAIL'}; one shard of {W * H // n} rows "
              f"on each of {len(shard_devs)} cards; render "
              f"{times['sharded']:.4f} s sharded, {times['single']:.4f} s "
              f"one card  [{card.splitlines()[0]}]", flush=True)
        if not ok:
            raise AssertionError(f"{mode}: sharded and single disagree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="N > 1: only render sharded over N cards and "
                         "compare with one card")
    args = ap.parse_args(argv)

    import jax

    from path_tracing_tpu.runtime import nvidia_smi, setup_jax_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[a] FAIL: JAX's default device is {dev.platform}, not a GPU",
              file=sys.stderr)
        return 1
    setup_jax_cache()
    print(f"[a] device {dev.device_kind} x {len(jax.devices())} "
          f"({dev.platform}), jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    try:
        card = nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[a] FAIL: nvidia-smi: {e}", file=sys.stderr)
        return 1
    print(card, flush=True)
    label = card.splitlines()[0]

    if args.cards > 1:
        phases = [("cards", lambda: phase_cards(args.cards, card))]
    else:
        phases = [("b main path", lambda: phase_main_path(label)),
                  ("c reference", phase_reference)]
    for name, run in phases:
        try:
            run()
        except Exception:  # noqa: BLE001 — report the phase, exit non-zero
            traceback.print_exc()
            print(f"[{name}] FAIL", file=sys.stderr)
            return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
