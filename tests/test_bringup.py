"""Bring-up on the GPU: device selection that hides no device, the
comparison helpers of chip_smoke.py, numerics that cannot run in TF32, the
compile cache location, the stand-in scenes, and the host runtime."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracing_tpu.imagecmp import agreement
from path_tracing_tpu.scene import scene_path
from path_tracing_tpu.scene.parser import load_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "path_tracing_tpu")
sys.path.insert(0, ROOT)


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    yield os.path.relpath(p, ROOT), fh.read()


def test_cli_device_gpu_without_gpu_fails(tmp_path, capsys):
    """--device gpu (the default) must not fall back to the CPU."""
    from path_tracing_tpu import cli

    out = str(tmp_path / "out.png")
    rc = cli.main(["--spp", "1", "--width", "8", "--height", "8",
                   "--output", out])
    assert rc != 0
    assert "no GPU" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_chip_smoke_without_gpu_fails():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not a GPU" in r.stderr


@pytest.mark.parametrize("x, ref, max_flipped, ok", [
    # identical
    ([[1.0, 2.0, 3.0]] * 4, [[1.0, 2.0, 3.0]] * 4, 0.0, True),
    # float rounding everywhere: no pixel flips
    ([[1.0 + 1e-7, 2.0, 3.0]] * 4, [[1.0, 2.0, 3.0]] * 4, 0.0, True),
    # one of 100 pixels flipped, total energy kept within 1%
    ([[1.0, 1.0, 1.0]] * 99 + [[1.5, 1.0, 1.0]],
     [[1.0, 1.0, 1.0]] * 100, 0.01, True),
    # the same flip is too many when no flips are allowed
    ([[1.0, 1.0, 1.0]] * 99 + [[1.5, 1.0, 1.0]],
     [[1.0, 1.0, 1.0]] * 100, 0.0, False),
    # a lost shard: half the pixels dark
    ([[1.0, 1.0, 1.0]] * 50 + [[0.0, 0.0, 0.0]] * 50,
     [[1.0, 1.0, 1.0]] * 100, 0.05, False),
    # a spatial permutation keeps the energy but moves every pixel
    ([[float(i), 0.0, 0.0] for i in range(100)][::-1],
     [[float(i), 0.0, 0.0] for i in range(100)], 0.05, False),
])
def test_agreement_cases(x, ref, max_flipped, ok):
    a = agreement(np.asarray(x, np.float32), np.asarray(ref, np.float32))
    assert a.ok(max_flipped) == ok, a


def test_agreement_numbers():
    ref = np.ones((4, 3), np.float32)
    x = ref.copy()
    x[0, 1] = 2.0
    a = agreement(x, ref)
    assert not a.bit_exact
    assert a.flipped == pytest.approx(0.25)
    assert a.max_rel == pytest.approx(1.0 / 1.001)
    assert a.energy_rel == pytest.approx(1.0 / 12.0)
    assert a.median_rel == 0.0
    assert agreement(ref, ref).bit_exact and str(agreement(ref, ref)) == \
        "bit-exact"
    with pytest.raises(ValueError):
        agreement(ref, ref[:2])


def test_chip_smoke_check_render():
    import chip_smoke

    assert chip_smoke.check_render("x", np.full((4, 3), 0.5)) == 0.5
    with pytest.raises(AssertionError):
        chip_smoke.check_render("x", np.zeros((4, 3)))
    bad = np.ones((4, 3))
    bad[1, 2] = np.nan
    with pytest.raises(AssertionError):
        chip_smoke.check_render("x", bad)


def test_light_gather_equals_per_field_lookup():
    """The per-lane light fetch is a row gather: exactly the table rows."""
    from path_tracing_tpu.integrators.pt import _take_light

    s = load_scene(scene_path("cornell.txt")).to_device()
    li = jnp.asarray([3, 0, 2, 1, 1, 3], jnp.int32)
    got = jax.jit(_take_light)(s, li)
    idx = np.asarray(li)
    np.testing.assert_array_equal(got["pos"], np.asarray(s.light_pos)[idx])
    np.testing.assert_array_equal(got["dir"], np.asarray(s.light_dir)[idx])
    np.testing.assert_array_equal(got["illum"],
                                  np.asarray(s.light_illum)[idx])
    np.testing.assert_array_equal(got["cutoff"],
                                  np.asarray(s.light_cutoff)[idx])
    np.testing.assert_array_equal(got["r"], np.asarray(s.light_ball_r)[idx])
    np.testing.assert_array_equal(
        got["is_par"], np.asarray(s.light_is_parallel)[idx] != 0)


def _sphere_ts_f64(ro, rd, centers, radii, max_dist, eps):
    oc = ro[:, None, :] - centers[None, :, :]
    b = np.sum(oc * rd[:, None, :], axis=-1)
    c = np.sum(oc * oc, axis=-1) - radii[None, :] ** 2
    h = b * b - c
    sh = np.sqrt(np.maximum(h, 0.0))
    t1, t2 = -b - sh, -b + sh
    ok = h >= 0
    v1 = ok & (t1 > eps) & (t1 < max_dist)
    v2 = ok & (t2 > eps) & (t2 < max_dist)
    return np.where(v1, t1, np.where(v2, t2, np.inf))


def test_sphere_ts_matches_float64_numpy():
    from path_tracing_tpu.ops.intersect import INF, sphere_ts
    from path_tracing_tpu.ops.math3 import EPSILON

    rs = np.random.RandomState(3)
    centers = rs.uniform(-1, 1, (7, 3)).astype(np.float32)
    radii = rs.uniform(0.1, 0.8, 7).astype(np.float32)
    ro = rs.uniform(-2, 2, (256, 3)).astype(np.float32)
    # aim near a random sphere so that most rays hit something
    aim = centers[rs.randint(0, 7, 256)] + rs.normal(size=(256, 3)) * 0.3
    rd = (aim - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    got = np.asarray(jax.jit(sphere_ts)(ro, rd, centers, radii, 5.0))
    want = _sphere_ts_f64(ro.astype(np.float64), rd.astype(np.float64),
                          centers.astype(np.float64),
                          radii.astype(np.float64), 5.0, EPSILON)
    hit_w = np.isfinite(want)
    hit_g = got < INF
    # away from the window edges the hit sets agree exactly
    assert (hit_w == hit_g).mean() > 0.999
    both = hit_w & hit_g
    assert both.sum() > 100
    np.testing.assert_allclose(got[both], want[both], rtol=1e-4, atol=1e-5)


def test_no_float_contraction_left():
    """No dot/einsum/matmul (and no @) remains on the render path: on a GPU
    an f32 contraction without a precision argument may run in TF32."""
    pat = re.compile(r"jnp\.(dot|einsum|matmul|tensordot|inner)\(|"
                     r"lax\.dot|[\w\)\]] @ [\w\(]")
    hits = [f"{p}: {m.group(0)}" for p, src in _sources()
            for m in pat.finditer(src)]
    assert hits == []


def test_no_tpu_kernels_imported():
    bad = [p for p, src in _sources()
           if re.search(r"pallas\.tpu|pltpu|pallas_call", src)]
    assert bad == []


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    r = subprocess.run(
        [sys.executable, "-c",
         "from path_tracing_tpu.runtime import setup_jax_cache\n"
         "setup_jax_cache()\n"
         "import jax\n"
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path / "cc") if env_dir else os.path.join(ROOT,
                                                             ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("name, tris, spheres, lights", [
    ("cornell.txt", 36, 5, 4), ("mis.txt", 48, 0, 5)])
def test_standin_scenes_parse(name, tris, spheres, lights):
    p = load_scene(scene_path(name))
    assert (len(p.tri_verts), len(p.sph_center), len(p.lights)) == \
        (tris, spheres, lights)
    with open(scene_path(name)) as f:
        assert "STAND-IN" in f.read()


def test_cornell_standin_materials():
    """Glass (eta 1.5), diamond (eta 2.4), a mirror wall, spot lights."""
    p = load_scene(scene_path("cornell.txt"))
    etas = sorted(m[5] for m in p.sph_mtl)
    assert 1.5 in etas and 2.4 in etas
    # a smooth conductor wall: metallic 1, roughness 0
    assert any(m[3] == 0.0 and m[4] == 1.0 for m in p.tri_mtl)
    assert all(l[10] == 0.0 and l[9] > 0.0 for l in p.lights)


def test_mis_standin_lights_decrease():
    p = load_scene(scene_path("mis.txt"))
    radii = [l[11] for l in p.lights]
    assert radii == sorted(radii, reverse=True) and len(set(radii)) == 5


def test_signal_handlers_restored_on_partial_failure(monkeypatch):
    import signal

    from path_tracing_tpu.cli import install_signal_handlers

    calls = []
    real = signal.signal

    def flaky(sig, handler):
        calls.append((sig, handler))
        if sig == signal.SIGUSR2 and handler == "h2":
            raise ValueError("signal only works in main thread")
        return f"old{sig}"

    monkeypatch.setattr(signal, "signal", flaky)
    old = install_signal_handlers({signal.SIGUSR1: "h1",
                                   signal.SIGUSR2: "h2"})
    monkeypatch.setattr(signal, "signal", real)
    assert old == {}
    # SIGUSR1 was installed, then put back to what it replaced
    assert calls == [(signal.SIGUSR1, "h1"), (signal.SIGUSR2, "h2"),
                     (signal.SIGUSR1, f"old{signal.SIGUSR1}")]


def test_texture_path_retried_at_returned_size():
    from path_tracing_tpu.runtime.native import _texture_path

    long_path = "/t" + "x" * 5000 + ".png"

    class FakeLib:
        def pt_get_texture_path(self, h, i, buf, cap):
            if i != 0:
                return -1
            need = len(long_path) + 1
            if need > cap:
                return need
            buf.value = long_path.encode()
            return 0

    assert _texture_path(FakeLib(), None, 0) == os.path.normpath(long_path)
    assert _texture_path(FakeLib(), None, 1) is None


def test_non_png_texture_without_pillow_is_a_clear_error(tmp_path,
                                                         monkeypatch):
    from path_tracing_tpu.scene.obj_loader import _decode_texture

    jpg = tmp_path / "t.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 32)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        _decode_texture(str(jpg))
    # PNG textures and missing files need no Pillow
    from path_tracing_tpu.film import write_png

    png = tmp_path / "t.png"
    write_png(str(png), np.full((2, 2, 3), 255, np.uint8))
    np.testing.assert_allclose(_decode_texture(str(png)), 1.0)
    assert _decode_texture(str(tmp_path / "missing.png")) is None
