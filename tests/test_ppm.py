"""PPM integrator tests: hash parity, exact gather vs brute force,
end-to-end render, and the PPM-vs-BDPT cross-integrator agreement the
reference GUI tracks as ``diff_rms`` (main.cpp:507,530-531)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracing_tpu.scene import scene_path
from path_tracing_tpu.config import RenderConfig
from path_tracing_tpu.integrators.ppm import (HitPoints, PhotonEvents,
                                              gather_flux, hash_cell,
                                              render_ppm_with_stats)
from path_tracing_tpu.scene.camera import make_camera
from path_tracing_tpu.scene.parser import load_scene
from path_tracing_tpu.scene.types import Material

INPUT_TXT = scene_path("cornell.txt")
W = H = 16


@pytest.fixture(scope="module")
def setup():
    p = load_scene(INPUT_TXT)
    scene = p.to_device()
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=3, light_depth=3,
                       delta_budget=3, ppm_max_per_cell=64)
    return scene, cam, cfg


def _c_hash(ix, iy, iz, table):
    """C semantics: int32 wraparound mul/xor, then unsigned modulo."""
    h = (np.int32(ix) * np.int32(73856093)) ^ \
        (np.int32(iy) * np.int32(19349663)) ^ \
        (np.int32(iz) * np.int32(83492791))
    return int(np.uint32(h) % np.uint32(table))


def test_hash_cell_matches_c_semantics():
    table = 1000003
    rngs = np.random.RandomState(0)
    with np.errstate(over="ignore"):
        for _ in range(50):
            ix, iy, iz = rngs.randint(-500, 500, 3)
            got = int(hash_cell(jnp.int32(ix), jnp.int32(iy), jnp.int32(iz),
                                table))
            assert got == _c_hash(ix, iy, iz, table), (ix, iy, iz)


def test_gather_flux_matches_bruteforce(setup):
    """The sort/searchsorted gather must equal the reference's 27-cell walk,
    including hash-collision double counting."""
    scene, cam, cfg = setup
    rs = np.random.RandomState(1)
    B, E = 24, 200
    span = np.asarray(scene.scene_max) - np.asarray(scene.scene_min)
    lo = np.asarray(scene.scene_min)

    hp_pos = (lo + rs.rand(B, 3) * span).astype(np.float32)
    hp_n = rs.randn(B, 3).astype(np.float32)
    hp_n /= np.linalg.norm(hp_n, axis=-1, keepdims=True)
    ev_pos = (hp_pos[rs.randint(0, B, E)]
              + rs.randn(E, 3).astype(np.float32) * 0.05)
    ev_n = np.tile(np.array([[0, 1, 0]], np.float32), (E, 1))
    ev_wi = rs.randn(E, 3).astype(np.float32)
    ev_wi /= np.linalg.norm(ev_wi, axis=-1, keepdims=True)
    ev_flux = rs.rand(E, 3).astype(np.float32)
    ev_valid = rs.rand(E) > 0.2

    hp = HitPoints(
        pos=jnp.asarray(hp_pos), normal=jnp.asarray(hp_n),
        wo=jnp.asarray(np.tile(np.array([[0, 1, 0]], np.float32), (B, 1))),
        mtl=Material(base_color=jnp.ones((B, 3)) * 0.5,
                     roughness=jnp.full((B,), 0.5),
                     metallic=jnp.zeros((B,)), eta=jnp.zeros((B,))),
        throughput=jnp.ones((B, 3)),
        valid=jnp.ones((B,), bool))
    ev = PhotonEvents(pos=jnp.asarray(ev_pos), normal=jnp.asarray(ev_n),
                      wi=jnp.asarray(ev_wi), flux=jnp.asarray(ev_flux),
                      valid=jnp.asarray(ev_valid))

    f = jax.jit(gather_flux, static_argnames=("cfg",))
    flux, count, overflow = f(scene, cfg, hp, ev)
    assert int(overflow) == 0

    # brute force with the reference's exact walk semantics
    from path_tracing_tpu.ops.bsdf import bsdf_evaluate
    cell = cfg.ppm_radius
    table = cfg.ppm_hash_size
    ev_cells = np.floor((ev_pos - lo) / cell).astype(np.int64)
    with np.errstate(over="ignore"):
        ev_hash = np.array([_c_hash(*c, table) for c in ev_cells])
    expected = np.zeros((B, 3), np.float32)
    exp_count = np.zeros(B, np.int64)
    hp_mtl_1 = Material(base_color=jnp.ones((1, 3)) * 0.5,
                        roughness=jnp.full((1,), 0.5),
                        metallic=jnp.zeros((1,)), eta=jnp.zeros((1,)))
    brdf_fn = jax.jit(lambda wo, wi, n: bsdf_evaluate(hp_mtl_1, wo, wi, n))
    for b in range(B):
        hc = np.floor((hp_pos[b] - lo) / cell).astype(np.int64)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    with np.errstate(over="ignore"):
                        hh = _c_hash(hc[0] + dx, hc[1] + dy, hc[2] + dz, table)
                    for e in np.nonzero(ev_hash == hh)[0]:
                        if not ev_valid[e]:
                            continue
                        if np.dot(hp_n[b], ev_n[e]) <= 0.01:
                            continue
                        d2 = np.sum((hp_pos[b] - ev_pos[e]) ** 2)
                        if d2 >= cfg.ppm_radius ** 2:
                            continue
                        brdf = np.asarray(brdf_fn(
                            jnp.asarray(hp_n[b:b + 1] * 0 + np.array([0, 1, 0],
                                        np.float32)),
                            jnp.asarray(ev_wi[e:e + 1]),
                            jnp.asarray(hp_n[b:b + 1])))[0]
                        expected[b] += ev_flux[e] * brdf
                        exp_count[b] += 1
    np.testing.assert_allclose(np.asarray(flux), expected,
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(count), exp_count)


def test_ppm_renders_finite(setup):
    scene, cam, cfg = setup
    img, count, overflow = render_ppm_with_stats(
        scene, cam, W, H, 64, cfg, jax.random.PRNGKey(0))
    img = np.asarray(img)
    assert np.all(np.isfinite(img)) and np.all(img >= 0)
    assert int(np.asarray(count).sum()) > 0  # photons actually landed
    assert float(np.mean(img.sum(-1) > 1e-5)) > 0.3
    assert int(overflow) == 0


def test_ppm_deterministic(setup):
    scene, cam, cfg = setup
    a, _, _ = render_ppm_with_stats(scene, cam, W, H, 32, cfg,
                                    jax.random.PRNGKey(3))
    b, _, _ = render_ppm_with_stats(scene, cam, W, H, 32, cfg,
                                    jax.random.PRNGKey(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ppm_vs_bdpt_cross_structure_and_brightness_quirk(setup):
    """Cross-integrator check (the GUI's diff_rms, main.cpp:507).

    The reference's PPM photon flux is ``illum*num_lights/spl``
    (ppm_cu.cu:213) with ``spl`` photons per light, i.e. each light emits
    ``num_lights x`` its flux — so reference PPM is ~Nl x brighter than
    reference BDPT (their GUI's diff_rms never reaches 0).  We reproduce
    that: pin the brightness ratio near Nl AND require structural agreement
    after mean-normalization."""
    from path_tracing_tpu.integrators.bdpt import render_bdpt

    scene, cam, cfg = setup
    key = jax.random.PRNGKey(0)
    ppm_acc = np.zeros((W * H, 3))
    passes = 4
    for i in range(passes):
        img, _, _ = render_ppm_with_stats(
            scene, cam, W, H, 2048, cfg, jax.random.fold_in(key, i))
        ppm_acc += np.asarray(img)
    ppm_img = ppm_acc / passes
    bdpt_img = np.asarray(render_bdpt(scene, cam, W, H, 2, 8, cfg,
                                      jax.random.PRNGKey(9), chunk=32))

    nl = int(scene.num_lights)
    ratio = float(ppm_img.mean() / max(bdpt_img.mean(), 1e-9))
    assert 0.6 * nl < ratio < 1.8 * nl, ratio  # the Nl-x emission quirk

    # structural agreement after removing the known brightness factor
    a = ppm_img / ppm_img.mean()
    b = bdpt_img / bdpt_img.mean()
    ab = a.reshape(4, 4, 4, 4, 3).mean((1, 3)).ravel()
    bb = b.reshape(4, 4, 4, 4, 3).mean((1, 3)).ravel()
    corr = float(np.corrcoef(ab, bb)[0, 1])
    assert corr > 0.6, corr


def test_progressive_radius_schedule():
    from path_tracing_tpu.integrators.ppm import ppm_radius_scale

    assert ppm_radius_scale(0, 0.7) == 1.0
    assert ppm_radius_scale(5, 0.0) == 1.0
    s1 = ppm_radius_scale(1, 0.7)
    s5 = ppm_radius_scale(5, 0.7)
    assert s1 == pytest.approx(1.7 / 2.0)
    assert 0.0 < s5 < s1 < 1.0  # monotonically shrinking


def test_ppm_shrunk_radius_still_renders(setup):
    scene, cam, cfg = setup
    img, _, _ = render_ppm_with_stats(scene, cam, W, H, 256, cfg,
                                      jax.random.PRNGKey(1), r2_scale=0.5)
    img = np.asarray(img)
    assert np.all(np.isfinite(img)) and float(img.sum()) > 0
