"""Quantitative PT parity vs an independent NumPy oracle.

Smoke-level PT tests are structurally blind to a missing path-throughput
factor in NEE (backend A/B tests share the bug and pass).  This test renders a small diffuse box
with the framework's PT and with ``tests/pt_numpy_oracle.py`` — a literal
NumPy transcription of reference ``src/pt_cu.cu`` — and pins the
image mean and per-pixel RMSE.  The pre-fix code overshoots the oracle mean
by >20% here; tolerance is a few percent of Monte-Carlo noise.
"""
from __future__ import annotations

import numpy as np
import pytest

from path_tracing_tpu.config import RenderConfig
from path_tracing_tpu.scene.camera import make_camera
from path_tracing_tpu.scene.types import Material, scene_from_numpy

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pt_numpy_oracle import render_pt_numpy  # noqa: E402

W = H = 16


def _quad(tris, p0, p1, p2, p3):
    tris.append((p0, p1, p2))
    tris.append((p0, p2, p3))


def _box_scene():
    """Diffuse Cornell-style box, open front; one sphere light, cutoff 0."""
    tris = []
    s = 2.0
    # floor y=0, ceiling y=4, back z=-s, left x=-s, right x=+s
    _quad(tris, (-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s))
    _quad(tris, (-s, 4, -s), (s, 4, -s), (s, 4, s), (-s, 4, s))
    _quad(tris, (-s, 0, -s), (s, 0, -s), (s, 4, -s), (-s, 4, -s))
    _quad(tris, (-s, 0, -s), (-s, 0, s), (-s, 4, s), (-s, 4, -s))
    _quad(tris, (s, 0, -s), (s, 0, s), (s, 4, s), (s, 4, -s))
    tri = np.array(tris, np.float32)  # (Nt, 3, 3)
    albedo = np.array([[0.75, 0.75, 0.75]] * 2 + [[0.75, 0.75, 0.75]] * 2
                      + [[0.7, 0.2, 0.2]] * 2 + [[0.2, 0.7, 0.2]] * 2
                      + [[0.2, 0.2, 0.7]] * 2, np.float32)
    nt = tri.shape[0]
    sph_c = np.array([[0.6, 0.8, -0.4]], np.float32)
    sph_r = np.array([0.8], np.float32)
    sph_alb = np.array([[0.7, 0.7, 0.7]], np.float32)

    light_pos = np.array([[0.0, 3.2, 0.0]], np.float32)
    light_r = np.array([0.3], np.float32)
    light_illum = np.array([[60.0, 60.0, 55.0]], np.float32)

    def mk_mtl(base):
        import jax.numpy as jnp
        n = base.shape[0]
        return Material(base_color=jnp.asarray(base),
                        roughness=jnp.ones((n,), jnp.float32),
                        metallic=jnp.zeros((n,), jnp.float32),
                        eta=jnp.zeros((n,), jnp.float32))

    scene = scene_from_numpy(
        sph_c, sph_r, mk_mtl(sph_alb),
        tri[:, 0], tri[:, 1], tri[:, 2], mk_mtl(albedo),
        light_pos, np.array([[0.0, -1.0, 0.0]], np.float32), light_illum,
        np.array([0.0], np.float32), np.array([0], np.int32), light_r)

    # the oracle's dict mirror — mtl rows are [rgb, rough, metal, eta];
    # triangle order must match the clustered order inside `scene`
    np_scene = dict(
        sph_c=sph_c.astype(np.float64), sph_r=sph_r.astype(np.float64),
        sph_m=np.concatenate([sph_alb, np.tile([1.0, 0.0, 0.0],
                                               (1, 1))], axis=1),
        tri_v0=np.asarray(scene.tri_v0, np.float64),
        tri_v1=np.asarray(scene.tri_v1, np.float64),
        tri_v2=np.asarray(scene.tri_v2, np.float64),
        tri_m=np.concatenate([np.asarray(scene.tri_mtl.base_color),
                              np.tile([1.0, 0.0, 0.0], (nt, 1))], axis=1),
        light_pos=light_pos.astype(np.float64),
        light_r=light_r.astype(np.float64),
        light_illum=light_illum.astype(np.float64),
    )
    eye = np.array([0.0, 2.0, 5.5], np.float32)
    look = np.array([0.0, 1.8, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    cam = make_camera(eye, look, up, 50.0, W, H)
    np_cam = dict(eye=np.asarray(cam.eye, np.float64),
                  ul=np.asarray(cam.ul, np.float64),
                  dx=np.asarray(cam.dx, np.float64),
                  dy=np.asarray(cam.dy, np.float64))
    return scene, cam, np_scene, np_cam


@pytest.mark.parametrize("spp", [96])
def test_pt_matches_numpy_oracle(spp):
    import jax

    from path_tracing_tpu.integrators.pt import render_pt

    scene, cam, np_scene, np_cam = _box_scene()
    cfg = RenderConfig(width=W, height=H, eye_depth=4, delta_budget=0)

    img = np.asarray(render_pt(scene, cam, W, H, spp, cfg,
                               jax.random.PRNGKey(7)))
    ref = render_pt_numpy(np_scene, np_cam, W, H, spp, max_depth=4, seed=11)

    assert np.isfinite(img).all() and np.isfinite(ref).all()
    m_img, m_ref = float(img.mean()), float(ref.mean())
    assert m_ref > 0.05  # the scene is actually lit
    rel = abs(m_img - m_ref) / m_ref
    assert rel < 0.05, (m_img, m_ref, rel)
    # per-pixel agreement (both are noisy at this spp; the bound is several
    # sigma of MC noise but far under the pre-fix structural error)
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse < 0.35 * m_ref, (rmse, m_ref)


def test_nee_includes_throughput_directly():
    """Unit-level pin: _nee scales with the path throughput
    (pt_cu.cu:142-143,193-195)."""
    import jax
    import jax.numpy as jnp

    from path_tracing_tpu.integrators import pt as pt_mod
    from path_tracing_tpu.ops.intersect import find_closest_hit

    scene, cam, _, _ = _box_scene()
    cfg = RenderConfig(width=W, height=H, eye_depth=4, delta_budget=0)
    B = 8
    ro = jnp.tile(jnp.asarray(cam.eye)[None], (B, 1))
    rd = jnp.tile(jnp.asarray([-0.25, -0.35, -1.0]), (B, 1))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    hit = find_closest_hit(scene, ro, rd)
    u = jax.random.uniform(jax.random.PRNGKey(0), (3, B))

    full = pt_mod._nee(scene, cfg, hit, -rd, jnp.ones((B, 3)),
                       u[0], u[1], u[2])
    half = pt_mod._nee(scene, cfg, hit, -rd, jnp.full((B, 3), 0.5),
                       u[0], u[1], u[2])
    assert float(jnp.max(jnp.abs(full))) > 0.0
    np.testing.assert_allclose(np.asarray(half), 0.5 * np.asarray(full),
                               rtol=1e-5)


def _veach_mini_scene():
    """mis_test.txt-class fixture: rough-METAL slabs + spot-cone lights —
    exercises FrSchlick, VNDF-only sampling (spec_weight 1) and the
    NEE/emission cone gates that input.txt-class scenes never touch."""
    import jax.numpy as jnp

    tris = []
    s = 3.0
    _quad(tris, (-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s))  # floor
    # two slabs tilted ~30 deg toward the camera
    _quad(tris, (-2.4, 0.4, -1.0), (-0.4, 0.4, -1.0),
          (-0.4, 1.4, -1.8), (-2.4, 1.4, -1.8))
    _quad(tris, (0.4, 0.4, -1.0), (2.4, 0.4, -1.0),
          (2.4, 1.4, -1.8), (0.4, 1.4, -1.8))
    tri = np.array(tris, np.float32)
    base = np.array([[0.7, 0.7, 0.7]] * 2          # diffuse floor
                    + [[0.9, 0.7, 0.4]] * 2        # gold-ish slab
                    + [[0.6, 0.7, 0.9]] * 2,       # blue-ish slab
                    np.float32)
    rough = np.array([1.0, 1.0, 0.15, 0.15, 0.45, 0.45], np.float32)
    metal = np.array([0.0, 0.0, 1.0, 1.0, 1.0, 1.0], np.float32)
    nt = tri.shape[0]

    light_pos = np.array([[-1.4, 3.0, -1.0], [1.4, 3.0, -1.0]], np.float32)
    light_dir = np.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    light_r = np.array([0.15, 0.45], np.float32)
    light_illum = np.array([[25.0, 24.0, 20.0], [10.0, 11.0, 13.0]],
                           np.float32)
    # narrow cones (~34 deg): the NEE inside-cone gate and the emission
    # cone_ratio actually BITE on the off-axis slabs (a vacuous gate would
    # not discriminate a sign/threshold error)
    cutoff = np.full((2,), 0.6, np.float32)

    import jax.numpy as jnp

    mtl = Material(base_color=jnp.asarray(base),
                   roughness=jnp.asarray(rough),
                   metallic=jnp.asarray(metal),
                   eta=jnp.zeros((nt,), jnp.float32))
    scene = scene_from_numpy(
        np.zeros((0, 3), np.float32), np.zeros((0,), np.float32),
        Material(base_color=jnp.zeros((0, 3)), roughness=jnp.zeros((0,)),
                 metallic=jnp.zeros((0,)), eta=jnp.zeros((0,))),
        tri[:, 0], tri[:, 1], tri[:, 2], mtl,
        light_pos, light_dir, light_illum,
        cutoff, np.zeros((2,), np.int32), light_r)

    np_scene = dict(
        sph_c=np.zeros((0, 3)), sph_r=np.zeros((0,)),
        sph_m=np.zeros((0, 6)),
        tri_v0=np.asarray(scene.tri_v0, np.float64),
        tri_v1=np.asarray(scene.tri_v1, np.float64),
        tri_v2=np.asarray(scene.tri_v2, np.float64),
        tri_m=np.concatenate(
            [np.asarray(scene.tri_mtl.base_color),
             np.stack([np.asarray(scene.tri_mtl.roughness),
                       np.asarray(scene.tri_mtl.metallic),
                       np.asarray(scene.tri_mtl.eta)], axis=1)], axis=1),
        light_pos=light_pos.astype(np.float64),
        light_dir=light_dir.astype(np.float64),
        light_r=light_r.astype(np.float64),
        light_illum=light_illum.astype(np.float64),
        light_cutoff=cutoff.astype(np.float64),
    )
    eye = np.array([0.0, 1.6, 4.5], np.float32)
    look = np.array([0.0, 0.9, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    cam = make_camera(eye, look, up, 50.0, W, H)
    np_cam = dict(eye=np.asarray(cam.eye, np.float64),
                  ul=np.asarray(cam.ul, np.float64),
                  dx=np.asarray(cam.dx, np.float64),
                  dy=np.asarray(cam.dy, np.float64))
    return scene, cam, np_scene, np_cam


def test_pt_metal_cone_matches_numpy_oracle():
    """config-2-class parity: metallic slabs + cone-gated lights."""
    import jax

    from path_tracing_tpu.integrators.pt import render_pt

    scene, cam, np_scene, np_cam = _veach_mini_scene()
    cfg = RenderConfig(width=W, height=H, eye_depth=4, delta_budget=0)
    spp = 96

    img = np.asarray(render_pt(scene, cam, W, H, spp, cfg,
                               jax.random.PRNGKey(3)))
    ref = render_pt_numpy(np_scene, np_cam, W, H, spp, max_depth=4, seed=5)

    assert np.isfinite(img).all() and np.isfinite(ref).all()
    m_img, m_ref = float(img.mean()), float(ref.mean())
    print("means", m_img, m_ref)
    assert m_ref > 0.02
    rel = abs(m_img - m_ref) / m_ref
    assert rel < 0.06, (m_img, m_ref, rel)
    # glossy-metal highlights are the noisiest pixels at this spp; the
    # mean is the structural pin, the RMSE only guards gross divergence
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse < 0.75 * m_ref, (rmse, m_ref)


def _sun_scene():
    """Parallel-light fixture: neither reference scene file uses
    is_parallel=1, so this branch (pt_cu.cu:130-149 — no pdf, no MIS,
    x num_lights) had no quantitative anchor until now."""
    import jax.numpy as jnp

    tris = []
    s = 2.5
    _quad(tris, (-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s))   # floor
    _quad(tris, (-s, 0, -s), (s, 0, -s), (s, 3, -s), (-s, 3, -s))  # back
    # a blocker slab floating above the floor casts a sun shadow
    _quad(tris, (-1.0, 1.2, -0.6), (0.2, 1.2, -0.6),
          (0.2, 1.2, 0.6), (-1.0, 1.2, 0.6))
    tri = np.array(tris, np.float32)
    base = np.array([[0.75, 0.72, 0.68]] * 4 + [[0.3, 0.5, 0.3]] * 2,
                    np.float32)
    nt = tri.shape[0]

    light_pos = np.array([[0.0, 50.0, 0.0]], np.float32)  # ball far away
    light_dir = np.array([[0.35, -1.0, 0.25]], np.float32)
    light_r = np.array([0.1], np.float32)
    light_illum = np.array([[1.1, 1.0, 0.9]], np.float32)

    mtl = Material(base_color=jnp.asarray(base),
                   roughness=jnp.ones((nt,), jnp.float32),
                   metallic=jnp.zeros((nt,), jnp.float32),
                   eta=jnp.zeros((nt,), jnp.float32))
    scene = scene_from_numpy(
        np.zeros((0, 3), np.float32), np.zeros((0,), np.float32),
        Material(base_color=jnp.zeros((0, 3)), roughness=jnp.zeros((0,)),
                 metallic=jnp.zeros((0,)), eta=jnp.zeros((0,))),
        tri[:, 0], tri[:, 1], tri[:, 2], mtl,
        light_pos, light_dir, light_illum,
        np.zeros((1,), np.float32), np.ones((1,), np.int32), light_r)

    np_scene = dict(
        sph_c=np.zeros((0, 3)), sph_r=np.zeros((0,)),
        sph_m=np.zeros((0, 6)),
        tri_v0=np.asarray(scene.tri_v0, np.float64),
        tri_v1=np.asarray(scene.tri_v1, np.float64),
        tri_v2=np.asarray(scene.tri_v2, np.float64),
        tri_m=np.concatenate(
            [np.asarray(scene.tri_mtl.base_color),
             np.stack([np.asarray(scene.tri_mtl.roughness),
                       np.asarray(scene.tri_mtl.metallic),
                       np.asarray(scene.tri_mtl.eta)], axis=1)], axis=1),
        light_pos=light_pos.astype(np.float64),
        light_dir=light_dir.astype(np.float64),
        light_r=light_r.astype(np.float64),
        light_illum=light_illum.astype(np.float64),
        light_parallel=np.ones(1, np.int64),
    )
    eye = np.array([0.0, 1.8, 5.0], np.float32)
    look = np.array([0.0, 0.8, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    cam = make_camera(eye, look, up, 50.0, W, H)
    np_cam = dict(eye=np.asarray(cam.eye, np.float64),
                  ul=np.asarray(cam.ul, np.float64),
                  dx=np.asarray(cam.dx, np.float64),
                  dy=np.asarray(cam.dy, np.float64))
    return scene, cam, np_scene, np_cam


def test_pt_parallel_light_matches_numpy_oracle():
    import jax

    from path_tracing_tpu.integrators.pt import render_pt

    scene, cam, np_scene, np_cam = _sun_scene()
    cfg = RenderConfig(width=W, height=H, eye_depth=3, delta_budget=0)
    spp = 64

    img = np.asarray(render_pt(scene, cam, W, H, spp, cfg,
                               jax.random.PRNGKey(2)))
    ref = render_pt_numpy(np_scene, np_cam, W, H, spp, max_depth=3, seed=9)

    assert np.isfinite(img).all() and np.isfinite(ref).all()
    m_img, m_ref = float(img.mean()), float(ref.mean())
    print("means", m_img, m_ref)
    assert m_ref > 0.05
    rel = abs(m_img - m_ref) / m_ref
    assert rel < 0.05, (m_img, m_ref, rel)
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse < 0.3 * m_ref, (rmse, m_ref)
