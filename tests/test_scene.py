"""Scene parser + camera tests against the reference's shipped fixtures."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from path_tracing_tpu.scene import scene_path
from path_tracing_tpu.scene.camera import make_camera, primary_ray_dirs
from path_tracing_tpu.scene.parser import load_scene, parse_scene_text

INPUT_TXT = scene_path("cornell.txt")
MIS_TXT = scene_path("mis.txt")


def test_parse_input_txt():
    p = load_scene(INPUT_TXT)
    assert (p.width, p.height) == (200, 200)
    assert p.fov == 50.0
    assert len(p.tri_verts) == 36  # 6 walls x 2 + two 12-tri boxes (SURVEY said 34; actual count is 36)
    assert len(p.sph_center) == 5
    assert len(p.lights) == 4
    np.testing.assert_allclose(p.eye, [0, 0, -1])
    # material state machine: glass sphere (eta 1.5) is sphere index 3
    assert p.sph_mtl[3][5] == 1.5
    assert p.sph_mtl[4][5] == 2.4
    # group switch: all spheres are group 1 (G 1 precedes them)
    assert all(g == 1 for g in p.sph_group)
    assert all(g == 0 for g in p.tri_group)
    # light 0: cutoff 180 deg in radians, ball r 0.1
    assert abs(p.lights[0][9] - math.pi) < 1e-6
    assert p.lights[0][11] == 0.1


def test_parse_mis_test_tolerates_9_number_materials():
    """quirk 9: M lines with a legacy Phong tail parse without desync."""
    p = load_scene(MIS_TXT)
    assert len(p.tri_verts) == 48  # 4 boxes x 12 triangles
    assert len(p.sph_center) == 0
    assert len(p.lights) == 5
    # the stray tokens must not corrupt the following T records
    v = np.asarray(p.tri_verts[0])
    np.testing.assert_allclose(v[0], [-3.0, 1.787, 1.578], atol=1e-6)
    # all four box materials: metallic 0.9
    assert all(m[4] == pytest.approx(0.9) for m in p.tri_mtl)


def test_parse_comments_and_empty():
    p = parse_scene_text("// nothing here\n\n// more\n")
    assert len(p.lights) == 0 and len(p.tri_verts) == 0


def test_scene_to_device_and_aabb():
    s = load_scene(INPUT_TXT).to_device()
    assert s.num_triangles == 36 and s.num_spheres == 5 and s.num_lights == 4
    lo = np.asarray(s.scene_min)
    hi = np.asarray(s.scene_max)
    # Cornell box spans roughly [-0.5, 0.5]^2 x [-1.1, 1.0]
    np.testing.assert_allclose(lo, [-0.5, -0.5, -1.1], atol=1e-5)
    np.testing.assert_allclose(hi, [0.5, 0.5, 1.0], atol=1e-5)


def test_camera_center_ray_points_at_lookat():
    p = load_scene(INPUT_TXT)
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 200, 200)
    d = primary_ray_dirs(cam, jnp.array([100]), jnp.array([100]),
                         jnp.array([0.0]), jnp.array([0.0]))
    d = np.asarray(d)[0]
    to_target = p.look_at - p.eye
    to_target = to_target / np.linalg.norm(to_target)
    # half-pixel off-center at most
    assert float(np.dot(d, to_target)) > 0.9999


def test_camera_fov_scaling():
    p = load_scene(INPUT_TXT)
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 200, 200)
    corner = primary_ray_dirs(cam, jnp.array([0]), jnp.array([0]),
                              jnp.array([0.0]), jnp.array([0.0]))
    center = primary_ray_dirs(cam, jnp.array([100]), jnp.array([100]),
                              jnp.array([0.0]), jnp.array([0.0]))
    ang = math.degrees(math.acos(float(np.clip(
        np.dot(np.asarray(corner)[0], np.asarray(center)[0]), -1, 1))))
    # corner-to-center angle for fov 50, square aspect: ~ atan(tan(25)*sqrt2)
    expected = math.degrees(math.atan(math.tan(math.radians(25)) * math.sqrt(2)))
    assert abs(ang - expected) < 1.0
