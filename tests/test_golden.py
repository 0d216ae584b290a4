"""Estimator-drift tripwire for the headline scene.

``test_mis_scene_estimator_pinned`` pins a fixed-seed CPU render of the MIS
stand-in scene against a committed fixture.
"""
import os

import numpy as np

from path_tracing_tpu.scene import scene_path

_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def test_mis_scene_estimator_pinned():
    """Fixed-seed 128^2 PT render of the MIS stand-in scene vs a committed
    fixture — an estimator-drift tripwire for the HEADLINE scene (a Cornell
    check can't catch MIS-weight regressions in the scene the benchmark
    actually runs).  The pin is 8-bit RMSE < 1.0: immune to
    ULP-level codegen jitter across jax versions, loud on any real
    estimator change.  Regenerate with
    ``python tests/gen_mis_fixture.py`` after an INTENDED change."""
    import jax

    from path_tracing_tpu.config import RenderConfig
    from path_tracing_tpu.film import tonemap_u8
    from path_tracing_tpu.integrators.pt import render_pt
    from path_tracing_tpu.scene.camera import make_camera
    from path_tracing_tpu.scene.parser import load_scene

    fixture = os.path.join(_FIX, "mis_pt_128.npy")
    assert os.path.exists(fixture), "run tests/gen_mis_fixture.py"
    p = load_scene(scene_path("mis.txt"))
    scene = p.to_device()
    W = H = 128
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=4, delta_budget=4)
    img = np.asarray(render_pt(scene, cam, W, H, 8, cfg,
                               jax.random.PRNGKey(7)))
    target = np.load(fixture)
    a = tonemap_u8(img, W, H).astype(np.float32)
    b = tonemap_u8(target, W, H).astype(np.float32)
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    assert rmse < 1.0, rmse
    assert abs(float(a.mean()) - float(b.mean())) < 0.5
