"""Regenerate tests/fixtures/mis_pt_128.npy — the fixed-seed 128^2 PT
render of the headline scene pinned by test_golden.py::
test_mis_scene_estimator_pinned.

Run ONLY after an intended estimator change, on CPU (the fixture pins the
deterministic XLA-tier draw sequence)::

    python tests/gen_mis_fixture.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from path_tracing_tpu.config import RenderConfig
    from path_tracing_tpu.integrators.pt import render_pt
    from path_tracing_tpu.scene import scene_path
    from path_tracing_tpu.scene.camera import make_camera
    from path_tracing_tpu.scene.parser import load_scene

    p = load_scene(scene_path("mis.txt"))
    scene = p.to_device()
    W = H = 128
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=4, delta_budget=4)
    img = np.asarray(render_pt(scene, cam, W, H, 8, cfg,
                               jax.random.PRNGKey(7))).astype(np.float32)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "mis_pt_128.npy")
    np.save(out, img)
    print(f"wrote {out}  mean={img.mean():.5f}")


if __name__ == "__main__":
    main()
