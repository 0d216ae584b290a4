"""Tests that need an NVIDIA GPU (marked ``gpu``; the ``gpu`` fixture skips
them elsewhere).  On the card:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _render(device, name, size=32):
    import chip_smoke

    fn, scene_name = chip_smoke._small_renders(size)[name]
    return chip_smoke._render_on(device, fn, scene_name, size)


@pytest.mark.parametrize("name", ["pt", "bdpt", "ppm"])
def test_gpu_matches_cpu(gpu, name):
    import jax

    import chip_smoke
    from path_tracing_tpu.imagecmp import agreement

    a = _render(gpu, name)
    b = _render(jax.devices("cpu")[0], name)
    ag = agreement(a, b)
    assert ag.ok(chip_smoke.TOLERANCE[name]), ag


def test_no_tf32_on_the_render_path(gpu):
    import jax

    default = _render(gpu, "pt_cornell")
    with jax.default_matmul_precision("highest"):
        highest = _render(gpu, "pt_cornell")
    np.testing.assert_array_equal(default, highest)
