"""Test configuration: the CPU backend with an 8-device virtual mesh.

Multi-device sharding paths are testable without hardware via XLA's host
platform device count (SURVEY.md §4).  Both settings must be in place before
JAX initializes, hence at conftest import time.  ``JAX_PLATFORMS`` is only
defaulted: the tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (README).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from path_tracing_tpu.runtime import setup_jax_cache  # noqa: E402

# persistent compile cache: the BDPT/PPM scan programs take a long time to
# compile on the CPU; cache them across test runs
setup_jax_cache()


@pytest.fixture
def gpu():
    """The default device, for tests marked ``gpu``; skips (at run time,
    never at import) when JAX's default device is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev


def make_textured_quad_obj(dirpath, n=8):
    """Shared fixture: unit quad in z=0 with uv = xy and a 4-quadrant
    map_Kd checker (UL red / UR green / LL blue / LR white in IMAGE space;
    uv v=1 maps to the top rows).  Returns the .obj path."""
    import os

    import numpy as np

    from path_tracing_tpu.film import write_png

    d = str(dirpath)
    img = np.zeros((n, n, 3), np.uint8)
    img[: n // 2, : n // 2] = (255, 0, 0)
    img[: n // 2, n // 2:] = (0, 255, 0)
    img[n // 2:, : n // 2] = (0, 0, 255)
    img[n // 2:, n // 2:] = (255, 255, 255)
    write_png(os.path.join(d, "check.png"), img)
    with open(os.path.join(d, "quad.mtl"), "w") as f:
        f.write("newmtl tex\nKd 1 1 1\nNs 2\nmap_Kd check.png\n")
    with open(os.path.join(d, "quad.obj"), "w") as f:
        f.write("mtllib quad.mtl\nusemtl tex\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                "f 1/1 2/2 3/3 4/4\n")
    return os.path.join(d, "quad.obj")
