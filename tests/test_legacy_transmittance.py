"""RGB shadow-transmittance machinery (legacy Ks / refract materials).

The reference's ``check_visibility`` (geometric.cuh:293-325) returns an RGB
transmission: occluders with ``mtl_old.refract <= 0`` block fully, refractive
occluders multiply their legacy ``Ks`` into the shadow ray.  The reference
never populates ``Material_Old`` (``to_cmtl_old`` is dead code, SURVEY.md
quirk 12), so the reachable behavior is binary blocking — but the machinery
exists, and the ``K`` scene record activates it here (VERDICT r1 missing #5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracing_tpu.scene import scene_path
from path_tracing_tpu.config import RenderConfig
from path_tracing_tpu.integrators.bdpt import render_bdpt
from path_tracing_tpu.integrators.pt import render_pt
from path_tracing_tpu.ops.intersect import (shadow_factor, transmittance,
                                            transmittance_rgb)
from path_tracing_tpu.scene.camera import make_camera
from path_tracing_tpu.scene.parser import load_scene, parse_scene_text

INPUT_TXT = scene_path("cornell.txt")

OCCLUDER_SCENE = """
M 0.8 0.8 0.8 1 0 0
K 0.5 0.25 1.0 1.5    // refractive: multiplies Ks
S 0 0 3 0.5
M 0.8 0.8 0.8 1 0 0   // M resets the legacy tail -> opaque
S 0 0 6 0.5
M 0.2 0.2 0.2 1 0 0
K 0.9 0.6 0.3 1.1     // second refractive occluder (triangle quad at z=8)
T -2 -2 8  2 -2 8  0 2 8
L 0 20 0  0 -1 0  1 1 1  180 0 0.1
"""


def _pts(*pairs):
    p1 = jnp.asarray([p for p, _ in pairs], jnp.float32)
    p2 = jnp.asarray([q for _, q in pairs], jnp.float32)
    return p1, p2


def test_parser_k_record_state_machine():
    p = parse_scene_text(OCCLUDER_SCENE)
    assert p.sph_legacy[0] == [0.5, 0.25, 1.0, 1.5]
    assert p.sph_legacy[1] == [0.0, 0.0, 0.0, 0.0]  # M reset the tail
    assert p.tri_legacy[0] == [0.9, 0.6, 0.3, 1.1]
    s = p.to_device()
    assert s.has_legacy_ks
    # reference-shipped scenes carry no K records and stay binary
    assert not load_scene(INPUT_TXT).to_device().has_legacy_ks


def test_transmittance_rgb_semantics():
    s = parse_scene_text(OCCLUDER_SCENE).to_device()
    p1, p2 = _pts(
        ([0, 0, 0], [0, 0, 2.0]),    # no occluder -> 1
        ([0, 0, 0], [0, 0, 4.5]),    # refractive sphere -> Ks
        ([0, 0, 0], [0, 0, 7.0]),    # + opaque sphere -> 0
        ([0, 0, 4.5], [0, 0, 9.0]),  # opaque sphere + refractive tri -> 0
        ([0, 5, 7.0], [0, 5, 9.0]),  # refractive tri alone... (misses: x=0,y=5
                                     # is outside the tri) -> 1
        ([0, 0, 7.0], [0, 0, 9.0]),  # refractive tri alone -> its Ks
    )
    tr = np.asarray(jax.jit(transmittance_rgb, static_argnums=())(s, p1, p2))
    np.testing.assert_allclose(tr[0], [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(tr[1], [0.5, 0.25, 1.0], atol=1e-6)
    np.testing.assert_allclose(tr[2], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(tr[3], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(tr[4], [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(tr[5], [0.9, 0.6, 0.3], atol=1e-6)


def test_transmittance_rgb_multiplies_in_series():
    s = parse_scene_text(OCCLUDER_SCENE).to_device()
    p1, p2 = _pts(([0, 0, 4.5], [0, 0, 9.0]))
    # move past the opaque sphere by starting behind it: 6.8 .. 9 crosses
    # only the triangle; 2 .. 9 crosses all three
    p1b, p2b = _pts(([0, 0, 2.0], [0, 0, 9.0]))
    tr_all = np.asarray(transmittance_rgb(s, p1b, p2b))[0]
    np.testing.assert_allclose(tr_all, [0, 0, 0], atol=1e-6)  # opaque kills
    # series product of the two refractive occluders, no opaque: shoot a ray
    # that clips both Ks objects but misses the opaque sphere
    s2 = parse_scene_text("""
M 0 0 0 1 0 0
K 0.5 0.5 1.0 1.5
S 0 0 3 0.5
M 0 0 0 1 0 0
K 0.8 0.4 0.2 1.1
T -2 -2 8  2 -2 8  0 2 8
L 0 20 0  0 -1 0  1 1 1  180 0 0.1
""").to_device()
    p1c, p2c = _pts(([0, 0, 0], [0, 0, 9.0]))
    tr = np.asarray(transmittance_rgb(s2, p1c, p2c))[0]
    np.testing.assert_allclose(tr, [0.4, 0.2, 0.2], atol=1e-6)


def test_transmittance_rgb_chunked_matches_block():
    # B > 65536 forces the lax.map chunked driver (incl. a padded tail);
    # it must agree lane-for-lane with the one-shot block computation.
    from path_tracing_tpu.ops.intersect import _transmittance_rgb_block

    s = parse_scene_text(OCCLUDER_SCENE).to_device()
    B = 65536 + 257
    rng = np.random.default_rng(0)
    p1 = jnp.asarray(rng.uniform(-1, 1, (B, 3)).astype(np.float32))
    p2 = jnp.asarray(rng.uniform(-1, 10, (B, 3)).astype(np.float32))
    chunked = np.asarray(jax.jit(transmittance_rgb)(s, p1, p2))
    block = np.asarray(jax.jit(_transmittance_rgb_block)(s, p1, p2))
    np.testing.assert_allclose(chunked, block, atol=1e-6)
    assert chunked.shape == (B, 3)


def test_shadow_factor_binary_fallbacks():
    # scenes without legacy data broadcast the binary transmittance
    s = load_scene(INPUT_TXT).to_device()
    key = jax.random.PRNGKey(1)
    p1 = jax.random.uniform(key, (64, 3), minval=-0.4, maxval=0.4)
    p2 = jax.random.uniform(jax.random.fold_in(key, 1), (64, 3),
                            minval=-0.4, maxval=0.4)
    sf = np.asarray(shadow_factor(s, p1, p2, dielectrics_block=True))
    tr = np.asarray(transmittance(s, p1, p2, dielectrics_block=True))
    assert sf.shape == (64, 3)
    np.testing.assert_array_equal(sf, np.broadcast_to(tr[:, None], (64, 3)))
    # the CPU-oracle rule (dielectrics_block=False) stays binary even on
    # legacy scenes (cpu_check_visibility is binary, cpu_bdpt.cpp:82-107)
    s2 = parse_scene_text(OCCLUDER_SCENE).to_device()
    p1b, p2b = _pts(([0, 0, 0], [0, 0, 4.5]))
    sf2 = np.asarray(shadow_factor(s2, p1b, p2b, dielectrics_block=False))
    assert sf2.shape == (1, 3)
    assert sf2[0, 0] == sf2[0, 1] == sf2[0, 2]


RENDER_SCENE_TMPL = """
E 0 0.5 -2.5
V 0 -0.5 0  0 1 0
F 60
R 16 16
M 0.75 0.75 0.75 1 0 0
T -3 -1 -3  3 -1 -3  0 -1 6      // diffuse floor
M 1.0 1.0 1.0 0.0 0.0 1.5
K {ks} 1.5
T -3 0 -3  3 0 -3  0 0 6         // smooth-glass slab between floor and light
L 0 3 0  0 -1 0  30 30 30  180 0 0.2
"""


def _render(ks: str, integrator=render_pt):
    p = parse_scene_text(RENDER_SCENE_TMPL.format(ks=ks))
    scene = p.to_device()
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 16, 16)
    cfg = RenderConfig(width=16, height=16, eye_depth=3, light_depth=3,
                       delta_budget=3)
    if integrator is render_pt:
        img = render_pt(scene, cam, 16, 16, 8, cfg, jax.random.PRNGKey(7))
    else:
        img = render_bdpt(scene, cam, 16, 16, 4, 4, cfg,
                          jax.random.PRNGKey(7))
    return np.asarray(img)


def test_pt_nee_tinted_by_refractive_occluder():
    neutral = _render("1 1 1")
    tinted = _render("1 0 0")
    assert np.all(np.isfinite(neutral)) and np.all(np.isfinite(tinted))
    # identical sampling decisions -> the red channel is untouched by the
    # Ks change, while green/blue lose the NEE light that crossed the slab
    np.testing.assert_allclose(tinted[:, 0], neutral[:, 0], rtol=1e-5)
    assert float(tinted[:, 1].mean()) < 0.7 * float(neutral[:, 1].mean())
    assert float(tinted[:, 2].mean()) < 0.7 * float(neutral[:, 2].mean())


def test_bdpt_connections_tinted_by_refractive_occluder():
    neutral = _render("1 1 1", integrator=render_bdpt)
    tinted = _render("0.2 1 0.2", integrator=render_bdpt)
    assert np.all(np.isfinite(neutral)) and np.all(np.isfinite(tinted))
    np.testing.assert_allclose(tinted[:, 1], neutral[:, 1], rtol=1e-5)
    assert float(tinted[:, 0].mean()) < 0.8 * float(neutral[:, 0].mean())


def test_native_parser_k_record_parity(tmp_path):
    from path_tracing_tpu.runtime.native import (native_available,
                                                 parse_scene_native)

    if not native_available():
        pytest.skip("native runtime unavailable")
    f = tmp_path / "legacy.txt"
    f.write_text(OCCLUDER_SCENE)
    a = parse_scene_native(str(f))
    if a is None or not a.sph_legacy:
        pytest.skip("stale libpt_runtime.so without pt_get_legacy")
    b = parse_scene_text(OCCLUDER_SCENE)
    np.testing.assert_allclose(np.asarray(a.sph_legacy),
                               np.asarray(b.sph_legacy), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.tri_legacy),
                               np.asarray(b.tri_legacy), atol=1e-6)
