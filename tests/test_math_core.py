"""Unit tests for the L3 device-math equivalents (SURVEY.md §4).

All heavy computations run under ``jax.jit`` — eager per-op dispatch is very
slow in this environment.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracing_tpu.ops import math3
from path_tracing_tpu.ops.frame import (build_local_frame, local_to_world,
                                        world_to_local)
from path_tracing_tpu.ops.fresnel import fr_dielectric, fr_schlick
from path_tracing_tpu.ops.microfacet import (roughness_to_alpha,
                                             sample_tr_visible_normal, tr_d,
                                             tr_g)


def test_reflect_refract():
    @jax.jit
    def f():
        i = jnp.array([[0.70710678, -0.70710678, 0.0]])
        n = jnp.array([[0.0, 1.0, 0.0]])
        r = math3.reflect(i, n)
        d = math3.refract(i, n, jnp.array([1.0]))
        shallow = math3.normalize(jnp.array([[0.9998, -0.02, 0.0]]))
        z = math3.refract(shallow, n, jnp.array([1.5]))
        return r, d, z, i

    r, d, z, i = f()
    np.testing.assert_allclose(np.asarray(r), [[0.70710678, 0.70710678, 0.0]],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(d), np.asarray(i), atol=1e-6)
    np.testing.assert_allclose(np.asarray(z), 0.0, atol=1e-7)  # TIR -> 0


def test_clamp_radiance_and_valid():
    @jax.jit
    def f():
        c = jnp.array([[30.0, 15.0, 0.0], [1.0, 2.0, 3.0]])
        v = math3.is_valid_color(jnp.array(
            [[1.0, 1.0, 1.0], [-0.1, 0, 0], [jnp.nan, 0, 0], [jnp.inf, 0, 0]]))
        return math3.clamp_radiance(c, 15.0), v

    out, v = f()
    np.testing.assert_allclose(np.asarray(out), [[15.0, 7.5, 0.0], [1, 2, 3]],
                               atol=1e-5)
    assert list(np.asarray(v)) == [True, False, False, False]


def test_local_frame_roundtrip():
    @jax.jit
    def f():
        n = math3.normalize(jax.random.normal(jax.random.PRNGKey(0), (64, 3)))
        t, b = build_local_frame(n)
        v = math3.normalize(jax.random.normal(jax.random.PRNGKey(1), (64, 3)))
        vl = world_to_local(v, t, b, n)
        v2 = local_to_world(vl, t, b, n)
        return (math3.dot(t, n), math3.dot(b, n), math3.length(t), v, vl, v2,
                math3.dot(v, n))

    tn, bn, tl, v, vl, v2, vn = f()
    np.testing.assert_allclose(np.asarray(tn), 0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(bn), 0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tl), 1, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v), atol=1e-5)
    np.testing.assert_allclose(np.asarray(vl[..., 2]), np.asarray(vn), atol=1e-5)


def test_fresnel_dielectric():
    @jax.jit
    def f():
        return (fr_dielectric(jnp.array([1.0]), 1.0, jnp.array([1.5])),
                fr_dielectric(jnp.array([-0.5]), 1.0, jnp.array([1.5])),
                fr_dielectric(jnp.array([0.001]), 1.0, jnp.array([1.5])))

    normal, tir, grazing = f()
    # normal incidence on glass: ((1.5-1)/(1.5+1))^2 = 0.04
    np.testing.assert_allclose(np.asarray(normal), [0.04], atol=1e-4)
    # TIR from inside beyond the critical angle (sin_c = 1/1.5 -> ~41.8 deg)
    np.testing.assert_allclose(np.asarray(tir), [1.0], atol=1e-6)
    assert float(grazing[0]) > 0.95


def test_fresnel_schlick():
    @jax.jit
    def f():
        r0 = jnp.array([[0.9, 0.7, 0.2]])
        return fr_schlick(jnp.array([1.0]), r0), fr_schlick(jnp.array([0.0]), r0), r0

    at1, at0, r0 = f()
    np.testing.assert_allclose(np.asarray(at1), np.asarray(r0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(at0), 1.0, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0625, 0.25, 1.0])
def test_ggx_d_reference_quirk_normalization(alpha):
    """The reference's typo'd D (alpha^2 + tan^4) gives
    ``integral D cos dw = pi*alpha/2`` — NOT 1 (see ops/microfacet.py).
    Substituting u = tan^2(theta) turns the integral into
    ``integral_0^inf alpha^2/(alpha^2+u^2) du = pi*alpha/2``.
    This test pins the quirk so a "fix" to textbook GGX gets caught."""

    @jax.jit
    def estimate():
        n = 200_000
        k1, k2 = jax.random.split(jax.random.PRNGKey(2))
        u1 = jax.random.uniform(k1, (n,))
        u2 = jax.random.uniform(k2, (n,))
        r = jnp.sqrt(u1)
        phi = 2 * jnp.pi * u2
        wh = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                        jnp.sqrt(jnp.maximum(0, 1 - u1))], axis=-1)
        # cosine-weighted: pdf = cos/pi  ->  E[D*cos/(cos/pi)] = pi*E[D]
        return jnp.mean(tr_d(wh, jnp.array(alpha))) * jnp.pi

    expected = np.pi * alpha / 2.0
    est = float(estimate())
    assert abs(est - expected) < 0.06 * max(expected, 1.0), (est, expected)


def test_vndf_sampling_upper_hemisphere():
    @jax.jit
    def f():
        wo = math3.normalize(jnp.tile(jnp.array([[0.4, 0.2, 0.8]]), (1024, 1)))
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        u1 = jax.random.uniform(k1, (1024,))
        u2 = jax.random.uniform(k2, (1024,))
        wh = sample_tr_visible_normal(wo, jnp.full((1024,), 0.3), u1, u2)
        return wh, math3.length(wh), math3.dot(wo, wh)

    wh, lens, vis = f()
    assert bool(jnp.all(wh[:, 2] >= 0))
    np.testing.assert_allclose(np.asarray(lens), 1.0, atol=1e-5)
    assert float(jnp.mean((vis > 0).astype(jnp.float32))) > 0.99


def test_smith_g_bounds_and_alpha_floor():
    @jax.jit
    def f():
        wo = math3.normalize(jnp.array([[0.3, 0.1, 0.95]]))
        wi = math3.normalize(jnp.array([[-0.2, 0.4, 0.89]]))
        return (tr_g(wo, wi, jnp.array([0.5])),
                roughness_to_alpha(jnp.array([0.0, 0.5, 1.0])))

    g, a = f()
    assert 0.0 < float(g[0]) <= 1.0
    np.testing.assert_allclose(np.asarray(a), [1e-6, 0.25, 1.0], rtol=1e-5)
