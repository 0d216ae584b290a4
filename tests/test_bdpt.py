"""BDPT integrator tests (tiny configs — CPU compile of the full scan chain
is expensive on this box, so shapes are minimal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracing_tpu.scene import scene_path
from path_tracing_tpu.config import RenderConfig
from path_tracing_tpu.integrators.bdpt import (render_bdpt, render_oracle,
                                               trace_light_paths)
from path_tracing_tpu.scene.camera import make_camera
from path_tracing_tpu.scene.parser import load_scene

INPUT_TXT = scene_path("cornell.txt")
W = H = 16


@pytest.fixture(scope="module")
def setup():
    p = load_scene(INPUT_TXT)
    scene = p.to_device()
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=3, light_depth=3,
                       delta_budget=3)
    return scene, cam, cfg


def test_light_vertex_tensor_invariants(setup):
    scene, cam, cfg = setup
    f = jax.jit(trace_light_paths,
                static_argnames=("cfg", "num_paths", "spl"))
    lv = f(scene, cfg=cfg, num_paths=8, spl=2, key=jax.random.PRNGKey(0))
    # vertex 0: the emitter, always valid
    assert bool(jnp.all(lv.valid[:, 0]))
    assert bool(jnp.all(lv.is_light_source[:, 0]))
    # spot emitters start on the ball surface (the Cornell scene has no parallel
    # lights): |origin - light_pos| == ball_r
    li = np.arange(8) % scene.num_lights
    d = np.asarray(lv.pos[:, 0]) - np.asarray(scene.light_pos)[li]
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1),
                               np.asarray(scene.light_ball_r)[li], rtol=1e-4)
    # emission directions are unit and inside each light's cone
    n0 = np.asarray(lv.normal[:, 0])
    np.testing.assert_allclose(np.linalg.norm(n0, axis=-1), 1.0, atol=1e-5)
    cos_cut = np.cos(np.asarray(scene.light_cutoff)[li])
    cos_emit = np.sum(n0 * np.asarray(lv.emit_dir[:, 0]), axis=-1)
    assert np.all(cos_emit >= cos_cut - 1e-4)
    # the MIS suffix factor is 0 at t=0 (the walk never visits the emitter)
    np.testing.assert_allclose(np.asarray(lv.mis_a[:, 0]), 0.0)
    # vertex-0 throughput = illum / spl
    np.testing.assert_allclose(
        np.asarray(lv.throughput[:, 0]),
        np.asarray(scene.light_illum)[li] / 2.0, rtol=1e-5)


def test_bdpt_renders_finite_nonzero(setup):
    scene, cam, cfg = setup
    img = np.asarray(render_bdpt(scene, cam, W, H, 1, 2, cfg,
                                 jax.random.PRNGKey(0), chunk=32))
    assert img.shape == (W * H, 3)
    assert np.all(np.isfinite(img)) and np.all(img >= 0)
    assert float(np.mean(img.sum(-1) > 1e-4)) > 0.9  # connections light all
    # absolute brightness in the golden image's band (linear mean ~0.1-0.2)
    assert 0.02 < float(img.mean()) < 0.6


def test_bdpt_deterministic(setup):
    scene, cam, cfg = setup
    a = np.asarray(render_bdpt(scene, cam, W, H, 1, 2, cfg,
                               jax.random.PRNGKey(5), chunk=32))
    b = np.asarray(render_bdpt(scene, cam, W, H, 1, 2, cfg,
                               jax.random.PRNGKey(5), chunk=32))
    np.testing.assert_array_equal(a, b)


def test_oracle_matches_gpu_parity_statistically(setup):
    """The oracle differs only in normalization/visibility conventions that
    cancel on this scene's direct paths; the two estimators must agree in
    expectation.  Compare coarse (4x4-block) means at low sample counts."""
    scene, cam, cfg = setup
    g = np.asarray(render_bdpt(scene, cam, W, H, 2, 4, cfg,
                               jax.random.PRNGKey(1), chunk=32))
    o = np.asarray(render_oracle(scene, cam, W, H, 2, 16, cfg, seed=2,
                                 chunk=32))
    gb = g.reshape(4, 4, 4, 4, 3).mean((1, 3))
    ob = o.reshape(4, 4, 4, 4, 3).mean((1, 3))
    gb, ob = np.clip(gb, 0, 1), np.clip(ob, 0, 1)
    rel = np.abs(gb - ob).mean() / max(ob.mean(), 1e-6)
    assert rel < 0.6, rel  # loose: both are noisy at these sample counts


def test_oracle_bit_reproducible(setup):
    scene, cam, cfg = setup
    a = np.asarray(render_oracle(scene, cam, W, H, 1, 4, cfg, seed=7, chunk=32))
    b = np.asarray(render_oracle(scene, cam, W, H, 1, 4, cfg, seed=7, chunk=32))
    c = np.asarray(render_oracle(scene, cam, W, H, 1, 4, cfg, seed=8, chunk=32))
    np.testing.assert_array_equal(a, b)
    assert np.any(a != c)


def test_oracle_regression_fixture(setup):
    """Pin the oracle's output against a committed fixture: semantic drift in
    any shared module (BSDF, MIS prefactors, emission sampling, visibility)
    shows up here.  Tolerances absorb cross-platform fp association."""
    scene_, _, _ = setup
    p = load_scene(INPUT_TXT)
    scene = p.to_device()
    W2 = H2 = 48
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W2, H2)
    cfg = RenderConfig(width=W2, height=H2, eye_depth=4, light_depth=4,
                       delta_budget=4)
    img = np.asarray(render_oracle(scene, cam, W2, H2, 2, 8, cfg, seed=1337,
                                   chunk=32))
    ref = np.load("tests/fixtures/oracle_48_input.npz")["img"]
    rmse = float(np.sqrt(np.mean(
        (np.clip(img, 0, 1) - np.clip(ref, 0, 1)) ** 2)))
    assert rmse < 0.02, rmse
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.05


def _ref_connection_numpy(ev_pos, ev_n, ev_tp, ev_mtl, wo_e, wo_s,
                          eye_fwd1, lv_pos, lv_n, lv_tp, lv_mtl, lv_wo,
                          lv_fwd1, clamp=15.0):
    """Literal NumPy transcription of ONE reference connection
    (bdpt_cu.cu:384-457 + calculate_mis_weight :204-284) for a clear
    visibility segment, eye walk s_idx in {0, 1} (``eye_fwd1=None`` for
    s_idx=0), light walk t_idx=1 with a surface vertex of pdf_fwd
    ``lv_fwd1``.  Reuses the PT oracle's literal bsdf transcription —
    crucially ``_bsdf_eval_pdf`` is scale-transparent like the reference's
    ``bsdf_pdf``, so the UNNORMALIZED ``d_vec`` goes straight in."""
    from tests.pt_numpy_oracle import _bsdf_eval_pdf

    d_vec = lv_pos - ev_pos
    dist2 = float(np.dot(d_vec, d_vec))
    dist = np.sqrt(dist2)
    wi = d_vec / dist
    cosE = max(0.0, float(np.dot(ev_n, wi)))
    cosL = max(0.0, float(np.dot(lv_n, -wi)))
    assert cosE > 0.0 and cosL > 0.0 and dist2 >= 1e-6

    def eval_unit(mtl, wo, w, n):
        f, _ = _bsdf_eval_pdf(mtl[None], wo[None], w[None], n[None])
        return f[0]

    def pdf_scaled(mtl, wo, w, n):   # reference passes UNNORMALIZED w
        _, p = _bsdf_eval_pdf(mtl[None], wo[None], w[None], n[None])
        return float(p[0])

    fE = eval_unit(ev_mtl, wo_e, wi, ev_n)
    fL = eval_unit(lv_mtl, lv_wo, -wi, lv_n)
    G = cosE * cosL / max(dist2, 1e-4)

    # calculate_mis_weight: dir_e_to_l is the UNNORMALIZED d_vec
    cos_s = max(0.0, float(np.dot(ev_n, d_vec)))
    cos_t = max(0.0, float(np.dot(lv_n, -d_vec)))
    pdf_omega_s = max(pdf_scaled(ev_mtl, wo_s, d_vec, ev_n), 1e-6)
    pdf_omega_t = max(pdf_scaled(lv_mtl, lv_wo, -d_vec, lv_n), 1e-6)
    pdf_s_to_t = pdf_omega_s * cos_t / dist2
    pdf_t_to_s = pdf_omega_t * cos_s / dist2
    sum_ratios = 1.0
    if eye_fwd1 is not None:         # s_idx=1: one eye-walk iteration
        sum_ratios += pdf_t_to_s / max(eye_fwd1, 1e-8)
    sum_ratios += pdf_s_to_t / max(lv_fwd1, 1e-8)  # t_idx=1 surface vertex
    mis_w = 1.0 / sum_ratios

    contrib = ev_tp * fE * G * fL * lv_tp * mis_w
    return np.minimum(contrib, clamp)


@pytest.mark.parametrize("eye_fwd1", [None, 0.0])
def test_connection_matches_reference_transcription(eye_fwd1):
    """_connect vs a literal transcription of the reference connection —
    including the dist-scaled MIS end pdfs (the reference passes the
    UNNORMALIZED d_vec into bsdf_pdf, bdpt_cu.cu:443-449 /
    cpu_bdpt.cpp:130-137, and converts with dot(n, d_vec) cosines).
    ``eye_fwd1=0.0`` is the reference's eye-vertex pdf_fwd placeholder
    (clamped to 1e-8 -> eye_f = 1e8), ``None`` the depth-0 case."""
    from path_tracing_tpu.integrators.bdpt import LightVertices, _connect
    from path_tracing_tpu.scene.parser import parse_scene_text
    from path_tracing_tpu.scene.types import Material

    # far-away geometry: the connection segment is unoccluded
    p = parse_scene_text("""
E 0 5 10
V 0 0 0  0 1 0
F 50
R 8 8
M 0.8 0.8 0.8 1.0 0.0 0.0
T -90 -50 -90  90 -50 -90  90 -50 90
L 0 40 0  0 -1 0  10 10 10  60 0 0.5
""")
    scene = p.to_device()
    cfg = RenderConfig(width=8, height=8, eye_depth=2, light_depth=2)

    def nrm(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v)

    ev_pos = np.array([0.0, 0.0, 0.0])
    ev_n = np.array([0.0, 0.0, 1.0])
    ev_tp = np.array([1.2, 1.0, 0.7])
    wo_e = nrm([0.3, -0.2, 1.0])
    wo_s = nrm([-0.5, 0.1, 1.0])
    ev_mtl_row = np.array([0.6, 0.5, 0.4, 0.8, 0.0, 0.0])  # rgb,rough,met,eta

    lv_pos = np.array([1.5, 0.7, 2.0])   # dist ~2.6: scale effects visible
    lv_n = nrm([-0.3, 0.1, -1.0])
    lv_tp = np.array([0.9, 0.8, 1.1])
    lv_wo = nrm([0.2, -0.4, -0.8])
    lv_mtl_row = np.array([0.3, 0.7, 0.2, 0.5, 0.0, 0.0])
    lv_fwd1 = 0.53                        # light-side walk: A = 1/0.53

    ref = _ref_connection_numpy(ev_pos, ev_n, ev_tp, ev_mtl_row, wo_e, wo_s,
                                eye_fwd1, lv_pos, lv_n, lv_tp, lv_mtl_row,
                                lv_wo, lv_fwd1, clamp=cfg.clamp)

    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    lv_flat = LightVertices(
        pos=f32(lv_pos[None]), normal=f32(lv_n[None]),
        throughput=f32(lv_tp[None]),
        mtl=Material(base_color=f32(lv_mtl_row[None, :3]),
                     roughness=f32([lv_mtl_row[3]]),
                     metallic=f32([lv_mtl_row[4]]),
                     eta=f32([lv_mtl_row[5]])),
        pdf_fwd=f32([lv_fwd1]), pdf_rev=f32([0.0]),
        is_light_source=jnp.zeros((1,), bool),
        source_cutoff=f32([0.0]), is_parallel=jnp.zeros((1,), bool),
        emit_dir=f32(np.zeros((1, 3))), wo=f32(lv_wo[None]),
        mis_a=f32([1.0 / lv_fwd1]), valid=jnp.ones((1,), bool))
    ev_mtl = Material(base_color=f32(ev_mtl_row[None, :3]),
                      roughness=f32([ev_mtl_row[3]]),
                      metallic=f32([ev_mtl_row[4]]),
                      eta=f32([ev_mtl_row[5]]))
    eye_f = 0.0 if eye_fwd1 is None else 1.0 / max(eye_fwd1, 1e-8)
    got = np.asarray(_connect(
        scene, cfg, lv_flat, jnp.int32(1), f32(ev_pos[None]),
        f32(ev_n[None]), f32(ev_tp[None]), ev_mtl, f32(wo_e[None]),
        f32(wo_s[None]), f32([eye_f]), 8))[0]

    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-7)


DIFFUSE_BOX = """
E 0 2 8
V 0 0 0  0 1 0
F 50
R 8 8
// closed diffuse box (no delta materials: stored vertices are adjacent)
M 0.7 0.7 0.7 1.0 0.0 0.0
T -5 -3 -5  5 -3 -5  5 -3 5
T -5 -3 -5  5 -3 5  -5 -3 5
T -5 5 -5  5 5 5  5 5 -5
T -5 5 -5  -5 5 5  5 5 5
T -5 -3 -5  5 -3 -5  5 5 -5
T -5 -3 -5  5 5 -5  -5 5 -5
M 0.6 0.3 0.3 0.8 0.0 0.0
T -5 -3 -5  -5 5 -5  -5 5 5
T -5 -3 -5  -5 5 5  -5 -3 5
T 5 -3 -5  5 5 5  5 5 -5
T 5 -3 -5  5 -3 5  5 5 5
L -2 3 0  0.3 -1 0.2  9 7 5  80 0 0.4
L  2 3 1  -0.2 -1 0   4 6 8  80 0 0.3
"""


def _traced_table(light_depth=4, paths=24, spl=4):
    from path_tracing_tpu.scene.parser import parse_scene_text

    p = parse_scene_text(DIFFUSE_BOX)
    scene = p.to_device()
    cfg = RenderConfig(width=8, height=8, eye_depth=2,
                       light_depth=light_depth, delta_budget=2)
    lv = trace_light_paths(scene, cfg, paths, spl, jax.random.PRNGKey(11))
    np_lv = {f: np.asarray(getattr(lv, f)) for f in
             ("pos", "normal", "throughput", "pdf_fwd", "pdf_rev",
              "is_light_source", "wo", "mis_a", "valid")}
    np_lv["mtl"] = np.concatenate(
        [np.asarray(lv.mtl.base_color),
         np.asarray(lv.mtl.roughness)[..., None],
         np.asarray(lv.mtl.metallic)[..., None],
         np.asarray(lv.mtl.eta)[..., None]], axis=-1)
    return np_lv


def test_light_trace_stored_pdfs_match_literal_recomputation():
    """Stored pdf_fwd/pdf_rev vs literal reference math recomputed from the
    stored geometry (bdpt_cu.cu:133-141,183-184): on a delta-free scene,
    consecutive stored vertices are physically adjacent, so
      pdf_fwd[t] = pdf_omega(prev) * |dot(n_t, dir)| / dist2
      pdf_rev[t] = bsdf_pdf(mtl_t, dir_{t+1}, wo_t) * |dot(n_{t-1}, dir_t)|
                   / dist2
    with pdf_omega(vertex 0) = 1/pi (bdpt_cu.cu:102) and bsdf_sample's
    returned rough pdf == bsdf_pdf (geometric.cuh:539-561).  Same class of
    check that caught the dist-scaled connection-pdf quirk."""
    from tests.pt_numpy_oracle import _bsdf_eval_pdf

    t = _traced_table()
    P, L = t["pdf_fwd"].shape
    checked_fwd = checked_rev = 0
    for p_i in range(P):
        for ti in range(1, L):
            if not t["valid"][p_i, ti] or t["is_light_source"][p_i, ti]:
                continue
            pos_p, pos_t = t["pos"][p_i, ti - 1], t["pos"][p_i, ti]
            d = pos_t - pos_p
            dist2 = float(np.dot(d, d))
            if dist2 < 1e-6:
                continue
            dirn = d / np.sqrt(dist2)
            n_t, n_p = t["normal"][p_i, ti], t["normal"][p_i, ti - 1]
            if ti == 1:
                pdf_omega = 1.0 / np.pi
            else:
                _, pdf_omega = _bsdf_eval_pdf(
                    t["mtl"][p_i, ti - 1][None], t["wo"][p_i, ti - 1][None],
                    dirn[None], n_p[None])
                pdf_omega = float(pdf_omega[0])
            want_fwd = pdf_omega * abs(float(np.dot(n_t, dirn))) / dist2
            np.testing.assert_allclose(t["pdf_fwd"][p_i, ti], want_fwd,
                                       rtol=2e-4, atol=1e-7)
            checked_fwd += 1

            # pdf_rev needs the direction actually sampled at t: the next
            # stored vertex (delta-free scene)
            if ti + 1 < L and t["valid"][p_i, ti + 1] \
                    and not t["is_light_source"][p_i, ti + 1]:
                d2 = t["pos"][p_i, ti + 1] - pos_t
                wi = d2 / np.linalg.norm(d2)
                _, pdf_rev_omega = _bsdf_eval_pdf(
                    t["mtl"][p_i, ti][None], wi[None],
                    t["wo"][p_i, ti][None], n_t[None])
                want_rev = (float(pdf_rev_omega[0])
                            * abs(float(np.dot(n_p, dirn))) / dist2)
                np.testing.assert_allclose(t["pdf_rev"][p_i, ti], want_rev,
                                           rtol=2e-4, atol=1e-7)
                checked_rev += 1
    assert checked_fwd >= 10 and checked_rev >= 3, (checked_fwd, checked_rev)


def test_mis_prefactor_matches_literal_reference_walk():
    """mis_a[t] (the O(1) light-side suffix factor) vs the literal
    reference ratio walk (cpu_bdpt.cpp:152-166) run on the SAME stored
    pdf_fwd/pdf_rev table: sum_light(t, x=1) must equal mis_a[t]."""
    t = _traced_table()
    P, L = t["pdf_fwd"].shape
    eta = t["mtl"][..., 5]
    checked = 0
    for p_i in range(P):
        for ti in range(1, L):
            if not t["valid"][p_i, ti]:
                continue
            ratio, prev, total = 1.0, 1.0, 0.0
            for i in range(ti, 0, -1):
                if t["is_light_source"][p_i, i]:
                    ratio *= prev / max(t["pdf_fwd"][p_i, i], 1e-8)
                    total += ratio
                    break
                if eta[p_i, i] > 0.0:
                    break
                ratio *= prev / max(t["pdf_fwd"][p_i, i], 1e-8)
                total += ratio
                prev = t["pdf_rev"][p_i, i]
            np.testing.assert_allclose(t["mis_a"][p_i, ti], total,
                                       rtol=2e-4, atol=1e-6)
            checked += 1
    assert checked >= 10, checked


def test_connection_subsampling_unbiased():
    """bdpt_connection_samples (stratified O(M) connections) has the same
    expectation as the exact all-pairs sweep; with the SAME light subpaths
    the channel means agree at the MC noise floor."""
    p = load_scene(INPUT_TXT)
    scene = p.to_device()
    W = H = 32
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=3, light_depth=3,
                       delta_budget=3)
    key = jax.random.PRNGKey(21)
    exact = np.asarray(render_bdpt(scene, cam, W, H, 8, 8, cfg, key))

    cfg_s = cfg.with_(bdpt_connection_samples=6)
    acc = np.zeros_like(exact)
    n = 6
    for i in range(n):
        acc += np.asarray(render_bdpt(scene, cam, W, H, 8, 8, cfg_s,
                                      jax.random.fold_in(key, 100 + i)))
    sub = acc / n
    me, ms = exact.mean(axis=0), sub.mean(axis=0)
    assert np.all(np.isfinite(sub))
    assert np.all(np.abs(me - ms) / np.maximum(np.abs(me), 1e-6) < 0.15), (
        me, ms)


def test_resample_light_vertices_unbiased_weights():
    """RIS invariant: for any linear functional of throughput, the
    resampled table's expectation equals the exact valid-prefix sum."""
    from path_tracing_tpu.integrators.bdpt import (compact_flat,
                                                   resample_light_vertices,
                                                   trace_light_paths)

    p = load_scene(INPUT_TXT)
    scene = p.to_device()
    cfg = RenderConfig(eye_depth=3, light_depth=3, delta_budget=3)
    lv = trace_light_paths(scene, cfg, scene.num_lights * 8, 8,
                           jax.random.PRNGKey(3))
    lv_flat, n_valid = compact_flat(lv.flat())
    nv = int(n_valid)
    assert nv > 16
    exact = np.asarray(lv_flat.throughput)[:nv].sum(axis=0)

    K = 16
    acc = np.zeros(3)
    n = 400
    for i in range(n):
        out, k2 = resample_light_vertices(lv_flat, n_valid, K,
                                          jax.random.PRNGKey(1000 + i))
        assert int(k2) == K
        acc += np.asarray(out.throughput).sum(axis=0)
    est = acc / n
    assert np.all(np.abs(est - exact) / np.maximum(np.abs(exact), 1e-6)
                  < 0.05), (est, exact)


def test_resampled_render_unbiased():
    """End-to-end: renders with the K-culled vertex table average to the
    exact-sweep render (same expectation, O(K) connection cost).

    PAIRED design: exact and resampled renders share each key, so the
    (heavy-tailed) light/eye-path noise cancels and only the resampling
    residual is measured — a single unpaired exact render's own MC error
    at this scale exceeds the tolerance (verified: per-key image means
    spread ~20% around [0.162, 0.174, 0.135] on this scene).
    """
    p = load_scene(INPUT_TXT)
    scene = p.to_device()
    W = H = 32
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    cfg = RenderConfig(width=W, height=H, eye_depth=3, light_depth=3,
                       delta_budget=3)
    cfg_r = cfg.with_(bdpt_resample_vertices=32)
    key = jax.random.PRNGKey(33)

    n = 6
    acc_e = acc_r = 0.0
    for i in range(n):
        k = jax.random.fold_in(key, 500 + i)
        acc_e = acc_e + np.asarray(
            render_bdpt(scene, cam, W, H, 8, 8, cfg, k))
        acc_r = acc_r + np.asarray(
            render_bdpt(scene, cam, W, H, 8, 8, cfg_r, k))
    me = (acc_e / n).mean(axis=0)
    ms = (acc_r / n).mean(axis=0)
    assert np.all(np.isfinite(acc_r))
    assert np.all(np.abs(me - ms) / np.maximum(np.abs(me), 1e-6) < 0.15), (
        me, ms)
