"""Multi-device sharding via ``shard_map`` over a device mesh.

The reference is single-GPU, single-process (SURVEY.md §2.2); this module is
the scaling design it lacks:

- **PT**: pixels are data-parallel — shard the flat lane axis over the mesh;
  no collectives (each shard owns its pixels' accumulation).
- **BDPT**: light subpaths shard over the mesh; the (small) light-vertex
  tensor is ``all_gather``-ed so every shard connects its pixels against
  ALL light vertices — the only cross-device traffic the algorithm needs.
- **PPM**: photons shard and their event tensors NEVER cross chips; the
  pixel-sized hitpoint table is all-gathered, each shard joins local events
  against all hitpoints, and the (B, 3) flux merges with ``psum_scatter``
  back to the pixel owners.

The mesh is flat (``("dp",)``): the cards of one host are joined all to
all, so the layout follows the algorithm alone.

**Mesh-invariant RNG**: every per-lane draw uses GLOBAL Threefry counters
(``rng.uniforms_g`` with ``start = axis_index * lanes_per_shard``),
so each shard draws the exact bits of the matching single-device lane
slice.  Consequences, pinned by ``__graft_entry__.dryrun_multichip`` and
``tests/test_sharding.py``: a sharded PT/BDPT render is per-pixel
BIT-EXACT against single-device (PPM matches to float associativity of its
flux ``psum``), and meshes of any size render identical images.

Everything compiles and runs on a virtual CPU mesh
(``--xla_force_host_platform_device_count=N``) for hardware-free CI.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8 promotes shard_map out of experimental (and renames
    # check_rep -> check_vma)
    from jax import shard_map as _shard_map

    def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True):
        # default True to match upstream check_rep/check_vma semantics
        # (ADVICE r1: a call site omitting it must not silently lose
        # replication checking)
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=check_rep)
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..config import RenderConfig
from ..scene.types import Camera, Scene


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """Flat render mesh over the first ``n_devices`` devices (all of them by
    default)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _lane_spec(mesh: Mesh):
    """(axis name, lane PartitionSpec) of the flat mesh."""
    (ax,) = mesh.axis_names
    return ax, P(ax)


def render_pt_sharded(scene: Scene, cam: Camera, width: int, height: int,
                      spp: int, cfg: RenderConfig, key, mesh: Mesh) -> jnp.ndarray:
    """Pixel-sharded PT: each device traces ``W*H/n`` lanes; zero collectives.

    Each shard runs the same regenerating wavefront (``wavefront_pt``) as
    single-device ``render_pt``."""
    from ..integrators.pt import wavefront_pt

    n = mesh.devices.size
    B = width * height
    assert B % n == 0, f"pixels ({B}) must divide the mesh ({n})"
    ax, lane = _lane_spec(mesh)
    idx = jnp.arange(B, dtype=jnp.int32)
    px = idx % width
    py = idx // width

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), lane, lane, P()),
             out_specs=lane, check_rep=False)
    def shard_fn(scene, cam, px_l, py_l, key):
        me = jax.lax.axis_index(ax)
        # global-counter RNG: this shard draws rows [me*B/n, (me+1)*B/n) of
        # the single-device (B,) draw — per-pixel bit-exact vs single chip
        return wavefront_pt(scene, cam, cfg, px_l, py_l, spp, key,
                            start=me * (B // n), total=B) / spp

    return shard_fn(scene, cam, px, py, key)


def render_ppm_sharded(scene: Scene, cam: Camera, width: int, height: int,
                       spl: int, cfg: RenderConfig, key, mesh: Mesh) -> jnp.ndarray:
    """PPM over the mesh: the eye pass is pixel-sharded; photons shard over
    the mesh and each shard gathers flux for its OWN pixels' hitpoints from
    its local photons, so the per-pixel flux merge is a ``psum`` over the
    mesh axis — the counterpart of the reference's global atomicAdd flux
    buffer (ppm_cu.cu:253-254).
    """
    from ..integrators.ppm import gather_flux, ppm_eye_trace, ppm_photon_trace
    from ..ops.math3 import PI, clamp_radiance, is_valid_color

    n = mesh.devices.size
    B = width * height
    assert B % n == 0
    ax, lane = _lane_spec(mesh)
    true_photons = scene.num_lights * spl
    num_photons = ((true_photons + n - 1) // n) * n  # mesh-rounding pad

    idx = jnp.arange(B, dtype=jnp.int32)
    px = idx % width
    py = idx // width

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), lane, lane, P()),
             out_specs=lane, check_rep=False)
    def shard_fn(scene_s, cam_s, px_l, py_l, key):
        me = jax.lax.axis_index(ax)
        direct, hp_local = ppm_eye_trace(scene_s, cam_s, cfg, px_l, py_l,
                                         jax.random.fold_in(key, 1),
                                         start=me * (B // n), total=B)
        # Photon events STAY on the chip that traced them (they are the big
        # tensor: photons x light_iters rows).  Instead the small per-pixel
        # hitpoint table is all-gathered (B rows total — pixel-sized), every
        # shard joins its LOCAL events against all hitpoints, and the
        # per-hitpoint flux (B, 3) is merged with a psum_scatter back to the
        # pixel owner — a true reduction, the counterpart of the reference's
        # global atomicAdd flux buffer (ppm_cu.cu:253-254).
        # global start/total keep the light assignment (global photon
        # index % num_lights) identical to single-device — each light gets
        # exactly spl photons across the WHOLE mesh — and kill the
        # mesh-rounding pad lanes (no silent flux inflation)
        # key is NOT me-folded: ppm_photon_trace's start/total now route the
        # RNG too (global counters), so local events are the bit-exact slice
        # of the single-device event tensor
        ev_local = ppm_photon_trace(
            scene_s, cfg, num_photons // n, spl,
            jax.random.fold_in(key, 2),
            start=me * (num_photons // n), total=true_photons)
        hp_all = jax.tree.map(
            lambda x: jax.lax.all_gather(x, ax, axis=0, tiled=True),
            hp_local)
        flux_part, count_part, _ = gather_flux(scene_s, cfg, hp_all, ev_local)
        flux = jax.lax.psum_scatter(flux_part, ax, scatter_dimension=0,
                                    tiled=True)
        count = jax.lax.psum_scatter(count_part, ax, scatter_dimension=0,
                                     tiled=True)
        radiance = flux / max(PI * cfg.ppm_radius * cfg.ppm_radius, 1e-6)
        radiance = jnp.where(
            (hp_local.valid & is_valid_color(radiance))[:, None],
            clamp_radiance(radiance, cfg.clamp), 0.0)
        return direct + radiance + 0.0 * jnp.sum(count)

    return shard_fn(scene, cam, px, py, key)


def render_bdpt_sharded(scene: Scene, cam: Camera, width: int, height: int,
                        spp: int, spl: int, cfg: RenderConfig, key,
                        mesh: Mesh, light_sample: int = 0,
                        chunk: int = 32) -> jnp.ndarray:
    """BDPT over the mesh: light paths sharded + all_gather of the vertex
    tensor; eye pixels sharded.

    The per-shard eye pass reuses ``integrators.bdpt.eye_pass``, the same
    eye trace and connection sweep as single-device ``render_bdpt``."""
    from ..integrators.bdpt import eye_pass, trace_light_paths

    n = mesh.devices.size
    B = width * height
    assert B % n == 0
    ax, lane = _lane_spec(mesh)
    ls = light_sample or spl
    true_paths = scene.num_lights * ls * spl
    num_paths = ((true_paths + n - 1) // n) * n  # pad to the mesh
    scene_used = scene.with_illum_scaled(1.0 / ls)

    idx = jnp.arange(B, dtype=jnp.int32)
    px = idx % width
    py = idx // width

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), lane, lane, P()),
             out_specs=lane, check_rep=False)
    def shard_fn(scene_s, cam_s, px_l, py_l, key):
        me = jax.lax.axis_index(ax)
        # each shard traces its slice of the light paths, then the vertex
        # tensor is gathered (it is small: paths*light_depth vertices)
        # global start/total: light assignment (global path index % Nl)
        # matches single-device, and mesh-rounding pad lanes store nothing
        # key is NOT me-folded: start/total route the RNG through global
        # counters, so the gathered vertex tensor is bit-identical to the
        # single-device trace (all_gather(tiled) concatenates in mesh-linear
        # order = global lane order)
        lv_local = trace_light_paths(
            scene_s, cfg, num_paths // n, spl,
            jax.random.fold_in(key, 0x0101),
            start=me * (num_paths // n), total=true_paths)
        lv = jax.tree.map(
            lambda x: jax.lax.all_gather(x, ax, axis=0, tiled=True),
            lv_local)
        # eye sampling also draws global counters (bit-exact per pixel)
        return eye_pass(scene_s, lv, cam_s, cfg, px_l, py_l, spp,
                        key, float(ls), chunk,
                        start=me * (B // n), total=B)

    return shard_fn(scene_used, cam, px, py, key)
