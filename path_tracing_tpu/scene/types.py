"""Scene data model: SoA device arrays (the replacement for the reference's
``CudaSphere``/``CudaTriangle``/``CudaLight`` AoS buffers, reference
``include/geometric.cuh:21-78``, and the per-integrator marshalling globals
in ``src/{pt,bdpt,ppm}_cu_helper.cpp``).

One scene module shared by every integrator — killing the reference's
copy-paste triplication (SURVEY.md §1).  Everything is a registered JAX
pytree of fixed-shape arrays, uploaded to the device once and reused for
every progressive iteration (the reference re-uploads each call,
pt_cu.cu:270-278).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass
class Material:
    """PBR material (pbrt-v4-flavored): base color, GGX roughness, metallic,
    IOR.  Reference struct ``CudaMaterial`` (geometric.cuh:21-27); the derived
    ``type`` enum of ``to_cmtl`` (geometric.cu:41-49) is not stored — every
    classification the kernels make is recomputed from these fields, exactly
    like the device code does.

    All fields broadcast: ``base_color`` is ``(..., 3)``, the rest ``(...,)``.
    """

    base_color: jnp.ndarray
    roughness: jnp.ndarray
    metallic: jnp.ndarray
    eta: jnp.ndarray

    @staticmethod
    def stack(mats: "list[Material]") -> "Material":
        if not mats:
            return Material(
                base_color=jnp.zeros((0, 3), jnp.float32),
                roughness=jnp.zeros((0,), jnp.float32),
                metallic=jnp.zeros((0,), jnp.float32),
                eta=jnp.zeros((0,), jnp.float32),
            )
        return Material(
            base_color=jnp.stack([m.base_color for m in mats]),
            roughness=jnp.stack([m.roughness for m in mats]),
            metallic=jnp.stack([m.metallic for m in mats]),
            eta=jnp.stack([m.eta for m in mats]),
        )

    def gather(self, idx: jnp.ndarray) -> "Material":
        """Row-gather a batched material table by index array."""
        return Material(
            base_color=self.base_color[idx],
            roughness=self.roughness[idx],
            metallic=self.metallic[idx],
            eta=self.eta[idx],
        )

    @staticmethod
    def light_ball(illum: jnp.ndarray) -> "Material":
        """Material seen when a ray hits a light ball.

        The CPU oracle defines it as (eta=0, roughness=1, metallic=0) with
        base_color = light flux (cpu_bdpt.cpp:69-72); the GPU leaves the
        non-color fields uninitialized (geometric.cuh:355-368).  We use the
        defined CPU semantics everywhere (SURVEY.md quirk 6).
        """
        shape = illum.shape[:-1]
        return Material(
            base_color=illum,
            roughness=jnp.ones(shape, illum.dtype),
            metallic=jnp.zeros(shape, illum.dtype),
            eta=jnp.zeros(shape, illum.dtype),
        )


@_register
@dataclass
class Scene:
    """Device-resident SoA scene.

    - spheres: centers ``(Ns,3)``, radii ``(Ns,)``, materials ``(Ns,...)``
    - triangles: vertices ``(Nt,3)`` each, materials ``(Nt,...)``
    - lights (geometric.cuh:73-78): position, direction (raw, normalized at
      use sites like the kernels do), RGB flux ``illum``, spot ``cutoff``
      (radians), ``is_parallel`` flag, light-ball radius
    - scene AABB min/max (for parallel-light emission planes,
      bdpt_cu.cu:39-63)
    """

    sph_center: jnp.ndarray
    sph_radius: jnp.ndarray
    sph_mtl: Material
    tri_v0: jnp.ndarray
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    tri_mtl: Material
    light_pos: jnp.ndarray
    light_dir: jnp.ndarray
    light_illum: jnp.ndarray
    light_cutoff: jnp.ndarray
    light_is_parallel: jnp.ndarray  # int32 (0/1)
    light_ball_r: jnp.ndarray
    scene_min: jnp.ndarray
    scene_max: jnp.ndarray
    # triangle clusters (flattened median-split BVH, ops/bvh.py): triangles
    # are stored cluster-contiguous, as data for a BVH traversal; the
    # brute-force intersection does not read them.  aabb rows are
    # [min3, max3]; ranges are [start, count].
    tri_cluster_aabb: jnp.ndarray   # (M, 6)
    tri_cluster_range: jnp.ndarray  # (M, 2) int32
    # textures (ops/texture.py; OBJ map_Kd — the capability the reference's
    # vendored-but-unused tiny_obj_loader implies).  Empty for text scenes.
    tri_uv: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0, 6), jnp.float32))   # (Nt, 6)
    tri_tex: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0,), jnp.int32))       # (Nt,)
    tex_atlas: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0, 1, 1, 3), jnp.float32))
    tex_size: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0, 2), jnp.int32))     # (NT, 2)
    # legacy shadow-transmittance materials (reference Material_Old.Ks /
    # .refract, the only fields live on the device — inside
    # check_visibility's RGB transmittance, geometric.cuh:293-325).  The
    # reference never populates them (to_cmtl_old is dead code, quirk 12);
    # the 'K' scene record activates the machinery here.  Empty (0-row)
    # arrays mean "not activated" and keep every hot path on the binary
    # blocker kernels.  Rows: ks (N,3) RGB transmission factor; refract (N,)
    # — occluders with refract <= 0 block fully.
    sph_ks: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0, 3), jnp.float32))   # (Ns, 3)
    sph_refract: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0,), jnp.float32))     # (Ns,)
    tri_ks: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0, 3), jnp.float32))   # (Nt, 3)
    tri_refract: jnp.ndarray = field(
        default_factory=lambda: jnp.zeros((0,), jnp.float32))     # (Nt,)

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def has_textures(self) -> bool:
        """Static (trace-time): the nearest-hit step adds the UV
        interpolation and atlas fetch only for textured scenes."""
        return self.tex_atlas.shape[0] > 0 and self.tri_tex.shape[0] > 0

    @property
    def has_legacy_ks(self) -> bool:
        """Static (trace-time): scenes carrying legacy Ks/refract materials
        take the RGB shadow-transmittance path (ops/intersect.py
        ``shadow_factor``); all others the binary any-blocker test."""
        return self.sph_ks.shape[0] > 0 or self.tri_ks.shape[0] > 0

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    def with_illum_scaled(self, scale: float) -> "Scene":
        """Return a scene with light flux scaled (the BDPT marshal step divides
        illum by light_sample, bdpt_cu_helper.cpp:61-63)."""
        return dataclasses.replace(self, light_illum=self.light_illum * scale)


@_register
@dataclass
class Camera:
    """Pinhole camera basis: eye + upper-left corner + per-pixel steps.

    Matches ``init_camera`` (main_cli.cpp:25-40): ray through pixel (x, y) is
    ``normalize(UL + dx*(x+jit) + dy*(y+jit) - eye)``.
    """

    eye: jnp.ndarray
    ul: jnp.ndarray
    dx: jnp.ndarray
    dy: jnp.ndarray


# triangles per cluster leaf: a fixed size, not tuned for any device
CLUSTER_LEAF_SIZE = 64


def scene_from_numpy(
    sph_center, sph_radius, sph_mtl, tri_v0, tri_v1, tri_v2, tri_mtl,
    light_pos, light_dir, light_illum, light_cutoff, light_is_parallel,
    light_ball_r, cluster_leaf_size: int | None = None,
    tri_uv=None, tri_tex=None, tex_atlas=None, tex_size=None,
    sph_legacy=None, tri_legacy=None,
) -> Scene:
    """Build a device Scene from host numpy arrays, computing the scene AABB
    the way the marshalling helpers do (bdpt_cu_helper.cpp:29-53): union of
    sphere bounds and triangle vertices (light balls excluded).

    Triangles are reordered into spatial clusters (ops/bvh.py) once a scene
    has more than ``cluster_leaf_size`` of them; tie-breaking between
    exactly coincident triangles may then differ from file order."""
    f32 = np.float32
    sph_center = np.asarray(sph_center, f32).reshape(-1, 3)
    sph_radius = np.asarray(sph_radius, f32).reshape(-1)
    tri_v0 = np.asarray(tri_v0, f32).reshape(-1, 3)
    tri_v1 = np.asarray(tri_v1, f32).reshape(-1, 3)
    tri_v2 = np.asarray(tri_v2, f32).reshape(-1, 3)

    # cluster + reorder triangles (single whole-scene cluster for tiny sets)
    nt_total = tri_v0.shape[0]
    if cluster_leaf_size is None:
        cluster_leaf_size = CLUSTER_LEAF_SIZE
    tri_uv = (np.asarray(tri_uv, f32).reshape(-1, 6) if tri_uv is not None
              else np.zeros((nt_total, 6), f32))
    tri_tex = (np.asarray(tri_tex, np.int32).reshape(-1)
               if tri_tex is not None
               else np.full((nt_total,), -1, np.int32))
    # legacy Ks/refract rows (ks3, refract): carried only when some object
    # actually refracts — all-zero tables are the reference's reachable state
    # and must keep has_legacy_ks False (binary blocking, quirk 12)
    sph_legacy = (np.asarray(sph_legacy, f32).reshape(-1, 4)
                  if sph_legacy is not None else np.zeros((0, 4), f32))
    tri_legacy = (np.asarray(tri_legacy, f32).reshape(-1, 4)
                  if tri_legacy is not None else np.zeros((0, 4), f32))
    if not (sph_legacy[:, 3] > 0).any() and not (tri_legacy[:, 3] > 0).any():
        sph_legacy = np.zeros((0, 4), f32)
        tri_legacy = np.zeros((0, 4), f32)
    elif tri_legacy.shape[0] != nt_total or sph_legacy.shape[0] != \
            sph_center.shape[0]:
        raise ValueError("legacy material rows must match object counts")
    if nt_total > cluster_leaf_size:
        from ..ops.bvh import build_clusters

        tris9 = np.concatenate([tri_v0, tri_v1, tri_v2], axis=1)
        order, cl_aabb, cl_range = build_clusters(tris9, cluster_leaf_size)
        tri_v0, tri_v1, tri_v2 = tri_v0[order], tri_v1[order], tri_v2[order]
        tri_mtl = tri_mtl.gather(jnp.asarray(order))
        tri_uv, tri_tex = tri_uv[order], tri_tex[order]
        if tri_legacy.shape[0]:
            tri_legacy = tri_legacy[order]
    else:
        if nt_total:
            verts_all = np.concatenate([tri_v0, tri_v1, tri_v2], axis=0)
            cl_aabb = np.concatenate(
                [verts_all.min(axis=0), verts_all.max(axis=0)])[None, :]
        else:
            cl_aabb = np.array([[1e9, 1e9, 1e9, -1e9, -1e9, -1e9]], f32)
        cl_range = np.array([[0, nt_total]], np.int32)

    mins, maxs = [], []
    if sph_center.shape[0]:
        mins.append((sph_center - sph_radius[:, None]).min(axis=0))
        maxs.append((sph_center + sph_radius[:, None]).max(axis=0))
    if tri_v0.shape[0]:
        verts = np.concatenate([tri_v0, tri_v1, tri_v2], axis=0)
        mins.append(verts.min(axis=0))
        maxs.append(verts.max(axis=0))
    if mins:
        scene_min = np.minimum.reduce(mins)
        scene_max = np.maximum.reduce(maxs)
    else:  # matches the helpers' +-1e9 init when the scene is empty
        scene_min = np.full(3, 1e9, f32)
        scene_max = np.full(3, -1e9, f32)

    return Scene(
        sph_center=jnp.asarray(sph_center),
        sph_radius=jnp.asarray(sph_radius),
        sph_mtl=sph_mtl,
        tri_v0=jnp.asarray(tri_v0),
        tri_v1=jnp.asarray(tri_v1),
        tri_v2=jnp.asarray(tri_v2),
        tri_mtl=tri_mtl,
        light_pos=jnp.asarray(np.asarray(light_pos, f32).reshape(-1, 3)),
        light_dir=jnp.asarray(np.asarray(light_dir, f32).reshape(-1, 3)),
        light_illum=jnp.asarray(np.asarray(light_illum, f32).reshape(-1, 3)),
        light_cutoff=jnp.asarray(np.asarray(light_cutoff, f32).reshape(-1)),
        light_is_parallel=jnp.asarray(
            np.asarray(light_is_parallel, np.int32).reshape(-1)),
        light_ball_r=jnp.asarray(np.asarray(light_ball_r, f32).reshape(-1)),
        scene_min=jnp.asarray(scene_min),
        scene_max=jnp.asarray(scene_max),
        tri_cluster_aabb=jnp.asarray(np.asarray(cl_aabb, f32).reshape(-1, 6)),
        tri_cluster_range=jnp.asarray(
            np.asarray(cl_range, np.int32).reshape(-1, 2)),
        tri_uv=jnp.asarray(tri_uv),
        tri_tex=jnp.asarray(tri_tex),
        tex_atlas=jnp.asarray(
            np.asarray(tex_atlas, f32).reshape(-1, *np.shape(tex_atlas)[1:])
            if tex_atlas is not None and np.size(tex_atlas)
            else np.zeros((0, 1, 1, 3), f32)),
        tex_size=jnp.asarray(
            np.asarray(tex_size, np.int32).reshape(-1, 2)
            if tex_size is not None and np.size(tex_size)
            else np.zeros((0, 2), np.int32)),
        sph_ks=jnp.asarray(sph_legacy[:, 0:3]),
        sph_refract=jnp.asarray(sph_legacy[:, 3]),
        tri_ks=jnp.asarray(tri_legacy[:, 0:3]),
        tri_refract=jnp.asarray(tri_legacy[:, 3]),
    )
