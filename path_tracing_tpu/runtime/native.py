"""ctypes bindings to the native C++ host runtime (csrc/pt_runtime.cc).

The compute path is JAX/XLA; the host runtime around it (parsers, geometry
flattening, the BVH/cluster builder) is native C++, mirroring the
reference's C++ host layers (SURVEY.md L1/L2/L4).  Pure-Python fallbacks in
scene/parser.py, scene/obj_loader.py and ops/bvh.py implement the identical
behavior and are cross-tested against this library.

Build: ``make -C csrc`` writes ``build/libpt_runtime.so`` (git-ignored).  The
first use builds it when it is missing or older than its source; when that
fails (no compiler) ``native_available()`` is False and the Python parsers
run instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "csrc")
_SRC = os.path.join(_CSRC, "pt_runtime.cc")
_SO = os.path.join(_ROOT, "build", "libpt_runtime.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        try:
            subprocess.run(["make", "-C", _CSRC], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            if not os.path.exists(_SO):
                return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.pt_parse_scene_file.restype = ctypes.c_void_p
    lib.pt_parse_scene_file.argtypes = [ctypes.c_char_p]
    lib.pt_parse_obj_file.restype = ctypes.c_void_p
    lib.pt_parse_obj_file.argtypes = [ctypes.c_char_p]
    lib.pt_scene_free.argtypes = [ctypes.c_void_p]
    for f in ("pt_num_spheres", "pt_num_triangles", "pt_num_lights"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for f in ("pt_get_spheres", "pt_get_triangles", "pt_get_lights",
              "pt_get_camera"):
        getattr(lib, f).argtypes = [ctypes.c_void_p, fp]
    lib.pt_get_groups.argtypes = [ctypes.c_void_p, ip, ip]
    try:  # added with the 'K' legacy-material record; stale .so lacks it
        lib.pt_get_legacy.argtypes = [ctypes.c_void_p, fp, fp]
    except AttributeError:
        pass
    try:  # added with OBJ vt/map_Kd support (round 5); stale .so lacks them
        lib.pt_get_tri_uv.argtypes = [ctypes.c_void_p, fp]
        lib.pt_get_tri_tex.argtypes = [ctypes.c_void_p, ip]
        lib.pt_num_textures.restype = ctypes.c_int
        lib.pt_num_textures.argtypes = [ctypes.c_void_p]
        lib.pt_get_texture_path.restype = ctypes.c_int
        lib.pt_get_texture_path.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_char_p, ctypes.c_int]
    except AttributeError:
        pass
    lib.pt_build_clusters.restype = ctypes.c_int
    lib.pt_build_clusters.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                      ip, fp, ip, ctypes.c_int]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def parse_scene_native(path: str):
    """Parse a text scene (or .obj) with the C++ runtime.

    Returns a ParsedScene or None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    is_obj = path.lower().endswith(".obj")
    fn = lib.pt_parse_obj_file if is_obj else lib.pt_parse_scene_file
    h = fn(path.encode())
    if not h:
        return None
    try:
        ns = lib.pt_num_spheres(h)
        nt = lib.pt_num_triangles(h)
        nl = lib.pt_num_lights(h)
        sph = np.zeros((max(ns, 1), 10), np.float32)
        tri = np.zeros((max(nt, 1), 15), np.float32)
        lig = np.zeros((max(nl, 1), 12), np.float32)
        cam = np.zeros(12, np.float32)
        sg = np.zeros(max(ns, 1), np.int32)
        tg = np.zeros(max(nt, 1), np.int32)
        if ns:
            lib.pt_get_spheres(h, sph.reshape(-1))
        if nt:
            lib.pt_get_triangles(h, tri.reshape(-1))
        if nl:
            lib.pt_get_lights(h, lig.reshape(-1))
        lib.pt_get_camera(h, cam)
        lib.pt_get_groups(h, sg, tg)
        sleg = np.zeros((max(ns, 1), 4), np.float32)
        tleg = np.zeros((max(nt, 1), 4), np.float32)
        if hasattr(lib, "pt_get_legacy"):
            lib.pt_get_legacy(h, sleg.reshape(-1), tleg.reshape(-1))
        uv = tex = tex_paths = None
        if is_obj and nt:
            if not hasattr(lib, "pt_get_tri_uv"):
                # stale .so predating the texture exports: returning an
                # untextured parse would silently drop map_Kd — let the
                # caller fall back to the Python loader (review r5)
                return None
            uv = np.zeros((nt, 6), np.float32)
            tex = np.zeros(nt, np.int32)
            lib.pt_get_tri_uv(h, uv.reshape(-1))
            lib.pt_get_tri_tex(h, tex)
            tex_paths = []
            for i in range(lib.pt_num_textures(h)):
                tex_paths.append(_texture_path(lib, h, i))
    finally:
        lib.pt_scene_free(h)

    from ..scene.parser import ParsedScene

    out = ParsedScene()
    out.eye, out.look_at, out.view_up = cam[0:3], cam[3:6], cam[6:9]
    out.fov = float(cam[9])
    out.width, out.height = int(cam[10]), int(cam[11])
    for i in range(ns):
        out.sph_center.append(sph[i, 0:3].tolist())
        out.sph_radius.append(float(sph[i, 3]))
        out.sph_mtl.append(sph[i, 4:10].tolist())
        out.sph_legacy.append(sleg[i].tolist())
        out.sph_group.append(int(sg[i]))
    # triangles: vectorized ndarray fields (ParsedScene.to_device accepts
    # either; the per-row Python loop was O(seconds) at 300k-tri meshes)
    out.tri_verts = tri[:nt, 0:9].reshape(nt, 3, 3)
    out.tri_mtl = tri[:nt, 9:15]
    out.tri_legacy = tleg[:nt]
    out.tri_group = tg[:nt]
    out.lights = [lig[i].tolist() for i in range(nl)]

    if uv is not None:
        # decode the referenced images (first-use order, like
        # obj_loader.tex_of) and remap ids: failed decodes become -1 and
        # do not consume an output slot, so ids match the Python loader's.
        # Dedup by NORMPATH here (the C++ side keys on the literal joined
        # string; 'tex.png' vs './tex.png' must share one slot like the
        # Python loader — review r5).
        from ..scene.obj_loader import _decode_texture

        id_map = np.full(max(len(tex_paths), 1) + 1, -1, np.int32)
        by_path: dict = {}
        for i, p in enumerate(tex_paths):
            if p is None:
                continue
            if p in by_path:
                id_map[i] = by_path[p]
                continue
            img = _decode_texture(p)
            slot = -1 if img is None else len(out.textures)
            if img is not None:
                out.textures.append(img)
            by_path[p] = slot
            id_map[i] = slot
        out.tri_uv = uv
        out.tri_tex = id_map[tex]  # tex == -1 hits the sentinel last row
    return out


def _texture_path(lib, h, i: int, cap: int = 4096) -> Optional[str]:
    """Texture path ``i`` of a parsed scene; the C++ side returns the
    capacity it needs when ``cap`` is too small, and the call is retried at
    that size.  None for a bad index."""
    buf = ctypes.create_string_buffer(cap)
    rc = lib.pt_get_texture_path(h, i, buf, cap)
    if rc > 0:
        buf = ctypes.create_string_buffer(rc)
        rc = lib.pt_get_texture_path(h, i, buf, rc)
    if rc != 0:
        return None
    return os.path.normpath(buf.value.decode())


def build_clusters_native(tris9: np.ndarray, leaf_size: int = 16):
    """Median-split clusters via the C++ builder.

    tris9: (N, 9) float32 triangle vertices.
    Returns (order (N,), aabbs (M, 6), ranges (M, 2)) or None.
    """
    lib = _load()
    if lib is None:
        return None
    tris9 = np.ascontiguousarray(tris9, np.float32).reshape(-1, 9)
    n = tris9.shape[0]
    max_clusters = max(4, 2 * (n // max(leaf_size, 1) + 2))
    order = np.zeros(n, np.int32)
    aabbs = np.zeros((max_clusters, 6), np.float32)
    ranges = np.zeros((max_clusters, 2), np.int32)
    m = lib.pt_build_clusters(tris9.reshape(-1), n, leaf_size, order,
                              aabbs.reshape(-1), ranges.reshape(-1),
                              max_clusters)
    if m < 0:
        return None
    return order, aabbs[:m], ranges[:m]
