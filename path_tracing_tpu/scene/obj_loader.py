"""Wavefront OBJ/MTL loader (tinyobj-compatible subset).

The reference vendors tiny_obj_loader.h (9,267 lines) but never calls it
(SURVEY.md component #27) — mesh scenes are a latent capability.  Here it is
active: OBJ geometry feeds the same triangle SoA as the text format, so every
integrator renders meshes unchanged (BASELINE config 3).

Supported subset (the part of tinyobj the reference could have used):
- ``v`` positions, ``vn`` normals (parsed; shading uses geometric normals
  like the reference's Triangle::normal_at) and ``vt`` texcoords
  (interpolated for ``map_Kd`` sampling, ops/texture.py),
- ``f`` faces with ``v``, ``v/vt``, ``v//vn``, ``v/vt/vn`` forms, negative
  (relative) indices, and polygon fan triangulation,
- ``o``/``g`` object/group names (mapped to group ids like the text format's
  ``G`` records), ``s`` ignored,
- ``mtllib`` / ``usemtl`` with MTL fields ``Kd`` (base color), ``Ns``
  (shininess -> roughness = sqrt(2/(Ns+2)), the Blinn-Phong moment match),
  ``Ni`` (IOR), ``d``/``Tr`` (dissolve: d < 1 marks a dielectric -> eta=Ni),
  ``illum`` (3/5 -> mirror-like metallic=1.0, roughness~0),
  ``Pm``/``Pr`` (PBR metallic/roughness extensions, take precedence),
  ``map_Kd`` (diffuse texture, decoded via PIL or the built-in PNG reader
  and modulated onto base_color at hit time — BASELINE config 3's
  "textured OBJ mesh").

A C++ implementation of the same grammar lives in csrc/ (see
runtime/native.py); this module is the always-available fallback and the
behavioral spec both are tested against.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .parser import ParsedScene


@dataclass
class MtlDef:
    kd: tuple = (0.8, 0.8, 0.8)
    ns: float = 10.0
    ni: float = 0.0
    d: float = 1.0
    illum: int = 2
    pm: float | None = None  # PBR metallic
    pr: float | None = None  # PBR roughness
    map_kd: str | None = None  # diffuse texture filename (relative to MTL)

    def to_material_row(self) -> List[float]:
        """-> [r, g, b, roughness, metallic, eta] (our Material layout)."""
        if self.pr is not None:
            rough = self.pr
        else:
            rough = math.sqrt(2.0 / (self.ns + 2.0))
        if self.pm is not None:
            metal = self.pm
        elif self.illum in (3, 5):
            metal, rough = 1.0, min(rough, 0.05)
        else:
            metal = 0.0
        eta = self.ni if (self.d < 1.0 or self.illum in (4, 6, 7, 9)) else 0.0
        return [*self.kd, rough, metal, eta]


def _parse_mtl(path: str) -> Dict[str, MtlDef]:
    mtls: Dict[str, MtlDef] = {}
    cur: MtlDef | None = None
    if not os.path.exists(path):
        return mtls
    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            key = tok[0].lower()
            try:
                if key == "newmtl":
                    cur = MtlDef()
                    mtls[tok[1]] = cur
                elif cur is None:
                    continue
                elif key == "kd":
                    cur.kd = tuple(float(x) for x in tok[1:4])
                elif key == "ns":
                    cur.ns = float(tok[1])
                elif key == "ni":
                    cur.ni = float(tok[1])
                elif key == "d":
                    cur.d = float(tok[1])
                elif key == "tr":
                    cur.d = 1.0 - float(tok[1])
                elif key == "illum":
                    cur.illum = int(float(tok[1]))
                elif key == "pm":
                    cur.pm = float(tok[1])
                elif key == "pr":
                    cur.pr = float(tok[1])
                elif key == "map_kd":
                    cur.map_kd = tok[-1]  # options (-o, -s ...) precede it
            except (ValueError, IndexError):
                continue  # tolerant like the text parser
    return mtls


def _decode_texture(path: str) -> "np.ndarray | None":
    """Image file -> (H, W, 3) float32 LINEAR RGB in [0, 1].  Pillow decodes
    any format when it is installed; without it PNG files use the built-in
    reader and other formats raise ImportError.  None (flat color fallback)
    when the file is missing or cannot be decoded.  Texel bytes are
    gamma-encoded (sRGB-ish); decode with the same 2.2 power the film
    module uses on output so texture energy is linear in the radiance
    math (not double-gamma'd)."""
    if not os.path.isfile(path):
        return None
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None:
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise ImportError(
                    f"texture {path}: only PNG textures load without "
                    f"Pillow; install Pillow for other image formats")
    try:
        if Image is not None:
            raw = np.asarray(Image.open(path).convert("RGB"), np.float32)
        else:
            from ..film import read_png

            raw = np.asarray(read_png(path), np.float32)
    except Exception:  # noqa: BLE001 — a corrupt texture falls back to flat
        return None
    return (raw / 255.0) ** 2.2


def load_obj(path: str, default_mtl: List[float] | None = None) -> ParsedScene:
    """Parse an OBJ file into a ParsedScene (triangles only; cameras/lights
    come from CLI flags or a companion text scene)."""
    out = ParsedScene()
    verts: List[List[float]] = []
    texcoords: List[List[float]] = []
    mtls: Dict[str, MtlDef] = {}
    cur_mtl = list(default_mtl or [0.8, 0.8, 0.8, 0.5, 0.0, 0.0])
    cur_tex = -1
    tex_ids: Dict[str, int] = {}  # resolved path -> index into out.textures
    group_id = 0
    next_group = 0
    base = os.path.dirname(os.path.abspath(path))

    def vidx(tok: str) -> int:
        i = int(tok.split("/")[0])
        return i - 1 if i > 0 else len(verts) + i

    def tidx(tok: str) -> int:
        """vt index of a face token, or -1 when absent (v or v//vn forms)."""
        parts = tok.split("/")
        if len(parts) < 2 or not parts[1]:
            return -1
        i = int(parts[1])
        return i - 1 if i > 0 else len(texcoords) + i

    def tex_of(m: MtlDef) -> int:
        if not m.map_kd:
            return -1
        p = os.path.normpath(os.path.join(base, m.map_kd))
        if p not in tex_ids:
            img = _decode_texture(p)
            tex_ids[p] = -1 if img is None else len(out.textures)
            if img is not None:
                out.textures.append(img)
        return tex_ids[p]

    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            key = tok[0]
            try:
                if key == "v":
                    verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
                elif key == "vt":
                    texcoords.append([float(tok[1]),
                                      float(tok[2]) if len(tok) > 2 else 0.0])
                elif key == "mtllib":
                    mtls.update(_parse_mtl(os.path.join(base, tok[1])))
                elif key == "usemtl":
                    if tok[1] in mtls:
                        cur_mtl = mtls[tok[1]].to_material_row()
                        cur_tex = tex_of(mtls[tok[1]])
                elif key in ("o", "g"):
                    next_group += 1
                    group_id = next_group
                elif key == "f":
                    idx = [vidx(t) for t in tok[1:]]
                    uvi = [tidx(t) for t in tok[1:]]
                    for k in range(1, len(idx) - 1):  # fan triangulation
                        out.tri_verts.append(
                            [verts[idx[0]], verts[idx[k]], verts[idx[k + 1]]])
                        out.tri_mtl.append(list(cur_mtl))
                        out.tri_group.append(group_id)
                        corners = (uvi[0], uvi[k], uvi[k + 1])
                        in_range = all(0 <= c < len(texcoords)
                                       for c in corners)
                        uv = []
                        for c in corners:
                            uv.extend(texcoords[c] if in_range else [0.0, 0.0])
                        out.tri_uv.append(uv)
                        out.tri_tex.append(cur_tex if in_range else -1)
            except (ValueError, IndexError):
                continue
    return out


def load_any_scene(path: str) -> ParsedScene:
    """Dispatch text-scene vs OBJ by extension; OBJ scenes get a default
    camera framing the mesh bounds and one overhead spot light unless a
    companion ``<name>.lights.txt`` text scene provides E/V/F/R/L records.

    Parsing runs on the native C++ runtime (csrc/pt_runtime.cc, incl.
    vt/map_Kd textures) when the library is available — the production
    path, like the reference's C++ host layers (main_cli.cpp:99-141) —
    with this module as the behavioral spec and always-available fallback.
    ``PT_NO_NATIVE=1`` forces the Python parsers (A/B + tests)."""
    native_out = None
    if not os.environ.get("PT_NO_NATIVE"):
        from ..runtime.native import parse_scene_native

        native_out = parse_scene_native(path)

    if not path.lower().endswith(".obj"):
        if native_out is not None:
            return native_out
        from .parser import load_scene

        return load_scene(path)

    out = native_out if native_out is not None else load_obj(path)
    companion = os.path.splitext(path)[0] + ".lights.txt"
    if os.path.exists(companion):
        from .parser import load_scene

        comp = load_scene(companion)
        out.eye, out.look_at, out.view_up = comp.eye, comp.look_at, comp.view_up
        out.fov, out.width, out.height = comp.fov, comp.width, comp.height
        out.lights = comp.lights
        return out

    return default_framing(out)


def default_framing(out: ParsedScene) -> ParsedScene:
    """Default camera + overhead spot for scenes without E/V/F/R/L records:
    look at the bbox center from outside along -z (shared by bare OBJ
    loads and the synthetic benchmark scenes, scene/synth.py)."""
    v = np.asarray([p for tri in out.tri_verts for p in tri], np.float32)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    out.eye = (center + np.array([0, 0.25 * diag, -1.2 * diag],
                                 np.float32)).astype(np.float32)
    out.look_at = center.astype(np.float32)
    out.view_up = np.array([0, 1, 0], np.float32)
    out.fov = 50.0
    out.width = out.width or 512
    out.height = out.height or 512
    out.lights = [[*(center + np.array([0, 0.9 * diag, 0])), 0, -1, 0,
                   20.0 * diag, 20.0 * diag, 20.0 * diag,
                   math.radians(180.0), 0, 0.05 * diag]]
    return out
