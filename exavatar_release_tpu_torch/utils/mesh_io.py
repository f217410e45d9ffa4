"""Mesh file IO: PLY (binary/ascii) and OBJ with UVs (counterpart of
exavatar_release_tpu/utils/mesh_io.py, numpy only, kept as the port's own
copy).

Replaces the reference's pytorch3d.io usage (save_ply/load_ply/load_obj/
save_obj; e.g. smplx_uv.obj loading at reference
fitting/common/utils/smpl_x.py:105-110 and point-cloud export at
avatar/main/get_neutral_pose.py). Host-side numpy.
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np


class ObjMesh(NamedTuple):
    verts: np.ndarray  # (V, 3)
    faces: np.ndarray  # (F, 3) vertex indices
    vertex_uv: Optional[np.ndarray]  # (Vt, 2) or None
    face_uv: Optional[np.ndarray]  # (F, 3) indices into vertex_uv or None


def save_ply(path: str, verts: np.ndarray, faces: Optional[np.ndarray] = None,
             colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY; colors in [0,1] stored as uchar."""
    verts = np.asarray(verts, np.float32)
    n = verts.shape[0]
    has_c = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    nf = 0 if faces is None else len(faces)
    if faces is not None:
        header += [f"element face {nf}", "property list uchar int vertex_indices"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_c:
            c8 = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            for i in range(n):
                f.write(struct.pack("<fff", *verts[i]) + c8[i].tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        if faces is not None:
            fa = np.asarray(faces, np.int32)
            for tri in fa:
                f.write(struct.pack("<B", 3) + tri.astype("<i4").tobytes())


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load (verts, faces|None); handles the binary/ascii files save_ply and
    common tools emit (xyz + optional uchar rgb, uchar-int face lists)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode()
    body = data[head_end:]
    n_vert = n_face = 0
    vert_props = []
    binary = "binary_little_endian" in header
    element = None
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            element = parts[1]
            if element == "vertex":
                n_vert = int(parts[2])
            elif element == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and element == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    if binary:
        dt = np.dtype([(name, type_map[t]) for name, t in vert_props])
        vtable = np.frombuffer(body[: dt.itemsize * n_vert], dtype=dt)
        verts = np.stack(
            [vtable["x"], vtable["y"], vtable["z"]], axis=1
        ).astype(np.float32)
        off = dt.itemsize * n_vert
        faces = None
        if n_face:
            faces = np.empty((n_face, 3), np.int32)
            for i in range(n_face):
                cnt = body[off]
                off += 1
                faces[i] = np.frombuffer(body[off : off + 12], "<i4")
                off += 4 * cnt
        return verts, faces
    # ascii
    lines = body.decode().split("\n")
    vrows = [list(map(float, l.split())) for l in lines[:n_vert]]
    verts = np.asarray([r[:3] for r in vrows], np.float32)
    faces = None
    if n_face:
        faces = np.asarray(
            [list(map(int, l.split()))[1:4] for l in lines[n_vert : n_vert + n_face]],
            np.int32,
        )
    return verts, faces


def load_obj(path: str) -> ObjMesh:
    """OBJ with v / vt / f (v, v/vt, v/vt/vn forms), 0-based output."""
    verts, uvs, faces, face_uv = [], [], [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "vt":
                uvs.append([float(p[1]), float(p[2])])
            elif p[0] == "f":
                vi, ti = [], []
                for tok in p[1:4]:
                    comp = tok.split("/")
                    vi.append(int(comp[0]) - 1)
                    if len(comp) > 1 and comp[1]:
                        ti.append(int(comp[1]) - 1)
                faces.append(vi)
                if len(ti) == 3:
                    face_uv.append(ti)
    return ObjMesh(
        verts=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        vertex_uv=np.asarray(uvs, np.float32) if uvs else None,
        face_uv=np.asarray(face_uv, np.int32) if face_uv else None,
    )


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             vertex_uv: Optional[np.ndarray] = None,
             face_uv: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if vertex_uv is not None:
            for t in np.asarray(vertex_uv):
                f.write(f"vt {t[0]} {t[1]}\n")
        for i, tri in enumerate(np.asarray(faces)):
            if face_uv is not None:
                tuv = np.asarray(face_uv)[i]
                f.write(
                    f"f {tri[0]+1}/{tuv[0]+1} {tri[1]+1}/{tuv[1]+1} "
                    f"{tri[2]+1}/{tuv[2]+1}\n"
                )
            else:
                f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
