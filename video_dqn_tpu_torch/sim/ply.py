"""Triangle-mesh scene files (counterpart of video_dqn_tpu/sim/ply.py): PLY
(ascii and binary_little_endian) read and write, a small OBJ reader, and
binary glTF 2.0 (GLB) read and write, in numpy and struct only.

Gibson scenes ship as .glb (with .obj and .ply variants); the mesh
simulator (sim/mesh_env.py) consumes bare geometry: positions, triangular
faces and optional per-vertex RGB. Every other property, texture and
material is skipped, and what the readers cannot read raises.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None, binary: bool = True) -> None:
    """vertices (N,3) float; faces (M,3) int; colors optional (N,3) uint8."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n, m = len(vertices), len(faces)
    has_c = colors is not None
    if has_c:
        colors = np.asarray(colors, np.uint8)
        assert colors.shape == (n, 3)
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = [
        "ply",
        f"format {fmt}",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if has_c:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header += [
        f"element face {m}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_c:
                for i in range(n):
                    f.write(struct.pack("<fff", *vertices[i]))
                    f.write(struct.pack("<BBB", *colors[i]))
            else:
                f.write(vertices.astype("<f4").tobytes())
            for i in range(m):
                f.write(struct.pack("<Biii", 3, *faces[i]))
        else:
            for i in range(n):
                row = f"{vertices[i,0]} {vertices[i,1]} {vertices[i,2]}"
                if has_c:
                    row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
                f.write((row + "\n").encode())
            for i in range(m):
                f.write(f"3 {faces[i,0]} {faces[i,1]} {faces[i,2]}\n".encode())


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Returns (vertices (N,3) float32, faces (M,3) int32, colors or None).
    Quad faces are triangulated with a fan."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    assert end >= 0, "not a PLY file"
    header = data[:end].decode("ascii", "replace").split("\n")
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    verts = faces = colors = None
    if fmt == "ascii":
        tokens = body.decode("ascii", "replace").split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                names = [p[0] for p in props]
                rows = np.array(
                    tokens[ti:ti + count * len(props)], np.float64
                ).reshape(count, len(props))
                ti += count * len(props)
                verts, colors = _extract_vertex(rows, names)
            elif name == "face":
                fl = []
                for _ in range(count):
                    k = int(tokens[ti]); ti += 1
                    idx = [int(tokens[ti + j]) for j in range(k)]; ti += k
                    for j in range(1, k - 1):
                        fl.append((idx[0], idx[j], idx[j + 1]))
                faces = np.asarray(fl, np.int32)
            else:
                if any(p[2] is not None for p in props):
                    raise ValueError(
                        f"cannot skip unknown PLY element {name!r} with "
                        "list properties (variable-size rows)"
                    )
                ti += count * len(props)
    else:
        little = "little" in fmt
        assert little, "big-endian PLY unsupported"
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                names = [p[0] for p in props]
                fmts = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                sz = struct.calcsize(fmts)
                rows = np.array(
                    [struct.unpack_from(fmts, body, off + i * sz)
                     for i in range(count)], np.float64)
                off += count * sz
                verts, colors = _extract_vertex(rows, names)
            elif name == "face":
                fl = []
                (lname, ltype, ctype) = props[0]
                cfmt, csz = _PLY_TYPES[ctype]
                ifmt, isz = _PLY_TYPES[ltype]
                for _ in range(count):
                    k = struct.unpack_from("<" + cfmt, body, off)[0]
                    off += csz
                    idx = struct.unpack_from(f"<{k}{ifmt}", body, off)
                    off += k * isz
                    for j in range(1, k - 1):
                        fl.append((idx[0], idx[j], idx[j + 1]))
                faces = np.asarray(fl, np.int32)
            else:  # skip fixed-size unknown elements
                if any(p[2] is not None for p in props):
                    raise ValueError(
                        f"cannot skip unknown PLY element {name!r} with "
                        "list properties (variable-size rows)"
                    )
                sz = sum(_PLY_TYPES[p[1]][1] for p in props)
                off += count * sz
    assert verts is not None and faces is not None
    return verts, faces, colors


def _extract_vertex(rows: np.ndarray, names):
    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
    verts = rows[:, [xi, yi, zi]].astype(np.float32)
    colors = None
    if "red" in names:
        ri = names.index("red")
        colors = rows[:, [ri, names.index("green"), names.index("blue")]]
        colors = np.clip(colors, 0, 255).astype(np.uint8)
    return verts, colors


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray, None]:
    """Tiny OBJ reader: v / f lines only; polygon faces fan-triangulated;
    1-based (and negative) indices handled. Returns (verts, faces, None)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for j in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[j], idx[j + 1]))
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32), None)


def _glb_chunks(data: bytes):
    magic, version, _length = struct.unpack_from("<4sII", data, 0)
    assert magic == b"glTF", "not a GLB file"
    assert version == 2, f"unsupported glTF version {version}"
    off = 12
    chunks = {}
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<I4s", data, off)
        chunks[ctype.rstrip(b"\x00")] = data[off + 8:off + 8 + clen]
        off += 8 + clen + ((-clen) % 4 if ctype == b"JSON" else 0)
        # binary chunks are already 4-aligned by spec; JSON is space-padded
    return chunks


_GLTF_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_GLTF_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def read_glb(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Minimal binary-glTF 2.0 reader: walks every scene node (matrix or
    TRS transforms applied), gathers triangle primitives' POSITION +
    indices (+ COLOR_0 when present). Textures/materials are ignored —
    the raycaster consumes bare geometry. This is the format Gibson
    scenes ship in."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = _glb_chunks(data)
    doc = json.loads(chunks[b"JSON"])
    bin_chunk = chunks.get(b"BIN", b"")

    def accessor(idx):
        acc = doc["accessors"][idx]
        if "sparse" in acc:
            # silently reading the base buffer would return wrong geometry
            raise NotImplementedError(
                "glTF sparse accessors are not supported")
        view = doc["bufferViews"][acc["bufferView"]]
        dtype = _GLTF_DTYPES[acc["componentType"]]
        ncomp = _GLTF_SIZES[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        elem = dtype().itemsize * ncomp
        stride = view.get("byteStride") or elem
        count = acc["count"]
        if stride == elem:  # tightly packed
            flat = np.frombuffer(bin_chunk, dtype, count * ncomp, start)
            return flat.reshape(count, ncomp)
        # interleaved: gather each element's bytes (last element may not
        # extend a full stride, so slice exactly to its end)
        raw = np.frombuffer(
            bin_chunk[start:start + stride * (count - 1) + elem], np.uint8
        )
        gather = np.arange(count)[:, None] * stride + np.arange(elem)[None, :]
        return raw[gather].copy().view(dtype).reshape(count, ncomp)

    def node_matrix(node):
        if "matrix" in node:
            return np.array(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m[:3, :3] *= np.array(node["scale"])[None, :]
        if "rotation" in node:  # xyzw quaternion
            x, y, z, w = node["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            m[:3, :3] = r @ m[:3, :3]
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m

    verts_all, faces_all, colors_all = [], [], []
    have_color = True
    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
    stack = [(n, np.eye(4)) for n in scene.get("nodes", [])]
    while stack:
        ni, parent = stack.pop()
        node = doc["nodes"][ni]
        m = parent @ node_matrix(node)
        for child in node.get("children", []):
            stack.append((child, m))
        if "mesh" not in node:
            continue
        mesh = doc["meshes"][node["mesh"]]
        for prim in mesh["primitives"]:
            if "KHR_draco_mesh_compression" in prim.get("extensions", {}):
                raise NotImplementedError(
                    "Draco-compressed GLB is not supported; decompress the "
                    "scene first (e.g. gltf-transform decompress)")
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            pos = accessor(prim["attributes"]["POSITION"]).astype(np.float64)
            pos = pos @ m[:3, :3].T + m[:3, 3]
            if "indices" in prim:
                idx = accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            base = sum(len(v) for v in verts_all)
            verts_all.append(pos.astype(np.float32))
            faces_all.append((idx.reshape(-1, 3) + base).astype(np.int32))
            if "COLOR_0" in prim["attributes"]:
                col = accessor(prim["attributes"]["COLOR_0"])[:, :3]
                if col.dtype != np.uint8:
                    col = np.clip(
                        col.astype(np.float64)
                        / (65535.0 if col.dtype == np.uint16 else 1.0),
                        0, 1,
                    ) * 255.0
                colors_all.append(col.astype(np.uint8))
            else:
                have_color = False
    assert verts_all, "GLB contains no triangle geometry"
    verts = np.concatenate(verts_all)
    faces = np.concatenate(faces_all)
    colors = np.concatenate(colors_all) if (have_color and colors_all) else None
    return verts, faces, colors


def write_glb(path: str, vertices: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Minimal single-mesh GLB writer (POSITION + uint32 indices +
    optional normalized-uint8 COLOR_0), for fixtures and export."""
    vertices = np.asarray(vertices, np.float32)
    idx = np.asarray(faces, np.uint32).reshape(-1)
    blobs = [vertices.tobytes(), idx.tobytes()]
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": len(blobs[0])},
        {"buffer": 0, "byteOffset": len(blobs[0]), "byteLength": len(blobs[1])},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(vertices),
         "type": "VEC3",
         "min": vertices.min(axis=0).tolist(),
         "max": vertices.max(axis=0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": len(idx),
         "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if colors is not None:
        c4 = np.concatenate(
            [np.asarray(colors, np.uint8),
             np.full((len(colors), 1), 255, np.uint8)], axis=1)
        off = sum(len(b) for b in blobs)
        blobs.append(c4.tobytes())
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(blobs[-1])})
        accessors.append({"bufferView": 2, "componentType": 5121,
                          "count": len(colors), "type": "VEC4",
                          "normalized": True})
        attributes["COLOR_0"] = 2
    bin_blob = b"".join(blobs)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [
            {"attributes": attributes, "indices": 1, "mode": 4}
        ]}],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(js), b"JSON"))
        f.write(js)
        f.write(struct.pack("<I4s", len(bin_blob), b"BIN\x00"))
        f.write(bin_blob)


def load_mesh(path: str):
    """Dispatch on extension. Returns (verts, faces, colors_or_None)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        return read_obj(path)
    if lower.endswith(".glb") or lower.endswith(".gltf"):
        return read_glb(path)
    return read_ply(path)
