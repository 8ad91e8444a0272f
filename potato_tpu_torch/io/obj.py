"""Wavefront OBJ mesh loader -> the port's MeshData (numpy SoA).

- parses `v`, `vn`, `vt`, `f` lines; silently skips anything else;
- face indices are 1-based `v`, `v/vt`, `v//vn`, `v/vt/vn`;
- identical (position, texcoord, normal) index triples are deduplicated
  into one vertex, numbered in order of first use;
- a missing normal or uv defaults to zeros;
- non-triangular faces are an error.
"""

from __future__ import annotations

import numpy as np

from potato_tpu_torch.scene.description import MeshData


class ObjError(ValueError):
    pass


def _parse_index(token: str):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' (1-based) -> (v, vt|-1, vn|-1)."""
    parts = token.split("/")
    try:
        v = int(parts[0]) - 1
    except (ValueError, IndexError):
        return None
    vt = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
    vn = int(parts[2]) - 1 if len(parts) > 2 and parts[2] else -1
    if v < 0:
        return None
    return (v, vt, vn)


def load(path_or_text, use_native: bool = True) -> MeshData:
    """Load an OBJ file: a path, or the file's text (any string holding a
    newline is taken as text)."""
    if isinstance(path_or_text, str) and "\n" not in path_or_text:
        with open(path_or_text, "r") as f:
            text = f.read()
    else:
        text = path_or_text

    if use_native:
        from potato_tpu_torch.io import native

        try:
            parsed = native.obj_parse(text)
        except ValueError as e:
            raise ObjError(str(e)) from e
        if parsed is not None:
            return MeshData(*parsed)

    positions, normals, uvs = [], [], []
    face_corners = []  # list of lists of (v, vt, vn)

    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        try:
            if tag == "v" and len(parts) >= 4:
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn" and len(parts) >= 4:
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt" and len(parts) >= 3:
                uvs.append((float(parts[1]), float(parts[2])))
            elif tag == "f" and len(parts) >= 2:
                corners = [_parse_index(t) for t in parts[1:]]
                if any(c is None for c in corners):
                    continue  # unparsable face: skipped
                face_corners.append(corners)
        except ValueError:
            continue  # unparsable line: skipped

    unique: dict = {}
    out_pos, out_nrm, out_uv = [], [], []
    indices = []
    for corners in face_corners:
        if len(corners) != 3:
            raise ObjError("Non-triangular faces are not supported")
        tri = []
        for c in corners:
            idx = unique.get(c)
            if idx is None:
                idx = len(out_pos)
                unique[c] = idx
                v, vt, vn = c
                out_pos.append(positions[v])
                out_nrm.append(normals[vn] if vn >= 0 else (0.0, 0.0, 0.0))
                out_uv.append(uvs[vt] if vt >= 0 else (0.0, 0.0))
            tri.append(idx)
        indices.append(tri)

    return MeshData(
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(-1, 3),
        uvs=np.asarray(out_uv, np.float32).reshape(-1, 2),
        indices=np.asarray(indices, np.int32).reshape(-1, 3),
    )
