"""Isosurface extraction: vectorized marching tetrahedra.

The port's own copy of ide3d_tpu/utils/marching.py (numpy only, unchanged).
The reference extracts meshes with `mcubes.marching_cubes` (render_mesh.py:26-55);
this needs neither mcubes nor skimage: a dependency-free NumPy
marching-tetrahedra implementation (each grid cube split
into 6 tetrahedra; per-tet lookup over 16 sign cases — no 256-entry MC tables).
Produces a valid watertight isosurface with ~2x the triangle count of classic MC;
fully vectorized over all tets at once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Cube corner offsets (z, y, x) indexed 0..7.
_CORNERS = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
        [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
    ],
    dtype=np.int64,
)

# Six tetrahedra covering the cube (corner indices), consistent orientation.
_TETS = np.array(
    [
        [0, 5, 1, 3],
        [0, 5, 3, 7],
        [0, 5, 7, 4],
        [0, 7, 3, 2],
        [0, 7, 2, 6],
        [0, 7, 6, 4],
    ],
    dtype=np.int64,
)

# For each of the 16 sign cases of a tet (bit i = vertex i inside), the list of
# cut edges forming 0, 1 or 2 triangles. Edges are pairs of tet-vertex indices.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

_CASES = {
    0b0000: [],
    0b1111: [],
    0b0001: [[(0, 1), (0, 2), (0, 3)]],
    0b1110: [[(0, 1), (0, 3), (0, 2)]],
    0b0010: [[(0, 1), (1, 3), (1, 2)]],
    0b1101: [[(0, 1), (1, 2), (1, 3)]],
    0b0100: [[(0, 2), (1, 2), (2, 3)]],
    0b1011: [[(0, 2), (2, 3), (1, 2)]],
    0b1000: [[(0, 3), (2, 3), (1, 3)]],
    0b0111: [[(0, 3), (1, 3), (2, 3)]],
    0b0011: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
    0b1100: [[(0, 2), (1, 3), (0, 3)], [(0, 2), (1, 2), (1, 3)]],
    0b0101: [[(0, 1), (1, 2), (2, 3)], [(0, 1), (2, 3), (0, 3)]],
    0b1010: [[(0, 1), (2, 3), (1, 2)], [(0, 1), (0, 3), (2, 3)]],
    0b0110: [[(0, 1), (0, 2), (2, 3)], [(0, 1), (2, 3), (1, 3)]],
    0b1001: [[(0, 1), (2, 3), (0, 2)], [(0, 1), (1, 3), (2, 3)]],
}


def marching_tetrahedra(
    volume: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a [D, H, W] scalar field.

    Returns (vertices [V, 3] in voxel coordinates (z, y, x), faces [F, 3] int).
    """
    D, H, W = volume.shape
    gz, gy, gx = np.meshgrid(
        np.arange(D - 1), np.arange(H - 1), np.arange(W - 1), indexing="ij"
    )
    base = np.stack([gz, gy, gx], axis=-1).reshape(-1, 3)  # cube origins

    corner_pos = base[:, None, :] + _CORNERS[None]  # [C, 8, 3]
    vals = volume[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]  # [C, 8]

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # [C, 4]
        tp = corner_pos[:, tet].astype(np.float64)  # [C, 4, 3]
        inside = tv > level
        case = (
            inside[:, 0].astype(np.int64)
            + inside[:, 1] * 2
            + inside[:, 2] * 4
            + inside[:, 3] * 8
        )
        for code, tri_list in _CASES.items():
            if not tri_list:
                continue
            sel = np.nonzero(case == code)[0]
            if sel.size == 0:
                continue
            for tri in tri_list:
                pts = []
                for (a, b) in tri:
                    va, vb = tv[sel, a], tv[sel, b]
                    t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pts.append(tp[sel, a] * (1 - t) + tp[sel, b] * t)
                tris.append(np.stack(pts, axis=1))  # [n, 3, 3]

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tri_pts = np.concatenate(tris, axis=0)  # [F, 3, 3]
    # Merge duplicate vertices (quantized) to build an indexed mesh.
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat * 1024).astype(np.int64)
    _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    verts = flat[idx]
    faces = inv.reshape(-1, 3)
    # Drop degenerate faces.
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[2]:.5f} {v[1]:.5f} {v[0]:.5f}\n")  # (z,y,x) -> (x,y,z)
        for face in faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        if len(verts):
            xyz = np.ascontiguousarray(verts[:, ::-1]).astype("<f4")  # (z,y,x) -> (x,y,z)
            f.write(xyz.tobytes())
        if len(faces):
            counts = np.full((len(faces), 1), 3, np.uint8)
            fdata = np.concatenate(
                [counts.view(np.uint8),
                 faces.astype("<i4").view(np.uint8).reshape(len(faces), -1)],
                axis=1,
            )
            f.write(fdata.tobytes())
