"""Generated structured meshes (no files needed).

Equivalents of the reference's structured_meshgen.F90: rectangular quad
meshes (``ele_info``, :6-71) and structured triangular meshes
(``tri_ele_info``/``tri_ele_info2``/``str_tri_X_nodes``, :75-334), emitted
directly as vertex/connectivity arrays that feed the same MacroMesh
topology path as gmsh meshes.
"""

from __future__ import annotations

import numpy as np

from .topology import MacroMesh, build_macro_mesh


def rect_mesh(no_ele_row: int, no_ele_col: int, dx: float, dy: float):
    """Structured quad mesh (structured_meshgen.F90:6-71).

    Returns:
      x_all:    (totele, 2, 4) node coords, local order (0,0),(1,0),(0,1),(1,1)
      face_ele: (totele, 4) neighbor element per face (0=bottom, 1=right,
                2=top, 3=left), -1 on the domain boundary.
    """
    totele = no_ele_row * no_ele_col
    e = np.arange(totele)
    col, row = divmod(e, no_ele_row)
    x0 = row * dx
    y0 = col * dy
    x_all = np.zeros((totele, 2, 4), np.float64)
    for k, (i, j) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        x_all[:, 0, k] = x0 + i * dx
        x_all[:, 1, k] = y0 + j * dy
    face_ele = np.full((totele, 4), -1, np.int64)
    face_ele[:, 0] = np.where(col > 0, e - no_ele_row, -1)
    face_ele[:, 1] = np.where(row < no_ele_row - 1, e + 1, -1)
    face_ele[:, 2] = np.where(col < no_ele_col - 1, e + no_ele_row, -1)
    face_ele[:, 3] = np.where(row > 0, e - 1, -1)
    return x_all, face_ele.astype(np.int32)


def tri_mesh(no_ele_row: int, no_ele_col: int, dx: float, dy: float
             ) -> MacroMesh:
    """Structured triangular mesh: each dx*dy cell split into two triangles.

    Mirrors tri_ele_info/str_tri_X_nodes (structured_meshgen.F90:75-334):
    cell (r, c) yields a lower-left triangle (nodes: right-bottom, top-left,
    bottom-left) and an upper-right one, matching the reference's up/down
    pattern.  Topology is then built with the standard O(E) hash.
    """
    nvx, nvy = no_ele_row + 1, no_ele_col + 1
    vx, vy = np.meshgrid(np.arange(nvx) * dx, np.arange(nvy) * dy,
                         indexing="xy")
    vertices = np.stack([vx.ravel(), vy.ravel(),
                         np.zeros(nvx * nvy)], axis=1)

    def vid(i, j):
        return j * nvx + i

    tris = []
    for j in range(no_ele_col):
        for i in range(no_ele_row):
            # "up" triangle: nodes 1=(i+1,j), 2=(i,j+1), 3=(i,j)
            tris.append([vid(i + 1, j), vid(i, j + 1), vid(i, j)])
            # "down" triangle: nodes 1=(i,j+1), 2=(i+1,j), 3=(i+1,j+1)
            tris.append([vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)])
    triangles = np.asarray(tris, np.int32)
    return build_macro_mesh(vertices, triangles)


def stretched_mesh(rows: int = 64, cols: int = 64, aspect: float = 3.0
                   ) -> MacroMesh:
    """RCM-ordered mesh of ``2*rows*cols`` right triangles stretched
    ``aspect``:1 (legs ``aspect*h`` by ``h``, h = 1/cols) on
    [0, aspect*rows*h] x [0, 1].

    The default (8,192 macros, 3:1) is the generated stand-in for the
    reference's ``untitled8192.msh`` benchmark mesh, whose stretched
    triangles are what make the strength-filtered aggregation
    (``SemiConfig.amg``) necessary.  RCM keeps cross-macro neighbours
    within a narrow index band (``topology.rcm_order``).
    """
    from . import topology

    h = 1.0 / cols
    return topology.rcm_reorder(tri_mesh(rows, cols, aspect * h, h))
