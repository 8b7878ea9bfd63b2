import numpy as np
import pytest

from p_a_multigrids_tpu.mesh import geometry, semi, splitting, structured, topology


@pytest.mark.parametrize("n", [1, 2, 3])
def test_child_lattice_covers_macro(n):
    verts, updown = splitting.child_lattice(n)
    C = 4 ** n
    assert verts.shape == (C, 3, 2)
    assert (np.abs(updown) == 1).all()
    assert (updown == 1).sum() == 2 ** (n - 1) * (2 ** n + 1)
    # every child is a half-lattice-cell triangle; a down child is a 180-deg
    # rotation of an up child, which preserves orientation in 2D, so all
    # signed areas are +0.5 (this is why detwei needs no sign handling and
    # only nx flips by the updown factor, ShapFun.F90:1789-1806).
    v = verts.astype(float)
    d1, d2 = v[:, 0] - v[:, 2], v[:, 1] - v[:, 2]
    area = 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    assert np.allclose(area, 0.5)
    # children tile the macro triangle exactly
    assert np.isclose(area.sum(), 0.5 * (2 ** n) ** 2)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_child_neighbors_symmetric(n):
    neigh = splitting.child_neighbors(n)
    C = 4 ** n
    for e in range(C):
        for f in range(3):
            e2 = neigh[e, f]
            if e2 >= 0:
                assert e in neigh[e2], (e, f, e2)
    # boundary face count: 3 * 2**n strips
    assert (neigh < 0).sum() == 3 * 2 ** n


def test_child_neighbors_matches_reference_n1():
    """get_str_neig for n=1 (splitting.F90:669-715): 4 children.

    Reference (1-based): ele1 (0,0,2), ele2 (4,1,3)... derived from the row
    algorithm: row1 = eles 1,2,3 (up,down,up), row2 = ele 4 (up).
    neighbors: ele2 faces: (1:ele4, 2:ele3, 3:ele1).
    """
    neigh = splitting.child_neighbors(1)
    # 0-based
    assert list(neigh[0]) == [-1, -1, 1]
    assert list(neigh[1]) == [3, 2, 0]
    assert list(neigh[2]) == [-1, 1, -1]
    assert list(neigh[3]) == [1, -1, -1]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_boundary_strips(n):
    strip_elems, strip_cface, slot_of = splitting.boundary_strips(n)
    m = 2 ** n
    # strips contain only boundary-faced children, each exactly once per face
    assert strip_elems.shape == (3, m)
    neigh = splitting.child_neighbors(n)
    for mf in range(3):
        cf = strip_cface[mf]
        for k in range(m):
            assert neigh[strip_elems[mf, k], cf] == -1


def test_boundary_strip_slots_follow_macro_edge():
    """Slots must advance monotonically along the macro face direction."""
    n = 2
    X = np.asarray([[[3.0, 1.0, 0.0], [0.0, 2.0, 0.0]]])  # one macro tri
    coords = splitting.child_coords(X, n)                  # (1, C, 2, 3)
    strip_elems, strip_cface, _ = splitting.boundary_strips(n)
    for mf in range(3):
        a, b = splitting.MACRO_FACE_NODES[mf]
        direction = X[0, :, b] - X[0, :, a]
        mids = coords[0, strip_elems[mf]].mean(axis=2)     # (m, 2)
        proj = mids @ direction
        assert (np.diff(proj) > 0).all(), mf


@pytest.mark.parametrize("n", [1, 2])
def test_element_conversion(n):
    fine = splitting.element_conversion(n)
    C = 4 ** n
    assert fine.shape == (C, 4)
    # all fine children used exactly once
    assert sorted(fine.ravel().tolist()) == list(range(4 ** (n + 1)))
    cv, cupd = splitting.child_lattice(n)
    fv, fupd = splitting.child_lattice(n + 1)
    for e in range(C):
        # corner children share orientation with parent; central one flips
        assert (fupd[fine[e, :3]] == cupd[e]).all()
        assert fupd[fine[e, 3]] == -cupd[e]
        # children tile the parent: total area check in fine lattice units
        vparent = cv[e].astype(float) * 2


def _painted_continuity(mesh, n):
    """Paint a linear field; neighbor tables must reproduce face values."""
    grid = semi.build_grid(mesh, n_split=n, multi_levels=1)
    lvl = grid.levels[0]
    U, C = mesh.num_elements, 4 ** n
    coords = splitting.child_coords(mesh.X, n)             # (U, C, 2, 3)
    f = lambda x, y: 1.3 * x - 0.7 * y + 0.25
    T = f(coords[:, :, 0, :], coords[:, :, 1, :])          # (U, C, 3)
    Tflat = T.reshape(U * C, 3)
    fn = splitting.CHILD_FACE_NODES
    for u in range(U):
        for c in range(C):
            for cf in range(3):
                ne = lvl.neigh_elem[u, c, cf]
                if ne < 0:
                    continue
                a, b = fn[cf]
                mine = np.asarray([T[u, c, a], T[u, c, b]])
                perm = lvl.neigh_perm[u, c, cf]
                theirs = Tflat[ne][perm]
                assert np.allclose(mine, theirs, atol=1e-9), (u, c, cf)


@pytest.mark.parametrize("n", [1, 2])
def test_flat_adjacency_continuity_structured(n):
    mesh = structured.tri_mesh(2, 2, 1.0, 1.0)
    _painted_continuity(mesh, n)


@pytest.mark.parametrize("n", [1, 2])
def test_flat_adjacency_continuity_gmsh(mesh_dir, n):
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    _painted_continuity(mesh, n)


def test_bc_faces_on_domain_boundary(mesh_dir):
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    grid = semi.build_grid(mesh, n_split=2, multi_levels=2)
    for lvl in grid.levels:
        m = 2 ** lvl.n
        nbnd_macro = (mesh.neig < 0).sum()
        assert lvl.bc_elem.shape[0] == nbnd_macro * m
        # interior+boundary faces account for every face
        assert (lvl.neigh_elem < 0).sum() == nbnd_macro * m
