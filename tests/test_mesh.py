import numpy as np
import pytest

from p_a_multigrids_tpu.mesh import structured, topology
from p_a_multigrids_tpu.utils import native


def test_structured_tri_mesh_topology():
    mesh = structured.tri_mesh(3, 2, 0.1, 0.1)
    assert mesh.num_elements == 12
    # interior edge count: each shared edge appears in two elements
    n_int = (mesh.neig >= 0).sum()
    n_bnd = (mesh.neig < 0).sum()
    assert n_int + n_bnd == 36
    # boundary edges of a 3x2 rect split into tris: perimeter = 2*(3+2)=10
    assert n_bnd == 10
    # symmetry
    for e in range(mesh.num_elements):
        for f in range(3):
            e2 = mesh.neig[e, f]
            if e2 >= 0:
                f2 = mesh.neigh_face[e, f]
                assert mesh.neig[e2, f2] == e
                assert mesh.dir_flag[e, f] == mesh.dir_flag[e2, f2]


def test_gmsh_reader_and_topology(mesh_dir):
    # test_sn2.msh holds 12 triangles (plus 8 boundary line elements that
    # the reader filters out, Msh2Tri.F90:264-269)
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    assert mesh.num_elements == 12
    # every neighbor pair shares exactly 2 vertex coordinates
    for e in range(mesh.num_elements):
        for f in range(3):
            e2 = mesh.neig[e, f]
            if e2 < 0:
                continue
            a = mesh.X[e].T          # (3, 2)
            b = mesh.X[e2].T
            shared = sum(
                1 for p in a if np.min(np.linalg.norm(b - p, axis=1)) < 1e-12)
            assert shared == 2


@pytest.mark.parametrize("name,nele", [
    ("900_ele.msh", 800),
    ("untitled8.msh", 8),
    ("irregular.msh", 11),
])
def test_gmsh_element_counts(mesh_dir, name, nele):
    mesh = topology.from_msh(f"{mesh_dir}/{name}")
    assert mesh.num_elements == nele


def test_native_matches_python():
    mesh = structured.tri_mesh(4, 4, 1.0, 1.0)
    if not native.available():
        pytest.skip("native lib not built")
    neig, nface, dirf = native.neighbor_topology(mesh.tri)
    neig2, nface2, dirf2 = topology._neighbor_topology_py(mesh.tri)
    assert (neig == neig2).all()
    assert (nface == nface2).all()
    assert (dirf == dirf2).all()


def test_native_gmsh_reader_matches_python(mesh_dir):
    """C++ loader (native/gmsh_reader.cpp) == Python parser bit-for-bit
    on representative zoo meshes (the ReadMSH contract,
    Msh2Tri.F90:132-334)."""
    if not native.available():
        pytest.skip("native lib not built")
    from p_a_multigrids_tpu.mesh import gmsh
    for name in ("test_sn2.msh", "900_ele.msh", "untitled8192.msh",
                 "irregular.msh"):
        path = f"{mesh_dir}/{name}"
        py = gmsh._read_msh_py(path)
        v, t, r = native.read_msh(path)
        np.testing.assert_array_equal(v, py.vertices)
        np.testing.assert_array_equal(t, py.triangles)
        np.testing.assert_array_equal(r, py.region_id)


def test_native_gmsh_reader_errors(tmp_path):
    if not native.available():
        pytest.skip("native lib not built")
    bad = tmp_path / "bad.msh"
    bad.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="unsupported gmsh version"):
        native.read_msh(str(bad))
    with pytest.raises(ValueError, match="cannot open"):
        native.read_msh(str(tmp_path / "missing.msh"))


def test_rect_mesh():
    x_all, face_ele = structured.rect_mesh(3, 2, 1.0, 2.0)
    assert x_all.shape == (6, 2, 4)
    assert np.isclose(x_all[4, 0, 0], 1.0)   # element 4 = row1,col1
    assert np.isclose(x_all[4, 1, 0], 2.0)
    assert face_ele[0, 0] == -1 and face_ele[0, 1] == 1
    assert face_ele[4, 0] == 1 and face_ele[4, 2] == -1


def test_cross_macro_tables_vectorized_matches_ref(mesh_dir):
    """Vectorized strip matching == the loop reference implementation."""
    from p_a_multigrids_tpu.mesh import semi as msemi_mesh

    for name, n in (("test_sn2.msh", 2), ("untitled8.msh", 1),
                    ("irregular.msh", 3)):
        mesh = topology.from_msh(f"{mesh_dir}/{name}")
        fast = msemi_mesh._cross_macro_tables(mesh, n)
        ref = msemi_mesh._cross_macro_tables_ref(mesh, n)
        np.testing.assert_array_equal(fast[0], ref[0])  # neigh_elem
        np.testing.assert_array_equal(fast[1], ref[1])  # neigh_perm
        # bc lists may differ in ordering only: sort by (elem, face)
        def sort3(t):
            order = np.lexsort((t[3], t[2]))
            return t[2][order], t[3][order], t[4][order]
        for got, want in zip(sort3(fast), sort3(ref)):
            np.testing.assert_array_equal(got, want)
