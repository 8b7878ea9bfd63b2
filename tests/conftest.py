"""Test harness: run on a virtual 8-device CPU mesh unless told otherwise.

Sets the env vars before jax is imported anywhere, so this conftest is
the very first import of the test session.  ``JAX_PLATFORMS`` defaults to
the CPU; tests marked ``gpu`` need a card and skip without one (run them
on a GPU machine with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu``).

Meshes are generated, never read from outside the repository: the
``mesh_dir`` fixture writes small gmsh 2.2 files named after the
reference's mesh zoo, so the gmsh readers are still exercised.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from p_a_multigrids_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from p_a_multigrids_tpu.mesh import structured  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def write_msh(path, mesh, region_id=None):
    """gmsh 2.2 ASCII file of a MacroMesh: the nodes, one 2-node line
    element per boundary edge (type 1, which readers must skip) and the
    triangles (type 2) with their region as the physical tag."""
    tri = np.asarray(mesh.tri)
    nv = int(tri.max()) + 1
    xy = np.zeros((nv, 2))
    for k in range(3):
        xy[tri[:, k]] = mesh.X[:, :, k]
    regions = (np.asarray(mesh.region_id) if region_id is None
               else np.asarray(region_id))
    edges = {}
    for e in range(len(tri)):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((int(tri[e, a]), int(tri[e, b]))))
            edges[key] = edges.get(key, 0) + 1
    bnd = [k for k, n in edges.items() if n == 1]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(nv)]
    lines += [f"{i + 1} {float(x)!r} {float(y)!r} 0"
              for i, (x, y) in enumerate(xy)]
    lines += ["$EndNodes", "$Elements", str(len(bnd) + len(tri))]
    eid = 1
    for a, b in bnd:
        lines.append(f"{eid} 1 2 1 1 {a + 1} {b + 1}")
        eid += 1
    for e in range(len(tri)):
        n = tri[e] + 1
        lines.append(f"{eid} 2 2 {regions[e]} 1 {n[0]} {n[1]} {n[2]}")
        eid += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _irregular_mesh():
    """11 Delaunay triangles on 8 irregular points (3 hull + 5 inside)."""
    from scipy.spatial import Delaunay

    from p_a_multigrids_tpu.mesh import topology

    pts = np.array([[0.0, 0.0], [1.0, 0.05], [0.35, 0.9], [0.3, 0.25],
                    [0.55, 0.3], [0.45, 0.55], [0.25, 0.45], [0.7, 0.2]])
    tri = Delaunay(pts).simplices.astype(np.int32)
    a, b, c = (pts[tri[:, k]] for k in range(3))
    det = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
           - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    tri[det < 0] = tri[det < 0][:, [0, 2, 1]]           # counter-clockwise
    verts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    return topology.build_macro_mesh(verts, tri)


# generated stand-ins for the reference's mesh zoo: same names, element
# counts and domain classes (unit squares, a thin [0, 1] column, an
# irregular Delaunay patch, the 8192-macro stretched bench mesh)
ZOO = {
    "test_sn2.msh": lambda: structured.tri_mesh(3, 2, 1 / 3, 1 / 2),
    "untitled8.msh": lambda: structured.tri_mesh(2, 2, 0.5, 0.5),
    "900_ele.msh": lambda: structured.tri_mesh(20, 20, 0.05, 0.05),
    "irregular.msh": _irregular_mesh,
    "P_structured_mesh.msh": lambda: structured.tri_mesh(
        60, 2, 1 / 60, 1 / 30),
    "untitled8192.msh": structured.stretched_mesh,
}


@pytest.fixture(scope="session")
def mesh_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    for name, make in ZOO.items():
        write_msh(str(d / name), make())
    return str(d)
