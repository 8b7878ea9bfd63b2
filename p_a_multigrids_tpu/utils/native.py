"""ctypes bridge to the optional C++ mesh-acceleration library.

The reference's entire compute stack is native compiled code; in this
framework the device compute path is JAX/XLA and the *setup* hot path
(neighbor topology over millions of elements, the gmsh reader) is native
C++ (native/), loaded here via ctypes with a NumPy fallback.  The library
is built from the committed sources with ``make -C native`` on first use,
or explicitly (and forcibly) with :func:`build`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _lib_path() -> str:
    return os.path.join(_root(), "native", "libmesh_accel.so")


def _make(force: bool) -> subprocess.CompletedProcess:
    cmd = ["make", "-C", os.path.join(_root(), "native")]
    if force:
        cmd.append("-B")
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          check=False)


def build(force: bool = True) -> bool:
    """(Re)build native/libmesh_accel.so from the committed sources and
    load it; ``force`` rebuilds even when a library file exists (a copied
    binary is never trusted).  Returns whether the library is in use."""
    global _LIB, _TRIED
    proc = _make(force)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    _LIB, _TRIED = None, False
    return available()


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        try:
            _make(force=False)
        except (OSError, subprocess.SubprocessError):
            pass
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            lib.neighbor_topology.restype = ctypes.c_int
            lib.neighbor_topology.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.gmsh_read.restype = ctypes.c_int
            lib.gmsh_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.gmsh_free.restype = None
            lib.gmsh_free.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _LIB = lib
        except (OSError, AttributeError):
            # missing or stale .so (e.g. built before gmsh_read existed):
            # fall back to the Python implementations
            _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def neighbor_topology(triangles: np.ndarray):
    """C++ edge-hash neighbor search; same contract as the Python version."""
    lib = _load()
    U = triangles.shape[0]
    tri = np.ascontiguousarray(triangles, np.int32)
    neig = np.full((U, 3), -1, np.int32)
    nface = np.full((U, 3), -1, np.int32)
    dirf = np.zeros((U, 3), np.uint8)
    rc = lib.neighbor_topology(
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(U),
        neig.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nface.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dirf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"mesh_accel.neighbor_topology failed rc={rc}")
    return neig, nface, dirf.astype(bool)


def read_msh(path: str):
    """C++ gmsh 2.x loader (native/gmsh_reader.cpp); same contract as
    mesh.gmsh.read_msh.  Returns (vertices (N,3) f64, triangles (E,3) i32
    0-based, region_id (E,) i32); raises ValueError on malformed input."""
    lib = _load()
    verts_p = ctypes.POINTER(ctypes.c_double)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    regs_p = ctypes.POINTER(ctypes.c_int32)()
    nnodes = ctypes.c_int64(0)
    ntris = ctypes.c_int64(0)
    errbuf = ctypes.create_string_buffer(256)
    rc = lib.gmsh_read(path.encode(), ctypes.byref(verts_p),
                       ctypes.byref(nnodes), ctypes.byref(tris_p),
                       ctypes.byref(regs_p), ctypes.byref(ntris),
                       errbuf, ctypes.c_int64(len(errbuf)))
    if rc != 0:
        raise ValueError(f"{path}: {errbuf.value.decode()}")
    try:
        n, e = nnodes.value, ntris.value
        vertices = np.ctypeslib.as_array(verts_p, (n, 3)).copy()
        triangles = (np.ctypeslib.as_array(tris_p, (e, 3)).copy()
                     if e else np.zeros((0, 3), np.int32))
        region_id = (np.ctypeslib.as_array(regs_p, (e,)).copy()
                     if e else np.zeros((0,), np.int32))
    finally:
        lib.gmsh_free(verts_p, tris_p, regs_p)
    return vertices, triangles, region_id
