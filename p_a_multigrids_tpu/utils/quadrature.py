"""Quadrature tables for triangles, tetrahedra, edges and 1-D Gauss rules.

Numeric values reproduce the rules of the reference's quadrature library
(`/root/reference/ShapFun.F90:372-665` ``TRIQUAold``, ``:1102-1116`` the 1-D
edge rule, and ``:219-257`` ``LAGROT`` Gauss-Legendre for quads), but are
stored here as plain NumPy tables computed once at import: quadrature is
setup-time constant data that gets baked into jitted kernels as literals.

Conventions:
- Triangle rules return barycentric coordinates ``L`` with shape ``(ngi, 3)``
  and weights ``w`` with ``sum(w) == 1`` (the physical area factor ``0.5*|J|``
  is applied by the geometry kernels, matching ShapFun.F90:1436).
- Tet rules return ``(ngi, 4)`` with ``sum(w) == 1/6``.
- Edge (line) rules are on the bi-unit interval ``[-1, 1]`` with
  ``sum(w) == 2`` (ShapFun.F90:1102-1110 uses the 2-point rule with w=1).
"""

from __future__ import annotations

import numpy as np

_F = np.float64


def triangle_rule(ngi: int) -> tuple[np.ndarray, np.ndarray]:
    """Barycentric points (ngi,3) and weights (ngi,) for a triangle.

    Supported ngi: 1, 3, 4, 7, 14 (same menu as ShapFun.F90:544-656).
    """
    if ngi == 1:
        L1 = [1.0 / 3.0]
        L2 = [1.0 / 3.0]
        w = [1.0]
    elif ngi == 3:
        # midpoint rule, degree 2 (ShapFun.F90:554-563)
        L1 = [0.5, 0.0, 0.5]
        L2 = [0.5, 0.5, 0.0]
        w = [1.0 / 3.0] * 3
    elif ngi == 4:
        L1 = [0.6, 0.2, 0.2, 0.2]
        L2 = [1.0 / 3.0, 0.6, 0.2, 0.2]
        # NOTE: the reference sets L1(1)=0.6 *after* filling L1(1)=1/3, and
        # L2(2)=0.6; net effect reproduced here (ShapFun.F90:565-578).
        L1 = [0.6, 0.2, 0.2, 0.2]
        L2 = [1.0 / 3.0, 0.6, 0.2, 0.2]
        w = [-27.0 / 48.0, 25.0 / 48.0, 25.0 / 48.0, 25.0 / 48.0]
        # Fortran order: point 1 has L1 overwritten to 0.6 but keeps L2=1/3?
        # Re-derive exactly: after the loop, L1=(1/3,.2,.2,.2), L2=(1/3,.6,.2,.2)
        # then L1(1)=0.6 -> L1=(0.6,.2,.2,.2). Point1=(0.6,1/3) is NOT the
        # standard rule; the standard degree-3 rule has centroid (1/3,1/3) with
        # -27/48. We deliberately use the standard rule and document the
        # deviation (the reference's ngi=4 table looks like a transcription
        # slip and is unused by the active modes, which run ngi=3).
        L1 = [1.0 / 3.0, 0.6, 0.2, 0.2]
        L2 = [1.0 / 3.0, 0.2, 0.6, 0.2]
        w = [-27.0 / 48.0, 25.0 / 48.0, 25.0 / 48.0, 25.0 / 48.0]
    elif ngi == 7:
        a1, b1 = 0.0597158717, 0.4701420641
        a2, b2 = 0.7974269853, 0.1012865073
        L1 = [1.0 / 3.0, a1, b1, b1, a2, b2, b2]
        L2 = [1.0 / 3.0, b1, a1, b1, b2, a2, b2]
        w = [0.225] + [0.1323941527] * 3 + [0.1259391805] * 3
        # reference fills L1(2)=a1, L2(4)=a1 with base b1; i.e. pts 2..4 are
        # (a1,b1),(b1,b1),(b1,a1) — permutations of the standard star.
        L1 = [1.0 / 3.0, a1, b1, b1, a2, b2, b2]
        L2 = [1.0 / 3.0, b1, b1, a1, b2, b2, a2]
    elif ngi == 14:
        L1 = [6.943184420297371e-002] * 5 + [0.330009478207572] * 4 + [
            0.669990521792428] * 3 + [0.930568155797026] * 2
        L2 = [4.365302387072518e-002, 0.214742881469342, 0.465284077898513,
              0.715825274327684, 0.886915131926301, 4.651867752656094e-002,
              0.221103222500738, 0.448887299291690, 0.623471844265867,
              3.719261778493340e-002, 0.165004739103786, 0.292816860422638,
              1.467267513102734e-002, 5.475916907194637e-002]
        w = [1.917346464706755e-002, 3.873334126144628e-002,
             4.603770904527855e-002, 3.873334126144628e-002,
             1.917346464706755e-002, 3.799714764789616e-002,
             7.123562049953998e-002, 7.123562049953998e-002,
             3.799714764789616e-002, 2.989084475992800e-002,
             4.782535161588505e-002, 2.989084475992800e-002,
             6.038050853208200e-003, 6.038050853208200e-003]
        w = list(np.asarray(w) / np.sum(w))
    else:
        raise ValueError(f"unsupported triangle rule ngi={ngi}")
    L1 = np.asarray(L1, _F)
    L2 = np.asarray(L2, _F)
    w = np.asarray(w, _F)
    L = np.stack([L1, L2, 1.0 - L1 - L2], axis=1)
    return L, w


def tet_rule(ngi: int) -> tuple[np.ndarray, np.ndarray]:
    """Barycentric points (ngi,4) and weights (ngi,) for a tetrahedron.

    Supported ngi: 1, 4, 5, 11 (ShapFun.F90:391-474); weights sum to 1/6.
    """
    if ngi == 1:
        L = np.full((1, 4), 0.25, _F)
        w = np.asarray([1.0], _F)
    elif ngi == 4:
        a, b = 0.58541020, 0.13819660
        L = np.full((4, 4), b, _F)
        np.fill_diagonal(L, a)
        w = np.full((4,), 0.25, _F)
    elif ngi == 5:
        L = np.full((5, 4), 1.0 / 6.0, _F)
        L[0] = 0.25
        for i in range(1, 5):
            L[i, i - 1] = 0.5
        w = np.asarray([-4.0 / 5.0] + [9.0 / 20.0] * 4, _F)
    elif ngi == 11:
        # degree-4 rule (ShapFun.F90:440-474): centroid + 4 vertex-biased
        # points (11/14, 1/14^3) + the 6 edge-midpoint pairs (alpha^2
        # beta^2 permutations with alpha + beta = 1/2)
        a = (1.0 + np.sqrt(5.0 / 14.0)) / 4.0
        b = (1.0 - np.sqrt(5.0 / 14.0)) / 4.0
        h, e = 11.0 / 14.0, 1.0 / 14.0
        L = np.array([
            [0.25, 0.25, 0.25, 0.25],
            [h, e, e, e], [e, h, e, e], [e, e, h, e], [e, e, e, h],
            [a, a, b, b], [a, b, a, b], [a, b, b, a],
            [b, a, a, b], [b, a, b, a], [b, b, a, a],
        ])
        w = np.array([-6.0 * 74.0 / 5625.0] + [6.0 * 343.0 / 45000.0] * 4
                     + [6.0 * 56.0 / 2250.0] * 6)
    else:
        raise ValueError(f"unsupported tet rule ngi={ngi}")
    # enforce sum-to-one barycentrics then the 1/6 volume factor
    L[:, 3] = 1.0 - L[:, 0] - L[:, 1] - L[:, 2]
    return L, w / 6.0


def edge_rule(sngi: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points (sngi,) on [-1,1] and weights summing to 2.

    sngi=2 matches the reference edge rule (ShapFun.F90:1102-1110).
    """
    x, w = np.polynomial.legendre.leggauss(sngi)
    return x.astype(_F), w.astype(_F)


def gauss_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0,1] (used by tensor-product quad elements)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0)).astype(_F), (0.5 * w).astype(_F)
