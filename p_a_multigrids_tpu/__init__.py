"""p_a_multigrids_tpu — a JAX sparse-FEM + geometric-multigrid framework.

A from-scratch JAX/XLA re-design of the capabilities of the Fortran
reference ``Amin-Nadimy/P-A_multigrids``: a 2-D discontinuous-Galerkin P1
finite-element transport-diffusion solver on structured, unstructured (gmsh)
and semi-structured triangular meshes, where every unstructured macro-triangle
is recursively bisected into ``4**n_split`` congruent children, giving a
nested hierarchy used for geometric-multigrid V-cycles.

Layer map (not a port):

- ``utils``     quadrature tables, shape functions, dtype policy, profiling
- ``mesh``      gmsh reader, O(E) neighbor topology, structured generators,
                semi-structured splitting index math, batched geometry
- ``ops``       batched element matrices, fixed-degree block-sparse (ELL/BSR)
                operators, SpMV, smoothers, dense solves
- ``multigrid`` restriction/prolongation transfer operators and the V-cycle
- ``models``    the workload drivers (the reference's 10 "modes")
- ``parallel``  macro-element partitioning, halo exchange, shard_map solvers
- ``io``        VTU/VTK writers and text curve outputs
- ``validation``analytical solutions and L1<0.01 acceptance gates
"""

__version__ = "0.1.0"

import jax as _jax

# Full f32 matmul precision everywhere.  On the GPU, XLA otherwise runs
# f32 matmuls in TF32 (about three decimal digits), which corrupts the
# one-hot gather contractions (ops/stencil.py), the multigrid transfer
# contractions and the dense bottom inverse: exact 0/1 selections and
# 1e6-conditioned coarse solves need every f32 bit.  The package's matmuls
# are tiny next to its bandwidth-bound stencil work, so the full-precision
# cost is invisible; code that genuinely wants reduced precision opts in
# explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")
