"""Debug / sanitizer mode: checkify numeric and bounds checks.

The reference's only sanitizer is gfortran's ``-fbounds-check`` on a serial
debug build (/root/reference/Makefile:8).  The JAX equivalent that
SURVEY §5 prescribes is ``jax.experimental.checkify``: the same jitted
solver graph is instrumented so that

- any primitive producing NaN/Inf from finite inputs (float checks),
- any out-of-bounds gather/scatter index (index checks — the moral
  equivalent of -fbounds-check on the static index tables), and
- explicit ``checkify.check`` assertions

raise a Python error with the failing check's location instead of silently
propagating garbage.  Enable with ``SemiConfig(debug=True)`` or the CLI
``--debug`` flag; the instrumented graph is slower to compile AND run
(every gather gains a bounds assert), so it is a debug mode, not a
production path — prefer small meshes / few levels when sanitizing.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.experimental import checkify

# -fbounds-check equivalent + NaN/Inf/div-by-zero generation
ERRORS = checkify.float_checks | checkify.index_checks | checkify.user_checks


def checked(fn, errors=ERRORS):
    """Wrap a jittable function so it raises on NaN/Inf/OOB.

    The checkify transform is applied inside jit (the recommended order),
    and the returned wrapper re-raises the first failed check as
    ``jax.experimental.checkify.JaxRuntimeError``.
    """
    cfn = jax.jit(checkify.checkify(fn, errors=errors))

    def wrapper(*args):
        err, out = cfn(*args)
        err.throw()
        return out

    return wrapper


def assert_finite(x, name: str = "array") -> None:
    """Host-side finite assertion for run boundaries (IC, final state)."""
    a = np.asarray(x)
    if not np.isfinite(a).all():
        bad = int((~np.isfinite(a)).sum())
        raise FloatingPointError(
            f"{name}: {bad}/{a.size} non-finite values "
            f"(min={np.nanmin(a)}, max={np.nanmax(a)})")
