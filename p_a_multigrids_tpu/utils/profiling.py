"""Profiling / observability helpers.

The reference's tracing story is manual CPU_TIME bracketing plus committed
gprof/callgrind artifacts (SURVEY.md section 5).  Here:

- ``timed``: wall-clock bracketing with device synchronization (the
  CPU_TIME equivalent that is actually correct under async dispatch);
- ``trace``: context manager around ``jax.profiler`` emitting a TensorBoard
  trace directory for per-kernel analysis;
- ``roofline``: quick arithmetic-intensity bookkeeping for an operator
  application, used by bench.py to report achieved vs light-speed
  bandwidth;
- ``PEAKS`` / ``peaks``: published peak rates per device kind, the only
  source of the denominators of every roofline share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time

import jax


@dataclasses.dataclass
class Timing:
    name: str
    seconds: float
    iterations: int

    @property
    def per_iter_ms(self) -> float:
        return self.seconds / self.iterations * 1e3

    def __str__(self):
        return f"{self.name}: {self.per_iter_ms:.3f} ms/iter"


def timed(name: str, fn, *args, iterations: int = 20, warmup: int = 2
          ) -> Timing:
    """Time a jitted callable with proper device synchronization."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iterations):
        out = fn(*args)
    jax.block_until_ready(out)
    return Timing(name=name, seconds=time.time() - t0,
                  iterations=iterations)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace around a block (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def union_ns(intervals) -> float:
    """Total length of the union of (start, duration) intervals."""
    total = 0.0
    end = float("-inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def device_busy_ns(trace_dir: str, plane_prefix: str = "/device:GPU",
                   line_prefix: str = "Stream") -> dict[str, dict]:
    """Busy time per device plane of the newest trace under ``trace_dir``:
    the union of the intervals of every event on the plane's stream lines
    (the kernels and copies the device ran); all of the plane's lines when
    none is named like a stream.  Returns {plane: {"busy_ns", "lines"}}.
    Idle share of a window is 1 - busy / window."""
    import glob
    import os

    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(files[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        picked = [ln for ln in lines if ln.name.startswith(line_prefix)]
        picked = picked or lines
        out[plane.name] = {
            "busy_ns": union_ns((ev.start_ns, ev.duration_ns)
                                for ln in picked for ev in ln.events),
            "lines": [ln.name for ln in picked]}
    return out

def require_gpu(devices, what: str):
    """Refuse to measure anywhere but on a GPU: a CPU run measures nothing
    a user pays for.  Returns ``devices``."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"{what}: needs a GPU, JAX found {plat!r}")
    return devices


def card_line() -> str:
    """``name, power.limit`` of every card as nvidia-smi reports them (a
    child process that stays off JAX); cards joined by `` | ``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return " | ".join(line.strip() for line in out.strip().splitlines())


# Published peaks, keyed by ``jax.Device.device_kind``.  Source: NVIDIA
# H100 Tensor Core GPU datasheet, SXM5 part (dense rates, no sparsity):
# HBM3 3.35 TB/s, FP32 67 TFLOP/s, FP64 34 TFLOP/s, TF32 tensor 495
# TFLOP/s, bf16 tensor 989 TFLOP/s; at the full 700 W power limit.  A card
# capped lower (nvidia-smi power.limit) cannot hold these clocks, so every
# share is reported beside the card's limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_gbps=3350.0, fp32_tflops=67.0, fp64_tflops=34.0,
        tf32_tflops=495.0, bf16_tflops=989.0, l2_mb=50.0,
        source="NVIDIA H100 datasheet (SXM5), dense rates at 700 W"),
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to utils/profiling.PEAKS with its source") from None


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_moved: float
    seconds: float

    @property
    def achieved_gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    def summary(self, peak_gbps: float) -> str:
        return (f"{self.achieved_gflops:.1f} GFLOP/s, "
                f"{self.achieved_gbps:.1f} GB/s "
                f"({100 * self.achieved_gbps / peak_gbps:.1f}% of "
                f"{peak_gbps:.0f} GB/s peak)")


def operator_roofline(U: int, C: int, nloc: int, seconds: float,
                      dtype_bytes: int = 4) -> Roofline:
    """Roofline for one block-STENCIL operator application (ops/stencil):
    the dominant traffic is the per-element coefficient blocks (self + 3
    faces, nloc x nloc each) streamed from HBM; state in/out is tiny.
    Reported by bench.py as op_achieved_gbps."""
    E = U * C
    nnz = E * 4 * nloc * nloc
    flops = 2.0 * nnz
    bytes_moved = dtype_bytes * (nnz + 3 * E * nloc)
    return Roofline(flops=flops, bytes_moved=bytes_moved, seconds=seconds)
