"""Profiling: jax.profiler traces + annotated regions + kernel reports.

Counterpart of the reference's profiling hooks — cudaEvent timings,
Nsight `-g -G` debug builds, and NCCL_DEBUG env plumbing
(ref: 00_mpi_vecadd.cu:89-98, README.md:12, scripts/modal_mpi.py:15):
XLA profiler traces (viewable in TensorBoard/Perfetto/xprof), named trace
annotations, and derived TFLOP/s / bandwidth reports from the timing
harness.

    from cuda_flashattention_tpu.utils.profiling import trace, annotate

    with trace("/tmp/cfa_trace"):          # capture a device trace
        with annotate("attention_fwd"):    # named region inside it
            o = flash_attention(q, k, v)
            jax.block_until_ready(o)
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a jax.profiler device trace into `log_dir`."""
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler timelines (and is free when
    no trace is active)."""
    return jax.profiler.TraceAnnotation(name)


def kernel_report(
    name: str,
    seconds: float,
    flops: float = 0.0,
    bytes_moved: float = 0.0,
    device=None,
) -> Dict[str, float]:
    """Derive TFLOP/s, GB/s and, on a device with published peaks
    (utils/timing.PEAKS), the fraction of each peak for a measured
    kernel; print a one-line summary (the reference prints raw elapsed
    ms, ref: 00_mpi_vecadd.cu:116-117 — we add the roofline context).
    On any other device no share is reported."""
    from cuda_flashattention_tpu.utils.timing import PEAKS
    dev = device or jax.devices()[0]
    peaks = PEAKS.get(getattr(dev, "device_kind", ""))
    tflops = flops / seconds / 1e12 if flops else 0.0
    gbps = bytes_moved / seconds / 1e9 if bytes_moved else 0.0
    out = {
        "name": name,
        "ms": seconds * 1e3,
        "tflops": tflops,
        "gbps": gbps,
        "frac_peak_flops": (tflops / peaks["peak_tflops"]
                            if peaks else None),
        "frac_peak_bw": gbps / peaks["peak_hbm_gbps"] if peaks else None,
    }

    def share(frac):
        return f" ({100 * frac:.1f}% peak)" if frac is not None else ""
    print(f"[kernel_report] {name}: {out['ms']:.3f} ms"
          + (f", {tflops:.1f} TFLOP/s" + share(out["frac_peak_flops"])
             if flops else "")
          + (f", {gbps:.1f} GB/s" + share(out["frac_peak_bw"])
             if bytes_moved else ""))
    return out


def save_device_memory_profile(path: str, device=None) -> None:
    """Dump the current device memory profile (pprof format)."""
    jax.profiler.save_device_memory_profile(path)
