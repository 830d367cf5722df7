"""Timing / throughput instrumentation.

Counterpart of the reference's cudaEvent + chrono timers
(ref: 00_mpi_vecadd.cu:89-98, 02_overlap.cu:61, 94-101):
`block_until_ready`-bracketed wall timing with warmup (compile) excluded,
reported as the median and quartiles of the repeats, plus the card's
published peaks for roofline shares and the attention FLOP count.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, List, Tuple

import jax
import numpy as np

# Published dense peaks per card, keyed by JAX's device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part (dense, no sparsity):
# 989 TFLOP/s bf16, 1,979 TFLOP/s fp8, 3.35 TB/s HBM3. These assume the
# full 700 W power limit; report the card's limit beside any share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "peak_tflops": 989.0,        # bf16 / fp16 tensor cores
        "peak_tflops_fp8": 1979.0,
        "peak_hbm_gbps": 3350.0,
    },
}


def device_peaks(device=None) -> Dict[str, float]:
    """The published peaks of `device` (default: the first device).
    A device without a row is an error: no peak is assumed."""
    dev = device or jax.devices()[0]
    kind = getattr(dev, "device_kind", "")
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return {"device_kind": kind, **PEAKS[kind]}


def card_lines() -> List[str]:
    """Each card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    reports them. A card may be set below its maximum power and then runs
    slower under load, so every measurement is recorded beside these."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()


def time_stats(fn: Callable, *args, repeats: int = 10, warmup: int = 2,
               **kwargs) -> Tuple[float, float, float]:
    """(median, first quartile, third quartile) wall seconds per call of
    fn(*args, **kwargs), each call ended by block_until_ready; the
    warmup calls (which compile) are excluded."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return float(med), float(q1), float(q3)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
            **kwargs) -> float:
    """Median wall seconds per call (see time_stats)."""
    return time_stats(fn, *args, repeats=iters, warmup=warmup, **kwargs)[0]


def attention_flops(b: int, h: int, nq: int, nk: int, d: int,
                    causal: bool = False, backward: bool = False) -> float:
    """Matmul FLOPs of one attention call: 2 matmuls fwd (QKᵀ, PV),
    5 bwd (recompute S, dP, dV, dK, dQ), 2·n·d MACs each."""
    pairs = b * h * nq * nk * (0.5 if causal else 1.0)
    n_matmuls = 5 if backward else 2
    return 2.0 * pairs * d * n_matmuls


def memory_stats(device=None) -> Dict[str, int]:
    dev = device or jax.devices()[0]
    stats = dev.memory_stats() or {}
    return {k: v for k, v in stats.items()
            if "bytes" in k or "limit" in k}
