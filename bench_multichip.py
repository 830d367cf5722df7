"""Multi-card ring-scaling benchmark: ring prefill and sharded-KV decode
timed at 1, 2, 4, ... cards.

The reference instruments its ring loop with wall-clock timing
(ref: 02_overlap.cu:61,94-101) but owns no fixed cluster; this harness
runs on WHATEVER devices are visible —
  * the GPUs of one host (one process drives them all): real numbers;
  * a virtual CPU mesh (`--cpu`, XLA_FLAGS=
    --xla_force_host_platform_device_count=8): validates the measurement
    path mechanically at toy sizes, kernels in the Pallas interpreter
    (the printed numbers are NOT device numbers there — the backend
    field says which).

Measures, for each device count n (1, 2, 4, ... ≤ #devices):
  * ring PREFILL, causal, fixed GLOBAL sequence (strong scaling):
    TFLOP/s and efficiency vs n=1;
  * sharded-KV DECODE at the longest context that fits (int8 KV,
    target 1M tokens on ≥4 chips): tokens/s and efficiency.

Prints one JSON line per measurement; each time is the median of
block_until_ready-bracketed calls after warmup (utils/timing.time_stats).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuda_flashattention_tpu.parallel.ring import ring_attention, ring_decode
from cuda_flashattention_tpu.utils.compile_cache import enable_compile_cache
from cuda_flashattention_tpu.utils.timing import attention_flops, time_stats


def bench_prefill(n: int, seq: int, heads: int, d: int, causal: bool,
                  iters: int):
    devices = np.array(jax.devices()[:n])
    mesh = Mesh(devices.reshape(n), ("sp",))
    rng = np.random.default_rng(0)

    def mk():
        x = rng.standard_normal((1, heads, seq, d)).astype(np.float32)
        arr = jnp.asarray(x, jnp.bfloat16)
        return jax.device_put(arr, NamedSharding(mesh, P(None, None, "sp")))

    q, k, v = mk(), mk(), mk()

    @jax.jit
    def step(x):
        return ring_attention(x, k, v, mesh=mesh, causal=causal)

    t = time_stats(step, q, repeats=iters, warmup=2)[0]
    flops = attention_flops(1, heads, seq, seq, d, causal=causal)
    return t, flops / t / 1e12


def bench_decode(n: int, ctx: int, heads: int, d: int, iters: int):
    devices = np.array(jax.devices()[:n])
    mesh = Mesh(devices.reshape(n), ("sp",))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    kv_spec = NamedSharding(mesh, P(None, None, "sp", None))
    k = jax.device_put(
        jax.random.randint(keys[0], (1, heads, ctx, d), -127, 128,
                           jnp.int8), kv_spec)
    v = jax.device_put(
        jax.random.randint(keys[1], (1, heads, ctx, d), -127, 128,
                           jnp.int8), kv_spec)
    sc_spec = NamedSharding(mesh, P(None, None, "sp"))
    sc = jax.device_put(jnp.full((1, heads, ctx), 1 / 127, jnp.float32),
                        sc_spec)
    q = jax.device_put(
        jax.random.uniform(keys[2], (1, heads, d), jnp.bfloat16, -0.5, 0.5),
        NamedSharding(mesh, P()))

    @jax.jit
    def step(x):
        o, _ = ring_decode(x, k, v, ctx, mesh=mesh, k_scale=sc, v_scale=sc)
        return o.astype(jnp.bfloat16)

    t = time_stats(step, q, repeats=iters, warmup=2)[0]
    return t, 1.0 / t


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1 << 17,
                    help="global prefill sequence (strong scaling)")
    ap.add_argument("--decode-ctx", type=int, default=1 << 20)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--max-devices", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="virtual CPU mesh validation (pair with XLA_FLAGS="
                    "--xla_force_host_platform_device_count=N)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        os.environ["CFA_PALLAS_INTERPRET"] = "1"
    enable_compile_cache()

    backend = jax.default_backend()
    n_avail = len(jax.devices())
    if args.max_devices:
        n_avail = min(n_avail, args.max_devices)
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    virtual = backend != "gpu"

    # the interpreter at 128k/1M would take hours — shrink mechanically
    # (tiny shapes: this mode only validates the measurement path)
    heads = args.heads if not virtual else 2
    seq = args.seq if not virtual else 512
    dctx = args.decode_ctx if not virtual else 2048
    iters = args.iters if not virtual else 2
    args.heads = heads

    def emit(row, measured):
        # a virtual mesh validates the path; its times are no device's
        row.update({k: "not measured (virtual mesh)" for k in measured}
                   if virtual else measured)
        print(json.dumps(row), flush=True)

    results = {"prefill": {}, "decode": {}}
    for n in counts:
        t, tf = bench_prefill(n, seq, args.heads, args.d, causal=True,
                              iters=iters)
        results["prefill"][n] = (t, tf)
        base_t = results["prefill"][counts[0]][0]
        eff = base_t / (n * t)
        emit({
            "bench": "ring_prefill_strong", "backend": backend,
            "virtual_mesh": virtual, "devices": n, "seq": seq,
            "heads": args.heads, "d": args.d}, {
            "wall_s": round(t, 4), "tflops_total": round(tf, 2),
            "scaling_efficiency_vs_1": round(eff, 4)})
    for n in counts:
        t, tok = bench_decode(n, dctx, args.heads, args.d, iters=iters)
        results["decode"][n] = (t, tok)
        base_t = results["decode"][counts[0]][0]
        eff = base_t / t / n  # strong scaling: same ctx, n× chips
        emit({
            "bench": "ring_decode_sharded_kv_int8", "backend": backend,
            "virtual_mesh": virtual, "devices": n, "ctx": dctx}, {
            "wall_s": round(t, 5), "tokens_per_s": round(tok, 1),
            "speedup_vs_1": round(base_t / t, 3),
            "scaling_efficiency_vs_1": round(eff, 4)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
