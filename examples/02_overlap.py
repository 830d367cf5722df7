"""Ladder stage 02 — compute/communication overlap microbenchmark.

Counterpart of the reference's dual-stream overlap template
(ref: src/03_flash_attention_v2_ring/02_overlap.cu:9-114): double-buffered
KV blocks rotate around the ring WHILE a compute kernel chews on the
resident block; after n steps the result must equal the sequential answer.

There are no user-managed streams: the ppermute for step k+1 is issued
before step k's matmul AND pinned to it with
`jax.lax.optimization_barrier`, since issuing alone lets XLA's scheduler
drain a bare serial permute chain back-to-back before any compute
(docs/MEMO.md #5). Wall-clock for the overlapped loop is printed like
the reference's chrono timing (:61,94-101); whether a collective is
really hidden is a question for a profiler trace of the ring on the
cards (ROADMAP.md).
"""

import _common  # noqa: F401

import sys

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cuda_flashattention_tpu.parallel.mesh import make_mesh
from cuda_flashattention_tpu.utils.timing import time_fn


def main() -> int:
    _, devices = _common.bootstrap()
    n_dev = len(devices)
    mesh = make_mesh((n_dev,), ("ring",), devices)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    rows, d = 256, 128  # per-shard "KV block" and a stand-in weight

    def overlapped(kv, w):
        # simulated attention compute (ref: 02_overlap.cu:64-92 uses a
        # dummy kernel): acc += kv @ w each step while kv rotates
        acc = jnp.zeros((rows, d), jnp.float32)
        cur = kv
        for step in range(n_dev):
            if step < n_dev - 1:
                nxt = jax.lax.ppermute(cur, "ring", perm)  # comm "stream"
            acc = acc + jnp.dot(cur, w,
                                preferred_element_type=jnp.float32)
            if step < n_dev - 1:
                # pin the transfer in flight DURING this step's compute
                # (without this the scheduler drains the chain first —
                # MEMO #5; same barrier as parallel/ring.py)
                nxt, acc = jax.lax.optimization_barrier((nxt, acc))
                cur = nxt
        return acc

    def sequential_ref(kv_all, w):
        # ground truth: sum over every shard's block (order-independent)
        return jnp.einsum("srd,de->re", kv_all, w)

    kv = jax.random.uniform(jax.random.PRNGKey(0), (n_dev, rows, d),
                            jnp.float32, -0.5, 0.5)
    w = jax.random.uniform(jax.random.PRNGKey(1), (d, d), jnp.float32,
                           -0.5, 0.5)

    # shard_map hands each shard its (1, rows, d) slice; drop the axis.
    # out_specs is replicated: after n_dev steps every shard holds the
    # same full sum.
    g = jax.jit(jax.shard_map(
        lambda kv, w: overlapped(kv[0], w), mesh=mesh,
        in_specs=(P("ring", None, None), P(None, None)),
        out_specs=P(None, None), check_vma=False))

    out = g(kv, w)
    ref = sequential_ref(kv, w)
    dt = time_fn(lambda: g(kv, w), iters=5)
    print(f"overlap loop over {n_dev} devices: {dt*1e3:.3f} ms "
          f"({rows}x{d} block per shard)")

    ok = bool(jnp.max(jnp.abs(out - ref)) < 1e-3)
    return _common.report("02_overlap", ok)


if __name__ == "__main__":
    sys.exit(main())
