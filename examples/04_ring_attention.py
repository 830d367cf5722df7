"""Ladder stage 04 — full distributed ring attention vs the oracle.

Counterpart of the reference's final ladder stage
(ref: src/03_flash_attention_v2_ring/04_ring_attention.cu:9-154):

  naive oracle on rank 0 + MPI_Bcast (:27-46)  → replicated oracle call
  row-shard Q/K/V across ranks (:66-84)        → device_put w/ PartitionSpec
  ring_attention_forward (:103-107)            → parallel.ring.ring_attention
  MPI_Gather to rank 0 (:124-126)              → the sharded result is one
                                                  logical array; comparison
                                                  happens on replicated host
  compare rtol 5e-3 (:134-135)                 → utils.testing.compare_outputs

Extensions the reference lacks: the same run also checks the CAUSAL ring
(per-step full/diagonal/skip dispatch) and the ring BACKWARD against
jax.grad of the oracle.

The reference requires seq % nranks == 0 (:56-63); seq=5096 divides the
8-device default mesh (637 rows per shard — and 637 is not tile-divisible,
so the in-kernel masking gets exercised too).
"""

import _common  # noqa: F401

import sys

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.ops.naive import (
    naive_attention,
    naive_attention_backward,
)
from cuda_flashattention_tpu.parallel.mesh import make_mesh, shard_on_axis
from cuda_flashattention_tpu.parallel.ring import ring_attention
from cuda_flashattention_tpu.utils.testing import (
    compare_outputs,
    seeded_random,
)

# seq is the reference shape by default; CI shrinks it via env
SEQ = int(__import__("os").environ.get("CFA_LADDER_SEQ", "5096"))
D, SCALE = 64, 1.0


def main() -> int:
    _, devices = _common.bootstrap()
    n_dev = len(devices)
    while SEQ % n_dev != 0:
        n_dev -= 1  # degrade to the largest device count dividing SEQ
    if n_dev != len(devices):
        print(f"seq {SEQ} % devices {len(devices)} != 0 — the reference "
              f"aborts here (:56-63); using {n_dev} devices instead")
    mesh = make_mesh((n_dev,), ("sp",), devices[:n_dev])

    q = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=42)) * 0.1
    k = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=43)) * 0.1
    v = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=44))
    qs = shard_on_axis(mesh, q, 2, "sp")
    ks = shard_on_axis(mesh, k, 2, "sp")
    vs = shard_on_axis(mesh, v, 2, "sp")

    ok = True

    # --- forward, full attention (the reference's only mode) ---
    o = ring_attention(qs, ks, vs, mesh=mesh, axis_name="sp", scale=SCALE)
    o_ref, _ = naive_attention(q, k, v, scale=SCALE)
    ok &= compare_outputs(o, o_ref, rtol=5e-3, atol=1e-3,
                          name="ring fwd (full)")

    # --- forward, causal (capability the reference lacks) ---
    oc = ring_attention(qs, ks, vs, mesh=mesh, axis_name="sp", scale=SCALE,
                        causal=True)
    oc_ref, _ = naive_attention(q, k, v, scale=SCALE, causal=True)
    ok &= compare_outputs(oc, oc_ref, rtol=5e-3, atol=1e-3,
                          name="ring fwd (causal)")

    # --- backward through the ring (capability the reference lacks) ---
    do = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=45))

    def loss(q, k, v):
        o = ring_attention(q, k, v, mesh=mesh, axis_name="sp", scale=SCALE,
                           causal=True)
        return jnp.sum(o.astype(jnp.float32) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(qs, ks, vs)
    dq_ref, dk_ref, dv_ref = naive_attention_backward(
        q, k, v, do, scale=SCALE, causal=True)
    ok &= compare_outputs(dq, dq_ref, rtol=5e-3, atol=1e-2, name="ring dQ")
    ok &= compare_outputs(dk, dk_ref, rtol=5e-3, atol=1e-2, name="ring dK")
    ok &= compare_outputs(dv, dv_ref, rtol=5e-3, atol=1e-2, name="ring dV")

    return _common.report("04_ring_attention", ok)


if __name__ == "__main__":
    sys.exit(main())
