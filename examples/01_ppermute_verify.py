"""Ladder stage 01 — ring topology verification via ppermute.

Counterpart of the reference's NCCL ring verifier
(ref: src/03_flash_attention_v2_ring/01_nccl_verify.cu:9-67): each rank
fills a buffer with its own id, the buffer is passed around the ring
n_devices times, and at every step each rank checks the buffer it holds
came from the expected source rank. `ncclSend/ncclRecv` inside
ncclGroupStart/End (ref: nccl_utils.h:115-121) become one
`jax.lax.ppermute` per step.
"""

import _common  # noqa: F401

import sys

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cuda_flashattention_tpu.parallel.mesh import make_mesh


def main() -> int:
    _, devices = _common.bootstrap()
    n_dev = len(devices)
    mesh = make_mesh((n_dev,), ("ring",), devices)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def ring_check(_):
        me = jax.lax.axis_index("ring")
        buf = jnp.full((8, 128), me, jnp.int32)  # rank-tagged payload
        bad = jnp.zeros((), jnp.int32)
        for step in range(1, n_dev + 1):
            buf = jax.lax.ppermute(buf, "ring", perm)
            src = (me - step) % n_dev  # provenance (ref: 01_nccl_verify.cu:42-59)
            bad = bad + jnp.sum(jnp.where(buf != src, 1, 0))
        # after a full loop the buffer must be home again
        bad = bad + jnp.sum(jnp.where(buf != me, 1, 0))
        return jax.lax.psum(bad, "ring")

    f = jax.jit(jax.shard_map(
        ring_check, mesh=mesh,
        in_specs=(P("ring"),), out_specs=P()))
    bad = f(jnp.zeros((n_dev,), jnp.int32))
    print(f"ring of {n_dev} devices: {int(bad)} provenance mismatches")
    return _common.report("01_ppermute_verify", int(bad) == 0)


if __name__ == "__main__":
    sys.exit(main())
