"""Ladder stage 00 — sharded vector add + psum checksum.

Counterpart of the reference's MPI vecadd smoke test
(ref: src/03_flash_attention_v2_ring/00_mpi_vecadd.cu:9-152): it proves
process/mesh bootstrap, per-device work placement, kernel timing, and a
cross-device reduction — before any attention enters the picture.

  MPI rank split w/ remainder (:58-61)  → PartitionSpec sharding (XLA pads)
  cudaEvent elapsed ms (:89-98)         → utils.timing.time_fn
  MPI_Reduce checksum (:122-138)        → jax.lax.psum inside shard_map

The reference's success/failure print is inverted (:131-137, SURVEY.md
"quirks"); this one is not.
"""

import _common  # noqa: F401  (must precede jax import)

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cuda_flashattention_tpu.parallel.mesh import make_mesh
from cuda_flashattention_tpu.utils.timing import time_fn


def main() -> int:
    _, devices = _common.bootstrap()
    mesh = make_mesh((len(devices),), ("dp",), devices)
    n = 1_000_000  # ref uses 1M elements (00_mpi_vecadd.cu:13)

    a = jnp.arange(n, dtype=jnp.float32)
    b = jnp.ones((n,), jnp.float32) * 2.0
    sharding = NamedSharding(mesh, P("dp"))
    a = jax.device_put(a, sharding)
    b = jax.device_put(b, sharding)

    def local_add_and_checksum(a, b):
        c = a + b
        return c, jax.lax.psum(jnp.sum(c), "dp")

    f = jax.jit(jax.shard_map(
        local_add_and_checksum, mesh=mesh, in_specs=(P("dp"), P("dp")),
        out_specs=(P("dp"), P())))
    c, checksum = f(a, b)

    dt = time_fn(lambda: f(a, b)[0], iters=5)
    print(f"vecadd over {len(devices)} devices: {dt*1e3:.3f} ms "
          f"({n} elements)")

    expected = float(np.sum(np.arange(n, dtype=np.float64) + 2.0))
    ok = abs(float(checksum) - expected) < 1e-3 * abs(expected)
    ok &= bool(jnp.allclose(c[:5], jnp.arange(5, dtype=jnp.float32) + 2.0))
    return _common.report("00_psum_vecadd", ok)


if __name__ == "__main__":
    sys.exit(main())
