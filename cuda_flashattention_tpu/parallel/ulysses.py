"""Ulysses-style sequence parallelism: all-to-all over heads.

The second standard long-context strategy (DeepSpeed-Ulysses,
arXiv 2309.14509) — SURVEY.md §2.4 notes the reference has "no Ulysses
(no all-to-all on heads)"; this module adds it as an alternative to the
ring (parallel/ring.py):

  ring:    KV shards rotate; O(n_shards) steps of compute+permute;
           comm volume ~ 2·N·d per device per layer, overlappable.
  ulysses: ONE all-to-all re-shards activations from sequence-sharded
           [B, H, N/s, d] to head-sharded [B, H/s, N, d], each device
           runs plain local attention over the FULL sequence for its
           head subset, and one all-to-all converts back. Comm volume
           ~ 2·(N/s)·H·d per device, in two dense collectives that ride
           NVLink at full bandwidth. Requires H % n_shards == 0 (heads must
           shard); the ring has no such constraint — pick per topology.

Differentiable for free: `jax.lax.all_to_all` is linear, so autodiff
reverses it — no custom VJP needed (the local attention inside already
carries one). Composes with every kernel feature: causal, window, GQA
(with head replication when Hkv doesn't divide the axis — KV heads are
repeated just enough to shard, trading comm for generality), and packed
segment ids (ids are all-gathered along the axis so every shard masks
against the full sequence — ids are N bytes where K/V are N·d, so the
gather is noise).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cuda_flashattention_tpu.ops.attention import flash_attention
from cuda_flashattention_tpu.ops.common import BlockSizes, resolve_scale


def ulysses_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "sp",
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    block_sizes: Optional[BlockSizes] = None,
    batch_axis: Optional[str] = None,
    segment_ids: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Sequence-parallel attention via head all-to-all: q/k/v [B,H,N,d]
    sharded on N over `axis_name` → O with the same sharding.

    Seq and q-head counts must divide the axis. GQA: when Hkv doesn't
    divide the axis, KV heads are replicated by the minimal factor that
    does (e.g. Hkv=2 on 8 shards → 4× → each shard owns one replica);
    the replication must divide the GQA group so query heads still land
    with their KV head. `segment_ids` [B, N] (same N-sharding) enables
    packed-sequence masking. Differentiable end to end.
    """
    n_shards = mesh.shape[axis_name]
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    if h % n_shards:
        raise ValueError(
            f"ulysses needs q heads {h} divisible by the "
            f"'{axis_name}' axis ({n_shards}); use the ring otherwise")
    n_orig = n
    if n % n_shards:
        # Ragged sequences: pad to the all-to-all grid (SURVEY §7(e) —
        # the reference asserts divisibility, 04_ring_attention.cu:56-63).
        # Causal needs no masking (pad rows sit past every real row, so
        # no real query ever sees a pad key); non-causal threads
        # pad-marking segment ids — pad rows get id −1, matching no real
        # row (pad-vs-pad matches are harmless: those outputs are sliced
        # off below).
        n = -(-n // n_shards) * n_shards
        pad = [(0, 0), (0, 0), (0, n - n_orig), (0, 0)]
        q, k, v = jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad)
        if segment_ids is None and not causal:
            segment_ids = jnp.zeros((b, n_orig), jnp.int32)
        if segment_ids is not None:
            segment_ids = jnp.pad(
                jnp.asarray(segment_ids, jnp.int32),
                [(0, 0), (0, n - n_orig)], constant_values=-1)
    if h_kv % n_shards:
        # head-replication fallback: repeat each KV head `rep` times so
        # the total shards evenly; query-head grouping survives iff rep
        # divides the GQA group
        import math
        rep = n_shards // math.gcd(h_kv, n_shards)
        if (h // h_kv) % rep:
            raise ValueError(
                f"kv heads {h_kv} don't divide the axis ({n_shards}) and "
                f"the needed replication {rep} doesn't divide the GQA "
                f"group {h // h_kv}; use the ring")
        k = jnp.repeat(k, rep, axis=1)
        v = jnp.repeat(v, rep, axis=1)
        h_kv *= rep
    scale = resolve_scale(scale, d)
    segmented = segment_ids is not None

    def local(q, k, v, *seg):
        # [B, H, N/s, d] per shard → all_to_all splits heads and
        # concatenates sequence: [B, H/s, N, d]
        qh = jax.lax.all_to_all(q, axis_name, split_axis=1, concat_axis=2,
                                tiled=True)
        kh = jax.lax.all_to_all(k, axis_name, split_axis=1, concat_axis=2,
                                tiled=True)
        vh = jax.lax.all_to_all(v, axis_name, split_axis=1, concat_axis=2,
                                tiled=True)
        seg_kw = {}
        if segmented:
            # ids have no head axis to trade: gather the full sequence
            # of ids on every shard (N ints vs N·d activations — noise)
            ids = jax.lax.all_gather(seg[0], axis_name, axis=1,
                                     tiled=True)
            seg_kw = dict(q_segment_ids=ids, kv_segment_ids=ids)
        o = flash_attention(qh, kh, vh, scale=scale, causal=causal,
                            window=window, block_sizes=block_sizes,
                            **seg_kw)
        # back to sequence-sharded: split sequence, gather heads
        return jax.lax.all_to_all(o, axis_name, split_axis=2,
                                  concat_axis=1, tiled=True)

    spec = P(batch_axis, None, axis_name, None)
    if segmented:
        f = jax.shard_map(
            local, mesh=mesh,
            in_specs=(spec, spec, spec, P(batch_axis, axis_name)),
            out_specs=spec, check_vma=False)
        out = f(q, k, v, jnp.asarray(segment_ids, jnp.int32))
    else:
        f = jax.shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                          out_specs=spec, check_vma=False)
        out = f(q, k, v)
    return out[:, :, :n_orig]
