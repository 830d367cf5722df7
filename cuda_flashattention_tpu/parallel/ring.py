"""Ring (sequence-parallel) attention over a device mesh.

Re-design of the reference's ring attention
(ref: src/03_flash_attention_v2_ring/common/ring_attention_kernel.cu:13-239
and 04_ring_attention.cu:9-154). Capability parity, different machinery:

  CUDA reference                          → this module
  ---------------------------------------   ------------------------------
  MPI process per GPU, NCCL comm            shard_map over a Mesh axis
  row-shard Q/K/V per rank (04:66-84)       PartitionSpec over the seq dim
  ncclSend/Recv K,V to next rank on a       jax.lax.ppermute — XLA emits
    comm stream (ring_exchange_kv,            collective-permute (NCCL)
    nccl_utils.h:133-142)
  unnormalised O + l,m state reloaded        per-step (O_i, LSE_i) pairs
    from HBM each step, normalise on          combined by exact logsumexp
    last step (ring kernel :64-79,109-139)    weighting (log-space, which
                                              sidesteps the fp drift the
                                              reference memoises about —
                                              memo.md:5)
  dual streams + cudaDeviceSynchronize       permute issued before the
    per step (:192-220, a full join!)          step's kernel; XLA schedules
                                              the collective concurrently
  no causal support, forward only            causal via per-step
    (SURVEY.md §2.3)                          full/diagonal/skip dispatch;
                                              full backward (custom_vjp)
                                              with rotating dK/dV

The backward is the standard ring-attention gradient: each (Q-shard,
KV-block) pair contributes flash-backward partials computed against the
GLOBAL LSE; dK/dV accumulators travel around the ring with their KV block
and land home after a final permute. The reference has no distributed
backward at all — this is new capability, same design language.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from cuda_flashattention_tpu.ops.common import (
    NEG_INF,
    BlockSizes,
    combine_partials,
    resolve_scale,
)
from cuda_flashattention_tpu.ops.decode import decode_attention
from cuda_flashattention_tpu.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward


def _step_fwd(q, k, v, kv_idx, my_idx, *, scale, causal, window, step,
              shard_len, block_sizes, qseg=None, kseg=None):
    """One ring step's local attention with causal block dispatch.

    For equal sequence shards, global causality reduces to three static
    cases (so masks stay compile-time): KV block strictly behind the Q
    shard → full attention (bounded below by the sliding window when one
    is set: the global window constraint col > row − W maps exactly onto
    the kernel's causal+window mask with kv_offset = step·L, since at
    ring distance `step` every local column sits step·L before the local
    row); same block → local causal (windowed); strictly ahead → skip
    (zero output, −inf LSE)."""
    kw = dict(scale=scale, block_sizes=block_sizes, out_dtype=jnp.float32)

    if not causal:
        # ragged global seq (padded to the shard grid): the pad tail is
        # masked via segment ids, which rotate with their KV shard
        return flash_attention_forward(
            q, k, v, causal=False, q_segment_ids=qseg,
            kv_segment_ids=kseg, **kw)

    def full_fn(args):
        if window:
            return flash_attention_forward(
                *args, causal=True, window=window,
                kv_offset=step * shard_len, **kw)
        return flash_attention_forward(*args, causal=False, **kw)

    def diag_fn(args):
        return flash_attention_forward(*args, causal=True, window=window,
                                       **kw)

    def skip_fn(args):
        qq = args[0]
        b, h, n, d = qq.shape
        return (jnp.zeros((b, h, n, d), jnp.float32),
                jnp.full((b, h, n), NEG_INF, jnp.float32))

    branch = jnp.where(kv_idx < my_idx, 0,
                       jnp.where(kv_idx == my_idx, 1, 2))
    return jax.lax.switch(branch, [full_fn, diag_fn, skip_fn], (q, k, v))


def _step_bwd(q, k, v, o, lse, do, kv_idx, my_idx, *, scale, causal,
              window, step, shard_len, block_sizes, qseg=None, kseg=None):
    """One ring step's gradient partials (vs the global LSE)."""
    kw = dict(scale=scale, block_sizes=block_sizes)

    if not causal:
        return flash_attention_backward(
            q, k, v, o, lse, do, causal=False, q_segment_ids=qseg,
            kv_segment_ids=kseg, **kw)

    def full_fn(args):
        if window:
            return flash_attention_backward(
                *args, causal=True, window=window,
                kv_offset=step * shard_len, **kw)
        return flash_attention_backward(*args, causal=False, **kw)

    def diag_fn(args):
        return flash_attention_backward(*args, causal=True, window=window,
                                        **kw)

    def skip_fn(args):
        qq, kk, vv = args[0], args[1], args[2]
        return (jnp.zeros_like(qq), jnp.zeros_like(kk), jnp.zeros_like(vv))

    branch = jnp.where(kv_idx < my_idx, 0,
                       jnp.where(kv_idx == my_idx, 1, 2))
    return jax.lax.switch(branch, [full_fn, diag_fn, skip_fn],
                          (q, k, v, o, lse, do))


def _make_ring_local(axis_name: str, n_shards: int, scale: float,
                     causal: bool, window: int, shard_len: int,
                     block_sizes, ragged: bool = False):
    """Build the per-shard ring function (runs inside shard_map).

    `ragged=True` (non-causal only): the global sequence was padded up to
    the shard grid and per-token segment ids mark the pad tail; kv ids
    rotate around the ring with their shard. Causal ragged needs no ids —
    pad rows sit at the END of the global sequence, so no REAL query row
    can ever see a pad key under the causal mask, and pad-row outputs are
    sliced off by the wrapper."""
    # Send to the next rank, receive from the previous — the same ring
    # orientation as the reference (ref: nccl_utils.h:115-121).
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    # Sliding window: a window of W tokens reaches back at most
    # ceil(W/L) shards, so the ring terminates after that many hops —
    # ring traffic AND compute scale with the window, not the context.
    if causal and window:
        max_steps = min(n_shards, -(-window // shard_len) + 1)
    else:
        max_steps = n_shards
    # after max_steps-1 rotations, rank i holds the accumulator for KV
    # shard (i - max_steps + 1); one permute sends it home
    perm_home = [(i, (i - (max_steps - 1)) % n_shards)
                 for i in range(n_shards)]

    @jax.custom_vjp
    def ring_local(q, k, v, qseg, kseg):
        o, _ = _ring_fwd(q, k, v, qseg, kseg)
        return o.astype(q.dtype)

    def _ring_fwd(q, k, v, qseg, kseg):
        my_idx = jax.lax.axis_index(axis_name)
        o = None
        lse = None
        k_cur, v_cur = k, v
        for step in range(max_steps):
            # Issue next shard's transfer BEFORE this step's compute, and
            # TIE the permute results to this step's outputs with an
            # optimization barrier below. Issuing first is not enough:
            # without the barrier XLA's scheduler may drain the whole
            # permute chain back-to-back BEFORE any kernel (zero
            # overlap). With it each transfer is in flight during the
            # step's compute, the dual-stream pattern the reference
            # builds by hand (ref: ring_attention_kernel.cu:192-218).
            if step < max_steps - 1:
                k_nxt = jax.lax.ppermute(k_cur, axis_name, perm)
                v_nxt = jax.lax.ppermute(v_cur, axis_name, perm)
                if ragged:
                    ks_nxt = jax.lax.ppermute(kseg, axis_name, perm)
            kv_idx = (my_idx - step) % n_shards
            o_s, lse_s = _step_fwd(
                q, k_cur, v_cur, kv_idx, my_idx, scale=scale, causal=causal,
                window=window, step=step, shard_len=shard_len,
                block_sizes=block_sizes,
                qseg=qseg if ragged else None,
                kseg=kseg if ragged else None)
            if step < max_steps - 1:
                if ragged:
                    # kseg's permute must ride the same barrier as k/v —
                    # outside it, XLA is free to schedule the segment-id
                    # transfer serially (the exact un-overlapped pattern
                    # the barrier exists to prevent)
                    k_nxt, v_nxt, ks_nxt, o_s, lse_s = (
                        jax.lax.optimization_barrier(
                            (k_nxt, v_nxt, ks_nxt, o_s, lse_s)))
                    kseg = ks_nxt
                else:
                    k_nxt, v_nxt, o_s, lse_s = (
                        jax.lax.optimization_barrier(
                            (k_nxt, v_nxt, o_s, lse_s)))
            if o is None:
                o, lse = o_s, lse_s
            else:
                o, lse = combine_partials(o, lse, o_s, lse_s)
            if step < max_steps - 1:
                k_cur, v_cur = k_nxt, v_nxt
        return o, lse

    def ring_fwd_vjp(q, k, v, qseg, kseg):
        o, lse = _ring_fwd(q, k, v, qseg, kseg)
        return o.astype(q.dtype), (q, k, v, o.astype(q.dtype), lse,
                                   qseg, kseg)

    def ring_bwd_vjp(res, do):
        q, k, v, o, lse, qseg, kseg = res
        my_idx = jax.lax.axis_index(axis_name)
        dq = jnp.zeros(q.shape, jnp.float32)
        dk_cur = jnp.zeros(k.shape, jnp.float32)
        dv_cur = jnp.zeros(v.shape, jnp.float32)
        k_cur, v_cur = k, v
        for step in range(max_steps):
            # K/V for the NEXT step start rotating before this step's
            # backward kernels; the barrier after the compute keeps the
            # transfers in flight during it (see _ring_fwd). dK/dV
            # accumulators travel AFTER the step (they're updated by it).
            if step < max_steps - 1:
                k_nxt = jax.lax.ppermute(k_cur, axis_name, perm)
                v_nxt = jax.lax.ppermute(v_cur, axis_name, perm)
                if ragged:
                    ks_nxt = jax.lax.ppermute(kseg, axis_name, perm)
            kv_idx = (my_idx - step) % n_shards
            dq_s, dk_s, dv_s = _step_bwd(
                q, k_cur, v_cur, o, lse, do, kv_idx, my_idx, scale=scale,
                causal=causal, window=window, step=step,
                shard_len=shard_len, block_sizes=block_sizes,
                qseg=qseg if ragged else None,
                kseg=kseg if ragged else None)
            if step < max_steps - 1:
                if ragged:
                    k_nxt, v_nxt, ks_nxt, dq_s, dk_s, dv_s = (
                        jax.lax.optimization_barrier(
                            (k_nxt, v_nxt, ks_nxt, dq_s, dk_s, dv_s)))
                else:
                    k_nxt, v_nxt, dq_s, dk_s, dv_s = (
                        jax.lax.optimization_barrier(
                            (k_nxt, v_nxt, dq_s, dk_s, dv_s)))
            dq = dq + dq_s.astype(jnp.float32)
            dk_cur = dk_cur + dk_s.astype(jnp.float32)
            dv_cur = dv_cur + dv_s.astype(jnp.float32)
            if step < max_steps - 1:
                # dK/dV accumulators travel WITH their KV block.
                k_cur, v_cur = k_nxt, v_nxt
                if ragged:
                    kseg = ks_nxt
                dk_cur = jax.lax.ppermute(dk_cur, axis_name, perm)
                dv_cur = jax.lax.ppermute(dv_cur, axis_name, perm)
        # One final permute sends each accumulated dK/dV shard home
        # (a single hop when the ring ran full circle).
        dk_home = jax.lax.ppermute(dk_cur, axis_name, perm_home)
        dv_home = jax.lax.ppermute(dv_cur, axis_name, perm_home)
        f0 = jax.dtypes.float0
        return (dq.astype(q.dtype), dk_home.astype(k.dtype),
                dv_home.astype(v.dtype),
                np.zeros(qseg.shape, f0) if qseg is not None else None,
                np.zeros(kseg.shape, f0) if kseg is not None else None)

    ring_local.defvjp(ring_fwd_vjp, ring_bwd_vjp)
    return ring_local


def ring_attention(
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
    head_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Sequence-parallel attention: q/k/v [B,H,N,d] sharded on N over
    `axis_name`. Differentiable (custom ring backward). Counterpart of
    `ring_attention_forward` + the missing distributed backward
    (ref: ring_attention_kernel.cu:143-239).

    Composes with data and tensor parallelism: `batch_axis` shards B and
    `head_axis` shards H (heads are independent, so the local ring code is
    unchanged — only the shard_map specs widen). Ring traffic stays on
    `axis_name`.

    Sequence lengths that do NOT divide the axis are padded up to the
    shard grid (the reference asserts divisibility instead — SURVEY §7(e),
    ref: 04_ring_attention.cu:56-63): causal needs no masks (pad rows sit
    past every real row), non-causal threads pad-marking segment ids
    around the ring."""
    n_shards = mesh.shape[axis_name]
    b, h, n, d = q.shape
    if h % k.shape[1] != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True")
    scale = resolve_scale(scale, d)

    n_pad = -(-n // n_shards) * n_shards
    ragged = n_pad != n and not causal
    if n_pad != n:
        pad = [(0, 0), (0, 0), (0, n_pad - n), (0, 0)]
        q, k, v = jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad)

    ring_local = _make_ring_local(axis_name, n_shards, scale, causal,
                                  window, n_pad // n_shards, block_sizes,
                                  ragged=ragged)
    spec = P(batch_axis, head_axis, axis_name, None)
    if ragged:
        # pad q rows get id -1, pad kv rows -2: they match nothing
        ids = jnp.arange(n_pad)[None, :]
        qseg = jnp.where(ids < n, 0, -1).astype(jnp.int32)
        kseg = jnp.where(ids < n, 0, -2).astype(jnp.int32)
        qseg = jnp.broadcast_to(qseg, (b, n_pad))
        kseg = jnp.broadcast_to(kseg, (b, n_pad))
        sspec = P(batch_axis, axis_name)
        f = jax.shard_map(
            ring_local, mesh=mesh,
            in_specs=(spec, spec, spec, sspec, sspec),
            out_specs=spec, check_vma=False)
        out = f(q, k, v, qseg, kseg)
    else:
        f = jax.shard_map(
            lambda q, k, v: ring_local(q, k, v, None, None), mesh=mesh,
            in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
        out = f(q, k, v)
    return out[:, :, :n]


def ring_decode_local(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    lengths,
    axis_name: str = "sp",
    k_scale: Optional[jnp.ndarray] = None,
    v_scale: Optional[jnp.ndarray] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
    windows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sharded-KV decode, called INSIDE shard_map: each shard attends its
    resident (possibly quantized) KV slice, partials are merged with one
    psum-weighted combine. No rotation — for decode the Qs are tiny and
    the KV stays put, so the pattern is a reduction, not a
    ring. `lengths` is [B] LOCAL live lengths (scalar broadcasts);
    `window`/`windows` as in decode_attention (ring_decode derives the
    per-shard values). Returns replicated (o [B,H,d], lse [B,H])."""
    b = q.shape[0]
    lengths = jnp.broadcast_to(jnp.asarray(lengths, jnp.int32), (b,))
    o_i, lse_i = decode_attention(
        q, k, v, lengths, k_scale=k_scale, v_scale=v_scale, scale=scale,
        block_k=block_k, window=window, windows=windows)
    lse_max = jax.lax.pmax(lse_i, axis_name)
    w = jnp.exp(lse_i - lse_max)
    o_w = jax.lax.psum(o_i * w[..., None], axis_name)
    w_sum = jax.lax.psum(w, axis_name)
    o = o_w / jnp.maximum(w_sum, 1e-30)[..., None]
    lse = lse_max + jnp.log(jnp.maximum(w_sum, 1e-30))
    return o.astype(q.dtype), lse


def ring_decode(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    lengths,
    mesh: Mesh,
    axis_name: str = "sp",
    k_scale: Optional[jnp.ndarray] = None,
    v_scale: Optional[jnp.ndarray] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Global-view wrapper over ring_decode_local: q [B,H,d] replicated,
    k/v [B,Hkv,N,d] sharded on N; `lengths` is the GLOBAL live context —
    a scalar or per-sequence [B] (mixed-length serving batches). Each
    shard derives its local live lengths from its ring position.

    `window` > 0 attends only the last `window` GLOBAL tokens: passing
    the same static window with shard-local lengths is exact, because the
    decode kernel's window cut `col >= length_local - window` equals the
    global cut `g >= length - window` at every shard offset — and shards
    wholly outside the window contribute l = 0 partials.

    Allocate caches with N divisible by the shard count: a non-divisible
    cache is padded here for correctness, and under jit that pad is a
    full-cache HBM copy INSIDE the compiled step — per generated token in
    a serving loop. Divisibility is a one-time allocation choice; the pad
    is the escape hatch, not the intended steady state."""
    n_shards = mesh.shape[axis_name]
    b = q.shape[0]
    n = k.shape[2]
    if n % n_shards != 0:
        # Pad the cache up to the shard grid (the reference asserts
        # divisibility instead — SURVEY §7(e), ref:
        # 04_ring_attention.cu:56-63). Pad rows land past every live
        # token (`lengths` ≤ n), so the decode kernel's length mask
        # already excludes them and the window math below is unchanged.
        n_pad = -(-n // n_shards) * n_shards
        pad = [(0, 0), (0, 0), (0, n_pad - n), (0, 0)]
        k, v = jnp.pad(k, pad), jnp.pad(v, pad)
        if k_scale is not None:
            spad = [(0, 0), (0, 0), (0, n_pad - n)]
            k_scale = jnp.pad(k_scale, spad, constant_values=1.0)
            v_scale = jnp.pad(v_scale, spad, constant_values=1.0)
        n = n_pad
    local_n = n // n_shards
    lengths = jnp.broadcast_to(
        jnp.asarray(lengths, jnp.int32), (b,))

    def local_fn(q, k, v, lengths, *maybe_scales):
        idx = jax.lax.axis_index(axis_name)
        my_len = jnp.clip(lengths - idx * local_n, 0, local_n)
        wins = None
        if window:
            # per-shard effective window: the global cut g >= length - W
            # at local coordinates is col >= my_len - W_i with
            # W_i = my_len - (length - W) + idx*L. Shards fully inside
            # the window get W_i >= my_len (no cut); shards fully before
            # it get W_i <= 0 (nothing visible).
            wins = my_len - lengths + window + idx * local_n
        ks, vs = (maybe_scales if maybe_scales else (None, None))
        return ring_decode_local(
            q, k, v, my_len, axis_name=axis_name, k_scale=ks, v_scale=vs,
            scale=scale, block_k=block_k, window=window, windows=wins)

    rep = P(None, None, None)
    kv_spec = P(None, None, axis_name, None)
    in_specs = [rep, kv_spec, kv_spec, P(None)]
    args = [q, k, v, lengths]
    if k_scale is not None:
        in_specs += [P(None, None, axis_name), P(None, None, axis_name)]
        args += [k_scale, v_scale]
    f = jax.shard_map(local_fn, mesh=mesh, in_specs=tuple(in_specs),
                      out_specs=(rep, P(None, None)), check_vma=False)
    return f(*args)
