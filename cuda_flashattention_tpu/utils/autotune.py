"""Measuring block-size autotuner for the attention kernels.

The reference fixes tile sizes as C++ template parameters and lists
"Auto-tune Br, Bc based on problem size" as future work
(ref: src/02_flash_attention_v2_backward/__info__/IMPLEMENTATION_SUMMARY.md:256,
template params at 02_fwd/flash_attention_kernel.cu:311-315). This module
delivers that item:

  * candidates are the Triton kernels' legal tiles (powers of two ≥ 16)
    whose pipelined K/V tiles fit a block's shared memory
    (the `BlockSizes` defaults stay the zero-cost choice; this tuner is
    the measured upgrade),
  * each candidate is timed on the live device by utils.timing.time_fn
    (median of block_until_ready-bracketed calls after warmup), and
  * results are cached per (device_kind, shape, dtype, causal, mode), both
    in-process and in an on-disk JSON so repeat runs pay nothing. The
    cache key carries a version ("v4") bumped whenever the kernels or the
    timing change, so stale winners can't outlive them.

Usage:
    bs = autotune_block_sizes(nq=16384, nk=16384, d=128)
    o, lse = flash_attention_forward(q, k, v, block_sizes=bs)

or from the shell:
    python -m cuda_flashattention_tpu.utils.autotune --seq 16384 --d 128
"""

from __future__ import annotations

import itertools
import json
import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.ops.common import BlockSizes, next_pow2
from cuda_flashattention_tpu.utils.log import get_logger
from cuda_flashattention_tpu.utils.timing import time_fn

from cuda_flashattention_tpu import config as _config

_CACHE_PATH = _config.AUTOTUNE_CACHE()
_MEM_CACHE: dict = {}


def _disk_cache_load() -> dict:
    try:
        with open(_CACHE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _disk_cache_store(cache: dict) -> None:
    try:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        with open(_CACHE_PATH, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
    except OSError:
        pass  # caching is best-effort


# A block's shared memory on Hopper (227 KB usable of the SM's 256 KB).
SMEM_BYTES = 227 * 1024
TILES = (32, 64, 128)


def candidate_blocks(nq: int, nk: int, d: int, num_stages: int = 3,
                     itemsize: int = 2) -> List[Tuple[int, int]]:
    """(block_q, block_k) pairs the Triton forward can run: powers of two
    from TILES, no larger than the problem (rounded up to a power of
    two ≥ 16), whose resident Q tile plus `num_stages` pipelined K and V
    tiles fit a block's shared memory."""
    def tiles(n):
        top = max(16, next_pow2(n))
        return [t for t in TILES if t <= top] or [top]
    d_p = max(16, next_pow2(d))
    out = []
    for bq, bk in itertools.product(tiles(nq), tiles(nk)):
        smem = (bq + num_stages * 2 * bk) * d_p * itemsize
        if smem <= SMEM_BYTES:
            out.append((bq, bk))
    return out or [(min(TILES[0], max(16, next_pow2(nq))),
                    min(TILES[0], max(16, next_pow2(nk))))]


def _bench_fwd(bs: BlockSizes, q, k, v, causal: bool, iters: int,
               window: int = 0) -> float:
    from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
    f = jax.jit(lambda q, k, v: flash_attention_forward(
        q, k, v, causal=causal, window=window, block_sizes=bs)[0])
    return time_fn(f, q, k, v, iters=iters, warmup=1)


def _bench_bwd(bs: BlockSizes, q, k, v, causal: bool, iters: int,
               window: int = 0) -> float:
    from cuda_flashattention_tpu.ops.flash_bwd import (
        flash_attention_backward)
    from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
    o, lse = flash_attention_forward(q, k, v, causal=causal, window=window)
    f = jax.jit(lambda q, k, v, o, lse: flash_attention_backward(
        q, k, v, o, lse, o, causal=causal, window=window,
        block_sizes=bs)[0])
    return time_fn(f, q, k, v, o, lse, iters=iters, warmup=1)


def autotune_block_sizes(
    nq: int,
    nk: int,
    d: int,
    batch: int = 1,
    heads: int = 1,
    dtype=jnp.bfloat16,
    causal: bool = False,
    window: int = 0,
    mode: str = "fwd",
    iters: int = 5,
    candidates: Optional[List[Tuple[int, int]]] = None,
    verbose: bool = False,
) -> BlockSizes:
    """Measure candidate tile sizes on the live device; return the best.

    `mode` is "fwd" or "bwd" (tunes block_q/block_k or the *_bwd pair);
    `window` tunes window-specific tiles (the straddler-mask fraction
    shifts the optimum — docs/IMPLEMENTATION.md "Known gaps", r1) and
    implies `causal` (windows are causal by definition here).
    Results are cached on disk keyed by device kind + problem shape.
    """
    if window:
        causal = True
    dev = jax.devices()[0]
    key = json.dumps(["v4", dev.device_kind, jax.default_backend(), batch, heads,
                      nq, nk, d, str(jnp.dtype(dtype)), causal, window,
                      mode])
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    disk = _disk_cache_load()
    if key in disk:
        bs = BlockSizes(**disk[key])
        _MEM_CACHE[key] = bs
        return bs

    cands = candidates or candidate_blocks(nq, nk, d)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.uniform(keys[0], (batch, heads, nq, d), dtype, -0.5, 0.5)
    k = jax.random.uniform(keys[1], (batch, heads, nk, d), dtype, -0.5, 0.5)
    v = jax.random.uniform(keys[2], (batch, heads, nk, d), dtype, -0.5, 0.5)

    best_bs, best_t = None, float("inf")
    failures = []
    base = BlockSizes()
    for bq, bk in cands:
        # A candidate the compiler rejects (e.g. more shared memory or
        # registers than a block may have) is just a non-winner, not a
        # tune abort — the candidate filter models shared memory only.
        try:
            if mode == "bwd":
                bs = BlockSizes(block_q=base.block_q, block_k=base.block_k,
                                block_q_bwd=bq, block_k_bwd=bk).clamp(nq, nk)
                t = _bench_bwd(bs, q, k, v, causal, iters, window=window)
            else:
                bs = BlockSizes(block_q=bq, block_k=bk,
                                block_q_bwd=base.block_q_bwd,
                                block_k_bwd=base.block_k_bwd).clamp(nq, nk)
                t = _bench_fwd(bs, q, k, v, causal, iters, window=window)
        except Exception as e:  # noqa: BLE001 — compile errors vary by path
            failures.append(f"({bq},{bk}): {type(e).__name__}: "
                            f"{str(e)[:120]}")
            if verbose:
                print(f"  ({bq:5d},{bk:5d}) -> failed: {failures[-1]}")
            continue
        if verbose:
            print(f"  ({bq:5d},{bk:5d}) -> {t*1e3:8.3f} ms")
        if t < best_t:
            best_bs, best_t = bs, t

    if failures:
        # Never silent (a broken _bench_* or a dead device would otherwise
        # masquerade as a successful tune), and never written to DISK: a
        # transient failure (device OOM from a concurrent job) striking
        # mid-sweep must not permanently cache a partially-measured winner.
        # Deterministic rejects re-tune once per process — acceptable for
        # an explicit user-invoked tune.
        get_logger(__name__).warning(
            "autotune %s %dx%d d=%d: %d/%d candidates failed "
            "(best-of-survivors kept in-process only, disk cache skipped): "
            "%s", mode, nq, nk, d, len(failures), len(cands),
            "; ".join(failures[:3]))
    if best_bs is None:
        # Every candidate failed: fall back to the defaults.
        best_bs = BlockSizes().clamp(nq, nk)
    elif not failures:
        disk[key] = {
            "block_q": best_bs.block_q, "block_k": best_bs.block_k,
            "block_q_bwd": best_bs.block_q_bwd,
            "block_k_bwd": best_bs.block_k_bwd,
        }
        _disk_cache_store(disk)
    _MEM_CACHE[key] = best_bs
    return best_bs


def autotune_decode_block_k(
    ctx: int,
    heads: int = 16,
    kv_heads: Optional[int] = None,
    d: int = 128,
    batch: int = 4,
    qtype: Optional[str] = None,
    window: int = 0,
    iters: int = 10,
    verbose: bool = False,
) -> int:
    """Measure decode cache tiles (powers of two 32..256 that the decode
    kernel accepts for this cache length) on the live device; cached like
    the prefill tuner. Returns the best block_k; the split count follows
    from it (ops/decode.decode_splits)."""
    from cuda_flashattention_tpu.ops.decode import (
        decode_attention, decode_block_k)
    from cuda_flashattention_tpu.ops.quant import quantize_kv

    kv_heads = kv_heads or heads
    dev = jax.devices()[0]
    key = json.dumps(["v4", dev.device_kind, jax.default_backend(), "decode",
                      batch, heads, kv_heads, ctx, d, qtype or "bf16",
                      window])
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    disk = _disk_cache_load()
    if key in disk:
        _MEM_CACHE[key] = disk[key]
        return disk[key]

    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    k = jax.random.uniform(keys[0], (batch, kv_heads, ctx, d),
                           jnp.bfloat16, -0.5, 0.5)
    v = jax.random.uniform(keys[1], (batch, kv_heads, ctx, d),
                           jnp.bfloat16, -0.5, 0.5)
    q = jax.random.uniform(keys[2], (batch, heads, d), jnp.bfloat16,
                           -0.5, 0.5)
    lengths = jnp.full((batch,), ctx, jnp.int32)
    scales = {}
    if qtype:
        kvq = quantize_kv(k, v, qtype)
        k, v = kvq.k_q, kvq.v_q
        scales = dict(k_scale=kvq.k_scale, v_scale=kvq.v_scale)

    cands = sorted({decode_block_k(ctx, bk) for bk in (32, 64, 128, 256)})
    best_bk, best_t = None, float("inf")
    failures = []
    for bk in cands:
        f = jax.jit(lambda q, k, v, sc, bk=bk: decode_attention(
            q, k, v, lengths, block_k=bk, window=window, **sc)[0])
        try:
            t = time_fn(f, q, k, v, scales, iters=iters, warmup=1)
        except Exception as e:  # noqa: BLE001 — same policy as the
            failures.append(  # block-sizes tuner: a reject is a non-winner
                f"block_k {bk}: {type(e).__name__}: {str(e)[:120]}")
            if verbose:
                print(f"  block_k {bk:6d} -> failed: {failures[-1]}")
            continue
        if verbose:
            print(f"  block_k {bk:6d} -> {t*1e3:8.3f} ms")
        if t < best_t:
            best_bk, best_t = bk, t

    if failures:
        get_logger(__name__).warning(
            "autotune decode ctx=%d: %d/%d candidates failed (disk cache "
            "skipped): %s", ctx, len(failures), len(cands),
            "; ".join(failures[:3]))
    if best_bk is None:
        best_bk = decode_block_k(ctx)
    elif not failures:
        disk[key] = best_bk
        _disk_cache_store(disk)
    _MEM_CACHE[key] = best_bk
    return best_bk


def autotune_page_size(
    ctx: int,
    heads: int = 16,
    d: int = 128,
    batch: int = 4,
    qtype: Optional[str] = None,
    iters: int = 10,
    verbose: bool = False,
) -> int:
    """Measure paged-decode page sizes (a CACHE-LAYOUT decision: pick it
    BEFORE allocating pools). Candidates 128..1024; cached. Returns the
    best page_size."""
    from cuda_flashattention_tpu.ops.paged import paged_decode_attention
    from cuda_flashattention_tpu.ops.quant import quantize_tensor

    dev = jax.devices()[0]
    key = json.dumps(["v4", dev.device_kind, jax.default_backend(), "page",
                      batch, heads, ctx, d, qtype or "bf16"])
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    disk = _disk_cache_load()
    if key in disk:
        _MEM_CACHE[key] = disk[key]
        return disk[key]

    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.uniform(keys[2], (batch, heads, d), jnp.bfloat16,
                           -0.5, 0.5)
    cands = [ps for ps in (128, 256, 512, 1024) if ps <= ctx] or [
        max(16, next_pow2(ctx))]
    best_ps, best_t = None, float("inf")
    failures = []
    for ps in cands:
        pages_per_seq = -(-ctx // ps)
        n_pool = batch * pages_per_seq
        kp = jax.random.uniform(keys[0], (n_pool, heads, ps, d),
                                jnp.bfloat16, -0.5, 0.5)
        vp = jax.random.uniform(keys[1], (n_pool, heads, ps, d),
                                jnp.bfloat16, -0.5, 0.5)
        scales = {}
        if qtype:
            from cuda_flashattention_tpu.ops.quant import _pair_qtypes
            kt, vt = _pair_qtypes(qtype)  # "mixed": int8 K / fp8 V
            kp, ks = quantize_tensor(kp, kt)
            vp, vs = quantize_tensor(vp, vt)
            scales = dict(k_scale=ks, v_scale=vs)
        table = jnp.arange(n_pool, dtype=jnp.int32).reshape(
            batch, pages_per_seq)
        lengths = jnp.full((batch,), ctx, jnp.int32)
        f = jax.jit(lambda q, kp, vp, sc, table=table: paged_decode_attention(
            q, kp, vp, table, lengths, **sc)[0])
        try:
            t = time_fn(f, q, kp, vp, scales, iters=iters, warmup=1)
        except Exception as e:  # noqa: BLE001
            failures.append(
                f"page_size {ps}: {type(e).__name__}: {str(e)[:120]}")
            if verbose:
                print(f"  page_size {ps:5d} -> failed: {failures[-1]}")
            continue
        if verbose:
            print(f"  page_size {ps:5d} -> {t*1e3:8.3f} ms")
        if t < best_t:
            best_ps, best_t = ps, t

    if failures:
        get_logger(__name__).warning(
            "autotune page ctx=%d: %d/%d candidates failed (disk cache "
            "skipped): %s", ctx, len(failures), len(cands),
            "; ".join(failures[:3]))
    if best_ps is None:
        best_ps = min(256, cands[-1])  # static serving default
    elif not failures:
        disk[key] = best_ps
        _disk_cache_store(disk)
    _MEM_CACHE[key] = best_ps
    return best_ps


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", type=int, default=16384)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--mode", choices=["fwd", "bwd", "decode", "page"],
                    default="fwd")
    ap.add_argument("--iters", type=int, default=5)
    opts = ap.parse_args()
    if opts.mode == "decode":
        bk = autotune_decode_block_k(ctx=opts.seq, heads=opts.heads,
                                     d=opts.d, batch=opts.batch,
                                     window=opts.window, verbose=True)
        print(f"best decode block_k: {bk}")
    elif opts.mode == "page":
        ps = autotune_page_size(ctx=opts.seq, heads=opts.heads, d=opts.d,
                                batch=opts.batch, verbose=True)
        print(f"best page_size: {ps}")
    else:
        bs = autotune_block_sizes(
            nq=opts.seq, nk=opts.seq, d=opts.d, batch=opts.batch,
            heads=opts.heads, causal=opts.causal, window=opts.window,
            mode=opts.mode, iters=opts.iters, verbose=True)
        print(f"best: {bs}")


if __name__ == "__main__":
    main()
