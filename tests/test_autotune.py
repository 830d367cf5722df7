"""Autotuner tests (the reference's future-work item delivered:
ref: __info__/IMPLEMENTATION_SUMMARY.md:256 "Auto-tune Br, Bc")."""

import os

import jax.numpy as jnp
import pytest

from cuda_flashattention_tpu.ops.common import BlockSizes
from cuda_flashattention_tpu.utils import autotune


def test_candidates_respect_smem_budget():
    cands = autotune.candidate_blocks(16384, 16384, 128)
    assert cands, "no candidates generated"
    # the default tiles must be in the candidate space
    assert (128, 64) in cands
    for bq, bk in cands:
        assert (bq + 3 * 2 * bk) * 128 * 2 <= autotune.SMEM_BYTES
        assert bq & (bq - 1) == 0 and bk & (bk - 1) == 0


def test_candidates_shrink_to_problem():
    cands = autotune.candidate_blocks(64, 64, 64)
    assert all(bq <= 64 and bk <= 64 for bq, bk in cands)


def test_static_heuristic_consistency():
    bs = BlockSizes().clamp(16384, 16384)
    for b in (bs.block_q, bs.block_k, bs.block_q_bwd, bs.block_k_bwd):
        assert b >= 16 and b & (b - 1) == 0
    small = BlockSizes().clamp(16, 16)
    assert small.block_q == 16


def test_autotune_measures_and_caches(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_CACHE_PATH",
                        os.path.join(tmp_path, "cache.json"))
    autotune._MEM_CACHE.clear()
    bs = autotune.autotune_block_sizes(
        nq=128, nk=128, d=64, dtype=jnp.float32, iters=1,
        candidates=[(128, 128), (128, 256)])
    assert isinstance(bs, BlockSizes)
    assert os.path.exists(autotune._CACHE_PATH)
    # second call must hit the cache (no bench): poison time_fn
    monkeypatch.setattr(autotune, "time_fn",
                        lambda *a, **k: pytest.fail("cache miss"))
    bs2 = autotune.autotune_block_sizes(
        nq=128, nk=128, d=64, dtype=jnp.float32, iters=1,
        candidates=[(128, 128), (128, 256)])
    assert bs2 == bs


def test_autotune_skips_failing_candidate(tmp_path, monkeypatch):
    """A candidate the compiler rejects is a non-winner, not a tune
    abort (the shared-memory model admits tiles the compiler can still
    refuse, e.g. for registers)."""
    monkeypatch.setattr(autotune, "_CACHE_PATH",
                        os.path.join(tmp_path, "cache.json"))
    autotune._MEM_CACHE.clear()
    real_bench = autotune._bench_fwd

    def bench(bs, q, k, v, causal, iters, window=0):
        if bs.block_k == 256:
            raise RuntimeError("out of resource: shared memory")
        return real_bench(bs, q, k, v, causal, iters, window=window)

    monkeypatch.setattr(autotune, "_bench_fwd", bench)
    bs = autotune.autotune_block_sizes(
        nq=128, nk=256, d=64, dtype=jnp.float32, iters=1,
        candidates=[(128, 256), (128, 128)])
    assert bs.block_k == 128  # the surviving candidate won
    # A partial sweep is memoized in-process but NEVER written to disk:
    # a transient mid-sweep failure must not permanently cache a
    # partially-measured winner.
    assert autotune._MEM_CACHE
    assert not os.path.exists(autotune._CACHE_PATH)


def test_autotune_all_candidates_fail(tmp_path, monkeypatch):
    """All candidates failing falls back to the default tiles and
    does NOT poison the disk cache (a transient device failure must not
    be cached as a winner)."""
    monkeypatch.setattr(autotune, "_CACHE_PATH",
                        os.path.join(tmp_path, "cache.json"))
    autotune._MEM_CACHE.clear()
    calls = []

    def bench(*a, **k):
        calls.append(1)
        raise RuntimeError("dead device")

    monkeypatch.setattr(autotune, "_bench_fwd", bench)
    bs = autotune.autotune_block_sizes(
        nq=128, nk=128, d=64, dtype=jnp.float32, iters=1,
        candidates=[(128, 128)])
    assert bs == BlockSizes().clamp(128, 128)
    assert not os.path.exists(autotune._CACHE_PATH)
    # ... but the heuristic IS memoized in-process, so a shape whose
    # every candidate deterministically fails to compile doesn't re-pay
    # the whole failed sweep on each call.
    bs2 = autotune.autotune_block_sizes(
        nq=128, nk=128, d=64, dtype=jnp.float32, iters=1,
        candidates=[(128, 128)])
    assert bs2 == bs and len(calls) == 1


def test_autotune_bwd_mode(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_CACHE_PATH",
                        os.path.join(tmp_path, "cache.json"))
    autotune._MEM_CACHE.clear()
    bs = autotune.autotune_block_sizes(
        nq=128, nk=128, d=64, dtype=jnp.float32, iters=1, mode="bwd",
        candidates=[(128, 128)])
    assert bs.block_q_bwd == 128 and bs.block_k_bwd == 128


def test_autotune_decode_block_k(tmp_path, monkeypatch):
    """Decode block_k tuner: returns a legal candidate and caches it."""
    import cuda_flashattention_tpu.utils.autotune as at
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "cache.json"))
    at._MEM_CACHE.clear()
    bk = at.autotune_decode_block_k(ctx=512, heads=2, d=32, batch=1,
                                    iters=1)
    assert bk in (32, 64, 128, 256)
    bk8 = at.autotune_decode_block_k(ctx=512, heads=2, d=32, batch=1,
                                     qtype="int8", iters=1)
    assert bk8 in (32, 64, 128, 256)
    # cached second call hits memory, no re-measurement
    assert at.autotune_decode_block_k(ctx=512, heads=2, d=32,
                                      batch=1, iters=1) == bk


def test_autotune_decode_failing_candidate(tmp_path, monkeypatch):
    """The decode tuner applies the same failure policy as the
    block-sizes tuner: a candidate whose compile dies is skipped (with
    the partial result kept out of the disk cache), and an all-fail
    sweep falls back to the static decode_block_k resolver."""
    import cuda_flashattention_tpu.utils.autotune as at
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "cache.json"))
    at._MEM_CACHE.clear()
    monkeypatch.setattr(
        at, "time_fn",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("dead")))
    bk = at.autotune_decode_block_k(ctx=512, heads=2, d=32, batch=1,
                                    iters=1)
    assert bk == 64  # the static default
    assert not os.path.exists(at._CACHE_PATH)


def test_autotune_page_size(tmp_path, monkeypatch):
    import cuda_flashattention_tpu.utils.autotune as at
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "cache.json"))
    at._MEM_CACHE.clear()
    ps = at.autotune_page_size(ctx=512, heads=2, d=32, batch=1, iters=1)
    assert ps in (128, 256, 512)
    # quantized pools: per-page scales ride the scan args path
    ps8 = at.autotune_page_size(ctx=512, heads=2, d=32, batch=1,
                                qtype="int8", iters=1)
    assert ps8 in (128, 256, 512)


def test_candidate_blocks_adapt_to_problem():
    from cuda_flashattention_tpu.utils.autotune import candidate_blocks
    small = candidate_blocks(20, 40, 64)
    assert all(bq <= 32 and bk <= 64 for bq, bk in small)
    big = candidate_blocks(32768, 32768, 128)
    assert max(bq for bq, _ in big) == 128  # tiles stay register-sized
