"""Kernel-layer helpers: the loop bounds every kernel derives from its
masks, the Triton tile rules the wrappers enforce, tile sizes, and the
log-space merge of partial results."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flashattention_tpu.ops.common import (
    BlockSizes,
    attention_mask,
    check_triton_shape,
    combine_partials,
    kv_tile_range,
    merge_partials,
    pad_head_dim,
    q_tile_range,
    triton_call_kwargs,
)

# (causal, window, kv_offset, nq, nk, block_q, block_k, segmented)
CASES = [
    (False, 0, 0, 100, 72, 32, 16, False),
    (True, 0, 0, 130, 130, 32, 16, False),
    (True, 0, 40, 64, 150, 16, 32, False),
    (True, 24, 0, 130, 130, 16, 16, False),
    (True, 40, 33, 70, 120, 32, 16, False),
    (True, 0, -20, 64, 64, 16, 16, False),
    (True, 0, 0, 64, 64, 16, 16, True),
]


def _visibility(causal, window, kv_offset, nq_p, nk_p, nk):
    rows = np.arange(nq_p)[:, None] + kv_offset
    cols = np.arange(nk_p)[None, :]
    ok = np.broadcast_to(cols < nk, (nq_p, nk_p)).copy()
    if causal:
        ok &= cols <= rows
        if window:
            ok &= cols > rows - window
    return ok


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_kv_tile_range_matches_brute_force(case):
    """Every visible pair lies in [lo, hi); tiles in [full_lo, full_hi)
    are entirely visible, so skipping their mask is exact."""
    causal, window, off, nq, nk, bq, bk, seg = case
    nqb, nkb = -(-nq // bq), -(-nk // bk)
    vis = _visibility(causal, window, off, nqb * bq, nkb * bk, nk)
    for i in range(nqb):
        lo, flo, fhi, hi = (int(x) for x in kv_tile_range(
            i * bq + off, block_q=bq, block_k=bk, n_kv_tiles=nkb,
            causal=causal, window=window, nk_valid=nk, segmented=seg))
        assert 0 <= lo <= flo <= fhi <= hi <= nkb
        tile = vis[i * bq:(i + 1) * bq].reshape(bq, nkb, bk)
        any_vis = tile.any(axis=(0, 2))
        all_vis = tile.all(axis=(0, 2))
        assert not any_vis[:lo].any() and not any_vis[hi:].any()
        assert all_vis[flo:fhi].all()
        if seg:
            assert flo == fhi  # segment ids make every tile masked


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_q_tile_range_matches_brute_force(case):
    causal, window, off, nq, nk, bq, bk, seg = case
    nqb, nkb = -(-nq // bq), -(-nk // bk)
    # padded columns need no mask in the dK/dV kernel: judge real ones
    vis = _visibility(causal, window, off, nqb * bq, nkb * bk, nkb * bk)
    for j in range(nkb):
        lo, flo, fhi, hi = (int(x) for x in q_tile_range(
            j * bk, block_q=bq, block_k=bk, n_q_tiles=nqb, causal=causal,
            window=window, kv_offset=off, segmented=seg))
        assert 0 <= lo <= flo <= fhi <= hi <= nqb
        tile = vis[:, j * bk:(j + 1) * bk].reshape(nqb, bq, bk)
        any_vis = tile.any(axis=(1, 2))
        all_vis = tile.all(axis=(1, 2))
        assert not any_vis[:lo].any() and not any_vis[hi:].any()
        assert all_vis[flo:fhi].all()


def test_attention_mask_matches_brute_force():
    rows = jnp.arange(10, 26, dtype=jnp.int32)
    cols = jnp.arange(0, 32, dtype=jnp.int32)
    got = attention_mask(rows, cols, causal=True, window=7, nk_valid=20)
    r, c = np.arange(10, 26)[:, None], np.arange(32)[None, :]
    want = (c < 20) & (c <= r) & (c > r - 7)
    assert (np.asarray(got) == want).all()


def test_triton_tile_rule():
    check_triton_shape((16, 128), (64, 16))
    for bad in ((8, 128), (48, 64), (16, 24)):
        with pytest.raises(ValueError, match="powers of two"):
            check_triton_shape(bad)


@pytest.mark.parametrize("bq,bk,nq,nk,want", [
    (128, 64, 4096, 4096, (128, 64)),
    (128, 64, 40, 20, (64, 32)),
    (8, 8, 100, 100, (16, 16)),
    (100, 48, 1000, 1000, (128, 64)),
])
def test_block_sizes_clamp_to_legal_tiles(bq, bk, nq, nk, want):
    bs = BlockSizes(block_q=bq, block_k=bk).clamp(nq, nk)
    assert (bs.block_q, bs.block_k) == want
    for b in (bs.block_q, bs.block_k, bs.block_q_bwd, bs.block_k_bwd):
        assert b >= 16 and b & (b - 1) == 0


def test_pad_head_dim():
    for d, want in ((4, 16), (24, 32), (64, 64), (128, 128)):
        x = jnp.ones((1, 2, 3, d))
        y = pad_head_dim(x)
        assert y.shape[-1] == want
        assert float(y[..., d:].sum()) == 0.0


def test_merge_partials_matches_pairwise_and_drops_empty():
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.standard_normal((3, 2, 5, 8)), jnp.float32)
    lse = jnp.asarray(rng.standard_normal((3, 2, 5)), jnp.float32)
    lse = lse.at[1].set(-1e30)          # one partial saw nothing
    o = o.at[1].set(0.0)
    got_o, got_lse = merge_partials(o, lse, axis=0)
    want_o, want_lse = combine_partials(o[0], lse[0], o[2], lse[2])
    np.testing.assert_allclose(got_o, want_o, atol=1e-6)
    np.testing.assert_allclose(got_lse, want_lse, atol=1e-6)
    empty_o, empty_lse = merge_partials(jnp.zeros((4, 3, 8)),
                                        jnp.full((4, 3), -1e30), axis=0)
    assert float(jnp.abs(empty_o).max()) == 0.0
    assert float(empty_lse.max()) == float(jnp.float32(-1e30))


def test_every_kernel_call_names_the_triton_route():
    kw = triton_call_kwargs("k", num_warps=4, num_stages=2)
    assert kw["backend"] == "triton"
    assert kw["compiler_params"].num_warps == 4
    assert kw["interpret"] is True       # CPU with the conftest opt-in
    assert set(itertools.chain(kw)) == {"backend", "compiler_params",
                                        "interpret", "name"}
