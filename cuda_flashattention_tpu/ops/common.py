"""Shared kernel-layer helpers.

Counterpart of the reference's device helper layer
(ref: src/util/cuda_helper.h, src/util/attention_helper.h): ceiling
division, padding, the finite −inf stand-in, tile sizes for the Pallas
Triton kernels, the interpret-mode rule, the log-space merge of partial
attention results, and the per-program loop bounds that every kernel
derives from causal / window / offset masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import triton as pltriton

from cuda_flashattention_tpu import config

# A finite stand-in for -inf inside kernels: exp(x - NEG_INF) == 0 in fp32
# while avoiding inf-inf = nan in the m/l updates (the reference needs a
# dedicated init_array kernel for -inf, ref: cuda_helper.h:60-65, memo.md:1).
NEG_INF = -1e30
LOG2E = 1.4426950408889634  # scores are carried in log2 units in-kernel
LN2 = 0.6931471805599453


def cdiv(a: int, b: int) -> int:
    """Ceiling division (ref: cuda_helper.h:16 `div_up`)."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def resolve_scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def interpret_mode() -> bool:
    """Whether Pallas kernels run in the interpreter.

    On a GPU backend kernels always compile. Anywhere else they run only
    in the Pallas interpreter, and only when the process opted in with
    CFA_PALLAS_INTERPRET=1 (tests/conftest.py and the CPU examples do);
    without that opt-in a kernel call raises instead of quietly
    interpreting."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if config.PALLAS_INTERPRET.as_bool:
        return True
    raise RuntimeError(
        f"the attention kernels compile for the GPU only (backend is "
        f"{backend!r}); set CFA_PALLAS_INTERPRET=1 to run them in the "
        f"Pallas interpreter")


def triton_call_kwargs(name: str, num_warps: int, num_stages: int) -> dict:
    """The keyword arguments every pallas_call of this package shares:
    the Triton route named explicitly (JAX's default GPU route is Mosaic
    GPU), its launch parameters, and the interpret rule above."""
    return dict(
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=interpret_mode(),
        name=name,
    )


def check_triton_shape(*shapes: Tuple[int, ...]) -> None:
    """Triton loads and stores whole power-of-two tiles, and its dot wants
    every dimension ≥ 16. The interpreter checks neither, so the wrappers
    check their tile shapes here, where CPU tests reach it."""
    for shape in shapes:
        for n in shape:
            if n < 16 or n & (n - 1):
                raise ValueError(
                    f"tile {shape}: Triton tiles need powers of two >= 16")


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes of the attention kernels.

    The reference fixes these as C++ template parameters <Br, Bc, d_max,
    num_warps> (ref: 02_fwd/kernel.cu:311-315); here they are runtime
    arguments. Each is a power of two ≥ 16 (Triton's tile rule): the
    forward walks KV in `block_k` tiles per `block_q` rows; the backward
    uses `block_q_bwd` × `block_k_bwd` in both of its kernels. The
    defaults suit d=128 in bf16 on Hopper: a 128-row forward tile keeps
    the fp32 accumulator at 64 registers a thread under 8 warps, and the
    backward's two fp32 accumulators (dK and dV) need the smaller tile.
    """

    block_q: int = 128
    block_k: int = 64
    block_q_bwd: int = 64
    block_k_bwd: int = 64

    def clamp(self, nq: int, nk: int) -> "BlockSizes":
        """Shrink tiles to the problem and round them to legal Triton
        tiles (a power of two ≥ 16)."""
        def fit(b: int, n: int) -> int:
            return max(16, min(next_pow2(b), next_pow2(n)))
        return BlockSizes(
            block_q=fit(self.block_q, nq),
            block_k=fit(self.block_k, nk),
            block_q_bwd=fit(self.block_q_bwd, nq),
            block_k_bwd=fit(self.block_k_bwd, nk),
        )


def num_warps_for(rows: int, d: int) -> int:
    """Warps per program: 8 for 128-row tiles at d ≥ 128, else 4."""
    return 8 if rows >= 128 and d >= 128 else 4


def pad_to_block(x: jnp.ndarray, axis: int, block: int,
                 value: float = 0.0) -> jnp.ndarray:
    """Pad `axis` up to a multiple of `block`.

    The reference dodges non-divisible shapes by assertion
    (ref: 04_ring_attention.cu:56-63); we pad + mask instead
    (SURVEY.md §7 hard part (e))."""
    n = x.shape[axis]
    target = round_up(n, block)
    if target == n:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - n)
    return jnp.pad(x, pads, constant_values=value)


def pad_head_dim(x: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad the trailing head dim to a legal Triton tile width.
    Zero columns change no score and produce zero output columns."""
    d = x.shape[-1]
    dp = max(16, next_pow2(d))
    if dp == d:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, dp - d)])


def dot_precision(dtype):
    """fp32 operands would otherwise run as TF32 in Triton's dot (about
    three decimal digits); ask for full precision. Narrow types take the
    tensor cores' native path."""
    return lax.Precision.HIGHEST if dtype == jnp.float32 else None


def combine_partials(o1, lse1, o2, lse2):
    """Merge two normalised partial attention results over disjoint key
    sets: O = Σᵢ Oᵢ·exp(LSEᵢ − LSE), LSE = logaddexp(LSEᵢ).

    Log-space combination avoids the reference's documented online-rescale
    drift ((x/y)·(y/z) ≠ x/z in fp — ref: memo.md:5)."""
    lse = jnp.logaddexp(lse1, lse2)
    w1 = jnp.exp(lse1 - lse)[..., None]
    w2 = jnp.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


def merge_partials(o, lse, axis: int = 0):
    """The n-way form of `combine_partials`: merge partials stacked on
    `axis` (o [..., d] with the stack axis among the leading dims, lse
    without the trailing d). Rows no partial saw come back O=0 /
    LSE=NEG_INF."""
    m = jnp.max(lse, axis=axis, keepdims=True)
    w = jnp.exp(lse - m)
    l_sum = jnp.sum(w, axis=axis)
    o = jnp.sum(o * w[..., None], axis=axis) / l_sum[..., None]
    m = jnp.squeeze(m, axis)
    lse = jnp.where(m <= NEG_INF * 0.5, NEG_INF, m + jnp.log(l_sum))
    return o, lse


# ---------------------------------------------------------------------------
# Loop bounds. Each kernel program owns one tile on one axis and loops over
# tiles of the other; these helpers give the range it must visit and the
# sub-range where no element is masked (so the mask is built only on the
# edges). They take traced int32 scalars inside kernels and plain ints in
# tests, and use only the integer ops Triton lowers (lax.div truncates, so
# floor division of a possibly negative numerator is spelled out).
# ---------------------------------------------------------------------------


def _floordiv(x, b: int):
    x = jnp.asarray(x, jnp.int32)
    return jnp.where(x >= 0, lax.div(x, jnp.int32(b)),
                     -lax.div(-x + (b - 1), jnp.int32(b)))


def _clip(x, lo, hi):
    return jnp.minimum(jnp.maximum(x, lo), hi)


def kv_tile_range(q_first, *, block_q: int, block_k: int, n_kv_tiles: int,
                  causal: bool, window: int, nk_valid: int,
                  segmented: bool):
    """For the query tile whose first row sits at global position
    `q_first` (tile index · block_q + kv_offset): the KV tiles [lo, hi)
    it sees, and [full_lo, full_hi) ⊆ [lo, hi) in which every
    (row, column) pair is visible and no mask is needed."""
    q_last = q_first + (block_q - 1)
    lo = jnp.int32(0)
    hi = jnp.int32(n_kv_tiles)
    full_lo, full_hi = lo, hi
    if causal:
        hi = _clip(_floordiv(q_last, block_k) + 1, 0, n_kv_tiles)
        full_hi = _floordiv(q_first + 1, block_k)
        if window:
            lo = _clip(_floordiv(q_first - window + 1, block_k), 0,
                       n_kv_tiles)
            full_lo = _floordiv(q_last - window + block_k, block_k)
    if nk_valid % block_k:
        full_hi = jnp.minimum(full_hi, nk_valid // block_k)
    if segmented:
        full_lo = hi
    lo = jnp.minimum(lo, hi)
    full_lo = _clip(full_lo, lo, hi)
    full_hi = _clip(full_hi, full_lo, hi)
    return lo, full_lo, full_hi, hi


def q_tile_range(k_first, *, block_q: int, block_k: int, n_q_tiles: int,
                 causal: bool, window: int, kv_offset: int,
                 segmented: bool):
    """For the KV tile whose first column is `k_first`: the query tiles
    [lo, hi) that see any of it, and the fully visible [full_lo, full_hi).
    Query rows are global at tile index · block_q + kv_offset. Padded
    columns need no mask here: each column's gradient is its own."""
    k_last = k_first + (block_k - 1)
    lo = jnp.int32(0)
    hi = jnp.int32(n_q_tiles)
    full_lo, full_hi = lo, hi
    if causal:
        lo = _clip(_floordiv(k_first - kv_offset, block_q), 0, n_q_tiles)
        full_lo = _floordiv(k_last - kv_offset + block_q - 1, block_q)
        if window:
            hi = _clip(_floordiv(k_last + window - 1 - kv_offset, block_q)
                       + 1, 0, n_q_tiles)
            full_hi = _floordiv(k_first + window - kv_offset - block_q,
                                block_q) + 1
    if segmented:
        full_lo = hi
    lo = jnp.minimum(lo, hi)
    full_lo = _clip(full_lo, lo, hi)
    full_hi = _clip(full_hi, full_lo, hi)
    return lo, full_lo, full_hi, hi


def attention_mask(rows, cols, *, causal: bool, window: int,
                   nk_valid: Optional[int] = None, qseg=None, kseg=None):
    """(rows × cols) visibility from global row/column index vectors."""
    r = rows[:, None]
    c = cols[None, :]
    ok = jnp.ones((rows.shape[0], cols.shape[0]), jnp.bool_)
    if nk_valid is not None:
        ok = jnp.logical_and(ok, c < nk_valid)
    if causal:
        ok = jnp.logical_and(ok, c <= r)
        if window:
            ok = jnp.logical_and(ok, c > r - window)
    if qseg is not None:
        ok = jnp.logical_and(ok, qseg[:, None] == kseg[None, :])
    return ok
