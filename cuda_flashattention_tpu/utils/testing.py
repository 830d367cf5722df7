"""Test utilities: tolerance comparison + deterministic fixtures.

Counterpart of the reference's host test helpers
(ref: src/util/attention_helper.h:137-208). Keeps the reference's exact
fixture styles (SURVEY.md §4): tiny hand-checkable integer matrices,
seeded random at realistic sizes, and programmatic structured data.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def compare_outputs(
    actual,
    expected,
    rtol: float = 1e-3,
    atol: float = 1.0,
    name: str = "output",
    max_print: int = 10,
    verbose: bool = True,
) -> bool:
    """Relative+absolute tolerance check, printing the first few diffs.

    Mirrors `compare_outputs` (ref: attention_helper.h:174-208): an element
    passes if |a-e| <= atol OR |a-e| <= rtol*|e|; the reference's defaults
    rtol=1e-3, atol=1.0 are kept.
    """
    a = np.asarray(actual, dtype=np.float64)
    e = np.asarray(expected, dtype=np.float64)
    if a.shape != e.shape:
        raise ValueError(f"{name}: shape mismatch {a.shape} vs {e.shape}")
    diff = np.abs(a - e)
    ok = (diff <= atol) | (diff <= rtol * np.abs(e))
    n_bad = int((~ok).sum())
    if n_bad and verbose:
        bad = np.argwhere(~ok)[:max_print]
        print(f"[compare_outputs] {name}: {n_bad}/{a.size} mismatches "
              f"(rtol={rtol}, atol={atol})")
        for idx in bad:
            t = tuple(int(i) for i in idx)
            print(f"  at {t}: actual={a[t]:.6g} expected={e[t]:.6g} "
                  f"diff={diff[t]:.3g}")
    return n_bad == 0


def max_abs_diff(actual, expected) -> float:
    a = np.asarray(actual, dtype=np.float64)
    e = np.asarray(expected, dtype=np.float64)
    return float(np.max(np.abs(a - e))) if a.size else 0.0


def assert_close(actual, expected, tol: float, name: str = "output") -> None:
    """Max-abs-diff threshold check, the reference's per-test PASS gate
    (e.g. ref: 02_fwd/main.cu:67-89 uses max_diff < 5e-3)."""
    d = max_abs_diff(actual, expected)
    if not d < tol:
        a = np.asarray(actual, np.float64).ravel()
        e = np.asarray(expected, np.float64).ravel()
        i = int(np.argmax(np.abs(a - e)))
        raise AssertionError(
            f"{name}: max diff {d:.3e} >= tol {tol:.0e} "
            f"(flat idx {i}: actual={a[i]:.6g} expected={e[i]:.6g})")


def identity_qk_fixture(n: int = 4, d: int = 4) -> Tuple[np.ndarray, ...]:
    """Identity-ish Q=K with distinct-row V, scale-1.0 hand-checkable case
    (ref: attention_helper.h:151-173 `create_simple_test_data`, and the
    integer 4x4 cases in 01/main.cu:196-345, 02_fwd/main.cu:134-155)."""
    q = np.zeros((n, d), np.float32)
    for i in range(n):
        q[i, i % d] = 1.0
    k = q.copy()
    v = np.arange(n * d, dtype=np.float32).reshape(n, d) / float(n * d)
    return q, k, v


def seeded_random(shape, seed: int = 42, lo: float = -0.5,
                  hi: float = 0.5) -> np.ndarray:
    """Seeded uniform random data, the reference's srand(42) ±0.5 style
    (ref: 02_fwd/main.cu:14-33, 02_bwd/main.cu:200-227)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def random_qkv(
    batch: int, heads: int, nq: int, nk: int, d: int, seed: int = 42,
    dtype=jnp.float32,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Multi-head random fixture in the framework's [B, H, N, d] layout."""
    q = seeded_random((batch, heads, nq, d), seed)
    k = seeded_random((batch, heads, nk, d), seed + 1)
    v = seeded_random((batch, heads, nk, d), seed + 2)
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype))


def print_matrix(name: str, m, max_rows: int = 8, max_cols: int = 8) -> None:
    """Truncated pretty-printer (ref: attention_helper.h:137-148)."""
    a = np.asarray(m)
    r, c = a.shape[:2] if a.ndim >= 2 else (a.shape[0], 1)
    print(f"{name} [{a.shape}]:")
    view = a.reshape(r, -1)[:max_rows, :max_cols]
    for row in view:
        print("  " + " ".join(f"{x:9.4f}" for x in row))
    if r > max_rows or view.shape[1] < np.prod(a.shape[1:], dtype=int):
        print("  ...")
