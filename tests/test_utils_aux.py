"""Aux-subsystem tests: logging, profiling report, config registry
(SURVEY.md §5 rows: metrics/logging, tracing/profiling, config system)."""

import logging

import numpy as np

from cuda_flashattention_tpu import config
from cuda_flashattention_tpu.utils.log import get_logger
from cuda_flashattention_tpu.utils.profiling import annotate, kernel_report
from cuda_flashattention_tpu.utils.testing import print_matrix


def test_logger_prefixes_process(capsys):
    log = get_logger("test")
    log.warning("hello %d", 7)
    err = capsys.readouterr().err
    assert "[p0]" in err and "hello 7" in err


def test_logger_level_env(monkeypatch):
    log = get_logger("lvl")
    assert isinstance(log, logging.Logger)
    log.debug("not shown at INFO")  # no assertion — must not raise


def test_kernel_report_math(capsys):
    out = kernel_report("toy", seconds=0.001, flops=1e9, bytes_moved=1e6)
    assert abs(out["tflops"] - 1.0) < 1e-9
    assert abs(out["gbps"] - 1.0) < 1e-9
    assert "toy" in capsys.readouterr().out


def test_annotate_is_cheap():
    with annotate("region"):
        x = np.ones(4).sum()
    assert x == 4.0


def test_config_registry():
    knobs = config.all_knobs()
    assert "PALLAS_INTERPRET" in knobs and "COORD" in knobs
    assert config.NPROC.as_int >= 1
    text = config.describe()
    assert "CFA_LOG_LEVEL" in text


def test_print_matrix_truncates(capsys):
    print_matrix("m", np.arange(100, dtype=np.float32).reshape(10, 10))
    out = capsys.readouterr().out
    assert "m [" in out and "..." in out


def test_checkpoint_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp
    from cuda_flashattention_tpu.utils import checkpoint as ckpt

    tree = {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "layers": [{"b": jnp.ones((2,), jnp.bfloat16)},
                       {"b": jnp.zeros((2,), jnp.bfloat16)}]}
    p = ckpt.save(str(tmp_path / "step1"), tree)
    like = jax.tree_util.tree_map(jnp.zeros_like, tree)
    back = ckpt.restore(p, like=like)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        assert (np.asarray(a) == np.asarray(b)).all()


def test_checkpoint_train_resume(tmp_path):
    """Save mid-training, restore, and confirm the resumed step matches
    the uninterrupted run bit-for-bit."""
    import jax
    import jax.numpy as jnp
    import optax
    from cuda_flashattention_tpu.models.transformer import (
        TransformerConfig, init_params, make_train_step)
    from cuda_flashattention_tpu.utils import checkpoint as ckpt

    cfg = TransformerConfig(vocab_size=31, d_model=32, n_layers=1,
                            n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
                            max_seq=16, dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(1e-3)
    step = make_train_step(cfg, opt, donate=False)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 31)

    s = opt.init(params)
    p1, s1, _ = step(params, s, tokens)
    path = ckpt.save(str(tmp_path / "mid"), {"p": p1, "s": s1})
    p2, s2, loss_a = step(p1, s1, tokens)

    like = {"p": jax.tree_util.tree_map(jnp.zeros_like, p1),
            "s": jax.tree_util.tree_map(jnp.zeros_like, s1)}
    st = ckpt.restore(path, like=like)
    p2r, s2r, loss_b = step(st["p"], st["s"], tokens)
    assert float(loss_a) == float(loss_b)
    for a, b in zip(jax.tree_util.tree_leaves(p2),
                    jax.tree_util.tree_leaves(p2r)):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_checkpoint_npz_structure_mismatch(tmp_path, monkeypatch):
    """The .npz restore path keys arrays by flattened position; a `like`
    with a different structure or shapes must raise a descriptive error
    instead of silently mis-assigning arrays (ADVICE r1)."""
    import numpy as np
    import pytest as _pytest
    from cuda_flashattention_tpu.utils import checkpoint as ckpt
    monkeypatch.setattr(ckpt, "_orbax", lambda: None)  # force .npz path
    tree = {"a": np.ones((2, 3)), "b": np.zeros((4,))}
    path = ckpt.save(str(tmp_path / "x"), tree)
    assert path.endswith(".npz")
    with _pytest.raises(ValueError, match="leaves"):
        ckpt.restore(path, like={"a": np.ones((2, 3))})
    with _pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, like={"a": np.ones((3, 2)), "b": np.zeros((4,))})
    out = ckpt.restore(path, like={"a": np.zeros((2, 3)),
                                   "b": np.zeros((4,))})
    assert (out["a"] == 1).all()


def test_time_stats_median_and_quartiles():
    """time_stats reports (median, q1, q3) of block_until_ready-bracketed
    calls, for array and pytree results alike."""
    import jax.numpy as jnp
    from cuda_flashattention_tpu.utils.timing import time_fn, time_stats

    w = jnp.full((4, 4), 0.5, jnp.float32)
    med, q1, q3 = time_stats(lambda x: x @ w, jnp.ones((4, 4)), repeats=5,
                             warmup=1)
    assert 0.0 < q1 <= med <= q3
    t = time_fn(lambda p: {"a": p["a"] * 2, "b": p["b"] + 1},
                {"a": jnp.ones((2, 2)), "b": jnp.zeros((3,))}, iters=3,
                warmup=1)
    assert t > 0.0


def test_device_peaks_h100_and_unknown_raises():
    """The peaks table knows the H100 SXM; any other device kind is an
    error, never a NaN or a default."""
    import types
    import pytest
    from cuda_flashattention_tpu.utils.timing import device_peaks

    h100 = device_peaks(types.SimpleNamespace(
        device_kind="NVIDIA H100 80GB HBM3"))
    assert h100["peak_tflops"] == 989.0 and h100["peak_hbm_gbps"] == 3350.0
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(types.SimpleNamespace(device_kind="cpu"))
    with pytest.raises(KeyError):
        device_peaks()  # the test host's CPU has no row


def test_compile_cache_path_rule(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; unset, the
    cache is the checkout's .jax_cache, which git ignores."""
    import os
    import jax
    from cuda_flashattention_tpu.utils import compile_cache as cc

    assert cc.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    default = cc.cache_dir({})
    assert default == os.path.join(cc.CHECKOUT, ".jax_cache")
    with open(os.path.join(cc.CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # untouched
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        assert cc.enable_compile_cache() == default
        assert jax.config.jax_compilation_cache_dir == default
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_interpret_requires_opt_in_off_gpu(monkeypatch):
    """Off the GPU a kernel call without CFA_PALLAS_INTERPRET=1 raises
    instead of quietly running in the interpreter."""
    import pytest
    from cuda_flashattention_tpu.ops.common import interpret_mode

    assert interpret_mode() is True  # conftest opted in
    monkeypatch.setenv("CFA_PALLAS_INTERPRET", "0")
    with pytest.raises(RuntimeError, match="CFA_PALLAS_INTERPRET"):
        interpret_mode()
