"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and its
phase functions must pass at a tiny size with the kernels in the
Pallas interpreter (the card runs them at full width)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=4, d_head=16, d_ff=128)


def test_refuses_a_cpu_device(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_refuses_without_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_kernels_tiny():
    cs.phase_kernels(b=1, h=4, hkv_gqa=2, n=64, d=16, window=24,
                     ragged_n=50, kv_offset=10, segment_len=16, dec_b=4,
                     dec_h=4, dec_hkv=2, dec_ctx=96, page_size=16,
                     max_pages=4)


def test_phase_train_tiny():
    cs.phase_train(batch=1, seq=64, steps=2, cfg_kw=SMALL)


def test_phase_serve_tiny():
    cs.phase_serve(batch=2, prompt=16, new=4, cfg_kw=dict(SMALL,
                                                          n_kv_heads=2))


def test_phase_cards_tiny():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    cs.phase_cards(n_cards=4, n=128, h=2, d=16, dec_ctx=512, dec_h=2,
                   train_seq=32, cfg_kw=SMALL)


def test_check_raises_on_a_failed_comparison():
    cs.check("within tolerance", 1e-3, 1e-2)
    with pytest.raises(AssertionError):
        cs.check("over tolerance", 2e-2, 1e-2)
    with pytest.raises(AssertionError):
        cs.check("not finite", float("nan"), 1e-2)


@pytest.mark.gpu
def test_chip_smoke_kernels_on_the_card():
    """On the card: the kernel phase at a reduced size, compiled."""
    cs.phase_kernels(n=1024, dec_ctx=4096)
