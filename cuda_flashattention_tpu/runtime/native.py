"""ctypes bridge to the native (C++/OpenMP) exact-attention oracle.

The reference's oracle is native C++ (ref: src/util/naive_attention.h,
compiled into every test main); this module keeps that property in the
framework: `csrc/naive_attention.cpp` is built once with g++ -O3 -fopenmp
into a cached shared library and exposed here with numpy-array wrappers.
The JAX oracle (ops.naive) remains the differentiable/on-device reference;
this one is the independent, framework-free cross-check (two oracles that
agree catch bugs a single oracle cannot) and is ~cores× faster on big CPUs
for ladder-scale shapes like the reference's seq=5096 ring test.

Build strategy mirrors the reference's compile-at-launch scripts
(ref: scripts/local_gpu.sh:35-52 invokes nvcc per run; we cache by source
hash instead of recompiling every time). No pybind11 — plain C ABI via
ctypes, per the environment's constraints.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from cuda_flashattention_tpu import config as _config

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc",
    "naive_attention.cpp")
_CACHE_DIR = _config.NATIVE_CACHE()


class NativeBuildError(RuntimeError):
    pass


def _build() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    lib_path = os.path.join(_CACHE_DIR, f"libcfa_naive_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = tempfile.mktemp(suffix=".so", dir=_CACHE_DIR)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not found: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"native oracle build failed:\n{e.stderr}") from e
    os.replace(tmp, lib_path)  # atomic vs concurrent builders
    return lib_path


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build())
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cfa_naive_forward.argtypes = [
        f32p, f32p, f32p, f32p, f32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_int64]
    lib.cfa_naive_forward.restype = None
    lib.cfa_naive_backward.argtypes = [
        f32p, f32p, f32p, f32p, f32p, f32p, f32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_int64]
    lib.cfa_naive_backward.restype = None
    lib.cfa_num_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True if the native oracle can be built/loaded on this machine."""
    try:
        _lib()
        return True
    except NativeBuildError:
        return False


def num_threads() -> int:
    return int(_lib().cfa_num_threads())


def _prep(x, bh, n, d) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x, dtype=np.float32)
                             .reshape(bh, n, d))
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def naive_attention_native(
    q, k, v, scale: Optional[float] = None, causal: bool = False,
    kv_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact attention fwd on the native oracle. q [..., Nq, d],
    k/v [..., Nk, d] -> (O fp32, LSE fp32) with the input's leading dims."""
    q = np.asarray(q, np.float32)
    lead = q.shape[:-2]
    nq, d = q.shape[-2:]
    nk = np.asarray(k).shape[-2]
    bh = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    qa = _prep(q, bh, nq, d)
    ka = _prep(k, bh, nk, d)
    va = _prep(v, bh, nk, d)
    o = np.zeros((bh, nq, d), np.float32)
    lse = np.zeros((bh, nq), np.float32)
    _lib().cfa_naive_forward(
        _ptr(qa), _ptr(ka), _ptr(va), _ptr(o), _ptr(lse),
        bh, nq, nk, d, ctypes.c_float(scale), int(causal), kv_offset)
    return o.reshape(*lead, nq, d), lse.reshape(*lead, nq)


def naive_attention_backward_native(
    q, k, v, do, scale: Optional[float] = None, causal: bool = False,
    kv_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact attention bwd on the native oracle -> (dQ, dK, dV) fp32."""
    q = np.asarray(q, np.float32)
    lead = q.shape[:-2]
    nq, d = q.shape[-2:]
    nk = np.asarray(k).shape[-2]
    bh = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    qa = _prep(q, bh, nq, d)
    ka = _prep(k, bh, nk, d)
    va = _prep(v, bh, nk, d)
    doa = _prep(do, bh, nq, d)
    dq = np.zeros((bh, nq, d), np.float32)
    dk = np.zeros((bh, nk, d), np.float32)
    dv = np.zeros((bh, nk, d), np.float32)
    _lib().cfa_naive_backward(
        _ptr(qa), _ptr(ka), _ptr(va), _ptr(doa),
        _ptr(dq), _ptr(dk), _ptr(dv),
        bh, nq, nk, d, ctypes.c_float(scale), int(causal), kv_offset)
    return (dq.reshape(*lead, nq, d), dk.reshape(*lead, nk, d),
            dv.reshape(*lead, nk, d))
