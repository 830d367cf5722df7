"""Checkpoint save/restore for params, optimizer state, and KV caches.

The reference has no checkpointing (SURVEY.md §5 marks it "not required
for parity"); a training/serving framework needs it, so this thin layer
wraps Orbax (JAX's checkpointer: async-friendly, sharding-aware
— restores respect the arrays' target shardings on a mesh) with a
fallback pure-numpy .npz path for environments without orbax.

    from cuda_flashattention_tpu.utils import checkpoint as ckpt
    ckpt.save("/tmp/run1/step100", {"params": params, "opt": opt_state})
    state = ckpt.restore("/tmp/run1/step100", like={"params": params,
                                                    "opt": opt_state})
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np


def _orbax():
    try:
        import orbax.checkpoint as ocp
        return ocp
    except ImportError:
        return None


def save(path: str, tree: Any, force: bool = True) -> str:
    """Save a pytree of arrays. Uses Orbax when available, else .npz."""
    ocp = _orbax()
    path = os.path.abspath(path)
    if ocp is not None:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, tree, force=force)
        ckptr.wait_until_finished()
        return path
    flat, _ = jax.tree_util.tree_flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **{str(i): np.asarray(x)
                               for i, x in enumerate(flat)})
    return path + ".npz"


def restore(path: str, like: Any) -> Any:
    """Restore a pytree saved by `save`. `like` supplies the structure
    (and, under Orbax, the target shardings/dtypes — pass arrays laid out
    on the destination mesh to restore sharded)."""
    ocp = _orbax()
    path = os.path.abspath(path)
    if ocp is not None and os.path.isdir(path):
        ckptr = ocp.StandardCheckpointer()
        return ckptr.restore(path, target=like)
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    flat, treedef = jax.tree_util.tree_flatten(like)
    if len(flat) != len(data.files):
        raise ValueError(
            f"checkpoint {path} holds {len(data.files)} arrays but `like` "
            f"has {len(flat)} leaves — structure mismatch (the .npz path "
            f"keys arrays by flattened-tree position)")
    out = []
    for i, x in enumerate(flat):
        arr = data[str(i)]
        if tuple(arr.shape) != tuple(np.shape(x)):
            raise ValueError(
                f"checkpoint leaf {i}: saved shape {tuple(arr.shape)} != "
                f"target shape {tuple(np.shape(x))} — `like` does not "
                f"match the saved tree")
        out.append(jax.numpy.asarray(arr, dtype=x.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)
