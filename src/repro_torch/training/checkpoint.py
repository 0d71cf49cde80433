"""Flat-file checkpointing: tree -> .npz + structure manifest, in the JAX
package's format (``training/checkpoint.py``).

The files are ``ckpt_{step}.npz`` and ``ckpt_{step}.json``, and the
leaves are named as ``jax.tree_util`` paths print (``training/tree.py``:
``"groups/0/attn/wq"``), so a checkpoint written by one package restores
in the other.  bf16 leaves are written as their raw 2-byte values, which
is what JAX's ``np.savez`` of an ml_dtypes bf16 array writes (they load
as ``|V2``), and read back through a ``uint16`` view; no ml_dtypes is
needed.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from .tree import map_named, named_leaves


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:     # raw bf16
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(path: str, tree, step: int = 0,
         meta: Dict[str, Any] | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = {name: _to_numpy(leaf) for name, leaf in named_leaves(tree)}
    np.savez(os.path.join(path, f"ckpt_{step}.npz"), **flat)
    manifest = {"step": step, "leaves": sorted(flat), "meta": meta or {}}
    with open(os.path.join(path, f"ckpt_{step}.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:-5]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".json")]
    return max(steps) if steps else None


def restore(path: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like``: each leaf on its
    device and in its dtype.  Returns (tree, step).  A leaf whose shape
    differs raises ``ValueError``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with np.load(os.path.join(path, f"ckpt_{step}.npz")) as data:
        def load(name, leaf):
            arr = data[name]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            return _from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)

        return map_named(load, tree_like), step
