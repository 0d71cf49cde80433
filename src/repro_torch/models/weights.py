"""Weights and states from the JAX package, passed through numpy.

The port keeps the JAX parameter and cache layouts (``groups``: one
stacked tree per block-pattern position with a leading ``n_rep`` axis;
``rem``: the unstacked remainder layers), so conversion is leaf for leaf.
``params_from_jax`` checks the tree against the port's own ``init`` shapes
before it converts anything.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import device as D
from .config import ModelConfig
from .transformer import _group_shapes, check_supported


def _tensor(a: Any, dev: torch.device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(dev)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def tree_from_numpy(tree: Any, device: D.DeviceLike = None, dtype=None):
    """Convert a tree (dicts, tuples, lists) of numpy arrays or scalars to
    torch tensors on ``device``; floating leaves cast to ``dtype`` when
    given.  Python ints pass through (e.g. a wire state's ``n_blocks``)."""
    dev = D.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, (int, bool)):
            return x
        return _tensor(x, dev, dtype)

    return conv(tree)


def cast_params(tree: Any, dtype=None):
    """A parameter tree with every floating leaf in ``dtype`` but the MoE
    router, which stays f32 as JAX keeps it (``init_moe``); ``dtype`` None
    returns ``tree`` as it is."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: v if k == "router" else cast_params(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_params(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def _expected_block(cfg: ModelConfig):
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    blk = {"norm1": (d,), "attn": {"wq": (d, h, hd), "wk": (d, kv, hd),
                                   "wv": (d, kv, hd), "wo": (h, hd, d)}}
    if f > 0:
        blk["norm2"] = (d,)
        e = cfg.n_experts
        blk["ffn"] = ({"router": (d, e), "w_gate": (e, d, f),
                       "w_up": (e, d, f), "w_down": (e, f, d)} if e > 0 else
                      {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    return blk


def _check(tree, expect, lead, where: str) -> None:
    if isinstance(expect, dict):
        if not isinstance(tree, dict) or set(tree) != set(expect):
            raise ValueError(f"{where}: keys {sorted(tree)} != "
                             f"{sorted(expect)}")
        for k in expect:
            _check(tree[k], expect[k], lead, f"{where}.{k}")
        return
    shape = tuple(np.shape(tree))
    if shape != tuple(lead) + tuple(expect):
        raise ValueError(f"{where}: shape {shape} != "
                         f"{tuple(lead) + tuple(expect)}")


def params_from_jax(cfg: ModelConfig, tree: Any,
                    device: D.DeviceLike = None, dtype=None):
    """The port's parameters from JAX ``transformer.init`` output passed
    through numpy (e.g. ``jax.tree.map(np.asarray, params)``).  The stacked
    group layout (``transformer._group_shapes``) is kept as is.  ``dtype``
    casts every floating leaf but the MoE router, which stays f32 as JAX
    keeps it."""
    check_supported(cfg)
    pat, n_rep, rem = _group_shapes(cfg)
    top = {"embed": (cfg.vocab_size, cfg.d_model),
           "out_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        top["unembed"] = (cfg.d_model, cfg.vocab_size)
    expect_keys = set(top) | {"groups", "rem"}
    if set(tree) != expect_keys:
        raise ValueError(f"params keys {sorted(tree)} != "
                         f"{sorted(expect_keys)}")
    for k, shape in top.items():
        _check(tree[k], shape, (), k)
    if len(tree["groups"]) != len(pat) or len(tree["rem"]) != rem:
        raise ValueError(f"{len(tree['groups'])} groups / "
                         f"{len(tree['rem'])} remainder layers; expected "
                         f"{len(pat)} / {rem}")
    for g in range(len(pat)):
        _check(tree["groups"][g], _expected_block(cfg), (n_rep,),
               f"groups[{g}]")
    for i in range(rem):
        _check(tree["rem"][i], _expected_block(cfg), (), f"rem[{i}]")
    out = cast_params(tree_from_numpy(tree, device), dtype)
    out["groups"] = tuple(out["groups"])
    out["rem"] = tuple(out["rem"])
    return out
