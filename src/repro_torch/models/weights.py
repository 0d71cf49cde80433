"""Weights and states from the JAX package, passed through numpy.

The port keeps the JAX parameter and cache layouts (``groups``: one
stacked tree per block-pattern position with a leading ``n_rep`` axis;
``rem``: the unstacked remainder layers), so conversion is leaf for leaf.
``params_from_jax`` checks the tree against the port's own ``init`` shapes
before it converts anything; it takes JAX's int8 trees too
(``quantize_weights``: a matrix leaf ``{"q": int8, "s": f32}``, one scale
per stacked layer or per tensor), whose scales stay f32 whatever
``dtype``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import device as D
from .config import BlockKind, ModelConfig
from .quant import is_quantized
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


# Leaves JAX keeps in f32 whatever the model dtype: the MoE router
# (``init_moe``) and the RG-LRU's recurrence parameter (``init_rglru``).
F32_LEAVES = ("router", "a_param")


def cast_params(tree: Any, dtype=None):
    """A parameter tree with every floating leaf in ``dtype`` but the
    ``F32_LEAVES`` (the MoE router and the RG-LRU's ``a_param``), which
    stay f32 as JAX keeps them, and int8 leaves, which keep their values
    and f32 scales; ``dtype`` None returns ``tree`` as it is."""
    if dtype is None or is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: v if k in F32_LEAVES else cast_params(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_params(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def _expected_block(cfg: ModelConfig, kind: BlockKind):
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    inner = h * hd
    if kind == BlockKind.MLSTM:           # no FFN: JAX's xLSTM blocks
        return {"norm1": (d,), "rec": {
            "w_up": (d, inner), "wq": (inner, h, hd), "wk": (inner, h, hd),
            "wv": (inner, h, hd), "w_if": (inner, 2 * h),
            "w_o": (inner, inner), "w_down": (inner, d)}}
    if kind == BlockKind.SLSTM:
        return {"norm1": (d,), "rec": {"w_gates": (d, 4 * d),
                                       "r_gates": (d, 4 * d),
                                       "w_out": (d, d)}}
    if kind == BlockKind.RGLRU:
        blk = {"norm1": (d,), "rec": {
            "w_x": (d, d), "w_y": (d, d), "conv_w": (cfg.rglru_conv_width, d),
            "w_a": (d, d), "w_i": (d, d), "a_param": (d,), "w_out": (d, d)}}
    else:
        attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                "wo": (h, hd, d)}
        blk = {"norm1": (d,), "attn": attn}
        if cfg.cross_attention:
            blk.update(cross=dict(attn), cross_norm=(d,))
    if f > 0:
        blk["norm2"] = (d,)
        e = cfg.n_experts if kind != BlockKind.RGLRU else 0
        blk["ffn"] = ({"router": (d, e), "w_gate": (e, d, f),
                       "w_up": (e, d, f), "w_down": (e, f, d)} if e > 0 else
                      {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    return blk


def _check(tree, expect, lead, where: str) -> None:
    if not isinstance(expect, dict) and is_quantized(tree):
        # an int8 leaf: its values at the leaf's shape, one scale per
        # stacked layer (lead) or per tensor
        _check(tree["q"], expect, lead, f"{where}.q")
        if tuple(np.shape(tree["s"])) != tuple(lead):
            raise ValueError(f"{where}.s: shape {np.shape(tree['s'])} != "
                             f"{tuple(lead)}")
        return
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
    casts every floating leaf but ``F32_LEAVES``, which stay f32 as JAX
    keeps them."""
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
        _check(tree["groups"][g], _expected_block(cfg, pat[g]), (n_rep,),
               f"groups[{g}]")
    for i in range(rem):
        _check(tree["rem"][i], _expected_block(cfg, pat[i]), (),
               f"rem[{i}]")
    out = cast_params(tree_from_numpy(tree, device), dtype)
    out["groups"] = tuple(out["groups"])
    out["rem"] = tuple(out["rem"])
    return out
