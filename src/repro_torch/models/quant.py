"""Int8 weights for serving, and the int8 KV page helpers (the port's copy
of the JAX package's ``models/quant.py``).

Matrix parameters are stored as int8 with one f32 scale per tensor, or,
for a leaf of a stacked layer group (``groups``, leading axis the layer
repeat), one scale per layer, so a layer's view slices its scale with its
values.  ``transformer.apply`` dequantizes each layer's leaves inside the
layer loop, and the embedding and unembedding where it reads them, so the
residency halves against bf16 while the products still run in the
compute dtype.  Norms and conv taps (``_SKIP_NAMES``) and vectors stay as
they are.

A quantized leaf is the dict ``{"q": int8 tensor, "s": f32 tensor}``; the
model detects the structure, so no config flag is needed.  The values
equal JAX's bit for bit on the same f32 input: f32 amax, ``max(amax,
1e-8) / 127``, the quotient rounded half to even (``torch.round`` rounds
as ``jnp.round``) and clipped to +-127.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

_SKIP_NAMES = {"norm1", "norm2", "cross_norm", "out_norm", "a_param",
               "conv_w"}


def _quant(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round(x / s) clipped to the int8 grid, in f32 as JAX computes it."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _quant_leaf(x: torch.Tensor, stacked: bool):
    min_rank = 3 if stacked else 2      # matrices only; norm vectors stay
    if x.dim() < min_rank or not x.is_floating_point():
        return x
    if not stacked:
        s = x.float().abs().amax().clamp_min(1e-8) / 127.0
        return {"q": _quant(x, s), "s": s}
    # one scale per stacked layer, quantized layer by layer: the peak
    # beyond the result is one layer's f32 copy
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for r in range(x.shape[0]):
        s[r] = x[r].float().abs().amax().clamp_min(1e-8) / 127.0
        q[r] = _quant(x[r], s[r])
    return {"q": q, "s": s}


def quantize_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every matrix parameter (norms and conv taps stay as they
    are; the tree's dicts and tuples are rebuilt, its tensors not
    modified)."""
    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, names + (str(i),))
                              for i, v in enumerate(tree))
        if not torch.is_tensor(tree) or any(n in _SKIP_NAMES
                                            for n in names):
            return tree
        return _quant_leaf(tree, stacked=bool(names) and names[0] == "groups")
    return walk(params, ())


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def dequant(leaf, dtype=torch.bfloat16):
    """Dequantize one (possibly quantized) parameter: q * s in f32, rounded
    to ``dtype`` (JAX's ``(q.astype(f32) * s).astype(dtype)``, value for
    value) in one elementwise pass that reads the int8 values and writes
    ``dtype``: no f32 copy of the tensor is made.  Anything else is
    returned as it is."""
    if is_quantized(leaf):
        q, s = leaf["q"], leaf["s"]
        s_b = s.reshape(s.shape + (1,) * (q.dim() - s.dim()))
        return torch.mul(q, s_b, out=torch.empty(q.shape, dtype=dtype,
                                                 device=q.device))
    return leaf


def dequant_tree(params, dtype=torch.bfloat16):
    """Dequantize a parameter subtree (e.g. one layer's views)."""
    if is_quantized(params):
        return dequant(params, dtype)
    if isinstance(params, dict):
        return {k: dequant_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(dequant_tree(v, dtype) for v in params)
    return params


# ---------------------------------------------------------------------------
# int8 KV pages
# ---------------------------------------------------------------------------
#
# A quantized KV page stores int8 values plus one f32 scale per (token
# entry, kv head), pool-shaped: values (..., block, KV, D), scales
# (..., block, KV), the layout of the int8 page pools kernels B1/B4 read.

def quantize_kv_page(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., block, KV, D) float -> (int8 of the same shape, f32
    (..., block, KV)) on the symmetric 127-step grid."""
    s = x.float().abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return _quant(x, s[..., None]), s


def dequantize_kv_page(q: torch.Tensor, s: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_kv_page`` (up to the int8 grid)."""
    return dequant({"q": q, "s": s[..., None]}, dtype)


def quantize_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor):
    """Quantize a K/V page-pool pair -> (k_q, k_scale, v_q, v_scale)."""
    kq, ks = quantize_kv_page(k_pages)
    vq, vs = quantize_kv_page(v_pages)
    return kq, ks, vq, vs
