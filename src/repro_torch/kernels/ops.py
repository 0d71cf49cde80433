"""Public attention entry points over the port's kernels.

Same contracts as the JAX package's ``kernels/ops.py``: padding to block
multiples, then the kernel, then the exact (o, l, m) combine for the
partial-emitting kernels.  Each kernel wrapper launches its CUDA kernel on
CUDA tensors and runs its plain version on CPU tensors; ``LAUNCHES``
counts the kernel launches (``reset_launches`` zeroes them).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.attention_offload import combine_stacked
from ._lib import LAUNCHES, reset_launches
from .flash_prefill import (flash_prefill, paged_prefix_partials,
                            prefix_pages_per_split)
from .split_kv_decode import (decode_pages_per_split, paged_decode_partials,
                              paged_verify_partials, split_kv_decode_partials,
                              verify_pages_per_split)

__all__ = ["LAUNCHES", "reset_launches", "flash_attention",
           "decode_attention", "decode_partials", "paged_decode_attention",
           "paged_verify_attention", "paged_prefill_attention"]


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad (False for a bool tensor) ``axis`` to a multiple."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def _pad_suffix(q, k, v, block_q: int, block_k: int):
    """The JAX wrappers' padding: queries to a multiple of
    min(block_q, pow2(S)), keys to the query length and then to the key
    block; padded keys sit in every real query's future."""
    s = q.shape[1]
    pow2 = 1 << max((s - 1).bit_length(), 3)
    bq = min(block_q, pow2)
    qp = _pad_to(q, 1, bq)
    tgt = qp.shape[1]
    bk = min(block_k, tgt)
    kp = _pad_to(_pad_to(k, 1, tgt), 1, bk)
    vp = _pad_to(_pad_to(v, 1, tgt), 1, bk)
    return qp, kp, vp


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    soft_cap: Optional[float] = None,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Causal (sliding-window, soft-capped) GQA flash attention of a fresh
    prefill.  q: (B, S, H, D); k, v: (B, S, KV, D).  Returns (B, S, H, D)
    in q's dtype."""
    s = q.shape[1]
    qp, kp, vp = _pad_suffix(q, k, v, block_q, block_k)
    out = flash_prefill(qp, kp, vp, window=window, scale=scale,
                        soft_cap=soft_cap)
    return out[:, :s]


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, *, block_k: int = 512,
                    scale: Optional[float] = None):
    """Raw per-block partials of single-token decode over a dense cache —
    what attention-level migration ships across devices, one per
    bk = min(block_k, L) keys (the last block ragged: the kernel reads the
    cache in place, no padded copy).  q: (B, H, D); k, v: (B, L, KV, D),
    or a contiguous range of a wider cache's kv heads; valid: (B, L) bool.
    Returns o (B, J, H, D), l/m (B, J, H), f32."""
    return split_kv_decode_partials(q, k, v, valid.bool(), block_k=block_k,
                                    scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, block_k: int = 512,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over a (ring or linear) dense cache:
    per-block partials from ``split_kv_decode_partials``, combined exactly
    over the block axis (flash decoding).  q: (B, H, D); k, v:
    (B, L, KV, D); valid: (B, L) bool.  Returns (B, H, D) in q's dtype."""
    o, l, m = decode_partials(q, k, v, valid, block_k=block_k, scale=scale)
    out = combine_stacked((o.movedim(1, 0), l.movedim(1, 0),
                           m.movedim(1, 0)))
    return out.to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pos_pages: torch.Tensor,
                           block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           soft_cap: Optional[float] = None,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None,
                           pages_per_split: Optional[int] = None
                           ) -> torch.Tensor:
    """Page-fused decode straight out of the block pool: partials from
    ``paged_decode_partials``, one per split of ``pages_per_split`` page
    slots (None: the split ``decode_pages_per_split`` picks for the card),
    combined exactly over the split axis.  q: (B, H, D); k/v_pages:
    (P, bs, KV, D), or int8 with k/v_scale_pages (P, bs, KV) f32
    (dequantized in the kernel); pos_pages: (P, bs); block_tables: (B, nb);
    pos_q: (B,).  Returns (B, H, D) in q's dtype."""
    if pages_per_split is None:
        pages_per_split = decode_pages_per_split(q, k_pages.shape[2],
                                                 block_tables.shape[1])
    o, l, m = paged_decode_partials(q, k_pages, v_pages, pos_pages,
                                    block_tables, pos_q, window=window,
                                    scale=scale, soft_cap=soft_cap,
                                    k_scale_pages=k_scale_pages,
                                    v_scale_pages=v_scale_pages,
                                    pages_per_split=pages_per_split)
    out = combine_stacked((o.movedim(1, 0), l.movedim(1, 0),
                           m.movedim(1, 0)))
    return out.to(q.dtype)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pos_pages: torch.Tensor,
                           block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           soft_cap: Optional[float] = None,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None,
                           pages_per_split: Optional[int] = None
                           ) -> torch.Tensor:
    """Speculative verification straight out of the block pool: S queries
    per row (each at its own position, so the causal order among the
    in-flight tokens is the position test) from ``paged_verify_partials``,
    one partial per split of ``pages_per_split`` page slots (None: the
    split ``verify_pages_per_split`` picks for the card), combined exactly
    over the split axis.  q: (B, S, H, D); k/v_pages: (P, bs, KV, D), or
    int8 with k/v_scale_pages (P, bs, KV); pos_pages: (P, bs);
    block_tables: (B, nb); pos_q: (B, S).  Returns (B, S, H, D) in q's
    dtype."""
    if pages_per_split is None:
        pages_per_split = verify_pages_per_split(
            q, k_pages.shape[2], block_tables.shape[1],
            int8=k_scale_pages is not None)
    o, l, m = paged_verify_partials(q, k_pages, v_pages, pos_pages,
                                    block_tables, pos_q, window=window,
                                    scale=scale, soft_cap=soft_cap,
                                    k_scale_pages=k_scale_pages,
                                    v_scale_pages=v_scale_pages,
                                    pages_per_split=pages_per_split)
    out = combine_stacked((o.movedim(1, 0), l.movedim(1, 0),
                           m.movedim(1, 0)))
    return out.to(q.dtype)


def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, pos_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            positions: torch.Tensor, *,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            soft_cap: Optional[float] = None,
                            block_q: int = 256,
                            block_k: int = 256,
                            pages_per_split: Optional[int] = None
                            ) -> torch.Tensor:
    """Paged chunked prefill: resume-chunk queries attend over the
    published prefix pages (``paged_prefix_partials``, one partial per
    split of ``pages_per_split`` page slots; None: the split
    ``prefix_pages_per_split`` picks for the card) plus the in-flight
    suffix (``flash_prefill`` partials, the chunk against itself) — two
    partitions of one exact softmax.  The prefix pools are read before the
    suffix is written into them.

    q: (B, S, H, D); k, v: (B, S, KV, D) suffix keys/values;
    k/v_pages: (P, bs, KV, D); pos_pages: (P, bs); block_tables: (B, nb);
    positions: (B, S) absolute query positions.  Returns (B, S, H, D)."""
    s = q.shape[1]
    if pages_per_split is None:
        pages_per_split = prefix_pages_per_split(q, k_pages.shape[2],
                                                 block_tables.shape[1])
    po, pl, pm = paged_prefix_partials(q, k_pages, v_pages, pos_pages,
                                       block_tables, positions,
                                       window=window, scale=scale,
                                       soft_cap=soft_cap,
                                       pages_per_split=pages_per_split)
    qp, kp, vp = _pad_suffix(q, k, v, block_q, block_k)
    so, sl, sm = flash_prefill(qp, kp, vp, window=window, scale=scale,
                               soft_cap=soft_cap, return_partials=True)
    out = combine_stacked((po.movedim(1, 0), pl.movedim(1, 0),
                           pm.movedim(1, 0)),
                          (so[None, :, :s], sl[None, :, :s],
                           sm[None, :, :s]))
    return out.to(q.dtype)
