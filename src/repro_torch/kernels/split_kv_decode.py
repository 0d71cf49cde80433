"""Page-fused split-KV decode (port of the TPU kernel
``src/repro/kernels/split_kv_decode.py``: ``paged_decode_partials``).

``paged_decode_partials`` scores one query row per sequence against its
KV pages in place — the block table steers which physical page each
partial reads — and returns per-page (o, l, m) partials; the exact
softmax is ``core.attention_offload.combine_stacked`` over the page axis
(``ops.paged_decode_attention``).  On a CUDA tensor it launches the
hand-written kernel ``csrc/paged_decode.cu`` (which says what bounds it on
the H100); on a CPU tensor it runs the plain version
``ref.paged_decode_partials_plain``.  Nothing else falls back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib
from .ref import Partials, paged_decode_partials_plain

NAME = "paged_decode_partials"


def paged_decode_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None) -> Partials:
    """q: (B, H, D); k/v_pages: (P, bs, KV, D); pos_pages: (P, bs) int32
    (-1 = hole); block_tables: (B, nb) int32 (-1 = dead; page 0 is the
    scratch page); pos_q: (B,) int32 decode positions.  Returns o
    (B, nb, H, D), l/m (B, nb, H), f32."""
    if q.device.type == "cpu":
        return paged_decode_partials_plain(
            q, k_pages, v_pages, pos_pages, block_tables, pos_q,
            window=window, scale=scale, soft_cap=soft_cap)
    q, block_tables, pos_q = (q.contiguous(), block_tables.contiguous(),
                              pos_q.contiguous())
    dev = _lib.check_cuda(NAME, q, k_pages, v_pages, pos_pages,
                          block_tables, pos_q)
    code = _lib.dtype_code(NAME, q, k_pages, v_pages)
    _lib.check_int32(NAME, pos_pages, block_tables, pos_q)
    b, h, d = q.shape
    _, bs, kv, dk = k_pages.shape
    nb = block_tables.shape[1]
    if (dk != d or h % kv or v_pages.shape != k_pages.shape
            or pos_pages.shape != k_pages.shape[:2]
            or block_tables.shape[0] != b or pos_q.shape != (b,)):
        raise ValueError(f"{NAME}: inconsistent shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    win, cap = _lib.mask_args(window, soft_cap)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    o = torch.empty((b, nb, h, d), dtype=torch.float32, device=dev)
    l = torch.empty((b, nb, h), dtype=torch.float32, device=dev)
    m = torch.empty((b, nb, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lib.launch("paged_decode", NAME,
                    *map(_lib.ptr, (q, k_pages, v_pages, pos_pages,
                                    block_tables, pos_q, o, l, m)),
                    b, h, kv, d, bs, nb, scale, win, cap, code)
    return o, l, m
