"""Prefill attention kernels (port of the TPU kernels
``src/repro/kernels/flash_prefill.py``: ``flash_prefill`` and
``paged_prefix_partials``).

* ``flash_prefill`` — causal GQA flash attention with sliding window, soft
  cap and query position offset, normalized or as (o, l, m) partials.
  CUDA kernel ``csrc/flash_prefill.cu``.
* ``paged_prefix_partials`` — resume-chunk queries against the published
  prefix pages, one partial per page, read in place through the block
  table.  CUDA kernel ``csrc/paged_prefix.cu``.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs the plain version from ``ref``.  Nothing else falls back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib
from .ref import Partials, flash_prefill_plain, paged_prefix_partials_plain

FLASH = "flash_prefill"
PREFIX = "paged_prefix_partials"


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None,
                  scale: Optional[float] = None,
                  soft_cap: Optional[float] = None,
                  seq_offset: int = 0,
                  return_partials: bool = False):
    """q: (B, S, H, D); k, v: (B, L, KV, D).  Queries sit at positions
    seq_offset..seq_offset+S-1 of the key axis.  Returns (B, S, H, D) in
    q's dtype, or with ``return_partials`` the unnormalized o (B, S, H, D)
    and l/m (B, S, H), all f32."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window, scale=scale,
                                   soft_cap=soft_cap, seq_offset=seq_offset,
                                   return_partials=return_partials)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = _lib.check_cuda(FLASH, q, k, v)
    code = _lib.dtype_code(FLASH, q, k, v)
    b, s, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or h % kv
            or v.shape != k.shape):
        raise ValueError(f"{FLASH}: inconsistent shapes q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}, v {tuple(v.shape)}")
    win, cap = _lib.mask_args(window, soft_cap)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if return_partials:
        o = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
        l = torch.empty((b, s, h), dtype=torch.float32, device=dev)
        m = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    else:
        o = torch.empty_like(q)
        l = m = o             # not written by the normalized kernel
    with torch.cuda.device(dev):
        _lib.launch("flash_prefill", FLASH,
                    *map(_lib.ptr, (q, k, v, o, l, m)),
                    b, s, length, h, kv, d, int(seq_offset), scale, win, cap,
                    int(return_partials), code)
    return (o, l, m) if return_partials else o


def paged_prefix_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor,
                          positions: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None) -> Partials:
    """q: (B, S, H, D) resume-chunk queries; k/v_pages: (P, bs, KV, D);
    pos_pages: (P, bs) int32; block_tables: (B, nb) int32 (-1 = dead);
    positions: (B, S) int32 absolute query positions.  Returns o
    (B, nb, S, H, D), l/m (B, nb, S, H), f32."""
    if q.device.type == "cpu":
        return paged_prefix_partials_plain(
            q, k_pages, v_pages, pos_pages, block_tables, positions,
            window=window, scale=scale, soft_cap=soft_cap)
    q, block_tables, positions = (q.contiguous(), block_tables.contiguous(),
                                  positions.contiguous())
    dev = _lib.check_cuda(PREFIX, q, k_pages, v_pages, pos_pages,
                          block_tables, positions)
    code = _lib.dtype_code(PREFIX, q, k_pages, v_pages)
    _lib.check_int32(PREFIX, pos_pages, block_tables, positions)
    b, s, h, d = q.shape
    _, bs, kv, dk = k_pages.shape
    nb = block_tables.shape[1]
    if (dk != d or h % kv or v_pages.shape != k_pages.shape
            or pos_pages.shape != k_pages.shape[:2]
            or block_tables.shape[0] != b or positions.shape != (b, s)):
        raise ValueError(f"{PREFIX}: inconsistent shapes q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}")
    win, cap = _lib.mask_args(window, soft_cap)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    o = torch.empty((b, nb, s, h, d), dtype=torch.float32, device=dev)
    l = torch.empty((b, nb, s, h), dtype=torch.float32, device=dev)
    m = torch.empty((b, nb, s, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lib.launch("paged_prefix", PREFIX,
                    *map(_lib.ptr, (q, k_pages, v_pages, pos_pages,
                                    block_tables, positions, o, l, m)),
                    b, s, h, kv, d, bs, nb, scale, win, cap, code)
    return o, l, m
