"""Split-KV decode, page-fused decode and speculative verification (port
of the TPU kernels ``src/repro/kernels/split_kv_decode.py``:
``split_kv_decode_partials``, ``paged_decode_partials`` and
``paged_verify_partials``).

* ``split_kv_decode_partials`` scores one query row per sequence against
  a dense KV cache, one partial per block of ``block_k`` keys.  CUDA
  kernel ``csrc/split_kv_decode.cu``.
* ``paged_decode_partials`` scores one query row per sequence against its
  KV pages in place — the block table steers which physical page each
  partial reads.  CUDA kernel ``csrc/paged_decode.cu``.
* ``paged_verify_partials`` scores S queries per sequence (the pending
  token and its proposals), each under its own causal horizon, in the
  same single pass over the pages.  CUDA kernel ``csrc/paged_verify.cu``.

The paged kernels take bf16/f32 pools, or int8 pools with their f32 scale
pools (``k_scale_pages``/``v_scale_pages``, one scale per (token entry, kv
head)), which launch the int8 variants and count under
``<name>_int8``.  All return (o, l, m) partials; the exact softmax is
``core.attention_offload.combine_stacked`` over the partition axis
(``ops.decode_attention``, ``ops.paged_decode_attention``,
``ops.paged_verify_attention``).  On a CUDA tensor each wrapper launches
its hand-written kernel (whose source says what bounds it on the H100);
on a CPU tensor it runs the plain version from ``ref``.  Nothing else
falls back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib
from .ref import (Partials, paged_decode_partials_plain,
                  paged_verify_partials_plain,
                  split_kv_decode_partials_plain)

NAME = "paged_decode_partials"
VERIFY = "paged_verify_partials"
SPLIT = "split_kv_decode_partials"


def _counter(name: str, k_scale_pages: Optional[torch.Tensor]) -> str:
    return name if k_scale_pages is None else name + "_int8"


def paged_decode_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None,
                          k_scale_pages: Optional[torch.Tensor] = None,
                          v_scale_pages: Optional[torch.Tensor] = None
                          ) -> Partials:
    """q: (B, H, D); k/v_pages: (P, bs, KV, D), or int8 with
    k/v_scale_pages (P, bs, KV) f32; pos_pages: (P, bs) int32 (-1 = hole);
    block_tables: (B, nb) int32 (-1 = dead; page 0 is the scratch page);
    pos_q: (B,) int32 decode positions.  Returns o (B, nb, H, D), l/m
    (B, nb, H), f32."""
    if q.device.type == "cpu":
        return paged_decode_partials_plain(
            q, k_pages, v_pages, pos_pages, block_tables, pos_q,
            window=window, scale=scale, soft_cap=soft_cap,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    if q.dim() != 3 or pos_q.dim() != 1:
        raise ValueError(f"{NAME}: q must be (B, H, D) and pos_q (B,), got "
                         f"{tuple(q.shape)} and {tuple(pos_q.shape)}")
    o, l, m = _lib.page_partials(
        "paged_decode", NAME, _counter(NAME, k_scale_pages), q[:, None],
        k_pages, v_pages, pos_pages, block_tables, pos_q[:, None], window,
        scale, soft_cap, k_scale_pages, v_scale_pages)
    return o[:, :, 0], l[:, :, 0], m[:, :, 0]


def paged_verify_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None,
                          k_scale_pages: Optional[torch.Tensor] = None,
                          v_scale_pages: Optional[torch.Tensor] = None
                          ) -> Partials:
    """Speculative verification, S queries per row in one page-fused pass.
    q: (B, S, H, D), the pending token plus S-1 proposals, already written
    into their pages; pos_q: (B, S) int32 absolute positions; the rest as
    ``paged_decode_partials``.  Returns o (B, nb, S, H, D), l/m
    (B, nb, S, H), f32."""
    if q.device.type == "cpu":
        return paged_verify_partials_plain(
            q, k_pages, v_pages, pos_pages, block_tables, pos_q,
            window=window, scale=scale, soft_cap=soft_cap,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    return _lib.page_partials("paged_verify", VERIFY,
                              _counter(VERIFY, k_scale_pages), q, k_pages,
                              v_pages, pos_pages, block_tables, pos_q,
                              window, scale, soft_cap, k_scale_pages,
                              v_scale_pages)


def split_kv_decode_partials(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             block_k: int = 512,
                             scale: Optional[float] = None) -> Partials:
    """Dense-cache split-KV decode.  q: (B, H, D); k, v: (B, L, KV, D);
    valid: (B, L) bool (or uint8); L a multiple of bk = min(block_k, L)
    (``ops.decode_attention`` pads).  Returns per-block partials
    o (B, J, H, D), l/m (B, J, H), f32, J = L / bk."""
    if q.device.type == "cpu":
        return split_kv_decode_partials_plain(q, k, v, valid,
                                              block_k=block_k, scale=scale)
    q, k, v, valid = (q.contiguous(), k.contiguous(), v.contiguous(),
                      valid.contiguous())
    dev = _lib.check_cuda(SPLIT, q, k, v, valid)
    code = _lib.dtype_code(SPLIT, q, k, v)
    if valid.dtype == torch.bool:
        valid = valid.view(torch.uint8)
    b, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    bk = min(int(block_k), length)
    if (k.shape[0] != b or k.shape[3] != d or h % kv or v.shape != k.shape
            or valid.shape != (b, length) or valid.dtype != torch.uint8
            or bk < 1 or length % bk):
        raise ValueError(f"{SPLIT}: inconsistent inputs q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, valid {tuple(valid.shape)} "
                         f"{valid.dtype}, block_k {bk}")
    nj = length // bk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    o = torch.empty((b, nj, h, d), dtype=torch.float32, device=dev)
    l = torch.empty((b, nj, h), dtype=torch.float32, device=dev)
    m = torch.empty((b, nj, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lib.launch("split_kv_decode", SPLIT, SPLIT,
                    *map(_lib.ptr, (q, k, v, valid, o, l, m)),
                    b, h, kv, d, length, bk, scale, code)
    return o, l, m
