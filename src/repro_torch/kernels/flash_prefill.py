"""Prefill attention kernels (port of the TPU kernels
``src/repro/kernels/flash_prefill.py``: ``flash_prefill`` and
``paged_prefix_partials``).

* ``flash_prefill`` — causal GQA flash attention with sliding window, soft
  cap and query position offset, normalized or as (o, l, m) partials.
  CUDA kernel ``csrc/flash_prefill.cu``.
* ``paged_prefix_partials`` — resume-chunk queries against the published
  prefix pages, read in place through the block table, one partial per
  split of ``pages_per_split`` page slots (1: the TPU kernel's one partial
  per page).  CUDA kernel ``csrc/paged_prefix.cu``.

Both kernels share the tile walk of ``csrc/attn_tile.cuh``: 4 warps of
16-row MMA tiles per block, key tiles in a cp.async ring, bf16 products on
the tensor cores.  They take head_dims that are multiples of 8 up to 256.

Each wrapper calls a custom operator (``custom_ops``:
``repro_torch::flash_prefill``, ``flash_prefill_partials``,
``paged_prefix_partials``): on a CUDA tensor it launches the kernel, on a
CPU tensor it runs the plain version from ``ref``, on ``meta`` it gives
shapes only.  Nothing else falls back.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import _lib
from .custom_ops import causal_pairs, define, placement_rules
from .ref import Partials, flash_prefill_plain, paged_prefix_partials_plain

FLASH = "flash_prefill"
PREFIX = "paged_prefix_partials"


def prefix_rows_per_block(head_dim: int) -> int:
    """Query rows per block of B3 (``csrc/paged_prefix.cu``
    ``PrefixTile``): 128 up to head_dim 128, 64 above."""
    return 128 if head_dim <= 128 else 64


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
    op = _FLASH_PARTIALS if return_partials else _FLASH
    return op(q, k, v, window, scale, soft_cap, int(seq_offset))


def _flash_cuda(q, k, v, window, scale, soft_cap, seq_offset,
                return_partials):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = _lib.check_cuda(FLASH, q, k, v)
    code = _lib.dtype_code(FLASH, q, k, v)
    b, s, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or h % kv
            or v.shape != k.shape):
        raise ValueError(f"{FLASH}: inconsistent shapes q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}, v {tuple(v.shape)}")
    _lib.check_tiles(FLASH, d, q, k, v)
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
        _lib.launch("flash_prefill", FLASH, FLASH,
                    *map(_lib.ptr, (q, k, v, o, l, m)),
                    b, s, length, h, kv, d, int(seq_offset), scale, win, cap,
                    int(return_partials), code)
    return (o, l, m) if return_partials else o


def _flash_flops(q, k, v, window, scale, soft_cap, seq_offset, **_):
    b, s, h, d = q
    return 4 * b * h * d * causal_pairs(s, k[1], seq_offset, window)


def _flash_rules(q, k, v, *scalars, partials: bool):
    """Rows along the batch, heads along the heads (q's and the kv heads
    alike), for o and, with ``partials``, l and m."""
    n = 3 if partials else 1
    tail = (None,) * len(scalars)
    return placement_rules((q, k, v) + scalars, [
        ((0,) * n, (0, 0, 0) + tail),
        ((2,) * n, (2, 2, 2) + tail)])


_FLASH_SCHEMA = ("(Tensor q, Tensor k, Tensor v, int? window, float? scale, "
                 "float? soft_cap, int seq_offset) -> {}")
_FLASH = define(
    FLASH, _FLASH_SCHEMA.format("Tensor"),
    lambda q, k, v, w, sc, cap, off: _flash_cuda(q, k, v, w, sc, cap, off,
                                                 False),
    lambda q, k, v, w, sc, cap, off: flash_prefill_plain(
        q, k, v, window=w, scale=sc, soft_cap=cap, seq_offset=off),
    lambda q, k, v, w, sc, cap, off: torch.empty_like(q),
    _flash_flops,
    lambda *a: _flash_rules(*a, partials=False))


def _flash_partials_fake(q, k, v, *_):
    b, s, h, d = q.shape
    return (q.new_empty((b, s, h, d), dtype=torch.float32),
            q.new_empty((b, s, h), dtype=torch.float32),
            q.new_empty((b, s, h), dtype=torch.float32))


_FLASH_PARTIALS = define(
    "flash_prefill_partials",
    _FLASH_SCHEMA.format("(Tensor, Tensor, Tensor)"),
    lambda q, k, v, w, sc, cap, off: _flash_cuda(q, k, v, w, sc, cap, off,
                                                 True),
    lambda q, k, v, w, sc, cap, off: tuple(flash_prefill_plain(
        q, k, v, window=w, scale=sc, soft_cap=cap, seq_offset=off,
        return_partials=True)),
    _flash_partials_fake, _flash_flops,
    lambda *a: _flash_rules(*a, partials=True))


def paged_prefix_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor,
                          positions: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None,
                          pages_per_split: int = 1) -> Partials:
    """q: (B, S, H, D) resume-chunk queries; k/v_pages: (P, bs, KV, D);
    pos_pages: (P, bs) int32; block_tables: (B, nb) int32 (-1 = dead);
    positions: (B, S) int32 absolute query positions.  Returns one partial
    per split of ``pages_per_split`` page slots (the last split ragged):
    o (B, ceil(nb / pps), S, H, D), l/m (B, ceil(nb / pps), S, H), f32.
    ``pages_per_split=1`` is the TPU kernel's one partial per page."""
    pps = int(pages_per_split)
    if pps < 1:
        raise ValueError(f"{PREFIX}: pages_per_split must be >= 1, "
                         f"got {pages_per_split}")
    return _PREFIX(q, k_pages, v_pages, pos_pages, block_tables, positions,
                   window, scale, soft_cap, pps)


def _prefix_cuda(q, k_pages, v_pages, pos_pages, block_tables, positions,
                 window, scale, soft_cap, pps):
    q, block_tables, positions = (q.contiguous(), block_tables.contiguous(),
                                  positions.contiguous())
    dev = _lib.check_cuda(PREFIX, q, k_pages, v_pages, pos_pages,
                          block_tables, positions)
    code = _lib.dtype_code(PREFIX, q, k_pages, v_pages)
    _lib.check_int32(PREFIX, pos_pages, block_tables, positions)
    b, s, h, d, bs, kv, nb = _lib.page_shapes(PREFIX, q, k_pages, v_pages,
                                              pos_pages, block_tables,
                                              positions)
    _lib.check_tiles(PREFIX, d, q, k_pages, v_pages)
    pps = min(pps, max(nb, 1))
    ns = -(-nb // pps)
    win, cap = _lib.mask_args(window, soft_cap)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    o = torch.empty((b, ns, s, h, d), dtype=torch.float32, device=dev)
    l = torch.empty((b, ns, s, h), dtype=torch.float32, device=dev)
    m = torch.empty((b, ns, s, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lib.launch("paged_prefix", PREFIX, PREFIX,
                    *map(_lib.ptr, (q, k_pages, v_pages, pos_pages,
                                    block_tables, positions, o, l, m)),
                    b, s, h, kv, d, bs, nb, pps, scale, win, cap, code)
    return o, l, m


def page_partials_fake(q, k_pages, block_tables, pps):
    """Shapes of a page kernel's partials: q (B, S, H, D), one partial per
    split of ``pps`` page slots."""
    b, s, h, d = q.shape
    nb = block_tables.shape[1]
    ns = -(-nb // min(pps, max(nb, 1)))
    return (q.new_empty((b, ns, s, h, d), dtype=torch.float32),
            q.new_empty((b, ns, s, h), dtype=torch.float32),
            q.new_empty((b, ns, s, h), dtype=torch.float32))


def page_flops(q, k_pages, block_tables) -> int:
    """4 * D per (query head, page slot) pair: every slot of the table."""
    b, s, h, d = q
    return 4 * b * s * h * d * block_tables[1] * k_pages[1]


def page_rules(q, k_pages, v_pages, pos_pages, block_tables, pos_q, *rest,
               head_dim: int, out_head_dim: int, n_scales: int = 0):
    """A page kernel's strategies: rows along the batch (the pools stay
    whole: any row may read any page), heads along the heads (q's heads
    and the pools' kv heads alike)."""
    scales = rest[:n_scales]
    tail = (None,) * (len(rest) - n_scales)
    args = (q, k_pages, v_pages, pos_pages, block_tables, pos_q) + rest
    return placement_rules(args, [
        ((0, 0, 0), (0, None, None, None, 0, 0) + (None,) * n_scales + tail),
        ((out_head_dim,) * 3, (head_dim, 2, 2, None, None, None)
         + (2,) * len(scales) + tail)])


_PREFIX = define(
    PREFIX,
    "(Tensor q, Tensor k_pages, Tensor v_pages, Tensor pos_pages, "
    "Tensor block_tables, Tensor positions, int? window, float? scale, "
    "float? soft_cap, int pages_per_split) -> (Tensor, Tensor, Tensor)",
    _prefix_cuda,
    lambda q, kp, vp, pp, bt, pos, w, sc, cap, pps: tuple(
        paged_prefix_partials_plain(q, kp, vp, pp, bt, pos, window=w,
                                    scale=sc, soft_cap=cap,
                                    pages_per_split=pps)),
    lambda q, kp, vp, pp, bt, pos, w, sc, cap, pps: page_partials_fake(
        q, kp, bt, pps),
    lambda q, kp, vp, pp, bt, pos, *_, **__: page_flops(q, kp, bt),
    lambda *a: page_rules(*a, head_dim=2, out_head_dim=3))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def prefix_pages_per_split(q: torch.Tensor, kv_heads: int, nb: int) -> int:
    """The split of the prefix pages that the serving path asks B3 for:
    ``split_rule`` with the card's SM count.  On the CPU (the plain
    version) one split per row."""
    if q.device.type != "cuda":
        return max(nb, 1)
    b, s, h, d = q.shape
    return split_rule(b, s, h, kv_heads, d, nb, sm_count(q.device))


def split_rule(b: int, s: int, h: int, kv_heads: int, head_dim: int,
               nb: int, n_sm: int) -> int:
    """Pages per split for B3 on a card of ``n_sm`` SMs.  B3 runs
    B * KV * ceil(S * G / prefix_rows_per_block(D)) blocks per split.  One
    split per row (pps = nb) writes the fewest partials; when those blocks
    would leave some SMs idle, the pages are cut into enough splits for
    about two blocks per SM (never more splits than pages)."""
    if nb <= 1:
        return max(nb, 1)
    blocks = b * kv_heads * -(-s * (h // kv_heads)
                              // prefix_rows_per_block(head_dim))
    if blocks >= n_sm:
        return nb
    n_split = min(nb, -(-2 * n_sm // blocks))
    return -(-nb // n_split)
