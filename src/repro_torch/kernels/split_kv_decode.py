"""Split-KV decode, page-fused decode and speculative verification (port
of the TPU kernels ``src/repro/kernels/split_kv_decode.py``:
``split_kv_decode_partials``, ``paged_decode_partials`` and
``paged_verify_partials``).

* ``split_kv_decode_partials`` scores one query row per sequence against
  a dense KV cache, one partial per block of ``block_k`` keys.  CUDA
  kernel ``csrc/split_kv_decode.cu``.
* ``paged_decode_partials`` scores one query row per sequence against its
  KV pages in place — the block table steers which physical pages each
  partial reads — one partial per split of ``pages_per_split`` page slots
  (1: the TPU kernel's one partial per page; the serving path asks for
  ``decode_pages_per_split``).  CUDA kernel ``csrc/paged_decode.cu``.
* ``paged_verify_partials`` scores S queries per sequence (the pending
  token and its proposals), each under its own causal horizon, in the
  same single pass over the pages, one partial per split of
  ``pages_per_split`` page slots (1: the TPU kernel's contract; the
  serving path asks for ``verify_pages_per_split``).  CUDA kernel
  ``csrc/paged_verify.cu``: up to ``VERIFY_WALK_ROWS`` query rows per kv
  head, and int8 pools at any count, on the key walk (on the tensor cores
  for bf16 queries); more rows of bf16/f32 pools on B3's tensor-core body
  (``csrc/paged_prefix.cuh``).

All three run the key walk of ``csrc/decode_walk.cuh`` (the two paged
ones also its page stream): the keys spread over the 4 warps of a block,
K/V tiles of ``decode_tile_keys`` keys in a four-stage cp.async ring; they
take head_dims that are multiples of 8 (16 for int8 pools) up to 256.

The paged kernels take bf16/f32 pools, or int8 pools with their f32 scale
pools (``k_scale_pages``/``v_scale_pages``, one scale per (token entry, kv
head)), which launch the int8 variants and count under
``<name>_int8``.  All return (o, l, m) partials; the exact softmax is
``core.attention_offload.combine_stacked`` over the partition axis
(``ops.decode_attention``, ``ops.paged_decode_attention``,
``ops.paged_verify_attention``).  Each wrapper calls a custom operator
(``custom_ops``: ``repro_torch::paged_decode_partials``,
``paged_verify_partials``, ``split_kv_decode_partials``): on a CUDA
tensor it launches the hand-written kernel (whose source says what bounds
it on the H100), on a CPU tensor it runs the plain version from ``ref``,
on ``meta`` it gives shapes only.  Nothing else falls back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib
from .custom_ops import define, placement_rules, shards_on
from .flash_prefill import (page_flops, page_partials_fake, page_rules,
                            prefix_rows_per_block, sm_count, split_rule)
from .ref import (Partials, paged_decode_partials_plain,
                  paged_verify_partials_plain,
                  split_kv_decode_partials_plain)

NAME = "paged_decode_partials"
VERIFY = "paged_verify_partials"
SPLIT = "split_kv_decode_partials"
MAX_BLOCK_K = 16384     # B5 keeps a key block's validity in shared memory
# B1's target of blocks per SM when it cuts rows into splits
DECODE_BLOCKS_PER_SM = 8
# B4 scores up to this many query rows per kv head (S * G) of a bf16/f32
# pool on a walk, more on B3's tile body (csrc/paged_verify.cu)
VERIFY_WALK_ROWS = 16


def _counter(name: str, k_scale_pages: Optional[torch.Tensor]) -> str:
    return name if k_scale_pages is None else name + "_int8"


def decode_tile_keys(head_dim: int, itemsize: int) -> int:
    """Keys per K/V tile of the decode walk (``csrc/decode_walk.cuh``
    ``Walk::kBk``): about 8 KB of K at the head_dim padded to 64, 128 or
    256, between 32 and 128 keys."""
    dp = 64 if head_dim <= 64 else (128 if head_dim <= 128 else 256)
    return max(32, min(128, 8192 // (dp * itemsize)))


def decode_rows_per_block(g: int) -> int:
    """Query heads per block of the decode walk (``dec::rows_per_block``):
    1, 4 or 8; a kv head of G > 8 query heads takes ceil(G / 8) blocks."""
    return 1 if g == 1 else (4 if g <= 4 else 8)


def verify_rows_per_block(rows: int, head_dim: int,
                          int8: bool = False) -> int:
    """Query rows per block of B4 for S * G packed rows
    (``csrc/paged_verify.cu``) with bf16 queries: 16 on the tensor-core
    walk for int8 pools, and for bf16 pools up to ``VERIFY_WALK_ROWS``
    rows; above, B3's body and ``prefix_rows_per_block`` rows.  (f32
    queries, the tests' type, take the FMA walk's 4 to 16.)  A kv head of
    more rows takes ceil(S * G / rows per block) blocks, each reading its
    pages."""
    if int8 or rows <= VERIFY_WALK_ROWS:
        return VERIFY_WALK_ROWS
    return prefix_rows_per_block(head_dim)


def _pages_per_split(blocks: int, nb: int, n_sm: int) -> int:
    """Pages per split when a launch runs ``blocks`` blocks per split:
    each row cut into enough splits for about ``DECODE_BLOCKS_PER_SM``
    blocks per SM, never more splits than pages."""
    if nb <= 1:
        return max(nb, 1)
    n_split = min(nb, -(-DECODE_BLOCKS_PER_SM * n_sm // blocks))
    return -(-nb // n_split)


def decode_pages_per_split(q: torch.Tensor, kv_heads: int, nb: int) -> int:
    """The split of the pages that the serving path asks B1 for:
    ``decode_split_rule`` with the card's SM count.  On the CPU (the plain
    version) one split per row."""
    if q.device.type != "cuda":
        return max(nb, 1)
    return decode_split_rule(q.shape[0], q.shape[1], kv_heads, nb,
                             sm_count(q.device))


def decode_split_rule(b: int, h: int, kv_heads: int, nb: int,
                      n_sm: int) -> int:
    """Pages per split for B1 on a card of ``n_sm`` SMs.  B1 runs
    B * KV * ceil(G / decode_rows_per_block(G)) blocks per split; the pages
    of each row are cut into enough splits for about
    ``DECODE_BLOCKS_PER_SM`` blocks per SM (one split per row when the
    blocks reach that already, never more splits than pages).  Rows of
    different lengths leave SMs idle at the end of a launch; many short
    blocks even that out at the cost of more partials."""
    g = h // kv_heads
    blocks = b * kv_heads * -(-g // decode_rows_per_block(g))
    return _pages_per_split(blocks, nb, n_sm)


def verify_pages_per_split(q: torch.Tensor, kv_heads: int, nb: int,
                           int8: bool = False) -> int:
    """The split of the pages that the serving path asks B4 (``int8``:
    B4-int8) for: ``verify_split_rule`` with the card's SM count.  On the
    CPU (the plain version) one split per row.  q: (B, S, H, D)."""
    if q.device.type != "cuda":
        return max(nb, 1)
    b, s, h, d = q.shape
    return verify_split_rule(b, s, h, kv_heads, d, nb, sm_count(q.device),
                             int8)


def verify_split_rule(b: int, s: int, h: int, kv_heads: int, d: int,
                      nb: int, n_sm: int, int8: bool = False) -> int:
    """Pages per split for B4 (``int8``: B4-int8) on a card of ``n_sm``
    SMs, for the body that runs: a walk up to ``VERIFY_WALK_ROWS`` query
    rows per kv head (and for int8 pools), B3's tile body above, which on
    the card beat the walk at 20 and 80 rows (PERF.md).  A walk takes B1's
    target of about ``DECODE_BLOCKS_PER_SM`` blocks per SM, counting
    B * KV * ceil(S * G / verify_rows_per_block(S * G, d, int8)) blocks per
    split; the tile body B3's own ``split_rule``."""
    rows = s * (h // kv_heads)
    if not int8 and rows > VERIFY_WALK_ROWS:
        return split_rule(b, s, h, kv_heads, d, nb, n_sm)
    blocks = b * kv_heads * -(-rows // verify_rows_per_block(rows, d, int8))
    return _pages_per_split(blocks, nb, n_sm)


def paged_decode_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None,
                          k_scale_pages: Optional[torch.Tensor] = None,
                          v_scale_pages: Optional[torch.Tensor] = None,
                          pages_per_split: int = 1) -> Partials:
    """q: (B, H, D); k/v_pages: (P, bs, KV, D), or int8 with
    k/v_scale_pages (P, bs, KV) f32; pos_pages: (P, bs) int32 (-1 = hole);
    block_tables: (B, nb) int32 (-1 = dead; page 0 is the scratch page);
    pos_q: (B,) int32 decode positions.  Returns one partial per split of
    ``pages_per_split`` page slots (the last split ragged): o
    (B, ceil(nb / pps), H, D), l/m (B, ceil(nb / pps), H), f32.
    ``pages_per_split=1`` is the TPU kernel's one partial per page."""
    pps = int(pages_per_split)
    if pps < 1:
        raise ValueError(f"{NAME}: pages_per_split must be >= 1, "
                         f"got {pages_per_split}")
    return _DECODE(q, k_pages, v_pages, pos_pages, block_tables, pos_q,
                   k_scale_pages, v_scale_pages, window, scale, soft_cap,
                   pps)


def _decode_cuda(q, k_pages, v_pages, pos_pages, block_tables, pos_q,
                 k_scale_pages, v_scale_pages, window, scale, soft_cap, pps):
    if q.dim() != 3 or pos_q.dim() != 1:
        raise ValueError(f"{NAME}: q must be (B, H, D) and pos_q (B,), got "
                         f"{tuple(q.shape)} and {tuple(pos_q.shape)}")
    counter = _counter(NAME, k_scale_pages)
    _lib.check_tiles(counter, q.shape[-1], k_pages, v_pages,
                     multiple=16 if k_scale_pages is not None else 8)
    o, l, m = _lib.page_partials(
        "paged_decode", NAME, counter, q[:, None], k_pages, v_pages,
        pos_pages, block_tables, pos_q[:, None], window, scale, soft_cap,
        k_scale_pages, v_scale_pages, pages_per_split=pps)
    return o[:, :, 0], l[:, :, 0], m[:, :, 0]


def _decode_fake(q, k_pages, v_pages, pos_pages, block_tables, *_):
    o, l, m = page_partials_fake(q[:, None], k_pages, block_tables, _[-1])
    return o[:, :, 0], l[:, :, 0], m[:, :, 0]


_PAGE_SCHEMA = ("(Tensor q, Tensor k_pages, Tensor v_pages, "
                "Tensor pos_pages, Tensor block_tables, Tensor pos_q, "
                "Tensor? k_scale_pages, Tensor? v_scale_pages, int? window, "
                "float? scale, float? soft_cap, int pages_per_split) -> "
                "(Tensor, Tensor, Tensor)")


def _plain(fn):
    def run(q, kp, vp, pp, bt, pq, ks, vs, w, sc, cap, pps):
        return tuple(fn(q, kp, vp, pp, bt, pq, window=w, scale=sc,
                        soft_cap=cap, k_scale_pages=ks, v_scale_pages=vs,
                        pages_per_split=pps))
    return run


_DECODE = define(
    NAME, _PAGE_SCHEMA, _decode_cuda, _plain(paged_decode_partials_plain),
    _decode_fake,
    lambda q, kp, vp, pp, bt, *_, **__: page_flops(
        (q[0], 1) + tuple(q[1:]), kp, bt),
    lambda *a: page_rules(*a, head_dim=1, out_head_dim=2, n_scales=2))


def paged_verify_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, pos_pages: torch.Tensor,
                          block_tables: torch.Tensor, pos_q: torch.Tensor, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          soft_cap: Optional[float] = None,
                          k_scale_pages: Optional[torch.Tensor] = None,
                          v_scale_pages: Optional[torch.Tensor] = None,
                          pages_per_split: int = 1) -> Partials:
    """Speculative verification, S queries per row in one page-fused pass.
    q: (B, S, H, D), the pending token plus S-1 proposals, already written
    into their pages; pos_q: (B, S) int32 absolute positions; the rest as
    ``paged_decode_partials``.  Returns one partial per split of
    ``pages_per_split`` page slots (the last split ragged): o
    (B, ceil(nb / pps), S, H, D), l/m (B, ceil(nb / pps), S, H), f32.
    ``pages_per_split=1`` is the TPU kernel's one partial per page."""
    pps = int(pages_per_split)
    if pps < 1:
        raise ValueError(f"{VERIFY}: pages_per_split must be >= 1, "
                         f"got {pages_per_split}")
    return _VERIFY(q, k_pages, v_pages, pos_pages, block_tables, pos_q,
                   k_scale_pages, v_scale_pages, window, scale, soft_cap,
                   pps)


def _verify_cuda(q, k_pages, v_pages, pos_pages, block_tables, pos_q,
                 k_scale_pages, v_scale_pages, window, scale, soft_cap, pps):
    if q.dim() != 4 or pos_q.dim() != 2:
        raise ValueError(f"{VERIFY}: q must be (B, S, H, D) and pos_q "
                         f"(B, S), got {tuple(q.shape)} and "
                         f"{tuple(pos_q.shape)}")
    counter = _counter(VERIFY, k_scale_pages)
    _lib.check_tiles(counter, q.shape[-1], q, k_pages, v_pages,
                     multiple=16 if k_scale_pages is not None else 8)
    return _lib.page_partials("paged_verify", VERIFY, counter, q, k_pages,
                              v_pages, pos_pages, block_tables, pos_q,
                              window, scale, soft_cap, k_scale_pages,
                              v_scale_pages, pages_per_split=pps)


_VERIFY = define(
    VERIFY, _PAGE_SCHEMA, _verify_cuda, _plain(paged_verify_partials_plain),
    lambda q, kp, vp, pp, bt, *_: page_partials_fake(q, kp, bt, _[-1]),
    lambda q, kp, vp, pp, bt, *_, **__: page_flops(q, kp, bt),
    lambda *a: page_rules(*a, head_dim=2, out_head_dim=3, n_scales=2))


def _kv_stride(k: torch.Tensor, v: torch.Tensor) -> Optional[int]:
    """Heads between consecutive keys when K and V are both a contiguous
    range of the kv heads of one (B, L, KV', D) layout (KV' for the whole
    cache), else None."""
    b, length, kv, d = k.shape
    if v.shape != k.shape or v.stride() != k.stride() or d == 0:
        return None
    st = k.stride()
    row = st[1] // d if st[1] % d == 0 else 0
    if st[3] != 1 or st[2] != d or row < kv:
        return None
    if b > 1 and st[0] != length * st[1]:
        return None
    return row


def split_kv_decode_partials(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             block_k: int = 512,
                             scale: Optional[float] = None) -> Partials:
    """Dense-cache split-KV decode.  q: (B, H, D); k, v: (B, L, KV, D),
    contiguous or a contiguous range of a wider (B, L, KV', D) cache's kv
    heads (``cache[:, :, a:b]``: read in place, keys KV' heads apart);
    valid: (B, L) bool (or uint8).  One partial per bk = min(block_k, L)
    keys, the last block ragged when bk does not divide L (its keys past
    L invalid).  Returns o (B, J, H, D), l/m (B, J, H), f32,
    J = ceil(L / bk)."""
    return _SPLIT(q, k, v, valid, int(block_k), scale)


def _split_cuda(q, k, v, valid, block_k, scale):
    b, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    kvs = _kv_stride(k, v)
    if kvs is None:
        raise ValueError(f"{SPLIT}: k and v must be one contiguous range of "
                         f"the kv heads of a (B, L, KV, D) cache, got "
                         f"strides {k.stride()} / {v.stride()}")
    q, valid = q.contiguous(), valid.contiguous()
    dev = _lib.check_cuda(SPLIT, q, valid)
    if k.device != dev or v.device != dev:
        raise ValueError(f"{SPLIT}: all inputs must be on one CUDA device, "
                         f"got {k.device} / {v.device} and {dev}")
    code = _lib.dtype_code(SPLIT, q, k, v)
    if valid.dtype == torch.bool:
        valid = valid.view(torch.uint8)
    bk = min(int(block_k), length)
    _lib.check_tiles(SPLIT, d, k, v)
    if (k.shape[0] != b or k.shape[3] != d or h % kv or v.shape != k.shape
            or valid.shape != (b, length) or valid.dtype != torch.uint8
            or bk < 1 or bk > MAX_BLOCK_K):
        raise ValueError(f"{SPLIT}: inconsistent inputs q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, valid {tuple(valid.shape)} "
                         f"{valid.dtype}, block_k {bk}")
    nj = -(-length // bk)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    o = torch.empty((b, nj, h, d), dtype=torch.float32, device=dev)
    l = torch.empty((b, nj, h), dtype=torch.float32, device=dev)
    m = torch.empty((b, nj, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lib.launch("split_kv_decode", SPLIT, SPLIT,
                    *map(_lib.ptr, (q, k, v, valid, o, l, m)),
                    b, h, kv, kvs, d, length, bk, scale, code)
    return o, l, m


def _split_fake(q, k, v, valid, block_k, scale):
    b, h, d = q.shape
    nj = -(-k.shape[1] // min(block_k, k.shape[1]))
    return (q.new_empty((b, nj, h, d), dtype=torch.float32),
            q.new_empty((b, nj, h), dtype=torch.float32),
            q.new_empty((b, nj, h), dtype=torch.float32))


def _split_flops(q, k, v, valid, block_k, scale, **_):
    """4 * D per (query head, key) pair: every key of the cache."""
    b, h, d = q
    return 4 * b * h * d * k[1]


def _split_rules(q, k, v, valid, block_k, scale):
    """Rows along the batch; heads along the heads (the validity mask
    whole); and keys along the sequence when every shard holds whole key
    blocks (its partials then split along the block axis), which is how
    a sequence-sharded cache decodes without gathering it."""
    rules = [((0, 0, 0), (0, 0, 0, 0, None, None)),
             ((2, 2, 2), (1, 2, 2, None, None, None))]
    length = k.shape[1]
    if length % (block_k * shards_on(k, 1)) == 0 and length > block_k:
        rules.append(((1, 1, 1), (None, 1, 1, 1, None, None)))
    return placement_rules((q, k, v, valid, block_k, scale), rules)


_SPLIT = define(
    SPLIT,
    "(Tensor q, Tensor k, Tensor v, Tensor valid, int block_k, "
    "float? scale) -> (Tensor, Tensor, Tensor)",
    _split_cuda,
    lambda q, k, v, valid, bk, sc: tuple(split_kv_decode_partials_plain(
        q, k, v, valid, block_k=bk, scale=sc)),
    _split_fake, _split_flops, _split_rules)
