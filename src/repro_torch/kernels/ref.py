"""Plain PyTorch versions of the attention kernels.

Two kinds of function live here:

* **Oracles** — gather-then-attend, one monolithic softmax per query, the
  plainest formulation (``flash_prefill_reference``,
  ``paged_decode_attention_reference``,
  ``paged_prefill_attention_reference``).  Tests hold the kernels' combined
  outputs against them.
* **Plain forms of the kernel functions** — the same inputs and the same
  outputs as each CUDA kernel, including its per-page (o, l, m) partial
  contract and its masking conventions (``NEG_INF = -1e30`` rather than
  ``-inf``; ``p`` zeroed by the mask *after* ``exp``, so a fully masked page
  gives ``l = 0``; dead table entries masked by ``table >= 0`` whatever the
  scratch page holds).  A kernel wrapper runs these on CPU tensors, and
  ``chip_smoke.py`` compares each kernel with its plain form on the card.

All arithmetic is float32 whatever the input type, as in the kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _soft_cap(s: torch.Tensor, soft_cap: Optional[float]) -> torch.Tensor:
    return s if soft_cap is None else torch.tanh(s / soft_cap) * soft_cap


# ---------------------------------------------------------------------------
# Plain forms of the kernel functions
# ---------------------------------------------------------------------------

def paged_prefix_partials_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                pos_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                positions: torch.Tensor, *,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                soft_cap: Optional[float] = None
                                ) -> Partials:
    """Per-page partials of S queries per row against block-table-steered
    pages.  q: (B, S, H, D); k/v_pages: (P, bs, KV, D); pos_pages: (P, bs);
    block_tables: (B, nb) (-1 = dead); positions: (B, S) absolute query
    positions.  Returns o (B, nb, S, H, D), l/m (B, nb, S, H), f32."""
    b, s, h, d = q.shape
    kv = k_pages.shape[2]
    nb = block_tables.shape[1]
    g = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    safe = block_tables.clamp_min(0).long()
    k = k_pages[safe].float()                        # (B, nb, bs, KV, D)
    v = v_pages[safe].float()
    pk = pos_pages[safe][:, :, None, :]              # (B, nb, 1, bs)
    pq = positions[:, None, :, None]                 # (B, 1, S, 1)
    mask = (block_tables >= 0)[:, :, None, None] & (pk >= 0) & (pk <= pq)
    if window is not None:
        mask = mask & (pk > pq - window)             # (B, nb, S, bs)
    mask = mask[:, :, None, None]                    # (B, nb, 1, 1, S, bs)
    qg = q.float().reshape(b, s, kv, g, d)
    sc = torch.einsum("bskgd,bjtkd->bjkgst", qg, k) * scale
    sc = torch.where(mask, _soft_cap(sc, soft_cap), NEG_INF)
    m = sc.amax(dim=-1)                              # (B, nb, KV, G, S)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bjkgst,bjtkd->bjskgd", p, v)   # (B, nb, S, KV, G, D)
    return (o.reshape(b, nb, s, h, d),
            l.permute(0, 1, 4, 2, 3).reshape(b, nb, s, h),
            m.permute(0, 1, 4, 2, 3).reshape(b, nb, s, h))


def paged_decode_partials_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                pos_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                pos_q: torch.Tensor, *,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                soft_cap: Optional[float] = None
                                ) -> Partials:
    """Single-query decode form: q (B, H, D), pos_q (B,).  The mask
    ``table >= 0 & pos >= 0 & pos <= pq (& window)`` is the prefix form's
    with S = 1.  Returns o (B, nb, H, D), l/m (B, nb, H), f32."""
    o, l, m = paged_prefix_partials_plain(
        q[:, None], k_pages, v_pages, pos_pages, block_tables,
        pos_q[:, None], window=window, scale=scale, soft_cap=soft_cap)
    return o[:, :, 0], l[:, :, 0], m[:, :, 0]


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        soft_cap: Optional[float] = None,
                        seq_offset: int = 0,
                        return_partials: bool = False):
    """Causal GQA attention of queries at positions seq_offset..+S-1 over
    keys at 0..L-1.  q: (B, S, H, D); k, v: (B, L, KV, D).  Returns the
    normalized (B, S, H, D) in q's dtype, or the unnormalized partials
    o (B, S, H, D), l/m (B, S, H) f32 — the online softmax's final state,
    which is this one-shot softmax's (m is the row max, NEG_INF when the
    row attends to nothing)."""
    b, s, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, s, kv, g, d)
    sc = torch.einsum("bskgd,blkd->bkgsl", qg, k.float()) * scale
    pos_q = seq_offset + torch.arange(s, device=q.device)[:, None]
    pos_k = torch.arange(length, device=q.device)[None, :]
    mask = pos_k <= pos_q
    if window is not None:
        mask = mask & (pos_k > pos_q - window)
    sc = torch.where(mask, _soft_cap(sc, soft_cap), NEG_INF)
    m = sc.amax(dim=-1)                              # (B, KV, G, S)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgsl,blkd->bskgd", p, v.float()).reshape(b, s, h, d)
    l = l.permute(0, 3, 1, 2).reshape(b, s, h)
    m = m.permute(0, 3, 1, 2).reshape(b, s, h)
    if return_partials:
        return o, l, m
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

def _softmax_attend(sc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    sc = torch.where(mask, sc, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.nan_to_num(p, nan=0.0)


def flash_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            window: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention; keys at 0..L-1, queries
    at L-S..L-1.  Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, s, kv, h // kv, d)
    sc = torch.einsum("bskgd,blkd->bkgsl", qg, k.float()) * scale
    pos_q = torch.arange(length - s, length, device=q.device)[:, None]
    pos_k = torch.arange(length, device=q.device)[None, :]
    mask = pos_k <= pos_q
    if window is not None:
        mask = mask & (pos_k > pos_q - window)
    p = _softmax_attend(sc, mask)
    o = torch.einsum("bkgsl,blkd->bskgd", p, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def _gather_lin(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    b, nb = tables.shape
    lin = pages[tables.clamp_min(0).long()]
    return lin.reshape((b, nb * pages.shape[1]) + pages.shape[2:])


def _lin_positions(pos_pages: torch.Tensor,
                   tables: torch.Tensor) -> torch.Tensor:
    pos = pos_pages[tables.clamp_min(0).long()]
    pos = torch.where((tables >= 0)[:, :, None], pos, -1)
    return pos.reshape(tables.shape[0], -1)


def paged_decode_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     pos_pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     pos_q: torch.Tensor, *,
                                     window: Optional[int] = None,
                                     scale: Optional[float] = None,
                                     soft_cap: Optional[float] = None
                                     ) -> torch.Tensor:
    """Gather-then-attend ground truth for page-fused decode.  q (B, H, D)
    → (B, H, D) in q's dtype."""
    b, h, d = q.shape
    kv = k_pages.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k_lin = _gather_lin(k_pages, block_tables).float()
    v_lin = _gather_lin(v_pages, block_tables).float()
    pos_lin = _lin_positions(pos_pages, block_tables)
    pq = pos_q[:, None]
    valid = (pos_lin >= 0) & (pos_lin <= pq)
    if window is not None:
        valid = valid & (pos_lin > pq - window)
    qg = q.float().reshape(b, kv, h // kv, d)
    sc = _soft_cap(torch.einsum("bkgd,blkd->bkgl", qg, k_lin) * scale,
                   soft_cap)
    p = _softmax_attend(sc, valid[:, None, None, :])
    o = torch.einsum("bkgl,blkd->bkgd", p, v_lin)
    return o.reshape(b, h, d).to(q.dtype)


def paged_prefill_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor,
                                      pos_pages: torch.Tensor,
                                      block_tables: torch.Tensor,
                                      positions: torch.Tensor, *,
                                      window: Optional[int] = None,
                                      scale: Optional[float] = None,
                                      soft_cap: Optional[float] = None
                                      ) -> torch.Tensor:
    """Ground truth for paged chunked prefill: the gathered prefix
    concatenated with the suffix, one softmax per query."""
    b, s, h, d = q.shape
    kv = k_pages.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    keys = torch.cat([_gather_lin(k_pages, block_tables), k], dim=1)
    vals = torch.cat([_gather_lin(v_pages, block_tables), v], dim=1)
    key_pos = torch.cat([_lin_positions(pos_pages, block_tables), positions],
                        dim=1)
    qg = q.float().reshape(b, s, kv, h // kv, d)
    sc = _soft_cap(torch.einsum("bskgd,blkd->bkgsl", qg, keys.float())
                   * scale, soft_cap)
    pq = positions[:, :, None]
    pk = key_pos[:, None, :]
    mask = (pk >= 0) & (pk <= pq)
    if window is not None:
        mask = mask & (pk > pq - window)
    p = _softmax_attend(sc, mask[:, None, None])
    o = torch.einsum("bkgsl,blkd->bskgd", p, vals.float())
    return o.reshape(b, s, h, d).to(q.dtype)
