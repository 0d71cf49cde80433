"""Plain PyTorch versions of the attention kernels.

Two kinds of function live here:

* **Oracles** — gather-then-attend, one monolithic softmax per query, the
  plainest formulation (``flash_prefill_reference``,
  ``decode_attention_reference``, ``paged_decode_attention_reference``,
  ``paged_verify_attention_reference``,
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
int8 pools (``k_scale_pages``/``v_scale_pages`` given, one f32 scale per
(token entry, kv head)) fold their scales where the JAX kernels do: the K
scale multiplies the scores after ``* scale`` and before the soft cap; ``l``
is summed from ``p`` before the V scale multiplies ``p`` ahead of the PV
product, and only where the key is visible (as in the kernels), so the
stale or non-finite scale of a masked entry never reaches ``o``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
                                soft_cap: Optional[float] = None,
                                k_scale_pages: Optional[torch.Tensor] = None,
                                v_scale_pages: Optional[torch.Tensor] = None,
                                pages_per_split: int = 1) -> Partials:
    """Per-page partials of S queries per row against block-table-steered
    pages.  q: (B, S, H, D); k/v_pages: (P, bs, KV, D), or int8 with
    k/v_scale_pages (P, bs, KV) f32; pos_pages: (P, bs); block_tables:
    (B, nb) (-1 = dead); positions: (B, S) absolute query positions.
    Returns o (B, nb, S, H, D), l/m (B, nb, S, H), f32; with
    ``pages_per_split`` > 1, each group of that many page slots (the last
    one ragged) merged into one partial by ``merge_partials_plain``:
    o (B, ceil(nb / pps), S, H, D), l/m (B, ceil(nb / pps), S, H)."""
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
    if k_scale_pages is not None:                    # (B, nb, KV, 1, 1, bs)
        sc = sc * _page_scales(k_scale_pages, safe)
    sc = torch.where(mask, _soft_cap(sc, soft_cap), NEG_INF)
    m = sc.amax(dim=-1)                              # (B, nb, KV, G, S)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_scale_pages is not None:
        p = torch.where(mask, p * _page_scales(v_scale_pages, safe), 0.0)
    o = torch.einsum("bjkgst,bjtkd->bjskgd", p, v)   # (B, nb, S, KV, G, D)
    parts = (o.reshape(b, nb, s, h, d),
             l.permute(0, 1, 4, 2, 3).reshape(b, nb, s, h),
             m.permute(0, 1, 4, 2, 3).reshape(b, nb, s, h))
    if pages_per_split == 1:
        return parts
    return merge_partials_plain(parts, pages_per_split)


def merge_partials_plain(parts: Partials, group: int) -> Partials:
    """Merge consecutive groups of ``group`` partials along axis 1 (the last
    group ragged) into one partial each, with ``combine_stacked``'s
    arithmetic but without the division: m is the group's max,
    o and l are the sums of each member's o and l weighted by
    exp(m_member - m); non-finite maxima weigh 0.  A group of all-masked
    partials stays all-masked (o = 0, l = 0, m = NEG_INF).  o (B, N, ...,
    D), l/m (B, N, ...) -> o (B, ceil(N / group), ..., D), l/m
    (B, ceil(N / group), ...)."""
    o, l, m = parts
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    n = l.shape[1]
    pad = -n % group
    if pad:
        o = torch.cat([o, o.new_zeros((o.shape[0], pad) + o.shape[2:])], 1)
        l = torch.cat([l, l.new_zeros((l.shape[0], pad) + l.shape[2:])], 1)
        m = torch.cat([m, m.new_full((m.shape[0], pad) + m.shape[2:],
                                     NEG_INF)], 1)
    ng = (n + pad) // group
    o = o.reshape((o.shape[0], ng, group) + o.shape[2:])
    l = l.reshape((l.shape[0], ng, group) + l.shape[2:])
    m = m.reshape((m.shape[0], ng, group) + m.shape[2:])
    big_m = m.amax(dim=2)
    big_m_safe = torch.where(torch.isfinite(big_m), big_m, 0.0)
    fin = torch.isfinite(m)
    w = torch.where(fin, torch.exp(torch.where(fin, m, float("-inf"))
                                   - big_m_safe.unsqueeze(2)), 0.0)
    return ((o * w[..., None]).sum(dim=2), (l * w).sum(dim=2), big_m)


def _page_scales(scale_pages: torch.Tensor,
                 safe: torch.Tensor) -> torch.Tensor:
    """(P, bs, KV) scale pools gathered through the table, shaped to
    broadcast against (B, nb, KV, G, S, bs) scores."""
    return scale_pages[safe].float().permute(0, 1, 3, 2)[:, :, :, None,
                                                         None, :]


def paged_decode_partials_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                pos_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                pos_q: torch.Tensor, *,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                soft_cap: Optional[float] = None,
                                k_scale_pages: Optional[torch.Tensor] = None,
                                v_scale_pages: Optional[torch.Tensor] = None,
                                pages_per_split: int = 1) -> Partials:
    """Single-query decode form: q (B, H, D), pos_q (B,).  The mask
    ``table >= 0 & pos >= 0 & pos <= pq (& window)`` is the prefix form's
    with S = 1.  Returns o (B, nb, H, D), l/m (B, nb, H), f32; with
    ``pages_per_split`` > 1 each group of that many page slots merged by
    ``merge_partials_plain``: o (B, ceil(nb / pps), H, D), l/m
    (B, ceil(nb / pps), H)."""
    o, l, m = paged_prefix_partials_plain(
        q[:, None], k_pages, v_pages, pos_pages, block_tables,
        pos_q[:, None], window=window, scale=scale, soft_cap=soft_cap,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
        pages_per_split=pages_per_split)
    return o[:, :, 0], l[:, :, 0], m[:, :, 0]


def paged_verify_partials_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                pos_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                pos_q: torch.Tensor, *,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                soft_cap: Optional[float] = None,
                                k_scale_pages: Optional[torch.Tensor] = None,
                                v_scale_pages: Optional[torch.Tensor] = None,
                                pages_per_split: int = 1) -> Partials:
    """Speculative-verify form: S queries per row (the pending token and
    its proposals, already written into their pages), each with its own
    position pos_q[:, s].  The per-query mask ``table >= 0 & pos >= 0 &
    pos <= pos_q[s] (& window)`` also hides the in-flight tokens at
    positions past pos_q[s].  q (B, S, H, D), pos_q (B, S).  Returns o
    (B, nb, S, H, D), l/m (B, nb, S, H), f32 — the prefix form's
    arithmetic; with ``pages_per_split`` > 1 each group of that many page
    slots merged by ``merge_partials_plain``: o
    (B, ceil(nb / pps), S, H, D), l/m (B, ceil(nb / pps), S, H)."""
    return paged_prefix_partials_plain(
        q, k_pages, v_pages, pos_pages, block_tables, pos_q, window=window,
        scale=scale, soft_cap=soft_cap, k_scale_pages=k_scale_pages,
        v_scale_pages=v_scale_pages, pages_per_split=pages_per_split)


def split_kv_decode_partials_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, valid: torch.Tensor, *,
                                   block_k: int = 512,
                                   scale: Optional[float] = None
                                   ) -> Partials:
    """Per-key-block partials of one decode query per row over a dense
    cache.  q: (B, H, D); k, v: (B, L, KV, D); valid: (B, L) bool; one
    partial per bk = min(block_k, L) keys, the last block ragged (its keys
    past L invalid), as the CUDA kernel.  No soft cap, no window: the JAX
    kernel has neither.  Returns o (B, J, H, D), l/m (B, J, H), f32,
    J = ceil(L / bk)."""
    b, h, d = q.shape
    length, kv = k.shape[1], k.shape[2]
    bk = min(block_k, length)
    nj = -(-length // bk)
    pad = nj * bk - length
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kv, h // kv, d)
    kb = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nj, bk, kv, d)
    vb = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nj, bk, kv, d)
    mask = F.pad(valid.bool(), (0, pad)).reshape(b, nj, 1, 1, bk)
    sc = torch.einsum("bkgd,bjtkd->bjkgt", qg, kb) * scale
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1)                              # (B, J, KV, G)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bjkgt,bjtkd->bjkgd", p, vb)
    return o.reshape(b, nj, h, d), l.reshape(b, nj, h), m.reshape(b, nj, h)


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


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, valid: torch.Tensor, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Exact decode attention over a dense cache, one softmax per row.
    q: (B, H, D); k, v: (B, L, KV, D); valid: (B, L) bool.  Returns
    (B, H, D) in q's dtype."""
    b, h, d = q.shape
    kv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kv, h // kv, d)
    sc = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) * scale
    p = _softmax_attend(sc, valid.bool()[:, None, None, :])
    o = torch.einsum("bkgl,blkd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)


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
                                     soft_cap: Optional[float] = None,
                                     k_scale_pages: Optional[torch.Tensor]
                                     = None,
                                     v_scale_pages: Optional[torch.Tensor]
                                     = None) -> torch.Tensor:
    """Gather-then-attend ground truth for page-fused decode: int8 pools
    are dequantized after the gather.  q (B, H, D) → (B, H, D) in q's
    dtype."""
    b, h, d = q.shape
    kv = k_pages.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k_lin = _gather_lin(k_pages, block_tables).float()
    v_lin = _gather_lin(v_pages, block_tables).float()
    if k_scale_pages is not None:
        k_lin = k_lin * _gather_lin(k_scale_pages, block_tables)[..., None]
        v_lin = v_lin * _gather_lin(v_scale_pages, block_tables)[..., None]
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


def paged_verify_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     pos_pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     pos_q: torch.Tensor, *,
                                     window: Optional[int] = None,
                                     scale: Optional[float] = None,
                                     soft_cap: Optional[float] = None,
                                     k_scale_pages: Optional[torch.Tensor]
                                     = None,
                                     v_scale_pages: Optional[torch.Tensor]
                                     = None) -> torch.Tensor:
    """Ground truth for speculative verification: each of the S queries
    is one independent single-token decode at its own position.
    q (B, S, H, D), pos_q (B, S) → (B, S, H, D) in q's dtype."""
    return torch.stack([paged_decode_attention_reference(
        q[:, s], k_pages, v_pages, pos_pages, block_tables, pos_q[:, s],
        window=window, scale=scale, soft_cap=soft_cap,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
        for s in range(q.shape[1])], dim=1)


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
