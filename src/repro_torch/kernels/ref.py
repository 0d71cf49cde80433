"""Plain PyTorch versions of the attention kernels and the xLSTM scans.

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

The xLSTM scans (``mlstm_scan_ref``, ``slstm_scan_ref`` and their
backward ``*_backward_ref``) step the recurrence one time step at a time,
as JAX's ``lax.scan`` does, with the outputs the kernels save for the
backward.

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


# ---------------------------------------------------------------------------
# xLSTM scans
# ---------------------------------------------------------------------------
#
# The gradient of ``max(x, y)`` goes to the larger side, half to each at a
# tie (``torch.maximum``'s and JAX's ``max``'s rule); that of ``|s|`` is
# sign(s), 0 at s = 0.  ``tie_weight(x, y)`` is x's share.

def tie_weight(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def _mlstm_gates(log_f, log_i, m):
    """One step's stabilizer: a = log f + m, m' = max(a, log i), f' =
    exp(a - m'), i' = exp(log i - m')."""
    a = log_f + m
    m_new = torch.maximum(a, log_i)
    return a, m_new, torch.exp(a - m_new), torch.exp(log_i - m_new)


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_i: torch.Tensor, log_f: torch.Tensor,
                   c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                   chunk: int = 0) -> Tuple[torch.Tensor, ...]:
    """The mLSTM recurrence, JAX's scan ``step`` (``mlstm_apply``) for t =
    0..S-1 in f32: m_t = max(log f + m, log i), f' = exp(log f + m - m_t),
    i' = exp(log i - m_t), C = f' C + i' v k^T, n = f' n + i' k, s = n . q,
    y_t = C q / max(|s|, exp(-m_t)).  q, k, v: (B, S, H, D); log_i, log_f:
    (B, S, H); carries C0 (B, H, D, D), n0 (B, H, D), m0 (B, H).

    Returns (y, C, n, m, ckC, ckn, ms, ss).  With ``chunk`` > 0 also what
    the kernel saves for the backward: the carries before every
    ``chunk``-th step, ckC (B, ceil(S / chunk), H, D, D) and ckn (B, .., H,
    D), and every step's m_t and s_t, ms / ss (B, S, H); with 0 these are
    empty (their step axis 0)."""
    b, s, h, d = q.shape
    c_mem, n_mem, m = c0, n0, m0
    ys, cks, ms, ss = [], [], [], []
    for t in range(s):
        if chunk and t % chunk == 0:
            cks.append((c_mem, n_mem))
        _, m_new, f_eff, i_eff = _mlstm_gates(log_f[:, t], log_i[:, t], m)
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        c_mem = (f_eff[..., None, None] * c_mem
                 + i_eff[..., None, None] * (vt[..., :, None]
                                             * kt[..., None, :]))
        n_mem = f_eff[..., None] * n_mem + i_eff[..., None] * kt
        dot = (n_mem * qt).sum(-1)
        den = torch.maximum(dot.abs(), torch.exp(-m_new))
        ys.append((c_mem @ qt[..., None])[..., 0] / den[..., None])
        ms.append(m_new)
        ss.append(dot)
        m = m_new
    y = torch.stack(ys, dim=1)
    nc = -(-s // chunk) if chunk else 0
    if chunk:
        ck_c = torch.stack([c for c, _ in cks], dim=1)
        ck_n = torch.stack([n for _, n in cks], dim=1)
        ms, ss = torch.stack(ms, dim=1), torch.stack(ss, dim=1)
    else:
        ck_c = c0.new_empty((b, nc, h, d, d))
        ck_n = n0.new_empty((b, nc, h, d))
        ms, ss = m0.new_empty((b, 0, h)), m0.new_empty((b, 0, h))
    return y, c_mem, n_mem, m, ck_c, ck_n, ms, ss


def mlstm_scan_backward_ref(dy: torch.Tensor, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            log_i: torch.Tensor, log_f: torch.Tensor,
                            c0: torch.Tensor, n0: torch.Tensor,
                            m0: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients (dq, dk, dv, dlog_i, dlog_f) of ``sum(dy * y)`` for y
    = ``mlstm_scan_ref``'s output, the carries held fixed: the forward
    recomputed from (C0, n0, m0), then one reverse pass carrying dC, dn
    and dm, the same formulas as the backward kernel's.  Per step, with
    den = max(|s|, g), g = exp(-m_t): dden = -(dy . y) / den splits into
    ds (to s) and dg (to m_t, times -g); dC_t = dC + (dy / den) q^T; dq =
    C_t^T dy / den + ds n_t; the scales' gradients dF = <dC_t, C_{t-1}> +
    dn_t . n_{t-1} and dI = v^T dC_t k + dn_t . k go through exp and max
    back to log_i, log_f and m_{t-1}."""
    b, s, h, d = q.shape
    cs, ns, gates = [c0], [n0], []
    c_mem, n_mem, m = c0, n0, m0
    for t in range(s):
        a, m_new, f_eff, i_eff = _mlstm_gates(log_f[:, t], log_i[:, t], m)
        kt, vt = k[:, t], v[:, t]
        c_mem = (f_eff[..., None, None] * c_mem
                 + i_eff[..., None, None] * (vt[..., :, None]
                                             * kt[..., None, :]))
        n_mem = f_eff[..., None] * n_mem + i_eff[..., None] * kt
        cs.append(c_mem)
        ns.append(n_mem)
        gates.append((a, m_new, f_eff, i_eff))
        m = m_new
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dli, dlf = torch.empty_like(log_i), torch.empty_like(log_f)
    dc = torch.zeros_like(c0)
    dn = torch.zeros_like(n0)
    dm = torch.zeros_like(m0)
    for t in range(s - 1, -1, -1):
        a, m_t, f_eff, i_eff = gates[t]
        qt, kt, vt, dyt = q[:, t], k[:, t], v[:, t], dy[:, t]
        c_t, c_p, n_t, n_p = cs[t + 1], cs[t], ns[t + 1], ns[t]
        dot = (n_t * qt).sum(-1)
        g = torch.exp(-m_t)
        den = torch.maximum(dot.abs(), g)
        y_t = (c_t @ qt[..., None])[..., 0] / den[..., None]
        dden = -(dyt * y_t).sum(-1) / den
        w_s = tie_weight(dot.abs(), g)
        ds = dden * w_s * torch.sign(dot)
        dg = dden * (1.0 - w_s) * -g
        dnum = dyt / den[..., None]
        dct = dc + dnum[..., :, None] * qt[..., None, :]
        dnt = dn + ds[..., None] * qt
        dq[:, t] = (c_t.transpose(-1, -2) @ dnum[..., None])[..., 0] \
            + ds[..., None] * n_t
        rows = (dct @ kt[..., None])[..., 0]            # dC_t k
        cols = (dct * vt[..., :, None]).sum(-2)         # dC_t^T v
        dv[:, t] = i_eff[..., None] * rows
        dk[:, t] = i_eff[..., None] * (cols + dnt)
        d_f = (dct * c_p).sum((-1, -2)) + (dnt * n_p).sum(-1)
        d_i = (kt * (cols + dnt)).sum(-1)
        d_a, d_b = d_f * f_eff, d_i * i_eff
        dmt = dm + dg - d_a - d_b
        w_a = tie_weight(a, log_i[:, t])
        da = d_a + w_a * dmt
        dli[:, t] = d_b + (1.0 - w_a) * dmt
        dlf[:, t] = da
        dm = da
        dc = f_eff[..., None, None] * dct
        dn = f_eff[..., None] * dnt
    return dq, dk, dv, dli, dlf


def _slstm_step(pre, c, n, m):
    """One sLSTM step from its pre-activations (z, i, f, o): returns (c, n,
    m, h) and the intermediates (z, o, log i, a, f', i', max(n, 1))."""
    d = c.shape[-1]
    pz, li, pf, po = pre.split(d, dim=-1)
    z, o = torch.tanh(pz), torch.sigmoid(po)
    a = F.logsigmoid(pf) + m
    m_new = torch.maximum(a, li)
    f_eff, i_eff = torch.exp(a - m_new), torch.exp(li - m_new)
    c = f_eff * c + i_eff * z
    n = f_eff * n + i_eff
    nn = torch.maximum(n, torch.ones_like(n))
    h = o * c / nn
    return (c, n, m_new, h), (z, o, li, a, f_eff, i_eff, nn)


def slstm_scan_ref(pre_x: torch.Tensor, r_w: torch.Tensor,
                   c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                   h0: torch.Tensor, save: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """The sLSTM recurrence, JAX's scan ``step`` (``slstm_apply``) for t =
    0..S-1 in f32: pre = pre_x_t + h r_w split into (z, i, f, o); z =
    tanh, o = sigmoid, log f = log_sigmoid; m_t = max(log f + m, i), f' =
    exp(log f + m - m_t), i' = exp(i - m_t), c = f' c + i' z, n = f' n +
    i', h = o c / max(n, 1).  pre_x: (B, S, 4d); r_w: (d, 4d); carries
    (B, d).

    Returns (y, c, n, m, h, pres, cs, ns, ms): y (B, S, d) the h sequence,
    the last carries, and with ``save`` what the kernel saves for the
    backward: every step's pre-activations pres (B, S, 4d) and c, n, m (B,
    S, d); without, those four are empty (their step axis 0)."""
    b, s, _ = pre_x.shape
    c, n, m, h = c0, n0, m0, h0
    ys, pres, cs, ns, ms = [], [], [], [], []
    for t in range(s):
        pre = pre_x[:, t] + h @ r_w
        (c, n, m, h), _ = _slstm_step(pre, c, n, m)
        ys.append(h)
        pres.append(pre)
        cs.append(c)
        ns.append(n)
        ms.append(m)
    y = torch.stack(ys, dim=1)
    if save:
        saved = [torch.stack(x, dim=1) for x in (pres, cs, ns, ms)]
    else:
        saved = [pre_x.new_empty((b, 0, pre_x.shape[2]))] + [
            c0.new_empty((b, 0, c0.shape[1])) for _ in range(3)]
    return (y, c, n, m, h, *saved)


def slstm_scan_backward_ref(dy: torch.Tensor, pre_x: torch.Tensor,
                            r_w: torch.Tensor, c0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor,
                            h0: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients (dpre_x, dr_w) of ``sum(dy * y)`` for y =
    ``slstm_scan_ref``'s output, the carries held fixed: the forward
    recomputed, then one reverse pass carrying dc, dn, dm and the
    recurrent dh = dpre_{t+1} r_w^T, the same formulas as the backward
    kernel's; dr_w = sum_t h_{t-1}^T dpre_t, one product at the end."""
    b, s, _ = pre_x.shape
    c, n, m, h = c0, n0, m0, h0
    steps, hs = [], [h0]
    for t in range(s):
        pre = pre_x[:, t] + h @ r_w
        carry_in = (c, n)
        (c, n, m, h), inter = _slstm_step(pre, c, n, m)
        steps.append((pre, carry_in, (c, n), inter))
        hs.append(h)
    dpre = torch.empty_like(pre_x)
    dc, dn, dm = (torch.zeros_like(c0) for _ in range(3))
    for t in range(s - 1, -1, -1):
        pre, (c_p, n_p), (c_t, n_t), (z, o, li, a, f_eff, i_eff, nn) = \
            steps[t]
        dh = dy[:, t] if t == s - 1 else dy[:, t] + dpre[:, t + 1] @ r_w.T
        d_o = dh * c_t / nn
        dct = dc + dh * o / nn
        dnt = dn - dh * (o * c_t) / (nn * nn) * tie_weight(
            n_t, torch.ones_like(n_t))
        d_f = dct * c_p + dnt * n_p
        d_i = dct * z + dnt
        d_a, d_b = d_f * f_eff, d_i * i_eff
        dmt = dm - d_a - d_b
        w_a = tie_weight(a, li)
        da = d_a + w_a * dmt
        pf = pre.split(c0.shape[1], dim=-1)[2]
        dpre[:, t] = torch.cat([dct * i_eff * (1.0 - z * z),
                                d_b + (1.0 - w_a) * dmt,
                                da * torch.sigmoid(-pf),
                                d_o * o * (1.0 - o)], dim=-1)
        dc, dn, dm = dct * f_eff, dnt * f_eff, da
    h_prev = torch.stack(hs[:-1], dim=1)
    d_rw = h_prev.reshape(b * s, -1).T @ dpre.reshape(b * s, -1)
    return dpre, d_rw
