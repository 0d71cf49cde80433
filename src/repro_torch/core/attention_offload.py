"""Partial-softmax attention and its exact combine (Eq. 6–10, §4.1).

Each KV partition j yields the statistics

    m_j = max(S_j),  l_j = Σ exp(S_j − m_j),  o_j = exp(S_j − m_j) · V_j

and the exact softmax over the union is

    M = max_j m_j,  L = Σ_j l_j e^{m_j − M},  O = Σ_j o_j e^{m_j − M} / L.

``split_kv_attention`` runs an N-way partition of one decode query's KV
as a loop over partitions: along the sequence (context-parallel decode)
or along the heads (Fig. 4's hot and cold devices, each branch its own
exact softmax).  ``sharded_decode_attention`` runs the sequence partition
across the ranks of a device mesh: each rank computes its shard's
partial and one ``all_gather`` of (H·D + 2H) floats per row brings every
rank the others'.  ``reference_attention`` is the one-softmax form the
tests hold them against.

The combine is plain torch (it is plain XLA in the JAX package, not a
Pallas kernel): the page-fused kernels emit one partial per page and
``kernels/ops.py`` reduces them here.  Masked partitions carry the kernels'
finite ``m = -1e30``; ``-inf`` (from ``partial_attention`` on a fully
masked partition) is handled too.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over one KV partition, returning partial stats.

    q: (B, H, D); k, v: (B, L, H, D) — heads already aligned.  mask: (B, L)
    or (B, H, L), True = attend.  Returns o (B, H, D) f32 unnormalized,
    l (B, H) f32, m (B, H) f32 (``-inf`` where nothing is attended)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * scale
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, :]
        s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhl,blhd->bhd", p, v.float())
    return o, l, m


Stack = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def combine_stacked(*stacks: Stack) -> torch.Tensor:
    """Exact softmax reconstruction over one or more stacks of partials,
    each (o (J, ..., D), l (J, ...), m (J, ...)) with its partition axis
    leading (views are fine: nothing is concatenated).  Returns (..., D)
    f32."""
    big_m = torch.stack([m.amax(dim=0) for _, _, m in stacks]).amax(dim=0)
    big_m_safe = torch.where(torch.isfinite(big_m), big_m, 0.0)
    num = den = 0.0
    for o, l, m in stacks:
        fin = torch.isfinite(m)
        w = torch.where(fin, torch.exp(torch.where(fin, m, float("-inf"))
                                       - big_m_safe), 0.0)
        num = num + (o * w[..., None]).sum(dim=0)
        den = den + (l * w).sum(dim=0)
    return num / den.clamp_min(1e-30)[..., None]


def combine_partials(os_: Sequence[torch.Tensor], ls: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor]) -> torch.Tensor:
    """Exact softmax reconstruction from per-partition (o, l, m)."""
    return combine_stacked((torch.stack(list(os_)), torch.stack(list(ls)),
                            torch.stack(list(ms))))


def expand_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, H, D) queries -> grouped (B, KV, G, D) for per-KV-head partials."""
    b, h, d = q.shape
    return q.reshape(b, n_kv, h // n_kv, d)


def split_kv_attention(q: torch.Tensor, k_parts: Sequence[torch.Tensor],
                       v_parts: Sequence[torch.Tensor],
                       masks: Optional[Sequence[Optional[torch.Tensor]]]
                       = None,
                       axis: str = "seq",
                       scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the KV scattered across partitions.

    axis="seq":  every part holds all heads and a slice of the sequence;
                 q (B, H, D), parts (B, L_j, H, D) -> (B, H, D) f32.
    axis="head": Fig. 4: the parts hold disjoint, consecutive head subsets;
                 q (B, H, D) is split to match, parts (B, L, H_j, D), and
                 each part's exact softmax is concatenated -> (B, H, D)."""
    if masks is None:
        masks = [None] * len(k_parts)
    if axis == "seq":
        parts = [partial_attention(q, k, v, m, scale)
                 for k, v, m in zip(k_parts, v_parts, masks)]
        return combine_partials(*zip(*parts))
    if axis == "head":
        outs = []
        h0 = 0
        for k, v, m in zip(k_parts, v_parts, masks):
            hj = k.shape[2]
            o, l, mm = partial_attention(q[:, h0:h0 + hj], k, v, m, scale)
            outs.append(combine_partials([o], [l], [mm]))
            h0 += hj
        return torch.cat(outs, dim=1)
    raise ValueError(axis)


def sharded_decode_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_valid: torch.Tensor, *,
                             seq_axis: str = "data",
                             scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention with the KV sequence sharded over the mesh axis
    ``seq_axis`` (JAX's ``shard_map`` of the same name, as explicit
    collectives).  Every rank calls it with its own shard: q (B, H, D)
    whole on every rank; k, v (B, L_j, KV, D) and kv_valid (B, L_j) bool,
    this rank's slice of the sequence (rank order along ``seq_axis`` is
    sequence order).  Returns the whole (B, H, D) in q's dtype on every
    rank.

    Each rank computes its partial (o, l, m): on a CUDA tensor kernel B5's
    per-block partials (``split_kv_decode_partials``, GQA-native, read in
    place) merged over the blocks, on a CPU tensor the plain
    ``partial_attention`` (K/V heads must equal q's there, as JAX's).  One
    ``all_gather`` over the axis's process group then carries B·(H·D + 2H)
    floats per rank, independent of L (the paper's "only l and O are
    exchanged", Eq. 8-10), and ``combine_partials`` takes them in rank
    order.  A shard with no valid key contributes nothing."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        from ..kernels.ref import merge_partials_plain
        from ..kernels.split_kv_decode import split_kv_decode_partials
        parts = split_kv_decode_partials(q, k, v, kv_valid.bool(),
                                         scale=scale)
        o, l, m = (x.squeeze(1) for x in merge_partials_plain(
            parts, group=parts[1].shape[1]))
    else:
        o, l, m = partial_attention(q, k, v, kv_valid.bool(), scale)
    group = mesh.get_group(seq_axis)
    n = dist.get_world_size(group)
    d = o.shape[-1]
    mine = torch.cat([o, l[..., None], m[..., None]], dim=-1).contiguous()
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    stats = torch.stack(parts)                       # (J, B, H, D + 2)
    return combine_stacked((stats[..., :d], stats[..., d],
                            stats[..., d + 1])).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """One softmax over the whole KV (the paper's form, for tests).
    q: (B, H, D); k, v: (B, L, H, D); mask (B, L) or (B, H, L).  Returns
    (B, H, D) f32; a fully masked row gives zeros."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * scale
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, :]
        s = torch.where(mask, s, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bhl,blhd->bhd", p, v.float())
