"""Partial-softmax attention and its exact combine (Eq. 6–10, §4.1).

Each KV partition j yields the statistics

    m_j = max(S_j),  l_j = Σ exp(S_j − m_j),  o_j = exp(S_j − m_j) · V_j

and the exact softmax over the union is

    M = max_j m_j,  L = Σ_j l_j e^{m_j − M},  O = Σ_j o_j e^{m_j − M} / L.

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
