"""Neural-net blocks of the port: the dense attention + gated-MLP subset.

Plain functions on tensors, the same conventions as the JAX package's
``models/layers.py``:

* Shapes: activations (B, S, d); attention heads (B, S, H, Dh).
* GQA: queries have H heads, keys/values have KV heads (H % KV == 0).
* KV caches store post-RoPE keys.

Parameters are plain dicts of tensors with the JAX layouts (``wq``
(d, H, Dh), ``wo`` (H, Dh, d), ...), so weights made by the JAX ``init``
load leaf for leaf (``models/weights.py``).  Unlike JAX, cache updates are
in place: the caller's cache tensors are written.

Not ported yet (later slices): int8 KV, head offload, cross-attention, MoE
and the recurrent blocks.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import Activation, ModelConfig

Params = Dict[str, Any]
State = Dict[str, Any]


# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm computed in f32 with a (1 + w) scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, D); positions: (B, S) int.  cos and
    sin are cast to x's dtype before the product, as in JAX."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions.float()[..., None] * freq
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights with JAX ``layers._dense``'s scale: 1/sqrt(fan_in)
    with fan_in = shape[0] (or the given scale), drawn in f32."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, Dh) -> (B, S, H, Dh)."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype,
                   device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, h, hd), dtype, device),
        "wk": dense_init(gen, (d, kv, hd), dtype, device),
        "wv": dense_init(gen, (d, kv, hd), dtype, device),
        "wo": dense_init(gen, (h, hd, d), dtype, device,
                         scale=1.0 / math.sqrt(h * hd)),
    }


def masked_attention(q, k, v, mask, scale, soft_cap=None) -> torch.Tensor:
    """Plain GQA attention.  q: (B, S, H, D); k, v: (B, L, KV, D); mask
    broadcastable to (B, KV, G, S, L), True = attend.  Scores in q's dtype
    (as JAX), softmax in f32, probabilities cast back to v's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bsgqd,blgd->bgqsl", qg, k) * scale
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    scores = torch.where(mask, scores.float(), float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    o = torch.einsum("bgqsl,blgd->bsgqd", probs.to(v.dtype), v)
    return o.reshape(b, s, h, d)


def causal_mask(positions_q: torch.Tensor, positions_k: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """(B, S), (B, L) -> (B, 1, 1, S, L) causal (+ sliding window) mask."""
    pq = positions_q[:, None, None, :, None]
    pk = positions_k[:, None, None, None, :]
    m = (pk <= pq) & (pk >= 0)
    if window is not None:
        m = m & (pk > pq - window)
    return m


# Sequences longer than this attend one q block at a time (memory
# O(bq * L) instead of O(S * L)).
ATTN_BLOCK_THRESHOLD = 1024
ATTN_BLOCK_Q = 512


def attend(q, k, v, pos_q, pos_k, *, window: Optional[int], scale: float,
           soft_cap: Optional[float] = None) -> torch.Tensor:
    """Positional-masked GQA attention: attends where 0 <= pos_k <= pos_q
    (& window).  q: (B, S, H, D); k, v: (B, L, KV, D); pos_q: (B, S);
    pos_k: (B, L) (-1 = hole).  The plain formulation: the stateless
    forward and the ``decode_kernel=False`` reference path use it."""
    s = q.shape[1]
    if s <= ATTN_BLOCK_THRESHOLD:
        return masked_attention(q, k, v, causal_mask(pos_q, pos_k, window),
                                scale, soft_cap)
    outs = [masked_attention(q[:, i:i + ATTN_BLOCK_Q], k, v,
                             causal_mask(pos_q[:, i:i + ATTN_BLOCK_Q], pos_k,
                                         window), scale, soft_cap)
            for i in range(0, s, ATTN_BLOCK_Q)]
    return torch.cat(outs, dim=1)


def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    positions: torch.Tensor,
                    state: Optional[State],
                    mode: str,
                    window: Optional[int],
                    prefix_aware: bool = False,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_kernel: bool = False,
                    ) -> Tuple[torch.Tensor, Optional[State]]:
    """Self attention.  Returns (y, new_state).

    ``state`` None: the stateless (train) forward, plain ``attend``.
    Otherwise ``state`` = {"k", "v", "pos"} is either a dense per-row cache
    (B, L, KV, D) or, with ``block_tables``, a block pool
    (n_pages, bs, KV, D) — updated IN PLACE:

    * fresh dense prefill: ``ops.flash_attention`` (kernel B2), then the
      keys are written at their positions;
    * paged incremental prefill (``prefix_aware``, chunk resume / store
      hit): ``ops.paged_prefill_attention`` reads the prefix pages (kernel
      B3) and the suffix (kernel B2) BEFORE the suffix is written into its
      pages, as in JAX (writing first would count the suffix twice);
    * paged decode, S == 1: the new token's K/V are written into their
      pages FIRST, then ``ops.paged_decode_attention`` (kernel B1) reads
      the pages in place — or, with ``paged_kernel=False``, the pages are
      gathered and attended with plain ``attend`` (the A/B reference).

    Dead table entries (-1) write into the reserved scratch page 0, which
    every reader masks out.
    """
    scale = 1.0 / math.sqrt(cfg.head_dim)
    cap = cfg.logit_soft_cap
    b, s, _ = x.shape
    q = rope(_proj_in(x, p["wq"]), positions, cfg.rope_theta)
    k = rope(_proj_in(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj_in(x, p["wv"])

    new_state = None
    if state is None:
        o = attend(q, k, v, positions, positions, window=window, scale=scale,
                   soft_cap=cap)
    else:
        cache_k, cache_v, slot_pos = state["k"], state["v"], state["pos"]
        paged = block_tables is not None and cache_k.shape[0] != b
        if mode == "prefill" and paged:
            if not prefix_aware:
                raise ValueError("paged prefill is the incremental "
                                 "(prefix-aware) resume path")
            bs_pg = cache_k.shape[1]
            plen = block_tables.shape[1] * bs_pg
            o = ops.paged_prefill_attention(
                q, k, v, cache_k, cache_v, slot_pos, block_tables,
                positions, window=window, scale=scale, soft_cap=cap)
            slot_off = positions % plen
            rows = torch.arange(b, device=x.device)[:, None]
            wblk = block_tables[rows, slot_off // bs_pg].clamp_min(0).long()
            off = (slot_off % bs_pg).long()
            cache_k[wblk, off] = k
            cache_v[wblk, off] = v
            slot_pos[wblk, off] = positions.to(slot_pos.dtype)
        elif mode == "prefill":
            if prefix_aware:
                raise NotImplementedError(
                    "dense-cache incremental prefill is not ported; the "
                    "port resumes prefill over paged caches only")
            cache_len = cache_k.shape[1]
            if s > cache_len:
                raise NotImplementedError(
                    "prefill longer than the cache (ring wrap) is not "
                    "ported: windowed stacks come with a later slice")
            o = ops.flash_attention(q, k, v, window=window, scale=scale,
                                    soft_cap=cap)
            rows = torch.arange(b, device=x.device)[:, None]
            write_pos = (positions % cache_len).long()
            cache_k[rows, write_pos] = k
            cache_v[rows, write_pos] = v
            slot_pos[rows, write_pos] = positions.to(slot_pos.dtype)
        elif paged:
            if s != 1:
                raise NotImplementedError(
                    "multi-token paged decode (speculative verify) comes "
                    "with the speculation slice")
            bs_pg = cache_k.shape[1]
            nb = block_tables.shape[1]
            plen = nb * bs_pg
            slot_off = positions % plen
            rows = torch.arange(b, device=x.device)[:, None]
            wblk = block_tables[rows, slot_off // bs_pg].clamp_min(0).long()
            off = (slot_off % bs_pg).long()
            cache_k[wblk, off] = k
            cache_v[wblk, off] = v
            slot_pos[wblk, off] = positions.to(slot_pos.dtype)
            if paged_kernel:
                o = ops.paged_decode_attention(
                    q[:, 0].contiguous(), cache_k, cache_v, slot_pos,
                    block_tables, positions[:, 0].to(torch.int32),
                    window=window, scale=scale, soft_cap=cap)[:, None]
            else:
                safe = block_tables.clamp_min(0).long()
                kvh, hd = cache_k.shape[-2], cache_k.shape[-1]
                k_lin = cache_k[safe].reshape(b, plen, kvh, hd)
                v_lin = cache_v[safe].reshape(b, plen, kvh, hd)
                pos_lin = torch.where((block_tables >= 0)[:, :, None],
                                      slot_pos[safe], -1).reshape(b, plen)
                o = attend(q, k_lin, v_lin, positions, pos_lin,
                           window=window, scale=scale, soft_cap=cap)
        else:
            raise NotImplementedError(
                "dense-cache decode is not ported: the port decodes over "
                "paged pools")
        new_state = {"k": cache_k, "v": cache_v, "pos": slot_pos}

    wo = p["wo"]
    y = (o.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])).reshape(b, s, -1)
    return y, new_state


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype,
             device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, f), dtype, device),
        "w_up": dense_init(gen, (d, f), dtype, device),
        "w_down": dense_init(gen, (f, d), dtype, device),
    }


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    act = (F.gelu(g, approximate="tanh") if cfg.activation == Activation.GEGLU
           else F.silu(g))
    return (act * u) @ p["w_down"]
