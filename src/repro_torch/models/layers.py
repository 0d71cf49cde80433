"""Neural-net blocks of the port: attention, the gated MLP and top-k MoE.

Plain functions on tensors, the same conventions as the JAX package's
``models/layers.py``:

* Shapes: activations (B, S, d); attention heads (B, S, H, Dh).
* GQA: queries have H heads, keys/values have KV heads (H % KV == 0).
* KV caches store post-RoPE keys.

Parameters are plain dicts of tensors with the JAX layouts (``wq``
(d, H, Dh), ``wo`` (H, Dh, d), ...), so weights made by the JAX ``init``
load leaf for leaf (``models/weights.py``).  Unlike JAX, cache updates are
in place: the caller's cache tensors are written.

int8 KV caches (a config's ``kv_quant``) store K/V as int8 with one f32
scale per (token, kv head) in the ``k_scale``/``v_scale`` leaves
(``quantize_kv``); attention folds the scales in (``masked_attention``,
or kernels B1/B4's int8 variants on the paged path).

Not ported yet (later slices): head offload, cross-attention and the
recurrent blocks.
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


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               scale: Optional[float] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normal weights with JAX ``layers._dense``'s scale: 1/sqrt(fan_in)
    with fan_in = shape[0] (or the given scale), drawn in f32.  For an
    expert leaf (E, d, f) that is 1/sqrt(E), as in JAX.  With ``out`` the
    draw is cast into it (the caller's stacked layer slot), so the peak is
    this leaf's f32 draw."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    w.mul_(scale)
    return w.to(dtype) if out is None else out.copy_(w)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization of K/V, as JAX's
    ``layers.quantize_kv``: scale = max(amax over D, 1e-6) / 127, values
    rounded half to even and clipped to +-127.  x: (B, S, KV, D) -> (int8
    values, f32 scales (B, S, KV))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, Dh) -> (B, S, H, Dh)."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype,
                   device, out: Optional[Params] = None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    o = out or {}
    return {
        "wq": dense_init(gen, (d, h, hd), dtype, device, out=o.get("wq")),
        "wk": dense_init(gen, (d, kv, hd), dtype, device, out=o.get("wk")),
        "wv": dense_init(gen, (d, kv, hd), dtype, device, out=o.get("wv")),
        "wo": dense_init(gen, (h, hd, d), dtype, device,
                         scale=1.0 / math.sqrt(h * hd), out=o.get("wo")),
    }


def masked_attention(q, k, v, mask, scale, soft_cap=None, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Plain GQA attention.  q: (B, S, H, D); k, v: (B, L, KV, D); mask
    broadcastable to (B, KV, G, S, L), True = attend.  Scores in q's dtype
    (as JAX), softmax in f32, probabilities cast back to v's dtype.

    int8 K/V (with k_scale/v_scale (B, L, KV) f32) are cast to q's dtype;
    the K scale multiplies the scores after ``* scale`` and before the soft
    cap, the V scale the probabilities after the softmax — JAX's order."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    kc = k.to(q.dtype) if k.dtype == torch.int8 else k
    scores = torch.einsum("bsgqd,blgd->bgqsl", qg, kc) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    scores = torch.where(mask, scores.float(), float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    vc = v.to(q.dtype) if v.dtype == torch.int8 else v
    o = torch.einsum("bgqsl,blgd->bsgqd", probs.to(vc.dtype), vc)
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
           soft_cap: Optional[float] = None, k_scale=None,
           v_scale=None) -> torch.Tensor:
    """Positional-masked GQA attention: attends where 0 <= pos_k <= pos_q
    (& window).  q: (B, S, H, D); k, v: (B, L, KV, D), or int8 with
    k_scale/v_scale (B, L, KV); pos_q: (B, S); pos_k: (B, L) (-1 = hole).
    The plain formulation: the stateless forward and the
    ``decode_kernel=False`` reference path use it."""
    s = q.shape[1]
    kw = dict(k_scale=k_scale, v_scale=v_scale)
    if s <= ATTN_BLOCK_THRESHOLD:
        return masked_attention(q, k, v, causal_mask(pos_q, pos_k, window),
                                scale, soft_cap, **kw)
    outs = [masked_attention(q[:, i:i + ATTN_BLOCK_Q], k, v,
                             causal_mask(pos_q[:, i:i + ATTN_BLOCK_Q], pos_k,
                                         window), scale, soft_cap, **kw)
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
    * dense incremental prefill (``prefix_aware`` over a per-row cache, a
      layer-span pipeline's chunk resume): plain ``attend`` over the
      cache's keys followed by the in-context ones, then the write, as
      JAX computes it outside any kernel;
    * paged decode: the new tokens' K/V are written into their pages
      FIRST, then read in place — S == 1 by ``ops.paged_decode_attention``
      (kernel B1), S > 1 (the speculative verify step: the pending token
      plus its proposals) by ``ops.paged_verify_attention`` (kernel B4),
      where each query's position hides the in-flight tokens after it; or,
      with ``paged_kernel=False``, the pages are gathered and attended
      with plain ``attend`` (the A/B reference);
    * dense decode (the draft model's per-row cache): ring write at
      ``positions % cache_len``, then plain ``attend``, as the JAX package
      computes it outside any kernel.

    An int8 cache (``k_scale``/``v_scale`` in ``state``) is written with
    ``quantize_kv``'s values and scales at the same places; prefill still
    attends over the unquantized K/V, every read after it through the
    scales (kernels B1/B4's int8 variants, or plain ``attend``).  As in
    JAX, an int8 cache has no prefix-aware (resume) prefill: it raises
    ``ValueError``.

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
        quant = "k_scale" in state
        k_sc = state.get("k_scale")
        v_sc = state.get("v_scale")
        if quant and prefix_aware:
            raise ValueError("an int8 KV cache has no prefix-aware "
                             "(resume) prefill, as in the JAX package "
                             "(int8 cache + prefix store not combined)")
        # what the cache stores: int8 values and their scales, or K/V
        k_w, v_w = k, v
        if quant:
            # K and V in one call: half the small kernels per layer
            (k_w, v_w), (ks_w, vs_w) = quantize_kv(torch.stack((k, v)))
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
            cache_len = cache_k.shape[1]
            if s > cache_len:
                raise NotImplementedError(
                    "prefill longer than the cache (ring wrap) is not "
                    "ported: windowed stacks come with a later slice")
            if prefix_aware:
                # chained (layer-span) resume over a dense per-row cache:
                # plain attend over [cache ; in-context keys], as JAX
                # computes it outside any kernel
                o = attend(q, torch.cat([cache_k, k], dim=1),
                           torch.cat([cache_v, v], dim=1), positions,
                           torch.cat([slot_pos, positions.to(slot_pos.dtype)],
                                     dim=1),
                           window=window, scale=scale, soft_cap=cap)
            else:
                o = ops.flash_attention(q, k, v, window=window, scale=scale,
                                        soft_cap=cap)
            rows = torch.arange(b, device=x.device)[:, None]
            write_pos = (positions % cache_len).long()
            cache_k[rows, write_pos] = k_w
            cache_v[rows, write_pos] = v_w
            slot_pos[rows, write_pos] = positions.to(slot_pos.dtype)
            if quant:
                k_sc[rows, write_pos] = ks_w
                v_sc[rows, write_pos] = vs_w
        elif paged:
            bs_pg = cache_k.shape[1]
            nb = block_tables.shape[1]
            plen = nb * bs_pg
            slot_off = positions % plen                      # (B, S)
            rows = torch.arange(b, device=x.device)[:, None]
            wblk = block_tables[rows, slot_off // bs_pg].clamp_min(0).long()
            off = (slot_off % bs_pg).long()
            cache_k[wblk, off] = k_w
            cache_v[wblk, off] = v_w
            slot_pos[wblk, off] = positions.to(slot_pos.dtype)
            if quant:
                k_sc[wblk, off] = ks_w
                v_sc[wblk, off] = vs_w
            scales = dict(k_scale_pages=k_sc, v_scale_pages=v_sc)
            if paged_kernel and s == 1:
                o = ops.paged_decode_attention(
                    q[:, 0].contiguous(), cache_k, cache_v, slot_pos,
                    block_tables, positions[:, 0].to(torch.int32),
                    window=window, scale=scale, soft_cap=cap,
                    **scales)[:, None]
            elif paged_kernel:
                o = ops.paged_verify_attention(
                    q.contiguous(), cache_k, cache_v, slot_pos, block_tables,
                    positions.to(torch.int32), window=window, scale=scale,
                    soft_cap=cap, **scales)
            else:
                safe = block_tables.clamp_min(0).long()
                kvh, hd = cache_k.shape[-2], cache_k.shape[-1]
                k_lin = cache_k[safe].reshape(b, plen, kvh, hd)
                v_lin = cache_v[safe].reshape(b, plen, kvh, hd)
                pos_lin = torch.where((block_tables >= 0)[:, :, None],
                                      slot_pos[safe], -1).reshape(b, plen)
                o = attend(q, k_lin, v_lin, positions, pos_lin,
                           window=window, scale=scale, soft_cap=cap,
                           k_scale=(k_sc[safe].reshape(b, plen, kvh)
                                    if quant else None),
                           v_scale=(v_sc[safe].reshape(b, plen, kvh)
                                    if quant else None))
        else:
            # dense per-row cache (the draft model's): ring write at
            # positions % cache_len, then plain attention over the row
            cache_len = cache_k.shape[1]
            rows = torch.arange(b, device=x.device)[:, None]
            write_pos = (positions % cache_len).long()
            cache_k[rows, write_pos] = k_w
            cache_v[rows, write_pos] = v_w
            slot_pos[rows, write_pos] = positions.to(slot_pos.dtype)
            if quant:
                k_sc[rows, write_pos] = ks_w
                v_sc[rows, write_pos] = vs_w
            o = attend(q, cache_k, cache_v, positions, slot_pos,
                       window=window, scale=scale, soft_cap=cap,
                       k_scale=k_sc, v_scale=v_sc)
        new_state = {"k": cache_k, "v": cache_v, "pos": slot_pos}
        if quant:
            new_state.update(k_scale=k_sc, v_scale=v_sc)

    wo = p["wo"]
    y = (o.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])).reshape(b, s, -1)
    return y, new_state


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU) and MoE
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype,
             device, out: Optional[Params] = None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    o = out or {}
    return {
        "w_gate": dense_init(gen, (d, f), dtype, device, out=o.get("w_gate")),
        "w_up": dense_init(gen, (d, f), dtype, device, out=o.get("w_up")),
        "w_down": dense_init(gen, (f, d), dtype, device, out=o.get("w_down")),
    }


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    return (F.gelu(g, approximate="tanh") if cfg.activation == Activation.GEGLU
            else F.silu(g))


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (_act(cfg, g) * u) @ p["w_down"]


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype,
             device, out: Optional[Params] = None) -> Params:
    """The router (d, E) in f32 whatever ``dtype``; the experts' gated MLPs
    stacked: ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d), each at
    ``dense_init``'s scale, whose fan-in is the leading axis: 1/sqrt(E),
    as JAX's ``init_moe`` draws them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    o = out or {}
    return {
        "router": dense_init(gen, (d, e), torch.float32, device,
                             out=o.get("router")),
        "w_gate": dense_init(gen, (e, d, f), dtype, device,
                             out=o.get("w_gate")),
        "w_up": dense_init(gen, (e, d, f), dtype, device, out=o.get("w_up")),
        "w_down": dense_init(gen, (e, f, d), dtype, device,
                             out=o.get("w_down")),
    }


MOE_IMPLS = ("dense", "sorted", "local_sorted")


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              impl: str = "sorted",
              capacity_factor: Optional[float] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE, as JAX's ``moe_apply``.  Returns (y, router_load), the
    load being each expert's share of the T * k (token, expert) pairs.

    The router runs in f32 (``x`` cast to f32 against the f32 router),
    then softmax, top-k and the top-k gates renormalised to sum to 1.

    impl="dense": every expert on every token, gate-weighted.
    impl="sorted": the (token, expert) pairs sorted stably by expert into
    an (E, cap, d) buffer, one batched product per expert weight.
    ``capacity_factor=None`` is no-drop (cap = T, what serving runs); a
    float bounds cap at ceil(T * k / E * cf), and pairs ranked past it
    within their expert, in the stable sorted order, are dropped.
    impl="local_sorted" (JAX: the sorted dispatch per data shard under
    ``shard_map``) needs a device mesh and raises.

    Static shapes and no host read-back, so the step can be captured in a
    CUDA graph.  No scatter-add: the buffer is gathered from the sorted
    pairs, and each token's k expert rows are gathered back through the
    inverse permutation and summed over k in one fixed-order reduction,
    so the output does not vary from run to run."""
    if impl == "local_sorted":
        raise NotImplementedError(
            "moe_apply(impl='local_sorted') shards the dispatch over a "
            "device mesh: not ported yet (ROADMAP A9, multi-device)")
    if impl not in MOE_IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    n = t * k
    dev = x.device
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)                  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    eid = idx.reshape(n)
    router_load = torch.zeros(e, dtype=torch.float32, device=dev
                              ).scatter_add_(0, eid, torch.ones(
                                  n, dtype=torch.float32, device=dev)) / n

    def expert_ffn(xe):                                            # (E, C, d)
        g = torch.bmm(xe, p["w_gate"])
        u = torch.bmm(xe, p["w_up"])
        return torch.bmm(_act(cfg, g) * u, p["w_down"])

    if impl == "dense":
        h = expert_ffn(xt[None].expand(e, t, d))                   # (E, T, d)
        w = torch.zeros((t, e), dtype=x.dtype, device=dev).scatter_(
            1, idx, gate_vals.to(x.dtype))
        y = torch.einsum("etd,te->td", h, w)
        return y.reshape(b, s, d), router_load

    cap = t if capacity_factor is None \
        else int(math.ceil(t * k / e * capacity_factor))
    cap = max(cap, 1)
    order = torch.argsort(eid, stable=True)                        # (n,)
    ar_e = torch.arange(e, dtype=eid.dtype, device=dev)
    eid_s = eid[order]
    seg_start = torch.searchsorted(eid_s, ar_e)                    # (E,)
    count = torch.searchsorted(eid_s, ar_e, right=True) - seg_start
    # dispatch: slot (expert, r) holds the r-th pair of that expert
    ar_c = torch.arange(cap, device=dev)
    filled = ar_c[None] < count[:, None]                           # (E, cap)
    src = order[(seg_start[:, None] + ar_c[None]).clamp_max(n - 1)] // k
    buf = torch.where(filled.reshape(-1, 1), xt[src.reshape(-1)],
                      torch.zeros((), dtype=x.dtype, device=dev))
    h = expert_ffn(buf.reshape(e, cap, d)).reshape(e * cap, d)
    # combine: pair i's rank within its expert, from its sorted position
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, dtype=order.dtype, device=dev)
    rank = pos - seg_start[eid]
    keep = rank < cap
    dest = eid * cap + torch.where(keep, rank, torch.zeros_like(rank))
    rows = torch.where(keep[:, None], h[dest],
                       torch.zeros((), dtype=x.dtype, device=dev))
    y = (rows * gate_vals.reshape(n, 1).to(x.dtype)).reshape(t, k, d).sum(1)
    return y.reshape(b, s, d), router_load
