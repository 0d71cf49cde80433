"""Neural-net blocks of the port: attention, the gated MLP, top-k MoE and
the recurrent blocks.

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

Fig. 4's head offload (``head_offload``) splits a dense decode step's
attention on the kv-head axis into a hot and a cold branch, each its own
exact softmax (``_decode_head_offload``).

Windowed attention keeps a ring cache of ``min(max_len, window)`` slots:
a key at position p lives in slot ``p % cache_len``, and a prefill longer
than the ring writes only its last ``cache_len`` keys, as JAX does.

The RG-LRU block (Griffin / RecurrentGemma, ``rglru_apply``) carries a
slot-dense recurrent state ``{"h": (B, d) f32, "conv": (B, W-1, d)}``,
updated in place like the caches; prefill runs its recurrence as a
log-depth scan over the time axis (``rglru_scan``).

Cross attention (seamless-m4t's text decoder, ``_cross_attention``)
attends from the self attention's normed input over precomputed encoder
frames; its projections ride in a slot-dense cross cache ``{"k", "v"}``
(B, n_frames, KV, D) that prefill writes and decode reads.

The xLSTM blocks (``mlstm_apply``, ``slstm_apply``) run their exponential
gating recurrence in f32 one step at a time, as JAX's ``lax.scan`` does,
and write their slot-dense state (mLSTM ``C``, ``n``, ``m``; sLSTM ``c``,
``n``, ``m``, ``h``; all f32) in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed
import torch.nn.functional as F

from ..kernels import ops, xlstm_scan
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
    sin are cast to x's dtype before the product, as in JAX.  ``freq`` is
    a plain tensor; under a dry run's ``DTensor`` step
    (``launch/dryrun.py``) ``implicit_replication()`` treats it, like every
    other constant, as replicated."""
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
    if _is_dtensor(q) and kvh != h:
        # the dry run: a head split (H -> KV x G) has no view when KV does
        # not divide over the mesh, forward or in the backward, so each kv
        # head is repeated to its G query heads (the same products)
        g = h // kvh

        def rep(t):
            return t[:, :, :, None].expand(
                *t.shape[:3], g, *t.shape[3:]).reshape(
                    t.shape[0], t.shape[1], h, *t.shape[3:])
        k, v = rep(k), rep(v)
        k_scale = rep(k_scale) if k_scale is not None else None
        v_scale = rep(v_scale) if v_scale is not None else None
        kvh = h
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


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def vocab_parallel(unembed: torch.Tensor) -> torch.Tensor:
    """The (d, V) unembedding as the logits' product takes it: as it is,
    or for a ``DTensor`` (the dry run) split along the vocabulary only,
    d gathered (the FSDP gather), so the logits keep the rows' batch
    split and the vocabulary's, and no rank sums whole logits."""
    if not _is_dtensor(unembed):
        return unembed
    from torch.distributed.tensor import Replicate
    want = [p if p.is_shard() and p.dim == 1 else Replicate()
            for p in unembed.placements]
    return unembed.redistribute(unembed.device_mesh, want)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: the embedding rows of (B, S) tokens.

    On a ``DTensor`` table (the dry run, ``launch/dryrun.py``), split
    along the vocabulary over "model" and maybe along d over the batch
    axes (FSDP), the lookup is the vocabulary-parallel one: the tokens
    keep their batch split, the table is gathered along d (the FSDP
    gather), each rank reads the rows of its vocabulary slice (zeros for
    the others) and the result is a partial sum over the vocabulary's
    mesh dims.  ``DTensor``'s own gather would replicate the batch."""
    if not _is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if p.is_shard() and p.dim == 0]
    t_pl = [Replicate() if i in vocab or not (p.is_shard() and p.dim == 0)
            else p for i, p in enumerate(tokens.placements)]
    w_pl = [p if i in vocab else Replicate()
            for i, p in enumerate(table.placements)]
    tok = tokens.redistribute(mesh, t_pl)
    w = table.redistribute(mesh, w_pl)
    w_l = w.to_local()
    _, off = compute_local_shape_and_global_offset(w.shape, mesh, w_pl)
    rows = tok.to_local().long() - off[0]
    inside = (rows >= 0) & (rows < w_l.shape[0])
    x_l = w_l[rows.clamp(0, max(w_l.shape[0] - 1, 0))] * \
        inside[..., None].to(w_l.dtype)
    out_pl = [Partial() if i in vocab else p for i, p in enumerate(t_pl)]
    return DTensor.from_local(x_l, mesh, out_pl, run_check=False)


def _write_rows(writes, positions: torch.Tensor) -> None:
    """Write each ``(cache, values)`` pair of a dense per-row cache in
    place: values (B, S, ...) land at slot ``positions % L`` of their row,
    positions (B, S) consecutive per row (``lengths + arange(S)``), at most
    L of them (a longer sequence is tail-sliced first).

    On plain tensors this is one ``index_put_`` per cache.  On a
    ``DTensor`` cache (the dry run, ``launch/dryrun.py``; its rows and
    slots may be split over the mesh) each rank writes its own shard: slot
    j of row b takes token (j - positions[b, 0]) mod L when that is below
    S, a gather from the values, which are first placed like the cache's
    rows and whole along the rest."""
    b = positions.shape[0]
    if not _is_dtensor(writes[0][0]):
        rows = torch.arange(b, device=positions.device)[:, None]
        write_pos = (positions % writes[0][0].shape[1]).long()
        for cache, val in writes:
            cache[rows, write_pos] = val
        return
    for cache, val in writes:
        _write_shard(cache, val, positions)


def _write_shard(cache, val, positions) -> None:
    """``_write_rows`` for one ``DTensor`` cache (see there)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, place = cache.device_mesh, cache.placements
    rows_like = [p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in place]
    val_l = val.redistribute(mesh, rows_like).to_local()
    start = positions[:, :1].redistribute(mesh, rows_like).to_local()
    local = cache.to_local()
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh, place)
    length, s = cache.shape[1], val_l.shape[1]
    slots = torch.arange(local.shape[1], device=local.device) + off[1]
    tok = (slots[None] - start.long()) % length              # (B_l, L_l)
    hit = tok < s
    idx = tok.clamp_max(s - 1)
    idx = idx.reshape(idx.shape + (1,) * (local.dim() - 2)).expand(
        idx.shape + tuple(local.shape[2:]))
    new = val_l.to(local.dtype).gather(1, idx)
    hit = hit.reshape(hit.shape + (1,) * (local.dim() - 2))
    local.copy_(torch.where(hit, new, local))


def _shard_block_k(cache: torch.Tensor, block_k: int = 512) -> int:
    """B5's key block: 512 (``ops.decode_attention``'s), or on a
    ``DTensor`` cache split along its keys, at most one shard's keys, so
    every shard holds whole blocks and B5 splits along the sequence."""
    if not _is_dtensor(cache):
        return block_k
    return min(block_k, cache.to_local().shape[1])


def dense_valid(slot_pos: torch.Tensor, pos_q: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """(B, L) keys a decode query at ``pos_q`` (B,) sees in a dense cache:
    0 <= slot_pos <= pos_q, and inside the window."""
    pq = pos_q[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= pq)
    if window is not None:
        valid = valid & (slot_pos > pq - window)
    return valid


def _decode_head_offload(cfg: ModelConfig, q, cache_k, cache_v, positions,
                         slot_pos, window, scale, n_off: int) -> torch.Tensor:
    """Fig. 4: split a decode step's attention on the kv-head axis.  The
    hot branch keeps kv heads ``[:kv - n_off]``, the cold branch computes
    ``[kv - n_off:]``; the branches hold disjoint heads, so each is its
    own exact softmax and the outputs concatenate on the head axis (only
    (o, l, m) would cross the devices).

    Each branch is ``ops.decode_attention``: B5's per-block partials
    (``ops.decode_partials``; the kernel on a CUDA tensor, its plain
    version on the CPU) over the branch's contiguous range of kv heads,
    read in place, and that range's query heads, reduced by
    ``combine_stacked``.  B5 is GQA-native, so JAX's ``jnp.repeat`` of K/V
    per query head is not needed.  As JAX's ``partial_attention``, no
    soft cap.  q: (B, 1, H, D); returns (B, 1, H, D) in q's dtype (each
    branch cast on its own: the same values as JAX's cast after the
    concatenation)."""
    b, s, h, d = q.shape
    kv = cache_k.shape[2]
    if not 0 <= n_off <= kv:
        raise ValueError(f"head_offload must be in 0..{kv} kv heads, "
                         f"got {n_off}")
    if s != 1:
        raise ValueError(f"head offload is a decode step of one token, "
                         f"got {s} query positions")
    g = h // kv
    cut = kv - n_off
    valid = dense_valid(slot_pos, positions[:, 0], window)
    q0 = q[:, 0]
    outs = [ops.decode_attention(
        q0[:, lo * g:hi * g], cache_k[:, :, lo:hi], cache_v[:, :, lo:hi],
        valid, scale=scale) for lo, hi in ((0, cut), (cut, kv)) if hi > lo]
    return torch.cat(outs, dim=1)[:, None]


def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    positions: torch.Tensor,
                    state: Optional[State],
                    mode: str,
                    window: Optional[int],
                    prefix_aware: bool = False,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_kernel: bool = False,
                    head_offload: int = 0,
                    frames: Optional[torch.Tensor] = None,
                    cross_p: Optional[Params] = None,
                    cross_state: Optional[State] = None,
                    ) -> Tuple[torch.Tensor, Optional[State]]:
    """Self attention, plus cross attention over ``frames`` when
    ``cross_p`` is given (``_cross_attention``).  Returns (y, new_state).

    ``state`` None: the stateless (train) forward, plain ``attend``.
    Otherwise ``state`` = {"k", "v", "pos"} is either a dense per-row cache
    (B, L, KV, D) or, with ``block_tables``, a block pool
    (n_pages, bs, KV, D) — updated IN PLACE:

    * fresh dense prefill: ``ops.flash_attention`` (kernel B2), then the
      keys are written at slot ``position % cache_len``; a ring shorter
      than the sequence takes only its last ``cache_len`` keys (JAX's
      tail slice);
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
    * dense decode (the dense-row engine's and the draft model's per-row
      cache): ring write at ``positions % cache_len``, then, for one token
      per row over a bf16/f32 cache without a soft cap,
      ``ops.decode_attention`` (kernel B5 on a CUDA tensor, its plain
      version on the CPU) under the validity mask ``0 <= slot_pos <= pos``
      plus the window (``dense_valid``); JAX computes this step in XLA.
      The config alone fixes the other route, plain ``attend``: for a
      verify step (S > 1), an int8 cache or a soft-capped stack, since B5
      takes no scales and no cap (JAX computes these outside any kernel
      too).  ``head_offload > 0`` (Fig. 4) splits the one-token step's
      heads (``_decode_head_offload``, B5 per branch); on an int8 cache it
      is ignored, as JAX's ``and not quant`` does.

    An int8 cache (``k_scale``/``v_scale`` in ``state``) is written with
    ``quantize_kv``'s values and scales at the same places; prefill still
    attends over the unquantized K/V, every read after it through the
    scales (kernels B1/B4's int8 variants, or plain ``attend``).  As in
    JAX, an int8 cache has no prefix-aware (resume) prefill: it raises
    ``ValueError``.

    Dead table entries (-1) write into the reserved scratch page 0, which
    every reader masks out.  ``head_offload > 0`` on a paged cache raises
    ``ValueError`` (JAX asserts that the two are not combined).
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
        if head_offload and block_tables is not None:
            raise ValueError("head offload and paged caches are not "
                             "combined (as in the JAX package)")
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
            # a ring shorter than the sequence keeps its last cache_len
            # keys (tail-sliced, so no two writes share a slot), as JAX
            pos_w = positions
            if s > cache_len:
                cut = slice(s - cache_len, None)
                k_w, v_w, pos_w = k_w[:, cut], v_w[:, cut], positions[:, cut]
                if quant:
                    ks_w, vs_w = ks_w[:, cut], vs_w[:, cut]
            writes = [(cache_k, k_w), (cache_v, v_w),
                      (slot_pos, pos_w.to(slot_pos.dtype))]
            if quant:
                writes += [(k_sc, ks_w), (v_sc, vs_w)]
            _write_rows(writes, pos_w)
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
            # dense per-row cache (dense-row engines, the draft model):
            # ring write at positions % cache_len, then attention over the
            # row (B5 for one token of a bf16/f32 cache without a cap)
            writes = [(cache_k, k_w), (cache_v, v_w),
                      (slot_pos, positions.to(slot_pos.dtype))]
            if quant:
                writes += [(k_sc, ks_w), (v_sc, vs_w)]
            _write_rows(writes, positions)
            if head_offload > 0 and not quant:
                o = _decode_head_offload(cfg, q, cache_k, cache_v, positions,
                                         slot_pos, window, scale,
                                         head_offload)
            elif s == 1 and not quant and cap is None:
                o = ops.decode_attention(
                    q[:, 0], cache_k, cache_v,
                    dense_valid(slot_pos, positions[:, 0], window),
                    scale=scale, block_k=_shard_block_k(cache_k))[:, None]
            else:
                o = attend(q, cache_k, cache_v, positions, slot_pos,
                           window=window, scale=scale, soft_cap=cap,
                           k_scale=k_sc, v_scale=v_sc)
        new_state = {"k": cache_k, "v": cache_v, "pos": slot_pos}
        if quant:
            new_state.update(k_scale=k_sc, v_scale=v_sc)

    y = _out_proj(o, p["wo"])
    if cross_p is not None:
        y = y + _cross_attention(cfg, cross_p, x, frames=frames,
                                 state=cross_state, mode=mode, scale=scale)
    return y, new_state


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) x (H, Dh, d) -> (B, S, d)."""
    b, s = o.shape[:2]
    return (o.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])).reshape(
        b, s, -1)


_EVERY_FRAME: Dict[Tuple[Tuple[int, int], torch.device], torch.Tensor] = {}


def _every_frame(shape, device) -> torch.Tensor:
    """The all-true (B, n_frames) key mask of a cross decode, made once
    per shape and device and shared by every layer and step.  One made
    while a CUDA graph is being captured is not kept: its fill runs only
    when the graph replays."""
    key = (tuple(shape), torch.device(device))
    mask = _EVERY_FRAME.get(key)
    if mask is None:
        mask = torch.ones(shape, dtype=torch.bool, device=device)
        if not (mask.is_cuda and torch.cuda.is_current_stream_capturing()):
            _EVERY_FRAME[key] = mask
    return mask


def _cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                     frames: Optional[torch.Tensor],
                     state: Optional[State], mode: str,
                     scale: float) -> torch.Tensor:
    """Cross attention of the normed stream ``x`` (the ``norm1`` output
    self attention reads; the block's ``cross_norm`` is not read, as in
    JAX) over the encoder frames, as JAX's ``attention_apply``: no
    position, no mask, no soft cap, the self attention's ``scale``.

    ``state`` = {"k", "v"} (B, n_frames, KV, D) is the slot-dense cross
    cache.  Decode reads it as it is (no frames needed); every other mode
    projects ``frames`` (B, n_frames, d_model) and, with a state, writes
    the projections into it in place, cast to its dtype.  Frames of a
    narrower float type are widened to x's dtype, as JAX's einsum
    promotes them; frames that would widen the stream (f32 frames on a
    bf16 stack) raise ``ValueError``, where JAX's layer scan refuses the
    f32 carry.  A one-token decode step attends through
    ``ops.decode_attention`` (kernel B5 on a CUDA tensor, every frame
    valid; its plain version on the CPU), where JAX computes in XLA; a
    prefill's S x n_frames attention is plain ``masked_attention``, as
    JAX's.  Returns the output projected by the cross ``wo``, (B, S, d)."""
    b, s, _ = x.shape
    if state is not None and mode == "decode":
        ck, cv = state["k"], state["v"]
    else:
        if frames is None:
            raise ValueError(f"{cfg.name}: cross attention needs frames "
                             f"(B, n_frames, d_model) in mode {mode!r}")
        if frames.shape[0] != b:
            raise ValueError(f"frames batch {frames.shape[0]} does not "
                             f"match the batch of {b} rows")
        if torch.promote_types(frames.dtype, x.dtype) != x.dtype:
            raise ValueError(f"{cfg.name}: {frames.dtype} frames on a "
                             f"{x.dtype} stack would widen its stream "
                             f"(JAX refuses them too); pass frames in "
                             f"{x.dtype}")
        fr = frames.to(device=x.device, dtype=x.dtype)
        ck, cv = _proj_in(fr, p["wk"]), _proj_in(fr, p["wv"])
        if state is not None:
            state["k"].copy_(ck)
            state["v"].copy_(cv)
    cq = _proj_in(x, p["wq"])
    if mode == "decode" and s == 1:
        co = ops.decode_attention(cq[:, 0], ck, cv,
                                  _every_frame(ck.shape[:2], x.device),
                                  scale=scale)[:, None]
    else:
        every = torch.ones((1, 1, 1, 1, ck.shape[1]), dtype=torch.bool,
                           device=x.device)
        co = masked_attention(cq, ck, cv, every, scale)
    return _out_proj(co, p["wo"])


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
              mesh=None,
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
    impl="local_sorted": the sorted dispatch per data shard (JAX's
    ``shard_map`` over the mesh's "pod"/"data" axes, as explicit
    collectives).  Every rank of ``mesh`` (a ``DeviceMesh``) calls it with
    its own batch shard ``x`` and the whole ``p``; the argsort and gathers
    stay on the rank, with the capacity of its T_local rows
    (ceil(T_local * k / E * cf)), and ``router_load`` is the mean of the
    shards' loads (``all_reduce`` over the data axes, divided by their
    size).  With no mesh, or a mesh without a data axis, it is "sorted",
    as JAX falls back.

    Static shapes and no host read-back, so the step can be captured in a
    CUDA graph.  No scatter-add: the buffer is gathered from the sorted
    pairs, and each token's k expert rows are gathered back through the
    inverse permutation and summed over k in one fixed-order reduction,
    so the output does not vary from run to run."""
    if impl == "local_sorted":
        from ..launch.mesh import data_axes
        dp = data_axes(mesh) if mesh is not None else ()
        if not dp:
            impl = "sorted"
        else:
            y, load = moe_apply(cfg, p, x, impl="sorted",
                                capacity_factor=capacity_factor)
            n = 1
            for a in dp:
                group = mesh.get_group(a)
                torch.distributed.all_reduce(load, group=group)
                n *= torch.distributed.get_world_size(group)
            return y, load / n
    if impl not in MOE_IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}")
    if _is_dtensor(x):
        return _moe_sharded(cfg, p, x, impl, capacity_factor)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    n = t * k
    dev = x.device
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
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


def _moe_sharded(cfg: ModelConfig, p: Params, x, impl: str,
                 capacity_factor: Optional[float]):
    """``moe_apply`` on ``DTensor``s (the dry run, ``launch/dryrun.py``):
    every rank routes the whole batch (the router and ``x`` gathered) and
    runs the dispatch on its local tensors, the experts' FFN on its slice
    of their hidden dim (the weights keep their split of f and gather the
    rest); the output is a partial sum over the mesh dims splitting f,
    placed back as ``x`` is.  The dispatch's sorts, searches and scatters
    then need no ``DTensor`` rule."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim

    def keep(w, fdim):
        want = [pl if pl.is_shard() and pl.dim == fdim else Replicate()
                for pl in w.placements]
        return w.redistribute(mesh, want)
    w_gate, w_up, w_down = (keep(p["w_gate"], 2), keep(p["w_up"], 2),
                            keep(p["w_down"], 1))
    local = {"router": p["router"].redistribute(mesh, whole).to_local(),
             "w_gate": w_gate.to_local(), "w_up": w_up.to_local(),
             "w_down": w_down.to_local()}
    y, load = moe_apply(cfg, local, x.redistribute(mesh, whole).to_local(),
                        impl=impl, capacity_factor=capacity_factor)
    y = DTensor.from_local(y, mesh, [Partial() if pl.is_shard() else
                                     Replicate() for pl in w_gate.placements],
                           run_check=False)
    place = [pl if pl.is_shard() else Replicate() for pl in x.placements]
    return (y.redistribute(mesh, place),
            DTensor.from_local(load, mesh, whole, run_check=False))


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

def init_rglru(cfg: ModelConfig, gen: Optional[torch.Generator], dtype,
               device, out: Optional[Params] = None) -> Params:
    """JAX's ``init_rglru``: five (d, d) projections, the (W, d) conv taps
    at scale 0.1, and ``a_param`` (d,) = 2.0 in f32 whatever ``dtype``."""
    d = cfg.d_model
    o = out or {}
    p = {"w_x": dense_init(gen, (d, d), dtype, device, out=o.get("w_x")),
         "w_y": dense_init(gen, (d, d), dtype, device, out=o.get("w_y")),
         "conv_w": dense_init(gen, (cfg.rglru_conv_width, d), dtype, device,
                              scale=0.1, out=o.get("conv_w")),
         "w_a": dense_init(gen, (d, d), dtype, device, out=o.get("w_a")),
         "w_i": dense_init(gen, (d, d), dtype, device, out=o.get("w_i"))}
    a = o.get("a_param")
    p["a_param"] = (a.fill_(2.0) if a is not None else torch.full(
        (d,), 2.0, dtype=torch.float32, device=device))
    p["w_out"] = dense_init(gen, (d, d), dtype, device, out=o.get("w_out"))
    return p


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t over time axis 1, from h0 (B, d).

    The recurrence's affine maps compose associatively, (a1, b1) then
    (a2, b2) = (a1 a2, a2 b1 + b2), so the inclusive scan takes
    ceil(log2 S) elementwise passes over (B, S, d) (Hillis-Steele), never a
    loop over S: JAX's ``lax.associative_scan`` with the same combine, in
    another association order (f32 results agree to a few ulps)."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev, b_prev = a[:, :-off], bx[:, :-off]
        bx = torch.cat([bx[:, :off], a[:, off:] * b_prev + bx[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], 1)
        off *= 2
    return a * h0[:, None, :] + bx


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                state: Optional[State], mode: str
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """The RG-LRU block, as JAX's ``rglru_apply``.  state: {"h": (B, d)
    f32, "conv": (B, W-1, d)} or None (stateless, zero history).

    gate = gelu_tanh(x w_y); u = x w_x through a causal temporal conv of
    width W over [conv history ; u] (taps summed in JAX's order); gates in
    f32: r, i = sigmoid(x w_a), sigmoid(x w_i), log a = -8 r
    softplus(a_param), beta = sqrt(max(1 - a^2, 1e-6)); h_t = a_t h_{t-1}
    + beta i conv_t in f32 (one step for S == 1, ``rglru_scan`` otherwise);
    y = (h in x's dtype * gate) w_out.

    The new ``h`` (the last step's) and conv history (the last W-1 inputs)
    are written into the caller's state tensors in place (``copy_``), so a
    CUDA graph that captures the step replays the update."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gate = F.gelu((x2 @ p["w_y"]).reshape(b, s, d), approximate="tanh")
    u = (x2 @ p["w_x"]).reshape(b, s, d)
    w = cfg.rglru_conv_width
    hist = state["conv"] if state is not None else \
        torch.zeros((b, w - 1, d), dtype=u.dtype, device=u.device)
    u_pad = torch.cat([hist, u], dim=1)     # a new tensor, not a view
    conv_w = p["conv_w"]
    conv = u_pad[:, 0:s] * conv_w[0]
    for i in range(1, w):
        conv = conv + u_pad[:, i:i + s] * conv_w[i]
    r = torch.sigmoid((x2 @ p["w_a"]).reshape(b, s, d).float())
    i_g = torch.sigmoid((x2 @ p["w_i"]).reshape(b, s, d).float())
    log_a = -8.0 * r * _softplus(p["a_param"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    bx = beta * (i_g * conv.float())
    h0 = state["h"].float() if state is not None else \
        torch.zeros((b, d), dtype=torch.float32, device=x.device)
    h = a * h0[:, None, :] + bx if s == 1 else rglru_scan(a, bx, h0)
    y = (h.to(x.dtype) * gate).reshape(b * s, d) @ p["w_out"]
    new_state = None
    if state is not None:
        state["h"].copy_(h[:, -1])
        if w > 1:
            state["conv"].copy_(u_pad[:, -(w - 1):])
        new_state = state
    return y.reshape(b, s, d), new_state


# ---------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, gen: Optional[torch.Generator], dtype,
               device, out: Optional[Params] = None) -> Params:
    """JAX's ``init_mlstm``, inner = H * Dh: the up projection (d, inner),
    q/k/v (inner, H, Dh), the input and forget gates ``w_if`` (inner, 2H),
    the output gate ``w_o`` (inner, inner) and the down projection
    (inner, d), each at ``dense_init``'s fan-in scale."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = h * hd
    o = out or {}
    shapes = (("w_up", (d, inner)), ("wq", (inner, h, hd)),
              ("wk", (inner, h, hd)), ("wv", (inner, h, hd)),
              ("w_if", (inner, 2 * h)), ("w_o", (inner, inner)),
              ("w_down", (inner, d)))
    return {k: dense_init(gen, shape, dtype, device, out=o.get(k))
            for k, shape in shapes}


def _xlstm_carry(state: Optional[State], keys, shapes, dev):
    """The recurrence's f32 carry: the state's leaves (f32 already: the
    same tensors, updated in place by the caller's ``copy_``), or zeros
    with the stabilizer ``m`` at -1e30 when there is no state."""
    if state is not None:
        return [state[k].float() for k in keys]
    return [torch.full(shape, -1e30 if k == "m" else 0.0,
                       dtype=torch.float32, device=dev)
            for k, shape in zip(keys, shapes)]


def _write_state(state: Optional[State], keys, values) -> Optional[State]:
    if state is None:
        return None
    for k, val in zip(keys, values):
        if val is not state[k]:
            state[k].copy_(val)
    return state


def mlstm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                state: Optional[State], mode: str
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Matrix-memory LSTM with exponential gating, as JAX's
    ``mlstm_apply``.  state: {"C": (B, H, D, D), "n": (B, H, D), "m":
    (B, H)}, all f32, or None (train: zero memory, ``m`` = -1e30).

    u = x w_up; q, k (divided by sqrt(D) in the model dtype) and v from u;
    the gates u w_if in the model dtype, cast to f32: log i = the first
    H, log f = log_sigmoid of the last H (-softplus(-x), as JAX); ogate =
    sigmoid(u w_o) in the model dtype.  The recurrence, JAX's
    ``lax.scan``, is one
    ``xlstm_scan.mlstm_scan`` over the sequence in f32 (a CUDA kernel on
    the card, forward and backward): m_t = max(log f + m, log i), f' =
    exp(log f + m - m_t), i' = exp(log i - m_t), C = f' C + i' v k^T, n =
    f' n + i' k, y_t = C q / max(|n . q|, exp(-m_t)).  y is cast to x's
    dtype before the output gate and the down projection.

    The last step's C, n and m are written into the caller's state tensors
    in place (``copy_``), so a CUDA graph that captures the step replays
    the update; without a state nothing is written."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    u = (x.reshape(b * s, d) @ p["w_up"]).reshape(b, s, -1)
    q = (_proj_in(u, p["wq"]) / math.sqrt(hd)).float()
    k = (_proj_in(u, p["wk"]) / math.sqrt(hd)).float()
    v = _proj_in(u, p["wv"]).float()
    u2 = u.reshape(b * s, -1)
    gates = (u2 @ p["w_if"]).reshape(b, s, 2 * h).float()
    log_i = gates[..., :h]
    # jax.nn.log_sigmoid's own form, -softplus(-x): its backward has a
    # DTensor rule (the dry run's train step), logsigmoid's has none
    log_f = -_softplus(-gates[..., h:])
    ogate = torch.sigmoid(u2 @ p["w_o"]).reshape(b, s, -1)
    keys = ("C", "n", "m")
    carry = _xlstm_carry(state, keys, ((b, h, hd, hd), (b, h, hd), (b, h)),
                         x.device)
    y, *last = xlstm_scan.mlstm_scan(q, k, v, log_i, log_f, *carry)
    y = y.reshape(b, s, h * hd).to(x.dtype)
    y = ((y * ogate.to(x.dtype)).reshape(b * s, -1) @ p["w_down"])
    return y.reshape(b, s, d), _write_state(state, keys, last)


def init_slstm(cfg: ModelConfig, gen: Optional[torch.Generator], dtype,
               device, out: Optional[Params] = None) -> Params:
    """JAX's ``init_slstm``: the input pre-activations ``w_gates`` (d, 4d)
    (z, i, f, o), the recurrent mix ``r_gates`` (d, 4d) at scale 0.1 and
    the output projection ``w_out`` (d, d)."""
    d = cfg.d_model
    o = out or {}
    return {"w_gates": dense_init(gen, (d, 4 * d), dtype, device,
                                  out=o.get("w_gates")),
            "r_gates": dense_init(gen, (d, 4 * d), dtype, device, scale=0.1,
                                  out=o.get("r_gates")),
            "w_out": dense_init(gen, (d, d), dtype, device,
                                out=o.get("w_out"))}


def slstm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                state: Optional[State], mode: str
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Scalar-memory LSTM with exponential gating and hidden recurrent
    mixing, as JAX's ``slstm_apply``.  state: {"c", "n", "m", "h"}, each
    (B, d) f32, or None (zeros, ``m`` = -1e30).

    The input pre-activations x w_gates are cast to f32; the recurrence,
    JAX's ``lax.scan``, is one ``xlstm_scan.slstm_scan`` over the sequence
    (a CUDA kernel per step on the card, forward and backward): each step
    adds h r_gates (``r_gates`` in f32) and splits into z, i, f, o: z =
    tanh, o = sigmoid, log f = log_sigmoid; m_t = max(log f + m, i), f' =
    exp(log f + m - m_t), i' = exp(i - m_t), c = f' c + i' z, n = f' n +
    i', h = o c / max(n, 1).  The h sequence, cast to x's dtype, goes
    through ``w_out``.  The last step's state is written in place."""
    b, s, d = x.shape
    pre_x = (x.reshape(b * s, d) @ p["w_gates"]).reshape(b, s, 4 * d).float()
    r_w = p["r_gates"].float()
    keys = ("c", "n", "m", "h")
    carry = _xlstm_carry(state, keys, ((b, d),) * 4, x.device)
    y, *last = xlstm_scan.slstm_scan(pre_x, r_w, *carry)
    y = y.to(x.dtype).reshape(b * s, d) @ p["w_out"]
    return y.reshape(b, s, d), _write_state(state, keys, last)
