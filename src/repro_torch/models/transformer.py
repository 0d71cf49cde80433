"""Transformer stacks of the port: init / train / prefill / decode.

Same layouts as the JAX package's ``models/transformer.py``, so states and
weights compare leaf for leaf: the layer stack is grouped by the config's
``block_pattern`` into ``groups`` (one stacked tree per pattern position,
leading axis ``n_rep``) plus unstacked remainder layers ``rem``.  Where JAX
scans over repeats, the port loops over them and indexes each layer's
weights and cache as views of the stacked tensors.

Caches are updated in place: ``apply`` writes the caller's cache tensors
and returns a cache dict over the same tensors with advanced lengths.

Public API
----------
    params             = init(cfg, seed, dtype, device)
    cache              = init_cache(cfg, batch, max_len, dtype, device)
    pcache             = init_paged_cache(cfg, batch, max_len, block_size,
                                          dtype, device)
    logits, cache, aux = apply(cfg, params, tokens, cache=..., mode=...)
    logits, aux        = forward_train(cfg, params, tokens, remat=...)
    logits, cache, aux = prefill(cfg, params, tokens, cache)
    logits, cache, aux = decode_step(cfg, params, token, cache)

Parameters may be int8 (``models/quant.py`` ``quantize_weights``: a matrix
leaf becomes ``{"q", "s"}``); ``apply`` dequantizes each layer's leaves
inside the layer loop and the embedding and unembedding where it reads
them, as JAX does, so nothing else sees a quantized leaf.

The port runs attention stacks (global, sliding-window or local attention
with a gated MLP or a top-k MoE), with bf16/f32 or int8 KV caches
(``kv_quant``: int8 ``k``/``v`` leaves plus f32 ``k_scale``/``v_scale``
leaves), and the hybrid stacks of RG-LRU blocks and local attention
(RecurrentGemma: each RG-LRU layer's state ``{"h": (B, d) f32, "conv":
(B, W-1, d)}``, and the embedding scaled by sqrt(d_model) as JAX scales
the hybrid family's), the xLSTM stacks (mLSTM and sLSTM blocks with no
FFN; states ``{"C", "n", "m"}`` and ``{"c", "n", "m", "h"}``, all f32,
the stabilizer ``m`` starting at -1e30) and attention with cross
attention over encoder frames (seamless-m4t: ``frames`` (B, n_frames,
d_model) to ``apply``; each attention layer's state carries a slot-dense
``"cross": {"k", "v"}`` (B, n_frames, KV, D) in the model dtype, int8 KV
or not): every block kind of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from .. import device as D
from . import layers as L
from . import quant as Q
from .config import BlockKind, Family, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, Any]

_ATTN_KINDS = (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION)
_XLSTM_KINDS = (BlockKind.MLSTM, BlockKind.SLSTM)
_PORTED_KINDS = _ATTN_KINDS + (BlockKind.RGLRU,) + _XLSTM_KINDS


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind the port does not
    run; every kind of the JAX package (and so every registry config) is
    ported."""
    missing = sorted({k.value for k in cfg.blocks()
                      if k not in _PORTED_KINDS})
    if missing:
        raise NotImplementedError(f"{cfg.name}: block kinds {missing} are "
                                  "not ported")


def _group_shapes(cfg: ModelConfig):
    """(pattern, n_repeats, n_remainder)."""
    pat = cfg.block_pattern
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _layer(tree, r: int):
    """Layer ``r``'s views into a stacked group tree."""
    return _tree_map(lambda a: a[r], tree)


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` layers' views into a stacked group tree (of dicts), from
    one ``unbind`` per leaf: a backward then stacks each leaf's gradient
    once from its layers', where indexing layer by layer (``_layer``)
    would add a zero-filled full-size gradient per layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][r] for k in tree} for r in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: BlockKind,
                gen: Optional[torch.Generator], dtype, device,
                out: Optional[Params] = None) -> Params:
    """One layer's weights; with ``out`` (its views into the stacked
    group) every leaf is drawn and cast straight into its slot."""
    o = out or {}

    def zeros(key):
        return o[key].zero_() if key in o else torch.zeros(
            cfg.d_model, dtype=dtype, device=device)

    p: Params = {"norm1": zeros("norm1")}
    if kind in _XLSTM_KINDS:
        # an xLSTM block carries its own up/down projections: no FFN, as
        # JAX's, whatever d_ff
        init_rec = L.init_mlstm if kind == BlockKind.MLSTM else L.init_slstm
        p["rec"] = init_rec(cfg, gen, dtype, device, out=o.get("rec"))
        return p
    if kind == BlockKind.RGLRU:
        p["rec"] = L.init_rglru(cfg, gen, dtype, device, out=o.get("rec"))
    else:
        p["attn"] = L.init_attention(cfg, gen, dtype, device,
                                     out=o.get("attn"))
        if cfg.cross_attention:
            # JAX initialises cross_norm and never reads it; kept so the
            # trees match leaf for leaf
            p["cross"] = L.init_attention(cfg, gen, dtype, device,
                                          out=o.get("cross"))
            p["cross_norm"] = zeros("cross_norm")
    if cfg.d_ff > 0:
        p["norm2"] = zeros("norm2")
        # JAX's RG-LRU block takes a gated MLP whatever n_experts
        init_ffn = L.init_moe if (cfg.n_experts > 0
                                  and kind != BlockKind.RGLRU) else L.init_mlp
        p["ffn"] = init_ffn(cfg, gen, dtype, device, out=o.get("ffn"))
    return p


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device: D.DeviceLike = None) -> Params:
    """Random weights drawn from ``seed`` on ``device`` (default the CUDA
    card), with the scales of the JAX ``init`` (the MoE router in f32);
    on ``meta`` only the tree's shapes and dtypes.
    Stacked groups are allocated at once and filled leaf by leaf, so the
    peak beyond the weights is one leaf's f32 draw."""
    check_supported(cfg)
    dev = D.resolve(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    pat, n_rep, rem = _group_shapes(cfg)
    params: Params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, dev,
                              scale=0.02),
        "out_norm": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype, dev, scale=0.02)
    groups = []
    for kind in pat:
        if not n_rep:
            groups.append({})
            continue
        shapes = _init_block(cfg, kind, None, dtype, torch.device("meta"))
        stacked = _tree_map(lambda a: torch.empty(
            (n_rep,) + tuple(a.shape), dtype=a.dtype, device=dev), shapes)
        if dev.type != "meta":
            for r in range(n_rep):
                _init_block(cfg, kind, gen, dtype, dev,
                            out=_layer(stacked, r))
        groups.append(stacked)
    params["groups"] = tuple(groups)
    params["rem"] = tuple(_init_block(cfg, pat[i], gen, dtype, dev)
                          for i in range(rem))
    return params


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, kind: BlockKind, max_len: int) -> int:
    """An attention layer's cache length: its window's ring when the
    window is shorter than ``max_len``."""
    window = (cfg.local_window if kind == BlockKind.LOCAL_ATTENTION
              else cfg.sliding_window)
    return min(max_len, window) if window else max_len


def attn_cache_lens(cfg: ModelConfig, max_len: int) -> List[int]:
    """The attention cache lengths of the stack's block kinds (JAX's
    ``_attn_cache_lens``); empty for a stack without attention."""
    return [_cache_len(cfg, kind, max_len) for kind in set(cfg.blocks())
            if kind in _ATTN_KINDS]


def _attn_state(cfg: ModelConfig, lead: Tuple[int, ...], length: int,
                dtype, dev) -> Dict[str, torch.Tensor]:
    """One attention cache: (lead..., length, KV, D) keys/values of
    ``dtype`` (int8 with ``kv_quant``, plus (lead..., length, KV) f32
    scales) and (lead..., length) positions, -1 = empty.  The cross cache
    is ``_cross_state``'s."""
    shape = lead + (length,)
    kv_dtype = torch.int8 if cfg.kv_quant else dtype
    st = {
        "k": torch.zeros(shape + (cfg.n_kv_heads, cfg.head_dim),
                         dtype=kv_dtype, device=dev),
        "v": torch.zeros(shape + (cfg.n_kv_heads, cfg.head_dim),
                         dtype=kv_dtype, device=dev),
        "pos": torch.full(shape, -1, dtype=torch.int32, device=dev),
    }
    if cfg.kv_quant:
        for key in ("k_scale", "v_scale"):
            st[key] = torch.zeros(shape + (cfg.n_kv_heads,),
                                  dtype=torch.float32, device=dev)
    return st


def _cross_state(cfg: ModelConfig, lead: Tuple[int, ...], dtype,
                 dev) -> Dict[str, torch.Tensor]:
    """A cross-attention layer's slot-dense cache, as JAX's: keys and
    values (lead..., n_frames, KV, D) in the model dtype (never int8),
    zero."""
    shape = lead + (cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _xlstm_state(cfg: ModelConfig, kind: BlockKind, lead: Tuple[int, ...],
                 dev) -> Dict[str, torch.Tensor]:
    """An xLSTM layer's state, as JAX's ``_block_state``, all f32 whatever
    the model dtype: mLSTM ``C`` (lead..., H, D, D), ``n`` (lead..., H,
    D), ``m`` (lead..., H); sLSTM ``c``, ``n``, ``m``, ``h`` (lead...,
    d).  Zeros, but the stabilizer ``m`` = -1e30: a fresh row's first
    step must see no memory (a zero ``m`` would change the scale of
    ``exp(-m)`` and of the sLSTM's ``max(n, 1)``)."""
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    shapes = ({"C": (h, hd, hd), "n": (h, hd), "m": (h,)}
              if kind == BlockKind.MLSTM else
              {"c": (d,), "n": (d,), "m": (d,), "h": (d,)})
    return {k: torch.full(lead + shape, -1e30 if k == "m" else 0.0,
                          dtype=torch.float32, device=dev)
            for k, shape in shapes.items()}


def _rec_state(cfg: ModelConfig, lead: Tuple[int, ...], dtype,
               dev) -> Dict[str, torch.Tensor]:
    """One RG-LRU layer's state, as JAX's ``_block_state``: ``h``
    (lead..., d) in f32 and the conv history (lead..., W-1, d) in the
    model dtype, zero."""
    return {"h": torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros(lead + (cfg.rglru_conv_width - 1,
                                        cfg.d_model), dtype=dtype,
                                device=dev)}


def _block_state(cfg: ModelConfig, kind: BlockKind, lead: Tuple[int, ...],
                 max_len: int, dtype, dev) -> Dict[str, torch.Tensor]:
    """A dense layer state with leading dims ``lead`` (.., batch)."""
    if kind == BlockKind.RGLRU:
        return _rec_state(cfg, lead, dtype, dev)
    if kind in _XLSTM_KINDS:
        return _xlstm_state(cfg, kind, lead, dev)
    st = _attn_state(cfg, lead, _cache_len(cfg, kind, max_len), dtype, dev)
    if cfg.cross_attention:
        st["cross"] = _cross_state(cfg, lead, dtype, dev)
    return st


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device: D.DeviceLike = None) -> Cache:
    """Blank dense serving cache: per attention layer (B, L, KV, D)
    keys/values and (B, L) positions (-1 = empty), L = ``max_len`` or the
    window's ring, with ``kv_quant`` int8 keys/values and (B, L, KV) f32
    scales, and with cross attention its (B, n_frames, KV, D) cross cache;
    per recurrent layer its blank state; stacked per group."""
    check_supported(cfg)
    dev = D.resolve(device)
    pat, n_rep, rem = _group_shapes(cfg)
    return {
        "lengths": torch.zeros(batch, dtype=torch.int32, device=dev),
        "groups": tuple(_block_state(cfg, kind, (n_rep, batch), max_len,
                                     dtype, dev) for kind in pat),
        "rem": tuple(_block_state(cfg, pat[i], (batch,), max_len, dtype,
                                  dev) for i in range(rem)),
    }


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int, dtype=torch.float32,
                     device: D.DeviceLike = None) -> Cache:
    """Blank serving cache in the paged block-pool layout: attention caches
    as long as the page space (the longest attention cache: a window's
    ring when every attention layer is windowed) become pools (1 + batch
    * nb pages of ``block_size``; page 0 is the reserved scratch page),
    all block tables empty (-1).  Shorter rings, recurrent states and
    cross caches stay per-row (slot-dense).  With ``kv_quant`` the K/V
    pools are int8 and the scale pools (.., n_pages, block_size, KV) f32,
    all zero."""
    check_supported(cfg)
    dev = D.resolve(device)
    pat, n_rep, rem = _group_shapes(cfg)
    plen = max(attn_cache_lens(cfg, max_len), default=0)
    if not plen or plen % block_size:
        raise ValueError(f"stack not pageable at block_size {block_size} "
                         f"(page length {plen})")
    nb = plen // block_size
    n_phys = 1 + batch * nb

    def build(kind: BlockKind, lead: Tuple[int, ...]):
        if kind in _ATTN_KINDS and _cache_len(cfg, kind, max_len) == plen:
            st = _attn_state(cfg, lead + (n_phys,), block_size, dtype, dev)
            if cfg.cross_attention:
                st["cross"] = _cross_state(cfg, lead + (batch,), dtype, dev)
            return st
        return _block_state(cfg, kind, lead + (batch,), max_len, dtype, dev)

    return {
        "lengths": torch.zeros(batch, dtype=torch.int32, device=dev),
        "block_tables": torch.full((batch, nb), -1, dtype=torch.int32,
                                   device=dev),
        "groups": tuple(build(kind, (n_rep,)) for kind in pat),
        "rem": tuple(build(pat[i], ()) for i in range(rem)),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _recompute_in_modes():
    """``torch.utils.checkpoint``'s ``context_fn``: the backward's
    recompute runs under the torch-function modes that the forward ran
    under (the dry run's ``cost_analysis.EvenViews``), which the autograd
    engine does not carry into it."""
    modes = torch.overrides._get_current_function_mode_stack()

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode)
            yield

    return contextlib.nullcontext(), recompute()


def _apply_block(cfg: ModelConfig, kind: BlockKind, p: Params,
                 x: torch.Tensor, *, positions, state, mode,
                 prefix_aware: bool, block_tables, paged_kernel: bool,
                 moe_impl: str = "sorted", moe_cf=None, head_offload: int = 0,
                 frames: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, router_load); the load is None for a block without
    experts (JAX returns zeros there, which add nothing).  The layer's
    int8 leaves are dequantized to x's dtype first (a no-op for
    unquantized weights).  An xLSTM block returns x + its output, with no
    FFN, as JAX's."""
    p = Q.dequant_tree(p, x.dtype)
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    if kind in _XLSTM_KINDS:
        rec_apply = L.mlstm_apply if kind == BlockKind.MLSTM \
            else L.slstm_apply
        y, _ = rec_apply(cfg, p["rec"], h, state=state, mode=mode)
        return x + y, None
    if kind == BlockKind.RGLRU:
        y, _ = L.rglru_apply(cfg, p["rec"], h, state=state, mode=mode)
    else:
        window = (cfg.local_window if kind == BlockKind.LOCAL_ATTENTION
                  else cfg.sliding_window)
        y, _ = L.attention_apply(cfg, p["attn"], h, positions=positions,
                                 state=state, mode=mode, window=window,
                                 prefix_aware=prefix_aware,
                                 block_tables=block_tables,
                                 paged_kernel=paged_kernel,
                                 head_offload=head_offload, frames=frames,
                                 cross_p=p.get("cross"),
                                 cross_state=(state.get("cross")
                                              if state is not None
                                              else None))
    x = x + y
    load = None
    if cfg.d_ff > 0:
        h2 = L.rms_norm(x, p["norm2"], cfg.rms_eps)
        if cfg.n_experts > 0 and kind != BlockKind.RGLRU:
            y2, load = L.moe_apply(cfg, p["ffn"], h2, impl=moe_impl,
                                   capacity_factor=moe_cf)
        else:
            y2 = L.mlp_apply(cfg, p["ffn"], h2)
        x = x + y2
    return x, load


def _graph_in_train_only(fn):
    """Prefill and decode never build an autograd graph, whatever the
    caller's grad mode and whether the leaves require grad: CUDA-graph
    capture (``serving/engine.py`` ``CompiledStep``) and the span views
    rely on it.  Train mode follows the caller's grad mode."""
    @functools.wraps(fn)
    def wrapped(*args, mode: str = "train", **kw):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and mode == "train"):
            return fn(*args, mode=mode, **kw)
    return wrapped


@_graph_in_train_only
def apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
          cache: Optional[Cache] = None,
          frames: Optional[torch.Tensor] = None,
          mode: str = "train",
          moe_impl: str = "sorted",
          moe_cf=None,
          prefix_aware: bool = False,
          logits_slice: str = "all",
          logits_at: Optional[torch.Tensor] = None,
          paged_kernel: bool = False,
          hidden_in: bool = False,
          hidden_out: bool = False,
          head_offload: int = 0,
          remat: bool = False,
          param_hook: Optional[Callable[[Params], Params]] = None,
          ) -> Tuple[torch.Tensor, Optional[Cache], Dict[str, Any]]:
    """Run the stack.

    tokens: (B, S) int.  mode: train | prefill | decode.
    logits_slice: "all" -> (B, S, V); "last" -> (B, V), read at each row's
    ``logits_at`` (B,) index when given.  A cache carrying "block_tables"
    is a paged block-pool cache: decode writes the S new tokens into their
    pages and attends over the pages (``paged_kernel=True``: kernel B1 for
    S == 1, kernel B4 for the S > 1 speculative verify step, their int8
    variants on an int8 cache; False: gather-then-attend, the A/B
    reference); prefill on it is the incremental resume
    (``prefix_aware=True``; kernels B3 + B2; not for an int8 cache).  Fresh
    prefill over a dense cache runs kernel B2; one-token decode over a
    dense bf16/f32 cache (dense-row engines, the draft model) kernel B5,
    and plain attention otherwise (``layers.attention_apply`` says when).
    Decode positions are ``lengths + arange(S)`` and the returned lengths
    advance by S.
    ``head_offload=n`` runs a one-token decode over a dense bf16/f32 cache
    as Fig. 4's hot/cold split, the last n kv heads a separate branch
    (``layers._decode_head_offload``: kernel B5 per branch); ignored on an
    int8 cache and outside decode, as in JAX; a paged cache, or n outside
    0..n_kv_heads, raises ``ValueError`` before any work.
    ``mode="train"`` without a cache is the plain stateless forward; it
    builds an autograd graph when the caller has grad enabled (prefill and
    decode never do).  ``remat`` (train mode with grad, as JAX's
    ``jax.checkpoint`` of the layer scan) runs each stacked layer's block
    under ``torch.utils.checkpoint``, so the backward recomputes its
    activations (the remainder layers ``rem`` are not rematerialized, as
    in JAX); the recompute is exact (MoE's sorted dispatch is
    deterministic).

    ``param_hook`` (JAX's) maps each layer's parameters (a stacked
    layer's and each remainder layer's) before its block runs: the dry
    run's steps (``launch/steps.py``) gather FSDP-split weights there, or
    the int8 payloads alone, so such a gather moves int8 bytes.

    A cross-attention stack takes ``frames`` (B, n_frames, d_model), the
    encoder output every attention layer attends to, in every mode but
    decode, which reads the cross K/V its prefill wrote into the cache
    (``layers._cross_attention``).

    Partial-stack (layer-span) execution, as in JAX: ``hidden_in=True``
    takes ``tokens`` as the (B, S, d_model) residual stream of the
    previous span and skips the embedding; ``hidden_out=True`` returns the
    residual stream before ``out_norm`` and the unembedding (the logits
    slice is then ignored).  Spans that partition the stack, chained,
    run the monolithic forward op for op.

    MoE blocks route with ``moe_impl`` ("sorted" or "dense";
    ``moe_cf`` the sorted dispatch's capacity factor, None = no drop).
    ``aux["router_load"]`` is the per-expert load summed over the layers
    and divided by ``n_layers``, as JAX returns it (zeros of shape (1,)
    for a stack without experts).
    """
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    pat, n_rep, rem = _group_shapes(cfg)
    b, s = tokens.shape[:2]
    dev = tokens.device
    block_tables = None
    if cache is not None and "block_tables" in cache:
        if mode == "train" or (mode == "prefill" and not prefix_aware):
            raise ValueError("paged caches serve decode and the incremental "
                             "(prefix-aware) prefill")
        block_tables = cache["block_tables"]
    if head_offload and block_tables is not None:
        raise ValueError("head offload and paged caches are not combined "
                         "(as in the JAX package)")
    if not 0 <= head_offload <= cfg.n_kv_heads:
        raise ValueError(f"head_offload must be in 0..{cfg.n_kv_heads} kv "
                         f"heads, got {head_offload}")
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    if cache is not None:
        positions = cache["lengths"][:, None] + ar[None, :]
    else:
        positions = ar[None, :].expand(b, s)
    dtype = params["out_norm"].dtype           # norms are never quantized
    emb = params["embed"]
    if hidden_in:
        x = tokens.to(dtype)
    elif Q.is_quantized(emb):
        # the rows a step reads, dequantized: JAX's values, row for row
        x = Q.dequant({"q": L.embed_rows(emb["q"], tokens), "s": emb["s"]},
                      dtype)
    else:
        x = L.embed_rows(emb, tokens)
    if not hidden_in and cfg.family == Family.HYBRID:
        # RecurrentGemma scales the embedding by sqrt(d_model) rounded to
        # the model dtype, as JAX does for the hybrid family (a host
        # scalar: a captured step copies nothing from the host)
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))

    loads = []

    def block(kind, p, st, x, ckpt=False):
        run = functools.partial(
            _apply_block, cfg, kind, positions=positions, state=st,
            mode=mode, prefix_aware=prefix_aware, block_tables=block_tables,
            paged_kernel=paged_kernel, moe_impl=moe_impl, moe_cf=moe_cf,
            head_offload=head_offload, frames=frames)
        x, rl = (torch.utils.checkpoint.checkpoint(
            run, p, x, use_reentrant=False, context_fn=_recompute_in_modes)
                 if ckpt else run(p, x))
        if rl is not None:
            loads.append(rl)
        return x

    ckpt = remat and mode == "train" and torch.is_grad_enabled()
    layers = [_unstack(gp, n_rep) for gp in params["groups"]]
    hook = param_hook if param_hook is not None else (lambda lp: lp)
    for r in range(n_rep):
        for g, kind in enumerate(pat):
            st = _layer(cache["groups"][g], r) if cache is not None else None
            x = block(kind, hook(layers[g][r]), st, x, ckpt)
    for i in range(rem):
        st = cache["rem"][i] if cache is not None else None
        x = block(pat[i], hook(params["rem"][i]), st, x)

    if hidden_out:
        logits = x                  # the residual stream for the next span
    else:
        x = L.rms_norm(x, params["out_norm"], cfg.rms_eps)
        if logits_slice == "last":
            x = x[:, -1] if logits_at is None else \
                x[torch.arange(b, device=dev), logits_at.to(dev).long()]
        unembed = Q.dequant(params["embed"], dtype).t() \
            if cfg.tie_embeddings else Q.dequant(params["unembed"], dtype)
        logits = x @ L.vocab_parallel(unembed)

    new_cache = None
    if cache is not None:
        new_cache = {"lengths": cache["lengths"] + s,
                     "groups": cache["groups"], "rem": cache["rem"]}
        if block_tables is not None:
            new_cache["block_tables"] = block_tables
    load = sum(loads) if loads else torch.zeros(1, device=dev)
    return logits, new_cache, {"router_load": load / max(cfg.n_layers, 1)}


# Convenience entry points, as JAX's ----------------------------------------

def forward_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  frames: Optional[torch.Tensor] = None,
                  moe_impl: str = "sorted", moe_cf=None,
                  remat: bool = False, param_hook=None):
    """The stateless forward: (logits (B, S, V), aux); differentiable
    under the caller's grad mode (``training/train_step.py``)."""
    logits, _, aux = apply(cfg, params, tokens, frames=frames, mode="train",
                           moe_impl=moe_impl, moe_cf=moe_cf, remat=remat,
                           param_hook=param_hook)
    return logits, aux


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Cache, frames: Optional[torch.Tensor] = None,
            moe_impl: str = "sorted", prefix_aware: bool = False):
    """Prefill ``tokens`` into ``cache``: (last-token logits (B, V), cache,
    aux)."""
    return apply(cfg, params, tokens, cache=cache, frames=frames,
                 mode="prefill", moe_impl=moe_impl, logits_slice="last",
                 prefix_aware=prefix_aware)


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: Cache, frames: Optional[torch.Tensor] = None,
                moe_impl: str = "sorted"):
    """One decode step of ``token`` (B, 1): (logits (B, V), cache, aux).
    ``frames`` is taken for JAX's signature; decode reads the cross K/V
    from the cache."""
    return apply(cfg, params, token, cache=cache, frames=frames,
                 mode="decode", moe_impl=moe_impl, logits_slice="last")
