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

This slice runs attention-only stacks (global or sliding-window attention
with a gated MLP); other block kinds, MoE, cross-attention and int8 KV
raise ``NotImplementedError`` (ROADMAP A9, A10).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import device as D
from . import layers as L
from .config import BlockKind, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, Any]

_ATTN_KINDS = (BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    missing = []
    if any(k not in _ATTN_KINDS for k in cfg.blocks()):
        missing.append("recurrent blocks (RG-LRU, mLSTM, sLSTM)")
    if cfg.n_experts > 0:
        missing.append("MoE")
    if cfg.cross_attention:
        missing.append("cross-attention")
    if cfg.kv_quant:
        missing.append("int8 KV")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            "(ROADMAP A9, A10: a later slice of the port)")


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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> Params:
    p: Params = {"norm1": torch.zeros(cfg.d_model, dtype=dtype, device=device),
                 "attn": L.init_attention(cfg, gen, dtype, device)}
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
        p["ffn"] = L.init_mlp(cfg, gen, dtype, device)
    return p


def _stack_into(dst, src, r: int):
    if isinstance(src, dict):
        for k in src:
            _stack_into(dst[k], src[k], r)
    else:
        dst[r].copy_(src)


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device: D.DeviceLike = None) -> Params:
    """Random weights drawn from ``seed`` on ``device`` (default the CUDA
    card), with the scales of the JAX ``init``.  Stacked groups are
    filled one layer at a time, so the peak is one layer's f32 draw."""
    check_supported(cfg)
    dev = D.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
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
    for _ in pat:
        stacked = None
        for r in range(n_rep):
            blk = _init_block(cfg, gen, dtype, dev)
            if stacked is None:
                stacked = _tree_map(
                    lambda a: torch.empty((n_rep,) + tuple(a.shape),
                                          dtype=a.dtype, device=dev), blk)
            _stack_into(stacked, blk, r)
        groups.append(stacked if stacked is not None else {})
    params["groups"] = tuple(groups)
    params["rem"] = tuple(_init_block(cfg, gen, dtype, dev)
                          for _ in range(rem))
    return params


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, kind: BlockKind, max_len: int) -> int:
    window = (cfg.local_window if kind == BlockKind.LOCAL_ATTENTION
              else cfg.sliding_window)
    return min(max_len, window) if window else max_len


def _block_state(cfg: ModelConfig, kind: BlockKind, lead: Tuple[int, ...],
                 length: int, dtype, dev) -> Dict[str, torch.Tensor]:
    shape = lead + (length,)
    return {
        "k": torch.zeros(shape + (cfg.n_kv_heads, cfg.head_dim), dtype=dtype,
                         device=dev),
        "v": torch.zeros(shape + (cfg.n_kv_heads, cfg.head_dim), dtype=dtype,
                         device=dev),
        "pos": torch.full(shape, -1, dtype=torch.int32, device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device: D.DeviceLike = None) -> Cache:
    """Blank dense serving cache: per layer (B, L, KV, D) keys/values and
    (B, L) positions (-1 = empty), stacked per group."""
    check_supported(cfg)
    dev = D.resolve(device)
    pat, n_rep, rem = _group_shapes(cfg)
    return {
        "lengths": torch.zeros(batch, dtype=torch.int32, device=dev),
        "groups": tuple(_block_state(cfg, kind, (n_rep, batch),
                                     _cache_len(cfg, kind, max_len), dtype,
                                     dev) for kind in pat),
        "rem": tuple(_block_state(cfg, pat[i], (batch,),
                                  _cache_len(cfg, pat[i], max_len), dtype,
                                  dev) for i in range(rem)),
    }


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int, dtype=torch.float32,
                     device: D.DeviceLike = None) -> Cache:
    """Blank serving cache in the paged block-pool layout: attention caches
    as long as the page space become pools (1 + batch * nb pages of
    ``block_size``; page 0 is the reserved scratch page), all block tables
    empty (-1).  Shorter (windowed) caches stay per-row."""
    check_supported(cfg)
    dev = D.resolve(device)
    pat, n_rep, rem = _group_shapes(cfg)
    plen = max(_cache_len(cfg, kind, max_len) for kind in pat)
    if plen % block_size:
        raise ValueError(f"stack not pageable at block_size {block_size} "
                         f"(page length {plen})")
    nb = plen // block_size
    n_phys = 1 + batch * nb

    def build(kind: BlockKind, lead: Tuple[int, ...]):
        clen = _cache_len(cfg, kind, max_len)
        if clen == plen:
            return _block_state(cfg, kind, lead + (n_phys,), block_size,
                                dtype, dev)
        return _block_state(cfg, kind, lead + (batch,), clen, dtype, dev)

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

def _apply_block(cfg: ModelConfig, kind: BlockKind, p: Params,
                 x: torch.Tensor, *, positions, state, mode,
                 prefix_aware: bool, block_tables,
                 paged_kernel: bool) -> torch.Tensor:
    window = (cfg.local_window if kind == BlockKind.LOCAL_ATTENTION
              else cfg.sliding_window)
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    y, _ = L.attention_apply(cfg, p["attn"], h, positions=positions,
                             state=state, mode=mode, window=window,
                             prefix_aware=prefix_aware,
                             block_tables=block_tables,
                             paged_kernel=paged_kernel)
    x = x + y
    if cfg.d_ff > 0:
        x = x + L.mlp_apply(cfg, p["ffn"],
                            L.rms_norm(x, p["norm2"], cfg.rms_eps))
    return x


@torch.no_grad()
def apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
          cache: Optional[Cache] = None,
          mode: str = "train",
          prefix_aware: bool = False,
          logits_slice: str = "all",
          logits_at: Optional[torch.Tensor] = None,
          paged_kernel: bool = False,
          ) -> Tuple[torch.Tensor, Optional[Cache], Dict[str, Any]]:
    """Run the stack.

    tokens: (B, S) int.  mode: train | prefill | decode.
    logits_slice: "all" -> (B, S, V); "last" -> (B, V), read at each row's
    ``logits_at`` (B,) index when given.  A cache carrying "block_tables"
    is a paged block-pool cache: decode writes the new token into its page
    and attends over the pages (``paged_kernel=True``: kernel B1; False:
    gather-then-attend, the A/B reference); prefill on it is the
    incremental resume (``prefix_aware=True``; kernels B3 + B2).  Fresh
    prefill over a dense cache runs kernel B2.  ``mode="train"`` without a
    cache is the plain stateless forward.
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
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    if cache is not None:
        positions = cache["lengths"][:, None] + ar[None, :]
    else:
        positions = ar[None, :].expand(b, s)
    x = params["embed"][tokens]

    def block(kind, p, st, x):
        return _apply_block(cfg, kind, p, x, positions=positions, state=st,
                            mode=mode, prefix_aware=prefix_aware,
                            block_tables=block_tables,
                            paged_kernel=paged_kernel)

    for r in range(n_rep):
        for g, kind in enumerate(pat):
            st = _layer(cache["groups"][g], r) if cache is not None else None
            x = block(kind, _layer(params["groups"][g], r), st, x)
    for i in range(rem):
        st = cache["rem"][i] if cache is not None else None
        x = block(pat[i], params["rem"][i], st, x)

    x = L.rms_norm(x, params["out_norm"], cfg.rms_eps)
    if logits_slice == "last":
        x = x[:, -1] if logits_at is None else \
            x[torch.arange(b, device=dev), logits_at.to(dev).long()]
    unembed = params["embed"].t() if cfg.tie_embeddings \
        else params["unembed"]
    logits = x @ unembed

    new_cache = None
    if cache is not None:
        new_cache = {"lengths": cache["lengths"] + s,
                     "groups": cache["groups"], "rem": cache["rem"]}
        if block_tables is not None:
            new_cache["block_tables"] = block_tables
    return logits, new_cache, {}
