"""The step functions the dry run measures (the JAX package's
``launch/steps.py``).

``build(cfg, shape, mesh)`` returns a ``Step``: the step function, its
example arguments as ``DTensor``s placed by the sharding policy
(``sharding.placements(tree_specs(...))``), the placements of its outputs
and the arguments it updates in place (JAX's donated arguments).  The
arguments' local shards are ``meta`` tensors by default, so nothing is
allocated; ``materialize`` gives real ones (the tests and the smoke's
one-rank check run the same step on values).

JAX's knobs and rules are kept: ``MOE_CF``, ``TRAIN_MICROBATCHES``,
``arch_for_shape``, ``with_kv_quant``, ``fsdp_weights`` for training
unless the model is small enough to replicate, ``ValueError`` for int8
weights in training, the train / fresh-prefill (last-token logits) /
decode steps and the cross-attention frames.  Where JAX's ``param_hook``
constrains each int8 ``q`` leaf to its no-FSDP spec before
dequantization, the port redistributes the int8 payload to the no-FSDP
placements (``T.apply(param_hook=...)``), so the FSDP gather moves int8
bytes.  Where JAX states out_shardings, the step function redistributes
its logits itself: replicated, or with ``shard_logits`` split along the
vocabulary.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models import quant as Q
from ..models import transformer as T
from ..models.config import ModelConfig
from ..training import optimizer as O
from ..training.train_step import make_train_step
from ..training.tree import map_named
from . import specs as S
from .mesh import axis_names, axis_sizes
from .sharding import ShardingPolicy, placements

# MoE capacity factor for production steps (token-dropping, bounded
# buffers); the tests use None (no-drop exact mode).
MOE_CF = 1.25
# Gradient-accumulation microbatches for train_4k: bounds activation
# memory at global_batch=256, seq=4096.
TRAIN_MICROBATCHES = 8


@dataclasses.dataclass
class Step:
    """``fn(*args)`` runs the step; ``out_placements`` holds the outputs'
    placements (trees of placement lists, as the outputs are laid out;
    None for a plain output); ``donate`` the argument indices the step
    updates in place (JAX's donate_argnums); ``cfg`` the config the step
    runs (after ``arch_for_shape`` and the knobs)."""
    fn: Callable
    args: tuple
    out_placements: Any
    donate: Tuple[int, ...]
    cfg: ModelConfig


def local_spec(shape: Tuple[int, ...], spec, mesh
               ) -> Tuple[Tuple[int, ...], list]:
    """(the local shape on this rank, the placements) of a global
    ``shape`` under ``spec``.  A mesh dim of size 1 replicates: its one
    rank holds the whole either way, and ``DTensor`` refuses views that
    merge a dim split over it."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = [Replicate() if mesh.size(i) == 1 else p
          for i, p in enumerate(placements(spec, mesh))]
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    return tuple(local), pl


def distribute(tree, spec_fn: Callable, mesh,
               materialize: Optional[Callable] = None):
    """Each leaf of ``tree`` (global shapes) as a ``DTensor`` over
    ``mesh`` under ``spec_fn(name, leaf)``.  Without ``materialize`` the
    local shards are ``meta`` tensors of the local shape; with it,
    ``materialize(name, leaf)`` gives the global values (the same on
    every rank), of which each rank keeps its block."""
    def one(name, leaf):
        local_shape, pl = local_spec(leaf.shape, spec_fn(name, leaf), mesh)
        if materialize is None:
            local = torch.empty(local_shape, dtype=leaf.dtype, device="meta")
        else:
            # this rank's block of the global values (DTensor's own
            # offsets), copied unless it is the whole: nothing is copied on
            # a one-rank mesh, and no collective scatters the values
            full = materialize(name, leaf)
            local = full[tuple(slice(o, o + n) for o, n in zip(
                _offset(leaf.shape, mesh, pl), local_shape))]
            if local.numel() != full.numel() or not local.is_contiguous():
                local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=leaf.shape,
                                  stride=_contiguous(leaf.shape))
    return map_named(one, tree)


def _offset(shape, mesh, pl) -> Tuple[int, ...]:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                       pl)[1])


def _contiguous(shape) -> Tuple[int, ...]:
    st, acc = [], 1
    for d in reversed(tuple(shape)):
        st.append(acc)
        acc *= d
    return tuple(reversed(st))


def build(cfg: ModelConfig, shape: S.ShapeSpec, mesh,
          dtype=torch.bfloat16, *,
          kv_quant: bool = False,
          weight_quant: bool = False,
          moe_impl: str = "sorted",
          moe_cf=MOE_CF,
          shard_logits: bool = False,
          materialize: Optional[Callable] = None,
          replicate: Optional[bool] = None,
          ) -> Step:
    """Knobs beyond the baseline (the hillclimb's):
    kv_quant      int8 KV cache with per-(token, head) scales
    weight_quant  int8 weights (serving only)
    moe_impl      "sorted" (active-FLOPs dispatch) | "dense" (all experts)
    moe_cf        MoE capacity factor (None = no-drop)
    shard_logits  leave serve-step logits vocab-sharded (skip the gather)

    ``replicate`` fixes whether the weights replicate (None: the model is
    small enough, ``cfg.replicate_small()``); a depth-cut step passes the
    full model's answer, so it is placed as the full model is."""
    cfg = S.arch_for_shape(cfg, shape)
    if kv_quant:
        cfg = cfg.with_kv_quant()
    if weight_quant and shape.kind == "train":
        raise ValueError("int8 weights are a serving-only optimization")
    small = cfg.replicate_small() if replicate is None else replicate
    if shape.kind == "train" and not small:
        # training always shards weights/grads/optimizer 2D (ZeRO-3 style):
        # the f32 Adam state is 4x the bf16 weights
        cfg = dataclasses.replace(cfg, fsdp_weights=True)
    policy = ShardingPolicy(mesh, cfg, seq_shard=(shape.name == "long_500k"),
                            replicate=small)
    ins = S.input_specs(cfg, shape, dtype)
    params = S.param_shapes(cfg, dtype)
    if weight_quant:
        params = Q.quantize_weights(params)
    # a train or prefill step gathers each layer's FSDP-split weights
    # before its block (ZeRO-3: the activations outweigh a layer's
    # weights); a decode step leaves the choice to DTensor, which moves the
    # one-token activations instead, and with int8 weights gathers the
    # int8 payloads (JAX's param_hook)
    hook = None
    if shape.kind != "decode" and cfg.fsdp_weights and not small:
        hook = _gather_hook(cfg, policy, mesh, lambda name: True)
    elif weight_quant:
        hook = _gather_hook(cfg, policy, mesh,
                            lambda name: name.endswith("/q"))

    def p_spec(name, leaf):
        return policy.param_spec(name, tuple(leaf.shape))

    p_dt = distribute(params, p_spec, mesh, materialize)
    rep = [Replicate()] * len(axis_names(mesh))

    def fixed(spec):
        return lambda name, leaf: spec

    if shape.kind == "train":
        f32 = map_named(lambda _, a: torch.empty(a.shape, dtype=torch.float32,
                                                 device="meta"), params)
        zeros = _zeros(materialize)
        opt = {"mu": distribute(f32, p_spec, mesh, zeros),
               "nu": distribute(f32, p_spec, mesh, zeros),
               "step": distribute(torch.empty((), dtype=torch.int32,
                                              device="meta"),
                                  fixed(()), mesh, zeros)}
        step = make_train_step(cfg, O.AdamWConfig(), moe_impl=moe_impl,
                               moe_cf=moe_cf, remat=True,
                               num_microbatches=TRAIN_MICROBATCHES,
                               param_hook=hook)
        batch = {"tokens": distribute(
            ins["batch"]["tokens"],
            fixed(policy.tokens_spec(shape.global_batch)), mesh,
            materialize)}
        if cfg.cross_attention:
            batch["frames"] = distribute(
                ins["batch"]["frames"],
                fixed(policy.frames_spec(shape.global_batch)), mesh,
                materialize)
        # params and state keep their placements; the metrics replicate
        return Step(step, (p_dt, opt, batch),
                    (placements_of(p_dt), placements_of(opt), rep), (0, 1),
                    cfg)

    c_dt = distribute(ins["cache"],
                      lambda n, a: policy.cache_spec(n, tuple(a.shape)),
                      mesh, materialize)
    tokens = distribute(ins["tokens"],
                        fixed(policy.tokens_spec(shape.global_batch)), mesh,
                        materialize)
    logits_pl = rep
    if shard_logits and cfg.vocab_size % axis_sizes(mesh)["model"] == 0:
        logits_pl = placements((None, "model"), mesh)
    mode = "prefill" if shape.kind == "prefill" else "decode"

    def fn(params, tokens, cache, frames=None):
        logits, new_cache, _ = T.apply(
            cfg, params, tokens, cache=cache, frames=frames, mode=mode,
            moe_impl=moe_impl, moe_cf=moe_cf, logits_slice="last",
            param_hook=hook)
        return logits.redistribute(mesh, logits_pl), new_cache

    args = [p_dt, tokens, c_dt]
    if cfg.cross_attention:
        args.append(distribute(ins["frames"],
                               fixed(policy.frames_spec(shape.global_batch)),
                               mesh, materialize))
    # the cache is written in place: it keeps its placements
    return Step(fn, tuple(args), (logits_pl, placements_of(c_dt)), (2,),
                cfg)


def placements_of(tree):
    """Each ``DTensor`` leaf of ``tree`` as its placement list."""
    return map_named(lambda _, a: list(a.placements), tree)


def _zeros(materialize: Optional[Callable]) -> Optional[Callable]:
    """Optimizer state starts at zero: real zeros where the arguments are
    real, ``meta`` otherwise."""
    if materialize is None:
        return None
    return lambda _, leaf: torch.zeros(leaf.shape, dtype=leaf.dtype)


def _gather_hook(cfg: ModelConfig, policy: ShardingPolicy, mesh,
                 which: Callable[[str], bool]):
    """A ``T.apply`` ``param_hook``: each layer's leaves that ``which``
    names re-placed on their no-FSDP spec (an all-gather over the batch
    axes; in the backward, a reduce-scatter of their gradients).  Names
    as JAX's hook builds them (``attn/wq/q``)."""
    nofsdp = dataclasses.replace(
        policy, cfg=dataclasses.replace(cfg, fsdp_weights=False))

    def hook(layer_p):
        def one(name, leaf):
            if not which(name):
                return leaf
            want = placements(nofsdp.param_spec(name, tuple(leaf.shape)),
                              mesh)
            return leaf if list(leaf.placements) == want else \
                leaf.redistribute(mesh, want)
        return map_named(one, layer_p)
    return hook


def n_repeats(cfg: ModelConfig) -> int:
    """Repeats of the block pattern in the stack."""
    return cfg.n_layers // len(cfg.block_pattern)


def with_repeats(cfg: ModelConfig, n_rep: int) -> ModelConfig:
    """``cfg`` cut to ``n_rep`` repeats of its pattern (its remainder
    layers kept)."""
    pat = len(cfg.block_pattern)
    return dataclasses.replace(cfg, n_layers=n_rep * pat + cfg.n_layers % pat)
