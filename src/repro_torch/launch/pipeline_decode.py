"""Pipeline-parallel decode (the JAX package's ``launch/pipeline_decode.py``).

Each rank along the mesh's "data" axis OWNS a contiguous span of
``per_stage`` layers outright (pipeline stages; the "model" axis is
replicated within a stage, JAX's fully-manual mode: identical results,
duplicated compute).  Nothing is gathered: the only traffic between
stages is the (microbatch, 1, d) activation, handed on by ``send`` /
``recv`` where JAX uses ``ppermute``; the last stage's logits are summed
over "data" by one ``all_reduce`` (the other stages contribute zeros).

The decode batch is split into ``n_stages`` microbatches fed GPipe-style
over ``2 * n_stages - 1`` ticks: at tick t stage s works on microbatch
t - s.  JAX masks the ticks where that index is out of range with
``jnp.where`` because the stage is a traced value; here the stage is a
Python int, so such a tick computes, writes and sends nothing (both sides
of each ``send``/``recv`` agree on it: stage s sends at tick t exactly
when stage s + 1 receives at t + 1).

Restrictions, as JAX's: dense decoder-only stacks of one attention kind,
the decode step only, over a dense cache.  The layer count is padded to a
multiple of the stage count with identity layers (every leaf zero: zero
output projections, so the residual passes through).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..models import layers as L
from ..models import quant as Q
from ..models import transformer as T
from ..models.config import BlockKind, ModelConfig
from ..training.tree import map_named
from .mesh import axis_names, axis_sizes
from .sharding import local_shard


def pad_layers(cfg: ModelConfig, n_stages: int) -> Tuple[int, int]:
    """(layers_per_stage, n_pad) so stages divide the (padded) stack."""
    total = -(-cfg.n_layers // n_stages) * n_stages
    return total // n_stages, total - cfg.n_layers


def _pad_leaf(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((n_pad,) + tuple(a.shape[1:]))])


def pad_stacked_params(cfg: ModelConfig, params, n_pad: int):
    """Append ``n_pad`` identity layers (every leaf zero, int8 payloads
    and scales too) to the stacked group's params."""
    if n_pad == 0:
        return params
    out = dict(params)
    out["groups"] = (map_named(lambda _, a: _pad_leaf(a, n_pad),
                               params["groups"][0]),)
    return out


def pad_stacked_cache(cache, n_pad: int):
    """Append ``n_pad`` blank layers to the stacked group's cache."""
    if n_pad == 0:
        return cache
    out = dict(cache)
    out["groups"] = (map_named(lambda _, a: _pad_leaf(a, n_pad),
                               cache["groups"][0]),)
    return out


def _stage_tree(tree, mesh, depth: int):
    """This rank's stage of a padded stacked group tree: every leaf cut on
    its layer axis to the stage's layers (views; JAX's in_specs
    ``P("data")``)."""
    def cut(name, a):
        if a.shape[0] != depth:
            raise ValueError(f"pipeline decode: leaf {name} has "
                             f"{a.shape[0]} layers, want the padded {depth}")
        return local_shard(a, ("data",), mesh)
    return map_named(cut, tree)


def build_pipeline_decode(cfg: ModelConfig, mesh, batch: int):
    """Returns ``(decode_fn, per_stage, n_pad)``; ``decode_fn(params,
    tokens, cache) -> (logits, new_cache)`` pipelined over the mesh's
    "data" axis, called by every rank of ``mesh`` (a ``DeviceMesh``).

    ``params`` and ``cache`` are the padded trees (``pad_stacked_params``
    / ``pad_stacked_cache``), ``tokens`` (B, 1); each rank reads and
    writes only its stage's layers of them.  Returns the (B, V) f32
    logits on every rank, and the cache whose ``groups[0]`` holds this
    rank's stage (views of the caller's tensors, written in place) with
    ``lengths + 1``."""
    if len(cfg.block_pattern) != 1 or cfg.block_pattern[0] not in (
            BlockKind.ATTENTION, BlockKind.LOCAL_ATTENTION):
        raise ValueError("pipeline decode: dense uniform stacks only")
    if "data" not in axis_names(mesh):
        raise ValueError("pipeline decode needs a mesh with a 'data' axis")
    n_stages = axis_sizes(mesh)["data"]
    if batch % n_stages:
        raise ValueError(f"pipeline decode: batch {batch} does not split "
                         f"into {n_stages} microbatches")
    mb = batch // n_stages
    per_stage, n_pad = pad_layers(cfg, n_stages)
    kind = cfg.block_pattern[0]

    def decode_fn(params: Dict[str, Any], tokens: torch.Tensor,
                  cache: Dict[str, Any]):
        group = mesh.get_group("data")
        stage = mesh.get_local_rank("data")
        last = n_stages - 1
        depth = per_stage * n_stages
        p_st = _stage_tree(params["groups"][0], mesh, depth)
        c_st = _stage_tree(cache["groups"][0], mesh, depth)
        layers = T._unstack(p_st, per_stage)
        lengths = cache["lengths"]
        compute_dtype = params["out_norm"].dtype
        emb = params["embed"]
        dev = lengths.device
        logits = torch.zeros((batch, cfg.vocab_size), dtype=torch.float32,
                             device=dev)
        for t in range(2 * n_stages - 1):
            m = t - stage                  # microbatch index at this stage
            if not 0 <= m < n_stages:
                continue                   # the masked tick
            rows = slice(m * mb, (m + 1) * mb)
            if stage == 0:
                toks = tokens[rows]
                x = (Q.dequant({"q": emb["q"][toks], "s": emb["s"]},
                               compute_dtype)
                     if Q.is_quantized(emb) else emb[toks])
            else:
                x = torch.empty((mb, 1, cfg.d_model), dtype=compute_dtype,
                                device=dev)
                dist.recv(x, src=dist.get_global_rank(group, stage - 1),
                          group=group)
            positions = lengths[rows][:, None]
            for r in range(per_stage):
                state = {k: a[r, rows] for k, a in c_st.items()}
                x, _ = T._apply_block(
                    cfg, kind, layers[r], x, positions=positions,
                    state=state, mode="decode", prefix_aware=False,
                    block_tables=None, paged_kernel=False)
            if stage == last:
                h = L.rms_norm(x, params["out_norm"], cfg.rms_eps)[:, -1]
                unembed = (Q.dequant(emb, compute_dtype).t()
                           if cfg.tie_embeddings
                           else Q.dequant(params["unembed"], compute_dtype))
                logits[rows] += (h @ unembed).float()
            else:
                dist.send(x.contiguous(),
                          dst=dist.get_global_rank(group, stage + 1),
                          group=group)
        # only the last stage holds real logits: sum over the stages
        dist.all_reduce(logits, group=group)
        new_cache = {"lengths": lengths + 1, "groups": (c_st,),
                     "rem": cache.get("rem", ())}
        return logits, new_cache

    return decode_fn, per_stage, n_pad
