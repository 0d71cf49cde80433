"""Layer-level migration (§4.1, Fig. 3) of the port, on torch tensors.

A model is partitioned layer-wise across *instances*.  Migration moves a
contiguous span of layers — weights ``W_l`` **and** serving state ``KV_l``
— to another instance and updates the routing table; execution resumes
with identical semantics (Eq. 5).  Costs are charged with the Eq. 4 model
(weights dominate: S_w >> S_kv).

The port of the JAX package's ``core/layer_migration.py``, with one
difference of substance: ``unstack_layers``, ``unstack_cache`` and
``span_params`` return views of the stacked tensors (a slice on the layer
axis), never copies, so a span engine shares its weights with the full
parameters.  ``restack_*`` and the state split/merge copy, as a wire
state owns its memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..models import layers as L
from ..models import transformer as T
from ..models.config import BlockKind, Family, ModelConfig
from .analytical import HardwareProfile, layer_migration_time


# ---------------------------------------------------------------------------
# Grouped params/cache <-> flat per-layer lists
# ---------------------------------------------------------------------------

def _map(fn, tree):
    return T._tree_map(fn, tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _stack(trees: Sequence[Any]):
    """Stack equally shaped trees on a new leading axis (copies)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def unstack_layers(cfg: ModelConfig, params: Dict[str, Any]
                   ) -> List[Tuple[BlockKind, Dict[str, Any]]]:
    """Grouped/stacked params -> ordered per-layer list (kind, params);
    each layer's tensors are views of the stacked ones."""
    pat, n_rep, rem = T._group_shapes(cfg)
    out: List[Tuple[BlockKind, Dict[str, Any]]] = []
    for r in range(n_rep):
        for g, kind in enumerate(pat):
            out.append((kind, T._layer(params["groups"][g], r)))
    for i in range(rem):
        out.append((pat[i], params["rem"][i]))
    return out


def unstack_cache(cfg: ModelConfig, cache: Dict[str, Any]
                  ) -> List[Dict[str, Any]]:
    """Per-layer states of a grouped cache or request state (views)."""
    pat, n_rep, rem = T._group_shapes(cfg)
    out = []
    for r in range(n_rep):
        for g in range(len(pat)):
            out.append(T._layer(cache["groups"][g], r))
    for i in range(rem):
        out.append(cache["rem"][i])
    return out


def restack_layers(cfg: ModelConfig,
                   layers: Sequence[Tuple[BlockKind, Dict[str, Any]]]
                   ) -> Dict[str, Any]:
    """Inverse of ``unstack_layers``: an ordered per-layer list back into
    the grouped/stacked layout of ``cfg`` (copies)."""
    pat, n_rep, rem = T._group_shapes(cfg)
    assert len(layers) == cfg.n_layers, (len(layers), cfg.n_layers)
    for i, (kind, _) in enumerate(layers):
        want = pat[i % len(pat)] if i < n_rep * len(pat) \
            else pat[i - n_rep * len(pat)]
        assert kind == want, f"layer {i}: {kind} != pattern {want}"
    groups = []
    for g in range(len(pat)):
        per_rep = [layers[r * len(pat) + g][1] for r in range(n_rep)]
        groups.append(_stack(per_rep) if per_rep else None)
    return {
        "groups": tuple(g for g in groups if g is not None),
        "rem": tuple(layers[n_rep * len(pat) + i][1] for i in range(rem)),
    }


def restack_cache(cfg: ModelConfig,
                  states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Inverse of ``unstack_cache`` (layer part only; callers re-attach
    ``length`` and friends).  Copies."""
    pat, n_rep, rem = T._group_shapes(cfg)
    assert len(states) == cfg.n_layers, (len(states), cfg.n_layers)
    groups = []
    for g in range(len(pat)):
        per_rep = [states[r * len(pat) + g] for r in range(n_rep)]
        groups.append(_stack(per_rep) if per_rep else None)
    return {
        "groups": tuple(g for g in groups if g is not None),
        "rem": tuple(_map(torch.clone, states[n_rep * len(pat) + i])
                     for i in range(rem)),
    }


def layer_state_bytes(state: Dict[str, Any]) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(state))


def layer_param_bytes(p: Dict[str, Any]) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(p))


# ---------------------------------------------------------------------------
# Layer spans: partial-stack configs, params and request-state split/merge
# ---------------------------------------------------------------------------

def even_spans(n_layers: int, k: int) -> List[Tuple[int, int]]:
    """Partition [0, n_layers) into ``k`` contiguous near-equal spans."""
    assert 1 <= k <= n_layers, (k, n_layers)
    cuts = [round(i * n_layers / k) for i in range(k + 1)]
    return [(cuts[i], cuts[i + 1]) for i in range(k)]


def span_config(cfg: ModelConfig, start: int, end: int) -> ModelConfig:
    """A ModelConfig describing layers [start, end) of ``cfg``'s stack: the
    exact slice of the full stack's block kinds as its pattern (one
    repeat, no remainder), so every grouped-layout consumer works on the
    span unchanged.  Embedding and unembedding stay in the config;
    partial-stack execution skips them (``apply(hidden_in/hidden_out)``)."""
    assert 0 <= start < end <= cfg.n_layers, (start, end, cfg.n_layers)
    blocks = cfg.blocks()[start:end]
    return dataclasses.replace(
        cfg, name=f"{cfg.name}[{start}:{end}]", n_layers=end - start,
        block_pattern=tuple(blocks))


def _layer_view(cfg: ModelConfig, params: Dict[str, Any], i: int):
    """Layer ``i``'s weights as a (1, ...) slice of the stacked tensors:
    a view, never a copy."""
    pat, n_rep, _ = T._group_shapes(cfg)
    if i < n_rep * len(pat):
        r = i // len(pat)
        return _map(lambda a: a[r:r + 1], params["groups"][i % len(pat)])
    return _map(lambda a: a.unsqueeze(0),
                params["rem"][i - n_rep * len(pat)])


def span_params(cfg: ModelConfig, params: Dict[str, Any], start: int,
                end: int) -> Dict[str, Any]:
    """Parameters for the [start, end) span in the span config's grouped
    layout: the embedding, out-norm (and unembedding) ride along on every
    span; the per-layer weights are views into ``params`` (one group per
    layer, each a one-repeat slice on the layer axis), so no weight is
    copied.  An int8 leaf's values and per-layer scales are cut together
    (a per-tensor scale becomes the layer's one-element scale)."""
    out: Dict[str, Any] = {"embed": params["embed"],
                           "out_norm": params["out_norm"]}
    if "unembed" in params:
        out["unembed"] = params["unembed"]
    out["groups"] = tuple(_layer_view(cfg, params, i)
                          for i in range(start, end))
    out["rem"] = ()
    return out


def _layers_n_blocks(layers: Sequence[Dict[str, Any]]) -> Optional[int]:
    """Pages carried by a per-layer state list, or None if every layer is
    dense.  A per-layer attention state's ``pos`` leaf is ``(clen,)`` in
    the dense layout and ``(n_blocks, block_size)`` in the paged wire
    format: the rank tells them apart."""
    for ls in layers:
        if isinstance(ls, dict) and "pos" in ls and ls["pos"].ndim == 2:
            return int(ls["pos"].shape[0])
    return None


def _base_config(cfg: ModelConfig,
                 base: Tuple[int, int]) -> ModelConfig:
    return cfg if base == (0, cfg.n_layers) else span_config(cfg, *base)


def split_state_spans(cfg: ModelConfig, st: Dict[str, Any],
                      bounds: Sequence[Tuple[int, int]],
                      base: Optional[Tuple[int, int]] = None
                      ) -> List[Dict[str, Any]]:
    """Split one request state (dense or paged wire format) into per-span
    states in each span config's grouped layout.  ``bounds`` are absolute
    layer indices; ``base`` names the span ``st`` itself covers (default
    the whole stack).  ``length`` is copied onto every part; ``n_blocks``
    only onto parts that carry paged leaves."""
    base = (0, cfg.n_layers) if base is None else tuple(base)
    layers = unstack_cache(_base_config(cfg, base), st)
    parts: List[Dict[str, Any]] = []
    for a, b in bounds:
        span_layers = layers[a - base[0]:b - base[0]]
        part = restack_cache(span_config(cfg, a, b), span_layers)
        part["length"] = st["length"]
        nb = _layers_n_blocks(span_layers)
        if nb is not None:
            part["n_blocks"] = nb
        parts.append(part)
    return parts


def merge_state_spans(cfg: ModelConfig, parts: Sequence[Dict[str, Any]],
                      bounds: Sequence[Tuple[int, int]]) -> Dict[str, Any]:
    """Inverse of ``split_state_spans``: per-span request states back into
    one state covering the contiguous union of ``bounds`` (the whole stack
    when the bounds partition it: the universal hand-off wire format), so
    span pipelines interoperate with full-stack engines."""
    assert len(parts) == len(bounds)
    for (_, b0), (a1, _) in zip(bounds, bounds[1:]):
        assert b0 == a1, f"bounds not contiguous: {bounds}"
    layers: List[Dict[str, Any]] = []
    for part, (a, b) in zip(parts, bounds):
        layers.extend(unstack_cache(span_config(cfg, a, b), part))
    out = restack_cache(_base_config(cfg, (bounds[0][0], bounds[-1][1])),
                        layers)
    out["length"] = parts[0]["length"]
    nb = _layers_n_blocks(layers)
    if nb is not None:
        out["n_blocks"] = nb
    return out


# ---------------------------------------------------------------------------
# Partitioned executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MigrationRecord:
    span: Tuple[int, int]
    src: str
    dst: str
    payload_bytes: int
    est_time_s: float


class PartitionedExecutor:
    """Runs a model whose layers live on named instances, layer by layer,
    with the activation handed off at instance boundaries (pipeline
    order).  ``assignment[i]`` names the instance owning layer i; the
    instances are logical and the hand-off is charged analytically."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 assignment: Sequence[str],
                 hw: Optional[HardwareProfile] = None):
        assert len(assignment) == cfg.n_layers
        T.check_supported(cfg)
        self.cfg = cfg
        self.embed = params["embed"]
        self.out_norm = params["out_norm"]
        self.unembed = params.get("unembed")
        self.layers = unstack_layers(cfg, params)
        self.assignment = list(assignment)
        self.hw = hw
        self.migrations: List[MigrationRecord] = []

    # -- execution -------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                states: Optional[List[Dict[str, Any]]] = None,
                mode: str = "train",
                frames: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]],
                           Dict[str, float]]:
        """Returns (logits, states, per-instance FLOP shares).  ``states``
        (per-layer dense caches, e.g. ``unstack_cache`` of a
        ``T.init_cache``) are written in place and returned.  ``frames``
        are a cross-attention stack's encoder output; the hybrid family's
        embedding is scaled by sqrt(d_model), as JAX's executor does."""
        cfg = self.cfg
        b, s = tokens.shape
        ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
        positions = (lengths.to(torch.int32)[:, None] + ar[None, :]
                     if lengths is not None else ar[None, :].expand(b, s))
        x = self.embed[tokens]
        if cfg.family == Family.HYBRID:
            x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
        shares: Dict[str, float] = {}
        per_layer_flops = 2.0 * cfg.active_param_count() \
            / max(cfg.n_layers, 1) * b * s
        for i, (kind, lp) in enumerate(self.layers):
            x, _ = T._apply_block(
                cfg, kind, lp, x, positions=positions,
                state=states[i] if states is not None else None, mode=mode,
                prefix_aware=False, block_tables=None, paged_kernel=False,
                frames=frames)
            inst = self.assignment[i]
            shares[inst] = shares.get(inst, 0.0) + per_layer_flops
        x = L.rms_norm(x, self.out_norm, cfg.rms_eps)
        unembed = self.embed.t() if cfg.tie_embeddings else self.unembed
        return x @ unembed, states, shares

    # -- migration -------------------------------------------------------
    def migrate(self, start: int, end: int, dst: str,
                states: Optional[List[Dict[str, Any]]] = None
                ) -> MigrationRecord:
        """Move layers [start, end) (and their serving state) to ``dst``."""
        src = self.assignment[start]
        payload = sum(layer_param_bytes(self.layers[i][1])
                      for i in range(start, end))
        if states is not None:
            payload += sum(layer_state_bytes(states[i])
                           for i in range(start, end))
        est = 0.0
        if self.hw is not None:
            est = layer_migration_time(self.cfg, end - start, 0, self.hw)
            est = max(est, payload / self.hw.net_bw + 2e-3)
        for i in range(start, end):
            self.assignment[i] = dst
        rec = MigrationRecord((start, end), src, dst, payload, est)
        self.migrations.append(rec)
        return rec

    def layers_on(self, inst: str) -> List[int]:
        return [i for i, a in enumerate(self.assignment) if a == inst]
