"""Sharding rules: tree path + shape -> partition spec (the JAX package's
``launch/sharding.py``).

A spec has one entry per tensor dimension: None (replicated), a mesh axis
name, or a tuple of axis names the dimension is split over, major axis
first.  These are JAX's ``PartitionSpec`` entries, so a port spec and
JAX's compare as tuples (``()`` is JAX's ``P()``: replicated).

Policy (as JAX's):
* batch            -> ("pod","data")                      [all shapes]
* attention heads / FFN hidden / vocab -> "model"
* GQA KV heads     -> "model" only when divisible, else replicated
* weights of >=100B models (``fsdp_weights``) additionally shard their
  non-head dim over the batch axes (ZeRO-3 / FSDP style)
* KV cache         -> batch over ("pod","data"), sequence over "model"
* long_500k (``seq_shard``, batch 1) -> KV sequence over
  ("pod","data","model"): full context parallelism
* models under ``REPLICATE_BYTES`` in bf16 replicate every weight

Every rule falls back to replication when a dimension does not divide by
the axis size.  The policy reads only the mesh's axis names and sizes
(``mesh.axis_sizes``), so it runs for a 256- or 512-rank mesh stand-in
with no process group.

``placements`` turns a spec into ``DTensor`` placements over a
``DeviceMesh``; ``local_shard`` cuts the slice of a global tensor that one
rank holds (a view), splitting a dimension over several axes major axis
first (``("pod", "data")``: pod-major, as JAX places it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from ..models.config import ModelConfig
from ..training.tree import map_named
from .mesh import axis_names, axis_sizes, coordinates, data_axes, mesh_dims

REPLICATE_BYTES = int(1.5e9)

Spec = Tuple[Any, ...]


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(axis))


def _maybe(mesh, axis, dim: int):
    """Use ``axis`` only when ``dim`` divides evenly."""
    if axis is None or dim % _axis_size(mesh, axis) != 0:
        return None
    # singleton axis tuples become bare names: ("data",) and "data" mean
    # the same sharding but would not compare equal as spec entries
    if isinstance(axis, tuple):
        if not axis:
            return None
        if len(axis) == 1:
            return axis[0]
    return axis


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    cfg: ModelConfig
    seq_shard: bool = False        # long_500k: context parallelism
    # replicate every weight (None: ``cfg.replicate_small()``); the dry
    # run fixes it from the full-depth model when it cuts the depth
    replicate: Optional[bool] = None

    @property
    def dp(self):
        return data_axes(self.mesh)

    @property
    def fsdp(self):
        """Extra weight-sharding axis for huge models."""
        return self.dp if self.cfg.fsdp_weights else None

    @property
    def replicate_all(self) -> bool:
        return self.cfg.replicate_small() if self.replicate is None \
            else self.replicate

    # -- parameters -----------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        m = self.mesh
        if self.replicate_all:
            return ()
        parts = path.split("/")
        name = parts[-1]
        if name == "s":                  # int8 scale: replicate
            return ()
        if name == "q":                  # int8 payload: parent weight's rule
            name = parts[-2]
        stacked = path.startswith("groups")     # leading repeat dim
        pre = (None,) if stacked else ()

        def spec(*axes):
            return pre + axes

        base = shape[1:] if stacked else shape
        if name in ("embed", "unembed"):
            # (V, d) / (d, V)
            big, small = (0, 1) if name == "embed" else (1, 0)
            out = [None, None]
            out[big] = _maybe(m, "model", shape[big])
            out[small] = _maybe(m, self.fsdp, shape[small])
            return tuple(out)
        if name in ("wq", "wk", "wv"):           # (d, H|KV, hd)
            return spec(_maybe(m, self.fsdp, base[0]),
                        _maybe(m, "model", base[1]), None)
        if name == "wo":                         # (H, hd, d)
            return spec(_maybe(m, "model", base[0]), None,
                        _maybe(m, self.fsdp, base[2]))
        if name in ("w_gate", "w_up"):
            if len(base) == 3:                   # MoE (E, d, f)
                return spec(None, _maybe(m, self.fsdp, base[1]),
                            _maybe(m, "model", base[2]))
            return spec(_maybe(m, self.fsdp, base[0]),
                        _maybe(m, "model", base[1]))
        if name == "w_down":
            if len(base) == 3:                   # MoE (E, f, d)
                return spec(None, _maybe(m, "model", base[1]),
                            _maybe(m, self.fsdp, base[2]))
            return spec(_maybe(m, "model", base[0]),
                        _maybe(m, self.fsdp, base[1]))
        if name == "router":                     # (d, E)
            return spec(_maybe(m, self.fsdp, base[0]), None)
        if name in ("w_x", "w_y", "w_a", "w_i", "w_out", "w_o",
                    "w_gates", "r_gates", "w_if"):
            return spec(_maybe(m, self.fsdp, base[0]),
                        _maybe(m, "model", base[1]))
        if name == "conv_w":                     # (W, d)
            return spec(None, _maybe(m, "model", base[1]))
        if name == "a_param":                    # (d,)
            return spec(_maybe(m, "model", base[0]))
        # norms, biases, everything else: replicate
        return (None,) * len(shape)

    # -- serving state ----------------------------------------------------
    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        m = self.mesh
        name = path.split("/")[-1]
        stacked = "groups" in path
        pre = (None,) if stacked else ()
        base = shape[1:] if stacked else shape

        def spec(*axes):
            return pre + axes

        batch_ax = None if self.seq_shard else \
            _maybe(m, self.dp, base[0] if base else 1)
        seq_axes = ("pod", "data", "model") if self.seq_shard else ("model",)
        seq_axes = tuple(a for a in seq_axes if a in axis_names(m))
        if name == "lengths":
            return (_maybe(m, self.dp, shape[0])
                    if not self.seq_shard else None,)
        if name in ("k", "v"):                  # (B, L, KV, D)
            return spec(batch_ax, _maybe(m, seq_axes, base[1]), None, None)
        if name == "pos":                        # (B, L)
            return spec(batch_ax, _maybe(m, seq_axes, base[1]))
        if name in ("k_scale", "v_scale"):       # (B, L, KV)
            return spec(batch_ax, _maybe(m, seq_axes, base[1]), None)
        if name == "h" and len(base) == 2:       # rglru / slstm (B, d)
            return spec(batch_ax, _maybe(m, "model", base[1]))
        if name == "conv":                       # (B, W-1, d)
            return spec(batch_ax, None, _maybe(m, "model", base[2]))
        if name in ("C", "n", "m", "c", "h"):    # xlstm states
            return spec(batch_ax, *((None,) * (len(base) - 1)))
        return spec(*((None,) * len(base)))

    # -- batches ----------------------------------------------------------
    def tokens_spec(self, batch: int) -> Spec:
        return (_maybe(self.mesh, self.dp, batch), None)

    def frames_spec(self, batch: int) -> Spec:
        return (_maybe(self.mesh, self.dp, batch), None, None)


def tree_specs(policy: ShardingPolicy, tree, kind: str):
    """A params (``"param"``) or cache (``"cache"``) tree mapped leaf by
    leaf to its spec (JAX's ``tree_shardings``; leaf names as
    ``training.tree`` gives them, ``"groups/0/attn/wq"``)."""
    fn = policy.param_spec if kind == "param" else policy.cache_spec
    return map_named(lambda name, leaf: fn(name, tuple(leaf.shape)), tree)


def opt_state_specs(policy: ShardingPolicy, param_specs) -> Dict[str, Any]:
    """AdamW's ``mu``/``nu`` mirror the parameters' specs; the step
    counter replicates."""
    return {"mu": param_specs, "nu": param_specs, "step": ()}


def placements(spec: Spec, mesh) -> list:
    """``DTensor`` placements of ``spec`` over ``mesh``: ``Shard(dim)`` on
    each mesh dim whose axes split tensor dimension ``dim``,
    ``Replicate()`` on the others.  A dimension split over several axes
    takes them in mesh order (the major axis first, as the policy writes
    them); a mesh dim that flattens several axes (the multi-pod mesh's
    ("pod", "data")) splits a dimension only over all of them."""
    names, dims = axis_names(mesh), mesh_dims(mesh)
    out = [Replicate() for _ in range(len(set(dims.values())))]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} does not follow the "
                             f"mesh's axis order {names}")
        for i in sorted({dims[a] for a in axes}):
            carried = tuple(a for a in names if dims[a] == i)
            if carried != tuple(a for a in axes if dims[a] == i):
                raise ValueError(f"spec entry {entry!r} splits part of "
                                 f"the mesh dim of axes {carried}")
            out[i] = Shard(d)
    return out


def local_shard(x: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The slice of the global ``x`` that the rank at ``coords`` (axis ->
    index; default this process's coordinate on the ``DeviceMesh``)
    holds under ``spec``: a view.  A dimension split over axes (a, b) is
    cut into size(a) * size(b) equal blocks and the rank takes block
    coords[a] * size(b) + coords[b]."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = coordinates(mesh)
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than x has "
                         f"dimensions {tuple(x.shape)}")
    out = x
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split over {axes} ({n} ways)")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        chunk = x.shape[d] // n
        out = out.narrow(d, idx * chunk, chunk)
    return out

