"""The causal LM loss (+ the MoE load-balance auxiliary) and the train
step, as the JAX package's ``training/train_step.py`` computes them.

``make_train_step`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``, which runs eagerly: the forward and its
autograd backward (``T.forward_train``, optionally rematerialized layer
by layer), then ``optimizer.apply_updates``, which writes the new values
into the caller's tensors.  No leaf of ``params`` requires grad before or
after a step (the backward runs on detached copies that share their
storage), so the trained tree serves as it is.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from . import optimizer as opt
from .tree import map_named, named_leaves


def lm_loss(cfg: ModelConfig, params, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None, moe_impl: str = "sorted",
            moe_cf=None, lb_coef: float = 0.01, remat: bool = False,
            param_hook=None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over tokens[:, :-1] -> tokens[:, 1:], in
    f32 through logsumexp.  A MoE stack adds ``lb_coef`` times the
    Switch-style load balance E * sum(load^2) over ``aux["router_load"]``
    (a count of routed pairs: no gradient, in either package).  Returns
    (loss, aux) with ``aux["nll"]`` and, for MoE, ``aux["lb_loss"]``."""
    logits, aux = T.forward_train(cfg, params, tokens[:, :-1], frames=frames,
                                  moe_impl=moe_impl, moe_cf=moe_cf,
                                  remat=remat, param_hook=param_hook)
    targets = tokens[:, 1:].long()
    logits = logits.float()
    logz, gold = _logz(logits), _gold_logit(logits, targets)
    nll = (logz - gold).mean()
    loss = nll
    if cfg.n_experts > 0:
        load = aux["router_load"]
        lb = cfg.n_experts * torch.sum(load * load)
        loss = loss + lb_coef * lb
        aux["lb_loss"] = lb
    aux["nll"] = nll
    return loss, aux


def _logz(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocabulary; for ``DTensor`` logits (the dry run)
    as max + log(sum(exp(x - max))), whose reductions ``DTensor`` splits
    with the vocabulary (its logsumexp gathers the logits first)."""
    if type(logits).__name__ != "DTensor":
        return torch.logsumexp(logits, dim=-1)
    m = _RowsWhole.apply(logits.amax(dim=-1, keepdim=True).detach())
    total = _RowsWhole.apply(torch.exp(logits - m).sum(-1, keepdim=True))
    return (m + torch.log(total))[..., 0]


class _RowsWhole(torch.autograd.Function):
    """A ``DTensor`` reduced over the vocabulary, made whole on every mesh
    dim but those splitting its rows, forward and backward: left alone,
    ``DTensor`` resolves such a sum by splitting the sequence, and its
    gradient then meets the vocabulary-split logits, which it gathers."""

    @staticmethod
    def forward(ctx, t):
        return _rows_placed(t)

    @staticmethod
    def backward(ctx, g):
        return _rows_placed(g)


def _rows_placed(t):
    from torch.distributed.tensor import Replicate
    want = [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in t.placements]
    return t.redistribute(t.device_mesh, want)


def _gold_logit(logits: torch.Tensor, targets: torch.Tensor
                ) -> torch.Tensor:
    """Each target's logit: a gather, or for vocabulary-split ``DTensor``
    logits (the dry run) a one-hot product summed over the vocabulary,
    the vocabulary's ids split as the logits are (exact: one nonzero
    term).  ``DTensor``'s gather over a split vocabulary masks only 2-D
    outputs."""
    if type(logits).__name__ != "DTensor":
        return logits.gather(-1, targets[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = [Shard(0) if p.is_shard() and p.dim == last else Replicate()
          for p in logits.placements]
    n, off = compute_local_shape_and_global_offset((logits.shape[-1],),
                                                   mesh, pl)
    ids = torch.arange(off[0], off[0] + n[0],
                       device=logits.to_local().device)
    vocab = DTensor.from_local(ids, mesh, pl, run_check=False,
                               shape=(logits.shape[-1],), stride=(1,))
    hit = (targets[..., None] == vocab).to(logits.dtype)
    return _RowsWhole.apply((logits * hit).sum(-1))


def _grad_one(cfg: ModelConfig, params, tokens, frames, **loss_kw
              ) -> Tuple[torch.Tensor, Dict[str, Any], List[torch.Tensor]]:
    """(loss, aux, grads) of one batch; grads in ``named_leaves`` order,
    each in its leaf's dtype, zeros for a leaf the loss does not read (as
    JAX's ``value_and_grad`` gives).  The backward runs on detached copies
    of the leaves, so the caller's tensors never require grad."""
    live = map_named(lambda _, a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, aux = lm_loss(cfg, live, tokens, frames=frames, **loss_kw)
        grads = torch.autograd.grad(
            loss, [a for _, a in named_leaves(live)], allow_unused=True,
            materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        list(grads)


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                   moe_impl: str = "sorted", moe_cf=None,
                   remat: bool = False, num_microbatches: int = 1,
                   param_hook=None):
    """(loss, aux, grads) of one batch, as JAX's step computes them before
    the update.  grads is a tree like ``params``.  ``param_hook`` is
    ``T.apply``'s (the dry run gathers FSDP-split weights there).

    ``num_microbatches`` > 1 splits the batch (and its frames) into equal
    chunks, accumulates f32 gradients divided by the count, and returns
    the loss as sum(loss_i) / mb, ``aux["nll"]`` as the mean of the
    chunks' (and ``aux["lb_loss"]`` likewise), as JAX's ``lax.scan`` body
    does; its gradients are then f32 whatever the parameter dtype."""
    if any(a.dtype == torch.int8 for _, a in named_leaves(params)):
        # int8 weights (models/quant.py), refused as JAX refuses them
        raise ValueError("int8 weights are a serving-only optimization")
    kw = dict(moe_impl=moe_impl, moe_cf=moe_cf, remat=remat,
              param_hook=param_hook)
    tokens, frames = batch["tokens"], batch.get("frames")
    mb = num_microbatches
    if mb <= 1:
        loss, aux, flat = _grad_one(cfg, params, tokens, frames, **kw)
    else:
        b = tokens.shape[0]
        if b % mb:
            raise ValueError(f"batch {b} does not split into {mb} "
                             "microbatches")
        flat = [torch.zeros_like(a, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
                for _, a in named_leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        parts: Dict[str, List[torch.Tensor]] = {}
        fr = _microbatches(frames, mb) if frames is not None else [None] * mb
        for t, f in zip(_microbatches(tokens, mb), fr):
            loss_i, aux_i, g = _grad_one(cfg, params, t, f, **kw)
            for acc, x in zip(flat, g):
                acc.add_(x.float() / mb)
            loss = loss + loss_i / mb
            for k in ("nll", "lb_loss"):
                if k in aux_i:
                    parts.setdefault(k, []).append(aux_i[k])
        aux = {k: torch.stack(v).mean() for k, v in parts.items()}
    by_name = dict(zip((n for n, _ in named_leaves(params)), flat))
    return loss, aux, map_named(lambda n, _: by_name[n], params)


def _microbatches(x: torch.Tensor, mb: int) -> List[torch.Tensor]:
    """``x`` cut into ``mb`` equal chunks of rows.  A ``DTensor`` whose
    rows are split over a mesh (the dry run, ``launch/steps.py``) is cut
    per rank: microbatch i holds chunk i of every rank's own rows, so no
    row moves between ranks (JAX's chunks are contiguous in the global
    batch; the summed loss and gradients are the same sums)."""
    if type(x).__name__ != "DTensor":
        return list(x.chunk(mb))
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(c, x.device_mesh, x.placements,
                               run_check=False)
            for c in x.to_local().chunk(mb)]


def make_train_step(cfg: ModelConfig, opt_cfg: opt.AdamWConfig,
                    moe_impl: str = "sorted", moe_cf=None,
                    remat: bool = False, num_microbatches: int = 1,
                    param_hook=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch: {"tokens": (B, S+1) int, optional "frames": (B, F, d)}.
    ``remat`` recomputes each stacked layer's activations in the backward
    (``T.apply``); ``num_microbatches`` accumulates gradients over batch
    chunks (``loss_and_grads``).  metrics: "loss", "nll", "grad_norm",
    "lr" as JAX's, plus "lb_loss" for a MoE stack; 0-d tensors on the
    parameters' device.  A tree with int8 leaves raises ``ValueError``."""
    def step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(
            cfg, params, batch, moe_impl=moe_impl, moe_cf=moe_cf,
            remat=remat, num_microbatches=num_microbatches,
            param_hook=param_hook)
        params, opt_state, om = opt.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        metrics = {"loss": loss, "nll": aux["nll"], **om}
        if "lb_loss" in aux:
            metrics["lb_loss"] = aux["lb_loss"]
        return params, opt_state, metrics
    return step
