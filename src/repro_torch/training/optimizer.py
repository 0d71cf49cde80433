"""AdamW, as the JAX package's ``training/optimizer.py`` computes it.

The rules are JAX's, copied on purpose: the clip scale min(1, clip /
(gnorm + 1e-9)); moments always f32 whatever the parameter dtype; bias
corrections from an f32 step; the update computed in f32 and cast back
to the parameter dtype; weight decay only on leaves with ``ndim >= 2``,
which counts the stacked layer axis, so a norm inside ``groups`` (shape
(n_rep, d)) is decayed and one in ``rem`` or ``out_norm`` is not
(ROADMAP §C, R5).

Where JAX donates the parameters and the state and returns new trees,
``apply_updates`` writes the new values into the caller's tensors in
place and returns the same trees.  Each leaf is worked in slices of at
most ``CHUNK_ELEMS`` elements along its first axis (a stacked leaf one
layer or less at a time), so the f32 temporaries stay bounded; every
operation is elementwise, so the values do not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator

import torch

from .tree import map_named, named_leaves

# The largest slice of a leaf one update works at once (256 MB in f32).
CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_state(params) -> Dict[str, Any]:
    """Zero f32 moments shaped like ``params`` and a step of 0 (int32), on
    the parameters' device."""
    def zeros(_, a):
        return torch.zeros(a.shape, dtype=torch.float32, device=a.device)

    dev = named_leaves(params)[0][1].device
    return {"mu": map_named(zeros, params), "nu": map_named(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _chunks(*ts: torch.Tensor) -> Iterator[tuple]:
    """Matching slices of same-shaped tensors along their first axis, at
    most ``CHUNK_ELEMS`` elements each (views: writes reach the leaf).  A
    ``DTensor`` leaf (the dry run) is worked whole: its rank holds only
    its shard, and a slice across a split axis would gather it."""
    t = ts[0]
    if (t.dim() == 0 or t.numel() <= CHUNK_ELEMS
            or type(t).__name__ == "DTensor"):
        yield ts
        return
    rows = max(1, CHUNK_ELEMS // (t.numel() // t.shape[0]))
    yield from zip(*(x.split(rows, dim=0) for x in ts))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(
        sum(c.float().square().sum() for (c,) in _chunks(a))
        for _, a in named_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Updates ``params`` and ``state`` in place and
    returns (params, state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    leaves = zip(named_leaves(params), named_leaves(grads),
                 named_leaves(state["mu"]), named_leaves(state["nu"]))
    for (_, p), (_, g), (_, mu), (_, nu) in leaves:
        decay = p.dim() >= 2            # the whole leaf's rank (R5)
        for p_c, g_c, mu_c, nu_c in _chunks(p, g, mu, nu):
            g32 = g_c.float() * scale
            mu_c.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            nu_c.mul_(cfg.b2).add_((1 - cfg.b2) * g32.square())
            delta = (mu_c / b1c) / (torch.sqrt(nu_c / b2c) + cfg.eps)
            p32 = p_c.float()
            if decay:
                delta = delta + cfg.weight_decay * p32
            p_c.copy_(p32 - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
