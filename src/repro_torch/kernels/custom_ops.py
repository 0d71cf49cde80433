"""The kernels as PyTorch custom operators (``torch.library.custom_op``).

Each kernel wrapper (``flash_prefill.py``, ``split_kv_decode.py``) defines
one operator in the ``repro_torch`` namespace with four bodies:

* ``cuda``: checks the inputs and launches the hand-written kernel
  (``_lib.launch``, which counts the launch).  A CUDA tensor never runs
  the plain version;
* ``cpu``: the plain PyTorch version from ``ref`` (its outputs made
  contiguous, as the other bodies' are);
* fake (also the ``meta`` kernel): output shapes only, so a step on
  ``meta`` tensors, or on ``DTensor``s whose local shards are ``meta``
  (``launch/dryrun.py``), never reaches ``ctypes``;
* a flop formula (``torch.utils.flop_counter.register_flop_formula``),
  which ``FlopCounterMode`` and the dry run's counter read;

and a ``DTensor`` sharding rule (``register_sharding``): rows follow the
batch, heads follow the heads (q's heads and the kv heads split alike,
so GQA groups stay whole), and B5's keys may split along the sequence
(its partials then split along the block axis).  Any other placement is
redistributed to one of these by ``DTensor``.

The flop formulas count from shapes alone (a fake tensor holds no
masks): 4 * D per (query head, key) pair the kernel walks, two products
of D multiply-adds.  B2 counts the pairs its causal (and window) mask
admits, which the shapes fix; B1, B3, B4 count every page slot of the
block table and B5 every key of the cache, the most the data could
need.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"


def define(name: str, schema: str, cuda_fn: Callable, cpu_fn: Callable,
           fake_fn: Callable, flops_fn: Callable,
           shardings_fn: Optional[Callable] = None):
    """Register the operator ``repro_torch::<name>`` with its bodies, its
    flop formula and its sharding rule.  Returns the operator (call it as
    a function)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cuda_fn,
                                 mutates_args=(), device_types="cuda",
                                 schema=schema)
    def cpu(*args):
        # contiguous, as the fake body's outputs are (a plain version may
        # return a permuted view)
        out = cpu_fn(*args)
        return tuple(t.contiguous() for t in out) \
            if isinstance(out, tuple) else out.contiguous()

    op.register_kernel("cpu")(cpu)
    op.register_fake(fake_fn)
    register_flop_formula(op._opoverload.overloadpacket)(flops_fn)
    if shardings_fn is not None:
        _register_sharding(op._opoverload, shardings_fn)
    return op


def _register_sharding(overload, fn) -> None:
    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(overload)(fn)


def causal_pairs(s: int, length: int, seq_offset: int,
                 window: Optional[int]) -> int:
    """(query, key) pairs a causal mask admits: the query at position
    p = seq_offset + i sees keys max(0, p - window + 1) .. min(p,
    length - 1).  Counted on the host (numpy), since a flop formula runs
    inside a dispatch mode."""
    p = np.arange(seq_offset, seq_offset + s, dtype=np.int64)
    lo = np.zeros_like(p) if window is None else \
        np.maximum(p - int(window) + 1, 0)
    return int(np.maximum(np.minimum(p, length - 1) - lo + 1, 0).sum())


def placement_rules(args: Sequence, strategies: Sequence[tuple]
                    ) -> List[tuple]:
    """``register_sharding`` strategies from ``(out_dims, in_dims)``
    pairs: ``out_dims`` one tensor dim per output, ``in_dims`` one per
    operator argument (None: replicated).  A dim becomes ``Shard(dim)``,
    None ``Replicate()``; an argument that is no tensor (a scalar, or an
    optional tensor not given) gets no placement.  The first strategy is
    always all replicated; a strategy that would split a dim unevenly
    over a mesh dim is left out."""
    from torch.distributed.tensor import Replicate, Shard

    def place(d):
        return Replicate() if d is None else Shard(d)

    is_t = [hasattr(a, "placements") for a in args]
    n_out = len(strategies[0][0]) if strategies else 1
    rules = [([Replicate()] * n_out,
              [Replicate() if t else None for t in is_t])]
    for out_dims, in_dims in strategies:
        if not all(_splits(a, d) for a, t, d in zip(args, is_t, in_dims)
                   if t and d is not None):
            continue
        rules.append(([place(d) for d in out_dims],
                      [place(d) if t else None
                       for t, d in zip(is_t, in_dims)]))
    return rules


def _splits(spec, dim: int) -> bool:
    """``spec``'s tensor dim ``dim`` splits evenly over every mesh dim
    (a strategy that would split it unevenly is not offered: no view of
    an uneven split exists)."""
    return all(spec.shape[dim] % spec.mesh.size(i) == 0
               for i in range(spec.mesh.ndim))


def shards_on(spec, dim: int) -> int:
    """How many ways the ``DTensor`` spec ``spec`` splits tensor dim
    ``dim`` over its mesh."""
    n = 1
    for i, p in enumerate(spec.placements):
        if getattr(p, "dim", None) == dim and p.is_shard():
            n *= spec.mesh.size(i)
    return n
