"""Per-rank cost tables of one step: flops, collective bytes, memory and
the roofline terms (the port's counterpart of the JAX package's
``launch/hlo_analysis.py``).

JAX lowers a step through XLA and reads the per-device program's text:
its dot flops, its collective instructions' output shapes, the compiled
memory analysis.  PyTorch has no such program, so the port runs the step
once with ``DTensor`` arguments under ``CostMode``, a dispatch mode that
sees what each rank runs on its local shards:

* ``CostMode`` declines every ``DTensor`` operator (it returns
  ``NotImplemented``), so ``DTensor`` decides the placements, inserts the
  collectives and calls the operators on its local tensors, which reach
  the mode.  The mode counts those: what one rank executes.  The
  operators ``DTensor``'s sharding propagation runs on fake global
  tensors are skipped.
* Flops: the formula ``torch.utils.flop_counter`` registers for the
  operator (matmuls, attention, convolutions, and the port's kernels,
  ``kernels/custom_ops.py``), on the local shapes; the same registry
  ``FlopCounterMode`` reads.
* Collectives: each ``_c10d_functional`` or ``c10d`` collective the rank
  issues, counted and sized by the bytes of its output tensor, as JAX's
  ``parse_collectives`` sizes an instruction by its output shape
  (send/recv as ``collective-permute``).
* Memory: the storages the step creates, live (freed when their last
  view dies) and at their peak.  A collective's autograd wrapper
  (``_c10d_functional._wrap_tensor_autograd``) adds no bytes but keeps
  the collective's output counted while it lives: on ``meta`` it is a new
  empty tensor that the next op reads in place of the output.

The mode runs as it is on ``meta`` shards over a ``"fake"`` process group
(``launch/dryrun.py``: the 256- and 512-rank meshes on one host) and on
real shards over gloo or NCCL (the tests and the smoke hold the two
equal).  ``parse_collectives`` has no counterpart: there is no program
text.

``Roofline`` carries JAX's fields and ``as_dict`` keys, with the H100's
rates from ``core/analytical.H100_SXM`` (989e12 flop/s in bf16, 3.35e12
B/s of HBM, 450e9 B/s of NVLink per card) in place of JAX's TPU
constants.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core.analytical import H100_SXM

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# operator (namespace.name, without the overload) -> JAX's collective kind
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "all-reduce",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}


def _is_dtensor_type(t) -> bool:
    return t.__name__ == "DTensor"


def _fake_active() -> bool:
    """A ``FakeTensorMode`` is running (``DTensor``'s sharding
    propagation on fake global tensors): not the rank's work."""
    key = torch._C._TorchDispatchModeKey.FAKE
    return torch._C._get_dispatch_mode(key) is not None


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts what one rank runs (see the module docstring): ``flops``,
    ``collective_bytes``/``collective_counts`` by JAX's kind, the bytes of
    the storages the step created that are ``live`` now and their
    ``peak``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collective_bytes: Dict[str, float] = {k: 0.0
                                                   for k in COLLECTIVES}
        self.collective_counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _fake_active() or any(t.__name__ == "FakeTensor" for t in types):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = packet._qualified_op_name.replace("::", ".")
        kind = _KIND.get(name)
        if kind is not None:
            # the c10d operators write into (or send) their first
            # argument's tensors; the functional ones return theirs
            moved = args[0] if name.startswith("c10d.") else out
            self.collective_bytes[kind] += sum(_nbytes(t)
                                               for t in _tensors(moved))
            self.collective_counts[kind] += 1
        if name == "_c10d_functional._wrap_tensor_autograd":
            # a wrapper of the collective's output: no buffer of its own,
            # but it keeps that output's alive (its meta kernel returns a
            # new empty tensor standing in for it)
            self._hold(args[0], out)
            return out
        # new storages only: an in-place op returns its input, a view op a
        # view of it
        ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            if t.untyped_storage()._cdata not in ins:
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        group = self._seen[key] = [st.nbytes(), 1]    # bytes, holders
        self.live += group[0]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, group)

    def _hold(self, t: torch.Tensor, wrapper: torch.Tensor) -> None:
        """``wrapper`` (another storage) keeps ``t``'s bytes counted."""
        group = self._seen.get(t.untyped_storage()._cdata)
        if group is not None:
            group[1] += 1
            weakref.finalize(wrapper.untyped_storage(), self._free, None,
                             group)

    def _free(self, key: Optional[int], group: list) -> None:
        if key is not None:
            self._seen.pop(key, None)
        group[1] -= 1
        if group[1] == 0:
            self.live -= group[0]


# ---------------------------------------------------------------------------
# Views of DTensors that DTensor's own propagation refuses
# ---------------------------------------------------------------------------

def _groups(src, dst):
    """The dims of ``src`` and ``dst`` (two shapes of one numel) that a
    view merges or splits together: [(src dims, dst dims), ...]."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        if i == len(src):
            out.append(([], list(range(j, len(dst)))))
            break
        if j == len(dst):
            out.append((list(range(i, len(src))), []))
            break
        gi, gj, pi, pj = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(i)
                pi *= src[i]
                i += 1
            else:
                gj.append(j)
                pj *= dst[j]
                j += 1
        out.append((gi, gj))
    return out


def view_placements(t, shape) -> list:
    """Placements of the ``DTensor`` ``t`` under which its view as
    ``shape`` exists: a split dim stays split only where it is the
    leading non-unit dim of its group and both it and the group's leading
    out dim divide by its shards; the others replicate.  ``DTensor``
    splits dims unevenly where an input was whole (and so does the
    backward of a view), and then refuses the view."""
    from torch.distributed.tensor import Replicate
    src = list(t.shape)
    where = {}
    for gi, gj in _groups(src, list(shape)):
        for k in gi:
            where[k] = (gi, gj)
    want, shards = [], {}
    for i, p in enumerate(t.placements):
        if p.is_shard():
            k = p.dim
            n = shards.get(k, 1) * t.device_mesh.size(i)
            gi, gj = where[k]
            lead_i = next((d for d in gi if src[d] != 1), None)
            lead_j = next((d for d in gj if shape[d] != 1), None)
            if (lead_i == k and src[k] % n == 0 and lead_j is not None
                    and shape[lead_j] % n == 0):
                shards[k] = n
            else:
                p = Replicate()
        want.append(p)
    return want


class _EvenView(torch.autograd.Function):
    """``t.reshape(shape)`` of a ``DTensor``, re-placed first
    (``view_placements``) in the forward and, for the gradient's view
    back, in the backward."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.src = tuple(t.shape)
        return _placed(t, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _placed(g, ctx.src).reshape(ctx.src), None


def _placed(t, shape):
    want = view_placements(t, shape)
    return t if want == list(t.placements) else \
        t.redistribute(t.device_mesh, want)


_VIEWS = (torch.Tensor.reshape, torch.Tensor.view, torch.reshape)


class EvenViews(torch.overrides.TorchFunctionMode):
    """Routes ``reshape``/``view`` of a ``DTensor`` to sizes through
    ``_EvenView`` (the dry run's steps; the model code is unchanged)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _VIEWS and args and type(args[0]).__name__ == "DTensor" \
                and not kwargs:
            shape = args[1:]
            if len(shape) == 1 and isinstance(shape[0], (tuple, list,
                                                         torch.Size)):
                shape = tuple(shape[0])
            if all(isinstance(d, int) for d in shape):
                t = args[0]
                shape = _resolve(tuple(shape), t.numel())
                if shape != tuple(t.shape):
                    return _EvenView.apply(t, shape)
        return func(*args, **kwargs)


def _resolve(shape, numel: int):
    if -1 not in shape:
        return shape
    known = 1
    for d in shape:
        if d != -1:
            known *= d
    return tuple(numel // known if d == -1 else d for d in shape)


def storages(tree) -> Dict[int, int]:
    """The storages this rank holds for the tensors of ``tree`` (a
    ``DTensor``'s local shard): storage -> bytes, each once."""
    out: Dict[int, int] = {}
    for t in _tensors(tree):
        if type(t).__name__ == "DTensor":
            t = t.to_local()
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


# ---------------------------------------------------------------------------
# Roofline terms, on the H100 (core/analytical.H100_SXM)
# ---------------------------------------------------------------------------

PEAK_FLOPS = H100_SXM.peak_flops      # bf16 dense, per card
HBM_BW = H100_SXM.hbm_bw              # bytes/s per card
LINK_BW = H100_SXM.net_bw             # NVLink bytes/s per card
HBM_BYTES = H100_SXM.hbm_bytes        # 80 GiB


@dataclasses.dataclass
class Roofline:
    """Per-(arch, shape, mesh) roofline terms.

    ``hlo_flops``, ``hlo_bytes`` and ``collective_bytes`` are per rank
    (one card): the flops and collectives ``CostMode`` counts on the
    rank's shards, the traffic ``dryrun.analytical_bytes_per_chip``
    models.  ``model_flops`` is the global 6·N·D / 2·N·D.  The field
    names are JAX's (``hlo_*``), though no HLO is involved."""
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float               # per chip
    hlo_bytes: float               # per chip (analytical)
    collective_bytes: float        # per chip
    model_flops: float             # global
    bytes_per_chip: float          # peak device residency per chip

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.hlo_flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "bytes_per_chip": self.bytes_per_chip,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
        }
