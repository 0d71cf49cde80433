"""Multi-pod dry run: every (architecture x input shape x mesh) step
measured on the production meshes, on one host (the JAX package's
``launch/dryrun.py``).

JAX lowers and compiles each step against 256 or 512 placeholder TPU
devices.  The port runs it: a ``"fake"`` process group of 256 ranks
(16 x 16) or 512 (2 x 16 x 16) in this one process, the mesh from
``mesh.make_production_mesh``, the parameters, caches and inputs from
``specs`` as ``DTensor``s whose local shards are ``meta`` tensors
(``steps.build``), and the step run once under ``cost_analysis.CostMode``
and ``implicit_replication()`` (the model's constants, such as ``rope``'s
frequencies, are plain tensors, taken as replicated).  The fake group
moves no data and no card is touched: the figures are rank 0's, modelled
from shapes.  The kernels run as their custom operators' fake bodies
(``kernels/custom_ops.py``), with their flop formulas.

Depth: the port's forward loops over layers in Python, so a deep step
runs at two and at three repeats of the block pattern
(``steps.with_repeats``; the first repeat meets the embedding's
placements, so it is no steady repeat), and flops, collectives, resident
bytes and the peak extend linearly to the model's repeats (JAX
multiplies its loop bodies by their trip counts).  The tests hold the
extension to a full-depth run.

Per combination this records, per rank (one card):
  * ``flops``: what the rank's operators count (``CostMode``);
  * ``bytes_accessed``: the analytical traffic model (as JAX's);
  * ``collective_bytes`` / ``_detail`` / ``_counts`` by JAX's kind;
  * ``model_flops``: the global 6·N·D / 2·N·D;
  * ``resident_bytes_per_chip``: the local bytes of the arguments and the
    outputs, each storage once (a donated argument the step writes in
    place is its output): exact;
  * ``peak_bytes_per_chip``: the arguments plus the peak of the storages
    the step creates, live ``meta`` storages tracked by ``CostMode``;
  * ``fits_hbm``: resident below the H100's 80 GiB (JAX's ``fits_16g``);
  * ``roofline``: ``cost_analysis.Roofline`` on the H100's rates.

Results land in ``<out>/<arch>__<shape>__<mesh>.json`` and a summary on
stdout.  Runs on the host only, by design (no ``device`` argument).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from .. import configs
from ..models.config import ModelConfig
from . import cost_analysis as C
from . import specs as S
from . import steps
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def analytical_bytes_per_chip(cfg: ModelConfig, shape: S.ShapeSpec,
                              n_chips: int, mesh) -> float:
    """Per-chip HBM traffic for one step, from the workload model (JAX's
    formula, framework-free):
      decode:  resident weight shard + KV shard read once per step
      prefill: weight shard + KV write + 2x activations per layer
      train:   3x prefill compute traffic + optimizer state update
    """
    model_axis = _axis(mesh, "model")
    w_bytes = cfg.active_param_count() * 2
    w_chip = w_bytes / (n_chips if cfg.fsdp_weights else model_axis)
    if cfg.replicate_small():
        w_chip = w_bytes
    kv_len = cfg.kv_cache_len(shape.seq_len)
    kv_total = cfg.kv_bytes_per_token() * kv_len * shape.global_batch
    kv_chip = kv_total / n_chips
    if shape.kind == "decode":
        return w_chip + kv_chip
    toks_chip = shape.global_batch * shape.seq_len / max(
        n_chips / model_axis, 1)
    act_chip = toks_chip * cfg.d_model * 2 * 4 * cfg.n_layers / model_axis
    if shape.kind == "prefill":
        return w_chip + 2 * kv_chip + act_chip
    # train: fwd + 2x bwd activation traffic + Adam state (14 B/param)
    opt_chip = cfg.param_count() * 14 / (n_chips if cfg.fsdp_weights
                                         else model_axis)
    return 3 * (w_chip + act_chip) + opt_chip


def model_flops(cfg: ModelConfig, shape: S.ShapeSpec) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (N = active)."""
    n = cfg.active_param_count()
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d_tokens


def _axis(mesh, name: str) -> int:
    from .mesh import axis_sizes
    return axis_sizes(mesh)[name]


# ---------------------------------------------------------------------------
# The fake group and one measured run
# ---------------------------------------------------------------------------

def fake_group(world_size: int) -> None:
    """The default process group as a ``"fake"`` group of ``world_size``
    ranks, this process rank 0 (one in place of another size is torn
    down).  Collectives on it move nothing."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (backend)
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


@dataclasses.dataclass
class Figures:
    """One rank's figures of one step (``measure``)."""
    flops: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    resident_bytes: float
    argument_bytes: float
    peak_bytes: float

    def extend(self, deeper: "Figures", n: int) -> "Figures":
        """``self`` at some depth, ``deeper`` one repeat deeper: the
        figures ``n`` repeats past ``self``'s, extended linearly."""
        def lin(a, b):
            return a + n * (b - a)
        return Figures(
            lin(self.flops, deeper.flops),
            {k: lin(v, deeper.collective_bytes[k])
             for k, v in self.collective_bytes.items()},
            {k: lin(v, deeper.collective_counts[k])
             for k, v in self.collective_counts.items()},
            lin(self.resident_bytes, deeper.resident_bytes),
            lin(self.argument_bytes, deeper.argument_bytes),
            lin(self.peak_bytes, deeper.peak_bytes))


def measure(step: steps.Step) -> Figures:
    """Run ``step`` once under ``CostMode`` and return this rank's
    figures.  Works on ``meta`` shards over a fake group and on real
    shards over a real one alike."""
    from torch.distributed.tensor.experimental import implicit_replication
    args = C.storages(step.args)
    args_bytes = sum(args.values())
    mode = C.CostMode()
    # a train step enables grad for its own backward
    with torch.no_grad(), implicit_replication(), C.EvenViews(), mode:
        out = step.fn(*step.args)
    # outputs the step wrote in place are its arguments' storages
    out_bytes = sum(n for k, n in C.storages(out).items() if k not in args)
    return Figures(float(mode.flops), dict(mode.collective_bytes),
                   dict(mode.collective_counts),
                   float(args_bytes + out_bytes), float(args_bytes),
                   float(args_bytes + mode.peak))


def measure_depth(build: Callable[[ModelConfig], steps.Step],
                  cfg: ModelConfig):
    """(the figures of the step ``build(cfg)`` at ``cfg``'s depth; the
    config the step runs, at that depth).  Up to three repeats of the
    pattern run as they are; deeper stacks run at two and at three
    repeats and extend linearly: the first repeat meets the embedding's
    placements, every later one its predecessor's, so from the second on
    each repeat adds the same figures."""
    n_rep = steps.n_repeats(cfg)
    step = build(steps.with_repeats(cfg, n_rep if n_rep <= 3 else 2))
    first = measure(step)
    scfg = dataclasses.replace(step.cfg, n_layers=cfg.n_layers)
    if n_rep <= 3:
        return first, scfg
    three = measure(build(steps.with_repeats(cfg, 3)))
    return first.extend(three, n_rep - 2), scfg


def run_one(arch: str, shape_name: str, mesh_kind: str,
            out_dir: str = OUT_DIR, verbose: bool = True,
            knobs: Optional[Dict[str, Any]] = None) -> dict:
    """One combination on the production mesh (``mesh_kind`` "single":
    16 x 16, "multi": 2 x 16 x 16) over a fake group; the record is
    written to ``out_dir`` and returned."""
    cfg0 = configs.get(arch)
    shape = S.SHAPES[shape_name]
    cfg = S.arch_for_shape(cfg0, shape)
    multi = mesh_kind == "multi"
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    n_chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "n_chips": int(n_chips), "variant": cfg.name, "ok": False}
    t0 = time.time()
    try:
        fig, scfg = figures(cfg0, shape, mesh, **(knobs or {}))
        byts = analytical_bytes_per_chip(scfg, shape, int(n_chips), mesh)
        rec.update(record(fig, scfg, shape, byts))
        rec["run_s"] = time.time() - t0
        roof = C.Roofline(arch, shape_name, mesh_kind, int(n_chips),
                          fig.flops, byts, sum(fig.collective_bytes.values()),
                          rec["model_flops"], fig.peak_bytes)
        rec["roofline"] = roof.as_dict()
        rec["ok"] = True
        if verbose:
            print(f"  OK   {arch:24}{shape_name:13}{mesh_kind:7}"
                  f" run={rec['run_s']:6.1f}s"
                  f" resident={fig.resident_bytes / 2**30:7.2f}GiB"
                  f" peak={fig.peak_bytes / 2**30:7.2f}GiB"
                  f" fits={rec['fits_hbm']}"
                  f" bottleneck={roof.bottleneck}", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["run_s"] = time.time() - t0
        if verbose:
            print(f"  FAIL {arch:24}{shape_name:13}{mesh_kind:7} "
                  f"{rec['error'][:120]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def figures(cfg0: ModelConfig, shape: S.ShapeSpec, mesh, **knobs):
    """(per-rank ``Figures`` at full depth, the config the step runs) of
    ``steps.build(cfg0, shape, mesh, **knobs)``."""
    small = S.arch_for_shape(cfg0, shape).replicate_small()
    return measure_depth(lambda c: steps.build(c, shape, mesh,
                                               replicate=small, **knobs),
                         cfg0)


def record(fig: Figures, cfg: ModelConfig, shape: S.ShapeSpec,
           byts: float) -> Dict[str, Any]:
    """The JSON fields of one measured combination (JAX's keys where
    they mean something here)."""
    return {
        "flops": fig.flops,
        "bytes_accessed": byts,
        "collective_bytes": sum(fig.collective_bytes.values()),
        "collective_detail": fig.collective_bytes,
        "collective_counts": fig.collective_counts,
        "model_flops": model_flops(cfg, shape),
        "resident_bytes_per_chip": fig.resident_bytes,
        "argument_bytes_per_chip": fig.argument_bytes,
        "peak_bytes_per_chip": fig.peak_bytes,
        "fits_hbm": bool(fig.resident_bytes < C.HBM_BYTES),
        "fits_hbm_with_peak": bool(fig.peak_bytes < C.HBM_BYTES),
        "loop_trips": [steps.n_repeats(cfg)],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="one architecture (default: all assigned)")
    ap.add_argument("--shape", default=None,
                    help="one shape (default: all four)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    archs = [args.arch] if args.arch else configs.names(assigned_only=True)
    shapes = [args.shape] if args.shape else list(S.SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    n_fail = 0
    for mesh_kind in meshes:
        print(f"=== mesh {mesh_kind} "
              f"({'2x16x16' if mesh_kind == 'multi' else '16x16'}) ===",
              flush=True)
        for arch in archs:
            for shape in shapes:
                rec = run_one(arch, shape, mesh_kind, args.out)
                n_fail += 0 if rec["ok"] else 1
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
