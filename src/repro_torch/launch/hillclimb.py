"""The hillclimb runner: one (arch x shape) step under a named variant,
measured as the dry run measures it (the JAX package's
``launch/hillclimb.py``), into ``<out>/<arch>__<shape>__<variant>.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch llama3-405b --shape decode_32k --variant kv_int8

``VARIANTS`` has JAX's keys and knobs.  The ``pipeline*`` variants run
``pipeline_decode.build_pipeline_decode`` over the mesh's "data" axis
(decode only): plain tensors, not ``DTensor``s, each rank reading its
stage's layers of the padded trees, so the resident bytes are the
stage's share, counted from the trees.  The traffic model takes JAX's
corrections: int8 weights halve the weight bytes, an int8 cache halves
the KV reads.  Host only, like the dry run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from .. import configs
from ..models import quant as Q
from ..training.tree import named_leaves
from . import cost_analysis as C
from . import dryrun as DR
from . import specs as S
from . import steps
from .mesh import axis_sizes, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "perf_torch")

VARIANTS = {
    "baseline": {},
    "kv_int8": {"kv_quant": True},
    "logits_sharded": {"shard_logits": True},
    "kv_int8+logits_sharded": {"kv_quant": True, "shard_logits": True},
    "w_int8": {"weight_quant": True},
    "w_int8+kv_int8": {"weight_quant": True, "kv_quant": True},
    "w_int8+kv_int8+logits_sharded": {"weight_quant": True,
                                      "kv_quant": True,
                                      "shard_logits": True},
    "moe_dense": {"moe_impl": "dense"},
    "moe_local_sorted": {"moe_impl": "local_sorted"},
    "moe_local+w_int8": {"moe_impl": "local_sorted", "weight_quant": True},
    "pipeline": {"pipeline": True},
    "pipeline+kv_int8": {"pipeline": True, "kv_quant": True},
    "pipeline+kv_int8+w_int8": {"pipeline": True, "kv_quant": True,
                                "weight_quant": True},
    "moe_sorted_cf1": {"moe_cf": 1.0},
    "moe_sorted_cf2": {"moe_cf": 2.0},
    "moe_nodrop": {"moe_cf": None},
}


def _pipeline_figures(cfg0, shape, mesh, knobs):
    """(figures, config) of the pipelined decode step: the stages along
    "data", this rank's stage measured at full depth."""
    from .pipeline_decode import (build_pipeline_decode, pad_stacked_cache,
                                  pad_stacked_params)
    if shape.kind != "decode":
        raise ValueError("pipeline variants are decode steps")
    cfg = S.arch_for_shape(cfg0, shape)
    if knobs.get("kv_quant"):
        cfg = cfg.with_kv_quant()
    cfg = dataclasses.replace(cfg, fsdp_weights=False)
    fn, per_stage, n_pad = build_pipeline_decode(cfg, mesh,
                                                 shape.global_batch)
    params = pad_stacked_params(cfg, S.param_shapes(cfg, torch.bfloat16),
                                n_pad)
    if knobs.get("weight_quant"):
        params = Q.quantize_weights(params)
    cache = pad_stacked_cache(S.cache_shapes(
        cfg, shape.global_batch, shape.seq_len, torch.bfloat16), n_pad)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                         device="meta")
    # plain tensors: the stages cut their layers themselves
    step = steps.Step(fn, (params, tokens, cache), (None, None), (2,), cfg)
    fig = DR.measure(step)
    # every rank holds the padded trees' global shapes as views; it owns
    # its stage's layers of the stacked group and the whole of the rest
    depth = per_stage * axis_sizes(mesh)["data"]
    resident = 0
    for tree in (params, cache):
        for name, a in named_leaves(tree):
            n = a.numel() * a.element_size()
            resident += n * per_stage // depth \
                if name.startswith("groups") else n
    resident += tokens.numel() * tokens.element_size()
    fig.peak_bytes += resident - fig.argument_bytes
    fig.resident_bytes += resident - fig.argument_bytes
    fig.argument_bytes = resident
    return fig, cfg


def run_variant(arch: str, shape_name: str, variant: str,
                mesh_kind: str = "single", out_dir: str = OUT_DIR) -> dict:
    cfg0 = configs.get(arch)
    shape = S.SHAPES[shape_name]
    knobs = VARIANTS[variant]
    multi = mesh_kind == "multi"
    DR.fake_group(512 if multi else 256)
    # the pipeline's stages take the "data" dim's group: three mesh dims
    mesh = make_production_mesh(multi_pod=multi,
                                flat=not knobs.get("pipeline"))
    n_chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": mesh_kind, "ok": False}
    t0 = time.time()
    try:
        if knobs.get("pipeline"):
            fig, cfg = _pipeline_figures(cfg0, shape, mesh, knobs)
        else:
            fig, cfg = DR.figures(cfg0, shape, mesh, **knobs)
        byts = DR.analytical_bytes_per_chip(cfg, shape, n_chips, mesh)
        if knobs.get("weight_quant"):
            # int8 weights: resident + read traffic of weights halve
            w_chip = cfg.active_param_count() * 2 / (
                n_chips if cfg.fsdp_weights else axis_sizes(mesh)["model"])
            byts -= 0.5 * w_chip
        if knobs.get("kv_quant") and shape.kind != "train":
            # int8 cache: KV reads halve (scales are ~1% of payload)
            kv_len = cfg.kv_cache_len(shape.seq_len)
            kv_total = cfg.kv_bytes_per_token() * kv_len * shape.global_batch
            byts -= 0.5 * kv_total / n_chips
        roof = C.Roofline(arch, shape_name, mesh_kind, n_chips, fig.flops,
                          byts, sum(fig.collective_bytes.values()),
                          DR.model_flops(cfg, shape), fig.resident_bytes)
        rec.update({
            "ok": True, "run_s": time.time() - t0,
            "resident_bytes_per_chip": fig.resident_bytes,
            "peak_bytes_per_chip": fig.peak_bytes,
            "collective_detail": fig.collective_bytes,
            "collective_counts": fig.collective_counts,
            "roofline": roof.as_dict(),
        })
        ro = rec["roofline"]
        print(f"{arch} {shape_name} [{variant:24}] "
              f"comp={ro['t_compute_s'] * 1e3:7.3f}ms "
              f"mem={ro['t_memory_s'] * 1e3:7.3f}ms "
              f"coll={ro['t_collective_s'] * 1e3:7.3f}ms "
              f"resident={fig.resident_bytes / 2**30:6.2f}GiB "
              f"bottleneck={ro['bottleneck']}", flush=True)
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-1500:]
        print(f"{arch} {shape_name} [{variant}] FAIL {rec['error'][:100]}",
              flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(
            out_dir, f"{arch}__{shape_name}__{variant}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()
    rec = run_variant(args.arch, args.shape, args.variant, args.mesh,
                      args.out)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
