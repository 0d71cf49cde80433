"""Assigned input shapes and their stand-ins (the JAX package's
``launch/specs.py``).

Shapes:
    train_4k       seq_len=4,096    global_batch=256   (training)
    prefill_32k    seq_len=32,768   global_batch=32    (inference-prefill)
    decode_32k     seq_len=32,768   global_batch=128   (inference-decode)
    long_500k      seq_len=524,288  global_batch=1     (long-context-decode)

Decode shapes are ONE new token against a seq_len-deep cache.
``long_500k`` needs sub-quadratic attention: hybrid and SSM stacks run
natively, the others their sliding-window variant (window 8192).

Nothing is allocated: the stand-ins are tensors on the ``meta`` device
(JAX's ``ShapeDtypeStruct`` from ``jax.eval_shape``), built by the port's
own ``T.init`` and ``T.init_cache``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models import transformer as T
from ..models.config import ModelConfig

LONG_WINDOW = 8192
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def arch_for_shape(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """long_500k needs sub-quadratic attention: dense/moe/vlm/audio stacks
    switch to their sliding-window variant; hybrid/ssm run natively."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return cfg.with_sliding_window(LONG_WINDOW)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16):
    """The full parameter tree on ``meta`` (no allocation)."""
    return T.init(cfg, seed=0, dtype=dtype, device=META)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16):
    """The dense serving cache on ``meta``."""
    return T.init_cache(cfg, batch, max_len, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Stand-ins for every input of the step: tokens, the cache and, for a
    cross-attention stack, the frames."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["batch"] = {"tokens": _meta((b, s + 1), torch.int32)}
        if cfg.cross_attention:
            out["batch"]["frames"] = _meta((b, cfg.n_frames, cfg.d_model),
                                           dtype)
        return out
    # prefill: the whole sequence; decode: one new token against a
    # seq_len-deep cache
    out["tokens"] = _meta((b, s if shape.kind == "prefill" else 1),
                          torch.int32)
    out["cache"] = cache_shapes(cfg, b, s, dtype)
    if cfg.cross_attention:
        out["frames"] = _meta((b, cfg.n_frames, cfg.d_model), dtype)
    return out
