"""Training entry point of the port: real steps on the card (or the CPU with
``--device cpu``), with the JAX package's ``launch/train.py`` flags plus
``--device``, and its log line.

    python -m repro_torch.launch.train --arch gemma-7b --smoke \\
        --steps 200 --batch 8 --seq 128 --device cpu

``--device`` defaults to the CUDA card; without one the command raises
unless ``--device cpu`` is given.  The weights come from
``models.transformer.init`` at seed 0 on that device, in bfloat16 on the
card (JAX's production train dtype, ``launch/steps.py``) and float32 on
the CPU; the steps run eagerly.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from .. import configs
from .. import device as D
from ..data.pipeline import DataConfig, SyntheticTokens
from ..models import transformer as T
from ..training import checkpoint as C
from ..training import optimizer as O
from ..training.train_step import make_train_step


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-13b")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    print(f"arch={cfg.name} params={cfg.param_count():,}")

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = T.init(cfg, seed=0, dtype=dtype, device=dev)
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                            total_steps=args.steps)
    opt_state = O.init_state(params)
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches)
    data = iter(SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch)))

    t0 = time.time()
    for step in range(1, args.steps + 1):
        raw = next(data)
        batch = {"tokens": torch.from_numpy(raw["tokens"]).to(dev)}
        if cfg.cross_attention:
            batch["frames"] = torch.zeros(
                (args.batch, cfg.n_frames, cfg.d_model), dtype=dtype,
                device=dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                  f"nll {float(m['nll']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"({(time.time() - t0) / step * 1e3:.0f} ms/step)")
    if args.ckpt:
        C.save(args.ckpt, params, step=args.steps,
               meta={"arch": cfg.name})
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
