"""Train a reduced xLSTM on the synthetic LM task with checkpointing, on
the PyTorch port: the data pipeline, AdamW + schedule, microbatched
gradient accumulation and a checkpoint save/restore (the port of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 120] \\
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import torch

from repro_torch import configs
from repro_torch import device as D
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import named_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    cfg = configs.get(args.arch).smoke()
    params = T.init(cfg, seed=0, device=dev)
    print(f"training {cfg.name}: {cfg.param_count():,} params on {dev}")
    ocfg = O.AdamWConfig(lr=2e-3, warmup_steps=args.steps // 10,
                         total_steps=args.steps)
    ostate = O.init_state(params)
    step = make_train_step(cfg, ocfg, num_microbatches=2)
    data = iter(SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, seed=0)))

    t0 = time.time()
    first = last = None
    for i in range(1, args.steps + 1):
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        params, ostate, m = step(params, ostate, batch)
        loss = float(m["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 20 == 0 or i == 1:
            print(f"step {i:4d} loss {loss:.4f} "
                  f"lr {float(m['lr']):.2e} "
                  f"({(time.time() - t0) / i * 1e3:.0f} ms/step)")

    with tempfile.TemporaryDirectory() as d:
        C.save(d, params, step=args.steps, meta={"arch": cfg.name})
        restored, st = C.restore(d, params)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            named_leaves(params), named_leaves(restored)))
        assert st == args.steps and same
        print(f"checkpoint round-trip at step {st}: OK")
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first


if __name__ == "__main__":
    main()
