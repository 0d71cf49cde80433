"""Quickstart on the PyTorch port: the BanaServe stack in one minute (the
port of ``examples/quickstart.py``).

1. Build a tiny dense model.
2. Train it for 30 steps (loss goes down).
3. Serve two requests through the disaggregated path: prefill engine ->
   Global KV Cache Store -> decode engine; the second request reuses the
   first one's prefix KV (incremental prefill).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core.kvstore import GlobalKVStore
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine)
from repro_torch.serving.request import Request
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    cfg = ModelConfig(name="tiny", family=Family.DENSE, n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab_size=256)
    params = T.init(cfg, seed=0, device=dev)
    print(f"model: {cfg.name}, {cfg.param_count():,} params on {dev}")

    # -- 2. train ---------------------------------------------------------
    step = make_train_step(
        cfg, O.AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps))
    ostate = O.init_state(params)
    data = iter(SyntheticTokens(DataConfig(vocab_size=256, seq_len=32,
                                           global_batch=8)))
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        params, ostate, m = step(params, ostate, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  train step {i:2d}  loss {float(m['loss']):.3f}")

    # -- 3. serve ----------------------------------------------------------
    store = GlobalKVStore(block_size=8)
    ecfg = EngineConfig(max_len=128, max_batch=4, block_size=8)
    pe = PrefillEngine(cfg, params, ecfg, store, device=dev)
    de = DecodeEngine(cfg, params, ecfg, device=dev)
    rng = np.random.default_rng(0)
    shared_prefix = rng.integers(0, 256, 24, dtype=np.int32)
    for rid in range(2):
        prompt = np.concatenate(
            [shared_prefix, rng.integers(0, 256, 8, dtype=np.int32)])
        req = Request(rid=rid, arrival=0.0, prompt=prompt, max_new_tokens=8)
        state, logits = pe.run(req)
        de.insert(req, state, int(torch.argmax(logits)))
        while de.active:
            de.step()
        print(f"  request {rid}: cached_prefix={req.cached_tokens} tokens, "
              f"generated {req.generated}")
    print(f"global KV store: {len(store)} blocks, "
          f"hit rate {store.stats.hit_rate:.2f}")
    assert store.stats.hit_rate > 0, "second request should hit the store"
    print("OK")


if __name__ == "__main__":
    main()
