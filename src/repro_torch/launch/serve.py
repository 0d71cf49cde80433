"""Serving CLI of the port: the streaming front door over either
backend, with the JAX package's ``launch/serve.py`` flags plus
``--device``.

    # analytical cluster simulation (no model compute, paper-scale configs)
    python -m repro_torch.launch.serve --backend sim --smoke

    # live disaggregated fleet over the real model on the card (virtual
    # clock, billed on the H100's data sheet)
    python -m repro_torch.launch.serve --backend live --arch llama-13b \\
        --requests 8 --max-new 16 --max-len 1024 --autoscale \\
        --profiles h100_sxm

    # the same at the arch's smoke size on the CPU
    python -m repro_torch.launch.serve --backend live --smoke --device cpu

Both backends are driven through ``serving.api.Server``: submit / stream
/ abort / drain.  ``--closed-loop K`` switches the workload from
open-loop Poisson arrivals to ``K`` fixed-concurrency clients (each
completion triggers the next submission); ``--admission-limit M`` bounds
in-flight requests, with overflow REJECTED and reported in the summary.

``--device`` defaults to the CUDA card; without one the CLI raises unless
``--device cpu`` is given.  The live backend draws its weights with
``models.transformer.init`` from seed 0 on that device, in bfloat16 on the
card and float32 on the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .. import configs
from .. import device as D
from ..serving.api import Server
from ..serving.workload import ClosedLoopClients, WorkloadConfig, generate


def _build_live(args, device):
    import torch

    from ..core import analytical as A
    from ..models import transformer as T
    from ..serving.engine import EngineConfig
    from ..serving.orchestrator import Orchestrator, OrchestratorConfig

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    print(f"live backend: arch={cfg.name} params={cfg.param_count():,}")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = T.init(cfg, seed=0, dtype=dtype, device=device)
    ecfg = EngineConfig(max_len=args.max_len, max_batch=args.max_batch,
                        block_size=16, speculation=args.speculation)
    draft = None
    if args.speculation == "draft":
        # the arch's smoke shrink as the small draft stack: same token
        # space, a fraction of the layers and width
        dcfg = configs.get(args.arch).smoke()
        draft = (dcfg, params if dcfg == cfg
                 else T.init(dcfg, seed=1, dtype=dtype, device=device))
        print(f"draft model: {dcfg.name} params={dcfg.param_count():,}")
    hw = A.H100_SXM
    # --rps is in arrivals per decode-iteration time, so the offered load
    # is meaningful at any model scale on the virtual clock
    t_iter = A.decode_iter_time(cfg, args.max_len, hw, batch=args.max_batch)
    wl = WorkloadConfig(kind="synthetic", rps=args.rps / t_iter,
                        n_requests=args.requests, vocab_size=cfg.vocab_size,
                        max_new_tokens=args.max_new,
                        prefix_share=args.prefix_share, n_prefix_groups=2,
                        prompt_len_lo=16,
                        prompt_len_hi=min(64, args.max_len // 2))
    orch = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=args.prefill, n_decode=args.decode, engine=ecfg, hw=hw,
        chunk_tokens=32), device=device, draft=draft)
    return orch, wl, 1e6  # report in virtual microseconds


def _build_sim(args, device):
    import dataclasses

    from ..serving.cluster import ClusterSim, SimConfig

    model = configs.get(args.arch)
    print(f"sim backend: system={args.system} model={model.name} "
          f"({args.instances} instances)")
    n = args.requests if not args.smoke else min(args.requests, 16)
    wl = WorkloadConfig(kind=args.workload, rps=args.rps,
                        n_requests=n, max_new_tokens=args.max_new,
                        prefix_share=args.prefix_share)
    scfg = SimConfig.preset(model, args.system, n_instances=args.instances)
    if args.speculation != "off":
        scfg = dataclasses.replace(
            scfg, speculation=args.speculation,
            draft_model=(model.smoke() if args.speculation == "draft"
                         else None))
    sim = ClusterSim(scfg)
    return sim, wl, 1.0    # report in seconds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the final summary."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", choices=("live", "sim"), default="live")
    ap.add_argument("--device", default=None,
                    help="torch device of the live fleet (default: the "
                         "CUDA card; 'cpu' must be asked for)")
    ap.add_argument("--arch", default="llama-13b")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-sized model (live) / shrunken workload (sim)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rps", type=float, default=2.0,
                    help="live: arrivals per decode-iteration time; "
                         "sim: arrivals/s")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefix-share", type=float, default=0.6)
    ap.add_argument("--prefill", type=int, default=2)
    ap.add_argument("--decode", type=int, default=2)
    ap.add_argument("--system", default="banaserve",
                    choices=("banaserve", "distserve", "vllm"))
    ap.add_argument("--workload", default="alpaca",
                    choices=("alpaca", "longbench", "synthetic"))
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--closed-loop", type=int, default=0, metavar="K",
                    help="K fixed-concurrency clients instead of "
                         "open-loop Poisson arrivals")
    ap.add_argument("--admission-limit", type=int, default=None,
                    help="max requests in flight; overflow is REJECTED")
    ap.add_argument("--speculation", choices=("off", "ngram", "draft"),
                    default="off",
                    help="multi-token speculative decoding on decode units "
                         "(live: exact verify on the paged KV; sim: "
                         "analytical twin); 'draft' uses the arch's smoke "
                         "shrink as the draft model")
    ap.add_argument("--autoscale", action="store_true",
                    help="SLO-driven elastic prefill/decode tiers: scale-up "
                         "bills warm-up on the virtual clock, scale-down "
                         "drains in-flight requests before retiring")
    ap.add_argument("--profiles", default=None, metavar="P1,P2",
                    help="hardware menu for autoscaled instances, e.g. "
                         "h100_sxm,a100_80g (see core.analytical.PROFILES); "
                         "decode orders land on the highest-HBM-bw part, "
                         "prefill on the highest-FLOPs part")
    args = ap.parse_args(argv)
    device = D.resolve(args.device)
    backend, wl, tscale = (_build_live if args.backend == "live"
                           else _build_sim)(args, device)
    autoscaler = None
    if args.autoscale:
        from ..core import analytical as A
        from ..serving.autoscale import AutoscaleConfig
        menu = (tuple(A.PROFILES[p] for p in args.profiles.split(","))
                if args.profiles else None)
        autoscaler = AutoscaleConfig(profiles=menu)
    server = Server(backend, admission_limit=args.admission_limit,
                    autoscaler=autoscaler)
    print(f"fleet: {server.fleet}")

    def pump() -> None:
        """Print each request's first-token and terminal stream events."""
        for h in server.handles.values():
            for ev in h.events():
                r = h.request
                if ev.kind == "token" and ev.index == 0:
                    print(f"req {r.rid:3d} first token @ "
                          f"{ev.t * tscale:10.2f} "
                          f"(ttft {r.ttft * tscale:8.2f})")
                elif ev.kind in ("completed", "aborted", "rejected"):
                    print(f"req {r.rid:3d} {ev.kind:9s} prompt="
                          f"{r.prompt_len:4d} out={len(r.generated):3d} "
                          f"cached={r.cached_tokens:3d}")

    if args.closed_loop:
        clients = ClosedLoopClients(wl, n_clients=args.closed_loop)
        s = server.run_closed_loop(clients)
        pump()
    else:
        for r in generate(wl):
            server.submit(r, at=r.arrival)
        while server.in_flight() and server.backend.clock:
            server.step()
            pump()
        server.drain()
        pump()
        s = server.summary()

    unit = "us" if tscale == 1e6 else "s"
    print(f"\n== {s['n_requests']} completed / {s['n_rejected']} rejected "
          f"/ {s['n_aborted']} aborted of {s['n_submitted']} submitted")
    print(f"throughput={s['throughput_tok_s']:.1f} tok/s  "
          f"mean_ttft={s['mean_ttft_s'] * tscale:.2f}{unit}  "
          f"p99_ttft={s['p99_ttft_s'] * tscale:.2f}{unit}  "
          f"mean_tpot={s['mean_tpot_s'] * tscale:.3f}{unit}")
    if s.get("speculation", "off") != "off":
        acc = s.get("acceptance_rate")
        tpi = s.get("tokens_per_decode_iter")
        print(f"speculation={s['speculation']}  "
              f"tokens/iter={'n/a' if tpi is None else f'{tpi:.2f}'}  "
              f"acceptance={'n/a' if acc is None else f'{acc:.2f}'}  "
              f"spec_iters={s.get('spec_iters', 0)} "
              f"plain_iters={s.get('spec_plain_iters', 0)}")
    if args.autoscale:
        print(f"autoscale: {s.get('autoscale_decisions', 0)} decisions, "
              f"{s.get('n_retired', 0)} instances retired")
    print(f"fleet now: {server.fleet}")
    return s


if __name__ == "__main__":
    main()
