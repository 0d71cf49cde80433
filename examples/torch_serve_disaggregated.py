"""End-to-end disaggregated serving on the PyTorch port through the
session-oriented front door (serving/api.py) over the event-driven live
orchestrator (the port of ``examples/serve_disaggregated.py``).

A gemma-family reduced model is served by a fleet of real prefill/decode
engines on the virtual clock, driven the way production systems are
driven: requests are *submitted* to a ``Server`` (open-loop — their
workload Poisson stamps are the virtual arrival times), each submission
returns a ``StreamHandle`` whose per-token events (token id + virtual
commit timestamp) and phase transitions drain as they are committed, and
one extra request is submitted mid-run while the fleet is busy to show
open-loop admission.  The run starts deliberately decode-starved
(3 prefill / 1 decode), so the Algorithm 1 controller re-rolls idle
prefill capacity into the decode tier while requests are in flight (the
executable Fig. 3).

The run reports the paper's time-domain metrics — TTFT/TPOT percentiles,
SLO attainment and goodput — and every generated sequence is then checked
token-for-token against a single-engine reference rollout: disaggregation,
chunked prefill, migration and *streaming consumption* change when and
where work runs, never what is computed.

    PYTHONPATH=src python examples/torch_serve_disaggregated.py
    PYTHONPATH=src python examples/torch_serve_disaggregated.py \
        --speculation ngram [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given, in float32 (the
model is tiny).  The virtual clock bills the H100's data-sheet roofline
(``analytical.H100_SXM``).
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import torch

from repro_torch import configs
from repro_torch import device as D
from repro_torch.core import analytical as A
from repro_torch.models import transformer as T
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import SLO, Outcome, Request
from repro_torch.serving.workload import WorkloadConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--speculation", choices=("off", "ngram", "draft"),
                    default="off",
                    help="speculative decoding on decode units; the exact "
                         "verify keeps the streamed outputs token-identical "
                         "to the plain reference either way")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    cfg = configs.get("gemma-7b").smoke()
    params = T.init(cfg, seed=0, device=dev)
    print(f"arch={cfg.name} ({cfg.param_count():,} params) on {dev}")

    ecfg = EngineConfig(max_len=160, max_batch=4, block_size=16,
                        speculation=args.speculation)
    # 'draft' here is a self-draft (the target's own params) — a degenerate
    # but deterministic draft model that demonstrates the accept-all path
    draft = (cfg, params) if args.speculation == "draft" else None
    hw = A.H100_SXM
    # saturating Poisson arrivals + SLO targets derived from the model's
    # own analytical costs, so the demo is meaningful at any model size
    t_pref = A.prefill_time(cfg, 48, hw)
    t_iter = A.decode_iter_time(cfg, ecfg.max_len, hw, batch=ecfg.max_batch)
    slo = SLO(ttft_s=8 * t_pref + 4 * t_iter, tpot_s=1.5 * t_iter)
    ocfg = OrchestratorConfig(n_prefill=3, n_decode=1, router="load_aware",
                              engine=ecfg, chunk_tokens=32, slo=slo, hw=hw)
    orch = Orchestrator(cfg, params, ocfg, draft=draft, device=dev)
    server = Server(orch)
    print(f"fleet: {server.fleet}")
    print(f"control interval: {orch.control_interval * 1e6:.2f} us "
          f"(virtual); SLO: TTFT<={slo.ttft_s * 1e6:.1f}us "
          f"TPOT<={slo.tpot_s * 1e6:.2f}us")

    wl = WorkloadConfig(kind="synthetic", rps=2.0 / t_iter, n_requests=14,
                        vocab_size=cfg.vocab_size, max_new_tokens=24,
                        prefix_share=0.7, n_prefix_groups=2, seed=1,
                        prompt_len_lo=24, prompt_len_hi=72)
    reqs = generate(wl)

    # open-loop submission: every request's Poisson stamp IS its virtual
    # arrival event; the handles stream tokens as they are committed
    handles = [server.submit(r, at=r.arrival) for r in reqs]

    # step the fleet a little, then submit one MORE request mid-run — the
    # open-loop path routes it on the next dispatch like any other arrival
    while server.now < reqs[6].arrival:
        server.step()
    rng_prompt = reqs[0].prompt[:32]
    late = Request(rid=999, arrival=0.0, prompt=rng_prompt,
                   max_new_tokens=12)
    handles.append(server.submit(late))
    print(f"\nsubmitted request 999 mid-run at t={server.now * 1e6:.2f}us "
          f"({server.in_flight()} in flight)")

    server.drain()
    s = server.summary()

    # streaming view: replay one handle's committed event stream
    h0 = handles[0]
    evs = h0.events()
    print(f"\nstream of request {h0.rid} ({len(evs)} events):")
    for ev in evs[:6]:
        what = (f"phase={ev.phase.value}" if ev.kind == "phase"
                else f"token={ev.token}")
        print(f"  t={ev.t * 1e6:8.3f}us  {ev.kind:6s} {what}")
    print(f"  ... terminal: {evs[-1].kind}")
    assert evs[-1].kind == Outcome.COMPLETED.value
    assert [e.token for e in evs if e.kind == "token"] == h0.tokens

    print("\nper-instance utilization (control cycles):")
    for i, snap in enumerate(orch.util_trace):
        row = "  ".join(f"{k}={v:.2f}" for k, v in sorted(snap.items()))
        print(f"  cycle {i}: {row}")

    print("\napplied migration actions:")
    for a in orch.migration_log:
        print(f"  {a.kind.value}: {a.src} -> {a.dst} "
              f"(benefit {a.predicted_benefit:.3f}, "
              f"cost {a.predicted_cost * 1e3:.3f} ms)")
    assert orch.migration_log, "expected at least one applied migration"

    print(f"\nfinal fleet: {server.fleet}")
    us = 1e6
    print(f"served {s['n_requests']} requests "
          f"({s['n_submitted']} submitted) in "
          f"{s['virtual_time_s'] * us:.1f} virtual us "
          f"({s['events']} events), "
          f"{s['throughput_tok_s']:.0f} tok/s virtual throughput")
    print(f"TTFT p50/p99: {s['p50_ttft_s'] * us:.2f}/"
          f"{s['p99_ttft_s'] * us:.2f} us   "
          f"TPOT p50/p99: {s['p50_tpot_s'] * us:.3f}/"
          f"{s['p99_tpot_s'] * us:.3f} us")
    print(f"SLO attainment: {s['slo_attainment']:.2f}  "
          f"goodput: {s['goodput_tok_s']:.0f} tok/s")
    print(f"store hit rate: {s['store_hit_rate']:.2f} "
          f"({s['store_entries']} blocks resident), "
          f"prefill token skew {s['prefill_token_skew']:.2f}")
    if args.speculation != "off":
        acc = s.get("acceptance_rate")
        tpi = s.get("tokens_per_decode_iter")
        print(f"speculation={args.speculation}: "
              f"tokens/decode-iter={'n/a' if tpi is None else f'{tpi:.2f}'} "
              f"acceptance={'n/a' if acc is None else f'{acc:.2f}'} "
              f"(router chose speculate on {s.get('spec_iters', 0)} "
              f"iterations, plain on {s.get('spec_plain_iters', 0)})")
        assert tpi is not None and tpi >= 1.0

    # --- exactness: streamed output == single-engine reference ------------
    # the reference rollout is ALWAYS plain greedy decode: when speculation
    # is on, this is the bit-identity guarantee, not a tautology
    ref_ecfg = dataclasses.replace(ecfg, speculation="off")
    ref_pe = PrefillEngine(cfg, params, ref_ecfg, None, name="ref_p",
                           device=dev)
    ref_de = DecodeEngine(cfg, params, ref_ecfg, name="ref_d", device=dev)
    checked = reqs + [late]
    for r in checked:
        ref = Request(rid=10_000 + r.rid, arrival=0.0, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens)
        st, logits = ref_pe.run(ref)
        ref_de.insert(ref, st, int(torch.argmax(logits)))
        while ref_de.active:
            ref_de.step()
        assert ref.generated == r.generated, (
            f"request {r.rid}: orchestrated decode diverged")
    print(f"\nall {len(checked)} streamed outputs (incl. the mid-run "
          "submission) token-identical to the single-engine reference ✓")


if __name__ == "__main__":
    main()
