"""Reproduce the paper's Figure 8/10 comparison (BanaServe vs DistServe-like
vs vLLM-like) with the port's discrete-event cluster simulator, on both
workload regimes (the port of ``examples/simulate_cluster.py``; it prints
what that script prints).

    PYTHONPATH=src python examples/torch_simulate_cluster.py

The simulator runs no model, so it needs no card.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

from repro_torch import configs
from repro_torch.serving.cluster import ClusterSim, SimConfig
from repro_torch.serving.workload import WorkloadConfig

MODEL = configs.get("llama-13b")


def run(kind, rps, n=80, max_new=256):
    print(f"\n--- {kind} workload @ {rps} RPS ---")
    base = None
    for system in ("vllm", "distserve", "banaserve"):
        w = WorkloadConfig(kind=kind, rps=rps, n_requests=n, seed=0,
                           max_new_tokens=max_new)
        s = ClusterSim(SimConfig.preset(MODEL, system), w).run()
        if system == "vllm":
            base = s["throughput_tok_s"]
        rel = s["throughput_tok_s"] / base
        print(f"{system:10} thpt={s['throughput_tok_s']:8.1f} tok/s "
              f"({rel:4.2f}x vllm)  ttft={s['mean_ttft_s']:7.3f}s  "
              f"tpot={s['mean_tpot_s'] * 1e3:6.1f}ms  "
              f"prefill_skew={s['prefill_skew']:.2f}  "
              f"migrations={s['migrations']}")


def main():
    run("alpaca", rps=5)
    run("alpaca", rps=20)
    run("longbench", rps=1, n=50, max_new=128)
    run("longbench", rps=4, n=50, max_new=128)


if __name__ == "__main__":
    main()
