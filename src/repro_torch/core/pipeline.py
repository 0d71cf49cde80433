"""Layer-wise overlapped transmission: the three-stage pipeline of §4.2.

While the GPU runs layer *i*'s forward, the HtoD channel prefetches layer
*i+1*'s cached KV and the DtoH channel stores layer *i−1*'s freshly produced
KV (Fig. 6).  The pipeline hides transfer latency whenever
``T_KV <= T_F,layer`` (Eq. 12–17).

This module is the analytical model: given per-layer compute and transfer
times it returns the end-to-end prefill time with and without overlap, the
non-overlapped residual the engine must charge, and the paper's worked
example as a self-check (validated in tests against Eq. 17's numbers).

A faithful copy of the JAX package's framework-free ``core/pipeline.py``,
which the simulator (``serving/cluster.py``) bills store fetches with.  It
keeps the reference's known fault (ROADMAP §C, R3): ``overlapped_time``
charges the fetch warm-up and the store drain on top of ``n_layers``
steady steps, so when one layer's KV transfer exceeds its compute (e.g.
``n_layers=1, t_fwd_layer=0.03125, t_kv_layer=0.0625``: 0.1875 s) it can
exceed ``serial_time`` (0.15625 s).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    n_layers: int
    t_fwd_layer: float          # per-layer forward compute time (s)
    t_kv_layer: float           # per-layer KV fetch time (s), = store time

    # -- Eq. 12/13 constructors ----------------------------------------
    @staticmethod
    def from_workload(*, t_forward_total: float, hit_rate: float,
                      n_layers: int, kv_bytes_per_token_layer: int,
                      seq_len: int, bandwidth_bps: float) -> "PipelineModel":
        t_f_layer = t_forward_total * hit_rate / n_layers          # Eq. 12
        t_kv = (kv_bytes_per_token_layer * seq_len * hit_rate
                / bandwidth_bps)                                    # Eq. 13
        return PipelineModel(n_layers, t_f_layer, t_kv)

    # -- timings ---------------------------------------------------------
    def serial_time(self) -> float:
        """No overlap: every fetch + store serializes with compute."""
        return self.n_layers * (self.t_fwd_layer + 2 * self.t_kv_layer)

    def overlapped_time(self) -> float:
        """Three-stage pipeline: per-layer latency is max(compute, fetch,
        store) after a one-layer fetch warm-up."""
        steady = max(self.t_fwd_layer, self.t_kv_layer)
        return self.t_kv_layer + self.n_layers * steady + self.t_kv_layer

    def residual_stall(self) -> float:
        """Extra latency vs pure compute — what the engine charges for a
        Global-Store fetch (0 when fully hidden)."""
        return max(0.0, self.overlapped_time()
                   - self.n_layers * self.t_fwd_layer)

    def fully_hidden(self) -> bool:
        return self.t_kv_layer <= self.t_fwd_layer

    def timeline(self) -> List[Tuple[str, int, float, float]]:
        """(channel, layer, start, end) events — Fig. 6 rendering."""
        ev = []
        steady = max(self.t_fwd_layer, self.t_kv_layer)
        for i in range(self.n_layers):
            ev.append(("HtoD", i, i * steady, i * steady + self.t_kv_layer))
            c0 = self.t_kv_layer + i * steady
            ev.append(("GPU", i, c0, c0 + self.t_fwd_layer))
            s0 = self.t_kv_layer + (i + 1) * steady
            ev.append(("DtoH", i, s0, s0 + self.t_kv_layer))
        return ev


def paper_example() -> PipelineModel:
    """The §4.2 worked example: llama-3.1-8B, L=1000, r=0.5, B=200 Gbps,
    T_F=270 ms → T_F,layer ≈ 4.22 ms, T_KV ≈ 0.082 ms (Eq. 17)."""
    return PipelineModel.from_workload(
        t_forward_total=0.270, hit_rate=0.5, n_layers=32,
        kv_bytes_per_token_layer=4096,       # Eq. 15: 4 KB
        seq_len=1000, bandwidth_bps=200e9 / 8)
