"""§4.3 analytical performance model for PD disaggregation.

Implements Eq. 18–31 plus the hardware profiles used to turn architecture
configs into per-stage compute/memory/latency estimates.  This model drives
(a) the discrete-event cluster simulator's step costs, (b) Algorithm 1's
benefit/cost evaluation, and (c) the roofline report's MODEL_FLOPS terms.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float            # FLOP/s (bf16)
    hbm_bw: float                # bytes/s
    hbm_bytes: int
    net_bw: float                # inter-device bytes/s (NVLink/ICI)
    host_bw: float               # device<->host bytes/s (PCIe/DMA)

    def __post_init__(self):
        # profiles key every lru-cached cost function; precompute the hash
        # instead of re-tupling six fields per cache lookup (hot in
        # 10^5-event simulation runs)
        object.__setattr__(self, "_hash", hash(
            (self.name, self.peak_flops, self.hbm_bw, self.hbm_bytes,
             self.net_bw, self.host_bw)))

    def __hash__(self) -> int:
        return self._hash

    @property
    def ridge_intensity(self) -> float:
        return self.peak_flops / self.hbm_bw


# TPU v5e per the task hardware constants; A100 for paper-setting sanity.
TPU_V5E = HardwareProfile("tpu_v5e", 197e12, 819e9, 16 << 30, 50e9, 25e9)
A100_80G = HardwareProfile("a100_80g", 312e12, 2039e9, 80 << 30, 300e9, 25e9)
# Heterogeneous-fleet parts: v5p is absolutely faster at everything but
# *comparatively* strongest at memory-bound decode (3.4x the HBM bandwidth
# of v5e vs 2.3x the FLOPs), v4 sits between — so a co-optimizing router /
# autoscaler lands decode on v5p and prefill per FLOP-per-dollar.
TPU_V5P = HardwareProfile("tpu_v5p", 459e12, 2765e9, 95 << 30, 100e9, 32e9)
TPU_V4 = HardwareProfile("tpu_v4", 275e12, 1228e9, 32 << 30, 50e9, 16e9)
# NVIDIA H100 SXM, data-sheet figures (not measured): 989 TFLOP/s bf16
# dense, 3.35 TB/s HBM3, 80 GiB, NVLink 450 GB/s each way, PCIe Gen5 x16
# 64 GB/s each way.  The port's default part.
H100_SXM = HardwareProfile("h100_sxm", 989e12, 3.35e12, 80 << 30, 450e9, 64e9)

PROFILES: Dict[str, HardwareProfile] = {
    p.name: p for p in (TPU_V5E, TPU_V5P, TPU_V4, A100_80G, H100_SXM)}


@functools.lru_cache(maxsize=None)
def model_consts(cfg: ModelConfig) -> Tuple[float, int, float]:
    """Memoized per-config constants for the hot cost paths:
    ``(active_params, n_attention_blocks, total_params)``.

    ``ModelConfig`` is frozen/hashable; the block scan and parameter sums
    are pure in it, and the event-driven simulator calls the cost model
    per event — at 10^5 requests the uncached scans dominate the sim's
    own runtime, so they are computed once per config here."""
    n_attn = sum(1 for b in cfg.blocks()
                 if b.value in ("attention", "local_attn"))
    return cfg.active_param_count(), n_attn, cfg.param_count()


def instance_warmup_time(cfg: ModelConfig, hw: HardwareProfile,
                         jit_compile_s: float = 2.0,
                         dtype_bytes: Optional[int] = None) -> float:
    """Virtual-clock cost of bringing a fresh instance into service:
    stream the full weight set host->device at the part's DMA bandwidth,
    then pay the jit-compile/tracing cost before the first real batch.
    The autoscaler bills this on scale-up — a new instance takes no
    traffic until ``now + instance_warmup_time(...)``."""
    weight_bytes = model_consts(cfg)[2] * (dtype_bytes or 2)
    return weight_bytes / hw.host_bw + max(jit_compile_s, 0.0)


# ---------------------------------------------------------------------------
# Stage cost models
# ---------------------------------------------------------------------------

def prefill_flops(cfg: ModelConfig, seq_len: int, batch: int = 1) -> float:
    """~2·N_active FLOPs/token for matmuls + attention quadratic term."""
    n, n_attn, _ = model_consts(cfg)
    flops = 2.0 * n * seq_len * batch
    # attention score/value FLOPs: 2 * 2 * S^2 * H * Dh per layer (causal /2)
    kv_len = cfg.kv_cache_len(seq_len)
    flops += batch * n_attn * 2 * 2 * seq_len * min(seq_len, kv_len) \
        * cfg.n_heads * cfg.head_dim * 0.5
    return flops


def suffix_prefill_flops(cfg: ModelConfig, prompt_len: int,
                         cached_tokens: int, batch: int = 1) -> float:
    """FLOPs of the incremental (prefix-aware) prefill that resumes from
    ``cached_tokens`` of stored KV: matmuls scale with the suffix, the
    attention term with suffix x full context."""
    cached = max(min(cached_tokens, prompt_len), 0)
    s = prompt_len - cached
    n, n_attn, _ = model_consts(cfg)
    flops = 2.0 * n * s * batch
    kv_len = cfg.kv_cache_len(prompt_len)
    flops += batch * n_attn * 2 * 2 * s * min(prompt_len, kv_len) \
        * cfg.n_heads * cfg.head_dim * 0.5
    return flops


def prefix_reuse_flops_saved(cfg: ModelConfig, prompt_len: int,
                             cached_tokens: int, batch: int = 1) -> float:
    """Prefill FLOPs the Global KV Store's prefix hit avoids: the full
    prompt's prefill minus the incremental suffix forward (Fig. 5 — the
    recompute-vs-fetch trade the tiered store wins when fetch hides under
    per-layer compute)."""
    return max(prefill_flops(cfg, prompt_len, batch)
               - suffix_prefill_flops(cfg, prompt_len, cached_tokens,
                                      batch), 0.0)


def decode_flops_per_token(cfg: ModelConfig, context: int, batch: int = 1) -> float:
    n, n_attn, _ = model_consts(cfg)
    flops = 2.0 * n * batch
    kv_len = cfg.kv_cache_len(context)
    flops += batch * n_attn * 2 * 2 * kv_len * cfg.n_heads * cfg.head_dim
    return flops


def decode_bytes_per_token(cfg: ModelConfig, context: int, batch: int = 1,
                           dtype_bytes: Optional[int] = None) -> float:
    """Decode is memory-bound: weights read once per step + KV read.

    ``dtype_bytes=None`` (default) bills KV at the config's own storage
    format — int8 caches (``kv_quant``) read ~half the bytes — while
    weights stay bf16.  An explicit value overrides both (what-if sweeps).
    """
    weight_bytes = model_consts(cfg)[0] * (dtype_bytes or 2)
    kv = cfg.kv_bytes_per_token(dtype_bytes) * cfg.kv_cache_len(context) * batch
    return weight_bytes + kv


def prefill_time(cfg: ModelConfig, seq_len: int, hw: HardwareProfile,
                 batch: int = 1, n_chips: int = 1, efficiency: float = 0.5
                 ) -> float:
    """T_p of Eq. 20 (compute-bound stage)."""
    return prefill_flops(cfg, seq_len, batch) / (
        hw.peak_flops * n_chips * efficiency)


def decode_time_per_token(cfg: ModelConfig, context: int, hw: HardwareProfile,
                          batch: int = 1, n_chips: int = 1,
                          efficiency: float = 0.8) -> float:
    """T_d + T_m of Eq. 22 (memory-bound stage): max of roofline terms."""
    t_comp = decode_flops_per_token(cfg, context, batch) / (
        hw.peak_flops * n_chips)
    t_mem = decode_bytes_per_token(cfg, context, batch) / (
        hw.hbm_bw * n_chips * efficiency)
    return max(t_comp, t_mem)


def decode_iter_time(cfg: ModelConfig, context: int, hw: HardwareProfile,
                     batch: int = 1, n_chips: int = 1,
                     efficiency: float = 0.8) -> float:
    """One continuous-batching decode iteration: every one of ``batch``
    active slots advances one token.  This is the virtual-clock cost both
    event loops charge per decode event — ``decode_time_per_token`` already
    models the whole batched step (weights stream once, per-slot KV adds),
    so the alias exists to make call sites read as what they bill."""
    return decode_time_per_token(cfg, context, hw, batch=batch,
                                 n_chips=n_chips, efficiency=efficiency)


def speculative_tokens_per_iter(k: int, accept_rate: float) -> float:
    """Expected committed tokens per speculative decode iteration: the
    longest-accepted-prefix scheme always commits the bonus token plus
    however many of the ``k`` proposals matched greedy (linear model of
    the geometric acceptance process — adequate for routing decisions)."""
    return 1.0 + max(0.0, min(1.0, accept_rate)) * max(k, 0)


def speculative_decode_iter_time(cfg: ModelConfig, context: int,
                                 hw: HardwareProfile, batch: int = 1,
                                 k: int = 4,
                                 draft_cfg: Optional[ModelConfig] = None,
                                 n_chips: int = 1,
                                 efficiency: float = 0.8) -> float:
    """One speculative decode iteration: verification scores ``k + 1``
    positions per slot in a single pass over the paged KV, so compute
    scales ~(k+1)x while bytes stay where plain decode left them (weights
    stream once, the KV read is the same pages plus k fresh entries) —
    higher arithmetic intensity, and on a memory-bound roofline often
    barely slower than a plain step.  ``draft_cfg`` adds k single-token
    draft-model iterations (the two-model path); the n-gram proposer is
    free.  Divide by ``speculative_tokens_per_iter`` for per-token cost."""
    s = max(k, 0) + 1
    t_comp = decode_flops_per_token(cfg, context, batch) * s / (
        hw.peak_flops * n_chips)
    t_mem = decode_bytes_per_token(cfg, context, batch) / (
        hw.hbm_bw * n_chips * efficiency)
    t = max(t_comp, t_mem)
    if draft_cfg is not None:
        t += max(k, 0) * decode_time_per_token(
            draft_cfg, context, hw, batch=batch, n_chips=n_chips,
            efficiency=efficiency)
    return t


def kv_transfer_time(cfg: ModelConfig, n_tokens: int, hw: HardwareProfile,
                     dtype_bytes: Optional[int] = None) -> float:
    """T_x of Eq. 21: move a request's KV prefill→decode over the fabric
    (billed at the config's KV storage format — int8 pages ship ~half)."""
    return cfg.kv_bytes_per_token(dtype_bytes) * n_tokens / hw.net_bw


# ---------------------------------------------------------------------------
# Eq. 20/22/30: latency + throughput
# ---------------------------------------------------------------------------

def ttft(t_prefill: float, t_kv_transfer: float, t_queue: float) -> float:
    return t_prefill + t_kv_transfer + t_queue            # Eq. 20/21


def tpot(t_decode: float, t_cache: float = 0.0, t_stall: float = 0.0) -> float:
    return t_decode + t_cache + t_stall                    # Eq. 22


def throughput(n_requests: int, l_out: float, t_ttft: float,
               t_tpot: float) -> float:
    return n_requests * l_out / (t_ttft + l_out * t_tpot)  # Eq. 30


# ---------------------------------------------------------------------------
# Eq. 23–27: per-instance footprints and utilization
# ---------------------------------------------------------------------------

def memory_footprint(cfg: ModelConfig, n_layers_local: int, kv_tokens: int,
                     dtype_bytes: Optional[int] = None,
                     base_bytes: int = 1 << 30) -> float:
    """Eq. 23/25: M0 + n·M_l + K (KV at the config's storage format)."""
    m_layer = cfg.param_count() / max(cfg.n_layers, 1) * (dtype_bytes or 2)
    kv = cfg.kv_bytes_per_token(dtype_bytes) * kv_tokens \
        * n_layers_local / max(cfg.n_layers, 1)
    return base_bytes + n_layers_local * m_layer + kv


def compute_demand(cfg: ModelConfig, n_layers_local: int, batch: int,
                   tokens: int) -> float:
    """Eq. 24/26: n·C_l·B·L (FLOPs)."""
    c_layer = 2.0 * cfg.active_param_count() / max(cfg.n_layers, 1)
    return n_layers_local * c_layer * batch * tokens


def utilization(comp_flops_per_s: float, mem_bytes: float,
                hw: HardwareProfile, n_chips: int = 1) -> float:
    """Eq. 32: U = C/C_max + M/M_max ∈ [0, 2]."""
    u_c = min(comp_flops_per_s / (hw.peak_flops * n_chips), 1.0)
    u_m = min(mem_bytes / (hw.hbm_bytes * n_chips), 1.0)
    return u_c + u_m


# ---------------------------------------------------------------------------
# Eq. 28: migration cost;  Eq. 4/11 latency models
# ---------------------------------------------------------------------------

def layer_migration_time(cfg: ModelConfig, n_layers: int, kv_tokens: int,
                         hw: HardwareProfile,
                         dtype_bytes: Optional[int] = None,
                         t_sync: float = 2e-3) -> float:
    """Eq. 3/4: (S_w + S_kv)/B_net + T_sync."""
    s_w = cfg.param_count() / max(cfg.n_layers, 1) * n_layers \
        * (dtype_bytes or 2)
    s_kv = cfg.kv_bytes_per_token(dtype_bytes) * kv_tokens \
        * n_layers / max(cfg.n_layers, 1)
    return (s_w + s_kv) / hw.net_bw + t_sync


def attention_migration_time(cfg: ModelConfig, n_heads: int, kv_tokens: int,
                             hw: HardwareProfile,
                             dtype_bytes: Optional[int] = None
                             ) -> float:
    """Eq. 11: S_kv/B_net — only the migrated heads' KV moves, no weights
    (int8 caches move ~half the bytes, and the router sees it)."""
    frac = n_heads / max(cfg.n_kv_heads, 1)
    s_kv = cfg.kv_bytes_per_token(dtype_bytes) * kv_tokens * frac
    return s_kv / hw.net_bw


def migration_cost(n_modules: int, t_transfer: float, t_sync: float = 2e-3,
                   t_realloc: float = 1e-3) -> float:
    return n_modules * (t_transfer + t_sync + t_realloc)   # Eq. 28


def span_transfer_schedule(cfg: ModelConfig, n_span_layers: int,
                           kv_tokens: int, dtype_bytes: Optional[int] = None
                           ) -> "Sequence[int]":
    """Ordered per-layer byte schedule of a §4.1 layer-span migration:
    each migrated layer ships its weight shard ``W_l`` plus its share of
    the resident serving state ``KV_l`` (Eq. 5).  Cost the schedule with
    ``overlapped_schedule_time`` — layer *i*'s payload streams while layer
    *i−1* re-materializes on the destination — so the move is billed per
    migrated layer, never per stack."""
    w_layer = cfg.param_count() / max(cfg.n_layers, 1) * (dtype_bytes or 2)
    kv_layer = cfg.kv_bytes_per_token(dtype_bytes) * kv_tokens \
        / max(cfg.n_layers, 1)
    return [int(w_layer + kv_layer)] * max(n_span_layers, 0)


def span_migration_time(cfg: ModelConfig, n_span_layers: int,
                        kv_tokens: int, hw: HardwareProfile,
                        t_layer_compute: float = 0.0,
                        overlapped: bool = True) -> float:
    """Eq. 4/11 cost of moving a contiguous span of ``n_span_layers``
    layers (weights + per-slot KV) — scales with the SPAN, not the stack."""
    sched = span_transfer_schedule(cfg, n_span_layers, kv_tokens)
    fn = overlapped_schedule_time if overlapped else serial_schedule_time
    return fn(sched, hw.net_bw, t_layer_compute)


# ---------------------------------------------------------------------------
# Ordered per-layer transfer schedules (paged hand-off / migration payloads)
# ---------------------------------------------------------------------------

def serial_schedule_time(layer_bytes: "Sequence[int]", bandwidth: float,
                         t_layer_compute: float = 0.0,
                         t_sync: float = 2e-3) -> float:
    """Eq. 4/11 without overlap: every layer's pages transfer, then its
    compute runs, strictly in sequence."""
    return (sum(layer_bytes) / bandwidth
            + len(layer_bytes) * t_layer_compute + t_sync)


def overlapped_schedule_time(layer_bytes: "Sequence[int]", bandwidth: float,
                             t_layer_compute: float = 0.0,
                             t_sync: float = 2e-3) -> float:
    """Eq. 4/11 with §4.2 layer-wise overlap: layer *i*'s pages stream
    while layer *i-1* computes, so a layer only stalls when its transfer
    outlives the compute in front of it (the two-stage pipeline makespan
    of Eq. 12–17 over a non-uniform schedule)."""
    recv = done = 0.0
    for nbytes in layer_bytes:
        recv += nbytes / bandwidth
        done = max(done, recv) + t_layer_compute
    return done + t_sync


# ---------------------------------------------------------------------------
# Eq. 18/31: the weighted objective
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    alpha: float = 1.0      # utilization
    beta: float = 1.0       # latency (s)
    gamma: float = 1e-3     # throughput (tok/s)


def objective(u_avg: float, t_avg_latency: float, thpt: float,
              w: ObjectiveWeights = ObjectiveWeights()) -> float:
    return w.alpha * u_avg - w.beta * t_avg_latency + w.gamma * thpt
