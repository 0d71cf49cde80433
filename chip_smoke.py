#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, in parallel) and print the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card: at the
   serving path's llama-13b shapes, at a GQA shape (granite-8b heads) and
   on a windowed, soft-capped case with dead table entries and holes, in
   float32 and bfloat16.  Time each kernel (CUDA events, warmed, many
   launches) beside its plain version, a library yardstick and the bound
   the card's data-sheet rates put on the same work.
3. Serve llama-13b at full width and depth in bf16 (random weights from a
   seed) through ``Server`` over the port's ``Orchestrator``: 8 requests,
   chunked prefill, a shared-prefix workload.  Checks that every request
   completes, that all three kernels ran on the serving path, that the
   paged pools are restored, and — teacher-forced through the plain
   monolithic forward — that every served token is within a stated gap of
   its step's best logit.  Prints prefill and decode throughput, peak
   memory, and the device-busy share of one profiled decode iteration.
4. Print the ``kernels`` JSON line, then the result line.

The script imports nothing of the JAX package and needs no network.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Data-sheet peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the peak for
# its input type (bf16 on the tensor cores, f32 on the FMA units).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Kernel-vs-plain tolerances.  Both sides compute in f32 from the same
# inputs (bf16 inputs are upcast exactly), so f32 partials differ only by
# summation order over D = 128 and up to 1024 keys: 1e-4.  A bf16 output
# is rounded to bf16 on both sides, so one bf16 step (2^-8 relative) can
# separate them: 2e-2.
TOL_F32 = 1e-4
TOL_BF16_OUT = 2e-2

# Teacher-forced check: a served token must lie within this many logits
# of its step's best under the plain bf16 forward.  The paged kernels and
# the plain forward round bf16 activations at different places, and random
# weights leave near-ties, so equality of argmax is not the criterion.
TOKEN_GAP_TOL = 0.25

# One mid-run decode iteration runs under torch.profiler (and is left out
# of the wall and decode clocks) to show how much of an iteration the card
# is busy.
PROFILE_ITER = 10


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Synthetic kernel inputs
# ---------------------------------------------------------------------------

def paged_case(torch, gen, dev, dtype, *, b, h, kv, d, bs, nb, lengths,
               s=1, n_prefix=None):
    """A block pool with ragged per-row tables (dead entries -1) and a
    poisoned scratch page.  Decode (s == 1): query at position length-1 of
    a row holding ``lengths[row]`` tokens.  Prefill (s > 1): ``n_prefix``
    prefix tokens in pages, S queries at n_prefix.. with their own pages
    allocated (positions still -1, as before the suffix write); a hole
    (pos -1) is punched in each row's first page."""
    n_phys = 1 + b * nb
    k_pages = torch.randn((n_phys, bs, kv, d), generator=gen, device=dev
                          ).to(dtype)
    v_pages = torch.randn((n_phys, bs, kv, d), generator=gen, device=dev
                          ).to(dtype)
    pos_pages = torch.randint(0, nb * bs, (n_phys, bs), generator=gen,
                              device=dev, dtype=torch.int32)   # poison
    tables = torch.full((b, nb), -1, dtype=torch.int32, device=dev)
    nxt = 1
    for row in range(b):
        live = lengths[row] if s == 1 else n_prefix[row]
        total = live if s == 1 else live + s
        for j in range(-(-total // bs)):
            tables[row, j] = nxt
            p = torch.arange(j * bs, (j + 1) * bs, device=dev,
                             dtype=torch.int32)
            p[p >= live] = -1
            pos_pages[nxt] = p
            nxt += 1
        if s > 1 and tables[row, 0] >= 0:
            pos_pages[int(tables[row, 0]), 3] = -1              # a hole
    if s == 1:
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        pos_q = torch.as_tensor([n - 1 for n in lengths], dtype=torch.int32,
                                device=dev)
    else:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        pos_q = (torch.as_tensor(n_prefix, dtype=torch.int32, device=dev)
                 [:, None] + torch.arange(s, dtype=torch.int32, device=dev))
    return q, k_pages, v_pages, pos_pages, tables, pos_q


def visible_pairs(torch, pos_pages, tables, pos_q, window):
    """(query, key) pairs the masks admit: what the kernel's flops need."""
    pk = pos_pages[tables.clamp_min(0).long()]
    pk = torch.where((tables >= 0)[:, :, None], pk, -1).reshape(
        tables.shape[0], 1, -1)
    pq = pos_q.reshape(tables.shape[0], -1, 1)
    ok = (pk >= 0) & (pk <= pq)
    if window is not None:
        ok &= pk > pq - window
    return int(ok.sum())


def live_page_bytes(torch, k_pages, pos_pages, tables):
    """K + V + pos bytes of the distinct pages the tables reference."""
    pages = torch.unique(tables[tables >= 0]).numel()
    per = k_pages[0].numel() * k_pages.element_size() * 2 \
        + pos_pages[0].numel() * 4
    return pages * per


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want) -> float:
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return max(float((a.float() - b.float()).abs().max()) for a, b in
               zip(got, want))


def check_close(torch, what, got, want, tol) -> float:
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        if a.shape != b.shape:
            fail(f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            fail(f"{what}: non-finite kernel output")
        if not torch.allclose(a.float(), b.float(), rtol=tol, atol=tol):
            fail(f"{what}: max |kernel - plain| = "
                 f"{max_err(torch, a, b):.3e} > {tol}")
    return max_err(torch, got, want)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   paged_prefix_partials)
    from repro_torch.kernels.split_kv_decode import paged_decode_partials

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # (label, heads, kv heads, head_dim, window, soft cap); the last case
    # also takes the kernels' widest head_dim
    cases = [("llama-13b", 40, 40, 128, None, None),
             ("granite-8b GQA", 32, 8, 128, None, None),
             ("window+cap", 8, 2, 256, 48, 30.0)]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        for label, h, kv, d, win, cap in cases:
            main = label == "llama-13b"
            bs, nb = 16, 64                           # max_len 1024
            b_dec = 8 if main else 4
            lengths = [int(x) for x in torch.randint(
                1, nb * bs, (b_dec,), generator=gen, device=dev)]
            # -- B1: paged decode partials
            q, kp, vp, pp, tb, pq = paged_case(
                torch, gen, dev, dtype, b=b_dec, h=h, kv=kv, d=d, bs=bs,
                nb=nb, lengths=lengths)
            if main:
                tb[-1] = -1                # an empty slot: all-dead row
            kw = dict(window=win, soft_cap=cap)
            got = paged_decode_partials(q, kp, vp, pp, tb, pq, **kw)
            want = ref.paged_decode_partials_plain(q, kp, vp, pp, tb, pq,
                                                   **kw)
            torch.cuda.synchronize()
            err = check_close(torch, f"B1 {label} {tname}", got, want,
                              TOL_F32)
            results[("B1", label, tname)] = dict(
                err=err, args=(q, kp, vp, pp, tb, pq))
            # -- B3: paged prefix partials (chunk 256 after a prefix)
            s = 256 if main else 64
            b_pre = 4 if main else 2
            n_prefix = [int(x) * bs for x in torch.randint(
                1, (nb * bs - s) // bs, (b_pre,), generator=gen, device=dev)]
            q3, kp3, vp3, pp3, tb3, pq3 = paged_case(
                torch, gen, dev, dtype, b=b_pre, h=h, kv=kv, d=d, bs=bs,
                nb=nb, lengths=None, s=s, n_prefix=n_prefix)
            got = paged_prefix_partials(q3, kp3, vp3, pp3, tb3, pq3, **kw)
            want = ref.paged_prefix_partials_plain(q3, kp3, vp3, pp3, tb3,
                                                   pq3, **kw)
            torch.cuda.synchronize()
            err = check_close(torch, f"B3 {label} {tname}", got, want,
                              TOL_F32)
            results[("B3", label, tname)] = dict(
                err=err, args=(q3, kp3, vp3, pp3, tb3, pq3))
            del got, want
            # -- B2: flash prefill, normalized and partials
            b2, s2 = (4, 256) if main else (2, 192)
            q2 = torch.randn((b2, s2, h, d), generator=gen, device=dev
                             ).to(dtype)
            k2 = torch.randn((b2, s2, kv, d), generator=gen, device=dev
                             ).to(dtype)
            v2 = torch.randn((b2, s2, kv, d), generator=gen, device=dev
                             ).to(dtype)
            got = flash_prefill(q2, k2, v2, **kw)
            want = ref.flash_prefill_plain(q2, k2, v2, **kw)
            torch.cuda.synchronize()
            tol = TOL_F32 if dtype == torch.float32 else TOL_BF16_OUT
            err = check_close(torch, f"B2 {label} {tname}", got, want, tol)
            off = 64
            gp = flash_prefill(q2[:, off:], k2, v2, seq_offset=off,
                               return_partials=True, **kw)
            wp = ref.flash_prefill_plain(q2[:, off:], k2, v2, seq_offset=off,
                                         return_partials=True, **kw)
            torch.cuda.synchronize()
            err = max(err, check_close(torch, f"B2 partials {label} "
                                       f"{tname}", gp, wp, TOL_F32))
            results[("B2", label, tname)] = dict(err=err, args=(q2, k2, v2))
            say(f"kernels vs plain [{label}, {tname}]: max |err| "
                f"B1 {results[('B1', label, tname)]['err']:.2e}  "
                f"B2 {err:.2e}  B3 {results[('B3', label, tname)]['err']:.2e}")

    # -- timings at the serving path's shapes (llama-13b, bf16)
    timing = {}
    r1 = results[("B1", "llama-13b", "bfloat16")]
    q, kp, vp, pp, tb, pq = r1["args"]
    b, h, d = q.shape
    nb, bs, kv = tb.shape[1], kp.shape[1], kp.shape[2]
    pairs = visible_pairs(torch, pp, tb, pq, None)
    out_b = b * nb * h * (d + 2) * 4
    byt = nbytes(q, tb, pq) + live_page_bytes(torch, kp, pp, tb) + out_b
    flops = 4 * d * h * pairs              # QK and PV, every head

    def lib_decode():
        kl = kp[tb.clamp_min(0).long()].reshape(b, nb * bs, kv, d)
        vl = vp[tb.clamp_min(0).long()].reshape(b, nb * bs, kv, d)
        pk = torch.where((tb >= 0)[:, :, None], pp[tb.clamp_min(0).long()],
                         -1).reshape(b, 1, 1, -1)
        mask = (pk >= 0) & (pk <= pq[:, None, None, None])
        return F.scaled_dot_product_attention(
            q[:, :, None], kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    timing["B1"] = dict(
        ms=time_ms(torch, lambda: paged_decode_partials(q, kp, vp, pp, tb,
                                                        pq), 200),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_partials_plain(
            q, kp, vp, pp, tb, pq), 20),
        library_ms=time_ms(torch, lib_decode, 50),
        bytes=byt, flops=flops, dtype="bfloat16")

    r3 = results[("B3", "llama-13b", "bfloat16")]
    q3, kp3, vp3, pp3, tb3, pq3 = r3["args"]
    b3, s3 = q3.shape[:2]
    pairs = visible_pairs(torch, pp3, tb3, pq3, None)
    out_b = b3 * nb * s3 * h * (d + 2) * 4
    byt = nbytes(q3, tb3, pq3) + live_page_bytes(torch, kp3, pp3, tb3) \
        + out_b

    def lib_prefix():
        kl = kp3[tb3.clamp_min(0).long()].reshape(b3, nb * bs, kv, d)
        vl = vp3[tb3.clamp_min(0).long()].reshape(b3, nb * bs, kv, d)
        pk = torch.where((tb3 >= 0)[:, :, None],
                         pp3[tb3.clamp_min(0).long()], -1
                         ).reshape(b3, 1, 1, -1)
        mask = (pk >= 0) & (pk <= pq3[:, None, :, None])
        return F.scaled_dot_product_attention(
            q3.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    timing["B3"] = dict(
        ms=time_ms(torch, lambda: paged_prefix_partials(
            q3, kp3, vp3, pp3, tb3, pq3), 20),
        plain_ms=time_ms(torch, lambda: ref.paged_prefix_partials_plain(
            q3, kp3, vp3, pp3, tb3, pq3), 5),
        library_ms=time_ms(torch, lib_prefix, 20),
        bytes=byt, flops=4 * d * h * pairs, dtype="bfloat16")

    r2 = results[("B2", "llama-13b", "bfloat16")]
    q2, k2, v2 = r2["args"]
    b2, s2 = q2.shape[:2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q2, k2, v2))
    timing["B2"] = dict(
        ms=time_ms(torch, lambda: flash_prefill(q2, k2, v2), 50),
        plain_ms=time_ms(torch, lambda: ref.flash_prefill_plain(q2, k2, v2),
                         10),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50),
        bytes=nbytes(q2, k2, v2) + nbytes(q2),        # q, k, v in; out
        flops=4 * d * h * b2 * s2 * (s2 + 1) // 2, dtype="bfloat16")
    errs = {kname: max(v["err"] for (kk, _, _), v in results.items()
                       if kk == kname) for kname in ("B1", "B2", "B3")}
    return timing, errs


# ---------------------------------------------------------------------------
# Phase 3: serving llama-13b through Server
# ---------------------------------------------------------------------------

def device_us(evt) -> float:
    """Self device time of a profiler entry, in microseconds."""
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0.0)


def serving_phase(torch, card: str):
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import Server
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)
    from repro_torch.serving.workload import WorkloadConfig, generate

    cfg = get("llama-13b")
    t0 = time.perf_counter()
    params = T.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say(f"llama-13b init (40 layers, d_model 5120, bf16, seed 0): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    ecfg = EngineConfig(max_len=1024, max_batch=8, block_size=16)
    orch = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ecfg, chunk_tokens=256))
    reqs = generate(WorkloadConfig(
        kind="synthetic", rps=1000.0, n_requests=8, vocab_size=cfg.vocab_size,
        max_new_tokens=32, prefix_share=0.6, n_prefix_groups=2, seed=0,
        prompt_len_lo=128, prompt_len_hi=768))
    for r in reqs:
        r.max_new_tokens = 32

    # wall-clock per phase (synchronized), wrapped around the engines
    clocks = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0,
              "decode_iters": 0}
    pe = orch.prefill_members()[0].prefill
    de = orch.decode_units()[0]
    waves = pe.prefill_waves

    def timed_waves(*a, **kw):
        gen = waves(*a, **kw)
        while True:
            t = time.perf_counter()
            wave = next(gen, None)
            torch.cuda.synchronize()
            clocks["prefill_s"] += time.perf_counter() - t
            if wave is None:
                return
            yield wave

    step = de.step
    prof = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def timed_step():
        if de.decode_iters == PROFILE_ITER - 1:
            prof["rows"] = de.active
            t = time.perf_counter()
            with torch.profiler.profile(activities=acts) as p:
                out = step()
                torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - t) * 1e3
            prof["profile"] = p          # summarised after the timed run
            return out
        t = time.perf_counter()
        before = de.tokens_decoded
        out = step()
        torch.cuda.synchronize()
        clocks["decode_s"] += time.perf_counter() - t
        clocks["decode_tokens"] += de.tokens_decoded - before
        clocks["decode_iters"] += 1
        return out

    pe.prefill_waves = timed_waves
    de.step = timed_step

    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").sum()     # start the tracer untimed
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    summary = Server(orch).run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - prof.get("wall_ms", 0.0) / 1e3
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        if r.outcome is None or r.outcome.value != "completed" \
                or len(r.generated) != r.max_new_tokens:
            fail(f"request {r.rid}: outcome {r.outcome}, "
                 f"{len(r.generated)}/{r.max_new_tokens} tokens")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    check_pools_restored(orch)

    # teacher-forced: the plain monolithic forward over each served stream
    worst = 0.0
    spread = []
    for r in reqs:
        stream = list(map(int, r.prompt)) + r.generated
        toks = torch.as_tensor(stream[:-1], device="cuda")[None]
        logits, _, _ = T.apply(cfg, params, toks, mode="train")
        lg = logits[0, r.prompt_len - 1:].float()
        if not torch.isfinite(lg).all():
            fail(f"request {r.rid}: non-finite logits")
        got = lg.gather(1, torch.as_tensor(r.generated, device="cuda")[:, None])
        gap = float((lg.max(dim=1).values - got[:, 0]).max())
        worst = max(worst, gap)
        spread.append(float(lg.std()))
        if gap > TOKEN_GAP_TOL:
            fail(f"request {r.rid}: a served token is {gap:.3f} below its "
                 f"step's best logit (tolerance {TOKEN_GAP_TOL})")
    prefill_tokens = sum(m.tokens_prefilled for m in orch.prefill_members())
    say(f"served {len(reqs)} requests: prompts "
        f"{min(r.prompt_len for r in reqs)}-"
        f"{max(r.prompt_len for r in reqs)} tokens, "
        f"{sum(r.cached_tokens for r in reqs)} prompt tokens from the store, "
        f"{summary['pages_bound']} pages bound, {summary['cow_forks']} COW "
        f"forks, {sum(len(r.generated) for r in reqs)} tokens out")
    say(f"teacher-forced: worst served-token gap {worst:.4f} "
        f"(tolerance {TOKEN_GAP_TOL}; logit std "
        f"{sum(spread) / len(spread):.3f})")
    iter_ms = clocks["decode_s"] / max(clocks["decode_iters"], 1) * 1e3
    say(f"wall clock (profiled iteration left out): {wall:.2f} s; "
        f"prefill {prefill_tokens} tokens in "
        f"{clocks['prefill_s']:.3f} s = "
        f"{prefill_tokens / max(clocks['prefill_s'], 1e-9):.1f} tok/s; "
        f"decode {clocks['decode_tokens']} tokens in "
        f"{clocks['decode_s']:.3f} s = "
        f"{clocks['decode_tokens'] / max(clocks['decode_s'], 1e-9):.1f} "
        f"tok/s ({clocks['decode_iters']} timed iterations, {iter_ms:.1f} "
        f"ms each); peak memory {peak / 2**30:.2f} GiB [{card}]")
    if prof:
        evs = prof["profile"].key_averages()
        # device entries only: an aten op's device time repeats its kernels'
        kern = [e for e in evs if str(e.device_type).endswith("CUDA")]
        busy = sum(device_us(e) for e in kern) / 1e3
        n_aten = sum(e.count for e in evs if e.key.startswith("aten::"))
        top = sorted(kern, key=device_us, reverse=True)[:5]
        head = (f"decode iteration {PROFILE_ITER} under torch.profiler "
                f"({prof['rows']} rows, {n_aten} aten op calls, nested "
                f"included; wall {prof['wall_ms']:.1f} ms with the profiler "
                f"on): device busy ")
        if busy > 0:
            say(head + f"{busy:.2f} ms in {sum(e.count for e in kern)} "
                f"kernels = {busy / iter_ms:.0%} of a timed iteration; top: "
                + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.2f} ms "
                            f"x{e.count}" for e in top))
        else:
            say(head + "not measured (the profiler recorded no device time)")
    say(f"serving-path launches: {json.dumps(launches)}")
    return launches


def check_pools_restored(orch) -> None:
    """Every decode slot empty; each page's refcount equals its holders
    (slot rows plus the store's page holds); free list plus store-held
    pages account for the whole pool."""
    store = orch.store
    for e in orch.decode_units():
        if e.active:
            fail(f"{e.name}: live slots after drain")
        holders = [e.slot_pages(i) for i in range(e.ecfg.max_batch)]
        held = sorted(store.pool_pages(e.name).values()) if store else []
        holders += [[p] for p in held]
        try:
            e.pool.check(holders=holders)
        except AssertionError as exc:
            fail(f"{e.name}: pool invariant: {exc}")
        if len(held) != len(set(held)) or \
                len(e._free) + len(held) != e.ecfg.max_batch * e._nb_slot:
            fail(f"{e.name}: leaked pages")


# ---------------------------------------------------------------------------

KERNELS = [
    # (timing key, launch counter, source, TPU kernel it replaces)
    ("B1", "paged_decode_partials",
     "src/repro_torch/kernels/csrc/paged_decode.cu",
     "src/repro/kernels/split_kv_decode.py:304"),
    ("B2", "flash_prefill", "src/repro_torch/kernels/csrc/flash_prefill.cu",
     "src/repro/kernels/flash_prefill.py:91"),
    ("B3", "paged_prefix_partials",
     "src/repro_torch/kernels/csrc/paged_prefix.cu",
     "src/repro/kernels/flash_prefill.py:210"),
]


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _lib

    # -- phase 1
    t0 = time.perf_counter()
    _lib.build(ptxas_verbose="--ptxas" in sys.argv)
    say(f"built {len(_lib.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # -- phase 2
    timing, errs = kernel_phase(torch)
    torch.cuda.empty_cache()
    for key, t in timing.items():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["flops"] / PEAK_FLOPS[t["dtype"]])
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["flops"] / PEAK_FLOPS[t["dtype"]]
                         else "operations")
        say(f"{key}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e6:.1f} MB, "
            f"{t['flops'] / 1e9:.2f} GFLOP) [{card}]")

    # -- phase 3
    launches = serving_phase(torch, card)

    # -- phase 4
    rows = []
    for key, counter, source, replaces in KERNELS:
        t = timing[key]
        rows.append({"name": counter, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counter],
                     "max_abs_err": errs[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    say(card)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
