#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build the seven CUDA kernel sources from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel; fifteen kernels: B1, B1-int8, B2,
   B3, B4, B4-int8, B5 and the xLSTM's eight scans: the mLSTM's and
   sLSTM's forward and backward in two designs each) and print the card's
   name
   and power limit (with
   ``--ptxas``, each kernel's registers, shared memory and spills).
2. Hold each kernel against its plain PyTorch version on the card: at the
   serving path's llama-13b shapes, at a GQA shape (granite-8b heads) and
   on a windowed, soft-capped head_dim-256 case with dead table entries
   and holes, and at granite-moe-3b-a800m's heads (24/8 of head_dim 64),
   in float32 and bfloat16; B1, B1-int8, B3, B4 and B4-int8 at
   one partial per page (the TPU kernels' contract), per 3 pages and per
   the split the serving path picks; the int8 variants of B1/B4 on the
   same pools quantized to int8 with per-entry scales; B5 over a dense
   llama-13b decode cache (1024 keys, random valid lengths, block_k 512).
   Time each kernel (its device time per call from torch.profiler, warmed,
   many launches; by CUDA events where no trace holds device time) with its plain version and a library yardstick timed the
   same way, and the bound the card's data-sheet rates put on the same
   work (counted from the partials each split writes and, for B5, the key
   tiles it reads); B1, B1-int8, B3, B4 and B4-int8 are timed at the
   serving split (one partial per page on an earlier line), B2 also at one
   1024-token sequence (the int8 runs' longest wave), B4 also at the
   granite-8b case (20 query rows per kv head: B3's tile body), B5 also
   with every key valid against unmasked SDPA and at the dense-row
   serving shape of run (k) (8 rows of a 1000-slot cache read in place,
   the last 512-key block ragged) against masked SDPA; each kernel again at
   granite-moe-3b-a800m's serving shapes (head_dim 64, 24/8 heads, so 15
   verify rows per kv head), on lines of their own.  B4's two bodies,
   the key walk (from a copy of B4 built with every row count on it) and
   B3's tensor-core body, are timed on the same verify inputs at 5, 20 and 80
   query rows per kv head (llama-13b, granite-8b and llama3-405b heads).
   B1 and B2 again at recurrentgemma-9b's local attention (16 query heads
   on one kv head of 256, a 2048-token window), on lines of their own, in
   f32 and bf16: B1 on a ring of 128 pages of 16 per row, three of 8 rows
   wrapped past position 2048 (their positions out of order across
   shuffled pages) and one empty slot, at one partial per page, per 3
   pages and at the serving split; B2 at 1 x 2048 and 4 x 512 tokens
   (timed) and 1 x 3000 (checked: the window cuts); yardsticks gather +
   SDPA under the window mask and causal SDPA.  B1, B2 and B5 again at
   seamless-m4t-large-v2's serving shapes in f32 (16/16 heads of 64): B1
   over 8 rows of 128-page tables as long as the served requests midway
   through decode, B2 on a fresh 1 x 512 chunk, B5 over 8 rows x 512
   cached frames, every one valid (the cross decode), timed over six
   cycled copies of the cross K/V so that it reads them from memory.
   The xLSTM's eight scan kernels at xlstm-350m's widths in f32 (mLSTM 4
   heads of 256, sLSTM d 1024) within TOL_SCAN_REL of the largest value
   of their plain versions: the forward scans at 8 x 256 (a served chunk
   wave), 1 x 1,024 and 1 x 4,096 (their routes: the chunkwise mLSTM,
   its chunk states in two windows at 1 x 4,096, and the persistent
   sLSTM) and 8 x 1 (the routes: one-pass and step), from
   fresh and running carries, each call's launch checked against its
   route, and the other design of each on the same inputs through its C
   entry point, and a recorded forward (its checkpoints) and the backward
   against autograd through the plain forward at 2 x 256 and at training
   run (y)'s 2 x 1,024 (XLSTM_TRAIN_SHAPE), each scan's two backward
   designs (chunkwise mLSTM and persistent sLSTM, routed; step, through
   its C entry point) on the same saved tensors; each timed with its plain
   version and its time per step, both designs of each forward at 8 x 256,
   1 x 1,024 and 1 x 4,096 and of each backward at 2 x 256 and 2 x 1,024
   in the same run, both sLSTM backwards at 1 to 8 rows of 2 to 16 steps
   around its route's least S,
   and both forwards as prefill calls them (eager) at 1 to 8 rows of 2 to
   256 steps, beside the design the route names.
3. Serve llama-13b at full width and depth in bf16 (random weights from a
   seed), 8 requests of a shared-prefix workload, five times: through
   ``Server`` over the port's ``Orchestrator`` (chunked prefill) plain,
   then with n-gram speculative decoding (``spec_len`` 4) under the
   orchestrator's load-aware speculate-or-plain choice; then a self-draft
   (the target drafts for itself, ``spec_len`` 4) at the engine level,
   ``PrefillEngine`` plus ``DecodeEngine(draft=...)`` stepped to
   completion, because the load-aware rule rightly never pays for a draft
   as large as the target; then the int8-KV stack (``with_kv_quant()``, the
   same weights and requests, no chunking: int8 KV cannot resume a prompt)
   through ``Server`` plain and with n-gram speculation.  Every decode-side
   forward (plain step, verify, draft micro-step, span stage) replays a
   CUDA graph captured over the engine's static cache; the bf16 plain and
   n-gram runs are served once more with graphs off (the same
   static-buffer step run eagerly), and their streams and launch counts
   must equal the replayed runs'.  Each run checks
   that every request completes, that the kernels of its path ran and, for
   the int8 runs, that the bf16 page kernels and B3 did not (the launch
   counts are zeroed just before the run and read just after), that the
   paged pools are restored, and — teacher-forced through the port's own
   forward (the plain monolithic one; for int8 a prefill then a multi-token
   decode over a dense int8 cache) — that every served token is within a
   stated gap of its step's best logit; the self-draft run must accept
   proposals.  Prints prefill and decode throughput, peak memory, the
   speculation counters, the int8 runs' argmax agreement with the bf16
   forward, the device-busy share of one profiled decode iteration of the
   bf16 (replayed and eager) and the int8 plain runs (with B1's share of
   it, and the device span of its compiled step from CUDA events), the
   graphs each decode engine captured and their capture time, and the
   device
   time of B2, B3 and the GEMMs in one profiled chunk-resume prefill wave
   of the bf16 plain run.  Then migrate, on the same weights and the same
   8 requests, bf16, 256-token chunks: (a) ``Server`` over one prefill
   member and two 2-stage decode pipelines (``decode_split=2``) with
   Algorithm 1 on; after the third decode iteration it forces, through
   ``apply_action``, a span move of 4 layers decode0.0 -> decode0.1, one
   of 4 layers decode1.1 -> decode1.0 and a KV_HEADS slot rebalance
   between the pipelines; (b) 2 prefill and 2 decode full-stack members,
   forcing a re-roll of prefill1 into decode; (c) a ``PrefillPipeline``
   over [(0, 20), (20, 40)] held against a full-stack ``PrefillEngine``
   (fresh and chunk-resume waves; states within STATE_TOL_REL, first
   tokens within TOKEN_GAP_TOL), its states decoded to the end by a
   ``DecodePipeline``.  Each run holds its streams to the teacher-forced
   rule, checks that every span engine's weights are views of the full
   parameters and that B1, B2 and B3 ((c): B1 and B2, never B3) ran, and
   prints each forced action's host wall clock and billed cost, the
   bytes a span move accounts, the actions Algorithm 1 applied, the
   launches, peak memory and the phase's seconds.  Then the front door,
   on the same weights and requests (bf16, 256-token chunks, graphs on,
   Algorithm 1 off): (d) ``Server`` with a ``SchedulerConfig`` of two
   tenants (bronze priority 0, gold weight 4 and priority 1) and swap
   preemption over one prefill and one decode member at ``max_batch``
   4, requests 0-3 bronze at t = 0 and 4-7 gold, submitted once the
   four bronze ones are decode-resident; (e) the same with sacrifice
   preemption; (f) one prefill and two decode members under
   ``AutoscaleConfig(max_prefill=2, max_decode=3)``, a decode member
   forced up on the H100 profile at the start, requests 0-3 at t = 0 and
   4-7 at its warm-up's end, and a forced drain of one decode member
   once a decode unit is active after that.  Each holds its streams to
   the teacher-forced rule, checks that B1 and B2 ran and the pools are
   restored; (d) and (e) that something was preempted (and for swap
   that pages were swapped and billed), printing each swap-out's and
   resume's synchronised host ms and bytes, or the B2 launches of the
   clones' re-prefills; (f) that the spawned member took no hand-off
   before its warm-up and at least one after, that its weights are
   views of the parameters and that the drained member retired,
   printing the fleet timeline, the policy's own decisions and the
   spawned engine's graph capture.  Then, on the same weights: (k) dense
   rows, ``max_len`` 1000 (no multiple of the 16-token block, so the
   engines serve dense rows, as JAX's do), plain with 256-token chunks
   through ``Server``, replayed and eagerly: B2 and B5 must launch and
   no page kernel, the streams and launches of the two runs must be
   equal, every token within the tolerance; it prints the streams equal
   to the paged plain run's, the decode clocks and B5's share of a
   profiled iteration; (l) Fig. 4 head offload at the model level: the
   served prompts prefilled into one dense cache, one decode step with
   ``head_offload`` n in (0, 1, 20, 39), each n > 0 held to n = 0's
   logits within OFFLOAD_TOL and to two B5 launches per layer; (m) int8
   weights (``quantize_weights``: residency printed against bf16) served
   plain through ``Server`` (replayed; tokens scored against the
   quantized forward) and over two 2-stage pipelines with a forced
   4-layer span move (its accounted bytes printed, streams against the
   plain int8 run's).  Then (v) ``Orchestrator.run`` (the batch drive)
   on the plain run's configuration and requests: its streams must equal
   the ``Server`` run's bit for bit, B1, B2 and B3 launch; and (w) the
   multi-device runtime on a one-rank NCCL group and a 1 x 1 mesh:
   ``sharded_decode_attention`` at llama-13b's 40 heads of 128 over one
   row of 32,768 bf16 keys (B5 once, then the all_gather) against its
   plain version within TOL_SHARDED, timed beside its bound, plain and
   SDPA; granite-moe-3b-a800m's ``moe_apply(impl="local_sorted")`` on one
   shard equal to ``sorted`` bit for bit; ``build_pipeline_decode`` on
   llama-13b (one stage of 40 layers, 8 rows, a 1,024-slot dense cache),
   8 steps, each token within TOKEN_GAP_TOL of ``T.decode_step``'s best
   and B5 launched 40 times a step; and (x1) shared pages across span
   stages: a 2-stage ``DecodePipeline`` over [(0, 20), (20, 40)], two
   requests of one served prompt, the second bound to the first's full
   prompt pages on both stages (``slot_pages`` into ``shared_pages``;
   ``pages_shared`` printed per stage), then after 8 iterations a live
   4-layer span move, both streams through ``check_streams``, every
   stage's pool whole again, B1 and B2 launched.  With the weights freed,
   (x2) the dry run on this machine's torch: ``dryrun.run_one`` for
   llama3-405b decode_32k and granite-moe-3b-a800m train_4k on 16 x 16
   fake ranks (host only), each roofline printed; and (x3) its one-rank
   figures against the card: llama-13b at full size in bf16, a decode
   step of 8 rows over a 4,096-slot dense cache (B5 on every layer) and
   a fresh 1 x 4,096 prefill (B2), the dry run on a one-rank fake group,
   then the same ``steps.build`` step on values over a one-rank NCCL
   group and a 1 x 1 mesh: the dry run's resident bytes within 1 % of
   the ``memory_allocated`` delta, its flops equal to
   ``FlopCounterMode``'s, the kernel on every layer, the plain serving
   step (CUDA events) not under the roofline's largest term; the peaks
   and the measured-to-bound ratio printed.  Then, still without weights,
   (g) the serving CLI as two subprocesses, the live fleet over
   llama-13b (``--requests 8 --max-new 16 --max-len 1024 --autoscale
   --profiles h100_sxm``) and the simulator (``--backend sim --smoke``),
   each of which must exit 0 with every request completed, and (v)
   ``examples/torch_serve_disaggregated.py`` as two subprocesses, plain
   and ``--speculation ngram``, each exiting 0 after its own
   token-for-token check against a single-engine rollout.  Then the MoE
   stacks, in f32 (random weights from seed 0; a probe first prints how
   far bf16 rounding, amplified through the routing, moves granite-moe's
   logits, past what the teacher-forced rule can tell from a fault):
   (h) granite-moe-3b-a800m at full width and depth through ``Server``
   on the same 8 requests: plain with 256-token chunks, replayed (B1, B2
   and B3 must launch), the same run eagerly (streams and launch counts
   must equal the replayed run's), n-gram (B4 must launch) and
   ``with_kv_quant()`` plain, unchunked (B1-int8 must launch, the bf16
   page kernels and B3 must not); each prints its decode and prefill
   clocks, peak memory and the router load of its first wave, and the
   plain runs the device ms of one profiled decode iteration by family
   (expert GEMMs, the MoE's other ops, attention kernels, the rest);
   (i) ``Server`` over two 2-stage granite-moe decode pipelines with one
   forced span move of a quarter of the stack; then (h) plain once more
   with the weights in bf16, its clocks printed and its tokens reported
   against the bf16 forward, not scored; (j) grok-1-314b at full width,
   depth cut to 2 of its 64 layers, plain.  Every f32 served token is
   held to the teacher-forced rule, but those the int8 run decodes over
   its quantized cache: its first tokens are held to it, and the others
   are reported against two references of other GEMM shapes
   (``check_streams`` says why).  Last, the RG-LRU hybrid: (n)
   recurrentgemma-9b at full width and depth in bf16 (38 layers: 26
   RG-LRU, 12 local attention; random weights from seed 0; ``max_len``
   4096, so each local layer's 2048-slot ring is 128 pages of 16) through
   ``Server`` over one prefill and one decode member, 8 synthetic
   prompts of 1,286-2,995 tokens arriving at once (two past the window,
   one crossing position 2048 while decoding), 512-token chunks, 32
   tokens out, replayed and eagerly: every request completes, B1 and B2
   launch and B3, B4 and B5 do not, the two runs' streams and launches
   are equal, the pools are restored, every token is within
   TOKEN_GAP_TOL of the monolithic bf16 forward's best (its logits
   unembedded at the scored positions only: 256,000 entries each); it
   prints the decode clocks, the compiled step's device span, prefill
   tok/s, peak memory and one profiled iteration's device ms by family
   (GEMMs, the RG-LRU's elementwise work, B1, the rest); (o) two 2-stage
   decode pipelines over [(0, 19), (19, 38)]: after the third decode
   iteration a forced 4-layer span move (host ms; weight bytes, views;
   ring-page and recurrent-state bytes), then, with two residents, a
   KV_HEADS rebalance; every token within the gap, the streams reported
   against (n)'s.  Then the last two registry configs, in f32 (random
   weights from seed 0): (p) xlstm-350m at full width and depth (24
   layers: 18 mLSTM, 6 sLSTM; no attention, so both engines serve dense
   rows) through ``Server``, the 8 requests of the llama-13b runs
   arriving at once, 256-token chunks, replayed and eagerly: the forward
   scans launch (JAX's lax.scan loops; both designs of each, the
   prefill's full chunks on the chunkwise mLSTM and persistent sLSTM, its
   shorter last chunks under the chunkwise boundary on the one-pass
   mLSTM, the decode steps on the one-pass and step kernels) and no
   B-kernel, the
   two runs'
   streams and launches are equal, every token within TOKEN_GAP_TOL of
   the monolithic f32 forward's best; it prints the decode clocks, the compiled step's device span, prefill
   tok/s, peak memory and one profiled iteration's device ms by family
   (GEMMs, the xLSTM's elementwise and recurrence work, the rest); (q)
   two 2-stage decode pipelines over [(0, 12), (12, 24)] with one forced
   4-layer span move (three mLSTM, one sLSTM: host ms, weight bytes,
   state bytes per resident), its streams equal to (p)'s; (r)
   seamless-m4t-large-v2 at full width and depth (24 layers, 512 frames
   per request) through the engines, since the orchestrator carries no
   frames: 8 prompts of 600-1,500 tokens, each prefilled with its own
   random frames by ``PrefillEngine.run_batch([req], frames,
   chunk_tokens=512)`` and inserted into one paged ``DecodeEngine``
   (``max_len`` 2048), 32 tokens out, replayed and eagerly: B1, B2 and
   B5 (the cross attention's decode over the cached frames) launch and
   B3, B4 do not, streams and launches equal, every token within the gap
   of the monolithic forward given the same frames; it prints the
   clocks, the cross K/V bytes per request and one profiled iteration by
   family (GEMMs, B1, B5, the rest); (s) a
   2-stage ``PrefillPipeline`` and ``DecodePipeline`` over the same
   bounds with one forced 4-layer span move (its bytes, cross K/V
   included), its streams equal to (r)'s.  Last, training, in bf16 from
   seed 0 on ``SyntheticTokens`` (seed 0) through ``make_train_step``
   and AdamW, every launch counter zeroed before the steps and read after
   (no B-kernel may launch: JAX trains outside any Pallas kernel): (t)
   llama-13b at full width, depth cut to 8 layers (the whole model's
   weights, grads and f32 moments would need ~156 GB), 20 steps of 4 x
   1,024 tokens without remat (lr 1e-3, warmup 2, total 20); every loss
   and grad norm finite, the mean loss of the last five steps below that
   of the first five; then one step in two microbatches from the same
   parameters (loss and grad norm within MB_TOL_REL of the full batch's),
   a bit-exact ``save``/``restore`` round trip of the trained tree, and
   the trained weights served through ``PrefillEngine`` then
   ``DecodeEngine`` on the 8 requests (B1 and B2 must launch, every token
   within TOKEN_GAP_TOL); (u) granite-moe-3b-a800m at full size (router
   f32) with remat and no-drop sorted dispatch, 10 steps of 2 x 512
   tokens, its ``lb_loss`` finite every step; (y) xlstm-350m at full size
   in f32, 10 steps of 2 x 1,024 tokens, the chunkwise mLSTM forward and
   backward and the persistent sLSTM forward and backward launched once a
   layer and step (and no other).  Each prints ms per step (and AdamW's
   device ms of it), tokens/s, peak memory, the losses and the launches.
4. Print the ``kernels`` JSON line, then the result line.

The script imports nothing of the JAX package and needs no network.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
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

# Run (w)'s sharded attention: one row of 32,768 keys gives outputs of
# about sqrt(e / L) ~ 0.01, so TOL_BF16_OUT would be twice a typical
# value; 1e-3 (absolute, plus 1e-3 relative) still fails a kernel that
# drops a key block, and rounding to bf16 at |o| < 0.1 moves o by < 4e-4.
TOL_SHARDED = 1e-3

# Teacher-forced check: a served token must lie within this many logits
# of its step's best under the plain bf16 forward.  The paged kernels and
# the plain forward round bf16 activations at different places, and random
# weights leave near-ties, so equality of argmax is not the criterion.
TOKEN_GAP_TOL = 0.25

# The kernel cases at the served stacks' shapes (8 decode rows, 4 x 256
# prefill rows, 1024-token page space); the other cases are smaller.
SERVED_CASES = ("llama-13b", "granite-moe")

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


def verify_case(torch, gen, dev, dtype, *, b, s, h, kv, d, bs, nb, lengths,
                stale=2):
    """A speculative verify step: row r holds ``lengths[r]`` committed
    tokens plus the S in-flight ones (the pending token and its proposals)
    already written at positions lengths[r]..+S-1, and ``stale`` tokens
    rejected by an earlier verify just past them (written, to be masked).
    Rows with length None are empty slots: all-dead tables, positions
    0..S-1, as the engine gives them.  The scratch page and unassigned
    pages hold poison positions; each live row's first page has a hole."""
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
        if lengths[row] is None:
            continue
        total = lengths[row] + s
        for j in range(-(-total // bs)):
            tables[row, j] = nxt
            p = torch.arange(j * bs, (j + 1) * bs, device=dev,
                             dtype=torch.int32)
            p[p >= total + stale] = -1
            pos_pages[nxt] = p
            nxt += 1
        pos_pages[int(tables[row, 0]), 0] = -1                  # a hole
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    pos_q = (torch.as_tensor([n or 0 for n in lengths], dtype=torch.int32,
                             device=dev)[:, None]
             + torch.arange(s, dtype=torch.int32, device=dev))
    return q, k_pages, v_pages, pos_pages, tables, pos_q


def ring_case(torch, gen, dev, dtype, *, h, kv, d, bs, nb, lengths):
    """One decode step of rows served over a windowed ring of nb * bs
    slots (recurrentgemma-9b's local attention): row r has written
    ``lengths[r]`` tokens, position p in slot p % (nb * bs), so a row past
    the ring's length holds its last nb * bs positions out of order
    across its pages (wrapped); its pages sit at shuffled physical ids.
    The query is at position length - 1.  A length of None is an empty
    slot (an all-dead table).  The scratch page and unassigned pages hold
    poison positions."""
    b = len(lengths)
    plen = nb * bs
    n_phys = 1 + b * nb
    k_pages = torch.randn((n_phys, bs, kv, d), generator=gen, device=dev
                          ).to(dtype)
    v_pages = torch.randn((n_phys, bs, kv, d), generator=gen, device=dev
                          ).to(dtype)
    pos_pages = torch.randint(0, 2 * plen, (n_phys, bs), generator=gen,
                              device=dev, dtype=torch.int32)   # poison
    tables = torch.full((b, nb), -1, dtype=torch.int32, device=dev)
    phys = (torch.randperm(n_phys - 1, generator=gen, device=dev) + 1
            ).to(torch.int32)
    nxt = 0
    for row, n in enumerate(lengths):
        if n is None:
            continue
        for j in range(min(-(-n // bs), nb)):
            tables[row, j] = phys[nxt]
            slot = torch.arange(j * bs, (j + 1) * bs, device=dev)
            # the last position written to each slot (-1: never)
            p = slot + plen * ((n - 1 - slot) // plen)
            pos_pages[int(phys[nxt])] = torch.where(
                slot < n, p, -1).to(torch.int32)
            nxt += 1
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    pos_q = torch.as_tensor([(n or 1) - 1 for n in lengths],
                            dtype=torch.int32, device=dev)
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


def needed_page_bytes(torch, k_pages, pos_pages, tables, pos_q, window):
    """What the paged-prefix function needs to read: the positions of every
    referenced page, and K + V of the distinct pages holding a key some
    query of its row sees."""
    safe = tables.clamp_min(0).long()
    pk = pos_pages[safe]                                 # (B, nb, bs)
    pq = pos_q.reshape(tables.shape[0], 1, 1, -1)
    ok = (pk[..., None] >= 0) & (pk[..., None] <= pq)
    if window is not None:
        ok &= pk[..., None] > pq - window
    seen = ok.flatten(2).any(dim=2) & (tables >= 0)
    n_kv = torch.unique(tables[seen]).numel()
    n_pos = torch.unique(tables[tables >= 0]).numel()
    return (n_kv * k_pages[0].numel() * k_pages.element_size() * 2
            + n_pos * pos_pages[0].numel() * 4)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


PROFILE_TRIES = 3


def profile_ms(torch, fn, iters: int, warmup: int = 3,
               bound_ms: float = None):
    """Device time of one call, and of each kernel (and copy) in it, by
    torch.profiler over ``iters`` back-to-back calls after a warm-up.
    Host dispatch is left out, so a kernel and its yardsticks compare on
    the card's time alone.  Returns (ms, {kernel name: ms}).

    The profiler loses kernel events on the H100 machine: later in a
    process a trace comes back a few launches short (95 of 100, 15 of 20)
    however long it is, so its sum over ``iters`` reads low (B5 at
    32,768 keys read 0.18 ms a call of 0.24).  So each kernel's time is
    its mean over the launches the trace kept times its launches per call
    (its count over ``iters``, rounded up); with nothing lost, that is the
    trace's sum over ``iters``.  Where every one of ``PROFILE_TRIES``
    traces holds no device time (the loss grows with the traces and
    captures a process has made), the call is timed by CUDA events
    instead (``queued_ms``) and no kernel's time is returned.  A reading
    under the caller's ``bound_ms`` fails the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    where = f"chip_smoke.py:{fn.__code__.co_firstlineno}"
    # a trace now and then comes back without device time
    for attempt in range(PROFILE_TRIES):
        if attempt:
            say(f"[profile] empty trace {attempt} of the call at {where}: "
                f"{len(prof.key_averages())} entries, none on the device")
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {e.key: device_us(e) / e.count * -(-e.count // iters) / 1e3
               for e in device_kernels(prof.key_averages()) if e.count}
        ms = sum(per.values())
        if ms > 0:
            break
    else:
        ms, per = queued_ms(torch, fn, iters), {}
        say(f"[profile] the profiler recorded no device time in "
            f"{PROFILE_TRIES} traces of the call at {where}: timed by CUDA "
            f"events instead, {ms:.4f} ms a call")
    if bound_ms is not None and ms < bound_ms:
        fail(f"the call at {where} reads {ms:.4f} ms, under its bound "
             f"{bound_ms:.4f} ms")
    return ms, per


def time_ms(torch, fn, iters: int, warmup: int = 3,
            bound_ms: float = None) -> float:
    """``profile_ms``'s time of one call."""
    return profile_ms(torch, fn, iters, warmup, bound_ms)[0]


def cycled(copies, fn):
    """A call of ``fn(*copy)`` on the next of ``copies`` in turn.  A timed
    kernel then reads its inputs from memory, as a serving step does (other
    layers' weights and caches run between two of its calls); called back
    to back on one copy that fits the card's 50 MB L2, it would read them
    from there."""
    turn = [0]

    def call():
        turn[0] += 1
        return fn(*copies[turn[0] % len(copies)])
    return call


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
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   paged_prefix_partials,
                                                   prefix_pages_per_split)
    from repro_torch.kernels.split_kv_decode import (
        decode_pages_per_split, paged_decode_partials,
        paged_verify_partials, split_kv_decode_partials,
        verify_pages_per_split)
    from repro_torch.models.layers import quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # B5 draws from a generator of its own, so the B1-B4 inputs are the
    # same as before B5 was added
    gen5 = torch.Generator(device=dev).manual_seed(5)
    # granite-moe-3b-a800m's case draws from its own generator too, so the
    # other cases' inputs stay as they were before it was added
    gen_moe = torch.Generator(device=dev).manual_seed(6)
    # (label, heads, kv heads, head_dim, window, soft cap); the third case
    # also takes the kernels' widest head_dim; granite-moe is head_dim 64
    # with 3 query heads per kv head (15 verify rows per kv head)
    cases = [("llama-13b", 40, 40, 128, None, None),
             ("granite-8b GQA", 32, 8, 128, None, None),
             ("window+cap", 8, 2, 256, 48, 30.0),
             ("granite-moe", 24, 8, 64, None, None)]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        for label, h, kv, d, win, cap in cases:
            # the served stacks' cases take the serving path's shapes
            main = label in SERVED_CASES
            g = gen_moe if label == "granite-moe" else gen
            g5 = gen_moe if label == "granite-moe" else gen5
            bs, nb = 16, 64                           # max_len 1024
            b_dec = 8 if main else 4
            lengths = [int(x) for x in torch.randint(
                1, nb * bs, (b_dec,), generator=g, device=dev)]
            # -- B1: paged decode partials
            q, kp, vp, pp, tb, pq = paged_case(
                torch, g, dev, dtype, b=b_dec, h=h, kv=kv, d=d, bs=bs,
                nb=nb, lengths=lengths)
            if main:
                tb[-1] = -1                # an empty slot: all-dead row
            kw = dict(window=win, soft_cap=cap)
            # one partial per page (the TPU contract), per 3 pages (ragged
            # last split, dead splits) and per the serving path's split
            pps_dec = decode_pages_per_split(q, kv, nb)

            def b1_check(key, pools, sc):
                err = 0.0
                for pps in (1, 3, pps_dec):
                    got = paged_decode_partials(q, *pools, pp, tb, pq, **kw,
                                                **sc, pages_per_split=pps)
                    want = ref.paged_decode_partials_plain(
                        q, *pools, pp, tb, pq, **kw, **sc,
                        pages_per_split=pps)
                    torch.cuda.synchronize()
                    err = max(err, check_close(
                        torch, f"{key} {label} {tname} pages_per_split "
                        f"{pps}", got, want, TOL_F32))
                    del got, want
                results[(key, label, tname)] = dict(
                    err=err, args=(q, *pools, pp, tb, pq), scales=sc,
                    pps=pps_dec)

            b1_check("B1", (kp, vp), {})
            # -- B1-int8: the same pools quantized, scales per entry
            kq, ksc = quantize_kv(kp)
            vq, vsc = quantize_kv(vp)
            b1_check("B1-int8", (kq, vq),
                     dict(k_scale_pages=ksc, v_scale_pages=vsc))
            # -- B3: paged prefix partials (chunk 256 after a prefix)
            s = 256 if main else 64
            b_pre = 4 if main else 2
            n_prefix = [int(x) * bs for x in torch.randint(
                1, (nb * bs - s) // bs, (b_pre,), generator=g, device=dev)]
            q3, kp3, vp3, pp3, tb3, pq3 = paged_case(
                torch, g, dev, dtype, b=b_pre, h=h, kv=kv, d=d, bs=bs,
                nb=nb, lengths=None, s=s, n_prefix=n_prefix)
            # one partial per page (the TPU contract), per 3 pages (ragged
            # last split, dead splits) and per the serving path's split
            pps_srv = prefix_pages_per_split(q3, kv, nb)
            err = 0.0
            for pps in (1, 3, pps_srv):
                got = paged_prefix_partials(q3, kp3, vp3, pp3, tb3, pq3,
                                            pages_per_split=pps, **kw)
                want = ref.paged_prefix_partials_plain(
                    q3, kp3, vp3, pp3, tb3, pq3, pages_per_split=pps, **kw)
                torch.cuda.synchronize()
                err = max(err, check_close(
                    torch, f"B3 {label} {tname} pages_per_split {pps}", got,
                    want, TOL_F32))
                del got, want
            results[("B3", label, tname)] = dict(
                err=err, args=(q3, kp3, vp3, pp3, tb3, pq3), pps=pps_srv)
            # -- B2: flash prefill, normalized and partials
            b2, s2 = (4, 256) if main else (2, 192)
            q2 = torch.randn((b2, s2, h, d), generator=g, device=dev
                             ).to(dtype)
            k2 = torch.randn((b2, s2, kv, d), generator=g, device=dev
                             ).to(dtype)
            v2 = torch.randn((b2, s2, kv, d), generator=g, device=dev
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
            del got, want, gp, wp
            # -- B4: speculative verify partials (S = spec_len + 1 = 5)
            sv = 5
            vlen = [int(x) for x in torch.randint(
                1, nb * bs - sv - 2, (b_dec,), generator=g, device=dev)]
            if main:
                vlen[-1] = None            # an empty slot: all-dead row
            q4, kp4, vp4, pp4, tb4, pq4 = verify_case(
                torch, g, dev, dtype, b=b_dec, s=sv, h=h, kv=kv, d=d,
                bs=bs, nb=nb, lengths=vlen)
            # one partial per page (the TPU contract), per 3 pages and per
            # the serving path's split

            def b4_check(key, pools, sc):
                err = 0.0
                pps_ver = verify_pages_per_split(q4, kv, nb, int8=bool(sc))
                for pps in (1, 3, pps_ver):
                    got = paged_verify_partials(q4, *pools, pp4, tb4, pq4,
                                                **kw, **sc,
                                                pages_per_split=pps)
                    want = ref.paged_verify_partials_plain(
                        q4, *pools, pp4, tb4, pq4, **kw, **sc,
                        pages_per_split=pps)
                    torch.cuda.synchronize()
                    err = max(err, check_close(
                        torch, f"{key} {label} {tname} pages_per_split "
                        f"{pps}", got, want, TOL_F32))
                    del got, want
                results[(key, label, tname)] = dict(
                    err=err, args=(q4, *pools, pp4, tb4, pq4), scales=sc,
                    pps=pps_ver)

            b4_check("B4", (kp4, vp4), {})
            # -- B4-int8
            kq4, ksc4 = quantize_kv(kp4)
            vq4, vsc4 = quantize_kv(vp4)
            b4_check("B4-int8", (kq4, vq4),
                     dict(k_scale_pages=ksc4, v_scale_pages=vsc4))
            # -- B5: split-KV decode over a dense cache (no window or cap:
            # the TPU kernel has neither); the main case at llama-13b's
            # decode shape, the others with L off the block multiple
            b5, l5 = (8, nb * bs) if main else (3, 600)
            q5 = torch.randn((b5, h, d), generator=g5, device=dev).to(dtype)
            k5 = torch.randn((b5, l5, kv, d), generator=g5, device=dev
                             ).to(dtype)
            v5 = torch.randn((b5, l5, kv, d), generator=g5, device=dev
                             ).to(dtype)
            lens5 = torch.randint(1, l5 + 1, (b5, 1), generator=g5,
                                  device=dev)
            valid5 = torch.arange(l5, device=dev)[None] < lens5
            got = ops.decode_partials(q5, k5, v5, valid5, block_k=512)
            pad5 = (-l5) % 512
            want = ref.split_kv_decode_partials_plain(
                q5, F.pad(k5, (0, 0, 0, 0, 0, pad5)),
                F.pad(v5, (0, 0, 0, 0, 0, pad5)), F.pad(valid5, (0, pad5)),
                block_k=512)
            torch.cuda.synchronize()
            err5 = check_close(torch, f"B5 {label} {tname}", got, want,
                               TOL_F32)
            # the combined output in q's dtype, against the one-softmax
            # reference (reported apart from the f32 partials' error)
            out5 = check_close(
                torch, f"B5 decode_attention {label} {tname}",
                ops.decode_attention(q5, k5, v5, valid5, block_k=512),
                ref.decode_attention_reference(q5, k5, v5, valid5),
                TOL_F32 if dtype == torch.float32 else TOL_BF16_OUT)
            results[("B5", label, tname)] = dict(
                err=err5, out_err=out5, args=(q5, k5, v5, valid5))
            del got, want
            say(f"kernels vs plain [{label}, {tname}]: max |err| " + "  ".join(
                f"{kk} {results[(kk, label, tname)]['err']:.2e}"
                for kk in ("B1", "B1-int8", "B2", "B3", "B4", "B4-int8",
                           "B5")) + f"  (B5 combined output {out5:.2e})")

    # -- timings at the served stacks' shapes (bf16): llama-13b's under the
    # kernels' own keys, granite-moe's under "<kernel> granite-moe"
    timing = serving_timings(torch, results, "llama-13b", "")
    timing.update(serving_timings(torch, results, "granite-moe",
                                  " granite-moe"))
    r1 = results[("B1", "llama-13b", "bfloat16")]
    q, kp, vp, pp, tb, pq = r1["args"]
    b, h, d = q.shape
    nb, bs, kv = tb.shape[1], kp.shape[1], kp.shape[2]
    # one 1024-token sequence: the int8 runs' longest unchunked wave
    gl = torch.Generator(device=dev).manual_seed(2)
    ql, kl_, vl_ = (torch.randn((1, 1024, h, d), generator=gl, device=dev
                                ).to(torch.bfloat16) for _ in range(3))
    qlt, klt, vlt = (t.transpose(1, 2).contiguous() for t in (ql, kl_, vl_))
    check_close(torch, "B2 (1, 1024) bfloat16", flash_prefill(ql, kl_, vl_),
                ref.flash_prefill_plain(ql, kl_, vl_), TOL_BF16_OUT)
    timing["B2 (1, 1024)"] = dict(
        ms=time_ms(torch, lambda: flash_prefill(ql, kl_, vl_), 50),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qlt, klt, vlt, is_causal=True), 50),
        bytes=4 * nbytes(ql), flops=4 * d * h * 1024 * 1025 // 2,
        dtype="bfloat16")
    # B4's two bodies on the same verify inputs at B4's serving split: the
    # key walk (from a copy of B4 built with every row count on the walk)
    # and B3's tensor-core body (prefix_kernel, through B3's own entry), at
    # llama-13b's 5 query rows per kv head, granite-8b's 20 (GQA 4) and
    # llama3-405b's 80 (GQA 16); B4 runs the walk up to 8 rows, B3's body
    # above (csrc/paged_verify.cu)
    gen_v = torch.Generator(device=dev).manual_seed(4)
    v405 = verify_case(torch, gen_v, dev, torch.bfloat16, b=4, s=5, h=128,
                       kv=8, d=128, bs=bs, nb=nb, lengths=[
                           int(x) for x in torch.randint(
                               1, nb * bs - 7, (4,), generator=gen_v,
                               device=dev)])
    shapes = [(name, results[("B4", name, "bfloat16")]["args"])
              for name in ("llama-13b", "granite-8b GQA")]
    shapes.append(("llama3-405b heads", v405))
    r4g = results[("B4", "granite-8b GQA", "bfloat16")]
    timing["B4 granite-8b GQA"] = verify_timing(torch, r4g["args"], {},
                                                r4g["pps"], 100)
    flags = _lib.NVCC_FLAGS
    _lib.NVCC_FLAGS = flags + ("-DREPRO_VERIFY_WALK_ROWS=1024",)
    _lib._loaded.pop("paged_verify", None)
    try:
        for label, args in shapes:
            _, sv, hv, _ = args[0].shape
            kvv = args[1].shape[2]
            pps_g = verify_pages_per_split(args[0], kvv, nb)
            for body, fn in (("walk", paged_verify_partials),
                             ("B3 body", paged_prefix_partials)):
                check_close(torch, f"B4 {body} on verify inputs, {label}",
                            fn(*args, pages_per_split=pps_g),
                            ref.paged_verify_partials_plain(
                                *args, pages_per_split=pps_g), TOL_F32)
                timing[f"B4 {body} {label}, S*G {sv * hv // kvv}"] = \
                    verify_timing(torch, args, {}, pps_g, 100, fn)
    finally:
        _lib.NVCC_FLAGS = flags
        _lib._loaded.pop("paged_verify", None)
    # B5 with every key valid: like for like with SDPA, which then needs no
    # mask
    q5, k5, v5, valid5 = results[("B5", "llama-13b", "bfloat16")]["args"]
    qt5, kt5, vt5 = q5[:, :, None], k5.transpose(1, 2), v5.transpose(1, 2)
    all5 = torch.ones_like(valid5)
    check_close(torch, "B5 every key valid",
                split_kv_decode_partials(q5, k5, v5, all5, block_k=512),
                ref.split_kv_decode_partials_plain(q5, k5, v5, all5,
                                                   block_k=512), TOL_F32)
    timing["B5 every key valid"] = dict(
        b5_timing(torch, q5, k5, v5, all5, 200),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt5, kt5, vt5), 50))
    # B5 at the dense-row serving shape of run (k): 8 rows of a 1000-slot
    # cache (max_len 1000), read in place with the last 512-key block
    # ragged (488 keys; no padded copy), valid up to the served lengths
    gd = torch.Generator(device=dev).manual_seed(7)
    qd = torch.randn((8, h, d), generator=gd, device=dev).to(torch.bfloat16)
    kd, vd = (torch.randn((8, 1000, kv, d), generator=gd, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    validd = torch.arange(1000, device=dev)[None] < torch.randint(
        189, 640, (8, 1), generator=gd, device=dev)
    err_d = check_close(
        torch, "B5 dense rows (8 x 1000 keys)",
        split_kv_decode_partials(qd, kd, vd, validd, block_k=512),
        ref.split_kv_decode_partials_plain(qd, kd, vd, validd, block_k=512),
        TOL_F32)
    # timed from memory, as a serving step reads it (other layers' weights
    # and caches between two of its calls): the calls cycle over three
    # copies of the cache, 492 MB, ten times the card's 50 MB L2; back to
    # back on one copy, much of it is served from L2
    copies = [(kd, vd)] + [(kd.clone(), vd.clone()) for _ in range(2)]
    timing["B5 dense rows (8 x 1000 keys)"] = dict(
        b5_timing(torch, qd, kd, vd, validd, 200, fn=cycled(
            copies, lambda k_, v_: split_kv_decode_partials(
                qd, k_, v_, validd, block_k=512))),
        plain_ms=time_ms(torch, lambda: ref.split_kv_decode_partials_plain(
            qd, kd, vd, validd, block_k=512), 20),
        library_ms=time_ms(torch, cycled(
            copies, lambda k_, v_: F.scaled_dot_product_attention(
                qd[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=validd[:, None, None, :])), 50))
    warm_ms = time_ms(torch, lambda: split_kv_decode_partials(
        qd, kd, vd, validd, block_k=512), 200)
    say(f"B5 dense rows (8 x 1000 keys, 40/40 heads of 128, block_k 512, "
        f"last block ragged): max |err| vs plain {err_d:.2e}; "
        f"{warm_ms:.4f} ms back to back on one copy (L2-warm)")
    del kd, vd, copies
    timing.update(hybrid_kernels(torch, results))
    timing.update(seamless_kernels(torch, results))
    timing.update(xlstm_scan_kernels(torch, results))
    errs = kernel_errs(results, ("B1", "B1-int8", "B2", "B3", "B4",
                                 "B4-int8", "B5") + tuple(SCAN_KEYS.values()))
    errs["B5"] = max(errs["B5"], err_d)
    return timing, errs


def kernel_errs(results, names) -> dict:
    """The largest |kernel - plain| of each row ``names`` of the kernels
    line, over its cases in ``results`` ({(key, label, dtype): {"err":
    ...}})."""
    return {kname: max(v["err"] for (kk, _, _), v in results.items()
                       if kk == kname) for kname in names}


def verify_timing(torch, args, sc, pps, iters, fn=None):
    """A verify kernel (B4, B4-int8, or ``fn``: B3's body on the same
    inputs) at ``pps`` pages per split; its bytes: q, the table and
    positions, each live page's K/V (int8: and their f32 scales) and
    positions, and the partials its split writes."""
    from repro_torch.kernels.split_kv_decode import paged_verify_partials
    fn = fn or paged_verify_partials
    qq, kk, _, pp_, tb_, pq_ = args
    bq, sq, hq, dq = qq.shape
    nbq, bsq, kvq = tb_.shape[1], kk.shape[1], kk.shape[2]
    n_live = torch.unique(tb_[tb_ >= 0]).numel()
    per_page = 2 * kk[0].numel() * kk.element_size() + bsq * 4 \
        + (2 * bsq * kvq * 4 if sc else 0)
    out_b = bq * -(-nbq // pps) * sq * hq * (dq + 2) * 4
    return dict(
        ms=time_ms(torch, lambda: fn(*args, **sc, pages_per_split=pps),
                   iters),
        bytes=nbytes(qq, tb_, pq_) + n_live * per_page + out_b,
        flops=4 * dq * hq * visible_pairs(torch, pp_, tb_, pq_, None),
        dtype="bfloat16", pages_per_split=pps)


def b5_timing(torch, q5, k5, v5, valid, iters, fn=None):
    """B5 over ``valid`` (block_k 512, the last block ragged when 512 does
    not divide L), or ``fn`` (B5 on copies of the same inputs); its bytes:
    q, the validity flags, K and V of the key tiles that hold a valid key
    (the tiles it reads) and the per-block partials."""
    from repro_torch.kernels.split_kv_decode import (decode_tile_keys,
                                                     split_kv_decode_partials)
    b5, l5, kv, d = k5.shape
    h = q5.shape[1]
    nj = -(-l5 // 512)
    tile5 = decode_tile_keys(d, k5.element_size())
    blocks = torch.nn.functional.pad(valid, (0, nj * 512 - l5)).reshape(
        b5, nj, 512)
    n_tiles = -(-512 // tile5)
    pad = n_tiles * tile5 - 512
    tiles = torch.nn.functional.pad(blocks, (0, pad)).reshape(
        b5, nj, n_tiles, tile5)
    # keys in tile t of block j: the last block holds only L - 512 j
    per_tile = torch.as_tensor(
        [[max(0, min(tile5, min(512, l5 - j * 512) - t * tile5))
          for t in range(n_tiles)] for j in range(nj)],
        dtype=torch.float32, device=valid.device)
    keys = tiles.any(dim=3).float() * per_tile
    read = int(keys.sum()) * kv * d * k5.element_size() * 2
    return dict(
        ms=time_ms(torch, fn or (lambda: split_kv_decode_partials(
            q5, k5, v5, valid, block_k=512)), iters),
        bytes=nbytes(q5, valid) + read + b5 * nj * h * (d + 2) * 4,
        flops=4 * d * h * int(valid.sum()), dtype="bfloat16")


def serving_timings(torch, results, label, tag):
    """Each kernel's card time, plain and library time at one served
    stack's bf16 shapes (``kernel_phase``'s ``label`` case), under the keys
    "<kernel><tag>"; B1, B1-int8, B3, B4 and B4-int8 at the serving split,
    and again at one partial per page ("<kernel><tag> per page")."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   paged_prefix_partials)
    from repro_torch.kernels.split_kv_decode import paged_decode_partials

    timing = {}
    r1 = results[("B1", label, "bfloat16")]
    q, kp, vp, pp, tb, pq = r1["args"]
    b, h, d = q.shape
    nb, bs, kv = tb.shape[1], kp.shape[1], kp.shape[2]

    def lib_decode():
        kl = kp[tb.clamp_min(0).long()].reshape(b, nb * bs, kv, d)
        vl = vp[tb.clamp_min(0).long()].reshape(b, nb * bs, kv, d)
        pk = torch.where((tb >= 0)[:, :, None], pp[tb.clamp_min(0).long()],
                         -1).reshape(b, 1, 1, -1)
        mask = (pk >= 0) & (pk <= pq[:, None, None, None])
        return F.scaled_dot_product_attention(
            q[:, :, None], kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    def b1_timing(key, pps, iters):
        """B1 (or B1-int8) at ``pps`` pages per split; its bytes: q, the
        table and positions, each live page's K/V (int8: and their f32
        scales) and positions, and the partials written."""
        r = results[(key, label, "bfloat16")]
        args, sc = r["args"], r["scales"]
        pairs = visible_pairs(torch, pp, tb, pq, None)
        n_live = torch.unique(tb[tb >= 0]).numel()
        elem = args[1].element_size()
        per_page = 2 * bs * kv * d * elem + bs * 4 \
            + (2 * bs * kv * 4 if sc else 0)
        out_b = b * -(-nb // pps) * h * (d + 2) * 4
        return dict(
            ms=time_ms(torch, lambda: paged_decode_partials(
                *args, **sc, pages_per_split=pps), iters),
            bytes=nbytes(q, tb, pq) + n_live * per_page + out_b,
            flops=4 * d * h * pairs, dtype="bfloat16", pages_per_split=pps)

    pps1 = r1["pps"]
    # JAX's one partial per page, reported on a line of its own
    timing[f"B1{tag} per page"] = b1_timing("B1", 1, 200)
    timing[f"B1{tag}"] = dict(
        b1_timing("B1", pps1, 200),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_partials_plain(
            q, kp, vp, pp, tb, pq, pages_per_split=pps1), 20),
        library_ms=time_ms(torch, lib_decode, 50))

    r3 = results[("B3", label, "bfloat16")]
    q3, kp3, vp3, pp3, tb3, pq3 = r3["args"]
    b3, s3 = q3.shape[:2]
    pps3 = r3["pps"]
    pairs = visible_pairs(torch, pp3, tb3, pq3, None)
    in_b = nbytes(q3, tb3, pq3) + needed_page_bytes(torch, kp3, pp3, tb3,
                                                    pq3, None)

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

    def b3_timing(pps, iters):
        n_split = -(-nb // pps)
        return dict(
            ms=time_ms(torch, lambda: paged_prefix_partials(
                q3, kp3, vp3, pp3, tb3, pq3, pages_per_split=pps), iters),
            bytes=in_b + b3 * n_split * s3 * h * (d + 2) * 4,
            flops=4 * d * h * pairs, dtype="bfloat16", pages_per_split=pps)

    # JAX's one partial per page, reported on a line of its own
    timing[f"B3{tag} per page"] = b3_timing(1, 20)
    timing[f"B3{tag}"] = dict(
        b3_timing(pps3, 50),
        plain_ms=time_ms(torch, lambda: ref.paged_prefix_partials_plain(
            q3, kp3, vp3, pp3, tb3, pq3, pages_per_split=pps3), 5),
        library_ms=time_ms(torch, lib_prefix, 20))

    q2, k2, v2 = results[("B2", label, "bfloat16")]["args"]
    b2, s2 = q2.shape[:2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q2, k2, v2))
    timing[f"B2{tag}"] = dict(
        ms=time_ms(torch, lambda: flash_prefill(q2, k2, v2), 50),
        plain_ms=time_ms(torch, lambda: ref.flash_prefill_plain(q2, k2, v2),
                         10),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != kv), 50),
        bytes=nbytes(q2, k2, v2) + nbytes(q2),        # q, k, v in; out
        flops=4 * d * h * b2 * s2 * (s2 + 1) // 2, dtype="bfloat16")

    r4 = results[("B4", label, "bfloat16")]
    q4, kp4, vp4, pp4, tb4, pq4 = r4["args"]
    b4 = q4.shape[0]

    def lib_verify():
        kl = kp4[tb4.clamp_min(0).long()].reshape(b4, nb * bs, kv, d)
        vl = vp4[tb4.clamp_min(0).long()].reshape(b4, nb * bs, kv, d)
        pk = torch.where((tb4 >= 0)[:, :, None],
                         pp4[tb4.clamp_min(0).long()], -1
                         ).reshape(b4, 1, 1, -1)
        mask = (pk >= 0) & (pk <= pq4[:, None, :, None])     # (B, 1, S, L)
        return F.scaled_dot_product_attention(
            q4.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    pps4 = r4["pps"]
    # JAX's one partial per page, reported on a line of its own
    timing[f"B4{tag} per page"] = verify_timing(torch, r4["args"], {}, 1, 200)
    timing[f"B4{tag}"] = dict(
        verify_timing(torch, r4["args"], {}, pps4, 200),
        plain_ms=time_ms(torch, lambda: ref.paged_verify_partials_plain(
            *r4["args"], pages_per_split=pps4), 20),
        library_ms=time_ms(torch, lib_verify, 50))

    def lib_int8(args, scales, s_axis):
        """Dequantize-gather the int8 pages to bf16, then masked SDPA."""
        qq, kq, vq, pp_, tb_, pq_ = args
        bq = qq.shape[0]
        safe = tb_.clamp_min(0).long()
        ks_ = scales["k_scale_pages"][safe][..., None]
        vs_ = scales["v_scale_pages"][safe][..., None]
        kl = (kq[safe] * ks_).to(qq.dtype).reshape(bq, nb * bs, kv, d)
        vl = (vq[safe] * vs_).to(qq.dtype).reshape(bq, nb * bs, kv, d)
        pk = torch.where((tb_ >= 0)[:, :, None], pp_[safe], -1
                         ).reshape(bq, 1, 1, -1)
        if s_axis:                                  # verify: (B, S, H, D)
            mask = (pk >= 0) & (pk <= pq_[:, None, :, None])
            qt = qq.transpose(1, 2)
        else:                                       # decode: (B, H, D)
            mask = (pk >= 0) & (pk <= pq_[:, None, None, None])
            qt = qq[:, :, None]
        return F.scaled_dot_product_attention(
            qt, kl.transpose(1, 2), vl.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    r1q = results[("B1-int8", label, "bfloat16")]
    timing[f"B1-int8{tag} per page"] = b1_timing("B1-int8", 1, 200)
    timing[f"B1-int8{tag}"] = dict(
        b1_timing("B1-int8", pps1, 200),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_partials_plain(
            *r1q["args"], **r1q["scales"], pages_per_split=pps1), 20),
        library_ms=time_ms(torch, lambda: lib_int8(r1q["args"],
                                                   r1q["scales"], False),
                           50))
    r4q = results[("B4-int8", label, "bfloat16")]
    timing[f"B4-int8{tag} per page"] = verify_timing(
        torch, r4q["args"], r4q["scales"], 1, 200)
    pps4q = r4q["pps"]
    timing[f"B4-int8{tag}"] = dict(
        verify_timing(torch, r4q["args"], r4q["scales"], pps4q, 200),
        plain_ms=time_ms(torch, lambda: ref.paged_verify_partials_plain(
            *r4q["args"], **r4q["scales"], pages_per_split=pps4q), 20),
        library_ms=time_ms(torch, lambda: lib_int8(r4q["args"],
                                                   r4q["scales"], True), 50))

    q5, k5, v5, valid5 = results[("B5", label, "bfloat16")]["args"]
    qt5, kt5, vt5 = q5[:, :, None], k5.transpose(1, 2), v5.transpose(1, 2)
    timing[f"B5{tag}"] = dict(
        b5_timing(torch, q5, k5, v5, valid5, 200),
        plain_ms=time_ms(torch, lambda: ref.split_kv_decode_partials_plain(
            q5, k5, v5, valid5, block_k=512), 20),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt5, kt5, vt5, attn_mask=valid5[:, None, None, :],
            enable_gqa=h != kv), 50))
    return timing


# recurrentgemma-9b's local attention: 16 query heads on one kv head of
# 256, a 2048-token window, the ring of 128 pages of 16 per row; 8 decode
# rows, three of them wrapped past position 2048, one empty slot
HYBRID_RING = dict(h=16, kv=1, d=256, bs=16, nb=128)
HYBRID_LENGTHS = [3000, 2600, 2049, 2045, 1500, 1286, 700, None]
HYBRID_WINDOW = 2048


def hybrid_kernels(torch, results):
    """B1 and B2 at recurrentgemma-9b's serving shapes, in f32 and bf16:
    B1 on the ring-wrapped table (``ring_case``) at one partial per page,
    per 3 pages and at the serving split; B2 at 1 x 2048 and 4 x 512
    tokens (a fresh wave and a chunked one) and, checked only, at 1 x 3000
    (the window cuts).  Errors go into ``results`` under the label
    "recurrentgemma-9b"; returns the bf16 timings under "B1
    recurrentgemma-9b", "B2 recurrentgemma-9b (1, 2048)" and "(4, 512)":
    the kernel, its plain version, a library yardstick (gather + SDPA
    under the window mask; SDPA, causal) and the bound's bytes and flops
    (B1: the in-window live pages, from ``needed_page_bytes``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.split_kv_decode import (decode_pages_per_split,
                                                     paged_decode_partials)

    dev = torch.device("cuda")
    label, win = "recurrentgemma-9b", HYBRID_WINDOW
    h, kv, d = HYBRID_RING["h"], HYBRID_RING["kv"], HYBRID_RING["d"]
    timing, args = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(9)
        a1 = ring_case(torch, g, dev, dtype, lengths=HYBRID_LENGTHS,
                       **HYBRID_RING)
        pps = decode_pages_per_split(a1[0], kv, HYBRID_RING["nb"])
        err = 0.0
        for split in (1, 3, pps):
            err = max(err, check_close(
                torch, f"B1 {label} {tname} pages_per_split {split}",
                paged_decode_partials(*a1, window=win,
                                      pages_per_split=split),
                ref.paged_decode_partials_plain(*a1, window=win,
                                                pages_per_split=split),
                TOL_F32))
        results[("B1", label, tname)] = dict(err=err)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16_OUT
        err2 = 0.0
        for b2, s2 in ((1, 2048), (4, 512), (1, 3000)):
            q2, k2, v2 = (torch.randn((b2, s2, n, d), generator=g,
                                      device=dev).to(dtype)
                          for n in (h, kv, kv))
            err2 = max(err2, check_close(
                torch, f"B2 {label} ({b2}, {s2}) {tname}",
                ops.flash_attention(q2, k2, v2, window=win),
                ref.flash_prefill_plain(q2, k2, v2, window=win), tol))
            if dtype == torch.bfloat16 and s2 <= 2048:
                args[(b2, s2)] = (q2, k2, v2)
        results[("B2", label, tname)] = dict(err=err2)
        if dtype == torch.bfloat16:
            args["B1"] = (a1, pps)
        say(f"kernels vs plain [{label} ring, 16/1 heads of 256, window "
            f"{win}, {tname}]: max |err| B1 {err:.2e} (rows of "
            f"{HYBRID_LENGTHS} tokens), B2 {err2:.2e}")

    (q, kp, vp, pp, tb, pq), pps = args["B1"]
    b, nb, bs = q.shape[0], tb.shape[1], kp.shape[1]
    pairs = visible_pairs(torch, pp, tb, pq, win)

    def lib_decode():
        safe = tb.clamp_min(0).long()
        kl = kp[safe].reshape(b, nb * bs, kv, d)
        vl = vp[safe].reshape(b, nb * bs, kv, d)
        pk = torch.where((tb >= 0)[:, :, None], pp[safe], -1
                         ).reshape(b, 1, 1, -1)
        pqq = pq[:, None, None, None]
        mask = (pk >= 0) & (pk <= pqq) & (pk > pqq - win)
        return F.scaled_dot_product_attention(
            q[:, :, None], kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    timing[f"B1 {label}"] = dict(
        ms=time_ms(torch, lambda: paged_decode_partials(
            q, kp, vp, pp, tb, pq, window=win, pages_per_split=pps), 200),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_partials_plain(
            q, kp, vp, pp, tb, pq, window=win, pages_per_split=pps), 10),
        library_ms=time_ms(torch, lib_decode, 50),
        bytes=nbytes(q, tb, pq) + needed_page_bytes(torch, kp, pp, tb,
                                                    pq[:, None], win)
        + b * -(-nb // pps) * h * (d + 2) * 4,
        flops=4 * d * h * pairs, dtype="bfloat16", pages_per_split=pps)
    for b2, s2 in ((1, 2048), (4, 512)):
        q2, k2, v2 = args[(b2, s2)]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q2, k2, v2))
        keys = min(s2, win)
        timing[f"B2 {label} ({b2}, {s2})"] = dict(
            ms=time_ms(torch, lambda: flash_prefill(q2, k2, v2, window=win),
                       50),
            plain_ms=time_ms(torch, lambda: ref.flash_prefill_plain(
                q2, k2, v2, window=win), 5),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 50),
            bytes=nbytes(q2, k2, v2) + nbytes(q2),
            flops=4 * d * h * b2 * (keys * (keys + 1) // 2
                                    + (s2 - keys) * keys),
            dtype="bfloat16")
    return timing


# ---------------------------------------------------------------------------
# The xLSTM scans: four kernels in place of JAX's two lax.scan loops
# ---------------------------------------------------------------------------

# Kernel vs plain tolerance of the scans, relative to the largest |value|
# of each output (f32 on both sides): the kernels sum C q and n . q over
# D = 256 and h r_w over d = 1024 in another order than the plain
# version's GEMMs, and the backward carries that rounding back through 256
# steps; 1e-4 is ~1000 f32 roundings of the largest value.
TOL_SCAN_REL = 1e-4
# xlstm-350m's recurrences: the mLSTM's 4 heads of 256, the sLSTM's d
SCAN_H, SCAN_D, SCAN_DM = 4, 256, 1024
# (y)'s batch and sequence, at which the kernel phase also checks the
# recorded forwards and the backward scans
XLSTM_TRAIN_SHAPE = (2, 1024)


def mlstm_bwd_flops(b, s, h, d, chunk=32):
    """The least flops (2 a multiply-add) of the mLSTM backward's function,
    as its chunkwise design computes it over chunks of ``chunk`` steps:
    the bound of both backward designs' rows.  (The operator's formula,
    ``xlstm_scan.mlstm_flops(..., backward=True)``, counts the first
    design's recomputation of every C_t, 6 D^2 multiply-adds a step; the
    dry run reads it and it stays.)  Per chunk of l steps: 4 D^2
    multiply-adds a step (the chain's rank-1 update (dec / den) dy q^T, U
    = C_j^T dy / den, G_j^T v, G_j k); a D^2 scaling (a_j G_j) and <G_j,
    C_j> a chunk; the in-chunk matrices' five causal products (Q K^T, dY
    V^T, E K, E^T Q, A^T dY: l (l + 1) / 2 pairs of D each); the dot
    products of D a step (dy . y, the dn chain, U . q, n_j . q, VG . k,
    dn . k) and a chunk (dn . n_j)."""
    total = 0
    for j in range(0, s, chunk):
        n = min(chunk, s - j)
        total += (8 * n * d * d + 3 * d * d + 5 * n * (n + 1) * d
                  + 12 * n * d + 2 * d)
    return b * h * total

# launch counter -> the key of the kernel's timing and error.  Two designs
# of each forward, chosen by shape (``xlstm_scan.mlstm_route``,
# ``slstm_route``): the chunkwise mLSTM and the persistent sLSTM take
# prefill chunks and training sequences from their routes' boundaries on,
# the one-pass mLSTM and the step sLSTM (the first designs) S = 1 (decode
# steps) and the calls under those boundaries.  Two designs of each
# backward (``xlstm_scan.mlstm_bwd_route``, ``slstm_bwd_route``): the
# chunkwise mLSTM one takes every forward recorded with 32-step chunks,
# the persistent sLSTM one every recorded forward of 2 steps or more that
# fits the card, the step ones (the first designs) the rest
SCAN_KEYS = {"mlstm_scan": "mLSTM", "mlstm_scan_chunkwise": "mLSTM-chunkwise",
             "mlstm_scan_backward": "mLSTM-bwd",
             "mlstm_scan_backward_chunkwise": "mLSTM-bwd-chunkwise",
             "slstm_scan": "sLSTM",
             "slstm_scan_persistent": "sLSTM-persistent",
             "slstm_scan_backward": "sLSTM-bwd",
             "slstm_scan_backward_persistent": "sLSTM-bwd-persistent"}
SCAN_KERNELS = tuple(SCAN_KEYS)
# a forward design (``xlstm_scan.mlstm_forward``/``slstm_forward``'s
# route) -> its launch counter
SCAN_DESIGNS = {"chunkwise": "mlstm_scan_chunkwise", "one_pass": "mlstm_scan",
                "persistent": "slstm_scan_persistent", "step": "slstm_scan"}
# an mLSTM backward design (``xlstm_scan.mlstm_backward``'s route) -> its
# launch counter
SCAN_BWD_DESIGNS = {"chunkwise": "mlstm_scan_backward_chunkwise",
                    "step": "mlstm_scan_backward"}
# an sLSTM backward design (``xlstm_scan.slstm_backward``'s route) -> its
# launch counter
SLSTM_BWD_DESIGNS = {"persistent": "slstm_scan_backward_persistent",
                     "step": "slstm_scan_backward"}
# what training run (y) launches: the redesigned forwards and backwards
# (and none of the first designs)
TRAIN_SCAN_KERNELS = ("mlstm_scan_chunkwise", "mlstm_scan_backward_chunkwise",
                      "slstm_scan_persistent",
                      "slstm_scan_backward_persistent")


def check_rel(torch, what, got, want, tol=TOL_SCAN_REL) -> float:
    """Every output within ``tol`` of the plain version's relative to its
    largest |value|, and finite; returns the largest absolute error."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            fail(f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            fail(f"{what}: non-finite kernel output")
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1e-30)
        if err > tol * scale:
            fail(f"{what}: max |kernel - plain| = {err:.3e} > {tol} x "
                 f"{scale:.3e}")
        worst = max(worst, err)
    return worst


def mlstm_case(torch, g, b, s, fresh=False):
    """(q, k, v, log_i, log_f, C0, n0, m0) at xlstm-350m's heads, scaled
    as ``mlstm_apply`` makes them (q, k over sqrt(D), forget gates near
    1); carries fresh (zeros, m = -1e30) or as after some steps."""
    import torch.nn.functional as F
    dev = "cuda"
    q, k = (torch.randn((b, s, SCAN_H, SCAN_D), generator=g, device=dev)
            / SCAN_D ** 0.5 for _ in range(2))
    v = torch.randn((b, s, SCAN_H, SCAN_D), generator=g, device=dev)
    log_i = torch.randn((b, s, SCAN_H), generator=g, device=dev)
    log_f = F.logsigmoid(torch.randn((b, s, SCAN_H), generator=g,
                                     device=dev) + 3)
    if fresh:
        c0 = torch.zeros((b, SCAN_H, SCAN_D, SCAN_D), device=dev)
        n0 = torch.zeros((b, SCAN_H, SCAN_D), device=dev)
        m0 = torch.full((b, SCAN_H), -1e30, device=dev)
    else:
        c0 = torch.randn((b, SCAN_H, SCAN_D, SCAN_D), generator=g,
                         device=dev) / SCAN_D
        n0 = torch.randn((b, SCAN_H, SCAN_D), generator=g, device=dev)
        m0 = torch.randn((b, SCAN_H), generator=g, device=dev)
    return q, k, v, log_i, log_f, c0, n0, m0


def slstm_case(torch, g, b, s, fresh=False):
    """(pre_x, r_w, c0, n0, m0, h0) at xlstm-350m's d; r_w at
    ``init_slstm``'s scale 0.1."""
    dev, d = "cuda", SCAN_DM
    pre_x = torch.randn((b, s, 4 * d), generator=g, device=dev)
    r_w = 0.1 * torch.randn((d, 4 * d), generator=g, device=dev)
    if fresh:
        carries = [torch.zeros((b, d), device=dev) for _ in range(4)]
        carries[2].fill_(-1e30)
    else:
        carries = [torch.randn((b, d), generator=g, device=dev)
                   for _ in range(4)]
        carries[1] = carries[1].abs() + 0.5
    return (pre_x, r_w, *carries)


def scan_bound_ms(nbytes_, flops) -> float:
    return 1e3 * max(nbytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])


def scan_counters(torch, b, s):
    """The launch counters of the forward designs the routes name for a
    (b, s) case at xlstm-350m's widths on this card."""
    from repro_torch.kernels import xlstm_scan as X
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ({"chunkwise": X.MLSTM_CHUNKWISE, "one_pass": X.MLSTM}[
                X.mlstm_route(b, s, SCAN_H, SCAN_D, 0)],
            {"persistent": X.SLSTM_PERSISTENT, "step": X.SLSTM}[
                X.slstm_route(b, s, SCAN_DM, sms)])


def routed(torch, counter, what, fn):
    """``fn()``, failing unless it launched ``counter``'s kernel once and
    no other."""
    from repro_torch.kernels import _lib
    before = dict(_lib.LAUNCHES)
    out = fn()
    got = {k: n - before[k] for k, n in _lib.LAUNCHES.items()
           if n != before[k]}
    if got != {counter: 1}:
        fail(f"{what}: launched {got}, the route names {counter}")
    return out


# a prefill long enough that the unrecorded chunkwise mLSTM walks its
# chunk states in more than one window (``xlstm_scan.mlstm_window``: 64 at
# one row of xlstm-350m's heads)
SCAN_WINDOWED = (1, 4096)
# the short prefill chunks (rows, steps) at which both designs of each
# forward are timed side by side (``route_sweep``), around the routes'
# boundaries (``xlstm_scan.MLSTM_CHUNKWISE_MIN_STEPS`` and
# ``_MIN_ROW_STEPS``, ``SLSTM_PERSISTENT_MIN_STEPS``)
ROUTE_SWEEP = tuple((1, s) for s in (2, 3, 4, 8, 16, 32, 64, 128, 256)) + (
    (2, 64), (2, 128), (4, 32), (4, 64)) + tuple(
    (8, s) for s in (2, 3, 4, 8, 16, 32, 64, 128))


def route_sweep(torch, g, events_ms) -> None:
    """Both designs of each forward at the (rows, steps) of
    ``ROUTE_SWEEP``, timed as prefill runs them: back-to-back eager calls
    through ``mlstm_forward``/``slstm_forward`` (host enqueue included),
    by CUDA events; prints each pair beside the design the route names."""
    from repro_torch.kernels import xlstm_scan as X
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, s in ROUTE_SWEEP:
        m, sl = mlstm_case(torch, g, b, s), slstm_case(torch, g, b, s)
        mt = {r: events_ms(lambda: X.mlstm_forward(r, *m, 0), 20)
              for r in ("chunkwise", "one_pass")}
        st = {r: events_ms(lambda: X.slstm_forward(r, *sl, False), 20)
              for r in ("persistent", "step")}
        say(f"route sweep {b} x {s}: mLSTM chunkwise {mt['chunkwise']:.4f}"
            f" / one-pass {mt['one_pass']:.4f} ms (route "
            f"{X.mlstm_route(b, s, SCAN_H, SCAN_D, 0)}); sLSTM persistent "
            f"{st['persistent']:.4f} / step {st['step']:.4f} ms (route "
            f"{X.slstm_route(b, s, SCAN_DM, sms)}), eager calls by CUDA "
            f"events")


def slstm_saved(s_args, s_out, dy):
    """``xlstm_scan.slstm_backward``'s arguments after the recorded
    forward of ``s_args`` gave ``s_out``: (dy, r_w, pres, cs, ns, ms, c0,
    n0, m0, h0, y)."""
    _, r_w, c0, n0, m0, h0 = s_args
    y, _, _, _, _, pres, cs, ns, ms = s_out
    return dy, r_w, pres, cs, ns, ms, c0, n0, m0, h0, y


# the short training sequences (rows, steps) at which both sLSTM backward
# designs are timed side by side (``bwd_route_sweep``), around the route's
# least S (``xlstm_scan.SLSTM_BWD_PERSISTENT_MIN_STEPS``)
SLSTM_BWD_SWEEP = ((1, 2), (1, 3), (1, 4), (1, 8), (2, 2), (2, 3), (2, 4),
                   (8, 2), (8, 3), (8, 4), (8, 16))


def bwd_route_sweep(torch, g, events_ms) -> None:
    """Both sLSTM backward designs at the (rows, steps) of
    ``SLSTM_BWD_SWEEP``, on one recorded forward's saved tensors each,
    timed as autograd runs them: back-to-back eager calls through
    ``slstm_backward`` (host enqueue and the dr_w product included), by
    CUDA events; prints each pair beside the design the route names."""
    from repro_torch.kernels import xlstm_scan as X
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, s in SLSTM_BWD_SWEEP:
        s_args = slstm_case(torch, g, b, s)
        s_out = X._SLSTM(*s_args, True)
        saved = slstm_saved(s_args, s_out, torch.randn_like(s_out[0]))
        st = {r: events_ms(lambda: X.slstm_backward(r, *saved), 20)
              for r in ("persistent", "step")}
        say(f"sLSTM backward route sweep {b} x {s}: persistent "
            f"{st['persistent']:.4f} / step {st['step']:.4f} ms (route "
            f"{X.slstm_bwd_route(b, s, SCAN_DM, sms)}), eager calls by "
            f"CUDA events")


def xlstm_scan_kernels(torch, results):
    """The eight scan kernels against their plain versions (``ref``) at
    xlstm-350m's widths in f32: the forward scans through their operators
    at 8 x 256 (one served chunk wave), 1 x 1,024 and ``SCAN_WINDOWED``'s
    1 x 4,096 (the chunkwise mLSTM's states in two windows), where the
    routes take the chunkwise mLSTM and the persistent sLSTM, and at 8 x 1
    (a decode step), where they take the first designs, the one-pass mLSTM
    and the step sLSTM,
    from fresh and from running carries, each call's launch checked
    against its route, and on the same inputs the design the route did
    not take, through its C entry point; the recorded forward's saved
    tensors
    and the backward, against autograd through the plain forward, at 2 x
    256 and at (y)'s ``XLSTM_TRAIN_SHAPE`` (each backward's launch checked
    against its route, and each scan's other backward design on the same
    saved tensors).  Errors go into ``results``;
    returns the timings of each kernel (its plain version beside it; no
    library call computes a scan) with its bytes, flops and steps, all by
    CUDA events (no profiler trace, no graph capture): around eager calls
    for the sLSTM's and the backwards, around calls queued behind a spin
    kernel (``queued_ms``) for the mLSTM's forwards and backwards and for
    every decode-step row; both designs of each forward at 8 x 256, 1 x
    1,024 and 1 x 4,096 in this run, the first designs also at their
    route's 8 x 1, both at the short prefills of ``route_sweep``, both
    designs of each backward at 2 x 256 and 2 x 1,024 and both sLSTM
    backwards at the short sequences of ``bwd_route_sweep``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import xlstm_scan as X

    g = torch.Generator(device="cuda").manual_seed(27)
    timing, errs = {}, {k: 0.0 for k in SCAN_KERNELS}
    cases = {}
    for b, s in ((8, 256), (1, 1024), SCAN_WINDOWED, (8, 1)):
        m_c, s_c = scan_counters(torch, b, s)
        for fresh in (True, False):
            m_args = mlstm_case(torch, g, b, s, fresh)
            s_args = slstm_case(torch, g, b, s, fresh)
            tag = f"({b}, {s}) {'fresh' if fresh else 'running'} carries"
            m_want = ref.mlstm_scan_ref(*m_args)[:4]
            s_want = ref.slstm_scan_ref(*s_args)[:5]
            errs[m_c] = max(errs[m_c], check_rel(
                torch, f"{m_c} {tag}", routed(
                    torch, m_c, f"mlstm_scan {tag}",
                    lambda: X._MLSTM(*m_args, 0))[:4], m_want))
            errs[s_c] = max(errs[s_c], check_rel(
                torch, f"{s_c} {tag}", routed(
                    torch, s_c, f"slstm_scan {tag}",
                    lambda: X._SLSTM(*s_args, False))[:5], s_want))
            # the design the route did not take, on the same inputs: the
            # first designs at the prefill shapes, the redesigned ones at
            # S = 1
            other_m, other_s = (("one_pass", "step") if s > 1
                                else ("chunkwise", "persistent"))
            errs[SCAN_DESIGNS[other_m]] = max(
                errs[SCAN_DESIGNS[other_m]], check_rel(
                    torch, f"mlstm_scan ({other_m}) {tag}",
                    X.mlstm_forward(other_m, *m_args, 0)[:4], m_want))
            errs[SCAN_DESIGNS[other_s]] = max(
                errs[SCAN_DESIGNS[other_s]], check_rel(
                    torch, f"slstm_scan ({other_s}) {tag}",
                    X.slstm_forward(other_s, *s_args, False)[:5], s_want))
            cases[b, s] = (m_args, s_args)
            del m_want, s_want
    # the recorded forward's saved tensors and the backward at 2 x 256 (the
    # timed case) and at (y)'s shape, 2 x 1,024: 32 checkpoint chunks, a
    # whole 1,024-step tile of the stabilizer's reverse
    chunk = X.MLSTM_CHUNK
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed_bwd, timed_s_bwd = {}, {}
    for b, s in ((2, 256), XLSTM_TRAIN_SHAPE):
        m_c, s_c = scan_counters(torch, b, s)
        m_args, s_args = mlstm_case(torch, g, b, s), slstm_case(torch, g, b, s)
        m_out = routed(torch, m_c, f"mlstm_scan ({b}, {s}) recorded",
                       lambda: X._MLSTM(*m_args, chunk))
        errs[m_c] = max(errs[m_c], check_rel(
            torch, f"{m_c} ({b}, {s}) recorded", m_out,
            ref.mlstm_scan_ref(*m_args, chunk)))
        s_out = routed(torch, s_c, f"slstm_scan ({b}, {s}) recorded",
                       lambda: X._SLSTM(*s_args, True))
        errs[s_c] = max(errs[s_c], check_rel(
            torch, f"{s_c} ({b}, {s}) recorded", s_out,
            ref.slstm_scan_ref(*s_args, True)))
        dy_m = torch.randn_like(m_out[0])
        dy_s = torch.randn_like(s_out[0])
        m_bwd = SCAN_BWD_DESIGNS[X.mlstm_bwd_route(b, s, SCAN_H, SCAN_D,
                                                   chunk)]
        s_bwd = SLSTM_BWD_DESIGNS[X.slstm_bwd_route(b, s, SCAN_DM, sms)]
        for name, fn, plain, args, n_seq, dy in (
                (m_bwd, X.mlstm_scan, ref.mlstm_scan_ref, m_args, 5, dy_m),
                (s_bwd, X.slstm_scan, ref.slstm_scan_ref, s_args, 2, dy_s)):
            seqs = [a.clone().requires_grad_() for a in args[:n_seq]]
            out = fn(*seqs, *args[n_seq:])[0]
            got = routed(torch, name, f"{name} ({b}, {s})",
                         lambda: torch.autograd.grad(out, seqs, dy))
            seqs = [a.clone().requires_grad_() for a in args[:n_seq]]
            want = torch.autograd.grad(plain(*seqs, *args[n_seq:])[0], seqs,
                                       dy)
            errs[name] = max(errs[name], check_rel(
                torch, f"{name} ({b}, {s})", got, want))
            if name == m_bwd:
                # the other mLSTM backward design on the same saved tensors
                other = "step" if m_bwd == X.MLSTM_BWD_CHUNKWISE else "chunkwise"
                q, k, v, li, lf, _, _, m0 = m_args
                y, _, _, _, ck_c, ck_n, ms, ss = m_out
                errs[SCAN_BWD_DESIGNS[other]] = max(
                    errs[SCAN_BWD_DESIGNS[other]], check_rel(
                        torch, f"mlstm_scan_backward ({other}) ({b}, {s})",
                        X.mlstm_backward(other, dy_m, q, k, v, li, lf, m0,
                                         ck_c, ck_n, ms, ss, y, chunk),
                        want))
            else:
                # the other sLSTM backward design on the same saved tensors
                other = "step" if s_bwd == X.SLSTM_BWD_PERSISTENT else (
                    "persistent")
                errs[SLSTM_BWD_DESIGNS[other]] = max(
                    errs[SLSTM_BWD_DESIGNS[other]], check_rel(
                        torch, f"slstm_scan_backward ({other}) ({b}, {s})",
                        X.slstm_backward(other, *slstm_saved(
                            s_args, s_out, dy_s)), want))
            del seqs, out, got, want
        timed_bwd[b, s] = m_args, m_out, dy_m
        timed_s_bwd[b, s] = s_args[0], slstm_saved(s_args, s_out, dy_s)
        del m_args, s_args, m_out, s_out, dy_m, dy_s
        torch.cuda.empty_cache()
    say(f"xLSTM scans vs plain [xlstm-350m: mLSTM {SCAN_H} heads of "
        f"{SCAN_D}, sLSTM d {SCAN_DM}, f32; 8 x 256, 1 x 1024 (routed "
        f"chunkwise, persistent), 8 x 1 (routed one-pass, step), each "
        f"with the other design on the same inputs, "
        f"from fresh and running carries, each call's route checked; "
        f"recorded forward and backward at 2 x 256 and "
        f"{XLSTM_TRAIN_SHAPE[0]} x {XLSTM_TRAIN_SHAPE[1]} against autograd "
        f"through the plain forward, each backward's other design on the "
        f"same saved tensors]: max |err| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tolerance {TOL_SCAN_REL} of the largest value)")
    for k, v in errs.items():
        results[(SCAN_KEYS[k], "xlstm-350m", "float32")] = dict(err=v)

    def events_ms(fn, iters):
        fn()
        return time_events(torch, fn, iters)

    def device_ms(fn, iters):
        return queued_ms(torch, fn, iters)

    def entry(key, s, kernel, plain_ms, ins, outs, flops, iters,
              timer=events_ms):
        # CUDA events around the sLSTM's calls: the step sLSTM's call is one
        # launch per step, so the call's time is the span, gaps between
        # launches included, not a trace's sum of kernel times
        t = dict(ms=timer(kernel, iters), plain_ms=plain_ms,
                 library_ms=None, bytes=nbytes(*ins) + nbytes(*outs),
                 flops=flops, dtype="float32", steps=s)
        timing[key] = t
        say(f"{key}: {t['ms'] / s * 1e3:.2f} us per step x {s} steps = "
            f"{t['ms']:.4f} ms, bound "
            f"{scan_bound_ms(t['bytes'], flops):.4f} ms (bytes and "
            f"flops), plain {t['plain_ms']:.1f} ms")
        return t["ms"]

    for b, s in ((8, 256), (1, 1024), SCAN_WINDOWED, (8, 1)):
        m, sl = cases.pop((b, s))
        m_flops = X.mlstm_flops(b, s, SCAN_H, SCAN_D)
        s_flops = X.slstm_flops(b, s, SCAN_DM)
        m_outs, s_outs = X._MLSTM(*m, 0)[:4], X._SLSTM(*sl, False)[:5]
        if s == 1:
            # the first designs' rows at the shape their route gives them, a
            # decode step, queued behind a spin (events around eager calls
            # would time the host's launch of each).  No profiler trace and
            # no CUDA graph here: either, added to the kernel phase, left
            # later traces without kernels
            entry("mLSTM", s, lambda: X._MLSTM(*m, 0),
                  device_ms(lambda: ref.mlstm_scan_ref(*m), 20), m, m_outs,
                  m_flops, 50, device_ms)
            entry("sLSTM", s, lambda: X._SLSTM(*sl, False),
                  device_ms(lambda: ref.slstm_scan_ref(*sl), 20), sl, s_outs,
                  s_flops, 50, device_ms)
            continue
        m_plain = events_ms(lambda: ref.mlstm_scan_ref(*m), 1)
        s_plain = events_ms(lambda: ref.slstm_scan_ref(*sl), 1)
        sfx = "" if (b, s) == (8, 256) else f" ({b}, {s})"
        # the mLSTM's calls queued behind a spin: events around eager calls
        # of the chunkwise design read the host's enqueue of its launches,
        # which takes longer than they run
        new_m = entry(f"mLSTM-chunkwise{sfx}", s, lambda: X._MLSTM(*m, 0),
                      m_plain, m, m_outs, m_flops, 20, device_ms)
        old_m = entry(f"mLSTM one-pass ({b}, {s})", s,
                      lambda: X.mlstm_forward("one_pass", *m, 0), m_plain, m,
                      m_outs, m_flops, 20, device_ms)
        new_s = entry(f"sLSTM-persistent{sfx}", s,
                      lambda: X._SLSTM(*sl, False), s_plain, sl, s_outs,
                      s_flops, 10)
        old_s = entry(f"sLSTM step ({b}, {s})", s,
                      lambda: X.slstm_forward("step", *sl, False), s_plain,
                      sl, s_outs, s_flops, 10)
        say(f"xLSTM forwards at {b} x {s}, redesigned vs first design in this "
            f"run: mLSTM chunkwise {new_m:.4f} vs one-pass {old_m:.4f} ms "
            f"({old_m / new_m:.2f}x); sLSTM persistent {new_s:.4f} vs step "
            f"{old_s:.4f} ms ({old_s / new_s:.2f}x)")
    route_sweep(torch, g, events_ms)
    # both mLSTM backward designs on the same saved tensors, queued behind
    # a spin (the chunkwise design's five launches enqueue longer than they
    # run), at 2 x 256 and at (y)'s 2 x 1,024
    for (b, s), (m_args, m_out, dy_m) in timed_bwd.items():
        q, k, v, li, lf, c0, n0, m0 = m_args
        y, _, _, _, ck_c, ck_n, ms, ss = m_out
        bwd = (dy_m, q, k, v, li, lf, m0, ck_c, ck_n, ms, ss, y, chunk)
        sfx = "" if (b, s) == (2, 256) else f" ({b}, {s})"
        plain = time_events(torch, lambda: ref.mlstm_scan_backward_ref(
            dy_m, q, k, v, li, lf, c0, n0, m0), 1)
        flops = mlstm_bwd_flops(b, s, SCAN_H, SCAN_D, chunk)
        new_b = entry(f"mLSTM-bwd-chunkwise{sfx}", s,
                      lambda: X._MLSTM_BWD(*bwd), plain, bwd[:-1],
                      (q, k, v, li, lf), flops, 20, device_ms)
        old_b = entry(f"mLSTM-bwd{sfx}", s,
                      lambda: X.mlstm_backward("step", *bwd), plain,
                      bwd[:-1], (q, k, v, li, lf), flops, 10, device_ms)
        say(f"mLSTM backward at {b} x {s}, redesigned vs first design in "
            f"this run: chunkwise {new_b:.4f} vs step {old_b:.4f} ms "
            f"({old_b / new_b:.2f}x)")
    del timed_bwd, bwd, m_args, m_out, dy_m
    # both sLSTM backward designs on the same saved tensors, by events
    # around eager calls (the step design's is a launch a step), at 2 x 256
    # and at (y)'s 2 x 1,024; each call's dr_w product included
    for (b, s), (pre_x, saved) in timed_s_bwd.items():
        dy_s, r_w, pres, cs, ns, sm, c0, n0, m0, h0, sy = saved
        sfx = "" if (b, s) == (2, 256) else f" ({b}, {s})"
        plain = events_ms(lambda: ref.slstm_scan_backward_ref(
            dy_s, pre_x, r_w, c0, n0, m0, h0), 1)
        flops = X.slstm_flops(b, s, SCAN_DM, backward=True)
        new_b = entry(f"sLSTM-bwd-persistent{sfx}", s,
                      lambda: X.slstm_backward("persistent", *saved), plain,
                      saved, (pre_x, r_w), flops, 10)
        old_b = entry(f"sLSTM-bwd{sfx}", s,
                      lambda: X.slstm_backward("step", *saved), plain,
                      saved, (pre_x, r_w), flops, 10)
        say(f"sLSTM backward at {b} x {s}, redesigned vs first design in "
            f"this run: persistent {new_b:.4f} vs step {old_b:.4f} ms "
            f"({old_b / new_b:.2f}x)")
    bwd_route_sweep(torch, g, events_ms)
    return timing


# seamless-m4t-large-v2's cross K/V are timed over this many copies (33.6
# MB each at 8 rows x 512 frames in f32, 201 MB together)
SEAMLESS_COPIES = 6


def seamless_kernels(torch, results):
    """B1, B2 and B5 at the shapes runs (r)-(s) give them: seamless-m4t-
    large-v2 in f32, 16/16 heads of 64, against their plain versions at
    TOL_F32.  B1 over 8 rows of 128-page tables (``SEAMLESS_MAX_LEN``,
    block 16), each row as long as one served request 16 tokens into its
    decode (``seamless_requests``), at one partial per page, per 3 pages
    and at the serving split; B2 on a fresh 1 x 512 chunk; B5 over 8 rows
    x 512 cached frames, every frame valid, block_k 512 (the cross
    decode).  Errors go into ``results`` under the label
    "seamless-m4t-large-v2"; returns the timings under "B1 seamless",
    "B2 seamless (1, 512)" and "B5 seamless cross": the kernel, its plain
    version, a library yardstick (gather + SDPA under the position mask;
    SDPA, causal; SDPA over every frame) and the bound's bytes and f32
    flops.  B5 and its SDPA run over ``SEAMLESS_COPIES`` cycled copies of
    the cross K/V (``cycled``)."""
    import torch.nn.functional as F
    from repro_torch.configs import get
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.split_kv_decode import (decode_pages_per_split,
                                                     paged_decode_partials,
                                                     split_kv_decode_partials)

    cfg = get("seamless-m4t-large-v2")
    dev, f32 = torch.device("cuda"), torch.float32
    label, cap = "seamless-m4t-large-v2", cfg.logit_soft_cap
    h, kv, d, bs = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    nb = SEAMLESS_MAX_LEN // bs
    lengths = [r.prompt_len + 16 for r in seamless_requests(cfg)]
    g = torch.Generator(device=dev).manual_seed(12)
    timing = {}

    # -- B1: the self-attention decode over the rows' pages
    q, kp, vp, pp, tb, pq = paged_case(torch, g, dev, f32, b=len(lengths),
                                       h=h, kv=kv, d=d, bs=bs, nb=nb,
                                       lengths=lengths)
    pps = decode_pages_per_split(q, kv, nb)
    err1 = max(check_close(
        torch, f"B1 {label} float32 pages_per_split {split}",
        paged_decode_partials(q, kp, vp, pp, tb, pq, soft_cap=cap,
                              pages_per_split=split),
        ref.paged_decode_partials_plain(q, kp, vp, pp, tb, pq, soft_cap=cap,
                                        pages_per_split=split), TOL_F32)
        for split in (1, 3, pps))
    results[("B1", label, "float32")] = dict(err=err1)
    b = q.shape[0]
    n_live = torch.unique(tb[tb >= 0]).numel()

    def lib_decode():
        safe = tb.clamp_min(0).long()
        kl = kp[safe].reshape(b, nb * bs, kv, d)
        vl = vp[safe].reshape(b, nb * bs, kv, d)
        pk = torch.where((tb >= 0)[:, :, None], pp[safe], -1
                         ).reshape(b, 1, 1, -1)
        mask = (pk >= 0) & (pk <= pq[:, None, None, None])
        return F.scaled_dot_product_attention(
            q[:, :, None], kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask, enable_gqa=h != kv)

    timing["B1 seamless"] = dict(
        ms=time_ms(torch, lambda: paged_decode_partials(
            q, kp, vp, pp, tb, pq, soft_cap=cap, pages_per_split=pps), 200),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_partials_plain(
            q, kp, vp, pp, tb, pq, soft_cap=cap, pages_per_split=pps), 10),
        library_ms=time_ms(torch, lib_decode, 50),
        bytes=nbytes(q, tb, pq) + n_live * (2 * bs * kv * d * 4 + bs * 4)
        + b * -(-nb // pps) * h * (d + 2) * 4,
        flops=4 * d * h * visible_pairs(torch, pp, tb, pq, None),
        dtype="float32", pages_per_split=pps)
    del kp, vp, pp

    # -- B2: a fresh prefill's first chunk
    q2, k2, v2 = (torch.randn((1, SEAMLESS_CHUNK, n, d), generator=g,
                              device=dev) for n in (h, kv, kv))
    err2 = check_close(torch, f"B2 {label} (1, {SEAMLESS_CHUNK}) float32",
                       flash_prefill(q2, k2, v2, soft_cap=cap),
                       ref.flash_prefill_plain(q2, k2, v2, soft_cap=cap),
                       TOL_F32)
    results[("B2", label, "float32")] = dict(err=err2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q2, k2, v2))
    s2 = SEAMLESS_CHUNK
    timing[f"B2 seamless (1, {s2})"] = dict(
        ms=time_ms(torch, lambda: flash_prefill(q2, k2, v2, soft_cap=cap),
                   50),
        plain_ms=time_ms(torch, lambda: ref.flash_prefill_plain(
            q2, k2, v2, soft_cap=cap), 10),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != kv), 50),
        bytes=nbytes(q2, k2, v2) + nbytes(q2),
        flops=4 * d * h * s2 * (s2 + 1) // 2, dtype="float32")

    # -- B5: the cross decode over every cached frame
    q5 = torch.randn((len(lengths), h, d), generator=g, device=dev)
    copies = [tuple(torch.randn((len(lengths), cfg.n_frames, kv, d),
                                generator=g, device=dev) for _ in range(2))
              for _ in range(SEAMLESS_COPIES)]
    k5, v5 = copies[0]
    every = torch.ones(k5.shape[:2], dtype=torch.bool, device=dev)
    err5 = check_close(
        torch, f"B5 {label} cross float32",
        split_kv_decode_partials(q5, k5, v5, every, block_k=512),
        ref.split_kv_decode_partials_plain(q5, k5, v5, every, block_k=512),
        TOL_F32)
    results[("B5", label, "float32")] = dict(err=err5)
    timing["B5 seamless cross"] = dict(
        b5_timing(torch, q5, k5, v5, every, 200, fn=cycled(
            copies, lambda k_, v_: split_kv_decode_partials(
                q5, k_, v_, every, block_k=512))),
        plain_ms=time_ms(torch, lambda: ref.split_kv_decode_partials_plain(
            q5, k5, v5, every, block_k=512), 20),
        library_ms=time_ms(torch, cycled(
            copies, lambda k_, v_: F.scaled_dot_product_attention(
                q5[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                enable_gqa=h != kv)), 50),
        dtype="float32")
    warm_ms = time_ms(torch, lambda: split_kv_decode_partials(
        q5, k5, v5, every, block_k=512), 200)
    say(f"kernels vs plain [{label}, {h}/{kv} heads of {d}, float32]: max "
        f"|err| B1 {err1:.2e} ({b} rows of {min(lengths)}-{max(lengths)} "
        f"tokens on {nb}-page tables, serving split {pps}), B2 {err2:.2e} "
        f"(1 x {s2}), B5 {err5:.2e} ({b} x {cfg.n_frames} frames, every "
        f"one valid; {warm_ms:.4f} ms back to back on one copy, L2-warm)")
    return timing


# ---------------------------------------------------------------------------
# Phase 3: serving llama-13b through Server
# ---------------------------------------------------------------------------

def device_us(evt) -> float:
    """Self device time of a profiler entry, in microseconds."""
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0.0)


def device_kernels(entries):
    """The device entries of a profile's ``key_averages()``: its kernels
    and copies, without ``FnRanges``' annotations, whose device time
    repeats their kernels'."""
    return [e for e in entries if str(e.device_type).endswith("CUDA")
            and e.key not in RANGED]


class StepEvents:
    """While active, CUDA events around every compiled-step call: the
    device span of the decode forwards, from the static input's copy to
    the graph's (or the eager step's) last kernel."""

    def __init__(self, torch):
        from repro_torch.serving import engine as E
        self.torch, self.E, self.pairs = torch, E, []

    def __enter__(self):
        torch, pairs = self.torch, self.pairs
        orig = self.orig = self.E.CompiledStep.__call__

        def call(step, x):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(step, x)
            b.record()
            pairs.append((a, b))
            return out

        self.E.CompiledStep.__call__ = call
        return self

    def __exit__(self, *exc):
        self.E.CompiledStep.__call__ = self.orig

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def say_graphs(label, card, engines) -> None:
    """Graphs each decode engine captured (over its life: a span move
    captures afresh), their warm-up plus capture time, and the steps it
    holds at the end, as (mode, width)."""
    parts = []
    for e in engines:
        r = e.compiled.report()
        parts.append(f"{e.name} {r['graphs_captured']} graphs in "
                     f"{r['capture_s'] * 1e3:.1f} ms, holds "
                     f"{[k[:2] for k in r['steps']]}"
                     if r["graphs"] else f"{e.name} eager (graphs off), "
                     f"holds {[k[:2] for k in r['steps']]}")
    say(f"[{label}] compiled steps: " + "; ".join(parts) + f" [{card}]")


def serving_phase(torch, card: str):
    """The plain and n-gram runs through ``Server``, each again with CUDA
    graphs off, the self-draft run at the engine level, then the int8-KV
    plain and n-gram runs through ``Server``, on one set of llama-13b
    weights (``kv_quant`` does not change them).  Returns {run label:
    launches during that run}."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T

    cfg = get("llama-13b")
    t0 = time.perf_counter()
    params = T.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say(f"llama-13b init (40 layers, d_model 5120, bf16, seed 0): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    launches, stats = {}, {}
    qcfg = cfg.with_kv_quant()
    bf16_pages = ("paged_decode_partials", "paged_verify_partials")
    # (label, config, speculation, chunk_tokens, kernels that must launch
    # during the run, kernels that must not)
    bf16_runs = [("plain", cfg, "off", 256,
                  ("paged_decode_partials", "flash_prefill",
                   "paged_prefix_partials"), ()),
                 ("ngram", cfg, "ngram", 256,
                  ("flash_prefill", "paged_prefix_partials",
                   "paged_verify_partials"), ())]
    int8_runs = [("int8", qcfg, "off", None,
                  ("paged_decode_partials_int8", "flash_prefill"),
                  bf16_pages + ("paged_prefix_partials",
                                "paged_verify_partials_int8")),
                 ("int8-ngram", qcfg, "ngram", None,
                  ("paged_verify_partials_int8", "flash_prefill"),
                  bf16_pages + ("paged_prefix_partials",))]

    def serve_all(runs, graphs=True, suffix=""):
        for label, rcfg, mode, chunk, needed, forbidden in runs:
            label += suffix
            stats[label] = serve_run(
                torch, card, rcfg, params, label=label, speculation=mode,
                chunk_tokens=chunk, needed=needed, forbidden=forbidden,
                profile=label in ("plain", "int8", "plain-eager"),
                bf16_streams=stats.get("plain", {}).get("streams"),
                graphs=graphs)
            launches[label] = stats[label]["launches"]
            gc.collect()         # the timing wrappers tie engine cycles
            torch.cuda.empty_cache()

    serve_all(bf16_runs)
    serve_all(bf16_runs, graphs=False, suffix="-eager")
    for base in ("plain", "ngram"):
        a, b = stats[base], stats[base + "-eager"]
        if a["streams"] != b["streams"]:
            diff = [rid for rid in a["streams"]
                    if a["streams"][rid] != b["streams"][rid]]
            fail(f"[{base}] replayed streams differ from the eager run's "
                 f"for requests {diff}")
        if a["launches"] != b["launches"]:
            fail(f"[{base}] replayed launches {a['launches']} differ from "
                 f"the eager run's {b['launches']}")
        speedup = b["steady_ms"] / max(a["steady_ms"], 1e-9)
        say(f"[{base}] CUDA graphs vs eager: decode {a['steady_ms']:.1f} vs "
            f"{b['steady_ms']:.1f} ms per iteration without capture "
            f"({speedup:.2f}x; {a['iter_ms']:.1f} ms with it; compiled "
            f"steps' device span {a['span_ms']:.1f} vs {b['span_ms']:.1f} "
            f"ms), "
            f"{a['decode_tps']:.1f} vs "
            f"{b['decode_tps']:.1f} tok/s, prefill {a['prefill_tps']:.1f} "
            f"vs {b['prefill_tps']:.1f} tok/s, peak memory "
            f"{a['peak_gib']:.2f} vs {b['peak_gib']:.2f} GiB; streams "
            f"{len(a['streams'])}/{len(b['streams'])} equal, launch counts "
            f"equal [{card}]")
    launches["self-draft"] = self_draft_run(torch, card, cfg, params)
    serve_all(int8_runs)
    launches.update(migration_phase(torch, card, cfg, params,
                                    stats["plain"]["streams"]))
    launches.update(frontdoor_phase(torch, card, cfg, params,
                                    stats["plain"]["streams"]))
    launches.update(dense_phase(torch, card, cfg, params, stats["plain"]))
    launches["orchestrator-run"] = orchestrator_run(
        torch, card, cfg, params, stats["plain"]["streams"])
    launches.update(multidevice_phase(torch, card, cfg, params))
    t0 = time.perf_counter()
    launches["x-shared"] = shared_span_run(torch, card, cfg, params)
    say(f"shared span pages (x1): {time.perf_counter() - t0:.1f} s")
    for q8, base in (("int8", "plain"), ("int8-ngram", "ngram")):
        a, b = stats[q8], stats[base]
        say(f"[{q8} vs {base}] decode {a['iter_ms']:.1f} vs "
            f"{b['iter_ms']:.1f} ms per iteration, {a['decode_tps']:.1f} vs "
            f"{b['decode_tps']:.1f} tok/s, peak memory {a['peak_gib']:.2f} "
            f"vs {b['peak_gib']:.2f} GiB (the bf16 run prefills in 256-token "
            f"chunks, the int8 run unchunked) [{card}]")
    return launches


# ---------------------------------------------------------------------------
# Dense rows (k), Fig. 4 head offload (l), int8 weights (m)
# ---------------------------------------------------------------------------

# (l): head-offloaded logits against the monolithic step's.  On the CPU in
# f32 the two agree to 2e-4 (tests/test_torch_offload.py), from another
# summation order in the branches.  On the card both run B5 per kv head
# with the same blocks (llama-13b has one query head per kv head, so a
# branch's blocks are the monolithic launch's blocks for its heads) and
# the same combine, so the attention outputs should be bit for bit the
# same; the allowance is one bf16 step (2^-8) of the attention output
# carried through 40 layers of bf16 rounding, bounded at half the
# served-token tolerance.
OFFLOAD_TOL = TOKEN_GAP_TOL / 2

PAGE_KERNELS = ("paged_decode_partials", "paged_decode_partials_int8",
                "paged_prefix_partials", "paged_verify_partials",
                "paged_verify_partials_int8")


def dense_phase(torch, card, cfg, params, plain):
    """(k) llama-13b on dense rows (``max_len`` 1000, 1000 % 16 = 8)
    through ``Server``, replayed and eagerly: B2 and B5 must launch, no
    page kernel; (l) Fig. 4 head offload at the model level on a dense
    cache of the served prompts; (m) int8 weights served plain (replayed)
    and over two 2-stage pipelines with a forced 4-layer span move.
    ``plain``: the paged bf16 plain run's stats.  Returns {run label:
    launches}."""
    from repro_torch.core.layer_migration import layer_param_bytes
    from repro_torch.models import quant as Q

    t0 = time.perf_counter()
    launches, runs = {}, {}
    for graphs, label in ((True, "dense"), (False, "dense-eager")):
        runs[label] = serve_run(
            torch, card, cfg, params, label=label, speculation="off",
            chunk_tokens=256, needed=("flash_prefill",
                                      "split_kv_decode_partials"),
            forbidden=PAGE_KERNELS, profile=graphs, graphs=graphs,
            max_len=1000, decode_kernel=("B5", "split_decode_kernel"))
        launches[label] = runs[label]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["dense"], runs["dense-eager"]
    if a["streams"] != b["streams"] or a["launches"] != b["launches"]:
        fail(f"[dense] replayed streams or launches differ from the eager "
             f"run's: {a['launches']} vs {b['launches']}")
    same = sum(a["streams"][rid] == plain["streams"][rid]
               for rid in a["streams"])
    say(f"[dense] dense rows (max_len 1000) vs paged plain (max_len 1024): "
        f"streams equal to the paged run's {same}/{len(a['streams'])}; "
        f"decode {a['steady_ms']:.1f} (replayed) / {b['steady_ms']:.1f} "
        f"(eager) vs {plain['steady_ms']:.1f} ms per iteration without "
        f"capture, device span {a['span_ms']:.1f} vs {plain['span_ms']:.1f} "
        f"ms; prefill {a['prefill_tps']:.1f} vs {plain['prefill_tps']:.1f} "
        f"tok/s; peak memory {a['peak_gib']:.2f} vs {plain['peak_gib']:.2f} "
        f"GiB; replayed and eager streams and launches equal [{card}]")
    launches["offload"] = head_offload_run(torch, card, cfg, params)

    t = time.perf_counter()
    qparams = Q.quantize_weights(params)
    torch.cuda.synchronize()
    say(f"[int8w] quantize_weights: {time.perf_counter() - t:.1f} s; "
        f"weights {layer_param_bytes(qparams) / 2**30:.2f} GiB (int8 values "
        f"plus f32 scales) against {layer_param_bytes(params) / 2**30:.2f} "
        f"GiB in bf16 "
        f"[{card}]")
    st = serve_run(torch, card, cfg, qparams, label="int8w",
                   speculation="off", chunk_tokens=256,
                   needed=("paged_decode_partials", "flash_prefill",
                           "paged_prefix_partials"),
                   forbidden=("split_kv_decode_partials",
                              "paged_verify_partials"), profile=True)
    launches["int8w"] = st["launches"]
    say(f"[int8w vs plain] decode {st['steady_ms']:.1f} vs "
        f"{plain['steady_ms']:.1f} ms per iteration without capture "
        f"(device span {st['span_ms']:.1f} vs {plain['span_ms']:.1f} ms), "
        f"prefill {st['prefill_tps']:.1f} vs {plain['prefill_tps']:.1f} "
        f"tok/s, peak memory {st['peak_gib']:.2f} vs "
        f"{plain['peak_gib']:.2f} GiB [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    launches["int8w-span"] = migration_run(
        torch, card, cfg, qparams, st["streams"], label="int8w-span",
        n_prefill=1, decode_split=2,
        force=force_one_span_move(torch, card, "int8w-span", 4))
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    say(f"dense rows, head offload and int8 weights (k)-(m): "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def head_offload_run(torch, card, cfg, params):
    """(l): the 8 served prompts prefilled into one dense bf16 cache of
    1000 slots, then one decode step per ``head_offload`` n in (0, 1, 20,
    39), each on the same cache (a step writes the same K/V at the same
    places whatever n): logits against n = 0's within OFFLOAD_TOL, B5
    launched once per layer at n = 0 and twice with n > 0.  Returns the
    launches of the offloaded steps."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    reqs = served_requests(cfg)
    lens = [r.prompt_len for r in reqs]
    toks = torch.zeros((len(reqs), max(lens)), dtype=torch.long,
                       device="cuda")
    for i, r in enumerate(reqs):
        toks[i, :lens[i]] = torch.as_tensor(r.prompt, device="cuda")
    cache = T.init_cache(cfg, len(reqs), 1000,
                         dtype=params["out_norm"].dtype)
    at = torch.as_tensor([n - 1 for n in lens], device="cuda")
    lg, cache, _ = T.apply(cfg, params, toks, cache=cache, mode="prefill",
                           logits_slice="last", logits_at=at)
    # each row resumes at its own length; the pad tokens past it sit at
    # later positions, masked, and the step overwrites the first of them
    cache["lengths"] = torch.as_tensor(lens, dtype=torch.int32,
                                       device="cuda")
    nxt = lg.argmax(dim=-1)[:, None]
    out, counts, ms = {}, {}, {}
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for n_off in (0, 1, 20, 39):
        ops.reset_launches()
        logits, _, _ = T.apply(cfg, params, nxt, cache=cache, mode="decode",
                               logits_slice="last", head_offload=n_off)
        torch.cuda.synchronize()
        counts[n_off] = dict(ops.LAUNCHES)
        out[n_off] = logits.float()
        if not torch.isfinite(out[n_off]).all():
            fail(f"[offload] head_offload={n_off}: non-finite logits")
        # the device time of one eager step, its kernels summed
        ms[n_off] = time_ms(torch, lambda: T.apply(
            cfg, params, nxt, cache=cache, mode="decode",
            logits_slice="last", head_offload=n_off), 3, warmup=1)
        if n_off:
            for k, v in counts[n_off].items():
                total[k] += v
    ops.reset_launches()
    parts = []
    for n_off in (1, 20, 39):
        diff = float((out[n_off] - out[0]).abs().max())
        b5 = counts[n_off]["split_kv_decode_partials"]
        if b5 != 2 * cfg.n_layers or any(
                v for k, v in counts[n_off].items()
                if k != "split_kv_decode_partials"):
            fail(f"[offload] head_offload={n_off}: launches "
                 f"{counts[n_off]}; expected B5 twice per layer only")
        if diff > OFFLOAD_TOL:
            fail(f"[offload] head_offload={n_off}: logits {diff:.4f} from "
                 f"the monolithic step's (tolerance {OFFLOAD_TOL})")
        same = bool(torch.equal(out[n_off].argmax(1), out[0].argmax(1)))
        parts.append(f"n={n_off} (hot {cfg.n_kv_heads - n_off} / cold "
                     f"{n_off} kv heads): max |logit diff| {diff:.6f}, "
                     f"argmax {'equal' if same else 'differs'}, B5 x{b5}, "
                     f"{ms[n_off]:.2f} ms of device time a step")
    if counts[0]["split_kv_decode_partials"] != cfg.n_layers:
        fail(f"[offload] the monolithic step launched {counts[0]}")
    say(f"[offload] Fig. 4 head offload, llama-13b bf16, 8 rows, dense "
        f"cache of the served prompts ({min(lens)}-{max(lens)} tokens, 1000 "
        f"slots), against head_offload=0 (B5 x{cfg.n_layers}, "
        f"{ms[0]:.2f} ms of device time a step, eager), tolerance "
        f"{OFFLOAD_TOL}: "
        + "; ".join(parts) + f" [{card}]")
    del cache
    return total


def served_requests(cfg):
    """The 8 requests every served run answers: prompts of 128-768 tokens,
    60 % of them behind one of two shared prefixes, 32 tokens out each."""
    from repro_torch.serving.workload import WorkloadConfig, generate

    reqs = generate(WorkloadConfig(
        kind="synthetic", rps=1000.0, n_requests=8, vocab_size=cfg.vocab_size,
        max_new_tokens=32, prefix_share=0.6, n_prefix_groups=2, seed=0,
        prompt_len_lo=128, prompt_len_hi=768))
    for r in reqs:
        r.max_new_tokens = 32
    return reqs


def int8_forward_logits(torch, cfg, params, prompt, generated,
                        stepwise=False):
    """The port's own int8-KV forward over a served stream, teacher-forced:
    the prompt prefilled into a dense int8 cache (attending over the
    unquantized K/V, as serving does), then every served token but the
    last decoded over the quantized cache in one multi-token step, or with
    ``stepwise`` one token a step as serving decodes (the same arithmetic
    in other GEMM shapes).  Row i scores the choice of generated[i]."""
    from repro_torch.models import transformer as T

    n_p, n_g = len(prompt), len(generated)
    cache = T.init_cache(cfg, 1, n_p + n_g, dtype=params["embed"].dtype)
    toks = torch.as_tensor([int(t) for t in prompt], device="cuda")[None]
    lg0, cache, _ = T.apply(cfg, params, toks, cache=cache, mode="prefill",
                            logits_slice="last")
    lgs = [lg0]
    rest = torch.as_tensor(generated[:-1], device="cuda")[None]
    for chunk in (rest.split(1, dim=1) if stepwise else (rest,)):
        if chunk.shape[1]:
            lg, cache, _ = T.apply(cfg, params, chunk, cache=cache,
                                   mode="decode", logits_slice="all")
            lgs.append(lg[0])
    return torch.cat(lgs, dim=0)


def forced_logits(torch, cfg, params, reqs, frames=None):
    """The port's monolithic forward over each request's stream (its
    prompt and every generated token but the last), teacher-forced, in one
    batch right-padded to the longest (and a cross-attention stack's
    ``frames``, one row per request): {rid: f32 logits of positions
    prompt_len - 1 ..}.  Each row is causal, so the pad after a stream
    reaches none of its scored positions.  Where the full logits would pass
    2^28 entries (recurrentgemma-9b: 256,000 x 3,000), the stack runs to
    its residual stream and only the scored positions are normed and
    unembedded, as ``T.apply`` does them."""
    from repro_torch.models import layers as L
    from repro_torch.models import quant as Q
    from repro_torch.models import transformer as T

    streams = [list(map(int, r.prompt)) + r.generated[:-1] for r in reqs]
    toks = torch.zeros((len(reqs), max(map(len, streams))), dtype=torch.long,
                       device="cuda")
    for row, st in enumerate(streams):
        toks[row, :len(st)] = torch.as_tensor(st, device="cuda")
    rows = [(r.rid, row, r.prompt_len - 1, len(st))
            for row, (r, st) in enumerate(zip(reqs, streams))]
    if toks.numel() * cfg.vocab_size <= 2 ** 28:
        logits, _, _ = T.apply(cfg, params, toks, frames=frames,
                               mode="train")
        return {rid: logits[row, a:z].float() for rid, row, a, z in rows}
    x, _, _ = T.apply(cfg, params, toks, frames=frames, mode="train",
                      hidden_out=True)
    dtype = params["out_norm"].dtype
    unembed = Q.dequant(params["embed"], dtype).t() \
        if cfg.tie_embeddings else Q.dequant(params["unembed"], dtype)
    return {rid: (L.rms_norm(x[row, a:z], params["out_norm"], cfg.rms_eps)
                  @ unembed).float() for rid, row, a, z in rows}


def token_gaps(torch, lg, tokens):
    """How far below its row's best logit each chosen token's logit is."""
    got = lg.gather(1, torch.as_tensor(tokens, device=lg.device)[:, None])
    return lg.max(dim=1).values - got[:, 0]


def check_streams(torch, cfg, params, label, reqs, launches, needed,
                  forbidden=(), bf16_streams=None, score=True,
                  frames_of=None, same_as=None):
    """Every request got its full budget, the kernels in ``needed`` ran and
    those in ``forbidden`` did not, and — teacher-forced through the port's
    own forward (the plain monolithic one; for an int8-KV stack
    ``int8_forward_logits``) — every served token is within TOKEN_GAP_TOL
    of its step's best logit.  For int8 also reports, as information, the
    teacher-forced argmax agreement with the unquantized forward (JAX's
    policy asks >= 90 %) and the served tokens equal to the unquantized
    run's.

    A MoE stack over int8 KV scores its first tokens only, which come from
    the prefill's logits over unquantized K/V; its decoded tokens are
    reported, not scored.  They read the quantized cache, and no reference
    follows them: an f32 rounding difference of another GEMM shape moves a
    K/V entry across an int8 rounding boundary, the step moves the
    attention output slightly, and where that flips the router's top-k
    the expert outputs (~100x the attention's at JAX's 1/sqrt(E) expert
    scale, ROADMAP R4) move the logits by whole units.  The report shows
    it: the gaps against two references that differ only in GEMM shapes
    (one multi-token decode step; one token a step, as serving decodes),
    and how far the two references differ from each other.  With
    ``score`` off (a bf16 MoE stack, PERF.md §7) every gap is reported and
    none fails the run.  ``frames_of`` maps a request id to its frames
    (a cross-attention stack's reference attends to them too).  With
    ``same_as`` (rid -> the tokens of a run scored this way) every stream
    must equal its own there, and is not scored again."""
    from repro_torch.models import transformer as T

    for r in reqs:
        if len(r.generated) != r.max_new_tokens:
            fail(f"[{label}] request {r.rid}: "
                 f"{len(r.generated)}/{r.max_new_tokens} tokens")
    for name in needed:
        if launches[name] <= 0:
            fail(f"[{label}] kernel {name} was not launched on the "
                 f"serving path")
    for name in forbidden:
        if launches[name] != 0:
            fail(f"[{label}] kernel {name} was launched {launches[name]} "
                 f"times; this path must not run it")
    if same_as is not None:
        differ = [r.rid for r in reqs if r.generated != same_as[r.rid]]
        if differ:
            fail(f"[{label}] streams of requests {differ} differ from the "
                 f"scored run's")
        say(f"[{label}] every stream equals the scored run's "
            f"({len(reqs)}/{len(reqs)}), so every token is within "
            f"{TOKEN_GAP_TOL} of its step's best as there")
        return
    moe_int8 = cfg.kv_quant and cfg.n_experts > 0
    worst = 0.0
    spread = []
    agree = total = same = scored = over = 0
    multi, step_gaps, ref_diff, ref_argmax = [], [], [], 0
    # a stack without attention (xLSTM) steps its recurrence token by token
    # from Python: one batched forward of every stream instead of one each
    batched = (forced_logits(torch, cfg, params, reqs)
               if not cfg.uses_kv_cache else None)
    for r in reqs:
        lg = batched[r.rid] if batched is not None else forced_logits(
            torch, cfg, params, [r],
            frames=frames_of[r.rid] if frames_of else None)[r.rid]
        if cfg.kv_quant:
            bf16_top = lg.argmax(dim=1)
            lg = int8_forward_logits(torch, cfg, params, r.prompt,
                                     r.generated).float()
            agree += int((lg.argmax(dim=1) == bf16_top).sum())
            total += len(r.generated)
            if bf16_streams is not None:
                same += sum(a == b for a, b in zip(r.generated,
                                                   bf16_streams[r.rid]))
        if not torch.isfinite(lg).all():
            fail(f"[{label}] request {r.rid}: non-finite logits")
        if moe_int8:
            step = int8_forward_logits(torch, cfg, params, r.prompt,
                                       r.generated, stepwise=True).float()
            if not torch.isfinite(step).all():
                fail(f"[{label}] request {r.rid}: non-finite logits")
            multi += token_gaps(torch, lg, r.generated)[1:].tolist()
            step_gaps += token_gaps(torch, step, r.generated)[1:].tolist()
            ref_diff.append(float((lg - step)[1:].abs().max()))
            ref_argmax += int((lg.argmax(dim=1) != step.argmax(dim=1))[1:]
                              .sum())
            lg = lg[:1]
        gaps = token_gaps(torch, lg, r.generated[:len(lg)])
        gap = float(gaps.max())
        scored += len(lg)
        over += int((gaps > TOKEN_GAP_TOL).sum())
        worst = max(worst, gap)
        spread.append(float(lg.std()))
        if gap > TOKEN_GAP_TOL and score:
            fail(f"[{label}] request {r.rid}: a served token is {gap:.3f} "
                 f"below its step's best logit (tolerance {TOKEN_GAP_TOL})")
    say(f"[{label}] teacher-forced{'' if score else ', reported and not scored'}"
        f": worst served-token gap {worst:.4f}, {over}/{scored} "
        f"{'scored ' if score else ''}tokens over the tolerance "
        f"{TOKEN_GAP_TOL} (logit std {sum(spread) / len(spread):.3f})")
    if moe_int8:
        def over(gaps):
            return sum(g > TOKEN_GAP_TOL for g in gaps)
        n = len(multi)
        say(f"[{label}] decoded tokens over int8 KV in a MoE stack, reported "
            f"and not scored (check_streams says why): against the "
            f"multi-token reference {over(multi)}/{n} steps over "
            f"{TOKEN_GAP_TOL}, largest gap {max(multi):.4f}; against the "
            f"one-token-a-step reference {over(step_gaps)}/{n}, largest "
            f"{max(step_gaps):.4f}; the two references differ by up to "
            f"{max(ref_diff):.4f} logits and in argmax at {ref_argmax}/{n} "
            f"steps")
    if cfg.kv_quant:
        say(f"[{label}] int8 vs unquantized forward, teacher-forced on the "
            f"served streams: argmax agrees on {agree}/{total} steps "
            f"({agree / max(total, 1):.1%}); served tokens equal to the "
            f"unquantized plain run's at the same place: {same}/{total}")


def say_speculation(label, card, stats, iter_ms) -> None:
    say(f"[{label}] speculation (spec_len 4): acceptance "
        f"{stats['acceptance_rate']}, {stats['tokens_per_decode_iter']:.3f} "
        f"tokens per decode iteration, {iter_ms:.1f} ms per decode "
        f"iteration, spec_iters {stats['spec_iters']} / plain_iters "
        f"{stats['spec_plain_iters']}, proposed {stats['spec_proposed']}, "
        f"accepted {stats['spec_accepted']} [{card}]")


def self_draft_run(torch, card, cfg, params):
    """Self-draft speculation at the engine level: the target drafts for
    itself (``draft=(cfg, params)``) and verifies on kernel B4, as the JAX
    package's self-draft bench arm does.  The orchestrator's load-aware
    rule bills the draft's k decode steps at the target's own cost, so it
    never speculates with this draft; the engines are driven directly.
    Returns the launches during the run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                            PrefillEngine)

    label = "self-draft"
    ecfg = EngineConfig(max_len=1024, max_batch=8, block_size=16,
                        speculation="draft", spec_len=4)
    pe = PrefillEngine(cfg, params, ecfg)
    de = DecodeEngine(cfg, params, ecfg, draft=(cfg, params))
    reqs = served_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        st, lg = pe.run(r)
        de.insert(r, st, int(torch.argmax(lg)))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s = 0.0
    while de.active:
        t = time.perf_counter()
        de.step()
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t
    capture_s = de.compiled.capture_s
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    if de.active:
        fail(f"[{label}] live slots after the run")
    try:
        de.pool.check(holders=[de.slot_pages(i)
                               for i in range(ecfg.max_batch)])
    except AssertionError as exc:
        fail(f"[{label}] pool invariant: {exc}")
    if len(de._free) != ecfg.max_batch * de._nb_slot:
        fail(f"[{label}] leaked pages")
    if de.spec_proposed <= 0 or de.spec_accepted <= 0:
        fail(f"[{label}] the self-draft had no proposal accepted "
             f"({de.spec_accepted}/{de.spec_proposed})")
    check_streams(torch, cfg, params, label, reqs, launches,
                  ("flash_prefill", "paged_verify_partials"))
    tokens_out = sum(len(r.generated) for r in reqs)
    iter_ms = decode_s / max(de.decode_iters, 1) * 1e3
    steady_ms = (decode_s - capture_s) / max(de.decode_iters, 1) * 1e3
    prompt_tokens = sum(r.prompt_len for r in reqs)
    say(f"[{label}] engine-level run: {len(reqs)} requests, prefill "
        f"{prompt_tokens} tokens in {prefill_s:.3f} s = "
        f"{prompt_tokens / max(prefill_s, 1e-9):.1f} tok/s (one request per "
        f"forward, no store); decode {de.tokens_decoded} tokens in "
        f"{decode_s:.3f} s = {de.tokens_decoded / max(decode_s, 1e-9):.1f} "
        f"tok/s over {de.decode_iters} iterations ({steady_ms:.1f} ms each "
        f"without the {capture_s:.3f} s of graph warm-up and capture); peak "
        f"memory {peak / 2**30:.2f} GiB [{card}]")
    say_speculation(label, card, {
        "acceptance_rate": de.spec_accepted / de.spec_proposed,
        # as Server's summary counts it: every token out over the iterations
        "tokens_per_decode_iter": tokens_out / max(de.decode_iters, 1),
        "spec_iters": de.decode_iters, "spec_plain_iters": 0,
        "spec_proposed": de.spec_proposed,
        "spec_accepted": de.spec_accepted}, iter_ms)
    say_graphs(label, card, [de])
    say(f"[{label}] serving-path launches: {json.dumps(launches)}")
    del pe, de
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_run(torch, card, cfg, params, *, label, speculation, chunk_tokens,
              needed, forbidden, profile, bf16_streams=None, graphs=True,
              score=True, max_len=1024, decode_kernel=("B1",
                                                        "paged_decode_kernel"),
              requests=None, same_as=None):
    """One run through ``Server`` (decode forwards replayed from CUDA
    graphs, or with ``graphs`` off run eagerly over the same static
    buffers); returns its launches, streams and decode figures.
    ``score``: as ``check_streams``'.  ``max_len`` 1000 (no multiple of
    the 16-token block) serves on dense rows; ``decode_kernel`` (name,
    symbol) is the attention kernel whose share of a profiled decode
    iteration is printed (None: none, for the xLSTM).  A chunked run
    whose resumes read published pages (B3) profiles one chunk-resume
    wave; dense rows and ring or recurrent stacks resume over the dense
    wave cache, without B3, so none.  ``requests`` (default
    ``served_requests``) makes the run's request list.  ``same_as``: as
    ``check_streams``'."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import Server
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)

    ecfg = EngineConfig(max_len=max_len, max_batch=8, block_size=16,
                        speculation=speculation, spec_len=4,
                        cuda_graphs=graphs)
    orch = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ecfg, chunk_tokens=chunk_tokens))
    reqs = (requests or served_requests)(cfg)

    # wall-clock per phase (synchronized), wrapped around the engines
    clocks = {"prefill_s": 0.0, "decode_s": 0.0, "span_ms": 0.0,
              "capture_s": 0.0,
              "decode_tokens": 0,
              "decode_iters": 0, "profiled_waves": 0,
              "profiled_tokens": 0, "profiled_s": 0.0}
    pe = orch.prefill_members()[0].prefill
    de = orch.decode_units()[0]
    waves = pe.prefill_waves
    step = de.step
    prof = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # with chunked prefill, waves run under torch.profiler (and are left
    # out of the prefill clock) until one of them resumes a prompt over
    # its published pages (B3 launches in it)
    profile_wave = profile and chunk_tokens is not None and pe._paged_inc

    def timed_waves(*a, **kw):
        gen = waves(*a, **kw)
        while True:
            if profile_wave and "wave" not in prof:
                before = ops.LAUNCHES["paged_prefix_partials"]
                t = time.perf_counter()
                with torch.profiler.profile(activities=acts) as p:
                    wave = next(gen, None)
                    torch.cuda.synchronize()
                if wave is None:
                    return
                wave_s = time.perf_counter() - t
                clocks["profiled_waves"] += 1
                clocks["profiled_tokens"] += wave["tokens"]
                clocks["profiled_s"] += wave_s
                if ops.LAUNCHES["paged_prefix_partials"] > before:
                    prof["wave"] = p
                    prof["wave_ms"] = wave_s * 1e3
                    prof["wave_shape"] = (wave["rows"], wave["padded_len"])
                yield wave
                continue
            t = time.perf_counter()
            wave = next(gen, None)
            torch.cuda.synchronize()
            clocks["prefill_s"] += time.perf_counter() - t
            if wave is None:
                return
            yield wave

    def timed_step():
        if profile and de.decode_iters == PROFILE_ITER - 1:
            prof["rows"] = de.active
            t = time.perf_counter()
            with torch.profiler.profile(activities=acts) as p, \
                    StepEvents(torch) as ev:
                out = step()
                torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - t) * 1e3
            prof["profile"] = p          # summarised after the timed run
            prof["step_ms"] = ev.ms()
            return out
        t = time.perf_counter()
        before = de.tokens_decoded
        cap = de.compiled.capture_s
        with StepEvents(torch) as ev:
            out = step()
            torch.cuda.synchronize()
        clocks["decode_s"] += time.perf_counter() - t
        clocks["capture_s"] += de.compiled.capture_s - cap
        clocks["span_ms"] += ev.ms()
        clocks["decode_tokens"] += de.tokens_decoded - before
        clocks["decode_iters"] += 1
        return out

    pe.prefill_waves = timed_waves
    de.step = timed_step

    if profile:
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").sum()   # start the tracer untimed
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    summary = Server(orch).run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - prof.get("wall_ms", 0.0) / 1e3 \
        - clocks["profiled_s"]
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        if r.outcome is None or r.outcome.value != "completed":
            fail(f"[{label}] request {r.rid}: outcome {r.outcome}")
    check_pools_restored(orch)
    if speculation != "off" and (summary["spec_iters"] <= 0
                                 or summary["spec_proposed"] <= 0):
        fail(f"[{label}] no speculative iteration scored a proposal")
    check_streams(torch, cfg, params, label, reqs, launches, needed,
                  forbidden, bf16_streams, score, same_as=same_as)
    prefill_tokens = sum(m.tokens_prefilled for m in orch.prefill_members()) \
        - clocks["profiled_tokens"]
    say(f"[{label}] served {len(reqs)} requests: prompts "
        f"{min(r.prompt_len for r in reqs)}-"
        f"{max(r.prompt_len for r in reqs)} tokens, "
        f"{sum(r.cached_tokens for r in reqs)} prompt tokens from the store, "
        f"{summary['pages_bound']} pages bound, {summary['cow_forks']} COW "
        f"forks, {sum(len(r.generated) for r in reqs)} tokens out")
    iter_ms = clocks["decode_s"] / max(clocks["decode_iters"], 1) * 1e3
    # the steady iteration: the graphs' one-time warm-up and capture out
    steady_ms = (clocks["decode_s"] - clocks["capture_s"]) \
        / max(clocks["decode_iters"], 1) * 1e3
    span_ms = clocks["span_ms"] / max(clocks["decode_iters"], 1)
    say(f"[{label}] wall clock"
        f"{' (profiled iteration and waves left out)' if prof else ''}: "
        f"{wall:.2f} s; prefill {prefill_tokens} tokens ("
        f"{clocks['profiled_waves']} profiled waves left out) in "
        f"{clocks['prefill_s']:.3f} s = "
        f"{prefill_tokens / max(clocks['prefill_s'], 1e-9):.1f} tok/s; "
        f"decode {clocks['decode_tokens']} tokens in "
        f"{clocks['decode_s']:.3f} s = "
        f"{clocks['decode_tokens'] / max(clocks['decode_s'], 1e-9):.1f} "
        f"tok/s ({clocks['decode_iters']} timed iterations, {iter_ms:.1f} "
        f"ms each, {steady_ms:.1f} ms without the "
        f"{clocks['capture_s']:.3f} s of graph warm-up and capture; the "
        f"compiled steps' device span "
        f"{span_ms:.1f} ms by CUDA events); {summary['decode_iters']} "
        f"decode iterations in all, "
        f"tokens_per_decode_iter {summary['tokens_per_decode_iter']:.3f}; "
        f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    if speculation != "off":
        say_speculation(label, card, summary, iter_ms)
    if "profile" in prof:
        evs = prof["profile"].key_averages()
        # device entries only: an aten op's device time repeats its kernels'
        kern = device_kernels(evs)
        busy = sum(device_us(e) for e in kern) / 1e3
        n_aten = sum(e.count for e in evs if e.key.startswith("aten::"))
        top = sorted(kern, key=device_us, reverse=True)[:5]
        head = (f"[{label}] decode iteration {PROFILE_ITER} "
                f"({'replayed' if graphs else 'eager'}) under "
                f"torch.profiler ({prof['rows']} rows, {n_aten} aten op "
                f"calls, nested included; wall {prof['wall_ms']:.1f} ms with "
                f"the profiler on; compiled step's device span "
                f"{prof['step_ms']:.2f} ms by CUDA events, profiler on): "
                f"device busy ")
        # B1 (bf16 or int8 pools), or B5 on dense rows, by its symbol;
        # none for a stack whose decode runs no attention kernel
        share = ""
        if decode_kernel is not None:
            kname, ksym = decode_kernel
            b1 = [e for e in kern if ksym in e.key]
            b1_ms = sum(device_us(e) for e in b1) / 1e3
            share = (f"{kname} {b1_ms:.3f} ms x{sum(e.count for e in b1)} "
                     f"= {b1_ms / max(busy, 1e-9):.1%} of the busy time; ")
        if busy > 0:
            say(head + f"{busy:.2f} ms in {sum(e.count for e in kern)} "
                f"kernels = {busy / steady_ms:.0%} of a timed iteration "
                f"without capture; {share}top: "
                + "; ".join(f"{e.key[:72]} {device_us(e) / 1e3:.2f} ms "
                            f"x{e.count}" for e in top))
        else:
            say(head + "not measured (the profiler recorded no device time)")
    if profile_wave:
        say_wave_profile(label, card, prof)
    say_graphs(label, card, [de])
    say(f"[{label}] serving-path launches: {json.dumps(launches)}")
    del orch, pe, de
    return {"launches": launches,
            "streams": {r.rid: list(r.generated) for r in reqs},
            "iter_ms": iter_ms,
            "steady_ms": steady_ms,
            "span_ms": span_ms,
            "decode_tps": clocks["decode_tokens"]
            / max(clocks["decode_s"], 1e-9),
            "prefill_tps": prefill_tokens / max(clocks["prefill_s"], 1e-9),
            "peak_gib": peak / 2**30,
            "decode_profile": prof.get("profile")}


def say_wave_profile(label, card, prof) -> None:
    """Device time of one profiled chunk-resume prefill wave by kernel
    family: B2 (flash_kernel), B3 (prefix_kernel), the GEMMs, the rest;
    and the card's busy share of the wave's wall time (profiler on)."""
    if "wave" not in prof:
        fail(f"[{label}] no profiled prefill wave launched B3")
    kern = device_kernels(prof["wave"].key_averages())
    fams = {"B2": 0.0, "B3": 0.0, "GEMM": 0.0, "other": 0.0}
    counts = dict.fromkeys(fams, 0)
    for e in kern:
        name = e.key.lower()
        fam = ("B2" if "flash_kernel" in name else
               "B3" if "prefix_kernel" in name else
               "GEMM" if any(x in name for x in ("nvjet", "gemm", "xmma",
                                                 "cutlass")) else "other")
        fams[fam] += device_us(e) / 1e3
        counts[fam] += e.count
    busy = sum(fams.values())
    rows, blen = prof["wave_shape"]
    head = (f"[{label}] chunk-resume prefill wave under torch.profiler "
            f"({rows} rows x {blen} tokens; wall {prof['wave_ms']:.1f} ms "
            f"with the profiler on): ")
    if busy <= 0:
        say(head + "not measured (the profiler recorded no device time)")
        return
    say(head + f"device busy {busy:.2f} ms = "
        f"{busy / prof['wave_ms']:.0%} of the wave; " + "; ".join(
            f"{k} {v:.3f} ms x{counts[k]}" for k, v in fams.items())
        + f" [{card}]")


def check_pools_restored(orch) -> None:
    """Every decode slot empty; each page's refcount equals its holders
    (slot rows plus the store's page holds); free list plus store-held
    pages account for the whole pool (every stage of a pipeline).  A
    dense-row engine has no pool: only its slots are checked."""
    store = orch.store
    for e in [e for u in orch.decode_units()
              for e in getattr(u, "engines", [u])]:
        if e.active:
            fail(f"{e.name}: live slots after drain")
        if not e.paged:
            continue
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
# Migration: span pipelines, live span moves, slot rebalance, re-roll
# ---------------------------------------------------------------------------

# A span-pipeline prefill and a full-stack one compute the same first
# chunk with the same kernels; a resumed chunk attends through plain
# attend (bf16 scores, as JAX) in the pipeline and through kernels B3 + B2
# (f32 scores) in the full-stack engine.  Their K/V may then differ by
# bf16 rounding carried through 40 layers: held to this share of the
# largest |K|/|V| of the layer's state.
STATE_TOL_REL = 0.05


def storage_ptrs(torch, tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(storage_ptrs(torch, v) for v in tree.values()))
    if isinstance(tree, (tuple, list)):
        return set().union(set(), *(storage_ptrs(torch, v) for v in tree))
    return {tree.untyped_storage().data_ptr()} if torch.is_tensor(tree) \
        else set()


def check_views(torch, label, params, engines) -> None:
    """Every span engine's weights are views of the full parameters."""
    full = storage_ptrs(torch, params)
    for e in engines:
        if not storage_ptrs(torch, e.sparams) <= full:
            fail(f"[{label}] {e.name}: span weights are not views of the "
                 f"full parameters")
    say(f"[{label}] weights: {len(engines)} engines, every weight a "
        f"view of the full parameters (storage shared)")


def say_streams_vs_plain(label, reqs, plain_streams) -> None:
    same = sum(r.generated == plain_streams[r.rid] for r in reqs)
    say(f"[{label}] streams identical to the plain run's: "
        f"{same}/{len(reqs)}")


def timed_action(torch, orch, kind, src, dst, amount):
    """Force one action through ``apply_action`` at the cost the
    controller would bill it; returns (applied, host ms synchronised,
    billed seconds)."""
    from repro_torch.core.migration import MigrationAction

    loads = {d.device: d for d in orch._device_loads()}
    benefit, cost = orch._migration_cost(kind, loads[src], loads[dst],
                                         amount)
    act = MigrationAction(kind, src=src, dst=dst, amount=amount,
                          predicted_benefit=benefit, predicted_cost=cost)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok = orch.apply_action(act)
    torch.cuda.synchronize()
    return ok, (time.perf_counter() - t) * 1e3, cost


def migration_run(torch, card, cfg, params, plain_streams, *, label,
                  n_prefill, decode_split, force, max_len=1024,
                  chunk_tokens=256, requests=None,
                  needed=("paged_decode_partials", "flash_prefill",
                          "paged_prefix_partials"),
                  forbidden=("paged_verify_partials",), exact=False):
    """One ``Server`` run over a migrating fleet; ``force(orch)`` applies
    the forced actions once the run is under way.  ``exact``: every
    stream must equal ``plain_streams`` (then it is not scored again).
    Returns launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import Server
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)

    ecfg = EngineConfig(max_len=max_len, max_batch=8, block_size=16)
    orch = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=n_prefill, n_decode=2, decode_split=decode_split,
        migration=True, chunk_tokens=chunk_tokens, engine=ecfg))
    reqs = (requests or served_requests)(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    srv = Server(orch)
    for r in reqs:
        srv.submit(r, at=r.arrival)
    n_forced = force(orch, srv)
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        if r.outcome is None or r.outcome.value != "completed":
            fail(f"[{label}] request {r.rid}: outcome {r.outcome}")
    check_pools_restored(orch)
    check_views(torch, label, params,
                [e for p in orch.decode_pipes for e in p.engines])
    check_streams(torch, cfg, params, label, reqs, launches, needed,
                  forbidden, same_as=plain_streams if exact else None)
    say_streams_vs_plain(label, reqs, plain_streams)
    s = orch.summary()
    decoded = {m.name: m.decode.tokens_decoded for m in orch.decode_members()}
    say(f"[{label}] tokens decoded per decode member {decoded}; actions "
        f"applied (kind, src, dst, amount, billed ms): " + ", ".join(
            f"({a.kind.value}, {a.src}, {a.dst}, {a.amount}, "
            f"{a.predicted_cost * 1e3:.3f})" for a in orch.migration_log))
    say(f"[{label}] fleet {s['fleet']}; span bounds "
        f"{s.get('span_bounds', {})}; {s['migrations']} actions applied "
        f"({n_forced} forced, {s['migrations'] - n_forced} planned by "
        f"Algorithm 1 over {len(orch.util_trace)} control cycles); "
        f"span_moves {s['span_moves']}, span_bytes_moved "
        f"{s['span_bytes_moved']}; {s['decode_iters']} decode iterations; "
        f"wall {wall:.2f} s; peak memory {peak / 2**30:.2f} GiB [{card}]")
    say_graphs(label, card, [e for u in orch.decode_units()
                             for e in getattr(u, "engines", [u])])
    say(f"[{label}] serving-path launches: {json.dumps(launches)}")
    del orch, srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_until(orch, srv, cond, what):
    while not cond():
        if not orch.clock:
            fail(f"the run ended before {what}")
        srv.step()


def force_span_moves(torch, card, label):
    """(a): after the third decode iteration, move 4 layers decode0.0 ->
    decode0.1 and 4 layers decode1.1 -> decode1.0, then rebalance slots
    between the two pipelines (KV_HEADS)."""
    from repro_torch.core.migration import MigrationKind

    def force(orch, srv):
        run_until(orch, srv, lambda: orch.metrics.decode_iters >= 3
                  and sum(p.active for p in orch.decode_pipes) >= 2,
                  "three decode iterations with two residents")
        for src, dst in (("decode0.0", "decode0.1"),
                         ("decode1.1", "decode1.0")):
            forced_span_move(torch, card, label, orch, src, dst, 4)
        # the router keeps the pipelines level: move one pipeline's
        # residents onto the other (extract/adopt), then let KV_HEADS
        # rebalance them
        heavy, light = orch.decode_pipes
        for slot, r in enumerate(light.slots):
            if r is not None:
                heavy.adopt(*light.extract_slot(slot))
        before = (heavy.active, light.active)
        ok, ms, cost = timed_action(torch, orch, MigrationKind.KV_HEADS,
                                    heavy.lead.name, light.lead.name, 1)
        if not ok or light.active == 0:
            fail(f"[{label}] the KV_HEADS rebalance was refused")
        say(f"[{label}] KV_HEADS rebalance {heavy.name} -> {light.name}: "
            f"residents {before} -> {(heavy.active, light.active)} in "
            f"{ms:.1f} ms host wall clock (synchronised), billed "
            f"{cost * 1e3:.3f} ms [{card}]")
        return 3
    return force


def force_move_then_rebalance(torch, card, label):
    """(o): after the third decode iteration, once a pipeline holds a
    request, move 4 layers from its first stage to its second; then, once
    two requests are decode-resident, move every resident onto one
    pipeline and rebalance slots to the other (KV_HEADS)."""
    from repro_torch.core.migration import MigrationKind

    def force(orch, srv):
        pipes = orch.decode_pipes
        run_until(orch, srv, lambda: orch.metrics.decode_iters >= 3
                  and any(p.active for p in pipes),
                  "three decode iterations with a resident")
        pipe = max(pipes, key=lambda p: p.active)
        forced_span_move(torch, card, label, orch, pipe.engines[0].name,
                         pipe.engines[1].name, 4)
        run_until(orch, srv, lambda: sum(p.active for p in pipes) >= 2,
                  "two decode residents")
        heavy, light = sorted(pipes, key=lambda p: -p.active)
        for slot, r in enumerate(light.slots):
            if r is not None:
                heavy.adopt(*light.extract_slot(slot))
        before = (heavy.active, light.active)
        ok, ms, cost = timed_action(torch, orch, MigrationKind.KV_HEADS,
                                    heavy.lead.name, light.lead.name, 1)
        if not ok or light.active == 0:
            fail(f"[{label}] the KV_HEADS rebalance was refused")
        say(f"[{label}] KV_HEADS rebalance {heavy.name} -> {light.name}: "
            f"residents {before} -> {(heavy.active, light.active)} in "
            f"{ms:.1f} ms host wall clock (synchronised), billed "
            f"{cost * 1e3:.3f} ms [{card}]")
        return 2
    return force


def forced_span_move(torch, card, label, orch, src, dst, n_layers) -> None:
    """Force a span move of ``n_layers`` layers ``src`` -> ``dst`` and print
    its host ms, the bytes it accounts and its billed cost."""
    from repro_torch.core.migration import MigrationKind

    ok, ms, cost = timed_action(torch, orch, MigrationKind.LAYER, src, dst,
                                n_layers)
    if not ok:
        fail(f"[{label}] the span move {src} -> {dst} was refused")
    rec = orch.span_move_log[-1]
    cfg = orch.cfg
    split = ""
    kinds = cfg.blocks()
    moved = [kinds[l].value for l, _ in rec["schedule"]]
    residents = orch._by_name[src].pipe.active
    if "mlstm" in moved or "slstm" in moved:
        # each moved xLSTM layer carries every resident's f32 state:
        # mLSTM C (H, D, D), n (H, D), m (H); sLSTM c, n, m, h (d)
        h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
        per = {"mlstm": 4 * (h * hd * hd + h * hd + h), "slstm": 16 * d}
        split = (" (" + ", ".join(
            f"{moved.count(k)} {k} layers x {residents} residents x "
            f"{per[k]} B" for k in per if k in moved) + ")")
    elif cfg.uses_recurrent_state:
        # each moved RG-LRU layer carries every resident's h (f32) and
        # conv history (bf16); the rest of kv_bytes is ring pages
        n_rec = moved.count("rglru")
        conv_b = orch.params["out_norm"].element_size()
        rec_b = n_rec * residents * cfg.d_model * (
            4 + conv_b * (cfg.rglru_conv_width - 1))
        split = (f" ({rec_b} of recurrent state: {n_rec} RG-LRU layers x "
                 f"{residents} residents; {rec['kv_bytes'] - rec_b} of ring "
                 f"pages)")
    say(f"[{label}] span move {src} -> {dst}: {rec['layers']} "
        f"layers in {ms:.1f} ms host wall clock (synchronised), "
        f"weight_bytes {rec['weight_bytes']} (views: re-sliced, not "
        f"copied), kv_bytes {rec['kv_bytes']}{split}, billed "
        f"{cost * 1e3:.3f} ms (Eq. 4/11, H100 data sheet) [{card}]")


def force_one_span_move(torch, card, label, n_layers=None):
    """(i), (m): after the third decode iteration, once a pipeline holds a
    request, move ``n_layers`` (default a quarter of the stack) from its
    first stage to its second (the KV of its residents moves with the
    layers)."""
    def force(orch, srv):
        run_until(orch, srv, lambda: orch.metrics.decode_iters >= 3
                  and any(p.active for p in orch.decode_pipes),
                  "three decode iterations with a resident")
        pipe = max(orch.decode_pipes, key=lambda p: p.active)
        src, dst = (e.name for e in pipe.engines)
        forced_span_move(torch, card, label, orch, src, dst,
                         n_layers or orch.cfg.n_layers // 4)
        return 1
    return force


def force_reroll(torch, card, label):
    """(b): after the third decode iteration, once prefill1 is idle,
    re-roll it into a decode member (its queue re-routes to prefill0)."""
    from repro_torch.core.migration import MigrationKind

    def force(orch, srv):
        m = orch._by_name["prefill1"]
        run_until(orch, srv, lambda: orch.metrics.decode_iters >= 3
                  and not m.busy and m._wavegen is None,
                  "three decode iterations with prefill1 idle")
        pending = sum(r.phase.value in ("queued", "routed", "prefill")
                      for r in orch._by_rid.values())
        ok, ms, cost = timed_action(torch, orch, MigrationKind.LAYER,
                                    "decode0", "prefill1", orch.cfg.n_layers)
        if not ok or m.role != "decode":
            fail(f"[{label}] the re-roll of prefill1 was refused")
        say(f"[{label}] re-roll prefill1 -> decode in {ms:.1f} ms host wall "
            f"clock (synchronised; a fresh decode engine and its pool; "
            f"{m.tokens_prefilled} tokens prefilled there before, "
            f"{pending} requests not yet handed off), billed "
            f"{cost * 1e3:.3f} ms [{card}]")
        return 1
    return force


def pipeline_engine_run(torch, card, cfg, params, plain_streams):
    """(c): a ``PrefillPipeline`` over [(0, 20), (20, 40)] against a
    full-stack ``PrefillEngine`` on the same 8 requests in 256-token
    chunks (fresh and chunk-resume waves), its states decoded to the end
    by a ``DecodePipeline``.  Returns the pipelines' launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, PrefillEngine
    from repro_torch.serving.span import DecodePipeline, PrefillPipeline

    label = "migrate-c"
    bounds = [(0, 20), (20, 40)]
    ecfg = EngineConfig(max_len=1024, max_batch=8, block_size=16)
    full = PrefillEngine(cfg, params, ecfg)
    want = full.run_batch(served_requests(cfg), chunk_tokens=256)
    del full
    pp = PrefillPipeline(cfg, params, ecfg, bounds)
    dp = DecodePipeline(cfg, params, ecfg, bounds)
    check_views(torch, label, params, pp.engines + dp.engines)
    reqs = served_requests(cfg)
    resumed = sum(r.prompt_len > 256 for r in reqs)
    if not resumed:
        fail(f"[{label}] no prompt is long enough to resume")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    n_waves = 0
    got = [None] * len(reqs)
    for wave in pp.prefill_waves(reqs, chunk_tokens=256):
        n_waves += 1
        for i, st, lg in wave["done"]:
            got[i] = (st, lg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    worst_state = worst_gap = first_chunk = 0.0
    head = 256 // ecfg.block_size          # pages of the first, fresh chunk
    for r, (st, lg), (wst, wlg) in zip(reqs, got, want):
        if int(st["n_blocks"]) != int(wst["n_blocks"]) or \
                int(st["length"]) != int(wst["length"]):
            fail(f"[{label}] request {r.rid}: state shape differs")
        for g, wg in zip(st["groups"], wst["groups"]):
            if not torch.equal(g["pos"], wg["pos"]):
                fail(f"[{label}] request {r.rid}: positions differ")
            for key in ("k", "v"):
                err = float((g[key].float() - wg[key].float()).abs().max())
                rel = err / max(float(wg[key].float().abs().max()), 1e-9)
                worst_state = max(worst_state, rel)
                first_chunk = max(first_chunk, float(
                    (g[key][:, :head].float()
                     - wg[key][:, :head].float()).abs().max()))
        gap = float(wlg.float().max() - wlg.float()[int(lg.argmax())])
        worst_gap = max(worst_gap, gap)
        if worst_state > STATE_TOL_REL or gap > TOKEN_GAP_TOL:
            fail(f"[{label}] request {r.rid}: pipeline prefill off the "
                 f"full-stack one (state {worst_state:.4f} of max |K|/|V|, "
                 f"tolerance {STATE_TOL_REL}; first-token gap {gap:.3f}, "
                 f"tolerance {TOKEN_GAP_TOL})")
    del want
    t1 = time.perf_counter()
    for r, (st, lg) in zip(reqs, got):
        dp.insert(r, st, int(torch.argmax(lg)))
    del got
    iters = 0
    while dp.active:
        dp.step()
        iters += 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for e in dp.engines:
        if e.active or len(e._free) != ecfg.max_batch * e._nb_slot:
            fail(f"[{label}] {e.name}: pool not restored")
    check_streams(torch, cfg, params, label, reqs, launches,
                  ("paged_decode_partials", "flash_prefill"),
                  ("paged_prefix_partials", "paged_verify_partials"))
    say_streams_vs_plain(label, reqs, plain_streams)
    tokens = sum(len(r.generated) for r in reqs)
    say(f"[{label}] PrefillPipeline {bounds}: {n_waves} waves ({resumed} "
        f"prompts resumed chunk by chunk) in {prefill_s:.3f} s; "
        f"against the full-stack PrefillEngine: worst K/V difference "
        f"{worst_state:.4f} of the layer's max |K|/|V| (tolerance "
        f"{STATE_TOL_REL}; largest absolute difference in the first, fresh "
        f"chunk {first_chunk:.3g}), worst first-token gap {worst_gap:.4f} "
        f"(tolerance {TOKEN_GAP_TOL}); DecodePipeline: {tokens} tokens out "
        f"in {iters} iterations, {decode_s:.3f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    say_graphs(label, card, dp.engines)
    say(f"[{label}] serving-path launches: {json.dumps(launches)}")
    del pp, dp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def migration_phase(torch, card, cfg, params, plain_streams):
    """The migration runs on the served runs' weights and requests:
    (a) ``Server`` over two 2-stage decode pipelines with forced span
    moves and a slot rebalance, Algorithm 1 planning alongside; (b) a
    full-stack fleet with a forced re-roll of prefill1 into decode;
    (c) span pipelines at the engine level.  Returns {run: launches}."""
    t0 = time.perf_counter()
    out = {}
    out["migrate-a"] = migration_run(
        torch, card, cfg, params, plain_streams, label="migrate-a",
        n_prefill=1, decode_split=2,
        force=force_span_moves(torch, card, "migrate-a"))
    out["migrate-b"] = migration_run(
        torch, card, cfg, params, plain_streams, label="migrate-b",
        n_prefill=2, decode_split=1,
        force=force_reroll(torch, card, "migrate-b"))
    out["migrate-c"] = pipeline_engine_run(torch, card, cfg, params,
                                           plain_streams)
    say(f"migration phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# The front door: fair share with preemption, autoscaling, the CLI
# ---------------------------------------------------------------------------

TENANTS = ("bronze", "gold")


def synced_ms(torch, fn, *a):
    """Host milliseconds of ``fn(*a)``, synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def time_preemption(torch, orch, log):
    """Wrap the orchestrator's swap-out and resume: each logs (kind, rid,
    host ms synchronised, bytes of the state moved)."""
    from repro_torch.models import kvcache as KC

    swap_out, resume = orch._swap_out, orch._resume_swapped

    def timed_swap_out(unit, slot):
        rid = unit.slots[slot].rid
        _, ms = synced_ms(torch, swap_out, unit, slot)
        log.append(("swap-out", rid, ms,
                    KC.state_num_bytes(orch._swapped[rid][1])))

    def timed_resume():
        parked = {rid: KC.state_num_bytes(st)
                  for rid, (_, st, _) in orch._swapped.items()}
        _, ms = synced_ms(torch, resume)
        back = [rid for rid in parked if rid not in orch._swapped]
        if back:
            log.append(("resume", back, ms, sum(parked[r] for r in back)))

    orch._swap_out, orch._resume_swapped = timed_swap_out, timed_resume


def count_clone_waves(orch, acc):
    """Count the B2 launches of prefill waves whose batch holds a
    sacrifice clone (negative rid)."""
    from repro_torch.kernels import ops

    for m in orch.prefill_members():
        def waves(reqs, chunk_tokens=None, _orig=m.prefill.prefill_waves):
            clones = any(r.rid < 0 for r in reqs)
            gen = _orig(reqs, chunk_tokens=chunk_tokens)
            while True:
                before = ops.LAUNCHES["flash_prefill"]
                wave = next(gen, None)
                if wave is None:
                    return
                if clones:
                    acc["waves"] += 1
                    acc["b2"] += ops.LAUNCHES["flash_prefill"] - before
                yield wave
        m.prefill.prefill_waves = waves


def frontdoor_run(torch, card, cfg, params, plain_streams, *, label, drive,
                  n_decode, max_batch, scheduler=None, autoscaler=None):
    """One ``Server`` run of the 8 served requests over a fleet of one
    prefill and ``n_decode`` full-stack decode members (256-token chunks,
    graphs on); ``drive(orch, srv, reqs)`` submits and steps the run and
    returns what it checked.  Holds the streams to the teacher-forced rule,
    checks B1 and B2 ran and the pools are restored.  Returns (launches,
    the orchestrator's summary, what ``drive`` returned, the
    orchestrator)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import Server
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)

    ecfg = EngineConfig(max_len=1024, max_batch=max_batch, block_size=16)
    orch = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=1, n_decode=n_decode, chunk_tokens=256, engine=ecfg,
        migration=False))
    reqs = served_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    srv = Server(orch, scheduler=scheduler, autoscaler=autoscaler)
    out = drive(orch, srv, reqs)
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        if r.outcome is None or r.outcome.value != "completed":
            fail(f"[{label}] request {r.rid}: outcome {r.outcome}")
    check_pools_restored(orch)
    check_streams(torch, cfg, params, label, reqs, launches,
                  ("paged_decode_partials", "flash_prefill"),
                  ("paged_verify_partials",))
    say_streams_vs_plain(label, reqs, plain_streams)
    s = orch.summary()
    say(f"[{label}] {s['n_requests']} completed; fleet {s['fleet']}; "
        f"{s['decode_iters']} decode iterations; virtual "
        f"{s['virtual_time_s']:.3f} s; wall {wall:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    say_graphs(label, card, orch.decode_units())
    say(f"[{label}] serving-path launches: {json.dumps(launches)}")
    return launches, s, out, orch


def tenant_drive(torch, label, preemption, log, clone_b2):
    """(d)/(e): requests 0-3 are bronze, at t = 0, 4-7 gold, submitted
    once all four bronze ones are decode-resident."""
    def drive(orch, srv, reqs):
        time_preemption(torch, orch, log)
        count_clone_waves(orch, clone_b2)
        for i, r in enumerate(reqs):
            r.tenant = TENANTS[i >= 4]
            if i < 4:
                srv.submit(r, at=0.0)
        run_until(orch, srv, lambda: sum(
            u.active for u in orch.decode_units()) == 4,
            "all four bronze requests decode-resident")
        t_gold = orch.clock.now
        for r in reqs[4:]:
            srv.submit(r)
        return t_gold
    return drive


def preemption_run(torch, card, cfg, params, plain_streams, *, label,
                   preemption):
    from repro_torch.serving.fairshare import SchedulerConfig, TenantPolicy

    log, clone_b2 = [], {"waves": 0, "b2": 0}
    sched = SchedulerConfig(preemption=preemption, tenants={
        "bronze": TenantPolicy(priority=0),
        "gold": TenantPolicy(weight=4, priority=1)})
    launches, s, t_gold, orch = frontdoor_run(
        torch, card, cfg, params, plain_streams, label=label,
        drive=tenant_drive(torch, label, preemption, log, clone_b2),
        n_decode=1, max_batch=4, scheduler=sched)
    n = s[f"n_preempted_{preemption}"]
    if n < 1:
        fail(f"[{label}] no request was preempted")
    if preemption == "swap":
        if s["pages_swapped"] <= 0 or s["swap_io_s"] <= 0:
            fail(f"[{label}] pages_swapped {s['pages_swapped']}, swap_io_s "
                 f"{s['swap_io_s']}")
        for kind, rid, ms, nb in log:
            say(f"[{label}] {kind} of request(s) {rid}: {ms:.2f} ms host "
                f"wall clock (synchronised), {nb} bytes ({nb / 2**20:.1f} "
                f"MiB) [{card}]")
        say(f"[{label}] {n} swapped, {s['pages_swapped']} pages; billed "
            f"swap_io_s {s['swap_io_s'] * 1e3:.3f} ms both ways at the "
            f"store's host tier")
    else:
        if clone_b2["b2"] <= 0:
            fail(f"[{label}] the clones' re-prefills launched no B2")
        say(f"[{label}] {n} sacrificed; the clones' re-prefills ran "
            f"{clone_b2['waves']} waves with {clone_b2['b2']} B2 launches")
    say(f"[{label}] gold submitted at virtual {t_gold:.4f} s; per tenant: "
        + "; ".join(f"{t}: {v['n_requests']} done, mean ttft "
                    f"{v['mean_ttft_s'] * 1e3:.2f} ms, preempted swap "
                    f"{v.get('n_preempted_swap', 0)} / sacrifice "
                    f"{v.get('n_preempted_sacrifice', 0)}"
                    for t, v in sorted(s["tenants"].items())))
    del orch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def autoscale_run(torch, card, cfg, params, plain_streams):
    """(f): a decode member forced up on the H100 profile at the start;
    requests 0-3 at t = 0, 4-7 at its warm-up's end; a forced drain of
    one decode member once a decode unit is active after that."""
    from repro_torch.core import analytical as A
    from repro_torch.serving.autoscale import AutoscaleConfig

    label = "autoscale-f"
    got = {}

    def drive(orch, srv, reqs):
        got["name"] = name = orch._scale_up("decode", A.H100_SXM)
        m = orch._by_name[name]
        got["member"], got["t_warm"] = m, m.warming_until
        adopt, got["adopts"] = m.decode.adopt, []

        def logged_adopt(*a, **kw):
            got["adopts"].append(orch.clock.now)
            return adopt(*a, **kw)

        m.decode.adopt = logged_adopt
        for i, r in enumerate(reqs):
            srv.submit(r, at=0.0 if i < 4 else m.warming_until)
        run_until(orch, srv, lambda: orch.clock.now >= m.warming_until
                  and any(u.active for u in orch.decode_units()),
                  "a decode unit active after the warm-up")
        _, got["drain_ms"] = synced_ms(torch, orch._scale_down, "decode")
        got["t_drain"] = orch.clock.now
        return got

    launches, s, got, orch = frontdoor_run(
        torch, card, cfg, params, plain_streams, label=label, drive=drive,
        n_decode=2, max_batch=8, autoscaler=AutoscaleConfig(
            max_prefill=2, max_decode=3, profiles=(A.H100_SXM,)))
    m, t_warm = got["member"], got["t_warm"]
    early = [t for t in got["adopts"] if t < t_warm]
    if early or not got["adopts"]:
        fail(f"[{label}] {m.name} took hand-offs at {got['adopts']}; its "
             f"warm-up ends at {t_warm}")
    check_views(torch, label, params, [m.decode])
    if s["n_retired"] < 1:
        fail(f"[{label}] the drained member did not retire")
    rep = m.decode.compiled.report()
    warm = A.instance_warmup_time(cfg, A.H100_SXM)
    say(f"[{label}] {m.name} warming until virtual {t_warm:.3f} s "
        f"(A.instance_warmup_time: {warm:.3f} s), {len(got['adopts'])} "
        f"hand-offs, the first at "
        f"{got['adopts'][0]:.3f} s; {rep['graphs_captured']} graphs "
        f"captured in {rep['capture_s'] * 1e3:.1f} ms; drain forced at "
        f"{got['t_drain']:.3f} s in {got['drain_ms']:.2f} ms host wall "
        f"clock, retired {[r.name for r in orch.retired]} [{card}]")
    say(f"[{label}] fleet timeline: " + ", ".join(
        f"{t:.3f} s {c}" for t, c in orch.metrics.fleet_timeline))
    say(f"[{label}] policy decisions: " + (", ".join(
        f"{t:.3f} s {d}" for t, d in orch.autoscaler.decisions) or "none")
        + f"; instance_seconds {s.get('instance_seconds', 0.0):.3f}")
    del orch, m, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def frontdoor_phase(torch, card, cfg, params, plain_streams):
    """(d) fair share with swap preemption, (e) the same with sacrifice,
    (f) autoscaling, on the served runs' weights and requests.  Returns
    {run: launches}."""
    t0 = time.perf_counter()
    out = {}
    for label, mode in (("fairshare-d", "swap"), ("fairshare-e",
                                                  "sacrifice")):
        out[label] = preemption_run(torch, card, cfg, params, plain_streams,
                                    label=label, preemption=mode)
    out["autoscale-f"] = autoscale_run(torch, card, cfg, params,
                                       plain_streams)
    say(f"front-door phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


CLI_RUNS = [
    ["--backend", "live", "--arch", "llama-13b", "--requests", "8",
     "--max-new", "16", "--max-len", "1024", "--autoscale", "--profiles",
     "h100_sxm"],
    ["--backend", "sim", "--smoke"],
]


def cli_phase(card) -> None:
    """(g): the serving CLI as subprocesses (each initialises its own
    weights); each must exit 0 with every request completed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for argv in CLI_RUNS:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            *argv], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        what = " ".join(argv)
        if p.returncode != 0:
            fail(f"[cli] {what} exited {p.returncode}: {p.stderr[-2000:]}")
        done = re.findall(r"^== (\d+) completed / \d+ rejected / \d+ "
                          r"aborted of (\d+) submitted$", p.stdout, re.M)
        if not done or done[-1][0] != done[-1][1] or done[-1][0] == "0":
            fail(f"[cli] {what}: not every request completed: {done}")
        tail = [ln for ln in p.stdout.splitlines()[-5:] if ln.strip()]
        say(f"[cli] {what}: exit 0 in {wall:.1f} s; " + " | ".join(tail)
            + f" [{card}]")


EXAMPLE_RUNS = [[], ["--speculation", "ngram"]]
EXAMPLE_OK = ("streamed outputs (incl. the mid-run submission) "
              "token-identical to the single-engine reference")


def examples_phase(card) -> None:
    """(v): ``examples/torch_serve_disaggregated.py`` as subprocesses,
    plain and with n-gram speculation (gemma-7b's smoke size in f32, 3
    prefill / 1 decode members, a migration, a mid-run submission); each
    must exit 0 after its own token-for-token check against a
    single-engine rollout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = ROOT / "examples" / "torch_serve_disaggregated.py"
    for argv in EXAMPLE_RUNS:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(script), *argv], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        what = " ".join(["torch_serve_disaggregated.py", *argv])
        if p.returncode != 0:
            fail(f"[example] {what} exited {p.returncode}: "
                 f"{p.stderr[-2000:]}")
        if EXAMPLE_OK not in p.stdout:
            fail(f"[example] {what}: no token-for-token check in its "
                 f"output: {p.stdout[-1000:]}")
        keep = [ln for ln in p.stdout.splitlines()
                if ln.startswith(("arch=", "served ", "TTFT", "speculation="))]
        say(f"[example] {what}: exit 0 in {wall:.1f} s; "
            + " | ".join(keep) + f"; {EXAMPLE_OK} [{card}]")


def orchestrator_run(torch, card, cfg, params, plain_streams):
    """(v): ``Orchestrator.run`` (the batch drive: each request submitted
    at its arrival, then drained) on the plain run's configuration and
    the same 8 requests; its streams must equal the ``Server`` run's bit
    for bit, and B1, B2 and B3 launch.  Returns its launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)

    ecfg = EngineConfig(max_len=1024, max_batch=8, block_size=16,
                        speculation="off", spec_len=4)
    orch = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ecfg, chunk_tokens=256))
    reqs = served_requests(cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    summary = orch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    streams = {r.rid: list(r.generated) for r in reqs}
    if streams != plain_streams:
        diff = [rid for rid in streams if streams[rid] != plain_streams[rid]]
        fail(f"[orchestrator-run] streams differ from the Server run's for "
             f"requests {diff}")
    missing = [k for k in ("paged_decode_partials", "flash_prefill",
                           "paged_prefix_partials") if not launches[k]]
    if missing:
        fail(f"[orchestrator-run] kernels {missing} never launched")
    check_pools_restored(orch)
    say(f"[orchestrator-run] Orchestrator.run: {summary['n_requests']} "
        f"requests, {sum(len(v) for v in streams.values())} tokens in "
        f"{wall:.2f} s wall, {summary['events']} events; streams equal to "
        f"the Server run's 8/8 bit for bit; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})} [{card}]")
    del orch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# (w): context-parallel decode attention at llama-13b's heads, one row of
# 32,768 keys; the pipeline's decode steps and cache
SHARDED_KEYS = 32768
PIPE_ROWS, PIPE_PROMPT, PIPE_CACHE, PIPE_STEPS = 8, 256, 1024, 8


def multidevice_phase(torch, card, cfg, params):
    """(w): the multi-device runtime on a one-rank NCCL group and a 1 x 1
    mesh at full width.  ``sharded_decode_attention`` at llama-13b's 40
    heads of 128 over one row of 32,768 bf16 keys (B5, then the gather)
    against its plain version (``partial_attention`` and the combine on
    the card) within TOL_SHARDED, timed beside its bound; granite-moe-3b-a800m's
    ``moe_apply(impl="local_sorted")`` on one shard (one layer's experts
    at full width, f32) equal to ``sorted`` bit for bit, with and without
    a capacity factor; ``build_pipeline_decode`` on llama-13b (40 layers,
    one stage, 8 rows prefilled with 256 tokens into a 1,024-slot dense
    cache), every decoded token within TOKEN_GAP_TOL of ``T.decode_step``'s
    best on the same tokens, B5 counted.  Returns {run label:
    launches}."""
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.core import attention_offload as AO
    from repro_torch.kernels import ops
    from repro_torch.kernels.split_kv_decode import split_kv_decode_partials
    from repro_torch.launch import mesh as M
    from repro_torch.launch.pipeline_decode import build_pipeline_decode
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    launches = {}
    M.init_process_group("cuda")
    try:
        mesh = M.make_host_mesh()
        say(f"[multi] one-rank {dist.get_backend()} group, mesh "
            f"{M.axis_sizes(mesh)} [{card}]")
        # -- sharded decode attention
        gen = torch.Generator(device="cuda").manual_seed(25)
        h, d = cfg.n_heads, cfg.head_dim
        q = torch.randn((1, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((1, SHARDED_KEYS, h, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        valid = torch.ones((1, SHARDED_KEYS), dtype=torch.bool,
                           device="cuda")

        def plain():
            return AO.combine_partials(
                *[[x] for x in AO.partial_attention(q, k, v, valid)]
            ).to(q.dtype)

        ops.reset_launches()
        got = AO.sharded_decode_attention(mesh, q, k, v, valid)
        torch.cuda.synchronize()
        launches["(w) sharded attention"] = dict(ops.LAUNCHES)
        if ops.LAUNCHES["split_kv_decode_partials"] != 1:
            fail(f"[multi] sharded attention launched B5 "
                 f"{ops.LAUNCHES['split_kv_decode_partials']} times, not 1")
        err = check_close(torch, "[multi] sharded_decode_attention", got,
                          plain(), TOL_SHARDED)

        def sharded():
            return AO.sharded_decode_attention(mesh, q, k, v, valid)

        moved = nbytes(q, k, v, valid, got)
        bound = 1e3 * max(moved / HBM_BYTES_PER_S,
                          4 * h * d * SHARDED_KEYS / PEAK_FLOPS["bfloat16"])
        # one timer, profile_ms, each reading held to the bound; B5's
        # share of the call and the rest (block merge, all_gather,
        # combine) are read off the call's own trace
        ms, per = profile_ms(torch, sharded, 20, bound_ms=bound)
        b5_in_call = sum(t for key, t in per.items()
                         if "split_decode_kernel" in key)
        # no trace kept (profile_ms timed the call by CUDA events): the
        # launch count above shows B5 ran, its share is not measured
        if per and not b5_in_call:
            fail(f"[multi] no B5 kernel in the sharded call's trace: "
                 f"{sorted(per)}")
        share = (f"B5 {b5_in_call:.4f} ms and the merge, all_gather and "
                 f"combine {ms - b5_in_call:.4f} ms of it, {len(per)} "
                 f"kernels" if per else
                 "B5's share not measured: no trace held device time, "
                 "the call timed by CUDA events")
        b5_ms = time_ms(torch, lambda: split_kv_decode_partials(
            q, k, v, valid), 20, bound_ms=bound)
        plain_ms = time_ms(torch, plain, 5, bound_ms=bound)
        sdpa_ms = time_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              q[:, :, None], k.transpose(1, 2),
                              v.transpose(1, 2)), 20, bound_ms=bound)
        say(f"[multi] sharded_decode_attention (1 x {SHARDED_KEYS} keys, "
            f"{h} heads of {d}, bf16, {moved / 1e6:.1f} MB): "
            f"{ms:.4f} ms of device time per call ({share}); B5 alone "
            f"{b5_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {sdpa_ms:.4f} "
            f"ms, each by torch.profiler or, where no trace held device "
            f"time, CUDA events; bound {bound:.4f} ms (bytes); max "
            f"|got - plain| {err:.3e} (tolerance {TOL_SHARDED}); B5 "
            f"launches 1 [{card}]")
        del q, k, v, valid, got
        torch.cuda.empty_cache()

        # -- per-shard MoE dispatch
        mcfg = get("granite-moe-3b-a800m")
        mgen = torch.Generator(device="cuda").manual_seed(26)
        p = L.init_moe(mcfg, mgen, torch.float32, torch.device("cuda"))
        x = torch.randn((4, 512, mcfg.d_model), generator=mgen,
                        device="cuda")
        for cf in (None, 1.25):
            want = L.moe_apply(mcfg, p, x, impl="sorted", capacity_factor=cf)
            ops.reset_launches()
            got = L.moe_apply(mcfg, p, x, impl="local_sorted",
                              capacity_factor=cf, mesh=mesh)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"[multi] local_sorted (cf {cf}) differs from sorted")
            say(f"[multi] granite-moe-3b-a800m moe_apply(local_sorted, cf "
                f"{cf}) on one shard of 4 x 512 tokens: y and router_load "
                f"equal to sorted bit for bit (load max "
                f"{float(got[1].max()):.4f}) [{card}]")
        del p, x, got, want
        torch.cuda.empty_cache()

        # -- pipeline decode
        fn, per_stage, n_pad = build_pipeline_decode(cfg, mesh, PIPE_ROWS)
        if (per_stage, n_pad) != (cfg.n_layers, 0):
            fail(f"[multi] one stage: (per_stage, n_pad) = "
                 f"{(per_stage, n_pad)}")
        pgen = torch.Generator(device="cuda").manual_seed(27)
        toks = torch.randint(0, cfg.vocab_size, (PIPE_ROWS, PIPE_PROMPT),
                             generator=pgen, device="cuda", dtype=torch.int32)
        cache = T.init_cache(cfg, PIPE_ROWS, PIPE_CACHE, dtype=torch.bfloat16)
        lg, cache, _ = T.prefill(cfg, params, toks, cache)
        ref_cache = {"lengths": cache["lengths"].clone(),
                     "groups": tuple({k: a.clone() for k, a in g.items()}
                                     for g in cache["groups"]),
                     "rem": ()}
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        pipe_launch = {k: 0 for k in ops.LAUNCHES}
        worst, pipe_s, ref_s = 0.0, 0.0, 0.0
        for _ in range(PIPE_STEPS):
            torch.cuda.synchronize()
            ops.reset_launches()
            t = time.perf_counter()
            lg_p, cache = fn(params, tok, cache)
            torch.cuda.synchronize()
            pipe_s += time.perf_counter() - t
            for k_, n in ops.LAUNCHES.items():
                pipe_launch[k_] += n
            t = time.perf_counter()
            lg_r, ref_cache, _ = T.decode_step(cfg, params, tok, ref_cache)
            torch.cuda.synchronize()
            ref_s += time.perf_counter() - t
            tok = lg_p.argmax(-1).to(torch.int32)[:, None]
            lg_r = lg_r.float()
            gap = (lg_r.max(-1).values - lg_r.gather(
                1, tok.long()).squeeze(1)).max()
            worst = max(worst, float(gap))
        launches["(w) pipeline decode"] = pipe_launch
        if worst > TOKEN_GAP_TOL:
            fail(f"[multi] pipeline decode: a token {worst:.4f} below "
                 f"T.decode_step's best (tolerance {TOKEN_GAP_TOL})")
        want_b5 = PIPE_STEPS * cfg.n_layers
        if pipe_launch["split_kv_decode_partials"] != want_b5:
            fail(f"[multi] pipeline decode launched B5 "
                 f"{pipe_launch['split_kv_decode_partials']} times, not "
                 f"{want_b5}")
        say(f"[multi] build_pipeline_decode: llama-13b, 1 stage of "
            f"{per_stage} layers, {PIPE_ROWS} rows after a {PIPE_PROMPT}-"
            f"token prefill into a {PIPE_CACHE}-slot dense cache, "
            f"{PIPE_STEPS} steps: {pipe_s / PIPE_STEPS * 1e3:.1f} ms per "
            f"step (T.decode_step {ref_s / PIPE_STEPS * 1e3:.1f} ms); every "
            f"token within {worst:.4f} of T.decode_step's best (tolerance "
            f"{TOKEN_GAP_TOL}); B5 launches {want_b5} [{card}]")
        del cache, ref_cache
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"multi-device runtime (w): {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# (x) Shared pages across span stages; the dry run's tables on the host and
# its one-rank figures against the card
# ---------------------------------------------------------------------------

SHARED_BOUNDS = [(0, 20), (20, 40)]
SHARED_STEPS = 8           # decode iterations before the live span move
SHARED_MOVE = 4            # layers the move shifts from stage 0 to stage 1
DRYRUN_HOST = (("llama3-405b", "decode_32k"),
               ("granite-moe-3b-a800m", "train_4k"))
# the one-rank check: llama-13b at full size in bf16 on a 1 x 1 mesh
ONE_RANK_SHAPES = (("decode_4k", 4096, 8, "decode"),
                   ("prefill_4k", 4096, 1, "prefill"))
ONE_RANK_KERNEL = {"decode": "split_kv_decode_partials",
                   "prefill": "flash_prefill"}
RESIDENT_TOL_REL = 0.01
ONE_RANK_ITERS = 5


def shared_span_run(torch, card, cfg, params):
    """(x1): a 2-stage ``DecodePipeline`` over SHARED_BOUNDS; two requests
    with the same served prompt, the second bound to the first's full
    prompt pages on both stages (``slot_pages`` into ``shared_pages``),
    SHARED_STEPS iterations, a live SHARED_MOVE-layer ``move_span``, then
    decoded to the end: both streams pass ``check_streams``, every stage's
    pool is whole again, B1 and B2 launch.  Returns the run's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import kvcache as KC
    from repro_torch.serving.engine import EngineConfig, PrefillEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.span import DecodePipeline

    label = "x-shared"
    ecfg = EngineConfig(max_len=1024, max_batch=8, block_size=16)
    prompt = max(served_requests(cfg), key=lambda r: r.prompt_len).prompt
    reqs = [Request(rid=i, arrival=0.0, prompt=prompt.copy(),
                    max_new_tokens=32) for i in range(2)]
    pe = PrefillEngine(cfg, params, ecfg)
    dp = DecodePipeline(cfg, params, ecfg, SHARED_BOUNDS)
    n_share = (reqs[0].prompt_len - 1) // ecfg.block_size   # own page kept
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    st, lg = pe.run(reqs[0])
    s0 = dp.insert(reqs[0], st, int(torch.argmax(lg)))
    pages = dp.slot_pages(s0)[:n_share]
    st, lg = pe.run(reqs[1])
    s1 = dp.insert(reqs[1], KC.split_paged_state(st, n_share,
                                                 ecfg.block_size),
                   int(torch.argmax(lg)), shared_pages=pages)
    del st, lg
    shared = [e.pages_shared for e in dp.engines]
    if shared != [n_share] * len(SHARED_BOUNDS) or \
            dp.slot_pages(s1)[:n_share] != pages:
        fail(f"[{label}] pages shared per stage {shared}, want {n_share} "
             f"each, bound by reference")
    for _ in range(SHARED_STEPS):
        dp.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    moved = dp.move_span(0, 1, SHARED_MOVE)
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - t1) * 1e3
    want_bounds = [(0, 20 - SHARED_MOVE), (20 - SHARED_MOVE, 40)]
    if moved is None or moved["layers"] != SHARED_MOVE or \
            [tuple(b) for b in dp.bounds] != want_bounds:
        fail(f"[{label}] span move gave {moved and moved['layers']} layers, "
             f"bounds {dp.bounds}")
    while dp.active:
        dp.step()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for e in dp.engines:
        try:
            e.pool.check(holders=[])
        except AssertionError as exc:
            fail(f"[{label}] {e.name}: pool invariant after the move: {exc}")
        if e.active or len(e._free) != ecfg.max_batch * e._nb_slot:
            fail(f"[{label}] {e.name}: pool not restored")
    check_streams(torch, cfg, params, label, reqs, launches,
                  ("paged_decode_partials", "flash_prefill"),
                  ("paged_verify_partials",))
    same = reqs[0].generated == reqs[1].generated
    say(f"[{label}] DecodePipeline {SHARED_BOUNDS}: 2 requests of one "
        f"{reqs[0].prompt_len}-token prompt, the second bound to the "
        f"first's {n_share} full pages on every stage (pages_shared per "
        f"stage {shared}); after {SHARED_STEPS} iterations a live "
        f"{SHARED_MOVE}-layer span move to {dp.bounds} in {move_ms:.1f} ms "
        f"({moved['kv_bytes'] / 2**20:.1f} MiB of KV re-adopted unshared); "
        f"every stage's pool restored; the two streams "
        f"{'equal' if same else 'differ'}; {run_s:.2f} s; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})} [{card}]")
    del pe, dp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dryrun_host_run(torch, card) -> None:
    """(x2): ``dryrun.run_one`` on this machine's torch for DRYRUN_HOST on
    the 16 x 16 mesh of 256 fake ranks (host only, no card), each
    roofline printed.  Fails unless every combination is OK."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as DR

    try:
        for arch, shape in DRYRUN_HOST:
            rec = DR.run_one(arch, shape, "single",
                             out_dir=str(ROOT / "build" / "dryrun"),
                             verbose=False)
            if not rec["ok"]:
                fail(f"[x-dryrun] {arch} {shape}: {rec['error']}")
            ro = rec["roofline"]
            say(f"[x-dryrun] {arch} {shape} on 16 x 16 fake ranks (torch "
                f"{torch.__version__}, host only): flops/chip "
                f"{rec['flops']:.4g}, collective bytes/chip "
                f"{rec['collective_bytes']:.4g} "
                f"{json.dumps(rec['collective_counts'])}, resident "
                f"{rec['resident_bytes_per_chip'] / 2**30:.2f} GiB, peak "
                f"{rec['peak_bytes_per_chip'] / 2**30:.2f} GiB, fits_hbm "
                f"{rec['fits_hbm']}; roofline on the H100's rates: compute "
                f"{ro['t_compute_s'] * 1e3:.3f} ms, memory "
                f"{ro['t_memory_s'] * 1e3:.3f} ms, collective "
                f"{ro['t_collective_s'] * 1e3:.3f} ms ({ro['bottleneck']}), "
                f"useful flop ratio {ro['useful_flop_ratio']:.3f}; "
                f"{rec['run_s']:.1f} s on the host")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def one_rank_check(torch, card):
    """(x3): the dry run's one-rank figures against the card.  llama-13b
    at full size in bf16; ONE_RANK_SHAPES (a decode step of 8 rows over a
    4,096-slot dense cache: B5 on every layer; a fresh prefill of 1 x
    4,096 tokens: B2).  The dry run first, on a one-rank fake group (meta
    shards); then the same ``steps.build`` step on values over a one-rank
    NCCL group and a 1 x 1 mesh.  Fails unless the dry run's resident
    bytes are within RESIDENT_TOL_REL of the ``memory_allocated`` delta,
    its flops equal ``FlopCounterMode``'s on the real step, the step
    launched its kernel on every layer, and the plain serving step (the
    same tensors, CUDA events over ONE_RANK_ITERS calls) is not under the
    roofline's largest term.  Prints the peaks side by side and the
    measured-to-bound ratio.  Returns {run label: launches}."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import cost_analysis as C
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.training.tree import named_leaves

    cfg = get("llama-13b")
    shapes = [S.ShapeSpec(*a) for a in ONE_RANK_SHAPES]
    t0 = time.perf_counter()
    DR.fake_group(1)
    try:
        host = M.make_host_mesh()
        dry = {sh.name: DR.figures(cfg, sh, host)[0] for sh in shapes}
        bytes_model = {sh.name: DR.analytical_bytes_per_chip(cfg, sh, 1,
                                                             host)
                       for sh in shapes}
    finally:
        dist.destroy_process_group()
    dry_s = time.perf_counter() - t0
    launches = {}
    M.init_process_group("cuda")
    try:
        mesh = M.make_host_mesh()
        gc.collect()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        params = T.init(cfg, seed=0, dtype=torch.bfloat16)
        pvals = dict(named_leaves(params))
        gen = torch.Generator(device="cuda").manual_seed(26)
        for sh in shapes:
            label = f"x-one-rank-{sh.kind}"
            b, s = sh.global_batch, sh.seq_len
            cache = T.init_cache(cfg, b, s, dtype=torch.bfloat16)
            toks = torch.randint(0, cfg.vocab_size,
                                 (b, 1 if sh.kind == "decode" else s),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            vals = {**pvals, **dict(named_leaves(cache)), "": toks}
            st = steps.build(cfg, sh, mesh, torch.bfloat16,
                             materialize=lambda n, leaf: vals[n])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            with torch.no_grad(), implicit_replication(), C.EvenViews(), \
                    FlopCounterMode(display=False) as fc:
                out = st.fn(*st.args)
            torch.cuda.synchronize()
            launches[label] = dict(ops.LAUNCHES)
            resident = torch.cuda.memory_allocated() - m0
            peak = torch.cuda.max_memory_allocated() - m0
            del out, st
            fig = dry[sh.name]
            kernel = ONE_RANK_KERNEL[sh.kind]
            if launches[label][kernel] != cfg.n_layers:
                fail(f"[{label}] {kernel} launched "
                     f"{launches[label][kernel]} times, not {cfg.n_layers}")
            err = abs(resident - fig.resident_bytes) / fig.resident_bytes
            if err > RESIDENT_TOL_REL:
                fail(f"[{label}] dry-run resident {fig.resident_bytes:.6g} B "
                     f"against the allocation's {resident:.6g} B: off by "
                     f"{err:.4f} (tolerance {RESIDENT_TOL_REL})")
            if fc.get_total_flops() != fig.flops:
                fail(f"[{label}] dry-run flops {fig.flops:.6g} against "
                     f"FlopCounterMode's {fc.get_total_flops():.6g}")
            roof = C.Roofline("llama-13b", sh.name, "1x1", 1, fig.flops,
                              bytes_model[sh.name],
                              sum(fig.collective_bytes.values()),
                              DR.model_flops(cfg, sh), fig.peak_bytes)
            bound_ms = 1e3 * max(roof.t_compute, roof.t_memory,
                                 roof.t_collective)

            def step():
                with torch.no_grad():
                    return T.apply(cfg, params, toks, cache=cache,
                                   mode=sh.kind, logits_slice="last")[0]
            step()
            ms = time_events(torch, step, ONE_RANK_ITERS)
            if ms < bound_ms:
                fail(f"[{label}] step {ms:.3f} ms under the roofline's "
                     f"{bound_ms:.3f} ms")
            say(f"[{label}] llama-13b bf16, {b} x {s} "
                f"({'one token over a dense cache' if sh.kind == 'decode' else 'fresh prefill'}), "
                f"1 x 1 mesh on a one-rank {dist.get_backend()} group: "
                f"resident {resident / 2**30:.3f} GiB allocated vs the dry "
                f"run's {fig.resident_bytes / 2**30:.3f} GiB (off {err:.5f}); "
                f"flops {fig.flops:.6g} = FlopCounterMode's; {kernel} "
                f"{launches[label][kernel]} launches; peak "
                f"{peak / 2**30:.3f} GiB allocated vs the dry run's "
                f"{fig.peak_bytes / 2**30:.3f} GiB; serving step "
                f"{ms:.3f} ms (CUDA events, {ONE_RANK_ITERS} calls) vs the "
                f"roofline's {bound_ms:.3f} ms ({roof.bottleneck}; compute "
                f"{roof.t_compute * 1e3:.3f}, memory "
                f"{roof.t_memory * 1e3:.3f} ms): {ms / bound_ms:.3f}x the "
                f"bound [{card}]")
            del cache, toks, vals
            gc.collect()
        del params, pvals
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"one-rank check (x3): {time.perf_counter() - t0:.1f} s, the dry "
        f"runs {dry_s:.1f} s of it")
    return launches


# cycles the card spins before a queued timing (~25 ms at the H100's
# clocks): longer than the host takes to enqueue every timed call
QUEUE_SLEEP_CYCLES = 50_000_000


def queued_ms(torch, fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls queued behind a
    spin kernel: the host enqueues every call while the card spins, so
    CUDA events around them read the calls back to back, without the
    host's launch gaps, and without a profiler trace or a graph capture
    (each trace and capture the kernel phase adds brings the profiler's
    loss of kernel events closer; PERF.md section 6)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    return time_events(torch, fn, iters)


def time_events(torch, fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dryrun_phase(torch, card):
    """(x2) and (x3), after the serving phase has freed its weights.
    Returns {run label: launches}."""
    t0 = time.perf_counter()
    dryrun_host_run(torch, card)
    launches = one_rank_check(torch, card)
    say(f"dry-run phase (x2, x3): {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# MoE stacks: granite-moe-3b-a800m at full size, grok-1-314b at 2 layers
# ---------------------------------------------------------------------------

# the port's attention kernels, by their CUDA symbols
ATTENTION_SYMBOLS = ("paged_decode_kernel", "paged_verify", "flash_kernel",
                     "prefix_kernel")
MOE_FAMILIES = ("expert GEMMs", "MoE's other ops (router, sort, gathers, "
                "activation, combine)", "attention kernels", "the rest")


class RouterLoad:
    """While active, keeps ``aux["router_load"]`` of the first prefill
    forward (one served wave) and the shape of its tokens; the load stays
    on the card until ``say`` reads it, after the run's clocks."""

    def __init__(self, torch):
        from repro_torch.models import transformer as T
        self.T, self.wave = T, None

    def __enter__(self):
        orig = self.orig = self.T.apply

        def apply(cfg, params, tokens, **kw):
            out = orig(cfg, params, tokens, **kw)
            if kw.get("mode") == "prefill" and self.wave is None:
                self.wave = (tuple(tokens.shape[:2]), out[2]["router_load"])
            return out

        self.T.apply = apply
        return self

    def __exit__(self, *exc):
        self.T.apply = self.orig

    def say(self, label, card) -> None:
        if self.wave is None:
            fail(f"[{label}] no prefill wave reported a router load")
        (rows, n), load = self.wave
        load = load.float().cpu()
        e = load.numel()
        if abs(float(load.sum()) - 1.0) > 1e-4:
            fail(f"[{label}] router load sums to {float(load.sum())}")
        say(f"[{label}] router_load of the first served wave ({rows} rows x "
            f"{n} tokens, mean over the layers): largest share "
            f"{float(load.max()):.4f} (expert {int(load.argmax())}), smallest "
            f"{float(load.min()):.4f} (expert {int(load.argmin())}); even "
            f"share {1 / e:.4f}, largest x E = {float(load.max()) * e:.2f} "
            f"[{card}]")


# the layer functions ``FnRanges`` may wrap in a profiler range
RANGED = ("moe_apply", "rglru_apply", "mlstm_apply", "slstm_apply")


class FnRanges:
    """While active, each call of ``models.layers.<fname>`` made under the
    profiler runs inside a ``record_function(fname)`` range, so an eager
    profile can tell that function's kernels from the rest; with the
    profiler off the call goes straight through."""

    def __init__(self, torch, fname):
        from repro_torch.models import layers as L
        assert fname in RANGED
        self.torch, self.L, self.fname = torch, L, fname

    def __enter__(self):
        orig = self.orig = getattr(self.L, self.fname)
        rf = self.torch.profiler.record_function
        profiling = self.torch.autograd._profiler_enabled
        fname = self.fname

        def ranged(*a, **kw):
            if not profiling():
                return orig(*a, **kw)
            with rf(fname):
                return orig(*a, **kw)

        setattr(self.L, fname, ranged)
        return self

    def __exit__(self, *exc):
        setattr(self.L, self.fname, self.orig)


def _inside(op, fname) -> bool:
    while op is not None:
        if op.name == fname:
            return True
        op = getattr(op, "cpu_parent", None)
    return False


def kernel_family(name: str, op) -> str:
    """The MoE family of a kernel ``name`` launched by profiler event
    ``op``."""
    if any(sym in name for sym in ATTENTION_SYMBOLS):
        return "attention kernels"
    if not _inside(op, "moe_apply"):
        return "the rest"
    return MOE_FAMILIES[0] if op.name == "aten::bmm" else MOE_FAMILIES[1]


HYBRID_FAMILIES = ("GEMMs", "the RG-LRU's elementwise work", "B1",
                   "the rest")
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")
GEMM_SYMBOLS = ("gemm", "nvjet", "xmma", "cutlass")


def hybrid_family(name: str, op) -> str:
    """The hybrid family of a kernel ``name`` launched by profiler event
    ``op`` (None: by its name alone): B1, a GEMM (any matrix product, the
    RG-LRU's own included), the RG-LRU's other (elementwise) kernels, or
    the rest."""
    if "paged_decode_kernel" in name:
        return "B1"
    if op is None:
        return ("GEMMs" if any(t in name.lower() for t in GEMM_SYMBOLS)
                else "the rest")
    if op.name in GEMM_OPS:
        return "GEMMs"
    return HYBRID_FAMILIES[1] if _inside(op, "rglru_apply") else "the rest"


def eager_families(prof, classify):
    """{kernel name: {family: device us}} of an eager profile, each kernel
    by the op that launched it (``FnRanges`` on)."""
    out = {}
    for e in prof.events():
        for k in getattr(e, "kernels", None) or ():
            fam = classify(k.name, e)
            d = out.setdefault(k.name, {})
            d[fam] = d.get(fam, 0.0) + k.duration
    return out


def say_families(label, card, replayed, eager, families=MOE_FAMILIES,
                 classify=kernel_family) -> None:
    """Device ms by family of one profiled decode iteration: the eager
    one exactly (each kernel by its launching op), the replayed one with
    each kernel name split as its launches split in the eager iteration
    (a graph replays the same kernels; its launches have no op)."""
    if replayed is None or eager is None:
        fail(f"[{label}] no profiled decode iteration")
    fams = eager_families(eager, classify)
    for name, prof in (("eager", eager), ("replayed", replayed)):
        kern = device_kernels(prof.key_averages())
        busy = sum(device_us(e) for e in kern) / 1e3
        if busy <= 0 or not fams:
            say(f"[{label}] decode iteration by family ({name}): not "
                f"measured (the profiler recorded no device time or no "
                f"kernel-to-op links)")
            continue
        ms = dict.fromkeys(families, 0.0)
        unseen = 0.0
        for e in kern:
            split = fams.get(e.key)
            us = device_us(e)
            if not split:
                fam = classify(e.key, None)
                ms[fam] += us / 1e3
                unseen += us / 1e3
                continue
            tot = sum(split.values())
            for fam, v in split.items():
                ms[fam] += us * v / tot / 1e3
        say(f"[{label}] decode iteration {PROFILE_ITER} ({name}) device ms "
            f"by family: " + "; ".join(
                f"{k} {v:.3f} ms ({v / busy:.0%})" for k, v in ms.items())
            + f"; busy {busy:.3f} ms in {sum(e.count for e in kern)} "
            f"kernels ({unseen:.3f} ms of them with no launching op in the "
            f"eager iteration, by name only) [{card}]")


def describe(cfg) -> str:
    return (f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
            f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
            f"{cfg.activation.value}, vocab {cfg.vocab_size}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'}; "
            f"{cfg.param_count() / 1e9:.2f} B parameters)")


def say_precision_probe(torch, card, cfg, params, prompt) -> None:
    """Why the MoE stacks are scored in f32: the same stateless forward
    over ``prompt`` and over its first ``n - 64`` tokens (the same
    positions, other GEMM shapes), in f32 and with every weight but the
    router cast to bf16.  Prints the largest logit difference between
    the two lengths in each dtype and between the dtypes, beside the
    logits' spread."""
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import cast_params

    toks = torch.as_tensor([int(t) for t in prompt], device="cuda")[None]
    n = toks.shape[1] - 64
    got = {}
    for name, p in (("f32", params),
                    ("bf16", cast_params(params, torch.bfloat16))):
        full, _, _ = T.apply(cfg, p, toks, mode="train")
        head, _, _ = T.apply(cfg, p, toks[:, :n], mode="train")
        got[name] = (full[0, :n].float(), head[0].float())
        del p, full, head
    diff = {k: float((a - b).abs().max()) for k, (a, b) in got.items()}
    cross = float((got["bf16"][1] - got["f32"][1]).abs().max())
    say(f"[{cfg.name} precision] the same forward over {toks.shape[1]} and "
        f"its first {n} tokens: largest logit difference f32 "
        f"{diff['f32']:.3g}, bf16 {diff['bf16']:.3g}; bf16 vs f32 "
        f"{cross:.3g}; logit std {float(got['f32'][1].std()):.3f} (the "
        f"teacher-forced rule allows {TOKEN_GAP_TOL}) [{card}]")


def moe_phase(torch, card):
    """(h) granite-moe-3b-a800m at full width and depth, served plain
    (replayed, then eager), n-gram and with int8 KV; (i) its span
    pipelines with one forced span move; (j) grok-1-314b at full width,
    depth cut to 2 layers, plain.  In f32: in bf16 a random-weight MoE
    stack amplifies rounding through its routing (``say_precision_probe``
    prints by how much), past what the teacher-forced rule can tell from
    a fault.  (h) also serves granite-moe plain in bf16, its tokens
    reported and not scored.  Returns {run: launches}."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import cast_params

    t0 = time.perf_counter()
    out, stats = {}, {}
    cfg = get("granite-moe-3b-a800m")
    params = T.init(cfg, seed=0, dtype=torch.float32)
    torch.cuda.synchronize()
    say(f"{describe(cfg)}, init in f32 (seed 0): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    say_precision_probe(torch, card, cfg, params,
                        served_requests(cfg)[0].prompt)
    gc.collect()
    torch.cuda.empty_cache()
    bf16_pages = ("paged_decode_partials", "paged_verify_partials")
    # (label, config, speculation, chunk_tokens, graphs, must launch,
    # must not launch)
    runs = [("moe-plain", cfg, "off", 256, True,
             ("paged_decode_partials", "flash_prefill",
              "paged_prefix_partials"), ("paged_verify_partials",)),
            ("moe-plain-eager", cfg, "off", 256, False,
             ("paged_decode_partials", "flash_prefill",
              "paged_prefix_partials"), ("paged_verify_partials",)),
            ("moe-ngram", cfg, "ngram", 256, True,
             ("flash_prefill", "paged_prefix_partials",
              "paged_verify_partials"), ()),
            ("moe-int8", cfg.with_kv_quant(), "off", None, True,
             ("paged_decode_partials_int8", "flash_prefill"),
             bf16_pages + ("paged_prefix_partials",
                           "paged_verify_partials_int8"))]
    for label, rcfg, mode, chunk, graphs, needed, forbidden in runs:
        with RouterLoad(torch) as rl, FnRanges(torch, "moe_apply"):
            stats[label] = serve_run(
                torch, card, rcfg, params, label=label, speculation=mode,
                chunk_tokens=chunk, needed=needed, forbidden=forbidden,
                profile=label in ("moe-plain", "moe-plain-eager"),
                bf16_streams=stats.get("moe-plain", {}).get("streams"),
                graphs=graphs)
        rl.say(label, card)
        out[label] = stats[label]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    a, b = stats["moe-plain"], stats["moe-plain-eager"]
    if a["streams"] != b["streams"]:
        diff = [rid for rid in a["streams"]
                if a["streams"][rid] != b["streams"][rid]]
        fail(f"[moe-plain] replayed streams differ from the eager run's for "
             f"requests {diff}")
    if a["launches"] != b["launches"]:
        fail(f"[moe-plain] replayed launches {a['launches']} differ from the "
             f"eager run's {b['launches']}")
    say(f"[moe-plain] CUDA graphs vs eager: decode {a['steady_ms']:.2f} vs "
        f"{b['steady_ms']:.2f} ms per iteration without capture "
        f"({a['iter_ms']:.2f} ms with it; compiled steps' device span "
        f"{a['span_ms']:.2f} vs {b['span_ms']:.2f} ms), prefill "
        f"{a['prefill_tps']:.1f} vs {b['prefill_tps']:.1f} tok/s, peak "
        f"memory {a['peak_gib']:.2f} vs {b['peak_gib']:.2f} GiB; streams "
        f"{len(a['streams'])}/{len(b['streams'])} equal, launch counts "
        f"equal [{card}]")
    say_families("moe-plain", card, a["decode_profile"],
                 b["decode_profile"])
    for st in stats.values():
        st.pop("decode_profile", None)
    out["moe-migrate-i"] = migration_run(
        torch, card, cfg, params, stats["moe-plain"]["streams"],
        label="moe-migrate-i", n_prefill=1, decode_split=2,
        force=force_one_span_move(torch, card, "moe-migrate-i"))
    # (h) in bf16, the dtype a deployment serves: what it costs on the
    # card; its tokens are reported, not scored (PERF.md §7)
    params = cast_params(params, torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    with RouterLoad(torch) as rl:
        st = serve_run(torch, card, cfg, params, label="moe-plain-bf16",
                       speculation="off", chunk_tokens=256,
                       needed=runs[0][5], forbidden=runs[0][6],
                       profile=False, score=False)
    rl.say("moe-plain-bf16", card)
    out["moe-plain-bf16"] = st["launches"]
    f32 = stats["moe-plain"]["streams"]
    same = sum(a == b for rid, s_ in st["streams"].items()
               for a, b in zip(s_, f32[rid]))
    say(f"[moe-plain-bf16] served tokens equal to the f32 plain run's at "
        f"the same place: {same}/{sum(map(len, f32.values()))} [{card}]")
    del params, st
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    full = get("grok-1-314b")
    gcfg = dataclasses.replace(full, name="grok-1-314b-2l", n_layers=2)
    torch.cuda.reset_peak_memory_stats()
    params = T.init(gcfg, seed=0, dtype=torch.float32)
    torch.cuda.synchronize()
    say(f"{describe(gcfg)}: grok-1-314b at full width, depth cut to "
        f"{gcfg.n_layers} of its {full.n_layers} layers; init in f32 (seed "
        f"0): {time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    with RouterLoad(torch) as rl:
        st = serve_run(torch, card, gcfg, params, label="grok-2l",
                       speculation="off", chunk_tokens=256,
                       needed=("paged_decode_partials", "flash_prefill",
                               "paged_prefix_partials"),
                       forbidden=("paged_verify_partials",), profile=False)
    rl.say("grok-2l", card)
    out["grok-2l"] = st["launches"]
    del params, st
    gc.collect()
    torch.cuda.empty_cache()
    say(f"MoE phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# The RG-LRU hybrid: recurrentgemma-9b served (n) and migrated (o)
# ---------------------------------------------------------------------------

# recurrentgemma-9b's engine: 4096-token page space, so its local layers'
# 2048-slot rings are 128 pages of 16 per row
HYBRID_MAX_LEN = 4096
HYBRID_CHUNK = 512
HYBRID_KERNELS = ("paged_decode_partials", "flash_prefill")
HYBRID_FORBIDDEN = ("paged_prefix_partials", "paged_verify_partials",
                    "split_kv_decode_partials", "paged_decode_partials_int8",
                    "paged_verify_partials_int8")


def hybrid_requests(cfg):
    """The 8 requests of runs (n) and (o): synthetic prompts of 1,200-3,000
    tokens from ``serving/workload.py`` (seed 74: 1,286-2,995 tokens), no
    shared prefix (the hybrid has no store), 32 tokens out each, all
    arriving at once (a burst: the prefill batches every prompt's chunks
    together, so their decodes overlap).  Checks that two prompts pass
    the 2,048-token window (the prefill tail-slices the ring), one
    crosses position 2,048 while decoding (the ring wraps in decode) and
    two stay below it."""
    from repro_torch.serving.workload import WorkloadConfig, generate

    reqs = generate(WorkloadConfig(
        kind="synthetic", rps=1000.0, n_requests=8,
        vocab_size=cfg.vocab_size, max_new_tokens=32, prefix_share=0.0,
        seed=74, prompt_len_lo=1200, prompt_len_hi=3000))
    for r in reqs:
        r.max_new_tokens = 32
        r.arrival = 0.0
    n = [r.prompt_len for r in reqs]
    w = cfg.local_window
    if not (sum(x > w for x in n) >= 2 and sum(x < w - 31 for x in n) >= 2
            and any(w - 31 <= x <= w for x in n)):
        fail(f"the hybrid's prompts {n} do not cover the ring's cases")
    return reqs


def hybrid_phase(torch, card):
    """(n) recurrentgemma-9b at full width and depth in bf16 (random
    weights from seed 0) through ``Server`` over one prefill and one
    decode member, 512-token chunks, replayed and eagerly: B1 and B2 must
    launch and B3, B4 and B5 must not, the streams and launches of the two
    runs must be equal, every token within TOKEN_GAP_TOL of the
    monolithic bf16 forward's best; prints one profiled iteration's device
    ms by family.  (o) two 2-stage decode pipelines over [(0, 19), (19,
    38)] with forced 4-layer span moves and a KV_HEADS rebalance after the
    third decode iteration.  Returns {run: launches}."""
    from repro_torch.configs import get
    from repro_torch.core.layer_migration import layer_param_bytes
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = get("recurrentgemma-9b")
    torch.cuda.reset_peak_memory_stats()
    params = T.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    kinds = cfg.blocks()
    say(f"{describe(cfg)}: {kinds.count(kinds[0])} RG-LRU and "
        f"{len(kinds) - kinds.count(kinds[0])} local-attention layers "
        f"(window {cfg.local_window}); init in bf16 (seed 0): "
        f"{time.perf_counter() - t0:.1f} s, weights "
        f"{layer_param_bytes(params) / 2**30:.2f} GiB [{card}]")
    out, runs = {}, {}
    with FnRanges(torch, "rglru_apply"):
        for graphs, label in ((True, "hybrid"), (False, "hybrid-eager")):
            runs[label] = serve_run(
                torch, card, cfg, params, label=label, speculation="off",
                chunk_tokens=HYBRID_CHUNK, needed=HYBRID_KERNELS,
                forbidden=HYBRID_FORBIDDEN, profile=True, graphs=graphs,
                max_len=HYBRID_MAX_LEN, requests=hybrid_requests)
            out[label] = runs[label]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
    a, b = runs["hybrid"], runs["hybrid-eager"]
    if a["streams"] != b["streams"] or a["launches"] != b["launches"]:
        fail(f"[hybrid] replayed streams or launches differ from the eager "
             f"run's: {a['launches']} vs {b['launches']}")
    say(f"[hybrid] CUDA graphs vs eager: decode {a['steady_ms']:.2f} vs "
        f"{b['steady_ms']:.2f} ms per iteration without capture "
        f"({a['iter_ms']:.2f} ms with it; compiled steps' device span "
        f"{a['span_ms']:.2f} vs {b['span_ms']:.2f} ms), prefill "
        f"{a['prefill_tps']:.1f} vs {b['prefill_tps']:.1f} tok/s, peak "
        f"memory {a['peak_gib']:.2f} vs {b['peak_gib']:.2f} GiB; streams "
        f"{len(a['streams'])}/{len(b['streams'])} equal, launch counts "
        f"equal [{card}]")
    say_families("hybrid", card, a["decode_profile"], b["decode_profile"],
                 HYBRID_FAMILIES, hybrid_family)
    for st in runs.values():
        st.pop("decode_profile", None)
    out["hybrid-migrate-o"] = migration_run(
        torch, card, cfg, params, a["streams"], label="hybrid-migrate-o",
        n_prefill=1, decode_split=2,
        force=force_move_then_rebalance(torch, card, "hybrid-migrate-o"),
        max_len=HYBRID_MAX_LEN, chunk_tokens=HYBRID_CHUNK,
        requests=hybrid_requests, needed=HYBRID_KERNELS,
        forbidden=HYBRID_FORBIDDEN)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"hybrid phase (n)-(o): {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# The xLSTM stack and cross attention: the last two registry configs
# ---------------------------------------------------------------------------

# every attention kernel counter (B1-B5): the xLSTM runs must launch none
# of them, and the forward scans
ALL_KERNELS = ("paged_decode_partials", "paged_decode_partials_int8",
               "flash_prefill", "paged_prefix_partials",
               "paged_verify_partials", "paged_verify_partials_int8",
               "split_kv_decode_partials")
XLSTM_KERNELS = ("mlstm_scan", "slstm_scan", "mlstm_scan_chunkwise",
                 "slstm_scan_persistent")
XLSTM_BACKWARD = ("mlstm_scan_backward", "mlstm_scan_backward_chunkwise",
                  "slstm_scan_backward", "slstm_scan_backward_persistent")
XLSTM_CHUNK = 256
XLSTM_FAMILIES = ("GEMMs", "the xLSTM's elementwise and recurrence work",
                  "the rest")


def xlstm_family(name: str, op) -> str:
    """The xLSTM family of a kernel ``name`` launched by profiler event
    ``op`` (None: by its name alone): a GEMM (every matrix product, the
    mLSTM's C q included), the mLSTM/sLSTM's other (elementwise and
    recurrence) kernels, or the rest."""
    if op is None:
        return ("GEMMs" if any(t in name.lower() for t in GEMM_SYMBOLS)
                else "the rest")
    if op.name in GEMM_OPS:
        return "GEMMs"
    return (XLSTM_FAMILIES[1] if _inside(op, "mlstm_apply")
            or _inside(op, "slstm_apply") else "the rest")


def xlstm_requests(cfg):
    """``served_requests`` (prompts of 189-606 tokens, 32 out), all
    arriving at once, as the hybrid's: the prefill batches the prompts'
    chunks together (the per-token recurrence then steps 8 rows at a
    time), and their decodes overlap."""
    reqs = served_requests(cfg)
    for r in reqs:
        r.arrival = 0.0
    return reqs


def xlstm_phase(torch, card):
    """(p) xlstm-350m at full width and depth in f32 (random weights from
    seed 0) through ``Server`` over one prefill and one decode member on
    dense rows, 256-token chunks, replayed and eagerly: the forward scans
    must launch and no B-kernel or backward scan, the streams and launches
    of the two runs must be equal, every token within TOKEN_GAP_TOL of the
    monolithic f32 forward's best; prints one profiled iteration's device
    ms by family.  (q) two 2-stage decode pipelines over [(0, 12), (12,
    24)] with one forced 4-layer span move (three mLSTM, one sLSTM); the
    streams must equal (p)'s.  Returns {run: launches}."""
    from repro_torch.configs import get
    from repro_torch.core.layer_migration import layer_param_bytes
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = get("xlstm-350m")
    torch.cuda.reset_peak_memory_stats()
    params = T.init(cfg, seed=0, dtype=torch.float32)
    torch.cuda.synchronize()
    kinds = cfg.blocks()
    n_m = kinds.count(kinds[0])
    n_params = layer_param_bytes(params) // 4
    say(f"{describe(cfg)}: {n_m} mLSTM and {len(kinds) - n_m} sLSTM layers, "
        f"no FFN; init in f32 (seed 0): {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f} B parameters in the tree "
        f"({layer_param_bytes(params) / 2**30:.2f} GiB; param_count() "
        f"takes the mLSTM's inner width as 2 d_model, the block's is heads "
        f"x head_dim = d_model) [{card}]")
    out, runs = {}, {}
    with FnRanges(torch, "mlstm_apply"), FnRanges(torch, "slstm_apply"):
        for graphs, label in ((True, "xlstm"), (False, "xlstm-eager")):
            # the eager run must equal the scored replayed run token for
            # token, so its reference (the recurrence stepped from Python
            # over every prompt) is not run twice
            runs[label] = serve_run(
                torch, card, cfg, params, label=label, speculation="off",
                chunk_tokens=XLSTM_CHUNK, needed=XLSTM_KERNELS,
                forbidden=ALL_KERNELS + XLSTM_BACKWARD,
                profile=True, graphs=graphs, decode_kernel=None,
                requests=xlstm_requests,
                same_as=None if graphs else runs["xlstm"]["streams"])
            out[label] = runs[label]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
    a, b = runs["xlstm"], runs["xlstm-eager"]
    if a["streams"] != b["streams"] or a["launches"] != b["launches"]:
        fail(f"[xlstm] replayed streams or launches differ from the eager "
             f"run's: {a['launches']} vs {b['launches']}")
    say(f"[xlstm] CUDA graphs vs eager: decode {a['steady_ms']:.2f} vs "
        f"{b['steady_ms']:.2f} ms per iteration without capture "
        f"({a['iter_ms']:.2f} ms with it; compiled steps' device span "
        f"{a['span_ms']:.2f} vs {b['span_ms']:.2f} ms), prefill "
        f"{a['prefill_tps']:.1f} vs {b['prefill_tps']:.1f} tok/s, peak "
        f"memory {a['peak_gib']:.2f} vs {b['peak_gib']:.2f} GiB; streams "
        f"{len(a['streams'])}/{len(b['streams'])} equal, launch counts "
        f"equal (forward scans: mLSTM {a['launches']['mlstm_scan_chunkwise']}"
        f" chunkwise + {a['launches']['mlstm_scan']} one-pass, sLSTM "
        f"{a['launches']['slstm_scan_persistent']} persistent + "
        f"{a['launches']['slstm_scan']} step; no B-kernel) [{card}]")
    say_families("xlstm", card, a["decode_profile"], b["decode_profile"],
                 XLSTM_FAMILIES, xlstm_family)
    for st in runs.values():
        st.pop("decode_profile", None)
    out["xlstm-migrate-q"] = migration_run(
        torch, card, cfg, params, a["streams"], label="xlstm-migrate-q",
        n_prefill=1, decode_split=2,
        force=force_one_span_move(torch, card, "xlstm-migrate-q", 4),
        chunk_tokens=XLSTM_CHUNK, requests=xlstm_requests,
        needed=XLSTM_KERNELS, forbidden=ALL_KERNELS + XLSTM_BACKWARD,
        exact=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"xlstm phase (p)-(q): {time.perf_counter() - t0:.1f} s [{card}]")
    return out


SEAMLESS_MAX_LEN = 2048
SEAMLESS_CHUNK = 512
SEAMLESS_KERNELS = ("paged_decode_partials", "flash_prefill",
                    "split_kv_decode_partials")
SEAMLESS_FORBIDDEN = ("paged_prefix_partials", "paged_verify_partials",
                      "paged_decode_partials_int8",
                      "paged_verify_partials_int8")
SEAMLESS_FAMILIES = ("GEMMs", "B1 (self attention)", "B5 (cross attention)",
                     "the rest")


def seamless_family(name: str, op) -> str:
    """The seamless family of a kernel ``name`` (op None: by its name
    alone): B1, B5, a GEMM, or the rest."""
    if "paged_decode_kernel" in name:
        return SEAMLESS_FAMILIES[1]
    if "split_decode_kernel" in name:
        return SEAMLESS_FAMILIES[2]
    if op is None:
        return ("GEMMs" if any(t in name.lower() for t in GEMM_SYMBOLS)
                else "the rest")
    return "GEMMs" if op.name in GEMM_OPS else "the rest"


def seamless_requests(cfg):
    """The 8 requests of runs (r) and (s): synthetic prompts of 600-1,500
    tokens from ``serving/workload.py`` (seed 23), no shared prefix, 32
    tokens out each; every prompt is longer than one 512-token chunk, so
    every prefill resumes."""
    from repro_torch.serving.workload import WorkloadConfig, generate

    reqs = generate(WorkloadConfig(
        kind="synthetic", rps=1000.0, n_requests=8,
        vocab_size=cfg.vocab_size, max_new_tokens=32, prefix_share=0.0,
        seed=23, prompt_len_lo=600, prompt_len_hi=1500))
    for r in reqs:
        r.max_new_tokens = 32
        r.arrival = 0.0
    if min(r.prompt_len for r in reqs) <= SEAMLESS_CHUNK:
        fail(f"seamless prompts {[r.prompt_len for r in reqs]}: one fits "
             f"a chunk")
    return reqs


def seamless_frames(torch, cfg, rid):
    """Request ``rid``'s encoder frames (1, n_frames, d_model), f32 from
    seed 100 + rid: the registry's stub for the speech encoder."""
    g = torch.Generator(device="cuda").manual_seed(100 + rid)
    return torch.randn((1, cfg.n_frames, cfg.d_model), generator=g,
                       device="cuda")


def seamless_run(torch, card, cfg, params, *, label, graphs,
                 bounds=None, move=None, profile=True, same_as=None):
    """One engine-level run of the 8 requests, each prefilled with its own
    frames by ``PrefillEngine.run_batch([req], frames, chunk_tokens=512)``
    (or a ``PrefillPipeline`` over ``bounds``) and inserted into one paged
    ``DecodeEngine`` (or a ``DecodePipeline`` over ``bounds``), decoded to
    the end (replayed, or with ``graphs`` off eagerly).  ``move`` = (src,
    dst, n): a live span move after the third decode iteration.  B1, B2
    and B5 must launch and B3, B4 must not; every token is held to the
    teacher-forced rule with the request's frames (or, with ``same_as``,
    must equal a scored run's).  Returns launches, streams and clocks."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                            PrefillEngine)
    from repro_torch.serving.span import DecodePipeline, PrefillPipeline

    ecfg = EngineConfig(max_len=SEAMLESS_MAX_LEN, max_batch=8,
                        block_size=16, cuda_graphs=graphs)
    if bounds:
        pe = PrefillPipeline(cfg, params, ecfg, bounds)
        de = DecodePipeline(cfg, params, ecfg, bounds)
        engines = de.engines
    else:
        pe, de = PrefillEngine(cfg, params, ecfg), \
            DecodeEngine(cfg, params, ecfg)
        engines = [de]
    reqs = seamless_requests(cfg)
    frames = {r.rid: seamless_frames(torch, cfg, r.rid) for r in reqs}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if profile:
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").sum()   # start the tracer untimed
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    cross_b = None
    for r in reqs:
        st, lg = pe.run_batch([r], frames=frames[r.rid],
                              chunk_tokens=SEAMLESS_CHUNK)[0]
        if cross_b is None:
            cross_b = sum(a.numel() * a.element_size()
                          for g in tuple(st["groups"]) + tuple(st["rem"])
                          for a in g["cross"].values())
        de.insert(r, st, int(torch.argmax(lg)))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prompt_tokens = sum(r.prompt_len for r in reqs)
    prof, rec, move_ms, residents = {}, None, 0.0, 0
    decode_s = span_ms = 0.0
    iters = timed = tokens = 0

    def capture_s():
        return sum(e.compiled.capture_s for e in engines)

    while de.active:
        if move is not None and iters == 3 and rec is None:
            residents = de.active
            t = time.perf_counter()
            rec = de.move_span(*move)
            torch.cuda.synchronize()
            move_ms = (time.perf_counter() - t) * 1e3
            if rec is None:
                fail(f"[{label}] the span move {move} was refused")
        before = sum(len(r.generated) for r in reqs)
        if profile and iters == PROFILE_ITER - 1:
            t = time.perf_counter()
            with torch.profiler.profile(activities=acts) as p, \
                    StepEvents(torch) as ev:
                de.step()
                torch.cuda.synchronize()
            prof.update(profile=p, wall_ms=(time.perf_counter() - t) * 1e3,
                        step_ms=ev.ms(), rows=de.active)
            iters += 1
            continue
        cap = capture_s()
        t = time.perf_counter()
        with StepEvents(torch) as ev:
            de.step()
            torch.cuda.synchronize()
        decode_s += time.perf_counter() - t - (capture_s() - cap)
        span_ms += ev.ms()
        tokens += sum(len(r.generated) for r in reqs) - before
        iters += 1
        timed += 1
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for e in engines:
        if e.active:
            fail(f"[{label}] {e.name}: live slots after the run")
        try:
            e.pool.check(holders=[])
        except AssertionError as exc:
            fail(f"[{label}] {e.name}: pool invariant: {exc}")
    check_streams(torch, cfg, params, label, reqs, launches,
                  SEAMLESS_KERNELS, SEAMLESS_FORBIDDEN, frames_of=frames,
                  same_as=same_as)
    steady_ms = decode_s / max(timed, 1) * 1e3
    say(f"[{label}] engine-level run{' over ' + str(bounds) if bounds else ''}"
        f": {len(reqs)} requests of {min(r.prompt_len for r in reqs)}-"
        f"{max(r.prompt_len for r in reqs)} tokens, each with its own "
        f"frames (1, {cfg.n_frames}, {cfg.d_model}); prefill "
        f"{prompt_tokens} tokens in {prefill_s:.3f} s = "
        f"{prompt_tokens / max(prefill_s, 1e-9):.1f} tok/s (one request "
        f"per call, {SEAMLESS_CHUNK}-token chunks); decode {tokens} tokens "
        f"over {timed} timed iterations, {steady_ms:.2f} ms each without "
        f"the {capture_s():.3f} s of graph warm-up and capture (compiled "
        f"steps' device span {span_ms / max(timed, 1):.2f} ms by CUDA "
        f"events); cross K/V per request {cross_b} B; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    if rec is not None:
        say(f"[{label}] span move stage {move[0]} -> {move[1]}: "
            f"{rec['layers']} layers in {move_ms:.1f} ms host wall clock "
            f"(synchronised), weight_bytes {rec['weight_bytes']} (views: "
            f"re-sliced, not copied), kv_bytes {rec['kv_bytes']} (pages "
            f"and cross K/V of {residents} residents; the cross K/V alone "
            f"{rec['layers'] * cross_b // cfg.n_layers} B per resident) "
            f"[{card}]")
    if "profile" in prof:
        kern = device_kernels(prof["profile"].key_averages())
        busy = sum(device_us(e) for e in kern) / 1e3
        say(f"[{label}] decode iteration {PROFILE_ITER} "
            f"({'replayed' if graphs else 'eager'}) under torch.profiler "
            f"({prof['rows']} rows; wall {prof['wall_ms']:.1f} ms; compiled "
            f"step's device span {prof['step_ms']:.2f} ms): device busy "
            + (f"{busy:.2f} ms in {sum(e.count for e in kern)} kernels"
               if busy > 0 else "not measured (no device time recorded)")
            + f" [{card}]")
    say_graphs(label, card, engines)
    say(f"[{label}] serving-path launches: {json.dumps(launches)}")
    del pe, de, engines
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches,
            "streams": {r.rid: list(r.generated) for r in reqs},
            "steady_ms": steady_ms, "span_ms": span_ms / max(timed, 1),
            "prefill_tps": prompt_tokens / max(prefill_s, 1e-9),
            "peak_gib": peak / 2**30, "decode_profile": prof.get("profile")}


def seamless_phase(torch, card):
    """(r) seamless-m4t-large-v2 at full width and depth in f32 (random
    weights from seed 0, each request's frames from its seed) through
    the engines (the orchestrator carries no frames), replayed and
    eagerly: B1, B2 and B5 must launch and B3, B4 must not, the two runs'
    streams and launches must be equal; prints one profiled iteration's
    device ms by family.  (s) a 2-stage ``PrefillPipeline`` and
    ``DecodePipeline`` over [(0, 12), (12, 24)] with one forced 4-layer
    span move; its streams must equal (r)'s.  (``seamless_kernels`` holds
    B1, B2 and B5 at these runs' shapes against their plain versions.)
    Returns {run: launches}."""
    from repro_torch.configs import get
    from repro_torch.core.layer_migration import layer_param_bytes
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = get("seamless-m4t-large-v2")
    params = T.init(cfg, seed=0, dtype=torch.float32)
    torch.cuda.synchronize()
    say(f"{describe(cfg)}: cross attention over {cfg.n_frames} frames per "
        f"layer; init in f32 (seed 0): {time.perf_counter() - t0:.1f} s, "
        f"weights {layer_param_bytes(params) / 2**30:.2f} GiB [{card}]")
    out, runs = {}, {}
    for graphs, label in ((True, "seamless"), (False, "seamless-eager")):
        runs[label] = seamless_run(
            torch, card, cfg, params, label=label, graphs=graphs,
            same_as=None if graphs else runs["seamless"]["streams"])
        out[label] = runs[label]["launches"]
    a, b = runs["seamless"], runs["seamless-eager"]
    if a["streams"] != b["streams"] or a["launches"] != b["launches"]:
        fail(f"[seamless] replayed streams or launches differ from the "
             f"eager run's: {a['launches']} vs {b['launches']}")
    say(f"[seamless] CUDA graphs vs eager: decode {a['steady_ms']:.2f} vs "
        f"{b['steady_ms']:.2f} ms per iteration without capture (compiled "
        f"steps' device span {a['span_ms']:.2f} vs {b['span_ms']:.2f} ms), "
        f"prefill {a['prefill_tps']:.1f} vs {b['prefill_tps']:.1f} tok/s, "
        f"peak memory {a['peak_gib']:.2f} vs {b['peak_gib']:.2f} GiB; "
        f"streams {len(a['streams'])}/{len(b['streams'])} equal, launch "
        f"counts equal [{card}]")
    say_families("seamless", card, a["decode_profile"], b["decode_profile"],
                 SEAMLESS_FAMILIES, seamless_family)
    out["seamless-pipeline-s"] = seamless_run(
        torch, card, cfg, params, label="seamless-pipeline-s", graphs=True,
        bounds=[(0, 12), (12, 24)], move=(0, 1, 4), profile=False,
        same_as=a["streams"])["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"seamless phase (r)-(s): {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Training: (t) llama-13b at full width, 8 layers; (u) granite-moe at full
# size; then the trained llama-13b weights served
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8
# The microbatch agreement: one step in two microbatches against the same
# parameters' full batch, both bf16.  The two runs may round the bf16
# forward in other GEMM shapes, and they hold the gradients in bf16 (one
# batch) or f32 (two, accumulated): on the H100 the loss agreed exactly
# and the grad norm to 6.8e-6 (PERF.md §6).
MB_TOL_REL = 1e-3


def tree_numel(tree) -> int:
    from repro_torch.training.tree import named_leaves
    return sum(a.numel() for _, a in named_leaves(tree))


def train_steps(torch, card, cfg, params, *, label, batches, remat,
                opt_cfg, kernels=()):
    """Runs ``len(batches)`` AdamW steps of ``make_train_step`` on
    ``params`` (updated in place) with every launch counter zeroed
    before and read after: every kernel of ``kernels`` must launch and no
    other (no B-kernel: JAX trains outside any Pallas kernel; the xLSTM
    stack's redesigned forward scans and the backward scans).  Checks that every loss, grad norm (and MoE
    ``lb_loss``) is finite and that the mean loss of the last five steps
    is below that of the first five; prints ms per step (host clock
    around synchronised steps; the first step apart) and the AdamW
    update's share of it (CUDA events around ``apply_updates``),
    tokens/s and peak memory (and what was allocated before the steps).
    Returns (optimizer state, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step

    state = O.init_state(params)
    step = make_train_step(cfg, opt_cfg, remat=remat)
    update, events = O.apply_updates, []

    def timed_update(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = update(*a)
        ev[1].record()
        events.append(ev)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    rows, secs = [], []
    O.apply_updates = timed_update
    for toks in batches:
        t = time.perf_counter()
        params, state, m = step(params, state, {"tokens": toks})
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        rows.append(m)
    O.apply_updates = update
    adamw_ms = sum(a.elapsed_time(b) for a, b in events[1:]) / max(
        len(events) - 1, 1)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(rows, 1):
        if not all(map(math.isfinite, m.values())):
            fail(f"[{label}] step {i}: non-finite metrics {m}")
    if any(n for k, n in launches.items() if k not in kernels) or not all(
            launches[k] for k in kernels):
        fail(f"[{label}] kernels launched during training: {launches}; "
             f"expected {list(kernels) or 'none'}")
    losses = [m["loss"] for m in rows]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        fail(f"[{label}] the loss did not decrease: mean of the first five "
             f"steps {first:.4f}, of the last five {last:.4f}")
    tokens = batches[0].shape[0] * (batches[0].shape[1] - 1)
    steady = sum(secs[1:]) / max(len(secs) - 1, 1)
    lb = ("; lb_loss " + ", ".join(f"{m['lb_loss']:.4f}" for m in rows)
          if "lb_loss" in rows[0] else "")
    say(f"[{label}] {len(rows)} steps of {batches[0].shape[0]} x "
        f"{batches[0].shape[1] - 1} tokens (remat {remat}): "
        f"{steady * 1e3:.1f} ms per step after the first "
        f"({secs[0] * 1e3:.1f} ms), AdamW {adamw_ms:.1f} ms of it (device), "
        f"{tokens / steady:.1f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held "
        f"before the steps); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (mean of the first five {first:.4f}, of the last "
        f"five {last:.4f}); grad norm {rows[0]['grad_norm']:.3f} -> "
        f"{rows[-1]['grad_norm']:.3f}{lb}; launches "
        f"{ {k: n for k, n in launches.items() if n} or 'none'} [{card}]")
    say(f"[{label}] losses: {', '.join(f'{x:.4f}' for x in losses)}")
    return state, launches


def train_batches(torch, cfg, batch, seq, n):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens

    data = iter(SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)))
    return [torch.as_tensor(next(data)["tokens"], device="cuda")
            for _ in range(n)]


def check_microbatches(torch, card, cfg, params, state, opt_cfg, toks):
    """The same parameters' full-batch loss and grad norm
    (``loss_and_grads``, no update) against one real step in two
    microbatches: each within MB_TOL_REL.  The step updates ``params``."""
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import (loss_and_grads,
                                                 make_train_step)

    torch.cuda.reset_peak_memory_stats()
    loss, _, grads = loss_and_grads(cfg, params, {"tokens": toks})
    loss, gnorm = float(loss), float(O.global_norm(grads))
    del grads
    step = make_train_step(cfg, opt_cfg, num_microbatches=2)
    _, _, m = step(params, state, {"tokens": toks})
    got = {k: float(m[k]) for k in ("loss", "grad_norm")}
    rel = {"loss": abs(got["loss"] - loss) / abs(loss),
           "grad_norm": abs(got["grad_norm"] - gnorm) / abs(gnorm)}
    say(f"[llama-13b-train] one step in 2 microbatches against the full "
        f"batch from the same parameters: loss {got['loss']:.6f} vs "
        f"{loss:.6f} (rel {rel['loss']:.2e}), grad norm "
        f"{got['grad_norm']:.5f} vs {gnorm:.5f} (rel "
        f"{rel['grad_norm']:.2e}); tolerance {MB_TOL_REL}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if max(rel.values()) > MB_TOL_REL:
        fail(f"[llama-13b-train] microbatched step disagrees: {rel}")


def check_checkpoint(torch, card, params) -> None:
    """``save`` then ``restore`` of the trained tree: every leaf bit for
    bit.  Written under the checkout's ``build/`` (ignored by git)."""
    import tempfile
    from repro_torch.training import checkpoint as C
    from repro_torch.training.tree import named_leaves

    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        C.save(d, params, step=21, meta={"arch": "llama-13b"})
        size = os.path.getsize(os.path.join(d, "ckpt_21.npz"))
        t1 = time.perf_counter()
        back, step = C.restore(d, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    bad = [n for (n, a), (_, b) in zip(named_leaves(params),
                                       named_leaves(back))
           if a.dtype != b.dtype or not torch.equal(
               a.view(torch.uint8), b.view(torch.uint8))]
    if bad or step != 21:
        fail(f"[llama-13b-train] checkpoint round trip differs at {bad}")
    say(f"[llama-13b-train] checkpoint round trip bit for bit: "
        f"{size / 2**30:.2f} GiB, save {t1 - t0:.1f} s, restore "
        f"{t2 - t1:.1f} s [{card}]")


def serve_trained(torch, card, cfg, params):
    """The trained weights through ``PrefillEngine`` then ``DecodeEngine``
    (as ``examples/quickstart.py`` serves), the 8 served requests: every
    token within the teacher-forced rule, B1 and B2 launched, B3-B5
    not.  Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                            PrefillEngine)

    label = "llama-13b-trained-served"
    ecfg = EngineConfig(max_len=1024, max_batch=8, block_size=16)
    pe = PrefillEngine(cfg, params, ecfg)
    de = DecodeEngine(cfg, params, ecfg)
    reqs = served_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        st, lg = pe.run(r)
        de.insert(r, st, int(torch.argmax(lg)))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    while de.active:
        de.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_streams(torch, cfg, params, label, reqs, launches,
                  ("paged_decode_partials", "flash_prefill"),
                  forbidden=("paged_prefix_partials", "paged_verify_partials",
                             "split_kv_decode_partials"))
    prompt_tokens = sum(r.prompt_len for r in reqs)
    capture_s = de.compiled.capture_s
    steady_ms = (decode_s - capture_s) / de.decode_iters * 1e3
    say(f"[{label}] {len(reqs)} requests: prefill {prompt_tokens} tokens at "
        f"{prompt_tokens / prefill_s:.1f} tok/s (one request per forward); "
        f"decode {de.tokens_decoded} tokens over {de.decode_iters} "
        f"iterations, {steady_ms:.2f} ms each without the {capture_s:.3f} s "
        f"of graph capture; "
        f"peak memory {peak / 2**30:.2f} GiB; launches "
        f"{json.dumps(launches)} [{card}]")
    del pe, de
    return launches


def training_phase(torch, card):
    """(t) llama-13b at full width (5120 wide, 40/40 heads of 128, d_ff
    13,824, vocab 32,000), depth cut to TRAIN_LAYERS: bf16 weights from
    seed 0, ``SyntheticTokens(seed=0)`` at 4 x 1,024, AdamW (lr 1e-3,
    warmup 2, total 20), 20 steps without remat; then the microbatch
    agreement, a checkpoint round trip and the trained weights served.
    (u) granite-moe-3b-a800m at full size, bf16 with its f32 router,
    remat, no-drop sorted dispatch, 2 x 512, 10 steps.  Returns {run:
    launches}."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    t0 = time.perf_counter()
    out = {}
    cfg = dataclasses.replace(get("llama-13b"), n_layers=TRAIN_LAYERS)
    params = T.init(cfg, seed=0, dtype=torch.bfloat16)
    say(f"[llama-13b-train] {describe(cfg)}: {tree_numel(params):,} "
        f"parameters in the tree, bf16 from seed 0 [{card}]")
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    batches = train_batches(torch, cfg, 4, 1024, 21)
    state, out["llama-13b-train"] = train_steps(
        torch, card, cfg, params, label="llama-13b-train",
        batches=batches[:20], remat=False, opt_cfg=opt_cfg)
    check_microbatches(torch, card, cfg, params, state, opt_cfg, batches[20])
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    check_checkpoint(torch, card, params)
    gc.collect()
    torch.cuda.empty_cache()
    out["llama-13b-trained-served"] = serve_trained(torch, card, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get("granite-moe-3b-a800m")
    params = T.init(cfg, seed=0, dtype=torch.bfloat16)
    say(f"[granite-moe-train] {describe(cfg)}: {tree_numel(params):,} "
        f"parameters in the tree, bf16 (router f32) from seed 0 [{card}]")
    _, out["granite-moe-train"] = train_steps(
        torch, card, cfg, params, label="granite-moe-train",
        batches=train_batches(torch, cfg, 2, 512, 10), remat=True,
        opt_cfg=O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out.update(xlstm_train_run(torch, card))
    say(f"training phase (t)-(u), (y): {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    return out


def xlstm_train_run(torch, card):
    """(y) xlstm-350m at full size in f32 from seed 0, AdamW (lr 1e-3,
    warmup 2, total 10), 10 steps of 2 x 1,024 tokens without remat: the
    chunkwise mLSTM forward and backward and the persistent sLSTM forward
    and backward must launch, each once a layer and step, and no other
    (none of the first designs).  Returns {run: launches}."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.models.config import BlockKind
    from repro_torch.training import optimizer as O

    t0 = time.perf_counter()
    cfg = get("xlstm-350m")
    params = T.init(cfg, seed=0, dtype=torch.float32)
    say(f"[xlstm-train] {describe(cfg)}: {tree_numel(params):,} parameters "
        f"in the tree, f32 from seed 0 [{card}]")
    _, launches = train_steps(
        torch, card, cfg, params, label="xlstm-train",
        batches=train_batches(torch, cfg, *XLSTM_TRAIN_SHAPE, 10),
        remat=False,
        opt_cfg=O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
        kernels=TRAIN_SCAN_KERNELS)
    kinds = cfg.blocks()
    for name in TRAIN_SCAN_KERNELS:
        want = 10 * kinds.count(BlockKind.MLSTM if name.startswith("mlstm")
                                else BlockKind.SLSTM)
        if launches[name] != want:
            fail(f"[xlstm-train] {name} launched {launches[name]} times, "
                 f"expected {want} (one a layer and step)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[xlstm-train] (y): {time.perf_counter() - t0:.1f} s [{card}]")
    return {"xlstm-train": launches}


# ---------------------------------------------------------------------------

KERNELS = [
    # (timing key, launch counter, source, TPU kernel it replaces)
    ("B1", "paged_decode_partials",
     "src/repro_torch/kernels/csrc/paged_decode.cu",
     "src/repro/kernels/split_kv_decode.py:304"),
    ("B1-int8", "paged_decode_partials_int8",
     "src/repro_torch/kernels/csrc/paged_decode.cu",
     "src/repro/kernels/split_kv_decode.py:304"),
    ("B2", "flash_prefill", "src/repro_torch/kernels/csrc/flash_prefill.cu",
     "src/repro/kernels/flash_prefill.py:91"),
    ("B3", "paged_prefix_partials",
     "src/repro_torch/kernels/csrc/paged_prefix.cu",
     "src/repro/kernels/flash_prefill.py:210"),
    ("B4", "paged_verify_partials",
     "src/repro_torch/kernels/csrc/paged_verify.cu",
     "src/repro/kernels/split_kv_decode.py:232"),
    ("B4-int8", "paged_verify_partials_int8",
     "src/repro_torch/kernels/csrc/paged_verify.cu",
     "src/repro/kernels/split_kv_decode.py:232"),
    ("B5", "split_kv_decode_partials",
     "src/repro_torch/kernels/csrc/split_kv_decode.cu",
     "src/repro/kernels/split_kv_decode.py:67"),
    # no TPU kernel: JAX's lax.scan loops, which XLA compiles; two designs
    # of each scan, forward and backward (the redesigned one first)
    ("mLSTM-chunkwise", "mlstm_scan_chunkwise",
     "src/repro_torch/kernels/csrc/mlstm_scan.cu",
     "src/repro/models/layers.py:709"),
    ("mLSTM", "mlstm_scan", "src/repro_torch/kernels/csrc/mlstm_scan.cu",
     "src/repro/models/layers.py:709"),
    ("mLSTM-bwd-chunkwise", "mlstm_scan_backward_chunkwise",
     "src/repro_torch/kernels/csrc/mlstm_scan.cu",
     "src/repro/models/layers.py:709"),
    ("mLSTM-bwd", "mlstm_scan_backward",
     "src/repro_torch/kernels/csrc/mlstm_scan.cu",
     "src/repro/models/layers.py:709"),
    ("sLSTM-persistent", "slstm_scan_persistent",
     "src/repro_torch/kernels/csrc/slstm_scan.cu",
     "src/repro/models/layers.py:763"),
    ("sLSTM", "slstm_scan", "src/repro_torch/kernels/csrc/slstm_scan.cu",
     "src/repro/models/layers.py:763"),
    ("sLSTM-bwd-persistent", "slstm_scan_backward_persistent",
     "src/repro_torch/kernels/csrc/slstm_scan.cu",
     "src/repro/models/layers.py:763"),
    ("sLSTM-bwd", "slstm_scan_backward",
     "src/repro_torch/kernels/csrc/slstm_scan.cu",
     "src/repro/models/layers.py:763"),
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
    say(f"built {len(_lib.KERNELS)} kernel sources "
        f"({sum(map(len, _lib.KERNELS.values()))} entry points) in "
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
    report_timing(timing, card)

    # -- phase 3
    per_run = serving_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    per_run.update(dryrun_phase(torch, card))
    cli_phase(card)
    examples_phase(card)
    per_run.update(moe_phase(torch, card))
    per_run.update(hybrid_phase(torch, card))
    per_run.update(xlstm_phase(torch, card))
    per_run.update(seamless_phase(torch, card))
    per_run.update(training_phase(torch, card))
    launches = {k: sum(run[k] for run in per_run.values())
                for k in _lib.LAUNCHES}

    # -- phase 4
    say(card)
    say(json.dumps({"kernels": kernel_rows(timing, errs, launches)}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def report_timing(timing, card) -> None:
    """Adds each timed kernel's bound (``bound_ms``, ``bound_by``) and
    prints it with its times; fails a time under its bound."""
    for key, t in timing.items():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["flops"] / PEAK_FLOPS[t["dtype"]])
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["flops"] / PEAK_FLOPS[t["dtype"]]
                         else "operations")
        for k in ("ms", "plain_ms", "library_ms"):
            if t.get(k) is not None and t[k] < t["bound_ms"]:
                fail(f"{key}: {k} {t[k]:.4f} is under the bound "
                     f"{t['bound_ms']:.4f} ms: the timer or the byte count "
                     f"is wrong")
        split = (f" (pages_per_split {t['pages_per_split']})"
                 if "pages_per_split" in t else "")
        times = ", ".join(f"{name} {t[k]:.4f} ms" for k, name in (
            ("ms", "kernel"), ("plain_ms", "plain"),
            ("library_ms", "library"), ("bound_ms", "bound"))
            if t.get(k) is not None)
        say(f"{key}{split}: {times} ({t['bound_by']}: "
            f"{t['bytes'] / 1e6:.1f} MB, {t['flops'] / 1e9:.2f} GFLOP) "
            f"[{card}]")


def kernel_rows(timing, errs, launches) -> list:
    """The ``kernels`` line's rows, one per entry of KERNELS."""
    rows = []
    for key, counter, source, replaces in KERNELS:
        t = timing[key]
        rows.append({"name": counter, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counter],
                     "max_abs_err": errs[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    return rows


if __name__ == "__main__":
    main()
