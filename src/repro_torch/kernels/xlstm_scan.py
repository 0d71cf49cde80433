"""The xLSTM recurrences as differentiable custom operators: the port's
counterpart of the two ``jax.lax.scan`` loops of JAX's
``src/repro/models/layers.py`` (``mlstm_apply``'s and ``slstm_apply``'s).

XLA compiles each scan into one loop on the device and differentiates
through it; PyTorch has no scan, so each recurrence is one operator over
the whole sequence, forward and backward, with hand-written CUDA kernels
behind them, two designs of each forward (no TPU kernel: JAX left these
loops to XLA):

* ``repro_torch::mlstm_scan(q, k, v, log_i, log_f, C0, n0, m0, chunk)``
  -> (y, C, n, m, ckC, ckn, ms, ss), CUDA ``csrc/mlstm_scan.cu``: the
  chunkwise forward (``mlstm_scan_forward_chunkwise``, parallel within
  32-step chunks, the chunk states in sequence) or the one-pass forward
  (``mlstm_scan_forward``, step after step), by ``mlstm_route``.  With
  ``chunk`` > 0 (a forward that autograd records) it also saves the
  carries before every ``chunk``-th step and every step's stabilizer m_t
  and n_t . q_t (a saved C per step would be B H D^2 floats a step, 2 GiB
  a layer at xlstm-350m's 2 x 1,024 tokens), from which
  ``repro_torch::mlstm_scan_backward`` differentiates: the chunkwise
  backward (``mlstm_scan_backward_chunkwise``: the chain of chunk-end
  gradients over the 32-step chunks in reverse, then every chunk's
  products with its saved state at once) or the step backward
  (``mlstm_scan_backward``, which recomputes each chunk's states and walks
  them step by step), by ``mlstm_bwd_route``.
* ``repro_torch::slstm_scan(pre_x, r_w, c0, n0, m0, h0, save)`` -> (y, c,
  n, m, h, pres, cs, ns, ms), CUDA ``csrc/slstm_scan.cu``: the persistent
  forward (``slstm_scan_forward_persistent``, one cooperative launch, r_w
  resident in shared memory) or the step forward (``slstm_scan_forward``,
  a launch a step), by ``slstm_route``.  With ``save`` it keeps every
  step's pre-activations and c, n, m (B S (4d + 3d) floats) for
  ``repro_torch::slstm_scan_backward``: the persistent backward
  (``slstm_scan_backward_persistent``, one cooperative launch, r_w's rows
  resident in shared memory) or the step backward
  (``slstm_scan_backward``, a launch a step), by ``slstm_bwd_route``; dr_w
  = sum_t h_{t-1}^T dpre_t is one ``torch.matmul`` after the kernel.

Each design counts its launches under its own name in ``_lib.LAUNCHES``:
``mlstm_scan_chunkwise`` / ``mlstm_scan`` (one-pass),
``mlstm_scan_backward_chunkwise`` / ``mlstm_scan_backward`` (step),
``slstm_scan_persistent`` / ``slstm_scan`` (step),
``slstm_scan_backward_persistent`` / ``slstm_scan_backward`` (step).  The
route is fixed by shape before any launch; a refused launch raises, and
nothing gives way to the other design or to the plain version.

Each operator has ``custom_ops.define``'s four bodies (CUDA: the kernel;
CPU: the plain version from ``ref``; fake: the shapes, the saved tensors
included, so the dry run counts them; a flop formula) and a ``DTensor``
rule: the mLSTM splits batch and heads, the sLSTM batch only (r_w mixes
all of d and stays replicated; its gradient is then a partial sum over the
batch shards).  The forward operators carry ``register_autograd``: the
backward is one operator call per layer.  The carries are the recurrence's
starting state (fresh zeros and m = -1e30 in training, the caller's state
in serving): a carry that requires grad, or a gradient reaching a final
carry, raises, never a silent zero.

The flop formulas count 2 flops per multiply-add of the products, from
shapes: the mLSTM's forward 2 B S H (2 D^2 + D) (C q, v k^T into C, n . q),
its backward 2 B S H (6 D^2 + 3 D) (v k^T recomputed, (dy / den) q^T, C^T
(dy / den), <dC, C_{t-1}>, dC k, dC^T v; dy . y, dn . n_{t-1}, dn . k);
the sLSTM's forward 2 B S d 4d (h r_w), its backward twice that (dpre
r_w^T per step, and dr_w).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _lib
from .custom_ops import _splits, define, placement_rules
from .ref import (mlstm_scan_backward_ref, mlstm_scan_ref,
                  slstm_scan_backward_ref, slstm_scan_ref)

MLSTM = "mlstm_scan"
MLSTM_BWD = "mlstm_scan_backward"
SLSTM = "slstm_scan"
SLSTM_BWD = "slstm_scan_backward"
# launch counters of the two redesigned forwards (the one-pass mLSTM and
# the step sLSTM count under MLSTM and SLSTM)
MLSTM_CHUNKWISE = "mlstm_scan_chunkwise"
SLSTM_PERSISTENT = "slstm_scan_persistent"
# and of the redesigned backwards (the step backwards count under
# MLSTM_BWD and SLSTM_BWD)
MLSTM_BWD_CHUNKWISE = "mlstm_scan_backward_chunkwise"
SLSTM_BWD_PERSISTENT = "slstm_scan_backward_persistent"
# steps per mLSTM checkpoint of a recorded forward, and per chunk of the
# chunkwise forward (its kernels' L)
MLSTM_CHUNK = 32
# value rows of C per block of the mLSTM backward: the scratch the wrapper
# allocates follows it, and the kernel refuses any other count than its
# kBwdRows
MLSTM_BWD_ROWS = 16
# columns of D a block of the chunkwise backward's products takes (its CT):
# its scratch holds a partial sum per tile
MLSTM_BWD_TILE = 128
MAX_HEAD_DIM = 1024         # one thread per column of C
# the widest D the step mLSTM backward launches: a thread per column of C,
# and past 256 threads its registers exceed an SM's (refused on an H100 at
# D = 260)
MLSTM_BWD_STEP_MAX_D = 256
# scratch bound of an unrecorded chunkwise mLSTM forward's chunk states
# (``mlstm_window``): 64 MiB, one window for a served 8 x 256 chunk wave
# or a 1 x 2,048 prefill at xlstm-350m's widths
MLSTM_STATE_BYTES = 64 << 20
# the persistent sLSTM forward: hidden units a block owns (kPUnits), batch
# rows a call takes (kPMaxRows), and the H100's shared memory a block may
# opt into (227 KiB)
SLSTM_UNITS = 8
SLSTM_MAX_ROWS = 8
SMEM_PER_BLOCK = 232448
# The routes' boundaries in S, from both designs timed as prefill calls
# them (eager, host enqueue included) at xlstm-350m's widths on an H100
# (``chip_smoke.route_sweep``; PERF.md section 6): the chunkwise mLSTM's
# launches cost ~0.12-0.25 ms however short the call, the one-pass
# kernel ~0.7 us a step at one row and ~3.2 at eight, so the one-pass
# kernel stays faster below ~64 steps at 8 rows and ~256-512 at one (the
# row-step bound is the first sweep's; later sweeps put it nearer 512
# below 8 rows); the persistent sLSTM wins from 4 steps on (at 2-3 the
# order flips between runs).
MLSTM_CHUNKWISE_MIN_STEPS = 64
MLSTM_CHUNKWISE_MIN_ROW_STEPS = 256
SLSTM_PERSISTENT_MIN_STEPS = 4
# the persistent sLSTM backward's least S, from both designs timed as
# autograd calls them (eager, host enqueue and the dr_w product included;
# ``chip_smoke.bwd_route_sweep``, PERF.md section 6): at 2 and 3 steps
# they are within ~0.02 ms either way, from 4 on the persistent design wins
# at every point measured (its device time is ~3.4 us a step against the
# step design's ~12.5); at S = 1 there is no recurrent product and both
# make one launch
SLSTM_BWD_PERSISTENT_MIN_STEPS = 2


def mlstm_window(b: int, h: int, d: int) -> int:
    """Chunks per window of an unrecorded chunkwise forward, and of the
    chunkwise backward's chunk-end gradients: as many chunk states (B H D^2
    floats each) as fit ``MLSTM_STATE_BYTES``, at least one.  The sequence
    is walked window after window (the backward's from its last), so the
    scratch stays within that budget however long the sequence (a recorded
    forward keeps every chunk's state: they are its checkpoints)."""
    return max(1, MLSTM_STATE_BYTES // (4 * b * h * d * d))


def mlstm_route(b: int, s: int, h: int, d: int, chunk: int) -> str:
    """The mLSTM forward's design for a call on the card, from its shape
    alone: ``"chunkwise"`` (``mlstm_scan_forward_chunkwise``) when S >=
    ``MLSTM_CHUNKWISE_MIN_STEPS`` (64), B S >=
    ``MLSTM_CHUNKWISE_MIN_ROW_STEPS`` (256), D is a multiple of 4 (its
    16-byte copies) and ``chunk`` is 0 or ``MLSTM_CHUNK`` (its chunk states
    are then the checkpoints); else ``"one_pass"``
    (``mlstm_scan_forward``): a decode step (S = 1), which a captured CUDA
    graph replays as one plain launch, and the short prefill chunks where
    one launch beats three."""
    if (s >= MLSTM_CHUNKWISE_MIN_STEPS
            and b * s >= MLSTM_CHUNKWISE_MIN_ROW_STEPS and d % 4 == 0
            and chunk in (0, MLSTM_CHUNK)):
        return "chunkwise"
    return "one_pass"


def mlstm_bwd_route(b: int, s: int, h: int, d: int, chunk: int) -> str:
    """The mLSTM backward's design for a call on the card, from its shape
    alone: ``"chunkwise"`` (``mlstm_scan_backward_chunkwise``) for every
    forward recorded with ``chunk`` = ``MLSTM_CHUNK`` (the checkpoints are
    then the states before its 32-step chunks), every D up to
    ``MAX_HEAD_DIM`` (one that is no multiple of 4 zero-padded to one);
    else ``"step"`` (``mlstm_scan_backward``, the first design), which
    takes D up to ``MLSTM_BWD_STEP_MAX_D``.  B, S and H do not choose: the
    chunkwise form's chain is S / 32 steps long where the first design's
    is S."""
    del b, s, h, d
    return "chunkwise" if chunk == MLSTM_CHUNK else "step"


def mlstm_bwd_scratch(b: int, s: int, h: int, d: int, window: int) -> int:
    """Floats of scratch the chunkwise backward takes with ``window``
    chunks of chunk-end gradients (``mlstm_scan_backward_chunkwise`` lays
    it out): the window's gradients of C and n and its in-chunk matrices E
    and A', the carried C and n gradients, nine scalars a step and a
    partial sum a step and a chunk per column tile of
    ``MLSTM_BWD_TILE`` (plus one)."""
    nc = -(-s // MLSTM_CHUNK)
    z1 = -(-d // MLSTM_BWD_TILE) + 1
    w = min(window, nc)
    return (b * w * h * (d * d + d + 2 * MLSTM_CHUNK ** 2)
            + b * h * (d * d + d) + b * s * h * (9 + 2 * z1)
            + b * nc * h * (1 + z1))


def slstm_persistent_smem(b: int, d: int) -> int:
    """Bytes of shared memory a block of the persistent sLSTM forward
    takes (``persistent_floats`` in ``csrc/slstm_scan.cu``): r_w's 32
    columns, h's rows staged (B rounded up to 1, 2, 4 or 8) and the 16
    warps' partial products, d padded to a multiple of 64."""
    rows = 1 if b <= 1 else 2 if b <= 2 else 4 if b <= 4 else 8
    dpad = -(-d // 64) * 64
    return 4 * (dpad * 32 + dpad * rows + 16 * rows * 32)


def slstm_route(b: int, s: int, d: int, sm_count: int) -> str:
    """The sLSTM forward's design for a call on the card, from its shape
    and the card's SM count alone: ``"persistent"``
    (``slstm_scan_forward_persistent``) when S >=
    ``SLSTM_PERSISTENT_MIN_STEPS`` (4), B <= 8, the
    ceil(d / 8) blocks fit one per SM and a block's shared memory
    (``slstm_persistent_smem``) fits ``SMEM_PER_BLOCK``; else ``"step"``
    (``slstm_scan_forward``, a launch a step): a decode step (S = 1),
    which a captured CUDA graph replays as one plain launch, calls of 2
    or 3 steps, and widths whose r_w does not fit on chip (d = 1,640 on
    an H100)."""
    if (s >= SLSTM_PERSISTENT_MIN_STEPS and b <= SLSTM_MAX_ROWS and -(-d // SLSTM_UNITS) <= sm_count
            and slstm_persistent_smem(b, d) <= SMEM_PER_BLOCK):
        return "persistent"
    return "step"


def slstm_bwd_persistent_smem(b: int, d: int) -> int:
    """Bytes of shared memory a block of the persistent sLSTM backward
    takes (``bwd_persistent_floats`` in ``csrc/slstm_scan.cu``): its 8
    units' rows of r_w (4d floats each) and the 16 warps' partial sums of
    8 units x the rows (B rounded up to 1, 2, 4 or 8)."""
    rows = 1 if b <= 1 else 2 if b <= 2 else 4 if b <= 4 else 8
    return 4 * (SLSTM_UNITS * 4 * d + 16 * rows * SLSTM_UNITS)


def slstm_bwd_route(b: int, s: int, d: int, sm_count: int) -> str:
    """The sLSTM backward's design for a call on the card, from its shape
    and the card's SM count alone: ``"persistent"``
    (``slstm_scan_backward_persistent``) when S >=
    ``SLSTM_BWD_PERSISTENT_MIN_STEPS`` (2), B <= 8, the ceil(d / 8) blocks
    fit one per SM and a block's shared memory
    (``slstm_bwd_persistent_smem``) fits ``SMEM_PER_BLOCK``; else
    ``"step"`` (``slstm_scan_backward``, a launch a step): a single step,
    more than 8 rows, and widths beyond 8 units an SM (d = 1,640 on an
    H100)."""
    if (s >= SLSTM_BWD_PERSISTENT_MIN_STEPS and b <= SLSTM_MAX_ROWS
            and -(-d // SLSTM_UNITS) <= sm_count
            and slstm_bwd_persistent_smem(b, d) <= SMEM_PER_BLOCK):
        return "persistent"
    return "step"


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, c0: torch.Tensor,
               n0: torch.Tensor, m0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The mLSTM recurrence over a sequence (``ref.mlstm_scan_ref``), f32:
    q, k, v (B, S, H, D); log_i, log_f (B, S, H); carries C0 (B, H, D, D),
    n0 (B, H, D), m0 (B, H).  Returns y (B, S, H, D) and the last C, n, m.
    A forward that autograd records saves checkpoints every
    ``MLSTM_CHUNK`` steps."""
    chunk = MLSTM_CHUNK if _needs_grad(q, k, v, log_i, log_f) else 0
    return _MLSTM(q, k, v, log_i, log_f, c0, n0, m0, chunk)[:4]


def slstm_scan(pre_x: torch.Tensor, r_w: torch.Tensor, c0: torch.Tensor,
               n0: torch.Tensor, m0: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """The sLSTM recurrence over a sequence (``ref.slstm_scan_ref``), f32:
    pre_x (B, S, 4d), r_w (d, 4d), carries (B, d).  Returns y (B, S, d)
    (the h sequence) and the last c, n, m, h.  A forward that autograd
    records saves every step's pre-activations and c, n, m."""
    save = _needs_grad(pre_x, r_w)
    return _SLSTM(pre_x, r_w, c0, n0, m0, h0, save)[:5]


def _f32(name: str, *ts) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the recurrence runs in float32, got "
                             f"{t.dtype}")


def _empty(ref: torch.Tensor, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=ref.device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_shapes(q, k, v, log_i, log_f, c0, n0, m0):
    b, s, h, d = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or log_i.shape != (b, s, h) or log_f.shape != (b, s, h)
            or c0.shape != (b, h, d, d) or n0.shape != (b, h, d)
            or m0.shape != (b, h)):
        raise ValueError(f"{MLSTM}: inconsistent shapes q {tuple(q.shape)}, "
                         f"gates {tuple(log_i.shape)}, carries "
                         f"{tuple(c0.shape)} {tuple(n0.shape)} "
                         f"{tuple(m0.shape)}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{MLSTM}: head_dim must be in [1, {MAX_HEAD_DIM}],"
                         f" got {d}")
    return b, s, h, d


def _mlstm_out_shapes(b, s, h, d, chunk):
    nc = -(-s // chunk) if chunk else 0
    return ((b, s, h, d), (b, h, d, d), (b, h, d), (b, h),
            (b, nc, h, d, d), (b, nc, h, d), (b, s if chunk else 0, h),
            (b, s if chunk else 0, h))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned address (a contiguous
    view may start anywhere; the chunkwise kernels copy 16 bytes at a
    time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mlstm_cuda(q, k, v, log_i, log_f, c0, n0, m0, chunk):
    ins = [t.contiguous() for t in (q, k, v, log_i, log_f, c0, n0, m0)]
    _lib.check_cuda(MLSTM, *ins)
    _f32(MLSTM, *ins)
    b, s, h, d = _mlstm_shapes(*ins)
    if s == 0:
        raise ValueError(f"{MLSTM}: empty sequence")
    return mlstm_forward(mlstm_route(b, s, h, d, chunk), *ins, chunk)


def mlstm_forward(route: str, q, k, v, log_i, log_f, c0, n0, m0,
                  chunk: int) -> Tuple[torch.Tensor, ...]:
    """Launch the mLSTM forward design ``route`` ("chunkwise" or
    "one_pass") on checked, contiguous f32 CUDA inputs; the operator's
    CUDA body calls it with ``mlstm_route``'s choice (``chip_smoke.py``
    also times the one-pass design at prefill shapes)."""
    ins = [q, k, v, log_i, log_f, c0, n0, m0]
    b, s, h, d = q.shape
    outs = [_empty(q, *sh) for sh in _mlstm_out_shapes(b, s, h, d, chunk)]
    with torch.cuda.device(q.device):
        if route == "one_pass":
            _lib.launch(MLSTM, "mlstm_scan_forward", MLSTM,
                        *map(_lib.ptr, ins + outs), b, s, h, d, int(chunk))
            return tuple(outs)
        if route != "chunkwise":
            raise ValueError(f"{MLSTM}: no forward design {route!r}")
        if d % 4 or chunk not in (0, MLSTM_CHUNK):
            raise ValueError(f"{MLSTM}: the chunkwise forward takes D a "
                             f"multiple of 4 and chunk 0 or {MLSTM_CHUNK}, "
                             f"got D {d}, chunk {chunk}")
        nc = -(-s // MLSTM_CHUNK)
        if chunk:
            window = nc
            states = outs[4:8]          # ckC, ckn, ms, ss
        else:
            # the chunk states of one window at a time: bounded scratch
            window = mlstm_window(b, h, d)
            w = min(nc, window)
            states = [_empty(q, b, w, h, d, d), _empty(q, b, w, h, d),
                      _empty(q, b, s, h)]
            states.append(states[2])    # ss: not written
        # the kernels' scratch: F and g a step, a decay a chunk
        scratch = _empty(q, (2 * s + nc) * b * h)
        _lib.launch(MLSTM, "mlstm_scan_forward_chunkwise", MLSTM_CHUNKWISE,
                    *map(_lib.ptr, [_aligned(t) for t in ins] + outs[:4]
                         + states + [scratch]),
                    b, s, h, d, int(bool(chunk)), window)
    return tuple(outs)


def _mlstm_cpu(q, k, v, log_i, log_f, c0, n0, m0, chunk):
    _f32(MLSTM, q, k, v, log_i, log_f, c0, n0, m0)
    _mlstm_shapes(q, k, v, log_i, log_f, c0, n0, m0)
    return mlstm_scan_ref(q, k, v, log_i, log_f, c0, n0, m0, chunk)


def _mlstm_fake(q, k, v, log_i, log_f, c0, n0, m0, chunk):
    b, s, h, d = q.shape
    return tuple(q.new_empty(sh, dtype=torch.float32)
                 for sh in _mlstm_out_shapes(b, s, h, d, chunk))


def mlstm_flops(b, s, h, d, backward=False) -> int:
    return 2 * b * s * h * ((6 * d * d + 3 * d) if backward
                            else (2 * d * d + d))


def _mlstm_flops(q, *_, **__):
    return mlstm_flops(*q)


def _mlstm_rules(q, k, v, log_i, log_f, c0, n0, m0, chunk):
    """Batch: dim 0 everywhere; heads: dim 2 of the sequences and the
    saved tensors, dim 1 of the carries."""
    return placement_rules((q, k, v, log_i, log_f, c0, n0, m0, chunk), [
        ((0,) * 8, (0,) * 8 + (None,)),
        ((2, 1, 1, 1, 2, 2, 2, 2), (2,) * 5 + (1, 1, 1, None))])


_MLSTM = define(
    MLSTM,
    "(Tensor q, Tensor k, Tensor v, Tensor log_i, Tensor log_f, Tensor C0, "
    "Tensor n0, Tensor m0, int chunk) -> (Tensor, Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor)",
    _mlstm_cuda, _mlstm_cpu, _mlstm_fake, _mlstm_flops, _mlstm_rules)


def _mlstm_bwd_cuda(dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y,
                    chunk):
    ins = [t.contiguous() for t in (dy, q, k, v, log_i, log_f, m0, ck_c,
                                    ck_n, ms, ss, y)]
    _lib.check_cuda(MLSTM_BWD, *ins)
    _f32(MLSTM_BWD, *ins)
    b, s, h, d = q.shape
    if chunk < 1 or ck_c.shape != (b, -(-s // chunk), h, d, d):
        raise ValueError(f"{MLSTM_BWD}: checkpoints {tuple(ck_c.shape)} do "
                         f"not fit chunk {chunk}")
    return mlstm_backward(mlstm_bwd_route(b, s, h, d, chunk), *ins, chunk)


def mlstm_backward(route: str, dy, q, k, v, log_i, log_f, m0, ck_c, ck_n,
                   ms, ss, y, chunk: int) -> Tuple[torch.Tensor, ...]:
    """Launch the mLSTM backward design ``route`` ("chunkwise" or "step")
    on checked, contiguous f32 CUDA inputs; the operator's CUDA body calls
    it with ``mlstm_bwd_route``'s choice (``chip_smoke.py`` also times the
    step design on the same inputs).  Returns (dq, dk, dv, dlog_i,
    dlog_f)."""
    ins = [dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y]
    b, s, h, d = q.shape
    if route == "step" and d > MLSTM_BWD_STEP_MAX_D:
        raise ValueError(f"{MLSTM_BWD}: the step backward takes D up to "
                         f"{MLSTM_BWD_STEP_MAX_D}, got {d}")
    if route == "chunkwise":
        if chunk != MLSTM_CHUNK:
            raise ValueError(f"{MLSTM_BWD}: the chunkwise backward takes "
                             f"chunk {MLSTM_CHUNK}, got {chunk}")
        if d % 4:
            return _mlstm_bwd_padded(*ins, chunk)
    elif route != "step":
        raise ValueError(f"{MLSTM_BWD}: no backward design {route!r}")
    outs = [torch.empty_like(x) for x in (q, k, v, log_i, log_f)]
    with torch.cuda.device(q.device):
        if route == "step":
            nb = -(-d // MLSTM_BWD_ROWS)
            dp = -(-d // 32) * 32
            scratch = [_empty(q, b * h * nb, chunk + 1, MLSTM_BWD_ROWS, dp),
                       _empty(q, b * h * nb, chunk + 1, dp),
                       _empty(q, b, s, h, nb, d), _empty(q, b, s, h, nb, d),
                       _empty(q, b, s, h, nb), _empty(q, b, s, h, nb),
                       _empty(q, b, s, h), _empty(q, b, s, h)]
            _lib.launch(MLSTM, "mlstm_scan_backward", MLSTM_BWD,
                        *map(_lib.ptr, ins + outs + scratch),
                        b, s, h, d, int(chunk), MLSTM_BWD_ROWS)
            return tuple(outs)
        # the chunk-end gradients of one window at a time: bounded scratch
        window = min(-(-s // MLSTM_CHUNK), mlstm_window(b, h, d))
        scratch = _empty(q, mlstm_bwd_scratch(b, s, h, d, window))
        _lib.launch(MLSTM, "mlstm_scan_backward_chunkwise",
                    MLSTM_BWD_CHUNKWISE,
                    *map(_lib.ptr, [_aligned(t) for t in ins] + outs
                         + [scratch]),
                    b, s, h, d, window)
    return tuple(outs)


def _mlstm_bwd_padded(dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y,
                      chunk):
    """The chunkwise backward at a D that is no multiple of 4 (its kernels
    copy 16 bytes at a time): every D-wide input zero-padded to the next
    multiple of 4.  The padded columns of k, v and q keep the padded rows
    and columns of every C and n zero, so s, den and y are unchanged and
    the gradients of the real columns are exact; the padded ones are
    dropped."""
    d = q.shape[-1]
    p = -d % 4

    def pad(t, dims=1):
        return torch.nn.functional.pad(t, (0, p) * dims)

    dq, dk, dv, dli, dlf = mlstm_backward(
        "chunkwise", pad(dy), pad(q), pad(k), pad(v), log_i, log_f, m0,
        pad(ck_c, 2), pad(ck_n), ms, ss, pad(y), chunk)
    return (dq[..., :d].contiguous(), dk[..., :d].contiguous(),
            dv[..., :d].contiguous(), dli, dlf)


def _mlstm_bwd_cpu(dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y,
                   chunk):
    return mlstm_scan_backward_ref(dy, q, k, v, log_i, log_f, ck_c[:, 0],
                                   ck_n[:, 0], m0)


def _mlstm_bwd_fake(dy, q, k, v, log_i, log_f, *_):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(log_i), torch.empty_like(log_f))


def _mlstm_bwd_rules(dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y,
                     chunk):
    args = (dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y, chunk)
    return placement_rules(args, [
        ((0,) * 5, (0,) * 12 + (None,)),
        ((2,) * 5, (2,) * 6 + (1,) + (2,) * 5 + (None,))])


_MLSTM_BWD = define(
    MLSTM_BWD,
    "(Tensor dy, Tensor q, Tensor k, Tensor v, Tensor log_i, Tensor log_f, "
    "Tensor m0, Tensor ckC, Tensor ckn, Tensor ms, Tensor ss, Tensor y, "
    "int chunk) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _mlstm_bwd_cuda, _mlstm_bwd_cpu, _mlstm_bwd_fake,
    lambda dy, q, *_, **__: mlstm_flops(*q, backward=True),
    _mlstm_bwd_rules)


def _refuse_carry_grads(name, carries, grads) -> None:
    if any(t.requires_grad for t in carries):
        raise ValueError(f"{name}: the carries are the recurrence's "
                         f"starting state and take no gradient")
    if any(g is not None for g in grads):
        raise ValueError(f"{name}: a gradient reached a final carry; only "
                         f"the output sequence is differentiated")


def _mlstm_setup(ctx, inputs, output):
    q, k, v, log_i, log_f, c0, n0, m0, chunk = inputs
    _refuse_carry_grads(MLSTM, (c0, n0, m0), ())
    y, _, _, _, ck_c, ck_n, ms, ss = output
    ctx.chunk = chunk
    ctx.set_materialize_grads(False)
    ctx.mark_non_differentiable(ck_c, ck_n, ms, ss)
    ctx.save_for_backward(q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y)


def _mlstm_backward(ctx, dy, dc, dn, dm, *_):
    _refuse_carry_grads(MLSTM, (), (dc, dn, dm))
    if ctx.chunk < 1:
        raise RuntimeError(f"{MLSTM}: the forward saved no checkpoints")
    q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y = ctx.saved_tensors
    if dy is None:
        return (None,) * 9
    grads = _MLSTM_BWD(dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y,
                       ctx.chunk)
    return (*grads, None, None, None, None)


_MLSTM.register_autograd(_mlstm_backward, setup_context=_mlstm_setup)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_shapes(pre_x, r_w, c0, n0, m0, h0):
    b, s, g = pre_x.shape
    d = r_w.shape[0]
    if (g != 4 * d or r_w.shape != (d, 4 * d)
            or any(t.shape != (b, d) for t in (c0, n0, m0, h0))):
        raise ValueError(f"{SLSTM}: inconsistent shapes pre_x "
                         f"{tuple(pre_x.shape)}, r_w {tuple(r_w.shape)}, "
                         f"carries {tuple(c0.shape)}")
    return b, s, d


def _slstm_out_shapes(b, s, d, save):
    s2 = s if save else 0
    return ((b, s, d), (b, d), (b, d), (b, d), (b, d), (b, s2, 4 * d),
            (b, s2, d), (b, s2, d), (b, s2, d))


def _slstm_cuda(pre_x, r_w, c0, n0, m0, h0, save):
    ins = [t.contiguous() for t in (pre_x, r_w, c0, n0, m0, h0)]
    dev = _lib.check_cuda(SLSTM, *ins)
    _f32(SLSTM, *ins)
    b, s, d = _slstm_shapes(*ins)
    if s == 0:
        raise ValueError(f"{SLSTM}: empty sequence")
    return slstm_forward(slstm_route(b, s, d, _sm_count(dev)), *ins, save)


def slstm_forward(route: str, pre_x, r_w, c0, n0, m0, h0,
                  save: bool) -> Tuple[torch.Tensor, ...]:
    """Launch the sLSTM forward design ``route`` ("persistent" or "step")
    on checked, contiguous f32 CUDA inputs; the operator's CUDA body calls
    it with ``slstm_route``'s choice (``chip_smoke.py`` also times the
    step design at prefill shapes).  The persistent kernel refuses a grid
    that cannot be co-resident: that raises."""
    b, s, _ = pre_x.shape
    d = r_w.shape[0]
    outs = [_empty(pre_x, *sh) for sh in _slstm_out_shapes(b, s, d, save)]
    args = [pre_x, r_w, c0, n0, m0, h0] + outs
    with torch.cuda.device(pre_x.device):
        if route == "step":
            _lib.launch(SLSTM, "slstm_scan_forward", SLSTM,
                        *map(_lib.ptr, args), b, s, d, int(save))
        elif route == "persistent":
            arrived = torch.empty(1, dtype=torch.int32, device=pre_x.device)
            _lib.launch(SLSTM, "slstm_scan_forward_persistent",
                        SLSTM_PERSISTENT, *map(_lib.ptr, args + [arrived]),
                        b, s, d, int(save))
        else:
            raise ValueError(f"{SLSTM}: no forward design {route!r}")
    return tuple(outs)


def _slstm_cpu(pre_x, r_w, c0, n0, m0, h0, save):
    _f32(SLSTM, pre_x, r_w, c0, n0, m0, h0)
    _slstm_shapes(pre_x, r_w, c0, n0, m0, h0)
    return slstm_scan_ref(pre_x, r_w, c0, n0, m0, h0, save)


def _slstm_fake(pre_x, r_w, c0, n0, m0, h0, save):
    b, s, _ = pre_x.shape
    return tuple(pre_x.new_empty(sh, dtype=torch.float32)
                 for sh in _slstm_out_shapes(b, s, r_w.shape[0], save))


def slstm_flops(b, s, d, backward=False) -> int:
    return (4 if backward else 2) * b * s * d * 4 * d


def _slstm_rules(pre_x, r_w, c0, n0, m0, h0, save):
    """Batch only: r_w stays replicated."""
    return placement_rules((pre_x, r_w, c0, n0, m0, h0, save), [
        ((0,) * 9, (0, None, 0, 0, 0, 0, None))])


_SLSTM = define(
    SLSTM,
    "(Tensor pre_x, Tensor r_w, Tensor c0, Tensor n0, Tensor m0, Tensor h0, "
    "bool save) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor, Tensor)",
    _slstm_cuda, _slstm_cpu, _slstm_fake,
    lambda pre_x, r_w, *_, **__: slstm_flops(pre_x[0], pre_x[1], r_w[0]),
    _slstm_rules)


def _slstm_bwd_cuda(dy, pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms, y):
    ins = [t.contiguous() for t in (dy, r_w, pres, cs, ns, ms, c0, n0, m0)]
    dev = _lib.check_cuda(SLSTM_BWD, *ins, h0.contiguous(), y.contiguous())
    _f32(SLSTM_BWD, *ins, h0, y)
    b, s, d = dy.shape
    if pres.shape != (b, s, 4 * d):
        raise ValueError(f"{SLSTM_BWD}: the forward saved no steps")
    return slstm_backward(slstm_bwd_route(b, s, d, _sm_count(dev)), *ins,
                          h0.contiguous(), y.contiguous())


def slstm_backward(route: str, dy, r_w, pres, cs, ns, ms, c0, n0, m0, h0,
                   y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sLSTM backward design ``route`` ("persistent" or
    "step") on checked, contiguous f32 CUDA inputs (the recorded forward's
    saved tensors and output); the operator's CUDA body calls it with
    ``slstm_bwd_route``'s choice (``chip_smoke.py`` also times the step
    design on the same inputs).  The persistent kernel refuses more than 8
    rows or a grid that cannot be co-resident: that raises.  Returns
    (dpre_x, dr_w)."""
    b, s, d = dy.shape
    dpre = torch.empty_like(pres)
    args = [dy, r_w, pres, cs, ns, ms, c0, n0, m0, dpre]
    with torch.cuda.device(dy.device):
        if route == "step":
            carries = _empty(dy, 3, b, d)
            _lib.launch(SLSTM, "slstm_scan_backward", SLSTM_BWD,
                        *map(_lib.ptr, args + [carries]), b, s, d)
        elif route == "persistent":
            arrived = torch.empty(1, dtype=torch.int32, device=dy.device)
            _lib.launch(SLSTM, "slstm_scan_backward_persistent",
                        SLSTM_BWD_PERSISTENT,
                        *map(_lib.ptr, args + [arrived]), b, s, d)
        else:
            raise ValueError(f"{SLSTM_BWD}: no backward design {route!r}")
    h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
    d_rw = h_prev.reshape(b * s, d).T @ dpre.reshape(b * s, 4 * d)
    return dpre, d_rw


def _slstm_bwd_cpu(dy, pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms, y):
    return slstm_scan_backward_ref(dy, pre_x, r_w, c0, n0, m0, h0)


def _slstm_bwd_rules(dy, pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms, y):
    """Batch only: dpre_x follows the batch, dr_w is a partial sum over
    the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    args = (dy, pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms, y)
    rules = [([Replicate(), Replicate()], [Replicate()] * len(args))]
    if _splits(dy, 0):
        rules.append(([Shard(0), Partial()],
                      [Shard(0), Shard(0), Replicate()]
                      + [Shard(0)] * (len(args) - 3)))
    return rules


_SLSTM_BWD = define(
    SLSTM_BWD,
    "(Tensor dy, Tensor pre_x, Tensor r_w, Tensor c0, Tensor n0, Tensor m0, "
    "Tensor h0, Tensor pres, Tensor cs, Tensor ns, Tensor ms, Tensor y) -> "
    "(Tensor, Tensor)",
    _slstm_bwd_cuda, _slstm_bwd_cpu,
    lambda dy, pre_x, r_w, *_: (torch.empty_like(pre_x),
                                torch.empty_like(r_w)),
    lambda dy, pre_x, r_w, *_, **__: slstm_flops(dy[0], dy[1], dy[2],
                                                 backward=True),
    _slstm_bwd_rules)


def _slstm_setup(ctx, inputs, output):
    pre_x, r_w, c0, n0, m0, h0, save = inputs
    _refuse_carry_grads(SLSTM, (c0, n0, m0, h0), ())
    y, _, _, _, _, pres, cs, ns, ms = output
    ctx.save = save
    ctx.set_materialize_grads(False)
    ctx.mark_non_differentiable(pres, cs, ns, ms)
    ctx.save_for_backward(pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms, y)


def _slstm_backward(ctx, dy, dc, dn, dm, dh, *_):
    _refuse_carry_grads(SLSTM, (), (dc, dn, dm, dh))
    if not ctx.save:
        raise RuntimeError(f"{SLSTM}: the forward saved no steps")
    pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms, y = ctx.saved_tensors
    if dy is None:
        return (None,) * 7
    dpre, d_rw = _SLSTM_BWD(dy, pre_x, r_w, c0, n0, m0, h0, pres, cs, ns, ms,
                            y)
    return dpre, d_rw, None, None, None, None, None


_SLSTM.register_autograd(_slstm_backward, setup_context=_slstm_setup)
