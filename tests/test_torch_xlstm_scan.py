"""The xLSTM scan operators (``kernels/xlstm_scan.py``) against JAX's
``lax.scan`` recurrences.

``repro_torch::mlstm_scan`` and ``slstm_scan`` run their plain CPU bodies
here (the CUDA kernels are held to the same plain versions on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  JAX's side is its
own scan ``step``: ``jax.lax.scan`` is wrapped while JAX's
``mlstm_apply``/``slstm_apply`` runs, and the wrapper runs the captured
step over this test's carries and inputs (the sLSTM's step closes over
the traced ``r_gates``), so ``jax.vjp`` differentiates exactly JAX's
recurrence.  Inputs are made from a numpy seed at B 2, S 7, H 2 heads of
D 16 (mLSTM), d 32 (sLSTM), with the carries fresh (zeros, m = -1e30, as
in training), random (m finite, as after some steps) and with one row
blanked (zeros and m = 0, the state an evicted decode slot leaves).

Checked: outputs and final carries, the gradients of y with respect to
q, k, v, log_i, log_f (mLSTM) and pre_x, r_w (sLSTM) through the
registered backward operators, two chunks against one pass, the
checkpoints the recorded forward saves, ``torch.library.opcheck`` for the
four operators, the flop formulas against a hand count, ``meta`` tensors
(shapes, no ``ctypes``) and the refusal of gradients for the carries.

Tolerance: STATE_TOL 1e-5 (absolute and relative; both sides step the
same f32 recurrence in the same order, only the reductions of C q, n . q
and h r_w sum in another order).

The chunkwise form of the mLSTM forward (the card's
``mlstm_scan_forward_chunkwise``) has a CPU oracle here,
``chunkwise_mlstm``: the same arithmetic as the kernels in plain PyTorch
(the exact sequential m, the chunk weights, the intra- and inter-chunk
parts, the chunk states as checkpoints), used by no path of the port.  It
is held to JAX's own scan step and to ``ref.mlstm_scan_ref``'s recorded
tensors over S in {1, 7, 31, 32, 33, 70} and chunks of 4 and 32 steps.
The chunkwise form of the mLSTM backward (``mlstm_scan_backward_chunkwise``)
has one too, ``chunkwise_mlstm_backward``: the reverse chain of
chunk-end gradients, the in-chunk matrices and the m reverse, from what
the recorded forward saves, held to ``jax.vjp`` of JAX's scan step and to
``ref.mlstm_scan_backward_ref`` over the same grid (JAX's forward and vjp
are computed once per carry and S for both oracles), and stands in for the
kernel to check the wrapper's zero-padding of a D that is no multiple of
4.  The route rules of both forwards and of both backwards are held to
their stated conditions, the persistent sLSTM backward's shared-memory
count to a hand count, and the sLSTM backward operator's CUDA body to
handing its saved tensors to the design its route names (with stand-ins
for the card's checks and launch).  About 42 s on one worker (~10 s before the
oracles' 72 cases, ~12 s of it the backward oracle's, most of the rest
JAX's scan and its vjp at six sequence lengths).
"""
import functools
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jax_configs
from repro.models import layers as JL
from repro_torch.kernels import _lib, ref
from repro_torch.kernels import xlstm_scan as X

STATE_TOL = dict(atol=1e-5, rtol=1e-5)
B, S, H, D, DM = 2, 7, 2, 16, 32
JCFG = dataclasses.replace(jax_configs.get("xlstm-350m"), d_model=DM,
                           n_heads=H, n_kv_heads=H, head_dim=D)
CARRIES = ("fresh", "random", "blanked")


def _mlstm_inputs(seed, carry, s=S, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, H, d)).astype(np.float32) / 4
               for _ in range(3))
    log_i = rng.standard_normal((B, s, H)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal((B, s, H))
                                   - 2))).astype(np.float32)
    c0 = rng.standard_normal((B, H, d, d)).astype(np.float32)
    n0 = rng.standard_normal((B, H, d)).astype(np.float32)
    m0 = rng.standard_normal((B, H)).astype(np.float32)
    if carry == "fresh":
        c0[:], n0[:], m0[:] = 0, 0, -1e30
    elif carry == "blanked":
        c0[1], n0[1], m0[1] = 0, 0, 0
    return (q, k, v, log_i, log_f), (c0, n0, m0)


def _slstm_inputs(seed, carry, s=S):
    rng = np.random.default_rng(seed)
    pre_x = rng.standard_normal((B, s, 4 * DM)).astype(np.float32)
    r_w = (0.1 * rng.standard_normal((DM, 4 * DM))).astype(np.float32)
    c0 = rng.standard_normal((B, DM)).astype(np.float32)
    n0 = (np.abs(rng.standard_normal((B, DM))) + 0.5).astype(np.float32)
    m0 = rng.standard_normal((B, DM)).astype(np.float32)
    h0 = rng.standard_normal((B, DM)).astype(np.float32)
    if carry == "fresh":
        c0[:], n0[:], m0[:], h0[:] = 0, 0, -1e30, 0
    elif carry == "blanked":
        c0[1], n0[1], m0[1], h0[1] = 0, 0, 0, 0
    return (pre_x, r_w), (c0, n0, m0, h0)


def _jax_scan(apply, params, carries, xs_of, *seqs):
    """Run JAX's ``apply`` (``mlstm_apply``/``slstm_apply``) with
    ``jax.lax.scan`` wrapped: its step runs over ``carries`` and the
    sequences ``xs_of(*seqs)`` (time-major).  Returns (final carries,
    ys) of that scan."""
    real, out = jax.lax.scan, {}

    def spy(step, init, xs):
        out["res"] = real(step, tuple(jnp.asarray(c) for c in carries),
                          xs_of(*seqs))
        return out["res"]

    keys = ("C", "n", "m") if apply is JL.mlstm_apply else ("c", "n", "m",
                                                            "h")
    x = jnp.zeros((B, seqs[0].shape[1], DM), jnp.float32)
    jax.lax.scan = spy
    try:
        apply(JCFG, params, x, state=dict(zip(keys, map(jnp.asarray,
                                                        carries))),
              mode="prefill")
    finally:
        jax.lax.scan = real
    return out["res"]


def jax_mlstm(carries, q, k, v, log_i, log_f):
    params = JL.init_mlstm(JCFG, jax.random.PRNGKey(0), jnp.float32)
    (c, n, m), ys = _jax_scan(
        JL.mlstm_apply, params, carries,
        lambda *xs: tuple(jnp.swapaxes(a, 0, 1) for a in xs),
        q, k, v, log_i, log_f)
    return jnp.swapaxes(ys, 0, 1), c, n, m


def jax_slstm(carries, pre_x, r_w):
    params = JL.init_slstm(JCFG, jax.random.PRNGKey(0), jnp.float32)
    params = dict(params, r_gates=r_w)
    (c, n, m, h), ys = _jax_scan(JL.slstm_apply, params, carries,
                                 lambda px: jnp.swapaxes(px, 0, 1), pre_x)
    return jnp.swapaxes(ys, 0, 1), c, n, m, h


def _t(xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **STATE_TOL)


@pytest.mark.parametrize("carry", CARRIES)
def test_mlstm_scan_and_grads_vs_jax(carry):
    """Outputs, final carries and ``jax.vjp``'s gradients of y."""
    seqs, carries = _mlstm_inputs(0, carry)
    want, vjp = jax.vjp(lambda *a: jax_mlstm(carries, *a), *seqs)
    ins = _t(seqs, grad=True)
    got = X.mlstm_scan(*ins, *_t(carries))
    _close(got, want)
    dy = np.random.default_rng(1).standard_normal(want[0].shape).astype(
        np.float32)
    want_g = vjp((jnp.asarray(dy),) + tuple(jnp.zeros_like(w)
                                           for w in want[1:]))
    _close(torch.autograd.grad(got[0], ins, torch.tensor(dy)), want_g)


@pytest.mark.parametrize("carry", CARRIES)
def test_slstm_scan_and_grads_vs_jax(carry):
    seqs, carries = _slstm_inputs(0, carry)
    want, vjp = jax.vjp(lambda *a: jax_slstm(carries, *a), *seqs)
    ins = _t(seqs, grad=True)
    got = X.slstm_scan(*ins, *_t(carries))
    _close(got, want)
    dy = np.random.default_rng(1).standard_normal(want[0].shape).astype(
        np.float32)
    want_g = vjp((jnp.asarray(dy),) + tuple(jnp.zeros_like(w)
                                           for w in want[1:]))
    _close(torch.autograd.grad(got[0], ins, torch.tensor(dy)), want_g)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_two_chunks_equal_one_pass(block):
    """Steps 0-2 then 3-6, the carries handed over, equal one pass."""
    if block == "mlstm":
        seqs, carries = _mlstm_inputs(2, "random")
        fn, n_seq = X.mlstm_scan, 5
    else:
        seqs, carries = _slstm_inputs(2, "random")
        fn, n_seq = X.slstm_scan, 1
    seqs = _t(seqs)
    one = fn(*seqs, *_t(carries))
    first = fn(*[x[:, :3] for x in seqs[:n_seq]], *seqs[n_seq:],
               *_t(carries))
    second = fn(*[x[:, 3:] for x in seqs[:n_seq]], *seqs[n_seq:],
                *first[1:])
    _close([torch.cat([first[0], second[0]], 1)] + list(second[1:]),
           [o.numpy() for o in one])


def test_recorded_forward_saves_checkpoints_and_steps():
    """chunk 3 over 7 steps: the carries before steps 0, 3, 6 and every
    step's m and n . q, as the plain loop steps them; chunk 0 saves
    nothing.  The sLSTM's save keeps every step's pre-activations and c,
    n, m."""
    seqs, carries = _mlstm_inputs(3, "random")
    ins = _t(seqs) + _t(carries)
    out = X._MLSTM(*ins, 3)
    assert out[4].shape == (B, 3, H, D, D) and out[6].shape == (B, S, H)
    for j, t in enumerate((0, 3, 6)):
        if t == 0:
            c, n = ins[5], ins[6]
        else:
            _, c, n, m = ref.mlstm_scan_ref(*[x[:, :t] for x in ins[:5]],
                                            *ins[5:])[:4]
            assert torch.equal(out[6][:, t - 1], m)
        assert torch.equal(out[4][:, j], c) and torch.equal(out[5][:, j], n)
    bare = X._MLSTM(*ins, 0)
    assert [tuple(o.shape) for o in bare[4:]] == [
        (B, 0, H, D, D), (B, 0, H, D), (B, 0, H), (B, 0, H)]
    for a, b in zip(bare[:4], out[:4]):
        assert torch.equal(a, b)
    seqs, carries = _slstm_inputs(3, "random")
    out = X._SLSTM(*_t(seqs), *_t(carries), True)
    assert [tuple(o.shape) for o in out[5:]] == [
        (B, S, 4 * DM), (B, S, DM), (B, S, DM), (B, S, DM)]
    assert torch.equal(out[6][:, -1], out[1])
    assert torch.equal(out[8][:, -1], out[3])


def _op_args():
    """Arguments of the four operators (the backward ones from a recorded
    forward)."""
    seqs, carries = _mlstm_inputs(4, "random")
    m_ins = _t(seqs) + _t(carries)
    y, _, _, _, ck_c, ck_n, ms, ss = X._MLSTM(*m_ins, 3)
    dy = torch.randn_like(y)
    seqs, carries = _slstm_inputs(4, "random")
    s_ins = _t(seqs) + _t(carries)
    sy, _, _, _, _, pres, cs, ns, sm = X._SLSTM(*s_ins, True)
    return {
        X._MLSTM: m_ins + [3],
        X._MLSTM_BWD: [dy] + m_ins[:5] + [m_ins[7], ck_c, ck_n, ms, ss, y,
                                           3],
        X._SLSTM: s_ins + [True],
        X._SLSTM_BWD: [torch.randn_like(sy)] + s_ins + [pres, cs, ns, sm,
                                                         sy]}


def test_opcheck_the_four_operators():
    for op, args in _op_args().items():
        if op in (X._MLSTM, X._SLSTM):
            args = [a.clone().requires_grad_(i < (5 if op is X._MLSTM
                                                 else 2))
                    if torch.is_tensor(a) else a
                    for i, a in enumerate(args)]
        torch.library.opcheck(op, tuple(args), test_utils=(
            "test_schema", "test_autograd_registration", "test_faketensor"))


def test_backward_ops_equal_the_plain_reverse_and_autograd():
    """The backward operators' CPU bodies are the explicit reverse loops
    of ``ref``, which equal autograd through the plain forward."""
    args = _op_args()
    a = args[X._MLSTM_BWD]
    got = X._MLSTM_BWD(*a)
    ins = [x.clone().requires_grad_() for x in a[1:6]]
    y = ref.mlstm_scan_ref(*ins, a[7][:, 0], a[8][:, 0], a[6])[0]
    _close(got, [g.numpy() for g in torch.autograd.grad(y, ins, a[0])])
    a = args[X._SLSTM_BWD]
    got = X._SLSTM_BWD(*a)
    ins = [x.clone().requires_grad_() for x in a[1:3]]
    y = ref.slstm_scan_ref(*ins, *a[3:7])[0]
    _close(got, [g.numpy() for g in torch.autograd.grad(y, ins, a[0])])


def test_flop_formulas_count_by_hand():
    """2 flops per multiply-add of the products: mLSTM forward C q, v k^T
    and n . q per (b, t, h): 2 (2 D^2 + D); backward 2 (6 D^2 + 3 D);
    sLSTM forward h r_w per (b, t): 2 d 4d; backward twice that."""
    want = {X._MLSTM: B * S * H * 2 * (2 * 16 * 16 + 16),        # 29,568
            X._MLSTM_BWD: B * S * H * 2 * (6 * 16 * 16 + 48),    # 88,704
            X._SLSTM: B * S * 2 * 32 * 128,                       # 114,688
            X._SLSTM_BWD: B * S * 4 * 32 * 128}                   # 229,376
    assert list(want.values()) == [29568, 88704, 114688, 229376]
    for op, args in _op_args().items():
        with FlopCounterMode(display=False) as fc:
            op(*args)
        assert fc.get_total_flops() == want[op], op


def test_meta_tensors_give_shapes_without_ctypes(monkeypatch):
    def no_ctypes(*a, **k):
        raise AssertionError("a meta call reached the kernel library")

    monkeypatch.setattr(_lib, "lib", no_ctypes)
    for op, args in _op_args().items():
        meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        got = op(*meta)
        for g, w in zip(got, op(*args)):
            assert g.device.type == "meta" and g.shape == w.shape


def test_carry_gradients_raise():
    """A carry that requires grad, or a loss that reaches a final carry,
    raises: the carries are the recurrence's starting state."""
    seqs, carries = _mlstm_inputs(5, "random")
    q, k, v, li, lf = _t(seqs, grad=True)
    c0, n0, m0 = _t(carries)
    with pytest.raises(ValueError, match="take no gradient"):
        X.mlstm_scan(q, k, v, li, lf, c0.requires_grad_(), n0, m0)
    y, c, n, m = X.mlstm_scan(q, k, v, li, lf, c0.detach(), n0, m0)
    with pytest.raises(ValueError, match="final carry"):
        (y.sum() + c.sum()).backward()
    seqs, carries = _slstm_inputs(5, "random")
    pre_x, r_w = _t(seqs, grad=True)
    y, c, n, m, h = X.slstm_scan(pre_x, r_w, *_t(carries))
    with pytest.raises(ValueError, match="final carry"):
        h.sum().backward()


# ---------------------------------------------------------------------------
# The chunkwise mLSTM forward, on the CPU
# ---------------------------------------------------------------------------

def chunkwise_mlstm(q, k, v, log_i, log_f, c0, n0, m0, L):
    """The chunkwise form of the mLSTM forward that
    ``csrc/mlstm_scan.cu``'s chunkwise kernels run, in plain PyTorch (f32),
    with chunks of ``L`` steps.  m_t by JAX's sequential recurrence; F_t
    the running sum of log f within t's chunk.  Per chunk, from the state
    (C, n) and the m before it, m_prev: W_ts = exp(log_i_s + F_t - F_s -
    m_t) for s <= t, decay_t = exp(F_t + m_prev - m_t), A = W o (Q K^T),
    s_t = decay_t n . q_t + sum_s A_ts, den_t = max(|s_t|, exp(-m_t)), y_t =
    (decay_t C q_t + (A V)_t) / den_t; then C = a C + sum_s g_s v_s k_s^T and
    n = a n + sum_s g_s k_s with g_s = W_{last,s}, a = decay_last.  Returns
    what ``ref.mlstm_scan_ref(..., chunk=L)`` returns: (y, C, n, m, ckC,
    ckn, ms, ss), the checkpoints being the chunk states."""
    b, s, h, d = q.shape
    m, ms, fs = m0, [], []
    for t in range(s):
        m = torch.maximum(log_f[:, t] + m, log_i[:, t])
        f = log_f[:, t] if t % L == 0 else f + log_f[:, t]
        ms.append(m)
        fs.append(f)
    ms, fs = torch.stack(ms, 1), torch.stack(fs, 1)         # (B, S, H)
    c, n, m_prev = c0, n0, m0
    ys, ss, ck_c, ck_n = [], [], [], []
    for t0 in range(0, s, L):
        ck_c.append(c)
        ck_n.append(n)
        sl = slice(t0, min(s, t0 + L))
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]           # (B, l, H, D)
        f, mc, ic = fs[:, sl], ms[:, sl], log_i[:, sl]       # (B, l, H)
        ln = f.shape[1]
        ft, mt = f.transpose(1, 2), mc.transpose(1, 2)       # (B, H, l)
        it = ic.transpose(1, 2)
        w = torch.exp(it[:, :, None, :] + ft[:, :, :, None]
                      - ft[:, :, None, :] - mt[:, :, :, None])
        w = torch.where(torch.ones(ln, ln, dtype=torch.bool).tril(), w,
                        torch.zeros(()))
        a = w * torch.einsum("bthd,bshd->bhts", qc, kc)      # (B, H, l, l)
        dec = torch.exp(f + m_prev[:, None] - mc)            # (B, l, H)
        nq = torch.einsum("bhd,bthd->bth", n, qc)
        st = dec * nq + a.sum(-1).transpose(1, 2)
        den = torch.maximum(st.abs(), torch.exp(-mc))
        y_inter = torch.einsum("bhrd,bthd->bthr", c, qc)
        y_intra = torch.einsum("bhts,bshr->bthr", a, vc)
        ys.append((dec[..., None] * y_inter + y_intra) / den[..., None])
        ss.append(st)
        g = torch.exp(ic + f[:, -1:] - f - mc[:, -1:])       # (B, l, H)
        decay = torch.exp(f[:, -1] + m_prev - mc[:, -1])     # (B, H)
        c = (decay[..., None, None] * c
             + torch.einsum("bsh,bshr,bshd->bhrd", g, vc, kc))
        n = decay[..., None] * n + torch.einsum("bsh,bshd->bhd", g, kc)
        m_prev = mc[:, -1]
    return (torch.cat(ys, 1), c, n, ms[:, -1], torch.stack(ck_c, 1),
            torch.stack(ck_n, 1), ms, torch.cat(ss, 1))


@functools.lru_cache(maxsize=None)
def _chunkwise_case(carry, s):
    """Inputs and a dy at S steps with the carry kind, JAX's scan over
    them and ``jax.vjp``'s gradients of its y for that dy (computed once
    per (carry, S) for both chunk lengths and both directions)."""
    seqs, carries = _mlstm_inputs(6, carry, s)
    dy = np.random.default_rng(8).standard_normal((B, s, H, D)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda *a: jax_mlstm(carries, *a), *seqs)
    grads = vjp((jnp.asarray(dy),) + tuple(jnp.zeros_like(w)
                                          for w in want[1:]))
    return (seqs, carries, [np.asarray(w) for w in want], dy,
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("s", [1, 7, 31, 32, 33, 70])
@pytest.mark.parametrize("carry", CARRIES)
def test_chunkwise_mlstm_vs_jax_and_the_recorded_forward(carry, s, chunk):
    """The chunkwise oracle's y and final C, n, m against JAX's scan step,
    and its chunk states, m and s against ``ref.mlstm_scan_ref(...,
    chunk)``'s checkpoints and steps, within STATE_TOL: the chunk weights
    are exponents of sums the sequential form takes as products, so only
    rounding differs (the weights' exponents are <= 0, and m is the same
    sequential recurrence, bit for bit)."""
    seqs, carries, want = _chunkwise_case(carry, s)[:3]
    ins = _t(seqs) + _t(carries)
    got = chunkwise_mlstm(*ins, chunk)
    _close(got[:4], want)
    rec = ref.mlstm_scan_ref(*ins, chunk)
    assert [g.shape for g in got] == [r.shape for r in rec]
    assert torch.equal(got[6], rec[6])                       # m, exactly
    _close(got[4:], [r.numpy() for r in rec[4:]])


# ---------------------------------------------------------------------------
# The chunkwise mLSTM backward, on the CPU
# ---------------------------------------------------------------------------

def chunkwise_mlstm_backward(dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms,
                             ss, y, L):
    """The chunkwise form of the mLSTM backward that
    ``csrc/mlstm_scan.cu``'s ``mlstm_scan_backward_chunkwise`` runs, in
    plain PyTorch (f32), over chunks of ``L`` steps.  It reads only what a
    forward recorded with chunk ``L`` saved: the state before every chunk
    (``ck_c``, ``ck_n``), every step's m and s (``ms``, ``ss``) and y.

    Within chunk j, with x_t = log f'_t and z_s = log i'_s, C_t = dec_t C_j
    + sum_{s<=t} W_ts v_s k_s^T (n alike), dec_t = exp(F_t + m_prev -
    m_t), W_ts = exp(log_i_s + F_t - F_s - m_t), F the sum of log f from
    the chunk's start; the state after the chunk is C_{j+1} = a_j C_j +
    sum_s g_s v_s k_s^T with a_j = dec_last, g_s = W_last,s.  Steps:

    1. Per step (all at once): den = max(|s|, exp(-m)), dden = -(dy .
       y) / den split into ds (to s) and dmg (to m, through exp(-m)), half
       each at a tie; dnum = dy / den.
    2. The reverse chain of chunk-end gradients, the only sequential part
       (one step a chunk): G_j = dC_{j+1} arrives at chunk j's end, dC_j =
       a_j G_j + sum_t dec_t dnum_t q_t^T, dn_j = a_j dn_{j+1} + sum_t dec_t
       ds_t q_t.
    3. Every chunk at once: X_ts = dnum_t . v_s + ds_t, A = W o (Q K^T), E =
       W o X, R = A o X; U_t = C_j^T dnum_t, VG_s = G_j^T v_s;
       dq_t = dec_t (U_t + ds_t n_j) + sum_s E_ts k_s;
       dk_s = g_s (VG_s + dn_{j+1}) + sum_t E_ts q_t;
       dv_s = g_s G_j k_s + sum_t A_ts dnum_t;
       the decays' terms Delta_t = dec_t (U_t . q_t + ds_t n_j . q_t),
       Delta_out = a_j (<G_j, C_j> + dn_{j+1} . n_j) and the state weights'
       Rout_s = g_s (VG_s . k_s + dn_{j+1} . k_s) give the gradients of the
       log gates: d z_s = sum_{t>=s} R_ts + Rout_s and d x_r = sum_{t>=r}
       Delta_t + Delta_out + sum_{t>=r, s<r} R_ts + sum_{s<r} Rout_s (x_r
       is in F_t for t >= r: in dec_t, in W_ts for s < r <= t, in a_j and
       in g_s for s < r).
    4. The scalar reverse of the m recurrence: x_t = log f_t + m_{t-1} -
       m_t and z_t = log i_t - m_t, m_t = max(log f_t + m_{t-1}, log i_t):
       dm' = dm + dmg - d x - d z; d log f = da = d x + w dm' (w: max's
       share of its first side); d log i = d z + (1 - w) dm'; dm = da.

    Returns (dq, dk, dv, dlog_i, dlog_f)."""
    b, s, h, d = q.shape
    g_m = torch.exp(-ms)
    den = torch.maximum(ss.abs(), g_m)
    dden = -(dy * y).sum(-1) / den
    w_s = ref.tie_weight(ss.abs(), g_m)
    ds = dden * w_s * torch.sign(ss)
    dmg = dden * (1.0 - w_s) * -g_m
    dnum = dy / den[..., None]
    m_before = torch.cat([m0[:, None], ms[:, :-1]], 1)       # (B, S, H)
    chunks = [slice(t0, min(s, t0 + L)) for t0 in range(0, s, L)]
    f_sum = torch.cat([torch.cumsum(log_f[:, c], 1) for c in chunks], 1)
    dec = torch.cat([torch.exp(f_sum[:, c] + m_before[:, c.start, None]
                               - ms[:, c]) for c in chunks], 1)
    # 2. the reverse chain
    ends, dc, dn = [None] * len(chunks), torch.zeros_like(ck_c[:, 0]), \
        torch.zeros_like(ck_n[:, 0])
    for j in range(len(chunks) - 1, -1, -1):
        c = chunks[j]
        ends[j] = dc, dn
        a = dec[:, c.stop - 1]
        dc = (a[..., None, None] * dc
              + torch.einsum("bth,bthr,bthc->bhrc", dec[:, c], dnum[:, c],
                             q[:, c]))
        dn = a[..., None] * dn + torch.einsum("bth,bthc->bhc",
                                              dec[:, c] * ds[:, c], q[:, c])
    # 3. every chunk
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    d_x, d_z = torch.empty_like(log_f), torch.empty_like(log_i)
    for j, c in enumerate(chunks):
        gc, gn = ends[j]
        cj, nj = ck_c[:, j], ck_n[:, j]
        qc, kc, vc, dnc = q[:, c], k[:, c], v[:, c], dnum[:, c]
        ln = c.stop - c.start
        ft, mt = f_sum[:, c].transpose(1, 2), ms[:, c].transpose(1, 2)
        it = log_i[:, c].transpose(1, 2)                     # (B, H, l)
        causal = torch.ones(ln, ln, dtype=torch.bool).tril()
        w = torch.where(causal, torch.exp(it[:, :, None, :] + ft[..., :, None]
                                          - ft[..., None, :]
                                          - mt[..., :, None]),
                        torch.zeros(()))                     # (B, H, t, s)
        x = (torch.einsum("bthr,bshr->bhts", dnc, vc)
             + ds[:, c].transpose(1, 2)[..., :, None])
        a_m = w * torch.einsum("bthd,bshd->bhts", qc, kc)
        e_m = w * x
        r_m = a_m * x
        dec_c, ds_c = dec[:, c], ds[:, c]                    # (B, l, H)
        g_s = w[..., -1, :].transpose(1, 2)                  # (B, l, H)
        u = torch.einsum("bthr,bhrc->bthc", dnc, cj)
        vg = torch.einsum("bshr,bhrc->bshc", vc, gc)
        dq[:, c] = (dec_c[..., None] * (u + ds_c[..., None] * nj[:, None])
                    + torch.einsum("bhts,bshc->bthc", e_m, kc))
        dk[:, c] = (g_s[..., None] * (vg + gn[:, None])
                    + torch.einsum("bhts,bthc->bshc", e_m, qc))
        dv[:, c] = (g_s[..., None] * torch.einsum("bhrc,bshc->bshr", gc, kc)
                    + torch.einsum("bhts,bthr->bshr", a_m, dnc))
        delta = dec_c * ((u * qc).sum(-1)
                         + ds_c * torch.einsum("bhd,bthd->bth", nj, qc))
        r_out = g_s * ((vg * kc).sum(-1) + torch.einsum("bhd,bshd->bsh", gn,
                                                        kc))
        d_out = dec_c[:, -1] * ((gc * cj).sum((-1, -2)) + (gn * nj).sum(-1))
        # rect[r] = sum over t >= r, s < r of R_ts
        idx = torch.arange(ln)
        rect_mask = ((idx[None, :, None] >= idx[:, None, None])
                     & (idx[None, None, :] < idx[:, None, None])).float()
        rect = torch.einsum("rts,bhts->brh", rect_mask, r_m)
        suffix = torch.flip(torch.cumsum(torch.flip(delta, [1]), 1), [1])
        d_x[:, c] = (suffix + d_out[:, None] + rect
                     + torch.cumsum(r_out, 1) - r_out)
        d_z[:, c] = r_m.sum(-2).transpose(1, 2) + r_out
    # 4. the m reverse
    dli, dlf = torch.empty_like(log_i), torch.empty_like(log_f)
    dm = torch.zeros_like(m0)
    for t in range(s - 1, -1, -1):
        w = ref.tie_weight(log_f[:, t] + m_before[:, t], log_i[:, t])
        dmt = dm + dmg[:, t] - d_x[:, t] - d_z[:, t]
        da = d_x[:, t] + w * dmt
        dli[:, t] = d_z[:, t] + (1.0 - w) * dmt
        dlf[:, t] = da
        dm = da
    return dq, dk, dv, dli, dlf


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("s", [1, 7, 31, 32, 33, 70])
@pytest.mark.parametrize("carry", CARRIES)
def test_chunkwise_mlstm_backward_vs_jax_and_the_plain_reverse(carry, s,
                                                               chunk):
    """The chunkwise backward oracle, from what ``ref.mlstm_scan_ref(...,
    chunk)`` records (its checkpoints, m, s and y), against ``jax.vjp`` of
    JAX's scan step and against ``ref.mlstm_scan_backward_ref``, within
    STATE_TOL: the chunk weights and decays are exponents of sums that the
    step-by-step reverse takes as products, so only rounding differs (every
    exponent is <= 0, and m is the recorded sequential one, bit for bit)."""
    seqs, carries, _, dy, want = _chunkwise_case(carry, s)
    ins = _t(seqs) + _t(carries)
    rec = ref.mlstm_scan_ref(*ins, chunk)
    dy_t = torch.tensor(dy)
    got = chunkwise_mlstm_backward(dy_t, *ins[:5], ins[7], rec[4], rec[5],
                                   rec[6], rec[7], rec[0], chunk)
    _close(got, want)
    _close(got, [g.numpy() for g in ref.mlstm_scan_backward_ref(
        dy_t, *ins)])


@pytest.mark.parametrize("d", [6, 18])
def test_chunkwise_backward_pads_d_to_a_multiple_of_4(monkeypatch, d):
    """``xlstm_scan._mlstm_bwd_padded``, the chunkwise route's way for a D
    that is no multiple of 4, with the chunkwise backward it calls
    replaced by the CPU oracle (which checks that it is given a padded D):
    its gradients at the real D against ``ref.mlstm_scan_backward_ref``
    within STATE_TOL, over 70 steps from a random carry."""
    def oracle(route, dy, q, k, v, log_i, log_f, m0, ck_c, ck_n, ms, ss, y,
               chunk):
        dp = q.shape[-1]
        assert route == "chunkwise" and dp % 4 == 0 and dp - d < 4
        assert ck_c.shape[-2:] == (dp, dp) and y.shape[-1] == dp
        return chunkwise_mlstm_backward(dy, q, k, v, log_i, log_f, m0, ck_c,
                                        ck_n, ms, ss, y, chunk)

    monkeypatch.setattr(X, "mlstm_backward", oracle)
    seqs, carries = _mlstm_inputs(12, "random", 70, d)
    ins = _t(seqs) + _t(carries)
    rec = ref.mlstm_scan_ref(*ins, X.MLSTM_CHUNK)
    dy = torch.tensor(np.random.default_rng(13).standard_normal(
        (B, 70, H, d)).astype(np.float32))
    got = X._mlstm_bwd_padded(dy, *ins[:5], ins[7], rec[4], rec[5], rec[6],
                              rec[7], rec[0], X.MLSTM_CHUNK)
    assert [g.shape for g in got] == [t.shape for t in ins[:5]]
    _close(got, [g.numpy() for g in ref.mlstm_scan_backward_ref(dy, *ins)])


def test_forward_routes_follow_their_stated_rules():
    """``mlstm_route`` and ``slstm_route`` from shape alone: the chunkwise
    mLSTM from 64 steps and 256 row-steps (B S) on, with D a multiple of
    4 and chunk 0 or MLSTM_CHUNK, the one-pass kernel at S = 1 (decode),
    below those boundaries and otherwise; the chunkwise mLSTM backward for
    every forward recorded with chunk MLSTM_CHUNK whose D is a multiple of
    4, whatever B, S and H, the step backward for any other D or chunk;
    the persistent sLSTM from 4
    steps on, B <= 8 and ceil(d / 8) blocks within the SMs whose shared
    memory fits a block, the step kernel at S = 1 to 3 and at d = 1,640
    on an H100's 132 SMs.  The shared-memory count is the kernel's (r_w's 32
    columns, h's rows rounded up to 1, 2, 4, 8 and the warps' partials)."""
    chunk = X.MLSTM_CHUNK
    for shape, route in (((8, 256, 4, 256, 0), "chunkwise"),
                         ((1, 1024, 4, 256, chunk), "chunkwise"),
                         ((8, 64, 4, 256, 0), "chunkwise"),
                         ((1, 256, 4, 256, 0), "chunkwise"),
                         ((4, 64, 2, 16, chunk), "chunkwise"),
                         ((2, 7, 2, 16, chunk), "one_pass"),
                         ((8, 32, 4, 256, 0), "one_pass"),
                         ((1, 128, 4, 256, 0), "one_pass"),
                         ((2, 64, 4, 256, 0), "one_pass"),
                         ((8, 1, 4, 256, 0), "one_pass"),
                         ((8, 1, 4, 256, chunk), "one_pass"),
                         ((4, 70, 2, 18, 0), "one_pass"),
                         ((4, 70, 2, 16, 3), "one_pass")):
        assert X.mlstm_route(*shape) == route, shape
    for shape, route in (((2, 1024, 4, 256, chunk), "chunkwise"),
                         ((2, 256, 4, 256, chunk), "chunkwise"),
                         ((1, 1, 4, 256, chunk), "chunkwise"),
                         ((2, 7, 2, 16, chunk), "chunkwise"),
                         ((8, 1030, 1, 12, chunk), "chunkwise"),
                         ((3, 70, 2, 18, chunk), "chunkwise"),
                         ((1, 40, 1, 260, chunk), "chunkwise"),
                         ((1, 40, 1, 1021, chunk), "chunkwise"),
                         ((2, 7, 2, 16, 3), "step"),
                         ((2, 70, 2, 16, 64), "step"),
                         ((4, 70, 2, 256, 16), "step")):
        assert X.mlstm_bwd_route(*shape) == route, shape
    assert X.slstm_persistent_smem(8, 1024) == 4 * (1024 * 32 + 1024 * 8
                                                    + 16 * 8 * 32)
    assert X.slstm_persistent_smem(3, 40) == 4 * (64 * 32 + 64 * 4
                                                  + 16 * 4 * 32)
    for shape, route in (((8, 256, 1024, 132), "persistent"),
                         ((1, 1024, 1024, 132), "persistent"),
                         ((2, 7, 32, 132), "persistent"),
                         ((3, 70, 40, 132), "persistent"),
                         ((8, 4, 1024, 132), "persistent"),
                         ((8, 1, 1024, 132), "step"),
                         ((8, 3, 1024, 132), "step"),
                         ((1, 2, 1024, 132), "step"),
                         ((9, 256, 1024, 132), "step"),
                         ((8, 7, 1640, 132), "step"),
                         ((2, 64, 1024, 100), "step"),
                         ((8, 64, 1056, 132), "persistent"),
                         ((8, 64, 1064, 133), "persistent"),
                         ((8, 64, 1600, 200), "step")):
        assert X.slstm_route(*shape) == route, shape


@pytest.mark.parametrize("shape,route", [
    ((2, 1024, 1024, 132), "persistent"),      # run (y)
    ((8, 256, 1024, 132), "persistent"),
    ((1, X.SLSTM_BWD_PERSISTENT_MIN_STEPS, 1024, 132), "persistent"),
    ((3, 70, 36, 132), "persistent"),
    ((8, 64, 1056, 132), "persistent"),        # 132 blocks on 132 SMs
    ((8, 64, 1780, 300), "persistent"),        # 231,936 bytes: fits
    ((9, 64, 1024, 132), "step"),              # more than 8 rows
    ((2, 7, 1640, 132), "step"),               # 205 blocks on 132 SMs
    ((8, 64, 1064, 132), "step"),              # 133 blocks
    ((8, 64, 1800, 300), "step"),              # 234,496 bytes: no fit
    ((2, X.SLSTM_BWD_PERSISTENT_MIN_STEPS - 1, 1024, 132), "step"),
    ((8, 1, 32, 132), "step")])
def test_slstm_backward_route_follows_its_stated_rule(shape, route):
    """``slstm_bwd_route`` from shape and SM count alone: the persistent
    backward from ``SLSTM_BWD_PERSISTENT_MIN_STEPS`` steps on with B <= 8,
    ceil(d / 8) blocks within the SMs and a block's shared memory within
    ``SMEM_PER_BLOCK``; the step backward otherwise."""
    assert X.SLSTM_BWD_PERSISTENT_MIN_STEPS >= 2
    assert X.slstm_bwd_route(*shape) == route


@pytest.mark.parametrize("d", [1024, 40])
def test_slstm_backward_persistent_smem_counts_by_hand(d):
    """``slstm_bwd_persistent_smem`` is the kernel's
    ``bwd_persistent_floats`` in bytes: 8 units' rows of r_w (4d floats
    each) and 16 warps' partial sums of 8 units x the rows, B rounded up
    to 1, 2, 4 or 8 rows."""
    for b, rows in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8)):
        assert X.slstm_bwd_persistent_smem(b, d) == 4 * (
            8 * 4 * d + 16 * rows * 8), (b, d)
    assert X.slstm_bwd_persistent_smem(8, 1024) == 135_168


@pytest.mark.parametrize("b,s,d,sms,route", [
    (2, 7, 32, 132, "persistent"), (8, 5, 40, 5, "persistent"),
    (9, 3, 32, 132, "step"), (2, 1, 32, 132, "step"),
    (2, 7, 32, 3, "step")])
def test_slstm_backward_op_dispatches_to_the_routed_design(
        monkeypatch, b, s, d, sms, route):
    """The backward operator's CUDA body, ``_slstm_bwd_cuda``, hands the
    saved tensors to ``slstm_backward`` under the design
    ``slstm_bwd_route`` names for their shape and the card's SM count (the
    card's checks and launch replaced by stand-ins that record the
    call)."""
    calls = []
    monkeypatch.setattr(_lib, "check_cuda", lambda name, *ts: ts[0].device)
    monkeypatch.setattr(X, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(X, "slstm_backward",
                        lambda *a: calls.append(a) or "launched")
    g = torch.Generator().manual_seed(b * 100 + s)
    dy, y, cs, ns, ms = (torch.randn((b, s, d), generator=g)
                         for _ in range(5))
    pre_x, pres = (torch.randn((b, s, 4 * d), generator=g) for _ in range(2))
    r_w = torch.randn((d, 4 * d), generator=g)
    c0, n0, m0, h0 = (torch.randn((b, d), generator=g) for _ in range(4))
    assert X._slstm_bwd_cuda(dy, pre_x, r_w, c0, n0, m0, h0, pres, cs, ns,
                             ms, y) == "launched"
    (got,) = calls
    assert got[0] == route == X.slstm_bwd_route(b, s, d, sms)
    want = (dy, r_w, pres, cs, ns, ms, c0, n0, m0, h0, y)
    assert len(got) == 1 + len(want)
    assert all(torch.equal(a, w) for a, w in zip(got[1:], want))
