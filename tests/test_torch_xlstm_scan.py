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
The route rules of both forwards are held to their stated conditions.
About 30 s on one worker (~10 s before the oracle's 36 cases, most of
the rest JAX's scan at six sequence lengths).
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


def _mlstm_inputs(seed, carry, s=S):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, H, D)).astype(np.float32) / 4
               for _ in range(3))
    log_i = rng.standard_normal((B, s, H)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal((B, s, H))
                                   - 2))).astype(np.float32)
    c0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    n0 = rng.standard_normal((B, H, D)).astype(np.float32)
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
    """Inputs at S steps with the carry kind, and JAX's scan over them
    (computed once per (carry, S) for both chunk lengths)."""
    seqs, carries = _mlstm_inputs(6, carry, s)
    return seqs, carries, [np.asarray(w) for w in jax_mlstm(carries, *seqs)]


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
    seqs, carries, want = _chunkwise_case(carry, s)
    ins = _t(seqs) + _t(carries)
    got = chunkwise_mlstm(*ins, chunk)
    _close(got[:4], want)
    rec = ref.mlstm_scan_ref(*ins, chunk)
    assert [g.shape for g in got] == [r.shape for r in rec]
    assert torch.equal(got[6], rec[6])                       # m, exactly
    _close(got[4:], [r.numpy() for r in rec[4:]])


def test_forward_routes_follow_their_stated_rules():
    """``mlstm_route`` and ``slstm_route`` from shape alone: the chunkwise
    mLSTM from 64 steps and 256 row-steps (B S) on, with D a multiple of
    4 and chunk 0 or MLSTM_CHUNK, the one-pass kernel at S = 1 (decode),
    below those boundaries and otherwise; the persistent sLSTM from 4
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
