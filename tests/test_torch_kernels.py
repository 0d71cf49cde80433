"""The port's attention kernels (plain versions on the CPU) against the JAX
package's Pallas kernels (interpret mode) and both packages' oracles.

Every case is made with numpy from a seed and handed to both sides.  The
paged cases carry ragged block tables with dead entries (-1), a scratch
page and unassigned pages poisoned with live-looking positions, holes
(pos -1) inside live pages, and fully masked pages, so a kernel that
reads through a dead entry or forgets to zero ``p`` after ``exp`` shows.

Tolerances (float32 on both sides, same inputs): the per-page and per-row
(o, l, m) partials differ only in summation order over D and a page's keys,
so ``atol = rtol = 1e-5``; the combined outputs likewise.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention_offload as JAO
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.kernels.flash_prefill import \
    paged_prefix_partials as j_paged_prefix_partials
from repro.kernels.split_kv_decode import \
    paged_decode_partials as j_paged_decode_partials
from repro_torch.core import attention_offload as PAO
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               paged_prefix_partials)
from repro_torch.kernels.split_kv_decode import paged_decode_partials
from test_torch_cuda import dense_case as _dense_case
from test_torch_cuda import paged_case as _paged_case

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite may run in several worker processes at once: keep torch to a
    couple of CPU threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, **tol):
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in
            (want if isinstance(want, tuple) else (want,))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


def _args(c, conv):
    return tuple(conv(c[k]) for k in ("q", "k_pages", "v_pages", "pos_pages",
                                      "block_tables", "pos_q"))


# (b, h, kv, d, bs, nb, window, soft_cap): MHA, GQA, window, soft cap
PAGED = [(3, 4, 4, 16, 8, 4, None, None),
         (2, 8, 2, 32, 4, 6, None, None),
         (3, 4, 2, 16, 8, 4, 11, None),
         (2, 4, 1, 16, 8, 3, None, 5.0),
         (2, 6, 2, 8, 4, 5, 7, 3.0)]


# ---------------------------------------------------------------------------
# B1: page-fused decode partials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", PAGED)
def test_paged_decode_partials_vs_jax(b, h, kv, d, bs, nb, win, cap):
    c = _paged_case(0, b, h, kv, d, bs, nb)
    got = paged_decode_partials(*_args(c, _t), window=win, soft_cap=cap)
    want = j_paged_decode_partials(*_args(c, jnp.asarray), window=win,
                                   soft_cap=cap, interpret=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", PAGED)
def test_paged_decode_attention_vs_jax_and_oracles(b, h, kv, d, bs, nb, win,
                                                   cap):
    c = _paged_case(1, b, h, kv, d, bs, nb)
    out = ops.paged_decode_attention(*_args(c, _t), window=win, soft_cap=cap)
    j_out = JOPS.paged_decode_attention(*_args(c, jnp.asarray), window=win,
                                        soft_cap=cap, interpret=True)
    oracle = ref.paged_decode_attention_reference(*_args(c, _t), window=win,
                                                  soft_cap=cap)
    _close(out.numpy(), j_out)
    _close(out.numpy(), oracle.numpy())
    if cap is None:      # the JAX oracle has no soft cap
        _close(out.numpy(), JREF.paged_decode_attention_reference(
            *_args(c, jnp.asarray), window=win))


def test_dead_entries_ignore_scratch_junk():
    """Dead table entries read the scratch page 0, which holds live-looking
    positions; the table test must mask them whatever page 0 holds."""
    c = _paged_case(2, 3, 4, 2, 16, 8, 4)
    base = paged_decode_partials(*_args(c, _t))
    c["k_pages"][0] = 1e3
    c["pos_pages"][0] = 0
    junk = paged_decode_partials(*_args(c, _t))
    dead = torch.as_tensor(c["block_tables"] < 0)
    assert dead.any()
    _close(tuple(x.numpy() for x in junk), tuple(x.numpy() for x in base))
    o, l, m = junk
    assert torch.all(l[dead] == 0) and torch.all(m[dead] == NEG_INF)
    assert torch.all(o[dead] == 0)


def test_fully_masked_live_page_has_zero_l():
    """A live page whose keys are all holes or in the query's future gives
    l = 0 and o = 0 (p zeroed by the mask after exp), m = NEG_INF."""
    c = _paged_case(3, 2, 4, 2, 16, 8, 4, hole=False)
    c["block_tables"][0, :2] = [1, 2]
    c["pos_pages"][1] = -1                       # all holes
    c["pos_pages"][2] = c["pos_q"][0] + 1 + np.arange(8)   # all future
    for side in ("port", "jax"):
        if side == "port":
            o, l, m = (x.numpy() for x in paged_decode_partials(
                *_args(c, _t)))
        else:
            o, l, m = (np.asarray(x) for x in j_paged_decode_partials(
                *_args(c, jnp.asarray), interpret=True))
        assert np.all(l[0, :2] == 0) and np.all(o[0, :2] == 0), side
        assert np.all(m[0, :2] == NEG_INF), side


# ---------------------------------------------------------------------------
# B2: flash prefill
# ---------------------------------------------------------------------------

# (b, s, h, kv, d, window, soft_cap, seq_offset)
FLASH = [(2, 16, 4, 4, 16, None, None, 0),
         (1, 32, 8, 2, 32, None, None, 0),
         (2, 16, 4, 2, 16, 5, None, 0),
         (1, 16, 4, 1, 16, None, 4.0, 0),
         (2, 16, 4, 2, 8, 6, 2.0, 16)]


@pytest.mark.parametrize("b,s,h,kv,d,win,cap,off", FLASH)
def test_flash_prefill_vs_jax(b, s, h, kv, d, win, cap, off):
    q, k, v = _dense_case(4, b, s, s + off, h, kv, d)
    kw = dict(window=win, soft_cap=cap, seq_offset=off)
    j_kw = dict(kw, block_q=8, block_k=8, interpret=True)
    for partials in (False, True):
        got = flash_prefill(_t(q), _t(k), _t(v), return_partials=partials,
                            **kw)
        want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), return_partials=partials,
                               **j_kw)
        if partials:
            _close(tuple(g.numpy() for g in got), want)
        else:
            _close(got.numpy(), want)


@pytest.mark.parametrize("s,win", [(5, None), (13, None), (24, 7)])
def test_flash_attention_padding_vs_jax_and_oracle(s, win):
    """``ops.flash_attention`` pads S to the pow2 query block and the keys
    behind it; the padded keys sit in every real query's future."""
    q, k, v = _dense_case(5, 2, s, s, 4, 2, 16)
    out = ops.flash_attention(_t(q), _t(k), _t(v), window=win, block_q=8,
                              block_k=8)
    j_out = JOPS.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=win, block_q=8,
                                 block_k=8, interpret=True)
    assert tuple(out.shape) == (2, s, 4, 16)
    _close(out.numpy(), j_out)
    _close(out.numpy(), ref.flash_prefill_reference(
        _t(q), _t(k), _t(v), window=win).numpy())
    _close(out.numpy(), JREF.flash_prefill_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=win))


def test_flash_window_masks_whole_rows_finitely():
    """With seq_offset past the window, early key tiles are fully masked
    for every query: partials stay finite and match one-shot softmax."""
    q, k, v = _dense_case(6, 1, 8, 40, 2, 2, 8)
    o, l, m = flash_prefill(_t(q), _t(k), _t(v), window=4, seq_offset=32,
                            return_partials=True)
    assert torch.isfinite(o).all() and torch.all(l > 0)
    want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window=4, seq_offset=32, block_q=8, block_k=8,
                           return_partials=True, interpret=True)
    _close((o.numpy(), l.numpy(), m.numpy()), want)


# ---------------------------------------------------------------------------
# B3: paged prefix partials and the combined paged prefill
# ---------------------------------------------------------------------------

# (b, s, h, kv, d, bs, nb, window, soft_cap)
PREFIX = [(2, 8, 4, 4, 16, 8, 5, None, None),
          (2, 16, 8, 2, 16, 4, 8, None, None),
          (2, 8, 4, 2, 16, 8, 5, 10, None),
          (1, 8, 4, 1, 8, 4, 6, None, 3.0),
          (2, 12, 4, 2, 8, 4, 7, 9, 2.0)]


@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", PREFIX)
def test_paged_prefix_partials_vs_jax(b, s, h, kv, d, bs, nb, win, cap):
    c = _paged_case(7, b, h, kv, d, bs, nb, s=s)
    got = paged_prefix_partials(*_args(c, _t), window=win, soft_cap=cap)
    want = j_paged_prefix_partials(*_args(c, jnp.asarray), window=win,
                                   soft_cap=cap, interpret=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", PREFIX)
def test_paged_prefill_attention_vs_jax_and_oracles(b, s, h, kv, d, bs, nb,
                                                    win, cap):
    c = _paged_case(8, b, h, kv, d, bs, nb, s=s)
    rng = np.random.default_rng(9)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    pages = _args(c, _t)
    out = ops.paged_prefill_attention(pages[0], _t(k), _t(v), *pages[1:],
                                      window=win, soft_cap=cap, block_q=8,
                                      block_k=8)
    jp = _args(c, jnp.asarray)
    j_out = JOPS.paged_prefill_attention(
        jp[0], jnp.asarray(k), jnp.asarray(v), *jp[1:], window=win,
        soft_cap=cap, block_q=8, block_k=8, interpret=True)
    _close(out.numpy(), j_out)
    oracle = ref.paged_prefill_attention_reference(
        pages[0], _t(k), _t(v), *pages[1:], window=win, soft_cap=cap)
    _close(out.numpy(), oracle.numpy())
    if cap is None:
        _close(out.numpy(), JREF.paged_prefill_attention_reference(
            jp[0], jnp.asarray(k), jnp.asarray(v), *jp[1:], window=win))


# ---------------------------------------------------------------------------
# The exact combine (plain torch, not a kernel)
# ---------------------------------------------------------------------------

def test_partial_attention_and_combine_vs_jax():
    rng = np.random.default_rng(10)
    b, h, d, n = 2, 4, 16, 12
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n, h, d)).astype(np.float32)
    v = rng.normal(size=(b, n, h, d)).astype(np.float32)
    mask = rng.random((b, n)) < 0.7
    mask[0, :4] = False                 # part 0 of row 0 fully masked
    parts_p, parts_j = [], []
    for lo in range(0, n, 4):
        sl = slice(lo, lo + 4)
        parts_p.append(PAO.partial_attention(
            _t(q), _t(k[:, sl]), _t(v[:, sl]), _t(mask[:, sl])))
        parts_j.append(JAO.partial_attention(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(mask[:, sl])))
    for pp, pj in zip(parts_p, parts_j):
        _close(tuple(x.numpy() for x in pp), pj)
    got = PAO.combine_partials(*zip(*parts_p))
    want = JAO.combine_partials(*zip(*parts_j))
    _close(got.numpy(), want)
    full = PAO.partial_attention(_t(q), _t(k), _t(v), _t(mask))
    _close(got.numpy(), (full[0] / full[1][..., None]).numpy())


# ---------------------------------------------------------------------------
# Dispatch rules
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version_without_counting():
    c = _paged_case(11, 2, 4, 2, 16, 8, 3)
    _lib.reset_launches()
    got = paged_decode_partials(*_args(c, _t))
    want = ref.paged_decode_partials_plain(*_args(c, _t))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in _lib.LAUNCHES.values())
    assert set(_lib.LAUNCHES) == {"paged_decode_partials", "flash_prefill",
                                  "paged_prefix_partials"}


def test_mask_args_reject_bad_window_and_cap():
    assert _lib.mask_args(None, None) == (0, 0.0)
    assert _lib.mask_args(16, 2.5) == (16, 2.5)
    with pytest.raises(ValueError):
        _lib.mask_args(0, None)
    with pytest.raises(ValueError):
        _lib.mask_args(None, -1.0)
