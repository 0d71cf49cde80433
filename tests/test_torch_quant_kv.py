"""The port's int8-KV serving path against the JAX package: ``quantize_kv``,
the int8 variants of the page kernels B1/B4 (plain versions on the CPU
against the JAX Pallas kernels in interpret mode), kernel B5 (dense
split-KV decode) and its ``ops`` entry points, the int8 stack forward,
the paged runtime's scale leaves, and int8 serving through the engines,
speculation and the orchestrator.

Every input is made with numpy from a seed and handed to both sides; the
weights come from the JAX ``init`` (``kv_quant`` does not change them).

Tolerances (float32 on both sides):
* partials and attention outputs ``1e-5`` (summation order over D and a
  page's keys), logits after the stack ``1e-4``;
* int8 leaves: equal, or one quantization step apart in at most
  ``INT8_FLIP_SHARE`` of the entries — the port's K/V differ from JAX's in
  the last bits and can land on the other side of a rounding boundary;
  scale leaves ``1e-5``;
* token streams and engine counters exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY, assert_pools_restored
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.split_kv_decode import \
    paged_decode_partials as j_paged_decode_partials
from repro.kernels.split_kv_decode import \
    paged_verify_partials as j_paged_verify_partials
from repro.models import kvcache as JKC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JDecode
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PrefillEngine as JPrefill
from repro.serving.request import Request as JRequest
from repro_torch.kernels import ops, ref
from repro_torch.kernels.split_kv_decode import (paged_decode_partials,
                                                 paged_verify_partials)
from repro_torch.models import kvcache as KC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.serving.api import Server
from repro_torch.serving.engine import (DecodeEngine, EngineConfig,
                                        PrefillEngine)
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving.request import Request
from test_torch_cuda import decode_case, paged_case, poison_unseen_scales, \
    quantize_pages, verify_case
from test_torch_kernels import merge_groups

PTINY = ModelConfig(name="tiny4", family=Family.DENSE, n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=128)
QCFG = PTINY.with_kv_quant()
JQCFG = TINY.with_kv_quant()
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_FLIP_SHARE = 1e-3
KEYS = ("q", "k_pages", "v_pages", "pos_pages", "block_tables", "pos_q")
SCALES = ("k_scale_pages", "v_scale_pages")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tiny_params):
    """(JAX params, the port's params made from them)."""
    return tiny_params, params_from_jax(
        QCFG, jax.tree.map(np.asarray, tiny_params), device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_jax(tree):
    """A JAX copy of a port tree (the port updates caches in place)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy().copy()) if torch.is_tensor(tree) else tree


def _assert_int8_close(got, want):
    got, want = _np(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, diff.max()
    assert (diff > 0).mean() <= INT8_FLIP_SHARE, (diff > 0).mean()


def _assert_tree_close(port, jax_tree, **tol):
    """Leaf for leaf; int8 leaves under the rounding rule above."""
    if isinstance(jax_tree, dict):
        assert set(port) == set(jax_tree)
        for k in jax_tree:
            _assert_tree_close(port[k], jax_tree[k], **tol)
    elif isinstance(jax_tree, (tuple, list)):
        assert len(port) == len(jax_tree)
        for a, b in zip(port, jax_tree):
            _assert_tree_close(a, b, **tol)
    else:
        a, b = _np(port), np.asarray(jax_tree)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype == np.int8:
            _assert_int8_close(a, b)
        else:
            np.testing.assert_allclose(a, b, **(tol or TOL))


def _args(c, conv):
    return tuple(conv(c[k]) for k in KEYS)


def _scales(c, conv):
    return {k: conv(c[k]) for k in SCALES}


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# quantize_kv
# ---------------------------------------------------------------------------

def test_quantize_kv_vs_jax():
    """Per-(token, head) amax over D, round half to even, clip: the same
    int8 values and scales as JAX on the same f32 input, including exact
    ties (x = (k + 0.5) * scale), an all-zero head (scale floor 1e-6) and
    heads of very different magnitude."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 3, (2, 7, 3, 1))
    x[0, 1, 2] = 0.0
    x[1, 2, 0, :4] = [127.0, 2.5, -0.5, 1.5]     # amax 127: scale 1, ties
    x[1, 2, 0, 4:] = 0.0
    got_q, got_s = L.quantize_kv(torch.as_tensor(x))
    want_q, want_s = JL.quantize_kv(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[1, 2, 0, :4].tolist() == [127, 2, 0, 2]
    assert float(got_s[0, 1, 2]) == np.float32(1e-6) / np.float32(127.0)


# ---------------------------------------------------------------------------
# B1 / B4 int8 variants: plain partials against the JAX kernels
# ---------------------------------------------------------------------------

# (b, h, kv, d, bs, nb, window, soft_cap): MHA, GQA, window, soft cap 30
QPAGED = [(3, 4, 4, 16, 8, 4, None, None),
          (2, 8, 2, 32, 4, 6, None, None),
          (3, 4, 2, 16, 8, 4, 11, None),
          (2, 4, 1, 16, 8, 3, None, 30.0),
          (2, 6, 2, 8, 4, 5, 7, 30.0)]


@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", QPAGED)
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_int8_page_partials_vs_jax(kind, b, h, kv, d, bs, nb, win, cap):
    """The int8-pool partials (K scale before the cap, l before the V
    scale) with dead entries, holes, poisoned scratch positions and, for
    verify, in-flight and stale tokens, against the JAX Pallas kernels."""
    if kind == "decode":
        c = quantize_pages(paged_case(20, b, h, kv, d, bs, nb))
        port, jaxk = paged_decode_partials, j_paged_decode_partials
    else:
        c = quantize_pages(verify_case(21, b, 3, h, kv, d, bs, nb))
        port, jaxk = paged_verify_partials, j_paged_verify_partials
    got = port(*_args(c, _t), window=win, soft_cap=cap, **_scales(c, _t))
    want = jaxk(*_args(c, jnp.asarray), window=win, soft_cap=cap,
                interpret=True, **_scales(c, jnp.asarray))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("split", [3, "nb"])
@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", QPAGED)
def test_int8_decode_split_partials_vs_jax_merge(b, h, kv, d, bs, nb, win,
                                                 cap, split):
    """B1-int8's plain version with several pages per split (3: a ragged
    last split; nb: one split per row), window and soft cap, equals the
    exact merge of the JAX int8 kernel's per-page partials."""
    pps = nb if split == "nb" else split
    c = quantize_pages(paged_case(20, b, h, kv, d, bs, nb))
    got = paged_decode_partials(*_args(c, _t), window=win, soft_cap=cap,
                                pages_per_split=pps, **_scales(c, _t))
    want = merge_groups(j_paged_decode_partials(
        *_args(c, jnp.asarray), window=win, soft_cap=cap, interpret=True,
        **_scales(c, jnp.asarray)), pps)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("split", [3, "nb"])
@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", QPAGED)
def test_int8_verify_split_partials_vs_jax_merge(b, h, kv, d, bs, nb, win,
                                                 cap, split):
    """B4-int8's plain version with several pages per split (3: a ragged
    last split; nb: one split per row), S = 3 queries each at its own
    position, window and soft cap, equals the exact merge of the JAX int8
    kernel's per-page partials."""
    pps = nb if split == "nb" else split
    c = quantize_pages(verify_case(21, b, 3, h, kv, d, bs, nb))
    got = paged_verify_partials(*_args(c, _t), window=win, soft_cap=cap,
                                pages_per_split=pps, **_scales(c, _t))
    want = merge_groups(j_paged_verify_partials(
        *_args(c, jnp.asarray), window=win, soft_cap=cap, interpret=True,
        **_scales(c, jnp.asarray)), pps)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("pps", [1, 3])
def test_int8_verify_attention_split_vs_jax(pps):
    """Combined int8 verify at one partial per page and per 3 pages (the
    CPU default is one split per row), window and soft cap, against JAX's
    ops and the dequantize-after-gather oracle."""
    c = quantize_pages(verify_case(23, 3, 4, 4, 2, 32, 8, 6))
    kw = dict(window=12, soft_cap=30.0)
    out = ops.paged_verify_attention(*_args(c, _t), **kw, **_scales(c, _t),
                                     pages_per_split=pps)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        JOPS.paged_verify_attention(*_args(c, jnp.asarray), **kw,
                                    interpret=True,
                                    **_scales(c, jnp.asarray))), **TOL)
    np.testing.assert_allclose(out.numpy(), ref.paged_verify_attention_reference(
        *_args(c, _t), **kw, **_scales(c, _t)).numpy(), **TOL)


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_int8_unseen_nan_scales_never_reach_the_partials(kind, pps):
    """NaN in the scale slots of every entry no query sees (holes,
    unwritten slots, stale tokens, the scratch page, unassigned pages)
    leaves the plain int8 partials equal to those with the real scales:
    the K scale is masked with the score, the V scale multiplies p only
    where the key is visible.  The card runs the same case against the
    kernels (``test_cuda_page_kernels_ignore_unseen_nan_scales``)."""
    if kind == "decode":
        c = quantize_pages(paged_case(25, 3, 4, 2, 16, 8, 4))
        port = paged_decode_partials
    else:
        c = quantize_pages(verify_case(26, 3, 4, 4, 2, 16, 8, 4))
        port = paged_verify_partials
    bad = poison_unseen_scales(c)
    assert np.isnan(bad["v_scale_pages"]).any()
    want = port(*_args(c, _t), soft_cap=30.0, pages_per_split=pps,
                **_scales(c, _t))
    got = port(*_args(bad, _t), soft_cap=30.0, pages_per_split=pps,
               **_scales(bad, _t))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)


@pytest.mark.parametrize("win,cap", [(None, None), (12, None), (None, 30.0)])
def test_int8_paged_attention_vs_jax_and_oracles(win, cap):
    """Combined int8 decode and verify attention against JAX's ops and
    both packages' dequantize-after-gather oracles."""
    c = quantize_pages(paged_case(22, 2, 4, 2, 32, 8, 6))
    out = ops.paged_decode_attention(*_args(c, _t), window=win, soft_cap=cap,
                                     **_scales(c, _t))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        JOPS.paged_decode_attention(*_args(c, jnp.asarray), window=win,
                                    soft_cap=cap, interpret=True,
                                    **_scales(c, jnp.asarray))), **TOL)
    np.testing.assert_allclose(out.numpy(), ref.paged_decode_attention_reference(
        *_args(c, _t), window=win, soft_cap=cap, **_scales(c, _t)).numpy(),
        **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        JREF.paged_decode_attention_reference(
            *_args(c, jnp.asarray), window=win, soft_cap=cap,
            **_scales(c, jnp.asarray))), **TOL)
    c = quantize_pages(verify_case(23, 3, 4, 4, 2, 32, 8, 6))
    out = ops.paged_verify_attention(*_args(c, _t), window=win, soft_cap=cap,
                                     **_scales(c, _t))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        JOPS.paged_verify_attention(*_args(c, jnp.asarray), window=win,
                                    soft_cap=cap, interpret=True,
                                    **_scales(c, jnp.asarray))), **TOL)
    np.testing.assert_allclose(out.numpy(), ref.paged_verify_attention_reference(
        *_args(c, _t), window=win, soft_cap=cap, **_scales(c, _t)).numpy(),
        **TOL)


def test_int8_v_scale_folds_after_l():
    """l is the sum of p before the V scale: scaling every V scale by 8
    scales o by 8 and leaves l and m unchanged."""
    c = quantize_pages(paged_case(24, 2, 4, 2, 16, 8, 3))
    a, kw = _args(c, _t), _scales(c, _t)
    o, l, m = paged_decode_partials(*a, **kw)
    o8, l8, m8 = paged_decode_partials(
        *a, k_scale_pages=kw["k_scale_pages"],
        v_scale_pages=kw["v_scale_pages"] * 8)
    assert torch.equal(l8, l) and torch.equal(m8, m)
    np.testing.assert_allclose(o8.numpy(), 8 * o.numpy(), **TOL)


# ---------------------------------------------------------------------------
# B5: dense split-KV decode
# ---------------------------------------------------------------------------

# (b, h, kv, d, L, block_k): L not a multiple of block_k 16; MHA, GQA, MQA
SPLIT = [(2, 4, 2, 16, 40, 16), (3, 8, 8, 32, 37, 16), (2, 4, 1, 8, 16, 16),
         (2, 4, 2, 16, 9, 16)]


@pytest.mark.parametrize("b,h,kv,d,length,bk", SPLIT)
def test_split_kv_decode_vs_jax(b, h, kv, d, length, bk):
    """B5's plain partials through ``ops.decode_partials`` (L padded to the
    block with invalid keys) and ``ops.decode_attention`` against the JAX
    kernel in interpret mode, the JAX oracle and the port's oracle."""
    q, k, v, valid = decode_case(25, b, h, kv, d, length)
    valid[0, :bk] = False                     # a fully invalid block
    got = ops.decode_partials(_t(q), _t(k), _t(v), _t(valid), block_k=bk)
    want = JOPS.decode_partials(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(valid),
                                block_k=bk, interpret=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    out = ops.decode_attention(_t(q), _t(k), _t(v), _t(valid), block_k=bk)
    jout = JOPS.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(valid),
                                 block_k=bk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        JREF.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        jnp.asarray(valid))), **TOL)
    np.testing.assert_allclose(out.numpy(), ref.decode_attention_reference(
        _t(q), _t(k), _t(v), _t(valid)).numpy(), **TOL)


# ---------------------------------------------------------------------------
# The int8 stack forward
# ---------------------------------------------------------------------------

def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, PTINY.vocab_size,
                                                (b, s)).astype(np.int32)


def test_init_caches_match_jax_layout():
    """int8 K/V leaves and zero f32 scale leaves, dense and paged."""
    _assert_tree_close(T.init_cache(QCFG, 2, 32, device="cpu"),
                       JT.init_cache(JQCFG, 2, 32))
    got = T.init_paged_cache(QCFG, 3, 48, 8, device="cpu")
    _assert_tree_close(got, JT.init_paged_cache(JQCFG, 3, 48, 8))
    assert got["groups"][0]["k_scale"].shape == (4, 1 + 3 * 6, 8, 2)


def _paged_after_prefill(tp, toks, lengths, max_len, bs):
    """The port's int8 paged cache holding each row's prefilled prefix
    (through the wire format); every row's table covers its page range."""
    b = toks.shape[0]
    dense = T.init_cache(QCFG, b, max_len, device="cpu")
    T.apply(QCFG, tp, torch.as_tensor(toks), cache=dense, mode="prefill")
    pc = T.init_paged_cache(QCFG, b, max_len, bs, device="cpu")
    nb = max_len // bs
    for row in range(b):
        st = KC.dense_state_to_paged(KC.extract_request_state(dense, row),
                                     bs, length=int(lengths[row]))
        n = st["n_blocks"]
        KC.insert_paged_state(pc, row, st,
                              list(range(1 + row * nb, 1 + row * nb + n)), bs)
        pc["block_tables"][row] = torch.arange(1 + row * nb,
                                               1 + (row + 1) * nb)
    pc["lengths"] = torch.as_tensor(lengths, dtype=torch.int32)
    return pc


def test_apply_int8_prefill_vs_jax(weights):
    """Fresh prefill attends over the unquantized K/V (kernel B2's path)
    and writes int8 values and scales: logits and every cache leaf."""
    jp, tp = weights
    toks = _tokens(30, 2, 16)
    at = np.asarray([15, 9], np.int32)
    got, gcache, _ = T.apply(
        QCFG, tp, torch.as_tensor(toks),
        cache=T.init_cache(QCFG, 2, 32, device="cpu"), mode="prefill",
        logits_slice="last", logits_at=torch.as_tensor(at))
    want, wcache, _ = JT.apply(
        JQCFG, jp, jnp.asarray(toks), cache=JT.init_cache(JQCFG, 2, 32),
        mode="prefill", logits_slice="last", logits_at=jnp.asarray(at))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _assert_tree_close(gcache, wcache, **LOGIT_TOL)
    plain, _, _ = JT.apply(TINY, jp, jnp.asarray(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(plain)[[0, 1], at],
                               **LOGIT_TOL)


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("paged_kernel", [True, False])
def test_apply_int8_paged_decode_vs_jax(weights, paged_kernel, s):
    """Paged int8 decode (S = 1, kernel B1-int8's path) and verify (S = 5,
    B4-int8's), or the gather-then-attend reference with gathered scales,
    on identical pools: logits and every pool leaf, over steps that cross
    into fresh pages."""
    jp, tp = weights
    toks = _tokens(31, 2, 13)
    lengths = np.asarray([13, 11], np.int32)
    pc = _paged_after_prefill(tp, toks, lengths, 48, 8)
    jc = _to_jax(pc)
    step = _tokens(32, 2, s)
    for _ in range(2):
        got, pc, _ = T.apply(QCFG, tp, torch.as_tensor(step), cache=pc,
                             mode="decode", logits_slice="all",
                             paged_kernel=paged_kernel)
        want, jc, _ = JT.apply(JQCFG, jp, jnp.asarray(step), cache=jc,
                               mode="decode", logits_slice="all",
                               paged_kernel=paged_kernel)
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        step = np.asarray(want).argmax(-1).astype(np.int32)
    _assert_tree_close(pc, jc, **LOGIT_TOL)


def test_apply_int8_dense_decode_vs_jax(weights):
    """Decode over a dense int8 cache (the draft model's): quantized ring
    writes, then plain attention through the scales."""
    jp, tp = weights
    toks = _tokens(33, 2, 10)
    at = np.asarray([9, 6], np.int32)
    dense = T.init_cache(QCFG, 2, 32, device="cpu")
    _, dense, _ = T.apply(QCFG, tp, torch.as_tensor(toks), cache=dense,
                          mode="prefill", logits_slice="last",
                          logits_at=torch.as_tensor(at))
    dense["lengths"] = torch.as_tensor(at + 1)
    jc = _to_jax(dense)
    step = _tokens(34, 2, 1)
    for _ in range(3):
        got, dense, _ = T.apply(QCFG, tp, torch.as_tensor(step), cache=dense,
                                mode="decode", logits_slice="last")
        want, jc, _ = JT.apply(JQCFG, jp, jnp.asarray(step), cache=jc,
                               mode="decode", logits_slice="last")
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        step = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    _assert_tree_close(dense, jc, **LOGIT_TOL)


def test_int8_prefix_aware_prefill_raises(weights):
    """JAX asserts 'int8 cache + prefix store not combined'; the port
    raises ValueError, on paged and dense caches alike."""
    _, tp = weights
    pc = _paged_after_prefill(tp, _tokens(35, 2, 16),
                              np.asarray([16, 16], np.int32), 48, 8)
    with pytest.raises(ValueError, match="int8"):
        T.apply(QCFG, tp, torch.as_tensor(_tokens(36, 2, 8)), cache=pc,
                mode="prefill", prefix_aware=True)
    with pytest.raises(ValueError, match="int8"):
        T.apply(QCFG, tp, torch.as_tensor(_tokens(36, 2, 8)),
                cache=T.init_cache(QCFG, 2, 32, device="cpu"),
                mode="prefill", prefix_aware=True)


# ---------------------------------------------------------------------------
# The paged runtime carries the scale leaves
# ---------------------------------------------------------------------------

def test_wire_state_functions_carry_scales(weights):
    """extract/insert, copy-on-write page copies, dense<->paged, the head
    split and the hand-off byte count each carry k_scale/v_scale pages
    beside k/v, leaf for leaf against JAX."""
    _, tp = weights
    toks = _tokens(37, 2, 21)
    pc = _paged_after_prefill(tp, toks, np.asarray([21, 21], np.int32),
                              48, 8)
    jc = _to_jax(pc)
    row = pc["block_tables"][1].numpy()[:3]
    st = KC.extract_paged_state(pc, 1, 8, table_row=row, length=21)
    jst = JKC.extract_paged_state(jc, 1, 8, table_row=row, length=21)
    _assert_tree_close(st, jst)
    for g in st["groups"]:
        assert g["k_scale"].shape == g["k"].shape[:-1]
        assert g["k"].dtype == torch.int8
        assert float(g["v_scale"].abs().max()) > 0
    _assert_tree_close(KC.split_paged_state(st, 1, 8),
                       JKC.split_paged_state(jst, 1, 8))
    dense = KC.paged_state_to_dense(st, 8, 48)
    _assert_tree_close(dense, JKC.paged_state_to_dense(jst, 8, 48))
    _assert_tree_close(KC.dense_state_to_paged(dense, 8),
                       JKC.dense_state_to_paged(
                           JKC.paged_state_to_dense(jst, 8, 48), 8))
    assert KC.state_num_bytes(st) == JKC.state_num_bytes(jst)
    # int8 K/V + f32 scales + int32 positions: fewer bytes than f32 K/V
    f32_st = KC.extract_paged_state(
        T.init_paged_cache(PTINY, 2, 48, 8, device="cpu"), 1, 8,
        table_row=row, length=21)
    assert KC.state_num_bytes(st) < KC.state_num_bytes(f32_st) / 2
    blank = T.init_paged_cache(QCFG, 2, 48, 8, device="cpu")
    KC.insert_paged_state(blank, 0, st, [7, 3, 9], 8)
    jblank = JKC.insert_paged_state(JT.init_paged_cache(JQCFG, 2, 48, 8), 0,
                                    jst, [7, 3, 9], 8)
    _assert_tree_close(blank, jblank)
    KC.copy_pages(blank, [7, 3], [11, 12], block_size=8)
    jblank = JKC.copy_pages(jblank, [7, 3], [11, 12], block_size=8)
    _assert_tree_close(blank, jblank)
    for g in blank["groups"]:
        for key in ("k", "v", "k_scale", "v_scale", "pos"):
            assert torch.equal(g[key][:, 11], g[key][:, 7]), key
    assert not KC.prefix_cacheable(QCFG) and KC.global_attention(QCFG)


# ---------------------------------------------------------------------------
# Serving: engines, speculation, the orchestrator
# ---------------------------------------------------------------------------

ECFG = EngineConfig(max_len=64, max_batch=3, block_size=8)


def _prompts(seed=5, n=3):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, 128, 11 + 6 * i), np.int32)
            for i in range(n)]


def _run_port(tp, ecfg, prompts, max_new=8, draft=None):
    pe = PrefillEngine(QCFG, tp, ecfg, device="cpu")
    de = DecodeEngine(QCFG, tp, ecfg, device="cpu", draft=draft)
    reqs = []
    for rid, prompt in enumerate(prompts):
        r = Request(rid=rid, arrival=0.0, prompt=prompt.copy(),
                    max_new_tokens=max_new)
        st, lg = pe.run(r)
        de.insert(r, st, int(torch.argmax(lg)))
        reqs.append(r)
    while de.active:
        de.step()
    assert de.active == 0
    de.pool.check(holders=[de.slot_pages(i)
                           for i in range(de.ecfg.max_batch)])
    assert len(de._free) == de.ecfg.max_batch * de._nb_slot, "leaked pages"
    return de, [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(tiny_params):
    """The JAX engines' int8 streams on ``_prompts()`` (JAX's gather
    reference decode, the stream its page-fused kernel equals)."""
    ecfg = JEngineConfig(max_len=64, max_batch=3, block_size=8,
                         decode_kernel=False)
    pe = JPrefill(JQCFG, tiny_params, ecfg, None)
    de = JDecode(JQCFG, tiny_params, ecfg)
    reqs = []
    for rid, prompt in enumerate(_prompts()):
        r = JRequest(rid=rid, arrival=0.0, prompt=prompt.copy(),
                     max_new_tokens=8)
        st, lg = pe.run(r)
        de.insert(r, st, int(jnp.argmax(lg)))
        reqs.append(r)
    while de.active:
        de.step()
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("decode_kernel", [None, False])
def test_int8_engine_streams_equal_jax(weights, jax_streams, decode_kernel):
    """The port's int8 engines (the kernel path and the gather-then-attend
    reference) give the JAX engines' streams on the same prompts."""
    _, tp = weights
    _, streams = _run_port(tp, dataclasses.replace(
        ECFG, decode_kernel=decode_kernel), _prompts())
    assert streams == jax_streams
    assert all(len(s) == 8 for s in streams)


@pytest.mark.parametrize("prop", ["ngram", "draft"])
def test_int8_speculation_bit_identical(weights, jax_streams, prop):
    """n-gram and self-draft speculation on int8 pages (the draft keeps a
    dense int8 cache): the plain stream, every self-draft proposal
    accepted, the pool clean afterwards."""
    _, tp = weights
    ecfg = dataclasses.replace(ECFG, speculation=prop, spec_len=4)
    de, streams = _run_port(tp, ecfg, _prompts(),
                            draft=(QCFG, tp) if prop == "draft" else None)
    assert streams == jax_streams
    assert de.decode_iters > 0
    if prop == "draft":
        assert de.spec_proposed > 0
        assert de.spec_accepted == de.spec_proposed
        assert de.decode_iters < 8


def test_int8_served_through_orchestrator(weights, jax_streams):
    """Server over the port's Orchestrator serves int8 prompts that fit in
    one chunk (no store attached, no prefix binds, pools restored) with
    the JAX engines' streams; a prompt longer than chunk_tokens raises
    before any prefill work, as JAX cannot resume it either."""
    _, tp = weights
    ocfg = OrchestratorConfig(n_prefill=1, n_decode=1, engine=ECFG,
                              chunk_tokens=32)
    orch = Orchestrator(QCFG, tp, ocfg, device="cpu")
    assert orch.store is not None and not orch.prefix_sharing
    assert orch.prefill_members()[0].prefill.store is None
    reqs = [Request(rid=i, arrival=0.0, prompt=p.copy(), max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    summary = Server(orch).run(reqs)
    assert [r.generated for r in reqs] == jax_streams
    assert summary["pages_bound"] == 0 and summary["store_entries"] == 0
    assert_pools_restored(orch)
    pe = PrefillEngine(QCFG, tp, ECFG, device="cpu")
    long = Request(rid=9, arrival=0.0, prompt=_prompts(6, 1)[0].repeat(4),
                   max_new_tokens=2)
    with pytest.raises(ValueError, match="chunk_tokens=16"):
        pe.prefill_waves([long], chunk_tokens=16)
    assert long.phase.value == "queued" and pe.tokens_prefilled == 0
