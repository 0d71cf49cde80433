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

The verify cases (B4) also write the in-flight tokens and stale
rolled-back ones into their pages, as the serving path does before the
read.

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
from repro.kernels.split_kv_decode import \
    paged_verify_partials as j_paged_verify_partials
from repro_torch.core import attention_offload as PAO
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               paged_prefix_partials,
                                               prefix_pages_per_split,
                                               split_rule)
from repro_torch.kernels.split_kv_decode import (decode_pages_per_split,
                                                 decode_split_rule,
                                                 paged_decode_partials,
                                                 paged_verify_partials,
                                                 verify_pages_per_split,
                                                 verify_rows_per_block,
                                                 verify_split_rule)
from test_torch_cuda import dense_case as _dense_case
from test_torch_cuda import paged_case as _paged_case
from test_torch_cuda import verify_case as _verify_case

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


@pytest.mark.parametrize("split", [3, "nb"])
@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", PAGED)
def test_paged_decode_split_partials_vs_jax_merge(b, h, kv, d, bs, nb, win,
                                                  cap, split):
    """B1's plain version with several pages per split (3: a ragged last
    split; nb: one split per row) equals the exact merge of JAX's per-page
    partials over each group."""
    pps = nb if split == "nb" else split
    c = _paged_case(0, b, h, kv, d, bs, nb)
    got = paged_decode_partials(*_args(c, _t), window=win, soft_cap=cap,
                                pages_per_split=pps)
    want = merge_groups(j_paged_decode_partials(
        *_args(c, jnp.asarray), window=win, soft_cap=cap, interpret=True),
        pps)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].shape[1] == -(-nb // pps)
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("b,h,kv,d,bs,nb,win,cap", PAGED)
def test_paged_decode_attention_split_vs_jax_and_oracles(b, h, kv, d, bs, nb,
                                                         win, cap, pps):
    """The combined paged decode at one partial per page and per 3 pages
    (the CPU default is one split per row) against JAX's and the oracle."""
    c = _paged_case(1, b, h, kv, d, bs, nb)
    out = ops.paged_decode_attention(*_args(c, _t), window=win, soft_cap=cap,
                                     pages_per_split=pps)
    _close(out.numpy(), JOPS.paged_decode_attention(
        *_args(c, jnp.asarray), window=win, soft_cap=cap, interpret=True))
    _close(out.numpy(), ref.paged_decode_attention_reference(
        *_args(c, _t), window=win, soft_cap=cap).numpy())


def test_dead_or_masked_decode_split_is_the_all_masked_partial():
    """A decode split whose entries are all dead, and one whose live pages
    hold only holes and keys after the query, give o = 0, l = 0,
    m = NEG_INF; the other splits match JAX's merged per-page partials."""
    b, h, kv, d, bs, nb = 2, 4, 2, 16, 8, 9
    c = _paged_case(13, b, h, kv, d, bs, nb)
    tables = c["block_tables"]
    tables[0, 6:9] = -1                       # split 2 of row 0: dead
    for j in range(6, 9):                     # row 1, split 2: nothing seen
        page = 1 + b * nb - 1 - j
        tables[1, j] = page
        c["pos_pages"][page] = c["pos_q"][1] + 1 + np.arange(bs)
    c["pos_pages"][tables[1, 6], :3] = -1
    got = paged_decode_partials(*_args(c, _t), pages_per_split=3)
    for row in (0, 1):
        assert torch.equal(got[0][row, 2], torch.zeros_like(got[0][row, 2]))
        assert torch.equal(got[1][row, 2], torch.zeros_like(got[1][row, 2]))
        assert (got[2][row, 2] == NEG_INF).all()
    want = merge_groups(j_paged_decode_partials(*_args(c, jnp.asarray),
                                                interpret=True), 3)
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("b,h,kv,nb,n_sm,want", [
    (64, 40, 40, 64, 132, 64),   # 2,560 blocks: one split per row
    (8, 40, 40, 64, 132, 16),    # 320 blocks: 4 splits of 16
    (1, 40, 40, 64, 132, 3),     # 40 blocks: 22 splits of 3
    (2, 32, 8, 64, 132, 1),      # GQA G = 4, one block per kv head: 16
    (1, 16, 1, 3, 132, 1),       # G = 16: 2 blocks; never more splits
    (1, 8, 8, 1, 132, 1)])
def test_decode_split_rule(b, h, kv, nb, n_sm, want):
    """B * KV * ceil(G / rows per block) blocks per split; each row cut
    into enough splits for about eight blocks per SM, one split per row
    when the blocks reach that, never more splits than pages."""
    assert decode_split_rule(b, h, kv, nb, n_sm) == want
    assert decode_pages_per_split(torch.zeros((b, h, 8)), kv, nb) == nb


# ---------------------------------------------------------------------------
# B4: speculative-verify partials
# ---------------------------------------------------------------------------

# (b, s, h, kv, d, bs, nb, window, soft_cap): S = 2 and 5, MHA, GQA, an
# empty slot (b > 2), window, soft cap
VERIFY = [(3, 2, 4, 4, 16, 8, 4, None, None),
          (2, 5, 8, 2, 32, 4, 6, None, None),
          (3, 5, 4, 2, 16, 8, 4, 11, None),
          (2, 2, 4, 1, 16, 8, 3, None, 5.0),
          (3, 5, 6, 2, 8, 4, 5, 7, 3.0)]


@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", VERIFY)
def test_paged_verify_partials_vs_jax(b, s, h, kv, d, bs, nb, win, cap):
    c = _verify_case(12, b, s, h, kv, d, bs, nb)
    got = paged_verify_partials(*_args(c, _t), window=win, soft_cap=cap,
                                pages_per_split=1)
    want = j_paged_verify_partials(*_args(c, jnp.asarray), window=win,
                                   soft_cap=cap, interpret=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", VERIFY)
def test_paged_verify_attention_vs_jax_and_oracles(b, s, h, kv, d, bs, nb,
                                                   win, cap):
    c = _verify_case(13, b, s, h, kv, d, bs, nb)
    out = ops.paged_verify_attention(*_args(c, _t), window=win, soft_cap=cap)
    j_out = JOPS.paged_verify_attention(*_args(c, jnp.asarray), window=win,
                                        soft_cap=cap, interpret=True)
    assert tuple(out.shape) == (b, s, h, d)
    _close(out.numpy(), j_out)
    _close(out.numpy(), ref.paged_verify_attention_reference(
        *_args(c, _t), window=win, soft_cap=cap).numpy())
    _close(out.numpy(), JREF.paged_verify_attention_reference(
        *_args(c, jnp.asarray), window=win, soft_cap=cap))


@pytest.mark.parametrize("split", [3, "nb"])
@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", VERIFY)
def test_paged_verify_split_partials_vs_jax_merge(b, s, h, kv, d, bs, nb,
                                                  win, cap, split):
    """B4's plain version with several pages per split (3: a ragged last
    split, and an empty slot's dead splits; nb: one split per row) equals
    the exact merge of JAX's per-page partials over each group."""
    pps = nb if split == "nb" else split
    c = _verify_case(12, b, s, h, kv, d, bs, nb)
    got = paged_verify_partials(*_args(c, _t), window=win, soft_cap=cap,
                                pages_per_split=pps)
    want = merge_groups(j_paged_verify_partials(
        *_args(c, jnp.asarray), window=win, soft_cap=cap, interpret=True),
        pps)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].shape[1] == -(-nb // pps)
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", VERIFY)
def test_paged_verify_attention_split_vs_jax_and_oracles(b, s, h, kv, d, bs,
                                                         nb, win, cap, pps):
    """The combined verify at one partial per page and per 3 pages (the
    CPU default is one split per row) against JAX's and the oracle."""
    c = _verify_case(13, b, s, h, kv, d, bs, nb)
    out = ops.paged_verify_attention(*_args(c, _t), window=win, soft_cap=cap,
                                     pages_per_split=pps)
    _close(out.numpy(), JOPS.paged_verify_attention(
        *_args(c, jnp.asarray), window=win, soft_cap=cap, interpret=True))
    _close(out.numpy(), ref.paged_verify_attention_reference(
        *_args(c, _t), window=win, soft_cap=cap).numpy())


def test_dead_or_masked_verify_split_is_the_all_masked_partial():
    """A verify split whose entries are all dead, and one whose live pages
    hold only holes and keys after every query, give o = 0, l = 0,
    m = NEG_INF for all S queries; a split seen only by the later queries
    (the in-flight tokens) is all-masked for the earlier ones alone.  The
    rest match JAX's merged per-page partials."""
    b, s, h, kv, d, bs, nb = 2, 3, 4, 2, 16, 4, 9
    c = _verify_case(15, b, s, h, kv, d, bs, nb)
    n0, rng = c["k_pages"].shape[0], np.random.default_rng(16)
    for key in ("k_pages", "v_pages"):         # six fresh pages
        c[key] = np.concatenate([c[key], rng.normal(
            size=(6,) + c[key].shape[1:]).astype(np.float32)])
    c["pos_pages"] = np.concatenate([c["pos_pages"],
                                     np.full((6, bs), -1, np.int32)])
    tables, pos, fresh = c["block_tables"], c["pos_pages"], n0 + np.arange(6)
    tables[0, 6:9] = -1                       # split 2 of row 0: dead
    tables[1, 6:9] = fresh[:3]                # row 1, split 2: nothing seen
    pos[fresh[:3]] = c["pos_q"][1, -1] + 1 + np.arange(bs)
    pos[fresh[0], :2] = -1
    tables[0, 3:6] = fresh[3:]                # row 0, split 1: only the
    pos[fresh[3], 1] = c["pos_q"][0, -1]      # last query's own token
    got = paged_verify_partials(*_args(c, _t), pages_per_split=3)
    for row in (0, 1):
        assert torch.equal(got[0][row, 2], torch.zeros_like(got[0][row, 2]))
        assert torch.equal(got[1][row, 2], torch.zeros_like(got[1][row, 2]))
        assert (got[2][row, 2] == NEG_INF).all()
    assert torch.equal(got[1][0, 1, :-1], torch.zeros_like(got[1][0, 1, :-1]))
    assert (got[2][0, 1, :-1] == NEG_INF).all()
    assert (got[1][0, 1, -1] > 0).all()
    want = merge_groups(j_paged_verify_partials(*_args(c, jnp.asarray),
                                                interpret=True), 3)
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("b,s,h,kv,d,nb,n_sm,int8,want", [
    (8, 5, 40, 40, 128, 64, 132, False, 16),  # llama-13b: 320 walk blocks
    (8, 4, 32, 8, 128, 64, 132, False, 4),    # 16 rows: one walk block
    (4, 5, 32, 8, 128, 64, 132, False, 8),    # 20 rows: B3's body and rule
    (4, 5, 32, 8, 128, 64, 132, True, 4),     # int8: two walk blocks
    (2, 5, 32, 8, 256, 64, 132, True, 2),     # ... at head_dim 256 too
    (2, 5, 128, 8, 128, 64, 132, True, 5),    # int8 G = 16: 80 rows, five
    (2, 5, 128, 8, 128, 64, 132, False, 4),   # 16 blocks: 2 per SM (B3)
    (64, 5, 40, 40, 128, 64, 132, False, 64),  # 2,560 blocks: one split
    (3, 2, 4, 4, 64, 10, 132, True, 1),       # never more splits than pages
    (1, 2, 8, 8, 64, 1, 132, False, 1)])
def test_verify_split_rule(b, s, h, kv, d, nb, n_sm, int8, want):
    """On the walk, B * KV * ceil(S * G / 16) blocks per split, each row
    cut into enough splits for about eight blocks per SM; above 16 rows of
    a bf16/f32 pool, B3's tile body and B3's own rule; never more splits
    than pages."""
    assert verify_split_rule(b, s, h, kv, d, nb, n_sm, int8) == want
    assert verify_pages_per_split(torch.zeros((b, s, h, d)), kv, nb,
                                  int8) == nb


def test_verify_rows_per_block():
    rows = (1, 4, 5, 8, 9, 16, 17, 80)
    assert [verify_rows_per_block(r, 128) for r in rows] \
        == [16, 16, 16, 16, 16, 16, 128, 128]
    assert [verify_rows_per_block(r, 128, int8=True) for r in rows] \
        == [16] * len(rows)
    assert [verify_rows_per_block(r, 256) for r in (2, 5, 20)] \
        == [16, 16, 64]
    assert [verify_rows_per_block(r, 256, int8=True) for r in (2, 5, 20)] \
        == [16, 16, 16]


def test_verify_hides_later_in_flight_tokens_by_position():
    """All S in-flight tokens are written before the read: query s must not
    see the tokens at positions past pos_q[s] (nor stale rolled-back
    ones), so changing their keys and values leaves query 0 unchanged,
    and each query equals a one-query decode at its own position."""
    c = _verify_case(14, 2, 5, 4, 2, 16, 8, 4)
    base = ops.paged_verify_attention(*_args(c, _t))
    for row in range(2):
        for t in range(int(c["pos_q"][row, 0]) + 1,
                       int(c["pos_q"][row, -1]) + 3):
            page = c["block_tables"][row, t // 8]
            c["k_pages"][page, t % 8] = 50.0
            c["v_pages"][page, t % 8] = -50.0
    moved = ops.paged_verify_attention(*_args(c, _t))
    _close(moved[:, 0].numpy(), base[:, 0].numpy())
    assert not np.allclose(moved[:, 1].numpy(), base[:, 1].numpy())
    for s in range(5):
        one = ops.paged_decode_attention(
            _t(c["q"][:, s]), *_args(c, _t)[1:5], _t(c["pos_q"][:, s]))
        _close(moved[:, s].numpy(), one.numpy())


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


def merge_groups(parts, group):
    """The exact merge of per-page partials (B, nb, ...) over consecutive
    groups of ``group`` pages (the last ragged), in float64: m the group's
    max, o and l weighted by exp(m_page - m)."""
    o, l, m = (np.asarray(x, np.float64) for x in parts)
    out = ([], [], [])
    for lo in range(0, l.shape[1], group):
        mg = m[:, lo:lo + group].max(axis=1)
        w = np.exp(m[:, lo:lo + group] - mg[:, None])
        out[0].append((o[:, lo:lo + group] * w[..., None]).sum(axis=1))
        out[1].append((l[:, lo:lo + group] * w).sum(axis=1))
        out[2].append(mg)
    return tuple(np.stack(x, axis=1) for x in out)


@pytest.mark.parametrize("split", [3, "nb"])
@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", PREFIX)
def test_paged_prefix_split_partials_vs_jax_merge(b, s, h, kv, d, bs, nb, win,
                                                  cap, split):
    """B3's plain version with several pages per split (3: a ragged last
    split, and whole splits of dead entries; nb: one split per row) equals
    the exact merge of JAX's per-page partials over each group."""
    pps = nb if split == "nb" else split
    c = _paged_case(7, b, h, kv, d, bs, nb, s=s)
    got = paged_prefix_partials(*_args(c, _t), window=win, soft_cap=cap,
                                pages_per_split=pps)
    per_page = j_paged_prefix_partials(*_args(c, jnp.asarray), window=win,
                                       soft_cap=cap, interpret=True)
    want = merge_groups(per_page, pps)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].shape[1] == -(-nb // pps)
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("b,s,h,kv,d,bs,nb,win,cap", PREFIX)
def test_paged_prefill_attention_split_vs_jax_and_oracles(b, s, h, kv, d, bs,
                                                          nb, win, cap, pps):
    """The combined paged prefill at one partial per page and per 3 pages
    (the CPU default is one split per row) against JAX's and the oracle."""
    c = _paged_case(8, b, h, kv, d, bs, nb, s=s)
    rng = np.random.default_rng(9)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    pages = _args(c, _t)
    out = ops.paged_prefill_attention(pages[0], _t(k), _t(v), *pages[1:],
                                      window=win, soft_cap=cap, block_q=8,
                                      block_k=8, pages_per_split=pps)
    jp = _args(c, jnp.asarray)
    j_out = JOPS.paged_prefill_attention(
        jp[0], jnp.asarray(k), jnp.asarray(v), *jp[1:], window=win,
        soft_cap=cap, block_q=8, block_k=8, interpret=True)
    _close(out.numpy(), j_out)
    oracle = ref.paged_prefill_attention_reference(
        pages[0], _t(k), _t(v), *pages[1:], window=win, soft_cap=cap)
    _close(out.numpy(), oracle.numpy())


def test_dead_or_masked_split_is_the_all_masked_partial():
    """A split whose entries are all dead, and one whose live pages hold no
    key any query sees (the chunk's own pages before the suffix write),
    give o = 0, l = 0, m = NEG_INF; the other splits match JAX's merged
    per-page partials."""
    b, s, h, kv, d, bs, nb = 2, 8, 4, 2, 16, 8, 9
    c = _paged_case(12, b, h, kv, d, bs, nb, s=s)
    tables = c["block_tables"]
    tables[0, 6:9] = -1                       # split 2 of row 0: dead
    # row 1: split 2 live, but every key after every query
    for j in range(6, 9):
        page = tables[1, j] if tables[1, j] >= 0 else 1 + b * nb - 1 - j
        tables[1, j] = page
        c["pos_pages"][page] = 10_000 + np.arange(bs)
    got = paged_prefix_partials(*_args(c, _t), pages_per_split=3)
    for row in (0, 1):
        assert torch.equal(got[0][row, 2], torch.zeros_like(got[0][row, 2]))
        assert torch.equal(got[1][row, 2], torch.zeros_like(got[1][row, 2]))
        assert (got[2][row, 2] == NEG_INF).all()
    want = merge_groups(j_paged_prefix_partials(*_args(c, jnp.asarray),
                                                 interpret=True), 3)
    _close(tuple(g.numpy() for g in got), want)


@pytest.mark.parametrize("b,s,h,kv,d,nb,n_sm,want", [
    (4, 256, 40, 40, 128, 64, 132, 64),   # 320 blocks fill the card
    (1, 128, 40, 40, 128, 64, 132, 10),   # 40 blocks: 7 splits of 10
    (2, 64, 32, 8, 128, 64, 132, 8),      # GQA: 32 blocks, 8 splits of 8
    (1, 16, 8, 2, 256, 3, 132, 1),        # never more splits than pages
    (1, 16, 8, 2, 64, 1, 132, 1)])
def test_serving_split_rule(b, s, h, kv, d, nb, n_sm, want):
    """One split per row unless B * KV * ceil(S * G / rows per block)
    blocks leave SMs idle; then about two blocks per SM."""
    assert split_rule(b, s, h, kv, d, nb, n_sm) == want
    assert prefix_pages_per_split(torch.zeros((b, s, h, d)), kv, nb) == nb


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
    assert set(_lib.LAUNCHES) == {"paged_decode_partials",
                                  "paged_decode_partials_int8",
                                  "flash_prefill", "paged_prefix_partials",
                                  "paged_verify_partials",
                                  "paged_verify_partials_int8",
                                  "split_kv_decode_partials",
                                  "mlstm_scan", "mlstm_scan_chunkwise",
                                  "mlstm_scan_backward",
                                  "mlstm_scan_backward_chunkwise",
                                  "slstm_scan", "slstm_scan_persistent",
                                  "slstm_scan_backward",
                                  "slstm_scan_backward_persistent"}
    c = _verify_case(11, 2, 3, 4, 2, 16, 8, 3)
    got = paged_verify_partials(*_args(c, _t))
    want = ref.paged_verify_partials_plain(*_args(c, _t))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in _lib.LAUNCHES.values())


def test_mask_args_reject_bad_window_and_cap():
    assert _lib.mask_args(None, None) == (0, 0.0)
    assert _lib.mask_args(16, 2.5) == (16, 2.5)
    with pytest.raises(ValueError):
        _lib.mask_args(0, None)
    with pytest.raises(ValueError):
        _lib.mask_args(None, -1.0)
