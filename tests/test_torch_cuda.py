"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card each case skips.  The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The synthetic cases are shared with ``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               paged_prefix_partials)
from repro_torch.kernels.split_kv_decode import (decode_pages_per_split,
                                                 paged_decode_partials,
                                                 paged_verify_partials,
                                                 split_kv_decode_partials,
                                                 verify_pages_per_split)
from repro_torch.models.weights import cast_params

KEYS = ("q", "k_pages", "v_pages", "pos_pages", "block_tables", "pos_q")


def paged_case(seed, b, h, kv, d, bs, nb, s=None, hole=True):
    """A pool with ragged per-row tables.  s None: decode, one query per
    row at position length-1.  s given: a resume chunk of s queries after
    a block-aligned prefix; the chunk's own pages are allocated (pos -1,
    as before the suffix write).  Unassigned pages and the scratch page
    hold poison positions; each row's first page gets a hole."""
    rng = np.random.default_rng(seed)
    n_phys = 1 + b * nb
    k_pages = rng.normal(size=(n_phys, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(n_phys, bs, kv, d)).astype(np.float32)
    pos_pages = rng.integers(0, bs * nb, (n_phys, bs)).astype(np.int32)
    tables = np.full((b, nb), -1, np.int32)
    if s is None:
        live = rng.integers(1, bs * nb + 1, b)
    else:
        live = rng.integers(0, (bs * nb - s) // bs + 1, b) * bs
    nxt = 1
    for row in range(b):
        total = int(live[row]) + (s or 0)
        for j in range(-(-total // bs)):
            tables[row, j] = nxt
            p = np.arange(j * bs, (j + 1) * bs)
            p[p >= live[row]] = -1
            pos_pages[nxt] = p
            nxt += 1
        if hole and live[row] > 1:
            pos_pages[tables[row, 0], 0] = -1
    if s is None:
        q = rng.normal(size=(b, h, d)).astype(np.float32)
        pos_q = (live - 1).astype(np.int32)
    else:
        q = rng.normal(size=(b, s, h, d)).astype(np.float32)
        pos_q = (live[:, None] + np.arange(s)[None]).astype(np.int32)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages,
                block_tables=tables, pos_q=pos_q)


def verify_case(seed, b, s, h, kv, d, bs, nb, stale=2):
    """A speculative verify step over a pool: each row holds ``live``
    committed tokens plus the S in-flight tokens (the pending one and its
    proposals) already written at positions live..live+S-1; ``stale``
    tokens rejected by an earlier verify sit just past them in the last
    page (later positions, still written) and must stay masked.  The last
    row (when b > 2) is an empty slot: an all-dead table and positions
    0..S-1, as the engine gives it.  Unassigned pages and the scratch
    page hold poison positions; each row's first page gets a hole."""
    rng = np.random.default_rng(seed)
    n_phys = 1 + b * nb
    k_pages = rng.normal(size=(n_phys, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(n_phys, bs, kv, d)).astype(np.float32)
    pos_pages = rng.integers(0, bs * nb, (n_phys, bs)).astype(np.int32)
    tables = np.full((b, nb), -1, np.int32)
    live = rng.integers(1, bs * nb - s - stale + 1, b)
    if b > 2:
        live[-1] = 0
    nxt = 1
    for row in range(b if b <= 2 else b - 1):
        total = int(live[row]) + s
        for j in range(-(-total // bs)):
            tables[row, j] = nxt
            p = np.arange(j * bs, (j + 1) * bs)
            p[p >= total + stale] = -1
            pos_pages[nxt] = p
            nxt += 1
        if live[row] > 1:
            pos_pages[tables[row, 0], 0] = -1
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos_q = (live[:, None] + np.arange(s)[None]).astype(np.int32)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages,
                block_tables=tables, pos_q=pos_q)


def quantize_pages(c):
    """The case with its K/V pools stored as int8 plus one f32 scale per
    (entry, kv head): the grid ``quantize_kv`` writes (amax over D,
    max(amax, 1e-6) / 127, round half to even, clip to +-127)."""
    out = dict(c)
    for name in ("k", "v"):
        x = c[f"{name}_pages"].astype(np.float32)
        sc = (np.maximum(np.abs(x).max(-1), np.float32(1e-6))
              / np.float32(127.0)).astype(np.float32)
        out[f"{name}_pages"] = np.clip(np.round(x / sc[..., None]), -127,
                                       127).astype(np.int8)
        out[f"{name}_scale_pages"] = sc
    return out


def poison_unseen_scales(c):
    """The quantized case with NaN in the scale slots of every pool entry
    that no query of any row sees without a window: holes, slots not
    written yet, stale rolled-back tokens, the scratch page and unassigned
    pages.  A kernel that lets a masked entry's scale (or a stale scale
    slot of its own) reach p gives NaN partials."""
    out = dict(c)
    pos, tables = c["pos_pages"], c["block_tables"]
    pq = np.asarray(c["pos_q"]).reshape(tables.shape[0], -1)
    seen = np.zeros(pos.shape, bool)
    for row in range(tables.shape[0]):
        for page in tables[row][tables[row] >= 0]:
            seen[page] |= (pos[page] >= 0) & (pos[page] <= pq[row].max())
    for name in ("k_scale_pages", "v_scale_pages"):
        out[name] = np.where(seen[..., None], c[name], np.float32(np.nan))
    return out


def decode_case(seed, b, h, kv, d, length):
    """Dense-cache decode: q (B, H, D), k/v (B, L, KV, D) and a ragged
    validity mask (each row valid up to its own length, plus holes)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, length + 1, b)
    valid = np.arange(length)[None, :] < lens[:, None]
    valid &= rng.random((b, length)) > 0.1
    return (rng.normal(size=(b, h, d)).astype(np.float32),
            rng.normal(size=(b, length, kv, d)).astype(np.float32),
            rng.normal(size=(b, length, kv, d)).astype(np.float32), valid)


def dense_case(seed, b, s, length, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, length, kv, d)).astype(np.float32),
            rng.normal(size=(b, length, kv, d)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_vs_plain(dtype, d):
    """Each CUDA kernel against its plain version on the card (GQA, window,
    soft cap, dead entries, holes; every head_dim variant of the flash
    kernel).  f32: both sides compute in f32 from the
    same inputs, 1e-4 covers the summation order; a normalized bf16 output
    may differ by one bf16 step, 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)

    def cu(c):
        return tuple(torch.as_tensor(c[k]).cuda().to(dt) if c[k].dtype ==
                     np.float32 else torch.as_tensor(c[k]).cuda()
                     for k in ("q", "k_pages", "v_pages", "pos_pages",
                               "block_tables", "pos_q"))

    for win, cap in ((None, None), (40, 20.0)):
        a = cu(paged_case(12, 4, 8, 2, d, 16, 16))
        got = paged_decode_partials(*a, window=win, soft_cap=cap)
        want = ref.paged_decode_partials_plain(*a, window=win, soft_cap=cap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        a = cu(paged_case(13, 2, 8, 2, d, 16, 16, s=64))
        got = paged_prefix_partials(*a, window=win, soft_cap=cap)
        want = ref.paged_prefix_partials_plain(*a, window=win, soft_cap=cap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        q, k, v = (torch.as_tensor(x).cuda().to(dt)
                   for x in dense_case(14, 2, 96, 96, 8, 2, d))
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(
            flash_prefill(q, k, v, window=win, soft_cap=cap),
            ref.flash_prefill_plain(q, k, v, window=win, soft_cap=cap),
            atol=tol, rtol=tol)
        for g, w in zip(flash_prefill(q[:, 32:], k, v, seq_offset=32,
                                      window=win, soft_cap=cap,
                                      return_partials=True),
                        ref.flash_prefill_plain(q[:, 32:], k, v,
                                                seq_offset=32, window=win,
                                                soft_cap=cap,
                                                return_partials=True)):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 5])
def test_cuda_verify_kernel_vs_plain(s, dtype, d):
    """The speculative-verify kernel (B4) against its plain version: S
    queries per row, GQA, window and soft cap, an empty slot's all-dead
    row, holes, and stale rolled-back tokens past the in-flight ones.
    Both sides compute in f32 from the same inputs: 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    c = verify_case(15, 4, s, 8, 2, d, 16, 16)
    a = tuple(torch.as_tensor(c[k]).cuda().to(dt) if c[k].dtype ==
              np.float32 else torch.as_tensor(c[k]).cuda()
              for k in ("q", "k_pages", "v_pages", "pos_pages",
                        "block_tables", "pos_q"))
    for win, cap in ((None, None), (40, 20.0)):
        got = paged_verify_partials(*a, window=win, soft_cap=cap)
        torch.cuda.synchronize()
        want = ref.paged_verify_partials_plain(*a, window=win, soft_cap=cap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _on_card(c, dt):
    """A case's arrays on the card: q in ``dt``, float pools in ``dt`` (int8
    pools stay int8, scale pools f32), indices as they are."""
    out = {k: torch.as_tensor(c[k]).cuda() for k in c}
    for k in ("q", "k_pages", "v_pages"):
        if out[k].is_floating_point():
            out[k] = out[k].to(dt)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_page_kernels_vs_plain(dtype, d):
    """The int8-pool variants of B1 and B4 against their plain versions:
    GQA, window and soft cap (the K scale folds in before the cap), scales
    far from 1, dead entries, holes, an empty slot and stale tokens.  Both
    sides dequantize into f32 from the same int8 values: 1e-4.  Scale
    pools that are not float32 are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    cases = [(paged_decode_partials, ref.paged_decode_partials_plain,
              paged_case(16, 4, 8, 2, d, 16, 16)),
             (paged_verify_partials, ref.paged_verify_partials_plain,
              verify_case(17, 4, 5, 8, 2, d, 16, 16))]
    for kernel, plain, c in cases:
        a = _on_card(quantize_pages(c), dt)
        scales = dict(k_scale_pages=a["k_scale_pages"],
                      v_scale_pages=a["v_scale_pages"])
        for win, cap in ((None, None), (40, 30.0)):
            got = kernel(*(a[k] for k in KEYS), window=win, soft_cap=cap,
                         **scales)
            torch.cuda.synchronize()
            want = plain(*(a[k] for k in KEYS), window=win, soft_cap=cap,
                         **scales)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        with pytest.raises(ValueError, match="scale pools"):
            kernel(*(a[k] for k in KEYS), k_scale_pages=scales[
                "k_scale_pages"].to(dt if dt != torch.float32
                                    else torch.float64),
                v_scale_pages=scales["v_scale_pages"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_kv_decode_vs_plain(dtype, d):
    """B5, dense-cache split-KV decode, against its plain version (MHA,
    GQA and G = 8, a ragged last block, a block_k that is not a multiple of
    the walk's key tile, fully invalid blocks) and through
    ``ops.decode_attention`` (L padded to the block) against the one-softmax
    reference.  Partials: both sides in f32 from the same inputs, 1e-4;
    the combined output in ``dtype``: 1e-4 in f32, one bf16 step (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    # MHA; GQA; G = 8 with a block_k off every key-tile multiple
    for h, kv, length, bk in ((8, 8, 1024, 512), (8, 2, 600, 128),
                              (16, 2, 600, 200)):
        q, k, v, valid = decode_case(18, 3, h, kv, d, length)
        q, k, v = (torch.as_tensor(x).cuda().to(dt) for x in (q, k, v))
        valid = torch.as_tensor(valid).cuda()
        valid[0, bk:] = False                   # whole blocks invalid
        bkp = min(bk, length)
        pad = (-length) % bkp
        kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                  for x in (k, v))
        validp = torch.nn.functional.pad(valid, (0, pad))
        got = split_kv_decode_partials(q, kp, vp, validp, block_k=bk)
        torch.cuda.synchronize()
        want = ref.split_kv_decode_partials_plain(q, kp, vp, validp,
                                                  block_k=bk)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(
            ops.decode_attention(q, k, v, valid, block_k=bk),
            ref.decode_attention_reference(q, k, v, valid), atol=tol,
            rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [96, 200])
def test_cuda_prefill_kernels_vs_plain(s, dtype, d):
    """B2 and B3 against their plain versions at S off the 64-row tile
    (96, 200), GQA (G = 4), with and without window plus soft cap.  B2:
    normalized from position 0 and partials at an offset; B3 at
    pages_per_split 1 (one partial per page), 3 (ragged last split, whole
    splits dead) and nb, over a table with dead entries, a dead slot
    inside the prefix and holes.  Partials: both sides in f32 from the same
    inputs, 1e-4; a normalized bf16 output one bf16 step, 2e-2.  A head_dim
    off the multiple of 8 the tiles need is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    nb = 24
    c = paged_case(21, 3, 8, 2, d, 16, nb, s=s)
    c["block_tables"][0, 1] = -1                # a dead slot mid-prefix
    a = _on_card(c, dt)
    pages = tuple(a[k] for k in KEYS)
    q, k, v = (torch.as_tensor(x).cuda().to(dt)
               for x in dense_case(22, 2, s, s, 8, 2, d))
    tol = 1e-4 if dtype == "float32" else 2e-2
    off = 37
    for win, cap in ((None, None), (40, 20.0)):
        kw = dict(window=win, soft_cap=cap)
        torch.testing.assert_close(flash_prefill(q, k, v, **kw),
                                   ref.flash_prefill_plain(q, k, v, **kw),
                                   atol=tol, rtol=tol)
        got = flash_prefill(q[:, off:], k, v, seq_offset=off,
                            return_partials=True, **kw)
        want = ref.flash_prefill_plain(q[:, off:], k, v, seq_offset=off,
                                       return_partials=True, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        for pps in (1, 3, nb):
            got = paged_prefix_partials(*pages, pages_per_split=pps, **kw)
            torch.cuda.synchronize()
            want = ref.paged_prefix_partials_plain(
                *pages, pages_per_split=pps, **kw)
            assert got[0].shape[1] == -(-nb // pps)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill(q[..., :d - 4], k[..., :d - 4], v[..., :d - 4])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_kernel_splits_vs_plain(dtype, d):
    """B1 and its int8 variant at 1 page per split (the TPU contract), 3
    (a ragged last split, whole splits of dead entries) and the serving
    split, MHA and GQA, with and without window plus soft cap, over tables
    with dead entries (a dead slot inside the live range too) and holes.
    Both sides compute in f32 from the same inputs: 1e-4.  A head_dim off
    the 16-element chunk of an int8 pool is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    nb = 24
    for h, kv in ((8, 8), (8, 2)):
        c = paged_case(23, 4, h, kv, d, 16, nb)
        c["block_tables"][0, 1] = -1            # a dead slot mid-table
        for quant in (False, True):
            a = _on_card(quantize_pages(c) if quant else c, dt)
            pages = tuple(a[k] for k in KEYS)
            sc = (dict(k_scale_pages=a["k_scale_pages"],
                       v_scale_pages=a["v_scale_pages"]) if quant else {})
            serving = decode_pages_per_split(pages[0], kv, nb)
            for win, cap in ((None, None), (40, 30.0)):
                for pps in (1, 3, serving):
                    got = paged_decode_partials(*pages, window=win,
                                                soft_cap=cap,
                                                pages_per_split=pps, **sc)
                    torch.cuda.synchronize()
                    want = ref.paged_decode_partials_plain(
                        *pages, window=win, soft_cap=cap,
                        pages_per_split=pps, **sc)
                    assert got[0].shape[1] == -(-nb // pps)
                    for g, w in zip(got, want):
                        torch.testing.assert_close(g, w, atol=1e-4,
                                                   rtol=1e-4)
    a = _on_card(quantize_pages(paged_case(24, 2, 4, 2, 24, 16, 4)), dt)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_partials(*(a[k] for k in KEYS),
                              k_scale_pages=a["k_scale_pages"],
                              v_scale_pages=a["v_scale_pages"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 5, 9])
def test_cuda_verify_kernel_splits_vs_plain(s, dtype, d):
    """B4 and its int8 variant at 1 page per split (the TPU contract), 3
    (a ragged last split, whole splits of dead entries) and the serving
    split, at G = 1, 4 and 16, so that S * G runs from 2 past the 16 rows
    of a walk block (an int8 kv head then takes several blocks, a bf16/f32
    one B3's tile body), with and without
    window plus soft cap, over tables with an empty slot, a dead slot
    inside the live range, holes and stale rolled-back tokens.  Both sides
    compute in f32 from the same inputs: 1e-4.  A head_dim off the 16-element
    chunk of an int8 pool is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    nb = 24
    for h, kv in ((8, 8), (8, 2), (16, 1)):
        c = verify_case(27, 4, s, h, kv, d, 16, nb)
        c["block_tables"][0, 1] = -1            # a dead slot mid-table
        for quant in (False, True):
            a = _on_card(quantize_pages(c) if quant else c, dt)
            pages = tuple(a[k] for k in KEYS)
            sc = (dict(k_scale_pages=a["k_scale_pages"],
                       v_scale_pages=a["v_scale_pages"]) if quant else {})
            serving = verify_pages_per_split(pages[0], kv, nb, quant)
            for win, cap in ((None, None), (40, 30.0)):
                for pps in (1, 3, serving):
                    got = paged_verify_partials(*pages, window=win,
                                                soft_cap=cap,
                                                pages_per_split=pps, **sc)
                    torch.cuda.synchronize()
                    want = ref.paged_verify_partials_plain(
                        *pages, window=win, soft_cap=cap,
                        pages_per_split=pps, **sc)
                    assert got[0].shape[1] == -(-nb // pps)
                    for g, w in zip(got, want):
                        torch.testing.assert_close(g, w, atol=1e-4,
                                                   rtol=1e-4)
    a = _on_card(quantize_pages(verify_case(28, 2, s, 4, 2, 24, 16, 4)), dt)
    with pytest.raises(ValueError, match="head_dim"):
        paged_verify_partials(*(a[k] for k in KEYS),
                              k_scale_pages=a["k_scale_pages"],
                              v_scale_pages=a["v_scale_pages"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_page_kernels_ignore_unseen_nan_scales(dtype):
    """The stale-scale case: NaN in the scale slots of every pool entry no
    query sees (``poison_unseen_scales``), so NaN also sits in tile rows
    past a split's last key once such entries have passed through the
    ring.  B1-int8 and B4-int8 (G = 1 and 4, S = 5: a key of the
    in-flight tokens is visible to query s and masked for s - 1) at splits
    1, 3 and the serving split give finite partials equal to the plain
    version's: 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    nb = 24
    for h, kv in ((8, 8), (8, 2)):
        cases = [(paged_decode_partials, ref.paged_decode_partials_plain,
                  decode_pages_per_split, paged_case(29, 4, h, kv, 128, 16,
                                                     nb)),
                 (paged_verify_partials, ref.paged_verify_partials_plain,
                  lambda q, kv_, nb_: verify_pages_per_split(q, kv_, nb_,
                                                             int8=True),
                  verify_case(30, 4, 5, h, kv, 128, 16, nb))]
        for kernel, plain, rule, c in cases:
            a = _on_card(poison_unseen_scales(quantize_pages(c)), dt)
            pages = tuple(a[k] for k in KEYS)
            sc = dict(k_scale_pages=a["k_scale_pages"],
                      v_scale_pages=a["v_scale_pages"])
            assert torch.isnan(sc["v_scale_pages"]).any()
            for pps in (1, 3, rule(pages[0], kv, nb)):
                got = kernel(*pages, soft_cap=30.0, pages_per_split=pps,
                             **sc)
                torch.cuda.synchronize()
                want = plain(*pages, soft_cap=30.0, pages_per_split=pps,
                             **sc)
                for g, w in zip(got, want):
                    assert torch.isfinite(g).all()
                    torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _small_stack(moe=False):
    """A 4-layer f32 stack at a width the kernels take (head_dim 64), its
    weights on the card, and an engine config with 16-token pages.  With
    ``moe`` its MLPs are 8 experts, top-2 (a 2:1 GQA stack, as
    granite-moe's 3:1)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import Family, ModelConfig
    from repro_torch.serving.engine import EngineConfig
    cfg = ModelConfig(name="span-card", family=Family.DENSE, n_layers=4,
                      d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
                      vocab_size=256)
    if moe:
        cfg = ModelConfig(name="moe-card", family=Family.MOE, n_layers=4,
                          d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
                          d_ff=64, n_experts=8, top_k=2, vocab_size=256)
    return (cfg, T.init(cfg, seed=0, device="cuda"),
            EngineConfig(max_len=256, max_batch=4, block_size=16))


def _span_requests(n, max_new=12):
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(31)
    return [Request(rid=i, arrival=0.0,
                    prompt=rng.integers(0, 256, 40 + 23 * i).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


@pytest.mark.cuda
def test_cuda_decode_pipeline_span_move_matches_full_stack():
    """A 2-stage DecodePipeline on the card (kernel B1 in every stage),
    with one live span move mid-stream, decodes the same tokens as a
    full-stack DecodeEngine from the same prefill states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    from repro_torch.serving.span import DecodePipeline
    cfg, params, ecfg = _small_stack()
    pe = PrefillEngine(cfg, params, ecfg)
    streams = []
    for unit in (DecodeEngine(cfg, params, ecfg),
                 DecodePipeline(cfg, params, ecfg, [(0, 2), (2, 4)])):
        reqs = _span_requests(3)
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
            unit.insert(r, st, int(torch.argmax(lg)))
        ops.reset_launches()
        for _ in range(4):
            unit.step()
        if isinstance(unit, DecodePipeline):
            assert unit.move_span(0, 1, 1)["kv_bytes"] > 0
            assert unit.bounds == [(0, 1), (1, 4)]
        while unit.active:
            unit.step()
        assert ops.LAUNCHES["paged_decode_partials"] > 0
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_cuda_prefill_pipeline_resume_matches_full_stack():
    """A PrefillPipeline resumes 32-token chunks over its dense per-span
    caches (plain attend, as JAX) where the full-stack engine resumes on
    kernels B3 + B2: f32 on both sides, so states and last logits agree
    to the summation order: 1e-4.  Positions and lengths exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.serving.engine import PrefillEngine
    from repro_torch.serving.span import PrefillPipeline
    cfg, params, ecfg = _small_stack()
    want = PrefillEngine(cfg, params, ecfg).run_batch(_span_requests(3),
                                                      chunk_tokens=32)
    ops.reset_launches()
    got = PrefillPipeline(cfg, params, ecfg, [(0, 3), (3, 4)]).run_batch(
        _span_requests(3), chunk_tokens=32)
    assert ops.LAUNCHES["flash_prefill"] > 0
    assert ops.LAUNCHES["paged_prefix_partials"] == 0
    for (st, lg), (wst, wlg) in zip(got, want):
        assert int(st["length"]) == int(wst["length"])
        assert int(st["n_blocks"]) == int(wst["n_blocks"])
        torch.testing.assert_close(lg, wlg, atol=1e-4, rtol=1e-4)
        for g, wg in zip(st["groups"], wst["groups"]):
            assert torch.equal(g["pos"], wg["pos"])
            for key in ("k", "v"):
                torch.testing.assert_close(g[key], wg[key], atol=1e-4,
                                           rtol=1e-4)


# ---------------------------------------------------------------------------
# The front door: swap/sacrifice preemption and a spawned decode member
# ---------------------------------------------------------------------------

def _served(orch, reqs, preempt=None):
    """Serve ``reqs`` through ``Server`` over ``orch``; with ``preempt``
    (swap or sacrifice) preempt each request once, after its second
    token.  Returns (streams, preempted rids)."""
    from repro_torch.serving.api import Server
    srv = Server(orch)
    handles = [srv.submit(r, at=r.arrival) for r in reqs]
    hit = []
    for _ in range(10_000):
        if not srv.step() and srv.in_flight() == 0:
            break
        for u in orch.decode_units() if preempt else ():
            rid = next((r.rid for r in u.slots if r is not None
                        and r.rid not in hit and len(r.generated) >= 2
                        and len(r.generated) < r.max_new_tokens), None)
            if rid is not None:
                assert orch.preempt(rid, preempt)
                hit.append(rid)
                break
    srv.drain()
    assert all(h.outcome.value == "completed" for h in handles)
    for e in orch.decode_units():
        held = orch.store.pool_pages(e.name).values()
        assert e.active == 0
        assert len(e._free) + len(held) == e.ecfg.max_batch * e._nb_slot
    return [h.tokens for h in handles], hit


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["swap", "sacrifice"])
def test_cuda_forced_preemption_streams_equal_uninterrupted(mode):
    """On the f32 small stack with CUDA graphs on, preempting every
    request once mid-decode (swap: the state parks on the card and is
    adopted back into the static cache; sacrifice: a clone re-prefills
    on B2/B3) gives the uninterrupted run's streams token for token."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)
    cfg, params, ecfg = _small_stack()

    def orch():
        return Orchestrator(cfg, params, OrchestratorConfig(
            n_prefill=1, n_decode=2, engine=ecfg, chunk_tokens=32))

    want, _ = _served(orch(), _span_requests(4))
    o = orch()
    ops.reset_launches()
    got, hit = _served(o, _span_requests(4), preempt=mode)
    assert len(hit) == 4 and got == want
    assert o.summary()[f"n_preempted_{mode}"] == 4
    assert ops.LAUNCHES["paged_decode_partials"] > 0
    assert all(u.compiled.report()["graphs_captured"] > 0
               for u in o.decode_units())
    if mode == "sacrifice":
        assert ops.LAUNCHES["flash_prefill"] > 0


@pytest.mark.cuda
def test_cuda_spawned_decode_member_captures_its_graphs():
    """``_scale_up`` spawns a decode engine on the card over the same
    parameter tensors; it takes work only after its virtual warm-up and
    captures its own CUDA graphs at its first decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.core import analytical as A
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  OrchestratorConfig)
    cfg, params, ecfg = _small_stack()
    o = Orchestrator(cfg, params, OrchestratorConfig(
        n_prefill=1, n_decode=1, engine=ecfg, migration=False))
    name = o._scale_up("decode", A.H100_SXM)
    m = o._by_name[name]
    assert o.fleet[name] == "decode:warming" and m.decode.device.type == "cuda"
    assert m.decode.params is params
    reqs = _span_requests(4)
    for r in reqs:
        r.arrival = m.warming_until
    _served(o, reqs)
    assert m.decode.tokens_decoded > 0
    assert m.decode.compiled.report()["graphs_captured"] > 0


# ---------------------------------------------------------------------------
# Compiled decode-side steps: CUDA graph replays against eager steps
# ---------------------------------------------------------------------------

GRAPH_MODES = {
    # mode: (speculation, kv_quant, dtype, span bounds or None)
    "plain-f32": ("off", False, "float32", None),
    "plain-bf16": ("off", False, "bfloat16", None),
    "plain-int8": ("off", True, "float32", None),
    "draft-f32": ("draft", False, "float32", None),
    "draft-int8": ("draft", True, "float32", None),
    "span-f32": ("off", False, "float32", [(0, 2), (2, 4)]),
}


def _graph_run(mode, graphs, monkeypatch, max_new=12, moe=False):
    """Serve ``_span_requests(3)`` on the small stack (``moe``: its MoE
    variant) in ``mode`` with CUDA graphs on or off.  Returns (every
    compiled step's output, cloned, in call order; the streams; the
    decode launches; the decode units)."""
    import dataclasses
    from repro_torch.serving import engine as E
    from repro_torch.serving.span import DecodePipeline
    spec, quant, dtype, bounds = GRAPH_MODES[mode]
    cfg, params, ecfg = _small_stack(moe)
    cfg = dataclasses.replace(cfg, kv_quant=quant)
    dt = getattr(torch, dtype)
    params = cast_params(params, dt)
    ecfg = dataclasses.replace(ecfg, speculation=spec, spec_len=4,
                               cuda_graphs=graphs)
    pe = E.PrefillEngine(cfg, params, ecfg)
    if bounds is None:
        unit = E.DecodeEngine(cfg, params, ecfg, draft=(
            dataclasses.replace(cfg, kv_quant=False), params)
            if spec == "draft" else None)
    else:
        unit = DecodePipeline(cfg, params, ecfg, bounds)
    reqs = _span_requests(3, max_new)
    for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
        unit.insert(r, st, int(torch.argmax(lg)))
    outs = []
    orig = E.CompiledStep.__call__

    def record(step, x):
        out = orig(step, x)
        outs.append(out.clone())
        return out

    monkeypatch.setattr(E.CompiledStep, "__call__", record)
    ops.reset_launches()
    while unit.active:
        unit.step()
    torch.cuda.synchronize()
    monkeypatch.setattr(E.CompiledStep, "__call__", orig)
    return outs, [r.generated for r in reqs], dict(ops.LAUNCHES), unit


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_cuda_graph_replays_equal_eager_steps(mode, monkeypatch):
    """Plain decode (f32, bf16, int8 pools), draft speculation (the draft
    micro-step and every verify width the run takes; bf16/f32 and int8
    pools) and a 2-stage span pipeline: every replayed step's output
    equals the eager static-buffer step's bit for bit, the streams are
    equal, and the launch counts of the two runs are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    eager, e_streams, e_launch, _ = _graph_run(mode, False, monkeypatch)
    graph, g_streams, g_launch, unit = _graph_run(mode, True, monkeypatch)
    engines = getattr(unit, "engines", [unit])
    assert all(e.compiled.report()["graphs_captured"] > 0 for e in engines)
    assert len(graph) == len(eager) > 0
    gaps = [float((g.float() - e.float()).abs().max())
            for g, e in zip(graph, eager)]
    assert max(gaps) == 0.0, f"largest replay-vs-eager gap {max(gaps)}"
    assert g_streams == e_streams
    assert g_launch == e_launch


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain-f32", "plain-bf16", "draft-f32",
                                  "span-f32"])
def test_cuda_moe_graph_replays_equal_eager_steps(mode, monkeypatch):
    """The MoE forward (f32 router, stable sort, gather dispatch and
    combine) captures in every decode-side step: each engine captures
    its graphs, and every replayed step equals the eager one bit for
    bit, with equal streams and launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    eager, e_streams, e_launch, _ = _graph_run(mode, False, monkeypatch,
                                               moe=True)
    graph, g_streams, g_launch, unit = _graph_run(mode, True, monkeypatch,
                                                  moe=True)
    for e in getattr(unit, "engines", [unit]):
        assert e.compiled.report()["graphs_captured"] > 0
        assert all(st.graph is not None for st in e.compiled.steps.values())
    assert len(graph) == len(eager) > 0
    gaps = [float((g.float() - e.float()).abs().max())
            for g, e in zip(graph, eager)]
    assert max(gaps) == 0.0, f"largest replay-vs-eager gap {max(gaps)}"
    assert g_streams == e_streams
    assert g_launch == e_launch
    assert g_launch["paged_decode_partials"] \
        + g_launch["paged_verify_partials"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain-int8", "draft-int8"])
def test_cuda_int8_graphs_launch_only_int8_page_kernels(mode, monkeypatch):
    """An int8 engine's captured steps launch B1-int8 (decode) and
    B4-int8 (verify), never the bf16/f32 page kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _, _, launches, de = _graph_run(mode, True, monkeypatch)
    int8 = {"paged_decode_partials_int8", "paged_verify_partials_int8"}
    for key, step in de.compiled.steps.items():
        if key[0] == "draft":
            # the draft's dense bf16/f32 cache: kernel B5, one per layer
            assert step.launches == {"split_kv_decode_partials": 4}
            continue
        assert step.graph is not None and set(step.launches) <= int8
        want = ("paged_verify_partials_int8" if key[0] == "verify"
                else "paged_decode_partials_int8")
        assert step.launches[want] == 4   # one per layer
    assert launches["paged_decode_partials"] == 0
    assert launches["paged_verify_partials"] == 0


@pytest.mark.cuda
def test_cuda_replays_count_their_launches():
    """After one step has captured the decode graph, N more steps add
    exactly N times one eager step's launches; the capture itself (and
    its warm-up) adds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    cfg, params, ecfg = _small_stack()
    counts = {}
    for graphs in (False, True):
        ecfg_g = dataclasses.replace(ecfg, cuda_graphs=graphs)
        pe = PrefillEngine(cfg, params, ecfg_g)
        de = DecodeEngine(cfg, params, ecfg_g)
        reqs = _span_requests(3, max_new=40)
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
            de.insert(r, st, int(torch.argmax(lg)))
        ops.reset_launches()
        de.step()
        counts[graphs, 1] = dict(ops.LAUNCHES)
        ops.reset_launches()
        for _ in range(7):
            de.step()
        counts[graphs, 7] = dict(ops.LAUNCHES)
    one = counts[False, 1]
    assert one["paged_decode_partials"] == cfg.n_layers
    assert counts[True, 1] == one
    assert counts[True, 7] == {k: 7 * n for k, n in one.items()}
    assert counts[False, 7] == counts[True, 7]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_kv_decode_head_slices_ragged_vs_plain(dtype):
    """B5 reading a contiguous range of a wider cache's kv heads in place
    (Fig. 4's branches: hot [:kv - n], cold [kv - n:]) over a cache whose
    length is no multiple of block_k (the last block ragged, no padded
    copy), against its plain version on the same slices.  Partials in
    f32 from the same inputs on both sides: 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    q, k, v, valid = decode_case(19, 3, 16, 8, 128, 1000)
    q, k, v = (torch.as_tensor(x).cuda().to(dt) for x in (q, k, v))
    valid = torch.as_tensor(valid).cuda()
    for lo, hi in ((0, 8), (0, 7), (7, 8), (0, 5), (5, 8)):
        qs = q[:, 2 * lo:2 * hi]
        ks, vs = k[:, :, lo:hi], v[:, :, lo:hi]
        ops.reset_launches()
        got = split_kv_decode_partials(qs, ks, vs, valid, block_k=512)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["split_kv_decode_partials"] == 1
        assert got[0].shape == (3, 2, 2 * (hi - lo), 128)
        want = ref.split_kv_decode_partials_plain(qs, ks, vs, valid,
                                                  block_k=512)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _dense_decode_inputs(cfg, params, dev):
    """A dense f32 cache of 4 rows prefilled with 120 tokens on the CPU
    (B2's plain version), the rows then at positions 120-299 (the slots
    between never written), and layer 0's decode inputs, on ``dev``."""
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(23)
    cpu = T._tree_map(lambda a: a.cpu(), params)
    cache = T.init_cache(cfg, 4, 300, device="cpu")
    T.apply(cfg, cpu, torch.as_tensor(rng.integers(0, 256, (4, 120))),
            cache=cache, mode="prefill")
    pos = torch.as_tensor([[120], [177], [240], [299]], dtype=torch.int32)
    st = T._tree_map(lambda a: a[0].to(dev), cache["groups"][0])
    x = torch.as_tensor(rng.normal(size=(4, 1, cfg.d_model)),
                        dtype=torch.float32)
    p = T._tree_map(lambda a: a[0].to(dev), cpu["groups"][0]["attn"])
    return p, x.to(dev), pos.to(dev), st


@pytest.mark.cuda
@pytest.mark.parametrize("n_off", [0, 1, 3])
def test_cuda_dense_decode_and_head_offload_vs_plain(n_off):
    """``attention_apply``'s dense decode branch on the card: B5 (one
    launch; with ``head_offload`` n > 0 the two Fig. 4 branches, two
    launches, each over its kv heads in place) against the same call's
    plain route on the CPU (B5's plain version); a soft-capped stack takes
    plain ``attend`` (no launch; fixed by the config) unless offloaded,
    as JAX's branches ignore the cap.  f32 attention outputs through the
    same projections: 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.config import Family, ModelConfig
    base = ModelConfig(name="dense-card", family=Family.DENSE, n_layers=2,
                       d_model=256, n_heads=8, n_kv_heads=4, head_dim=64,
                       d_ff=256, vocab_size=256)
    params = T.init(base, seed=3, device="cuda")
    for cap in (None, 30.0):
        cfg = dataclasses.replace(base, logit_soft_cap=cap)
        outs = {}
        for dev in ("cuda", "cpu"):
            p, x, pos, st = _dense_decode_inputs(cfg, params, dev)
            ops.reset_launches()
            y, _ = L.attention_apply(cfg, p, x, positions=pos, state=st,
                                     mode="decode", window=None,
                                     head_offload=n_off)
            outs[dev] = (y, dict(ops.LAUNCHES))
        torch.cuda.synchronize()
        torch.testing.assert_close(outs["cuda"][0].cpu(), outs["cpu"][0],
                                   atol=1e-4, rtol=1e-4)
        want = 2 if n_off else (1 if cap is None else 0)
        assert outs["cuda"][1]["split_kv_decode_partials"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense-float32", "dense-bfloat16",
                                  "int8w-bfloat16"])
def test_cuda_dense_rows_and_int8_weights_replay_equal_eager(mode,
                                                            monkeypatch):
    """Dense rows (``max_len`` 250, no multiple of the 16-token block) and
    int8 weights on the card: every replayed decode step equals the eager
    one bit for bit, and the streams and launch counts are equal; dense
    rows launch B2 and B5 and no page kernel, the quantized (paged) stack
    B1 and B2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.models import quant as Q
    from repro_torch.serving import engine as E
    kind, dtype = mode.split("-")
    cfg, params, ecfg = _small_stack()
    params = cast_params(params, getattr(torch, dtype))
    if kind == "dense":
        ecfg = dataclasses.replace(ecfg, max_len=250)
    else:
        params = Q.quantize_weights(params)
    orig = E.CompiledStep.__call__
    runs = []
    for graphs in (False, True):
        ecfg_g = dataclasses.replace(ecfg, cuda_graphs=graphs)
        pe = E.PrefillEngine(cfg, params, ecfg_g)
        de = E.DecodeEngine(cfg, params, ecfg_g)
        assert de.paged is (kind != "dense")
        reqs = _span_requests(3)
        outs = []

        def record(step, x):
            out = orig(step, x)
            outs.append(out.clone())
            return out

        monkeypatch.setattr(E.CompiledStep, "__call__", record)
        ops.reset_launches()
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs, chunk_tokens=32)):
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
        torch.cuda.synchronize()
        monkeypatch.setattr(E.CompiledStep, "__call__", orig)
        runs.append((outs, [r.generated for r in reqs], dict(ops.LAUNCHES)))
        assert (de.compiled.report()["graphs_captured"] > 0) is graphs
    (eager, e_streams, e_launch), (graph, g_streams, g_launch) = runs
    assert len(graph) == len(eager) > 0
    assert max(float((g.float() - e.float()).abs().max())
               for g, e in zip(graph, eager)) == 0.0
    assert g_streams == e_streams and g_launch == e_launch
    assert g_launch["flash_prefill"] > 0
    if kind == "dense":
        assert g_launch["split_kv_decode_partials"] > 0
        for name in ("paged_decode_partials", "paged_prefix_partials",
                     "paged_verify_partials"):
            assert g_launch[name] == 0
    else:
        assert g_launch["paged_decode_partials"] > 0


# ---------------------------------------------------------------------------
# The RG-LRU hybrid: ring pages, the hybrid's attention shapes, graphs
# ---------------------------------------------------------------------------

def ring_case(seed, lengths, h, kv, d, bs, nb):
    """One decode step of rows served over a windowed ring of nb * bs
    slots: row r has written ``lengths[r]`` tokens, position p in slot
    p % (nb * bs), so a row past the ring's length holds its last nb * bs
    positions out of position order across its pages, which sit at
    shuffled physical ids.  The query is at position length - 1; a length
    of None is an empty slot (an all-dead table).  The scratch page and
    unassigned pages hold poison positions."""
    rng = np.random.default_rng(seed)
    b, plen = len(lengths), nb * bs
    n_phys = 1 + b * nb
    k_pages = rng.normal(size=(n_phys, bs, kv, d)).astype(np.float32)
    v_pages = rng.normal(size=(n_phys, bs, kv, d)).astype(np.float32)
    pos_pages = rng.integers(0, 2 * plen, (n_phys, bs)).astype(np.int32)
    tables = np.full((b, nb), -1, np.int32)
    phys = rng.permutation(n_phys - 1) + 1
    nxt = 0
    for row, n in enumerate(lengths):
        if n is None:
            continue
        for j in range(min(-(-n // bs), nb)):
            tables[row, j] = phys[nxt]
            slot = np.arange(j * bs, (j + 1) * bs)
            p = slot + plen * ((n - 1 - slot) // plen)
            pos_pages[phys[nxt]] = np.where(slot < n, p, -1)
            nxt += 1
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pos_q = np.asarray([(n or 1) - 1 for n in lengths], np.int32)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages,
                block_tables=tables, pos_q=pos_q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_hybrid_attention_kernels_vs_plain(dtype):
    """B1 and B2 at recurrentgemma-9b's attention shapes (16 query heads
    on one kv head of 256, a 2048-token window): B1 on a ring of 128
    pages of 16 wrapped past position 2048 in three rows, with an empty
    slot, at one partial per page, per 3 pages and at the serving split;
    B2 over 2304 tokens (the window cuts) and 2 x 512 against its plain
    version.  Tolerances as ``test_cuda_kernel_vs_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    c = ring_case(21, [3000, 2600, 2049, 2045, 900, None], 16, 1, 256, 16,
                  128)
    a = tuple(torch.as_tensor(c[k]).cuda().to(dt) if c[k].dtype ==
              np.float32 else torch.as_tensor(c[k]).cuda() for k in KEYS)
    for pps in (1, 3, decode_pages_per_split(a[0], 1, 128)):
        got = paged_decode_partials(*a, window=2048, pages_per_split=pps)
        want = ref.paged_decode_partials_plain(*a, window=2048,
                                               pages_per_split=pps)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    tol = 1e-4 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(22)
    for b, s in ((1, 2304), (2, 512)):
        q, k, v = (torch.as_tensor(rng.normal(size=(b, s, n, 256)).astype(
            np.float32)).cuda().to(dt) for n in (16, 1, 1))
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, window=2048),
            ref.flash_prefill_plain(q, k, v, window=2048), atol=tol,
            rtol=tol)


def _hybrid_stack(dtype):
    """A 5-layer RG-LRU hybrid (one (RGLRU, RGLRU, LOCAL) group plus two
    RG-LRU layers) at 16/1 heads of 64 with a 32-token window, on the
    card in ``dtype``, and an engine config whose ring is 2 pages of 16."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig
    cfg = dataclasses.replace(get("recurrentgemma-9b"), name="rg5-card",
                              n_layers=5, d_model=128, n_heads=16,
                              n_kv_heads=1, head_dim=64, d_ff=256,
                              vocab_size=256, local_window=32)
    return (cfg, T.init(cfg, seed=0, dtype=getattr(torch, dtype),
                        device="cuda"),
            EngineConfig(max_len=256, max_batch=4, block_size=16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_hybrid_served_replay_equals_eager(dtype, monkeypatch):
    """The hybrid prefilled in 32-token chunks over prompts longer than its
    window and decoded over the paged ring (B1) with ``h``/``conv``
    updated in place, with CUDA graphs on and off: every replayed step
    equals the eager one bit for bit, the streams and launches are equal,
    B1 and B2 launch and B3, B4 and B5 do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.serving import engine as E
    cfg, params, ecfg = _hybrid_stack(dtype)
    orig = E.CompiledStep.__call__
    runs = []
    for graphs in (False, True):
        ecfg_g = dataclasses.replace(ecfg, cuda_graphs=graphs)
        pe = E.PrefillEngine(cfg, params, ecfg_g)
        de = E.DecodeEngine(cfg, params, ecfg_g)
        assert de.paged and de.page_len == 32
        reqs = _span_requests(3)
        outs = []

        def record(step, x):
            out = orig(step, x)
            outs.append(out.clone())
            return out

        monkeypatch.setattr(E.CompiledStep, "__call__", record)
        ops.reset_launches()
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs, chunk_tokens=32)):
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
        torch.cuda.synchronize()
        monkeypatch.setattr(E.CompiledStep, "__call__", orig)
        runs.append((outs, [r.generated for r in reqs], dict(ops.LAUNCHES)))
        assert (de.compiled.report()["graphs_captured"] > 0) is graphs
    (eager, e_streams, e_launch), (graph, g_streams, g_launch) = runs
    assert len(graph) == len(eager) > 0
    assert max(float((g.float() - e.float()).abs().max())
               for g, e in zip(graph, eager)) == 0.0
    assert g_streams == e_streams and g_launch == e_launch
    assert g_launch["flash_prefill"] > 0
    assert g_launch["paged_decode_partials"] > 0
    for name in ("paged_prefix_partials", "paged_verify_partials",
                 "split_kv_decode_partials"):
        assert g_launch[name] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_decode_step_in_a_graph_equals_eager(dtype):
    """The RG-LRU decode step (S = 1) captured in a CUDA graph over static
    input and state tensors and replayed over five steps: its outputs and
    the ``h``/``conv`` it writes in place equal the eager step's bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.models import layers as L
    cfg, _, _ = _hybrid_stack("float32")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = L.init_rglru(cfg, gen, dt, "cuda")
    b, d, w = 4, cfg.d_model, cfg.rglru_conv_width
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    c0 = torch.randn((b, w - 1, d), generator=gen, device="cuda").to(dt)
    xs = [torch.randn((b, 1, d), generator=gen, device="cuda").to(dt)
          for _ in range(5)]
    eager = {"h": h0.clone(), "conv": c0.clone()}
    static = {"h": h0.clone(), "conv": c0.clone()}
    x = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        L.rglru_apply(cfg, p, x, state=static, mode="decode")
    torch.cuda.current_stream().wait_stream(side)
    static["h"].copy_(h0)
    static["conv"].copy_(c0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, _ = L.rglru_apply(cfg, p, x, state=static, mode="decode")
    for xt in xs:
        want, _ = L.rglru_apply(cfg, p, xt, state=eager, mode="decode")
        x.copy_(xt)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert torch.equal(static["h"], eager["h"])
        assert torch.equal(static["conv"], eager["conv"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_b5_cross_decode_vs_plain(dtype):
    """B5 at the cross-attention decode shapes: seamless' 8 rows x 512
    frames (one full 512-key block) at 16/16 heads of 64, and a GQA case
    of 3 rows x 12 frames at 4/2 heads of 16, every frame valid, against
    its plain version (partials in f32 from the same inputs: 1e-4), and
    the combined output of ``ops.decode_attention`` against plain
    masked attention over all frames (one output rounding in bf16:
    2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.models import layers as L
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(17)
    for b, f, h, kv, d in ((8, 512, 16, 16, 64), (3, 12, 4, 2, 16)):
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((b, f, kv, d), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        every = torch.ones((b, f), dtype=torch.bool, device="cuda")
        ops.reset_launches()
        got = split_kv_decode_partials(q, k, v, every, block_k=512)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["split_kv_decode_partials"] == 1
        want = ref.split_kv_decode_partials_plain(q, k, v, every,
                                                  block_k=512)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        out = ops.decode_attention(q, k, v, every, scale=d ** -0.5)
        plain = L.masked_attention(q[:, None], k, v, torch.ones(
            (1, 1, 1, 1, f), dtype=torch.bool, device="cuda"), d ** -0.5)
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(out.float(), plain[:, 0].float(),
                                   atol=tol, rtol=tol)


def _last_two_stacks(arch):
    """The registry's smoke size of ``arch`` on the card in f32 and an
    engine config of 16-token blocks; seamless' frames per request."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig
    cfg = get(arch).smoke()
    return (cfg, T.init(cfg, seed=0, device="cuda"),
            EngineConfig(max_len=256, max_batch=4, block_size=16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m", "seamless-m4t-large-v2"])
def test_cuda_last_two_stacks_replay_equal_eager(arch, monkeypatch):
    """xlstm-350m and seamless-m4t-large-v2 at smoke size, prefilled in
    32-token chunks (seamless with each request's own frames) and decoded
    with CUDA graphs on and off: every replayed step equals the eager one
    bit for bit (the xLSTM's C/n/m/c/h restored after the capture's
    warm-up), the streams and launches are equal; the xLSTM launches no
    kernel, seamless B1, B2 and B5 (cross decode) and never B3 or B4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.serving import engine as E
    cfg, params, ecfg = _last_two_stacks(arch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    orig = E.CompiledStep.__call__
    runs = []
    for graphs in (False, True):
        ecfg_g = dataclasses.replace(ecfg, cuda_graphs=graphs)
        pe = E.PrefillEngine(cfg, params, ecfg_g)
        de = E.DecodeEngine(cfg, params, ecfg_g)
        assert de.paged == cfg.cross_attention
        reqs = _span_requests(3)
        gen.manual_seed(5)
        frames = [torch.randn((1, cfg.n_frames, cfg.d_model), generator=gen,
                              device="cuda") if cfg.cross_attention else None
                  for _ in reqs]
        outs = []

        def record(step, x):
            out = orig(step, x)
            outs.append(out.clone())
            return out

        monkeypatch.setattr(E.CompiledStep, "__call__", record)
        ops.reset_launches()
        for r, f in zip(reqs, frames):
            st, lg = pe.run_batch([r], frames=f, chunk_tokens=32)[0]
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
        torch.cuda.synchronize()
        monkeypatch.setattr(E.CompiledStep, "__call__", orig)
        runs.append((outs, [r.generated for r in reqs], dict(ops.LAUNCHES)))
        assert (de.compiled.report()["graphs_captured"] > 0) is graphs
    (eager, e_streams, e_launch), (graph, g_streams, g_launch) = runs
    assert len(graph) == len(eager) > 0
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
    assert g_streams == e_streams and g_launch == e_launch
    used = ({"paged_decode_partials", "flash_prefill",
             "split_kv_decode_partials"} if cfg.cross_attention else set())
    for name, n in g_launch.items():
        assert (n > 0) == (name in used), (name, n)


@pytest.mark.cuda
def test_cuda_smoke_phases_of_the_last_two_stacks(monkeypatch):
    """``chip_smoke.py``'s runs (p)-(s) at 24 layers of narrow width: the
    xLSTM through ``Server`` replayed and eagerly and over two 2-stage
    pipelines with a span move; seamless through the engines replayed and
    eagerly and over a 2-stage prefill and decode pipeline with a span
    move; before them B1, B2 and B5 at the seamless runs' shapes against
    their plain versions (``seamless_kernels``).  Each phase fails (exits)
    on any of its checks: kernels against their plain versions, launches,
    equal streams, the teacher-forced gap, pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    import sys
    from pathlib import Path
    import repro_torch.configs as registry
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS
    real = registry.get
    narrow = {"xlstm-350m": dict(d_model=128, n_heads=2, n_kv_heads=2,
                                 head_dim=64, vocab_size=512),
              "seamless-m4t-large-v2": dict(d_model=128, n_heads=4,
                                            n_kv_heads=4, head_dim=32,
                                            d_ff=256, vocab_size=512,
                                            n_frames=64)}
    monkeypatch.setattr(registry, "get", lambda name: dataclasses.replace(
        real(name), **narrow[name]))
    served = CS.served_requests

    def short(cfg):          # prompts of 40-100 tokens, chunked at 32
        reqs = served(cfg)
        for r in reqs:
            r.prompt = r.prompt[:40 + 8 * r.rid]
        return reqs

    monkeypatch.setattr(CS, "served_requests", short)
    monkeypatch.setattr(CS, "XLSTM_CHUNK", 32)
    launches = CS.xlstm_phase(torch, "card test")
    assert all(n == 0 for run in launches.values() for n in run.values())
    results = {}
    timing = CS.seamless_kernels(torch, results)
    assert sorted(k for k, _, _ in results) == ["B1", "B2", "B5"]
    assert all(r["err"] <= CS.TOL_F32 for r in results.values())
    assert all(t["ms"] > 0 and t["library_ms"] > 0 for t in timing.values())
    runs = CS.seamless_phase(torch, "card test")
    assert all(run["split_kv_decode_partials"] > 0 for run in runs.values())


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------

def _clone_tree(tree, device):
    from repro_torch.training.tree import map_named
    return map_named(lambda _, a: a.to(device, copy=True), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat", [("llama-13b", False),
                                        ("llama-13b", True),
                                        ("granite-moe-3b-a800m", True)])
def test_cuda_train_step_matches_cpu(arch, remat):
    """One train step of the arch's smoke size in f32 on the card against
    the same step on the CPU, from the same weights and tokens: the loss
    within 1e-5 relative and every gradient leaf within 2e-4 of its
    largest |CPU gradient| (f32 sums in another order, the bound the CPU
    tests hold the port to against JAX); the AdamW update of the same
    gradients within 1e-6 relative; the step's loss, grad norm and lr
    within 1e-5 relative.  No leaf requires grad after the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import (loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import named_leaves
    cfg = get(arch).smoke()
    base = T.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32))
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    devs = ("cpu", "cuda")
    got = {d: loss_and_grads(cfg, _clone_tree(base, d),
                             {"tokens": toks.to(d)}, remat=remat)
           for d in devs}
    assert float(got["cuda"][0]) == pytest.approx(float(got["cpu"][0]),
                                                  rel=1e-5)
    grads = {d: named_leaves(got[d][2]) for d in devs}
    for (name, a), (_, b) in zip(grads["cpu"], grads["cuda"]):
        tol = 2e-4 * max(float(a.abs().max()), 1e-12)
        assert float((b.cpu() - a).abs().max()) <= tol, name
    cpu_grads = got["cpu"][2]
    upd = {}
    for d in devs:
        p = _clone_tree(base, d)
        O.apply_updates(ocfg, p, _clone_tree(cpu_grads, d), O.init_state(p))
        upd[d] = named_leaves(p)
    for (name, a), (_, b) in zip(upd["cpu"], upd["cuda"]):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=1e-7,
                                   msg=name)
    step = make_train_step(cfg, ocfg, remat=remat)
    metrics = {}
    for d in devs:
        p = _clone_tree(base, d)
        p, _, metrics[d] = step(p, O.init_state(p), {"tokens": toks.to(d)})
        assert not any(a.requires_grad for _, a in named_leaves(p))
    for k in ("loss", "grad_norm", "lr"):
        assert float(metrics["cuda"][k]) == pytest.approx(
            float(metrics["cpu"][k]), rel=1e-5), k


@pytest.mark.cuda
def test_cuda_graphs_replay_weights_a_train_step_updated(monkeypatch):
    """A decode engine captures its graphs, one train step then updates
    the weights in place, and the same graphs replay (none is captured
    again) equal to an eager engine's steps on the updated weights, bit
    for bit: the graphs read the weights where the step wrote them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.serving import engine as E
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import named_leaves
    cfg, params, ecfg = _small_stack()
    pe = E.PrefillEngine(cfg, params, ecfg)
    graph = E.DecodeEngine(cfg, params, ecfg)

    def serve(de, record=None):
        reqs = _span_requests(2)
        for r in reqs:
            st, lg = pe.run(r)
            de.insert(r, st, int(torch.argmax(lg)))
        while de.active:
            de.step()
        torch.cuda.synchronize()
        return [r.generated for r in reqs]

    before = serve(graph)
    captured = graph.compiled.report()["graphs_captured"]
    assert captured > 0
    old = {n: a.clone() for n, a in named_leaves(params)}
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 65)).astype(np.int32)).cuda()
    step = make_train_step(cfg, O.AdamWConfig(lr=1e-2, warmup_steps=1,
                                              total_steps=4))
    assert step(params, O.init_state(params), {"tokens": toks})[0] is params
    assert all(not torch.equal(a, old[n]) for n, a in named_leaves(params)
               if a.dim() >= 2)
    assert not any(a.requires_grad for _, a in named_leaves(params))
    orig = E.CompiledStep.__call__
    runs = []
    for de in (graph, E.DecodeEngine(cfg, params,
                                     dataclasses.replace(ecfg,
                                                         cuda_graphs=False))):
        outs = []

        def record(st, x):
            out = orig(st, x)
            outs.append(out.clone())
            return out

        monkeypatch.setattr(E.CompiledStep, "__call__", record)
        runs.append((serve(de), outs))
        monkeypatch.setattr(E.CompiledStep, "__call__", orig)
    assert graph.compiled.report()["graphs_captured"] == captured
    (g_streams, g_outs), (e_streams, e_outs) = runs
    assert len(g_outs) == len(e_outs) > 0
    assert all(torch.equal(g, e) for g, e in zip(g_outs, e_outs))
    assert g_streams == e_streams != before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 4e-3)])
def test_cuda_sharded_decode_attention_on_b5_vs_plain(dtype, tol):
    """``sharded_decode_attention`` on a one-rank NCCL group and a 1 x 1
    mesh runs B5 (one launch: its per-block partials, merged, then the
    gather) and equals its plain version (``partial_attention`` and the
    combine, on the CPU) on the same inputs: a GQA case with a ragged last
    key block, one row attending nothing.  The outputs' spread is ~0.04,
    so bf16 is held to 4e-3 (about one bf16 step), not 2e-2, which a
    kernel that dropped a key block could pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import torch.distributed as dist
    from repro_torch.core import attention_offload as AO
    from repro_torch.launch import mesh as M
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    b, length, h, kv, d = 3, 1300, 8, 2, 128
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, length, kv, d)).astype(
        np.float32)) for _ in range(2))
    valid = torch.from_numpy(np.arange(length)[None] < np.array(
        [[1300], [777], [0]]))
    q, k, v = (x.to(dt) for x in (q, k, v))
    g = h // kv
    o, l, m = AO.partial_attention(q, k.repeat_interleave(g, 2),
                                   v.repeat_interleave(g, 2), valid)
    want = AO.combine_partials([o], [l], [m]).to(dt)
    M.init_process_group("cuda")
    try:
        mesh = M.make_host_mesh()
        ops.reset_launches()
        got = AO.sharded_decode_attention(
            mesh, q.cuda(), k.cuda(), v.cuda(), valid.cuda())
        torch.cuda.synchronize()
        assert ops.LAUNCHES["split_kv_decode_partials"] == 1
    finally:
        dist.destroy_process_group()
    assert got.dtype == dt and got.shape == (b, h, d)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=tol)
    assert not got[2].any()


@pytest.mark.cuda
def test_cuda_uncapturable_forward_raises(monkeypatch):
    """A forward that cannot be captured (a host copy inside it) raises
    on a graph engine; nothing runs it eagerly instead.  The same
    forward runs on an engine with graphs off.  (Last in the file: a
    failed capture is the one case here that leaves the stream's capture
    to CUDA's error path.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    cfg, params, ecfg = _small_stack()
    orig = L.mlp_apply

    def mlp_with_host_copy(cfg_, p, x):
        x.cpu()
        return orig(cfg_, p, x)

    streams = []
    for graphs in (True, False):
        ecfg_g = dataclasses.replace(ecfg, cuda_graphs=graphs)
        pe = PrefillEngine(cfg, params, ecfg_g)
        de = DecodeEngine(cfg, params, ecfg_g)
        reqs = _span_requests(2, max_new=3)
        for r, (st, lg) in zip(reqs, pe.run_batch(reqs)):
            de.insert(r, st, int(torch.argmax(lg)))
        monkeypatch.setattr(L, "mlp_apply", mlp_with_host_copy)
        ops.reset_launches()
        if graphs:
            with pytest.raises(RuntimeError):
                de.step()
            assert de.compiled.report()["graphs_captured"] == 0
            assert all(len(r.generated) == 1 for r in reqs)
        else:
            while de.active:
                de.step()
            streams.append([r.generated for r in reqs])
        monkeypatch.setattr(L, "mlp_apply", orig)
        torch.cuda.synchronize()
    assert all(len(s) == 3 for s in streams[0])
