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

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               paged_prefix_partials)
from repro_torch.kernels.split_kv_decode import paged_decode_partials


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
