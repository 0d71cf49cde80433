"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``.  The
build happens at first use, from the sources in this checkout, into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``); the library name carries a hash of the sources and
flags, so an edited kernel is rebuilt.  Nothing here runs when a module
is imported: the CPU tests import every module and have no ``nvcc``.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one only
where it launches its kernel (the xLSTM scans: one per call of their C
entry point, each design of a scan under its own name, though an entry
point may launch more than one kernel: one per step of the sLSTM's step
forward and step backward, one and then two a window of chunks for the
mLSTM's chunkwise forward, four for its step backward, one, three a window
and one for its chunkwise backward).  The int8-pool variants of the page
kernels count apart from the bf16/f32 ones.  ``page_partials`` checks and launches
the page kernels (paged decode, speculative verify), whose C entry points
share one argument list, the int8 ones adding the scale pools.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
HEADERS = ("common.cuh", "attn_tile.cuh", "decode_walk.cuh",
           "paged_prefix.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library (source ``csrc/<name>.cu``) -> {C entry point: argtypes}
KERNELS = {
    "paged_decode": {
        "paged_decode_partials": [_P] * 9 + [_I] * 8 + [_F, _I, _F, _I, _P],
        "paged_decode_partials_q8":
            [_P] * 11 + [_I] * 8 + [_F, _I, _F, _I, _P]},
    "paged_prefix": {
        "paged_prefix_partials": [_P] * 9 + [_I] * 8 + [_F, _I, _F, _I, _P]},
    "paged_verify": {
        "paged_verify_partials": [_P] * 9 + [_I] * 8 + [_F, _I, _F, _I, _P],
        "paged_verify_partials_q8":
            [_P] * 11 + [_I] * 8 + [_F, _I, _F, _I, _P]},
    "flash_prefill": {
        "flash_prefill": [_P] * 6 + [_I] * 7 + [_F, _I, _F, _I, _I, _P]},
    "split_kv_decode": {
        "split_kv_decode_partials": [_P] * 7 + [_I] * 7 + [_F, _I, _P]},
    "mlstm_scan": {
        "mlstm_scan_forward": [_P] * 16 + [_I] * 5 + [_P],
        "mlstm_scan_forward_chunkwise": [_P] * 17 + [_I] * 6 + [_P],
        "mlstm_scan_backward": [_P] * 25 + [_I] * 6 + [_P],
        "mlstm_scan_backward_chunkwise": [_P] * 18 + [_I] * 5 + [_P]},
    "slstm_scan": {
        "slstm_scan_forward": [_P] * 15 + [_I] * 4 + [_P],
        "slstm_scan_forward_persistent": [_P] * 16 + [_I] * 4 + [_P],
        "slstm_scan_backward": [_P] * 11 + [_I] * 3 + [_P],
        "slstm_scan_backward_persistent": [_P] * 11 + [_I] * 3 + [_P]},
}

LAUNCHES: Dict[str, int] = {"paged_decode_partials": 0,
                            "paged_decode_partials_int8": 0,
                            "flash_prefill": 0,
                            "paged_prefix_partials": 0,
                            "paged_verify_partials": 0,
                            "paged_verify_partials_int8": 0,
                            "split_kv_decode_partials": 0,
                            "mlstm_scan": 0, "mlstm_scan_chunkwise": 0,
                            "mlstm_scan_backward": 0,
                            "mlstm_scan_backward_chunkwise": 0,
                            "slstm_scan": 0, "slstm_scan_persistent": 0,
                            "slstm_scan_backward": 0,
                            "slstm_scan_backward_persistent": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, Path]:
    """Compile the named kernel libraries that are not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> library
    path.  Raises with the compiler's output when a build fails.  With
    ``ptxas_verbose`` every source is rebuilt and the compiler's register
    and shared-memory report is printed."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        tgt = out[name] = _target(name)
        if tgt.exists() and not ptxas_verbose:
            continue
        tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if ptxas_verbose:
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    if name not in _loaded:
        path = build([name])[name]
        cdll = ctypes.CDLL(str(path))
        for fn_name, argtypes in KERNELS[name].items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = cdll
    return _loaded[name]


def launch(name: str, fn_name: str, counter: str, *args) -> None:
    """Call the C entry point ``fn_name`` of library ``name`` on the
    current stream and count the launch under ``counter``.  Raises when
    the launch was refused (the entry point returns
    ``cudaGetLastError()``)."""
    fn = getattr(lib(name), fn_name)
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{counter}: CUDA launch failed with "
                           f"cudaError {err}")
    LAUNCHES[counter] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The kernels' input contract: every tensor on one CUDA device and
    contiguous.  Returns the device; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def dtype_code(name: str, *tensors: torch.Tensor) -> int:
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{name}: q/k/v must share one dtype of "
                         f"{list(DTYPE_CODES)}, got "
                         f"{[t.dtype for t in tensors]}")
    return DTYPE_CODES[dt]


def pool_args(name: str, q: torch.Tensor, k_pages: torch.Tensor,
              v_pages: torch.Tensor, k_scale_pages: Optional[torch.Tensor],
              v_scale_pages: Optional[torch.Tensor]) -> tuple:
    """Check a page kernel's pools: K/V of q's dtype, or int8 with f32
    scale pools (P, bs, KV) on q's device.  Returns (q's dtype code, the
    scale pools or ())."""
    if k_scale_pages is None and v_scale_pages is None:
        return dtype_code(name, q, k_pages, v_pages), ()
    if k_scale_pages is None or v_scale_pages is None:
        raise ValueError(f"{name}: give both scale pools or neither")
    check_cuda(name, q, k_scale_pages, v_scale_pages)
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"{name}: scale pools go with int8 K/V pools, got "
                         f"{k_pages.dtype} / {v_pages.dtype}")
    for t in (k_scale_pages, v_scale_pages):
        if t.dtype != torch.float32 or t.shape != k_pages.shape[:3]:
            raise ValueError(f"{name}: scale pools must be float32 of shape "
                             f"{tuple(k_pages.shape[:3])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return dtype_code(name, q), (k_scale_pages, v_scale_pages)


def check_int32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index tensors must be int32, "
                             f"got {t.dtype}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def page_partials(lib_name: str, fn_name: str, counter: str,
                  q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, pos_pages: torch.Tensor,
                  block_tables: torch.Tensor, pos_q: torch.Tensor,
                  window: Optional[int], scale: Optional[float],
                  soft_cap: Optional[float],
                  k_scale_pages: Optional[torch.Tensor],
                  v_scale_pages: Optional[torch.Tensor],
                  pages_per_split: int):
    """Check and launch one of the page kernels (paged decode with S = 1,
    speculative verify); ``fn_name`` is the C entry point, its ``_q8``
    variant when scale pools are given.  q: (B, S, H, D); k/v_pages:
    (P, bs, KV, D); pos_pages: (P, bs) int32; block_tables: (B, nb) int32;
    pos_q: (B, S) int32.  Returns one partial per split of
    ``pages_per_split`` page slots: o (B, N, S, H, D), l/m (B, N, S, H),
    f32, N = ceil(nb / pps)."""
    q, block_tables, pos_q = (q.contiguous(), block_tables.contiguous(),
                              pos_q.contiguous())
    dev = check_cuda(counter, q, k_pages, v_pages, pos_pages, block_tables,
                     pos_q)
    code, scales = pool_args(counter, q, k_pages, v_pages, k_scale_pages,
                             v_scale_pages)
    check_int32(counter, pos_pages, block_tables, pos_q)
    b, s, h, d, bs, kv, nb = page_shapes(counter, q, k_pages, v_pages,
                                         pos_pages, block_tables, pos_q)
    win, cap = mask_args(window, soft_cap)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    pps = min(int(pages_per_split), max(nb, 1))
    n = -(-nb // pps)
    o = torch.empty((b, n, s, h, d), dtype=torch.float32, device=dev)
    l = torch.empty((b, n, s, h), dtype=torch.float32, device=dev)
    m = torch.empty((b, n, s, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(lib_name, fn_name + ("_q8" if scales else ""), counter,
               *map(ptr, (q, k_pages, v_pages) + scales
                    + (pos_pages, block_tables, pos_q, o, l, m)),
               b, s, h, kv, d, bs, nb, pps, scale, win, cap, code)
    return o, l, m


def page_shapes(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, pos_pages: torch.Tensor,
                block_tables: torch.Tensor, pos_q: torch.Tensor) -> tuple:
    """(B, S, H, D, bs, KV, nb) of a page kernel's inputs: q (B, S, H, D),
    pools (P, bs, KV, D), pos_pages (P, bs), block_tables (B, nb), pos_q
    (B, S).  Raises when they do not fit together."""
    b, s, h, d = q.shape
    _, bs, kv, dk = k_pages.shape
    nb = block_tables.shape[1]
    if (dk != d or h % kv or v_pages.shape != k_pages.shape
            or pos_pages.shape != k_pages.shape[:2]
            or block_tables.shape[0] != b or pos_q.shape != (b, s)):
        raise ValueError(f"{name}: inconsistent shapes q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}, positions "
                         f"{tuple(pos_q.shape)}")
    return b, s, h, d, bs, kv, nb


def check_tiles(name: str, d: int, *tensors: torch.Tensor,
                multiple: int = 8) -> None:
    """The tile kernels' input contract beyond ``check_cuda`` (prefill,
    decode, verify): a head_dim that is a multiple of ``multiple`` (8; 16
    for int8 pools, one 16-byte chunk) up to 256, and data 16-byte aligned
    (they copy rows in 16-byte chunks)."""
    if d % multiple or not 0 < d <= 256:
        raise ValueError(f"{name}: head_dim must be a multiple of "
                         f"{multiple} in [{multiple}, 256], got {d}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")


def mask_args(window: Optional[int],
              soft_cap: Optional[float]) -> tuple:
    """(window, soft_cap) as the C entry points take them: 0 = none."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be > 0, got {soft_cap}")
    return (0 if window is None else int(window),
            0.0 if soft_cap is None else float(soft_cap))
