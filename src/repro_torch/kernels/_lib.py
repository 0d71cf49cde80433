"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``.  The
build happens at first use, from the sources in this checkout, into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``); the library name carries a hash of the sources and
flags, so an edited kernel is rebuilt.  Nothing here runs when a module
is imported: the CPU tests import every module and have no ``nvcc``.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one only
where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
HEADERS = ("common.cuh", "paged_partials.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> (C entry point, argtypes)
KERNELS = {
    "paged_decode": ("paged_decode_partials",
                     [_P] * 9 + [_I] * 6 + [_F, _I, _F, _I, _P]),
    "paged_prefix": ("paged_prefix_partials",
                     [_P] * 9 + [_I] * 7 + [_F, _I, _F, _I, _P]),
    "flash_prefill": ("flash_prefill",
                      [_P] * 6 + [_I] * 7 + [_F, _I, _F, _I, _I, _P]),
}

LAUNCHES: Dict[str, int] = {"paged_decode_partials": 0, "flash_prefill": 0,
                            "paged_prefix_partials": 0}

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
        fn_name, argtypes = KERNELS[name]
        fn = getattr(cdll, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = cdll
    return _loaded[name]


def launch(name: str, counter: str, *args) -> None:
    """Call a kernel's C entry point on the current stream and count the
    launch.  Raises when the launch was refused (the entry point returns
    ``cudaGetLastError()``)."""
    fn = getattr(lib(name), KERNELS[name][0])
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


def check_int32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index tensors must be int32, "
                             f"got {t.dtype}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def mask_args(window: Optional[int],
              soft_cap: Optional[float]) -> tuple:
    """(window, soft_cap) as the C entry points take them: 0 = none."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap must be > 0, got {soft_cap}")
    return (0 if window is None else int(window),
            0.0 if soft_cap is None else float(soft_cap))
