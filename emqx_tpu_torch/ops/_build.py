"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with nvcc into its own shared library
with a plain C interface, under ``emqx_tpu_torch/_build/`` (gitignored), at
first use; the library's name carries a hash of the source and the flags,
so an edited source rebuilds.  Libraries load with ``ctypes``: every pointer
and the stream pass as ``c_void_p``.  No PyTorch headers are compiled, which
keeps a build to seconds.  A failed build raises.

Every launch goes through a :class:`Kernel`, which raises on a non-zero
``cudaGetLastError()`` and counts the launches it made — the count a run
reads to show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  With no card, ``device=None`` raises — nothing falls back
    to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain-torch versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes."""
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ' (non-contiguous)'}")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(
        " ".join(NVCC_FLAGS).encode() + b"\0" + src.read_bytes()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(sources: Optional[list[str]] = None) -> dict[str, Path]:
    """Compile every stale source, one nvcc process per source, all started
    together.  Returns source name → library path; raises on any failure."""
    names = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    out = {n: _lib_path(CSRC / n) for n in names}
    stale = {n: p for n, p in out.items() if not p.exists()}
    if not stale:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n, p in stale.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n} failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, stale[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([source])[source]))
            lib.router_kernels_error_string.argtypes = [ctypes.c_int]
            lib.router_kernels_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class Kernel:
    """One C entry point of a csrc library, loaded at first launch."""

    def __init__(self, symbol: str, source: str, argtypes: list) -> None:
        self.symbol = symbol
        self.source = source
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args, device: torch.device) -> None:
        fn = self._fn
        if fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
        if err:
            msg = library(self.source).router_kernels_error_string(err)
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed ({err}): {msg.decode()}")
        self.launches += 1


P, I, U, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong

# symbol → Kernel, one per hand-written kernel launch
KERNELS: dict[str, Kernel] = {
    "trie_walk": Kernel("trie_walk", "router_kernels.cu",
                        [P, P, U] + [P] * 3 + [I] * 4 + [P] * 3),
    "compact": Kernel("compact", "router_kernels.cu",
                      [P, I, I, I, P, P, P]),
    "fanout_pool": Kernel("fanout_pool", "router_kernels.cu",
                          [P, I, P, I, I, P, I, I, P, P]),
    "patch": Kernel("patch", "router_kernels.cu",
                    [P] * 6 + [I, P, P, I, P, I, P]),
    "trie_walk_sharded": Kernel("trie_walk_sharded", "router_kernels.cu",
                                [P, P, U, LL, LL] + [P] * 3 + [I] * 5
                                + [P] * 3),
    "compact_sharded": Kernel("compact_sharded", "router_kernels.cu",
                              [P] + [I] * 6 + [P] * 4),
    "fanout_bitmaps": Kernel("fanout_bitmaps", "router_kernels.cu",
                             [P, I, I, P, I, I, P, P]),
    "bitmap_counts": Kernel("bitmap_counts", "router_kernels.cu",
                            [P, I, I, P, P]),
    "walk_compact": Kernel("walk_compact", "router_kernels.cu",
                           [P, P, U] + [P] * 3 + [I] * 5 + [P] * 3),
    "walk_compact_sharded": Kernel("walk_compact_sharded",
                                   "router_kernels.cu",
                                   [P, P, U, LL, LL] + [P] * 3 + [I] * 9
                                   + [P] * 4),
}


def launch_counts() -> dict[str, int]:
    return {n: k.launches for n, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
