"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with `ctypes`: no PyTorch headers, so a
build takes seconds. Builds happen at first use, all sources at once (one
`nvcc` process each, started together), into `_build/` beside this file,
which `.gitignore` lists. A library's file name carries a hash of its
source, the headers and the flags, so an edited kernel is rebuilt and an
unchanged one is reused.

A missing `nvcc` or a failed compile raises `RuntimeError`; nothing falls
back to another implementation. Every kernel is launched by `launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel (with -Xptxas -v: registers, shared memory,
# spills), kept for whoever wants to print it
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA toolkit is "
        "needed to build the kernels in " + str(CSRC))


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every stale `csrc/*.cu`; returns {name: library path}."""
    out = {src.stem: BUILD_DIR / f"{src.stem}-{_digest(src)}.so"
           for src in sorted(CSRC.glob("*.cu"))}
    stale = {name: path for name, path in out.items() if not path.exists()}
    if not stale:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in stale.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    try:
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            build_log[name] = log
            if proc.returncode != 0:
                failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, stale[name])
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built on first use)."""
    if name not in _libs:
        paths = build_all()
        if name not in paths:
            raise RuntimeError(f"no kernel source {name}.cu in {CSRC}")
        _libs[name] = ctypes.CDLL(str(paths[name]))
    return _libs[name]


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# {C entry point: (the csrc/<library>.cu defining it, its parameter types as
# its `extern "C"` line declares them, the stream last)}; each returns 0 or
# a CUDA error
ENTRIES: Dict[str, Tuple[str, Tuple[type, ...]]] = {
    "flash_fwd": ("flash_fwd", (_P,) * 5 + (_I,) * 6 + (_F, _P)),
    "flash_bwd": ("flash_bwd", (_P,) * 9 + (_I,) * 7 + (_F, _P)),
    "xent_fwd": ("xent", (_P,) * 4 + (_I,) * 3 + (_L,) * 3 + (_P,)),
    "xent_bwd": ("xent", (_P,) * 5 + (_I,) * 4 + (_L,) * 3 + (_P,)),
    "conv_fwd": ("short_conv", (_P,) * 3 + (_I,) * 5 + (_P,)),
    "conv_bwd": ("short_conv", (_P,) * 6 + (_I,) * 5 + (_P,)),
    "conv_silu_fwd": ("conv_silu", (_P, _L) + (_P,) * 3 + (_I,) * 5 + (_P,)),
    "conv_silu_bwd": ("conv_silu", (_P, _L) + (_P,) * 6 + (_I,) * 5 + (_P,)),
    "ssd_fwd": ("ssd", (_P, _L, _P, _P, _P, _L, _P, _L) + (_P,) * 3
                + (_I,) * 4 + (_P,)),
    "ssd_bwd": ("ssd", (_P, _L, _P, _P, _P, _L, _P, _L) + (_P,) * 10
                + (_I,) * 4 + (_P,)),
}
_fns: Dict[str, Callable[..., int]] = {}
# the one-device ring launches from a thread per member
_count_lock = threading.Lock()


def on_card(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the plain version's), True for a CUDA one
    (the kernels'); ValueError on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cuda"


def launch(entry: str, device, *args, launches: Dict[str, int],
           count: Optional[Iterable[str]] = None) -> None:
    """The C entry point `entry` on `args` and `device`'s current stream,
    under `torch.cuda.device(device)`; typed from `ENTRIES` on first use.
    A non-zero return raises RuntimeError; else each name in `count`
    (default: `entry`) gains one in the caller's `launches`."""
    fn = _fns.get(entry)
    if fn is None:
        lib_name, argtypes = ENTRIES[entry]
        fn = getattr(library(lib_name), entry)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _fns[entry] = fn
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    with _count_lock:
        for name in (entry,) if count is None else count:
            launches[name] += 1
