"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each source under ``kernels/csrc`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface; all
``nvcc`` processes start together.  The libraries go to
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the flags, the source and every
shared ``*.cuh`` header, so a changed source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing is built or loaded at
import: the first launch (or ``build()``) does it.

Every source exports one C entry point ``int repro_<name>(..., cudaStream_t)``
that returns a CUDA error code; ``kernel`` makes its launcher, which
counts each launch under ``name`` in ``utils/counters.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

import torch

from repro_torch.utils import counters

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on a machine with an NVIDIA card")


def _target(name: str) -> Path:
    """The library of one source, named by a hash of the flags, the
    source and every shared header under ``csrc`` (any of which it may
    include), so that a changed header rebuilds every kernel."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named kernel source that is not built yet, with one
    ``nvcc`` process per source, all running at once.  Returns the
    library path of each name; raises with the compiler's output when a
    build fails."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}:\n{log}")
                continue
            os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def kernel(name: str, argtypes: Sequence) -> Callable[..., None]:
    """The launcher of ``repro_<name>``: ``launch(device, *args)`` calls
    it with ``args`` (of the C types ``argtypes``) and the current stream
    of ``device`` (read at every call: a CUDA graph's capture runs on its
    own stream), raises on a nonzero return, and otherwise counts one
    launch of ``name``.  The library is loaded (built if need be) at the
    first call."""
    fn = None
    counters.bump(name, 0)

    def launch(device, *args) -> None:
        nonlocal fn
        if fn is None:
            fn = getattr(load(name), f"repro_{name}")
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        counters.bump(name)

    return launch
