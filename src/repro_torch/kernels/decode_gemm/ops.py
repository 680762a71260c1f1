"""The decode step's weight products at a few rows: CUDA kernel and plain
version.

Replaces no TPU kernel: the reference leaves every weight product to
XLA's dot, and the port's ``models.common.linear`` leaves it to cuBLAS.
At a decode step of at most 16 rows (``MAX_ROWS``) the hand-written
Hopper kernel ``kernels/csrc/decode_gemm.cu`` takes ``x @ w`` instead,
for up to three weights that read the same ``x`` in one launch (a Mamba2
layer's three in-projections).  Every output is a sum in f32 rounded
once to bf16, as ``linear``'s; the weights stay as they are, in the
port's (in, out) layout, or one weight as an (out, in) tensor's
transpose (the tied head, the embedding read in place).

What bounds it on the H100: the weight bytes (at most 16 operations a
byte).  Each block streams a tile of 128 columns of one weight (64 of a
transposed one: ``TILE_N``) through a 6-stage ``cp.async`` ring,
multiplies on ``mma.sync`` with the rows of ``x`` as the narrow
dimension, and where the tiles are too few for the card's SMs, K is
split over a thread-block cluster whose partial sums meet in distributed
shared memory (``split_for``): one launch, no reduction kernel.  It is a
programmatic dependent launch: its first 80 KB of weight a block stream
in while the kernel before it finishes.  ``chip_smoke.py`` measures it
beside its bound, the plain version and ``torch.matmul``.

``decode_gemm`` takes the plain version only for tensors on the CPU; a
CUDA tensor launches the kernel or raises.  ``takes_kernel`` says which
products the kernel takes; ``models.common.decode_linear`` routes a
decode step's products by it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from repro_torch.kernels import build

MAX_ROWS = 16
MAX_WEIGHTS = 3
TILE_N = {False: 128, True: 64}     # output columns a block: (K, N), (N, K)
STAGE_ELEMS = 8192          # weight elements a stage of the ring (16 KB)
MAX_SPLIT = 8               # blocks of a cluster
_launch = build.kernel(
    "decode_gemm", [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
       ctypes.c_longlong] * MAX_WEIGHTS + [ctypes.c_int] * 2)


def decode_gemm_plain(x: torch.Tensor, ws: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """``x @ w`` for each weight: ``models.common.linear`` itself."""
    return [torch.matmul(x, w) for w in ws]


def _row_major(w: torch.Tensor) -> bool:
    return w.stride(1) == 1 and w.stride(0) >= w.shape[1] \
        and w.stride(0) % 8 == 0


def _transposed(w: torch.Tensor) -> bool:
    """An (in, out) view of an (out, in) row-major tensor."""
    return w.stride(0) == 1 and w.stride(1) >= w.shape[0] \
        and w.stride(1) % 8 == 0


def takes_kernel(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> bool:
    """Whether ``decode_gemm`` takes ``x @ w`` for every weight of
    ``ws``: bf16, at most ``MAX_ROWS`` rows of a K that is a multiple of
    8, one to three 2-D weights (K, N) with N a multiple of 8, each
    row-major or (one weight alone) the transpose of a row-major (N, K),
    16-byte aligned.  The device is the wrapper's to judge."""
    k = x.shape[-1]
    if x.dtype != torch.bfloat16 or k == 0 or k % 8 \
            or not 1 <= x.numel() // k <= MAX_ROWS \
            or not 1 <= len(ws) <= MAX_WEIGHTS:
        return False
    for w in ws:
        if w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[0] != k \
                or w.shape[1] % 8 or w.data_ptr() % 16 \
                or not (_row_major(w) or (len(ws) == 1 and _transposed(w))):
            return False
    return True


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_for(k: int, tiles: int, sms: int, tile_n: int) -> int:
    """The blocks of a cluster that share K: the least power of two up to
    ``MAX_SPLIT`` that gives every one of ``sms`` SMs a block
    (``tiles`` x split >= sms), while every block keeps at least one
    stage (``STAGE_ELEMS / tile_n`` rows of K)."""
    stages = -(-k // (STAGE_ELEMS // tile_n))
    split = 1
    while split < MAX_SPLIT and tiles * split < sms and 2 * split <= stages:
        split *= 2
    return split


def tiles_of(ns: Sequence[int], tile_n: int) -> int:
    """The blocks of ``tile_n`` output columns over weights of ``ns``
    columns."""
    return sum(-(-n // tile_n) for n in ns)



def decode_gemm(x: torch.Tensor, ws: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """``x @ w`` for each weight of ``ws`` (one to three, each (K, N_i)),
    in one launch: ``x`` (..., K) with at most ``MAX_ROWS`` rows, each
    output (..., N_i) bf16.  Raises unless ``takes_kernel``."""
    if x.device.type == "cpu":
        return decode_gemm_plain(x, ws)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not takes_kernel(x, ws) \
            or any(w.device != x.device for w in ws):
        raise ValueError(
            f"decode_gemm takes bf16 x of at most {MAX_ROWS} rows and 1 to "
            f"{MAX_WEIGHTS} bf16 (K, N) weights on its device, K and N "
            f"multiples of 8, row-major or one (N, K) transposed, 16-byte "
            f"aligned; got x {tuple(x.shape)} {x.dtype}, weights "
            f"{[(tuple(w.shape), w.stride(), w.dtype) for w in ws]}")
    k = x.shape[-1]
    rows = x.numel() // k
    x2 = x.reshape(rows, k)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    ys = [torch.empty((*x.shape[:-1], w.shape[1]), dtype=x.dtype,
                      device=x.device) for w in ws]
    wt = not _row_major(ws[0])
    args = []
    for i in range(MAX_WEIGHTS):
        if i < len(ws):
            w, y = ws[i], ys[i]
            args += [w.data_ptr(), w.stride(1) if wt else w.stride(0),
                     w.shape[1], y.data_ptr(), w.shape[1]]
        else:
            args += [None, 0, 0, None, 0]
    ns = [w.shape[1] for w in ws]
    sms = _sms(x.device.index or 0)
    split = split_for(k, tiles_of(ns, TILE_N[wt]), sms, TILE_N[wt])
    _launch(x.device, x2.data_ptr(), x2.stride(0), rows, k, len(ws), *args,
            int(wt), split)
    return ys
