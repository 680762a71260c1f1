"""The SwiGLU / GeGLU gate: CUDA kernel and plain version.

Replaces no TPU kernel: the reference leaves the gate of its MLP to XLA,
which fuses it.  In PyTorch it is an activation kernel and a product
kernel a layer of every decode step; the hand-written Hopper kernel
``kernels/csrc/glu_gate.cu`` is one.  ``glu_gate_plain`` is the pair as
``models.mlp.mlp_fwd`` runs it on every other path.

What bounds it on the H100: the bytes (gate and up read, the product
written), about a MB at the decode shapes, so the launch.  One thread
per 8 elements with 16-byte accesses.  ``chip_smoke.py`` measures it
beside its bound and the plain version.

``glu_gate`` takes the plain version only for tensors on the CPU; a
CUDA tensor launches the kernel (bf16 only) or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_KINDS = {"swiglu": 0, "geglu": 1, "geglu_erf": 2}
_launch = build.kernel("glu_gate", [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int])


def glu_gate_plain(gate: torch.Tensor, up: torch.Tensor, kind: str
                   ) -> torch.Tensor:
    """``act(gate) * up``, act SiLU (``swiglu``), tanh-GELU (``geglu``)
    or the exact erf GELU (``geglu_erf``, Zamba2's), each rounded to the
    inputs' dtype."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "geglu_erf":
        return F.gelu(gate) * up
    raise ValueError(kind)


def _check(gate, up, kind):
    if kind not in _KINDS:
        raise ValueError(f"kind {kind!r} not in {tuple(_KINDS)}")
    if gate.shape != up.shape or gate.numel() % 8:
        raise ValueError(f"gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} must match, with a multiple "
                         f"of 8 elements")
    for t in (gate, up):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"bfloat16 expected, got {t.dtype}")
        if t.device != gate.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("gate, up must be contiguous, 16-byte aligned "
                             "and on one device")


def glu_gate(gate: torch.Tensor, up: torch.Tensor, kind: str
             ) -> torch.Tensor:
    """``act(gate) * up`` in gate's shape and dtype (``glu_gate_plain``)."""
    if gate.device.type == "cpu":
        return glu_gate_plain(gate, up, kind)
    if gate.device.type != "cuda":
        raise ValueError(f"no kernel for device {gate.device}")
    _check(gate, up, kind)
    act = torch.empty_like(gate)
    _launch(gate.device, gate.data_ptr(), up.data_ptr(), act.data_ptr(),
            gate.numel(), _KINDS[kind])
    return act
