"""Hand-written CUDA kernels for Hopper (``sm_90a``) for the serving hot
spots: the counterparts of the reference's Pallas TPU kernels, five
that fuse the decode step's elementwise chains (``add_rms_norm``,
``rope_kv_write``, ``glu_gate``, and a Mamba2 mixer's
``mamba2_conv_step`` and ``mamba2_gate_norm``), which the reference
leaves to XLA, and ``decode_gemm``, the decode step's weight products
at up to 16 rows, which it leaves to XLA's dot: a programmatic
dependent launch that the small fused kernels let start early
(``csrc/common.cuh``).

Each kernel has its source under ``csrc/`` and an ``ops.py`` with the
public wrapper and its plain PyTorch version (which the wrapper takes
for tensors on the CPU).  ``build.py`` owns the rest: a source's
launcher (``build.kernel``), which compiles it with ``nvcc`` at its
first launch and counts every launch in ``utils/counters.py``;
importing this package builds nothing.
"""
from repro_torch.kernels.add_rms_norm.ops import add_rms_norm
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_gemm.ops import decode_gemm
from repro_torch.kernels.glu_gate.ops import glu_gate
from repro_torch.kernels.mamba2_conv_step.ops import mamba2_conv_step
from repro_torch.kernels.mamba2_gate_norm.ops import mamba2_gate_norm
from repro_torch.kernels.rope_kv_write.ops import rope_kv_write
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.swa_prefill.ops import swa_prefill_attention
