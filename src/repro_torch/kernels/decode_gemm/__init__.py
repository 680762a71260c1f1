from repro_torch.kernels.decode_gemm.ops import decode_gemm
