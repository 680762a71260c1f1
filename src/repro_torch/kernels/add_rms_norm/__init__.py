from repro_torch.kernels.add_rms_norm.ops import add_rms_norm
