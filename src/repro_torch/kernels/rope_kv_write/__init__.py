from repro_torch.kernels.rope_kv_write.ops import rope_kv_write
