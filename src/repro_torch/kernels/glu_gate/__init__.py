from repro_torch.kernels.glu_gate.ops import glu_gate
