"""End-to-end serving driver on the PyTorch port: a real reduced model
served with batched requests behind the full Sponge pipeline — EDF
queue, dynamic batching, IP-solver scaler, executable-table vertical
scaling — under a synthetic 4G bandwidth trace
(``examples/serve_dynamic_slo.py`` with ``repro_torch`` for ``repro``).
The table's prefill and decode attention run on the hand-written CUDA
kernels on the card (``--device cuda``, the default); ``--device cpu``
runs their plain PyTorch versions.

    PYTHONPATH=src python examples/torch_serve_dynamic_slo.py \
        [--arch smollm-135m-reduced] [--rps 12] [--duration 8] \
        [--device cuda]
"""
import argparse

from repro_torch.launch.serve import main


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m-reduced")
    ap.add_argument("--rps", type=float, default=12.0)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return main(["--mode", "live", "--arch", a.arch, "--rps", str(a.rps),
                 "--duration", str(a.duration), "--slo", "3.0",
                 "--prompt-len", "16", "--gen-tokens", "4",
                 "--device", a.device])


if __name__ == "__main__":
    run()
