"""The paper's Fig. 4 study on the PyTorch port as a runnable example:
Sponge vs FA2 vs static instances on a 10-minute 4G trace
(discrete-event simulation calibrated with the YOLOv5s-class perf
model; NumPy only, no device).  ``examples/fig4_study.py`` with
``repro_torch`` for ``repro``: it prints the reference's lines.

    PYTHONPATH=src python examples/torch_fig4_study.py [--duration 600]
"""
import argparse

from repro_torch.launch.serve import main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--rps", type=float, default=20.0)
    a = ap.parse_args()
    main(["--mode", "sim", "--duration", str(a.duration),
          "--rps", str(a.rps)])
