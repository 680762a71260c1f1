"""Train a ~1M-param SmolLM-family model for a few hundred steps on the
synthetic pipeline and checkpoint it, on the PyTorch port
(``examples/train_smollm.py`` with ``repro_torch`` for ``repro``).  The
identical code path drives the full 135M config on the card
(``--device cuda``, the default; ``--device cpu`` on a machine without
one).

    PYTHONPATH=src python examples/torch_train_smollm.py [--steps 200] \
        [--device cuda]
"""
import argparse

from repro_torch.launch.train import main


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default="out/smollm_ckpt")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return main(["--arch", "smollm-135m-reduced", "--steps", str(a.steps),
                 "--batch", "8", "--seq", "64", "--lr", "1e-3",
                 "--ckpt", a.ckpt, "--log-every", "20",
                 "--device", a.device])


if __name__ == "__main__":
    run()
