"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Serves the cell's traffic through the PyTorch and CUDA port
(``src/repro_torch``) on NVIDIA cards for ``--seconds`` of wall clock
(``perfbench/harness/serve.py``), checks what it served against the
plain reference (``perfbench/harness/check.py``), and prints one JSON
object as the last line of its output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read over
a profiled slice of the window.  The numbers compared for ``correct``
are printed beside their limits as the last lines of standard error
and under the result's last key, ``check``.

Exits with another code than 0, and prints no result, when no card is
there (or fewer than the cell asks for), when the port cannot be
imported, or when JAX or the JAX package was loaded into this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache stays inside the checkout, at a fixed path:
# the port's kernels build into build/repro_torch_kernels/ by themselves,
# and any Triton or torch extension build would go here
for var, sub in (("TRITON_CACHE_DIR", "build/triton"),
                 ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
    os.environ[var] = str(ROOT / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Of ``names`` (the loaded modules), those whose top-level name is
    JAX's or the JAX package's (compared whole: ``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import repro_torch  # noqa: F401  -- the port: a checkout without it fails here
    import torch

    from perfbench.harness import spec
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from perfbench.harness import measure
    result, check_lines = measure.run(bench, cell, args.seed, args.seconds,
                                      bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    for line in check_lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
