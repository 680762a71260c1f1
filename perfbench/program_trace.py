"""One traced run of a cell with the port's own spans read beside the
harness's, or the tracing's cost per decode call, on the card.

    python3 perfbench/program_trace.py --workload <cell> --seed <n> --seconds <s> [--plain]
    python3 perfbench/program_trace.py --workload <cell> --seed <n> --overhead <gangs>

Without ``--overhead`` the run is the one ``run.py --trace 1`` makes,
inside ``harness.program.Wiring``: the stack built with a
``ServeTrace`` (not with ``--plain``), the profiler's digest keeping the
``sponge.*`` spans.  It prints the run's result line, whose metrics hold
the program's (``harness/program.py``) beside every per-layer metric of
the cell, and under ``program`` the median decode call wall inside the
profiled slice and outside it.

With ``--overhead N`` it builds the cell's stack with a trace and, with
the profiler off, serves 2N gangs of the largest b, every stream
``max_decode`` long, with the trace on and off in turns (on, off, off,
on, ...).  It prints each side's median decode call wall (the step
table's own timing: the spans ``decode``, ``sync``, ``copy_in`` and
``replay`` fall inside it), each side's median gang wall per decode
call (everything, noisier), and what one span and one mark cost on the
host alone.  Either way the last line of the output is one JSON object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import run as cli  # noqa: E402  -- its environment too


def traced_run(bench, cell, seed: int, seconds: float, plain: bool,
               device="cuda") -> dict:
    from perfbench.harness import measure, program
    with program.Wiring(program=not plain) as w:
        result, _ = measure.run(bench, cell, seed, seconds, True, T_START,
                                device)
    result["program"] = program.decode_walls_ms(w.run)
    result["seed"] = seed
    result["plain"] = plain
    return result


def _med_ms(xs) -> float:
    return 1e3 * statistics.median(xs)


def overhead(bench, cell, seed: int, gangs: int, device="cuda") -> dict:
    """Decode call walls with the trace on and off (module docstring)."""
    import torch

    from perfbench.harness import program, serve, spec, traffic
    from repro_torch.core.slo import Request

    conf = spec.load_config(bench, cell["config"])
    mix = spec.load_mix(cell["traffic"])
    family = spec.reference(conf["family"])
    with program.Wiring() as w:
        runner, backend, _ = serve.build_stack(conf, mix, family, seed,
                                               device)
    tr = w.trace
    steps = [fn.step for fn in (*backend.pre_table.fns.values(),
                                *backend.dec_table.fns.values())]
    b, c = max(mix["b_set"]), max(mix["c_set"])
    prompts = [r.prompt for r in
               traffic.generate(mix, seed, 60.0, conf["vocab_size"])[:b]]
    walls = {True: [], False: []}
    calls = {True: [], False: []}
    for k in range(2 * gangs):
        on = (k % 4) in (0, 3)
        backend.set_trace(tr if on else None)
        for s in steps:
            s.trace = tr if on else None
        batch = [Request.make(arrival=0.0, comm_latency=0.0, slo=1e9,
                              size_kb=1.0, prompt_tokens=len(p),
                              decode_tokens=mix["max_decode"])
                 for p in prompts]
        for q, p in zip(batch, prompts):
            backend.on_submit(q, p)
        n = len(backend.dec_table.calls)
        t0 = time.perf_counter()
        backend.execute(batch, c, b, 0.0)
        wall = time.perf_counter() - t0
        made = backend.dec_table.calls[n:]
        walls[on].append(wall / len(made))
        calls[on] += [dt for _, _, _, dt in made]
    reps = 100_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with tr.span("overhead"):
            pass
    span_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.mark("overhead")
    mark_us = (time.perf_counter() - t0) / reps * 1e6
    return {"workload": cell["name"], "seed": seed, "gangs": gangs,
            "b": b, "decode_calls": mix["max_decode"],
            "device": torch.cuda.get_device_name(0)
            if str(device).startswith("cuda") else "cpu",
            "call_ms_on": _med_ms(calls[True]),
            "call_ms_off": _med_ms(calls[False]),
            "call_cost_us": 1e3 * (_med_ms(calls[True])
                                   - _med_ms(calls[False])),
            "gang_per_decode_ms_on": _med_ms(walls[True]),
            "gang_per_decode_ms_off": _med_ms(walls[False]),
            "gang_cost_us_per_decode": 1e3 * (_med_ms(walls[True])
                                              - _med_ms(walls[False])),
            "span_us": span_us, "mark_us": mark_us}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--overhead", type=int, default=0)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness import spec
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 2
    if args.overhead:
        line = overhead(bench, cell, args.seed, args.overhead)
    else:
        line = traced_run(bench, cell, args.seed, args.seconds, args.plain)
    found = cli.forbidden_modules()
    if found:
        print(f"program_trace: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
