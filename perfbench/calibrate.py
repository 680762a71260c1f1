"""Readings that set a cell's rate and its limit of ``correct``, on the card.

    python3 perfbench/calibrate.py --workload <cell> sweep --rates 2,4,6 --seconds 20
    python3 perfbench/calibrate.py --workload <cell> seeds --seeds 1,2,3 --seconds 10 [--control N]

Every window is served as a run of the benchmark serves it
(``serve.serve``: the stack built by ``serve.build_stack`` over the
seed's weights, the open loop, the drain), one after another in one
process:

- ``sweep``: the cell's mix at each offered rate; prints each rate's
  share of requests that met both limits, the 50th and 90th percentile
  of time to first token, the tokens per second, the queue wait of the
  first and the last third of the requests (a backlog that grows shows
  as a later third that waits longer) and how long the drain took.  The
  knee is the highest rate with at least 90 % met and no growing backlog.
- ``seeds``: at the cell's rate, each seed's weights and traffic; judges
  the served tokens by ``check.verdict`` with the cell's limits, as a
  run does, and on the first ``--control`` seeds judges the control
  (the tokens the fp8 reference puts first) by the same verdict, which
  has to come out not correct.  Prints each side's verdict, the numbers
  compared beside their limits, the mean gap and the share of tokens
  whose gap is not 0.

Every line is also appended to ``chiprun_out/calibrate-<cell>.jsonl``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def third_waits(run):
    from perfbench.harness import stats
    order = sorted(run.reqs, key=lambda r: r.send)
    k = max(1, len(order) // 3)
    waits = [run.dispatch[r.index] - r.arrival if r.index in run.dispatch
             else stats.INF for r in order]
    return (stats.percentile(waits[:k], 50), stats.percentile(waits[-k:], 50))


def _free(device) -> None:
    gc.collect()
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.empty_cache()


def sweep(bench, cell, rates, seed: int, seconds: float, emit,
          device="cuda", root=None):
    """One window per offered rate (module docstring)."""
    from perfbench.harness import serve, spec, stats
    root = root or spec.ROOT
    conf = spec.load_config(bench, cell["config"], root)
    mix = spec.load_mix(cell["traffic"], root)
    family = spec.reference(conf["family"], root)
    for rate in rates:
        m = dict(mix, rate_rps=rate)
        t0 = time.perf_counter()
        run, _, gen, _ = serve.serve(cell["name"], conf, m, family, seed,
                                     seconds, False, t0, device)
        last = max((ts[-1] for ts in run.tokens.values()), default=0.0)
        first, later = third_waits(run)
        emit({"rate": rate, "sent": len(run.reqs), "served": len(gen),
              "setup_s": run.setup_s,
              "met_pct": stats.attainment_pct(run),
              "ttft_p50_s": stats.percentile(stats.ttfts(run), 50),
              "ttft_p90_s": stats.percentile(stats.ttfts(run), 90),
              "tokens_per_s": stats.tokens_in_window(run) / seconds,
              "wait_first_third_s": first, "wait_last_third_s": later,
              "drain_s": last - seconds, "gangs": len(run.gangs),
              "mean_gang": len(gen) / max(len(run.gangs), 1),
              "wall_s": time.perf_counter() - t0})
        del run, gen
        _free(device)


def seeds(bench, cell, seed_list, seconds: float, control: int, emit,
          device="cuda", root=None) -> list:
    """One window per seed, judged as a run judges it; the control is
    judged by the same verdict on the first ``control`` seeds (module
    docstring).  Returns the records."""
    from perfbench.harness import check, serve, spec
    root = root or spec.ROOT
    conf = spec.load_config(bench, cell["config"], root)
    mix = spec.load_mix(cell["traffic"], root)
    family = spec.reference(conf["family"], root)
    limits = spec.cell_limits(cell["name"], root)
    out = []
    for n, seed in enumerate(seed_list):
        t0 = time.perf_counter()
        run, tree, gen, _ = serve.serve(cell["name"], conf, mix, family,
                                        seed, seconds, False, t0, device)
        t1 = time.perf_counter()
        pick = check.sample(run, gen, seed)
        got = check.gaps(family, tree, conf, mix["bucket"], run, gen, pick,
                         device, control=n < control)
        rec = {"seed": seed, "setup_s": run.setup_s, "sent": len(run.reqs),
               "served": len(gen), "checked_requests": len(pick),
               "checked_tokens": len(got["served"]),
               "ref_s": time.perf_counter() - t1}
        sides = ("served", "control") if n < control else ("served",)
        for side in sides:
            g = got[side]
            ok, numbers = check.verdict(run, gen, g, limits)
            rec[side] = {"correct": ok, "check": numbers,
                         "mean_gap": sum(g) / len(g) if g else None,
                         "nonzero_pct": (100.0 * sum(x > 0 for x in g)
                                         / len(g)) if g else None}
        emit(rec)
        out.append(rec)
        del run, tree, gen
        _free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("mode", choices=("sweep", "seeds"))
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=0,
                    help="judge the fp8 control on the first N seeds")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    from perfbench.harness import spec
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    seed_list = [int(s) for s in args.seeds.split(",")]
    out = ROOT / "chiprun_out" / f"calibrate-{cell['name']}.jsonl"
    out.parent.mkdir(exist_ok=True)

    def emit(rec):
        rec.update(cell=cell["name"], mode=args.mode,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    if args.mode == "sweep":
        sweep(bench, cell, [float(x) for x in args.rates.split(",")],
              seed_list[0], args.seconds, emit)
    else:
        seeds(bench, cell, seed_list, args.seconds, args.control, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
