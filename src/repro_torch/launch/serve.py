"""Serving launcher: Sponge end-to-end through the serving API.

Counterpart of ``repro.launch.serve`` under the same argument names.
Three modes, one control plane:

* ``--mode sim``  -- the trace-driven discrete-event study (Fig. 4):
  Sponge vs FA2 vs static 8/16 under a 4G bandwidth trace on the
  ``yolov5s_like`` model; NumPy only, no device.
* ``--mode live`` -- the paper's fixed-work loop on a real model
  (``make_live_server``): EDF queue, dynamic batching, the IP-solver
  scaler, and the (c, b) table of prefill + ``--gen-tokens`` greedy
  decode steps on the Hopper kernels.  Runs on ``cuda`` unless
  ``--device`` names another.  ``--policy fa2`` runs one-core replicas
  over the same table (on one card they run one after another in wall
  time; the virtual clock treats them as parallel).
* ``--scenario <token scenario>`` (or ``--mode scenario``) -- a
  registered token scenario served on the real kernels through
  ``TokenTorchBackend`` (``--engine torch``).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode sim --duration 600
    PYTHONPATH=src python -m repro_torch.launch.serve --mode live \\
        --arch smollm-135m --rps 10 --duration 6 --prompt-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario llm-chat \\
        --arch smollm-135m --requests 48 --prompt-len 256 --gen-tokens 64

``--arch`` takes any id of ``repro_torch.configs.registry`` (``smollm-135m``,
``smollm-360m``, ``gemma-2b``, ``h2o-danube-1.8b``, ``rwkv6-1.6b``,
``zamba2-2.7b``, and their ``-reduced`` cuts).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.slo import Request
from repro_torch.network.latency import comm_latency
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving.api import make_live_server, make_sim_server
from repro_torch.serving.scenarios import list_scenarios
from repro_torch.serving.token_backend import run_token_scenario
from repro_torch.serving.workload import WorkloadGenerator

SIM_POLICIES = (("sponge", dict(c0=16)),
                ("fa2", dict(c0=1)),
                ("static-8", dict(c0=8)),
                ("static-16", dict(c0=16)))
LIVE_C_SET = LIVE_B_SET = (1, 2, 4, 8)


def run_sim(args) -> dict:
    perf = yolov5s_like()
    trace = synth_4g_trace(args.duration, seed=args.seed)
    wl = WorkloadGenerator(rps=args.rps, slo=args.slo, size_kb=args.size_kb)

    out = {}
    for name, kw in SIM_POLICIES:
        server = make_sim_server(perf, name, prior_rps=args.rps,
                                 slo=args.slo, expected_rps=args.rps, **kw)
        out[name] = server.serve(wl, trace)
    for k, v in out.items():
        print(f"{k:10s} violations={v['violation_rate']*100:6.2f}%  "
              f"avg_cores={v['avg_cores']:6.2f}  p99={v['p99']:.3f}s")
    sp, fa = out["sponge"], out["fa2"]
    print("SLO-violation reduction vs FA2: "
          f"{fa['violation_rate']/max(sp['violation_rate'],1e-9):.1f}x "
          "(paper: >15x)")
    print("CPU reduction vs static-16: "
          f"{100*(1-sp['avg_cores']/out['static-16']['avg_cores']):.1f}% "
          "(paper: >20%)")
    return out


def live_arrivals(rps: float, duration: float, slo: float, size_kb: float,
                  prompt_len: int, vocab_size: int, seed: int):
    """``(Request, prompt)`` pairs for ``--mode live``: sends at a fixed
    ``rps`` over ``duration`` seconds, comm latency from a 4G trace drawn
    from ``seed``, random prompt ids from the same seed (the reference's
    ``run_live`` arrival loop)."""
    trace = synth_4g_trace(int(duration) + 5, seed=seed)
    rng = np.random.default_rng(seed)
    arrivals = []
    for i in range(int(rps * duration)):
        ts = i / rps
        cl = comm_latency(size_kb, trace, ts)
        req = Request.make(arrival=ts + cl, comm_latency=cl, slo=slo)
        arrivals.append((req, rng.integers(
            0, vocab_size, prompt_len).astype(np.int32)))
    return arrivals


def run_live(args) -> dict:
    server, cfg = make_live_server(
        args.arch, c_set=LIVE_C_SET, b_set=LIVE_B_SET,
        prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
        policy=args.policy, adaptation_interval=0.5, prior_rps=args.rps,
        slo=args.slo, expected_rps=args.rps, device=args.device)
    perf = server.backend.perf
    print(f"calibrated perf model: gamma={perf.gamma:.6g} "
          f"eps={perf.eps:.6g} delta={perf.delta:.6g} eta={perf.eta:.6g} "
          f"r2={perf.r2:.3f} l(1,1)={perf.latency(1, 1)*1e3:.1f}ms")
    arrivals = live_arrivals(args.rps, args.duration, args.slo,
                             args.size_kb, args.prompt_len, cfg.vocab_size,
                             args.seed)
    report = server.run(arrivals, horizon=args.duration + 30)
    res = {"n": report.n_requests, "violations": report.n_violations,
           "violation_rate": report.violation_rate,
           "p50": report.p50, "p99": report.p99,
           "decisions": len(report.decisions or ()),
           "instances": len(server.pool)}
    print(json.dumps(res, indent=1, default=float))
    return res


def run_scenario_mode(args) -> dict:
    if args.policy != "sponge":
        raise SystemExit("the token engine runs the sponge policy only "
                         f"(got --policy {args.policy!r})")
    if args.duration is not None:
        raise SystemExit("the token engine sizes the run by --requests, "
                         "not --duration")
    report, stats = run_token_scenario(
        args.scenario, requests=args.requests or 24, seed=args.seed,
        arch=args.arch, prompt_len=args.prompt_len,
        max_decode=args.gen_tokens, rps=args.rps, device=args.device)
    ev = stats["events"]
    dt = stats["run_wall_s"]
    out = {"scenario": args.scenario, "engine": stats["engine"],
           "device": stats["device"], "policy": report.policy,
           "n": report.n_requests, "violation_rate": report.violation_rate,
           "p50": report.p50, "p99": report.p99,
           "avg_cores": report.avg_cores,
           "events": ev, "events_per_s": ev / max(dt, 1e-9), "wall_s": dt,
           "tokens_served": report.tokens_served,
           "tokens_per_s": report.tokens_per_s,
           "ttft_p50": report.ttft_p50, "ttft_p99": report.ttft_p99,
           "tbt_violation_rate": report.tbt_violation_rate}
    print(json.dumps(out, indent=1, default=float))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "live", "scenario"),
                    default="sim")
    scenario_help = "; ".join(f"{k}: {v}" for k, v in
                              list_scenarios().items()).replace("%", "%%")
    ap.add_argument("--scenario", default=None,
                    help=f"token scenario to serve ({scenario_help})")
    ap.add_argument("--engine", choices=("torch",), default="torch",
                    help="scenario mode: the real-kernel TokenTorchBackend")
    ap.add_argument("--requests", type=int, default=None,
                    help="scenario mode: size the run by request count "
                         "(default 24)")
    ap.add_argument("--arch", default="smollm-135m-reduced",
                    help="a registered arch id (smollm-135m, smollm-360m, "
                         "gemma-2b, h2o-danube-1.8b, rwkv6-1.6b, "
                         "zamba2-2.7b, or any of them with -reduced)")
    ap.add_argument("--policy", default="sponge",
                    help="live mode: sponge, fa2 or static-<cores>")
    # None = "use the mode's default" (the token scenario carries its own
    # rps; sim/live keep the reference's 20 rps / 600 s)
    ap.add_argument("--rps", type=float, default=None)
    ap.add_argument("--slo", type=float, default=1.0)
    ap.add_argument("--size-kb", type=float, default=200.0)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="live and scenario modes: torch device (default: "
                         "cuda; 'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.scenario or args.mode == "scenario":
        if not args.scenario:
            ap.error("--mode scenario requires --scenario <name>")
        return run_scenario_mode(args)
    args.rps = 20.0 if args.rps is None else args.rps
    args.duration = 600.0 if args.duration is None else args.duration
    if args.mode == "sim":
        return run_sim(args)
    return run_live(args)


if __name__ == "__main__":
    main()
