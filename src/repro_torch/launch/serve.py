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
* ``--scenario <name>`` (or ``--mode scenario``) -- a registered
  scenario.  ``--engine fast`` runs it on the struct-of-arrays fast
  engine and ``--engine exact`` on the object-based exact engine
  (``serving.scenarios.run_scenario``; NumPy only, no device): the
  session scenarios (``slo-renegotiation``, ``cancel-storm``) through
  the online session API (``--no-mid-flight`` replays them without
  their update/cancel stream), the token scenarios on
  ``TokenFastSimRunner`` / ``TokenSimBackend`` (``--admission-quantile``
  and ``--no-speculative`` steer the decode-length-aware ones).
  ``--engine torch`` serves a token scenario on the real kernels through
  ``TokenTorchBackend``.  The default is ``torch`` for token scenarios
  and ``fast`` for the rest; ``--engine vector`` is refused (not ported
  yet).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode sim --duration 600
    PYTHONPATH=src python -m repro_torch.launch.serve --mode live \\
        --arch smollm-135m --rps 10 --duration 6 --prompt-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario llm-chat \\
        --arch smollm-135m --requests 48 --prompt-len 256 --gen-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario steady \\
        --duration 60                           # the fast engine
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --scenario slo-renegotiation --engine exact --duration 60

``--arch`` takes any id of ``repro_torch.configs.registry`` that serves
prompts of token ids (``smollm-135m``, ``smollm-360m``, ``gemma-2b``,
``h2o-danube-1.8b``, ``rwkv6-1.6b``, ``zamba2-2.7b``, and their
``-reduced`` cuts).  ``qwen2-vl-2b`` and ``whisper-large-v3`` need
patch or frame embeddings beside the tokens and run through the model
API (``models.build_model``) only, as in the reference, whose serving
backends feed tokens alone.
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
from repro_torch.serving.scenarios import (ENGINES, build_scenario,
                                           check_engine, list_scenarios,
                                           run_scenario)
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
    q = args.admission_quantile
    if q is not None and not (q == 0.0 or 0.0 < q < 1.0):
        raise SystemExit("--admission-quantile must be in [0, 1) "
                         f"(0 disables the uncertainty path), got {q}")
    if args.engine is None:
        _, meta = build_scenario(args.scenario, duration=1.0)
        args.engine = "torch" if meta.get("token") else "fast"
    if args.engine == "torch":
        if q is not None or args.no_speculative:
            raise SystemExit("--admission-quantile/--no-speculative run "
                             "on the fast/exact token engines, not "
                             "--engine torch")
        if args.policy != "sponge":
            raise SystemExit("--engine torch runs the sponge policy only "
                             f"(got --policy {args.policy!r})")
        if args.duration is not None:
            raise SystemExit("--engine torch sizes the run by --requests, "
                             "not --duration")
        report, stats = run_token_scenario(
            args.scenario, requests=args.requests or 24, seed=args.seed,
            arch=args.arch, prompt_len=args.prompt_len,
            max_decode=args.gen_tokens, rps=args.rps, device=args.device)
    else:
        try:
            check_engine(args.engine)
        except ValueError as e:
            raise SystemExit(str(e))
        report, stats = run_scenario(
            args.scenario, policy=args.policy, engine=args.engine,
            duration=args.duration, rps=args.rps, seed=args.seed,
            requests=args.requests, mid_flight=not args.no_mid_flight,
            admission_quantile=q, speculative=not args.no_speculative)
    ev = stats["events"]
    dt = stats["run_wall_s"]            # engine time only (no generation)
    out = {"scenario": args.scenario, "engine": stats["engine"],
           "policy": report.policy, "n": report.n_requests,
           "violation_rate": report.violation_rate,
           "p50": report.p50, "p99": report.p99,
           "avg_cores": report.avg_cores,
           "events": ev, "events_per_s": ev / max(dt, 1e-9), "wall_s": dt}
    if "device" in stats:
        out["device"] = stats["device"]
    if report.tokens_served:            # token scenarios
        out.update(tokens_served=report.tokens_served,
                   tokens_per_s=report.tokens_per_s,
                   ttft_p50=report.ttft_p50, ttft_p99=report.ttft_p99,
                   tbt_violation_rate=report.tbt_violation_rate)
    if "session" in stats:              # session scenarios
        out.update(n_cancelled=report.n_cancelled, **{
            f"mid_flight_{k}": v for k, v in stats["session"].items()})
    if "uncertainty" in stats:          # distribution-aware runs
        u = stats["uncertainty"]
        out.update(n_cancelled=report.n_cancelled,
                   admission_quantile=u["quantile"],
                   slack_factor=u["slack_factor"],
                   calibration_error=u["calibration_error"],
                   overrun_cancels=u["overrun_cancels"])
    if "solver" in stats:
        out["solver_hit_rate"] = stats["solver"].get("hit_rate")
    print(json.dumps(out, indent=1, default=float))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "live", "scenario"),
                    default="sim")
    scenario_help = "; ".join(f"{k}: {v}" for k, v in
                              list_scenarios().items()).replace("%", "%%")
    ap.add_argument("--scenario", default=None,
                    help=f"run a registered scenario ({scenario_help})")
    ap.add_argument("--engine", choices=ENGINES + ("vector", "torch"),
                    default=None,
                    help="scenario mode: the struct-of-arrays fast engine "
                         "or the object-based exact engine (NumPy, no "
                         "device), or, for token scenarios, the "
                         "real-kernel TokenTorchBackend (default: torch "
                         "for token scenarios, fast otherwise); vector is "
                         "not ported yet and is refused")
    ap.add_argument("--requests", type=int, default=None,
                    help="scenario mode: size the run by request count "
                         "(--engine torch: default 24)")
    ap.add_argument("--no-mid-flight", action="store_true",
                    help="session scenarios: suppress the mid-flight "
                         "update_slo/cancel stream (the closed-world "
                         "replay of the same workload)")
    ap.add_argument("--admission-quantile", type=float, default=None,
                    help="token scenarios with a declared decode-length "
                         "distribution, fast/exact engine: plan admission at "
                         "this quantile (0 disables the uncertainty path "
                         "-- the deterministic-cost baseline; default: "
                         "the scenario's own quantile)")
    ap.add_argument("--no-speculative", action="store_true",
                    help="distribution-aware runs: disable speculative "
                         "over-admission with cancel-on-overrun (streams "
                         "run to completion; the solver still plans at "
                         "the admission quantile)")
    ap.add_argument("--arch", default="smollm-135m-reduced",
                    help="a registered arch id (smollm-135m, smollm-360m, "
                         "gemma-2b, h2o-danube-1.8b, rwkv6-1.6b, "
                         "zamba2-2.7b, or any of them with -reduced)")
    ap.add_argument("--policy", default="sponge",
                    help="live mode and the fast/exact engines: sponge, "
                         "sponge-pred (exact engine), fa2 or "
                         "static-<cores>")
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
