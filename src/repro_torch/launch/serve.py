"""Serving launcher: a registered token scenario on the Hopper kernels.

Counterpart of the token-scenario branch of ``repro.launch.serve``
(``--scenario <token scenario> --engine jax``), under the same argument
names; the other modes of the reference launcher are still to be ported
(ROADMAP.md).  Runs on ``cuda`` unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.serve --scenario llm-chat \\
        --arch smollm-135m --requests 48 --prompt-len 256 --gen-tokens 64

``--arch`` takes any id of ``repro_torch.configs.registry`` (``smollm-135m``,
``rwkv6-1.6b``, ``zamba2-2.7b``, and their ``-reduced`` cuts).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.serving.scenarios import list_scenarios
from repro_torch.serving.token_backend import run_token_scenario


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
    scenario_help = "; ".join(f"{k}: {v}" for k, v in
                              list_scenarios().items()).replace("%", "%%")
    ap.add_argument("--scenario", required=True,
                    help=f"token scenario to serve ({scenario_help})")
    ap.add_argument("--engine", choices=("torch",), default="torch",
                    help="the real-kernel TokenTorchBackend")
    ap.add_argument("--requests", type=int, default=None,
                    help="size the run by request count (default 24)")
    ap.add_argument("--arch", default="smollm-135m-reduced",
                    help="a registered arch id (smollm-135m, rwkv6-1.6b, "
                         "zamba2-2.7b, or any of them with -reduced)")
    ap.add_argument("--policy", default="sponge")
    ap.add_argument("--rps", type=float, default=None)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    return run_scenario_mode(ap.parse_args(argv))


if __name__ == "__main__":
    main()
