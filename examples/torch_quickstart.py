"""Quickstart on the PyTorch port: the unified Sponge serving API in ~40
lines (``examples/quickstart.py`` with ``repro_torch`` for ``repro``).

Builds the paper's performance model, composes a SpongeServer (policy +
backend + runner), submits requests whose network latency ate part of the
SLO, and watches the scaler pick (cores, batch) via the Integer Program
(Algorithm 1) while the runner serves them.  NumPy only, no device.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core.perf_model import fit_table1
from repro_torch.core.slo import Request
from repro_torch.serving.api import make_sim_server

# 1. performance model l(b, c) fitted on the paper's Table 1 measurements
perf = fit_table1()
print(f"l(b=4, c=8) = {perf.latency(4, 8)*1e3:.1f} ms "
      f"(paper measured: 37 ms)")

# 2. one call wires the whole control plane: IP-solver policy + simulated
#    execution backend + the event-loop runner
server = make_sim_server(perf, "sponge", c0=1, prior_rps=100.0)

# 3. requests whose network latency ate part of the end-to-end SLO — the
#    dynamic-SLO quantity the scaler must react to
reqs = [Request.make(arrival=0.0, comm_latency=cl, slo=1.0)
        for cl in (0.05, 0.30, 0.60, 0.12, 0.45)]
print(f"remaining budgets: {[round(r.slo - r.comm_latency, 2) for r in reqs]}")

# 4. run the scenario; the runner feeds the EDF queue, the scaler solves
#    the IP each adaptation interval, the backend applies the in-place
#    vertical resize (no cold start) and executes batches
report = server.run(reqs, horizon=5.0)

t0, first = report.decisions[0]
print(f"first decision: c={first.c} cores, b={first.b}, "
      f"feasible={first.feasible} "
      f"({first.solver_iters} IP iterations, {first.solver_time*1e6:.0f} us)")
inst = server.pool[0].instance
print(f"in-place resizes applied: "
      f"{[(e.c_from, e.c_to) for e in inst.resizes]} "
      f"(penalty {inst.resize_penalty*1e3:.1f} ms each; "
      f"a horizontal cold start is ~10 s)")
print(f"served {report.n_requests} requests, "
      f"violations={report.n_violations}, p99={report.p99*1e3:.0f} ms, "
      f"core-seconds={report.core_seconds:.2f}")
