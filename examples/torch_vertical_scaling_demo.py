"""In-place vertical scaling under a live bandwidth squeeze, on the
PyTorch port (``examples/vertical_scaling_demo.py`` with ``repro_torch``
for ``repro``).

Simulates a network fade mid-run and shows the scaler reacting within one
adaptation interval (vs a 10 s horizontal cold start), printing the (c, b)
trajectory and per-request outcomes — all through the unified serving API.
NumPy only, no device.

    PYTHONPATH=src python examples/torch_vertical_scaling_demo.py
"""
import numpy as np

from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.slo import Request
from repro_torch.serving.api import make_sim_server

perf = yolov5s_like()
server = make_sim_server(perf, "sponge", c0=12, prior_rps=20.0)

# 60 s of traffic; the network fades hard between t=20 and t=30
reqs = []
rng = np.random.default_rng(0)
for i in range(20 * 60):
    ts = i / 20.0
    cl = 0.55 if 20 <= ts < 30 else 0.08
    reqs.append(Request.make(arrival=ts + cl, comm_latency=cl, slo=1.0))
res = server.run(reqs, horizon=70)

print("time  ->  (cores, batch) decisions around the fade:")
for t, d in res.decisions:
    if 16 <= t <= 34 and int(t) == t:
        marker = " <= fade" if 20 <= t < 30 else ""
        print(f"  t={t:5.1f}s  c={d.c:2d}  b={d.b:2d}  "
              f"feasible={d.feasible}{marker}")
inst = server.pool[0].instance
print(f"\nresizes: {len(inst.resizes)}; "
      f"violations: {res['n_violations']}/{res['n_requests']} "
      f"({res['violation_rate']*100:.2f}%)")
print(f"avg allocated cores: {res['avg_cores']:.1f} "
      f"(static worst-case would hold 16 throughout)")
