"""One run of a cell: the port's serving stack under an open loop on the
wall clock, then the check of what it served.

The stack is built as a user builds it:
``make_token_live_server(cfg, ..., clock="measured", params=<the
benchmark's weights>, prior_rps=<the offered rate>)`` and
``runner.session()``.  Every request of the window is submitted up front
onto the session's pending heap with its arrival (send + comm latency);
then the loop calls ``session.step_until(<wall seconds since the window
opened>)`` and sleeps only when nothing is due.  A gang blocks the loop
while it runs, so a stall delays every later request, and idle time is
real.  In a traced run the clock stops while the profiler starts and
while it collects the slice (``trace.Tracer.due``).

The harness times every request from outside the program.  It wraps
``execute`` on the backend instance it built (the program is not
edited) and reads the ``TimedExecutor.calls`` each gang added: a
request's first token is at the end of its gang's prefill call, and
its k-th streamed token at the end of the gang's k-th decode call
(each call ends once the device has finished).  After the window it
sends nothing more and lets the requests sent in it finish, for at most
``DRAIN_S`` seconds, or until the session holds none that it has not
dispatched; one that got no tokens then has failed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np

from perfbench.harness import spec, traffic, weights
from perfbench.harness.trace import Tracer, span

DRAIN_S = 60.0          # a request sent in the window may finish this late
TRACE_S = 3.0           # the traced slice: the window's last seconds
MAX_SLEEP_S = 0.05


@dataclasses.dataclass
class Gang:
    """One dispatch: its requests (indices into the window's list) and the
    walls of its step calls, in seconds since the window opened."""
    dispatch: float
    b: int
    reqs: List[int]
    prefill: tuple              # (start, wall)
    decode: List[tuple]         # (start, wall) per decode call
    traced: bool


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""
    cell: str
    conf: dict
    mix: dict
    seconds: float
    reqs: List[traffic.Req]
    gangs: List[Gang]
    tokens: Dict[int, List[float]]      # request -> wall of each token
    dispatch: Dict[int, float]          # request -> its gang's dispatch
    setup_s: float
    lateness: List[float]               # how late each arrival was seen
    trace: Optional[dict] = None

    def in_window(self, gang: Gang) -> bool:
        return gang.dispatch < self.seconds


class _Spanned:
    """A step table with a host span around each call (traced runs)."""

    def __init__(self, table, name: str, tracer: Tracer):
        self._table, self._name, self._tracer = table, name, tracer

    def __call__(self, *args):
        with span(self._name, self._tracer.active):
            return self._table(*args)

    def __getattr__(self, key):
        return getattr(self._table, key)


def build_config(conf: dict):
    """The program's ModelConfig of a configuration file."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(conf["registry_id"]),
                               **spec.model_fields(conf))


def _next_due(sess) -> float:
    """The session's next event: a pending arrival, a tick or a wake-up
    (``ExactSession``'s heaps, read and left as they are)."""
    due = [sess._next_tick]
    if sess._pending:
        due.append(sess._pending[0][0])
    if sess._events:
        due.append(sess._events[0][0])
    return min(due)


def build_stack(conf: dict, mix: dict, family, seed: int, device="cuda"):
    """The weights of ``seed`` and the port's serving stack over them:
    ``(runner, backend, tree)``."""
    import torch

    from repro_torch.kernels import build as kernel_build
    from repro_torch.serving.token_backend import make_token_live_server

    if str(device).startswith("cuda"):
        kernel_build.build()            # every source at once, if not built
    tree = weights.draw(family.param_layout(conf), seed,
                        getattr(torch, conf["param_dtype"]), device)
    runner, backend, _, _ = make_token_live_server(
        build_config(conf), c_set=tuple(mix["c_set"]),
        b_set=tuple(mix["b_set"]), prompt_len=mix["bucket"],
        max_decode=mix["max_decode"], clock="measured", tick=mix["tick_s"],
        prior_rps=mix["rate_rps"], params=weights.program_params(tree),
        device=device)
    return runner, backend, tree


def window(cell: str, conf: dict, mix: dict, runner, backend, reqs,
           seconds: float, trace: bool, setup_s: float):
    """The open loop over ``reqs`` and the drain (module docstring).
    Returns the ``Run`` and the program's generated ids by request."""
    from repro_torch.core.slo import Request

    tracer = Tracer(trace)
    backend.pre_table = _Spanned(backend.pre_table, "program.prefill", tracer)
    backend.dec_table = _Spanned(backend.dec_table, "program.decode", tracer)
    sess = runner.session()
    index_of: Dict[int, int] = {}
    for r in reqs:
        q = Request.make(arrival=r.arrival, comm_latency=r.comm_latency,
                         slo=r.ttft_slo, size_kb=r.size_kb,
                         prompt_tokens=r.prompt_tokens,
                         decode_tokens=r.decode_tokens, tbt_slo=r.tbt_slo)
        index_of[q.id] = r.index
        sess.submit(q, payload=r.prompt)

    gangs: List[Gang] = []
    generated: Dict[int, List[int]] = {}
    original = backend.execute

    def execute(batch, c, b, now):
        n_pre = len(backend.pre_table.calls)
        n_dec = len(backend.dec_table.calls)
        t_disp = time.perf_counter() - t_open
        with span("program.execute", tracer.active):
            fin = original(batch, c, b, now)
        pre = backend.pre_table.calls[n_pre:]
        dec = backend.dec_table.calls[n_dec:]
        ids = [index_of[r.id] for r in batch]
        for r, i in zip(batch, ids):
            generated[i] = list(backend.generated[r.id])
        gangs.append(Gang(t_disp, b, ids,
                          (pre[0][0] - t_open, pre[0][3]),
                          [(t0 - t_open, dt) for t0, _, _, dt in dec],
                          tracer.active))
        return fin

    backend.execute = execute
    calls = []
    t_open = time.perf_counter()
    while True:
        now = time.perf_counter() - t_open
        held = tracer.due(now, seconds - TRACE_S, TRACE_S)
        if held:
            # the window's clock stops while the profiler starts or
            # collects: that time is the trace's, not the session's
            t_open += held
            now -= held
        calls.append(now)
        with span("harness.step_until", tracer.active):
            sess.step_until(now)
        idle = not sess._pending and not len(runner.queue)
        if len(generated) >= len(reqs) or idle or now >= seconds + DRAIN_S:
            break
        wait = _next_due(sess) - (time.perf_counter() - t_open)
        if wait > 0:
            with span("harness.sleep", tracer.active):
                time.sleep(min(wait, MAX_SLEEP_S))
    backend.execute = original

    tokens: Dict[int, List[float]] = {}
    dispatch: Dict[int, float] = {}
    for g in gangs:
        for i in g.reqs:
            n = reqs[i].decode_tokens
            tokens[i] = [g.prefill[0] + g.prefill[1]] + [
                t0 + dt for t0, dt in g.decode[:n]]
            dispatch[i] = g.dispatch
    calls = np.asarray(calls)
    lateness = [float(calls[np.searchsorted(calls, r.arrival)] - r.arrival)
                for r in reqs if r.arrival <= calls[-1]]
    run = Run(cell, conf, mix, seconds, reqs, gangs, tokens, dispatch,
              setup_s, lateness, tracer.digest())
    return run, generated


def serve(cell: str, conf: dict, mix: dict, family, seed: int,
          seconds: float, trace: bool, t_start: float, device="cuda"):
    """Build the stack, run the window and the drain.  Returns the
    ``Run``, the weights' tree, the program's generated ids by request
    and the peak device memory; the program's state is freed."""
    import torch

    on_card = str(device).startswith("cuda")
    runner, backend, tree = build_stack(conf, mix, family, seed, device)
    reqs = traffic.generate(mix, seed, seconds, conf["vocab_size"])
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    run, generated = window(cell, conf, mix, runner, backend, reqs, seconds,
                            trace, setup_s)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del runner, backend
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return run, tree, generated, peak
