"""The decode-stream scan engine: chunks of integer steps on the card.

Copy of ``repro.serving.scanpath``.  ``TokenFastSimRunner`` steps its
continuous-batching decode stream one engine step at a time in Python.
This module re-expresses that step loop as a **pure** ``state -> state``
function over fixed-size arrays and runs it in chunks of ``K`` steps:

* ``backend="torch"`` -- the counterpart of the reference's
  ``jax.jit`` of a ``lax.scan``: the state lives in static device
  buffers, and one chunk of ``K`` steps (``_step_torch``, about 30
  element-wise ops and reductions each) is captured as a CUDA graph on
  its first call (``serving.capture.CapturedStep``) and replayed for
  every later chunk, so a chunk costs one launch from the host.  The
  knobs ``(a_p, a_d, b0, cap, allow)`` are 0-dim views of one device
  tensor, written in place before each replay (the reference's 0-d
  arrays, which avoid a retrace).  Runs on ``cuda`` unless ``device``
  names another (the CPU runs the same ops eagerly);
* ``backend="numpy"`` -- the plain version: ``_step(np, ...)`` in a
  Python loop, the reference's NumPy backend term for term.

Model (a deliberately simplified decode stream, documented rather than
bit-matched to ``TokenFastSimRunner``):

* state lives in dense request-indexed arrays over the
  **deadline-presorted** workload -- join and leave are masked writes,
  never compaction;
* per step, admission is EDF among arrived un-admitted requests:
  ``rank = cumsum(eligible)`` caps joins at the free slot count, and a
  second masked ``cumsum`` over prompt tokens enforces the prefill
  allowance with break-at-first-overflow prefix semantics (the head
  request always admits, so an oversized prompt runs over allowance
  instead of stalling the stream forever);
* step latency is the token cost model's composition surface quantized
  to **integer microseconds** (``dt = A_p·T + A_d·S + B``); all state
  is integer, so the backends compute *identical* values -- no float
  contraction or accumulation-order hazards.  NumPy and PyTorch both
  promote the int32 sums and cumsums to int64 (JAX keeps int32), so
  both compute in int64; the torch route writes ``first`` / ``fin``
  back to int32 buffers at the chunk's end, which keeps their values
  because ``run`` refuses a horizon at or past 2^31 µs;
* decisions (new ``(c, b)``) apply at **chunk boundaries**: the host
  reads ``t`` and ``done.all()`` once per chunk (and, with a ``decide``
  hook, the waiting and active counts, reduced on the device), re-derives
  the integer cost coefficients for the new ``c`` and writes the knobs.

Equivalence contract (``tests/test_torch_scanpath.py``, and phase
``engines`` of ``chip_smoke.py`` on the card): decision streams,
first-token / finish columns, per-request TBT-violation counts,
core-seconds and step counts are identical on both backends and equal
to the reference's NumPy and JAX backends.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import Composition, TokenCostModel
from repro_torch.models.api import resolve_device
from repro_torch.serving.capture import CapturedStep
from repro_torch.serving.workload import RequestBatch

_BIG = np.int32(2**31 - 2)


def _coefficients(cost: TokenCostModel, c: int) -> Tuple[int, int, int]:
    """Integer-µs step-latency coefficients at core count ``c``:
    ``dt_us = A_p·T + A_d·S + B`` for ``T`` prefill tokens and ``S``
    decode slots.  Derived host-side once per chunk, so both backends
    consume identical integers."""
    a_p = cost.gamma_p / c + cost.delta_p
    a_d = cost.gamma_d / c + cost.delta_d
    b = cost.eps / c + cost.eta
    return (int(round(a_p * 1e6)), int(round(a_d * 1e6)),
            int(round(b * 1e6)))


def _step(xp, state, cols, knobs):
    """One decode-stream engine step — pure, backend-agnostic (``xp``
    is ``numpy``).  All arithmetic is exact integer math."""
    t, adm, done, rem, first, fin, viol, nsteps = state
    arrival, ptok, tbt = cols
    a_p, a_d, b0, cap, allow = knobs
    i32 = xp.int32
    active = adm & ~done
    s_cnt = xp.sum(active.astype(i32))
    # EDF admission: arrays are deadline-presorted, so a masked cumsum
    # IS the earliest-deadline-first rank
    eligible = (arrival <= t) & ~adm
    rank = xp.cumsum(eligible.astype(i32))
    mask1 = eligible & (rank <= (cap - s_cnt))
    cumtok = xp.cumsum(xp.where(mask1, ptok, xp.int32(0)))
    # break at first overflow, but the head request always admits: an
    # oversized prompt must run (over allowance) rather than livelock
    # the idle-jump (next arrival already <= t, so time cannot advance)
    head1 = xp.cumsum(mask1.astype(i32)) == 1
    newly = mask1 & ((cumtok <= allow) | head1)
    t_cnt = xp.sum(xp.where(newly, ptok, xp.int32(0)))
    advance = (s_cnt + t_cnt) > 0
    dt = a_p * t_cnt + a_d * s_cnt + b0
    # idle: jump to the next un-admitted arrival (if any)
    na = xp.min(xp.where(~adm, arrival, _BIG))
    t_end = xp.where(advance, t + dt,
                     xp.where(xp.any(~adm), xp.maximum(t, na), t))
    adm = adm | newly
    first = xp.where(newly, t_end, first)
    rem = xp.where(active, rem - 1, rem)
    just_done = active & (rem <= 0)
    done = done | just_done
    fin = xp.where(just_done, t_end, fin)
    viol = viol + xp.where(active & (dt > tbt), xp.int32(1), xp.int32(0))
    nsteps = nsteps + xp.where(advance, xp.int32(1), xp.int32(0))
    return (t_end, adm, done, rem, first, fin, viol, nsteps)


def _step_torch(state, cols, knobs):
    """:func:`_step` in PyTorch, op for op: the same integer values
    (sums and cumsums promote to int64 as NumPy's do), no host read."""
    t, adm, done, rem, first, fin, viol, nsteps = state
    arrival, ptok, tbt = cols
    a_p, a_d, b0, cap, allow = knobs
    i32 = torch.int32
    active = adm & ~done
    s_cnt = torch.sum(active.to(i32))
    eligible = (arrival <= t) & ~adm
    rank = torch.cumsum(eligible.to(i32), 0)
    mask1 = eligible & (rank <= (cap - s_cnt))
    cumtok = torch.cumsum(torch.where(mask1, ptok, 0), 0)
    head1 = torch.cumsum(mask1.to(i32), 0) == 1
    newly = mask1 & ((cumtok <= allow) | head1)
    t_cnt = torch.sum(torch.where(newly, ptok, 0))
    advance = (s_cnt + t_cnt) > 0
    dt = a_p * t_cnt + a_d * s_cnt + b0
    na = torch.min(torch.where(~adm, arrival, int(_BIG)))
    t_end = torch.where(advance, t + dt,
                        torch.where(torch.any(~adm), torch.maximum(t, na),
                                    t))
    adm = adm | newly
    first = torch.where(newly, t_end, first)
    rem = torch.where(active, rem - 1, rem)
    just_done = active & (rem <= 0)
    done = done | just_done
    fin = torch.where(just_done, t_end, fin)
    viol = viol + torch.where(active & (dt > tbt), 1, 0)
    nsteps = nsteps + torch.where(advance, 1, 0)
    return (t_end, adm, done, rem, first, fin, viol, nsteps)


class _TorchChunk:
    """Static device buffers of one workload size and the chunk of
    ``k`` steps over them: captured as a CUDA graph at its first call on
    the card, eager on the CPU.  ``load`` writes a run's columns and
    initial state into the buffers; ``__call__`` writes the knobs and
    advances the state in place by ``k`` steps."""

    def __init__(self, n: int, k: int, device: torch.device):
        def z(dtype, shape=(n,)):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.n, self.k, self.device = n, k, device
        self.cols = (z(torch.int32), z(torch.int32), z(torch.int32))
        self.state = (z(torch.int64, ()), z(torch.bool), z(torch.bool),
                      z(torch.int32), z(torch.int32), z(torch.int32),
                      z(torch.int32), z(torch.int64, ()))
        self.knobs = z(torch.int64, (5,))
        self.step = CapturedStep(self._chunk, (self.knobs,))

    def _chunk(self) -> None:
        knobs = tuple(self.knobs.unbind())
        st = self.state
        for _ in range(self.k):
            st = _step_torch(st, self.cols, knobs)
        for buf, val in zip(self.state, st):
            buf.copy_(val)

    def load(self, cols, state) -> None:
        for buf, host in zip(self.cols + self.state, cols + state):
            buf.copy_(torch.as_tensor(host))

    def __call__(self, knobs) -> None:
        self.step(torch.tensor(knobs, dtype=torch.int64))   # one copy

    @property
    def replays(self) -> int:
        return self.step.replays

    def t_done(self) -> Tuple[int, bool]:
        """``t`` and ``done.all()``: one read from the device."""
        t, all_done = torch.stack(
            (self.state[0], self.state[2].all().to(torch.int64))).tolist()
        return t, bool(all_done)

    def counts(self) -> Tuple[int, int]:
        """Waiting (arrived, not admitted) and active requests at ``t``,
        reduced on the device: one read."""
        t, adm, done = self.state[:3]
        return tuple(torch.stack(
            (((self.cols[0] <= t) & ~adm).sum(),
             (adm & ~done).sum())).tolist())


class ScanDecodeEngine:
    """Chunked decode-stream simulator: ``K`` steps per chunk, decisions
    at chunk boundaries, identical results on the torch and NumPy
    backends.

    ``decide`` (optional) is called host-side at every chunk boundary
    with ``(t_seconds, n_waiting, n_active)`` and returns ``(c, b)``;
    the default holds ``(c0, b0)`` static.  Use
    :func:`make_sponge_decide` to adapt a ``SpongeScaler``."""

    def __init__(self, cost: TokenCostModel, *, c0: int = 8, b0: int = 8,
                 chunk_steps: int = 64,
                 prefill_allowance: int = 1 << 30,
                 decide: Optional[Callable] = None):
        self.cost = cost
        self.c0 = int(c0)
        self.b0 = int(b0)
        self.chunk_steps = int(chunk_steps)
        self.prefill_allowance = int(prefill_allowance)
        self.decide = decide
        self.decisions: List[tuple] = []
        self._torch_chunk: Optional[_TorchChunk] = None
        self.chunks = 0

    @property
    def replays(self) -> int:
        """Graph replays of the torch route's captured chunk so far."""
        return self._torch_chunk.replays if self._torch_chunk else 0

    # -- backends ----------------------------------------------------------
    def _chunk_numpy(self, state, cols, knobs):
        for _ in range(self.chunk_steps):
            state = _step(np, state, cols, knobs)
        return state

    def _chunk_for(self, n: int, device: torch.device) -> _TorchChunk:
        """The static buffers and captured chunk for ``n`` requests on
        ``device``, kept across runs of the same size (the counterpart
        of ``jax.jit``'s cache: a second run replays the same graph)."""
        ch = self._torch_chunk
        if ch is None or ch.n != n or ch.device != device:
            ch = self._torch_chunk = _TorchChunk(n, self.chunk_steps, device)
        return ch

    # -- entry point -------------------------------------------------------
    def run(self, batch: RequestBatch, horizon: Optional[float] = None,
            backend: str = "auto", device=None) -> dict:
        """Simulate the whole workload; returns a dict with per-request
        ``first_tok`` / ``finish`` (seconds, NaN if never served),
        ``tbt_violations`` counts, the decision stream, ``core_seconds``
        and ``steps``.  ``backend`` is ``auto`` (= ``torch``), ``torch``
        (on ``device``: ``cuda`` unless named; raises without a card) or
        ``numpy``, the plain version."""
        if backend == "auto":
            backend = "torch"
        if backend not in ("torch", "numpy"):
            raise ValueError(
                f"backend={backend!r}: the port runs backend='torch' "
                "(the card, or device='cpu') or 'numpy' (the plain "
                "version); the reference's 'jax' backend has no "
                "counterpart here")
        dev = resolve_device(device) if backend == "torch" else None
        n = len(batch)
        arrival = np.asarray(batch.arrival, np.float64)
        if horizon is None:
            horizon = (float(arrival[-1]) + 60.0) if n else 60.0
        if horizon * 1e6 >= 2**31:
            raise ValueError("scanpath is int32-µs; horizon must be "
                             "< ~2147 s")
        # deadline-presorted request space (EDF admission by cumsum)
        dl = np.asarray(batch.deadline, np.float64)
        order = np.argsort(dl, kind="stable")
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)

        def us(x):
            return np.asarray(np.round(np.asarray(x, np.float64) * 1e6),
                              np.int32)
        cols = (us(arrival[order]),
                np.maximum(np.asarray(batch.prompt_tokens,
                                      np.int64)[order], 1).astype(np.int32),
                np.minimum(np.asarray(batch.tbt_slo,
                                      np.float64)[order] * 1e6,
                           float(_BIG)).astype(np.int32))
        rem0 = np.maximum(np.asarray(batch.decode_tokens,
                                     np.int64)[order], 1).astype(np.int32)
        state = (np.int32(0),
                 np.zeros(n, bool), np.zeros(n, bool), rem0,
                 np.full(n, -1, np.int32), np.full(n, -1, np.int32),
                 np.zeros(n, np.int32), np.int32(0))
        c, b = self.c0, self.b0
        self.decisions = []
        self.chunks = 0
        horizon_us = int(horizon * 1e6)
        core_us = 0
        if backend == "numpy":
            while True:
                t_us = int(np.asarray(state[0]))
                done = np.asarray(state[2])
                if t_us >= horizon_us or bool(done.all()):
                    break
                if self.decide is not None:
                    adm = np.asarray(state[1])
                    arrived = np.asarray(cols[0]) <= t_us
                    c, b = self.decide(t_us / 1e6,
                                       int((arrived & ~adm).sum()),
                                       int((adm & ~done).sum()))
                self.decisions.append((t_us / 1e6, int(c), int(b)))
                a_p, a_d, b_us = _coefficients(self.cost, c)
                knobs = (np.int32(a_p), np.int32(a_d), np.int32(b_us),
                         np.int32(b), np.int32(self.prefill_allowance))
                state = self._chunk_numpy(state, cols, knobs)
                self.chunks += 1
                t_end = min(int(np.asarray(state[0])), horizon_us)
                core_us += c * max(t_end - t_us, 0)
            first, fin, viol, steps = state[4], state[5], state[6], state[7]
        else:
            ch = self._chunk_for(n, dev)
            ch.load(cols, state)
            t_us, all_done = (0, n == 0)
            while not (t_us >= horizon_us or all_done):
                if self.decide is not None:
                    waiting, active = ch.counts()
                    c, b = self.decide(t_us / 1e6, waiting, active)
                self.decisions.append((t_us / 1e6, int(c), int(b)))
                a_p, a_d, b_us = _coefficients(self.cost, c)
                ch((a_p, a_d, b_us, b, self.prefill_allowance))
                self.chunks += 1
                t_next, all_done = ch.t_done()
                core_us += c * max(min(t_next, horizon_us) - t_us, 0)
                t_us = t_next
            first, fin, viol, steps = (x.cpu().numpy()
                                       for x in ch.state[4:])
        first = np.asarray(first, np.int64)[inv]
        fin = np.asarray(fin, np.int64)[inv]
        viol = np.asarray(viol, np.int64)[inv]
        to_s = lambda col: np.where(col >= 0, col / 1e6, np.nan)
        return {"backend": backend,
                "first_tok": to_s(first), "finish": to_s(fin),
                "tbt_violations": viol,
                "decisions": list(self.decisions),
                "core_seconds": core_us / 1e6,
                "steps": int(np.asarray(steps)),
                "n_served": int((fin >= 0).sum())}


def make_sponge_decide(scaler, cost: TokenCostModel,
                       c_set, b_set) -> Callable:
    """Adapt a queue-pressure heuristic over the solver's ``(c, b)``
    grid for chunk-boundary decisions: pick the smallest core count
    whose projected step latency clears the busiest slot cap.  (A
    deliberately simple stand-in for the IP solver — chunk boundaries
    are coarse, and the engine's contract is backend parity, not
    solver fidelity.)"""
    c_set = sorted(c_set)
    b_set = sorted(b_set)

    def decide(t_s: float, n_waiting: int, n_active: int):
        want = n_waiting + n_active
        b = next((bb for bb in b_set if bb >= want), b_set[-1])
        for c in c_set:
            if cost.step_latency(c, Composition(0, b)) <= getattr(
                    scaler, "target_step_latency", 0.1):
                return c, b
        return c_set[-1], b
    return decide
