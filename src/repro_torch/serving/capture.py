"""One step-table entry captured as a CUDA graph: ``CapturedStep``.

The reference compiles every ``(c, b)`` entry of its step tables with
``jax.jit`` at warm-up, so that serving calls a ready executable.  The
port's counterpart is a CUDA graph per entry.  The entry's first call
(the warm-up) runs its step eagerly, which does the first call's host
work (the kernels' build, their shared-memory opt-ins and the SM-count
read, PyTorch's lazy device constants and cuBLAS handles) and is that
call's result, then runs it once more under ``torch.cuda.graph``, which
records every launch without running any: a step that updates state in
place (a decode step advancing its cache) advances it once per call.
Every later call copies its inputs into the entry's static input
tensors and replays the graph: one launch from the host for the whole
step.

A step that a graph can hold reads nothing back to the host and takes
its inputs only from the static tensors it is given (the model keeps
its cache index on the device for this).  Its outputs are the tensors
the captured run returned, in the graph's private memory pool: each
replay writes them again, so a caller that keeps one past the next call
copies it.

The step's counts (``utils/counters.py``: the kernels' launches,
counted by their launcher in ``kernels/build.py``, and the other counts,
such as ``ssd_scan``'s launches by body and published Zamba2's
shared-block applications) are kept by Python code, and a replay runs
none.  The capture therefore records each count's increase (what the
graph holds), takes it back (the capture ran nothing), and adds it again
on every replay, so a count still says how many times the card ran it.  With a trace, each call
marks what it added to the counts other than launches
(``sponge.step_counts``).

On the CPU there is nothing to capture: the step runs eagerly on every
call, as it does on the card when the caller asks for ``capture=False``
(the comparison route).  On the card with capture on, a failed capture
raises; the entry never carries on eagerly.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels.build import SOURCES
from repro_torch.serving.trace import span
from repro_torch.utils import counters


def _launches(counts: Dict[str, int]) -> Dict[str, int]:
    return {k: n for k, n in counts.items() if k in SOURCES}


def _others(counts: Dict[str, int]) -> Dict[str, int]:
    return {k: n for k, n in counts.items() if k not in SOURCES}


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch count so far."""
    return _launches(counters.read())


def event_counts() -> Dict[str, int]:
    """Every other count so far (``utils/counters.py``)."""
    return _others(counters.read())


class CapturedStep:
    """A step ``body()`` over the static tensors ``inputs``, captured as
    a CUDA graph at its first call when ``capture`` (the default on a
    CUDA device), else run eagerly on every call.

    ``step(*args)`` copies each argument into its static input (an
    argument that is that static tensor itself is not copied), runs the
    step (the first call, eagerly) or replays its graph, and returns its
    outputs.  ``replays`` counts the graph's replays and ``counts``
    holds what one replay adds to each count (``utils/counters.py``):
    ``deltas`` its kernel launches, ``events`` the rest.  With a
    ``trace`` (``serving/trace.py``) the copy of the arguments is the
    span ``sponge.copy_in``, each replay the span ``sponge.replay``, and
    each call that added to ``event_counts`` marks ``sponge.step_counts``
    with what it added.
    """

    trace = None

    def __init__(self, body: Callable[[], Any],
                 inputs: Sequence[torch.Tensor],
                 capture: Optional[bool] = None):
        self.body = body
        self.inputs = tuple(inputs)
        self.device = self.inputs[0].device
        self.capture = (self.device.type == "cuda" if capture is None
                        else capture)
        if self.capture and self.device.type != "cuda":
            raise ValueError(f"no CUDA graph on device {self.device}")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.counts: Dict[str, int] = {}
        self.replays = 0

    @property
    def deltas(self) -> Dict[str, int]:
        return _launches(self.counts)

    @property
    def events(self) -> Dict[str, int]:
        return _others(self.counts)

    def _capture(self) -> None:
        """Record the step's launches into the graph (runs nothing)."""
        graph = torch.cuda.CUDAGraph()
        before = counters.read()
        with torch.cuda.graph(graph):
            outputs = self.body()
        self.counts = counters.delta(counters.read(), before)
        counters.add(self.counts, -1)           # the capture ran nothing
        self.graph, self.outputs = graph, outputs

    def _eager(self) -> Any:
        """One eager run of the step (marking its counts when traced)."""
        if self.trace is None:
            return self.body()
        before = counters.read()
        outputs = self.body()
        self._mark(counters.delta(counters.read(), before))
        return outputs

    def _mark(self, counts: Dict[str, int]) -> None:
        events = None if self.trace is None else _others(counts)
        if events:
            self.trace.mark("step_counts", **events)

    @torch.inference_mode()
    def __call__(self, *args) -> Any:
        if len(args) != len(self.inputs):
            raise TypeError(f"{len(self.inputs)} inputs expected, got "
                            f"{len(args)}")
        with span(self.trace, "copy_in"):
            for dst, src in zip(self.inputs, args):
                if src is not dst:
                    dst.copy_(torch.as_tensor(src))
        if not self.capture:
            return self._eager()
        if self.graph is None:
            outputs = self._eager()             # the warm-up, eagerly
            self._capture()
            return outputs
        with span(self.trace, "replay"):
            self.graph.replay()
        self.replays += 1
        counters.add(self.counts)
        self._mark(self.counts)
        return self.outputs


def table_replays(*tables: Dict[Any, Callable]) -> int:
    """Graph replays of the distinct entries of step tables whose
    functions carry their :class:`CapturedStep` as ``.step`` (the tables
    of ``build_token_step_fns`` and ``build_llm_step_fns``)."""
    steps = {id(fn.step): fn.step for table in tables
             for fn in table.values()}
    return sum(step.replays for step in steps.values())
