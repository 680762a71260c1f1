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

The kernels' Python launch counters count calls of their wrappers, and
a replay calls none.  The capture therefore records each counter's
increase (the launches the graph holds), takes it back (the capture ran
no kernel), and adds it again on every replay, so a count still says
how many times the card ran the kernel.

On the CPU there is nothing to capture: the step runs eagerly on every
call, as it does on the card when the caller asks for ``capture=False``
(the comparison route).  On the card with capture on, a failed capture
raises; the entry never carries on eagerly.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels.add_rms_norm import ops as _norm
from repro_torch.kernels.decode_attention import ops as _dec
from repro_torch.kernels.glu_gate import ops as _gate
from repro_torch.kernels.rope_kv_write import ops as _rope
from repro_torch.kernels.rwkv6_scan import ops as _wkv
from repro_torch.kernels.ssd_scan import ops as _ssd
from repro_torch.kernels.swa_prefill import ops as _pre
from repro_torch.serving.trace import span

# every kernel wrapper's module, by kernel name (each keeps ``launches``)
KERNELS = {"swa_prefill": _pre, "decode_attention": _dec,
           "rwkv6_scan": _wkv, "ssd_scan": _ssd, "add_rms_norm": _norm,
           "rope_kv_write": _rope, "glu_gate": _gate}


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch count so far."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    for name, n in delta.items():
        KERNELS[name].launches += sign * n


class CapturedStep:
    """A step ``body()`` over the static tensors ``inputs``, captured as
    a CUDA graph at its first call when ``capture`` (the default on a
    CUDA device), else run eagerly on every call.

    ``step(*args)`` copies each argument into its static input (an
    argument that is that static tensor itself is not copied), runs the
    step (the first call, eagerly) or replays its graph, and returns its
    outputs.  ``replays`` counts the graph's replays and ``deltas`` holds
    the kernel launches one replay makes.  With a ``trace``
    (``serving/trace.py``) the copy of the arguments is the span
    ``sponge.copy_in`` and each replay the span ``sponge.replay``.
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
        self.deltas: Dict[str, int] = {}
        self.replays = 0

    def _capture(self) -> None:
        """Record the step's launches into the graph (runs nothing)."""
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph):
            outputs = self.body()
        after = launch_counts()
        self.deltas = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
        _add_launches(self.deltas, -1)          # the capture ran nothing
        self.graph, self.outputs = graph, outputs

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
            return self.body()
        if self.graph is None:
            outputs = self.body()               # the warm-up, eagerly
            self._capture()
            return outputs
        with span(self.trace, "replay"):
            self.graph.replay()
        self.replays += 1
        _add_launches(self.deltas)
        return self.outputs


def table_replays(*tables: Dict[Any, Callable]) -> int:
    """Graph replays of the distinct entries of step tables whose
    functions carry their :class:`CapturedStep` as ``.step`` (the tables
    of ``build_token_step_fns`` and ``build_llm_step_fns``)."""
    steps = {id(fn.step): fn.step for table in tables
             for fn in table.values()}
    return sum(step.replays for step in steps.values())
