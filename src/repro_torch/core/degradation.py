"""Model ladder for accuracy degradation — the third scaling axis.

Copy of ``repro.core.degradation``.  Sponge scales cores (vertical,
Algorithm 1) and replicas (horizontal, the joint (n, c, b) solver).
When *no* (n, c, b) is feasible the paper simply violates; "Dynamic
Network Adaptation at Inference" supplies the missing axis: scale the
**model**, trading accuracy for latency only when the SLO is otherwise
unreachable.  This module holds the ladder the (m, n, c, b) solver
(``core.solver.MultiModelSolverTable``) searches over:

* a :class:`ModelRung` per registry entry — the arch id, its registry
  accuracy score (``configs.registry.MODEL_ACCURACY``), a
  **fitted** cost surface (a :class:`~core.perf_model.PerfModel`
  RANSAC-fitted over a profiled (b, c, latency) sweep of the rung), and
  the weights-load time a fleet pays to swap onto the rung;
* a :class:`ModelLadder` — rungs ordered accuracy-descending, which IS
  the solver's candidate preference: the solver sheds accuracy only
  when every (n, c, b) at a higher rung is infeasible.

Cost surfaces scale from a calibrated base model (the Fig. 4
``yolov5s_like`` surface by default) by the cube root of the rung's
active-parameter ratio — the sublinear serving-latency growth a
batch-amortized accelerator shows — and the weights-load time scales
with *total* parameters over a load bandwidth (bigger weights, longer
swap).  Both knobs are explicit so studies can pin their own surfaces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core.cost_model import CostModel
from repro_torch.core.perf_model import PerfModel, yolov5s_like

# the registry's natural ladder, ascending capability: the
# serving-study default uses the small end where swaps are cheap
DEFAULT_LADDER_ARCHS: Tuple[str, ...] = (
    "smollm-135m", "smollm-360m", "gemma-2b", "rwkv6-1.6b")
FULL_LADDER_ARCHS: Tuple[str, ...] = (
    "smollm-135m", "smollm-360m", "gemma-2b", "zamba2-2.7b",
    "rwkv6-1.6b", "deepseek-v3-671b", "kimi-k2-1t-a32b")


@dataclass(frozen=True)
class ModelRung:
    """One ladder entry: a servable model size.

    ``accuracy`` is the registry quality score in (0, 1]; ``cost`` is
    the rung's fitted latency surface (anything satisfying the
    :class:`~core.cost_model.CostModel` protocol — the solver and
    both fleet engines only ever call ``latency``/``throughput``);
    ``swap_cost`` is the weights-load time (seconds) a replica pays
    before serving its first batch on this rung — the model-swap
    analogue of the horizontal axis's cold start.
    """
    name: str
    accuracy: float
    cost: Union[PerfModel, CostModel]
    swap_cost: float = 0.0


class ModelLadder:
    """Accuracy-ordered rung collection (best rung first).

    The iteration order is the (m, n, c, b) solver's candidate
    preference, so construction sorts rungs accuracy-descending and
    rejects duplicate names or duplicate accuracies (ties would make
    the shed order ambiguous across runs).
    """

    def __init__(self, rungs: Sequence[ModelRung]):
        if not rungs:
            raise ValueError("a ModelLadder needs at least one rung")
        names = [r.name for r in rungs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rung names: {names}")
        accs = [r.accuracy for r in rungs]
        if len(set(accs)) != len(accs):
            raise ValueError(f"duplicate rung accuracies: {accs}")
        for r in rungs:
            if not (0.0 < r.accuracy <= 1.0):
                raise ValueError(
                    f"rung {r.name!r}: accuracy {r.accuracy} not in (0, 1]")
        self.rungs: List[ModelRung] = sorted(
            rungs, key=lambda r: -r.accuracy)
        self._by_name = {r.name: r for r in self.rungs}

    def __len__(self) -> int:
        return len(self.rungs)

    def __iter__(self):
        return iter(self.rungs)

    def __getitem__(self, i: int) -> ModelRung:
        return self.rungs[i]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def rung(self, name: str) -> ModelRung:
        if name not in self._by_name:
            raise KeyError(f"unknown rung {name!r}; ladder: "
                           f"{[r.name for r in self.rungs]}")
        return self._by_name[name]

    def accuracy(self, name: str) -> float:
        return self.rung(name).accuracy

    def cost(self, name: str) -> Union[PerfModel, CostModel]:
        return self.rung(name).cost

    def swap_cost(self, name: str) -> float:
        return self.rung(name).swap_cost

    def best(self, accuracy_floor: float = 0.0) -> ModelRung:
        """The highest-accuracy rung at or above the floor."""
        for r in self.rungs:
            if r.accuracy >= accuracy_floor - 1e-12:
                return r
        raise ValueError(
            f"no rung clears accuracy floor {accuracy_floor} "
            f"(best available: {self.rungs[0].accuracy})")

    def admissible(self, accuracy_floor: float = 0.0,
                   m_set: Optional[Sequence[str]] = None
                   ) -> List[ModelRung]:
        """Rungs the solver may consider, preference order preserved:
        optionally restricted to ``m_set`` (a pin), always restricted
        to accuracies at or above ``accuracy_floor``."""
        allow = None if m_set is None else set(m_set)
        out = [r for r in self.rungs
               if (allow is None or r.name in allow)
               and r.accuracy >= accuracy_floor - 1e-12]
        if not out:
            raise ValueError(
                f"no admissible rung (floor={accuracy_floor}, "
                f"m_set={m_set}, ladder={[r.name for r in self.rungs]})")
        return out


def _scaled(base: PerfModel, s: float) -> PerfModel:
    """The base surface with every coefficient scaled by ``s`` — a
    model ``s``x slower at every (b, c)."""
    return PerfModel(gamma=base.gamma * s, eps=base.eps * s,
                     delta=base.delta * s, eta=base.eta * s)


def fit_rung_cost(base: PerfModel, scale: float, *,
                  bs: Sequence[int] = tuple(range(1, 17)),
                  cs: Sequence[int] = tuple(range(1, 17)),
                  noise: float = 0.01, seed: int = 0) -> PerfModel:
    """A rung's **fitted** cost surface: profile the scaled model over
    the (b, c) grid (noisy samples, as a real profiling sweep would
    give) and RANSAC-fit a fresh :class:`PerfModel` to the sweep —
    the same calibration path the paper's Table 1 surface went
    through, per rung."""
    truth = _scaled(base, scale)
    return PerfModel.fit(truth.sample_profile(bs, cs, noise=noise,
                                              seed=seed))


def resolve_ladder(spec, **kw) -> Optional["ModelLadder"]:
    """Resolve a ladder *spec* as it appears in scenario meta or a CLI
    flag: ``None`` (no ladder) and :class:`ModelLadder` instances pass
    through; ``"default"`` / ``"full"`` name the stock arch tuples; any
    other string is a comma-separated arch-id list; any sequence is an
    arch-id tuple.  Keeping specs as strings keeps scenario meta
    JSON-serializable."""
    if spec is None or isinstance(spec, ModelLadder):
        return spec
    if isinstance(spec, str):
        if spec == "default":
            return default_ladder(**kw)
        if spec == "full":
            return default_ladder(FULL_LADDER_ARCHS, **kw)
        return default_ladder(tuple(s.strip() for s in spec.split(",")),
                              **kw)
    return default_ladder(tuple(spec), **kw)


def default_ladder(archs: Sequence[str] = DEFAULT_LADDER_ARCHS, *,
                   base: Optional[PerfModel] = None,
                   load_gb_per_s: float = 40.0,
                   noise: float = 0.01) -> ModelLadder:
    """The registry-derived ladder: one rung per arch id.

    * accuracy — ``configs.registry.MODEL_ACCURACY``;
    * cost — :func:`fit_rung_cost` of ``base`` (default: the Fig. 4
      ``yolov5s_like`` surface) scaled by ``(active_params /
      active_params_smallest) ** (1/3)``, the sublinear latency growth
      of batch-amortized serving;
    * swap_cost — bf16 weight bytes over ``load_gb_per_s`` (weights
      streamed from local cache at swap time).

    Deterministic: the profiling seed is derived from the arch index,
    so the same ``archs`` tuple always fits the same surfaces (the
    decision-identity tests depend on this).
    """
    from repro_torch.configs.registry import get_config, model_accuracy
    if base is None:
        base = yolov5s_like()
    cfgs = {a: get_config(a) for a in archs}
    active = {a: float(cfgs[a].active_param_count()) for a in archs}
    a0 = min(active.values())
    rungs = []
    for i, a in enumerate(archs):
        scale = (active[a] / a0) ** (1.0 / 3.0)
        cost = fit_rung_cost(base, scale, noise=noise, seed=1000 + i)
        swap = 2.0 * float(cfgs[a].param_count()) / (load_gb_per_s * 1e9)
        rungs.append(ModelRung(name=a, accuracy=model_accuracy(a),
                               cost=cost, swap_cost=swap))
    return ModelLadder(rungs)
