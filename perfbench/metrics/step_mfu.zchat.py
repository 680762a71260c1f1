"""step_mfu in the published Zamba2 cell: model FLOPs of the useful work
(``counts/zamba2.py``) over the step calls' wall at the bf16 peak."""
from perfbench.harness import hybrid


def read(run):
    return hybrid.step_mfu_pct(run)
