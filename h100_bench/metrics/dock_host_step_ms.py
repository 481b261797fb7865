"""Host ms to hand one docking train step to the card: the median of the
program's ``train.feed`` spans over the traced steps (the input copy, the
graph's launch and the output's clone), the tracer's own cost included;
None unless the marks read whole and there is one span a step
(h100_bench/dock_sections.py)."""

import statistics

from h100_bench import dock_sections
from h100_bench.sections import SPAN

LAYER = "train step (train/steps.py TrainPrograms.feed, train/optim.py FusedAdam)"
UNIT = "ms"


def read(run):
    spans = [d / 1e3 for _, d, name in run.trace.host if name == SPAN]
    if dock_sections.steps(run) is None or len(spans) != run.steps:
        return None
    return statistics.median(spans)
