"""Host ms to hand one train step to the card: the median of the
program's ``train.feed`` spans over the traced steps (the input copy,
the graph's launch and the output's clone), the tracer's own cost
included (h100_bench/sections.py)."""

import statistics

from h100_bench import sections

LAYER = "train step (train/steps.py TrainPrograms.feed, train/optim.py FusedAdam)"
UNIT = "ms"


def read(run):
    spans = sections.feed_spans_ms(run)
    return None if spans is None else statistics.median(spans)
