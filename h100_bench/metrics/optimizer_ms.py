"""Device ms a train step in the optimizer (FusedAdam's clip, Adam and
apply, from the ``optimizer`` mark to the metric sums), read from the
program's section marks (h100_bench/sections.py)."""

from h100_bench import sections

LAYER = "optimizer (train/optim.py FusedAdam)"
UNIT = "ms"


def read(run):
    return sections.section_ms(run, "optimizer")
