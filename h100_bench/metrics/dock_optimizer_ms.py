"""Device ms a docking train step in the optimizer (FusedAdam's clip, Adam
and apply, from the ``optimizer`` mark to the metric sums), read from the
program's section marks (h100_bench/dock_sections.py)."""

from h100_bench import dock_sections

LAYER = "optimizer (train/optim.py FusedAdam)"
UNIT = "ms"


def read(run):
    return dock_sections.section_ms(run, "optimizer")
