"""Device ms a docking train step in the two pairwise distance heads and
the loss: forward (from the ``dock_head`` mark), the loss's backward (from
the step's ``head_bwd``) and the heads' backward (from
``dock_head_bwd``), read from the program's section marks
(h100_bench/dock_sections.py)."""

from h100_bench import dock_sections

LAYER = "model (models/*: sections between train/profiler.py marks)"
UNIT = "ms"


def read(run):
    return dock_sections.section_ms(run, "dock_head", "head_bwd", "dock_head_bwd")
