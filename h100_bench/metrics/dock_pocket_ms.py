"""Device ms a docking train step in the pocket stream: its gbf, embedding
and encoder layers (from the ``pocket`` mark) and their backward (from
``pocket_bwd``), read from the program's section marks
(h100_bench/dock_sections.py)."""

from h100_bench import dock_sections

LAYER = "model (models/*: sections between train/profiler.py marks)"
UNIT = "ms"


def read(run):
    return dock_sections.section_ms(run, "pocket", "pocket_bwd")
