"""Device ms a train step in the head, forward (from the ``head`` mark:
InfoNCE, cross-modal fusion or the gas and environment embeddings, pooling,
FDS, the classification head, the task loss and CT) and backward (from
``head_bwd``), read from the program's section marks
(h100_bench/sections.py)."""

from h100_bench import sections

LAYER = "model (models/*: sections between train/profiler.py marks)"
UNIT = "ms"


def read(run):
    return sections.section_ms(run, "head", "head_bwd")
