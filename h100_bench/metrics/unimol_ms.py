"""Device ms a train step in the Uni-Mol stream: its forward (gbf, the
embeddings and the encoder layers, from the ``unimol`` mark) and its
backward (from the ``unimol_bwd`` mark), read from the program's section
marks (h100_bench/sections.py)."""

from h100_bench import sections

LAYER = "model (models/*: sections between train/profiler.py marks)"
UNIT = "ms"


def read(run):
    return sections.section_ms(run, "unimol", "unimol_bwd")
