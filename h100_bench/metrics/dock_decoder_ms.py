"""Device ms a docking train step in the decoder: the complex's assembly
and the recycled rounds (from the ``decoder`` mark) and their backward
(from ``decoder_bwd``), read from the program's section marks
(h100_bench/dock_sections.py)."""

from h100_bench import dock_sections

LAYER = "model (models/*: sections between train/profiler.py marks)"
UNIT = "ms"


def read(run):
    return dock_sections.section_ms(run, "decoder", "decoder_bwd")
