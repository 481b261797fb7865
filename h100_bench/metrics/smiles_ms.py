"""Device ms a train step in the SMILES encoder, forward (from the
``smiles`` mark) and backward (from ``smiles_bwd``), read from the
program's section marks (h100_bench/sections.py); nothing in a model
without a SMILES stream."""

from h100_bench import sections

LAYER = "model (models/*: sections between train/profiler.py marks)"
UNIT = "ms"


def read(run):
    return sections.section_ms(run, "smiles", "smiles_bwd")
