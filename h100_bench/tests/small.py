"""Small cells for the CPU tests: the benchmark's cells with every width
and count cut so that a step runs in a second on the CPU."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100_bench.registry import Cell, Registry  # noqa: E402

CELLS = ("mmdti-train-b32-n64", "unimof-train-b16-n528")


def small_cell(name: str, compute_dtype: str = None) -> Cell:
    cell = Cell(Registry(), name)
    c, m = copy.deepcopy(cell.config), copy.deepcopy(cell.mix)
    c["unimol"].update(encoder_layers=2, embed_dim=64, ffn_embed_dim=128, attention_heads=8,
                       gaussian_kernels=16)
    if compute_dtype:
        c["compute_dtype"] = compute_dtype
        c["unimol"]["pair_dtype"] = compute_dtype
    m["dataset"]["count"] = 64
    m["warmup_steps"] = 1
    m["trace_steps"] = 2
    if c["model"] == "mof":
        m["dataset"]["atoms"] = [20, 40]
        m.update(atom_pad=40, max_atoms=30, batch=4)
    else:
        c["chemberta"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                              intermediate_size=128)
        c["crossmodal"].update(hidden_size=64, num_attention_heads=4, intermediate_size=128)
        m["dataset"].update(atoms=[10, 30], smiles_tokens=[8, 24])
        m.update(batch=8, atom_pad=32, smiles_pad=24)
    cell.config, cell.mix = c, m
    return cell
