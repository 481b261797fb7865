"""The train step's sections in a traced run, read from the program's own
marks: mmdti_tpu_torch's train/profiler.py launches a null kernel
``trace_mark_<mark>`` at each section's start, recorded into the step's
CUDA graph, so every replayed step emits its marks in stream order; and it
names the host's hand-over of each step to the card with the span
``train.feed``.

``steps(run)`` splits the device operations of the traced steps by mark;
``feed_spans_ms(run)`` gives the host spans.  Both return None unless the
trace holds exactly ``run.steps`` ``step`` marks, each followed by one whole
sequence of SEQUENCES, the same in every step: a trace of a program
without the marks (or one that lost events) reads nothing.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

PREFIX = "trace_mark_"
_MARK = re.compile(PREFIX + r"([a-z_]+)")
# the marks of one step: MM-DTI's, and those of a model without a SMILES
# stream (Uni-MOF)
SEQUENCES = (
    ("step", "unimol", "smiles", "head", "head_bwd", "smiles_bwd", "unimol_bwd", "optimizer",
     "end"),
    ("step", "unimol", "head", "head_bwd", "unimol_bwd", "optimizer", "end"),
)
SPAN = "train.feed"


def mark_of(op_name: str) -> Optional[str]:
    """The mark a device operation's name carries, or None."""
    m = _MARK.search(op_name)
    return m.group(1) if m else None


def steps(run) -> Optional[List[Dict[str, Tuple[float, int]]]]:
    """Per traced step, mark -> (device ms, operations) of the device
    operations from that mark to the next one (the marks left out; the last
    step's ``end`` runs to the trace's end); None unless every step holds
    one whole sequence."""
    dev = run.trace.device
    marks = [(i, mark_of(e[2])) for i, e in enumerate(dev) if PREFIX in e[2]]
    names = [m for _, m in marks]
    starts = [j for j, m in enumerate(names) if m == "step"]
    if len(starts) != run.steps or not starts or starts[0] != 0:
        return None
    bounds = list(zip(starts, starts[1:] + [len(marks)]))
    seqs = {tuple(names[a:b]) for a, b in bounds}
    if len(seqs) != 1 or seqs.pop() not in SEQUENCES:
        return None
    out = []
    for a, b in bounds:
        sections = {}
        for j in range(a, b):
            first = marks[j][0] + 1
            last = marks[j + 1][0] if j + 1 < len(marks) else len(dev)
            ops = dev[first:last]
            sections[marks[j][1]] = (sum(d for _, d, _ in ops) / 1e3, len(ops))
        out.append(sections)
    return out


def section_ms(run, *names: str) -> Optional[float]:
    """Device ms a step of the sections ``names`` together, over the traced
    steps; None where the steps hold none of them."""
    split = steps(run)
    if split is None or not any(n in split[0] for n in names):
        return None
    return sum(s[n][0] for s in split for n in names if n in s) / len(split)


def feed_spans_ms(run) -> Optional[List[float]]:
    """The host spans ``train.feed`` of the traced steps, in ms; None unless
    the marks read whole and there is one span a step."""
    spans = [d / 1e3 for _, d, name in run.trace.host if name == SPAN]
    if steps(run) is None or len(spans) != run.steps:
        return None
    return spans
