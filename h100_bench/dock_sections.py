"""The docking train step's sections in a traced run, read from the
program's own marks (train/profiler.py DOCKING_MARKS of mmdti_tpu_torch):
sections.py's reading for a mark sequence that its SEQUENCES does not
hold.  The ligand stream keeps ``unimol``; the pocket stream, the recycled
decoder and the distance heads open ``pocket``, ``decoder`` and
``dock_head``; the step's ``head_bwd`` (the loss's backward) is followed by
``dock_head_bwd``, ``decoder_bwd``, ``pocket_bwd`` and ``unimol_bwd``.

``steps(run)`` returns None unless the trace holds exactly ``run.steps``
``step`` marks, each followed by one whole SEQUENCE.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from h100_bench.sections import PREFIX, mark_of

SEQUENCE = ("step", "unimol", "pocket", "decoder", "dock_head", "head_bwd", "dock_head_bwd",
            "decoder_bwd", "pocket_bwd", "unimol_bwd", "optimizer", "end")


def steps(run) -> Optional[List[Dict[str, list]]]:
    """Per traced step, mark -> the device operations (start, duration,
    name) from that mark to the next one (the marks left out; the last
    step's ``end`` runs to the trace's end); None unless every step holds
    one whole SEQUENCE."""
    dev = run.trace.device
    marks = [(i, mark_of(e[2])) for i, e in enumerate(dev) if PREFIX in e[2]]
    names = [m for _, m in marks]
    starts = [j for j, m in enumerate(names) if m == "step"]
    if len(starts) != run.steps or not starts or starts[0] != 0:
        return None
    bounds = list(zip(starts, starts[1:] + [len(marks)]))
    if any(tuple(names[a:b]) != SEQUENCE for a, b in bounds):
        return None
    out = []
    for a, b in bounds:
        sections = {}
        for j in range(a, b):
            last = marks[j + 1][0] if j + 1 < len(marks) else len(dev)
            sections[marks[j][1]] = dev[marks[j][0] + 1:last]
        out.append(sections)
    return out


def section_ms(run, *names: str) -> Optional[float]:
    """Device ms a step of the sections ``names`` together, over the traced
    steps; None where the marks do not read whole."""
    split = steps(run)
    if split is None:
        return None
    return sum(d for s in split for n in names for _, d, _ in s[n]) / 1e3 / len(split)
