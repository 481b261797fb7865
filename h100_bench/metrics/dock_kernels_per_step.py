"""Device operations (kernels, copies, sets) a docking train step from its
``step`` mark to its ``end`` mark, the marks left out, read from the
program's section marks (h100_bench/dock_sections.py): the work the host
hands to the card each step."""

from h100_bench import dock_sections

LAYER = "train step (train/steps.py TrainPrograms.feed, train/optim.py FusedAdam)"
UNIT = "count"


def read(run):
    split = dock_sections.steps(run)
    if split is None:
        return None
    return sum(len(ops) for s in split for mark, ops in s.items() if mark != "end") / len(split)
