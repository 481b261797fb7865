"""Device operations (kernels, copies, sets) a train step from its
``step`` mark to its ``end`` mark, the marks left out, read from the
program's section marks (h100_bench/sections.py): the work the host hands
to the card each step."""

from h100_bench import sections

LAYER = "train step (train/steps.py TrainPrograms.feed, train/optim.py FusedAdam)"
UNIT = "count"


def read(run):
    split = sections.steps(run)
    if split is None:
        return None
    return sum(n for s in split for mark, (_, n) in s.items() if mark != "end") / len(split)
