"""The model FLOPs of the traced steps (work.py, at each molecule's real
atoms and tokens) over the traced window, as a share of the H100's bf16
peak."""

from h100_bench import work

LAYER = "train step (train/steps.py TrainPrograms.feed, train/optim.py FusedAdam)"
UNIT = "%"


def read(run):
    if run.trace.window_s <= 0:
        return None
    return run.flops / run.trace.window_s / work.PEAK_BF16_FLOPS * 100.0
