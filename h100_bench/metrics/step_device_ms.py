"""Device time of one train step: every kernel, copy and set on the card
over the traced steps, per step."""

LAYER = "train step (train/steps.py TrainPrograms.feed, train/optim.py FusedAdam)"
UNIT = "ms"


def read(run):
    if not run.trace.device:
        return None
    return run.trace.device_sum_s() / run.steps * 1e3
