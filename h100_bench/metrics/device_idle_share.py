"""Share of the traced window (first device operation's start to the last
one's end) in which nothing ran on the card."""

LAYER = "device (H100)"
UNIT = "%"


def read(run):
    w = run.trace.window_s
    if w <= 0:
        return None
    return (1.0 - run.trace.busy_s / w) * 100.0
