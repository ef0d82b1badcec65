"""mfu.score: harness.metrics.mfu in score cells."""

from harness.metrics import mfu


def read(view):
    return mfu(view, "score")
