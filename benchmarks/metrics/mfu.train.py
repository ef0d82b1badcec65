"""mfu.train: harness.metrics.mfu in train cells."""

from harness.metrics import mfu


def read(view):
    return mfu(view, "train")
