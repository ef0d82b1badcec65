"""device_idle.score: harness.metrics.device_idle in score cells."""

from harness.metrics import device_idle


def read(view):
    return device_idle(view, "score")
