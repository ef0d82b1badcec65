"""device_idle.train: harness.metrics.device_idle in train cells."""

from harness.metrics import device_idle


def read(view):
    return device_idle(view, "train")
