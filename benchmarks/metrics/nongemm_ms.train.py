"""nongemm_ms.train: harness.metrics.nongemm_ms in training cells."""

from harness.metrics import nongemm_ms


def read(view):
    return nongemm_ms(view)
