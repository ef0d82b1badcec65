"""flash_roofline.score: harness.metrics.flash_roofline in score cells."""

from harness.metrics import flash_roofline


def read(view):
    return flash_roofline(view, "score")
