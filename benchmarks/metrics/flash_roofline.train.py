"""flash_roofline.train: harness.metrics.flash_roofline in train cells."""

from harness.metrics import flash_roofline


def read(view):
    return flash_roofline(view, "train")
