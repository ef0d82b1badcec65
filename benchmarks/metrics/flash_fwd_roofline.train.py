"""flash_fwd_roofline.train: K1 (`flash_fwd`)'s share of its own roofline in
train cells, harness.kernels.roofline."""

from harness.kernels import roofline


def read(view):
    return roofline(view, "flash_fwd", "train")
