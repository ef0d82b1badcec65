"""flash_dkv_roofline.train: K2 (`flash_bwd_dkv`)'s share of its own roofline in
train cells, harness.kernels.roofline."""

from harness.kernels import roofline


def read(view):
    return roofline(view, "flash_bwd_dkv", "train")
