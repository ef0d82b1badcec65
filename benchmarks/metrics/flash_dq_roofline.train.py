"""flash_dq_roofline.train: K3 (`flash_bwd_dq`)'s share of its own roofline in
train cells, harness.kernels.roofline."""

from harness.kernels import roofline


def read(view):
    return roofline(view, "flash_bwd_dq", "train")
