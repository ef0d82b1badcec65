"""gemm_roofline.train: harness.metrics.gemm_roofline in train cells."""

from harness.metrics import gemm_roofline


def read(view):
    return gemm_roofline(view, "train")
