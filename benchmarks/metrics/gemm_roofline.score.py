"""gemm_roofline.score: harness.metrics.gemm_roofline in score cells."""

from harness.metrics import gemm_roofline


def read(view):
    return gemm_roofline(view, "score")
