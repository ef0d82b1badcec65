"""mamba_ms.train: device ms a training step in the kernels of the Mamba
mixer's own layers, forward, recomputed and backward: S1 (the scan,
csrc/ssd.cu) and C1's ungated pair (the convolution, csrc/conv_silu.cu,
with the reduction of its taps' gradient), the kernels whose names hold
one of MARKS. The mixer's projections and elementwise passes run as
library kernels that the trace does not tell from the other layers' by
name, so they are not in it (the port's span `workload.mamba`, which
holds them, is read by benchmarks/split.py). None where the window ran
no S1 kernel (a block without Mamba layers)."""

MARKS = ("ssd_fwd_kernel", "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel",
         "conv_silu_fwd_kernel", "conv_silu_bwd_kernel",
         "conv_silu_dw_kernel")


def read(view):
    if view.kind != "train" or not view.units:
        return None
    by_mark = [0] * len(MARKS)
    for name, start, end in view.events.device:
        for i, mark in enumerate(MARKS):
            if mark in name:
                by_mark[i] += end - start
                break
    if not any(by_mark[:3]):
        return None
    return 1e-6 * sum(by_mark) / len(view.units)
