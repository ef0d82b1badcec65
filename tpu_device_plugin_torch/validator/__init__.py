"""Guest-side slice validator — the PyTorch/CUDA compute component.

The host plugin's job ends when a VMI boots with its VFIO groups attached;
proof that the slice actually *works* comes from inside the guest. This
package is that proof on an NVIDIA card: it enumerates the CUDA device and
trains (or serves) a transformer whose attention goes through hand-written
flash-attention kernels (csrc/flash_fwd.cu forward, csrc/flash_bwd.cu
backward) and whose training loss goes through a fused log-softmax/NLL
kernel pair (csrc/xent.cu). Run it in the guest:

    python -m tpu_device_plugin_torch.validator --mode train --preset mfu

It reports the training step time, TFLOP/s and MFU (or, with
`--mode infer`, the serving latency percentiles and tokens/s) and the
card's matmul and memory microbench against its datasheet peak. With
several cards it runs a (pp, dp, sp, ep, tp) mesh, one process per card,
with ring attention over sp (`--tp`, `--sp`, `--pp`, `--ep`), a top-1
switch MoE (`--experts`) and the GPipe schedule (`--gpipe-microbatches`);
several guests compose one slice with `--coordinator`,
`--num-processes` and `--process-id`. `--mode attn-bench` and
`--mode ring-bench` time the kernels.
"""

from .workload import ModelConfig, build_infer, build_workload  # noqa: F401
