"""Guest-side slice validator — the PyTorch/CUDA compute component.

The host plugin's job ends when a VMI boots with its VFIO groups attached;
proof that the slice actually *works* comes from inside the guest. This
package is that proof on an NVIDIA card: it enumerates the CUDA device and
runs a transformer forward whose attention goes through a hand-written
flash-attention kernel (csrc/flash_fwd.cu). Run it in the guest:

    python -m tpu_device_plugin_torch.validator --mode infer --preset mfu

It reports the serving latency percentiles, tokens/s and the card's matmul
and memory microbench against its datasheet peak. Training, the mesh and
the benches are ported in later slices (ROADMAP.md, Queue 1).
"""

from .workload import ModelConfig, build_infer  # noqa: F401
