"""PyTorch/CUDA port of the guest-side slice validator, for NVIDIA Hopper.

`tpu_device_plugin_torch.validator` mirrors `tpu_device_plugin.validator`
module for module. It imports `torch` and nothing of JAX or of the JAX
package; kernels are hand-written CUDA C++ under `validator/csrc/`, built
with `nvcc` at first use.
"""
