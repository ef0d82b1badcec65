"""Card-only tests of the port's CUDA kernels (marker `gpu`).

Each skips without a CUDA card; on one, run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

This file imports no JAX, so it runs where only PyTorch is installed. The
kernel is held against its plain PyTorch version on the same inputs:
max |do| <= 2e-2 in bf16 (output rounding, 2^-8 relative) and <= 1e-4 in
f32 (summation order only), |dlse| <= 1e-3.
"""

import numpy as np
import pytest
import torch

from tpu_device_plugin_torch.validator import flash_attention as fa
from tpu_device_plugin_torch.validator import workload

O_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def inputs(hb, seq, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((hb, seq, d),
                                                 dtype=np.float32))
            .to(device=device, dtype=getattr(torch, dtype)) for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [1, 96, 200])
def test_kernel_matches_plain(cuda_device, dtype, d, causal, seq):
    q, k, v = inputs(3, seq, d, dtype, cuda_device, seed=d + seq)
    before = fa.launches
    o, lse = fa.flash_attention(q, k, v, None, causal, True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert o.dtype == q.dtype and lse.shape == (3, seq)
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, d ** -0.5, causal, True)
    assert (o.float() - ref_o.float()).abs().max().item() <= O_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.gpu
def test_kernel_refuses_grad_and_bad_inputs(cuda_device):
    q = torch.zeros((2, 64, 32), device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(q, q, q)
    with torch.no_grad():
        fa.flash_attention(q, q, q)   # inference under no_grad is fine
    bad = torch.zeros((2, 64, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(bad, bad, bad)


@pytest.mark.gpu
def test_serving_forward_goes_through_the_kernel(cuda_device):
    cfg = workload.ModelConfig(vocab=64, d_model=64, n_heads=4, d_ff=128,
                               n_layers=2, seq_len=96, batch=2)
    fwd, params, tokens = workload.build_infer(cfg, device=cuda_device)
    before = fa.launches
    logits = fwd(params, tokens)
    assert fa.launches == before + cfg.n_layers   # auto picks flash on CUDA
    einsum = workload.forward(params, tokens, cfg, "einsum")
    assert logits.shape == (2, 96, 64) and torch.isfinite(logits).all()
    rel = ((logits - einsum).abs().max() / einsum.abs().max()).item()
    assert rel <= 0.02
