"""The training head's summed NLL (xent.py) on the CPU.

A CPU tensor takes `xent.nll_sum_plain`, which must be the composition the
training loss used before the head had its kernel pair (f32 logits from
`workload._head`, sliced, log-softmax, gather, sum), bit for bit in value
and gradient, and `workload.sgd_step` must give the same loss and
gradients as with that composition. The kernels' own arithmetic (each
row's lse and NLL; g (softmax - onehot) rounded once to bf16, zero past
T) is held to the composition here in plain PyTorch: the loss within f32
summation noise, the gradient within one bf16 rounding. The kernels
themselves run in tests/test_torch_gpu.py.
"""

from unittest import mock

import pytest
import torch

from tpu_device_plugin_torch.validator import tracing, xent
from tpu_device_plugin_torch.validator import workload as tw

# (B, S, T, V): T = S (an sp shard that is not the last), T = S - 1, a
# vocab that is not a multiple of 8, one row
SHAPES = [(2, 12, 12, 64), (2, 12, 11, 64), (3, 9, 8, 37), (1, 1, 1, 5)]
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=16, batch=2)


def _composition(logits, targets):
    """The loss as `workload._nll_sum` composed it on the f32 logits."""
    logprobs = torch.log_softmax(logits.float()[:, :targets.shape[1]], dim=-1)
    return -torch.gather(logprobs, -1, targets[..., None].long()).sum()


def _nll_sum_before(params, x, targets, ax, cfg):
    """`workload._nll_sum` before the head had its kernel pair."""
    logits = tw._head(params, x, ax, cfg)
    logprobs = torch.log_softmax(logits[:, :targets.shape[1]], dim=-1)
    return -torch.gather(logprobs, -1, targets[..., None].long()).sum()


def _inputs(b, s, t, v, seed=0):
    gen = torch.Generator().manual_seed(seed)
    logits = (4 * torch.randn((b, s, v), generator=gen)).to(torch.bfloat16)
    targets = torch.randint(0, v, (b, t), generator=gen)
    return logits, targets


def _value_and_grad(fn, logits, targets, scale=0.37):
    leaf = logits.detach().requires_grad_()
    loss = fn(leaf, targets)
    (loss * scale).backward()
    return loss.detach(), leaf.grad


@pytest.mark.parametrize("shape", SHAPES, ids=[f"B{b}S{s}T{t}V{v}"
                                               for b, s, t, v in SHAPES])
def test_plain_is_the_composition_bit_for_bit(shape):
    logits, targets = _inputs(*shape)
    loss, grad = _value_and_grad(xent.nll_sum, logits, targets)
    ref_loss, ref_grad = _value_and_grad(_composition, logits, targets)
    assert loss.dtype == torch.float32 and grad.dtype == torch.bfloat16
    assert torch.equal(loss, ref_loss)
    assert torch.equal(grad, ref_grad)
    plain_loss, plain_grad = _value_and_grad(xent.nll_sum_plain, logits,
                                             targets)
    assert torch.equal(plain_loss, ref_loss) and torch.equal(plain_grad,
                                                             ref_grad)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"B{b}S{s}T{t}V{v}"
                                               for b, s, t, v in SHAPES])
def test_kernel_arithmetic_matches_the_composition(shape):
    """What xent_fwd and xent_bwd compute, in plain PyTorch: the rows' NLLs
    sum to the loss; g (exp(x - lse) - onehot) rounded once to bf16, zero
    for t >= T, is the composition's gradient within one bf16 rounding."""
    b, s, t, v = shape
    logits, targets = _inputs(*shape, seed=1)
    scale = 0.37
    ref_loss, ref_grad = _value_and_grad(_composition, logits, targets, scale)
    lse, nll = xent.nll_rows_plain(logits, targets)
    assert lse.shape == nll.shape == (b, t) and lse.dtype == torch.float32
    assert abs(nll.sum().item() - ref_loss.item()) <= 1e-5 * ref_loss.item()
    x = logits.float()[:, :t]
    onehot = torch.nn.functional.one_hot(targets, v).float()
    grad = torch.zeros((b, s, v), dtype=torch.bfloat16)
    grad[:, :t] = (scale * (torch.exp(x - lse[..., None]) - onehot)
                   ).to(torch.bfloat16)
    assert (grad[:, t:] == 0).all() and (ref_grad[:, t:] == 0).all()
    diff = (grad.float() - ref_grad.float()).abs()
    assert (diff <= 2 ** -8 * ref_grad.float().abs() + 1e-7).all()


@pytest.mark.parametrize("attention", ["einsum", "flash"])
@pytest.mark.parametrize("n_experts", [0, 2])
def test_sgd_step_unchanged_by_the_head_split(attention, n_experts):
    cfg = tw.ModelConfig(**SMALL, n_experts=n_experts)
    runs = []
    for nll_sum in (tw._nll_sum, _nll_sum_before):
        step, params, momentum, tokens = tw.build_workload(
            cfg, seed=3, attention=attention, device="cpu")
        with mock.patch.object(tw, "_nll_sum", nll_sum):
            loss, grads = tw.value_and_grad(params, tokens, cfg, attention)
            params, momentum, step_loss = step(params, momentum, tokens)
        runs.append((loss, tw._leaves(grads), step_loss,
                     tw._leaves(params), tw._leaves(momentum)))
    (loss, grads, step_loss, params, momentum), ref = runs
    assert torch.equal(loss, ref[0]) and torch.equal(step_loss, ref[2])
    for got, want in zip(grads + params + momentum, ref[1] + ref[3] + ref[4]):
        assert torch.equal(got, want)


def test_forward_still_returns_f32_logits():
    cfg = tw.ModelConfig(**SMALL)
    _, params, tokens = tw.build_infer(cfg, seed=3, attention="einsum",
                                       device="cpu")
    x = tw._stage(params, tokens, cfg, "einsum", None)
    logits = tw.forward(params, tokens, cfg, "einsum")
    assert logits.dtype == torch.float32
    assert torch.equal(logits, tw._logits(params, x, None, cfg).float())


def test_cpu_path_counts_no_fused_rows():
    logits, targets = _inputs(2, 12, 11, 64)
    with tracing.recording() as rec:
        xent.nll_sum(logits, targets)
    assert "head.fused_rows" not in rec.counts


@pytest.mark.parametrize("case", [
    ("float32", (2, 12, 64), (2, 11), "bfloat16 logits"),
    ("bfloat16", (2, 12, 64), (2, 13), "0 < T <= S"),
    ("bfloat16", (2, 12, 64), (3, 11), "0 < T <= S"),
    ("bfloat16", (2, 12, 64), (2, 0), "0 < T <= S"),
    ("bfloat16", (24, 64), (2, 11), r"\(B, S, V\)"),
], ids=["f32-logits", "T-over-S", "other-B", "T-zero", "2-d-logits"])
def test_kernel_inputs_are_checked(case):
    dtype, shape, tshape, message = case
    logits = torch.zeros(shape, dtype=getattr(torch, dtype))
    targets = torch.zeros(tshape, dtype=torch.int64)
    with pytest.raises(ValueError, match=message):
        xent._kernel_targets(logits, targets)


def test_kernel_targets_become_dense_int64():
    logits = torch.zeros((2, 12, 64), dtype=torch.bfloat16)
    rows = torch.arange(26, dtype=torch.int32).view(2, 13)
    targets = xent._kernel_targets(logits, rows[:, 1:])
    assert targets.dtype == torch.int64 and targets.stride(-1) == 1
    assert torch.equal(targets, rows[:, 1:].long())
    with pytest.raises(ValueError, match="last dimension dense"):
        xent._kernel_targets(logits.transpose(1, 2).contiguous()
                             .transpose(1, 2), rows[:, 1:])
    with pytest.raises(ValueError, match="cpu or cuda"):
        xent.nll_sum(logits.to("meta"), rows[:, 1:].to("meta"))
