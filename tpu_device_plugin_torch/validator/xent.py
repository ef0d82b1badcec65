"""The training head's summed next-token NLL on a hand-written CUDA kernel
pair (`csrc/xent.cu`).

For bf16 logits (B, S, V) and targets (B, T), T <= S, the loss is the sum
over b and t < T of log-softmax's NLL of logits[b, t] at targets[b, t],
taken in f32 from the exactly widened bf16 values. Its gradient with
respect to the logits, rounded once to bf16, is
g (softmax(logits[b, t]) - onehot(targets[b, t])) for t < T and 0 for
t >= T, where g is the gradient of the sum.

- `nll_sum_plain` is the function as PyTorch composes it: widen to f32,
  slice the first T positions, log-softmax, gather, sum; autograd gives
  the gradient, which the widening's backward rounds to bf16. A CPU tensor
  gets it.
- On a CUDA tensor `nll_sum` goes through `_NLLSum`: `xent_fwd` reads each
  row of logits once and writes its lse and NLL (f32, (B, T)), which are
  summed here; `xent_bwd` reads the logits and the saved lse once more and
  writes the bf16 gradient once. No f32 copy of the logits, no copy of the
  slice and no log-probs reach device memory. A CUDA tensor launches the
  kernels or raises, never falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import tracing
from ._kernels import launch, on_card

# CUDA kernel launches per kernel since import (or since the caller last
# reset them); a run reads them to show its heads went through the kernels
launches = {"xent_fwd": 0, "xent_bwd": 0}


def nll_sum_plain(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The summed NLL in plain PyTorch (differentiable): logits widened to
    f32, their first T positions, log-softmax, the targets' entries."""
    logprobs = torch.log_softmax(logits.float()[:, :targets.shape[1]], dim=-1)
    return -torch.gather(logprobs, -1, targets[..., None].long()).sum()


def nll_rows_plain(logits: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`xent_fwd`'s outputs in plain PyTorch: each row's logsumexp and NLL,
    f32 (B, T)."""
    x = logits.float()[:, :targets.shape[1]]
    lse = torch.logsumexp(x, dim=-1)
    return lse, lse - torch.gather(x, -1, targets[..., None].long())[..., 0]


def _kernel_targets(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Checks what the kernels take; returns the targets as int64 with a
    dense last dimension."""
    if logits.dim() != 3 or targets.dim() != 2:
        raise ValueError("the NLL kernels take logits (B, S, V) and targets "
                         f"(B, T); got {tuple(logits.shape)} and "
                         f"{tuple(targets.shape)}")
    if logits.dtype != torch.bfloat16:
        raise ValueError(f"the NLL kernels take bfloat16 logits; got "
                         f"{logits.dtype}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise ValueError(f"targets must be integers; got {targets.dtype}")
    if targets.device != logits.device:
        raise ValueError("logits and targets must be on one device")
    (b, s, v), (tb, t) = logits.shape, targets.shape
    if tb != b or not 0 < t <= s or v <= 0:
        raise ValueError(f"targets (B, T) need the logits' B and 0 < T <= S; "
                         f"got logits {tuple(logits.shape)}, targets "
                         f"{tuple(targets.shape)}")
    if b * s >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"the NLL kernels take under 2^31 rows and vocab; "
                         f"got {b * s} rows of {v}")
    if logits.stride(-1) != 1:
        raise ValueError("the NLL kernels need the logits' last dimension "
                         "dense")
    targets = targets.long()
    return targets if targets.stride(-1) == 1 else targets.contiguous()


def nll_rows(logits: torch.Tensor, targets: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`xent_fwd` on the current stream: each row's lse and NLL, f32
    (B, T). CUDA tensors only."""
    targets = _kernel_targets(logits, targets)
    (b, _, v), t = logits.shape, targets.shape[1]
    lse, nll = (torch.empty((b, t), dtype=torch.float32, device=logits.device)
                for _ in range(2))
    launch("xent_fwd", logits.device, logits.data_ptr(), targets.data_ptr(),
           lse.data_ptr(), nll.data_ptr(), b, t, v, logits.stride(0),
           logits.stride(1), targets.stride(0), launches=launches)
    return lse, nll


def nll_grad(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """`xent_bwd` on the current stream: the bf16 gradient (B, S, V) of the
    summed NLL, scaled by the f32 0-d `g`, from the lse `nll_rows` wrote.
    CUDA tensors only."""
    targets = _kernel_targets(logits, targets)
    (b, s, v), t = logits.shape, targets.shape[1]
    if (lse.shape != (b, t) or lse.dtype != torch.float32
            or lse.device != logits.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous f32 (B, T) on "
                         f"{logits.device}")
    if g.numel() != 1 or g.device != logits.device:
        raise ValueError(f"g must be one value on {logits.device}")
    g = g.float().contiguous()
    dlogits = torch.empty((b, s, v), dtype=torch.bfloat16,
                          device=logits.device)
    launch("xent_bwd", logits.device, logits.data_ptr(), targets.data_ptr(),
           lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(), b, s, t, v,
           logits.stride(0), logits.stride(1), targets.stride(0),
           launches=launches)
    return dlogits


class _NLLSum(torch.autograd.Function):
    """Forward `xent_fwd` and the sum of its NLLs, saving (logits, targets,
    lse); backward `xent_bwd`."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse, nll = nll_rows(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        return nll_grad(logits, targets, lse, g), None


def nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The summed next-token NLL of `logits` (B, S, V) against `targets`
    (B, T), T <= S, f32 and differentiable: `nll_sum_plain` on a CPU
    tensor, the kernel pair on a CUDA tensor (bf16 logits), or raises.
    The kernel path counts its rows, B x T, as `head.fused_rows`."""
    if not on_card(logits, "nll_sum"):
        return nll_sum_plain(logits, targets)
    loss = _NLLSum.apply(logits, targets)
    tracing.count("head.fused_rows", targets.shape[0] * targets.shape[1])
    return loss
