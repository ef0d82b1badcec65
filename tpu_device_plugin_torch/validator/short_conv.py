"""LFM2's gated short convolution, and Mamba-2's ungated one, on a
hand-written CUDA kernel pair each (C1: `csrc/short_conv.cu`, and its
ungated mode `csrc/conv_silu.cu`).

For the conv projection's output bch (b, s, 3d) bf16, cut into gates B, C
and values h of d channels each, and taps w (K, d) f32:

    u[t]     = bf16(B[t] h[t])                      (u is 0 before t = 0)
    mixed[t] = bf16(w[K-1] u[t] + sum_j<K-1 w[j] u[t-(K-1)+j])
    y[t]     = bf16(C[t] mixed[t])

each sum in f32 in that order, per channel and per sequence. The
backward, for dy (b, s, d) bf16, rounds as autograd does through the
composition: dmixed = bf16(dy C), dC = bf16(dy mixed); du[t] the f32 sum
of dmixed[t] w[K-1] and dmixed[t+(K-1)-j] w[j], rounded once; dB =
bf16(du h), dh = bf16(du B); each tap's gradient dw[j] the f32 sum of the
bf16 products dmixed[t+(K-1)-j] u[t].

- `gated_conv_plain` is the function as PyTorch composes it (the chunk,
  the gates, `_CausalConv`); autograd differentiates it. A CPU tensor
  gets it.
- On a CUDA tensor `gated_conv` goes through `_GatedConv`: `conv_fwd`
  reads bch once and writes y once; `conv_bwd` reads bch and dy once,
  writes dbch once in bch's layout (no concatenation) and each tile's f32
  tap partials, which a second kernel sums in a fixed order. Only bch and
  w are saved for the backward: u and mixed are recomputed from bch. A
  CUDA tensor launches the kernels or raises, never falls back.

The ungated mode, for x (b, s, D) bf16 (its rows may lie a stride apart:
a slice of a wider projection, read in place), taps w (K, D) and a bias
(D,) f32, K = 4:

    y[t] = bf16(silu(w[K-1] x[t] + sum_j<K-1 w[j] x[t-(K-1)+j] + bias))

the sum and the SiLU in f32 (x is 0 before t = 0). Its backward keeps the
sum's gradient g = dy silu'(sum) in f32: dx = bf16 of the sum over taps
of g w, each tap's gradient the f32 sum of g x, the bias's that of g.
`conv_silu_plain` is the composition; `conv_silu` takes the kernel pair
(`conv_silu_fwd`, `conv_silu_bwd`) on a CUDA tensor, saving x, w and the
bias alone.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import tracing
from ._kernels import launch, on_card

# the taps the kernels are compiled for: gated, ungated
KERNEL_TAPS = (2, 3, 4)
UNGATED_TAPS = (4,)
# tokens a thread walks in either kernel; a tile also reads its K - 1
# neighbours on either side (at LFM2's shape 64 beat 16, 32, 128 and 256
# on an H100)
TILE = 64
# the rows over which `conv_dw_kernel` interleaves the tiles' partials
# (kRedRows in csrc/short_conv.cu)
DW_ROWS = 8

# CUDA kernel launches per entry point since import (or since the caller
# last reset them); `conv_bwd` is the tile pass and the taps' sum together
launches = {"conv_fwd": 0, "conv_bwd": 0}
# the same for the ungated mode's pair
ungated_launches = {"conv_silu_fwd": 0, "conv_silu_bwd": 0}


def dw_sum_depth(b: int, s: int) -> int:
    """The most f32 additions that any term of a tap's gradient passes
    through on the kernel path: the TILE products of its tile, then its
    row's share of the b ceil(s / TILE) tiles, then the DW_ROWS rows. Each
    addition rounds by at most 2^-24 of the running sum, so the kernels'
    tap gradient lies within dw_sum_depth(b, s) 2^-24 of the sum of its
    terms' absolute values from the exact sum of those terms."""
    tiles = b * -(-s // TILE)
    return TILE + -(-tiles // DW_ROWS) + DW_ROWS


class _CausalConv(torch.autograd.Function):
    """Depthwise causal convolution of u (b, s, d) bf16 with taps w (K, d)
    f32: out[t] = sum_j w[j] * u[t - (K - 1) + j] (u is 0 before the
    sequence), each sum in f32 from the bf16 inputs, rounded to bf16 once;
    in the backward du likewise, and each tap's gradient an f32 sum of
    the bf16 products grad * u. It keeps u alone for the backward, where
    autograd's composition would keep an f32 copy of u for each tap."""

    @staticmethod
    def forward(ctx, u, w):
        ctx.save_for_backward(u, w)
        s, taps = u.shape[1], w.shape[0]
        acc = u * w[taps - 1]
        for j in range(taps - 1):
            shift = taps - 1 - j
            acc[:, shift:].addcmul_(u[:, :s - shift], w[j])
        return acc.to(u.dtype)

    @staticmethod
    def backward(ctx, grad):
        u, w = ctx.saved_tensors
        s, taps = u.shape[1], w.shape[0]
        du = grad * w[taps - 1]
        dw = torch.empty_like(w)
        dw[taps - 1] = (grad * u).sum((0, 1), dtype=torch.float32)
        for j in range(taps - 1):
            shift = taps - 1 - j
            du[:, :s - shift].addcmul_(grad[:, shift:], w[j])
            dw[j] = (grad[:, shift:] * u[:, :s - shift]).sum(
                (0, 1), dtype=torch.float32)
        return du.to(grad.dtype), dw


def gated_conv_plain(bch: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gated convolution in plain PyTorch (differentiable):
    B, C, h = chunk(bch, 3); C * conv(B * h)."""
    gate_b, gate_c, h = bch.chunk(3, -1)
    return gate_c * _CausalConv.apply(gate_b * h, w)


def _check(bch: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int, int]:
    """Checks what the kernels take; returns (b, s, d, K)."""
    if bch.dim() != 3 or w.dim() != 2 or bch.shape[-1] != 3 * w.shape[1]:
        raise ValueError(f"the conv kernels take bch (b, s, 3d) and taps "
                         f"(K, d); got {tuple(bch.shape)} and "
                         f"{tuple(w.shape)}")
    if bch.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise ValueError(f"the conv kernels take bfloat16 bch and float32 "
                         f"taps; got {bch.dtype} and {w.dtype}")
    if w.device != bch.device:
        raise ValueError("bch and the taps must be on one device")
    (b, s, _), (taps, d) = bch.shape, w.shape
    if taps not in KERNEL_TAPS:
        raise ValueError(f"the conv kernels take K in {KERNEL_TAPS}; got "
                         f"{taps}")
    if d % 8:
        raise ValueError(f"the conv kernels take d a multiple of 8; got {d}")
    if b * s * 3 * d >= 2 ** 31 or b * s == 0:
        raise ValueError(f"the conv kernels take 0 < b s 3d < 2^31; got "
                         f"{tuple(bch.shape)}")
    if not bch.is_contiguous() or bch.data_ptr() % 16:
        raise ValueError("the conv kernels need bch contiguous and 16-byte "
                         "aligned")
    return b, s, d, taps


def conv_fwd(bch: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`conv_fwd` on the current stream: y (b, s, d) bf16. CUDA tensors
    only."""
    b, s, d, taps = _check(bch, w)
    w = w.contiguous()
    y = torch.empty((b, s, d), dtype=torch.bfloat16, device=bch.device)
    launch("conv_fwd", bch.device, bch.data_ptr(), w.data_ptr(), y.data_ptr(),
           b, s, d, taps, TILE, launches=launches)
    return y


def conv_bwd(bch: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`conv_bwd` on the current stream: (dbch (b, s, 3d) bf16, dw (K, d)
    f32) for the gradient dy (b, s, d) of y. CUDA tensors only."""
    b, s, d, taps = _check(bch, w)
    if (dy.shape != (b, s, d) or dy.dtype != torch.bfloat16
            or dy.device != bch.device):
        raise ValueError(f"dy must be bf16 {(b, s, d)} on {bch.device}; got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.contiguous_format)
    w = w.contiguous()
    tiles = b * -(-s // TILE)
    dbch = torch.empty_like(bch)
    dw = torch.empty_like(w)
    partials = torch.empty((tiles, taps, d), dtype=torch.float32,
                           device=bch.device)
    launch("conv_bwd", bch.device, bch.data_ptr(), w.data_ptr(), dy.data_ptr(),
           dbch.data_ptr(), partials.data_ptr(), dw.data_ptr(), b, s, d, taps,
           TILE, launches=launches)
    return dbch, dw


class _GatedConv(torch.autograd.Function):
    """Forward `conv_fwd`, saving (bch, w) alone; backward `conv_bwd`."""

    @staticmethod
    def forward(ctx, bch, w):
        ctx.save_for_backward(bch, w)
        return conv_fwd(bch, w)

    @staticmethod
    def backward(ctx, dy):
        bch, w = ctx.saved_tensors
        return conv_bwd(bch, w, dy)


def gated_conv(bch: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gated convolution of bch (b, s, 3d) with taps w (K, d), y (b, s,
    d), differentiable: `gated_conv_plain` on a CPU tensor, the kernel pair
    on a CUDA tensor (bf16 bch, f32 taps), or raises. The kernel path
    counts its rows, b x s, as `conv.fused_rows`."""
    if not on_card(bch, "gated_conv"):
        return gated_conv_plain(bch, w)
    y = _GatedConv.apply(bch, w)
    tracing.count("conv.fused_rows", bch.shape[0] * bch.shape[1])
    return y


def conv_silu_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The ungated convolution in plain PyTorch (differentiable): the
    causal depthwise sum over the taps in f32, plus the bias, SiLU,
    rounded to bf16 once."""
    s, taps = x.shape[1], w.shape[0]
    xf = x.float()
    acc = xf * w[taps - 1]
    for j in range(taps - 1):
        shift = taps - 1 - j
        if shift < s:   # a tap past the sequence's start adds nothing
            acc = acc + torch.nn.functional.pad(xf[:, :s - shift] * w[j],
                                                (0, 0, shift, 0))
    return torch.nn.functional.silu(acc + bias).to(x.dtype)


def _check_silu(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> Tuple[int, int, int, int]:
    """Checks what the ungated kernels take; returns (b, s, D, K)."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2] \
            or bias.shape != (x.shape[2],):
        raise ValueError(f"the ungated conv kernels take x (b, s, D), taps "
                         f"(K, D) and a bias (D,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)} and {tuple(bias.shape)}")
    if (x.dtype != torch.bfloat16 or w.dtype != torch.float32
            or bias.dtype != torch.float32):
        raise ValueError(f"the ungated conv kernels take bfloat16 x and "
                         f"float32 taps and bias; got {x.dtype}, {w.dtype}, "
                         f"{bias.dtype}")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("x, the taps and the bias must be on one device")
    (b, s, d), taps = x.shape, w.shape[0]
    if taps not in UNGATED_TAPS:
        raise ValueError(f"the ungated conv kernels take K in "
                         f"{UNGATED_TAPS}; got {taps}")
    if d % 8 or b * s == 0 or b * s * d >= 2 ** 31:
        raise ValueError(f"the ungated conv kernels take D a multiple of 8 "
                         f"and 0 < b s D < 2^31; got {tuple(x.shape)}")
    if (x.stride(2) != 1 or x.stride(1) % 8 or x.data_ptr() % 16
            or x.stride(0) != s * x.stride(1)):
        raise ValueError(f"the ungated conv kernels need x's rows dense, "
                         f"16-byte aligned, a multiple of 8 elements apart; "
                         f"got strides {x.stride()}")
    return b, s, d, taps


def conv_silu_fwd(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """`conv_silu_fwd` on the current stream: y (b, s, D) bf16. CUDA
    tensors only."""
    b, s, d, taps = _check_silu(x, w, bias)
    w, bias = w.contiguous(), bias.contiguous()
    y = torch.empty((b, s, d), dtype=torch.bfloat16, device=x.device)
    launch("conv_silu_fwd", x.device, x.data_ptr(), x.stride(1),
           w.data_ptr(), bias.data_ptr(), y.data_ptr(), b, s, d, taps, TILE,
           launches=ungated_launches)
    return y


def conv_silu_bwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  dy: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`conv_silu_bwd` on the current stream: (dx (b, s, D) bf16 dense, dw
    (K, D) f32, dbias (D,) f32) for the gradient dy of y. CUDA tensors
    only."""
    b, s, d, taps = _check_silu(x, w, bias)
    if (dy.shape != (b, s, d) or dy.dtype != torch.bfloat16
            or dy.device != x.device):
        raise ValueError(f"dy must be bf16 {(b, s, d)} on {x.device}; got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.contiguous_format)
    w, bias = w.contiguous(), bias.contiguous()
    tiles = b * -(-s // TILE)
    dx = torch.empty((b, s, d), dtype=torch.bfloat16, device=x.device)
    dwb = torch.empty((taps + 1, d), dtype=torch.float32, device=x.device)
    partials = torch.empty((tiles, taps + 1, d), dtype=torch.float32,
                           device=x.device)
    launch("conv_silu_bwd", x.device, x.data_ptr(), x.stride(1),
           w.data_ptr(), bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
           partials.data_ptr(), dwb.data_ptr(), b, s, d, taps, TILE,
           launches=ungated_launches)
    return dx, dwb[:taps], dwb[taps]


class _ConvSilu(torch.autograd.Function):
    """Forward `conv_silu_fwd`, saving (x, w, bias) alone; backward
    `conv_silu_bwd`."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return conv_silu_fwd(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        return conv_silu_bwd(*ctx.saved_tensors, dy)


def conv_silu(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The ungated convolution of x (b, s, D) with taps w (K, D) and a
    bias, y (b, s, D) bf16, differentiable: `conv_silu_plain` on a CPU
    tensor, the kernel pair on a CUDA tensor, or raises."""
    if not on_card(x, "conv_silu"):
        return conv_silu_plain(x, w, bias)
    return _ConvSilu.apply(x, w, bias)
