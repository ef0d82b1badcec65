"""S1: Mamba-2's chunked selective scan on a hand-written CUDA kernel pair
(`csrc/ssd.cu`).

For x (b, s, heads, head dim) bf16, dt (b, s, heads) f32 (the softplus'
output), a (heads,) f32 (negative), B and C (b, s, groups, state) bf16
(head h reads group h // (heads / groups)) and D (heads,) f32, with
S_-1 = 0 for each sequence and head:

    S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T     (head dim x state)
    y_t = S_t C_t + D x_t                          (bf16)

computed in chunks of CHUNK tokens (Mamba-2's chunked form, arXiv:
2405.21060 section 6), with cum the running f32 sum of dt a inside a
chunk and every product of bf16 operands summed in f32:

    M[t][s] = bf16(exp(cum_t - cum_s) dt_s (C_t . B_s)),  s <= t, else 0
    y_t     = bf16(exp(cum_t) (C_t . bf16(S_prev)) + (M x)_t + D x_t)
    S_end   = exp(cum_end) S_prev + bf16(x_s exp(cum_end - cum_s) dt_s)^T B

the state S passed between chunks in f32.

- `ssd_plain` is that function in plain PyTorch (differentiable); a CPU
  tensor gets it.
- On a CUDA tensor `ssd` goes through `_Scan`: `ssd_fwd` walks each
  head's chunks in order and, under autograd, saves the f32 state
  entering each chunk (b x chunks x heads x head dim x state); `ssd_bwd`
  walks them backwards for the state's gradient, then computes every
  chunk's gradients from the two, the heads of a group summed into dB and
  dC in order (no atomic adds). Only the inputs and the states are saved.
  A CUDA tensor launches the kernels or raises, never falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._kernels import launch, on_card

# the kernels' chunk, head dim and state (kQ, kP, kN in csrc/ssd.cu)
CHUNK = 64
KERNEL_HEAD_DIM = 64
KERNEL_STATE = 128

# CUDA kernel launches per entry point since import (or since the caller
# last reset them); `ssd_bwd` is the state pass and the chunk pass together
launches = {"ssd_fwd": 0, "ssd_bwd": 0}


def _by_head(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, s, groups, n) -> (b, s, heads, n), head h on group h // (heads /
    groups)."""
    return t.repeat_interleave(heads // t.shape[2], dim=2)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
              chunk: int = CHUNK) -> torch.Tensor:
    """The chunked scan in plain PyTorch (differentiable), as the module's
    docstring writes it: y (b, s, heads, head dim) bf16."""
    b, s, heads, p = x.shape
    pad = -s % chunk
    nc = (s + pad) // chunk

    def chunks(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.view(b, nc, chunk, *t.shape[2:])

    xc = chunks(x)                                    # (b, nc, l, h, p)
    bc = chunks(_by_head(B, heads))                   # (b, nc, l, h, n)
    cc = chunks(_by_head(C, heads))
    dtc = chunks(dt[..., None])[..., 0]               # (b, nc, l, h)
    cum = (dtc * a).cumsum(2)
    gram = torch.einsum("bcthn,bcshn->bchts", cc.float(), bc.float())
    cum_h = cum.transpose(2, 3)                       # (b, nc, h, l)
    seg = cum_h[..., :, None] - cum_h[..., None, :]   # (.., t, s)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.exp(torch.where(causal, seg, -torch.inf))
    m = (decay * dtc.transpose(2, 3)[..., None, :] * gram).to(torch.bfloat16)
    y_diag = torch.einsum("bchts,bcshp->bcthp", m.float(), xc.float())
    end = cum_h[..., -1:]                             # (b, nc, h, 1)
    w = (torch.exp(end - cum_h) * dtc.transpose(2, 3)).transpose(2, 3)
    xw = (xc.float() * w[..., None]).to(torch.bfloat16)
    state = x.new_zeros(b, heads, p, B.shape[-1], dtype=torch.float32)
    out = []
    for c in range(nc):
        y_off = torch.einsum("bthn,bhpn->bthp", cc[:, c].float(),
                             state.to(torch.bfloat16).float())
        y_off = y_off * torch.exp(cum[:, c])[..., None]
        out.append(y_off + y_diag[:, c])
        state = (state * torch.exp(end[:, c])[..., None]
                 + torch.einsum("bshp,bshn->bhpn", xw[:, c].float(),
                                bc[:, c].float()))
    y = torch.stack(out, 1).reshape(b, nc * chunk, heads, p)[:, :s]
    return (y + D[:, None] * x.float()).to(torch.bfloat16)


def _check(x, dt, a, B, C, D) -> Tuple[int, int, int, int]:
    """Checks what the kernels take; returns (b, s, heads, groups)."""
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"the scan kernels take x (b, s, heads, head dim) "
                         f"and B, C (b, s, groups, state); got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, heads, p = x.shape
    groups, n = B.shape[2:]
    if (p, n) != (KERNEL_HEAD_DIM, KERNEL_STATE):
        raise ValueError(f"the scan kernels take head dim "
                         f"{KERNEL_HEAD_DIM} and state {KERNEL_STATE}; got "
                         f"{p} and {n}")
    if B.shape[:2] != (b, s) or heads % groups:
        raise ValueError(f"B and C must be (b, s, groups, state) with groups "
                         f"dividing heads; got {tuple(B.shape)} for x "
                         f"{tuple(x.shape)}")
    if dt.shape != (b, s, heads) or a.shape != (heads,) or D.shape != (heads,):
        raise ValueError(f"dt must be {(b, s, heads)} and a, D ({heads},); "
                         f"got {tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(D.shape)}")
    if (x.dtype, B.dtype, C.dtype) != (torch.bfloat16,) * 3 or any(
            t.dtype != torch.float32 for t in (dt, a, D)):
        raise ValueError("the scan kernels take bf16 x, B, C and f32 dt, a, "
                         "D")
    if any(t.device != x.device for t in (dt, a, B, C, D)):
        raise ValueError("the scan's inputs must be on one device")
    for name, t in (("x", x), ("B", B), ("C", C)):
        # tokens a stride apart, (heads or groups, last dim) dense within one
        if (t.stride(3) != 1 or t.stride(2) != t.shape[3]
                or t.stride(0) != s * t.stride(1) or t.stride(1) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"the scan kernels need {name}'s rows dense, "
                             f"16-byte aligned and a multiple of 8 elements "
                             f"apart; got strides {t.stride()}")
    return b, s, heads, groups


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def ssd_fwd(x, dt, a, B, C, D, save: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`ssd_fwd` on the current stream: (y (b, s, heads, head dim) bf16,
    the f32 state entering each chunk where `save`, else None). CUDA
    tensors only."""
    b, s, heads, groups = _check(x, dt, a, B, C, D)
    dt, a, D = _dense(dt), _dense(a), _dense(D)
    y = torch.empty((b, s, heads, KERNEL_HEAD_DIM), dtype=torch.bfloat16,
                    device=x.device)
    states = (torch.empty((b, -(-s // CHUNK), heads, KERNEL_HEAD_DIM,
                           KERNEL_STATE), dtype=torch.float32,
                          device=x.device) if save else None)
    launch("ssd_fwd", x.device, x.data_ptr(), x.stride(1), dt.data_ptr(),
           a.data_ptr(), B.data_ptr(), B.stride(1), C.data_ptr(),
           C.stride(1), D.data_ptr(), y.data_ptr(),
           0 if states is None else states.data_ptr(), b, s, heads, groups,
           launches=launches)
    return y, states


def ssd_bwd(x, dt, a, B, C, D, states, dy):
    """`ssd_bwd` on the current stream: (dx, ddt, da, dB, dC, dD) for the
    gradient dy of y, from `ssd_fwd`'s saved states. CUDA tensors only."""
    b, s, heads, groups = _check(x, dt, a, B, C, D)
    if dy.shape != x.shape or dy.dtype != torch.bfloat16:
        raise ValueError(f"dy must be bf16 {tuple(x.shape)}; got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    dt, a, D = _dense(dt), _dense(a), _dense(D)
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.contiguous_format)
    nc = -(-s // CHUNK)
    rstates = torch.empty_like(states)
    dx = torch.empty((b, s, heads, KERNEL_HEAD_DIM), dtype=torch.bfloat16,
                     device=x.device)
    ddt = torch.empty((b, s, heads), dtype=torch.float32, device=x.device)
    dB = torch.empty((b, s, groups, KERNEL_STATE), dtype=torch.bfloat16,
                     device=x.device)
    dC = torch.empty_like(dB)
    da_part = torch.empty((b, nc, heads), dtype=torch.float32,
                          device=x.device)
    dd_part = torch.empty_like(da_part)
    launch("ssd_bwd", x.device, x.data_ptr(), x.stride(1), dt.data_ptr(),
           a.data_ptr(), B.data_ptr(), B.stride(1), C.data_ptr(),
           C.stride(1), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
           rstates.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
           dC.data_ptr(), da_part.data_ptr(), dd_part.data_ptr(), b, s,
           heads, groups, launches=launches)
    return dx, ddt, da_part.sum((0, 1)), dB, dC, dd_part.sum((0, 1))


class _Scan(torch.autograd.Function):
    """Forward `ssd_fwd`, saving the inputs and, where a gradient is wanted
    (`save`), the chunk states; backward `ssd_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, a, B, C, D, save):
        y, states = ssd_fwd(x, dt, a, B, C, D, save)
        ctx.save_for_backward(x, dt, a, B, C, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_bwd(*ctx.saved_tensors, dy), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """The chunked scan, y (b, s, heads, head dim) bf16, differentiable:
    `ssd_plain` on a CPU tensor, the kernel pair on a CUDA tensor, or
    raises."""
    if not on_card(x, "ssd"):
        return ssd_plain(x, dt, a, B, C, D)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a, B, C, D))
    return _Scan.apply(x, dt, a, B, C, D, save)
