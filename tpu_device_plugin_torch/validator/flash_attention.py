"""Flash-attention forward — the burn-in's hot op, on a hand-written CUDA kernel.

Port of the forward half of `tpu_device_plugin/validator/flash_attention.py`.
Causal (or full) multi-head attention over (heads_batch, seq, head_dim)
tensors, computed blockwise with the online-softmax recurrence so the
(S, S) score matrix never reaches device memory. The kernel is
`csrc/flash_fwd.cu` (built and loaded by `_kernels`); its plain PyTorch
version, `flash_attention_plain`, computes the same function in f32 and is
what a CPU tensor gets.

The TPU version's `block_q`/`block_k` were VMEM tile choices; the CUDA
kernel's tiles are its own compile-time constants, so they are not
arguments here. The backward (the TPU version's `custom_vjp` with two
Pallas kernels) is not ported yet: ROADMAP.md, Queue 1, item 2.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

# head dims the CUDA kernel is instantiated for (csrc/flash_fwd.cu)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# CUDA kernel launches since import (or since the caller last reset it);
# a run reads it to show its attention went through the kernel
launches = 0


def _reference_attention(q, k, v, sm_scale: float, causal: bool):
    """Plain einsum attention. Shapes: q, k, v are (heads_batch, seq, head_dim)."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * sm_scale
    if causal:
        seq = q.shape[1]
        mask = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def flash_attention_plain(q, k, v, sm_scale: float, causal: bool,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch, computed in f32.

    Returns `o` in q's dtype and, with `return_lse`, the per-row logsumexp
    of the scaled, masked scores as f32 (heads_batch, seq)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * sm_scale
    if causal:
        seq = q.shape[1]
        mask = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", torch.exp(s - lse[..., None]), vf)
    o = o.to(q.dtype)
    return (o, lse) if return_lse else o


def _flash_fwd_fn():
    from . import _kernels
    lib = _kernels.library("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention takes q, k, v of one shape (heads_batch, seq, "
            f"head_dim); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v "
                         "(call .contiguous() after folding heads)")
    hb, seq, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has no head_dim {d}; "
                         f"built for {KERNEL_HEAD_DIMS}")
    if not (0 < hb <= 65535 and seq > 0):
        raise ValueError(f"flash_attention kernel needs 0 < heads_batch <= "
                         f"65535 and seq > 0; got {hb}, {seq}")


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = True, return_lse: bool = False):
    """Blockwise causal attention. q, k, v: (heads_batch, seq, head_dim).

    A CPU tensor gets `flash_attention_plain`. A CUDA tensor launches the
    kernel in csrc/flash_fwd.cu on the current stream, or raises; it never
    falls back. With `return_lse`, returns (o, lse) with lse f32
    (heads_batch, seq)."""
    global launches
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, causal, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward on CUDA yet: the backward kernels "
            "arrive with the training slice (ROADMAP.md, Queue 1, item 2)")
    _check_kernel_inputs(q, k, v)
    hb, seq, d = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((hb, seq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _flash_fwd_fn()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 hb, seq, d, _DTYPE_CODE[q.dtype], int(causal),
                 float(sm_scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return (o, lse) if return_lse else o
