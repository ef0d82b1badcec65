"""Flash attention — the burn-in's hot op, on hand-written CUDA kernels.

Port of `tpu_device_plugin/validator/flash_attention.py`. Causal (or full)
multi-head attention over (heads_batch, seq, head_dim) tensors (v, and
so o, may have a head dim of its own: latent attention's (192, 128)),
computed blockwise so the (S, S) score matrix never reaches device memory, in
either direction:

- the forward (K1, `csrc/flash_fwd.cu`) runs the online-softmax
  recurrence and can store the per-row logsumexp;
- the backward (K2 and K3, `csrc/flash_bwd.cu`) recomputes P per tile from
  (q, k, lse) in the FlashAttention-2 two-pass shape: one pass
  accumulates (dk, dv) per key tile, one accumulates dq per query tile.

`flash_attention` is differentiable through `_FlashAttention`, the
counterpart of the TPU version's `custom_vjp`. Each kernel has a plain
PyTorch version computed in f32 (`flash_attention_plain`,
`flash_bwd_dkv_plain`, `flash_bwd_dq_plain`), which is what a CPU tensor
gets; a CUDA tensor launches the kernel or raises, never falls back. With
bf16 inputs the plain versions round P (K1, K2) and dS (K2, K3) to bf16
before the products that take them, as the kernels' tensor-core products
and the JAX kernels do; in f32 nothing is rounded.

The TPU version's block sizes were VMEM tile choices; the CUDA kernels'
tiles are their own compile-time constants, so they are not arguments.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._kernels import launch, on_card

NEG_INF = -1e30

# head dims the CUDA kernels are instantiated for (csrc/*.cu), shared by
# q, k and v; and the (q/k, v) pairs of head dims they are instantiated
# for besides, in bf16 only (latent attention: MLA's 128 + 64 query/key
# dims over 128 value dims)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_HEAD_DIM_PAIRS = ((192, 128),)
# K1's key tile (TC_BK in csrc/flash_fwd.cu); the plain forward rounds P
# over key blocks of this size, as K1 does
KEY_BLOCK = 128
# The bf16 (tensor-core) kernels' compile-time tiles as (block_q, block_k),
# the only ones the benches can select: K1 runs 128-query blocks over
# 128-key tiles; in the JAX kernels' naming of one backward pair, K3 holds
# 128 queries per block and K2 128 keys per block (each streams the other
# side in tiles of its own: TC_BQ and dq_bk in csrc/flash_bwd.cu).
FWD_BLOCK = (128, KEY_BLOCK)
BWD_BLOCK = (128, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# CUDA kernel launches per kernel since import (or since the caller last
# reset them); a run reads them to show it went through the kernels.
launches = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def _reference_attention(q, k, v, sm_scale: float, causal: bool):
    """Plain einsum attention. Shapes: q, k, v are (heads_batch, seq, head_dim)."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * sm_scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _causal_mask(seq: int, device) -> torch.Tensor:
    return torch.ones((seq, seq), dtype=torch.bool, device=device).tril()


def flash_attention_plain(q, k, v, sm_scale: float, causal: bool,
                          return_lse: bool = False):
    """K1's function in plain PyTorch, computed in f32.

    Returns `o` in q's dtype and, with `return_lse`, the per-row logsumexp
    of the scaled, masked scores as f32 (heads_batch, seq). In f32,
    o = exp(s - lse) V. Otherwise P is rounded to q's dtype before the P V
    product, as K1 and the JAX kernel round it (flash_attention.py:111):
    see `_rounded_pv`."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * sm_scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], q.device), s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    if q.dtype == torch.float32:
        o = torch.einsum("bqk,bkd->bqd", torch.exp(s - lse[..., None]), vf)
    else:
        o = _rounded_pv(s, v)
    o = o.to(q.dtype)
    return (o, lse) if return_lse else o


def _rounded_pv(s, v):
    """softmax(s) V by the online recurrence over key blocks of KEY_BLOCK,
    K1's tiles: per block p = exp(s - m) against the running row max m,
    rounded to v's dtype for the product, the accumulator rescaled by
    exp(m_old - m_new), the row sum l taken from the unrounded p, and
    o = acc / l at the end (f32). Blocks wholly above a causal diagonal,
    which K1 skips, leave m, l and acc exactly as they were."""
    hb, seq, _ = s.shape
    m = torch.full((hb, seq), NEG_INF, device=s.device)
    l = torch.zeros((hb, seq), device=s.device)
    acc = torch.zeros((hb, seq, v.shape[-1]), device=s.device)
    for k0 in range(0, seq, KEY_BLOCK):
        sb = s[:, :, k0:k0 + KEY_BLOCK]
        m_new = torch.maximum(m, sb.amax(dim=-1))
        p = torch.exp(sb - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype).float(),
            v[:, k0:k0 + KEY_BLOCK].float())
        m = m_new
    return acc / l[..., None]


def _p_ds(q, k, v, do, lse, di, sm_scale: float, causal: bool,
          round_to=None):
    """P and dS of the FlashAttention-2 backward, f32, zero where masked.
    With `round_to`, both are rounded to that dtype (and held in f32), as
    K2, K3 and the JAX kernels round them before their products; dS is
    taken from the unrounded P and scaled before it is rounded. In f32 the
    rounding is the identity."""
    qf, kf = q.float(), k.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * sm_scale
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    p = torch.exp(s - lse[..., None])
    ds = p * (dp - di[..., None]) * sm_scale
    if causal:
        mask = _causal_mask(q.shape[1], q.device)
        p = torch.where(mask, p, 0.0)
        ds = torch.where(mask, ds, 0.0)
    if round_to is not None:
        p, ds = p.to(round_to).float(), ds.to(round_to).float()
    return p, ds


def flash_bwd_dkv_plain(q, k, v, do, lse, di, sm_scale: float, causal: bool):
    """K2's function in plain PyTorch: (dk, dv) in f32, from the f32
    (heads_batch, seq) lse and D = rowsum(dO * O); P and dS are rounded to
    q's dtype before dV = P^T dO and dK = dS^T Q (flash_attention.py:224,
    :227)."""
    p, ds = _p_ds(q, k, v, do, lse, di, sm_scale, causal, round_to=q.dtype)
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk, dv


def flash_bwd_dq_plain(q, k, v, do, lse, di, sm_scale: float, causal: bool):
    """K3's function in plain PyTorch: dq in f32; dS, scaled, is rounded
    to q's dtype before dQ = dS K (flash_attention.py:262)."""
    _, ds = _p_ds(q, k, v, do, lse, di, sm_scale, causal, round_to=q.dtype)
    return torch.einsum("bqk,bkd->bqd", ds, k.float())


def rounding_terms_fwd(q, k, v, lse, sm_scale: float, causal: bool):
    """For each element of K1's output, the largest term of its sum
    P V, bounded by w[r] max_i |v[i, c]| with w[r] = max_i P[r, i] =
    exp(max_i s[r, i] - lse[r]) (f32, of o's shape).

    With bf16 inputs K1 and `flash_attention_plain` round P to bf16 from
    scores that differ in the last f32 bits (another summation order), so
    now and then one P rounds the other way: one bf16 ulp, at most 2^-7 of
    that P, and of its term in o. A check allows that much beside the
    output's own rounding."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], q.device), s, NEG_INF)
    w = torch.exp(s.amax(dim=-1) - lse)
    return w[..., None] * v.float().abs().amax(dim=1, keepdim=True)


def rounding_terms_dkv(q, k, v, do, lse, di, sm_scale: float, causal: bool):
    """As `rounding_terms_fwd`, for K2: the largest term of each element of
    dk (max_q |dS[q, k]| max_q |Q[q, c]|) and of dv (max_q P[q, k]
    max_q |dO[q, c]|), the P and dS that K2 and `flash_bwd_dkv_plain`
    round to bf16."""
    p, ds = _p_ds(q, k, v, do, lse, di, sm_scale, causal, round_to=q.dtype)
    pmax, dsmax = p.amax(dim=1), ds.abs().amax(dim=1)
    del p, ds
    return (dsmax[..., None] * q.float().abs().amax(dim=1, keepdim=True),
            pmax[..., None] * do.float().abs().amax(dim=1, keepdim=True))


def rounding_terms_dq(q, k, v, do, lse, di, sm_scale: float, causal: bool):
    """As `rounding_terms_dkv`, for K3: the largest term of each element of
    dq, max_k |dS[q, k]| max_k |K[k, c]|, the dS that K3 and
    `flash_bwd_dq_plain` round to bf16."""
    _, ds = _p_ds(q, k, v, do, lse, di, sm_scale, causal, round_to=q.dtype)
    dsmax = ds.abs().amax(dim=2)
    del ds
    return dsmax[..., None] * k.float().abs().amax(dim=1, keepdim=True)


def _row_dot(do, o) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, from the saved output as the TPU version
    computes it (flash_attention.py:286-290)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale: float,
                              causal: bool, out_dtype=None, di=None):
    """The backward in plain PyTorch: (dq, dk, dv) in `out_dtype`
    (default: the inputs' dtype), computed in f32. D = rowsum(dO * O) is
    `di` where given (then `o` is not read), else taken from `o`."""
    if di is None:
        di = _row_dot(do, o)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, di, sm_scale, causal)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, di, sm_scale, causal)
    out_dtype = out_dtype or q.dtype
    return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype)


def _check_kernel_inputs(q, k, v, *others):
    """q and k of one shape (heads_batch, seq, head_dim), v (and dO) of one
    shape (heads_batch, seq, v_head_dim), at head dims a kernel is built
    for."""
    tensors = (q, k, v, *others)
    if (q.dim() != 3 or k.shape != q.shape or v.dim() != 3
            or v.shape[:2] != q.shape[:2]
            or any(t.shape != v.shape for t in others)):
        raise ValueError(
            "flash_attention takes q and k of one shape (heads_batch, seq, "
            "head_dim) and v (and dO) of one shape (heads_batch, seq, "
            f"v_head_dim); got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in _DTYPE_CODE:
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         "tensors of one dtype; got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel needs contiguous q, k, v "
                         "(call .contiguous() after folding heads)")
    hb, seq, d = q.shape
    dv = v.shape[-1]
    if dv == d and d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has no head_dim {d}; "
                         f"built for {KERNEL_HEAD_DIMS}")
    if dv != d and ((d, dv) not in KERNEL_HEAD_DIM_PAIRS
                    or q.dtype != torch.bfloat16):
        raise ValueError(f"flash_attention kernel has no head_dim pair "
                         f"({d}, {dv}) in {q.dtype}; built for "
                         f"{KERNEL_HEAD_DIM_PAIRS} in bfloat16")
    if not (0 < hb <= 65535 and seq > 0):
        raise ValueError(f"flash_attention kernel needs 0 < heads_batch <= "
                         f"65535 and seq > 0; got {hb}, {seq}")


def flash_attention_fwd(q, k, v, sm_scale: float, causal: bool,
                        return_lse: bool = False):
    """K1: `flash_attention_plain` on a CPU tensor, the kernel in
    csrc/flash_fwd.cu on a CUDA tensor (current stream), or raises."""
    if not on_card(q, "flash_attention"):
        return flash_attention_plain(q, k, v, sm_scale, causal, return_lse)
    _check_kernel_inputs(q, k, v)
    hb, seq, d = q.shape
    o = torch.empty_like(v)
    lse = (torch.empty((hb, seq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), lse.data_ptr() if lse is not None else None, hb, seq,
           d, v.shape[-1], _DTYPE_CODE[q.dtype], int(causal), float(sm_scale),
           launches=launches)
    return (o, lse) if return_lse else o


def launch_bwd(q, k, v, do, lse, di, dq, dk, dv, sm_scale: float,
               causal: bool) -> None:
    """Launch K2 (into dk, dv) and K3 (into dq) of csrc/flash_bwd.cu on the
    current stream. A None dq skips K3, None dk and dv skip K2. Inputs are
    contiguous CUDA tensors; lse and di f32 (heads_batch, seq); outputs
    (dq and dk of q's shape, dv of v's) in q's dtype or f32."""
    _check_kernel_inputs(q, k, v, do)
    hb, seq, d = q.shape
    outs = [t for t in (dq, dk, dv) if t is not None]
    if (dk is None) != (dv is None) or not outs:
        raise ValueError("launch_bwd takes dq, or dk and dv, or all three")
    for t in (lse, di):
        if (t.shape != (hb, seq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError("lse and di must be contiguous f32 "
                             f"(heads_batch, seq) on {q.device}")
    if any(t.shape != like.shape or t.device != q.device
           or not t.is_contiguous() or t.dtype != outs[0].dtype
           or t.dtype not in (q.dtype, torch.float32)
           for t, like in ((dq, q), (dk, q), (dv, v)) if t is not None):
        raise ValueError("dq and dk must be contiguous tensors of q's shape, "
                         "dv of v's, of q's dtype or f32, of one dtype, on "
                         "q's device")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    launch("flash_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           do.data_ptr(), lse.data_ptr(), di.data_ptr(), ptr(dq), ptr(dk),
           ptr(dv), hb, seq, d, v.shape[-1], _DTYPE_CODE[q.dtype],
           _DTYPE_CODE[outs[0].dtype], int(causal), float(sm_scale),
           launches=launches,
           count=[name for name, out in (("flash_bwd_dkv", dk),
                                         ("flash_bwd_dq", dq))
                  if out is not None])


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float, causal: bool,
                        out_dtype=None, di=None):
    """(dq, dk, dv) of attention with upstream gradient `do`, in
    `out_dtype` (default: q's dtype). `flash_attention_bwd_plain` on a CPU
    tensor; K2 and K3 on a CUDA tensor, or raises. D = rowsum(dO * O) is
    `di` where given (ring attention passes the global one; `o` is then
    not read), else taken from `o`."""
    if not on_card(q, "flash_attention"):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale,
                                         causal, out_dtype, di)
    if di is None:
        di = _row_dot(do, o)
    dq, dk, dv = (torch.empty(like.shape, dtype=out_dtype or q.dtype,
                              device=q.device) for like in (q, k, v))
    launch_bwd(q, k, v, do, lse, di, dq, dk, dv, sm_scale, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward K1 with lse, saving (q, k, v, o, lse); backward K2 and K3.
    On CPU tensors both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        o, lse = flash_attention_fwd(q, k, v, sm_scale, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives strided (through the heads unfold's transpose)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = True, return_lse: bool = False):
    """Blockwise causal attention. q, k, v: (heads_batch, seq, head_dim).

    Differentiable: when a gradient is needed it goes through
    `_FlashAttention` (K1 forward, K2 + K3 backward on CUDA; the plain
    versions on the CPU). With `return_lse`, returns (o, lse) with lse f32
    (heads_batch, seq), not differentiable."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, sm_scale, causal)
        return (o, lse) if return_lse else o
    return flash_attention_fwd(q, k, v, sm_scale, causal, return_lse)
