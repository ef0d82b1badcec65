"""Ring attention — sequence-parallel causal attention over the `sp` ring.

Port of `tpu_device_plugin/validator/ring_attention.py`. Each of the `sp`
ranks holds S/sp queries, keys and values. K and V rotate round the ring
(rank i sends to i+1 and receives from i-1) while each rank accumulates
attention over the visiting block with the online-softmax recurrence. The
backward rotates K and V again, recomputes each tile from the saved global
logsumexp, and carries the dK/dV accumulators round with their blocks, so
after a full cycle each gradient is back at its block's rank. Per-rank
residency is O(S/sp) in both directions.

Causality at block granularity: rank i attends fully to blocks j < i,
causally to its own block, not at all to j > i. The schedule visits the
local block first, so the running max is finite from step 0. A skipped
step (j > i) launches nothing: the JAX version adds an exact zero there.

Two inner loops, each a pair of plain functions (forward -> (o, lse),
backward -> (dq, dk, dv)) under one autograd Function:

- the einsum ring (`ring_attention`): f32 score tiles, what the workload
  runs on CPU tensors, as the JAX workload does under interpret;
- ring flash (`ring_flash_attention`): each step is K1 with its lse
  (`flash_attention_fwd`) and, backward, K2 and K3 with f32 outputs against
  the GLOBAL lse and D = rowsum(dO * O) (`flash_attention_bwd`): the CUDA
  kernels on CUDA tensors, their plain versions on CPU tensors.

Where the ring's communication lives: a ring object with `index`, `size`
and `rotate(*tensors)`. `ProcessGroupRing` is a ring of processes (one
`batch_isend_irecv` per rotation over the sp group); `ThreadRing` is a
ring of threads in one process, the one-device stand-in for a ring of
cards (as the JAX tests' virtual CPU devices are).

Layout: (heads_batch, seq_local, head_dim); lse is f32 (heads_batch,
seq_local).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

from ._kernels import on_card
from .flash_attention import (NEG_INF, _row_dot,
                              flash_attention_bwd, flash_attention_fwd)


class ProcessGroupRing:
    """The ring of the processes of `group` (the sp group), in group order."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        # P2POp takes global ranks
        ranks = dist.get_process_group_ranks(group)
        self._next = ranks[(self.index + 1) % self.size]
        self._prev = ranks[(self.index - 1) % self.size]

    def rotate(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        """Send each tensor to ring position index+1, return what came from
        index-1. One batch of P2P ops in which every rank of the group
        takes part (NCCL sets its communicator up lazily on the first)."""
        import torch.distributed as dist
        if self.size == 1:
            return list(tensors)
        sends = [t.contiguous() for t in tensors]
        outs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, self._next, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, o, self._prev, self.group) for o in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs


class ThreadRing:
    """A ring of `size` threads of one process, the one-device stand-in for
    a ring of cards: `member(i)` is position i's ring object.

    A rotation hands each thread the tensors of the thread before it, by
    reference (the ring functions never write a tensor they have sent);
    on CUDA, where each thread runs on its own stream, with `_event` and
    `_take`. A thread that fails breaks the barrier, so the others raise
    instead of waiting forever."""

    def __init__(self, size: int, timeout_s: float = 300.0):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout_s)
        self._slots: List[Optional[tuple]] = [None] * size

    def member(self, index: int) -> "_ThreadRingMember":
        return _ThreadRingMember(self, index)

    def abort(self) -> None:
        self._barrier.abort()


def _event(t: torch.Tensor):
    """An event recorded on the current stream after `t` was produced, or
    None on the CPU: what a thread hands over with `t`."""
    if not t.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _take(tensors, event) -> None:
    """The receiving thread's current stream waits for the sender's
    `event`, and the allocator is told `tensors` are in use on it."""
    if event is None:
        return
    stream = torch.cuda.current_stream()
    stream.wait_event(event)
    for t in tensors:
        t.record_stream(stream)


class _ThreadRingMember:
    def __init__(self, ring: ThreadRing, index: int):
        self._ring, self.index, self.size = ring, index, ring.size

    def rotate(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        if self.size == 1:
            return list(tensors)
        ring = self._ring
        ring._slots[self.index] = (tensors, _event(tensors[0]))
        ring._barrier.wait()
        got, event = ring._slots[(self.index - 1) % self.size]
        ring._barrier.wait()   # every slot read before any is written again
        _take(got, event)
        return list(got)


def run_on_threads(size: int, fn: Callable, device=None,
                   timeout_s: float = 300.0, group=None) -> list:
    """`fn(member)` for each member of `group` (by default a new
    `ThreadRing(size)`; `pipeline.ThreadLink` is the other kind), each in
    its own thread (on CUDA, on its own stream of `device`, which first
    waits for the caller's stream and is synchronised before the thread
    ends); returns the results in member order and re-raises the first
    exception. A thread that fails aborts the group."""
    ring = ThreadRing(size, timeout_s) if group is None else group
    results: list = [None] * size
    errors: List[BaseException] = []
    on_cuda = device is not None and torch.device(device).type == "cuda"
    caller = torch.cuda.current_stream(device) if on_cuda else None

    def body(i: int) -> None:
        try:
            if on_cuda:
                stream = torch.cuda.Stream(device)
                stream.wait_stream(caller)
                with torch.cuda.stream(stream):
                    results[i] = fn(ring.member(i))
                stream.synchronize()
            else:
                results[i] = fn(ring.member(i))
        except BaseException as exc:   # re-raised by the caller's thread
            errors.append(exc)
            ring.abort()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    if any(t.is_alive() for t in threads):
        ring.abort()
        raise TimeoutError(f"ring threads still running after {timeout_s:g} s")
    if errors:
        # a broken barrier is the echo of another thread's failure
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return results


def _step_mode(src: int, index: int) -> Optional[bool]:
    """The block from rank `src` at rank `index`: None = skip (a future
    block), True = causal (the own block), False = full (a past block)."""
    if src > index:
        return None
    return src == index


def _merge(m, l, acc, o_b, lse_b):
    """Fold a finished block (o_b f32, lse_b) into the running (m, l, acc):
    the block has total weight exp(lse_b) and weighted sum o_b exp(lse_b)."""
    m_new = torch.maximum(m, lse_b)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(lse_b - m_new)
    l = alpha * l + beta
    acc = acc * alpha[..., None] + o_b * beta[..., None]
    return m_new, l, acc


def ring_flash_forward(q, k, v, sm_scale: float, ring):
    """(o in q's dtype, global lse f32): K1 with lse on each non-skipped
    step. The step's o_b is merged as K1 returns it, rounded to q's dtype,
    then cast to f32, as the JAX ring merges `_flash_3d`'s output."""
    hb, s, d = q.shape
    m = torch.full((hb, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((hb, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((hb, s, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(ring.size):
        mode = _step_mode((ring.index - step) % ring.size, ring.index)
        if mode is not None:
            o_b, lse_b = flash_attention_fwd(q, k_cur, v_cur, sm_scale, mode,
                                             True)
            m, l, acc = _merge(m, l, acc, o_b.float(), lse_b)
        if step != ring.size - 1:
            k_cur, v_cur = ring.rotate(k_cur, v_cur)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def ring_flash_backward(q, k, v, o, lse, do, sm_scale: float, ring):
    """(dq, dk, dv) in the inputs' dtype: K2 and K3 with f32 outputs on each
    non-skipped step, against the global `lse` and D = rowsum(dO * O) of
    the global `o` (computed once). The f32 partials join f32 sums, as in
    the JAX ring; the dK/dV accumulators take a final homing hop."""
    di = _row_dot(do, o)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros_like(dq)
    dv_cur = torch.zeros_like(dq)
    k_cur, v_cur = k, v
    for step in range(ring.size):
        mode = _step_mode((ring.index - step) % ring.size, ring.index)
        if mode is not None:
            dq_b, dk_b, dv_b = flash_attention_bwd(
                q, k_cur, v_cur, None, lse, do, sm_scale, mode,
                out_dtype=torch.float32, di=di)
            dq = dq + dq_b
            dk_cur = dk_cur + dk_b
            dv_cur = dv_cur + dv_b
        # K and V are dead after the last step; the accumulators go home
        if step != ring.size - 1:
            k_cur, v_cur, dk_cur, dv_cur = ring.rotate(k_cur, v_cur, dk_cur,
                                                       dv_cur)
        else:
            dk_cur, dv_cur = ring.rotate(dk_cur, dv_cur)
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


def _block_scores(qf, k_cur, sm_scale: float, causal: bool):
    s = torch.einsum("bqd,bkd->bqk", qf, k_cur.float()) * sm_scale
    if causal:
        tril = torch.ones(s.shape[1:], dtype=torch.bool, device=s.device).tril()
        s = torch.where(tril, s, NEG_INF)
    return s


def ring_einsum_forward(q, k, v, sm_scale: float, ring):
    """(o in q's dtype, global lse f32) from f32 score tiles, the online
    softmax run over the visiting blocks' scores."""
    hb, s, d = q.shape
    qf = q.float()
    m = torch.full((hb, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((hb, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((hb, s, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(ring.size):
        mode = _step_mode((ring.index - step) % ring.size, ring.index)
        if mode is not None:
            sc = _block_scores(qf, k_cur, sm_scale, mode)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", p, v_cur.float())
            m = m_new
        if step != ring.size - 1:
            k_cur, v_cur = ring.rotate(k_cur, v_cur)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def ring_einsum_backward(q, k, v, o, lse, do, sm_scale: float, ring):
    """(dq, dk, dv) in the inputs' dtype: each visiting tile recomputed in
    f32 from the global lse, the dK/dV accumulators carried home."""
    qf, dof = q.float(), do.float()
    di = _row_dot(do, o)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros_like(dq)
    dv_cur = torch.zeros_like(dq)
    k_cur, v_cur = k, v
    for step in range(ring.size):
        mode = _step_mode((ring.index - step) % ring.size, ring.index)
        if mode is not None:
            kf, vf = k_cur.float(), v_cur.float()
            p = torch.exp(_block_scores(qf, k_cur, sm_scale, mode)
                          - lse[..., None])   # masked entries -> 0
            dv_cur = dv_cur + torch.einsum("bqk,bqd->bkd", p, dof)
            dp = torch.einsum("bqd,bkd->bqk", dof, vf)
            ds = p * (dp - di[..., None]) * sm_scale
            dq = dq + torch.einsum("bqk,bkd->bqd", ds, kf)
            dk_cur = dk_cur + torch.einsum("bqk,bqd->bkd", ds, qf)
        if step != ring.size - 1:
            k_cur, v_cur, dk_cur, dv_cur = ring.rotate(k_cur, v_cur, dk_cur,
                                                       dv_cur)
        else:
            dk_cur, dv_cur = ring.rotate(dk_cur, dv_cur)
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _Ring(torch.autograd.Function):
    """A ring forward saving (q, k, v, o, lse); its backward re-rotates."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, ring, forward_fn, backward_fn):
        o, lse = forward_fn(q, k, v, sm_scale, ring)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.ring, ctx.backward_fn = sm_scale, ring, backward_fn
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = ctx.backward_fn(q, k, v, o, lse, do.contiguous(),
                                ctx.sm_scale, ctx.ring)
        return (*grads, None, None, None, None)


def ring_attention(q, k, v, sm_scale: float, ring):
    """Causal attention with K/V rotating round `ring`: the einsum ring."""
    return _Ring.apply(q, k, v, sm_scale, ring, ring_einsum_forward,
                       ring_einsum_backward)


def ring_flash_attention(q, k, v, sm_scale: float, ring):
    """`ring_attention` with the flash kernels inside each step: K1 forward,
    K2 and K3 backward on CUDA tensors (their plain versions on the CPU).
    q, k, v must be contiguous."""
    on_card(q, "flash_attention")   # cpu or cuda, nothing else
    return _Ring.apply(q, k, v, sm_scale, ring, ring_flash_forward,
                       ring_flash_backward)
