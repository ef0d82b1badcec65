"""Processes, groups and the collectives of the port's mesh.

The JAX package has no counterpart: there, sharding annotations
(`workload.param_specs`, `with_sharding_constraint`) let XLA's partitioner
insert every collective. The port runs eagerly, so each collective is an
explicit `torch.distributed` call over a group of the `DeviceMesh`
(mesh.py): NCCL on the cards, gloo on the CPU.

- `spawn` runs one function in n processes, one per device, and returns
  what each returned.
- `enter`, `exit_`, `gather` are the autograd-aware collectives of
  Megatron-style tensor parallelism; `all_reduce_grads` sums gradients
  over the groups on which a leaf's rank holds only a partial.
- `pipe_send`, `pipe_recv` move activations between pipeline stages, and
  their gradients back in the backward.
- `queue_offsets` gives top-1 routing its global token order: each rank's
  place in every expert's queue over the whole (dp, sp)-sharded batch.

Nothing here starts a process or opens a file at import.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


class _RemoteTraceback(Exception):
    """A child's traceback, chained to the exception the parent re-raises."""

    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self) -> str:
        return self.tb


def _child(rank: int, n: int, device_type: str, init_method: str,
           timeout_s: float, results, fn: Callable, args: Sequence,
           mesh_kw: Optional[Dict[str, Any]]) -> None:
    """One spawned process: join the group, build the mesh, run `fn`,
    put ("ok", rank, result) or ("error", rank, exception, traceback)."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        else:
            # n processes of one host side by side: one intra-op thread each
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = None
            if mesh_kw is not None:
                from .mesh import slice_mesh
                mesh = slice_mesh(n, device_type=device_type, **mesh_kw)
            out = fn(rank, mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException as exc:   # reported to the parent, which re-raises
        tb = traceback.format_exc()
        try:
            results.put(("error", rank, exc, tb))
        except Exception:   # an exception that does not pickle
            results.put(("error", rank, RuntimeError(repr(exc)), tb))


def spawn(fn: Callable, n: int, device_type: str = "cpu",
          timeout_s: float = 300.0, args: Sequence = (),
          mesh: Optional[Dict[str, Any]] = None) -> List[Any]:
    """Run `fn(rank, mesh, *args)` in n fresh processes; returns the n
    results in rank order.

    Each process joins one group of n (NCCL with card `rank` on "cuda",
    gloo with one thread on "cpu"), rendezvousing through a file in a new
    temporary directory (no TCP port, so parallel callers never collide),
    and builds `mesh.slice_mesh(n, **mesh)` when `mesh` is given (else it
    passes None). `fn` and `args` are pickled: `fn` must be a module-level
    function of a module the child can import.

    The first child exception is re-raised here, chained to the child's
    traceback; a child that dies without reporting, or a run past
    `timeout_s`, raises RuntimeError or TimeoutError. Every child is
    killed and joined before this returns or raises."""
    if n < 1:
        raise ValueError(f"spawn needs n >= 1, got {n}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(prefix="tdp-spawn-"))
    init_method = f"file://{tmp / 'rendezvous'}"
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(rank, n, device_type, init_method, timeout_s,
                               results, fn, tuple(args), mesh))
             for rank in range(n)]
    deadline = time.monotonic() + timeout_s
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {n - len(out)} of {n} processes still running "
                    f"after {timeout_s:g} s")
            try:
                msg = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [p for rank, p in enumerate(procs)
                        if rank not in out and p.exitcode is not None]
                if dead:
                    # one last look: its report may have been in flight
                    try:
                        msg = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: process {procs.index(dead[0])} exited "
                            f"with code {dead[0].exitcode} without a result")
                else:
                    continue
            if msg[0] == "error":
                _, rank, exc, tb = msg
                raise exc from _RemoteTraceback(f"\nprocess {rank}:\n{tb}")
            out[msg[1]] = msg[2]
        return [out[rank] for rank in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)


# --- tensor-parallel collectives --------------------------------------------
#
# The residual stream is replicated over tp; the projections that read it
# are column-sharded and those that write it row-sharded. `enter` marks a
# replicated tensor about to feed a sharded computation: each rank's
# gradient then holds only its shard's part, so the backward sums them.
# `exit_` sums the partial products of a row-sharded matmul; its backward
# passes the (replicated) gradient through. Sums run in f32 for f32 and
# bf16 tensors alike; at one rank every collective is the identity.


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, in f32, returned in x's dtype (a new tensor)."""
    acc = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_grads):
        ctx.dim, ctx.group, ctx.sum_grads = dim, group, sum_grads
        ctx.size = x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grads:
            grad = _sum(grad, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over `group` backward."""
    return _Enter.apply(x, group)


def exit_(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` forward; the gradient passes through backward."""
    return _Exit.apply(x, group)


def gather(x: torch.Tensor, dim: int, group, sum_grads: bool) -> torch.Tensor:
    """The shards of `group`, concatenated along `dim` in rank order.

    Backward, each rank takes its own slice of the gradient: summed over
    the group first when the ranks use the gathered tensor for different
    work (`sum_grads`, the sequence-parallel K/V), as it is when they all
    compute the same thing from it (the tp-sharded embedding)."""
    return _Gather.apply(x, dim, group, sum_grads)


def all_reduce_grads(grads: List[torch.Tensor], groups) -> List[torch.Tensor]:
    """`grads` summed over each group in `groups`, as one flat f32 buffer
    per group; returns new tensors of the grads' shapes and dtypes."""
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    for group in groups:
        dist.all_reduce(flat, group=group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out


# --- pipeline stages ------------------------------------------------------
#
# Stage k runs layers [k L/pp, (k + 1) L/pp) and hands its output to the
# rank of the same (dp, sp, ep, tp) place on stage k + 1. The send is the
# end of an earlier stage's loss: a zero that, differentiated, receives the
# gradient of what it sent; the receive sends the gradient back. Peers are
# global ranks.


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst):
        ctx.dst, ctx.meta = dst, (x.shape, x.dtype, x.device)
        dist.send(x.contiguous(), dst)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, ctx.dst)
        return grad, None


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, like, src):
        ctx.src = src
        x = torch.empty_like(like)
        dist.recv(x, src)
        return x

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.src)
        return None, None


def pipe_send(x: torch.Tensor, dst: int) -> torch.Tensor:
    """Sends x to global rank `dst`; returns an f32 zero whose backward
    receives x's gradient from `dst` (the sending stage's loss)."""
    return _Send.apply(x, dst)


def pipe_recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """The tensor global rank `src` sends, of `like`'s shape and dtype; its
    gradient is sent back to `src` in the backward, and `like` gets none
    (`like` only ties the receive into the graph)."""
    return _Recv.apply(like, src)


# --- top-1 routing over a sharded batch -------------------------------------


def queue_offsets(counts: torch.Tensor, dp=None, sp=None) -> torch.Tensor:
    """How many tokens of the global batch reach each expert ahead of each
    of this rank's rows.

    The global token order is b-major: row by row, each row's sp blocks in
    order. `counts` (rows, E) holds, per row of this rank's (dp, sp) block
    and per expert, the block's tokens routed there; `dp` and `sp` are this
    rank's (group, index) on each axis, or None for an axis of one rank.
    Returns (rows, E): the tokens routed to each expert before the row's
    first token here. Only the counts cross ranks (an all-gather over sp,
    then over dp)."""
    blocks = counts[None]                              # (sp, rows, E)
    if sp is not None:
        blocks = _all_gather(blocks, 0, sp[0])
    blocks = blocks[None]                              # (dp, sp, rows, E)
    if dp is not None:
        blocks = _all_gather(blocks, 0, dp[0])
    n_dp, n_sp, rows, e = blocks.shape
    order = blocks.transpose(1, 2).reshape(-1, e)      # b-major
    before = (order.cumsum(0) - order).view(n_dp, rows, n_sp, e)
    return before[0 if dp is None else dp[1], :, 0 if sp is None else sp[1]]
