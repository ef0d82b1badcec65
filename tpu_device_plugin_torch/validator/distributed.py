"""Processes, groups and the collectives of the port's mesh.

The JAX package has no counterpart: there, sharding annotations
(`workload.param_specs`, `with_sharding_constraint`) let XLA's partitioner
insert every collective. The port runs eagerly, so each collective is an
explicit `torch.distributed` call over a group of the `DeviceMesh`
(mesh.py): NCCL on the cards, gloo on the CPU.

- `join` composes one world from several guest processes (the probe's
  `--coordinator`), each holding some of a slice's devices, over a
  `TCPStore` that process 0 hosts: it returns this guest's `World`.
- `spawn` runs one function in n processes, one per device, and returns
  what each returned; given a `World`, they are this guest's ranks of it.
- `enter`, `exit_`, `gather` are the autograd-aware collectives of
  Megatron-style tensor parallelism; `all_reduce_grads` sums gradients
  over the groups on which a leaf's rank holds only a partial.
- `pipe_send`, `pipe_recv` move activations between pipeline stages, and
  their gradients back in the backward.
- `queue_offsets` gives top-1 routing its global token order: each rank's
  place in every expert's queue over the whole (dp, sp)-sharded batch.

Nothing here starts a process or opens a file or a socket at import.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import queue
import shutil
import socket
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class _RemoteTraceback(Exception):
    """A child's traceback, chained to the exception the parent re-raises."""

    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self) -> str:
        return self.tb


class World:
    """This guest process's place in a world joined over several guests
    (`join`): global ranks `offset` .. `offset + local - 1` of `size`, in
    the order of the process ids, then of each process's local devices.

    The store stays open until `close`, which marks this process done
    with it; process 0, which hosts it, then waits (at most `timeout_s`)
    until every process is done, so a slow guest never finds it gone.
    Use it as a context manager to close it."""

    def __init__(self, host: str, port: int, process_id: int,
                 counts: Sequence[int], kinds: Sequence[str],
                 timeout_s: float, store, join_s: float):
        self.host, self.port, self.process_id = host, port, process_id
        self.counts = tuple(counts)    # local devices of each process, by id
        self.kinds = list(kinds)       # every device's name, sorted, unique
        self.timeout_s = timeout_s
        self.join_s = join_s           # seconds the rendezvous took
        self._store = store
        self._spawns = 0

    @property
    def offset(self) -> int:
        return sum(self.counts[:self.process_id])

    @property
    def local(self) -> int:
        return self.counts[self.process_id]

    @property
    def size(self) -> int:
        return sum(self.counts)

    def rendezvous(self) -> Tuple[str, int, str]:
        """(host, port, key prefix) for the group of the next `spawn`.
        Every guest runs the same sequence of spawns, so the k-th spawn of
        each one meets the others' k-th under one prefix."""
        self._spawns += 1
        return self.host, self.port, f"spawn{self._spawns}/"

    def close(self) -> None:
        """Marks this process done; on process 0, waits for every other."""
        if self._store is None:
            return
        store, self._store = self._store, None
        store.set(f"done/{self.process_id}", "1")
        if self.process_id == 0:
            try:
                store.wait([f"done/{i}" for i in range(len(self.counts))],
                           datetime.timedelta(seconds=self.timeout_s))
            except dist.DistStoreError:
                # a guest that never finished reports its own failure;
                # this one's report is already out
                pass

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def join(coordinator: str, num_processes: Optional[int],
         process_id: Optional[int], local_kinds: Sequence[str],
         timeout_s: float) -> World:
    """Join the world of `num_processes` guest processes at `coordinator`
    ("host:port"): process 0 hosts a `TCPStore` there, the others connect
    to it; each puts the names of its local devices (`local_kinds`, one
    per device) under its id and waits for every other's. Connecting and
    waiting share one deadline, `timeout_s` from the call.

    Raises ValueError for a missing or bad argument, TimeoutError for a
    coordinator that never accepts a connection, and the store's error (a
    `torch.distributed.DistError`) for a port that cannot be bound or a
    process that never came, each within the deadline."""
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs --num-processes and "
                         "--process-id")
    if num_processes < 1:
        raise ValueError(f"--num-processes must be >= 1, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in "
                         f"[0, {num_processes})")
    if not local_kinds:
        raise ValueError("this process has no local device to join with")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    start = time.monotonic()
    deadline = start + timeout_s

    def left() -> datetime.timedelta:
        return datetime.timedelta(seconds=max(deadline - time.monotonic(),
                                              1e-3))

    if process_id != 0:
        _await_listener(host, int(port), deadline, timeout_s)
    store = dist.TCPStore(host, int(port), is_master=process_id == 0,
                          timeout=left())
    store.set(f"devices/{process_id}", json.dumps(list(local_kinds)))
    keys = [f"devices/{i}" for i in range(num_processes)]
    store.wait(keys, left())
    per_process = [json.loads(store.get(key)) for key in keys]
    return World(host, int(port), process_id,
                 [len(kinds) for kinds in per_process],
                 sorted({k for kinds in per_process for k in kinds}),
                 timeout_s, store, time.monotonic() - start)


def _await_listener(host: str, port: int, deadline: float,
                    timeout_s: float) -> None:
    """Returns once something accepts connections at host:port; raises
    TimeoutError at `deadline` (a monotonic time). The store client's own
    connect retries once more past its timeout (12.8 s for 5 s on an H100
    host), so a coordinator that never comes is timed here."""
    while True:
        try:
            with socket.create_connection(
                    (host, port), timeout=max(deadline - time.monotonic(),
                                              1e-3)):
                return
        except OSError as exc:
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(
                    f"timed out after {timeout_s:g} s waiting for the "
                    f"coordinator at {host}:{port}") from exc
            time.sleep(min(0.1, deadline - now))


def _child(local: int, rank: int, n: int, device_type: str, rendezvous,
           timeout_s: float, results, fn: Callable, args: Sequence,
           mesh_kw: Optional[Dict[str, Any]]) -> None:
    """One spawned process: join the group (rank `rank` of n, on local
    device `local`), build the mesh, run `fn`, put ("ok", local, result)
    or ("error", rank, exception, traceback). `rendezvous` is a `file://`
    init method, or a world's (host, port, prefix)."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(local)
        else:
            # n processes of one host side by side: one intra-op thread each
            torch.set_num_threads(1)
        timeout = datetime.timedelta(seconds=timeout_s)
        if isinstance(rendezvous, str):
            how = dict(init_method=rendezvous)
        else:
            host, port, prefix = rendezvous
            how = dict(store=dist.PrefixStore(prefix, dist.TCPStore(
                host, port, is_master=False, timeout=timeout)))
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            world_size=n, rank=rank, timeout=timeout, **how)
        try:
            mesh = None
            if mesh_kw is not None:
                from .mesh import slice_mesh
                mesh = slice_mesh(n, device_type=device_type, **mesh_kw)
            out = fn(rank, mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", local, out))
    except BaseException as exc:   # reported to the parent, which re-raises
        tb = traceback.format_exc()
        try:
            results.put(("error", rank, exc, tb))
        except Exception:   # an exception that does not pickle
            results.put(("error", rank, RuntimeError(repr(exc)), tb))


def spawn(fn: Callable, n: int, device_type: str = "cpu",
          timeout_s: float = 300.0, args: Sequence = (),
          mesh: Optional[Dict[str, Any]] = None,
          world: Optional[World] = None) -> List[Any]:
    """Run `fn(rank, mesh, *args)` in n fresh processes; returns the n
    results in local order.

    Without `world`, the processes are ranks 0 .. n-1 of one group of n,
    rendezvousing through a file in a new temporary directory (no TCP
    port, so parallel callers never collide). With a `World` (`join`),
    n must be its `local` count: they are ranks `world.offset` .. of one
    group of `world.size`, rendezvousing through the world's store, with
    the other guests' processes. Each uses local device i (NCCL on
    "cuda", gloo with one thread on "cpu") and builds
    `mesh.slice_mesh(group size, **mesh)` when `mesh` is given (else it
    passes None). `fn` and `args` are pickled: `fn` must be a
    module-level function of a module the child can import.

    The first child exception is re-raised here, chained to the child's
    traceback; a child that dies without reporting, or a run past
    `timeout_s`, raises RuntimeError or TimeoutError. Every child is
    killed and joined before this returns or raises."""
    if n < 1:
        raise ValueError(f"spawn needs n >= 1, got {n}")
    if world is not None and n != world.local:
        raise ValueError(f"spawn of {n} processes in a world where this "
                         f"process holds {world.local} devices")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = None
    if world is None:
        first, size = 0, n
        tmp = Path(tempfile.mkdtemp(prefix="tdp-spawn-"))
        rendezvous = f"file://{tmp / 'rendezvous'}"
    else:
        first, size = world.offset, world.size
        rendezvous = world.rendezvous()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(local, first + local, size, device_type,
                               rendezvous, timeout_s, results, fn,
                               tuple(args), mesh))
             for local in range(n)]
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
                dead = [p for local, p in enumerate(procs)
                        if local not in out and p.exitcode is not None]
                if dead:
                    # one last look: its report may have been in flight
                    try:
                        msg = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: process {first + procs.index(dead[0])} "
                            f"exited with code {dead[0].exitcode} without a "
                            "result")
                else:
                    continue
            if msg[0] == "error":
                _, rank, exc, tb = msg
                raise exc from _RemoteTraceback(f"\nprocess {rank}:\n{tb}")
            out[msg[1]] = msg[2]
        return [out[local] for local in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        results.join_thread()
        if tmp is not None:
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
