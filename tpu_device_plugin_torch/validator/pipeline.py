"""GPipe: microbatched pipeline parallelism over the `pp` mesh axis.

Port of `tpu_device_plugin/validator/pipeline.py`. Each pp stage holds its
n_layers/pp layers of the stacked weights (embed and unembed are whole on
every stage) and runs the classic fill/drain schedule over `n_micro`
microbatches of its dp rows:

- fill: stage s takes microbatch m from stage s-1 (stage 0 embeds it),
  runs its layers, and hands the output to stage s+1; the last stage takes
  each microbatch's loss;
- drain: the microbatches in reverse, each stage receiving the gradient
  of its output from stage s+1 (the last stage starts from its loss),
  running its backward, and sending the gradient of its input to s-1.

The JAX version is one `lax.scan` in which every stage computes at every
step (the fill and drain steps on clamped garbage) and JAX transposes the
`ppermute` schedule into the backward sweep. The port computes what that
schedule computes, not its lockstep: each stage runs only its own
microbatches, and the sends and receives stay outside autograd. A stage
keeps each microbatch's input (as a leaf that requires grad) and output,
and in the drain calls `torch.autograd.backward(output, grad)` itself, so
no backward ever waits inside the autograd engine, which runs every CUDA
backward of a device on one thread (stages as threads of one process
would otherwise deadlock there).

Where the stages' traffic lives: a link with `index`, `size`, `send`,
`recv` and `sum` (over the stages). `ProcessGroupLink` is a pipeline of
processes (global ranks of the pp group); `ThreadLink` is a pipeline of
threads in one process, the one-card stand-in (NCCL refuses two ranks on
one card), as ring_attention.py's `ThreadRing` is for the ring.

Scope, as in the JAX version: attention is einsum by construction, and the
mesh's sp, tp and ep axes must be 1 (dp composes: gradients are summed
over it).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from .ring_attention import _event, _take
from .workload import (ModelConfig, Params, _bf16, _layers, _leaves,
                       _named_leaves, _nll_sum, _place, _sgd_update,
                       _token_rows, _with_leaves, resolve_device)


class ProcessGroupLink:
    """The stages of a pipeline as processes: `ranks` are the global ranks
    of the pp group in stage order, `group` the group itself; this process
    is stage `index`."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.index = dist.get_rank(group)
        self.size = len(self.ranks)

    def send(self, t: torch.Tensor, stage: int) -> None:
        import torch.distributed as dist
        dist.send(t.contiguous(), self.ranks[stage])

    def recv(self, shape, dtype, device, stage: int) -> torch.Tensor:
        import torch.distributed as dist
        t = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(t, self.ranks[stage])
        return t

    def sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """`tensors` summed over the stages (one flat f32 all-reduce)."""
        from .distributed import all_reduce_grads
        return all_reduce_grads(list(tensors), [self.group])


class ThreadLink:
    """The stages of a pipeline as `size` threads of one process:
    `member(i)` is stage i's link (see `ring_attention.run_on_threads`,
    which runs one function per member, each thread on its own CUDA
    stream).

    A send hands the receiver the tensor itself, with
    `ring_attention._event` and `_take`; a sender never writes a tensor it
    has sent. A thread that fails aborts the link, so the others raise
    instead of waiting."""

    def __init__(self, size: int, timeout_s: float = 300.0):
        self.size, self.timeout_s = size, timeout_s
        self._boxes: Dict[tuple, queue.Queue] = {
            (src, dst): queue.Queue() for src in range(size)
            for dst in range(size) if abs(src - dst) == 1}
        self._barrier = threading.Barrier(size, timeout=timeout_s)
        self._slots: List[Optional[tuple]] = [None] * size
        self._aborted = threading.Event()

    def member(self, index: int) -> "_ThreadLinkMember":
        return _ThreadLinkMember(self, index)

    def abort(self) -> None:
        self._aborted.set()
        self._barrier.abort()


class _ThreadLinkMember:
    def __init__(self, link: ThreadLink, index: int):
        self._link, self.index, self.size = link, index, link.size

    def send(self, t: torch.Tensor, stage: int) -> None:
        self._link._boxes[(self.index, stage)].put((t, _event(t)))

    def recv(self, shape, dtype, device, stage: int) -> torch.Tensor:
        link = self._link
        box = link._boxes[(stage, self.index)]
        deadline = time.monotonic() + link.timeout_s
        while True:
            if link._aborted.is_set():
                raise RuntimeError(f"stage {self.index}: the pipeline was "
                                   "aborted by another stage's failure")
            try:
                t, event = box.get(timeout=0.05)
                break
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"stage {self.index}: nothing from stage {stage} "
                        f"after {link.timeout_s:g} s")
        if (tuple(t.shape), t.dtype) != (tuple(shape), dtype):
            raise RuntimeError(f"stage {self.index} expected {tuple(shape)} "
                               f"{dtype} from stage {stage}, got "
                               f"{tuple(t.shape)} {t.dtype}")
        _take([t], event)
        return t

    def sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """`tensors` summed over the stages, in stage order, in f32."""
        link = self._link
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        link._slots[self.index] = (flat, _event(flat))
        link._barrier.wait()
        total = None
        for other, event in link._slots:
            _take([other], event)
            total = other.clone() if total is None else total + other
        link._barrier.wait()   # every slot read before any is written again
        out, at = [], 0
        for t in tensors:
            out.append(total[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out


def check_gpipe(cfg: ModelConfig, sizes: Dict[str, int], n_micro: int,
                local_batch: int) -> None:
    """The JAX version's checks of a GPipe configuration, with its
    wording: `sizes` are the mesh's {axis: size} (pp present only when it
    is larger than 1, as `mesh.mesh_dims` gives them) and `local_batch`
    one dp rank's rows. Raises ValueError."""
    if "pp" not in sizes:
        raise ValueError("gpipe path needs a 'pp' mesh axis "
                         "(slice_mesh(..., pp=N) with N > 1)")
    if any(sizes.get(axis, 1) != 1 for axis in ("sp", "tp", "ep")):
        # ep would silently replicate the whole pipeline per expert rank
        # (no expert dispatch in this schedule)
        raise ValueError("gpipe path needs sp == tp == ep == 1 (pp x dp mesh)")
    if cfg.n_layers % sizes["pp"]:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={sizes['pp']}")
    if n_micro < 1:
        raise ValueError(f"n_micro={n_micro} must be at least 1")
    if local_batch % n_micro:
        raise ValueError(f"local batch {local_batch} not divisible by "
                         f"n_micro={n_micro}")


def _stages(mesh, link):
    """(link, dp group or None, {axis: size}) of a GPipe run: the pp group
    of `mesh` as processes, or, without a mesh, `link` (a `ThreadLink`
    member: stages as threads, dp 1)."""
    if mesh is not None:
        from .mesh import mesh_shape
        sizes = mesh_shape(mesh)
        if "pp" not in sizes:
            return None, None, sizes
        return (ProcessGroupLink(mesh.get_group("pp")), mesh.get_group("dp"),
                sizes)
    if link is None:
        return None, None, {}
    return link, None, ({"pp": link.size, "dp": 1} if link.size > 1
                        else {"dp": 1})


def _stage_apply(x: torch.Tensor, layers: Params,
                 cfg: ModelConfig) -> torch.Tensor:
    """This stage's layers, the workload's block with einsum attention (as
    the JAX version fixes it); under `cfg.remat` each layer is recomputed
    in the backward, keeping one activation per layer and microbatch."""
    return _layers(x, layers, cfg, "einsum", None)


def _schedule(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
              n_micro: int, link, dp: int, backward: bool) -> torch.Tensor:
    """This stage's part of the loss, the fill over `n_micro` microbatches
    of `tokens` (this rank's rows); with `backward`, then the drain, which
    leaves the gradients in the leaves' `.grad`. The part is the last
    stage's summed NLL over the global batch's (rows x (seq - 1))
    positions, 0 on the other stages."""
    b, seq = tokens.shape
    micro = tokens.view(n_micro, b // n_micro, seq)
    first, last = link.index == 0, link.index == link.size - 1
    shape = (b // n_micro, seq, cfg.d_model)
    local = torch.zeros((), dtype=torch.float32, device=tokens.device)
    kept = []   # (input, output) of each microbatch, for the drain
    for rows in micro:
        if first:
            x = _bf16(params["embed"])[rows]
        else:
            x = link.recv(shape, torch.bfloat16, tokens.device,
                          link.index - 1)
            x.requires_grad_(backward)
        y = _stage_apply(x, params["layers"], cfg)
        if last:
            y = (_nll_sum(params, y, rows[:, 1:], None, cfg)
                 / (b * dp * (seq - 1)))
            local = local + y.detach()
        else:
            link.send(y.detach(), link.index + 1)
        kept.append((x, y))
    if backward:
        while kept:
            x, y = kept.pop()
            grad = (None if last else
                    link.recv(y.shape, y.dtype, y.device, link.index + 1))
            torch.autograd.backward(y, grad)
            if not first:
                link.send(x.grad, link.index - 1)
    return local


def _resolve_stages(tokens: torch.Tensor, cfg: ModelConfig, mesh,
                    n_micro: int, link):
    link, dp_group, sizes = _stages(mesh, link)
    check_gpipe(cfg, sizes, n_micro, tokens.shape[0])
    return link, dp_group, sizes.get("dp", 1)


def gpipe_value_and_grad(params: Params, tokens: torch.Tensor,
                         cfg: ModelConfig, mesh, n_micro: int, link=None):
    """(loss, grads) of the GPipe schedule: `params` are this stage's
    (its layers, embed and unembed whole), `tokens` this rank's dp rows.

    The loss is the mean NLL over every (microbatch, row, position),
    summed over pp (only the last stage's part is not 0) and over dp (each
    part is already divided by dp), as the JAX version's psum and pmean.
    Each leaf's gradient is summed over dp, and embed's (stage 0's only)
    and unembed's (the last stage's only) over pp too, as the stage-cut
    path's `workload._grad_axes`. Every rank gets the global loss."""
    link, dp_group, dp = _resolve_stages(tokens, cfg, mesh, n_micro, link)
    named = _named_leaves(params)
    leaves = [p.detach().requires_grad_() for _, p in named]
    with torch.enable_grad():
        local = _schedule(_with_leaves(params, leaves), tokens, cfg, n_micro,
                          link, dp, backward=True)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    whole = [i for i, (key, _) in enumerate(named)
             if not key.startswith("layers.")]
    summed = link.sum([local] + [grads[i] for i in whole])
    loss = summed[0]
    for i, g in zip(whole, summed[1:]):
        grads[i] = g
    if dp_group is not None:
        from .distributed import all_reduce_grads
        loss, *grads = all_reduce_grads([loss] + grads, [dp_group])
    return loss, _with_leaves(params, grads)


def gpipe_loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  mesh, n_micro: int, link=None) -> torch.Tensor:
    """The loss of the GPipe schedule, forward only (the fill): the same
    value `gpipe_value_and_grad` returns. `mesh` holds the pp (and dp)
    axes; without one, `link` is this thread's `ThreadLink` member."""
    link, dp_group, dp = _resolve_stages(tokens, cfg, mesh, n_micro, link)
    with torch.no_grad():
        local = _schedule(params, tokens, cfg, n_micro, link, dp,
                          backward=False)
    loss, = link.sum([local])
    if dp_group is not None:
        from .distributed import all_reduce_grads
        loss, = all_reduce_grads([loss], [dp_group])
    return loss


def build_gpipe(cfg: ModelConfig, mesh, n_micro: int, seed: int = 0,
                lr: Optional[float] = None, device=None, link=None):
    """(step, params, momentum, tokens) of the GPipe path on this rank.

    Params come from `seed` as `workload.build_workload`'s do; this
    stage keeps its n_layers/pp layers and the whole embed and unembed.
    Tokens are this rank's dp rows (from `seed + 1`). `step(params,
    momentum, tokens) -> (params, momentum, loss)` is SGD with momentum
    on `gpipe_value_and_grad`, in place. `mesh` holds the pp (and dp) axes
    over processes; without one, `link` is this thread's `ThreadLink`
    member (stages as threads of one process, dp 1). Raises ValueError on
    a configuration the schedule cannot run (`check_gpipe`)."""
    dev = resolve_device(device)
    lr = cfg.lr if lr is None else lr
    link, _, sizes = _stages(mesh, link)
    dp = sizes.get("dp", 1)
    if cfg.batch % dp:
        raise ValueError(f"batch {cfg.batch} not divisible by dp={dp}")
    check_gpipe(cfg, sizes, n_micro, cfg.batch // dp)
    params, tokens = _place(cfg, dev, seed)
    if mesh is not None:
        tokens = _token_rows(tokens, mesh)
    per_stage = cfg.n_layers // link.size
    start = link.index * per_stage
    params["layers"] = {key: w[start:start + per_stage].clone()
                        for key, w in params["layers"].items()}
    momentum = _with_leaves(params, [torch.zeros_like(p)
                                     for p in _leaves(params)])

    def step(p: Params, m: Params, t: torch.Tensor):
        loss, grads = gpipe_value_and_grad(p, t, cfg, mesh, n_micro, link)
        _sgd_update(p, m, grads, cfg.momentum, lr)
        return p, m, loss

    return step, params, momentum, tokens
