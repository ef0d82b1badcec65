"""Ring-flash vs einsum-ring benchmark over an sp ring.

Port of `tpu_device_plugin/validator/ring_bench.py`: times the ring with
the flash kernels in each step (`ring_attention.ring_flash_forward` and
`_backward`: K1, then K2 and K3 with f32 outputs) against the einsum ring
(`ring_einsum_forward`, `_backward`), at GLOBAL sequence lengths split
over sp ranks:

    python -m tpu_device_plugin_torch.validator --mode ring-bench \\
        --seqs 4096,8192 --sp 2 --repeats 4

Which ring runs (the result's "ring"):

- "processes": sp 1 in this process, or, with sp up to the visible cards,
  one process per card (`distributed.spawn`, `ProcessGroupRing` over
  NCCL); rank 0's times are reported;
- "threads": sp larger than the visible cards (one card, or the CPU):
  sp threads of this process on one device, each on its own stream
  (`ThreadRing`), as chip_smoke.py runs the ring on one card.

Both call the plain forward and backward functions, not autograd: the
autograd engine runs every CUDA backward of a device on one thread, where
ring members that are threads would wait for each other. A training
iteration is the forward, then the backward of sum(o.float() ** 2), whose
three gradients feed the next iteration (attn_bench.py's chain).

Timing is timing.py's chained differencing, shared with attn_bench, so the
two sweeps cannot drift.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .timing import paired_time as _paired_time


def _fwd_member(forward, sm: float, repeats: int):
    """ring member fn(ring, q, k, v) -> scalar: `repeats` dependent ring
    forwards (each output feeds the next q)."""
    def run(ring, q, k, v):
        with torch.no_grad():
            for _ in range(max(repeats, 1)):
                q = forward(q, k, v, sm, ring)[0]
            return q.float().sum()
    return run


def _train_member(forward, backward, sm: float, repeats: int):
    """The same for training iterations: all three gradients carried (dq
    becomes q, dk and dv perturb k and v)."""
    def run(ring, q, k, v):
        with torch.no_grad():
            for _ in range(max(repeats, 1)):
                o, lse = forward(q, k, v, sm, ring)
                # d sum(o.float() ** 2) / do, in o's dtype
                do = (2 * o.float()).to(o.dtype)
                dq, dk, dv = backward(q, k, v, o, lse, do, sm, ring)
                q, k, v = (dq, k + (0.001 * dk).to(k.dtype),
                           v + (0.001 * dv).to(v.dtype))
            return sum(x.float().sum() for x in (q, k, v))
    return run


def _shards(hb: int, seq: int, head_dim: int, sp: int, indices, dev):
    """{ring index: (q, k, v)} of the global bf16 (hb, seq, head_dim)
    tensors from seeds 1, 2, 3, each cut into sp blocks of the sequence."""
    full = []
    for seed in (1, 2, 3):
        gen = torch.Generator(dev).manual_seed(seed)
        full.append(torch.randn((hb, seq, head_dim), generator=gen,
                                device=dev).to(torch.bfloat16))
    return {i: tuple(t.chunk(sp, 1)[i].contiguous() for t in full)
            for i in indices}


def _cells(seq_lens, blocks, sp: int, hb: int, head_dim: int, iters: int,
           repeats: int, dev, run, indices) -> list:
    """Every cell of the sweep; `run(member_fn)` runs member_fn(ring) on
    each ring member this process drives (`indices`) and returns their
    results."""
    from . import ring_attention as ra
    from .attn_bench import launched
    from .flash_attention import launches
    sm = head_dim ** -0.5
    cells = []
    for seq in seq_lens:
        shards = _shards(hb, seq, head_dim, sp, indices, dev)
        reps = (max(2, min(2048, int(repeats * (8192 / seq) ** 2)))
                if repeats > 1 else repeats)

        def chain(member):
            def build(r):
                one = member(r)

                def fn(parts):
                    outs = run(lambda ring: one(ring, *parts[ring.index]))
                    return sum(o.to(dev) for o in outs)
                return fn
            return build

        def measure(forward, backward, label):
            try:
                before = dict(launches)
                fwd_s = _paired_time(
                    chain(lambda r: _fwd_member(forward, sm, r)), (shards,),
                    iters, reps)
                fwd_launches = launched(before)
                before = dict(launches)
                train_s = _paired_time(
                    chain(lambda r: _train_member(forward, backward, sm, r)),
                    (shards,), iters, reps)
                return fwd_s, train_s, "", (fwd_launches, launched(before))
            except Exception as exc:   # the einsum ring runs out first
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                return (None, None, f"{label}: {type(exc).__name__}: {exc}",
                        (None, None))

        ein_fwd, ein_train, ein_err, _ = measure(
            ra.ring_einsum_forward, ra.ring_einsum_backward, "einsum-ring")
        for bq, bk in blocks:
            fl_fwd, fl_train, fl_err, (fwd_launches, train_launches) = measure(
                ra.ring_flash_forward, ra.ring_flash_backward, "ring-flash")

            def ms(s):
                return None if s is None else s * 1e3

            cells.append({
                "seq": seq, "sp": sp, "block_q": bq, "block_k": bk,
                "reps": reps,
                "ring_flash_fwd_ms": ms(fl_fwd),
                "einsum_ring_fwd_ms": ms(ein_fwd),
                "ring_flash_train_ms": ms(fl_train),
                "einsum_ring_train_ms": ms(ein_train),
                "fwd_speedup": (ein_fwd / fl_fwd
                                if ein_fwd is not None and fl_fwd else None),
                "train_speedup": (ein_train / fl_train
                                  if ein_train is not None and fl_train
                                  else None),
                "ring_flash_fwd_launches": fwd_launches,
                "ring_flash_train_launches": train_launches,
                "error": "; ".join(x for x in (ein_err, fl_err) if x),
            })
        del shards
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return cells


def _bench_rank(rank: int, _mesh, seq_lens, blocks, sp: int, hb: int,
                head_dim: int, iters: int, repeats: int):
    """One process of a ring of processes (run by `distributed.spawn`):
    its ring member's timings; rank 0's cells are returned."""
    import torch.distributed as dist

    from .ring_attention import ProcessGroupRing
    ring = ProcessGroupRing(dist.group.WORLD)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() and dist.get_backend() == "nccl"
           else torch.device("cpu"))
    cells = _cells(seq_lens, blocks, sp, hb, head_dim, iters, repeats, dev,
                   lambda fn: [fn(ring)], [rank])
    return cells if rank == 0 else None


def bench_ring(
    seq_lens: Sequence[int] = (4096, 8192),
    blocks: Sequence[Tuple[int, int]] = ((128, 128),),
    sp=None,
    hb: int = 8,
    head_dim: int = 128,
    iters: int = 5,
    repeats: int = 1,
    device=None,
) -> dict:
    """Time the flash ring against the einsum ring on an sp ring (CUDA
    unless `device` says otherwise; sp defaults to the visible cards).

    `seq_lens` are GLOBAL lengths; each rank holds seq/sp. Returns {"cells":
    [...], "ring_flash_wins_at": [...], "ring": "processes" or "threads",
    ...}; a speedup > 1 means the flash ring is faster. Raises ValueError
    where a length does not divide by sp or a block is not the compiled
    tile."""
    from .attn_bench import check_tiles
    from .ring_attention import ThreadRing, run_on_threads
    from .workload import resolve_device

    check_tiles(blocks)
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    sp = max(cards, 1) if sp is None else sp
    for seq in seq_lens:
        if seq % sp:
            raise ValueError(f"seq {seq} not divisible by sp={sp}")
    args = (tuple(seq_lens), tuple(blocks), sp, hb, head_dim, iters, repeats)
    if sp == 1:
        member = ThreadRing(1).member(0)
        cells = _cells(*args, dev, lambda fn: [fn(member)], [0])
        ring = "processes"
    elif sp <= cards:
        from .distributed import spawn
        cells = spawn(_bench_rank, sp, "cuda", timeout_s=1800.0,
                      args=args)[0]
        ring = "processes"
    else:
        cells = _cells(*args, dev,
                       lambda fn: run_on_threads(sp, fn, device=dev),
                       range(sp))
        ring = "threads"
    wins = sorted({c["seq"] for c in cells
                   if (c["train_speedup"] or 0) > 1.0})
    on_card = dev.type == "cuda"
    return {
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "platform": "gpu" if on_card else dev.type,
        # the kernels ran only on the card; elsewhere their plain versions
        "interpret": not on_card,
        "sp": sp, "hb": hb, "head_dim": head_dim,
        "ring": ring,
        "cells": cells,
        "ring_flash_wins_at": wins,
        "ring_flash_ok": bool(cells) and all(
            c["ring_flash_fwd_ms"] is not None for c in cells),
    }
