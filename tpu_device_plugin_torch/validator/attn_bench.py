"""Flash-vs-einsum attention benchmark on one card.

Port of `tpu_device_plugin/validator/attn_bench.py`: forward and training
timings of the flash kernels (K1 forward, K2 and K3 backward, through
`flash_attention`) against the einsum reference, across sequence lengths,
in one command:

    python -m tpu_device_plugin_torch.validator --mode attn-bench \\
        --seqs 1024,2048,4096 --repeats 4

Returns one cell per sequence length plus a summary; the crossover it
measures sets `workload.FLASH_MIN_SEQ`. The kernels' tiles are compile-time
constants (`flash_attention.FWD_BLOCK`, `BWD_BLOCK`), so `blocks` and
`bwd_blocks` can only name them. On the CPU the kernels' plain versions
run (`interpret` is true): keep seqs small there.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch

# module-level name so tests can monkeypatch the timing seam
from .timing import paired_time as _paired_time  # noqa: E402


def check_tiles(blocks: Sequence[Tuple[int, int]],
                bwd_blocks: Sequence[Optional[Tuple[int, int]]] = (None,)
                ) -> None:
    """Raises ValueError unless every block is the compiled forward tile
    and every backward block the compiled backward pair (None: the
    compiled one)."""
    from .flash_attention import BWD_BLOCK, FWD_BLOCK
    bad = [b for b in blocks if tuple(b) != FWD_BLOCK]
    bad += [b for b in bwd_blocks if b is not None and tuple(b) != BWD_BLOCK]
    if bad:
        raise ValueError(
            f"tiles {bad} are not compiled: the kernels' tiles are "
            "compile-time constants; blocks takes {0}x{1} (K1), bwd blocks "
            "{2}x{3} (K3's query blocks x K2's key blocks)".format(
                *FWD_BLOCK, *BWD_BLOCK))


def _chain_fwd(fn_one, repeats: int):
    """fn(q, k, v) -> scalar: `repeats` serially dependent forwards (each
    output feeds the next call's q, so no call can be skipped or
    overlapped), reduced to one float so fetching it waits for them all."""
    def run(q, k, v):
        with torch.no_grad():
            for _ in range(max(repeats, 1)):
                q = fn_one(q, k, v)
            return q.float().sum()
    return run


def _chain_train(grad_fn, repeats: int):
    """Same, for a grad fn returning (dq, dk, dv). All three feed the next
    iteration's inputs (dq becomes q; dk and dv perturb k and v), as the
    JAX version carries them so that XLA cannot drop the dK/dV work; here
    it keeps every iteration's inputs those of a real training chain."""
    def run(q, k, v):
        for _ in range(max(repeats, 1)):
            dq, dk, dv = grad_fn(q, k, v)
            q, k, v = (dq, k + (0.001 * dk).to(k.dtype),
                       v + (0.001 * dv).to(v.dtype))
        return sum(x.float().sum() for x in (q, k, v))
    return run


def _grad_of(attend):
    """(q, k, v) -> (dq, dk, dv) of sum(attend(q, k, v).float() ** 2)."""
    def grad(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            loss = (attend(q, k, v).float() ** 2).sum()
            return torch.autograd.grad(loss, (q, k, v))
    return grad


def launched(before: dict) -> dict:
    """Kernel launches since `before` (a copy of `flash_attention.launches`)."""
    from .flash_attention import launches
    return {name: launches[name] - before[name] for name in launches}


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def bench_attention(
    seq_lens: Sequence[int] = (1024, 2048, 4096),
    blocks: Sequence[Tuple[int, int]] = ((128, 128),),
    hb: int = 8,
    head_dim: int = 128,
    iters: int = 10,
    causal: bool = True,
    device=None,
    bwd_blocks: Sequence[Optional[Tuple[int, int]]] = (None,),
    repeats: int = 1,
) -> dict:
    """Compare the flash kernels with the einsum reference on one device
    (CUDA unless `device` says otherwise), in bf16.

    Returns {"cells": [...], "flash_wins_at": [...], "device_kind": ...}.
    Each cell: seq, the tiles, flash/einsum forward and train ms, speedups
    (> 1 means flash is faster), and the kernel launches of each flash
    chain. An einsum failure (out of memory at long seq) is recorded in
    its cell and the sweep goes on."""
    from . import flash_attention as fa
    from .workload import resolve_device

    check_tiles(blocks, bwd_blocks)
    dev = resolve_device(device)
    iters = max(iters, 1)

    def rand(shape, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    sm = head_dim ** -0.5
    cells = []
    for seq in seq_lens:
        # differencing cancels the fixed fetch cost but not its noise:
        # scale the chain so R x t_iter stays well above it at every seq
        # (attention ~ seq^2), never below 2
        reps = (max(2, min(2048, int(repeats * (4096 / seq) ** 2)))
                if repeats > 1 else repeats)
        q, k, v = (rand((hb, seq, head_dim), i) for i in (1, 2, 3))

        def ein_one(q, k, v):
            # cast to q's dtype so the chained carry keeps q's type
            return fa._reference_attention(q, k, v, sm, causal).to(q.dtype)

        try:
            ein_fwd_s = _paired_time(
                lambda r: _chain_fwd(ein_one, r), (q, k, v), iters, reps)
            ein_train_s = _paired_time(
                lambda r: _chain_train(_grad_of(ein_one), r), (q, k, v),
                iters, reps)
            ein_err = ""
        except Exception as exc:
            # the einsum reference materializes the (S, S) matrix and runs
            # out of memory at lengths flash handles fine: keep sweeping
            _free(dev)
            ein_fwd_s = ein_train_s = None
            ein_err = f"einsum: {type(exc).__name__}: {exc}"
        for bq, bk in blocks:
            for bwd in bwd_blocks:
                bwq, bwk = bwd if bwd is not None else fa.BWD_BLOCK

                def fl_one(q, k, v):
                    return fa.flash_attention(q, k, v, None, causal)

                fwd_launches = train_launches = None
                try:
                    before = dict(fa.launches)
                    fl_fwd_s = _paired_time(
                        lambda r: _chain_fwd(fl_one, r), (q, k, v), iters,
                        reps)
                    fwd_launches = launched(before)
                    before = dict(fa.launches)
                    fl_train_s = _paired_time(
                        lambda r: _chain_train(_grad_of(fl_one), r),
                        (q, k, v), iters, reps)
                    train_launches = launched(before)
                    err = ein_err
                except Exception as exc:  # report the cell, keep sweeping
                    _free(dev)
                    fl_fwd_s = fl_train_s = None  # None -> JSON null
                    err = "; ".join(
                        x for x in (ein_err,
                                    f"flash: {type(exc).__name__}: {exc}")
                        if x)

                def ms(s):
                    return None if s is None else s * 1e3

                def speedup(ref_s, new_s):
                    return (ref_s / new_s
                            if ref_s is not None and new_s else None)

                cells.append({
                    "seq": seq, "block_q": bq, "block_k": bk,
                    # the compiled backward tiles (K3's query blocks, K2's
                    # key blocks), whatever the sequence length
                    "bwd_block_q": bwq,
                    "bwd_block_k": bwk,
                    "reps": reps,  # effective chain length for this seq
                    "flash_fwd_ms": ms(fl_fwd_s),
                    "einsum_fwd_ms": ms(ein_fwd_s),
                    "flash_train_ms": ms(fl_train_s),
                    "einsum_train_ms": ms(ein_train_s),
                    "fwd_speedup": speedup(ein_fwd_s, fl_fwd_s),
                    "train_speedup": speedup(ein_train_s, fl_train_s),
                    "flash_fwd_launches": fwd_launches,
                    "flash_train_launches": train_launches,
                    "error": err,
                })
        del q, k, v
        _free(dev)
    wins = sorted({c["seq"] for c in cells
                   if c["flash_fwd_ms"] is not None
                   and (c["fwd_speedup"] or 0) > 1.0})
    on_card = dev.type == "cuda"
    return {
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "platform": "gpu" if on_card else dev.type,
        # the kernels ran only on the card; elsewhere their plain versions
        "interpret": not on_card,
        "hb": hb,
        "head_dim": head_dim,
        "repeats": repeats,
        "cells": cells,
        "flash_wins_at": wins,
        # the verdict the CLI uses: the flash kernels must have run in
        # every cell; an einsum failure degrades that cell's comparison,
        # never the sweep
        "flash_ok": bool(cells) and all(
            c["flash_fwd_ms"] is not None for c in cells),
    }


def crossover(results: Iterable[dict]) -> Optional[int]:
    """The shortest swept length from which the flash kernels train faster
    than einsum attention at every longer swept length, in every result
    (`bench_attention`'s; a cell whose einsum side failed, as it runs out
    of memory first, counts for flash); None if flash loses at the
    longest. `workload.FLASH_MIN_SEQ` is this rule applied to the
    committed H100 sweeps."""
    cells = [c for r in results for c in r["cells"]]

    def flash_trains_faster(seq):
        return all(c["flash_train_ms"] is not None
                   and (c["einsum_train_ms"] is None
                        or c["flash_train_ms"] < c["einsum_train_ms"])
                   for c in cells if c["seq"] == seq)

    shortest = None
    for seq in sorted({c["seq"] for c in cells}, reverse=True):
        if not flash_trains_faster(seq):
            break
        shortest = seq
    return shortest
