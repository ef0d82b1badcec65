"""Entry points of the port, mirroring the repository's `__graft_entry__.py`.

`entry()` is the loss of the burn-in transformer at a small configuration,
with example arguments, on CUDA unless the caller passes `device="cpu"`.
`dryrun_multichip(n)` runs one sharded training step per regime of the
JAX version on n gloo CPU processes: (dp, sp, tp), then, where n is a
multiple of 8, (pp, ep, tp) with a top-1 switch MoE, and the GPipe
schedule over pp x dp.
"""

from __future__ import annotations


def entry(device=None):
    """(fn, (params, tokens)): `fn(params, tokens)` is the mean next-token
    loss at ModelConfig(seq_len=128, batch=4, n_layers=2), einsum
    attention; params from seed 0, tokens from seed 1."""
    from .validator.workload import (ModelConfig, _place, loss_fn,
                                     resolve_device)

    cfg = ModelConfig(seq_len=128, batch=4, n_layers=2)
    params, tokens = _place(cfg, resolve_device(device), 0)

    def fn(p, t):
        return loss_fn(p, t, cfg)

    return fn, (params, tokens)


def _dryrun_rank(rank, _mesh, regimes):
    """One training step per (slice_mesh keywords, config, GPipe
    microbatches) regime, the GPipe schedule where the microbatches are
    not 0; the mesh's shape and the loss of each."""
    import torch.distributed as dist

    from .validator.mesh import mesh_shape, slice_mesh
    from .validator.pipeline import build_gpipe
    from .validator.workload import build_workload
    out = []
    for mesh_kw, cfg, n_micro in regimes:
        mesh = slice_mesh(dist.get_world_size(), device_type="cpu", **mesh_kw)
        if n_micro:
            step, params, momentum, tokens = build_gpipe(cfg, mesh, n_micro,
                                                         device="cpu")
        else:
            step, params, momentum, tokens = build_workload(cfg, mesh,
                                                            device="cpu")
        _, _, loss = step(params, momentum, tokens)
        out.append((mesh_shape(mesh), loss.item()))
    return out


def dryrun_multichip(n_devices: int) -> None:
    """One training step per sharding regime over `n_devices` gloo CPU
    processes, as the JAX version: (dp, sp, tp) with tp up to 4, sp 2
    where it divides and ring attention over it; then, where n is a
    multiple of 8, pp 2 x ep 2 x tp 2 with a 4-expert MoE (stage-cut
    layers, experts over ep), and the GPipe schedule on pp 2 x dp n/2 with
    2 microbatches. Prints rank 0's `dryrun_multichip: mesh={...}
    loss=...` per regime (`gpipe mesh=` for the third)."""
    from .validator.distributed import spawn
    from .validator.mesh import mesh_dims
    from .validator.workload import ModelConfig

    tp = 1
    while tp * 2 <= min(n_devices, 4) and n_devices % (tp * 2) == 0:
        tp *= 2
    sp = 2 if n_devices % (tp * 2) == 0 and n_devices // tp >= 2 else 1
    dp = dict(mesh_dims(n_devices, tp=tp, sp=sp))["dp"]
    regimes = [(dict(tp=tp, sp=sp),
                ModelConfig(seq_len=64, batch=max(4, dp * 2), n_layers=2), 0)]
    if n_devices % 8 == 0:
        moe = dict(pp=2, ep=2, tp=2, sp=1)
        dp2 = dict(mesh_dims(n_devices, **moe))["dp"]
        regimes.append((moe, ModelConfig(seq_len=64, batch=max(4, dp2 * 2),
                                         n_layers=2, n_experts=4), 0))
        gpipe = dict(pp=2, tp=1, sp=1)
        dp3 = dict(mesh_dims(n_devices, **gpipe))["dp"]
        regimes.append((gpipe, ModelConfig(seq_len=64, batch=dp3 * 4,
                                           n_layers=2), 2))
    for (_, _, n_micro), (shape, loss) in zip(
            regimes, spawn(_dryrun_rank, n_devices, "cpu", timeout_s=600,
                           args=(regimes,))[0]):
        kind = "gpipe " if n_micro else ""
        print(f"dryrun_multichip: {kind}mesh={shape} loss={loss:.4f}")
