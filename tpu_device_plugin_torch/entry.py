"""Entry points of the port, mirroring the repository's `__graft_entry__.py`.

`entry()` is the loss of the burn-in transformer at a small configuration,
with example arguments, on CUDA unless the caller passes `device="cpu"`.
`dryrun_multichip(n)` runs one sharded training step on a (dp, sp, tp)
mesh of n gloo CPU processes.
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


def _dryrun_rank(rank, mesh, cfg):
    from .validator.mesh import mesh_shape
    from .validator.workload import build_workload
    step, params, momentum, tokens = build_workload(cfg, mesh, device="cpu")
    _, _, loss = step(params, momentum, tokens)
    return mesh_shape(mesh), loss.item()


def dryrun_multichip(n_devices: int) -> None:
    """One training step on a (dp, sp, tp) mesh over `n_devices` gloo CPU
    processes: the first regime of the JAX version (tp up to 4, sp 2 where
    it divides, dp the rest; ring attention over sp). Prints rank 0's
    `dryrun_multichip: mesh={...} loss=...`. The JAX version's pipeline and
    expert regimes, run where n is a multiple of 8, are not ported yet."""
    from .validator.distributed import spawn
    from .validator.mesh import infer_mesh_shape
    from .validator.workload import ModelConfig

    tp = 1
    while tp * 2 <= min(n_devices, 4) and n_devices % (tp * 2) == 0:
        tp *= 2
    sp = 2 if n_devices % (tp * 2) == 0 and n_devices // tp >= 2 else 1
    dp, _, _ = infer_mesh_shape(n_devices, tp=tp, sp=sp)
    cfg = ModelConfig(seq_len=64, batch=max(4, dp * 2), n_layers=2)
    shape, loss = spawn(_dryrun_rank, n_devices, "cpu", timeout_s=600,
                        args=(cfg,), mesh=dict(tp=tp, sp=sp))[0]
    print(f"dryrun_multichip: mesh={shape} loss={loss:.4f}")
    if n_devices % 8 == 0:
        print("dryrun_multichip: the (pp, ep, tp) MoE regime and the GPipe "
              "regime are not yet ported (ROADMAP.md, Queue 1, items 5 "
              "and 6)")
