"""Single-device compile-check entry point of the port.

Mirrors `entry()` of the repository's `__graft_entry__.py`: the loss of the
burn-in transformer at a small configuration, with example arguments, on
CUDA unless the caller passes `device="cpu"`.
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
