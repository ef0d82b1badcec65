#!/usr/bin/env python3
"""Margins of the port's GPipe against the JAX package on the CPU.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python3 tests/torch_gpipe_margins.py

At tests/test_torch_pipeline.py's configuration and seeds, with that
file's gloo workers (pp 2 x dp 2, 4 microbatches), prints one JSON line:
the GPipe losses of both frameworks and their single-device losses, the
largest per-leaf gradient difference (over max |g|) against JAX's GPipe
and against the port's single-device step, remat's difference, and the
dense shift (port minus JAX single-device loss) at keys 5, 0 and 7 with,
at key 5, layer 0's attention and MLP differences on the same input.
It lives beside the tests because it imports JAX as they do; pytest does
not collect it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_pipeline as T
    from tpu_device_plugin.validator import workload as jw
    from tpu_device_plugin_torch.validator import workload as tw
    from tpu_device_plugin_torch.validator.distributed import spawn

    np_params, np_tokens, jax_loss, jax_grads, jax_single = \
        T.jax_side.__wrapped__()
    runs = {r["place"]: r for r in spawn(
        T._worker, 4, "cpu", timeout_s=300, args=(np_params, np_tokens),
        mesh=dict(pp=2, tp=1, sp=1))}
    loss, grads = T._whole(runs, "remat=False")
    loss_r, grads_r = T._whole(runs, "remat=True")
    tokens = torch.from_numpy(np_tokens.copy())
    single, ref = tw.value_and_grad(tw.params_from_jax(np_params, "cpu"),
                                    tokens, tw.ModelConfig(**T.SMALL),
                                    "einsum")
    ref = {k: g.numpy() for k, g in tw._named_leaves(ref)}

    def jax_leaf(name):
        leaf = jax_grads
        for part in name.split("."):
            leaf = leaf[part]
        return leaf

    shifts = {}
    cfg, tcfg = jw.ModelConfig(**T.SMALL), tw.ModelConfig(**T.SMALL)
    for seed in (5, 0, 7):
        p = jw.init_params(jax.random.key(seed), cfg)
        t = jax.random.randint(jax.random.key(seed + 1),
                               (cfg.batch, cfg.seq_len), 0, cfg.vocab,
                               dtype=jnp.int32)
        tp = tw.params_from_jax(jax.tree.map(np.asarray, p), "cpu")
        shifts[seed] = (tw.loss_fn(tp, torch.from_numpy(np.array(t)),
                                   tcfg).item() - float(jw.loss_fn(p, t, cfg)))
        if seed == 5:
            layer_j = {k: v[0] for k, v in p["layers"].items()}
            layer_t = {k: v[0] for k, v in tp["layers"].items()}
            x = jw._rms_norm(p["embed"].astype(jnp.bfloat16)[t])
            xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()

            def diff(a, b):
                return float(np.abs(np.asarray(a.astype(jnp.float32))
                                    - b.float().numpy()).max())
            layer0 = dict(
                attention=diff(jw._attention(x, layer_j, cfg, "einsum", True,
                                             None),
                               tw._attention(xt, layer_t, tcfg, "einsum")),
                mlp=diff(jw._mlp(x, layer_j), tw._mlp(xt, layer_t)))
    print(json.dumps(dict(
        port_gpipe_loss=loss, port_single_loss=single.item(),
        jax_gpipe_loss=jax_loss, jax_single_loss=jax_single,
        port_gpipe_minus_single=loss - single.item(),
        jax_gpipe_minus_single=jax_loss - jax_single,
        max_grad_rel_vs_jax_gpipe=max(
            (T._rel(g, jax_leaf(n)), n) for n, g in grads.items()),
        max_grad_rel_vs_port_single=max(
            (T._rel(g, ref[n]), n) for n, g in grads.items()),
        remat_loss_diff=abs(loss_r - loss),
        remat_grad_max_abs=max(float(np.abs(grads_r[n] - grads[n]).max())
                               for n in grads),
        dense_shift_by_key=shifts, key5_layer0_max_abs_diff=layer0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
