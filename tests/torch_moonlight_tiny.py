"""DeepSeek-V3's block (Moonlight-16B-A3B's) at a tiny size, and its plain
reference.

The reference is the benchmark's definition of Moonlight-16B-A3B
(`benchmarks/definitions/moonlight-16b-a3b.py`: plain float32 PyTorch,
nothing of the port), loaded by path; its `harness` helpers come from
`benchmarks/`. Used by tests/test_torch_moonlight.py (CPU); imports no
JAX. pytest does not collect it. The gaps and `rel`, `max_rel` are
tests/torch_lfm2_tiny.py's.

The tiny size keeps every kind of the block: 1 dense and 3 MoE layers,
d 64, 4 heads of 24 + 8 query/key dims over 16 value dims, a latent of
32, 16 routed experts top-2 with 4 held beside shared experts of twice
an expert's width, an untied head over a vocab of 256. Tolerances, the
port in bf16 against the reference in f32 on the same weights, the
reference following the port's routes: over four seeds the port's loss
reads within 4e-3 of the reference's, its logits within 2.7% (max |d|
over max |ref|), every leaf's gradient and update within 3.6% (einsum
attention, or flash through the kernels' plain versions at (32, 16));
the same reference with fp8 products (the control) reads 23% or more on
the logits and 36% or more on every gradient.
"""

from __future__ import annotations

from pathlib import Path

import torch

from torch_lfm2_tiny import max_rel, rel, step_gaps  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
DEFINITION_PATH = ROOT / "benchmarks" / "definitions" / "moonlight-16b-a3b.py"

LOSS_TOL = 0.01       # port 4e-3 at most over 4 seeds
LOGITS_TOL = 0.1      # port 2.7%, control 23% or more
GRAD_TOL = 0.15       # port 3.6% at most on any leaf, control 36% or more

MODEL = dict(vocab=256, d_model=64, n_heads=4, d_ff=96, n_layers=4,
             layer_types=["mla"] * 4, n_dense_layers=1, n_experts=16,
             experts_held=4, expert_d_ff=16, experts_per_token=2,
             rope_theta=50000.0, norm_eps=1e-5, kv_lora_rank=32,
             qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16,
             shared_d_ff=32, routed_scale=2.446, router_eps=1e-20,
             untied_head=True, lr=0.01, momentum=0.9)
BATCH, SEQ = 2, 32


def definition():
    """The definition module, loaded by path as the benchmark loads it."""
    from harness.spec import load_definition
    return load_definition(DEFINITION_PATH)


def inputs(seed: int, device, model=MODEL):
    """(flat f32 params, tokens (BATCH, SEQ)) on `device`, the params drawn
    as the benchmark draws them."""
    from harness.inputs import flatten, make_params
    params = flatten(make_params(definition(), model, seed, device))
    tokens = torch.randint(0, model["vocab"], (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(seed))
    return params, tokens.to(device)


def port_step(workload, params, tokens, attention: str, model=MODEL):
    """One port `sgd_step` on copies of `params`, recording its routes:
    (loss, gradient and updated params as flat dicts, routes)."""
    from harness.inputs import flatten, nest
    d = definition()
    cfg = workload.ModelConfig(**model, batch=BATCH, seq_len=SEQ)
    p = nest({k: v.clone() for k, v in params.items()})
    m = nest({k: torch.zeros_like(v) for k, v in params.items()})
    routes = d.new_routes(model)
    with d.record(workload, routes):
        _, _, loss = workload.sgd_step(p, m, tokens, cfg, attention)
    return loss.item(), flatten(m), flatten(p), routes


def reference_step(params, tokens, routes, precision: str = "f32",
                   model=MODEL):
    """The definition's step on copies of `params`, following `routes`:
    (loss, gradient, updated params, the routes' gap)."""
    d = definition()
    p = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    given = d.new_routes(model, routes.by_layer, follow=True)
    loss = d.sgd_step(p, m, tokens, model, precision, given)
    return loss.item(), m, p, given.gap
