"""Granite-4.0-H's block (granite-4.0-h-small's) at a tiny size, and its
plain reference.

The reference is the benchmark's definition of granite-4.0-h-small
(`benchmarks/definitions/granite-4.0-h-small.py`: plain float32 PyTorch,
nothing of the port), loaded by path; its `harness` helpers come from
`benchmarks/`. Used by tests/test_torch_granite.py (CPU); imports no JAX.
pytest does not collect it. The gaps and `rel`, `max_rel` are
tests/torch_lfm2_tiny.py's.

The tiny size keeps every kind of the block: 3 Mamba-2 layers and 1
attention layer without positions, d 64, 4 Mamba heads of 8 over a state
of 16 in 2 groups, 4 taps; 4 query heads over 2 key-value heads of 16
at the scale 1/16; a softmax top-4 of 16 routed experts with 4 held
beside a shared expert of twice an expert's width; the muP multipliers
12, 0.22 and 16; a tied head over a vocab of 256. 80 tokens a sequence:
two of the port's scan chunks (ssd.CHUNK, 64), one of the reference's
(256). Tolerances, the port in bf16 against the reference in f32 on the
same weights, the reference following the port's routes, over four seeds
(einsum and flash attention): the port's loss within 5e-5 of the
reference's, its logits within 0.4% (max |d| over max |ref|), every
leaf's gradient within 3.0% and update within 3.7%; the same reference
with fp8 products (the control) reads 1.7% or more on the logits and 13%
or more on the gradients. The loss does not tell the two apart at this
size (the control's reads 1.2e-4 to 2.5e-4: the logits divided by 16 sit
near log 256 for every token), so the control is judged by the others.
"""

from __future__ import annotations

from pathlib import Path

import torch

from torch_lfm2_tiny import max_rel, rel, step_gaps  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
DEFINITION_PATH = ROOT / "benchmarks" / "definitions" / "granite-4.0-h-small.py"

LOSS_TOL = 1e-3       # port 5e-5 at most over 4 seeds
LOGITS_TOL = 0.01     # port 0.4%, control 1.7% or more
GRAD_TOL = 0.08       # port 3.7% at most on any leaf, control 13% or more

MODEL = dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=16,
             n_layers=4, layer_types=["mamba", "attention", "mamba",
                                      "mamba"],
             n_experts=16, experts_held=4, expert_d_ff=16,
             experts_per_token=4, norm_eps=1e-5, shared_d_ff=32,
             mamba_heads=4, mamba_head_dim=8, mamba_state=16,
             mamba_groups=2, mamba_taps=4, attention_scale=0.0625,
             router_scores="softmax", embedding_scale=12.0,
             residual_scale=0.22, logits_scale=16.0, lr=0.01, momentum=0.9)
BATCH, SEQ = 2, 80


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
