"""The hybrid block (LFM2-8B-A1B's, at a tiny size) against its plain f32
reference, the benchmark's definition, on the CPU.

- A training step and a forward, the reference following the port's
  routes: loss, logits, every leaf's gradient and update, within the
  bounds of tests/torch_lfm2_tiny.py, which the reference in fp8 fails.
- The expert cut: the partial MoE outputs of four port layers, each
  holding 2 of the 8 experts, add up to the uncut reference layer's.
- Routing: the bias selects experts and does not weight them; a routing
  skewed onto one expert drops nothing.
- The spans and counters of the new layers under `tracing.recording()`.
- No tensor left in a reference cycle by a step.
"""

import pytest
import torch

from tpu_device_plugin_torch.validator import tracing, workload

import torch_lfm2_tiny as tiny

SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_the_ports_leaves_are_the_definitions():
    cfg = workload.ModelConfig(**tiny.MODEL)
    assert cfg.hybrid
    shapes = tiny.definition().leaf_shapes(tiny.MODEL)
    assert workload.leaf_shapes(cfg) == shapes
    assert list(workload.leaf_shapes(cfg)) == list(shapes)


def test_sgd_step_matches_the_reference_and_the_control_does_not():
    params, tokens = tiny.inputs(SEED, "cpu")
    loss, grad, new, routes = tiny.port_step(workload, params, tokens,
                                             "einsum")
    assert len(routes.by_layer) == 3
    assert all(r.shape == (tiny.BATCH * tiny.SEQ, 2)
               for r in routes.by_layer.values())
    ref = tiny.reference_step(params, tokens, routes)
    gaps = tiny.step_gaps((loss, grad, new), ref[:3], params)
    assert gaps["loss"] <= tiny.LOSS_TOL, gaps
    assert gaps["grad"] <= tiny.GRAD_TOL, gaps
    assert gaps["update"] <= tiny.GRAD_TOL, gaps
    # the routes the port took are near-ties of the reference's own or
    # its own: a followed expert ranks under a skipped one by rounding only
    assert ref[3] < 0.02
    # the selection bias gets no gradient: the step leaves it unchanged
    assert torch.equal(new["layers.moe_bias"], params["layers.moe_bias"])
    control = tiny.reference_step(params, tokens, routes, "fp8")
    assert tiny.step_gaps(control[:3], ref[:3], params)["grad"] \
        > tiny.GRAD_TOL


def test_forward_matches_the_reference_and_the_control_does_not():
    d = tiny.definition()
    params, tokens = tiny.inputs(SEED + 1, "cpu")
    from harness.inputs import nest
    cfg = workload.ModelConfig(**tiny.MODEL, batch=tiny.BATCH,
                               seq_len=tiny.SEQ)
    routes = d.new_routes(tiny.MODEL)
    with d.record(workload, routes), torch.no_grad():
        out = workload.forward(nest(params), tokens, cfg, "einsum")
    assert out.dtype == torch.float32
    ref, control = (d.logits(params, tokens, tiny.MODEL, precision,
                             d.new_routes(tiny.MODEL, routes.by_layer, True))
                    for precision in ("f32", "fp8"))
    assert tiny.max_rel(out, ref) <= tiny.LOGITS_TOL
    assert tiny.max_rel(control, ref) > tiny.LOGITS_TOL


def _moe_layer(seed: int):
    """One MoE layer's leaves of the tiny block with all 8 experts."""
    model = dict(tiny.MODEL, experts_held=8)
    params, _ = tiny.inputs(seed, "cpu", model)
    return model, {k: params["layers." + k][0]
                   for k in ("wr", "w1e", "w3e", "w2e", "moe_bias")}


def _reference_moe(model, layer, x, routes, first=0):
    d = tiny.definition()
    return d._moe(x.float(), *(layer[k] for k in
                               ("wr", "w1e", "w3e", "w2e", "moe_bias")),
                  model, "f32", 0, d.new_routes(model, routes.by_layer, True),
                  first=first)


def test_four_expert_shares_add_up_to_the_uncut_layer():
    d = tiny.definition()
    model, layer = _moe_layer(SEED + 2)
    cfg = workload.ModelConfig(**model)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(5)
                    ).bfloat16()
    shares, routes = [], d.new_routes(model)
    for i in range(4):
        held = {k: (v[2 * i:2 * i + 2] if k in ("w1e", "w3e", "w2e") else v)
                for k, v in layer.items()}
        with d.record(workload, routes if i == 0 else None):
            shares.append(workload._moe_dropless(x, held, cfg, first=2 * i))
    whole = sum(s.float() for s in shares)
    ref = _reference_moe(model, layer, x, routes)
    # each share is rounded to bf16 once (2^-9), the sum of four a little
    # more; one share alone is far off the whole
    assert tiny.rel(whole, ref) <= 0.01
    assert tiny.rel(shares[0], ref) > 0.3


def test_the_bias_selects_and_does_not_weight():
    model, layer = _moe_layer(SEED + 3)
    cfg = workload.ModelConfig(**model)
    xt = torch.randn(64, 64, generator=torch.Generator().manual_seed(6)
                     ).bfloat16()
    scores = torch.sigmoid(xt.float() @ layer["wr"].bfloat16().float())
    # lift the expert token 0 ranks last into its top 2
    last = scores.argsort(-1)[:, 0]
    bias = torch.zeros(8)
    bias[last[0]] = 2.0
    weights, chosen = workload._route_topk(xt, layer["wr"], bias, cfg)
    _, unbiased = workload._route_topk(xt, layer["wr"], torch.zeros(8), cfg)
    assert last[0] in chosen[0] and last[0] not in unbiased[0]
    assert not torch.equal(chosen, unbiased)
    picked = scores.gather(1, chosen)
    assert torch.allclose(weights, picked / (picked.sum(-1, keepdim=True)
                                             + 1e-6))


def test_a_skewed_routing_drops_nothing():
    d = tiny.definition()
    model, layer = _moe_layer(SEED + 4)
    layer["moe_bias"] = torch.zeros(8)
    layer["moe_bias"][3] = 10.0          # every token's first choice
    held = {k: (v[2:4] if k in ("w1e", "w3e", "w2e") else v)
            for k, v in layer.items()}   # experts 2 and 3
    cfg = workload.ModelConfig(**dict(model, experts_held=2))
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(7)
                    ).bfloat16()
    routes = d.new_routes(model)
    with tracing.recording() as rec, d.record(workload, routes):
        out = workload._moe_dropless(x, held, cfg, first=2)
    chosen = routes.by_layer[0]
    assert (chosen == 3).any(-1).all()
    held_pairs = ((chosen == 2) | (chosen == 3)).sum().item()
    assert rec.counts == {"moe.routed": 64, "moe.held": held_pairs,
                          "moe.dropped": 0, "moe.max_rows": 32}
    ref = _reference_moe(model, held, x, routes, first=2)
    assert tiny.rel(out, ref) <= 0.01


def test_the_new_spans_and_counters_are_recorded():
    params, tokens = tiny.inputs(SEED + 5, "cpu")
    from harness.inputs import nest
    cfg = workload.ModelConfig(**tiny.MODEL, batch=tiny.BATCH,
                               seq_len=tiny.SEQ)
    p = nest(params)
    m = nest({k: torch.zeros_like(v) for k, v in params.items()})
    with tracing.recording() as rec:
        workload.sgd_step(p, m, tokens, cfg, "einsum")
    names = {s.name for s in rec.spans}
    assert {"workload.conv", "workload.conv.bwd", "workload.attention",
            "workload.attention.bwd", "workload.ffn", "workload.ffn.bwd",
            "moe.route", "moe.dispatch", "moe.experts",
            "moe.combine"} <= names
    pairs = 3 * tiny.BATCH * tiny.SEQ * 2        # 3 MoE layers, top-2
    assert rec.counts["moe.routed"] == pairs
    assert rec.counts["moe.dropped"] == 0
    assert 0 < rec.counts["moe.held"] < pairs    # 4 of the 8 experts held
    assert 0 < rec.counts["moe.max_rows"] <= rec.counts["moe.held"]


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_the_hybrid_step_leaves_no_cyclic_garbage_holding_tensors(attention):
    """After a first step, the hybrid block's steps leave no tensor in a
    reference cycle: `sgd_step` pauses the garbage collector, so what a
    step allocates has to go when its last reference does."""
    import gc

    from harness.inputs import nest
    params, tokens = tiny.inputs(SEED + 7, "cpu")
    cfg = workload.ModelConfig(**tiny.MODEL, batch=tiny.BATCH,
                               seq_len=tiny.SEQ)
    p = nest(params)
    m = nest({k: torch.zeros_like(v) for k, v in params.items()})
    workload.sgd_step(p, m, tokens, cfg, attention)
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            workload.sgd_step(p, m, tokens, cfg, attention)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        tensors = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert tensors == []


def test_the_hybrid_block_refuses_a_mesh():
    cfg = workload.ModelConfig(**tiny.MODEL)
    with pytest.raises(ValueError, match="hybrid block"):
        workload.param_specs(cfg)
    assert not workload.ModelConfig(n_experts=8).hybrid


@pytest.mark.parametrize("numbers", [dict(n_kv_heads=2),
                                     dict(n_experts=8, experts_per_token=2),
                                     dict(norm_eps=1e-5),
                                     dict(rope_theta=1e4)])
def test_the_hybrid_numbers_need_layer_types(numbers):
    """Only `layer_types` chooses the hybrid block: its numbers on the block
    above are refused, not half taken."""
    with pytest.raises(ValueError, match="layer_types"):
        workload.ModelConfig(**numbers)
