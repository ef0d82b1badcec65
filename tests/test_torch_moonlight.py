"""DeepSeek-V3's block (Moonlight-16B-A3B's, at a tiny size) against its
plain f32 reference, the benchmark's definition, on the CPU.

- The port's leaves are the definition's.
- A training step (einsum attention, and flash through the kernels'
  plain versions at the tiny (24 + 8, 16) head dims) and a forward, the
  reference following the port's routes: loss, logits, every leaf's
  gradient and update, within the bounds of tests/torch_moonlight_tiny.py,
  which the reference in fp8 fails.
- The expert cut: the routed outputs of four port layers, each holding 4
  of the 16 experts, with the shared experts counted once, add up to the
  uncut reference layer's.
- Routing: the routed scale multiplies the weights; the bias selects
  experts and does not weight them.
- Latent attention: the latent's RMSNorm takes eps 1e-6, not the block's;
  the adjacent-pair RoPE gives the published interleaved form's q . k.
- The spans and counters of the new layers under `tracing.recording()`,
  `mla.flash_rows` b s heads for each latent attention layer.
"""

import pytest
import torch

from tpu_device_plugin_torch.validator import tracing, workload

import torch_moonlight_tiny as tiny

SEED = 2 ** 31 + 13
MOE_KEYS = ("wr", "w1e", "w3e", "w2e", "moe_bias", "ws1", "ws3", "ws2")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_the_ports_leaves_are_the_definitions():
    cfg = workload.ModelConfig(**tiny.MODEL)
    assert cfg.hybrid and not cfg.tied
    shapes = tiny.definition().leaf_shapes(tiny.MODEL)
    assert workload.leaf_shapes(cfg) == shapes
    assert list(workload.leaf_shapes(cfg)) == list(shapes)
    assert cfg.kinds(4) == [("mla", "swiglu")] + [("mla",
                                                   "shared_dropless")] * 3


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_sgd_step_matches_the_reference_and_the_control_does_not(attention):
    params, tokens = tiny.inputs(SEED, "cpu")
    loss, grad, new, routes = tiny.port_step(workload, params, tokens,
                                             attention)
    assert len(routes.by_layer) == 3
    ref = tiny.reference_step(params, tokens, routes)
    gaps = tiny.step_gaps((loss, grad, new), ref[:3], params)
    assert gaps["loss"] <= tiny.LOSS_TOL, gaps
    assert gaps["grad"] <= tiny.GRAD_TOL, gaps
    assert gaps["update"] <= tiny.GRAD_TOL, gaps
    assert ref[3] < 0.02
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
    """One MoE layer's leaves of the tiny block with all 16 experts."""
    model = dict(tiny.MODEL, experts_held=16)
    params, _ = tiny.inputs(seed, "cpu", model)
    return model, {k: params["layers." + k][0] for k in MOE_KEYS}


def _reference_moe(model, layer, x, routes, first=0):
    d = tiny.definition()
    return d._moe(x.float(), layer, model, "f32", 0,
                  d.new_routes(model, routes.by_layer, True), first=first)


def test_four_expert_shares_and_the_shared_experts_add_up_to_the_layer():
    d = tiny.definition()
    model, layer = _moe_layer(SEED + 2)
    cfg = workload.ModelConfig(**model)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(5)
                    ).bfloat16()
    shares, routes = [], d.new_routes(model)
    for i in range(4):
        held = {k: (v[4 * i:4 * i + 4] if k in ("w1e", "w3e", "w2e") else v)
                for k, v in layer.items()}
        with d.record(workload, routes if i == 0 else None):
            shares.append(workload._moe_dropless(x, held, cfg, first=4 * i))
    shared = workload._swiglu(x, layer["ws1"], layer["ws3"], layer["ws2"])
    # a chip's MoE output is its routed share plus the shared experts
    with d.record(workload, None):
        chip = workload._moe_shared(x, dict(layer, w1e=layer["w1e"][:4],
                                            w3e=layer["w3e"][:4],
                                            w2e=layer["w2e"][:4]), cfg)
    assert torch.equal(chip, shares[0] + shared)
    whole = sum(s.float() for s in shares) + shared.float()
    ref = _reference_moe(model, layer, x, routes)
    # each share and the shared output rounded to bf16 once (2^-9); the
    # shared experts counted in every share read 0.3 or more off
    assert tiny.rel(whole, ref) <= 0.01
    assert tiny.rel(whole + 3 * shared.float(), ref) > 0.1
    assert tiny.rel(shares[0].float() + shared.float(), ref) > 0.1


def test_the_routed_scale_weights_and_the_bias_selects_only():
    model, layer = _moe_layer(SEED + 3)
    cfg = workload.ModelConfig(**model)
    xt = torch.randn(64, 64, generator=torch.Generator().manual_seed(6)
                     ).bfloat16()
    scores = torch.sigmoid(xt.float() @ layer["wr"].bfloat16().float())
    last = scores.argsort(-1)[:, 0]
    bias = torch.zeros(16)
    bias[last[0]] = 2.0
    weights, chosen = workload._route_topk(xt, layer["wr"], bias, cfg)
    _, unbiased = workload._route_topk(xt, layer["wr"], torch.zeros(16), cfg)
    assert last[0] in chosen[0] and last[0] not in unbiased[0]
    picked = scores.gather(1, chosen)
    expect = picked / (picked.sum(-1, keepdim=True) + 1e-20) * 2.446
    assert torch.allclose(weights, expect)
    assert torch.allclose(weights.sum(-1), torch.full((64,), 2.446))
    # at scale 1 and eps 1e-6 the weights are LFM2's, op for op
    lfm2 = workload.ModelConfig(**dict(model, routed_scale=1.0,
                                       router_eps=1e-6))
    plain, _ = workload._route_topk(xt, layer["wr"], bias, lfm2)
    assert torch.equal(plain, picked / (picked.sum(-1, keepdim=True) + 1e-6))


def _mla_leaves(seed: int, latent_scale: float = 1.0):
    params, _ = tiny.inputs(seed, "cpu")
    w = {k: params["layers." + k][0]
         for k in ("q_proj", "kv_a", "kv_norm", "kv_b", "o_proj")}
    w["kv_a"] = w["kv_a"] * latent_scale
    return w


@pytest.mark.parametrize("latent_scale", [1.0, 1e-3])
def test_latent_attention_matches_the_reference_and_its_latent_eps(
        latent_scale):
    """The mixer alone against the reference's; with the latent drawn a
    thousand times smaller its mean square (~1e-6) is near the latent
    norm's eps, so the latent norm at the block's 1e-5 reads far off."""
    d = tiny.definition()
    cfg = workload.ModelConfig(**tiny.MODEL)
    w = _mla_leaves(SEED + 4, latent_scale)
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(8)
                    ).bfloat16()
    out = workload._mla(x, w, cfg, "einsum")
    ref = d._mla(x.float(), w, tiny.MODEL, "f32")
    assert tiny.rel(out, ref) <= 0.02
    if latent_scale < 1:
        saved = d.LATENT_EPS
        d.LATENT_EPS = 1e-5
        try:
            assert tiny.rel(out, d._mla(x.float(), w, tiny.MODEL, "f32")) \
                > 0.05
        finally:
            d.LATENT_EPS = saved


def test_the_adjacent_pair_rope_gives_the_published_q_dot_k():
    d = tiny.definition()
    gen = torch.Generator().manual_seed(9)
    q = torch.randn(2, 40, 4, 8, generator=gen).bfloat16()
    k = torch.randn(2, 40, 1, 8, generator=gen).bfloat16()
    rope = workload._rotary_pairs(40, 8, 50000.0, "cpu")
    pq, pk = workload._rope_pairs(q, rope), workload._rope_pairs(k, rope)
    rq = d._rope_interleaved(q.float().transpose(1, 2), 50000.0)
    rk = d._rope_interleaved(k.float().transpose(1, 2), 50000.0)
    port = torch.einsum("bqhd,bkhd->bhqk", pq.float(), pk.float().expand_as(pq))
    ref = torch.einsum("bhqd,bhkd->bhqk", rq, rk.expand_as(rq))
    # each side rounds its rotated vectors once, to bf16 on the port's
    assert tiny.rel(port, ref) <= 1e-2
    # the published form's dims are a permutation of the port's
    perm = torch.cat([torch.arange(0, 8, 2), torch.arange(1, 8, 2)])
    assert torch.allclose(pq.float()[..., perm], rq.transpose(1, 2),
                          atol=2e-2, rtol=1e-2)
    # without the rotation the two differ: positions matter
    assert tiny.rel(torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                 k.float().expand_as(q)), ref) > 0.1


def test_the_new_spans_and_counters_are_recorded():
    params, tokens = tiny.inputs(SEED + 5, "cpu")
    from harness.inputs import nest
    cfg = workload.ModelConfig(**tiny.MODEL, batch=tiny.BATCH,
                               seq_len=tiny.SEQ, remat=True)
    p = nest(params)
    m = nest({k: torch.zeros_like(v) for k, v in params.items()})
    with tracing.recording() as rec:
        workload.sgd_step(p, m, tokens, cfg, "flash")
    names = {s.name for s in rec.spans}
    assert {"workload.attention", "workload.attention.bwd", "mla.project",
            "workload.ffn", "workload.ffn.bwd", "moe.route", "moe.dispatch",
            "moe.experts", "moe.combine", "moe.shared"} <= names
    # once per layer per step: remat's recomputation inside the backward
    # is not counted again
    assert rec.counts["mla.flash_rows"] == 4 * tiny.BATCH * tiny.SEQ * 4
    pairs = 3 * tiny.BATCH * tiny.SEQ * 2        # 3 MoE layers, top-2
    assert rec.counts["moe.routed"] == pairs
    assert rec.counts["moe.dropped"] == 0
    assert 0 < rec.counts["moe.held"] < pairs    # 4 of the 16 experts held
    with tracing.recording() as rec:
        workload.sgd_step(p, m, tokens, cfg, "einsum")
    assert "mla.flash_rows" not in rec.counts


def test_remat_gives_the_steps_result():
    """The layers recomputed in the backward (and the experts not
    checkpointed again inside them) give the step without remat."""
    params, tokens = tiny.inputs(SEED + 6, "cpu")
    base = tiny.port_step(workload, params, tokens, "flash")
    again = tiny.port_step(workload, params, tokens, "flash",
                           dict(tiny.MODEL, remat=True))
    assert base[0] == again[0]
    assert all(torch.equal(base[1][k], again[1][k]) for k in base[1])


@pytest.mark.parametrize("numbers", [dict(kv_lora_rank=32),
                                     dict(shared_d_ff=32),
                                     dict(routed_scale=2.446),
                                     dict(untied_head=True)])
def test_the_new_numbers_need_layer_types(numbers):
    with pytest.raises(ValueError, match="layer_types"):
        workload.ModelConfig(**numbers)


def test_latent_attention_needs_its_widths_and_refuses_the_ring():
    with pytest.raises(ValueError, match="mla layers need"):
        workload.ModelConfig(**dict(tiny.MODEL, qk_rope_head_dim=7))
    with pytest.raises(ValueError, match="mla layers need"):
        workload.ModelConfig(**dict(tiny.MODEL, kv_lora_rank=0))
    cfg = workload.ModelConfig(**tiny.MODEL)
    with pytest.raises(ValueError, match="flash or einsum"):
        workload._mla(torch.zeros(1, 8, 64).bfloat16(),
                      _mla_leaves(SEED), cfg, "ring")
