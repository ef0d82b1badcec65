"""Granite-4.0-H's block (granite-4.0-h-small's, at a tiny size) against
its plain f32 reference, the benchmark's definition, on the CPU.

- The port's leaves are the definition's; its kinds: Mamba-2, GQA without
  positions, the softmax shared MoE.
- A training step (einsum attention, and flash through the kernels'
  plain versions) and a forward, the reference following the port's
  routes: loss, logits, every leaf's gradient and update, within the
  bounds of tests/torch_granite_tiny.py, which the reference in fp8
  fails.
- The reference's logits against transformers' GraniteMoeHybridForCausalLM
  on the same weights, mapped leaf to leaf.
- The scan's plain version (`ssd.ssd_plain`) against the step-by-step
  recurrence, shorter than a chunk, across chunks and past a multiple of
  one, and its gradients against autograd through the recurrence.
- C1's ungated mode in plain form against `F.conv1d(groups=C)`.
- The expert cut: eight shares of 9 of a 72-expert layer add up to the
  uncut layer, the shared expert counted once.
- The softmax router against GraniteMoeHybridTopKGating; the sigmoid
  router op for op as before.
- The spans of the Mamba mixer; remat; `ModelConfig`'s new errors.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from tpu_device_plugin_torch.validator import short_conv, ssd, tracing
from tpu_device_plugin_torch.validator import workload

import torch_granite_tiny as tiny

SEED = 2 ** 31 + 29
MOE_KEYS = ("wr", "w1e", "w3e", "w2e", "ws1", "ws3", "ws2")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_the_ports_leaves_and_kinds_are_the_definitions():
    cfg = workload.ModelConfig(**tiny.MODEL)
    assert cfg.hybrid and cfg.tied
    shapes = tiny.definition().leaf_shapes(tiny.MODEL)
    assert workload.leaf_shapes(cfg) == shapes
    assert list(workload.leaf_shapes(cfg)) == list(shapes)
    moe = "softmax_shared_dropless"
    assert cfg.kinds(4) == [("mamba", moe), ("attention", moe),
                            ("mamba", moe), ("mamba", moe)]
    assert "layers.moe_bias" not in shapes
    # in_proj: z, xBC (inner + 2 groups x state), dt
    assert shapes["layers.in_proj"] == (3, 64, 32 + 32 + 64 + 4)


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_sgd_step_matches_the_reference_and_the_control_does_not(attention):
    params, tokens = tiny.inputs(SEED, "cpu")
    loss, grad, new, routes = tiny.port_step(workload, params, tokens,
                                             attention)
    assert len(routes.by_layer) == 4
    ref = tiny.reference_step(params, tokens, routes)
    gaps = tiny.step_gaps((loss, grad, new), ref[:3], params)
    assert gaps["loss"] <= tiny.LOSS_TOL, gaps
    assert gaps["grad"] <= tiny.GRAD_TOL, gaps
    assert gaps["update"] <= tiny.GRAD_TOL, gaps
    # the port's routes are the reference's own up to near-ties of logits
    assert ref[3] < 0.05
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


def _transformers_model(params, model):
    """transformers' GraniteMoeHybridForCausalLM at `model`'s sizes, all
    experts, holding `params` leaf for leaf (offsets made weights)."""
    transformers = pytest.importorskip("transformers")
    d = tiny.definition()
    config = transformers.GraniteMoeHybridConfig(
        vocab_size=model["vocab"], hidden_size=model["d_model"],
        intermediate_size=model["expert_d_ff"],
        num_hidden_layers=model["n_layers"],
        num_attention_heads=model["n_heads"],
        num_key_value_heads=model["n_kv_heads"], rms_norm_eps=1e-5,
        tie_word_embeddings=True, embedding_multiplier=12.0,
        logits_scaling=16.0, residual_multiplier=0.22,
        attention_multiplier=model["attention_scale"],
        num_local_experts=model["n_experts"],
        num_experts_per_tok=model["experts_per_token"],
        shared_intermediate_size=model["shared_d_ff"],
        position_embedding_type="nope", layer_types=model["layer_types"],
        mamba_n_heads=model["mamba_heads"],
        mamba_n_groups=model["mamba_groups"],
        mamba_d_state=model["mamba_state"],
        mamba_d_head=model["mamba_head_dim"], mamba_d_conv=4,
        mamba_expand=model["mamba_heads"] * model["mamba_head_dim"]
        / model["d_model"], mamba_chunk_size=d.CHUNK)
    config._attn_implementation = "eager"
    net = transformers.GraniteMoeHybridForCausalLM(config).eval()
    taken = {"mamba": 0, "attention": 0}
    with torch.no_grad():
        net.model.embed_tokens.weight.copy_(params["embed"])
        net.model.norm.weight.copy_(1 + params["final_norm"])
        for i, kind in enumerate(model["layer_types"]):
            layer, j = net.model.layers[i], taken[kind]
            taken[kind] += 1

            def w(key, at=j):
                return params["layers." + key][at]

            layer.input_layernorm.weight.copy_(1 + w("op_norm", i))
            layer.post_attention_layernorm.weight.copy_(1 + w("ffn_norm", i))
            if kind == "mamba":
                m = layer.mamba
                m.in_proj.weight.copy_(w("in_proj").t())
                m.conv1d.weight.copy_(w("conv_w").t()[:, None, :])
                m.conv1d.bias.copy_(w("conv_b"))
                m.dt_bias.copy_(d.DT_BIAS + w("dt_bias"))
                m.A_log.copy_(d.A_LOG + w("A_log"))
                m.D.copy_(1 + w("D"))
                m.norm.weight.copy_(1 + w("gate_norm"))
                m.out_proj.weight.copy_(w("out_proj").t())
            else:
                a = layer.self_attn
                for name in ("q", "k", "v", "o"):
                    getattr(a, f"{name}_proj").weight.copy_(
                        w(f"w{name}").t())
            moe = layer.block_sparse_moe
            moe.router.layer.weight.copy_(w("wr", i).t())
            moe.input_linear.weight.copy_(torch.cat(
                [w("w1e", i).transpose(1, 2), w("w3e", i).transpose(1, 2)],
                1))
            moe.output_linear.weight.copy_(w("w2e", i).transpose(1, 2))
            shared = layer.shared_mlp
            shared.input_linear.weight.copy_(torch.cat(
                [w("ws1", i).t(), w("ws3", i).t()], 0))
            shared.output_linear.weight.copy_(w("ws2", i).t())
    return net


def test_the_reference_is_transformers_granitemoehybrid():
    """The definition's logits against the published modelling code's
    (its torch_forward scan at the published chunk), all 16 experts held,
    f32 on both sides: they agree to f32 rounding (5e-6 of the largest
    logit here); a reference without the residual multiplier reads 10%
    or more off."""
    d = tiny.definition()
    model = dict(tiny.MODEL, experts_held=16)
    params, tokens = tiny.inputs(SEED + 2, "cpu", model)
    net = _transformers_model(params, model)
    with torch.no_grad():
        theirs = net(input_ids=tokens).logits
    ours = d.logits(params, tokens, model, "f32")
    assert tiny.max_rel(ours, theirs) <= 1e-4
    off = d.logits(params, tokens, dict(model, residual_scale=1.0), "f32")
    assert tiny.max_rel(off, theirs) > 0.1


def _recurrence(x, dt, a, B, C, D):
    """The scan a step at a time in float64: S_t = exp(dt_t a) S_{t-1} +
    dt_t x_t B_t^T, y_t = S_t C_t + D x_t."""
    b, s, h, p = x.shape
    Bh = B.double().repeat_interleave(h // B.shape[2], 2)
    Ch = C.double().repeat_interleave(h // C.shape[2], 2)
    state = torch.zeros(b, h, p, B.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        dt_t = dt[:, t].double()
        state = (torch.exp(dt_t * a.double())[..., None, None] * state
                 + (dt_t[..., None] * x[:, t].double())[..., None]
                 * Bh[:, t][:, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t])
                  + D.double()[:, None] * x[:, t].double())
    return torch.stack(ys, 1)


def _scan_inputs(s, seed, groups=2):
    gen = torch.Generator().manual_seed(seed)
    b, h, p, n = 2, 4, 8, 16
    x = torch.randn(b, s, h, p, generator=gen).bfloat16()
    dt = F.softplus(torch.randn(b, s, h, generator=gen) - 3)
    a = -torch.exp(torch.randn(h, generator=gen) * 0.5 + 1)
    B = torch.randn(b, s, groups, n, generator=gen).bfloat16()
    C = torch.randn(b, s, groups, n, generator=gen).bfloat16()
    D = 1 + 0.1 * torch.randn(h, generator=gen)
    return x, dt, a, B, C, D


@pytest.mark.parametrize("seq", [17, 64, 150])
def test_the_plain_scan_is_the_recurrence(seq):
    """At chunk 32: shorter than a chunk, two whole chunks, and four and a
    part. The plain version rounds M, the state read by C, x dt exp(..)
    and y to bf16 (2^-9 each): 0.3% of the largest output here; the
    recurrence without its decay, or without D, reads 10% or more off."""
    inputs = _scan_inputs(seq, seq)
    y = ssd.ssd_plain(*inputs, chunk=32)
    ref = _recurrence(*inputs)
    assert y.dtype == torch.bfloat16 and y.shape == inputs[0].shape
    assert tiny.max_rel(y, ref) <= 0.01
    x, dt, a, B, C, D = inputs
    assert tiny.max_rel(y, _recurrence(x, dt, a * 0, B, C, D)) > 0.1
    assert tiny.max_rel(y, _recurrence(x, dt, a, B, C, D * 0)) > 0.1


def test_the_plain_scans_gradients_are_the_recurrences():
    """Every input's gradient through the plain chunked scan (autograd
    through its bf16 roundings) against autograd through the f64
    recurrence: within 2% of the largest, each."""
    x, dt, a, B, C, D = _scan_inputs(100, 7)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    ours = [t.detach().float().requires_grad_() for t in (x, dt, a, B, C, D)]
    (ssd.ssd_plain(ours[0].bfloat16(), ours[1], ours[2], ours[3].bfloat16(),
                   ours[4].bfloat16(), ours[5], chunk=32).float()
     * dy).sum().backward()
    theirs = [t.detach().double().requires_grad_() for t in (x, dt, a, B, C,
                                                             D)]
    (_recurrence(*theirs) * dy.double()).sum().backward()
    for name, u, v in zip("x dt a B C D".split(), ours, theirs):
        assert tiny.max_rel(u.grad, v.grad) <= 0.02, name


@pytest.mark.parametrize("seq", [20, 2, 1])
def test_the_plain_ungated_conv_is_conv1d_with_its_bias_and_silu(seq):
    """At 20 tokens, and at fewer than the taps (their earliest taps fall
    before the sequence)."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, seq, 24, generator=gen).bfloat16()
    w = torch.randn(4, 24, generator=gen) * 0.5
    bias = torch.randn(24, generator=gen) * 0.1
    y = short_conv.conv_silu_plain(x, w, bias)
    ref = F.silu(F.conv1d(x.float().transpose(1, 2), w.t()[:, None, :], bias,
                          padding=3, groups=24)[..., :seq].transpose(1, 2))
    # f32 sums rounded to bf16 once
    assert y.dtype == torch.bfloat16
    assert (y.float() - ref).abs().max() <= 2 ** -8 * ref.abs().max()
    # the taps in the published order: reversed, they read far off
    rev = short_conv.conv_silu_plain(x, w.flip(0), bias)
    assert (rev.float() - ref).abs().max() > 0.1
    # a slice of a wider projection's rows, read in place
    wide = torch.randn(2, seq, 40, generator=gen).bfloat16()
    assert torch.equal(short_conv.conv_silu_plain(wide[..., 8:32], w, bias),
                       short_conv.conv_silu_plain(
                           wide[..., 8:32].contiguous(), w, bias))


def test_eight_shares_of_nine_experts_and_the_shared_add_up_to_the_layer():
    d = tiny.definition()
    model = dict(tiny.MODEL, n_experts=72, experts_held=72,
                 experts_per_token=10)
    params, _ = tiny.inputs(SEED + 3, "cpu", model)
    layer = {k: params["layers." + k][0] for k in MOE_KEYS}
    cfg = workload.ModelConfig(**dict(model, experts_held=9))
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(5)
                    ).bfloat16()
    shares, routes = [], d.new_routes(model)
    for i in range(8):
        held = {k: (v[9 * i:9 * i + 9] if k in ("w1e", "w3e", "w2e") else v)
                for k, v in layer.items()}
        with d.record(workload, routes if i == 0 else None):
            shares.append(workload._moe_dropless(x, held, cfg, first=9 * i,
                                                 router="softmax"))
    shared = workload._swiglu(x, layer["ws1"], layer["ws3"], layer["ws2"])
    with d.record(workload, None):
        chip = workload._moe_shared(x, dict(layer, w1e=layer["w1e"][:9],
                                            w3e=layer["w3e"][:9],
                                            w2e=layer["w2e"][:9]), cfg,
                                    router="softmax")
    assert torch.equal(chip, shares[0] + shared)
    whole = sum(s.float() for s in shares) + shared.float()
    ref = d._moe(x.float(), layer, model, "f32", 0,
                 d.new_routes(model, routes.by_layer, True))
    # each share and the shared output rounded to bf16 once (2^-9); the
    # shared expert counted in every share, or one share alone, far off
    assert tiny.rel(whole, ref) <= 0.01
    assert tiny.rel(whole + 7 * shared.float(), ref) > 0.1
    assert tiny.rel(shares[0].float() + shared.float(), ref) > 0.1


def test_the_softmax_router_is_granites_and_the_sigmoid_router_as_before():
    pytest.importorskip("transformers")
    from transformers.models.granitemoehybrid import (
        modeling_granitemoehybrid as published)
    gen = torch.Generator().manual_seed(12)
    xt = torch.randn(64, 64, generator=gen).bfloat16()
    wr = torch.randn(64, 72, generator=gen) * 0.125
    cfg = workload.ModelConfig(**dict(tiny.MODEL, n_experts=72,
                                      experts_per_token=10))
    weights, chosen = workload._route_topk(xt, wr, None, cfg)
    gating = published.GraniteMoeHybridTopKGating(64, 72, 10)
    with torch.no_grad():
        gating.layer.weight.copy_(wr.bfloat16().float().t())
        sorted_pairs, rows, gates, _, logits = gating(xt.float())
    # each sorted pair's expert, from the gating's own top-10 of its logits
    experts = logits.topk(10, -1).indices.reshape(-1)[sorted_pairs]
    theirs = torch.zeros(64, 72).index_put((rows, experts), gates)
    ours = torch.zeros(64, 72).scatter(1, chosen, weights)
    assert torch.allclose(ours, theirs, atol=1e-6)
    assert torch.allclose(weights.sum(-1), torch.ones(64))
    # the sigmoid router: bias-selected top-k of sigmoid scores, normalised
    # with router_eps, op for op as it was
    lfm2 = workload.ModelConfig(**dict(tiny.MODEL, n_experts=72,
                                       experts_per_token=10,
                                       router_scores="sigmoid",
                                       router_eps=1e-6))
    bias = torch.randn(72, generator=gen) * 0.01
    weights, chosen = workload._route_topk(xt, wr, bias, lfm2)
    scores = torch.sigmoid(xt.float() @ wr.bfloat16().float())
    expect_chosen = (scores + bias).topk(10, -1).indices
    picked = scores.gather(1, expect_chosen)
    assert torch.equal(chosen, expect_chosen)
    assert torch.equal(weights, picked / (picked.sum(-1, keepdim=True)
                                          + 1e-6))


def test_the_mamba_mixers_spans_and_its_counter_only_through_s1():
    params, tokens = tiny.inputs(SEED + 4, "cpu")
    from harness.inputs import nest
    cfg = workload.ModelConfig(**tiny.MODEL, batch=tiny.BATCH,
                               seq_len=tiny.SEQ, remat=True)
    p = nest(params)
    m = nest({k: torch.zeros_like(v) for k, v in params.items()})
    with tracing.recording() as rec:
        workload.sgd_step(p, m, tokens, cfg, "flash")
    names = {s.name for s in rec.spans}
    assert {"workload.mamba", "workload.mamba.bwd", "mamba.conv",
            "mamba.scan", "workload.attention", "workload.attention.bwd",
            "workload.ffn", "workload.ffn.bwd", "moe.route",
            "moe.shared"} <= names
    # mamba.conv and mamba.scan inside workload.mamba, once a layer a
    # forward (remat's recomputation runs inside the backward)
    parents = [rec.spans[s.parent].name for s in rec.spans
               if s.name in ("mamba.conv", "mamba.scan")]
    assert parents == ["workload.mamba"] * 2 * 3 * 2
    pairs = 4 * tiny.BATCH * tiny.SEQ * 4          # 4 MoE layers, top-4
    assert rec.counts["moe.routed"] == pairs
    assert 0 < rec.counts["moe.held"] < pairs      # 4 of the 16 held
    # the plain scan on a CPU tensor: S1 ran nowhere, nothing counted
    assert "mamba.scan_rows" not in rec.counts


def test_remat_gives_the_steps_result():
    params, tokens = tiny.inputs(SEED + 5, "cpu")
    base = tiny.port_step(workload, params, tokens, "flash")
    again = tiny.port_step(workload, params, tokens, "flash",
                           dict(tiny.MODEL, remat=True))
    assert base[0] == again[0]
    assert all(torch.equal(base[1][k], again[1][k]) for k in base[1])


def test_the_multipliers_run_no_op_at_one():
    """At 1 the embedding, residual and logits multipliers leave the step
    as the block without them computes it; Granite's change the logits."""
    params, tokens = tiny.inputs(SEED + 6, "cpu")
    from harness.inputs import nest
    ones = dict(tiny.MODEL, embedding_scale=1.0, residual_scale=1.0,
                logits_scale=1.0)
    outs = []
    for model in (ones, tiny.MODEL):
        cfg = workload.ModelConfig(**model, batch=tiny.BATCH,
                                   seq_len=tiny.SEQ)
        with torch.no_grad():
            outs.append(workload.forward(nest(params), tokens, cfg,
                                         "einsum"))
    assert tiny.max_rel(outs[0], outs[1]) > 0.5


@pytest.mark.parametrize("missing", ["mamba_heads", "mamba_head_dim",
                                     "mamba_state", "mamba_groups",
                                     "mamba_taps"])
def test_mamba_layers_name_the_width_they_miss(missing):
    with pytest.raises(ValueError, match=f"mamba layers need.*{missing}"):
        workload.ModelConfig(**dict(tiny.MODEL, **{missing: 0}))


def test_rope_theta_is_needed_only_where_a_layer_uses_rope():
    # Granite's attention without positions, and LFM2's conv layers alone,
    # need none
    workload.ModelConfig(**tiny.MODEL)
    workload.ModelConfig(layer_types=["conv", "conv"], norm_eps=1e-5)
    mla = dict(layer_types=["mla"], n_layers=1, kv_lora_rank=8,
               qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
    with pytest.raises(ValueError, match="mla.*use RoPE.*rope_theta"):
        workload.ModelConfig(**mla)
    workload.ModelConfig(**mla, rope_theta=1e4)
    # with rope_theta, the attention layers are LFM2's qk-norm and RoPE
    cfg = workload.ModelConfig(**dict(tiny.MODEL, rope_theta=1e4))
    assert cfg.kinds(4)[1][0] == "qk_norm_attention"


@pytest.mark.parametrize("numbers", [dict(mamba_heads=4),
                                     dict(attention_scale=0.1),
                                     dict(router_scores="softmax"),
                                     dict(embedding_scale=12.0),
                                     dict(residual_scale=0.22),
                                     dict(logits_scale=16.0)])
def test_the_new_numbers_need_layer_types(numbers):
    with pytest.raises(ValueError, match="layer_types"):
        workload.ModelConfig(**numbers)


def test_the_router_scores_are_sigmoid_or_softmax():
    with pytest.raises(ValueError, match="router_scores"):
        workload.ModelConfig(**dict(tiny.MODEL, router_scores="relu"))
    with pytest.raises(ValueError, match="beside shared experts"):
        workload.ModelConfig(**dict(tiny.MODEL, shared_d_ff=0))
    with pytest.raises(ValueError, match="multiple of mamba_groups"):
        workload.ModelConfig(**dict(tiny.MODEL, mamba_groups=3))


def test_the_mamba_offsets_put_a_and_dt_in_mambas_ranges():
    assert -math.exp(workload.MAMBA_A_LOG) == pytest.approx(-4.0)
    assert F.softplus(torch.tensor(workload.MAMBA_DT_BIAS)).item() == \
        pytest.approx(0.01, rel=1e-5)
    d = tiny.definition()
    assert (d.A_LOG, d.DT_BIAS) == (workload.MAMBA_A_LOG,
                                    workload.MAMBA_DT_BIAS)
