"""Card-only tests of the port's CUDA kernels (marker `gpu`).

Each skips without a CUDA card; on one, run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

This file imports no JAX, so it runs where only PyTorch is installed. Each
kernel is held against its plain PyTorch version on the same inputs:

- K1, K2, K3: element by element, |d| <= GRAD_ATOL x max(max |g|, 1)
  + GRAD_RTOL x |g| (+ FLIP_RTOL x term with bf16 inputs);
  K1's |dlse| <= 1e-3. Both compute in f32 from the same inputs (lse and D
  in the backward); two bf16 outputs rounded from nearly equal f32 values
  differ by at most one ulp, 2^-7 of |g|; f32 outputs differ only by
  summation order. The absolute term is for elements near 0, where only
  f32 summation noise is left, and for gradients that vanish: at seq 1
  softmax has one key, and dq and dk are rounding noise around 0. With
  bf16 inputs K1 rounds P, K2 P and dS, and K3 dS, to bf16, as their plain
  versions do, from scores summed in another order: now and then one
  rounds the other way, by one bf16 ulp (2^-7 of it), so the largest
  single term of the element's sum (`rounding_terms_fwd`, `_dkv`, `_dq`)
  is allowed once.
- xent_fwd, xent_bwd (the training head's NLL): each row's lse and NLL
  within NLL_ATOL of the plain version's (f32 from the same bf16 values;
  exp is `ex2.approx`, ~2^-22 relative, and sums run in another order),
  the summed loss within NLL_RTOL. The bf16 gradient g (p - onehot)
  against the composition's autograd gradient: both compute p within a
  few 1e-6 of it, relative, and round once, so |d| <= 2^-7 |ref| (one
  ulp) + XENT_GRAD_ATOL (p flushed to 0 under 2^-126), and at each target
  XENT_TARGET_ATOL |g| more (p - 1 loses p's relative precision); rows
  past T exactly 0.
- conv_fwd, conv_bwd (LFM2's gated short convolution): the same bf16
  roundings as the plain version from exact products, only the f32 sums
  in another order (fused multiply-adds), so y is within one bf16 ulp of
  the plain version's per element and dbch within `grad_close`; each tap's
  gradient, an f32 sum of b s bf16 products, within
  `short_conv.dw_sum_depth(b, s)` 2^-24 of the sum of their absolute
  values from their exact (f64) sum: the most additions any term passes
  through in the kernels' order.
- conv_silu_fwd, conv_silu_bwd (C1's ungated mode, Mamba-2's convolution):
  the same f32 sum in the same order as the plain version, but fused
  multiply-adds against PyTorch's products and sums, and the SiLU's exp
  another. Where the sum nearly cancels, silu keeps its absolute error
  (some 5 roundings of 2^-24 of its terms' magnitudes), so y within one
  bf16 ulp plus CONV_SILU_SUM_TOL of the sum of |w_j x_j| and |bias|, dx
  likewise of the sum of |g w_j| (with the error the sum's own carries
  into g), the taps' and the bias's f32 gradients
  within CONV_SILU_DW_TOL of the largest.
- ssd_fwd, ssd_bwd (S1, Mamba-2's chunked scan): each output's largest
  |d| over the plain version's largest within SSD_TOL, chip_smoke.py's
  bars (about twice what the cell's one layer reads on an H100), the
  gradients bit for bit the same on a second run.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from tpu_device_plugin_torch.validator import flash_attention as fa
from tpu_device_plugin_torch.validator import (short_conv, ssd, tracing,
                                               workload, xent)

LSE_TOL = 1e-3
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2 ** -7}
GRAD_ATOL = {"float32": 1e-5, "bfloat16": 1e-4}
FLIP_RTOL = 2 ** -7
SMALL = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=96, batch=2)
NLL_ATOL = 1e-4
NLL_RTOL = 1e-5
XENT_GRAD_ATOL = 1e-30
XENT_TARGET_ATOL = 1e-5
# (B, S, T, V): switch-base-8's and pythia-1.4b's vocab (the benchmark's
# row widths), a ragged vocab, T = S
XENT_SHAPES = [(2, 64, 63, 32128), (2, 32, 31, 50304), (3, 40, 39, 1001),
               (2, 16, 16, 1001)]
# (b, s, d): s ragged against the kernels' tiles of 64 tokens, b > 1; one
# token; LFM2's width over three tiles and a part
CONV_SHAPES = [(2, 200, 136), (3, 37, 64), (1, 1, 8), (2, 197, 2048)]
# (b, s, D, row stride): x read in place in wider rows, ragged against the
# tiles; one token; Granite's xBC in its projection's rows, one tile long
CONV_SILU_SHAPES = [(2, 200, 136, 200), (3, 37, 64, 64), (1, 1, 8, 16),
                    (2, 64, 8448, 16768)]
CONV_SILU_DW_TOL = 1e-5
CONV_SILU_SUM_TOL = 2 ** -21
# (b, s, heads, groups) at head dim 64, state 128: one token, ragged
# against the chunks of 64, two groups; the cell's one layer
SSD_SHAPES = [(1, 1, 4, 2), (2, 200, 4, 1), (1, 1000, 8, 2),
              (2, 8192, 128, 1)]
SSD_TOL = {"y": 4e-3, "dx": 2e-2, "ddt": 1e-2, "da": 2e-2, "dB": 1e-2,
           "dC": 1e-2, "dD": 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def inputs(hb, seq, d, dtype, device, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((hb, seq, d),
                                                 dtype=np.float32))
            .to(device=device, dtype=getattr(torch, dtype)) for _ in range(n)]


def rel_err(out, ref):
    """max |out - ref| / max |ref|"""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def grad_close(out, ref, dtype, term=None) -> bool:
    """Every element within GRAD_ATOL x max(max |ref|, 1) + GRAD_RTOL x |ref|
    (+ FLIP_RTOL x term)."""
    out, ref = out.float(), ref.float()
    scale = max(ref.abs().max().item(), 1.0)
    bar = GRAD_ATOL[dtype] * scale + GRAD_RTOL[dtype] * ref.abs()
    if term is not None:
        bar = bar + FLIP_RTOL * term
    return bool(((out - ref).abs() <= bar).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [1, 96, 200])
def test_kernel_matches_plain(cuda_device, dtype, d, causal, seq):
    q, k, v = inputs(3, seq, d, dtype, cuda_device, seed=d + seq)
    before = fa.launches["flash_fwd"]
    o, lse = fa.flash_attention(q, k, v, None, causal, True)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 1
    assert o.dtype == q.dtype and lse.shape == (3, seq)
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, d ** -0.5, causal, True)
    term = (fa.rounding_terms_fwd(q, k, v, ref_lse, d ** -0.5, causal)
            if dtype == "bfloat16" else None)
    assert torch.isfinite(o).all()
    assert grad_close(o, ref_o, dtype, term)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [1, 96, 200])
def test_backward_kernels_match_plain(cuda_device, dtype, d, causal, seq):
    q, k, v, do = inputs(3, seq, d, dtype, cuda_device, seed=d + seq, n=4)
    scale = d ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale, causal, True)
    before = dict(fa.launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal)
    di = (do.float() * o.float()).sum(-1)
    terms = ((fa.rounding_terms_dq(q, k, v, do, lse, di, scale, causal),
              *fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, causal))
             if dtype == "bfloat16" else (None, None, None))
    for name, g, ref, term in zip(("dq", "dk", "dv"), grads, refs, terms):
        assert g.dtype == q.dtype and g.shape == q.shape
        assert torch.isfinite(g).all(), name
        assert grad_close(g, ref, dtype, term), name


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hb,seq,d", [(2, 2048, 128), (1, 8192, 64),
                                      (8, 512, 64), (2, 1000, 128),
                                      (3, 517, 64)])
def test_dkv_kernel_at_the_cells_shapes(cuda_device, hb, seq, d, causal,
                                        out_dtype):
    """K2 alone at the training cells' attention (Pythia's d 128 over
    2048, LFM2's d 64 over 8192 with hb cut, Switch's d 64 over 512) and
    at ragged lengths: against its plain version, and bit for bit the same
    on a second launch."""
    q, k, v, do = inputs(hb, seq, d, "bfloat16", cuda_device, seed=seq + d,
                         n=4)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
    di = (do.float() * o.float()).sum(-1)
    out = getattr(torch, out_dtype)
    runs = []
    before = fa.launches["flash_bwd_dkv"]
    for _ in range(2):
        dk, dv = (torch.empty(q.shape, dtype=out, device=cuda_device)
                  for _ in range(2))
        fa.launch_bwd(q, k, v, do, lse, di, None, dk, dv, scale, causal)
        runs.append((dk, dv))
    torch.cuda.synchronize()
    assert fa.launches["flash_bwd_dkv"] == before + 2
    refs = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di, scale, causal)
    terms = fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, causal)
    for name, g, ref, term in zip(("dk", "dv"), runs[0], refs, terms):
        assert torch.isfinite(g).all(), name
        assert grad_close(g, ref, out_dtype, term), name
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [1, 37, 100, 130, 320, 1000])
@pytest.mark.parametrize("d,dv", [(16, 16), (64, 64), (128, 128), (192, 128)])
def test_dq_kernel_turns_at_the_edges(cuda_device, d, dv, seq, causal):
    """K3 alone where its warpgroups' turns meet the edges: one key, seq
    below one query block and not a multiple of the key tile (a single
    query tile), a second block whose upper warpgroup holds no row, seq a
    multiple of 64 but not of 128; at each head-dim pair, causal and not.
    dq into bf16 against the plain version and bit for bit the same on a
    second launch; into f32 against the plain version, and rounded to bf16
    bit for bit the bf16 dq (the same sums, another store)."""
    q, k = inputs(2, seq, d, "bfloat16", cuda_device, seed=seq + d, n=2)
    v, do = inputs(2, seq, dv, "bfloat16", cuda_device, seed=seq + dv + 1,
                   n=2)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
    di = (do.float() * o.float()).sum(-1)
    runs = [torch.empty_like(q), torch.empty_like(q),
            torch.empty(q.shape, dtype=torch.float32, device=cuda_device)]
    before = dict(fa.launches)
    for dq in runs:
        fa.launch_bwd(q, k, v, do, lse, di, dq, None, None, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches == dict(before, flash_bwd_dq=before["flash_bwd_dq"] + 3)
    ref = fa.flash_bwd_dq_plain(q, k, v, do, lse, di, scale, causal)
    term = fa.rounding_terms_dq(q, k, v, do, lse, di, scale, causal)
    for dq, dt in zip(runs[::2], ("bfloat16", "float32")):
        assert torch.isfinite(dq).all(), dt
        assert grad_close(dq, ref, dt, term), dt
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[2].to(torch.bfloat16), runs[0])


@pytest.mark.gpu
def test_backward_kernels_f32_out_and_one_pass_alone(cuda_device):
    """out_dtype f32 from bf16 inputs, and K2 / K3 launched alone."""
    q, k, v, do = inputs(2, 200, 64, "bfloat16", cuda_device, seed=1, n=4)
    scale = 64 ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale, True, True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, scale, True,
                                   out_dtype=torch.float32)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, True,
                                        out_dtype=torch.float32)
    di = (do.float() * o.float()).sum(-1)
    terms = (fa.rounding_terms_dq(q, k, v, do, lse, di, scale, True),
             *fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, True))
    for g, ref, term in zip(grads, refs, terms):
        assert g.dtype == torch.float32
        assert grad_close(g, ref, "float32", term)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=cuda_device)
    before = dict(fa.launches)
    fa.launch_bwd(q, k, v, do, lse, di, dq, None, None, scale, True)
    torch.cuda.synchronize()
    assert fa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"]
    assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert torch.equal(dq, grads[0])
    with pytest.raises(ValueError, match="dk and dv"):
        fa.launch_bwd(q, k, v, do, lse, di, None, dq, None, scale, True)


@pytest.mark.gpu
def test_grad_goes_through_the_kernels(cuda_device):
    q, k, v = (t.requires_grad_() for t in
               inputs(2, 64, 32, "float32", cuda_device, seed=2))
    before = dict(fa.launches)
    loss = (fa.flash_attention(q, k, v) ** 2).sum()
    loss.backward()
    torch.cuda.synchronize()
    for name in fa.launches:
        assert fa.launches[name] == before[name] + 1, name
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    (fa._reference_attention(qr, kr, vr, 32 ** -0.5, True) ** 2).sum().backward()
    for g, ref in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert (g - ref).abs().max().item() < 1e-4
    with torch.no_grad():
        fa.flash_attention(q, k, v)   # inference under no_grad: K1 only
    bad = torch.zeros((2, 64, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(bad, bad, bad)


@pytest.mark.gpu
def test_serving_forward_goes_through_the_kernel(cuda_device):
    cfg = workload.ModelConfig(**SMALL)
    fwd, params, tokens = workload.build_infer(cfg, attention="flash",
                                               device=cuda_device)
    before = fa.launches["flash_fwd"]
    logits = fwd(params, tokens)
    assert fa.launches["flash_fwd"] == before + cfg.n_layers
    einsum = workload.forward(params, tokens, cfg, "einsum")
    assert logits.shape == (2, 96, 64) and torch.isfinite(logits).all()
    rel = ((logits - einsum).abs().max() / einsum.abs().max()).item()
    assert rel <= 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_training_step_goes_through_the_kernels(cuda_device, remat):
    cfg = workload.ModelConfig(**SMALL, remat=remat)
    step, params, momentum, tokens = workload.build_workload(
        cfg, attention="flash", device=cuda_device)
    before = dict(fa.launches)
    losses = [step(params, momentum, tokens)[2].item() for _ in range(3)]
    per_step = {"flash_fwd": cfg.n_layers * (2 if remat else 1),
                "flash_bwd_dkv": cfg.n_layers, "flash_bwd_dq": cfg.n_layers}
    for name, n in per_step.items():
        assert fa.launches[name] == before[name] + 3 * n, name
    assert losses[-1] < losses[0]
    # the same step's gradients through the plain versions (CPU)
    cpu_params = workload.init_params(torch.Generator().manual_seed(0), cfg,
                                      "cpu")
    gpu_params = {"embed": cpu_params["embed"].to(cuda_device),
                  "unembed": cpu_params["unembed"].to(cuda_device),
                  "layers": {k: w.to(cuda_device)
                             for k, w in cpu_params["layers"].items()}}
    loss, grads = workload.value_and_grad(gpu_params, tokens, cfg, "flash")
    ref_loss, ref = workload.value_and_grad(cpu_params, tokens.cpu(), cfg,
                                            "flash")
    assert abs(loss.item() - ref_loss.item()) < 1e-3
    for g, r in zip(workload._leaves(grads), workload._leaves(ref)):
        assert rel_err(g.cpu(), r) <= 0.03


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sp", [2, 3, 4])
def test_thread_ring_flash_matches_global_plain(cuda_device, dtype, d, sp):
    """Ring flash on one card, its ranks as threads on their own streams,
    against global attention through the plain versions; s_local 50 is no
    multiple of the kernels' tiles. o is allowed, beside the element bar,
    2^-7 x (P|V|) for the bf16 rounding of each step's output and of P in
    other blocks (as chip_smoke.py's ring phase); the gradients are held
    against the plain backward from the ring's own o and lse."""
    from tpu_device_plugin_torch.validator import ring_attention as ra
    s_local = 50
    q, k, v, do = inputs(2, sp * s_local, d, dtype, cuda_device,
                         seed=sp * d, n=4)
    scale = d ** -0.5
    shards = [t.chunk(sp, 1) for t in (q, k, v, do)]

    def member(ring):
        qi, ki, vi, doi = (s[ring.index].contiguous() for s in shards)
        o, lse = ra.ring_flash_forward(qi, ki, vi, scale, ring)
        return (o, lse, *ra.ring_flash_backward(qi, ki, vi, o, lse, doi,
                                                scale, ring))

    before = dict(fa.launches)
    outs = ra.run_on_threads(sp, member, device=cuda_device, timeout_s=120)
    torch.cuda.synchronize()
    for name in fa.launches:
        assert fa.launches[name] == before[name] + sp * (sp + 1) // 2, name
    o, lse, dq, dk, dv = (torch.cat([x[j] for x in outs], 1)
                          for j in range(5))
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, scale, True, True)
    term = None
    if dtype == "bfloat16":
        term = (fa.rounding_terms_fwd(q, k, v, ref_lse, scale, True)
                + fa.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), scale, True))
    assert torch.isfinite(o).all() and o.dtype == q.dtype
    assert grad_close(o, ref_o, dtype, term)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, True,
                                        out_dtype=torch.float32)
    di = (do.float() * o.float()).sum(-1)
    terms = ((fa.rounding_terms_dq(q, k, v, do, lse, di, scale, True),
              *fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, True))
             if dtype == "bfloat16" else (None, None, None))
    for name, g, ref, t in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, terms):
        assert g.dtype == q.dtype and torch.isfinite(g).all(), name
        assert grad_close(g, ref, dtype, t), name


@pytest.mark.gpu
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_moe_dispatch_equals_onehot_on_card(cuda_device, factor):
    """The scatter dispatch against its one-hot plain version on the card,
    bit for bit (each one-hot einsum element is one exact bf16 product)."""
    cfg = workload.ModelConfig(**SMALL, n_experts=4, capacity_factor=factor)
    params = workload.init_params(
        torch.Generator(cuda_device).manual_seed(0), cfg, cuda_device)
    layer = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn((cfg.batch, cfg.seq_len, cfg.d_model), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    with torch.no_grad():
        out = workload._moe(x.bfloat16(), layer, cfg)
        ref = workload._moe_onehot(x.bfloat16(), layer, cfg)
    assert torch.isfinite(out).all() and torch.equal(out, ref)
    assert bool((ref == 0).all(-1).any()) == (factor < 1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["train", "infer"])
def test_moe_paths_go_through_the_kernels(cuda_device, mode):
    """The MoE training step launches K1, K2 and K3 once per layer, the
    serving forward K1 only; training lowers the loss."""
    cfg = workload.ModelConfig(**SMALL, n_experts=4)
    before = dict(fa.launches)
    if mode == "infer":
        fwd, params, tokens = workload.build_infer(cfg, attention="flash",
                                                   device=cuda_device)
        logits = fwd(params, tokens)
        assert torch.isfinite(logits).all()
        per_call = {"flash_fwd": cfg.n_layers, "flash_bwd_dkv": 0,
                    "flash_bwd_dq": 0}
        calls = 1
    else:
        step, params, momentum, tokens = workload.build_workload(
            cfg, attention="flash", device=cuda_device)
        losses = [step(params, momentum, tokens)[2].item() for _ in range(3)]
        assert losses[-1] < losses[0]
        per_call = dict.fromkeys(fa.launches, cfg.n_layers)
        calls = 3
    for name, n in per_call.items():
        assert fa.launches[name] == before[name] + calls * n, name


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_threads_match_plain_step_on_card(cuda_device, remat):
    """GPipe with its 2 stages as threads on the card (each on its own
    stream) against the non-pipelined step on the same weights, einsum
    attention on both sides: the loss within 1e-3, each leaf's gradient
    within 3% of its max |g|; no kernel launches; the loss falls."""
    from tpu_device_plugin_torch.validator import pipeline
    from tpu_device_plugin_torch.validator.ring_attention import run_on_threads
    cfg = workload.ModelConfig(**dict(SMALL, batch=4), remat=remat)
    params, tokens = workload._place(cfg, cuda_device, 0)
    ref_loss, ref = workload.value_and_grad(params, tokens, cfg, "einsum")
    ref = dict(workload._named_leaves(ref))

    def stage(link):
        step, p, m, t = pipeline.build_gpipe(cfg, None, 2, device=cuda_device,
                                             link=link)
        loss, grads = pipeline.gpipe_value_and_grad(p, t, cfg, None, 2, link)
        losses = [step(p, m, t)[2].item() for _ in range(3)]
        return loss, dict(workload._named_leaves(grads)), losses

    before = dict(fa.launches)
    outs = run_on_threads(2, stage, device=cuda_device, timeout_s=120,
                          group=pipeline.ThreadLink(2))
    assert fa.launches == before
    for index, (loss, grads, losses) in enumerate(outs):
        assert abs(loss.item() - ref_loss.item()) < 1e-3
        assert losses[-1] < losses[0]
        for key, g in grads.items():
            r = ref[key]
            if key.startswith("layers."):
                r = r[index:index + 1]
            assert torch.isfinite(g).all() and rel_err(g, r) <= 0.03, key


@pytest.mark.gpu
def test_attn_bench_cells_on_card(cuda_device):
    """attn-bench on the card: every cell timed, the forward chain through
    K1 alone, the train chain through K1, K2 and K3."""
    from tpu_device_plugin_torch.validator.attn_bench import bench_attention
    result = bench_attention(seq_lens=(256, 384), hb=2, iters=2,
                             device=cuda_device)
    assert result["platform"] == "gpu" and result["interpret"] is False
    assert result["flash_ok"]
    for cell in result["cells"]:
        assert cell["error"] == "" and cell["flash_train_ms"] > 0
        assert cell["einsum_train_ms"] > 0
        fwd, train = cell["flash_fwd_launches"], cell["flash_train_launches"]
        assert fwd["flash_fwd"] > 0
        assert fwd["flash_bwd_dkv"] == fwd["flash_bwd_dq"] == 0
        assert all(n > 0 for n in train.values())


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [1, 2])
def test_ring_bench_cells_on_card(cuda_device, sp):
    """ring-bench on one card: sp 1 in this process, sp 2 as threads."""
    from tpu_device_plugin_torch.validator.ring_bench import bench_ring
    result = bench_ring(seq_lens=(512,), sp=sp, hb=2, iters=2,
                        device=cuda_device)
    assert result["ring"] == ("processes" if sp == 1 else "threads")
    assert result["ring_flash_ok"] and result["interpret"] is False
    cell = result["cells"][0]
    assert cell["error"] == "" and cell["einsum_ring_train_ms"] > 0
    assert all(n > 0 for n in cell["ring_flash_train_launches"].values())
    assert cell["ring_flash_fwd_launches"]["flash_bwd_dkv"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [96, workload.FLASH_MIN_SEQ])
def test_auto_attention_on_card_follows_flash_min_seq(cuda_device, seq):
    """auto: einsum below FLASH_MIN_SEQ (no launch), the kernels from it."""
    cfg = workload.ModelConfig(**dict(SMALL, seq_len=seq))
    fwd, params, tokens = workload.build_infer(cfg, device=cuda_device)
    before = fa.launches["flash_fwd"]
    assert torch.isfinite(fwd(params, tokens)).all()
    expected = cfg.n_layers if seq >= workload.FLASH_MIN_SEQ else 0
    assert fa.launches["flash_fwd"] - before == expected


def _cyclic_cuda_garbage() -> dict:
    """What a collection finds in reference cycles: the CUDA tensors, their
    storage in GB, and the functions among the garbage by qualified name
    (a recursive closure shows as `<outer>.<locals>.<name>`)."""
    import gc
    from collections import Counter
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        found = list(gc.garbage)
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
    tensors = [o for o in found if isinstance(o, torch.Tensor) and o.is_cuda]
    storage = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
               for t in tensors}
    return dict(cuda_tensors=len(tensors),
                cuda_storage_gb=sum(storage.values()) / 1e9,
                functions=Counter(o.__qualname__ for o in found
                                  if callable(o) and hasattr(o, "__qualname__")
                                  ).most_common(5))


@pytest.mark.gpu
def test_back_to_back_validations_free_their_memory(cuda_device):
    """Two validate_slice(mfu) training runs with the garbage collector
    off leave memory_allocated within 1 GB of where it started: nothing
    they allocate waits for a collection. Where it fails, the message
    names what a collection then finds (a recursive closure in
    workload._with_leaves once kept each step's gradients alive)."""
    import gc

    from tpu_device_plugin_torch.validator.probe import PRESETS, validate_slice
    cfg = workload.ModelConfig(**PRESETS["mfu"])
    gc.collect()
    start = torch.cuda.memory_allocated()
    gc.disable()
    try:
        for run in range(2):
            report = validate_slice(cfg=cfg, steps=3, mode="train",
                                    device=cuda_device)
            assert report.ok, report.error
            held = torch.cuda.memory_allocated() - start
            if held >= 1e9:
                pytest.fail(f"{held / 1e9} GB held after run {run + 1} of "
                            f"{report.steps} steps; in cycles: "
                            f"{_cyclic_cuda_garbage()}")
    finally:
        gc.enable()


def _xent_inputs(b, s, t, v, device, seed=0, strided=False):
    gen = torch.Generator(device).manual_seed(seed)
    width = v + 3 if strided else v   # rows 3 elements apart: no alignment
    logits = (4 * torch.randn((b, s, width), generator=gen, device=device)
              ).to(torch.bfloat16)[..., :v]
    targets = torch.randint(0, v, (b, t), generator=gen, device=device)
    return logits, targets


def xent_grad_close(grad, ref, targets, g) -> bool:
    t = targets.shape[1]
    bar = GRAD_RTOL["bfloat16"] * ref.float().abs() + XENT_GRAD_ATOL
    bar[:, :t].scatter_add_(-1, targets[..., None], torch.full(
        targets[..., None].shape, XENT_TARGET_ATOL * abs(g), device=bar.device))
    return bool(((grad.float() - ref.float()).abs() <= bar).all())


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape", XENT_SHAPES,
                         ids=[f"B{b}S{s}T{t}V{v}" for b, s, t, v in XENT_SHAPES])
def test_xent_kernels_match_plain(cuda_device, shape, strided):
    b, s, t, v = shape
    logits, targets = _xent_inputs(*shape, cuda_device, strided=strided)
    lse, nll = xent.nll_rows(logits, targets)
    ref_lse, ref_nll = xent.nll_rows_plain(logits, targets)
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= NLL_ATOL
    assert (nll - ref_nll).abs().max().item() <= NLL_ATOL
    g = torch.tensor(0.37, device=cuda_device)
    grad = xent.nll_grad(logits, targets, lse, g)
    leaf = logits.detach().requires_grad_()
    (xent.nll_sum_plain(leaf, targets) * g).backward()
    assert grad.shape == (b, s, v) and grad.dtype == torch.bfloat16
    assert (grad[:, t:] == 0).all()
    assert xent_grad_close(grad, leaf.grad, targets, g.item())
    loss = xent.nll_sum(logits, targets)
    ref = xent.nll_sum_plain(logits, targets)
    assert abs(loss.item() - ref.item()) <= NLL_RTOL * abs(ref.item())


@pytest.mark.gpu
def test_xent_counts_one_launch_each_way_and_raises_on_bad_input(cuda_device):
    logits, targets = _xent_inputs(2, 12, 11, 1001, cuda_device)
    leaf = logits.detach().requires_grad_()
    before = dict(xent.launches)
    with tracing.recording() as rec:
        xent.nll_sum(leaf, targets).backward()
    torch.cuda.synchronize()
    assert xent.launches == {k: n + 1 for k, n in before.items()}
    assert rec.counts["head.fused_rows"] == 2 * 11
    with pytest.raises(ValueError, match="bfloat16 logits"):
        xent.nll_sum(logits.float(), targets)
    with pytest.raises(ValueError, match="0 < T <= S"):
        xent.nll_sum(logits, torch.zeros((2, 13), dtype=torch.int64,
                                         device=cuda_device))
    assert xent.launches == {k: n + 1 for k, n in before.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("n_experts", [0, 2])
def test_training_head_goes_through_the_kernels(cuda_device, n_experts):
    """Each step's head: one xent_fwd and one xent_bwd, B x (seq - 1)
    fused rows, and no log-softmax."""
    cfg = workload.ModelConfig(**SMALL, n_experts=n_experts)
    step, params, momentum, tokens = workload.build_workload(
        cfg, attention="flash", device=cuda_device)
    before = dict(xent.launches)
    with mock.patch("torch.log_softmax", side_effect=AssertionError(
            "log_softmax on the training path")), \
            tracing.recording() as rec:
        losses = [step(params, momentum, tokens)[2].item() for _ in range(3)]
    assert xent.launches == {k: n + 3 for k, n in before.items()}
    assert rec.counts["head.fused_rows"] == 3 * cfg.batch * (cfg.seq_len - 1)
    assert losses[-1] < losses[0]
    with torch.no_grad():   # serving never enters the kernels
        logits = workload.forward(params, tokens, cfg, "flash")
    assert logits.dtype == torch.float32
    assert xent.launches == {k: n + 3 for k, n in before.items()}


@pytest.mark.gpu
def test_hybrid_block_on_card_matches_the_reference(cuda_device):
    """The tiny LFM2 block (tests/torch_lfm2_tiny.py) through K1-K3 and
    `torch._grouped_mm` on the card against the definition's f32
    reference there (TF32 off), following the port's routes: the CPU
    test's bounds, which the fp8 control fails."""
    import torch_lfm2_tiny as tiny
    params, tokens = tiny.inputs(2 ** 31 + 21, cuda_device)
    before = dict(fa.launches)
    conv_before = dict(short_conv.launches)
    loss, grad, new, routes = tiny.port_step(workload, params, tokens,
                                             "flash")
    attention_layers = tiny.MODEL["layer_types"].count("attention")
    for name in fa.launches:
        assert fa.launches[name] == before[name] + attention_layers, name
    conv_layers = tiny.MODEL["layer_types"].count("conv")
    assert short_conv.launches == {k: n + conv_layers
                                   for k, n in conv_before.items()}
    ref = tiny.reference_step(params, tokens, routes)
    gaps = tiny.step_gaps((loss, grad, new), ref[:3], params)
    assert gaps["loss"] <= tiny.LOSS_TOL, gaps
    assert gaps["grad"] <= tiny.GRAD_TOL, gaps
    assert gaps["update"] <= tiny.GRAD_TOL, gaps
    assert ref[3] < 0.02
    control = tiny.reference_step(params, tokens, routes, "fp8")
    assert tiny.step_gaps(control[:3], ref[:3], params)["grad"] \
        > tiny.GRAD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [1, 96, 200, 1000])
def test_latent_attention_kernels_match_plain(cuda_device, seq, causal,
                                              out_dtype):
    """K1, K2 and K3 at latent attention's head dims (q and k 192, v 128)
    against their plain versions, within the bars of the equal-dim
    instances."""
    q, k = inputs(3, seq, 192, "bfloat16", cuda_device, seed=seq, n=2)
    v, do = inputs(3, seq, 128, "bfloat16", cuda_device, seed=seq + 1, n=2)
    scale = 192 ** -0.5
    before = dict(fa.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
    assert o.shape == v.shape
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, True)
    assert grad_close(o, ref_o, "bfloat16",
                      fa.rounding_terms_fwd(q, k, v, ref_lse, scale, causal))
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, scale, causal,
                                   out_dtype=getattr(torch, out_dtype))
    torch.cuda.synchronize()
    assert fa.launches == {name: n + 1 for name, n in before.items()}
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal,
                                        out_dtype=torch.float32)
    di = (do.float() * o.float()).sum(-1)
    terms = (fa.rounding_terms_dq(q, k, v, do, lse, di, scale, causal),
             *fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, causal))
    for name, g, ref, term, like in zip(("dq", "dk", "dv"), grads, refs,
                                        terms, (q, k, v)):
        assert g.shape == like.shape, name
        assert torch.isfinite(g).all(), name
        assert grad_close(g, ref, out_dtype, term), name


@pytest.mark.gpu
def test_latent_attention_block_on_card_matches_the_reference(cuda_device):
    """DeepSeek-V3's block at latent attention's head dims (192 / 128, so
    that its attention runs K1-K3) and a small width, through
    `sgd_step` on the card, against the definition's f32 reference there
    (TF32 off), following the port's routes: the CPU test's bounds
    (tests/torch_moonlight_tiny.py), which the fp8 control fails; K1-K3
    once a layer, `mla.flash_rows` b s heads a layer."""
    import torch_moonlight_tiny as tiny
    model = dict(tiny.MODEL, d_model=256, n_heads=2, kv_lora_rank=64,
                 qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    params, tokens = tiny.inputs(2 ** 31 + 23, cuda_device, model)
    before = dict(fa.launches)
    with tracing.recording() as rec:
        loss, grad, new, routes = tiny.port_step(workload, params, tokens,
                                                 "flash", model)
    layers = model["n_layers"]
    assert fa.launches == {name: n + layers for name, n in before.items()}
    assert rec.counts["mla.flash_rows"] == layers * tiny.BATCH * tiny.SEQ * 2
    ref = tiny.reference_step(params, tokens, routes, model=model)
    gaps = tiny.step_gaps((loss, grad, new), ref[:3], params)
    assert gaps["loss"] <= tiny.LOSS_TOL, gaps
    assert gaps["grad"] <= tiny.GRAD_TOL, gaps
    assert gaps["update"] <= tiny.GRAD_TOL, gaps
    control = tiny.reference_step(params, tokens, routes, "fp8", model)
    assert tiny.step_gaps(control[:3], ref[:3], params)["grad"] \
        > tiny.GRAD_TOL


def _conv_inputs(b, s, d, taps, device, seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    bch = torch.randn((b, s, 3 * d), generator=gen, device=device
                      ).to(torch.bfloat16)
    w = torch.randn((taps, d), generator=gen, device=device) * taps ** -0.5
    dy = torch.randn((b, s, d), generator=gen, device=device
                     ).to(torch.bfloat16)
    return bch, w, dy


def _conv_plain(bch, w, dy):
    """The plain version's y, dbch and dw for dy."""
    leaf, taps = bch.detach().requires_grad_(), w.detach().requires_grad_()
    y = short_conv.gated_conv_plain(leaf, taps)
    y.backward(dy)
    return y.detach(), leaf.grad, taps.grad


def _dw_exact(bch, w, dy):
    """Each tap's gradient as the exact (f64) sum of the bf16 products
    bf16(dy C)[t + K-1-j] bf16(B h)[t], and the sum of their absolute
    values."""
    s, taps = bch.shape[1], w.shape[0]
    gate_b, gate_c, h = bch.chunk(3, -1)
    u, dmixed = gate_b * h, dy * gate_c
    terms = [(dmixed[:, taps - 1 - j:] * u[:, :s - (taps - 1 - j)]).double()
             for j in range(taps)]
    return (torch.stack([t.sum((0, 1)) for t in terms]),
            torch.stack([t.abs().sum((0, 1)) for t in terms]))


def within_one_ulp(out, ref) -> bool:
    """Every bf16 element within one bf16 ulp of |ref| (of the least
    normal bf16 value where ref is smaller)."""
    ref = ref.float()
    mag = ref.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((out.float() - ref).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [2, 3, 4])
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=[f"b{b}s{s}d{d}" for b, s, d in CONV_SHAPES])
def test_conv_kernels_match_plain(cuda_device, shape, taps):
    bch, w, dy = _conv_inputs(*shape, taps, cuda_device)
    y = short_conv.conv_fwd(bch, w)
    dbch, dw = short_conv.conv_bwd(bch, w, dy)
    again = short_conv.conv_bwd(bch, w, dy)
    torch.cuda.synchronize()
    ref_y, ref_dbch, _ = _conv_plain(bch, w, dy)
    assert y.shape == ref_y.shape and y.dtype == torch.bfloat16
    assert dbch.shape == bch.shape and dbch.dtype == torch.bfloat16
    assert dw.shape == w.shape and dw.dtype == torch.float32
    assert within_one_ulp(y, ref_y)
    assert grad_close(dbch, ref_dbch, "bfloat16")
    exact, mag = _dw_exact(bch, w, dy)
    bar = short_conv.dw_sum_depth(*shape[:2]) * 2 ** -24 * mag
    assert ((dw.double() - exact).abs() <= bar).all()
    assert torch.equal(again[0], dbch) and torch.equal(again[1], dw)


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [2, 3, 4])
def test_conv_kernels_keep_the_sequences_apart(cuda_device, taps):
    """Each sequence's outputs and gradients, bit for bit, as alone."""
    bch, w, dy = _conv_inputs(3, 70, 64, taps, cuda_device, seed=1)
    y = short_conv.conv_fwd(bch, w)
    dbch, _ = short_conv.conv_bwd(bch, w, dy)
    for i in range(3):
        one = bch[i:i + 1].contiguous()
        assert torch.equal(short_conv.conv_fwd(one, w), y[i:i + 1])
        alone, _ = short_conv.conv_bwd(one, w, dy[i:i + 1].contiguous())
        assert torch.equal(alone, dbch[i:i + 1])


@pytest.mark.gpu
def test_conv_counts_its_launches_and_rows_and_raises_on_bad_input(
        cuda_device):
    bch, w, dy = _conv_inputs(2, 37, 64, 3, cuda_device)
    leaf = bch.detach().requires_grad_()
    taps = w.detach().requires_grad_()
    before = dict(short_conv.launches)
    with tracing.recording() as rec:
        short_conv.gated_conv(leaf, taps).backward(dy)
    torch.cuda.synchronize()
    assert short_conv.launches == {k: n + 1 for k, n in before.items()}
    assert rec.counts["conv.fused_rows"] == 2 * 37
    assert leaf.grad.dtype == torch.bfloat16 and taps.grad.dtype == torch.float32
    # a CUDA tensor reaches the kernels' checks (tests/test_torch_short_conv.py
    # holds each refusal), and nothing falls back
    with pytest.raises(ValueError, match="contiguous"):
        short_conv.gated_conv(torch.cat([bch, bch], -1)[..., :3 * 64], w)
    assert short_conv.launches == {k: n + 1 for k, n in before.items()}


def _conv_silu_inputs(b, s, d, stride, device, seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    rows = torch.randn((b, s, stride), generator=gen, device=device
                       ).to(torch.bfloat16)
    x = rows[..., stride - d:]
    w = 0.5 * torch.randn((4, d), generator=gen, device=device)
    bias = 0.1 * torch.randn((d,), generator=gen, device=device)
    dy = torch.randn((b, s, d), generator=gen, device=device
                     ).to(torch.bfloat16)
    return x, w, bias, dy


def _conv_silu_bars(x, w, bias, dy):
    """The sum of |w_j x_j| and |bias| of each output of the ungated
    convolution, and of |g w_j| of each input's gradient (|g| = |dy|
    (|silu'(sum)| + the sum's magnitude), 0 past the sequence), times
    CONV_SILU_SUM_TOL."""
    s, taps = x.shape[1], w.shape[0]

    def causal(values, weights):
        acc = values * weights[taps - 1]
        for j in range(taps - 1):
            shift = taps - 1 - j
            if shift < s:
                acc[:, shift:] += values[:, :s - shift] * weights[j]
        return acc

    total = causal(x.float(), w) + bias
    sig = torch.sigmoid(total)
    sums = causal(x.float().abs(), w.abs()) + bias.abs()
    # |g| and the error that the sum's own carries into g (|silu''| < 1)
    g = dy.float().abs() * ((sig * (1 + total * (1 - sig))).abs() + sums)
    grad = g * w[taps - 1].abs()
    for j in range(taps - 1):
        shift = taps - 1 - j
        if shift < s:
            grad[:, :s - shift] += g[:, shift:] * w[j].abs()
    return CONV_SILU_SUM_TOL * sums, CONV_SILU_SUM_TOL * grad


def within_one_ulp_and(out, ref, extra) -> bool:
    """Every bf16 element within one bf16 ulp of |ref| plus `extra`."""
    ref = ref.float()
    mag = ref.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((out.float() - ref).abs() <= ulp + extra).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CONV_SILU_SHAPES,
                         ids=["x".join(map(str, s)) for s in CONV_SILU_SHAPES])
def test_conv_silu_kernels_match_plain(cuda_device, shape):
    x, w, bias, dy = _conv_silu_inputs(*shape, cuda_device)
    y = short_conv.conv_silu_fwd(x, w, bias)
    dx, dw, db = short_conv.conv_silu_bwd(x, w, bias, dy)
    again = short_conv.conv_silu_bwd(x, w, bias, dy)
    leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
    ref = short_conv.conv_silu_plain(*leaves)
    ref.backward(dy)
    y_bar, dx_bar = _conv_silu_bars(x, w, bias, dy)
    assert within_one_ulp_and(y, ref.detach(), y_bar)
    assert within_one_ulp_and(dx, leaves[0].grad, dx_bar)
    assert rel_err(dw, leaves[1].grad) <= CONV_SILU_DW_TOL
    assert rel_err(db, leaves[2].grad) <= CONV_SILU_DW_TOL
    assert all(torch.equal(u, v) for u, v in zip((dx, dw, db), again))


@pytest.mark.gpu
def test_conv_silu_counts_its_launches_and_leaves_the_gated_counts(
        cuda_device):
    x, w, bias, dy = _conv_silu_inputs(2, 37, 64, 96, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (w, bias)]
    before, gated = dict(short_conv.ungated_launches), dict(
        short_conv.launches)
    short_conv.conv_silu(x, *leaves).backward(dy)
    torch.cuda.synchronize()
    assert short_conv.ungated_launches == {k: n + 1
                                           for k, n in before.items()}
    assert short_conv.launches == gated
    with pytest.raises(ValueError, match="take K in"):
        short_conv.conv_silu(x, w[:3], bias)


def _ssd_inputs(b, s, heads, groups, device, seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    p, n = ssd.KERNEL_HEAD_DIM, ssd.KERNEL_STATE
    xbc = torch.randn((b, s, heads * p + 2 * groups * n), generator=gen,
                      device=device).to(torch.bfloat16)
    x, B, C = xbc.split([heads * p, groups * n, groups * n], -1)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, heads), generator=gen, device=device) - 4.6)
    a = -torch.exp(1.386 + 0.5 * torch.randn(heads, generator=gen,
                                              device=device))
    D = 1 + 0.1 * torch.randn(heads, generator=gen, device=device)
    dy = torch.randn((b, s, heads, p), generator=gen, device=device
                     ).to(torch.bfloat16)
    return (x.view(b, s, heads, p), dt, a, B.view(b, s, groups, n),
            C.view(b, s, groups, n), D), dy


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=["x".join(map(str, s)) for s in SSD_SHAPES])
def test_ssd_kernels_match_plain(cuda_device, shape):
    inputs, dy = _ssd_inputs(*shape, cuda_device)
    y, states = ssd.ssd_fwd(*inputs, True)
    grads = ssd.ssd_bwd(*inputs, states, dy)
    again = ssd.ssd_bwd(*inputs, states, dy)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))
    leaves = [t.detach().float().requires_grad_() for t in inputs]
    ref = ssd.ssd_plain(leaves[0].bfloat16(), leaves[1], leaves[2],
                        leaves[3].bfloat16(), leaves[4].bfloat16(),
                        leaves[5])
    ref.backward(dy)
    refs = (ref.detach(), *(t.grad for t in leaves))
    for name, out, r in zip(SSD_TOL, (y, *grads), refs):
        assert out.shape == r.shape, name
        # at one token a's gradient is 0 on both sides (S_-1 = 0)
        scale = r.float().abs().max().clamp(min=1e-30)
        assert (out.float() - r.float()).abs().max() <= SSD_TOL[name] * scale, \
            name


@pytest.mark.gpu
def test_ssd_saves_states_only_under_autograd_and_counts_its_launches(
        cuda_device):
    inputs, dy = _ssd_inputs(2, 130, 4, 1, cuda_device)
    before = dict(ssd.launches)
    with torch.no_grad():
        y = ssd.ssd(*inputs)
    leaves = [inputs[0], *(t.detach().requires_grad_() for t in inputs[1:])]
    ssd.ssd(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert ssd.launches == {"ssd_fwd": before["ssd_fwd"] + 2,
                            "ssd_bwd": before["ssd_bwd"] + 1}
    assert torch.equal(y, ssd.ssd_fwd(*inputs, False)[0])
    with pytest.raises(ValueError, match="head dim"):
        ssd.ssd(inputs[0][..., :32], *inputs[1:])


@pytest.mark.gpu
def test_granite_block_on_card_matches_the_reference(cuda_device):
    """The tiny Granite block (tests/torch_granite_tiny.py) at the widths S1
    takes (head dim 64, state 128) through S1, C1's ungated mode, K1-K3
    and `torch._grouped_mm` on the card against the definition's f32
    reference there (TF32 off), following the port's routes: the CPU
    test's bounds, which the fp8 control fails; `mamba.scan_rows` b s
    heads a Mamba layer."""
    import torch_granite_tiny as tiny
    model = dict(tiny.MODEL, mamba_heads=2, mamba_head_dim=64,
                 mamba_state=128, mamba_groups=1)
    params, tokens = tiny.inputs(2 ** 31 + 23, cuda_device, model)
    before = {**ssd.launches, **short_conv.ungated_launches}
    with tracing.recording() as rec:
        loss, grad, new, routes = tiny.port_step(workload, params, tokens,
                                                 "flash", model)
    mamba = model["layer_types"].count("mamba")
    assert {**ssd.launches, **short_conv.ungated_launches} == {
        k: n + mamba for k, n in before.items()}
    assert rec.counts["mamba.scan_rows"] == mamba * tiny.BATCH * tiny.SEQ * 2
    ref = tiny.reference_step(params, tokens, routes, model=model)
    gaps = tiny.step_gaps((loss, grad, new), ref[:3], params)
    assert gaps["loss"] <= tiny.LOSS_TOL, gaps
    assert gaps["grad"] <= tiny.GRAD_TOL, gaps
    assert gaps["update"] <= tiny.GRAD_TOL, gaps
    control = tiny.reference_step(params, tokens, routes, "fp8", model)
    assert tiny.step_gaps(control[:3], ref[:3], params)["grad"] \
        > tiny.GRAD_TOL
