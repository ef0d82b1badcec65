"""Port parity: the top-1 switch MoE of tpu_device_plugin_torch vs the JAX one,
on one device.

The JAX side builds its step and forward with `build_workload` and
`build_infer` (one-CPU mesh; flash through the Pallas kernels in interpret
mode); its weights, momentum and tokens cross to the port through numpy.

Routing. On the same input the port routes exactly as the jitted JAX
`_moe`: the same argmax expert, queue place and drop for every token. Its
router logits are the f32 products of the bf16 operands, as jit computes
them (XLA folds the JAX code's bf16 rounding of `xt @ wr` into the f32
convert). Through a whole step the router's inputs are not bit for bit
the same: XLA on the CPU rounds each op of `jax.nn.gelu` to bf16 where the
port's GELU rounds once, and inside jit it keeps some sums in f32 across
fusions (a residual add fused into the next RMSNorm). The logits then
differ by some dl, and a token whose two best logits lie within dl of
each other can take the other expert: a tie at the rounding level, after
which the token's whole MoE output differs. The step tests therefore
record both sides' router logits inside the real step (the JAX `_moe`
hands them to the host by `jax.debug.callback` from the jitted scan),
print how many routes agree, require every disagreement to be such a tie
and 97% of routes to agree, and take the port's step on the JAX routes
(with the port's own gates) for the loss and gradient bars, so that a tie
cannot stand in for a fault, nor hide one.

Bars, those of the dense step (tests/test_torch_train.py): the loss within
1e-3 after one step and 1e-2 after three, the gradients within 3% of max
|g| per leaf, logits within 2% of max |logit|. The scatter dispatch
(`_moe`) equals its one-hot plain version (`_moe_onehot`) bit for bit:
each element of the one-hot einsums is a single product of bf16 values,
exact in f32, rounded once.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_device_plugin.validator import workload as jw  # noqa: E402
from tpu_device_plugin_torch.validator import workload as tw  # noqa: E402

# test_validator.py's SMALL configuration
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=16, batch=4)
# (n_experts, capacity_factor, attention); 0.25 drops tokens
STEP_CASES = [(2, 1.25, "einsum"), (4, 1.25, "einsum"), (2, 0.25, "einsum"),
              (4, 0.25, "einsum"), (4, 1.25, "flash")]
LOSS_TOL = 1e-3
LOSS_TOL_STEP3 = 1e-2
GRAD_REL_TOL = 0.03
LOGIT_REL_TOL = 0.02
ROUTE_AGREE_MIN = 0.97


@pytest.fixture(autouse=True, scope="module")
def _small_torch_pool():
    """A small intra-op pool while the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def from_jax(tree):
    return tw.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def record_jax_logits(monkeypatch):
    """Wraps the JAX `_moe`: each call hands its router logits (t, E), as
    `_moe` computes them, to the returned list."""
    calls = []
    real = jw._moe

    def recording(x, layer, cfg, mesh):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ layer["wr"].astype(jnp.bfloat16)).astype(jnp.float32)
        jax.debug.callback(lambda lg: calls.append(np.asarray(lg)), logits,
                           ordered=True)
        return real(x, layer, cfg, mesh)
    monkeypatch.setattr(jw, "_moe", recording)
    return calls


def route_port_as_jax(monkeypatch, jax_calls):
    """Replaces the port's `_route`: the k-th call takes the experts of the
    JAX side's k-th routing, with the gates of the port's own softmax, and
    records the port's own logits (returned list)."""
    calls = []

    def pinned(xt, wr):
        logits = xt.float() @ tw._bf16(wr).float()
        top1 = torch.from_numpy(jax_calls[len(calls)].argmax(-1))
        calls.append(logits.detach().numpy().copy())
        gates = torch.softmax(logits, dim=-1)
        return gates.gather(-1, top1[:, None])[:, 0], top1
    monkeypatch.setattr(tw, "_route", pinned)
    return calls


def check_routes(ours, ref) -> int:
    """Each routing's argmax experts, ours against the reference's. The
    router's inputs carry rounding-level differences between the sides,
    so its logits differ by up to some dl (held to 2% of max |logit|);
    every disagreement must be a tie at that level: the two experts'
    logits within dl of each other on the reference side. At least 97% of
    the routes agree. Returns the number of disagreements."""
    assert len(ours) == len(ref) > 0
    agree, flips = [], 0
    for lp, lj in zip(ours, ref):
        dl = np.abs(lp - lj).max()
        assert dl <= LOGIT_REL_TOL * np.abs(lj).max()
        a, b = lp.argmax(-1), lj.argmax(-1)
        agree.append(int((a == b).sum()))
        for t in np.nonzero(a != b)[0]:
            assert abs(lj[t, a[t]] - lj[t, b[t]]) <= dl, (t, lp[t], lj[t])
            flips += 1
    print(f"routes agreeing per routing: {agree} of {ref[0].shape[0]}; "
          f"{flips} ties")
    assert sum(agree) >= ROUTE_AGREE_MIN * len(ref) * ref[0].shape[0]
    return flips


@pytest.mark.parametrize("n_experts,factor,attention", STEP_CASES,
                         ids=[f"e{e}-cf{f}-{a}" for e, f, a in STEP_CASES])
def test_moe_step_matches_jax(n_experts, factor, attention, monkeypatch):
    cfg_kw = dict(SMALL, n_experts=n_experts, capacity_factor=factor)
    jax_calls = record_jax_logits(monkeypatch)
    step, params, momentum, tokens = jw.build_workload(
        jw.ModelConfig(**cfg_kw), attention=attention)
    tparams, tmom = from_jax(params), from_jax(momentum)
    ttokens = torch.from_numpy(np.array(tokens))
    cfg = tw.ModelConfig(**cfg_kw)
    ref, grads = [], None
    for i in range(3):
        params, momentum, loss = step(params, momentum, tokens)
        ref.append(float(loss))
        if i == 0:
            grads = tw._leaves(from_jax(momentum))
    jax.effects_barrier()
    assert len(jax_calls) == 3 * cfg.n_layers
    port_calls = route_port_as_jax(monkeypatch, jax_calls)
    losses = []
    for i in range(3):
        losses.append(tw.sgd_step(tparams, tmom, ttokens, cfg,
                                  attention)[2].item())
        if i == 0:
            assert abs(losses[0] - ref[0]) < LOSS_TOL
            assert len(grads) == len(tw._leaves(tmom)) == 9
            for g, r in zip(tw._leaves(tmom), grads):
                assert g.shape == r.shape
                err = (g - r).abs().max().item()
                assert err <= GRAD_REL_TOL * r.abs().max().item()
    check_routes(port_calls, jax_calls)
    assert abs(losses[-1] - ref[-1]) < LOSS_TOL_STEP3
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("n_experts", [2, 4])
def test_moe_forward_matches_jax(n_experts, monkeypatch):
    cfg_kw = dict(SMALL, n_experts=n_experts)
    jax_calls = record_jax_logits(monkeypatch)
    fwd, params, tokens = jw.build_infer(jw.ModelConfig(**cfg_kw), seed=1,
                                         attention="einsum")
    ref = np.asarray(fwd(params, tokens))
    jax.effects_barrier()
    port_calls = route_port_as_jax(monkeypatch, jax_calls)
    with torch.no_grad():
        out = tw.forward(from_jax(params), torch.from_numpy(np.array(tokens)),
                         tw.ModelConfig(**cfg_kw), "einsum").numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= LOGIT_REL_TOL * np.abs(ref).max()
    check_routes(port_calls, jax_calls)


@pytest.mark.parametrize("n_experts,factor", [(2, 1.25), (4, 1.25),
                                              (2, 0.25), (4, 0.25)])
def test_moe_layer_routes_as_jax_on_the_same_input(n_experts, factor):
    """Both `_moe`s on one input and one layer's weights, the JAX one
    jitted as the step runs it: the same expert and the same drops (a zero
    output row) for every token, and outputs within the GELU's rounding
    (2% of max |out|)."""
    cfg_kw = dict(SMALL, n_experts=n_experts, capacity_factor=factor)
    jcfg = jw.ModelConfig(**cfg_kw)
    params = jw.init_params(jax.random.key(3), jcfg)
    layer = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.key(4), (4, 16, 32)).astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda x_, l_: jw._moe(x_, l_, jcfg, None))(
        x, layer).astype(jnp.float32))
    logits = np.asarray(jax.jit(lambda x_, w: (
        x_.reshape(-1, 32) @ w.astype(jnp.bfloat16)).astype(jnp.float32))(
            x, layer["wr"]))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tlayer = from_jax(layer)
    out = tw._moe(tx, tlayer, tw.ModelConfig(**cfg_kw)).float().numpy()
    _, top1 = tw._route(tx.reshape(-1, 32), tlayer["wr"])
    np.testing.assert_array_equal(top1.numpy(), logits.argmax(-1))
    dropped = (ref == 0).all(-1)
    np.testing.assert_array_equal((out == 0).all(-1), dropped)
    assert dropped.any() == (factor < 1)
    assert np.abs(out - ref).max() <= LOGIT_REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("n_experts,factor", [(2, 1.25), (4, 1.25),
                                              (2, 0.25), (4, 0.25)])
def test_scatter_dispatch_equals_onehot(n_experts, factor):
    """`_moe` against its one-hot plain version: the outputs bit for bit,
    with and without drops; the gradients to the MoE's input and weights
    within f32 summation noise (the gate's gradient sums its d products in
    another order)."""
    cfg = tw.ModelConfig(**SMALL, n_experts=n_experts,
                         capacity_factor=factor)
    params = tw.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    layer = {k: v[0].clone().requires_grad_()
             for k, v in params["layers"].items()}
    x = (torch.randn((4, 16, 32), generator=torch.Generator().manual_seed(6))
         .bfloat16().requires_grad_())
    out = tw._moe(x, layer, cfg)
    ref = tw._moe_onehot(x, layer, cfg)
    assert torch.equal(out, ref)
    dropped = int((ref == 0).all(-1).sum())
    assert (dropped > 0) == (factor < 1)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    names = ["x", "wr", "w1e", "w2e"]
    inputs = [x] + [layer[n] for n in names[1:]]
    got = torch.autograd.grad(out, inputs, dout.bfloat16())
    want = torch.autograd.grad(ref, inputs, dout.bfloat16())
    for name, g, r in zip(names, got, want):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 1e-2 * r.float().abs().max().item(), name


def test_moe_capacity_is_the_jax_formula():
    """The JAX version's `cap` (workload.py:247): t x factor / E, rounded
    up to a multiple of 8, at least 8, at most t."""
    for t, e, factor, cap in [(64, 2, 1.25, 40), (64, 4, 1.25, 24),
                              (64, 2, 0.25, 8), (64, 4, 0.25, 8),
                              (16384, 4, 1.25, 5120), (8, 4, 1.25, 8),
                              (4, 4, 1.25, 4), (100, 3, 1.0, 40)]:
        assert tw._capacity(t, e, factor) == cap


def test_moe_remat_gives_the_same_loss_and_grads():
    cfg = tw.ModelConfig(**SMALL, n_experts=4, capacity_factor=0.25)
    _, params, _, tokens = tw.build_workload(cfg, seed=2, device="cpu")
    loss, grads = tw.value_and_grad(params, tokens, cfg, "flash")
    rloss, rgrads = tw.value_and_grad(
        params, tokens, tw.ModelConfig(**SMALL, n_experts=4,
                                       capacity_factor=0.25, remat=True),
        "flash")
    assert abs(loss.item() - rloss.item()) <= 1e-6
    for g, r in zip(tw._leaves(grads), tw._leaves(rgrads)):
        assert (g - r).abs().max().item() <= 1e-6


def test_moe_ring_of_one_serves_as_einsum():
    """Without a mesh, ring attention is a ring of one; the MoE forward
    through it agrees with the einsum forward."""
    cfg = tw.ModelConfig(**SMALL, n_experts=4)
    fwd, params, tokens = tw.build_infer(cfg, attention="ring", device="cpu")
    ring = fwd(params, tokens)
    einsum = tw.forward(params, tokens, cfg, "einsum")
    assert torch.isfinite(ring).all()
    assert (ring - einsum).abs().max() <= LOGIT_REL_TOL * einsum.abs().max()


def test_moe_workload_flops_ignore_the_experts():
    """As the JAX probe's: the dense MLP's FLOPs (one expert per token)."""
    from tpu_device_plugin.validator import probe as jprobe
    from tpu_device_plugin_torch.validator import probe as tprobe
    cfg_kw = dict(tprobe.PRESETS["mfu"], n_experts=4)
    assert (tprobe._workload_flops(tw.ModelConfig(**cfg_kw))
            == jprobe._workload_flops(jw.ModelConfig(**cfg_kw))
            == tprobe._workload_flops(tw.ModelConfig(**tprobe.PRESETS["mfu"])))
