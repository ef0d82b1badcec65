"""Port parity: a training step of tpu_device_plugin_torch vs the JAX one.

The JAX side builds its step with `build_workload` (one-CPU mesh; the
Pallas kernels, forward and backward, in interpret mode for flash). Its
weights, momentum and tokens cross to the port through numpy, taken
before each call because the jitted step donates its arguments. The
port's step runs on CPU tensors, so its flash attention is the plain
forward and the plain backward behind the same autograd Function the card
uses.

Tolerances: the loss within 1e-3 after one step and 1e-2 after three;
momentum after one step (= the gradients) within 3% of max |g| per leaf.
Both frameworks run every matmul in bf16 but round at different places;
the largest gap is `embed`'s gradient, a bf16 scatter-add in both (1.6%
measured on a CPU, where the JAX package's own flash and einsum
gradients differ by up to 1.3% per leaf).
"""

import gc

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tpu_device_plugin.validator import workload as jw  # noqa: E402
from tpu_device_plugin_torch.validator import flash_attention as tfa  # noqa: E402
from tpu_device_plugin_torch.validator import workload as tw  # noqa: E402

CONFIGS = {
    "small": dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
                  seq_len=96, batch=2),
    # __graft_entry__.entry()'s configuration (head_dim 16)
    "entry": dict(seq_len=128, batch=4, n_layers=2),
}
GRAD_REL_TOL = 0.03


@pytest.fixture(autouse=True, scope="module")
def _small_torch_pool():
    """The suite runs files side by side (xdist); a small intra-op pool
    keeps torch's busy threads from starving the timing-based tests in
    the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def from_jax(tree):
    return tw.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("attention", ["flash", "einsum"])
@pytest.mark.parametrize("name", ["small", "entry"])
def test_sgd_step_matches_jax(name, attention):
    cfg_kw = CONFIGS[name]
    step, params, momentum, tokens = jw.build_workload(
        jw.ModelConfig(**cfg_kw), attention=attention)
    tparams, tmom = from_jax(params), from_jax(momentum)
    ttokens = torch.from_numpy(np.array(tokens))
    cfg = tw.ModelConfig(**cfg_kw)
    launches = dict(tfa.launches)
    losses, ref = [], []
    for i in range(3):
        params, momentum, loss = step(params, momentum, tokens)
        ref.append(float(loss))
        out = tw.sgd_step(tparams, tmom, ttokens, cfg, attention)
        assert out[0] is tparams and out[1] is tmom   # updated in place
        losses.append(out[2].item())
        if i == 0:
            assert abs(losses[0] - ref[0]) < 1e-3
            grads = tw._leaves(from_jax(momentum))
            assert len(grads) == len(tw._leaves(tmom)) == 8
            for g, r in zip(tw._leaves(tmom), grads):
                r = torch.as_tensor(r)
                assert g.shape == r.shape
                err = (g - r).abs().max().item()
                assert err <= GRAD_REL_TOL * r.abs().max().item()
    assert abs(losses[-1] - ref[-1]) < 1e-2
    assert losses[-1] < losses[0]
    assert tfa.launches == launches   # the CPU never launches a kernel


@pytest.mark.parametrize("attention", ["flash", "einsum"])
def test_remat_gives_the_same_loss_and_grads(attention):
    cfg = tw.ModelConfig(**CONFIGS["small"])
    _, params, _, tokens = tw.build_workload(cfg, seed=2, device="cpu")
    loss, grads = tw.value_and_grad(params, tokens, cfg, attention)
    rloss, rgrads = tw.value_and_grad(params, tokens,
                                      tw.ModelConfig(**CONFIGS["small"],
                                                     remat=True), attention)
    assert abs(loss.item() - rloss.item()) <= 1e-6
    for g, r in zip(tw._leaves(grads), tw._leaves(rgrads)):
        assert (g - r).abs().max().item() <= 1e-6
    # the caller's params never become autograd leaves
    assert not any(p.requires_grad for p in tw._leaves(params))


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["collector_on", "collector_off"])
def test_sgd_step_pauses_the_collector_and_restores_it(monkeypatch, enabled):
    """No automatic garbage collection while a step builds and runs its
    graph, and the collector as the caller had it once the step returns,
    also when the step raises."""
    cfg = tw.ModelConfig(**CONFIGS["small"])
    _, params, momentum, tokens = tw.build_workload(cfg, seed=3,
                                                    device="cpu")
    seen = []
    grad = tw.value_and_grad

    def value_and_grad(*args, **kwargs):
        seen.append(gc.isenabled())
        return grad(*args, **kwargs)

    monkeypatch.setattr(tw, "value_and_grad", value_and_grad)
    (gc.enable if enabled else gc.disable)()
    try:
        tw.sgd_step(params, momentum, tokens, cfg, "einsum")
        assert seen == [False]
        assert gc.isenabled() is enabled
        with pytest.raises(IndexError):
            tw.sgd_step(params, momentum, tokens + cfg.vocab, cfg, "einsum")
        assert seen == [False, False]
        assert gc.isenabled() is enabled
    finally:
        gc.enable()


def test_build_workload_is_seeded_with_zero_momentum():
    cfg = tw.ModelConfig(**CONFIGS["small"])
    step, p1, m1, t1 = tw.build_workload(cfg, seed=3, device="cpu")
    _, p2, _, t2 = tw.build_workload(cfg, seed=3, device="cpu")
    _, p_infer, t_infer = tw.build_infer(cfg, seed=3, device="cpu")
    for a, b, c in zip(tw._leaves(p1), tw._leaves(p2), tw._leaves(p_infer)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(t1, t2) and torch.equal(t1, t_infer)
    assert all(not m.any() for m in tw._leaves(m1))
    before = p1["unembed"].clone()
    _, _, loss = step(p1, m1, t1)
    assert loss.shape == () and torch.isfinite(loss)
    # p <- p - lr * m with m = g after the first step
    assert torch.allclose(p1["unembed"], before - cfg.lr * m1["unembed"])


def test_port_entry_matches_graft_entry():
    import __graft_entry__
    from tpu_device_plugin_torch.entry import entry
    jfn, (jparams, jtokens) = __graft_entry__.entry()
    ref = float(jfn(jparams, jtokens))
    fn, (params, tokens) = entry("cpu")
    assert params["layers"]["wq"].shape == (2, 128, 128)
    assert tokens.shape == (4, 128) and tokens.device.type == "cpu"
    assert torch.isfinite(fn(params, tokens))
    # on the JAX entry's own weights and tokens, the same loss
    loss = fn(from_jax(jparams), torch.from_numpy(np.array(jtokens)))
    assert abs(loss.item() - ref) < 1e-3


def test_training_builds_refuse_without_cuda(monkeypatch):
    from tpu_device_plugin_torch.entry import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tw.build_workload(),
                  lambda: tw.build_workload(tw.ModelConfig(), attention="flash"),
                  lambda: entry()):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


@pytest.mark.parametrize("preset", ["burnin", "mfu", "mfu-lite"])
def test_workload_flops_matches_jax(preset):
    from tpu_device_plugin.validator import probe as jprobe
    from tpu_device_plugin_torch.validator import probe as tprobe
    assert tprobe.PRESETS[preset] == jprobe.PRESETS[preset]
    cfg = tprobe.PRESETS[preset]
    assert (tprobe._workload_flops(tw.ModelConfig(**cfg))
            == jprobe._workload_flops(jw.ModelConfig(**cfg)))
