"""Port parity: a training step and a forward of the port on a (dp, sp, tp)
mesh, over 4 gloo processes, against the JAX package's sharded step on
4 virtual CPU devices and against the port's own single-device step.

Both sides take the JAX package's weights and tokens for one seed (through
numpy), so they start from the same model. The port's processes run
module-level functions of this module, which imports no JAX at import
time (spawned children import it); all mesh cases share one spawn.

Bars: the loss within 1e-3; the gradients (the momentum after one step
from zero momentum) within 3% of max |g| per leaf, the bars of the port's
single-device parity (tests/test_torch_train.py). The port's sharded step
is held to them against its own single-device step and against the JAX
single-device step; against the JAX sharded step, the loss bar grows by
how far the JAX sharded loss itself lies from the JAX single-device one.
XLA rounds tp's partial products otherwise than the port, which sums them
in f32 and rounds once: at tp 2 with ring attention the JAX sharded loss
moved 7.1e-4 from its single-device loss, the port's 6e-5 from its own
(CPU). The sharded forward's logits, gathered, are held to 2% of max
|logit| (and 99% argmax agreement) against the single-device forward.
Each sharded step is also taken with the loss composed as it was before
the head had its kernel pair (`_nll_sum_before`): the same loss and
gradients, bit for bit.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from tpu_device_plugin_torch.validator import workload as tw
from tpu_device_plugin_torch.validator.distributed import spawn
from tpu_device_plugin_torch.validator.mesh import mesh_shape

# test_validator.py's SMALL configuration (n_heads and d_ff divide by 4)
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=1,
             seq_len=16, batch=4)
SEED = 7
# (dp, sp, tp) and the attention mode
CASES = [((1, 2, 2), "einsum"), ((2, 1, 2), "einsum"), ((2, 2, 1), "einsum"),
         ((1, 4, 1), "einsum"), ((1, 2, 2), "ring"), ((2, 1, 2), "ring"),
         ((2, 2, 1), "ring"), ((1, 4, 1), "ring")]
SERVING = [((1, 2, 2), "einsum"), ((2, 2, 1), "ring")]
LOSS_TOL = 1e-3
GRAD_REL_TOL = 0.03
LOGIT_REL_TOL = 0.02
ARGMAX_AGREE_MIN = 0.99


def _unshard(tree, cfg, mesh) -> list:
    """Each leaf of this rank's shards, gathered over tp into the whole
    leaf (numpy, in `_leaves` order)."""
    import torch.distributed as dist
    group, tp = mesh.get_group("tp"), mesh_shape(mesh)["tp"]
    out = []
    specs = tw._leaves(tw.param_specs(cfg))
    for leaf, spec in zip(tw._leaves(tree), specs):
        if "tp" in spec:
            parts = [torch.empty_like(leaf) for _ in range(tp)]
            dist.all_gather(parts, leaf.contiguous(), group=group)
            leaf = torch.cat(parts, spec.index("tp"))
        out.append(leaf.numpy())
    return out


def _nll_sum_before(params, x, targets, ax, cfg):
    """`workload._nll_sum` before the head had its kernel pair: the f32
    logits of `_head`, sliced, log-softmax, gather, sum."""
    logits = tw._head(params, x, ax, cfg)
    logprobs = torch.log_softmax(logits[:, :targets.shape[1]], dim=-1)
    return -torch.gather(logprobs, -1, targets[..., None].long()).sum()


def _worker(rank, _mesh, np_params, np_tokens):
    """Every case on its own mesh over the 4 ranks: one training step (loss
    and whole gradients), the same step with `_nll_sum_before`, and the
    serving forwards (this rank's logits block and its place)."""
    from tpu_device_plugin_torch.validator.mesh import slice_mesh
    cfg = tw.ModelConfig(**SMALL)
    tokens = torch.from_numpy(np.array(np_tokens))
    steps, serving, before = [], [], []
    for (dp, sp, tp), attention in CASES:
        mesh = slice_mesh(4, tp=tp, sp=sp, device_type="cpu")
        for nll_sum, out in ((tw._nll_sum, steps), (_nll_sum_before, before)):
            params = tw.shard_params(tw.params_from_jax(np_params, "cpu"),
                                     cfg, mesh)
            momentum = tw._with_leaves(params, [torch.zeros_like(p)
                                                for p in tw._leaves(params)])
            rows = tw._token_rows(tokens, mesh)
            with mock.patch.object(tw, "_nll_sum", nll_sum):
                _, momentum, loss = tw.sgd_step(params, momentum, rows, cfg,
                                                attention, mesh)
            out.append((loss.item(), _unshard(momentum, cfg, mesh)))
    for (dp, sp, tp), attention in SERVING:
        mesh = slice_mesh(4, tp=tp, sp=sp, device_type="cpu")
        params = tw.shard_params(tw.params_from_jax(np_params, "cpu"), cfg,
                                 mesh)
        block = tw._token_rows(tokens, mesh).chunk(sp, 1)[
            mesh.get_local_rank("sp")]
        with torch.no_grad():
            logits = tw.forward(params, block, cfg, attention, mesh)
        serving.append((mesh.get_local_rank("dp"), mesh.get_local_rank("sp"),
                        logits.numpy()))
    # flash needs the whole sequence on each rank
    try:
        tw.build_infer(cfg, mesh, attention="flash", device="cpu")
        flash_refused = ""
    except ValueError as exc:
        flash_refused = str(exc)
    return steps, serving, flash_refused, before


@pytest.fixture(scope="module")
def jax_inputs():
    jax = pytest.importorskip("jax")
    from tpu_device_plugin.validator import workload as jw
    params = jw.init_params(jax.random.key(SEED), jw.ModelConfig(**SMALL))
    tokens = jax.random.randint(jax.random.key(SEED + 1),
                                (SMALL["batch"], SMALL["seq_len"]), 0,
                                SMALL["vocab"], dtype=jax.numpy.int32)
    return jax.tree.map(np.asarray, params), np.asarray(tokens)


@pytest.fixture(scope="module")
def jax_single():
    """The JAX single-device step per attention mode: (loss, grads)."""
    jax = pytest.importorskip("jax")
    from tpu_device_plugin.validator import workload as jw
    from tpu_device_plugin.validator.mesh import slice_mesh
    out = {}
    for attention in ("einsum", "ring"):
        step, params, momentum, tokens = jw.build_workload(
            jw.ModelConfig(**SMALL), slice_mesh(jax.devices("cpu")[:1]),
            seed=SEED, attention=attention)
        _, momentum, loss = step(params, momentum, tokens)
        out[attention] = (float(loss), jax.tree.leaves(
            jax.tree.map(np.asarray, momentum)))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_inputs):
    """The port: every case over 4 gloo processes, and the single-device
    step and forward on the same weights."""
    np_params, np_tokens = jax_inputs
    per_rank = spawn(_worker, 4, "cpu", timeout_s=300,
                     args=(np_params, np_tokens))
    cfg = tw.ModelConfig(**SMALL)
    params = tw.params_from_jax(np_params, "cpu")
    tokens = torch.from_numpy(np.array(np_tokens))
    with torch.no_grad():
        logits = tw.forward(params, tokens, cfg, "einsum")
    momentum = tw._with_leaves(params, [torch.zeros_like(p)
                                        for p in tw._leaves(params)])
    _, momentum, loss = tw.sgd_step(params, momentum, tokens, cfg, "einsum")
    single = (loss.item(), [m.numpy() for m in tw._leaves(momentum)])
    return per_rank, single, logits.numpy()


def _assert_step_close(got, ref, loss_tol=LOSS_TOL):
    (loss, grads), (ref_loss, ref_grads) = got, ref
    assert abs(loss - ref_loss) < loss_tol, (loss, ref_loss)
    assert len(grads) == len(ref_grads) == 8
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= GRAD_REL_TOL * np.abs(r).max()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-dp{m[0]}sp{m[1]}tp{m[2]}" for m, a in CASES])
def test_sharded_step_matches_jax_and_single_device(case, jax_inputs,
                                                    jax_single, port_runs):
    jax = pytest.importorskip("jax")
    from tpu_device_plugin.validator import workload as jw
    from tpu_device_plugin.validator.mesh import slice_mesh
    (dp, sp, tp), attention = CASES[case]
    per_rank, single, _ = port_runs
    ours = per_rank[0][0][case]
    # every rank reports the same global loss
    assert all(r[0][case][0] == ours[0] for r in per_rank)

    mesh = slice_mesh(jax.devices("cpu")[:4], tp=tp, sp=sp)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == dict(
        dp=dp, sp=sp, tp=tp)
    step, params, momentum, tokens = jw.build_workload(
        jw.ModelConfig(**SMALL), mesh, seed=SEED, attention=attention)
    np.testing.assert_array_equal(np.asarray(tokens), jax_inputs[1])
    _, momentum, loss = step(params, momentum, tokens)
    ref = (float(loss), jax.tree.leaves(jax.tree.map(np.asarray, momentum)))
    jax_shift = abs(ref[0] - jax_single[attention][0])
    _assert_step_close(ours, ref, LOSS_TOL + jax_shift)
    _assert_step_close(ours, jax_single[attention])
    _assert_step_close(ours, single)


@pytest.mark.parametrize("case", range(len(SERVING)),
                         ids=[f"{a}-dp{m[0]}sp{m[1]}tp{m[2]}"
                              for m, a in SERVING])
def test_sharded_forward_matches_single_device(case, port_runs):
    (dp, sp, tp), _ = SERVING[case]
    per_rank, _, ref = port_runs
    rows, width = SMALL["batch"] // dp, SMALL["seq_len"] // sp
    logits = np.full_like(ref, np.nan)
    for _, serving, flash_refused, _ in per_rank:
        assert "flash attention requires sp == 1" in flash_refused
        i, j, block = serving[case]
        got = logits[i * rows:(i + 1) * rows, j * width:(j + 1) * width]
        # tp ranks hold the same block
        assert np.isnan(got).all() or np.array_equal(got, block)
        got[...] = block
    assert np.isfinite(logits).all()
    assert np.abs(logits - ref).max() <= LOGIT_REL_TOL * np.abs(ref).max()
    agree = (logits.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= ARGMAX_AGREE_MIN


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-dp{m[0]}sp{m[1]}tp{m[2]}" for m, a in CASES])
def test_sharded_step_unchanged_by_the_head_split(case, port_runs):
    per_rank, _, _ = port_runs
    for steps, _, _, before in per_rank:
        (loss, grads), (ref_loss, ref_grads) = steps[case], before[case]
        assert loss == ref_loss
        assert len(grads) == len(ref_grads) == 8
        for g, r in zip(grads, ref_grads):
            np.testing.assert_array_equal(g, r)
