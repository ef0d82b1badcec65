"""Port parity of the GPipe schedule (pipeline.py): the port's GPipe loss and
gradients over 4 gloo processes (pp 2 x dp 2, 4 microbatches) against the
JAX package's `gpipe_loss_fn` on 4 virtual CPU devices and against the
port's single-device step; the thread link against the gloo link; the
probe's GPipe branch and the CLI's refusals.

Both sides take the JAX package's weights (`init_params(key(5))`) and
tokens (`key(6)`) at tests/test_validator.py's GPipe configuration,
through numpy. The port's processes run `_worker`, a module-level function
of this module, which imports no JAX at import time; all the gloo cases
share one spawn.

Bars, those of the dense parity tests (tests/test_torch_train.py): the
loss within 1e-3, each leaf's gradient within 3% of its max |g|. The JAX
package's own GPipe sits within 1.4e-6 of its plain loss and its
gradients within 0.35% of max |g| per leaf at this configuration. Against
the JAX GPipe, the loss bar grows by how far the port's single-device loss
lies from the JAX package's on the same weights, as test_torch_sharded.py's
grows by XLA's partitioning shift: at this seed the dense paths differ by
1.37e-3, all of it the MLP's GELU (XLA on the CPU rounds each op of
`jax.nn.gelu` to bf16, the port once: one bf16 ulp in some hidden units
from layer 0 on; ROADMAP.md, deliberate differences). The schedule's own
shift, GPipe minus single-device, is held to agree between the two
frameworks within 1e-4. Remat equals no remat within 1e-5 (loss) and 1e-4 (each
gradient element), as test_validator.py's remat tests hold the JAX side.
At pp 2 x dp 1 the two links carry the same tensors and the sums over pp
add a zero, so the thread link equals the gloo link bit for bit.
"""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from tpu_device_plugin_torch.validator import pipeline as pl
from tpu_device_plugin_torch.validator import probe
from tpu_device_plugin_torch.validator import workload as tw
from tpu_device_plugin_torch.validator.distributed import spawn
from tpu_device_plugin_torch.validator.mesh import mesh_shape

# test_validator.py's GPipe configuration
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=16, batch=8)
N_MICRO = 4
LOSS_TOL = 1e-3
GRAD_REL_TOL = 0.03
SHIFT_TOL = 1e-4
REMAT_LOSS_TOL = 1e-5
REMAT_GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _small_torch_pool():
    """The suite runs files side by side (xdist): a small intra-op pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _stage_params(np_params, stage: int, stages: int):
    """Stage `stage`'s params of the whole numpy tree: its layers, embed
    and unembed whole."""
    params = tw.params_from_jax(np_params, "cpu")
    per = SMALL["n_layers"] // stages
    params["layers"] = {key: w[stage * per:(stage + 1) * per].clone()
                        for key, w in params["layers"].items()}
    return params


def _numpy(loss, grads):
    return loss.item(), {key: g.numpy() for key, g in tw._named_leaves(grads)}


def _worker(rank, mesh, np_params, np_tokens):
    """On the pp 2 x dp 2 mesh: GPipe loss and gradients without and with
    remat, the forward-only loss, and 4 training steps' losses. Then pp 2
    x dp 1 over ranks 0 and 1 through a process-group link, and on rank 0
    the same through a thread link (2 threads of this process)."""
    import torch.distributed as dist

    from tpu_device_plugin_torch.validator.ring_attention import run_on_threads
    cfg = tw.ModelConfig(**SMALL)
    stage, row = mesh.get_local_rank("pp"), mesh.get_local_rank("dp")
    params = _stage_params(np_params, stage, 2)
    tokens = torch.from_numpy(np_tokens)
    rows = tw._token_rows(tokens, mesh)
    out = {"place": (stage, row), "shape": mesh_shape(mesh)}
    for remat in (False, True):
        out[f"remat={remat}"] = _numpy(*pl.gpipe_value_and_grad(
            params, rows, replace(cfg, remat=remat), mesh, N_MICRO))
    out["loss_fn"] = pl.gpipe_loss_fn(params, rows, cfg, mesh, N_MICRO).item()
    step, p, m, t = pl.build_gpipe(cfg, mesh, N_MICRO, device="cpu")
    out["losses"] = [step(p, m, t)[2].item() for _ in range(4)]

    pair = dist.new_group([0, 1])   # every rank takes part in making it
    if rank < 2:
        out["gloo_link"] = _numpy(*pl.gpipe_value_and_grad(
            _stage_params(np_params, rank, 2), tokens, cfg, None, N_MICRO,
            pl.ProcessGroupLink(pair)))
    if rank == 0:
        out["thread_link"] = run_on_threads(2, lambda link: _numpy(
            *pl.gpipe_value_and_grad(_stage_params(np_params, link.index, 2),
                                     tokens, cfg, None, N_MICRO, link)),
            group=pl.ThreadLink(2, timeout_s=120))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's weights and tokens (numpy), its GPipe (pp 2 x
    dp 2, 4 microbatches) loss and gradients, and its single-device loss."""
    jax = pytest.importorskip("jax")
    from tpu_device_plugin.validator import workload as jw
    from tpu_device_plugin.validator.mesh import slice_mesh
    from tpu_device_plugin.validator.pipeline import gpipe_loss_fn
    cfg = jw.ModelConfig(**SMALL)
    params = jw.init_params(jax.random.key(5), cfg)
    tokens = jax.random.randint(jax.random.key(6), (cfg.batch, cfg.seq_len),
                                0, cfg.vocab, dtype=jax.numpy.int32)
    mesh = slice_mesh(jax.devices()[:4], pp=2, tp=1, sp=1)
    loss, grads = jax.value_and_grad(
        lambda p: gpipe_loss_fn(p, tokens, cfg, mesh, N_MICRO))(params)
    np_params = jax.tree.map(np.asarray, params)
    return (np_params, np.asarray(tokens), float(loss),
            jax.tree.map(np.asarray, grads),
            float(jw.loss_fn(params, tokens, cfg)))


@pytest.fixture(scope="module")
def port_runs(jax_side):
    """Every rank's results of the one spawn, by (pp, dp) place."""
    np_params, np_tokens, *_ = jax_side
    ranks = spawn(_worker, 4, "cpu", timeout_s=300,
                  args=(np_params, np_tokens),
                  mesh=dict(pp=2, tp=1, sp=1))
    return {r["place"]: r for r in ranks}


def _whole(runs, key):
    """(loss, {leaf: whole gradient}) of `key`'s run: each stage's layers
    joined (from dp row 0), embed and unembed from stage 0."""
    loss, grads = runs[(0, 0)][key]
    _, later = runs[(1, 0)][key]
    whole = {name: (np.concatenate([g, later[name]]) if name.startswith(
        "layers.") else g) for name, g in grads.items()}
    return loss, whole


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_mesh_is_pp2_dp2(port_runs):
    assert port_runs[(0, 0)]["shape"] == {"pp": 2, "dp": 2, "sp": 1, "tp": 1}
    assert sorted(port_runs) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_gpipe_loss_matches_jax_gpipe_and_single_device(jax_side, port_runs):
    np_params, np_tokens, jax_loss, _, jax_single = jax_side
    cfg = tw.ModelConfig(**SMALL)
    single = tw.loss_fn(tw.params_from_jax(np_params, "cpu"),
                        torch.from_numpy(np_tokens.copy()), cfg).item()
    dense_shift = abs(single - jax_single)
    for run in port_runs.values():   # every rank has the global loss
        loss, _ = run["remat=False"]
        assert abs(loss - single) <= LOSS_TOL
        assert abs(loss - jax_loss) <= LOSS_TOL + dense_shift
        assert abs((loss - single) - (jax_loss - jax_single)) <= SHIFT_TOL
        assert run["loss_fn"] == pytest.approx(loss, abs=1e-6)


def test_gpipe_grads_match_jax_gpipe(jax_side, port_runs):
    _, _, _, jax_grads, _ = jax_side
    _, grads = _whole(port_runs, "remat=False")
    for name, g in grads.items():
        ref = jax_grads
        for part in name.split("."):
            ref = ref[part]
        assert g.shape == ref.shape
        assert _rel(g, ref) <= GRAD_REL_TOL, name


def test_gpipe_grads_match_single_device(jax_side, port_runs):
    np_params, np_tokens, *_ = jax_side
    _, ref = tw.value_and_grad(tw.params_from_jax(np_params, "cpu"),
                               torch.from_numpy(np_tokens.copy()),
                               tw.ModelConfig(**SMALL), "einsum")
    ref = {key: g.numpy() for key, g in tw._named_leaves(ref)}
    _, grads = _whole(port_runs, "remat=False")
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        assert _rel(g, ref[name]) <= GRAD_REL_TOL, name


def test_dp_replicas_hold_equal_gradients(port_runs):
    """dp rows of one stage end with the same (summed) gradients."""
    for stage in (0, 1):
        _, a = port_runs[(stage, 0)]["remat=False"]
        _, b = port_runs[(stage, 1)]["remat=False"]
        for name in a:
            assert np.array_equal(a[name], b[name]), (stage, name)


def test_gpipe_remat_equals_no_remat(port_runs):
    for run in port_runs.values():
        loss, grads = run["remat=False"]
        loss_r, grads_r = run["remat=True"]
        assert abs(loss - loss_r) <= REMAT_LOSS_TOL
        for name in grads:
            assert np.abs(grads[name] - grads_r[name]).max() <= REMAT_GRAD_TOL


def test_thread_link_equals_gloo_link_bit_for_bit(port_runs):
    """pp 2 x dp 1: stage i of the thread link (rank 0's threads) against
    stage i of the gloo link (rank i), to the last bit."""
    threads = port_runs[(0, 0)]["thread_link"]
    for stage, place in ((0, (0, 0)), (1, (0, 1))):
        loss, grads = port_runs[place]["gloo_link"]
        t_loss, t_grads = threads[stage]
        assert t_loss == loss
        assert sorted(t_grads) == sorted(grads)
        for name in grads:
            assert np.array_equal(t_grads[name], grads[name]), (stage, name)


def test_build_gpipe_trains_on_the_mesh(port_runs):
    for run in port_runs.values():
        losses = run["losses"]
        assert losses[-1] < losses[0]
    assert len({tuple(r["losses"]) for r in port_runs.values()}) == 1


@pytest.mark.parametrize("sizes,n_micro,local,match", [
    ({"dp": 4, "sp": 1, "tp": 1}, 2, 2, "'pp' mesh axis"),
    ({"pp": 2, "dp": 1, "sp": 1, "ep": 2, "tp": 1}, 2, 8, "ep == 1"),
    ({"pp": 2, "dp": 1, "sp": 1, "tp": 2}, 2, 8, "sp == tp == ep == 1"),
    ({"pp": 4, "dp": 1, "sp": 1, "tp": 1}, 2, 8, "n_layers=2 not divisible"),
    ({"pp": 2, "dp": 2, "sp": 1, "tp": 1}, 3, 4, "local batch 4 not divis"),
    ({"pp": 2, "dp": 2, "sp": 1, "tp": 1}, 0, 4, "n_micro=0"),
])
def test_check_gpipe_refuses_with_the_jax_wording(sizes, n_micro, local,
                                                  match):
    with pytest.raises(ValueError, match=match):
        pl.check_gpipe(tw.ModelConfig(**SMALL), sizes, n_micro, local)


def test_build_gpipe_without_pp_is_a_value_error():
    with pytest.raises(ValueError, match="'pp' mesh axis"):
        pl.build_gpipe(tw.ModelConfig(**SMALL), None, 2, device="cpu")


def test_validate_slice_gpipe_over_four_processes():
    report = probe.validate_slice(cfg=tw.ModelConfig(**SMALL), steps=2,
                                  pp=2, tp=1, sp=1, gpipe_microbatches=2,
                                  device="cpu", n_devices=4)
    assert report.ok, report.error
    assert report.loss_end < report.loss_start
    assert report.mesh_shape == {"pp": 2, "dp": 2, "sp": 1, "tp": 1}
    assert report.steps == 1 + 2 + 4
    assert report.tflops_per_chip == pytest.approx(
        probe._workload_flops(tw.ModelConfig(**SMALL)) / report.step_time_s
        / 1e12 / 4)


@pytest.mark.parametrize("kw,match", [
    # pp 2 x dp 4: local batch 2, not divisible by 4 microbatches
    (dict(pp=2, tp=1, gpipe_microbatches=4, n_devices=8), "local batch 2"),
    (dict(tp=2, gpipe_microbatches=2, n_devices=4), "'pp' mesh axis"),
    (dict(pp=2, ep=2, tp=1, gpipe_microbatches=2, n_devices=4), "ep == 1"),
])
def test_validate_slice_gpipe_config_errors(kw, match):
    """Configurations the schedule cannot run are the caller's (exit 2),
    found before any process starts."""
    report = probe.validate_slice(cfg=tw.ModelConfig(**SMALL), steps=1, sp=1,
                                  device="cpu", **kw)
    assert report.invalid_config and not report.ok
    assert report.error.startswith("invalid configuration")
    assert match in report.error


def test_gpipe_pp2_on_one_device_is_the_divisibility_error(capsys):
    """As --tp 2: a mesh that does not divide the one device, exit 1."""
    rc = probe.main(["--gpipe-microbatches", "2", "--pp", "2", "--device",
                     "cpu", "--steps", "1", "--seq-len", "16"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not report["invalid_config"]
    assert "not divisible by pp=2" in report["error"]


@pytest.mark.parametrize("argv", [
    ["--gpipe-microbatches", "2"],                      # no --pp
    ["--gpipe-microbatches", "2", "--pp", "2", "--tp", "2"],
    ["--gpipe-microbatches", "2", "--pp", "2", "--attention", "flash"],
    ["--gpipe-microbatches", "3", "--pp", "2"],         # batch 8 % 3
    ["--mode", "infer", "--pp", "2", "--gpipe-microbatches", "2"],
    ["--mode", "attn-bench", "--gpipe-microbatches", "2"],
    ["--mode", "ring-bench", "--gpipe-microbatches", "2"],
    ["--gpipe-microbatches", "2", "--pp", "2", "--ep", "2", "--experts", "4"],
])
def test_cli_gpipe_refusals_exit_2(argv):
    with pytest.raises(SystemExit) as exc:
        probe.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2, argv
