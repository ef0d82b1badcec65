"""Port parity on the (pp, dp, sp, ep, tp) mesh: training steps and a serving
forward of the port over 8 gloo processes, against the JAX package's
sharded step on 8 virtual CPU devices and against the single-device steps.

Both sides take the JAX package's weights and tokens for one seed (through
numpy). The port's processes run module-level functions of this module,
which imports no JAX at import time; all mesh cases share one spawn.

Bars, those of tests/test_torch_sharded.py: the loss within 1e-3 and the
gradients (the momentum after one step from zero momentum) within 3% of
max |g| per leaf; against the JAX sharded step the loss bar grows by how
far the JAX sharded loss lies from its own single-device loss. The serving
logits, gathered, within 2% of max |logit| of the single-device forward.

Routing. On the mesh the port routes exactly as on one device: each token
of every layer goes to the same expert (the capacity and the queue places
are global, so the drops are the same too), and every ep and tp rank of a
block routes alike; the mesh step is then held to the port's
single-device step. Against the JAX package, top-1 routing meets ties at
the rounding level (tests/test_torch_moe.py: the router's inputs carry
rounding differences between the frameworks, and XLA's partitioned
program rounds otherwise than its single-device one), where one flipped
token moves the loss by ~1e-2. So the router logits of each JAX step are
recorded inside it; the port's own routes are compared with the JAX
single-device ones (every disagreement must be a tie within the logits'
difference, and 97% agree), and the port's mesh step is held to each JAX
step with its routes pinned to that step's (the port's own gates).

The cases: (pp, ep, tp) = (2, 2, 2) with 4 experts; pp 2 x dp 2 x tp 2
with 2 experts (the JAX package's pp/ep parity configuration); ep 2 x dp 2
x sp 2 with 4 experts at capacity factor 0.25, whose drops are decided
over the whole batch; remat on a (tp 2, sp 2) mesh with ring attention
(test_validator.py's remat-on-a-mesh configuration); and the serving
forward at (pp, ep, tp) = (2, 2, 2), whose logits every pp stage returns.
"""

import json

import numpy as np
import pytest
import torch

from tpu_device_plugin_torch.validator import workload as tw
from tpu_device_plugin_torch.validator.distributed import spawn
from tpu_device_plugin_torch.validator.mesh import mesh_shape

# test_validator.py's pp/ep configuration
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=16, batch=4)
SEED = 7
# (name, slice_mesh keywords, ModelConfig overrides, attention)
CASES = [
    ("pp2-ep2-tp2", dict(pp=2, ep=2, tp=2, sp=1), dict(n_experts=4),
     "einsum"),
    ("pp2-dp2-tp2", dict(pp=2, tp=2, sp=1), dict(n_experts=2), "einsum"),
    ("ep2-dp2-sp2-drops", dict(ep=2, tp=1, sp=2),
     dict(n_experts=4, capacity_factor=0.25), "einsum"),
    ("remat-dp2-sp2-tp2", dict(tp=2, sp=2), dict(seq_len=32, remat=True),
     "ring"),
]
SERVING = ("pp2-ep2-tp2", dict(pp=2, ep=2, tp=2, sp=1), dict(n_experts=4))
LOSS_TOL = 1e-3
GRAD_REL_TOL = 0.03
LOGIT_REL_TOL = 0.02
ROUTE_AGREE_MIN = 0.97


def _config(overrides) -> dict:
    return dict(SMALL, **overrides)


def _unshard(tree, cfg, mesh) -> list:
    """Each leaf of this rank's shards, gathered over tp, ep and pp into
    the whole leaf (numpy, in `_leaves` order)."""
    import torch.distributed as dist
    sizes = mesh_shape(mesh)
    out = []
    for leaf, spec in zip(tw._leaves(tree), tw._leaves(tw.param_specs(cfg))):
        for axis in ("tp", "ep", "pp"):
            if axis in spec and axis in sizes:
                parts = [torch.empty_like(leaf) for _ in range(sizes[axis])]
                dist.all_gather(parts, leaf.contiguous(),
                                group=mesh.get_group(axis))
                leaf = torch.cat(parts, spec.index(axis))
        out.append(leaf.numpy())
    return out


def _place(mesh) -> dict:
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


class _Router:
    """Stands in for the port's `_route` and records each call's experts.
    With `pinned` routes (per layer, (batch, seq)) it returns those
    experts, this rank's block of them, with the port's own gates."""

    def __init__(self, real):
        self.real, self.routes, self.pinned = real, [], None
        self.first_layer, self.block = 0, (slice(None), slice(None))

    def start(self, mesh=None, cfg=None, pinned=None):
        self.routes.clear()
        self.pinned = pinned
        if mesh is not None:
            sizes, place = mesh_shape(mesh), _place(mesh)
            rows = cfg.batch // sizes["dp"]
            width = cfg.seq_len // sizes["sp"]
            self.first_layer = (place.get("pp", 0) * cfg.n_layers
                                // sizes.get("pp", 1))
            self.block = (slice(place["dp"] * rows, (place["dp"] + 1) * rows),
                          slice(place["sp"] * width,
                                (place["sp"] + 1) * width))

    def __call__(self, xt, wr):
        gate, top1 = self.real(xt, wr)
        self.routes.append(top1.numpy().copy())
        if self.pinned is None:
            return gate, top1
        layer = self.first_layer + len(self.routes) - 1
        top1 = torch.from_numpy(
            self.pinned[layer][self.block].reshape(-1).copy())
        gates = torch.softmax(xt.float() @ tw._bf16(wr).float(), dim=-1)
        return gates.gather(-1, top1[:, None])[:, 0], top1


PINS = (None, "jax_single", "jax_sharded")


def _worker(rank, _mesh, np_params, np_tokens, jax_routes):
    """Every case on its own mesh over the 8 ranks: training steps (the
    loss, the whole gradients, and per layer this rank's routes with its
    place on the mesh) on the port's own routes and pinned to each JAX
    step's; then the serving forward (this rank's logits)."""
    from tpu_device_plugin_torch.validator.mesh import slice_mesh
    router = tw._route = _Router(tw._route)
    steps = []
    for name, mesh_kw, overrides, attention in CASES:
        cfg = tw.ModelConfig(**_config(overrides))
        mesh = slice_mesh(8, device_type="cpu", **mesh_kw)
        rows = tw._token_rows(torch.from_numpy(np.array(np_tokens[name])),
                              mesh)
        runs = {}
        for pin in PINS if cfg.n_experts else PINS[:1]:
            params = tw.shard_params(
                tw.params_from_jax(np_params[name], "cpu"), cfg, mesh)
            momentum = tw._with_leaves(params, [torch.zeros_like(p)
                                                for p in tw._leaves(params)])
            router.start(mesh, cfg, pin and jax_routes[name][pin])
            _, momentum, loss = tw.sgd_step(params, momentum, rows, cfg,
                                            attention, mesh)
            runs[pin] = (loss.item(), _unshard(momentum, cfg, mesh),
                         list(router.routes))
        steps.append((_place(mesh), runs))
    router.start()
    name, mesh_kw, overrides = SERVING
    cfg = tw.ModelConfig(**_config(overrides))
    mesh = slice_mesh(8, device_type="cpu", **mesh_kw)
    params = tw.shard_params(tw.params_from_jax(np_params[name], "cpu"), cfg,
                             mesh)
    block = tw._token_rows(torch.from_numpy(np.array(np_tokens[name])), mesh)
    with torch.no_grad():
        logits = tw.forward(params, block, cfg, "einsum", mesh)
    return steps, (_place(mesh), logits.numpy())


@pytest.fixture(scope="module")
def jax_inputs():
    """Per case, the JAX package's weights and tokens for SEED (numpy)."""
    jax = pytest.importorskip("jax")
    from tpu_device_plugin.validator import workload as jw
    params, tokens = {}, {}
    for name, _, overrides, _ in CASES:
        cfg = jw.ModelConfig(**_config(overrides))
        p = jw.init_params(jax.random.key(SEED), cfg)
        t = jax.random.randint(jax.random.key(SEED + 1),
                               (cfg.batch, cfg.seq_len), 0, cfg.vocab,
                               dtype=jax.numpy.int32)
        params[name] = jax.tree.map(np.asarray, p)
        tokens[name] = np.asarray(t)
    return params, tokens


@pytest.fixture(scope="module")
def port_runs(jax_inputs, jax_steps):
    """The port: every case over 8 gloo processes; and, per case, the
    single-device step (loss, gradients, routes and router logits per
    layer) and the serving case's single-device logits."""
    np_params, np_tokens = jax_inputs
    jax_routes = {name: {pin: [lg.argmax(-1).reshape(SMALL["batch"], -1)
                               for lg in jax_steps[name][pin][2]]
                         for pin in PINS[1:]}
                  for name, _, overrides, _ in CASES
                  if "n_experts" in overrides}
    per_rank = spawn(_worker, 8, "cpu", timeout_s=300,
                     args=(np_params, np_tokens, jax_routes))
    single = {}
    real = tw._route
    logits = []

    def recording(xt, wr):
        logits.append((xt.float() @ tw._bf16(wr).float()).detach().numpy())
        return real(xt, wr)
    tw._route = recording
    try:
        for name, _, overrides, attention in CASES:
            cfg = tw.ModelConfig(**_config(overrides))
            params = tw.params_from_jax(np_params[name], "cpu")
            tokens = torch.from_numpy(np.array(np_tokens[name]))
            momentum = tw._with_leaves(params, [torch.zeros_like(p)
                                                for p in tw._leaves(params)])
            logits.clear()
            _, momentum, loss = tw.sgd_step(params, momentum, tokens, cfg,
                                            attention)
            single[name] = (loss.item(),
                            [m.numpy() for m in tw._leaves(momentum)],
                            list(logits))
        name, _, overrides = SERVING
        with torch.no_grad():
            served = tw.forward(tw.params_from_jax(np_params[name], "cpu"),
                                torch.from_numpy(np.array(np_tokens[name])),
                                tw.ModelConfig(**_config(overrides)),
                                "einsum").numpy()
    finally:
        tw._route = real
    return per_rank, single, served


@pytest.fixture(scope="module")
def jax_steps():
    """Per case, the JAX sharded step on 8 devices and the JAX
    single-device step: (loss, grads, router logits per layer) each, the
    logits handed out of the jitted step by `jax.debug.callback`."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from tpu_device_plugin.validator import workload as jw
    from tpu_device_plugin.validator.mesh import slice_mesh
    real = jw._moe
    calls = []

    def recording(x, layer, cfg, mesh):
        # unordered (a sharded program allows no ordered effect): the
        # layer is found by its router weights
        xt = x.reshape(-1, x.shape[-1])
        lg = (xt @ layer["wr"].astype(jnp.bfloat16)).astype(jnp.float32)
        jax.debug.callback(lambda w, v: calls.append((np.asarray(w),
                                                      np.asarray(v))),
                           layer["wr"], lg)
        return real(x, layer, cfg, mesh)
    jw._moe = recording
    out = {}
    try:
        for name, mesh_kw, overrides, attention in CASES:
            cfg = jw.ModelConfig(**_config(overrides))
            out[name] = {}
            for pin, mesh in (
                    ("jax_sharded", slice_mesh(jax.devices("cpu")[:8],
                                               **mesh_kw)),
                    ("jax_single", slice_mesh(jax.devices("cpu")[:1]))):
                step, params, momentum, tokens = jw.build_workload(
                    cfg, mesh, seed=SEED, attention=attention)
                wr = np.asarray(params["layers"].get("wr", np.zeros(0)))
                calls.clear()
                _, momentum, loss = step(params, momentum, tokens)
                jax.effects_barrier()
                logits = [[v for w, v in calls if np.array_equal(w, wr[i])]
                          for i in range(len(wr))]
                for per_layer in logits:
                    assert per_layer and all(np.array_equal(v, per_layer[0])
                                             for v in per_layer)
                out[name][pin] = (float(loss), jax.tree.leaves(
                    jax.tree.map(np.asarray, momentum)),
                    [per_layer[0] for per_layer in logits])
    finally:
        jw._moe = real
    return out


def _assert_step_close(got, ref, loss_tol=LOSS_TOL, label=""):
    (loss, grads), (ref_loss, ref_grads) = got, ref
    assert len(grads) == len(ref_grads)
    rel = [np.abs(g - r).max() / np.abs(r).max()
           for g, r in zip(grads, ref_grads)]
    print(f"{label}: |dloss| {abs(loss - ref_loss):.2e} (bar {loss_tol:.2e}),"
          f" max grad rel {max(rel):.4f}")
    assert abs(loss - ref_loss) < loss_tol, (loss, ref_loss)
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= GRAD_REL_TOL * np.abs(r).max()


def _assemble_routes(per_rank, case, cfg, pin):
    """The mesh's routes per layer as (batch, seq) arrays, from each rank's
    block; every rank of a block (ep, tp) must route alike."""
    n = {axis: 1 + max(steps[case][0].get(axis, 0) for steps, _ in per_rank)
         for axis in ("pp", "dp", "sp")}
    rows, width = cfg.batch // n["dp"], cfg.seq_len // n["sp"]
    stage_layers = cfg.n_layers // n["pp"]
    per_layer = [np.full((cfg.batch, cfg.seq_len), -1)
                 for _ in range(cfg.n_layers)]
    for steps, _ in per_rank:
        place, runs = steps[case]
        dp, sp = place["dp"], place["sp"]
        routes = runs[pin][2]
        assert len(routes) == stage_layers
        for i, r in enumerate(routes):
            got = per_layer[place.get("pp", 0) * stage_layers + i][
                dp * rows:(dp + 1) * rows, sp * width:(sp + 1) * width]
            r = r.reshape(rows, width)
            assert (got == -1).all() or np.array_equal(got, r)
            got[...] = r
    assert all((r >= 0).all() for r in per_layer)
    return per_layer


def _check_ties(ours, ref):
    """Router logits per layer, ours against the reference's: every route
    disagreement is a tie within the logits' largest difference, and at
    least 97% of the routes agree. Returns the agreeing counts."""
    agree = []
    for lp, lj in zip(ours, ref):
        dl = np.abs(lp - lj).max()
        assert dl <= LOGIT_REL_TOL * np.abs(lj).max()
        a, b = lp.argmax(-1), lj.argmax(-1)
        agree.append(int((a == b).sum()))
        for t in np.nonzero(a != b)[0]:
            assert abs(lj[t, a[t]] - lj[t, b[t]]) <= dl
    assert sum(agree) >= ROUTE_AGREE_MIN * len(ref) * ref[0].shape[0]
    return agree


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_pp_ep_step_matches_jax_and_single_device(case, jax_steps,
                                                  port_runs):
    name, _, overrides, _ = CASES[case]
    per_rank, single, _ = port_runs
    cfg = tw.ModelConfig(**_config(overrides))
    runs = per_rank[0][0][case][1]
    # every rank reports the same global loss and whole gradients
    for steps, _ in per_rank:
        for pin, (loss, grads, _) in steps[case][1].items():
            assert loss == runs[pin][0]
            for g, r in zip(grads, runs[pin][1]):
                np.testing.assert_array_equal(g, r)
    _assert_step_close(runs[None][:2], single[name][:2], LOSS_TOL,
                       f"{name}: mesh vs port single")
    jax_single, jax_sharded = (jax_steps[name][p] for p in PINS[1:])
    if not cfg.n_experts:
        _assert_step_close(runs[None][:2], jax_single[:2], LOSS_TOL,
                           f"{name}: mesh vs jax single")
        _assert_step_close(runs[None][:2], jax_sharded[:2],
                           LOSS_TOL + abs(jax_sharded[0] - jax_single[0]),
                           f"{name}: mesh vs jax sharded")
        return
    mesh_routes = _assemble_routes(per_rank, case, cfg, None)
    for r, lg in zip(mesh_routes, single[name][2]):
        np.testing.assert_array_equal(r.reshape(-1), lg.argmax(-1))
    agree = _check_ties(single[name][2], jax_single[2])
    jax_agree = [int((a.argmax(-1) == b.argmax(-1)).sum())
                 for a, b in zip(jax_sharded[2], jax_single[2])]
    print(f"{name}: routes of {cfg.batch * cfg.seq_len} per layer: mesh = "
          f"port single; port vs jax single {agree}; jax sharded vs jax "
          f"single {jax_agree}")
    for pin in PINS[1:]:
        _assert_step_close(runs[pin][:2], jax_steps[name][pin][:2],
                           LOSS_TOL + (abs(jax_sharded[0] - jax_single[0])
                                       if pin == "jax_sharded" else 0),
                           f"{name}: mesh on {pin} routes vs {pin}")


def test_pp_ep_forward_matches_single_device(port_runs):
    """Every rank of the (pp, ep, tp) = (2, 2, 2) mesh (dp = sp = 1) holds
    the whole batch's logits, the last stage's broadcast over pp."""
    per_rank, _, ref = port_runs
    for _, (place, logits) in per_rank:
        assert place["pp"] in (0, 1)
        np.testing.assert_array_equal(logits, per_rank[0][1][1])
    logits = per_rank[0][1][1]
    assert logits.shape == ref.shape and np.isfinite(logits).all()
    assert np.abs(logits - ref).max() <= LOGIT_REL_TOL * np.abs(ref).max()


# --- the CLI and validate_slice on the pp and ep axes ------------------------


@pytest.mark.parametrize("argv", [
    ["--pp", "3"],                    # does not divide n_layers=2
    ["--ep", "2"],                    # a dense model has no experts to cut
    ["--ep", "4", "--experts", "2"],  # ep does not divide the experts
    ["--preset", "mfu", "--pp", "3"],
], ids=["pp-layers", "ep-dense", "ep-experts", "mfu-pp"])
def test_main_rejects_invalid_pp_ep_before_devices(argv, capsys):
    """As the JAX probe (test_validator.py): a usage error, exit 2, before
    any device is touched (here there is no card: a check that came later
    would report a failed slice, exit 1)."""
    from tpu_device_plugin_torch.validator import probe
    with pytest.raises(SystemExit) as exc:
        probe.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("--pp" if "--pp" in argv else "--ep") in err


def test_main_trains_moe_on_cpu(capsys):
    from tpu_device_plugin_torch.validator import probe
    rc = probe.main(["--experts", "2", "--device", "cpu", "--steps", "1",
                     "--seq-len", "16"])
    report = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["ok"] is True
    assert report["loss_end"] < report["loss_start"]


def test_main_pp_on_one_device_is_a_failed_slice(capsys):
    """As --tp on one device: the mesh does not divide, exit 1."""
    from tpu_device_plugin_torch.validator import probe
    assert probe.main(["--pp", "2", "--device", "cpu", "--steps", "1",
                       "--seq-len", "16"]) == 1
    report = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert not report["ok"] and "not divisible by pp=2" in report["error"]


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_validate_slice_pp_ep_over_four_processes(mode):
    from tpu_device_plugin_torch.validator import probe
    cfg = tw.ModelConfig(**_config(dict(n_experts=2)))
    report = probe.validate_slice(cfg=cfg, steps=2, mode=mode, pp=2, ep=2,
                                  device="cpu", n_devices=4)
    assert report.ok, report.error
    assert report.mesh_shape == {"pp": 2, "dp": 1, "sp": 1, "ep": 2, "tp": 1}
    if mode == "train":
        assert report.loss_end < report.loss_start and report.steps == 7
    else:
        assert report.forwards > 3 and report.tokens_per_s > 0


def test_main_help_names_the_mesh_and_moe_flags(capsys):
    """argparse formats help strings with %: a bare one would crash --help."""
    from tpu_device_plugin_torch.validator import probe
    with pytest.raises(SystemExit) as exc:
        probe.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--pp", "--ep", "--experts", "--gpipe-microbatches"):
        assert flag in out
