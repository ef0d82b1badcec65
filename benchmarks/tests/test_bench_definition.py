"""A configuration's definition (harness/block.py): the port's block, which
a configuration without a `definition` key gets, gives the same counts,
weights and reference as before definitions could be named; and a
definition written into a checkout beside its configuration brings its
own leaves, reference and counts with no edit to a file of the harness."""

import dataclasses
import hashlib
import json
import time

import pytest
import torch

from harness import block, cell, metrics, program, reference
from harness.inputs import flatten, generator, make_leaf, make_params
from harness.peaks import lookup
from harness.spec import load_cell
from harness.trace import Events
from harness.traffic import make_plan

from tiny import BENCH, MIXES, MODELS, REPO, TRAIN_LIMITS, make

SEED = 2 ** 33 + 5


def _model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def _flops(work):
    return sum(f for f, _, _ in work)


@pytest.mark.parametrize("name", ["pythia-1.4b.train", "switch-base-8.train",
                                  "pythia-1.4b.score"])
def test_the_benchmarks_configurations_get_the_ports_block(name):
    assert load_cell(name, REPO).definition is block


def test_the_ports_block_counts_as_counts_py_did():
    pythia, switch = _model("pythia-1.4b"), _model("switch-base-8")
    assert block.model_flops(pythia, 8, 2048, True) == 138775225171968.0
    assert block.model_flops(switch, 128, 512, True) == 44988037595136.0
    assert block.model_flops(pythia, 8, 1024, False) == 22304570474496.0
    assert _flops(block.gemm_work(pythia, 8, 2048, "flash", True)) == \
        128874788683776.0
    assert _flops(block.gemm_work(switch, 128, 512, "flash", True)) == \
        48695265460224.0
    assert _flops(block.attention_work(pythia, 8, 2048, True)) == \
        9900436488192.0


# sha256 of the weights (leaf names and f32 bytes, in sorted order), of
# the reference's leaf norms after its three followed steps (json), and of
# its f32 logits of the first scoring request; and its losses, all as the
# harness gave them before a configuration could name its definition
PINNED = {
    "tiny-dense": dict(
        weights="937606a7bf021ec873df497acc98cd04c8aebdf543d144ab40676f5daa7a9d27",
        losses=[4.765969276428223, 4.92269229888916, 4.427153587341309],
        norms="b431a1180341c1aa5f4a35e4ad4d4d36850f0560ec78a481eb6424bbe8cb8ab9",
        logits="cff2f633fc5fed29e8b9862cd770dbe86451895adb81468a447a752301ade22d"),
    "tiny-moe": dict(
        weights="a26d11ae0a6cd7ade943223caabeba5a82ecb3c79fe317d9f91fe14d4563993a",
        losses=[4.533715724945068, 4.970952987670898, 4.225420951843262],
        route_gap=0.004117041826248169,
        norms="f95c9ac248a1f5330a561c1a23f927e3c2ee552f26c980cb0a11224e1771b950",
        logits="1b0bf62218b184f588cd23e84192a37d28dd26c865fab483afb3b2d4c84c9b5b"),
}


def _sha(*parts: bytes) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_ports_block_gives_the_same_weights_and_reference(name):
    torch.set_num_threads(2)
    model, pinned = MODELS[name], PINNED[name]
    params = flatten(make_params(block, model, SEED, "cpu"))
    assert _sha(*(part for k in sorted(params) for part in (
        k.encode(), params[k].numpy().tobytes()))) == pinned["weights"]
    plan = make_plan(MIXES["tiny-train"], model, SEED, "cpu")
    batches = [plan.batch_tokens(i).clone() for i in range(3)]
    routes = [block.new_routes(model) for _ in batches]
    for r, tokens in zip(routes, batches):
        if r is not None:          # routes as the reference takes them
            reference.loss(params, tokens, model, "f32", r)
    ref = cell.train_reference(block, model, SEED, "cpu", batches, routes)
    assert ref["losses"] == pinned["losses"]
    assert ref.get("route_gap") == pinned.get("route_gap")
    assert _sha(json.dumps({k: ref[k] for k in ("grad", "update")},
                           sort_keys=True).encode()) == pinned["norms"]
    prompt = make_plan(MIXES["tiny-score"], model, SEED, "cpu").prompt(0)
    logits = block.logits(params, prompt, model, "f32")
    assert _sha(logits.numpy().tobytes()) == pinned["logits"]


# A definition of its own: the port's block with one more leaf, `extra`,
# which the port is given and ignores (its gradient is 0 there), and
# counts at twice the block's. LR_FACTOR 2 plants a fault in its
# reference: SGD at twice the configuration's learning rate.
DEFINITION = '''
from harness import block

LR_FACTOR = {lr_factor}
SEEN = []                      # the leaves each reference call was given
new_routes, record = block.new_routes, block.record


def leaf_shapes(model):
    return {{**block.leaf_shapes(model), "extra": (model["d_model"],)}}


def leaf_scale(model, name):
    return 1.0 if name == "extra" else block.leaf_scale(model, name)


def _rest(tree):
    return {{k: v for k, v in tree.items() if k != "extra"}}


def sgd_step(params, momentum, tokens, model, precision, routes):
    SEEN.append(sorted(params))
    loss = block.sgd_step(_rest(params), _rest(momentum), tokens,
                          dict(model, lr=model["lr"] * LR_FACTOR),
                          precision, routes)
    momentum["extra"].mul_(model["momentum"])
    params["extra"].sub_(momentum["extra"], alpha=model["lr"])
    return loss


def logits(params, tokens, model, precision):
    SEEN.append(sorted(params))
    return block.logits(_rest(params), tokens, model, precision)


def _twice(work):
    return [(2 * f, 2 * b, dtype) for f, b, dtype in work]


def model_flops(model, batch, seq, train):
    return 2 * block.model_flops(model, batch, seq, train)


def gemm_work(model, batch, seq, attention, train):
    return _twice(block.gemm_work(model, batch, seq, attention, train))


def attention_work(model, batch, seq, train):
    return _twice(block.attention_work(model, batch, seq, train))
'''
OWN = {"tiny-extra": 1, "tiny-extra-fault": 2}     # config: LR_FACTOR
OWN_CELLS = {"tiny-extra.train": ("tiny-extra", "tiny-train"),
             "tiny-extra.score": ("tiny-extra", "tiny-score"),
             "tiny-extra-fault.train": ("tiny-extra-fault", "tiny-train")}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The tiny checkout, with configurations that name definition files
    written into it alone, and their cells added as new entries."""
    torch.set_num_threads(2)
    root = make(tmp_path_factory.mktemp("checkout"))
    bench_dir = root / "benchmarks"
    (bench_dir / "definitions").mkdir()
    for name, lr_factor in OWN.items():
        (bench_dir / "definitions" / f"{name}.py").write_text(
            DEFINITION.format(lr_factor=lr_factor))
        (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(
            {"definition": f"benchmarks/definitions/{name}.py",
             "model": MODELS["tiny-dense"]}))
    limits = json.loads((bench_dir / "limits" / "tiny-dense.score.json")
                        .read_text())
    for name in OWN_CELLS:
        (bench_dir / "limits" / f"{name}.json").write_text(json.dumps(
            limits if name.endswith(".score")
            else {k: {"limit": v} for k, v in TRAIN_LIMITS.items()}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": n, "source": "tiny", "file": f"benchmarks/configs/{n}.json",
         "reduced": [], "why": "CPU test"} for n in OWN]
    bench["workloads"] += [
        {"name": c, "config": conf, "traffic": mix, "chips": 1,
         "why": "CPU test"} for c, (conf, mix) in OWN_CELLS.items()]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        for c in OWN_CELLS:
            if "tiny-dense." + c.rsplit(".", 1)[1] in metric.get("workloads",
                                                                []):
                metric["workloads"].append(c)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


class Seeing(program.Port):
    """The port, noting the leaves each training step is given."""

    seen: list = []

    def step(self, params, momentum, tokens, routes=None):
        Seeing.seen.append(sorted(flatten(params)))
        return super().step(params, momentum, tokens, routes)


def _run(found, port_class=program.Port, seed=7):
    port = port_class(found.definition, found.model, "cpu")
    return cell.run(found, seed, 0.2, False, "cpu", time.perf_counter(),
                    port=port)


def test_a_definitions_leaf_reaches_the_port_and_the_reference(checkout):
    found = load_cell("tiny-extra.train", checkout)
    assert found.definition.leaf_shapes(found.model)["extra"] == (32,)
    extra = make_leaf(found.definition, found.model, "extra", SEED, "cpu")
    assert torch.equal(extra, torch.randn(
        (32,), generator=generator(SEED, "weights:extra", "cpu")))
    Seeing.seen = []
    result = _run(found, Seeing).result
    assert result["correct"] is True, result["checks"]
    assert Seeing.seen and all("extra" in s for s in Seeing.seen)
    assert found.definition.SEEN and all("extra" in s
                                         for s in found.definition.SEEN)
    scoring = load_cell("tiny-extra.score", checkout)
    scored = _run(scoring).result
    assert scored["correct"] is True, scored["checks"]
    assert scoring.definition.SEEN and all("extra" in s
                                           for s in scoring.definition.SEEN)


@pytest.mark.parametrize("name,port_class", [
    ("tiny-extra-fault.train", program.Port),
    ("tiny-extra.train", program.Control)], ids=["fault", "control"])
def test_a_definitions_own_reference_decides_correct(checkout, name,
                                                     port_class):
    outcome = _run(load_cell(name, checkout), port_class)
    assert outcome.correct is False, outcome.numbers


def test_the_readers_take_the_definitions_counts(checkout):
    own = load_cell("tiny-extra.train", checkout)
    ms = 1_000_000
    events = Events(window=(0, 10 * ms),
                    device=[("flash_fwd_kernel", 0, 2 * ms),
                            ("gemm_kernel", 2 * ms, 7 * ms)])
    view = metrics.View("train", own.model, block, [(4, 16, "flash")] * 3,
                        events, lookup("NVIDIA H100 80GB HBM3"))
    theirs = dataclasses.replace(view, definition=own.definition)
    for metric in ("mfu.train", "gemm_roofline.train", "flash_roofline.train"):
        read = own.readers[metric]
        assert read(view) > 0
        assert read(theirs) == 2 * read(view)


def test_a_definition_without_a_name_it_needs_is_refused(checkout):
    path = checkout / "benchmarks" / "definitions" / "tiny-extra.py"
    saved = path.read_text()
    path.write_text(saved.replace("def logits(", "def _logits("))
    try:
        with pytest.raises(AttributeError, match="logits"):
            load_cell("tiny-extra.train", checkout)
    finally:
        path.write_text(saved)
