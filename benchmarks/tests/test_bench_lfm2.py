"""LFM2-8B-A1B's definition (benchmarks/definitions/lfm2-8b-a1b.py): its
held leaves and training FLOPs at the cell's shapes, worked out on the CPU
from shapes; and a tiny checkout of a configuration that names it, whose
cell reads `correct` true through the port and false with a fault planted
in its reference or with the fp8 control in the port's place."""

import json
import math
import time

import pytest
import torch

from harness import cell, program
from harness.spec import load_cell, load_definition

from tiny import BENCH, MIXES, make

DEFINITION = BENCH / "definitions" / "lfm2-8b-a1b.py"
TINY = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
            n_layers=4, layer_types=["conv", "conv", "attention", "conv"],
            n_dense_layers=1, n_experts=8, experts_held=4, expert_d_ff=32,
            experts_per_token=2, rope_theta=1e6, norm_eps=1e-5, lr=0.01,
            momentum=0.9)
# from CPU runs of the tiny cell: sound runs read at most a third of each
# (over five seeds: 4.2e-3, 1.3e-2, 1.3e-2, 3.1e-2); the control reads
# more on grad_gap, update_gap and route_gap (0.17, 6.5e-2, 0.36), the
# planted fault on update_gap (0.51) and route_gap (0.12)
LIMITS = {"loss_gap": 0.025, "grad_gap": 0.05, "update_gap": 0.05,
          "route_gap": 0.1}
CELLS = {"tiny-lfm2.train": "tiny-lfm2", "tiny-lfm2-fault.train":
         "tiny-lfm2-fault"}


def _model():
    return json.loads((BENCH / "configs" / "lfm2-8b-a1b.json").read_text()
                      )["model"]


def test_the_held_leaves_and_the_training_flops_of_the_cell():
    d = load_definition(DEFINITION)
    model = _model()

    def params(m):
        return sum(math.prod(s) for s in d.leaf_shapes(m).values())

    assert params(model) == 2_526_625_216
    # all 32 experts, tied: the published 8.3 B
    assert params(dict(model, experts_held=32)) == 8_339_930_560
    assert d.model_flops(model, 2, 8192, True) == 91574205677568.0
    # gemm_work and attention_work split the same matmul FLOPs at flash
    work = d.gemm_work(model, 2, 8192, "flash", True) + d.attention_work(
        model, 2, 8192, True)
    assert sum(f for f, _, _ in work) == pytest.approx(
        d.model_flops(model, 2, 8192, True), rel=1e-12)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The tiny checkout with two configurations naming a copy of the
    definition: as it is, and with SGD at twice the learning rate in its
    reference (the planted fault)."""
    torch.set_num_threads(2)
    root = make(tmp_path_factory.mktemp("checkout"))
    bench_dir = root / "benchmarks"
    (bench_dir / "definitions").mkdir()
    source = DEFINITION.read_text()
    faulty = source.replace('alpha=model["lr"])', 'alpha=2 * model["lr"])')
    assert faulty != source
    for name, text in (("tiny-lfm2", source), ("tiny-lfm2-fault", faulty)):
        (bench_dir / "definitions" / f"{name}.py").write_text(text)
        (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(
            {"definition": f"benchmarks/definitions/{name}.py",
             "model": TINY}))
    for name in CELLS:
        (bench_dir / "limits" / f"{name}.json").write_text(json.dumps(
            {k: {"limit": v} for k, v in LIMITS.items()}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": n, "source": "tiny", "file": f"benchmarks/configs/{n}.json",
         "reduced": [], "why": "CPU test"} for n in CELLS.values()]
    bench["workloads"] += [
        {"name": c, "config": conf, "traffic": "tiny-train", "chips": 1,
         "why": "CPU test"} for c, conf in CELLS.items()]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-dense.train" in metric.get("workloads", []):
            metric["workloads"] += list(CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert MIXES["tiny-train"]["kind"] == "train"
    return root


def _run(found, port_class=program.Port, seed=2 ** 33 + 7):
    port = port_class(found.definition, found.model, "cpu")
    return cell.run(found, seed, 0.2, False, "cpu", time.perf_counter(),
                    port=port)


@pytest.mark.parametrize("name,port_class,correct", [
    ("tiny-lfm2.train", program.Port, True),
    ("tiny-lfm2-fault.train", program.Port, False),
    ("tiny-lfm2.train", program.Control, False)],
    ids=["port", "fault", "control"])
def test_a_tiny_checkout_of_the_definition_decides_correct(
        checkout, name, port_class, correct):
    outcome = _run(load_cell(name, checkout), port_class)
    assert outcome.correct is correct, outcome.numbers
    assert set(outcome.numbers) >= set(LIMITS)
