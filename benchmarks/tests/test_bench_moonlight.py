"""Moonlight-16B-A3B's definition (benchmarks/definitions/moonlight-16b-a3b.py):
its held leaves, its training FLOPs and the work of its products and of
each flash kernel at the cell's shapes, worked out on the CPU from shapes;
the per-kernel roofline readers; and a tiny checkout of a configuration
that names it, whose cell reads `correct` true through the port and false
with a fault planted in its reference or with the fp8 control in the
port's place."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from harness import cell, counts, kernels, program
from harness.counts import bound_s
from harness.peaks import PEAKS
from harness.spec import load_cell, load_definition
from harness.trace import Events

from tiny import BENCH, MIXES, make

DEFINITION = BENCH / "definitions" / "moonlight-16b-a3b.py"
TINY = dict(vocab=256, d_model=64, n_heads=4, d_ff=96, n_layers=4,
            layer_types=["mla"] * 4, n_dense_layers=1, n_experts=16,
            experts_held=4, expert_d_ff=16, experts_per_token=2,
            rope_theta=50000.0, norm_eps=1e-5, kv_lora_rank=32,
            qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16,
            shared_d_ff=32, routed_scale=2.446, router_eps=1e-20,
            untied_head=True, lr=0.01, momentum=0.9, remat=True)
# from CPU runs of the tiny cell: sound runs read at most a third of each;
# the control and the planted fault read more on at least one
LIMITS = {"loss_gap": 0.025, "grad_gap": 0.05, "update_gap": 0.05,
          "route_gap": 0.1}
CELLS = {"tiny-moonlight.train": "tiny-moonlight",
         "tiny-moonlight-fault.train": "tiny-moonlight-fault"}
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def _model():
    return json.loads((BENCH / "configs" / "moonlight-16b-a3b.json")
                      .read_text())["model"]


def _params(d, model):
    return sum(math.prod(s) for s in d.leaf_shapes(model).values())


def test_the_held_leaves_and_the_training_flops_of_the_cell():
    d = load_definition(DEFINITION)
    model = _model()
    assert _params(d, model) == 3_364_615_296          # 3,364 M held
    # all 64 routed experts: the published 16 B
    assert _params(d, dict(model, experts_held=64)) == 15_960_110_208
    # matmuls and causal attention once (QK^T at 192, PV at 128)
    assert d.model_flops(model, 2, 8192, True) == pytest.approx(
        193.1e12, rel=1e-3)
    assert d.model_flops(model, 2, 8192, True) == 3 * d.model_flops(
        model, 2, 8192, False)


def test_the_kernels_work_is_attention_work_and_the_split_and_remat_twice():
    d = load_definition(DEFINITION)
    model = _model()
    by_kernel = d.attention_work_by_kernel(model, 2, 8192, True)
    assert set(by_kernel) == set(KERNELS)
    pairs = 2 * 16 * 8192 * 8193 // 2
    layers = model["n_layers"]
    # attention_work is counts.py's yardstick at (192, 128): the forward
    # per run, the backward dV, dP (at 128), dK, dQ (at 192) once
    work = d.attention_work(model, 2, 8192, True)
    assert work[:2 * layers] == by_kernel["flash_fwd"]
    assert [f for f, _, _ in work[2 * layers:]] == [
        2.0 * pairs * (128 + 128 + 192 + 192)] * layers
    # the kernels' work is that, S recomputed in K2 and in K3, and dP a
    # second time in K3
    split = 2.0 * pairs * (2 * 192 + 128) * layers
    assert sum(f for w in by_kernel.values() for f, _, _ in w) == \
        pytest.approx(sum(f for f, _, _ in work) + split, rel=1e-12)
    # at equal head dims it is counts.py's own
    equal = dict(model, qk_nope_head_dim=64, qk_rope_head_dim=64,
                 v_head_dim=128, remat=False)
    assert sorted(d.attention_work(equal, 2, 8192, True)) == sorted(
        counts.attention_work(equal, 2, 8192, True))
    # K1 runs twice a layer under remat, once without; K2, K3 once
    assert len(by_kernel["flash_fwd"]) == 2 * layers
    assert len(d.attention_work_by_kernel(dict(model, remat=False), 2, 8192,
                                          True)["flash_fwd"]) == layers
    assert [len(by_kernel[k]) for k in KERNELS[1:]] == [layers, layers]
    # each product at its own head dim: K1's QK^T at 192 and PV at 128
    assert by_kernel["flash_fwd"][0][0] == 2.0 * pairs * (192 + 128)
    assert by_kernel["flash_bwd_dkv"][0][0] == 4.0 * pairs * (192 + 128)
    assert by_kernel["flash_bwd_dq"][0][0] == 2.0 * pairs * (2 * 192 + 128)
    # remat's forward is in the work of the products, not in model_flops
    gemm = d.gemm_work(model, 2, 8192, "flash", True)
    no_remat = d.gemm_work(dict(model, remat=False), 2, 8192, "flash", True)
    attention = sum(f for f, _, _ in d.attention_work(model, 2, 8192, True))
    attention_once = sum(f for f, _, _ in d.attention_work(
        dict(model, remat=False), 2, 8192, True))
    matmuls = sum(f for f, _, _ in no_remat)
    assert sum(f for f, _, _ in gemm) > matmuls
    head = 2 * 2 * 8192 * 2048 * 163840
    # the products run a fourth forward of every layer's matmuls
    assert sum(f for f, _, _ in gemm) - matmuls == pytest.approx(
        (matmuls - 3 * head) / 3, rel=1e-9)
    assert attention - attention_once == sum(
        f for f, _, _ in by_kernel["flash_fwd"]) / 2


def _view(model, seconds):
    d = load_definition(DEFINITION)
    device = [(f"void flash_{k}_wgmma_kernel<192, 128>", 0, int(ns))
              for k, ns in seconds.items()]
    return SimpleNamespace(kind="train", model=model, definition=d,
                           units=[(2, 8192, "flash")] * 3,
                           events=Events((0, 10 ** 10), device),
                           peak=PEAKS["NVIDIA H100 80GB HBM3"],
                           seconds=lambda *g: sum(
                               ns for k, ns in seconds.items()
                               if f"flash_{k}" in g) / 1e9)


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_kernels_roofline_is_its_bound_over_its_time(kernel):
    model = _model()
    d = load_definition(DEFINITION)
    peak = PEAKS["NVIDIA H100 80GB HBM3"]
    bound = bound_s(d.attention_work_by_kernel(model, 2, 8192, True)[kernel],
                    peak)
    short = kernel[len("flash_"):]
    view = _view(model, {short: 4 * bound * 3 * 1e9})
    assert kernels.roofline(view, kernel, "train") == pytest.approx(25.0)
    # nothing to read: another kind of cell, no per-kernel work, no time
    assert kernels.roofline(view, kernel, "score") is None
    view.definition = SimpleNamespace()
    assert kernels.roofline(view, kernel, "train") is None
    assert kernels.roofline(_view(model, {}), kernel, "train") is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The tiny checkout with two configurations naming a copy of the
    definition: as it is, and with the routed scale left out of its
    reference (the planted fault)."""
    torch.set_num_threads(2)
    root = make(tmp_path_factory.mktemp("checkout"))
    bench_dir = root / "benchmarks"
    (bench_dir / "definitions").mkdir()
    source = DEFINITION.read_text()
    faulty = source.replace('weights = weights * model["routed_scale"]',
                            'weights = weights * 1.0')
    assert faulty != source
    for name, text in (("tiny-moonlight", source),
                       ("tiny-moonlight-fault", faulty)):
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
    ("tiny-moonlight.train", program.Port, True),
    ("tiny-moonlight-fault.train", program.Port, False),
    ("tiny-moonlight.train", program.Control, False)],
    ids=["port", "fault", "control"])
def test_a_tiny_checkout_of_the_definition_decides_correct(
        checkout, name, port_class, correct):
    outcome = _run(load_cell(name, checkout), port_class)
    assert outcome.correct is correct, outcome.numbers
    assert set(outcome.numbers) >= set(LIMITS)
