"""granite-4.0-h-small's definition
(benchmarks/definitions/granite-4.0-h-small.py): its held leaves and its
training FLOPs at the cell's shape, the scan's work (`ssd_work`) and the
readers of S1's roofline and of the Mamba mixer's kernels, worked out on
the CPU from shapes; and a tiny checkout of a configuration that names
it, whose cell reads `correct` true through the port and false with a
fault planted in its reference or with the fp8 control in the port's
place."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from harness import cell, program
from harness.counts import bound_s
from harness.peaks import PEAKS
from harness.spec import load_cell, load_definition, load_reader
from harness.trace import Events

from tiny import BENCH, MIXES, make

DEFINITION = BENCH / "definitions" / "granite-4.0-h-small.py"
TINY = dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=16,
            n_layers=4, layer_types=["mamba", "attention", "mamba", "mamba"],
            n_experts=16, experts_held=4, expert_d_ff=16, experts_per_token=4,
            norm_eps=1e-5, shared_d_ff=32, mamba_heads=4, mamba_head_dim=8,
            mamba_state=16, mamba_groups=2, mamba_taps=4,
            attention_scale=0.0625, router_scores="softmax",
            embedding_scale=12.0, residual_scale=0.22, logits_scale=16.0,
            lr=0.01, momentum=0.9, remat=True)
# from CPU runs of the tiny cell over four seeds: sound runs read at most
# a third of each (loss 4e-5, medians 8.9e-4 and 6.7e-4, route 0.0145,
# grad and update 0.0149); the control reads more on the loss (3.5e-4 or
# more), the medians (5.5e-3, 4.9e-3) and the routes (0.092), the planted
# fault on every one (grad 0.95 or more)
LIMITS = {"loss_gap": 2e-4, "grad_gap": 0.05, "update_gap": 0.05,
          "grad_gap_median": 0.003, "update_gap_median": 0.0025,
          "route_gap": 0.05}
CELLS = {"tiny-granite.train": "tiny-granite",
         "tiny-granite-fault.train": "tiny-granite-fault"}
SSD_MARKS = ("ssd_fwd_kernel", "ssd_bwd_state_kernel",
             "ssd_bwd_chunk_kernel")
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def _model():
    return json.loads((BENCH / "configs" / "granite-4.0-h-small.json")
                      .read_text())["model"]


def _params(d, model):
    return sum(math.prod(s) for s in d.leaf_shapes(model).values())


def test_the_held_leaves_and_the_training_flops_of_the_cell():
    d = load_definition(DEFINITION)
    model = _model()
    assert _params(d, model) == 4_418_340_096          # 4.418 B held
    # 20 layers: 18 Mamba mixers of 102.29 M, 2 attention of 41.94 M
    shapes = d.leaf_shapes(model)
    mamba = sum(math.prod(s) for k, s in shapes.items()
                if k.split(".")[-1] in d.MAMBA)
    assert mamba == 18 * 102_286_976
    # matmuls, causal attention once and the scan's products once
    assert d.model_flops(model, 2, 8192, True) == pytest.approx(
        304.5e12, rel=1e-3)
    assert d.model_flops(model, 2, 8192, True) == 3 * d.model_flops(
        model, 2, 8192, False)
    # the configuration keeps every published width
    conf = json.loads((BENCH / "configs" / "granite-4.0-h-small.json")
                      .read_text())
    assert (model["mamba_heads"], model["mamba_head_dim"],
            model["mamba_state"], model["mamba_groups"]) == (
        conf["mamba_n_heads"], conf["mamba_d_head"], conf["mamba_d_state"],
        conf["mamba_n_groups"])
    assert model["layer_types"] == conf["layer_types"][:20]


def test_the_scans_work_at_the_published_chunk():
    d = load_definition(DEFINITION)
    model = _model()
    t, q = 2 * 8192, d.CHUNK
    work = d.ssd_work(model, 2, 8192, True)
    # 18 Mamba layers: the forward twice under remat, the backward once
    assert len(work) == 18 * 3
    fwd, again, bwd = work[:3]
    assert fwd == again
    assert fwd[0] == 2 * t * q * 128 + 128 * (2 * t * q * 64
                                              + 4 * t * 64 * 128)
    assert bwd[0] == 2 * fwd[0]
    # x, dt, B, C read once, y written once (bf16, dt f32)
    assert fwd[1] == t * (2 * 8192 + 4 * 128 + 4 * 128) + 2 * t * 8192
    assert len(d.ssd_work(dict(model, remat=False), 2, 8192, True)) == 36
    assert d.ssd_work(model, 2, 8192, False) == [fwd] * 18
    # whatever chunk S1 takes, the work is the published one's
    assert d.CHUNK == json.loads((BENCH / "configs" /
                                  "granite-4.0-h-small.json").read_text()
                                 )["mamba_chunk_size"]


def _view(model, device, definition=None):
    return SimpleNamespace(
        kind="train", model=model,
        definition=definition or load_definition(DEFINITION),
        units=[(2, 8192, "flash")] * 3, events=Events((0, 10 ** 10), device),
        peak=PEAKS["NVIDIA H100 80GB HBM3"])


def test_the_kernels_work_is_attention_work_with_s_and_dp_recomputed():
    d = load_definition(DEFINITION)
    model = _model()
    by_kernel = d.attention_work_by_kernel(model, 2, 8192, True)
    assert set(by_kernel) == set(KERNELS)
    pairs = 2 * 32 * 8192 * 8193 // 2
    layers = 2                                   # attention at 5 and 15
    work = d.attention_work(model, 2, 8192, True)
    # K1 twice a layer under remat, once without; K2 and K3 once
    assert work[:2 * layers] == by_kernel["flash_fwd"]
    assert len(d.attention_work_by_kernel(dict(model, remat=False), 2, 8192,
                                          True)["flash_fwd"]) == layers
    assert [len(by_kernel[k]) for k in KERNELS[1:]] == [layers, layers]
    # at head dim 128: K1 QK^T and PV, K2 S^T, dP^T, dV, dK, K3 S, dP, dQ
    assert [by_kernel[k][0][0] for k in KERNELS] == [
        2.0 * pairs * 128 * n for n in (2, 4, 3)]
    # the kernels' work is attention_work's, S recomputed in K2 and in K3
    # and dP made a second time in K3
    assert sum(f for w in by_kernel.values() for f, _, _ in w) == \
        pytest.approx(sum(f for f, _, _ in work)
                      + 2.0 * pairs * 3 * 128 * layers, rel=1e-12)
    # serving runs K1 alone, once a layer
    assert d.attention_work_by_kernel(model, 2, 8192, False) == {
        "flash_fwd": [by_kernel["flash_fwd"][0][:1]
                      + (by_kernel["flash_fwd"][0][1] - 4 * 2 * 32 * 8192,
                         "bf16")] * layers}


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_flash_kernels_roofline_reads_the_cell(kernel):
    metric = kernel.replace("_bwd", "")      # flash_fwd, flash_dkv, flash_dq
    read = load_reader(BENCH / "metrics" / f"{metric}_roofline.train.py")
    model = _model()
    d = load_definition(DEFINITION)
    bound = bound_s(d.attention_work_by_kernel(model, 2, 8192, True)[kernel],
                    PEAKS["NVIDIA H100 80GB HBM3"])
    view = _view(model, [])
    view.seconds = lambda group: 4 * bound * 3 if group == kernel else 0.0
    assert read(view) == pytest.approx(25.0)
    view.seconds = lambda group: 0.0
    assert read(view) is None


def test_the_ssd_roofline_is_the_scans_bound_over_s1s_time():
    read = load_reader(BENCH / "metrics" / "ssd_roofline.train.py")
    model = _model()
    d = load_definition(DEFINITION)
    bound = bound_s(d.ssd_work(model, 2, 8192, True),
                    PEAKS["NVIDIA H100 80GB HBM3"])
    ns = 4 * bound * 3 * 1e9 / len(SSD_MARKS)
    device = [(f"(anonymous namespace)::{m}(...)", 0, int(ns))
              for m in SSD_MARKS] + [("nvjet_tst_192x192", 0, 10 ** 9)]
    assert read(_view(model, device)) == pytest.approx(25.0, rel=1e-6)
    # nothing to read: another kind of cell, no scan work, no S1 kernel
    view = _view(model, device)
    view.kind = "score"
    assert read(view) is None
    assert read(_view(model, device, SimpleNamespace())) is None
    assert read(_view(model, device[-1:])) is None


def test_the_mamba_ms_reads_s1_and_c1s_ungated_kernels_a_step():
    read = load_reader(BENCH / "metrics" / "mamba_ms.train.py")
    model = _model()
    device = [("ssd_fwd_kernel", 0, 3 * 10 ** 6),
              ("void conv_silu_bwd_kernel<4>(...)", 0, 3 * 10 ** 6),
              ("conv_silu_dw_kernel(...)", 0, 3 * 10 ** 6),
              # LFM2's gated reduction is not the mixer's
              ("void conv_dw_kernel(...)", 0, 3 * 10 ** 6),
              ("nvjet_tst_192x192", 0, 10 ** 9)]
    assert read(_view(model, device)) == pytest.approx(3.0)
    # without S1 in the window (a block without Mamba layers): None
    assert read(_view(model, device[1:])) is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The tiny checkout with two configurations naming a copy of the
    definition: as it is, and with D's skip left out of its reference
    (the planted fault)."""
    torch.set_num_threads(2)
    root = make(tmp_path_factory.mktemp("checkout"))
    bench_dir = root / "benchmarks"
    (bench_dir / "definitions").mkdir()
    source = DEFINITION.read_text()
    faulty = source.replace('y = (y + (1 + w["D"])[:, None] * x)',
                            'y = (y + w["D"][:, None] * x)')
    assert faulty != source
    for name, text in (("tiny-granite", source),
                       ("tiny-granite-fault", faulty)):
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


def _run(found, port_class=program.Port, seed=2 ** 33 + 11):
    port = port_class(found.definition, found.model, "cpu")
    return cell.run(found, seed, 0.2, False, "cpu", time.perf_counter(),
                    port=port)


@pytest.mark.parametrize("name,port_class,correct", [
    ("tiny-granite.train", program.Port, True),
    ("tiny-granite-fault.train", program.Port, False),
    ("tiny-granite.train", program.Control, False)],
    ids=["port", "fault", "control"])
def test_a_tiny_checkout_of_the_definition_decides_correct(
        checkout, name, port_class, correct):
    outcome = _run(load_cell(name, checkout), port_class)
    assert outcome.correct is correct, outcome.numbers
    assert set(outcome.numbers) >= set(LIMITS)
