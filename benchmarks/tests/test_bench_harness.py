"""The harness end to end on the CPU, on tiny cells (tests/tiny.py): cells
found by name, the result line, the faults and the control failing the
check, the import guard, and the trace's arithmetic."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import cell, guard, program
from harness.spec import load_cell
from harness.trace import Events, union_ns

from tiny import BENCH, REPO, make

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(2)
    return make(tmp_path_factory.mktemp("checkout"))


def _run(checkout, name, seed=7, trace=False, port_class=None,
         seconds=0.2):
    found = load_cell(name, checkout)
    port = (port_class(found.definition, found.model, "cpu") if port_class
            else None)
    return cell.run(found, seed, seconds, trace, "cpu", time.perf_counter(),
                    port=port)


@pytest.mark.parametrize("name", ["tiny-dense.train", "tiny-moe.train",
                                  "tiny-dense.score"])
def test_sound_run_is_correct_and_its_line_has_the_keys(checkout, name):
    result = _run(checkout, name).result
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    kind = name.rsplit(".", 1)[1]
    wanted = {"train": {"train_tokens_per_s", "setup_s"},
              "score": {"score_tokens_per_s", "score_p95_ms", "setup_s"}}
    assert set(result["metrics"]) == wanted[kind]
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert json.loads(json.dumps(result)) == result


def test_traced_line_has_breakdown_and_window(checkout):
    result = _run(checkout, "tiny-dense.train", trace=True).result
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    # on the CPU no device work is traced, so no per-layer metric reads
    assert result["metrics"] == {}


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in ("tiny-dense.train", "tiny-moe.train",
                               "tiny-dense.score")
    for fault in program.FAULTS_OF[name.rsplit(".", 1)[1]]])
def test_each_fault_of_the_timed_path_makes_the_run_incorrect(
        checkout, name, fault):
    outcome = _run(checkout, name, port_class=program.FAULTS[fault])
    assert outcome.correct is False, outcome.numbers


@pytest.mark.parametrize("name", ["tiny-dense.train", "tiny-moe.train",
                                  "tiny-dense.score"])
def test_control_in_the_ports_place_is_not_correct(checkout, name):
    sound = _run(checkout, name, seed=11).numbers
    control = _run(checkout, name, seed=11, port_class=program.Control)
    assert control.correct is False
    assert max(control.numbers[k] / max(sound[k], 1e-12)
               for k in sound) >= 3


def test_new_config_mix_metric_and_limits_are_found_by_name(checkout):
    """A cell, its configuration, its mix and a per-layer metric added as
    new files (and BENCHMARK.json entries) run with no other edit."""
    root = checkout
    bench_file = root / "BENCHMARK.json"
    saved = bench_file.read_text()
    bench = json.loads(saved)
    added = root / "benchmarks"
    (added / "configs" / "tiny-wide.json").write_text(json.dumps(
        {"model": dict(vocab=48, d_model=48, n_heads=3, d_ff=96, n_layers=1,
                       n_experts=0, capacity_factor=1.25, lr=0.01,
                       momentum=0.9)}))
    (added / "mixes" / "tiny-train-b2.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "seq": 8, "pool": 3, "followed": 2,
         "report": {"tokens_per_s": "train_tokens_per_s"}}))
    (added / "limits" / "tiny-wide.train.json").write_text(json.dumps(
        {"loss_gap": {"limit": 0.05}}))
    (added / "metrics" / "steps_traced.train.py").write_text(
        "def read(view):\n    return float(len(view.units))\n")
    bench["configs"].append({"name": "tiny-wide", "source": "tiny",
                             "file": "benchmarks/configs/tiny-wide.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "tiny-wide.train",
                               "config": "tiny-wide",
                               "traffic": "tiny-train-b2", "chips": 1,
                               "why": "CPU test"})
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                               "better": "higher", "source": "program_span",
                               "layer": "model step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny-wide.train"]})
    for metric in bench["end_to_end"]:
        if metric["name"] == "train_tokens_per_s":
            metric["workloads"].append("tiny-wide.train")
    bench_file.write_text(json.dumps(bench))
    try:
        result = _run(root, "tiny-wide.train", trace=True).result
    finally:
        bench_file.write_text(saved)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["steps_traced.train"]["value"] == \
        result["attempted"]
    assert result["metrics"]["steps_traced.train"]["unit"] == "steps"


def test_guard_compares_whole_top_level_names():
    modules = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
               "tpu_device_plugin.validator.probe": 1,
               "tpu_device_plugin_torch.validator": 1, "jaxtyping": 1,
               "torch": 1}
    assert guard.forbidden_loaded(modules) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla",
        "tpu_device_plugin.validator.probe"]


def _python(code: str, cwd: Path, path: list) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join(str(p) for p in path)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_a_run_loads_neither_jax_nor_the_jax_package(checkout):
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(1)\n"
        "from pathlib import Path\n"
        "from harness import cell, guard\n"
        "from harness.spec import load_cell\n"
        f"c = load_cell('tiny-moe.train', Path({str(checkout)!r}))\n"
        "cell.run(c, 3, 0.1, True, 'cpu', time.perf_counter())\n"
        "print(guard.forbidden_loaded())\n"
        "print('tpu_device_plugin_torch' in sys.modules)\n")
    done = _python(code, REPO, [BENCH, REPO])
    assert done.returncode == 0, done.stderr
    assert done.stdout.split("\n")[:2] == ["[]", "True"]


def test_reference_loads_nothing_of_the_port():
    code = ("import sys\nimport harness.reference, harness.checks\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('tpu_device_plugin_torch', 'tpu_device_plugin', 'jax')))\n")
    done = _python(code, BENCH, [BENCH])
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_run_exits_nonzero_and_prints_no_result_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    done = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "pythia-1.4b.train", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert done.stdout == ""


def test_without_the_port_a_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the port cannot be imported and the run stops."""
    (tmp_path / "BENCHMARK.json").write_text(
        (REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(BENCH), str(tmp_path / "benchmarks")],
                   check=True)
    code = ("import sys, time\n"
            "sys.path[:0] = ['benchmarks', '.']\n"
            "from pathlib import Path\n"
            "from harness import cell\n"
            "from harness.spec import load_cell\n"
            "c = load_cell('pythia-1.4b.score', Path('.'))\n"
            "cell.run(c, 1, 0.1, False, 'cpu', time.perf_counter())\n")
    done = _python(code, tmp_path, [])
    assert done.returncode != 0
    assert "tpu_device_plugin_torch" in done.stderr


def test_busy_union_and_idle_gaps_by_span():
    ms = 1_000_000
    events = Events(
        window=(0, 10 * ms),
        device=[("k1", 1 * ms, 3 * ms), ("k2", 2 * ms, 4 * ms),
                ("gemm", 6 * ms, 7 * ms)],
        spans=[("bench.window", 0, 10 * ms),
               ("bench.enqueue_step", 0, 5 * ms),
               ("bench.sync", 5 * ms, 9 * ms)])
    assert union_ns([(1, 3), (2, 4), (6, 7)]) == 4
    assert events.busy_ns() == 4 * ms
    gaps = dict(events.idle_gaps())
    # gaps [0, 1) mid 0.5 in enqueue; [4, 6) mid 5 and [7, 10) mid 8.5 in
    # sync, which begins at 5 and ends at 9
    assert gaps == {"bench.sync": 0.005, "bench.enqueue_step": 0.001}
    assert events.time_by_group() == {"other": 4 * ms, "gemm": 1 * ms}
    assert events.top_ops(2) == [["k1", 0.002], ["k2", 0.002]]


@pytest.mark.gpu
def test_each_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in [w["name"] for w in json.loads(
            (REPO / "BENCHMARK.json").read_text())["workloads"]]:
        done = subprocess.run(
            [sys.executable, "benchmarks/run.py", "--workload", name,
             "--seed", "17", "--seconds", "2", "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=360)
        assert done.returncode == 0, done.stderr[-2000:]
        assert json.loads(done.stdout.splitlines()[-1])["correct"] is True
