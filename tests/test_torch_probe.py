"""The port's probe, CLI, datasheet peaks, timing, and import hygiene.

Runs on the CPU at a tiny configuration (`device="cpu"`); the card's own
run is chip_smoke.py.
"""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from tpu_device_plugin_torch.validator import peaks, probe, timing
from tpu_device_plugin_torch.validator.workload import ModelConfig

REPO = Path(__file__).resolve().parent.parent
TINY = ModelConfig(vocab=32, d_model=32, n_heads=2, d_ff=64, n_layers=2,
                   seq_len=32, batch=2)


def test_validate_slice_infer_on_cpu():
    report = probe.validate_slice(cfg=TINY, steps=2, mode="infer",
                                  device="cpu")
    assert report.ok, report.error
    assert report.platform == "cpu" and report.device_kinds == ["cpu"]
    assert report.infer_p50_ms > 0 and report.infer_p99_ms >= report.infer_p50_ms
    assert report.step_time_s > 0 and report.tokens_per_s > 0
    # first forward + 2 latency samples + the differencing chains
    assert report.forwards > 3
    # no peak for the CPU: no fractions, no veto
    assert report.peak_tflops == 0 and not report.perf_suspect
    assert report.matmul_tflops > 0 and report.hbm_gbps > 0
    assert json.loads(report.to_json())["ok"] is True


def test_validate_slice_counts_kernel_path_forwards(monkeypatch):
    """flash mode on CPU tensors: the plain version, never the kernel."""
    from tpu_device_plugin_torch.validator import flash_attention as fa
    monkeypatch.setattr(probe, "_microbench", lambda dev, m=None: (1.0, 1.0))
    before = dict(fa.launches)
    report = probe.validate_slice(cfg=TINY, steps=1, attention="flash",
                                  mode="infer", device="cpu")
    assert report.ok, report.error
    assert report.forwards > 0 and report.steps == 0
    assert fa.launches == before


def test_validate_slice_train_on_cpu():
    """The default mode trains; flash on CPU tensors runs the plain forward
    and backward, never a kernel."""
    from tpu_device_plugin_torch.validator import flash_attention as fa
    before = dict(fa.launches)
    report = probe.validate_slice(cfg=TINY, steps=2, attention="flash",
                                  device="cpu")
    assert report.ok, report.error
    assert report.loss_end < report.loss_start
    # the first step, then blocks of N and 2N
    assert report.steps == 1 + 2 + 4 and report.forwards == 0
    assert report.step_time_s > 0 and report.first_step_s > 0
    assert report.tflops_per_chip == pytest.approx(
        probe._workload_flops(TINY) / report.step_time_s / 1e12)
    # no peak for the CPU: no MFU
    assert report.mfu == 0 and report.peak_tflops == 0
    assert fa.launches == before


def test_train_step_time_falls_back_to_the_block_mean(monkeypatch):
    """A noisy host can make the 2N-step block no slower than the N-step
    one; the step time is then the 2N block's mean, never 0."""
    ticks = iter([0.0, 10.0, 13.0, 20.0, 22.0])  # first step, N, 2N blocks
    monkeypatch.setattr(probe.time, "monotonic", lambda: next(ticks))
    report = probe.SliceReport(ok=False)
    probe._train(report, TINY, 1, "einsum", torch.device("cpu"))
    assert report.step_time_s == pytest.approx(2.0 / 2)
    assert report.tflops_per_chip == pytest.approx(
        probe._workload_flops(TINY) / 1.0 / 1e12)


def test_training_that_does_not_learn_fails(monkeypatch):
    from tpu_device_plugin_torch.validator import workload
    real = workload.sgd_step

    def frozen(params, momentum, tokens, cfg, attention="einsum", mesh=None):
        _, _, loss = real(params, momentum, tokens, cfg, attention, mesh)
        return params, momentum, loss * 0 + 7.0
    monkeypatch.setattr(workload, "sgd_step", frozen)
    monkeypatch.setattr(probe, "_microbench", lambda dev, m=None: (1.0, 1.0))
    report = probe.validate_slice(cfg=TINY, steps=1, device="cpu")
    assert not report.ok and "loss did not decrease" in report.error


def test_impossible_train_mfu_vetoes(monkeypatch):
    """A training rate above 1.05x the datasheet peak refuses the run."""
    monkeypatch.setattr(probe, "_microbench",
                        lambda dev, m=None: (500.0, 100.0))
    monkeypatch.setattr(peaks, "lookup", lambda name: peaks.PEAKS["h100-sxm5"])
    monkeypatch.setattr(probe, "_workload_flops", lambda cfg: 1e18)
    report = probe.validate_slice(cfg=TINY, steps=1, device="cpu")
    assert report.mfu > peaks.SUSPECT_FACTOR
    assert report.perf_suspect and not report.ok
    assert "train MFU" in report.error


def test_unported_mode_is_a_config_error():
    """A bench is no validation: validate_slice names the bench functions
    (the CLI runs them, tests/test_torch_bench.py)."""
    report = probe.validate_slice(cfg=TINY, mode="attn-bench", device="cpu")
    assert report.invalid_config and not report.ok
    assert "bench_attention" in report.error and report.steps == 0


def test_missing_cuda_is_reported_not_raised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = probe.validate_slice(cfg=TINY, steps=1)
    assert not report.ok and not report.invalid_config
    assert "CUDA" in report.error


def test_microbench_failure_never_vetoes(monkeypatch):
    def boom(device, min_diff_s=None):
        raise RuntimeError("microbench exploded")
    monkeypatch.setattr(probe, "_microbench", boom)
    report = probe.validate_slice(cfg=TINY, steps=1, mode="infer",
                                  device="cpu")
    assert report.ok
    assert "microbench skipped" in report.error


def test_impossible_microbench_vetoes(monkeypatch):
    """A reading above 1.05x the datasheet peak refuses the run, even after
    the retry (here the CPU run is checked against the H100 SXM peak)."""
    monkeypatch.setattr(probe, "_microbench",
                        lambda dev, m=None: (2000.0, 100.0))
    monkeypatch.setattr(peaks, "lookup", lambda name: peaks.PEAKS["h100-sxm5"])
    report = probe.validate_slice(cfg=TINY, steps=1, mode="infer",
                                  device="cpu")
    assert report.perf_suspect and not report.ok
    assert "exceeds datasheet peak" in report.error
    assert report.peak_tflops == 989.0


def test_main_exit_code_zero_on_cpu(capsys):
    rc = probe.main(["--mode", "infer", "--device", "cpu", "--steps", "1",
                     "--seq-len", "32"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    assert json.loads(out)["ok"] is True


@pytest.mark.parametrize("argv", [["--mode", "train"], [], ["--remat"]])
def test_main_train_exit_code_zero_on_cpu(argv, capsys):
    rc = probe.main(argv + ["--device", "cpu", "--steps", "1",
                            "--seq-len", "32"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["ok"] is True
    assert report["steps"] == 4 and report["loss_end"] < report["loss_start"]


def test_workload_flops_at_mfu():
    cfg = ModelConfig(**probe.PRESETS["mfu"])
    assert probe._workload_flops(cfg) == pytest.approx(42.984e12, rel=1e-4)


@pytest.mark.parametrize("argv,match", [
    (["--mode", "attn-bench", "--blocks", "64x64"], "are not compiled"),
    (["--mode", "ring-bench", "--blocks", "256x256"], "are not compiled"),
    (["--gpipe-microbatches", "2", "--pp", "2", "--attention", "einsum"],
     "runs einsum attention"),
])
def test_main_rejects_unported_with_exit_2(argv, match, capsys):
    """What the port cannot run is refused: tiles that are not compiled
    (the benches), an attention choice with GPipe (einsum by
    construction)."""
    with pytest.raises(SystemExit) as exc:
        probe.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


def test_training_leaves_no_cyclic_garbage_holding_tensors():
    """With the garbage collector off, a validation's steps leave no
    tensor in a reference cycle: every step's gradients are freed when
    the last reference goes, not at the next collection (on the card at
    mfu, each step's gradients are GBs)."""
    import gc
    gc.collect()
    gc.disable()
    try:
        report = probe.validate_slice(cfg=TINY, steps=2, device="cpu")
        assert report.ok, report.error
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        tensors = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert tensors == []


# test_validator.py's SMALL configuration
SMALL = ModelConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=1,
                    seq_len=16, batch=4)


def test_validate_slice_over_four_processes(monkeypatch):
    """A (dp 2, tp 2) mesh of 4 gloo processes: the loss falls, and the
    model TFLOP/s are shared over the 4 devices, as the JAX probe shares
    them."""
    report = probe.validate_slice(cfg=SMALL, steps=3, tp=2, device="cpu",
                                  n_devices=4)
    assert report.ok, report.error
    assert report.n_devices == 4 and report.platform == "cpu"
    assert report.mesh_shape == {"dp": 2, "sp": 1, "tp": 2}
    assert report.loss_end < report.loss_start
    assert report.steps == 1 + 3 + 6
    assert report.first_step_s > report.devices_visible_s > 0
    assert report.tflops_per_chip == pytest.approx(
        probe._workload_flops(SMALL) / report.step_time_s / 1e12 / 4)
    assert report.matmul_tflops > 0   # rank 0's microbench


def test_validate_slice_infer_over_a_ring():
    report = probe.validate_slice(cfg=SMALL, steps=2, sp=2, tp=1,
                                  mode="infer", device="cpu", n_devices=4)
    assert report.ok, report.error
    assert report.mesh_shape == {"dp": 2, "sp": 2, "tp": 1}
    assert report.forwards > 3 and report.steps == 0
    assert report.tokens_per_s == pytest.approx(
        SMALL.batch * SMALL.seq_len / report.step_time_s)


@pytest.mark.parametrize("kw,match", [
    (dict(tp=2), "1 devices not divisible by tp=2"),
    (dict(sp=3, n_devices=4), "4 devices not divisible by tp=4 \\* sp=3"),
])
def test_indivisible_mesh_is_reported(kw, match):
    """As the JAX probe: the ValueError lands in `error`, not ok, and is
    not a configuration error (exit code 1)."""
    report = probe.validate_slice(cfg=SMALL, steps=1, device="cpu", **kw)
    assert not report.ok and not report.invalid_config
    assert report.error.startswith("ValueError")
    assert re.search(match, report.error)


@pytest.mark.parametrize("argv,rc", [
    (["--tp", "1", "--sp", "1"], 0),
    (["--tp", "2"], 1),
    (["--sp", "2", "--attention", "ring", "--mode", "infer"], 1),
])
def test_main_takes_tp_and_sp(argv, rc, capsys):
    assert probe.main(argv + ["--device", "cpu", "--steps", "1",
                              "--seq-len", "16"]) == rc
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is (rc == 0)
    if rc:
        assert "not divisible" in report["error"]


def test_dryrun_multichip_eight_processes(capsys):
    """The three regimes of the JAX version's dryrun: (dp, sp, tp), the
    (pp, ep, tp) MoE, and the GPipe schedule over pp 2 x dp 4."""
    from tpu_device_plugin_torch.entry import dryrun_multichip
    dryrun_multichip(8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(
        "dryrun_multichip: mesh={'dp': 1, 'sp': 2, 'tp': 4} loss=")
    assert lines[1].startswith(
        "dryrun_multichip: mesh={'pp': 2, 'dp': 1, 'sp': 1, 'ep': 2, "
        "'tp': 2} loss=")
    assert lines[2].startswith(
        "dryrun_multichip: gpipe mesh={'pp': 2, 'dp': 4, 'sp': 1, 'tp': 1} "
        "loss=")
    for line in lines:
        loss = float(line.rsplit("=", 1)[1])
        assert 0 < loss < 10
    assert len(lines) == 3


def test_main_exit_code_one_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["--mode", "infer", "--steps", "1"]) == 1
    assert probe.main(["--steps", "1"]) == 1   # train, the default


def test_presets_match_jax_package():
    assert probe.PRESETS["mfu"] == dict(d_model=2048, n_heads=16, d_ff=8192,
                                        n_layers=8, seq_len=2048, batch=8)
    cfg = ModelConfig(**probe.PRESETS["mfu"])
    assert cfg.d_model // cfg.n_heads == 128


@pytest.mark.parametrize("name,gen,tflops,gbps", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm5", 989.0, 3350.0),
    ("NVIDIA H100 PCIe", "h100-pcie", 756.0, 2000.0),
])
def test_peaks_known_cards(name, gen, tflops, gbps):
    peak = peaks.lookup(name)
    assert (peak.generation, peak.bf16_tflops, peak.hbm_gbps) == (gen, tflops, gbps)
    got, suspect, why = peaks.check(name, 0.8 * tflops, 0.8 * gbps)
    assert got is peak and not suspect and why == ""


@pytest.mark.parametrize("name", ["cpu", "", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 NVL", "TPU v5 lite"])
def test_peaks_unknown_card_gives_no_fractions(name):
    assert peaks.check(name, 1e9, 1e9) == (None, False, "")


def test_peaks_suspect_veto():
    name = "NVIDIA H100 80GB HBM3"
    _, suspect, why = peaks.check(name, tflops=989.0 * 1.06)
    assert suspect and "TFLOP/s" in why
    _, suspect, why = peaks.check(name, gbps=3350.0 * 1.06)
    assert suspect and "GB/s" in why
    _, suspect, _ = peaks.check(name, 989.0 * 1.04, 3350.0 * 1.04)
    assert not suspect


def test_timing_median_and_paired_time():
    assert timing.median([3.0, 1.0, 2.0]) == 2.0
    calls = []

    def build(k):
        def run(x):
            calls.append(k)
            return (x * k).sum()
        return run

    x = torch.ones(4)
    assert timing.paired_time(build, (x,), 3, 4) >= 0.0
    # warm both chain lengths, then 3 interleaved pairs
    assert calls == [4, 8] + [4, 8] * 3
    calls.clear()
    assert timing.paired_time(build, (x,), 2, 1) >= 0.0
    assert calls == [1, 1, 1]   # plain per-call timing after one warmup


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_nor_the_jax_package():
    files = sorted((REPO / "tpu_device_plugin_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    assert REPO / "tpu_device_plugin_torch" / "entry.py" in files
    assert len(files) > 5
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpu_device_plugin"), (
                f"{path.relative_to(REPO)} imports {name}")
