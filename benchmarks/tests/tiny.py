"""A checkout of tiny cells for the harness's CPU tests: configurations,
mixes and limits of their own, added as files beside the real metric
readers, and a BENCHMARK.json that names them. Limits are from CPU runs
of these sizes (sound runs read at most a third of each; the control and
the faults read more)."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

MODELS = {
    "tiny-dense": dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                       n_experts=0, capacity_factor=1.25, lr=0.01,
                       momentum=0.9),
    "tiny-moe": dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                     n_experts=4, capacity_factor=1.25, lr=0.01,
                     momentum=0.9),
}
MIXES = {
    "tiny-train": {"kind": "train", "batch": 4, "seq": 16, "pool": 4,
                   "report": {"tokens_per_s": "train_tokens_per_s"}},
    "tiny-score": {"kind": "score", "batch": 4,
                   "length": {"median": 16, "sigma": 0.6, "min": 8,
                              "max": 32, "multiple": 8},
                   "cycle": 8, "sample": 3,
                   "report": {"tokens_per_s": "score_tokens_per_s",
                              "p95_ms": "score_p95_ms"}},
}
TRAIN_LIMITS = {"loss_gap": 0.008, "grad_gap": 0.012, "update_gap": 0.012}
LIMITS = {
    "tiny-dense.train": TRAIN_LIMITS,
    "tiny-moe.train": {**TRAIN_LIMITS, "route_gap": 0.02},
    "tiny-dense.score": {"top1_gap": 0.1, "top1_gap_mean": 0.005,
                         "logprob_gap": 0.15, "logprob_gap_mean": 0.03},
}
CELLS = {"tiny-dense.train": ("tiny-dense", "tiny-train"),
         "tiny-moe.train": ("tiny-moe", "tiny-train"),
         "tiny-dense.score": ("tiny-dense", "tiny-score")}


def make(root: Path) -> Path:
    """Write the tiny checkout under `root`; returns it."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = root / "benchmarks"
    for sub in ("configs", "mixes", "limits"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", out / "metrics")
    for name, model in MODELS.items():
        (out / "configs" / f"{name}.json").write_text(
            json.dumps({"model": model}))
    for name, mix in MIXES.items():
        (out / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    for cell, limits in LIMITS.items():
        (out / "limits" / f"{cell}.json").write_text(json.dumps(
            {k: {"limit": v} for k, v in limits.items()}))
    bench["configs"] = [
        {"name": n, "source": "tiny", "file": f"benchmarks/configs/{n}.json",
         "reduced": [], "why": "CPU test"} for n in MODELS]
    bench["workloads"] = [
        {"name": c, "config": conf, "traffic": mix, "chips": 1,
         "why": "CPU test"} for c, (conf, mix) in CELLS.items()]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            cells = [c for c in CELLS if any(
                c.endswith("." + w.rsplit(".", 1)[1])
                for w in metric["workloads"])]
            metric["workloads"] = cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
