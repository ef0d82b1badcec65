#!/usr/bin/env python3
"""Shows that chip_smoke.py's kernel checks fail a kernel that is wrong.

    python3 scripts/mutation_check.py [--out DIR] [--variants] [--match S]

Run from the repository root on a machine with a CUDA card. For each
mutation below it copies tpu_device_plugin_torch/ into a fresh directory
(under --out, default a temporary one), changes one line of one kernel
source (or of the ring) there, and runs chip_smoke's check of that kernel
(or its ring phase) against the copy (which builds its own libraries). A mutation is caught when the
check raises; the script prints, per mutation, the check line that failed
(tol_ratio, max_rel_err), and exits non-zero if any mutation passed.

With --variants it instead runs the same check on each variant below (a
one-line change that must still pass), between two runs of the source as
it is, and prints each run's timing lines and the ptxas registers and
spills of its tensor-core instances; it exits non-zero if a variant fails
the check.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = "tpu_device_plugin_torch/validator/csrc"

# (name, source, line as it is, line as mutated, chip_smoke check)
MUTATIONS = [
    ("K1 skips the diagonal key tile (query tiles after the first)",
     f"{CSRC}/flash_fwd.cu",
     "  const int num_k = (k_end + TC_BK - 1) / TC_BK;",
     "  const int num_k = (k_end + TC_BK - 1) / TC_BK - (causal && q0 > 0);",
     "check_flash_fwd"),
    ("K2 skips the diagonal query tile of the last key tile",
     f"{CSRC}/flash_bwd.cu",
     "  const int q_begin = causal ? k0 / BQ : 0;      // the diagonal",
     "  const int q_begin = causal ? k0 / BQ + (blockIdx.x == gridDim.x - 1) : 0;",
     "check_flash_bwd"),
    ("K3 skips the diagonal key tile (query tiles after the first)",
     f"{CSRC}/flash_bwd.cu",
     "  const int num_k = (k_end + BK - 1) / BK;",
     "  const int num_k = (k_end + BK - 1) / BK - (causal && q0 > 0);",
     "check_flash_bwd"),
    ("K3's turn multiplies the tile before's dS by this turn's K",
     f"{CSRC}/flash_bwd.cu",
     "        const uint64_t km = sm90::opaque(KT::mnmajor(sk0 + sp * KT::BYTES));",
     "        const uint64_t km = sm90::opaque(KT::mnmajor(sk0 + s * KT::BYTES));",
     "check_flash_bwd"),
    ("S1 passes the state between chunks without its decay",
     f"{CSRC}/ssd.cu",
     "    const float decay = expf(cum_end);",
     "    const float decay = 1.f;",
     "check_ssd"),
    ("S1 leaves D's skip out of y",
     f"{CSRC}/ssd.cu",
     "                pack_f32(acc[0][j][2 * half] + dh * x0,",
     "                pack_f32(acc[0][j][2 * half],",
     "check_ssd"),
    ("the ring treats past blocks as causal",
     "tpu_device_plugin_torch/validator/ring_attention.py",
     "    return src == index",
     "    return True",
     "check_ring"),
]

# (name, source, line as it is, line as changed, chip_smoke check)
VARIANTS = [
    ("K3 with 64-key tiles at head dims up to 64",
     f"{CSRC}/flash_bwd.cu",
     "template <int DQK> constexpr int dq_bk() { return DQK <= 64 ? 128 : 64; }",
     "template <int DQK> constexpr int dq_bk() { return 64; }",
     "check_flash_bwd"),
    ("K3 with 32-key tiles at head dims (192, 128)",
     f"{CSRC}/flash_bwd.cu",
     "template <int DQK> constexpr int dq_bk() { return DQK <= 64 ? 128 : 64; }",
     "template <int DQK> constexpr int dq_bk() { return DQK <= 64 ? 128 : DQK > 128 ? 32 : 64; }",
     "check_flash_bwd"),
    ("K3 with a two-stage K / V ring",
     f"{CSRC}/flash_bwd.cu",
     "constexpr int DQ_STAGES = 3;            // K / V ring depth",
     "constexpr int DQ_STAGES = 2;            // K / V ring depth",
     "check_flash_bwd"),
    ("K3 with a four-stage K / V ring where it fits (not at (192, 128))",
     f"{CSRC}/flash_bwd.cu",
     "  static constexpr int STAGES = DQ_STAGES;",
     "  static constexpr int STAGES = DQK > 128 ? DQ_STAGES : 4;",
     "check_flash_bwd"),
    ("K2 with a two-stage Q / dO / lse / D ring",
     f"{CSRC}/flash_bwd.cu",
     "constexpr int TC_STAGES = 3;            // Q / dO / lse / D ring depth at TC_BQ",
     "constexpr int TC_STAGES = 2;            // Q / dO / lse / D ring depth at TC_BQ",
     "check_flash_bwd"),
]

CHILD = """
import json, sys, torch
sys.path.append({root!r})
sys.path.append({scripts!r})
import chip_smoke
from tpu_device_plugin_torch.validator import _kernels
from tpu_device_plugin_torch.validator import flash_attention as fa
from sass_census import ptxas_info   # puts the root first on sys.path
assert fa.__file__.startswith({copy!r}), fa.__file__
_kernels.build_all()
info = {{}}
for log in _kernels.build_log.values():
    info.update(ptxas_info(log))
print(json.dumps({{"ptxas": {{k: v for k, v in info.items() if "wgmma" in k}}}}),
      flush=True)
try:
    chip_smoke.{check}(torch, fa, torch.device("cuda", 0))
except AssertionError:
    sys.exit(3)
"""


def run(name, source, before, after, check, out_dir: Path) -> dict:
    copy = Path(tempfile.mkdtemp(prefix="mutant-", dir=out_dir))
    shutil.copytree(ROOT / "tpu_device_plugin_torch",
                    copy / "tpu_device_plugin_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = copy / source
    text = path.read_text()
    if text.count(before) != 1:
        raise SystemExit(f"{source}: the line to change is not there once: "
                         f"{before!r}")
    path.write_text(text.replace(before, after))
    env = dict(os.environ, PYTHONPATH=str(copy))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(
            root=str(ROOT), scripts=str(ROOT / "scripts"), copy=str(copy),
            check=check)],
        cwd=copy, env=env, capture_output=True, text=True, timeout=900)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    failed = [ln for ln in lines if ln.get("ok") is False]
    shutil.rmtree(copy, ignore_errors=True)
    return {"change": name, "source": source, "caught": proc.returncode == 3,
            "exit": proc.returncode, "failed_check": failed[0] if failed else None,
            "timing": [ln for ln in lines if "ms" in ln],
            "ptxas": next((ln["ptxas"] for ln in lines if "ptxas" in ln), {}),
            "stderr_tail": proc.stderr[-2000:] if proc.returncode not in (0, 3)
            else ""}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the changed copies")
    ap.add_argument("--variants", action="store_true",
                    help="time the variants instead of catching mutations")
    ap.add_argument("--match", default="",
                    help="only the mutations whose name holds this")
    args = ap.parse_args()
    out_dir = args.out or Path(tempfile.mkdtemp(prefix="mutation-check-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.variants:
        _, source, before, _, check = VARIANTS[0]
        as_is = ("as it is", source, before, before, check)
        results = [run(*v, out_dir) for v in (as_is, *VARIANTS, as_is)]
        ok = all(r["exit"] == 0 for r in results)
    else:
        results = [run(*m, out_dir) for m in MUTATIONS if args.match in m[0]]
        ok = all(r["caught"] for r in results)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
