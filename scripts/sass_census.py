#!/usr/bin/env python3
"""What the port's CUDA kernels compiled to, instance by instance.

    python3 scripts/sass_census.py [--match wgmma]

Run from the repository root on the machine with the CUDA toolkit. Builds
the libraries of tpu_device_plugin_torch/validator/csrc/ (as the port
does at first use), then prints one JSON line per kernel instance: its
mangled name, what `nvcc -Xptxas -v` said of it (registers, spill bytes,
stack), and counts of chosen SASS instructions from `cuobjdump -sass`:
HGMMA (wgmma on the tensor cores), UTMALDG (TMA loads), FFMA (scalar f32
multiply-adds) and MUFU.EX2 (exponentials), and `sass_sha256`, a hash of
the instance's instructions (equal across two trees where the compiled
code is the same).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OPCODES = ("HGMMA", "UTMALDG", "FFMA", "MUFU.EX2")


def ptxas_info(log: str) -> dict:
    """{mangled name: {registers, spill_stores, spill_loads, stack}} from
    nvcc's -Xptxas -v output, and `wgmma_serialized` where ptxas warned
    that it serialized the function's wgmmas (C7512)."""
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"C7512.*function '(\S+)'", line)
        if m:
            info.setdefault(m.group(1), {})["wgmma_serialized"] = True
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            info.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            info[name].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[name]["registers"] = int(m.group(1))
    return info


def sass_counts(lib: Path) -> dict:
    """{mangled name: {opcode: count, "sass_sha256": hash}} from
    cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, hashes, name = {}, {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(OPCODES, 0)
            hashes[name] = hashlib.sha256()
            continue
        if name is None:
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if m:
            hashes[name].update(line.strip().encode())
            op = m.group(1)
            for want in OPCODES:
                if op == want or op.startswith(want + "."):
                    counts[name][want] += 1
    for name, h in hashes.items():
        counts[name]["sass_sha256"] = h.hexdigest()[:16]
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", default="",
                    help="only instances whose name contains this")
    args = ap.parse_args()
    from tpu_device_plugin_torch.validator import _kernels
    libs = _kernels.build_all()
    info = {}
    for log in _kernels.build_log.values():
        info.update(ptxas_info(log))
    for lib_name, path in libs.items():
        for name, ops in sass_counts(path).items():
            if args.match not in name:
                continue
            print(json.dumps({"library": lib_name, "kernel": name, **ops,
                              **info.get(name, {})}), flush=True)
    if not _kernels.build_log:
        print("libraries were already built: no ptxas lines (delete "
              f"{_kernels.BUILD_DIR} to see them)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
