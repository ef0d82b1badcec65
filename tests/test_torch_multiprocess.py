"""The multi-process slice of the port: several guest processes compose one
world over a TCP store (`probe.join_slice`, `distributed.join`, the CLI's
`--coordinator/--num-processes/--process-id/--init-timeout`), on gloo.

The counterpart of tests/test_multinode.py::test_distributed_two_process_slice:
two OS processes, each holding 2 gloo CPU ranks, form a world of 4. Their
reports, and a sharded step from the JAX package's weights over that
world, are held to the JAX package and, bit for bit, to the same work
over one process's 4 ranks (same ranks, same gloo reduction order).

The guests are `python -c` processes that import this module (which
imports no JAX at import time) and run `_guest`; their ranks run its
module-level workers. The same two guests then run the CLI, one CPU
device each, joined on a second port. The ports are chosen by binding
port 0; a guest 0 that then finds one taken ("address already in use",
another test process took it in between) is started again on new ports,
and nothing else is retried.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_sharded import (SEED, SMALL, _assert_step_close, _unshard,
                                jax_inputs)  # noqa: F401  (a fixture)
from tpu_device_plugin_torch.validator import flash_attention as fa
from tpu_device_plugin_torch.validator import probe
from tpu_device_plugin_torch.validator import workload as tw
from tpu_device_plugin_torch.validator.distributed import spawn

REPO = Path(__file__).resolve().parent.parent
# the JAX test's settings: the default model at seq 32, 2 steps
CFG = tw.ModelConfig(seq_len=32)
STEPS = 2
# the JAX package's mesh for 4 devices
MESH_4 = {"dp": 1, "sp": 1, "tp": 4}
IN_USE = "address already in use"


def _free_ports(n: int) -> list:
    """n distinct ports that were free when asked (all held at once)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _free_port() -> int:
    return _free_ports(1)[0]


def _step_worker(rank, mesh, np_params, np_tokens):
    """One training step from the JAX package's weights on this rank's
    shards: the loss and the whole gradients (the momentum after one
    step from zero), gathered over tp."""
    cfg = tw.ModelConfig(**SMALL)
    params = tw.shard_params(tw.params_from_jax(np_params, "cpu"), cfg, mesh)
    momentum = tw._with_leaves(params, [torch.zeros_like(p)
                                        for p in tw._leaves(params)])
    rows = tw._token_rows(torch.from_numpy(np.array(np_tokens)), mesh)
    _, momentum, loss = tw.sgd_step(params, momentum, rows, cfg, "einsum",
                                    mesh)
    return loss.item(), _unshard(momentum, cfg, mesh)


def _guest(port: int, cli_port: int, process_id: int, inputs: str,
           out: str) -> int:
    """One guest of two, with 2 gloo CPU ranks: join the world of 4 at
    127.0.0.1:port, validate the slice, take the sharded step; its
    report and its first rank's step are pickled to `out`. Then the CLI
    with one CPU device, joined at 127.0.0.1:cli_port: its report is the
    last line printed, and its exit code is returned."""
    with open(inputs, "rb") as f:
        np_params, np_tokens = pickle.load(f)
    with probe.join_slice(f"127.0.0.1:{port}", 2, process_id, 60,
                          device="cpu", n_devices=2) as world:
        report = probe.validate_slice(cfg=CFG, steps=STEPS, device="cpu",
                                      n_devices=2, world=world)
        step = spawn(_step_worker, 2, "cpu", 300, args=(np_params, np_tokens),
                     mesh=dict(tp=4, sp=1), world=world)[0]
    with open(out, "wb") as f:
        pickle.dump((dict(report.__dict__), step), f)
    return probe.main(["--device", "cpu", "--coordinator",
                       f"127.0.0.1:{cli_port}", "--num-processes", "2",
                       "--process-id", str(process_id), "--steps",
                       str(STEPS), "--seq-len", "32"])


def _run_guests(argv_for, n: int, timeout: float = 240):
    """Start n guest processes (`argv_for(ports, i)`, two ports); returns
    each one's (returncode, stdout, stderr). Where guest 0 reports a port
    taken, all are stopped and started again on new ports (at most 3
    times)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    for _ in range(3):
        ports = _free_ports(2)
        procs = [subprocess.Popen(argv_for(ports, i), cwd=REPO, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for i in range(n)]
        try:
            outs = [procs[0].communicate(timeout=timeout)]
            if procs[0].returncode and IN_USE in "".join(outs[0]):
                continue
            outs += [p.communicate(timeout=timeout) for p in procs[1:]]
            return [(p.returncode, *o) for p, o in zip(procs, outs)]
        finally:
            # never orphan a guest waiting at the rendezvous
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    raise AssertionError(f"port taken 3 times: {outs[0][1][-800:]}")


@pytest.fixture(scope="module")
def two_guests(jax_inputs, tmp_path_factory):  # noqa: F811
    """Two guests x 2 gloo ranks: (reports, guest 0's step, each guest's
    CLI run as (returncode, stdout, stderr))."""
    tmp = tmp_path_factory.mktemp("guests")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(jax_inputs, f)

    def argv(ports, i):
        code = ("import sys; from test_torch_multiprocess import _guest; "
                f"sys.exit(_guest({ports[0]}, {ports[1]}, {i}, "
                f"{str(inputs)!r}, {str(tmp / f'out{i}.pkl')!r}))")
        return [sys.executable, "-c", code]

    results = _run_guests(argv, 2)
    outs = []
    for i, (_, _, err) in enumerate(results):
        out = tmp / f"out{i}.pkl"
        assert out.exists(), f"guest {i} failed: {err[-1500:]}"
        with open(out, "rb") as f:
            outs.append(pickle.load(f))
    return [o[0] for o in outs], outs[0][1], results


def test_two_guests_compose_one_slice_of_four(two_guests):
    """test_multinode.py's two-process slice: both reports ok over the
    global 4 devices, the same loss on both, and both losses bit for bit
    the one-process 4-rank validation's."""
    reports, _, _ = two_guests
    for report in reports:
        assert report["ok"], report["error"]
        assert report["n_devices"] == 4            # global slice, not local
        assert report["mesh_shape"] == MESH_4
        assert report["device_kinds"] == ["cpu"]
        assert report["steps"] == 1 + STEPS + 2 * STEPS
        assert report["matmul_tflops"] > 0         # each guest's own rank
    assert reports[0]["loss_end"] == reports[1]["loss_end"]
    assert reports[0]["loss_start"] == reports[1]["loss_start"]
    one = probe.validate_slice(cfg=CFG, steps=STEPS, device="cpu",
                               n_devices=4)
    assert one.ok, one.error
    assert one.mesh_shape == MESH_4
    assert reports[0]["loss_start"] == one.loss_start
    assert reports[0]["loss_end"] == one.loss_end


def test_sharded_step_over_two_guests_matches_jax(two_guests, jax_inputs):  # noqa: F811
    """The tp 4 step from the JAX package's weights over the composed
    world: within test_torch_sharded.py's bars of the JAX sharded step on
    4 virtual devices, and bit for bit the one-process spawn of 4."""
    jax = pytest.importorskip("jax")
    from tpu_device_plugin.validator import workload as jw
    from tpu_device_plugin.validator.mesh import slice_mesh
    _, ours, _ = two_guests
    np_params, np_tokens = jax_inputs
    one = spawn(_step_worker, 4, "cpu", 300, args=(np_params, np_tokens),
                mesh=dict(tp=4, sp=1))[0]
    assert ours[0] == one[0]
    for g, r in zip(ours[1], one[1]):
        np.testing.assert_array_equal(g, r)

    cfg = jw.ModelConfig(**SMALL)
    ref = {}
    for label, devices, kw in (("single", 1, {}), ("sharded", 4, dict(tp=4))):
        mesh = slice_mesh(jax.devices("cpu")[:devices], **kw)
        step, params, momentum, tokens = jw.build_workload(
            cfg, mesh, seed=SEED, attention="einsum")
        np.testing.assert_array_equal(np.asarray(tokens), np_tokens)
        _, momentum, loss = step(params, momentum, tokens)
        ref[label] = (float(loss), jax.tree.leaves(
            jax.tree.map(np.asarray, momentum)))
    jax_shift = abs(ref["sharded"][0] - ref["single"][0])
    _assert_step_close(ours, ref["sharded"], 1e-3 + jax_shift)


def test_cli_two_guests(two_guests):
    """`main` with --coordinator in two processes (the same two guests),
    one CPU device each: both exit 0 with the global count."""
    reports = []
    for i, (rc, out, err) in enumerate(two_guests[2]):
        assert rc == 0, f"guest {i}'s CLI failed: {err[-1500:]}"
        reports.append(json.loads(out.strip().splitlines()[-1]))
    for report in reports:
        assert report["ok"], report["error"]
        assert report["n_devices"] == 2
        assert report["mesh_shape"] == {"dp": 1, "sp": 1, "tp": 2}
    assert reports[0]["loss_end"] == reports[1]["loss_end"]


def _main_joined(argv, capsys, timeout_s=None):
    """probe.main(argv) with '{port}' in argv replaced by a free port (a
    new one where the port was taken); (rc, last JSON line, seconds)."""
    for _ in range(3):
        port = str(_free_port())
        t0 = time.monotonic()
        rc = probe.main([a.replace("{port}", port) for a in argv])
        took = time.monotonic() - t0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if IN_USE not in line.get("error", ""):
            return rc, line, took
    raise AssertionError(f"port taken 3 times: {line}")


@pytest.mark.parametrize("argv,within_s", [
    (["--coordinator", "127.0.0.1:{port}", "--process-id", "0"], None),
    (["--coordinator", "127.0.0.1:{port}", "--num-processes", "2",
      "--process-id", "2"], None),
    (["--coordinator", "127.0.0.1", "--num-processes", "1",
      "--process-id", "0"], None),
    # nobody serves the port: the store's connect times out
    (["--coordinator", "127.0.0.1:{port}", "--num-processes", "2",
      "--process-id", "1", "--init-timeout", "2"], 2 + 20),
], ids=["no-num-processes", "process-id-out-of-range", "no-port",
        "unreachable"])
def test_failed_rendezvous_is_a_report_exit_1(argv, within_s, capsys):
    rc, report, took = _main_joined(argv + ["--device", "cpu", "--steps",
                                            "1"], capsys)
    assert rc == 1
    assert report["ok"] is False
    assert report["error"].startswith("distributed init: "), report["error"]
    if within_s is not None:
        assert "timed out" in report["error"], report["error"]
        assert took < within_s


def test_attn_bench_stays_local_in_a_joined_world(capsys):
    """--mode attn-bench with a world of one joined: it runs on this
    process's device and prints what it prints without one."""
    argv = ["--mode", "attn-bench", "--seqs", "64", "--hb", "2", "--steps",
            "1", "--device", "cpu"]
    rc, joined, _ = _main_joined(argv + ["--coordinator", "127.0.0.1:{port}",
                                         "--num-processes", "1",
                                         "--process-id", "0"], capsys)
    assert rc == 0 and joined["ok"] is True
    assert probe.main(argv) == 0
    alone = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(joined) == set(alone)
    assert [c["seq"] for c in joined["cells"]] == [64]
    assert joined["platform"] == alone["platform"] == "cpu"


def test_world_of_one_spawns_a_fresh_rank(monkeypatch):
    """A joined world spawns this guest's ranks even for one device (the
    card run's shape), and the report carries that rank's launch counts
    and the global mesh."""
    from tpu_device_plugin_torch.validator import distributed
    calls = []
    real = distributed.spawn

    def spy(fn, n, *args, **kw):
        calls.append((n, kw.get("world")))
        return real(fn, n, *args, **kw)

    monkeypatch.setattr(distributed, "spawn", spy)
    for _ in range(3):
        try:
            world = probe.join_slice(f"127.0.0.1:{_free_port()}", 1, 0, 30,
                                     device="cpu")
            break
        except RuntimeError as exc:
            if IN_USE not in str(exc):
                raise
    else:
        pytest.fail("port taken 3 times")
    with world:
        assert (world.offset, world.local, world.size) == (0, 1, 1)
        report = probe.validate_slice(cfg=CFG, steps=1, attention="flash",
                                      device="cpu", world=world)
    assert report.ok, report.error
    assert calls == [(1, world)]
    assert report.n_devices == 1 and report.mesh_shape == dict(dp=1, sp=1,
                                                               tp=1)
    # flash on CPU tensors runs the plain versions: nothing launched
    assert report.launches == dict.fromkeys(fa.launches, 0)
    assert report.steps == 1 + 1 + 2
