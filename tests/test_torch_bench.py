"""The port's benches (attn_bench.py, ring_bench.py) and their CLI modes on
the CPU, where the kernels' plain versions run (`interpret` is true).

Mirrors tests/test_validator.py's attn-bench tests and
tests/test_perf_honesty.py's ring-bench tests at the compiled tiles (the
CUDA kernels' tiles are compile-time constants, so 128x128 is the only
block; the JAX tests' 32x32 is refused). The result and cell keys are
the JAX package's, with the kernel launches of each flash chain beside
them and, for the ring, which ring ran.
"""

import json

import pytest
import torch

from tpu_device_plugin_torch.validator import attn_bench, probe, ring_bench
from tpu_device_plugin_torch.validator import flash_attention as fa

ATTN_EXTRA_CELL_KEYS = {"flash_fwd_launches", "flash_train_launches"}
RING_EXTRA_CELL_KEYS = {"ring_flash_fwd_launches", "ring_flash_train_launches"}


@pytest.fixture(autouse=True, scope="module")
def _small_torch_pool():
    """The suite runs files side by side (xdist): a small intra-op pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cpus(n):
    import jax
    return jax.devices()[:n]


def test_bench_attention_cpu_has_the_jax_keys():
    """One cell per seq, every side timed, the JAX result's keys."""
    pytest.importorskip("jax")
    from tpu_device_plugin.validator.attn_bench import bench_attention as jb
    ref = jb(seq_lens=(64,), blocks=((32, 32),), hb=2, head_dim=32, iters=1)
    result = attn_bench.bench_attention(seq_lens=(64, 96), hb=2, head_dim=32,
                                        iters=2, device="cpu")
    assert set(result) == set(ref)
    assert result["platform"] == "cpu" and result["interpret"] is True
    assert len(result["cells"]) == 2 and result["flash_ok"]
    for cell in result["cells"]:
        assert set(cell) == set(ref["cells"][0]) | ATTN_EXTRA_CELL_KEYS
        assert cell["error"] == ""
        assert (cell["block_q"], cell["block_k"]) == fa.FWD_BLOCK
        assert (cell["bwd_block_q"], cell["bwd_block_k"]) == fa.BWD_BLOCK
        for key in ("flash_fwd_ms", "einsum_fwd_ms", "flash_train_ms",
                    "einsum_train_ms", "fwd_speedup", "train_speedup"):
            assert cell[key] > 0, key
        # the plain versions ran: no kernel launched
        assert not any(cell["flash_train_launches"].values())


def test_attn_bench_partial_failure_keeps_cells(monkeypatch):
    """An einsum failure at one seq must not discard the other seqs'
    cells, and its timings serialize as JSON null, never NaN."""
    real_paired = attn_bench._paired_time

    def flaky(build, args, iters, repeats):
        if args[0].shape[1] == 128:   # the big seq "runs out of memory"
            raise MemoryError("out of memory")
        return real_paired(build, args, iters, repeats)

    monkeypatch.setattr(attn_bench, "_paired_time", flaky)
    result = attn_bench.bench_attention(seq_lens=(64, 128), hb=2,
                                        head_dim=32, iters=1, device="cpu")
    assert len(result["cells"]) == 2
    good, bad = result["cells"]
    assert good["error"] == "" and good["flash_fwd_ms"] > 0
    assert "MemoryError" in bad["error"]
    assert not result["flash_ok"] and 128 not in result["flash_wins_at"]
    text = json.dumps(result)
    assert "NaN" not in text
    assert json.loads(text)["cells"][1]["flash_fwd_ms"] is None


def test_einsum_failure_keeps_the_flash_side(monkeypatch):
    """Only the einsum side fails (as it runs out of memory first): the
    cell keeps the flash timings and the sweep stays ok."""
    real_paired = attn_bench._paired_time
    calls = []

    def einsum_oom(build, args, iters, repeats):
        calls.append(1)
        if len(calls) == 1:   # the einsum forward comes first
            raise MemoryError("out of memory")
        return real_paired(build, args, iters, repeats)

    monkeypatch.setattr(attn_bench, "_paired_time", einsum_oom)
    result = attn_bench.bench_attention(seq_lens=(64,), hb=2, head_dim=32,
                                        iters=1, device="cpu")
    cell = result["cells"][0]
    assert cell["einsum_fwd_ms"] is None and cell["flash_train_ms"] > 0
    assert cell["error"].startswith("einsum: MemoryError")
    assert cell["train_speedup"] is None and result["flash_ok"]


def test_train_chain_carries_all_three_gradients():
    """Each iteration's inputs are the last one's dq, k + 0.001 dk and
    v + 0.001 dv: a chain carrying dq alone (k and v fixed) fails here."""
    seen = []

    def grads(q, k, v):
        g = 0.5 * q.float() + k.float() - v.float()
        return g.to(q.dtype), (2 * g).to(k.dtype), (-g).to(v.dtype)

    def grad_fn(q, k, v):
        seen.append((q, k, v))
        return grads(q, k, v)

    q, k, v = (torch.randn((2, 8, 16)).bfloat16() for _ in range(3))
    attn_bench._chain_train(grad_fn, 3)(q, k, v)
    assert len(seen) == 3
    for (q0, k0, v0), (q1, k1, v1) in zip(seen, seen[1:]):
        dq, dk, dv = grads(q0, k0, v0)
        assert torch.equal(q1, dq)
        assert torch.equal(k1, k0 + (0.001 * dk).to(k0.dtype))
        assert torch.equal(v1, v0 + (0.001 * dv).to(v0.dtype))
        assert not torch.equal(k1, k0) and not torch.equal(v1, v0)


def test_train_chain_runs_the_flash_backward(monkeypatch):
    """The flash train chain goes through `_FlashAttention`'s backward once
    per iteration, with the k and v each iteration carries."""
    calls = []
    real = fa.flash_attention_bwd

    def spy(q, k, v, *rest, **kw):
        calls.append(k.clone())
        return real(q, k, v, *rest, **kw)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    q, k, v = (torch.randn((2, 32, 16)).bfloat16() for _ in range(3))
    grad = attn_bench._grad_of(lambda q, k, v: fa.flash_attention(q, k, v))
    attn_bench._chain_train(grad, 3)(q, k, v)
    assert len(calls) == 3
    assert not torch.equal(calls[0], calls[1])


def test_bench_ring_threads_cpu_has_the_jax_keys():
    """sp 2 on the CPU runs as 2 threads: both rings timed, speedups
    populated, the JAX result's keys plus "ring"."""
    pytest.importorskip("jax")
    from tpu_device_plugin.validator.ring_bench import bench_ring as jb
    ref = jb(seq_lens=(64,), blocks=((32, 32),), sp=2, hb=2, head_dim=32,
             iters=1, devices=_cpus(2))
    result = ring_bench.bench_ring(seq_lens=(64,), sp=2, hb=2, head_dim=32,
                                   iters=1, device="cpu")
    assert set(result) == set(ref) | {"ring"}
    assert result["ring"] == "threads" and result["sp"] == 2
    assert result["platform"] == "cpu" and result["interpret"] is True
    cell = result["cells"][0]
    assert set(cell) == set(ref["cells"][0]) | RING_EXTRA_CELL_KEYS
    assert cell["error"] == ""
    assert cell["ring_flash_fwd_ms"] > 0 and cell["einsum_ring_train_ms"] > 0
    assert cell["train_speedup"] is not None
    assert result["ring_flash_ok"]


def test_bench_ring_sp1_runs_in_this_process():
    result = ring_bench.bench_ring(seq_lens=(48,), sp=1, hb=2, head_dim=16,
                                   iters=1, device="cpu")
    assert result["ring"] == "processes" and result["ring_flash_ok"]


def test_bench_ring_over_gloo_processes():
    """The ring of processes (what sp up to the visible cards runs, over
    NCCL) on 2 gloo processes: rank 0's cells."""
    from tpu_device_plugin_torch.validator.distributed import spawn
    cells = spawn(ring_bench._bench_rank, 2, "cpu", timeout_s=120,
                  args=((64,), ((128, 128),), 2, 2, 16, 1, 1))[0]
    assert len(cells) == 1 and cells[0]["error"] == ""
    assert cells[0]["ring_flash_train_ms"] > 0
    assert cells[0]["einsum_ring_fwd_ms"] > 0


def test_bench_ring_rejects_indivisible_seq():
    with pytest.raises(ValueError, match="not divisible"):
        ring_bench.bench_ring(seq_lens=(65,), sp=2, hb=2, head_dim=32,
                              device="cpu")


@pytest.mark.parametrize("kw", [dict(blocks=((32, 32),)),
                                dict(bwd_blocks=((256, 256),))])
def test_bench_attention_rejects_uncompiled_tiles(kw):
    with pytest.raises(ValueError, match="not compiled"):
        attn_bench.bench_attention(seq_lens=(64,), device="cpu", **kw)


def test_benches_need_cuda_unless_told(monkeypatch):
    """No silent CPU fallback: without a card and without device="cpu"
    the benches raise, and the CLI reports it as a JSON line, exit 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        attn_bench.bench_attention(seq_lens=(64,))
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_bench.bench_ring(seq_lens=(64,), sp=1)


def test_bench_cli_error_is_a_json_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["--mode", "attn-bench", "--seqs", "64"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] is False and "CUDA" in line["error"]


def test_attn_bench_cli_json_line(capsys):
    rc = probe.main(["--mode", "attn-bench", "--seqs", "64", "--hb", "2",
                     "--steps", "1", "--device", "cpu"])
    text = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(text)
    assert rc == 0 and payload["ok"] is True
    assert list(payload) == sorted(payload)
    assert payload["cells"][0]["seq"] == 64 and payload["hb"] == 2


def test_ring_bench_cli_json_line(capsys):
    rc = probe.main(["--mode", "ring-bench", "--seqs", "64", "--sp", "2",
                     "--hb", "2", "--steps", "1", "--device", "cpu"])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and payload["ok"] is True
    assert payload["ring"] == "threads" and payload["cells"][0]["seq"] == 64


@pytest.mark.parametrize("argv", [
    ["--mode", "attn-bench", "--blocks", "32x32"],
    ["--mode", "attn-bench", "--blocks", "128x128,256x128"],
    ["--mode", "attn-bench", "--bwd-blocks", "256x256"],
    ["--mode", "attn-bench", "--blocks", "128"],
    ["--mode", "ring-bench", "--blocks", "32x32"],
])
def test_cli_uncompiled_tiles_exit_2(argv, capsys):
    """Refused before any device is touched (no --device cpu here),
    naming the tiles that exist."""
    with pytest.raises(SystemExit) as exc:
        probe.main(argv)
    assert exc.value.code == 2
    assert "128x128" in capsys.readouterr().err


def test_compiled_tiles_match_the_kernel_sources():
    """FWD_BLOCK and BWD_BLOCK name the constants csrc/ compiles."""
    import re
    from pathlib import Path
    csrc = Path(fa.__file__).with_name("csrc")

    def const(src, name):
        text = (csrc / src).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert fa.FWD_BLOCK == (const("flash_fwd.cu", "TC_BQ"),
                            const("flash_fwd.cu", "TC_BK"))
    assert fa.BWD_BLOCK == (const("flash_bwd.cu", "DQ_BQ"),
                            const("flash_bwd.cu", "TC_BK"))
