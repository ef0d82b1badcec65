"""Port parity: the port's ring attention against the JAX package's rings.

The port's rings run over gloo process groups (4 processes, one spawn for
every case; the spawned children import this module, which imports no JAX
at import time); the JAX rings run under `shard_map` on the virtual CPU
devices. Both take the same numpy inputs, split along the sequence. The
gradients are those of sum(out ** 2) over the whole sequence.

Bars, those of tests/test_flash_attention.py for the JAX rings:
- the einsum ring against `ring_attention` (f32): out < 1e-5, grads < 1e-4;
- ring flash through the kernels' plain versions against
  `ring_flash_attention` in interpret mode (f32): out < 1e-4, grads < 1e-3;
- on 2 ranks at seq 96 (a ragged 48-row shard), ring flash against the
  einsum ring: < 1e-5;
- in bf16, ring flash against `ring_flash_attention` in interpret mode:
  one bf16 ulp of the largest value (2^-7 max |ref|); measured 0 on the
  CPU, bit for bit, for out and every gradient;
- the thread-backed ring (`run_on_threads`, the one-device stand-in for a
  ring of cards) on CPU tensors against the gloo run: bit for bit.
"""

import numpy as np
import pytest
import torch

from tpu_device_plugin_torch.validator import ring_attention as ra
from tpu_device_plugin_torch.validator.distributed import spawn

# (name, ranks, bh, seq, d, dtype, ring, input seed): the shapes of
# test_flash_attention.py's ring tests
CASES = [("einsum", 4, 2, 64, 16, "float32", "einsum", 0),
         ("flash", 4, 2, 128, 16, "float32", "flash", 1),
         ("flash_2", 2, 2, 96, 16, "float32", "flash", 2),
         ("einsum_2", 2, 2, 96, 16, "float32", "einsum", 2),
         ("flash_bf16", 4, 2, 128, 16, "bfloat16", "flash", 3)]
BF16_ULP = 2 ** -7
_FUNCS = {"einsum": ra.ring_attention, "flash": ra.ring_flash_attention}
_PLAIN = {"einsum": (ra.ring_einsum_forward, ra.ring_einsum_backward),
          "flash": (ra.ring_flash_forward, ra.ring_flash_backward)}


def _inputs(bh, seq, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bh, seq, d), dtype=np.float32)
            for _ in range(3)]
    if dtype == "bfloat16":
        # round through bf16 so both frameworks see the same values
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _shard(a, dtype, ranks, index):
    t = torch.from_numpy(np.array(a)).to(getattr(torch, dtype))
    return t.chunk(ranks, 1)[index].contiguous()


def _worker(rank, _mesh, inputs):
    """Every case over a gloo sp group: (out, dq, dk, dv) of this rank's
    shard, in f32 numpy."""
    from tpu_device_plugin_torch.validator.mesh import slice_mesh
    meshes = {r: slice_mesh(4, tp=1, sp=r, device_type="cpu") for r in (2, 4)}
    out = {}
    for (name, ranks, _, _, d, dtype, kind, _), arrs in zip(CASES, inputs):
        mesh = meshes[ranks]
        ring = ra.ProcessGroupRing(mesh.get_group("sp"))
        q, k, v = (_shard(a, dtype, ranks, ring.index).requires_grad_()
                   for a in arrs)
        o = _FUNCS[kind](q, k, v, d ** -0.5, ring)
        (o.float() ** 2).sum().backward()
        out[name] = [t.detach().float().numpy()
                     for t in (o, q.grad, k.grad, v.grad)]
    return out


def _threads(name, ranks, d, dtype, kind, arrs):
    """The same case on a ThreadRing, through the plain functions."""
    forward, backward = _PLAIN[kind]

    def run(ring):
        q, k, v = (_shard(a, dtype, ranks, ring.index) for a in arrs)
        o, lse = forward(q, k, v, d ** -0.5, ring)
        grads = backward(q, k, v, o, lse, 2 * o, d ** -0.5, ring)
        return [t.float().numpy() for t in (o, *grads)]
    return ra.run_on_threads(ranks, run)


@pytest.fixture(scope="module")
def runs():
    inputs = [_inputs(bh, seq, d, dtype, seed)
              for _, _, bh, seq, d, dtype, _, seed in CASES]
    per_rank = spawn(_worker, 4, "cpu", timeout_s=300, args=(inputs,))
    # whole tensors: shards concatenated in ring order (ranks 0..r-1 of
    # the default group hold ring positions 0..r-1 of the first sp group)
    port = {}
    for (name, ranks, *_), arrs in zip(CASES, inputs):
        port[name] = [np.concatenate([per_rank[i][name][j]
                                      for i in range(ranks)], axis=1)
                      for j in range(4)]
    return inputs, port


def _jax_ring(kind, ranks, d, dtype, arrs):
    """(out, dq, dk, dv) of the JAX ring under shard_map, in f32 numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from tpu_device_plugin.validator.ring_attention import (
        ring_attention, ring_flash_attention)
    mesh = Mesh(np.array(jax.devices("cpu")[:ranks]), ("sp",))
    if kind == "einsum":
        def inner(a, b, c):
            return ring_attention(a, b, c, d ** -0.5, "sp")
    else:
        def inner(a, b, c):
            return ring_flash_attention(a, b, c, d ** -0.5, "sp", 32, 32,
                                        True, 32, 32)
    f = jax.shard_map(inner, mesh=mesh, in_specs=(P(None, "sp", None),) * 3,
                      out_specs=P(None, "sp", None), check_vma=False)
    def loss(q, k, v):
        out = f(q, k, v)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    q, k, v = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _max_err(a, b):
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("name,out_tol,grad_tol", [
    ("einsum", 1e-5, 1e-4),
    ("flash", 1e-4, 1e-3),
    ("flash_bf16", BF16_ULP, BF16_ULP),
])
def test_ring_matches_jax_ring(name, out_tol, grad_tol, runs):
    inputs, port = runs
    i = [c[0] for c in CASES].index(name)
    _, ranks, _, _, d, dtype, kind, _ = CASES[i]
    ref = _jax_ring(kind, ranks, d, dtype, inputs[i])
    if dtype == "bfloat16":   # relative to the largest value
        out_tol *= np.abs(ref[0]).max()
    assert _max_err(port[name][0], ref[0]) < out_tol
    for got, want in zip(port[name][1:], ref[1:]):
        scale = np.abs(want).max() if dtype == "bfloat16" else 1.0
        assert _max_err(got, want) < grad_tol * scale


def test_ring_flash_matches_einsum_ring_on_two_ranks(runs):
    inputs, port = runs
    for got, want in zip(port["flash_2"], port["einsum_2"]):
        assert _max_err(got, want) < 1e-5
    # and the JAX einsum ring at the same shape
    ref = _jax_ring("einsum", 2, 16, "float32", inputs[2])
    assert _max_err(port["flash_2"][0], ref[0]) < 1e-5


@pytest.mark.parametrize("name", ["einsum", "flash_2", "flash_bf16"])
def test_thread_ring_matches_process_ring(name, runs):
    inputs, port = runs
    i = [c[0] for c in CASES].index(name)
    _, ranks, _, _, d, dtype, kind, _ = CASES[i]
    per_thread = _threads(name, ranks, d, dtype, kind, inputs[i])
    for j in range(4):
        whole = np.concatenate([r[j] for r in per_thread], axis=1)
        np.testing.assert_array_equal(whole, port[name][j])


def test_ring_skips_future_blocks_and_counts_no_launch():
    """Position r runs r + 1 steps (its own block and the past ones), each
    a plain version on CPU tensors: no kernel launch."""
    from tpu_device_plugin_torch.validator import flash_attention as fa
    calls = []
    real = ra.flash_attention_fwd

    def counting(q, k, v, scale, causal, return_lse=False):
        calls.append(causal)
        return real(q, k, v, scale, causal, return_lse)
    before = dict(fa.launches)
    q, k, v = (torch.randn(2, 8, 16) for _ in range(3))
    old, ra.flash_attention_fwd = ra.flash_attention_fwd, counting
    try:
        ra.run_on_threads(3, lambda ring: ra.ring_flash_forward(
            q, k, v, 0.25, ring))
    finally:
        ra.flash_attention_fwd = old
    assert sorted(calls) == [False] * 3 + [True] * 3   # 1 + 2 + 3 steps
    assert fa.launches == before


def test_thread_ring_reraises_a_failing_member():
    def run(ring):
        if ring.index == 1:
            raise ValueError("member 1 failed")
        return ring.rotate(torch.zeros(1))
    with pytest.raises(ValueError, match="member 1 failed"):
        ra.run_on_threads(3, run, timeout_s=30)
