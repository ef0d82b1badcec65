"""Port parity: the flash-attention backward of tpu_device_plugin_torch vs JAX.

The JAX side is `_flash_bwd_3d`, its two Pallas backward kernels in
interpret mode on the CPU; the port's side is `flash_attention_bwd_plain`,
the plain version of its K2 and K3 kernels, which is also what the
wrapper gives a CPU tensor. Both get the same q, k, v, dO (numpy, from a
seed) and the same o and lse (the port's plain forward in f32; the JAX
kernels read lse lane-replicated to 128, the port as (heads_batch, seq)).

Tolerances are the JAX tests' own (tests/test_flash_attention.py): f32
< 1e-4 (summation order only) and bf16 < 1e-1. With bf16 inputs the port's
plain versions round P and dS to bf16 before the dV, dK and dQ products,
as the JAX kernels do, so they are also held to the much tighter 2e-3
(`test_rounding_plain_backward_matches_jax_kernels`).

The CUDA kernels run only on a card: tests/test_torch_gpu.py holds them
against the plain version there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_device_plugin.validator import flash_attention as jfa  # noqa: E402
from tpu_device_plugin_torch.validator import flash_attention as tfa  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 1e-1}


@pytest.fixture(autouse=True, scope="module")
def _small_torch_pool():
    """The suite runs files side by side (xdist); a small intra-op pool
    keeps torch's busy threads from starving the timing-based tests in
    the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def arrays(hb, seq, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((hb, seq, d), dtype=np.float32)
            for _ in range(n)]


def to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block", [(96, 64), (128, 32), (64, 128)])
def test_plain_backward_matches_jax_kernels(dtype, d, causal, seq, block):
    q, k, v, do = (to_torch(a, dtype) for a in arrays(2, seq, d, seq + d))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale, causal, True)
    grads = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal)
    jlse = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                            (*lse.shape, jfa.LANES))
    jdtype = getattr(jnp, dtype)
    ref = jfa._flash_bwd_3d(*(to_jax(as_np(t), jdtype) for t in (q, k, v, o)),
                            jlse, to_jax(as_np(do), jdtype), scale, causal,
                            block, block, True)
    for g, r in zip(grads, ref):
        assert g.dtype == q.dtype and g.shape == q.shape
        assert np.max(np.abs(as_np(g) - as_np(r))) < TOL[dtype]


def test_plain_backward_out_dtype():
    q, k, v, do = (to_torch(a, "bfloat16") for a in arrays(2, 64, 16, 1))
    o, lse = tfa.flash_attention_plain(q, k, v, 0.25, True, True)
    grads = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, 0.25, True,
                                          out_dtype=torch.float32)
    assert all(g.dtype == torch.float32 for g in grads)
    # the CPU wrapper is the plain version
    same = tfa.flash_attention_bwd(q, k, v, o, lse, do, 0.25, True,
                                   out_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(grads, same))


@pytest.mark.parametrize("causal,seq,block", [(True, 64, 32), (True, 96, 64),
                                              (False, 128, 64)])
def test_gradients_through_the_function_match_jax(causal, seq, block):
    """jax.grad of sum(o^2) through the JAX custom_vjp (Pallas forward and
    backward, interpret mode) against autograd through the port's
    `_FlashAttention` on CPU tensors (plain forward, plain backward)."""
    d = 32
    q, k, v = arrays(2, seq, d, 3 + seq, n=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = dict(tfa.launches)
    (tfa.flash_attention(tq, tk, tv, None, causal) ** 2).sum().backward()
    assert tfa.launches == before   # the CPU never launches a kernel

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, None, causal, block,
                                           block, True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for t, r in zip((tq, tk, tv), ref):
        assert np.max(np.abs(t.grad.numpy() - np.asarray(r))) < 1e-4


def test_function_returns_lse_without_gradient():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in arrays(2, 32, 16, 9, n=3))
    o, lse = tfa.flash_attention(q, k, v, None, True, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    ref_o, ref_lse = tfa.flash_attention_plain(q.detach(), k.detach(),
                                               v.detach(), 0.25, True, True)
    assert torch.equal(o.detach(), ref_o) and torch.equal(lse, ref_lse)
    # strided upstream gradient, as from the heads unfold's transpose
    g = torch.randn(2, 16, 32).transpose(1, 2)
    o.backward(g)
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()


def test_backward_input_checks():
    q = torch.zeros((2, 64, 32))
    with pytest.raises(ValueError, match="one shape"):
        tfa._check_kernel_inputs(q, q, q, torch.zeros((2, 64, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_kernel_inputs(q, q, q, torch.zeros((2, 32, 64)).transpose(1, 2))
    meta = torch.empty((2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention_bwd(meta, meta, meta, meta, None, meta, 1.0, True)


def test_launch_bwd_output_checks():
    """K2/K3 write q's dtype or f32, never bf16 from f32 inputs; refused
    before any kernel is looked up."""
    q = torch.zeros((2, 64, 32))
    rows = torch.zeros((2, 64))
    bf16 = torch.zeros((2, 64, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q's dtype or f32"):
        tfa.launch_bwd(q, q, q, q, rows, rows, bf16, None, None, 1.0, True)
    with pytest.raises(ValueError, match="dk and dv"):
        tfa.launch_bwd(q, q, q, q, rows, rows, None, q, None, 1.0, True)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block", [(96, 64), (128, 32), (200, 128)])
def test_rounding_plain_backward_matches_jax_kernels(d, causal, seq, block):
    """In bf16 the plain K2 rounds P and dS to bf16 before dV = P^T dO and
    dK = dS^T Q, and the plain K3 rounds dS before dQ = dS K, as the JAX
    kernels do (:224, :227, :262). With f32 outputs (`out_dtype`, both
    sides) dq, dk and dv agree with `_flash_bwd_3d` to < 1e-3: they differ
    at most 3.2e-4 over these cases, where dq from an unrounded dS was off
    by 1.65e-3 to 5.0e-3. In bf16 outputs the same sums can round one
    output ulp apart (3.9e-3 for dv at d 32, causal, seq 200): < 1e-2 (the
    bar above is 1e-1)."""
    q, k, v, do = (to_torch(a, "bfloat16") for a in arrays(2, seq, d, 5 + seq + d))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale, causal, True)
    jlse = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                            (*lse.shape, jfa.LANES))
    for out_dtype, jout, tol in ((torch.float32, jnp.float32, 1e-3),
                                 (None, None, 1e-2)):
        grads = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale,
                                              causal, out_dtype)
        ref = jfa._flash_bwd_3d(
            *(to_jax(as_np(t), jnp.bfloat16) for t in (q, k, v, o)), jlse,
            to_jax(as_np(do), jnp.bfloat16), scale, causal, block, block,
            True, out_dtype=jout)
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            assert np.max(np.abs(as_np(g) - as_np(r))) < tol, (name, out_dtype)


# (query/key head dim, value head dim): the tiny tests' 32, latent
# attention's (192, 128) and a tiny (24 + 8, 16); the first keeps the ids
# it had
HEAD_DIMS = [((32, 32), ""), ((192, 128), "192x128-"), ((32, 16), "32x16-")]


@pytest.mark.parametrize("dims,causal", [
    (dims, causal) for dims, _ in HEAD_DIMS for causal in (True, False)],
    ids=[f"{tag}{causal}" for _, tag in HEAD_DIMS for causal in (True, False)])
def test_plain_backward_in_f32_is_unrounded(dims, causal):
    """In f32 the rounding is the identity: K2's and K3's plain versions
    equal the products of the unrounded P and dS bit for bit, and their
    gradients are autograd's through einsum attention. V (and dO, dV) may
    have a head dim of its own."""
    d, dv = dims
    q, k = (to_torch(a, "float32") for a in arrays(2, 96, d, 8, n=2))
    v, do = (to_torch(a, "float32") for a in arrays(2, 96, dv, 9, n=2))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale, causal, True)
    di = tfa._row_dot(do, o)
    p, ds = tfa._p_ds(q, k, v, do, lse, di, scale, causal)
    dk, dv = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, di, scale, causal)
    assert torch.equal(dv, torch.einsum("bqk,bqd->bkd", p, do))
    assert torch.equal(dk, torch.einsum("bqk,bqd->bkd", ds, q))
    assert torch.equal(tfa.flash_bwd_dq_plain(q, k, v, do, lse, di, scale,
                                              causal),
                       torch.einsum("bqk,bkd->bqd", ds, k))
    assert dk.shape == q.shape and dv.shape == v.shape
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        (tfa._reference_attention(*leaves, scale, causal) * do).sum(), leaves)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal)
    for g, r in zip(got, ref):
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-5)
    # bf16: P and dS rounded for K2, the same rounded dS for K3
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    pb, dsb = tfa._p_ds(qb, kb, vb, dob, lse, di, scale, causal)
    rp, rds = tfa._p_ds(qb, kb, vb, dob, lse, di, scale, causal,
                        round_to=torch.bfloat16)
    assert torch.equal(rp, pb.bfloat16().float())
    assert torch.equal(rds, dsb.bfloat16().float())
    assert torch.equal(tfa.flash_bwd_dq_plain(qb, kb, vb, dob, lse, di, scale,
                                              causal),
                       torch.einsum("bqk,bkd->bqd", rds, kb.float()))


def test_rounding_terms_dkv_bound_every_term():
    """`rounding_terms_dkv` is no smaller than any single term of dk's
    (dS[q, k] Q[q, c]) or dv's (P[q, k] dO[q, c]) sums."""
    q, k, v, do = (to_torch(a, "bfloat16") for a in arrays(2, 64, 16, 12))
    scale = 0.25
    o, lse = tfa.flash_attention_plain(q, k, v, scale, True, True)
    di = tfa._row_dot(do, o)
    term_dk, term_dv = tfa.rounding_terms_dkv(q, k, v, do, lse, di, scale,
                                              True)
    p, ds = tfa._p_ds(q, k, v, do, lse, di, scale, True,
                      round_to=torch.bfloat16)
    dk_terms = (ds.abs()[..., None] * q.float().abs()[:, :, None]).amax(dim=1)
    dv_terms = (p[..., None] * do.float().abs()[:, :, None]).amax(dim=1)
    assert term_dk.shape == term_dv.shape == q.shape
    assert bool((dk_terms <= term_dk).all()) and bool((dv_terms <= term_dv).all())


@pytest.mark.parametrize("causal", [True, False])
def test_rounding_terms_dq_bound_every_term(causal):
    """`rounding_terms_dq` is no smaller than any single term of dq's sums
    (dS[q, k] K[k, c])."""
    q, k, v, do = (to_torch(a, "bfloat16") for a in arrays(2, 64, 16, 13))
    scale = 0.25
    o, lse = tfa.flash_attention_plain(q, k, v, scale, causal, True)
    di = tfa._row_dot(do, o)
    term = tfa.rounding_terms_dq(q, k, v, do, lse, di, scale, causal)
    _, ds = tfa._p_ds(q, k, v, do, lse, di, scale, causal,
                      round_to=torch.bfloat16)
    terms = (ds.abs()[..., None] * k.float().abs()[:, None]).amax(dim=2)
    assert term.shape == q.shape
    assert bool((terms <= term).all())
