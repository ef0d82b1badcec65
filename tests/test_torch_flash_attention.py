"""Port parity: tpu_device_plugin_torch flash attention vs the JAX kernel.

Inputs are made with numpy from a seed and handed to both frameworks. The
JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_flash_attention.py does; the port's wrapper runs its plain
version on CPU tensors. Tolerances are the JAX tests' own: f32 < 1e-5
(only summation order differs) and bf16 < 3e-2 (bf16 keeps 8 bits of
mantissa, and the JAX kernel rounds P to bf16 before PV where the port's
plain version stays in f32).

The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py holds
it against the plain version there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_device_plugin.validator import flash_attention as jfa  # noqa: E402
from tpu_device_plugin_torch.validator import _kernels  # noqa: E402
from tpu_device_plugin_torch.validator import flash_attention as tfa  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def inputs(hb, seq, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((hb, seq, d), dtype=np.float32)
            for _ in range(3)]


def to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block", [(128, 64), (96, 64), (64, 128)])
def test_forward_matches_jax_kernel(dtype, d, causal, seq, block):
    arrays = inputs(2, seq, d, seed=seq + d)
    out = tfa.flash_attention(*to_torch(arrays, dtype), None, causal)
    assert out.dtype == getattr(torch, dtype)
    jq = to_jax(arrays, dtype)
    kernel = jfa.flash_attention(*jq, None, causal, block, block, True)
    ref = jfa._reference_attention(*jq, d ** -0.5, causal)
    assert np.max(np.abs(as_np(out) - as_np(kernel))) < TOL[dtype]
    assert np.max(np.abs(as_np(out) - as_np(ref))) < TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block", [(128, 64), (96, 64), (64, 128)])
def test_lse_matches_jax_kernel(causal, seq, block):
    d = 32
    arrays = inputs(2, seq, d, seed=7)
    _, lse = tfa.flash_attention(*to_torch(arrays, "float32"), None, causal,
                                 return_lse=True)
    assert lse.shape == (2, seq) and lse.dtype == torch.float32
    _, jlse = jfa._flash_3d(*to_jax(arrays, jnp.float32), d ** -0.5, causal,
                            block, block, True, return_lse=True)
    assert np.max(np.abs(lse.numpy() - np.asarray(jlse)[..., 0])) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    d = 16
    arrays = inputs(2, 96, d, seed=3)
    out = tfa._reference_attention(*to_torch(arrays, "float32"), d ** -0.5,
                                   causal)
    ref = jfa._reference_attention(*to_jax(arrays, jnp.float32), d ** -0.5,
                                   causal)
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < 1e-5


def test_default_scale_and_plain_version_agree():
    q, k, v = to_torch(inputs(2, 64, 32, seed=5), "float32")
    assert torch.equal(tfa.flash_attention(q, k, v),
                       tfa.flash_attention_plain(q, k, v, 32 ** -0.5, True))


def test_other_devices_are_refused():
    q = torch.empty((2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("case,match", [
    ("rank", "one shape"),
    ("mismatch", "one shape"),
    ("float16", "float32 or bfloat16"),
    ("mixed", "float32 or bfloat16"),
    ("strided", "contiguous"),
    ("head_dim", "no head_dim 48"),
    ("pair", r"no head_dim pair \(32, 16\)"),
    ("f32_pair", r"no head_dim pair \(192, 128\) in torch.float32"),
])
def test_kernel_input_checks(case, match):
    """What the wrapper refuses before any pointer reaches the kernel."""
    q = torch.zeros((2, 64, 32))
    k = v = q
    if case == "rank":
        q = k = v = torch.zeros((2, 64))
    elif case == "mismatch":
        k = torch.zeros((2, 32, 32))
    elif case == "float16":
        q = k = v = q.half()
    elif case == "mixed":
        k = q.bfloat16()
    elif case == "strided":
        q = torch.zeros((2, 32, 64)).transpose(1, 2)
    elif case == "head_dim":
        q = k = v = torch.zeros((2, 64, 48))
    elif case == "pair":
        v = torch.zeros((2, 64, 16))
    elif case == "f32_pair":
        q = k = torch.zeros((2, 64, 192))
        v = torch.zeros((2, 64, 128))
    with pytest.raises(ValueError, match=match):
        tfa._check_kernel_inputs(q, k, v)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()


def test_kernel_library_name_follows_source_and_flags(monkeypatch):
    """A changed source or flag set gets a fresh library, never a stale one."""
    src = _kernels.CSRC / "flash_fwd.cu"
    assert src.is_file()
    digest = _kernels._digest(src)
    assert len(digest) == 16 and digest == _kernels._digest(src)
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    assert _kernels._digest(src) != digest


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,block", [(128, 128), (96, 64), (200, 128)])
def test_rounding_plain_forward_matches_jax_kernel(d, causal, seq, block):
    """In bf16 the plain version rounds P to bf16 before P V, as the JAX
    kernel does (flash_attention.py:111), so it agrees with the kernel to
    within its output rounding: < 1e-2 (the bar above is 3e-2)."""
    arrays = inputs(2, seq, d, seed=11 + seq + d)
    out = tfa.flash_attention(*to_torch(arrays, "bfloat16"), None, causal)
    kernel = jfa.flash_attention(*to_jax(arrays, jnp.bfloat16), None, causal,
                                 block, block, True)
    assert np.max(np.abs(as_np(out) - as_np(kernel))) < 1e-2


# (query/key head dim, value head dim): the tiny tests' 32, latent
# attention's (192, 128) and a tiny (24 + 8, 16); the first keeps the ids
# it had
HEAD_DIMS = [((32, 32), ""), ((192, 128), "192x128-"), ((32, 16), "32x16-")]


@pytest.mark.parametrize("dims,causal", [
    (dims, causal) for dims, _ in HEAD_DIMS for causal in (True, False)],
    ids=[f"{tag}{causal}" for _, tag in HEAD_DIMS for causal in (True, False)])
def test_plain_forward_in_f32_is_unrounded(dims, causal):
    """f32 inputs take exp(s - lse) V as before, bit for bit; bf16 inputs
    go through the rounding recurrence, which in f32 arithmetic differs
    from it only by rounding. V may have a head dim of its own."""
    d, dv = dims
    q, k, _ = to_torch(inputs(2, 200, d, seed=4), "float32")
    v = to_torch(inputs(2, 200, dv, seed=5), "float32")[0]
    scale = d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        s = torch.where(torch.ones(200, 200, dtype=torch.bool).tril(), s,
                        tfa.NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    old = torch.einsum("bqk,bkd->bqd", torch.exp(s - lse[..., None]), v)
    o, plain_lse = tfa.flash_attention_plain(q, k, v, scale, causal, True)
    assert torch.equal(o, old) and torch.equal(plain_lse, lse)
    assert torch.allclose(tfa._rounded_pv(s, v), old, atol=1e-6)


def test_rounding_terms_bound_every_term():
    """`rounding_terms_fwd` is no smaller than any single term P[r, i]
    |v[i, c]| of o[r, c]'s sum."""
    q, k, v = to_torch(inputs(2, 96, 16, seed=6), "bfloat16")
    scale = 0.25
    _, lse = tfa.flash_attention_plain(q, k, v, scale, True, True)
    term = tfa.rounding_terms_fwd(q, k, v, lse, scale, True)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = torch.where(torch.ones(96, 96, dtype=torch.bool).tril(), s,
                    tfa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    terms = (p[..., None] * v.float().abs()[:, None]).amax(dim=2)
    assert term.shape == q.shape
    assert bool((terms <= term * (1 + 1e-6)).all())
