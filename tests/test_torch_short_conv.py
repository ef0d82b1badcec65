"""LFM2's gated short convolution (short_conv.py) on the CPU.

A CPU tensor takes `short_conv.gated_conv_plain`, the composition the
hybrid block ran before the convolution had its kernel pair, and
`workload.sgd_step` gives the same loss and gradients as with that
composition inline. The plain version is held to the benchmark's f32
reference, `_conv` of `benchmarks/definitions/lfm2-8b-a1b.py` (torch's
conv1d), forward and backward, within the stated roundings: each
output or gradient element is three bf16 roundings (u, mixed, y; dmixed,
du, dB or dh; dmixed, u, each tap's product) from the f32 value, each of
exact products or f32 sums and at most 2^-8 of the sum of the absolute
values of the element's terms, which the same reference gives on the
absolute values of the inputs. The kernels themselves run in
tests/test_torch_gpu.py.
"""

from unittest import mock

import pytest
import torch

from tpu_device_plugin_torch.validator import short_conv, tracing
from tpu_device_plugin_torch.validator import workload as tw

import torch_lfm2_tiny as tiny

# three bf16 roundings of at most 2^-8 each against the sum of the
# absolute values of an element's terms; their second-order terms and the
# f32 sums' rounding (under 50 terms) fit under a fourth
ROUNDING_RTOL = 2 ** -6
# (b, s, d), b s <= d (`_reference`): one sequence, b > 1, one token
SHAPES = [(1, 23, 64), (2, 23, 48), (2, 1, 16)]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _inputs(b, s, d, taps, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bch = torch.randn((b, s, 3 * d), generator=gen).to(torch.bfloat16)
    w = torch.randn((taps, d), generator=gen) * taps ** -0.5
    dy = torch.randn((b, s, d), generator=gen).to(torch.bfloat16)
    return bch, w, dy


def _value_and_grads(fn, bch, w, dy):
    leaf, taps = bch.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(leaf, taps)
    y.backward(dy)
    return y.detach(), leaf.grad, taps.grad


def _reference(bch, w, dy):
    """The definition's `_conv` in f32 on bch (b, s, 3d), b s <= d, its
    projections made exact (token i the one-hot row i, conv_in's row i
    bch's row i, conv_out the identity), so that it computes
    `C * conv(B * h)` on these very values: its output and the gradients
    of bch and w for dy."""
    b, s, d3 = bch.shape
    d = d3 // 3
    conv_in = torch.zeros((d, d3))
    conv_in[:b * s] = bch.float().reshape(b * s, d3)
    conv_in.requires_grad_()
    taps = w.float().detach().requires_grad_()
    onehot = torch.eye(d)[:b * s].reshape(b, s, d)
    y = tiny.definition()._conv(onehot, conv_in, taps, torch.eye(d), {},
                                "f32")
    y.backward(dy.float())
    return y.detach(), conv_in.grad[:b * s].reshape(b, s, d3), taps.grad


@pytest.mark.parametrize("taps", [2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"b{b}s{s}d{d}"
                                               for b, s, d in SHAPES])
def test_plain_is_the_definitions_convolution_at_the_stated_roundings(
        shape, taps):
    bch, w, dy = _inputs(*shape, taps)
    got = _value_and_grads(short_conv.gated_conv_plain, bch, w, dy)
    ref = _reference(bch, w, dy)
    terms = _reference(bch.abs(), w.abs(), dy.abs())
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    for name, g, r, t in zip(("y", "dbch", "dw"), got, ref, terms):
        assert g.shape == r.shape, name
        bar = ROUNDING_RTOL * t
        assert ((g.float() - r).abs() <= bar).all(), name


@pytest.mark.parametrize("taps", [2, 3, 4])
def test_cpu_takes_the_plain_version_bit_for_bit(taps):
    bch, w, dy = _inputs(2, 23, 32, taps, seed=1)
    got = _value_and_grads(short_conv.gated_conv, bch, w, dy)
    want = _value_and_grads(short_conv.gated_conv_plain, bch, w, dy)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("taps", [2, 3, 4])
def test_no_token_crosses_the_batch(taps):
    """The second sequence's outputs and gradients are its own alone: its
    first K - 1 outputs see no token of the first."""
    bch, w, dy = _inputs(2, 9, 16, taps, seed=2)
    y, dbch, _ = _value_and_grads(short_conv.gated_conv, bch, w, dy)
    alone = _value_and_grads(short_conv.gated_conv, bch[1:], w, dy[1:])
    assert torch.equal(y[1:], alone[0]) and torch.equal(dbch[1:], alone[1])
    other = bch.clone()
    other[0] = other[0].flip(0) * 2
    y2 = short_conv.gated_conv(other, w)
    assert torch.equal(y2[1, :taps - 1], y[1, :taps - 1])
    assert not torch.equal(y2[0], y[0])


def _short_conv_inline(x, layer):
    """`workload._short_conv` before the convolution moved to
    short_conv.py."""
    bch = x @ layer["conv_in"].to(torch.bfloat16)
    gate_b, gate_c, h = bch.chunk(3, -1)
    mixed = short_conv._CausalConv.apply(gate_b * h, layer["conv_w"])
    return (gate_c * mixed) @ layer["conv_out"].to(torch.bfloat16)


def test_sgd_step_unchanged_by_the_move():
    params, tokens = tiny.inputs(7, "cpu")
    runs = []
    for conv in (tw._short_conv, _short_conv_inline):
        with mock.patch.object(tw, "_short_conv", conv):
            runs.append(tiny.port_step(tw, params, tokens, "einsum"))
    (loss, grad, new, _), ref = runs
    assert loss == ref[0]
    for key in grad:
        assert torch.equal(grad[key], ref[1][key]), key
        assert torch.equal(new[key], ref[2][key]), key


def test_cpu_path_counts_no_fused_rows():
    bch, w, _ = _inputs(2, 9, 16, 3)
    with tracing.recording() as rec:
        short_conv.gated_conv(bch, w)
    assert "conv.fused_rows" not in rec.counts


def _sliced(bch):
    return bch[..., :bch.shape[-1] // 2]


def _transposed(bch):
    return _sliced(bch.transpose(0, 1))


@pytest.mark.parametrize("case", [
    ("bfloat16", "float32", (2, 9, 96), (3, 16), _sliced, None),
    ("float32", "float32", (2, 9, 48), (3, 16), None, "bfloat16 bch"),
    ("bfloat16", "bfloat16", (2, 9, 48), (3, 16), None, "float32 taps"),
    ("bfloat16", "float32", (2, 9, 48), (5, 16), None, "K in"),
    ("bfloat16", "float32", (2, 9, 48), (1, 16), None, "K in"),
    ("bfloat16", "float32", (2, 9, 36), (3, 12), None, "multiple of 8"),
    ("bfloat16", "float32", (2, 9, 48), (3, 8), None, r"\(b, s, 3d\)"),
    ("bfloat16", "float32", (18, 48), (3, 16), None, r"\(b, s, 3d\)"),
    ("bfloat16", "float32", (2, 9, 96), (3, 16), _sliced, "contiguous"),
    ("bfloat16", "float32", (9, 2, 96), (3, 16), _transposed, "contiguous"),
], ids=["dense-copy", "f32-bch", "bf16-taps", "K5", "K1", "d12", "other-d",
        "2-d-bch", "sliced", "transposed"])
def test_kernel_inputs_are_checked(case):
    """What the kernels refuse, and a dense copy of a slice they take."""
    dtype, wtype, shape, wshape, view, message = case
    bch = torch.zeros(shape, dtype=getattr(torch, dtype))
    w = torch.zeros(wshape, dtype=getattr(torch, wtype))
    if view is not None:
        bch = view(bch)
    if message is None:
        assert short_conv._check(bch.contiguous(), w) == (2, 9, 16, 3)
        return
    with pytest.raises(ValueError, match=message):
        short_conv._check(bch, w)
