"""Port parity: the serving forward of tpu_device_plugin_torch vs the JAX one.

The JAX side builds its model with `build_infer` (one-CPU mesh, Pallas
kernel in interpret mode for flash); its weights and tokens cross to the
port through numpy (`params_from_jax`), because `jax.random` cannot be
reproduced in torch. Tolerances: max |dlogit| <= 2% of max |logit| (both
frameworks run every matmul in bf16 but round at different places; jitted
XLA also keeps excess precision inside fusions; measured 0.9-1.0%), and
the loss within 1e-2. Argmax agreement >= 99% at the small configuration
(vocab 64). At the entry configuration (vocab 256) near-tied logits flip
under bf16 rounding alone: the JAX package's own flash and einsum forwards
agree on 98.6% of positions there, so the port is held to 98%.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_device_plugin.validator import workload as jw  # noqa: E402
from tpu_device_plugin_torch.validator import workload as tw  # noqa: E402

SMALL = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=96, batch=2)
# __graft_entry__.entry()'s configuration (head_dim 16)
ENTRY = dict(seq_len=128, batch=4, n_layers=2)
LOGIT_REL_TOL = 0.02
ARGMAX_AGREE_MIN = {"small": 0.99, "entry": 0.98}
# vocab 256 (entry) has many near-tied logits: its agreement is pooled
AGREE_SEEDS = {"small": (0,), "entry": (0, 1, 2)}


def port_inputs(params, tokens):
    tparams = tw.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return tparams, torch.from_numpy(np.array(tokens))


@pytest.mark.parametrize("attention", ["flash", "einsum"])
@pytest.mark.parametrize("name", ["small", "entry"])
def test_forward_matches_jax_build_infer(name, attention):
    """Logits within LOGIT_REL_TOL for each seed; argmax agreement over
    the positions of all AGREE_SEEDS. At vocab 256 near-tied logits flip
    under bf16 rounding alone, so one batch of 512 positions estimates the
    agreement only to about +-0.6 points: over seeds 0-5 the entry config's
    flash forward agrees on 97.7-99.8% (mean 98.8%) of positions."""
    cfg_kw = {"small": SMALL, "entry": ENTRY}[name]
    agree = []
    for seed in AGREE_SEEDS[name]:
        fwd, params, tokens = jw.build_infer(jw.ModelConfig(**cfg_kw),
                                             seed=seed, attention=attention)
        ref = np.asarray(fwd(params, tokens))
        tparams, ttokens = port_inputs(params, tokens)
        cfg = tw.ModelConfig(**cfg_kw)
        with torch.no_grad():
            out = tw.forward(tparams, ttokens, cfg, attention).numpy()
        assert out.shape == ref.shape == (cfg.batch, cfg.seq_len, cfg.vocab)
        assert np.max(np.abs(out - ref)) <= LOGIT_REL_TOL * np.max(np.abs(ref))
        agree.append(np.mean(out.argmax(-1) == ref.argmax(-1)))
    assert np.mean(agree) >= ARGMAX_AGREE_MIN[name]


@pytest.mark.parametrize("attention", ["flash", "einsum"])
def test_loss_matches_jax(attention):
    cfg_kw = SMALL
    params = jw.init_params(jax.random.key(0), jw.ModelConfig(**cfg_kw))
    tokens = jax.random.randint(jax.random.key(1), (2, 96), 0, 64,
                                dtype=jnp.int32)
    ref = float(jw.loss_fn(params, tokens, jw.ModelConfig(**cfg_kw)))
    tparams, ttokens = port_inputs(params, tokens)
    with torch.no_grad():
        loss = tw.loss_fn(tparams, ttokens, tw.ModelConfig(**cfg_kw),
                          attention).item()
    assert abs(loss - ref) < 1e-2


def test_build_infer_port_defaults_to_cuda_without_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tw.build_infer(),
                  lambda: tw.build_infer(tw.ModelConfig(), attention="flash"),
                  lambda: tw.params_from_jax({"embed": np.zeros((2, 2))}),
                  lambda: tw.init_params(torch.Generator(), tw.ModelConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


@pytest.mark.parametrize("n_experts", [0, 2])
def test_init_params_matches_jax_layout(n_experts):
    cfg_kw = dict(SMALL, n_experts=n_experts)
    ref = jw.init_params(jax.random.key(0), jw.ModelConfig(**cfg_kw))
    gen = torch.Generator().manual_seed(0)
    out = tw.init_params(gen, tw.ModelConfig(**cfg_kw), "cpu")
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    out_shapes = {"embed": tuple(out["embed"].shape),
                  "unembed": tuple(out["unembed"].shape),
                  "layers": {k: tuple(v.shape) for k, v in out["layers"].items()}}
    assert out_shapes == ref_shapes
    # same scale: N(0, 1) * d_model ** -0.5
    std = out["layers"]["wq"].std().item()
    assert abs(std - 64 ** -0.5) < 0.1 * 64 ** -0.5


_PINNED = dict(vocab=96, d_model=64, n_heads=4, d_ff=160, n_layers=3)
_ATTENTION_LEAVES = [("layers.wq", (3, 64, 64)), ("layers.wk", (3, 64, 64)),
                     ("layers.wv", (3, 64, 64)), ("layers.wo", (3, 64, 64))]


@pytest.mark.parametrize("n_experts, leaves", [
    (0, [("layers.w1", (3, 64, 160)), ("layers.w2", (3, 160, 64))]),
    (3, [("layers.wr", (3, 64, 3)), ("layers.w1e", (3, 3, 64, 160)),
         ("layers.w2e", (3, 3, 160, 64))]),
], ids=["dense", "switch"])
def test_leaf_shapes_of_the_reference_block_are_pinned(n_experts, leaves):
    """Names, shapes and order: `init_params` draws the leaves in this
    order, so a seed gives the same weights only while it holds."""
    cfg = tw.ModelConfig(**_PINNED, n_experts=n_experts)
    assert list(tw.leaf_shapes(cfg).items()) == [
        ("embed", (96, 64)), ("unembed", (64, 96)), *_ATTENTION_LEAVES,
        *leaves]


def test_params_from_jax_copies_every_key():
    cfg = jw.ModelConfig(**dict(SMALL, n_experts=2))
    tree = jax.tree.map(np.array, jw.init_params(jax.random.key(1), cfg))
    out = tw.params_from_jax(tree, "cpu")
    assert set(out["layers"]) == {"wq", "wk", "wv", "wo", "wr", "w1e", "w2e"}
    for key in ("wr", "w1e", "w2e"):
        assert np.array_equal(out["layers"][key].numpy(), tree["layers"][key])
    # a copy, not a view of the caller's arrays
    tree["embed"][0, 0] += 1.0
    assert out["embed"][0, 0].item() != tree["embed"][0, 0]


def test_fold_heads_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 4)).astype(np.float32)
    ref = np.asarray(jw._fold_heads(jnp.asarray(x)))
    out = tw._fold_heads(torch.from_numpy(x))
    assert np.array_equal(out.numpy(), ref)
    back = tw._unfold_heads(out, 2, 3)
    assert np.array_equal(back.numpy(), x)


def test_rms_norm_and_mlp_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    layer = {"w1": rng.standard_normal((64, 128)).astype(np.float32) * 0.125,
             "w2": rng.standard_normal((128, 64)).astype(np.float32) * 0.125}
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    norm = tw._rms_norm(tx)
    assert norm.dtype == torch.bfloat16
    ref = np.asarray(jw._rms_norm(jx).astype(jnp.float32))
    assert np.max(np.abs(norm.float().numpy() - ref)) < 3e-2
    # tanh-approximate GELU, as jax.nn.gelu's default
    mlp = tw._mlp(tx, {k: torch.from_numpy(v) for k, v in layer.items()})
    ref = np.asarray(jw._mlp(jx, {k: jnp.asarray(v) for k, v in layer.items()})
                     .astype(jnp.float32))
    assert np.max(np.abs(mlp.float().numpy() - ref)) <= 0.02 * np.max(np.abs(ref))


def test_resolve_modes():
    assert tw._resolve(None, None, None, "cpu")[2] == "einsum"
    assert tw._resolve(None, None, "flash", "cpu")[2] == "flash"
    with pytest.raises(ValueError, match="unknown attention mode"):
        tw._resolve(None, None, "sparse", "cpu")
    # ring without a mesh is a ring of one: the own block, causal
    cfg = tw.ModelConfig(**SMALL)
    fwd, params, tokens = tw.build_infer(cfg, attention="ring", device="cpu")
    einsum = tw.forward(params, tokens, cfg, "einsum")
    assert (fwd(params, tokens) - einsum).abs().max() <= 0.02 * einsum.abs().max()


@pytest.mark.parametrize("seq,want", [(128, "einsum"), (511, "einsum"),
                                      (512, "flash"), (2048, "flash")])
def test_auto_dispatches_on_flash_min_seq_on_cuda(monkeypatch, seq, want):
    """On CUDA, auto takes the flash kernels from FLASH_MIN_SEQ on and
    einsum below it; on the CPU einsum at every length; explicit modes
    are honoured. (No tensor is made: _resolve only names the device.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = tw.ModelConfig(seq_len=seq)
    assert tw._resolve(cfg, None, None, "cuda")[2] == want
    assert tw._resolve(cfg, None, None, "cpu")[2] == "einsum"
    assert tw._resolve(cfg, None, "flash", "cuda")[2] == "flash"
    assert tw._resolve(cfg, None, "einsum", "cuda")[2] == "einsum"


def test_flash_min_seq_is_the_committed_sweeps_crossover():
    """FLASH_MIN_SEQ is the rule (attn_bench.crossover) applied to the H100
    sweeps committed under docs/, at hb 8 and hb 128; the mfu preset's
    seq 2048 takes flash."""
    import json
    from pathlib import Path

    from tpu_device_plugin_torch.validator.attn_bench import crossover
    from tpu_device_plugin_torch.validator.probe import PRESETS
    doc = json.loads((Path(__file__).resolve().parent.parent / "docs"
                      / "validator_h100_attn_pr7.json").read_text())
    assert doc["card"].startswith("NVIDIA H100")
    assert sorted(s["hb"] for s in doc["sweeps"]) == [8, 128]
    assert all(s["platform"] == "gpu" and not s["interpret"]
               for s in doc["sweeps"])
    assert tw.FLASH_MIN_SEQ == crossover(doc["sweeps"]) == doc["flash_min_seq"]
    assert PRESETS["mfu"]["seq_len"] >= tw.FLASH_MIN_SEQ


def test_crossover_rule():
    """The shortest length from which flash trains faster at every longer
    one, in every sweep; an einsum that failed counts for flash."""
    from tpu_device_plugin_torch.validator.attn_bench import crossover

    def sweep(*cells):
        return {"cells": [dict(seq=s, flash_train_ms=f, einsum_train_ms=e)
                          for s, f, e in cells]}
    a = sweep((256, 2.0, 1.0), (512, 1.0, 2.0), (1024, 1.0, None))
    b = sweep((256, 1.0, 2.0), (512, 1.0, 2.0), (1024, 3.0, 4.0))
    assert crossover([a]) == 512 and crossover([b]) == 256
    assert crossover([a, b]) == 512
    assert crossover([sweep((256, 1.0, 2.0), (512, 3.0, 2.0))]) is None
    assert crossover([sweep((256, 1.0, 2.0), (512, None, 2.0))]) is None


def test_build_infer_is_seeded():
    cfg = tw.ModelConfig(**SMALL)
    fwd, p1, t1 = tw.build_infer(cfg, seed=3, device="cpu")
    _, p2, t2 = tw.build_infer(cfg, seed=3, device="cpu")
    assert torch.equal(p1["layers"]["w1"], p2["layers"]["w1"])
    assert torch.equal(t1, t2)
    assert t1.shape == (cfg.batch, cfg.seq_len)
    assert 0 <= int(t1.min()) and int(t1.max()) < cfg.vocab
    logits = fwd(p1, t1)
    assert not logits.requires_grad and torch.isfinite(logits).all()
