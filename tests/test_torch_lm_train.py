"""The port's LM training pieces against the reference's on the CPU: the
data pipeline (``repro_torch.data.lm_data``), the chunked cross-entropy
(``models.stack.chunked_ce_loss``), the loss's precision scope and head
upcast, the launcher (``repro_torch.launch.train``) and the examples
beside the reference's (``lm_ternary_train_torch.py``,
``quickstart_torch.py``, ``kws_stream_torch.py``).

Tolerances, each stated where it is used: batches equal byte for byte;
``chunked_ce_loss`` within 1e-6 relative of the reference's loss, and its
gradients within rtol 1e-5 / atol 1e-7 (float32 sums in another order);
the examples' bit-exact lines exact.
"""
from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_data as ref_lm_data
from repro.models import stack as ref_stack
from repro_torch.configs import base as port_base
from repro_torch.data import lm_data
from repro_torch.launch import train as port_train
from repro_torch.models import api, layers, stack
from repro_torch.train import loop
from repro_torch.utils.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# lm_data
# ---------------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    """bf16 words of a reference (ml_dtypes) array or a port tensor."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    assert x.dtype.name == "bfloat16"
    return np.asarray(x).view(np.uint16)


def _same_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "frontend":
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        else:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=16, global_batch=8),
    dict(vocab=50, seq_len=33, global_batch=6, seed=7),
    dict(vocab=1000, seq_len=16, global_batch=8, n_hosts=2, host_id=1),
    dict(vocab=1000, seq_len=16, global_batch=8, microbatches=4),
    dict(vocab=300, seq_len=8, global_batch=4, frontend_tokens=5,
         frontend_dim=24),
    dict(vocab=300, seq_len=8, global_batch=8, frontend_tokens=3,
         frontend_dim=16, microbatches=2, n_hosts=2, host_id=0, seed=3),
], ids=["plain", "seed", "host", "microbatches", "frontend",
        "frontend-mb-host"])
@pytest.mark.parametrize("step", [0, 5])
def test_lm_data_batches_equal_reference(kw, step):
    """Tokens, labels and the frontend's bf16 bits, byte for byte."""
    got = lm_data.batch_at(lm_data.DataConfig(**kw), step)
    want = ref_lm_data.batch_at(ref_lm_data.DataConfig(**kw), step)
    _same_batch(got, want)
    it, ref_it = (lm_data.iterator(lm_data.DataConfig(**kw), step),
                  ref_lm_data.iterator(ref_lm_data.DataConfig(**kw), step))
    for _ in range(2):
        _same_batch(next(it), next(ref_it))


def test_lm_data_deterministic_and_host_sharded():
    """The reference's ``tests/test_data_serve.py`` contracts."""
    cfg = lm_data.DataConfig(vocab=1000, seq_len=16, global_batch=8)
    b1, b2 = lm_data.batch_at(cfg, 3), lm_data.batch_at(cfg, 3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], lm_data.batch_at(cfg, 4)["tokens"])
    h0, h1 = (lm_data.batch_at(lm_data.DataConfig(
        vocab=1000, seq_len=16, global_batch=8, n_hosts=2, host_id=i), 3)
        for i in (0, 1))
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    b = lm_data.batch_at(lm_data.DataConfig(vocab=1000, seq_len=16,
                                            global_batch=4), 0)
    assert b["tokens"].shape == b["labels"].shape
    assert (b["tokens"] >= 0).all() and (b["tokens"] < 1000).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_lm_data_to_device():
    b = lm_data.batch_at(lm_data.DataConfig(
        vocab=100, seq_len=4, global_batch=2, frontend_tokens=2,
        frontend_dim=8), 0)
    d = lm_data.to_device(b, "cpu")
    assert d["tokens"].dtype == d["labels"].dtype == torch.int64
    assert d["frontend"].dtype == torch.bfloat16
    np.testing.assert_array_equal(d["tokens"].numpy(), b["tokens"])
    assert torch.equal(d["frontend"], b["frontend"])


def test_lm_data_imports_no_ml_dtypes():
    src = (ROOT / "src/repro_torch/data/lm_data.py").read_text()
    assert "ml_dtypes" not in src.split('"""', 2)[2]
    assert "astype(\"bfloat16\")" not in src


# ---------------------------------------------------------------------------
# chunked_ce_loss
# ---------------------------------------------------------------------------

D_CE, VOCAB, PADDED = 8, 37, 48


def _ce_case(b, s, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, D_CE)).astype(np.float32)
    h = np.array(jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32))
    w = rng.standard_normal((D_CE, PADDED)).astype(np.float32)
    labels = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    flat = labels.reshape(-1)
    flat[::5] = -1                   # masked
    flat[1::7] = VOCAB + 3           # >= vocab: masked, gather clipped
    flat[2::11] = PADDED + 9         # >= padded_vocab: clipped to the last
    return h, w, labels


@pytest.mark.parametrize("b,s,chunk", [(2, 16, 4), (2, 16, 16), (2, 15, 4),
                                       (3, 12, 64), (1, 18, 8)],
                         ids=["chunked", "one-chunk", "irregular-tail",
                              "chunk-above-seq", "tail-18-by-8"])
def test_chunked_ce_loss_matches_reference(b, s, chunk):
    """Loss within 1e-6 relative; dL/dh and dL/dW within rtol 1e-5 and
    atol 1e-7 (float32 sums in another order)."""
    h, w, labels = _ce_case(b, s, seed=b * 100 + s)

    def ref(hh, ww):
        return ref_stack.chunked_ce_loss(
            lambda hc: hc.astype(jnp.float32) @ ww, hh, jnp.asarray(labels),
            VOCAB, PADDED, chunk=chunk)
    want, (want_dh, want_dw) = jax.value_and_grad(ref, (0, 1))(
        jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(w))
    th = torch.as_tensor(h).to(torch.bfloat16).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    got = stack.chunked_ce_loss(lambda hc: hc.to(torch.float32) @ tw, th,
                                torch.as_tensor(labels), VOCAB, PADDED,
                                chunk=chunk)
    got_dh, got_dw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-7)
    assert got_dh.dtype == torch.bfloat16
    np.testing.assert_allclose(got_dh.float().numpy(),
                               np.asarray(want_dh.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-7)


def test_chunked_ce_loss_all_masked_is_zero():
    h = torch.randn(2, 4, D_CE)
    w = torch.randn(D_CE, PADDED)
    labels = torch.full((2, 4), -1)
    got = stack.chunked_ce_loss(lambda hc: hc @ w, h, labels, VOCAB, PADDED)
    assert float(got) == 0.0


# ---------------------------------------------------------------------------
# The loss's precision scope and head upcast
# ---------------------------------------------------------------------------

CFG = port_base.get_arch("qwen3-0.6b", smoke=True)


def _params():
    return api.init_params(CFG, generator=torch.Generator().manual_seed(0),
                           device="cpu")


def _batch(seed=0):
    b = lm_data.batch_at(lm_data.DataConfig(vocab=CFG.vocab, seq_len=16,
                                            global_batch=2, seed=seed), 0)
    return lm_data.to_device(b, "cpu")


def test_backward_runs_at_lm_precision(monkeypatch):
    """Under a global "high" float32 precision, every matmul of the loss's
    forward, backward and checkpointed recomputation sees "highest", and
    the process's setting is restored after the backward."""
    seen = []
    mm = torch.matmul

    def spy(*a, **k):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul
                     .allow_bf16_reduced_precision_reduction))
        return mm(*a, **k)

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        monkeypatch.setattr(torch, "matmul", spy)
        params, batch = _params(), _batch()
        api.loss_fn(CFG, "block")(params, batch)
        n_forward = len(seen)
        seen.clear()
        loss, grads = loop.value_and_grad(api.loss_fn(CFG, "block"), params,
                                          batch)
        monkeypatch.setattr(torch, "matmul", mm)
        assert torch.get_float32_matmul_precision() == "high"
        # the backward recomputed the checkpointed blocks' matmuls
        assert n_forward and len(seen) > n_forward
        assert all(s == ("highest", False) for s in seen)
        assert torch.isfinite(loss) and all(
            torch.isfinite(g.float()).all() for g in tree_leaves(grads))
    finally:
        torch.set_float32_matmul_precision(prev)


def test_backward_precision_scope_inside_the_pass():
    """The backward's own nodes run under "highest"; the caller's
    setting is back when the pass ends."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.get_float32_matmul_precision())
            return g

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        x = torch.ones(3, requires_grad=True)
        loss = layers.backward_at_lm_precision(Probe.apply(x).sum())
        loss.backward()
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_head_upcast_is_not_memoized_under_a_gradient():
    """A weight that takes a gradient gets a fresh float32 copy each call
    (no graph carried between losses); serving keeps its memo."""
    params = _params()
    w = params["embed"].detach().requires_grad_(True)
    a, b = stack._head_f32(w), stack._head_f32(w)
    assert a is not b and a.grad_fn is not None
    assert not hasattr(w, "_f32_copy")
    with torch.no_grad():
        c, d = stack._head_f32(w), stack._head_f32(w)
    assert c is d and c.grad_fn is None


def test_tied_embedding_gets_both_gradients():
    """The tied embedding's gradient is the gather's plus the head's: the
    head's part equals the gradient of the logits alone."""
    params = _params()
    assert CFG.tie_embeddings
    batch = _batch()
    _, g = loop.value_and_grad(api.loss_fn(CFG, "none"), params, batch)
    embed = params["embed"].detach().requires_grad_(True)
    p2 = dict(params, embed=embed)
    with layers.lm_precision():
        h, _, _ = stack.forward_hidden(CFG, p2, batch["tokens"], remat="none")
        g_gather = torch.autograd.grad(h.float().sum(), embed)[0]
    rows = torch.unique(batch["tokens"])
    others = torch.ones(CFG.padded_vocab, dtype=torch.bool)
    others[rows] = False
    assert float(g_gather[others].abs().max()) == 0.0
    assert float(g["embed"][others].float().abs().max()) > 0  # head only


# ---------------------------------------------------------------------------
# No card
# ---------------------------------------------------------------------------

def test_training_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    b = lm_data.batch_at(lm_data.DataConfig(vocab=10, seq_len=4,
                                            global_batch=2), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_data.to_device(b)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("lm_ternary_train_torch").main(["--steps", "1"])


# ---------------------------------------------------------------------------
# Launcher and examples
# ---------------------------------------------------------------------------

def test_launcher_survives_a_simulated_failure(tmp_path):
    """--failure-rate draws from random.Random(seed); each simulated
    failure restarts the trainer, which resumes from the last checkpoint
    (every 2 steps), and the run ends at --steps."""
    out = port_train.main([
        "--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--failure-rate", "0.3", "--seed", "3", "--device", "cpu"])
    assert out["steps"] == 6 and out["restarts"] >= 1
    steps = [m["step"] for m in out["history"]]
    assert steps[-1] == 6 and all(np.isfinite(m["loss"])
                                  for m in out["history"])
    # after a restart the run resumes at a checkpointed step, never at 1
    resumed = [b for a, b in zip(steps, steps[1:]) if b <= a]
    assert resumed and all(s > 1 and (s - 1) % 2 == 0 for s in resumed)


def test_launcher_without_checkpoints_raises_on_failure():
    with pytest.raises(RuntimeError, match="simulated"):
        port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "8", "--failure-rate",
                         "1.0", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_launcher_trains_frontend_families(arch):
    out = port_train.main(["--arch", arch, "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "8", "--remat", "block",
                           "--microbatches", "2", "--device", "cpu"])
    assert out["steps"] == 2 and out["restarts"] == 0
    assert all(np.isfinite(m["loss"]) for m in out["history"])


def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_ternary_example_runs(capsys):
    out = _example("lm_ternary_train_torch").main(["--steps", "4",
                                                   "--device", "cpu"])
    assert np.isfinite(out["gap"])
    assert out["fp"][-1]["loss"] < out["fp"][0]["loss"]
    assert np.isfinite(out["ternary"][-1]["loss"])
    assert out["dense_bytes"] // out["packed_bytes"] >= 7
    assert "quantization loss gap" in capsys.readouterr().out


def test_quickstart_example_is_bit_exact(capsys):
    assert _example("quickstart_torch").main(["--steps", "3", "--device",
                                              "cpu"])
    assert "bit-exact: True" in capsys.readouterr().out


def test_kws_stream_example_matches_the_executor(capsys):
    n = _example("kws_stream_torch").main(["--steps", "3", "--device",
                                           "cpu"])
    text = capsys.readouterr().out
    assert text.count("offline-match=OK") == n
    assert "MISMATCH" not in text
