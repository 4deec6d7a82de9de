"""Model-layer shape/behaviour tests (style of
reference: deepblast/tests/test_alignment.py, test_language_model.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepblast_jax.models import (
    BiLM, NeuralAligner, StackedCNN, StackedRNN, T5Config, T5Encoder)


def test_stacked_cnn_shapes():
    m = StackedCNN(features=16, layers=2, k_size=5)
    x = jnp.ones((2, 11, 8), jnp.float32)
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (2, 11, 16)


def test_stacked_rnn_shapes():
    m = StackedRNN(hidden=8, features=12, layers=2)
    x = jnp.ones((2, 7, 6), jnp.float32)
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (2, 7, 12)


@pytest.mark.parametrize("head", ["cnn", "rnn"])
def test_heads_pad_invariant(head):
    """Features at true positions must not depend on pad width or pad
    content — conv stacks read layers*(k-1)/2 positions past each row's
    end, reverse RNNs read the whole buffer (the reference leaks both,
    deepblast/embedding.py:85-168)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    lengths = jnp.asarray([10, 7])
    m = (StackedCNN(features=16, layers=2, k_size=5) if head == "cnn"
         else StackedRNN(hidden=8, features=16, layers=2))
    # narrow buffer, zero pads vs wide buffer, junk pads
    xa = np.pad(x, ((0, 0), (0, 2), (0, 0)))
    xb = np.pad(x, ((0, 0), (0, 22), (0, 0)))
    xb[:, 10:, :] = rng.standard_normal((2, 22, 6))
    xb[1, 7:, :] = rng.standard_normal((25, 6))
    xa[1, 7:10, :] = 3.0  # junk INSIDE the narrow buffer past row 1's end
    params = m.init(jax.random.key(0), jnp.asarray(xa), lengths)
    ya = m.apply(params, jnp.asarray(xa), lengths)
    yb = m.apply(params, jnp.asarray(xb), lengths)
    for b, L in enumerate([10, 7]):
        np.testing.assert_allclose(np.asarray(ya)[b, :L],
                                   np.asarray(yb)[b, :L],
                                   rtol=1e-5, atol=1e-6)


def test_bilm_encode_shapes_and_masking():
    m = BiLM(nin=22, nout=21, embedding_dim=8, hidden_dim=8, num_layers=2)
    tok = jnp.asarray(np.random.default_rng(0).integers(0, 21, (2, 9)))
    lengths = jnp.asarray([9, 5])
    params = m.init(jax.random.key(0), tok, lengths)
    h = m.apply(params, tok, lengths, method=BiLM.encode)
    assert h.shape == (2, 9, 2 * 2 * 8)
    logp = m.apply(params, tok, lengths)
    assert logp.shape == (2, 9, 21)
    np.testing.assert_allclose(
        np.exp(np.asarray(logp)).sum(-1), 1.0, rtol=1e-5)


def test_bilm_reverse_respects_lengths():
    """Features of a short sequence must not depend on padding content."""
    m = BiLM(nin=22, nout=21, embedding_dim=8, hidden_dim=8, num_layers=1)
    rng = np.random.default_rng(1)
    tok1 = jnp.asarray(rng.integers(0, 21, (1, 8)))
    tok2 = tok1.at[:, 5:].set(7)  # change only padding region
    lengths = jnp.asarray([5])
    params = m.init(jax.random.key(0), tok1, lengths)
    h1 = m.apply(params, tok1, lengths, method=BiLM.encode)
    h2 = m.apply(params, tok2, lengths, method=BiLM.encode)
    np.testing.assert_allclose(h1[:, :5], h2[:, :5], atol=1e-6)


def test_t5_encoder_shapes():
    cfg = T5Config.tiny()
    m = T5Encoder(cfg)
    tok = jnp.asarray(np.random.default_rng(0).integers(0, 30, (2, 10)))
    mask = jnp.asarray([[1] * 10, [1] * 6 + [0] * 4])
    params = m.init(jax.random.key(0), tok, mask)
    h = m.apply(params, tok, mask)
    assert h.shape == (2, 10, cfg.d_model)
    assert np.all(np.asarray(h[1, 6:]) == 0)


def test_t5_hf_conversion_roundtrip():
    """convert_hf_t5_encoder accepts a synthetic HF-layout state dict and
    produces params the T5 module can run with."""
    from deepblast_jax.models import convert_hf_t5_encoder
    cfg = T5Config.tiny()
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    inner = cfg.num_heads * cfg.d_kv
    sd = {"shared.weight": w(cfg.vocab_size, cfg.d_model),
          "encoder.final_layer_norm.weight": w(cfg.d_model)}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        sd[f"{pre}.0.SelfAttention.q.weight"] = w(inner, cfg.d_model)
        sd[f"{pre}.0.SelfAttention.k.weight"] = w(inner, cfg.d_model)
        sd[f"{pre}.0.SelfAttention.v.weight"] = w(inner, cfg.d_model)
        sd[f"{pre}.0.SelfAttention.o.weight"] = w(cfg.d_model, inner)
        sd[f"{pre}.0.layer_norm.weight"] = w(cfg.d_model)
        sd[f"{pre}.1.DenseReluDense.wi.weight"] = w(cfg.d_ff, cfg.d_model)
        sd[f"{pre}.1.DenseReluDense.wo.weight"] = w(cfg.d_model, cfg.d_ff)
        sd[f"{pre}.1.layer_norm.weight"] = w(cfg.d_model)
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
       ".weight"] = w(cfg.relative_attention_num_buckets, cfg.num_heads)

    params = convert_hf_t5_encoder(sd, cfg)
    m = T5Encoder(cfg)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 7)))
    h = m.apply(params, tok)
    assert h.shape == (1, 7, cfg.d_model)
    # structure must match a fresh init exactly
    ref = m.init(jax.random.key(0), tok)
    flat_a = jax.tree_util.tree_structure(params)
    flat_b = jax.tree_util.tree_structure(ref)
    assert flat_a == flat_b


@pytest.mark.parametrize("mode", ["needleman-wunsch", "smith-waterman"])
def test_neural_aligner_forward(mode):
    D = 12
    m = NeuralAligner(embedding_dim=D, hidden_dim=16, layers=2,
                      alignment_mode=mode)
    rng = np.random.default_rng(0)
    B, N, M = 2, 9, 7
    hx = jnp.asarray(rng.standard_normal((B, N, D)), jnp.float32)
    hy = jnp.asarray(rng.standard_normal((B, M, D)), jnp.float32)
    ln = jnp.asarray([N, 5])
    lm_ = jnp.asarray([M, 4])
    params = m.init(jax.random.key(0), hx, hy, (ln, lm_))
    aln, theta, A = m.apply(params, hx, hy, (ln, lm_))
    assert aln.shape == (B, N, M)
    assert theta.shape == (B, N, M)
    # expected alignment marginals live in [0, 1]-ish and pad region is 0
    assert np.all(np.asarray(aln[1, 5:, :]) == 0)
    assert np.all(np.asarray(aln[1, :, 4:]) == 0)
    # the model is trainable end to end: grads flow to both heads
    def loss(p):
        a, _, _ = m.apply(p, hx, hy, (ln, lm_))
        return jnp.sum(a * a)
    g = jax.grad(loss)(params)
    gm = jax.tree_util.tree_leaves(g["params"]["match_embedding"])
    gg = jax.tree_util.tree_leaves(g["params"]["gap_embedding"])
    assert any(np.abs(np.asarray(x)).max() > 0 for x in gm)
    assert any(np.abs(np.asarray(x)).max() > 0 for x in gg)


def test_neural_aligner_score():
    D = 8
    m = NeuralAligner(embedding_dim=D, hidden_dim=8, layers=1)
    rng = np.random.default_rng(1)
    hx = jnp.asarray(rng.standard_normal((1, 5, D)), jnp.float32)
    hy = jnp.asarray(rng.standard_normal((1, 6, D)), jnp.float32)
    params = m.init(jax.random.key(0), hx, hy)
    s = m.apply(params, hx, hy, method=NeuralAligner.score)
    assert s.shape == (1,)
    assert np.isfinite(np.asarray(s)).all()
