"""Numerical parity of the native T5 encoder against the real HuggingFace
``T5EncoderModel`` computation graph (VERDICT round-1 item 7).

The reference wraps the HF torch model directly
(reference: deepblast/language_model.py:21-47); this repo re-implements
the encoder in plain JAX and converts the torch state dict
(deepblast_jax/models/lm.py::convert_hf_t5_encoder).  These tests
instantiate a *real* randomly-initialised ``T5EncoderModel`` offline (no
hub download), convert its state dict, and assert the JAX forward matches
the torch forward — covering kernel transposition, relative-bias
orientation/bucketing, RMSNorm placement, and masking, for both the
ProtT5 ``relu`` FF and the ``gated-gelu`` variant.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from deepblast_jax.models.lm import (  # noqa: E402
    T5Config,
    T5Encoder,
    convert_hf_t5_encoder,
)


def _hf_encoder(ff_proj, seed=0):
    hf_cfg = transformers.T5Config(
        vocab_size=32, d_model=32, d_kv=8, d_ff=64,
        num_layers=2, num_heads=4,
        relative_attention_num_buckets=8,
        relative_attention_max_distance=20,
        feed_forward_proj=ff_proj,
        dropout_rate=0.0, is_encoder_decoder=False, use_cache=False)
    torch.manual_seed(seed)
    model = transformers.T5EncoderModel(hf_cfg).eval()
    cfg = T5Config(vocab_size=32, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4,
                   relative_attention_num_buckets=8,
                   relative_attention_max_distance=20,
                   feed_forward_proj=ff_proj)
    return model, cfg


@pytest.mark.parametrize("ff_proj", ["relu", "gated-gelu"])
def test_t5_encoder_matches_hf(ff_proj):
    model, cfg = _hf_encoder(ff_proj)
    rng = np.random.default_rng(1)
    B, L = 3, 17
    tokens = rng.integers(0, cfg.vocab_size, (B, L))
    lengths = np.array([17, 11, 5])
    mask = (np.arange(L)[None, :] < lengths[:, None])

    with torch.no_grad():
        ref = model(input_ids=torch.tensor(tokens),
                    attention_mask=torch.tensor(mask.astype(np.int64)))
    ref_h = ref.last_hidden_state.numpy() * mask[..., None]

    params = convert_hf_t5_encoder(model.state_dict(), cfg)
    out = T5Encoder(cfg).apply(params, jnp.asarray(tokens),
                               jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(out), ref_h, atol=1e-4, rtol=1e-4)


def test_t5_encoder_matches_hf_long_buckets():
    """Sequence long enough to exercise the logarithmic distance buckets."""
    model, cfg = _hf_encoder("relu", seed=3)
    rng = np.random.default_rng(2)
    B, L = 2, 64
    tokens = rng.integers(0, cfg.vocab_size, (B, L))
    mask = np.ones((B, L), bool)
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(tokens)).last_hidden_state.numpy()
    params = convert_hf_t5_encoder(model.state_dict(), cfg)
    out = T5Encoder(cfg).apply(params, jnp.asarray(tokens))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4, rtol=1e-4)
