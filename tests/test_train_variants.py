"""Trainer variants: BiLM and T5 language models, RNN heads, SW mode,
sparsemax operator, alternative losses — each trains a couple of steps on
the synthetic corpus."""

import numpy as np
import pytest

from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
from tests.test_train import fixture_frame


def _fit(cfg, n_rows=6, lm=None):
    ds = TMAlignDataset(fixture_frame(n_rows, min_len=8, max_len=16),
                        tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(cfg, lm=lm)
    state, history = model.fit(ds)
    assert np.isfinite(history[-1]["train_loss"])
    return model, state, history


BASE = dict(embedding_dim=16, hidden_dim=16, layers=2, vocab_size=32,
            batch_size=3, learning_rate=1e-2, epochs=2, scheduler="none",
            pad_multiple=8, dropout=0.0, max_len=64)


def test_bilstm_lm_trains():
    cfg = DeepBLASTConfig(lm_type="bilstm", **BASE)
    model, state, _ = _fit(cfg)
    s = model.align("ACDEFGHI", "ACDEFGHI", state)
    assert s.count(":") + s.count("1") == 8


def test_t5_lm_trains():
    from deepblast_jax.models import T5Config, T5Encoder
    cfg = DeepBLASTConfig(lm_type="prot_t5", **BASE)
    lm = T5Encoder(T5Config(vocab_size=32, d_model=16, d_kv=8, d_ff=32,
                            num_layers=2, num_heads=2))
    _fit(cfg, lm=lm)


def test_finetune_lm():
    cfg = DeepBLASTConfig(lm_type="embed", finetune=True, **BASE)
    model, state, _ = _fit(cfg)
    assert "lm" in state.params


def test_rnn_heads_train():
    cfg = DeepBLASTConfig(layer_type="rnn", **BASE)
    _fit(cfg)


def test_linear_head():
    cfg = DeepBLASTConfig(**{**BASE, "layers": 1})
    _fit(cfg)


def test_smith_waterman_mode():
    cfg = DeepBLASTConfig(alignment_mode="smith-waterman", **BASE)
    _fit(cfg)


def test_sparsemax_operator():
    cfg = DeepBLASTConfig(operator="sparsemax", **BASE)
    _fit(cfg)


@pytest.mark.parametrize("loss", ["sse", "path"])
def test_other_losses(loss):
    cfg = DeepBLASTConfig(loss=loss, **BASE)
    ds = TMAlignDataset(fixture_frame(6, min_len=8, max_len=16),
                        tokenizer=ProtT5Tokenizer(),
                        construct_paths=(loss == "path"))
    model = DeepBLAST(cfg)
    state, history = model.fit(ds)
    assert np.isfinite(history[-1]["train_loss"])


def test_grad_clip_and_accum():
    cfg = DeepBLASTConfig(grad_clip=1.0, grad_accum=2, **BASE)
    _fit(cfg)


def test_validation_logging(tmp_path):
    from deepblast_jax.utils.logging import MetricsLogger
    cfg = DeepBLASTConfig(visualization_fraction=1.0, **BASE)
    ds = TMAlignDataset(fixture_frame(6, min_len=8, max_len=16),
                        tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(cfg)
    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    state, history = model.fit(ds, ds, logger=logger)
    assert "val_perc_id" in history[-1]
    assert 0.0 <= history[-1]["val_perc_id"] <= 1.0


def test_triton_backend_trains_like_scan():
    """The Triton DP kernels (interpreted here) train step for step like the
    scan oracle, and decode the same alignment."""
    hist = {}
    for backend in ("scan", "triton"):
        cfg = DeepBLASTConfig(backend=backend, **{**BASE, "epochs": 1})
        model, state, hist[backend] = _fit(cfg)
        hist[backend + "_aln"] = model.align("ACDEFGHIK", "ACDFGHIK", state)
    np.testing.assert_allclose(hist["triton"][-1]["train_loss"],
                               hist["scan"][-1]["train_loss"], rtol=1e-6)
    assert hist["triton_aln"] == hist["scan_aln"]


def test_storage_menu_keys_in_old_configs_load():
    """config.json files written before the fp32-only DP still carry the
    removed storage-menu keys; from_json drops them."""
    import dataclasses
    import json
    d = dataclasses.asdict(DeepBLASTConfig(**BASE))
    d.update(dp_bf16_residuals="auto", dp_i16_streams=False,
             dp_decode_menu="fast")
    cfg = DeepBLASTConfig.from_json(json.dumps(d))
    assert cfg == DeepBLASTConfig(**BASE)
