"""deepblast-convert-lm: pretrained-checkpoint conversion artifacts.

Golden layout test pins the exact Rostlab/prot_t5_xl_uniref50 HF
state-dict key/shape manifest (VERDICT r4 item 5: a future weight drop
must load first-try), and end-to-end tests run the CLI on synthetic torch
checkpoints (tiny geometry) through save → load → forward.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepblast_jax.models.convert import (
    bilm_key_shapes,
    convert_checkpoint,
    hf_t5_encoder_key_shapes,
    infer_t5_config,
    is_converted_lm,
    load_converted_lm,
    save_converted_lm,
    validate_hf_t5_state_dict,
)
from deepblast_jax.models.lm import BiLM, T5Config, T5Encoder


def test_rostlab_xl_manifest_golden():
    """Pin the exact key set and shapes of the Rostlab ProtT5-XL encoder
    state dict (T5-3B geometry, relu FF; reference wraps it at
    deepblast/language_model.py:21-47)."""
    ks = hf_t5_encoder_key_shapes(T5Config.prot_t5_xl())
    # 24 blocks x 8 keys (q k v o, 2 layer norms, wi wo) + rel-bias
    # + shared + final_ln
    assert len(ks) == 24 * 8 + 1 + 2
    assert ks["shared.weight"] == (128, 1024)
    assert ks["encoder.final_layer_norm.weight"] == (1024,)
    assert ks["encoder.block.0.layer.0.SelfAttention.q.weight"] == \
        (4096, 1024)
    assert ks["encoder.block.0.layer.0.SelfAttention.o.weight"] == \
        (1024, 4096)
    assert ks["encoder.block.0.layer.0.SelfAttention"
              ".relative_attention_bias.weight"] == (32, 32)
    assert ks["encoder.block.23.layer.1.DenseReluDense.wi.weight"] == \
        (16384, 1024)
    assert ks["encoder.block.23.layer.1.DenseReluDense.wo.weight"] == \
        (1024, 16384)
    # relu FF: no gated wi_0/wi_1 keys
    assert not any("wi_0" in k for k in ks)
    # parameter count of the full XL encoder (1,208M — PERF_NOTES r3)
    n = sum(int(np.prod(s)) for s in ks.values())
    assert n == 1_208_141_824, n


def _fake_sd(key_shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.02
            for k, s in key_shapes.items()}


def test_validate_and_infer_roundtrip():
    cfg = T5Config.tiny()
    sd = _fake_sd(hf_t5_encoder_key_shapes(cfg))
    missing, mismatched, extra = validate_hf_t5_state_dict(sd, cfg)
    assert not missing and not mismatched and not extra
    inf = infer_t5_config(sd)
    for f in ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
              "num_heads", "feed_forward_proj"):
        assert getattr(inf, f) == getattr(cfg, f), f
    # a truncated dict is caught
    sd2 = dict(sd)
    sd2.pop("encoder.final_layer_norm.weight")
    missing, _, _ = validate_hf_t5_state_dict(sd2, cfg)
    assert missing == ["encoder.final_layer_norm.weight"]
    # a mis-shaped weight is caught
    sd3 = dict(sd)
    sd3["shared.weight"] = sd3["shared.weight"][:, :-1]
    _, mismatched, _ = validate_hf_t5_state_dict(sd3, cfg)
    assert mismatched and mismatched[0][0] == "shared.weight"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_t5_end_to_end(tmp_path, dtype):
    """torch checkpoint file -> CLI -> artifact -> load -> forward."""
    torch = pytest.importorskip("torch")
    cfg = T5Config.tiny()
    sd = {k: torch.tensor(v) for k, v in
          _fake_sd(hf_t5_encoder_key_shapes(cfg)).items()}
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(sd, ckpt)

    from deepblast_jax.cli.convert_lm import main
    out = tmp_path / "artifact"
    args = [str(ckpt), "--output", str(out)]
    if dtype == "bfloat16":
        args += ["--dtype", "bfloat16"]
    assert main(args) == 0
    assert (out / "manifest.json").exists() and (out / "params.npz").exists()
    with open(out / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["kind"] == "prot_t5"
    assert manifest["config"]["num_layers"] == cfg.num_layers
    assert manifest["storage_dtype"] == dtype

    model, params = load_converted_lm(str(out))
    assert isinstance(model, T5Encoder)
    tokens = jnp.zeros((2, 8), jnp.int32)
    mask = jnp.ones((2, 8), bool)
    h = model.apply(jax.tree_util.tree_map(jnp.asarray, params),
                    tokens, mask)
    assert h.shape == (2, 8, cfg.d_model)
    assert np.isfinite(np.asarray(h, np.float32)).all()


def test_convert_bilstm_end_to_end(tmp_path):
    torch = pytest.importorskip("torch")
    ks = bilm_key_shapes(nin=22, nout=21, embedding_dim=21, hidden_dim=16,
                         num_layers=2)
    sd = {k: torch.tensor(v) for k, v in _fake_sd(ks, seed=3).items()}
    ckpt = tmp_path / "lstm2x.pt"
    torch.save(sd, ckpt)

    from deepblast_jax.cli.convert_lm import main
    out = tmp_path / "bilm"
    assert main([str(ckpt), "--output", str(out), "--kind", "bilstm"]) == 0
    model, params = load_converted_lm(str(out))
    assert isinstance(model, BiLM)
    assert model.hidden_dim == 16 and model.num_layers == 2
    tokens = jnp.zeros((2, 6), jnp.int32)
    h = model.apply(jax.tree_util.tree_map(jnp.asarray, params), tokens,
                    method=BiLM.encode)
    assert h.shape == (2, 6, model.hidden_size)


def test_build_model_accepts_artifact(tmp_path):
    """cli.common.build_model consumes a converted artifact (torch-free
    load path) and sizes the aligner from it."""
    torch = pytest.importorskip("torch")
    ks = bilm_key_shapes(nin=22, nout=21, embedding_dim=21, hidden_dim=8,
                         num_layers=2)
    sd = {k: torch.tensor(v) for k, v in _fake_sd(ks, seed=5).items()}
    ckpt = tmp_path / "lstm2x.pt"
    torch.save(sd, ckpt)
    out = tmp_path / "bilm"
    convert_checkpoint(str(ckpt), str(out), kind="bilstm")

    from deepblast_jax.cli.common import build_model
    from deepblast_jax.train.trainer import DeepBLASTConfig
    config = DeepBLASTConfig(lm_type="bilstm", embedding_dim=999,
                             vocab_size=22)
    model = build_model(config, pretrain_path=str(out))
    # embedding_dim corrected from the artifact (2 * 2 layers * 8 hidden)
    assert model.config.embedding_dim == 32
    state = model.init(sample_len=8)
    assert state.lm_params is not None


def test_detect_kind_errors():
    from deepblast_jax.models.convert import detect_kind
    with pytest.raises(ValueError):
        detect_kind({"some.other.key": np.zeros(3)})


def _rewrite_format(directory, tag):
    path = os.path.join(directory, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["format"] = tag
    with open(path, "w") as f:
        json.dump(manifest, f)


# "deepblast-legacy-lm/1" stands for the tag written under the package's
# former name: the same layout with another package name in the tag
@pytest.mark.parametrize("tag", ["deepblast-jax-lm/1",
                                 "deepblast-legacy-lm/1"])
def test_artifact_format_tags_load(tmp_path, tag):
    """An artifact loads (torch-free) whatever package name its tag
    carries, as long as the layout version is 1."""
    cfg = T5Config.tiny()
    params = T5Encoder(cfg).init(jax.random.key(0))
    out = str(tmp_path / "t5")
    save_converted_lm(out, "prot_t5", params, {
        k: getattr(cfg, k) for k in ("vocab_size", "d_model", "d_kv",
                                     "d_ff", "num_layers", "num_heads")})
    _rewrite_format(out, tag)
    assert is_converted_lm(out)
    model, loaded = load_converted_lm(out)
    assert isinstance(model, T5Encoder)
    want = jax.tree_util.tree_leaves(params)
    got = jax.tree_util.tree_leaves(loaded)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("tag", ["deepblast-jax-lm/2", "other-lm/1", None])
def test_artifact_format_tags_rejected(tmp_path, tag):
    """Another layout version or a foreign manifest is not an artifact:
    is_converted_lm says so, and load_converted_lm refuses it."""
    cfg = T5Config.tiny()
    out = str(tmp_path / "t5")
    save_converted_lm(out, "prot_t5",
                      T5Encoder(cfg).init(jax.random.key(0)),
                      {"vocab_size": cfg.vocab_size})
    _rewrite_format(out, tag)
    assert not is_converted_lm(out)
    with pytest.raises(ValueError):
        load_converted_lm(out)
