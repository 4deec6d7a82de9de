"""Pretrained-LM conversion artifacts (VERDICT r4 item 5).

The reference's end-user story is "download checkpoint → load → align"
(reference: deepblast/utils.py:12-65 ``load_model``,
deepblast/language_model.py:16-18 registry).  This module gives the
converters in :mod:`deepblast_jax.models.lm` a user-facing artifact
format:

* :func:`hf_t5_encoder_key_shapes` — the exact key → shape manifest a
  HuggingFace ``T5EncoderModel`` state dict must carry for
  ``convert_hf_t5_encoder`` to load it (pinned for Rostlab XL by
  tests/test_convert_lm.py, so a future weight drop loads first-try).
* :func:`validate_hf_t5_state_dict` / :func:`infer_t5_config` — check a
  downloaded state dict against the manifest / recover the geometry.
* :func:`save_converted_lm` / :func:`load_converted_lm` — the on-disk
  artifact: a flat ``.npz`` of the parameter tree plus a
  ``manifest.json`` (kind, geometry, parameter count) that
  ``deepblast-train --lm <dir>`` and ``utils-style`` loaders consume
  without torch.

CLI wrapper: :mod:`deepblast_jax.cli.convert_lm` (``deepblast-convert-lm``).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from deepblast_jax.models.lm import (
    BiLM, T5Config, T5Encoder,
    convert_bepler_bilm, convert_hf_t5_encoder,
)

MANIFEST_FORMAT = "deepblast-jax-lm/1"
# The tag names the package that wrote the artifact, and the package was
# renamed; the layout is versioned by the "/1" suffix alone, so artifacts
# written under the former name load unchanged.
_FORMAT_RE = re.compile(r"deepblast-[a-z0-9_]+-lm/1")


def _known_format(manifest):
    fmt = manifest.get("format")
    return isinstance(fmt, str) and _FORMAT_RE.fullmatch(fmt) is not None

__all__ = [
    "hf_t5_encoder_key_shapes",
    "infer_t5_config",
    "validate_hf_t5_state_dict",
    "bilm_key_shapes",
    "save_converted_lm",
    "load_converted_lm",
    "convert_checkpoint",
]


# ---------------------------------------------------------------------------
# Expected HF T5 encoder layout
# ---------------------------------------------------------------------------

def hf_t5_encoder_key_shapes(cfg: T5Config):
    """Key → shape manifest of the HF ``T5EncoderModel`` state-dict keys
    :func:`convert_hf_t5_encoder` reads (torch convention: ``Linear``
    weights are ``(out, in)``).  Rostlab/prot_t5_xl_uniref50 ==
    ``T5Config.prot_t5_xl()`` (T5-3B geometry, relu FF)."""
    inner = cfg.num_heads * cfg.d_kv
    ks = {
        "shared.weight": (cfg.vocab_size, cfg.d_model),
        "encoder.final_layer_norm.weight": (cfg.d_model,),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        ks[f"{pre}.0.SelfAttention.q.weight"] = (inner, cfg.d_model)
        ks[f"{pre}.0.SelfAttention.k.weight"] = (inner, cfg.d_model)
        ks[f"{pre}.0.SelfAttention.v.weight"] = (inner, cfg.d_model)
        ks[f"{pre}.0.SelfAttention.o.weight"] = (cfg.d_model, inner)
        ks[f"{pre}.0.layer_norm.weight"] = (cfg.d_model,)
        ks[f"{pre}.1.layer_norm.weight"] = (cfg.d_model,)
        if cfg.feed_forward_proj == "gated-gelu":
            ks[f"{pre}.1.DenseReluDense.wi_0.weight"] = (cfg.d_ff,
                                                         cfg.d_model)
            ks[f"{pre}.1.DenseReluDense.wi_1.weight"] = (cfg.d_ff,
                                                         cfg.d_model)
        else:
            ks[f"{pre}.1.DenseReluDense.wi.weight"] = (cfg.d_ff,
                                                       cfg.d_model)
        ks[f"{pre}.1.DenseReluDense.wo.weight"] = (cfg.d_model, cfg.d_ff)
        if i == 0:
            ks[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = (
                cfg.relative_attention_num_buckets, cfg.num_heads)
    return ks


def _shape(v):
    return tuple(v.shape)


def infer_t5_config(sd) -> T5Config:
    """Recover the encoder geometry from a HF state dict."""
    vocab, d_model = _shape(sd["shared.weight"])
    layers = set()
    gated = False
    for k in sd:
        if k.startswith("encoder.block."):
            layers.add(int(k.split(".")[2]))
        if "DenseReluDense.wi_0" in k:
            gated = True
    n_layers = max(layers) + 1
    inner = _shape(sd["encoder.block.0.layer.0.SelfAttention.q.weight"])[0]
    rb = sd["encoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight"]
    num_buckets, num_heads = _shape(rb)
    wi = ("encoder.block.0.layer.1.DenseReluDense.wi_0.weight" if gated
          else "encoder.block.0.layer.1.DenseReluDense.wi.weight")
    d_ff = _shape(sd[wi])[0]
    return T5Config(
        vocab_size=vocab, d_model=d_model, d_kv=inner // num_heads,
        d_ff=d_ff, num_layers=n_layers, num_heads=num_heads,
        relative_attention_num_buckets=num_buckets,
        feed_forward_proj="gated-gelu" if gated else "relu")


def validate_hf_t5_state_dict(sd, cfg: T5Config):
    """Check every required key exists with the expected shape.  Returns
    (missing, mismatched, extra) — extra keys (decoder weights,
    ``encoder.embed_tokens.weight`` tied alias, lm_head) are harmless
    and ignored by the converter."""
    expect = hf_t5_encoder_key_shapes(cfg)
    missing = [k for k in expect if k not in sd]
    mismatched = [(k, _shape(sd[k]), expect[k]) for k in expect
                  if k in sd and _shape(sd[k]) != expect[k]]
    extra = [k for k in sd if k not in expect]
    return missing, mismatched, extra


def bilm_key_shapes(nin=22, nout=21, embedding_dim=21, hidden_dim=1024,
                    num_layers=2):
    """Key → shape manifest of the Bepler ``lstm2x.pt`` layout
    (reference: deepblast/language_model.py:50-85)."""
    ks = {"embed.weight": (nin, embedding_dim),
          "linear.weight": (nout, hidden_dim),
          "linear.bias": (nout,)}
    for i in range(num_layers):
        nin_i = embedding_dim if i == 0 else hidden_dim
        ks[f"rnn.{i}.weight_ih_l0"] = (4 * hidden_dim, nin_i)
        ks[f"rnn.{i}.weight_hh_l0"] = (4 * hidden_dim, hidden_dim)
        ks[f"rnn.{i}.bias_ih_l0"] = (4 * hidden_dim,)
        ks[f"rnn.{i}.bias_hh_l0"] = (4 * hidden_dim,)
    return ks


# ---------------------------------------------------------------------------
# On-disk artifact
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_converted_lm(directory, kind, params, config, source=None,
                      dtype=None):
    """Write ``params.npz`` + ``manifest.json``.  ``config`` is a
    JSON-able dict of the model geometry (T5Config fields / BiLM dims).
    ``dtype`` optionally narrows storage (e.g. bfloat16 for the frozen
    serving path — stored via uint16 bit view since npz has no bf16)."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(params)
    if dtype is not None and str(dtype) not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported storage dtype {dtype!r} "
                         "(float32 or bfloat16)")
    bf16 = dtype is not None and str(dtype) == "bfloat16"
    stored = {}
    for k, v in flat.items():
        if bf16 and v.dtype in (np.float32, np.float64):
            import jax.numpy as jnp
            v = np.asarray(jnp.asarray(v, jnp.bfloat16).view(jnp.uint16))
            k = k + "::bf16"
        stored[k] = v
    np.savez(os.path.join(directory, "params.npz"), **stored)
    n_params = int(sum(v.size for v in flat.values()))
    manifest = {
        "format": MANIFEST_FORMAT,
        "kind": kind,
        "config": config,
        "n_params": n_params,
        "source": source,
        "storage_dtype": "bfloat16" if bf16 else "float32",
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_converted_lm(directory):
    """Rebuild ``(module, params)`` from a converted-LM directory."""
    import jax.numpy as jnp
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if not _known_format(manifest):
        raise ValueError(f"{directory} is not a deepblast-jax LM artifact")
    data = np.load(os.path.join(directory, "params.npz"))
    flat = {}
    for k in data.files:
        v = data[k]
        if k.endswith("::bf16"):
            flat[k[:-6]] = jnp.asarray(v).view(jnp.bfloat16)
        else:
            flat[k] = v
    params = _unflatten(flat)
    cfg = manifest["config"]
    if manifest["kind"] == "prot_t5":
        model = T5Encoder(T5Config(**{
            k: v for k, v in cfg.items()
            if k in T5Config.__dataclass_fields__}))
    elif manifest["kind"] == "bilstm":
        model = BiLM(nin=cfg["nin"], nout=cfg["nout"],
                     embedding_dim=cfg["embedding_dim"],
                     hidden_dim=cfg["hidden_dim"],
                     num_layers=cfg["num_layers"])
    else:
        raise ValueError(f"unknown LM kind {manifest['kind']!r}")
    return model, params


def is_converted_lm(path):
    """True only for THIS repo's LM artifacts: a raw HF snapshot can
    legitimately contain an unrelated manifest.json and must fall
    through to the HF/torch loaders, so the format line is checked."""
    mf = os.path.join(path, "manifest.json")
    if not (os.path.isdir(path) and os.path.exists(mf)):
        return False
    try:
        with open(mf) as f:
            return _known_format(json.load(f))
    except (OSError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Conversion driver (torch only here, host-side)
# ---------------------------------------------------------------------------

def _load_torch_sd(path):
    import torch  # host-side, conversion time only
    f = path
    if os.path.isdir(path):
        f = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(f):
            raise FileNotFoundError(
                f"{path} has no pytorch_model.bin — pass the checkpoint "
                "file directly")
    sd = torch.load(f, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):            # whole-module pickles
        sd = sd.state_dict()
    return {k: v for k, v in sd.items()}, f


def detect_kind(sd):
    if any(k.startswith("encoder.block.") for k in sd):
        return "prot_t5"
    if any(k.startswith("rnn.") for k in sd):
        return "bilstm"
    raise ValueError(
        "unrecognised checkpoint layout: expected HF T5EncoderModel keys "
        "(encoder.block.*) or Bepler BiLM keys (rnn.*)")


def convert_checkpoint(checkpoint, output, kind="auto", dtype=None,
                       strict=True):
    """Convert a downloaded pretrained checkpoint into this repo's LM
    artifact.  Returns the manifest dict."""
    sd, source = _load_torch_sd(checkpoint)
    if kind == "auto":
        kind = detect_kind(sd)
    if kind == "prot_t5":
        cfg = infer_t5_config(sd)
        missing, mismatched, _ = validate_hf_t5_state_dict(sd, cfg)
        if missing or mismatched:
            msg = (f"state dict does not match the expected HF T5 encoder "
                   f"layout: missing={missing[:5]} "
                   f"mismatched={mismatched[:5]}")
            if strict:
                raise ValueError(msg)
            print(f"WARNING: {msg}")
        params = convert_hf_t5_encoder(sd, cfg)
        config = {k: getattr(cfg, k) for k in (
            "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
            "num_heads", "relative_attention_num_buckets",
            "relative_attention_max_distance", "feed_forward_proj")}
    elif kind == "bilstm":
        H = np.asarray(sd["rnn.0.weight_hh_l0"]).shape[1]
        nin, emb = np.asarray(sd["embed.weight"]).shape
        nout = np.asarray(sd["linear.weight"]).shape[0]
        nl = len({k.split(".")[1] for k in sd if k.startswith("rnn.")})
        params = convert_bepler_bilm(sd, num_layers=nl)
        config = {"nin": int(nin), "nout": int(nout),
                  "embedding_dim": int(emb), "hidden_dim": int(H),
                  "num_layers": int(nl)}
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return save_converted_lm(output, kind, params, config,
                             source=os.path.abspath(source), dtype=dtype)
