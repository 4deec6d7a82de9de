"""Protein language models (reference: deepblast/language_model.py).

Two LM families, both plain JAX (:mod:`deepblast_jax.models.module`; no
torch at training or inference time):

* :class:`BiLM` — the Bepler et al. 2019 two-layer tied bidirectional LSTM LM
  (reference: deepblast/language_model.py:50-272).  ``encode`` concatenates
  the hidden states of every layer in both directions, with the one-position
  shift of the reference so position ``i``'s features exclude token ``i``.

* :class:`T5Encoder` — a from-scratch T5 encoder stack (RMSNorm, relative
  position buckets, relu/gated FF) covering ProtT5
  (reference: deepblast/language_model.py:21-47 wraps the HF torch
  ``T5EncoderModel``).  :func:`convert_hf_t5_encoder` maps a HuggingFace
  PyTorch checkpoint's state dict onto the parameter tree, so
  Rostlab/prot_t5_xl_uniref50 weights load without torch at inference time.

The registry mirrors ``pretrained_language_models``
(reference: deepblast/language_model.py:16-18).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from deepblast_jax.models.module import (
    Module,
    dense,
    init_dense,
    init_embed,
    init_lstm,
    rnn,
)


# ---------------------------------------------------------------------------
# BiLM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BiLM(Module):
    """Tied bidirectional stacked-LSTM language model.

    Parameters: ``embed/embedding``, ``lstm{i}/cell/{ii..io,hi..ho}`` (the
    same cell runs both directions) and ``linear``."""

    nin: int = 22              # alphabet + start/stop (mask) token
    nout: int = 21
    embedding_dim: int = 21
    hidden_dim: int = 1024
    num_layers: int = 2
    dropout: float = 0.0

    @property
    def hidden_size(self):
        return 2 * self.num_layers * self.hidden_dim

    def init_params(self, rng, tokens=None, lengths=None):
        keys = jax.random.split(rng, self.num_layers + 2)
        p = {"embed": init_embed(keys[0], self.nin, self.embedding_dim)}
        n_in = self.embedding_dim
        for i in range(self.num_layers):
            p[f"lstm{i}"] = {"cell": init_lstm(keys[i + 1], n_in,
                                               self.hidden_dim)}
            n_in = self.hidden_dim
        p["linear"] = init_dense(keys[-1], self.hidden_dim, self.nout)
        return p

    def _directional(self, p, inputs, lengths, reverse):
        """Run the stacked cells over ``inputs``; returns per-layer states."""
        outs = []
        h = inputs
        for i in range(self.num_layers):
            h = rnn(p[f"lstm{i}"], h, lengths, reverse=reverse)
            outs.append(h)
        return outs

    def _split_inputs(self, p, tokens, lengths):
        """Build the shifted forward/reverse input streams.

        Tokens are the raw alphabet codes; the start/stop flank token is the
        embedding index ``nin - 1`` (reference mask_idx,
        deepblast/language_model.py:55-57).
        """
        B, L = tokens.shape
        table = p["embed"]["embedding"]
        e = table[tokens]
        flank = table[jnp.full((B, 1), self.nin - 1, tokens.dtype)]
        # forward stream: position i sees [start, x_1 .. x_{i-1}]
        fwd_in = jnp.concatenate([flank, e[:, :-1]], axis=1)
        # reverse stream: position i sees [x_{i+1} .. x_L, stop]
        pos = jnp.arange(L)[None, :]
        shifted = jnp.concatenate([e[:, 1:], jnp.zeros_like(e[:, :1])], axis=1)
        is_last = (pos == (lengths[:, None] - 1))[..., None]
        rvs_in = jnp.where(is_last, flank, shifted)
        return fwd_in, rvs_in

    def encode(self, p, tokens, lengths=None):
        """Context embeddings ``(B, L, 2 * num_layers * hidden_dim)``."""
        B, L = tokens.shape
        if lengths is None:
            lengths = jnp.full((B,), L, jnp.int32)
        fwd_in, rvs_in = self._split_inputs(p, tokens, lengths)
        h_fwd = self._directional(p, fwd_in, lengths, reverse=False)
        h_rvs = self._directional(p, rvs_in, lengths, reverse=True)
        feats = []
        for f, r in zip(h_fwd, h_rvs):
            feats.extend([f, r])
        return jnp.concatenate(feats, axis=-1)

    def __call__(self, p, tokens, lengths=None):
        """Bidirectional next/prev-token log probabilities ``(B, L, nout)``
        (reference: deepblast/language_model.py:231-272)."""
        B, L = tokens.shape
        if lengths is None:
            lengths = jnp.full((B,), L, jnp.int32)
        fwd_in, rvs_in = self._split_inputs(p, tokens, lengths)
        h_fwd = self._directional(p, fwd_in, lengths, reverse=False)[-1]
        h_rvs = self._directional(p, rvs_in, lengths, reverse=True)[-1]
        logp = dense(p["linear"], h_fwd) + dense(p["linear"], h_rvs)
        return jax.nn.log_softmax(logp, axis=-1)


def convert_bepler_bilm(state_dict, *, num_layers=2):
    """Map a Bepler et al. 2019 tied-BiLM torch checkpoint (the reference
    registry's ``lstm2x.pt`` layout: ``embed.weight``,
    ``rnn.{i}.{weight,bias}_{ih,hh}_l0``, ``linear.{weight,bias}`` —
    reference: deepblast/language_model.py:50-85) onto the :class:`BiLM`
    parameter tree.

    Torch fuses the four LSTM gates row-wise in (input, forget, cell,
    output) order and carries two bias vectors; the tree keeps one dense
    per gate with the bias on the hidden-side dense, so each torch gate chunk
    transposes into a ``(in, H)`` kernel and the two bias chunks sum.
    """

    def g(key):
        v = state_dict[key]
        return np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v)

    gates = ("i", "f", "g", "o")
    p = {"embed": {"embedding": g("embed.weight")},
         "linear": {"kernel": g("linear.weight").T,
                    "bias": g("linear.bias")}}
    for i in range(num_layers):
        w_ih = g(f"rnn.{i}.weight_ih_l0")
        w_hh = g(f"rnn.{i}.weight_hh_l0")
        b = g(f"rnn.{i}.bias_ih_l0") + g(f"rnn.{i}.bias_hh_l0")
        H = w_hh.shape[1]
        cell = {}
        for n, gate in enumerate(gates):
            rows = slice(n * H, (n + 1) * H)
            cell[f"i{gate}"] = {"kernel": w_ih[rows].T}
            cell[f"h{gate}"] = {"kernel": w_hh[rows].T, "bias": b[rows]}
        p[f"lstm{i}"] = {"cell": cell}
    return {"params": p}


def load_bilm(path, **kw):
    """Load a pretrained tied BiLM from a torch checkpoint file
    (reference: deepblast/language_model.py:16-18 ``lstm2x.pt``)."""
    import torch  # host-side, offline conversion only
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):           # whole-module pickles
        sd = sd.state_dict()
    H = sd["rnn.0.weight_hh_l0"].shape[1]
    nin, emb = sd["embed.weight"].shape
    nout = sd["linear.weight"].shape[0]
    nl = len({k.split(".")[1] for k in sd if k.startswith("rnn.")})
    model = BiLM(nin=nin, nout=nout, embedding_dim=emb, hidden_dim=H,
                 num_layers=nl, **kw)
    return model, convert_bepler_bilm(sd, num_layers=nl)


@dataclasses.dataclass(frozen=True)
class TokenEmbed(Module):
    """Plain learned token embedding — the LM-free debug/minimal path
    (stands in for a frozen LM in tests and small-scale runs)."""

    vocab: int
    dim: int

    def init_params(self, rng, tokens=None, lengths=None):
        return {"Embed_0": init_embed(rng, self.vocab, self.dim)}

    def __call__(self, p, tokens, lengths=None):
        return p["Embed_0"]["embedding"][tokens]


# ---------------------------------------------------------------------------
# T5 encoder (ProtT5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 128
    d_model: int = 1024
    d_kv: int = 128
    d_ff: int = 16384
    num_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"   # "relu" | "gated-gelu"
    dtype: jnp.dtype = jnp.float32

    @classmethod
    def prot_t5_xl(cls, **kw):
        """Rostlab/prot_t5_xl_uniref50 encoder geometry."""
        return cls(vocab_size=128, d_model=1024, d_kv=128, d_ff=16384,
                   num_layers=24, num_heads=32, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        return cls(vocab_size=32, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4, **kw)


def rms_norm(p, x, eps):
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    return (x * jax.lax.rsqrt(var + eps)).astype(x.dtype) * p["weight"]


def relative_position_bucket(rel_pos, num_buckets=32, max_distance=128):
    """T5's bidirectional relative-position bucketing."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(jnp.int32) * num_buckets
    n = jnp.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        jnp.log(n.astype(jnp.float32) / max_exact + 1e-6)
        / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(jnp.int32)
    val_if_large = jnp.minimum(val_if_large, num_buckets - 1)
    return ret + jnp.where(is_small, n, val_if_large)


def t5_attention(p, x, mask, cfg, position_bias=None):
    """Self-attention of one T5 block; block 0 owns the relative-position
    bias table and computes ``position_bias`` for all blocks."""
    inner = cfg.num_heads * cfg.d_kv
    B, L, _ = x.shape
    shape = (B, L, cfg.num_heads, cfg.d_kv)
    q = dense(p["q"], x, cfg.dtype).reshape(shape)
    k = dense(p["k"], x, cfg.dtype).reshape(shape)
    v = dense(p["v"], x, cfg.dtype).reshape(shape)
    # NOTE: T5 does not scale q by sqrt(d_kv)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    if "relative_attention_bias" in p:
        rel = (jnp.arange(L)[None, :] - jnp.arange(L)[:, None])
        buckets = relative_position_bucket(
            rel, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        position_bias = jnp.transpose(
            p["relative_attention_bias"][buckets], (2, 0, 1))[None]
    if position_bias is not None:
        scores = scores + position_bias
    if mask is not None:
        neg = jnp.finfo(jnp.float32).min
        scores = jnp.where(mask[:, None, None, :], scores, neg)
    probs = jax.nn.softmax(scores, axis=-1).astype(cfg.dtype)
    out = jnp.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(B, L, inner)
    return dense(p["o"], out, cfg.dtype), position_bias


def t5_ff(p, x, cfg):
    if cfg.feed_forward_proj == "gated-gelu":
        h = (jax.nn.gelu(dense(p["wi_0"], x, cfg.dtype))
             * dense(p["wi_1"], x, cfg.dtype))
    else:
        h = jax.nn.relu(dense(p["wi"], x, cfg.dtype))
    return dense(p["wo"], h, cfg.dtype)


def t5_block(p, x, mask, cfg, position_bias=None):
    h = rms_norm(p["ln_attn"], x, cfg.layer_norm_epsilon)
    attn, position_bias = t5_attention(p["attn"], h, mask, cfg,
                                       position_bias)
    x = x + attn
    h = rms_norm(p["ln_ff"], x, cfg.layer_norm_epsilon)
    return x + t5_ff(p["ff"], h, cfg), position_bias


@dataclasses.dataclass(frozen=True)
class T5Encoder(Module):
    """ProtT5-class encoder producing residue embeddings ``(B, L, d_model)``.

    Replacement for the wrapped HF ``T5EncoderModel``
    (reference: deepblast/language_model.py:21-47).  Parameters:
    ``embed/embedding``, ``block{i}/{ln_attn,attn/{q,k,v,o},ln_ff,ff}``
    (``attn/relative_attention_bias`` in block 0) and ``ln_final``.
    """

    cfg: T5Config

    def init_params(self, rng, tokens=None, mask=None):
        cfg = self.cfg
        inner = cfg.num_heads * cfg.d_kv
        keys = jax.random.split(rng, cfg.num_layers + 1)

        def ones():  # a buffer per leaf: the train step donates the state
            return {"weight": jnp.ones((cfg.d_model,), jnp.float32)}

        def lin(key, n_in, n_out):
            return init_dense(key, n_in, n_out, use_bias=False)

        p = {"embed": init_embed(keys[0], cfg.vocab_size, cfg.d_model)}
        for i in range(cfg.num_layers):
            kq, kk, kv, ko, kb, k0, k1, k2 = jax.random.split(keys[i + 1], 8)
            attn = {"q": lin(kq, cfg.d_model, inner),
                    "k": lin(kk, cfg.d_model, inner),
                    "v": lin(kv, cfg.d_model, inner),
                    "o": lin(ko, inner, cfg.d_model)}
            if i == 0:
                attn["relative_attention_bias"] = 0.02 * jax.random.normal(
                    kb, (cfg.relative_attention_num_buckets, cfg.num_heads))
            if cfg.feed_forward_proj == "gated-gelu":
                ff = {"wi_0": lin(k0, cfg.d_model, cfg.d_ff),
                      "wi_1": lin(k1, cfg.d_model, cfg.d_ff),
                      "wo": lin(k2, cfg.d_ff, cfg.d_model)}
            else:
                ff = {"wi": lin(k0, cfg.d_model, cfg.d_ff),
                      "wo": lin(k2, cfg.d_ff, cfg.d_model)}
            p[f"block{i}"] = {"ln_attn": ones(), "attn": attn,
                              "ln_ff": ones(), "ff": ff}
        p["ln_final"] = ones()
        return p

    def __call__(self, p, tokens, mask=None):
        cfg = self.cfg
        if mask is None:
            mask = jnp.ones(tokens.shape, bool)
        else:
            mask = mask.astype(bool)
        x = p["embed"]["embedding"].astype(cfg.dtype)[tokens]
        position_bias = None
        for i in range(cfg.num_layers):
            x, position_bias = t5_block(p[f"block{i}"], x, mask, cfg,
                                        position_bias)
        x = rms_norm(p["ln_final"], x, cfg.layer_norm_epsilon)
        return x * mask[..., None]


def convert_hf_t5_encoder(state_dict, cfg: T5Config):
    """Map a HuggingFace PyTorch ``T5EncoderModel`` state dict onto the
    :class:`T5Encoder` parameter tree (numpy arrays in, pytree out)."""

    def g(key):
        v = state_dict[key]
        return np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v)

    def lin(key):
        return {"kernel": g(key).T}

    p = {"embed": {"embedding": g("shared.weight")},
         "ln_final": {"weight": g("encoder.final_layer_norm.weight")}}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        attn = {
            "q": lin(f"{pre}.0.SelfAttention.q.weight"),
            "k": lin(f"{pre}.0.SelfAttention.k.weight"),
            "v": lin(f"{pre}.0.SelfAttention.v.weight"),
            "o": lin(f"{pre}.0.SelfAttention.o.weight"),
        }
        if i == 0:
            attn["relative_attention_bias"] = g(
                f"{pre}.0.SelfAttention.relative_attention_bias.weight")
        if cfg.feed_forward_proj == "gated-gelu":
            ff = {"wi_0": lin(f"{pre}.1.DenseReluDense.wi_0.weight"),
                  "wi_1": lin(f"{pre}.1.DenseReluDense.wi_1.weight"),
                  "wo": lin(f"{pre}.1.DenseReluDense.wo.weight")}
        else:
            ff = {"wi": lin(f"{pre}.1.DenseReluDense.wi.weight"),
                  "wo": lin(f"{pre}.1.DenseReluDense.wo.weight")}
        p[f"block{i}"] = {
            "ln_attn": {"weight": g(f"{pre}.0.layer_norm.weight")},
            "attn": attn,
            "ln_ff": {"weight": g(f"{pre}.1.layer_norm.weight")},
            "ff": ff,
        }
    return {"params": p}


def load_prot_t5(path, cfg: Optional[T5Config] = None):
    """Load a ProtT5 encoder from a local HF checkpoint directory or a
    ``pytorch_model.bin`` file.  Requires torch only at conversion time."""
    import os
    cfg = cfg or T5Config.prot_t5_xl()
    import torch  # local import: conversion is a host-side, offline step
    f = path
    if os.path.isdir(path):
        f = os.path.join(path, "pytorch_model.bin")
    sd = torch.load(f, map_location="cpu", weights_only=True)
    return T5Encoder(cfg), convert_hf_t5_encoder(sd, cfg)


#: Mirrors the reference registry (deepblast/language_model.py:16-18).
pretrained_language_models = {
    "bilstm": BiLM,
    "prot_t5_xl": T5Config.prot_t5_xl,
}
