"""Match/gap embedding heads (reference: deepblast/embedding.py).

Plain-JAX re-designs of the reference's PackedSequence-aware torch modules
(:mod:`deepblast_jax.models.module`).  All heads map padded LM embeddings
``(B, L, D)`` to head features ``(B, L, F)`` (static shapes with length
masks instead of PackedSequence plumbing,
reference: deepblast/dataset/utils.py:214-251).

Heads that mix neighbouring positions (conv stacks, reverse RNNs) take
``lengths`` and mask padding so features at *true* positions are invariant
to pad width and pad content — without this, the last ``layers*(k-1)/2``
positions of every sequence change with batch composition and length
bucketing (the reference has this leak: its StackedCNN convolves the padded
batch buffer, deepblast/embedding.py:152-168; fixed here, test-covered by
tests/test_cli.py::test_search_cli_bucket_parity).  Feature values at pad
positions are still garbage; downstream DP consumers mask by length.

Note the reference's argument-shift quirk: ``DeepBLAST`` passes positional
args so that the ``--layers`` hyper-parameter lands in ``StackedCNN``'s
``k_size`` while the depth stays 2 (reference: deepblast/trainer.py:74-77 vs
deepblast/alignment.py:15,57-60 and deepblast/embedding.py:130).  Here depth
and kernel width are independent, honestly-named fields; the config layer
maps reference flag sets onto them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from deepblast_jax.models.module import (
    Module,
    conv1d,
    dense,
    dropout,
    init_conv1d,
    init_dense,
    init_gru,
    init_lstm,
    rnn,
)


def _length_mask(x, lengths):
    """(B, L, 1) mask of true positions, or None when lengths is None."""
    if lengths is None:
        return None
    L = x.shape[-2]
    return (jnp.arange(L)[None, :] < lengths[:, None])[..., None] \
        .astype(x.dtype)


def _dropout_rng(rngs):
    return None if rngs is None else rngs.get("dropout")


@dataclasses.dataclass(frozen=True)
class StackedCNN(Module):
    """Linear embed -> n x [Conv1d(k, same) + ReLU] -> dropout
    (reference: deepblast/embedding.py:129-169).

    With ``lengths``, pad positions are zeroed before every conv so each
    conv's boundary reads zeros regardless of buffer width — identical to
    what 'SAME' padding supplies past the buffer edge, hence features at
    true positions are pad-invariant."""

    features: int
    layers: int = 2
    k_size: int = 5
    dropout: float = 0.0

    def init_params(self, rng, x, lengths=None, deterministic=True):
        D = x.shape[-1]
        keys = jax.random.split(rng, self.layers + 1)
        p = {"embed": init_dense(keys[0], D, D)}
        n_in = D
        for i in range(self.layers):
            p[f"conv{i}"] = init_conv1d(keys[i + 1], self.k_size, n_in,
                                        self.features)
            n_in = self.features
        return p

    def __call__(self, p, x, lengths=None, deterministic=True, rngs=None):
        mask = _length_mask(x, lengths)
        h = dense(p["embed"], x)
        for i in range(self.layers):
            if mask is not None:
                h = h * mask
            h = jax.nn.relu(conv1d(p[f"conv{i}"], h))
        return dropout(h, self.dropout, _dropout_rng(rngs), deterministic)


@dataclasses.dataclass(frozen=True)
class StackedRNN(Module):
    """Linear embed -> stacked bidirectional LSTM/GRU -> dropout -> proj
    (reference: deepblast/embedding.py:85-126)."""

    hidden: int
    features: int
    layers: int = 2
    dropout: float = 0.0
    rnn_type: str = "lstm"

    def init_params(self, rng, x, lengths=None, deterministic=True):
        D = x.shape[-1]
        cell = {"lstm": init_lstm, "gru": init_gru}[self.rnn_type]
        keys = jax.random.split(rng, 2 * self.layers + 2)
        p = {"embed": init_dense(keys[0], D, D)}
        n_in = D
        for i in range(self.layers):
            p[f"fwd{i}"] = {"cell": cell(keys[2 * i + 1], n_in, self.hidden)}
            p[f"bwd{i}"] = {"cell": cell(keys[2 * i + 2], n_in, self.hidden)}
            n_in = 2 * self.hidden
        p["proj"] = init_dense(keys[-1], n_in, self.features)
        return p

    def __call__(self, p, x, lengths=None, deterministic=True, rngs=None):
        h = dense(p["embed"], x)
        for i in range(self.layers):
            hf = rnn(p[f"fwd{i}"], h, lengths, cell=self.rnn_type)
            hb = rnn(p[f"bwd{i}"], h, lengths, reverse=True,
                     cell=self.rnn_type)
            h = jnp.concatenate([hf, hb], axis=-1)
        h = dropout(h, self.dropout, _dropout_rng(rngs), deterministic)
        return dense(p["proj"], h)


@dataclasses.dataclass(frozen=True)
class LinearHead(Module):
    """Single linear head, the ``n_layers == 1`` branch of the reference
    aligner (reference: deepblast/alignment.py:63-65).  Position-local, so
    ``lengths`` is accepted for interface parity and ignored."""

    features: int

    def init_params(self, rng, x, lengths=None, deterministic=True):
        return {"Dense_0": init_dense(rng, x.shape[-1], self.features)}

    def __call__(self, p, x, lengths=None, deterministic=True, rngs=None):
        return dense(p["Dense_0"], x)


def build_head(layer_type: str, *, embedding_dim: int, hidden_dim: int,
               layers: int, k_size: int = 5, dropout: float = 0.0):
    """Factory matching the reference aligner's head selection
    (reference: deepblast/alignment.py:48-65)."""
    if layers <= 1:
        return LinearHead(hidden_dim)
    if layer_type == "cnn":
        return StackedCNN(hidden_dim, layers=layers, k_size=k_size,
                          dropout=dropout)
    if layer_type == "rnn":
        return StackedRNN(hidden_dim, hidden_dim, layers=layers,
                          dropout=dropout)
    raise ValueError(f"layer type {layer_type!r} not supported")
