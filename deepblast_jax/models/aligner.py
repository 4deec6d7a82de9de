"""Neural alignment model (reference: deepblast/alignment.py:13-171).

``NeuralAligner`` turns frozen language-model embeddings of two sequences
into DP potentials and decodes the expected alignment:

* ``theta = softplus(zx @ zy^T)`` — per-pair match potentials
  (reference: deepblast/alignment.py:122)
* ``A = logsigmoid(gx @ gy^T)`` — per-cell gap potentials
  (reference: deepblast/alignment.py:123)
* ``aln = expected_alignment(theta, A)`` — the differentiable decode
  (reference: deepblast/alignment.py:124, deepblast/nw.py:446-458)

Design notes: the language model runs *outside* this module (it is frozen;
its activations are produced once per batch, reference's ``no_grad`` in
deepblast/alignment.py:90-93), the pairwise interactions are batched
einsums, and decoding is the batched wavefront DP with per-pair lengths
instead of per-pair Python slicing (reference: deepblast/alignment.py:165-169).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from deepblast_jax.models.heads import build_head
from deepblast_jax.models.module import Module
from deepblast_jax.ops import dp as dp_ops

_MODE_ALIASES = {
    "needleman-wunsch": "nw",
    "smith-waterman": "sw",
    "nw": "nw",
    "sw": "sw",
}


@dataclasses.dataclass(frozen=True)
class NeuralAligner(Module):
    """Match/gap heads over LM embeddings + differentiable DP decoding.

    Parameters: ``{"match_embedding": head, "gap_embedding": head}``."""

    embedding_dim: int = 1024      # LM output dim (reference n_input)
    hidden_dim: int = 1024         # head feature dim (reference n_units)
    layers: int = 2
    k_size: int = 5
    dropout: float = 0.0
    layer_type: str = "cnn"
    alignment_mode: str = "needleman-wunsch"
    operator: str = "softmax"
    backend: Optional[str] = None
    matmul_dtype: Optional[str] = None   # e.g. "bfloat16"

    @property
    def mode(self):
        return _MODE_ALIASES[self.alignment_mode]

    @property
    def head(self):
        return build_head(self.layer_type, embedding_dim=self.embedding_dim,
                          hidden_dim=self.hidden_dim, layers=self.layers,
                          k_size=self.k_size, dropout=self.dropout)

    def init_params(self, rng, hx, hy=None, lengths=None,
                    deterministic=True):
        r_m, r_g = jax.random.split(rng)
        return {"match_embedding": self.head.init_params(r_m, hx),
                "gap_embedding": self.head.init_params(r_g, hx)}

    def blosum_factor(self, p, hx, lengths=None, deterministic=True,
                      rngs=None):
        """Head features for one side (reference:
        deepblast/alignment.py:81-97, sans the in-module LM call).

        ``lengths`` makes the features *padding-invariant*: the stacked
        heads mix neighbouring positions (conv receptive field / reverse
        RNN), so without masking, features at the last few true positions
        depend on the pad width and pad content — scores then change with
        batch composition and length bucketing.  The reference has the
        same leak (its StackedCNN convolves the padded batch buffer,
        deepblast/embedding.py:152-168); here it is fixed and
        test-covered (tests/test_cli.py::test_search_cli_bucket_parity,
        tests/test_models.py)."""
        rz = rg = rngs
        if rngs is not None and "dropout" in rngs:
            # independent dropout masks for the two heads
            kz, kg = jax.random.split(rngs["dropout"])
            rz, rg = {"dropout": kz}, {"dropout": kg}
        zx = self.head(p["match_embedding"], hx, lengths,
                       deterministic=deterministic, rngs=rz)
        gx = self.head(p["gap_embedding"], hx, lengths,
                       deterministic=deterministic, rngs=rg)
        return zx, gx

    def potentials(self, p, hx, hy, lengths=None, deterministic=True,
                   rngs=None):
        """Match and gap potential matrices ``(B, N, M)``."""
        ln, lm = lengths if lengths is not None else (None, None)
        rx = ry = rngs
        if rngs is not None and "dropout" in rngs:
            kx, ky = jax.random.split(rngs["dropout"])
            rx, ry = {"dropout": kx}, {"dropout": ky}
        zx, gx = self.blosum_factor(p, hx, ln, deterministic, rx)
        zy, gy = self.blosum_factor(p, hy, lm, deterministic, ry)
        if self.matmul_dtype is not None:
            dt = jnp.dtype(self.matmul_dtype)
            zx, zy, gx, gy = (v.astype(dt) for v in (zx, zy, gx, gy))
        match = jnp.einsum("bid,bjd->bij", zx, zy,
                           preferred_element_type=jnp.float32)
        gap = jnp.einsum("bid,bjd->bij", gx, gy,
                         preferred_element_type=jnp.float32)
        theta = jax.nn.softplus(match)
        A = jax.nn.log_sigmoid(gap)
        return theta, A

    def __call__(self, p, hx, hy, lengths=None, deterministic=True,
                 rngs=None):
        """Returns ``(aln, theta, A)`` like the reference forward
        (reference: deepblast/alignment.py:99-125)."""
        theta, A = self.potentials(p, hx, hy, lengths, deterministic, rngs)
        aln = dp_ops.expected_alignment(
            theta, A, lengths, mode=self.mode, operator=self.operator,
            backend=self.backend)
        return aln, theta, A

    def score(self, p, hx, hy, lengths=None):
        """Terminal alignment scores (reference:
        deepblast/alignment.py:127-137)."""
        theta, A = self.potentials(p, hx, hy, lengths, deterministic=True)
        return dp_ops.alignment_score(
            theta, A, lengths, mode=self.mode, operator=self.operator,
            backend=self.backend)
