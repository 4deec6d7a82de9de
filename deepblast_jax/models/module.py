"""Plain-JAX modules: parameters in nested dicts, pure apply functions.

A model is a frozen dataclass of hyper-parameters.  ``init(rng, *inputs)``
returns ``{"params": tree}`` built from example inputs, and
``apply(variables, *inputs, method=None, rngs=None)`` runs ``__call__`` (or
another method) with ``variables["params"]`` passed as the first argument.
The tree paths are those of the earlier flax modules (``kernel``/``bias``/
``embedding``, ``conv0``, ``lstm0/cell/ii``, ``block3/attn/q``), so
converted LM artifacts and saved checkpoints keep loading.

Layer helpers below are functions of ``(params, x)`` plus ``init_*``
functions that draw the same initial distributions as flax's defaults.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Module",
    "dense",
    "init_dense",
    "conv1d",
    "init_conv1d",
    "init_embed",
    "init_lstm",
    "init_gru",
    "rnn",
    "dropout",
]


class Module:
    """Base of the plain-JAX modules: ``init`` / ``apply`` over
    ``{"params": tree}``."""

    def init_params(self, rng, *args, **kw):  # pragma: no cover - abstract
        raise NotImplementedError

    def init(self, rng, *args, **kw):
        """``{"params": tree}`` for these hyper-parameters; ``args`` are
        example inputs that fix input widths."""
        return {"params": self.init_params(rng, *args, **kw)}

    def apply(self, variables, *args, method=None, rngs=None, **kw):
        fn = method if method is not None else type(self).__call__
        if rngs is not None:
            kw["rngs"] = rngs
        return fn(self, variables["params"], *args, **kw)


# ---------------------------------------------------------------------------
# initialisers (flax defaults: lecun-normal kernels, zero biases,
# fan-in-normal embeddings, orthogonal recurrent kernels)
# ---------------------------------------------------------------------------

def _lecun_normal(rng, shape, fan_in, dtype=jnp.float32):
    # truncated to +-2 sd and rescaled to unit variance, as in flax
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    return std * jax.random.truncated_normal(rng, -2.0, 2.0, shape, dtype)


def _orthogonal(rng, n_in, n_out, dtype=jnp.float32):
    a = jax.random.normal(rng, (max(n_in, n_out), min(n_in, n_out)), dtype)
    q, r = jnp.linalg.qr(a)
    q = q * jnp.sign(jnp.diag(r))
    return q if n_in >= n_out else q.T


def init_dense(rng, n_in, n_out, use_bias=True):
    p = {"kernel": _lecun_normal(rng, (n_in, n_out), n_in)}
    if use_bias:
        p["bias"] = jnp.zeros((n_out,), jnp.float32)
    return p


def dense(p, x, dtype=None):
    """``x @ kernel + bias``; with ``dtype``, inputs and weights are cast to
    it for the product (the flax ``Dense(dtype=...)`` semantics)."""
    k = p["kernel"]
    if dtype is not None:
        x, k = x.astype(dtype), k.astype(dtype)
    y = jnp.dot(x, k)
    if "bias" in p:
        y = y + p["bias"].astype(y.dtype)
    return y


def init_conv1d(rng, k_size, n_in, n_out):
    return {"kernel": _lecun_normal(rng, (k_size, n_in, n_out),
                                    k_size * n_in),
            "bias": jnp.zeros((n_out,), jnp.float32)}


def conv1d(p, x):
    """'SAME'-padded 1-D convolution of ``x`` (B, L, C) with kernel
    (k, C, F)."""
    y = jax.lax.conv_general_dilated(
        x, p["kernel"].astype(x.dtype), window_strides=(1,),
        padding="SAME", dimension_numbers=("NWC", "WIO", "NWC"))
    return y + p["bias"].astype(y.dtype)


def init_embed(rng, num, features):
    return {"embedding": jax.random.normal(rng, (num, features))
            / np.sqrt(features)}


def dropout(x, rate, rng, deterministic):
    if deterministic or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout needs rngs={'dropout': key} in training")
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)


# ---------------------------------------------------------------------------
# recurrent cells (flax OptimizedLSTMCell / GRUCell parameter layout)
# ---------------------------------------------------------------------------

def init_lstm(rng, n_in, hidden):
    """``{"ii","if","ig","io"}`` input kernels (no bias) and
    ``{"hi","hf","hg","ho"}`` recurrent kernels with the bias."""
    keys = jax.random.split(rng, 8)
    p = {}
    for n, g in enumerate("ifgo"):
        p[f"i{g}"] = {"kernel": _lecun_normal(keys[n], (n_in, hidden), n_in)}
        p[f"h{g}"] = {"kernel": _orthogonal(keys[4 + n], hidden, hidden),
                      "bias": jnp.zeros((hidden,), jnp.float32)}
    return p


def _lstm_step(p, carry, x):
    c, h = carry
    pre = {g: dense(p[f"i{g}"], x) + dense(p[f"h{g}"], h) for g in "ifgo"}
    i = jax.nn.sigmoid(pre["i"])
    f = jax.nn.sigmoid(pre["f"])
    g = jnp.tanh(pre["g"])
    o = jax.nn.sigmoid(pre["o"])
    c = f * c + i * g
    h = o * jnp.tanh(c)
    return (c, h), h


def init_gru(rng, n_in, hidden):
    """``{"ir","iz","in"}`` input kernels with bias, ``{"hr","hz"}``
    recurrent kernels without and ``"hn"`` with bias."""
    keys = jax.random.split(rng, 6)
    p = {}
    for n, g in enumerate("rzn"):
        p[f"i{g}"] = init_dense(keys[n], n_in, hidden)
        p[f"h{g}"] = {"kernel": _orthogonal(keys[3 + n], hidden, hidden)}
    p["hn"]["bias"] = jnp.zeros((hidden,), jnp.float32)
    return p


def _gru_step(p, h, x):
    r = jax.nn.sigmoid(dense(p["ir"], x) + dense(p["hr"], h))
    z = jax.nn.sigmoid(dense(p["iz"], x) + dense(p["hz"], h))
    n = jnp.tanh(dense(p["in"], x) + r * dense(p["hn"], h))
    h = (1.0 - z) * n + z * h
    return h, h


def _flip_within(x, lengths):
    """Reverse each row's first ``length`` steps (padding reversed among
    itself), the involution flax's ``flip_sequences`` applies."""
    L = x.shape[1]
    idx = (jnp.arange(L - 1, -1, -1)[None, :] + lengths[:, None]) % L
    return jnp.take_along_axis(x, idx[..., None], axis=1)


def rnn(p, x, lengths=None, reverse=False, cell="lstm"):
    """Run an LSTM or GRU cell over ``x`` (B, L, C); returns (B, L, H).

    ``reverse`` runs right to left over each row's true length and returns
    outputs in the original order, so features at true positions never see
    padding."""
    cp = p["cell"]
    B, L = x.shape[:2]
    if cell == "lstm":
        H = cp["hi"]["kernel"].shape[0]
        step, carry = _lstm_step, (jnp.zeros((B, H), x.dtype),) * 2
    else:
        H = cp["hr"]["kernel"].shape[0]
        step, carry = _gru_step, jnp.zeros((B, H), x.dtype)
    if reverse:
        if lengths is None:
            lengths = jnp.full((B,), L, jnp.int32)
        x = _flip_within(x, lengths)
    _, ys = jax.lax.scan(lambda c, xt: step(cp, c, xt), carry,
                         jnp.swapaxes(x, 0, 1))
    ys = jnp.swapaxes(ys, 0, 1)
    if reverse:
        ys = _flip_within(ys, lengths)
    return ys
