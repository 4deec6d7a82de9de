"""The plain-JAX modules keep the parameter-tree paths of the earlier flax
modules (converted LM artifacts and saved checkpoints depend on them), and
the main path imports without flax, orbax, pandas or torch."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepblast_jax.models import (
    BiLM,
    LinearHead,
    NeuralAligner,
    StackedCNN,
    StackedRNN,
    T5Config,
    T5Encoder,
)
from deepblast_jax.models.lm import TokenEmbed, convert_bepler_bilm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): tuple(v.shape)
            for p, v in leaves}


def test_stacked_cnn_param_paths():
    p = StackedCNN(features=6, layers=2, k_size=3).init(
        jax.random.key(0), jnp.ones((1, 5, 4)))
    assert _paths(p) == {
        "params/embed/kernel": (4, 4), "params/embed/bias": (4,),
        "params/conv0/kernel": (3, 4, 6), "params/conv0/bias": (6,),
        "params/conv1/kernel": (3, 6, 6), "params/conv1/bias": (6,)}


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_stacked_rnn_param_paths(rnn_type):
    p = StackedRNN(hidden=3, features=5, layers=1, rnn_type=rnn_type).init(
        jax.random.key(0), jnp.ones((1, 4, 2)))
    got = _paths(p)
    if rnn_type == "lstm":
        cell = {**{f"i{g}/kernel": (2, 3) for g in "ifgo"},
                **{f"h{g}/kernel": (3, 3) for g in "ifgo"},
                **{f"h{g}/bias": (3,) for g in "ifgo"}}
    else:
        cell = {**{f"i{g}/kernel": (2, 3) for g in "rzn"},
                **{f"i{g}/bias": (3,) for g in "rzn"},
                **{f"h{g}/kernel": (3, 3) for g in "rzn"}, "hn/bias": (3,)}
    want = {"params/embed/kernel": (2, 2), "params/embed/bias": (2,),
            "params/proj/kernel": (6, 5), "params/proj/bias": (5,)}
    for d in ("fwd0", "bwd0"):
        want.update({f"params/{d}/cell/{k}": v for k, v in cell.items()})
    assert got == want


def test_linear_head_and_token_embed_param_paths():
    assert _paths(LinearHead(7).init(jax.random.key(0), jnp.ones((1, 2, 3)))) \
        == {"params/Dense_0/kernel": (3, 7), "params/Dense_0/bias": (7,)}
    assert _paths(TokenEmbed(vocab=11, dim=4).init(jax.random.key(0))) == {
        "params/Embed_0/embedding": (11, 4)}


def test_neural_aligner_param_paths():
    m = NeuralAligner(embedding_dim=4, hidden_dim=6, layers=1)
    h = jnp.ones((1, 3, 4))
    got = _paths(m.init(jax.random.key(0), h, h))
    assert got == {f"params/{head}/Dense_0/{k}": s
                   for head in ("match_embedding", "gap_embedding")
                   for k, s in (("kernel", (4, 6)), ("bias", (6,)))}


def test_bilm_param_paths_match_the_converter():
    m = BiLM(nin=6, nout=5, embedding_dim=4, hidden_dim=3, num_layers=2)
    ours = _paths(m.init(jax.random.key(0)))
    H = 3
    sd = {"embed.weight": np.zeros((6, 4)),
          "linear.weight": np.zeros((5, H)), "linear.bias": np.zeros(5)}
    for i, n_in in enumerate((4, H)):
        sd[f"rnn.{i}.weight_ih_l0"] = np.zeros((4 * H, n_in))
        sd[f"rnn.{i}.weight_hh_l0"] = np.zeros((4 * H, H))
        sd[f"rnn.{i}.bias_ih_l0"] = np.zeros(4 * H)
        sd[f"rnn.{i}.bias_hh_l0"] = np.zeros(4 * H)
    assert ours == _paths(convert_bepler_bilm(sd, num_layers=2))


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_t5_param_paths(ff):
    cfg = T5Config(vocab_size=8, d_model=4, d_kv=2, d_ff=6, num_layers=2,
                   num_heads=2, feed_forward_proj=ff)
    got = _paths(T5Encoder(cfg).init(jax.random.key(0)))
    assert got["params/embed/embedding"] == (8, 4)
    assert got["params/block0/attn/relative_attention_bias"] == (32, 2)
    assert "params/block1/attn/relative_attention_bias" not in got
    assert got["params/block1/attn/q/kernel"] == (4, 4)
    assert got["params/block1/ln_ff/weight"] == (4,)
    assert got["params/ln_final/weight"] == (4,)
    wi = ({"wi_0", "wi_1"} if ff == "gated-gelu" else {"wi"}) | {"wo"}
    assert {k.split("/")[3] for k in got if "/ff/" in k} == wi


_BLOCKED = ["flax", "orbax", "orbax.checkpoint", "pandas", "torch"]


@pytest.mark.parametrize("module", [
    "deepblast_jax.ops", "deepblast_jax.models", "deepblast_jax.train",
    "deepblast_jax.data.dataset", "deepblast_jax.sim",
    "deepblast_jax.cli.train", "deepblast_jax.cli.search", "chip_smoke"])
def test_main_path_imports_without_optional_packages(module):
    code = ("import sys\n"
            f"for m in {_BLOCKED!r}: sys.modules[m] = None\n"
            f"import {module}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
