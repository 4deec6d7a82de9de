"""End-to-end training slice: synthetic TM-align pairs -> DeepBLAST ->
loss decreases and the string API produces valid alignments (SURVEY.md §7
minimum slice; reference test analogue: deepblast/tests/test_alignment.py)."""

import numpy as np
import pandas as pd
import pytest

from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
from deepblast_jax.train import DeepBLAST, DeepBLASTConfig

AA = "ACDEFGHIKLMNPQRSTVWY"


def _random_pair(rng, n):
    seq = "".join(rng.choice(list(AA), size=n))
    kind = rng.integers(0, 3)
    if kind == 0:
        return seq, seq, ":" * n
    if kind == 1:  # x-gap in the middle
        k = int(rng.integers(1, max(2, n // 4)))
        pos = int(rng.integers(1, n - k))
        chain2 = seq[:pos] + seq[pos + k:]
        aln = ":" * pos + "1" * k + ":" * (n - pos - k)
        return seq, chain2, aln
    k = int(rng.integers(1, max(2, n // 4)))
    pos = int(rng.integers(1, n - k))
    chain1 = seq[:pos] + seq[pos + k:]
    aln = ":" * pos + "2" * k + ":" * (n - pos - k)
    return chain1, seq, aln


def fixture_frame(n_rows=12, min_len=10, max_len=24, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        n = int(rng.integers(min_len, max_len))
        c1, c2, aln = _random_pair(rng, n)
        rows.append([f"q{i}", f"t{i}", 0.9, 0.9, 1.0, c1, c2, aln])
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def tiny_config():
    return DeepBLASTConfig(
        embedding_dim=16, hidden_dim=16, layers=2, k_size=5,
        vocab_size=32, lm_type="embed", batch_size=4,
        learning_rate=5e-2, epochs=3, scheduler="none",
        max_len=64, pad_multiple=8, mask_gaps=True)


def test_dataset_fixture_roundtrip():
    ds = TMAlignDataset(fixture_frame(), tokenizer=ProtT5Tokenizer())
    assert len(ds) == 12
    item = ds[0]
    assert item["aln"].shape == (len(item["x"]), len(item["y"]))
    assert item["gmask"].shape == item["aln"].shape
    # each row of a global alignment has exactly one aligned cell per match
    assert item["aln"].sum() >= max(item["aln"].shape) - 1


def test_training_loss_decreases(tiny_config):
    ds = TMAlignDataset(fixture_frame(), tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(tiny_config)
    state, history = model.fit(ds, ds)
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert np.isfinite(history[-1]["validation_loss"])


def test_multi_step_dispatch_matches_single():
    """steps_per_dispatch=4 (lax.scan over stacked batches in one jit)
    reproduces the single-step training losses step for step (dropout 0,
    same seed/order; stragglers at shape changes fall back to singles)."""
    ds = TMAlignDataset(fixture_frame(16, seed=5),
                        tokenizer=ProtT5Tokenizer())
    base = dict(embedding_dim=16, hidden_dim=16, layers=2, k_size=5,
                vocab_size=32, lm_type="embed", batch_size=4,
                learning_rate=5e-2, epochs=2, scheduler="none",
                max_len=64, pad_multiple=64, dropout=0.0, mask_gaps=True)

    class _Rec:
        def __init__(self):
            self.rows = []

        def log_scalar(self, tag, value, step):
            if tag == "train_loss":
                self.rows.append((step, value))

        def log_figure(self, *a, **k):
            pass

        def log_text(self, *a, **k):
            pass

    logs = {}
    for spd in (1, 4):
        model = DeepBLAST(DeepBLASTConfig(steps_per_dispatch=spd, **base))
        rec = _Rec()
        model.fit(ds, logger=rec)
        logs[spd] = rec.rows
    assert len(logs[1]) == len(logs[4]) == 8
    assert [s for s, _ in logs[1]] == [s for s, _ in logs[4]]
    np.testing.assert_allclose([v for _, v in logs[1]],
                               [v for _, v in logs[4]],
                               rtol=2e-4, atol=1e-6)


def test_align_string_api(tiny_config):
    ds = TMAlignDataset(fixture_frame(6), tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(tiny_config)
    model.fit(ds)
    s = model.align("ACDEFGHIK", "ACDEFGHIK")
    assert len(s) >= 9
    assert set(s) <= set(":12")
    # state string consumes both sequences fully
    assert s.count(":") + s.count("1") == 9
    assert s.count(":") + s.count("2") == 9


def test_losses_match_per_pair_loops():
    """Vectorised losses == reference-style per-pair python loops."""
    import jax.numpy as jnp
    from deepblast_jax.train.losses import (
        matrix_cross_entropy, soft_alignment_loss, soft_path_loss, EPS)
    rng = np.random.default_rng(0)
    B, N, M = 3, 6, 5
    Yt = (rng.random((B, N, M)) < 0.3).astype(np.float32)
    Yp = rng.random((B, N, M)).astype(np.float32)
    P = rng.random((B, N, M)).astype(np.float32)
    G = rng.random((B, N, M)) < 0.8
    xl = np.array([6, 4, 5])
    yl = np.array([5, 3, 2])

    def loop_ce():
        tot = 0.0
        for b in range(B):
            yp = np.clip(Yp[b, :xl[b], :yl[b]], EPS, 1 - EPS)
            yt = Yt[b, :xl[b], :yl[b]]
            g = G[b, :xl[b], :yl[b]]
            ll = yt * np.log(yp) + (1 - yt) * np.log(1 - yp)
            tot += -ll[g].mean()
        return tot / B

    def loop_norm(A_, B_):
        tot = 0.0
        for b in range(B):
            d = (A_[b, :xl[b], :yl[b]] - B_[b, :xl[b], :yl[b]])[
                G[b, :xl[b], :yl[b]]]
            tot += np.linalg.norm(d)
        return tot / B

    def loop_path():
        tot = 0.0
        for b in range(B):
            d = (P[b, :xl[b], :yl[b]] * Yp[b, :xl[b], :yl[b]])[
                G[b, :xl[b], :yl[b]]]
            tot += np.linalg.norm(d)
        return tot / B

    args = (jnp.asarray(xl), jnp.asarray(yl), jnp.asarray(G))
    np.testing.assert_allclose(
        matrix_cross_entropy(jnp.asarray(Yt), jnp.asarray(Yp), *args),
        loop_ce(), rtol=1e-5)
    np.testing.assert_allclose(
        soft_alignment_loss(jnp.asarray(Yt), jnp.asarray(Yp), *args),
        loop_norm(Yt, Yp), rtol=1e-5)
    np.testing.assert_allclose(
        soft_path_loss(jnp.asarray(P), jnp.asarray(Yp), *args),
        loop_path(), rtol=1e-5)


def test_checkpoint_roundtrip(tiny_config, tmp_path):
    import jax
    from deepblast_jax.train import Checkpointer
    ds = TMAlignDataset(fixture_frame(4), tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(tiny_config)
    state, _ = model.fit(ds)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(state, {"validation_loss": 1.0})
    template = model.init()
    restored = ck.restore(template)
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_schedules():
    from deepblast_jax.train.schedules import make_schedule
    for name in ["none", "cosine", "cosine_restarts", "triangular", "steplr"]:
        s = make_schedule(name, 1e-3, epochs=8, steps_per_epoch=10)
        vals = [float(s(i)) for i in [0, 10, 50, 79]]
        assert all(np.isfinite(v) and 0 <= v <= 1.1e-3 for v in vals), name
    with pytest.raises(ValueError):
        make_schedule("bogus", 1e-3, 1)
