"""CLI integration tests: train -> evaluate -> search on a synthetic
corpus, exercising the argparse surface end to end."""

import json
import os

import numpy as np
import pytest

from tests.test_train import fixture_frame


def _write_pairs(path, n, seed):
    df = fixture_frame(n, seed=seed)
    df.to_csv(path, sep="\t", header=False, index=False)


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    train = root / "train.tab"
    valid = root / "valid.tab"
    test = root / "test.tab"
    _write_pairs(train, 8, 0)
    _write_pairs(valid, 4, 1)
    _write_pairs(test, 4, 2)
    out = root / "model"
    from deepblast_jax.cli.train import main
    rc = main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "--test-pairs", str(test), "-o", str(out),
        "--embedding-dim", "16", "--hidden-dim", "16", "--vocab-size", "32",
        "--epochs", "2", "--batch-size", "4", "--learning-rate", "1e-2",
        "--scheduler", "none", "--dropout", "0.0", "--max-len", "64",
    ])
    assert rc == 0
    return root, out, test


def test_train_cli_outputs(trained_dir):
    root, out, _ = trained_dir
    assert os.path.exists(out / "config.json")
    assert os.path.exists(out / "checkpoints")
    metrics = [json.loads(l) for l in
               open(next((out).glob("logdir_*/metrics.jsonl")))
               ] if list(out.glob("logdir_*")) else []
    assert any(m.get("tag") == "train_loss" for m in metrics)


def test_evaluate_cli(trained_dir):
    root, out, test = trained_dir
    from deepblast_jax.cli.evaluate import main
    rc = main(["--load-from-checkpoint", str(out),
               "--test-pairs", str(test),
               "-o", str(root / "eval")])
    assert rc == 0
    import pandas as pd
    df = pd.read_csv(root / "eval" / f"{test.name}-results.csv")
    assert len(df) == 4
    assert "test_perc_id" in df.columns


def test_search_cli(trained_dir):
    root, out, _ = trained_dir
    q = root / "q.fasta"
    db = root / "db.fasta"
    q.write_text(">q1\nACDEFGHIKL\n>q2\nMNPQRSTVWY\n")
    db.write_text(">d1\nACDEFGHIKL\n>d2\nTVWYACDE\n")
    from deepblast_jax.cli.search import main
    outfile = root / "hits.tsv"
    rc = main(["--query-fasta", str(q), "--db-fasta", str(db),
               "--load-from-checkpoint", str(out),
               "--output-file", str(outfile), "--batch-size", "2"])
    assert rc == 0
    lines = outfile.read_text().strip().split("\n")
    assert len(lines) == 4
    for line in lines:
        qid, did, s, ns = line.split("\t")
        assert np.isfinite(float(s)) and np.isfinite(float(ns))


def test_search_cli_pad_parity(trained_dir):
    """Per-pair scores must not depend on batch padding: a fine
    --pad-multiple (batches pad near each pair's length) and a coarse
    one (everything shares one padded shape) must agree, and every pair
    must appear exactly once."""
    root, out, _ = trained_dir
    q = root / "qb.fasta"
    db = root / "dbb.fasta"
    q.write_text(">q1\nACDEFGHIKL\n>q2\nMNPQRSTVWYACDEFGHIKLMNPQRSTVWY\n")
    db.write_text(">d1\nACDEFGHIKL\n>d2\nTVWYACDETVWYACDETVWYACDE\n"
                  ">d3\nACD\n")
    from deepblast_jax.cli.search import main

    def run(pm, path):
        rc = main(["--query-fasta", str(q), "--db-fasta", str(db),
                   "--load-from-checkpoint", str(out),
                   "--output-file", str(path), "--batch-size", "2",
                   "--pad-multiple", str(pm)])
        assert rc == 0
        rows = {}
        for line in path.read_text().strip().split("\n"):
            qid, did, s, ns = line.split("\t")
            rows[(qid, did)] = float(s)
        return rows

    fine = run(8, root / "hits_fine.tsv")
    coarse = run(256, root / "hits_coarse.tsv")
    assert set(fine) == set(coarse) and len(fine) == 6
    for k in fine:
        np.testing.assert_allclose(fine[k], coarse[k], rtol=1e-4,
                                   atol=1e-5)


def test_benchmark_cli_smoke(capsys):
    from deepblast_jax.cli.benchmark import main
    rc = main(["--sweep", "headline", "--length", "16", "--batch-size", "2",
               "--iters", "1", "--backend", "scan", "--depth", "fwd"])
    assert rc == 0
    out = capsys.readouterr().out.strip().split("\n")[-1]
    rec = json.loads(out)
    assert rec["alignments_per_sec"] > 0


def test_hmm_simulate_requires_hmmer(tmp_path):
    from deepblast_jax.cli.hmm_simulate import main
    with pytest.raises((RuntimeError, SystemExit, Exception)):
        main(["--hmmfile", str(tmp_path / "missing.hmm"),
              "--output-file", str(tmp_path / "o.tsv")])


def test_tensorboard2csv(trained_dir, tmp_path):
    root, out, _ = trained_dir
    logs = list(out.glob("logdir_*"))
    if not logs:
        pytest.skip("no logdir")
    from deepblast_jax.cli.tensorboard2csv import main
    csv = tmp_path / "m.csv"
    rc = main(["--logdir", str(logs[0]), "--output-csv", str(csv)])
    assert rc == 0
    assert csv.exists()


def test_multi_device_fit_with_steps_per_dispatch():
    """Data-parallel sharding composes with multi-step dispatch: the
    scanned train step runs under the mesh with (K, B, ...) batches
    sharded on axis 1."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("single device")
    from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
    from deepblast_jax.parallel import make_mesh
    from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
    cfg = DeepBLASTConfig(
        embedding_dim=16, hidden_dim=16, layers=2, vocab_size=32,
        lm_type="embed", batch_size=8, learning_rate=1e-2, epochs=1,
        scheduler="none", pad_multiple=64, dropout=0.0,
        steps_per_dispatch=2)
    ds = TMAlignDataset(fixture_frame(32, seed=4),
                        tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(cfg)
    mesh = make_mesh(dp=len(jax.devices()), tp=1)
    state, history = model.fit(ds, mesh=mesh)
    assert np.isfinite(history[-1]["train_loss"])


def test_search_cli_mesh_parity(trained_dir):
    """--mesh auto shards scoring over the virtual devices and produces
    the same scores as the single-device path."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("single device")
    root, out, _ = trained_dir
    q = root / "qm.fasta"
    db = root / "dbm.fasta"
    q.write_text(">q1\nACDEFGHIKL\n>q2\nMNPQRSTVWY\n>q3\nACDACD\n")
    db.write_text(">d1\nACDEFGHIKL\n>d2\nTVWYACDE\n")
    from deepblast_jax.cli.search import main
    f_mesh, f_none = root / "hits_mesh.tsv", root / "hits_none.tsv"
    for mesh, path in [("auto", f_mesh), ("none", f_none)]:
        rc = main(["--query-fasta", str(q), "--db-fasta", str(db),
                   "--load-from-checkpoint", str(out),
                   "--output-file", str(path), "--batch-size", "4",
                   "--mesh", mesh])
        assert rc == 0
    lines_m = f_mesh.read_text().strip().split("\n")
    lines_n = f_none.read_text().strip().split("\n")
    assert len(lines_m) == len(lines_n) == 6
    for a, b in zip(lines_m, lines_n):
        qa, da, sa, na = a.split("\t")
        qb, db_, sb, nb = b.split("\t")
        assert (qa, da) == (qb, db_)
        np.testing.assert_allclose(float(sa), float(sb), rtol=1e-4,
                                   atol=1e-5)


def test_multi_device_data_parallel_fit():
    """DP sharding over the 8 virtual devices (reference: DDP,
    scripts/deepblast-train:66-84)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("single device")
    from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
    from deepblast_jax.parallel import make_mesh
    from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
    cfg = DeepBLASTConfig(
        embedding_dim=16, hidden_dim=16, layers=2, vocab_size=32,
        lm_type="embed", batch_size=8, learning_rate=1e-2, epochs=2,
        scheduler="none", pad_multiple=8, dropout=0.0)
    ds = TMAlignDataset(fixture_frame(16, seed=3),
                        tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(cfg)
    mesh = make_mesh(dp=len(jax.devices()), tp=1)
    state, history = model.fit(ds, mesh=mesh)
    assert np.isfinite(history[-1]["train_loss"])
    assert history[-1]["train_loss"] < history[0]["train_loss"] * 1.5
