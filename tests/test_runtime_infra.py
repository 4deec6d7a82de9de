"""Run-time plumbing: the compile-cache rule, ``.npz`` checkpoints, the
seeded pair simulator and pair files, the device timer, and the refusal of
the device measurements to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from deepblast_jax.data.dataset import (
    TMAlignDataset,
    read_pairs,
    write_pairs,
)
from deepblast_jax.sim import simulate_pairs
from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
from deepblast_jax.train.checkpoint import (
    Checkpointer,
    load_model,
    save_config,
)
from deepblast_jax.utils import cache
from deepblast_jax.utils.timing import time_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- compile cache --------------------------------------------------------------


def test_cache_dir_follows_the_environment():
    assert cache.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}) == "/somewhere/else"


def test_cache_dir_falls_back_to_the_checkout():
    want = os.path.join(ROOT, ".jax_cache")
    assert cache.compile_cache_dir({}) == want
    assert cache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == want


def test_enable_compile_cache_leaves_a_set_environment_alone(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/the/environment")
    try:
        jax.config.update("jax_compilation_cache_dir", "/left/as/it/was")
        assert cache.enable_compile_cache() == "/from/the/environment"
        assert jax.config.jax_compilation_cache_dir == "/left/as/it/was"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# -- checkpoints -----------------------------------------------------------------

_TINY = dict(embedding_dim=8, hidden_dim=8, layers=2, k_size=3,
             vocab_size=32, lm_type="embed", batch_size=2, epochs=1,
             scheduler="none", pad_multiple=8)


def test_npz_checkpoint_round_trip(tmp_path):
    model = DeepBLAST(DeepBLASTConfig(**_TINY))
    state = model.init()
    state = state.replace(step=state.step + 7)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(state, {"validation_loss": 1.5})
    assert ck.latest_step() == 7 and ck.best_step() == 7
    restored = ck.restore(jax.eval_shape(model.init))
    a, b = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(
        restored)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree_util.tree_structure(state) == \
        jax.tree_util.tree_structure(restored)


def test_checkpointer_keeps_the_best_k(tmp_path):
    model = DeepBLAST(DeepBLASTConfig(**_TINY))
    state = model.init()
    ck = Checkpointer(tmp_path, keep=2)
    for step, loss in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 5.0)):
        ck.save(state.replace(step=state.step + step),
                {"validation_loss": loss})
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) \
        == ["step_2.npz", "step_3.npz"]
    assert ck.best_step() == 2 and ck.latest_step() == 3
    assert int(ck.restore(state, step=3).step) == 3


def test_restore_rejects_a_mismatched_model(tmp_path):
    model = DeepBLAST(DeepBLASTConfig(**_TINY))
    Checkpointer(tmp_path).save(model.init())
    other = DeepBLAST(DeepBLASTConfig(**{**_TINY, "hidden_dim": 4}))
    with pytest.raises(ValueError):
        Checkpointer(tmp_path).restore(jax.eval_shape(other.init))


def test_load_model_from_output_directory(tmp_path):
    config = DeepBLASTConfig(**_TINY)
    model = DeepBLAST(config)
    state = model.init()
    save_config(config, tmp_path)
    Checkpointer(tmp_path / "checkpoints").save(state)
    loaded = load_model(str(tmp_path))
    assert loaded.config == config
    for x, y in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(loaded.state.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert isinstance(loaded.align("ACDEFG", "ACDFG"), str)


# -- simulated pairs and pair files ----------------------------------------------

def test_simulated_pairs_are_consistent_alignments():
    for row in simulate_pairs(20, seed=4, min_len=10, max_len=30):
        c1, c2, s = row[5], row[6], row[7]
        assert 10 <= len(c1) <= 30 and len(c2) <= 30
        assert s.count(":") + s.count("1") == len(c1)
        assert s.count(":") + s.count("2") == len(c2)


def test_simulated_pairs_follow_the_seed():
    assert simulate_pairs(5, seed=1) == simulate_pairs(5, seed=1)
    assert simulate_pairs(5, seed=1) != simulate_pairs(5, seed=2)


def test_pair_file_round_trip_feeds_the_dataset(tmp_path):
    rows = simulate_pairs(6, seed=0, min_len=8, max_len=20)
    path = tmp_path / "pairs.tsv"
    write_pairs(rows, path)
    back = read_pairs(path)
    assert [r[5:] for r in back] == [r[5:] for r in rows]
    from_file = TMAlignDataset(str(path))
    from_rows = TMAlignDataset(rows)
    assert len(from_file) == len(from_rows) == 6
    for k in ("x", "y", "aln", "states"):
        np.testing.assert_array_equal(from_file[2][k], from_rows[2][k])


# -- timing -----------------------------------------------------------------------

def test_time_fn_waits_for_every_call():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    samples = time_fn(fn, jax.numpy.ones(3), warmup=2, iters=4)
    assert len(samples) == 4 and len(calls) == 6
    assert all(s >= 0 for s in samples)


# -- no GPU, no device measurement ----------------------------------------------

def _run_script(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_device_measurements_refuse_the_cpu(script):
    proc = _run_script([script], ROOT)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_script(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
