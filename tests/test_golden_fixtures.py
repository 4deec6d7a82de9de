"""Golden tests against the reference's real data fixtures.

Fixture files are verbatim copies from the reference checkout:
  dm.txt            <- deepblast/tests/data/dm.txt (25x23 gradient matrix,
                       tests/test_nw_cuda.py:79-89)
  test_tm_align.tab <- deepblast/dataset/tests/data/test_tm_align.tab
                       (dataset/tests/test_dataset.py:13-48)
  example.txt       <- deepblast/dataset/tests/data/example.txt (Malidup,
                       dataset/tests/test_dataset.py:51-71)

The states2alignment regression strings are ported from
deepblast/dataset/tests/test_utils.py:78-225 (11 cases).
"""

import os

import numpy as np
import pandas as pd
import pytest

from deepblast_jax.data import state_utils as su
from deepblast_jax.data.dataset import MaliAlignmentDataset, TMAlignDataset
from deepblast_jax.ops.dp import traceback

DATA = os.path.join(os.path.dirname(__file__), "data")


# ---------------------------------------------------------------------------
# dm.txt: traceback on a real 25x23 expected-alignment matrix
# ---------------------------------------------------------------------------

def test_traceback_dm_golden():
    """Reference: tests/test_nw_cuda.py:79-89 (test_decoding2).  That test
    is CUDA-gated and its walk wraps off the matrix at the i==0 border
    (see ops.dp.traceback's documented deviation); with the corrected
    border guard the walk stays in-matrix and the alignment round-trips."""
    dm = np.loadtxt(os.path.join(DATA, "dm.txt"))
    assert dm.shape == (25, 23)
    X = "HECDRKTCDESFSTKGNLRVHKLGH"
    Y = "LKCSGCGKNFKSQYAYKRHEQTH"
    decoded = traceback(dm)
    xs, ys, states = zip(*decoded)
    assert decoded[0][:2] == (0, 0)
    assert decoded[-1][:2] == (24, 22)
    # regression-locked path on this fixture
    assert "".join(map(str, states)) == (
        "2222222222222222210022220000000000000000000001")
    ax, ay = su.states2alignment(np.array(states), X, Y)
    assert ax.replace("-", "") == X
    assert ay.replace("-", "") == Y
    assert len(ax) == len(ay) == len(decoded)


# ---------------------------------------------------------------------------
# test_tm_align.tab: real TM-align rows through TMAlignDataset + training
# ---------------------------------------------------------------------------

def test_tm_align_dataset_golden():
    """Reference: dataset/tests/test_dataset.py:17-34 — 10 rows at
    tm_threshold=0; first item clips to 21-residue alignments."""
    path = os.path.join(DATA, "test_tm_align.tab")
    ds = TMAlignDataset(path, tm_threshold=0, max_len=10000)
    assert len(ds) == 10
    item = ds[0]
    assert len(item["states"]) == 21
    assert item["aln"].shape == (21, 21)
    assert len(item["x"]) == 21 and len(item["y"]) == 21
    for i in range(len(ds)):
        it = ds[i]
        lg, lp = len(it["x"]), len(it["y"])
        assert it["aln"].shape == (lg, lp)
        assert it["gmask"].shape == (lg, lp)


def test_tm_align_train_step_golden():
    """One fit epoch on the reference's real TSV must produce a finite,
    decreasing-ish loss (the end-to-end data -> kernels path)."""
    from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
    path = os.path.join(DATA, "test_tm_align.tab")
    ds = TMAlignDataset(path, tm_threshold=0, max_len=10000)
    cfg = DeepBLASTConfig(
        embedding_dim=16, hidden_dim=16, layers=1, vocab_size=32,
        lm_type="embed", batch_size=2, learning_rate=1e-2, epochs=1,
        scheduler="none", pad_multiple=16, dropout=0.0)
    model = DeepBLAST(cfg)
    _, history = model.fit(ds)
    assert np.isfinite(history[-1]["train_loss"])


# ---------------------------------------------------------------------------
# example.txt: real Malidup rows
# ---------------------------------------------------------------------------

def test_mali_dataset_golden():
    """Reference: dataset/tests/test_dataset.py:51-71 asserts an (81, 82)
    matrix for an 81/81-residue pair — the transition-walk phantom column
    (see states2edges's documented deviation).  With consumption-based
    coords every row yields matrix dims equal to its ungapped lengths."""
    pairs = pd.read_table(os.path.join(DATA, "example.txt"), header=None)
    ds = MaliAlignmentDataset(pairs)
    assert len(ds) == 3
    item = ds[0]
    assert len(item["x"]) == 81 and len(item["y"]) == 81
    assert len(item["states"]) == 100
    assert item["aln"].shape == (81, 81)
    for i in range(3):
        it = ds[i]
        assert it["aln"].shape == (len(it["x"]), len(it["y"]))


# ---------------------------------------------------------------------------
# states2alignment regressions (reference: dataset/tests/test_utils.py)
# ---------------------------------------------------------------------------

def _tm(s):
    return np.array([su.tmstate_f(c) for c in s])


def test_states2matrix_coords_golden():
    """Reference: dataset/tests/test_utils.py:62-76."""
    s = _tm("::1122::")
    np.testing.assert_allclose(
        s, np.array([1, 1, 0, 0, 2, 2, 1, 1]))
    M = su.states2matrix(s, sparse=True)
    res = list(zip(list(M.row), list(M.col)))
    assert res == [(0, 0), (1, 1), (2, 1), (3, 1),
                   (3, 2), (3, 3), (4, 4), (5, 5)]


def test_states2alignment_case_1():
    s = _tm("111:::222")
    rx, ry = su.states2alignment(s, "123456", "abcdef")
    assert rx == "123456---"
    assert ry == "---abcdef"


def test_states2alignment_case_2():
    s = _tm("111:::111")
    rx, ry = su.states2alignment(s, "123456789", "abc")
    assert rx == "123456789"
    assert ry == "---abc---"


_X3 = ("XSDHGDVSLPPEDRVRALSQLGSAVEVNEDIPPRRYFRSGVEIIRMA"
       "SIYSEEGNIEHAFILYNKYITLFIEKLPKHRDYKSAVIPEKKDTVK"
       "KLKEIAFPKAEELKAELLKRYTKEYTEYNEEKKKEAEELARNMAIQ"
       "QELX")
_Y3 = "XIDVLRAKAAKERAERRLQSQQDDIDFKRAELALKRAMNRLSVAEMKX"
_S3 = np.array(
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
     0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 0, 1, 1, 2, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 1])


def test_states2alignment_case_3():
    su.states2alignment(_S3, _X3, _Y3)


_X4 = "XGSSGSSGFDENWGADEELLLIDACETLGLGNWADIADYVGNARTKEECRDHYLKTYIEX"
_Y4 = ("XGEIRVGNRYQADITDLLKEGEEDGRDQSRLETQVWEAHNPLTDKQIDQFLVVARSVGTF"
       "ARALDSLHMSAAAASRDITLFHAMDTLHKNIYDISKAISALVPQGGPVLCRDEMEEWSAS"
       "EANLFEEALEKYGKDFTDIQQDFLPWKSLTSIIEYYYMWKTTX")
_S4 = np.array(
    [1, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1,
     1, 1, 2, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1])


def test_states2alignment_cases_4_to_7():
    """Cases 4-7 in the reference all exercise the same 60/163 pair and
    state vector (dataset/tests/test_utils.py:120-218)."""
    su.states2alignment(_S4, _X4, _Y4)


def test_states2alignment_case_8():
    s = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 1])
    su.states2alignment(s, "YRCHKVCPYTFVGKSDLDLHQFITAH",
                        "HECDDCSKQFSRNNHLAKHLRAH")


def test_states2alignment_case_9():
    su.states2alignment(np.array([1, 1, 0, 1]), "HCAH", "HCH")


def test_states2alignment_case_10():
    pred = np.array(
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
         1, 0, 2, 1, 1, 0, 1, 2, 0, 1, 1, 1, 1])
    su.states2alignment(pred, "YACSGGCGQNFRTMSEFNEHMIRLVH",
                        "LICPKHTRDCGKVFKRNSSLRVHEH")


def test_states2alignment_case_11():
    pred = np.array(
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
         2, 2, 2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0,
         0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
         0, 0, 0])
    su.states2alignment(pred, "LNCKEIKKYCEMSFRNPDDIRKHRGAIH",
                        "YTCSSCNESLRTAWCLNKHLR")
