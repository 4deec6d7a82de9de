"""Evaluation layer tests: scoring (reference analogue:
deepblast/tests/test_score.py), structural metrics, PDB parsing, corpus
parsers."""

import numpy as np
import pytest

from deepblast_jax.eval import metrics as M
from deepblast_jax.eval import score as S


class TestRocEdges:
    def test_exact(self):
        true = [(0, 0), (1, 1), (2, 2)]
        pred = [(0, 0), (1, 1), (2, 1)]
        tp, fp, fn, perc_id, ppv, fnr, fdr = S.roc_edges(true, pred)
        assert (tp, fp, fn) == (2, 1, 1)
        assert perc_id == pytest.approx(2 / 3)
        assert ppv == pytest.approx(2 / 3)
        assert fnr == pytest.approx(1 / 3)
        assert fdr == pytest.approx(1 / 3)

    def test_alignment_score_strings(self):
        stats = S.alignment_score(":::", ":::")
        assert stats[0] == 3 and stats[1] == 0 and stats[2] == 0

    def test_kernel_identity(self):
        true = [(0, 0), (1, 1)]
        pred = [(1, 1), (2, 2)]  # shifted one step along the diagonal
        assert S.roc_edges_kernel_identity(true, pred, 1) == 0.5
        assert S.roc_edges_kernel_identity(true, pred, 2) == 1.0

    def test_filter_gaps(self):
        states = [1, 0, 1]
        edges = [(0, 0), (1, 0), (2, 1)]
        assert S.filter_gaps(states, edges) == [(0, 0), (2, 1)]

    def test_alignment_text(self):
        txt = S.alignment_text("AB", "CD", np.array([1, 1]),
                               np.array([1, 1]), [1, 0, 0, 1, 1, 0, 0])
        assert "Ground truth" in txt and "Prediction" in txt


def _helix(n, seed=0):
    t = np.linspace(0, 4 * np.pi, n)
    return np.stack([np.cos(t) * 5, np.sin(t) * 5, t], axis=1)


def _random_rotation(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


class TestKabsch:
    def test_recovers_rotation(self):
        p1 = _helix(30)
        R0 = _random_rotation(1)
        p2 = p1 @ R0.T + np.array([1.0, -2.0, 3.0])
        R, w, d, o1, o2 = M.kabsch(p1, p2)
        aligned = (p2 - o2) @ R.T
        assert np.sqrt(np.mean((aligned - (p1 - o1)) ** 2)) < 1e-8
        assert d == 1

    def test_improper_fix(self):
        p1 = _helix(20)
        p2 = p1.copy()
        p2[:, 2] = -p2[:, 2]  # mirrored
        R, w, d, _, _ = M.kabsch(p1, p2)
        assert np.isclose(np.linalg.det(R), 1.0)


class TestStructuralMetrics:
    def test_identical_structures(self):
        p = _helix(40)
        ai = np.stack([np.arange(40), np.arange(40)])
        A, raw, maxsub = M.FR_TM_maxsub_score(p, p.copy(), ai)
        assert A.score > 0.95
        sm = M.standard_metrics(p, p.copy(), ai, indicies=A.alignment)
        assert sm.TM > 0.95
        assert sm.PSI == pytest.approx(1.0)
        assert sm.aRMS < 1e-6

    def test_rotated_structures(self):
        p = _helix(40)
        q = p @ _random_rotation(2).T + 7.0
        ai = np.stack([np.arange(40), np.arange(40)])
        A, _, _ = M.FR_TM_maxsub_score(p, q, ai)
        assert A.score > 0.95

    def test_partial_similarity(self):
        p = _helix(40)
        q = p.copy()
        q[20:] += _helix(40)[::-1][:20] * 0.5  # corrupt second half
        ai = np.stack([np.arange(40), np.arange(40)])
        A, _, _ = M.FR_TM_maxsub_score(p, q, ai)
        sm = M.standard_metrics(p, q, ai, indicies=A.alignment)
        assert 0.0 < sm.TM < 1.0
        assert sm.L_PSI >= 20

    def test_parse_alignment_string(self):
        ai = M.parse_alignment_string(":1:2:")
        # reference returns [second_idx, first_idx]
        np.testing.assert_array_equal(ai[1], [0, 2, 3])
        np.testing.assert_array_equal(ai[0], [0, 1, 3])


PDB_LINES = """ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N
ATOM      2  CA  ALA A   1      11.639   6.071  -5.147  1.00  0.00           C
ATOM      3  CA  GLY A   2       8.304   5.024  -4.020  1.00  0.00           C
ATOM      4  CA  TRP A   3       5.ois   not  parsed
TER
"""


class TestParsePDB:
    def test_read(self, tmp_path):
        f = tmp_path / "x.pdb"
        f.write_text(
            "ATOM      1  CA  ALA A   1      11.639   6.071  -5.147  1.00"
            "  0.00           C\n"
            "ATOM      2  CA  GLY A   2       8.304   5.024  -4.020  1.00"
            "  0.00           C\n"
            "TER\n")
        ok, s = __import__(
            "deepblast_jax.data.parse_pdb", fromlist=["readPDB"]
        ).readPDB(str(f))
        assert ok
        assert s.seq == "AG"
        assert s.CA.shape == (2, 3)
        assert s.first_resnum == 1


TM2021_BLOCK = """
 *********************************************************************
 * TM-align (Version 20210224): protein structure alignment          *
 * References: Y Zhang, J Skolnick. Nucl Acids Res 33, 2302-9 (2005) *
 * Please email comments and suggestions to yangzhanglab@umich.edu   *
 *********************************************************************

Name of Chain_1: /x/q.pdb (to be superimposed onto Chain_2)
Name of Chain_2: /x/t.pdb
Length of Chain_1: 6 residues
Length of Chain_2: 5 residues

Aligned length= 5, RMSD=   1.89, Seq_ID=n_identical/n_aligned= 0.050
TM-score= 0.46204 (if normalized by length of Chain_1, i.e., LN=6, d0=6.35)
TM-score= 0.53755 (if normalized by length of Chain_2, i.e., LN=5, d0=1.04)
(You should use TM-score normalized by length of the reference structure)

(":" denotes residue pairs of d <  5.0 Angstrom, "." denotes other aligned residues)
ACDEFG
 ::.::
-CDEFG

"""


class TestTMAlignParser:
    def test_parse_block_2021(self):
        from deepblast_jax.data import parsers
        lines = [ln + "\n" for ln in TM2021_BLOCK.split("\n")]
        assert parsers.validate_block_2021(lines)
        row = parsers.parse_block_2021(lines)
        assert row[0] == "/x/q.pdb"
        assert row[2] == pytest.approx(0.46204)
        assert row[3] == pytest.approx(0.53755)
        assert row[4] == pytest.approx(1.89)
        assert row[5] == "ACDEFG"
        assert row[6] == "CDEFG"
        assert row[7] == "1::.::"

    def test_parse_file(self, tmp_path):
        from deepblast_jax.data import parsers
        # pad to the 23-line block stride of concatenated TMalign output
        lines = TM2021_BLOCK.split("\n")
        lines += [""] * (23 - len(lines))
        f = tmp_path / "tm.txt"
        f.write_text("\n".join(lines) + "\n")
        df = parsers.parse_tm_align_file(str(f))
        assert len(df) == 1
        assert df.iloc[0]["alignment"] == "1::.::"


class TestMaliParser:
    def test_read_mali(self, tmp_path):
        d = tmp_path / "pair1"
        d.mkdir()
        (d / "d1xxx.manual.ali").write_text("AC-DE\nA-GDE\n")
        from deepblast_jax.data import parsers
        df = parsers.read_mali(str(tmp_path), tool="manual")
        assert len(df) == 1
        assert df.iloc[0][0] == "ACDE"
        assert df.iloc[0][1] == "AGDE"
        assert df.iloc[0][2] == ":2" + "1" + "::"


class TestFatcat:
    def test_extract(self):
        from deepblast_jax.data import parsers
        df = parsers.parse_fatcat_ids(["d1abcA_ d2xyzB_ 1.0"])
        assert df.iloc[0]["pdb1"] == "1abc"
        assert df.iloc[0]["chain1"] == "A"
        assert df.iloc[0]["pdb2"] == "2xyz"


class TestBlastXML:
    def test_parse(self, tmp_path):
        xml = """<?xml version="1.0"?>
<BlastOutput><BlastOutput_iterations>
<Iteration>
 <Iteration_query-def>q1</Iteration_query-def>
 <Iteration_hits><Hit>
  <Hit_def>h1</Hit_def>
  <Hit_hsps><Hsp>
   <Hsp_bit-score>55.1</Hsp_bit-score>
   <Hsp_evalue>1e-10</Hsp_evalue>
   <Hsp_query-from>1</Hsp_query-from><Hsp_query-to>4</Hsp_query-to>
   <Hsp_hit-from>2</Hsp_hit-from><Hsp_hit-to>5</Hsp_hit-to>
   <Hsp_qseq>AC-D</Hsp_qseq><Hsp_hseq>ACED</Hsp_hseq>
   <Hsp_midline>AC D</Hsp_midline>
  </Hsp></Hit_hsps>
 </Hit></Iteration_hits>
</Iteration>
</BlastOutput_iterations></BlastOutput>"""
        f = tmp_path / "b.xml"
        f.write_text(xml)
        from deepblast_jax.data import parsers
        df = parsers.parse_blast_xml(str(f))
        assert len(df) == 1
        assert df.iloc[0]["query_id"] == "q1"
        assert df.iloc[0]["query_string"] == "AC-D"
        assert float(df.iloc[0]["evalue"]) == pytest.approx(1e-10)


def test_sim_make_hmm_data():
    from deepblast_jax.sim import make_hmm_data
    states, emissions, theta = make_hmm_data(T=10)
    assert states.shape == (10,)
    assert emissions.shape == (10, 2)
    assert theta.shape == (10, 3, 3)
