"""HMM-simulator fixture tests (VERDICT r4 item 6).

The reference ships a Pfam zf-C2H2 profile HMM (data/zf-C2H2.hmm) and an
alignment fixture (deepblast/tests/data/zf-C2H2-alignments.txt); its
``sim.hmm_alignments`` shells out to ``hmmemit -a``.  hmmer is absent in
this environment, so these tests run the full MSA-parse path
(``_gen_alignments`` / ``hmm_alignments`` / the CLI) against a vendored
canned ``hmmemit -a`` Stockholm output (tests/data/zf-C2H2-hmmemit.sto —
rows taken from the reference's alignment fixture, lowercased inserts and
#=GR annotation rows included to exercise the line filtering), with the
subprocess mocked.  The profile HMM itself (tests/data/zf-C2H2.hmm, Pfam
PF00096.27) is vendored as a declared reference data fixture.

parse_alignment goldens come straight from the reference fixture rows
(reference: deepblast/tests/data/zf-C2H2-alignments.txt).
"""

import io
import os
import random

import numpy as np
import pandas as pd
import pytest

from deepblast_jax import sim

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
HMM = os.path.join(DATA, "zf-C2H2.hmm")
STO = os.path.join(DATA, "zf-C2H2-hmmemit.sto")

# rows of the reference's zf-C2H2-alignments.txt (gapped pair -> states)
GOLDEN = [
    ("MQCP...ICKKDYS....TYSHLKKHMSR..H",
     "HVCKISYYCDEAYGKNDGSSYGLVEHLEKENH",
     "::::111:::::::1111:::::::::::11:"),
    ("HVCKISYYCDEAYGKNDGSSYGLVEHLEKENH",
     "MQCP...ICKKDYS....TYSHLKKHMSR..H",
     "::::222:::::::2222:::::::::::22:"),
    # dual-gap MSA columns carry no state (reference _state_f returns ""
    # for '.','.' — deepblast/sim.py:24-33), so the 9 shared-dot columns
    # of this pair drop and 23 matches remain
    ("FKCD...NCKKVYD....SYKSMKEHLNA..H",
     "MQCP...ICKKDYS....TYSHLKKHMSR..H",
     ":" * 23),
]


@pytest.mark.parametrize("ai,aj,states", GOLDEN)
def test_parse_alignment_reference_goldens(ai, aj, states):
    xx, yy, s = sim.parse_alignment(ai, aj)
    assert s == states
    assert xx == ai.replace(".", "")
    assert yy == aj.replace(".", "")


class _FakeProc:
    """Popen stand-in returning the canned hmmemit -a output."""

    def __init__(self, cmd, **kw):
        assert "hmmemit -a" in cmd and "zf-C2H2.hmm" in cmd, cmd
        with open(STO, "rb") as f:
            self.stdout = io.BytesIO(f.read())
        self.returncode = 0

    def wait(self):
        return 0


def test_hmm_alignments_parses_canned_msa(monkeypatch):
    monkeypatch.setattr(sim, "Popen", _FakeProc)
    random.seed(0)
    rows = sim.hmm_alignments(7, seed=0, n_alignments=12, hmmfile=HMM)
    assert len(rows) == 12 and all(len(r) == 8 for r in rows)
    for row in rows:
        n1, n2, _, _, _, yy, xx, s = row
        assert n1.startswith("ZF-C2H2-SAMPLE")
        assert n2.startswith("ZF-C2H2-SAMPLE")
        # ungapped sequences; states use the reference 3-char alphabet
        assert "." not in xx and "-" not in xx
        assert "." not in yy and "-" not in yy
        assert set(s) <= {":", "1", "2"}
        # state-string algebra consistency: ':'+ '2' consumes x,
        # ':' + '1' consumes y
        assert s.count(":") + s.count("2") == len(xx)
        assert s.count(":") + s.count("1") == len(yy)
        # insert residues arrive uppercased
        assert xx == xx.upper() and yy == yy.upper()


def test_hmm_alignments_feeds_tmalign_dataset(monkeypatch, tmp_path):
    """End-to-end: simulator TSV -> TMAlignDataset item (the reference's
    simulated-training flow, deepblast/sim.py -> dataset.py)."""
    monkeypatch.setattr(sim, "Popen", _FakeProc)
    random.seed(1)
    rows = sim.hmm_alignments(7, seed=0, n_alignments=6, hmmfile=HMM)
    tsv = tmp_path / "sim.tab"
    from deepblast_jax.data.dataset import TMAlignDataset, write_pairs
    write_pairs(rows, tsv)
    ds = TMAlignDataset(str(tsv))
    assert len(ds) == 6
    item = ds[0]
    x, y, aln = item["x"], item["y"], item["aln"]
    assert np.asarray(aln).shape == (len(np.asarray(x)),
                                     len(np.asarray(y)))
    assert np.asarray(aln).sum() > 0


def test_cli_hmm_simulate_with_canned_output(monkeypatch, tmp_path):
    monkeypatch.setattr(sim, "Popen", _FakeProc)
    from deepblast_jax.cli import hmm_simulate
    out = tmp_path / "sim.tab"
    rc = hmm_simulate.main([
        "--hmmfile", HMM, "--n-sequences", "7", "--n-alignments", "5",
        "--seed", "0", "--output-file", str(out)])
    assert rc == 0
    df = pd.read_csv(out, sep="\t", header=None)
    assert df.shape == (5, 8)


def test_vendored_hmm_is_a_profile_hmm():
    """The vendored fixture is the real Pfam zf-C2H2 profile (what a user
    would pass to hmmemit)."""
    with open(HMM) as f:
        head = f.read(400)
    assert head.startswith("HMMER3/")
    assert "NAME  zf-C2H2" in head
    assert "ACC   PF00096" in head
    assert "LENG  23" in head
