"""Built-in Kabsch-Sander secondary-structure assignment
(deepblast_jax/data/dssp.py) and the get_mali_structure_stats corpus
helper (reference: deepblast/dataset/parse_mali.py:113-161 — Bio.PDB +
mkdssp there; self-contained here).

Oracles are ideal geometries from the NeRF backbone builder: canonical
helix dihedrals must classify as H/G/I, a lone extended strand as coil,
and rigid antiparallel strand placements (found by energy search, frozen
here) as E (ladder) / B (isolated bridge).
"""

import os

import numpy as np

from deepblast_jax.data.dssp import (
    assign_secondary_structure,
    build_backbone,
    hbond_matrix,
    place_amide_hydrogens,
    read_backbone,
    secondary_structure_counts,
)
from deepblast_jax.data.parsers import get_mali_structure_stats


def test_alpha_helix_is_H():
    co = build_backbone([(-57.0, -47.0)] * 16)
    ss = assign_secondary_structure(co)
    assert set(ss[1:-1]) == {"H"}, ss


def test_310_helix_is_G():
    co = build_backbone([(-49.0, -26.0)] * 14)
    ss = assign_secondary_structure(co)
    assert set(ss[1:-1]) == {"G"}, ss


def test_pi_helix_is_I():
    co = build_backbone([(-55.0, -70.0)] * 14)
    ss = assign_secondary_structure(co)
    assert set(ss[1:-1]) == {"I"}, ss


def test_lone_strand_is_coil():
    co = build_backbone([(-139.0, 135.0)] * 10)
    assert set(assign_secondary_structure(co)) == {"-"}


def _two_strands(dx, dy, dz, L=8):
    """Two ideal antiparallel strands: the second is the first rotated
    180 deg about y and rigidly translated (separate chain segments via
    a residue-numbering gap)."""
    s1 = build_backbone([(-139.0, 135.0)] * L)
    R = np.diag([-1.0, 1.0, -1.0])
    x0 = s1["CA"][-1][0] + s1["CA"][0][0]
    s2 = {k: (v @ R.T) + np.array([x0 + dx, dy, dz]) for k, v in s1.items()}
    co = {k: np.concatenate([s1[k], s2[k]]) for k in s1}
    nums = np.concatenate([np.arange(L), np.arange(100, 100 + L)])
    return co, nums


def test_antiparallel_ladder_is_E():
    co, nums = _two_strands(1.0, 3.0, 0.9)
    ss = assign_secondary_structure(co, resnums=nums)
    assert ss.count("E") >= 4, ss
    assert "B" not in ss


def test_isolated_bridge_is_B():
    co, nums = _two_strands(1.2, 3.0, 0.2)
    ss = assign_secondary_structure(co, resnums=nums)
    assert ss.count("B") >= 2, ss
    assert "E" not in ss


def test_helix_hbond_pattern_is_i_to_i4():
    """The alpha helix's H-bonds are CO(i) <- NH(i+4) specifically."""
    co = build_backbone([(-57.0, -47.0)] * 12)
    L = 12
    breaks = np.zeros(L - 1, bool)
    H = place_amide_hydrogens(co, breaks)
    hb = hbond_matrix(co, H)
    i, j = np.nonzero(hb)
    assert len(i) >= 6
    assert np.all(j - i == 4), (i, j)


def test_chain_break_splits_turns():
    """A numbering gap mid-helix removes helix assignments spanning it."""
    co = build_backbone([(-57.0, -47.0)] * 16)
    nums = np.concatenate([np.arange(8), np.arange(50, 58)])
    ss = assign_secondary_structure(co, resnums=nums)
    full = assign_secondary_structure(co)
    assert full.count("H") > ss.count("H")


def _write_pdb(path, coords, resnames=None):
    atoms = [("N", " N  "), ("CA", " CA "), ("C", " C  "), ("O", " O  ")]
    L = coords["CA"].shape[0]
    resnames = resnames or ["ALA"] * L
    serial = 1
    with open(path, "w") as f:
        for i in range(L):
            for key, label in atoms:
                x, y, z = coords[key][i]
                f.write(f"ATOM  {serial:5d} {label} {resnames[i]} A"
                        f"{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                        f"  1.00  0.00           {label.strip()[0]}\n")
                serial += 1
        f.write("TER\nEND\n")


def test_read_backbone_roundtrip(tmp_path):
    co = build_backbone([(-57.0, -47.0)] * 10)
    p = tmp_path / "helix.manual.pdb"
    _write_pdb(str(p), co)
    coords, names, nums = read_backbone(str(p))
    assert names == ["ALA"] * 10
    np.testing.assert_allclose(coords["CA"], co["CA"], atol=1e-3)
    counts, length = secondary_structure_counts(str(p))
    assert length == 10
    assert counts["H"] >= 6


def test_proline_has_no_amide_donor():
    """Prolines have no amide H: every H-bond with a PRO donor vanishes
    (the helix assignment itself survives one missing turn — the
    minimal-helix rule bridges it, as in DSSP)."""
    co = build_backbone([(-57.0, -47.0)] * 12)
    names = ["ALA"] * 12
    names[6] = "PRO"
    L = 12
    breaks = np.zeros(L - 1, bool)
    hb_ala = hbond_matrix(co, place_amide_hydrogens(co, breaks))
    hb_pro = hbond_matrix(co, place_amide_hydrogens(co, breaks, names))
    assert hb_ala[2, 6] and not hb_pro[2, 6]
    assert not hb_pro[:, 6].any()          # no bonds with donor 6
    removed = hb_ala & ~hb_pro
    assert set(np.nonzero(removed)[1]) == {6}  # nothing else changed


def test_get_mali_structure_stats(tmp_path):
    """Reference row shape (parse_mali.py:140-151): x<class> counts +
    pdb/path/xlen, one row per manual PDB; non-manual files skipped."""
    d1 = tmp_path / "pair1"
    d1.mkdir()
    _write_pdb(str(d1 / "d1a2b.manual.pdb"),
               build_backbone([(-57.0, -47.0)] * 12))
    _write_pdb(str(d1 / "d1a2b.dali.pdb"),
               build_backbone([(-57.0, -47.0)] * 12))

    df = get_mali_structure_stats(str(tmp_path))
    assert len(df) == 1
    row = df.iloc[0]
    assert row["pdb"] == "d1a2b"
    assert row["xlen"] == 12
    assert row["xH"] >= 8
    assert row["path"].endswith("d1a2b.manual.pdb")
