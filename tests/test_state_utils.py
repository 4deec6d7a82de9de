"""State-string algebra tests — ports the semantics of the reference's
densest suite (reference: deepblast/dataset/tests/test_utils.py)."""

import numpy as np
import pytest

from deepblast_jax.constants import m, x, y
from deepblast_jax.data import state_utils as su


def S(txt):
    return [su.tmstate_f(c) for c in txt]


class TestStateF:
    def test_state_f(self):
        assert su.state_f(("A", "B")) == m
        assert su.state_f(("-", "B")) == x
        assert su.state_f(("A", "-")) == y

    def test_tmstate_roundtrip(self):
        for s, c in [(x, "1"), (m, ":"), (y, "2")]:
            assert su.tmstate_f(c) == s
            assert su.revstate_f(s) == c
        assert su.tmstate_f(".") == m


class TestStates2Edges:
    def test_match_run(self):
        assert su.states2edges([m, m, m]) == [(0, 0), (1, 1), (2, 2)]

    def test_x_then_m(self):
        # leading-gap runs consume only their own tape: the first m after
        # an x-run sits at column 0 (consumption-based coords; the
        # reference's transition walk phantom-advanced the column — see
        # states2edges docstring)
        assert su.states2edges([x, x, m]) == [(0, 0), (1, 0), (2, 0)]

    def test_y_then_m(self):
        assert su.states2edges([y, y, m]) == [(0, 0), (0, 1), (0, 2)]

    def test_mixed(self):
        assert su.states2edges([m, x, y, m]) == [
            (0, 0), (1, 0), (1, 1), (2, 2)]

    def test_invalid_state_code(self):
        with pytest.raises(ValueError):
            su.states2edges([m, 7])


class TestStates2Matrix:
    def test_diagonal(self):
        mat = su.states2matrix([m, m, m])
        np.testing.assert_array_equal(mat, np.eye(3))

    def test_with_gaps(self):
        mat = su.states2matrix([m, x, m])
        expected = np.array([[1, 0], [1, 0], [0, 1]])
        np.testing.assert_array_equal(mat, expected)

    def test_sparse(self):
        sp = su.states2matrix([m, m], sparse=True)
        assert sp.shape == (2, 2)


class TestStates2Alignment:
    def test_simple(self):
        ax, ay = su.states2alignment(np.array([m, m, m]), "ABC", "DEF")
        assert ax == "ABC" and ay == "DEF"

    def test_gaps(self):
        ax, ay = su.states2alignment(np.array([x, m, m]), "ABC", "EF")
        assert ax == "ABC" and ay == "-EF"
        ax, ay = su.states2alignment(np.array([y, m, m]), "BC", "DEF")
        assert ax == "-BC" and ay == "DEF"

    def test_string_input(self):
        ax, ay = su.states2alignment("1::", "ABC", "EF")
        assert ax == "ABC" and ay == "-EF"

    def test_length_validation(self):
        with pytest.raises(ValueError):
            su.states2alignment(np.array([m, m]), "ABC", "DE")
        with pytest.raises(ValueError):
            su.states2alignment(np.array([m, m, m]), "ABC", "DE")


class TestClipBoundaries:
    def test_no_clip_needed(self):
        X, Y, A, st = su.clip_boundaries("ABC", "DEF", S("::."), "::.")
        assert X == "ABC" and Y == "DEF"

    def test_clip_leading_gaps(self):
        st = "11::"
        A = S(st)
        X, Y, A_, st_ = su.clip_boundaries("ABCD", "EF", A, st)
        assert X == "CD" and Y == "EF"
        assert st_ == "::"

    def test_clip_trailing_gaps(self):
        st = "::22"
        A = S(st)
        X, Y, A_, st_ = su.clip_boundaries("AB", "EFGH", A, st)
        assert X == "AB" and Y == "EF"
        assert st_ == "::"


class TestGapMask:
    def test_all_matches(self):
        g = su.gap_mask(":::")
        np.testing.assert_array_equal(g, np.eye(3, dtype=bool))

    def test_mismatch_dots_masked(self):
        g = su.gap_mask(":.:")
        expected = np.eye(3, dtype=bool)
        expected[1, 1] = False
        np.testing.assert_array_equal(g, expected)

    def test_gaps_masked(self):
        g = su.gap_mask(":1:")
        assert g[0, 0]
        assert not g[1, 0]
        assert g[2, 1]


class TestPathDistance:
    def test_on_path_zero(self):
        pi = [(0, 0), (1, 1), (2, 2)]
        P = su.path_distance_matrix(pi)
        assert P.shape == (3, 3)
        np.testing.assert_allclose(np.diag(P), 0)
        np.testing.assert_allclose(P[0, 2], np.sqrt(2))


class TestTrimGap:
    def test_span_no_gap(self):
        i, j = su.trim_gap_span(np.ones(10, bool), k=3)
        assert (i, j) == (0, 10)

    def test_span_with_run(self):
        # matches, then 4 gaps, then matches: k=3 forces a split
        v = np.array([1, 1, 0, 0, 0, 0, 1, 1, 1], bool)
        i, j = su.trim_gap_span(v, k=3)
        # longest valid window has no 3 consecutive gaps
        assert (j - i) == 5
        sub = v[i:j].astype(int)
        assert "000" not in "".join(map(str, sub))

    def test_trim_gap_row(self):
        row = dict(chain1="AAA", chain2="BBBBBBB",
                   alignment=":" + "2" * 4 + "::")
        out = su.trim_gap(row, k=3)
        assert out["alignment"] == "22::"
        assert out["chain1"] == "AA"
        assert out["chain2"] == "BBBB"


class TestRemoveOrphans:
    def test_orphan_replaced(self):
        states = "1" * 6 + ":" + "1" * 6
        out = su.remove_orphans(states, threshold=11)
        assert ":" not in out
        # the orphaned match becomes a gap pair (reference edge-padding is
        # asymmetric by one, reproduced here)
        assert out.count("2") == 1

    def test_no_orphan(self):
        states = ":::" + "1" * 3 + ":::"
        assert su.remove_orphans(states, 5).count(":") == 6


class TestPadSequences:
    def test_roundtrip(self):
        seqs = [np.arange(3), np.arange(5), np.arange(2)]
        padded, lens = su.pad_sequences(seqs, pad_value=-1)
        assert padded.shape == (3, 5)
        np.testing.assert_array_equal(lens, [3, 5, 2])
        np.testing.assert_array_equal(padded[0], [0, 1, 2, -1, -1])


class TestAlphabet:
    def test_uniprot21_synonyms(self):
        from deepblast_jax.data import Uniprot21
        a = Uniprot21()
        enc = a.encode(b"OUBZ")
        np.testing.assert_array_equal(enc, [11, 4, 20, 20])
        enc = a.encode(b"ARNDC")
        np.testing.assert_array_equal(enc, [0, 1, 2, 3, 4])

    def test_tokenizer_pad_ends(self):
        from deepblast_jax.data import UniprotTokenizer
        t = UniprotTokenizer(pad_ends=True)
        z = t("AR")
        np.testing.assert_array_equal(z, [20, 0, 1, 20])

    def test_prot_t5_tokenizer(self):
        from deepblast_jax.data import ProtT5Tokenizer
        t = ProtT5Tokenizer()
        ids, mask = t("AU")  # U -> X
        assert ids.shape == (2,)
        assert ids[1] == t.vocab["X"]
        assert t.decode(ids) == "AX"
