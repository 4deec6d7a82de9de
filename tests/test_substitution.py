"""BLOSUM62 substitution module + pair simulator (quality-eval corpus
generator, deepblast_jax/data/substitution.py)."""

import numpy as np

from deepblast_jax.data.state_utils import states2alignment, tmstate_f
from deepblast_jax.data.substitution import (
    AA20,
    BLOSUM62,
    BLOSUM62_FREQS,
    blosum62_matrix,
    simulate_blosum_pairs,
    substitution_theta,
)


def test_blosum62_matrix_properties():
    assert BLOSUM62.shape == (20, 20)
    np.testing.assert_array_equal(BLOSUM62, BLOSUM62.T)   # symmetric
    # canonical entries
    i = {a: k for k, a in enumerate(AA20)}
    assert BLOSUM62[i["W"], i["W"]] == 11
    assert BLOSUM62[i["A"], i["A"]] == 4
    assert BLOSUM62[i["E"], i["Q"]] == 2
    assert abs(BLOSUM62_FREQS.sum() - 1.0) < 1e-12


def test_substitution_theta():
    th = substitution_theta("AW", "WA")
    i = {a: k for k, a in enumerate(AA20)}
    assert th.shape == (2, 2)
    assert th[0, 1] == BLOSUM62[i["A"], i["A"]]
    assert th[1, 0] == BLOSUM62[i["W"], i["W"]]
    assert th[0, 0] == BLOSUM62[i["A"], i["W"]]


def test_blosum62_matrix_reindex():
    m = blosum62_matrix("WAX")
    assert m[0, 0] == 11 and m[1, 1] == 4
    assert np.isclose(m[0, 2], BLOSUM62.mean())   # unknown residue


def test_simulated_pairs_are_consistent():
    """Sequences, lengths, and state strings agree (states2alignment
    accepts every pair), and the frame is TMAlignDataset-shaped."""
    df = simulate_blosum_pairs(32, seed=3)
    assert df.shape[1] == 8
    for _, row in df.iterrows():
        x, y, st = row.iloc[5], row.iloc[6], row.iloc[7]
        assert len(x) == st.count(":") + st.count("1")
        assert len(y) == st.count(":") + st.count("2")
        states = [tmstate_f(c) for c in st]
        states2alignment(np.asarray(states), x, y)   # raises on mismatch


def test_simulated_matches_score_above_background():
    """Match columns sampled from the BLOSUM62 joint have positive mean
    log-odds; random pairs score negative — the corpus carries signal."""
    df = simulate_blosum_pairs(64, seed=4)
    i = {a: k for k, a in enumerate(AA20)}
    scores = []
    for _, row in df.iterrows():
        x, y, st = row.iloc[5], row.iloc[6], row.iloc[7]
        xi, yi = 0, 0
        for c in st:
            if c == ":":
                scores.append(BLOSUM62[i[x[xi]], i[y[yi]]])
                xi += 1
                yi += 1
            elif c == "1":
                xi += 1
            else:
                yi += 1
    rng = np.random.default_rng(0)
    rand = BLOSUM62[rng.choice(20, 5000, p=BLOSUM62_FREQS)[:, None],
                    rng.choice(20, 5000, p=BLOSUM62_FREQS)[None, :]]
    assert np.mean(scores) > 0.5
    assert np.mean(rand) < 0.0


def test_trainable_dataset_roundtrip():
    from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
    df = simulate_blosum_pairs(8, seed=5)
    ds = TMAlignDataset(df, tokenizer=ProtT5Tokenizer())
    assert len(ds) == 8
    item = ds[0]
    assert item["aln"].shape == (len(item["x"]), len(item["y"]))


def test_simulate_hmm_pairs_frame_valid():
    """The HMM-context generator emits the same 8-column frame contract
    as simulate_blosum_pairs: state strings advance x on ':'/'1' and y
    on ':'/'2' to exactly the emitted lengths, and it feeds
    TMAlignDataset unchanged."""
    from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
    from deepblast_jax.data.substitution import simulate_hmm_pairs
    df = simulate_hmm_pairs(16, seed=7)
    for _, row in df.iterrows():
        x, y, st = row.iloc[5], row.iloc[6], row.iloc[7]
        assert len(x) == sum(c in ":1" for c in st)
        assert len(y) == sum(c in ":2" for c in st)
    ds = TMAlignDataset(df, tokenizer=ProtT5Tokenizer())
    item = ds[0]
    assert item["aln"].shape == (len(item["x"]), len(item["y"]))


def test_hmm_sequences_carry_context():
    """Neighbouring residues must carry mutual information (the whole
    point of the HMM corpus: a language model can beat the unigram floor
    on it; on the i.i.d. corpus it cannot)."""
    from deepblast_jax.data.substitution import (
        AA20, sample_hmm_sequences)
    seqs = sample_hmm_sequences(400, seed=9)
    i = {a: k for k, a in enumerate(AA20)}
    uni = np.zeros(20)
    big = np.zeros((20, 20))
    for s in seqs:
        ids = np.asarray([i[c] for c in s])
        np.add.at(uni, ids, 1)
        np.add.at(big, (ids[:-1], ids[1:]), 1)
    uni = uni / uni.sum()
    big = big / big.sum()
    # mutual information of adjacent pairs, in nats
    mi = 0.0
    for a in range(20):
        for b in range(20):
            if big[a, b] > 0:
                mi += big[a, b] * np.log(big[a, b] / (uni[a] * uni[b]))
    assert mi > 0.02, mi
