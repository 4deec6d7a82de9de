"""Alignment simulation (reference: deepblast/sim.py, deepblast/utils.py:68-117).

``hmm_alignments`` shells out to HMMER's ``hmmemit`` to sample aligned pairs
from a profile HMM; :func:`simulate_pairs` draws seeded pairs with
substitutions and indels without any external binary; :func:`make_hmm_data`
produces the HMM/CRF toy potentials used in notebook examples.

Pairs are rows in the TM-align TSV layout (``dataset.TM_COLUMNS``: names,
two TM-scores, RMSD, the two chains and the alignment state string with
``:`` aligned, ``1`` a residue of chain 1 only, ``2`` one of chain 2 only);
``dataset.write_pairs`` writes them for ``deepblast-train``.
"""

from __future__ import annotations

import re
from random import randint
from subprocess import PIPE, Popen

import numpy as np

__all__ = ["hmm_alignments", "make_hmm_data", "parse_alignment",
           "simulate_pairs"]


def _genpairs(n):
    seen = set()
    xx, yy = randint(0, n - 1), randint(0, n - 1)
    while True:
        seen.add((xx, yy))
        yield (xx, yy)
        xx, yy = randint(0, n - 1), randint(0, n - 1)
        while (xx, yy) in seen and xx == yy:
            xx, yy = randint(0, n - 1), randint(0, n - 1)


def _state_f(z):
    i, j = z
    if i == "." and j == ".":
        return ""
    if i == "." and j != ".":
        return "1"
    if i != "." and j == ".":
        return "2"
    return ":"


def parse_alignment(ai, aj):
    """Pairwise rows of an MSA -> ungapped sequences + state string
    (reference: deepblast/sim.py:37-42)."""
    alignment = list(zip(ai, aj))
    states = "".join(_state_f(z) for z in alignment)
    xx = ai.replace(".", "")
    yy = aj.replace(".", "")
    return xx, yy, states


def _gen_alignments(msa, n_alignments):
    gen = _genpairs(len(msa))
    out = []
    for _ in range(n_alignments):
        i, j = next(gen)
        n1, ai = re.split(r"\s+", msa[i])
        n2, aj = re.split(r"\s+", msa[j])
        xx, yy, s = parse_alignment(
            ai.replace("-", "."), aj.replace("-", "."))
        out.append((n1, n2, 1, 1, 1, yy, xx, s))
    return out


def hmm_alignments(n, seed, n_alignments, hmmfile):
    """Sample an MSA with ``hmmemit`` and pair rows into alignments
    (reference: deepblast/sim.py:59-74).  Requires the hmmer binary."""
    cmd = f"hmmemit -a -N {n} --seed {seed} {hmmfile}"
    proc = Popen(cmd, shell=True, stdout=PIPE)
    proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(
            "hmmemit failed — is the hmmer suite installed?")
    lines = [ln.decode().rstrip().upper() for ln in proc.stdout.readlines()]
    lines = [ln for ln in lines
             if len(ln) and ln[0] not in {" ", "#", "/"}]
    return _gen_alignments(lines, n_alignments)


_AMINO = np.array(list("ACDEFGHIKLMNPQRSTVWY"))


def simulate_pairs(n, seed=0, min_len=64, max_len=512, p_indel=0.05,
                   p_sub=0.3):
    """``n`` seeded homologous pairs with chain lengths in
    ``[min_len, max_len]``.

    Chain 1 is a random protein of a length drawn uniformly from the range;
    chain 2 follows it with substitutions (rate ``p_sub`` per aligned
    residue) and insertions on either side (rate ``p_indel`` each per
    column).  Returns TM-align TSV rows (see the module docstring)."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        target = int(rng.integers(min_len, max_len + 1))
        c1, c2, states = [], [], []
        while len(c1) < target:
            u = rng.random()
            if u < p_indel or len(c2) >= max_len:
                c1.append(rng.choice(_AMINO))
                states.append("1")
            elif u < 2 * p_indel and len(c2) < max_len:
                c2.append(rng.choice(_AMINO))
                states.append("2")
            else:
                a = rng.choice(_AMINO)
                c1.append(a)
                c2.append(rng.choice(_AMINO) if rng.random() < p_sub else a)
                states.append(":")
        rows.append([f"sim{k}a", f"sim{k}b", 0.9, 0.9, 1.0,
                     "".join(c1), "".join(c2), "".join(states)])
    return rows


def _sample_hmm(transition_matrix, means, covs, start_state, n_samples,
                random_state):
    n_states = covs.shape[0]
    n_features = covs.shape[1]
    states = np.zeros(n_samples, dtype=int)
    emissions = np.zeros((n_samples, n_features))
    prev = start_state
    for i in range(n_samples):
        # NOTE: the reference indexes columns (deepblast/utils.py:79-80),
        # which are not normalised and make numpy raise — its make_data is
        # dead code upstream.  Rows are the from-state distributions.
        state = random_state.choice(n_states, p=transition_matrix[prev])
        emissions[i] = random_state.multivariate_normal(
            means[state], covs[state])
        states[i] = state
        prev = state
    return emissions, states


def make_hmm_data(T=20):
    """HMM sample + CRF potentials toy problem
    (reference: deepblast/utils.py:85-117)."""
    from scipy.stats import multivariate_normal
    random_state = np.random.RandomState(0)
    d, e = 0.2, 0.1
    transition_matrix = np.array(
        [[1 - 2 * d, d, d], [1 - e, e, 0], [1 - e, 0, e]])
    means = np.array([[0, 0], [10, 0], [5, -5]])
    covs = np.array([[[1, 0], [0, 1]], [[.2, 0], [0, .3]],
                     [[2, 0], [0, 1]]])
    emissions, states = _sample_hmm(
        transition_matrix, means, covs, 0, T, random_state)
    ll = np.concatenate([
        multivariate_normal(mu, cov).logpdf(emissions)[:, None]
        for mu, cov in zip(means, covs)], axis=1)
    with np.errstate(divide="ignore"):   # structural zeros -> -inf
        theta = ll[:, :, None] + np.log(transition_matrix)[None]
    return states, emissions, theta
