"""Alignment state-string algebra (reference: deepblast/dataset/utils.py).

Pure-numpy utilities shared by datasets, training and evaluation.  The
3-state alphabet is (x, m, y) = (0, 1, 2) (deepblast_jax.constants); the
TM-align textual form uses ``1`` (gap in second sequence), ``:``/``.``
(match) and ``2`` (gap in first sequence).

All semantics match the reference exactly (the test-suite ports its dense
regression cases); the only redesign is :func:`trim_gap_span`, which replaces
the reference's O(n^2) numba search (deepblast/dataset/utils.py:486-529)
with a linear sliding scan.
"""

from __future__ import annotations

import numpy as np

from deepblast_jax.constants import m, x, y

__all__ = [
    "state_f",
    "tmstate_f",
    "revstate_f",
    "states2edges",
    "states2matrix",
    "states2alignment",
    "clip_boundaries",
    "gap_mask",
    "path_distance_matrix",
    "remove_orphans",
    "trim_gap_span",
    "trim_gap",
    "pad_sequences",
    "decode_tokens",
]


def state_f(z):
    """Gapped-pair characters -> state (reference:
    deepblast/dataset/utils.py:13-19)."""
    if z[0] == "-":
        return x
    if z[1] == "-":
        return y
    return m


def tmstate_f(z):
    """TM-align state character -> state (reference:
    deepblast/dataset/utils.py:22-29)."""
    if z == "1":
        return x
    if z == "2":
        return y
    return m


def revstate_f(z):
    if z == x:
        return "1"
    if z == y:
        return "2"
    if z == m:
        return ":"


def states2edges(states):
    """State string -> list of (i, j) matrix coordinates along the path
    (reference: deepblast/dataset/utils.py:107-114).

    Coordinates are consumption-based: state ``t`` sits at row
    ``(#x + #m consumed so far) - 1`` and column ``(#y + #m so far) - 1``
    (clipped at 0), so the resulting matrix dims always equal the ungapped
    sequence lengths.  Documented deviation: the reference walks pairwise
    transitions from a fixed ``(0, 0)`` anchor, which phantom-advances the
    opposite index when the string *starts* with a gap run — its own
    Malidup fixture then yields an (81, 82) matrix for an 81/81 pair
    (dataset/tests/test_dataset.py:60-70 hard-codes the inconsistent
    shape).  Interior transitions are identical."""
    states = np.asarray(list(states))
    known = (states == x) | (states == m) | (states == y)
    if not known.all():
        bad = states[~known][0]
        raise ValueError(f"Unknown state code {bad!r} in state string.")
    ci = np.maximum(np.cumsum((states == x) | (states == m)) - 1, 0)
    cj = np.maximum(np.cumsum((states == y) | (states == m)) - 1, 0)
    return list(zip(ci.tolist(), cj.tolist()))


def states2matrix(states, sparse=False):
    """State string -> dense 0/1 alignment matrix
    (reference: deepblast/dataset/utils.py:117-134)."""
    coords = states2edges(states)
    rows, cols = np.array(coords).T
    N, M = rows.max() + 1, cols.max() + 1
    mat = np.zeros((N, M))
    mat[rows, cols] = 1.0
    if sparse:
        from scipy.sparse import coo_matrix
        return coo_matrix((np.ones(len(coords)), (rows, cols)),
                          shape=(N, M))
    return mat


def states2alignment(states, X: str, Y: str):
    """State string -> gapped sequence pair, with length validation
    (reference: deepblast/dataset/utils.py:137-181)."""
    if isinstance(states, str):
        states = np.array([tmstate_f(s) for s in states])
    states = np.asarray(states)
    sx = int(np.sum(states == x) + np.sum(states == m))
    sy = int(np.sum(states == y) + np.sum(states == m))
    if sx != len(X):
        raise ValueError(
            f"The state string length {sx} does not match "
            f"the length of sequence {len(X)}.\n"
            f"SequenceX: {X}\nSequenceY: {Y}\nStates: {states}\n")
    if sy != len(Y):
        raise ValueError(
            f"The state string length {sy} does not match "
            f"the length of sequence {len(Y)}.\n"
            f"SequenceX: {X}\nSequenceY: {Y}\nStates: {states}\n")
    ax, ay = [], []
    i = j = 0
    for s in states:
        if s == x:
            ax.append(X[i]); ay.append("-"); i += 1
        elif s == y:
            ax.append("-"); ay.append(Y[j]); j += 1
        elif s == m:
            ax.append(X[i]); ay.append(Y[j]); i += 1; j += 1
        else:
            raise ValueError(f"{s} is not recognized")
    return "".join(ax), "".join(ay)


def clip_boundaries(X, Y, A, st):
    """Trim leading/trailing gap states from an alignment
    (reference: deepblast/dataset/utils.py:41-57)."""
    A = list(A)
    if A[0] == m:
        first = 0
    else:
        first = A.index(m)
    if A[-1] == m:
        last = len(A)
    else:
        last = len(A) - A[::-1].index(m)
    gx, gy = states2alignment(np.array(A), X, Y)
    X_ = gx[first:last].replace("-", "")
    Y_ = gy[first:last].replace("-", "")
    return X_, Y_, A[first:last], st[first:last]


def gap_mask(states: str, sparse=False):
    """Mask of confident (``:``) alignment cells along the path
    (reference: deepblast/dataset/utils.py:393-409).  Cell (0, 0) is always
    kept, mirroring the reference's ``idx[0] = 1``."""
    st = np.array([tmstate_f(s) for s in states])
    coords = np.array(states2edges(st))
    keep = np.array(list(states)) == ":"
    keep[0] = True
    rows, cols = coords.T
    N, M = rows.max() + 1, cols.max() + 1
    mat = np.zeros((N, M), dtype=bool)
    mat[rows[keep], cols[keep]] = True
    if sparse:
        from scipy.sparse import coo_matrix
        return coo_matrix(mat)
    return mat


def path_distance_matrix(pi):
    """Distance from every cell to the nearest path cell
    (reference: deepblast/dataset/utils.py:315-339)."""
    pi = np.asarray(pi)
    N = pi[:, 0].max() + 1
    M = pi[:, 1].max() + 1
    try:
        from scipy.spatial import cKDTree
        xs, ys = np.arange(N), np.arange(M)
        coords = np.dstack(np.meshgrid(xs, ys)).reshape(-1, 2)
        d, _ = cKDTree(pi).query(coords)
        out = np.zeros((N, M))
        out[coords[:, 0], coords[:, 1]] = d
        return out
    except ImportError:
        gi = np.arange(N)[:, None, None]
        gj = np.arange(M)[None, :, None]
        d2 = (gi - pi[None, None, :, 0]) ** 2 + (gj - pi[None, None, :, 1]) ** 2
        return np.sqrt(d2.min(axis=-1).astype(float))


def _window(seq, n):
    for i in range(len(seq) - n + 1):
        yield tuple(seq[i:i + n])


def _replace_orphan(w, s):
    i = len(w) // 2
    sw = "".join(w)
    if w[i] == ":" and (("1" * s in sw[:i] and "1" * s in sw[i:])
                        or ("2" * s in sw[:i] and "2" * s in sw[i:])):
        return ["1", "2"]
    return [w[i]]


def remove_orphans(states: str, threshold: int = 11) -> str:
    """Replace matches orphaned inside long gaps with gap pairs
    (reference: deepblast/dataset/utils.py:435-473)."""
    wins = list(_window(states, threshold))
    out = []
    for w in wins:
        out.extend(_replace_orphan(w, threshold // 2))
    out = list(states[:threshold // 2]) + out
    out += list(states[-threshold // 2 + 1:])
    return "".join(out)


def trim_gap_span(is_match, k=10):
    """Longest half-open span ``[i, j)`` of the alignment containing no run
    of ``k`` consecutive gaps.  Linear-time redesign of the reference's
    O(n^2) numba search (deepblast/dataset/utils.py:486-529)."""
    is_match = np.asarray(is_match).astype(bool)
    best_i = best_j = 0
    start = 0
    run = 0
    for idx, v in enumerate(is_match):
        run = 0 if v else run + 1
        if run >= k:
            # any window containing positions [idx-k+1, idx] is invalid:
            # it must start after the first gap of the run
            start = idx - k + 2
        if idx + 1 - start > best_j - best_i:
            best_i, best_j = start, idx + 1
    return best_i, best_j


def trim_gap(df_row, k=10):
    """Trim a TM-align pair record to its longest span without ``k``
    consecutive gaps (reference: deepblast/dataset/utils.py:532-555).
    ``df_row`` is any mapping with ``chain1``, ``chain2``, ``alignment``."""
    aln = df_row["alignment"]
    is_match = np.array(list(aln)) == ":"
    if "0" * k not in "".join(map(str, is_match.astype(int))):
        return dict(df_row)
    i, j = trim_gap_span(is_match, k)
    states = np.array([tmstate_f(s) for s in aln])
    ax, ay = states2alignment(states, df_row["chain1"], df_row["chain2"])
    out = dict(df_row)
    out["chain1"] = ax[i:j].replace("-", "")
    out["chain2"] = ay[i:j].replace("-", "")
    out["alignment"] = aln[i:j]
    return out


def pad_sequences(seqs, pad_value=0, dtype=None):
    """Stack variable-length 1-D arrays into a padded matrix + lengths —
    the static-shape replacement for PackedSequence
    (reference: deepblast/dataset/utils.py:214-251)."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(lengths.max()) if len(seqs) else 0
    dtype = dtype or np.asarray(seqs[0]).dtype
    out = np.full((len(seqs), L), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lengths


def decode_tokens(codes, vocab):
    """Token ids -> string given a token->id vocab
    (reference: deepblast/dataset/utils.py:195-210)."""
    inv = {v: k for k, v in vocab.items()}
    return "".join(inv[int(c)] for c in codes).replace("▁", "")
