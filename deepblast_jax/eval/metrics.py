"""Structural alignment quality metrics (reference: deepblast/metrics.py).

Clean re-implementation of the reference's Kabsch superposition and
fragment-seeded iterative MaxSub / TM-score search (Mammoth-style), plus the
``standard_metrics`` table (TM, PSI family, RMS family, sequence identities)
and the end-to-end :func:`process_alignment` PDB-pair driver used for the
Malidup/Malisam benchmark (reference README figure ``imgs/malidup.png``).

Differences from the reference (documented):
* all inner atom loops are vectorised numpy;
* the run-length counter used for aPSI/oPSI/rPSI is reset between the three
  computations (the reference carries it over, deepblast/metrics.py:443-466);
* no debug printing.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from deepblast_jax.data.parse_pdb import readPDB

__all__ = [
    "kabsch",
    "kabsch_template_alignment",
    "tm_d0",
    "tm_score_from_dev2",
    "FR_TM_maxsub_score",
    "standard_metrics",
    "parse_alignment_string",
    "process_alignment",
    "MAXSUB_TM",
    "Metrics",
]

MAXSUB_TM = namedtuple(
    "MAXSUB_TM", ("score", "rotation", "alignment", "alignedRMS"))

Metrics = namedtuple("Metrics", [
    "TM", "PSI", "aPSI", "oPSI", "rPSI", "cRMS", "aRMS", "oRMS",
    "aSeq_ident", "oSeq_ident", "cSeq_Ident",
    "L_min", "L_aligned", "L_orientable", "L_PSI",
])


def kabsch(p1, p2):
    """Optimal rotation/translation superposing two matched point clouds.

    Returns ``(R, w, d, offset1, offset2)``; apply as
    ``(p2 - offset2) @ R.T`` to superpose onto ``p1 - offset1``
    (reference: deepblast/metrics.py:8-105, incl. the improper-rotation
    sign fix)."""
    p1 = np.asarray(p1, float)
    p2 = np.asarray(p2, float)
    offset1 = p1.mean(axis=0)
    offset2 = p2.mean(axis=0)
    a = p1 - offset1
    b = p2 - offset2
    H = a.T @ b
    V, w, U = np.linalg.svd(H)
    R = V @ U
    d = np.sign(np.linalg.det(R))
    if d == -1:
        U[-1, :] = -U[-1, :]
        R = V @ U
    return R, w, d, offset1, offset2


def kabsch_template_alignment(p0, p1, t0, t1):
    """Superpose ``p1`` onto ``p0`` using the transform fit on templates
    ``(t0, t1)`` (reference: deepblast/metrics.py:108-134)."""
    R, w, d, off0, off1 = kabsch(t0, t1)
    p0n = p0 - off0
    p1n = (p1 - off1) @ R.T
    return p0n, p1n, (R, w, d, off0, off1)


def tm_d0(L_min):
    return 1.24 * (L_min - 15) ** (1.0 / 3.0) - 1.8


def tm_score_from_dev2(dev2, L_min):
    d02 = tm_d0(L_min) ** 2
    return float(np.sum(1.0 / (1.0 + dev2 / d02)) / L_min)


def _dev2(p0a, p1a):
    return np.sum((p0a - p1a) ** 2, axis=1)


def FR_TM_maxsub_score(master_p0, master_p1, align_index,
                       FRAGSMALL=8, FRAGLARGE=12, TOL=7.0, UNIT=1.0):
    """Fragment-seeded iterative superposition search.

    For every consecutive fragment of the alignment: superpose on the
    fragment, then iteratively grow the included pair set with an expanding
    distance threshold, re-superposing after each growth step; track the
    best TM-score, the best "longest at comparable TM", and the classic
    MaxSub (most pairs under ``TOL`` RMSD) solutions
    (reference: deepblast/metrics.py:139-375).

    Returns ``(maxsub_TM, raw_TM, maxsub)`` as :data:`MAXSUB_TM` tuples.
    """
    align_index = np.asarray(align_index)
    RMSTOL = TOL * UNIT
    L_min = min(master_p0.shape[0], master_p1.shape[0])
    assert L_min > 9
    d02 = tm_d0(L_min) ** 2
    N = align_index.shape[1]
    FRAGSIZE = 7  # the reference hardcodes 7 (deepblast/metrics.py:157)
    windows = N - FRAGSIZE

    p0 = master_p0[align_index[0]]
    p1 = master_p1[align_index[1]]

    eye = np.eye(3)
    maxsub = dict(most=-1, rms=1e9 * UNIT, alignment=np.array([], int),
                  rotation=eye)
    raw = dict(score=-1.0, rotation=eye, alignment=np.arange(0),
               rms=1e9 * UNIT)
    best = dict(score=-1.0, rotation=eye, alignment=np.arange(0),
                rms=1e9 * UNIT, most=-1)
    longest = dict(score=-1.0, rotation=eye, alignment=np.arange(0),
                   rms=1e9 * UNIT, most=-1)

    jj = np.arange(N)
    for i0 in range(max(1, windows)):
        frg = np.arange(i0, min(i0 + FRAGSIZE, N))
        p0a, p1a, G = kabsch_template_alignment(p0, p1, p0[frg], p1[frg])
        dev2 = _dev2(p0a, p1a)
        tm = np.sum(1.0 / (1.0 + dev2 / d02)) / L_min
        rms = float(np.sqrt(dev2.mean()))
        if tm > raw["score"]:
            raw.update(score=tm, rotation=G, alignment=frg, rms=rms)
        if tm > best["score"]:
            best.update(score=tm, rotation=G, alignment=frg, rms=rms,
                        most=len(frg))

        included = np.zeros(N, bool)
        last_count = 0
        t = 0.0
        while t < TOL:
            t += 0.1
            dev2 = _dev2(p0a, p1a)
            in_frag = (jj - i0 >= 0) & (jj - i0 < FRAGSIZE)
            add = (~included) & ((dev2 < t * t) | in_frag)
            outside = (~included) & (~add) & (~in_frag)
            included = included | add
            count = int(included.sum())
            if count > last_count and count > 3:
                last_count = count
                idx = jj[included]
                p0a, p1a, G = kabsch_template_alignment(
                    p0, p1, p0[idx], p1[idx])
                dev2 = _dev2(p0a, p1a)
                rms = float(np.sqrt(dev2.mean()))
                if (count > maxsub["most"] and rms <= RMSTOL) or (
                        count == maxsub["most"] and rms < maxsub["rms"]):
                    maxsub.update(most=count, rms=rms, alignment=idx,
                                  rotation=G)
                tm = np.sum(1.0 / (1.0 + dev2 / d02)) / L_min
                if ((count > longest["most"] and tm > 0.97 * longest["score"])
                        or (count < longest["most"]
                            and tm > 1.02 * longest["score"])
                        or (count == longest["most"]
                            and tm > longest["score"])):
                    longest.update(score=tm, rotation=G, alignment=idx,
                                   rms=rms, most=count)
                if tm > best["score"]:
                    best.update(score=tm, rotation=G, alignment=idx,
                                rms=rms, most=count)
            else:
                # fast-forward the threshold to the nearest excluded pair
                if outside.any():
                    t = float(np.sqrt(dev2[outside].min()))
                else:
                    break

    # trade length for (nearly equal) TM score
    if longest["most"] > best["most"] and \
            longest["score"] > 0.97 * best["score"]:
        best = dict(longest)

    return (
        MAXSUB_TM(best["score"], best["rotation"], best["alignment"],
                  best["rms"]),
        MAXSUB_TM(raw["score"], raw["rotation"], raw["alignment"],
                  raw["rms"]),
        MAXSUB_TM(maxsub["most"], maxsub["rotation"], maxsub["alignment"],
                  maxsub["rms"]),
    )


def _run_psi(cols, L_min):
    """Sum of run lengths >= 4 of consecutive (gap-free) aligned columns."""
    if cols.shape[1] == 0:
        return 0.0
    total = 0
    c = 0
    n = cols.shape[1]
    for i in range(n):
        c += 1
        if i + 1 == n or np.any((cols[:, i + 1] - cols[:, i]) > 1):
            if c > 3:
                total += c
            c = 0
    return total / L_min


def standard_metrics(master_p0, master_p1, align_index, indicies=None,
                     seq0=None, seq1=None, d0=4.0, UNIT=1.0):
    """TM / PSI / RMS / identity table after superposing on ``indicies``
    (reference: deepblast/metrics.py:380-468)."""
    align_index = np.asarray(align_index)
    if indicies is None:
        indicies = np.arange(align_index.shape[1])
    indicies = np.asarray(indicies, int)
    L_min = min(master_p0.shape[0], master_p1.shape[0])
    L_aligned = align_index.shape[1]
    L_orientable = len(indicies)

    p0 = master_p0[align_index[0]]
    p1 = master_p1[align_index[1]]
    p0a, p1a, G = kabsch_template_alignment(
        p0, p1, p0[indicies], p1[indicies])
    dev2 = _dev2(p0a, p1a)

    TM = tm_score_from_dev2(dev2, L_min)
    aRMS = float(np.sqrt(dev2.sum() / L_aligned))
    oRMS = float(np.sqrt(dev2[indicies].sum() / L_orientable))

    psi_mask = np.sqrt(dev2) < (d0 * UNIT)
    L_PSI = int(psi_mask.sum())
    PSI = L_PSI / L_min
    cRMS = float(np.sqrt(dev2[psi_mask].sum() / L_PSI)) if L_PSI > 2 \
        else float("nan")

    if seq0 is not None and seq1 is not None:
        sa = np.array([[seq0[i], seq1[j]] for i, j in align_index.T])
        same = sa[:, 0] == sa[:, 1]
        aSeq = float(same.sum()) / L_aligned
        oSeq = float(same[indicies].sum()) / max(L_orientable, 1)
        cSeq = float(same[psi_mask].sum()) / max(L_PSI, 1)
    else:
        aSeq = oSeq = cSeq = 0.0

    aPSI = _run_psi(align_index, L_min)
    oPSI = _run_psi(align_index[:, indicies], L_min)
    rPSI = _run_psi(align_index[:, psi_mask], L_min)

    return Metrics(TM, PSI, aPSI, oPSI, rPSI, cRMS, aRMS, oRMS,
                   aSeq, oSeq, cSeq, L_min, L_aligned, L_orientable, L_PSI)


def parse_alignment_string(s):
    """DeepBLAST state string -> aligned index pairs, matches only
    (reference: deepblast/metrics.py:471-501; note the reference returns
    ``[a01, a00]``, i.e. (second, first))."""
    c0 = c1 = 0
    a00, a01 = [], []
    for ch in s:
        if ch == ":":
            a00.append(c0)
            a01.append(c1)
            c0 += 1
            c1 += 1
        elif ch == "1":
            c0 += 1
        elif ch == "2":
            c1 += 1
    return np.array([a01, a00])


# reference-compatible alias (reference: deepblast/metrics.py:471)
parseAlingmentString = parse_alignment_string


def process_alignment(alignment, seq0=None, seq1=None, pdb0=None, pdb1=None,
                      transpose=True):
    """PDB-pair driver: parse alignment, run the fragment search, report
    standard metrics (reference: deepblast/metrics.py:504-549)."""
    import warnings
    _, s0 = readPDB(pdb0)
    _, s1 = readPDB(pdb1)
    if transpose:
        s0, s1 = s1, s0
        seq0, seq1 = seq1, seq0
    ai = parse_alignment_string(alignment)
    if seq0 is None or seq1 is None:
        seq0, seq1 = s0.seq, s1.seq
    if s0.seq != seq0:
        warnings.warn(f"sequence {seq0} does not match pdb {pdb0}")
    if s1.seq != seq1:
        warnings.warn(f"sequence {seq1} does not match pdb {pdb1}")
    A, _, _ = FR_TM_maxsub_score(s0.CA, s1.CA, ai)
    return standard_metrics(s0.CA, s1.CA, ai, indicies=A.alignment,
                            seq0=s0.seq, seq1=s1.seq, d0=4.0, UNIT=1.0)
