"""Corpus parsers (reference: deepblast/dataset/parse_tm_align.py,
parse_mali.py, parse_blast.py, parse_hmmer.py, parse_fatcat.py,
tm_align.py).

Self-contained (no Biopython): BLAST XML uses ``xml.etree``; the HMMER3
text parser reads domain alignment blocks directly.
"""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import pandas as pd

from deepblast_jax.data.state_utils import revstate_f, state_f

__all__ = [
    "aln_f",
    "parse_block_2017",
    "parse_block_2021",
    "validate_block_2021",
    "parse_tm_align_file",
    "tm_align_batch",
    "read_mali",
    "read_mali_mammoth",
    "get_mali_structure_stats",
    "parse_blast_xml",
    "get_blast_alignments",
    "parse_hmmer_text",
    "get_hmmer_alignments",
    "parse_fatcat_ids",
]

TM_HEADER = ["chain1_name", "chain2_name", "tmscore1", "tmscore2", "rmsd",
             "chain1", "chain2", "alignment"]


# ---------------------------------------------------------------------------
# TM-align raw output
# ---------------------------------------------------------------------------

def aln_f(X):
    """Per-column TM-align state char: gap-in-2 -> '1', gap-in-1 -> '2',
    else the TM annotation (':' close pair, '.' other aligned)
    (reference: deepblast/dataset/parse_tm_align.py:30-36)."""
    a, ann, b = X
    if b == "-":
        return "1"
    if a == "-":
        return "2"
    return ann


def parse_block_2017(lines):
    """Parse one 25-line block of TM-align 20170708 output
    (reference: deepblast/dataset/parse_tm_align.py:41-86)."""
    chain1_name = lines[11].split(":")[1].strip()
    chain2_name = lines[12].split(":")[1].strip()
    tmscore1 = float(lines[17].lstrip().split(" ")[1])
    tmscore2 = float(lines[18].lstrip().split(" ")[1])
    chain1 = lines[22].strip()
    aln = lines[23]
    chain2 = lines[24].strip()
    rmsd = float(re.split(r"\s+", lines[16].lstrip().split(", ")[1])[1])
    alignment = "".join(aln_f(z) for z in zip(chain1, aln, chain2))
    return (chain1_name, chain2_name, tmscore1, tmscore2, rmsd,
            chain1.replace("-", ""), chain2.replace("-", ""), alignment)


def validate_block_2021(lines):
    """(reference: deepblast/dataset/parse_tm_align.py:116-127)"""
    try:
        return ("Chain_1" in lines[7] and "Chain_2" in lines[8]
                and "TM-score" in lines[13] and "TM-score" in lines[14]
                and ":" in lines[19] and "RMSD" in lines[12]
                and " " not in lines[18].strip()
                and " " not in lines[20].strip())
    except IndexError:
        return False


def parse_block_2021(lines):
    """Parse one 23-line block of TM-align 20210224 output
    (reference: deepblast/dataset/parse_tm_align.py:129-174)."""
    chain1_name = lines[7].split(":")[1].strip().split(" ")[0]
    chain2_name = lines[8].split(":")[1].strip().split(" ")[0]
    tmscore1 = float(lines[13].lstrip().split(" ")[1])
    tmscore2 = float(lines[14].lstrip().split(" ")[1])
    chain1 = lines[18].strip()
    aln = lines[19]
    chain2 = lines[20].strip()
    rmsd = float(re.split(r"\s+", lines[12].lstrip().split(", ")[1])[1])
    alignment = "".join(aln_f(z) for z in zip(chain1, aln, chain2))
    return (chain1_name, chain2_name, tmscore1, tmscore2, rmsd,
            chain1.replace("-", ""), chain2.replace("-", ""), alignment)


def parse_tm_align_file(fname, output=None, lines_per_block=23):
    """Stream a concatenated TM-align output file into the 8-column table
    (reference: deepblast/dataset/parse_tm_align.py:177-208 __main__)."""
    rows = []
    block = []
    i = 0
    for line in open(fname):
        if i % lines_per_block == 0 and i > 0:
            if validate_block_2021(block):
                rows.append(parse_block_2021(block))
                block = []
            else:
                i -= 1
                block = block[1:]
        block.append(line)
        i += 1
    if validate_block_2021(block):
        rows.append(parse_block_2021(block))
    df = pd.DataFrame(rows, columns=TM_HEADER)
    if output:
        df.to_csv(output, sep="\t", header=False, index=False)
    return df


def tm_align_batch(pair_file, output, pdb_root, num_jobs=4,
                   tmalign_bin="TMalign", scratch=None):
    """Fan out TMalign subprocesses over PDB id pairs
    (reference: deepblast/dataset/tm_align.py:1-38).  ``scratch``
    defaults to the process's temporary directory."""
    import tempfile
    scratch = scratch or tempfile.gettempdir()
    procs = []
    for line in open(pair_file):
        xid, yid = line.rstrip().split(" ")
        xid, yid = xid.lower(), yid.lower()
        cmds = []
        paths = []
        for pid in (xid, yid):
            div = pid[1:-1]
            src = f"{pdb_root}/{div}/pdb{pid}.ent.gz"
            dst = f"{scratch}/pdb{pid}.ent.gz"
            cmds += [f"cp {src} {dst}", f"gunzip -f {dst}"]
            paths.append(f"{scratch}/pdb{pid}.ent")
        cmds.append(f"{tmalign_bin} {paths[0]} {paths[1]} >> {output}")
        cmds.append(f"rm -f {paths[0]} {paths[1]}")
        procs.append(subprocess.Popen("; ".join(cmds), shell=True))
        if len(procs) >= num_jobs:
            for p in procs:
                p.wait()
            procs = []
    for p in procs:
        p.wait()


# ---------------------------------------------------------------------------
# Malidup / Malisam
# ---------------------------------------------------------------------------

def read_mali(root, tool="manual", report_ids=False):
    """Read gapped-pair ``.ali`` files under ``root``
    (reference: deepblast/dataset/parse_mali.py:9-60)."""
    res, pdbs, dirs, single_pdbs = [], [], [], []
    import glob as _glob
    for path, _, files in os.walk(root):
        for f in sorted(files):
            if ".ali" in f and tool in f and "manual2" not in f:
                lines = open(os.path.join(path, f)).readlines()
                X = lines[0].rstrip().upper()
                Y = lines[1].rstrip().upper()
                S = "".join(revstate_f(state_f(z)) for z in zip(X, Y))
                res.append((X.replace("-", ""), Y.replace("-", ""), S))
                ps = sorted(
                    os.path.basename(p)
                    for p in _glob.glob(f"{path}/*.pdb")
                    if all(t not in os.path.basename(p)
                           for t in ("fast", "tm", "manual", "dali")))
                single_pdbs.append(ps)
                pdbs.append(os.path.basename(f).split(f".{tool}.ali")[0])
                dirs.append(os.path.basename(path))
    df = pd.DataFrame(res)
    if report_ids and len(df):
        df["query_id"] = np.arange(len(df)).astype(str)
        df["hit_id"] = (np.arange(len(df)) + len(df)).astype(str)
        df["pdb"] = pdbs
        df["dir"] = dirs
        sp = pd.DataFrame(single_pdbs)
        sp.columns = [f"pdb_{i}" for i in range(sp.shape[1])]
        df = pd.concat((df, sp), axis=1)
    return df


def read_mali_mammoth(root, report_ids=False):
    """Mammoth ``.ali`` variant (reference:
    deepblast/dataset/parse_mali.py:68-110)."""

    def strip(xx):
        return "".join(xx.split(" ")[1:]).rstrip()

    res, pdbs = [], []
    for path, _, files in os.walk(root):
        for f in sorted(files):
            if ".ali" in f:
                contents = open(os.path.join(path, f)).readlines()
                pred = [ln for ln in contents if "Prediction " in ln]
                expr = [ln for ln in contents if "Experiment " in ln]
                idx = np.arange(len(pred)) % 2 == 0
                X = "".join(strip(p) for p in np.array(pred)[idx])
                Y = "".join(strip(e) for e in np.array(expr)[~idx])
                X = X.replace(".", "-").rstrip().upper()
                Y = Y.replace(".", "-").rstrip().upper()
                S = "".join(revstate_f(state_f(z)) for z in zip(X, Y))
                res.append((X.replace("-", ""), Y.replace("-", ""), S))
                pdbs.append(os.path.basename(f).split(".mammoth.ali")[0])
    df = pd.DataFrame(res)
    if report_ids and len(df):
        df["query_id"] = np.arange(len(df)).astype(str)
        df["hit_id"] = (np.arange(len(df)) + len(df)).astype(str)
        df["pdb"] = pdbs
    return df


def get_mali_structure_stats(root, tool="manual"):
    """Per-structure secondary-structure class counts for the manual
    Malidup/Malisam PDBs under ``root`` (reference:
    deepblast/dataset/parse_mali.py:113-161).

    The reference shells out to ``mkdssp`` via Bio.PDB.DSSP; here the
    Kabsch-Sander assignment is built in
    (:mod:`deepblast_jax.data.dssp`), so there is no binary or Biopython
    dependency.  Output matches the reference row shape: one row per
    PDB whose filename contains ``tool``, with ``x<class>`` count
    columns (DSSP 8-letter classes, '-' = coil), ``pdb``, ``path``, and
    ``xlen``."""
    from deepblast_jax.data.dssp import secondary_structure_counts

    rows = []
    for path, _, files in os.walk(root):
        for f in sorted(files):
            if ".pdb" in f and tool in f:
                fname = os.path.join(path, f)
                counts, length = secondary_structure_counts(fname)
                stats = {f"x{k}": v for k, v in sorted(counts.items())}
                stats["pdb"] = os.path.basename(f).split(".")[0]
                stats["path"] = fname
                stats["xlen"] = length
                rows.append(stats)
    return pd.DataFrame(rows)


# ---------------------------------------------------------------------------
# BLAST XML (xml.etree instead of Bio.SearchIO)
# ---------------------------------------------------------------------------

BLAST_COLUMNS = ["query_id", "hit_id", "fragment_num",
                 "query_start", "query_end", "hit_start", "hit_end",
                 "query_string", "hit_string", "alignment_string",
                 "score", "evalue"]


def parse_blast_xml(blast_path):
    """(reference: deepblast/dataset/parse_blast.py:8-41)"""
    import xml.etree.ElementTree as ET
    rows = []
    root = ET.parse(blast_path).getroot()
    for it in root.iter("Iteration"):
        qid = it.findtext("Iteration_query-def") or \
            it.findtext("Iteration_query-ID")
        qid = (qid or "").split()[0]
        for hit in it.iter("Hit"):
            hid = (hit.findtext("Hit_def")
                   or hit.findtext("Hit_id") or "").split()[0]
            if qid == hid:
                continue
            for i, hsp in enumerate(hit.iter("Hsp")):
                rows.append([
                    qid, hid, str(i),
                    str(int(hsp.findtext("Hsp_query-from")) - 1),
                    hsp.findtext("Hsp_query-to"),
                    str(int(hsp.findtext("Hsp_hit-from")) - 1),
                    hsp.findtext("Hsp_hit-to"),
                    hsp.findtext("Hsp_qseq"),
                    hsp.findtext("Hsp_hseq"),
                    hsp.findtext("Hsp_midline"),
                    hsp.findtext("Hsp_bit-score"),
                    hsp.findtext("Hsp_evalue"),
                ])
    return pd.DataFrame(rows, columns=BLAST_COLUMNS)


def _top_hits(df):
    df = df.copy()
    df["evalue"] = df["evalue"].astype(float)
    idx = df.groupby(["query_id", "hit_id"])["evalue"].idxmin()
    return df.loc[idx].set_index(
        pd.MultiIndex.from_frame(df.loc[idx, ["query_id", "hit_id"]]))


def get_blast_alignments(blast_path, mali_root):
    """(reference: deepblast/dataset/parse_blast.py:44-54)"""
    df = _top_hits(parse_blast_xml(blast_path))
    manual = read_mali(mali_root, tool="manual", report_ids=True)
    keep = set(map(tuple, manual[["query_id", "hit_id"]].values)) \
        & set(df.index)
    df = df.loc[sorted(keep)]
    df["aln"] = [
        "".join(revstate_f(state_f(z)) for z in zip(q, h))
        for q, h in zip(df["query_string"], df["hit_string"])]
    return df


# ---------------------------------------------------------------------------
# HMMER3 text
# ---------------------------------------------------------------------------

HMMER_COLUMNS = ["query_id", "hit_id", "fragment_num",
                 "query_start", "query_end", "hit_start", "hit_end",
                 "query_string", "hit_string", "score", "evalue"]


def parse_hmmer_text(hmmer_path):
    """Minimal HMMER3 text-output parser extracting per-domain alignment
    fragments (reference: deepblast/dataset/parse_hmmer.py:8-37 via
    Bio.SearchIO, reimplemented natively)."""
    rows = []
    query_id = None
    hit_id = None
    dom_scores = {}
    with open(hmmer_path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("Query:"):
            query_id = line.split()[1]
        elif line.startswith(">>"):
            hit_id = line.split()[1]
            dom_scores = {}
            # domain table follows after a header + separator
            j = i + 3
            while j < len(lines) and lines[j].strip():
                toks = lines[j].split()
                if len(toks) >= 13 and toks[1] in ("!", "?"):
                    dom_scores[int(toks[0])] = (float(toks[2]),
                                                float(toks[5]))
                j += 1
        elif line.strip().startswith("== domain"):
            dom_num = int(line.split()[2])
            qseq = hseq = None
            qs = qe = hs = he = None
            j = i + 1
            while j < len(lines):
                ln = lines[j].rstrip("\n")
                toks = ln.split()
                if not toks:
                    if qseq is not None and hseq is not None:
                        break
                elif query_id and toks[0] == query_id and len(toks) >= 4:
                    if qseq is None:
                        qs = int(toks[1]) - 1
                    qseq = (qseq or "") + toks[2]
                    qe = int(toks[3])
                elif hit_id and toks[0] == hit_id and len(toks) >= 4:
                    if hseq is None:
                        hs = int(toks[1]) - 1
                    hseq = (hseq or "") + toks[2]
                    he = int(toks[3])
                j += 1
            if qseq and hseq and query_id != hit_id:
                score, evalue = dom_scores.get(dom_num, (0.0, 0.0))
                rows.append([query_id, hit_id, str(dom_num - 1),
                             str(qs), str(qe), str(hs), str(he),
                             qseq.upper(), hseq.upper(),
                             str(score), str(evalue)])
            i = j
        i += 1
    return pd.DataFrame(rows, columns=HMMER_COLUMNS)


def get_hmmer_alignments(hmmer_path, mali_root):
    """(reference: deepblast/dataset/parse_hmmer.py:40-52)"""
    df = _top_hits(parse_hmmer_text(hmmer_path))
    manual = read_mali(mali_root, tool="manual", report_ids=True)
    keep = set(map(tuple, manual[["query_id", "hit_id"]].values)) \
        & set(df.index)
    df = df.loc[sorted(keep)]
    df["aln"] = [
        "".join(revstate_f(state_f(z))
                for z in zip(q.replace(".", "-"), h.replace(".", "-")))
        for q, h in zip(df["query_string"], df["hit_string"])]
    return df


# ---------------------------------------------------------------------------
# FATCAT id lists
# ---------------------------------------------------------------------------

def parse_fatcat_ids(lines):
    """Split FATCAT rigid output ids into (pdb, chain) pairs
    (reference: deepblast/dataset/parse_fatcat.py:1-20)."""

    def extract(xx):
        yy = xx[1:] if xx[0] == "d" else xx.split(":")[1]
        return yy[:4], yy[4], yy[5:]

    rows = []
    for line in lines:
        toks = re.split(r"\s+", line.strip())
        p1, c1, _ = extract(toks[0])
        p2, c2, _ = extract(toks[1])
        rows.append((p1, c1, p2, c2))
    return pd.DataFrame(rows, columns=["pdb1", "chain1", "pdb2", "chain2"])
