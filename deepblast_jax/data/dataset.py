"""Datasets and batching (reference: deepblast/dataset/dataset.py).

Numpy-native datasets (no torch DataLoader machinery): each item is a dict
of arrays; :func:`collate` pads a list of items into fixed-shape batches and
:func:`make_batches` adds shuffling and length-bucketed padding so XLA sees
a small, static set of shapes (the static-shape replacement for
PackedSequence batching, reference: deepblast/dataset/utils.py:214-312).

Pair tables are lists of rows.  A dataset takes a TSV path, a list of
rows, or any table with ``to_numpy()`` (a pandas DataFrame built by an
offline parser) — this module itself needs no pandas.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np

from deepblast_jax.constants import m
from deepblast_jax.data.alphabet import ProtT5Tokenizer, UniprotTokenizer
from deepblast_jax.data.state_utils import (
    clip_boundaries,
    gap_mask,
    path_distance_matrix,
    state_f,
    states2edges,
    states2matrix,
    tmstate_f,
    trim_gap,
)

__all__ = [
    "TMAlignDataset",
    "MaliAlignmentDataset",
    "FastaDataset",
    "read_fasta",
    "collate",
    "make_batches",
    "TM_COLUMNS",
    "read_pairs",
    "write_pairs",
]

TM_COLUMNS = [
    "chain1_name", "chain2_name", "tmscore1", "tmscore2", "rmsd",
    "chain1", "chain2", "alignment",
]


def _table_rows(table):
    """Rows of a pair table: a TSV path (no header), a table with
    ``to_numpy()``, or an iterable of rows."""
    if isinstance(table, (str, os.PathLike)):
        return read_pairs(table)
    if hasattr(table, "to_numpy"):
        return table.to_numpy().tolist()
    return [list(r) for r in table]


def read_pairs(path):
    """Rows of a tab-separated pair file without a header line."""
    with open(path, newline="") as f:
        return [row for row in csv.reader(f, delimiter="\t") if row]


def write_pairs(rows, path):
    """Write pair rows as a tab-separated file without a header line (the
    format :class:`TMAlignDataset` reads)."""
    with open(path, "w", newline="") as f:
        csv.writer(f, delimiter="\t", lineterminator="\n").writerows(rows)


def _reshape(mat, N, M):
    """Orient a matrix as (N, M), transposing if needed
    (reference: deepblast/dataset/utils.py:463-473)."""
    if mat.shape != (N, M) and mat.shape != (M, N):
        raise ValueError(f"The shape of `x` {mat.shape} "
                         f"does not agree with ({N}, {M})")
    return mat if mat.shape == (N, M) else mat.T


class TMAlignDataset:
    """TM-align TSV training pairs (8 columns, TM_COLUMNS order;
    reference: deepblast/dataset/dataset.py:43-189)."""

    def __init__(self, path, tokenizer=None, tm_threshold=0.4, max_len=1024,
                 max_gap=None, pad_ends=False, clip_ends=True,
                 mask_gaps=True, return_names=False, construct_paths=False):
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        pairs = []
        for row in _table_rows(path):
            r = dict(zip(TM_COLUMNS, row))
            for k in ("tmscore1", "tmscore2", "rmsd"):
                r[k] = float(r[k])
            for k in ("chain1_name", "chain2_name", "chain1", "chain2",
                      "alignment"):
                r[k] = str(r[k])
            if (max(r["tmscore1"], r["tmscore2"]) > tm_threshold
                    and max(len(r["chain1"]), len(r["chain2"])) < max_len):
                pairs.append(trim_gap(r, max_gap) if max_gap is not None
                             else r)
        self.pairs = pairs
        self.pad_ends = pad_ends
        self.clip_ends = clip_ends
        self.mask_gaps = mask_gaps
        self.return_names = return_names
        self.construct_paths = construct_paths

    def __len__(self):
        return len(self.pairs)

    def lengths(self):
        """Per-pair max sequence length, for length-bucketed batching."""
        return np.array([max(len(r["chain1"]), len(r["chain2"]))
                         for r in self.pairs], np.int64)

    def __getitem__(self, i):
        row = self.pairs[i]
        gene, pos, st = row["chain1"], row["chain2"], row["alignment"]
        states = [tmstate_f(s) for s in st]
        if self.clip_ends:
            gene, pos, states, st = clip_boundaries(gene, pos, states, st)
        if self.pad_ends:
            states = [m] + states + [m]
        x_tok, _ = self.tokenizer(gene)
        y_tok, _ = self.tokenizer(pos)
        states = np.asarray(states, np.int32)
        aln = states2matrix(states)
        lg, lp = len(gene), len(pos)
        aln = _reshape(aln, lg, lp).astype(np.float32)
        if self.construct_paths:
            path = _reshape(
                path_distance_matrix(states2edges(states)), lg, lp)
        else:
            path = np.zeros((lg, lp), np.float32)
        if self.mask_gaps:
            g = _reshape(gap_mask(st), lg, lp)
        else:
            g = np.ones((lg, lp), bool)
        item = dict(x=x_tok, y=y_tok, states=states,
                    aln=aln, path=path.astype(np.float32), gmask=g)
        if self.return_names:
            item["names"] = (row["chain1_name"], row["chain2_name"])
            item["seqs"] = (gene, pos)
        return item


class MaliAlignmentDataset:
    """Gapped-pair rows (Malidup/Malisam;
    reference: deepblast/dataset/dataset.py:192-241)."""

    def __init__(self, pairs, tokenizer=None):
        self.pairs = _table_rows(pairs)
        self.tokenizer = tokenizer or UniprotTokenizer()

    def __len__(self):
        return len(self.pairs)

    def lengths(self):
        """Per-pair max ungapped sequence length (batching sort key)."""
        return np.array([
            max(len(str(r[0]).replace("-", "")),
                len(str(r[1]).replace("-", "")))
            for r in self.pairs], np.int64)

    def __getitem__(self, i):
        gene = str(self.pairs[i][0])
        pos = str(self.pairs[i][1])
        assert len(gene) == len(pos)
        states = np.asarray(
            [state_f(z) for z in zip(gene, pos)], np.int32)
        aln = states2matrix(states).astype(np.float32)
        x_tok = np.asarray(self.tokenizer(gene.replace("-", "")), np.int32)
        y_tok = np.asarray(self.tokenizer(pos.replace("-", "")), np.int32)
        lg, lp = len(gene.replace("-", "")), len(pos.replace("-", ""))
        aln = _reshape(aln, lg, lp)
        return dict(x=x_tok, y=y_tok, states=states, aln=aln,
                    path=np.zeros_like(aln), gmask=np.ones_like(aln, bool))


def read_fasta(path):
    """Minimal FASTA reader yielding ``(id, sequence)``."""
    name, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


class FastaDataset:
    """Streams query x database pairs for search
    (reference: deepblast/dataset/dataset.py:244-282)."""

    def __init__(self, query_file, db_file, tokenizer=None):
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        self.query_file = query_file
        self.db_file = db_file

    def __iter__(self):
        for dbid, dbseq in read_fasta(self.db_file):
            db_tok, _ = self.tokenizer(dbseq)
            for qid, qseq in read_fasta(self.query_file):
                q_tok, _ = self.tokenizer(qseq)
                yield dict(qid=qid, dbid=dbid,
                           x=np.asarray(q_tok, np.int32),
                           y=np.asarray(db_tok, np.int32))


def _bucket(n, multiple, cap=None):
    b = int(math.ceil(n / multiple) * multiple)
    return min(b, cap) if cap else b


def collate(items, pad_multiple=1, pad_token=0):
    """Pad a list of dataset items into one fixed-shape batch dict.

    Returns arrays ``x, y (B, Lx|Ly) int32``, ``x_len, y_len (B,)``,
    ``aln, path (B, Lx, Ly) float32``, ``gmask (B, Lx, Ly) bool`` plus the
    ragged ``states`` / ``names`` lists for host-side evaluation.
    """
    B = len(items)
    xl = np.array([len(it["x"]) for it in items], np.int32)
    yl = np.array([len(it["y"]) for it in items], np.int32)
    Lx = _bucket(int(xl.max()), pad_multiple)
    Ly = _bucket(int(yl.max()), pad_multiple)
    x = np.full((B, Lx), pad_token, np.int32)
    y = np.full((B, Ly), pad_token, np.int32)
    aln = np.zeros((B, Lx, Ly), np.float32)
    path = np.zeros((B, Lx, Ly), np.float32)
    g = np.zeros((B, Lx, Ly), bool)
    for b, it in enumerate(items):
        n, mm = xl[b], yl[b]
        x[b, :n] = it["x"]
        y[b, :mm] = it["y"]
        aln[b, :n, :mm] = it["aln"]
        path[b, :n, :mm] = it["path"]
        g[b, :n, :mm] = it["gmask"]
    batch = dict(x=x, y=y, x_len=xl, y_len=yl, aln=aln, path=path, gmask=g,
                 states=[it["states"] for it in items])
    if "names" in items[0]:
        batch["names"] = [it["names"] for it in items]
        batch["seqs"] = [it.get("seqs") for it in items]
    return batch


def make_batches(dataset, batch_size, shuffle=True, seed=0, pad_multiple=16,
                 sort_by_length=True, drop_last=False):
    """Yield collated batches; length-sorting plus pad_multiple bucketing
    keeps the number of distinct XLA shapes small."""
    idx = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    if sort_by_length and hasattr(dataset, "lengths"):
        lens = np.asarray(dataset.lengths())[idx]
        if lens.any():
            order = np.argsort(lens, kind="stable")
            idx = idx[order]
    chunks = [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]
    if drop_last and chunks and len(chunks[-1]) < batch_size:
        chunks = chunks[:-1]
    if shuffle:
        rng.shuffle(chunks)
    for chunk in chunks:
        yield collate([dataset[int(i)] for i in chunk],
                      pad_multiple=pad_multiple)
