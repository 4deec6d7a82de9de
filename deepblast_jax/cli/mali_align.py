"""``deepblast-mali-align`` — align Malidup/Malisam PDB-derived pairs
(reference: scripts/deepblast-mali-align, which has a syntax error
upstream — ``dfrom`` at scripts/deepblast-mali-align:11 — fixed here)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-mali-align")
    parser.add_argument("--mali-pairs", type=str, required=True,
                        help="CSV with pdb filename pairs (and optionally "
                             "the manual alignment)")
    parser.add_argument("--input-mali-dir", type=str, required=True)
    parser.add_argument("--load-from-checkpoint", type=str, required=True)
    parser.add_argument("--output-alignments", type=str, required=True)
    args = parser.parse_args(argv)

    import pandas as pd

    from deepblast_jax.data.parse_pdb import readPDB
    from deepblast_jax.train.checkpoint import load_model

    model = load_model(args.load_from_checkpoint)
    res = pd.read_csv(args.mali_pairs, index_col=0)
    out = []
    for i in range(len(res)):
        pdb0, pdb1 = res.iloc[i][0], res.iloc[i][1]
        _, s0 = readPDB(f"{args.input_mali_dir}/{pdb0}")
        _, s1 = readPDB(f"{args.input_mali_dir}/{pdb1}")
        out.append(model.align(s1.seq, s0.seq))
    res["deepblast"] = out
    res = res.rename(columns={"0": "query_seq", "1": "hit_seq",
                              "2": "manual"})
    res.to_csv(args.output_alignments)
    print(f"wrote {args.output_alignments} ({len(res)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
