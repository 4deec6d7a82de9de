"""``deepblast-hmm-simulate`` (reference: scripts/hmm-simulate)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-hmm-simulate")
    parser.add_argument("--hmmfile", type=str, required=True)
    parser.add_argument("--n-sequences", type=int, default=100)
    parser.add_argument("--n-alignments", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-file", type=str, required=True)
    args = parser.parse_args(argv)

    from deepblast_jax.data.dataset import write_pairs
    from deepblast_jax.sim import hmm_alignments

    rows = hmm_alignments(args.n_sequences, args.seed, args.n_alignments,
                          args.hmmfile)
    write_pairs(rows, args.output_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
