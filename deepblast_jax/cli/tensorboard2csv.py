"""``deepblast-tensorboard2csv`` (reference: scripts/deepblast-tensorboard2csv)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-tensorboard2csv")
    parser.add_argument("--logdir", type=str, required=True)
    parser.add_argument("--output-csv", type=str, required=True)
    parser.add_argument("--pattern", type=str, default=None)
    args = parser.parse_args(argv)

    from deepblast_jax.utils.logging import tensorboard_to_csv

    df = tensorboard_to_csv(args.logdir, args.output_csv, args.pattern)
    print(f"wrote {args.output_csv} ({len(df)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
