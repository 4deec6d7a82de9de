"""``deepblast-evaluate`` — per-pair accuracy stats CSV
(reference: scripts/deepblast-evaluate)."""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-evaluate")
    parser.add_argument("--load-from-checkpoint", type=str, required=True,
                        help="model output directory (with config.json)")
    parser.add_argument("--test-pairs", type=str, required=True)
    parser.add_argument("-o", "--output-directory", type=str, required=True)
    args = parser.parse_args(argv)

    from deepblast_jax.train.checkpoint import load_model

    model = load_model(args.load_from_checkpoint)
    ds = model._dataset(args.test_pairs, return_names=True)
    df = model.test(model.state, ds)
    os.makedirs(args.output_directory, exist_ok=True)
    fname = os.path.basename(args.test_pairs)
    out = os.path.join(args.output_directory, f"{fname}-results.csv")
    df.to_csv(out)
    print(f"wrote {out} ({len(df)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
