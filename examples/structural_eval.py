"""Structural evaluation example: score a predicted alignment of two PDB
structures with TM-score/PSI metrics (reference analogue:
deepblast/metrics.py process_alignment usage in ipynb/)."""

import sys

from deepblast_jax.eval.metrics import process_alignment


def main(pdb0, pdb1, alignment):
    sm = process_alignment(alignment, pdb0=pdb0, pdb1=pdb1)
    for field, value in zip(sm._fields, sm):
        print(f"{field:>14}: {value}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3])
