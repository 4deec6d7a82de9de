"""deepblast-convert-lm — convert a downloaded pretrained language-model
checkpoint (Rostlab ProtT5 HF directory / Bepler ``lstm2x.pt``) into this
repo's torch-free LM artifact (``params.npz`` + ``manifest.json``).

Closes the reference's end-user pretrained story (reference:
deepblast/utils.py:12-65 downloads + rebuilds from torch checkpoints;
deepblast/language_model.py:16-18 registry): here the conversion is an
explicit offline step, after which training/serving never import torch.

Examples::

    deepblast-convert-lm ~/prot_t5_xl_uniref50/ --output lm_artifact/
    deepblast-convert-lm lstm2x.pt --kind bilstm --output bilm_artifact/
    deepblast-train --lm lm_artifact/ ...
"""

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="deepblast-convert-lm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint",
                   help="HF checkpoint directory (pytorch_model.bin) or a "
                        "torch .pt/.bin file")
    p.add_argument("--output", required=True,
                   help="output artifact directory")
    p.add_argument("--kind", choices=["auto", "prot_t5", "bilstm"],
                   default="auto",
                   help="checkpoint family (default: detect from keys)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype for the artifact (bfloat16 halves "
                        "it; the frozen serving path runs bf16 anyway)")
    p.add_argument("--no-strict", action="store_true",
                   help="warn instead of fail on manifest mismatches")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from deepblast_jax.models.convert import convert_checkpoint
    manifest = convert_checkpoint(
        args.checkpoint, args.output, kind=args.kind,
        dtype=None if args.dtype == "float32" else args.dtype,
        strict=not args.no_strict)
    print(json.dumps(manifest, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
