"""Shared CLI plumbing (reference flag surface:
deepblast/trainer.py:338-419 ``add_model_specific_args`` +
scripts/deepblast-train:96-108 infra flags)."""

from __future__ import annotations

import argparse

from deepblast_jax.data.alphabet import ProtT5Tokenizer
from deepblast_jax.train.trainer import DeepBLASTConfig

MODE_ALIASES = {
    "needleman-wunch": "needleman-wunsch",     # reference typo kept working
    "needleman-wunsch": "needleman-wunsch",
    "smith-waterman": "smith-waterman",
}


def add_model_args(parser: argparse.ArgumentParser, require_pairs=True):
    parser.add_argument("--train-pairs", required=require_pairs,
                        help="Training pairs file")
    parser.add_argument("--test-pairs", required=require_pairs,
                        help="Testing pairs file")
    parser.add_argument("--valid-pairs", required=require_pairs,
                        help="Validation pairs file")
    parser.add_argument("--pretrain-path", type=str, default=None,
                        help="Path to a local ProtT5 checkpoint directory "
                             "(HF layout); omit to train the LM-free model")
    parser.add_argument("--lm-type", type=str, default="embed",
                        choices=["embed", "bilstm", "prot_t5"])
    parser.add_argument("--vocab-size", type=int, default=32)
    parser.add_argument("--embedding-dim", type=int, default=1024)
    parser.add_argument("--hidden-dim", type=int, default=1024)
    parser.add_argument("--layers", type=int, default=2,
                        help="Number of head layers (default 2)")
    parser.add_argument("--k-size", type=int, default=5,
                        help="CNN kernel width (the reference's --layers "
                             "effectively set this; here it is explicit)")
    parser.add_argument("--layer-type", type=str, default="cnn",
                        choices=["cnn", "rnn"])
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--loss", type=str, default="cross_entropy",
                        choices=["sse", "path", "cross_entropy"])
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--mode", "--alignment-mode", dest="alignment_mode",
                        type=str, default="needleman-wunsch")
    parser.add_argument("--operator", type=str, default="softmax",
                        choices=["softmax", "sparsemax", "hardmax"])
    from deepblast_jax.ops.dp import _BACKENDS
    parser.add_argument("--backend", type=str, default=None,
                        choices=[None, *_BACKENDS],
                        help="DP backend (default: the platform's — the "
                        "triton kernels on a GPU, the scan oracle "
                        "elsewhere)")
    parser.add_argument("--finetune", type=bool, default=False)
    parser.add_argument("--mask-gaps", type=bool, default=True)
    parser.add_argument("--scheduler", type=str, default="cosine")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--visualization-fraction", type=float, default=0.1)
    parser.add_argument("--max-len", type=int, default=1024)
    parser.add_argument("--pad-multiple", type=int, default=16,
                        help="round padded batch lengths up to this "
                             "multiple: fewer distinct shapes, fewer "
                             "compilations")
    parser.add_argument("-o", "--output-directory", required=require_pairs,
                        help="Output directory of model results")
    return parser


def add_infra_args(parser: argparse.ArgumentParser):
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="train K steps per device dispatch "
                             "(lax.scan inside one jit) — amortises "
                             "per-dispatch host cost")
    parser.add_argument("--grad-clip", type=float, default=10.0)
    parser.add_argument("--nodes", type=int, default=1)
    parser.add_argument("--coordinator", type=str, default=None,
                        help="jax.distributed coordinator address "
                             "(multi-host)")
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel mesh width")
    parser.add_argument("--load-from-checkpoint", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--precision", type=str, default="32",
                        choices=("32", "bf16", "16"),
                        help="matmul compute dtype for the heads/LM "
                        "(reference: scripts/deepblast-train:95-103); the "
                        "DP always runs in fp32")
    return parser


def _pretrained_lm_type(args):
    """lm_type implied by --pretrain-path: a raw HF directory means
    ProtT5 (the reference's only pretrained path); a deepblast-convert-lm
    artifact self-describes its kind in manifest.json."""
    if not args.pretrain_path:
        return args.lm_type
    from deepblast_jax.models.convert import is_converted_lm
    if is_converted_lm(args.pretrain_path):
        import json
        import os
        with open(os.path.join(args.pretrain_path, "manifest.json")) as f:
            return {"prot_t5": "prot_t5", "bilstm": "bilstm"}[
                json.load(f)["kind"]]
    return "prot_t5"


def config_from_args(args) -> DeepBLASTConfig:
    mode = MODE_ALIASES.get(args.alignment_mode, args.alignment_mode)
    return DeepBLASTConfig(
        embedding_dim=args.embedding_dim,
        hidden_dim=args.hidden_dim,
        layers=args.layers,
        k_size=args.k_size,
        dropout=args.dropout,
        layer_type=args.layer_type,
        alignment_mode=mode,
        operator=args.operator,
        backend=args.backend,
        lm_type=_pretrained_lm_type(args),
        vocab_size=args.vocab_size,
        finetune=bool(args.finetune),
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        epochs=args.epochs,
        scheduler=args.scheduler,
        loss=args.loss,
        grad_clip=getattr(args, "grad_clip", None),
        grad_accum=getattr(args, "grad_accum", 1),
        steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        mask_gaps=bool(args.mask_gaps),
        seed=getattr(args, "seed", 0),
        precision=getattr(args, "precision", "32"),
        train_pairs=args.train_pairs,
        valid_pairs=args.valid_pairs,
        test_pairs=args.test_pairs,
        max_len=args.max_len,
        pad_multiple=getattr(args, "pad_multiple", 16),
        output_directory=args.output_directory,
        visualization_fraction=args.visualization_fraction,
        tp=getattr(args, "tp", 1),
    )


def build_model(config, pretrain_path=None):
    """Construct DeepBLAST; loads LM weights when a local checkpoint is
    given (reference: scripts/deepblast-train:18-20).  Accepts either a
    raw HF ProtT5 checkpoint directory (torch needed, converted on the
    fly) or a ``deepblast-convert-lm`` artifact directory (torch-free)."""
    from deepblast_jax.train.trainer import DeepBLAST
    tokenizer = ProtT5Tokenizer()
    lm = lm_params = None
    if pretrain_path:
        from deepblast_jax.models.convert import (is_converted_lm,
                                                  load_converted_lm)
        if is_converted_lm(pretrain_path):
            lm, lm_params = load_converted_lm(pretrain_path)
            from deepblast_jax.models.lm import BiLM
            if isinstance(lm, BiLM):
                # the heads' input width is the LM's feature dim and the
                # one-hot channel width is the LM's alphabet; derive both
                # from the artifact so a geometry mismatch cannot
                # silently mis-shape the aligner.  Bepler BiLMs embed
                # Uniprot21 ids (+ mask), NOT ProtT5 sentencepiece ids —
                # switch the tokenizer accordingly.
                import dataclasses
                config = dataclasses.replace(
                    config, embedding_dim=lm.hidden_size,
                    vocab_size=lm.nin)
                from deepblast_jax.data import UniprotPairTokenizer
                tokenizer = UniprotPairTokenizer()
        else:
            from deepblast_jax.models.lm import load_prot_t5
            lm, lm_params = load_prot_t5(pretrain_path)
    return DeepBLAST(config, tokenizer=tokenizer, lm=lm,
                     lm_params=lm_params)
