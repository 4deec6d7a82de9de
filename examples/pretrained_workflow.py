"""Pretrained-checkpoint walkthrough: convert -> load -> align.

The reference's notebook story (reference: ipynb/small-test.ipynb +
deepblast/utils.py:12-65) is "download a checkpoint, load_model, align".
Here the same flow runs torch-free after a one-time conversion:

    deepblast-convert-lm <downloaded-checkpoint> --output lm_artifact/
    deepblast-train --pretrain-path lm_artifact/ ...
    model.align(x, y)

Network access (and therefore the real Rostlab/Bepler weights) is
unavailable in this environment, so this example synthesizes a
Bepler-layout BiLM torch checkpoint, converts it through the real CLI,
and runs the full load -> finetune-heads -> align path on the artifact.
Swap the synthetic checkpoint for a downloaded one and everything else
is identical.

Run: PYTHONPATH=. python examples/pretrained_workflow.py   (~2 min CPU)
"""

import os
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def synthesize_bepler_checkpoint(path, hidden=32):
    """Stand-in for downloading lstm2x.pt (stripped from the reference
    snapshot itself) — same key layout, random weights."""
    import torch
    from deepblast_jax.models.convert import bilm_key_shapes
    rng = np.random.default_rng(0)
    sd = {k: torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.1)
          for k, s in bilm_key_shapes(hidden_dim=hidden).items()}
    torch.save(sd, path)


def main():
    root = tempfile.mkdtemp(prefix="deepblast_pretrained_")
    ckpt = os.path.join(root, "lstm2x.pt")
    artifact = os.path.join(root, "lm_artifact")
    synthesize_bepler_checkpoint(ckpt)

    # 1. one-time conversion (the only step that needs torch)
    from deepblast_jax.cli.convert_lm import main as convert_main
    assert convert_main([ckpt, "--output", artifact]) == 0

    # 2. build the model from the artifact — no torch import from here on
    from deepblast_jax.cli.common import build_model
    from deepblast_jax.train.trainer import DeepBLASTConfig
    config = DeepBLASTConfig(lm_type="bilstm", vocab_size=22,
                             hidden_dim=64, epochs=4, batch_size=8,
                             max_len=64, pad_multiple=32,
                             scheduler="none")
    model = build_model(config, pretrain_path=artifact)
    print(f"LM feature dim from artifact: {model.config.embedding_dim}")

    # 3. quick head fit on simulated pairs (frozen LM), then align
    from deepblast_jax.data.substitution import simulate_blosum_pairs
    from deepblast_jax.data.dataset import TMAlignDataset
    pairs = simulate_blosum_pairs(64, seed=1, max_len=48)
    ds = TMAlignDataset(pairs, tokenizer=model.tokenizer, max_len=64)
    state, history = model.fit(ds)
    print(f"head-fit loss: {history[0]['train_loss']:.3f} -> "
          f"{history[-1]['train_loss']:.3f}")

    x, y = "HEAGAWGHEE", "HEAGAWGHE"
    print(f"align({x!r}, {y!r}) = {model.align(x, y)}")


if __name__ == "__main__":
    main()
