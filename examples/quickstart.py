"""Quickstart: train a small aligner on simulated pairs and align strings.

(reference analogue: examples/simulation.py and ipynb/small-test.ipynb)
"""

import numpy as np
import pandas as pd

from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
from deepblast_jax.train import DeepBLAST, DeepBLASTConfig

AA = list("ACDEFGHIKLMNPQRSTVWY")


def simulate_pairs(n=64, lo=12, hi=48, seed=0):
    """Identity-ish pairs with random gaps — stands in for hmmemit output
    when the hmmer binary is unavailable."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        L = int(rng.integers(lo, hi))
        seq = "".join(rng.choice(AA, size=L))
        k = int(rng.integers(1, max(2, L // 6)))
        pos = int(rng.integers(1, L - k))
        if rng.random() < 0.5:
            other = seq[:pos] + seq[pos + k:]
            aln = ":" * pos + "1" * k + ":" * (L - pos - k)
            rows.append([f"a{i}", f"b{i}", 0.9, 0.9, 1.0, seq, other, aln])
        else:
            other = seq[:pos] + seq[pos + k:]
            aln = ":" * pos + "2" * k + ":" * (L - pos - k)
            rows.append([f"a{i}", f"b{i}", 0.9, 0.9, 1.0, other, seq, aln])
    return pd.DataFrame(rows)


def main():
    config = DeepBLASTConfig(
        embedding_dim=32, hidden_dim=32, layers=2, vocab_size=32,
        lm_type="embed", batch_size=8, learning_rate=5e-3, epochs=5,
        scheduler="cosine", dropout=0.0, pad_multiple=16)
    dataset = TMAlignDataset(simulate_pairs(), tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(config)
    state, history = model.fit(dataset)
    print("losses:", [round(h["train_loss"], 4) for h in history])
    x = "HEAGAWGHEE"
    y = "HEAGAWGHE"
    print(f"align({x!r}, {y!r}) = {model.align(x, y)}")


if __name__ == "__main__":
    main()
