#!/usr/bin/env python3
"""Pretrained-BiLM aligner quality — the reference's pretrained-LM leg
(round 4).

The reference's flagship configuration runs a *pretrained frozen*
language model under the aligner (ProtT5 or the Bepler BiLM ``lstm2x.pt``
— deepblast/language_model.py:12-47); neither checkpoint is reachable
here.  This script demonstrates the leg end to end anyway, with a
corpus where pretraining is *measurable*:

- pairs come from :func:`simulate_hmm_pairs` — a hidden
  secondary-structure-like Markov chain over columns, so residues carry
  neighbour context (on the i.i.d. ``simulate_blosum_pairs`` corpus a
  language model can only learn unigram frequencies and pretraining is
  void by construction);
- the native JAX BiLM is pretrained as a cloze LM (predict each token
  from both directions, reference semantics language_model.py:231-272)
  on sequences from the same process;
- the aligner trains on top of the FROZEN LM (reference: no_grad
  embeddings, deepblast/alignment.py:90-93), data-poor on purpose
  (pretraining matters most when pair supervision is scarce);
- arms: embed-LM baseline / random-init frozen BiLM (architecture
  control) / pretrained frozen BiLM, plus the tuned classical NW
  baselines from the round-3 protocol.

Writes docs/quality_bilm_r04.json.

Runs on the platform JAX picks (``JAX_PLATFORMS=cpu`` pins the CPU).

Run: python scripts/quality_bilm.py
"""

import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from deepblast_jax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from quality_eval import (  # noqa: E402
    MAXLEN, eval_model, nw_stats, summarize, tune_gap)

from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset  # noqa: E402
from deepblast_jax.data.substitution import (  # noqa: E402
    sample_hmm_sequences, simulate_hmm_pairs)
from deepblast_jax.models.lm import BiLM  # noqa: E402
from deepblast_jax.ops import dp as dp_ops  # noqa: E402
from deepblast_jax.train import DeepBLAST, DeepBLASTConfig  # noqa: E402

N_TRAIN = int(os.environ.get("DEEPBLAST_QUALITY_TRAIN", 1024))
N_VALID = 128
N_TEST = 256
EPOCHS = int(os.environ.get("DEEPBLAST_QUALITY_EPOCHS", 16))
LM_SEQS = int(os.environ.get("DEEPBLAST_QUALITY_LM_SEQS", 8192))
LM_STEPS = int(os.environ.get("DEEPBLAST_QUALITY_LM_STEPS", 1500))
LM_BS = 64
VOCAB = 32
EMBED_DIM = 64                      # aligner input dim
HIDDEN = EMBED_DIM // 4             # BiLM sizing rule of trainer._build_lm


def pretrain_bilm(tok, seed=0):
    """Cloze-LM pretraining on HMM-process sequences; returns
    (lm_params, final_nll, unigram_nll)."""
    rng = np.random.default_rng(seed)
    seqs = sample_hmm_sequences(LM_SEQS, seed=seed + 10)
    toks = np.zeros((len(seqs), MAXLEN), np.int32)
    lens = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        t = np.asarray(tok(s)).ravel()[:MAXLEN]
        toks[i, :len(t)] = t
        lens[i] = len(t)

    lm = BiLM(nin=VOCAB, nout=VOCAB - 1, embedding_dim=HIDDEN,
              hidden_dim=HIDDEN, num_layers=2)
    params = lm.init(jax.random.key(seed), jnp.asarray(toks[:2]),
                     jnp.asarray(lens[:2]))

    def nll(params, tk, ln):
        logp = lm.apply(params, tk, ln)
        mask = (jnp.arange(tk.shape[1])[None, :] < ln[:, None])
        pick = jnp.take_along_axis(logp, tk[..., None], axis=-1)[..., 0]
        return -(pick * mask).sum() / mask.sum()

    tx = optax.adamw(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, tk, ln):
        loss, g = jax.value_and_grad(nll)(params, tk, ln)
        up, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, up), opt, loss

    # unigram floor: the best any context-free predictor can do
    counts = np.bincount(
        np.concatenate([toks[i, :lens[i]] for i in range(len(seqs))]),
        minlength=VOCAB - 1).astype(np.float64)
    p = counts / counts.sum()
    unigram = float(-(p[p > 0] * np.log(p[p > 0])).sum())

    last = None
    for it in range(LM_STEPS):
        idx = rng.choice(len(seqs), LM_BS, replace=False)
        params, opt, last = step(params, opt, jnp.asarray(toks[idx]),
                                 jnp.asarray(lens[idx]))
        if it % 200 == 0:
            print(f"# lm step {it}: nll {float(last):.4f} "
                  f"(unigram floor {unigram:.4f})", flush=True)
    return params, float(last), unigram


def run_arm(name, cfg, tok, train_ds, valid_ds, test, lm_params=None):
    t0 = time.time()
    model = DeepBLAST(cfg, tokenizer=tok, lm_params=lm_params)
    state, history = model.fit(train_ds, valid_ds)
    stats = summarize(eval_model(model, state, test))
    print(f"{name}: {stats} ({time.time() - t0:.0f}s)", flush=True)
    return stats, history


def main():
    t0 = time.time()
    backend = dp_ops.get_backend(None)[0]
    print(f"# backend={backend} train={N_TRAIN} epochs={EPOCHS}",
          flush=True)

    train = simulate_hmm_pairs(N_TRAIN, seed=1)
    valid = simulate_hmm_pairs(N_VALID, seed=2)
    test = simulate_hmm_pairs(N_TEST, seed=3)
    tok = ProtT5Tokenizer()
    train_ds = TMAlignDataset(train, tokenizer=tok, max_len=MAXLEN)
    valid_ds = TMAlignDataset(valid, tokenizer=tok, max_len=MAXLEN)

    def cfg(lm_type):
        return DeepBLASTConfig(
            embedding_dim=EMBED_DIM, hidden_dim=64, layers=2,
            vocab_size=VOCAB, lm_type=lm_type, batch_size=32,
            learning_rate=2e-3, epochs=EPOCHS, scheduler="cosine",
            loss="cross_entropy", pad_multiple=MAXLEN, max_len=MAXLEN,
            backend=backend)

    lm_params, lm_nll, unigram = pretrain_bilm(tok)
    print(f"# pretrained BiLM nll {lm_nll:.4f} vs unigram floor "
          f"{unigram:.4f} (context gain {unigram - lm_nll:.4f} nats)",
          flush=True)

    embed_stats, _ = run_arm("embed-LM", cfg("embed"), tok,
                             train_ds, valid_ds, test)
    rand_stats, _ = run_arm("BiLM random-frozen", cfg("bilstm"), tok,
                            train_ds, valid_ds, test)
    pre_stats, _ = run_arm("BiLM pretrained-frozen", cfg("bilstm"), tok,
                           train_ds, valid_ds, test, lm_params=lm_params)

    g_bl = tune_gap(valid, "blosum62")
    blosum = summarize(nw_stats(test, g_bl, "blosum62"))
    print(f"blosum62 NW (gap={g_bl}): {blosum}", flush=True)
    g_id = tune_gap(valid, "identity")
    ident = summarize(nw_stats(test, g_id, "identity"))
    print(f"identity NW (gap={g_id}): {ident}", flush=True)

    result = {
        "corpus": {"train": N_TRAIN, "valid": N_VALID, "test": N_TEST,
                   "epochs": EPOCHS, "backend": backend,
                   "generator": "3-state secondary-structure-like HMM + "
                                "BLOSUM62-conditional substitution"},
        "lm_pretraining": {"sequences": LM_SEQS, "steps": LM_STEPS,
                           "final_nll": round(lm_nll, 4),
                           "unigram_floor_nll": round(unigram, 4)},
        "alignment_accuracy": {
            "embed_lm": embed_stats,
            "bilm_random_frozen": rand_stats,
            "bilm_pretrained_frozen": pre_stats,
            "nw_blosum62": {**blosum, "gap": g_bl},
            "nw_identity": {**ident, "gap": g_id},
        },
        "wall_s": round(time.time() - t0, 1),
    }
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "quality_bilm_r04.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
