"""``deepblast-search`` — score query x database FASTA pairs
(reference: scripts/deepblast-search, which is stale/broken upstream:
it imports a removed class, scripts/deepblast-search:9).

Beyond the reference (which runs on one GPU): with more than one device
and ``--mesh auto`` (the default), scoring batches are sharded over the
``data`` axis of a device mesh — parameters replicated, pairs split —
so database scans scale across the cards the same way training does.

Batch formation is a single accumulator: pairs flush in input order
every ``--batch-size``, padded to the batch max rounded up to
``--pad-multiple`` (so batch shapes repeat and the jitted scorer
compiles a handful of programs, not one per batch).
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-search")
    parser.add_argument("--query-fasta", type=str, required=True)
    parser.add_argument("--db-fasta", type=str, required=True)
    parser.add_argument("--load-from-checkpoint", type=str, required=True,
                        help="model output directory (with config.json)")
    parser.add_argument("--output-file", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=10)
    parser.add_argument("--mesh", choices=["auto", "none"], default="auto",
                        help="shard scoring batches over the data axis of "
                             "a device mesh when >1 device is visible")
    parser.add_argument("--pad-multiple", type=int, default=64,
                        help="round padded sequence lengths up to this "
                             "multiple so batch shapes bucket and the "
                             "scorer compiles a handful of programs "
                             "instead of one per batch")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from deepblast_jax.data.dataset import FastaDataset
    from deepblast_jax.data.state_utils import pad_sequences
    from deepblast_jax.parallel import mesh as mesh_lib
    from deepblast_jax.train.checkpoint import load_model

    model = load_model(args.load_from_checkpoint)
    ds = FastaDataset(args.query_fasta, args.db_fasta,
                      tokenizer=model.tokenizer)

    mesh = None
    dp = 1
    # jit the scorer in BOTH paths: eager score_pairs dispatches each op
    # separately.  Params ride as explicit jit args, never closure
    # constants (XLA constant-folds large closures through layout ops).
    if args.mesh == "auto" and len(jax.devices()) > 1:
        dp = len(jax.devices())  # flush() pads the batch up to dp shards
        mesh = mesh_lib.make_mesh(dp=dp, tp=1)
        repl = mesh_lib.replicated_sharding(mesh)
        params = jax.device_put(model.state.params, repl)
        lm_params = jax.device_put(model.state.lm_params, repl) \
            if model.state.lm_params is not None else None
        bsh = mesh_lib.batch_sharding(mesh)

    else:
        params = model.state.params
        lm_params = model.state.lm_params

    @jax.jit
    def _score(params, lm_params, batch):
        state = SimpleNamespace(params=params, lm_params=lm_params)
        return model.score_pairs(state, batch)

    def _pad_rounded(seqs):
        # round padded lengths up to --pad-multiple so batch shapes
        # repeat and the jitted scorer compiles once per shape, not
        # once per flush
        toks, lens = pad_sequences(seqs)
        pm = max(1, args.pad_multiple)
        L = -(-toks.shape[1] // pm) * pm
        if L != toks.shape[1]:
            toks = np.pad(toks, ((0, 0), (0, L - toks.shape[1])))
        return toks, lens

    # every launch is padded (tail item replicated) to the same row
    # count, so each shape compiles exactly one program — partial
    # flushes at end-of-scan reuse it instead of compiling per ragged
    # tail shape; drain() slices the replicas back off
    full = args.batch_size
    if mesh is not None and full % dp:
        full += dp - full % dp

    def dispatch(items):
        """Tokenize, pad, and launch one scoring batch (async dispatch —
        jax returns before the device finishes)."""
        its = items + [items[-1]] * (full - len(items))
        xs, xl = _pad_rounded([it["x"] for it in its])
        ys, yl = _pad_rounded([it["y"] for it in its])
        batch = dict(x=jnp.asarray(xs), y=jnp.asarray(ys),
                     x_len=jnp.asarray(xl), y_len=jnp.asarray(yl))
        if mesh is not None:
            batch = {k: jax.device_put(v, bsh) for k, v in batch.items()}
        # under the mesh each device scores its own share of the batch
        with mesh_lib.mesh_context(mesh):
            return items, _score(params, lm_params, batch), xl, yl

    def drain(pending, out):
        # the device-to-host readback happens one batch late, so host
        # tokenization of batch k+1 overlaps device compute of batch k
        # (the trainer's deferred-loss-readback pattern)
        items, dev_scores, xl, yl = pending
        scores = np.asarray(dev_scores)[:len(items)]
        for it, s, ql, dl in zip(items, scores, xl, yl):
            norm = s / (float(ql) * float(dl))
            out.write(f"{it['qid']}\t{it['dbid']}\t"
                      f"{np.round(s, 4)}\t{np.round(norm, 4)}\n")

    from collections import deque

    with open(args.output_file, "w") as out:
        # a 2-deep in-flight queue: host collate of batch k+2 overlaps
        # device compute of k+1 while k's readback completes
        buf, inflight = [], deque()

        def launch(items):
            if len(inflight) >= 2:
                drain(inflight.popleft(), out)
            inflight.append(dispatch(items))

        for item in ds:
            buf.append(item)
            if len(buf) >= args.batch_size:
                launch(buf)
                buf = []
        if buf:
            launch(buf)
        while inflight:
            drain(inflight.popleft(), out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
