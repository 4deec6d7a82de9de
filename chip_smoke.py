#!/usr/bin/env python3
"""End-to-end check of the program on one GPU.

Runs in one process, through the entry points a user calls, at the full
width of the paper's model (ProtT5-XL geometry with seeded random weights,
frozen, feeding the CNN heads at the trainer's default widths):

1. kernels: every Triton DP pass against the ``lax.scan`` oracle on the
   card (B=256 at 512x512 NW, and a ragged B=16 batch with lengths
   64-1024, NW and SW), and ``jax.grad`` and the double grad through
   ``ops/dp.py``'s custom_vjp against the scan backend;
2. train: ``deepblast-train --lm-type prot_t5`` takes a few steps on
   simulated pairs (batch 16, lengths 64-512) and writes a checkpoint; its
   first step's loss and gradient norm are compared with the same step on
   the scan backend, all under ``jax.default_matmul_precision("highest")``;
3. align: ``DeepBLAST.align`` from that checkpoint, the GPU default
   backend against scan;
4. search: ``deepblast-search`` over 64 query x database pairs, the GPU
   default backend against scan.

Every comparison is printed with its tolerance; any failure raises and the
script exits non-zero.  The last line is one JSON object naming the device.

    python chip_smoke.py                 # one card, the phases above
    python chip_smoke.py --four-cards    # only the data-parallel path

``--four-cards`` checks that the DP's training gradient on a data-sharded
B=256 512x512 batch runs each card's quarter on that card (no gather in
the compiled program) and equals one card's, then compares
``DeepBLAST.fit(mesh="auto")`` at dp=4 with dp=1 at the same global batch
(loss over 3 steps) and ``deepblast-search --mesh auto`` with ``--mesh
none``, on an LM-free model at the heads' default widths.

Without a GPU the script exits non-zero before running anything.  Scratch
files go to ``.chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")

# shapes of each phase (a CPU rehearsal may shrink them)
SIZES = dict(
    kernel_full=(256, 512, 512),
    kernel_ragged=(16, 1024, 1024, 64),     # B, N, M, min length
    train_pairs=64, eval_pairs=16, pair_len=(64, 512), batch=16,
    pad_multiple=512, align_pairs=4, search_seqs=8, lm="prot_t5",
    four_card_pairs=48,
)


def log(*args):
    print(*args, flush=True)


def compare(name, got, want, rtol, atol):
    """Assert ``got`` is within ``rtol``/``atol`` of ``want`` (numpy
    ``allclose`` semantics) and print the worst errors."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - want)
    excess = float(np.max(err - rtol * np.abs(want))) if err.size else 0.0
    log(f"  {name:38s} max|diff| {float(err.max()) if err.size else 0:.3e}"
        f"  max(|diff| - rtol|want|) {excess:.3e}"
        f"  (rtol {rtol:g}, atol {atol:g})")
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: outside rtol {rtol} / atol {atol}")


# ---------------------------------------------------------------------------
# 1. kernels
# ---------------------------------------------------------------------------

def _dp_inputs(B, N, M, min_len, seed):
    import jax.numpy as jnp
    import numpy as np
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, N, M)).astype(np.float32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(np.float32)
    if min_len is None:
        ln = np.full(B, N, np.int32)
        lm = np.full(B, M, np.int32)
    else:
        ln = rng.integers(min_len, N + 1, B).astype(np.int32)
        lm = rng.integers(min_len, M + 1, B).astype(np.int32)
        ln[0], lm[0] = N, M      # one pair spans the whole buffer
    return tuple(map(jnp.asarray, (theta, A, ln, lm)))


def _check_passes(label, theta, A, ln, lm, mode):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepblast_jax.ops import dp_scan, dp_triton
    from deepblast_jax.ops.skew import skew

    log(f"[kernels] {label}")
    op = "softmax"
    td, ad = jax.jit(skew)(theta), jax.jit(skew)(A)
    scan = {
        "forward": jax.jit(lambda *a: dp_scan.forward_scan(
            *a, mode=mode, operator=op)),
        "backward": jax.jit(lambda *a: dp_scan.backward_scan(*a, mode=mode)),
        "adjoint_forward": jax.jit(lambda *a: dp_scan.adjoint_forward_scan(
            *a, mode=mode, operator=op)),
        "adjoint_backward": jax.jit(
            lambda *a: dp_scan.adjoint_backward_scan(*a, mode=mode)),
    }
    tri = {
        "forward": jax.jit(lambda *a: dp_triton.forward(
            *a, mode=mode, operator=op)),
        "forward_score": jax.jit(lambda *a: dp_triton.forward_score(
            *a, mode=mode, operator=op)),
        "backward": jax.jit(lambda *a: dp_triton.backward(*a, mode=mode)),
        "adjoint_forward": jax.jit(lambda *a: dp_triton.adjoint_forward(
            *a, mode=mode, operator=op)),
        "adjoint_backward": jax.jit(
            lambda *a: dp_triton.adjoint_backward(*a, mode=mode)),
    }
    vt, qs = scan["forward"](td, ad, ln, lm)
    vt_t, qs_t = tri["forward"](td, ad, ln, lm)
    compare("forward vt", vt_t, vt, 1e-5, 1e-5)
    for n, a, b in zip("xmy", qs_t, qs):
        compare(f"forward q{n}", a, b, 1e-5, 1e-5)
    compare("forward_score vt", tri["forward_score"](td, ad, ln, lm), vt,
            1e-5, 1e-5)
    Et = jnp.ones_like(vt)
    E = scan["backward"](Et, qs, ln, lm)
    compare("backward E", tri["backward"](Et, qs, ln, lm), E, 1e-4, 1e-4)
    rng = np.random.default_rng(7)
    zt = jax.jit(skew)(jnp.asarray(rng.standard_normal(theta.shape),
                                   theta.dtype))
    za = jax.jit(skew)(jnp.asarray(rng.standard_normal(theta.shape),
                                   theta.dtype))
    vtd, qds = scan["adjoint_forward"](qs, zt, za, ln, lm)
    vtd_t, qds_t = tri["adjoint_forward"](qs, zt, za, ln, lm)
    compare("adjoint_forward vtd", vtd_t, vtd, 1e-4, 1e-4)
    for n, a, b in zip("xmy", qds_t, qds):
        compare(f"adjoint_forward qd{n}", a, b, 1e-4, 1e-4)
    vtd0, qds0 = scan["adjoint_forward"](qs, zt, jnp.zeros_like(za), ln, lm)
    vtd0_t, _ = tri["adjoint_forward"](qs, zt, None, ln, lm)
    compare("adjoint_forward vtd (no gap tangent)", vtd0_t, vtd0, 1e-4, 1e-4)
    Ed = scan["adjoint_backward"](E, qs, qds, ln, lm)
    Ed_t = tri["adjoint_backward"](E, qs, qds, ln, lm)
    compare("adjoint_backward Ed", Ed_t, Ed, 1e-4, 1e-4)
    EdA = Ed * (qs[0] + qs[2]) + E * (qds[0] + qds[2])
    EdA_t = Ed_t * (qs[0] + qs[2]) + E * (qds[0] + qds[2])
    compare("adjoint_backward EdA", EdA_t, EdA, 1e-4, 1e-4)


def _check_grads(label, theta, A, ln, lm, mode):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepblast_jax.ops import dp as dp_ops

    log(f"[kernels] grads through ops/dp.py, {label}")
    W = jnp.asarray(np.random.default_rng(3).standard_normal(theta.shape),
                    theta.dtype)

    def first(backend):
        return jax.jit(jax.grad(lambda t, a: jnp.sum(dp_ops.alignment_score(
            t, a, (ln, lm), mode=mode, backend=backend)), argnums=(0, 1)))

    def second(backend):
        return jax.jit(jax.grad(lambda t, a: jnp.sum(
            dp_ops.expected_alignment(t, a, (ln, lm), mode=mode,
                                      backend=backend) * W),
            argnums=(0, 1)))

    for name, make in (("grad", first), ("double grad", second)):
        want = make("scan")(theta, A)
        got = make("triton")(theta, A)
        compare(f"{name} d/dtheta", got[0], want[0], 1e-4, 1e-4)
        compare(f"{name} d/dA", got[1], want[1], 1e-4, 1e-4)


def phase_kernels():
    B, N, M = SIZES["kernel_full"]
    _check_passes(f"B={B} {N}x{M} nw", *_dp_inputs(B, N, M, None, 0), "nw")
    B, N, M, lo = SIZES["kernel_ragged"]
    for mode in ("nw", "sw"):
        args = _dp_inputs(B, N, M, lo, 1)
        label = f"ragged B={B} lengths {lo}-{N} {mode}"
        _check_passes(label, *args, mode)
        _check_grads(label, *args, mode)


# ---------------------------------------------------------------------------
# 2. train
# ---------------------------------------------------------------------------

def _write_pairs(name, n, seed):
    from deepblast_jax.data.dataset import write_pairs
    from deepblast_jax.sim import simulate_pairs
    lo, hi = SIZES["pair_len"]
    rows = simulate_pairs(n, seed=seed, min_len=lo, max_len=hi)
    path = os.path.join(WORK, name)
    write_pairs(rows, path)
    return path, rows


def _step_metrics(model, state, batch, dropout_key):
    """Loss and gradient global norm of one train step (no update)."""
    import jax
    import optax

    def loss_of(params, lm_params, batch):
        aln, _, _ = model._forward(params, lm_params, batch, train=True,
                                   rngs={"dropout": dropout_key})
        return model.compute_loss(batch, aln)

    @jax.jit
    def metrics(params, lm_params, batch):
        loss, grads = jax.value_and_grad(loss_of)(params, lm_params, batch)
        return loss, optax.global_norm(grads)

    loss, norm = metrics(state.params, state.lm_params, batch)
    return float(loss), float(norm)


def phase_train():
    import jax
    import numpy as np

    from deepblast_jax.cli import train as cli_train
    from deepblast_jax.train import DeepBLAST, DeepBLASTConfig

    log("[train] deepblast-train --lm-type "
        f"{SIZES['lm']}, batch {SIZES['batch']}")
    train_tsv, _ = _write_pairs("train.tsv", SIZES["train_pairs"], 0)
    valid_tsv, _ = _write_pairs("valid.tsv", SIZES["eval_pairs"], 1)
    test_tsv, test_rows = _write_pairs("test.tsv", SIZES["eval_pairs"], 2)
    out = os.path.join(WORK, "model")
    argv = ["--train-pairs", train_tsv, "--valid-pairs", valid_tsv,
            "--test-pairs", test_tsv, "-o", out, "--lm-type", SIZES["lm"],
            "--batch-size", str(SIZES["batch"]), "--epochs", "1",
            "--pad-multiple", str(SIZES["pad_multiple"]),
            "--visualization-fraction", "0", "--seed", "0"]
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        rc = cli_train.main(argv)
    assert rc == 0, f"deepblast-train returned {rc}"
    log(f"  deepblast-train finished in {time.perf_counter() - t0:.1f} s")
    losses = []
    for root, _, files in os.walk(out):
        if "metrics.jsonl" in files:
            with open(os.path.join(root, "metrics.jsonl")) as f:
                for line in f:
                    d = json.loads(line)
                    if d.get("tag") == "train_loss":
                        losses.append(float(d["value"]))
    log(f"  per-step train losses {losses}")
    assert losses and np.isfinite(losses).all(), "non-finite training loss"
    ckpts = os.listdir(os.path.join(out, "checkpoints"))
    assert any(c.endswith(".npz") for c in ckpts), ckpts
    log(f"  checkpoint files {sorted(ckpts)}")

    # the first step again, on each backend, without the update
    with open(os.path.join(out, "config.json")) as f:
        config = DeepBLASTConfig.from_json(f.read())
    results = {}
    with jax.default_matmul_precision("highest"):
        state = None
        for backend in ("triton", "scan"):
            model = DeepBLAST(dataclasses.replace(config, backend=backend))
            if state is None:
                state = model.init()
            ds = model._dataset(config.train_pairs)
            batch = next(iter(model._batches(ds, True, config.seed)))
            _, dropout_key = jax.random.split(jax.random.key(config.seed + 1))
            results[backend] = _step_metrics(
                model, state, model._device_batch(batch), dropout_key)
            log(f"  first step on {backend}: loss {results[backend][0]:.8g}"
                f"  grad norm {results[backend][1]:.8g}")
    del state
    compare("first-step loss, triton vs scan", results["triton"][0],
            results["scan"][0], 1e-4, 0.0)
    compare("first-step loss, deepblast-train vs scan", losses[0],
            results["scan"][0], 1e-4, 0.0)
    compare("first-step grad norm, triton vs scan", results["triton"][1],
            results["scan"][1], 1e-3, 0.0)
    return out, test_rows


# ---------------------------------------------------------------------------
# 3. align
# ---------------------------------------------------------------------------

def _first_split_is_tie(E, states_a, states_b, rel=1e-4):
    """Whether two tracebacks over ``E`` part at a tie of the greedy walk
    (the walk runs from the last cell backwards)."""
    import numpy as np
    ra, rb = states_a[::-1], states_b[::-1]
    k = next(i for i, (a, b) in enumerate(zip(ra, rb)) if a != b)
    i, j, _ = ra[k - 1]
    cands = sorted([E[i - 1, j] if i > 0 else -np.inf,
                    E[i - 1, j - 1] if i > 0 and j > 0 else -np.inf,
                    E[i, j - 1] if j > 0 else -np.inf], reverse=True)
    return abs(cands[0] - cands[1]) <= rel * abs(cands[0]) + 1e-6


def phase_align(out, test_rows):
    import jax
    import numpy as np

    from deepblast_jax.ops import dp as dp_ops
    from deepblast_jax.ops.skew import unskew
    from deepblast_jax.train import DeepBLAST
    from deepblast_jax.train.checkpoint import load_model

    log("[align] DeepBLAST.align from the checkpoint")
    model = load_model(out)
    ref = DeepBLAST(dataclasses.replace(model.config, backend="scan"),
                    tokenizer=model.tokenizer)
    ref.state = model.state
    default = dp_ops.get_backend(model.config.backend)[0]
    decode = {"default": jax.jit(model.decode_stream),
              "scan": jax.jit(ref.decode_stream)}
    for row in test_rows[:SIZES["align_pairs"]]:
        x, y = row[5], row[6]
        got, want = model.align(x, y), ref.align(x, y)
        # the expectations behind both walks
        xt, _ = model.tokenizer(x)
        yt, _ = model.tokenizer(y)
        pm = model.config.pad_multiple
        pad = lambda t: np.pad(np.asarray(t), (0, -(-len(t) // pm) * pm  # noqa: E731
                                              - len(t)))[None]
        batch = dict(x=pad(xt), y=pad(yt),
                     x_len=np.asarray([len(xt)], np.int32),
                     y_len=np.asarray([len(yt)], np.int32))
        E = {k: np.asarray(f(model.state.params, model.state.lm_params,
                             batch)) for k, f in decode.items()}
        compare(f"E stream {len(xt)}x{len(yt)} ({default} vs scan)",
                E["default"], E["scan"], 1e-4, 1e-4)
        same = got == want
        if not same:
            En = np.asarray(unskew(E["scan"], batch["x"].shape[1],
                                   batch["y"].shape[1], offset=1))[0]
            En = En[:len(xt), :len(yt)]
            walk = dp_ops.traceback
            if not _first_split_is_tie(En, walk(En), walk(np.asarray(
                    unskew(E["default"], batch["x"].shape[1],
                           batch["y"].shape[1], offset=1))[0][
                        :len(xt), :len(yt)])):
                raise AssertionError(
                    f"align {len(xt)}x{len(yt)}: tracebacks differ "
                    "outside a tie")
        log(f"  align {len(xt)}x{len(yt)}: "
            f"{'identical' if same else 'differs at a tie'}"
            f" ({got.count(':')} aligned columns)")


# ---------------------------------------------------------------------------
# 4. search
# ---------------------------------------------------------------------------

def _read_scores(path):
    import numpy as np
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    return [r[:2] for r in rows], np.asarray([float(r[2]) for r in rows])


def _search(out, query, db, tsv, *extra):
    from deepblast_jax.cli import search as cli_search
    argv = ["--query-fasta", query, "--db-fasta", db,
            "--load-from-checkpoint", out, "--output-file", tsv,
            "--batch-size", str(SIZES["batch"]),
            "--pad-multiple", str(SIZES["pad_multiple"]), *extra]
    t0 = time.perf_counter()
    rc = cli_search.main(argv)
    assert rc == 0, f"deepblast-search returned {rc}"
    return time.perf_counter() - t0


def _fasta(name, seqs):
    path = os.path.join(WORK, name)
    with open(path, "w") as f:
        for k, s in enumerate(seqs):
            f.write(f">{name.split('.')[0]}{k}\n{s}\n")
    return path


def _search_inputs():
    from deepblast_jax.sim import simulate_pairs
    lo, hi = SIZES["pair_len"]
    n = SIZES["search_seqs"]
    rows = simulate_pairs(n, seed=3, min_len=lo, max_len=hi)
    return (_fasta("query.fa", [r[5] for r in rows]),
            _fasta("db.fa", [r[6] for r in rows]))


def phase_search(out):
    import numpy as np

    from deepblast_jax.ops import dp as dp_ops

    query, db = _search_inputs()
    n = SIZES["search_seqs"] ** 2
    log(f"[search] deepblast-search, {n} query x database pairs")
    default = dp_ops.get_backend(None)[0]
    tsv = {k: os.path.join(WORK, f"search_{k}.tsv")
           for k in ("default", "scan")}
    secs = _search(out, query, db, tsv["default"])
    dp_ops.set_default_backend("scan")
    try:
        _search(out, query, db, tsv["scan"])
    finally:
        dp_ops.set_default_backend(None)
    ids, got = _read_scores(tsv["default"])
    ids_ref, want = _read_scores(tsv["scan"])
    assert ids == ids_ref and len(ids) == n, (len(ids), len(ids_ref))
    log(f"  {n} pairs in {secs:.1f} s on {default} (first call included)")
    # scores are written rounded to 4 decimals, hence the atol
    compare(f"search scores ({default} vs scan)", got, want, 1e-4, 1e-4)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# --four-cards: data-parallel training and sharded search
# ---------------------------------------------------------------------------

class _StepLosses:
    """A logger for ``DeepBLAST.fit`` that keeps the per-step losses."""

    def __init__(self):
        self.losses = []

    def log_scalar(self, tag, value, step):
        if tag == "train_loss":
            self.losses.append(float(value))


def _four_card_dp():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepblast_jax.ops import dp as dp_ops
    from deepblast_jax.parallel import mesh as mesh_lib
    from deepblast_jax.utils.timing import time_fn

    B, N, M = SIZES["kernel_full"]
    theta, A, ln, lm = _dp_inputs(B, N, M, N // 8, 2)
    W = jnp.asarray(np.random.default_rng(4).standard_normal(theta.shape),
                    theta.dtype)
    mesh = mesh_lib.make_mesh(dp=4, tp=1)
    backend = dp_ops.get_backend(None)[0]
    log(f"[four-cards] DP training gradient ({backend}), B={B} {N}x{M}: "
        "data-sharded over 4 cards vs one card")
    grad = jax.jit(jax.grad(lambda t, a, w, n, m: jnp.sum(
        w * dp_ops.expected_alignment(t, a, (n, m))), argnums=(0, 1)))
    args1 = (theta, A, W, ln, lm)
    args4 = [jax.device_put(x, NamedSharding(mesh, P("data")))
             for x in args1]
    with mesh_lib.mesh_context(mesh):
        hlo = grad.lower(*args4).compile().as_text()
        got = grad(*args4)
        t4 = time_fn(grad, *args4)
    want = grad(*args1)
    t1 = time_fn(grad, *args1)
    moves = ("all-gather", "all-to-all", "collective-permute")
    log(f"  collectives in the sharded program: "
        f"{ {op: hlo.count(op + '(') for op in moves + ('all-reduce',)} }")
    for name, g, w in zip(("d/dtheta", "d/dA"), got, want):
        assert g.sharding.spec == P("data"), g.sharding
        compare(f"{name}, 4 cards vs one", g, w, 1e-5, 1e-5)
    if any(op + "(" in hlo for op in moves):
        raise AssertionError("the sharded DP moves pairs between cards")
    log(f"  median ms: one card {1e3 * float(np.median(t1)):.3f}, "
        f"4 cards {1e3 * float(np.median(t4)):.3f} (10 warmed calls each)")


def phase_four_cards():
    import jax

    from deepblast_jax.data.dataset import TMAlignDataset
    from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
    from deepblast_jax.train.checkpoint import Checkpointer, save_config

    n = len(jax.devices())
    assert n == 4, f"--four-cards needs 4 devices, JAX sees {n}"
    _four_card_dp()
    train_tsv, _ = _write_pairs("train4.tsv", SIZES["four_card_pairs"], 0)
    config = DeepBLASTConfig(lm_type="embed", batch_size=SIZES["batch"],
                             epochs=1, dropout=0.0, scheduler="none",
                             pad_multiple=SIZES["pad_multiple"],
                             learning_rate=1e-3, train_pairs=train_tsv)
    log(f"[four-cards] fit, global batch {config.batch_size}: dp=4 vs dp=1")
    losses = {}
    with jax.default_matmul_precision("highest"):
        for label, mesh in (("dp=1", None), ("dp=4", "auto")):
            model = DeepBLAST(config)
            ds = TMAlignDataset(train_tsv, tokenizer=model.tokenizer,
                                max_len=config.max_len)
            logger = _StepLosses()
            model.fit(ds, logger=logger, mesh=mesh)
            shape = None if model.mesh is None else dict(model.mesh.shape)
            log(f"  {label}: mesh {shape}, step losses {logger.losses}")
            losses[label] = logger.losses
    assert len(losses["dp=4"]) == 3, losses
    compare("loss over 3 steps, dp=4 vs dp=1", losses["dp=4"],
            losses["dp=1"], 1e-4, 0.0)

    out = os.path.join(WORK, "model4")
    save_config(config, out)
    Checkpointer(os.path.join(out, "checkpoints")).save(model.state)
    query, db = _search_inputs()
    log("[four-cards] deepblast-search --mesh auto vs --mesh none")
    tsv = {k: os.path.join(WORK, f"search4_{k}.tsv")
           for k in ("auto", "none")}
    # "highest": the two programs would otherwise pick TF32 matmul and conv
    # algorithms per shard shape, and the scores would differ in TF32's
    # last digits rather than by the sharding
    with jax.default_matmul_precision("highest"):
        for k in tsv:
            _search(out, query, db, tsv[k], "--mesh", k)
    ids, got = _read_scores(tsv["auto"])
    ids_ref, want = _read_scores(tsv["none"])
    assert ids == ids_ref
    compare("search scores, 4-card mesh vs one card", got, want, 1e-5, 1e-4)


# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the data-parallel path on 4 GPUs")
    args = p.parse_args(argv)

    import jax

    from deepblast_jax.utils.device import card, device_info, require_gpu

    require_gpu("chip_smoke.py")
    from deepblast_jax.utils.cache import enable_compile_cache
    enable_compile_cache()
    log(f"card: {card()}")
    log(f"jax {jax.__version__} devices: {jax.devices()}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_kernels()
        log(f"  kernels done at {time.perf_counter() - t0:.1f} s")
        out, test_rows = phase_train()
        log(f"  train done at {time.perf_counter() - t0:.1f} s")
        phase_align(out, test_rows)
        log(f"  align done at {time.perf_counter() - t0:.1f} s")
        phase_search(out)
        log(f"  search done at {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"card: {card()}")
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
