"""Training system (reference: deepblast/trainer.py).

``DeepBLAST`` is the top-level model+trainer object mirroring the reference
LightningModule's capabilities — loss selection, AdamW + schedulers, frozen
LM handling, validation statistics, checkpointing, the ``align(x, y)``
string API — rebuilt in JAX:

* the language model runs as a separate frozen computation
  (``stop_gradient``) feeding the aligner, exactly like the reference's
  ``no_grad`` LM call (deepblast/alignment.py:90-93);
* one jitted train step under a ``(data, model)`` mesh: batch sharded on
  ``data``, params replicated (or TP-sharded), XLA inserts the gradient
  all-reduce — replacing Lightning DDP/NCCL
  (reference: scripts/deepblast-train:66-84);
* variable-length pairs ride static bucketed shapes with per-pair length
  masking instead of PackedSequence plumbing;
* ``.npz`` checkpoints of params + optimizer state, monitored on
  validation loss like the reference's ModelCheckpoint
  (reference: scripts/deepblast-train:57-63).
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial
from typing import Any, Optional

import chex
import jax
import jax.numpy as jnp
import numpy as np
import optax

from deepblast_jax.data.alphabet import ProtT5Tokenizer
from deepblast_jax.data.dataset import TMAlignDataset, make_batches
from deepblast_jax.data.state_utils import revstate_f, states2edges
from deepblast_jax.eval.score import (
    ROC_COLUMNS,
    alignment_text,
    filter_gaps,
    roc_edges,
)
from deepblast_jax.models.aligner import NeuralAligner
from deepblast_jax.models.lm import BiLM, T5Config, T5Encoder, TokenEmbed
from deepblast_jax.ops import dp as dp_ops
from deepblast_jax.parallel import mesh as mesh_lib
from deepblast_jax.train.losses import get_loss
from deepblast_jax.train.schedules import make_schedule

__all__ = ["DeepBLASTConfig", "DeepBLAST", "TrainState"]


@dataclasses.dataclass
class DeepBLASTConfig:
    """Hyper-parameters (reference: deepblast/trainer.py:27-50,338-419)."""

    # model
    embedding_dim: int = 1024       # LM feature dim fed to the heads
    hidden_dim: int = 1024
    layers: int = 2
    k_size: int = 5
    dropout: float = 0.0
    layer_type: str = "cnn"
    alignment_mode: str = "needleman-wunsch"
    operator: str = "softmax"
    backend: Optional[str] = None
    # language model
    lm_type: str = "embed"          # embed | bilstm | prot_t5
    vocab_size: int = 32
    finetune: bool = False
    # Feature-schema marker (ADVICE r4): round 4 added a parameter-free
    # one-hot identity channel to bilstm features (_lm_apply), changing
    # the aligner input dim from embedding_dim to embedding_dim +
    # vocab_size.  The flag is persisted in config.json so checkpoints
    # self-describe their head-input schema; pre-change bilstm
    # checkpoints (no key in their JSON) are rejected with a clear error
    # in from_json, and setting the flag false rebuilds the pre-change
    # architecture so those checkpoints can still be loaded.
    bilstm_onehot_channel: bool = True
    # optimisation
    batch_size: int = 32
    learning_rate: float = 5e-5
    epochs: int = 10
    scheduler: str = "cosine"
    loss: str = "cross_entropy"
    grad_clip: Optional[float] = None
    grad_accum: int = 1
    # train this many steps per device dispatch (lax.scan inside one jit):
    # amortises the per-dispatch host overhead.  Consecutive same-shape
    # batches are stacked; stragglers run as single steps.
    steps_per_dispatch: int = 1
    mask_gaps: bool = True
    seed: int = 0
    # "32" | "bf16" | "16": head/LM matmul compute dtype (reference
    # --precision, scripts/deepblast-train:95-103); DP stays fp32.
    precision: str = "32"
    # data
    train_pairs: Optional[str] = None
    valid_pairs: Optional[str] = None
    test_pairs: Optional[str] = None
    max_len: int = 1024
    pad_multiple: int = 16
    # infra
    output_directory: Optional[str] = None
    visualization_fraction: float = 0.1
    tp: int = 1
    use_tp_params: bool = False

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s):
        d = json.loads(s)
        if d.get("lm_type") == "bilstm" and "bilstm_onehot_channel" not in d:
            raise ValueError(
                "this bilstm checkpoint predates the one-hot identity "
                "channel added to the LM features (head input dim changed "
                "from embedding_dim to embedding_dim + vocab_size), so its "
                "head weights cannot load into the current architecture. "
                "Add '\"bilstm_onehot_channel\": false' to its config.json "
                "to rebuild the pre-change architecture, or re-train.")
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


#: --precision value -> aligner/LM matmul dtype (None = full fp32)
_PRECISION_DTYPES = {"32": None, "bf16": "bfloat16", "16": "float16"}


@chex.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    lm_params: Any
    opt_state: Any


class DeepBLAST:
    """Top-level alignment model + training loop."""

    def __init__(self, config: DeepBLASTConfig, tokenizer=None,
                 lm=None, lm_params=None):
        self.config = config
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        self.loss_fn = get_loss(config.loss)
        self.lm = lm if lm is not None else self._build_lm()
        self._ext_lm_params = lm_params
        self.aligner = NeuralAligner(
            # bilstm features carry an extra one-hot identity channel
            # (see _lm_apply; gated by the persisted schema marker)
            embedding_dim=config.embedding_dim + (
                config.vocab_size if (config.lm_type == "bilstm"
                                      and config.bilstm_onehot_channel)
                else 0),
            hidden_dim=config.hidden_dim,
            layers=config.layers,
            k_size=config.k_size,
            dropout=config.dropout,
            layer_type=config.layer_type,
            alignment_mode=config.alignment_mode,
            operator=config.operator,
            backend=config.backend,
            matmul_dtype=_PRECISION_DTYPES[config.precision],
        )
        self.tx = self._build_optimizer()
        self.mesh = None
        self._train_step = None
        self._val_step = None
        self._decode_stream = None

    # -- construction ------------------------------------------------------

    def _build_lm(self):
        c = self.config
        if c.lm_type == "embed":
            return TokenEmbed(vocab=c.vocab_size, dim=c.embedding_dim)
        if c.lm_type == "bilstm":
            hidden = c.embedding_dim // 4
            return BiLM(nin=c.vocab_size, nout=c.vocab_size - 1,
                        embedding_dim=hidden, hidden_dim=hidden,
                        num_layers=2)
        if c.lm_type == "prot_t5":
            mm = _PRECISION_DTYPES[c.precision]
            dt = jnp.dtype(mm) if mm else jnp.float32
            return T5Encoder(T5Config.prot_t5_xl(dtype=dt))
        raise ValueError(f"unknown lm_type {c.lm_type!r}")

    def _lm_apply(self, lm_params, tokens, lengths):
        if isinstance(self.lm, BiLM):
            # BiLM.encode is a *cloze* contract: features at position i
            # see only the neighbours, never x_i itself — alignment
            # scoring needs residue identity above all, so concat a
            # parameter-free one-hot identity channel (the heads' first
            # Dense learns the mix — exactly the reference's LMEmbed
            # combination, deepblast/embedding.py:5-39, which its BiLM
            # path composes via StackedRNN's embedded input).
            feats = self.lm.apply(lm_params, tokens, lengths,
                                  method=BiLM.encode)
            # raw feature scale is kept deliberately: per-position
            # standardization was A/B-tested and LOSES badly (F1 0.68 ->
            # 0.51 on the HMM corpus — LSTM state magnitudes are
            # informative; docs/QUALITY.md round 4)
            if not self.config.bilstm_onehot_channel:
                return feats  # pre-round-4 schema (old checkpoints)
            oh = jax.nn.one_hot(tokens, self.config.vocab_size,
                                dtype=feats.dtype)
            return jnp.concatenate([oh, feats], axis=-1)
        if isinstance(self.lm, T5Encoder):
            L = tokens.shape[1]
            mask = jnp.arange(L)[None, :] < lengths[:, None]
            return self.lm.apply(lm_params, tokens, mask)
        return self.lm.apply(lm_params, tokens)

    def _build_optimizer(self):
        c = self.config
        sched = make_schedule(c.scheduler, c.learning_rate, c.epochs,
                              steps_per_epoch=self._steps_per_epoch())
        chain = []
        if c.grad_clip:
            chain.append(optax.clip_by_global_norm(c.grad_clip))
        chain.append(optax.adamw(sched))
        tx = optax.chain(*chain)
        if c.grad_accum > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=c.grad_accum)
        return tx

    def _steps_per_epoch(self):
        # best effort; exact value only affects per-step schedules
        return getattr(self, "_spe", 1)

    def init(self, rng=None, sample_len=32):
        """Initialise parameters; returns a :class:`TrainState`."""
        c = self.config
        rng = rng if rng is not None else jax.random.key(c.seed)
        r_lm, r_al = jax.random.split(rng)
        tok = jnp.zeros((1, sample_len), jnp.int32)
        lens = jnp.full((1,), sample_len, jnp.int32)
        if self._ext_lm_params is not None:
            lm_params = self._ext_lm_params
        else:
            lm_params = self.lm.init(r_lm, tok, lens)
        h = self._lm_apply(lm_params, tok, lens)
        params = self.aligner.init(r_al, h, h, (lens, lens))
        trainable = dict(aligner=params["params"])
        if c.finetune:
            trainable["lm"] = lm_params["params"]
            lm_params = {}  # everything is trainable
        opt_state = self.tx.init(trainable)
        return TrainState(step=jnp.zeros((), jnp.int32), params=trainable,
                          lm_params=lm_params, opt_state=opt_state)

    # -- forward / loss ----------------------------------------------------

    def _embeddings(self, params, lm_params, batch, frozen=True):
        if self.config.finetune and "lm" in params:
            lm_p = {"params": params["lm"]}
        else:
            lm_p = lm_params
        hx = self._lm_apply(lm_p, batch["x"], batch["x_len"])
        hy = self._lm_apply(lm_p, batch["y"], batch["y_len"])
        if frozen and not self.config.finetune:
            hx = jax.lax.stop_gradient(hx)
            hy = jax.lax.stop_gradient(hy)
        return hx, hy

    def _forward(self, params, lm_params, batch, train=False, rngs=None):
        hx, hy = self._embeddings(params, lm_params, batch)
        lengths = (batch["x_len"], batch["y_len"])
        aln, theta, A = self.aligner.apply(
            {"params": params["aligner"]}, hx, hy, lengths,
            deterministic=not train, rngs=rngs)
        return aln, theta, A

    def compute_loss(self, batch, aln):
        c = self.config
        G = batch["gmask"] if c.mask_gaps else jnp.ones_like(batch["gmask"])
        target = batch["path"] if c.loss == "path" else batch["aln"]
        # aln may arrive as uint8 (_shrink_batch cuts transfer bytes);
        # cast on device — XLA fuses it into the loss
        target = target.astype(aln.dtype)
        return self.loss_fn(target, aln, batch["x_len"], batch["y_len"], G)

    # -- jitted steps ------------------------------------------------------

    def make_train_step(self):
        def step(state: TrainState, batch, dropout_rng):
            def loss_of(params):
                rngs = {"dropout": dropout_rng}
                aln, theta, A = self._forward(
                    params, state.lm_params, batch, train=True, rngs=rngs)
                return self.compute_loss(batch, aln)

            loss, grads = jax.value_and_grad(loss_of)(state.params)
            updates, opt_state = self.tx.update(
                grads, state.opt_state, state.params)
            params = optax.apply_updates(state.params, updates)
            new_state = state.replace(step=state.step + 1, params=params,
                                      opt_state=opt_state)
            return new_state, loss

        return jax.jit(step, donate_argnums=(0,))

    def make_train_multi_step(self):
        """K train steps in one jitted dispatch: ``lax.scan`` over stacked
        (K, B, ...) batches.  Identical per-step semantics to
        :meth:`make_train_step`; amortises the per-dispatch host cost."""
        def body(state: TrainState, xs):
            batch, dropout_rng = xs

            def loss_of(params):
                rngs = {"dropout": dropout_rng}
                aln, theta, A = self._forward(
                    params, state.lm_params, batch, train=True, rngs=rngs)
                return self.compute_loss(batch, aln)

            loss, grads = jax.value_and_grad(loss_of)(state.params)
            updates, opt_state = self.tx.update(
                grads, state.opt_state, state.params)
            params = optax.apply_updates(state.params, updates)
            return state.replace(step=state.step + 1, params=params,
                                 opt_state=opt_state), loss

        def multi(state: TrainState, batches, dropout_rngs):
            return jax.lax.scan(body, state, (batches, dropout_rngs))

        return jax.jit(multi, donate_argnums=(0,))

    def make_val_step(self):
        def step(state: TrainState, batch):
            aln, theta, A = self._forward(
                state.params, state.lm_params, batch, train=False)
            loss = self.compute_loss(batch, aln)
            return loss, aln, theta, A

        return jax.jit(step)

    # -- data --------------------------------------------------------------

    def _dataset(self, path, **kw):
        return TMAlignDataset(path, tokenizer=self.tokenizer,
                              max_len=self.config.max_len,
                              mask_gaps=True, **kw)

    def _batches(self, dataset, shuffle, seed):
        return make_batches(dataset, self.config.batch_size, shuffle=shuffle,
                            seed=seed, pad_multiple=self.config.pad_multiple,
                            drop_last=self.mesh is not None)

    def _consume_loss(self, pending, losses, logger):
        vals, step0 = pending  # step0 = step number of the first value
        vals = np.atleast_1d(np.asarray(vals))
        assert not np.isnan(vals).any(), "NaN training loss"
        for i, v in enumerate(vals):
            losses.append(float(v))
            if logger:
                logger.log_scalar("train_loss", float(v), step0 + i)

    def _shrink_batch(self, batch):
        """Cut host->device bytes per step ~4x: the (B, Lx, Ly) float32
        target matrices dominate the transfer (2.7 MB/batch at 32x96^2 vs
        ~50 KB of tokens).  ``aln``
        is a 0/1 incidence matrix and ships as uint8 (compute_loss casts
        back on device); ``path`` is real-valued and only consumed by
        the path loss, so other losses drop it from the transfer
        entirely (visualization only reads ``aln``)."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, list):
                out[k] = v
            elif k == "path" and self.config.loss != "path":
                continue
            elif k == "aln":
                a = np.asarray(v)
                # lossless only: a user dataset could carry soft targets
                u = a.astype(np.uint8)
                out[k] = u if (a.dtype != np.uint8
                               and np.array_equal(a, u)) else a
            else:
                out[k] = v
        return out

    def _device_batch(self, batch):
        batch = self._shrink_batch(batch)
        arrays = {k: jnp.asarray(v) for k, v in batch.items()
                  if not isinstance(v, list)}
        if self.mesh is not None:
            arrays = mesh_lib.shard_batch(arrays, self.mesh)
        return arrays

    def _device_chunk(self, chunk):
        """Stack K same-shape batches into (K, B, ...) device arrays."""
        chunk = [self._shrink_batch(b) for b in chunk]
        keys = [k for k, v in chunk[0].items() if not isinstance(v, list)]
        arrays = {k: jnp.asarray(np.stack([np.asarray(b[k]) for b in chunk]))
                  for k in keys}
        if self.mesh is not None:
            arrays = mesh_lib.shard_batch(arrays, self.mesh, stacked=True)
        return arrays

    @staticmethod
    def _batch_shapes(batch):
        return tuple(sorted((k, np.asarray(v).shape)
                            for k, v in batch.items()
                            if not isinstance(v, list)))

    # -- the fit loop ------------------------------------------------------

    def fit(self, train_dataset=None, valid_dataset=None, callbacks=(),
            logger=None, checkpointer=None, mesh=None):
        """Train.  With ``mesh`` (or more than one device and
        ``mesh="auto"``), the batch is sharded over the ``data`` axis and
        parameters are replicated — XLA inserts the gradient all-reduce
        (the reference's DDP, scripts/deepblast-train:78)."""
        c = self.config
        if mesh == "auto":
            # Use every device the batch can be split over: the data axis is
            # the largest divisor of batch_size that fits n_devices // tp
            # (a subset mesh when batch_size is small keeps tiny-config runs
            # working instead of erroring, mirroring DDP's behaviour of just
            # using the devices you give it).
            n = len(jax.devices()) // max(1, c.tp)
            dp = max((k for k in range(1, n + 1)
                      if c.batch_size % k == 0), default=1)
            if dp * c.tp > 1:
                mesh = mesh_lib.make_mesh(
                    dp=dp, tp=c.tp, devices=jax.devices()[:dp * c.tp])
            else:
                mesh = None
        self.mesh = mesh
        if mesh is not None and c.batch_size % mesh.shape["data"] != 0:
            raise ValueError("batch_size must divide the data mesh axis")
        # under the mesh the DP splits its work over the data axis
        # (ops/dp.py::_per_shard)
        with mesh_lib.mesh_context(mesh):
            return self._fit(train_dataset, valid_dataset, callbacks,
                             logger, checkpointer)

    def _fit(self, train_dataset, valid_dataset, callbacks, logger,
             checkpointer):
        c = self.config
        mesh = self.mesh
        train_dataset = train_dataset or self._dataset(c.train_pairs)
        valid_dataset = valid_dataset or (
            self._dataset(c.valid_pairs) if c.valid_pairs else None)
        self._spe = max(1, len(train_dataset) // max(1, c.batch_size))
        self.tx = self._build_optimizer()

        # resume from a restored checkpoint when present
        # (reference: --load-from-checkpoint, scripts/deepblast-train:21-24)
        state = getattr(self, "state", None)
        if state is None:
            state = self.init()
        if mesh is not None:
            repl = mesh_lib.replicated_sharding(mesh)
            state = jax.device_put(state, repl)
        train_step = self.make_train_step()
        K = max(1, c.steps_per_dispatch)
        multi_step = self.make_train_multi_step() if K > 1 else None
        val_step = self.make_val_step()
        rng = jax.random.key(c.seed + 1)
        history = []
        best = np.inf
        step0 = int(state.step)
        for epoch in range(c.epochs):
            losses = []
            # One-step-deferred loss readback: float(loss) blocks on the
            # device, so consuming dispatch i's losses only after issuing
            # dispatch i+1 overlaps host batch prep + dispatch with device
            # compute.  The NaN
            # assert consequently fires one dispatch late — same guarantee
            # the reference's detect_anomaly gives at far lower cost.
            # With steps_per_dispatch > 1, K consecutive same-shape batches
            # are stacked and scanned inside one jit; stragglers (shape
            # changes, epoch tail) run as single steps so only two
            # programs ever compile.
            pending = None
            chunk = []
            chunk_shape = None

            def _issue(batches):
                nonlocal state, pending, step0, rng
                if len(batches) == K and multi_step is not None:
                    keys = jax.random.split(rng, K + 1)
                    rng = keys[0]
                    state, lvec = multi_step(
                        state, self._device_chunk(batches), keys[1:])
                    if pending is not None:
                        self._consume_loss(pending, losses, logger)
                    pending = (lvec, step0 + 1)
                    step0 += K
                else:
                    for b in batches:
                        _issue_single(b)

            def _issue_single(batch):
                nonlocal state, pending, step0, rng
                rng, dr = jax.random.split(rng)
                state, loss = train_step(state, self._device_batch(batch),
                                         dr)
                if pending is not None:
                    self._consume_loss(pending, losses, logger)
                step0 += 1
                pending = (loss, step0)

            for batch in self._batches(train_dataset, True, c.seed + epoch):
                if K == 1:
                    _issue_single(batch)
                    continue
                sh = self._batch_shapes(batch)
                if chunk and sh != chunk_shape:
                    _issue(chunk)
                    chunk = []
                chunk.append(batch)
                chunk_shape = sh
                if len(chunk) == K:
                    _issue(chunk)
                    chunk = []
            if chunk:
                _issue(chunk)
                chunk = []
            if pending is not None:
                self._consume_loss(pending, losses, logger)
            entry = {"epoch": epoch, "train_loss": float(np.mean(losses))}
            if valid_dataset is not None:
                vlosses = []
                vstats = []
                for bi, batch in enumerate(
                        self._batches(valid_dataset, False, 0)):
                    vloss, aln, theta, gap = val_step(
                        state, self._device_batch(batch))
                    vlosses.append(float(vloss))
                    # alignment accuracy stats over the FULL validation
                    # epoch (reference aggregates tp/fp/fn/ppv across all
                    # batches, deepblast/trainer.py:249-262); only the
                    # figures are sampled by visualization_fraction.
                    vstats += self.validation_stats(state, batch, aln)
                    if (logger and bi == 0
                            and c.visualization_fraction > 0):
                        self._log_visualizations(
                            logger, batch, aln, theta, gap, int(state.step))
                entry["validation_loss"] = float(np.mean(vlosses))
                if vstats:
                    cols = ["val_tp", "val_fp", "val_fn", "val_perc_id",
                            "val_ppv", "val_fnr", "val_fdr"]
                    means = np.mean(np.asarray(vstats, float), axis=0)
                    for col, v in zip(cols, means):
                        entry[col] = float(v)
                        if logger:
                            logger.log_scalar(col, v, int(state.step))
                if logger:
                    logger.log_scalar("validation_loss",
                                      entry["validation_loss"], int(state.step))
                if checkpointer and entry["validation_loss"] < best:
                    best = entry["validation_loss"]
                    checkpointer.save(state, entry)
            elif checkpointer:
                checkpointer.save(state, entry)
            history.append(entry)
            for cb in callbacks:
                cb(self, state, entry)
        self.state = state
        return state, history

    # -- evaluation --------------------------------------------------------

    def _log_visualizations(self, logger, batch, aln, theta, gap, step,
                            max_pairs=2):
        """Alignment matrix figures + text renders (reference:
        deepblast/trainer.py:210-231)."""
        import random as _random

        from deepblast_jax.eval.score import (
            alignment_text, alignment_visualization)
        aln_np = np.asarray(aln)
        for b in range(min(max_pairs, len(batch["x_len"]))):
            if _random.random() > self.config.visualization_fraction:
                continue
            n, mm = int(batch["x_len"][b]), int(batch["y_len"][b])
            try:
                fig, _ = alignment_visualization(
                    np.asarray(batch["aln"][b]), aln_np[b],
                    np.asarray(theta[b]), np.asarray(gap[b]), n, mm)
                logger.log_figure(f"alignment-matrix/{b}", fig, step)
                pred_states = [s for _, _, s in
                               dp_ops.traceback(aln_np[b, :n, :mm])]
                x_str = self.tokenizer.decode(batch["x"][b][:n])
                y_str = self.tokenizer.decode(batch["y"][b][:mm])
                true_states = np.asarray(batch["states"][b])
                from deepblast_jax.data.state_utils import states2edges
                from deepblast_jax.eval.score import filter_gaps, roc_edges
                stats = roc_edges(
                    filter_gaps(true_states, states2edges(true_states)),
                    filter_gaps(pred_states, states2edges(pred_states)))
                text = alignment_text(
                    x_str, y_str, np.asarray(pred_states), true_states,
                    list(stats))
                logger.log_text(f"alignment/{b}", text, step)
            except Exception:   # visualization must never kill training
                continue

    def validation_stats(self, state, batch, aln):
        """Per-pair traceback accuracy stats
        (reference: deepblast/trainer.py:190-233)."""
        stats = []
        aln = np.asarray(aln)
        for b in range(len(batch["x_len"])):
            n, mm = int(batch["x_len"][b]), int(batch["y_len"][b])
            pred_states = [s for _, _, s in
                           dp_ops.traceback(aln[b, :n, :mm])]
            true_states = list(np.asarray(batch["states"][b]))
            pred_edges = filter_gaps(pred_states, states2edges(pred_states))
            true_edges = filter_gaps(true_states, states2edges(true_states))
            stats.append(roc_edges(true_edges, pred_edges))
        return stats

    def test(self, state=None, test_dataset=None):
        """Per-pair stats table (reference: deepblast/trainer.py:266-295)."""
        import pandas as pd
        c = self.config
        state = state or self.state
        test_dataset = test_dataset or self._dataset(
            c.test_pairs, return_names=True)
        val_step = self.make_val_step()
        rows = []
        for batch in self._batches(test_dataset, False, 0):
            loss, aln, theta, A = val_step(state, self._device_batch(batch))
            stats = self.validation_stats(state, batch, aln)
            for b, st in enumerate(stats):
                row = dict(zip([f"test_{c_}" for c_ in ROC_COLUMNS], st))
                if "names" in batch:
                    row["query_name"], row["key_name"] = batch["names"][b]
                rows.append(row)
        return pd.DataFrame(rows)

    # -- inference ---------------------------------------------------------

    def align(self, x: str, y: str, state=None) -> str:
        """One-shot string alignment API
        (reference: deepblast/trainer.py:80-88).

        Tokens are padded to a multiple of ``pad_multiple`` so the jitted
        decode compiles once per length bucket (padding never changes the
        result: the heads and the DP mask by length).  The decode returns
        the expectation in the DP's diagonal stream layout and the
        traceback walks it on host, so no unskew relayout runs."""
        state = state or self.state
        x_tok, _ = self.tokenizer(x)
        y_tok, _ = self.tokenizer(y)
        pm = max(1, self.config.pad_multiple)

        def padded(tok):
            L = -(-len(tok) // pm) * pm
            return jnp.asarray(np.pad(np.asarray(tok), (0, L - len(tok))))[None]

        batch = dict(x=padded(x_tok), y=padded(y_tok),
                     x_len=jnp.asarray([len(x_tok)], jnp.int32),
                     y_len=jnp.asarray([len(y_tok)], jnp.int32))
        if self._decode_stream is None:
            self._decode_stream = jax.jit(self.decode_stream)
        E_s = self._decode_stream(state.params, state.lm_params, batch)
        states = dp_ops.traceback_stream(E_s, len(x_tok), len(y_tok), 0)
        return "".join(revstate_f(s) for _, _, s in states)

    def decode_stream(self, params, lm_params, batch):
        """Expected alignments of a batch in the DP's stream layout."""
        hx, hy = self._embeddings(params, lm_params, batch)
        lengths = (batch["x_len"], batch["y_len"])
        theta, A = self.aligner.apply(
            {"params": params["aligner"]}, hx, hy, lengths,
            method=NeuralAligner.potentials)
        return dp_ops.expected_alignment_stream(
            theta, A, lengths, mode=self.aligner.mode,
            operator=self.config.operator, backend=self.config.backend)

    def score_pairs(self, state, batch):
        """Alignment scores for search
        (reference: deepblast/alignment.py:127-137)."""
        hx, hy = self._embeddings(state.params, state.lm_params, batch)
        theta, A = self.aligner.apply(
            {"params": state.params["aligner"]}, hx, hy,
            (batch["x_len"], batch["y_len"]),
            method=NeuralAligner.potentials)
        return dp_ops.alignment_score(
            theta, A, (batch["x_len"], batch["y_len"]),
            mode=self.aligner.mode, operator=self.config.operator,
            backend=self.config.backend)
