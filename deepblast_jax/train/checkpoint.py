"""Checkpoints as ``.npz`` files of the flattened train state (reference
checkpoint policy: scripts/deepblast-train:57-63 ModelCheckpoint on
validation_loss, plus the final state-dict dump at
scripts/deepblast-train:92-94; user-facing reconstruction mirrors
deepblast/utils.py:12-65).

Each checkpoint is ``step_<n>.npz``, one array per leaf of the
:class:`~deepblast_jax.train.trainer.TrainState`, keyed by the leaf's tree
path (``jax.tree_util.keystr``).  ``index.json`` lists the kept steps with
their metrics.  Restoring needs a template of the same structure, which
``jax.eval_shape(model.init)`` gives without computing anything.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import jax
import numpy as np

__all__ = ["Checkpointer", "load_model", "save_config"]


def _flatten(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in leaves}


class Checkpointer:
    """Monitored checkpoint writer keeping the best-k states."""

    def __init__(self, directory, keep=3, monitor="validation_loss"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.monitor = monitor

    # -- index ---------------------------------------------------------------

    def _index_path(self):
        return os.path.join(self.directory, "index.json")

    def _index(self):
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return []

    def _file(self, step):
        return os.path.join(self.directory, f"step_{step}.npz")

    def _score(self, entry):
        m = entry["metrics"]
        return m.get(self.monitor, m.get("train_loss", 0.0))

    # -- save / restore --------------------------------------------------------

    def save(self, state, metrics=None):
        step = int(state.step)
        arrays = {k: np.asarray(v) for k, v in _flatten(state).items()}
        tmp = self._file(step) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._file(step))
        entry = {"step": step,
                 "metrics": {k: float(v) for k, v in (metrics or {}).items()
                             if isinstance(v, (int, float))}}
        index = [e for e in self._index() if e["step"] != step] + [entry]
        index.sort(key=self._score)
        for old in index[self.keep:]:
            if os.path.exists(self._file(old["step"])):
                os.remove(self._file(old["step"]))
        index = sorted(index[:self.keep], key=lambda e: e["step"])
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, self._index_path())

    def best_step(self):
        index = self._index()
        return min(index, key=self._score)["step"] if index else None

    def latest_step(self):
        index = self._index()
        return max(e["step"] for e in index) if index else None

    def restore(self, state, step: Optional[int] = None):
        """Restore into the structure of ``state`` (a TrainState of arrays
        or of ``jax.ShapeDtypeStruct``); the default step is the best
        monitored one.  Returns device arrays."""
        step = step if step is not None else self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        paths, treedef = jax.tree_util.tree_flatten_with_path(state)
        with np.load(self._file(step)) as data:
            leaves = []
            for path, like in paths:
                key = jax.tree_util.keystr(path)
                arr = data[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(
                        f"checkpoint leaf {key} has shape {arr.shape}, the "
                        f"model expects {tuple(like.shape)}")
                leaves.append(jax.device_put(arr.astype(like.dtype)))
        return jax.tree_util.tree_unflatten(treedef, leaves)


def save_config(config, directory):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(config.to_json())


def load_model(directory, step=None, tokenizer=None, lm_params=None):
    """Rebuild a DeepBLAST model + state from an output directory
    (reference: deepblast/utils.py:12-65)."""
    from deepblast_jax.train.trainer import DeepBLAST, DeepBLASTConfig
    with open(os.path.join(directory, "config.json")) as f:
        config = DeepBLASTConfig.from_json(f.read())
    model = DeepBLAST(config, tokenizer=tokenizer, lm_params=lm_params)
    template = jax.eval_shape(model.init)
    ckpt = Checkpointer(os.path.join(directory, "checkpoints"))
    model.state = ckpt.restore(template, step)
    return model
