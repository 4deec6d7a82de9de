"""Device mesh and sharding utilities.

The reference's only parallelism is Lightning DDP over NCCL
(reference: scripts/deepblast-train:66-84, deepblast/trainer.py:245-246).
The equivalent here is a 2-D ``(data, model)`` mesh over ``jax.devices()``:

* ``data``  — pure data parallelism: the batch is sharded, parameters are
  replicated, and XLA inserts the ``psum`` gradient all-reduce (NCCL
  between GPUs) when the jitted train step runs under the mesh.
* ``model`` — optional tensor parallelism for the heads and the (frozen)
  protein LM: weight matrices are sharded along their output/input features
  following :func:`param_partition_spec`, which is only worth it when
  finetuning ProtT5-scale encoders.

Multi-host: call :func:`initialize_distributed` once per process before
building the mesh; ``jax.devices()`` then spans all hosts.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "mesh_context",
    "batch_sharding",
    "replicated_sharding",
    "param_partition_spec",
    "shard_params",
    "shard_batch",
]


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None):
    """Multi-host bring-up (reference DDP's init,
    scripts/deepblast-train:78, replaced by jax.distributed)."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices=None) -> Mesh:
    """Build a ``(data, model)`` mesh over all available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, ("data", "model"))


def mesh_context(mesh: Optional[Mesh]):
    """``jax.set_mesh(mesh)``, or no context when ``mesh`` is None.  The DP
    (``ops/dp.py``) runs each device's share of the batch on that device
    when the context mesh has a ``data`` axis."""
    return jax.set_mesh(mesh) if mesh is not None \
        else contextlib.nullcontext()


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_partition_spec(path, leaf) -> P:
    """Tensor-parallel partition rules for model parameters.

    Defaults to replication; large projection matrices shard their feature
    dimension over ``model``.  Keys are param path tuples.
    """
    names = [str(k.key) if hasattr(k, "key") else str(k) for k in path]
    joined = "/".join(names)
    if leaf.ndim == 0:
        return P()
    # T5 / Dense kernels: (in, out)
    if names[-1] == "kernel" and leaf.ndim == 2:
        if any(s in joined for s in ("attn/o", "ff/wo")):
            return P("model", None)
        return P(None, "model")
    # Conv kernels: (k, in, out)
    if names[-1] == "kernel" and leaf.ndim == 3:
        return P(None, None, "model")
    return P()


def shard_params(params, mesh: Mesh, use_tp=False):
    """Place a parameter pytree on the mesh (replicated, or TP-sharded
    when ``use_tp``)."""
    if not use_tp:
        sh = replicated_sharding(mesh)
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sh), params)

    def place(path, leaf):
        spec = param_partition_spec(path, leaf)
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, params)


def shard_batch(batch, mesh: Mesh, stacked: bool = False):
    """Place every array of a batch dict on the data axis.  With
    ``stacked``, arrays carry a leading steps axis (K, B, ...) and the
    *second* axis is the sharded batch."""
    sh = NamedSharding(mesh, P(None, "data")) if stacked \
        else batch_sharding(mesh)

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= (2 if stacked else 1):
            return jax.device_put(x, sh)
        return x

    return {k: place(v) if not isinstance(v, list) else v
            for k, v in batch.items()}
