from deepblast_jax.parallel.mesh import (  # noqa: F401
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated_sharding,
    shard_batch,
    shard_params,
)
