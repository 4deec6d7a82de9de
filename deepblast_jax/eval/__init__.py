from deepblast_jax.eval import score  # noqa: F401
