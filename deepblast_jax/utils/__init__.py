from deepblast_jax.utils.logging import MetricsLogger, tensorboard_to_csv  # noqa: F401
