from deepblast_jax.train.losses import (  # noqa: F401
    get_loss,
    matrix_cross_entropy,
    soft_alignment_loss,
    soft_path_loss,
)
from deepblast_jax.train.trainer import (  # noqa: F401
    DeepBLAST,
    DeepBLASTConfig,
    TrainState,
)
from deepblast_jax.train.checkpoint import Checkpointer, load_model  # noqa: F401
