from deepblast_jax.models.aligner import NeuralAligner  # noqa: F401
from deepblast_jax.models.heads import (  # noqa: F401
    LinearHead,
    StackedCNN,
    StackedRNN,
)
from deepblast_jax.models.lm import (  # noqa: F401
    BiLM,
    T5Config,
    T5Encoder,
    convert_hf_t5_encoder,
    load_prot_t5,
    pretrained_language_models,
)
