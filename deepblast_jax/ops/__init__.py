from deepblast_jax.ops.dp import (  # noqa: F401
    AlignmentDecoder,
    NeedlemanWunschDecoder,
    SmithWatermanDecoder,
    alignment_score,
    expected_alignment,
    traceback,
)
from deepblast_jax.ops.smooth import OPERATORS  # noqa: F401
