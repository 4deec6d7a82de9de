"""deepblast_jax — a differentiable protein alignment framework in JAX.

A from-scratch JAX / XLA / Pallas re-design with the capabilities of
DeepBLAST (flatironinstitute/deepblast): differentiable smoothed
Needleman-Wunsch / Smith-Waterman alignment driven by protein language-model
embeddings, trained against structural alignments.
"""

__version__ = "0.1.0"
