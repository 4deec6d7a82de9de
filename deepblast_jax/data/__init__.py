from deepblast_jax.data.alphabet import (  # noqa: F401
    Alphabet,
    ProtT5Tokenizer,
    Uniprot21,
    UniprotTokenizer,
    UniprotPairTokenizer,
)
from deepblast_jax.data.dataset import (  # noqa: F401
    FastaDataset,
    MaliAlignmentDataset,
    TMAlignDataset,
    collate,
    make_batches,
    read_fasta,
)
from deepblast_jax.data import state_utils  # noqa: F401
