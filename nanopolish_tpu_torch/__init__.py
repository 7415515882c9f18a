"""nanopolish_tpu_torch — the PyTorch/CUDA port of nanopolish_tpu.

Signal-level nanopore analysis on an NVIDIA H100: host-side IO and event
detection in NumPy/C++, the batched numerical core in PyTorch, and the
dynamic programs of the hot path (adaptive banded event alignment and the
profile-HMM Viterbi) as hand-written CUDA kernels under ``csrc/``.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, CLI ``--device cpu``), where every kernel is replaced
by its plain PyTorch version.

Every subcommand of the JAX package runs here, training included.
"""

__version__ = "0.1.0"

from .utils.alphabet import (  # noqa: F401
    ALPHABETS,
    DNA_ALPHABET,
    METHYL_CPG_ALPHABET,
    METHYL_DAM_ALPHABET,
    METHYL_DCM_ALPHABET,
    METHYL_GPC_ALPHABET,
    U_TO_T_RNA_ALPHABET,
    Alphabet,
    get_alphabet_by_name,
)
from .models.pore_model import PoreModel, PoreModelSet, get_model  # noqa: F401
