"""Model files for the ``--models-fofn`` tests.

``shifted_models_fofn`` writes built-in models with every level mean
shifted by a fixed amount, up for even kmer ranks and down for odd ones
(a shift of them all alike is absorbed by the reads' shift scaling and
changes no call), and lists them in a file of filenames, so an app that
reads the fofn prints something other than its default run (nothing is
downloaded).  ``fresh_model_sets`` gives both packages'
``PoreModelSet`` a fresh singleton for the block and puts the old one
back after it: ``initialize`` replaces built-in models in place, and
the suite runs each file in one worker (``--dist loadfile``), so a replaced
model would otherwise reach the file's later tests.
"""

from __future__ import annotations

import contextlib

import numpy as np

from nanopolish_tpu.models.pore_model import PoreModelSet as JaxModels
from nanopolish_tpu_torch.models.pore_model import PoreModelSet

NUC = ("r9.4_450bps", "nucleotide", "template", 6)
CPG = ("r9.4_450bps", "cpg", "template", 6)


def shifted_models_fofn(d, keys, shift: float) -> str:
    """models.fofn in directory ``d`` naming one file per model key, each
    the built-in model with every level mean moved by ``shift`` pA, up
    for even kmer ranks and down for odd ones."""
    paths = []
    for kit, alphabet, strand, k in keys:
        m = PoreModelSet.instance().get_model(kit, alphabet, strand, k)
        name = f"{kit}.{alphabet}.{k}mer.{strand}.shifted.model"
        path = d / name
        sign = 1.0 - 2.0 * (np.arange(m.num_states) % 2)
        m.with_states(m.level_mean + shift * sign,
                      m.level_stdv).write(str(path), name)
        paths.append(str(path))
    fofn = d / "models.fofn"
    fofn.write_text("\n".join(paths) + "\n")
    return str(fofn)


@contextlib.contextmanager
def fresh_model_sets():
    """Both packages' model registries start empty (built-ins load on first
    use) inside the block and are the caller's again after it."""
    saved = PoreModelSet._instance, JaxModels._instance
    PoreModelSet.reset()
    JaxModels.reset()
    try:
        yield
    finally:
        PoreModelSet._instance, JaxModels._instance = saved
