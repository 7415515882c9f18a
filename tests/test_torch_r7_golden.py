"""The reference's golden R7 HMM test through nanopolish_tpu_torch.

The port's counterpart of tests/test_r7_golden.py: the same reference
fast5, inputs and recorded values (imported from that module), read with
the port's legacy 2D loader and scored with its R7 profile HMM.  Like
that test it skips when the reference test data is not present; the
file is not part of this repository.
"""

import os

import numpy as np
import pytest

from nanopolish_tpu_torch.io.fast5_legacy import load_legacy_2d
from nanopolish_tpu_torch.models.hmm_input import HMMInputSequence
from nanopolish_tpu_torch.models.transition_parameters import \
    TransitionParameters
from nanopolish_tpu_torch.ops.profile_hmm_r7 import R7Scorer
from tests.test_r7_golden import (EXPECTED_ALIGNMENT, EXPECTED_FORWARD,
                                  EXPECTED_VITERBI_LAST_STATE, F5, INPUTS,
                                  REF_SUBSEQ)

needs_file = pytest.mark.skipif(not os.path.exists(F5),
                                reason="reference test data not present")


@needs_file
def test_legacy_2d_ingest():
    read = load_legacy_2d(F5)
    assert set(read.strands) == {0, 1}
    t = read.strands[0]
    assert len(t.mean) == 5346
    assert len(read.strands[1].mean) == 6838
    assert t.k == 5 and len(t.level_mean) == 4 ** 5
    assert t.shift == pytest.approx(2.0752194, abs=1e-5)
    assert t.scale == pytest.approx(0.9667562, abs=1e-5)
    assert read.twod_sequence and set(read.twod_sequence) <= set("ACGT")
    assert 20 < np.median(t.mean) < 120


@needs_file
@pytest.mark.parametrize("si", [0, 1])
def test_golden_hmm_values(si):
    read = load_legacy_2d(F5)
    inp = INPUTS[si]
    sd = read.strands[inp["strand"]]
    params = TransitionParameters.for_kit("sqkmap005", inp["strand"])
    sc = R7Scorer(sd, params, HMMInputSequence(REF_SUBSEQ), inp["rc"],
                  inp["e_start"], inp["e_stop"])
    states, kis, eis, fms = sc.align()
    assert states == EXPECTED_ALIGNMENT[si]
    assert fms[-1] == pytest.approx(EXPECTED_VITERBI_LAST_STATE[si],
                                    rel=1.2e-5)
    assert sc.score() == pytest.approx(EXPECTED_FORWARD[si], rel=1.2e-5)
