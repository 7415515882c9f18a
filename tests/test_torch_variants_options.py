"""nanopolish_tpu_torch `variants --consensus` options and `-q` on
methylated signal against the JAX package's app, on the CPU: --faster,
--effort, -x, --max-rounds and -m/-d on tests/test_torch_variants.py's
consensus_pipeline corpus, and -q cpg / -q cpg,gpc, plain and with
--consensus, on utils/synthetic.build_methylated_variants_corpus.  Each
case is held to the JAX app's VCF under the printed-output rule
(tests/printed_output.py) and shown to take effect, by an output that
moves off the default run's or by what tests/test_torch_variants._Spy
saw.  (Beside the calling options of tests/test_torch_variants.py, in a
file of their own so that the suite's workers share the time.)
"""

import io

import pytest
import torch

from nanopolish_tpu_torch.utils.synthetic import \
    build_methylated_variants_corpus
from tests.test_torch_variants import (DRAFT_LEN, N_READS, WINDOW, _Spy,
                                       _agree, _args, _rows, _spied,
                                       consensus_pipeline)  # noqa: F401

torch.set_num_threads(2)

# the polishing options' window: the planted substitution and deletion
POLISH_WINDOW = "tig1:100-200"


@pytest.fixture(scope="module")
def polishing_default(consensus_pipeline):
    """The port's ``--consensus -d 10`` VCF, and its spy."""
    return _spied(_args(consensus_pipeline, POLISH_WINDOW) + ["--consensus",
                                                             "-d", "10"])


@pytest.mark.parametrize("case", ["faster", "effort_10", "max_haplotypes_4",
                                  "max_rounds_1", "frequency_depth"])
def test_polishing_options_match_jax_app(consensus_pipeline,
                                         polishing_default, case):
    """--faster, --effort, -x, --max-rounds and -m/-d with --consensus,
    each shown to take effect: the screen's threshold and the segments it
    scored, the max-haplotypes warning, the number of rounds, the pileup's
    thresholds."""
    extra = {"faster": ["--faster"], "effort_10": ["--effort", "10"],
             "max_haplotypes_4": ["-x", "4"],
             "max_rounds_1": ["--max-rounds", "1"],
             "frequency_depth": ["-m", "0.4", "-d", "5"]}[case]
    args = _args(consensus_pipeline, POLISH_WINDOW) + ["--consensus", "-d",
                                                       "10"]
    default, dspy = polishing_default
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        spy = _Spy(mp)
        got = _agree(args + extra, f"variants --consensus {' '.join(extra)}",
                     stderr=err)
    assert dspy.thresholds == {100}
    if case in ("faster", "effort_10"):
        assert spy.thresholds == {25 if case == "faster" else 10}
        assert spy.segments < dspy.segments
    elif case == "max_haplotypes_4":
        assert "would exceed max-haplotypes" in err.getvalue()
        assert got != default
    elif case == "max_rounds_1":
        assert spy.rounds == 1 < dspy.rounds and got != default
    else:
        assert spy.pileup == [(0.4, 5)] and dspy.pileup == [(0.2, 10)]


@pytest.fixture(scope="module")
def methylated_pipeline(tmp_path_factory):
    """utils/synthetic.build_methylated_variants_corpus at the
    consensus_pipeline's size: 25 full-length reads of a 360-base truth
    whose signal is the r9.4_450bps cpg 6-mer model over the cpg
    alphabet's methylation of it; the draft carries a substitution at the
    C of a CpG site and one away from any CpG."""
    p = build_methylated_variants_corpus(
        str(tmp_path_factory.mktemp("torch_cpg")), genome_len=DRAFT_LEN,
        n_reads=N_READS)
    truth = p["truth"]
    at_cpg, away = p["edits"]
    assert truth[at_cpg:at_cpg + 2] == "CG" and "CG" not in \
        truth[away - 1:away + 2]
    return p


@pytest.mark.parametrize("types", ["cpg", "cpg,gpc"])
def test_methylation_aware_calling_matches_jax_app(methylated_pipeline,
                                                   types):
    """-q on methylated signal: every group's haplotypes are scored with
    their methylated alternatives (ScoreBatcher units of 2 or 3
    sequences, the cpg and gpc models' 15,625-kmer tables padded into one
    stack with the nucleotide model's), which moves the qualities off
    plain mode's; the JAX app prints the same VCF."""
    p = methylated_pipeline
    args = _args(p, WINDOW)
    plain, pspy = _spied(args)
    with pytest.MonkeyPatch.context() as mp:
        spy = _Spy(mp)
        got = _agree(args + ["-q", types], f"variants -q {types}")
    called = {int(r[1]) - 1 for r in _rows(got)}
    assert set(p["edits"]) <= called
    assert [r[5] for r in _rows(got)] != [r[5] for r in _rows(plain)]
    assert spy.unit_seqs == 1 + types.count(",") + 1
    assert pspy.unit_seqs == 1 and max(pspy.table_widths) == 4096
    assert 15625 in spy.table_widths


def test_methylation_aware_consensus_matches_jax_app(methylated_pipeline):
    """--consensus -q cpg: the single-base-edit screen and every later
    round go through the object path with methylated alternatives (the
    array path is never asked), and the JAX app prints the same VCF; both
    planted edits are called."""
    p = methylated_pipeline
    args = _args(p, "tig1:110-235") + ["--consensus", "-d", "10", "-q",
                                       "cpg"]
    with pytest.MonkeyPatch.context() as mp:
        spy = _Spy(mp)
        got = _agree(args, "variants --consensus -q cpg")
    assert spy.array_screens == 0 and spy.unit_seqs == 2
    assert 15625 in spy.table_widths
    assert {int(r[1]) - 1 for r in _rows(got)} >= set(p["edits"])
