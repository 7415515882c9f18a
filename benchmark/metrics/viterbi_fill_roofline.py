"""viterbi_fill's share of its roofline, in %: the least time one H100
could take for the chain's DP cells and their bytes
(``harness/roofline.viterbi_fill_s`` of CHAIN_STATS' counts) over the
device seconds of every viterbi_fill kernel.  Those seconds include any
host-wavefront round's fill, which the counts leave out.
None where the traced run has nothing to read."""

from harness import roofline


def read(rec):
    n = roofline.chain_counts(rec)
    if n is None:
        return None
    cells, steps, windows = n
    return roofline.share(roofline.viterbi_fill_s(cells, steps, windows),
                          roofline.kernel_seconds(rec, "viterbi_fill"))
