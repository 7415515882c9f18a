"""viterbi_backtrack_kernel's share of its roofline, in %: the least time
one H100 could take for the chain's path steps and windows
(``harness/roofline.viterbi_backtrack_s`` of CHAIN_STATS' counts) over the
kernel's device seconds.
None where the traced run has nothing to read."""

from harness import roofline


def read(rec):
    n = roofline.chain_counts(rec)
    if n is None:
        return None
    _, steps, windows = n
    return roofline.share(roofline.viterbi_backtrack_s(steps, windows),
                          roofline.kernel_seconds(rec, "viterbi_backtrack"))
