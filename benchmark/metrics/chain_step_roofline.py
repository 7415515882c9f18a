"""chain_step's share of its roofline, in %: the least time one H100 could
take for the bytes of the chain's live windows
(``harness/roofline.chain_step_s`` of CHAIN_STATS' ``live_windows``) over
the device seconds of both chain_step kernels (prepare and consume).
None where the traced run has nothing to read."""

from harness import roofline


def read(rec):
    n = roofline.chain_counts(rec)
    if n is None:
        return None
    return roofline.share(roofline.chain_step_s(n[2]),
                          roofline.kernel_seconds(rec, "chain_step_"))
