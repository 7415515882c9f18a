"""Device milliseconds of every viterbi_fill kernel (torch.profiler) per
Mb of read bases.
None where the traced run has nothing to read."""


def read(rec):
    s = sum(v for k, v in rec["kernel_s"].items() if "viterbi_fill" in k)
    if s <= 0:
        return None
    return s * 1e3 / (rec["bases"] / 1e6)
