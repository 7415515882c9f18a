"""Card-seconds a Mb: the union of the intervals of the window's kernels
(torch.profiler; copies left out: the copy engines run them beside the
kernels, and a copy from pageable memory lasts as long as the host
takes) per Mb of read bases of its passes.
None where the run recorded no kernel."""


def read(rec):
    if rec["kernel_busy_s"] <= 0:
        return None
    return rec["kernel_busy_s"] / (rec["bases"] / 1e6)
