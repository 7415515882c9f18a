"""The share of eventalign jobs the device chain declined or gave back to
the host wavefront (CHAIN_STATS: ineligible + aborted over all).
None where the traced run has nothing to read."""


def read(rec):
    c = rec["chain"]
    n = c["chained"] + c["ineligible"] + c["aborted"]
    if rec["app"] != "eventalign" or n == 0:
        return None
    return (c["ineligible"] + c["aborted"]) / n
