"""call-methylation: seconds blocked in device fetches (SYNC_STATS
blocked_s, summed over the fetching threads) per Mb of read bases.
None where the traced run has nothing to read."""


def read(rec):
    if rec["app"] != "call-methylation":
        return None
    return rec["blocked_s"] / (rec["bases"] / 1e6)
