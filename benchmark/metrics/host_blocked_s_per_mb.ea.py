"""eventalign: seconds the host blocked in device fetches
(SYNC_STATS blocked_s) per Mb of read bases.
None where the traced run has nothing to read."""


def read(rec):
    if rec["app"] != "eventalign":
        return None
    return rec["blocked_s"] / (rec["bases"] / 1e6)
