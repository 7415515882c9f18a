"""call-methylation: read bases of every pass of the traced window over
the window's length, on the host's clock.
None where the traced run has nothing to read."""


def read(rec):
    if rec["app"] != "call-methylation" or rec["wall_s"] <= 0:
        return None
    return rec["bases"] / rec["wall_s"]
