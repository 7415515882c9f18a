""""ea.chain_check" span seconds (the main thread's blocking reads of the
device chain's active count, which wait for the rounds issued) over the
traced passes' wall.
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("ea.chain_check")
    if rec["app"] != "eventalign" or s is None:
        return None
    return s / rec["wall_s"]
