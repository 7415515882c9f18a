""""ea.emit" scope seconds (the main thread's TSV rendering) over the
traced passes' wall.
None where the traced run has nothing to read."""


def read(rec):
    if rec["app"] != "eventalign" or "ea.emit" not in rec["scopes"]:
        return None
    return rec["scopes"]["ea.emit"] / rec["wall_s"]
