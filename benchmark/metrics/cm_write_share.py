""""meth.write" scope seconds (the main thread's TSV writing) over the
traced passes' wall.
None where the traced run has nothing to read."""


def read(rec):
    if rec["app"] != "call-methylation" or "meth.write" not in rec["scopes"]:
        return None
    return rec["scopes"]["meth.write"] / rec["wall_s"]
