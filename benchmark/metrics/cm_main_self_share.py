""""meth.pass.self" seconds (the main thread's time in call-methylation
passes that no span inside the pass names) over the traced passes' wall.
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("meth.pass.self")
    if rec["app"] != "call-methylation" or s is None:
        return None
    return s / rec["wall_s"]
