""""meth.wait_chunk" span seconds (call-methylation's main thread waiting
on the loader threads' next chunk) over the traced passes' wall.
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("meth.wait_chunk")
    if rec["app"] != "call-methylation" or s is None:
        return None
    return s / rec["wall_s"]
