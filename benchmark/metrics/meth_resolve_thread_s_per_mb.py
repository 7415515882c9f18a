""""meth.resolve" span seconds (call-methylation's score fetch and site
columns on the fetch threads, thread-seconds) per Mb of read bases.
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("meth.resolve")
    if rec["app"] != "call-methylation" or s is None:
        return None
    return s / (rec["bases"] / 1e6)
