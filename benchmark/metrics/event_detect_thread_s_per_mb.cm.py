"""call-methylation: "read_builder.detect" span seconds (host event
detection on the loader threads, thread-seconds) per Mb of read bases.
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("read_builder.detect")
    if rec["app"] != "call-methylation" or s is None:
        return None
    return s / (rec["bases"] / 1e6)
