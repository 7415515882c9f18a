"""call-methylation: "read_builder.process_chunk" scope seconds per Mb of
read bases, summed over the loader threads (thread-seconds).
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("read_builder.process_chunk")
    if rec["app"] != "call-methylation" or s is None:
        return None
    return s / (rec["bases"] / 1e6)
