"""eventalign: "read_builder.process_chunk" scope seconds per Mb of read
bases (the ingest's device stage, issue and fetch, and the reads'
assembly).
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("read_builder.process_chunk")
    if rec["app"] != "eventalign" or s is None:
        return None
    return s / (rec["bases"] / 1e6)
