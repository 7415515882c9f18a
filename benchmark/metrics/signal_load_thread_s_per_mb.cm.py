"""call-methylation: "read_loader.load_raw" span seconds (signal reading
and decompression on the loader threads, thread-seconds) per Mb of read
bases.
None where the traced run has nothing to read."""


def read(rec):
    s = rec["scopes"].get("read_loader.load_raw")
    if rec["app"] != "call-methylation" or s is None:
        return None
    return s / (rec["bases"] / 1e6)
