#!/usr/bin/env python3
"""One Chrome trace of a run's spans and its device work, for Perfetto.

    python3 tools/merge_traces.py spans.json device.json merged.json

``spans.json`` is the port's span export (NPT_PROFILE=1
NPT_PROFILE_TRACE=spans.json; ts in us on the Unix epoch);
``device.json`` a torch.profiler ``export_chrome_trace`` of the same run,
whose ts count from its ``baseTimeNanoseconds``.  The merged file puts
both on the Unix epoch, so the spans sit on the same thread rows as the
host's torch operations and above the card's kernels and copies.
"""

from __future__ import annotations

import json
import sys


def merge(spans_path: str, device_path: str, out_path: str) -> int:
    """Write the merged trace; returns its number of events."""
    with open(spans_path) as fh:
        spans = json.load(fh)["traceEvents"]
    with open(device_path) as fh:
        device = json.load(fh)
    base_us = device.get("baseTimeNanoseconds", 0) / 1e3
    events = device["traceEvents"]
    for e in events:
        if "ts" in e:
            e["ts"] = float(e["ts"]) + base_us
    events += spans
    with open(out_path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)


if __name__ == "__main__":
    if len(sys.argv) != 4:
        sys.exit(__doc__.split("\n\n")[1])
    print(merge(*sys.argv[1:]), "events")
