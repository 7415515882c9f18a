"""The share of the device chain's job slots that held a window: over its
batches, CHAIN_STATS' live_windows over slot_rounds (jobs x rounds run).
None where the traced run has nothing to read."""


def read(rec):
    c = rec.get("chain") or {}
    if rec["app"] != "eventalign" or not c.get("slot_rounds"):
        return None
    return c["live_windows"] / c["slot_rounds"]
