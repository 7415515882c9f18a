"""eventalign: 1 - (the union of the device's kernel and copy intervals)
over the traced window.
None where the traced run has nothing to read."""


def read(rec):
    if rec["app"] != "eventalign" or rec["busy_s"] <= 0:
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]
