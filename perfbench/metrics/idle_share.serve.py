"""The device's idle share of the traced window, in percent: 1 - the union
of the intervals in which an operation ran on the device / the window's
wall time."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
