"""Synchronised wall milliseconds inside the model's fused decode per
decode step, from the benchmark's spans."""


def read(record):
    spans = [s for s in record.get("spans", ()) if s[0] == "decode_scan"]
    steps = sum(s[3]["steps"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / steps
