"""Synchronised wall milliseconds inside the model's batched prefill per
1000 real (unpadded) prompt tokens, from the benchmark's spans."""


def read(record):
    spans = [s for s in record.get("spans", ()) if s[0] == "prefill_batched"]
    tokens = sum(s[3]["real_tokens"] for s in spans)
    if not tokens:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / (tokens / 1e3)
