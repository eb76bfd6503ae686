"""The median time to first token, over the requests whose first token
came in the window."""
import statistics


def read(record):
    ttft = record.get("ttft_s")
    return statistics.median(ttft) if ttft else None
