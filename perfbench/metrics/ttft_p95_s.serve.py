"""The 95th percentile of time to first token, over the requests whose
first token came in the window."""
import numpy as np


def read(record):
    ttft = record.get("ttft_s")
    return float(np.percentile(ttft, 95)) if ttft else None
