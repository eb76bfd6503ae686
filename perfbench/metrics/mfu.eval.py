"""Model FLOPs of the window's forwards over (window seconds x 989
TFLOP/s, the H100's dense bf16 peak), in percent."""
from perfbench.counting import PEAK_BF16_FLOPS


def read(record):
    if not record.get("forwards"):
        return None
    return 100.0 * record["model_flops"] / (record["window_s"]
                                            * PEAK_BF16_FLOPS)
