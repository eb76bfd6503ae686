"""DeepSeek-67B — llama-arch, deep (95L) [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, mlp_act="swiglu",
    # 95-layer x 32k x batch-128 cache = 816 GB in bf16; fp8 KV storage is
    # the standard production trade for long-context GQA serving
    kv_cache_dtype="float8_e4m3fn",
))
