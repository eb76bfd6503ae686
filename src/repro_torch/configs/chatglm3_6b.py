"""ChatGLM3-6B — 2d (half-dim) RoPE, GQA [arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, rope_style="half", mlp_act="swiglu",
    qkv_bias=True,
))
