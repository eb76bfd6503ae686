"""InternVL2-1B — InternViT frontend (stub) + Qwen2-0.5B-style LM backbone
[arXiv:2404.16821; hf].  The vision tower is a STUB per the assignment:
input_specs() provides precomputed patch embeddings (256 tokens/image)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, mlp_act="swiglu", qkv_bias=True,
    frontend="vision", n_prefix_tokens=256, tie_embeddings=True,
))
