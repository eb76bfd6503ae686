"""DeepSeekMoE-16B — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=102400,
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    mlp_act="swiglu", kv_cache_dtype="float8_e4m3fn",
))
