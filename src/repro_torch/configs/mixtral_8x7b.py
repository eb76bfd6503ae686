"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab_size=32000,
    n_experts=8, n_shared_experts=0, experts_per_token=2, moe_d_ff=14336,
    window=4096, mlp_act="swiglu",
))
