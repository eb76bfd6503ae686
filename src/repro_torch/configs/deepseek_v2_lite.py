"""DeepSeek-V2-Lite — multi-head latent attention (a 512-wide latent and a
64-dim shared rope key, no query low-rank), YaRN RoPE, one dense layer and
26 MoE layers of 2 shared + 64 routed experts, top-6, dropless
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite config.json].

Registered outside ``ARCH_IDS``: the JAX package has no MLA, so the
registry-wide parity tests have nothing to hold it to.  The port ties the
unembed to the embedding table, as for every config (the published model
has a separate head)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    n_dense_layers=1, norm_topk_prob=False, routed_scaling_factor=1.0,
    moe_dropless=True,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0, yarn_factor=40.0, yarn_original_max_len=4096,
    yarn_beta_fast=32.0, yarn_beta_slow=1.0, yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    mlp_act="swiglu",
))
