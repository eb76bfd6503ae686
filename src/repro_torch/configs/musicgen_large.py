"""MusicGen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf].  The EnCodec frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, mlp_act="gelu",
    frontend="audio", n_prefix_tokens=0,
    # full MHA (32 KV heads) at batch 128 x 32k context: 824 GB of cache in
    # bf16 — fp8 KV storage keeps the decode cell on-chip (production trick)
    kv_cache_dtype="float8_e4m3fn",
))
