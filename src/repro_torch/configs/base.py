"""Architecture configuration schema + registry (counterpart of
``repro.configs.base``, the same data).

One ``ArchConfig`` per assigned architecture (exact published numbers) plus a
``reduced()`` variant for CPU smoke tests.  The ``numerics`` fields integrate
the paper's technique: every arch carries an FPU/precision policy selected by
FPGen DSE per workload.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

ARCH_IDS = (
    "tinyllama-1.1b", "starcoder2-7b", "chatglm3-6b", "deepseek-67b",
    "deepseek-moe-16b", "mixtral-8x7b", "internvl2-1b", "zamba2-1.2b",
    "falcon-mamba-7b", "musicgen-large",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    #: leading layers whose FFN is a dense MLP of width ``d_ff`` before the
    #: MoE layers (DeepSeek's ``first_k_dense_replace``)
    n_dense_layers: int = 0
    #: the top-k routing weights renormalised to sum to 1 (else the
    #: softmax's own), then times ``routed_scaling_factor``
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    #: every (token, pick) computed whatever an expert's load: no capacity,
    #: so a token's output does not depend on the other tokens of the call
    moe_dropless: bool = False
    # --- SSM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # mamba2 head dim
    ssm_version: int = 0  # 1 = mamba1, 2 = mamba2
    #: internal selective-scan chunk (lax.scan carry points).  Chunked
    #: serving prefill is bitwise-exact only when its chunk boundaries land
    #: on multiples of this, so the engine rounds its prefill chunk to it.
    ssm_scan_chunk: int = 64
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0  # apply the shared attention block every N
    # --- attention flavor ---
    rope_style: str = "full"  # 'full' | 'half' (chatglm 2d) | 'none'
    rope_theta: float = 10000.0
    window: int = 0  # sliding-window size (mixtral); 0 = full
    mlp_act: str = "swiglu"  # 'swiglu' | 'gelu'
    qkv_bias: bool = False
    # --- multi-head latent attention (DeepSeek-V2); 0 => none ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- YaRN RoPE scaling (arXiv:2309.00071); factor 0 => none ---
    yarn_factor: float = 0.0
    yarn_original_max_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # --- modality frontend stub ---
    frontend: str = "none"  # 'none' | 'vision' | 'audio'
    n_prefix_tokens: int = 0  # precomputed patch/frame embeddings
    # --- numerics policy hooks (the paper's technique) ---
    numerics_precision: str = "sp"
    emulated_numerics: bool = False  # smoke-scale: route matmuls via fma_emu
    emulated_fmt: str = "bf16"
    # --- training ---
    dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False
    # --- serving ---
    kv_cache_dtype: str = ""  # '' = dtype; 'float8_e4m3fn' halves cache HBM

    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    def _mla_counts(self) -> Tuple[int, int, int]:
        """(one MLA block's projections, its norms (ln1, ln2, the latent's),
        one MoE layer's router) for the MLA configs."""
        d, H, r = self.d_model, self.n_heads, self.kv_lora_rank
        nope, rope, v = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                         self.v_head_dim)
        attn = d * H * (nope + rope) + d * (r + rope) \
            + r * H * (nope + v) + H * v * d
        return attn, 2 * d + r, d * self.n_experts

    def _mla_params(self, experts: int) -> int:
        """An MLA config's parameters with ``experts`` routed experts a MoE
        layer (all of them, or the top-k a token passes through): the
        embedding and an untied unembed, every block, the leading dense
        MLPs and the final norm."""
        d, L, nd = self.d_model, self.n_layers, self.n_dense_layers
        attn, norms, router = self._mla_counts()
        moe = (self.n_shared_experts + experts) * 3 * d * self.moe_d_ff \
            + router
        return 2 * self.vocab_size * d + L * (attn + norms) \
            + nd * 3 * d * self.d_ff + (L - nd) * moe + d

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks); an MLA config's
        is exact (``_mla_params``)."""
        if self.is_mla:
            return self._mla_params(self.n_experts)
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.n_heads:
            hd = self.head_dim
            per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        if self.family == "moe":
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            routed = self.n_experts * 3 * d * self.moe_d_ff
            per_layer += shared + routed + d * self.n_experts
            if self.d_ff:
                pass
        elif self.d_ff:
            mult = 3 if self.mlp_act == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        if self.ssm_version:
            d_in = self.ssm_expand * d
            per_layer_ssm = (d * 2 * d_in  # in_proj
                             + d_in * self.ssm_conv
                             + d_in * (2 * self.ssm_state + 2)
                             + d_in * d)  # out_proj
            if self.family == "hybrid":
                n_ssm = L
                per_layer = per_layer_ssm  # ssm layers
                total += n_ssm * per_layer
                # one shared attention+mlp block
                hd = self.head_dim
                total += (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                          + self.n_heads * hd * d + 3 * d * self.d_ff)
                total += 2 * L * d  # norms
                return total
            per_layer = per_layer_ssm
        total += L * per_layer + 2 * L * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed)."""
        if self.family != "moe":
            return self.param_count()
        if self.is_mla:
            return self._mla_params(self.experts_per_token)
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d * 2
        hd = self.head_dim
        per_layer = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        per_layer += (self.n_shared_experts + self.experts_per_token) \
            * 3 * d * self.moe_d_ff
        per_layer += d * self.n_experts
        total += L * per_layer + 2 * L * d
        return total

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, 4 * self.n_kv_heads // self.n_heads)
        if self.n_experts:
            kw["n_experts"] = 4
            kw["experts_per_token"] = min(self.experts_per_token, 2)
            kw["moe_d_ff"] = 32
        if self.ssm_state:
            kw["ssm_state"] = 8
            kw["ssm_head_dim"] = 16
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        if self.window:
            kw["window"] = 16
        if self.n_prefix_tokens:
            kw["n_prefix_tokens"] = 8
        kw["kv_cache_dtype"] = ""  # exact caches at smoke scale
        if self.n_experts:
            kw["capacity_factor"] = 8.0  # no token dropping at smoke scale
        return dataclasses.replace(self, name=self.name + "-smoke", **kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        try:
            importlib.import_module(f"repro_torch.configs.{mod}")
        except ImportError as e:
            raise KeyError(f"unknown arch {name!r}: {e}") from e
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    """The configs of ``ARCH_IDS`` (a config registered outside it, such
    as deepseek-v2-lite, is reached by ``get_config`` alone)."""
    return {a: get_config(a) for a in ARCH_IDS}


def cells(arch: str) -> Tuple[str, ...]:
    """The dry-run cells defined for an arch (skips documented in DESIGN.md)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return tuple(out)
