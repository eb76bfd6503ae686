"""Model assembly: the decoder LM (counterpart of ``repro.models.model``).

Families:
  dense  : L x [GQA attention + MLP]
  vlm    : dense, with precomputed patch embeddings (``prefix_embeds``)
           in front of the tokens (internvl2; the vision tower is a stub)
  audio  : dense over precomputed frame embeddings (``frame_embeds``) in
           place of the token embedding (musicgen; the codec is a stub)
  moe    : L x [GQA attention + MoE]   (deepseek-moe, mixtral)
  ssm    : L x [Mamba-1]               (attention-free; falcon-mamba)
  hybrid : L x [Mamba-2] + one *shared* attention+MLP block applied after
           every ``shared_attn_every`` layers (zamba2)

The JAX package stacks each layer's parameters along a leading axis and
runs the stack with ``lax.scan``; the port keeps the same parameter tree
(so ``models.convert.params_from_jax`` is a plain copy) and loops over the
layers.  Decode is a single-token step against a cache (KV for the
attention families, a ring of ``window`` slots with sliding-window
attention; conv + state carries for ssm; both for hybrid, whose shared
block keeps one KV cache per application) that the port updates in place
(the JAX function returns a new one); the returned ``DecodeCache`` shares
the caller's storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import chunk_attention, decode_attention
from repro_torch.models.flash_vjp import flash_attention_trainable
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_rope, dense_init, embed_apply,
                                       embed_init, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, unembed_apply)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.numerics import matmul

_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the KV cache's ``dtype``.  Into ``float8_e4m3fn``,
    |x| > 464 and +-inf become NaN, as the JAX package's ``astype`` gives
    them, where torch's cast saturates to +-448 (464 is the tie between
    448 and the next step, which rounds to 448)."""
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > 464, x.new_tensor(float("nan")), x)
    return x.to(dtype)


def _pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _layer(tree: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _emulates(policy) -> bool:
    return policy is not None and getattr(policy, "emulate", False)


# ---------------------------------------------------------------------------
# Attention transformer block (dense / moe; the hybrid's shared block)
# ---------------------------------------------------------------------------
def attn_block_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                    n: Optional[int]):
    """``n`` stacked blocks' parameters (leading axis = layer), or one
    block's with ``n=None``."""
    d, hd, dev = cfg.d_model, cfg.head_dim, gen.device
    lead = () if n is None else (n,)
    p = {
        "ln1": rmsnorm_init(d, dtype, dev, lead=lead),
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, lead=lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, lead=lead),
        "ln2": rmsnorm_init(d, dtype, dev, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads * hd),
                            ("bk", cfg.n_kv_heads * hd),
                            ("bv", cfg.n_kv_heads * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=dev)
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, d, n_experts=cfg.n_experts,
                            moe_d_ff=cfg.moe_d_ff,
                            n_shared=cfg.n_shared_experts, dtype=dtype,
                            lead=lead)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype, lead=lead)
    return p


def _qkv(p, h, cfg: ArchConfig, positions, policy):
    B, S, _ = h.shape
    q = matmul(h, p["wq"], policy)
    k = matmul(h, p["wk"], policy)
    v = matmul(h, p["wv"], policy)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    return q, k, v


def _ffn(p, h2, cfg: ArchConfig, policy):
    """The MLP, or for the moe family the MoE (which no policy reaches:
    the JAX ``_ffn`` passes none to ``moe_apply``).  Returns (out, aux)."""
    if cfg.family == "moe":
        return moe_apply(p["moe"], h2, top_k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
    return mlp_apply(p["mlp"], h2, cfg.mlp_act, policy), {"aux_loss": 0.0}


def _residual_ffn(p, x, attn, cfg: ArchConfig, policy):
    """x + wo(attn), then + ffn(norm): the block's second half.  Returns
    (out, aux)."""
    B, S = attn.shape[:2]
    x = x + matmul(attn.reshape(B, S, -1), p["wo"], policy)
    h2 = rmsnorm(p["ln2"], x)
    ff, aux = _ffn(p, h2, cfg, policy)
    return x + ff, aux


def attn_block_apply(p, x, positions, cfg: ArchConfig, *, policy=None):
    """Full-sequence block.  Returns (out, aux, (k, v))."""
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, positions, policy)
    attn = flash_attention_trainable(q, k, v, causal=True, window=cfg.window)
    out, aux = _residual_ffn(p, x, attn, cfg, policy)
    return out, aux, (k, v)


def attn_block_decode(p, x, k_cache, v_cache, cache_len, cfg: ArchConfig, *,
                      ring: bool = False, policy=None, write_mask=None):
    """x: (B,1,d); caches (B,Smax,Hkv,D), written in place at each lane's
    ``cache_len`` (B,), or on a ring (sliding window) at ``cache_len %
    Smax`` — except lanes where ``write_mask`` is False or (not a ring) the
    position lies beyond the cache, whose cache bits stay as they were.  A
    ring holds exactly the window, so it needs no window mask."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, cache_len[:, None], policy)
    lanes = torch.arange(B, device=x.device)
    if ring:
        idx = cache_len % Smax
        keep = torch.ones_like(cache_len, dtype=torch.bool)
    else:
        idx = cache_len.clamp(max=Smax - 1)
        keep = cache_len < Smax
    if write_mask is not None:
        keep = keep & write_mask
    keep = keep[:, None, None]
    k_cache[lanes, idx] = torch.where(keep, to_cache(k[:, 0], k_cache.dtype),
                                      k_cache[lanes, idx])
    v_cache[lanes, idx] = torch.where(keep, to_cache(v[:, 0], v_cache.dtype),
                                      v_cache[lanes, idx])
    valid = torch.clamp(cache_len + 1, max=Smax)
    attn = decode_attention(q, k_cache, v_cache, valid,
                            window=0 if ring else cfg.window)
    return _residual_ffn(p, x, attn, cfg, policy)[0]


def _chunk_attn_block(p, x, k_cache, v_cache, offsets, chunk_lens, positions,
                      cfg: ArchConfig, *, ring: bool, policy=None):
    """Chunk-resumable attention block over gathered per-lane cache lanes.

    x: (M,Cb,d); k_cache/v_cache: (M,smax,Hkv,D); offsets/chunk_lens: (M,)
    tokens already prefilled / valid tokens in this chunk; positions:
    (M,Cb).  Attends against the history (on a ring: the last ``smax``
    positions, gathered in position order) + the fresh chunk, and returns
    (out, new_k, new_v) with only the valid chunk K/V written.  On a ring a
    chunk longer than ``smax`` writes only its last ``smax`` columns, the
    positions the ring keeps."""
    M, Cb, _ = x.shape
    smax = k_cache.shape[1]
    dev = x.device
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, positions, policy)
    col = torch.arange(Cb, device=dev)[None, :]
    valid_new = col < chunk_lens[:, None]
    i = torch.arange(smax, device=dev)[None, :]
    if ring:
        hist_pos = offsets[:, None] - smax + i
        slot = (hist_pos % smax)[..., None, None]
        k_hist = torch.take_along_dim(k_cache, slot, dim=1)
        v_hist = torch.take_along_dim(v_cache, slot, dim=1)
        hist_valid = hist_pos >= 0
        write_pos = positions % smax
        written = valid_new & (col >= chunk_lens[:, None] - smax)
    else:
        hist_pos = i.expand(M, smax)
        k_hist, v_hist = k_cache, v_cache
        hist_valid = hist_pos < offsets[:, None]
        write_pos, written = positions, valid_new
    k_all = torch.cat([k_hist.to(k.dtype), k], dim=1)
    v_all = torch.cat([v_hist.to(v.dtype), v], dim=1)
    k_pos = torch.cat([hist_pos, positions], dim=1)
    k_valid = torch.cat([hist_valid, valid_new], dim=1)
    attn = chunk_attention(q, k_all, v_all, positions, k_pos, k_valid,
                           window=cfg.window)
    # columns not written go to a scratch slot past the cache and are dropped
    write_idx = torch.where(written, write_pos, smax).clamp(max=smax)
    lanes = torch.arange(M, device=dev)[:, None]
    new_k, new_v = [], []
    for cache, fresh, out in ((k_cache, k, new_k), (v_cache, v, new_v)):
        ext = torch.cat([cache, cache[:, :1]], dim=1)
        ext[lanes, write_idx] = to_cache(fresh, cache.dtype)
        out.append(ext[:, :smax])
    return (_residual_ffn(p, x, attn, cfg, policy)[0], new_k[0], new_v[0])


# ---------------------------------------------------------------------------
# SSM block (norm + mamba)
# ---------------------------------------------------------------------------
def ssm_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, n: int):
    """``n`` stacked blocks' parameters (leading axis = layer)."""
    d, lead = cfg.d_model, (n,)
    p = {"ln": rmsnorm_init(d, dtype, gen.device, lead=lead)}
    if cfg.ssm_version == 1:
        p["mamba"] = ssm.mamba1_init(gen, d, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand, conv=cfg.ssm_conv,
                                     dtype=dtype, lead=lead)
    else:
        p["mamba"] = ssm.mamba2_init(gen, d, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand, conv=cfg.ssm_conv,
                                     head_dim=cfg.ssm_head_dim, dtype=dtype,
                                     lead=lead)
    return p


def ssm_block_apply(p, x, cfg: ArchConfig, state=None,
                    return_state: bool = False):
    """x + mamba(norm(x)); with ``return_state`` also the block's
    (conv carry, h) after the sequence."""
    h = rmsnorm(p["ln"], x)
    kw = dict(state=state, return_state=return_state,
              chunk=cfg.ssm_scan_chunk)
    if cfg.ssm_version == 1:
        out = ssm.mamba1_apply(p["mamba"], h, d_state=cfg.ssm_state, **kw)
    else:
        out = ssm.mamba2_apply(p["mamba"], h, d_state=cfg.ssm_state,
                               head_dim=cfg.ssm_head_dim, **kw)
    if return_state:
        y, new_state = out
        return x + y, new_state
    return x + out


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeCache:
    """Decode state: ``data`` {"k", "v"} of shape (L, B, Smax, Hkv, D)
    (dense, moe; Smax = min(max_len, window) with a window), {"conv" (L, B,
    K-1, C), "h" (L, B, ...)} (ssm), or both (hybrid, with k/v of shape
    (n_shared_applications, B, max_len, Hkv, D)), and ``length``, a 0-d
    (single sequence) or (B,) per-slot int64 tensor."""

    data: Dict
    length: torch.Tensor


class LM:
    """Decoder LM for one ArchConfig, on ``device`` (default CUDA)."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family not in _ATTN_FAMILIES + ("ssm", "hybrid"):
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab_padded = _pad_vocab(cfg.vocab_size)
        self.dtype = _DTYPES[cfg.dtype]

    @property
    def ring(self) -> bool:
        """The KV cache is a ring of ``window`` slots (sliding-window
        attention); the hybrid's shared-block caches never are."""
        return bool(self.cfg.window) and self.cfg.family != "hybrid"

    # ------------------------------------------------------------- init ----
    def init(self, seed: int) -> Dict:
        """Random parameters drawn on the model's device from a
        ``torch.Generator`` seeded with ``seed``."""
        cfg, dtype = self.cfg, self.dtype
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        block_init = attn_block_init if cfg.family in _ATTN_FAMILIES \
            else ssm_block_init
        params = {
            "embed": embed_init(gen, self.vocab_padded, cfg.d_model, dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, self.device),
            "layers": block_init(gen, cfg, dtype, cfg.n_layers),
        }
        if cfg.family == "hybrid":
            params["shared_attn"] = attn_block_init(gen, cfg, dtype, None)
        return params

    # ------------------------------------------------------- segments ------
    def _segments(self):
        """[(start, end, apply_shared_after), ...]: the hybrid's Mamba-2
        runs of ``shared_attn_every`` layers, each followed by the shared
        block, and a shorter trailing run without it; one run otherwise."""
        cfg = self.cfg
        if cfg.family != "hybrid":
            return [(0, cfg.n_layers, False)]
        every = cfg.shared_attn_every
        segs, start = [], 0
        while start < cfg.n_layers:
            end = min(start + every, cfg.n_layers)
            segs.append((start, end, end - start == every))
            start = end
        return segs

    @property
    def n_shared_applications(self) -> int:
        return sum(1 for _, _, s in self._segments() if s)

    # ------------------------------------------------------- forward -------
    def _embed_inputs(self, params, tokens, prefix_embeds, frame_embeds):
        """The stack's input: ``frame_embeds`` (B, S, d) in place of the
        token embedding, cast to the model dtype, and ``prefix_embeds``
        (B, P, d), cast likewise, concatenated in front."""
        if frame_embeds is not None:
            x = frame_embeds.to(self.dtype)
        else:
            x = embed_apply(params["embed"], tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(self.dtype), x], dim=1)
        return x

    def apply(self, params, tokens=None, *, prefix_embeds=None,
              frame_embeds=None, policy=None, collect_kv: bool = False,
              collect_states: bool = False, logits_last_only: bool = False,
              last_index=None, moe_stats: bool = False):
        """Full-sequence forward over ``tokens`` (B, S), or over
        ``frame_embeds`` (B, S, d) (audio), with ``prefix_embeds`` (B, P, d)
        in front (vlm; their positions come first and are unembedded too).
        Returns (logits, aux), with
        ``collect_kv`` (attention families, hybrid) then (k, v) of shape
        (L or n_shared_applications, B, S, Hkv, D) in the cache dtype (None
        for a hybrid without a shared application), and with
        ``collect_states`` (ssm, hybrid) then (conv, h): each layer's
        decode state after the sequence, stacked.  ``aux`` is the MoE
        load-balance loss summed over the layers (0.0 without experts);
        with ``moe_stats`` (moe family) it is instead a dict of that sum
        (``aux_loss``) and each layer's dropped share (``dropped_frac``,
        (L,) float32).

        logits_last_only: unembed only the final position; last_index: (B,)
        per-sample position to unembed instead (bucket-padded prefill).
        Under a policy, only the attention projections, the dense MLPs and
        the unembed are emulated: the ssm family's only policy-routed
        matmul is the unembed, the moe family's experts and router take
        none, nor do the hybrid's Mamba-2 blocks."""
        x = self._embed_inputs(params, tokens, prefix_embeds, frame_embeds)
        B = x.shape[0]
        x, aux, kv, states = self._stack(params, x, policy, collect_kv,
                                         collect_states)
        if not moe_stats:
            aux = aux["aux_loss"]
        x = rmsnorm(params["final_norm"], x)
        if last_index is not None:
            x = x[torch.arange(B, device=x.device), last_index][:, None]
        elif logits_last_only:
            x = x[:, -1:]
        logits = unembed_apply(params["embed"], x, policy)
        return (logits, aux) + ((kv,) if collect_kv else ()) \
            + ((states,) if collect_states else ())

    def _stack(self, params, x, policy, collect_kv: bool,
               collect_states: bool):
        """The layers over the embedded x.  Returns (x, aux, kv or None,
        states or None); aux: the summed ``aux_loss`` and, for the moe
        family, each layer's ``dropped_frac`` stacked."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux, ks, vs, states = 0.0, [], [], None
        dropped = []
        if cfg.family in _ATTN_FAMILIES:
            for i in range(cfg.n_layers):
                x, a, (k, v) = attn_block_apply(
                    _layer(params["layers"], i), x, positions, cfg,
                    policy=policy)
                aux = aux + a["aux_loss"]
                if "dropped_frac" in a:
                    dropped.append(a["dropped_frac"])
                if collect_kv:
                    ks.append(k)
                    vs.append(v)
        elif cfg.family == "ssm":
            x, states = self._ssm_stack(params["layers"], x,
                                        collect=collect_states)
        else:  # hybrid
            convs, hs = [], []
            for s, e, shared in self._segments():
                x, st = self._ssm_stack(params["layers"], x,
                                        collect=collect_states, start=s,
                                        end=e)
                if collect_states:
                    convs.append(st[0])
                    hs.append(st[1])
                if shared:
                    x, _, (k, v) = attn_block_apply(
                        params["shared_attn"], x, positions, cfg,
                        policy=policy)
                    if collect_kv:
                        ks.append(k)
                        vs.append(v)
            if collect_states:
                states = (torch.cat(convs), torch.cat(hs))
        kv = None
        if ks:
            kv = (torch.stack([to_cache(k, self.cache_dtype) for k in ks]),
                  torch.stack([to_cache(v, self.cache_dtype) for v in vs]))
        aux = {"aux_loss": aux}
        if dropped:
            aux["dropped_frac"] = torch.stack(dropped)
        return x, aux, kv, states

    def _ssm_stack(self, layers, x, states=None, collect: bool = False,
                   start: int = 0, end: Optional[int] = None):
        """Layers ``start`` to ``end`` (default all) of the ssm stack over
        x.  ``states``: per-layer (conv, h) stacked on a leading axis over
        every layer, to resume from (None: zeros).  Returns (x, (conv, h)
        of those layers stacked) when collecting or resuming, else (x,
        None)."""
        convs, hs = [], []
        keep = collect or states is not None
        for i in range(start, self.cfg.n_layers if end is None else end):
            st = None if states is None else (states[0][i], states[1][i])
            out = ssm_block_apply(_layer(layers, i), x, self.cfg, state=st,
                                  return_state=keep)
            if keep:
                x, (conv, h) = out
                convs.append(conv)
                hs.append(h)
            else:
                x = out
        return x, ((torch.stack(convs), torch.stack(hs)) if keep else None)

    def _decode_states(self, params, tokens, policy, states,
                       prefix_embeds=None, frame_embeds=None):
        """The hybrid's decode states after a prefill, the JAX package's
        way: from a second forward whose shared blocks run with no policy
        (``_prefill_ssm_states``).  Under an emulating policy they differ
        from the first pass's after the first shared application, so that
        pass runs here; otherwise the first pass's are the same numbers."""
        if self.cfg.family != "hybrid" or not _emulates(policy):
            return states
        x = self._embed_inputs(params, tokens, prefix_embeds, frame_embeds)
        return self._stack(params, x, None, False, True)[3]

    # -------------------------------------------------------- caches -------
    @property
    def cache_dtype(self):
        return _DTYPES[self.cfg.kv_cache_dtype or self.cfg.dtype]

    def init_cache(self, batch: int, max_len: int) -> DecodeCache:
        """Zeroed decode state for ``batch`` lanes: KV of ``max_len``
        positions (a ring of min(max_len, window) slots with a window) and,
        for ssm and hybrid, conv and h carries (which do not grow with the
        length)."""
        cfg, dev = self.cfg, self.device
        data = {}
        if cfg.family in ("ssm", "hybrid"):
            (conv_s, conv_t), (h_s, h_t) = ssm.mamba_state_shapes(cfg, batch)
            L = cfg.n_layers
            data["conv"] = torch.zeros((L,) + conv_s, dtype=conv_t,
                                       device=dev)
            data["h"] = torch.zeros((L,) + h_s, dtype=h_t, device=dev)
        if cfg.family != "ssm":
            n = cfg.n_layers if cfg.family in _ATTN_FAMILIES \
                else self.n_shared_applications
            smax = min(max_len, cfg.window) if self.ring else max_len
            shp = (n, batch, smax, cfg.n_kv_heads, cfg.head_dim)
            for name in ("k", "v"):
                data[name] = torch.zeros(shp, dtype=self.cache_dtype,
                                         device=dev)
        return DecodeCache(data, torch.zeros((), dtype=torch.int64,
                                             device=dev))

    def cache_at_length(self, cache: DecodeCache, length) -> DecodeCache:
        return DecodeCache(cache.data, torch.as_tensor(
            length, dtype=torch.int64, device=self.device))

    # -------------------------------------------------------- decode -------
    def _ssm_decode(self, lp, x, data, i, write_mask):
        """One ssm layer's decode step; layer ``i``'s carries are written in
        place (masked-off lanes keep theirs)."""
        x, new = ssm_block_apply(lp, x, self.cfg, return_state=True,
                                 state=(data["conv"][i], data["h"][i]))
        for old, fresh in zip((data["conv"][i], data["h"][i]), new):
            if write_mask is not None:
                keep = write_mask.reshape((x.shape[0],) + (1,) *
                                          (fresh.dim() - 1))
                fresh = torch.where(keep, fresh, old)
            old.copy_(fresh)
        return x

    def decode_step(self, params, cache: DecodeCache, tokens, *, policy=None,
                    write_mask=None):
        """tokens: (B,1) -> (logits (B,1,V), cache advanced by one).

        The cache is written in place; ``write_mask`` (B,) bool leaves the
        cache bits of masked-off lanes untouched."""
        cfg = self.cfg
        x = embed_apply(params["embed"], tokens)
        B = x.shape[0]
        clen = cache.length
        lens = clen.expand(B) if clen.dim() == 0 else clen
        data = cache.data
        if cfg.family in _ATTN_FAMILIES:
            for i in range(cfg.n_layers):
                x = attn_block_decode(_layer(params["layers"], i), x,
                                      data["k"][i], data["v"][i], lens, cfg,
                                      ring=self.ring, policy=policy,
                                      write_mask=write_mask)
        else:
            app = 0
            for s, e, shared in self._segments():
                for i in range(s, e):
                    x = self._ssm_decode(_layer(params["layers"], i), x,
                                         data, i, write_mask)
                if shared:
                    x = attn_block_decode(params["shared_attn"], x,
                                          data["k"][app], data["v"][app],
                                          lens, cfg, ring=False,
                                          policy=policy,
                                          write_mask=write_mask)
                    app += 1
        x = rmsnorm(params["final_norm"], x)
        logits = unembed_apply(params["embed"], x, policy)
        return logits, DecodeCache(cache.data, clen + 1)

    # -------------------------------------------------------- prefill ------
    def _collect(self, params, tokens, policy, prefix_embeds=None,
                 frame_embeds=None, **kw):
        """One forward that returns what a prefill keeps: (logits, kv or
        None, states or None)."""
        fam = self.cfg.family
        out = self.apply(params, tokens, prefix_embeds=prefix_embeds,
                         frame_embeds=frame_embeds, policy=policy,
                         collect_kv=fam != "ssm",
                         collect_states=fam in ("ssm", "hybrid"), **kw)
        kv = out[2] if fam != "ssm" else None
        states = out[-1] if fam in ("ssm", "hybrid") else None
        return out[0], kv, self._decode_states(
            params, tokens, policy, states, prefix_embeds, frame_embeds)

    def prefill(self, params, tokens=None, *, prefix_embeds=None,
                frame_embeds=None, max_len: Optional[int] = None,
                policy=None):
        """Run the full prompt (``tokens``, or ``frame_embeds``, after any
        ``prefix_embeds``: ``apply``'s inputs), build a decode cache.
        Returns (last_logits (B,V), cache); the cache's length counts the
        prefix.  A ring cache shorter than the prompt keeps the prompt's
        tail, ring-aligned: position p at slot p % smax, where decode
        writes next."""
        logits, kv, states = self._collect(
            params, tokens, policy, prefix_embeds, frame_embeds,
            logits_last_only=True)
        B, S = (tokens if frame_embeds is None else frame_embeds).shape[:2]
        if prefix_embeds is not None:
            S += prefix_embeds.shape[1]
        if self.cfg.family == "ssm":  # the state does not grow with max_len
            cache = DecodeCache(dict(zip(("conv", "h"), states)), None)
            return logits[:, -1], self.cache_at_length(cache, S)
        cache = self.init_cache(B, max_len or S)
        data = cache.data
        if kv is not None:
            smax = data["k"].shape[2]
            for name, t in zip(("k", "v"), kv):
                if smax >= S:
                    data[name][:, :, :S] = t
                else:
                    data[name].copy_(torch.roll(t[:, :, S - smax:], S % smax,
                                                dims=2))
        if states is not None:
            data["conv"].copy_(states[0])
            data["h"].copy_(states[1])
        return logits[:, -1], self.cache_at_length(cache, S)

    def prefill_batched(self, params, tokens, true_lens, *, policy=None):
        """Bucket-padded batched prefill for the serving engine.

        tokens: (M, Lb) right-padded to one bucket length; true_lens: (M,).
        Returns ``(last_logits (M, V), kv or None, states or None)``: k, v
        of shape (L or n_shared_applications, M, Lb, Hkv, D) and the ssm
        and hybrid families' (conv, h).  Right-padding is exact for causal
        attention: a pad never enters a valid position's context.  SSM
        state carries run through pads, so those families must be called
        with exact lengths (all ``true_lens == Lb``)."""
        true_lens = torch.as_tensor(true_lens, dtype=torch.int64,
                                    device=self.device)
        logits, kv, states = self._collect(params, tokens, policy,
                                           last_index=true_lens - 1)
        return logits[:, 0], kv, states

    def prefill_chunk(self, params, cache: DecodeCache, tokens, offsets,
                      chunk_lens, slot_ids, *, policy=None):
        """One chunk of a chunk-resumable prefill over M lanes of a batched
        decode cache (``cache.length`` per slot, (B,)).

        tokens: (M, Cb) right-padded chunk tokens; offsets: (M,) tokens
        already prefilled per lane; chunk_lens: (M,) valid tokens; slot_ids:
        (M,) cache lanes.  Returns ``(last_logits (M, V), cache)`` with the
        chunk's KV written at the offsets (ring-aligned on a ring) and the
        lane lengths advanced to ``offsets + chunk_lens``.  History is read
        back from the cache, so the cache dtype must equal the compute
        dtype.

        The ssm and hybrid families resume each lane from its conv/h
        carries (a lane with offset 0 starts from zeros, whatever the slot
        held) and write them back; their chunks must be exact length
        (``chunk_lens == Cb``: the conv carry is the raw chunk tail), and
        the prefill equals the monolithic one when every non-final boundary
        lands on a multiple of ``cfg.ssm_scan_chunk``."""
        cfg, dev = self.cfg, self.device
        x = embed_apply(params["embed"], tokens)
        M, Cb = tokens.shape
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
        chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int64,
                                     device=dev)
        slot_ids = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        positions = offsets[:, None] + torch.arange(Cb, device=dev)[None, :]
        data = cache.data

        def attend(p, x, i, ring):
            x, k2, v2 = _chunk_attn_block(
                p, x, data["k"][i][slot_ids], data["v"][i][slot_ids],
                offsets, chunk_lens, positions, cfg, ring=ring, policy=policy)
            data["k"][i, slot_ids] = k2
            data["v"][i, slot_ids] = v2
            return x

        if cfg.family in _ATTN_FAMILIES:
            for i in range(cfg.n_layers):
                x = attend(_layer(params["layers"], i), x, i, self.ring)
        else:
            fresh = offsets == 0
            lanes = []
            for name in ("conv", "h"):
                t = data[name][:, slot_ids]
                lanes.append(t.masked_fill(
                    fresh.reshape((1, M) + (1,) * (t.dim() - 2)), 0))
            convs, hs, app = [], [], 0
            for s, e, shared in self._segments():
                x, (conv, h) = self._ssm_stack(params["layers"], x,
                                               states=lanes, start=s, end=e)
                convs.append(conv)
                hs.append(h)
                if shared:
                    x = attend(params["shared_attn"], x, app, False)
                    app += 1
            data["conv"][:, slot_ids] = torch.cat(convs)
            data["h"][:, slot_ids] = torch.cat(hs)
        length = cache.length.clone()
        length[slot_ids] = offsets + chunk_lens
        x = rmsnorm(params["final_norm"], x)
        x = x[torch.arange(M, device=dev), chunk_lens - 1][:, None]
        logits = unembed_apply(params["embed"], x, policy)
        return logits[:, 0], DecodeCache(data, length)

    def prefill_chunked(self, params, tokens, chunk_size: int, *,
                        max_len: Optional[int] = None, policy=None):
        """The monolithic prefill built from ``prefill_chunk`` steps of
        ``chunk_size`` tokens.  tokens: (B, S) exact (no pads).  Returns
        ``(last_logits (B, V), cache)`` with per-lane lengths, equal to
        ``prefill``'s for any chunk size obeying the family's boundary
        contract (see ``prefill_chunk``)."""
        B, S = tokens.shape
        base = self.init_cache(B, max_len or S)
        cache = DecodeCache(base.data, torch.zeros(B, dtype=torch.int64,
                                                   device=self.device))
        slot_ids = torch.arange(B, device=self.device)
        last = None
        for off in range(0, S, chunk_size):
            clen = min(chunk_size, S - off)
            last, cache = self.prefill_chunk(
                params, cache, tokens[:, off:off + clen],
                torch.full((B,), off), torch.full((B,), clen), slot_ids,
                policy=policy)
        return last, cache

    def decode_scan(self, params, cache: DecodeCache, tok, active, budget,
                    n_steps: int, *, pad_id: int = 0, policy=None,
                    stop_tokens: tuple = ()):
        """Greedy multi-token decode: ``n_steps`` decode_step + argmax
        iterations with no host sync.

        cache.length must be per-slot (B,); tok: (B, 1) next token per
        slot; active: (B,) bool gates which lanes sample/advance; budget:
        (B,) remaining tokens per slot.  Inactive lanes ride the batched
        step but keep their cache bits (a ring write or an ssm state is not
        masked by length), length, token and budget.  A lane
        deactivates when its budget hits zero or, with ``stop_tokens``,
        when it samples a stop token (which is still emitted).  Returns
        ``(cache, tok, active, budget, toks (n, B), emitted (n, B))``."""
        stops = torch.tensor([int(s) for s in stop_tokens],
                             dtype=torch.int64, device=self.device)
        toks, emitted = [], []
        for _ in range(n_steps):
            logits, stepped = self.decode_step(params, cache, tok,
                                               policy=policy,
                                               write_mask=active)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            toks.append(torch.where(active, nxt, pad_id))
            emitted.append(active)
            budget = budget - active.to(budget.dtype)
            length = torch.where(active, stepped.length, cache.length)
            tok = torch.where(active[:, None], nxt[:, None], tok)
            new_active = active & (budget > 0)
            if len(stop_tokens):
                stopped = torch.isin(nxt, stops)
                new_active = new_active & ~(active & stopped)
            cache, active = DecodeCache(cache.data, length), new_active
        return (cache, tok, active, budget, torch.stack(toks),
                torch.stack(emitted))
