"""Model assembly: the decoder LM (counterpart of ``repro.models.model``).

Families ported so far:
  dense : L x [GQA attention + MLP]
  ssm   : L x [Mamba-1]    (attention-free; falcon-mamba)

The JAX package stacks each layer's parameters along a leading axis and
runs the stack with ``lax.scan``; the port keeps the same parameter tree
(so ``models.convert.params_from_jax`` is a plain copy) and loops over the
layers.  Decode is a single-token step against a cache (KV for dense,
conv + state carries for ssm) that the port updates in place (the JAX
function returns a new one); the returned ``DecodeCache`` shares the
caller's storage.

The other families raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
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
from repro_torch.models.numerics import matmul

#: families not ported yet -> the ROADMAP.md queue-1 item that ports them
_LATER_FAMILIES = {"hybrid": 14, "moe": 10, "vlm": 13, "audio": 13}
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


# ---------------------------------------------------------------------------
# Attention transformer block
# ---------------------------------------------------------------------------
def attn_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, n: int):
    """``n`` stacked blocks' parameters (leading axis = layer)."""
    d, hd, dev = cfg.d_model, cfg.head_dim, gen.device
    lead = (n,)
    p = {
        "ln1": rmsnorm_init(d, dtype, dev, lead=lead),
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, lead=lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, lead=lead),
        "ln2": rmsnorm_init(d, dtype, dev, lead=lead),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads * hd),
                            ("bk", cfg.n_kv_heads * hd),
                            ("bv", cfg.n_kv_heads * hd)):
            p[name] = torch.zeros((n, width), dtype=dtype, device=dev)
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


def _residual_ffn(p, x, attn, cfg: ArchConfig, policy):
    """x + wo(attn), then + mlp(norm): the block's second half."""
    B, S = attn.shape[:2]
    x = x + matmul(attn.reshape(B, S, -1), p["wo"], policy)
    h2 = rmsnorm(p["ln2"], x)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_act, policy)


def attn_block_apply(p, x, positions, cfg: ArchConfig, *, policy=None):
    """Full-sequence block.  Returns (out, (k, v))."""
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, positions, policy)
    attn = flash_attention_trainable(q, k, v, causal=True, window=cfg.window)
    return _residual_ffn(p, x, attn, cfg, policy), (k, v)


def attn_block_decode(p, x, k_cache, v_cache, cache_len, cfg: ArchConfig, *,
                      policy=None, write_mask=None):
    """x: (B,1,d); caches (B,Smax,Hkv,D), written in place at each lane's
    ``cache_len`` (B,) — except lanes where ``write_mask`` is False or the
    position lies beyond the cache, whose cache bits stay as they were."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, cache_len[:, None], policy)
    lanes = torch.arange(B, device=x.device)
    keep = cache_len < Smax
    if write_mask is not None:
        keep = keep & write_mask
    idx = cache_len.clamp(max=Smax - 1)
    keep = keep[:, None, None]
    k_cache[lanes, idx] = torch.where(keep, to_cache(k[:, 0], k_cache.dtype),
                                      k_cache[lanes, idx])
    v_cache[lanes, idx] = torch.where(keep, to_cache(v[:, 0], v_cache.dtype),
                                      v_cache[lanes, idx])
    valid = torch.clamp(cache_len + 1, max=Smax)
    attn = decode_attention(q, k_cache, v_cache, valid, window=cfg.window)
    return _residual_ffn(p, x, attn, cfg, policy)


def _chunk_attn_block(p, x, k_cache, v_cache, offsets, chunk_lens, positions,
                      cfg: ArchConfig, *, policy=None):
    """Chunk-resumable attention block over gathered per-lane cache lanes.

    x: (M,Cb,d); k_cache/v_cache: (M,smax,Hkv,D); offsets/chunk_lens: (M,)
    tokens already prefilled / valid tokens in this chunk; positions:
    (M,Cb).  Attends against the history + the fresh chunk and returns
    (out, new_k, new_v) with only the valid chunk K/V written."""
    M, Cb, _ = x.shape
    smax = k_cache.shape[1]
    dev = x.device
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, positions, policy)
    valid_new = torch.arange(Cb, device=dev)[None, :] < chunk_lens[:, None]
    hist_pos = torch.arange(smax, device=dev).expand(M, smax)
    hist_valid = hist_pos < offsets[:, None]
    k_all = torch.cat([k_cache.to(k.dtype), k], dim=1)
    v_all = torch.cat([v_cache.to(v.dtype), v], dim=1)
    k_pos = torch.cat([hist_pos, positions], dim=1)
    k_valid = torch.cat([hist_valid, valid_new], dim=1)
    attn = chunk_attention(q, k_all, v_all, positions, k_pos, k_valid,
                           window=cfg.window)
    # pad columns go to a scratch slot past the cache and are dropped
    write_idx = torch.where(valid_new, positions, smax).clamp(max=smax)
    lanes = torch.arange(M, device=dev)[:, None]
    new_k, new_v = [], []
    for cache, fresh, out in ((k_cache, k, new_k), (v_cache, v, new_v)):
        ext = torch.cat([cache, cache[:, :1]], dim=1)
        ext[lanes, write_idx] = to_cache(fresh, cache.dtype)
        out.append(ext[:, :smax])
    return (_residual_ffn(p, x, attn, cfg, policy), new_k[0], new_v[0])


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
    (dense) or {"conv" (L, B, K-1, C), "h" (L, B, d_in, N)} (ssm), and
    ``length``, a 0-d (single sequence) or (B,) per-slot int64 tensor."""

    data: Dict
    length: torch.Tensor


class LM:
    """Decoder LM for one ArchConfig, on ``device`` (default CUDA)."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family in _LATER_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family} family is not ported yet: ROADMAP.md "
                f"queue 1 item {_LATER_FAMILIES[cfg.family]}")
        if cfg.family not in ("dense", "ssm"):
            raise ValueError(cfg.family)
        if cfg.window:
            raise NotImplementedError(
                "sliding-window (ring) KV caches arrive with mixtral: "
                "ROADMAP.md queue 1 item 10")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab_padded = _pad_vocab(cfg.vocab_size)
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------- init ----
    def init(self, seed: int) -> Dict:
        """Random parameters drawn on the model's device from a
        ``torch.Generator`` seeded with ``seed``."""
        cfg, dtype = self.cfg, self.dtype
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        block_init = ssm_block_init if cfg.family == "ssm" \
            else attn_block_init
        return {
            "embed": embed_init(gen, self.vocab_padded, cfg.d_model, dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, self.device),
            "layers": block_init(gen, cfg, dtype, cfg.n_layers),
        }

    # ------------------------------------------------------- forward -------
    def apply(self, params, tokens, *, policy=None, collect_kv: bool = False,
              collect_states: bool = False, logits_last_only: bool = False,
              last_index=None):
        """Full-sequence forward. Returns (logits, aux) or, with
        ``collect_kv`` (dense), (logits, aux, (k, v)) with k, v of shape
        (L, B, S, Hkv, D) in the cache dtype, or with ``collect_states``
        (ssm), (logits, aux, (conv, h)): each layer's decode state after the
        sequence, stacked.  The JAX package's prefill runs the stack a
        second time for the states (``_prefill_ssm_states``); the port takes
        them from this pass, whose numbers are the same.

        logits_last_only: unembed only the final position; last_index: (B,)
        per-sample position to unembed instead (bucket-padded prefill).
        Under a policy, only the projections and the unembed are emulated:
        the ssm family's only policy-routed matmul is the unembed."""
        cfg = self.cfg
        x = embed_apply(params["embed"], tokens)
        B, S, _ = x.shape
        collected = None
        if cfg.family == "ssm":
            x, states = self._ssm_stack(params["layers"], x,
                                        collect=collect_states)
            if collect_states:
                collected = states
        else:
            positions = torch.arange(S, device=x.device)[None, :]
            ks, vs = [], []
            for i in range(cfg.n_layers):
                x, (k, v) = attn_block_apply(_layer(params["layers"], i), x,
                                             positions, cfg, policy=policy)
                if collect_kv:
                    ks.append(to_cache(k, self.cache_dtype))
                    vs.append(to_cache(v, self.cache_dtype))
            if collect_kv:
                collected = (torch.stack(ks), torch.stack(vs))
        x = rmsnorm(params["final_norm"], x)
        if last_index is not None:
            x = x[torch.arange(B, device=x.device), last_index][:, None]
        elif logits_last_only:
            x = x[:, -1:]
        logits = unembed_apply(params["embed"], x, policy)
        if collected is not None:
            return logits, 0.0, collected
        return logits, 0.0

    def _ssm_stack(self, layers, x, states=None, collect: bool = False):
        """The ssm layers over x.  ``states``: per-layer (conv, h) stacked
        on a leading layer axis to resume from (None: zeros).  Returns
        (x, (conv, h) stacked) when collecting or resuming, else (x, None).
        """
        convs, hs = [], []
        keep = collect or states is not None
        for i in range(self.cfg.n_layers):
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

    # -------------------------------------------------------- caches -------
    @property
    def cache_dtype(self):
        return _DTYPES[self.cfg.kv_cache_dtype or self.cfg.dtype]

    def init_cache(self, batch: int, max_len: int) -> DecodeCache:
        """Zeroed decode state for ``batch`` lanes: KV of ``max_len``
        positions (dense) or conv and h carries (ssm, whose state does not
        grow with the length)."""
        cfg, L, dev = self.cfg, self.cfg.n_layers, self.device
        if cfg.family == "ssm":
            (conv_s, conv_t), (h_s, h_t) = ssm.mamba_state_shapes(cfg, batch)
            data = {"conv": torch.zeros((L,) + conv_s, dtype=conv_t,
                                        device=dev),
                    "h": torch.zeros((L,) + h_s, dtype=h_t, device=dev)}
        else:
            shp = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            data = {name: torch.zeros(shp, dtype=self.cache_dtype,
                                      device=dev) for name in ("k", "v")}
        return DecodeCache(data, torch.zeros((), dtype=torch.int64,
                                             device=dev))

    def cache_at_length(self, cache: DecodeCache, length) -> DecodeCache:
        return DecodeCache(cache.data, torch.as_tensor(
            length, dtype=torch.int64, device=self.device))

    # -------------------------------------------------------- decode -------
    def decode_step(self, params, cache: DecodeCache, tokens, *, policy=None,
                    write_mask=None):
        """tokens: (B,1) -> (logits (B,1,V), cache advanced by one).

        The cache is written in place; ``write_mask`` (B,) bool leaves the
        cache bits of masked-off lanes untouched."""
        x = embed_apply(params["embed"], tokens)
        B = x.shape[0]
        clen = cache.length
        lens = clen.expand(B) if clen.dim() == 0 else clen
        data = cache.data
        for i in range(self.cfg.n_layers):
            lp = _layer(params["layers"], i)
            if self.cfg.family == "ssm":
                x, new = ssm_block_apply(lp, x, self.cfg, return_state=True,
                                         state=(data["conv"][i],
                                                data["h"][i]))
                for old, fresh in zip((data["conv"][i], data["h"][i]), new):
                    if write_mask is not None:
                        keep = write_mask.reshape((B,) + (1,) *
                                                  (fresh.dim() - 1))
                        fresh = torch.where(keep, fresh, old)
                    old.copy_(fresh)
                continue
            x = attn_block_decode(lp, x, data["k"][i], data["v"][i], lens,
                                  self.cfg, policy=policy,
                                  write_mask=write_mask)
        x = rmsnorm(params["final_norm"], x)
        logits = unembed_apply(params["embed"], x, policy)
        return logits, DecodeCache(cache.data, clen + 1)

    # -------------------------------------------------------- prefill ------
    def prefill(self, params, tokens, *, max_len: Optional[int] = None,
                policy=None):
        """Run the full prompt, build a decode cache. Returns
        (last_logits (B,V), cache)."""
        ssm_family = self.cfg.family == "ssm"
        logits, _, collected = self.apply(
            params, tokens, policy=policy, collect_kv=not ssm_family,
            collect_states=ssm_family, logits_last_only=True)
        B, S = tokens.shape
        if ssm_family:  # the state does not grow with max_len
            cache = DecodeCache(dict(zip(("conv", "h"), collected)), None)
        else:
            cache = self.init_cache(B, max_len or S)
            cache.data["k"][:, :, :S] = collected[0]
            cache.data["v"][:, :, :S] = collected[1]
        return logits[:, -1], self.cache_at_length(cache, S)

    def prefill_batched(self, params, tokens, true_lens, *, policy=None):
        """Bucket-padded batched prefill for the serving engine.

        tokens: (M, Lb) right-padded to one bucket length; true_lens: (M,).
        Returns ``(last_logits (M, V), (k, v), None)`` with k, v of shape
        (L, M, Lb, Hkv, D), or for the ssm family ``(last_logits, None,
        (conv, h))``.  Right-padding is exact for causal attention: a pad
        never enters a valid position's context.  SSM state carries run
        through pads, so that family must be called with exact lengths (all
        ``true_lens == Lb``)."""
        true_lens = torch.as_tensor(true_lens, dtype=torch.int64,
                                    device=self.device)
        ssm_family = self.cfg.family == "ssm"
        logits, _, collected = self.apply(
            params, tokens, policy=policy, collect_kv=not ssm_family,
            collect_states=ssm_family, last_index=true_lens - 1)
        if ssm_family:
            return logits[:, 0], None, collected
        return logits[:, 0], collected, None

    def prefill_chunk(self, params, cache: DecodeCache, tokens, offsets,
                      chunk_lens, slot_ids, *, policy=None):
        """One chunk of a chunk-resumable prefill over M lanes of a batched
        decode cache (``cache.length`` per slot, (B,)).

        tokens: (M, Cb) right-padded chunk tokens; offsets: (M,) tokens
        already prefilled per lane; chunk_lens: (M,) valid tokens; slot_ids:
        (M,) cache lanes.  Returns ``(last_logits (M, V), cache)`` with the
        chunk's KV written at the offsets and the lane lengths advanced to
        ``offsets + chunk_lens``.  History is read back from the cache, so
        the cache dtype must equal the compute dtype.

        The ssm family resumes each lane from its conv/h carries (a lane
        with offset 0 starts from zeros, whatever the slot held) and writes
        them back; its chunks must be exact length (``chunk_lens == Cb``:
        the conv carry is the raw chunk tail), and the prefill equals the
        monolithic one when every non-final boundary lands on a multiple of
        ``cfg.ssm_scan_chunk``."""
        dev = self.device
        x = embed_apply(params["embed"], tokens)
        M, Cb = tokens.shape
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
        chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int64,
                                     device=dev)
        slot_ids = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        positions = offsets[:, None] + torch.arange(Cb, device=dev)[None, :]
        data = cache.data
        if self.cfg.family == "ssm":
            fresh = offsets == 0
            lanes = []
            for name in ("conv", "h"):
                t = data[name][:, slot_ids]
                lanes.append(t.masked_fill(
                    fresh.reshape((1, M) + (1,) * (t.dim() - 2)), 0))
            x, (conv, h) = self._ssm_stack(params["layers"], x, states=lanes)
            data["conv"][:, slot_ids] = conv
            data["h"][:, slot_ids] = h
        else:
            for i in range(self.cfg.n_layers):
                x, k2, v2 = _chunk_attn_block(
                    _layer(params["layers"], i), x, data["k"][i][slot_ids],
                    data["v"][i][slot_ids], offsets, chunk_lens, positions,
                    self.cfg, policy=policy)
                data["k"][i, slot_ids] = k2
                data["v"][i, slot_ids] = v2
        length = cache.length.clone()
        length[slot_ids] = offsets + chunk_lens
        x = rmsnorm(params["final_norm"], x)
        x = x[torch.arange(M, device=dev), chunk_lens - 1][:, None]
        logits = unembed_apply(params["embed"], x, policy)
        return logits[:, 0], DecodeCache(data, length)

    def decode_scan(self, params, cache: DecodeCache, tok, active, budget,
                    n_steps: int, *, pad_id: int = 0, policy=None,
                    stop_tokens: tuple = ()):
        """Greedy multi-token decode: ``n_steps`` decode_step + argmax
        iterations with no host sync.

        cache.length must be per-slot (B,); tok: (B, 1) next token per
        slot; active: (B,) bool gates which lanes sample/advance; budget:
        (B,) remaining tokens per slot.  Inactive lanes ride the batched
        step but keep their cache bits, length, token and budget.  A lane
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
