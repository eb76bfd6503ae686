"""Batched serving engine: continuous batching over the LM's decode step
(counterpart of ``repro.serve.engine``, without chip-policy routing).

The engine drives the LM's prefill/decode steps with a fixed slot count.
Requests are admitted into free slots; finished and expired slots are
recycled.  Structure, as in the JAX engine:

  * **Fused multi-token decode** — ``LM.decode_scan`` decodes up to N
    tokens per dispatch with greedy sampling on the device; the slot state
    (per-slot lengths, next token, remaining budget, active flags) stays in
    device tensors and the host syncs once per dispatch.
  * **Bucketed batched prefill** — prompt lengths are padded up to
    power-of-two buckets (exact for causal attention) and same-bucket
    queued requests are admitted in one batched prefill.  The ssm family's
    states integrate every prompt token, pads included, so it batches at
    exact lengths instead.
  * **Chunked prefill** (``prefill_chunk=N``) — prompts stream through
    their lanes N tokens per step, interleaved with decode dispatches.  For
    the ssm family N is rounded up to ``cfg.ssm_scan_chunk`` (the scan's
    carry points) and chunks stay exact length.
  * **Stop tokens** — a lane freezes on the device the moment it samples
    one; the stop token is emitted, nothing after it.
  * **Deadlines** on an injected ``clock``: a request that expired before a
    step is released without decoding another token; tokens decoded in the
    dispatch during which the deadline passes are kept.

The device state is updated in place (the JAX engine donates its buffers
to the same effect).  Greedy sampling only.  The engine runs on the
model's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.faults import UnitFault
from repro_torch.models import LM, DecodeCache
from repro_torch.telemetry.tracer import NULL_TRACER
from repro_torch.telemetry.tracer import Event as TraceEvent


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int
    max_new_tokens: int
    deadline_s: Optional[float] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    expired: bool = False
    #: structurally rejected by validation: never admitted
    rejected: bool = False
    reject_reason: str = ""
    #: clock time ``submit()`` accepted the request (TTFT origin)
    submitted_s: Optional[float] = None
    #: clock time the first output token was committed
    first_token_s: Optional[float] = None


class RequestRejected(ValueError):
    """Structured admission reject: ``submit()`` raises it and records the
    reject on the request and in ``server.rejected``."""

    def __init__(self, req: "Request", code: str, reason: str):
        super().__init__(f"request {req.uid}: [{code}] {reason}")
        self.req = req
        self.code = code
        self.reason = reason


def bucket_length(n: int, *, lo: int = 8) -> int:
    """Power-of-two prompt-length bucket (>= lo) — the prefill pad target."""
    b = lo
    while b < n:
        b *= 2
    return b


class BatchedServer:
    """Fixed-slot continuous batching server around one LM.

    ``dispatch_tokens`` is the fused decode depth ``run()`` uses per
    dispatch; ``clock`` is the deadline time source.  Fleet routing by a
    chip policy is not ported yet (ROADMAP.md queue 1 item 7): the slots
    form one fleet, named ''."""

    def __init__(self, model: LM, params, *, slots: int, max_len: int,
                 pad_id: int = 0, chip_policy=None, dispatch_tokens: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 stop_tokens: Tuple[int, ...] = (), min_bucket: int = 8,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None, tracer=None):
        if chip_policy is not None:
            raise NotImplementedError("chip_policy routing is not ported "
                                      "yet: ROADMAP.md queue 1 item 7")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if model.cache_dtype != model.dtype:
                raise ValueError(
                    "chunked prefill reads KV history back from the cache "
                    "between chunks, so the cache dtype must equal the "
                    f"compute dtype (cache {model.cache_dtype} != compute "
                    f"{model.dtype})")
            if model.cfg.family == "ssm":
                # the chunked prefill resumes exactly only at the scan's
                # carry points: round the chunk up to them
                sc = max(int(model.cfg.ssm_scan_chunk), 1)
                prefill_chunk = -(-prefill_chunk // sc) * sc
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.cfg = model.cfg
        self.dispatch_tokens = dispatch_tokens
        self.min_bucket = min_bucket
        self.prefill_chunk = prefill_chunk
        self.prefill_token_budget = prefill_token_budget
        self.stop_tokens = tuple(int(s) for s in stop_tokens)
        self._stop_set = set(self.stop_tokens)
        self._clock = clock
        self._prefill_pos: Dict[int, int] = {}  # slot -> tokens prefilled
        self._slot_pf_budget = [0] * slots  # decode budget armed on finish
        self.prefill_tokens = 0
        self.tokens_decoded = 0
        self.dispatches = 0
        self.host_syncs = 0
        self._stall_prefill_tokens = 0
        self._contended_decode_tokens = 0
        dev = model.device
        # ssm states integrate every prompt token, so bucket pads would
        # perturb them: that family batches at exact lengths
        self._bucketed = self.cfg.family != "ssm"
        cache = model.init_cache(slots, max_len)
        # a KV cache caps the per-slot length; ssm states do not grow
        self._len_cap = cache.data["k"].shape[2] if "k" in cache.data \
            else None
        # device-resident slot state
        self.cache = DecodeCache(cache.data, torch.zeros(
            slots, dtype=torch.int64, device=dev))
        self._next_tok = torch.full((slots, 1), pad_id, dtype=torch.int64,
                                    device=dev)
        self._budget = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._active_mask = torch.zeros(slots, dtype=torch.bool, device=dev)
        # host-side slot table and queue
        self._active: List[Optional[Request]] = [None] * slots
        self._slot_quota = [0] * slots  # 1 + device budget per slot
        self._queue: List[Request] = []
        self._in_service = True
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.reset_run_counters()

    # ------------------------------------------------------------ counters
    def reset_run_counters(self) -> None:
        """Zero the decode-stall inputs and snapshot the cumulative counters
        so ``run_report()`` gives this run's deltas (``run()`` calls it)."""
        self._stall_prefill_tokens = 0
        self._contended_decode_tokens = 0
        self._run_base = dict(tokens_decoded=self.tokens_decoded,
                              prefill_tokens=self.prefill_tokens,
                              dispatches=self.dispatches,
                              host_syncs=self.host_syncs)

    def run_report(self) -> Dict[str, float]:
        """Counters scoped to the current run."""
        out = {k: getattr(self, k) - v for k, v in self._run_base.items()}
        out["decode_stall_frac"] = self.decode_stall_frac
        return out

    @property
    def decode_stall_frac(self) -> float:
        """Over the steps that prefilled while decode-ready lanes existed:
        prefill tokens / (prefill + decode tokens) of those steps."""
        tot = self._stall_prefill_tokens + self._contended_decode_tokens
        return self._stall_prefill_tokens / max(tot, 1)

    # ---------------------------------------------------------- validation
    def _reject(self, req: Request, code: str, reason: str):
        req.rejected = True
        req.reject_reason = f"[{code}] {reason}"
        self.rejected.append(req)
        if self.tracer.enabled:
            now = self._clock()
            self.tracer.request_begin(req.uid, now)
            self.tracer.event(req.uid, TraceEvent.REJECT, now, code=code)
            self.tracer.end_attempt(req.uid, now, "rejected")
            self.tracer.end_request(req.uid, now, "rejected")
        raise RequestRejected(req, code, reason)

    def validate(self, req: Request) -> None:
        """Raises ``RequestRejected`` (and records it) on the first
        violation."""
        n = req.max_new_tokens
        if not isinstance(n, (int, np.integer)) or n < 1:
            self._reject(req, "bad_max_tokens",
                         f"max_new_tokens must be a positive int, got {n!r}")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            self._reject(req, "bad_prompt",
                         f"prompt must be a non-empty 1-D int array, got "
                         f"shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            self._reject(req, "bad_prompt",
                         f"prompt dtype must be integer, got {prompt.dtype}")
        if self._len_cap is not None and len(prompt) > self._len_cap:
            self._reject(req, "prompt_too_long",
                         f"prompt length {len(prompt)} exceeds the engine "
                         f"cache capacity {self._len_cap}")

    def set_fleet_in_service(self, name: str, in_service: bool) -> None:
        if name != "":
            raise KeyError(f"no fleet {name!r}; have ['']")
        self._in_service = in_service

    def submit(self, req: Request):
        self.validate(req)
        if not self._in_service:
            raise UnitFault(f"request {req.uid}: no serving fleet in service")
        if req.submitted_s is None:
            req.submitted_s = self._clock()
        self._queue.append(req)
        if self.tracer.enabled:
            self.tracer.request_begin(req.uid, req.submitted_s,
                                      prompt_tokens=len(req.prompt),
                                      max_new_tokens=req.max_new_tokens)
            self.tracer.event(req.uid, TraceEvent.ADMIT, self._clock())

    def _bucket(self, n: int) -> int:
        if not self._bucketed:
            return n
        return min(bucket_length(n, lo=self.min_bucket), self._len_cap)

    def _finish(self, req: Request):
        req.done = True
        self.finished.append(req)
        if self.tracer.enabled:
            now = self._clock()
            status = "expired" if req.expired else "ok"
            self.tracer.event(
                req.uid, TraceEvent.EXPIRE if req.expired
                else TraceEvent.FINISH, now, tokens_out=len(req.output))
            self.tracer.end_attempt(req.uid, now, status)
            self.tracer.end_request(req.uid, now, status)

    def _expire(self, req: Request):
        req.expired = True
        self._finish(req)

    def _deactivate(self, slots: List[int]) -> None:
        if slots:
            idx = torch.as_tensor(slots, device=self._active_mask.device)
            self._active_mask[idx] = False

    def _expire_active(self, now: float):
        """Release slots whose request expired before this step."""
        released = []
        for s, req in enumerate(self._active):
            if req is not None and req.deadline_s is not None \
                    and now > req.deadline_s:
                self._expire(req)
                self._active[s] = None
                self._prefill_pos.pop(s, None)
                released.append(s)
        self._deactivate(released)

    def idle(self) -> bool:
        """Nothing queued or seated."""
        return not self._queue and all(r is None for r in self._active)

    def _budget_for(self, req: Request) -> int:
        """Device decode budget: the tokens after the first, capped by the
        cache capacity where there is one."""
        cap = req.max_new_tokens - 1
        if self._len_cap is not None:
            cap = min(cap, self._len_cap - len(req.prompt))
        return max(cap, 0)

    def _commit_first(self, req: Request, slot: int, first: int,
                      budget: int, now: float) -> bool:
        """Commit the token the prompt's last logits produced; returns True
        when the request is finished by it (zero budget or a first-token
        stop), which the caller must free on the device."""
        self.tokens_decoded += 1
        req.output.append(first)
        if req.first_token_s is None:
            req.first_token_s = now
        if self.tracer.enabled:
            self.tracer.event(req.uid, TraceEvent.DECODE_DISPATCH, now,
                              tokens=1, slot=slot, first=True)
        if budget == 0 or first in self._stop_set:
            self._finish(req)
            return True
        return False

    # ---------------------------------------------------------- admission
    def _arm(self, slots: List[int], first, budgets: List[int]) -> None:
        """Arm the decode state of lanes whose prompt is complete."""
        dev = self._budget.device
        idx = torch.as_tensor(slots, device=dev)
        b = torch.as_tensor(budgets, dtype=torch.int64, device=dev)
        self._next_tok[idx, 0] = first
        self._budget[idx] = b
        self._active_mask[idx] = b > 0

    def _admit(self, now: float):
        if not self._in_service:
            return
        queue = self._queue
        while queue:
            free = [s for s in range(self.slots) if self._active[s] is None]
            if not free:
                break
            batch: List[Request] = []
            bucket = None
            i = 0
            while i < len(queue) and len(batch) < len(free):
                req = queue[i]
                if req.deadline_s is not None and now > req.deadline_s:
                    queue.pop(i)
                    self._expire(req)  # expired in queue: zero work
                    continue
                b = self._bucket(len(req.prompt))
                if bucket is None:
                    bucket = b
                if b == bucket:  # batched same-bucket admission
                    batch.append(queue.pop(i))
                    continue
                i += 1
            if not batch:
                break
            self._admit_batch(batch, free[:len(batch)], bucket)

    def _admit_batch(self, reqs: List[Request], slot_ids: List[int],
                     bucket: int):
        dev = self.model.device
        tokens = np.full((len(reqs), bucket), self.pad_id, np.int64)
        true_lens = np.array([len(r.prompt) for r in reqs], np.int64)
        for j, req in enumerate(reqs):
            tokens[j, :len(req.prompt)] = np.asarray(req.prompt)
        budgets = [self._budget_for(r) for r in reqs]
        last_logits, kv, states = self.model.prefill_batched(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(true_lens).to(dev))
        first = torch.argmax(last_logits, dim=-1)
        ids = torch.as_tensor(slot_ids, device=dev)
        data = self.cache.data
        if kv is not None:
            data["k"][:, ids, :bucket] = kv[0]
            data["v"][:, ids, :bucket] = kv[1]
        if states is not None:
            data["conv"][:, ids] = states[0]
            data["h"][:, ids] = states[1]
        self.cache.length[ids] = torch.from_numpy(true_lens).to(dev)
        self._arm(slot_ids, first, budgets)
        first = first.tolist()  # one host sync per admitted batch
        self.host_syncs += 1
        now = self._clock()
        dead = []
        for req, slot, f, budget in zip(reqs, slot_ids, first, budgets):
            if self.tracer.enabled:
                self.tracer.begin_attempt(req.uid, now, slot=slot)
                self.tracer.event(req.uid, TraceEvent.SEAT, now, slot=slot)
                self.tracer.event(req.uid, TraceEvent.PREFILL, now,
                                  tokens=len(req.prompt), bucket=bucket,
                                  slot=slot)
            self.prefill_tokens += len(req.prompt)
            if self._commit_first(req, slot, f, budget, now):
                dead.append(slot)
            else:
                self._active[slot] = req
                self._slot_quota[slot] = 1 + budget
        self._deactivate(dead)

    # --------------------------------------- continuous batching scheduler
    def _seat(self, now: float):
        """Move queued requests into free lanes immediately (FIFO) without
        device work; seated lanes prefill chunk by chunk."""
        if not self._in_service:
            return
        free = [s for s in range(self.slots) if self._active[s] is None]
        while self._queue and free:
            req = self._queue.pop(0)
            if req.deadline_s is not None and now > req.deadline_s:
                self._expire(req)
                continue
            slot = free.pop(0)
            self._active[slot] = req
            self._prefill_pos[slot] = 0
            self._slot_pf_budget[slot] = self._budget_for(req)
            self._slot_quota[slot] = 1 + self._slot_pf_budget[slot]
            if self.tracer.enabled:
                self.tracer.begin_attempt(req.uid, now, slot=slot)
                self.tracer.event(req.uid, TraceEvent.SEAT, now, slot=slot)

    def _advance_prefills(self, now: float):
        """Advance every mid-prefill lane by one chunk, grouped by padded
        chunk width (the final partial chunk pads up to a pow2 bucket; ssm
        chunks stay exact length, since the conv carry integrates raw
        inputs).  A lane whose chunk completes its prompt is armed for
        decode and its first token committed (one host sync, only on such
        steps)."""
        C = self.prefill_chunk
        lanes = sorted(self._prefill_pos)

        def clen_of(s):
            return min(C, len(self._active[s].prompt) - self._prefill_pos[s])

        if self.prefill_token_budget is not None and lanes:
            kept, total = [], 0
            for s in lanes:  # whole chunks in lane order, always >= 1
                if kept and total + clen_of(s) > self.prefill_token_budget:
                    break
                kept.append(s)
                total += clen_of(s)
            lanes = kept
        groups: Dict[int, List[int]] = {}
        for s in lanes:
            cb = min(bucket_length(clen_of(s), lo=self.min_bucket), C) \
                if self._bucketed else clen_of(s)
            groups.setdefault(cb, []).append(s)
        dev = self.model.device
        for cb, slots in sorted(groups.items()):
            tokens = np.full((len(slots), cb), self.pad_id, np.int64)
            offs, clens, finals = [], [], []
            for j, s in enumerate(slots):
                p = np.asarray(self._active[s].prompt)
                off, clen = self._prefill_pos[s], clen_of(s)
                tokens[j, :clen] = p[off:off + clen]
                offs.append(off)
                clens.append(clen)
                if off + clen == len(p):
                    finals.append(j)
            last_logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache, torch.from_numpy(tokens).to(dev),
                offs, clens, slots)
            first = None
            if finals:
                fin_slots = [slots[j] for j in finals]
                first = torch.argmax(last_logits[finals], dim=-1)
                self._arm(fin_slots, first,
                          [self._slot_pf_budget[s] for s in fin_slots])
                first = dict(zip(finals, first.tolist()))  # host sync
                self.host_syncs += 1
            dead = []
            for j, s in enumerate(slots):
                req = self._active[s]
                self.prefill_tokens += clens[j]
                if self.tracer.enabled:
                    self.tracer.event(req.uid, TraceEvent.PREFILL_CHUNK, now,
                                      tokens=clens[j], offset=offs[j],
                                      slot=s)
                if j not in finals:
                    self._prefill_pos[s] = offs[j] + clens[j]
                    continue
                del self._prefill_pos[s]
                if self._commit_first(req, s, first[j],
                                      self._slot_pf_budget[s], now):
                    self._active[s] = None
                    dead.append(s)
            self._deactivate(dead)

    # ------------------------------------------------------------ decoding
    def step(self, max_tokens: Optional[int] = None) -> int:
        """One scheduler step: admission (monolithic, or a chunked-prefill
        advance), then one fused decode dispatch over the decode-ready
        slots (up to ``max_tokens`` tokens each, default 1).  Returns the
        number of seated slots."""
        now = self._clock()
        self._expire_active(now)
        decode_ready = sum(1 for s, r in enumerate(self._active)
                           if r is not None and s not in self._prefill_pos)
        pf0 = self.prefill_tokens
        if self.prefill_chunk is not None:
            self._seat(now)
            self._advance_prefills(now)
        else:
            self._admit(now)
        pf_delta = self.prefill_tokens - pf0
        contended = decode_ready > 0 and pf_delta > 0
        if contended:
            self._stall_prefill_tokens += pf_delta
        n_seated = sum(1 for r in self._active if r is not None)
        active_slots = [s for s, r in enumerate(self._active)
                        if r is not None and s not in self._prefill_pos]
        if not active_slots:
            return n_seated
        n = 1 if max_tokens is None else max(1, int(max_tokens))
        (self.cache, self._next_tok, self._active_mask, self._budget, toks,
         emitted) = self.model.decode_scan(
            self.params, self.cache, self._next_tok, self._active_mask,
            self._budget, n, pad_id=self.pad_id, stop_tokens=self.stop_tokens)
        # the host sync: one fetch per N-token dispatch
        fetched = torch.stack([toks, emitted.to(toks.dtype)]).cpu().numpy()
        toks_np, emitted_np = fetched[0], fetched[1].astype(bool)
        self.dispatches += 1
        self.host_syncs += 1
        now = self._clock()
        released = []
        decode_emitted = 0
        for slot in active_slots:
            req = self._active[slot]
            count = int(emitted_np[:, slot].sum())
            decode_emitted += count
            if self.tracer.enabled and count:
                self.tracer.event(req.uid, TraceEvent.DECODE_DISPATCH, now,
                                  tokens=count, slot=slot)
            req.output.extend(int(t) for t in toks_np[:count, slot])
            self.tokens_decoded += count
            if count < n or len(req.output) >= self._slot_quota[slot] \
                    or (count and int(toks_np[count - 1, slot])
                        in self._stop_set):
                # budget exhausted on the device, or the lane sampled a stop
                # token; quota < max_new_tokens means the cache capacity
                # truncated the request
                self._finish(req)
            if not req.done and req.deadline_s is not None \
                    and now > req.deadline_s:
                # expired during this dispatch: its tokens stay, the slot
                # is released for queued traffic
                self._expire(req)
                released.append(slot)
            if req.done:
                self._active[slot] = None
        self._deactivate(released)
        if contended:
            self._contended_decode_tokens += decode_emitted
        return n_seated

    def run(self, max_steps: int = 10_000,
            dispatch_tokens: Optional[int] = None) -> List[Request]:
        """Serve until the queue and slots drain (or ``max_steps`` steps);
        returns the requests finished (including expired) since the last
        ``run`` call."""
        self.reset_run_counters()
        n = self.dispatch_tokens if dispatch_tokens is None \
            else dispatch_tokens
        for _ in range(max_steps):
            if self.idle():
                break
            self.step(n)
        out, self.finished = self.finished, []
        return out


def greedy_decode(model: LM, params, prompt: np.ndarray, n_new: int,
                  max_len: Optional[int] = None,
                  stop_tokens: Tuple[int, ...] = ()) -> List[int]:
    """Single-sequence reference decoder on the model's device (tests
    compare the server against it).  ``stop_tokens``: decoding stops after
    emitting one (the stop token is included)."""
    stops = set(int(s) for s in stop_tokens)
    max_len = max_len or (len(prompt) + n_new)
    dev = model.device
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    last, cache = model.prefill(params, tokens, max_len=max_len)
    out = [int(torch.argmax(last, dim=-1)[0])]
    for _ in range(n_new - 1):
        if out[-1] in stops:
            break
        tok = torch.tensor([[out[-1]]], dtype=torch.int64, device=dev)
        logits, cache = model.decode_step(params, cache, tok)
        out.append(int(torch.argmax(logits[:, -1], dim=-1)[0]))
    return out
