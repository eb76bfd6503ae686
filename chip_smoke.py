#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card, the torch/CUDA versions, and the build of every kernel from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. every kernel against its plain PyTorch version on the card: K2
     (quantize) bitwise on 4M elements with specials and f32 subnormals, K1
     (fused_qmm) and K3 (fma_emu) exactly equal to their plain versions on
     ragged shapes and on tinyllama-1.1b's shapes (both sum each 128-deep
     partial dot with f32 FMAs in k order), with two controls that the check
     must catch (a cascade that skips the accumulator rounding, fp8 without
     operand rounding), and the emulated LM on a small config against the
     same LM on the CPU;
  3. the main path at the full width of tinyllama-1.1b, launch counters set
     to 0 just before: ``BatchedServer`` answers 8 requests (native bf16
     matmuls; every token of every request, and of ``greedy_decode``'s
     stream, must have a logit within 4 * 2**-8 of max |logit| of the top
     one in ``LM.apply`` on the same prefix), the LM's prefill + decode_scan run under four emulating
     policies (every projection and the unembed through K1, 155 launches per
     forward), ``quantize_tensor`` rounds the embedding table (K2) and
     ``emulated_matmul(impl='pallas')`` runs a projection (K3);
  4. each kernel's time at the model's shapes beside its bound, its plain
     version's time and the library call's, and a profile of one decode step.

Every line but the last two is a JSON record or the card's
``nvidia-smi --query-gpu=name,power.limit`` line; the line before the last
is the kernel table ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and peak operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp8": 1979e12, "bf16": 989e12, "fp16": 989e12,
                  "tf32": 495e12, "f32": 67e12}
# the emulated model path: 7 projections per layer + the unembed
ARCH = "tinyllama-1.1b"
SERVE = dict(slots=4, max_len=256, requests=8, prompt_lo=16, prompt_hi=128,
             new_tokens=32)
EMU = dict(batch=4, prompt=128, steps=16)
# a served token is right where LM.apply on the same prefix puts its logit
# within this share of max |logit| of the top one (bf16 keeps 8 significant
# bits: a few roundings at the largest logit), since the server's bucketed prefill and decode steps run
# bf16 products of other shapes than one full-sequence forward
NEAR_TIE = 4 * 2.0 ** -8
LIBRARY_K1 = "torch.matmul(a.float(), b.float()), TF32 off"
NO_LIBRARY_CALL = ("none: no single PyTorch call rounds partial sums on the "
                   "128-deep k-block schedule (cascade style)")


def emit(record):
    print(json.dumps(record), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def mismatches(got, want):
    """Entries where ``got`` and ``want`` differ: equal values (+0 == -0),
    or NaN in both."""
    same = (got == want) | (got.isnan() & want.isnan())
    return int((~same).sum())


def max_abs_err(got, want):
    fin = torch.isfinite(want) & torch.isfinite(got)
    err = (got.double() - want.double()).abs()
    return float(torch.where(fin, err, torch.zeros_like(err)).max())


def peak_for(fmt):
    if fmt.name in ("fp8_e4m3", "fp8_e5m2"):
        return PEAK_OPS_PER_S["fp8"]
    if fmt.name in ("bf16", "fp16"):
        return PEAK_OPS_PER_S[fmt.name]
    return PEAK_OPS_PER_S["tf32" if fmt.man_bits <= 10 else "f32"]


def qmm_bound(m, k, n, a_bytes, b_bytes, fmt):
    """Least time in ms for (m,k) @ (k,n) -> f32, as (bytes time, operations
    time): each operand read once and the output written once at the HBM
    rate; 2mkn operations at the tensor-core rate of a type that holds the
    rounded operands exactly.  The bound is the larger of the two."""
    byts = m * k * a_bytes + k * n * b_bytes + m * n * 4
    return (1e3 * byts / HBM_BYTES_PER_S,
            1e3 * 2.0 * m * k * n / peak_for(fmt))


def bound_of(t_bytes, t_ops):
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, flush, reps=10, warm=2):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 cache flushed before each run."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 1: card, versions, build
# ---------------------------------------------------------------------------
def card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    emit({"phase": "versions", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source,
          "libraries": [_build._lib_path(n).name for n in _build.SOURCES]})
    return smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def model_shapes(cfg):
    """(K, N) of the 7 projections of one layer and of the unembed."""
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d), "unembed": (d, cfg.vocab_size)}


def qmm_operands(gen, m, k, n, dev, unembed, bf16=True):
    """Activations and a weight as the model path hands them to K1: bf16
    rows, and a (K, N) weight, or the unembed's table.T read in place."""
    dt = torch.bfloat16 if bf16 else torch.float32
    a = torch.randn(m, k, generator=gen, device=dev).to(dt)
    if unembed:
        table = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(dt)
        return a, table.T
    return a, (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(dt)


def check_kernels(dev):
    from repro_torch.core import formats as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.fma_emu import fma_emu_matmul
    from repro_torch.kernels.fused import fused_qmm, fused_qmm_ref
    from repro_torch.kernels.quantize_kernel import quantize_nd
    from repro_torch.kernels.ref import fma_emu_matmul_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {"quantize_nd": 0.0, "fused_qmm": 0.0, "fma_emu_matmul": 0.0}

    # K2: bitwise, specials and f32 subnormals included
    n = 1 << 22
    x = torch.randn(n, generator=gen, device=dev) * torch.exp2(
        torch.randint(-150, 129, (n,), generator=gen, device=dev).float())
    x[:10] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                           float("nan"), 1e-40, -3e-39, 240.0, 248.0, 65520.0])
    sub_f32 = [f for f in F.REGISTRY.values()
               if f.exp_bits <= 8 and f.man_bits < 23]
    for fmt in sub_f32:
        got = quantize_nd(x, fmt=fmt)
        want = F.quantize(x, fmt)
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check(bad == 0, f"K2 {fmt.name}: {bad} of {n} elements differ bitwise")
    emit({"phase": "check", "kernel": "quantize_nd", "elements": n,
          "formats": [f.name for f in sub_f32], "bitwise": True})

    # K1 and K3 exactly equal to their plain versions: the kernel and the
    # plain version's per-block product (cuBLAS, TF32 off) both sum each
    # 128-deep partial dot with f32 FMAs in k order, and every rounding and
    # epilogue op is the same, so any difference is a fault
    cfg = get_config(ARCH)
    cases = [((61, 300, 37), False, False), ((2, 61, 300, 37), False, False)]
    for m in (512, 4):
        for name, (k, nn) in model_shapes(cfg).items():
            if name in ("wv", "w_up"):
                continue  # the same (K, N) as wk and w_gate
            cases.append(((m, k, nn), True, name == "unembed"))
    fmts = (F.BF16, F.FP16, F.FP8_E4M3)
    styles = ("fused", "cascade", "cascade_fwd")
    n_checks = 0
    for shape, bf16, unembed in cases:
        batched = len(shape) == 4
        m, k, nn = shape[-3:]
        a, b = qmm_operands(gen, m, k, nn, dev, unembed, bf16)
        if batched:
            a = torch.randn(shape[0], m, k, generator=gen, device=dev)
        for fmt in fmts:
            for style in styles:
                for scaled in (False, True):
                    got = fused_qmm(a, b, fmt=fmt, style=style, scaled=scaled)
                    want = fused_qmm_ref(a, b, fmt=fmt, style=style,
                                         scaled=scaled, bm=128, bn=128)
                    bad = mismatches(got, want)
                    check(bad == 0, f"K1 {shape} {fmt.name} {style} "
                          f"scaled={scaled}: {bad} entries differ (max err "
                          f"{max_abs_err(got, want)})")
                    errs["fused_qmm"] = max(errs["fused_qmm"],
                                            max_abs_err(got, want))
                    n_checks += 1
                if not batched:
                    got = fma_emu_matmul(a, b, fmt=fmt, style=style)
                    want = fma_emu_matmul_ref(a, b, fmt=fmt, style=style)
                    bad = mismatches(got, want)
                    check(bad == 0, f"K3 {shape} {fmt.name} {style}: {bad} "
                          f"entries differ (max err {max_abs_err(got, want)})")
                    errs["fma_emu_matmul"] = max(errs["fma_emu_matmul"],
                                                 max_abs_err(got, want))
                    n_checks += 1
    torch.cuda.synchronize()

    # controls at the main path's prefill shape: the check must catch a
    # cascade that skips the accumulator rounding, and fp8 without operand
    # rounding (the plain version at f32, where rounding is the identity)
    k, nn = model_shapes(cfg)["wq"]
    a, b = qmm_operands(gen, 512, k, nn, dev, False)
    controls = {
        "cascade_without_acc_rounding": mismatches(
            fused_qmm(a, b, fmt=F.BF16, style="cascade"),
            fused_qmm_ref(a, b, fmt=F.BF16, style="cascade_fwd", bm=128,
                          bn=128)),
        "fp8_without_operand_rounding": mismatches(
            fused_qmm(a, b, fmt=F.FP8_E4M3),
            fused_qmm_ref(a, b, fmt=F.FP32, bm=128, bn=128)),
    }
    for name, bad in controls.items():
        check(bad > 0, f"control {name}: the check did not catch it")
    emit({"phase": "check", "kernel": "fused_qmm+fma_emu_matmul",
          "checks": n_checks, "shapes": [c[0] for c in cases],
          "formats": [f.name for f in fmts], "styles": list(styles),
          "tolerance": "exact: every entry equal to the plain version's",
          "max_abs_err": {k: errs[k] for k in ("fused_qmm",
                                               "fma_emu_matmul")},
          "controls_entries_differing": controls,
          "control_entries": 512 * nn})
    return errs


def check_small_lm(dev):
    """The emulated LM on tinyllama's reduced config (f32): K1 on the card
    against the plain version on the CPU, same weights and tokens;
    |delta| <= 4 * 2**-8 * max|logit|, the tolerance the CPU parity tests
    hold the port to against the JAX package."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    cpu_lm, gpu_lm = LM(cfg, device="cpu"), LM(cfg, device=dev)
    params_cpu = cpu_lm.init(seed=SEED)
    params_gpu = tree_to(params_cpu, dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 24)))
    worst = 0.0
    for fmt, style in (("bf16", "fused"), ("bf16", "cascade"),
                       ("bf16", "cascade_fwd"), ("fp8_e4m3", "fused")):
        pol = EmulatedPolicy(fmt, style)
        want, _ = cpu_lm.apply(params_cpu, toks, policy=pol)
        got, _ = gpu_lm.apply(params_gpu, toks.to(dev), policy=pol)
        delta = float((got.cpu() - want).abs().max())
        limit = 4 * 2.0 ** -8 * float(want.abs().max())
        check(delta <= limit, f"small LM {fmt}/{style}: |delta| {delta} > "
              f"{limit}")
        worst = max(worst, delta / limit)
    emit({"phase": "check", "what": "reduced LM under EmulatedPolicy, card "
          "vs CPU plain version", "worst_delta_over_limit": worst})


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width(model, params, rng):
    from repro_torch.serve import BatchedServer, Request, greedy_decode
    s = SERVE
    lens = rng.integers(s["prompt_lo"], s["prompt_hi"] + 1, s["requests"])
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]

    def serve(batch):
        server = BatchedServer(model, params, slots=s["slots"],
                               max_len=s["max_len"])
        reqs = [Request(uid=i, prompt=p, max_new_tokens=s["new_tokens"])
                for i, p in enumerate(batch)]
        for r in reqs:
            server.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        return reqs, done, time.perf_counter() - t0, server

    serve(prompts[:2])  # warm-up: allocator, cuBLAS handles
    reqs, done, wall, server = serve(prompts)
    check(len(done) == len(reqs), "server did not finish every request")
    vocab = model.vocab_padded
    for r in reqs:
        check(r.done and not r.expired and len(r.output) == s["new_tokens"],
              f"request {r.uid}: {len(r.output)} tokens")
        check(all(0 <= t < vocab for t in r.output), "token out of range")
    report = server.run_report()
    # every token of every request, and of greedy_decode's stream for the
    # same prompt, against one full-sequence forward on its own prefix
    worst, exact, agree = 0.0, 0, []
    for r, prompt in zip(reqs, prompts):
        ref = greedy_decode(model, params, prompt, s["new_tokens"],
                            max_len=s["max_len"])
        agree.append(next((i for i, (x, y) in enumerate(zip(r.output, ref))
                           if x != y), len(ref)))
        for what, stream in (("server", r.output), ("greedy_decode", ref)):
            shortfall, limit, hits = stream_vs_apply(model, params, prompt,
                                                     stream)
            over = shortfall / limit
            bad = int((over > 1).sum())
            check(bad == 0, f"request {r.uid}: {bad} {what} tokens fall "
                  f"short of LM.apply's top logit by more than {NEAR_TIE} "
                  f"of max |logit| (worst {float(over.max())} of the limit)")
            worst = max(worst, float(over.max()))
            exact += hits
    n_tok = sum(len(r.output) for r in reqs)
    emit({"phase": "serve", "arch": ARCH, "dtype": model.cfg.dtype,
          "slots": s["slots"], "max_len": s["max_len"],
          "requests": len(reqs), "prompt_lens": [int(n) for n in lens],
          "new_tokens": s["new_tokens"], "wall_s": wall,
          "tokens_per_s": n_tok / wall, "dispatches": report["dispatches"],
          "host_syncs": report["host_syncs"],
          "tokens_checked": 2 * n_tok, "tokens_at_apply_argmax": exact,
          "worst_shortfall_over_limit": worst,
          "server_greedy_agreeing_prefix": agree})


def stream_vs_apply(model, params, prompt, stream):
    """For each token of ``stream`` generated after ``prompt``: how far its
    logit in ``LM.apply`` on the prompt + the stream's earlier tokens falls
    short of that position's top logit, the limit (NEAR_TIE of max |logit|
    there), and how many tokens are the argmax outright."""
    toks = np.concatenate([prompt, np.asarray(stream[:-1], np.int64)])
    logits, _ = model.apply(params, torch.as_tensor(toks[None],
                                                    device=model.device))
    pos = logits[0, len(prompt) - 1:].float()  # (len(stream), vocab)
    chosen = torch.as_tensor(stream, device=pos.device)[:, None]
    shortfall = pos.max(-1).values - pos.gather(-1, chosen)[:, 0]
    limit = NEAR_TIE * pos.abs().max(-1).values
    return shortfall, limit, int((shortfall == 0).sum())


def emulated_full_width(model, params, rng):
    """prefill 4x128 + decode_scan 16 under each emulating policy, twice:
    155 K1 launches per forward, finite logits, identical streams."""
    from repro_torch.kernels.fused import fused_qmm
    from repro_torch.models.numerics import EmulatedPolicy
    cfg, dev = model.cfg, model.device
    per_fwd = 7 * cfg.n_layers + 1
    B, S, steps = EMU["batch"], EMU["prompt"], EMU["steps"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    native_last, _ = model.prefill(params, toks, max_len=S + steps + 1)
    out = {}
    for fmt, style in (("bf16", "fused"), ("bf16", "cascade"),
                       ("bf16", "cascade_fwd"), ("fp8_e4m3", "fused")):
        pol = EmulatedPolicy(fmt, style)
        runs = []
        for _ in range(2):
            c0 = fused_qmm.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = model.prefill(params, toks, max_len=S + steps + 1,
                                        policy=pol)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            check(fused_qmm.launches - c0 == per_fwd,
                  f"{fmt}/{style} prefill: {fused_qmm.launches - c0} K1 "
                  f"launches, expected {per_fwd}")
            check(bool(torch.isfinite(last).all()), "non-finite logits")
            cache = model.cache_at_length(cache, torch.full((B,), S))
            tok = torch.argmax(last, dim=-1)[:, None]
            active = torch.ones(B, dtype=torch.bool, device=dev)
            budget = torch.full((B,), steps, dtype=torch.int64, device=dev)
            c1 = fused_qmm.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, tok, _, _, stream, _ = model.decode_scan(
                params, cache, tok, active, budget, steps, policy=pol)
            torch.cuda.synchronize()
            t_decode = time.perf_counter() - t0
            check(fused_qmm.launches - c1 == steps * per_fwd,
                  f"{fmt}/{style} decode_scan: {fused_qmm.launches - c1} K1 "
                  f"launches, expected {steps * per_fwd}")
            logits, _ = model.decode_step(params, cache, tok, policy=pol)
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            runs.append((last, stream, logits, t_prefill, t_decode))
        (l1, s1, g1, *_), (l2, s2, g2, tp, td) = runs
        check(torch.equal(l1, l2) and torch.equal(s1, s2)
              and torch.equal(g1, g2), f"{fmt}/{style}: runs differ")
        gap = float((l2 - native_last).abs().max() / native_last.abs().max())
        out[f"{fmt}/{style}"] = dict(
            prefill_s=tp, decode_s=td, decode_tokens_per_s=B * steps / td,
            k1_launches_per_forward=per_fwd,
            rel_gap_to_native_bf16=gap,
            top1_agree_native=float((l2.argmax(-1) == native_last.argmax(-1))
                                    .float().mean()))
    emit({"phase": "emulated", "arch": ARCH, "batch": B, "prompt": S,
          "decode_steps": steps, "deterministic": True, "policies": out})


def user_calls_full_width(model, params):
    """K2 and K3 through the numerics entry points a user calls: the
    embedding table rounded to fp8_e4m3 and bf16, and a projection of the
    prompt's embeddings through ``impl='pallas'``, which runs K3 on the
    same device code as K1 and so agrees with ``impl='fused'`` bitwise."""
    from repro_torch.numerics import emulated_matmul, quantize_tensor
    table = params["embed"]
    rounded = {}
    for fmt in ("fp8_e4m3", "bf16"):
        q = quantize_tensor(table, fmt=fmt)
        check(q.shape == table.shape and bool(torch.isfinite(q).all()),
              f"quantize_tensor {fmt}")
        rounded[fmt] = float(((q - table.float()).norm()
                              / table.float().norm()))
    check(rounded["bf16"] == 0.0, "bf16 rounding moved bf16 weights")
    x = table[:EMU["batch"] * EMU["prompt"]]
    w = params["layers"]["wq"][0]
    k3 = emulated_matmul(x, w, fmt="bf16", style="cascade", impl="pallas")
    k1 = emulated_matmul(x, w, fmt="bf16", style="cascade", impl="fused")
    check(torch.equal(k3, k1), "impl='pallas' and impl='fused' differ")
    emit({"phase": "numerics_entry_points", "quantize_rel_err": rounded,
          "pallas_equals_fused": True, "shape": list(x.shape) + [w.shape[1]]})


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def time_kernels(dev, cfg, launches, errs):
    from repro_torch.core import formats as F
    from repro_torch.kernels.fma_emu import fma_emu_matmul
    from repro_torch.kernels.fused import fused_qmm, fused_qmm_ref
    from repro_torch.kernels.quantize_kernel import quantize_nd
    from repro_torch.kernels.ref import fma_emu_matmul_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    shapes = model_shapes(cfg)
    rows = []
    totals = {m: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      bytes_ms=0.0, ops_ms=0.0) for m in (4, 512)}
    for m in (4, 512):
        for name, (k, n) in shapes.items():
            # a forward runs each projection once per layer at M rows; the
            # unembed runs once, at the batch's 4 last rows also in prefill
            reps = cfg.n_layers if name != "unembed" else int(m == 4)
            a, b = qmm_operands(gen, m, k, n, dev, name == "unembed")
            fmt = F.BF16
            ms = time_ms(lambda: fused_qmm(a, b, fmt=fmt), flush)
            plain = time_ms(lambda: fused_qmm_ref(a, b, fmt=fmt, bm=128,
                                                  bn=128), flush, reps=3)
            # bf16 operands are exact in bf16 and the fused style rounds no
            # partial sum, so K1 here is an f32 product of the widened
            # operands: one library call computes it
            library = time_ms(lambda: torch.matmul(a.float(), b.float()),
                              flush)
            t_bytes, t_ops = qmm_bound(m, k, n, 2, 2, fmt)
            bound, by = bound_of(t_bytes, t_ops)
            rows.append(dict(m=m, k=k, n=n, weight=name, per_forward=reps,
                             ms=ms, plain_ms=plain, library_ms=library,
                             bound_ms=bound, bound_by=by))
            t = totals[m]
            t["ms"] += reps * ms
            t["plain_ms"] += reps * plain
            t["library_ms"] += reps * library
            t["bound_ms"] += reps * bound
            t["bytes_ms"] += reps * t_bytes
            t["ops_ms"] += reps * t_ops
    # the styles and fp8 at the largest decode projection
    k, n = shapes["w_gate"]
    a, b = qmm_operands(gen, 4, k, n, dev, False)
    for fmt in (F.BF16, F.FP8_E4M3):
        for style in ("fused", "cascade", "cascade_fwd"):
            for scaled in (False, True):
                ms = time_ms(lambda: fused_qmm(a, b, fmt=fmt, style=style,
                                               scaled=scaled), flush)
                rows.append(dict(m=4, k=k, n=n, weight="w_gate", fmt=fmt.name,
                                 style=style, scaled=scaled, ms=ms))
    emit({"phase": "times", "kernel": "fused_qmm", "fmt": "bf16",
          "style": "fused", "unit": "ms per launch, median of 10, L2 "
          "flushed", "library_call": LIBRARY_K1, "rows": rows,
          "per_forward": totals})

    # K3 at the shape the main path ran it: (512, 2048) @ (2048, 2048)
    k, n = shapes["wq"]
    a, b = qmm_operands(gen, 512, k, n, dev, False)
    k3 = dict(ms=time_ms(lambda: fma_emu_matmul(a, b, fmt=F.BF16,
                                                style="cascade"), flush),
              plain_ms=time_ms(lambda: fma_emu_matmul_ref(
                  a, b, fmt=F.BF16, style="cascade"), flush, reps=3))
    k3["bound_ms"], k3["bound_by"] = bound_of(*qmm_bound(512, k, n, 2, 2,
                                                         F.BF16))

    # K2 on the embedding table's element count, f32 in and out
    numel = cfg.vocab_size * cfg.d_model
    x = torch.randn(numel, generator=gen, device=dev)
    k2 = dict(ms=time_ms(lambda: quantize_nd(x, fmt=F.BF16), flush),
              plain_ms=time_ms(lambda: F.quantize(x, F.BF16), flush, reps=3),
              library_ms=time_ms(lambda: x.to(torch.bfloat16).float(), flush))
    k2["bound_ms"] = 1e3 * numel * 8 / HBM_BYTES_PER_S
    emit({"phase": "times", "kernel": "fma_emu_matmul", "shape":
          [512, k, n], "fmt": "bf16", "style": "cascade", **k3})
    emit({"phase": "times", "kernel": "quantize_nd", "elements": numel,
          "fmt": "bf16", **k2, "library_call": "x.to(torch.bfloat16).float()"})

    dec = totals[4]
    return [
        dict(name="fused_qmm", route="cuda",
             source="src/repro_torch/csrc/qmm.cu",
             replaces="src/repro/kernels/fused.py:140",
             launches=launches["fused_qmm"], max_abs_err=errs["fused_qmm"],
             ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=bound_of(dec["bytes_ms"], dec["ops_ms"])[1],
             library_ms=dec["library_ms"], library_call=LIBRARY_K1,
             work=f"one decode forward of {ARCH}, batch 4: "
                  f"{7 * cfg.n_layers + 1} launches, bf16 fused"),
        dict(name="quantize_nd", route="cuda",
             source="src/repro_torch/csrc/quantize.cu",
             replaces="src/repro/kernels/quantize_kernel.py:25",
             launches=launches["quantize_nd"], max_abs_err=errs["quantize_nd"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by="bytes", library_ms=k2["library_ms"],
             library_call="x.to(torch.bfloat16).float()",
             work=f"{numel} f32 elements to bf16"),
        dict(name="fma_emu_matmul", route="cuda",
             source="src/repro_torch/csrc/qmm.cu",
             replaces="src/repro/kernels/fma_emu.py:72",
             launches=launches["fma_emu_matmul"],
             max_abs_err=errs["fma_emu_matmul"], ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None,
             library_call=NO_LIBRARY_CALL,
             work=f"(512, {k}) @ ({k}, {n}) bf16 cascade"),
    ]


def profile_decode(model, params, rng):
    """Device time by kernel over one decode step at batch 4, native and
    under EmulatedPolicy(bf16, fused); the idle share is 1 - device time /
    host wall time of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.numerics import EmulatedPolicy
    cfg, dev = model.cfg, model.device
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                           device=dev)
    _, cache = model.prefill(params, toks, max_len=80)
    tok = toks[:, -1:]
    result = {}
    for label, pol in (("native", None), ("bf16/fused", EmulatedPolicy(
            "bf16", "fused"))):
        model.decode_step(params, cache, tok, policy=pol)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, policy=pol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = {}  # device-side events only: an op's time is its kernels'
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + e.device_time_total
        total_us = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        result[label] = dict(
            wall_ms=wall * 1e3,
            device_ms=total_us / 1e3 if total_us else "not measured",
            idle_share=1 - total_us / 1e3 / (wall * 1e3) if total_us
            else "not measured",
            top_kernels_ms=[[k[:80], v / 1e3] for k, v in top])
    emit({"phase": "profile", "what": "one decode_step, batch 4, cache 64",
          **result})


# ---------------------------------------------------------------------------
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.fma_emu import fma_emu_matmul
    from repro_torch.kernels.fused import fused_qmm
    from repro_torch.kernels.quantize_kernel import quantize_nd
    from repro_torch.models import LM
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = card_and_build()
    errs = check_kernels(dev)
    check_small_lm(dev)

    cfg = get_config(ARCH)
    model = LM(cfg, device=dev)
    params = model.init(seed=SEED)
    rng = np.random.default_rng(SEED)
    wrappers = {"fused_qmm": fused_qmm, "quantize_nd": quantize_nd,
                "fma_emu_matmul": fma_emu_matmul}
    for fn in wrappers.values():
        fn.launches = 0
    serve_full_width(model, params, rng)
    emulated_full_width(model, params, rng)
    user_calls_full_width(model, params)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    emit({"phase": "launches", "main_path": launches})
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    kernels = time_kernels(dev, cfg, launches, errs)
    profile_decode(model, params, rng)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
