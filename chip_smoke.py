#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card, the torch/CUDA versions, and the build of every kernel from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel), with
     ``ptxas`` registers and spills of the K1/K3, K4 and K5/K6 kernels (a
     spill in any of K4's six or K5/K6's four vector instantiations fails
     the run);
  2. every kernel against its plain PyTorch version on the card: K2
     (quantize) bitwise on 4M elements with specials and f32 subnormals, K1
     (fused_qmm) and K3 (fma_emu) exactly equal to their plain versions on
     ragged shapes and on tinyllama-1.1b's shapes (both sum each 128-deep
     partial dot with f32 FMAs in k order), each case with the schedule
     ``plan_qmm`` picked for it (all three are reached), with four controls
     that the check must catch (a cascade that skips the accumulator
     rounding on each schedule, at M = 512, 4 and 1024; fp8 without operand
     rounding); K1/K3's rounding (the multiplication form) against
     K2's on all 2**32 f32 patterns for every format, zero mismatches; and
     the emulated LM on a small config against the same LM on the CPU;
     K5 (ssm_scan_quantized) and K6 (ssm_scan) bitwise against theirs on
     ragged shapes (S = 1, S under the ring's depth and not a multiple of
     it, partial last d-blocks with B > 1, N = 5, 8 and 16, operands 4
     bytes off a 16-byte boundary or non-contiguous), every operand format,
     an out_fmt, f32 subnormals, +-inf and NaN, with three controls the
     check must catch (a recurrence contracted into fused multiply-adds,
     fp8 without operand rounding, the readout summed as per-lane partials
     added in a tree);
     K4 (fused_flash_attention) bitwise against its plain version on ragged
     GQA shapes (groups of 1, 2, 8), head dims 16, 64 and 128, blocks of 16
     and 128, a window, kv_len < Sk, q_offset > 0 and Sq = 1, under no
     format, bf16, fp8_e4m3 scaled and fp8_e5m2 scaled with a bf16 out_fmt,
     with f32 subnormals, +-0, +-inf and NaN planted, and on bf16 operands,
     with three controls the check must catch (fp8 without rounding p,
     scaled=False where a tile's max lies above 240, the window ignored);
  3. the dense path at the full width of tinyllama-1.1b, launch counters
     set to 0 just before: ``BatchedServer`` answers 8 requests (native bf16
     matmuls; every token of every request, and of ``greedy_decode``'s
     stream, must have a logit within 4 * 2**-8 of max |logit| of the top
     one in ``LM.apply`` on the same prefix), the LM's prefill + decode_scan
     run under four emulating policies (every projection and the unembed
     through K1, 155 launches per forward), ``quantize_tensor`` rounds the
     embedding table (K2) and ``emulated_matmul(impl='pallas')`` runs a
     projection (K3); then each of K1-K3's time at the model's shapes
     (each K1 call with its plan; K1, K3 and the library call also timed
     for device work alone) beside its bound, its plain version's time and
     the library call's, and a profile of one decode step;
  3a. the attention path at tinyllama-1.1b's full width, counters set to 0
     just before: layer 0's q, k and v after RoPE from a 2 x 2048 prefill
     (``_qkv`` on the normed embeddings) through ``policy_flash_attention``
     under two emulating policies (bf16, fp8_e4m3; scaled) and
     ``emulated_flash_attention(fmt=None)``, each output bitwise equal to
     the plain version's on the same operands, and the unrounded K4 on the
     operands' f32 widening within 2**-19 * max |v| of the model's own
     attention (``policy_flash_attention`` with no policy) on the same f32
     operands; then K4's times at that shape beside its bound, its plain
     version's and ``scaled_dot_product_attention``'s;
  3b. benchgen on the card: ``calibrate()`` measures the card's rates,
     then, counters set to 0 just before and read just after,
     ``validate`` of the default specs and two full-width flash specs
     against those rates, in which K1, K2, K4 and K5 must each launch;
     then one run of every spec, whose output must be finite, and every
     row printed beside ``paper_machine()``'s prediction;
  4. the ssm path at the full width and depth of falcon-mamba-7b
     (tinyllama freed first), launch counters set to 0 just before:
     ``BatchedServer`` and ``greedy_decode`` as in 3 in bf16, every token
     held to twice the model's own bf16 noise floor measured in the run
     (``prefill`` against ``LM.apply`` at one position; at least 4 * 2**-8,
     the floor itself under 2**-3, of max |logit|), then the same requests
     on the same weights computed in float32, every token held to
     4 * 2**-8; in both the server's and ``greedy_decode``'s streams agree
     up to the first near tie of ``LM.apply``; layer 0's selective-scan
     operands from a 2 x 256 prefill through K6 (``ssm_scan``, held to the
     layer's own chunked scan on the same operands) and through K5
     (``policy_ssm_scan`` under two emulating policies and none, held to
     the plain version); one prefill under an emulating policy, whose only
     routed matmul is the unembed (one K1 launch); then, outside the
     counted window, K1 on that prefill's own unembed operands (M = 2 and
     4, K = 4096, N = the padded vocabulary, the table's transpose read
     through its strides) exactly equal to its plain version; K5's and
     K6's times at the scan shape beside their bound, and a profile of one
     decode step;
  5. the paper's DSE core at full size on the card (it launches none of
     K1-K6, so it has no launch window): ``calibrate`` (6000 float32 Adam
     steps) within rtol 1e-3 of the same fit on the CPU, its Table I
     residuals within the reference's envelope; ``calibrated_spec_mix``'s
     270-candidate search picking the CPU's mixture and ``fig2c_penalties``
     bitwise the CPU's, its reductions within 0.05 of the paper's 37% / 57%;
     the SP+DP Fig. 3/4 sweep (9,240 points with latency) within rtol 1e-12
     of the numpy backend with the same Pareto sets, and the anchored
     Table I rows exact to 1e-6; ``tune_split`` of both precisions over the
     288-structure enumeration at the ``TUNE_*`` grids picking the numpy
     backend's design and operating point, the fabricated units' Table I
     split, and a same-shape retune hitting the sweep cache; ``bb_study``
     within the paper's body-bias bounds.  Each stage's seconds are printed
     beside the card's name and power limit.

Every line but the last two is a JSON record or the card's
``nvidia-smi --query-gpu=name,power.limit`` line; the line before the last
is the kernel table ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""
import gc
import json
import re
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
SSM_ARCH = "falcon-mamba-7b"
# layer 0's scan operands are taken from a prefill of this shape
SSM_SCAN = dict(batch=2, prompt=256)
# K6 on the layer's operands against the layer's own chunked scan: both
# round every op to f32, but the chunked scan multiplies the decays of a
# 64-token chunk in a doubling tree and reads out with einsum, in another
# order than the kernel's sequential recurrence and left-to-right readout
SCAN_VS_LAYER = 1e-5
SERVE = dict(slots=4, max_len=256, requests=8, prompt_lo=16, prompt_hi=128,
             new_tokens=32)
EMU = dict(batch=4, prompt=128, steps=16)
# a served token is right where LM.apply on the same prefix puts its logit
# within this share of max |logit| of the top one (bf16 keeps 8 significant
# bits: a few roundings at the largest logit), since the server's bucketed prefill and decode steps run
# bf16 products of other shapes than one full-sequence forward
NEAR_TIE = 4 * 2.0 ** -8
# falcon-mamba's 64 bf16 layers put prefill's and LM.apply's logits apart
# by more than NEAR_TIE (two shapes of one computation), so its bf16 tokens
# are held to twice that measured floor; a floor above this share of
# max |logit| is no longer rounding noise and fails the run
FLOOR_CAP = 32 * 2.0 ** -8
# layer 0's attention operands come from a prefill of this shape (the
# model's 2048-token context)
FLASH = dict(batch=2, prompt=2048)
# the unrounded K4 on the operands' f32 widening against the model's own
# attention on the same f32 operands: both compute in f32, but the model's
# attention takes 1024-wide blocks and sums with matrix products, in another
# order than K4's 128-wide blocks and left-to-right sums (1.3e-7 * max |v|
# apart on normal operands at this length); an output row is a convex
# combination of v's rows, so the bound is a share of max |v|
FLASH_VS_MODEL = 2.0 ** -19
# the two full-width flash specs benchgen adds to its default sweep
FLASH_SPECS = ((("flash", "bf16", (2, 32, 2048, 64)), {}),
               (("flash", "fp8_e4m3", (1, 36, 1024, 128)), dict(scaled=True)))
LIBRARY_K1 = "torch.matmul(a.float(), b.float()), TF32 off"
LIBRARY_K4 = ("torch.nn.functional.scaled_dot_product_attention on f32 "
              "(B, H, S, D) views, is_causal=True, enable_gqa=True, TF32 off")
NO_LIBRARY_CALL = ("none: no single PyTorch call rounds partial sums on the "
                   "128-deep k-block schedule (cascade style)")
NO_LIBRARY_SCAN = ("none: no single PyTorch call computes a selective scan "
                   "(a linear recurrence with an N-wide readout)")


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
    return tree_map(lambda t: t.to(dev), tree)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


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


def flash_bound(B, Hq, Sq, Sk, D, byts, fmt, operand_type):
    """K4's least times in ms, as its three terms: the bytes (each input
    read once, the output written once) at the HBM rate, and the two
    products of 2*B*Hq*Sq*Sk*D operations each (masked pairs computed, as
    on the TPU), each at the tensor-core rate of a type that holds its
    operands exactly.  q and k are rounded to ``fmt``, or with no format
    stay in the operands' type; p is rounded to ``fmt``, or with no format
    stays f32, so p@v runs at the f32 rate.  The repo's fp8_e4m3 grid
    (max 240, least subnormal 2**-9) lies inside e4m3fn, so it takes the
    fp8 rate.  The bound is the larger of the bytes and the two products'
    sum."""
    per_dot = 2.0 * B * Hq * Sq * Sk * D
    qk_peak = peak_for(fmt) if fmt else PEAK_OPS_PER_S[operand_type]
    pv_peak = peak_for(fmt) if fmt else PEAK_OPS_PER_S["f32"]
    return {"bytes_ms": 1e3 * byts / HBM_BYTES_PER_S,
            "qk_ms": 1e3 * per_dot / qk_peak,
            "pv_ms": 1e3 * per_dot / pv_peak}


def bound_of(t_bytes, t_ops):
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# a spin of this many cycles (~0.2 ms) on the card ahead of a run timed
# for its device work alone
SPIN_CYCLES = 400_000


def time_ms(fn, flush, reps=10, warm=2, spin=False):
    """Median time of ``fn`` over ``reps`` runs between CUDA events, with
    the L2 cache flushed before each run.  It includes the host's dispatch
    where that outlasts the flush; with ``spin`` a sleep kernel holds the
    card while the host enqueues the run, so only device work is timed."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
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
    # what ptxas -v reported for the K1/K3, K4 and K5/K6 kernels; a K4
    # instantiation or a K5/K6 vector (lanes) instantiation that spills
    # fails the run
    no_spills = {"flash_attn": ("flash_kernel", 6, "K4",
                                "D 16/64/128 x f32/bf16"),
                 "ssm_scan": ("ssm_scan_lanes_kernel", 4, "K5/K6",
                              "N 8/16 x rounding off/on")}
    for name, source in (("qmm", "qmm.cu"), ("flash_attn", "flash_attn.cu"),
                         ("ssm_scan", "ssm_scan.cu")):
        log = _build._lib_path(name).with_suffix(".log")
        check(log.exists() or name not in no_spills,
              f"no ptxas log at {log}: {source}'s spills cannot be checked")
        if log.exists():
            entries = ptxas_entries(log.read_text())
            emit({"phase": "ptxas", "source": source, "kernels": entries})
            if name in no_spills:
                kernel, count, label, what = no_spills[name]
                found = [e for e in entries if e["kernel"] == kernel]
                check(len(found) == count, f"ptxas reported {len(found)} "
                      f"{label} instantiations, expected {count} ({what})")
                for e in found:
                    check(e["spill_store_bytes"] == 0 and
                          e["spill_load_bytes"] == 0,
                          f"{label} {e['template']} spills: {e}")
    return smi


def ptxas_entries(text):
    """Registers and spill-store bytes of each entry function in a
    ``ptxas -v`` log, with the kernel's name and its template arguments
    (integers; f32 or bf16 for types; a back-reference ``S<n>_`` in this
    repo's kernels only ever repeats bf16, the one named type)."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        m = re.search(r"([a-z][a-z_]*_kernel)(?:I(\w*?)EE?v)?", mangled)
        if not m:
            continue
        args = [int(lit) if lit else types.get(t, "bf16") for lit, t in
                re.findall(r"Li(\d+)E|(13__nv_bfloat16|S\d*_|f)",
                           m.group(2) or "")]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        loads = re.search(r"(\d+) bytes spill loads", block)
        out.append({"kernel": m.group(1), "template": args,
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill
                    else None,
                    "spill_load_bytes": int(loads.group(1)) if loads
                    else None})
    return out


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
    from repro_torch.kernels.fused import (fused_qmm, fused_qmm_ref,
                                           plan_qmm, sm_count)
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
    # epilogue op is the same, so any difference is a fault.  The cases
    # reach every schedule of plan_qmm: split_rows at M = 4, split_tile on
    # the ragged shapes and on every projection at M = 512, whole on wq at
    # M = 1024 (a 4 x 256-token prefill)
    cfg = get_config(ARCH)
    cases = [((61, 300, 37), False, False), ((2, 61, 300, 37), False, False)]
    for m in (512, 4):
        for name, (k, nn) in model_shapes(cfg).items():
            if name in ("wv", "w_up"):
                continue  # the same (K, N) as wk and w_gate
            cases.append(((m, k, nn), True, name == "unembed"))
    cases.append(((1024, *model_shapes(cfg)["wq"]), True, False))
    fmts = (F.BF16, F.FP16, F.FP8_E4M3)
    styles = ("fused", "cascade", "cascade_fwd")
    n_checks, plans = 0, []
    sms = sm_count(dev)
    for shape, bf16, unembed in cases:
        batched = len(shape) == 4
        m, k, nn = shape[-3:]
        a, b = qmm_operands(gen, m, k, nn, dev, unembed, bf16)
        if batched:
            a = torch.randn(shape[0], m, k, generator=gen, device=dev)
        plans.append(dict(shape=list(shape), b_strides=list(b.stride()),
                          **vars(plan_qmm(shape[0] if batched else 1, m, nn,
                                          k, sms))))
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

    # controls at the main path's prefill shape (split_tile) and decode
    # shape (split_rows), and at 1024 rows (whole): the check must catch a
    # cascade that skips the accumulator rounding, and fp8 without operand
    # rounding (the plain version at f32, where rounding is the identity)
    k, nn = model_shapes(cfg)["wq"]
    a1024, b = qmm_operands(gen, 1024, k, nn, dev, False)
    a, a4 = a1024[:512].contiguous(), a1024[:4].contiguous()
    controls = {
        "cascade_without_acc_rounding": mismatches(
            fused_qmm(a, b, fmt=F.BF16, style="cascade"),
            fused_qmm_ref(a, b, fmt=F.BF16, style="cascade_fwd", bm=128,
                          bn=128)),
        "fp8_without_operand_rounding": mismatches(
            fused_qmm(a, b, fmt=F.FP8_E4M3),
            fused_qmm_ref(a, b, fmt=F.FP32, bm=128, bn=128)),
        "split_rows_cascade_without_acc_rounding": mismatches(
            fused_qmm(a4, b, fmt=F.BF16, style="cascade"),
            fused_qmm_ref(a4, b, fmt=F.BF16, style="cascade_fwd", bm=128,
                          bn=128)),
        "whole_cascade_without_acc_rounding": mismatches(
            fused_qmm(a1024, b, fmt=F.BF16, style="cascade"),
            fused_qmm_ref(a1024, b, fmt=F.BF16, style="cascade_fwd",
                          bm=128, bn=128)),
    }
    for name, bad in controls.items():
        check(bad > 0, f"control {name}: the check did not catch it")
    emit({"phase": "check", "kernel": "fused_qmm+fma_emu_matmul",
          "checks": n_checks, "shapes": [c[0] for c in cases],
          "plans": plans, "sm_count": sms,
          "schedules": sorted({pl["schedule"] for pl in plans}),
          "formats": [f.name for f in fmts], "styles": list(styles),
          "tolerance": "exact: every entry equal to the plain version's",
          "max_abs_err": {k: errs[k] for k in ("fused_qmm",
                                               "fma_emu_matmul")},
          "controls_entries_differing": controls,
          "control_entries": {"split_tile": 512 * nn, "whole": 1024 * nn,
                              "split_rows": 4 * nn}})
    check(len({pl["schedule"] for pl in plans}) == 3,
          "the K1 checks did not reach every schedule")
    return errs


def check_rounding(dev):
    """The rounding K1/K3 run, quantize_rne_mul, against K2's
    quantize_rne on all 2**32 f32 bit patterns, on the card: zero bitwise
    mismatches for every format; and for the formats that hold every bf16
    value (where K1 skips rounding an unscaled bf16 operand) zero finite
    bf16 patterns moved by the rounding."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import rounding_mismatches
    rows = {}
    t0 = time.perf_counter()
    for fmt in F.REGISTRY.values():
        if fmt.exp_bits > 8 or fmt.man_bits >= 23:
            continue
        mul_vs_div, bf16_moved = rounding_mismatches(fmt, dev)
        holds_bf16 = fmt.exp_bits == 8 and fmt.man_bits >= 7
        check(mul_vs_div == 0, f"{fmt.name}: quantize_rne_mul differs from "
              f"quantize_rne on {mul_vs_div} f32 patterns")
        check((bf16_moved == 0) == holds_bf16, f"{fmt.name}: rounding moves "
              f"{bf16_moved} finite bf16 values (holds bf16: {holds_bf16})")
        rows[fmt.name] = dict(mul_vs_div_mismatches=mul_vs_div,
                              bf16_values_moved=bf16_moved,
                              holds_bf16=holds_bf16)
    emit({"phase": "check", "what": "quantize_rne_mul vs quantize_rne, all "
          "2**32 f32 patterns", "formats": rows,
          "seconds": time.perf_counter() - t0})


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


def scan_operands(gen, shape, dev, specials=True):
    """a in (0.5, 1), b and c normal; with ``specials``, f32 subnormals,
    signed zeros, +-inf and NaN planted among them."""
    B, S, D, N = shape
    a = torch.rand(shape, generator=gen, device=dev) * 0.5 + 0.5
    b = torch.randn(shape, generator=gen, device=dev)
    c = torch.randn((B, S, N), generator=gen, device=dev)
    if specials:
        vals = torch.tensor([1e-40, -3e-39, 0.0, -0.0, float("inf"),
                             -float("inf"), float("nan"), 240.0, 250.0],
                            device=dev)
        for t in (a, b, c):
            flat = t.view(-1)
            idx = torch.randint(0, flat.numel(), (64,), generator=gen,
                                device=dev)
            flat[idx] = vals[torch.arange(64, device=dev) % len(vals)]
    return a, b, c


def scan_layout(t, layout):
    """The same values as ``t`` 4 bytes off a 16-byte boundary
    (``offset4``), as a non-contiguous view (``strided``), or as they are;
    the wrappers realign the first two."""
    if layout == "offset4":
        flat = torch.empty(t.numel() + 1, device=t.device)[1:]
        return flat.view(t.shape).copy_(t)
    if layout == "strided":
        return t.transpose(0, -1).contiguous().transpose(0, -1)
    return t


def tree_readout(prod):
    """The readout summed as per-lane partials added in a tree: each
    group of four products summed from its first, the groups' sums then
    added pairwise (a control: the kernel's order is one chain)."""
    parts = [((prod[..., n] + prod[..., n + 1]) + prod[..., n + 2])
             + prod[..., n + 3] for n in range(0, prod.shape[-1], 4)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def check_scan_kernels(dev):
    """K6 and K5 bitwise against their plain versions, and three controls
    the check must catch."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import (ssm_scan_quantized,
                                           ssm_scan_quantized_ref)
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    # (shape, chunk, bd, layout): falcon-mamba's N = 16, the reduced
    # configs' N = 8, N = 5 (the scalar kernel), S = 1, S under the ring's
    # depth of 8 and not a multiple of it, S across the 64-step chunks of
    # rounded c, partial last d-blocks with B > 1 (blocks of 8 rows at
    # D = 201, 32 at D = 4100, 16 at N = 8 and D = 1000); operands 4 bytes
    # off a 16-byte boundary and non-contiguous
    cases = [((2, 128, 8192 // 16, 16), 64, 256, "contiguous"),
             ((3, 64, 200, 16), 32, 200, "contiguous"),
             ((2, 48, 136, 8), 16, 136, "contiguous"),
             ((1, 32, 40, 5), 32, 40, "contiguous"),
             ((2, 1, 256, 16), 1, 256, "contiguous"),
             ((3, 13, 201, 16), 13, 201, "offset4"),
             ((2, 70, 4100, 16), 70, 4100, "strided"),
             ((3, 21, 1000, 8), 21, 1000, "offset4")]
    fmts = (None, F.BF16, F.FP16, F.FP8_E4M3)
    errs = {"ssm_scan": 0.0, "ssm_scan_quantized": 0.0}
    n_checks = 0
    for shape, chunk, bd, layout in cases:
        a, b, c = scan_operands(gen, shape, dev)
        want = ssm_scan_ref(a, b, c)
        a, b, c = (scan_layout(t, layout) for t in (a, b, c))
        y6, h6 = ssm_scan(a, b, c, chunk=chunk, bd=bd)
        for got, ref in zip((y6, h6), want):
            bad = mismatches(got, ref)
            check(bad == 0, f"K6 {shape}: {bad} entries differ")
            errs["ssm_scan"] = max(errs["ssm_scan"], max_abs_err(got, ref))
        n_checks += 1
        for fmt in fmts:
            for out_fmt in (None, F.BF16):
                got = ssm_scan_quantized(a, b, c, fmt=fmt, out_fmt=out_fmt,
                                         chunk=chunk, bd=bd)
                want = ssm_scan_quantized_ref(a, b, c, fmt=fmt,
                                              out_fmt=out_fmt)
                for g, w in zip(got, want):
                    bad = mismatches(g, w)
                    check(bad == 0, f"K5 {shape} fmt={fmt} out={out_fmt}: "
                          f"{bad} entries differ")
                    errs["ssm_scan_quantized"] = max(
                        errs["ssm_scan_quantized"], max_abs_err(g, w))
                if fmt is None and out_fmt is None:
                    check(mismatches(got[0], y6) == 0
                          and mismatches(got[1], h6) == 0,
                          f"K5 with fmt=None differs from K6 at {shape}")
                n_checks += 1
        # the shape validation of both wrappers, on card tensors
        for call in (lambda: ssm_scan(a, b, c, chunk=chunk + 1),
                     lambda: ssm_scan_quantized(a, b, c, fmt=None,
                                                chunk=chunk, bd=7)):
            try:
                call()
                fail(f"a bad chunk/bd at {shape} was not refused")
            except ValueError:
                pass
    torch.cuda.synchronize()

    # controls at falcon-mamba's N without specials: the recurrence as fused
    # multiply-adds (float64 product and sum, rounded once), fp8 without
    # operand rounding (the plain version at fmt=None), and the readout
    # summed as per-lane partials added in a tree
    a, b, c = scan_operands(gen, (2, 64, 1024, 16), dev, specials=False)
    y_k5, _ = ssm_scan_quantized(a, b, c, fmt=F.FP8_E4M3, chunk=64)
    y_k6, _ = ssm_scan(a, b, c)
    h = h_tree = torch.zeros_like(a[:, 0])
    ys, ys_tree = [], []
    for t in range(a.shape[1]):
        h = (a[:, t].double() * h.double() + b[:, t].double()).float()
        prod = h * c[:, t, None, :]
        y = prod[..., 0]
        for n in range(1, prod.shape[-1]):
            y = y + prod[..., n]
        ys.append(y)
        h_tree = a[:, t] * h_tree + b[:, t]
        ys_tree.append(tree_readout(h_tree * c[:, t, None, :]))
    controls = {
        "recurrence_as_fma": mismatches(y_k6, torch.stack(ys, 1)),
        "readout_as_lane_tree": mismatches(y_k6, torch.stack(ys_tree, 1)),
        "fp8_without_operand_rounding": mismatches(
            y_k5, ssm_scan_quantized_ref(a, b, c, fmt=None)[0]),
    }
    for name, bad in controls.items():
        check(bad > 0, f"control {name}: the check did not catch it")
    emit({"phase": "check", "kernel": "ssm_scan+ssm_scan_quantized",
          "checks": n_checks, "shapes": [list(c[0]) for c in cases],
          "layouts": [c[3] for c in cases],
          "formats": [f.name if f else None for f in fmts],
          "out_formats": [None, "bf16"],
          "tolerance": "bitwise: every entry equal to the plain version's "
                       "(NaN equal to NaN)",
          "max_abs_err": errs, "controls_entries_differing": controls,
          "control_entries": int(y_k6.numel())})
    return errs


def flash_operands(gen, q_shape, kv_shape, dev, specials=True):
    """q, k, v normal; with ``specials``, f32 subnormals and signed zeros
    planted in many places and one each of NaN, +inf and -inf in q, k and
    v."""
    q = torch.randn(q_shape, generator=gen, device=dev)
    k = torch.randn(kv_shape, generator=gen, device=dev)
    v = torch.randn(kv_shape, generator=gen, device=dev)
    if specials:
        quiet = torch.tensor([1e-40, -3e-39, 0.0, -0.0], device=dev)
        loud = torch.tensor([float("nan"), float("inf"), -float("inf")],
                            device=dev)
        for t in (q, k, v):
            flat = t.view(-1)
            idx = torch.randint(0, flat.numel(), (32,), generator=gen,
                                device=dev)
            flat[idx] = quiet[torch.arange(32, device=dev) % 4]
            idx = torch.randint(0, flat.numel(), (3,), generator=gen,
                                device=dev)
            flat[idx] = loud
    return q, k, v


def check_flash_kernels(dev):
    """K4 bitwise against its plain version, and three controls the check
    must catch."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import (fused_flash_attention,
                                           fused_flash_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    # (q (B, Sq, Hq), kv (B, Sk, Hkv), keywords): GQA groups of 2, 8, 1 and
    # 4, ragged lengths, q_offset with Sq != Sk, a window with kv_len < Sk,
    # a decode shape, and lengths above 128 so that unequal blocks stay
    # unequal
    cases = [((2, 45, 4), (2, 45, 2), {}),
             ((1, 37, 8), (1, 53, 1), dict(q_offset=16)),
             ((2, 50, 2), (2, 50, 2), dict(window=8, kv_len=41)),
             ((3, 1, 4), (3, 70, 2), dict(q_offset=69)),
             ((2, 200, 4), (2, 200, 2), {}),
             ((1, 150, 8), (1, 290, 2), dict(q_offset=140, kv_len=281))]
    # (block_q, block_k): the register tile's edges at 16, whole tiles, and
    # unequal blocks
    blocks = ((16, 16), (128, 128), (128, 64), (64, 128))
    fmts = ((None, False, None), (F.BF16, True, None),
            (F.FP8_E4M3, True, None), (F.FP8_E5M2, True, F.BF16))
    err, n_checks = 0.0, 0
    for D in (16, 64, 128):
        for bq, bk in blocks:
            for (B, Sq, Hq), (_, Sk, Hkv), kw in cases:
                q, k, v = flash_operands(gen, (B, Sq, Hq, D),
                                         (B, Sk, Hkv, D), dev)
                for fmt, scaled, out_fmt in fmts:
                    args = dict(fmt=fmt, scaled=scaled, out_fmt=out_fmt,
                                block_q=bq, block_k=bk, **kw)
                    got = fused_flash_attention(q, k, v, **args)
                    want = fused_flash_ref(q, k, v, **args)
                    bad = mismatches(got, want)
                    check(bad == 0, f"K4 q {(B, Sq, Hq, D)} kv "
                          f"{(B, Sk, Hkv, D)} {kw} blocks {(bq, bk)} fmt="
                          f"{getattr(fmt, 'name', None)}: {bad} entries "
                          f"differ (max err {max_abs_err(got, want)})")
                    err = max(err, max_abs_err(got, want))
                    n_checks += 1
    # bf16 operands at tinyllama's heads (32 / 4, D = 64), read as they are
    q, k, v = (t.to(torch.bfloat16) for t in flash_operands(
        gen, (2, 300, 32, 64), (2, 300, 4, 64), dev, specials=False))
    for fmt in (None, F.BF16, F.FP8_E4M3):
        got = fused_flash_attention(q, k, v, fmt=fmt)
        want = fused_flash_ref(q, k, v, fmt=fmt)
        check(got.dtype == torch.bfloat16 and mismatches(got, want) == 0,
              f"K4 on bf16 operands, fmt={getattr(fmt, 'name', None)}: "
              f"{mismatches(got, want)} entries differ")
        n_checks += 1
    torch.cuda.synchronize()

    # controls: fp8 with q, k and v rounded but p not (the unscaled rounding
    # is elementwise, so that is the unrounded schedule on rounded
    # operands); scaled=False where q's tile max lies above 240, without a
    # causal mask (a masked score far above the row max gives inf * 0 = NaN
    # in both versions, by the reference's rule); the window ignored
    q, k, v = flash_operands(gen, (2, 256, 8, 64), (2, 256, 2, 64), dev,
                             specials=False)
    e4 = F.FP8_E4M3
    big = q * 300.0
    scaled_big = fused_flash_attention(big, k, v, fmt=e4, causal=False)
    check(bool(torch.isfinite(scaled_big).all()),
          "K4 scaled fp8 on a q tile above 240 is not finite")
    controls = {
        "fp8_without_rounding_p": mismatches(
            fused_flash_attention(q, k, v, fmt=e4, scaled=False),
            fused_flash_ref(F.quantize(q, e4), F.quantize(k, e4),
                            F.quantize(v, e4), fmt=None)),
        "unscaled_above_240": mismatches(
            scaled_big, fused_flash_ref(big, k, v, fmt=e4, scaled=False,
                                        causal=False)),
        "window_ignored": mismatches(
            fused_flash_attention(q, k, v, fmt=None, window=32),
            fused_flash_ref(q, k, v, fmt=None)),
    }
    for name, bad in controls.items():
        check(bad > 0, f"control {name}: the check did not catch it")
    emit({"phase": "check", "kernel": "fused_flash_attention",
          "checks": n_checks, "head_dims": [16, 64, 128],
          "blocks": [list(b) for b in blocks],
          "cases": [[list(c[0]), list(c[1]), c[2]] for c in cases],
          "formats": ["none", "bf16 scaled", "fp8_e4m3 scaled",
                      "fp8_e5m2 scaled, out bf16"],
          "tolerance": "bitwise: every entry equal to the plain version's "
                       "(NaN equal to NaN)",
          "max_abs_err": err, "controls_entries_differing": controls,
          "control_entries": int(q.numel())})
    return {"fused_flash_attention": err}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width(model, params, rng, noise_floor=False):
    """``BatchedServer`` answers SERVE's requests (after a warm-up), then
    every token of every request, and of ``greedy_decode``'s stream for the
    same prompt, is held to one ``LM.apply`` over its whole stream: its
    logit within a share of max |logit| of the top one.  The share is
    NEAR_TIE, or with ``noise_floor`` the larger of NEAR_TIE and twice the
    model's own rounding noise measured in this run: how far ``prefill``'s
    last logits lie from ``LM.apply``'s at the same position (two shapes of
    the same computation), itself held under FLOOR_CAP.  The server's and
    ``greedy_decode``'s streams must also agree up to the first position
    where ``LM.apply``'s top two logits lie within NEAR_TIE of max |logit|.
    """
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
    held, agree, floor = [], [], 0.0
    for r, prompt in zip(reqs, prompts):
        ref = greedy_decode(model, params, prompt, s["new_tokens"],
                            max_len=s["max_len"])
        split = next((i for i, (x, y) in enumerate(zip(r.output, ref))
                      if x != y), len(ref))
        agree.append(split)
        for what, stream in (("server", r.output), ("greedy_decode", ref)):
            shortfall, scale, margin, first = stream_vs_apply(
                model, params, prompt, stream)
            held.append((r.uid, what, shortfall, scale))
            if split < len(ref):  # the prefixes agree up to here
                check(float(margin[split]) <= NEAR_TIE * float(scale[split]),
                      f"request {r.uid}: the server and greedy_decode part "
                      f"at token {split}, where LM.apply's top two logits "
                      f"are {float(margin[split] / scale[split])} of max "
                      f"|logit| apart (a near tie is within {NEAR_TIE})")
        last, _ = model.prefill(params, torch.as_tensor(
            prompt[None], device=model.device))
        floor = max(floor, float((last[0].float() - first).abs().max()
                                 / first.abs().max()))
    share = NEAR_TIE
    if noise_floor:
        check(floor <= FLOOR_CAP, f"prefill and LM.apply differ by {floor} "
              f"of max |logit|, more than rounding noise ({FLOOR_CAP})")
        share = max(NEAR_TIE, 2 * floor)
    worst, exact = 0.0, 0
    for uid, what, shortfall, scale in held:
        over = shortfall / (share * scale)
        bad = int((over > 1).sum())
        check(bad == 0, f"request {uid}: {bad} {what} tokens fall short of "
              f"LM.apply's top logit by more than {share} of max |logit| "
              f"(worst {float(over.max())} of the limit)")
        worst = max(worst, float(over.max()))
        exact += int((shortfall == 0).sum())
    n_tok = sum(len(r.output) for r in reqs)
    rec = {"phase": "serve", "arch": model.cfg.name,
           "dtype": model.cfg.dtype, "slots": s["slots"],
           "max_len": s["max_len"], "requests": len(reqs),
           "prompt_lens": [int(n) for n in lens],
           "new_tokens": s["new_tokens"], "wall_s": wall,
           "tokens_per_s": n_tok / wall, "dispatches": report["dispatches"],
           "host_syncs": report["host_syncs"],
           "tokens_checked": 2 * n_tok, "tokens_at_apply_argmax": exact,
           "prefill_vs_apply_rel_logit_gap": floor,
           "limit_share_of_max_logit": share,
           "limit_from_noise_floor": noise_floor,
           "worst_shortfall_over_limit": worst,
           "tokens_within_near_tie": sum(
               int((sh <= NEAR_TIE * sc).sum()) for _, _, sh, sc in held),
           "server_greedy_agreeing_prefix": agree}
    emit(rec)
    return rec


def stream_vs_apply(model, params, prompt, stream):
    """For each token of ``stream`` generated after ``prompt``, from
    ``LM.apply`` on the prompt + the stream's earlier tokens: how far its
    logit falls short of that position's top logit, max |logit| there, the
    gap between the top two logits there, and the logits at the prompt's
    last position."""
    toks = np.concatenate([prompt, np.asarray(stream[:-1], np.int64)])
    logits, _ = model.apply(params, torch.as_tensor(toks[None],
                                                    device=model.device))
    pos = logits[0, len(prompt) - 1:].float()  # (len(stream), vocab)
    chosen = torch.as_tensor(stream, device=pos.device)[:, None]
    top2 = pos.topk(2, dim=-1).values
    shortfall = top2[:, 0] - pos.gather(-1, chosen)[:, 0]
    return (shortfall, pos.abs().max(-1).values, top2[:, 0] - top2[:, 1],
            pos[0])


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


def serve_f32(cfg, params, dev):
    """The served-token check of ``serve_full_width`` on the same model and
    requests computed in float32 (the bf16 weights widened, exactly), held
    to NEAR_TIE itself.  In bf16 the model's own rounding noise at this
    depth is above NEAR_TIE (the bf16 run measures it), so here the
    serving, state and chunking logic is all the tight limit can see."""
    import dataclasses
    from repro_torch.models import LM
    model = LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
    wide = tree_map(lambda t: t.float(), params)
    rec = serve_full_width(model, wide, np.random.default_rng(SEED + 1))
    del model, wide
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def attention_layer0_operands(model, params, rng):
    """Layer 0's q, k and v after RoPE for a prefill of FLASH's shape,
    through the functions the dense block runs: the block's norm of the
    embeddings, then ``_qkv`` (no policy: the model's native path)."""
    from repro_torch.models.layers import embed_apply, rmsnorm
    from repro_torch.models.model import _layer, _qkv
    cfg, dev = model.cfg, model.device
    B, S = FLASH["batch"], FLASH["prompt"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    lp = _layer(params["layers"], 0)
    h = rmsnorm(lp["ln1"], embed_apply(params["embed"], toks))
    positions = torch.arange(S, device=dev)[None, :]
    return _qkv(lp, h, cfg, positions, None)


def attention_full_width(model, params, rng):
    """K4 on layer 0's full-width attention operands through the entry
    points a user calls: ``policy_flash_attention`` under bf16 and fp8_e4m3
    (scaled, the default) and ``emulated_flash_attention(fmt=None)``, each
    bitwise equal to the plain version; the unrounded K4 on the operands'
    f32 widening against the model's own attention on the same operands."""
    from repro_torch.kernels.fused import fused_flash_ref
    from repro_torch.models.numerics import (EmulatedPolicy,
                                             policy_flash_attention)
    from repro_torch.numerics import emulated_flash_attention, get_format
    q, k, v = attention_layer0_operands(model, params, rng)
    check(bool(torch.isfinite(q).all() and torch.isfinite(k).all()
               and torch.isfinite(v).all()), "non-finite attention operands")
    outs = {}
    for label, pol in (("bf16", EmulatedPolicy("bf16", "fused")),
                       ("fp8_e4m3", EmulatedPolicy("fp8_e4m3", "fused"))):
        outs[label] = (policy_flash_attention(q, k, v, pol),
                       get_format(pol.fmt))
    outs["none"] = (emulated_flash_attention(q, k, v, fmt=None,
                                             device=q.device), None)
    exact = {}
    for label, (out, fmt) in outs.items():
        check(out.shape == q.shape and out.dtype == q.dtype
              and bool(torch.isfinite(out).all()),
              f"K4 {label}: output {tuple(out.shape)} {out.dtype}, finite "
              f"{bool(torch.isfinite(out).all())}")
        bad = mismatches(out, fused_flash_ref(q, k, v, fmt=fmt))
        check(bad == 0, f"K4 {label}: {bad} entries differ from the plain "
              "version at full width")
        exact[label] = True
    # the unrounded K4 against the model's own attention (the inert policy
    # path) on the operands' f32 widening, which is exact
    q32, k32, v32 = q.float(), k.float(), v.float()
    k4 = emulated_flash_attention(q32, k32, v32, fmt=None, device=q.device)
    model_attn = policy_flash_attention(q32, k32, v32, None)
    vmax = float(v32.abs().max())
    gap = float((k4 - model_attn).abs().max())
    check(gap <= FLASH_VS_MODEL * vmax, f"unrounded K4 vs the model's "
          f"attention: {gap} > {FLASH_VS_MODEL} * max|v| = "
          f"{FLASH_VS_MODEL * vmax}")
    check(torch.equal(k4.to(q.dtype), outs["none"][0]),
          "K4 on the f32 widening, cast back, differs from K4 on bf16")
    base = outs["none"][0].float()
    scale = float(base.abs().max())
    emit({"phase": "attention_full_width", "arch": model.cfg.name,
          "layer": 0, "q": list(q.shape), "kv": list(k.shape),
          "dtype": str(q.dtype).replace("torch.", ""),
          "exact_vs_plain": exact,
          "unrounded_vs_model_attention": {
              "max_abs": gap, "share_of_max_v": gap / vmax,
              "limit_share_of_max_v": FLASH_VS_MODEL},
          "rel_gap_to_unrounded": {
              label: float((outs[label][0].float() - base).abs().max())
              / scale for label in ("bf16", "fp8_e4m3")},
          "max_abs_out": scale})
    return q, k, v


def time_flash_kernel(dev, operands, errs):
    """K4 at the full-width shape: median of 10 launches with the L2
    flushed under no format, bf16 and fp8_e4m3 (scaled), beside the bound,
    the plain version's time (3 runs) and, with no format, the library
    call's."""
    import torch.nn.functional as TF
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import (fused_flash_attention,
                                           fused_flash_ref)
    q, k, v = operands
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    ms, plain = {}, {}
    for fmt in (None, F.BF16, F.FP8_E4M3):
        name = fmt.name if fmt else "none"
        ms[name] = time_ms(lambda: fused_flash_attention(q, k, v, fmt=fmt),
                           flush)
        plain[name] = time_ms(lambda: fused_flash_ref(q, k, v, fmt=fmt),
                              flush, reps=3, warm=1)
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))
    library = time_ms(lambda: TF.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    esize = q.element_size()
    byts = esize * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    operand_type = "bf16" if q.dtype == torch.bfloat16 else "f32"
    terms = {name: flash_bound(B, Hq, S, S, D, byts, fmt, operand_type)
             for name, fmt in zip(ms, (None, F.BF16, F.FP8_E4M3))}
    bounds = {n: bound_of(t["bytes_ms"], t["qk_ms"] + t["pv_ms"])
              for n, t in terms.items()}
    emit({"phase": "times", "kernel": "fused_flash_attention",
          "shape": {"q": list(q.shape), "kv": list(k.shape)},
          "dtype": str(q.dtype).replace("torch.", ""),
          "unit": "ms per launch, median of 10, L2 flushed; plain median of "
                  "3", "ms_by_fmt": ms, "plain_ms_by_fmt": plain,
          "bound_ms_by_fmt": {n: b[0] for n, b in bounds.items()},
          "bound_by": {n: b[1] for n, b in bounds.items()},
          "bound_terms_ms_by_fmt": terms, "bytes": byts,
          "operations": 4.0 * B * Hq * S * S * D,
          "library_ms_fmt_none": library,
          "library_call": LIBRARY_K4})
    return dict(name="fused_flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attn.cu",
                replaces="src/repro/kernels/fused.py:343",
                max_abs_err=errs["fused_flash_attention"], ms=ms["none"],
                plain_ms=plain["none"], bound_ms=bounds["none"][0],
                bound_by=bounds["none"][1], library_ms=library,
                library_call=LIBRARY_K4, ms_by_fmt=ms,
                plain_ms_by_fmt=plain,
                bound_ms_by_fmt={n: b[0] for n, b in bounds.items()},
                bound_terms_ms_by_fmt=terms,
                work=f"layer 0 of {ARCH}: q {list(q.shape)}, k and v "
                     f"{list(k.shape)} bf16, causal, fmt none (the row's "
                     "times; ms_by_fmt has bf16 and fp8_e4m3)")


def benchgen_specs():
    from repro_torch.benchgen import KernelSpec, default_specs
    return default_specs() + [KernelSpec(*a, **kw) for a, kw in FLASH_SPECS]


def benchgen_report(dev, specs, machine, out):
    """After the counted ``validate`` run: one run of every spec's kernel,
    whose output must be finite, and every row printed beside the
    prediction at ``paper_machine()``'s data-sheet rates."""
    from repro_torch.benchgen import (build, make_inputs, paper_machine,
                                      predict)
    for spec in specs:
        res = build(spec, device=dev)(*make_inputs(spec, device=dev))
        check(bool(torch.isfinite(res).all()),
              f"benchgen {spec.name}: non-finite output")
    emit({"phase": "benchgen", "paper_machine": paper_machine().as_dict(),
          "calibrated": machine.as_dict(), "tol": out["tol"],
          "rows": [{"spec": r["spec"]["name"], "t_pred_s": r["t_pred_s"],
                    "t_meas_s": r["t_meas_s"], "ratio": r["ratio"],
                    "bottleneck": r["bottleneck"],
                    "within_tol": r["within_tol"],
                    "t_pred_paper_machine_s": predict(
                        spec, paper_machine()).step_time_bound_s}
                   for spec, r in zip(specs, out["rows"])],
          "summary": out["summary"], "outputs_finite": True})


def ssm_layer0_operands(model, params, rng):
    """Layer 0's selective-scan operands for a prefill of SSM_SCAN's shape,
    through the functions ``mamba1_apply`` runs: the block's norm, the
    in_proj, the causal conv and silu, then ``_mamba1_core``.  Returns
    (tokens, a, bx, C)."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_apply, rmsnorm
    from repro_torch.models.model import _layer
    cfg, dev = model.cfg, model.device
    B, S = SSM_SCAN["batch"], SSM_SCAN["prompt"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    lp = _layer(params["layers"], 0)
    p = lp["mamba"]
    d_in = p["out_proj"].shape[0]
    x = rmsnorm(lp["ln"], embed_apply(params["embed"], toks))
    x_in, _ = torch.split(x @ p["in_proj"], [d_in, d_in], dim=-1)
    xc, _ = ssm.causal_conv1d(x_in, p["conv_w"], p["conv_b"])
    xc = ssm._silu_in(xc)
    a, bx, cm = ssm._mamba1_core(p, xc, cfg.ssm_state)
    return toks, a, bx, cm


def ssm_kernels_full_width(model, params, rng):
    """K6 and K5 on layer 0's full-width operands, through the entry points
    a user calls, and one prefill under an emulating policy (K1 once)."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import fused_qmm, ssm_scan_quantized_ref
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    from repro_torch.models import ssm
    from repro_torch.models.numerics import EmulatedPolicy, policy_ssm_scan
    cfg = model.cfg
    toks, a, bx, cm = ssm_layer0_operands(model, params, rng)
    B, S, D, N = a.shape
    check(bool(torch.isfinite(a).all() and torch.isfinite(bx).all()
               and torch.isfinite(cm).all()), "non-finite scan operands")
    h0 = torch.zeros((B, D, N), dtype=torch.float32, device=a.device)

    # K6 against the layer's own chunked scan on the same operands
    y6, h6 = ssm_scan(a, bx, cm)

    def readout(parts):
        a_k, b_k, c_k = parts
        return a_k, b_k, (lambda h_seq:
                          torch.einsum("bsdn,bsn->bsd", h_seq, c_k))

    y_layer, h_layer = ssm._chunked_ssm((a, bx, cm), h0, readout,
                                        cfg.ssm_scan_chunk)
    rel_y = float((y6 - y_layer).abs().max() / y_layer.abs().max())
    rel_h = float((h6 - h_layer).abs().max() / h_layer.abs().max())
    check(rel_y <= SCAN_VS_LAYER and rel_h <= SCAN_VS_LAYER,
          f"K6 vs the layer's chunked scan: y {rel_y}, h {rel_h} of max| |, "
          f"limit {SCAN_VS_LAYER}")
    y6r, h6r = ssm_scan_ref(a, bx, cm)
    check(mismatches(y6, y6r) == 0 and mismatches(h6, h6r) == 0,
          "K6 differs from its plain version at full width")

    # K5 through the policy entry point
    k5 = {}
    for label, pol in (("none", None),
                       ("bf16/fused", EmulatedPolicy("bf16", "fused")),
                       ("fp8_e4m3/fused", EmulatedPolicy("fp8_e4m3",
                                                         "fused"))):
        y5, h5 = policy_ssm_scan(a, bx, cm, pol)
        fmt = F.REGISTRY[pol.fmt] if pol else None
        w_y, w_h = ssm_scan_quantized_ref(a, bx, cm, fmt=fmt)
        bad = mismatches(y5, w_y) + mismatches(h5, w_h)
        check(bad == 0, f"K5 {label}: {bad} entries differ at full width")
        if pol is None:
            check(torch.equal(y5, y6) and torch.equal(h5, h6),
                  "K5 with no policy differs from K6")
        k5[label] = dict(
            exact=True,
            y_rel_gap_to_unrounded=float((y5 - y6).abs().max()
                                         / y6.abs().max()))

    # a prefill under an emulating policy: the unembed is its one K1 launch
    c0 = fused_qmm.launches
    pol = EmulatedPolicy("bf16", "fused")
    last, _ = model.prefill(params, toks, policy=pol)
    k1 = fused_qmm.launches - c0
    check(k1 == 1, f"emulated {cfg.name} prefill: {k1} K1 launches, "
          "expected 1 (the unembed)")
    native, _ = model.prefill(params, toks)
    check(bool(torch.isfinite(last).all()), "non-finite emulated logits")
    emit({"phase": "ssm_kernels_full_width", "arch": cfg.name,
          "layer": 0, "shape": [B, S, D, N],
          "k6_vs_layer_chunked_scan": {"y_rel": rel_y, "h_rel": rel_h,
                                       "limit": SCAN_VS_LAYER},
          "k6_equals_plain": True, "k5_by_policy": k5,
          "emulated_prefill_k1_launches": k1,
          "emulated_prefill_rel_gap_to_native": float(
              (last - native).abs().max() / native.abs().max())})
    return (a, bx, cm), toks, last


def check_ssm_unembed(model, params, toks, last):
    """K1 at the shapes the ssm path gives it, against its plain version:
    the unembed of falcon-mamba's final normed hidden states from the
    2 x 256 prefill (M = 2, its last positions; M = 4, the last two of
    each, as a 4-slot decode step gives it), K = d_model, N = the padded
    vocabulary, b = the embedding table's transpose read through its
    strides.  The emulated prefill's logits must be these operands'
    product, so the operands are the path's own.  Runs outside the counted
    window: these launches only compare."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import fused_qmm, fused_qmm_ref
    from repro_torch.models.layers import embed_apply, rmsnorm, unembed_apply
    from repro_torch.models.numerics import EmulatedPolicy
    table = params["embed"]
    x, _ = model._ssm_stack(params["layers"], embed_apply(table, toks),
                            collect=True)  # as prefill runs it
    x = rmsnorm(params["final_norm"], x)
    again = unembed_apply(table, x[:, -1:], EmulatedPolicy("bf16", "fused"))
    check(torch.equal(again[:, 0], last), "the emulated prefill's logits are "
          "not the unembed of its final hidden states")
    b = table.T
    fmts = (F.BF16, F.FP16, F.FP8_E4M3)
    styles = ("fused", "cascade", "cascade_fwd")
    worst, n_checks = 0.0, 0
    for a in (x[:, -1], x[:, -2:].reshape(-1, x.shape[-1])):
        for fmt in fmts:
            for style in styles:
                for scaled in (False, True):
                    got = fused_qmm(a, b, fmt=fmt, style=style, scaled=scaled)
                    want = fused_qmm_ref(a, b, fmt=fmt, style=style,
                                         scaled=scaled, bm=128, bn=128)
                    bad = mismatches(got, want)
                    check(bad == 0, f"K1 unembed {tuple(a.shape)} @ "
                          f"{tuple(b.shape)} {fmt.name} {style} scaled="
                          f"{scaled}: {bad} entries differ (max err "
                          f"{max_abs_err(got, want)})")
                    worst = max(worst, max_abs_err(got, want))
                    n_checks += 1
    emit({"phase": "check", "kernel": "fused_qmm", "arch": model.cfg.name,
          "what": "the unembed on the prefill's final hidden states",
          "shapes": [[2, b.shape[0], b.shape[1]], [4, b.shape[0], b.shape[1]]],
          "b_strides": list(b.stride()), "checks": n_checks,
          "formats": [f.name for f in fmts], "styles": list(styles),
          "tolerance": "exact: every entry equal to the plain version's",
          "max_abs_err": worst, "prefill_logits_are_these_operands": True})
    return worst


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def time_kernels(dev, cfg, launches, errs):
    from repro_torch.core import formats as F
    from repro_torch.kernels.fma_emu import fma_emu_matmul
    from repro_torch.kernels.fused import (fused_qmm, fused_qmm_ref,
                                           plan_qmm, sm_count)
    from repro_torch.kernels.quantize_kernel import quantize_nd
    from repro_torch.kernels.ref import fma_emu_matmul_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    shapes = model_shapes(cfg)
    rows = []
    totals = {m: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                      library_device_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                      ops_ms=0.0) for m in (4, 512)}
    for m in (4, 512):
        for name, (k, n) in shapes.items():
            # a forward runs each projection once per layer at M rows; the
            # unembed runs once, at the batch's 4 last rows also in prefill
            reps = cfg.n_layers if name != "unembed" else int(m == 4)
            a, b = qmm_operands(gen, m, k, n, dev, name == "unembed")
            fmt = F.BF16
            def k1():
                return fused_qmm(a, b, fmt=fmt)

            # bf16 operands are exact in bf16 and the fused style rounds no
            # partial sum, so K1 here is an f32 product of the widened
            # operands: one library call computes it
            def library():
                return torch.matmul(a.float(), b.float())

            row = dict(ms=time_ms(k1, flush),
                       device_ms=time_ms(k1, flush, spin=True),
                       plain_ms=time_ms(lambda: fused_qmm_ref(
                           a, b, fmt=fmt, bm=128, bn=128), flush, reps=3),
                       library_ms=time_ms(library, flush),
                       library_device_ms=time_ms(library, flush, spin=True))
            t_bytes, t_ops = qmm_bound(m, k, n, 2, 2, fmt)
            bound, by = bound_of(t_bytes, t_ops)
            rows.append(dict(m=m, k=k, n=n, weight=name, per_forward=reps,
                             **row, bound_ms=bound, bound_by=by,
                             plan=vars(plan_qmm(1, m, n, k, sm_count(dev)))))
            t = totals[m]
            for key, v in dict(row, bound_ms=bound, bytes_ms=t_bytes,
                               ops_ms=t_ops).items():
                t[key] += reps * v
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
          "flushed; device_ms with a spin kernel ahead of each run",
          "library_call": LIBRARY_K1, "rows": rows, "per_forward": totals,
          "per_forward_over_library": {m: t["ms"] / t["library_ms"]
                                       for m, t in totals.items()},
          "per_forward_over_library_device": {
              m: t["device_ms"] / t["library_device_ms"]
              for m, t in totals.items()}})

    # K3 at the shape the main path ran it: (512, 2048) @ (2048, 2048)
    k, n = shapes["wq"]
    a, b = qmm_operands(gen, 512, k, n, dev, False)
    def k3_call():
        return fma_emu_matmul(a, b, fmt=F.BF16, style="cascade")

    k3 = dict(ms=time_ms(k3_call, flush),
              device_ms=time_ms(k3_call, flush, spin=True),
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
          [512, k, n], "fmt": "bf16", "style": "cascade",
          "plan": vars(plan_qmm(1, 512, n, k, sm_count(dev))), **k3})
    emit({"phase": "times", "kernel": "quantize_nd", "elements": numel,
          "fmt": "bf16", **k2, "library_call": "x.to(torch.bfloat16).float()"})

    dec = totals[4]
    return [
        dict(name="fused_qmm", route="cuda",
             source="src/repro_torch/csrc/qmm.cu",
             replaces="src/repro/kernels/fused.py:140",
             launches=launches["fused_qmm"], max_abs_err=errs["fused_qmm"],
             ms=dec["ms"], device_ms=dec["device_ms"],
             plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=bound_of(dec["bytes_ms"], dec["ops_ms"])[1],
             library_ms=dec["library_ms"],
             library_device_ms=dec["library_device_ms"],
             library_call=LIBRARY_K1,
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
             device_ms=k3["device_ms"], plain_ms=k3["plain_ms"],
             bound_ms=k3["bound_ms"], bound_by=k3["bound_by"], library_ms=None,
             library_call=NO_LIBRARY_CALL,
             work=f"(512, {k}) @ ({k}, {n}) bf16 cascade"),
    ]


def time_scan_kernels(dev, operands, launches, errs):
    """K6 and K5 at layer 0's full-width shape: median of 10 launches with
    the L2 flushed, beside the bound, the plain version's time (3 runs)."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import (ssm_scan_quantized,
                                           ssm_scan_quantized_ref)
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.ssm_scan import plan_scan, ssm_scan, ssm_scan_ref
    a, bx, cm = operands
    B, S, D, N = a.shape
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    k6 = dict(ms=time_ms(lambda: ssm_scan(a, bx, cm), flush),
              plain_ms=time_ms(lambda: ssm_scan_ref(a, bx, cm), flush,
                               reps=3))
    k5 = {}
    for fmt in (None, F.BF16, F.FP8_E4M3):
        k5[fmt.name if fmt else "none"] = time_ms(
            lambda: ssm_scan_quantized(a, bx, cm, fmt=fmt), flush)
    plan = plan_scan(a.shape, sm_count(dev))
    k5_plain = time_ms(lambda: ssm_scan_quantized_ref(a, bx, cm, fmt=F.BF16),
                       flush, reps=3)
    # each input read once, each output written once, f32
    elems = B * S * D * N
    byts = 4 * (2 * elems + B * S * N + B * S * D + B * D * N)
    t_bytes = 1e3 * byts / HBM_BYTES_PER_S
    # 4 flops per (b, s, d, n): the recurrence's multiply and add, the
    # readout's; rounding an operand takes some 10 f32 operations (four
    # multiplications, rint, compares) for each of a, b, c
    t_ops6 = 1e3 * 4 * elems / PEAK_OPS_PER_S["f32"]
    t_ops5 = 1e3 * (4 * elems + 10 * (2 * elems + B * S * N)) \
        / PEAK_OPS_PER_S["f32"]
    b6, by6 = bound_of(t_bytes, t_ops6)
    b5, by5 = bound_of(t_bytes, t_ops5)
    k5_bound = {name: (b6 if name == "none" else b5) for name in k5}
    k5_rate = {name: byts / (ms * 1e-3) for name, ms in k5.items()}
    emit({"phase": "times", "kernel": "ssm_scan+ssm_scan_quantized",
          "shape": [B, S, D, N], "unit": "ms per launch, median of 10, L2 "
          "flushed", "bytes": byts, "bytes_ms": t_bytes,
          "ssm_scan": {**k6, "bound_ms": b6, "bound_by": by6,
                       "achieved_bytes_per_s": byts / (k6["ms"] * 1e-3)},
          "ssm_scan_quantized_ms_by_fmt": k5,
          "ssm_scan_quantized_achieved_bytes_per_s_by_fmt": k5_rate,
          "ssm_scan_quantized_bound_ms_by_fmt": k5_bound,
          "ssm_scan_quantized_plain_ms_bf16": k5_plain,
          "ssm_scan_quantized_bound_ms": b5,
          "plan": {"kernel": plan.kernel, "lanes": plan.lanes,
                   "rows": plan.rows, "grid": list(plan.grid)}})
    work = f"layer 0 of {SSM_ARCH}, a and b {[B, S, D, N]} f32"
    return [
        dict(name="ssm_scan_quantized", route="cuda",
             source="src/repro_torch/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/fused.py:594",
             launches=launches["ssm_scan_quantized"],
             max_abs_err=errs["ssm_scan_quantized"], ms=k5["bf16"],
             plain_ms=k5_plain, bound_ms=b5, bound_by=by5, library_ms=None,
             library_call=NO_LIBRARY_SCAN, work=work + ", fmt bf16",
             ms_by_fmt=k5, bound_ms_by_fmt=k5_bound,
             achieved_bytes_per_s_by_fmt=k5_rate),
        dict(name="ssm_scan", route="cuda",
             source="src/repro_torch/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/ssm_scan.py:59",
             launches=launches["ssm_scan"], max_abs_err=errs["ssm_scan"],
             ms=k6["ms"], plain_ms=k6["plain_ms"], bound_ms=b6,
             bound_by=by6, library_ms=None, library_call=NO_LIBRARY_SCAN,
             work=work),
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
    emit({"phase": "profile", "arch": cfg.name,
          "what": "one decode_step, batch 4, after a 64-token prefill",
          **result})
    return result


# ---------------------------------------------------------------------------
# the paper's DSE core: gates from the JAX package's own tests
# (tests/test_golden_fpmax.py's Table I residual envelope and ANCHOR_RTOL,
# tests/test_latency_and_dse.py's body-bias bounds)
CALIBRATE_RTOL = 1e-3
DSE_RTOL = 1e-12
ANCHOR_RTOL = 1e-6
FIT_ENVELOPE = dict(freq_rel_err=0.32, power_rel_err=0.15,
                    area_rel_err=0.33)
# the electrical grids of tests/test_autotune.py for the fabricated units
FAB_VDD = np.round(np.arange(0.55, 1.101, 0.05), 3)
FAB_VBB = np.round(np.arange(0.0, 1.21, 0.3), 2)


def dse_full_size(dev, smi):
    """The DSE core on the card against the CPU and the numpy backend;
    returns each stage's seconds."""
    from repro_torch.core import autotune as at
    from repro_torch.core import body_bias, dse, energy_model, latency_sim
    from repro_torch.core.fpu_arch import DP_CMA, FABRICATED, TABLE_I
    seconds = {}

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[stage] = time.perf_counter() - t0
        emit({"phase": "dse", "stage": stage, "seconds": seconds[stage],
              "card": smi})
        return out

    # the phase is host-bound: its time is launches x host time a launch
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x = x + 1
    torch.cuda.synchronize()
    emit({"phase": "dse", "host_us_per_launch":
          (time.perf_counter() - t0) / 2000 * 1e6, "what": "x + 1, eager"})
    params = timed("calibrate", lambda: energy_model.calibrate(device=dev))
    cpu_params = timed("calibrate_cpu",
                       lambda: energy_model.calibrate(device="cpu"))
    rel = np.abs(np.array(params.values) / np.array(cpu_params.values) - 1)
    emit({"phase": "dse", "check": "calibrate", "params": repr(params),
          "max_rel_vs_cpu": float(rel.max())})
    check(rel.max() <= CALIBRATE_RTOL, f"calibrate on the card is "
          f"{rel.max():.3g} from the CPU's fit (rtol {CALIBRATE_RTOL})")
    report = energy_model.calibration_report(params, device=dev)
    for name, row in report.items():
        for key, bound in FIT_ENVELOPE.items():
            check(abs(row[key]) <= bound, f"{name} {key} {row[key]:.3f} "
                  f"outside +-{bound}")
        gw = row["gflops_per_w_pred"] / row["gflops_per_w_meas"] - 1.0
        gm = row["gflops_per_mm2_pred"] / row["gflops_per_mm2_meas"] - 1.0
        check(abs(gw) <= 0.20 and abs(gm) <= 0.48,
              f"{name} efficiency residuals {gw:.3f} / {gm:.3f}")

    latency_sim.clear_penalty_cache()
    mix = timed("spec_mix", lambda: latency_sim.calibrated_spec_mix(
        device=dev))
    cpu_mix = timed("spec_mix_cpu", lambda: latency_sim.calibrated_spec_mix(
        device="cpu"))
    check(mix == cpu_mix, f"mixture search: card {mix} != CPU {cpu_mix}")
    latency_sim.clear_penalty_cache()
    fig2c = latency_sim.fig2c_penalties(mix, device=dev)
    latency_sim.clear_penalty_cache()
    cpu_fig2c = latency_sim.fig2c_penalties(mix, device="cpu")
    emit({"phase": "dse", "check": "fig2c", "mix": str(mix), **fig2c})
    check(fig2c == cpu_fig2c, f"fig2c penalties: card {fig2c} != CPU "
          f"{cpu_fig2c}")
    check(abs(fig2c["reduction_vs_fwd"] - 0.37) < 0.05 and
          abs(fig2c["reduction_vs_nofwd"] - 0.57) < 0.05,
          f"fig2c reductions {fig2c} not within 0.05 of 0.37 / 0.57")

    latency_sim.clear_penalty_cache()
    space = dse.enumerate_structures("sp") + dse.enumerate_structures("dp")
    res = timed("sweep_fig34", lambda: dse.sweep_arrays(
        space, params, mix=mix, with_latency=True, device=dev))
    ref = dse.sweep_arrays(space, params, mix=mix, with_latency=True,
                           backend="numpy", device=dev)
    check(len(res) == 9240, f"{len(res)} sweep points, expected 9240")
    worst = max(float(np.max(np.abs(res.metrics[k] / ref.metrics[k] - 1)))
                for k in ref.metrics)
    check(list(res.metrics) == list(ref.metrics) and worst <= DSE_RTOL,
          f"card sweep {worst:.3g} from the numpy backend (rtol {DSE_RTOL})")
    for what in ("throughput_pareto_mask", "latency_pareto_mask"):
        check(np.array_equal(getattr(res, what)(), getattr(ref, what)()),
              f"{what} differs between the card and the numpy backend")
    fab = list(FABRICATED.values())
    anch = dse.sweep_arrays(fab, params, sorted({TABLE_I[d.name].vdd
                                                 for d in fab}), [1.2],
                            anchored=True, device=dev)
    for i, d in enumerate(fab):
        m = TABLE_I[d.name]
        r = int(np.nonzero((anch.design_index == i) & (anch.vdd == m.vdd))
                [0][0])
        for key, want in (("freq_ghz", m.freq_ghz), ("p_leak_mw", m.leak_mw),
                          ("p_total_mw", m.power_mw),
                          ("area_mm2", m.area_mm2)):
            got = anch.metrics[key][r]
            check(abs(got / want - 1) <= ANCHOR_RTOL,
                  f"anchored {d.name} {key} {got} != Table I {want}")
    emit({"phase": "dse", "check": "sweep_fig34", "points": len(res),
          "max_rel_vs_numpy": worst,
          "throughput_pareto": int(res.throughput_pareto_mask().sum()),
          "latency_pareto": int(res.latency_pareto_mask().sum()),
          "best_throughput": res.point(res.argbest_throughput()).key,
          "best_latency": res.point(res.argbest_latency()).key})

    cache = energy_model.SweepExecutableCache()
    for precision in ("sp", "dp"):
        pair = timed(f"tune_split_{precision}", lambda: at.tune_split(
            precision, params=params, cache=cache, device=dev))
        for r in pair:
            got = (r.design.name, r.vdd, r.vbb)
            want = numpy_tune(r.profile, precision, params, dev)
            check(got == want, f"tune {r.profile.name} {precision}: card "
                  f"{got} != numpy backend {want}")
        check(pair[0].design.name != pair[1].design.name,
              f"{precision}: throughput and latency optima coincide")
        emit({"phase": "dse", "check": f"tune_split_{precision}",
              "results": [r.as_dict() for r in pair],
              "cache": dict(cache.stats)})
    check(cache.stats == dict(hits=3, misses=1, executables=1),
          f"same-shape tunes missed the sweep cache: {cache.stats}")
    for precision in ("sp", "dp"):
        units = [d for d in fab if d.precision == precision]
        for profile, style in ((at.GEMM_STREAM, "fma"),
                               (at.DEPENDENT_CHAIN, "cma")):
            r = at.autotune(profile, precision, designs=units, params=params,
                            vdd_grid=FAB_VDD, vbb_grid=FAB_VBB,
                            anchored=True, cache=cache, device=dev)
            check(r.design.name == f"{precision}_{style}",
                  f"{profile.name} picked {r.design.name} among the "
                  f"fabricated {precision} units")

    s = body_bias.bb_study(DP_CMA, params, vdd=0.6)
    emit({"phase": "dse", "check": "bb_study", **s})
    check(0.10 < s["bb_energy_saving"] < 0.35 and
          2.3 < s["low_util_static_ratio"] < 4.0 and
          1.2 < s["low_util_adaptive_ratio"] < 1.9,
          f"bb_study(DP_CMA, vdd=0.6) outside the paper's bounds: {s}")
    emit({"phase": "dse", "seconds": seconds, "card": smi})
    return seconds


def numpy_tune(profile, precision, params, dev):
    """``autotune``'s pick with the sweep on the numpy backend (the
    penalties come from the cache the card's tune filled)."""
    from repro_torch.core import autotune as at
    from repro_torch.core import dse
    res = dse.sweep_arrays(dse.enumerate_structures_full(precision), params,
                           at.TUNE_VDD_GRID, at.TUNE_VBB_GRID,
                           mix=profile.mix(), with_latency=True,
                           backend="numpy", device=dev)
    at.attach_workload_metrics(res, profile, params)
    i = res.argbest(profile.objective())
    return res.design_of(i).name, float(res.vdd[i]), float(res.vbb[i])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.benchgen import calibrate, validate
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.fma_emu import fma_emu_matmul
    from repro_torch.kernels.fused import (fused_flash_attention, fused_qmm,
                                           ssm_scan_quantized)
    from repro_torch.kernels.quantize_kernel import quantize_nd
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import LM
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = card_and_build()
    errs = check_kernels(dev)
    check_rounding(dev)
    errs.update(check_scan_kernels(dev))
    errs.update(check_flash_kernels(dev))
    check_small_lm(dev)

    wrappers = {"fused_qmm": fused_qmm, "quantize_nd": quantize_nd,
                "fma_emu_matmul": fma_emu_matmul,
                "fused_flash_attention": fused_flash_attention,
                "ssm_scan_quantized": ssm_scan_quantized,
                "ssm_scan": ssm_scan}
    paths = {}

    def drive(path, kernels_of_path, *steps):
        """The path's steps with every launch count set to 0 just before
        and read just after; each kernel of the path must have launched."""
        for fn in wrappers.values():
            fn.launches = 0
        out = [step() for step in steps]
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        emit({"phase": "launches", "path": path, "counts": counts})
        for name in kernels_of_path:
            check(counts[name] > 0, f"{name} was not launched on the "
                  f"{path} path")
        paths[path] = counts
        return counts, out

    # the dense path: tinyllama-1.1b
    cfg = get_config(ARCH)
    model = LM(cfg, device=dev)
    params = model.init(seed=SEED)
    rng = np.random.default_rng(SEED)
    dense, _ = drive(ARCH, ("fused_qmm", "quantize_nd", "fma_emu_matmul"),
                     lambda: serve_full_width(model, params, rng),
                     lambda: emulated_full_width(model, params, rng),
                     lambda: user_calls_full_width(model, params))
    kernels = time_kernels(dev, cfg, dense, errs)
    profile_decode(model, params, rng)

    # the attention path: K4 on tinyllama-1.1b's layer 0 at full width,
    # then benchgen's generated kernels on the card
    _, (flash_operands_,) = drive(
        f"{ARCH} attention", ("fused_flash_attention",),
        lambda: attention_full_width(model, params, rng))
    kernels.append(time_flash_kernel(dev, flash_operands_, errs))
    del flash_operands_
    specs = benchgen_specs()
    machine = calibrate(device=dev)  # launches K2: outside the window
    _, (bench,) = drive(
        "benchgen", ("fused_qmm", "quantize_nd", "fused_flash_attention",
                     "ssm_scan_quantized"),
        lambda: validate(specs, machine=machine, device=dev))
    benchgen_report(dev, specs, machine, bench)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # the ssm path: falcon-mamba-7b
    scfg = get_config(SSM_ARCH)
    smodel = LM(scfg, device=dev)
    t0 = time.perf_counter()
    sparams = smodel.init(seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": SSM_ARCH, "seconds":
          time.perf_counter() - t0, "parameters": sum(
              t.numel() for t in tree_leaves(sparams)),
          "device_bytes": torch.cuda.memory_allocated()})
    ssm_counts, (_, _, (operands, toks, last)) = drive(
        SSM_ARCH, ("ssm_scan", "ssm_scan_quantized", "fused_qmm"),
        lambda: serve_full_width(smodel, sparams,
                                 np.random.default_rng(SEED + 1),
                                 noise_floor=True),
        lambda: serve_f32(scfg, sparams, dev),
        lambda: ssm_kernels_full_width(smodel, sparams, rng))
    errs["fused_qmm"] = max(errs["fused_qmm"],
                            check_ssm_unembed(smodel, sparams, toks, last))
    kernels += time_scan_kernels(dev, operands, ssm_counts, errs)
    del operands
    profile_decode(smodel, sparams, rng)
    for row in kernels:  # launches on every path of this run
        row["max_abs_err"] = errs[row["name"]]
        by_path = {path: counts[row["name"]]
                   for path, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    # the paper's DSE core: no kernel of K1-K6, so no launch window
    del smodel, sparams
    gc.collect()
    torch.cuda.empty_cache()
    dse_full_size(dev, smi)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
