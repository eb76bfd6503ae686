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
  3b. the chip facade on tinyllama-1.1b, counters set to 0 just before:
     ``BatchedServer`` with a ``ChipPolicy`` over the fabricated SP+DP die
     (calibrated on the card), 8 slots split into one fleet per decode
     unit, deadline routing and an accuracy class, serves 12 requests, one
     per (precision sp/dp/None, deadline or not, accuracy_slo 1e-2/None);
     each request's unit equals ``admission_unit`` computed apart, its
     energy equals prompt tokens x flops/token on the prefill unit plus
     decoded tokens on its unit (rel 1e-9), ``energy_report`` equals the
     sum over requests, every token passes the ``serve`` gate, and an
     unmeetable SLO is rejected as ``accuracy_slo_unmeetable``; one 4x128
     prefill under the prefill unit's and one under the decode unit's
     routed numerics (bf16 fused, bf16 cascade_fwd), 155 K1 launches each,
     bitwise equal to ``EmulatedPolicy`` with that format and style;
  3c. telemetry on tinyllama-1.1b (the chip phase's die and fleets): the
     chip phase's 12 requests served under the recording ``Tracer`` and
     untraced, in turns; the trace's ``check_integrity()`` empty, one root
     span a request, each request's span energy equal to its
     ``energy_j`` and the tracer's total to ``energy_report``'s (rel
     1e-9), the same tokens traced and untraced, the JSONL round trip
     equal to the tracer and the Chrome trace parsed; then the loaded
     trace's ``phases_from_trace`` tuned by ``tune_chip`` on the card and
     on the CPU, picking the same units; tracing's cost in served
     tokens/s printed;
  3d. fault-tolerant serving of tinyllama-1.1b in float32 (the bf16
     weights widened) by ``ResilientServer`` over the same die, on a fake
     clock with synthetic dispatch times and a seeded ``FaultInjector``,
     8 sp requests (bulk ones on sp_fma, deadline-bound ones on sp_cma):
     sp_fma killed mid-run (no request lost, the drained ones resumed on
     sp_cma, each resumed stream bitwise the uninterrupted run's or parting
     first at a near tie of ``LM.apply``, every token within 4 * 2**-8 of
     it); a transient corruption retried with backoff, no corrupt token
     committed; a throttle detected and sp_fma's J/FLOP raised; every
     fleet killed, all 8 requests parked, a probe bringing the fleets
     back and the requests finished; ``resilience_report()`` and each
     recovery's latency in sim and wall seconds printed; then the
     per-token ``ReferenceServer`` serving phase 3's 8 requests in bf16,
     every token held to 4 * 2**-8 of ``LM.apply``;
  3e. benchgen on the card: ``calibrate()`` measures the card's rates,
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
  4a. the hybrid path at the full width and depth of zamba2-1.2b (each
     model of 4a-4c freed before the next), counters set to 0 just before:
     ``BatchedServer`` and ``greedy_decode`` as in 4 in bf16 (twice the
     model's own noise floor; the two streams parting only where the
     single-lane decode path puts their picks within twice the measured
     gap between one lane and the server's batch), a server prefilling in
     64-token chunks (its parting from the monolithic streams judged the
     same way, the chunked prefill's own gap added), the same requests in
     float32 (4 * 2**-8), one 4x128 prefill and 4 decode steps under
     EmulatedPolicy(bf16, fused) with 37 K1 launches per forward (six
     shared-block projections per application, six applications, the
     unembed), and a profile of one decode step;
  4b. the MoE path at the full width and depth of deepseek-moe-16b (fp8 KV
     cache): served at ``capacity_factor = n_experts`` (nothing drops) in
     bf16 (timed, not held); the same requests at the config's 1.25 with
     each prefill forward's dropped share (``LM.apply(moe_stats=True)`` on
     the server's own batches, read off the server's recorded ``Tracer``)
     and the tokens that differ printed; two
     identical prefills bitwise equal; 113 K1 launches per emulated
     forward; layer 0's MoE on the largest served prefill's input against
     the CPU (picks, keep mask and slots identical, output within
     4 * 2**-8); last, the bf16 weights widened to float32 leaf by leaf
     and the no-drop requests served again at full depth with a float32
     KV cache, every token and greedy_decode's held to 4 * 2**-8 of
     ``LM.apply`` (the fp8 cache rounds the shapes' last-bit differences
     to whole fp8 steps, beyond that share at this depth);
  4c. the sliding-window path of mixtral-8x7b at full width, 4 of its 32
     layers (one card holds no more), its 4096-slot ring KV cache, at
     ``capacity_factor = n_experts``: prompts of 700-4200 tokens served
     and decoded past the window's edge (float32 held to 4 * 2**-8, bf16
     timed), a 4600-token ``prefill_chunked`` in chunks of 1000 against
     ``prefill`` (layer 0's ring bitwise in bf16; in float32 the last
     logits and every layer's ring within 1e-4 of their max |value|),
     17 K1 launches per emulated forward;
  4d. the vlm and audio families at full width and depth, each model
     freed before the next: internvl2-1b (24 layers, d_model 896, 14/2
     heads, vocab 151655) with 256 prefix embeddings from a
     ``torch.Generator`` before 64 tokens, prefilled and decoded 8 steps
     (each token within 4 * 2**-8 of ``LM.apply``'s top logit on the same
     embeddings and tokens; the cache length counts the prefix), phase
     3's 8 requests served as a token LM under phase 3's gates, one
     4x128 prefill with the prefix and 4 decode steps under
     EmulatedPolicy(bf16, fused) with 169 K1 launches per forward, and a
     decode profile; musicgen-large (48 layers, d_model 2048, 32 MHA
     heads, float8_e4m3fn KV cache) with 2 x 512 frame embeddings
     prefilled and decoded 8 steps in bf16 (timed, each token's gap to
     ``LM.apply`` printed, not gated), layer 0's fp8 cache bitwise the
     CPU's ``to_cache`` of the same K/V, 289 K1 launches per emulated
     forward (frames in place of the tokens), a decode profile, and the
     same frames in float32 with a float32 cache, every token within
     4 * 2**-8 of ``LM.apply``;
  5. the paper's DSE core at full size on the card (it launches none of
     K1-K6, so it has no launch window): the chip phase's ``calibrate``
     (6000 float32 Adam steps) within rtol 1e-3 of the same fit on the CPU, its Table I
     residuals within the reference's envelope; ``calibrated_spec_mix``'s
     270-candidate search picking the CPU's mixture and ``fig2c_penalties``
     bitwise the CPU's, its reductions within 0.05 of the paper's 37% / 57%;
     the SP+DP Fig. 3/4 sweep (9,240 points with latency) within rtol 1e-12
     of the numpy backend with the same Pareto sets, and the anchored
     Table I rows exact to 1e-6; ``tune_split`` of both precisions over the
     288-structure enumeration at the ``TUNE_*`` grids picking the numpy
     backend's design and operating point, the fabricated units' Table I
     split, and a same-shape retune hitting the sweep cache; ``bb_study``
     within the paper's body-bias bounds; the chip facade's numerics and
     tuning: the exact ``AccuracyModel`` over the SP and DP ladders (a
     monotone ladder), the float64 softfloat on the card bitwise the CPU's
     on 2**20 normal-range triples per format and ``dp_fma`` exact against
     ``Fraction`` on 4096 of them, ``emulated_dot`` on the card equal to
     the oracle's exact steps on its own samples for every (format,
     style), the format-joint ``autotune`` (a loose SLO below SP, a tight
     one at fp32, an unmeetable one refused) and ``tune_chip`` over
     tinyllama-1.1b's phases picking on the card what it picks on the CPU.
     Each stage's seconds are printed beside the card's name and power
     limit.

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

STARTED = time.perf_counter()

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
# the chip-routed server: slots split into one fleet per decode unit of the
# fabricated SP+DP die; the requests cycle through every (precision,
# deadline, accuracy class) combination
CHIP = dict(slots=8, max_len=256, prompt_lo=16, prompt_hi=128, new_tokens=32,
            precisions=("sp", "dp", None), deadlines=(False, True),
            slos=(None, 1e-2), accuracy_fleets=(1e-2,), unmeetable=1e-30)
# each request's energy against the per-token sum (the JAX package's own
# bound between bulk and per-token charging, tests/test_serve_fused.py)
ENERGY_REL = 1e-9
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
    """Print one record, with the seconds since the script started."""
    record = dict(record, elapsed_s=time.perf_counter() - STARTED)
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
def serve_full_width(model, params, rng, noise_floor=False, spec=SERVE,
                     lens=None, prefill_chunk=None, parting_on_decode=False,
                     greedy=None):
    """``BatchedServer`` answers ``spec``'s requests (after a warm-up;
    prompts of ``lens`` tokens, or of lengths drawn from ``spec``'s range;
    with ``prefill_chunk`` the server prefills in chunks), then
    every token of every request, and of ``greedy_decode``'s stream for the
    same prompt, is held to one ``LM.apply`` over its whole stream: its
    logit within a share of max |logit| of the top one.  The share is
    NEAR_TIE, or with ``noise_floor`` the larger of NEAR_TIE and twice the
    model's own rounding noise measured in this run: how far ``prefill``'s
    last logits lie from ``LM.apply``'s at the same position (two shapes of
    the same computation), itself held under FLOOR_CAP.  The server's and
    ``greedy_decode``'s streams must also agree up to the first position
    where ``LM.apply``'s top two logits lie within NEAR_TIE of max |logit|;
    with ``parting_on_decode`` instead where the single-lane decode path
    (``greedy_decode``'s own logits) puts the two picks within twice the
    measured gap between a decode step run as one lane and in the server's
    batch (``lane_gap``), NEAR_TIE at least.  ``greedy``: greedy_decode's
    streams for these prompts, already held in an earlier call.

    A model whose KV cache is narrower than its compute dtype is held
    instead to the single-lane path ``greedy_decode`` takes, ``prefill``
    and ``decode_step`` replayed along the server's own stream
    (``LM.apply`` keeps no cache, so it is no reference for decoded
    tokens); that makes the agreement a check of the stream's every token.

    A MoE below float32 is not held beyond every request completing with
    tokens in range, and no reference is replayed for it: its routing
    turns a last-bit difference between the server's shapes and the
    reference's into another expert for a token, a deviation no noise
    floor sampled at a few positions bounds; its float32 run carries the
    gate.
    """
    from repro_torch.serve import BatchedServer, Request, greedy_decode
    s = spec
    reference = "decode" if model.cache_dtype != model.dtype else "apply"
    gate_tokens = not model.cfg.n_experts or model.dtype == torch.float32
    if lens is None:
        lens = rng.integers(s["prompt_lo"], s["prompt_hi"] + 1,
                            s["requests"])
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]

    def serve(batch):
        server = BatchedServer(model, params, slots=s["slots"],
                               max_len=s["max_len"],
                               prefill_chunk=prefill_chunk)
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
    n_tok = sum(len(r.output) for r in reqs)
    rec = {"phase": "serve", "arch": model.cfg.name, "reference": reference,
           "kv_cache_dtype": str(model.cache_dtype),
           "dtype": model.cfg.dtype, "prefill_chunk": server.prefill_chunk,
           "capacity_factor": model.cfg.capacity_factor
           if model.cfg.n_experts else None, "slots": s["slots"],
           "max_len": s["max_len"], "requests": len(reqs),
           "prompt_lens": [int(n) for n in lens],
           "new_tokens": s["new_tokens"], "wall_s": wall,
           "tokens_per_s": n_tok / wall, "dispatches": report["dispatches"],
           "host_syncs": report["host_syncs"], "gated": gate_tokens}
    streams = {}
    if gate_tokens:
        measured, streams = hold_streams(
            model, params, reqs, prompts, s, noise_floor,
            parting_on_decode and (server.prefill_chunk or 0), greedy)
        rec.update(measured)
    emit(rec)
    rec.update(outputs=[r.output for r in reqs], prompts=prompts,
               greedy=streams)
    return rec


def hold_streams(model, params, reqs, prompts, s, noise_floor,
                 parting_on_decode, greedy):
    """``serve_full_width``'s gates on the served streams; returns what
    they measured and greedy_decode's streams by request.
    ``parting_on_decode``: False, or the server's prefill chunk (0: none)
    when the streams' parting is judged on the decode path."""
    from repro_torch.serve import greedy_decode
    reference = "decode" if model.cache_dtype != model.dtype else "apply"
    # every token of every request, and of greedy_decode's stream for the
    # same prompt, against one full-sequence forward on its own prefix
    held, agree, parts, gaps, floor = [], [], [], [], 0.0
    streams = {}
    for r, prompt in zip(reqs, prompts):
        if reference == "decode":
            shortfall, scale, _, rows = stream_vs_decode(
                model, params, prompt, r.output, s["max_len"])
            held.append((r.uid, "server", shortfall, scale))
            pos = apply_along(model, params, prompt, r.output)
            gaps.append((rows - pos).abs().max(-1).values
                        / pos.abs().max(-1).values)
            first = pos[0]
        else:
            shortfall, scale, margin, first = stream_vs_apply(
                model, params, prompt, r.output)
            held.append((r.uid, "server", shortfall, scale))
            ref = greedy[r.uid] if greedy else greedy_decode(
                model, params, prompt, s["new_tokens"], max_len=s["max_len"])
            streams[r.uid] = ref
            if not greedy:
                shortfall, scale, margin, _ = stream_vs_apply(
                    model, params, prompt, ref)
                held.append((r.uid, "greedy_decode", shortfall, scale))
            split = next((i for i, (x, y) in enumerate(zip(r.output, ref))
                          if x != y), len(ref))
            agree.append(split)
            if split < len(ref):  # the prefixes agree up to here
                parts.append((r.uid, prompt, ref, split, r.output[split],
                              float(margin[split] / scale[split])))
        last, _ = model.prefill(params, torch.as_tensor(
            prompt[None], device=model.device))
        floor = max(floor, float((last[0].float() - first).abs().max()
                                 / first.abs().max()))
    share = NEAR_TIE
    if noise_floor:
        check(floor <= FLOOR_CAP, f"prefill and LM.apply differ by {floor} "
              f"of max |logit|, more than rounding noise ({FLOOR_CAP})")
        share = max(NEAR_TIE, 2 * floor)
    out = {"parting_gaps": [p[-1] for p in parts]}
    if parting_on_decode is not False:
        lanes = max(lane_gap(model, params, prompt, r.output[0], s)
                    for r, prompt in zip(reqs, prompts))
        chunks = max(chunk_gap(model, params, prompt, parting_on_decode)
                     for prompt in prompts) if parting_on_decode else 0.0
        limit = max(NEAR_TIE, 2 * (lanes + chunks))
        on_decode = []
        for uid, prompt, ref, split, pick, _ in parts:
            on_decode.append(decode_parting(
                model, params, prompt, ref, split, pick, s["max_len"]))
            check(on_decode[-1] <= limit, f"request {uid}: the server and "
                  f"greedy_decode part at token {split}, where the decode "
                  f"path puts their picks {on_decode[-1]} of max |logit| "
                  f"apart (limit {limit})")
        out.update(lane_vs_batch_rel_logit_gap=lanes,
                   chunked_vs_prefill_rel_logit_gap=chunks,
                   parting_limit_on_decode=limit,
                   parting_gaps_on_decode=on_decode)
    else:
        for uid, _, _, split, _, gap in parts:
            check(gap <= NEAR_TIE, f"request {uid}: the server and "
                  f"greedy_decode part at token {split}, where LM.apply's "
                  f"top two logits are {gap} of max |logit| apart (a near "
                  f"tie is within {NEAR_TIE})")
    worst, exact = 0.0, 0
    for uid, what, shortfall, scale in held:
        over = shortfall / (share * scale)
        bad = int((over > 1).sum())
        check(bad == 0, f"request {uid}: {bad} {what} tokens fall short of "
              f"LM.apply's top logit by more than {share} of max |logit| "
              f"(worst {float(over.max())} of the limit)")
        worst = max(worst, float(over.max()))
        exact += int((shortfall == 0).sum())
    out.update({"tokens_checked": len(held) * s["new_tokens"],
                "tokens_at_reference_argmax": exact,
                "prefill_vs_apply_rel_logit_gap": floor,
                "limit_share_of_max_logit": share,
                "limit_from_noise_floor": noise_floor,
                "worst_shortfall_over_limit": worst,
                "tokens_within_near_tie": sum(
                    int((sh <= NEAR_TIE * sc).sum())
                    for _, _, sh, sc in held),
                "server_greedy_agreeing_prefix": agree})
    if gaps:  # how far the decode path lies from LM.apply on its tokens
        gaps = torch.cat(gaps)
        out["decode_vs_apply_rel_logit_gap"] = dict(
            median=float(gaps.median()), max=float(gaps.max()))
    return out, streams


def lane_gap(model, params, prompt, tok, s):
    """How far one decode step's logits after ``prompt`` (fed ``tok``)
    lie apart run as one lane and as lane 0 of the server's ``slots``
    lanes holding the same cache, as a share of max |logit|: the decode
    batch's own rounding noise."""
    from repro_torch.models.model import DecodeCache
    dev = model.device
    _, cache = model.prefill(params, torch.as_tensor(prompt[None],
                                                     device=dev),
                             max_len=s["max_len"])
    wide = DecodeCache({k: t.repeat_interleave(s["slots"], dim=1)
                        for k, t in cache.data.items()}, cache.length)
    rows = [model.decode_step(params, c, torch.full(
        (b, 1), int(tok), device=dev))[0][0, -1].float()
        for b, c in ((1, cache), (s["slots"], wide))]
    return float((rows[0] - rows[1]).abs().max() / rows[0].abs().max())


def chunk_gap(model, params, prompt, chunk):
    """How far ``prefill_chunked`` in ``chunk``-token chunks puts the
    prompt's last logits from ``prefill``'s, as a share of max |logit|."""
    toks = torch.as_tensor(prompt[None], device=model.device)
    want, _ = model.prefill(params, toks)
    got, _ = model.prefill_chunked(params, toks, chunk)
    return float((got - want).abs().max() / want.abs().max())


def decode_parting(model, params, prompt, stream, split, pick, max_len):
    """Where ``pick`` parts from ``stream`` at ``split``: how far apart the
    single-lane decode path, on ``prompt`` and ``stream[:split]``, puts the
    two tokens' logits, as a share of max |logit| there."""
    _, _, _, rows = stream_vs_decode(model, params, prompt,
                                     stream[:split + 1], max_len)
    row = rows[split]
    return float((row[stream[split]] - row[pick]).abs() / row.abs().max())


def stream_vs_decode(model, params, prompt, stream, max_len):
    """``stream_vs_apply``'s first three, from ``prefill`` of the prompt and
    ``decode_step`` on each earlier token of the stream (one lane, the
    model's own cache), and those logits."""
    dev = model.device
    last, cache = model.prefill(params, torch.as_tensor(prompt[None],
                                                        device=dev),
                                max_len=max_len)
    rows = [last[0]]
    for t in stream[:-1]:
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[int(t)]], device=dev))
        rows.append(logits[0, -1])
    pos = torch.stack(rows).float()
    chosen = torch.as_tensor(stream, device=dev)[:, None]
    top2 = pos.topk(2, dim=-1).values
    shortfall = top2[:, 0] - pos.gather(-1, chosen)[:, 0]
    return (shortfall, pos.abs().max(-1).values, top2[:, 0] - top2[:, 1],
            pos)


def apply_along(model, params, prompt, stream):
    """``LM.apply``'s logits for each token of ``stream`` generated after
    ``prompt``: one forward over the prompt and the stream's earlier
    tokens, (len(stream), vocab) in float32."""
    toks = np.concatenate([prompt, np.asarray(stream[:-1], np.int64)])
    logits, _ = model.apply(params, torch.as_tensor(toks[None],
                                                    device=model.device))
    return logits[0, len(prompt) - 1:].float()


def stream_vs_apply(model, params, prompt, stream):
    """For each token of ``stream`` generated after ``prompt``, from
    ``LM.apply`` on the prompt + the stream's earlier tokens: how far its
    logit falls short of that position's top logit, max |logit| there, the
    gap between the top two logits there, and the logits at the prompt's
    last position."""
    pos = apply_along(model, params, prompt, stream)
    chosen = torch.as_tensor(stream, device=pos.device)[:, None]
    top2 = pos.topk(2, dim=-1).values
    shortfall = top2[:, 0] - pos.gather(-1, chosen)[:, 0]
    return (shortfall, pos.abs().max(-1).values, top2[:, 0] - top2[:, 1],
            pos[0])


def hold_to_apply(model, params, reqs, prompts, what):
    """Every token of every request within NEAR_TIE of ``LM.apply``'s top
    logit on its own prefix; returns (worst shortfall over the limit,
    tokens at the argmax) and each request's margins."""
    worst, exact, margins = 0.0, 0, {}
    for r, prompt in zip(reqs, prompts):
        shortfall, scale, margin, _ = stream_vs_apply(model, params, prompt,
                                                      r.output)
        over = shortfall / (NEAR_TIE * scale)
        check(int((over > 1).sum()) == 0, f"{what} request {r.uid}: a token "
              f"falls short of LM.apply's top logit by more than {NEAR_TIE} "
              "of max |logit|")
        worst = max(worst, float(over.max()))
        exact += int((shortfall == 0).sum())
        margins[r.uid] = margin / scale
    return worst, exact, margins


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


def chip_server(model, params, tech, **kw):
    """The chip phase's policy over the fabricated SP+DP die and its
    ``BatchedServer`` (``kw``: more server options, such as a tracer)."""
    from repro_torch.core import chip
    from repro_torch.serve import BatchedServer
    c = CHIP
    policy = chip.ChipPolicy(chip.fabricated_chip(None, tech), tech)
    return policy, BatchedServer(model, params, slots=c["slots"],
                                 max_len=c["max_len"], chip_policy=policy,
                                 deadline_routing=True,
                                 accuracy_fleets=c["accuracy_fleets"], **kw)


def chip_traffic(cfg, rng):
    """The chip phase's 12 requests, one per (precision, deadline, accuracy
    class): (combos, prompt lengths, prompts, requests)."""
    from repro_torch.serve import Request
    c = CHIP
    combos = [(p, d, a) for p in c["precisions"] for d in c["deadlines"]
              for a in c["slos"]]
    lens = rng.integers(c["prompt_lo"], c["prompt_hi"] + 1, len(combos))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    far = time.monotonic() + 1e6  # a deadline class, never an expiry
    reqs = [Request(uid=i, prompt=pr, max_new_tokens=c["new_tokens"],
                    deadline_s=far if d else None, precision=p,
                    accuracy_slo=a)
            for i, (pr, (p, d, a)) in enumerate(zip(prompts, combos))]
    return combos, lens, prompts, reqs


def chip_full_width(model, params, rng, tech):
    """The chip facade on tinyllama-1.1b at full width: ``BatchedServer``
    with a ``ChipPolicy`` over the fabricated SP+DP die routes requests of
    every (precision, deadline, accuracy class) combination to their
    fleets and charges their energy; every routed unit, energy and served
    token is gated.  Then one prefill under the prefill unit's and one
    under the decode unit's routed numerics, each K1 launch counted and
    the logits bitwise those of ``EmulatedPolicy`` with the same format and
    style."""
    from repro_torch.core import chip
    from repro_torch.kernels.fused import fused_qmm
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.serve import Request, RequestRejected
    cfg, dev, c = model.cfg, model.device, CHIP
    policy, server = chip_server(model, params, tech)
    combos, lens, prompts, reqs = chip_traffic(cfg, rng)
    bad = Request(uid=len(reqs), prompt=prompts[0], max_new_tokens=2,
                  accuracy_slo=c["unmeetable"])
    try:
        server.submit(bad)
        fail("an unmeetable accuracy SLO was admitted")
    except RequestRejected as e:
        check(e.code == "accuracy_slo_unmeetable" and bad.rejected,
              f"unmeetable SLO rejected as {e.code}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == len(reqs), "chip server did not finish every request")
    # routing, from a policy of its own (no shared route cache)
    judge = chip.ChipPolicy(chip.fabricated_chip(None, tech), tech)
    fpt = server.flops_per_token
    check(fpt == 2.0 * cfg.active_param_count(), f"flops/token {fpt}")
    per_unit, worst_rel = {}, 0.0
    for r, (p, d, a) in zip(reqs, combos):
        want = judge.admission_unit(
            precision=p or cfg.numerics_precision,
            deadline_class="interactive" if d else "bulk",
            accuracy_slo=a).name
        check(r.routed_unit == want, f"request {r.uid} routed to "
              f"{r.routed_unit}, admission_unit says {want}")
        check(r.done and not r.expired and
              len(r.output) == c["new_tokens"],
              f"request {r.uid}: {len(r.output)} tokens")
        pre = judge.unit_for_phase("prefill",
                                   precision=p or cfg.numerics_precision)
        dec = judge.spec.unit(r.routed_unit)
        parts = {pre.name: len(r.prompt) * fpt * pre.e_per_flop_pj * 1e-12}
        parts[dec.name] = parts.get(dec.name, 0.0) + \
            (len(r.output) - 1) * fpt * dec.e_per_flop_pj * 1e-12
        check(sorted(r.unit_energy_j) == sorted(parts),
              f"request {r.uid} charged {sorted(r.unit_energy_j)}, "
              f"expected {sorted(parts)}")
        for unit, e in parts.items():
            rel = abs(r.unit_energy_j[unit] / e - 1)
            worst_rel = max(worst_rel, rel)
            check(rel <= ENERGY_REL, f"request {r.uid} {unit}: "
                  f"{r.unit_energy_j[unit]} J, per-token sum {e} J")
            per_unit[unit] = per_unit.get(unit, 0.0) + r.unit_energy_j[unit]
        rel = abs(r.energy_j / sum(parts.values()) - 1)
        worst_rel = max(worst_rel, rel)
        check(rel <= ENERGY_REL, f"request {r.uid}: {r.energy_j} J")
    report = server.energy_report()
    check(sorted(report["per_unit_j"]) == sorted(per_unit),
          f"energy_report units {sorted(report['per_unit_j'])}")
    for unit, e in per_unit.items():
        check(abs(report["per_unit_j"][unit] / e - 1) <= ENERGY_REL,
              f"energy_report {unit} != the requests' sum")
    check(abs(report["total_j"] / sum(per_unit.values()) - 1) <= ENERGY_REL,
          "energy_report total != the requests' sum")
    # every served token against LM.apply on its own prefix
    worst, exact, _ = hold_to_apply(model, params, reqs, prompts, "chip")
    # the routed units' numerics through K1
    B, S = EMU["batch"], EMU["prompt"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    per_fwd = 7 * cfg.n_layers + 1
    numerics = {}
    for phase, unit, style in (("prefill", "sp_fma", "fused"),
                               ("decode", "sp_cma", "cascade_fwd")):
        pol = policy.numerics_for_phase(phase,
                                        precision=cfg.numerics_precision,
                                        emulate=True)
        check(pol.fpu_design.name == unit and pol.fmt.name == "bf16" and
              pol.accum_style == style and pol.emulate,
              f"{phase} routed to {pol.fpu_design.name} "
              f"{pol.fmt.name}/{pol.accum_style}")
        c0 = fused_qmm.launches
        routed, _ = model.prefill(params, toks, policy=pol)
        torch.cuda.synchronize()
        launches = fused_qmm.launches - c0
        check(launches == per_fwd, f"{phase} routed prefill: {launches} K1 "
              f"launches, expected {per_fwd}")
        plain, _ = model.prefill(params, toks,
                                 policy=EmulatedPolicy("bf16", style))
        check(torch.equal(routed, plain), f"{phase} routed prefill differs "
              f"from EmulatedPolicy(bf16, {style})")
        check(bool(torch.isfinite(routed).all()), "non-finite logits")
        numerics[phase] = dict(unit=unit, fmt="bf16", style=style,
                               k1_launches=launches,
                               bitwise_equal_emulated_policy=True)
    n_tok = sum(len(r.output) for r in reqs)
    rr = server.run_report()
    emit({"phase": "chip", "arch": cfg.name, "dtype": cfg.dtype,
          "chip": policy.spec.name, "slots": c["slots"],
          "fleets": {k: list(v) for k, v in server._fleets.items()},
          "requests": len(reqs), "prompt_lens": [int(n) for n in lens],
          "new_tokens": c["new_tokens"], "wall_s": wall,
          "tokens_per_s": n_tok / wall, "dispatches": rr["dispatches"],
          "host_syncs": rr["host_syncs"],
          "routed": {r.uid: r.routed_unit for r in reqs},
          "unit_rel_err": {u.name: u.rel_err() for u in policy.spec.units},
          "unit_e_pj": {u.name: u.e_per_flop_pj for u in policy.spec.units},
          "energy_report": report, "energy_worst_rel_vs_sum": worst_rel,
          "rejected": "accuracy_slo_unmeetable",
          "tokens_checked": n_tok, "tokens_at_apply_argmax": exact,
          "worst_shortfall_over_limit": worst, "numerics": numerics})


# ---------------------------------------------------------------------------
# phases 3d-3e: telemetry and fault-tolerant serving on tinyllama-1.1b
# ---------------------------------------------------------------------------
# each traced and untraced serve of the chip phase's requests runs this
# many times, alternating, for tracing's cost in served tokens/s
TRACE_RUNS = 2
# the resilience phase's fake clock: one tick per scheduler step, and the
# synthetic dispatch time the health monitor reads
TICK = 0.05
RESILIENCE = dict(slots=8, max_len=256, requests=8, prompt_lo=16,
                  prompt_hi=128, new_tokens=32, dispatch_tokens=8)


class FakeClock:
    """The serving clock of the resilience phase: sim seconds, advanced
    by the caller."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def trace_full_width(model, params, tech, dev):
    """The chip phase's 12 requests served under the recording ``Tracer``
    and untraced, in turns: the trace's integrity, one root span a
    request, span energy equal to each request's and to ``energy_report``
    (rel ENERGY_REL), the same tokens traced and untraced, the JSONL round
    trip equal to the tracer and the Chrome trace parsed; then the trace's
    measured phases (``phases_from_trace``) tuned by ``tune_chip`` on the
    card and on the CPU, with identical picks."""
    import dataclasses
    import tempfile
    from repro_torch.core import chip, energy_model, latency_sim
    from repro_torch.telemetry import (Tracer, load_jsonl, phases_from_trace,
                                       summarize_trace, write_chrome_trace,
                                       write_jsonl)
    cfg = model.cfg

    def serve(tracer):
        _, server = chip_server(model, params, tech, tracer=tracer)
        _, _, _, reqs = chip_traffic(cfg, np.random.default_rng(SEED + 2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            server.submit(r)
        server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(r.done and not r.expired for r in reqs),
              "the traced phase did not finish every request")
        return server, reqs, sum(len(r.output) for r in reqs) / wall

    serve(None)  # warm-up: the first run pays for the allocator's growth
    rates = {"untraced": [], "traced": []}
    for _ in range(TRACE_RUNS):
        plain, plain_reqs, rate = serve(None)
        rates["untraced"].append(rate)
        tracer = Tracer()
        server, reqs, rate = serve(tracer)
        rates["traced"].append(rate)
    problems = tracer.check_integrity()
    check(problems == [], f"trace integrity: {problems[:3]}")
    roots = [s for s in tracer.spans if s.is_root]
    check(sorted(s.uid for s in roots) == [r.uid for r in reqs],
          "not one root span per request")
    worst = 0.0
    for r, q in zip(reqs, plain_reqs):
        check(r.output == q.output, f"request {r.uid}: tracing changed its "
              "tokens")
        rel = abs(tracer.request_energy_j(r.uid) / r.energy_j - 1)
        worst = max(worst, rel)
        check(rel <= ENERGY_REL, f"request {r.uid}: span energy "
              f"{tracer.request_energy_j(r.uid)} J, request {r.energy_j} J")
    total = server.energy_report()["total_j"]
    rel = abs(tracer.total_energy_j() / total - 1)
    check(rel <= ENERGY_REL, f"span energy {tracer.total_energy_j()} J, "
          f"energy_report {total} J")
    with tempfile.TemporaryDirectory() as tmp:
        path = write_jsonl(tracer, str(Path(tmp) / "trace.jsonl"))
        back = load_jsonl(path)
        chrome = json.loads(Path(write_chrome_trace(
            tracer, str(Path(tmp) / "trace.json"))).read_text())
        jsonl_bytes = Path(path).stat().st_size
    check([dataclasses.asdict(x) for x in back.spans] ==
          [dataclasses.asdict(x) for x in tracer.spans]
          and back.metrics == tracer.metrics
          and back.system_events == tracer.system_events,
          "the JSONL round trip differs from the tracer")
    slices = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    check(len(slices) == len(tracer.spans), "Chrome trace: "
          f"{len(slices)} slices for {len(tracer.spans)} spans")
    # the measured phases tuned on the card and on the CPU
    phases = phases_from_trace(back, name=cfg.name)
    check([p.name for p in phases] == [f"{cfg.name}:prefill",
                                       f"{cfg.name}:decode"],
          f"phases {[p.name for p in phases]}")

    def picks(res):
        return [(u.name, u.design.name, u.vdd, u.vbb, u.count,
                 u.fmt.name if u.fmt else None) for u in res.spec.units]

    tuned, seconds = {}, {}
    for where in (dev, "cpu"):
        latency_sim.clear_penalty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tuned[str(where)] = chip.tune_chip(
            phases, params=tech, cache=energy_model.SweepExecutableCache(),
            device=where)
        seconds[str(where)] = time.perf_counter() - t0
    on_card, on_cpu = tuned[str(dev)], tuned["cpu"]
    check(picks(on_card) == picks(on_cpu), f"tune_chip on the trace: card "
          f"{picks(on_card)} != CPU {picks(on_cpu)}")
    summary = summarize_trace(back)
    untraced, traced = (float(np.median(rates[k]))
                        for k in ("untraced", "traced"))
    emit({"phase": "trace", "arch": cfg.name, "requests": len(reqs),
          "spans": len(tracer.spans), "events": sum(
              len(x.events) for x in tracer.spans),
          "metric_samples": sum(map(len, tracer.metrics.values())),
          "jsonl_bytes": jsonl_bytes, "chrome_events": len(
              chrome["traceEvents"]),
          "integrity": "clean", "tokens_equal_untraced": True,
          "energy_worst_rel": worst, "energy_total_rel": rel,
          "tokens_per_s": rates, "tokens_per_s_untraced": untraced,
          "tokens_per_s_traced": traced,
          "tracing_cost_share": 1 - traced / untraced,
          "summary": dataclasses.asdict(summary),
          "phases": [dict(name=p.name, flops_fraction=p.flops_fraction,
                          activity=p.profile.activity) for p in phases],
          "tune_chip_units": picks(on_card),
          "tune_chip_seconds": seconds})


def resilient_server(model, params, tech, events=(), **res_kw):
    """A ``ResilientServer`` over the chip phase's die (one fleet per decode
    unit, deadline routing) on a fake clock with synthetic dispatch times
    and a ``FaultInjector`` armed with ``events`` (seeded)."""
    from repro_torch.core import chip
    from repro_torch.faults import FaultInjector
    from repro_torch.serve import ResilienceConfig, ResilientServer
    s = RESILIENCE
    clock = FakeClock()
    policy = chip.ChipPolicy(chip.fabricated_chip(None, tech), tech)
    res_kw.setdefault("probe_interval_s", None)
    server = ResilientServer(
        model, params, slots=s["slots"], max_len=s["max_len"],
        chip_policy=policy, deadline_routing=True,
        dispatch_tokens=s["dispatch_tokens"], clock=clock,
        injector=FaultInjector(events, seed=SEED),
        resilience=ResilienceConfig(synthetic_dispatch_s=TICK, **res_kw))
    return server, clock


def resilience_traffic(cfg, prompts):
    """sp requests, half with a deadline class (a deadline no run reaches):
    bulk ones route to sp_fma, deadline-bound ones to sp_cma."""
    from repro_torch.serve import Request
    return [Request(uid=i, prompt=p, max_new_tokens=RESILIENCE["new_tokens"],
                    precision="sp", deadline_s=1e9 if i % 2 else None)
            for i, p in enumerate(prompts)]


def drive_resilient(server, clock, reqs, max_steps=400, walls=None):
    """Submit ``reqs``, then step one tick at a time until idle (or for
    ``max_steps`` ticks); returns ``walls`` with the wall seconds at each
    tick added (sim time -> wall time)."""
    for r in reqs:
        server.submit(r)
    walls = {clock.t: time.perf_counter()} if walls is None else walls
    for _ in range(max_steps):
        clock.t += TICK
        server.step(server.dispatch_tokens)
        torch.cuda.synchronize()
        walls[clock.t] = time.perf_counter()
        if server.idle():
            break
    return walls


def recovery_walls(report, walls):
    """Each drain's recovery latency in sim seconds (ticks) and in wall
    seconds on the card."""
    out = []
    for f in report["fault_log"]:
        if not f["requests_drained"]:
            continue
        det, rec = f["detected_s"], f["recovered_s"]
        out.append(dict(unit=f["unit"], kind=f["kind"],
                        drained=f["requests_drained"],
                        sim_s=None if rec is None else rec - det,
                        wall_s=None if rec is None else
                        walls.get(rec, np.nan) - walls.get(det, np.nan)))
    return out


def resilience_full_width(cfg, params, tech, dev):
    """Fault-tolerant serving of tinyllama-1.1b at full width, in float32
    (the bf16 weights widened, exactly): a fleet killed mid-run (no request
    lost; the drained ones resume on the other sp fleet, each resumed
    stream compared with an uninterrupted run of the same server: bitwise,
    or parting first at a near tie of ``LM.apply``; every token within
    NEAR_TIE of ``LM.apply``); transient corruption retried with backoff
    (no corrupt token committed); a throttle detected and repriced; every
    fleet killed, the requests parked and brought back by a probe.  Then
    ``ReferenceServer`` serves the serve phase's 8 requests on the bf16
    weights, held to NEAR_TIE."""
    import dataclasses
    from repro_torch.core.chip import UnitHealth
    from repro_torch.faults import FaultEvent, FaultInjector, FaultKind
    from repro_torch.models import LM
    from repro_torch.serve import ReferenceServer, Request
    s = RESILIENCE
    model = LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
    wide = tree_map(lambda t: t.float(), params)
    rng = np.random.default_rng(SEED + 4)
    lens = rng.integers(s["prompt_lo"], s["prompt_hi"] + 1, s["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    out = {}

    def run(events=(), **kw):
        server, clock = resilient_server(model, wide, tech, events, **kw)
        reqs = resilience_traffic(cfg, prompts)
        t0 = time.perf_counter()
        walls = drive_resilient(server, clock, reqs)
        wall = time.perf_counter() - t0
        check(all(r.done and not r.expired and not r.rejected and
                  len(r.output) == s["new_tokens"] for r in reqs),
              "requests lost or cut: "
              f"{[(r.uid, len(r.output), r.done) for r in reqs]}")
        bad = [r.uid for r in reqs
               if FaultInjector.CORRUPT_TOKEN in r.output]
        check(not bad, f"a corrupt token was committed to {bad}")
        return server, reqs, walls, sum(len(r.output) for r in reqs) / wall

    # the uninterrupted run (twice: the first warms the float32 model up),
    # then sp_fma killed at its third tick
    run()
    base, base_reqs, _, base_rate = run()
    routed = [r.routed_unit for r in base_reqs]
    check(sorted(set(routed)) == ["sp_cma", "sp_fma"], f"routes {routed}")
    kill = FaultEvent(at_s=3 * TICK, unit="sp_fma", kind=FaultKind.KILL)
    server, reqs, walls, rate = run((kill,))
    rep = server.resilience_report()
    check(rep["health"]["sp_fma"]["status"] == UnitHealth.DEAD,
          "the killed fleet is not dead")
    moved = [r for r in reqs if r.requeues]
    check(moved and all(r.routed_unit == "sp_cma" for r in moved),
          f"drained requests resumed on {[r.routed_unit for r in moved]}")
    worst, exact, margins = hold_to_apply(model, wide, reqs, prompts,
                                          "resumed")
    resumed = {}
    for r, b in zip(reqs, base_reqs):
        split = next((i for i, (x, y) in enumerate(zip(r.output, b.output))
                      if x != y), len(b.output))
        gap = None if split == len(b.output) else float(margins[r.uid][split])
        check(gap is None or gap <= NEAR_TIE, f"request {r.uid}: the "
              f"resumed stream parts from the uninterrupted one at token "
              f"{split}, where LM.apply's top two logits are {gap} of max "
              f"|logit| apart (a near tie is within {NEAR_TIE})")
        if r.requeues:
            resumed[r.uid] = dict(bitwise=split == len(b.output),
                                  parting=split, gap=gap,
                                  requeues=r.requeues)
    out["kill"] = dict(report=rep, recovery=recovery_walls(rep, walls),
                       resumed=resumed, tokens_per_s=rate,
                       uninterrupted_tokens_per_s=base_rate,
                       worst_shortfall_over_limit=worst,
                       tokens_at_apply_argmax=exact)

    # transient corruption on sp_fma: retried on the same fleet
    corrupt = FaultEvent(at_s=3 * TICK, unit="sp_fma",
                         kind=FaultKind.CORRUPT, duration_s=3 * TICK,
                         magnitude=1.0)
    server, reqs, walls, rate = run((corrupt,), backoff_base_s=2 * TICK,
                                    probe_interval_s=1.0)
    rep = server.resilience_report()
    check(sum(rep["corrupt_dispatches"].values()) >= 1 and
          server.wasted_energy_j > 0, "the corruption went unseen")
    check(rep["health"]["sp_fma"]["in_service"], "a transient corruption "
          "took sp_fma out of service")
    hold_to_apply(model, wide, reqs, prompts, "corrupted")
    out["corrupt"] = dict(report=rep, recovery=recovery_walls(rep, walls),
                          wasted_energy_j=server.wasted_energy_j,
                          tokens_per_s=rate)

    # a throttle on sp_fma: detected from dispatch times, repriced
    throttle = FaultEvent(at_s=2 * TICK, unit="sp_fma",
                          kind=FaultKind.THROTTLE, magnitude=0.5)
    server, reqs, walls, rate = run((throttle,))
    pol = server.chip_policy
    unit = pol.spec.unit("sp_fma")
    rep = server.resilience_report()
    health = rep["health"]["sp_fma"]
    check(health["status"] == UnitHealth.THROTTLED, "the throttle went "
          "undetected")
    j_per_flop = pol.unit_energy_j(unit, 1.0)
    j_healthy = unit.energy_j(1.0)
    check(j_per_flop > j_healthy, f"throttled sp_fma costs {j_per_flop} "
          f"J/FLOP, healthy {j_healthy}")
    out["throttle"] = dict(report=rep, j_per_flop=j_per_flop,
                           j_per_flop_healthy=j_healthy, tokens_per_s=rate)

    # every fleet killed: the requests park, a probe brings them back
    kills = tuple(FaultEvent(at_s=2 * TICK, unit=u, kind=FaultKind.KILL,
                             duration_s=4 * TICK)
                  for u in ("sp_fma", "sp_cma", "dp_fma", "dp_cma"))
    server, clock = resilient_server(model, wide, tech, kills,
                                     probe_interval_s=6 * TICK)
    reqs = resilience_traffic(cfg, prompts)
    # up to the first probe, 6 ticks after the kills: every fleet dies
    # within these, and nothing is in service to take the requests
    walls = drive_resilient(server, clock, reqs, max_steps=7)
    parked = len(server._parked)
    check(parked == len(reqs), f"{parked} of {len(reqs)} requests parked")
    walls = drive_resilient(server, clock, [], walls=walls)
    check(all(r.done and len(r.output) == s["new_tokens"] for r in reqs),
          "parked requests did not finish")
    hold_to_apply(model, wide, reqs, prompts, "parked")
    rep = server.resilience_report()
    out["kill_all"] = dict(report=rep, parked=parked,
                           recovery=recovery_walls(rep, walls))
    del model, wide
    release()

    # the per-token ReferenceServer on the bf16 weights
    ref_model = LM(cfg, device=dev)
    srng = np.random.default_rng(SEED)
    sl = srng.integers(SERVE["prompt_lo"], SERVE["prompt_hi"] + 1,
                       SERVE["requests"])
    sprompts = [srng.integers(0, cfg.vocab_size, n) for n in sl]
    server = ReferenceServer(ref_model, params, slots=SERVE["slots"],
                             max_len=SERVE["max_len"])
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVE["new_tokens"])
            for i, p in enumerate(sprompts)]
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run()
    wall = time.perf_counter() - t0
    check(len(done) == len(reqs) and all(
        len(r.output) == SERVE["new_tokens"] for r in reqs),
        "ReferenceServer did not finish every request")
    worst, exact, _ = hold_to_apply(ref_model, params, reqs, sprompts,
                                    "ReferenceServer")
    out["reference_server"] = dict(
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        worst_shortfall_over_limit=worst, tokens_at_apply_argmax=exact,
        tokens_checked=sum(len(r.output) for r in reqs))
    emit({"phase": "resilience", "arch": cfg.name, "dtype": "float32",
          "slots": s["slots"], "requests": len(prompts),
          "new_tokens": s["new_tokens"], "tick_s": TICK, **out})


def serve_f32(cfg, params, dev, **kw):
    """The served-token check of ``serve_full_width`` (``kw``: its request
    options) on the same model and requests computed in float32 (the bf16
    weights widened, exactly), held to NEAR_TIE itself.  In bf16 the
    model's own rounding noise at this depth is above NEAR_TIE (the bf16
    run measures it), so here the serving, state and chunking logic is all
    the tight limit can see."""
    import dataclasses
    from repro_torch.models import LM
    model = LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
    wide = tree_map(lambda t: t.float(), params)
    rec = serve_full_width(model, wide, np.random.default_rng(SEED + 1),
                           **kw)
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
# phases 4a-4c: the hybrid, MoE and sliding-window families at full width
# ---------------------------------------------------------------------------
HYBRID_ARCH = "zamba2-1.2b"
MOE_ARCH = "deepseek-moe-16b"
WINDOW_ARCH = "mixtral-8x7b"
# the hybrid's chunked server: the engine rounds the chunk up to the scan's
# 64-token carry points
HYBRID_CHUNK = 64
# mixtral-8x7b's 32 layers hold ~93 GB of bf16 weights, more than one
# H100's 80 GB: the window phase keeps every width and cuts the depth
WINDOW_LAYERS = 4
# prompts below, just under and beyond the 4096-token window; 32 new
# tokens take the 4090-token prompt across the window's edge in decode
WINDOW_SERVE = dict(slots=4, max_len=4096 + 512, new_tokens=32)
WINDOW_LENS = (700, 4090, 4200, 2500)
# one prefill_chunked of this many tokens in chunks of this size: the last
# chunk (4000-4599) crosses the window's edge at 4096
WINDOW_CHUNKED = dict(prompt=4600, chunk=1000)
# prefill_chunked against prefill in float32: the last logits, and each
# layer's ring, within this share of their max |value| (the chunk's
# attention and the monolithic forward sum in other orders; the readings on
# an H100 are 5.9e-6 for the logits and about 1e-5 for the rings, and the
# bound predicted before any reading was 1e-4)
CHUNKED_F32 = 1e-4


def init_model(cfg, dev, **record):
    """The model and its random bf16 parameters, with an ``init`` record
    (``record``: what else to print, such as a cut of depth)."""
    from repro_torch.models import LM
    model = LM(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "seconds":
          time.perf_counter() - t0, "parameters": sum(
              t.numel() for t in tree_leaves(params)),
          "device_bytes": torch.cuda.memory_allocated(), **record})
    return model, params


def release():
    """Return the card memory of what the caller has dropped."""
    gc.collect()
    torch.cuda.empty_cache()


def emulated_forwards(model, params, rng, per_fwd, steps=4, embeds=False):
    """One EMU-shaped prefill and ``steps`` decode steps under
    EmulatedPolicy(bf16, fused): every forward launches K1 ``per_fwd``
    times (the attention projections, the dense MLPs and the unembed; no
    Mamba projection, expert or router), and the logits are finite.  With
    ``embeds`` the prefill takes the family's embedding inputs (``vlm``:
    the prefix before the tokens; ``audio``: frames in place of them)."""
    from repro_torch.kernels.fused import fused_qmm
    from repro_torch.models.numerics import EmulatedPolicy
    cfg, dev = model.cfg, model.device
    pol = EmulatedPolicy("bf16", "fused")
    B, S = EMU["batch"], EMU["prompt"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    kw = {}
    if embeds:
        toks, kw = embed_inputs(model, params, B, S, SEED + 7)
        if cfg.family == "vlm":
            S += cfg.n_prefix_tokens
    c0 = fused_qmm.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, toks, max_len=S + steps + 1,
                                policy=pol, **kw)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    got = fused_qmm.launches - c0
    check(got == per_fwd, f"{cfg.name} emulated prefill: {got} K1 launches, "
          f"expected {per_fwd}")
    check(bool(torch.isfinite(last).all()), "non-finite emulated logits")
    cache = model.cache_at_length(cache, torch.full((B,), S))
    c1 = fused_qmm.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, tok, _, _, stream, _ = model.decode_scan(
        params, cache, torch.argmax(last, dim=-1)[:, None],
        torch.ones(B, dtype=torch.bool, device=dev),
        torch.full((B,), steps, dtype=torch.int64, device=dev), steps,
        policy=pol)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    got = fused_qmm.launches - c1
    check(got == steps * per_fwd, f"{cfg.name} emulated decode: {got} K1 "
          f"launches, expected {steps * per_fwd}")
    native, _ = model.prefill(params, toks, max_len=S + 1, **kw)
    emit({"phase": "emulated", "arch": cfg.name, "policy": "bf16/fused",
          "batch": B, "prompt": S, "inputs": sorted(kw) or ["tokens"],
          "decode_steps": steps,
          "k1_launches_per_forward": per_fwd, "prefill_s": t_prefill,
          "decode_s": t_decode, "decode_tokens_per_s": B * steps / t_decode,
          "rel_gap_to_native_bf16": float((last - native).abs().max()
                                          / native.abs().max())})


def chunked_server(model, params, mono):
    """The monolithic server's requests again through a server that
    prefills in HYBRID_CHUNK-token chunks: every ``serve_full_width`` gate
    on its streams (greedy_decode's were held in the monolithic run), and
    wherever a chunked stream parts from the monolithic one, the
    single-lane decode path puts the two picks within the chunked run's
    parting limit (twice the lanes' gap plus the chunked prefill's)."""
    rec = serve_full_width(model, params, np.random.default_rng(SEED + 1),
                           noise_floor=True, prefill_chunk=HYBRID_CHUNK,
                           parting_on_decode=True, greedy=mono["greedy"])
    check(rec["prefill_chunk"] == HYBRID_CHUNK, "chunk not on the scan's "
          "carry points")
    limit = rec["parting_limit_on_decode"]
    parts, gaps, same = [], [], 0
    for prompt, got, want in zip(rec["prompts"], rec["outputs"],
                                 mono["outputs"]):
        split = next((i for i, (x, y) in enumerate(zip(got, want))
                      if x != y), len(want))
        parts.append(split)
        same += sum(int(x == y) for x, y in zip(got, want))
        if split < len(want):
            gaps.append(decode_parting(model, params, prompt, want, split,
                                       got[split], SERVE["max_len"]))
            check(gaps[-1] <= limit, f"the chunked server parts from the "
                  f"monolithic one at token {split}, where the decode path "
                  f"puts their picks {gaps[-1]} of max |logit| apart "
                  f"(limit {limit})")
    emit({"phase": "serve_chunked_vs_monolithic", "arch": model.cfg.name,
          "prefill_chunk": HYBRID_CHUNK, "tokens": sum(map(len, mono[
              "outputs"])), "tokens_equal": same,
          "agreeing_prefix": parts, "parting_limit_on_decode": limit,
          "parting_gaps_on_decode": gaps})


def hybrid_path(dev, drive, rng):
    """zamba2-1.2b at full width and depth: served in bf16 (monolithic and
    chunked, held to twice the model's own bf16 noise floor) and in
    float32 (held to NEAR_TIE), one emulated prefill and decode with 37 K1
    launches per forward (six shared-block projections per application,
    six applications, and the unembed), and a profile of one decode
    step."""
    from repro_torch.configs.base import get_config
    cfg = get_config(HYBRID_ARCH)
    model, params = init_model(cfg, dev)
    per_fwd = 6 * model.n_shared_applications + 1
    mono = {}
    drive(HYBRID_ARCH, ("fused_qmm",),
          lambda: mono.update(serve_full_width(
              model, params, np.random.default_rng(SEED + 1),
              noise_floor=True, parting_on_decode=True)),
          lambda: chunked_server(model, params, mono),
          lambda: serve_f32(cfg, params, dev),
          lambda: emulated_forwards(model, params, rng, per_fwd))
    profile_decode(model, params, rng)


def prefill_batches(tracer):
    """Each monolithic prefill the server ran, from its recorded trace:
    {(time, bucket): the requests' uids in the order of the batch's rows}.
    The engine opens each row's attempt span, and records its PREFILL event
    there, in row order."""
    from repro_torch.telemetry import Event
    batches = {}
    for span in tracer.spans:
        for etype, t, attrs in span.events:
            if etype == Event.PREFILL:
                batches.setdefault((t, attrs["bucket"]), []).append(
                    span.uid)
    return batches


def moe_layer0_input(model, params, toks):
    """The input of layer 0's MoE in a forward over ``toks``: the block's
    first half, as ``attn_block_apply`` computes it."""
    from repro_torch.models.flash_vjp import flash_attention_trainable
    from repro_torch.models.layers import embed_apply, rmsnorm
    from repro_torch.models.model import _layer, _qkv
    from repro_torch.models.numerics import matmul
    cfg = model.cfg
    p = _layer(params["layers"], 0)
    x = embed_apply(params["embed"], toks)
    B, S = toks.shape
    positions = torch.arange(S, device=toks.device)[None, :]
    q, k, v = _qkv(p, rmsnorm(p["ln1"], x), cfg, positions, None)
    attn = flash_attention_trainable(q, k, v, causal=True, window=cfg.window)
    x = x + matmul(attn.reshape(B, S, -1), p["wo"], None)
    return rmsnorm(p["ln2"], x)


def serve_with_drops(model, params, nodrop):
    """The no-drop run's requests at the config's capacity factor: the
    dropped share of every prefill forward and how many served tokens
    differ from the no-drop run, as numbers (which entries drop depends on
    every token the forward carries, pads included).  Each prefill's
    shares are ``LM.apply(moe_stats=True)`` on the server's own batch,
    rebuilt from the server's recorded ``Tracer`` (bitwise the server's
    forward: the MoE is deterministic, see ``moe_determinism``).  A decode
    step carries ``slots`` tokens, within the capacity's floor, so none
    can drop.
    Returns the input of layer 0's MoE in the prefill with the most
    tokens."""
    from repro_torch.models import moe
    from repro_torch.models.model import _layer
    from repro_torch.serve import BatchedServer, Request
    from repro_torch.telemetry import Tracer
    cfg, dev, s = model.cfg, model.device, SERVE
    tracer = Tracer()
    server = BatchedServer(model, params, slots=s["slots"],
                           max_len=s["max_len"], tracer=tracer)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=s["new_tokens"])
            for i, p in enumerate(nodrop["prompts"])]
    for r in reqs:
        server.submit(r)
    server.run()
    check(all(r.done and len(r.output) == s["new_tokens"] for r in reqs),
          "the capacity-factor server did not finish every request")
    check(moe.capacity(s["slots"], cfg.experts_per_token, cfg.n_experts,
                       cfg.capacity_factor) >= s["slots"],
          "a decode step could drop")
    check(tracer.check_integrity() == [], "the MoE server's trace is not "
          "clean")
    batches = prefill_batches(tracer)
    shares, sizes, biggest = [], [], None
    for (_, bucket), uids in batches.items():
        toks = np.full((len(uids), bucket), server.pad_id, np.int64)
        for row, uid in enumerate(uids):
            prompt = nodrop["prompts"][uid]
            toks[row, :len(prompt)] = prompt
        toks = torch.as_tensor(toks, device=dev)
        _, aux = model.apply(params, toks, logits_last_only=True,
                             moe_stats=True)
        shares.append(aux["dropped_frac"])
        sizes.append(toks.numel())
        if biggest is None or toks.numel() > biggest[0].numel():
            biggest = (toks, aux["dropped_frac"][0])
    x = moe_layer0_input(model, params, biggest[0])
    _, aux = moe.moe_apply(_layer(params["layers"], 0)["moe"], x,
                           top_k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor)
    check(torch.equal(aux["dropped_frac"], biggest[1]), "layer 0's MoE "
          "input is not the forward's")
    differ = [sum(int(x != y) for x, y in zip(r.output, want))
              for r, want in zip(reqs, nodrop["outputs"])]
    emit({"phase": "moe_drops", "arch": cfg.name,
          "capacity_factor": cfg.capacity_factor,
          "prefill_forwards": len(sizes), "prefill_tokens_per_forward": sizes,
          "prefill_dropped_share": [float(d.mean()) for d in shares],
          "prefill_dropped_share_by_layer": [d.tolist() for d in shares],
          "decode_dropped_share": 0.0,
          "tokens": sum(map(len, nodrop["outputs"])),
          "tokens_differing_from_no_drop_run": differ})
    return x


def moe_determinism(model, params, rng):
    """Two identical 4x128 prefills (drops included) give the same bits:
    last logits and the float8 KV cache."""
    cfg, dev = model.cfg, model.device
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                           device=dev)
    (l1, c1), (l2, c2) = (model.prefill(params, toks) for _ in range(2))
    same = torch.equal(l1, l2) and all(
        torch.equal(c1.data[k].view(torch.uint8), c2.data[k].view(
            torch.uint8)) for k in ("k", "v"))
    check(same, "two identical MoE prefills differ")
    emit({"phase": "check", "what": "two identical 4x128 prefills, bitwise",
          "arch": cfg.name, "capacity_factor": cfg.capacity_factor,
          "equal": True})


def moe_layer0_vs_cpu(model, params, x):
    """Layer 0's MoE on the card against the same layer on the CPU, on its
    input from the served prefill with the most tokens: the picks, the keep
    mask, the slots and the tokens identical, two card runs bitwise equal,
    the output within NEAR_TIE * max |out| (the experts' bf16 products sum
    in another order on the CPU; each output is a few rounded adds of
    those)."""
    from repro_torch.models import moe
    from repro_torch.models.model import _layer
    cfg = model.cfg
    kw = dict(top_k=cfg.experts_per_token,
              capacity_factor=cfg.capacity_factor)
    card = _layer(params["layers"], 0)["moe"]
    cpu = tree_map(lambda t: t.cpu(), card)
    xf = x.reshape(-1, cfg.d_model)
    got = moe.route(card["router"], xf, **kw)
    want = moe.route(cpu["router"], xf.cpu(), **kw)
    for name in ("top_i", "keep", "slot", "tok"):
        check(torch.equal(getattr(got, name).cpu(), getattr(want, name)),
              f"layer-0 MoE {name} differ between the card and the CPU")
    check(got.cap == want.cap, "capacities differ")
    out1, aux = moe.moe_apply(card, x, **kw)
    out2, _ = moe.moe_apply(card, x, **kw)
    check(torch.equal(out1, out2), "layer-0 MoE differs between two runs")
    ref, aux_cpu = moe.moe_apply(cpu, x.cpu(), **kw)
    err = float((out1.cpu().float() - ref.float()).abs().max())
    limit = NEAR_TIE * float(ref.float().abs().max())
    check(err <= limit, f"layer-0 MoE card vs CPU: {err} > {limit}")
    emit({"phase": "check", "what": "layer-0 MoE, card vs CPU", "arch":
          cfg.name, "tokens": xf.shape[0], "capacity": got.cap,
          "dropped_share": float(aux["dropped_frac"]),
          "dropped_share_cpu": float(aux_cpu["dropped_frac"]),
          "picks_keep_slots_equal": True, "deterministic": True,
          "max_abs_err": err, "limit": limit,
          "entries_differing": int((out1.cpu() != ref).sum())})


def moe_f32(cfg, box, dev):
    """The moe phase's served-token check in float32 at full depth, at
    ``capacity_factor = n_experts``, with a float32 KV cache: every token,
    and greedy_decode's, within NEAR_TIE of ``LM.apply`` on its prefix.
    The config's fp8 cache is left out here: it rounds the last-bit
    differences between the server's batched shapes and a one-sequence
    reference to whole fp8 steps (an e4m3 step is 6-12% of a value), and
    at 28 layers that moved one served token of 256 to 9.2% of max |logit|
    short of the single-lane decode path (chip run 1 of PR 20's review).
    ``box`` holds the only reference to the bf16 parameters: they are
    widened (exactly) one leaf at a time, largest first, each bf16 leaf
    freed once widened."""
    import dataclasses
    from repro_torch.models import LM
    model = LM(dataclasses.replace(cfg, dtype="float32", kv_cache_dtype=None,
                                   capacity_factor=float(cfg.n_experts)),
               device=dev)
    params = box.pop()
    leaves = []

    def collect(tree):
        for key, t in tree.items():
            if isinstance(t, dict):
                collect(t)
            else:
                leaves.append((tree, key))

    collect(params)
    torch.cuda.reset_peak_memory_stats()
    for tree, key in sorted(leaves, key=lambda e: -e[0][e[1]].numel()):
        tree[key] = tree[key].float()
        release()
    widened = torch.cuda.max_memory_allocated()
    emit({"phase": "init", "arch": cfg.name, "dtype": "float32",
          "device_bytes": torch.cuda.memory_allocated(),
          "peak_bytes_while_widening": widened})
    serve_full_width(model, params, np.random.default_rng(SEED + 1))
    emit({"phase": "memory", "arch": cfg.name, "dtype": "float32",
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "card_bytes": torch.cuda.get_device_properties(dev).total_memory})
    del model, params
    release()


def moe_path(dev, drive, rng):
    """deepseek-moe-16b at full width and depth (fp8 KV cache).  The served
    tokens are gated on the same weights at ``capacity_factor =
    n_experts``, at which nothing can drop: at the config's 1.25 which
    tokens drop depends on the batch's composition, so a one-sequence
    reference says nothing of a batched server's tokens.  The reference is
    ``LM.apply``, held in float32 with a float32 cache within NEAR_TIE as
    the phase's last step (``serve_full_width`` gates no bf16 MoE token;
    the bf16 run on the fp8 cache is timed).
    At 1.25 the same requests are served and their dropped shares and
    token differences printed; two identical prefills must be bitwise
    equal; one emulated prefill makes 113 K1 launches; layer 0's MoE is
    held to the CPU."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    cfg = get_config(MOE_ARCH)
    model, params = init_model(cfg, dev)
    nodrop = LM(dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts)), device=dev)
    per_fwd = 4 * cfg.n_layers + 1
    rec = {}
    drive(MOE_ARCH, ("fused_qmm",),
          lambda: rec.update(serve_full_width(
              nodrop, params, np.random.default_rng(SEED + 1))),
          lambda: rec.update(layer0=serve_with_drops(model, params, rec)),
          lambda: moe_determinism(model, params, rng),
          lambda: emulated_forwards(model, params, rng, per_fwd))
    moe_layer0_vs_cpu(model, params, rec.pop("layer0"))
    profile_decode(model, params, rng)
    box = [params]
    del model, nodrop, params, rec
    release()
    moe_f32(cfg, box, dev)


def window_chunked(model, params):
    """``prefill_chunked`` of WINDOW_CHUNKED's prompt against ``prefill``.
    In bf16 (the model's own dtype), layer 0's ring (k and v) bitwise
    equal: each position of the window at slot p % 4096.  In float32 the
    last logits and every layer's ring within CHUNKED_F32 of their max
    |value|.  The rest is printed.  The two are not bitwise on the card:
    the chunk's attention sums over the ring's 4096 slots and the chunk in
    one block, the monolithic forward over 1024-key blocks, and cuBLAS and
    CUDA's reductions pick their order by shape (in float32 already layer
    0's projections differ in the last bit; in bf16 their rounding absorbs
    that); in bf16 a last-bit difference can move a token to another
    expert, so there the logits' and later rings' gaps are printed only."""
    cfg, dev = model.cfg, model.device
    S, C = WINDOW_CHUNKED["prompt"], WINDOW_CHUNKED["chunk"]
    toks = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (1, S)), device=dev)
    last_m, cm = model.prefill(params, toks, max_len=S)
    last_c, cc = model.prefill_chunked(params, toks, C, max_len=S)
    check(cm.data["k"].shape[2] == cfg.window, "the cache is not a ring")
    f32 = cfg.dtype == "float32"
    rings = {name: [float((cc.data[name][i].float() - cm.data[name][i]
                           .float()).abs().max()
                          / cm.data[name][i].float().abs().max())
                    for i in range(cfg.n_layers)] for name in ("k", "v")}
    for name, gaps in rings.items():
        check(gaps[0] == 0.0 or f32, f"layer 0's ring {name} differs "
              f"between prefill_chunked and prefill")
        check(max(gaps) <= CHUNKED_F32 or not f32, f"prefill_chunked vs "
              f"prefill: ring {name} {gaps} of max |{name}| apart, more "
              f"than {CHUNKED_F32}")
    gap = float((last_c - last_m).abs().max() / last_m.abs().max())
    check(gap <= CHUNKED_F32 or not f32, f"prefill_chunked vs prefill: "
          f"last logits {gap} of max |logit| apart, more than {CHUNKED_F32}")
    emit({"phase": "window_prefill_chunked", "arch": cfg.name,
          "dtype": cfg.dtype, "prompt": S, "chunk": C, "ring": cfg.window,
          "ring_rel_gap_by_layer": rings,
          "logits_bitwise": bool(torch.equal(last_c, last_m)),
          "last_logits_rel_gap": gap,
          "limit": CHUNKED_F32 if f32 else None})


def window_f32(cfg, params, dev):
    """The window phase's serving check and chunked prefill in float32
    (the bf16 weights widened, exactly), held to NEAR_TIE."""
    import dataclasses
    from repro_torch.models import LM
    model = LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
    wide = tree_map(lambda t: t.float(), params)
    serve_full_width(model, wide, np.random.default_rng(SEED + 1),
                     spec=WINDOW_SERVE, lens=WINDOW_LENS)
    window_chunked(model, wide)
    del model, wide
    release()


def window_path(dev, drive, rng):
    """mixtral-8x7b at full width, its depth cut to WINDOW_LAYERS, with its
    4096-slot ring KV cache, at ``capacity_factor = n_experts`` (nothing
    drops): prompts shorter and longer than the window served in float32
    (held to NEAR_TIE) and bf16 (printed), decode past the
    window's edge, a ``prefill_chunked`` across that edge, one emulated
    prefill and decode (4 projections a layer and the unembed through K1),
    and a profile of one decode step."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(WINDOW_ARCH)
    cfg = dataclasses.replace(full, n_layers=WINDOW_LAYERS,
                              capacity_factor=float(full.n_experts))
    model, params = init_model(cfg, dev, reduced={
        "n_layers": [full.n_layers, WINDOW_LAYERS],
        "why": "32 layers of bf16 weights (~93 GB) exceed one H100's 80 GB"})
    per_fwd = 4 * WINDOW_LAYERS + 1
    drive(f"{WINDOW_ARCH} window", ("fused_qmm",),
          lambda: serve_full_width(
              model, params, np.random.default_rng(SEED + 1),
              noise_floor=True, spec=WINDOW_SERVE, lens=WINDOW_LENS),
          lambda: window_chunked(model, params),
          lambda: window_f32(cfg, params, dev),
          lambda: emulated_forwards(model, params, rng, per_fwd))
    profile_decode(model, params, rng)


# ---------------------------------------------------------------------------
# phase 4d: the vlm and audio families at full width and depth
# ---------------------------------------------------------------------------
VLM_ARCH = "internvl2-1b"
AUDIO_ARCH = "musicgen-large"
# the embedding-input checks: prompt tokens after the prefix (vlm), frames
# (audio), and decode steps after the prefill
VLM_EMBEDS = dict(batch=2, prompt=64, steps=8)
AUDIO_EMBEDS = dict(batch=2, frames=512, steps=8)


def embed_inputs(model, params, batch, length, seed):
    """The family's embedding input drawn from a ``torch.Generator`` at the
    token table's scale: (tokens or None, apply/prefill kwargs).  vlm:
    ``n_prefix_tokens`` patch embeddings in front of ``length`` tokens;
    audio: ``length`` frame embeddings."""
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scale = float(params["embed"].float().std())
    if cfg.family == "vlm":
        toks = torch.randint(0, cfg.vocab_size, (batch, length),
                             generator=gen, device=dev)
        emb = torch.randn((batch, cfg.n_prefix_tokens, cfg.d_model),
                          generator=gen, device=dev) * scale
        return toks, {"prefix_embeds": emb.to(model.dtype)}
    emb = torch.randn((batch, length, cfg.d_model), generator=gen,
                      device=dev) * scale
    return None, {"frame_embeds": emb.to(model.dtype)}


def embeds_decode(model, params, toks, kw, steps, max_len):
    """``prefill`` of the embedding inputs and ``steps`` greedy
    ``decode_step``s: (the stream (B, steps + 1), the logits that picked
    it (B, steps + 1, V), the cache, seconds of the prefill and of the
    decode steps)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, toks, max_len=max_len, **kw)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    rows = [last]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(
            params, cache, torch.argmax(rows[-1], dim=-1)[:, None])
        rows.append(logits[:, -1])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    rows = torch.stack(rows, 1).float()
    return rows.argmax(-1), rows, cache, t_prefill, t_decode


def embeds_vs_apply(model, params, toks, kw, stream):
    """``LM.apply`` on the same embedding inputs and tokens: for each
    position of ``stream`` (B, T), how far its token's logit falls short
    of the top one, max |logit| there, both (B, T) float32, and the logits
    (B, T, V).  A generated token enters as its table row: for audio the
    frames and the rows go in as one ``frame_embeds``."""
    fed = stream[:, :-1]
    n_new = stream.shape[1]
    if model.cfg.family == "audio":
        frames = torch.cat([kw["frame_embeds"],
                            params["embed"][fed].to(model.dtype)], dim=1)
        logits, _ = model.apply(params, frame_embeds=frames)
    else:
        logits, _ = model.apply(params, torch.cat([toks, fed], dim=1),
                                prefix_embeds=kw["prefix_embeds"])
    pos = logits[:, -n_new:].float()
    top = pos.max(-1).values
    shortfall = top - pos.gather(-1, stream[..., None])[..., 0]
    return shortfall, pos.abs().max(-1).values, pos


def embeds_check(model, params, spec, seed, gate=True):
    """``embeds_decode`` on the family's embedding inputs, each token held
    to NEAR_TIE of ``LM.apply``'s top logit (printed only with ``gate``
    False); returns the record and the inputs."""
    B = spec["batch"]
    length = spec.get("prompt", spec.get("frames"))
    toks, kw = embed_inputs(model, params, B, length, seed)
    S = length + (model.cfg.n_prefix_tokens
                  if model.cfg.family == "vlm" else 0)
    stream, rows, cache, t_prefill, t_decode = embeds_decode(
        model, params, toks, kw, spec["steps"], S + spec["steps"] + 1)
    check(int(cache.length) == S + spec["steps"], "the cache length does "
          "not count the prefix")
    shortfall, scale, pos = embeds_vs_apply(model, params, toks, kw, stream)
    share = (shortfall / scale).flatten()
    # how far the prefill and decode path's logits lie from LM.apply's
    gap = ((rows - pos).abs().max(-1).values / scale).flatten()
    if gate:
        bad = int((share > NEAR_TIE).sum())
        check(bad == 0, f"{model.cfg.name}: {bad} tokens fall short of "
              f"LM.apply's top logit by more than {NEAR_TIE} of max |logit| "
              f"(worst {float(share.max())})")
    rec = {"batch": B, "prompt": length, "positions": S,
           "decode_steps": spec["steps"], "prefill_s": t_prefill,
           "decode_s": t_decode, "decode_tokens_per_s":
           B * spec["steps"] / t_decode,
           "shortfall_share_of_max_logit": share.tolist(),
           "median_shortfall_share": float(share.median()),
           "decode_vs_apply_rel_logit_gap": gap.tolist(),
           "median_decode_vs_apply_gap": float(gap.median()),
           "tokens_at_apply_argmax": int((shortfall == 0).sum()),
           "gated": gate, "limit": NEAR_TIE if gate else None}
    return rec, (toks, kw)


def vlm_path(dev, drive, rng):
    """internvl2-1b at full width and depth: 256 prefix embeddings before
    64 tokens, prefilled and decoded 8 steps (each token within NEAR_TIE of
    ``LM.apply`` on the same embeddings and tokens), the serve phase's 8
    requests served as a token LM under the same gate, one emulated 4x128
    prefill with the prefix and 4 decode steps (169 K1 launches a forward:
    seven projections a layer and the unembed), and a profile of one
    decode step."""
    from repro_torch.configs.base import get_config
    cfg = get_config(VLM_ARCH)
    model, params = init_model(cfg, dev)
    per_fwd = 7 * cfg.n_layers + 1
    rec = {}

    def check_embeds():
        rec.update(embeds_check(model, params, VLM_EMBEDS, SEED + 5)[0])
        emit({"phase": "vlm_audio", "arch": cfg.name, "dtype": cfg.dtype,
              "input": "prefix_embeds", **rec})

    drive(VLM_ARCH, ("fused_qmm",), check_embeds,
          lambda: serve_full_width(model, params,
                                   np.random.default_rng(SEED + 1)),
          lambda: emulated_forwards(model, params, rng, per_fwd,
                                    embeds=True))
    profile_decode(model, params, rng)


def fp8_cache_vs_cpu(model, params, kw):
    """Layer 0's float8 cache after a prefill of the frames, against the
    CPU's ``to_cache`` of the same K/V (the card's layer-0 projections, as
    ``attn_block_apply`` computes them): bitwise."""
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import _layer, _qkv, to_cache
    cfg = model.cfg
    frames = kw["frame_embeds"]
    _, cache = model.prefill(params, None, frame_embeds=frames)
    p = _layer(params["layers"], 0)
    x = frames.to(model.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    _, k, v = _qkv(p, rmsnorm(p["ln1"], x), cfg, positions, None)
    out = {}
    for name, t in (("k", k), ("v", v)):
        want = to_cache(t.cpu(), torch.float8_e4m3fn).view(torch.uint8)
        got = cache.data[name][0].cpu().view(torch.uint8)
        out[name] = int((got != want).sum())
        check(out[name] == 0, f"layer 0's fp8 {name} cache: {out[name]} "
              "entries differ from the CPU's to_cache")
    emit({"phase": "check", "what": "layer-0 float8_e4m3fn KV cache after "
          "a prefill, card vs the CPU's to_cache", "arch": cfg.name,
          "entries": int(k.numel()), "differing": out})


def audio_f32(cfg, box, dev):
    """musicgen-large's embedding-input check in float32 with a float32
    cache (``kv_cache_dtype=""``; the bf16 weights widened leaf by leaf):
    every token within NEAR_TIE of ``LM.apply``."""
    import dataclasses
    from repro_torch.models import LM
    model = LM(dataclasses.replace(cfg, dtype="float32", kv_cache_dtype=""),
               device=dev)
    params = tree_map(lambda t: t.float(), box.pop())
    release()
    rec, _ = embeds_check(model, params, AUDIO_EMBEDS, SEED + 6)
    emit({"phase": "vlm_audio", "arch": cfg.name, "dtype": "float32",
          "kv_cache_dtype": "float32", "input": "frame_embeds", **rec})
    del model, params
    release()


def audio_path(dev, drive, rng):
    """musicgen-large at full width and depth with its float8_e4m3fn KV
    cache: 2 x 512 frame embeddings prefilled and decoded 8 steps in bf16
    (timed; each token's gap to ``LM.apply`` printed, not gated: the fp8
    cache moves decode off ``LM.apply``), layer 0's fp8 cache bitwise the
    CPU's ``to_cache``, one emulated 4x128 prefill of frames and 4 decode
    steps (289 K1 launches a forward: six projections a layer and the
    unembed), a profile of one decode step, and last the same frames in
    float32 with a float32 cache, every token within NEAR_TIE of
    ``LM.apply``."""
    from repro_torch.configs.base import get_config
    cfg = get_config(AUDIO_ARCH)
    model, params = init_model(cfg, dev)
    check(model.cache_dtype == torch.float8_e4m3fn, "musicgen's cache is "
          "not float8")
    per_fwd = 6 * cfg.n_layers + 1
    inputs = {}

    def bf16_embeds():
        rec, inp = embeds_check(model, params, AUDIO_EMBEDS, SEED + 6,
                                gate=False)
        inputs["kw"] = inp[1]
        emit({"phase": "vlm_audio", "arch": cfg.name, "dtype": cfg.dtype,
              "kv_cache_dtype": "float8_e4m3fn", "input": "frame_embeds",
              **rec})

    drive(AUDIO_ARCH, ("fused_qmm",), bf16_embeds,
          lambda: fp8_cache_vs_cpu(model, params, inputs["kw"]),
          lambda: emulated_forwards(model, params, rng, per_fwd,
                                    embeds=True))
    profile_decode(model, params, rng)
    box = [params]
    del model, params, inputs
    release()
    audio_f32(cfg, box, dev)


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
# the softfloat on the card: normal-range operand triples per format, and
# the subsample dp_fma is held to the exact Fraction value on
SOFTFLOAT = dict(n=1 << 20, exact=4096,
                 formats=("fp32", "tf32", "bf16", "fp16", "fp8_e4m3",
                          "fp8_e5m2"))
# the format-joint tunes: a loose SLO downshifts below SP, a tight one
# keeps fp32, an unmeetable one has no feasible point
SLO_LOOSE, SLO_TIGHT, SLO_UNMEETABLE = 1e-2, 1e-8, 1e-12


def dse_full_size(dev, smi, params, fit_s):
    """The DSE core on the card against the CPU and the numpy backend;
    ``params`` is the card's ``calibrate`` fit, which took ``fit_s``
    seconds in the chip phase.  Returns each stage's seconds."""
    from repro_torch.core import autotune as at
    from repro_torch.core import body_bias, dse, energy_model, latency_sim
    from repro_torch.core.fpu_arch import DP_CMA, FABRICATED, TABLE_I
    seconds = {"calibrate": fit_s}

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
    chip_dse(dev, params, timed)
    emit({"phase": "dse", "seconds": seconds, "card": smi})
    return seconds


def chip_dse(dev, params, timed):
    """The chip facade's numerics and tuning at full size: the accuracy
    oracle over the SP and DP ladders (host), the float64 softfloat on the
    card against the CPU and the exact Fraction values, ``emulated_dot``
    on the oracle's own samples against the oracle, the format-joint
    ``autotune`` and ``tune_chip`` picking on the card what they pick on the
    CPU."""
    from fractions import Fraction
    from repro_torch.core import autotune as at
    from repro_torch.core import chip, energy_model, latency_sim
    from repro_torch.core import softfloat as sf
    from repro_torch.numerics import (DEFAULT_ACCURACY_MODEL, REGISTRY,
                                      dot_exact_steps, emulated_dot,
                                      get_format, rne_fraction)
    styles = ("fused", "cascade", "cascade_fwd")
    ladder = {p: [f.name for f in REGISTRY.formats_for(p)]
              for p in ("sp", "dp")}
    pairs = sorted({(f, st) for fs in ladder.values() for f in fs
                    for st in styles})
    errs = timed("accuracy_model", lambda: {
        f"{f}/{st}": DEFAULT_ACCURACY_MODEL.rel_err(f, st)
        for f, st in pairs})
    fused = [errs[f"{f}/fused"] for f in ("fp64", "fp32", "fp16", "bf16",
                                          "fp8_e4m3")]
    check(all(a < b for a, b in zip(fused, fused[1:])),
          f"accuracy ladder not monotone: {fused}")
    emit({"phase": "dse", "check": "accuracy_model", "pairs": len(pairs),
          "rel_err": errs})

    def softfloat_on_card():
        n, out = SOFTFLOAT["n"], {}
        r = np.random.default_rng(SEED)
        for name in SOFTFLOAT["formats"]:
            f = get_format(name)
            raw = r.standard_normal((3, n)) * np.exp2(
                r.integers(-6, 7, (3, n)))
            cpu = [sf.quantize64(torch.from_numpy(x), f).float()
                   for x in raw]
            card = [t.to(dev) for t in cpu]
            for op, k in (("sf_mul", 2), ("sf_add", 2), ("sf_fma", 3),
                          ("sf_cma", 3)):
                got = getattr(sf, op)(*card[:k], f).cpu()
                want = getattr(sf, op)(*cpu[:k], f)
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      f"{op} {name}: the card differs from the CPU")
            out[name] = n
        wide = [torch.from_numpy(x) for x in
                r.standard_normal((3, n)) * np.exp2(r.integers(-6, 7,
                                                               (3, n)))]
        got = sf.dp_fma(*(t.to(dev) for t in wide)).cpu()
        want = sf.dp_fma(*wide)
        check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
              "dp_fma: the card differs from the CPU")
        k = SOFTFLOAT["exact"]
        a, b, c = (t[:k].tolist() for t in wide)
        exact = [float(Fraction(x) * Fraction(y) + Fraction(z))
                 for x, y, z in zip(a, b, c)]
        check(got[:k].tolist() == exact, "dp_fma is not the correctly "
              "rounded a*b + c")
        check(sf.dp_cma(*wide[:3])[:k].tolist() != exact,
              "dp_cma rounds as dp_fma does: the check cannot see a "
              "second rounding")
        return out

    timed("softfloat_on_card", softfloat_on_card)

    def dot_vs_oracle():
        samples = torch.from_numpy(DEFAULT_ACCURACY_MODEL._samples())
        checked = {}
        for name in SOFTFLOAT["formats"]:
            f = get_format(name)
            for st in styles:
                rows, want = [], []
                for pair in samples.tolist():
                    try:
                        a = [rne_fraction(Fraction(x), f) for x in pair[0]]
                        b = [rne_fraction(Fraction(x), f) for x in pair[1]]
                        w = dot_exact_steps(a, b, f, st)
                    except OverflowError:
                        continue
                    rows.append(([float(x) for x in a],
                                 [float(x) for x in b]))
                    want.append(float(np.float32(float(w))))
                a = torch.tensor([x for x, _ in rows], device=dev)
                b = torch.tensor([y for _, y in rows], device=dev)
                got = emulated_dot(a, b, fmt=f, style=st)
                check(got.device == a.device, "emulated_dot left the card")
                check(got.tolist() == want,
                      f"emulated_dot {name}/{st} on the card != the oracle")
                checked[f"{name}/{st}"] = len(want)
        return checked

    checked = timed("emulated_dot_vs_oracle", dot_vs_oracle)
    emit({"phase": "dse", "check": "softfloat", "triples_per_format":
          SOFTFLOAT["n"], "dp_fma_exact_subsample": SOFTFLOAT["exact"],
          "emulated_dot_samples": checked})

    cache = energy_model.SweepExecutableCache()
    loose = timed("autotune_slo_loose", lambda: at.autotune(
        at.GEMM_STREAM, params=params, accuracy_slo=SLO_LOOSE, cache=cache,
        device=dev))
    tight = timed("autotune_slo_tight", lambda: at.autotune(
        at.GEMM_STREAM, params=params, accuracy_slo=SLO_TIGHT, cache=cache,
        device=dev))
    check(loose.fmt.bits < 32 and loose.metrics["rel_err"] <= SLO_LOOSE,
          f"loose SLO kept {loose.fmt.name}")
    check(tight.fmt.name == "fp32" and tight.metrics["rel_err"] <= SLO_TIGHT,
          f"tight SLO picked {tight.fmt.name}")
    try:
        at.autotune(at.GEMM_STREAM, params=params,
                    accuracy_slo=SLO_UNMEETABLE, cache=cache, device=dev)
        fail(f"accuracy_slo={SLO_UNMEETABLE} found a feasible point")
    except ValueError as e:
        check("no feasible" in str(e), f"unmeetable SLO raised {e}")
    emit({"phase": "dse", "check": "format_joint_autotune",
          "loose": loose.as_dict(), "tight": tight.as_dict()})

    def picks(res):
        return [(u.name, u.design.name, u.vdd, u.vbb, u.count, u.fmt.name)
                for u in res.spec.units]

    phases = chip.phases_from_config(ARCH)
    latency_sim.clear_penalty_cache()
    on_card = timed("tune_chip", lambda: chip.tune_chip(
        phases, params=params, accuracy_slo=SLO_LOOSE,
        cache=energy_model.SweepExecutableCache(), device=dev))
    latency_sim.clear_penalty_cache()
    on_cpu = timed("tune_chip_cpu", lambda: chip.tune_chip(
        phases, params=params, accuracy_slo=SLO_LOOSE,
        cache=energy_model.SweepExecutableCache(), device="cpu"))
    check(picks(on_card) == picks(on_cpu), f"tune_chip: card "
          f"{picks(on_card)} != CPU {picks(on_cpu)}")
    emit({"phase": "dse", "check": "tune_chip", "arch": ARCH,
          "accuracy_slo": SLO_LOOSE, "units": picks(on_card),
          "report": on_card.report})


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
    # the chip facade: fleet routing, energy and the routed units'
    # numerics through K1, on the card's own calibration of the model
    from repro_torch.core import energy_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tech = energy_model.calibrate(device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    emit({"phase": "chip", "stage": "calibrate", "seconds": fit_s,
          "card": smi})
    drive(f"{ARCH} chip", ("fused_qmm",),
          lambda: chip_full_width(model, params,
                                  np.random.default_rng(SEED + 2), tech))
    # telemetry and fault-tolerant serving on the native path, which
    # launches none of K1-K6
    drive(f"{ARCH} trace", (),
          lambda: trace_full_width(model, params, tech, dev))
    drive(f"{ARCH} resilience", (),
          lambda: resilience_full_width(cfg, params, tech, dev))
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
    del smodel, sparams
    release()

    # the hybrid, MoE, sliding-window, vlm and audio families, one model
    # at a time
    for path in (hybrid_path, moe_path, window_path, vlm_path, audio_path):
        path(dev, drive, rng)
        release()
    for row in kernels:  # launches on every path of this run
        row["max_abs_err"] = errs[row["name"]]
        by_path = {path: counts[row["name"]]
                   for path, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    # the paper's DSE core: no kernel of K1-K6, so no launch window
    dse_full_size(dev, smi, tech, fit_s)

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
