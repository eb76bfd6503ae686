#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

That is the full run.  ``python3 chip_smoke.py --paths dense`` (or a comma
list of ``PATHS``: tinyllama, ssm, hybrid, moe, window, vlm, audio, dense,
dse) runs phases 1 and 2 and only the named paths, in the full run's
order, with the same last line; its kernel table lists only the kernels
timed on those paths.

Phases, each of which fails the run (non-zero exit, no result line):

  1. the card, the torch/CUDA versions, and the build of every kernel from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel), with
     ``ptxas`` registers and spills of the K1/K3, K4, K5/K6 and tensor-core
     attention kernels (a spill in any of K1/K3's eight tiled, K4's six,
     K5/K6's four vector or the attention's eight instantiations fails the
     run);
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
     the tensor-core attention (flash_attention_tc) against its plain
     version ``attention_blocks`` within ``agreement_bound`` at the
     benchmark cells' shapes (starcoder2-7b 2 x 2048, 36/4 heads of 128;
     chatglm3-6b 4096, 32/2; DeepSeek-V2-Lite 4096, 16/16 heads of 192/128
     with v a strided view and its YaRN scale) and on ragged, offset,
     kv_len, windowed and fp16 operands, with a control the check must
     catch (a scale 1% off); then its times at those shapes beside its bound
     (the admitted pairs' two products at 989 TFLOP/s), the plain version's
     and ``scaled_dot_product_attention``'s on the same bf16 operands (a
     yardstick the port never calls); every path below counts its launches,
     and the dense configs' no-grad forwards launch it once a layer;
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
  3e. cluster serving of tinyllama-1.1b in float32 (the bf16 weights
     widened; both dies serve them), counters set to 0 just before: a
     ``ClusterRouter`` over an fp8_e4m3 die ``eco`` and an fp32 die
     ``gold`` (4 slots each, accuracy fleets 5e-2 and 1e-7, 8 tokens a
     dispatch, 64-token prefill chunks) on one ``SimClock``, under a seeded
     open-loop trace (3 simulated seconds, bursty and diurnal, loose bulk
     and tight interactive requests 3:1) replayed at 0.1 s a step: steady
     (every arrival finished, none rejected or expired, every token within
     4 * 2**-8 of ``LM.apply``, tight traffic only on gold, eco serving
     some of the loose; latency and TTFT percentiles in simulated seconds,
     J per request and per token, per-die utilization and wall seconds
     printed); the same trace with eco killed at 2.0 simulated seconds
     (at least one request in flight on eco, as many migrations as
     evacuated requests, each finished on gold with a requeue, nothing
     lost, every stream bitwise the steady run's or parting where the
     single-lane decode path puts the two picks within 4 * 2**-8; each
     migration's recovery in ticks and wall seconds printed); both dies
     failed, 3 requests parked and finished once gold is restored, an
     unknown precision and an unmeetable SLO rejected with the router's
     codes; one 4x128 prefill under each die's decode unit numerics
     (fp8_e4m3 and fp32, cascade_fwd), 155 K1 launches each, bitwise the
     same prefill with K1's plain version; ``tune_cluster`` of a 3:1
     bulk/interactive mix at the full ``TUNE_*`` grids on the card and on
     the CPU, identical picks and balanced throughput within 1e-9; then
     ``python -m repro_torch.launch.cluster --fail-at 2.0 --fail-die eco``
     and ``python -m repro_torch.launch.serve --chaos kill`` run on the
     card, each exiting 0 with every request finished;
  3f. training tinyllama-1.1b on the card, counters set to 0 just before
     and every count 0 just after (no kernel of K1-K6 has a backward, so
     none lies on this path): (a) ``flash_attention_trainable``'s
     recompute backward on layer 0's f32 q, k, v (2 x 2048, 32/4 heads)
     at blocks of 1024 and 256, with a window, kv_len < Sk and
     q_offset > 0, dq, dk and dv within 1e-5 * max |g| of autograd
     through a naive f32 attention, both peak memories printed; (b) 40
     steps at full width and depth (22 layers, bf16, remat) from
     ``LM.init``, 8 x 512 tokens of the port's data pipeline a step, the
     launcher's AdamW at lr 1e-3 (3e-3 diverges into NaN at this width),
     warmup 10: the loss finite and
     ``grad_norm`` > 0 every step, the mean of the last 5 losses below
     the first 5's by 0.2; step wall and device ms, idle share, tokens/s,
     model FLOP/s (8 N T) and peak memory printed; (c) the same batch
     with ``microbatches=2`` against one batch: the loss within 1e-3,
     each weight within two bf16 ulps of its size plus twice the lr;
     (d) 2 layers at full width in float32, two steps on the card and on
     the CPU from the same state: the loss within rtol 1e-5; from the
     CPU's state every gradient leaf within 1e-4 * max |g| and AdamW on
     the same gradients within 1e-3 lr; the weights after two steps
     within 2.5 of the lr summed; (e) in a child process made deterministic before CUDA
     starts, 2 layers in bf16 through ``run_with_restarts`` with failures
     before steps 3 and 6 and a checkpoint every 2: the final params,
     moments and counters bitwise the uninterrupted run's, each save's
     and restore's bytes and seconds printed; (f) ``python -m
     repro_torch.launch.train --arch tinyllama-1.1b --steps 20`` on the
     card, exit 0 and a falling loss; (g) a control the check must
     catch: a train step under ``EmulatedPolicy(bf16, fused)`` raising
     ``NoBackwardError`` on the card;
  3g. benchgen on the card: ``calibrate()`` measures the card's rates,
     then, counters set to 0 just before and read just after,
     ``validate`` of the default specs and two full-width flash specs
     against those rates, in which K1, K2, K4 and K5 must each launch;
     then one run of every spec, whose output must be finite, and every
     row printed beside ``paper_machine()``'s prediction;
  3h. (run between 3f and 3g) distribution on the card, as a world of
     one NCCL rank (file store in a temporary directory) with a (data=1,
     model=1) mesh, counters set to 0 just before: (a) one sharded train step of tinyllama-1.1b
     at full width and depth (bf16, remat) from a fresh state laid out
     by ``param_specs`` (DTensors), 8 x 512 tokens, and a second one
     profiled: loss finite, ``grad_norm`` > 0; step wall and device ms,
     idle share and peak bytes printed; (b) 2 full-width layers in
     float32, one step sharded and one unsharded from the same state:
     the loss within 1e-4 relative, every weight within 1e-4; (c)
     deepseek-moe-16b's layer-0 MoE at full width on 2 x 512 tokens at
     ``capacity_factor = n_experts``: ``moe_apply_distributed`` within
     1e-5 of max |out| of ``moe_apply`` in float32, both timed in bf16
     (their gap printed, not gated); (d) ``pipeline_forward`` with one
     stage bitwise the sequential result; (e) (b)'s sharded state saved
     from the mesh and restored with ``shardings=``, every leaf bitwise
     with its placements; (f) the bf16 ``fused`` policy matmul of
     DTensor operands, K1 launched once on the replicated operands,
     bitwise the unsharded K1, and ``fused_qmm`` refusing a DTensor; the process group is then
     destroyed; (g) ``python -m repro_torch.launch.train --devices 1
     --steps 10`` on the card (its own world of one rank, run beside
     (b)-(f); (a) and (c)'s times are taken after it ends), exit 0 and
     its loss below a uniform prediction's; (h) 8 ``decode_step``s of
     full-width tinyllama-1.1b after a 2 x 64 prefill, with the params and
     the cache laid out on the mesh (DTensors), every step's logits and
     the final cache bitwise the plain decode's; then chunked prefill on
     the mesh against the plain one, bitwise: ``prefill_chunked`` of the
     2 x 64 prompt in chunks of 16 (the last logits, every cache leaf
     and the lengths), a ``prefill_chunk`` of 16 tokens over three lanes
     of that 2-lane cache, slot id 2 a pad lane (the real lanes' logits,
     the cache, the lengths, and the first chunk's KV, which the pad lane
     would overwrite, kept), and one chunk into a fresh cache under
     EmulatedPolicy(bf16, fused), whose 155 K1 launches on the
     replicated operands are with (f)'s one the phase's only launches of
     K1-K6 (the plain chunk's run before the window);
  3i. (run after 3h) the dry run on the port's own terms, counters set to
     0 just before and every count 0 just after: (a) in a child process
     ``python -m chip_smoke --dryrun`` (started with phase 3h and given
     the chip phase's calibration, so that it fits none), made rank 0 of
     a fake world of 256 ranks, ``launch.dryrun.run_cell`` of
     tinyllama-1.1b ``decode_32k`` and ``train_4k`` on pod16x16 at full
     width, counted at 3 and 4 layers and extrapolated to 22, the chip
     policy's energy telemetry on the card: both rows ``ok``, printed;
     (b) ``roofline.op_cost.count`` around one full-width train step of
     tinyllama-1.1b (3f's shape, 8 x 512 tokens, bf16, remat) on the card
     and around the same step on ``meta`` stand-ins: flops, traffic and
     collective bytes equal integers; the step's device ms (its kernels'
     time in a profile, uncounted) and model FLOPs / (989e12 x device s)
     printed; the cost of
     a ``record_function`` scope on the host printed (a decode step enters
     none);
  3j. (run after 4d, path ``dense``) the dense family's last three
     configurations, one model at a time, each freed before the next:
     starcoder2-7b (32 layers, d_model 4608, 36/4 heads of 128, gelu,
     qkv bias, vocab 49152) and chatglm3-6b (28 layers, d_model 4096,
     32/2 heads, half RoPE, qkv bias, swiglu, vocab 65024) at full width
     and depth, and deepseek-67b (d_model 8192, 64/8 heads, vocab 102400,
     float8_e4m3fn cache) at full width and 24 of its 95 layers (its bf16
     weights exceed the card at full depth), counters set to 0 just
     before each: phase 3's 8 requests served in bf16 under phase 3's
     gates (every token within NEAR_TIE of ``LM.apply``; the model's own
     bf16 noise floor printed), deepseek-67b's on the fp8 cache timed and
     each served token's shortfall from ``LM.apply``'s top logit printed
     with their p50, p99 and max, not gated, and its layer 0's fp8 cache
     after a 2 x 512 prefill bitwise the CPU's ``to_cache``; one 4x128
     prefill and 4 decode steps under EmulatedPolicy(bf16, fused), 193,
     197 and 169 K1 launches a forward; then, outside the window, K1 on
     layer 0's own operands (every projection and the unembed, at M = 4
     and 512, bf16 under each style) exactly equal to its plain version
     with each case's plan printed, layer 0's block in float32 on 2 x 64
     tokens on the card against the CPU within 1e-4 of max |value|
     (chatglm3's half RoPE at head dim 128 among them), a profile of one
     decode step, and for deepseek-67b last the served-token check in
     float32 with a
     float32 cache at 8 layers (the bf16 weights widened leaf by leaf),
     every token within NEAR_TIE of ``LM.apply``;
  4. the ssm path at the full width and depth of falcon-mamba-7b
     (tinyllama freed first), launch counters set to 0 just before:
     ``BatchedServer`` and ``greedy_decode`` as in 3 in bf16, every token
     held to twice the model's own bf16 noise floor measured in the run
     (``prefill`` against ``LM.apply`` at one position; at least 4 * 2**-8,
     the floor itself under 2**-3, of max |logit|), then the same requests
     on the same weights computed in float32 at 16 of the 64 layers (a
     cut for the script's time), every token held to 4 * 2**-8; in both the server's and ``greedy_decode``'s streams agree
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
     float32 at 12 of the 38 layers (a cut for the script's time, two
     shared-block applications kept; 4 * 2**-8), one 4x128 prefill and 4
     decode steps under EmulatedPolicy(bf16, fused) with 37 K1 launches
     per forward (six shared-block projections per application, six
     applications, the unembed), and a profile of one decode step;
  4b. the MoE path at the full width and depth of deepseek-moe-16b (fp8 KV
     cache): served at ``capacity_factor = n_experts`` (nothing drops) in
     bf16 (timed, not held); the same requests at the config's 1.25 with
     each prefill forward's dropped share (``LM.apply(moe_stats=True)`` on
     the server's own batches, read off the server's recorded ``Tracer``)
     and the tokens that differ printed; two
     identical prefills bitwise equal; 113 K1 launches per emulated
     forward; layer 0's MoE on the largest served prefill's input against
     the CPU (picks, keep mask and slots identical, output within
     4 * 2**-8); last, the bf16 weights of the first 8 of the 28 layers
     (a cut for the script's time) widened to float32 leaf by leaf and
     the no-drop requests served again with a float32 KV cache, every
     token and greedy_decode's held to 4 * 2**-8 of ``LM.apply`` (the
     fp8 cache rounds the shapes' last-bit differences to whole fp8
     steps, beyond that share at full depth);
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
import contextlib
import gc
import itertools
import json
import math
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
LIBRARY_TC = ("torch.nn.functional.scaled_dot_product_attention on the same "
              "bf16 operands as (B, H, S, D) views, is_causal=True, "
              "enable_gqa=True, the same scale")
# the tensor-core attention at the benchmark cells' shapes, causal squares:
# (label, B, S, Hq, Hkv, D, Dv, scale or None for D^-1/2)
ATTN_TC_SHAPES = (("starcoder2-7b eval", 2, 2048, 36, 4, 128, 128, None),
                  ("chatglm3-6b prefill", 1, 4096, 32, 2, 128, 128, None),
                  ("deepseek-v2-lite prefill", 1, 4096, 16, 16, 192, 128,
                   "yarn"))
# and on masked, ragged and fp16 operands: (B, Sq, Sk, Hq, Hkv, D, Dv,
# dtype, keywords)
ATTN_TC_EDGES = ((2, 300, 300, 8, 2, 64, 64, "bfloat16", {}),
                 (1, 77, 333, 8, 8, 128, 128, "bfloat16",
                  dict(q_offset=256)),
                 (2, 200, 256, 4, 1, 128, 128, "bfloat16",
                  dict(causal=False, kv_len=150)),
                 (1, 500, 500, 6, 3, 64, 64, "bfloat16", dict(window=100)),
                 (2, 384, 384, 8, 8, 128, 128, "float16", {}))
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


def kernel_event(e):
    """A profiler average of kernels on the card: not a host op, and not
    the device-side span of a ``record_function`` scope (the flash and
    scan scopes), which would count its kernels' time twice."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


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
    # what ptxas -v reported for the K1/K3, K4 and K5/K6 kernels; a K1/K3
    # tiled instantiation, a K4 instantiation or a K5/K6 vector (lanes)
    # instantiation that spills fails the run
    no_spills = {"qmm": ("qmm_tile_kernel", 8, "K1/K3",
                         "BM 64/128 x f32/bf16 a x f32/bf16 b"),
                 "flash_attn": ("flash_kernel", 6, "K4",
                                "D 16/64/128 x f32/bf16"),
                 "ssm_scan": ("ssm_scan_lanes_kernel", 4, "K5/K6",
                              "N 8/16 x rounding off/on"),
                 "attention_tc": ("attention_tc_kernel", 8,
                                  "tensor-core attention",
                                  "(D, Dv) 64/64, 128/128, 192/128, 256/256 "
                                  "x bf16/fp16")}
    for name, source in (("qmm", "qmm.cu"), ("flash_attn", "flash_attn.cu"),
                         ("ssm_scan", "ssm_scan.cu"),
                         ("attention_tc", "attention_tc.cu")):
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


def attn_tc_operands(B, Sq, Sk, Hq, Hkv, D, Dv, dtype, dev, seed):
    """Seeded normal q (B, Sq, Hq, D), k (B, Sk, Hkv, D) and v (B, Sk, Hkv,
    Dv) in ``dtype`` on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(B, S, H, W, generator=g).to(dtype).to(dev)
                 for S, H, W in ((Sq, Hq, D), (Sk, Hkv, D), (Sk, Hkv, Dv)))


def attn_tc_scale(scale, D):
    from repro_torch.configs.deepseek_v2_lite import CONFIG
    from repro_torch.models.mla import softmax_scale
    return softmax_scale(CONFIG) if scale == "yarn" else 1.0 / math.sqrt(D)


def attn_tc_shapes(dev):
    """The benchmark cells' shapes and the edge cases, as (label, q, k, v,
    keywords); DeepSeek-V2-Lite's v is the strided view ``kv[..., 128:]``,
    as its prefill passes it."""
    for i, (label, B, S, Hq, Hkv, D, Dv, scale) in enumerate(ATTN_TC_SHAPES):
        wide = Dv + 128 if scale == "yarn" else Dv
        q, k, v = attn_tc_operands(B, S, S, Hq, Hkv, D, wide, torch.bfloat16,
                                   dev, SEED + i)
        yield label, q, k, v[..., wide - Dv:], dict(
            scale=attn_tc_scale(scale, D))
    for i, (B, Sq, Sk, Hq, Hkv, D, Dv, dt, kw) in enumerate(ATTN_TC_EDGES):
        q, k, v = attn_tc_operands(B, Sq, Sk, Hq, Hkv, D, Dv,
                                   getattr(torch, dt), dev, SEED + 10 + i)
        yield f"{dt} {(B, Sq, Sk, Hq, Hkv, D, Dv)} {kw}", q, k, v, dict(
            kw, scale=1.0 / math.sqrt(D))


def attn_tc_vs_plain(q, k, v, kw, scale_by=1.0):
    """The kernel (its scale times ``scale_by``) against the plain version:
    (max |err|, max err / ``agreement_bound``)."""
    from repro_torch.kernels.attention_tc import (agreement_bound,
                                                  flash_attention_tc)
    from repro_torch.models.attention import attention_blocks
    kw = dict(dict(causal=True, window=0, q_offset=0, kv_len=k.shape[1]),
              **kw)
    with torch.no_grad():
        got = flash_attention_tc(q, k, v, **dict(kw,
                                                 scale=kw["scale"] * scale_by))
        want = attention_blocks(q, k, v, **kw)
        a_mean = attention_blocks(q.float(), k.float(), v.float().abs(),
                                  **kw)
    err = (got.float() - want.float()).abs()
    tol = agreement_bound(got, want, a_mean, k.shape[1])
    return float(err.max()), float((err / tol).max())


def check_attention_tc(dev):
    """The tensor-core attention within ``agreement_bound`` of its plain
    version at the cells' shapes and the edge cases, and a control the
    check must catch: the scale 1% off."""
    cases = []
    for label, q, k, v, kw in attn_tc_shapes(dev):
        err, share = attn_tc_vs_plain(q, k, v, kw)
        check(share <= 1.0, f"tensor-core attention {label}: {err} is "
              f"{share:.3g} of the stated bound")
        cases.append({"case": label, "max_abs_err": err,
                      "max_share_of_bound": share})
        del q, k, v
    q, k, v = attn_tc_operands(2, 300, 300, 8, 2, 64, 64, torch.bfloat16,
                               dev, SEED + 20)
    _, control = attn_tc_vs_plain(q, k, v, dict(scale=0.125), scale_by=1.01)
    check(control > 1.0, f"tensor-core attention: a scale 1% off stays "
          f"within the bound ({control:.3g} of it)")
    emit({"phase": "check", "kernel": "flash_attention_tc", "cases": cases,
          "tolerance": "attention_tc.agreement_bound: 2 u A + 2^-16 A + one "
                       "ulp of the output's type (A the row's "
                       "softmax-weighted mean of |v|)",
          "control_scale_1pct_share_of_bound": control})
    return {"flash_attention_tc": max(c["max_abs_err"] for c in cases)}


def time_attention_tc(dev, errs):
    """The tensor-core attention at the cells' shapes: median of 10
    launches with the L2 flushed, beside its bound (the admitted pairs' two
    products at the bf16 peak), the plain version's time (3 runs) and
    ``scaled_dot_product_attention``'s on the same operands.  Returns one
    kernel row a shape."""
    import torch.nn.functional as TF
    from repro_torch.kernels.attention_tc import flash_attention_tc
    from repro_torch.models.attention import attention_blocks
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    rows = []
    for label, q, k, v, kw in itertools.islice(attn_tc_shapes(dev),
                                               len(ATTN_TC_SHAPES)):
        B, S, Hq, D = q.shape
        Hkv, Dv = k.shape[2], v.shape[3]
        sc = kw["scale"]
        with torch.no_grad():
            ms = time_ms(lambda: flash_attention_tc(q, k, v, scale=sc), flush)
            plain = time_ms(lambda: attention_blocks(
                q, k, v, scale=sc, causal=True, window=0, q_offset=0,
                kv_len=S), flush, reps=3, warm=1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = time_ms(lambda: TF.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=sc, enable_gqa=True),
                flush)
        pairs = S * (S + 1) / 2
        operations = 2.0 * B * Hq * pairs * (D + Dv)
        byts = 2 * (B * S * Hq * (D + Dv) + B * S * Hkv * (D + Dv))
        bound = bound_of(1e3 * byts / HBM_BYTES_PER_S,
                         1e3 * operations / PEAK_OPS_PER_S["bf16"])
        emit({"phase": "times", "kernel": "flash_attention_tc",
              "case": label, "q": list(q.shape), "k": list(k.shape),
              "v": list(v.shape), "unit": "ms per launch, median of 10, L2 "
              "flushed; plain median of 3", "ms": ms, "plain_ms": plain,
              "library_ms": library, "bound_ms": bound[0],
              "bound_by": bound[1], "operations": operations,
              "tflops": operations / ms / 1e9,
              "share_of_bound": bound[0] / ms})
        rows.append(dict(name="flash_attention_tc", route="cuda",
                         source="src/repro_torch/csrc/attention_tc.cu",
                         replaces="none (models/attention.py::flash_blocks "
                                  "on the no-grad path)",
                         max_abs_err=errs["flash_attention_tc"], ms=ms,
                         plain_ms=plain, bound_ms=bound[0],
                         bound_by=bound[1], library_ms=library,
                         library_call=LIBRARY_TC,
                         work=f"{label}: q {list(q.shape)}, k "
                              f"{list(k.shape)}, v {list(v.shape)} bf16, "
                              "causal"))
        del q, k, v
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width(model, params, rng, noise_floor=False, spec=SERVE,
                     lens=None, prefill_chunk=None, parting_on_decode=False,
                     greedy=None, gate=True):
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
    gate.  With ``gate`` False no model is held beyond that either (the
    caller measures the served tokens, ``served_vs_apply``).
    """
    from repro_torch.serve import BatchedServer, Request, greedy_decode
    s = spec
    reference = "decode" if model.cache_dtype != model.dtype else "apply"
    gate_tokens = gate and (not model.cfg.n_experts
                            or model.dtype == torch.float32)
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


def served_vs_apply(model, params, rec):
    """How far each token that ``serve_full_width`` served (``rec``) falls
    short of ``LM.apply``'s top logit on its own prefix, as a share of
    max |logit| there: printed, p50, p99 and max over every served token,
    not gated."""
    shares, exact = [], 0
    for prompt, stream in zip(rec["prompts"], rec["outputs"]):
        shortfall, scale, _, _ = stream_vs_apply(model, params, prompt,
                                                 stream)
        shares.append(shortfall / scale)
        exact += int((shortfall == 0).sum())
    shares = torch.cat(shares).double()
    q = torch.quantile(shares, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                            device=shares.device))
    out = {"tokens": int(shares.numel()), "p50": float(q[0]),
           "p99": float(q[1]), "max": float(shares.max()),
           "tokens_at_apply_argmax": exact,
           "within_near_tie": int((shares <= NEAR_TIE).sum())}
    emit({"phase": "serve_vs_apply", "arch": model.cfg.name,
          "kv_cache_dtype": str(model.cache_dtype), "dtype": model.cfg.dtype,
          "gated": False, "shortfall_share_of_max_logit": out,
          "shares": shares.tolist()})
    return out


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
# phases 3c-3d: telemetry and fault-tolerant serving on tinyllama-1.1b
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
    span_slices = [e for e in slices if e.get("cat") != "scope"]
    check(len(span_slices) == len(tracer.spans) and
          len(slices) - len(span_slices) == len(tracer.scopes),
          f"Chrome trace: {len(span_slices)} slices for "
          f"{len(tracer.spans)} spans, {len(slices) - len(span_slices)} for "
          f"{len(tracer.scopes)} scopes")
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


# ---------------------------------------------------------------------------
# phase 3e: cluster serving on tinyllama-1.1b
# ---------------------------------------------------------------------------
# the cluster phase: the eco+gold pair (one fp8 unit, one fp32 unit), a
# server of 4 slots on each, on one simulated clock advanced `tick` a step;
# eco is killed at `kill_at` simulated seconds
CLUSTER = dict(slots=4, max_len=256, dispatch_tokens=8, prefill_chunk=64,
               accuracy_fleets=(5e-2, 1e-7), tick=0.1, kill_at=2.0,
               parked=3, parked_tokens=8, tune_max_chips=4)
# the seeded open-loop trace: bursty, diurnal, 3:1 loose bulk to tight
# interactive traffic; 3 simulated seconds (15 arrivals) keep the phase
# near a minute on an H100, where 6 (36 arrivals) took 48 s to replay
# twice
CLUSTER_TRACE = dict(horizon_s=3.0, base_rate_rps=2.0,
                     diurnal_amplitude=0.6, diurnal_period_s=12.0,
                     burst_multiplier=3.0, burst_on_s=1.5, burst_off_s=5.0,
                     seed=7)


def eco_gold():
    """The two-die cluster of ``launch.cluster``: ``eco`` with one fp8_e4m3
    unit (rel_err 1e-2, 0.5 pJ/FLOP), ``gold`` with one fp32 unit (1e-8,
    4.0 pJ/FLOP)."""
    from repro_torch.cluster import ClusterSpec
    from repro_torch.core import chip
    from repro_torch.core.formats import FP32, FP8_E4M3
    from repro_torch.launch.serve import tiered_unit
    return ClusterSpec("eco+gold", (
        chip.ChipSpec("eco", (tiered_unit("decode_eco", FP8_E4M3, 1e-2,
                                          0.5),)),
        chip.ChipSpec("gold", (tiered_unit("decode_gold", FP32, 1e-8,
                                           4.0),))))


def cluster_router(model, params, tech):
    """A ``ClusterRouter`` over ``eco_gold()`` on a fresh ``SimClock``."""
    from repro_torch.cluster import ClusterRouter, SimClock
    c = CLUSTER
    clock = SimClock()
    router = ClusterRouter(model, params, eco_gold(), slots=c["slots"],
                           max_len=c["max_len"], clock=clock,
                           accuracy_fleets=c["accuracy_fleets"],
                           dispatch_tokens=c["dispatch_tokens"],
                           prefill_chunk=c["prefill_chunk"],
                           tech_params=tech)
    return router, clock


def cluster_trace(vocab):
    """CLUSTER_TRACE's arrivals: loose bulk requests (weight 3, prompts of
    16-128 tokens, 32 new, accuracy_slo 5e-2) and tight interactive ones
    (weight 1, 24-96 tokens, 16 new, 1e-7, a deadline 120 s out)."""
    from repro_torch.cluster import RequestClass, TraceConfig, generate
    return generate(TraceConfig(**CLUSTER_TRACE, classes=(
        RequestClass("loose_bulk", weight=3, prompt_lens=(16, 32, 64, 128),
                     max_new_tokens=32, accuracy_slo=5e-2),
        RequestClass("tight_interactive", weight=1,
                     prompt_lens=(24, 48, 96), max_new_tokens=16,
                     accuracy_slo=1e-7, deadline_slack_s=120.0))), vocab)


def timed_steps(router, clock, watch=None):
    """Wrap ``router.step``: each step ends with a synchronize and logs
    (sim s, wall s); with ``watch`` ({uid: (request, tokens it held at the
    kill)}) the first step after which a watched request holds more tokens
    is its recovery, logged per uid."""
    log, recovered = [], {}
    step = router.step

    def timed(max_tokens=None):
        n = step(max_tokens)
        torch.cuda.synchronize()
        now = time.perf_counter()
        log.append((clock.t, now))
        for uid, (r, held) in (watch or {}).items():
            if uid not in recovered and len(r.output) > held:
                recovered[uid] = (clock.t, now)
        return n

    router.step = timed
    return log, recovered


def plain_prefill(model, params, toks, policy):
    """``model.prefill`` under ``policy`` with K1 replaced by its plain
    version (``fused_qmm_ref`` at the kernel's 128 x 128 tiling) on the
    same device: nothing is launched or counted."""
    from repro_torch.kernels import fused
    from repro_torch.kernels.ref import TILE
    kernel = fused.fused_qmm

    def plain(a, b, **kw):
        return fused.fused_qmm_ref(a, b, bm=TILE, bn=TILE, **kw)

    fused.fused_qmm = plain
    try:
        logits, _ = model.prefill(params, toks, policy=policy)
    finally:
        fused.fused_qmm = kernel
    return logits


class Launcher:
    """``python -m module args`` started from the checkout (on the card:
    the launchers' default device; ``env``: variables set for it alone)
    with its output in temporary files and its end time taken by a
    thread; ``finish`` waits, requires exit 0 and returns the output lines
    and the wall seconds; ``close`` kills it if it still runs and closes
    its files."""

    def __init__(self, module, *args, env=None):
        import os
        import tempfile
        import threading
        env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
            if p))
        self.what = " ".join((module,) + args)
        self.out, self.err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", module, *args],
                                     cwd=ROOT, env=env, stdout=self.out,
                                     stderr=self.err)
        self.ended = None

        def wait():
            self.proc.wait()
            self.ended = time.perf_counter()

        self.waiter = threading.Thread(target=wait, daemon=True)
        self.waiter.start()

    def finish(self, timeout=600):
        self.waiter.join(timeout)
        check(self.ended is not None, f"{self.what} still runs after "
              f"{timeout} s")
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read().decode(), self.err.read().decode()
        check(self.proc.returncode == 0, f"{self.what} exited "
              f"{self.proc.returncode}: {err[-2000:]}")
        return out.splitlines(), self.ended - self.t0

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()


def cluster_served(rep_finished, trace, what):
    """Every arrival of ``trace`` finished with its whole budget, none
    rejected or expired."""
    reqs = [a.request for a in trace]
    check(sorted(r.uid for r in rep_finished) == sorted(r.uid for r in reqs)
          and all(r.done and not r.expired and not r.rejected and
                  len(r.output) == r.max_new_tokens for r in reqs),
          f"{what}: requests lost, rejected, expired or cut: "
          f"{[(r.uid, len(r.output), r.done) for r in reqs]}")
    return reqs, [np.asarray(r.prompt, np.int64) for r in reqs]


def cluster_full_width(cfg, params, tech, dev):
    """Cluster serving of tinyllama-1.1b at full width in float32 (the
    bf16 weights widened, exactly; both dies serve them): the eco+gold
    pair under a seeded open-loop trace replayed at one tick a step
    (steady: nothing lost, every token within NEAR_TIE of ``LM.apply``,
    tight traffic only on gold, eco serving some of the loose); the same
    trace with eco killed mid-trace (in-flight requests migrated to gold
    and resumed, nothing lost, every stream bitwise the steady run's or
    parting at a near tie of the single-lane decode path, each
    migration's recovery in ticks and wall seconds); both dies failed,
    requests parked and finished once gold is restored, and the two
    cluster-wide rejects; one 4x128 prefill under each die's decode unit
    numerics through K1 (7 * n_layers + 1 launches each), bitwise its
    plain version; ``tune_cluster`` on the card and on the CPU with
    identical picks; and both launchers run on the card."""
    import dataclasses
    from repro_torch.cluster import latency_stats, replay
    from repro_torch.models import LM
    from repro_torch.serve import Request, RequestRejected
    c, t_phase = CLUSTER, time.perf_counter()
    model = LM(dataclasses.replace(cfg, dtype="float32"), device=dev)
    wide = tree_map(lambda t: t.float(), params)
    out = {}

    # steady: the whole trace
    router, clock = cluster_router(model, wide, tech)
    trace = cluster_trace(cfg.vocab_size)
    check(trace, "the seeded trace is empty")
    log, _ = timed_steps(router, clock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = replay(router, trace, clock, tick_s=c["tick"],
                 dispatch_tokens=c["dispatch_tokens"])
    wall = time.perf_counter() - t0
    check(not rep["rejected"] and not rep["expired"],
          f"steady: {len(rep['rejected'])} rejected, "
          f"{len(rep['expired'])} expired")
    reqs, prompts = cluster_served(rep["finished"], trace, "steady")
    worst, exact, _ = hold_to_apply(model, wide, reqs, prompts,
                                    "cluster steady")
    classes = rep["classes"]
    placed = {cls: {} for cls in set(classes.values())}
    for r in reqs:
        by = placed[classes[r.uid]]
        by[r.routed_unit] = by.get(r.routed_unit, 0) + 1
    check(set(placed.get("tight_interactive", {})) == {"decode_gold"},
          f"tight traffic placed {placed}")
    check(placed.get("loose_bulk", {}).get("decode_eco", 0) > 0,
          f"eco served none of the loose traffic: {placed}")
    energy = router.energy_report()
    n_tok = sum(len(r.output) for r in reqs)
    steady = {r.uid: list(r.output) for r in reqs}
    out["steady"] = dict(
        arrivals=len(trace), classes={k: sum(v.values())
                                      for k, v in placed.items()},
        placed=placed, latency=latency_stats(rep["latency_s"],
                                             rep["ttft_s"]),
        span_s=rep["span_s"], steps=len(log),
        j_per_request=energy["total_j"] / len(reqs),
        j_per_token=energy["j_per_token"], total_j=energy["total_j"],
        utilization=router.utilization_report(), wall_s=wall,
        tokens_per_s=n_tok / wall, tokens_checked=n_tok,
        tokens_at_apply_argmax=exact, worst_shortfall_over_limit=worst)

    # die-kill: the same trace replayed in two parts around eco's kill
    router, clock = cluster_router(model, wide, tech)
    trace = cluster_trace(cfg.vocab_size)
    pre = [a for a in trace if a.at_s < c["kill_at"]]
    post = [a for a in trace if a.at_s >= c["kill_at"]]
    watch = {}
    log, recovered = timed_steps(router, clock, watch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep1 = replay(router, pre, clock, tick_s=c["tick"],
                  dispatch_tokens=c["dispatch_tokens"],
                  max_steps=int(c["kill_at"] / c["tick"]))
    on_eco = router.servers["eco"].load_report()
    t_kill, wall_kill = clock.t, time.perf_counter()
    moved = router.fail_chip("eco")
    check(moved, f"nothing was in flight on eco at the kill: {on_eco}")
    check(router.migrations == len(moved), f"{router.migrations} "
          f"migrations for {len(moved)} evacuated requests")
    watch.update({r.uid: (r, len(r.output)) for r in moved})
    held = {r.uid: len(r.output) for r in moved}
    rep2 = replay(router, post, clock, tick_s=c["tick"],
                  dispatch_tokens=c["dispatch_tokens"],
                  carryover={a.request.uid: a.at_s for a in pre})
    wall = time.perf_counter() - t0
    check(not (rep1["rejected"] or rep2["rejected"] or rep1["expired"]
               or rep2["expired"]), "die-kill: requests rejected or "
          "expired")
    reqs, prompts = cluster_served(rep1["finished"] + rep2["finished"],
                                   trace, "die-kill")
    for r in moved:
        check(r.routed_unit == "decode_gold" and r.requeues >= 1,
              f"migrated request {r.uid} finished on {r.routed_unit} "
              f"after {r.requeues} requeues")
    worst, exact, _ = hold_to_apply(model, wide, reqs, prompts,
                                    "cluster die-kill")
    partings = {}
    for r, prompt in zip(reqs, prompts):
        base = steady[r.uid]
        split = next((i for i, (x, y) in enumerate(zip(r.output, base))
                      if x != y), None)
        if split is None:
            continue
        gap = decode_parting(model, wide, prompt, base, split,
                             r.output[split], c["max_len"])
        check(gap <= NEAR_TIE, f"request {r.uid}: the die-kill stream "
              f"parts from the steady one at token {split}, where the "
              f"decode path puts the two picks {gap} of max |logit| apart "
              f"(a near tie is within {NEAR_TIE})")
        partings[r.uid] = dict(split=split, gap=gap,
                               migrated=r.uid in held)
    check(set(recovered) == set(held), f"migrated requests "
          f"{sorted(set(held) - set(recovered))} never resumed")
    recovery = {uid: dict(tokens_at_kill=held[uid],
                          ticks=round((t - t_kill) / c["tick"]),
                          sim_s=t - t_kill, wall_s=w - wall_kill)
                for uid, (t, w) in sorted(recovered.items())}
    energy = router.energy_report()
    latency = {**rep1["latency_s"], **rep2["latency_s"]}
    ttft = {**rep1["ttft_s"], **rep2["ttft_s"]}
    out["die_kill"] = dict(
        kill_at_s=t_kill, in_flight_on_eco=on_eco,
        evacuated=sorted(held), migrations=router.migrations,
        recovery=recovery, partings=partings,
        bitwise_streams=len(reqs) - len(partings),
        latency=latency_stats(latency, ttft), steps=len(log),
        j_per_token=energy["j_per_token"], total_j=energy["total_j"],
        utilization=router.utilization_report(), wall_s=wall,
        failed=router.cluster_report()["failed"],
        tokens_at_apply_argmax=exact, worst_shortfall_over_limit=worst)

    # both dies failed: requests park at the router, gold's restore drains
    # them; then the two cluster-wide rejects
    t0 = time.perf_counter()
    router, clock = cluster_router(model, wide, tech)
    router.fail_chip("eco")
    router.fail_chip("gold")
    parked = [Request(uid=i, prompt=prompts[i],
                      max_new_tokens=c["parked_tokens"], accuracy_slo=5e-2)
              for i in range(c["parked"])]
    targets = [router.submit(r) for r in parked]
    check(targets == [""] * len(parked) and
          len(router._parked) == len(parked) and not router.idle(),
          f"with both dies failed the requests went to {targets}")
    clock.t += c["tick"]
    check(router.step() == 0, "a failed die served")
    router.restore_chip("gold")
    for _ in range(400):
        clock.t += c["tick"]
        router.step(c["dispatch_tokens"])
        if router.idle():
            break
    done = router.drain_finished()
    check(len(done) == len(parked) and not router._parked and all(
        r.done and r.routed_unit == "decode_gold" and
        len(r.output) == c["parked_tokens"] for r in parked),
        "parked requests did not finish on gold")
    hold_to_apply(model, wide, parked, prompts[:len(parked)],
                  "cluster parked")
    rejects = {}
    for i, (kw, code) in enumerate(((dict(precision="dp"),
                                     "unknown_precision"),
                                    (dict(accuracy_slo=1e-12),
                                     "accuracy_slo_unmeetable"))):
        bad = Request(uid=1000 + i, prompt=prompts[0], max_new_tokens=4,
                      **kw)
        try:
            router.submit(bad)
            fail(f"a request with {kw} was admitted")
        except RequestRejected as e:
            check(e.code == code and bad.rejected and
                  bad in router.rejected, f"{kw} rejected as {e.code}")
            rejects[code] = e.reason
    out["park"] = dict(parked=len(parked), finished=len(done),
                       rejects=rejects, seconds=time.perf_counter() - t0)

    # both launchers on the card, alongside the K1 checks and the tunes
    # (host-bound, one process each on a card with room for all three)
    launchers = (Launcher("repro_torch.launch.cluster", "--fail-at",
                          str(c["kill_at"]), "--fail-die", "eco"),
                 Launcher("repro_torch.launch.serve", "--chaos", "kill"))
    try:
        cluster_checks(cfg, model, wide, router, tech, dev, out)
        out["launchers"] = finish_launchers(launchers)
    finally:
        for launcher in launchers:
            launcher.close()
    del model, wide, router
    release()
    emit({"phase": "cluster", "arch": cfg.name, "dtype": "float32",
          "cluster": "eco+gold", **c, "trace": CLUSTER_TRACE,
          "seconds": time.perf_counter() - t_phase, **out})


def finish_launchers(launchers):
    """Each launcher exited 0 with every request finished: their output
    lines and wall seconds."""
    (lines, w_cluster), (lines2, w_serve) = (x.finish() for x in launchers)
    m = re.search(r"^(\d+)/(\d+) requests finished \((\d+) expired\)",
                  "\n".join(lines), re.M)
    check(m is not None and m.group(1) == m.group(2) and m.group(3) == "0",
          f"launch.cluster: {lines}")
    m = re.search(r"^chaos=kill: (\d+)/(\d+) requests completed",
                  "\n".join(lines2), re.M)
    check(m is not None and m.group(1) == m.group(2),
          f"launch.serve: {lines2}")
    return dict(cluster=dict(lines=lines, wall_s=w_cluster),
                serve=dict(lines=lines2, wall_s=w_serve))


def cluster_checks(cfg, model, wide, router, tech, dev, out):
    """One 4x128 prefill under each die's decode unit numerics through K1
    against the plain version; ``tune_cluster`` on the card and the
    CPU."""
    from repro_torch.cluster import ChipClass, tune_cluster
    from repro_torch.core import autotune, chip, energy_model, latency_sim
    from repro_torch.kernels.fused import fused_qmm
    c = CLUSTER
    t0 = time.perf_counter()
    B, S = EMU["batch"], EMU["prompt"]
    toks = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (B, S)), device=dev)
    per_fwd = 7 * cfg.n_layers + 1
    logits, numerics = {}, {}
    for die, unit, fmt in (("eco", "decode_eco", "fp8_e4m3"),
                           ("gold", "decode_gold", "fp32")):
        pol = router.policies[die].numerics_for_phase("decode", fmt=None,
                                                      emulate=True)
        check(pol.fmt.name == fmt and pol.emulate,
              f"{die}: numerics {pol.fmt.name}, expected {fmt}")
        c0 = fused_qmm.launches
        routed, _ = model.prefill(wide, toks, policy=pol)
        torch.cuda.synchronize()
        launches = fused_qmm.launches - c0
        check(launches == per_fwd, f"{die} routed prefill: {launches} K1 "
              f"launches, expected {per_fwd}")
        check(bool(torch.isfinite(routed).all()), f"{die}: non-finite "
              "logits")
        plain = plain_prefill(model, wide, toks, pol)
        check(torch.equal(routed, plain), f"{die} routed prefill differs "
              "from the plain K1's")
        logits[die] = routed
        numerics[die] = dict(unit=unit, fmt=fmt, style=pol.accum_style,
                             k1_launches=launches, bitwise_plain=True)
    gap = float((logits["eco"] - logits["gold"]).abs().max() /
                logits["gold"].abs().max())
    out["k1_per_die"] = dict(numerics, eco_vs_gold_rel_gap=gap,
                             seconds=time.perf_counter() - t0)
    del logits, routed, plain

    # tune_cluster on the card and on the CPU
    classes = [ChipClass("bulk", (chip.PhaseSpec(
                   "train", autotune.GEMM_STREAM),), workload_share=3.0),
               ChipClass("interactive", (chip.PhaseSpec(
                   "decode", autotune.DEPENDENT_CHAIN),),
                   workload_share=1.0)]

    def picks(rc):
        return rc.counts, [(d.name, [(u.design.name, u.vdd, u.vbb, u.count,
                                      u.fmt.name if u.fmt else None)
                                     for u in d.units])
                           for d in rc.spec.chips]

    tuned, seconds = {}, {}
    for where in (dev, "cpu"):
        latency_sim.clear_penalty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tuned[str(where)] = tune_cluster(
            classes, max_chips=c["tune_max_chips"], params=tech,
            cache=energy_model.SweepExecutableCache(), device=where)
        seconds[str(where)] = time.perf_counter() - t0
    on_card, on_cpu = tuned[str(dev)], tuned["cpu"]
    check(picks(on_card) == picks(on_cpu), f"tune_cluster: card "
          f"{picks(on_card)} != CPU {picks(on_cpu)}")
    bal = [t.report["balanced_throughput_gflops"] for t in (on_card,
                                                            on_cpu)]
    check(abs(bal[0] / bal[1] - 1) <= ENERGY_REL, f"tune_cluster balanced "
          f"throughput: card {bal[0]}, CPU {bal[1]}")
    out["tune_cluster"] = dict(counts=on_card.counts,
                               dies=picks(on_card)[1],
                               balanced_throughput_gflops=bal,
                               converged=on_card.search.converged,
                               seconds=seconds)


# ---------------------------------------------------------------------------
# phase 3f: training tinyllama-1.1b (none of K1-K6 lies on this path)
# ---------------------------------------------------------------------------
# 40 steps of 8 x 512 tokens from the port's data pipeline with the train
# launcher's optimizer (warmup 10, a cosine to 10% at the last step) at lr
# 1e-3, not the launcher's 3e-3: at full width 3e-3 diverges (the loss
# climbs from 10.8 to 12.2) until a masked attention score lies more than
# ~88.7 above its row max, where exp(s - max) * mask, the reference's
# formula, gives inf * 0 = NaN (step 37 in bf16, step 12 in float32;
# PERF.md)
TRAIN = dict(steps=40, seq_len=512, batch=8, lr=1e-3, warmup=10)
# the loss falls: the mean of the last 5 losses below the mean of the
# first 5 by this much (the rule of tests/test_models_smoke.py)
TRAIN_DROP = 0.2
# the flash backward at layer 0's shape against autograd through a naive
# f32 attention: (case, keywords, the q rows taken); q_offset's case takes
# the last 1024 rows against every key
FLASH_BWD = (("causal, blocks 1024", dict(block_q=1024, block_k=1024), 0),
             ("causal, blocks 256", dict(block_q=256, block_k=256), 0),
             ("window 512", dict(window=512, block_q=256, block_k=256), 0),
             ("kv_len 1500", dict(kv_len=1500, block_q=256, block_k=256), 0),
             ("q_offset 1024", dict(q_offset=1024, block_q=256,
                                    block_k=256), 1024))
# dq, dk and dv within this share of max |g| of the naive attention's (the
# JAX package's bound for its own recompute backward, tests/test_attention.py)
FLASH_BWD_REL = 1e-5
# the card against the CPU, and the restart: tinyllama cut to 2 layers
# (full width), 2 x 128 tokens a step
TRAIN_CUT = dict(layers=2, batch=2, seq_len=128)
# card vs CPU in float32: the loss within this relative gap; from the same
# state every gradient leaf within GRAD_REL * max |g|, and AdamW on the same
# gradients moving each weight within UPDATE_LR of the lr of the other
# side's (the two differ in the global norm's summation order alone);
# after two steps each on its own side a weight within PARAM_LR of the lr
# summed: Adam moves a weight by about lr whatever its gradient's size, so
# a gradient near zero whose sign differs between the sides moves its
# weight by up to 2 lr the other way, and Adam's step is at most ~1.2 lr
# at these betas (an H100 reads up to 0.31 against its CPU host)
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_UPDATE_LR = 1e-3
TRAIN_PARAM_LR = 2.5
# microbatches=2 against one batch (bf16, full width): the loss within this
# relative gap; each weight within two bf16 ulps of its size (2**-7 |p|
# each) plus twice the step's lr: the two f32 updates may round to
# neighbouring bf16 values, and Adam's step may differ by up to lr where
# a gradient's sign differs
TRAIN_MICRO_LOSS_REL = 1e-3
# the restart: 8 steps with a checkpoint every 2 and failures before steps
# 3 and 6, in a child process set deterministic before CUDA starts (the
# embedding's gradient is a scatter-add, atomics without it)
RESTART = dict(steps=8, every=2, fail_at=(3, 6))
# the launcher's run on the card (its reduced config, its own flags)
TRAIN_LAUNCH_STEPS = 20


def naive_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    q_offset=0, **_):
    """Dense f32 softmax attention with k and v repeated over each group."""
    import math
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else kv_len
    kr = k.repeat_interleave(Hq // Hkv, dim=2)
    vr = v.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(D)
    qp = q_offset + torch.arange(Sq, device=q.device)
    kp = torch.arange(Sk, device=q.device)
    mask = (kp[None, :] < kv_len).expand(Sq, Sk)
    if causal:
        mask = mask & (kp[None, :] <= qp[:, None])
    if window:
        mask = mask & (kp[None, :] > qp[:, None] - window)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


def flash_backward_full_width(model, params, rng):
    """(a) ``flash_attention_trainable``'s dq, dk and dv on layer 0's f32
    operands against autograd through ``naive_attention``, each case's
    peak memory beside the naive one's."""
    from repro_torch.models.flash_vjp import flash_attention_trainable
    dev = model.device
    q0, k0, v0 = (t.float() for t in
                  attention_layer0_operands(model, params, rng))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = []
    for name, kw, row0 in FLASH_BWD:
        q = q0[:, row0:]
        w = torch.randn(q.shape, generator=gen, device=dev)
        out = {}
        for label, fn in (("flash", flash_attention_trainable),
                          ("naive", naive_attention)):
            qkv = [t.clone().requires_grad_(True) for t in (q, k0, v0)]
            release()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            grads = torch.autograd.grad((fn(*qkv, **kw) * w).sum(), qkv)
            torch.cuda.synchronize()
            out[label] = (grads, time.perf_counter() - t0,
                          torch.cuda.max_memory_allocated() - base)
            del qkv
        rels = []
        for what, g, ref in zip("qkv", out["flash"][0], out["naive"][0]):
            check(bool(torch.isfinite(g).all()), f"flash backward {name}: "
                  f"d{what} not finite")
            rel = float((g - ref).abs().max() / ref.abs().max())
            check(rel <= FLASH_BWD_REL, f"flash backward {name}: d{what} "
                  f"{rel:.3g} of max |g| from the naive attention's")
            rels.append(rel)
        cases.append(dict(case=name, q_rows=q.shape[1], rel_err_dqkv=rels,
                          seconds=out["flash"][1],
                          naive_seconds=out["naive"][1],
                          peak_bytes=out["flash"][2],
                          naive_peak_bytes=out["naive"][2]))
        del out
    return dict(q=list(q0.shape), kv=list(k0.shape), dtype="float32",
                bound=FLASH_BWD_REL, cases=cases)


def bits(t):
    """``t`` viewed as integers of its width: equal views are equal bits."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def grad_leaves(model, params, batch):
    """Every parameter leaf's gradient of ``model.loss_fn`` on ``batch``,
    in the tree's leaf order, and the loss."""
    from repro_torch.train import tree
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = model.loss_fn(tree.unflatten(params, live), batch)
    return torch.autograd.grad(loss, live), loss.detach()


def train_full_width(model, dev, smi):
    """(b) tinyllama-1.1b at full width and depth (bf16, ``cfg.remat``)
    trains TRAIN's steps from ``LM.init(SEED)``: the loss finite and
    falling, ``grad_norm`` > 0 each step; step wall and device ms, the
    idle share, tokens/s, model FLOP/s and peak memory.  Returns the final
    state, the step function and the optimizer's config for (c)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.train import tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_state, make_train_step
    cfg = model.cfg
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                           total_steps=TRAIN["steps"])
    dcfg = for_arch(cfg, seq_len=TRAIN["seq_len"],
                         global_batch=TRAIN["batch"])
    release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, SEED, opt)
    step = make_train_step(model, opt)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    losses, norms, walls, device_ms, top = [], [], [], None, []
    profiled = TRAIN["steps"] // 2
    for i in range(TRAIN["steps"]):
        batch = make_batch(dcfg, i, dev)
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if i == profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            walls.append(time.perf_counter() - t0)
        if i == profiled:
            kernels = {}  # device-side events only: an op's time is its
            for e in prof.key_averages():  # kernels' (not the device span
                if kernel_event(e):  # of a record_function scope)
                    kernels[e.key] = kernels.get(e.key, 0.0) \
                        + e.device_time_total / 1e3
            device_ms = sum(kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        losses.append(loss)
        norms.append(norm)
        if not (np.isfinite(loss) and np.isfinite(norm) and norm > 0):
            emit({"phase": "train", "failed_at_step": i, "losses": losses,
                  "grad_norms": norms})
            fail(f"train step {i}: loss {loss}, grad_norm {norm}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first - TRAIN_DROP, f"train: the loss did not fall by "
          f"{TRAIN_DROP}: first 5 {first:.4f}, last 5 {last:.4f}")
    tokens = TRAIN["batch"] * TRAIN["seq_len"]
    # the unprofiled steps' median: the profiler adds host time, not
    # device time, to the step it records
    wall = float(np.median([w for i, w in enumerate(walls)
                            if i not in (0, profiled)]))
    rec = dict(
        arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
        remat=cfg.remat, parameters=n_params, **TRAIN,
        losses=losses, grad_norms=norms, first5=first, last5=last,
        step_wall_ms=wall * 1e3, first_step_wall_ms=walls[0] * 1e3,
        profiled_step=profiled,
        profiled_step_wall_ms=walls[profiled] * 1e3,
        profiled_step_device_ms=device_ms or "not measured",
        top_kernels_ms=[[k[:80], v] for k, v in top] if device_ms else [],
        tokens_per_s=tokens / wall,
        model_flops_per_s=8 * n_params * tokens / wall,
        flops_counted="6 N T + the remat forward's 2 N T, N every "
                      "parameter (the tied embedding once)",
        peak_bytes=torch.cuda.max_memory_allocated() - base, card=smi)
    return state, step, opt, dcfg, rec


def train_microbatches(model, state, step, opt, dcfg):
    """(c) the same batch through ``microbatches=2`` and through one batch
    from the trained state: the loss within TRAIN_MICRO_LOSS_REL, each
    weight within one bf16 ulp of its size plus the step's lr."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train import tree
    from repro_torch.train.train_loop import make_train_step
    batch = make_batch(dcfg, TRAIN["steps"], model.device)
    one, m1 = step(state, batch)
    two, m2 = make_train_step(model, opt, microbatches=2)(state, batch)
    l1, l2, lr = float(m1["loss"]), float(m2["loss"]), float(m1["lr"])
    rel = abs(l1 - l2) / abs(l1)
    check(rel <= TRAIN_MICRO_LOSS_REL, f"microbatches=2: loss {l2} vs {l1}")
    check(sorted(m2) == ["grad_norm", "loss", "lr"],
          f"microbatches=2: metrics {sorted(m2)}")
    worst = 0.0
    for a, b in zip(tree.leaves(one.params),
                    tree.leaves(two.params)):
        a, b = a.float(), b.float()
        worst = max(worst, float(((a - b).abs()
                                  / (2.0 ** -7 * a.abs() + lr)).max()))
    check(worst <= 2.0, f"microbatches=2: a weight {worst:.3g} x (one bf16 "
          "ulp + lr) from the one-batch update")
    return dict(loss=l1, loss_microbatches=l2, loss_rel=rel,
                grad_norm=float(m1["grad_norm"]),
                grad_norm_microbatches=float(m2["grad_norm"]), lr=lr,
                param_gap_over_ulp_plus_lr=worst)


def train_card_vs_cpu(cfg, dev):
    """(d) tinyllama at full width cut to TRAIN_CUT's depth in float32:
    two steps on the card (``make_train_step``) and on the CPU (its
    gradients and ``apply_updates``, the step's own two calls) from the
    same state on the same batches.  Each step from the CPU's state: every
    gradient leaf, and ``apply_updates`` on the CPU's gradients (the
    weights within TRAIN_UPDATE_LR of the lr, the moments within
    TRAIN_GRAD_REL of their max); the card's own steps: the loss, and
    after two the weights within TRAIN_PARAM_LR of the lr summed."""
    import dataclasses
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.models import LM
    from repro_torch.train import tree
    from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                             init_state)
    from repro_torch.train.train_loop import TrainState, make_train_step
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT["layers"],
                              dtype="float32")
    models = {"cpu": LM(cut, device="cpu"), "cuda": LM(cut, device=dev)}
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=4)
    params = models["cpu"].init(seed=SEED)
    cpu = TrainState(params, init_state(params, opt),
                          torch.zeros((), dtype=torch.int32))
    card = tree.map(lambda t: t.to(dev), cpu)
    card_step = make_train_step(models["cuda"], opt)
    dcfg = for_arch(cut, seq_len=TRAIN_CUT["seq_len"],
                         global_batch=TRAIN_CUT["batch"])

    def gap(on_card, on_cpu, scale):
        """max |card - cpu| over the leaves, each over ``scale(cpu)``."""
        return max(float((a.cpu() - b).abs().max() / scale(b))
                   for a, b in zip(tree.leaves(on_card), tree.leaves(on_cpu)))

    def to(tree_, d):
        return tree.map(lambda t: t.to(d), tree_)

    rows = []
    lr_sum = 0.0
    for i in range(2):
        batches = {k: make_batch(dcfg, i, mdl.device)
                   for k, mdl in models.items()}
        # every gradient leaf, and the update, from the same (the CPU's)
        # state
        grads = {k: grad_leaves(mdl, to(cpu.params, mdl.device),
                                 batches[k])
                 for k, mdl in models.items()}
        grad_rel = gap(grads["cuda"][0], grads["cpu"][0],
                       lambda c: c.abs().max().clamp(min=1e-30))
        check(grad_rel <= TRAIN_GRAD_REL, f"card vs CPU step {i}: a "
              f"gradient leaf {grad_rel:.3g} of its max |g| apart")
        g_cpu = tree.unflatten(cpu.params, list(grads["cpu"][0]))
        with torch.no_grad():
            upd = {k: apply_updates(*to((cpu.params, g_cpu, cpu.opt),
                                        mdl.device), opt)
                   for k, mdl in models.items()}
        lr = float(upd["cpu"][2]["lr"])
        update_gap = gap(upd["cuda"][0], upd["cpu"][0], lambda c: lr)
        moment_gap = gap(upd["cuda"][1][:2], upd["cpu"][1][:2],
                         lambda c: c.abs().max().clamp(min=1e-30))
        check(update_gap <= TRAIN_UPDATE_LR and moment_gap <= TRAIN_GRAD_REL,
              f"card vs CPU step {i}: apply_updates on the same gradients "
              f"moves a weight {update_gap:.3g} lr, a moment "
              f"{moment_gap:.3g} of its max apart")
        loss_cpu = float(grads["cpu"][1])
        cpu = TrainState(upd["cpu"][0], upd["cpu"][1], cpu.step + 1)
        card, mg = card_step(card, batches["cuda"])
        loss_rel = abs(float(mg["loss"]) - loss_cpu) / abs(loss_cpu)
        check(loss_rel <= TRAIN_LOSS_REL, f"card vs CPU step {i}: loss "
              f"{float(mg['loss'])} vs {loss_cpu}")
        lr_sum += lr
        param_gap = gap(card.params, cpu.params, lambda c: lr_sum)
        check(param_gap <= TRAIN_PARAM_LR, f"card vs CPU step {i}: a "
              f"weight {param_gap:.3g} of the lr summed apart")
        rows.append(dict(step=i, loss_cpu=loss_cpu,
                         loss_card=float(mg["loss"]), loss_rel=loss_rel,
                         grad_norm_cpu=float(upd["cpu"][2]["grad_norm"]),
                         grad_norm_card=float(mg["grad_norm"]),
                         grad_leaf_rel=grad_rel,
                         same_state_update_over_lr=update_gap,
                         same_state_moment_rel=moment_gap,
                         param_gap_over_lr_sum=param_gap))
    return dict(dtype="float32", **TRAIN_CUT,
                bounds=dict(loss_rel=TRAIN_LOSS_REL,
                            grad_leaf_rel=TRAIN_GRAD_REL,
                            update_over_lr=TRAIN_UPDATE_LR,
                            param_over_lr_sum=TRAIN_PARAM_LR), steps=rows)


def train_restart_child():
    """(e), run as ``python -m chip_smoke --train-restart`` with
    ``CUBLAS_WORKSPACE_CONFIG`` set and deterministic algorithms on before
    CUDA starts: tinyllama at TRAIN_CUT's depth in bf16 trained
    uninterrupted, then through ``run_with_restarts`` with RESTART's
    failures into a temporary directory; the final params, moments and
    counters bitwise equal.  Prints one JSON line with each save's and
    restore's bytes and seconds."""
    import dataclasses
    import os
    import tempfile
    torch.use_deterministic_algorithms(True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import (failure_schedule,
                                                   run_with_restarts)
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.train import tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (make_train_state,
                                              make_train_step, train_loop)
    dev = torch.device("cuda")
    cut = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_CUT["layers"])
    model = LM(cut, device=dev)
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=2,
                           total_steps=RESTART["steps"])
    dcfg = for_arch(cut, seq_len=TRAIN_CUT["seq_len"],
                         global_batch=TRAIN_CUT["batch"])

    def data(i):
        return make_batch(dcfg, i, dev)

    def make_state():
        return make_train_state(model, SEED, opt)

    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    ref, _ = train_loop(model, make_state(), step, data,
                        n_steps=RESTART["steps"])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    saves, restores = [], []

    class Timed(CheckpointManager):
        def save(self, s, tree_, extra=None, block=False):
            t = time.perf_counter()
            super().save(s, tree_, extra, block=True)
            d = os.path.join(self.directory, f"step_{s}")
            saves.append(dict(step=s, seconds=time.perf_counter() - t,
                              bytes=sum(os.path.getsize(os.path.join(d, f))
                                        for f in os.listdir(d))))

        def restore(self, like, step=None, shardings=None):
            t = time.perf_counter()
            out = super().restore(like, step, shardings)
            torch.cuda.synchronize()
            restores.append(dict(step=int(out[1]["step"]),
                                 seconds=time.perf_counter() - t))
            return out

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        final, _, restarts = run_with_restarts(
            model, make_state, step, data, n_steps=RESTART["steps"],
            manager=Timed(d, keep=2, async_save=False),
            checkpoint_every=RESTART["every"],
            failure_hook=failure_schedule(set(RESTART["fail_at"])))
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
    differ = [path for path, a, b in zip(tree.paths(final),
                                         tree.leaves(ref), tree.leaves(final))
              if not torch.equal(bits(a), bits(b))]
    print(json.dumps(dict(restarts=restarts, leaves=len(tree.leaves(ref)),
                          leaves_differing=differ, saves=saves,
                          restores=restores, uninterrupted_s=ref_s,
                          with_restarts_s=restart_s)), flush=True)
    return 0 if restarts == len(RESTART["fail_at"]) and not differ else 1


def train_restart_result(child):
    """(e)'s gates on the child's JSON line."""
    lines, wall = child.finish()
    rec = json.loads(lines[-1])
    check(rec["restarts"] == len(RESTART["fail_at"]),
          f"restart: {rec['restarts']} restarts")
    check(not rec["leaves_differing"], "restart: the final state differs "
          f"from the uninterrupted run's at {rec['leaves_differing']}")
    return dict(layers=TRAIN_CUT["layers"], dtype="bfloat16", **RESTART,
                deterministic="CUBLAS_WORKSPACE_CONFIG=:4096:8, "
                "torch.use_deterministic_algorithms(True)",
                bitwise=True, wall_s=wall, **rec)


def train_launcher_result(launcher):
    """(f) ``launch.train`` on the card: exit 0, its rows' loss falling."""
    import ast
    lines, wall = launcher.finish()
    rows = [ast.literal_eval(x) for x in lines if x.startswith("{")]
    check(len(rows) >= 2 and rows[-1]["loss"] < rows[0]["loss"],
          f"launch.train: the loss did not fall: {lines}")
    check(lines[-1].startswith(f"trained {ARCH} (reduced) for "
                               f"{TRAIN_LAUNCH_STEPS} steps"),
          f"launch.train: {lines[-1:]}")
    return dict(lines=lines[-3:], wall_s=wall)


def emulated_train_refused(cfg, dev):
    """(g) a train step of tinyllama at TRAIN_CUT's depth under
    ``EmulatedPolicy(bf16, fused)`` on the card raises ``NoBackwardError``
    (K1 has no backward); returning a state fails the phase."""
    import dataclasses
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.kernels._build import NoBackwardError
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_state, make_train_step
    model = LM(dataclasses.replace(cfg, n_layers=TRAIN_CUT["layers"]),
               device=dev)
    opt = AdamWConfig(lr=TRAIN["lr"])
    state = make_train_state(model, SEED, opt)
    step = make_train_step(model, opt,
                                policy=EmulatedPolicy("bf16", "fused"))
    dcfg = for_arch(model.cfg, seq_len=TRAIN_CUT["seq_len"],
                         global_batch=TRAIN_CUT["batch"])
    try:
        step(state, make_batch(dcfg, 0, dev))
    except NoBackwardError as e:
        return str(e)[:120]
    fail("a train step under EmulatedPolicy(bf16, fused) returned a state "
         "on the card")


def train_path(model, params, dev, smi):
    """Phase 3f: (e) and (f) start as child processes, then (a), (d), (g),
    (b) and (c) run here; (e) and (f) are read last."""
    t_phase = time.perf_counter()
    children = (Launcher("chip_smoke", "--train-restart", env=dict(
                    CUBLAS_WORKSPACE_CONFIG=":4096:8")),
                Launcher("repro_torch.launch.train", "--arch", ARCH,
                         "--steps", str(TRAIN_LAUNCH_STEPS)))
    out = {}
    try:
        t0 = time.perf_counter()
        out["flash_backward"] = flash_backward_full_width(
            model, params, np.random.default_rng(SEED + 3))
        out["flash_backward"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["card_vs_cpu"] = train_card_vs_cpu(model.cfg, dev)
        out["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
        out["emulated_policy_refused"] = emulated_train_refused(model.cfg,
                                                                dev)
        t0 = time.perf_counter()
        out["restart"] = train_restart_result(children[0])
        out["launcher"] = train_launcher_result(children[1])
        out["children_waited_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, step, opt, dcfg, out["full_width"] = train_full_width(
            model, dev, smi)
        out["full_width"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["microbatches"] = train_microbatches(model, state, step, opt,
                                                 dcfg)
        out["microbatches"]["seconds"] = time.perf_counter() - t0
        del state
    finally:
        for child in children:
            child.close()
    release()
    emit({"phase": "train", "arch": ARCH, "seconds":
          time.perf_counter() - t_phase, **out})


# ---------------------------------------------------------------------------
# phase 3h: distribution on a world of one NCCL rank
# ---------------------------------------------------------------------------
DIST_CUT = dict(layers=2, batch=2, seq_len=128)
# (b)'s contract, the JAX package's sharded-vs-unsharded test's: the loss
# within DIST_REL relative, every weight within DIST_REL
DIST_REL = 1e-4
DIST_MOE = dict(batch=2, seq_len=512)
# (c): the distributed MoE against moe_apply in float32, of max |out|
DIST_MOE_REL = 1e-5
DIST_PIPE = dict(n_micro=8, mb=2)
DIST_LAUNCH_STEPS = 10
# (f): tinyllama's layer-0 q projection of 4 x 128 tokens
DIST_K1 = dict(batch=4, prompt=128)


@contextlib.contextmanager
def nccl_world_of_one():
    """A process group of one NCCL rank (this process, the card) through
    a file store in a temporary directory, torn down on leaving."""
    import os
    import tempfile
    from datetime import timedelta
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "store"), rank=0, world_size=1,
            timeout=timedelta(seconds=120), device_id=torch.device("cuda", 0))
        try:
            yield
        finally:
            dist.destroy_process_group()


def dist_k1_operands(params, dev):
    """(f)'s operands: normal bf16 activations (DIST_K1 x d_model) and
    layer 0's wq; and the unsharded K1 result (``policy_matmul`` on the
    plain tensors), taken outside the launch window."""
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.numerics.emulate import policy_matmul
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    w = params["layers"]["wq"][0]
    x = torch.randn((DIST_K1["batch"], DIST_K1["prompt"], w.shape[0]),
                    generator=gen, device=dev).to(torch.bfloat16)
    return x, w, policy_matmul(x, w, EmulatedPolicy("bf16", "fused"))


def dist_train_full_width(model, dev, smi, ctx):
    """(a) one sharded train step of tinyllama-1.1b at full width and depth
    (bf16, remat) from a fresh state laid out by ``param_specs``, the
    train phase's batch shape, and a second one timed and profiled (the
    card's activity only: DTensor's host dispatch makes a CPU trace cost
    seconds to read): the loss finite and ``grad_norm`` > 0; step wall and
    device ms, the idle share, peak bytes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_state, make_train_step
    cfg = model.cfg
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                      total_steps=TRAIN["steps"])
    dcfg = for_arch(cfg, seq_len=TRAIN["seq_len"],
                    global_batch=TRAIN["batch"])
    release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with sh.use_mesh(ctx):
        state = make_train_state(model, SEED, opt)
        specs = sh.param_specs(state, cfg.n_experts, ctx)
        state = sh.distribute_tree(state, specs, ctx)
        step = make_train_step(model, opt, grad_shardings=sh.named_shardings(
            specs.params, ctx))
        walls, losses, norms, device_ms = [], [], [], None
        for i in range(2):
            batch = make_batch(dcfg, i, dev)
            torch.cuda.synchronize()
            with (profile(activities=[ProfilerActivity.CUDA])
                  if i == 1 else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                walls.append(time.perf_counter() - t0)
            check(np.isfinite(losses[-1]) and np.isfinite(norms[-1])
                  and norms[-1] > 0, f"sharded step {i}: loss {losses[-1]}, "
                  f"grad_norm {norms[-1]}")
        kernels = {}
        for e in prof.key_averages():
            if kernel_event(e):
                kernels[e.key] = kernels.get(e.key, 0.0) \
                    + e.device_time_total / 1e3
        device_ms = sum(kernels.values())
        placements = sorted({str(tuple(p.placements))
                             for p in tree.leaves(state.params)})
    del state
    return dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                remat=cfg.remat, mesh=dict(ctx.axes), batch=TRAIN["batch"],
                seq_len=TRAIN["seq_len"], losses=losses, grad_norms=norms,
                first_step_wall_ms=walls[0] * 1e3,
                step_wall_ms=walls[1] * 1e3,
                step_device_ms=device_ms or "not measured",
                top_kernels_ms=[[k[:80], v] for k, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1])[:6]],
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                param_placements=placements, card=smi)


def dist_cut_vs_unsharded(cfg, dev, ctx):
    """(b) tinyllama at full width cut to DIST_CUT's depth in float32: one
    step sharded and one unsharded from the same state on the same batch,
    the loss within DIST_REL relative and every weight within DIST_REL.
    Returns the record and the sharded state and its specs for (e)."""
    import dataclasses
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.models import LM
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_state, make_train_step
    cut = dataclasses.replace(cfg, n_layers=DIST_CUT["layers"],
                              dtype="float32")
    model = LM(cut, device=dev)
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=4)
    batch = make_batch(for_arch(cut, seq_len=DIST_CUT["seq_len"],
                                global_batch=DIST_CUT["batch"]), 0, dev)
    state = make_train_state(model, SEED, opt)
    plain, pm = make_train_step(model, opt)(state, batch)
    with sh.use_mesh(ctx):
        specs = sh.param_specs(state, cut.n_experts, ctx)
        sharded, sm = make_train_step(
            model, opt, grad_shardings=sh.named_shardings(
                specs.params, ctx))(sh.distribute_tree(state, specs, ctx),
                                    batch)
        gap = max(float((sh.full(a) - b).abs().max()) for a, b in
                  zip(tree.leaves(sharded.params), tree.leaves(plain.params)))
    loss_rel = abs(float(sm["loss"]) - float(pm["loss"])) \
        / abs(float(pm["loss"]))
    check(loss_rel <= DIST_REL and gap <= DIST_REL, f"sharded vs unsharded "
          f"step: loss rel {loss_rel:.3g}, a weight {gap:.3g} apart")
    return dict(dtype="float32", **DIST_CUT, loss=float(pm["loss"]),
                loss_sharded=float(sm["loss"]), loss_rel=loss_rel,
                grad_norm=float(pm["grad_norm"]),
                grad_norm_sharded=float(sm["grad_norm"]),
                max_weight_gap=gap, bound=DIST_REL), sharded, specs


def dist_checkpoint(state, specs, ctx):
    """(e) the sharded 2-layer state saved from the mesh and restored with
    ``shardings=``: every leaf bitwise and with its placements."""
    import tempfile
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    from repro_torch.train.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1, async_save=False)
        t0 = time.perf_counter()
        mgr.save(1, state, block=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = mgr.restore(state, shardings=sh.named_shardings(specs, ctx))
        restore_s = time.perf_counter() - t0
    n_bytes, differing = 0, []
    for i, (a, b) in enumerate(zip(tree.leaves(state), tree.leaves(back))):
        laid_out = sh.is_dtensor(b) and tuple(b.placements) == tuple(
            a.placements)
        a, b = sh.full(a), sh.full(b)
        n_bytes += a.numel() * a.element_size()
        if not (laid_out and a.dtype == b.dtype
                and torch.equal(bits(a), bits(b))):
            differing.append(i)
    check(not differing, f"restore with shardings: leaves {differing} "
          "differ from the saved state")
    return dict(leaves=len(tree.leaves(state)), bytes=n_bytes, bitwise=True,
                save_s=save_s, restore_s=restore_s)


def dist_moe_full_width(dev, ctx, smi, timed):
    """(c) deepseek-moe-16b's layer-0 MoE at full width (64 experts, top 6,
    2 shared, d 2048) on DIST_MOE tokens, at ``capacity_factor =
    n_experts``: ``moe_apply_distributed`` against ``moe_apply`` in
    float32 within DIST_MOE_REL of max |out|; with ``timed``, both in bf16
    timed and their gap printed, not gated (a random router turns
    last-bit differences into other experts, ROADMAP 3)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.moe_sharded import moe_apply_distributed
    from repro_torch.parallel import sharding as sh
    mcfg = get_config(MOE_ARCH)
    kw = dict(top_k=mcfg.experts_per_token,
              capacity_factor=float(mcfg.n_experts))
    dtype = torch.bfloat16 if timed else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    p = moe_init(gen, mcfg.d_model, n_experts=mcfg.n_experts,
                 moe_d_ff=mcfg.moe_d_ff, n_shared=mcfg.n_shared_experts,
                 dtype=dtype)
    x = torch.randn((DIST_MOE["batch"], DIST_MOE["seq_len"], mcfg.d_model),
                    generator=gen, device=dev).to(dtype)
    with torch.no_grad(), sh.use_mesh(ctx):
        def dist_fn():
            return moe_apply_distributed(p, x, ctx=ctx, **kw)

        got, aux = dist_fn()
        got = sh.full(got)
        want, want_aux = moe_apply(p, x, **kw)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        rec = dict(arch=mcfg.name, layer=0, **DIST_MOE, **kw,
                   dtype=str(dtype).removeprefix("torch."),
                   max_abs_err=err, max_abs_out=scale,
                   dropped=float(sh.full(aux["dropped_frac"])),
                   aux_loss=float(sh.full(aux["aux_loss"])),
                   aux_loss_moe_apply=float(want_aux["aux_loss"]))
        if timed:
            flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
            rec["ms"] = time_ms(dist_fn, flush, reps=5, warm=1)
            rec["moe_apply_ms"] = time_ms(lambda: moe_apply(p, x, **kw),
                                          flush, reps=5, warm=1)
            rec["card"] = smi
        else:
            check(err <= DIST_MOE_REL * scale, f"distributed MoE vs "
                  f"moe_apply in float32: {err} > {DIST_MOE_REL} x {scale}")
            rec["bound"] = DIST_MOE_REL * scale
    return rec


def dist_pipeline(dev):
    """(d) ``pipeline_forward`` with one stage on a ('pod',) mesh of the
    one rank: tanh(h @ W) over DIST_PIPE's microbatches of d_model 2048,
    bitwise the same function applied microbatch by microbatch."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    d = 2048
    w = torch.randn((1, d, d), generator=gen, device=dev) * d ** -0.5
    x = torch.randn((DIST_PIPE["n_micro"], DIST_PIPE["mb"], d),
                    generator=gen, device=dev)

    def stage(wt, h):
        return torch.tanh(h @ wt)

    got = pipeline_forward(stage, 1, mesh, axis="pod")(w, x)
    want = torch.stack([stage(w[0], x[m]) for m in range(x.shape[0])])
    check(torch.equal(bits(got), bits(want)), "pipeline_forward with one "
          "stage differs from the sequential result")
    return dict(stages=1, d=d, **DIST_PIPE, bitwise=True)


def dist_k1(x, w, ref, ctx):
    """(f) the bf16 ``fused`` policy matmul of (a)'s operands as DTensors
    on the mesh (x sharded over the batch and its K over 'model', w by
    ('fsdp', 'tensor')): redistributed to ``Replicate``, K1 launched once
    on the full operands, bitwise the unsharded K1; and the K1 wrapper
    handed the DTensors directly refuses them."""
    from repro_torch.kernels import fused
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.numerics import get_format
    from repro_torch.numerics.emulate import policy_matmul
    from repro_torch.parallel import sharding as sh
    with sh.use_mesh(ctx):
        xd = sh.shard(x, "batch", None, "tensor")
        wd = sh.redistribute(w, ctx.mesh, sh.placements(
            sh.spec_for(("fsdp", "tensor"), tuple(w.shape)), ctx.mesh))
        before = fused.fused_qmm.launches
        out = policy_matmul(xd, wd, EmulatedPolicy("bf16", "fused"))
        launched = fused.fused_qmm.launches - before
        try:
            fused.fused_qmm(xd, wd, fmt=get_format("bf16"))
            refused = None
        except TypeError as e:
            refused = str(e)[:100]
    check(launched == 1, f"the policy matmul on the mesh launched K1 "
          f"{launched} times")
    check(torch.equal(bits(out.to_local()), bits(ref)),
          "the policy matmul on the mesh differs from the unsharded K1")
    check(refused is not None, "fused_qmm accepted a DTensor")
    return dict(shape=[list(x.shape), list(w.shape)],
                placements=[str(p) for p in out.placements],
                k1_launches=launched, bitwise=True, refused=refused)


def dist_launcher_result(child):
    """(g) ``launch.train --devices 1`` on the card: exit 0, its step-10 row
    below the loss of a uniform prediction over the padded vocabulary
    (where the random init starts), its last line naming one device."""
    import ast
    import math
    lines, wall = child.finish()
    rows = [ast.literal_eval(x) for x in lines if x.startswith("{")]
    check(lines[-1] == f"trained {ARCH} (reduced) for {DIST_LAUNCH_STEPS} "
          "steps on 1 device(s)", f"launch.train --devices 1: {lines[-1:]}")
    check(len(rows) == 1 and rows[0]["loss"] < math.log(256),
          f"launch.train --devices 1: the loss did not fall: {lines}")
    return dict(lines=lines[-2:], wall_s=wall, uniform_loss=math.log(256))


def distributed_path(model, params, dev, smi, k1, fused_ref):
    """Phase 3h: (g) starts as a child process; then on a world of one
    NCCL rank with a (data=1, model=1) mesh (b), (e), (c) in float32, (d),
    (f) and (h) run while it does; (g) is read, and (a) and (c)'s bf16 times
    are taken with the card to this process alone; the group is
    destroyed."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as sh
    t_phase = time.perf_counter()
    child = Launcher("repro_torch.launch.train", "--arch", ARCH, "--steps",
                     str(DIST_LAUNCH_STEPS), "--devices", "1")
    out = {}

    def run(name, fn):
        t0 = time.perf_counter()
        rec = fn()
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        release()

    try:
        with nccl_world_of_one():
            ctx = sh.make_context(make_host_mesh(data=1, model=1))
            t0 = time.perf_counter()
            rec, state, specs = dist_cut_vs_unsharded(model.cfg, dev, ctx)
            out["cut_vs_unsharded"] = dict(rec, seconds=time.perf_counter()
                                           - t0)
            run("checkpoint", lambda: dist_checkpoint(state, specs, ctx))
            del state
            run("moe_layer0", lambda: dist_moe_full_width(dev, ctx, smi,
                                                          timed=False))
            run("pipeline", lambda: dist_pipeline(dev))
            run("policy_matmul_k1", lambda: dist_k1(*k1, ctx))
            run("decode_on_mesh", lambda: dist_decode(model, params, dev,
                                                      ctx))
            run("chunks_on_mesh", lambda: dist_chunks(model, params, dev,
                                                      ctx, fused_ref))
            t0 = time.perf_counter()
            out["launcher"] = dist_launcher_result(child)
            out["launcher_waited_s"] = time.perf_counter() - t0
            run("full_width_step",
                lambda: dist_train_full_width(model, dev, smi, ctx))
            run("moe_layer0_bf16_times", lambda: dist_moe_full_width(
                dev, ctx, smi, timed=True))
        import torch.distributed as dist
        check(not dist.is_initialized(), "the process group outlived the "
              "phase")
    finally:
        child.close()
    release()
    emit({"phase": "distributed", "arch": ARCH, "world": 1,
          "backend": "nccl", "seconds": time.perf_counter() - t_phase,
          **out})


# (h): 8 decode steps on the (1, 1) mesh after a 2 x 64 prefill; then the
# prompt in chunks of 16, a chunk over lanes PAD_SLOTS of that 2-lane cache
# (slot id 2 a pad lane) and a fused chunk, each on the mesh and plain
DIST_DECODE = dict(batch=2, prompt=64, steps=8, max_len=128)
DIST_CHUNK = 16
PAD_SLOTS = (0, 2, 1)
# 3i (a): the dry run's cells of tinyllama-1.1b on pod16x16 in the child
DRYRUN_SHAPES = ("decode_32k", "train_4k")
# 3i (b): record_function scopes timed on the host
SCOPE_REPS = 20000


def dist_tokens(model, dev):
    """(h)'s prompt (batch x prompt), its decode tokens (steps x batch x
    1), and the pad-lane chunk's tokens (3 x DIST_CHUNK)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    B = DIST_DECODE["batch"]
    vocab = model.cfg.vocab_size
    return tuple(torch.randint(0, vocab, shape, generator=gen, device=dev)
                 for shape in ((B, DIST_DECODE["prompt"]),
                               (DIST_DECODE["steps"], B, 1),
                               (len(PAD_SLOTS), DIST_CHUNK)))


def on_mesh(model, cache, batch, ctx):
    """``cache`` of ``batch`` lanes laid out on the mesh as
    ``launch.specs`` lays it out."""
    from repro_torch.launch.specs import _cache_specs
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    return tree.map(lambda t, s: sh.redistribute(t, s.mesh, s.placements),
                    cache, _cache_specs(model, cache, batch, ctx))


def fresh_lanes(model, dev):
    """A zeroed cache of (h)'s lanes with per-lane lengths."""
    from repro_torch.models.model import DecodeCache
    B = DIST_DECODE["batch"]
    return DecodeCache(model.init_cache(B, DIST_DECODE["max_len"]).data,
                       torch.zeros(B, dtype=torch.int64, device=dev))


def fused_chunk(model, params, cache, prompt):
    """The first DIST_CHUNK tokens of ``prompt`` into ``cache`` under
    EmulatedPolicy(bf16, fused)."""
    from repro_torch.models.numerics import EmulatedPolicy
    B = prompt.shape[0]
    return model.prefill_chunk(
        params, cache, prompt[:, :DIST_CHUNK], [0] * B, [DIST_CHUNK] * B,
        list(range(B)), policy=EmulatedPolicy("bf16", "fused"))


def dist_fused_reference(model, params, dev):
    """(h)'s fused chunk on plain tensors, taken outside the launch
    window: (last logits, cache)."""
    last, cache = fused_chunk(model, params, fresh_lanes(model, dev),
                              dist_tokens(model, dev)[0])
    torch.cuda.synchronize()
    return last, cache


def dist_decode(model, params, dev, ctx):
    """(h) DIST_DECODE's decode steps of the full-width model unsharded and
    with the params and the cache distributed on the (1, 1) mesh: every
    step's logits and the final cache bitwise equal."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    B = DIST_DECODE["batch"]
    prompt, toks, _ = dist_tokens(model, dev)
    _, cache = model.prefill(params, prompt, max_len=DIST_DECODE["max_len"])
    start = tree.map(torch.clone, cache)
    want = []
    for t in toks:
        logits, cache = model.decode_step(params, cache, t)
        want.append(logits)
    with sh.use_mesh(ctx):
        dp = sh.distribute_tree(
            params, sh.param_specs(params, model.cfg.n_experts, ctx), ctx)
        dc = on_mesh(model, start, B, ctx)
        got = []
        for t in toks:
            logits, dc = model.decode_step(dp, dc, t)
            got.append(sh.full(logits))
        caches = {k: sh.full(v) for k, v in dc.data.items()}
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if not torch.equal(bits(a), bits(b))]
    cache_differ = [k for k, v in cache.data.items()
                    if not torch.equal(bits(v), bits(caches[k]))]
    check(not differ and not cache_differ, f"decode on the mesh: steps "
          f"{differ} and caches {cache_differ} differ from the plain decode")
    return dict(**DIST_DECODE, steps_bitwise=len(want), caches_bitwise=sorted(
        caches), length=int(sh.full(dc.length)))


def dist_chunks(model, params, dev, ctx, fused_ref):
    """(h) chunked prefill of the full-width model on the (1, 1) mesh
    against the plain one, bitwise: ``prefill_chunked`` of the prompt in
    chunks of DIST_CHUNK (the last logits, every cache leaf, the lengths);
    then a chunk over PAD_SLOTS of that cache, slot id 2 a pad lane (the
    real lanes' logits, the cache, the lengths, and the first DIST_CHUNK
    positions of lane 1, which the pad lane would overwrite, kept); then
    ``fused_chunk`` into a fresh cache against ``fused_ref``, its K1
    launches counted."""
    from repro_torch.kernels.fused import fused_qmm
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    prompt, _, pad_tokens = dist_tokens(model, dev)
    B, S = prompt.shape
    n, max_len = DIST_CHUNK, DIST_DECODE["max_len"]
    slots = torch.tensor(PAD_SLOTS, device=dev)
    real = slots < B
    pad_args = (pad_tokens, torch.where(real, S, 0), [n] * len(PAD_SLOTS),
                slots)

    def differ(want, got):
        """The leaves (and "length") where ``got`` is not ``want``'s bits."""
        pairs = dict(want.data, length=want.length)
        return [k for k, v in pairs.items() if not torch.equal(bits(v), bits(
            sh.full(got.length if k == "length" else got.data[k])))]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rec = dict(chunk=n, batch=B, prompt=S, pad_slots=list(PAD_SLOTS))
    (last, plain), rec["chunked_plain_s"] = timed(
        lambda: model.prefill_chunked(params, prompt, n, max_len=max_len))
    snap = tree.map(torch.clone, plain)
    (pad_last, plain), rec["pad_chunk_plain_s"] = timed(
        lambda: model.prefill_chunk(params, plain, *pad_args))
    with sh.use_mesh(ctx):
        dp = sh.distribute_tree(
            params, sh.param_specs(params, model.cfg.n_experts, ctx), ctx)
        (got_last, got), rec["chunked_mesh_s"] = timed(
            lambda: model.prefill_chunked(dp, prompt, n, max_len=max_len))
        chunked = differ(snap, got)
        check(torch.equal(bits(last), bits(sh.full(got_last)))
              and not chunked, f"prefill_chunked on the mesh: the last "
              f"logits or {chunked} differ from the plain one")
        (got_pad, got), rec["pad_chunk_mesh_s"] = timed(
            lambda: model.prefill_chunk(dp, got, *pad_args))
        padded = differ(plain, got)
        check(torch.equal(bits(pad_last[real]),
                          bits(sh.full(got_pad)[real])) and not padded,
              f"the pad-lane chunk on the mesh: the real lanes' logits or "
              f"{padded} differ from the plain chunk's")
        kept = [k for k in ("k", "v") if not torch.equal(
            bits(snap.data[k][:, :, :n]), bits(plain.data[k][:, :, :n]))]
        check(not kept and plain.length.tolist() == [S + n] * B,
              f"the pad lane wrote {kept} or the lengths "
              f"{plain.length.tolist()}")
        before = fused_qmm.launches
        (f_last, f_cache), rec["fused_mesh_s"] = timed(
            lambda: fused_chunk(model, dp, on_mesh(
                model, fresh_lanes(model, dev), B, ctx), prompt))
        launched = fused_qmm.launches - before
    per_fwd = 7 * model.cfg.n_layers + 1
    fused = differ(fused_ref[1], f_cache)
    check(launched == per_fwd, f"the fused chunk on the mesh launched K1 "
          f"{launched} times, expected {per_fwd}")
    check(torch.equal(bits(fused_ref[0]), bits(sh.full(f_last)))
          and not fused, f"the fused chunk on the mesh: the last logits or "
          f"{fused} differ from the plain chunk's")
    return dict(rec, chunked_bitwise=sorted(snap.data) + ["last_logits",
                                                         "length"],
                pad_chunk_bitwise=True, pad_lane_wrote_nothing=True,
                length=sh.full(got.length).tolist(),
                placements={k: [str(p) for p in v.placements]
                            for k, v in got.data.items()},
                fused_k1_launches=launched, fused_bitwise=True)


def dryrun_child(tech_values):
    """3i (a), run as ``python -m chip_smoke --dryrun TECH``: this process
    made rank 0 of a fake world of 256 ranks, ``run_cell`` of each of
    DRYRUN_SHAPES for tinyllama-1.1b on pod16x16 at full width (counted at
    the dry run's default depths), the chip policy on the card from the
    calibration ``TECH`` (``TechParams.values`` as JSON).  Prints one JSON
    line per row."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.energy_model import TechParams
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    fake_world(256)
    tech = TechParams(tuple(json.loads(tech_values)))
    for shape in DRYRUN_SHAPES:
        t0 = time.perf_counter()
        row = dryrun.run_cell(ARCH, shape, device="cuda", tech=tech,
                              verbose=False)
        print(json.dumps(dict(row, seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


def dryrun_result(child):
    """3i (a)'s gates on the child's rows."""
    lines, wall = child.finish()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    check([r.get("shape") for r in rows] == list(DRYRUN_SHAPES),
          f"dryrun child: {lines[-3:]}")
    for r in rows:
        check(r["status"] == "ok" and r["mesh"] == "pod16x16"
              and r["chips"] == 256 and r["flops_per_device"] > 0
              and r["chip_energy"]["unit"] == r["fpu_unit"],
              f"dryrun row {r['shape']}: {r}")
    keep = ("shape", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_breakdown",
            "model_flops", "bottleneck", "roofline_fraction",
            "fpu_unit", "memory", "counted_depths",
            "lower_s", "compile_s", "seconds")
    rows = [{k: r.get(k) for k in keep} for r in rows]
    return dict(rows=rows, wall_s=wall)


def dryrun_count_vs_meta(model, dev, smi):
    """3i (b): ``op_cost.count`` of one full-width train step on the card
    and of the same step on meta stand-ins, equal; the step's device
    time (its kernels' in a profile) and model FLOP share of the bf16
    peak."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.models import LM
    from repro_torch.roofline.analysis import model_flops_estimate
    from repro_torch.roofline.op_cost import count
    from repro_torch.train import tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_state, make_train_step
    cfg = model.cfg
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                      total_steps=TRAIN["steps"])
    batch = make_batch(for_arch(cfg, seq_len=TRAIN["seq_len"],
                                global_batch=TRAIN["batch"]), 0, dev)
    step = make_train_step(model, opt)
    state = make_train_state(model, SEED, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, card = count(step, state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    meta_model = LM(cfg, device="meta")
    meta_state = make_train_state(meta_model, SEED, opt)
    meta_batch = tree.map(lambda t: torch.empty_like(t, device="meta"),
                          batch)
    t0 = time.perf_counter()
    _, meta = count(make_train_step(meta_model, opt), meta_state,
                    meta_batch)
    meta_s = time.perf_counter() - t0
    fields = ("flops", "traffic_bytes", "collective_bytes")
    got = {f: getattr(card, f) for f in fields}
    want = {f: getattr(meta, f) for f in fields}
    check(got == want, f"op_cost on the card {got} and on meta stand-ins "
          f"{want} differ")
    check(card.flops > 0 and float(card.flops).is_integer()
          and float(card.traffic_bytes).is_integer(),
          f"op_cost counts not positive integers: {got}")
    step(state, batch)  # the step uncounted, warm, then its kernels' time
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    device_ms = sum(e.device_time_total for e in prof.key_averages()
                    if kernel_event(e)) / 1e3
    mflops = model_flops_estimate(cfg, ShapeSpec(
        "train", TRAIN["seq_len"], TRAIN["batch"], "train"))
    del state
    release()
    return dict(tokens=TRAIN["batch"] * TRAIN["seq_len"],
                flops=card.flops, traffic_bytes=card.traffic_bytes,
                collective_bytes=card.collective_bytes,
                scope_traffic=card.scope_traffic,
                peak_live_bytes=card.peak_live_bytes, counted_s=counted_s,
                meta_counted_s=meta_s, step_device_ms=device_ms,
                model_flops=mflops,
                model_flops_share_of_bf16_peak=mflops / (
                    PEAK_OPS_PER_S["bf16"] * device_ms / 1e3),
                model_flops_share_note="6 N T / (989e12 x the step's "
                                       "kernel seconds)", card=smi)


def scope_cost_us():
    """The host cost of one ``record_function`` scope, microseconds (the
    median of 5 runs of SCOPE_REPS)."""
    from torch.profiler import record_function
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(SCOPE_REPS):
            with record_function("selective_scan_kernel"):
                pass
        runs.append((time.perf_counter() - t0) / SCOPE_REPS * 1e6)
    return float(np.median(runs))


def dryrun_path(model, dev, smi, child):
    """Phase 3i: (b), then (a)'s child read."""
    t_phase = time.perf_counter()
    out = {"count_vs_meta": dryrun_count_vs_meta(model, dev, smi),
           "record_function_us": scope_cost_us(),
           "decode_step_scopes": 0}
    t0 = time.perf_counter()
    out["child"] = dryrun_result(child)
    out["child_waited_s"] = time.perf_counter() - t0
    emit({"phase": "dryrun", "arch": ARCH, "seconds":
          time.perf_counter() - t_phase, **out})


def serve_f32(cfg, params, dev, layers=None, **kw):
    """The served-token check of ``serve_full_width`` (``kw``: its request
    options) on the same model and requests computed in float32 (the bf16
    weights widened, exactly), held to NEAR_TIE itself.  In bf16 the
    model's own rounding noise at this depth is above NEAR_TIE (the bf16
    run measures it), so here the serving, state and chunking logic is all
    the tight limit can see.  ``layers``: only the first so many layers
    (a cut of depth, for the script's time)."""
    import dataclasses
    from repro_torch.models import LM
    if layers:
        emit({"phase": "init", "arch": cfg.name, "dtype": "float32",
              "layers": layers, "cut_from_layers": cfg.n_layers})
        cfg = dataclasses.replace(cfg, n_layers=layers)
        params = dict(params, layers=tree_map(lambda t: t[:layers],
                                              params["layers"]))
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
            if kernel_event(e) and e.device_time_total > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + e.device_time_total
        total_us = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        result[label] = dict(
            wall_ms=wall * 1e3,
            device_ms=total_us / 1e3 if total_us else "not measured",
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
# the float32 runs of deepseek-moe-16b, falcon-mamba-7b and zamba2-1.2b take
# this many of their 28, 64 and 38 layers (full width), for the script's
# time: the float32 run checks the serving logic, which every layer runs
# alike (zamba2's 12 keep two shared-block applications)
MOE_F32_LAYERS = 8
SSM_F32_LAYERS = 16
HYBRID_F32_LAYERS = 12
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
    float32 at HYBRID_F32_LAYERS of its depth (held to NEAR_TIE), one
    emulated prefill and decode with 37 K1
    launches per forward (six shared-block projections per application,
    six applications, and the unembed), and a profile of one decode
    step."""
    from repro_torch.configs.base import get_config
    cfg = get_config(HYBRID_ARCH)
    model, params = init_model(cfg, dev)
    per_fwd = 6 * model.n_shared_applications + 1
    mono = {}
    drive(HYBRID_ARCH, ("fused_qmm", "flash_attention_tc"),
          lambda: mono.update(serve_full_width(
              model, params, np.random.default_rng(SEED + 1),
              noise_floor=True, parting_on_decode=True)),
          lambda: chunked_server(model, params, mono),
          lambda: serve_f32(cfg, params, dev, layers=HYBRID_F32_LAYERS),
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


def widened(box, layers):
    """``box``'s bf16 parameters (its only reference) cut to their first
    ``layers`` layers and widened (exactly) to float32 one leaf at a time,
    largest first, each bf16 leaf freed once widened: the card never holds
    both copies of more than one leaf.  Returns the parameters and the
    peak bytes while widening."""
    params = box.pop()
    params["layers"] = tree_map(lambda t: t[:layers].clone(),
                                params["layers"])
    release()
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
    return params, torch.cuda.max_memory_allocated()


def serve_f32_widened(cfg, box, dev, layers):
    """``serve_f32`` for a model too large to hold twice: ``cfg``'s
    requests served in float32 at ``layers`` of its depth with a float32
    KV cache, every token, and greedy_decode's, within NEAR_TIE of
    ``LM.apply`` on its prefix.  ``box`` holds the only reference to the
    bf16 parameters (``widened``).
    A config's fp8 cache is left out here: it rounds the last-bit
    differences between the server's batched shapes and a one-sequence
    reference to whole fp8 steps (an e4m3 step is 6-12% of a value), and
    at 28 layers of deepseek-moe-16b that moved one served token of 256 to
    9.2% of max |logit| short of the single-lane decode path (chip run 1
    of PR 20's review)."""
    import dataclasses
    from repro_torch.models import LM
    model = LM(dataclasses.replace(cfg, dtype="float32", kv_cache_dtype=None,
                                   n_layers=layers), device=dev)
    params, peak = widened(box, layers)
    emit({"phase": "init", "arch": cfg.name, "dtype": "float32",
          "layers": layers, "cut_from_layers": cfg.n_layers,
          "device_bytes": torch.cuda.memory_allocated(),
          "peak_bytes_while_widening": peak})
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
    the bf16 run on the fp8 cache is timed; ``serve_f32_widened``).
    At 1.25 the same requests are served and their dropped shares and
    token differences printed; two identical prefills must be bitwise
    equal; one emulated prefill makes 113 K1 launches; layer 0's MoE is
    held to the CPU."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    cfg = get_config(MOE_ARCH)
    model, params = init_model(cfg, dev)
    nodrop_cfg = dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts))
    nodrop = LM(nodrop_cfg, device=dev)
    per_fwd = 4 * cfg.n_layers + 1
    rec = {}
    drive(MOE_ARCH, ("fused_qmm", "flash_attention_tc"),
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
    serve_f32_widened(nodrop_cfg, box, dev, MOE_F32_LAYERS)


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
    drive(f"{WINDOW_ARCH} window", ("fused_qmm", "flash_attention_tc"),
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

    drive(VLM_ARCH, ("fused_qmm", "flash_attention_tc"), check_embeds,
          lambda: serve_full_width(model, params,
                                   np.random.default_rng(SEED + 1)),
          lambda: emulated_forwards(model, params, rng, per_fwd,
                                    embeds=True))
    profile_decode(model, params, rng)


def fp8_cache_vs_cpu(model, params, toks=None, **kw):
    """Layer 0's float8 cache after a prefill of ``toks`` (or of the frames
    in ``kw``), against the CPU's ``to_cache`` of the same K/V (the card's
    layer-0 projections, as ``attn_block_apply`` computes them):
    bitwise."""
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import _layer, _qkv, to_cache
    cfg = model.cfg
    _, cache = model.prefill(params, toks, **kw)
    p = _layer(params["layers"], 0)
    x = model._embed_inputs(params, toks, None, kw.get("frame_embeds"))
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
          "input": "tokens" if toks is not None else sorted(kw),
          "shape": list(x.shape[:2]), "entries": int(k.numel()),
          "differing": out})


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

    drive(AUDIO_ARCH, ("fused_qmm", "flash_attention_tc"), bf16_embeds,
          lambda: fp8_cache_vs_cpu(model, params, **inputs["kw"]),
          lambda: emulated_forwards(model, params, rng, per_fwd,
                                    embeds=True))
    profile_decode(model, params, rng)
    box = [params]
    del model, params, inputs
    release()
    audio_f32(cfg, box, dev)


# ---------------------------------------------------------------------------
# phase 3j: the dense family's last three configurations at full width
# ---------------------------------------------------------------------------
DENSE_ARCHS = ("starcoder2-7b", "chatglm3-6b", "deepseek-67b")
# deepseek-67b's 95 layers hold ~133 GB of bf16 weights, more than one
# H100's 80 GB: its bf16 run keeps every width and this many layers, and
# its float32 run (a float32 cache in place of the fp8 one) this many
DEEPSEEK_LAYERS = 24
DEEPSEEK_F32_LAYERS = 8
# the decode steps of each dense path's emulated forwards (EMU's prefill)
DENSE_EMU_STEPS = 4
# layer 0's fp8 cache is held to the CPU's after a prefill of this shape
DENSE_FP8_PREFILL = dict(batch=2, prompt=512)
# layer 0's block in float32 on this many tokens, card against the CPU:
# both round every op to f32, but cuBLAS and the CPU's BLAS sum the
# 4096- to 22016-deep dots (and the softmax its rows) in other orders,
# ~1e-6 of a value apart
DENSE_BLOCK = dict(batch=2, prompt=64)
BLOCK_VS_CPU = 1e-4
# K1 on layer 0's operands against the plain K1, bf16, each style
DENSE_K1_STYLES = ("fused", "cascade", "cascade_fwd")


def attention_per_forward(model, params, rng):
    """One no-grad bf16 forward of 2 x 256 tokens launches the tensor-core
    attention once a layer."""
    from repro_torch.kernels.attention_tc import flash_attention_tc
    cfg = model.cfg
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                           device=model.device)
    before = flash_attention_tc.launches
    with torch.no_grad():
        model.apply(params, toks)
    got = flash_attention_tc.launches - before
    check(got == cfg.n_layers, f"{cfg.name} forward: {got} tensor-core "
          f"attention launches, expected {cfg.n_layers}")
    emit({"phase": "attention_launches", "arch": cfg.name,
          "per_forward": got})


def dense_cfg(arch):
    """The config a dense path runs and its ``init`` record: full width,
    and for deepseek-67b DEEPSEEK_LAYERS of its 95 layers."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(arch)
    if arch != "deepseek-67b":
        return full, {}
    return dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS), {
        "reduced": {"n_layers": [full.n_layers, DEEPSEEK_LAYERS],
                    "why": f"{full.param_count() * 2 / 1e9:.0f} GB of bf16 "
                    "weights at 95 layers exceed one H100's 80 GB"}}


def layer0_k1_vs_plain(model, params, rng):
    """K1 on layer 0's projections and the unembed at M = 512 (EMU's 4 x 128
    prefill) and M = 4 (each sequence's last position, a 4-slot decode
    step's rows), bf16 under each of DENSE_K1_STYLES, exactly equal to the
    plain K1 on the same operands, each case with the schedule ``plan_qmm``
    picked for it.  The operands are the path's: layer 0's weights and the
    table's transpose read in place, the normed embeddings of EMU's tokens
    (the q, k, v, o, MLP and unembed inputs: o's width is d_model in these
    configs) and the MLP's hidden from them (the down projection's).  Runs
    outside the counted window: these launches only compare.  Returns the
    largest error (0.0: exact)."""
    import torch.nn.functional as Fn
    from repro_torch.core import formats as F
    from repro_torch.kernels.fused import (fused_qmm, fused_qmm_ref,
                                           plan_qmm, sm_count)
    from repro_torch.models.layers import embed_apply, rmsnorm
    from repro_torch.models.model import _layer
    cfg, dev = model.cfg, model.device
    B, S = EMU["batch"], EMU["prompt"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    lp = _layer(params["layers"], 0)
    h = rmsnorm(lp["ln1"], embed_apply(params["embed"], toks)).reshape(
        B * S, -1)
    mlp = lp["mlp"]
    up = h @ mlp["w_up"]
    if cfg.mlp_act == "swiglu":
        hid = Fn.silu((h @ mlp["w_gate"]).float()).to(h.dtype) * up
    else:
        hid = Fn.gelu(up.float(), approximate="tanh").to(h.dtype)
    rows = {cfg.d_model: h, cfg.d_ff: hid}
    check(cfg.n_heads * cfg.head_dim == cfg.d_model, f"{cfg.name}: o's "
          "input is not d_model wide")
    weights = {name: lp[name] for name in ("wq", "wk", "wv", "wo")}
    weights.update(mlp)
    weights["unembed"] = params["embed"].T
    sms = sm_count(dev)
    cases, worst, n_checks = [], 0.0, 0
    for m in (4, B * S):
        for name, b in weights.items():
            k, n = b.shape
            a = rows[k] if m == B * S else rows[k][S - 1::S].contiguous()
            plan = plan_qmm(1, m, n, k, sms)
            cases.append(dict(name=name, m=m, k=k, n=n,
                              b_strides=list(b.stride()), **vars(plan)))
            for style in DENSE_K1_STYLES:
                got = fused_qmm(a, b, fmt=F.BF16, style=style)
                want = fused_qmm_ref(a, b, fmt=F.BF16, style=style, bm=128,
                                     bn=128)
                bad = mismatches(got, want)
                check(bad == 0, f"{cfg.name} K1 {name} ({m}, {k}) @ ({k}, "
                      f"{n}) bf16 {style} ({plan.schedule}): {bad} entries "
                      f"differ (max err {max_abs_err(got, want)})")
                worst = max(worst, max_abs_err(got, want))
                n_checks += 1
            del a, got, want
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "fused_qmm", "arch": cfg.name,
          "what": "layer 0's projections and the unembed on the path's "
          "operands, M = 4 and 512", "cases": cases, "checks": n_checks,
          "sm_count": sms, "schedules": sorted({c["schedule"]
                                                for c in cases}),
          "format": "bf16", "styles": list(DENSE_K1_STYLES),
          "tolerance": "exact: every entry equal to the plain version's",
          "max_abs_err": worst})
    return worst


def block0_vs_cpu(model, params, rng):
    """Layer 0's block (``attn_block_apply``: norms, q/k/v with the
    config's bias and RoPE style at head dim 128, attention, o, the MLP)
    in float32 on DENSE_BLOCK's tokens, on the card and on the CPU from the
    same widened weights and embeddings: the output and the block's k and
    v within BLOCK_VS_CPU of their max |value|."""
    import dataclasses
    from repro_torch.models.model import _layer, attn_block_apply
    cfg, dev = dataclasses.replace(model.cfg, dtype="float32"), model.device
    B, S = DENSE_BLOCK["batch"], DENSE_BLOCK["prompt"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    lp = tree_map(lambda t: t.float(), _layer(params["layers"], 0))
    x = params["embed"][toks].float()
    positions = torch.arange(S, device=dev)[None, :]
    out, seconds = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _, (k, v) = attn_block_apply(tree_to(lp, d), x.to(d),
                                        positions.to(d), cfg)
        torch.cuda.synchronize()
        seconds[where] = time.perf_counter() - t0
        out[where] = {"out": y.cpu(), "k": k.cpu(), "v": v.cpu()}
    gaps = {name: float((out["card"][name] - want).abs().max()
                        / want.abs().max())
            for name, want in out["cpu"].items()}
    for name, gap in gaps.items():
        check(gap <= BLOCK_VS_CPU, f"{cfg.name} layer 0 {name}: card and CPU "
              f"{gap} of max |value| apart (limit {BLOCK_VS_CPU})")
    emit({"phase": "check", "what": "layer 0's block in float32, card vs "
          "CPU", "arch": cfg.name, "rope_style": cfg.rope_style,
          "head_dim": cfg.head_dim, "qkv_bias": cfg.qkv_bias,
          "mlp_act": cfg.mlp_act, "batch": B, "prompt": S,
          "rel_gap_of_max_value": gaps, "limit": BLOCK_VS_CPU,
          "seconds": seconds})


def dense_path(arch, dev, drive, rng):
    """One dense config at full width and depth (deepseek-67b at
    DEEPSEEK_LAYERS of its 95 layers, with its float8_e4m3fn cache): the
    serve phase's requests (every token within NEAR_TIE of ``LM.apply``,
    the model's own bf16 noise floor printed; with the fp8 cache timed,
    each served token's gap to ``LM.apply`` printed, not gated, and layer
    0's fp8 cache after a prefill bitwise the CPU's ``to_cache``), one
    emulated 4x128 prefill and DENSE_EMU_STEPS decode steps under
    EmulatedPolicy(bf16, fused) (every projection of every layer and the
    unembed through K1), then
    K1 on layer 0's operands exactly equal to its plain version, layer 0's
    block in float32 card against CPU, a profile of one decode step, and
    for the fp8 cache last the served-token check in float32 with a
    float32 cache at DEEPSEEK_F32_LAYERS layers.  Returns K1's largest
    error against its plain version."""
    cfg, record = dense_cfg(arch)
    model, params = init_model(cfg, dev, **record)
    fp8 = model.cache_dtype == torch.float8_e4m3fn
    projections = 4 + (3 if cfg.mlp_act == "swiglu" else 2)
    per_fwd = projections * cfg.n_layers + 1
    rec = {}
    steps = [lambda: rec.update(serve_full_width(
        model, params, np.random.default_rng(SEED + 1), gate=not fp8))]
    if fp8:
        f = DENSE_FP8_PREFILL
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
            f["batch"], f["prompt"])), device=dev)
        steps += [lambda: served_vs_apply(model, params, rec),
                  lambda: fp8_cache_vs_cpu(model, params, toks)]
    steps.append(lambda: emulated_forwards(model, params, rng, per_fwd,
                                           steps=DENSE_EMU_STEPS))
    drive(arch, ("fused_qmm", "flash_attention_tc"), *steps)
    attention_per_forward(model, params, rng)
    err = layer0_k1_vs_plain(model, params, rng)
    block0_vs_cpu(model, params, rng)
    profile_decode(model, params, rng)
    if fp8:
        box = [params]
        del model, params, rec, steps
        release()
        from repro_torch.configs.base import get_config
        serve_f32_widened(get_config(arch), box, dev, DEEPSEEK_F32_LAYERS)
    return err


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


def tinyllama_paths(dev, drive, rng, smi, errs):
    """Phases 3-3i and 3g on tinyllama-1.1b (and benchgen's specs): the
    dense, attention, chip, trace, resilience, cluster, train, distributed,
    dryrun and benchgen paths.  Returns K1-K4's kernel rows and the card's
    calibration with its seconds."""
    from repro_torch.benchgen import calibrate, validate
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    cfg = get_config(ARCH)
    model = LM(cfg, device=dev)
    params = model.init(seed=SEED)
    dense, _ = drive(ARCH, ("fused_qmm", "quantize_nd", "fma_emu_matmul",
                            "flash_attention_tc"),
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
    tech, fit_s = card_calibration(dev, smi)
    drive(f"{ARCH} chip", ("fused_qmm",),
          lambda: chip_full_width(model, params,
                                  np.random.default_rng(SEED + 2), tech))
    # telemetry and fault-tolerant serving on the native path, which
    # launches none of K1-K6
    drive(f"{ARCH} trace", (),
          lambda: trace_full_width(model, params, tech, dev))
    drive(f"{ARCH} resilience", (),
          lambda: resilience_full_width(cfg, params, tech, dev))
    # cluster serving: two dies behind the router, a die killed mid-trace,
    # and each die's unit numerics through K1
    drive(f"{ARCH} cluster", ("fused_qmm",),
          lambda: cluster_full_width(cfg, params, tech, dev))
    # training: the flash backward, 40 steps at full width and depth,
    # microbatches, the card against the CPU, a restart and the launcher;
    # no kernel of K1-K6 has a backward, so none may launch here
    train_counts, _ = drive(f"{ARCH} train", (),
                            lambda: train_path(model, params, dev, smi))
    check(not any(train_counts.values()),
          f"the train path launched {train_counts}")
    # the dry run's child (3i (a)) counts on the host while 3h runs; its
    # chip policy's few seconds on the card come before 3h's timed steps
    dry_child = Launcher("chip_smoke", "--dryrun",
                         json.dumps(list(tech.values)))
    try:
        # distribution on a world of one NCCL rank: only (f)'s policy
        # matmul and (h)'s fused chunk on the mesh launch a kernel: K1
        # once, then once for each projection and the unembed; their
        # unsharded references run before the window
        k1_dist = dist_k1_operands(params, dev)
        fused_ref = dist_fused_reference(model, params, dev)
        dist_counts, _ = drive(
            f"{ARCH} distributed", ("fused_qmm",),
            lambda: distributed_path(model, params, dev, smi, k1_dist,
                                     fused_ref))
        k1_mesh = 1 + 7 * cfg.n_layers + 1
        check(dist_counts["fused_qmm"] == k1_mesh
              and sum(dist_counts.values()) == k1_mesh,
              f"the distributed path launched {dist_counts}")
        del k1_dist, fused_ref
        # the dry run launches none of K1-K6
        dry_counts, _ = drive(f"{ARCH} dryrun", (),
                              lambda: dryrun_path(model, dev, smi,
                                                  dry_child))
        check(not any(dry_counts.values()),
              f"the dryrun path launched {dry_counts}")
    finally:
        dry_child.close()
    specs = benchgen_specs()
    machine = calibrate(device=dev)  # launches K2: outside the window
    _, (bench,) = drive(
        "benchgen", ("fused_qmm", "quantize_nd", "fused_flash_attention",
                     "ssm_scan_quantized"),
        lambda: validate(specs, machine=machine, device=dev))
    benchgen_report(dev, specs, machine, bench)
    return kernels, tech, fit_s


def card_calibration(dev, smi):
    """The DSE core's ``calibrate`` on the card, and its seconds."""
    from repro_torch.core import energy_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tech = energy_model.calibrate(device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    emit({"phase": "chip", "stage": "calibrate", "seconds": fit_s,
          "card": smi})
    return tech, fit_s


def ssm_path(dev, drive, rng, errs):
    """Phase 4 on falcon-mamba-7b; returns K5's and K6's kernel rows."""
    from repro_torch.configs.base import get_config
    scfg = get_config(SSM_ARCH)
    smodel, sparams = init_model(scfg, dev)
    ssm_counts, (_, _, (operands, toks, last)) = drive(
        SSM_ARCH, ("ssm_scan", "ssm_scan_quantized", "fused_qmm"),
        lambda: serve_full_width(smodel, sparams,
                                 np.random.default_rng(SEED + 1),
                                 noise_floor=True),
        lambda: serve_f32(scfg, sparams, dev, layers=SSM_F32_LAYERS),
        lambda: ssm_kernels_full_width(smodel, sparams, rng))
    errs["fused_qmm"] = max(errs["fused_qmm"],
                            check_ssm_unembed(smodel, sparams, toks, last))
    kernels = time_scan_kernels(dev, operands, ssm_counts, errs)
    del operands
    profile_decode(smodel, sparams, rng)
    return kernels


#: the paths ``--paths`` names, in the order of a full run
PATHS = ("tinyllama", "ssm", "hybrid", "moe", "window", "vlm", "audio",
         "dense", "dse")


def selected_paths(args):
    """The paths of ``--paths a,b`` in a full run's order, all of them with
    no argument; None for anything else."""
    if not args:
        return PATHS
    if len(args) != 2 or args[0] != "--paths":
        return None
    names = set(args[1].split(","))
    if not names or names - set(PATHS):
        return None
    return tuple(p for p in PATHS if p in names)


def main(paths=PATHS):
    """The build and the kernel checks, then ``paths`` (PATHS: the full
    run)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.attention_tc import flash_attention_tc
    from repro_torch.kernels.fma_emu import fma_emu_matmul
    from repro_torch.kernels.fused import (fused_flash_attention, fused_qmm,
                                           ssm_scan_quantized)
    from repro_torch.kernels.quantize_kernel import quantize_nd
    from repro_torch.kernels.ssm_scan import ssm_scan
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = card_and_build()
    emit({"phase": "paths", "paths": list(paths), "full_run": paths == PATHS})
    errs = check_kernels(dev)
    check_rounding(dev)
    errs.update(check_scan_kernels(dev))
    errs.update(check_flash_kernels(dev))
    errs.update(check_attention_tc(dev))
    check_small_lm(dev)
    attention_rows = time_attention_tc(dev, errs)

    wrappers = {"fused_qmm": fused_qmm, "quantize_nd": quantize_nd,
                "fma_emu_matmul": fma_emu_matmul,
                "fused_flash_attention": fused_flash_attention,
                "ssm_scan_quantized": ssm_scan_quantized,
                "ssm_scan": ssm_scan}
    paths_run = {}

    def drive(path, kernels_of_path, *steps):
        """The path's steps with every launch count set to 0 just before
        and read just after; each kernel of the path must have launched.
        Returns K1-K6's counts; the tensor-core attention's
        (``flash_attention_tc``) is printed and checked beside them."""
        for fn in (*wrappers.values(), flash_attention_tc):
            fn.launches = 0
        out = [step() for step in steps]
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        every = dict(counts, flash_attention_tc=flash_attention_tc.launches)
        emit({"phase": "launches", "path": path, "counts": every})
        for name in kernels_of_path:
            check(every[name] > 0, f"{name} was not launched on the "
                  f"{path} path")
        paths_run[path] = every
        return counts, out

    rng = np.random.default_rng(SEED)
    kernels, tech = [], None
    if "tinyllama" in paths:
        kernels, tech, fit_s = tinyllama_paths(dev, drive, rng, smi, errs)
        release()
    if "ssm" in paths:
        kernels += ssm_path(dev, drive, rng, errs)
        release()
    # the hybrid, MoE, sliding-window, vlm and audio families, then the
    # dense family's last three configs, one model at a time
    for name, path in (("hybrid", hybrid_path), ("moe", moe_path),
                       ("window", window_path), ("vlm", vlm_path),
                       ("audio", audio_path)):
        if name in paths:
            path(dev, drive, rng)
            release()
    if "dense" in paths:
        for arch in DENSE_ARCHS:
            errs["fused_qmm"] = max(errs["fused_qmm"],
                                    dense_path(arch, dev, drive, rng))
            release()
    kernels += attention_rows
    for row in kernels:  # launches on every path of this run
        row["max_abs_err"] = errs[row["name"]]
        by_path = {path: counts[row["name"]]
                   for path, counts in paths_run.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    # the paper's DSE core: no kernel of K1-K6, so no launch window
    if "dse" in paths:
        if tech is None:
            tech, fit_s = card_calibration(dev, smi)
        dse_full_size(dev, smi, tech, fit_s)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "paths": list(paths), "card": smi})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-restart"]:
        sys.exit(train_restart_child())
    if sys.argv[1:2] == ["--dryrun"] and len(sys.argv) == 3:
        sys.exit(dryrun_child(sys.argv[2]))
    paths = selected_paths(sys.argv[1:])
    if paths is None:
        print(f"usage: chip_smoke.py [--paths {','.join(PATHS)}]",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(paths))
