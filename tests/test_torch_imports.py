"""Package rules of the port: what it imports, where it runs, what the CUDA
wrappers accept, and that its configuration data is the JAX package's.

  * no module of ``src/repro_torch`` and no line of ``chip_smoke.py``
    imports ``jax`` or any module of ``repro`` (an AST scan);
  * an entry point given no device raises when CUDA is absent: there is no
    silent CPU fallback;
  * the wrappers' operand checks and the build helper work without a card
    or ``nvcc`` (nothing is compiled at import).
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro_torch.configs import base as tbase
from repro_torch.core import formats as tf
from repro_torch.kernels import _build
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fma_emu import fma_emu_matmul
from repro_torch.kernels.quantize_kernel import quantize_nd
from repro_torch.kernels.ssm_scan import ssm_scan

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, (str(path), bad)


def test_slice_modules_are_scanned():
    """The modules each slice added are among the files the scan reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/ssm_scan.py", "kernels/fused.py", "models/ssm.py",
                "models/model.py", "numerics/emulate.py",
                "models/numerics.py", "serve/engine.py",
                "benchgen/__init__.py", "benchgen/spec.py",
                "benchgen/machine.py", "benchgen/bench.py",
                "roofline/__init__.py", "roofline/analysis.py",
                "core/__init__.py", "core/formats.py", "core/fpu_arch.py",
                "core/objective.py", "core/energy_model.py",
                "core/latency_sim.py", "core/dse.py", "core/body_bias.py",
                "core/localsearch.py", "core/trace.py", "core/autotune.py",
                "numerics/registry.py", "core/softfloat.py",
                "core/chip.py", "numerics/accuracy.py", "models/moe.py",
                "faults.py", "telemetry/__init__.py", "telemetry/tracer.py",
                "telemetry/export.py", "telemetry/profile.py",
                "serve/__init__.py", "serve/resilience.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.models import LM
    from repro_torch.models.convert import params_from_jax
    from repro_torch import benchgen
    from repro_torch.numerics import (emulated_flash_attention,
                                      emulated_matmul, emulated_ssm_scan,
                                      quantize_tensor)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tbase.get_config("tinyllama-1.1b").reduced()
    ssm_cfg = tbase.get_config("falcon-mamba-7b").reduced()
    hybrid_cfg = tbase.get_config("zamba2-1.2b").reduced()
    moe_cfg = tbase.get_config("deepseek-moe-16b").reduced()
    a = np.ones((4, 8), np.float32)
    ab, c = np.ones((1, 64, 8, 4), np.float32), np.ones((1, 64, 4),
                                                         np.float32)
    spec = benchgen.KernelSpec("quantize", "bf16", (16, 128))
    calls = [lambda: LM(cfg),
             lambda: LM(ssm_cfg),
             lambda: LM(hybrid_cfg),
             lambda: LM(moe_cfg),
             lambda: emulated_matmul(a, a.T, fmt="bf16"),
             lambda: emulated_ssm_scan(ab, ab, c, fmt="bf16"),
             lambda: quantize_tensor(a, fmt="bf16"),
             lambda: emulated_flash_attention(ab, ab, ab, fmt="bf16"),
             lambda: benchgen.calibrate(n=1),
             lambda: benchgen.make_inputs(spec),
             lambda: benchgen.build(spec),
             lambda: benchgen.measure(spec),
             lambda: benchgen.validate([spec], benchgen.paper_machine()),
             lambda: params_from_jax({}, cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the same calls run when the caller asks for the CPU
    assert LM(cfg, device="cpu").device.type == "cpu"
    assert emulated_matmul(a, a.T, fmt="bf16", device="cpu").shape == (4, 4)


def test_servers_raise_without_cuda(monkeypatch):
    """The fault-tolerant and the traced server run on the card unless the
    caller asks for the CPU: their model and chip policy raise without
    CUDA, and run with ``device="cpu"``."""
    from repro_torch.core import chip, energy_model
    from repro_torch.models import LM
    from repro_torch.serve import BatchedServer, Request, ResilientServer
    from repro_torch.telemetry import Tracer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tbase.get_config("tinyllama-1.1b").reduced()
    params = energy_model.TechParams(tuple(
        s[1] for s in energy_model._PARAM_SPEC))
    calls = [lambda: ResilientServer(
                 LM(cfg), {}, slots=2, max_len=16,
                 chip_policy=chip.ChipPolicy(chip.fabricated_chip(
                     None, params), params)),
             lambda: BatchedServer(LM(cfg), {}, slots=2, max_len=16,
                                   tracer=Tracer()),
             lambda: chip.fabricated_chip()]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    model = LM(cfg, device="cpu")
    tracer = Tracer()
    for server in (ResilientServer(
            model, model.init(seed=0), slots=2, max_len=16,
            chip_policy=chip.ChipPolicy(chip.fabricated_chip(None, params),
                                        params), tracer=tracer),
            BatchedServer(model, model.init(seed=0), slots=2, max_len=16,
                          tracer=tracer)):
        req = Request(uid=len(tracer.roots()), prompt=np.arange(4),
                      max_new_tokens=2)
        server.submit(req)
        server.run()
        assert req.done and len(req.output) == 2
    assert tracer.check_integrity() == [] and len(tracer.roots()) == 2


def test_dse_entry_points_raise_without_cuda(monkeypatch):
    """The DSE core's device work (the fit, the batched model, the latency
    simulator) runs on the card unless the caller passes a device; its
    numpy routes need none."""
    from repro_torch.core import (autotune, chip, dse, energy_model,
                                  latency_sim, softfloat)
    from repro_torch.core.fpu_arch import FABRICATED
    from repro_torch.numerics import emulated_dot
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = energy_model.TechParams(tuple(
        s[1] for s in energy_model._PARAM_SPEC))
    units = list(FABRICATED.values())
    mix = latency_sim.SpecMix(0.3, 0.1, 0.0, 0.3, n_ops=64, seed=123)
    calls = [lambda: energy_model.calibrate(steps=1),
             lambda: energy_model.predict_batch(units, params, [0.8], [0.0]),
             lambda: energy_model.predict_points(units, params),
             lambda: energy_model.calibration_report(params),
             lambda: energy_model.SweepExecutableCache().predict(
                 params.as_array(), *energy_model.feature_matrix(units),
                 np.array([0.8]), np.array([0.0]), 1.0),
             lambda: latency_sim.penalties_for_waits([(2, 4)], mix),
             lambda: latency_sim.fig2c_reductions_batch([mix]),
             lambda: latency_sim.calibrated_spec_mix(),
             lambda: dse.sweep_arrays(units, params),
             lambda: autotune.autotune(autotune.GEMM_STREAM, "sp",
                                       designs=units, params=params),
             lambda: autotune.autotune(autotune.GEMM_STREAM, "sp",
                                       designs=units, params=params,
                                       accuracy_slo=1e-2),
             lambda: chip.fabricated_chip(),
             lambda: chip.default_chip("sp", params),
             lambda: chip.ChipPolicy(chip.fabricated_chip(
                 params=params)).params,
             lambda: chip.tune_chip([chip.PhaseSpec(
                 "train", autotune.GEMM_STREAM, designs=tuple(units))],
                 params=params),
             lambda: softfloat.sf_fma(1.0, 2.0, 3.0, tf.BF16),
             lambda: softfloat.dp_fma(np.ones(3), np.ones(3), np.ones(3)),
             lambda: emulated_dot(np.ones((2, 4)), np.ones((2, 4)),
                                  fmt="bf16")]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the numpy routes and the CPU on request
    out = energy_model.predict_batch(units, params, [0.8], [0.0],
                                     backend="numpy")
    assert out["freq_ghz"].shape == (4, 1, 1)
    assert energy_model.predict_batch(units, params, [0.8], [0.0],
                                      device="cpu")["freq_ghz"].shape == \
        (4, 1, 1)
    assert latency_sim.penalties_for_waits([(2, 4)], mix,
                                           device="cpu").shape == (1,)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a, b = torch.ones(8, 256), torch.ones(256, 8)
    for fmt, style, b_ in ((tf.FP64, "fused", b), (tf.BF16, "nope", b),
                           (tf.BF16, "fused", b.to("meta"))):
        with pytest.raises(ValueError):
            tfused.check_operands(a, b_, fmt, style)
    with pytest.raises(TypeError):
        tfused.check_operands(a.half(), b, tf.BF16, "fused")
    with pytest.raises(ValueError):  # a must be contiguous along k
        tfused.check_operands(a.T.contiguous().T, b, tf.BF16, "fused")
    with pytest.raises(ValueError):  # b contiguous along neither dim
        tfused.check_operands(a, torch.ones(512, 16)[::2, ::2], tf.BF16,
                              "fused")
    meta = torch.ones(8, 256, device="meta")
    ab = torch.ones(1, 64, 8, 4, device="meta")
    c = torch.ones(1, 64, 4, device="meta")
    for call in (lambda: tfused.fused_qmm(meta, b.to("meta"), fmt=tf.BF16),
                 lambda: fma_emu_matmul(meta, b.to("meta"), fmt=tf.BF16),
                 lambda: quantize_nd(meta, fmt=tf.BF16),
                 lambda: ssm_scan(ab, ab, c),
                 lambda: tfused.ssm_scan_quantized(ab, ab, c, fmt=tf.BF16),
                 lambda: tfused.fused_flash_attention(ab, ab, ab,
                                                      fmt=tf.BF16)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            call()
    # shapes the flash kernel does not take, on every device
    q = torch.ones(1, 16, 4, 8)
    for k in (torch.ones(1, 16, 4, 4), torch.ones(2, 16, 4, 8),
              torch.ones(1, 16, 4)):
        with pytest.raises(ValueError, match="bad flash shapes"):
            tfused.fused_flash_attention(q, k, k, fmt=None)
    with pytest.raises(ValueError, match="Hq=4 not a multiple of Hkv=3"):
        tfused.fused_flash_attention(q, q[:, :, :3], q[:, :, :3], fmt=None)
    with pytest.raises(ValueError, match="operands on"):
        tfused.fused_flash_attention(q, q, q.to("meta"), fmt=None)
    # shapes the scan kernels do not take
    ab_cpu, c_cpu = torch.ones(1, 64, 8, 4), torch.ones(1, 64, 4)
    for bad in ((ab_cpu, ab_cpu[..., :2], c_cpu), (ab_cpu, ab_cpu, c_cpu.mT),
                (ab_cpu[0], ab_cpu[0], c_cpu)):
        with pytest.raises(ValueError, match="bad scan shapes"):
            ssm_scan(*bad)
    with pytest.raises(ValueError, match="operands on"):
        ssm_scan(ab_cpu, ab_cpu, c.to("meta"))


def test_build_is_lazy_and_keyed_by_source(monkeypatch, tmp_path):
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    for flag in ("--use_fast_math", "-ftz=true"):
        assert flag not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    before = _build._lib_path("qmm")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build._lib_path("qmm") != before
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "a launch")


@pytest.mark.parametrize("arch", sorted(jbase.all_configs()))
def test_config_data_matches_jax(arch):
    want = jbase.get_config(arch)
    got = tbase.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert tbase.cells(arch) == jbase.cells(arch)
