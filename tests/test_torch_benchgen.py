"""The port's benchgen against ``repro.benchgen``, on the CPU.

For every spec of ``default_specs()`` and the two full-width flash specs
that ``chip_smoke.py`` adds: the analytic counts, the names, the
predictions for the same machine numbers and the operands are equal, and
the plain closures (``build(spec, 'ref')``) agree within the tolerances of
the kernels' own parity tests: quantize bitwise (no f32 subnormals among
normal draws), qmm within two format ulps of |a| @ |b| (tests/
test_torch_emulate.py: XLA and PyTorch sum each 128-deep block in their own
orders, and a partial sum near a midpoint can round the other way), flash
within tests/test_torch_flash.py's bounds, the scan within 1e-5 * max |y|
(tests/test_torch_ssm_kernels.py).  The machine model and ``validate`` keep
the JAX package's structure; ``paper_machine()`` is the H100 data-sheet
corner.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.benchgen as jbg
import repro_torch.benchgen as tbg
from repro_torch.roofline.analysis import RooflineReport

FULL_WIDTH_FLASH = [(("flash", "bf16", (2, 32, 2048, 64)), {}),
                    (("flash", "fp8_e4m3", (1, 36, 1024, 128)),
                     dict(scaled=True))]


def _pairs():
    j = jbg.default_specs() + [jbg.KernelSpec(*a, **kw)
                               for a, kw in FULL_WIDTH_FLASH]
    t = tbg.default_specs() + [tbg.KernelSpec(*a, **kw)
                               for a, kw in FULL_WIDTH_FLASH]
    return list(zip(j, t))


PAIRS = _pairs()
IDS = [t.name for _, t in PAIRS]


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_spec_counts_and_names_equal(pair):
    jspec, tspec = pair
    assert tspec.name == jspec.name
    assert tspec.as_dict() == jspec.as_dict()
    assert tbg.op_counts(tspec) == jbg.op_counts(jspec)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_predict_fields_equal(pair):
    jspec, tspec = pair
    numbers = dict(name="m", mxu_flops=3e14, vpu_flops=2e12,
                   quant_rate=1.5e11, exp_rate=2.5e11, hbm_bw=2e12)
    jrep = jbg.predict(jspec, jbg.MachineModel(**numbers))
    trep = tbg.predict(tspec, tbg.MachineModel(**numbers))
    assert isinstance(trep, RooflineReport)
    assert trep.as_dict() == jrep.as_dict()
    assert trep.step_time_bound_s == jrep.step_time_bound_s


def test_spec_errors_equal():
    bad = [("conv", "bf16", (8, 8, 8)), ("qmm", "bf16", (8, 8)),
           ("qmm", "bf16", (8, 8, 8), "sloppy"), ("qmm", "fp13", (8, 8, 8))]
    for args in bad:
        with pytest.raises((ValueError, KeyError)) as jerr:
            jbg.KernelSpec(*args)
        with pytest.raises(jerr.type) as terr:
            tbg.KernelSpec(*args)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_make_inputs_bitwise(pair):
    jspec, tspec = pair
    got = tbg.make_inputs(tspec, seed=3, device="cpu")
    want = jbg.make_inputs(jspec, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert np.array_equal(g.numpy().view(np.uint32),
                              np.asarray(w).view(np.uint32))


def _ulp(x, fmt):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(np.maximum(e, 1 - fmt.bias) - fmt.man_bits)


@pytest.mark.parametrize("pair", PAIRS[:7], ids=IDS[:7])
def test_build_ref_outputs_agree(pair):
    jspec, tspec = pair
    args = tbg.make_inputs(tspec, device="cpu")
    got = tbg.build(tspec, "ref", device="cpu")(*args).numpy()
    want = np.asarray(jbg.build(jspec, "ref")(*jbg.make_inputs(jspec)))
    assert got.shape == want.shape
    fmt = tspec.float_format
    if tspec.op == "quantize":
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    elif tspec.op == "qmm":
        a, b = (t.numpy() for t in args)
        scale = np.abs(a) @ np.abs(b)
        assert (np.abs(got - want) <= 2 * _ulp(scale, fmt)).all()
    elif tspec.op == "flash":
        vmax = float(np.abs(args[2].numpy()).max())
        err = np.abs(got - want)
        assert (err <= 2.0 ** -fmt.man_bits * vmax).all()
        assert (err <= 1e-6 * vmax).mean() >= 0.95
    else:  # ssm_scan y
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_build_auto_and_unknown_impl():
    spec = tbg.KernelSpec("quantize", "bf16", (16, 128))
    (x,) = tbg.make_inputs(spec, device="cpu")
    assert torch.equal(tbg.build(spec, "auto", device="cpu")(x),
                       tbg.build(spec, "ref", device="cpu")(x))
    with pytest.raises(ValueError, match="unknown impl"):
        tbg.build(spec, "interpret", device="cpu")


def test_paper_machine_is_the_h100_corner():
    m = tbg.paper_machine()
    assert m.mxu_flops > m.vpu_flops > m.quant_rate > 0
    assert m.hbm_bw > 0
    assert set(m.as_dict()) == set(jbg.paper_machine().as_dict())
    assert "h100" in m.name and "tpu" not in m.name
    assert (m.mxu_flops, m.hbm_bw) == (989e12, 3.35e12)
    # the JAX corner's ratios between the pipes, on the H100's peak
    j = jbg.paper_machine()
    for key in ("vpu_flops", "quant_rate", "exp_rate"):
        assert math.isclose(getattr(m, key) / m.mxu_flops,
                            getattr(j, key) / j.mxu_flops, rel_tol=1e-12)


def test_validate_has_the_jax_structure():
    specs = [("quantize", "bf16", (256, 256)), ("qmm", "bf16", (64, 64, 64)),
             ("flash", "bf16", (1, 2, 32, 8)),
             ("ssm_scan", "bf16", (1, 16, 8, 4))]
    numbers = dict(name="m", mxu_flops=1e11, vpu_flops=1e10,
                   quant_rate=1e9, exp_rate=1e9, hbm_bw=1e10)
    got = tbg.validate([tbg.KernelSpec(*s) for s in specs],
                       tbg.MachineModel(**numbers), impl="ref", n=2,
                       device="cpu")
    want = jbg.validate([jbg.KernelSpec(*s) for s in specs],
                        jbg.MachineModel(**numbers), impl="ref", n=1)
    assert set(got) == set(want)
    assert set(got["summary"]) == set(want["summary"])
    assert got["machine"] == want["machine"] and got["tol"] == want["tol"]
    assert got["summary"]["n_specs"] == len(specs)
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w)
        assert g["spec"] == w["spec"]
        assert g["t_pred_s"] == w["t_pred_s"]
        assert g["bottleneck"] == w["bottleneck"]
        assert g["t_meas_s"] > 0
        assert g["ratio"] == pytest.approx(g["t_meas_s"] / g["t_pred_s"],
                                           rel=1e-6)


def test_calibrate_measures_the_given_device():
    m = tbg.calibrate(n=1, device="cpu")
    assert m.name == "calibrated:cpu"
    assert all(v > 0 for k, v in dataclasses.asdict(m).items()
               if k != "name")
