"""The port's deprecated ``core.precision_policy`` shim against the JAX
package's: ``select_fpu``, ``policy_for_shape``, ``fabricated_policy`` and
``step_energy_telemetry`` return the same designs, policies and reports,
and each call warns with the same ``DeprecationWarning`` text (``repro``
read as ``repro_torch``).

The JAX package's chip module imports ``jax.experimental.enable_x64``, a
name jax 0.9.0 dropped, so the reference runs in one subprocess that
restores it before importing, and pickles plain values back; the alias
never enters this process (see tests/test_torch_dse.py).  Both sides run
on the reference's fitted parameters: the calls that take ``params`` get
them, and ``policy_for_shape``, which always calibrates, finds them as the
port's calibration.  Tolerances: designs, policies and warnings identical;
the telemetry's floats at rel 1e-12 (numpy on both sides, as
tests/test_torch_chip.py holds the host metric rows).
"""
import os
import pickle
import subprocess
import sys
import warnings

import pytest

from repro_torch.core import chip
from repro_torch.core import energy_model as em
from repro_torch.core import precision_policy as pp
from repro_torch.core.formats import BF16, FP32
from repro_torch.core.fpu_arch import FABRICATED

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
RTOL = 1e-12

#: the same calls against either package: ``ns`` holds its shim ``pp``,
#: ``P`` (the fitted parameters), ``BF16``, ``FP32``, ``FABRICATED`` and
#: ``dev`` (``{}`` for JAX, ``{"device": "cpu"}`` for the port).
_CALLS = r'''
import dataclasses
import warnings

SHAPES = ("train", "prefill", "decode", "decode_32k", "long_500k")
TELEMETRY = [dict(achieved_flops=2e12, step_time_s=0.5, peak_flops=1e13,
                  adaptive_bb=bb) for bb in (True, False)] + [
    dict(achieved_flops=1e9, step_time_s=1.0, peak_flops=1e13)]


def plain(x):
    """Designs, formats and policies as dicts of plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def call(fn, *args, **kw):
    """fn's value and the (category, text) of each warning it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return plain(out), [(w.category.__name__, str(w.message))
                        for w in caught]


def run(ns):
    pp, P, dev = ns["pp"], ns["P"], ns["dev"]
    out = {}
    for prec in ("sp", "dp"):
        for work in ("throughput", "latency"):
            out["select_fpu", prec, work] = call(
                pp.select_fpu, work, prec, params=P, **dev)
        for kind in SHAPES:
            for fmt in (ns["BF16"], ns["FP32"]):
                out["policy_for_shape", prec, kind, fmt.name] = call(
                    pp.policy_for_shape, kind, prec, fmt, **dev)
    for name in sorted(ns["FABRICATED"]):
        out["fabricated_policy", name, "default"] = call(
            pp.fabricated_policy, name)
        out["fabricated_policy", name, "bf16"] = call(
            pp.fabricated_policy, name, ns["BF16"])
        for i, kw in enumerate(TELEMETRY):
            out["step_energy_telemetry", name, i] = call(
                pp.step_energy_telemetry, ns["FABRICATED"][name], params=P,
                **kw, **dev)
    return out
'''

_REF = r"""
import pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
from repro.core import precision_policy as pp
from repro.core.energy_model import calibrate
from repro.core.formats import BF16, FP32
from repro.core.fpu_arch import FABRICATED

exec(sys.argv[1])
P = calibrate()
out = run(dict(pp=pp, P=P, dev={}, BF16=BF16, FP32=FP32,
               FABRICATED=FABRICATED))
with open(sys.argv[2], "wb") as fh:
    pickle.dump(dict(P=P.values, out=out), fh)
"""

exec(_CALLS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX shim's values, from a subprocess (see above)."""
    path = tmp_path_factory.mktemp("precision_policy_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, _CALLS, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def got(ref):
    """The port's shim on the reference's fit: ``policy_for_shape``
    calibrates, so the port's calibration is the reference's parameters
    for the duration."""
    P = em.TechParams(ref["P"])
    saved = chip.calibrate
    chip.calibrate = lambda **kw: P
    chip.clear_policy_cache()
    try:
        return run(dict(pp=pp, P=P, dev={"device": CPU}, BF16=BF16,
                        FP32=FP32, FABRICATED=FABRICATED))
    finally:
        chip.calibrate = saved
        chip.clear_policy_cache()


def _port_warning(warned):
    return [(cat, text.replace("repro.core.", "repro_torch.core."))
            for cat, text in warned]


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=0.0)
    else:
        assert got == want


@pytest.mark.parametrize("fn", ["select_fpu", "policy_for_shape",
                                "fabricated_policy",
                                "step_energy_telemetry"])
def test_shim_matches_jax(ref, got, fn):
    keys = [k for k in ref["out"] if k[0] == fn]
    assert keys and sorted(keys, key=str) == sorted(
        (k for k in got if k[0] == fn), key=str)
    for key in keys:
        (g_val, g_warn), (w_val, w_warn) = got[key], ref["out"][key]
        assert g_warn == _port_warning(w_warn), key
        assert len(g_warn) == 1 and g_warn[0][0] == "DeprecationWarning"
        assert g_warn[0][1].startswith(f"repro_torch.core.precision_policy."
                                       f"{fn} is deprecated; use "
                                       "repro_torch.core.chip.")
        _close(g_val, w_val)


def test_shim_keeps_the_public_names():
    """The JAX shim's ``__all__``; ``NumericsPolicy`` is the chip's; a
    warning turned into an error stops the call."""
    assert pp.__all__ == ["NumericsPolicy", "select_fpu", "policy_for_shape",
                          "fabricated_policy", "step_energy_telemetry"]
    assert pp.NumericsPolicy is chip.NumericsPolicy
    with pytest.warns(DeprecationWarning, match="fabricated_policy"):
        pol = pp.fabricated_policy("sp_fma")
    assert pol.fmt == FP32 and pol.fpu_design == FABRICATED["sp_fma"]
    assert pol.accum_style == chip.kernel_style_for(FABRICATED["sp_fma"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(DeprecationWarning):
            pp.fabricated_policy("dp_cma", BF16)
