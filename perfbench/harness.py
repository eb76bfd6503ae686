"""The benchmark's shared core: the spec and a cell's files, the run's
context, spans, the module check and the result line.

A cell is a ``workloads`` entry of ``BENCHMARK.json``.  Everything that
belongs to one configuration, one traffic mix or one per-layer metric sits
in a file of its own, found by name:

- ``perfbench/configs/<config>.json`` (via the ``configs`` entry's
  ``file``), whose ``family`` names ``perfbench/families/<family>.py``
  (the program's model, the weights, the plain reference from
  ``perfbench/reference/<family>.py``, and the family's counts of model
  FLOPs and K1's bound from the file's published shapes);
- ``perfbench/traffic/<traffic>.json``, whose ``kind`` names the driver
  ``perfbench/drivers/<kind>.py``;
- ``perfbench/limits/<cell>.json``: the limit of each number compared;
- ``perfbench/metrics/<metric>.py``: the reader of one per-layer metric.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run (the JAX
#: package is ``repro``; the port, ``repro_torch``, is another name)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: what every family module gives; a driver names what else it needs
#: from the family in its own ``FAMILY_NEEDS``
FAMILY_NEEDS = ("program", "make_weights", "reference_logits",
                "model_flops")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    check_family(config, traffic)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def family(config: dict):
    return importlib.import_module(f"perfbench.families.{config['family']}")


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['kind']}")


def check_family(config: dict, traffic: dict) -> None:
    """Raise, before any weights are made, if the configuration's family
    lacks a function that every family or the traffic's driver needs."""
    fam = family(config)
    needs = FAMILY_NEEDS + tuple(getattr(driver(traffic), "FAMILY_NEEDS",
                                         ()))
    missing = [n for n in needs if not callable(getattr(fam, n, None))]
    if missing:
        raise AttributeError(
            f"perfbench/families/{config['family']}.py has no "
            f"{', '.join(missing)}: a {traffic['kind']!r} cell needs "
            f"{', '.join(needs)} of its family")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments and the device.
    ``control`` (calibration only) also reads the lower-precision control
    beside the program."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False


@dataclasses.dataclass
class Outcome:
    """What a driver returns.  ``metrics``: the end-to-end values by name;
    ``checks``: each number compared, ``{name: (value, limit)}``, correct
    when value <= limit; ``record``: what the per-layer readers read;
    ``extra``: readings for calibration (controls), printed by it only."""

    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, tuple]
    memory_peak_bytes: int
    record: dict
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def sync(device) -> None:
    if getattr(device, "type", "cpu") == "cuda":
        import torch
        torch.cuda.synchronize(device)


class Spans:
    """The benchmark's own spans around calls into the program, kept in
    memory: ``(name, start_s, end_s, attrs)`` on the host clock, each
    bracketed by device synchronisations, recorded only while ``on``."""

    def __init__(self, device, on: bool):
        self.device = device
        self.on = on
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        sync(self.device)
        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            yield
        sync(self.device)
        self.items.append((name, t0, time.perf_counter(), attrs))

    def wrap(self, obj, method: str, attrs: Callable[..., dict]):
        """Put a span around ``obj.method`` on this instance only."""
        inner = getattr(obj, method)

        def wrapped(*args, **kw):
            with self.span(method, **attrs(*args, **kw)):
                return inner(*args, **kw)

        setattr(obj, method, wrapped)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, control: bool = False) -> Outcome:
    """One run of ``cell`` on ``device``: the driver's set-up, window and
    check.  No look for a card here (``run.py`` makes it)."""
    run = Run(cell, seed, seconds, trace, device, t_start, control)
    return driver(cell.traffic).run(run)


def per_layer_metrics(cell: Cell, record: dict) -> Dict[str, dict]:
    """Each per-layer metric's reading; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end_metrics(cell: Cell,
                       values: Dict[str, float]) -> Dict[str, dict]:
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
    if missing:
        raise RuntimeError(f"the driver gave no {missing} in {cell.name}")
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end}


def checks_line(checks: Dict[str, tuple]) -> Dict[str, dict]:
    return {k: {"value": float(v), "limit": float(lim)}
            for k, (v, lim) in checks.items()}
