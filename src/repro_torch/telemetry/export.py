"""Trace exporters of the port (counterpart of
``repro.telemetry.export``): Chrome-trace/Perfetto JSON and compact JSONL.

Two formats, both views of the same ``Tracer`` state:

  * **Chrome trace JSON** (``write_chrome_trace``): the ``traceEvents``
    array that chrome://tracing and the Perfetto UI open directly.  Spans
    become complete ``"X"`` slices (one track per request uid, one process
    per site), request-scoped events instant ``"i"`` markers on the same
    track, system events (faults, probes) a ``system`` track, and metric
    timelines ``"C"`` counter tracks.  Timestamps are the tracer's clock
    seconds in microseconds (the format's unit).  Phase scopes, where the
    tracer has any, are ``"X"`` slices on a ``scopes`` process of their
    own, at their ``perf_counter`` microseconds.

  * **JSONL** (``write_jsonl``/``load_jsonl``): one self-describing JSON
    object per line (``{"k": "span" | "metric" | "sys", ...}``);
    ``load_jsonl`` rebuilds a ``Tracer`` with its spans, metric timelines
    and system events.  The rows are the JAX package's, field for field,
    so a log written by either package loads in the other.  A tracer with
    phase scopes adds one ``"clock"`` row (its ``clock_anchor``) and a
    ``"scope"`` row per scope, which the JAX package's loader skips.
"""
from __future__ import annotations

import json
from typing import List, Union

from repro_torch.telemetry.tracer import Scope, Span, Tracer

_US = 1e6  # tracer clock is in seconds; chrome traces want microseconds


def to_chrome_trace(tracer: Tracer) -> dict:
    """Render the tracer as a Chrome-trace ``{"traceEvents": [...]}`` dict
    (see module docstring for the mapping)."""
    events: List[dict] = []
    sites = sorted({s.site for s in tracer.spans} |
                   {site for _, _, site, _ in tracer.system_events} |
                   {site for rows in tracer.metrics.values()
                    for _, site, _ in rows})
    pid_of = {site: i + 1 for i, site in enumerate(sites)}
    for site, pid in pid_of.items():
        events.append(dict(ph="M", name="process_name", pid=pid, tid=0,
                           args=dict(name=site or "serve")))
    end_s = max([s.end_s or s.start_s for s in tracer.spans] +
                [t for _, t, _, _ in tracer.system_events] + [0.0])
    for s in tracer.spans:
        pid = pid_of.get(s.site, 1) if sites else 1
        dur = ((s.end_s if s.end_s is not None else end_s) - s.start_s)
        events.append(dict(
            ph="X", name=s.name, cat="root" if s.is_root else "attempt",
            pid=pid, tid=s.uid, ts=s.start_s * _US,
            dur=max(dur, 0.0) * _US,
            args=dict(status=s.status, energy_j=s.energy_j,
                      prefill_tokens=s.prefill_tokens,
                      decode_tokens=s.decode_tokens, fleet=s.fleet,
                      **s.attrs)))
        for etype, t, attrs in s.events:
            events.append(dict(ph="i", name=etype, cat="event", s="t",
                               pid=pid, tid=s.uid, ts=t * _US,
                               args=dict(attrs)))
    for etype, t, site, attrs in tracer.system_events:
        events.append(dict(ph="i", name=etype, cat="system", s="p",
                           pid=pid_of.get(site, 1) if sites else 1,
                           tid=0, ts=t * _US, args=dict(attrs)))
    for name, rows in tracer.metrics.items():
        for t, site, value in rows:
            events.append(dict(ph="C", name=name,
                               pid=pid_of.get(site, 1) if sites else 1,
                               tid=0, ts=t * _US,
                               args={name: value}))
    if tracer.scopes:
        events.extend(_scope_events(tracer, len(pid_of) + 1))
    return dict(traceEvents=events, displayTimeUnit="ms")


def _scope_events(tracer: Tracer, pid: int) -> List[dict]:
    tracer.resolve_device_times()
    out = [dict(ph="M", name="process_name", pid=pid, tid=0,
                args=dict(name="scopes"))]
    for sc in tracer.scopes:
        end = sc.end_ns if sc.end_ns is not None else sc.start_ns
        out.append(dict(ph="X", name=sc.name, cat="scope", pid=pid, tid=0,
                        ts=sc.start_ns / 1e3,
                        dur=max(end - sc.start_ns, 0) / 1e3,
                        args=dict(device_s=sc.device_s, **sc.attrs)))
    return out


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(tracer), fh)
    return path


# --------------------------------------------------------------- JSONL
def _span_row(s: Span) -> dict:
    return dict(k="span", id=s.span_id, uid=s.uid, parent=s.parent_id,
                name=s.name, site=s.site, fleet=s.fleet, t0=s.start_s,
                t1=s.end_s, status=s.status, e_j=s.energy_j,
                unit_e_j=s.unit_energy_j, pf=s.prefill_tokens,
                dec=s.decode_tokens,
                events=[[t, ts, a] for t, ts, a in s.events],
                attrs=s.attrs)


def write_jsonl(tracer: Tracer, path: str) -> str:
    """One JSON object per line: every span, metric sample, and system
    event (round-tripped by ``load_jsonl``)."""
    with open(path, "w") as fh:
        for s in tracer.spans:
            fh.write(json.dumps(_span_row(s)) + "\n")
        for name, rows in tracer.metrics.items():
            for t, site, value in rows:
                fh.write(json.dumps(dict(k="metric", name=name, t=t,
                                         site=site, v=value)) + "\n")
        for etype, t, site, attrs in tracer.system_events:
            fh.write(json.dumps(dict(k="sys", type=etype, t=t, site=site,
                                     attrs=attrs)) + "\n")
        if tracer.scopes:
            tracer.resolve_device_times()
            pc, epoch = tracer.clock_anchor
            fh.write(json.dumps(dict(k="clock", perf_ns=pc,
                                     epoch_ns=epoch)) + "\n")
            for sc in tracer.scopes:
                fh.write(json.dumps(dict(
                    k="scope", id=sc.scope_id, parent=sc.parent_id,
                    name=sc.name, t0_ns=sc.start_ns, t1_ns=sc.end_ns,
                    dev_s=sc.device_s, attrs=sc.attrs)) + "\n")
    return path


def load_jsonl(path: str) -> Tracer:
    """Reconstruct a ``Tracer`` from a ``write_jsonl`` log."""
    tr = Tracer()
    max_id = -1
    for line in open(path):
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        kind = row.get("k")
        if kind == "span":
            span = Span(row["id"], row["uid"], row["parent"], row["name"],
                        row["site"], row["fleet"], row["t0"],
                        end_s=row["t1"], status=row["status"],
                        energy_j=row["e_j"],
                        unit_energy_j=dict(row["unit_e_j"]),
                        prefill_tokens=row["pf"], decode_tokens=row["dec"],
                        events=[(t, ts, a) for t, ts, a in row["events"]],
                        attrs=row["attrs"])
            tr.spans.append(span)
            max_id = max(max_id, span.span_id)
            if span.is_root:
                tr._root[span.uid] = span
            else:
                tr._last_attempt[span.uid] = span
                if span.end_s is None:
                    tr._attempt[span.uid] = span
        elif kind == "metric":
            tr.metrics.setdefault(row["name"], []).append(
                (row["t"], row["site"], row["v"]))
        elif kind == "sys":
            tr.system_events.append((row["type"], row["t"], row["site"],
                                     row["attrs"]))
        elif kind == "clock":
            tr.clock_anchor = (row["perf_ns"], row["epoch_ns"])
        elif kind == "scope":
            tr.scopes.append(Scope(row["id"], row["name"], row["attrs"],
                                   parent_id=row["parent"],
                                   start_ns=row["t0_ns"],
                                   end_ns=row["t1_ns"],
                                   device_s=row["dev_s"]))
    tr._next_id = max_id + 1
    return tr


def coerce_tracer(source: Union[Tracer, str]) -> Tracer:
    """Accept a live ``Tracer`` or a path to a JSONL log."""
    if isinstance(source, str):
        return load_jsonl(source)
    return source
