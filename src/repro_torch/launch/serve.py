"""Serving launcher: batched continuous-batching engine over any assigned
architecture, at its reduced config (counterpart of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 8 --slots 4

With ``--chaos`` the launcher runs the fault-tolerant engine over a
tiered two-fleet die and injects one seeded fault mid-run, printing the
resilience report:

  PYTHONPATH=src python -m repro_torch.launch.serve --chaos kill

It runs on the card; ``--device cpu`` runs it on the host instead.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--dispatch-tokens", type=int, default=8,
                    help="fused decode tokens per host dispatch")
    ap.add_argument("--stop-token", type=int, default=None,
                    help="EOS-class token id: lanes freeze on device the "
                         "moment they sample it")
    ap.add_argument("--accuracy-slo", type=float, default=None,
                    help="tag every request with this accuracy class "
                         "(normwise rel_err ceiling; needs a chip policy "
                         "with accuracy-tiered units to change routing)")
    ap.add_argument("--chaos", choices=("kill", "throttle", "corrupt"),
                    default=None,
                    help="run the resilient engine on a tiered die and "
                         "inject this seeded fault on the cheap fleet "
                         "mid-run (degrade-don't-drop demo)")
    ap.add_argument("--chaos-at", type=float, default=0.15,
                    help="fault onset, simulated seconds")
    ap.add_argument("--chaos-seed", type=int, default=7,
                    help="FaultInjector RNG seed")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a telemetry trace and write it here: "
                         "*.jsonl -> compact JSONL event log, anything "
                         "else -> Chrome-trace JSON (open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; there is "
                         "no fallback to the CPU)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch._device import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.serve.engine import BatchedServer, Request

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.frontend == "audio":
        raise SystemExit("musicgen prompts require the frame-embed stub")
    model = LM(cfg, device=device)
    params = model.init(seed=0)
    stops = () if args.stop_token is None else (args.stop_token,)

    tracer = None
    if args.trace_out is not None:
        from repro_torch.telemetry import Tracer
        tracer = Tracer()

    if args.chaos is not None:
        _run_chaos(args, cfg, model, params, stops, tracer)
        _write_trace(tracer, args.trace_out)
        return

    server = BatchedServer(model, params, slots=args.slots,
                           max_len=args.max_len,
                           dispatch_tokens=args.dispatch_tokens,
                           stop_tokens=stops, tracer=tracer)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        3 + i % 6).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    accuracy_slo=args.accuracy_slo)
            for i in range(args.requests)]
    for r in reqs:
        server.submit(r)
    finished = server.run(max_steps=2000)
    toks = sum(len(r.output) for r in finished)
    print(f"{len(finished)}/{len(reqs)} requests completed, {toks} tokens, "
          f"{server.dispatches} fused dispatches, "
          f"{server.host_syncs} host syncs")
    _write_trace(tracer, args.trace_out)


def _write_trace(tracer, path):
    if tracer is None or path is None:
        return
    from repro_torch.telemetry import write_chrome_trace, write_jsonl
    if path.endswith(".jsonl"):
        write_jsonl(tracer, path)
    else:
        write_chrome_trace(tracer, path)
    print(f"trace: {len(tracer.spans)} spans -> {path}")


def tiered_unit(name, fmt, rel_err, e_pj):
    """A fabricated sp_cma unit with a self-consistent metrics row in
    ``fmt``, at ``rel_err`` and ``e_pj`` pJ/FLOP (the launchers' dies)."""
    from repro_torch.core import chip
    from repro_torch.core.fpu_arch import FABRICATED
    metrics = dict(freq_ghz=1.0, cycle_ns=1.0, p_total_mw=2e3 * e_pj,
                   area_mm2=0.01, gflops_per_w=1.0 / (e_pj * 1e-3),
                   gflops_per_mm2=200.0, e_eff_pj=e_pj, rel_err=rel_err,
                   avg_latency_penalty=0.0)
    return chip.ChipUnit(name, FABRICATED["sp_cma"], 0.8, 1.2,
                         metrics=metrics, fmt=fmt)


def _run_chaos(args, cfg, model, params, stops, tracer=None):
    """Fault-injection demo: a tiered fp8/fp32 die, one seeded fault on
    the cheap fleet mid-run, every request still completes."""
    import numpy as np

    from repro_torch.core import chip
    from repro_torch.core.formats import FP32, FP8_E4M3
    from repro_torch.faults import FaultEvent, FaultInjector, FaultKind
    from repro_torch.serve.engine import Request
    from repro_torch.serve.resilience import (ResilienceConfig,
                                              ResilientServer)

    tick = 0.05
    device = model.device
    spec = chip.ChipSpec("tiered",
                         (tiered_unit("decode_eco", FP8_E4M3, 1e-2, 0.5),
                          tiered_unit("decode_gold", FP32, 1e-8, 4.0)))
    # the units carry their own metric rows, so serving never reads the
    # policy's calibration: it is fitted on ``device`` only if asked for
    policy = chip.ChipPolicy(spec, device=device)
    kind = {"kill": FaultKind.KILL, "throttle": FaultKind.THROTTLE,
            "corrupt": FaultKind.CORRUPT}[args.chaos]
    event = FaultEvent(at_s=args.chaos_at, unit="decode_eco", kind=kind,
                       magnitude=0.4 if kind is FaultKind.THROTTLE else 1.0,
                       duration_s=4 * tick if kind is FaultKind.CORRUPT
                       else None)
    clock_t = [0.0]
    server = ResilientServer(
        model, params, slots=args.slots, max_len=args.max_len,
        chip_policy=policy, accuracy_fleets=(5e-2, 1e-7),
        dispatch_tokens=args.dispatch_tokens, stop_tokens=stops,
        clock=lambda: clock_t[0],
        injector=FaultInjector((event,), seed=args.chaos_seed),
        resilience=ResilienceConfig(synthetic_dispatch_s=tick,
                                    probe_interval_s=1.0),
        tracer=tracer)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        3 + i % 6).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    accuracy_slo=args.accuracy_slo or 5e-2)
            for i in range(args.requests)]
    for r in reqs:
        server.submit(r)
    for _ in range(2000):
        clock_t[0] += tick
        server.step()
        if server.idle():
            break
    rep = server.resilience_report()
    done = sum(1 for r in reqs if r.done and not r.expired)
    print(f"chaos={args.chaos}: {done}/{len(reqs)} requests completed, "
          f"{sum(1 for r in reqs if r.requeues)} migrated, "
          f"faults_logged={len(rep['fault_log'])}, "
          f"recovery_s={rep['recovery_latency_s']['max']:.3f}, "
          f"wasted_j={server.wasted_energy_j:.3e}")
    for name, h in sorted(rep["health"].items()):
        print(f"  {name}: {h['status']} energy_scale={h['energy_scale']:.2f}")


if __name__ == "__main__":
    main()
