"""Cluster serving launcher: a heterogeneous two-die cluster under the
seeded bursty/diurnal open-loop trace (counterpart of
``repro.launch.cluster``).

  PYTHONPATH=src python -m repro_torch.launch.cluster --horizon 20 --rate 1.0

With ``--fail-at`` a die is killed mid-trace and the router migrates its
traffic (degrade-don't-drop; every stream resumes on a survivor):

  PYTHONPATH=src python -m repro_torch.launch.cluster --fail-at 5.0 \
      --fail-die eco

It runs on the card; ``--device cpu`` runs it on the host instead.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--dispatch-tokens", type=int, default=4)
    ap.add_argument("--horizon", type=float, default=15.0,
                    help="trace horizon, simulated seconds")
    ap.add_argument("--rate", type=float, default=0.8,
                    help="base arrival rate, requests/s")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tick", type=float, default=0.05,
                    help="simulated seconds per engine step")
    ap.add_argument("--fail-at", type=float, default=None,
                    help="kill --fail-die at this simulated time")
    ap.add_argument("--fail-die", default="eco")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a cluster-wide telemetry trace and write "
                         "it here: *.jsonl -> compact JSONL event log, "
                         "anything else -> Chrome-trace JSON (open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; there is "
                         "no fallback to the CPU)")
    args = ap.parse_args(argv)

    import json

    from repro_torch._device import resolve_device
    from repro_torch.cluster import (ClusterRouter, ClusterSpec,
                                     RequestClass, SimClock, TraceConfig,
                                     generate, latency_stats, replay)
    from repro_torch.configs.base import get_config
    from repro_torch.core import chip
    from repro_torch.core.formats import FP32, FP8_E4M3
    from repro_torch.launch.serve import tiered_unit
    from repro_torch.models import LM

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.frontend == "audio":
        raise SystemExit("musicgen prompts require the frame-embed stub")
    model = LM(cfg, device=device)
    params = model.init(seed=0)

    cluster = ClusterSpec("demo", (
        chip.ChipSpec("eco", (tiered_unit("decode_eco", FP8_E4M3, 1e-2,
                                          0.5),)),
        chip.ChipSpec("gold", (tiered_unit("decode_gold", FP32, 1e-8,
                                           4.0),))))
    clock = SimClock()
    tracer = None
    if args.trace_out is not None:
        from repro_torch.telemetry import Tracer
        tracer = Tracer()
    router = ClusterRouter(model, params, cluster, slots=args.slots,
                           max_len=args.max_len, clock=clock,
                           accuracy_fleets=(5e-2, 1e-7),
                           dispatch_tokens=args.dispatch_tokens,
                           tracer=tracer)
    trace = generate(
        TraceConfig(horizon_s=args.horizon, base_rate_rps=args.rate,
                    seed=args.seed,
                    classes=(RequestClass("loose", weight=3,
                                          accuracy_slo=5e-2),
                             RequestClass("tight", weight=1,
                                          max_new_tokens=8,
                                          accuracy_slo=1e-7,
                                          deadline_slack_s=60.0))),
        cfg.vocab_size)

    if args.fail_at is None:
        rep = replay(router, trace, clock, tick_s=args.tick,
                     dispatch_tokens=args.dispatch_tokens, tracer=tracer)
    else:
        # split replay around the failure so the kill lands mid-traffic
        pre = [a for a in trace if a.at_s < args.fail_at]
        post = [a for a in trace if a.at_s >= args.fail_at]
        rep = replay(router, pre, clock, tick_s=args.tick,
                     dispatch_tokens=args.dispatch_tokens,
                     max_steps=int(args.fail_at / args.tick),
                     tracer=tracer)
        moved = router.fail_chip(args.fail_die)
        print(f"killed die {args.fail_die!r} at t={clock.t:.2f}s: "
              f"{len(moved)} requests evacuated")
        rep2 = replay(router, post, clock, tick_s=args.tick,
                      dispatch_tokens=args.dispatch_tokens,
                      carryover={a.request.uid: a.at_s for a in pre},
                      tracer=tracer)
        rep["finished"] = rep["finished"] + rep2["finished"]
        rep["latency_s"].update(rep2["latency_s"])
        rep["expired"] = rep["expired"] + rep2["expired"]

    st = latency_stats(rep["latency_s"])
    energy = router.energy_report()
    n_fin = len(rep["finished"])
    print(f"{n_fin}/{len(trace)} requests finished "
          f"({len(rep['expired'])} expired), "
          f"p50={st['p50_s']:.3f}s p99={st['p99_s']:.3f}s, "
          f"energy/request={energy['total_j'] / max(n_fin, 1):.3e} J, "
          f"migrations={router.migrations}")
    print("per-die utilization:",
          json.dumps({k: round(v, 3)
                      for k, v in router.utilization_report().items()}))

    if tracer is not None:
        from repro_torch.telemetry import write_chrome_trace, write_jsonl
        if args.trace_out.endswith(".jsonl"):
            write_jsonl(tracer, args.trace_out)
        else:
            write_chrome_trace(tracer, args.trace_out)
        print(f"trace: {len(tracer.spans)} spans -> {args.trace_out}")


if __name__ == "__main__":
    main()
