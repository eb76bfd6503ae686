"""Training launcher: trains any assigned architecture at its reduced
config (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 100

It runs eagerly on the card; ``--device cpu`` runs it on the host instead.
Sharded training over several devices (``--devices``/``--data``/
``--model``) is ROADMAP item 12c and not ported yet.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over N devices (ROADMAP item 12c, not "
                         "ported)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; there is "
                         "no fallback to the CPU)")
    args = ap.parse_args(argv)
    if args.devices or args.data != 1 or args.model != 1:
        raise NotImplementedError(
            "--devices/--data/--model: sharded training is ROADMAP item "
            "12c (distribution), not ported yet")

    from repro_torch._device import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.models import LM
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (make_train_state,
                                              make_train_step, train_loop)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = LM(cfg, device=dev)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                      compress_grads=args.compress_grads)
    dcfg = for_arch(cfg, seq_len=args.seq_len, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None

    state = make_train_state(model, 0, opt)
    step = make_train_step(model, opt, microbatches=args.microbatches)
    state, hist = train_loop(
        model, state, step, lambda i: make_batch(dcfg, i, dev),
        n_steps=args.steps, log_every=10,
        checkpoint_manager=mgr, checkpoint_every=args.ckpt_every)
    for row in hist[-3:]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    if mgr:
        mgr.wait()
    print(f"trained {args.arch} (reduced) for {args.steps} steps "
          f"on 1 device(s)")


if __name__ == "__main__":
    main()
