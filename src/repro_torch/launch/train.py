"""Training launcher: trains any assigned architecture at its reduced
config (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --device cpu --devices 8 --data 4 --model 2 --steps 50

It runs eagerly on the card; ``--device cpu`` runs it on the host instead.
``--devices N --data D --model M`` shards it over a (data=D, model=M) mesh
of N = D * M ranks, the train state laid out by ``param_specs``: on the
CPU, N spawned gloo ranks (the counterpart of forcing N host devices); on
the card, one NCCL rank per CUDA device, and N must be the number of CUDA
devices.  Rank 0 prints the rows.
"""
import argparse


def _train(args, dev, data: int = 0, model_axis: int = 0):
    """The training run on this process; on a mesh of (data, model) when
    ``data`` is given.  Returns the lines to print."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.models import LM
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (make_train_state,
                                              make_train_step, train_loop)

    cfg = get_config(args.arch).reduced()
    model = LM(cfg, device=dev)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                      compress_grads=args.compress_grads)
    dcfg = for_arch(cfg, seq_len=args.seq_len, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None

    ctx = grad_sh = None
    if data:
        from repro_torch.launch.mesh import make_host_mesh
        ctx = sh.make_context(make_host_mesh(data=data, model=model_axis))
    with sh.use_mesh(ctx):
        state = make_train_state(model, 0, opt)
        if ctx is not None:
            specs = sh.param_specs(state, cfg.n_experts, ctx)
            state = sh.distribute_tree(state, specs, ctx)
            grad_sh = sh.named_shardings(specs.params, ctx)
        step = make_train_step(model, opt, microbatches=args.microbatches,
                               grad_shardings=grad_sh)
        state, hist = train_loop(
            model, state, step, lambda i: make_batch(dcfg, i, dev),
            n_steps=args.steps, log_every=10,
            checkpoint_manager=mgr, checkpoint_every=args.ckpt_every)
    lines = [str({k: round(v, 4) if isinstance(v, float) else v
                  for k, v in row.items()}) for row in hist[-3:]]
    if mgr:
        mgr.wait()
    lines.append(f"trained {args.arch} (reduced) for {args.steps} steps "
                 f"on {args.devices or 1} device(s)")
    return lines


def _rank(rank, args, device_type):
    """One rank of a sharded run (``launch.mesh.spawn``)."""
    import torch
    dev = torch.device("cuda", rank) if device_type == "cuda" \
        else torch.device("cpu")
    return _train(args, dev, args.data, args.model)


def _sharded(args, device_type):
    """The lines of a run sharded over ``args.devices`` ranks."""
    import os
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn
    n = args.devices
    if n != args.data * args.model:
        raise ValueError(f"--devices {n} is not --data {args.data} x "
                         f"--model {args.model}")
    if device_type == "cpu":
        return spawn(_rank, n, args, "cpu")[0]
    if n != torch.cuda.device_count():
        raise ValueError(f"--devices {n}: there are "
                         f"{torch.cuda.device_count()} CUDA devices")
    if n > 1:
        return spawn(_rank, n, args, "cuda", backend="nccl")[0]
    # one card: a world of one NCCL rank in this process
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", rank=0, world_size=1,
                                init_method="file://" + os.path.join(
                                    tmp, "store"),
                                timeout=timedelta(seconds=60))
        try:
            return _rank(0, args, "cuda")
        finally:
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over N ranks, a (data, model) mesh: gloo "
                         "ranks with --device cpu, else one per CUDA device")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; there is "
                         "no fallback to the CPU)")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    dev = resolve_device(args.device)
    if args.devices:
        lines = _sharded(args, dev.type)
    else:
        lines = _train(args, dev)
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
