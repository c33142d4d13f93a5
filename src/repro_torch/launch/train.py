"""The training entry point: --arch/--shape selectable, checkpoint and
restart, the straggler watchdog, optional gradient compression.

The port of ``src/repro/launch/train.py``, with the same flags and printed
lines, plus ``--torch-device`` (default ``cuda``, which raises without a
card; ``cpu`` runs on the CPU). A step is the family's ``train_step``:
``loss_fn``'s gradient through every param, then ``optim.adamw.apply``.
Every family trains here: ``recsys`` (``dlrm-mlperf``: the tables'
gradient through the lookup's backward kernel on the card), ``gnn`` (``gcn-cora``, ``gin-tu``,
``schnet``, ``graphcast`` at ``d_in=32, d_out=5`` on the reference's fixed
512-node random graph: every message-passing sum on the sorted-sum
kernel) and ``lm`` (the five transformers on ``TokenStream(vocab,
seed=1)`` batches of ``--batch`` x ``--seq``; the token embedding's
gradient on the sorted-sum kernel, every GEMM accumulating in float32:
``layers.float32_accumulation``). Under ``--smoke``, or on the CPU,
params and activations are float32 (the reference's ``set_dtypes``
rule).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --smoke --steps 30 --batch 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --smoke --steps 30 --compress int8 --torch-device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --smoke --steps 30 --torch-device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --steps 15 --batch 4 --seq 64 --torch-device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import time
from functools import partial


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", choices=["none", "bf16", "int8"],
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L

    bundle = get_arch(args.arch)
    with (L.float32_accumulation() if bundle.family == "lm"
          else contextlib.nullcontext()):
        return _train(args, bundle)


def _train(args, bundle):
    import torch

    from repro_torch.core.engine import resolve_torch_device
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as C
    from repro_torch.runtime.straggler import StepTimeWatchdog

    dev = resolve_torch_device(args.torch_device)
    if args.smoke or dev.type == "cpu":
        L.set_dtypes(torch.float32, torch.float32)

    cfg = bundle.smoke_config if args.smoke else bundle.config
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=max(args.steps, 10),
                                warmup_steps=max(2, args.steps // 10))
    gen = torch.Generator(device=dev).manual_seed(0)

    if bundle.family == "lm":
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import transformer as M
        params = M.init_params(cfg, gen, device=dev)
        stream = TokenStream(cfg.vocab, seed=1)
        batches = (stream.batch(args.batch, args.seq)
                   for _ in range(10**9))
    elif bundle.family == "gnn":
        import dataclasses

        from repro_torch.data.graphs import make_gnn_batch, random_graph
        from repro_torch.models import gnn as M
        cfg = dataclasses.replace(cfg, d_in=32, d_out=5)
        params = M.init_params(cfg, gen, device=dev)
        src, dst = random_graph(512, 2048, seed=1)
        fixed = {k: torch.as_tensor(v, device=dev) for k, v in
                 make_gnn_batch(src, dst, 512, 32, n_classes=5,
                                seed=1).items()}
        batches = (fixed for _ in range(10**9))
    else:
        from repro_torch.data.recsys import CriteoLikeGenerator
        from repro_torch.models import dlrm as M
        params = M.init_params(cfg, gen, device=dev)
        data = CriteoLikeGenerator(cfg.table_sizes, cfg.n_dense, cfg.hot,
                                   seed=1)
        batches = (data.batch(args.batch) for _ in range(10**9))
    loss_fn = partial(M.loss_fn, cfg)

    opt_state = adamw.init(params)
    ef = None
    if args.compress == "int8":
        ef = C.init_error_feedback(params)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and mgr.latest_step() is not None:
            (params, opt_state), start_step = mgr.restore((params, opt_state))
            print(f"resumed from step {start_step}")

    def grads_of(params, batch):
        loss, _, grads = L.value_and_grad(lambda p: loss_fn(p, batch),
                                          params)
        return loss, grads

    step_plain = partial(M.train_step, cfg, opt_cfg)

    def step_int8(params, opt_state, ef, batch):
        loss, grads = grads_of(params, batch)
        packed, ef = C.compress_int8_ef(grads, ef)
        grads = C.decompress_int8(packed)   # stands in for the DCN hop
        params, opt_state, om = adamw.apply(opt_cfg, params, grads, opt_state)
        return params, opt_state, ef, {"loss": loss, **om}

    watchdog = StepTimeWatchdog()
    losses = []
    for i in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(batches).items()}
        t0 = time.time()
        if args.compress == "int8":
            params, opt_state, ef, m = step_int8(params, opt_state, ef, batch)
        else:
            params, opt_state, m = step_plain(params, opt_state, batch)
        loss = float(m["loss"])
        straggle = watchdog.record(time.time() - t0)
        losses.append(loss)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {loss:.4f} lr {float(m['lr']):.2e} "
                  f"gnorm {float(m['grad_norm']):.3f}"
                  f"{' [straggler]' if straggle else ''}", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, (params, opt_state))
    if mgr:
        mgr.save(args.steps, (params, opt_state))
        mgr.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
