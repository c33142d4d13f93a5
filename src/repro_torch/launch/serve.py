"""LM serving: batched prefill + greedy decode with a KV cache.

The port of ``src/repro/launch/serve.py``, with the same flags and
printed line, plus ``--torch-device`` (default ``cuda``, which raises
without a card; ``cpu`` runs on the CPU). Greedy decoding by default;
non-greedy sampling draws from a seeded ``torch.Generator`` on the
device. Under ``--smoke``, or on the CPU, params and activations are
float32 (the reference's ``set_dtypes`` rule); on the card the bfloat16
GEMMs accumulate in float32 with bfloat16 reduced-precision reductions
and TF32 turned off while it generates (``layers.float32_accumulation``,
which restores the flags after), as the reference's
``preferred_element_type`` asks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 [--torch-device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def generate(cfg, params, prompts, n_gen: int, greedy: bool = True,
             seed: int = 0) -> np.ndarray:
    """prompts (B, S) -> generated tokens (B, n_gen), on the params'
    device: one prefill, then ``n_gen`` decode steps against its cache,
    the tokens kept on the device until the end."""
    from repro_torch.models import transformer as M
    prompts = torch.as_tensor(prompts, device=params["embed"].device)
    b, s = prompts.shape
    cache, logits = M.prefill(cfg, params, prompts, max_len=s + n_gen)
    gen = None if greedy else \
        torch.Generator(device=logits.device).manual_seed(seed)
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    for i in range(n_gen):
        out.append(tok[:, 0])
        logits, cache = M.decode_step(cfg, params, cache, tok, s + i)
        if greedy:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        else:
            tok = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=gen).to(torch.int32)
    return torch.stack(out, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.core.engine import resolve_torch_device
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M

    dev = resolve_torch_device(args.torch_device)
    if args.smoke or dev.type == "cpu":
        L.set_dtypes(torch.float32, torch.float32)
    bundle = get_arch(args.arch)
    if bundle.family != "lm":
        ap.error(f"serve.py drives LM archs; {args.arch!r} is "
                 f"{bundle.family!r}")
    cfg = bundle.smoke_config if args.smoke else bundle.config

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))

    t0 = time.time()
    with L.float32_accumulation():
        toks = generate(cfg, params, prompts, args.gen)
    dt = time.time() - t0
    rate = args.batch * args.gen / dt
    print(f"generated {toks.shape} in {dt:.2f}s ({rate:.1f} tok/s) "
          f"sample row: {toks[0][:16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
