"""Variant runs: measure named variants of the three chosen cells on the
card.

The port of ``src/repro/launch/perf.py``. Each variant is a (name,
cfg_transform) pair, measured by ``dryrun.run_cell(..., "card",
probes=True)`` into ``results/perf/`` (``--out``):

  python -m repro_torch.launch.perf [--cell dlrm_train] [--force]

None of the three cells fits one card as the reference defines it, so
each is cut by one named cut, recorded in its records' ``reduced``.
Widths are never cut; only batch, depth or table rows are:

  * ``qwen2_prefill`` (qwen2-7b, prefill_32k): batch 32 -> 1, the
    32,768-token sequence kept;
  * ``deepseek_train`` (deepseek-v2-236b, train_4k): batch 256 -> 1, and
    60 layers -> the most whose training state (params, gradients and
    AdamW moments) fits the card; where none fits, the record says so and
    nothing runs;
  * ``dlrm_train`` (dlrm-mlperf, train_batch): each table capped at 2^23
    rows, as the smoke's ``train`` phase caps them.

As in the reference, some variants are the same config, because the
difference between them was a code change there: dlrm's baseline and
v1-v3 (its ``CONFIG`` already sets ``sparse_optimizer`` and
``shard_moments_2d``), and deepseek's v1 and v3. Their spread is a
measure of the noise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

OUT = Path("results/perf")
DLRM_TABLE_CAP = 1 << 23
# bytes a param of a training step holds: bfloat16 param and gradient,
# float32 AdamW moments
TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 4


def qwen2_prefill_variants():
    return [
        ("v1_qchunk1024", lambda c: dataclasses.replace(c, attn_q_chunk=1024)),
        ("v2_qchunk2048", lambda c: dataclasses.replace(c, attn_q_chunk=2048)),
        ("v3_qchunk512", lambda c: dataclasses.replace(c, attn_q_chunk=512)),
    ]


def deepseek_train_variants():
    return [
        ("v1_sortdispatch",
         lambda c: dataclasses.replace(c, moe_impl="gathered_sort")),
        ("v2_sort_qchunk",
         lambda c: dataclasses.replace(c, moe_impl="gathered_sort",
                                       attn_q_chunk=1024)),
        # v3 = v1 + a code change in the reference (device-local dispatch
        # scatters), so the same config here
        ("v3_sort_localdisp",
         lambda c: dataclasses.replace(c, moe_impl="gathered_sort")),
    ]


def dlrm_train_variants():
    return [
        ("v1_sparse_opt",
         lambda c: dataclasses.replace(c, sparse_optimizer=True)),
        # v2 = v1 + a code change in the reference (a replicated row-update
        # constraint), so the same config here
        ("v2_sparse_opt_repl",
         lambda c: dataclasses.replace(c, sparse_optimizer=True)),
        ("v3_sparse_zero_moments",
         lambda c: dataclasses.replace(c, sparse_optimizer=True,
                                       shard_moments_2d=True)),
    ]


CELLS = {
    "qwen2_prefill": ("qwen2-7b", "prefill_32k", qwen2_prefill_variants),
    "deepseek_train": ("deepseek-v2-236b", "train_4k", deepseek_train_variants),
    "dlrm_train": ("dlrm-mlperf", "train_batch", dlrm_train_variants),
}


def train_layers_that_fit(cfg, card_bytes: int) -> int:
    """The most layers (the prefix and whole repeats of the pattern) of an
    LM config whose training state, ``TRAIN_BYTES_PER_PARAM`` bytes a
    param, fits ``card_bytes``; 0 where not even one repeat fits."""
    best = 0
    for k in range(1, cfg.n_repeats + 1):
        n = len(cfg.prefix) + len(cfg.pattern) * k
        c = dataclasses.replace(cfg, n_layers=n)
        if c.params_count() * TRAIN_BYTES_PER_PARAM > card_bytes:
            break
        best = n
    return best


def card_cut(key: str, card_bytes: int
             ) -> Tuple[Optional[Callable], Dict[str, Any], Dict[str, Any]]:
    """(cfg_transform, dims, reduced) of ``key``'s cut to one card of
    ``card_bytes`` (module docstring). ``reduced`` has ``"fits": False``
    where no cut fits."""
    from repro_torch.configs import get_arch

    arch, shape, _ = CELLS[key]
    bundle = get_arch(arch)
    dims = bundle.shapes[shape].dims
    if key == "qwen2_prefill":
        return None, {"batch": 1}, {"batch": [dims["batch"], 1]}
    if key == "deepseek_train":
        cfg = bundle.config
        n = train_layers_that_fit(cfg, card_bytes)
        reduced = {"batch": [dims["batch"], 1], "n_layers": [cfg.n_layers, n],
                   "fits": n > 0}
        return (lambda c: dataclasses.replace(c, n_layers=n)), \
            {"batch": 1}, reduced
    if key == "dlrm_train":
        cfg = bundle.config
        return (lambda c: dataclasses.replace(c, table_sizes=tuple(
            min(v, DLRM_TABLE_CAP) for v in c.table_sizes))), {}, \
            {"table_rows_cap": DLRM_TABLE_CAP,
             "rows": [sum(cfg.table_sizes),
                      sum(min(v, DLRM_TABLE_CAP) for v in cfg.table_sizes)]}
    raise KeyError(key)


def _then(cut: Optional[Callable], tf: Optional[Callable]) -> Callable:
    def both(c):
        if cut is not None:
            c = cut(c)
        return tf(c) if tf is not None else c
    return both


def _not_cut_to_fit(out: Path, arch: str, shape: str, variant: str,
                    reduced: Dict[str, Any]) -> Dict[str, Any]:
    """The record of a variant no cut fits: written, and nothing run."""
    rec = {"arch": arch, "shape": shape, "mesh": "card", "ok": True,
           "variant": variant, "reduced": reduced, "ran": False,
           "fits_one_card": False,
           "reason": "no cut of the depth fits the card"}
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}__{shape}__card__{variant}.json").write_text(
        json.dumps(rec, indent=2))
    return rec


def summarize(rec) -> str:
    if not rec.get("ok"):
        return f"FAIL {rec.get('error', '')[:120]}"
    if not rec.get("ran"):
        return f"NOT RUN: {rec.get('reason', '')}"
    gb = rec.get("peak_bytes", 0) / 2**30
    line = (f"step={rec['step_ms']:.3f}ms peak={gb:.1f}GiB "
            f"flops={rec['counted_flops']:.4g} "
            f"useful={rec.get('useful_flops_ratio', 0):.3f}")
    if "bf16_peak_share" in rec:
        line += f" bf16_peak={rec['bf16_peak_share']:.3f}"
    ext = rec.get("extrapolated")
    if ext:
        step = (f"{ext['step_ms']:.3f}ms" if ext["step_ms"] is not None
                else f"unresolved ({ext['step_ms_unresolved']:.3f}ms)")
        line += (f" | extrapolated step={step} "
                 f"+-{ext['step_ms_spread']:.3f}ms "
                 f"peak={ext.get('peak_bytes', 0) / 2**30:.1f}GiB")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import hbm_bytes

    card_bytes = hbm_bytes(args.torch_device)
    out = Path(args.out)
    n_fail = 0
    for key in ([args.cell] if args.cell else list(CELLS)):
        arch, shape, variants = CELLS[key]
        cut, dims, reduced = card_cut(key, card_bytes)
        for vname, tf in [("baseline", None)] + variants():
            if reduced.get("fits") is False:
                rec = _not_cut_to_fit(out, arch, shape, vname, reduced)
            else:
                rec = run_cell(arch, shape, "card", out, force=args.force,
                               probes=True, cfg_transform=_then(cut, tf),
                               variant=vname, dims=dims, reduced=reduced,
                               torch_device=args.torch_device,
                               card_bytes=card_bytes)
            print(f"{key}/{vname}: {summarize(rec)}", flush=True)
            n_fail += not rec["ok"]
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
