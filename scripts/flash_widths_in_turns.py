"""Time kernels 5 and 5b (``tim_tpu_torch.ops.flash_mha``) of two checkouts
in turns on one CUDA card: the other checkout, this one, this one, the
other (each in a process of its own, importing that checkout's package and
``chip_smoke.py`` helpers), at [8, 16, 1568, dh] bf16 for each head dim,
beside ``scaled_dot_product_attention`` and its backward.

    python scripts/flash_widths_in_turns.py OTHER_ROOT [--head_dims 64,80]

Each number: CUDA events, mean of 10 calls after 2 warm-ups (chip_smoke's
``cuda_ms``; SDPA's backward ``sdpa_bwd_ms``). Prints one JSON line per
(checkout, head dim) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_root(root: str, label: str, head_dims) -> None:
    """The timings of the checkout at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from tim_tpu_torch.ops import flash_mha as fm
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dh in head_dims:
        q, k, v = cs.packed_views(8, 1568, 16, dh, torch.bfloat16, gen)
        kw = {"sm_scale": dh ** -0.5}
        out, lse = fm.flash_mha_with_lse(q, k, v, **kw)
        do = torch.randn(out.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        row = {"label": label, "dh": dh}
        row["fwd_ms"] = cs.cuda_ms(lambda: fm.flash_mha(q, k, v, **kw))
        row["sdpa_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=kw["sm_scale"]))
        row["bwd_ms"] = cs.cuda_ms(lambda: fm.flash_mha_bwd(
            q, k, v, out, lse, do, **kw))
        torch.use_deterministic_algorithms(True)
        try:
            row["bwd_deterministic_ms"] = cs.cuda_ms(
                lambda: fm.flash_mha_bwd(q, k, v, out, lse, do, **kw))
        finally:
            torch.use_deterministic_algorithms(False)
        row["sdpa_bwd_ms"] = cs.sdpa_bwd_ms(q, k, v, do)
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse, do
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("other", help="the other checkout's root")
    parser.add_argument("--head_dims", default="64,80,88,104,128")
    parser.add_argument("--time", nargs=2, metavar=("ROOT", "LABEL"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    head_dims = [int(x) for x in args.head_dims.split(",")]
    if args.time:
        time_root(os.path.abspath(args.time[0]), args.time[1], head_dims)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    turns = [(args.other, "other"), (HERE, "this"), (HERE, "this"),
             (args.other, "other")]
    for root, label in turns:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.other,
             "--head_dims", args.head_dims, "--time", root, label],
            timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
