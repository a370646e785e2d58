"""Time the bf16 attention kernels of two checkouts in turns on one CUDA
card: the other checkout, this one, this one, the other (each in a process
of its own, importing that checkout's ``tim_tpu_torch`` and
``chip_smoke.py`` helpers, through the public wrappers, so a route's
zero-padded copy is timed with it), beside one PyTorch call for the same
function (``scaled_dot_product_attention``; kernels 1 and 4 with a float
mask).

    python scripts/attention_in_turns.py OTHER_ROOT [--only 4,5,1,widths]
                                         [--head_dims 64,80,88,104,128]

- 4: the window-attention forward at a Swin trunk's stage 1, batch 8,
  shifted ([512, H, 784, dh]: Swin-B's 32, trunk A's 64, trunk C's 40,
  and 48), and at a Swin-B trunk at num_heads (1, 1, 1, 1)'s stages 3 and
  4 ([32, 1, 784, 512], [8, 1, 784, 1024]);
- 5: the flash-attention forward at ViT-L's [8, 16, 1568, 64] and at
  [8, 2 | 1, 1568, 512 | 1024];
- 1: query-block attention at [128, 8, 798, 128] and [128, 2 | 1, 798,
  512 | 1024], F 100;
- widths: kernels 5 and 5b at [8, 16, 1568, dh] for each of
  ``--head_dims``, the forward beside SDPA, the backward (and its
  deterministic route) beside SDPA's backward.

Each number: CUDA events, mean of 10 calls after 2 warm-ups (chip_smoke's
``cuda_ms``; SDPA's backward ``sdpa_bwd_ms``). Prints the card's name and
power limit, then one JSON line per (checkout, kernel, shape).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (heads, head dim, windows a clip, token grid index of SWIN_STAGES)
WINDOW_SHAPES = ((4, 32, 0), (2, 64, 0), (3, 40, 0), (2, 48, 0), (1, 512, 2),
                 (1, 1024, 3))
FLASH_SHAPES = ((8, 16, 1568, 64), (8, 2, 1568, 512), (8, 1, 1568, 1024))
QUERY_BLOCK_SHAPES = ((128, 8, 128), (128, 2, 512), (128, 1, 1024))


def time_root(root: str, label: str, only, head_dims) -> None:
    """The timings of the checkout at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.ops import window_attention as wa
    bf16 = torch.bfloat16

    def emit(kernel, shape, ms, library_ms, library):
        print(json.dumps({"label": label, "kernel": kernel, "shape": shape,
                          "ms": ms, "library_ms": library_ms,
                          "library": library}), flush=True)

    if "4" in only:
        for heads, dh, stage in WINDOW_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(dh)
            n_win, _, dims = cs.SWIN_STAGES[stage]
            shifted = n_win > 1
            q, k, v = cs.swin_qkv(8, n_win, heads, bf16, gen, dh=dh)
            bias, region = cs.swin_bias(heads, dims, shifted, gen)
            kw = {"sm_scale": dh ** -0.5}
            ms = cs.cuda_ms(lambda: wa.window_attention(q, k, v, bias,
                                                        region, **kw))
            lib_qkv, mask = cs.window_library_args(q, k, v, bias, region,
                                                   n_win)
            lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                *lib_qkv, attn_mask=mask, scale=kw["sm_scale"]))
            emit("window_attention", list(q.shape), ms, lib,
                 "masked scaled_dot_product_attention")
            del q, k, v, bias, region, lib_qkv, mask
            torch.cuda.empty_cache()
    if "5" in only:
        for b, h, s, dh in FLASH_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(dh)
            q, k, v = cs.packed_views(b, s, h, dh, bf16, gen)
            kw = {"sm_scale": dh ** -0.5}
            ms = cs.cuda_ms(lambda: fm.flash_mha(q, k, v, **kw))
            lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=kw["sm_scale"]))
            emit("flash_mha", [b, h, s, dh], ms, lib,
                 "scaled_dot_product_attention")
            del q, k, v
            torch.cuda.empty_cache()
    if "1" in only:
        for b, h, dh in QUERY_BLOCK_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(dh)
            args = cs.packed_views(b, 898, h, dh, bf16, gen, f=100)
            ms = cs.cuda_ms(lambda: qba.query_block_attention(*args))
            sdpa = cs.masked_sdpa_args(*args)
            lib = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
            emit("query_block_attention", [b, h, 798, dh], ms, lib,
                 "masked scaled_dot_product_attention")
            del args, sdpa
            torch.cuda.empty_cache()
    if "widths" in only:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dh in head_dims:
            q, k, v = cs.packed_views(8, 1568, 16, dh, bf16, gen)
            kw = {"sm_scale": dh ** -0.5}
            out, lse = fm.flash_mha_with_lse(q, k, v, **kw)
            do = torch.randn(out.shape, generator=gen, device="cuda").to(
                bf16)
            row = {"label": label, "dh": dh}
            row["fwd_ms"] = cs.cuda_ms(lambda: fm.flash_mha(q, k, v, **kw))
            row["sdpa_ms"] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(
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
    parser.add_argument("--only", default="4,5,1",
                        help="what to time: 4, 5, 1, widths")
    parser.add_argument("--head_dims", default="64,80,88,104,128",
                        help="the head dims of 'widths'")
    parser.add_argument("--time", nargs=2, metavar=("ROOT", "LABEL"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    only = args.only.split(",")
    head_dims = [int(x) for x in args.head_dims.split(",")]
    if args.time:
        time_root(os.path.abspath(args.time[0]), args.time[1], only,
                  head_dims)
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
             "--only", args.only, "--head_dims", args.head_dims,
             "--time", root, label], timeout=1200)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
