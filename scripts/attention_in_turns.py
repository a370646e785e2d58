"""Time the bf16 attention kernels of two checkouts in turns on one CUDA
card: the other checkout, this one, this one, the other (each in a process
of its own, importing that checkout's ``tim_tpu_torch`` and
``chip_smoke.py`` helpers, through the public wrappers, so a route's
zero-padded copy is timed with it), beside one PyTorch call for the same
function (``scaled_dot_product_attention``; kernels 1 and 4 with a float
mask).

    python scripts/attention_in_turns.py OTHER_ROOT
        [--only 4,5,1,widths,256] [--head_dims 64,80,88,104,128]

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
  deterministic route) beside SDPA's backward;
- 256: bf16 head dims 129-256 that command lines reach. Kernels 5 / 5b
  at [8, 4, 1568, 256] (ViT-L at finetune_cli --num_heads 4), [8, 6,
  1568, 192] and [8, 6, 1568, 200] (--embed_dim 1152 / 1200 --num_heads
  6): the forward beside SDPA, the backward beside SDPA's backward and
  beside the column-slice passes forced at the same head dim
  (``tim_flash_mha_bwd_cols``). Kernel 1 at [128, 4, 798, 256] (TIM at
  cli --nhead 4), [128, 6, 798, 200] and [128, 6, 798, 180] (--d_model
  600 / 540 --nhead 6), F 100, on strided views of the packed projection:
  beside masked SDPA and the column-slice forward forced at one
  256-column slice (``tim_query_block_attention_cols``; 180 through a
  copy to 192). Each with its bound (bytes at 3.35 TB/s against the
  operations at 989 TFLOP/s bf16) and the routes the wrapper counted.

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
FLASH_256 = ((8, 4, 1568, 256), (8, 6, 1568, 192), (8, 6, 1568, 200))
QUERY_BLOCK_256 = ((128, 4, 256), (128, 6, 200), (128, 6, 180))


def cols_bwd(q, k, v, out, lse, do, scale):
    """Kernel 5b's column-slice passes at q's head dim (the route past 256,
    forced), through their C launcher."""
    import torch
    from tim_tpu_torch import _build
    from tim_tpu_torch.ops import flash_mha as fm
    grads = fm.packed_grads(q)
    do, strides = fm.bwd_args(q, k, v, out, do, grads)
    delta = torch.empty_like(lse)
    b, h, s, dh = q.shape
    fn = _build.launcher("tim_flash_mha_bwd_cols", fm._BWD_COLS_ARGTYPES)
    status = fn(*[t.data_ptr() for t in (q, k, v, out, do, *grads)],
                strides, lse.data_ptr(), delta.data_ptr(), b, h, s, dh, 1,
                float(scale), torch.cuda.current_stream().cuda_stream)
    _build.check(status, "tim_flash_mha_bwd_cols")
    return grads


def cols_query_block(tensors):
    """Kernel 1's column-slice forward at one slice (forced), through its
    C launcher; a head dim off a multiple of 8 through one zero-padded
    copy to the next multiple of 64, as the route past 256 takes it."""
    import ctypes
    import math
    import torch
    from tim_tpu_torch import _build
    from tim_tpu_torch.ops import query_block_attention as qba
    dh = tensors[0].shape[-1]
    if dh % 8:
        tensors = [torch.nn.functional.pad(t, (0, -dh % 64))
                   for t in tensors]
    qq, kc = tensors[0], tensors[1]
    b, h, nq, width = qq.shape
    out = torch.empty((b, h, nq, width), dtype=qq.dtype, device=qq.device)
    strides = (ctypes.c_longlong * 15)(
        *[s for t in tensors for s in t.stride()[:3]])
    fn = _build.launcher("tim_query_block_attention_cols",
                         qba._COLS_ARGTYPES)
    status = fn(*[t.data_ptr() for t in tensors], out.data_ptr(), strides,
                b, h, nq, kc.shape[2], width, 1, 1.0 / math.sqrt(dh),
                torch.cuda.current_stream().cuda_stream)
    _build.check(status, "tim_query_block_attention_cols")
    return out[..., :dh]


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
    if "256" in only:
        for b, h, s, dh in FLASH_256:
            gen = torch.Generator(device="cuda").manual_seed(dh)
            q, k, v = cs.packed_views(b, s, h, dh, bf16, gen)
            kw = {"sm_scale": dh ** -0.5}
            out, lse = fm.flash_mha_with_lse(q, k, v, **kw)
            do = torch.randn(out.shape, generator=gen, device="cuda").to(
                bf16)
            row = {"label": label, "kernel": "flash_mha / flash_mha_bwd",
                   "shape": [b, h, s, dh]}
            row["fwd_routes"] = cs.routes_by_name(
                fm.flash_mha, lambda: fm.flash_mha(q, k, v, **kw))
            row["bwd_routes"] = cs.routes_by_name(
                fm.flash_mha_bwd, lambda: fm.flash_mha_bwd(
                    q, k, v, out, lse, do, **kw))
            row["fwd_ms"] = cs.cuda_ms(lambda: fm.flash_mha(q, k, v, **kw))
            row["sdpa_ms"] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=kw["sm_scale"]))
            row["sdpa_backend"] = cs.sdpa_backend(q, k, v,
                                                  scale=kw["sm_scale"])
            row["fwd_bound_ms"] = cs.bound(
                cs.nbytes(q, k, v, out), 4 * b * h * s * s * dh, "bf16")
            row["bwd_ms"] = cs.cuda_ms(lambda: fm.flash_mha_bwd(
                q, k, v, out, lse, do, **kw))
            row["cols_bwd_ms"] = cs.cuda_ms(lambda: cols_bwd(
                q, k, v, out, lse, do, kw["sm_scale"]))
            row["sdpa_bwd_ms"] = cs.sdpa_bwd_ms(q, k, v, do)
            row["bwd_bound_ms"] = cs.attention_bwd_bound(
                q, 2 * cs.nbytes(q, k, v) + cs.nbytes(out, do, lse))
            print(json.dumps(row), flush=True)
            del q, k, v, out, lse, do
            torch.cuda.empty_cache()
        for b, h, dh in QUERY_BLOCK_256:
            gen = torch.Generator(device="cuda").manual_seed(dh)
            args = cs.packed_views(b, 898, h, dh, bf16, gen, f=100)
            row = {"label": label, "kernel": "query_block_attention",
                   "shape": [b, h, 798, dh], "f": 100}
            row["routes"] = cs.routes_by_name(
                qba.query_block_attention,
                lambda: qba.query_block_attention(*args))
            row["ms"] = cs.cuda_ms(lambda: qba.query_block_attention(*args))
            row["cols_ms"] = cs.cuda_ms(lambda: cols_query_block(args))
            sdpa = cs.masked_sdpa_args(*args)
            row["library_ms"] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
            row["library"] = cs.sdpa_backend(sdpa[0], sdpa[1], sdpa[2],
                                             attn_mask=sdpa[3])
            row["bound_ms"] = cs.bound(
                cs.nbytes(*args) + cs.nbytes(args[0]),
                4 * b * h * 798 * 101 * dh, "bf16")
            print(json.dumps(row), flush=True)
            del args, sdpa
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("other", help="the other checkout's root")
    parser.add_argument("--only", default="4,5,1",
                        help="what to time: 4, 5, 1, widths, 256")
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
