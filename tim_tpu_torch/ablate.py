"""Where the bf16 kernels' time goes: each kernel timed with one part of
its loop removed at a time, on the CUDA card.

    python -m tim_tpu_torch.ablate [--kernel 5b|5|4|forward|4b|2|3|all]
                                   [--head_dim 64]

- 5b, the flash-attention backward, at [8, 16, 1568, head_dim] (ViT-L's
  64 by default: the one-pass core ``csrc/flash_mha_bwd_sm90.cuh``; bf16
  65-128: the two passes of ``csrc/flash_mha_bwd_wide_sm90.cuh``, on the
  instance ``ops.flash_mha.launch_plan`` picks, q, k, v read in place
  where it does), beside the backward of ``scaled_dot_product_attention``;
- 5, the flash-attention forward, and 4, the window-attention forward
  (their shared core ``csrc/flash_attention_sm90.cuh``), at
  [8, 16, 1568, head_dim] and at Swin-B's stage 1 ([512, 4, 784, 32],
  shifted, batch 8), each as
  its inference launch and as its training launch (which writes the row
  log-sum-exp), beside ``scaled_dot_product_attention`` (kernel 4: with
  the float mask ab[type]) without and with inputs that require grad (the
  call that also keeps its log-sum-exp);
- 4b, the window-attention backward (``csrc/window_attention_bwd_sm90.cuh``),
  at Swin-B's stages 1 and 3 (shifted, batch 8), beside the masked
  backward of ``scaled_dot_product_attention``;
- 2, the post-attention tail (``csrc/fused_post_attention_sm90.cuh``) at
  [128 x 898, 1024, 2048], beside its two bare products through
  ``torch.matmul``;
- 3, the fused int8 matmul (``csrc/int8_matmul_fused.cuh``) at the class
  head fc_action ([128 x 399, 1024] bf16 rows of the [128, 898, 1024]
  encoder output -> 3806) with bias, each variant with GELU (so that
  every part is there to cut) and as the serving call (no GELU), beside
  the bare int8 product ``torch._int_mm`` of pre-quantized rows (N
  padded to 3808).

Each variant is the kernel's source with one text span cut out (so its
outputs are wrong: it measures time only), compiled with the same nvcc flags as the library, all variants in
parallel; a variant whose wgmma ptxas serialises or that spills is named. Each is timed with CUDA
events (mean of 20 calls after 3) in two rounds of opposite order. The
cost of a part is the full kernel's time less the variant's. Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from tim_tpu_torch import _build
from tim_tpu_torch.ops import flash_mha as fm
from tim_tpu_torch.ops import window_attention as wa

HEADER = "flash_mha_bwd_sm90.cuh"
# kernel 5b's variants: (where the cut starts, the text that ends it
# (kept), what replaces the cut)
CUTS = {
    "dq atomic adds": ('        asm volatile("red.global.add.v2.f32',
                       "\n    }\n  }\n\n  // dk, dv rows", "        ;"),
    "S/dP products": ("    wgmma_64x64_ss<0, 0, false>(sc,",
                      "    wg_commit();\n    wg_wait<0>();\n"
                      "    fence_regs(sc);", ""),
    "softmax work": ("#pragma unroll\n    for (int i = 0; i < 32; i += 2) {\n"
                     "      const int col", "    // bf16 A fragments", ""),
    "dV/dK products": ("#pragma unroll\n    for (int kk = 0; kk < 4; "
                       "++kk) {\n      wgmma_64x64_rs",
                       "    wg_commit();\n\n    // dS^T", ""),
    "dS stores": ("#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n"
                  "#pragma unroll\n      for", "    fence_async_smem();\n"
                  "    __syncthreads();\n\n    // dQ", ""),
    "q/do loads after the first tile": (
        "    if (jt + kStages - 1 < n_qt)\n", "      load_q(jt + kStages",
        "    if (false)\n"),
}

WIDE_HEADER = "flash_mha_bwd_wide_sm90.cuh"
# kernel 5b's variants past head dim 64 (the two wgmma passes)
WIDE_CUTS = {
    "dk/dv pass": ("  err = launch_pass(dkdv_kernel<DH>",
                   "  return launch_pass(dq_kernel", ""),
    "dq pass": ("  return launch_pass(dq_kernel<DH>",
                "\n}\n\n}  // namespace bwd90", "  return 0;"),
    "dk/dv pass: S/dP products": (
        "    product_rows<DH, kRows>(sc, sm.res_a, wg * 64, "
        "sm.a(jt % kStages));", "  };\n  // dV += P^T dO", ""),
    "dk/dv pass: softmax work": (
        "#pragma unroll\n    for (int i = 0; i < 32; i += 2) {\n"
        "      const int col = (i / 4) * 8 + 2 * tig;\n      const float2 l2",
        "  };\n\n  if constexpr (kPipe<DH>)", ""),
    "dk/dv pass: dV/dK products": (
        "    product_cols<DH>(dv, dv_t, pa, sm.b(jt % kStages));",
        "  };\n  auto retire_dvdk", ""),
    "dq pass: dQ products": (
        "    product_cols<DH>(dq, dq_t, da, sm.a(prev));",
        "    sm90::wg_commit();\n    sm90::wg_wait<1>();", ""),
    "dq pass: softmax work": (
        "#pragma unroll\n    for (int i = 0; i < 32; ++i) {\n"
        "      const int r = (i >> 1) & 1;", "  };\n\n  // tile 0", ""),
}

FORWARD_HEADER = "flash_attention_sm90.cuh"
# the forward core's variants; the bias and region cuts change kernel 4
# only (kernel 5's instance has neither)
FORWARD_CUTS = {
    "bias load": ("    if constexpr (BIAS) {\n      if (kt + 1 < "
                  "n_tiles) load_bias", "    sm90::wg_wait<0>();\n"
                  "#pragma unroll\n    for (int j = 0; j < NC; ++j) "
                  "sm90::fence_regs(o[j]);", ""),
    "region compare": ("      if (rc.masked) {", "    }\n    if (ragged) {",
                       ""),
    "exponentials": ("sm90::ex2(fmaf(sc[i], rc.c, -mc[r]));",
                     "   // -inf -> 0", "fmaf(sc[i], rc.c, -mc[r]);"),
    "lse store": ("    if constexpr (LSE) {\n      if (rc.tig == 0",
                  "  }\n  // a column pair of an accumulator's element", ""),
    "second product (P V)": (
        "    issue_pv<DH, BK, NC>(o, pa, dv(kt - 1));\n",
        "    sm90::wg_commit();\n    sm90::wg_wait<1>();", ""),
}
KERNEL_4_ONLY = ("bias load", "region compare")

WINDOW_BWD_HEADER = "window_attention_bwd_sm90.cuh"
# kernel 4b's variants (the bf16 one-pass backward)
WINDOW_BWD_CUTS = {
    "bias load": ("#pragma unroll\n    for (int i = 0; i < 32; ++i) {\n"
                  "      const int col = min(qt * kBQ",
                  "  };\n", "    for (int i = 0; i < 32; ++i) "
                  "sc[i] = 0.f;\n"),
    "region compare": ("          if (masked && rqe[e]",
                       "          float pe = sm90::ex2", ""),
    "dbias accumulate": ("          if ((q_full || q0 + col + e < S) && "
                         "(SP || key_ok[r]))\n            partial[prow[r]", "        }\n      }\n"
                         "      fwd90::pack_p<64>(sc, pa);", ""),
    "dq adds": ("          if (q0 + row < S)\n            asm volatile("
                "\"red.global.add", "        }\n      }\n"
                "      // every thread of the warpgroup", "          ;\n"),
    "softmax work": (
        "#pragma unroll\n      for (int i = 0; i < 32; i += 2) {\n"
        "        const int col = (i / 4) * 8 + 2 * tig;\n        const int r",
        "      fwd90::pack_p<64>(sc, pa);", ""),
}

TAIL_HEADER = "fused_post_attention_sm90.cuh"
# kernel 2's variants (the bf16 tail)
TAIL_CUTS = {
    "LN1 row pass": ("  int err = launch_ln_rows(x, attn",
                     "  if (err != 0) return err;\n  CUtensorMap",
                     "  int err = 0;\n"),
    "GELU epilogue": ("        const float v0 = gelu_erf(",
                      "        if (row < e.m)\n          *reinterpret_cast"
                      "<uint32_t*>(e.out + (long long)row * e.n + col) =\n"
                      "              tim_attn::pack_bf16(v0, v1);",
                      "        const float v0 = acc[hf][i] + b.x, "
                      "v1 = acc[hf][i + 1] + b.y;\n"),
    "LN2 row pass": ("  return launch_ln_rows(out, nullptr",
                     "\n}\n\n}  // namespace tim_fpa", "  return 0;"),
    "second product (first alone)": ("  EpiParams e2{", "\n}\n\n}  // "
                                     "namespace tim_fpa", "  return 0;"),
    "first product (second alone)": ("  EpiParams e1{", "  EpiParams e2{",
                                     ""),
}

INT8_SOURCE = "int8_matmul_fused.cuh"
# kernel 3's variants
INT8_CUTS = {
    "quantize (x loads and quantize)": (
        "    if (a.x_bf16)\n      fill_tile<", "    sm90::fence_async_smem();",
        ""),
    "epilogue stores": (
        "        if (a.out_bf16)\n          store_pair(",
        "\n      }\n    }\n    __syncwarp();\n  }\n}",
        '        asm volatile("" ::"f"(y0), "f"(y1), "l"(at));'),
    "GELU": ("  if constexpr (GELU) y = gelu_erf(y);\n", "  return y;", ""),
    "bias": ("  if (a.bias) y = __fadd_rn(y, b);\n", "  if constexpr (GELU)",
             ""),
}


def cut(text: str, start: str, end: str, new: str) -> str:
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


def variants(header: str, cuts) -> dict:
    """{name: the header's text}: the full kernel and one variant a cut."""
    with open(os.path.join(_build._CSRC, header)) as f:
        text = f.read()
    out = {"full kernel": text}
    out.update({f"without {name}": cut(text, *spec)
                for name, spec in cuts.items()})
    return out


def build(work: str, name: str, header: str, text: str, sources) -> str:
    src = os.path.join(work, "".join(c if c.isalnum() or c in "-_" else "_"
                                     for c in name))
    shutil.copytree(_build._CSRC, src)
    with open(os.path.join(src, header), "w") as f:
        f.write(text)
    lib = src + ".so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
         *(os.path.join(src, s) for s in sources)], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for '{name}':\n{proc.stderr}")
    for code in ("C7515", "C7512"):
        if code in proc.stderr:
            print(f"[build] '{name}': ptxas serialises its wgmma ({code})")
    spills = [line.strip() for line in proc.stderr.splitlines()
              if re.search(r"\b[1-9]\d* bytes spill (stores|loads)", line)]
    if spills:
        print(f"[build] '{name}': {spills[:4]}")
    return lib


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(calls) -> dict:
    """{name: [ms, ms]}: every call timed in two rounds of opposite order."""
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(cuda_ms(calls[name]))
    return times


def sdpa_with_grad(*args, **kwargs):
    """The forward of ``scaled_dot_product_attention`` on inputs that
    require grad: the call that also keeps its log-sum-exp."""
    leaves = [t.detach().requires_grad_() for t in args]

    def run():
        with torch.enable_grad():
            F.scaled_dot_product_attention(*leaves, **kwargs)
    return run


def packed_qkv(dh, gen):
    """q, k, v [8, 16, 1568, dh] bf16 as views of one packed projection, and
    the instance they run on (which reads them in place)."""
    qkv = torch.randn(8, 1568, 3, 16, dh, generator=gen, device="cuda")
    q, k, v = fm.unpack_qkv(qkv.to(torch.bfloat16))
    inst, copied = fm.launch_plan(dh, torch.bfloat16, q, k, v)
    if copied:
        raise SystemExit(f"--head_dim {dh}: no bf16 instance reads it in "
                         f"place (the wrapper would copy it to {inst})")
    return q, k, v, inst


def ablate_5b(libs, gen, dh):
    q, k, v, inst = packed_qkv(dh, gen)
    scale = dh ** -0.5
    out, lse = fm.flash_mha_with_lse(q, k, v, sm_scale=scale)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    grads = fm.packed_grads(q)
    do, strides = fm.bwd_args(q, k, v, out, do, grads)
    delta = fm.bwd_scratch(lse, inst, True)
    # the fp32 dq sum of the one-pass core (head dim 64 only)
    acc = (torch.empty(q.shape, dtype=torch.float32, device="cuda")
           if inst == 64 else None)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, out, do, *grads)]

    def call(fn):
        status = fn(*ptrs, strides, lse.data_ptr(), delta.data_ptr(),
                    None if acc is None else acc.data_ptr(), 8, 16, 1568,
                    dh, inst, 1, scale, stream)
        _build.check(status, "flash_mha_bwd variant")

    calls = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).tim_flash_mha_bwd
        fn.argtypes = fm._BWD_ARGTYPES
        calls[name] = (lambda f: lambda: call(f))(fn)
    times = in_turns(calls)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, scale=scale)
    times["scaled_dot_product_attention backward"] = [cuda_ms(
        lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))]
    return {"shape": [8, 16, 1568, dh], "instance": inst, "ms": times}


def forward_calls(libs, symbol, argtypes, args_of, cuts_apply):
    """{variant (inference|lse): call} of each library's forward."""
    calls = {}
    for name, lib in libs.items():
        if not cuts_apply(name):
            continue
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = argtypes
        for launch in ("inference", "lse"):
            args = args_of(launch)
            calls[f"{name}, {launch}"] = (
                lambda f, a: lambda: _build.check(f(*a), symbol))(fn, args)
    return calls


def ablate_5(libs, gen, dh):
    q, k, v, inst = packed_qkv(dh, gen)
    scale = dh ** -0.5
    view, strides = fm.launch_args(q, k, v)
    lse = fm.row_stats(q)
    stream = torch.cuda.current_stream().cuda_stream

    def args_of(launch):
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, lse.data_ptr() if launch == "lse" else None, 8, 16,
                1568, dh, inst, 1, scale, stream)

    calls = forward_calls(libs, "tim_flash_mha", fm._ARGTYPES, args_of,
                          lambda name: not any(c in name for c in
                                               KERNEL_4_ONLY))
    calls["scaled_dot_product_attention"] = (
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    calls["scaled_dot_product_attention, inputs require grad"] = (
        sdpa_with_grad(q, k, v, scale=scale))
    return {"shape": [8, 16, 1568, dh], "instance": inst,
            "ms": in_turns(calls)}


def ablate_4(libs, gen):
    """Stage 1 of Swin-B at batch 8: 512 windows x 4 heads, N 784, dh 32,
    shifted (region ids of 64 window types), a random bias [4, 784, 784]."""
    from tim_tpu_torch.models.backbones import swin3d as sw
    n_win, heads, dims = 64, 4, (16, 56, 56)
    qkv = torch.randn(8 * n_win, 784, 3, heads, 32, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = fm.unpack_qkv(qkv)
    bias = torch.randn(heads, 784, 784, generator=gen, device="cuda")
    window, shift = sw.effective_window(dims, (16, 7, 7), (8, 3, 3))
    region = torch.from_numpy(sw.shift_region_ids(dims, window,
                                                  shift)).cuda()
    view, strides = fm.launch_args(q, k, v)
    lse = fm.row_stats(q)
    stream = torch.cuda.current_stream().cuda_stream

    def args_of(launch):
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, lse.data_ptr() if launch == "lse" else None,
                bias.data_ptr(), region.data_ptr(), n_win, 8 * n_win, heads,
                784, 32, 32, 1, 32 ** -0.5, stream)

    calls = forward_calls(libs, "tim_window_attention", wa._ARGTYPES,
                          args_of, lambda name: True)
    shape = (8, n_win * heads, 784, 32)
    lib_qkv = [t.reshape(shape) for t in (q, k, v)]
    mask = wa.attention_bias(bias, region).expand(
        n_win, heads, 784, 784).reshape(1, n_win * heads, 784, 784).to(
            torch.bfloat16)
    calls["masked scaled_dot_product_attention"] = (
        lambda: F.scaled_dot_product_attention(*lib_qkv, attn_mask=mask,
                                               scale=32 ** -0.5))
    calls["masked scaled_dot_product_attention, inputs require grad"] = (
        sdpa_with_grad(*lib_qkv, attn_mask=mask, scale=32 ** -0.5))
    return {"shape": [8 * n_win, heads, 784, 32], "ms": in_turns(calls)}


def ablate_4b(libs, gen):
    """Swin-B's stage 1 ([512, 4, 784, 32], shifted) and stage 3 ([32, 16,
    784, 32], shifted) at batch 8, bf16, beside the masked backward of
    ``scaled_dot_product_attention``."""
    import chip_smoke as cs
    out = {}
    for stage in (1, 3):
        n_win, heads, dims = cs.SWIN_STAGES[stage - 1]
        args, o, lse, do = cs.window_bwd_case(8, n_win, heads, dims, True,
                                              torch.bfloat16, gen)
        q, k, v, bias, region = args
        bw, h, n, dh = q.shape
        grads = fm.packed_grads(q)
        do, strides = fm.bwd_args(q, k, v, o, do, grads)
        delta = torch.empty_like(lse)
        acc = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        groups = wa.bwd_groups(bw, h, n)
        scratch = (torch.empty((groups, h, n, n), device="cuda")
                   if groups > 1 else None)
        dbias = torch.empty_like(bias)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, o, do, *grads)]

        def call(fn):
            status = fn(*ptrs, strides, lse.data_ptr(), delta.data_ptr(),
                        acc.data_ptr(), bias.data_ptr(), region.data_ptr(),
                        n_win, dbias.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        groups, bw, h, n, dh, 32, 1, 32 ** -0.5, stream)
            _build.check(status, "window_attention_bwd variant")

        calls = {}
        for name, lib in libs.items():
            fn = ctypes.CDLL(lib).tim_window_attention_bwd
            fn.argtypes = wa._BWD_ARGTYPES
            calls[name] = (lambda f: lambda: call(f))(fn)
        times = in_turns(calls)
        lib_qkv, mask = cs.window_library_args(q, k, v, bias, region, n_win)
        leaves = [t.detach().requires_grad_() for t in (*lib_qkv, mask)]
        res = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                             scale=32 ** -0.5)
        lib_do = do.reshape(lib_qkv[0].shape)
        times["masked scaled_dot_product_attention backward"] = [cuda_ms(
            lambda: torch.autograd.grad(res, leaves, lib_do,
                                        retain_graph=True))]
        out[f"stage {stage}"] = {"shape": [bw, h, n, dh], "groups": groups,
                                 "ms": times}
        del args, o, lse, do, grads, acc, scratch, leaves, res
        torch.cuda.empty_cache()
    return out


def ablate_2(libs, gen):
    """The bf16 tail at [128 x 898, 1024, 2048], beside the two bare bf16
    products through ``torch.matmul``."""
    import chip_smoke as cs
    from tim_tpu_torch.ops import fused_post_attention as fpa
    args = cs.tail_args(128, torch.bfloat16, gen)
    x = args[0]
    n, c = x.numel() // x.shape[-1], x.shape[-1]
    ff = args[4].shape[0]
    inputs = [x, args[1], args[2], args[3], args[4].to(x.dtype), args[5],
              args[6].to(x.dtype), args[7], args[8], args[9]]
    y = torch.empty((n, c), dtype=x.dtype, device="cuda")
    h = torch.empty((n, ff), dtype=x.dtype, device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in inputs + [y, h, out]]
    calls = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).tim_fused_post_attention
        fn.argtypes = fpa._ARGTYPES
        calls[name] = (lambda f: lambda: _build.check(
            f(*ptrs, n, c, ff, c, 1, fpa.EPS, stream), "tail variant"))(fn)
    y2 = x.reshape(n, c)
    calls["torch.matmul, both products"] = lambda: torch.matmul(
        torch.matmul(y2, inputs[4].t()), inputs[6].t())
    return {"shape": [n, c, ff], "ms": in_turns(calls)}


def ablate_3(libs, gen):
    """fc_action at 128 windows, bf16, with bias, each variant with GELU
    (every part there to cut) and as the serving call (no GELU); beside
    ``torch._int_mm``."""
    from tim_tpu_torch.ops import int8_matmul_fused as i8
    seq = torch.randn(128, 898, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = seq[:, 100:499]
    n = 3806
    w_q = torch.randint(-127, 128, (n, 1024), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) * 3e-4
    b = torch.randn(n, generator=gen, device="cuda") * 0.1
    act_scale = x.float().abs().amax().item() / 127.0
    inv_sx, sx = i8._scales(act_scale)
    out = torch.empty((128, 399, n), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, gelu):
        _build.check(fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                        b.data_ptr(), out.data_ptr(), x.stride(0),
                        x.stride(1), 128, 399, 1024, 1024, n, inv_sx, sx,
                        gelu, 1, 1, None, stream),
                     "int8_matmul_fused variant")

    calls = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).tim_int8_matmul_fused
        fn.argtypes = i8._ARGTYPES
        for launch, gelu in (("with GELU", 1), ("serving call", 0)):
            calls[f"{name}, {launch}"] = (
                lambda f, g: lambda: call(f, g))(fn, gelu)
    xq = torch.clamp(torch.round(x.reshape(-1, 1024).float() * inv_sx),
                     -127, 127).to(torch.int8)
    w_pad = F.pad(w_q, (0, 0, 0, -n % 8))
    calls["torch._int_mm, pre-quantized x"] = (
        lambda: torch._int_mm(xq, w_pad.t()))
    return {"shape": [128 * 399, 1024, n], "ms": in_turns(calls)}


def report(name, result):
    ms = result["ms"]
    full = {key.split(", ", 1)[1]: sum(times) / 2
            for key, times in ms.items() if key.startswith("full kernel, ")}
    if "full kernel" in ms:
        full[None] = sum(ms["full kernel"]) / 2
    for variant, times in ms.items():
        mean = sum(times) / len(times)
        launch = variant.rsplit(", ", 1)[-1] if ", " in variant else None
        part = (f"  (part {full[launch] - mean:+.4f} ms)"
                if launch in full and variant.startswith("without") else "")
        print(f"[{name}] {variant:58s} "
              f"{' / '.join(f'{t:.4f}' for t in times)} ms{part}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--kernel", choices=("5b", "5", "4", "forward",
                                             "4b", "2", "3", "all"),
                        default="all")
    parser.add_argument("--head_dim", type=int, default=64,
                        help="kernels 5 and 5b's head dim: 64, or one that "
                        "a bf16 instance past 64 reads in place (a "
                        "multiple of 8 from 72 to 128)")
    parsed = parser.parse_args(argv)
    which, dh = parsed.kernel, parsed.head_dim
    if not torch.cuda.is_available():
        raise SystemExit("tim_tpu_torch.ablate needs a CUDA card")
    jobs = {}
    if which in ("5b", "all"):
        header, cuts = (HEADER, CUTS) if dh == 64 else (WIDE_HEADER,
                                                        WIDE_CUTS)
        jobs["5b"] = (header, variants(header, cuts),
                      ["flash_mha_bwd.cu", "flash_mha_bwd_wide.cu"])
    if which in ("5", "4", "forward", "all"):
        jobs["forward"] = (FORWARD_HEADER,
                           variants(FORWARD_HEADER, FORWARD_CUTS),
                           ["flash_mha.cu", "flash_mha_wide.cu",
                            "window_attention.cu"])
    if which in ("4b", "all"):
        jobs["4b"] = (WINDOW_BWD_HEADER,
                      variants(WINDOW_BWD_HEADER, WINDOW_BWD_CUTS),
                      ["window_attention_bwd.cu",
                       "window_attention_bwd_sm90.cu"])
    if which in ("2", "all"):
        jobs["2"] = (TAIL_HEADER,
                     variants(TAIL_HEADER, TAIL_CUTS),
                     ["fused_post_attention.cu",
                      "fused_post_attention_sm90.cu"])
    if which in ("3", "all"):
        jobs["3"] = (INT8_SOURCE, variants(INT8_SOURCE, INT8_CUTS),
                     ["int8_matmul_fused.cu", "int8_matmul_fused_gelu.cu"])
    work = tempfile.mkdtemp()
    try:
        tasks = [(job, name, header, text, sources)
                 for job, (header, texts, sources) in jobs.items()
                 for name, text in texts.items()]
        with ThreadPoolExecutor(len(tasks)) as pool:
            built = list(pool.map(
                lambda t: build(work, f"{t[0]}-{t[1]}", *t[2:]), tasks))
        libs = {job: {} for job in jobs}
        for (job, name, *_), lib in zip(tasks, built):
            libs[job][name] = lib
        gen = torch.Generator(device="cuda").manual_seed(0)
        results = {}
        if "5b" in jobs:
            results["5b"] = ablate_5b(libs["5b"], gen, dh)
        if which in ("5", "forward", "all"):
            results["5"] = ablate_5(libs["forward"], gen, dh)
        if which in ("4", "forward", "all"):
            results["4"] = ablate_4(libs["forward"], gen)
        if "4b" in jobs:
            for stage, res in ablate_4b(libs["4b"], gen).items():
                results[f"4b {stage}"] = res
        if "2" in jobs:
            results["2"] = ablate_2(libs["2"], gen)
        if "3" in jobs:
            results["3"] = ablate_3(libs["3"], gen)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    for name, result in results.items():
        report(name, result)
    print(json.dumps({"card": smi[0] if smi else None, **results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
