"""Where the attention kernels' time goes: each bf16 kernel timed with one
part of its loop removed at a time, on the CUDA card.

    python -m tim_tpu_torch.ablate [--kernel 5b|5|4|forward|all]

- 5b, the flash-attention backward (``csrc/flash_mha_bwd_sm90.cuh``), at
  ViT-L's shape [8, 16, 1568, 64], beside the backward of
  ``scaled_dot_product_attention``;
- 5, the flash-attention forward, and 4, the window-attention forward
  (their shared core ``csrc/flash_attention_sm90.cuh``), at ViT-L's shape
  and at Swin-B's stage 1 ([512, 4, 784, 32], shifted, batch 8), each as
  its inference launch and as its training launch (which writes the row
  log-sum-exp), beside ``scaled_dot_product_attention`` (kernel 4: with
  the float mask ab[type]) without and with inputs that require grad (the
  call that also keeps its log-sum-exp).

Each variant is the kernel's source with one text span cut out (so its
outputs are wrong: it measures time only), compiled with the same nvcc
flags as the library, all variants in parallel. Each is timed with CUDA
events (mean of 20 calls after 3) in two rounds of opposite order. The
cost of a part is the full kernel's time less the variant's. Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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

FORWARD_HEADER = "flash_attention_sm90.cuh"
# the forward core's variants; the bias and region cuts change kernel 4
# only (kernel 5's instance has neither)
FORWARD_CUTS = {
    "bias load": ("    if constexpr (BIAS) {\n      if (kt + 1 < "
                  "n_tiles) load_bias", "    sm90::wg_wait<0>();\n"
                  "    sm90::fence_regs(o);", ""),
    "region compare": ("      if (rc.masked) {", "    }\n    if (ragged) {",
                       ""),
    "exponentials": ("sm90::ex2(fmaf(sc[i], rc.c, -mc[r]));",
                     "   // -inf -> 0", "fmaf(sc[i], rc.c, -mc[r]);"),
    "lse store": ("    if constexpr (LSE) {\n      if (rc.tig == 0",
                  "  }\n#pragma unroll\n  for (int i = 0; i < DH / 2; "
                  "i += 2) {", ""),
    "second product (P V)": (
        "    issue_pv<DH, BK>(o, pa, dv(kt - 1));\n",
        "    sm90::wg_commit();\n    sm90::wg_wait<1>();", ""),
}
KERNEL_4_ONLY = ("bias load", "region compare")

def cut(text: str, start: str, end: str, new: str) -> str:
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


def variants(header: str, cuts) -> dict:
    """{name: the header's text}: the full kernel and one variant a
    cut."""
    with open(os.path.join(_build._CSRC, header)) as f:
        text = f.read()
    out = {"full kernel": text}
    out.update({f"without {name}": cut(text, *spec)
                for name, spec in cuts.items()})
    return out


def build(work: str, name: str, header: str, text: str, sources) -> str:
    src = os.path.join(work, name.replace(" ", "_").replace("/", "_")
                       .replace("(", "").replace(")", ""))
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


def ablate_5b(libs, gen):
    qkv = torch.randn(8, 1568, 3, 16, 64, generator=gen, device="cuda")
    q, k, v = fm.unpack_qkv(qkv.to(torch.bfloat16))
    out, lse = fm.flash_mha_with_lse(q, k, v, sm_scale=0.125)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    grads = fm.packed_grads(q)
    do, strides = fm.bwd_args(q, k, v, out, do, grads)
    delta = torch.empty_like(lse)
    acc = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, out, do, *grads)]

    def call(fn):
        status = fn(*ptrs, strides, lse.data_ptr(), delta.data_ptr(),
                    acc.data_ptr(), 8, 16, 1568, 64, 1, 0.125, stream)
        _build.check(status, "flash_mha_bwd variant")

    calls = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).tim_flash_mha_bwd
        fn.argtypes = fm._BWD_ARGTYPES
        calls[name] = (lambda f: lambda: call(f))(fn)
    times = in_turns(calls)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, scale=0.125)
    times["scaled_dot_product_attention backward"] = [cuda_ms(
        lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))]
    return {"shape": [8, 16, 1568, 64], "ms": times}


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


def ablate_5(libs, gen):
    qkv = torch.randn(8, 1568, 3, 16, 64, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = fm.unpack_qkv(qkv)
    view, strides = fm.launch_args(q, k, v)
    lse = fm.row_stats(q)
    stream = torch.cuda.current_stream().cuda_stream

    def args_of(launch):
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, lse.data_ptr() if launch == "lse" else None, 8, 16,
                1568, 64, 1, 0.125, stream)

    calls = forward_calls(libs, "tim_flash_mha", fm._ARGTYPES, args_of,
                          lambda name: not any(c in name for c in
                                               KERNEL_4_ONLY))
    calls["scaled_dot_product_attention"] = (
        lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125))
    calls["scaled_dot_product_attention, inputs require grad"] = (
        sdpa_with_grad(q, k, v, scale=0.125))
    return {"shape": [8, 16, 1568, 64], "ms": in_turns(calls)}


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
                784, 32, 1, 32 ** -0.5, stream)

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


def report(name, result):
    ms = result["ms"]
    full = {launch: sum(ms[f"full kernel, {launch}"]) / 2
            for launch in ("inference", "lse")
            if f"full kernel, {launch}" in ms}
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
                                             "all"), default="all")
    which = parser.parse_args(argv).kernel
    if not torch.cuda.is_available():
        raise SystemExit("tim_tpu_torch.ablate needs a CUDA card")
    jobs = {}
    if which in ("5b", "all"):
        jobs["5b"] = (HEADER, variants(HEADER, CUTS), ["flash_mha_bwd.cu"])
    if which in ("5", "4", "forward", "all"):
        jobs["forward"] = (FORWARD_HEADER,
                           variants(FORWARD_HEADER, FORWARD_CUTS),
                           ["flash_mha.cu", "window_attention.cu"])
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
            results["5b"] = ablate_5b(libs["5b"], gen)
        if which in ("5", "forward", "all"):
            results["5"] = ablate_5(libs["forward"], gen)
        if which in ("4", "forward", "all"):
            results["4"] = ablate_4(libs["forward"], gen)
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
