"""Where kernel 5b's time goes: the bf16 flash-attention backward
(``csrc/flash_mha_bwd_sm90.cuh``) timed with one part of its query-tile
loop removed at a time, on the CUDA card.

    python -m tim_tpu_torch.ablate

Each variant is the kernel's source with one text span cut out (so its
gradients are wrong: it measures time only), compiled with the same nvcc
flags as the library, all variants in parallel. Each is timed with CUDA
events at ViT-L's shape [8, 16, 1568, 64] (mean of 20 calls after 3),
in two rounds of opposite order, beside the backward of
``scaled_dot_product_attention``. The cost of a part is the full kernel's
time less the variant's. Prints one JSON line with the card's name and
power limit.
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

HEADER = "flash_mha_bwd_sm90.cuh"
# variant: (where the cut starts, the text that ends it (kept), what
# replaces the cut)
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


def cut(text: str, start: str, end: str, new: str) -> str:
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


def build(work: str, name: str, text: str) -> str:
    src = os.path.join(work, name.replace(" ", "_").replace("/", "_"))
    shutil.copytree(_build._CSRC, src)
    with open(os.path.join(src, HEADER), "w") as f:
        f.write(text)
    lib = src + ".so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
         os.path.join(src, "flash_mha_bwd.cu")], capture_output=True,
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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tim_tpu_torch.ablate needs a CUDA card")
    with open(os.path.join(_build._CSRC, HEADER)) as f:
        text = f.read()
    variants = {"full kernel": text}
    variants.update({f"without {name}": cut(text, *spec)
                     for name, spec in CUTS.items()})
    work = tempfile.mkdtemp()
    try:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = dict(zip(variants, pool.map(
                lambda kv: build(work, *kv), variants.items())))
        gen = torch.Generator(device="cuda").manual_seed(0)
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
        fns = {}
        for name, lib in libs.items():
            fn = ctypes.CDLL(lib).tim_flash_mha_bwd
            fn.argtypes = fm._BWD_ARGTYPES
            fns[name] = fn
        ptrs = [t.data_ptr() for t in (q, k, v, out, do, *grads)]

        def call(fn):
            status = fn(*ptrs, strides, lse.data_ptr(), delta.data_ptr(),
                        acc.data_ptr(), 8, 16, 1568, 64, 1, 0.125, stream)
            _build.check(status, "flash_mha_bwd variant")

        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(cuda_ms(lambda: call(fns[name])))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, scale=0.125)
        sdpa = cuda_ms(lambda: torch.autograd.grad(o, leaves, do,
                                                   retain_graph=True))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    full = sum(times["full kernel"]) / 2
    for name, ms in times.items():
        mean = sum(ms) / 2
        print(f"{name:40s} {ms[0]:.4f} / {ms[1]:.4f} ms  "
              f"(part {full - mean:+.4f} ms)")
    print(f"{'scaled_dot_product_attention backward':40s} {sdpa:.4f} ms")
    print(json.dumps({"card": smi[0] if smi else None, "shape":
                      [8, 16, 1568, 64], "ms": times, "sdpa_bwd_ms": sdpa}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
