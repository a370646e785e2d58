"""The multi-process dry run: counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``.

    python -m tim_tpu_torch.dryrun [N] [--device cuda|cpu]

``dryrun_multichip(n, device=...)`` starts ``n`` ranks, one process each
(gloo on the CPU, NCCL on ``n`` cards), as a mesh of data x model with a
model axis of 2 when ``n`` is even and at least 4 (sequence parallelism
on then), else 1. Each rank runs, at tiny widths (S divisible by 2):

- a recognition and a detection train step (dropout, mixup and drloc at
  their defaults: every draw is the global batch's, so that the ranks
  draw what one process draws);
- both runners' banked validation, and the detection runner's top-2
  dense dump;
- a checkpoint round trip: the recognition runner's state saved (gathered
  over the model ranks, written by rank 0) and resumed into a fresh
  runner, whose validation is compared;
- the data-sharded clip extraction of a tiny fused detection pipeline
  (each data rank extracts its clips, the features gathered over the
  data group) and the pipeline's forward on them.

The same work then runs in this process without a process group, and
every rank's results must be finite and equal it: losses within 1e-4
relative, parameters and everything else within atol 1e-4 / rtol 1e-3.
The splits are built from numpy alone; every head is as wide as the card's kernels take (TIM's 32, the
Swin's 32, the ViT's 64). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

LOSS_RTOL = 1e-4
ATOL, RTOL = 1e-4, 1e-3
SEED = 0


def model_axis(n: int) -> int:
    """JAX's choice: 2 when ``n`` is even and at least 4, else 1."""
    return 2 if n % 2 == 0 and n >= 4 else 1


def _split(kind: str, cfg, rng, *, videos: int = 2, seconds: float = 16.0,
           stride: int = 2, gap: float = 0.2):
    """A synthetic ``kind`` (``"detection"``/``"recognition"``) split of
    ``videos`` videos, a feature every ``gap`` s (two augmentation sets),
    windows of ``num_feats`` features at a 1 s stride; a window's queries
    are the actions (0.3-1.2 s, ten a modality a video) fully inside
    it."""
    from tim_tpu_torch.data.dataset import (
        DetectionDataset, FeatureStore, RecognitionDataset)
    from tim_tpu_torch.data.windows import (
        Window, WindowSet, window_feat_indices)
    size = cfg.num_feats * gap * stride
    vc = cfg.visual_classes
    feats = {"v": {}, "a": {}}
    times, windows = {}, []
    max_v = max_a = next_id = 0
    for i in range(videos):
        vid = f"P{i:02d}_{i:02d}"
        starts = np.arange(0.0, seconds - 1.0, gap, dtype=np.float32)
        times[vid] = np.stack([starts, starts + 1.0], -1)
        for m, dim in (("v", cfg.visual_input_dim),
                       ("a", cfg.audio_input_dim)):
            feats[m][vid] = rng.standard_normal((len(starts), 2, dim),
                                                dtype=np.float32)
        acts = []
        for prefix in ("v", "a"):
            start = rng.uniform(0.0, seconds - 1.5, 10)
            stop = start + rng.uniform(0.3, 1.2, 10)
            labels = -np.ones((10, 4), np.int64)
            if prefix == "v":
                for col, n in enumerate((vc[0], vc[len(vc) // 2], vc[-1])):
                    labels[:, col] = rng.integers(0, n, 10)
            else:
                labels[:, 3] = rng.integers(0, cfg.audio_classes, 10)
            ids = np.arange(next_id, next_id + 10)
            next_id += 10
            acts.append((prefix, np.stack([start, stop], -1).astype(
                np.float32), labels, ids))
        for w in range(int(seconds - size) + 1):
            lo, hi = float(w), float(w) + size
            win = Window(video_id=vid, start_sec=lo, stop_sec=hi,
                         feat_indices=window_feat_indices(
                             times[vid], lo, hi, stride, cfg.num_feats))
            for prefix, q, lab, ids in acts:
                inside = np.flatnonzero((q[:, 0] >= lo) & (q[:, 1] <= hi))
                setattr(win, f"{prefix}_queries", q[inside])
                setattr(win, f"{prefix}_labels", lab[inside])
                setattr(win, f"{prefix}_action_ids", ids[inside])
                setattr(win, f"{prefix}_narration_ids",
                        [f"{prefix}_{j}" for j in ids[inside]])
            max_v = max(max_v, len(win.v_queries))
            max_a = max(max_a, len(win.a_queries))
            windows.append(win)
    ws = WindowSet(windows=windows, max_visual_actions=max_v,
                   max_audio_actions=max_a, num_actions=next_id,
                   window_size=size)
    stores = (FeatureStore(feats["v"], times), FeatureStore(feats["a"], times))
    if kind == "detection":
        return DetectionDataset(ws, *stores, include_verb_noun=False,
                                dataset_name="synthetic",
                                sample_augmentations=False)
    return RecognitionDataset(ws, *stores, sample_augmentations=False)


def _batch(ds, share: slice, n: int, device) -> Dict[str, torch.Tensor]:
    """This rank's rows ``share`` of the split's first ``n`` windows."""
    from tim_tpu_torch.data.dataset import batch_iterator
    batch = next(batch_iterator(ds, n, shuffle=False))
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[share]))
            .to(device) for k, v in batch.items() if not k.startswith("_")}


def _numpy(tree) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def _train_step(kind: str, mesh, sp: bool, batch_size: int, device):
    """One train step of a tiny model of ``kind``: its metrics and whole
    parameters after the update."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models.tim import TimDetection, TimRecognition
    from tim_tpu_torch.train import detection as det
    from tim_tpu_torch.train import recognition as rec
    from tim_tpu_torch.train.optim import make_optimizer
    from tim_tpu_torch.train.state import create_train_state
    common = dict(visual_input_dim=32, audio_input_dim=24, d_model=32,
                  nhead=2, num_layers=2, num_feats=8,
                  compute_dtype="float32", sequence_parallel=sp)
    gen = torch.Generator().manual_seed(SEED)
    if kind == "recognition":
        cfg = C.ModelConfig(visual_classes=(8, 12, 16), audio_classes=8,
                            **common)
        tcfg = C.TrainConfig(lr=1e-3)
        model = TimRecognition(cfg, device=device, generator=gen, mesh=mesh)
    else:
        cfg = C.DetectionConfig(visual_classes=(16,), audio_classes=8,
                                train_query_size=0.04,
                                inference_query_size=0.08, **common)
        tcfg = C.TrainConfig(lr=1e-3, normaliser_init=20.0)
        model = TimDetection(cfg, device=device, generator=gen, mesh=mesh)
    ds = _split(kind, cfg, np.random.default_rng(SEED + 1))
    batch = _batch(ds, mesh.share(batch_size), batch_size, device)
    state = create_train_state(model, make_optimizer(
        model.parameters(), tcfg.lr, tcfg.weight_decay, 100, 10),
        normaliser=tcfg.normaliser_init)
    if kind == "recognition":
        ws = ds.windows
        step = rec.make_train_step(model, cfg, tcfg, ws.max_visual_actions,
                                   ws.max_audio_actions, mesh=mesh)
    else:
        step = det.make_train_step(model, cfg, tcfg, mesh=mesh)
    metrics = step(state, batch)
    out = {f"{kind}_{k}": v for k, v in _numpy(metrics).items()}
    out.update({f"{kind}_param.{k}": v
                for k, v in _numpy(model.full_state_dict()).items()})
    return out


def _runners(mesh_cfg, sp: bool, batch_size: int, device, tmp: str):
    """Both runners' banked validation, the detection dump and the
    recognition checkpoint round trip."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.parallel import multihost
    from tim_tpu_torch.runner.detection import DetectionRunner
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    from tim_tpu_torch.train import checkpoint as ckpt
    common = dict(visual_input_dim=24, audio_input_dim=16, d_model=32,
                  nhead=2, num_layers=1, compute_dtype="float32",
                  sequence_parallel=sp)
    out = {}
    rcfg = C.ModelConfig(visual_classes=(6, 8, 10), audio_classes=6,
                         num_feats=6, **common)
    rtcfg = C.TrainConfig(batch_size=batch_size, epochs=1, warmup_epochs=0,
                          lr=1e-3, seed=SEED)
    rec_ds = _split("recognition", rcfg, np.random.default_rng(SEED + 2))

    def rec_runner():
        r = RecognitionRunner(rcfg, rtcfg, rec_ds, rec_ds, mesh_cfg=mesh_cfg,
                              use_device_bank=True, print_freq=1000,
                              device=device)
        r.init_state()
        return r

    runner = rec_runner()
    runner.train_epoch(0)
    out.update({f"rec_val.{k}": v for k, v in runner.validate().items()})
    ckpt.save_checkpoint(tmp, runner.state, epoch=1)
    multihost.barrier("checkpoint written")
    resumed = rec_runner()
    resumed.resume(tmp)
    out.update({f"rec_resumed_val.{k}": v
                for k, v in resumed.validate().items()})
    same = [torch.equal(a, b) for a, b in zip(
        runner.model.full_state_dict().values(),
        resumed.model.full_state_dict().values())]
    out["rec_resumed_equal"] = float(all(same))

    dcfg = C.DetectionConfig(visual_classes=(4,), audio_classes=4,
                             num_feats=8, train_query_size=0.1,
                             inference_query_size=0.2, **common)
    dtcfg = C.TrainConfig(batch_size=batch_size, epochs=1, warmup_epochs=0,
                          lr=1e-3, normaliser_init=10.0, seed=SEED)
    det_ds = _split("detection", dcfg, np.random.default_rng(SEED + 3))
    det = DetectionRunner(dcfg, dtcfg, det_ds, det_ds, mesh_cfg=mesh_cfg,
                          use_device_bank=True, print_freq=1000,
                          device=device)
    det.init_state()
    det.train_epoch(0)
    out.update({f"det_val.{k}": v for k, v in det.validate().items()})
    dump = det.extract_dense_predictions(top_k=2)
    out.update({f"det_dump.{k}": v for k, v in dump.items()
                if k != "video_ids"})
    return out


def _extraction(mesh, batch_size: int, device):
    """A tiny fused detection pipeline: each data rank extracts the
    features of its clips, gathered over the data group; the pipeline's
    logits on them."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models.backbones.slowfast import AuditorySlowFast
    from tim_tpu_torch.models.backbones.swin3d import SwinTransformer3D
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    from tim_tpu_torch.models.fused import FusedDetectionPipeline
    from tim_tpu_torch.models.queries import generate_query_pyramid
    gen = torch.Generator().manual_seed(SEED)
    swin = SwinTransformer3D(patch_size=(2, 4, 4), embed_dim=32,
                             depths=(1, 1), num_heads=(1, 2),
                             window_size=(2, 4, 4), device=device,
                             generator=gen)
    vit = VideoMAEViT(img_size=16, patch_size=8, embed_dim=64, depth=1,
                      num_heads=1, num_frames=4, tubelet_size=2,
                      device=device, generator=gen)
    audio = AuditorySlowFast(num_classes=5, width=8, alpha=4, beta_inv=4,
                             device=device, generator=gen)
    nf = 3
    cfg = C.DetectionConfig(
        visual_classes=(4,), audio_classes=3,
        visual_input_dim=swin.num_features + vit.embed_dim,
        audio_input_dim=audio.num_features, d_model=32, nhead=2,
        num_layers=1, num_feats=nf, compute_dtype="float32",
        inference_query_size=0.25)
    pipe = FusedDetectionPipeline(cfg, swin=swin, vit=vit, audio=audio,
                                  device=device, generator=gen)
    nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
    rng = np.random.default_rng(SEED + 4)
    clips = rng.standard_normal((batch_size, nf, 4, 16, 16, 3),
                                dtype=np.float32)
    specs = rng.standard_normal((batch_size, nf, 32, 128), dtype=np.float32)
    times = rng.uniform(size=(batch_size, 2 * nf + 2 * nq, 2)).astype(
        np.float32)
    share = mesh.share(batch_size)
    on = {k: torch.from_numpy(v[share]).to(device)
          for k, v in (("clips", clips), ("specs", specs), ("times", times))}
    with torch.inference_mode():
        v_feats = pipe.extract_visual(on["clips"])
        a_feats = pipe.extract_audio(on["specs"])
        cls, reg, _ = pipe.tim.encoder_forward(
            v_feats, a_feats, pipe.tim.encode_times(on["times"]), nq, nq)
    out = {"extract_v_feats": v_feats, "extract_a_feats": a_feats,
           "extract_action": cls[2], "extract_audio": cls[3],
           "extract_v_reg": reg[0]}
    return _numpy({k: mesh.all_gather(v.contiguous())
                   for k, v in out.items()})


def run(n: int, mesh_cfg, device, tmp: str) -> Dict[str, np.ndarray]:
    """Every part of the dry run in this process, as one rank of the
    process group of ``n`` ranks that it has joined (``mesh_cfg`` its
    layout) or, without a group, as the one-process run. ``n``: the
    global batch is ``2 n`` windows."""
    from tim_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_cfg.data, mesh_cfg.model)
    sp = mesh_cfg.model > 1
    batch_size = 2 * n
    out = {}
    for kind in ("recognition", "detection"):
        out.update(_train_step(kind, mesh, sp, batch_size, device))
    out.update(_runners(mesh_cfg, sp, batch_size, device, tmp))
    out.update(_extraction(mesh, batch_size, device))
    return out


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """Raise unless ``got`` holds every key of ``want``, finite and equal
    it (losses within ``LOSS_RTOL`` relative, the rest within ``ATOL`` /
    ``RTOL``); returns the largest difference of each key."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"dry run keys differ: "
                             f"{sorted(set(got) ^ set(want))}")
    errors = {}
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        if not np.isfinite(g).all():
            raise AssertionError(f"dry run {k}: not finite")
        if "loss" in k.rsplit(".", 1)[-1]:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-9,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        errors[k] = float(np.abs(g - w).max()) if g.size else 0.0
    return errors


def _rank_main(args) -> None:
    """One rank: join the group, run, write ``rank<r>.pt``."""
    from tim_tpu_torch.config import MeshConfig
    from tim_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    device = torch.device(args.device)
    multihost.initialize(f"localhost:{args.port}", args.world, args.rank,
                         device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    m = model_axis(args.world)
    out = run(args.world, MeshConfig(args.world // m, m), device, args.tmp)
    torch.save(out, os.path.join(args.tmp, f"rank{args.rank}.pt"))
    multihost.finalize()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device="cuda", timeout: float = 900.0
                     ) -> Dict[str, object]:
    """Run the dry run on ``n`` ranks (subprocesses: gloo with
    ``device="cpu"``, else NCCL, rank r on card r) and in this process;
    raise unless every rank equals this process's run. Returns the mesh,
    the seconds and the largest difference of each result."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA card; pass "
                               "device='cpu' for gloo ranks")
        if n > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip: {n} ranks need {n} cards "
                             f"(NCCL takes one a rank); "
                             f"{torch.cuda.device_count()} here")
    from tim_tpu_torch.config import MeshConfig
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tim_tpu_torch.dryrun", "--rank", str(r),
             "--world", str(n), "--port", port, "--device", device.type,
             "--tmp", tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(n)]
        try:
            os.makedirs(os.path.join(tmp, "one"))
            want = run(n, MeshConfig(1, 1), device if device.type == "cpu"
                       else torch.device("cuda", 0),
                       os.path.join(tmp, "one"))
            logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip: rank {r} exited "
                                   f"{p.returncode}:\n{log[-4000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
    errors = {}
    for got in ranks:
        for k, e in compare(got, want).items():
            errors[k] = max(errors.get(k, 0.0), e)
    if not all(r["rec_resumed_equal"] == 1.0 for r in ranks):
        raise AssertionError("dry run: a resumed state differs from the "
                             "saved one")
    m = model_axis(n)
    return {"ranks": n, "data": n // m, "model": m,
            "sequence_parallel": m > 1, "device": device.type,
            "seconds": time.perf_counter() - t0,
            "max_error": max(errors.values()), "errors": errors}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("python -m tim_tpu_torch.dryrun")
    p.add_argument("n", nargs="?", type=int, default=4,
                   help="ranks (one process each)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", help=argparse.SUPPRESS)
    p.add_argument("--tmp", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    summary = dryrun_multichip(args.n, device=args.device)
    summary.pop("errors")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
