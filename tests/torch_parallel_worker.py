"""Cases of the port's data-parallel tests (``tests/test_torch_parallel.py``)
and model-axis tests (``tests/test_torch_tensor_parallel.py``, with
``model2``: two ranks at data 1 x model 2) and the worker that runs them
in several processes over gloo:

    PYTHONPATH=. python tests/torch_parallel_worker.py NPROC RANK PORT \
        INPUTS OUTDIR [model2]

Each rank joins the process group at ``localhost:PORT`` through the TIM
command line (``cli.run`` with ``--num_shards NPROC --shard_id RANK
--init_method localhost:PORT --mesh_data NPROC``, gloo on the CPU), runs
every case on the CPU and writes ``OUTDIR/rank<RANK>.pt``. The runner and
command-line cases are plain functions, so the test runs them in one
process too. Imports nothing of JAX.
"""

import os
import socket
import sys

import numpy as np
import torch

from tim_tpu_torch import config as PC
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import synthetic as psyn
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.parallel import multihost

NUM_FEATS = 8


def _bundle():
    return psyn.synthetic_epic(
        seed=7, num_videos=2, video_seconds=45.0, per_video=8,
        visual_dim=24, audio_dim=16, visual_classes=(5, 6, 4),
        audio_classes=3)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join_group_of_one(backend: str) -> None:
    """A process group of one rank (``backend`` ``"gloo"`` or ``"nccl"``)
    on a free localhost port: the data-parallel path whose collectives
    leave every value as it is. ``multihost.initialize`` joins none for
    one process, as JAX's does."""
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)


def _recognition_splits():
    """(train, validation) ``RecognitionDataset`` of the bundle, without
    augmentation sampling."""
    b = _bundle()
    ws = pwin.build_recognition_windows(
        pwin.normalize_actions(b["v_actions"], "visual"),
        pwin.normalize_actions(b["a_actions"], "audio"), b["video_info"],
        b["v_feat_times"], num_feats=6, feat_stride=2, feat_gap=0.2)
    stores = (pds.FeatureStore(b["v_feats"], b["v_feat_times"]),
              pds.FeatureStore(b["a_feats"], b["a_feat_times"]))
    return tuple(pds.RecognitionDataset(ws, *stores,
                                        sample_augmentations=False)
                 for _ in range(2))


def cli_recognition_stats(out, shard_flags=()) -> dict:
    """``cli.run --train`` (one epoch at batch 8, then its validation) of
    a one-layer width-16 recognition model in fp32 on the CPU, dropout,
    mixup and drloc off; ``shard_flags`` make this process one rank of
    several (the command line joins the group)."""
    from tim_tpu_torch import cli
    args = cli.build_parser().parse_args([
        "--output_dir", str(out), "--train", "--finetune_epochs", "1",
        "--warmup_epochs", "0", "--lr", "1e-3", "--num_feats", "6",
        "--feat_stride", "2", "--d_model", "16", "--nhead", "2",
        "--num_layers", "1", "--visual_input_dim", "24",
        "--audio_input_dim", "16", "--compute_dtype", "float32",
        "--batch-size", "8", "--enc_dropout", "0", "--feat_dropout", "0",
        "--seq_dropout", "0", "--mixup_alpha", "0", "--lambda_drloc", "0",
        "--seed", "0", "--print-freq", "100", *shard_flags])
    stats = cli.run(args, *_recognition_splits(), device="cpu")
    return {k: float(v) for k, v in stats.items()}


def recognition_runner_stats(banked: bool, device="cpu") -> dict:
    """``RecognitionRunner``: validate, one epoch at batch 8, validate
    (dropout, mixup and drloc off; the reference worker's setting)."""
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    cfg = PC.ModelConfig(
        visual_classes=(5, 6, 4), audio_classes=3, visual_input_dim=24,
        audio_input_dim=16, d_model=16, nhead=2, num_layers=1, num_feats=6,
        compute_dtype="float32", enc_dropout=0.0, feat_dropout=0.0,
        seq_dropout=0.0)
    tcfg = PC.TrainConfig(batch_size=8, epochs=1, warmup_epochs=0, lr=1e-3,
                          mixup_alpha=0.0, lambda_drloc=0.0, seed=0)
    runner = RecognitionRunner(
        cfg, tcfg, *_recognition_splits(), print_freq=100,
        use_device_bank=banked, device=device)
    runner.init_state()
    pre = runner.validate()
    runner.train_epoch(0)
    post = runner.validate()
    out = {f"pre_{k}": float(v) for k, v in pre.items()}
    out.update({f"post_{k}": float(v) for k, v in post.items()})
    return out


def detection_runner_digest(banked: bool, device="cpu") -> dict:
    """``DetectionRunner``: validate, one epoch at batch 8, validate, the
    top-2 dense dump."""
    from tim_tpu_torch.runner.detection import DetectionRunner
    b = _bundle()
    window_size = NUM_FEATS * 2 * 0.2
    ws = pwin.build_detection_windows(
        pwin.normalize_actions(b["v_actions"], "visual", detection=True,
                               window_size=window_size),
        pwin.normalize_actions(b["a_actions"], "audio", detection=True,
                               window_size=window_size),
        b["video_info"], b["v_feat_times"], num_feats=NUM_FEATS,
        feat_stride=2, feat_gap=0.2)
    stores = (pds.FeatureStore(b["v_feats"], b["v_feat_times"]),
              pds.FeatureStore(b["a_feats"], b["a_feat_times"]))

    def split():
        return pds.DetectionDataset(ws, *stores, include_verb_noun=False,
                                    dataset_name="synthetic",
                                    sample_augmentations=False)

    cfg = PC.DetectionConfig(
        visual_classes=(4,), audio_classes=3, visual_input_dim=24,
        audio_input_dim=16, d_model=16, nhead=2, num_layers=1,
        num_feats=NUM_FEATS, compute_dtype="float32", train_query_size=0.1,
        inference_query_size=0.2, enc_dropout=0.0, feat_dropout=0.0,
        seq_dropout=0.0)
    tcfg = PC.TrainConfig(batch_size=8, epochs=1, warmup_epochs=0, lr=1e-3,
                          lambda_drloc=0.0, normaliser_init=10.0, seed=0)
    runner = DetectionRunner(cfg, tcfg, split(), split(), print_freq=100,
                             use_device_bank=banked, device=device)
    runner.init_state()
    pre = runner.validate()
    runner.train_epoch(0)
    post = runner.validate()
    dump = runner.extract_dense_predictions(top_k=2)
    out = {f"pre_{k}": float(v) for k, v in pre.items()}
    out.update({f"post_{k}": float(v) for k, v in post.items()})
    out.update(n_rows=len(dump["video_ids"]),
               video_ids=list(dump["video_ids"]),
               action_topk_values=dump["action_topk_values"],
               action_topk_classes=dump["action_topk_classes"],
               v_proposals=dump["v_proposals"],
               normaliser=float(runner.state.normaliser))
    return out


def _fixed_draws(cls, total: int, **fields):
    """A step's draws function that hands out the given draws of the
    global batch of ``total`` rows."""
    def draws(step, batch_size):
        assert batch_size == total, (batch_size, total)
        return cls(**fields)
    return draws


def train_state_case(kind: str, case: dict, mesh):
    """(model, train state, train step) of ``case`` (built by the test:
    configs, weights, the global batch, the draws) on ``mesh``: the model
    built whole and sharded over its model axis, the weights loaded."""
    from tim_tpu_torch.models.tim import TimDetection, TimRecognition
    from tim_tpu_torch.train import detection as pdet
    from tim_tpu_torch.train import recognition as prec
    from tim_tpu_torch.train.optim import make_optimizer
    from tim_tpu_torch.train.state import create_train_state
    tcfg = PC.TrainConfig(**case["tcfg"])
    total = len(case["batch"]["times"])
    d = case["draws"]
    if kind == "detection":
        cfg = PC.DetectionConfig(**case["cfg"])
        model = TimDetection(cfg, device="cpu", mesh=mesh)
        draws = _fixed_draws(pdet.StepDraws, total, v_queries=d["v_queries"],
                             a_queries=d["a_queries"], drloc=d["drloc"],
                             dropout_seed=0)
        step = pdet.make_train_step(model, cfg, tcfg, draws=draws, mesh=mesh)
    else:
        cfg = PC.ModelConfig(**case["cfg"])
        model = TimRecognition(cfg, device="cpu", mesh=mesh)
        draws = _fixed_draws(prec.StepDraws, total, perm=d["perm"],
                             lam=d["lam"], drloc=d["drloc"], dropout_seed=0)
        step = prec.make_train_step(model, cfg, tcfg, case["nv"], case["na"],
                                    draws=draws, mesh=mesh)
    model.load_state_dict(case["state_dict"], strict=True)
    state = create_train_state(model, make_optimizer(
        model.parameters(), tcfg.lr, tcfg.weight_decay, case["total_steps"],
        case["warmup_steps"], min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm),
        normaliser=tcfg.normaliser_init)
    return model, state, step


def train_step_case(kind: str, case: dict, mesh, save_to=None,
                    resume_from=None) -> dict:
    """One train step of ``case`` on this rank's rows (of its data
    group); the whole parameters after it, the gradients it applied
    (``grads``: this rank's slices of the sharded ones) and, with
    ``save_to``, the state saved there (``train.checkpoint``). With
    ``resume_from`` (a checkpoint: ``.pt``, the JAX package's msgpack or
    its orbax directory)
    the state is restored from it before the step."""
    model, state, step = train_state_case(kind, case, mesh)
    if resume_from is not None:
        from tim_tpu_torch.train import checkpoint as ckpt
        ckpt.restore_train_state(state, ckpt.load_checkpoint(resume_from))
    batch = case["batch"]
    rows = mesh.share(len(batch["times"]))
    mine = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in batch.items()}
    grads = {}
    apply = state.optimizer.step

    def recorded():
        grads.update({k: v.grad.clone() for k, v in model.named_parameters()
                      if v.grad is not None})
        return apply()

    state.optimizer.step = recorded
    metrics = step(state, mine)
    names = dict(model.named_parameters())
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {k: v.clone() for k, v in
                      model.full_state_dict().items() if k in names},
           "grads": grads, "sharded": dict(model.shard_specs),
           "tokens_sharded": model.encoder.tokens_sharded,
           "normaliser": float(state.normaliser)}
    if save_to is not None:
        from tim_tpu_torch.train import checkpoint as ckpt
        ckpt.save_checkpoint(save_to, state, epoch=1)
    return out


def resave_case(kind: str, case: dict, mesh, src: str, dst: str) -> None:
    """Resume ``case``'s state from the checkpoint at ``src`` and save it
    to ``dst`` (on a model axis: sliced on load, gathered on save)."""
    from tim_tpu_torch.train import checkpoint as ckpt
    _, state, _ = train_state_case(kind, case, mesh)
    ckpt.restore_train_state(state, ckpt.load_checkpoint(src))
    ckpt.save_checkpoint(dst, state, epoch=1)


def helpers_case(rank: int) -> dict:
    """The host helpers on per-rank arrays."""
    x = np.arange(6, dtype=np.float64).reshape(2, 3) + 10 * rank
    flags = np.asarray([rank == 0, True, False])
    out = {
        "gather": multihost.allgather_host_arrays(x),
        "gather_bool": multihost.allgather_host_arrays(flags),
        "gather_int": multihost.allgather_host_arrays(
            np.asarray([rank, -rank], np.int64)),
        "scalars": multihost.allreduce_host_scalars(
            {"a": rank + 1.0, "b": 2.0 * rank}),
        "sum": multihost.allreduce_host_array(x, "sum"),
        "max": multihost.allreduce_host_array(
            np.asarray([rank, -rank, 7], np.int64), "max"),
        "count": multihost.process_count(),
        "master": multihost.is_master(),
    }
    multihost.barrier("helpers")
    return out


def tensor_parallel_main(rank: int, port: int, inputs: str, outdir: str):
    """The cases of ``tests/test_torch_tensor_parallel.py`` on two ranks
    at data 1 x model 2: the command line with ``--mesh_model 2
    --sequence_parallel true`` (it joins the group), then each train step
    case with sequence parallelism off and on, the checkpoint cases (a
    port checkpoint resaved, a JAX msgpack one and a JAX orbax one resumed
    and stepped) and
    the sharding of each ``rules`` configuration."""
    from tim_tpu_torch.models.tim import TimDetection, TimRecognition
    from tim_tpu_torch.parallel.mesh import make_mesh
    cli_out = os.path.join(outdir, f"cli{rank}")
    out = {"cli": cli_recognition_stats(cli_out, [
        "--num_shards", "2", "--shard_id", str(rank), "--init_method",
        f"localhost:{port}", "--mesh_model", "2",
        "--sequence_parallel", "true"])}
    mesh = make_mesh(-1, 2)
    out["mesh"] = (mesh.shape, mesh.data_rank, mesh.model_rank)
    cases = torch.load(inputs, weights_only=False)
    for name, (kind, case) in cases["steps"].items():
        multihost.collective.calls = 0
        save_to = (os.path.join(outdir, f"ckpt_{name}")
                   if name == cases["save"] else None)
        out[name] = train_step_case(kind, case, mesh, save_to)
        out[name]["collectives"] = multihost.collective.calls
    kind, case = cases["steps"][cases["save"]]
    resave_case(kind, case, mesh, cases["resave_from"],
                os.path.join(outdir, "ckpt_resaved"))
    out["jax_resume"] = train_step_case(kind, case, mesh,
                                        resume_from=cases["jax_resume_from"])
    out["jax_orbax_resume"] = train_step_case(
        kind, case, mesh, resume_from=cases["jax_orbax_resume_from"])
    out["rules"] = {}
    for name, (kind, cfg) in cases["rules"].items():
        cls = TimDetection if kind == "detection" else TimRecognition
        cfg = (PC.DetectionConfig if kind == "detection"
               else PC.ModelConfig)(**cfg)
        model = cls(cfg, device="cpu", mesh=mesh)
        out["rules"][name] = {k: tuple(v.shape)
                              for k, v in model.named_parameters()}
    multihost.barrier("done")
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    multihost.finalize()


def main():
    nproc, rank, port = (int(a) for a in sys.argv[1:4])
    inputs, outdir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    if sys.argv[6:] == ["model2"]:
        return tensor_parallel_main(rank, port, inputs, outdir)
    cli_out = os.path.join(outdir, f"cli{rank}")
    out = {"cli_recognition": cli_recognition_stats(cli_out, [
        "--num_shards", str(nproc), "--shard_id", str(rank),
        "--init_method", f"localhost:{port}", "--mesh_data", str(nproc)])}
    out["cli_group"] = multihost.process_count()
    out["cli_checkpoint"] = os.path.exists(
        os.path.join(cli_out, "checkpoint.pt"))
    from tim_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(-1, 1)
    cases = torch.load(inputs, weights_only=False)
    multihost.collective.calls = 0
    out["helpers"] = helpers_case(rank)
    out["helper_collectives"] = multihost.collective.calls
    for kind in ("recognition", "detection"):
        multihost.collective.calls = 0
        out[f"{kind}_step"] = train_step_case(kind, cases[kind], mesh)
        out[f"{kind}_step_collectives"] = multihost.collective.calls
    for banked in (False, True):
        tag = "bank" if banked else "host"
        out[f"recognition_runner_{tag}"] = recognition_runner_stats(banked)
        out[f"detection_runner_{tag}"] = detection_runner_digest(banked)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    multihost.finalize()


if __name__ == "__main__":
    main()
