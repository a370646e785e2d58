"""TIM command line: train, validate or extract for both TIM variants,
the counterpart of ``tim_tpu/cli.py``.

    python -m tim_tpu_torch.cli --variant recognition --train \\
        --video_data_path ... --audio_data_path ... \\
        --video_train_action_pickle ... [...]

The parser has the JAX CLI's flags and defaults, and the data files are
the reference's pickles and npy banks. ``main`` parses, loads the splits
(``load_datasets``: the DataFrame pickles through the port's own reader,
``utils.pdpickle.read_pickle``, with no pandas) and hands them to
``run``, which builds a ``DetectionRunner`` or a ``RecognitionRunner``
on the CUDA card (``device="cuda"``, the default; raises without one)
or, when asked, on the CPU, and then trains
(``--train``), validates (``--validate``) or dumps the validation split
(``--extract_feats``: ``dense_predictions.npz`` for detection, its
``<head>_topk_*`` columns with ``--extract_top_k``;
``val_features.pkl`` for recognition). ``--torch_checkpoint`` loads a
released reference checkpoint strictly (the port uses its parameter
names); ``--resume`` continues from a checkpoint ``--train`` wrote or
from the JAX package's ``checkpoint.msgpack`` or ``orbax/<epoch>``
directory, and ``--pretrained_model`` warm-starts from any of them
(``train.checkpoint.load_checkpoint``).

Several processes, one card each (data, tensor and sequence
parallelism):

    python -m tim_tpu_torch.cli ... --num_shards 2 --shard_id 0 \
        --init_method tcp://host0:29500     # and --shard_id 1 beside it

``--num_shards > 1`` joins the process group at ``--init_method``
(``tcp://host:port`` or ``host:port``) as rank ``--shard_id`` before the
first device query (``parallel.multihost.initialize``: NCCL, each rank on
card ``shard_id % device_count``; gloo for ``device="cpu"``). The
processes form a ``--mesh_data`` x ``--mesh_model`` mesh
(``parallel.mesh``): ``--mesh_model M`` (dividing ``--num_shards``) puts
the encoder's heads and FFN units and the divisible class heads over
groups of M consecutive ranks, ``--sequence_parallel true`` the
encoder's post-LN regions on token shards over them; the runners split
every batch of ``--batch-size`` windows across the data axis
(``--mesh_data``: -1 or ``--num_shards / --mesh_model``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tim_tpu_torch import config as C


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="TIM: audio-visual time-interval transformer "
                    "(PyTorch port)")
    p.add_argument("--variant", choices=["recognition", "detection"],
                   default="recognition")

    # dataset paths (reference names)
    for flag in ("video_data_path", "audio_data_path",
                 "video_train_action_pickle", "video_val_action_pickle",
                 "video_train_context_pickle", "video_val_context_pickle",
                 "audio_train_action_pickle", "audio_val_action_pickle",
                 "audio_train_context_pickle", "audio_val_context_pickle",
                 "video_info_pickle"):
        p.add_argument(f"--{flag}", type=Path, default=Path(""))
    p.add_argument("--dataset", default="epic",
                   choices=["epic", "perception", "ave"])
    p.add_argument("--include_verb_noun", type=_str2bool, default=None)
    p.add_argument("--num_feats", type=int, default=50)
    p.add_argument("--feat_stride", type=int, default=3)
    p.add_argument("--feat_gap", type=float, default=0.2)
    p.add_argument("--window_stride", type=float, default=1.0)
    p.add_argument("--data_modality", default="audio_visual",
                   choices=["visual", "audio", "audio_visual"])
    p.add_argument("--model_modality", default="audio_visual",
                   choices=["visual", "audio", "audio_visual"])

    # model
    p.add_argument("--visual_input_dim", type=int, default=None)
    p.add_argument("--audio_input_dim", type=int, default=2304)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--feedforward_scale", type=int, default=4)
    p.add_argument("--nhead", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--enc_dropout", type=float, default=0.1)
    p.add_argument("--feat_dropout", type=float, default=0.5)
    p.add_argument("--seq_dropout", type=float, default=0.5)
    p.add_argument("--apply_feature_pooling", type=_str2bool, default=False)
    p.add_argument("--compute_dtype", default="bfloat16")

    # train
    p.add_argument("--finetune_epochs", type=int, default=100)
    p.add_argument("--warmup_epochs", type=int, default=2)
    p.add_argument("-b", "--batch-size", dest="batch_size", type=int,
                   default=64)
    p.add_argument("--pretrained_model", default="")
    p.add_argument("--resume", default="",
                   help="checkpoint dir/file for full training resume")
    p.add_argument("--lambda_drloc", type=float, default=0.3)
    p.add_argument("--mixup_alpha", type=float, default=0.2)
    p.add_argument("--lambda_audio", type=float, default=1.0)
    p.add_argument("--m_drloc", type=int, default=32)
    p.add_argument("--early_stop_period", type=int, default=-1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=None)

    # detection-only
    p.add_argument("--iou_threshold", type=float, default=0.6)
    p.add_argument("--lambda_reg", type=float, default=0.5)
    p.add_argument("--label_smoothing", type=float, default=0.9)
    p.add_argument("--normaliser", type=float, default=250.0)
    p.add_argument("--normaliser_momentum", type=float, default=0.9)
    p.add_argument("--verb_only", type=_str2bool, default=True)

    # run mode
    p.add_argument("--train", action="store_true")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--extract_feats", action="store_true")
    p.add_argument("--extract_top_k", type=int, default=0,
                   help="detection dense dumps: ship only the k best "
                        "classes per query (identical eval whenever every "
                        "above-threshold class fits in k); 0 = full dense "
                        "scores")

    # misc / parallel
    p.add_argument("--output_dir", type=Path, default=Path("output"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-freq", "-p", dest="print_freq", type=int,
                   default=100)
    p.add_argument("--num_shards", type=int, default=1,
                   help="total number of processes, one card each")
    p.add_argument("--shard_id", type=int, default=0,
                   help="this process's index in [0, num_shards)")
    p.add_argument("--init_method", default="tcp://localhost:9999",
                   help="coordinator address (tcp://host:port or "
                        "host:port)")
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data-parallel mesh axis (-1 or --num_shards / "
                        "--mesh_model: one process per card)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel mesh axis (divides --num_shards)")
    p.add_argument("--device_bank", type=_str2bool, default=False,
                   help="keep the splits resident in device memory and "
                        "gather windows on the device")
    p.add_argument("--torch_checkpoint", default="",
                   help="released reference checkpoint (.pyth) to load")
    p.add_argument("--fast_scores", type=_str2bool, default=False,
                   help="bf16 attention scores/softmax (serving knob)")
    p.add_argument("--sequence_parallel", type=_str2bool, default=False,
                   help="shard the token axis over the model mesh axis")
    p.add_argument("--remat", type=_str2bool, default=False,
                   help="recompute encoder layers in the backward "
                        "(memory <-> FLOPs trade)")
    return p


def _str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y", "t")


def check_supported(args) -> None:
    """Raise ``ValueError`` for a process grid that one process per card
    cannot lay out: a shard id outside ``--num_shards``, a model axis
    that does not divide it, a data axis other than -1 or
    ``--num_shards / --mesh_model``."""
    if args.num_shards < 1 or not 0 <= args.shard_id < args.num_shards:
        raise ValueError(f"--shard_id {args.shard_id} outside [0, "
                         f"--num_shards {args.num_shards})")
    if args.mesh_model < 1 or args.num_shards % args.mesh_model:
        raise ValueError(f"--mesh_model {args.mesh_model} does not divide "
                         f"--num_shards {args.num_shards}")
    data = args.num_shards // args.mesh_model
    if args.mesh_data not in (-1, data):
        raise ValueError(
            f"--mesh_data {args.mesh_data}: the port runs one process per "
            f"card, so the data axis is -1 or --num_shards / --mesh_model "
            f"({data})")


def initialize(args, device=None) -> None:
    """Join the process group of ``--num_shards`` processes (nothing for
    one, or when this process has joined one already); NCCL unless
    ``device`` is the CPU."""
    from tim_tpu_torch.parallel import multihost
    if args.num_shards > 1 and not multihost.initialized():
        multihost.initialize(args.init_method, args.num_shards,
                             args.shard_id, device=device)


def configs_from_args(args):
    """(model config, train config) of the parsed flags, with the JAX
    CLI's hidden defaults: the dataset presets, the visual width (2048
    detection, 1024 recognition), the depth (6, 4) and the weight decay
    (0.05, 1e-4)."""
    detection = args.variant == "detection"
    include_vn = args.include_verb_noun
    if include_vn is None:
        include_vn = not detection

    # dataset presets (``parser.py:196-204``)
    if args.dataset == "perception":
        visual_classes, audio_classes = (63,), 17
        include_vn = False
    elif args.dataset == "ave":
        visual_classes, audio_classes = (29,), 29
        include_vn = False
    else:
        visual_classes = (97, 300, 3806) if include_vn else (3806,)
        audio_classes = 44
        if detection and not include_vn:
            # EPIC detection regresses verb or noun streams separately
            visual_classes = (97,) if args.verb_only else (300,)

    common = dict(
        visual_classes=visual_classes,
        audio_classes=audio_classes,
        visual_input_dim=args.visual_input_dim
        or (2048 if detection else 1024),
        audio_input_dim=args.audio_input_dim,
        d_model=args.d_model,
        feedforward_scale=args.feedforward_scale,
        nhead=args.nhead,
        num_layers=args.num_layers or (6 if detection else 4),
        enc_dropout=args.enc_dropout,
        feat_dropout=args.feat_dropout,
        seq_dropout=args.seq_dropout,
        input_modality=args.model_modality,
        data_modality=args.data_modality,
        num_feats=args.num_feats,
        include_verb_noun=include_vn,
        apply_feature_pooling=args.apply_feature_pooling,
        compute_dtype=args.compute_dtype,
        fast_scores=args.fast_scores,
        sequence_parallel=args.sequence_parallel,
        remat=args.remat,
    )
    if detection:
        mcfg = C.DetectionConfig(
            iou_threshold=args.iou_threshold,
            label_smoothing=args.label_smoothing,
            **common)
    else:
        mcfg = C.ModelConfig(**common)

    tcfg = C.TrainConfig(
        batch_size=args.batch_size,
        epochs=args.finetune_epochs,
        warmup_epochs=args.warmup_epochs,
        lr=args.lr,
        weight_decay=args.weight_decay
        if args.weight_decay is not None else (0.05 if detection else 1e-4),
        mixup_alpha=args.mixup_alpha,
        lambda_audio=args.lambda_audio,
        lambda_drloc=args.lambda_drloc,
        m_drloc=args.m_drloc,
        lambda_reg=args.lambda_reg,
        normaliser_init=args.normaliser,
        normaliser_momentum=args.normaliser_momentum,
        seed=args.seed,
        early_stop_period=args.early_stop_period,
    )
    return mcfg, tcfg


def load_datasets(args, mcfg, detection: bool):
    """(train_ds, val_ds) from the reference's pickles and npy banks
    (train_ds None unless ``--train``)."""
    from tim_tpu_torch.data.dataset import (
        DetectionDataset, FeatureStore, RecognitionDataset)
    from tim_tpu_torch.data.windows import (
        build_detection_windows, build_recognition_windows,
        normalize_actions)
    from tim_tpu_torch.utils.pdpickle import read_pickle

    window_size = args.num_feats * args.feat_gap * args.feat_stride
    video_info = read_pickle(args.video_info_pickle)

    def split(split_name, v_pkl, a_pkl, v_ctx, a_ctx, sample_aug):
        v_norm = a_norm = None
        v_store = a_store = None
        feat_times = None
        if "visual" in args.data_modality:
            v_norm = normalize_actions(
                read_pickle(v_pkl), "visual", args.dataset,
                detection=detection, window_size=window_size)
        if "audio" in args.data_modality:
            a_norm = normalize_actions(
                read_pickle(a_pkl), "audio", args.dataset,
                detection=detection, window_size=window_size)
        if "visual" in args.model_modality:
            ctx = read_pickle(v_ctx)
            v_store = FeatureStore.from_npy_dir(
                str(args.video_data_path), split_name, ctx)
            feat_times = v_store.feat_times
        if "audio" in args.model_modality:
            ctx = read_pickle(a_ctx)
            a_store = FeatureStore.from_npy_dir(
                str(args.audio_data_path), split_name, ctx)
            feat_times = feat_times or a_store.feat_times

        build = build_detection_windows if detection else \
            build_recognition_windows
        ws = build(
            v_norm, a_norm, video_info, feat_times,
            num_feats=args.num_feats, feat_stride=args.feat_stride,
            feat_gap=args.feat_gap, window_stride=args.window_stride,
            data_modality=args.data_modality)
        if detection:
            return DetectionDataset(
                ws, v_store, a_store, sample_augmentations=sample_aug,
                verb_only=args.verb_only,
                include_verb_noun=mcfg.include_verb_noun,
                dataset_name=args.dataset)
        return RecognitionDataset(ws, v_store, a_store,
                                  sample_augmentations=sample_aug)

    train_ds = None
    if args.train:
        train_ds = split("train", args.video_train_action_pickle,
                         args.audio_train_action_pickle,
                         args.video_train_context_pickle,
                         args.audio_train_context_pickle, True)
    val_ds = split("val", args.video_val_action_pickle,
                   args.audio_val_action_pickle,
                   args.video_val_context_pickle,
                   args.audio_val_context_pickle, False)
    return train_ds, val_ds


def make_runner(args, train_ds, val_ds, *, device=None):
    """The ``DetectionRunner`` or ``RecognitionRunner`` that ``args``
    configures over the given splits, on ``device`` (the card by default),
    its state initialised (``--pretrained_model``). ``--num_shards > 1``:
    this process is rank ``--shard_id`` (the group joined here unless it
    was already)."""
    check_supported(args)
    initialize(args, device)
    mcfg, tcfg = configs_from_args(args)
    if args.variant == "detection":
        from tim_tpu_torch.runner.detection import DetectionRunner as cls
    else:
        from tim_tpu_torch.runner.recognition import RecognitionRunner as cls
    runner = cls(mcfg, tcfg, train_ds, val_ds,
                 mesh_cfg=C.MeshConfig(args.mesh_data, args.mesh_model),
                 output_dir=str(args.output_dir),
                 print_freq=args.print_freq,
                 use_device_bank=args.device_bank, device=device)
    runner.init_state(pretrained=args.pretrained_model or None)
    return runner


def run(args, train_ds, val_ds, *, device=None):
    """The run that ``args`` asks for over the given splits (built by
    ``load_datasets`` or otherwise): the runner of ``make_runner``, the
    ``--torch_checkpoint`` and ``--resume`` loaded, then ``--train``
    (returns the last epoch's validation statistics), ``--validate``
    (prints and returns the statistics) or ``--extract_feats`` (writes the
    dump into ``--output_dir`` and returns it). Several processes: rank 0
    prints and writes."""
    from tim_tpu_torch.parallel import multihost
    detection = args.variant == "detection"
    runner = make_runner(args, train_ds, val_ds, device=device)
    if args.torch_checkpoint:
        import torch
        ckpt = torch.load(args.torch_checkpoint, map_location="cpu",
                          weights_only=False)
        runner.load_torch_checkpoint(ckpt.get("state_dict", ckpt))
    start_epoch = runner.resume(args.resume) if args.resume else 0

    if args.train:
        return runner.fit(start_epoch=start_epoch)
    if args.validate:
        stats = runner.validate()
        if multihost.is_master():
            print(stats)
        return stats
    if args.extract_feats:
        if detection:
            dump = runner.extract_dense_predictions(
                top_k=args.extract_top_k or None)
            if multihost.is_master():
                np.savez(args.output_dir / "dense_predictions.npz", **dump)
            return dump
        return runner.extract_predictions(
            path=str(args.output_dir / "val_features.pkl"))
    raise SystemExit("pass one of --train / --validate / --extract_feats")


def main(argv=None, *, device=None):
    from tim_tpu_torch.models.tim import resolve_device
    args = build_parser().parse_args(argv)
    check_supported(args)
    initialize(args, device)            # before the first device query
    device = resolve_device(device)     # before reading any data
    mcfg, _ = configs_from_args(args)
    train_ds, val_ds = load_datasets(args, mcfg,
                                     args.variant == "detection")
    return run(args, train_ds, val_ds, device=device)


if __name__ == "__main__":
    main()
