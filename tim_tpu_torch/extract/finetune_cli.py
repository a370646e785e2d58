"""VideoMAE backbone training command line: counterpart of
``tim_tpu/extract/finetune_cli.py`` (the role of the reference's
``feature_extractors/VideoMAE/run_class_finetuning.py`` and of the
pretraining launcher its tree references but omits):

    # EK100 classification finetune on extracted frame dirs
    python -m tim_tpu_torch.extract.finetune_cli --mode finetune \\
        --anno_train train.csv --anno_val val.csv --data_path frames/ \\
        --epochs 50 --batch_size 16 --pretrained pre_out/checkpoint.pt

    # MAE pretraining (tube masking, pixel reconstruction)
    python -m tim_tpu_torch.extract.finetune_cli --mode pretrain \\
        --anno_train train.csv --data_path frames/ --mask_ratio 0.9

The parser has the JAX CLI's flags and defaults. ``main`` reads the
annotation CSVs (video_id, start_frame, stop_frame, verb_class,
noun_class) with the port's own reader (``data.table.read_csv``, no
pandas) and the frames with the port's own JPEG decoder
(``extract.clips.jpeg_frame_reader``: cv2.imread's pixels and orientation,
no cv2), builds the clip datasets (``datasets``; the finetune clips'
RandAugment is ``VideoRandAugment`` over the port's own Pillow ops,
``extract.imageops``, so neither mode loads PIL) and hands them to
``run``, which trains on the CUDA card (``device="cuda"``, the default; raises without one) or,
when asked, on the CPU:

- ``--mode pretrain``: ``BackbonePretrainRunner`` over
  ``PretrainVideoMAE`` on train clips with identity RandAugment and no
  erasing (the reference's pretraining transform is crop and flip only);
- ``--mode finetune``: ``BackboneFinetuneRunner`` over
  ``TwoHeadViT(VideoMAEViT)``, then ``validate()``; ``--pretrained`` merges
  the encoder of a checkpoint that ``--mode pretrain`` wrote
  (``checkpoint.pt``) into the trunk (the MAE encoder's names are the
  ViT's: every ``blocks.{i}`` entry loads, ``fc_norm`` keeps its init),
  or of the JAX package's ``checkpoint.msgpack`` of its pretraining
  (merged as JAX merges it, by flax path and shape:
  ``train.checkpoint.jax_merge``).

Each mode ends with ``train.checkpoint.save_checkpoint`` and returns its
statistics. The ViT's attention is kernel 5 (and 5b) on the card and its
plain version on the CPU, whatever ``--flash_attention`` says among
``auto`` and ``on``; the card has no other attention, so ``off`` raises
there. JAX refuses ``--remat`` with flash attention because the TPU
compiler crashes; the port has no such limit: ``--remat`` and
``--remat_mlp`` are ``torch.utils.checkpoint`` over whole blocks or the
MLP sub-block, kernel 5 outside the recomputation of the latter
(``--remat_mlp auto``: on for pretraining).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from tim_tpu_torch.train import checkpoint as ckpt


def build_parser():
    p = argparse.ArgumentParser("python -m tim_tpu_torch.extract.finetune_cli")
    p.add_argument("--mode", choices=["finetune", "pretrain"],
                   default="finetune")
    p.add_argument("--anno_train", required=True)
    p.add_argument("--anno_val", default="")
    p.add_argument("--data_path", required=True)
    p.add_argument("--filename_tmpl", default="img_{:05d}.jpg")
    # model (ViT-L defaults, ``run_class_finetuning.py`` vit_large_patch16)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--embed_dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--num_heads", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--num_verbs", type=int, default=97)
    p.add_argument("--num_nouns", type=int, default=300)
    # recipe
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--num_sample", type=int, default=2)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--mask_ratio", type=float, default=0.9)
    p.add_argument("--pretrained", default="",
                   help="checkpoint written by --mode pretrain "
                        "(checkpoint.pt, or the JAX package's "
                        "checkpoint.msgpack) whose encoder warm-starts the "
                        "finetune trunk")
    p.add_argument("--compute_dtype", default="bfloat16",
                   help="bfloat16 or float32")
    p.add_argument("--flash_attention", default="auto",
                   choices=["auto", "on", "off"],
                   help="the ViT's attention: kernel 5 on the card, its "
                        "plain version on the CPU (auto and on); off "
                        "raises on the card, which has no other route")
    p.add_argument("--remat", action="store_true",
                   help="torch.utils.checkpoint each ViT block: recompute "
                        "block activations in the backward")
    p.add_argument("--remat_mlp", default="auto",
                   choices=["auto", "on", "off"],
                   help="torch.utils.checkpoint only the LN2+MLP sub-block "
                        "(the attention kernel outside it); auto = on for "
                        "pretrain")
    p.add_argument("--output_dir", type=Path, default=Path("output"))
    p.add_argument("--seed", type=int, default=0)
    return p


def identity_augment(frames):
    """RandAugment that leaves the frames as they are (pretraining)."""
    return frames


def datasets(args, anno_train, anno_val, reader: Callable, *,
             rand_augment: Optional[Callable] = None):
    """(train_ds, val_ds) of ``args.mode`` over annotation columns (a
    ``Table``, a DataFrame or a ``dict`` of arrays) and a frame reader:
    pretraining takes train clips with identity RandAugment and no erasing
    (val_ds None); finetuning takes ``--num_sample`` views a clip with
    ``rand_augment`` (None: the recipe's ``VideoRandAugment``) and erasing
    at ``--reprob``, and validation clips of ``anno_val`` (``anno_train``
    when None)."""
    from tim_tpu_torch.extract.clips import EK100ClipDataset
    common = dict(num_frames=args.num_frames, crop_size=args.input_size)
    if args.mode == "pretrain":
        return EK100ClipDataset(
            anno_train, reader, mode="train", num_sample=1, reprob=0.0,
            rand_augment=identity_augment, **common), None
    train_ds = EK100ClipDataset(
        anno_train, reader, mode="train", num_sample=args.num_sample,
        reprob=args.reprob, rand_augment=rand_augment, **common)
    val_ds = EK100ClipDataset(
        anno_train if anno_val is None else anno_val, reader,
        mode="validation", **common)
    return train_ds, val_ds


def load_pretrained_encoder(path: str, trunk: torch.nn.Module
                            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the parameters of the checkpoint at ``path``, the entries of
    ``trunk``'s state dict that it lacks or holds at another shape). The
    checkpoint is one that ``--mode pretrain`` wrote, or a JAX msgpack or
    orbax one (then the parameters are the trunk's whole state dict with
    the file's encoder merged in, ``train.checkpoint.jax_merge``)."""
    params = ckpt.load_checkpoint(path)["params"]
    if ckpt.is_flax_tree(params):
        return ckpt.jax_merge(trunk, params)
    missing = [k for k, v in trunk.state_dict().items()
               if k not in params or tuple(params[k].shape) != tuple(v.shape)]
    return params, missing


def run(args, train_ds, val_ds=None, *, device=None,
        weights: Optional[Mapping[str, torch.Tensor]] = None):
    """The training that ``args.mode`` asks for over the given datasets
    (``datasets`` builds them): the model on ``device`` (the card by
    default), initialised from ``args.seed`` (or from ``weights``, a state
    dict of the mode's model, loaded strictly), trained, checkpointed into
    ``--output_dir``; returns the statistics (pretrain: the last step's
    loss; finetune: the validation top-1s)."""
    from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    from tim_tpu_torch.models.tim import resolve_device
    from tim_tpu_torch.runner.backbone import (
        BackboneFinetuneRunner, BackbonePretrainRunner, TwoHeadViT)

    if (args.flash_attention == "off"
            and torch.device(device or "cuda").type == "cuda"):
        raise ValueError(
            "--flash_attention off: the ViT's attention on the card is "
            "kernel 5 (csrc/flash_mha.cu) and the card has no other route; "
            "pass auto or on (off is the CPU's plain attention)")
    if args.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"--compute_dtype {args.compute_dtype}: bfloat16 "
                         f"or float32")
    device = resolve_device(device)
    remat_mlp = (args.mode == "pretrain" if args.remat_mlp == "auto"
                 else args.remat_mlp == "on")
    vit_kw = dict(
        img_size=args.input_size, patch_size=args.patch_size,
        embed_dim=args.embed_dim, depth=args.depth,
        num_heads=args.num_heads, num_frames=args.num_frames,
        tubelet_size=args.tubelet_size, dtype=args.compute_dtype,
        device=device, generator=torch.Generator().manual_seed(args.seed),
        remat=args.remat, remat_mlp=remat_mlp)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    if args.mode == "pretrain":
        model = PretrainVideoMAE(**vit_kw)
        if weights is not None:
            model.load_state_dict(weights, strict=True)
        runner = BackbonePretrainRunner(
            model, train_ds, mask_ratio=args.mask_ratio,
            batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
            weight_decay=args.weight_decay, seed=args.seed,
            output_dir=str(out))
        stats = runner.fit()
        ckpt.save_checkpoint(str(out), runner.state, epoch=args.epochs)
        print(stats)
        return stats

    model = TwoHeadViT(VideoMAEViT(**vit_kw), num_verbs=args.num_verbs,
                       num_nouns=args.num_nouns,
                       generator=torch.Generator().manual_seed(args.seed))
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    runner = BackboneFinetuneRunner(
        model, train_ds, val_ds, batch_size=args.batch_size,
        epochs=args.epochs, lr=args.lr, layer_decay=args.layer_decay,
        weight_decay=args.weight_decay, mixup_alpha=args.mixup,
        smoothing=args.smoothing, warmup_epochs=args.warmup_epochs,
        seed=args.seed, output_dir=str(out))
    pre = None
    if args.pretrained:
        pre, missing = load_pretrained_encoder(args.pretrained, model.trunk)
        total = len(model.trunk.state_dict())
        runner.logger.info(
            "--pretrained %s: %d of %d trunk entries loaded, %d missing %s",
            args.pretrained, total - len(missing), total, len(missing),
            missing)
    runner.init_state(pretrained_encoder=pre)
    runner.fit()
    stats = runner.validate()
    ckpt.save_checkpoint(str(out), runner.state, epoch=args.epochs)
    print(stats)
    return stats


def main(argv=None, *, device=None):
    """Parse, read the CSVs (``read_csv``) and the JPEG frames
    (``jpeg_frame_reader``), run."""
    from tim_tpu_torch.data.table import read_csv
    from tim_tpu_torch.extract.clips import jpeg_frame_reader
    from tim_tpu_torch.models.tim import resolve_device
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    anno_train = read_csv(args.anno_train)
    anno_val = read_csv(args.anno_val) if args.anno_val else None
    reader = jpeg_frame_reader(args.data_path, args.filename_tmpl)
    train_ds, val_ds = datasets(args, anno_train, anno_val, reader)
    return run(args, train_ds, val_ds, device=device)


if __name__ == "__main__":
    main()
