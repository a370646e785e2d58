"""The port's backbone finetune / pretraining CLI
(``tim_tpu_torch/extract/finetune_cli.py``) on the CPU, on JPEG frames
written by cv2 and annotation CSVs written by pandas (tiny ViT, fp32):

- as ``tests/test_finetune_cli.py``: both modes run one epoch and write
  ``checkpoint.pt``; pretraining samples its clips ``mode="train"``;
- the parser equals JAX's (flags, defaults, choices);
- parity: both CLIs start from JAX's initial weights (handed to the port's
  ``run``), mixup off, the same RandAugment and erasing draws: the
  finetune loss within rtol 1e-4 with verb and noun top-1 equal, the
  pretrain loss within rtol 1e-4;
- the chain from ``--mode pretrain`` to ``--pretrained``: every encoder
  entry of the trunk loads (only ``fc_norm``, which the MAE lacks, keeps
  its init);
- the errors: ``--flash_attention off`` on the card (a JAX msgpack
  checkpoint is read: ``tests/test_torch_jax_checkpoint.py``); with PIL
  blocked ``datasets`` builds ``--mode finetune`` whose RandAugment gives
  JAX's frames; without pandas, cv2 and PIL ``main --mode pretrain``
  reads the CSVs and decodes the frames itself and runs.
"""

import functools
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")
cv2 = pytest.importorskip("cv2")

from tests.torch_port_helpers import perturbed  # noqa: E402
from tim_tpu.extract import finetune_cli as jcli  # noqa: E402
from tim_tpu.runner import backbone as jrunner  # noqa: E402
from tim_tpu_torch.convert import (  # noqa: E402
    mae_state_dict_from_jax, two_head_state_dict_from_jax)
from tim_tpu_torch.extract import autoaug as pautoaug  # noqa: E402
from tim_tpu_torch.extract import clips as pclips  # noqa: E402
from tim_tpu_torch.extract import finetune_cli as pcli  # noqa: E402
from tim_tpu_torch.models.backbones.vit import VideoMAEViT  # noqa: E402
from tim_tpu_torch.runner import backbone as prunner  # noqa: E402

RTOL = 1e-4
TINY = ["--input_size", "32", "--patch_size", "8", "--embed_dim", "16",
        "--depth", "1", "--num_heads", "2", "--num_frames", "4",
        "--tubelet_size", "2", "--num_verbs", "2", "--num_nouns", "2",
        "--epochs", "1", "--warmup_epochs", "0", "--batch_size", "2",
        "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def clip_data(tmp_path_factory):
    """60 JPEG frames of one video and a CSV of 4 segments (the JAX
    test's data)."""
    tmp_path = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    d = tmp_path / "frames" / "v1"
    d.mkdir(parents=True)
    for i in range(1, 61):
        cv2.imwrite(str(d / f"img_{i:05d}.jpg"),
                    rng.integers(0, 255, (48, 64, 3), np.uint8))
    ann = pd.DataFrame({
        "video_id": ["v1", "v1", "v1", "v1"],
        "start_frame": [0, 10, 20, 30],
        "stop_frame": [25, 40, 50, 58],
        "verb_class": [0, 1, 0, 1],
        "noun_class": [1, 0, 1, 0],
    })
    csv = tmp_path / "train.csv"
    ann.to_csv(csv, index=False)
    return tmp_path, csv


@pytest.fixture(autouse=True)
def small_mae(monkeypatch):
    """Both packages' ``PretrainVideoMAE`` with a one-block 32-wide decoder
    (the CLIs build the 512 x 12 default, which the tiny encoder does not
    need)."""
    from tim_tpu.models.backbones import mae as jmae
    from tim_tpu_torch.models.backbones import mae as pmae
    for mod in (jmae, pmae):
        monkeypatch.setattr(mod, "PretrainVideoMAE", functools.partial(
            mod.PretrainVideoMAE, decoder_dim=32, decoder_depth=1,
            decoder_heads=1))


def _argv(clip_data, mode, out, *extra):
    tmp_path, csv = clip_data
    return ["--mode", mode, "--anno_train", str(csv), "--data_path",
            str(tmp_path / "frames"), "--output_dir", str(out), *TINY,
            *extra]


def test_pretrain_mode_runs_and_samples_randomly(clip_data, monkeypatch,
                                                 tmp_path):
    seen_modes = []
    orig = pclips.EK100ClipDataset.__init__

    def spy(self, *a, **kw):
        seen_modes.append(kw.get("mode", "train"))
        return orig(self, *a, **kw)

    monkeypatch.setattr(pclips.EK100ClipDataset, "__init__", spy)
    stats = pcli.main(_argv(clip_data, "pretrain", tmp_path / "pre",
                            "--mask_ratio", "0.75"), device="cpu")
    assert np.isfinite(stats["loss"])
    assert seen_modes == ["train"]
    payload = torch.load(tmp_path / "pre" / "checkpoint.pt",
                         weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 2


def test_finetune_mode_runs(clip_data, tmp_path):
    stats = pcli.main(_argv(clip_data, "finetune", tmp_path / "ft",
                            "--num_sample", "1"), device="cpu")
    assert sorted(stats) == ["noun_top1", "verb_top1"]
    assert os.path.exists(tmp_path / "ft" / "checkpoint.pt")


def test_parser_equals_jax():
    def flags(parser):
        return sorted((a.dest, a.default, tuple(a.choices or ()), a.required,
                       a.type) for a in parser._actions)
    assert flags(pcli.build_parser()) == flags(jcli.build_parser())


def _capture(monkeypatch, module, cls, method, store):
    """Wrap ``module.cls.method`` to keep its return value and the
    runner's step count after it."""
    target = getattr(module, cls)
    orig = getattr(target, method)

    def wrapped(self, *a, **kw):
        out = orig(self, *a, **kw)
        store[method] = (out, getattr(self.state, "step", None))
        return out

    monkeypatch.setattr(target, method, wrapped)


def _perturb_jax_init(monkeypatch, cls, store):
    """JAX's ``cls.init_state`` followed by seeded noise on every
    parameter (as ``tests/test_torch_train.py`` replaces the runner's
    parameters: no LayerNorm or head at its trivial init, where Adam's
    update of a gradient within rounding of zero is ill-conditioned);
    ``store["weights"]``: those parameters."""
    target = getattr(jrunner, cls)
    orig = target.init_state

    def wrapped(self, *a, **kw):
        out = orig(self, *a, **kw)
        params = perturbed({"params": self.state.params}, 0)["params"]
        store["weights"] = {"params": params}
        self.state = self.state.replace(params=jax.tree_util.tree_map(
            jnp.asarray, params))
        return out

    monkeypatch.setattr(target, "init_state", wrapped)


@pytest.mark.parametrize("mode", ["finetune", "pretrain"])
def test_both_clis_train_alike_from_one_weight_set(clip_data, monkeypatch,
                                                   tmp_path, mode):
    extra = (["--mixup", "0", "--num_sample", "2", "--reprob", "0.5"]
             if mode == "finetune" else ["--mask_ratio", "0.5"])
    cls = ("BackboneFinetuneRunner" if mode == "finetune"
           else "BackbonePretrainRunner")
    jax_seen, port_seen = {}, {}
    _perturb_jax_init(monkeypatch, cls, jax_seen)
    _capture(monkeypatch, jrunner, cls, "fit", jax_seen)
    _capture(monkeypatch, prunner, cls, "fit", port_seen)
    np.random.seed(3)               # VideoRandAugment's global draws
    random.seed(3)
    want = jcli.main(_argv(clip_data, mode, tmp_path / "jax", *extra))
    variables = jax_seen["weights"]
    weights = (two_head_state_dict_from_jax(variables) if mode == "finetune"
               else mae_state_dict_from_jax(variables))

    args = pcli.build_parser().parse_args(
        _argv(clip_data, mode, tmp_path / "port", *extra))
    tmp, csv = clip_data
    train_ds, val_ds = pcli.datasets(
        args, pd.read_csv(csv), None,
        pclips.jpeg_frame_reader(str(tmp / "frames")))
    np.random.seed(3)
    random.seed(3)
    # JAX's init_state draws train_ds[0] to shape its parameters
    # (tim_tpu/runner/backbone.py:165, :253), which takes a clip's
    # augmentation draws; the port's parameters need no example, so the
    # same draw is taken here and both runs then train on the same clips
    train_ds[0]
    got = pcli.run(args, train_ds, val_ds, device="cpu", weights=weights)
    assert sorted(got) == sorted(want)
    jfit, pfit = jax_seen["fit"][0], port_seen["fit"][0]
    np.testing.assert_allclose(pfit["loss"], jfit["loss"], rtol=RTOL)
    if mode == "finetune":
        assert got == {k: float(v) for k, v in want.items()}
    assert port_seen["fit"][1] == 2


def test_pretrain_checkpoint_warm_starts_every_encoder_entry(clip_data,
                                                             tmp_path):
    pcli.main(_argv(clip_data, "pretrain", tmp_path / "pre"), device="cpu")
    path = str(tmp_path / "pre" / "checkpoint.pt")
    trunk = VideoMAEViT(img_size=32, patch_size=8, embed_dim=16, depth=1,
                        num_heads=2, num_frames=4, tubelet_size=2,
                        device="cpu")
    params, missing = pcli.load_pretrained_encoder(path, trunk)
    assert missing == ["fc_norm.weight", "fc_norm.bias"]
    blocks = [k for k in trunk.state_dict() if k.startswith("blocks.")]
    assert blocks and all(k in params for k in blocks)
    stats = pcli.main(_argv(clip_data, "finetune", tmp_path / "ft",
                            "--num_sample", "1", "--pretrained", path),
                      device="cpu")
    assert sorted(stats) == ["noun_top1", "verb_top1"]


def test_the_cli_names_what_it_cannot_do(clip_data, monkeypatch, tmp_path):
    args = pcli.build_parser().parse_args(
        _argv(clip_data, "finetune", tmp_path, "--flash_attention", "off"))
    with pytest.raises(ValueError, match="kernel 5"):
        pcli.run(args, None, None)                 # the card
    # --mode finetune builds with PIL blocked: the recipe's
    # VideoRandAugment over the port's own Pillow ops gives JAX's
    # augmented frames (bit for bit) under the same seeds, and so JAX's
    # training clips (within the resize's 1e-5, tests/test_torch_clips.py)
    from tim_tpu.extract import clips as jclips
    tmp, csv = clip_data
    anno = pd.read_csv(csv)
    jtrain = jclips.EK100ClipDataset(
        anno, jclips.jpeg_frame_reader(str(tmp / "frames")), mode="train",
        num_sample=args.num_sample, reprob=args.reprob,
        num_frames=args.num_frames, crop_size=args.input_size)

    def recorded(ds, store):
        augment = ds.rand_augment
        ds.rand_augment = lambda frames: store.append(augment(frames)) or \
            store[-1]

    jframes, pframes = [], []
    recorded(jtrain, jframes)
    random.seed(4)
    np.random.seed(4)
    want = [jtrain[i] for i in range(2)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    train_ds, _ = pcli.datasets(
        args, anno, None, pclips.jpeg_frame_reader(str(tmp / "frames")))
    assert isinstance(train_ds.rand_augment, pautoaug.VideoRandAugment)
    recorded(train_ds, pframes)
    random.seed(4)
    np.random.seed(4)
    got = [train_ds[i] for i in range(2)]
    assert len(pframes) == len(jframes) == 2 * args.num_sample
    for g, w in zip(pframes, jframes):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "video":
                assert g[k].shape == w[k].shape
                assert np.abs(g[k] - w[k]).max() <= 1e-5 * np.abs(w[k]).max()
            else:
                np.testing.assert_array_equal(g[k], w[k])
    # without pandas, cv2 and PIL (blocked above) the CSVs are read
    # (data.table.read_csv) and the frames decoded by the port
    # (utils.jpeg): --mode pretrain runs
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    stats = pcli.main(_argv(clip_data, "pretrain", tmp_path), device="cpu")
    assert np.isfinite(stats["loss"])
    with pytest.raises(FileNotFoundError):
        pcli.main(_argv(clip_data, "pretrain", tmp_path) + [
            "--anno_train", str(tmp_path / "missing.csv")], device="cpu")
