"""The port's visual extraction against the JAX package on the CPU: the
two CLIs on a tiny synthetic frames dir with the same weights give equal
banks (fp32); the port's copies of the pipeline helpers and transforms
equal the originals; what is not ported raises."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu.extract import cli as jcli
from tim_tpu.extract import pipeline as jpipe
from tim_tpu.extract.tables import build_feature_time_table
from tim_tpu.models.backbones import swin3d as jswin
from tim_tpu.models.backbones import vit as jvit
from tim_tpu_torch.convert import swin_state_dict_from_jax, vit_state_dict_from_jax
from tim_tpu_torch.extract import cli as pcli
from tim_tpu_torch.extract import pipeline as ppipe
from tim_tpu_torch.models.backbones import swin3d as pswin
from tim_tpu_torch.models.backbones import vit as pvit

SWIN = dict(patch_size=(2, 4, 4), embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=(8, 3, 3))
VIT = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4,
           num_frames=4, tubelet_size=2)


def _write_frames(tmp, vid, n, size=64, seed=0):
    from PIL import Image
    d = tmp / "frames" / vid
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                     dtype=np.uint8)).save(
            d / f"frame_{i:010d}.jpg")


@pytest.mark.parametrize("backbone,num_frames", [("omnivore", 8),
                                                 ("videomae", 4)])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, backbone, num_frames):
    """Both CLIs extract the same two videos with the same (tiny) backbone
    weights: the JAX CLI's own init, handed to the port as a reference
    checkpoint through the state-dict converter."""
    _write_frames(tmp_path, "v1", 30, seed=0)
    _write_frames(tmp_path, "v2", 24, seed=1)
    build_feature_time_table({"v1": 1.6, "v2": 1.3}, interval=1.1, hop=0.3,
                             fps=25.0).to_pickle(tmp_path / "ctx.pkl")
    if backbone == "omnivore":
        jmodel = jswin.SwinTransformer3D(**SWIN)
        monkeypatch.setattr(jswin, "omnivore_swinB_epic",
                            lambda dtype="float32", use_flash=False,
                            quantized=False: jmodel)
        monkeypatch.setattr(
            pswin, "omnivore_swinB_epic",
            lambda dtype="float32", device=None, generator=None:
            pswin.SwinTransformer3D(**SWIN, dtype=dtype, device=device,
                                    generator=generator))
    else:
        jmodel = jvit.VideoMAEViT(**VIT)
        monkeypatch.setattr(jvit, "videomae_vit_large",
                            lambda dtype="float32", use_flash=False,
                            quantized=False: jmodel)
        monkeypatch.setattr(
            pvit, "videomae_vit_large",
            lambda dtype="float32", device=None, generator=None:
            pvit.VideoMAEViT(**VIT, dtype=dtype, device=device,
                             generator=generator))
    # the JAX CLI's init without a checkpoint
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, num_frames, 32, 32, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = (swin_state_dict_from_jax(variables, SWIN["depths"])
          if backbone == "omnivore"
          else vit_state_dict_from_jax(variables, VIT["depth"]))
    torch.save({"model": sd}, tmp_path / "ckpt.pt")

    common = ["--backbone", backbone, "--frames_dir", str(tmp_path / "frames"),
              "--feature_times", str(tmp_path / "ctx.pkl"), "--split", "val",
              "--batch_size", "3", "--num_frames", str(num_frames),
              "--crop_size", "32", "--compute_dtype", "float32"]
    jcli.main(common + ["--out_dir", str(tmp_path / "jax")])
    pcli.main(common + ["--out_dir", str(tmp_path / "port"),
                        "--checkpoint", str(tmp_path / "ckpt.pt")],
              device="cpu")
    for vid in ("v1", "v2"):
        want = np.load(tmp_path / "jax" / "val" / f"{vid}.npy")
        got = np.load(tmp_path / "port" / "val" / f"{vid}.npy")
        assert got.shape == want.shape and got.shape[1] == 1
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_parser_has_the_jax_flags():
    def flags(parser):
        return sorted((a.dest, a.default, tuple(a.choices or ()))
                      for a in parser._actions)
    assert flags(pcli.build_parser()) == flags(jcli.build_parser())


@pytest.mark.parametrize("argv,error,match", [
    (["--backbone", "slowfast", "--quantize_backbone", "on"],
     NotImplementedError, "int8"),
    (["--backbone", "videomae", "--quantize_backbone", "on"],
     NotImplementedError, "int8"),
    (["--backbone", "omnivore", "--num_aug", "2"], NotImplementedError,
     "RandAugment"),
])
def test_unported_options_raise(argv, error, match):
    args = pcli.build_parser().parse_args(
        argv + ["--feature_times", "x", "--out_dir", "y"])
    make = (pcli.make_audio_apply if args.backbone == "slowfast"
            else pcli.make_visual_apply)
    with pytest.raises(error, match=match):
        make(args, device="cpu")


def test_flash_off_is_refused_on_the_card_only():
    args = pcli.build_parser().parse_args(
        ["--backbone", "videomae", "--flash_attention", "off",
         "--quantize_backbone", "auto", "--feature_times", "x",
         "--out_dir", "y"])
    with pytest.raises(ValueError, match="flash_attention off"):
        pcli.check_supported(args, torch.device("cuda"))
    pcli.check_supported(args, torch.device("cpu"))   # plain versions


@pytest.mark.parametrize("n,batch,aug", [(7, 3, 1), (4, 8, 2), (6, 2, 3)])
def test_extract_features_for_video_equals_jax(n, batch, aug):
    rng = np.random.default_rng(n)
    clips = rng.normal(size=(n, aug, 4, 5)).astype(np.float32)
    calls = []

    def jax_apply(x):
        calls.append(x.shape[0])
        return x.sum(axis=1) * 2.0

    def port_apply(x):
        return x.sum(dim=1) * 2.0

    want = jpipe.extract_features_for_video(
        lambda t, a: clips[t, a], n, aug, jax_apply, batch_size=batch)
    got = ppipe.extract_features_for_video(
        lambda t, a: clips[t, a], n, aug, port_apply, batch_size=batch)
    assert set(calls) == {batch}   # the ragged last batch is padded
    np.testing.assert_array_equal(got, want)


def test_bank_save_and_merge_equal_jax(tmp_path):
    banks = {(name, vid): np.random.default_rng(i).normal(size=(5, 1, dim))
             for i, (name, dim, vid) in enumerate(
                 (n, d, v) for n, d in (("a", 6), ("b", 4))
                 for v in ("v1", "v2"))}
    for pkg, root in ((jpipe, "jax"), (ppipe, "port")):
        for (name, vid), bank in banks.items():
            pkg.save_feature_bank(str(tmp_path / root / name), "train", vid,
                                  bank)
        assert pkg.merge_feature_dirs(
            str(tmp_path / root / "a"), str(tmp_path / root / "b"),
            str(tmp_path / root / "m"), expected_dim=None) == 2
    for vid in ("v1", "v2"):
        got = np.load(tmp_path / "port" / "m" / "train" / f"{vid}.npy")
        want = np.load(tmp_path / "jax" / "m" / "train" / f"{vid}.npy")
        assert got.shape == (5, 1, 10)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num,start,total,samples", [
    (55, 1, 300, 32), (20, 100, 110, 16), (3, 7, 9, 8)])
def test_frame_indices_equal_jax(num, start, total, samples):
    np.testing.assert_array_equal(
        ppipe.omnivore_frame_indices(num, start, total, samples),
        jpipe.omnivore_frame_indices(num, start, total, samples))
    np.testing.assert_array_equal(
        ppipe.sample_clip_frames(total, start, start + num, samples, 2),
        jpipe.sample_clip_frames(total, start, start + num, samples, 2))


@pytest.mark.parametrize("shape", [(3, 48, 64, 3), (2, 70, 40, 3)])
def test_transforms_equal_jax(shape):
    frames = np.random.default_rng(shape[1]).integers(
        0, 255, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        ppipe.preprocess_video_clip(frames, size=32),
        jpipe.preprocess_video_clip(frames, size=32))
    for spatial_idx in (0, 1, 2):
        for bgr in (True, False):
            np.testing.assert_array_equal(
                ppipe.omnivore_test_transform(frames, size=32,
                                              input_bgr=bgr,
                                              spatial_idx=spatial_idx),
                jpipe.omnivore_test_transform(frames, size=32,
                                              input_bgr=bgr,
                                              spatial_idx=spatial_idx))
    np.testing.assert_array_equal(ppipe.OMNIVORE_MEAN, jpipe.OMNIVORE_MEAN)
    np.testing.assert_array_equal(ppipe.OMNIVORE_STD, jpipe.OMNIVORE_STD)
