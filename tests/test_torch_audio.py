"""Auditory SlowFast and the audio half of extraction, the port against the
JAX package on the CPU, fp32, at ``tests/test_backbones.py``'s small size
(R50 depths, width 8, alpha 4, beta_inv 4, 5 classes), with BatchNorm
statistics and affines drawn from a seed so that eval-mode BN matters:

- ``AuditorySlowFast``: features and softmaxed logits within 1e-4 of the
  largest, the JAX model's weights from ``slowfast.params_from_torch`` of
  the port's state dict; training mode (batch statistics, dropout, raw
  logits) differs from eval as the JAX model's does;
- ``pack_pathways`` picks JAX's time indices;
- ``convert.slowfast_state_dict_from_jax`` inverts ``params_from_torch``
  key for key and loads strictly;
- the numpy copies ``extract/{audio,spec_warp,augment}.py`` equal the
  originals on seeded inputs (``spec_warp`` pinned to
  ``tim_tpu/extract/spec_warp.py`` itself);
- both extraction CLIs (``--backbone slowfast``) on one WAV, table and
  torch checkpoint: banks within 1e-4 of the largest feature, the
  SpecAugment set too when both draw from one seed of ``random``.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu.extract import audio as jaudio
from tim_tpu.extract import augment as jaug
from tim_tpu.extract import cli as jcli
from tim_tpu.extract import spec_warp as jwarp
from tim_tpu.extract.tables import build_feature_time_table
from tim_tpu.models.backbones import slowfast as jsf
from tim_tpu_torch.convert import slowfast_state_dict_from_jax
from tim_tpu_torch.extract import audio as paudio
from tim_tpu_torch.extract import augment as paug
from tim_tpu_torch.extract import cli as pcli
from tim_tpu_torch.extract import spec_warp as pwarp
from tim_tpu_torch.models.backbones import slowfast as psf

SMALL = dict(num_classes=5, width=8, alpha=4, beta_inv=4)
TOL = 1e-4      # of the largest feature / logit


def _small_port_model(seed=0, dropout_rate=0.0):
    """The port's small SlowFast on the CPU, its BatchNorm statistics and
    affines moved off their init by a seeded generator."""
    model = psf.AuditorySlowFast(**SMALL, dropout_rate=dropout_rate,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model


@pytest.fixture(scope="module")
def models():
    """(port model, its state dict, the JAX model and variables)."""
    model = _small_port_model()
    sd = model.state_dict()
    return (model, sd, jsf.AuditorySlowFast(**SMALL, dropout_rate=0.0),
            jsf.params_from_torch(sd))


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (name, err, np.abs(want).max())


def test_slowfast_matches_jax(models):
    model, _, jmodel, variables = models
    spec = np.random.default_rng(0).normal(size=(2, 1, 32, 64)).astype(
        np.float32)
    logits, feats = model(*psf.pack_pathways(torch.from_numpy(spec), 4))
    jslow, jfast = jsf.pack_pathways(jnp.asarray(spec.transpose(0, 2, 3, 1)),
                                     4)
    jlogits, jfeats = jmodel.apply(variables, jslow, jfast, train=False)
    assert feats.shape == (2, model.num_features) == (2, 8 * 32 + 8 * 32 // 4)
    _close(feats, jfeats, "feature")
    _close(logits, jlogits, "logits")
    np.testing.assert_allclose(logits.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_training_mode_uses_batch_statistics_dropout_and_raw_logits():
    model = _small_port_model(dropout_rate=0.5)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 1, 32, 64)).astype(np.float32))
    _, eval_feats = model(*psf.pack_pathways(x, 4))
    stem_bn = model.s1.pathway0_stem.bn
    mean = stem_bn.running_mean.clone()
    model.train()
    logits, feats = model(*psf.pack_pathways(x, 4))
    assert feats.requires_grad
    assert not torch.allclose(logits.sum(-1), torch.ones(2))
    assert (feats == 0).float().mean() > 0.3          # dropout on
    assert not torch.allclose(feats, eval_feats)
    # batch statistics, and the running ones updated (flax's mutable
    # batch_stats with momentum 0.9 = torch's 0.1)
    assert stem_bn.momentum == 0.1
    assert not torch.equal(stem_bn.running_mean, mean)


@pytest.mark.parametrize("t,alpha", [(16, 4), (32, 4), (50, 4), (200, 4),
                                     (201, 8), (7, 2)])
def test_pack_pathways_matches_jax(t, alpha):
    x = np.arange(2 * t * 3, dtype=np.float32).reshape(2, 1, t, 3)
    slow, fast = psf.pack_pathways(torch.from_numpy(x), alpha)
    jslow, jfast = jsf.pack_pathways(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                     alpha)
    np.testing.assert_array_equal(slow.numpy(),
                                  np.asarray(jslow).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(fast.numpy(), x)


def test_converter_inverts_params_from_torch_key_for_key(models):
    _, sd, _, variables = models
    back = slowfast_state_dict_from_jax(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(back[k]) == 0, k
        else:
            torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    fresh = psf.AuditorySlowFast(**SMALL, device="cpu")
    fresh.load_state_dict(back, strict=True)


def test_audio_copy_equals_jax():
    rng = np.random.default_rng(0)
    wave = rng.normal(size=30000).astype(np.float32)
    for sr in (24000, 16000):
        np.testing.assert_array_equal(paudio.mel_filterbank(sr),
                                      jaudio.mel_filterbank(sr))
    np.testing.assert_array_equal(paudio.log_mel_spectrogram(wave),
                                  jaudio.log_mel_spectrogram(wave))
    for start, end in ((0, 23975), (1000, 9000), (5, 30000)):
        np.testing.assert_array_equal(
            paudio.extract_clip_spectrogram(wave, start, end),
            jaudio.extract_clip_spectrogram(wave, start, end))
    for args in ((0, 40000, 23976, 0, 1), (100, 90000, 23976, 1, 3),
                 (10, 20000, 23976, 0, 2), (0, 50000, 23976, 2, 3)):
        assert (paudio.record_clip_bounds(*args)
                == jaudio.record_clip_bounds(*args))
    assert (paudio.uniform_clip_indices(
        50000, 23976, -1, 1, 7, rng=np.random.default_rng(3))
        == jaudio.uniform_clip_indices(
        50000, 23976, -1, 1, 7, rng=np.random.default_rng(3)))


def test_spec_warp_copy_equals_jax():
    spec = np.random.default_rng(1).normal(size=(128, 200)).astype(
        np.float32)
    for seed in (0, 1, 2):
        np.testing.assert_array_equal(
            pwarp.time_warp_exact(spec, rng=np.random.default_rng(seed)),
            jwarp.time_warp_exact(spec, rng=np.random.default_rng(seed)))
    src = np.asarray([[64.0, 90.0], [10.0, 20.0]], np.float32)
    dst = src + np.asarray([[0.0, 3.0], [1.0, -2.0]], np.float32)
    for got, want in zip(
            pwarp.sparse_image_warp(spec, src, dst,
                                    rng=np.random.default_rng(4)),
            jwarp.sparse_image_warp(spec, src, dst,
                                    rng=np.random.default_rng(4))):
        np.testing.assert_array_equal(got, want)


def test_augment_copy_equals_jax():
    spec = np.random.default_rng(2).normal(size=(200, 128)).astype(
        np.float32)
    for exact in (True, False):
        np.testing.assert_array_equal(
            paug.spec_augment(spec, rng=random.Random(5), exact_warp=exact),
            jaug.spec_augment(spec, rng=random.Random(5), exact_warp=exact))
    frames = np.random.default_rng(3).integers(
        0, 255, (3, 16, 16, 3)).astype(np.uint8)
    for per_frame in (False, True):
        np.testing.assert_array_equal(
            paug.random_erasing(frames, probability=1.0, per_frame=per_frame,
                                rng=random.Random(6)),
            jaug.random_erasing(frames, probability=1.0, per_frame=per_frame,
                                rng=random.Random(6)))
    outs = []
    for mod in (paug, jaug):
        random.seed(7)
        outs.append(mod.RandAugment(magnitude=9, num_ops=3)(frames))
    np.testing.assert_array_equal(*outs)
    assert paug.RAND_AUGMENT_OPS == jaug.RAND_AUGMENT_OPS


def test_audio_extraction_cli_matches_jax(models, tmp_path, monkeypatch):
    """One 4 s WAV, 11 records of 1.1 s every 0.2 s, ``--num_aug 2``, the
    small model through both CLIs from one torch checkpoint: the clean
    set's bank within 1e-4 of the largest feature, and the SpecAugment set
    too when both CLIs draw from ``random`` seeded alike."""
    from scipy.io import wavfile
    _, sd, _, _ = models
    sr = 24000
    wave = np.random.default_rng(5).normal(scale=0.2, size=4 * sr)
    wavfile.write(tmp_path / "v1.wav", sr,
                  np.clip(wave * 32767, -32768, 32767).astype(np.int16))
    build_feature_time_table({"v1": 4.0}, interval=1.1, hop=0.2,
                             fps=50.0).to_pickle(tmp_path / "ctx.pkl")
    torch.save({"model_state": sd}, tmp_path / "asf.pyth")
    monkeypatch.setattr(jsf, "AuditorySlowFast",
                        functools.partial(jsf.AuditorySlowFast, **SMALL))
    monkeypatch.setattr(psf, "AuditorySlowFast",
                        functools.partial(psf.AuditorySlowFast, **SMALL))
    banks = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("port", pcli.main, {"device": "cpu"})):
        random.seed(0)
        main(["--backbone", "slowfast", "--audio_dir", str(tmp_path),
              "--feature_times", str(tmp_path / "ctx.pkl"),
              "--checkpoint", str(tmp_path / "asf.pyth"),
              "--out_dir", str(tmp_path / name), "--split", "val",
              "--num_aug", "2", "--batch_size", "8"], **kw)
        banks[name] = np.load(tmp_path / name / "val" / "v1.npy")
    got, want = banks["port"], banks["jax"]
    assert got.shape == want.shape == (len(want), 2, 320)
    assert len(want) == 15
    _close(got[:, 0], want[:, 0], "clean set")
    _close(got[:, 1], want[:, 1], "SpecAugment set")
    assert not np.allclose(got[:, 0], got[:, 1])


def test_audio_apply_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    args = pcli.build_parser().parse_args(
        ["--backbone", "slowfast", "--feature_times", "x", "--out_dir", "y"])
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.make_audio_apply(args)
    with pytest.raises(RuntimeError, match="cuda"):
        psf.AuditorySlowFast()
    with pytest.raises(ValueError, match="make_visual_apply"):
        pcli.make_audio_apply(pcli.build_parser().parse_args(
            ["--backbone", "videomae", "--feature_times", "x",
             "--out_dir", "y"]), device="cpu")
    with pytest.raises(ValueError, match="make_audio_apply"):
        pcli.make_visual_apply(args, device="cpu")


def test_a_wav_at_another_rate_is_refused(tmp_path, monkeypatch):
    from scipy.io import wavfile
    wavfile.write(tmp_path / "v1.wav", 16000, np.zeros(32000, np.int16))
    build_feature_time_table({"v1": 2.0}, interval=1.1, hop=0.2,
                             fps=50.0).to_pickle(tmp_path / "ctx.pkl")
    monkeypatch.setattr(psf, "AuditorySlowFast",
                        functools.partial(psf.AuditorySlowFast, **SMALL))
    with pytest.raises(ValueError, match="sampling rate 16000"):
        pcli.main(["--backbone", "slowfast", "--audio_dir", str(tmp_path),
                   "--feature_times", str(tmp_path / "ctx.pkl"),
                   "--out_dir", str(tmp_path / "out")], device="cpu")
