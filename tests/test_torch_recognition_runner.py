"""The port's ``RecognitionRunner`` against the JAX package's on the CPU,
fp32, at small sizes, on the same synthetic split and weights:

- the recognition windows and examples of the port's data copies equal
  JAX's;
- ``validate`` (host and banked paths): every statistic within 1e-5
  relative; the banked vote sums within 1e-9 of the host path's and
  bit-equal between two runs;
- ``fit`` on the host and the banked path (mixup, drloc and dropout off,
  so that neither package draws; one augmentation set): the
  validation statistics within 1e-5, every parameter within 1e-4 of its
  largest value;
- ``extract_predictions``: the same narration ids, scores within 1e-5;
- a checkpoint resume continues bit-equal to an uninterrupted run, and
  the runner defaults to the card.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from tests.test_torch_train import assert_state_close
from tests.torch_port_helpers import jax_frames, port_train_cfg
from tim_tpu import config as C
from tim_tpu.data import dataset as jds
from tim_tpu.data import windows as jwin
from tim_tpu.runner import RecognitionRunner as JaxRecognitionRunner
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import recognition_state_dict_from_jax
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import synthetic as psyn
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.evals.meters import WindowVoteAccumulator
from tim_tpu_torch.runner.recognition import RecognitionRunner, _head_spec

NUM_FEATS = 8


@functools.lru_cache(maxsize=None)
def rec_bundle(num_aug: int = 1):
    """(synthetic bundle, recognition WindowSet): 2 videos, features of
    ``num_aug`` augmentation sets (the port's copy of the JAX builders)."""
    b = psyn.synthetic_epic(seed=7, num_videos=2, video_seconds=40.0,
                            per_video=8, visual_dim=24, audio_dim=16,
                            visual_classes=(5, 6, 11), audio_classes=7)
    for m in ("v", "a"):
        b[f"{m}_feats"] = {k: np.ascontiguousarray(v[:, :num_aug])
                           for k, v in b[f"{m}_feats"].items()}
    return b, _windows(pwin, b)


def _windows(mod, b):
    if mod is jwin:
        b = jax_frames(b)
    return mod.build_recognition_windows(
        mod.normalize_actions(b["v_actions"], "visual"),
        mod.normalize_actions(b["a_actions"], "audio"),
        b["video_info"], b["v_feat_times"], num_feats=NUM_FEATS,
        feat_stride=2, feat_gap=0.2)


def _datasets(mod, b, ws):
    stores = (mod.FeatureStore(b["v_feats"], b["v_feat_times"]),
              mod.FeatureStore(b["a_feats"], b["a_feat_times"]))
    return (mod.RecognitionDataset(ws, *stores),
            mod.RecognitionDataset(ws, *stores, sample_augmentations=False))


def _cfg(**kw):
    base = dict(visual_classes=(5, 6, 11), audio_classes=7,
                visual_input_dim=24, audio_input_dim=16, d_model=16,
                nhead=2, num_layers=1, num_feats=NUM_FEATS,
                compute_dtype="float32", enc_dropout=0.0, feat_dropout=0.0,
                seq_dropout=0.0)
    base.update(kw)
    return C.ModelConfig(**base)


def _tcfg(**kw):
    base = dict(batch_size=8, epochs=1, warmup_epochs=0, lr=1e-3,
                mixup_alpha=0.0, lambda_drloc=0.0, seed=0)
    base.update(kw)
    return C.TrainConfig(**base)


def _pcfg(cfg):
    return PC.ModelConfig(**dataclasses.asdict(cfg))


def _pair(banked, cfg=None, tcfg=None, num_aug=1):
    """(JAX runner, port runner) over the same split, with the port's
    random initial weights loaded into both."""
    cfg, tcfg = cfg or _cfg(), tcfg or _tcfg()
    b, ws = rec_bundle(num_aug)
    jtrain, jval = _datasets(jds, b, _windows(jwin, b))
    ptrain, pval = _datasets(pds, b, ws)
    jrun = JaxRecognitionRunner(cfg, tcfg, jtrain, jval,
                                mesh_cfg=C.MeshConfig(data=1),
                                dataset_name="epic", print_freq=1,
                                use_device_bank=banked)
    prun = RecognitionRunner(_pcfg(cfg), port_train_cfg(tcfg), ptrain, pval,
                             print_freq=1, use_device_bank=banked,
                             device="cpu")
    sd = prun.model.state_dict()
    prun.load_torch_checkpoint(sd)
    jrun.load_torch_checkpoint({k: v.numpy() for k, v in sd.items()})
    return jrun, prun


def _stats_close(got, want, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


def test_recognition_windows_and_examples_equal_jax():
    b, ws = rec_bundle(2)
    want_ws = _windows(jwin, b)
    for f in ("max_visual_actions", "max_audio_actions", "num_actions",
              "window_size"):
        assert getattr(ws, f) == getattr(want_ws, f), f
    assert len(ws.windows) == len(want_ws.windows) > 20
    ours, theirs = (_datasets(mod, b, w)[0] for mod, w in (
        (pds, ws), (jds, want_ws)))
    ours.rng, theirs.rng = (np.random.default_rng(3) for _ in range(2))
    for i in (0, 5, len(ws.windows) - 1):
        got, want = ours[i], theirs[i]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("banked", [False, True])
def test_runner_validate_matches_jax(banked):
    jrun, prun = _pair(banked)
    _stats_close(prun.validate(), jrun.validate())


def test_banked_votes_equal_the_host_path_and_repeat_bit_for_bit():
    _, prun = _pair(True)
    accs = []
    for _ in range(2):
        acc = WindowVoteAccumulator(prun.val_ds.windows.num_actions,
                                    _head_spec(prun.cfg))
        prun._run_bank_accum(acc)
        accs.append(acc)
    host = WindowVoteAccumulator(prun.val_ds.windows.num_actions,
                                 _head_spec(prun.cfg))
    for logits, _, v_ids, a_ids, labels in prun._eval_batches(prun.val_ds):
        host.update(logits, v_ids, a_ids, labels)
    for h in host.sums:
        assert np.array_equal(accs[0].sums[h], accs[1].sums[h]), h
        scale = np.abs(host.sums[h]).max()
        assert np.abs(accs[0].sums[h] - host.sums[h]).max() <= 1e-9 * scale
    np.testing.assert_array_equal(accs[0].seen, host.seen)
    np.testing.assert_array_equal(accs[0].v_labels, host.v_labels)
    np.testing.assert_array_equal(accs[0].a_labels, host.a_labels)
    assert (host.seen > 0).sum() == prun.val_ds.windows.num_actions


@pytest.mark.parametrize("banked", [False, True])
def test_fit_matches_jax(banked):
    """Two epochs on both packages: the validation statistics of the last
    and the parameters after it."""
    tcfg = _tcfg(epochs=2)
    jrun, prun = _pair(banked, tcfg=tcfg)
    want, got = jrun.fit(), prun.fit()
    _stats_close(got, want)
    assert prun.state.step == int(jrun.state.step) > 2
    assert_state_close(
        dict(prun.model.named_parameters()),
        recognition_state_dict_from_jax({"params": jrun.state.params}),
        1e-4, "param", 2e-3 * prun.state.step)
    assert prun._best_tag(got, 5) == "none"


def test_extract_predictions_matches_jax(tmp_path):
    jrun, prun = _pair(False)
    want = jrun.extract_predictions()
    got = prun.extract_predictions(path=str(tmp_path / "preds.pkl"))
    assert sorted(got) == sorted(want)
    assert got["v_narration_ids"] == want["v_narration_ids"]
    assert got["a_narration_ids"] == want["a_narration_ids"]
    for k in ("action", "verb", "noun", "audio"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].sum(1), 1.0, rtol=1e-9)
    assert os.path.exists(tmp_path / "preds.pkl")
    _, banked = _pair(True)
    dump = banked.extract_predictions()
    for k in ("action", "verb", "noun", "audio"):
        np.testing.assert_allclose(dump[k], got[k], rtol=0, atol=1e-9)


def test_resume_continues_bit_equal(tmp_path):
    """fit one epoch with checkpoints; a fresh runner resumed from them
    and the first runner take one more epoch each: equal parameters."""
    cfg = _pcfg(_cfg())
    tcfg = port_train_cfg(_tcfg(epochs=2, mixup_alpha=0.2,
                                lambda_drloc=0.3))
    b, ws = rec_bundle(2)
    train, val = _datasets(pds, b, ws)
    runner = RecognitionRunner(cfg, tcfg, train, val,
                               output_dir=str(tmp_path), device="cpu",
                               use_device_bank=True)
    runner.fit(epochs=1)
    assert os.path.exists(tmp_path / "checkpoint.pt")
    fresh = RecognitionRunner(cfg, tcfg, train, val, device="cpu",
                              use_device_bank=True)
    assert fresh.resume(str(tmp_path)) == 1
    assert fresh.state.step == runner.state.step > 0
    for r in (runner, fresh):
        r.train_epoch(1)
    for (k, p), q in zip(runner.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(p, q), k


def test_runner_defaults_to_the_card():
    b, ws = rec_bundle()
    train, val = _datasets(pds, b, ws)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            RecognitionRunner(_pcfg(_cfg()), port_train_cfg(_tcfg()), train,
                              val)
    runner = RecognitionRunner(_pcfg(_cfg()), port_train_cfg(_tcfg()), train,
                               val, device="cpu")
    assert next(runner.model.parameters()).device.type == "cpu"
