"""The port's detection data, checkpoints and ``DetectionRunner`` against
the JAX package on the CPU, fp32, at small sizes:

- the copies (``data/{windows,dataset,synthetic}.py``,
  ``evals/{metrics,meters}.py``) give JAX's windows, examples, batches
  and accumulators; the device bank's gather equals the host dataset's
  rows;
- ``shape_matched_merge``'s three warnings; a checkpoint round trip, and
  k steps + save + resume + 2 steps bit-equal to k + 2 uninterrupted
  steps;
- ``DetectionRunner.validate`` (host and banked paths) equal to JAX's
  runner's on the same weights; a short training whose loss falls, and
  ``fit`` writing its checkpoints; the mAP half runs
  (``tests/test_torch_evals.py`` holds it to JAX's).
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import port_cfg, port_train_cfg
from tim_tpu import config as C
from tim_tpu.data import dataset as jds
from tim_tpu.data import synthetic as jsyn
from tim_tpu.data import windows as jwin
from tim_tpu.evals import meters as jmeters
from tim_tpu.runner import DetectionRunner as JaxDetectionRunner
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import synthetic as psyn
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.data.device_bank import (
    DetectionWindowTables, DeviceFeatureBank)
from tim_tpu_torch.evals import meters as pmeters
from tim_tpu_torch.runner.detection import DetectionRunner
from tim_tpu_torch.train import checkpoint as ckpt
from tim_tpu_torch.train import detection as pdet
from tim_tpu_torch.train.optim import make_optimizer
from tim_tpu_torch.train.state import create_train_state

NUM_FEATS = 8


@pytest.fixture(scope="module")
def bundle():
    return psyn.synthetic_epic(seed=7, num_videos=2, video_seconds=40.0,
                               per_video=8, visual_dim=24, audio_dim=16,
                               visual_classes=(5, 6, 4), audio_classes=3)


def _windows(mod, b, **kw):
    wsz = NUM_FEATS * 2 * 0.2
    return mod.build_detection_windows(
        mod.normalize_actions(b["v_actions"], "visual", detection=True,
                              window_size=wsz),
        mod.normalize_actions(b["a_actions"], "audio", detection=True,
                              window_size=wsz),
        b["video_info"], b["v_feat_times"], num_feats=NUM_FEATS,
        feat_stride=2, feat_gap=0.2, **kw)


def _dataset(mod, win_mod, b, **kw):
    ws = _windows(win_mod, b)
    return mod.DetectionDataset(
        ws, mod.FeatureStore(b["v_feats"], b["v_feat_times"]),
        mod.FeatureStore(b["a_feats"], b["a_feat_times"]),
        include_verb_noun=False, dataset_name="synthetic", **kw)


def _cfg(**kw):
    base = dict(visual_classes=(4,), audio_classes=3, visual_input_dim=24,
                audio_input_dim=16, d_model=16, nhead=2, num_layers=1,
                num_feats=NUM_FEATS, compute_dtype="float32",
                train_query_size=0.05, inference_query_size=0.1)
    base.update(kw)
    return C.DetectionConfig(**base)


def _tcfg(**kw):
    base = dict(batch_size=8, epochs=1, warmup_epochs=0, lr=1e-3,
                lambda_drloc=0.1, normaliser_init=30.0, seed=0)
    base.update(kw)
    return C.TrainConfig(**base)


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def test_synthetic_and_windows_copies_equal_jax(bundle):
    theirs = jsyn.synthetic_epic(seed=7, num_videos=2, video_seconds=40.0,
                                 per_video=8, visual_dim=24, audio_dim=16,
                                 visual_classes=(5, 6, 4), audio_classes=3)
    for key in ("v_actions", "a_actions", "video_info"):
        assert bundle[key].equals(theirs[key]), key
    for key in ("v_feats", "a_feats", "v_feat_times"):
        for vid in theirs[key]:
            np.testing.assert_array_equal(bundle[key][vid], theirs[key][vid])
    for kw in ({}, {"with_gt": False}):
        ours, want = _windows(pwin, bundle, **kw), _windows(jwin, theirs, **kw)
        for f in ("max_visual_actions", "max_audio_actions", "num_actions",
                  "window_size", "min_query", "max_query"):
            assert getattr(ours, f) == getattr(want, f), f
        assert len(ours.windows) == len(want.windows)
        for a, b in zip(ours.windows, want.windows):
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f.name)),
                    np.asarray(getattr(b, f.name)), err_msg=f.name)
    assert pwin.timestamp_to_seconds("01:02:03.5") == \
        jwin.timestamp_to_seconds("01:02:03.5")


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataset_and_batch_iterator_equal_jax(bundle, drop_last):
    ours = _dataset(pds, pwin, bundle, rng=np.random.default_rng(3))
    want = _dataset(jds, jwin, bundle, rng=np.random.default_rng(3))
    assert len(ours) == len(want)
    got_batches = list(pds.batch_iterator(
        ours, 7, rng=np.random.default_rng(1), drop_last=drop_last,
        with_indices=True))
    want_batches = list(jds.batch_iterator(
        want, 7, rng=np.random.default_rng(1), drop_last=drop_last,
        with_indices=True))
    assert len(got_batches) == len(want_batches) > 0
    for g, w in zip(got_batches, want_batches):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    padded = pds.pad_rows(np.ones((2, 3)), 4, -1, np.int64)
    np.testing.assert_array_equal(
        padded, jds.pad_rows(np.ones((2, 3)), 4, -1, np.int64))


def test_bank_gather_equals_the_host_dataset_rows(bundle):
    ds = _dataset(pds, pwin, bundle, sample_augmentations=False)
    v_bank = DeviceFeatureBank(bundle["v_feats"], device="cpu")
    a_bank = DeviceFeatureBank(bundle["a_feats"], device="cpu")
    tables = DetectionWindowTables(
        ds.windows, v_bank, a_bank, bundle["v_feat_times"],
        bundle["a_feat_times"], dataset_name="synthetic")
    ids = torch.arange(len(ds))
    batch = tables.batch(ids)
    v, a = (b.gather(batch["feat_indices"]) for b in (v_bank, a_bank))
    rows = [ds[i] for i in range(len(ds))]
    for key, got in (("v_feats", v), ("a_feats", a)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.stack([r[key] for r in rows]))
    for key in ("times", "v_gt_segments", "a_gt_segments", "verb", "noun",
                "action", "class_id", "window_start", "window_size"):
        np.testing.assert_array_equal(batch[key].numpy(),
                                      np.stack([r[key] for r in rows]),
                                      err_msg=key)
    # one augmentation set per token, as the dataset draws them
    rng = np.random.default_rng(0)
    aug = torch.from_numpy(rng.integers(0, 2, tuple(
        batch["feat_indices"].shape)))
    got = v_bank.gather(batch["feat_indices"], aug).numpy()
    for i, w in enumerate(ds.windows.windows):
        np.testing.assert_array_equal(
            got[i], bundle["v_feats"][w.video_id][w.feat_indices,
                                                  aug[i].numpy()])


def test_meters_copy_equal_jax():
    rng = np.random.default_rng(0)
    heads = {"verb": 5, "noun": 6, "action": 7, "audio": 3}
    ours, want = (m.WindowVoteAccumulator(10, heads)
                  for m in (pmeters, jmeters))
    for _ in range(3):
        logits = {h: rng.normal(size=(2, 4, c)) for h, c in heads.items()}
        v_ids = rng.integers(-1, 10, (2, 4))
        a_ids = rng.integers(-1, 10, (2, 4))
        labels = {k: rng.integers(0, 5, (2, 4))
                  for k in ("verb", "noun", "action", "class_id")}
        for acc in (ours, want):
            acc.update(logits, v_ids, a_ids, labels)
    assert ours.summarize() == want.summarize()
    la, lb = pmeters.LossAverager(), jmeters.LossAverager()
    for avg in (la, lb):
        avg.update({"loss": 1.5, "x": 2.0}, count=3)
        avg.update({"loss": 0.5})
    assert la.averages() == lb.averages()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_shape_matched_merge_three_cases(caplog):
    init = {"a": torch.zeros(2, 2), "b": torch.zeros(3), "c": torch.zeros(1)}
    loaded = {"a": torch.ones(2, 2), "b": torch.ones(4), "d": torch.ones(1)}
    # caplog's handler sits on the root logger; a runner built earlier in
    # this process stops the port's loggers from propagating to it
    # (``utils.logging.setup_logging``), so listen on the module's logger
    logger = logging.getLogger(ckpt.__name__)
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            merged = ckpt.shape_matched_merge(init, loaded)
    finally:
        logger.removeHandler(caplog.handler)
    assert torch.equal(merged["a"], torch.ones(2, 2))
    assert torch.equal(merged["b"], torch.zeros(3))
    assert torch.equal(merged["c"], torch.zeros(1))
    assert set(merged) == set(init)
    text = caplog.text
    assert "shape mismatch for b" in text
    assert "missing from checkpoint: c" in text
    assert "unused checkpoint entry: d" in text


def _train_setup(bundle, seed=0):
    cfg, tcfg = port_cfg(_cfg()), port_train_cfg(_tcfg(
        normaliser_momentum=0.9))
    from tim_tpu_torch.models import TimDetection
    model = TimDetection(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, make_optimizer(
        model.parameters(), tcfg.lr, tcfg.weight_decay, 20, 2),
        normaliser=tcfg.normaliser_init)
    step = pdet.make_train_step(model, cfg, tcfg)
    return state, step


def _batches(bundle, n):
    ds = _dataset(pds, pwin, bundle, rng=np.random.default_rng(0))
    out = []
    for batch in pds.batch_iterator(ds, 8, rng=np.random.default_rng(0)):
        out.append({k: torch.from_numpy(np.asarray(v))
                    for k, v in batch.items() if k != "_pad"})
        if len(out) == n:
            return out
    raise AssertionError("not enough windows")


def _state_tensors(state):
    out = {f"param.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for i, s in opt["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    out.update({f"count.{k}": v for k, v in opt["if_finite"].items()})
    out["normaliser"] = state.normaliser
    return out


def test_checkpoint_round_trip_and_resume_bit_equal(bundle, tmp_path):
    """2 steps, save, a fresh state (other init) resumed, 2 more steps:
    bit-equal to 4 uninterrupted steps (parameters, optimizer moments
    and counters, normaliser, step); the payload loads with
    ``weights_only``; ``best_<tag>`` copies per tag."""
    batches = _batches(bundle, 4)
    ref, ref_step = _train_setup(bundle)
    for b in batches:
        ref_step(ref, b)

    state, step = _train_setup(bundle)
    for b in batches[:2]:
        step(state, b)
    ckpt.save_checkpoint(str(tmp_path), state, epoch=3,
                         extra={"val_stats": {"loss": 1.25}},
                         is_best="loss_map")
    for name in ("checkpoint.pt", "best_loss.pt", "best_map.pt"):
        assert os.path.exists(tmp_path / name)
    payload = torch.load(tmp_path / "checkpoint.pt", weights_only=True)
    assert payload["epoch"] == 3 and payload["step"] == 2
    assert payload["extra"]["val_stats"]["loss"] == 1.25

    resumed, rstep = _train_setup(bundle, seed=1)
    ckpt.restore_train_state(resumed, ckpt.load_checkpoint(str(tmp_path)))
    assert resumed.step == 2
    want = _state_tensors(state)
    got = _state_tensors(resumed)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for b in batches[2:]:
        rstep(resumed, b)
    want, got = _state_tensors(ref), _state_tensors(resumed)
    assert resumed.step == ref.step == 4
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("banked", [False, True])
def test_runner_validate_matches_jax(bundle, banked):
    """Both runners load the same reference-format weights; their
    validation losses agree (fp32)."""
    cfg, tcfg = _cfg(), _tcfg()
    jtrain = _dataset(jds, jwin, bundle)
    jval = _dataset(jds, jwin, bundle, sample_augmentations=False)
    jrun = JaxDetectionRunner(cfg, tcfg, jtrain, jval,
                              mesh_cfg=C.MeshConfig(data=1),
                              use_device_bank=banked)
    ptrain = _dataset(pds, pwin, bundle)
    pval = _dataset(pds, pwin, bundle, sample_augmentations=False)
    prun = DetectionRunner(port_cfg(cfg), port_train_cfg(tcfg), ptrain, pval,
                           use_device_bank=banked, device="cpu")
    sd = prun.model.state_dict()
    prun.load_torch_checkpoint(sd)
    jrun.load_torch_checkpoint({k: v.numpy() for k, v in sd.items()})
    want, got = jrun.validate(), prun.validate()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_training_loss_falls_and_fit_checkpoints(bundle, tmp_path):
    """40 steps on one batch with the normaliser frozen (momentum 1.0) cut
    the loss below 0.9 of its first value (as the JAX package's
    ``test_detection_overfit``); ``fit`` trains, validates, checkpoints
    the last and best epochs, and ``resume`` continues from them."""
    from tim_tpu_torch.models import TimDetection
    cfg = port_cfg(_cfg(d_model=32, nhead=4, num_layers=2,
                        visual_classes=(13,), audio_classes=7))
    tcfg = port_train_cfg(_tcfg(lr=3e-4, normaliser_init=20.0,
                            normaliser_momentum=1.0))
    model = TimDetection(cfg, device="cpu")
    state = create_train_state(model, make_optimizer(
        model.parameters(), 3e-4, 0.05, 300, 10), normaliser=20.0)
    step = pdet.make_train_step(model, cfg, tcfg)
    batch = _batches(bundle, 1)[0]
    losses = [float(step(state, batch)["loss"]) for _ in range(40)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses[::10]

    ds = _dataset(pds, pwin, bundle)
    val = _dataset(pds, pwin, bundle, sample_augmentations=False)
    runner = DetectionRunner(port_cfg(_cfg()), port_train_cfg(_tcfg(epochs=2)),
                             ds, val, output_dir=str(tmp_path),
                             print_freq=1, device="cpu")
    stats = runner.fit()
    assert np.isfinite(stats["loss"]) and runner.best_loss < float("inf")
    assert os.path.exists(tmp_path / "checkpoint.pt")
    assert os.path.exists(tmp_path / "best_loss.pt")
    again = DetectionRunner(port_cfg(_cfg()), port_train_cfg(_tcfg(epochs=2)),
                            ds, val, device="cpu")
    assert again.resume(str(tmp_path)) == 2
    assert again.state.step == runner.state.step
    for (k, a), b in zip(runner.model.state_dict().items(),
                         again.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_runner_defaults_to_the_card_and_the_map_half_runs(bundle):
    """The runner defaults to the card. The mAP half, which raised until it
    was ported, now runs (``tests/test_torch_evals.py`` holds it to
    JAX's): no ``NotImplementedError`` is left."""
    ds = _dataset(pds, pwin, bundle)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DetectionRunner(port_cfg(_cfg()), port_train_cfg(_tcfg()), ds, ds)
    runner = DetectionRunner(port_cfg(_cfg()), port_train_cfg(_tcfg()), ds, ds,
                             device="cpu")
    dump = runner.extract_dense_predictions()
    assert len(dump["video_ids"]) == len(ds) * runner.num_queries
    gt = {"video-id": np.asarray(["P00_00"], object),
          "t-start": np.zeros(1), "t-end": np.ones(1),
          "label": np.zeros(1, np.int64)}
    m_ap, avg, _ = runner.evaluate_mAP(gt)
    assert m_ap.shape == (5,) and 0.0 <= avg <= 1.0
    stats = runner.fit(eval_mAP_gt=gt, eval_mAP_every=1)
    assert 0.0 <= stats["val_avg_mAP"] <= 1.0
