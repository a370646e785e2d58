"""The detection mAP chain of the port against the JAX package on the CPU:

- ``evals/anet.py``, ``evals/ek100.py`` and the submission half of
  ``evals/format_predictions.py`` are copies: the same inputs give the
  same APs, columns, submissions and errors (exactly; the mAP chain is
  numpy on both sides), with ``n_jobs`` 1 and 2;
- ``DetectionRunner.extract_dense_predictions`` (banked, host, ``top_k``)
  against JAX's runner on the same weights, fp32: the same window rows
  and columns, scores and proposals within 1e-5; ``evaluate_mAP`` equal
  within 1e-6 of the avg mAP; ``fit(eval_mAP_gt=...)`` reports it;
- GT fed back as the predictions gives avg mAP 1.0.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_detection_runner import (  # noqa: F401 (fixtures)
    _cfg, _dataset, _tcfg, bundle, jax_bundle)
from tests.torch_port_helpers import port_cfg, port_train_cfg
from tim_tpu import config as C
from tim_tpu.data import dataset as jds
from tim_tpu.data import windows as jwin
from tim_tpu.evals import anet as janet
from tim_tpu.evals import ek100 as jek
from tim_tpu.evals import format_predictions as jfp
from tim_tpu.runner import DetectionRunner as JaxDetectionRunner
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.data.table import Table
from tim_tpu_torch.evals import anet as panet
from tim_tpu_torch.evals import ek100 as pek
from tim_tpu_torch.evals import format_predictions as pfp
from tim_tpu_torch.runner.detection import DetectionRunner


def _equal(got, want, msg=""):
    """Nested dicts, lists, tuples and arrays equal exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), msg
        for k in want:
            _equal(got[k], want[k], f"{msg}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{msg}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=msg)
    else:
        assert got == want, (msg, got, want)


def _detections(seed, n_gt=40, n_pred=300, classes=6, videos=4):
    rng = np.random.default_rng(seed)
    gs = rng.uniform(0, 60, n_gt)
    gt = {"video-id": np.asarray([f"v{i % 3}" for i in range(n_gt)],
                                 object),
          "t-start": gs, "t-end": gs + rng.uniform(0.5, 5, n_gt),
          "label": rng.integers(0, classes, n_gt)}
    ps = rng.uniform(0, 60, n_pred)
    pe = ps + rng.uniform(0, 6, n_pred)
    pe[:3] = ps[:3]                     # zero-length predictions
    pred = {"video-id": np.asarray([f"v{rng.integers(0, videos)}"
                                    for _ in range(n_pred)], object),
            "t-start": ps, "t-end": pe,
            "label": rng.integers(0, classes + 1, n_pred),
            "score": rng.uniform(0, 1, n_pred)}
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_anet_copy_equals_jax(seed):
    gt, pred = _detections(seed)
    target = np.asarray([3.0, 7.5])
    segs = np.stack([pred["t-start"], pred["t-end"]], -1)
    np.testing.assert_array_equal(panet.segment_iou(target, segs),
                                  janet.segment_iou(target, segs))
    prec = np.random.default_rng(seed).uniform(size=50)
    rec = np.sort(np.random.default_rng(seed + 1).uniform(size=50))
    assert panet.interpolated_prec_rec(prec, rec) == \
        janet.interpolated_prec_rec(prec, rec)
    thr = np.asarray([0.1, 0.3, 0.5])
    args = (gt["video-id"], np.stack([gt["t-start"], gt["t-end"]], -1),
            pred["video-id"], segs, pred["score"], thr)
    np.testing.assert_array_equal(
        panet.compute_average_precision_detection(*args),
        janet.compute_average_precision_detection(*args))
    for n_jobs in (1, 2):
        got = panet.DetectionEvaluator(gt, pred, n_jobs=n_jobs).evaluate()
        want = janet.DetectionEvaluator(gt, pred, n_jobs=n_jobs).evaluate()
        _equal(got, want)
        assert got[1] > 0.0


def test_ek100_copy_equals_jax():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(7)
    n_gt = 40

    def fmt(sec):
        h, m, s = int(sec // 3600), int((sec % 3600) // 60), sec % 60
        return f"{h:02d}:{m:02d}:{s:09.6f}"

    gs = rng.uniform(0, 60, n_gt)
    ann = pd.DataFrame({
        "video_id": [f"P{i % 3}" for i in range(n_gt)],
        "start_timestamp": [fmt(s) for s in gs],
        "stop_timestamp": [fmt(s + rng.uniform(1, 5)) for s in gs],
        "verb_class": rng.integers(0, 4, n_gt),
        "noun_class": rng.integers(0, 5, n_gt),
    }, index=pd.Index([f"n{i}" for i in range(n_gt)], name="narration_id"))
    results = {}
    for _ in range(120):
        vid = f"P{rng.integers(0, 4)}"
        s = float(rng.uniform(0, 60))
        v, n = int(rng.integers(0, 4)), int(rng.integers(0, 5))
        results.setdefault(vid, []).append({
            "verb": v, "noun": n, "action": f"{v},{n}",
            "score": float(rng.uniform(0, 1)),
            "segment": [round(s, 3), round(s + float(rng.uniform(1, 6)),
                                           3)]})
    submission = {"version": "0.2", "challenge": "action_detection",
                  "results": results}
    for task in ("verb", "noun", "action"):
        _equal(pek.gt_columns_from_annotations(Table.from_frame(ann), task,
                                               5),
               jek.gt_columns_from_annotations(ann, task, 5), task)
        _equal(pek.prediction_columns_from_submission(submission, task, 5),
               jek.prediction_columns_from_submission(submission, task, 5),
               task)
        _equal(pek.evaluate_ek100(Table.from_frame(ann), submission, task,
                                  num_nouns=5),
               jek.evaluate_ek100(ann, submission, task, num_nouns=5), task)


def _dump(seed, n=200, classes=7):
    rng = np.random.default_rng(seed)
    vids = np.asarray([f"v{i % 3}" for i in range(n)], object)
    start = rng.uniform(0, 50, n)
    props = np.stack([start, start + rng.uniform(-0.5, 6, n)], -1)
    scores = rng.uniform(0, 0.3, (n, classes)).astype(np.float32)
    gs = rng.uniform(0, 50, 30)
    gt = pfp.gt_to_columns(np.asarray([f"v{i % 3}" for i in range(30)],
                                      object), gs,
                           gs + rng.uniform(1, 5, 30),
                           rng.integers(0, classes, 30))
    return vids, props, scores, gt


@pytest.mark.parametrize("topk", [False, True])
def test_evaluate_detections_and_submissions_equal_jax(topk, tmp_path):
    vids, props, scores, gt = _dump(2)
    _equal(pfp.gt_to_columns(gt["video-id"], gt["t-start"], gt["t-end"],
                             gt["label"]),
           jfp.gt_to_columns(gt["video-id"], gt["t-start"], gt["t-end"],
                             gt["label"]))
    sc = scores
    if topk:
        cls = np.argsort(-scores, -1, kind="stable")[:, :4]
        sc = (np.take_along_axis(scores, cls, -1), cls)
    out = {}
    for name, mod in (("port", pfp), ("jax", jfp)):
        out[name] = mod.evaluate_detections(
            vids, props, sc, gt, score_threshold=0.1, n_jobs=2,
            submission_path=str(tmp_path / f"{name}.json"),
            challenge_json_path=str(tmp_path / f"{name}_challenge.json"),
            num_nouns=3, topk_num_classes=7 if topk else None)
    _equal(out["port"], out["jax"])
    assert out["port"][1] > 0.0
    for suffix in (".json", "_challenge.json"):
        assert ((tmp_path / f"port{suffix}").read_text()
                == (tmp_path / f"jax{suffix}").read_text())
    dets = pfp.nms_per_video(pfp.threshold_predictions(vids, props, scores,
                                                       0.1))
    _equal(pfp.nms_per_video(pfp.threshold_predictions(
        vids, props, scores, 0.1), n_jobs=2), dets)
    _equal(pfp.build_challenge_submission(dets, num_nouns=3),
           jfp.build_challenge_submission(dets, num_nouns=3))
    sub = pfp.build_submission(dets, task="verb", challenge="x")
    _equal(sub, jfp.build_submission(dets, task="verb", challenge="x"))
    _equal(pfp.submission_to_columns(sub, task="verb"),
           jfp.submission_to_columns(sub, task="verb"))


def test_two_stream_fusion_equals_jax():
    rng = np.random.default_rng(3)
    n = 60
    vids = np.asarray([f"v{i % 2}" for i in range(n)], object)
    vs, ns = rng.uniform(0, 0.5, (n, 6)), rng.uniform(0, 0.5, (n, 8))
    st = rng.uniform(0, 30, (2, n))
    vp = np.stack([st[0], st[0] + 3], -1)
    npr = np.stack([st[1], st[1] + 2], -1)
    _equal(pfp.two_stream_fusion(vids, vs, ns, vp, npr, num_nouns=8),
           jfp.two_stream_fusion(vids, vs, ns, vp, npr, num_nouns=8))


def test_validate_submission_equals_jax():
    good = {"version": "0.2", "challenge": "action_detection",
            "results": {"v1": [{"action": 2, "score": 0.5,
                                "segment": [1.0, 2.0]},
                               {"action": "1,2", "score": 0.4,
                                "segment": [1.0, 3.0]}]}}
    pfp.validate_submission(good, num_classes=5, video_ids=["v1"])
    bad = [
        ({"challenge": "x", "results": {}}, {}),
        ({**good, "version": "9.9"}, {}),
        ({**good, "challenge": "x"}, {}),
        ({**good, "results": []}, {}),
        ({**good, "results": {"v1": [{"action": 2, "score": 0.5}]}}, {}),
        ({**good, "results": {"v1": [{"action": 2, "score": 0.5,
                                      "segment": [2.0, 1.0]}]}}, {}),
        ({**good, "results": {"v1": [{"action": 9, "score": 0.5,
                                      "segment": [1.0, 2.0]}]}},
         {"num_classes": 5}),
        (good, {"video_ids": ["v1", "v2"]}),
    ]
    for sub, kw in bad:
        with pytest.raises(jfp.SubmissionError) as want:
            jfp.validate_submission(sub, **kw)
        with pytest.raises(pfp.SubmissionError) as got:
            pfp.validate_submission(sub, **kw)
        assert str(got.value) == str(want.value)
        assert issubclass(pfp.SubmissionError, ValueError)
    assert pfp.VALID_VERSIONS == jfp.VALID_VERSIONS
    assert pfp.VALID_CHALLENGES == jfp.VALID_CHALLENGES


def test_ground_truth_fed_back_gives_map_one():
    rng = np.random.default_rng(5)
    n = 12
    vids = np.asarray([f"v{i % 3}" for i in range(n)], object)
    starts = rng.uniform(0, 40, n)
    ends = starts + rng.uniform(1, 4, n)
    labels = rng.integers(0, 4, n)
    scores = np.full((n, 4), 0.001, np.float32)
    scores[np.arange(n), labels] = 0.9
    m_ap, avg, submission = pfp.evaluate_detections(
        vids, np.stack([starts, ends], -1), scores,
        pfp.gt_to_columns(vids, starts, ends, labels))
    assert avg == pytest.approx(1.0) and np.allclose(m_ap, 1.0)
    assert len(submission["results"]) == 3


# ---------------------------------------------------------------------------
# DetectionRunner's mAP chain against JAX's
# ---------------------------------------------------------------------------

def _runners(bundle, jax_bundle, banked, **cfg_kw):
    cfg, tcfg = _cfg(**cfg_kw), _tcfg()
    jval = _dataset(jds, jwin, jax_bundle, sample_augmentations=False)
    jrun = JaxDetectionRunner(cfg, tcfg, jval, jval,
                              mesh_cfg=C.MeshConfig(data=1),
                              use_device_bank=banked)
    pval = _dataset(pds, pwin, bundle, sample_augmentations=False)
    prun = DetectionRunner(port_cfg(cfg), port_train_cfg(tcfg), pval, pval,
                           use_device_bank=banked, device="cpu")
    sd = prun.model.state_dict()
    # the class heads apart from their focal prior, so that scores clear a
    # threshold, and the regressions' two sigmoids apart, so that the
    # proposals are intervals (end > start)
    sd = {k: (v + 0.3 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(1))
              if k.startswith("cls_head") else v)
          for k, v in sd.items()}
    for m in ("visual", "audio"):
        sd[f"reg_head.fc_{m}_action.4.bias"] = torch.tensor([-1.5, 1.5])
    prun.load_torch_checkpoint(sd)
    jrun.load_torch_checkpoint({k: v.numpy() for k, v in sd.items()})
    return jrun, prun, pval


def _gt(bundle, ds):
    v = pwin.normalize_actions(bundle["v_actions"], "visual", detection=True,
                               window_size=ds.windows.window_size)
    return pfp.gt_to_columns(v["video_id"], v["start_sec"], v["stop_sec"],
                             v["action_class"])


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("top_k", [None, 3])
def test_dense_dump_and_map_match_jax(bundle, jax_bundle,  # noqa: F811
                                      banked, top_k):
    jrun, prun, pval = _runners(bundle, jax_bundle, banked)
    want = jrun.extract_dense_predictions(top_k=top_k)
    got = prun.extract_dense_predictions(top_k=top_k)
    assert sorted(got) == sorted(want)
    assert len(got["video_ids"]) == len(pval) * prun.num_queries
    np.testing.assert_array_equal(got["video_ids"], want["video_ids"])
    for k in want:
        if k == "video_ids":
            continue
        if k.endswith("_classes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    if top_k is not None:
        dense = prun.extract_dense_predictions()
        order = np.argsort(-dense["action"], -1, kind="stable")[:, :top_k]
        np.testing.assert_array_equal(
            np.take_along_axis(dense["action"], got["action_topk_classes"],
                               -1), got["action_topk_values"])
        np.testing.assert_array_equal(
            np.sort(got["action_topk_classes"], -1), np.sort(order, -1))
    gt = _gt(bundle, pval)
    w_map, w_avg, _ = jrun.evaluate_mAP(gt, top_k=top_k,
                                        score_threshold=0.05)
    g_map, g_avg, sub = prun.evaluate_mAP(gt, top_k=top_k,
                                          score_threshold=0.05)
    np.testing.assert_allclose(g_map, w_map, rtol=0, atol=1e-6)
    assert abs(g_avg - w_avg) <= 1e-6 and len(sub["results"]) > 0


def test_banked_and_host_dumps_agree_and_fit_reports_map(
        bundle, jax_bundle):  # noqa: F811
    _, host, pval = _runners(bundle, jax_bundle, False)
    _, banked, _ = _runners(bundle, jax_bundle, True)
    a, b = host.extract_dense_predictions(), banked.extract_dense_predictions()
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "video_ids":
            np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    gt = _gt(bundle, pval)
    stats = banked.fit(epochs=1, eval_mAP_gt=gt, eval_mAP_every=1,
                       score_threshold=0.05)
    assert 0.0 <= stats["val_avg_mAP"] <= 1.0
    assert "val_avg_mAP" not in host.fit(epochs=1, eval_mAP_gt=gt,
                                         eval_mAP_every=2)
