"""TIM detection training in the port against the JAX package on the CPU,
fp32, at small sizes; both packages get the same numpy inputs and weights.

- intervals and losses to 1e-6 (the smoothed focal loss also against its
  explicit-target form), query labelling and smoothed labels exactly;
- dropout: the uint8 threshold and scale of JAX's, unbiased means and
  keep rates within binomial bounds, identity when deterministic, and
  the same masks when ``remat`` recomputes a layer;
- ``_modality_losses``, 3 steps of ``make_train_step`` (dropout rates 0,
  JAX's own query and drloc draws handed in), ``make_val_step`` and
  ``make_bank_train_step``: losses, grad norm and normaliser to 1e-5
  relative, every parameter to 1e-4 of its largest value (see
  ``tests/test_torch_train.py::assert_state_close`` for the elements
  where Adam is ill-conditioned);
- the optimizer's skip of non-finite gradients against optax's;
- kernels 1, 2 and 3 refuse inputs that require grad.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import assert_state_close
from tests.torch_port_helpers import (
    jax_variables, port_cfg, port_model, port_train_cfg, small_cfg)
from tim_tpu import config as C
from tim_tpu.data.device_bank import (
    DetectionWindowTables as JaxTables, DeviceFeatureBank as JaxBank)
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models import queries as JQ
from tim_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from tim_tpu.ops import dropout as jdrop
from tim_tpu.ops import intervals as JI
from tim_tpu.ops import losses as JL
from tim_tpu.train import detection as jdet
from tim_tpu.train.optim import make_optimizer as jax_make_optimizer
from tim_tpu.train.state import create_train_state as jax_train_state
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import detection_state_dict_from_jax
from tim_tpu_torch.data.device_bank import (
    DetectionWindowTables, DeviceFeatureBank)
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.models import queries as PQ
from tim_tpu_torch.ops import dropout as pdrop
from tim_tpu_torch.ops import intervals as PI
from tim_tpu_torch.ops import losses as PL
from tim_tpu_torch.train import detection as pdet
from tim_tpu_torch.train.optim import make_optimizer
from tim_tpu_torch.train.state import create_train_state

RTOL = 1e-5           # losses, grad norm, normaliser
PARAM_TOL = 1e-4      # parameters after steps: of each tensor's largest


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# intervals, losses, labels
# ---------------------------------------------------------------------------

def _segments(rng, *shape):
    return np.sort(rng.uniform(-0.1, 1.0, shape + (2,)), -1).astype(
        np.float32)


def test_intervals_match_jax():
    rng = np.random.default_rng(0)
    a, b = _segments(rng, 4, 7), _segments(rng, 4, 7)
    b[0, :2] = 0.0                      # zero-length padding: 0, not NaN
    a[0, :2] = 0.0
    _close(PI.segment_iou_1d(_t(a), _t(b)), JI.segment_iou_1d(a, b))
    q, t = _segments(rng, 3, 11), _segments(rng, 3, 5)
    _close(PI.pairwise_iou_1d(_t(q), _t(t)), JI.pairwise_iou_1d(q, t))


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_and_diou_losses_match_jax(weighted):
    rng = np.random.default_rng(1)
    logits = rng.normal(scale=3.0, size=(40, 9)).astype(np.float32)
    targets = rng.uniform(size=(40, 9)).astype(np.float32)
    w = rng.uniform(size=(40, 9)).astype(np.float32) if weighted else None
    for red in ("none", "sum", "mean"):
        _close(PL.sigmoid_focal_loss(_t(logits), _t(targets), reduction=red,
                                     weights=None if w is None else _t(w)),
               JL.sigmoid_focal_loss(logits, targets, reduction=red,
                                     weights=w), rtol=1e-6, atol=1e-7)
    off = rng.uniform(0.0, 1.0, (2, 30, 2)).astype(np.float32)
    wd = rng.uniform(size=(30,)).astype(np.float32) if weighted else None
    for red in ("none", "sum", "mean"):
        _close(PL.ctr_diou_loss_1d(_t(off[0]), _t(off[1]), reduction=red,
                                   weights=None if wd is None else _t(wd)),
               JL.ctr_diou_loss_1d(off[0], off[1], reduction=red,
                                   weights=wd), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("c", [5, 44, 3806])
def test_smoothed_focal_matches_jax_and_explicit_targets(c):
    """The port never forms the [N, C] targets; JAX builds them from an
    iota; the explicit form builds them with ``smooth_positive_labels``."""
    rng = np.random.default_rng(c)
    n = 64
    logits = rng.normal(scale=2.0, size=(n, c)).astype(np.float32)
    labels = rng.integers(-1, c, n)
    labels[:5] = -1
    w = rng.uniform(0.5, 1.0, n).astype(np.float32)
    got = PL.sigmoid_focal_loss_smoothed(_t(logits), _t(labels, torch.long),
                                         0.9, weights=_t(w))
    _close(got, JL.sigmoid_focal_loss_smoothed(
        jnp.asarray(logits), jnp.asarray(labels), 0.9, weights=w), rtol=1e-6)
    explicit = PL.sigmoid_focal_loss(
        _t(logits), PL.smooth_positive_labels(_t(labels, torch.long), c, 0.9),
        weights=_t(w)[:, None], reduction="sum")
    _close(got, explicit, rtol=1e-6)
    # and the gradient of the two forms, to 1e-6 of its largest value (a
    # label column's gradient is its peak term's less its floor term's)
    x1, x2 = _t(logits).requires_grad_(), _t(logits).requires_grad_()
    PL.sigmoid_focal_loss_smoothed(x1, _t(labels, torch.long), 0.9,
                                   weights=_t(w)).backward()
    PL.sigmoid_focal_loss(x2, PL.smooth_positive_labels(
        _t(labels, torch.long), c, 0.9), weights=_t(w)[:, None],
        reduction="sum").backward()
    _close(x1.grad, x2.grad, rtol=0, atol=1e-6 * float(x2.grad.abs().max()))


def test_smooth_labels_and_drloc_match_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(-1, 7, (3, 6))
    _close(PL.smooth_positive_labels(_t(labels, torch.long), 7, 0.9),
           JL.smooth_positive_labels(jnp.asarray(labels), 7, 0.9))
    x1 = rng.normal(size=(3, 10, 8)).astype(np.float32)
    x2 = rng.normal(size=(3, 10, 8)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    r1, r2 = jax.random.split(key)
    pos = tuple(torch.from_numpy(np.asarray(jax.random.randint(
        r, (3, 5), 0, 10))).long() for r in (r1, r2))
    want = JL.drloc_loss(key, x1, x2, lambda p: jnp.tanh(p @ w), 5)
    got = PL.drloc_loss(pos, _t(x1), _t(x2),
                        lambda p: torch.tanh(p @ _t(w)))
    _close(got, want, rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    p1, p2 = PL.drloc_positions(gen, 3, 10, 5)
    assert p1.shape == p2.shape == (3, 5) and int(p1.max()) < 10


@pytest.mark.parametrize("n_labels", [1, 3])
def test_label_queries_and_smoothing_match_jax(n_labels):
    rng = np.random.default_rng(n_labels)
    pool = JQ.generate_query_pyramid(0.1)
    queries = np.broadcast_to(pool[rng.permutation(len(pool))[:20]],
                              (4, 20, 2)).copy()
    gt = np.zeros((4, 5, 2), np.float32)
    gt[:, :3] = pool[rng.integers(0, len(pool), (4, 3))] + rng.normal(
        scale=0.01, size=(4, 3, 2)).astype(np.float32)
    labels = -np.ones((4, 5, n_labels), np.int64)
    labels[:, :3] = rng.integers(0, 6, (4, 3, n_labels))
    want = JQ.label_queries(jnp.asarray(queries), jnp.asarray(gt),
                            jnp.asarray(labels), 0.6)
    got = PQ.label_queries(_t(queries), _t(gt), _t(labels, torch.long), 0.6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isfinite(got[0][..., 0].numpy()).sum() > 0   # positives
    classes = (4, 5, 6) if n_labels == 3 else (6,)
    for mod in ("visual", "audio"):
        ours = PQ.smooth_detection_labels(got[1], classes, 6, 0.9, mod)
        theirs = JQ.smooth_detection_labels(want[1], classes, 6, 0.9, mod)
        for o, t in zip(*(((ours,), (theirs,)) if mod == "audio"
                          else (ours, theirs))):
            assert (o is None) == (t is None)
            if o is not None:
                np.testing.assert_array_equal(o.numpy(), np.asarray(t))


def test_sample_train_queries_is_a_subset_without_repeats():
    pool = torch.from_numpy(PQ.generate_query_pyramid(0.005))
    gen = torch.Generator().manual_seed(0)
    qs = PQ.sample_train_queries(gen, pool, 399)
    rows = {tuple(r) for r in pool.tolist()}
    assert qs.shape == (399, 2)
    assert all(tuple(r) in rows for r in qs.tolist())
    idx = [pool.tolist().index(r) for r in qs.tolist()]
    assert len(set(idx)) == 399
    again = PQ.sample_train_queries(torch.Generator().manual_seed(0), pool,
                                    399)
    assert torch.equal(qs, again)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.001, 0.1, 0.25, 0.5, 0.9, 0.999])
def test_coarse_dropout_threshold_and_scale_match_jax(rate):
    x = np.ones((4096,), np.float32)
    want = np.asarray(jdrop.coarse_dropout(jax.random.PRNGKey(0),
                                           jnp.asarray(x), rate))
    got = pdrop.coarse_dropout(_t(x), rate,
                               torch.Generator().manual_seed(0)).numpy()
    keep_q = pdrop.keep_quantized(rate)
    assert keep_q == int(np.round((1.0 - rate) * 256.0))
    # the same values: 0, or the scale JAX applies (identity / all zeros
    # at the two ends)
    assert set(np.unique(got)) <= set(np.unique(want)) | {0.0}
    if 0 < keep_q < 256:
        assert np.unique(want[want > 0]) == np.unique(got[got > 0]) \
            == np.float32(256.0 / keep_q)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 32])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_mean(bits, rate):
    n = 200_000
    x = torch.ones(n)
    y = pdrop.dropout(x, rate, False, bits, torch.Generator().manual_seed(1))
    p = (pdrop.keep_quantized(rate) / 256.0) if bits == 8 else 1.0 - rate
    kept = int((y != 0).sum())
    sigma = np.sqrt(n * p * (1.0 - p))
    assert abs(kept - n * p) <= 5 * sigma
    # unbiased: E[mask * scale] = 1 (scale exact for these rates)
    assert abs(float(y.double().mean()) - 1.0) <= 5 * sigma / (n * p)
    assert pdrop.dropout(x, rate, True, bits) is x
    assert pdrop.dropout(x, 0.0, False, bits) is x


def _remat_grads(remat: bool, seed: int):
    cfg = port_cfg(small_cfg(remat=remat, enc_dropout=0.3, feat_dropout=0.2,
                             seq_dropout=0.2, dropout_bits=8))
    model = TimDetection(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b, nq = 3, 4
    v = _t(rng.normal(size=(b, cfg.num_feats, cfg.visual_input_dim)))
    a = _t(rng.normal(size=(b, cfg.num_feats, cfg.audio_input_dim)))
    te = _t(rng.normal(size=(b, cfg.num_context + 2 * nq, cfg.d_model)))
    cls, reg, ctx = model.encoder_forward(v, a, te, nq, nq,
                                          dropout_seed=seed)
    loss = cls[2].square().sum() + reg[1].sum() + ctx.sum()
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def test_remat_recomputes_the_same_masks():
    """With dropout on (uint8 masks), rematerialised layers give the very
    gradients of the stored forward: their recomputation drew the same
    masks. Another seed gives other gradients."""
    plain, remat = _remat_grads(False, 7), _remat_grads(True, 7)
    assert set(plain) == set(remat)
    for name in plain:
        torch.testing.assert_close(remat[name], plain[name], rtol=0, atol=0,
                                   msg=name)
    other = _remat_grads(True, 8)
    assert any(not torch.equal(other[n], plain[n]) for n in plain)


def test_encoder_dropout_sites_and_bits():
    """An encoder layer in training draws its masks from its seed: the
    same seed twice gives the same output, another seed another; with
    rate 0 it is JAX's training forward of the layer (and the port's own
    deterministic one)."""
    cfg = small_cfg(enc_dropout=0.0)
    variables = jax_variables(cfg)
    width = 2 * cfg.d_model
    jl = JaxEncoderLayer(width, cfg.nhead, cfg.d_model * 4, dropout=0.0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, width)).astype(np.float32)
    want = jl.apply({"params": variables["params"]["encoder"]["layer0"]},
                    x, 4, False, rngs={"dropout": jax.random.PRNGKey(1)})
    layer = port_model(cfg, variables).backbone.layers[0]
    with torch.no_grad():
        got = layer(_t(x), 4, False, 5)
        _close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, layer(_t(x), 4))
        layer.dropout_rate = 0.3
        one, two = layer(_t(x), 4, False, 5), layer(_t(x), 4, False, 5)
        assert torch.equal(one, two)
        assert not torch.equal(one, layer(_t(x), 4, False, 6))
        assert not torch.allclose(one, layer(_t(x), 4))


# ---------------------------------------------------------------------------
# losses, train, val and bank steps against JAX
# ---------------------------------------------------------------------------

def _det_cfg(**kw):
    base = dict(train_query_size=0.1, enc_dropout=0.0, feat_dropout=0.0,
                seq_dropout=0.0)
    base.update(kw)
    return small_cfg(**base)


def _train_batch(cfg, b=4, seed=3, n_gt=4):
    """A random detection batch (numpy) whose GT segments sit near train
    pool intervals, so that some queries are positives."""
    rng = np.random.default_rng(seed)
    f = cfg.num_feats
    pool = JQ.generate_query_pyramid(cfg.train_query_size)
    seg = np.zeros((b, n_gt, 2), np.float32)
    seg[:, :3] = np.clip(pool[rng.integers(0, len(pool), (b, 3))]
                         + rng.normal(scale=0.01, size=(b, 3, 2)), 0, 1)
    vc = cfg.visual_classes
    labels = {k: -np.ones((b, n_gt), np.int64)
              for k in ("verb", "noun", "action", "class_id")}
    for k, n in zip(("verb", "noun", "action"),
                    vc if len(vc) == 3 else (vc[0],) * 3):
        labels[k][:, :3] = rng.integers(0, n, (b, 3))
    labels["class_id"][:, :3] = rng.integers(0, cfg.audio_classes, (b, 3))
    return {
        "v_feats": rng.normal(size=(b, f, cfg.visual_input_dim)).astype(
            np.float32),
        "a_feats": rng.normal(size=(b, f, cfg.audio_input_dim)).astype(
            np.float32),
        "times": np.sort(rng.uniform(0, 1, (b, 2 * f, 2)), -1).astype(
            np.float32),
        "v_gt_segments": seg, "a_gt_segments": seg[:, ::-1].copy(),
        "window_start": np.arange(b, dtype=np.float32),
        "window_size": np.full(b, 3.6, np.float32), **labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("case", ["visual1", "visual3", "audio",
                                  "visual1-fixed-normaliser"])
def test_modality_losses_match_jax(case):
    classes = (4, 5, 6) if case == "visual3" else (6,)
    cfg = _det_cfg(visual_classes=classes, audio_classes=6)
    tcfg = C.TrainConfig()
    modality = "audio" if case == "audio" else "visual"
    update = not case.endswith("fixed-normaliser")
    rng = np.random.default_rng(4)
    b, nq = 3, 7
    logits = tuple(rng.normal(size=(b, nq, c)).astype(np.float32)
                   for c in (4, 5, 6, 6))
    reg = rng.uniform(0.0, 1.0, (b, nq, 2)).astype(np.float32)
    targets = rng.uniform(0.0, 1.0, (b, nq, 2)).astype(np.float32)
    targets[:, :3] = np.inf
    labels = rng.integers(0, 4, (b, nq, len(classes)))
    labels[:, :3] = -1
    ious = rng.uniform(0.0, 1.0, (b, nq)).astype(np.float32)
    want = jdet._modality_losses(
        tuple(jnp.asarray(x) for x in logits), jnp.asarray(reg),
        jnp.asarray(targets), jnp.asarray(labels), jnp.asarray(ious), cfg,
        tcfg, jnp.float32(250.0), modality, update_normaliser=update)
    got = pdet._modality_losses(
        tuple(_t(x) for x in logits), _t(reg), _t(targets),
        _t(labels, torch.long), _t(ious), port_cfg(cfg),
        PC.TrainConfig(), torch.tensor(250.0), modality,
        update_normaliser=update)
    for g, w in zip(got, want):
        _close(g, w, rtol=RTOL)


def _jax_draws(cfg, tcfg, rng, num_queries):
    """The port's draws function made of JAX's own draws (the
    ``fold_in``/``split`` chain of ``tim_tpu/train/detection.py``)."""
    pool = jnp.asarray(JQ.generate_query_pyramid(cfg.train_query_size))

    def draws(step, batch_size):
        rng_vq, rng_aq, _, rng_drloc = jax.random.split(
            jax.random.fold_in(rng, step), 4)
        r1, r2 = jax.random.split(rng_drloc)
        return pdet.StepDraws(
            _t(JQ.sample_train_queries(rng_vq, pool, num_queries)),
            _t(JQ.sample_train_queries(rng_aq, pool, num_queries)),
            tuple(torch.from_numpy(np.asarray(jax.random.randint(
                r, (batch_size, tcfg.m_drloc), 0, cfg.num_feats))).long()
                for r in (r1, r2)), dropout_seed=step)

    return draws


def _step_pair(cfg, tcfg, lr=1e-3, total=10, warmup=2):
    """(JAX state, jitted JAX step, port state, port step) from the same
    weights, dropout rates 0, the port handed JAX's draws."""
    variables = jax_variables(cfg)
    jstate = jax_train_state(
        variables["params"],
        jax_make_optimizer(lr, tcfg.weight_decay, total, warmup,
                           min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm),
        normaliser=tcfg.normaliser_init)
    jstep = jax.jit(jdet.make_train_step(JaxTimDetection(cfg), cfg, tcfg))
    model = port_model(cfg, variables)
    pstate = create_train_state(model, make_optimizer(
        model.parameters(), lr, tcfg.weight_decay, total, warmup,
        min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm),
        normaliser=tcfg.normaliser_init)
    nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]
    pstep = pdet.make_train_step(
        model, port_cfg(cfg), port_train_cfg(tcfg),
        draws=_jax_draws(cfg, tcfg, jax.random.PRNGKey(5), nq))
    return jstate, jstep, pstate, pstep


def _assert_params(model, jparams, budget):
    assert_state_close(dict(model.named_parameters()),
                       detection_state_dict_from_jax({"params": jparams}),
                       PARAM_TOL, "param", budget)


@pytest.mark.parametrize("classes", [(11,), (4, 5, 11)])
def test_train_step_matches_jax_over_3_steps(classes):
    cfg = _det_cfg(visual_classes=classes)
    tcfg = C.TrainConfig(lambda_drloc=0.3, normaliser_init=250.0)
    jstate, jstep, pstate, pstep = _step_pair(cfg, tcfg)
    batch = _train_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, rng)
        pm = pstep(pstate, _torch_batch(batch))
        assert set(pm) == set(jm)
        for k in jm:
            _close(pm[k], jm[k], rtol=RTOL, atol=1e-9)
        _assert_params(pstate.model, jstate.params, 2e-3 * (i + 1))
    assert float(jm["num_pos_visual"]) > 0
    assert pstate.step == 3 and int(pstate.optimizer.counters["count"]) == 3
    _close(pstate.normaliser, jstate.normaliser, rtol=RTOL)


def test_val_step_matches_jax():
    cfg = _det_cfg()
    tcfg = C.TrainConfig()
    variables = jax_variables(cfg)
    jstate = jax_train_state(variables["params"], optax.sgd(0.0),
                             normaliser=37.0)
    want = jax.jit(jdet.make_val_step(JaxTimDetection(cfg), cfg, tcfg))(
        jstate, {k: jnp.asarray(v) for k, v in _train_batch(cfg).items()})
    model = port_model(cfg, variables)
    pstate = create_train_state(model, torch.optim.SGD(model.parameters(),
                                                       lr=0.0),
                                normaliser=37.0)
    got = pdet.make_val_step(model, port_cfg(cfg), port_train_cfg(tcfg))(
        pstate, _torch_batch(_train_batch(cfg)))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=RTOL)
    assert float(pstate.normaliser) == 37.0


def _tiny_bundle():
    from tim_tpu.data import synthetic
    from tim_tpu.data.windows import (
        build_detection_windows, normalize_actions)
    b = synthetic.synthetic_epic(seed=0, num_videos=2, video_seconds=30.0,
                                 per_video=6, visual_dim=16, audio_dim=12)
    ws = build_detection_windows(
        normalize_actions(b["v_actions"], "visual", detection=True,
                          window_size=3.2),
        normalize_actions(b["a_actions"], "audio", detection=True,
                          window_size=3.2),
        b["video_info"], b["v_feat_times"], num_feats=8, feat_stride=2,
        feat_gap=0.2)
    return b, ws


def test_bank_train_step_matches_jax():
    """Two banked steps (one augmentation set, so neither package draws
    one) of the port and of JAX from the same weights and window ids."""
    b, ws = _tiny_bundle()
    cfg = _det_cfg(num_feats=8)
    tcfg = C.TrainConfig(lambda_drloc=0.3)
    feats = {m: {k: v[:, :1] for k, v in b[f"{m}_feats"].items()}
             for m in ("v", "a")}
    jv, ja = JaxBank(feats["v"]), JaxBank(feats["a"])
    jtables = JaxTables(ws, jv, ja, b["v_feat_times"], b["a_feat_times"],
                        dataset_name="synthetic")
    pv, pa = (DeviceFeatureBank(feats[m], device="cpu") for m in "va")
    ptables = DetectionWindowTables(ws, pv, pa, b["v_feat_times"],
                                    b["a_feat_times"],
                                    dataset_name="synthetic")
    jstate, _, pstate, _ = _step_pair(cfg, tcfg)
    jstep = jax.jit(jdet.make_bank_train_step(JaxTimDetection(cfg), cfg,
                                              tcfg, jv, ja))
    nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]
    pstep = pdet.make_bank_train_step(
        pstate.model, port_cfg(cfg), port_train_cfg(tcfg), pv, pa,
        draws=_jax_draws(cfg, tcfg, jax.random.PRNGKey(5), nq))
    rng = jax.random.PRNGKey(5)
    for i, ids in enumerate(([0, 3, 5, 7], [2, 4, 6, 8])):
        jstate, jm = jstep(jstate, jtables.batch(jnp.asarray(ids)), rng)
        pm = pstep(pstate, ptables.batch(torch.tensor(ids)))
        for k in jm:
            _close(pm[k], jm[k], rtol=RTOL, atol=1e-9)
        _assert_params(pstate.model, jstate.params, 2e-3 * (i + 1))


# ---------------------------------------------------------------------------
# the optimizer's non-finite skip against optax
# ---------------------------------------------------------------------------

def test_nonfinite_gradients_are_skipped_as_optax_skips_them():
    """A NaN or inf gradient skips the update (parameters, moments and the
    schedule's count stay; the skip counts advance); after 8 skips in a
    row the next non-finite update is applied, as optax gives up."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jax_make_optimizer(1e-2, 1e-4, 20, 3, clip_norm=1.0)
    jparams, jopt = p0, tx.init(p0)
    params = [torch.nn.Parameter(_t(p0["a"])), torch.nn.Parameter(
        _t(p0["b"]))]
    opt = make_optimizer(params, 1e-2, 1e-4, 20, 3, clip_norm=1.0)
    finite = [True, False, True] + [False] * 10
    for i, ok in enumerate(finite):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        if not ok:
            g["b"][i % 5] = np.nan if i % 2 else np.inf
        upd, jopt = tx.update(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(params, ("a", "b")):
            p.grad = _t(g[k])
        opt.step()
        opt.zero_grad()
        for p, k in zip(params, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), jparams[k],
                                       rtol=1e-5, atol=1e-7, err_msg=str(i))
        c = opt.counters
        assert int(c["notfinite_count"]) == int(jopt.notfinite_count)
        assert int(c["total_notfinite"]) == int(jopt.total_notfinite)
        assert bool(c["last_finite"]) == bool(jopt.last_finite)
        inner_count = int(jopt.inner_state[1][0].count)
        assert int(c["count"]) == inner_count, i
    # the 9th non-finite step in a row was applied: NaN everywhere
    assert not np.isfinite(jparams["b"]).all()
    assert int(opt.counters["count"]) == 4


# ---------------------------------------------------------------------------
# kernels without a backward
# ---------------------------------------------------------------------------

def test_kernels_without_a_backward_refuse_grad_inputs():
    """Kernels 1, 2 and 3 write their output through raw pointers and
    define no backward: their wrappers refuse (before launching) inputs
    that require grad while grad mode is on."""
    from tim_tpu_torch.ops.fused_post_attention import fused_post_attention
    from tim_tpu_torch.ops.int8_matmul_fused import int8_matmul_fused
    from tim_tpu_torch.ops.query_block_attention import (
        query_block_attention)
    from tim_tpu_torch._build import refuse_grad
    x = torch.ones(2, 3, requires_grad=True)
    for name in ("query_block_attention", "fused_post_attention",
                 "int8_matmul_fused"):
        with pytest.raises(RuntimeError, match=name):
            refuse_grad(name, torch.ones(2), x)
        with torch.no_grad():
            refuse_grad(name, x)
        refuse_grad(name, torch.ones(2))
    assert all(hasattr(f, "launches") for f in (
        query_block_attention, fused_post_attention, int8_matmul_fused))
