"""TIM recognition in the port against the JAX package on the CPU, at small
sizes; both packages get the same numpy inputs and weights.

- ``AVGA``, ``RecognitionClsHead``, the verb/noun CLS layout and
  ``TimRecognition`` for the four recognition presets: fp32 within 1e-5
  of the largest output, bf16 within 2e-2 of it (bf16 roundings in
  another order: the products and sums of XLA and of PyTorch's CPU
  kernels);
- ``cross_entropy`` (smoothing, ignored and out-of-range labels, weights,
  reductions), ``mixup`` (fp32 and bf16 weights) and
  ``mixup_cross_entropy``: 1e-6 relative;
- 3 steps of ``make_train_step`` and ``make_bank_train_step`` (dropout
  rates 0, JAX's own mixup and drloc draws handed in): metrics within
  1e-5 relative, every parameter within 1e-4 of its largest value (see
  ``tests/test_torch_train.py::assert_state_close``); ``make_eval_step``
  within 1e-5;
- the state dict round trip through ``recognition_params_from_torch``
  (bit-equal) and its strict load;
- ``RecognitionServer.classify_intervals`` in fp32 within 1e-5, and
  ``.quantized``: int8 weights bit-equal to JAX's, calibrated scales
  within 1e-6 relative (abs-maxes of fp32 activations of the dynamic-int8
  forward, whose sums round in another order: a few ulps, as
  ``tests/test_torch_quant.py`` holds detection's), scores within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import assert_state_close
from tests.torch_port_helpers import port_train_cfg
from tim_tpu import config as C
from tim_tpu.convert.torch_import import recognition_params_from_torch
from tim_tpu.models import TimRecognition as JaxTimRecognition
from tim_tpu.models.encodings import FeatureEncoding as JaxFeatureEncoding
from tim_tpu.models.heads import RecognitionClsHead as JaxHead
from tim_tpu.models.pool import AVGA as JaxAVGA
from tim_tpu.ops import losses as JL
from tim_tpu.serve import RecognitionServer as JaxServer
from tim_tpu.train import recognition as jrec
from tim_tpu.train.optim import make_optimizer as jax_make_optimizer
from tim_tpu.train.state import create_train_state as jax_train_state
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import (
    act_scales_from_jax, quantized_recognition_state_dict_from_jax,
    recognition_state_dict_from_jax)
from tim_tpu_torch.models import TimRecognition
from tim_tpu_torch.ops import losses as PL
from tim_tpu_torch.serve import RecognitionServer
from tim_tpu_torch.train import recognition as prec
from tim_tpu_torch.train.optim import make_optimizer
from tim_tpu_torch.train.state import create_train_state

F32_TOL = 1e-5        # fp32 forward, of the largest output
BF16_TOL = 2e-2       # bf16 forward, of the largest output
RTOL = 1e-5           # losses and grad norm of the train steps
PARAM_TOL = 1e-4      # parameters after steps: of each tensor's largest

PRESETS = ("epic_recognition", "epic_visual_only", "perception_recognition",
           "ave_recognition")


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _scaled(got, want, tol, msg=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (msg, err, np.abs(want).max())


def rec_cfgs(preset="epic_recognition", **kw):
    """(JAX config, port config) of a small recognition preset."""
    base = dict(d_model=32, num_layers=2, nhead=2, num_feats=6,
                compute_dtype="float32", audio_input_dim=12,
                visual_input_dim=16)
    if preset != "perception_recognition":
        base["visual_classes"] = ((4, 5, 11) if preset != "ave_recognition"
                                  else (7,))
    if preset == "ave_recognition":
        base["audio_classes"] = 7
    base.update(kw)
    return getattr(C, preset)(**base), getattr(PC, preset)(**base)


def _queries(cfg, nv=3, na=2):
    return (nv if "visual" in cfg.data_modality else 0,
            na if "audio" in cfg.data_modality else 0)


def rec_inputs(cfg, b=3, seed=1, nv=3, na=2):
    """(v, a, times) numpy inputs of a forward (v flattened [.., 49*Dv]
    for AVE)."""
    rng = np.random.default_rng(seed)
    nv, na = _queries(cfg, nv, na)
    vdim = cfg.visual_input_dim * (49 if cfg.apply_feature_pooling else 1)
    v = (rng.normal(size=(b, cfg.num_feats, vdim)).astype(np.float32)
         if "visual" in cfg.input_modality else None)
    a = (rng.normal(size=(b, cfg.num_feats, cfg.audio_input_dim))
         .astype(np.float32) if "audio" in cfg.input_modality else None)
    times = np.sort(rng.uniform(0, 1, (b, cfg.num_context + nv + na, 2)),
                    -1).astype(np.float32)
    return v, a, times


_VARIABLES = {}


def rec_variables(cfg, seed=0):
    """``{'params': tree}`` (numpy) of a flax TimRecognition, perturbed by
    seeded noise so that no LayerNorm or bias sits at its init."""
    key = (cfg, seed)
    if key not in _VARIABLES:
        v, a, times = rec_inputs(cfg, b=1)
        nv, na = _queries(cfg)
        k = jax.random.PRNGKey(seed)
        params = jax.jit(lambda v, a, t: JaxTimRecognition(cfg).init(
            {"params": k, "dropout": k}, v, a, t, nv, na))(
            v, a, times)["params"]
        rng = np.random.default_rng(seed)
        _VARIABLES[key] = {"params": jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape))
            .astype(np.float32), params)}
    return _VARIABLES[key]


def rec_model(pcfg, variables) -> TimRecognition:
    model = TimRecognition(pcfg, device="cpu")
    model.load_state_dict(recognition_state_dict_from_jax(variables),
                          strict=True)
    return model


def _opt(x):
    return None if x is None else torch.from_numpy(x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avga_matches_jax(dtype):
    rng = np.random.default_rng(0)
    dv, da = 16, 12
    audio = rng.normal(size=(2, 5, da)).astype(np.float32)
    video = rng.normal(size=(2, 5, 49, dv)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jm = JaxAVGA(hidden_size=dv, dtype=jdt)
    params = jm.init(jax.random.PRNGKey(0), audio, video)["params"]
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape))
        .astype(np.float32), params)
    want = jm.apply({"params": params}, audio, video)
    sd = recognition_state_dict_from_jax({"params": {
        "time_mlp": {}, "time_norm": {"scale": np.ones(1),
                                      "bias": np.zeros(1)},
        "feature_encoding": {}, "encoder": {}, "drloc_mlp": {},
        "cls_head": {}, "pool": params}})
    from tim_tpu_torch.models.pool import AVGA
    pool = AVGA(dv, da, dtype=getattr(torch, dtype),
                generator=torch.Generator().manual_seed(0))
    pool.load_state_dict({k[len("pool."):]: v for k, v in sd.items()
                          if k.startswith("pool.")}, strict=True)
    with torch.no_grad():
        got = pool(_t(audio), _t(video))
    assert got.dtype == getattr(torch, dtype)
    _scaled(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    with pytest.raises(ValueError, match="map_size"):
        pool(_t(audio), _t(video[:, :, :36]))


@pytest.mark.parametrize("classes,nv,na", [((4, 5, 11), 3, 2), ((7,), 2, 0),
                                           ((7,), 0, 3)])
def test_recognition_head_slices_the_tail_as_jax(classes, nv, na):
    rng = np.random.default_rng(1)
    width, s = 8, 20
    x = rng.normal(size=(2, s, width)).astype(np.float32)
    jh = JaxHead(visual_classes=classes, audio_classes=6)
    params = jh.init(jax.random.PRNGKey(0), x, max(nv, 1),
                     max(na, 1))["params"]
    want = jh.apply({"params": params}, x, nv, na)
    from tim_tpu_torch.convert import _CLS_HEADS, _linear
    from tim_tpu_torch.models.heads import RecognitionClsHead
    sd = {}
    for name, tree in params.items():
        _linear(tree, _CLS_HEADS[name], sd)
    head = RecognitionClsHead(width, classes, 6, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = head(_t(x), nv, na)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _scaled(g, w, F32_TOL)


@pytest.mark.parametrize("input_modality,data_modality", [
    ("audio_visual", "audio_visual"), ("visual", "visual"),
    ("audio", "audio"), ("visual", "audio_visual")])
def test_verb_noun_cls_layout_matches_jax(input_modality, data_modality):
    """verb, noun and action CLS sets in that order after the context,
    audio last; a one-modality model's tokens carry no modality prefix in
    the state dict, as the reference's."""
    d, nf, nv, na = 8, 4, 3, 2
    rng = np.random.default_rng(2)
    v = rng.normal(size=(2, nf, 16)).astype(np.float32)
    a = rng.normal(size=(2, nf, 12)).astype(np.float32)
    n_ctx = nf * (2 if input_modality == "audio_visual" else 1)
    te = rng.normal(size=(2, n_ctx + nv + na, d)).astype(np.float32)
    jfe = JaxFeatureEncoding(d_model=d, input_modality=input_modality,
                             data_modality=data_modality, num_feats=nf,
                             use_verb_noun_cls=True)
    params = jfe.init(jax.random.PRNGKey(0), v, a, te, nv, na)["params"]
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape))
        .astype(np.float32), params)
    want = jfe.apply({"params": params}, v, a, te, nv, na)
    sd = recognition_state_dict_from_jax({"params": {
        "time_mlp": {}, "time_norm": {"scale": np.ones(1),
                                      "bias": np.zeros(1)},
        "feature_encoding": params, "encoder": {}, "drloc_mlp": {},
        "cls_head": {}}})
    fe_sd = {k[len("feature_encoding."):]: t for k, t in sd.items()
             if k.startswith("feature_encoding.")}
    single = input_modality == data_modality != "audio_visual"
    assert ("action_cls" in fe_sd) == single
    assert ("visual_verb_cls" in fe_sd) == (not single)
    from tim_tpu_torch.models.encodings import FeatureEncoding
    fe = FeatureEncoding(d, input_modality, data_modality, nf, 16, 12,
                         dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0),
                         use_verb_noun_cls=True, prefix_tokens=not single)
    fe.load_state_dict(fe_sd, strict=True)
    with torch.no_grad():
        got = fe(_t(v), _t(a), _t(te), nv, na)
    _scaled(got, want, F32_TOL)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tim_recognition_matches_jax(preset, dtype):
    cfg, pcfg = rec_cfgs(preset, compute_dtype=dtype)
    variables = rec_variables(rec_cfgs(preset)[0])
    v, a, times = rec_inputs(cfg)
    nv, na = _queries(cfg)
    want, want_ctx = jax.jit(lambda p, v, a, t: JaxTimRecognition(
        cfg).apply(p, v, a, t, nv, na))(variables, v, a, times)
    model = rec_model(pcfg, variables)
    with torch.no_grad():
        got, ctx = model(_opt(v), _opt(a), _t(times), nv, na)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(("verb", "noun", "action", "audio"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == getattr(torch, dtype)
            _scaled(g, w, tol, name)
    _scaled(ctx, want_ctx, tol, "context")


@pytest.mark.parametrize("preset", PRESETS)
def test_state_dict_round_trip_and_strict_load(preset):
    cfg, pcfg = rec_cfgs(preset)
    variables = rec_variables(cfg)
    sd = recognition_state_dict_from_jax(variables)
    back = recognition_params_from_torch(sd, d_model=cfg.d_model,
                                         num_layers=cfg.num_layers)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(path))
    model = TimRecognition(pcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    assert all(k.startswith(("time_mlp.", "feature_encoding.",
                             "transformer_encoder.layers.", "cls_head.",
                             "drloc_mlp.", "pool.")) for k in sd)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    """Labels -1 (ignored) and out of range (ignored, not raised) add
    nothing; the mean divides by the valid count, at least 1."""
    rng = np.random.default_rng(3)
    logits = rng.normal(scale=3.0, size=(30, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 30)
    labels[:4] = -1
    labels[4:6] = [9, 15]
    w = rng.uniform(size=30).astype(np.float32)
    for weights in (None, w):
        for red in ("mean", "sum", "none"):
            _close(PL.cross_entropy(_t(logits), _t(labels, torch.long),
                                    label_smoothing=smoothing,
                                    weights=None if weights is None
                                    else _t(weights), reduction=red),
                   JL.cross_entropy(logits, labels,
                                    label_smoothing=smoothing,
                                    weights=weights, reduction=red),
                   rtol=1e-6, atol=1e-7)
    none = -np.ones(30, np.int64)
    assert float(PL.cross_entropy(_t(logits), _t(none, torch.long))) == 0.0
    bf = PL.cross_entropy(_t(logits, torch.bfloat16), _t(labels, torch.long))
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("lam_dtype", ["float32", "bfloat16"])
def test_mixup_and_mixup_cross_entropy_match_jax(lam_dtype):
    """JAX's ``mixup`` rounds its weight to ``inputs[0]``'s dtype and mixes
    each input in the promotion of that dtype and its own."""
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(9)
    jdt = jnp.dtype(lam_dtype)
    x0 = jnp.asarray(rng.normal(size=(6, 4, 5)), jdt)
    x1 = jnp.asarray(rng.normal(size=(6, 3)), jnp.bfloat16)
    x2 = jnp.asarray(rng.normal(size=(6, 2)), jnp.float32)
    (m0, m1, m2), perm, lam = JL.mixup(key, (x0, x1, x2), 0.4)
    got = PL.mixup(tuple(torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, str(x.dtype))) for x in (x0, x1, x2)),
        _t(perm, torch.long), float(lam))
    for g, w in zip(got, (m0, m1, m2)):
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    logits = rng.normal(size=(6, 7)).astype(np.float32)
    la, lb = rng.integers(-1, 7, 6), rng.integers(-1, 9, 6)
    _close(PL.mixup_cross_entropy(_t(logits), _t(la, torch.long),
                                  _t(lb, torch.long), float(lam),
                                  label_smoothing=0.1),
           JL.mixup_cross_entropy(logits, la, lb, lam, label_smoothing=0.1),
           rtol=1e-6)


def test_mixup_draws_are_a_permutation_and_a_beta_weight():
    perm, lam = PL.mixup_draws(np.random.default_rng(0), 8, 0.2)
    assert sorted(perm.tolist()) == list(range(8)) and 0.0 <= lam <= 1.0
    perm, lam = PL.mixup_draws(np.random.default_rng(0), 8, 0.0)
    assert lam == 1.0
    d = prec.make_step_draws(PC.epic_recognition(num_feats=6),
                             PC.TrainConfig(lambda_drloc=0.3))
    one, two = d(3, 4), d(3, 4)
    assert torch.equal(one.perm, two.perm) and one.lam == two.lam
    assert all(torch.equal(p, q) for p, q in zip(one.drloc, two.drloc))
    assert one.drloc[0].shape == (4, 32) and one.drloc[0].max() < 6
    assert d(4, 4).dropout_seed != one.dropout_seed


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------

def _train_cfgs(preset="epic_recognition", **kw):
    return rec_cfgs(preset, enc_dropout=0.0, feat_dropout=0.0,
                    seq_dropout=0.0, **kw)


def rec_batch(cfg, b=4, seed=3, nv=3, na=2):
    """A recognition batch (numpy): features, times, label rows with
    padded (-1) queries."""
    v, a, times = rec_inputs(cfg, b, seed, nv, na)
    rng = np.random.default_rng(seed + 1)
    vc = cfg.visual_classes
    out = {"times": times}
    if v is not None:
        out["v_feats"] = v
    if a is not None:
        out["a_feats"] = a
    for k, n, c in (("verb", nv, vc[0]), ("noun", nv, vc[min(1, len(vc) - 1)]),
                    ("action", nv, vc[-1]),
                    ("class_id", na, cfg.audio_classes)):
        lab = rng.integers(0, c, (b, n))
        lab[:, -1:] = -1
        out[k] = lab
    return out


def jax_draws(cfg, tcfg, rng):
    """The port's draws function made of JAX's own draws (the
    ``fold_in``/``split`` chain of ``tim_tpu/train/recognition.py``)."""

    def draws(step, batch_size):
        rng_mix, _, rng_drloc = jax.random.split(
            jax.random.fold_in(rng, step), 3)
        rng_lam, rng_perm = jax.random.split(rng_mix)
        lam = (jax.random.beta(rng_lam, tcfg.mixup_alpha, tcfg.mixup_alpha)
               if tcfg.mixup_alpha > 0 else 1.0)
        perm = jax.random.permutation(rng_perm, batch_size)
        r1, r2 = jax.random.split(rng_drloc)
        drloc = tuple(torch.from_numpy(np.array(jax.random.randint(
            r, (batch_size, tcfg.m_drloc), 0, cfg.num_feats))).long()
            for r in (r1, r2))
        return prec.StepDraws(_t(perm, torch.long), float(lam), drloc,
                              dropout_seed=step)

    return draws


def _step_pair(cfg, pcfg, tcfg, nv, na, lr=1e-3, total=10, warmup=2):
    variables = rec_variables(cfg)
    jstate = jax_train_state(
        variables["params"],
        jax_make_optimizer(lr, tcfg.weight_decay, total, warmup,
                           min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm))
    model = rec_model(pcfg, variables)
    pstate = create_train_state(model, make_optimizer(
        model.parameters(), lr, tcfg.weight_decay, total, warmup,
        min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm))
    return jstate, pstate


def _assert_params(model, jparams, budget):
    assert_state_close(dict(model.named_parameters()),
                       recognition_state_dict_from_jax({"params": jparams}),
                       PARAM_TOL, "param", budget)


@pytest.mark.parametrize("preset", ["epic_recognition", "epic_visual_only"])
def test_train_step_matches_jax_over_3_steps(preset):
    cfg, pcfg = _train_cfgs(preset)
    tcfg = C.TrainConfig(lambda_drloc=0.3, mixup_alpha=0.4)
    nv, na = _queries(cfg)
    jstate, pstate = _step_pair(cfg, pcfg, tcfg, nv, na)
    jstep = jax.jit(jrec.make_train_step(JaxTimRecognition(cfg), cfg, tcfg,
                                         nv, na))
    rng = jax.random.PRNGKey(5)
    pstep = prec.make_train_step(pstate.model, pcfg, port_train_cfg(tcfg),
                                 nv, na, draws=jax_draws(cfg, tcfg, rng))
    batch = rec_batch(cfg, nv=nv, na=na)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, rng)
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(pm) == set(jm)
        for k in jm:
            _close(pm[k], jm[k], rtol=RTOL, atol=1e-9)
        _assert_params(pstate.model, jstate.params, 2e-3 * (i + 1))
    assert pstate.step == 3


def test_bank_train_step_matches_jax():
    """Two banked steps (one augmentation set, so neither package draws
    one) from the same weights and window ids."""
    from tim_tpu.data.device_bank import (
        DeviceFeatureBank as JaxBank, DeviceWindowTables as JaxTables)
    from tim_tpu_torch.data.device_bank import (
        DeviceFeatureBank, DeviceWindowTables)
    from tests.test_torch_recognition_runner import rec_bundle
    b, ws = rec_bundle()
    cfg, pcfg = _train_cfgs(num_feats=8, visual_input_dim=24,
                            audio_input_dim=16, audio_classes=7)
    tcfg = C.TrainConfig(lambda_drloc=0.3)
    nv, na = ws.max_visual_actions, ws.max_audio_actions
    feats = {m: b[f"{m}_feats"] for m in ("v", "a")}
    jv, ja = JaxBank(feats["v"]), JaxBank(feats["a"])
    jtables = JaxTables(ws, jv, ja, b["v_feat_times"], b["a_feat_times"])
    pv, pa = (DeviceFeatureBank(feats[m], device="cpu") for m in "va")
    ptables = DeviceWindowTables(ws, pv, pa, b["v_feat_times"],
                                 b["a_feat_times"])
    ids = [0, 3, 5, 7]
    for k, want in jtables.batch(jnp.asarray(ids)).items():
        np.testing.assert_array_equal(
            ptables.batch(torch.tensor(ids))[k].numpy(), np.asarray(want),
            err_msg=k)
    variables = rec_variables(cfg)
    jstate = jax_train_state(variables["params"], jax_make_optimizer(
        1e-3, tcfg.weight_decay, 10, 2, min_lr=tcfg.min_lr,
        clip_norm=tcfg.clip_norm))
    model = rec_model(pcfg, variables)
    pstate = create_train_state(model, make_optimizer(
        model.parameters(), 1e-3, tcfg.weight_decay, 10, 2,
        min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm))
    rng = jax.random.PRNGKey(5)
    jstep = jax.jit(jrec.make_bank_train_step(JaxTimRecognition(cfg), cfg,
                                              tcfg, nv, na, jv, ja))
    pstep = prec.make_bank_train_step(model, pcfg, port_train_cfg(tcfg), nv,
                                      na, pv, pa,
                                      draws=jax_draws(cfg, tcfg, rng))
    for i, ids in enumerate(([0, 3, 5, 7], [2, 4, 6, 8])):
        jstate, jm = jstep(jstate, jtables.batch(jnp.asarray(ids)), rng)
        pm = pstep(pstate, ptables.batch(torch.tensor(ids)))
        for k in jm:
            _close(pm[k], jm[k], rtol=RTOL, atol=1e-9)
        _assert_params(pstate.model, jstate.params, 2e-3 * (i + 1))


@pytest.mark.parametrize("preset", ["epic_recognition", "perception_recognition"])
def test_eval_step_matches_jax(preset):
    cfg, pcfg = rec_cfgs(preset)
    tcfg = C.TrainConfig(label_smoothing=0.1)
    nv, na = _queries(cfg)
    variables = rec_variables(cfg)
    batch = rec_batch(cfg, nv=nv, na=na)
    jl, jloss = jax.jit(jrec.make_eval_step(JaxTimRecognition(cfg), cfg,
                                            tcfg, nv, na))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    pl, ploss = prec.make_eval_step(rec_model(pcfg, variables), pcfg,
                                    port_train_cfg(tcfg), nv, na)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(pl) == set(jl) and set(ploss) == set(jloss)
    for k in jl:
        _scaled(pl[k], jl[k], F32_TOL, k)
    for k in jloss:
        _close(ploss[k], jloss[k], rtol=RTOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _video(cfg, seconds=20.0, n=12, seed=6):
    rng = np.random.default_rng(seed)
    starts = np.arange(0.0, seconds - 1.0, 0.2, dtype=np.float32)
    feat_times = np.stack([starts, starts + 1.0], -1)
    v = (rng.normal(size=(len(starts), cfg.visual_input_dim))
         .astype(np.float32) if "visual" in cfg.input_modality else None)
    a = (rng.normal(size=(len(starts), cfg.audio_input_dim))
         .astype(np.float32) if "audio" in cfg.input_modality else None)
    lo = rng.uniform(0, seconds - 4.0, n)
    intervals = np.stack([lo, lo + rng.uniform(0.3, 3.0, n)], -1)
    return v, a, feat_times, intervals


SERVE_KW = dict(feat_stride=1, ensemble=3, batch_size=8)


@pytest.mark.parametrize("preset", ["epic_recognition", "epic_visual_only"])
def test_classify_intervals_matches_jax(preset):
    """fp32 scores within 1e-5; the covering windows equal JAX's (the
    padded last batch does not vote)."""
    cfg, pcfg = rec_cfgs(preset)
    variables = rec_variables(cfg)
    jserver = JaxServer(cfg, variables["params"], **SERVE_KW)
    server = RecognitionServer(pcfg, recognition_state_dict_from_jax(
        variables), device="cpu", **SERVE_KW)
    v, a, feat_times, intervals = _video(cfg)
    for s, e in intervals:
        np.testing.assert_array_equal(server._covering_windows(s, e),
                                      jserver._covering_windows(s, e))
    want = jserver.classify_intervals(v, a, feat_times, intervals)
    got = server.classify_intervals(v, a, feat_times, intervals)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].sum(-1), 1.0, rtol=1e-9)


@pytest.mark.parametrize("calibration", ["zeros", "batch"])
def test_quantized_recognition_server_matches_jax(calibration):
    """Int8 weights bit-equal to JAX's, calibrated scales (on JAX's zero
    batch, and on a real batch) within 1e-6 relative; scores within
    1e-3."""
    cfg, pcfg = rec_cfgs()
    variables = rec_variables(cfg)
    nv, na = 1, 1
    batches = [None]
    if calibration == "batch":
        v, a, times = rec_inputs(cfg, b=2, seed=8, nv=nv, na=na)
        batches = [(v, a, times)]
    jserver = JaxServer.quantized(cfg, variables["params"], batches,
                                  **SERVE_KW)
    server = RecognitionServer.quantized(
        pcfg, recognition_state_dict_from_jax(variables), batches,
        device="cpu", **SERVE_KW)
    want_sd = quantized_recognition_state_dict_from_jax(jserver.params)
    got_sd = server.model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert any(t.dtype == torch.int8 for t in got_sd.values())
    want_scales = act_scales_from_jax(jserver.cfg.quant_act_scales,
                                      encoder="transformer_encoder")
    got_scales = server.cfg.quant_act_scales
    assert [n for n, _ in got_scales] == [n for n, _ in want_scales]
    np.testing.assert_allclose([s for _, s in got_scales],
                               [s for _, s in want_scales], rtol=1e-6)
    assert len(want_scales) == 4 * cfg.num_layers + 4
    v, a, feat_times, intervals = _video(cfg)
    want = jserver.classify_intervals(v, a, feat_times, intervals)
    got = server.classify_intervals(v, a, feat_times, intervals)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
