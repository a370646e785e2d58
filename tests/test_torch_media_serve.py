"""Raw-media serving of the port against the JAX package on the CPU, fp32,
tiny backbones holding the same weights (``tests/test_serve.py``'s
raw-media cases, ``tests/test_fused.py``):

- ``DetectionServer.detect_video_frames`` with one backbone (every mode)
  and with the ``[swin, vit]`` concat from one frame bank, and
  ``detect_video_media``: labels equal, segments and scores within 1e-4
  of JAX's same calls; the ``.quantized`` server runs both;
- an empty ``clip_frames`` table raises the intended ``ValueError`` in
  the port, where JAX raises numpy's zero-size reduction error;
- the fused pipelines (``models/fused.py``) within 1e-4 of JAX's, with
  full-size SlowFast as JAX builds it;
- ``evals.nms.nms_1d_torch`` equal to ``nms_1d_jax`` and to the host NMS,
  a zero-length top segment included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu import config as C
from tim_tpu.convert.torch_import import (
    detection_params_from_torch, recognition_params_from_torch)
from tim_tpu.evals.nms import nms_1d_jax
from tim_tpu.models import TimDetection as JTimDetection
from tim_tpu.models.backbones import slowfast as jslowfast
from tim_tpu.models.backbones import swin3d as jswin
from tim_tpu.models.backbones import vit as jvit
from tim_tpu.models.queries import generate_query_pyramid
from tim_tpu.serve import DetectionServer as JServer
from tim_tpu_torch.convert import detection_state_dict_from_jax
from tim_tpu_torch.evals.nms import nms_1d, nms_1d_torch
from tim_tpu_torch.models.backbones.swin3d import SwinTransformer3D as PSwin
from tim_tpu_torch.models.backbones.vit import VideoMAEViT as PViT
from tim_tpu_torch.serve import DetectionServer as PServer
from tests.torch_port_helpers import port_cfg

JSwin, JViT = jswin.SwinTransformer3D, jvit.VideoMAEViT

TOL = 1e-4
SWIN = dict(patch_size=(2, 4, 4), embed_dim=8, depths=(2, 2),
            num_heads=(2, 2), window_size=(2, 3, 3))          # 16-d
VIT16 = dict(img_size=16, patch_size=8, embed_dim=16, depth=1, num_heads=2,
             num_frames=8, tubelet_size=2)
VIT32 = dict(VIT16, embed_dim=32)
SERVER_KW = dict(feat_stride=2, feat_gap=0.2, batch_size=4)
DURATION, NFEAT = 8.0, 30


def _cfg():
    return C.DetectionConfig(
        visual_classes=(4,), audio_classes=3, visual_input_dim=32,
        audio_input_dim=12, d_model=16, nhead=2, num_layers=1, num_feats=6,
        compute_dtype="float32", inference_query_size=0.2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _swin(kw, seed):
    """(JAX model, its variables, the port's model): the port's seeded
    random init, handed to JAX through ``params_from_torch``."""
    pm = PSwin(**kw, device="cpu", generator=_gen(seed))
    return (JSwin(**kw), jswin.params_from_torch(pm.state_dict(),
                                                 kw["depths"]), pm)


def _vit(kw, seed):
    pm = PViT(**kw, device="cpu", generator=_gen(seed))
    return (JViT(**kw), jvit.params_from_torch(pm.state_dict(),
                                               kw["depth"]), pm)


@pytest.fixture(scope="module")
def media():
    """Both servers, three backbones, a video of 8 s: frames, two clip
    tables from one origin (8-frame clips every 2 frames), feature
    times, spectrograms and a linear audio extractor in each package."""
    cfg = _cfg()
    nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, a, t: JTimDetection(cfg).init(
            {"params": key, "dropout": key}, v, a, t, nq, nq,
            deterministic=True))(
        jnp.zeros((1, 6, 32)), jnp.zeros((1, 6, 12)),
        jnp.zeros((1, 12 + 2 * nq, 2)))["params"])
    sd = detection_state_dict_from_jax({"params": params})
    rnd = np.random.default_rng(3)
    table = np.stack([np.arange(t * 2, t * 2 + 8) for t in range(NFEAT)])
    frames = (rnd.normal(size=(table.max() + 3, 16, 16, 3)) * 0.5
              ).astype(np.float32)
    starts = np.linspace(0, DURATION - 1.1, NFEAT).astype(np.float32)
    specs = rnd.normal(size=(NFEAT, 16, 8)).astype(np.float32)
    wa = (rnd.normal(size=(16 * 8, 12)) * 0.05).astype(np.float32)
    return dict(
        cfg=cfg, params=params, sd=sd, frames=frames, table=table,
        ft=np.stack([starts, starts + 1.1], -1), specs=specs,
        jserver=JServer(cfg, params, **SERVER_KW),
        pserver=PServer(port_cfg(cfg), sd, device="cpu", **SERVER_KW),
        jax_audio=jax.jit(lambda s: jnp.dot(s.reshape(s.shape[0], -1),
                                            jnp.asarray(wa))),
        port_audio=lambda s: s.reshape(s.shape[0], -1) @ torch.from_numpy(wa),
        swin=_swin(SWIN, 1), vit16=_vit(VIT16, 2), vit32=_vit(VIT32, 3),
        cache={})


def _same_detections(got, want):
    assert len(want["scores"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["segments"], want["segments"], atol=TOL)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)


def _jax_frames(m, backbones, tables):
    key = ("frames", tuple(backbones))
    if key not in m["cache"]:
        m["cache"][key] = m["jserver"].detect_video_frames(
            m["frames"], tables, m["ft"], DURATION,
            visual_model=[m[b][0] for b in backbones],
            visual_variables=[m[b][1] for b in backbones],
            audio_specs=m["specs"], audio_extractor=m["jax_audio"],
            extract_batch=8, score_threshold=0.01)
    return m["cache"][key]


@pytest.mark.parametrize("mode", ["auto", "gather", "pair_embed", "naive"])
def test_detect_video_frames_single_backbone_equals_jax(media, mode):
    m = media
    want = _jax_frames(m, ["vit32"], [m["table"]])
    got = m["pserver"].detect_video_frames(
        m["frames"], m["table"], m["ft"], DURATION,
        visual_model=m["vit32"][2], audio_specs=m["specs"],
        audio_extractor=m["port_audio"], extract_batch=8, mode=mode,
        score_threshold=0.01)
    _same_detections(got, want)


def test_detect_video_frames_concat_equals_jax(media):
    """Swin (the 8-frame clips) || ViT (the same clips one frame later)
    over one frame bank and one origin."""
    m = media
    tables = [m["table"], m["table"] + 1]
    want = _jax_frames(m, ["swin", "vit16"], tables)
    got = m["pserver"].detect_video_frames(
        m["frames"], tables, m["ft"], DURATION,
        visual_model=[m["swin"][2], m["vit16"][2]], audio_specs=m["specs"],
        audio_extractor=m["port_audio"], extract_batch=8,
        score_threshold=0.01)
    _same_detections(got, want)


def test_detect_video_media_equals_jax(media):
    m = media
    jm, variables, pm = m["vit32"]
    clips = m["frames"][m["table"]]
    want = m["jserver"].detect_video_media(
        clips, m["specs"], m["ft"], DURATION,
        visual_extractor=jax.jit(lambda c: jm.apply(variables, c)),
        audio_extractor=m["jax_audio"], extract_batch=8,
        score_threshold=0.01)
    got = m["pserver"].detect_video_media(
        clips, m["specs"], m["ft"], DURATION, visual_extractor=pm,
        audio_extractor=m["port_audio"], extract_batch=8,
        score_threshold=0.01)
    _same_detections(got, want)
    with pytest.raises(ValueError, match="visual_extractor"):
        m["pserver"].detect_video_media(clips, None, m["ft"], DURATION)


def test_quantized_server_serves_raw_media(media):
    """``DetectionServer.quantized`` (its fused int8 heads' plain version
    on the CPU) through both raw-media calls: the detections of
    ``detect_video`` over the same features."""
    m = media
    cfg = port_cfg(m["cfg"])
    import dataclasses
    server = PServer.quantized(
        dataclasses.replace(cfg, quant_pallas_heads=True), m["sd"], [None],
        device="cpu", **SERVER_KW)
    pm = m["vit32"][2]
    got = server.detect_video_frames(
        m["frames"], m["table"], m["ft"], DURATION, visual_model=pm,
        audio_specs=m["specs"], audio_extractor=m["port_audio"],
        extract_batch=8, score_threshold=0.01)
    clips = m["frames"][m["table"]]
    media_out = server.detect_video_media(
        clips, m["specs"], m["ft"], DURATION, visual_extractor=pm,
        audio_extractor=m["port_audio"], extract_batch=8,
        score_threshold=0.01)
    with torch.inference_mode():
        v = pm(torch.from_numpy(clips)).numpy()
        a = m["port_audio"](torch.from_numpy(m["specs"])).numpy()
    want = server.detect_video(v, a, m["ft"], DURATION, score_threshold=0.01)
    _same_detections(got, want)
    _same_detections(media_out, want)


def test_empty_table_raises_the_intended_error(media):
    m = media
    empty = np.zeros((0, 8), np.int64)
    with pytest.raises(ValueError, match="zero-size array"):
        m["jserver"].detect_video_frames(
            m["frames"], empty, m["ft"], DURATION,
            visual_model=m["vit32"][0], visual_variables=m["vit32"][1])
    with pytest.raises(ValueError, match="empty"):
        m["pserver"].detect_video_frames(
            m["frames"], empty, m["ft"], DURATION,
            visual_model=m["vit32"][2])
    with pytest.raises(ValueError, match="0-based"):
        m["pserver"].detect_video_frames(
            m["frames"], m["table"] + len(m["frames"]), m["ft"], DURATION,
            visual_model=m["vit32"][2])


# --------------------------------------------------------------------------
# fused pipelines (tests/test_fused.py's two cases)
# --------------------------------------------------------------------------

def _fused_inputs(b=2, f=3):
    rnd = np.random.default_rng(0)
    clips = rnd.normal(size=(b, f, 4, 16, 16, 3)).astype(np.float32)
    specs = rnd.normal(size=(b, f, 32, 128)).astype(np.float32)
    return clips, specs, rnd


def _fused_backbones():
    swin = dict(patch_size=(2, 4, 4), embed_dim=8, depths=(1, 1),
                num_heads=(2, 2), window_size=(2, 3, 3))
    vit = dict(img_size=16, patch_size=8, embed_dim=16, depth=1,
               num_heads=2, num_frames=4, tubelet_size=2)
    return swin, vit


def _pipelines(jcls, pcls, cfg, pcfg, to_jax):
    """The JAX pipeline, its variables and the port's: the port's seeded
    random init (full-size SlowFast, as JAX builds it), handed to JAX
    through the ``params_from_torch`` converters."""
    swin_kw, vit_kw = _fused_backbones()
    pipe = pcls(pcfg, swin=PSwin(**swin_kw, device="cpu",
                                 generator=_gen(1)),
                vit=PViT(**vit_kw, device="cpu", generator=_gen(2)),
                device="cpu", generator=_gen(3))
    audio = jslowfast.params_from_torch(pipe.audio_model.state_dict())
    variables = {
        "params": {
            "swin": jswin.params_from_torch(
                pipe.swin_model.state_dict(), swin_kw["depths"])["params"],
            "vit": jvit.params_from_torch(
                pipe.vit_model.state_dict(), 1)["params"],
            "audio_model": audio["params"],
            "tim": to_jax(pipe.tim.state_dict(), d_model=16,
                          num_layers=1)["params"]},
        "batch_stats": {"audio_model": audio["batch_stats"]}}
    jpipe = jcls(tim_cfg=cfg, swin=JSwin(**swin_kw), vit=JViT(**vit_kw))
    return jpipe, variables, pipe


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_fused_detection_pipeline_equals_jax():
    from tim_tpu.models.fused import FusedDetectionPipeline as JPipe
    from tim_tpu_torch.models.fused import FusedDetectionPipeline as PPipe

    cfg = C.DetectionConfig(
        visual_classes=(4,), audio_classes=3, visual_input_dim=32,
        audio_input_dim=2304, d_model=16, nhead=2, num_layers=1,
        num_feats=3, compute_dtype="float32", inference_query_size=0.25)
    nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
    jpipe, variables, pipe = _pipelines(JPipe, PPipe, cfg, port_cfg(cfg),
                                        detection_params_from_torch)
    clips, specs, rnd = _fused_inputs()
    queries = np.broadcast_to(
        generate_query_pyramid(cfg.inference_query_size), (2, nq, 2))
    times = np.concatenate([rnd.uniform(size=(2, 6, 2)), queries, queries],
                           axis=1).astype(np.float32)
    want = jpipe.apply(variables, clips, specs, times, nq, nq)
    with torch.inference_mode():
        cls_scores, reg_scores, ctx = pipe(
            torch.from_numpy(clips), torch.from_numpy(specs),
            torch.from_numpy(times), nq, nq)
        feats = pipe.extract_visual(torch.from_numpy(clips))
    assert feats.shape == (2, 3, 32)
    for g, w in zip(cls_scores, want[0]):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g, w) <= TOL
    for g, w in zip(reg_scores, want[1]):
        assert _rel(g, w) <= TOL
    assert _rel(ctx, want[2]) <= TOL


def test_fused_recognition_pipeline_equals_jax():
    from tim_tpu.models.fused import FusedRecognitionPipeline as JPipe
    from tim_tpu_torch import config as PC
    from tim_tpu_torch.models.fused import FusedRecognitionPipeline as PPipe

    fields = dict(visual_classes=(4,), audio_classes=3,
                  include_verb_noun=False, visual_input_dim=32,
                  audio_input_dim=2304, d_model=16, nhead=2, num_layers=1,
                  num_feats=3, compute_dtype="float32")
    jpipe, variables, pipe = _pipelines(
        JPipe, PPipe, C.ModelConfig(**fields), PC.ModelConfig(**fields),
        recognition_params_from_torch)
    clips, specs, rnd = _fused_inputs()
    nv = na = 2
    times = rnd.uniform(size=(2, 6 + nv + na, 2)).astype(np.float32)
    want = jpipe.apply(variables, clips, specs, times, nv, na)
    with torch.inference_mode():
        logits, ctx = pipe(torch.from_numpy(clips), torch.from_numpy(specs),
                           torch.from_numpy(times), nv, na)
    for g, w in zip(logits, want[0]):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g, w) <= TOL
    assert _rel(ctx, want[1]) <= TOL


# --------------------------------------------------------------------------
# on-device NMS
# --------------------------------------------------------------------------

def _segments(seed, n=40):
    rnd = np.random.default_rng(seed)
    start = rnd.uniform(0, 20, n)
    segs = np.stack([start, start + rnd.uniform(0.2, 4, n)], -1)
    scores = rnd.uniform(size=n)
    return segs.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("seed,iou,max_keep", [(0, 0.3, 12), (1, 0.5, 40),
                                               (2, 0.1, 50)])
def test_nms_1d_torch_equals_jax_and_host(seed, iou, max_keep):
    segs, scores = _segments(seed)
    keep, valid = nms_1d_torch(torch.from_numpy(segs),
                               torch.from_numpy(scores), iou, max_keep)
    jkeep, jvalid = nms_1d_jax(jnp.asarray(segs), jnp.asarray(scores), iou,
                               max_keep)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    host = nms_1d(segs, scores, iou)
    np.testing.assert_array_equal(keep[valid].numpy(), host[:max_keep])


def test_nms_1d_torch_removes_a_zero_length_top_segment():
    """Its self-IoU is 0, below the threshold: without the explicit
    removal it would be selected at every step."""
    segs = np.asarray([[5.0, 5.0], [1.0, 3.0], [5.0, 5.0], [1.5, 3.5]],
                      np.float32)
    scores = np.asarray([0.9, 0.8, 0.7, 0.6], np.float32)
    keep, valid = nms_1d_torch(torch.from_numpy(segs),
                               torch.from_numpy(scores), 0.5, 5)
    jkeep, jvalid = nms_1d_jax(jnp.asarray(segs), jnp.asarray(scores), 0.5, 5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert keep[valid].tolist() == [0, 1, 2]
    assert keep[~valid].tolist() == [-1, -1]
