"""The port's overlap-aware dense extraction (``extract/dense_media.py``)
against the JAX package on the CPU, fp32, with tiny backbones (a Swin
with a shifted block, a one-block ViT) holding the same weights:

- ``build_clip_plan``, ``_chunk_rows`` and ``_stream_plan`` (numpy
  copies) equal JAX's on dense, ragged and irregular tables;
- each mode (``naive``, ``gather``, ``pair_embed``, ``stream``) within
  1e-5 of the port's ``naive`` and 1e-4 of JAX's ``extract_dense_visual``;
- a uint8 bank with the device normalizer equals the host-normalized bank
  (the normalizer equals JAX's bit for bit);
- bf16 modes within the feature gate of the bf16 ``naive`` path;
- ``dispatch="scan"`` (TPU-only) raises;
- the copies ``extract/media.py`` (the ffmpeg commands) and
  ``extract/tables.py`` equal the originals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu.extract import dense_media as jdm
from tim_tpu.extract import media as jmedia
from tim_tpu.extract import tables as jtables
from tim_tpu.extract.pipeline import omnivore_frame_indices
from tim_tpu.models.backbones.swin3d import SwinTransformer3D as JSwin
from tim_tpu.models.backbones.vit import VideoMAEViT as JViT
from tim_tpu_torch.convert import swin_state_dict_from_jax, vit_state_dict_from_jax
from tim_tpu_torch.extract import dense_media as pdm
from tim_tpu_torch.extract import media as pmedia
from tim_tpu_torch.data.table import Table
from tim_tpu_torch.extract import tables as ptables
from tim_tpu_torch.models.backbones.swin3d import SwinTransformer3D as PSwin
from tim_tpu_torch.models.backbones.vit import VideoMAEViT as PViT

SWIN = dict(patch_size=(2, 4, 4), embed_dim=8, depths=(2, 2),
            num_heads=(2, 2), window_size=(2, 3, 3))
VIT = dict(img_size=16, patch_size=8, embed_dim=16, depth=1, num_heads=2,
           num_frames=8, tubelet_size=2)
MODES = ("naive", "gather", "pair_embed", "stream")
BF16_FEATURE_TOL = 1.5e-2     # of the largest feature (PERF.md section 2)


def _dense_table(n_steps=7, span=8, hop=2):
    return np.stack([np.arange(span) + t * hop for t in range(n_steps)])


def _irregular_table():
    return np.stack([omnivore_frame_indices(55, s, 10_000, num_samples=32)
                     for s in range(0, 60, 10)]) - 1


@pytest.mark.parametrize("table,batch", [
    (_dense_table(), 3), (_dense_table(9, 16, 2), 2), (_dense_table(5), 8),
    (_irregular_table(), 4),
    # a frame gapped across non-adjacent batches re-uploads
    (np.stack([[0, 1, 2, 3], [10, 11, 12, 13], [0, 1, 12, 13]]), 1),
])
def test_plans_equal_jax(table, batch):
    got, want = pdm.build_clip_plan(table), jdm.build_clip_plan(table)
    for field in ("unique_frames", "clip_idx", "pairs", "pair_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), field)
    assert (got.frame_dedup, got.pair_dedup) == (want.frame_dedup,
                                                 want.pair_dedup)
    # the plan reassembles the table
    np.testing.assert_array_equal(
        got.unique_frames[got.pairs[got.pair_idx].reshape(len(table), -1)],
        table)
    np.testing.assert_array_equal(pdm._chunk_rows(got.clip_idx, batch),
                                  jdm._chunk_rows(want.clip_idx, batch))
    cap, steps = pdm._stream_plan(got.clip_idx, batch)
    jcap, jsteps = jdm._stream_plan(want.clip_idx, batch)
    assert cap == jcap and len(steps) == len(jsteps)
    for s, js in zip(steps, jsteps):
        for field in ("new_rows", "idx", "tail_sel"):
            np.testing.assert_array_equal(getattr(s, field),
                                          getattr(js, field), field)
    # a step's gather, through the carried tail, gives the planned rows:
    # a padded slot never shadows a real row
    idx = pdm._pad_rows(got.clip_idx, batch)
    tail = np.full(cap, -1)
    for k, s in enumerate(steps):
        bank = np.concatenate([tail, s.new_rows])
        np.testing.assert_array_equal(bank[s.idx],
                                      idx[k * batch:(k + 1) * batch])
        tail = bank[s.tail_sel]


def test_plan_rejects_odd_length():
    with pytest.raises(ValueError, match="tubelet"):
        pdm.build_clip_plan(np.zeros((3, 7), np.int64), tubelet=2)


def _models(which):
    """(JAX model, its variables, the port's fp32 model with the same
    weights, frames, plan) at a dense 16-frame-clip geometry."""
    plan = pdm.build_clip_plan(_dense_table(7, 8, 2))
    rng = np.random.default_rng(3)
    frames = (rng.normal(size=(len(plan.unique_frames), 16, 16, 3)) * 0.5
              ).astype(np.float32)
    if which == "swin":
        jm, pcls, kw = JSwin(**SWIN), PSwin, SWIN
        to_sd = lambda v: swin_state_dict_from_jax(v, SWIN["depths"])  # noqa
    else:
        jm, pcls, kw = JViT(**VIT), PViT, VIT
        to_sd = lambda v: vit_state_dict_from_jax(v, VIT["depth"])  # noqa
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(frames[plan.clip_idx[:1]])))
    pm = pcls(**kw, device="cpu")
    pm.load_state_dict(to_sd(variables), strict=True)
    return jm, variables, pm, frames, plan


@pytest.fixture(scope="module")
def models():
    return {which: _models(which) for which in ("swin", "vit")}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("which", ["swin", "vit"])
def test_modes_equal_naive_and_jax(models, which):
    jm, variables, pm, frames, plan = models[which]
    want = jdm.extract_dense_visual(jm, variables, frames, plan,
                                    batch_size=3, mode="naive")
    ref = pdm.extract_dense_visual(pm, frames, plan, batch_size=3,
                                   mode="naive")
    assert ref.dtype == torch.float32 and ref.shape == (7, 16)
    assert ref.device.type == "cpu"
    for mode in MODES:
        got = pdm.extract_dense_visual(pm, frames, plan, batch_size=3,
                                       embed_batch=4, mode=mode)
        assert _rel(got, ref) <= 1e-5, mode
        assert _rel(got, want) <= 1e-4, mode


def test_uint8_bank_with_device_normalizer_matches_host(models):
    _, _, pm, _, plan = models["vit"]
    raw = np.random.default_rng(0).integers(
        0, 256, (len(plan.unique_frames), 16, 16, 3)).astype(np.uint8)
    tf = pdm.uint8_normalizer(dtype="float32")
    assert pdm.uint8_normalizer(dtype="float32") is tf
    host = ((raw.astype(np.float32) / 255.0
             - np.asarray([0.485, 0.456, 0.406], np.float32))
            / np.asarray([0.229, 0.224, 0.225], np.float32))
    np.testing.assert_array_equal(tf(torch.from_numpy(raw)).numpy(), host)
    np.testing.assert_array_equal(
        tf(torch.from_numpy(raw)).numpy(),
        np.asarray(jdm.uint8_normalizer(dtype="float32")(jnp.asarray(raw))))
    for mode in MODES:
        want = pdm.extract_dense_visual(pm, host, plan, batch_size=2,
                                        mode=mode)
        got = pdm.extract_dense_visual(pm, raw, plan, batch_size=2,
                                       mode=mode, frame_transform=tf)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=mode)


@pytest.mark.parametrize("which", ["swin", "vit"])
def test_bf16_modes_within_the_feature_gate(models, which):
    _, variables, _, frames, plan = models[which]
    pcls, kw, to_sd = ((PSwin, SWIN, lambda v: swin_state_dict_from_jax(
        v, SWIN["depths"])) if which == "swin" else
        (PViT, VIT, lambda v: vit_state_dict_from_jax(v, VIT["depth"])))
    pm = pcls(**kw, dtype="bfloat16", device="cpu")
    pm.load_state_dict(to_sd(variables), strict=True)
    ref = pdm.extract_dense_visual(pm, frames, plan, batch_size=3,
                                   mode="naive")
    assert ref.dtype == torch.bfloat16
    for mode in MODES[1:]:
        got = pdm.extract_dense_visual(pm, frames, plan, batch_size=3,
                                       mode=mode)
        assert _rel(got.float(), ref.float()) <= BF16_FEATURE_TOL, mode


def test_scan_dispatch_raises_and_unknown_modes(models):
    _, _, pm, frames, plan = models["vit"]
    with pytest.raises(NotImplementedError, match="scan"):
        pdm.extract_dense_visual(pm, frames, plan, dispatch="scan")
    with pytest.raises(ValueError, match="dispatch"):
        pdm.extract_dense_visual(pm, frames, plan, dispatch="async")
    with pytest.raises(ValueError, match="mode"):
        pdm.extract_dense_visual(pm, frames, plan, mode="bank")


def test_tables_copy_equals_jax():
    durations = {"a": 3.7, "b": 1.05, "c": 2.0}
    for fps in (50.0, {"a": 30.0, "b": 25.0, "c": 60.0}):
        got = ptables.build_feature_time_table(durations, fps=fps)
        want = jtables.build_feature_time_table(durations, fps=fps)
        assert got.equals(Table.from_frame(want))
        assert list(got.index) == list(want.index)
        assert ptables.build_video_info(durations, fps).equals(
            Table.from_frame(jtables.build_video_info(durations, fps)))


def test_media_copy_issues_the_same_commands(monkeypatch, tmp_path):
    import subprocess
    calls = {}

    class Done:
        stdout = "30000/1001,12.5\n"

    def fake_run(tag):
        def run(cmd, **kwargs):
            calls.setdefault(tag, []).append((cmd, kwargs))
            return Done()
        return run

    for tag, mod in (("jax", jmedia), ("port", pmedia)):
        monkeypatch.setattr(subprocess, "run", fake_run(tag))
        mod.extract_frames("v.mp4", str(tmp_path / tag / "f"), fps=25)
        mod.extract_frames("v.mp4", str(tmp_path / tag / "g"))
        mod.extract_audio("v.mp4", str(tmp_path / tag / "a.wav"),
                          mono=False)
        assert mod.probe_duration_fps("v.mp4") == (12.5, 30000 / 1001)
        assert mod.has_ffmpeg() == jmedia.has_ffmpeg()

    def strip(cmds, tag):
        return [([a.replace(str(tmp_path / tag), "") for a in c], kw)
                for c, kw in cmds]
    assert strip(calls["port"], "port") == strip(calls["jax"], "jax")
