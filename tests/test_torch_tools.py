"""The port's profiling and memory tools on the CPU: ``utils/memory.py``
(no device figures on the CPU), ``utils/profiling.py`` (``torch_trace``
writes a trace; ``ExperimentLogger`` without wandb logs to the Python
logger, as the JAX package's does), ``utils/logging.py::PhaseTimer``
against the JAX package's on the same clock, and the recognition
runner's log line (iteration, data and step seconds and the memory
summary)."""

import glob
import json
import logging
import sys

import numpy as np
import pytest
import torch

from tim_tpu.utils import logging as jlog
from tim_tpu.utils import memory as jmem
from tim_tpu.utils import profiling as jprof
from tim_tpu_torch.utils import logging as plog
from tim_tpu_torch.utils import memory as pmem
from tim_tpu_torch.utils import profiling as pprof


def test_memory_summary_on_the_cpu():
    assert pmem.device_memory_gb("cpu") is None
    if not torch.cuda.is_available():
        assert pmem.device_memory_gb() is None
        summary = pmem.memory_summary()
        assert summary.startswith("ram ") and "hbm" not in summary
    assert pmem.memory_summary("cpu").startswith("ram ")
    assert abs(pmem.host_memory_gb() - jmem.host_memory_gb()) < 0.5
    assert pmem.host_memory_gb() > 0


def test_torch_trace_writes_a_trace(tmp_path):
    with pprof.torch_trace(str(tmp_path / "trace")) as prof:
        assert prof is not None
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with pprof.torch_trace("") as prof:
        assert prof is None
    assert not (tmp_path / "none").exists()


@pytest.fixture()
def captured(caplog):
    """caplog's handler on the port's and JAX's loggers (which may not
    propagate once ``setup_logging`` configured them)."""
    loggers = [logging.getLogger(n) for n in ("tim_tpu_torch", "tim_tpu")]
    saved = [(lg.propagate, lg.level) for lg in loggers]
    for lg in loggers:
        lg.addHandler(caplog.handler)
        lg.propagate = False        # each record once
        lg.setLevel(logging.INFO)
    yield caplog
    for lg, (propagate, level) in zip(loggers, saved):
        lg.removeHandler(caplog.handler)
        lg.propagate, lg.level = propagate, level


def test_experiment_logger_without_wandb_logs_like_jax(captured,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)    # not importable
    lines = {}
    for name, mod in (("port", pprof), ("jax", jprof)):
        captured.clear()
        exp = mod.ExperimentLogger(enable_wandb=True, project="p")
        exp.log({"loss": 1.5}, step=3)
        exp.log({"acc": 0.25})
        exp.finish()
        lines[name] = [r.getMessage() for r in captured.records]
    assert len(lines["port"]) == 3
    assert "wandb requested but unavailable" in lines["port"][0]
    assert lines["port"][1:] == lines["jax"][1:] == [
        "experiment step 3: {'loss': 1.5}", "experiment: {'acc': 0.25}"]


def test_phase_timer_copy_equals_jax(monkeypatch):
    """Both timers on one scripted clock read the same phases."""
    ticks = [1.0, 2.0, 2.5, 4.0, 4.5, 10.0, 10.25, 11.0, 12.5]
    got = []
    for mod in (plog, jlog):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.PhaseTimer()
        t.iter_tic()
        t.data_toc()
        t.net_toc()
        t.iter_toc()
        first = (t.data_time, t.net_time, t.iter_time)
        t.reset()
        t.data_toc()
        t.net_toc()
        t.iter_toc()
        got.append((first, (t.data_time, t.net_time, t.iter_time)))
    assert got[0] == got[1] == ((0.5, 1.5, 2.5), (0.25, 0.75, 2.5))


@pytest.mark.parametrize("banked", [False, True])
def test_recognition_runner_logs_phase_times_and_memory(captured, banked):
    from tests.torch_parallel_worker import _bundle
    from tim_tpu_torch import config as PC
    from tim_tpu_torch.data import dataset as pds
    from tim_tpu_torch.data import windows as pwin
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    b = _bundle()
    ws = pwin.build_recognition_windows(
        pwin.normalize_actions(b["v_actions"], "visual"),
        pwin.normalize_actions(b["a_actions"], "audio"), b["video_info"],
        b["v_feat_times"], num_feats=6, feat_stride=2, feat_gap=0.2)
    ds = pds.RecognitionDataset(
        ws, pds.FeatureStore(b["v_feats"], b["v_feat_times"]),
        pds.FeatureStore(b["a_feats"], b["a_feat_times"]))
    cfg = PC.ModelConfig(visual_classes=(5, 6, 4), audio_classes=3,
                         visual_input_dim=24, audio_input_dim=16,
                         d_model=16, nhead=2, num_layers=1, num_feats=6,
                         compute_dtype="float32")
    runner = RecognitionRunner(
        cfg, PC.TrainConfig(batch_size=8, epochs=1), ds, None,
        print_freq=1, use_device_bank=banked, device="cpu")
    captured.clear()
    stats = runner.train_epoch(0)
    lines = [r.getMessage() for r in captured.records
             if "iter" in r.getMessage()]
    assert len(lines) == len(ds) // 8 > 0 and np.isfinite(stats["loss"])
    for i, line in enumerate(lines):
        assert line.startswith(f"epoch 1 iter {i} | loss ")
        assert "s (data " in line and "s net " in line and "| ram " in line
        assert line.endswith(" (banked)") == banked
