"""The port's checkpoint gate (``python -m tim_tpu_torch.validate_checkpoint``)
against the JAX package's, on checkpoints the port's small models write in
the reference's format (recognition audio-visual with verb/noun heads,
one-modality recognition, audio-visual detection), on the CPU:

- ``infer_from_state_dict`` equals JAX's;
- both gates with ``--skip_parity``: every stage passes, and the contract
  numbers agree within 1e-3 (JAX's as it prints them, 3 and 4 decimals);
- a wrong ``--task`` and a missing tensor FAIL, the latter naming it;
- a one-class head passes in the port (JAX's ``_margin_agreement`` still
  fails on it);
- parity SKIPs without the reference tree; with the loader pointed at a
  tree whose ``models/tim.py`` is built on ``tests/torch_oracle.py`` it
  PASSes, and FAILs once a tensor is perturbed on the reference side;
- each stage prints its device, parity runs on the CPU, and the gate
  defaults to the card.
"""

import re
import textwrap

import numpy as np
import pytest
import torch

from tim_tpu import validate_checkpoint as JV
from tim_tpu_torch import config as PC
from tim_tpu_torch import validate_checkpoint as PV
from tim_tpu_torch.models import TimDetection, TimRecognition

SMALL = dict(d_model=16, nhead=2, num_layers=2, num_feats=6,
             compute_dtype="float32")
MODELS = {
    "rec_av": (TimRecognition, "recognition", PC.ModelConfig(
        visual_classes=(5, 6, 4), audio_classes=3, visual_input_dim=24,
        audio_input_dim=16, **SMALL)),
    "rec_visual": (TimRecognition, "recognition", PC.ModelConfig(
        visual_classes=(4,), audio_classes=3, visual_input_dim=24,
        include_verb_noun=False, input_modality="visual",
        data_modality="visual", **SMALL)),
    "det_av": (TimDetection, "detection", PC.DetectionConfig(
        visual_classes=(13,), audio_classes=7, visual_input_dim=20,
        audio_input_dim=16, **SMALL)),
    "rec_one_class": (TimRecognition, "recognition", PC.ModelConfig(
        visual_classes=(1,), audio_classes=3, visual_input_dim=24,
        include_verb_noun=False, input_modality="visual",
        data_modality="visual", **SMALL)),
}
ARGS = ["--nhead", "2", "--num_feats", "6"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = tmp_path_factory.mktemp("gate")
    paths = {}
    for seed, (name, (cls, _, cfg)) in enumerate(MODELS.items()):
        model = cls(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
        paths[name] = out / f"{name}.pth.tar"
        torch.save({"state_dict": model.state_dict(), "epoch": 7},
                   paths[name])
    return paths


def _argv(ckpts, name, *extra):
    return [str(ckpts[name]), "--task", MODELS[name][1], *ARGS, *extra]


def _lines(out):
    return {m.group(1): m.group(2) for m in re.finditer(
        r"^\[validate\] (\w+)\s+(PASS|FAIL|SKIP)", out, re.M)}


def _contract_numbers(out):
    m = re.search(r"score d max ([\d.]+) \(<=0.1\) mean ([\d.]+) "
                  r"\(<=0.01\), top-1 agree ([\d.]+)", out)
    return tuple(float(x) for x in m.groups())


@pytest.mark.parametrize("name", ["rec_av", "rec_visual", "det_av"])
def test_infer_equals_jax(name, ckpts):
    sd = torch.load(ckpts[name], weights_only=True)["state_dict"]
    task = MODELS[name][1]
    assert PV.infer_from_state_dict(sd, task) == JV.infer_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, task)


@pytest.mark.parametrize("name", ["rec_av", "det_av"])
def test_gate_passes_and_the_contract_matches_jax(name, ckpts, capsys):
    gate = PV.validate(_argv(ckpts, name, "--skip_parity"), device="cpu")
    out = capsys.readouterr().out
    assert not gate.failed, out
    assert _lines(out) == {"load": "PASS", "infer": "PASS",
                           "convert": "PASS", "parity": "SKIP",
                           "contract": "PASS"}, out
    assert JV.main(_argv(ckpts, name, "--skip_parity")) == 0
    jax_out = capsys.readouterr().out
    assert "contract   PASS" in jax_out, jax_out
    ours = gate.numbers["contract"]
    assert _contract_numbers(out) == pytest.approx(
        (ours["max"], ours["mean"], ours["agreement"]), abs=5e-4)
    for got, want in zip((ours["max"], ours["mean"], ours["agreement"]),
                         _contract_numbers(jax_out)):
        assert abs(got - want) <= 1e-3, (got, want)


def test_one_modality_gate_passes(ckpts, capsys):
    assert PV.main(_argv(ckpts, "rec_visual", "--skip_parity"),
                   device="cpu") == 0
    assert "RESULT: PASS" in capsys.readouterr().out


def test_one_class_head_passes_in_the_port(ckpts, capsys):
    """A one-class head's argmax always agrees: the port's agreement is
    1.0. JAX's ``_margin_agreement`` raises on it (``np.partition`` at
    -2), so its gate fails that contract; the JAX package stays as it
    is."""
    assert PV.main(_argv(ckpts, "rec_one_class", "--skip_parity"),
                   device="cpu") == 0
    out = capsys.readouterr().out
    assert "top-1 agree 1.000" in out and "RESULT: PASS" in out, out
    scores = np.full((4, 1), 0.5)
    assert PV._margin_agreement(scores, scores) == 1.0
    with pytest.raises(ValueError):
        JV._margin_agreement(scores, scores)


def test_wrong_task_fails(ckpts, capsys):
    assert PV.main([str(ckpts["rec_av"]), "--task", "detection", *ARGS],
                   device="cpu") == 1
    out = capsys.readouterr().out
    assert "infer      FAIL" in out and "RESULT: FAIL (infer)" in out


def test_a_missing_tensor_fails_convert_by_name(ckpts, tmp_path, capsys):
    sd = torch.load(ckpts["det_av"], weights_only=True)["state_dict"]
    del sd["reg_head.fc_audio_action.2.weight"]
    sd["cls_head.extra.weight"] = torch.zeros(2)
    path = tmp_path / "broken.pth"
    torch.save({"state_dict": sd}, path)
    assert PV.main([str(path), "--task", "detection", *ARGS],
                   device="cpu") == 1
    out = capsys.readouterr().out
    assert "convert    FAIL" in out
    assert "reg_head.fc_audio_action.2.weight" in out
    assert "cls_head.extra.weight" in out


def test_wrapped_checkpoints_load(ckpts, tmp_path, capsys):
    sd = torch.load(ckpts["det_av"], weights_only=True)["state_dict"]
    path = tmp_path / "wrapped.pth"
    torch.save({"state_dict": {f"module._orig_mod.{k}": v
                               for k, v in sd.items()}}, path)
    assert PV.main([str(path), "--task", "detection", *ARGS,
                    "--skip_contract"], device="cpu") == 0
    assert "convert    PASS" in capsys.readouterr().out


def test_parity_skips_without_the_tree(ckpts, tmp_path, monkeypatch,
                                       capsys):
    monkeypatch.setattr(PV, "REFERENCE_ROOT", str(tmp_path / "absent"))
    assert PV.main(_argv(ckpts, "rec_av", "--skip_contract"),
                   device="cpu") == 0
    out = capsys.readouterr().out
    assert re.search(r"parity     SKIP  reference tree not found .*\(cpu,",
                     out), out


_ORACLE_TIM = '''
from tests.torch_oracle import OracleRecognitionAV


class TIM(OracleRecognitionAV):
    """The reference recognition TIM's constructor and calls over the
    oracle transcription."""

    def __init__(self, num_class, visual_input_dim, audio_input_dim,
                 d_model, nhead, num_layers, **_):
        (verb, noun, action), audio = num_class
        super().__init__(visual_input_dim, audio_input_dim, d_model, nhead,
                         num_layers, ((verb, noun, action), audio))

    def forward(self, inputs, forward_type, time_encodings=None,
                num_v_queries=0, num_a_queries=0):
        if forward_type == "time_mlp":
            return inputs          # the oracle encodes the times itself
        v, a = inputs
        *logits, _ = super().forward(v, a, time_encodings, num_v_queries,
                                     num_a_queries)
        return logits, None
'''

_PERTURB = '''

    def load_state_dict(self, sd, strict=True):
        out = super().load_state_dict(sd, strict=strict)
        with torch.no_grad():
            self.cls_head.fc_visual_action.bias.add_(1e-2)
        return out
'''


def _oracle_tree(root, perturb):
    pkg = root / "recognition" / "time_interval_machine" / "models"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    src = "import torch\n" + _ORACLE_TIM + (_PERTURB if perturb else "")
    (pkg / "tim.py").write_text(textwrap.dedent(src))
    return root


@pytest.mark.parametrize("perturb", [False, True])
def test_parity_against_an_oracle_tree(perturb, ckpts, tmp_path,
                                       monkeypatch, capsys):
    root = _oracle_tree(tmp_path / "ref", perturb)
    monkeypatch.setattr(PV, "REFERENCE_ROOT", str(root))
    gate = PV.validate(_argv(ckpts, "rec_av", "--skip_contract"),
                       device="cpu")
    out = capsys.readouterr().out
    assert _lines(out)["parity"] == ("FAIL" if perturb else "PASS"), out
    assert re.search(r"parity     (PASS|FAIL)  .*\(cpu,", out), out
    worst = gate.numbers["parity"]["max_logit_diff"]
    assert (worst > 2e-4) if perturb else (worst <= 2e-4)
    assert gate.numbers["parity"]["heads"] == 4


def test_the_loader_copy_equals_the_tests_loader(tmp_path, monkeypatch):
    """The port's ``reference_tim_module`` and ``tests/reference_loader.py``
    import the same tree the same way and leave ``sys.modules`` as they
    found it."""
    import sys

    from tests import reference_loader
    root = _oracle_tree(tmp_path / "ref", False)
    monkeypatch.setattr(PV, "REFERENCE_ROOT", str(root))
    monkeypatch.setattr(reference_loader, "_REF", str(root))
    before = set(sys.modules)
    with PV.reference_tim_module("recognition") as ours, \
            reference_loader.reference_tim_module("recognition") as theirs:
        assert ours.__file__ == theirs.__file__
        assert ours.TIM.__name__ == theirs.TIM.__name__ == "TIM"
    assert not {m for m in set(sys.modules) - before
                if m.startswith("time_interval_machine")}


def test_stages_print_their_device_and_the_gate_defaults_to_the_card(
        ckpts, capsys):
    PV.main(_argv(ckpts, "det_av", "--skip_parity"), device="cpu")
    out = capsys.readouterr().out
    for stage in ("load", "infer", "convert", "parity", "contract"):
        assert re.search(rf"\[validate\] {stage}\s+\w+  .*\(cpu, "
                         rf"[\d.]+ s\)$", out, re.M), (stage, out)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        PV.main(_argv(ckpts, "det_av"))
