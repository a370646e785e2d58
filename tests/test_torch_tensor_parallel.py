"""Tensor and sequence parallelism of the port over a model axis of
processes, on the CPU: two gloo ranks at data 1 x model 2, each a
subprocess with its own timeout (``tests/torch_parallel_worker.py``,
``model2``), spawned once for the module, at the widths of
``tests/test_parallel.py`` (d_model 32, 4 heads, 2 layers, recognition
S = 24):

- one recognition and one detection train step with sequence parallelism
  off and on, JAX's draws handed in, dropout off, against the JAX
  package's single-device step on the global batch of 8: the loss within
  1e-4 relative, every parameter within atol 1e-4 / rtol 1e-3 (as
  ``tests/test_parallel.py``); the gradients of replicated parameters
  equal on both model ranks;
- the same steps with dropout 0.1 and ``remat`` on, against the port in
  one process: the loss within 1e-5 relative, every parameter within atol
  1e-4 / rtol 1e-3 (every mask is drawn at the global shape and sliced);
  so too encoders whose heads or FFN width model 2 does not divide (that
  region replicated);
- the sharding rules: the port's slices for a model axis of 2 equal JAX's
  ``param_shardings`` specs element for element (13- and 97-class heads
  replicated, divisible ones sharded);
- ``cli.run --num_shards 2 --mesh_model 2 --sequence_parallel true``
  against the same command line in one process;
- a checkpoint saved under model 2 resumes bit-equal under model 1 and
  loads strictly into a one-process ``TimDetection``, and the other way
  round; a JAX-written msgpack checkpoint, and the same state as a JAX
  orbax directory, resumed by the two ranks (each keeps its slices of the
  parameters and moments) take the step that one process takes from
  them;
- ``dryrun_multichip(4, device="cpu")``: data 2 x model 2 with sequence
  parallelism, every rank equal to one process.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_detection_train as tdet
from tests import test_torch_recognition as trec
from tests import torch_parallel_worker as worker
from tests.torch_port_helpers import port_cfg, port_train_cfg
from tim_tpu import config as C
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models import TimRecognition as JaxTimRecognition
from tim_tpu.models import queries as JQ
from tim_tpu.parallel import mesh as jmesh
from tim_tpu.train import checkpoint as jckpt
from tim_tpu.train import detection as jdet
from tim_tpu.train import recognition as jrec
from tim_tpu.train.optim import make_optimizer as jax_make_optimizer
from tim_tpu.train.state import create_train_state as jax_train_state
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import (
    detection_params_to_jax, detection_state_dict_from_jax,
    recognition_state_dict_from_jax)
from tim_tpu_torch.dryrun import dryrun_multichip
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.parallel import mesh as pmesh
from tim_tpu_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
RANKS = 2
GLOBAL_BATCH = 8
TOTAL_STEPS, WARMUP_STEPS = 100, 10       # tests/test_parallel.py's recipe
LOSS_RTOL = 1e-4
DROPOUT_LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
WIDTHS = dict(d_model=32, nhead=4, num_layers=2, num_feats=8,
              visual_input_dim=32, audio_input_dim=24)
# encoders whose heads (3) or FFN width (33 x 3) model 2 does not divide:
# that region stays replicated, the other is sharded
REPLICATED_REGIONS = {
    "replicated_heads": dict(d_model=48, nhead=3),
    "replicated_ffn": dict(d_model=33, nhead=2, feedforward_scale=3)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models of this file on one CPU thread (as the ranks run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dropout(rate: float, remat: bool) -> dict:
    return dict(enc_dropout=rate, feat_dropout=rate, seq_dropout=rate,
                remat=remat)


def _recognition_case(rate=0.0, remat=False, **widths):
    """(port case, JAX reference thunk): one step of a recognition model
    at ``WIDTHS`` (updated by ``widths``) on 8 windows with 2 + 2 queries
    (S = 24); 9 verbs and 11 nouns stay replicated over model 2, 16
    actions and 8 sounds shard."""
    cfg, pcfg = trec.rec_cfgs("epic_recognition", visual_classes=(9, 11, 16),
                              audio_classes=8, **{**WIDTHS, **widths},
                              **_dropout(rate, remat))
    tcfg = C.TrainConfig(lambda_drloc=0.3, mixup_alpha=0.4, lr=1e-3)
    nv, na = 2, 2
    batch = trec.rec_batch(cfg, b=GLOBAL_BATCH, nv=nv, na=na)
    variables = trec.rec_variables(dataclasses.replace(
        cfg, **_dropout(0.0, False)))
    rng = jax.random.PRNGKey(5)
    d = trec.jax_draws(cfg, tcfg, rng)(0, GLOBAL_BATCH)
    case = dict(cfg=dataclasses.asdict(pcfg),
                tcfg=dataclasses.asdict(port_train_cfg(tcfg)),
                state_dict=recognition_state_dict_from_jax(variables),
                batch=batch, nv=nv, na=na, total_steps=TOTAL_STEPS,
                warmup_steps=WARMUP_STEPS,
                draws=dict(perm=d.perm, lam=d.lam, drloc=d.drloc))

    def reference():
        jstate = jax_train_state(variables["params"], jax_make_optimizer(
            tcfg.lr, tcfg.weight_decay, TOTAL_STEPS, WARMUP_STEPS,
            min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm))
        jstep = jax.jit(jrec.make_train_step(JaxTimRecognition(cfg), cfg,
                                             tcfg, nv, na))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, rng)
        return ({k: float(v) for k, v in jm.items()},
                recognition_state_dict_from_jax({"params": jstate.params}))

    return case, reference


def _detection_case(rate=0.0, remat=False):
    """(port case, JAX reference thunk): one step of a detection model at
    ``WIDTHS`` on 8 windows; 13 verbs stay replicated over model 2, 8
    sounds shard."""
    cfg = tdet._det_cfg(visual_classes=(13,), audio_classes=8, **WIDTHS)
    variables = tdet.jax_variables(cfg)
    cfg = dataclasses.replace(cfg, **_dropout(rate, remat))
    tcfg = C.TrainConfig(lambda_drloc=0.3, normaliser_init=250.0, lr=1e-3)
    batch = tdet._train_batch(cfg, b=GLOBAL_BATCH)
    rng = jax.random.PRNGKey(5)
    nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]
    d = tdet._jax_draws(cfg, tcfg, rng, nq)(0, GLOBAL_BATCH)
    case = dict(cfg=dataclasses.asdict(port_cfg(cfg)),
                tcfg=dataclasses.asdict(port_train_cfg(tcfg)),
                state_dict=detection_state_dict_from_jax(variables),
                batch=batch, total_steps=TOTAL_STEPS,
                warmup_steps=WARMUP_STEPS,
                draws=dict(v_queries=d.v_queries, a_queries=d.a_queries,
                           drloc=d.drloc))

    def reference():
        jstate = jax_train_state(variables["params"], jax_make_optimizer(
            tcfg.lr, tcfg.weight_decay, TOTAL_STEPS, WARMUP_STEPS,
            min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm),
            normaliser=tcfg.normaliser_init)
        jstep = jax.jit(jdet.make_train_step(JaxTimDetection(cfg), cfg,
                                             tcfg))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, rng)
        return ({k: float(v) for k, v in jm.items()},
                detection_state_dict_from_jax({"params": jstate.params}))

    return case, reference


def _jax_checkpoint(case, path, orbax=False):
    """A msgpack checkpoint of the detection ``case``'s model written by
    the JAX package (``save_checkpoint``; with ``orbax``, an orbax one,
    ``save_checkpoint_orbax``): its weights perturbed, Adam moments drawn
    (nu > 0), 3 updates and 1 skip counted."""
    from flax import serialization
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda t: (np.asarray(t) + rng.normal(scale=0.01, size=t.shape))
        .astype(np.float32), detection_params_to_jax(case["state_dict"]))
    state = jax_train_state(params, jax_make_optimizer(
        1e-3, 0.0, TOTAL_STEPS, WARMUP_STEPS))
    sd = serialization.to_state_dict(state.opt_state)
    adam = sd["inner_state"]["1"]["0"]
    adam["mu"] = jax.tree_util.tree_map(
        lambda p: rng.normal(scale=1e-3, size=p.shape).astype(np.float32),
        params)
    adam["nu"] = jax.tree_util.tree_map(
        lambda p: rng.uniform(1e-8, 1e-6, p.shape).astype(np.float32),
        params)
    adam["count"] = sd["inner_state"]["1"]["2"]["count"] = np.int32(3)
    sd["total_notfinite"] = np.int32(1)
    state = state.replace(
        step=jnp.int32(4), normaliser=jnp.float32(200.0),
        opt_state=serialization.from_state_dict(state.opt_state, sd))
    if orbax:
        jckpt.save_checkpoint_orbax(path, state, epoch=2)
    else:
        jckpt.save_checkpoint(path, state, epoch=2)


def _sequence_parallel(case):
    return {**case, "cfg": {**case["cfg"], "sequence_parallel": True}}


def _rules_cfgs():
    """(JAX config, port config) by name: ``tests/test_parallel.py``'s two
    recognition configurations (13 actions: replicated; 16/32/64 + 8:
    sharded) and EPIC detection's class counts at small width (97 verbs
    replicated; 300 nouns, 3806 actions, 44 sounds sharded)."""
    small = dict(d_model=32, nhead=4, num_layers=1, num_feats=8,
                 visual_input_dim=32, audio_input_dim=24,
                 compute_dtype="float32")
    rec = {name: C.ModelConfig(visual_classes=vc, audio_classes=ac, **small)
           for name, vc, ac in (("rec_13", (9, 11, 13), 7),
                                ("rec_64", (16, 32, 64), 8))}
    det = C.epic_detection(visual_classes=(97, 300, 3806), audio_classes=44,
                           inference_query_size=0.2, **small)
    return {**{n: ("recognition", c, PC.ModelConfig(**dataclasses.asdict(c)))
               for n, c in rec.items()},
            "det_epic": ("detection", det, port_cfg(det))}


@pytest.fixture(scope="module")
def model_ranks(tmp_path_factory):
    """The two ranks' results (one launch for every case), the JAX
    references and the port's one-process runs, computed while the ranks
    run."""
    tmp = tmp_path_factory.mktemp("model_ranks")
    steps, references = {}, {}
    for kind, make in (("recognition", _recognition_case),
                       ("detection", _detection_case)):
        case, references[kind] = make()
        steps[f"{kind}_tp"] = (kind, case)
        steps[f"{kind}_sp"] = (kind, _sequence_parallel(case))
        steps[f"{kind}_dropout"] = (kind, _sequence_parallel(
            make(0.1, True)[0]))
    for name, widths in REPLICATED_REGIONS.items():
        steps[name] = ("recognition", _sequence_parallel(
            _recognition_case(0.1, False, **widths)[0]))
    one = pmesh.make_mesh(1, 1)
    # a checkpoint of one process, for the ranks to resume and save again
    worker.train_step_case("detection", steps["detection_tp"][1], one,
                           save_to=str(tmp / "ckpt_one"))
    _jax_checkpoint(steps["detection_sp"][1], str(tmp / "ckpt_jax"))
    _jax_checkpoint(steps["detection_sp"][1], str(tmp / "ckpt_jax_orbax"),
                    orbax=True)
    rules = _rules_cfgs()
    inputs = tmp / "inputs.pt"
    torch.save({"steps": steps, "save": "detection_sp",
                "resave_from": str(tmp / "ckpt_one"),
                "jax_resume_from": str(tmp / "ckpt_jax"),
                "jax_orbax_resume_from": str(tmp / "ckpt_jax_orbax"),
                "rules": {n: (kind, dataclasses.asdict(pcfg))
                          for n, (kind, _, pcfg) in rules.items()}}, inputs)
    port = str(worker.free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(RANKS), str(r), port, str(inputs),
         str(tmp), "model2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(RANKS)]
    logs = []
    try:
        want = {kind: ref() for kind, ref in references.items()}
        single = {name: worker.train_step_case(kind, case, one)
                  for name, (kind, case) in steps.items()
                  if name.endswith("_dropout") or name in REPLICATED_REGIONS}
        single["jax_resume"] = worker.train_step_case(
            *steps["detection_sp"], one, resume_from=str(tmp / "ckpt_jax"))
        single["jax_orbax_resume"] = worker.train_step_case(
            *steps["detection_sp"], one,
            resume_from=str(tmp / "ckpt_jax_orbax"))
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    return {"ranks": ranks, "jax": want, "single": single, "steps": steps,
            "rules": rules, "tmp": tmp}


def _params_close(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["tp", "sp"])
@pytest.mark.parametrize("kind", ["recognition", "detection"])
def test_train_step_at_model_2_equals_jax_on_the_global_batch(
        model_ranks, kind, layout):
    want_metrics, want_params = model_ranks["jax"][kind]
    got = [r[f"{kind}_{layout}"] for r in model_ranks["ranks"]]
    for rank in got:
        assert rank["sharded"], "nothing sharded"
        assert rank["tokens_sharded"] == (layout == "sp")
        np.testing.assert_allclose(rank["metrics"]["loss"],
                                   want_metrics["loss"], rtol=LOSS_RTOL,
                                   atol=1e-9)
        for k, want in want_metrics.items():
            np.testing.assert_allclose(rank["metrics"][k], want,
                                       rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
        _params_close(rank["params"], want_params)
    for name in want_params:
        assert torch.equal(got[0]["params"][name], got[1]["params"][name])
    # the steps ran collectives over the model axis
    assert min(r["collectives"] for r in got) > 0


@pytest.mark.parametrize("layout", ["tp", "sp", "dropout"])
@pytest.mark.parametrize("kind", ["recognition", "detection"])
def test_replicated_gradients_equal_on_both_model_ranks(model_ranks, kind,
                                                        layout):
    """Under sequence parallelism the norms' gradients are partial per
    token shard until the step sums them over the model group: after it
    every replicated parameter's gradient is the same on both ranks; a
    sharded one is each rank's slice."""
    first, second = (r[f"{kind}_{layout}"] for r in model_ranks["ranks"])
    replicated = sorted(set(first["grads"]) - set(first["sharded"]))
    assert replicated and first["sharded"]
    for name in replicated:
        assert torch.equal(first["grads"][name], second["grads"][name]), name
    for name, (dim, _) in first["sharded"].items():
        full = first["params"][name].shape
        assert first["grads"][name].shape[dim] * RANKS == full[dim], name


@pytest.mark.parametrize("kind", ["recognition", "detection"])
def test_dropout_and_remat_at_model_2_equal_one_process(model_ranks, kind):
    """Dropout 0.1 on every site and ``remat`` on, sequence parallelism
    on: each mask drawn at the global shape and sliced (rows, heads, FFN
    columns, tokens), so the ranks draw what one process draws."""
    single = model_ranks["single"][f"{kind}_dropout"]
    for rank in model_ranks["ranks"]:
        got = rank[f"{kind}_dropout"]
        for k, want in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=DROPOUT_LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        _params_close(got["params"], single["params"])
    # dropout moved the loss: the masks are not all ones
    no_drop = model_ranks["ranks"][0][f"{kind}_sp"]["metrics"]["loss"]
    assert abs(single["metrics"]["loss"] - no_drop) > 1e-4


@pytest.mark.parametrize("name", sorted(REPLICATED_REGIONS))
def test_replicated_encoder_regions_at_model_2_equal_one_process(
        model_ranks, name):
    """A head count or FFN width that model 2 does not divide stays
    replicated, as in JAX, beside the sharded region; with sequence
    parallelism and dropout the step equals one process's."""
    single = model_ranks["single"][name]
    replicated = ("self_attn.in_proj_weight" if name == "replicated_heads"
                  else "linear1.weight")
    for rank in model_ranks["ranks"]:
        got = rank[name]
        assert got["tokens_sharded"]
        assert not any(replicated in n for n in got["sharded"])
        assert any("layers.0." in n for n in got["sharded"])
        for k, want in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=DROPOUT_LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        _params_close(got["params"], single["params"])
    first, second = (r[name]["grads"] for r in model_ranks["ranks"])
    for n in set(first) - set(model_ranks["ranks"][0][name]["sharded"]):
        assert torch.equal(first[n], second[n]), n


def _owner_map(params, shardings):
    """Each leaf of ``params`` (shapes) as an array of the model rank that
    holds each element under ``shardings`` (-1: every rank)."""
    def owner(leaf, sh):
        out = -np.ones(leaf.shape, np.float32)
        spec = tuple(sh.spec)
        if "model" in spec:
            dim = spec.index("model")
            n = leaf.shape[dim]
            idx = np.arange(n) // (n // 2)
            shape = [1] * len(leaf.shape)
            shape[dim] = n
            out[...] = idx.reshape(shape)
        return out
    return jax.tree_util.tree_map(owner, params, shardings)


@pytest.mark.parametrize("name", ["rec_13", "rec_64", "det_epic"])
def test_sharding_rules_equal_jax_param_shardings(model_ranks, name):
    kind, cfg, pcfg = model_ranks["rules"][name]
    nf = cfg.num_feats
    if kind == "recognition":
        model, convert, nv = JaxTimRecognition(cfg), \
            recognition_state_dict_from_jax, 3
        times = jnp.zeros((1, cfg.num_context + nv + 2, 2))
        args = (nv, 2)
    else:
        model, convert = JaxTimDetection(cfg), detection_state_dict_from_jax
        nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]
        times = jnp.zeros((1, 2 * nf + 2 * nq, 2))
        args = (nq, nq)
    k = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: model.init(
        {"params": k, "dropout": k}, jnp.zeros((1, nf, cfg.visual_input_dim)),
        jnp.zeros((1, nf, cfg.audio_input_dim)), times, *args,
        deterministic=True))["params"]
    shardings = jmesh.param_shardings(params, jmesh.make_mesh(1, 2))
    owners = convert({"params": _owner_map(params, shardings)})
    full = {n: tuple(t.shape) for n, t in owners.items()}
    specs = pmesh.param_specs(full, 2)
    for n, t in owners.items():
        assert (n in specs) == bool((t >= 0).any()), n
    for r, rank in enumerate(model_ranks["ranks"]):
        local = rank["rules"][name]
        assert sorted(local) == sorted(owners)
        fake = types.SimpleNamespace(model_size=2, model_rank=r)
        for n, t in owners.items():
            if n not in specs:
                assert local[n] == full[n], n
                continue
            mine = pmesh.Mesh.local_slice(fake, t, *specs[n])
            assert local[n] == tuple(mine.shape), n
            assert bool((mine == r).all()), n
    heads = {n.split(".")[1] for n in specs if n.startswith("cls_head.")}
    expected = {"rec_13": {"fc_visual_verb": False, "fc_visual_noun": False,
                           "fc_visual_action": False,
                           "fc_audio_action": False},
                "rec_64": {"fc_visual_verb": True, "fc_visual_noun": True,
                           "fc_visual_action": True,
                           "fc_audio_action": True},
                "det_epic": {"fc_visual_verb": False,
                             "fc_visual_noun": True,
                             "fc_visual_action": True,
                             "fc_audio_action": True}}[name]
    assert {h: h in heads for h in expected} == expected
    assert any(".self_attn.in_proj_weight" in n for n in specs)
    assert any(".linear2.weight" in n for n in specs)


def test_cli_with_a_model_axis_matches_one_process(model_ranks, tmp_path):
    """``--num_shards 2 --mesh_model 2 --sequence_parallel true`` (the
    command line joins the group) against the same run in one process."""
    single = worker.cli_recognition_stats(tmp_path)
    for rank in model_ranks["ranks"]:
        assert rank["mesh"][0] == {"data": 1, "model": 2}
        double = rank["cli"]
        assert sorted(double) == sorted(single) and single
        for k, want in single.items():
            np.testing.assert_allclose(double[k], want, rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=k)
    assert {r["mesh"][2] for r in model_ranks["ranks"]} == {0, 1}


def _assert_payload_equal(got, want, path="payload"):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), path
        for k in want:
            _assert_payload_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_payload_equal(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def test_checkpoint_saved_under_model_2_resumes_bit_equal_under_model_1(
        model_ranks, tmp_path):
    """The ranks' checkpoint (gathered, rank 0 wrote it) after a step with
    sequence parallelism: it holds the ranks' whole parameters, loads
    strictly into a one-process ``TimDetection``, and a one-process state
    resumed from it saves it again bit for bit."""
    saved = ckpt.load_checkpoint(str(model_ranks["tmp"] / "ckpt_detection_sp"))
    kind, case = model_ranks["steps"]["detection_sp"]
    for name, t in model_ranks["ranks"][0]["detection_sp"]["params"].items():
        assert torch.equal(saved["params"][name], t), name
    TimDetection(PC.DetectionConfig(**case["cfg"]), device="cpu") \
        .load_state_dict(saved["params"], strict=True)
    worker.resave_case(kind, case, pmesh.make_mesh(1, 1),
                       str(model_ranks["tmp"] / "ckpt_detection_sp"),
                       str(tmp_path))
    _assert_payload_equal(ckpt.load_checkpoint(str(tmp_path)), saved)


def test_checkpoint_saved_under_model_1_resumes_bit_equal_under_model_2(
        model_ranks):
    """A one-process checkpoint resumed by the two ranks (each keeps its
    slices) and saved by them again (gathered) is the same file."""
    tmp = model_ranks["tmp"]
    _assert_payload_equal(ckpt.load_checkpoint(str(tmp / "ckpt_resaved")),
                          ckpt.load_checkpoint(str(tmp / "ckpt_one")))


def test_jax_msgpack_checkpoint_resumes_under_model_2_as_in_one_process(
        model_ranks):
    """The JAX package's ``checkpoint.msgpack`` of the detection model,
    resumed by the two ranks (each keeps its slices of the parameters and
    moments) and stepped with sequence parallelism: the loss, normaliser
    and parameters of the step one process takes from the same file."""
    single = model_ranks["single"]["jax_resume"]
    for rank in model_ranks["ranks"]:
        got = rank["jax_resume"]
        assert got["sharded"]
        for k, want in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["normaliser"], single["normaliser"],
                                   rtol=LOSS_RTOL)
        _params_close(got["params"], single["params"])
    # the step started from the file, not from the case's weights
    fresh = model_ranks["ranks"][0]["detection_sp"]["params"]
    assert not all(torch.equal(t, fresh[n])
                   for n, t in single["params"].items())


def test_jax_orbax_checkpoint_resumes_under_model_2_as_in_one_process(
        model_ranks):
    """The same JAX state as an orbax directory (``orbax/2``, no
    ``checkpoint.msgpack`` beside it): one process steps from it exactly
    as from the msgpack file, and the two ranks (each keeps its slices)
    take the step one process takes."""
    single = model_ranks["single"]["jax_orbax_resume"]
    from_msgpack = model_ranks["single"]["jax_resume"]
    assert single["metrics"] == from_msgpack["metrics"]
    assert single["normaliser"] == from_msgpack["normaliser"]
    for name, t in from_msgpack["params"].items():
        assert torch.equal(single["params"][name], t), name
    for rank in model_ranks["ranks"]:
        got = rank["jax_orbax_resume"]
        assert got["sharded"]
        for k, want in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["normaliser"], single["normaliser"],
                                   rtol=LOSS_RTOL)
        _params_close(got["params"], single["params"])


def test_dryrun_multichip_four_ranks_on_the_cpu():
    summary = dryrun_multichip(4, device="cpu", timeout=600)
    assert (summary["data"], summary["model"],
            summary["sequence_parallel"]) == (2, 2, True)
    assert summary["max_error"] <= 1e-3
