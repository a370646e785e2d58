"""Data parallelism of the port over ``torch.distributed`` on the CPU:
two ranks over gloo, each a subprocess with its own timeout
(``tests/torch_parallel_worker.py``), against the JAX package's
single-device step on the global batch and against the port in one
process:

- one recognition train step (mixup 0.4 and drloc 0.3, JAX's draws handed
  in) and one detection train step (drloc 0.3) on a global batch of 8
  split 4 + 4, dropout off, the valid label counts and the positive
  counts deliberately unequal between the ranks: the loss within 1e-4
  relative of JAX's, every parameter within atol 1e-4 / rtol 1e-3 (as
  ``tests/test_parallel.py``), the detection normaliser equal on both
  ranks and to JAX's;
- ``RecognitionRunner`` validate, one epoch, validate with 1 and 2
  processes, host and banked paths: accuracies within 1e-6, losses
  within 5e-3 relative (as ``tests/test_multihost.py``);
- ``DetectionRunner``'s top-2 dense dump with 1 and 2 processes: the same
  rows, top-k values within 1e-5;
- ``cli.run --train`` with ``--num_shards 2 --shard_id r --init_method
  localhost:PORT --mesh_data 2`` (the command line joins the group) against
  the same command line in one process, as the runners; rank 0 alone writes
  the checkpoint;
- the host helpers against numpy, the collective count, the mesh's
  refusals (a model axis that does not divide one process), the draws of
  a rank's rows, ``MeshConfig``; a group of one rank leaves a run
  bit-equal to the run without a group.
"""

import dataclasses
import os
import subprocess
import sys

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
from tim_tpu.train import detection as jdet
from tim_tpu.train import recognition as jrec
from tim_tpu.train.optim import make_optimizer as jax_make_optimizer
from tim_tpu.train.state import create_train_state as jax_train_state
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import (
    detection_state_dict_from_jax, recognition_state_dict_from_jax)
from tim_tpu_torch.ops.dropout import BatchRows, dropout
from tim_tpu_torch.parallel import mesh as pmesh
from tim_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
RANKS = 2
GLOBAL_BATCH = 8
TOTAL_STEPS, WARMUP_STEPS = 100, 10       # tests/test_parallel.py's recipe
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models of this file on one CPU thread (as the ranks run):
    beside other test processes, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recognition_case():
    """(port case, JAX reference thunk): one step of a small one-layer
    ``epic_recognition`` on 8 windows, rank 1's rows (4-7) holding fewer
    valid verb / noun / action / audio labels than rank 0's."""
    cfg, pcfg = trec._train_cfgs("epic_recognition", num_layers=1)
    tcfg = C.TrainConfig(lambda_drloc=0.3, mixup_alpha=0.4, lr=1e-3)
    nv, na = trec._queries(cfg)
    batch = trec.rec_batch(cfg, b=GLOBAL_BATCH, nv=nv, na=na)
    for k in ("verb", "noun", "action", "class_id"):
        batch[k][4:, 1:] = -1
        batch[k][6:, 0] = -1
    variables = trec.rec_variables(cfg)
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
                recognition_state_dict_from_jax({"params": jstate.params}),
                None)

    return case, reference


def _detection_case():
    """(port case, JAX reference thunk): one step of a small one-layer
    ``epic_detection`` on 8 windows, rank 1's rows keeping one GT segment
    where rank 0's keep three (fewer positives)."""
    cfg = tdet._det_cfg(num_layers=1)
    tcfg = C.TrainConfig(lambda_drloc=0.3, normaliser_init=250.0, lr=1e-3)
    batch = tdet._train_batch(cfg, b=GLOBAL_BATCH)
    for k in ("verb", "noun", "action", "class_id"):
        batch[k][4:, 1:] = -1
    batch["v_gt_segments"][4:, 1:] = 0.0
    batch["a_gt_segments"][4:, 1:] = 0.0
    variables = tdet.jax_variables(cfg)
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
                detection_state_dict_from_jax({"params": jstate.params}),
                float(jstate.normaliser))

    return case, reference


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' results (one launch for every case) and the JAX
    references, computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("ranks")
    cases, references = {}, {}
    for kind, make in (("recognition", _recognition_case),
                       ("detection", _detection_case)):
        cases[kind], references[kind] = make()
    inputs = tmp / "inputs.pt"
    torch.save(cases, inputs)
    port = str(worker.free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(RANKS), str(r), port, str(inputs),
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(RANKS)]
    logs = []
    try:
        want = {kind: ref() for kind, ref in references.items()}
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
    return {"ranks": ranks, "jax": want, "cases": cases}


@pytest.mark.parametrize("kind", ["recognition", "detection"])
def test_train_step_on_two_ranks_equals_jax_on_the_global_batch(two_ranks,
                                                                  kind):
    want_metrics, want_params, want_norm = two_ranks["jax"][kind]
    case = two_ranks["cases"][kind]
    got = [r[f"{kind}_step"] for r in two_ranks["ranks"]]
    # the ranks' label / positive counts differ: the point of the test
    labels = case["batch"]["action"]
    assert (labels[:4] >= 0).sum() > (labels[4:] >= 0).sum()
    for rank in got:
        assert sorted(rank["metrics"]) == sorted(want_metrics)
        for k, want in want_metrics.items():
            np.testing.assert_allclose(rank["metrics"][k], want,
                                       rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
        assert sorted(rank["params"]) == sorted(want_params)
        for name, want in want_params.items():
            np.testing.assert_allclose(
                rank["params"][name].numpy(), want.numpy(), atol=PARAM_ATOL,
                rtol=PARAM_RTOL, err_msg=name)
    # every rank took the same update and holds the same normaliser
    for name in want_params:
        assert torch.equal(got[0]["params"][name], got[1]["params"][name])
    assert got[0]["normaliser"] == got[1]["normaliser"]
    if want_norm is not None:
        np.testing.assert_allclose(got[0]["normaliser"], want_norm,
                                   rtol=1e-6)
        assert got[0]["metrics"]["num_pos_visual"] == \
            want_metrics["num_pos_visual"]


def test_train_steps_run_collectives(two_ranks):
    """A train step's collectives: recognition gathers the batch's inputs
    and labels, then sums the gradients and loss shares in one bucketed
    all_reduce; detection sums the positive counts, then the gradients."""
    for rank in two_ranks["ranks"]:
        assert rank["detection_step_collectives"] == 2
        assert rank["recognition_step_collectives"] >= 3


@pytest.mark.parametrize("tag", ["host", "bank"])
def test_recognition_runner_two_processes_match_one(two_ranks, tag):
    single = worker.recognition_runner_stats(tag == "bank")
    for rank in two_ranks["ranks"]:
        double = rank[f"recognition_runner_{tag}"]
        assert sorted(double) == sorted(single)
        for k, want in single.items():
            if "top" in k:
                np.testing.assert_allclose(double[k], want, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(double[k], want, rtol=5e-3,
                                           err_msg=k)


@pytest.mark.parametrize("tag", ["host", "bank"])
def test_detection_dump_two_processes_match_one(two_ranks, tag):
    single = worker.detection_runner_digest(tag == "bank")
    for rank in two_ranks["ranks"]:
        double = rank[f"detection_runner_{tag}"]
        assert double["n_rows"] == single["n_rows"] > 0
        assert double["video_ids"] == single["video_ids"]
        np.testing.assert_allclose(double["action_topk_values"],
                                   single["action_topk_values"], atol=1e-5)
        np.testing.assert_allclose(double["v_proposals"],
                                   single["v_proposals"], atol=1e-5)
        for k in single:
            if k.startswith(("pre_loss", "post_loss")):
                np.testing.assert_allclose(double[k], single[k], rtol=5e-3,
                                           err_msg=k)
    assert (two_ranks["ranks"][0][f"detection_runner_{tag}"]["normaliser"]
            == two_ranks["ranks"][1][f"detection_runner_{tag}"]["normaliser"])


def test_cli_with_two_shards_matches_one_process(two_ranks, tmp_path):
    single = worker.cli_recognition_stats(tmp_path)
    assert os.path.exists(tmp_path / "checkpoint.pt")
    for r, rank in enumerate(two_ranks["ranks"]):
        assert rank["cli_group"] == RANKS
        assert rank["cli_checkpoint"] == (r == 0)
        double = rank["cli_recognition"]
        assert sorted(double) == sorted(single) and single
        for k, want in single.items():
            if "top" in k:
                np.testing.assert_allclose(double[k], want, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(double[k], want, rtol=5e-3,
                                           err_msg=k)


def test_host_helpers_over_gloo_match_numpy(two_ranks):
    per_rank = [np.arange(6, dtype=np.float64).reshape(2, 3) + 10 * r
                for r in range(RANKS)]
    for r, rank in enumerate(two_ranks["ranks"]):
        h = rank["helpers"]
        np.testing.assert_array_equal(h["gather"],
                                      np.concatenate(per_rank))
        assert h["gather"].dtype == np.float64
        np.testing.assert_array_equal(
            h["gather_bool"], [True, True, False, False, True, False])
        assert h["gather_bool"].dtype == np.bool_
        np.testing.assert_array_equal(h["gather_int"], [0, 0, 1, -1])
        assert h["scalars"] == {"a": 1.5, "b": 1.0}
        np.testing.assert_array_equal(h["sum"], sum(per_rank))
        np.testing.assert_array_equal(h["max"], [1, 0, 7])
        assert h["count"] == RANKS and h["master"] == (r == 0)
        assert rank["helper_collectives"] == 7


def test_helpers_are_the_identity_without_a_group():
    assert not multihost.initialized()
    x = np.arange(4.0)
    assert multihost.allgather_host_arrays(x) is x
    assert multihost.allreduce_host_array(x, "max") is x
    assert multihost.allreduce_host_scalars({"a": 2}) == {"a": 2.0}
    assert multihost.process_count() == 1 and multihost.is_master()
    multihost.initialize("localhost:1", 1, 0, device="cpu")   # one: nothing
    assert not multihost.initialized()


def test_mesh_refuses_what_one_process_per_card_cannot_run():
    """A model axis that does not divide the processes and a data axis
    other than -1 or their count over it raise; ``make_mesh(-1, 2)`` runs
    over two ranks (``tests/test_torch_tensor_parallel.py``)."""
    with pytest.raises(ValueError, match="must divide the process count"):
        pmesh.make_mesh(-1, 2)
    with pytest.raises(ValueError, match="one process per card"):
        pmesh.make_mesh(3, 1)
    mesh = pmesh.make_mesh(1, 1)
    assert (mesh.shape, mesh.rows(4), mesh.distributed) == (
        {"data": 1, "model": 1}, (0, 4), False)
    batch = pmesh.shard_batch({"x": np.ones((2, 3), np.float32)}, "cpu")
    assert batch["x"].shape == (2, 3)
    assert pmesh.host_local_rows(batch["x"]) is batch["x"]
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("localhost:1", 2, 2, device="cpu")


def test_mesh_config_copy_equals_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(PC.MeshConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(C.MeshConfig)])


@pytest.mark.parametrize("bits", [32, 8])
def test_a_rank_draws_its_rows_of_the_global_masks(bits):
    """``BatchRows``: rank r's dropout mask is rows [r*b, (r+1)*b) of the
    mask drawn for the global batch from the same seed."""
    x = torch.ones(8, 5, 7)
    full = dropout(x, 0.3, False, bits, torch.Generator().manual_seed(3))
    for r in range(2):
        part = dropout(x[:4], 0.3, False, bits,
                       BatchRows(torch.Generator().manual_seed(3), 4 * r, 8))
        assert torch.equal(part, full[4 * r:4 * r + 4])


def test_a_group_of_one_rank_leaves_the_runs_bit_equal():
    """Through the distributed path (collectives and all) with one rank,
    training, validation and the dump equal the run without a group."""
    plain = (worker.detection_runner_digest(True),
             worker.recognition_runner_stats(False))
    multihost.collective.calls = 0
    worker.join_group_of_one("gloo")
    try:
        grouped = (worker.detection_runner_digest(True),
                   worker.recognition_runner_stats(False))
        calls = multihost.collective.calls
    finally:
        multihost.finalize()
    assert calls > 0
    for got, want in zip(grouped, plain):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
