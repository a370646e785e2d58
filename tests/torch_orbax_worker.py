"""One process of ``tests/test_torch_orbax.py``'s two-process JAX save:

    python tests/torch_orbax_worker.py NPROC PID PORT OUTDIR

Each process holds 2 CPU devices; the devices of all processes form a
data x model 2 mesh. A small detection train state (seeded parameters,
one AdamW step on seeded gradients) is placed by JAX's
``PARTITION_RULES`` and saved with ``save_checkpoint_orbax``: each
process writes its shards into ``OUTDIR/orbax/3``. Process 0 then writes
``OUTDIR/leaves.npz``: every leaf of the saved payload, gathered whole,
under its orbax name (the tree path joined by ``.``).
"""

import sys


def main():
    nproc, pid, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}", num_processes=nproc,
            process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from flax import serialization

    from tim_tpu import config as C
    from tim_tpu.models import TimDetection
    from tim_tpu.models import queries as Q
    from tim_tpu.parallel import make_mesh, shard_train_state
    from tim_tpu.train import checkpoint as ckpt
    from tim_tpu.train.optim import make_optimizer
    from tim_tpu.train.state import create_train_state

    cfg = C.DetectionConfig(
        visual_classes=(4,), audio_classes=3, visual_input_dim=24,
        audio_input_dim=16, d_model=16, nhead=2, num_layers=2, num_feats=8,
        train_query_size=0.1, inference_query_size=0.2,
        compute_dtype="float32")
    nq = Q.generate_query_pyramid(cfg.inference_query_size).shape[0]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: TimDetection(cfg).init(
        {"params": key, "dropout": key},
        jnp.zeros((1, cfg.num_feats, cfg.visual_input_dim)),
        jnp.zeros((1, cfg.num_feats, cfg.audio_input_dim)),
        jnp.zeros((1, cfg.num_context + 2 * nq, 2)), nq, nq,
        deterministic=True))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    grads = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    state = create_train_state(params, make_optimizer(1e-3, 1e-4, 10, 2),
                               normaliser=3.0)
    state = state.apply_gradients(grads=grads)
    state = shard_train_state(state, make_mesh(-1, 2))
    ckpt.save_checkpoint_orbax(out, state, epoch=3, extra={"loss": 0.5})

    payload = {"params": state.params,
               "opt_state": serialization.to_state_dict(state.opt_state),
               "step": state.step, "normaliser": state.normaliser}
    flat = jax.tree_util.tree_flatten_with_path(payload)[0]
    leaves = multihost_utils.process_allgather([v for _, v in flat],
                                               tiled=True)
    if jax.process_index() == 0:
        names = [".".join(str(getattr(k, "key", k)) for k in path)
                 for path, _ in flat]
        np.savez(f"{out}/leaves.npz",
                 **{n: np.asarray(v) for n, v in zip(names, leaves)})


if __name__ == "__main__":
    main()
