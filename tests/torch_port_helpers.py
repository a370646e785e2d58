"""Shared builders for the ``tim_tpu_torch`` parity tests: one small
detection configuration (the JAX package's, and ``port_cfg`` for the
port's copy), flax params for it (perturbed with seeded numpy noise so
that no LayerNorm or bias sits at its trivial init), and the port model
loaded from them, on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tim_tpu import config as C
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models.queries import generate_query_pyramid
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import detection_state_dict_from_jax
from tim_tpu_torch.models import TimDetection


def small_cfg(**overrides):
    kw = dict(d_model=32, num_layers=2, nhead=2, num_feats=6,
              visual_input_dim=16, audio_input_dim=12,
              visual_classes=(11,), audio_classes=5,
              compute_dtype="float32", inference_query_size=0.2)
    kw.update(overrides)
    return C.epic_detection(**kw)


def port_cfg(cfg) -> PC.DetectionConfig:
    """The port's ``DetectionConfig`` with every field of ``cfg`` (a JAX
    package config)."""
    return PC.DetectionConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})


def num_queries(cfg) -> int:
    return generate_query_pyramid(cfg.inference_query_size).shape[0]


@functools.lru_cache(maxsize=None)
def jax_variables(cfg, seed: int = 0):
    """``{'params': tree}`` of numpy leaves for a flax TimDetection
    (cached per configuration: callers must not mutate it)."""
    nq = num_queries(cfg)
    key = jax.random.PRNGKey(seed)
    variables = JaxTimDetection(cfg).init(
        {"params": key, "dropout": key},
        jnp.zeros((1, cfg.num_feats, cfg.visual_input_dim)),
        jnp.zeros((1, cfg.num_feats, cfg.audio_input_dim)),
        jnp.zeros((1, cfg.num_context + 2 * nq, 2)), nq, nq,
        deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape))
        .astype(np.float32), variables["params"])
    return {"params": params}


def port_model(cfg, variables) -> TimDetection:
    model = TimDetection(port_cfg(cfg), device="cpu")
    model.load_state_dict(detection_state_dict_from_jax(variables),
                          strict=True)
    return model


def inference_batch(cfg, batch: int, seed: int = 1):
    """Random dense-inference batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    f = cfg.num_feats
    return {
        "v_feats": rng.normal(size=(batch, f, cfg.visual_input_dim))
        .astype(np.float32),
        "a_feats": rng.normal(size=(batch, f, cfg.audio_input_dim))
        .astype(np.float32),
        "times": np.sort(rng.uniform(0, 1, size=(batch, 2 * f, 2)), -1)
        .astype(np.float32),
        "window_start": (np.arange(batch) * 1.0).astype(np.float32),
        "window_size": np.full(batch, 3.6, np.float32),
    }


def perturbed(variables, seed: int, scale: float = 0.05):
    """``{'params': tree}`` plus seeded numpy noise on every leaf (fp32
    numpy leaves), so that no LayerNorm, bias or head sits at its trivial
    init."""
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=scale, size=x.shape))
        .astype(np.float32), variables["params"])}
