"""Optimizer and learning-rate schedule: counterpart of
``tim_tpu/train/optim.py``.

``warmup_cosine_schedule`` is a copy in plain Python floats (the backbone
runners set each param group's lr from it on the host).
``make_optimizer`` is the TIM recipe, ``optax.apply_if_finite(chain(
clip_by_global_norm, adamw), max_consecutive_errors=8)``, as one torch
optimizer (``AdamWIfFinite``) whose every decision stays on the device:
no step reads a value back to the host.

On a model axis (parameters of which each model rank holds a slice
carry the mesh as ``model_mesh``: ``models.tim``) the global norm sums
the squares of the sharded gradients over the model ranks and counts the
replicated ones once, and a non-finite gradient on any rank skips the
step on all (one ``all_reduce`` of both), so that the ranks clip by one
norm and skip together.

``if_finite_to_optax`` / ``if_finite_from_optax`` map an
``AdamWIfFinite`` state dict onto the ``flax.serialization.
to_state_dict`` layout of the JAX package's optimizer state and back
(the JAX package's msgpack checkpoints, ``train.checkpoint``);
``adamw_to_optax`` writes a ``torch.optim.AdamW`` state (the MAE
pretraining runner's) in ``optax.adamw``'s layout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Sequence, Tuple

import torch


def warmup_cosine_schedule(lr: float, min_lr: float, total_steps: int,
                           warmup_steps: int):
    """cosine(step) * min(1, (step+1)/warmup) — torch CosineAnnealingLR
    with pytorch-warmup LinearWarmup dampening."""

    def schedule(step) -> float:
        t = float(min(step, total_steps))
        cosine = min_lr + 0.5 * (lr - min_lr) * (
            1.0 + math.cos(math.pi * t / max(total_steps, 1)))
        warm = min(1.0, (t + 1.0) / warmup_steps) if warmup_steps > 0 else 1.0
        return cosine * warm

    return schedule


def warmup_cosine_schedule_fp32(lr: float, min_lr: float, total_steps: int,
                                warmup_steps: int):
    """``warmup_cosine_schedule`` of a device step count (an int tensor),
    in fp32 on that device, as the JAX package computes it."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step, max=total_steps).float()
        cosine = min_lr + 0.5 * (lr - min_lr) * (
            1.0 + torch.cos(math.pi * t / max(total_steps, 1)))
        if warmup_steps > 0:
            cosine = cosine * torch.clamp((t + 1.0) / warmup_steps, max=1.0)
        return cosine

    return schedule


def global_norm_and_finite(tensors, sharded=(), mesh=None):
    """(sqrt of the sum of squares, every element finite), fp32 on the
    tensors' device, of ``tensors`` and, on a model axis (``mesh``), of
    the model ranks' ``sharded`` slices (one ``all_reduce``)."""
    def norms(ts, order=2.0):
        if not ts:
            return torch.zeros(0, device=device)
        return torch.stack(torch._foreach_norm([t.float() for t in ts],
                                               order))

    device = (list(tensors) + list(sharded))[0].device
    if mesh is None:
        return (torch.linalg.vector_norm(norms(tensors)),
                torch.isfinite(norms(tensors, math.inf)).all())
    # the sharded slices' squares and largest magnitudes summed over the
    # ranks: a non-finite element on any rank makes the sum non-finite
    part = torch.stack([norms(sharded).square().sum(),
                        norms(sharded, math.inf).sum()])
    mesh.model_all_reduce(part)
    norm = torch.sqrt(norms(tensors).square().sum() + part[0])
    return norm, torch.isfinite(norms(tensors, math.inf)).all() & \
        torch.isfinite(part[1])


class AdamWIfFinite(torch.optim.Optimizer):
    """``optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(
    clip_norm), optax.adamw(schedule, b1, b2, eps, weight_decay)),
    max_consecutive_errors)``:

    - the gradients (a parameter without one counts as zeros, as JAX's
      zero cotangent) are clipped to a global norm of ``clip_norm``
      (scaled by ``clip_norm / norm`` when the norm reaches it);
    - Adam moments with optax's bias correction, decoupled weight decay
      on every parameter, lr ``schedule(count)``:
      ``p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``;
    - a step whose gradients hold a NaN or inf is skipped: parameters and
      moments stay, and ``count``, the number of applied updates that the
      schedule and the bias correction read, does not advance. After
      ``max_consecutive_errors`` skips in a row the next non-finite step
      is applied anyway, as optax gives up.

    The counters (``count``, ``notfinite_count``, ``total_notfinite``,
    ``last_finite``) are device tensors, saved by ``state_dict``.
    ``step()`` returns the gradients' global norm before clipping; the
    parameters' ``model_mesh`` makes it the norm over a model axis
    (module docstring)."""

    COUNTERS = ("count", "notfinite_count", "total_notfinite",
                "last_finite")

    def __init__(self, params: Iterable[torch.nn.Parameter], *,
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 weight_decay: float, clip_norm: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 max_consecutive_errors: int = 8):
        super().__init__(params, dict(weight_decay=weight_decay,
                                      betas=betas, eps=eps))
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.max_consecutive_errors = max_consecutive_errors
        device = self.param_groups[0]["params"][0].device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        self.counters: Dict[str, torch.Tensor] = {
            "count": zero.clone(), "notfinite_count": zero.clone(),
            "total_notfinite": zero.clone(),
            "last_finite": torch.ones((), dtype=torch.bool, device=device)}

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("AdamWIfFinite.step takes no closure")
        c = self.counters
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        meshes = [getattr(p, "model_mesh", None) for p in params]
        mesh = next((m for m in meshes if m is not None), None)
        if mesh is None:
            norm, finite = global_norm_and_finite(grads)
        else:
            norm, finite = global_norm_and_finite(
                [g for m, g in zip(meshes, grads) if m is None],
                [g for m, g in zip(meshes, grads) if m is not None], mesh)
        c["notfinite_count"] = torch.where(finite, 0,
                                           c["notfinite_count"] + 1)
        apply = finite | (c["notfinite_count"]
                          > self.max_consecutive_errors)
        c["total_notfinite"] = torch.where(finite, c["total_notfinite"],
                                           c["total_notfinite"] + 1)
        c["last_finite"] = finite

        # a skipped step's gradients become zeros and its clip scale 1, so
        # that nothing below turns finite state into NaN; its lr and
        # moment weights of 0 then keep the state as it is
        grads = [torch.where(apply, g, 0.0) for g in grads]
        clip = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
        torch._foreach_mul_(grads, torch.where(apply, clip, 1.0))
        lr = torch.where(apply, self.schedule(c["count"]), 0.0)
        t = (c["count"] + 1).float()
        start = 0
        for group in self.param_groups:
            n = len(group["params"])
            self._adamw(group, params[start:start + n],
                        grads[start:start + n], apply, lr, t)
            start += n
        c["count"] = c["count"] + apply.int()
        return norm

    def _adamw(self, group, params, grads, apply, lr, t):
        b1, b2 = group["betas"]
        for p in params:
            if not self.state[p]:
                self.state[p]["exp_avg"] = torch.zeros_like(p)
                self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_avg_sq"] for p in params]
        one = torch.ones((), device=lr.device)
        # mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2 when the
        # step applies, else mu and nu times 1 plus 0
        torch._foreach_mul_(mu, torch.where(apply, b1, one))
        torch._foreach_add_(mu, torch._foreach_mul(
            grads, torch.where(apply, 1.0 - b1, 0.0)))
        torch._foreach_mul_(nu, torch.where(apply, b2, one))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, torch.where(apply, 1.0 - b2, 0.0))
        torch._foreach_add_(nu, sq)
        den = torch._foreach_div(nu, 1.0 - torch.pow(b2 * one, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu, 1.0 - torch.pow(b1 * one, t))
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(
            params, group["weight_decay"]))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)

    def state_dict(self):
        out = super().state_dict()
        out["if_finite"] = {k: v.clone() for k, v in self.counters.items()}
        return out

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        counters = state_dict.pop("if_finite")
        super().load_state_dict(state_dict)
        for k in self.COUNTERS:
            self.counters[k] = counters[k].to(self.counters[k].device)


def make_optimizer(params, lr: float, weight_decay: float, total_steps: int,
                   warmup_steps: int, *, min_lr: float = 1e-6,
                   clip_norm: float = 1.0) -> AdamWIfFinite:
    """The TIM recipe: global-norm clip, AdamW (betas 0.9, 0.999, eps 1e-8,
    decay on every parameter) on the warmup-cosine schedule, non-finite
    steps skipped (up to 8 in a row)."""
    return AdamWIfFinite(
        params, schedule=warmup_cosine_schedule_fp32(lr, min_lr, total_steps,
                                                     warmup_steps),
        weight_decay=weight_decay, clip_norm=clip_norm, betas=(0.9, 0.999),
        eps=1e-8, max_consecutive_errors=8)


# ---------------------------------------------------------------------------
# the JAX package's optimizer state (optax's to_state_dict layout)
# ---------------------------------------------------------------------------

Converter = Callable[[Mapping[str, torch.Tensor]], Dict]
MOMENTS = (("mu", "exp_avg"), ("nu", "exp_avg_sq"))


def _moment_trees(state: Mapping, params: Sequence[Tuple[str, torch.Tensor]],
                  to_jax: Converter) -> Dict:
    """{"mu": tree, "nu": tree} of a torch optimizer's ``state`` (indexed
    as ``params``, (name, whole tensor) pairs in the optimizer's order;
    a parameter without state has zero moments, as optax's init)."""
    out = {}
    for jax_name, slot in MOMENTS:
        out[jax_name] = to_jax({
            name: (state[i][slot] if slot in state.get(i, {})
                   else torch.zeros_like(p)).detach().cpu()
            for i, (name, p) in enumerate(params)})
    return out


def _count(value) -> torch.Tensor:
    return torch.as_tensor(value).detach().cpu().to(torch.int32).reshape(
        ()).clone()


def if_finite_to_optax(opt_state: Mapping,
                       params: Sequence[Tuple[str, torch.Tensor]],
                       to_jax: Converter) -> Dict:
    """An ``AdamWIfFinite`` state dict (whole moments) -> the
    ``to_state_dict`` of ``optax.apply_if_finite(chain(
    clip_by_global_norm, adamw(schedule)))``'s state:
    ``{notfinite_count, last_finite, total_notfinite, inner_state: {'0':
    {} (the clip), '1': {'0': {count, mu, nu} (Adam), '1': {} (weight
    decay), '2': {count} (the schedule)}}}``. The counters map by name,
    ``count`` fills both counts, the moments go through ``to_jax`` (the
    model's param converter; ``params``: (name, whole tensor) in the
    optimizer's order)."""
    c = opt_state["if_finite"]
    count = _count(c["count"])
    adam = {"count": count, **_moment_trees(opt_state["state"], params,
                                            to_jax)}
    return {"notfinite_count": _count(c["notfinite_count"]),
            "last_finite": torch.as_tensor(c["last_finite"]).detach().cpu()
            .to(torch.bool).reshape(()),
            "total_notfinite": _count(c["total_notfinite"]),
            "inner_state": {"0": {}, "1": {"0": adam, "1": {},
                                           "2": {"count": count.clone()}}}}


def if_finite_from_optax(tree: Mapping, names: Sequence[str],
                         from_jax: Converter, param_groups) -> Dict:
    """The inverse of ``if_finite_to_optax``: an ``AdamWIfFinite`` state
    dict (whole moments, indexed by ``names``, the model's parameter
    names in the optimizer's order; ``param_groups`` as the optimizer's
    own). Raises when the Adam and schedule counts differ or a moment is
    missing."""
    inner = tree["inner_state"]["1"]
    count, schedule = inner["0"]["count"], inner["2"]["count"]
    if int(count) != int(schedule):
        raise ValueError(f"optimizer state: Adam count {int(count)} and "
                         f"schedule count {int(schedule)} differ")
    moments = {slot: from_jax(inner["0"][jax_name])
               for jax_name, slot in MOMENTS}
    state = {}
    for i, name in enumerate(names):
        missing = [slot for slot, m in moments.items() if name not in m]
        if missing:
            raise ValueError(f"optimizer state: no {missing} for {name}")
        state[i] = {slot: moments[slot][name] for slot in moments}
    counters = {"count": _count(count),
                "notfinite_count": _count(tree["notfinite_count"]),
                "total_notfinite": _count(tree["total_notfinite"]),
                "last_finite": torch.as_tensor(tree["last_finite"])
                .to(torch.bool).reshape(()).clone()}
    return {"state": state, "param_groups": param_groups,
            "if_finite": counters}


def adamw_to_optax(opt_state: Mapping,
                   params: Sequence[Tuple[str, torch.Tensor]],
                   to_jax: Converter) -> Dict:
    """A ``torch.optim.AdamW`` state dict (one step count for every
    parameter) -> the ``to_state_dict`` of ``optax.adamw(lr)``'s state:
    ``{'0': {count, mu, nu}, '1': {} (weight decay), '2': {} (the
    learning rate)}``."""
    steps = {int(s["step"]) for s in opt_state["state"].values()}
    if len(steps) > 1:
        raise ValueError(f"AdamW state: parameters at steps {sorted(steps)}")
    count = _count(steps.pop() if steps else 0)
    return {"0": {"count": count, **_moment_trees(opt_state["state"], params,
                                                  to_jax)},
            "1": {}, "2": {}}
