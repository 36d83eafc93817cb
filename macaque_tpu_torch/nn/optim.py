"""The optax transformations the trainers chain, written out over dicts of
tensors (a model's state-dict names to float32 tensors).

Each transformation is an ``(init, update)`` pair as in optax:
``init(params) -> state`` and ``update(updates, state, params) ->
(updates, state)``; :func:`chain` runs them in turn and
:func:`apply_updates` adds the result to the parameters. Every operation
is optax's, in its order: ``clip_by_global_norm`` divides by the norm and
then multiplies by the limit, ``scale_by_adam`` corrects both moments for
their bias at the incremented count, ``scale_by_learning_rate`` reads a
schedule at the count *before* it is incremented. (``torch.optim.AdamW``
is not this chain: it decays the weights apart from the update, so a
per-layer learning-rate scale would not reach the decay.)
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Transform(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple]


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def _empty(params):
    return ()


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale every update by ``max_norm / norm`` when the global norm of all
    of them reaches ``max_norm``."""
    def update(updates, state, params=None):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in updates.values()))
        trigger = norm < max_norm
        return {k: torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm)
                for k, g in updates.items()}, state

    return Transform(_empty, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    """Adam's moments and their bias correction (``eps_root`` 0)."""
    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        count = state["count"] + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        mu, nu, out = {}, {}, {}
        for k, g in updates.items():
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
            out[k] = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float, mask: dict | None = None
                        ) -> Transform:
    """``update + weight_decay * param`` where ``mask[name]`` (all where no
    mask is given)."""
    def update(updates, state, params=None):
        return {k: g + weight_decay * params[k]
                if mask is None or mask[k] else g
                for k, g in updates.items()}, state

    return Transform(_empty, update)


def scale_by_dict(scales: dict) -> Transform:
    """Multiply each update by its own constant (the layer-wise lr decay)."""
    def update(updates, state, params=None):
        return {k: g * scales[k] for k, g in updates.items()}, state

    return Transform(_empty, update)


def scale_by_learning_rate(lr) -> Transform:
    """Multiply by ``-lr``, or by ``-lr(count)`` for a schedule, the count
    read before it is incremented."""
    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        step = -(lr(state["count"]) if callable(lr) else lr)
        return ({k: g * step for k, g in updates.items()},
                {"count": state["count"] + 1})

    return Transform(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4, mask: dict | None = None) -> Transform:
    """``optax.adamw``: Adam, the decayed weights, the learning rate."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(lr))


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Transform:
    """``optax.adam``."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
