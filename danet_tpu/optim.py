"""Optimizer registry (optax-backed).

Equivalent of the reference optimizer layer (/root/reference/app/ozers.py
plus the gradient-clip/apply logic at main.py:354-363): named factories
resolved via ``hparams.get_optimizer()``, elementwise gradient value
clipping at +/-GRAD_CLIP_THRES, and a runtime-adjustable learning rate
(the reference keeps LR in a tf Variable; here it is an injected
hyperparameter living in the optax state so LR decay needs no recompile).
"""
from __future__ import annotations

import optax

from danet_tpu.hparams import hparams


def _clip_transform(grad_clip, clip_norm):
    """One stateless transform for both clip modes.

    - clip_norm (GRAD_CLIP_NORM; 0/None = off): global-norm clip — spike
      protection for recurrent nets; the elementwise value clip never
      fires on the small-but-collectively-huge gradients of a bf16 loss
      spike, exactly the excursion that wrecks a staged run.
    - grad_clip (GRAD_CLIP_THRES; None = off): the reference's
      elementwise value clip (reference main.py:354-363).

    Both modes live in a SINGLE always-present transform with EmptyState
    so the optax chain is always (clip, inject) — toggling either key
    between stages of a run never changes the opt_state tree structure,
    and checkpoints stay restorable across the toggle (a restore
    matches leaves by their tree path).
    """
    import jax
    import jax.numpy as jnp

    def init_fn(params):
        del params
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        del params
        if clip_norm:  # static python toggle: no structure change
            max_norm = float(clip_norm)
            g_norm = optax.global_norm(updates)
            scale = jnp.where(g_norm < max_norm, 1.0, max_norm
                              / jnp.maximum(g_norm, 1e-38))
            updates = jax.tree_util.tree_map(
                lambda u: u * scale.astype(u.dtype), updates)
        if grad_clip is not None:
            c = float(grad_clip)
            updates = jax.tree_util.tree_map(
                lambda u: jnp.clip(u, -c, c), updates)
        return updates, state

    return optax.GradientTransformation(init_fn, update_fn)


def _with_clip_and_lr(opt_factory, learn_rate: float, grad_clip,
                      clip_norm=None):
    return optax.chain(
        _clip_transform(grad_clip, clip_norm),
        optax.inject_hyperparams(opt_factory)(learning_rate=learn_rate))


@hparams.register_optimizer("sgd")
def sgd_ozer(learn_rate, grad_clip=None, clip_norm=None, **kwargs):
    return _with_clip_and_lr(optax.sgd, learn_rate, grad_clip, clip_norm)


@hparams.register_optimizer("adam")
def adam_ozer(learn_rate, grad_clip=None, clip_norm=None, **kwargs):
    return _with_clip_and_lr(optax.adam, learn_rate, grad_clip, clip_norm)


@hparams.register_optimizer("adamw")
def adamw_ozer(learn_rate, grad_clip=None, clip_norm=None, hp=None,
               **kwargs):
    """Adam with decoupled weight decay (not in the reference — its
    REG_TYPE L2 regularizer was inert; WEIGHT_DECAY is the modern
    production equivalent, default 1e-4).  An explicit WEIGHT_DECAY=0
    is honored (decay disabled), and the hp the optimizer was built
    from wins over the global singleton."""
    hp = hp if hp is not None else hparams
    wd = getattr(hp, "WEIGHT_DECAY", None)
    wd = 1e-4 if wd is None else float(wd)

    def factory(learning_rate):
        return optax.adamw(learning_rate, weight_decay=wd)

    return _with_clip_and_lr(factory, learn_rate, grad_clip, clip_norm)


def make_optimizer(hp=None):
    """Build the configured optimizer with the reference's clip semantics.

    The hp namespace is forwarded to factories that accept it (so e.g.
    adamw reads WEIGHT_DECAY from the config it was built with); custom
    user-registered factories with the minimal (learn_rate, grad_clip)
    signature keep working."""
    import inspect
    hp = hp if hp is not None else hparams
    factory = hp.get_optimizer()
    kw = {}
    try:
        params = inspect.signature(factory).parameters
        has_varkw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                        for p in params.values())
        if "hp" in params or has_varkw:
            kw["hp"] = hp
        if "clip_norm" in params or has_varkw:
            kw["clip_norm"] = getattr(hp, "GRAD_CLIP_NORM", None)
    except (TypeError, ValueError):
        pass
    return factory(hp.LR, grad_clip=hp.GRAD_CLIP_THRES, **kw)


def set_learn_rate(opt_state, lr: float):
    """Update the injected learning rate inside an optax state pytree."""
    # the inject_hyperparams state is the last element of the chain state
    import jax.numpy as jnp
    inner = opt_state[-1]
    old = inner.hyperparams["learning_rate"]
    new = jnp.asarray(lr, dtype=old.dtype) if hasattr(old, "dtype") else lr
    inner.hyperparams["learning_rate"] = new
    return opt_state


def get_learn_rate(opt_state) -> float:
    return float(opt_state[-1].hyperparams["learning_rate"])
