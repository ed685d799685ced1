"""Checkpoint save/load: one directory of numpy arrays per checkpoint.

Equivalent of the reference's tf.train.Saver flow
(/root/reference/main.py:192-206,399,461-477) with two deliberate fixes
(SURVEY.md §5): optimizer state IS checkpointed (the reference saves
trainable variables only, losing Adam moments on resume), and the learning
rate + epoch counter round-trip too.  The `-i/-o` CLI semantics and the
per-epoch `saves/<name>_e<i>` layout are preserved.

Layout of a checkpoint directory::

    state.npz       one array per pytree leaf, keyed by its key path
    manifest.json   format tag and the key path, shape and dtype of every
                    leaf, in flattening order

Leaves are addressed by ``jax.tree_util.keystr`` of their path, so a
restore needs a template only for the container types (optax states are
named tuples); the arrays themselves are matched by name.
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np

FORMAT = "danet-ckpt-npz-v1"
ARRAYS_NAME = "state.npz"
MANIFEST_NAME = "manifest.json"


def _flatten(tree) -> list:
    return [(jax.tree_util.keystr(kp), leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _to_host(state):
    """Host numpy copy of every leaf.  Under several processes the leaves
    may be global arrays no single process holds: gather them first."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        state = multihost_utils.process_allgather(state, tiled=True)
    return jax.tree_util.tree_map(np.asarray, state)


def _storable(arr: np.ndarray) -> np.ndarray:
    """npz keeps numpy's own dtypes only: store extension dtypes
    (bfloat16) as same-width unsigned ints; the manifest keeps the name."""
    if arr.dtype.isbuiltin:
        return arr
    return arr.view("u%d" % arr.dtype.itemsize)


def save_checkpoint(path: str, state: dict) -> None:
    """Save a train-state pytree {params, opt_state, step, epoch, lr}.

    Writes into ``<path>.partial`` and renames, so an interrupted save
    never leaves a half-written checkpoint under ``path``."""
    path = os.path.abspath(path)
    leaves = _flatten(_to_host(state))
    if jax.process_index() == 0:
        tmp = path + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, ARRAYS_NAME),
                 **{k: _storable(v) for k, v in leaves})
        manifest = {"format": FORMAT, "leaves": [
            {"key": k, "shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in leaves]}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("save_checkpoint " + path)


def _read(path: str) -> dict:
    """keystr -> numpy array, for every leaf the checkpoint holds."""
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError("%s is not a %s checkpoint" % (path, FORMAT))
    with np.load(os.path.join(path, ARRAYS_NAME)) as npz:
        return {e["key"]: npz[e["key"]].view(jnp.dtype(e["dtype"]))
                .reshape(e["shape"]) for e in manifest["leaves"]}


def _has_subtree(saved: dict, key: str) -> bool:
    prefix = jax.tree_util.keystr((jax.tree_util.DictKey(key),))
    return any(k.startswith(prefix) for k in saved)


def _restore(saved: dict, template, path: str, check_dtype: bool = False):
    """Rebuild ``template``'s structure from the saved leaves.  Raises a
    user-actionable ValueError on a different architecture/config."""
    want = _flatten(template)
    missing = [k for k, _ in want if k not in saved]
    if missing:
        raise ValueError(
            "checkpoint %s holds %d leaves but the expected state has %d "
            "and %d of them (e.g. %s) are missing — different "
            "architecture/config? (e.g. a different ENCODER_TYPE or "
            "encoder dims than the checkpoint was trained with)"
            % (path, len(saved), len(want), len(missing), missing[0]))
    leaves = []
    for key, w_leaf in want:
        got = saved[key]
        if np.shape(w_leaf) != got.shape:
            raise ValueError(
                "checkpoint %s%s has shape %s but the expected state has "
                "%s — different architecture/config?"
                % (path, key, got.shape, np.shape(w_leaf)))
        w_dtype = np.dtype(getattr(w_leaf, "dtype", None)
                           or np.asarray(w_leaf).dtype)
        if check_dtype and got.dtype != w_dtype:
            raise ValueError(
                "checkpoint %s%s has dtype %s but the expected state has "
                "%s (different FLOATX/COMPUTE_DTYPE config?)"
                % (path, key, got.dtype, w_dtype))
        leaves.append(got.astype(w_dtype, copy=False))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def load_eval_params(path: str, params_template):
    """Restore the weights inference/serving should run on: the EMA
    (Polyak) average when the checkpoint carries one, raw params
    otherwise.  Counterpart of Trainer.eval_params for params-only
    consumers (the serving exporter, eval scripts)."""
    path = os.path.abspath(path)
    saved = _read(path)
    key = "ema" if _has_subtree(saved, "ema") else "params"
    return _restore(saved, {key: params_template}, path,
                    check_dtype=True)[key]


def load_checkpoint(path: str, template: dict, partial: bool = False) -> dict:
    """Restore a train-state pytree; template supplies structure/shapes.

    partial=True restores only the top-level keys present in the template
    (e.g. params-only consumers like the serving exporter) and also
    checks dtypes.  Otherwise leaves saved under keys the template lacks
    are an error, with one exception, EMA compatibility in both
    directions: a pre-EMA checkpoint restored under EMA_DECAY>0 re-seeds
    'ema' from the restored params (the EMA restarts from the resume
    point), and an EMA checkpoint restored under EMA_DECAY=0 drops its
    'ema'."""
    path = os.path.abspath(path)
    saved = _read(path)
    if partial:
        missing = [k for k in template if not _has_subtree(saved, k)]
        if missing:
            raise KeyError("checkpoint %s lacks keys %s" % (path, missing))
        return _restore(saved, template, path, check_dtype=True)

    reseed_ema = (isinstance(template, dict) and "ema" in template
                  and "params" in template
                  and not _has_subtree(saved, "ema"))
    if reseed_ema:
        template = {k: v for k, v in template.items() if k != "ema"}
    if isinstance(template, dict) and "ema" not in template:
        ema_prefix = jax.tree_util.keystr((jax.tree_util.DictKey("ema"),))
        saved = {k: v for k, v in saved.items()
                 if not k.startswith(ema_prefix)}
    state = _restore(saved, template, path)
    extra = sorted(set(saved) - {k for k, _ in _flatten(template)})
    if extra:
        raise ValueError(
            "checkpoint %s holds %d leaves that the expected state lacks "
            "(e.g. %s) — different architecture/config?"
            % (path, len(extra), extra[0]))
    if reseed_ema:
        state["ema"] = jax.tree_util.tree_map(np.copy, state["params"])
    # counters round-trip as 0-d arrays; hand back python ints so consumers
    # (JSONL metrics writer, epoch arithmetic) see the template's types
    for key in ("step", "epoch"):
        if key in state:
            state[key] = int(state[key])
    return state
