"""Checkpoint format units: numpy-only save/restore of a train state."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from danet_tpu.train import checkpoint as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0, ema=False):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"encoder": {"lstm0": {"wh": jax.random.normal(k1, (4, 4, 4))},
                          "out": jax.random.normal(k2, (3,), jnp.bfloat16)},
              "separator": {}}
    opt = optax.chain(optax.clip(1.0), optax.inject_hyperparams(
        optax.adam)(learning_rate=1e-3))
    state = {"params": params, "opt_state": opt.init(params),
             "step": 7, "epoch": 3}
    if ema:
        state["ema"] = jax.tree_util.tree_map(lambda x: x + 1, params)
    return state


def _assert_tree_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip_numpy_format(tmp_path):
    """params (incl. a bfloat16 leaf), optax named-tuple states and the
    counters round-trip exactly; the directory holds the npz and its
    manifest only; a different architecture fails with a diagnosis."""
    state = _state()
    path = str(tmp_path / "ck")
    ckpt_lib.save_checkpoint(path, state)
    ckpt_lib.save_checkpoint(path, state)  # overwrite in place
    assert sorted(os.listdir(path)) == ["manifest.json", "state.npz"]
    assert not os.path.exists(path + ".partial")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest["leaves"]) == len(jax.tree_util.tree_leaves(state))

    got = ckpt_lib.load_checkpoint(path, _state(seed=1))
    assert type(got["step"]) is int and got["step"] == 7
    assert type(got["epoch"]) is int and got["epoch"] == 3
    _assert_tree_equal(got["params"], state["params"])
    _assert_tree_equal(got["opt_state"], state["opt_state"])

    wrong = _state(seed=1)
    wrong["params"]["encoder"]["lstm0"]["wh"] = jnp.zeros((4, 4, 5))
    with pytest.raises(ValueError, match=r"\['wh'\] has shape"):
        ckpt_lib.load_checkpoint(path, wrong)
    extra = _state(seed=1)
    del extra["params"]["encoder"]["out"]
    with pytest.raises(ValueError, match="leaves that the expected state"):
        ckpt_lib.load_checkpoint(path, extra)


def test_checkpoint_ema_compat_both_directions(tmp_path):
    """A pre-EMA checkpoint restored with an EMA template re-seeds 'ema'
    from the restored params; an EMA checkpoint restored without one
    drops it; eval consumers prefer the EMA weights when present."""
    plain, with_ema = str(tmp_path / "plain"), str(tmp_path / "ema")
    s0 = _state(seed=0)
    ckpt_lib.save_checkpoint(plain, s0)
    got = ckpt_lib.load_checkpoint(plain, _state(seed=1, ema=True))
    _assert_tree_equal(got["ema"], s0["params"])
    _assert_tree_equal(got["params"], s0["params"])

    s1 = _state(seed=2, ema=True)
    ckpt_lib.save_checkpoint(with_ema, s1)
    got = ckpt_lib.load_checkpoint(with_ema, _state(seed=3))
    assert "ema" not in got
    _assert_tree_equal(got["params"], s1["params"])

    tmpl = _state(seed=4)["params"]
    _assert_tree_equal(ckpt_lib.load_eval_params(with_ema, tmpl), s1["ema"])
    _assert_tree_equal(ckpt_lib.load_eval_params(plain, tmpl), s0["params"])


def test_train_path_imports_only_core_packages(tmp_path):
    """`python main.py -m train` and its checkpoint save/load import
    nothing beyond JAX, numpy, scipy, optax, chex, einops (and what those
    import themselves) and the standard library."""
    code = """
import sys
import jax, numpy, scipy, scipy.io, scipy.signal, optax, chex, einops
before = {m.split('.')[0] for m in sys.modules}
import main
from danet_tpu.train import checkpoint
checkpoint.save_checkpoint(sys.argv[1], {"params": {"w": numpy.ones(3)},
                                         "step": 1})
checkpoint.load_checkpoint(sys.argv[1], {"params": {"w": numpy.ones(3)},
                                         "step": 0})
new = {m.split('.')[0] for m in sys.modules} - before
new -= set(sys.stdlib_module_names) | {"main", "danet_tpu"}
print(sorted(new))
assert not new, new
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "ck")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
