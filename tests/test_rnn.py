"""RNN cell math vs numpy oracles (reference semantics: app/ops.py:110-188)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from danet_tpu.ops import rnn


def _numpy_lstm(params, x, candidate_activation, dtype=np.float64):
    """Step-by-step numpy oracle of the reference LSTM cell
    (ops.py:138-148): act = [cand|i|f|o]; c' = sig(i)*g(cand)+sig(f)*c;
    h' = sig(o)*tanh(c')."""
    wx = np.asarray(params["wx"], dtype)  # [I,4,H]
    wh = np.asarray(params["wh"], dtype)  # [H,4,H]
    b = np.asarray(params["b"], dtype)    # [4,H]
    x = np.asarray(x, dtype)
    bsz, t, _ = x.shape
    h = np.zeros((bsz, wh.shape[0]), dtype)
    c = np.zeros((bsz, wh.shape[0]), dtype)
    sig = lambda z: 1 / (1 + np.exp(-z))
    g = np.tanh if candidate_activation == "tanh" else (lambda z: z)
    hs = []
    for ti in range(t):
        act = (np.einsum("bi,igh->bgh", x[:, ti], wx)
               + np.einsum("bh,hgk->bgk", h, wh) + b)
        cand, i, f, o = act[:, 0], sig(act[:, 1]), sig(act[:, 2]), \
            sig(act[:, 3])
        c = i * g(cand) + f * c
        h = o * np.tanh(c)
        hs.append(h)
    return np.stack(hs, axis=1)


def test_lstm_matches_numpy_oracle():
    rng = jax.random.PRNGKey(0)
    params = rnn.lstm_init(rng, 5, 7, gate_bias=(0.0, 1.5, -1.0, 1.0))
    x = np.random.RandomState(0).randn(3, 6, 5).astype(np.float32)
    for act in ["tanh", "linear"]:
        out = np.asarray(rnn.lstm_apply(params, jnp.asarray(x), act))
        ref = _numpy_lstm(params, x, act)
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_lstm_reverse_is_time_reflection():
    rng = jax.random.PRNGKey(1)
    params = rnn.lstm_init(rng, 4, 6)
    x = np.random.RandomState(1).randn(2, 8, 4).astype(np.float32)
    fwd_on_reversed = np.asarray(
        rnn.lstm_apply(params, jnp.asarray(x[:, ::-1].copy()), "tanh"))
    bwd = np.asarray(rnn.lstm_apply(params, jnp.asarray(x), "tanh",
                                    reverse=True))
    np.testing.assert_allclose(bwd, fwd_on_reversed[:, ::-1], atol=1e-6)


def test_bilstm_concat_layout():
    rng = jax.random.PRNGKey(2)
    params = rnn.bilstm_init(rng, 4, 5)
    x = np.random.RandomState(2).randn(2, 7, 4).astype(np.float32)
    out = np.asarray(rnn.bilstm_apply(params, jnp.asarray(x), "tanh"))
    assert out.shape == (2, 7, 10)
    f = np.asarray(rnn.lstm_apply(params["fwd"], jnp.asarray(x), "tanh"))
    b = np.asarray(rnn.lstm_apply(params["bwd"], jnp.asarray(x), "tanh",
                                  reverse=True))
    np.testing.assert_allclose(out, np.concatenate([f, b], axis=-1),
                               atol=1e-6)


def test_bilstm_dropout_active_only_with_rng():
    rng = jax.random.PRNGKey(3)
    params = rnn.bilstm_init(rng, 4, 5)
    x = np.random.RandomState(3).randn(2, 7, 4).astype(np.float32)
    base = np.asarray(rnn.bilstm_apply(params, jnp.asarray(x), "tanh"))
    dropped = np.asarray(rnn.bilstm_apply(
        params, jnp.asarray(x), "tanh",
        dropout_rng=jax.random.PRNGKey(4), keep_prob=0.5))
    assert (dropped == 0).sum() > 0
    # zero-out positions come from the mask; surviving entries are scaled
    nz = dropped != 0
    np.testing.assert_allclose(dropped[nz], base[nz] / 0.5, rtol=1e-5)


def _numpy_gru(params, x, c0=None, dtype=np.float64):
    wgx = np.asarray(params["wgx"], dtype)
    wgh = np.asarray(params["wgh"], dtype)
    bg = np.asarray(params["bg"], dtype)
    wcx = np.asarray(params["wcx"], dtype)
    wch = np.asarray(params["wch"], dtype)
    bc = np.asarray(params["bc"], dtype)
    x = np.asarray(x, dtype)
    bsz, t, _ = x.shape
    c = (np.zeros((bsz, wch.shape[0]), dtype) if c0 is None
         else np.asarray(c0, dtype))
    sig = lambda z: 1 / (1 + np.exp(-z))
    out = []
    for ti in range(t):
        gates = sig(np.einsum("bi,igh->bgh", x[:, ti], wgx)
                    + np.einsum("bh,hgk->bgk", c, wgh) + bg)
        r, u = gates[:, 0], gates[:, 1]
        cand = np.tanh(x[:, ti] @ wcx + (c * r) @ wch + bc)
        c = c * u + cand * (1 - u)
        out.append(c)
    return np.stack(out, axis=1)


def test_gru_matches_numpy_oracle():
    rng = jax.random.PRNGKey(5)
    params = rnn.gru_init(rng, 4, 6)
    x = np.random.RandomState(5).randn(2, 5, 4).astype(np.float32)
    out = np.asarray(rnn.gru_apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(out, _numpy_gru(params, x), atol=1e-5)


# --- float32 references at realistic widths --------------------------------
# The scans are compared at precision="highest" with a plain float32 numpy
# step loop: on a GPU a default-precision float32 matmul may run in TF32,
# which the 2e-5 tolerance below would reject.
_F32_ATOL = 2e-5


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("act", ["tanh", "linear"])
def test_lstm_matches_float32_reference(act, reverse):
    params = rnn.lstm_init(jax.random.PRNGKey(6), 24, 40,
                           gate_bias=(0.0, 1.5, -1.0, 1.0))
    x = np.random.RandomState(6).randn(4, 17, 24).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(rnn.lstm_apply(params, jnp.asarray(x), act,
                                        reverse=reverse))
    xin = x[:, ::-1] if reverse else x
    ref = _numpy_lstm(params, xin, act, np.float32)
    if reverse:
        ref = ref[:, ::-1]
    assert out.dtype == np.float32 and out.shape == (4, 17, 40)
    np.testing.assert_allclose(out, ref, atol=_F32_ATOL)


def test_bilstm_matches_float32_reference():
    """BiLSTM = concat(forward scan, time-reflected backward scan)."""
    params = rnn.bilstm_init(jax.random.PRNGKey(7), 24, 40)
    x = np.random.RandomState(7).randn(3, 19, 24).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(rnn.bilstm_apply(params, jnp.asarray(x), "tanh"))
    ref = np.concatenate(
        [_numpy_lstm(params["fwd"], x, "tanh", np.float32),
         _numpy_lstm(params["bwd"], x[:, ::-1], "tanh",
                     np.float32)[:, ::-1]], axis=-1)
    np.testing.assert_allclose(out, ref, atol=_F32_ATOL)


def test_gru_matches_float32_reference_with_carry():
    """GRU from a nonzero initial carry, with the final carry returned
    (the streaming/sequence-parallel contract)."""
    params = rnn.gru_init(jax.random.PRNGKey(8), 24, 40, w_scale=0.2)
    x = np.random.RandomState(8).randn(3, 15, 24).astype(np.float32)
    c0 = np.random.RandomState(9).randn(3, 40).astype(np.float32) * 0.5
    with jax.default_matmul_precision("highest"):
        out, c_f = rnn.gru_apply(params, jnp.asarray(x),
                                 c0=jnp.asarray(c0), return_state=True)
    ref = _numpy_gru(params, x, c0, np.float32)
    np.testing.assert_allclose(np.asarray(out), ref, atol=_F32_ATOL)
    np.testing.assert_allclose(np.asarray(c_f), ref[:, -1], atol=_F32_ATOL)


def test_lstm_gradients_check_grads():
    """Reverse-mode gradients of the scan (through lax.scan's transpose)
    agree with finite differences, w.r.t. inputs and every weight."""
    from jax.test_util import check_grads
    params = rnn.lstm_init(jax.random.PRNGKey(10), 3, 4)
    x = jnp.asarray(np.random.RandomState(10).randn(2, 5, 3)
                    .astype(np.float32))

    def f(p, v):
        return jnp.sum(jnp.sin(rnn.lstm_apply(p, v, "tanh", reverse=True)))

    with jax.default_matmul_precision("highest"):
        check_grads(f, (params, x), order=1, modes=("rev",),
                    atol=2e-2, rtol=2e-2, eps=1e-2)


def test_gru_gradients_check_grads():
    from jax.test_util import check_grads
    params = rnn.gru_init(jax.random.PRNGKey(11), 3, 4, w_scale=0.5)
    x = jnp.asarray(np.random.RandomState(11).randn(2, 5, 3)
                    .astype(np.float32))

    def f(p, v):
        return jnp.sum(jnp.sin(rnn.gru_apply(p, v)))

    with jax.default_matmul_precision("highest"):
        check_grads(f, (params, x), order=1, modes=("rev",),
                    atol=2e-2, rtol=2e-2, eps=1e-2)
