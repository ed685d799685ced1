"""Recurrent layers as time-major ``lax.scan`` with fused gate GEMMs.

Redesign of the reference's RNN stack (tf.scan over a per-step "flat"
cell — reference main.py:76-183, app/ops.py:110-188):

  * **Input projections are hoisted out of the scan.**  The x-part of the
    gate pre-activation for *all* timesteps is one big
    ``[T*B, idim] @ [idim, 4*hdim]`` GEMM; only the unavoidable recurrent
    ``h @ Wh`` stays inside the scan.
  * **Time-major layout** ([T, B, H]) so each scan step is a contiguous
    matmul, and weights stay resident across steps.
  * **Gate weights are stored as [in, 4, h]** so each of the four gates is
    contiguous in the trailing axis — this lets tensor-parallel
    sharding split the *hidden* axis while keeping all gate elementwise math
    local to a shard.

Cell semantics match reference ops.py:110-148: pre-activation split into
[candidate, i, f, o]; ``c' = sigmoid(i)*g(cand) + sigmoid(f)*c``;
``h' = sigmoid(o)*tanh(c')``.  The reference's candidate has *no* tanh
(nonstandard, ops.py:143-147); that behaviour is kept behind
``candidate_activation='linear'`` while the default here is the standard
``'tanh'`` (see SURVEY.md §7 hard-parts note).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from danet_tpu.ops.nn import dropout, ee, uniform_init


def lstm_init(rng, idim: int, hdim: int, w_scale: Optional[float] = None,
              gate_bias: tuple = (0.0, 0.0, 0.0, 0.0), dtype=jnp.float32):
    """LSTM params: wx [idim,4,h], wh [h,4,h], b [4,h].

    gate_bias = (candidate, input, forget, output) initial biases — the
    reference encoders use (0, 1.5, -1, 1) (modules.py:158-162).
    Equivalent to the reference's single concat([x,h]) @ W[(idim+h),4h]
    with one uniform init over the whole matrix.
    """
    kx, kh = jax.random.split(rng)
    if w_scale is None:
        w_scale = float(1.0 / np.sqrt(hdim))
    b = np.zeros((4, hdim), dtype=np.float32)
    for g in range(4):
        b[g, :] = gate_bias[g]
    return {
        "wx": uniform_init(kx, (idim, 4, hdim), w_scale, dtype),
        "wh": uniform_init(kh, (hdim, 4, hdim), w_scale, dtype),
        "b": jnp.asarray(b, dtype=dtype),
    }


def lstm_input_proj(params, x_tm: jnp.ndarray) -> jnp.ndarray:
    """Hoisted input projection: one large GEMM over all timesteps.
    [T, B, idim] -> [T, B, 4, hdim] in the input's dtype."""
    dt = x_tm.dtype
    return ee("tbi,igh->tbgh", x_tm, params["wx"].astype(dt)) \
        + params["b"].astype(dt)


def _lstm_scan(params, x_tm: jnp.ndarray, c0, h0,
               candidate_activation: str, return_state: bool = False):
    """Core scan. x_tm: [T, B, idim] time-major. Returns hidden seq [T,B,h]
    (or (hidden seq, (c_final, h_final)) with return_state)."""
    dt = x_tm.dtype
    xp = lstm_input_proj(params, x_tm)

    # default zero states are derived from xp (not fresh constants) so they
    # inherit xp's varying axes under shard_map (seq/pipe parallel callers);
    # nan_to_num guards against 0*inf = NaN poisoning from non-finite inputs
    if c0 is None:
        c0 = jnp.nan_to_num(xp[0, :, 0]) * 0
    if h0 is None:
        h0 = jnp.nan_to_num(xp[0, :, 0]) * 0

    wh = params["wh"].astype(dt)
    g_fn = jnp.tanh if candidate_activation == "tanh" else (lambda z: z)

    def step(carry, xp_t):
        c, h = carry
        act = xp_t + ee("bh,hgk->bgk", h, wh)
        cand = g_fn(act[:, 0])
        i = jax.nn.sigmoid(act[:, 1])
        f = jax.nn.sigmoid(act[:, 2])
        o = jax.nn.sigmoid(act[:, 3])
        c_new = i * cand + f * c
        h_new = o * jnp.tanh(c_new)
        return (c_new, h_new), h_new

    (c_f, h_f), hs = jax.lax.scan(step, (c0, h0), xp)
    return (hs, (c_f, h_f)) if return_state else hs


def lstm_apply(params, x: jnp.ndarray, candidate_activation: str = "tanh",
               reverse: bool = False, c0=None, h0=None,
               return_state: bool = False):
    """Run an LSTM over x [B, T, idim] -> [B, T, hdim].

    reverse=True runs over time-reversed input and re-reverses the output
    (the reference builds its backward BiLSTM direction the same way,
    modules.py:128-136). Initial state is zero, matching the reference's
    per-batch state reset (main.py:432,538-540).
    return_state=True additionally returns the final scan carry
    (c, h) — for a reversed scan that is the state after consuming the
    input down to its FIRST frame (sequence-parallel halo warmup,
    parallel/seq_parallel.py).
    """
    x_tm = jnp.swapaxes(x, 0, 1)
    if reverse:
        x_tm = x_tm[::-1]
    out = _lstm_scan(params, x_tm, c0, h0, candidate_activation,
                     return_state=return_state)
    hs, state = out if return_state else (out, None)
    if reverse:
        hs = hs[::-1]
    hs = jnp.swapaxes(hs, 0, 1)
    return (hs, state) if return_state else hs


def bilstm_init(rng, idim: int, hdim: int, w_scale=None,
                gate_bias=(0.0, 0.0, 0.0, 0.0), dtype=jnp.float32):
    """Forward + backward LSTM params (reference modules.py:120-137)."""
    kf, kb = jax.random.split(rng)
    return {
        "fwd": lstm_init(kf, idim, hdim, w_scale, gate_bias, dtype),
        "bwd": lstm_init(kb, idim, hdim, w_scale, gate_bias, dtype),
    }


def bilstm_apply(params, x: jnp.ndarray,
                 candidate_activation: str = "tanh",
                 dropout_rng=None, keep_prob: float = 1.0) -> jnp.ndarray:
    """BiLSTM: concat(fwd, bwd-reversed) [B,T,2h], optional dropout.

    The two directions' scans are independent programs that XLA
    schedules concurrently.
    """
    h_f = lstm_apply(params["fwd"], x, candidate_activation)
    h_b = lstm_apply(params["bwd"], x, candidate_activation, reverse=True)
    y = jnp.concatenate([h_f, h_b], axis=-1)
    if dropout_rng is not None and keep_prob < 1.0:
        y = dropout(dropout_rng, y, keep_prob)
    return y


def gru_init(rng, idim: int, hdim: int, w_scale: Optional[float] = None,
             dtype=jnp.float32):
    """GRU params (reference ops.py:151-188): gate and candidate linears.

    Candidate bias inits to 1.0 as in the reference (ops.py:175-176).
    """
    kgx, kgh, kcx, kch = jax.random.split(rng, 4)
    if w_scale is None:
        w_scale = float(0.1 / np.sqrt(hdim))  # reference main.py:175
    return {
        "wgx": uniform_init(kgx, (idim, 2, hdim), w_scale, dtype),
        "wgh": uniform_init(kgh, (hdim, 2, hdim), w_scale, dtype),
        "bg": jnp.zeros((2, hdim), dtype=dtype),
        "wcx": uniform_init(kcx, (idim, hdim), w_scale, dtype),
        "wch": uniform_init(kch, (hdim, hdim), w_scale, dtype),
        "bc": jnp.ones((hdim,), dtype=dtype),
    }


def gru_apply(params, x: jnp.ndarray, c0=None, return_state: bool = False):
    """GRU over [B, T, idim] -> [B, T, hdim].

    Semantics per reference ops.py:151-188: gates (r, u) from concat(x, c);
    candidate tanh from concat(x, c*r); c' = c*u + cand*(1-u).
    return_state=True additionally returns the final carry c
    (sequence-parallel halo warmup).
    """
    dt = x.dtype
    x_tm = jnp.swapaxes(x, 0, 1)
    gx = ee("tbi,igh->tbgh", x_tm, params["wgx"].astype(dt)) \
        + params["bg"].astype(dt)
    cx = ee("tbi,ih->tbh", x_tm, params["wcx"].astype(dt)) \
        + params["bc"].astype(dt)
    wgh = params["wgh"].astype(dt)
    wch = params["wch"].astype(dt)

    if c0 is None:
        c0 = jnp.nan_to_num(cx[0]) * 0  # varying-axis-safe zeros (see LSTM)

    def step(c, inp):
        gx_t, cx_t = inp
        gates = jax.nn.sigmoid(gx_t + ee("bh,hgk->bgk", c, wgh))
        r, u = gates[:, 0], gates[:, 1]
        cand = jnp.tanh(cx_t + ee("bh,hk->bk", c * r, wch))
        c_new = c * u + cand * (1.0 - u)
        return c_new, c_new

    c_f, cs = jax.lax.scan(step, c0, (gx, cx))
    cs = jnp.swapaxes(cs, 0, 1)
    return (cs, c_f) if return_state else cs
