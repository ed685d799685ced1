"""Small functional NN layer library: linear, leaky-relu, dropout, conv.

Functional (pytree params + pure apply) equivalents of the reference op
layer zoo (/root/reference/app/ops.py:37-107 lyr_linear/relu).  Params are
plain dicts created by ``*_init`` functions; apply functions are pure and
jit/pjit-friendly.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def uniform_init(rng, shape, scale, dtype=jnp.float32):
    return jax.random.uniform(
        rng, shape, dtype=dtype, minval=-scale, maxval=scale)


def mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Matmul with f32 accumulation, output in the operands' dtype.

    With bf16 operands this runs the bf16 tensor-core path while
    accumulating in f32 (mixed-precision training standard); with f32 it is
    a plain f32 matmul."""
    return jnp.matmul(
        a, b, preferred_element_type=jnp.float32).astype(a.dtype)


def ee(subscripts: str, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Einsum with f32 accumulation, output in the operands' dtype."""
    return jnp.einsum(
        subscripts, a, b, preferred_element_type=jnp.float32).astype(a.dtype)


def linear_init(rng, idim: int, odim: int, w_scale: Optional[float] = None,
                bias: bool = True, b_value=0.0, dtype=jnp.float32):
    """Params for y = x @ W + b (reference ops.py:37-90 lyr_linear).

    Default W init matches tf.get_variable's glorot_uniform default
    (the reference passes no initializer for most linears).
    """
    if w_scale is None:
        w_scale = float(np.sqrt(6.0 / (idim + odim)))  # glorot uniform
    params = {"w": uniform_init(rng, (idim, odim), w_scale, dtype)}
    if bias:
        b = jnp.full((odim,), b_value, dtype=dtype) if np.isscalar(b_value) \
            else jnp.asarray(b_value, dtype=dtype)
        params["b"] = b
    return params


def linear_apply(params, x: jnp.ndarray) -> jnp.ndarray:
    """y = x @ W (+ b) on the last axis, any leading rank."""
    y = mm(x, params["w"].astype(x.dtype))
    if "b" in params:
        y = y + params["b"].astype(x.dtype)
    return y


def layer_norm(params, x: jnp.ndarray) -> jnp.ndarray:
    """LayerNorm over the trailing axis with {'g','b'} params.

    THE shared definition (epsilon included) for the attention/TCN/DPRNN
    blocks AND their sequence-parallel counterparts in
    parallel/seq_parallel.py — the SP-vs-dense EXACT parity guarantees
    depend on both paths using identical math."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    xn = (x - mu) * jax.lax.rsqrt(var + 1e-6)
    return xn * params["g"].astype(x.dtype) + params["b"].astype(x.dtype)


def leaky_relu(x: jnp.ndarray, alpha: float = 0.0) -> jnp.ndarray:
    """max(x*alpha, x) — reference ops.py:93-107."""
    if alpha == 0.0:
        return jax.nn.relu(x)
    return jnp.maximum(x * alpha, x)


def causal_band(qpos: jnp.ndarray, kpos: jnp.ndarray,
                window: int) -> jnp.ndarray:
    """The ATTN_CAUSAL banded attention mask, defined ONCE.

    True where key position ``kpos`` is visible to query position
    ``qpos``: the query itself and the ``window - 1`` positions before it
    (``kpos <= qpos and kpos > qpos - window``).  Every causal-attention
    site — the single-program dense band, the ring/Ulysses SP collectives
    (which rebuild it in global coordinates per fold) and the streaming
    K/V-cache mask — must use this helper so the window convention cannot
    drift between the paths whose pairwise exactness the tests assert."""
    return (kpos <= qpos) & (kpos > qpos - window)


def dropout(rng, x: jnp.ndarray, keep_prob: float) -> jnp.ndarray:
    """Inverted dropout.

    Note: the reference *intends* dropout in its BiLSTM stack but never wires
    the placeholder through (main.py:243 vs modules.py:137) so it is inert
    there; here it is functional. keep_prob=1 is the identity.
    """
    if keep_prob >= 1.0:
        return x
    mask = jax.random.bernoulli(rng, keep_prob, x.shape)
    return jnp.where(mask, x / keep_prob, jnp.zeros_like(x))


def conv2d_init(rng, in_ch: int, out_ch: int, ksize: int,
                w_scale: Optional[float] = None, dtype=jnp.float32):
    """Params for an NCHW same-padded conv (reference modules.py:289-363
    uses tf.layers.conv2d channels_first)."""
    if w_scale is None:
        fan_in = in_ch * ksize * ksize
        fan_out = out_ch * ksize * ksize
        w_scale = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return {
        "w": uniform_init(rng, (out_ch, in_ch, ksize, ksize), w_scale, dtype),
        "b": jnp.zeros((out_ch,), dtype=dtype),
    }


def conv2d_apply(params, x: jnp.ndarray) -> jnp.ndarray:
    """NCHW 'SAME' convolution via lax.conv_general_dilated.

    Kernel follows the activation dtype and the output stays in it too:
    a preferred_element_type=f32 output makes the VJP's transposed convs
    see an f32 cotangent against bf16 operands, which lax rejects (the
    same trap conv1d_depthwise_apply documents).  Accumulation is not
    sacrificed — bf16 convs accumulate in f32 internally; only
    the output rounding point moves, and the very next op casts to
    x.dtype anyway.
    """
    y = jax.lax.conv_general_dilated(
        x, params["w"].astype(x.dtype), window_strides=(1, 1),
        padding="SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return y + params["b"].astype(x.dtype)[None, :, None, None]


def conv1d_depthwise_init(rng, channels: int, ksize: int,
                          w_scale: Optional[float] = None,
                          dtype=jnp.float32):
    """Params for a depthwise (per-channel) 1-D conv over the time axis —
    the TCN block's temporal mixer (no cross-channel contraction; the
    surrounding 1x1 linears do channel mixing)."""
    if w_scale is None:
        w_scale = float(np.sqrt(6.0 / (2 * ksize)))  # fan_in = fan_out = K
    return {
        "w": uniform_init(rng, (channels, 1, ksize), w_scale, dtype),
        "b": jnp.zeros((channels,), dtype=dtype),
    }


def conv1d_depthwise_apply(params, x: jnp.ndarray, dilation: int = 1,
                           causal: bool = False) -> jnp.ndarray:
    """Depthwise dilated conv over axis 1 of [B, T, C] -> [B, T, C].

    ``causal=True`` left-pads with (K-1)*dilation zeros so output frame t
    sees only inputs <= t (streaming-exact: a carried tail of the same
    length continues the convolution bit-for-bit); otherwise the padding
    splits symmetrically ('SAME' with dilation).

    Runs in f32 regardless of the activation dtype: a depthwise conv is
    K MACs per output element — bandwidth-bound, so f32 costs little,
    and mixed bf16/f32 conv operands break the VJP's
    transpose-conv dtype agreement.
    """
    k = params["w"].shape[-1]
    span = (k - 1) * dilation
    pad = [(span, 0)] if causal else [(span // 2, span - span // 2)]
    xt = jnp.swapaxes(x, 1, 2).astype(jnp.float32)   # [B, C, T]
    y = jax.lax.conv_general_dilated(
        xt, params["w"], window_strides=(1,), padding=pad,
        rhs_dilation=(dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        feature_group_count=params["w"].shape[0])
    y = (y + params["b"][None, :, None]).astype(x.dtype)
    return jnp.swapaxes(y, 1, 2)


def max_pool_2x2(x: jnp.ndarray) -> jnp.ndarray:
    """2x2/2 max pool, NCHW."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, 1, 2, 2), window_strides=(1, 1, 2, 2),
        padding="VALID")
