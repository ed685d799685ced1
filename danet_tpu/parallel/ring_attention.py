"""Ring attention: exact sequence-parallel attention over a 'seq' axis.

SURVEY.md §2.4: ring attention becomes relevant once an attention encoder
exists — attn-v1 (models/encoders.py) is that variant, and this module is
its multi-chip long-context path.  Queries stay put (T sharded over the
ring); key/value blocks rotate around the ring via `ppermute`, and each
device folds every incoming block into a numerically-stable online-softmax
accumulator (flash-attention style running max / denominator), so the
result is EXACT full attention with O(T/S) memory per device and
communication around the device ring.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from danet_tpu.ops import nn as nn_ops


def _fold_block(acc, m, denom, q, k, v, scale, kmask, band=None):
    """Fold one K/V block into the online-softmax state.

    q [B,Tq,H,D]; k/v [B,Tk,H,D]; kmask [B,Tk] (True = valid key).
    band: optional [Tq,Tk] bool (causal-window mask in GLOBAL positions).
    acc [B,Tq,H,D] (unnormalized), m/denom [B,Tq,H].
    """
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    mask = kmask[:, None, None, :]
    if band is not None:
        mask = mask & band[None, None]
    logits = jnp.where(mask, logits, -1e9)
    blk_max = jnp.max(logits, axis=-1)                    # [B,H,Tq]
    m_new = jnp.maximum(m, jnp.moveaxis(blk_max, 1, 2))   # [B,Tq,H]
    correction = jnp.exp(m - m_new)
    p = jnp.exp(logits
                - jnp.moveaxis(m_new, 1, 2)[:, :, :, None])  # [B,H,Tq,Tk]
    p_sum = jnp.moveaxis(jnp.sum(p, axis=-1), 1, 2)       # [B,Tq,H]
    pv = jnp.einsum("bhqk,bkhd->bqhd", p, v,
                    preferred_element_type=jnp.float32)
    acc = acc * correction[..., None] + pv
    denom = denom * correction + p_sum
    return acc, m_new, denom


def ring_attention(q, k, v, mesh, seq_axis: str = "seq",
                   key_mask=None, data_axis: str = "data",
                   causal_window: int = 0):
    """Exact multi-head attention with T sharded over `seq_axis`.

    Args:
        q, k, v: GLOBAL [B, T, H, D] (T divisible by the axis size)
        key_mask: optional GLOBAL [B, T] bool; False keys are excluded
        data_axis: mesh axis to shard B over as well (skipped when absent
            or the batch does not divide) — composes dp x sp
        causal_window: when > 0, apply the ATTN_CAUSAL banded mask in
            GLOBAL frame positions — query t attends to keys in
            (t - causal_window, t].  Each fold knows which global block
            the rotating K/V slab came from, so the band is exact across
            device boundaries (same mask as
            AttentionEncoder._dense_attention's `band`).
    Returns:
        [B, T, H, D] attention output (f32 accumulate, input dtype out)
    """
    s = mesh.shape[seq_axis]
    b, t, heads, hd = q.shape
    assert t % s == 0
    chunk = t // s
    scale = 1.0 / float(hd) ** 0.5
    if key_mask is None:
        key_mask = jnp.ones((b, t), bool)
    from danet_tpu.parallel.seq_parallel import _mesh_data_axis
    d_axis = _mesh_data_axis(mesh, b, data_axis)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(d_axis, seq_axis), P(d_axis, seq_axis),
                  P(d_axis, seq_axis), P(d_axis, seq_axis)),
        out_specs=P(d_axis, seq_axis))
    def run(q_loc, k_loc, v_loc, mask_loc):
        perm = [(i, (i + 1) % s) for i in range(s)]
        qf = q_loc.astype(jnp.float32)
        # accumulators must carry the varying type (seq, plus data under
        # dp x sp) under shard_map
        vary = (seq_axis,) if d_axis is None else (seq_axis, d_axis)
        acc = jax.lax.pcast(
            jnp.zeros(q_loc.shape, jnp.float32), vary, to="varying")
        m = jax.lax.pcast(
            jnp.full(q_loc.shape[:3], -jnp.inf, jnp.float32), vary,
            to="varying")
        denom = jax.lax.pcast(
            jnp.zeros(q_loc.shape[:3], jnp.float32), vary,
            to="varying")

        def rotate(blks):
            return tuple(jax.lax.ppermute(b, seq_axis, perm) for b in blks)

        r = jax.lax.axis_index(seq_axis)

        def step(i, state):
            acc, m, denom, k_blk, v_blk, mask_blk = state
            band = None
            if causal_window:
                # at fold i this device holds the K/V slab that STARTED
                # on ring position (r - i) mod s; rebuild the global
                # band mask from both slabs' global frame offsets
                src = (r - i) % s
                qpos = r * chunk + jnp.arange(chunk)[:, None]
                kpos = src * chunk + jnp.arange(chunk)[None, :]
                band = nn_ops.causal_band(qpos, kpos, causal_window)
            acc, m, denom = _fold_block(
                acc, m, denom, qf, k_blk.astype(jnp.float32),
                v_blk.astype(jnp.float32), scale, mask_blk, band)
            # the last iteration's rotation would be dead traffic
            k_blk, v_blk, mask_blk = jax.lax.cond(
                i < s - 1, rotate, lambda blks: blks,
                (k_blk, v_blk, mask_blk))
            return acc, m, denom, k_blk, v_blk, mask_blk

        acc, m, denom, _, _, _ = jax.lax.fori_loop(
            0, s, step, (acc, m, denom, k_loc, v_loc, mask_loc))
        return (acc / denom[..., None]).astype(q_loc.dtype)

    return run(q, k, v, key_mask)
