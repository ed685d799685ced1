"""Ulysses sequence parallelism: all-to-all head-sharded attention.

SURVEY.md §2.4 plans two long-context strategies for the attention
encoder family (the reference has neither — no attention anywhere,
`app/modules.py`): ring attention (parallel/ring_attention.py — K/V
blocks rotate around the device ring, O(T/S) memory, S ppermute rounds)
and this Ulysses-style path: ONE all-to-all converts the T-sharded activations
into head-sharded full-sequence blocks, each device runs plain dense
attention over the whole sequence for H/S heads, and a second
all-to-all restores T-sharding.

Trade-off vs ring: two collectives total (latency-bound) instead of S
rotations (bandwidth-pipelined), full-T logits memory per device but
only for H/S heads.  For the moderate T of speech separation the
all-to-all pair is usually cheaper; ring wins once T is too long for
full-T logits to fit device memory.  Requires heads % S == 0 (ring instead
requires nothing of H).  Both are EXACT — same output as
`AttentionEncoder._dense_attention` up to f32 accumulation order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from danet_tpu.ops import nn as nn_ops


def ulysses_attention(q, k, v, mesh, seq_axis: str = "seq",
                      key_mask=None, data_axis: str = "data",
                      causal_window: int = 0):
    """Exact multi-head attention with T sharded over `seq_axis`,
    computed head-sharded after an all-to-all.

    Args:
        q, k, v: GLOBAL [B, T, H, D] (T and H divisible by the axis size)
        key_mask: optional GLOBAL [B, T] bool; False keys are excluded
        data_axis: mesh axis to shard B over as well (skipped when absent
            or the batch does not divide) — composes dp x sp
        causal_window: when > 0, AND in the ATTN_CAUSAL banded mask —
            query t attends to keys in (t - causal_window, t].  Trivial
            here: after the all-to-all each device sees the FULL
            sequence for its head group, so the global band applies
            directly (same mask as _dense_attention's `band`).
    Returns:
        [B, T, H, D] attention output (f32 accumulate, input dtype out)
    """
    s = mesh.shape[seq_axis]
    b, t, heads, hd = q.shape
    assert t % s == 0, (t, s)
    assert heads % s == 0, ("Ulysses shards heads over the seq axis; "
                            "use ring_attention when H %% S != 0", heads, s)
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
        # [B, T/S, H, D] -> [B, T, H/S, D]: scatter head groups,
        # gather sequence blocks — one fused all-to-all each way.
        def heads_to_seq(x):
            return jax.lax.all_to_all(
                x, seq_axis, split_axis=2, concat_axis=1, tiled=True)

        qh = heads_to_seq(q_loc).astype(jnp.float32)
        kh = heads_to_seq(k_loc).astype(jnp.float32)
        vh = heads_to_seq(v_loc).astype(jnp.float32)
        mask = jax.lax.all_gather(
            mask_loc, seq_axis, axis=1, tiled=True)       # [B, T]

        logits = jnp.einsum("bqhd,bkhd->bhqk", qh, kh,
                            preferred_element_type=jnp.float32) * scale
        full = mask[:, None, None, :]
        if causal_window:
            band = nn_ops.causal_band(jnp.arange(t)[:, None],
                                      jnp.arange(t)[None, :], causal_window)
            full = full & band[None, None]
        logits = jnp.where(full, logits, -1e9)
        attn = jax.nn.softmax(logits, axis=-1)
        out = jnp.einsum("bhqk,bkhd->bqhd", attn, vh,
                         preferred_element_type=jnp.float32)
        # [B, T, H/S, D] -> [B, T/S, H, D]
        out = jax.lax.all_to_all(
            out.astype(q_loc.dtype), seq_axis,
            split_axis=1, concat_axis=2, tiled=True)
        return out

    return run(q, k, v, key_mask)
