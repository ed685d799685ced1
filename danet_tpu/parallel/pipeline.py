"""Pipeline parallelism: GPipe-style microbatching over encoder layers.

SURVEY.md §2.4 marks PP "not warranted" for a 4-layer encoder, and the
trainer does not use it by default — but the capability is trainer-reachable
(set MESH_PIPE in the config; mesh_from_hparams adds a 'pipe' axis and the
BiLSTM encoders route their stacks through here): consecutive BiLSTM layers
are grouped into one stage per device along the 'pipe' mesh axis (each
device holds ONLY its stage's weights — the stacked layer pytree is sharded
over the axis), the batch is split into microbatches, and activations flow
stage-to-stage via `ppermute` in a software-pipelined schedule
of ``n_micro + n_stages - 1`` ticks (bubble fraction (S-1)/(M+S-1)).

The schedule is pure lax ops with a static trip count, so JAX autodiff
differentiates through it — GPipe semantics fall out for free: the backward
pass re-runs the schedule in reverse (transposed ppermutes), and parameter
gradients accumulate across microbatches exactly as in the sequential
model.  Gradient parity with the unpipelined stack is tested
(tests/test_parallel.py).  Layer 0's smaller input width is zero-padded up
to the inter-stage width so every stage runs the same program on
identically-shaped params.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from danet_tpu.ops import rnn


def _pad_layer_params(p, in_dim: int):
    """Zero-pad a bilstm layer's input dim up to in_dim (homogeneous
    stacking across stages; zero rows contribute nothing)."""
    def pad_dir(d):
        wx = d["wx"]
        pad = in_dim - wx.shape[0]
        if pad:
            wx = jnp.pad(wx, [(0, pad), (0, 0), (0, 0)])
        return {"wx": wx, "wh": d["wh"], "b": d["b"]}
    return {"fwd": pad_dir(p["fwd"]), "bwd": pad_dir(p["bwd"])}


def _stage_stack(params_list, n_stages: int):
    """Pad layer-0's input dim to the inter-stage width and stack the
    layer pytrees into [S, L, ...] leaves (S stages of L consecutive
    layers).  Pure jnp — safe under jit tracing; shard_map's in_specs
    slice the stage axis onto the 'pipe' devices."""
    hdim = params_list[0]["fwd"]["wh"].shape[0]
    width = 2 * hdim
    padded = [_pad_layer_params(p, width) for p in params_list]
    per_stage = len(padded) // n_stages
    stacked = jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls).reshape(
            (n_stages, per_stage) + ls[0].shape), *padded)
    return stacked, width


def stack_pipeline_params(params_list, mesh, pipe_axis: str = "pipe"):
    """Eager pre-staging: stack + place the layer pytrees sharded over
    `pipe_axis` (each device then holds ONLY its stage's weights).  Reuse
    the result across calls to avoid re-staging host arrays."""
    stacked, _ = _stage_stack(params_list, mesh.shape[pipe_axis])
    shardings = jax.tree_util.tree_map(
        lambda v: jax.NamedSharding(mesh, P(pipe_axis)), stacked)
    return jax.device_put(stacked, shardings)


def bilstm_stack_pipelined(params_list, x, mesh, n_micro: int = 4,
                           pipe_axis: str = "pipe",
                           candidate_activation: str = "tanh",
                           stacked=None,
                           dropout_rng=None, keep_prob: float = 1.0,
                           remat: bool = False):
    """Run a BiLSTM stack pipelined over `pipe_axis`.

    Args:
        params_list: one bilstm param dict per layer; len must be a
            multiple of the axis size (consecutive layers group into one
            stage per device)
        x: [B, T, F] with B divisible by n_micro
        mesh: Mesh containing `pipe_axis`
        stacked: optional pre-stacked/sharded params from
            stack_pipeline_params (avoids re-staging per call)
        dropout_rng/keep_prob: per-layer dropout between stacked layers
            (matches the sequential stack's placement; keys derive from
            (layer, microbatch) so each microbatch draws fresh masks)
    Returns:
        [B, T, 2*hdim]
    """
    s = mesh.shape[pipe_axis]
    n_layers = len(params_list)
    assert n_layers % s == 0, (
        "%d layers must group evenly over %d pipeline stages"
        % (n_layers, s))
    per_stage = n_layers // s
    b, t, f = x.shape
    assert b % n_micro == 0
    mb = b // n_micro
    hdim = params_list[0]["fwd"]["wh"].shape[0]
    width = 2 * hdim  # inter-stage activation width
    assert width >= f, "inter-stage width must cover the input features"

    if stacked is None:
        stacked, _ = _stage_stack(params_list, s)

    use_dropout = dropout_rng is not None and keep_prob < 1.0
    if use_dropout:
        layer_keys = jax.random.split(
            dropout_rng, n_layers).reshape(s, per_stage, 2)
    else:
        # dummy operand keeps the shard_map signature static
        layer_keys = jnp.zeros((s, per_stage, 2), jnp.uint32)

    # microbatches, input features zero-padded to the inter-stage width
    x_mb = jnp.pad(x, [(0, 0), (0, 0), (0, width - f)])
    x_mb = x_mb.reshape(n_micro, mb, t, width)

    # combined dp x pp: if the mesh has a 'data' axis, each data-shard
    # pipelines only its own rows of every microbatch (activations stay
    # batch-sharded; no all-gather of the input)
    data_axis = "data" if "data" in mesh.shape else None
    if data_axis and mb % mesh.shape["data"] != 0:
        data_axis = None  # indivisible rows: replicate instead of failing

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(pipe_axis), P(None, data_axis), P(pipe_axis)),
        out_specs=P(pipe_axis, None, data_axis))
    def run(stage_params, micro, keys):
        # stage_params: this device's layer group (leading axis of size 1)
        my_params = jax.tree_util.tree_map(lambda v: v[0], stage_params)
        my_keys = keys[0]                                   # [L, 2]
        mb = micro.shape[1]                                 # local rows
        stage = jax.lax.axis_index(pipe_axis)
        perm = [(i, i + 1) for i in range(s - 1)]

        def apply_layer(layer, z, key):
            return rnn.bilstm_apply(
                layer, z, candidate_activation, dropout_rng=key,
                keep_prob=keep_prob)

        # REMAT: recompute layer activations in the backward pass (same
        # policy the sequential encoder branch applies per layer)
        apply_fn = jax.checkpoint(apply_layer) if remat else apply_layer

        def stage_apply(z, tick):
            for li in range(per_stage):
                layer = jax.tree_util.tree_map(
                    lambda v: v[li], my_params)
                key = None
                if use_dropout:
                    # fresh mask per (layer, tick) — a microbatch meets
                    # stage q at tick mb_idx+q, so masks never repeat
                    # across layers or microbatches; the data-shard index
                    # folds in so different rows draw different masks
                    key = jax.random.fold_in(my_keys[li], tick)
                    if data_axis:
                        key = jax.random.fold_in(
                            key, jax.lax.axis_index(data_axis))
                z = apply_fn(layer, z, key)
            return z

        n_ticks = n_micro + s - 1
        # loop carries must be marked varying over every axis the computed
        # activations vary over: 'pipe' always, and 'data' when rows are
        # data-sharded (micro slices differ per data shard)
        vary = (pipe_axis,) + ((data_axis,) if data_axis else ())
        out_buf = jax.lax.pcast(
            jnp.zeros((n_micro, mb, t, width), x.dtype), vary,
            to="varying")
        carry = jax.lax.pcast(
            jnp.zeros((mb, t, width), x.dtype), vary, to="varying")

        def tick(i, state):
            carry, out_buf = state
            # stage 0 ingests microbatch i (garbage after the last one —
            # masked out by the collection index below)
            feed_idx = jnp.clip(i, 0, n_micro - 1)
            inp = jnp.where(stage == 0, micro[feed_idx], carry)
            out = stage_apply(inp, i)
            # last stage completed microbatch i-(s-1) this tick
            done_idx = jnp.clip(i - (s - 1), 0, n_micro - 1)
            valid = jnp.logical_and(stage == s - 1, i >= s - 1)
            out_buf = jax.lax.cond(
                valid,
                lambda ob: ob.at[done_idx].set(out),
                lambda ob: ob,
                out_buf)
            carry = jax.lax.ppermute(out, pipe_axis, perm)
            return carry, out_buf

        _, out_buf = jax.lax.fori_loop(0, n_ticks, tick, (carry, out_buf))
        return out_buf[None]  # [1, M, mb, T, width] -> stage axis
    out = run(stacked, x_mb, layer_keys)            # [S, M, mb, T, width]
    return out[-1].reshape(b, t, width)
