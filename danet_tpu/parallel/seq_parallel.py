"""Sequence-parallel (Bi)LSTM: exact boundary-state relay or halo warmup.

SURVEY.md §2.4/§5: the reference handles long sequences only by cropping;
true sequence parallelism for recurrences is blocked by the sequential
state chain.  Two schemes are implemented (SP_RNN_SCHEME):

* ``relay`` (default, EXACT): the T axis is sharded over a 'seq' mesh
  axis and the true boundary states are relayed through the device ring —
  S rounds, each a local chunk scan followed by a one-hop ``ppermute`` of
  the final (c, h) to the next device.  Device k's round-k scan starts
  from the state device k-1 finished round k-1 with, so its outputs equal
  the dense scan bit-for-bit; a ``where(idx == round)`` keeps exactly
  those.  Sequential depth stays O(T) — an exact recurrence cannot beat
  that — so the relay buys MEMORY scaling (each device stores 1/S of the
  activations; inputs, outputs and every pointwise stage stay T-sharded)
  and composes with dp/tp for throughput, at dense-scan wall-clock.

* ``halo`` (approximate, lower latency): every device warms its LSTM
  state up on a halo of frames received from its neighbour,
  then discards the halo outputs.  The recurrence is exact within a chunk
  and approximate across chunk boundaries with error decaying in the halo
  length (LSTM state has finite memory).  Wall-clock per layer
  ~ (chunk + halo)/chunk / S of the sequential scan — the scheme to pick
  when latency matters more than bit-exactness.

Comms per layer: relay = S-1 state hops per direction (tiny [B, H]
messages); halo = two edge-slice ppermutes.

Composes with data parallelism: when the mesh also carries a 'data' axis
(and the batch divides over it), the batch dim is sharded over 'data'
inside the same shard_map, so a dp x sp mesh runs each (batch shard,
chunk) pair on its own device.  Trainer-reachable via MESH_SEQ (the
BiLstmEncoder routes through here when MESH_SEQ > 1); dropout between
layers is supported for that path, with masks decorrelated across mesh
positions by folding the device's coordinates into the key.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from danet_tpu.ops import rnn


def _shift_from_left(x_edge, axis_name):
    """Every device receives its LEFT neighbour's edge slice (device 0
    receives zeros)."""
    s = jax.lax.psum(1, axis_name)
    perm = [(i, i + 1) for i in range(s - 1)]
    return jax.lax.ppermute(x_edge, axis_name, perm)


def _shift_from_right(x_edge, axis_name):
    """Every device receives its RIGHT neighbour's edge slice (device S-1
    receives zeros)."""
    s = jax.lax.psum(1, axis_name)
    perm = [(i + 1, i) for i in range(s - 1)]
    return jax.lax.ppermute(x_edge, axis_name, perm)


def _bilstm_layer_local(p, x_loc, halo: int, axis_name: str,
                        candidate_activation: str, vary_axes=None):
    """One BiLSTM layer on a local chunk [B, C, F] with halo warmup.

    Each direction runs a short warmup scan over the neighbour's halo
    frames to estimate the state at the chunk boundary, then the main
    scan over the local chunk seeded with that state.  Ring-EDGE devices
    (first chunk for the forward direction, last for the backward) zero
    the warmup state instead: their true initial state IS zero, and
    warming up on the zeroed ppermute fill would drift the state off zero
    through the gate biases.  Consequence: edge chunks are exact, and at
    S=2 with halo == chunk the whole layer is exact."""
    left = _shift_from_left(x_loc[:, -halo:], axis_name)
    right = _shift_from_right(x_loc[:, :halo], axis_name)

    # initial states must be marked varying over every axis the input is
    # sharded on (seq, plus data under dp x sp) for the scan carry to
    # type-check under shard_map
    hdim = p["fwd"]["wh"].shape[0]
    zero = jax.lax.pcast(
        jnp.zeros((x_loc.shape[0], hdim), x_loc.dtype),
        vary_axes if vary_axes is not None else axis_name,
        to="varying")
    idx = jax.lax.axis_index(axis_name)
    s = jax.lax.psum(1, axis_name)

    def boundary_state(params, x_halo, reverse, is_edge):
        _, (c_w, h_w) = rnn.lstm_apply(
            params, x_halo, candidate_activation, reverse=reverse,
            c0=zero, h0=zero, return_state=True)
        keep = jnp.where(is_edge, 0.0, 1.0).astype(c_w.dtype)
        return c_w * keep, h_w * keep

    c0f, h0f = boundary_state(p["fwd"], left, False, idx == 0)
    h_f = rnn.lstm_apply(p["fwd"], x_loc, candidate_activation,
                         c0=c0f, h0=h0f)
    c0b, h0b = boundary_state(p["bwd"], right, True, idx == s - 1)
    h_b = rnn.lstm_apply(p["bwd"], x_loc, candidate_activation,
                         reverse=True, c0=c0b, h0=h0b)
    return jnp.concatenate([h_f, h_b], axis=-1)


def _relay_direction(scan_fn, x_loc, hdim: int, axis_name: str, vary_axes,
                     reverse: bool, n_state: int = 2):
    """EXACT sequence parallelism for one scan direction: S rounds of
    local chunk scans with the true boundary state relayed one hop per
    round.  ``scan_fn(x, state0) -> (y, state_end)`` runs the local
    recurrence (state is a tuple of [B, H] arrays).  At round r only
    device r (forward) / S-1-r (reverse) holds a correct incoming state;
    its outputs are selected into the result.  All other rounds' outputs
    are discarded by the select, so their (garbage) states never reach a
    kept output — and the select also zeroes their gradient paths, making
    the backward pass exact too (ppermute transposes to the reverse hop).
    """
    s = jax.lax.psum(1, axis_name)  # static axis size
    idx = jax.lax.axis_index(axis_name)
    b, chunk = x_loc.shape[0], x_loc.shape[1]

    def pv(z):
        return jax.lax.pcast(z, vary_axes, to="varying")

    zero = pv(jnp.zeros((b, hdim), x_loc.dtype))
    out0 = pv(jnp.zeros((b, chunk, hdim), x_loc.dtype))
    hop = _shift_from_right if reverse else _shift_from_left

    def body(carry, r):
        state, out = carry
        y, state_end = scan_fn(x_loc, state)
        active = idx == (s - 1 - r if reverse else r)
        out = jnp.where(active, y, out)
        state = tuple(hop(z, axis_name) for z in state_end)
        return (state, out), None

    (_, out), _ = jax.lax.scan(
        body, ((zero,) * n_state, out0), jnp.arange(s))
    return out


def _bilstm_layer_relay(p, x_loc, axis_name: str,
                        candidate_activation: str, vary_axes):
    """One EXACT sequence-parallel BiLSTM layer on a local chunk
    [B, C, F]: forward relay left-to-right, backward relay right-to-left
    (the two directions' rounds interleave, so both rings are busy)."""
    hdim = p["fwd"]["wh"].shape[0]

    def direction(pp, reverse):
        def scan_fn(x, state):
            c0, h0 = state
            y, (c, h) = rnn.lstm_apply(
                pp, x, candidate_activation, reverse=reverse,
                c0=c0, h0=h0, return_state=True)
            return y, (c, h)

        return _relay_direction(scan_fn, x_loc, hdim, axis_name,
                                vary_axes, reverse)

    h_f = direction(p["fwd"], False)
    h_b = direction(p["bwd"], True)
    return jnp.concatenate([h_f, h_b], axis=-1)


def _gru_layer_relay(p, x_loc, axis_name: str, vary_axes):
    """One EXACT sequence-parallel unidirectional GRU layer (relay of the
    single [B, H] state, forward direction only)."""
    hdim = p["wch"].shape[0]

    def scan_fn(x, state):
        y, c = rnn.gru_apply(p, x, c0=state[0], return_state=True)
        return y, (c,)

    return _relay_direction(scan_fn, x_loc, hdim, axis_name, vary_axes,
                            reverse=False, n_state=1)


def _gru_layer_local(p, x_loc, halo: int, axis_name: str, vary_axes):
    """One unidirectional GRU layer on a local chunk with halo warmup
    (same edge-zeroing scheme as the BiLSTM forward direction)."""
    left = _shift_from_left(x_loc[:, -halo:], axis_name)
    hdim = p["wch"].shape[0]
    zero = jax.lax.pcast(
        jnp.zeros((x_loc.shape[0], hdim), x_loc.dtype), vary_axes,
        to="varying")
    _, c_w = rnn.gru_apply(p, left, c0=zero, return_state=True)
    keep = jnp.where(jax.lax.axis_index(axis_name) == 0, 0.0, 1.0)
    return rnn.gru_apply(p, x_loc, c0=c_w * keep.astype(c_w.dtype))


def gru_stack_sp(params_list, x, mesh, halo: int = 32,
                 seq_axis: str = "seq", data_axis: str = "data",
                 drop_keys=None, keep_prob: float = 1.0,
                 remat: bool = False, scheme: str = "relay"):
    """Sequence-parallel stack of unidirectional GRU layers (gru-v1
    encoder) — same contract as bilstm_stack_sp."""
    s = mesh.shape[seq_axis]
    assert x.shape[1] % s == 0, "T must divide across the seq axis"
    if scheme == "halo":
        assert halo >= 1
        assert x.shape[1] // s >= halo, "chunk must be >= halo"
    elif scheme != "relay":
        raise ValueError("unknown SP_RNN_SCHEME %r" % (scheme,))
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    x_spec = P(d_axis, seq_axis, None)
    if drop_keys is None:
        drop_keys = [None] * len(params_list)
    key_mask = [k is not None for k in drop_keys]
    keys_in = [k for k in drop_keys if k is not None]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), x_spec, P()),
        out_specs=x_spec)
    def run(params_list, x_loc, keys_in):
        coord = jax.lax.axis_index(seq_axis)
        if d_axis is not None:
            coord = coord * jax.lax.psum(1, d_axis) \
                + jax.lax.axis_index(d_axis)
        vary = (seq_axis,) if d_axis is None else (seq_axis, d_axis)
        kiter = iter(keys_in)
        y = x_loc
        for p, has_key in zip(params_list, key_mask):
            if scheme == "relay":
                layer = _maybe_ckpt(lambda pp, v: _gru_layer_relay(
                    pp, v, seq_axis, vary), remat)
            else:
                layer = _maybe_ckpt(lambda pp, v: _gru_layer_local(
                    pp, v, halo, seq_axis, vary), remat)
            y = layer(p, y)
            if has_key:
                from danet_tpu.ops.nn import dropout
                y = dropout(jax.random.fold_in(next(kiter), coord),
                            y, keep_prob)
        return y

    return run(params_list, x, keys_in)


def tcn_stack_sp(params, x, mesh, dilations, kernel: int, causal: bool,
                 alpha: float, seq_axis: str = "seq",
                 data_axis: str = "data",
                 drop_keys=None, keep_prob: float = 1.0,
                 remat: bool = False):
    """EXACT sequence-parallel TCN stack (tcn-v1 encoder).

    Unlike the recurrent halo scheme above (boundary-approximate, error
    decaying in the halo), a dilated conv needs only a FINITE context of
    (K-1)*dilation frames per block — so exchanging exactly that halo of
    the conv input with the neighbour devices reproduces the dense
    computation bit-for-bit: the ppermute zero-fill at the ring edges IS
    the zero padding the global conv applies at the sequence edges.
    Comms: one (causal) or two (non-causal) edge-slice ppermutes per
    block.

    Args:
        params: {"bottleneck": linear, "block{i}": TCN block dicts} (the
            TcnEncoder param tree minus the output head)
        x: GLOBAL centered input [B, T, F]; T must divide by the seq axis
            and each chunk must cover the largest (K-1)*dilation span
        dilations: per-block dilation list (len = number of blocks)
        kernel, causal, alpha: TcnEncoder block hyperparameters
        drop_keys/keep_prob: optional per-block dropout (masks
            decorrelated across mesh positions)
    Returns:
        hidden [B, T, D] (global, T-sharded internally); apply the output
        head outside (pointwise — GSPMD handles its global mean).
    """
    from danet_tpu.ops import nn
    s = mesh.shape[seq_axis]
    t = x.shape[1]
    assert t % s == 0, "T must divide across the seq axis"
    chunk = t // s
    max_span = max((kernel - 1) * d for d in dilations)
    assert chunk >= max_span, (
        "chunk %d < largest conv span %d — lower MESH_SEQ or the "
        "TCN_BLOCKS dilation ceiling" % (chunk, max_span))
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    x_spec = P(d_axis, seq_axis, None)
    n_blocks = len(dilations)
    if drop_keys is None:
        drop_keys = [None] * n_blocks
    key_mask = [k is not None for k in drop_keys]
    keys_in = [k for k in drop_keys if k is not None]

    from danet_tpu.ops.nn import layer_norm as _ln

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), x_spec, P()),
        out_specs=x_spec)
    def run(params, x_loc, keys_in):
        coord = jax.lax.axis_index(seq_axis)
        if d_axis is not None:
            coord = coord * jax.lax.psum(1, d_axis) \
                + jax.lax.axis_index(d_axis)
        kiter = iter(keys_in)
        h = nn.linear_apply(params["bottleneck"], x_loc)

        def one_block(blk, h, dil):
            y = _ln(blk["ln1"], h)
            y = nn.leaky_relu(nn.linear_apply(blk["in"], y), alpha)
            span = (kernel - 1) * dil
            parts = []
            if causal:
                if span > 0:
                    parts.append(_shift_from_left(y[:, -span:], seq_axis))
                parts.append(y)
            else:
                lspan, rspan = span // 2, span - span // 2
                if lspan > 0:
                    parts.append(_shift_from_left(y[:, -lspan:], seq_axis))
                parts.append(y)
                if rspan > 0:
                    parts.append(_shift_from_right(y[:, :rspan], seq_axis))
            ycat = jnp.concatenate(parts, axis=1) if len(parts) > 1 else y
            # VALID depthwise conv in f32 (same dtype policy as
            # ops.nn.conv1d_depthwise_apply)
            w = blk["dconv"]["w"]
            yc = jax.lax.conv_general_dilated(
                jnp.swapaxes(ycat, 1, 2).astype(jnp.float32), w,
                window_strides=(1,), padding=[(0, 0)],
                rhs_dilation=(dil,),
                dimension_numbers=("NCH", "OIH", "NCH"),
                feature_group_count=w.shape[0])
            yc = (yc + blk["dconv"]["b"][None, :, None]).astype(y.dtype)
            y = jnp.swapaxes(yc, 1, 2)
            y = nn.leaky_relu(_ln(blk["ln2"], y), alpha)
            y = nn.linear_apply(blk["out"], y)
            return h + y

        for i, dil in enumerate(dilations):
            block = _maybe_ckpt(
                lambda b, v, d=dil: one_block(b, v, d), remat)
            h = block(params[f"block{i}"], h)
            if key_mask[i]:
                from danet_tpu.ops.nn import dropout
                h = dropout(jax.random.fold_in(next(kiter), coord),
                            h, keep_prob)
        return h

    return run(params, x, keys_in)


def _mesh_data_axis(mesh, batch: int, data_axis):
    """'data' when the mesh carries it and the batch divides over it."""
    if data_axis and data_axis in mesh.shape \
            and mesh.shape[data_axis] > 1 and batch % mesh.shape[data_axis] == 0:
        return data_axis
    return None


def _maybe_ckpt(fn, remat: bool):
    """REMAT support inside the SP shard_maps: recompute a layer's
    activations in the backward pass instead of storing them (same
    policy the sequential encoder branches apply via _maybe_remat —
    without this, enabling sequence parallelism would silently DROP the
    rematerialization a memory-sized config depends on).  Collectives
    inside the layer (ppermute halos, all_to_all) replay on the
    recompute, which XLA supports under shard_map."""
    return jax.checkpoint(fn) if remat else fn


def bilstm_stack_sp(params_list, x, mesh, halo: int = 32,
                    seq_axis: str = "seq",
                    candidate_activation: str = "tanh",
                    data_axis: str = "data",
                    drop_keys=None, keep_prob: float = 1.0,
                    remat: bool = False, scheme: str = "relay"):
    """Run a stack of BiLSTM layers sequence-parallel over `seq_axis`.

    Args:
        params_list: list of bilstm param dicts ({'fwd':..., 'bwd':...})
        x: GLOBAL input [B, T, F]; T must divide by the seq axis size (and
           for scheme='halo' each chunk must be >= halo)
        mesh: jax.sharding.Mesh containing `seq_axis`
        halo: warmup frames exchanged per layer per direction ('halo' only)
        data_axis: mesh axis to shard the batch over as well (skipped when
           absent from the mesh or the batch does not divide)
        drop_keys: optional list of per-layer PRNG keys (None entries skip
           that layer); masks are decorrelated across devices
        keep_prob: dropout keep probability for the drop_keys path
        scheme: 'relay' (EXACT boundary-state relay, the default) or
           'halo' (approximate warmup, lower latency) — module docstring
    Returns:
        [B, T, 2*hdim] (global, T-sharded internally)
    """
    s = mesh.shape[seq_axis]
    assert x.shape[1] % s == 0, "T must divide across the seq axis"
    if scheme == "halo":
        assert halo >= 1, "halo must be >= 1 (x[:, -halo:] with halo=0 " \
            "would select the whole chunk, not an empty one)"
        assert x.shape[1] // s >= halo, "chunk must be >= halo"
    elif scheme != "relay":
        raise ValueError("unknown SP_RNN_SCHEME %r" % (scheme,))
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    x_spec = P(d_axis, seq_axis, None)
    if drop_keys is None:
        drop_keys = [None] * len(params_list)
    key_mask = [k is not None for k in drop_keys]
    keys_in = [k for k in drop_keys if k is not None]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), x_spec, P()),
        out_specs=x_spec)
    def run(params_list, x_loc, keys_in):
        # decorrelate dropout masks across mesh positions (each device
        # holds a distinct (batch shard, chunk) tile)
        coord = jax.lax.axis_index(seq_axis)
        if d_axis is not None:
            coord = coord * jax.lax.psum(1, d_axis) \
                + jax.lax.axis_index(d_axis)
        kiter = iter(keys_in)
        vary = (seq_axis,) if d_axis is None else (seq_axis, d_axis)
        y = x_loc
        for p, has_key in zip(params_list, key_mask):
            if scheme == "relay":
                layer = _maybe_ckpt(lambda pp, v: _bilstm_layer_relay(
                    pp, v, seq_axis, candidate_activation,
                    vary_axes=vary), remat)
            else:
                layer = _maybe_ckpt(lambda pp, v: _bilstm_layer_local(
                    pp, v, halo, seq_axis, candidate_activation,
                    vary_axes=vary), remat)
            y = layer(p, y)
            if has_key:
                from danet_tpu.ops.nn import dropout
                y = dropout(jax.random.fold_in(next(kiter), coord),
                            y, keep_prob)
        return y

    return run(params_list, x, keys_in)


def conv_bilstm_sp(params, x, mesh, nfft: int, feature_size: int,
                   embed_size: int, alpha: float, act: str,
                   seq_axis: str = "seq", data_axis: str = "data",
                   drop_keys=None, keep_prob: float = 1.0,
                   remat: bool = False):
    """EXACT sequence-parallel conv-bilstm-v1 encoder (VERDICT r4 item 5:
    the reference's measured-strongest architecture gets a first-class SP
    route).

    Composition of the two exact SP mechanisms this module already
    carries, matched to the encoder's mixed architecture
    (models/encoders.py::ConvBiLstmEncoder, reference modules.py:263-379):

    - every SAME conv exchanges exactly its k//2-frame halo with the ring
      neighbours (the tcn_stack_sp mechanism); the ppermute zero-fill at
      the ring edges IS the zero padding the global SAME conv applies, so
      the sharded conv is bit-exact;
    - the 2x2/2 max pools are shard-local and exact because each chunk's
      frame count stays even (T must divide by 4*S, the dense contract's
      LENGTH_ALIGN times the ring size);
    - the per-example global mean centerings psum partial sums over the
      ring;
    - the two BiLSTM layers run the EXACT boundary-state relay
      (_bilstm_layer_relay, the bilstm-orig SP scheme);
    - pixel-shuffle upsampling and the dense head are pointwise in the
      chunk and stay local.

    Args:
        params: the ConvBiLstmEncoder param tree
        x: GLOBAL log spectra [B, T, F]; T must divide by 4*S and each
            chunk must keep >= 2 frames after the double pooling
        nfft/feature_size/embed_size/alpha/act: encoder hyperparameters
    Returns:
        embeddings [B, T, F, E] (global, T-sharded internally)
    """
    from danet_tpu.ops import nn
    s = mesh.shape[seq_axis]
    t = x.shape[1]
    assert t % (4 * s) == 0, (
        "T=%d must divide by 4*MESH_SEQ=%d (the conv-bilstm pools twice "
        "and every chunk boundary must land on the pooled grid)"
        % (t, 4 * s))
    assert t // (4 * s) >= 2, (
        "chunk too short for the k=3 conv halos after double pooling — "
        "raise MAX_TRAIN_LEN/TIME_BUCKET or lower MESH_SEQ")
    d_axis = _mesh_data_axis(mesh, x.shape[0], data_axis)
    x_spec = P(d_axis, seq_axis, None)
    out_spec = P(d_axis, seq_axis, None, None)
    if drop_keys is None:
        drop_keys = [None, None]
    key_mask = [k is not None for k in drop_keys]
    keys_in = [k for k in drop_keys if k is not None]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), x_spec, P()),
        out_specs=out_spec)
    def run(params, x_loc, keys_in):
        coord = jax.lax.axis_index(seq_axis)
        if d_axis is not None:
            coord = coord * jax.lax.psum(1, d_axis) \
                + jax.lax.axis_index(d_axis)
        kiter = iter(keys_in)
        vary = (seq_axis,) if d_axis is None else (seq_axis, d_axis)
        b = x_loc.shape[0]

        def conv_sp(p, v):
            # halo-extended VALID conv in T x SAME in F == global SAME
            w = p["w"]
            h = w.shape[2] // 2
            parts = []
            if h:
                parts.append(_shift_from_left(v[:, :, -h:], seq_axis))
            parts.append(v)
            if h:
                parts.append(_shift_from_right(v[:, :, :h], seq_axis))
            vc = jnp.concatenate(parts, axis=2) if h else v
            y = jax.lax.conv_general_dilated(
                vc, w.astype(v.dtype), window_strides=(1, 1),
                padding=[(0, 0), (h, h)],
                dimension_numbers=("NCHW", "OIHW", "NCHW"))
            return y + p["b"].astype(v.dtype)[None, :, None, None]

        def centered(v):
            # per-example mean over (C, T_global, F): psum partial sums
            loc = jnp.sum(v.astype(jnp.float32), axis=(1, 2, 3),
                          keepdims=True)
            tot = jax.lax.psum(loc, seq_axis)
            cnt = v.shape[1] * v.shape[2] * v.shape[3] * s
            return v - (tot / cnt).astype(v.dtype)

        v = x_loc[:, None]                                # [B,1,Tc,F]
        v = nn.leaky_relu(conv_sp(params["down0a"], v), alpha)
        v = nn.leaky_relu(conv_sp(params["down0b"], v), alpha)
        v = nn.max_pool_2x2(v)
        v = nn.leaky_relu(conv_sp(params["down1a"], v), alpha)
        v = nn.leaky_relu(conv_sp(params["down1b"], v), alpha)
        v = nn.max_pool_2x2(v)                     # [B,16,Tc/4,nfft/8]
        v = centered(v)
        skip = v

        seq = jnp.transpose(v, (0, 2, 1, 3)).reshape(
            b, v.shape[2], nfft * 2)
        for p, has_key in zip((params["lstm0"], params["lstm1"]),
                              key_mask):
            layer = _maybe_ckpt(lambda pp, u: _bilstm_layer_relay(
                pp, u, seq_axis, act, vary_axes=vary), remat)
            seq = layer(p, seq)
            if has_key:
                from danet_tpu.ops.nn import dropout
                seq = dropout(jax.random.fold_in(next(kiter), coord),
                              seq, keep_prob)
        v = jnp.transpose(
            seq.reshape(b, -1, 16, nfft // 8), (0, 2, 1, 3)) + skip
        v = centered(v)

        v = nn.leaky_relu(conv_sp(params["up0a"], v), alpha)
        v = nn.leaky_relu(conv_sp(params["up0b"], v), alpha)
        t4 = v.shape[2]
        v = v.reshape(b, 16, 2, 2, t4, nfft // 8)
        v = jnp.transpose(v, (0, 1, 4, 2, 5, 3))
        v = v.reshape(b, 16, t4 * 2, nfft // 4)
        v = nn.leaky_relu(conv_sp(params["up1a"], v), alpha)
        v = nn.leaky_relu(conv_sp(params["up1b"], v), alpha)
        v = jnp.transpose(v, (0, 2, 1, 3)).reshape(b, -1, nfft)

        out = nn.linear_apply(params["output"], v)
        return out.reshape(b, -1, feature_size, embed_size)

    return run(params, x, keys_in)


def dprnn_stack_sp(params, x, mesh, p: int, n_blocks: int,
                   inter_causal: bool, seq_axis: str = "seq",
                   data_axis: str = "data",
                   drop_keys=None, keep_prob: float = 1.0,
                   remat: bool = False):
    """EXACT sequence-parallel dual-path RNN stack (dprnn-v1 encoder
    with DPRNN_HOP == DPRNN_CHUNK, i.e. non-overlapping segments).

    Two structural facts make DPRNN sequence parallelism exact with no
    halos and no approximation:

      * the intra-chunk BiLSTM touches only frames INSIDE one P-frame
        segment — segments shard cleanly over the seq axis;
      * the inter-chunk RNN is INDEPENDENT across intra positions — so a
        Ulysses-style ``all_to_all`` re-shards [B, S_local, P, D] into
        [B, S, P_local, D], the inter scan runs over the FULL segment
        axis locally on 1/s of the positions, and a second all_to_all
        restores segment sharding.

    Comms: two all-to-alls per block.  Requires
    T % (P * s) == 0 (whole segments per device) and P % s == 0 (the
    position split).

    Args:
        params: {"bottleneck": linear, "block{i}": dual-path block dicts}
            (the DprnnEncoder param tree minus the output head)
        x: GLOBAL centered input [B, T, F]
        p: DPRNN_CHUNK (= DPRNN_HOP) segment length in frames
        inter_causal: unidirectional inter-chunk LSTM (the online variant)
        drop_keys: optional per-block (intra_key, inter_key) pairs; masks
            are decorrelated across mesh positions
    Returns:
        hidden [B, T, D] (global, T-sharded internally); apply the output
        head outside (pointwise — GSPMD handles its global mean).
    """
    from danet_tpu.ops import nn
    s = mesh.shape[seq_axis]
    b, t, _ = x.shape
    if t % (p * s):
        raise ValueError(
            "T=%d must split into whole %d-frame segments per seq-axis "
            "device (s=%d): pick MAX_TRAIN_LEN / TIME_BUCKET so that "
            "T %% (DPRNN_CHUNK * MESH_SEQ) == 0" % (t, p, s))
    if p % s:
        raise ValueError(
            "DPRNN_CHUNK=%d must divide by MESH_SEQ=%d (the inter-chunk "
            "all_to_all splits the position axis)" % (p, s))
    d_axis = _mesh_data_axis(mesh, b, data_axis)
    x_spec = P(d_axis, seq_axis, None)
    if drop_keys is None:
        drop_keys = [None] * n_blocks
    key_mask = [k is not None for k in drop_keys]
    keys_in = [k for k in drop_keys if k is not None]

    from danet_tpu.ops.nn import layer_norm as _ln

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), x_spec, P()),
        out_specs=x_spec)
    def run(params, x_loc, keys_in):
        coord = jax.lax.axis_index(seq_axis)
        if d_axis is not None:
            coord = coord * jax.lax.psum(1, d_axis) \
                + jax.lax.axis_index(d_axis)
        kiter = iter(keys_in)
        h = nn.linear_apply(params["bottleneck"], x_loc)
        bl, d = h.shape[0], h.shape[-1]
        s_loc = h.shape[1] // p
        chunks = h.reshape(bl, s_loc, p, d)
        def one_block(blk, chunks, dkey):
            # intra-chunk path: segment-local, exact under the sharding
            y = rnn.bilstm_apply(
                blk["intra"], chunks.reshape(bl * s_loc, p, d), "tanh")
            y = nn.linear_apply(blk["intra_proj"], y).reshape(
                bl, s_loc, p, d)
            y = _ln(blk["intra_ln"], y)
            if dkey is not None:
                y = nn.dropout(dkey[0], y, keep_prob)
            chunks = chunks + y
            # inter-chunk path: all_to_all to position sharding, full-S
            # scan on local positions, all_to_all back
            yp = jax.lax.all_to_all(
                chunks, seq_axis, split_axis=2, concat_axis=1, tiled=True)
            s_glob, p_loc = yp.shape[1], yp.shape[2]
            yq = jnp.transpose(yp, (0, 2, 1, 3)).reshape(
                bl * p_loc, s_glob, d)
            if inter_causal:
                yq = rnn.lstm_apply(blk["inter"], yq, "tanh")
            else:
                yq = rnn.bilstm_apply(blk["inter"], yq, "tanh")
            yq = nn.linear_apply(blk["inter_proj"], yq)
            yq = jnp.transpose(
                yq.reshape(bl, p_loc, s_glob, d), (0, 2, 1, 3))
            yq = jax.lax.all_to_all(
                yq, seq_axis, split_axis=1, concat_axis=2, tiled=True)
            y = _ln(blk["inter_ln"], yq)
            if dkey is not None:
                y = nn.dropout(dkey[1], y, keep_prob)
            return chunks + y

        block = _maybe_ckpt(one_block, remat)
        for i in range(n_blocks):
            dkey = (jax.random.split(
                jax.random.fold_in(next(kiter), coord))
                if key_mask[i] else None)
            chunks = block(params[f"block{i}"], chunks, dkey)
        return chunks.reshape(bl, s_loc * p, d)

    return run(params, x, keys_in)
