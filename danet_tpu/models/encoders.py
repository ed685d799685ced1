"""Encoder zoo: toy MLP, LSTM, BiLSTM, Conv-BiLSTM hybrid.

Re-implementations of the reference encoder registry
(/root/reference/app/modules.py:96-379), with identical registry keys and
architecture hyperparameters (hidden sizes, init ranges, gate-bias inits),
built on the time-major fused-gate scan in danet_tpu.ops.rnn.

Unlike the reference, dropout in the (Bi)LSTM stacks is actually functional
(the reference feeds a dropout placeholder that is never connected —
main.py:225-227,243).
"""
from __future__ import annotations

import functools
from math import sqrt

import jax
import jax.numpy as jnp

from danet_tpu.hparams import hparams
from danet_tpu.models.base import Encoder
from danet_tpu.ops import nn, rnn


def _candidate_activation(hp) -> str:
    """'linear' reproduces the reference's no-tanh candidate cell
    (ops.py:143-147); default is the standard 'tanh'."""
    return "linear" if getattr(hp, "LSTM_LEGACY_CELL", False) else "tanh"


def _maybe_remat(hp, fn):
    """REMAT=true wraps a layer apply in jax.checkpoint: activations are
    recomputed in the backward pass instead of stored — trades FLOPs for
    HBM so the tl=512 curriculum stages fit (SURVEY.md long-context)."""
    return jax.checkpoint(fn) if getattr(hp, "REMAT", False) else fn


def _route_mesh(axis: str, n: int):
    """The active mesh when it carries ``axis`` at size ``n``, else None.

    Model code engages a MESH_* strategy only when the active mesh
    actually provides the axis.  The Trainer builds its mesh via
    mesh_from_hparams (which always carries the configured axes), so
    training routes as configured — and DaNet._check_parallel_support
    still rejects encoders that cannot route a configured strategy at
    all.  Inference surfaces on a smaller host (demo, serving export,
    separate_wav) run the SAME training config densely instead of
    demanding the multi-device training mesh."""
    from danet_tpu.parallel import active_mesh
    from danet_tpu.parallel.sharding import MeshUnavailableError
    try:
        mesh = active_mesh()
    except MeshUnavailableError:
        return None  # mesh_from_hparams on a host with too few devices;
        # any OTHER mesh-construction error is a real bug and propagates
    if axis in mesh.shape and mesh.shape[axis] == n:
        return mesh
    return None


@hparams.register_encoder("toy")
class ToyEncoder(Encoder):
    """3-layer MLP for debugging (reference modules.py:96-116)."""

    def init(self, rng):
        hp = self.hp
        k0, k1 = jax.random.split(rng)
        return {
            "linear0": nn.linear_init(k0, hp.FEATURE_SIZE, hp.FFT_SIZE * 2),
            "linear1": nn.linear_init(
                k1, hp.FFT_SIZE * 2, hp.FEATURE_SIZE * hp.EMBED_SIZE),
        }

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        mid = nn.linear_apply(params["linear0"], log_spectra)
        mid = nn.leaky_relu(mid, hp.RELU_LEAKAGE)
        if tap:
            tap("mid_act", mid)
        out = nn.linear_apply(params["linear1"], mid)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)


class _LstmHead:
    """Shared output head: mean-center + bias-free linear to F*E + reshape
    (reference modules.py:181-195,244-259)."""

    @staticmethod
    def init(rng, hp, in_dim):
        return nn.linear_init(
            rng, in_dim, hp.FEATURE_SIZE * hp.EMBED_SIZE,
            w_scale=1.85, bias=False)

    @staticmethod
    def apply_centered(params, hp, x, mu):
        """Head with an explicit centering statistic (streaming inference
        freezes mu from the warmup window; offline passes the batch mean)."""
        x = x - mu
        out = nn.linear_apply(params, x)
        b, t = x.shape[0], x.shape[1]
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)

    @staticmethod
    def apply(params, hp, x):
        return _LstmHead.apply_centered(
            params, hp, x, jnp.mean(x, axis=(1, 2), keepdims=True))


@hparams.register_encoder("lstm-orig")
class LstmEncoder(Encoder):
    """4x unidirectional LSTM, hdim=600 (reference modules.py:140-196)."""

    HDIM = 600
    N_LAYERS = 4

    def init(self, rng):
        hp = self.hp
        keys = jax.random.split(rng, self.N_LAYERS + 1)
        w_scale = 1.15 / sqrt(self.HDIM)
        gate_bias = (0.0, 1.5, -1.0, 1.0)  # cand, input, forget, output
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"lstm{i}"] = rnn.lstm_init(
                keys[i], in_dim, self.HDIM, w_scale, gate_bias)
            in_dim = self.HDIM
        params["output"] = _LstmHead.init(keys[-1], hp, in_dim)
        return params

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        act = _candidate_activation(hp)
        x = log_spectra - jnp.mean(log_spectra, axis=(1, 2), keepdims=True)
        for i in range(self.N_LAYERS):
            layer = _maybe_remat(hp, lambda p, v: rnn.lstm_apply(p, v, act))
            x = layer(params[f"lstm{i}"], x)
            if tap:
                tap("lstm%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)

    # --- causal streaming hooks (DaNet.separate_stream) -----------------
    def stream_state_init(self, batch: int, dtype=jnp.float32):
        """Zero per-layer (c, h) carry — the state at a fresh utterance."""
        z = jnp.zeros((batch, self.HDIM), dtype)
        return [(z, z) for _ in range(self.N_LAYERS)]

    def stream_hidden(self, params, x, state):
        """Centered input chunk [B, Tc, F] -> (hidden seq [B, Tc, H],
        new state).  Exact continuation: feeding chunks back-to-back
        reproduces the full-sequence scan bit-for-bit."""
        act = _candidate_activation(self.hp)
        new_state = []
        for i in range(self.N_LAYERS):
            c0, h0 = state[i]
            x, (c, h) = rnn.lstm_apply(
                params[f"lstm{i}"], x, act, c0=c0, h0=h0, return_state=True)
            new_state.append((c, h))
        return x, new_state

    def stream_head(self, params, h, mu):
        """Output head with a frozen centering statistic (see
        _LstmHead.apply_centered)."""
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("bilstm-orig")
class BiLstmEncoder(Encoder):
    """4x BiLSTM, hdim=300 per direction, per-layer dropout
    (reference modules.py:199-260) — the paper architecture and the
    flagship encoder of this framework."""

    HDIM = 300
    N_LAYERS = 4

    def init(self, rng):
        hp = self.hp
        keys = jax.random.split(rng, self.N_LAYERS + 1)
        w_scale = 0.75 / sqrt(self.HDIM)
        gate_bias = (0.0, 1.5, -1.0, 1.0)
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"lstm{i}"] = rnn.bilstm_init(
                keys[i], in_dim, self.HDIM, w_scale, gate_bias)
            in_dim = self.HDIM * 2
        params["output"] = _LstmHead.init(keys[-1], hp, in_dim)
        return params

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        x = log_spectra - jnp.mean(log_spectra, axis=(1, 2), keepdims=True)
        n_pipe = int(getattr(hp, "MESH_PIPE", 1) or 1)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        pipe_mesh = _route_mesh("pipe", n_pipe) if n_pipe > 1 else None
        seq_mesh = (_route_mesh("seq", n_seq)
                    if n_seq > 1 and pipe_mesh is None else None)
        if pipe_mesh is not None:
            # trainer-reachable pipeline parallelism: the stack runs
            # GPipe-microbatched over the mesh's 'pipe' axis (exact +
            # differentiable; parallel/pipeline.py)
            x = self._apply_pipelined(
                params, x, pipe_mesh, n_pipe, act, keep,
                rng if (rng is not None and keep < 1.0) else None)
        elif seq_mesh is not None:
            # trainer-reachable sequence parallelism: chunked scans with
            # halo state warmup over the mesh's 'seq' axis (differentiable;
            # boundary-approximate with halo-decaying error;
            # parallel/seq_parallel.py)
            x = self._apply_sp(
                params, x, seq_mesh, n_seq, act, keep,
                rng if (rng is not None and keep < 1.0) else None)
        else:
            drop_keys = (jax.random.split(rng, self.N_LAYERS)
                         if (rng is not None and keep < 1.0) else
                         [None] * self.N_LAYERS)
            for i in range(self.N_LAYERS):
                layer = _maybe_remat(
                    hp, lambda p, v, k: rnn.bilstm_apply(
                        p, v, act, dropout_rng=k, keep_prob=keep))
                x = layer(params[f"lstm{i}"], x, drop_keys[i])
                if tap:
                    tap("lstm%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)

    def _apply_sp(self, params, x, mesh, n_seq, act, keep, rng):
        from danet_tpu.parallel.seq_parallel import bilstm_stack_sp
        hp = self.hp
        t = x.shape[1]
        if t % n_seq:
            raise ValueError(
                "MESH_SEQ=%d must divide the frame count T=%d (pick "
                "MAX_TRAIN_LEN / TIME_BUCKET accordingly)" % (n_seq, t))
        halo = min(int(getattr(hp, "SP_HALO", 0) or 32), t // n_seq)
        layers = [params[f"lstm{i}"] for i in range(self.N_LAYERS)]
        drop_keys = (list(jax.random.split(rng, self.N_LAYERS))
                     if rng is not None else None)
        return bilstm_stack_sp(
            layers, x, mesh, halo=halo, candidate_activation=act,
            drop_keys=drop_keys, keep_prob=keep,
            remat=bool(getattr(hp, "REMAT", False)),
            scheme=getattr(hp, "SP_RNN_SCHEME", "relay") or "relay")

    def _apply_pipelined(self, params, x, mesh, n_pipe, act, keep, rng):
        from danet_tpu.parallel.pipeline import bilstm_stack_pipelined
        hp = self.hp
        layers = [params[f"lstm{i}"] for i in range(self.N_LAYERS)]
        b = x.shape[0]
        n_micro = int(getattr(hp, "PIPE_MICROBATCHES", 0) or 0)
        if not n_micro:
            # default: enough microbatches to keep the bubble small,
            # clipped to a divisor of the batch
            n_micro = min(b, 2 * n_pipe)
            while b % n_micro:
                n_micro -= 1
        return bilstm_stack_pipelined(
            layers, x, mesh, n_micro=n_micro, candidate_activation=act,
            dropout_rng=rng, keep_prob=keep,
            remat=bool(getattr(hp, "REMAT", False)))


@hparams.register_encoder("attn-v1")
class AttentionEncoder(Encoder):
    """Pre-LN transformer encoder over frames (not in the reference).

    Unlike the recurrent encoders, every stage here is a large batched
    GEMM and the T axis carries no sequential dependency, so sequence
    parallelism is exact (ring/blockwise attention is the natural
    multi-chip extension, SURVEY §2.4).
    Config: ATTN_DIM, ATTN_HEADS, ATTN_LAYERS, ATTN_MLP_MULT.

    ATTN_CAUSAL=true switches to causal windowed attention: each frame
    attends to at most the ATTN_LOOKBACK most recent frames (itself
    included).  That bounds the receptive field to
    ATTN_LAYERS * (ATTN_LOOKBACK - 1) past frames and makes the family
    ONLINE-streamable: the stream hooks below carry a per-layer rolling
    K/V cache of the last ATTN_LOOKBACK-1 frames (the standard decode
    cache), so chunked streaming reproduces the full-sequence causal
    forward EXACTLY (tested chunk-size-invariant).  Positional encoding
    stays exact across chunks via a carried global frame offset.
    """

    def _dims(self):
        hp = self.hp

        def get(key, default):
            v = getattr(hp, key, None)
            return default if v is None else int(v)

        d = get("ATTN_DIM", 256)
        heads = get("ATTN_HEADS", 4)
        if d % 2 != 0:
            raise ValueError("ATTN_DIM must be even (got %d)" % d)
        if d % heads != 0:
            raise ValueError(
                "ATTN_DIM (%d) must divide by ATTN_HEADS (%d)" % (d, heads))
        return d, heads, get("ATTN_LAYERS", 4), get("ATTN_MLP_MULT", 4)

    def _mlp_params(self, rng, d, mlp):
        ks = jax.random.split(rng, 2)
        return {
            "mlp_in": nn.linear_init(ks[0], d, mlp * d),
            "mlp_out": nn.linear_init(ks[1], mlp * d, d),
        }

    def init(self, rng):
        hp = self.hp
        d, heads, n_layers, mlp = self._dims()
        keys = jax.random.split(rng, 2 + n_layers)
        params = {
            "embed": nn.linear_init(keys[0], hp.FEATURE_SIZE, d),
            "output": nn.linear_init(
                keys[1], d, hp.FEATURE_SIZE * hp.EMBED_SIZE, bias=False),
        }
        for i in range(n_layers):
            ks = jax.random.split(keys[2 + i], 3)
            params[f"block{i}"] = {
                "qkv": nn.linear_init(ks[0], d, 3 * d),
                "proj": nn.linear_init(ks[1], d, d),
                "ln1": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
                "ln2": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
                **self._mlp_params(ks[2], d, mlp),
            }
        return params

    def _mlp(self, blk, y, train=False):
        return nn.linear_apply(
            blk["mlp_out"], jax.nn.gelu(nn.linear_apply(blk["mlp_in"], y)))

    @staticmethod
    def _ln(p, x):
        return nn.layer_norm(p, x)

    @staticmethod
    def _posenc(t, d, dtype):
        import numpy as _np
        pos = _np.arange(t)[:, None]
        dim = _np.arange(d // 2)[None, :]
        ang = pos / (10000.0 ** (2 * dim / d))
        pe = _np.concatenate([_np.sin(ang), _np.cos(ang)], axis=-1)
        return jnp.asarray(pe.astype("float32")).astype(dtype)

    @staticmethod
    def _dense_attention(q, k, v, key_mask, band=None):
        """Full masked multi-head attention (single-program path).
        `band` optionally adds a [Q, K] causal-window mask on top of the
        per-key padding mask (ATTN_CAUSAL)."""
        hd = q.shape[-1]
        logits = nn.ee("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(
            jnp.asarray(hd, q.dtype))
        mask = key_mask[:, None, None, :]
        if band is not None:
            mask = mask & band[None, None]
        logits = jnp.where(mask, logits.astype(jnp.float32),
                           jnp.asarray(-1e9, jnp.float32))
        attn = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
        return nn.ee("bhqk,bkhd->bqhd", attn, v)

    def _causal_window(self):
        """ATTN_LOOKBACK frames (incl. self) when ATTN_CAUSAL, else 0."""
        if not bool(getattr(self.hp, "ATTN_CAUSAL", False)):
            return 0
        w = getattr(self.hp, "ATTN_LOOKBACK", None)
        w = 128 if w is None else int(w)  # explicit 0 must hit the guard
        if w < 1:
            raise ValueError("ATTN_LOOKBACK must be >= 1 (got %d)" % w)
        return w

    def _sp_attn_fn(self, mesh, causal_window: int = 0):
        kind = str(getattr(self.hp, "SP_ATTN", None) or "ring")
        if kind == "ulysses":
            from danet_tpu.parallel.ulysses import (
                ulysses_attention as sp_attention)
        elif kind == "ring":
            from danet_tpu.parallel.ring_attention import (
                ring_attention as sp_attention)
        else:
            raise ValueError("SP_ATTN must be 'ring' or 'ulysses', got %r"
                             % (kind,))
        return lambda q, k, v, km: sp_attention(
            q, k, v, mesh, key_mask=km, causal_window=causal_window)

    def apply(self, params, log_spectra, train=False, rng=None,
              attn_fn=None, tap=None, attn_fn_is_causal=False):
        """attn_fn(q, k, v, key_mask) -> [B,T,H,D]; defaults to dense
        attention. parallel/ring_attention supplies the exact
        sequence-parallel alternative (see DaNet.separate_sp).
        attn_fn_is_causal: the supplied attn_fn already applies the
        ATTN_CAUSAL band (e.g. causal_window passed to the SP
        collectives) — suppresses the silently-dropped-band guard."""
        hp = self.hp
        d, heads, n_layers, _ = self._dims()
        hd = d // heads
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop_keys = (jax.random.split(rng, n_layers)
                     if (rng is not None and keep < 1.0) else
                     [None] * n_layers)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        causal_w = self._causal_window()
        if causal_w and attn_fn is not None and not attn_fn_is_causal:
            # an externally supplied attn_fn cannot see the band mask —
            # fail loudly rather than silently drop causality (DaNet
            # passes causal_window through separate_sp itself and sets
            # attn_fn_is_causal)
            raise ValueError(
                "ATTN_CAUSAL with an external attn_fn would silently "
                "drop the causal band; pass causal_window to the SP "
                "attention and set attn_fn_is_causal=True "
                "(DaNet.separate_sp does)")
        seq_mesh = (_route_mesh("seq", n_seq)
                    if attn_fn is None and n_seq > 1 else None)
        if seq_mesh is not None:
            # trainer-reachable sequence parallelism: EXACT T-sharded
            # attention over the mesh's 'seq' axis; SP_ATTN picks the
            # collective pattern ('ring' K/V rotation or 'ulysses'
            # all-to-all head sharding); the ATTN_CAUSAL band composes
            # exactly with both (global-position masks inside the
            # collectives)
            attn_fn = self._sp_attn_fn(seq_mesh, causal_window=causal_w)
        elif attn_fn is None and causal_w:
            # causal windowed attention, single-program: EXACT chunked
            # banded attention when the sequence is long enough for the
            # O(T*C) form to pay (ops/local_attention.py), dense banded
            # otherwise.  Must NOT fire when an external attn_fn was
            # supplied: separate_sp passes the SP collective with
            # attn_fn_is_causal=True and overwriting it here would
            # silently run single-program banded attention on every
            # device instead of the T-sharded collective.
            from danet_tpu.ops.local_attention import resolve_banded_attn_fn
            attn_fn = resolve_banded_attn_fn(
                hp, t, causal_w, self._dense_attention)
        elif attn_fn is None:
            attn_fn = self._dense_attention

        # key mask: zero-padded frames (TIME_BUCKET / batch padding) have
        # exactly zero spectra; exclude them as attention keys so padding
        # cannot leak into real frames' embeddings
        key_mask = jnp.any(log_spectra != 0.0, axis=-1)   # [B, T]

        # masked mean-centering (padding must not shift real frames)
        mcount = jnp.sum(key_mask, axis=1)[:, None, None]  # [B,1,1]
        mu = (jnp.sum(log_spectra * key_mask[..., None], axis=(1, 2),
                      keepdims=True)
              / (mcount * log_spectra.shape[-1] + 1e-6))
        x = (log_spectra - mu) * key_mask[..., None].astype(
            log_spectra.dtype)
        h = nn.linear_apply(params["embed"], x)
        h = h + self._posenc(t, d, h.dtype)
        for i in range(n_layers):
            p = params[f"block{i}"]
            y = self._ln(p["ln1"], h)
            qkv = nn.linear_apply(p["qkv"], y).reshape(b, t, 3, heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            o = attn_fn(q, k, v, key_mask).reshape(b, t, d)
            h = h + nn.linear_apply(p["proj"], o)
            y = self._ln(p["ln2"], h)
            y = self._mlp(p, y, train=train)
            if drop_keys[i] is not None:
                y = nn.dropout(drop_keys[i], y, keep)
            h = h + y
            if tap:
                tap("block%d_h" % i, h)
        out = nn.linear_apply(params["output"], h)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)

    # --- causal streaming hooks (ATTN_CAUSAL; DaNet.separate_stream) ----
    @staticmethod
    def _posenc_dyn(offset, t, d, dtype):
        """Sinusoidal positions offset..offset+t-1 with a TRACED offset —
        must match _posenc's formula exactly so streaming equals the
        full-sequence forward."""
        pos = (jnp.arange(t) + offset)[:, None].astype(jnp.float32)
        dim = jnp.arange(d // 2)[None, :].astype(jnp.float32)
        ang = pos / (10000.0 ** (2 * dim / d))
        pe = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)
        return pe.astype(dtype)

    def stream_state_init(self, batch: int, dtype=jnp.float32):
        """Per-layer rolling K/V cache of the last ATTN_LOOKBACK-1 frames
        + the global frame offset and cache fill count."""
        w = self._causal_window()
        if not w:
            raise ValueError(
                "attn-v1 streams only with ATTN_CAUSAL=true (full "
                "bidirectional attention needs future context)")
        d, heads, n_layers, _ = self._dims()
        hd = d // heads
        z = jnp.zeros((batch, w - 1, heads, hd), dtype)
        return {
            "cache": {f"block{i}": {"k": z, "v": z}
                      for i in range(n_layers)},
            "offset": jnp.zeros((), jnp.int32),
            "filled": jnp.zeros((), jnp.int32),
        }

    def stream_hidden(self, params, x, state):
        """Centered chunk [B, Tc, F] -> (hidden [B, Tc, D], new state).
        Exact continuation: each layer's queries attend to the cached
        ATTN_LOOKBACK-1 previous frames' K/V (computed by earlier chunks
        at this layer — causality makes them final) plus the chunk's own,
        under the same causal band mask as apply()."""
        w = self._causal_window()
        d, heads, n_layers, _ = self._dims()
        hd = d // heads
        b, c = x.shape[0], x.shape[1]
        h = nn.linear_apply(params["embed"], x)
        h = h + self._posenc_dyn(state["offset"], c, d, h.dtype)

        # validity of the w-1 cache slots (left-filled with zeros until
        # `filled` real frames have streamed past), then the chunk's own
        # frames — combined with the banded causal mask
        filled = jnp.minimum(state["filled"], w - 1)
        jidx = jnp.arange(w - 1 + c)
        key_valid = jidx >= (w - 1) - filled
        qpos = jnp.arange(c)[:, None] + (w - 1)
        kpos = jidx[None, :]
        mask = nn.causal_band(qpos, kpos, w) & key_valid[None, :]

        new_cache = {}
        for i in range(n_layers):
            p = params[f"block{i}"]
            cache = state["cache"][f"block{i}"]
            y = self._ln(p["ln1"], h)
            qkv = nn.linear_apply(p["qkv"], y).reshape(b, c, 3, heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            kc = jnp.concatenate([cache["k"].astype(k.dtype), k], axis=1)
            vc = jnp.concatenate([cache["v"].astype(v.dtype), v], axis=1)
            logits = nn.ee("bqhd,bkhd->bhqk", q, kc) / jnp.sqrt(
                jnp.asarray(hd, q.dtype))
            logits = jnp.where(mask[None, None],
                               logits.astype(jnp.float32),
                               jnp.asarray(-1e9, jnp.float32))
            attn = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
            o = nn.ee("bhqk,bkhd->bqhd", attn, vc).reshape(b, c, d)
            h = h + nn.linear_apply(p["proj"], o)
            y = self._ln(p["ln2"], h)
            h = h + self._mlp(p, y)
            new_cache[f"block{i}"] = {
                "k": kc[:, kc.shape[1] - (w - 1):],
                "v": vc[:, vc.shape[1] - (w - 1):]}
        return h, {"cache": new_cache,
                   "offset": state["offset"] + c,
                   "filled": jnp.minimum(state["filled"] + c, w - 1)}

    def stream_head(self, params, h, mu):
        """Output head; the attention family applies no output centering
        (apply() has none), so the frozen `mu` is unused."""
        hp = self.hp
        b, t = h.shape[0], h.shape[1]
        out = nn.linear_apply(params["output"], h)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)


@hparams.register_encoder("moe-v1")
class MoEAttentionEncoder(AttentionEncoder):
    """Attention encoder with a mixture-of-experts MLP per block.

    Soft-mixture (dense-dispatch) MoE: out = sum_e gate_e(x) * expert_e(x)
    — exact, differentiable, and expert-parallel-ready (the expert weights
    shard one-group-per-device over an 'expert' mesh axis;
    parallel/expert.py).  Config: MOE_EXPERTS on top of the ATTN_* keys.
    SURVEY §2.4's EP row: the reference has no MoE; this makes the family
    available without changing any registry contract.
    """

    def _n_experts(self):
        v = getattr(self.hp, "MOE_EXPERTS", None)
        return 4 if v is None else int(v)

    def _mlp_params(self, rng, d, mlp):
        n_exp = self._n_experts()
        ks = jax.random.split(rng, 3)
        scale_in = float(jnp.sqrt(6.0 / (d + mlp * d)))
        return {"moe": {
            "router": nn.uniform_init(ks[0], (d, n_exp), 0.02),
            "w_in": nn.uniform_init(ks[1], (n_exp, d, mlp * d), scale_in),
            "w_out": nn.uniform_init(ks[2], (n_exp, mlp * d, d), scale_in),
        }}

    def _mlp(self, blk, y, train=False):
        from danet_tpu.parallel.expert import (moe_mlp, moe_mlp_ep,
                                               moe_mlp_ep_routed,
                                               moe_mlp_topk,
                                               moe_mlp_topk_dropless)
        hp = self.hp
        n_ep = int(getattr(hp, "MESH_EXPERT", 1) or 1)
        mesh = _route_mesh("expert", n_ep) if n_ep > 1 else None
        k = int(getattr(hp, "MOE_TOP_K", 0) or 0)
        if k > 0:
            if not train:
                # inference/streaming is DROPLESS: capacity dropping is
                # batch-global (a token's output depends on which other
                # tokens claimed its experts' slots), which both degrades
                # serving quality and breaks causal chunked streaming's
                # chunk-invariance; capacity is a training-efficiency
                # device only (parallel/expert.py moe_mlp_topk_dropless)
                return moe_mlp_topk_dropless(blk["moe"], y, k=k)
            # top-k routed dispatch with capacity + all_to_all token
            # movement (parallel/expert.py module docstring) — the form
            # that scales communication with routed tokens, not the full
            # activation set
            cf = float(getattr(hp, "MOE_CAPACITY_FACTOR", 1.25) or 1.25)
            if mesh is not None:
                return moe_mlp_ep_routed(blk["moe"], y, mesh, k=k,
                                         capacity_factor=cf)
            return moe_mlp_topk(blk["moe"], y, k=k, capacity_factor=cf)
        if mesh is not None:
            # trainer-reachable expert parallelism: expert groups shard
            # one-per-device over the mesh's 'expert' axis (exact,
            # all-to-all-free; parallel/expert.py); dense dispatch when
            # the active mesh has no expert axis (inference hosts)
            return moe_mlp_ep(blk["moe"], y, mesh)
        return moe_mlp(blk["moe"], y)


@hparams.register_encoder("gru-v1")
class GruEncoder(Encoder):
    """4x unidirectional GRU encoder.

    The reference ships GRU cell machinery (ops.py:151-188, main.py:134-183)
    but never registers a GRU encoder (dead code, SURVEY.md appendix); this
    makes the family usable.  Same head/centering as the LSTM encoders.
    """

    HDIM = 600
    N_LAYERS = 4

    def init(self, rng):
        hp = self.hp
        keys = jax.random.split(rng, self.N_LAYERS + 1)
        w_scale = 0.1 / sqrt(self.HDIM)  # reference main.py:175
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"gru{i}"] = rnn.gru_init(
                keys[i], in_dim, self.HDIM, w_scale)
            in_dim = self.HDIM
        params["output"] = _LstmHead.init(keys[-1], hp, in_dim)
        return params

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        x = log_spectra - jnp.mean(log_spectra, axis=(1, 2), keepdims=True)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh("seq", n_seq) if n_seq > 1 else None
        if mesh is not None:
            # trainer-reachable sequence parallelism (halo scheme,
            # parallel/seq_parallel.gru_stack_sp); dense on meshes
            # without a seq axis (inference hosts)
            from danet_tpu.parallel.seq_parallel import gru_stack_sp
            t = x.shape[1]
            if t % n_seq:
                raise ValueError(
                    "MESH_SEQ=%d must divide the frame count T=%d"
                    % (n_seq, t))
            halo = min(int(getattr(hp, "SP_HALO", 0) or 32), t // n_seq)
            layers = [params[f"gru{i}"] for i in range(self.N_LAYERS)]
            x = gru_stack_sp(layers, x, mesh, halo=halo,
                             remat=bool(getattr(hp, "REMAT", False)),
                             scheme=getattr(hp, "SP_RNN_SCHEME",
                                            "relay") or "relay")
        else:
            for i in range(self.N_LAYERS):
                x = rnn.gru_apply(params[f"gru{i}"], x)
                if tap:
                    tap("gru%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)

    # --- causal streaming hooks (DaNet.separate_stream) -----------------
    def stream_state_init(self, batch: int, dtype=jnp.float32):
        z = jnp.zeros((batch, self.HDIM), dtype)
        return [z for _ in range(self.N_LAYERS)]

    def stream_hidden(self, params, x, state):
        new_state = []
        for i in range(self.N_LAYERS):
            x, c = rnn.gru_apply(params[f"gru{i}"], x, c0=state[i],
                                 return_state=True)
            new_state.append(c)
        return x, new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("tcn-v1")
class TcnEncoder(Encoder):
    """Temporal convolutional encoder (Conv-TasNet-style TCN; new family,
    not in the reference — its only conv architecture is the conv-bilstm
    hybrid, modules.py:263-379).

    A stack of residual blocks, each: channelwise LayerNorm -> 1x1 linear
    (D->H) -> leaky-relu -> depthwise dilated conv over T -> LayerNorm ->
    leaky-relu -> 1x1 linear (H->D), with dilations 1,2,4,...,2^(X-1)
    repeated R times (Luo & Mesgarani 2019's separator module, applied
    here as a DaNet embedding encoder).  Every stage is a batched GEMM or
    a cheap depthwise conv — no sequential T dependency, so the GEMMs stay
    large like the attention encoder while the receptive field stays
    finite (1 + R*(K-1)*(2^X - 1) frames).

    TCN_CAUSAL=true left-pads the depthwise convs, making the encoder
    causal end-to-end: DaNet.separate_stream then streams it EXACTLY with
    a carried per-block tail buffer (constant memory per chunk).
    Config: TCN_DIM, TCN_HIDDEN, TCN_KERNEL, TCN_BLOCKS (X), TCN_REPEATS
    (R), TCN_CAUSAL.
    """

    def _dims(self):
        hp = self.hp

        def get(key, default):
            v = getattr(hp, key, None)
            return default if v is None else int(v)

        return (get("TCN_DIM", 256), get("TCN_HIDDEN", 512),
                get("TCN_KERNEL", 3), get("TCN_BLOCKS", 4),
                get("TCN_REPEATS", 3),
                bool(getattr(hp, "TCN_CAUSAL", False)))

    def _n_blocks(self):
        _, _, _, x_blocks, repeats, _ = self._dims()
        return x_blocks * repeats

    def _dilation(self, i):
        _, _, _, x_blocks, _, _ = self._dims()
        return 2 ** (i % x_blocks)

    def init(self, rng):
        hp = self.hp
        d, h, k, x_blocks, repeats, _ = self._dims()
        n_blocks = x_blocks * repeats
        keys = jax.random.split(rng, n_blocks + 2)
        params = {
            "bottleneck": nn.linear_init(keys[0], hp.FEATURE_SIZE, d),
            "output": _LstmHead.init(keys[1], hp, d),
        }
        for i in range(n_blocks):
            ks = jax.random.split(keys[2 + i], 3)
            params[f"block{i}"] = {
                "ln1": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
                "in": nn.linear_init(ks[0], d, h),
                "dconv": nn.conv1d_depthwise_init(ks[1], h, k),
                "ln2": {"g": jnp.ones((h,)), "b": jnp.zeros((h,))},
                "out": nn.linear_init(ks[2], h, d),
            }
        return params

    @staticmethod
    def _block(blk, h_seq, dilation, causal, alpha, tail=None):
        """One residual block.  With ``tail`` (streaming), the depthwise
        conv runs VALID over [tail | chunk] and the new tail is returned.
        Static (no encoder state): the waveform-domain TasNet separator
        (models/tasnet.py) reuses it over learned-basis frames."""
        y = AttentionEncoder._ln(blk["ln1"], h_seq)
        y = nn.leaky_relu(nn.linear_apply(blk["in"], y), alpha)
        if tail is not None:
            ycat = jnp.concatenate([tail, y], axis=1)
            span = tail.shape[1]
            new_tail = ycat[:, ycat.shape[1] - span:]
            # causal VALID conv over the tail-extended chunk == the
            # full-sequence causal conv restricted to these frames
            # (f32 conv like conv1d_depthwise_apply)
            w = blk["dconv"]["w"]
            yc = jax.lax.conv_general_dilated(
                jnp.swapaxes(ycat, 1, 2).astype(jnp.float32), w,
                window_strides=(1,), padding=[(0, 0)],
                rhs_dilation=(dilation,),
                dimension_numbers=("NCH", "OIH", "NCH"),
                feature_group_count=w.shape[0])
            yc = (yc + blk["dconv"]["b"][None, :, None]).astype(y.dtype)
            y = jnp.swapaxes(yc, 1, 2)
        else:
            new_tail = None
            y = nn.conv1d_depthwise_apply(
                blk["dconv"], y, dilation=dilation, causal=causal)
        y = nn.leaky_relu(AttentionEncoder._ln(blk["ln2"], y), alpha)
        y = nn.linear_apply(blk["out"], y)
        return h_seq + y, new_tail

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        _, _, k, _, _, causal = self._dims()
        alpha = hp.RELU_LEAKAGE
        n_blocks = self._n_blocks()
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop_keys = (jax.random.split(rng, n_blocks)
                     if (rng is not None and keep < 1.0) else
                     [None] * n_blocks)
        x = log_spectra - jnp.mean(log_spectra, axis=(1, 2), keepdims=True)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh("seq", n_seq) if n_seq > 1 else None
        if mesh is not None:
            # trainer-reachable sequence parallelism — EXACT for the TCN:
            # each block's conv needs only (K-1)*dilation context frames,
            # exchanged as halos (seq_parallel.tcn_stack_sp);
            # dense on meshes without a seq axis (inference hosts)
            from danet_tpu.parallel.seq_parallel import tcn_stack_sp
            if x.shape[1] % n_seq:
                raise ValueError(
                    "MESH_SEQ=%d must divide the frame count T=%d"
                    % (n_seq, x.shape[1]))
            body = {key: v for key, v in params.items() if key != "output"}
            h = tcn_stack_sp(
                body, x, mesh,
                dilations=[self._dilation(i) for i in range(n_blocks)],
                kernel=k, causal=causal, alpha=alpha,
                drop_keys=(list(drop_keys)
                           if drop_keys[0] is not None else None),
                keep_prob=keep,
                remat=bool(getattr(hp, "REMAT", False)))
            return _LstmHead.apply(params["output"], hp, h)
        h = nn.linear_apply(params["bottleneck"], x)
        for i in range(n_blocks):
            layer = _maybe_remat(hp, lambda p, v: self._block(
                p, v, self._dilation(i), causal, alpha)[0])
            h = layer(params[f"block{i}"], h)
            if drop_keys[i] is not None:
                h = nn.dropout(drop_keys[i], h, keep)
            if tap:
                tap("block%d_h" % i, h)
        return _LstmHead.apply(params["output"], hp, h)

    # --- causal streaming hooks (DaNet.separate_stream) -----------------
    def stream_state_init(self, batch: int, dtype=jnp.float32):
        """Per-block tail buffers of the depthwise convs' inputs — the
        zeros match the causal left-padding at a fresh stream."""
        _, h, k, _, _, causal = self._dims()
        if not causal:
            raise ValueError(
                "tcn-v1 streams only with TCN_CAUSAL=true (non-causal "
                "depthwise convs need future frames)")
        return [jnp.zeros((batch, (k - 1) * self._dilation(i), h), dtype)
                for i in range(self._n_blocks())]

    def stream_hidden(self, params, x, state):
        """Centered chunk [B, Tc, F] -> (hidden [B, Tc, D], new tails)."""
        hp = self.hp
        alpha = hp.RELU_LEAKAGE
        h = nn.linear_apply(params["bottleneck"], x)
        new_state = []
        for i in range(self._n_blocks()):
            h, tail = self._block(
                params[f"block{i}"], h, self._dilation(i), True, alpha,
                tail=state[i])
            new_state.append(tail)
        return h, new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("dprnn-v1")
class DprnnEncoder(Encoder):
    """Dual-path RNN encoder (new family, not in the reference — its
    recurrent encoders are plain 4-deep stacks, modules.py:140-260).

    Luo, Chen & Yoshioka, "Dual-Path RNN: efficient long sequence modeling
    for time-domain single-channel speech separation" (ICASSP 2020),
    applied here as a DaNet embedding encoder over STFT frames.  The frame
    axis is segmented into S half-overlapping chunks of P frames; each of
    R blocks runs (a) an intra-chunk BiLSTM over P, batched over B*S —
    short scans with a huge effective batch, so every per-step gate GEMM
    stays large — then (b) an inter-chunk (Bi)LSTM over S, batched
    over B*P.  Full-sequence receptive field therefore costs O(P + T/P)
    sequential scan steps instead of the O(T) of a plain (Bi)LSTM stack —
    the dual-path trick is exactly a sequential-dependency reduction,
    which is what a scan-bound RNN path wants.  Each path:
    RNN -> linear -> LayerNorm -> residual; chunks merge by
    count-normalized overlap-add; shared centered head to [B, T, F, E].

    DPRNN_INTER_CAUSAL=true makes the inter-chunk RNN unidirectional (the
    paper's online variant: latency = one chunk).  With additionally
    DPRNN_HOP == DPRNN_CHUNK (non-overlapping segments) the encoder is
    causal at segment granularity and DaNet.separate_stream streams it
    EXACTLY: the per-position inter-chunk (c, h) state is carried across
    stream chunks, so chunked online inference reproduces the offline
    forward at one-segment latency.
    Config: DPRNN_DIM (D), DPRNN_HIDDEN (H per direction), DPRNN_CHUNK
    (P), DPRNN_HOP (segment hop, default P//2), DPRNN_BLOCKS (R),
    DPRNN_INTER_CAUSAL.
    """

    def _dims(self):
        hp = self.hp

        def get(key, default):
            v = getattr(hp, key, None)
            return default if v is None else int(v)

        p = get("DPRNN_CHUNK", 64)
        hop = get("DPRNN_HOP", max(p // 2, 1))
        if not 1 <= hop <= p:
            raise ValueError(
                "DPRNN_HOP must be in [1, DPRNN_CHUNK]; got hop=%d P=%d"
                % (hop, p))
        return (get("DPRNN_DIM", 128), get("DPRNN_HIDDEN", 128),
                p, hop, get("DPRNN_BLOCKS", 4),
                bool(getattr(self.hp, "DPRNN_INTER_CAUSAL", False)))

    def init(self, rng):
        hp = self.hp
        d, h, _, _, n_blocks, inter_causal = self._dims()
        keys = jax.random.split(rng, n_blocks + 2)
        gate_bias = (0.0, 0.0, 1.0, 0.0)  # standard forget-bias-1 init
        params = {
            "bottleneck": nn.linear_init(keys[0], hp.FEATURE_SIZE, d),
            "output": _LstmHead.init(keys[1], hp, d),
        }
        for i in range(n_blocks):
            ks = jax.random.split(keys[2 + i], 4)
            if inter_causal:
                inter = rnn.lstm_init(ks[2], d, h, gate_bias=gate_bias)
                inter_odim = h
            else:
                inter = rnn.bilstm_init(ks[2], d, h, gate_bias=gate_bias)
                inter_odim = 2 * h
            params[f"block{i}"] = {
                "intra": rnn.bilstm_init(ks[0], d, h, gate_bias=gate_bias),
                "intra_proj": nn.linear_init(ks[1], 2 * h, d),
                "intra_ln": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
                "inter": inter,
                "inter_proj": nn.linear_init(ks[3], inter_odim, d),
                "inter_ln": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
            }
        return params

    @staticmethod
    def _segment(x, p, hop=None):
        """[B, T, D] -> chunks [B, S, P, D] with the given hop (default
        P//2), plus the static (gather_idx, total_padded, T) needed to
        merge back."""
        import numpy as _np
        b, t, d = x.shape
        hop = max(p // 2, 1) if hop is None else min(hop, p)
        n_chunks = max(-(-(t - p) // hop), 0) + 1
        total = (n_chunks - 1) * hop + p
        x = jnp.pad(x, ((0, 0), (0, total - t), (0, 0)))
        idx = (_np.arange(n_chunks)[:, None] * hop
               + _np.arange(p)[None, :])           # [S, P]
        return x[:, idx], (jnp.asarray(idx), total, t)

    @staticmethod
    def _merge(chunks, seg_info):
        """Count-normalized overlap-add back to [B, T, D]."""
        idx, total, t = seg_info
        b, s, p, d = chunks.shape
        acc = jnp.zeros((b, total, d), chunks.dtype)
        acc = acc.at[:, idx].add(chunks)
        cnt = jnp.zeros((total,), chunks.dtype).at[idx].add(
            jnp.ones((s, p), chunks.dtype))
        return (acc / cnt[None, :, None])[:, :t]

    def _block(self, blk, chunks, inter_causal, dkey=None, keep=1.0,
               inter_state=None):
        """One dual-path block.  With ``inter_state`` (streaming), the
        causal inter-chunk LSTM resumes from the carried per-position
        (c, h) and the new carry is returned."""
        b, s, p, d = chunks.shape
        # intra-chunk path: BiLSTM over P, batched over B*S
        y = rnn.bilstm_apply(blk["intra"], chunks.reshape(b * s, p, d),
                             "tanh")
        y = nn.linear_apply(blk["intra_proj"], y).reshape(b, s, p, d)
        y = AttentionEncoder._ln(blk["intra_ln"], y)
        if dkey is not None:
            y = nn.dropout(dkey[0], y, keep)
        chunks = chunks + y
        # inter-chunk path: (Bi)LSTM over S, batched over B*P
        y = jnp.transpose(chunks, (0, 2, 1, 3)).reshape(b * p, s, d)
        new_state = None
        if inter_state is not None:
            c0, h0 = inter_state
            y, new_state = rnn.lstm_apply(
                blk["inter"], y, "tanh", c0=c0, h0=h0, return_state=True)
        elif inter_causal:
            y = rnn.lstm_apply(blk["inter"], y, "tanh")
        else:
            y = rnn.bilstm_apply(blk["inter"], y, "tanh")
        y = nn.linear_apply(blk["inter_proj"], y)
        y = jnp.transpose(y.reshape(b, p, s, d), (0, 2, 1, 3))
        y = AttentionEncoder._ln(blk["inter_ln"], y)
        if dkey is not None:
            y = nn.dropout(dkey[1], y, keep)
        return chunks + y, new_state

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        d, _, p, hop, n_blocks, inter_causal = self._dims()
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        x = log_spectra - jnp.mean(log_spectra, axis=(1, 2), keepdims=True)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh("seq", n_seq) if n_seq > 1 else None
        if mesh is not None:
            # trainer-reachable sequence parallelism — EXACT for the
            # non-overlapping DPRNN: segments shard over 'seq' (the intra
            # path is segment-local) and the inter-chunk scan re-shards
            # positionwise via all_to_all (seq_parallel.dprnn_stack_sp);
            # dense on meshes without a seq axis (inference hosts)
            if hop != p:
                raise ValueError(
                    "MESH_SEQ>1 with dprnn-v1 requires DPRNN_HOP == "
                    "DPRNN_CHUNK (non-overlapping segments; exact SP); "
                    "got hop=%d P=%d" % (hop, p))
            from danet_tpu.parallel.seq_parallel import dprnn_stack_sp
            body = {k: v for k, v in params.items() if k != "output"}
            merged = dprnn_stack_sp(
                body, x, mesh, p, n_blocks, inter_causal,
                drop_keys=(list(jax.random.split(rng, n_blocks))
                           if (rng is not None and keep < 1.0) else None),
                keep_prob=keep,
                remat=bool(getattr(hp, "REMAT", False)))
            return _LstmHead.apply(params["output"], hp, merged)
        # dense-path dropout keys derive here, AFTER the SP early return
        # (the SP stack derives its own per-device keys)
        drop_keys = (jax.random.split(rng, 2 * n_blocks).reshape(
            n_blocks, 2, -1) if (rng is not None and keep < 1.0) else
            [None] * n_blocks)
        h = nn.linear_apply(params["bottleneck"], x)
        p_eff = min(p, h.shape[1])
        chunks, seg_info = self._segment(
            h, p_eff, hop if p_eff == p else None)
        for i in range(n_blocks):
            layer = _maybe_remat(hp, lambda blk, c, k: self._block(
                blk, c, inter_causal, dkey=k, keep=keep)[0])
            chunks = layer(params[f"block{i}"], chunks, drop_keys[i])
            if tap:
                tap("block%d_chunks" % i, chunks)
        merged = self._merge(chunks, seg_info)
        return _LstmHead.apply(params["output"], hp, merged)

    def sp_granularity(self) -> int:
        """Sequence parallelism shards whole DPRNN_CHUNK segments."""
        return self._dims()[2]

    # --- causal streaming hooks (DaNet.separate_stream) -----------------
    def stream_granularity(self) -> int:
        """Streaming advances in whole segments: chunk/warmup sizes must
        be multiples of DPRNN_CHUNK."""
        return self._dims()[2]

    def stream_state_init(self, batch: int, dtype=jnp.float32):
        """Per-block per-position (c, h) carries of the causal inter-chunk
        LSTM — zeros match the offline scan's zero initial state."""
        _, h, p, hop, n_blocks, inter_causal = self._dims()
        if not inter_causal or hop != p:
            raise ValueError(
                "dprnn-v1 streams only with DPRNN_INTER_CAUSAL=true and "
                "DPRNN_HOP == DPRNN_CHUNK (non-overlapping causal "
                "segments; got hop=%d P=%d)" % (hop, p))
        z = jnp.zeros((batch * p, h), dtype)
        return [(z, z) for _ in range(n_blocks)]

    def stream_hidden(self, params, x, state):
        """Pre-centered chunk [B, Tc, F] (Tc a multiple of DPRNN_CHUNK)
        -> (merged hidden [B, Tc, D], new inter-chunk carries).  Exact
        continuation: back-to-back chunks reproduce the offline
        non-overlapping causal forward (bit-for-bit on the XLA scan
        path this method pins; see the class docstring)."""
        d, _, p, _, n_blocks, _ = self._dims()
        b, tc = x.shape[0], x.shape[1]
        if tc % p:
            raise ValueError(
                "dprnn-v1 stream chunks must be multiples of "
                "DPRNN_CHUNK=%d (got %d frames)" % (p, tc))
        h = nn.linear_apply(params["bottleneck"], x)
        chunks = h.reshape(b, tc // p, p, d)
        new_state = []
        for i in range(n_blocks):
            chunks, st = self._block(
                params[f"block{i}"], chunks, True, inter_state=state[i])
            new_state.append(st)
        return chunks.reshape(b, tc, d), new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("conv-bilstm-v1")
class ConvBiLstmEncoder(Encoder):
    """U-Net-ish CNN + BiLSTM hybrid (reference modules.py:263-379).

    Shape contract: T must be a multiple of LENGTH_ALIGN (4) and
    FEATURE_SIZE//4 == FFT_SIZE//8 (holds for the odd onesided size since
    pooling floors).  Down: conv8-conv16-pool, conv32-conv16-pool; middle:
    2x BiLSTM(hdim=FFT_SIZE) with residual; up: conv32-conv64 +
    pixel-shuffle x2, conv16-conv8; dense head to F*E.
    """

    def sp_granularity(self) -> int:
        # each SP chunk must land on the double-pooled grid (T % 4*S == 0)
        return 4

    def init(self, rng):
        hp = self.hp
        nfft = hp.FFT_SIZE
        ks = jax.random.split(rng, 11)
        gate_bias = (0.0, 1.0, -1.0, 1.0)  # reference modules.py:282-285
        w_scale = 2.0 / sqrt(nfft)
        conv_scale = 3e-1  # reference modules.py:336-338 (up-path convs)
        return {
            "down0a": nn.conv2d_init(ks[0], 1, 8, 5),
            "down0b": nn.conv2d_init(ks[1], 8, 16, 5),
            "down1a": nn.conv2d_init(ks[2], 16, 32, 3),
            "down1b": nn.conv2d_init(ks[3], 32, 16, 3),
            "lstm0": rnn.bilstm_init(ks[4], nfft * 2, nfft, w_scale, gate_bias),
            "lstm1": rnn.bilstm_init(ks[5], nfft * 2, nfft, w_scale, gate_bias),
            "up0a": nn.conv2d_init(ks[6], 16, 32, 3, w_scale=conv_scale),
            "up0b": nn.conv2d_init(ks[7], 32, 64, 3, w_scale=conv_scale),
            "up1a": nn.conv2d_init(ks[8], 16, 16, 5),
            "up1b": nn.conv2d_init(ks[9], 16, 8, 5),
            "output": nn.linear_init(
                ks[10], nfft, hp.FEATURE_SIZE * hp.EMBED_SIZE, bias=False),
        }

    def apply(self, params, log_spectra, train=False, rng=None, tap=None):
        hp = self.hp
        nfft = hp.FFT_SIZE
        alpha = hp.RELU_LEAKAGE
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        seq_mesh = _route_mesh("seq", n_seq) if n_seq > 1 else None
        if seq_mesh is not None and tap is None:
            # trainer-reachable EXACT sequence parallelism: conv halos +
            # psum centerings + boundary-state-relay BiLSTM core
            # (parallel/seq_parallel.py::conv_bilstm_sp); debug taps run
            # the dense path
            from danet_tpu.parallel.seq_parallel import conv_bilstm_sp
            t = log_spectra.shape[1]
            if t % (4 * n_seq):
                raise ValueError(
                    "MESH_SEQ=%d needs T %% (4*MESH_SEQ) == 0 for the "
                    "conv-bilstm pooled grid; got T=%d — pick "
                    "MAX_TRAIN_LEN / TIME_BUCKET accordingly"
                    % (n_seq, t))
            dk = (list(jax.random.split(rng, 2))
                  if (rng is not None and keep < 1.0) else None)
            return conv_bilstm_sp(
                params, log_spectra, seq_mesh, nfft, hp.FEATURE_SIZE,
                hp.EMBED_SIZE, alpha, act, drop_keys=dk, keep_prob=keep,
                remat=bool(getattr(hp, "REMAT", False)))
        drop_keys = (jax.random.split(rng, 2)
                     if (rng is not None and keep < 1.0) else [None, None])
        b = log_spectra.shape[0]

        x = log_spectra[:, None]  # [B, 1, T, F]
        x = nn.leaky_relu(nn.conv2d_apply(params["down0a"], x), alpha)
        x = nn.leaky_relu(nn.conv2d_apply(params["down0b"], x), alpha)
        x = nn.max_pool_2x2(x)                       # [B, 16, T/2, F/2]
        if tap:
            tap("conv_act", x)  # reference modules.py:375-377 conv_act
        x = nn.leaky_relu(nn.conv2d_apply(params["down1a"], x), alpha)
        x = nn.leaky_relu(nn.conv2d_apply(params["down1b"], x), alpha)
        x = nn.max_pool_2x2(x)                       # [B, 16, T/4, nfft/8]
        x = x - jnp.mean(x, axis=(1, 2, 3), keepdims=True)
        skip = x

        # [B, T/4, 16*nfft/8 = nfft*2]
        seq = jnp.transpose(x, (0, 2, 1, 3)).reshape(b, x.shape[2], nfft * 2)
        seq = rnn.bilstm_apply(params["lstm0"], seq, act,
                               dropout_rng=drop_keys[0], keep_prob=keep)
        seq = rnn.bilstm_apply(params["lstm1"], seq, act,
                               dropout_rng=drop_keys[1], keep_prob=keep)
        if tap:
            tap("lstm_act", seq)  # reference lstm_act (modules.py:376)
        x = jnp.transpose(
            seq.reshape(b, -1, 16, nfft // 8), (0, 2, 1, 3))
        x = x + skip
        x = x - jnp.mean(x, axis=(1, 2, 3), keepdims=True)
        if tap:
            tap("mid4", x)        # reference mid4: post-residual centering

        x = nn.leaky_relu(nn.conv2d_apply(params["up0a"], x), alpha)
        x = nn.leaky_relu(nn.conv2d_apply(params["up0b"], x), alpha)
        # pixel-shuffle x2 in T and F (reference modules.py:350-353)
        t4 = x.shape[2]
        x = x.reshape(b, 16, 2, 2, t4, nfft // 8)
        x = jnp.transpose(x, (0, 1, 4, 2, 5, 3))
        x = x.reshape(b, 16, t4 * 2, nfft // 4)
        x = nn.leaky_relu(nn.conv2d_apply(params["up1a"], x), alpha)
        x = nn.leaky_relu(nn.conv2d_apply(params["up1b"], x), alpha)
        # [B, 8, T/2, nfft/4] -> fold channels+freq into time x nfft
        x = jnp.transpose(x, (0, 2, 1, 3)).reshape(b, -1, nfft)

        out = nn.linear_apply(params["output"], x)
        return out.reshape(b, -1, hp.FEATURE_SIZE, hp.EMBED_SIZE)
