"""Conv-TasNet: waveform-domain separation with a learned filterbank.

A second model family beyond the reference's DaNet (the reference has
exactly one Model, /root/reference/main.py:61-548).  Luo & Mesgarani,
"Conv-TasNet: Surpassing Ideal Time-Frequency Magnitude Masking for
Speech Separation" (TASLP 2019): instead of STFT -> per-bin embeddings ->
attractors -> masks, the mixture waveform is framed into a LEARNED
overcomplete basis (a 1-D conv encoder, ~2 ms windows), a dilated TCN
regresses one mask per source directly in basis space, and a learned
transposed-conv decoder overlap-adds the masked features back to
waveforms.  Trained end-to-end with the uPIT SI-SNR objective.

Why it belongs in this framework: PARITY.md records that the tcn-v1
DaNet *embedding* encoder underfits the attractor task while the same
TCN family excels in this native mask-regression setting — this model IS
that native setting, reusing the framework's TCN residual blocks
(models/encoders.py::TcnEncoder._block), uPIT SI-SNR loss and BSS-eval
metrics.

Device mapping: framing is a static gather; the encoder/decoder bases are
[win, N] GEMMs; every TCN stage is a batched GEMM or depthwise conv —
there is NO sequential scan anywhere, so the whole training step is
GEMM-shaped (contrast the BiLSTM's T-step recurrence).

Contract: drop-in for the Trainer/serving surfaces (init / train_loss /
valid_metrics / separate / separate_wav / parameter_count), selected via
MODEL_TYPE='tasnet-v1'.  Dataset batches stay STFT spectra in the ri
layout; the model inverts them to waveforms on device through the exact
GEMM-native iSTFT (ops/dsp.py) at the front of each entry point, so the
whole data layer, Trainer and checkpoints are shared with DaNet.

Deviations from the paper (documented, config-visible): channelwise
LayerNorm in the blocks (the paper's cLN; its gLN variant is a training-
time normalization nicety), residual-only blocks (no separate skip
accumulator), and mask nonlinearity selectable via TASNET_MASK
('sigmoid' default | 'relu' | 'softmax').
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from danet_tpu.hparams import hparams
from danet_tpu.ops import loss as loss_ops
from danet_tpu.ops import nn


def _frame(x: jnp.ndarray, win: int, stride: int) -> jnp.ndarray:
    """[..., L] -> [..., K, win] valid framing; L must satisfy
    (L - win) % stride == 0 (callers pad)."""
    length = x.shape[-1]
    assert (length - win) % stride == 0, (length, win, stride)
    k = (length - win) // stride + 1
    idx = (np.arange(k)[:, None] * stride + np.arange(win)[None, :])
    return x[..., idx]


def _overlap_add(frames: jnp.ndarray, stride: int) -> jnp.ndarray:
    """[..., K, win] -> [..., (K-1)*stride + win] transposed-conv style
    overlap-add (plain sum, no window normalization — the decoder basis
    is learned, so any fixed normalization would be absorbed by it)."""
    k, win = frames.shape[-2], frames.shape[-1]
    out_len = (k - 1) * stride + win
    idx = (np.arange(k)[:, None] * stride + np.arange(win)[None, :])
    out = jnp.zeros(frames.shape[:-2] + (out_len,), dtype=frames.dtype)
    return out.at[..., idx.reshape(-1)].add(
        frames.reshape(frames.shape[:-2] + (-1,)))


@hparams.register_model("tasnet-v1")
class TasNet:
    """Waveform-in, waveform-out separation; Trainer-compatible surface."""

    def __init__(self, hp=None, name: str = "tasnet"):
        hp = hp if hp is not None else hparams
        self.hp = hp
        self.name = name
        self._check_parallel_support()

    def _check_parallel_support(self):
        """Data parallelism is native (pure batch ops -> GSPMD shards the
        batch) and MESH_SEQ routes the EXACT sample-sharded sequence-
        parallel forward (_forward_sp); the other mesh axes have no route
        through this model, so fail loudly instead of silently
        replicating."""
        for key in ("MESH_MODEL", "MESH_PIPE", "MESH_EXPERT"):
            if int(getattr(self.hp, key, 1) or 1) > 1:
                raise ValueError(
                    "MODEL_TYPE='tasnet-v1' supports data parallelism "
                    "and MESH_SEQ only; %s>1 is not routed" % key)

    def _dims(self):
        hp = self.hp

        def get(key, default):
            v = getattr(hp, key, None)
            return default if v is None else int(v)

        return {
            "n_basis": get("TASNET_FILTERS", 512),
            "win": get("TASNET_WIN", 16),
            "stride": get("TASNET_STRIDE", 8),
            "bottleneck": get("TASNET_BOTTLENECK", 128),
            "hidden": get("TASNET_HIDDEN", 512),
            "kernel": get("TASNET_KERNEL", 3),
            "x_blocks": get("TASNET_BLOCKS", 8),
            "repeats": get("TASNET_REPEATS", 3),
            "causal": bool(getattr(hp, "TASNET_CAUSAL", False)),
            "mask": str(getattr(hp, "TASNET_MASK", "sigmoid")
                        or "sigmoid"),
        }

    def _n_blocks(self):
        d = self._dims()
        return d["x_blocks"] * d["repeats"]

    def _dilation(self, i):
        return 2 ** (i % self._dims()["x_blocks"])

    # ------------------------------------------------------------------
    def init(self, rng) -> dict:
        d = self._dims()
        n_blocks = self._n_blocks()
        keys = jax.random.split(rng, n_blocks + 4)
        nb, win, bd, h, k = (d["n_basis"], d["win"], d["bottleneck"],
                             d["hidden"], d["kernel"])
        params = {
            # learned analysis/synthesis bases (the paper's 1-D conv
            # encoder/decoder); scale ~ the linear default 1/sqrt(fan_in)
            "enc_basis": nn.uniform_init(
                keys[0], (win, nb), 1.0 / np.sqrt(win)),
            "dec_basis": nn.uniform_init(
                keys[1], (nb, win), 1.0 / np.sqrt(nb)),
            "ln_in": {"g": jnp.ones((nb,)), "b": jnp.zeros((nb,))},
            "bottleneck": nn.linear_init(keys[2], nb, bd),
            "mask_head": nn.linear_init(
                keys[3], bd, self.hp.MAX_N_SIGNAL * nb),
        }
        for i in range(n_blocks):
            ks = jax.random.split(keys[4 + i], 3)
            params[f"block{i}"] = {
                "ln1": {"g": jnp.ones((bd,)), "b": jnp.zeros((bd,))},
                "in": nn.linear_init(ks[0], bd, h),
                "dconv": nn.conv1d_depthwise_init(ks[1], h, k),
                "ln2": {"g": jnp.ones((h,)), "b": jnp.zeros((h,))},
                "out": nn.linear_init(ks[2], h, bd),
            }
        return params

    # ------------------------------------------------------------------
    def _pad_len(self, length: int):
        """Pad to a stride multiple (>= one stride); with the forward's
        zero-suffix framing (see _separate_wav_padded) every padded
        length then frames evenly into L/stride analysis windows."""
        stride = self._dims()["stride"]
        length = max(length, stride)
        return length + (-length) % stride

    def _mask_and_decode(self, params, feats, y):
        """Shared tail: TCN output y -> masks -> masked basis features ->
        decoded frames [B, N, K, win] (all pointwise per frame)."""
        d = self._dims()
        n = self.hp.MAX_N_SIGNAL
        b, k = y.shape[0], y.shape[1]
        logits = nn.linear_apply(params["mask_head"], y).astype(
            jnp.float32)
        logits = logits.reshape(b, k, n, d["n_basis"])
        if d["mask"] == "sigmoid":
            masks = jax.nn.sigmoid(logits)
        elif d["mask"] == "relu":
            masks = jax.nn.relu(logits)
        elif d["mask"] == "softmax":
            masks = jax.nn.softmax(logits, axis=2)   # over sources
        else:
            raise ValueError("Unknown TASNET_MASK %r" % (d["mask"],))
        masks = jnp.moveaxis(masks, 2, 1)             # [B, N, K, nb]
        sep_feats = feats.astype(jnp.float32)[:, None] * masks
        return masks, nn.mm(sep_feats, params["dec_basis"].astype(
            jnp.float32))                             # [B, N, K, win]

    def _forward_sp(self, params, mix_wav, mesh, train=False, rng=None,
                    seq_axis: str = "seq"):
        """EXACT sequence-parallel forward over a 'seq' mesh axis.

        The waveform shards in equal sample chunks; every stage is local
        except three cheap boundary exchanges:

          * framing: each shard fetches the (win - stride)-sample head of
            its RIGHT neighbour (one ppermute) so boundary-straddling
            analysis frames are exact;
          * the dilated TCN runs through parallel/seq_parallel.
            tcn_stack_sp — the conv halos are exchanged per block, exact
            by the same finite-context argument as the tcn-v1 encoder;
          * decoder overlap-add: each shard ships its (win - stride)-
            sample OLA tail to the RIGHT neighbour's head (one ppermute).

        Basis GEMMs, LayerNorms and the mask head are per-frame, so GSPMD
        keeps them frame-sharded with no collectives.  Output equals the
        dense forward bit-for-bit modulo f32 reduction order (tested).
        """
        import functools

        from jax.sharding import PartitionSpec as P

        from danet_tpu.models.encoders import AttentionEncoder
        from danet_tpu.parallel.seq_parallel import (
            _mesh_data_axis, _shift_from_left, _shift_from_right,
            tcn_stack_sp)

        hp = self.hp
        d = self._dims()
        win, stride = d["win"], d["stride"]
        overlap = win - stride
        s = mesh.shape[seq_axis]
        length = mix_wav.shape[-1]
        if length % (stride * s):
            raise ValueError(
                "MESH_SEQ=%d needs the padded waveform length %d to "
                "divide by stride*seq = %d" % (s, length, stride * s))
        n_blocks = self._n_blocks()
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop_keys = (list(jax.random.split(rng, n_blocks))
                     if (rng is not None and keep < 1.0) else None)
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        d_axis = _mesh_data_axis(mesh, mix_wav.shape[0], "data")

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P(d_axis, seq_axis)),
            out_specs=P(d_axis, seq_axis, None))
        def feats_fn(enc_basis, wav_loc):
            halo = _shift_from_right(wav_loc[:, :overlap], seq_axis)
            ext = jnp.concatenate([wav_loc, halo], axis=-1)
            frames = _frame(ext, win, stride)        # [B, Lc/stride, win]
            return jax.nn.relu(nn.mm(
                frames.astype(cdt), enc_basis.astype(cdt)))

        feats = feats_fn(params["enc_basis"], mix_wav)  # [B, K, nb]
        y = AttentionEncoder._ln(params["ln_in"], feats)
        body = {"bottleneck": params["bottleneck"]}
        body.update({f"block{i}": params[f"block{i}"]
                     for i in range(n_blocks)})
        y = tcn_stack_sp(
            body, y, mesh,
            dilations=[self._dilation(i) for i in range(n_blocks)],
            kernel=d["kernel"], causal=d["causal"],
            alpha=hp.RELU_LEAKAGE, seq_axis=seq_axis,
            drop_keys=drop_keys, keep_prob=keep,
            remat=bool(getattr(hp, "REMAT", False)))
        _, sep_frames = self._mask_and_decode(params, feats, y)

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(d_axis, None, seq_axis, None),),
            out_specs=P(d_axis, None, seq_axis))
        def ola_fn(frames_loc):
            buf = _overlap_add(frames_loc, stride)   # [B, N, Lc+overlap]
            from_left = _shift_from_left(buf[..., -overlap:], seq_axis)
            out = buf[..., :buf.shape[-1] - overlap]
            return out.at[..., :overlap].add(from_left)

        return ola_fn(sep_frames)                    # [B, N, L]

    def _separate_wav_padded(self, params, mix_wav, train=False, rng=None,
                             tap=None):
        """Core forward: [B, L] (pre-padded) -> separated [B, N, L].

        With MESH_SEQ>1 configured and an active mesh carrying the 'seq'
        axis, routes the exact sequence-parallel path (_forward_sp);
        dense otherwise (inference hosts without the axis)."""
        from danet_tpu.models.encoders import (AttentionEncoder,
                                               TcnEncoder, _route_mesh)
        hp = self.hp
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        if n_seq > 1 and tap is None:
            mesh = _route_mesh("seq", n_seq)
            if mesh is not None:
                return self._forward_sp(params, mix_wav, mesh,
                                        train=train, rng=rng)
        d = self._dims()
        n = hp.MAX_N_SIGNAL
        alpha = hp.RELU_LEAKAGE
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        n_blocks = self._n_blocks()
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop_keys = (jax.random.split(rng, n_blocks)
                     if (rng is not None and keep < 1.0) else
                     [None] * n_blocks)

        # zero-suffix framing convention: analyze K = L/stride frames of
        # the (win - stride)-zero-extended signal, so every input sample
        # is covered and the SP path's zero right-halo at the global edge
        # (_forward_sp) computes the IDENTICAL frame set; the extra
        # frames' own output samples land past L and are trimmed by the
        # callers.
        overlap = d["win"] - d["stride"]
        ext = jnp.pad(mix_wav, [(0, 0)] * (mix_wav.ndim - 1)
                      + [(0, overlap)])
        frames = _frame(ext, d["win"], d["stride"])         # [B, K, win]
        feats = jax.nn.relu(nn.mm(
            frames.astype(cdt), params["enc_basis"].astype(cdt)))
        if tap:
            tap("basis_feats", feats)
        y = AttentionEncoder._ln(params["ln_in"], feats)
        y = nn.linear_apply(params["bottleneck"], y)
        for i in range(n_blocks):
            y, _ = TcnEncoder._block(
                params[f"block{i}"], y, self._dilation(i), d["causal"],
                alpha)
            if drop_keys[i] is not None:
                y = nn.dropout(drop_keys[i], y, keep)
            if tap:
                tap("block%d_h" % i, y)

        masks, sep_frames = self._mask_and_decode(params, feats, y)
        if tap:
            tap("masks", masks)
        return _overlap_add(sep_frames, d["stride"])  # [B, N, L]

    # ------------------------------------------------------------------
    def _src_wavs(self, src_ri):
        """Per-source waveforms from dataset ri spectra via the exact
        GEMM-native iSTFT; [B, N, T, F, 2] -> [B, N, Lw]."""
        from danet_tpu.ops import dsp
        hp = self.hp
        return dsp.istft_ri(src_ri, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)

    def train_loss(self, params, src_ri: jnp.ndarray,
                   rng: Optional[jax.Array] = None):
        """uPIT negative SI-SNR on waveforms; aux = {snr}."""
        hp = self.hp
        wav_src = self._src_wavs(src_ri)              # [B, N, Lw]
        mix_db = float(getattr(hp, "MIX_SNR_DB", 0.0) or 0.0)
        if mix_db > 0.0 and rng is not None:
            # same live relative-gain mixing augmentation as DaNet
            b, n = wav_src.shape[0], wav_src.shape[1]
            db = jax.random.uniform(
                jax.random.fold_in(rng, 0x5e2), (b, n, 1),
                minval=-0.5 * mix_db, maxval=0.5 * mix_db)
            wav_src = wav_src * (10.0 ** (db / 20.0)).astype(wav_src.dtype)
        length = wav_src.shape[-1]
        padded = self._pad_len(length)
        mix = jnp.sum(wav_src, axis=1)
        mix = jnp.pad(mix, [(0, 0), (0, padded - length)])
        sep = self._separate_wav_padded(
            params, mix, train=True, rng=rng)[..., :length]
        loss, perms, perm_idx = loss_ops.pit_si_snr_loss(wav_src, sep)
        sep_pit = loss_ops.unpermute(sep, perms, perm_idx)
        snr = jnp.mean(loss_ops.batch_snr(wav_src, sep_pit, eps=hp.EPS))
        if getattr(hp, "REG_APPLY", False) and hp.REG_TYPE is not None:
            from danet_tpu.models.danet import reg_loss
            loss = loss + reg_loss(params, hp.REG_TYPE, hp.REG_SCALE)
        return loss, {"snr": snr, "perm_idx": perm_idx}

    def valid_metrics(self, params, src_ri: jnp.ndarray):
        """Waveform-domain validation: loss is the uPIT negative SI-SNR
        (this family's objective — NOT comparable to DaNet's spectral
        MSE), SNR matches the framework-wide metric, plus the optional
        SI-SNR / BSS-eval sweeps."""
        hp = self.hp
        wav_src = self._src_wavs(src_ri)
        length = wav_src.shape[-1]
        padded = self._pad_len(length)
        mix = jnp.pad(jnp.sum(wav_src, axis=1),
                      [(0, 0), (0, padded - length)])
        sep = self._separate_wav_padded(params, mix)[..., :length]
        loss, perms, perm_idx = loss_ops.pit_si_snr_loss(wav_src, sep)
        sep_pit = loss_ops.unpermute(sep, perms, perm_idx)
        out = {"loss": loss,
               "SNR": jnp.mean(loss_ops.batch_snr(
                   wav_src, sep_pit, eps=hp.EPS))}
        if getattr(hp, "EVAL_SI_SNR", False):
            out["SI_SNR"] = jnp.mean(loss_ops.si_snr(wav_src, sep_pit))
        if getattr(hp, "EVAL_SDR", False):
            bss = jax.vmap(lambda r, e: loss_ops.bss_eval_sources(
                r, e, filt_len=int(getattr(hp, "BSS_FILT_LEN", 512))))(
                    wav_src, sep_pit)
            out["SDR"] = jnp.mean(bss["sdr"])
            out["SIR"] = jnp.mean(bss["sir"])
            out["SAR"] = jnp.mean(bss["sar"])
        return out

    # ------------------------------------------------------------------
    def separate_wav(self, params, wav: jnp.ndarray) -> jnp.ndarray:
        """[B, L] mixture waveforms -> [B, N, L] separated waveforms —
        the native surface of this family (no STFT anywhere)."""
        length = wav.shape[-1]
        padded = self._pad_len(length)
        wav = jnp.pad(wav, [(0, 0), (0, padded - length)])
        return self._separate_wav_padded(params, wav)[..., :length]

    def separate(self, params, mix_ri: jnp.ndarray) -> jnp.ndarray:
        """Spectral-surface adapter (demo mode / DaNet-parity serving):
        [B, T, F, 2] mixture spectra -> [B, N, T, F, 2] separated
        spectra, by exact iSTFT -> waveform separation -> STFT."""
        from danet_tpu.ops import dsp
        hp = self.hp
        wav = dsp.istft_ri(mix_ri, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
        sep = self.separate_wav(params, wav)          # [B, N, L]
        return dsp.stft_ri(sep, hp.FFT_SIZE, hp.FFT_STRIDE,
                           hp.FFT_WND_ARRAY)[..., :mix_ri.shape[1], :, :]

    # ------------------------------------------------------------------
    # Exact causal streaming (TASNET_CAUSAL=true): waveform chunks in,
    # separated chunks out, all state explicit — the same two-program
    # serving surface as DaNet (serve.export_streamer).  Unlike DaNet
    # there are NO utterance-level statistics (masks are per-frame), so
    # streaming is EXACT with zero warmup dependence: the output equals
    # the offline separation of the zero-prefixed stream, delayed by
    # win - stride samples (1 ms at the 16/8 defaults and 8 kHz).
    # ------------------------------------------------------------------
    def stream_granularity_samples(self) -> int:
        """Chunk sizes must be multiples of the basis stride."""
        return self._dims()["stride"]

    def stream_latency_samples(self) -> int:
        """Output lags input by the frame overlap."""
        d = self._dims()
        return d["win"] - d["stride"]

    def _require_causal(self):
        if not self._dims()["causal"]:
            raise ValueError(
                "TasNet streams only with TASNET_CAUSAL=true (non-causal "
                "dilated convs need future frames)")

    def stream_state_init(self, batch: int) -> dict:
        """Zero stream state: raw-input frame tail, per-block conv tails
        (matching the causal left padding of a fresh stream), decoder
        overlap-add tail."""
        self._require_causal()
        d = self._dims()
        n = self.hp.MAX_N_SIGNAL
        cdt = jnp.asarray(0.0, getattr(
            self.hp, "COMPUTE_DTYPE", "float32")).dtype
        overlap = d["win"] - d["stride"]
        return {
            "wav_tail": jnp.zeros((batch, overlap), jnp.float32),
            "conv_tails": [
                jnp.zeros(
                    (batch, (d["kernel"] - 1) * self._dilation(i),
                     d["hidden"]), cdt)
                for i in range(self._n_blocks())],
            "ola_tail": jnp.zeros((batch, n, overlap), jnp.float32),
        }

    def stream_init(self, params, wav_warmup: jnp.ndarray):
        """Start a stream: [B, Lw] -> (sep [B, N, Lw], state).  Lw must
        be a multiple of TASNET_STRIDE.  Purely a zero-state step (no
        frozen statistics), kept two-program for serving-surface parity
        with DaNet (serve.export_streamer)."""
        self._require_causal()
        state = self.stream_state_init(wav_warmup.shape[0])
        return self.stream_step(params, state, wav_warmup)

    def stream_step(self, params, state: dict, wav_chunk: jnp.ndarray):
        """One streaming step: (state, [B, Lc]) -> ([B, N, Lc], state').
        Lc must be a multiple of TASNET_STRIDE; output is chunk-size-
        invariant (tested) and lags input by win - stride samples."""
        from danet_tpu.models.encoders import AttentionEncoder, TcnEncoder
        hp = self.hp
        d = self._dims()
        alpha = hp.RELU_LEAKAGE
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        win, stride = d["win"], d["stride"]
        overlap = win - stride
        lc = wav_chunk.shape[-1]
        if lc % stride:
            raise ValueError(
                "chunk length %d must be a multiple of TASNET_STRIDE=%d"
                % (lc, stride))

        ext = jnp.concatenate(
            [state["wav_tail"], wav_chunk.astype(jnp.float32)], axis=-1)
        frames = _frame(ext, win, stride)              # [B, K=Lc/stride, win]
        feats = jax.nn.relu(nn.mm(
            frames.astype(cdt), params["enc_basis"].astype(cdt)))
        y = AttentionEncoder._ln(params["ln_in"], feats)
        y = nn.linear_apply(params["bottleneck"], y)
        new_tails = []
        for i in range(self._n_blocks()):
            y, tail = TcnEncoder._block(
                params[f"block{i}"], y, self._dilation(i), True, alpha,
                tail=state["conv_tails"][i])
            new_tails.append(tail)

        _, sep_frames = self._mask_and_decode(params, feats, y)
        buf = _overlap_add(sep_frames, stride)        # [B, N, Lc+overlap]
        buf = buf.at[..., :overlap].add(state["ola_tail"])
        out = buf[..., :lc]
        return out, {"wav_tail": ext[..., ext.shape[-1] - overlap:],
                     "conv_tails": new_tails,
                     "ola_tail": buf[..., lc:]}

    def parameter_count(self, params) -> int:
        return sum(x.size for x in jax.tree_util.tree_leaves(params))
