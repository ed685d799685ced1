"""DaNet model composition: feature front-end -> encoder -> estimator ->
separator -> reconstruction, plus PIT loss / SNR metrics.

Functional equivalent of the reference's monolithic graph builder
(/root/reference/main.py:208-399), re-designed for XLA:

  * **ri layout.** Complex spectra live on device as float tensors with a
    trailing (real, imag) axis — complex dtypes never cross the
    host/device boundary (XLA decomposes complex arithmetic anyway).
  * **Phase-as-unit-vector.** The reference reconstructs with
    ``cos(atan2(im,re))`` / ``sin(atan2)`` (main.py:237-238,281-284); here
    the unit phase vector is ``mix / (|mix| + eps)`` — no transcendentals,
    identical output wherever the mask output is nonzero.
  * Three pure entry points (train_loss / valid_metrics / separate) instead
    of one graph with three fetch lists; each jits to a single fused XLA
    program.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from danet_tpu.hparams import hparams
from danet_tpu.ops import loss as loss_ops


def mixture_features(src_ri: jnp.ndarray, eps: float):
    """From per-source ri spectra [B,N,T,F,2]:
    (mix_ri [B,T,F,2], src_pwr [B,N,T,F], mix_pwr [B,T,F],
     logmag [B,T,F], phase_unit [B,T,F,2]).

    In-graph mixing as in reference main.py:233-240: the mixture IS the sum
    of the (shuffle-paired) source spectra.
    """
    mix_ri = jnp.sum(src_ri, axis=1)
    src_pwr = jnp.sqrt(jnp.sum(jnp.square(src_ri), axis=-1))
    mix_pwr = jnp.sqrt(jnp.sum(jnp.square(mix_ri), axis=-1))
    logmag = jnp.log1p(mix_pwr)
    phase_unit = mix_ri / (mix_pwr[..., None] + eps)
    return mix_ri, src_pwr, mix_pwr, logmag, phase_unit


@hparams.register_model("danet")
class DaNet:
    """The composed model; sub-modules resolved from the registries by the
    same config keys as the reference (ENCODER_TYPE,
    TRAIN/INFER_ESTIMATOR_METHOD, SEPARATOR_TYPE — main.py:210,249-270).
    The default MODEL_TYPE; 'tasnet-v1' selects the waveform-domain
    Conv-TasNet family (models/tasnet.py)."""

    def __init__(self, hp=None, name: str = "danet"):
        hp = hp if hp is not None else hparams
        self.hp = hp
        self.name = name
        self.encoder = hp.get_encoder()(hp, "encoder")
        self.train_estimator = hp.get_estimator(
            hp.TRAIN_ESTIMATOR_METHOD)(hp, "train_estimator")
        self.same_method = (
            hp.INFER_ESTIMATOR_METHOD == hp.TRAIN_ESTIMATOR_METHOD)
        if self.same_method:
            self.infer_estimator = self.train_estimator
        else:
            self.infer_estimator = hp.get_estimator(
                hp.INFER_ESTIMATOR_METHOD)(hp, "infer_estimator")
            # reference main.py:266: inference estimator must not need truth
            assert not self.infer_estimator.USE_TRUTH
        self.separator = hp.get_separator(hp.SEPARATOR_TYPE)(hp, "separator")
        self._check_parallel_support()

    def _check_parallel_support(self):
        """Fail loudly when a configured parallelism strategy has no route
        through the configured encoder — a MESH_* axis that silently falls
        back to replicated execution would waste the devices it claims."""
        from danet_tpu.models import encoders as enc_mod
        hp, enc = self.hp, self.encoder

        def n(key):
            return int(getattr(hp, key, 1) or 1)

        if n("MESH_PIPE") > 1 and not isinstance(
                enc, enc_mod.BiLstmEncoder):
            raise ValueError(
                "MESH_PIPE>1 requires a pipeline-capable encoder "
                "(bilstm-orig); got ENCODER_TYPE=%r" % hp.ENCODER_TYPE)
        if n("MESH_SEQ") > 1 and not isinstance(
                enc, (enc_mod.BiLstmEncoder, enc_mod.AttentionEncoder,
                      enc_mod.GruEncoder, enc_mod.TcnEncoder,
                      enc_mod.DprnnEncoder, enc_mod.ConvBiLstmEncoder)):
            raise ValueError(
                "MESH_SEQ>1 requires a sequence-parallel encoder "
                "(bilstm-orig, gru-v1, attn-v1, moe-v1, tcn-v1, "
                "dprnn-v1, conv-bilstm-v1); got ENCODER_TYPE=%r"
                % hp.ENCODER_TYPE)
        if n("MESH_EXPERT") > 1 and not isinstance(
                enc, enc_mod.MoEAttentionEncoder):
            raise ValueError(
                "MESH_EXPERT>1 requires the MoE encoder (moe-v1); got "
                "ENCODER_TYPE=%r" % hp.ENCODER_TYPE)
        if n("MESH_PIPE") > 1 and n("MESH_SEQ") > 1:
            raise ValueError(
                "MESH_PIPE and MESH_SEQ cannot combine (the encoder "
                "routes through one strategy); pick one")

    # ------------------------------------------------------------------
    def init(self, rng) -> dict:
        k_enc, k_te, k_ie, k_sep = jax.random.split(rng, 4)
        params = {
            "encoder": self.encoder.init(k_enc),
            "train_estimator": self.train_estimator.init(k_te),
            "separator": self.separator.init(k_sep),
        }
        if not self.same_method:
            params["infer_estimator"] = self.infer_estimator.init(k_ie)
        return params

    # ------------------------------------------------------------------
    def _embed(self, params, logmag, train: bool, rng):
        """Encoder forward in COMPUTE_DTYPE (bfloat16 GEMMs with f32
        accumulation — see ops.nn.mm/ee; features and
        losses stay f32)."""
        cdt = getattr(self.hp, "COMPUTE_DTYPE", "float32")
        embed = self.encoder.apply(
            params["encoder"], logmag.astype(cdt), train=train, rng=rng)
        b = embed.shape[0]
        embed_flat = embed.reshape(b, -1, embed.shape[-1])
        return embed, embed_flat

    def _infer_est_params(self, params):
        return params["train_estimator"] if self.same_method \
            else params["infer_estimator"]

    # ------------------------------------------------------------------
    def train_loss(self, params, src_ri: jnp.ndarray,
                   rng: Optional[jax.Array] = None):
        """PIT training loss on complex reconstruction + aux metrics.

        Mirrors reference main.py:289-309 (train path): loss on the
        complex (ri) separated signals vs the true sources, then
        un-permute and report SNR.

        Returns (loss, aux) — aux = {snr, perm_idx} (+ dc when enabled).
        """
        hp = self.hp
        # Random relative-gain mixing augmentation: each source draws a
        # per-example level offset in +/- MIX_SNR_DB/2 dB before in-graph
        # mixing, as real WSJ0-mix recipes do.  The reference ships this
        # only as DEAD code (gen_2spkr_mixture + MAX_MIX_SNR,
        # /root/reference/app/datasets/WSJ0/process.py:17,67-118 — never
        # called); here it is live, in-graph, and off by default.
        mix_db = float(getattr(hp, "MIX_SNR_DB", 0.0) or 0.0)
        if mix_db > 0.0 and rng is not None:
            b, n = src_ri.shape[0], src_ri.shape[1]
            db = jax.random.uniform(
                jax.random.fold_in(rng, 0x5e2), (b, n, 1, 1, 1),
                minval=-0.5 * mix_db, maxval=0.5 * mix_db)
            src_ri = src_ri * (10.0 ** (db / 20.0)).astype(src_ri.dtype)
        (mix_ri, src_pwr, mix_pwr, logmag,
         phase_unit) = mixture_features(src_ri, hp.EPS)
        embed, embed_flat = self._embed(params, logmag, train=True, rng=rng)
        attractors = self.train_estimator.apply(
            params["train_estimator"], embed,
            src_pwr=src_pwr, mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params["separator"], mix_pwr, attractors, embed_flat)

        loss_type = getattr(hp, "TRAIN_LOSS_TYPE", "pit-mse") or "pit-mse"
        if loss_type == "pit-si-snr":
            # waveform-domain uPIT: differentiate through the GEMM-native
            # on-device iSTFT (ops/dsp.py) into negative SI-SNR — the
            # modern separation objective (not in the reference)
            from danet_tpu.ops import dsp
            sep_ri = sep_pwr[..., None] * phase_unit[:, None]
            wav_src = dsp.istft_ri(src_ri, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
            wav_sep = dsp.istft_ri(sep_ri, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
            loss, perms, perm_idx = loss_ops.pit_si_snr_loss(
                wav_src, wav_sep)
            sep_ri_pit = loss_ops.unpermute(sep_ri, perms, perm_idx)
            snr = jnp.mean(loss_ops.batch_snr(
                src_ri, sep_ri_pit, eps=hp.EPS, complex_ri=True))
        elif loss_type == "pit-mse":
            # fused tail: loss + SNR straight from the masked magnitudes —
            # the [B, N, T, F, 2] reconstruction (and its gradient) is
            # never materialized (ops/loss.py::pit_mse_masked_ri)
            loss, perms, perm_idx, snr_vec = loss_ops.pit_mse_masked_ri(
                src_ri, sep_pwr, phase_unit, eps=hp.EPS)
            snr = jnp.mean(snr_vec)
        else:
            raise ValueError("Unknown TRAIN_LOSS_TYPE %r" % (loss_type,))

        # Optional deep-clustering auxiliary (chimera-style multi-task):
        # regularizes the embedding space toward per-source clusters — the
        # structure the anchored/k-means estimators exploit at inference.
        # Magnitude-ratio bin weighting (chimera++) via DC_WEIGHT_TYPE.
        dc_w = float(getattr(hp, "DC_LOSS_WEIGHT", 0.0) or 0.0)
        if dc_w > 0.0:
            wt = getattr(hp, "DC_WEIGHT_TYPE", "mr") or "mr"
            if wt == "mr":
                dc_weights = mix_pwr
            elif wt == "none":
                dc_weights = None
            else:
                raise ValueError("Unknown DC_WEIGHT_TYPE %r" % (wt,))
            dc = loss_ops.dc_loss(embed, src_pwr, weights=dc_weights)
            # Scale-match the auxiliary to the primary objective.  The DC
            # objective is O(1/N) dimensionless while the primary losses
            # live on wildly different scales (complex-spectrum MSE here
            # is ~3e-4; negative SI-SNR is ~dBs), so a fixed weight
            # cannot be calibrated across objectives — the round-3
            # DC_LOSS_WEIGHT=0.3 broadband run had the auxiliary dominate
            # the MSE gradient by ~3 orders of magnitude (never learned,
            # NaN'd at epoch 10).  The stop-gradient ratio makes
            # DC_LOSS_WEIGHT a RELATIVE contribution: the DC term always
            # contributes dc_w x the primary loss magnitude, whatever the
            # stage's objective.
            # The ratio is CAPPED: as dc shrinks relative to the primary
            # loss the raw ratio |loss|/dc grows without bound, and the
            # auxiliary's gradient (dc_w * scale * grad(dc)) would be
            # amplified inversely with its own progress — the mirror
            # image of the dominance failure the scale-match fixes.
            # Below dc ~ 1e-3|loss| the auxiliary has converged relative
            # to the primary; let its contribution shrink naturally.
            scale = jax.lax.stop_gradient(jnp.minimum(
                jnp.abs(loss) / (dc + jnp.asarray(1e-20, loss.dtype)),
                jnp.asarray(1e3, loss.dtype)))
            loss = loss + dc_w * scale * dc
            dc_raw = dc  # raw (unscaled) value, exposed for diagnostics

        # Optional auxiliary loss through the inference-estimator path.
        # In the reference, anchors receive NO gradient unless
        # TRAIN_ESTIMATOR_METHOD='anchor' (main.py:289-290 optimizes only
        # the train path), so inference-time attractors stay at random
        # init — a structural weakness behind its "won't learn well"
        # disclaimer.  ANCHOR_AUX_LOSS > 0 trains the anchor path jointly
        # (magnitude-domain PIT, as the reference's valid loss).
        aux_w = float(getattr(hp, "ANCHOR_AUX_LOSS", 0.0) or 0.0)
        if aux_w > 0.0 and not self.same_method:
            # mix_pwr must be passed so weighted estimators (kmeans) train
            # the same refinement they run at inference
            attr_inf = self.infer_estimator.apply(
                self._infer_est_params(params), embed, mix_pwr=mix_pwr)
            sep_pwr_inf = self.separator.apply(
                params["separator"], mix_pwr, attr_inf, embed_flat)
            if loss_type == "pit-si-snr":
                # keep the aux path in the same loss family: a dB-scale
                # main loss would otherwise drown the MSE aux gradient
                from danet_tpu.ops import dsp
                sep_ri_inf = sep_pwr_inf[..., None] * phase_unit[:, None]
                wav_inf = dsp.istft_ri(
                    sep_ri_inf, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
                aux, _, _ = loss_ops.pit_si_snr_loss(wav_src, wav_inf)
            else:
                aux, _, _ = loss_ops.pit_mse_loss(src_pwr, sep_pwr_inf)
            loss = loss + aux_w * aux

        if getattr(hp, "REG_APPLY", False) and hp.REG_TYPE is not None:
            loss = loss + reg_loss(params, hp.REG_TYPE, hp.REG_SCALE)
        aux_out = {"snr": snr, "perm_idx": perm_idx}
        if dc_w > 0.0:
            aux_out["dc"] = dc_raw
        return loss, aux_out

    # ------------------------------------------------------------------
    def valid_metrics(self, params, src_ri: jnp.ndarray):
        """Validation loss/SNR through the inference estimator path.

        Mirrors reference main.py:312-337: PIT loss on *magnitudes*,
        un-permute, reconstruct with mixture phase, SNR vs true sources.
        """
        hp = self.hp
        (mix_ri, src_pwr, mix_pwr, logmag,
         phase_unit) = mixture_features(src_ri, hp.EPS)
        embed, embed_flat = self._embed(params, logmag, train=False, rng=None)
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed,
            src_pwr=src_pwr, mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params["separator"], mix_pwr, attractors, embed_flat)

        loss, perms, perm_idx = loss_ops.pit_mse_loss(src_pwr, sep_pwr)
        sep_pwr_pit = loss_ops.unpermute(sep_pwr, perms, perm_idx)
        sep_ri = sep_pwr_pit[..., None] * phase_unit[:, None]
        snr = jnp.mean(loss_ops.batch_snr(
            src_ri, sep_ri, eps=hp.EPS, complex_ri=True))
        out = {"loss": loss, "SNR": snr, "separated_ri": sep_ri}
        eval_si = getattr(hp, "EVAL_SI_SNR", False)
        eval_sdr = getattr(hp, "EVAL_SDR", False)
        if eval_si or eval_sdr:
            # waveform-domain metrics via on-device iSTFT (modern WSJ0-2mix
            # eval metrics; the reference reports only spectral SNR)
            from danet_tpu.ops import dsp
            wav_src = dsp.istft_ri(src_ri, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
            wav_sep = dsp.istft_ri(sep_ri, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
            if eval_si:
                out["SI_SNR"] = jnp.mean(loss_ops.si_snr(wav_src, wav_sep))
            if eval_sdr:
                # BSS-eval with the standard 512-tap distortion filter —
                # the metric the DaNet paper's WSJ0-mix numbers use
                bss = jax.vmap(lambda r, e: loss_ops.bss_eval_sources(
                    r, e, filt_len=int(getattr(hp, "BSS_FILT_LEN", 512))))(
                        wav_src, wav_sep)
                out["SDR"] = jnp.mean(bss["sdr"])
                out["SIR"] = jnp.mean(bss["sir"])
                out["SAR"] = jnp.mean(bss["sar"])
        return out

    # ------------------------------------------------------------------
    def _mix_features(self, mix_ri):
        """(mix_pwr, logmag, phase_unit) from mixture ri spectra."""
        hp = self.hp
        mix_pwr = jnp.sqrt(jnp.sum(jnp.square(mix_ri), axis=-1))
        return (mix_pwr, jnp.log1p(mix_pwr),
                mix_ri / (mix_pwr[..., None] + hp.EPS))

    def _separate_tail(self, params, embed, mix_pwr, phase_unit):
        """Shared inference tail: attractors -> masks -> reconstruction."""
        b = embed.shape[0]
        embed_flat = embed.reshape(b, -1, embed.shape[-1])
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed, mix_pwr=mix_pwr)
        sep_pwr = self.separator.apply(
            params["separator"], mix_pwr, attractors, embed_flat)
        return sep_pwr[..., None] * phase_unit[:, None]

    def separate(self, params, mix_ri: jnp.ndarray) -> jnp.ndarray:
        """Inference: mixture ri spectra [B,T,F,2] -> separated ri
        [B,N,T,F,2] (reference infer_fetches, main.py:333-335,384-385;
        output source order is arbitrary, as in the reference)."""
        mix_pwr, logmag, phase_unit = self._mix_features(mix_ri)
        embed, _ = self._embed(params, logmag, train=False, rng=None)
        return self._separate_tail(params, embed, mix_pwr, phase_unit)

    # ------------------------------------------------------------------
    def separate_sp(self, params, mix_ri: jnp.ndarray, mesh,
                    halo: int = 32, seq_axis: str = "seq",
                    sp_attn: str = "ring") -> jnp.ndarray:
        """Sequence-parallel inference over a 'seq' mesh axis:
        [B, T, F, 2] -> [B, N, T, F, 2].

        The pointwise front-end, embedding head, estimator einsums and
        masking are exactly T-sharded (GSPMD inserts the psums for the
        global attractor reductions).  The encoder runs sequence-parallel
        per its family: bilstm-orig per SP_RNN_SCHEME — 'relay' (EXACT
        boundary-state relay, default) or 'halo' (approximate warmup,
        halo-decaying error) via parallel/seq_parallel.bilstm_stack_sp;
        attn-v1/moe-v1 via EXACT sequence-parallel attention — `sp_attn`
        picks the collective pattern: 'ring' (K/V rotation around the
        device ring, parallel/ring_attention) or 'ulysses' (all-to-all head
        sharding, parallel/ulysses; needs ATTN_HEADS divisible by the
        axis size).
        """
        from danet_tpu.models.encoders import (AttentionEncoder,
                                                BiLstmEncoder, _LstmHead,
                                                _candidate_activation)
        hp = self.hp
        mix_pwr, logmag, phase_unit = self._mix_features(mix_ri)
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        enc = params["encoder"]

        if isinstance(self.encoder, AttentionEncoder):
            if sp_attn == "ulysses":
                from danet_tpu.parallel.ulysses import (
                    ulysses_attention as sp_attention)
            else:
                from danet_tpu.parallel.ring_attention import (
                    ring_attention as sp_attention)
            causal_w = self.encoder._causal_window()
            embed = self.encoder.apply(
                enc, logmag.astype(cdt),
                attn_fn=lambda q, k, v, km: sp_attention(
                    q, k, v, mesh, seq_axis=seq_axis, key_mask=km,
                    causal_window=causal_w),
                attn_fn_is_causal=True)
        elif isinstance(self.encoder, BiLstmEncoder):
            from danet_tpu.parallel.seq_parallel import bilstm_stack_sp
            x = logmag.astype(cdt)
            x = x - jnp.mean(x, axis=(1, 2), keepdims=True)
            layers = [enc[f"lstm{i}"]
                      for i in range(self.encoder.N_LAYERS)]
            h = bilstm_stack_sp(
                layers, x, mesh, halo=halo, seq_axis=seq_axis,
                candidate_activation=_candidate_activation(hp),
                scheme=getattr(hp, "SP_RNN_SCHEME", "relay") or "relay")
            embed = _LstmHead.apply(enc["output"], hp, h)
        else:
            raise NotImplementedError(
                "separate_sp supports bilstm-orig and attention encoders")
        return self._separate_tail(params, embed, mix_pwr, phase_unit)

    # ------------------------------------------------------------------
    def separate_long(self, params, mix_ri: jnp.ndarray,
                      chunk_frames: int = 256,
                      overlap_frames: int = 32) -> jnp.ndarray:
        """Streaming long-form separation: [T, F, 2] -> [N, T, F, 2].

        Long recordings are processed as overlapping chunks batched into
        ONE separate() call (the chunk axis becomes the batch axis — large
        GEMMs regardless of input length), then stitched:

          * source alignment: separation is permutation-ambiguous per
            chunk, so each chunk's sources are re-ordered to best match the
            previous chunk's tail over the overlap region (magnitude MSE,
            the PIT machinery reused with a lax.scan chain);
          * crossfade: linear ramp over the overlapped frames.

        Memory is O(T) on device but encoder state never spans chunks —
        arbitrarily long inputs separate at fixed per-chunk cost.  Not in
        the reference (which feeds whole utterances, demo mode only).
        """
        hp = self.hp
        t, f = mix_ri.shape[0], mix_ri.shape[1]
        n = hp.MAX_N_SIGNAL
        hop = chunk_frames - overlap_frames
        assert hop > 0
        assert overlap_frames > 0, \
            "separate_long needs overlap_frames >= 1 (alignment + crossfade)"

        n_chunks = max(1, -(-(t - overlap_frames) // hop))
        t_pad = overlap_frames + n_chunks * hop
        mix_p = jnp.pad(mix_ri, [(0, t_pad - t), (0, 0), (0, 0)])

        starts = np.arange(n_chunks) * hop
        idx = starts[:, None] + np.arange(chunk_frames)[None, :]
        chunks = mix_p[jnp.asarray(idx)]              # [C, W, F, 2]

        sep = self.separate(params, chunks)           # [C, N, W, F, 2]

        # --- chain alignment over chunks ---
        perms = jnp.asarray(loss_ops.permutations_array(n))  # [P, N]

        def align(prev_tail, chunk_sep):
            # prev_tail: [N, V, F] magnitudes of the previous aligned tail
            head = jnp.sqrt(jnp.sum(jnp.square(
                chunk_sep[:, :overlap_frames]), axis=-1))     # [N, V, F]
            cost = jnp.mean(jnp.square(
                prev_tail[:, None] - head[None, :]), axis=(2, 3))  # [N, N]
            perm_cost = jnp.sum(
                cost[jnp.arange(n)[None, :], perms], axis=1)  # [P]
            best = perms[jnp.argmin(perm_cost)]               # [N]
            aligned = chunk_sep[best]
            new_tail = jnp.sqrt(jnp.sum(jnp.square(
                aligned[:, -overlap_frames:]), axis=-1))
            return new_tail, aligned

        init_tail = jnp.sqrt(jnp.sum(jnp.square(
            sep[0][:, -overlap_frames:]), axis=-1))
        _, rest = jax.lax.scan(align, init_tail, sep[1:])
        aligned = jnp.concatenate([sep[:1], rest], axis=0)    # [C, N, W, F, 2]

        # --- crossfaded overlap-add over the frame axis ---
        ramp = jnp.linspace(0.0, 1.0, overlap_frames + 2)[1:-1]
        w = jnp.ones((chunk_frames,))
        w = w.at[:overlap_frames].set(ramp)
        w = w.at[-overlap_frames:].set(ramp[::-1])
        # first chunk keeps its head, last keeps its tail
        weights = jnp.broadcast_to(w, (n_chunks, chunk_frames))
        weights = weights.at[0, :overlap_frames].set(1.0)
        weights = weights.at[-1, -overlap_frames:].set(1.0)

        out = jnp.zeros((n, t_pad, f, 2), dtype=sep.dtype)
        den = jnp.zeros((t_pad,), dtype=sep.dtype)
        flat_idx = jnp.asarray(idx.reshape(-1))
        contrib = aligned * weights[:, None, :, None, None]
        out = out.at[:, flat_idx].add(
            jnp.moveaxis(contrib, 1, 0).reshape(n, -1, f, 2))
        den = den.at[flat_idx].add(weights.reshape(-1))
        out = out / den[None, :, None, None]
        return out[:, :t]

    # ------------------------------------------------------------------
    def _stream_capable(self) -> bool:
        """True when the configured encoder supports exact causal
        streaming (shared gate of separate_stream / stream_init)."""
        from danet_tpu.models.encoders import (AttentionEncoder,
                                               DprnnEncoder, GruEncoder,
                                               LstmEncoder, TcnEncoder)
        hp = self.hp
        if isinstance(self.encoder, (LstmEncoder, GruEncoder)):
            return True
        if isinstance(self.encoder, AttentionEncoder):
            # causal windowed attention streams via per-layer K/V caches
            return bool(getattr(hp, "ATTN_CAUSAL", False))
        if isinstance(self.encoder, TcnEncoder):
            return bool(getattr(hp, "TCN_CAUSAL", False))
        if isinstance(self.encoder, DprnnEncoder):
            # online variant: causal inter-chunk RNN + non-overlapping
            # segments (stream_state_init re-validates with a message)
            d = self.encoder._dims()
            return bool(getattr(hp, "DPRNN_INTER_CAUSAL", False)) and (
                d[2] == d[3])
        return False

    def _stream_granularity(self) -> int:
        """Frames per streaming advance unit (1 unless the encoder is
        segment-granular, e.g. dprnn-v1's DPRNN_CHUNK)."""
        fn = getattr(self.encoder, "stream_granularity", None)
        return int(fn()) if fn is not None else 1

    def separate_stream(self, params, mix_ri: jnp.ndarray,
                        chunk_frames: int = 64,
                        warmup_frames: int = 128) -> jnp.ndarray:
        """Causal ONLINE separation with carried RNN state:
        [T, F, 2] -> [N, T, F, 2].

        Real-time inference mode for the causal (unidirectional) encoders
        (lstm-orig, gru-v1) — not possible in the reference, whose graph
        consumes whole utterances (main.py:215-219).  Frames after a
        warmup window are processed in fixed-size chunks with the
        encoders' (c, h) state carried across chunk boundaries, so chunked
        streaming reproduces the full-sequence recurrence EXACTLY (tested:
        output is invariant to chunk_frames) and per-chunk latency is
        constant regardless of stream length.

        Streaming semantics for the non-causal statistics, frozen from the
        warmup window (the standard online adaptation):

          * input mean-centering (reference modules.py:150-151) and the
            output head's centering (modules.py:181-184) use the warmup
            window's means;
          * attractors are estimated ONCE on the warmup embedding
            (inference estimator) and reused for every later chunk —
            DaNet's attractors are utterance-level speaker anchors, so
            this is the intended deployment of the anchored/k-means
            estimators (DaNet paper §2.3).

        Use separate_long for offline long-form input (batched chunks,
        larger GEMMs, permutation re-alignment); use this for
        latency-bound live streams.
        """
        hp = self.hp
        if not self._stream_capable():
            raise ValueError(
                "separate_stream requires a causal encoder (lstm-orig, "
                "gru-v1, attn-v1/moe-v1 with ATTN_CAUSAL=true, tcn-v1 "
                "with TCN_CAUSAL=true, or dprnn-v1 with "
                "DPRNN_INTER_CAUSAL=true and DPRNN_HOP == DPRNN_CHUNK); "
                "got ENCODER_TYPE=%r. Bidirectional encoders "
                "need future context — use separate_long."
                % hp.ENCODER_TYPE)
        g = self._stream_granularity()
        t, f = mix_ri.shape[0], mix_ri.shape[1]
        w = int(min(warmup_frames, t))
        w = max(w - w % g, g)  # segment-granular encoders advance in g
        if w > t:
            raise ValueError(
                "stream too short: the encoder advances in %d-frame "
                "segments but the stream has only %d frames" % (g, t))
        assert chunk_frames >= 1
        if chunk_frames % g:
            raise ValueError(
                "chunk_frames=%d must be a multiple of the encoder's "
                "stream granularity %d (DPRNN_CHUNK)" % (chunk_frames, g))
        n_chunks = -(-(t - w) // chunk_frames) if t > w else 0
        t_pad = w + n_chunks * chunk_frames
        mix_p = jnp.pad(mix_ri, [(0, t_pad - t), (0, 0), (0, 0)])[None]
        mix_pwr, logmag, phase_unit = self._mix_features(mix_p)
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        enc, n = self.encoder, hp.MAX_N_SIGNAL

        # ---- warmup: state, frozen stats, attractors ----
        mu_in = jnp.mean(logmag[:, :w], axis=(1, 2), keepdims=True)
        state = enc.stream_state_init(1, dtype=jnp.asarray(0.0, cdt).dtype)
        h_w, state = enc.stream_hidden(
            params["encoder"], (logmag[:, :w] - mu_in).astype(cdt), state)
        mu_head = jnp.mean(h_w, axis=(1, 2), keepdims=True)
        embed_w = enc.stream_head(params["encoder"], h_w, mu_head)
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed_w,
            mix_pwr=mix_pwr[:, :w])

        def sep_chunk(embed, pwr_c, phase_c):
            ef = embed.reshape(1, -1, embed.shape[-1])
            sep_pwr = self.separator.apply(
                params["separator"], pwr_c, attractors, ef)
            return sep_pwr[..., None] * phase_c[:, None]   # [1,N,Tc,F,2]

        out_w = sep_chunk(embed_w, mix_pwr[:, :w], phase_unit[:, :w])
        if n_chunks == 0:
            return out_w[0, :, :t]

        # ---- post-warmup chunks: lax.scan carrying the RNN state ----
        def to_chunks(x):
            return x[:, w:].reshape(
                (1, n_chunks, chunk_frames) + x.shape[2:]).swapaxes(0, 1)

        def step(state, inp):
            logmag_c, pwr_c, phase_c = inp
            h, state = enc.stream_hidden(
                params["encoder"], (logmag_c - mu_in).astype(cdt), state)
            embed = enc.stream_head(params["encoder"], h, mu_head)
            return state, sep_chunk(embed, pwr_c, phase_c)

        _, outs = jax.lax.scan(
            step, state,
            (to_chunks(logmag), to_chunks(mix_pwr), to_chunks(phase_unit)))
        # [C, 1, N, Tc, F, 2] -> [N, C*Tc, F, 2]
        rest = jnp.moveaxis(outs[:, 0], 1, 0).reshape(n, -1, f, 2)
        return jnp.concatenate([out_w[0], rest], axis=1)[:, :t]

    # ------------------------------------------------------------------
    # Waveform-level causal streaming: fixed-size wav chunks in, separated
    # wav chunks out, ALL state explicit — the real-time serving pipeline
    # (AOT-exportable; serve.export_streamer).  Spectral-level streaming
    # with implicit chunking is separate_stream above.
    # ------------------------------------------------------------------
    def _stream_sep_frames(self, params, mix_ri, logmag, mu_in, mu_head,
                           attractors, enc_state):
        """Shared per-chunk spectral pipeline: frames -> separated ri."""
        cdt = getattr(self.hp, "COMPUTE_DTYPE", "float32")
        mix_pwr = jnp.sqrt(jnp.sum(jnp.square(mix_ri), axis=-1))
        phase_unit = mix_ri / (mix_pwr[..., None] + self.hp.EPS)
        h, enc_state = self.encoder.stream_hidden(
            params["encoder"], (logmag - mu_in).astype(cdt), enc_state)
        embed = self.encoder.stream_head(params["encoder"], h, mu_head)
        ef = embed.reshape(embed.shape[0], -1, embed.shape[-1])
        sep_pwr = self.separator.apply(
            params["separator"], mix_pwr, attractors, ef)
        return sep_pwr[..., None] * phase_unit[:, None], mix_pwr, enc_state

    def stream_init(self, params, wav_warmup: jnp.ndarray):
        """Start a causal waveform stream: [B, Lw] -> (sep [B, N, Lw],
        state).

        Runs the warmup window through the causal encoder (lstm-orig,
        gru-v1, or tcn-v1 with TCN_CAUSAL — same gate as separate_stream),
        freezes the non-causal statistics from it (input/head centering
        means, attractors via the inference estimator), and emits the
        warmup audio.  Lw must be a multiple of FFT_STRIDE.

        The returned ``state`` pytree carries EVERYTHING between chunks:
        encoder recurrent state / conv tails, the STFT input tail, the
        iSTFT overlap-add tail, and the frozen statistics — so
        ``stream_step`` is a pure function (state, chunk) -> (state', out)
        and AOT-exports with jax.export (serve.export_streamer).  Output
        audio lags input by FFT_SIZE - FFT_STRIDE samples (minimal
        overlap-add latency; ops/dsp.py streaming convention).
        """
        from danet_tpu.ops import dsp
        hp = self.hp
        if not self._stream_capable():
            raise ValueError(
                "stream_init requires a causal encoder (lstm-orig, "
                "gru-v1, attn-v1/moe-v1 with ATTN_CAUSAL=true, tcn-v1 "
                "with TCN_CAUSAL=true, or dprnn-v1 with "
                "DPRNN_INTER_CAUSAL=true and DPRNN_HOP == DPRNN_CHUNK); "
                "got ENCODER_TYPE=%r" % hp.ENCODER_TYPE)
        fft, stride = hp.FFT_SIZE, hp.FFT_STRIDE
        p = fft - stride
        b = wav_warmup.shape[0]
        if wav_warmup.shape[-1] < stride:
            raise ValueError(
                "warmup window must cover at least one frame "
                "(>= FFT_STRIDE=%d samples, got %d)"
                % (stride, wav_warmup.shape[-1]))
        g = self._stream_granularity()
        if g > 1 and (wav_warmup.shape[-1] // stride) % g:
            raise ValueError(
                "the encoder advances in %d-frame segments: the warmup "
                "window must be a multiple of %d samples "
                "(FFT_STRIDE * granularity; got %d samples = %d frames)"
                % (g, g * stride, wav_warmup.shape[-1],
                   wav_warmup.shape[-1] // stride))
        n = hp.MAX_N_SIGNAL
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        window = hp.FFT_WND_ARRAY

        frames, stft_tail = dsp.stream_frames(
            jnp.zeros((b, p), wav_warmup.dtype), wav_warmup, fft, stride)
        mix_ri = dsp.stft_frames_ri(frames, window)       # [B, W, F, 2]
        mix_pwr = jnp.sqrt(jnp.sum(jnp.square(mix_ri), axis=-1))
        logmag = jnp.log1p(mix_pwr)
        mu_in = jnp.mean(logmag, axis=(1, 2), keepdims=True)
        enc_state0 = self.encoder.stream_state_init(
            b, dtype=jnp.asarray(0.0, cdt).dtype)
        h, enc_state = self.encoder.stream_hidden(
            params["encoder"], (logmag - mu_in).astype(cdt), enc_state0)
        mu_head = jnp.mean(h, axis=(1, 2), keepdims=True)
        embed = self.encoder.stream_head(params["encoder"], h, mu_head)
        attractors = self.infer_estimator.apply(
            self._infer_est_params(params), embed, mix_pwr=mix_pwr)

        phase_unit = mix_ri / (mix_pwr[..., None] + hp.EPS)
        ef = embed.reshape(b, -1, embed.shape[-1])
        sep_pwr = self.separator.apply(
            params["separator"], mix_pwr, attractors, ef)
        sep_ri = sep_pwr[..., None] * phase_unit[:, None]
        out, ola_tail = dsp.istft_stream_ri(
            sep_ri, stride, window, jnp.zeros((b, n, p), jnp.float32))
        state = {"enc": enc_state, "stft_tail": stft_tail,
                 "ola_tail": ola_tail, "mu_in": mu_in, "mu_head": mu_head,
                 "attractors": attractors}
        return out, state

    def stream_step(self, params, state: dict,
                    wav_chunk: jnp.ndarray):
        """One causal streaming step: (state, [B, Lc]) -> ([B, N, Lc],
        state').  Lc must be a multiple of FFT_STRIDE; output is
        chunk-size-invariant (tested) and lags input by
        FFT_SIZE - FFT_STRIDE samples."""
        from danet_tpu.ops import dsp
        hp = self.hp
        window = hp.FFT_WND_ARRAY
        frames, stft_tail = dsp.stream_frames(
            state["stft_tail"], wav_chunk, hp.FFT_SIZE, hp.FFT_STRIDE)
        mix_ri = dsp.stft_frames_ri(frames, window)
        logmag = jnp.log1p(jnp.sqrt(jnp.sum(jnp.square(mix_ri), axis=-1)))
        sep_ri, _, enc_state = self._stream_sep_frames(
            params, mix_ri, logmag, state["mu_in"], state["mu_head"],
            state["attractors"], state["enc"])
        out, ola_tail = dsp.istft_stream_ri(
            sep_ri, hp.FFT_STRIDE, window, state["ola_tail"])
        return out, dict(state, enc=enc_state, stft_tail=stft_tail,
                         ola_tail=ola_tail)

    # ------------------------------------------------------------------
    def separate_wav(self, params, wav: jnp.ndarray) -> jnp.ndarray:
        """Fused streaming inference: waveform batch [B, L] -> separated
        waveforms [B, N, L'].

        The whole pipeline — GEMM-native STFT, encoder, attractor
        estimation, masking, phase reconstruction, GEMM-native iSTFT —
        compiles to ONE XLA program on device; no host DSP round-trip
        (the reference does STFT/iSTFT on the host with scipy,
        utils.py:95-135).  L' = num_frames * FFT_STRIDE, the reference
        overlap-add length convention.
        """
        from danet_tpu.ops import dsp
        hp = self.hp
        window = hp.FFT_WND_ARRAY
        mix_ri = dsp.stft_ri(wav, hp.FFT_SIZE, hp.FFT_STRIDE, window)
        sep_ri = self.separate(params, mix_ri)                # [B,N,T,F,2]
        return dsp.istft_ri(sep_ri, hp.FFT_STRIDE, window)

    # ------------------------------------------------------------------
    def parameter_count(self, params) -> int:
        """Total trainable parameter count (reference main.py:542-548)."""
        return sum(x.size for x in jax.tree_util.tree_leaves(params))


def reg_loss(params, reg_type: str, scale: float):
    """L1/L2 parameter regularization.

    The reference attaches a regularizer to the variable scope but never
    adds the collection to the objective (main.py:228-229; inert — see
    SURVEY.md appendix), so this is OFF by default (REG_APPLY=false) and
    functional when enabled.
    """
    leaves = jax.tree_util.tree_leaves(params)
    if reg_type == "L2":
        return scale * sum(jnp.sum(jnp.square(x)) for x in leaves)
    if reg_type == "L1":
        return scale * sum(jnp.sum(jnp.abs(x)) for x in leaves)
    raise ValueError("Unknown REG_TYPE %r" % (reg_type,))
