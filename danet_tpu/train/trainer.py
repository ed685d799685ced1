"""Training driver: jitted SPMD train/valid steps + reference loop semantics.

Re-implements the reference Model.train/test loops
(reference main.py:402-532) on a functional substrate:

  * one jitted, buffer-donating train step (fwd+bwd+update fused in a single
    XLA program) instead of sess.run over fetch lists;
  * batches placed with a ('data',)-sharded NamedSharding; parameters are
    sharded per danet_tpu.parallel rules — gradient all-reduce and TP
    collectives are inserted by GSPMD;
  * static bucketed time shapes (pad T up to TIME_BUCKET multiples) instead
    of the reference's dynamic-length graph, bounding XLA recompiles;
  * the reference's loop features preserved: random MAX_TRAIN_LEN crop,
    per-epoch LR decay (adaptive/fixed/None), NaN-rollback to the previous
    epoch checkpoint, per-epoch saves under saves/<name>_e<i>, validation
    sweep, running-mean CLI reports, ':'/'.'/'S' progress glyphs.

Deliberate fixes vs the reference (documented in SURVEY.md appendix):
optimizer state is checkpointed (Adam moments survive resume), test-mode
metrics are averaged rather than summed, RNN state is implicitly zero per
batch (the scan carries no cross-batch state, so no reset_state() step).
"""
from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from collections import OrderedDict
from math import isnan
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from danet_tpu import optim as optim_lib
from danet_tpu.data import audio
from danet_tpu.hparams import hparams
from danet_tpu.parallel import (batch_sharding, mesh_from_hparams,
                                replicated, shard_params)
from danet_tpu.train import checkpoint as ckpt_lib
from danet_tpu.train.metrics import MetricsWriter, StepTimer

# exit code of the hang watchdog (WATCHDOG_SECS): distinct from python's
# 1/2 and shells' 126+ so supervisors can tell "device link hung, relaunch
# and resume" from a real crash
WATCHDOG_EXIT_CODE = 114


def _dict_add(dst, src):
    for k, v in src.items():
        dst[k] = dst.get(k, 0.0) + v


def _dict_mul(di, coeff):
    for k in di:
        di[k] *= coeff


def _dict_format(di):
    return " ".join("%s=%s" % (k, v) for k, v in di.items())


def prefetch_to_device(batch_iter, put_fn, depth: int = 2):
    """Pipelined input: host batch prep runs in a background thread while
    the device computes; the (async) device transfer happens on the main
    thread, which owns all dispatch.  The reference's feed_dict copy is
    fully synchronous (main.py:430-431).  Yields device arrays."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []
    stop = threading.Event()

    def worker():
        try:
            for item in batch_iter:
                # bounded put + stop flag: if the consumer abandons the
                # generator (step exception, Ctrl-C), the worker must not
                # block on a full queue forever, pinning the dataset
                # handles it holds
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            while not stop.is_set():  # consumer still draining: deliver
                try:
                    q.put(sentinel, timeout=0.5)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield put_fn(item)  # async dispatch; returns before DMA ends
    finally:
        stop.set()


def effective_bucket(hp):
    """TIME_BUCKET adjusted for sequence parallelism: under MESH_SEQ > 1
    every padded T must divide over the 'seq' axis, so the bucket rounds
    up to lcm(TIME_BUCKET, MESH_SEQ) (or just MESH_SEQ when unbucketed).
    Segment-granular encoders widen the unit further via the
    Encoder.sp_granularity hook (e.g. dprnn-v1 SP shards whole
    DPRNN_CHUNK segments per device, so the bucket must divide by
    DPRNN_CHUNK * MESH_SEQ)."""
    bucket = getattr(hp, "TIME_BUCKET", None)
    n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
    if n_seq > 1:
        from math import gcd
        try:
            g = int(hp.get_encoder()(hp, "bucket_probe").sp_granularity())
        except Exception:
            g = 1  # unregistered/misconfigured encoder: fail later, loudly
        unit = max(g, 1) * n_seq
        b = int(bucket or 1)
        bucket = b * unit // gcd(b, unit)
    return bucket


def prepare_batch(flat_spectra: np.ndarray, batch_size: int, n_signal: int,
                  max_len: Optional[int] = None,
                  bucket: Optional[int] = None,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Host-side batch prep: flat [B*N, T, F] -> ri [B, N, T', F, 2].

    Reshaping consecutive utterances into the N axis IS the speaker mixing
    (the shuffle pairs them; reference main.py:414-421); then the random
    MAX_TRAIN_LEN temporal crop (main.py:422-426) and zero-padding up to the
    TIME_BUCKET multiple for static XLA shapes.
    """
    b_total = flat_spectra.shape[0]
    assert b_total == batch_size * n_signal, (b_total, batch_size, n_signal)
    spectra = flat_spectra.reshape(
        batch_size, n_signal, -1, flat_spectra.shape[-1])
    t = spectra.shape[2]
    if max_len is not None and t > max_len:
        rng = rng or np.random
        beg = rng.randint(0, t - max_len)
        spectra = spectra[:, :, beg:beg + max_len]
        t = max_len
    if bucket:
        pad = (-t) % bucket
        if pad:
            spectra = np.pad(
                spectra, [(0, 0), (0, 0), (0, pad), (0, 0)])
    return audio.to_ri(spectra)


def prepare_batch_wave(flat_wave: np.ndarray, batch_size: int, n_signal: int,
                       fft_size: int, stride: int,
                       max_len: Optional[int] = None,
                       bucket: Optional[int] = None,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
    """Host-side prep for TRANSFER_DOMAIN='wave': flat [B*N, S] waveforms
    -> [B, N, S'] float32, crop/bucket expressed in STFT FRAMES so the
    device-side GEMM STFT (ops/dsp.py::stft_ri, scipy-compatible framing)
    lands on exactly the same static [T', F] grid the spectra wire uses.

    Same semantics as prepare_batch: consecutive-utterance reshape IS the
    speaker mixing (reference main.py:414-421), random MAX_TRAIN_LEN crop
    (main.py:422-426, at frame granularity: a crop of L frames spans
    (L-1)*stride samples of the un-boundary-padded signal), zero-pad up
    to the TIME_BUCKET frame multiple.  The wire moves raw audio instead
    of its (f32-wide, redundant at overlap>0) STFT — 4x fewer bytes than
    bf16 spectra, 8x fewer than the f32 spectra wire at the default
    fft=256/stride=64, before the optional int16 wire quantization."""
    b_total = flat_wave.shape[0]
    assert b_total == batch_size * n_signal, (b_total, batch_size, n_signal)
    wave = flat_wave.reshape(batch_size, n_signal, -1)
    from danet_tpu.ops.dsp import stft_frame_count
    t = stft_frame_count(wave.shape[-1], fft_size, stride)
    if max_len is not None and t > max_len:
        rng = rng or np.random
        # beg <= t - max_len - 1, so the slice end (beg + max_len - 1) *
        # stride <= (t - 2) * stride < S — always a full in-bounds slice
        beg = rng.randint(0, t - max_len)
        span = (max_len - 1) * stride  # samples spanning max_len frames
        wave = wave[:, :, beg * stride:beg * stride + span]
        t = max_len
    if bucket:
        t = t + ((-t) % bucket)
    # canonicalize the sample length to the frame grid: every S in
    # ((t-2)*stride, (t-1)*stride] yields t frames, so snapping S up to
    # (t-1)*stride dedupes compile shapes without changing t.  NOTE:
    # unlike the spectra wire's appended all-zero frames, bucket-pad
    # frames here are STFTs of the zero-padded tail (windows overlapping
    # the last real samples are nonzero), and crop-edge frames see zero
    # boundary context instead of the neighboring samples the spectra
    # wire's crop retained — a training-level augmentation difference,
    # not a defect; the two wires are frame-exact only on uncropped,
    # unbucketed signals (tests/test_wave_wire.py pins that case).
    target = (t - 1) * stride
    if wave.shape[-1] < target:
        wave = np.pad(
            wave, [(0, 0), (0, 0), (0, target - wave.shape[-1])])
    return wave.astype(np.float32)


class Trainer:
    """Owns the optimizer, the mesh, the jitted step functions, and the
    training/eval loops. ``state`` is {params, opt_state, step, epoch}."""

    def __init__(self, model, hp=None, name: str = "UnnamedExperiment",
                 mesh=None, save_dir: str = "saves"):
        self.hp = hp if hp is not None else hparams
        self.model = model
        self.name = name
        self.save_dir = save_dir
        self.optimizer = optim_lib.make_optimizer(self.hp)
        self._preempt = False
        self._heartbeat = time.monotonic()
        self._watchdog_on = False
        self.mesh = mesh if mesh is not None else mesh_from_hparams(self.hp)
        # a configured strategy must actually be provided by the mesh the
        # trainer runs on — model code falls back DENSE on meshes without
        # the axis (the inference-host behavior), which in TRAINING would
        # silently drop the requested parallelism, so fail loudly here
        for key, axis in (("MESH_MODEL", "model"), ("MESH_PIPE", "pipe"),
                          ("MESH_EXPERT", "expert"), ("MESH_SEQ", "seq")):
            n = int(getattr(self.hp, key, 1) or 1)
            if n > 1 and self.mesh.shape.get(axis, 1) != n:
                raise ValueError(
                    "%s=%d but the trainer mesh has no matching %r axis "
                    "(%r) — build it via mesh_from_hparams or pass a "
                    "mesh carrying the configured axes"
                    % (key, n, axis, dict(self.mesh.shape)))
        # model code (pipeline/expert shard_map paths) reaches the mesh
        # through the active-mesh registry
        from danet_tpu.parallel import set_active_mesh
        set_active_mesh(self.mesh)
        self._build_steps()

    # ------------------------------------------------------------------
    def _build_steps(self):
        model, opt = self.model, self.optimizer
        # TRANSFER_DOMAIN='wave': the wire carries raw waveforms [B, N, S]
        # (optionally int16 PCM) and the jitted steps run the GEMM STFT
        # on-device — the host->device link moves 4-8x fewer bytes than
        # the spectra contract and the front-end runs as device GEMMs.  The
        # reference has no equivalent: its feed_dict ships f32 complex
        # spectra every step (main.py:427-431).
        domain = str(getattr(self.hp, "TRANSFER_DOMAIN", "spectra"))
        if domain not in ("spectra", "wave"):
            raise ValueError(
                "TRANSFER_DOMAIN=%r: expected 'spectra' or 'wave'" % domain)
        self._wave_mode = domain == "wave"
        wire_dtype = str(getattr(self.hp, "TRANSFER_DTYPE", "float32"))
        if wire_dtype not in ("float32", "bfloat16", "int16"):
            # an unknown value must not silently fall through to the f32
            # wire — the user believes the bytes were halved
            raise ValueError(
                "TRANSFER_DTYPE=%r: expected 'float32', 'bfloat16' or "
                "'int16'" % wire_dtype)
        if wire_dtype == "int16" and not self._wave_mode:
            raise ValueError(
                "TRANSFER_DTYPE='int16' is PCM quantization of the wave "
                "wire — it requires TRANSFER_DOMAIN='wave' (spectra have "
                "no natural int16 encoding)")
        # MESH_SEQ composes: the wire batch is only data-sharded (axis 0,
        # batch_sharding) for BOTH domains — the encoders reshard frames
        # onto 'seq' inside their own shard_maps — so the on-device STFT
        # runs before any seq partitioning, and effective_bucket's
        # granularity*n_seq frame quantum is honored by
        # prepare_batch_wave's frame-denominated bucketing
        # (tested: test_wave_wire.py::test_wave_wire_under_mesh_seq)
        # wire dtype + PCM scale are frozen HERE so the host-side cast
        # (_wire_cast) and the in-graph dequantization (ingest) can never
        # desync under a post-construction hparams mutation
        self._wire_dtype = wire_dtype
        self._pcm_scale = float(getattr(self.hp, "WAVE_PCM_SCALE", 1.0)
                                or 1.0)
        if self._wave_mode:
            from danet_tpu.ops import dsp as _dsp
            _fft = int(self.hp.FFT_SIZE)
            _stride = int(self.hp.FFT_STRIDE)
            _wnd = np.asarray(self.hp.FFT_WND_ARRAY, dtype=np.float32)
            _dq = self._pcm_scale / 32768.0  # symmetric PCM dequant:
            # wire = round(x * 32768 / scale) -> x' = wire * scale/32768
            # reproduces 16-bit-origin samples EXACTLY at scale=32768

            def ingest(src):
                x = src.astype(jnp.float32)
                if src.dtype == jnp.int16:
                    x = x * _dq
                return _dsp.stft_ri(x, _fft, _stride, _wnd)
        else:
            def ingest(src):
                # bf16-wire upcast: loss/target math stays f32 (XLA fuses
                # the convert into the first consumer); f32-wire no-op
                return src.astype(jnp.float32)
        accum = int(getattr(self.hp, "GRAD_ACCUM", 1) or 1)
        if accum > 1 and self.hp.BATCH_SIZE % accum != 0:
            raise ValueError(
                "GRAD_ACCUM=%d must divide BATCH_SIZE=%d"
                % (accum, self.hp.BATCH_SIZE))
        if accum > 1 and float(getattr(self.hp, "DC_LOSS_WEIGHT", 0) or 0):
            # the scale-matched DC weight is calibrated by watching this
            # column, so its absence must be loud, not a code comment
            print("[note] the raw-DC diagnostic column is unavailable under "
                  "GRAD_ACCUM>1 (fixed scan-carry structure); DC still "
                  "contributes to the loss")

        def grads_and_metrics(params, src_ri, rng):
            if accum == 1:
                (loss, aux), grads = jax.value_and_grad(
                    model.train_loss, has_aux=True)(params, src_ri, rng)
                extra = {"DC": aux["dc"]} if "dc" in aux else {}
                return grads, loss, aux["snr"], extra
            # gradient accumulation: the effective batch stays BATCH_SIZE
            # but fwd+bwd memory is one microbatch — lax.scan over accum
            # microbatches inside ONE compiled step (big-batch training on
            # a single chip's HBM; no reference analogue — single-GPU,
            # whole-batch only, main.py:430-431)
            micro = src_ri.reshape(
                (accum, src_ri.shape[0] // accum) + src_ri.shape[1:])
            rngs = (jax.random.split(rng, accum)
                    if rng is not None else jnp.zeros((accum,)))

            def body(carry, xs):
                g_acc, loss_acc, snr_acc = carry
                mb, k = xs
                (loss, aux), grads = jax.value_and_grad(
                    model.train_loss, has_aux=True)(
                        params, mb, k if rng is not None else None)
                g_acc = jax.tree_util.tree_map(jnp.add, g_acc, grads)
                return (g_acc, loss_acc + loss, snr_acc + aux["snr"]), None

            init = (jax.tree_util.tree_map(jnp.zeros_like, params),
                    jnp.zeros(()), jnp.zeros(()))
            (g, l, s), _ = jax.lax.scan(body, init, (micro, rngs))
            inv = 1.0 / accum
            # (the raw-DC diagnostic is reported on the accum==1 path only
            # — the scan carry structure is fixed before tracing)
            return (jax.tree_util.tree_map(lambda x: x * inv, g),
                    l * inv, s * inv, {})

        def train_step(params, opt_state, src_ri, rng):
            # wire ingest: bf16-spectra upcast, or wave -> on-device STFT
            src_ri = ingest(src_ri)
            grads, loss, snr, extra = grads_and_metrics(params, src_ri, rng)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, {"loss": loss, "SNR": snr, **extra}

        def valid_step(params, src_ri):
            src_ri = ingest(src_ri)  # wire ingest (see train_step)
            m = model.valid_metrics(params, src_ri)
            return {k: v for k, v in m.items() if k != "separated_ri"}

        if getattr(self.hp, "NAN_CHECKS", False):
            # checkify-instrumented step: the first NaN/inf inside the
            # fwd+bwd graph raises with its source location — the in-graph
            # upgrade of the reference's post-epoch NaN sentinel
            # (main.py:461-476); costs a few % per step, off by default.
            from jax.experimental import checkify

            checked = jax.jit(
                checkify.checkify(train_step, errors=checkify.float_checks),
                donate_argnums=(0, 1))

            def train_step_checked(params, opt_state, src_ri, rng):
                err, out = checked(params, opt_state, src_ri, rng)
                err.throw()  # host-side raise with the NaN's source location
                return out

            self._train_step = self._with_mesh(train_step_checked)
        else:
            self._train_step = self._with_mesh(
                jax.jit(train_step, donate_argnums=(0, 1)))
        # EMA (Polyak) weight averaging: a separate tiny jitted update so
        # the train step's signature/donation and the checkify variant stay
        # untouched; one fused elementwise pass over params, dispatched
        # async right after the step.  Eval/inference then run on the
        # averaged weights (state['ema']) — not in the reference (its
        # Saver writes raw variables only, main.py:192-206).
        self.ema_decay = float(getattr(self.hp, "EMA_DECAY", 0.0) or 0.0)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                "EMA_DECAY=%r must be in [0, 1)" % (self.ema_decay,))
        if self.ema_decay:
            d = self.ema_decay

            def ema_step(ema, params):
                return jax.tree_util.tree_map(
                    lambda e, p: e * d + p.astype(e.dtype) * (1.0 - d),
                    ema, params)

            self._ema_step = self._with_mesh(
                jax.jit(ema_step, donate_argnums=(0,)))

        # TRAIN_STEPS_PER_CALL > 1: scan K train steps (and the EMA
        # update) inside ONE dispatched XLA program over a [K, B, ...]
        # batch stack, for small steps whose per-call host dispatch cost
        # rivals their device time.  Bit-exact
        # vs K single steps: the per-step rng is derived with the SAME
        # fold_in(fold_in(rng, step), retry) composition the single-step
        # loop uses.  No reference analogue (sess.run per batch,
        # main.py:430-431).
        k_call = int(getattr(self.hp, "TRAIN_STEPS_PER_CALL", 1) or 1)
        if k_call > 1 and getattr(self.hp, "NAN_CHECKS", False):
            print("[TRAIN_STEPS_PER_CALL disabled under NAN_CHECKS — "
                  "checkify locates NaNs per single step]")
            k_call = 1
        if k_call > 1 and jax.process_count() > 1:
            print("[TRAIN_STEPS_PER_CALL disabled on multi-host — "
                  "per-host batch slicing is per-step]")
            k_call = 1
        self._steps_per_call = k_call
        if k_call > 1:
            ema_on = bool(self.ema_decay)
            d = self.ema_decay

            def train_step_k(params, opt_state, ema, src_k, step0, retry,
                             rng):
                def body(carry, xs):
                    params, opt_state, ema = carry
                    src, i = xs
                    k = jax.random.fold_in(
                        jax.random.fold_in(rng, i), retry)
                    params, opt_state, metrics = train_step(
                        params, opt_state, src, k)
                    if ema_on:
                        ema = jax.tree_util.tree_map(
                            lambda e, p: e * d + p.astype(e.dtype) * (1 - d),
                            ema, params)
                    return (params, opt_state, ema), metrics

                steps = step0 + jnp.arange(k_call, dtype=jnp.int32)
                (params, opt_state, ema), ms = jax.lax.scan(
                    body, (params, opt_state, ema), (src_k, steps))
                return params, opt_state, ema, ms

            self._train_step_k = self._with_mesh(
                jax.jit(train_step_k, donate_argnums=(0, 1, 2)))
        self._valid_step = self._with_mesh(jax.jit(valid_step))
        self._separate = self._with_mesh(jax.jit(model.separate))
        self._separate_wav = self._with_mesh(jax.jit(model.separate_wav))

    def _with_mesh(self, fn):
        """Re-register THIS trainer's mesh before every step call.

        The active-mesh registry is process-global; constructing a second
        Trainer (e.g. a side eval) would otherwise re-target the first
        trainer's lazily-traced shard_map routes (pipeline/expert/seq) to
        the newer mesh.  Jitted steps trace lazily at their first call,
        so registering at call time — not construction time — binds each
        trace to the trainer that owns it.

        Scope note: this binds the MESH half of routing.  Hyperparameter
        reads (MESH_* flags, dims, backends) happen at trace time against
        the hp namespace the model was built with — normally the process
        singleton — so when interleaving trainers with DIFFERENT configs,
        the singleton must reflect a trainer's config when its first step
        runs (the same contract every hp-dependent trace in this codebase
        has; Trainer construction validates its strategy axes against its
        mesh, so a mismatch fails loudly rather than routing densely)."""
        from danet_tpu.parallel import set_active_mesh

        def wrapped(*args, **kwargs):
            set_active_mesh(self.mesh)
            return fn(*args, **kwargs)

        return wrapped

    # ------------------------------------------------------------------
    def init_state(self, rng) -> dict:
        params = self.model.init(rng)
        params = shard_params(self.mesh, params)
        opt_state = jax.jit(self.optimizer.init)(params)
        state = {"params": params, "opt_state": opt_state,
                 "step": 0, "epoch": 0}
        if self.ema_decay:
            # independent buffers: the train step donates params, so the
            # EMA tree must not alias them
            state["ema"] = jax.tree_util.tree_map(jnp.copy, params)
        return state

    def _wire_cast(self, batch_np: np.ndarray) -> np.ndarray:
        """TRANSFER_DTYPE='bfloat16': cast the prepared batch host-side so
        the host->device transfer moves half the bytes (PCIe input
        bandwidth).  The jitted steps upcast back to f32 at entry, so
        compute/loss precision is unchanged — the only effect is bf16
        quantization of the input spectra (~8-bit mantissa, a noise floor
        ~48 dB under the signal; irrelevant at training SNRs).  Off by
        default; eval protocols should keep f32.

        TRANSFER_DTYPE='int16' (TRANSFER_DOMAIN='wave' only): PCM
        quantization of the wave wire — 2 bytes/sample like bf16 but
        EXACT for material that was 16-bit on disk when WAVE_PCM_SCALE
        matches the dataset's declared WAVE_SCALE (symmetric 32768
        scaling both ways; _epoch_fn enforces the match).  Wire dtype and
        scale were frozen at construction (_build_steps) so this cast and
        the jitted ingest cannot desync."""
        if self._wire_dtype == "bfloat16":
            import ml_dtypes
            return batch_np.astype(ml_dtypes.bfloat16)
        if self._wire_dtype == "int16":
            return np.clip(
                np.round(batch_np * (32768.0 / self._pcm_scale)),
                -32768, 32767).astype(np.int16)
        return batch_np

    def _epoch_fn(self, dataset, for_eval: bool = False):
        """The dataset iterator matching the configured wire domain.

        for_eval=True skips the int16-wire scale validation: eval sweeps
        always ship f32 (_put_batch for_eval) and never quantize, so an
        int16-configured trainer can still Trainer.test a dataset with a
        different declared WAVE_SCALE."""
        if not self._wave_mode:
            return dataset.epoch
        fn = getattr(dataset, "epoch_wave", None)
        if fn is None:
            raise ValueError(
                "TRANSFER_DOMAIN='wave' needs a wave-capable dataset "
                "(synth, synth-speech, wav-dir, wsj0, timit expose "
                "epoch_wave); %s stores spectra only — use the default "
                "spectra wire" % type(dataset).__name__)
        if self._wire_dtype == "int16" and not for_eval:
            # the PCM wire normalizes by WAVE_PCM_SCALE; a mismatch with
            # the dataset's declared amplitude bound either clips peaks
            # (scale too small) or throws away bits (too large) — fail
            # loudly instead of training on silently distorted audio
            want = float(getattr(dataset, "WAVE_SCALE", 1.0))
            if self._pcm_scale != want:
                raise ValueError(
                    "TRANSFER_DTYPE='int16' with WAVE_PCM_SCALE=%g but "
                    "%s declares WAVE_SCALE=%g — set WAVE_PCM_SCALE=%g "
                    "in the config (it is frozen into the compiled step, "
                    "so it is an hparam, not auto-adopted)"
                    % (self._pcm_scale, type(dataset).__name__, want,
                       want))
        return fn

    def _put_batch(self, batch_np: np.ndarray, for_eval: bool = False):
        """Single-host: device_put with the batch sharding.  Multi-host:
        every host prepares the identical global batch (seeded shuffles —
        see train()), keeps only its row slice, and assembles the global
        array (parallel/multihost.py).

        for_eval=True skips the lossy wire casts: valid/test sweeps
        always ship full-precision f32 so quality metrics stay
        protocol-comparable (PARITY.md evals are f32-wire) even when the
        TRAIN wire runs bf16/int16 — quantized inputs are a training
        throughput trade, never an eval one."""
        if not for_eval:
            batch_np = self._wire_cast(batch_np)
        if jax.process_count() > 1:
            from danet_tpu.parallel import multihost
            rows = multihost.host_batch_slice(batch_np.shape[0])
            return multihost.global_batch_from_local(
                self.mesh, batch_np[rows])
        return jax.device_put(batch_np, batch_sharding(self.mesh))

    # ------------------------------------------------------------------
    # LR control (reference main.py:185-190; LR lives in optax state here)
    def set_learn_rate(self, state, lr: float):
        optim_lib.set_learn_rate(state["opt_state"], lr)

    def get_learn_rate(self, state) -> float:
        return optim_lib.get_learn_rate(state["opt_state"])

    # ------------------------------------------------------------------
    def eval_params(self, state):
        """Weights that evaluation/inference runs on: the EMA (Polyak)
        average when EMA_DECAY is set (state['ema']), raw params otherwise.
        Used by the valid sweep, test(), separate() and the demo paths —
        with averaging enabled, every quality-facing consumer sees the
        averaged weights, never the raw ones."""
        ema = state.get("ema") if isinstance(state, dict) else None
        return ema if ema is not None else state["params"]

    # ------------------------------------------------------------------
    def save_path(self, epoch: int) -> str:
        return os.path.join(self.save_dir, "%s_e%d" % (self.name, epoch))

    def save_params(self, state, path: str):
        ckpt_lib.save_checkpoint(path, state)

    def load_params(self, state, path: str) -> dict:
        """Restore a train state AND re-establish its mesh placement.

        The checkpoint layer hands back host arrays; without re-sharding,
        a resume or NaN rollback on a dp x tp mesh would silently drop the
        tensor-parallel parameter placement (replicating every shard)."""
        state = ckpt_lib.load_checkpoint(path, state)
        state["params"] = shard_params(self.mesh, state["params"])
        if state.get("ema") is not None:
            # the EMA tree mirrors the params' sharding rules; without this
            # a resume/rollback on a dp x tp mesh would leave host arrays
            # that mis-place against the mesh-sharded params
            state["ema"] = shard_params(self.mesh, state["ema"])
        # opt_state placement mirrors a fresh init on the sharded params.
        # Scalar/statistic leaves of jit(init) can come back UNCOMMITTED on
        # the default device when the mesh covers only a subset of the
        # local devices (e.g. a small-batch data axis on a many-device
        # host); committing them there via device_put would then conflict
        # with the mesh-spanning params in the next train step — replicate
        # such leaves over the mesh instead.
        ref_opt = jax.jit(self.optimizer.init)(state["params"])
        mesh_ids = {d.id for d in self.mesh.devices.flat}
        rep = replicated(self.mesh)

        def _place(ref, x):
            sh = getattr(ref, "sharding", None)
            if sh is not None and {d.id for d in sh.device_set} == mesh_ids:
                return jax.device_put(np.asarray(x), sh)
            return jax.device_put(np.asarray(x), rep)

        state["opt_state"] = jax.tree_util.tree_map(
            _place, ref_opt, state["opt_state"])
        return state

    # ------------------------------------------------------------------
    def train(self, n_epoch: int, dataset, save_on_epoch: bool = True,
              valid_on_epoch: bool = True, state: Optional[dict] = None,
              rng=None, writer: Optional[MetricsWriter] = None,
              save_best: bool = False, lr: Optional[float] = None,
              data_seed: int = 0) -> dict:
        """Train loop with preemption-safe shutdown: SIGTERM/SIGINT during
        training checkpoints to ``saves/<name>_preempt`` at the next step
        boundary and returns the state cleanly (the production story for
        preemptible fleets; the reference dies checkpoint-less,
        main.py:402-510).  A resume from the preempt checkpoint restarts
        the interrupted epoch from its beginning with the mid-epoch
        params — some batches of that epoch are seen twice, the standard
        preemption-recovery tradeoff.  A second signal restores the
        default handler so a third one can force-kill a hung step."""
        with self._preempt_signals(), self._hang_watchdog():
            return self._train_impl(
                n_epoch, dataset, save_on_epoch, valid_on_epoch, state,
                rng, writer, save_best, lr, data_seed)

    @contextlib.contextmanager
    def _hang_watchdog(self):
        """General hang watchdog (SURVEY.md §5).

        A hung device, a collective waiting on a dead peer or a stuck
        input thread leaves the dispatching thread blocked forever inside
        a runtime call — no exception, no signal delivery (the step loop
        never reaches its ``self._preempt`` check), just a silent futex
        wait.  When WATCHDOG_SECS > 0, a daemon thread
        watches a heartbeat that every completed train step / eval batch /
        metric flush refreshes; if the heartbeat goes stale past the limit
        the process prints a diagnosis and hard-exits with
        WATCHDOG_EXIT_CODE so a supervisor (the staged-recipe retry loops,
        a cluster runner) can relaunch and resume from the last epoch
        checkpoint.  ``os._exit`` is deliberate: with the runtime wedged,
        interpreter shutdown (atexit, device teardown) can itself hang.
        The reference has no analogue — a hung sess.run stalls it forever (main.py:402-510)."""
        secs = float(getattr(self.hp, "WATCHDOG_SECS", 0) or 0)
        if secs <= 0 or self._watchdog_on:  # nested: train() owns it
            yield
            return
        self._heartbeat = time.monotonic()
        self._watchdog_on = True
        stop = threading.Event()

        def watch():
            while not stop.wait(min(15.0, secs / 4)):
                stale = time.monotonic() - self._heartbeat
                if stale > secs:
                    msg = ("\n[watchdog] no step/batch completed in %.0f s "
                           "(WATCHDOG_SECS=%.0f): presumed hung; "
                           "exiting %d for supervised relaunch\n"
                           % (stale, secs, WATCHDOG_EXIT_CODE))
                    for stream in (sys.stderr, sys.stdout):
                        try:
                            stream.write(msg)
                            stream.flush()
                        except Exception:
                            pass
                    os._exit(WATCHDOG_EXIT_CODE)

        thread = threading.Thread(
            target=watch, daemon=True, name="hang-watchdog")
        thread.start()
        try:
            yield
        finally:
            stop.set()
            self._watchdog_on = False

    @contextlib.contextmanager
    def _preempt_signals(self):
        self._preempt = False
        installed = {}

        def handler(signum, frame):
            if self._preempt:  # second signal: next one force-kills
                for sig, h in installed.items():
                    signal.signal(sig, h)
            self._preempt = True
            sys.stdout.write(
                "\n[signal %d: checkpointing at the next step boundary]\n"
                % signum)
            sys.stdout.flush()

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    installed[sig] = signal.signal(sig, handler)
                except (ValueError, OSError):  # pragma: no cover
                    pass
        try:
            yield
        finally:
            for sig, h in installed.items():
                signal.signal(sig, h)

    def _train_impl(self, n_epoch: int, dataset, save_on_epoch: bool = True,
                    valid_on_epoch: bool = True, state: Optional[dict] = None,
                    rng=None, writer: Optional[MetricsWriter] = None,
                    save_best: bool = False, lr: Optional[float] = None,
                    data_seed: int = 0) -> dict:
        hp = self.hp
        rng = rng if rng is not None else jax.random.PRNGKey(0)
        if state is None:
            rng, k_init = jax.random.split(rng)
            state = self.init_state(k_init)
        if writer is None:
            writer = MetricsWriter(hp.SUMMARY_DIR, hp.SUMMARY_TITLE)
        rng = jax.device_put(rng, replicated(self.mesh))

        best_loss = float("+inf")
        best_loss_time = 0
        best_valid_loss = float("+inf")
        # LR resume semantics: the checkpointed LR (restored inside
        # opt_state by load_params) is authoritative unless the caller
        # overrides it explicitly — a mid-stage resume of an adaptive-decay
        # run continues at the decayed LR instead of silently restarting at
        # hp.LR.  A fresh init already carries hp.LR (optim.make_optimizer),
        # so non-resumed runs behave identically.
        if lr is not None:
            self.set_learn_rate(state, lr)
            print("Set learning rate to %f" % lr)
        else:
            print("Learning rate: %f" % self.get_learn_rate(state))
        base_lr = self.get_learn_rate(state)  # cosine anneals from here
        bucket = effective_bucket(hp)

        # device profiling (absent in the reference — SURVEY.md §5): trace
        # PROFILE_STEPS steps after warmup into the run dir; view with
        # TensorBoard/Perfetto.
        profile_steps = int(getattr(hp, "PROFILE_STEPS", 0) or 0)
        profile_at = state["step"] + 3 if profile_steps else -1
        profiling = False

        # metrics fetched from device every METRICS_EVERY steps: a per-step
        # scalar transfer would serialize the pipeline (the reference's
        # sess.run is synchronous anyway; >1 trades logging granularity for
        # full async dispatch + prefetch overlap)
        metrics_every = int(getattr(hp, "METRICS_EVERY", 1) or 1)

        epoch_fn = self._epoch_fn(dataset)

        def device_batches():
            for data_pt in epoch_fn(
                    "train", hp.BATCH_SIZE * hp.MAX_N_SIGNAL, shuffle=True):
                if self._wave_mode:
                    yield prepare_batch_wave(
                        data_pt[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                        hp.FFT_SIZE, hp.FFT_STRIDE,
                        max_len=hp.MAX_TRAIN_LEN, bucket=bucket)
                else:
                    yield prepare_batch(
                        data_pt[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                        max_len=hp.MAX_TRAIN_LEN, bucket=bucket)

        # TRAIN_STEPS_PER_CALL: stack K prepared batches host-side (one
        # [K, B, ...] transfer) and run them through one scanned dispatch
        # (_build_steps).  The epoch remainder falls back to single steps.
        k_call = self._steps_per_call

        def grouped_batches():
            if k_call == 1:
                yield from device_batches()
                return
            buf = []
            for b in device_batches():
                # variable-length corpora (wav-dir/TIMIT/WSJ0) pad each
                # batch only to its own bucketed T, so consecutive batches
                # can differ in shape: stacking those would raise, and a
                # partial-size stack would force a fresh compile of
                # train_step_k per group size — flush a mismatched group
                # as single steps instead (ADVICE r3)
                if buf and b.shape != buf[0].shape:
                    yield from buf
                    buf = []
                buf.append(b)
                if len(buf) == k_call:
                    yield np.stack(buf)
                    buf = []
            yield from buf

        # single batches: spectra [B,N,T,F,2] (5d) / wave [B,N,S] (3d);
        # a TRAIN_STEPS_PER_CALL stack adds the leading K axis
        stacked_ndim = 4 if self._wave_mode else 6

        def put_any(batch_np):
            if batch_np.ndim == stacked_ndim:
                from danet_tpu.parallel import stacked_batch_sharding
                return jax.device_put(
                    self._wire_cast(batch_np),
                    stacked_batch_sharding(self.mesh))
            return self._put_batch(batch_np)

        # cumulative epoch numbering: a resumed run continues from the
        # checkpointed counter (epoch-save names, logs and the checkpoint's
        # own epoch field all report cumulative progress across stages)
        epoch0 = int(state.get("epoch", 0))
        epoch = epoch0
        n_total = epoch0 + n_epoch
        nan_retries = 0  # NaN-rollback retries; perturbs the retry's seeds
        crash_retries = 0  # total valid-crash rollbacks this invocation
        while epoch < n_total:
            # Deterministic per-epoch data stream (shuffle + crop): the
            # reference leaves these to the ambient unseeded np.random;
            # here every epoch seeds the global numpy RNG from
            # (data_seed, epoch, retry) so a run is reproducible end-to-end
            # and — on multi-host — all hosts draw the SAME shuffled epoch
            # stream, letting per-host batch slices partition one global
            # batch.  zlib.crc32 is process-independent (Python hash() is
            # salted per process); the retry counter folds in so a NaN
            # rollback does not replay a bit-identical epoch forever.
            import zlib
            np.random.seed(zlib.crc32(
                b"danet-epoch-%d-retry-%d-seed-%d"
                % (epoch, nan_retries, data_seed)))
            cli_report = OrderedDict()
            # pending: (step0, device-metrics dict, s/step, k) — scalars for
            # single steps, [K] arrays for a TRAIN_STEPS_PER_CALL group
            pending = []
            pending_steps = 0

            def flush_pending():
                nonlocal pending_steps
                if not pending:
                    return
                # ONE host transfer for the whole block (plus one LR fetch):
                # a float(v) per metric per step is a full device RTT each
                # and serializes the async dispatch pipeline
                fetched = jax.device_get([m for _, m, _, _ in pending])
                lr = self.get_learn_rate(state)
                for (step0, _, st, k), m in zip(pending, fetched):
                    for j in range(k):
                        row = {key: float(v[j] if k > 1 else v)
                               for key, v in m.items()}
                        row["LR"] = lr
                        writer.scalars(
                            "train", dict(row, step_time=st), step0 + j)
                        _dict_add(cli_report, row)
                pending.clear()
                pending_steps = 0
                self._heartbeat = time.monotonic()

            timer = StepTimer()
            n_batches = 0
            for src_ri in prefetch_to_device(grouped_batches(), put_any):
                stacked = src_ri.ndim == stacked_ndim
                if (profile_at >= 0 and not profiling
                        and state["step"] >= profile_at):
                    jax.profiler.start_trace(
                        os.path.join(writer.run_dir, "profile"))
                    profiling = True
                timer.start()
                if self.ema_decay and "ema" not in state:
                    # caller-supplied pre-EMA state
                    state["ema"] = jax.tree_util.tree_map(
                        jnp.copy, state["params"])
                if stacked:
                    ema_in = state["ema"] if self.ema_decay else {}
                    (state["params"], state["opt_state"], ema_out,
                     metrics_k) = self._train_step_k(
                        state["params"], state["opt_state"], ema_in,
                        src_ri, state["step"], nan_retries, rng)
                    if self.ema_decay:
                        state["ema"] = ema_out
                    st = timer.stop() / k_call
                    # keep the [K]-vector metric arrays whole on device —
                    # indexing them here would dispatch K tiny gathers per
                    # metric; flush_pending fetches and splits host-side
                    pending.append((state["step"], metrics_k, st, k_call))
                    pending_steps += k_call
                    state["step"] += k_call
                    n_batches += k_call
                    sys.stdout.write(":" * k_call)
                else:
                    # nan_retries folds in so a rolled-back epoch re-runs
                    # with fresh dropout keys (the restored step alone
                    # would replay the identical computation)
                    step_rng = jax.random.fold_in(
                        jax.random.fold_in(rng, state["step"]), nan_retries)
                    state["params"], state["opt_state"], metrics = \
                        self._train_step(
                            state["params"], state["opt_state"], src_ri,
                            step_rng)
                    if self.ema_decay:
                        state["ema"] = self._ema_step(
                            state["ema"], state["params"])
                    pending.append((state["step"], metrics, timer.stop(), 1))
                    pending_steps += 1
                    state["step"] += 1
                    n_batches += 1
                    sys.stdout.write(":")
                self._heartbeat = time.monotonic()
                if pending_steps >= metrics_every:
                    flush_pending()
                if profiling and state["step"] >= profile_at + profile_steps:
                    jax.profiler.stop_trace()
                    profiling = False
                sys.stdout.flush()
                if self._preempt:
                    break
            flush_pending()
            if self._preempt:
                path = os.path.join(self.save_dir,
                                    "%s_preempt" % self.name)
                self.save_params(state, path)
                sys.stdout.write(
                    "\n[preempted: saved %s at step %d (epoch %d "
                    "incomplete); resume with -i to continue]\n"
                    % (path, state["step"], epoch + 1))
                sys.stdout.flush()
                return state
            if n_batches == 0:
                raise RuntimeError(
                    "dataset yielded no training batches for batch size %d"
                    % (hp.BATCH_SIZE * hp.MAX_N_SIGNAL))
            _dict_mul(cli_report, 1.0 / n_batches)

            # LR decay policy (reference main.py:439-459)
            if hp.LR_DECAY_TYPE == "adaptive":
                if cli_report["loss"] < best_loss:
                    best_loss = cli_report["loss"]
                    best_loss_time = 0
                else:
                    best_loss_time += 1
            elif hp.LR_DECAY_TYPE == "fixed":
                best_loss_time += 1
            elif hp.LR_DECAY_TYPE == "cosine":
                # cosine anneal over THIS invocation's epochs, from the
                # entry LR down to LR * LR_DECAY (not in the reference;
                # the production-standard schedule for fixed-length runs)
                import math
                frac = (epoch - epoch0 + 1) / max(n_epoch, 1)
                floor_lr = base_lr * hp.LR_DECAY
                new_lr = floor_lr + 0.5 * (base_lr - floor_lr) * (
                    1.0 + math.cos(math.pi * min(frac, 1.0)))
                self.set_learn_rate(state, new_lr)
            elif hp.LR_DECAY_TYPE is None:
                pass
            else:
                raise ValueError(
                    'Unknown LR_DECAY_TYPE "%s"' % hp.LR_DECAY_TYPE)
            if best_loss_time == hp.NUM_EPOCH_PER_LR_DECAY:
                best_loss_time = 0
                old_lr = self.get_learn_rate(state)
                new_lr = old_lr * hp.LR_DECAY
                self.set_learn_rate(state, new_lr)
                sys.stdout.write("[LR %f -> %f]" % (old_lr, new_lr))
                sys.stdout.flush()

            # NaN sentinel + rollback (reference main.py:461-476).  The
            # check runs regardless of save_on_epoch so a NaN epoch can
            # never be silently written into a stage's final checkpoint;
            # rollback needs a prior epoch save, otherwise abort.
            if any(isnan(v) for v in cli_report.values()):
                # roll back whenever the previous epoch boundary's
                # checkpoint exists — including the first epoch of a
                # RESUMED stage (epoch == epoch0), whose checkpoint was
                # written by the prior stage
                rollback = self.save_path(epoch)
                if save_on_epoch and os.path.exists(rollback):
                    sys.stdout.write(
                        "\nEpoch %d/%d got NaN values, restoring last "
                        "checkpoint ... " % (epoch + 1, n_total))
                    state = self.load_params(state, rollback)
                    nan_retries += 1  # perturbs shuffle/crop/dropout seeds
                    sys.stdout.write("done\n")
                    continue  # redo this epoch from the restored state
                sys.stdout.write(
                    "\nRun into NaN during epoch %d with no checkpoint to "
                    "roll back to, exiting ...\n" % (epoch + 1))
                sys.exit(-1)
            # a transient NaN only perturbs the seeds of the epoch that
            # retried — once an epoch completes cleanly, later epochs
            # return to the canonical (retry-free) RNG streams so the rest
            # of the run stays reproducible
            nan_retries = 0
            # increment BEFORE saving so saves/<name>_e<k> embeds epoch=k
            # and resuming from it continues at epoch k (not k-1)
            epoch += 1
            state["epoch"] = epoch
            if save_on_epoch:
                self.save_params(state, self.save_path(epoch))
                sys.stdout.write("S")
            sys.stdout.write("\nEpoch %d/%d %s (%.3fs/step)\n" % (
                epoch, n_total, _dict_format(cli_report), timer.mean))
            sys.stdout.flush()

            if not valid_on_epoch:
                continue
            cli_report = self._metrics_sweep(
                state, dataset, "valid", bucket)
            writer.scalars("valid", cli_report, state["step"])
            sys.stdout.write("\nValid  %d/%d %s\n" % (
                epoch, n_total, _dict_format(cli_report)))
            sys.stdout.flush()
            # Valid-crash rollback (VALID_CRASH_FACTOR > 0; not in the
            # reference): a loss spike that recovers before NaN leaves the
            # params wrecked but finite — the NaN sentinel never fires, the
            # damaged state gets checkpointed, and every later stage resumes
            # from it (observed in production: a stage-final spike cost a
            # 68-epoch staged run ~2.7 dB SI-SNR).  If this epoch's valid
            # loss exceeds the invocation's best by the factor, restore the
            # keep-best checkpoint (or the previous epoch boundary) and
            # replay with perturbed data/dropout seeds.  best_valid_loss is
            # per-invocation, so staged objective switches never trip it.
            crash_factor = float(
                getattr(hp, "VALID_CRASH_FACTOR", 0.0) or 0.0)
            if (crash_factor > 0.0 and crash_retries < 3
                    and best_valid_loss < float("inf")
                    and cli_report.get("loss", 0.0)
                    > best_valid_loss * crash_factor):
                target = os.path.join(self.save_dir, "%s_best" % self.name)
                if not (save_best and os.path.exists(target)):
                    target = self.save_path(epoch - 1)
                if os.path.exists(target):
                    sys.stdout.write(
                        "\n[valid loss %.6g > %.2fx best %.6g: crash "
                        "rollback to %s]\n" % (
                            cli_report["loss"], crash_factor,
                            best_valid_loss, target))
                    sys.stdout.flush()
                    # the spiked epoch's checkpoint was already written
                    # above (save_on_epoch saves BEFORE the valid sweep
                    # can detect the spike) — remove it, or a preemption
                    # during the replay window would resume from the
                    # poisoned newest-epoch checkpoint, the exact
                    # failure this guard exists to prevent
                    spiked = self.save_path(epoch)
                    if (save_on_epoch and os.path.exists(spiked)
                            and os.path.abspath(spiked)
                            != os.path.abspath(target)):
                        import shutil
                        shutil.rmtree(spiked, ignore_errors=True)
                    state = self.load_params(state, target)
                    epoch = int(state.get("epoch", epoch - 1))
                    # cap is per-invocation (never reset): a divergence
                    # that recurs after every rollback must not replay the
                    # best->crash window forever.  Each retry perturbs the
                    # first replayed epoch's seeds differently.
                    crash_retries += 1
                    nan_retries = crash_retries
                    continue
                sys.stdout.write(
                    "\n[valid loss spiked but no checkpoint to roll back "
                    "to; continuing]\n")
                sys.stdout.flush()
            # keep-best checkpoint on the valid loss (not in the reference,
            # which only saves per-epoch — a late-training excursion there
            # silently degrades the last checkpoint).  best_valid_loss is
            # tracked UNconditionally: the crash-rollback trigger above
            # must work in the plain save_on_epoch workflow too (its
            # rollback target is then the previous epoch's checkpoint).
            if cli_report.get("loss", float("inf")) < best_valid_loss:
                best_valid_loss = cli_report["loss"]
                if save_best:
                    self.save_params(state, os.path.join(
                        self.save_dir, "%s_best" % self.name))
                    sys.stdout.write("B")
                    sys.stdout.flush()
        return state

    # ------------------------------------------------------------------
    def _metrics_sweep(self, state, dataset, subset: str, bucket) -> dict:
        """One metrics pass with device-side accumulation.

        Fetching each batch's scalars immediately (`float(v)` per batch)
        serializes dispatch -> transfer -> dispatch, which dominates sweep
        wall time when each fetch is a round trip.  Instead the per-batch
        metric dicts stay on device and are summed there; the sweep does exactly ONE host
        transfer at the end.  (TensorBoard gets the sweep mean rather than
        per-batch points — the per-batch curves were an artifact of the
        reference's synchronous sess.run loop, main.py:482-509.)
        """
        hp = self.hp
        acc = None
        n = 0
        for data_pt in self._epoch_fn(dataset, for_eval=True)(
                subset, hp.BATCH_SIZE * hp.MAX_N_SIGNAL, shuffle=False):
            if self._wave_mode:
                batch = prepare_batch_wave(
                    data_pt[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                    hp.FFT_SIZE, hp.FFT_STRIDE, bucket=bucket)
            else:
                batch = prepare_batch(
                    data_pt[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                    bucket=bucket)
            metrics = self._valid_step(
                self.eval_params(state), self._put_batch(
                    batch, for_eval=True))
            acc = metrics if acc is None else jax.tree_util.tree_map(
                jnp.add, acc, metrics)
            n += 1
            self._heartbeat = time.monotonic()
            sys.stdout.write(".")
            sys.stdout.flush()
        if acc is None:
            return OrderedDict()
        fetched = jax.device_get(acc)  # the sweep's single host transfer
        return OrderedDict(
            (k, float(v) / n) for k, v in sorted(fetched.items()))

    def test(self, state, dataset, subset: str = "test",
             name: str = "Test") -> dict:
        """One metrics pass over a subset (reference main.py:512-532; unlike
        the reference, reports the *average* over batches, not the sum)."""
        bucket = effective_bucket(self.hp)
        with self._hang_watchdog():
            cli_report = self._metrics_sweep(state, dataset, subset, bucket)
        sys.stdout.write("\n%s: %s\n" % (name, _dict_format(cli_report)))
        return cli_report

    # ------------------------------------------------------------------
    def separate(self, state, mix_ri: np.ndarray) -> np.ndarray:
        """Inference on a mixture batch [B, T, F, 2] -> [B, N, T, F, 2]."""
        return np.asarray(self._separate(self.eval_params(state), mix_ri))
