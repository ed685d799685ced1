"""Measure TRAIN_STEPS_PER_CALL in the REAL Trainer loop (GPU).

bench.py --chain 50 measures the raw scanned-step program.  This probe
times the actual `Trainer.train`
epoch loop — prefetch thread, device transfers, metrics pipeline, EMA
off — with TRAIN_STEPS_PER_CALL of 1 vs 8 on the bench workload
(flagship bilstm-orig, B=32, N=2, T=128, bf16), so the recorded win is
the framework-level one a user gets, not a microbenchmark.

METRICS_EVERY=30 for BOTH runs (a per-step scalar fetch would
serialize dispatch and mask the effect being measured).

Run on the real chip:  python benchmarks/steps_per_call.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BATCH = int(os.environ.get("SPC_BATCH", 32))
N_SIGNAL = 2
T = int(os.environ.get("SPC_T", 128))
N_BATCHES = int(os.environ.get("SPC_BATCHES", 60))


class _FixedBatches:
    """Dataset stub: N_BATCHES pregenerated random spectra batches (and
    matching-length random waveforms for the TRANSFER_DOMAIN='wave' arm —
    throughput only, content is irrelevant here)."""

    def __init__(self, feature_size, stride):
        rng = np.random.RandomState(0)
        self._batches = [
            rng.rand(BATCH * N_SIGNAL, T, feature_size).astype(np.float32)
            for _ in range(N_BATCHES)]
        n_samples = (T - 1) * stride  # the T-frame sample grid
        self._waves = [
            rng.uniform(-1, 1, (BATCH * N_SIGNAL, n_samples))
            .astype(np.float32) for _ in range(N_BATCHES)]

    def epoch(self, subset, batch_size, shuffle=False):
        for b in self._batches:
            yield (b,)

    def epoch_wave(self, subset, batch_size, shuffle=False):
        for b in self._waves:
            yield (b,)


def _write_wsj0_fixture(path: str, n_utts: int, n_samples: int):
    """wsj0-schema HDF5 of CONSISTENT spectra (STFTs of int16-scale
    waveforms) so the ladder arms run through the REAL Wsj0Dataset —
    h5py reads, host-side exact iSTFT inversion + cache for the wave
    arm (data/wsj0.py epoch_wave), batch padding — i.e. the wire a
    reference-corpus user actually gets (VERDICT r4 item 3)."""
    import h5py
    from danet_tpu.data.audio import stft_np
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        dt = h5py.special_dtype(vlen=np.dtype("complex64"))
        feats = f.create_dataset("features", (n_utts,), dtype=dt)
        shapes = f.create_dataset("features_shapes", (n_utts, 2),
                                  dtype="int32")
        for i in range(n_utts):
            wav = rng.randint(-20000, 20000, size=(n_samples,)) \
                .astype(np.float64)
            spec = stft_np(wav).astype(np.complex64)
            feats[i] = spec.reshape(-1)
            shapes[i] = spec.shape
        split_dt = np.dtype([
            ("split", "S8"), ("source", "S16"),
            ("start", "int64"), ("stop", "int64")])
        f.attrs["split"] = np.asarray(
            [(b"train", b"features", 0, n_utts),
             (b"valid", b"features", 0, n_utts),
             (b"test", b"features", 0, n_utts)], dtype=split_dt)


def main():
    import jax
    from danet_tpu.hparams import hparams
    from danet_tpu.models import DaNet
    from danet_tpu.train.trainer import Trainer

    wsj0_mode = "--wsj0-fixture" in sys.argv
    hparams.load_json(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "default.json"))
    hparams.ENCODER_TYPE = "bilstm-orig"
    hparams.BATCH_SIZE = BATCH
    hparams.COMPUTE_DTYPE = "bfloat16"
    hparams.METRICS_EVERY = 30
    hparams.SUMMARY_DIR = "/tmp/spc_logs"
    hparams.digest()
    if wsj0_mode:
        from danet_tpu.data.wsj0 import Wsj0Dataset
        n_utts = N_BATCHES * BATCH * N_SIGNAL
        # (T-1)*stride samples -> exactly T frames, MAX_TRAIN_LEN-crop-
        # free static shapes (no recompiles between arms)
        n_samples = (T - 1) * hparams.FFT_STRIDE
        path = "/tmp/spc_wsj0_fixture_%dx%d.hdf5" % (n_utts, n_samples)
        if not os.path.exists(path):
            print("writing wsj0-schema fixture (%d utts)..." % n_utts,
                  flush=True)
            _write_wsj0_fixture(path, n_utts, n_samples)
        ds = Wsj0Dataset(path=path)
        ds.install_and_load()
        # the int16 arm quantizes at the corpus's declared int16 scale
        hparams.WAVE_PCM_SCALE = 32768.0
    else:
        ds = _FixedBatches(hparams.FEATURE_SIZE, hparams.FFT_STRIDE)

    # the framework loop moves the full batch host->device every step;
    # that transfer can dominate (and cap) everything this probe
    # measures — print the volume so the regime is explicit
    elems_step = BATCH * N_SIGNAL * T * hparams.FEATURE_SIZE * 2
    wave_elems = BATCH * N_SIGNAL * (T - 1) * hparams.FFT_STRIDE
    print("h2d transfer: %.1f MB/step f32 wire / %.1f MB/step bf16 wire / "
          "%.1f MB/step int16-wave wire "
          "(batch %d x %d srcs x T=%d x F=%d ri)"
          % (elems_step * 4 / 1e6, elems_step * 2 / 1e6,
             wave_elems * 2 / 1e6, BATCH, N_SIGNAL,
             T, hparams.FEATURE_SIZE), flush=True)
    print("%-22s %12s %12s %14s" % ("steps/call / wire", "mixtures/s",
                                    "ms/step", "eff MB/s h2d"), flush=True)
    arms = ((1, "float32", "spectra"), (8, "float32", "spectra"),
            (8, "bfloat16", "spectra"), (8, "int16", "wave"))
    for k, wire, domain in arms:
        if domain == "wave":
            bytes_step = wave_elems * 2
        else:
            bytes_step = elems_step * (2 if wire == "bfloat16" else 4)
        hparams.TRAIN_STEPS_PER_CALL = k
        hparams.TRANSFER_DTYPE = wire
        hparams.TRANSFER_DOMAIN = domain
        trainer = Trainer(DaNet(), name="spc%d%s" % (k, wire[:2]),
                          save_dir="/tmp/spc_sv")
        state = trainer.train(1, ds, save_on_epoch=False,
                              valid_on_epoch=False)  # warmup + compile
        t0 = time.perf_counter()
        n_epochs = 3
        state = trainer.train(n_epochs, ds, save_on_epoch=False,
                              valid_on_epoch=False, state=state)
        jax.block_until_ready(state["params"])
        dt = time.perf_counter() - t0
        steps = n_epochs * N_BATCHES
        print("%-22s %12.0f %12.2f %14.1f"
              % ("%d / %s%s" % (k, wire,
                                "-wave" if domain == "wave" else ""),
                 BATCH * steps / dt,
                 1e3 * dt / steps, bytes_step * steps / dt / 1e6),
              flush=True)


if __name__ == "__main__":
    main()
