"""WSJ0 dataset: HDF5-backed variable-length STFT spectra.

Reads the ``wsj0-danet.hdf5`` file produced by danet_tpu/data/WSJ0/process.py
(fuel-compatible layout: a ``features`` dataset of flattened variable-length
complex spectra plus per-example shapes and a ``split`` attribute — same
schema as the reference, /root/reference/app/datasets/WSJ0/process.py:148-222)
— but accessed with plain h5py instead of the fuel dependency
(reference wsj0.py:1-57).  Epoch semantics match: index list padded modulo
dataset size so every batch is full, optional shuffle, per-batch zero-pad to
the batch max length with random left/right split.
"""
from __future__ import annotations

import os

import numpy as np

from danet_tpu.data.audio import random_zeropad
from danet_tpu.data.dataset import Dataset
from danet_tpu.hparams import hparams


@hparams.register_dataset("wsj0")
class Wsj0Dataset(Dataset):
    def __init__(self, path: str | None = None):
        super().__init__()
        # WSJ0_PATH config key: same CLI-reachable override as TIMIT_DIR
        self.path = path \
            or getattr(hparams, "WSJ0_PATH", "") \
            or os.path.join(
                os.path.dirname(__file__), "WSJ0", "wsj0-danet.hdf5")

    def __del__(self):
        if getattr(self, "is_loaded", False):
            try:
                self.h5file.close()
            except Exception:
                pass  # interpreter teardown: h5py internals may be gone

    def install_and_load(self):
        try:
            import h5py  # only this dataset needs it: imported on use
        except ImportError as e:
            raise RuntimeError("h5py is required for the WSJ0 dataset") from e
        if not os.path.exists(self.path):
            raise IOError(
                'Did not find WSJ0 file "%s", run data/WSJ0/install.sh first'
                % self.path)
        self.h5file = h5py.File(self.path, "r")
        # split table rows: (split, source, start, stop).  Two layouts are
        # supported: ours (single 'features' source) and the reference's
        # fuel-style one ('{split}_spectra' source per subset,
        # reference WSJ0/process.py:148-222).
        self.splits = {}
        for row in self.h5file.attrs["split"]:
            name = row["split"] if isinstance(row["split"], str) \
                else row["split"].decode()
            source = row["source"] if isinstance(row["source"], str) \
                else row["source"].decode()
            self.splits.setdefault(
                name, (source, int(row["start"]), int(row["stop"])))
        self.is_loaded = True

    def _fetch(self, subset: str, rows: np.ndarray):
        source, start, _ = self.splits[subset]
        feats = self.h5file[source]
        shapes = self.h5file[source + "_shapes"] \
            if source + "_shapes" in self.h5file \
            else self.h5file["features_shapes"]
        out = []
        # preserve the REQUESTED order: a sorted fetch would undo the
        # epoch shuffle, and since the HDF5 rows are written per-speaker
        # contiguously, consecutive (= mixed-together) utterances would
        # preferentially come from the same speaker
        for r in rows:
            t, f = shapes[start + r]
            out.append(feats[start + r].reshape(t, f))
        return out

    def _epoch_rows(self, subset, batch_size, shuffle):
        _, start, stop = self.splits[subset]
        size = stop - start
        n_pad = ((size + batch_size - 1) // batch_size) * batch_size
        indices = np.arange(n_pad) % size  # wrap so every batch is full
        if shuffle:
            np.random.shuffle(indices)
        for i in range(0, n_pad, batch_size):
            yield indices[i:i + batch_size]

    def epoch(self, subset, batch_size, shuffle=False):
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        for batch_rows in self._epoch_rows(subset, batch_size, shuffle):
            spectra_li = self._fetch(subset, batch_rows)
            max_len = max(len(x) for x in spectra_li)
            spectra = np.stack([
                random_zeropad(x, max_len - len(x), axis=-2)
                for x in spectra_li])
            yield (spectra,)

    # the stored spectra are STFTs of raw 16-bit PCM samples (the
    # preprocessing STFTs sph2pipe/sphere-decoder output verbatim,
    # reference WSJ0/process.py:175-179), so the inverted waveforms come
    # back at int16 scale — the int16 wave wire's WAVE_PCM_SCALE=32768
    # contract (trainer-enforced) is bit-exact for this corpus
    WAVE_SCALE = 32768.0

    def epoch_wave(self, subset, batch_size, shuffle=False):
        """Waveform epochs for TRANSFER_DOMAIN='wave': [batch, S] float32.

        The HDF5 artifacts stay spectra; each utterance's stored STFT is
        inverted host-side once (exact, audio.spectra_to_wave) and cached
        (Dataset._wave_from_spectra), so the wire moves raw samples — 8x
        fewer bytes than the f32 spectra contract the reference feeds
        every step (main.py:427-431) — and the on-device GEMM STFT
        reproduces the stored spectra to float precision."""
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        for batch_rows in self._epoch_rows(subset, batch_size, shuffle):
            spectra_li = self._fetch(subset, batch_rows)
            waves = [
                self._wave_from_spectra((subset, int(r)), x)
                for r, x in zip(batch_rows, spectra_li)]
            max_len = max(len(w) for w in waves)
            batch = np.stack([
                random_zeropad(w, max_len - len(w), axis=-1)
                for w in waves])
            yield (batch,)
