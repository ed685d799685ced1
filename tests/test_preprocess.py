"""Offline preprocessing pipeline integration tests: synthetic corpora ->
process.py (subprocess, as users run it) -> dataset classes -> epochs.

Covers the reference's L-1 offline layer end-to-end
(/root/reference/app/datasets/TIMIT/process.py, WSJ0/process.py) without
the real corpora.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile

from tests.shorten_ref import make_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(script, args, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script)] + args,
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _write_timit_utt(dirpath, stem, seed, n=12000, rate=16000):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(n) * 3000).astype(np.int16)
    scipy.io.wavfile.write(os.path.join(dirpath, stem + ".wav"), rate, wav)
    with open(os.path.join(dirpath, stem.upper() + ".TXT"), "w") as f:
        f.write("0 %d she had your dark suit\n" % n)
    with open(os.path.join(dirpath, stem.upper() + ".PHN"), "w") as f:
        for i, pho in enumerate(["sh", "iy", "hh", "ae", "dcl"]):
            f.write("%d %d %s\n" % (i * 100, (i + 1) * 100, pho))


def test_timit_preprocess_to_epoch(tmp_path, fresh_hparams):
    for subset in ("train", "test"):
        d = tmp_path / subset
        d.mkdir()
        for i in range(4):
            _write_timit_utt(str(d), "si%d" % i, seed=i,
                             n=8000 + 2000 * i)
        # 'sa' sentences must be excluded (speaker-identical text)
        _write_timit_utt(str(d), "sa1", seed=99)

    out = _run_script("danet_tpu/data/TIMIT/process.py", [
        "--train-dir", str(tmp_path / "train"),
        "--test-dir", str(tmp_path / "test"),
        "--out-dir", str(tmp_path)])
    assert "train: 4 utterances" in out, out  # sa1 excluded
    assert "Finished preprocessing" in out

    from danet_tpu.data.timit import TimitDataset
    hp = fresh_hparams
    ds = TimitDataset(data_dir=str(tmp_path))
    ds.install_and_load()
    batches = list(ds.epoch("train", 2, shuffle=True))
    assert len(batches) == 2  # 4 utterances / batch 2
    spectra = batches[0][0]
    assert spectra.shape[0] == 2
    assert spectra.shape[-1] == hp.FEATURE_SIZE
    assert spectra.dtype == np.complex64
    # lengths sorted at preprocess time -> batch padding is minimal; the
    # spectra must be finite and non-degenerate
    assert np.isfinite(spectra).all() and np.abs(spectra).max() > 0
    # valid aliases test (reference timit.py:111-113)
    assert len(list(ds.epoch("valid", 2))) == 2


def test_wsj0_preprocess_to_epoch(tmp_path, fresh_hparams):
    pytest.importorskip("danet_tpu.native.sphere")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        x = (rng.randn(9000 + 1000 * i) * 2000).astype("<i2")
        p = tmp_path / ("utt%d.sph" % i)
        p.write_bytes(make_sphere(
            x.tobytes(), sample_rate=8000, coding="pcm",
            byte_format="01", sample_count=len(x)))
        paths.append(str(p))
    for name, sel in [("train", paths[:3]), ("valid", paths[3:4]),
                      ("test", paths[4:])]:
        with open(tmp_path / ("%s_set_files" % name), "w") as f:
            f.write("\n".join(sel) + "\n")

    h5 = str(tmp_path / "wsj0.h5")
    out = _run_script("danet_tpu/data/WSJ0/process.py", [
        "--list-dir", str(tmp_path), "-o", h5])
    assert "Wrote" in out

    from danet_tpu.data.wsj0 import Wsj0Dataset
    hp = fresh_hparams
    ds = Wsj0Dataset(path=h5)
    ds.install_and_load()
    got = list(ds.epoch("train", 2, shuffle=False))
    assert len(got) >= 1
    spectra = got[0][0]
    assert spectra.shape[0] == 2
    assert spectra.shape[-1] == hp.FEATURE_SIZE
    assert np.isfinite(spectra).all() and np.abs(spectra).max() > 0


def test_wsj0_fuel_layout_roundtrip(tmp_path, fresh_hparams):
    """--fuel-layout writes the REFERENCE stack's fuel-H5PYDataset schema
    (per-subset '{name}_spectra' + dim scales + 7-field split attr,
    reference WSJ0/process.py:148-222) — and our loader's fuel-reading
    path consumes it, proving bidirectional interop."""
    import h5py
    pytest.importorskip("danet_tpu.native.sphere")
    rng = np.random.RandomState(1)
    paths = []
    for i in range(4):
        x = (rng.randn(9000 + 500 * i) * 2000).astype("<i2")
        p = tmp_path / ("f%d.sph" % i)
        p.write_bytes(make_sphere(
            x.tobytes(), sample_rate=8000, coding="pcm",
            byte_format="01", sample_count=len(x)))
        paths.append(str(p))
    for name, sel in [("train", paths[:2]), ("valid", paths[2:3]),
                      ("test", paths[3:])]:
        with open(tmp_path / ("%s_set_files" % name), "w") as f:
            f.write("\n".join(sel) + "\n")

    h5 = str(tmp_path / "wsj0_fuel.h5")
    out = _run_script("danet_tpu/data/WSJ0/process.py", [
        "--list-dir", str(tmp_path), "-o", h5, "--fuel-layout"])
    assert "fuel layout" in out

    # schema checks: the exact structures the reference's loader needs
    with h5py.File(h5, "r") as f:
        for s in ("train", "valid", "test"):
            assert "%s_spectra" % s in f
            assert "%s_spectra_shapes" % s in f
            assert list(f["%s_spectra_shape_labels" % s][...]) == [
                b"length", b"fft_size"]
        split = f.attrs["split"]
        assert set(split.dtype.names) >= {
            "split", "source", "start", "stop", "available"}
        assert [r["split"] for r in split] == [b"train", b"valid", b"test"]

    from danet_tpu.data.wsj0 import Wsj0Dataset
    hp = fresh_hparams
    ds = Wsj0Dataset(path=h5)
    ds.install_and_load()
    got = list(ds.epoch("train", 2, shuffle=False))
    assert len(got) >= 1
    spectra = got[0][0]
    assert spectra.shape[-1] == hp.FEATURE_SIZE
    assert np.isfinite(spectra).all() and np.abs(spectra).max() > 0
