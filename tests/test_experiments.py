"""Experiment-driver journey: the staged-recipe surface all PARITY.md
quality evidence rests on, driven as real subprocesses on a tiny synth
corpus — `experiments/synth_extended.py` (train stage -> resumed stage)
then `experiments/eval_checkpoint.py` (estimator sweep) on the produced
checkpoint.  Mirrors the recipe scripts' structure
(experiments/synth_speech*.sh) the way test_dressrehearsal mirrors the
reference README journey.
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, args, cwd, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "experiments", script)] + args,
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(cwd))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_synth_extended_then_eval_checkpoint(tmp_path, fresh_hparams):
    save = str(tmp_path / "run")
    common = ["--save-dir", save, "--batches", "2", "--epochs", "1",
              "--dataset", "synth-speech", "--encoder", "toy",
              "--eval-si-snr", "--set", "TRAIN_STEPS_PER_CALL=2"]
    out = _run("synth_extended.py", common + ["--lr", "1e-3"], tmp_path)
    assert "Epoch 1/1" in out and "saved at step" in out

    # stage B resumes from the stage-A checkpoint (the staged recipes'
    # contract: every later stage starts from `latest`)
    out = _run("synth_extended.py",
               common + ["--lr", "3e-4", "--resume"], tmp_path)
    assert re.search(r"resumed from step [1-9]", out), out

    out = _run("eval_checkpoint.py",
               ["--ckpt", os.path.join(save, "latest"),
                "--dataset", "synth-speech", "--batches", "1",
                "--encoder", "toy", "--no-sdr"], tmp_path)
    # the estimator sweep reports both inference paths with the metric
    # set the PARITY tables quote
    assert "eval[anchor]" in out and "eval[kmeans]" in out
    for line in out.splitlines():
        if line.startswith(("anchor", "kmeans")):
            assert "SI_SNR=" in line and "SNR=" in line, line
