"""chip_smoke.py logic that needs no card: its last line, its refusal to
run without a GPU, and which phases each mode runs."""
import json
import os
import shutil
import subprocess
import sys

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_result_line_is_exactly_ok_and_device():
    line = chip_smoke.result_line({
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "extra": "dropped"})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_refuses_host_without_gpu_and_lone_copy(tmp_path):
    """On a CPU-only host the script exits nonzero and prints no result;
    so does a copy of the script with nothing of the repo beside it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_four_cards_runs_only_its_phase():
    assert chip_smoke.plan(four_cards=True) == ("four-cards",)
    default = chip_smoke.plan(four_cards=False)
    assert default == ("train", "shipping", "serve", "compare", "bench")
    assert "four-cards" not in default
    assert set(default) | {"four-cards"} == set(chip_smoke.PHASES)
