"""bench.py units that need no device: the record's shape, the peak table
and error propagation (bench.py imports jax lazily, and `measure` is
replaced by a fake here)."""
import json
import sys
import types

import pytest

import bench


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """bench.main() turns on the persistent compile cache; keep the
    process-wide JAX config of the test worker untouched."""
    from danet_tpu import compile_cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")


def _fake_step_handles():
    return (None, None, None, None)


def test_default_record_embeds_shipping_flagship(monkeypatch, capsys):
    """A default `python bench.py` run measures BOTH the pinned
    cross-round workload (headline metric) and configs/shipping.json's
    shipping flagship encoder, embedding the latter as
    record['shipping_flagship']."""
    calls = []

    def fake_measure(*a, **k):
        calls.append(bench.ENCODER)
        return 5000.0, _fake_step_handles()

    monkeypatch.setattr(bench, "measure", fake_measure)
    monkeypatch.setattr(bench, "mfu_stats",
                        lambda *a, **k: (25.0, 13.0))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    bench.main()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    record = json.loads(out)
    assert record["metric"] == "train_mixtures_per_sec"
    assert record["device"]["platform"] == "cpu"
    assert record["device"]["count"] >= 1
    assert "card" in record["device"]
    ship = record["shipping_flagship"]
    assert ship["encoder"] == "attn-v1"  # configs/shipping.json
    assert ship["mixtures_per_sec"] == 5000.0
    assert ship["mfu_pct_bf16_peak"] == 13.0
    # headline + full shipping program + its stage-A/B (no-aux) arm
    assert calls == ["bilstm-orig", "attn-v1", "attn-v1"]
    assert "stage_ab_program" in ship
    # the globals are restored after the flagship measurement
    assert bench.ENCODER == "bilstm-orig" and bench.MODEL == "danet"


def test_shipping_arm_measures_full_config(monkeypatch, capsys):
    """The shipping-flagship arm must measure the ACTUAL shipping
    program — configs/shipping.json's batch and step-shaping keys
    applied, non-step (wire/driver) keys recorded as not_applied."""
    seen = []

    def fake_measure(*a, **k):
        seen.append((bench.ENCODER, bench.BATCH,
                     dict(bench.CONFIG_OVERRIDES or {})))
        return 5000.0, _fake_step_handles()

    monkeypatch.setattr(bench, "measure", fake_measure)
    monkeypatch.setattr(bench, "mfu_stats", lambda *a, **k: (25.0, 13.0))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    bench.main()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ship = record["shipping_flagship"]
    # configs/shipping.json: attn-v1 at BATCH_SIZE=64 with the aux losses
    assert ship["batch"] == 64
    assert seen[1][1] == 64
    assert seen[1][2].get("ANCHOR_AUX_LOSS") == 0.5
    # wire/driver keys are measured elsewhere and say so
    assert "TRANSFER_DOMAIN" in ship["not_applied"]
    # headline arm ran at the pinned protocol
    assert seen[0][:2] == ("bilstm-orig", 32)
    assert bench.BATCH == 32 and bench.CONFIG_OVERRIDES is None


def test_arg_accepts_equals_form(monkeypatch):
    monkeypatch.setattr(
        sys, "argv", ["bench.py", "--encoder=gru-v1", "--batch", "64"])
    assert bench._arg("--encoder") == "gru-v1"
    assert bench._arg("--batch") == "64"
    assert bench._arg("--model") is None


def test_h100_peak_lookup():
    """The H100's published dense bf16 peak and HBM bandwidth (NVIDIA's
    SXM data sheet) are keyed by the device_kind JAX reports."""
    peak = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert peak == {"bf16_tflops": 989.0, "hbm_tb_per_s": 3.35}


def test_unknown_device_kind_gives_no_mfu(monkeypatch, capsys):
    """A card missing from the peak table gets TFLOP/s but no MFU, and
    says why on stderr — no peak is ever assumed."""
    import jax
    fake_dev = types.SimpleNamespace(device_kind="Imaginary Card 9000")
    monkeypatch.setattr(jax, "devices", lambda *a: [fake_dev])
    monkeypatch.setattr(bench, "step_flops", lambda *a: 2e12)
    tflops, mfu = bench.mfu_stats(None, None, None, None,
                                  mix_per_sec=bench.BATCH)
    assert tflops == 2.0 and mfu is None
    assert "Imaginary Card 9000" in capsys.readouterr().err


@pytest.mark.parametrize("arm", ["headline", "shipping"])
def test_measure_errors_propagate(monkeypatch, capsys, arm):
    """A failing measurement fails the run: no retry on another path and
    no record printed (neither for the headline nor the shipping arm)."""
    calls = []

    def fake_measure(*a, **k):
        calls.append(bench.ENCODER)
        if arm == "headline" or len(calls) > 1:
            raise RuntimeError("compile failed")
        return 5000.0, _fake_step_handles()

    monkeypatch.setattr(bench, "measure", fake_measure)
    monkeypatch.setattr(bench, "mfu_stats", lambda *a, **k: (None, None))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(RuntimeError, match="compile failed"):
        bench.main()
    assert capsys.readouterr().out == ""
    assert calls == (["bilstm-orig"] if arm == "headline"
                     else ["bilstm-orig", "attn-v1"])
    assert bench.ENCODER == "bilstm-orig" and bench.BATCH == 32
