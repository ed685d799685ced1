"""Benchmark harness: flagship train-step throughput in mixtures/sec/chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.  The record names the device it ran on (platform, device_kind, count
and the card's power limit); the program runs on whatever backend JAX
picks and never falls back to another.

Workload: full jitted training step (fwd+bwd+Adam update) of the flagship
bilstm-orig DaNet under the reference default hyperparameters
(/root/reference/default.json: BATCH_SIZE=32, MAX_N_SIGNAL=2,
MAX_TRAIN_LEN=128, FFT_SIZE=256 -> F=129) — i.e. the per-step work of
`python main.py -m train` with the paper encoder.

Dispatch shape: configs/shipping.json sets TRAIN_STEPS_PER_CALL, so the
production Trainer dispatches one scanned k-step program per host call
and the bench times the identical scanned program (the JSON records
"steps_per_call").  Timing ends in ``jax.block_until_ready``.

Dev switches: `--encoder KEY` benches another encoder family,
`--model tasnet-v1` benches the waveform-domain Conv-TasNet family,
`--batch N` probes batch scaling of the latency-bound recurrent step,
`--sweep` prints a per-family table (throughput + TFLOP/s + MFU).  The
default stays ONE JSON line.

MFU: XLA's cost_analysis FLOPs for one step over the card's published
bf16 peak (PEAKS, keyed by device_kind).  A card missing from PEAKS gets
no MFU and a line on stderr saying why.

Baseline: the reference publishes NO numbers (BASELINE.md); the stand-in
baseline is this same workload measured on a CPU backend (run
`python bench.py --cpu-baseline` to re-measure; the committed constant
below is from that measurement).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SHIPPING_CONFIG = os.path.join(REPO, "configs", "shipping.json")

# measured via `python bench.py --cpu-baseline` on a CPU backend (see
# module docstring) — mixtures/sec for the identical train step.
CPU_BASELINE_MIX_PER_SEC = 5.42

BATCH = 32
N_SIGNAL = 2
T = 128
ENCODER = "bilstm-orig"  # flagship default; --encoder overrides (dev use)
MODEL = "danet"  # MODEL_TYPE; --model tasnet-v1 benches the TasNet family

# extra hparams applied on top of the pinned defaults (the shipping-
# flagship arm loads configs/shipping.json here so the measured program
# IS the shipping one)
CONFIG_OVERRIDES = None
# config keys that do not shape the compiled train step (wire/driver/
# eval concerns measured elsewhere: benchmarks/steps_per_call.py for the
# wire, the Trainer loop for the rest) — recorded as not_applied so the
# artifact says exactly what the shipping measurement covers
_NON_STEP_KEYS = (
    "DATASET_TYPE", "TRANSFER_DOMAIN", "TRANSFER_DTYPE", "WAVE_PCM_SCALE",
    "SUMMARY_TITLE", "METRICS_EVERY", "WATCHDOG_SECS", "EVAL_SI_SNR",
    "EVAL_SDR", "LR_DECAY_TYPE", "TRAIN_STEPS_PER_CALL")

# Published dense peaks per card, keyed by jax device_kind (NVIDIA H100
# data sheet, SXM part, at its 700 W power limit).  A card that is not
# listed gets no MFU; no peak is ever assumed.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_tb_per_s": 3.35},
}


def peak_for(kind: str):
    """The PEAKS entry for a device_kind, or None (said on stderr)."""
    peak = PEAKS.get(kind)
    if peak is None:
        sys.stderr.write("[bench] no published peak for device_kind %r: "
                         "MFU not reported\n" % (kind,))
    return peak


def card_name_and_power_limit():
    """`name, power.limit` of the first card as nvidia-smi reports them,
    or None on a host without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except FileNotFoundError:
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_record() -> dict:
    """What the numbers were measured on."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card_name_and_power_limit()}


def build_step():
    import jax
    import optax
    from danet_tpu.hparams import hparams
    import danet_tpu  # noqa: F401
    from danet_tpu import optim as optim_lib

    hparams.load_json(os.path.join(REPO, "default.json"))
    hparams.MODEL_TYPE = MODEL
    hparams.ENCODER_TYPE = ENCODER
    hparams.BATCH_SIZE = BATCH
    # the shipping training precision: bf16 compute, f32 master params
    hparams.COMPUTE_DTYPE = "bfloat16"
    if CONFIG_OVERRIDES:
        for k, v in CONFIG_OVERRIDES.items():
            if k not in _NON_STEP_KEYS:
                setattr(hparams, k, v)
        # globals still pin the workload identity (mixtures/s math)
        hparams.MODEL_TYPE = MODEL
        hparams.BATCH_SIZE = BATCH
    hparams.digest()

    model = hparams.get_model()()
    optimizer = optim_lib.make_optimizer(hparams)
    params = model.init(jax.random.PRNGKey(0))
    opt_state = jax.jit(optimizer.init)(params)
    src = jax.device_put(np.random.RandomState(0).randn(
        BATCH, N_SIGNAL, T, hparams.FEATURE_SIZE, 2).astype(np.float32))

    @jax.jit
    def train_step(params, opt_state, src_ri):
        (loss, aux), grads = jax.value_and_grad(
            model.train_loss, has_aux=True)(params, src_ri, None)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, params, opt_state, src


def step_flops(step, *args):
    """XLA's own FLOP count for one compiled step, or None (said on
    stderr) when the backend's cost model reports none."""
    ca = step.lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops = (ca or {}).get("flops")
    if not flops:
        sys.stderr.write("[bench] cost_analysis reports no FLOPs: "
                         "TFLOP/s and MFU not reported\n")
        return None
    return float(flops)


def mfu_stats(step, params, opt_state, src, mix_per_sec: float):
    """Achieved TFLOP/s and model FLOPs utilization vs the card's bf16
    peak.  Returns (tflops, mfu_pct); either may be None."""
    import jax
    flops = step_flops(step, params, opt_state, src)
    if not flops:
        return None, None
    tflops = flops * (mix_per_sec / BATCH) / 1e12
    peak = peak_for(jax.devices()[0].device_kind)
    return (round(tflops, 2),
            round(100.0 * tflops / peak["bf16_tflops"], 1) if peak else None)


def build_chained(n: int):
    """One compiled program running `n` train steps back-to-back
    (lax.scan over the step, same batch) — the shipping dispatch shape:
    configs/shipping.json sets TRAIN_STEPS_PER_CALL, so the production
    Trainer loop runs the same scanned multi-step program per call
    (train/trainer.py::_build_steps)."""
    import jax
    step, params, opt_state, src = build_step()

    @jax.jit
    def chained(params, opt_state, src_ri):
        def body(carry, _):
            p, o = carry
            p, o, loss = step(p, o, src_ri)
            return (p, o), loss
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=n)
        return params, opt_state, losses[-1]

    return chained, (step, params, opt_state, src)


def _check_finite(loss):
    if not np.isfinite(float(loss)):
        raise FloatingPointError("bench step produced loss %r" % (loss,))


def shipping_steps_per_call() -> int:
    """TRAIN_STEPS_PER_CALL from the shipping config: the production
    Trainer dispatches one scanned k-step program per host call
    (train/trainer.py::_build_steps), so the pinned bench workload
    dispatches the same shape."""
    with open(SHIPPING_CONFIG) as f:
        return max(1, int(json.load(f).get("TRAIN_STEPS_PER_CALL", 1)))


def measure(n_warmup: int = 3, n_iters: int = 50, steps_per_call=None):
    """(mixtures/sec, (step, params, opt_state, src)) for the configured
    workload; the handles are the single step, for cost analysis."""
    import jax
    k = shipping_steps_per_call() if steps_per_call is None \
        else max(1, int(steps_per_call))
    if k > 1:
        prog, (step, params, opt_state, src) = build_chained(k)
    else:
        step, params, opt_state, src = build_step()
        prog = step
    handles = (step, params, opt_state, src)
    for _ in range(n_warmup):
        params, opt_state, loss = prog(params, opt_state, src)
    _check_finite(loss)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        params, opt_state, loss = prog(params, opt_state, src)
    jax.block_until_ready((params, opt_state, loss))
    dt = time.perf_counter() - t0
    _check_finite(loss)
    return BATCH * n_iters * k / dt, handles


def sweep():
    """Per-family perf table: throughput, step time, TFLOP/s and MFU for
    every model family.  Families run sequentially in one process —
    build_step reloads default.json each time, so the hparams singleton
    resets per row."""
    global ENCODER, MODEL
    fams = [("danet", "bilstm-orig"), ("danet", "lstm-orig"),
            ("danet", "conv-bilstm-v1"), ("danet", "gru-v1"),
            ("danet", "attn-v1"), ("danet", "moe-v1"),
            ("danet", "tcn-v1"), ("danet", "dprnn-v1"),
            ("tasnet-v1", "bilstm-orig")]
    print("%-22s %12s %9s %10s %7s" % (
        "family", "mixtures/s", "ms/step", "TFLOP/s", "MFU%"), flush=True)
    saved = (MODEL, ENCODER)  # --sweep combined with other flags, or
    # importing bench as a module, must not leave the last family behind
    try:
        for model, enc in fams:
            MODEL, ENCODER = model, enc
            mps, handles = measure()
            tflops, mfu = mfu_stats(*handles, mix_per_sec=mps)
            name = model if model != "danet" else enc
            print("%-22s %12.0f %9.2f %10s %7s" % (
                name, mps, 1e3 * BATCH / mps,
                "-" if tflops is None else "%.1f" % tflops,
                "-" if mfu is None else "%.1f" % mfu), flush=True)
    finally:
        MODEL, ENCODER = saved


def _arg(name: str):
    """CLI value for --name, accepting both '--name v' and '--name=v'."""
    for i, a in enumerate(sys.argv):
        if a == name:
            return sys.argv[i + 1]
        if a.startswith(name + "="):
            return a[len(name) + 1:]
    return None


def _arm_record(mps: float, handles) -> dict:
    rec = {"mixtures_per_sec": round(mps, 2),
           "ms_per_step": round(1e3 * BATCH / mps, 3)}
    tflops, mfu = mfu_stats(*handles, mix_per_sec=mps)
    if tflops is not None:
        rec["tflops_per_sec"] = tflops
        if mfu is not None:
            rec["mfu_pct_bf16_peak"] = mfu
    return rec


def main():
    global ENCODER, MODEL, BATCH, CONFIG_OVERRIDES, T
    if _arg("--encoder") is not None:
        ENCODER = _arg("--encoder")
    if _arg("--model") is not None:
        MODEL = _arg("--model")
    if _arg("--batch") is not None:
        # batch-scaling probe: the B=32 recurrent step is latency-bound
        BATCH = int(_arg("--batch"))
    if _arg("--seqlen") is not None:
        # sequence-length probe: more frames per dispatch
        T = int(_arg("--seqlen"))
    for kv in (a for i, a in enumerate(sys.argv)
               if i and sys.argv[i - 1] == "--set"):
        # generic hparam override for perf probes, e.g.
        # --set ATTN_CAUSAL=true (strings bare, numbers parsed)
        k, _, v = kv.partition("=")
        try:
            v = json.loads(v)
        except ValueError:
            pass
        CONFIG_OVERRIDES = dict(CONFIG_OVERRIDES or {}, **{k: v})
    if "--cpu-baseline" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
        mps, _ = measure(n_warmup=1, n_iters=3, steps_per_call=1)
        print("CPU baseline: %.2f mixtures/sec" % mps)
        return
    from danet_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    if _arg("--chain") is not None:
        # dispatch-free throughput probe: N steps per dispatch
        n_chain = int(_arg("--chain"))
        mps, _ = measure(2, 10, steps_per_call=n_chain)
        print("chained x%d on %s: %.0f mixtures/sec (%.3f ms/step)"
              % (n_chain, device_record()["device_kind"], mps,
                 1e3 * BATCH / mps))
        return
    if "--sweep" in sys.argv:
        sweep()
        return
    mps, handles = measure()
    record = {
        "metric": "train_mixtures_per_sec",
        "value": round(mps, 2),
        "unit": "mixtures/sec/chip",
        "vs_baseline": round(mps / CPU_BASELINE_MIX_PER_SEC, 2),
        "steps_per_call": shipping_steps_per_call(),
        "device": device_record(),
    }
    record.update({k: v for k, v in _arm_record(mps, handles).items()
                   if k not in ("mixtures_per_sec",)})
    # The headline metric stays pinned to the bilstm-orig workload; the
    # SHIPPING flagship is the FULL configs/shipping.json program (attn-v1
    # at the config's own BATCH_SIZE + aux losses), so a default run also
    # measures it and embeds the result in the same record.
    if not any(_arg(f) is not None for f in (
            "--encoder", "--model", "--batch", "--seqlen", "--set")):
        saved = (MODEL, ENCODER, BATCH, CONFIG_OVERRIDES)
        try:
            with open(SHIPPING_CONFIG) as f:
                cfg = json.load(f)
            MODEL = "danet"
            ENCODER = cfg.get("ENCODER_TYPE", ENCODER)
            BATCH = int(cfg.get("BATCH_SIZE", BATCH))
            CONFIG_OVERRIDES = cfg
            ship = dict({"encoder": ENCODER, "batch": BATCH,
                         "not_applied": sorted(
                             k for k in cfg if k in _NON_STEP_KEYS)},
                        **_arm_record(*measure()))
            record["shipping_flagship"] = ship
            # the quality recipes' stage-A/B program (no aux loss yet)
            # is equally shipped semantics — embed it alongside
            if float(cfg.get("ANCHOR_AUX_LOSS", 0) or 0) > 0:
                CONFIG_OVERRIDES = dict(cfg, ANCHOR_AUX_LOSS=0)
                ship["stage_ab_program"] = _arm_record(*measure())
        finally:
            MODEL, ENCODER, BATCH, CONFIG_OVERRIDES = saved
    print(json.dumps(record))


if __name__ == "__main__":
    main()
