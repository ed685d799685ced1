"""Smoke run of the main paths on one NVIDIA GPU (or four, with an option).

    python chip_smoke.py               # phases train, shipping, serve,
                                       # compare, bench on one card
    python chip_smoke.py --four-cards  # only the data-parallel phase:
                                       # 4 cards against 1 card

Each phase runs the system through the entry points a user calls
(`main.py`, `python -m danet_tpu.serve`, `bench.py`) or, where a check
needs the arrays, through a child process of this script
(`--phase NAME`).  This process never opens a card: every child sees
exactly the cards it needs through CUDA_VISIBLE_DEVICES, and one child
runs at a time, because a JAX process reserves most of a card's memory.
Child output goes to chiprun_out/chip_smoke/<step>.log; the lines
starting with "smoke:" are echoed here.  Any failed check exits nonzero
and prints no result.  The last line of a passing run is
{"ok": true, "device": {"platform", "kind", "count"}} as JAX reports the
device.

Widths are the reference defaults (default.json: 4x BiLSTM 300/dir,
EMBED 20, F=129, B=32, T=128), weights are random from a seed, and the
data is the seeded synth-speech corpus, so nothing is downloaded.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
LOGS = os.path.join(REPO, "chiprun_out", "chip_smoke")
SMOKE_PHASES = ("train", "shipping", "serve", "compare", "bench")
FOUR_CARD_PHASES = ("four-cards",)
PHASE_TIMEOUT_S = 900
TOTAL_TIMEOUT_S = 1150  # the whole run, compilation included

# Tolerances of the compare phase, card against the CPU backend on the
# same weights and batch.  "highest": float32 everywhere, so only the
# order of summation differs (cuBLAS/cuDNN against Eigen), amplified by
# 4 BiLSTM layers x 128 recurrent steps; its gradient bound is one a
# TF32 run fails (an H100 80GB HBM3 at 700 W read 9.4e-7 here and 5.9e-4
# at the default precision).  "default": float32 matmuls may run in TF32
# on the card (10 mantissa bits, ~5e-4 relative rounding per product)
# while the CPU keeps float32; the gradient bound leaves about ten times
# the rounding seen there.
TOL = {
    "highest": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4},
    "default": {"loss_rel": 1e-3, "grad_rel_l2": 5e-3},
    # GEMM-DFT STFT/iSTFT against scipy / the host overlap-add, error
    # over the reference's peak: float32 rounding of a 256-term sum
    # (2.4e-7 and 3.5e-6 on the CPU backend); the iSTFT's window-square
    # normalization amplifies it near the signal's ends
    "stft_highest": 1e-5,
    "istft_highest": 2e-5,
}
# --four-cards: the same 10 steps on 4 cards (global batch 128 split 4
# ways, gradient all-reduce) and on 1 card.  Step 0 differs only in the
# forward's summation order and GEMM shapes; later steps add Adam
# updates of slightly different gradients.
DP_STEPS = 10
DP_TOL = {"first_rel": 1e-3, "all_rel": 2e-2}


def result_line(device: dict) -> str:
    """The contract's last line: exactly ok and the device."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def plan(four_cards: bool) -> tuple:
    return FOUR_CARD_PHASES if four_cards else SMOKE_PHASES


class SmokeError(RuntimeError):
    pass


def say(msg: str) -> None:
    print("smoke: " + msg, flush=True)


# ---------------------------------------------------------------------------
# parent side: processes, logs and checks that need no device
# ---------------------------------------------------------------------------

def _env(cards: str) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards,
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    return env


_DEADLINE = [time.monotonic() + TOTAL_TIMEOUT_S]


def run(step: str, cmd: list, cards: str = "0", cwd: str = WORK,
        timeout: float = PHASE_TIMEOUT_S) -> str:
    """Run one child to its end, its output in LOGS/<step>.log; echo its
    "smoke:" lines; raise SmokeError on a nonzero exit or a timeout (its
    own, or the end of the whole run's time).  The child gets its own
    process group, which is killed on timeout."""
    os.makedirs(LOGS, exist_ok=True)
    log_path = os.path.join(LOGS, step + ".log")
    t0 = time.monotonic()
    timeout = min(timeout, _DEADLINE[0] - t0)
    if timeout <= 0:
        raise SmokeError("%s: no time left in the run" % step)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=cwd, env=_env(cards), stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout after %.0f s" % timeout
    with open(log_path) as f:
        out = f.read()
    for line in out.splitlines():
        if line.startswith("smoke: "):
            print(line, flush=True)
    if rc != 0:
        sys.stderr.write("---- last lines of %s ----\n%s\n" % (
            log_path, "\n".join(out.splitlines()[-60:])))
        raise SmokeError("%s: %s exited %s" % (step, cmd[1:3], rc))
    say("%s done in %.1f s" % (step, time.monotonic() - t0))
    return out


def _self(phase: str, *extra) -> list:
    return [sys.executable, os.path.abspath(__file__), "--phase", phase,
            *extra]


def _main_py(*args) -> list:
    return [sys.executable, os.path.join(REPO, "main.py"), *args]


def probe_device(cards: str) -> dict:
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind,"
            " 'count': len(d)}))")
    out = run("probe", [sys.executable, "-c", code], cards=cards, cwd=REPO,
              timeout=300)
    return json.loads(out.strip().splitlines()[-1])


def require_gpu(device: dict, count: int) -> None:
    if device["platform"] != "gpu":
        raise SmokeError("JAX found no GPU (platform %r): nothing to smoke"
                         % (device["platform"],))
    if device["count"] != count:
        raise SmokeError("expected %d visible card(s), JAX sees %d"
                         % (count, device["count"]))


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _write_json(name: str, obj: dict) -> str:
    path = os.path.join(WORK, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def _train_losses(summary_dir: str) -> list:
    """(step, train loss) records of one run, from its metrics.jsonl."""
    paths = glob.glob(os.path.join(summary_dir, "*", "metrics.jsonl"))
    if len(paths) != 1:
        raise SmokeError("expected one metrics.jsonl under %s, found %r"
                         % (summary_dir, paths))
    rows = []
    with open(paths[0]) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec:
                rows.append((rec["step"], rec["train/loss"]))
    return rows


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


TRAIN_CFG = {"ENCODER_TYPE": "bilstm-orig", "DATASET_TYPE": "synth-speech",
             "SYNTH_BATCHES": 24}
TRAIN_EPOCHS = 2


def phase_train() -> None:
    import numpy as np
    cfg = _write_json("train.json", dict(
        TRAIN_CFG, SUMMARY_DIR=os.path.join(WORK, "logs_train")))
    run("train", _main_py("-m", "train", "-ds", "synth-speech", "-c", cfg,
                          "-n", "smoke", "-ne", str(TRAIN_EPOCHS)))
    rows = _train_losses(os.path.join(WORK, "logs_train"))
    losses = np.array([v for _, v in rows])
    n_steps = TRAIN_EPOCHS * TRAIN_CFG["SYNTH_BATCHES"]
    _check(len(losses) == n_steps, "train: %d losses logged, expected %d"
           % (len(losses), n_steps))
    _check(bool(np.isfinite(losses).all()), "train: non-finite loss")
    # the synth corpus repeats the same batches every epoch, so the two
    # epochs' mean losses compare like with like
    first, last = losses[:n_steps // 2].mean(), losses[n_steps // 2:].mean()
    say("train bilstm-orig: %d steps, mean loss epoch 1 %.6g -> epoch 2 "
        "%.6g" % (len(losses), first, last))
    _check(last < first, "train: loss did not decrease")
    ckpt = os.path.join(WORK, "saves", "smoke_e%d" % TRAIN_EPOCHS)
    _check(os.path.isdir(ckpt), "train: no checkpoint at %s" % ckpt)

    cfg = _write_json("resume.json", dict(
        TRAIN_CFG, SUMMARY_DIR=os.path.join(WORK, "logs_resume")))
    run("train-resume", _main_py(
        "-m", "train", "-ds", "synth-speech", "-c", cfg, "-n", "smoke",
        "-i", ckpt, "-ne", "1"))
    last_step = rows[-1][0]
    rows = _train_losses(os.path.join(WORK, "logs_resume"))
    steps = [s for s, _ in rows]
    resumed = np.array([v for _, v in rows])
    _check(steps[0] == last_step + 1, "resume: first step %d after %d"
           % (steps[0], last_step))
    _check(bool(np.isfinite(resumed).all()), "resume: non-finite loss")
    _check(os.path.isdir(os.path.join(
        WORK, "saves", "smoke_e%d" % (TRAIN_EPOCHS + 1))),
        "resume: no epoch checkpoint")
    say("train resume from %s: steps %d..%d, loss %.6g -> %.6g"
        % (os.path.basename(ckpt), steps[0], steps[-1], resumed[0],
           resumed[-1]))


def phase_shipping() -> None:
    import numpy as np
    with open(os.path.join(REPO, "configs", "shipping.json")) as f:
        cfg = json.load(f)
    # wsj0 needs a corpus on disk; synth-speech rides the same int16
    # wave wire, quantized at its own declared scale
    cfg.update(DATASET_TYPE="synth-speech", WAVE_PCM_SCALE=4.0,
               SYNTH_BATCHES=3 * int(cfg["TRAIN_STEPS_PER_CALL"]),
               SUMMARY_DIR=os.path.join(WORK, "logs_shipping"))
    path = _write_json("shipping.json", cfg)
    run("shipping", _main_py("-m", "train", "-c", path, "-n", "shipping",
                             "-ne", "1", "--no-save-on-epoch"))
    losses = np.array([v for _, v in _train_losses(cfg["SUMMARY_DIR"])])
    _check(len(losses) == cfg["SYNTH_BATCHES"],
           "shipping: %d losses logged" % len(losses))
    _check(bool(np.isfinite(losses).all()), "shipping: non-finite loss")
    say("shipping attn-v1 B=%d k=%d int16 wave wire: %d steps, loss %.6g "
        "-> %.6g" % (cfg["BATCH_SIZE"], cfg["TRAIN_STEPS_PER_CALL"],
                     len(losses), losses[0], losses[-1]))


SMPRATE = 8000
WAV_SECONDS = 10


def synth_mixture(seed: int = 0):
    """10 s at 8 kHz: two seeded harmonic sources with vibrato."""
    import numpy as np
    rng = np.random.RandomState(seed)
    t = np.arange(WAV_SECONDS * SMPRATE) / SMPRATE
    mix = np.zeros_like(t)
    for f0 in rng.uniform(100, 300, size=2):
        phase = 2 * np.pi * np.cumsum(
            f0 * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(2, 6) * t))
        ) / SMPRATE
        for h in range(1, 6):
            mix += np.sin(h * phase) / h
    mix += 0.01 * rng.randn(len(t))
    return (0.5 * mix / np.abs(mix).max()).astype(np.float32)


def phase_serve() -> None:
    import numpy as np
    import scipy.io.wavfile
    mix = synth_mixture()
    wav = os.path.join(WORK, "mix.wav")
    scipy.io.wavfile.write(wav, SMPRATE, (mix * 32767).astype(np.int16))
    ckpt = os.path.join(WORK, "saves", "smoke_e%d" % (TRAIN_EPOCHS + 1))
    cfg = os.path.join(WORK, "train.json")
    run("serve-demo", _main_py("-m", "demo", "-c", cfg, "-i", ckpt,
                               "-if", wav))
    for i in (1, 2):
        out = os.path.join(WORK, "mix_separated_%d.wav" % i)
        rate, data = scipy.io.wavfile.read(out)
        _check(rate == SMPRATE and abs(len(data) - len(mix)) <= 512,
               "demo: %s has %d samples at %d Hz" % (out, len(data), rate))
        _check(bool(np.isfinite(data.astype(np.float64)).all())
               and np.abs(data).max() > 0, "demo: %s is empty" % out)
    say("demo: 2 separated WAVs of %d samples" % len(mix))
    art = os.path.join(WORK, "artifact")
    run("serve-export", [sys.executable, "-m", "danet_tpu.serve", "export",
                         "-c", cfg, "-i", ckpt, "-o", art,
                         "--lengths", str(len(mix))])
    run("serve-run", [sys.executable, "-m", "danet_tpu.serve", "run",
                      "-d", art, "-if", wav,
                      "-o", os.path.join(WORK, "served")])
    for i in (0, 1):
        rate, data = scipy.io.wavfile.read(
            os.path.join(WORK, "served_%d.wav" % i))
        _check(len(data) == len(mix), "serve run: %d samples" % len(data))
    run("serve-check", _self("serve-check"))


def phase_compare() -> None:
    run("compare", _self("compare"))


def phase_bench() -> None:
    out = run("bench", [sys.executable, os.path.join(REPO, "bench.py")],
              cwd=REPO, timeout=1200)
    record = json.loads(out.strip().splitlines()[-1])
    _check(record["device"]["platform"] == "gpu", "bench: not on the GPU")
    _check(record["value"] > 0, "bench: no throughput")
    say("bench record: " + json.dumps(record))
    run("timings", _self("timings"))


def phase_four_cards() -> None:
    import numpy as np
    runs = {}
    for cards in ("0,1,2,3", "0"):
        out = run("dp-%dcard" % len(cards.split(",")), _self("dp"),
                  cards=cards)
        rec = json.loads(out.strip().splitlines()[-1])
        runs[rec["devices"]] = np.array(rec["losses"])
    _check(set(runs) == {1, 4}, "four-cards: ran on %r" % sorted(runs))
    rel = np.abs(runs[4] - runs[1]) / np.abs(runs[1])
    say("dp global batch 128, %d steps: max rel loss diff 4 vs 1 card "
        "%.3g (step 0: %.3g); tolerance %g (step 0: %g)"
        % (len(rel), rel.max(), rel[0], DP_TOL["all_rel"],
           DP_TOL["first_rel"]))
    for i, (a, b) in enumerate(zip(runs[4], runs[1])):
        say("dp step %d: loss 4 cards %.6f, 1 card %.6f" % (i, a, b))
    _check(rel[0] <= DP_TOL["first_rel"] and rel.max() <= DP_TOL["all_rel"],
           "four-cards: losses disagree")


PHASES = {"train": phase_train, "shipping": phase_shipping,
          "serve": phase_serve, "compare": phase_compare,
          "bench": phase_bench, "four-cards": phase_four_cards}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel phase")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        CHILD_PHASES[args.phase]()
        return 0
    if not os.path.isdir(os.path.join(REPO, "danet_tpu")):
        sys.stderr.write("chip_smoke.py runs from a checkout of the repo; "
                         "%s has no danet_tpu package\n" % REPO)
        return 2
    n_cards = 4 if args.four_cards else 1
    cards = ",".join(str(i) for i in range(n_cards))
    _DEADLINE[0] = time.monotonic() + TOTAL_TIMEOUT_S
    try:
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        device = probe_device(cards)
        require_gpu(device, n_cards)
        for line in card_lines():
            print("card: " + line, flush=True)
        say("device %s x%d" % (device["kind"], device["count"]))
        for name in plan(args.four_cards):
            t0 = time.monotonic()
            PHASES[name]()
            say("phase %s passed in %.1f s" % (name, time.monotonic() - t0))
    except SmokeError as e:
        sys.stderr.write("chip_smoke FAILED: %s\n" % e)
        return 1
    print(result_line(device), flush=True)
    return 0


# ---------------------------------------------------------------------------
# child side: one process on the card(s) CUDA_VISIBLE_DEVICES names
# ---------------------------------------------------------------------------

def _hparams(**overrides):
    from danet_tpu.hparams import hparams
    import danet_tpu  # noqa: F401  (registries)
    hparams.load_json(os.path.join(REPO, "default.json"))
    for k, v in overrides.items():
        setattr(hparams, k, v)
    hparams.digest()
    return hparams


def _first_batch(hp, batch_size: int):
    """The first synth-speech training batch, spectra [B, N, T, F, 2]."""
    import numpy as np
    from danet_tpu.train.trainer import effective_bucket, prepare_batch
    dataset = hp.get_dataset()()
    dataset.install_and_load()
    np.random.seed(0)
    data_pt = next(iter(dataset.epoch(
        "train", batch_size * hp.MAX_N_SIGNAL, shuffle=True)))
    return prepare_batch(data_pt[0], batch_size, hp.MAX_N_SIGNAL,
                         max_len=hp.MAX_TRAIN_LEN, bucket=effective_bucket(hp))


def _rel_l2(a_tree, b_tree) -> float:
    import jax
    import numpy as np
    num = den = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(a_tree),
                    jax.tree_util.tree_leaves(b_tree)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        num += float(np.sum((a - b) ** 2))
        den += float(np.sum(b ** 2))
    return (num / den) ** 0.5


def child_compare() -> None:
    """bilstm-orig train loss and gradients, and the DSP front-end, on the
    card against the CPU backend / scipy, in one process."""
    import jax
    import numpy as np
    import scipy.signal
    from danet_tpu.compile_cache import enable_compile_cache
    from danet_tpu.data import audio
    from danet_tpu.models import DaNet
    from danet_tpu.ops import dsp
    enable_compile_cache()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    _check(gpu.platform == "gpu", "compare: no GPU")
    hp = _hparams(ENCODER_TYPE="bilstm-orig", DATASET_TYPE="synth-speech")
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _first_batch(hp, hp.BATCH_SIZE)
    say("compare: bilstm-orig B=%d N=%d T=%d F=%d, COMPUTE_DTYPE=%s"
        % (tuple(src.shape[:4]) + (hp.COMPUTE_DTYPE,)))

    def loss_fn(p, s):
        return model.train_loss(p, s, None)[0]

    def on(device, precision):
        with jax.default_matmul_precision(precision):
            f = jax.jit(jax.value_and_grad(loss_fn))
            loss, grads = f(jax.device_put(params, device),
                            jax.device_put(src, device))
            return float(loss), jax.device_get(grads)

    ref_loss, ref_grads = on(cpu, "highest")
    for precision in ("highest", "default"):
        loss, grads = on(gpu, precision)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        grad_rel = _rel_l2(grads, ref_grads)
        tol = TOL[precision]
        say("compare %s precision: loss gpu %.7g cpu %.7g rel %.3g (tol %g);"
            " grads rel L2 %.3g (tol %g)"
            % (precision, loss, ref_loss, loss_rel, tol["loss_rel"],
               grad_rel, tol["grad_rel_l2"]))
        _check(loss_rel <= tol["loss_rel"] and grad_rel <= tol["grad_rel_l2"],
               "compare %s: card and CPU disagree" % precision)

    x = synth_mixture(1)[None]
    window = hp.FFT_WND_ARRAY
    with jax.default_matmul_precision("highest"):
        ri = jax.jit(lambda w: dsp.stft_ri(
            w, hp.FFT_SIZE, hp.FFT_STRIDE, window))(jax.device_put(x, gpu))
        ri = np.asarray(ri)[0]
        y = np.asarray(jax.jit(lambda r: dsp.istft_ri(
            r, hp.FFT_STRIDE, window))(jax.device_put(ri, gpu)))
    z_ref = scipy.signal.stft(
        x[0], window=window, nperseg=hp.FFT_SIZE,
        noverlap=hp.FFT_SIZE - hp.FFT_STRIDE)[2].T
    stft_err = np.abs(audio.from_ri(ri) - z_ref).max() / np.abs(z_ref).max()
    y_ref = audio.istft_np(z_ref)
    istft_err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    say("compare dsp highest precision: stft_ri vs scipy %.3g (tol %g), "
        "istft_ri vs host overlap-add %.3g (tol %g)"
        % (stft_err, TOL["stft_highest"], istft_err, TOL["istft_highest"]))
    _check(stft_err <= TOL["stft_highest"]
           and istft_err <= TOL["istft_highest"],
           "compare dsp: card and scipy disagree")


def child_serve_check() -> None:
    """The exported artifact, loaded as a server would: finite separated
    sources of the request's length."""
    import numpy as np
    from danet_tpu import serve
    from danet_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    bundle = serve.load_separator(os.path.join(WORK, "artifact"))
    mix = synth_mixture()
    out = bundle.separate(mix)
    _check(out.shape == (2, len(mix)), "serve: output shape %r"
           % (out.shape,))
    _check(bool(np.isfinite(out).all()) and np.abs(out).max() > 0,
           "serve: output not finite or all zero")
    say("serve artifact: [%d, %d] finite, peak %.3f"
        % (out.shape + (float(np.abs(out).max()),)))


def _time_ms(fn, args, n_iters: int = 20):
    """Per-call wall times (ms) of a jitted fn after warmup, each call
    ended by block_until_ready."""
    import jax
    for _ in range(3):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)


def _encoder_fwd_bwd(encoder):
    """Forward+backward of an encoder alone, w.r.t. its weights."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fwd_bwd(p, x):
        def f(q):
            e = encoder.apply(q, x, train=False)
            return jnp.mean(jnp.square(e.astype(jnp.float32)))
        return jax.value_and_grad(f)(p)
    return fwd_bwd


def child_timings() -> None:
    """The recurrent, DSP and serving paths timed on the card: the
    bilstm-orig train step, the 4-layer BiLSTM and GRU
    encoders' forward+backward alone (bf16 compute, f32 master weights,
    B=32, T=128, F=129), the STFT+iSTFT pair and separate_wav on 10 s of
    8 kHz audio."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from danet_tpu import optim as optim_lib
    from danet_tpu.compile_cache import enable_compile_cache
    from danet_tpu.models import DaNet
    from danet_tpu.models.danet import mixture_features
    from danet_tpu.ops import dsp
    enable_compile_cache()
    hp = _hparams(ENCODER_TYPE="bilstm-orig", DATASET_TYPE="synth-speech",
                  COMPUTE_DTYPE="bfloat16")
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    optimizer = optim_lib.make_optimizer(hp)
    opt_state = optimizer.init(params)
    src = jax.device_put(_first_batch(hp, hp.BATCH_SIZE))

    @jax.jit
    def train_step(p, o, s):
        loss, grads = jax.value_and_grad(
            lambda q: model.train_loss(q, s, None)[0])(p)
        updates, o = optimizer.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    step_ms = _time_ms(lambda: train_step(params, opt_state, src), ())
    logmag = mixture_features(src, hp.EPS)[3].astype(jnp.bfloat16)
    enc_ms = _time_ms(_encoder_fwd_bwd(model.encoder),
                      (params["encoder"], logmag))
    med_step, med_enc = np.median(step_ms), np.median(enc_ms)
    say("timing bilstm-orig train step (1 step/dispatch, bf16): median "
        "%.3f ms, min %.3f ms" % (med_step, step_ms[0]))
    say("timing 4xBiLSTM encoder fwd+bwd alone: median %.3f ms, min "
        "%.3f ms (%.1f%% of the step)"
        % (med_enc, enc_ms[0], 100.0 * med_enc / med_step))

    _hparams(ENCODER_TYPE="gru-v1", COMPUTE_DTYPE="bfloat16")
    gru = DaNet()
    gru_ms = _time_ms(_encoder_fwd_bwd(gru.encoder),
                      (gru.init(jax.random.PRNGKey(0))["encoder"], logmag))
    say("timing 4xGRU (gru-v1) encoder fwd+bwd alone: median %.3f ms, "
        "min %.3f ms" % (np.median(gru_ms), gru_ms[0]))

    hp = _hparams(ENCODER_TYPE="bilstm-orig")
    wav = jax.device_put(synth_mixture()[None])
    window = hp.FFT_WND_ARRAY
    stft_ms = _time_ms(jax.jit(lambda w: dsp.istft_ri(dsp.stft_ri(
        w, hp.FFT_SIZE, hp.FFT_STRIDE, window), hp.FFT_STRIDE, window)),
        (wav,))
    say("timing stft_ri+istft_ri %d s at %d Hz (B=1, f32): median %.3f ms"
        % (WAV_SECONDS, SMPRATE, np.median(stft_ms)))
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    sep = jax.jit(model.separate_wav)
    sep_ms = _time_ms(sep, (params, wav))
    out = np.asarray(sep(params, wav))
    _check(bool(np.isfinite(out).all()), "timing: separate_wav not finite")
    say("timing separate_wav %d s at %d Hz (B=1, f32): median %.3f ms, "
        "p90 %.3f ms, real-time factor %.5f"
        % (WAV_SECONDS, SMPRATE, np.median(sep_ms),
           sep_ms[int(0.9 * len(sep_ms))],
           np.median(sep_ms) / (1e3 * WAV_SECONDS)))


def child_dp() -> None:
    """DP_STEPS training steps of the train configuration at global batch
    128 on every visible card; prints the per-step losses as JSON."""
    import jax
    import numpy as np
    from danet_tpu.compile_cache import enable_compile_cache
    from danet_tpu.models import DaNet
    from danet_tpu.train.trainer import Trainer, effective_bucket, \
        prepare_batch
    enable_compile_cache()
    hp = _hparams(ENCODER_TYPE="bilstm-orig", DATASET_TYPE="synth-speech",
                  BATCH_SIZE=128, SYNTH_BATCHES=DP_STEPS)
    dataset = hp.get_dataset()()
    dataset.install_and_load()
    np.random.seed(0)
    batches = [prepare_batch(d[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                             max_len=hp.MAX_TRAIN_LEN,
                             bucket=effective_bucket(hp))
               for d in dataset.epoch("train", hp.BATCH_SIZE
                                      * hp.MAX_N_SIGNAL, shuffle=True)]
    trainer = Trainer(DaNet(), name="dp", save_dir=WORK)
    state = trainer.init_state(jax.random.PRNGKey(0))
    params, opt_state = state["params"], state["opt_state"]
    losses = []
    for i, b in enumerate(batches):
        params, opt_state, m = trainer._train_step(
            params, opt_state, trainer._put_batch(b),
            jax.random.PRNGKey(100 + i))
        losses.append(float(m["loss"]))
    n = len(jax.devices())
    say("dp on %d card(s), mesh %s: losses %s"
        % (n, dict(trainer.mesh.shape), ["%.6f" % v for v in losses]))
    print(json.dumps({"devices": n, "losses": losses}))


CHILD_PHASES = {"compare": child_compare, "serve-check": child_serve_check,
                "timings": child_timings, "dp": child_dp}


if __name__ == "__main__":
    sys.exit(main())
