"""Exported-streaming-artifact latency vs the live jitted stream path.

serve.py's export-stream artifacts (AOT StableHLO warmup + fixed-chunk
step programs, params baked in) are parity-tested on CPU
(tests/test_serve.py); this benchmark answers the remaining serving
question: what per-chunk latency does the ARTIFACT deliver on the
card, next to the live `jax.jit(model.stream_step)` path?

Both arms run the SAME protocol: the full separated chunk is fetched to
the host every step — the serving contract (a caller wants the audio
out), which includes the device-to-host transfer that a sum-fetch
protocol amortizes away.  The live arm is
measured under both protocols so the artifact number has an
apples-to-apples neighbour.

Run on the chip:  python benchmarks/stream_artifact_latency.py
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=50)
    ap.add_argument("--chunk-samples", type=int, default=512)
    ap.add_argument("--warmup-samples", type=int, default=16384)
    ap.add_argument("--out-dir", default="/tmp/stream_artifact_bench")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from danet_tpu.hparams import hparams
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet
    from danet_tpu import serve

    hparams.load_json(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "default.json"))
    # the shipping online configuration: causal attn with a rolling K/V
    # cache (PARITY.md streaming table's 1.08 ms live row)
    hparams.ENCODER_TYPE = "attn-v1"
    hparams.ATTN_CAUSAL = True
    hparams.ATTN_LOOKBACK = 128
    hparams.BATCH_SIZE = 1
    hparams.digest()

    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    warm = rng.randn(1, args.warmup_samples).astype(np.float32) * 0.1
    chunk = rng.randn(1, args.chunk_samples).astype(np.float32) * 0.1
    chunk_ms = 1e3 * args.chunk_samples / hparams.SMPRATE

    def report(tag, dt):
        print("%-34s %6.2f ms/chunk  RTF %5.0fx   (%.1f ms audio/chunk)"
              % (tag, dt * 1e3, chunk_ms / (dt * 1e3), chunk_ms),
              flush=True)

    # --- live jitted path -------------------------------------------------
    cj = jnp.asarray(chunk)
    _, state = model.stream_init(params, jnp.asarray(warm))
    step = jax.jit(model.stream_step)
    out, state = step(params, state, cj)
    _ = np.asarray(out)                       # compile + sync
    s0 = state

    t0 = time.perf_counter()
    st = s0
    for _ in range(args.chunks):
        out, st = step(params, st, cj)
    _ = float(jnp.sum(out))
    report("live (sum-fetch)",
           (time.perf_counter() - t0) / args.chunks)

    t0 = time.perf_counter()
    st = s0
    for _ in range(args.chunks):
        out, st = step(params, st, cj)
        _ = np.asarray(out)                   # full audio to host
    report("live (full-output fetch)",
           (time.perf_counter() - t0) / args.chunks)

    # --- exported artifact ------------------------------------------------
    shutil.rmtree(args.out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    serve.export_streamer(model, params, args.out_dir,
                          args.chunk_samples, args.warmup_samples)
    print("export_streamer: %.1f s" % (time.perf_counter() - t0),
          flush=True)

    s = serve.load_streamer(args.out_dir)
    t0 = time.perf_counter()
    s.start(warm)
    print("artifact warmup program: %.1f s incl. first-call compile"
          % (time.perf_counter() - t0), flush=True)
    _ = s.feed(chunk)                          # step first-call compile

    t0 = time.perf_counter()
    for _ in range(args.chunks):
        _ = s.feed(chunk)                      # np.asarray inside feed
    report("artifact (full-output fetch)",
           (time.perf_counter() - t0) / args.chunks)


if __name__ == "__main__":
    main()
