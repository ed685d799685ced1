"""Streaming-step latency benchmark: per-chunk wall clock of the causal
online pipeline (DaNet.stream_step) for each streamable encoder family.

The serving metric for live audio: a chunk of C samples at SMPRATE must
separate in well under C/SMPRATE seconds (real-time factor > 1).  The
algorithmic latency is FFT_SIZE - FFT_STRIDE samples on top of the chunk
duration (ops/dsp.py streaming convention; dprnn-v1 adds its segment
granularity — chunks must be multiples of DPRNN_CHUNK frames).

Run: python benchmarks/stream_latency.py [--chunks N] [--chunk-frames F]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


CONFIGS = {
    "lstm-orig": {},
    "gru-v1": {},
    "tcn-v1": {"TCN_CAUSAL": True},
    "dprnn-v1": {"DPRNN_INTER_CAUSAL": True, "DPRNN_HOP": 64,
                 "DPRNN_CHUNK": 64},
    # causal windowed attention (per-layer rolling K/V cache)
    "attn-v1": {"ATTN_CAUSAL": True, "ATTN_LOOKBACK": 128},
    # waveform-domain family (MODEL_TYPE, not an encoder key): exact
    # causal streaming via carried filterbank/conv/OLA tails
    "tasnet-v1": {"MODEL_TYPE": "tasnet-v1", "TASNET_CAUSAL": True},
}


def bench_encoder(encoder: str, overrides: dict, chunk_frames: int,
                  n_chunks: int) -> None:
    import jax
    import jax.numpy as jnp
    from danet_tpu.hparams import hparams
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet

    hparams.load_json(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "default.json"))
    # default.json carries every CONFIGS key, so reloading it resets any
    # override a previous encoder's bench applied to the shared singleton
    if not overrides.get("MODEL_TYPE"):
        hparams.ENCODER_TYPE = encoder
    hparams.BATCH_SIZE = 1
    for k, v in overrides.items():
        setattr(hparams, k, v)
    hparams.digest()

    model = hparams.get_model()()
    params = model.init(jax.random.PRNGKey(0))
    stride = hparams.FFT_STRIDE
    if isinstance(model, DaNet):
        g = model._stream_granularity()
        cf = max(chunk_frames, g)
        cf -= cf % g
        chunk_n = cf * stride
        warm_n = max(128, 2 * cf) * stride
        warm_n -= warm_n % (g * stride)
        alg_latency = hparams.FFT_SIZE - stride
    else:
        # waveform-domain family: granularity/latency in SAMPLES
        g = model.stream_granularity_samples()
        chunk_n = max(chunk_frames * stride, g)
        chunk_n -= chunk_n % g
        warm_n = max(128 * stride, 2 * chunk_n)
        warm_n -= warm_n % g
        alg_latency = model.stream_latency_samples()

    rng = np.random.RandomState(0)
    warm = jnp.asarray(rng.randn(1, warm_n).astype(np.float32) * 0.1)
    chunk = jnp.asarray(rng.randn(1, chunk_n).astype(np.float32) * 0.1)

    _, state = model.stream_init(params, warm)
    step = jax.jit(model.stream_step)
    out, state = step(params, state, chunk)   # compile
    jax.block_until_ready((out, state))

    t0 = time.perf_counter()
    for _ in range(n_chunks):
        out, state = step(params, state, chunk)
    jax.block_until_ready((out, state))
    dt = (time.perf_counter() - t0) / n_chunks
    chunk_ms = 1e3 * chunk_n / hparams.SMPRATE
    print("%-10s chunk=%5d samples (%6.1f ms audio): %6.2f ms/step  "
          "RTF %.0fx  (+%d samples algorithmic latency)"
          % (encoder, chunk_n, chunk_ms, dt * 1e3, chunk_ms / (dt * 1e3),
             alg_latency), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=50)
    ap.add_argument("--chunk-frames", type=int, default=8,
                    help="frames per streaming chunk (rounded to each "
                         "encoder's granularity)")
    ap.add_argument("--encoders", default=",".join(CONFIGS))
    args = ap.parse_args()
    for enc in args.encoders.split(","):
        enc = enc.strip()
        if enc:
            bench_encoder(enc, CONFIGS.get(enc, {}), args.chunk_frames,
                          args.chunks)


if __name__ == "__main__":
    main()
