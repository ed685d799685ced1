"""Demo-latency benchmark: WAV-in -> separated-WAVs wall clock.

Measures the fused on-device inference path (DaNet.separate_wav: GEMM
STFT -> encoder -> anchor attractors -> masks -> GEMM iSTFT, one XLA
program) for a 10-second 8 kHz mixture, the BASELINE.md "demo latency"
metric.  Run: python benchmarks/latency.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    import jax.numpy as jnp
    from danet_tpu.hparams import hparams
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet

    hparams.load_json(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "default.json"))
    hparams.ENCODER_TYPE = "bilstm-orig"
    hparams.BATCH_SIZE = 1
    hparams.digest()

    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    seconds = 10.0
    wav = jnp.asarray(np.random.RandomState(0).randn(
        1, int(seconds * hparams.SMPRATE)).astype(np.float32) * 0.1)

    fn = jax.jit(model.separate_wav)
    jax.block_until_ready(fn(params, wav))  # compile
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        out = fn(params, wav)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    rtf = seconds / dt
    print("separate_wav(%.0fs @ %dHz): %.1f ms  (%.0fx real-time)"
          % (seconds, hparams.SMPRATE, dt * 1e3, rtf))


if __name__ == "__main__":
    main()
