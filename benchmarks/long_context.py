"""Long-context END-TO-END training: ATTN_CAUSAL attn-v1 at T=2048-8192.

Upgrades ops/local_attention.py from microbenchmark to capability
(VERDICT r3 item 7): the claim is that the chunked banded path lets the
FULL training step (fwd+bwd+Adam, DaNet attn-v1, ATTN_CAUSAL with a
finite ATTN_LOOKBACK) run at sequence lengths where the dense-banded
form exhausts device memory on its [B, H, T, T] masked logits — the
capability the reference lacks entirely (its only length tool is the MAX_TRAIN_LEN
random crop, /root/reference/main.py:422-426).

Two modes:
  python benchmarks/long_context.py            # one GPU
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/long_context.py --cpu-mesh   # MESH_SEQ=8 ring

The GPU mode times N_STEPS real train steps per (T, path) cell, ended by
jax.block_until_ready, and prints per-cell ms/step +
frames/s; a dense cell that fails to compile/fit records OOM — that
boundary IS the result.  The CPU-mesh mode runs a few steps of the same
model sequence-parallel over an 8-device 'seq' ring (SP_ATTN=ring
composing with the causal band) to demonstrate the multi-chip long-T
path executes end-to-end.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BATCH = int(os.environ.get("LC_BATCH", 4))
N_SIGNAL = 2
N_STEPS = int(os.environ.get("LC_STEPS", 50))
LOOKBACK = int(os.environ.get("LC_LOOKBACK", 128))


def build_step(t, local_chunk, mesh_seq=0):
    import jax
    import optax
    from danet_tpu.hparams import hparams
    from danet_tpu import optim as optim_lib  # noqa: F401 (registry)
    import danet_tpu  # noqa: F401

    hparams.load_json(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "default.json"))
    hparams.ENCODER_TYPE = "attn-v1"
    hparams.BATCH_SIZE = BATCH
    hparams.COMPUTE_DTYPE = "bfloat16"
    hparams.ATTN_CAUSAL = True
    hparams.ATTN_LOOKBACK = LOOKBACK
    hparams.ATTN_LOCAL_CHUNK = local_chunk
    hparams.MAX_TRAIN_LEN = t
    hparams.TIME_BUCKET = t
    if mesh_seq:
        hparams.MESH_SEQ = mesh_seq
        hparams.SP_ATTN = "ring"
        # keep the CPU-mesh demo cheap: the 1-core container simulates
        # all 8 devices; geometry, not speed, is under test
        hparams.ATTN_DIM = 64
        hparams.ATTN_LAYERS = 2
        hparams.ATTN_HEADS = 2
    hparams.digest()

    from danet_tpu.models import DaNet
    from danet_tpu.train.trainer import Trainer, prepare_batch

    trainer = Trainer(DaNet(), name="longctx",
                      save_dir="/tmp/longctx_saves")
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    flat = rng.rand(BATCH * N_SIGNAL, t,
                    hparams.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, BATCH, N_SIGNAL, max_len=t,
                          bucket=hparams.TIME_BUCKET)
    src = trainer._put_batch(batch)
    return trainer, state, src


def timed_steps(trainer, state, src, n_steps):
    import jax
    params, opt_state = state["params"], state["opt_state"]
    for i in range(3):
        params, opt_state, m = trainer._train_step(
            params, opt_state, src, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["loss"]))
    t0 = time.perf_counter()
    for i in range(n_steps):
        params, opt_state, m = trainer._train_step(
            params, opt_state, src, jax.random.PRNGKey(100 + i))
    jax.block_until_ready((params, opt_state, m))
    dt = (time.perf_counter() - t0) / n_steps
    assert np.isfinite(float(m["loss"]))
    return dt


def device_mem_gb():
    import jax
    try:
        stats = jax.local_devices()[0].memory_stats()
        return stats.get("peak_bytes_in_use", 0) / 2**30
    except Exception:
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="MESH_SEQ=8 ring demo on the virtual CPU mesh")
    ap.add_argument("--t", type=int, nargs="*",
                    default=[2048, 4096, 8192])
    args = ap.parse_args()

    if args.cpu_mesh:
        t = args.t[0] if args.t else 4096
        print("cpu-mesh: MESH_SEQ=8 ring, ATTN_CAUSAL, T=%d, B=%d"
              % (t, BATCH), flush=True)
        trainer, state, src = build_step(t, local_chunk=0, mesh_seq=8)
        dt = timed_steps(trainer, state, src, n_steps=2)
        print("cpu-mesh OK: %d devices, %.1f s/step (1-core simulation "
              "— executes, not a speed claim)"
              % (len(__import__("jax").devices()), dt), flush=True)
        return

    print("%-6s %-8s %10s %12s %10s" % (
        "T", "path", "ms/step", "frames/s", "peak GB"), flush=True)
    for t in args.t:
        for name, chunk in (("chunked", 0), ("dense", -1)):
            try:
                trainer, state, src = build_step(t, local_chunk=chunk)
                dt = timed_steps(trainer, state, src, N_STEPS)
            except Exception as e:
                print("%-6d %-8s %10s (%s: %.120s)"
                      % (t, name, "OOM/fail", type(e).__name__, e),
                      flush=True)
                continue
            mem = device_mem_gb()
            print("%-6d %-8s %10.2f %12.0f %10s"
                  % (t, name, dt * 1e3, BATCH * t / dt,
                     "-" if mem is None else "%.2f" % mem), flush=True)


if __name__ == "__main__":
    main()
