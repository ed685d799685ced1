"""Decompose the flagship train step's non-encoder tail (GPU).

This profiler measures the estimator/separator/PIT residual of the step
stage by stage so optimization effort lands where the time actually is.

Method: jit fwd+bwd (value_and_grad + a param-sum consumer so the
backward runs) of progressively longer PREFIXES of DaNet.train_loss at
the bench workload (B=32, N=2, T=128, bf16), timed over 50 iterations
ended by jax.block_until_ready.  Successive
differences = per-stage fwd+bwd cost.  Stages:

  null      a trivial jitted reduction of the input — measures the fixed
            per-dispatch overhead (host dispatch + launch), which is
            NOT model cost and must be subtracted before reading any
            stage delta as optimization headroom
  feat      mixture_features only (STFT-side features are precomputed
            in src_ri form, so this is the power/log/phase block)
  encoder   + encoder forward to embeddings
  estim     + truth-weighted estimator (train path)
  separ     + dot-sigmoid separator -> separated power
  pit       + FUSED masked PIT (the shipping tail: loss + SNR straight
            from the masks, ops/loss.py::pit_mse_masked_ri)
  pit-composed  the pre-r4 tail (materialized [B,N,T,F,2] reconstruction
            + complex-ri PIT) — its delta is also against 'separ', so
            pit vs pit-composed reads the fold's win directly

Run on the real chip:  python benchmarks/tail_profile.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BATCH, N_SIGNAL, T = 32, 2, 128


def build(stage: str):
    import jax
    import jax.numpy as jnp
    from danet_tpu.hparams import hparams
    import danet_tpu  # noqa: F401
    from danet_tpu.models.danet import mixture_features
    from danet_tpu.ops import loss as loss_ops

    hparams.load_json(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "default.json"))
    hparams.ENCODER_TYPE = "bilstm-orig"  # the flagship, as bench.py —
    # default.json ships the reference's 'toy' encoder, which would make
    # the encoder stage (and the tail's share of the step) meaningless
    hparams.BATCH_SIZE = BATCH
    hparams.COMPUTE_DTYPE = "bfloat16"
    hparams.digest()
    model = hparams.get_model()()
    params = model.init(jax.random.PRNGKey(0))
    src = jax.device_put(np.random.RandomState(0).randn(
        BATCH, N_SIGNAL, T, hparams.FEATURE_SIZE, 2).astype(np.float32))

    def prefix_loss(params, src_ri):
        if stage == "null":
            return jnp.sum(src_ri) + 0.0 * sum(
                jnp.sum(p.astype(jnp.float32))
                for p in jax.tree_util.tree_leaves(params))
        (mix_ri, src_pwr, mix_pwr, logmag,
         phase_unit) = mixture_features(src_ri, hparams.EPS)
        if stage == "feat":
            return (jnp.mean(jnp.square(mix_pwr))
                    + jnp.mean(jnp.square(logmag)))
        embed, embed_flat = model._embed(params, logmag, True, None)
        if stage == "encoder":
            return jnp.mean(jnp.square(embed.astype(jnp.float32)))
        attractors = model.train_estimator.apply(
            params["train_estimator"], embed,
            src_pwr=src_pwr, mix_pwr=mix_pwr)
        if stage == "estim":
            return (jnp.mean(jnp.square(attractors.astype(jnp.float32)))
                    + 0.0 * jnp.mean(jnp.square(
                        embed.astype(jnp.float32))))
        sep_pwr = model.separator.apply(
            params["separator"], mix_pwr, attractors, embed_flat)
        if stage == "separ":
            return jnp.mean(jnp.square(sep_pwr))
        if stage == "pit-composed":
            # the pre-r4 tail: materialize the [B,N,T,F,2] reconstruction
            # and difference it (kept as the comparison row quantifying
            # the fused fold's win)
            sep_ri = sep_pwr[..., None] * phase_unit[:, None]
            loss, _, _ = loss_ops.pit_mse_loss(
                src_ri, sep_ri, complex_ri=True)
            return loss
        # the SHIPPING tail (models/danet.py train path): fused masked
        # PIT, no reconstruction materialized (ops/loss.py)
        loss, _, _, snr = loss_ops.pit_mse_masked_ri(
            src_ri, sep_pwr, phase_unit, eps=hparams.EPS)
        return loss + 0.0 * jnp.mean(snr)

    @jax.jit
    def step(params, src_ri):
        loss, grads = jax.value_and_grad(prefix_loss)(params, src_ri)
        # consume the grads so XLA cannot DCE the backward
        gsum = sum(jnp.sum(g.astype(jnp.float32))
                   for g in jax.tree_util.tree_leaves(grads))
        return loss + 0.0 * gsum

    return step, params, src


def timeit(step, params, src, iters=50):
    import jax
    for _ in range(3):
        out = step(params, src)
    assert np.isfinite(float(out))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(params, src)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    stages = ["null", "feat", "encoder", "estim", "separ", "pit",
              "pit-composed"]
    prev = 0.0
    print("%-12s %9s %9s" % ("stage", "ms(cum)", "ms(delta)"), flush=True)
    for s in stages:
        step, params, src = build(s)
        ms = timeit(step, params, src)
        # pit-composed deltas against the same 'separ' prefix as 'pit'
        print("%-12s %9.3f %9.3f" % (s, ms, ms - prev), flush=True)
        if s != "pit":
            prev = ms


if __name__ == "__main__":
    main()
