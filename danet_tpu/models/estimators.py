"""Attractor estimators: truth / truth-threshold / truth-weighted / anchor.

Re-implementations of the reference estimator registry
(/root/reference/app/modules.py:382-545).  The reference computes per-source
means with ``tf.map_fn`` + ``unsorted_segment_sum``; here the hard assignment
becomes a one-hot tensor and every segment mean is a single batched einsum —
a GEMM with no scatter, no host loop, and a trivially clean
gradient.  The anchored estimator is pure einsum/argmin and maps 1:1 to XLA.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from danet_tpu.hparams import hparams
from danet_tpu.models.base import Estimator
from danet_tpu.ops.nn import ee


def _flatten_embed(embed):
    """[B, T, F, E] -> [B, T*F, E]"""
    b, t, f, e = embed.shape
    return embed.reshape(b, t * f, e)


def _hard_assignment(src_pwr):
    """One-hot dominant-source assignment per TF bin.

    src_pwr: [B, N, T, F] -> one-hot [B, T*F, N]
    (argmax as in reference modules.py:396).
    """
    b, n = src_pwr.shape[0], src_pwr.shape[1]
    labels = jnp.argmax(src_pwr, axis=1)          # [B, T, F]
    onehot = jax.nn.one_hot(labels, n, dtype=src_pwr.dtype)
    return onehot.reshape(b, -1, n)               # [B, TF, N]


@hparams.register_estimator("truth")
class AverageEstimator(Estimator):
    """Plain per-source mean of embeddings (reference modules.py:382-412).

    Keeps the reference's ``/(count + 1)`` denominator (modules.py:407) for
    metric parity — documented quirk, not a standard mean.
    """

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        embed_flat = _flatten_embed(embed)
        onehot = _hard_assignment(src_pwr)
        onehot = onehot.astype(embed_flat.dtype)
        sums = ee("bkn,bke->bne", onehot, embed_flat)
        counts = jnp.sum(onehot, axis=1)          # [B, N]
        return sums / (counts[..., None] + 1.0)


@hparams.register_estimator("truth-threshold")
class ThresholdedAverageEstimator(Estimator):
    """Mean over bins whose mixture magnitude exceeds 5
    (reference modules.py:415-450)."""

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        hp = self.hp
        embed_flat = _flatten_embed(embed)
        onehot = _hard_assignment(src_pwr)
        b = embed.shape[0]
        w = (mix_pwr.reshape(b, -1, 1) > 5.0).astype(embed_flat.dtype)
        # fold the bin weight into the [B, TF, N] assignment (N << E)
        # instead of scaling the [B, TF, E] embeddings: same contraction
        # (sum_k onehot*w*embed), but no embed-sized temporary and the
        # weight-sum reduction rides the same small tensor — one GEMM +
        # one reduce instead of two GEMMs over an extra E-wide pass.
        wgt = onehot.astype(embed_flat.dtype) * w
        sums = ee("bkn,bke->bne", wgt, embed_flat)
        wsum = jnp.sum(wgt, axis=1)[..., None]
        return sums / (wsum + hp.EPS)


@hparams.register_estimator("truth-weighted")
class WeightedAverageEstimator(Estimator):
    """Mixture-magnitude-weighted mean — the default train estimator
    (reference modules.py:453-487, default.json:29)."""

    USE_TRUTH = True

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        hp = self.hp
        embed_flat = _flatten_embed(embed)
        onehot = _hard_assignment(src_pwr)
        b = embed.shape[0]
        w = mix_pwr.reshape(b, -1, 1).astype(embed_flat.dtype)
        # weight folded into the [B, TF, N] assignment, not the
        # [B, TF, E] embeddings — see ThresholdedAverageEstimator
        wgt = onehot.astype(embed_flat.dtype) * w
        sums = ee("bkn,bke->bne", wgt, embed_flat)
        wsum = jnp.sum(wgt, axis=1)[..., None]
        return sums / (wsum + hp.EPS)


@hparams.register_estimator("kmeans")
class KMeansEstimator(Estimator):
    """Truth-free k-means attractor estimation (DaNet paper's test-time
    alternative; listed in BASELINE.json configs, absent in the reference).

    Centroids are initialized from the anchor mechanism (trainable anchors,
    min-similarity subset — eq. 6-9) and refined with KMEANS_ITER rounds of
    mixture-power-weighted soft assignment / mean updates.  Everything is
    dense einsums inside a fori_loop — no data-dependent shapes.
    """

    USE_TRUTH = False

    def init(self, rng):
        hp = self.hp
        return {
            "anchors": jax.random.normal(
                rng, (hp.NUM_ANCHOR, hp.EMBED_SIZE), dtype=jnp.float32),
        }

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        hp = self.hp
        n_iter = getattr(hp, "KMEANS_ITER", None)
        n_iter = 5 if n_iter is None else int(n_iter)
        embed_flat = _flatten_embed(embed)             # [B, K, E]
        # bin weights: mixture power if available, else uniform
        if mix_pwr is not None:
            w = mix_pwr.reshape(embed.shape[0], -1, 1).astype(
                embed_flat.dtype)
        else:
            w = jnp.ones(embed_flat.shape[:2] + (1,), embed_flat.dtype)

        # anchor-based initialization (same as AnchoredEstimator)
        init = AnchoredEstimator.apply(self, params, embed)

        n_src = init.shape[1]
        if n_src == 2:
            # N=2 strength reduction (same identity as the anchor init's
            # fast path): the two-way softmax is a sigmoid of the logit
            # difference, and the complement slot follows from the
            # loop-INVARIANT weighted totals — per iteration one [B, K]
            # contraction + one sigmoid instead of two [B, K, 2] einsums
            # + a softmax.  This loop runs inside every shipping train
            # step (unrolled-kmeans fine-tuning).
            w1 = w[..., 0]                                  # [B, K]
            sums_w = ee("bk,bke->be", w1, embed_flat)       # invariant
            wsum_w = jnp.sum(w1.astype(jnp.float32), axis=1,
                             keepdims=True)                 # [B, 1]

            def step(centroids):
                dc = (centroids[:, 0] - centroids[:, 1]).astype(
                    embed_flat.dtype)                       # [B, E]
                s = jax.nn.sigmoid(
                    ee("bke,be->bk", embed_flat, dc)) * w1  # [B, K]
                sums0 = ee("bk,bke->be", s, embed_flat)
                wsum0 = jnp.sum(s.astype(jnp.float32), axis=1,
                                keepdims=True)
                c0 = sums0 / (wsum0 + hp.EPS).astype(sums0.dtype)
                c1 = (sums_w - sums0) / (wsum_w - wsum0
                                         + hp.EPS).astype(sums0.dtype)
                return jnp.stack([c0, c1], axis=1).astype(centroids.dtype)
        else:
            def step(centroids):
                # soft assignment by dot-product similarity (softmax/N)
                logits = ee("bke,bne->bkn", embed_flat,
                            centroids.astype(embed_flat.dtype))
                assign = jax.nn.softmax(logits, axis=-1) * w  # [B, K, N]
                sums = ee("bkn,bke->bne", assign, embed_flat)
                wsum = jnp.sum(assign, axis=1)[..., None]
                return (sums / (wsum + hp.EPS)).astype(centroids.dtype)

        # statically unrolled (KMEANS_ITER is small): unlike a
        # fori_loop/scan, the unrolled chain lets XLA fuse across
        # iterations and differentiates without a carried-loop stack
        centroids = init
        for _ in range(n_iter):
            centroids = step(centroids)
        return centroids


@hparams.register_estimator("anchor")
class AnchoredEstimator(Estimator):
    """Trainable anchors + softmax assignment + min-similarity subset pick —
    the inference-time estimator (reference modules.py:490-545, DaNet paper
    eq. 6-9).  All dense einsums; the subset choice is an argmin-gather over
    the C(NUM_ANCHOR, N) combinations."""

    USE_TRUTH = False

    def init(self, rng):
        hp = self.hp
        return {
            "anchors": jax.random.normal(
                rng, (hp.NUM_ANCHOR, hp.EMBED_SIZE), dtype=jnp.float32),
        }

    @staticmethod
    def _attractor_sets_pairs(embed, anchors, combs):
        """N=2 strength reduction of eq (6)-(7).

        A two-way softmax is a sigmoid of the logit difference, so the
        [B, P, T, F, 2] assignment tensor (P = C(A, 2) subsets) never
        materializes: one [B, K, A] anchor-dot GEMM (A distinct anchors
        instead of P*2 subset slots), one [B, K, P] sigmoid, and one
        [B, P, E] contraction replace the eq-(6)/(7) chain; slot 1
        follows by sum-complement (softmax weights sum to 1 per bin).
        Exact in real arithmetic — softmax([x, y]) ==
        [sigmoid(x-y), sigmoid(y-x)].  This path runs EVERY training
        step under the shipping config (ANCHOR_AUX_LOSS through the
        kmeans estimator, whose init is the anchor mechanism), where
        the materialized form dominated the step tail."""
        b, e_dim = embed.shape[0], embed.shape[-1]
        e_flat = embed.reshape(b, -1, e_dim)                # [B, K, E]
        k = e_flat.shape[1]
        d = ee("bke,ae->bka", e_flat, anchors)              # [B, K, A]
        s = jax.nn.sigmoid(
            d[..., jnp.asarray(combs[:, 0])]
            - d[..., jnp.asarray(combs[:, 1])])             # [B, K, P]
        num0 = ee("bkp,bke->bpe", s, e_flat)                # [B, P, E]
        num1 = jnp.sum(e_flat, axis=1)[:, None] - num0
        den0 = jnp.sum(s.astype(jnp.float32), axis=1)       # [B, P]
        den1 = jnp.asarray(k, jnp.float32) - den0
        att0 = num0 / den0[..., None].astype(embed.dtype)
        att1 = num1 / den1[..., None].astype(embed.dtype)
        return jnp.stack([att0, att1], axis=2)              # [B, P, 2, E]

    @staticmethod
    def _attractor_sets_general(embed, anchors, combs):
        """eq (6)-(7) for any N: materialized per-subset softmax."""
        anchor_sets = anchors[jnp.asarray(combs)]           # [P, N, E]
        # eq (6): soft assignment of each TF bin to a subset's anchors
        logits = ee("btfe,pce->bptfc", embed, anchor_sets)
        assignment = jax.nn.softmax(logits, axis=-1)
        # eq (7): assignment-weighted mean embedding per anchor
        attractor_sets = ee("bptfc,btfe->bpce", assignment, embed)
        return attractor_sets / jnp.sum(
            assignment.astype(jnp.float32), axis=(2, 3)
        )[..., None].astype(embed.dtype)

    def apply(self, params, embed, src_pwr=None, mix_pwr=None):
        hp = self.hp
        n = hp.MAX_N_SIGNAL
        combs = np.asarray(
            list(itertools.combinations(range(hp.NUM_ANCHOR), n)),
            dtype=np.int32)
        anchors = params["anchors"].astype(embed.dtype)
        # via the class, not self: KMeansEstimator borrows this apply for
        # its anchor-based init (AnchoredEstimator.apply(self, ...)) and
        # is not a subclass
        if n == 2:
            attractor_sets = AnchoredEstimator._attractor_sets_pairs(
                embed, anchors, combs)
        else:
            attractor_sets = AnchoredEstimator._attractor_sets_general(
                embed, anchors, combs)

        # eq (8): in-set max pairwise similarity between DISTINCT
        # attractors.  The reference takes the max over the full Gram
        # including the diagonal (modules.py:526-531); by Cauchy-Schwarz
        # a.b <= max(|a|^2, |b|^2), so its criterion degenerates to
        # "smallest max attractor norm", ignoring actual pairwise
        # similarity — a documented fix (SURVEY.md appendix policy).
        sim = ee("bpce,bpde->bpcd", attractor_sets, attractor_sets)
        n_set = sim.shape[-1]
        diag = jnp.eye(n_set, dtype=bool)
        sim = jnp.where(diag, -jnp.inf, sim.astype(jnp.float32))
        in_set_sim = jnp.max(sim, axis=(-1, -2))

        # eq (9): pick the least-similar subset
        choice = jnp.argmin(in_set_sim, axis=1)               # [B]
        return jnp.take_along_axis(
            attractor_sets, choice[:, None, None, None], axis=1)[:, 0]
