"""Module zoo tests: encoder shapes, estimator oracles, separator math
(golden-value tests per SURVEY.md §4 implication)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from danet_tpu.models import DaNet


B, N, T = 2, 2, 16


def _src(hp, n=N, t=T, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, n, t, hp.FEATURE_SIZE, 2).astype(np.float32)


@pytest.mark.parametrize("enc", ["toy", "lstm-orig", "bilstm-orig",
                                 "conv-bilstm-v1", "tcn-v1", "dprnn-v1"])
def test_encoder_shapes(fresh_hparams, enc):
    hp = fresh_hparams
    hp.ENCODER_TYPE = enc
    hp.BATCH_SIZE = B
    encoder = hp.get_encoder()(hp, "encoder")
    params = encoder.init(jax.random.PRNGKey(0))
    logmag = jnp.asarray(
        np.random.RandomState(1).randn(B, T, hp.FEATURE_SIZE)
        .astype(np.float32))
    out = encoder.apply(params, logmag)
    assert out.shape == (B, T, hp.FEATURE_SIZE, hp.EMBED_SIZE)
    assert np.isfinite(np.asarray(out)).all()


def _estimator_inputs(hp, seed=0):
    rng = np.random.RandomState(seed)
    embed = rng.randn(B, T, hp.FEATURE_SIZE, hp.EMBED_SIZE).astype(
        np.float32)
    src_pwr = np.abs(rng.randn(B, N, T, hp.FEATURE_SIZE)).astype(np.float32)
    mix_pwr = src_pwr.sum(axis=1)
    return embed, src_pwr, mix_pwr


def test_truth_estimator_oracle(fresh_hparams):
    """truth = per-source sum of embeddings / (count + 1) — including the
    reference's +1 quirk (modules.py:407)."""
    hp = fresh_hparams
    est = hp.get_estimator("truth")(hp, "e")
    embed, src_pwr, mix_pwr = _estimator_inputs(hp)
    out = np.asarray(est.apply({}, jnp.asarray(embed), jnp.asarray(src_pwr),
                               jnp.asarray(mix_pwr)))
    flat = embed.reshape(B, -1, hp.EMBED_SIZE)
    labels = src_pwr.argmax(axis=1).reshape(B, -1)
    for b in range(B):
        for c in range(N):
            mask = labels[b] == c
            ref = flat[b][mask].sum(axis=0) / (mask.sum() + 1.0)
            np.testing.assert_allclose(out[b, c], ref, atol=1e-4)


def test_truth_weighted_estimator_oracle(fresh_hparams):
    hp = fresh_hparams
    est = hp.get_estimator("truth-weighted")(hp, "e")
    embed, src_pwr, mix_pwr = _estimator_inputs(hp, seed=1)
    out = np.asarray(est.apply({}, jnp.asarray(embed), jnp.asarray(src_pwr),
                               jnp.asarray(mix_pwr)))
    flat = embed.reshape(B, -1, hp.EMBED_SIZE)
    w = mix_pwr.reshape(B, -1)
    labels = src_pwr.argmax(axis=1).reshape(B, -1)
    for b in range(B):
        for c in range(N):
            mask = labels[b] == c
            ref = ((flat[b] * w[b][:, None])[mask].sum(axis=0)
                   / (w[b][mask].sum() + hp.EPS))
            np.testing.assert_allclose(out[b, c], ref, rtol=1e-3)


def test_truth_threshold_estimator_oracle(fresh_hparams):
    hp = fresh_hparams
    est = hp.get_estimator("truth-threshold")(hp, "e")
    embed, src_pwr, mix_pwr = _estimator_inputs(hp, seed=2)
    mix_pwr = mix_pwr * 4.0  # make some bins exceed the fixed threshold 5
    out = np.asarray(est.apply({}, jnp.asarray(embed), jnp.asarray(src_pwr),
                               jnp.asarray(mix_pwr)))
    flat = embed.reshape(B, -1, hp.EMBED_SIZE)
    w = (mix_pwr.reshape(B, -1) > 5.0).astype(np.float32)
    labels = src_pwr.argmax(axis=1).reshape(B, -1)
    assert w.sum() > 0
    for b in range(B):
        for c in range(N):
            mask = labels[b] == c
            ref = ((flat[b] * w[b][:, None])[mask].sum(axis=0)
                   / (w[b][mask].sum() + hp.EPS))
            np.testing.assert_allclose(out[b, c], ref, atol=1e-4)


def test_anchor_estimator_properties(fresh_hparams):
    """Anchored estimator returns attractors that are convex-ish combinations
    of embeddings (assignment-weighted means), shape [B, N, E]."""
    hp = fresh_hparams
    est = hp.get_estimator("anchor")(hp, "e")
    params = est.init(jax.random.PRNGKey(0))
    assert params["anchors"].shape == (hp.NUM_ANCHOR, hp.EMBED_SIZE)
    embed, _, _ = _estimator_inputs(hp, seed=3)
    out = np.asarray(est.apply(params, jnp.asarray(embed)))
    assert out.shape == (B, N, hp.EMBED_SIZE)
    # attractors lie within embedding min/max envelope (weighted means)
    assert out.max() <= embed.max() + 1e-5
    assert out.min() >= embed.min() - 1e-5


def test_anchor_pairs_fast_path_matches_general(fresh_hparams):
    """The N=2 sigmoid-difference strength reduction of eq (6)-(7)
    (r5: the [B,P,TF,2] assignment tensor never materializes) is
    numerically the materialized per-subset softmax."""
    import itertools
    from danet_tpu.models.estimators import AnchoredEstimator
    hp = fresh_hparams
    est = hp.get_estimator("anchor")(hp, "e")
    params = est.init(jax.random.PRNGKey(1))
    embed, _, _ = _estimator_inputs(hp, seed=7)
    embed = jnp.asarray(embed)
    combs = np.asarray(
        list(itertools.combinations(range(hp.NUM_ANCHOR), 2)),
        dtype=np.int32)
    anchors = params["anchors"]
    fast = np.asarray(AnchoredEstimator._attractor_sets_pairs(
        embed, anchors, combs))
    general = np.asarray(AnchoredEstimator._attractor_sets_general(
        embed, anchors, combs))
    np.testing.assert_allclose(fast, general, rtol=1e-4, atol=1e-5)
    # and gradients through both forms agree (the aux-loss path trains
    # the anchors through this computation)
    g_fast = jax.grad(lambda a: jnp.sum(
        AnchoredEstimator._attractor_sets_pairs(embed, a, combs) ** 2)
    )(anchors)
    g_gen = jax.grad(lambda a: jnp.sum(
        AnchoredEstimator._attractor_sets_general(embed, a, combs) ** 2)
    )(anchors)
    np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_gen),
                               rtol=1e-3, atol=1e-4)


def test_kmeans_pairs_step_matches_softmax(fresh_hparams):
    """The N=2 kmeans refinement (sigmoid + complement-of-invariant
    totals, r5) matches the general weighted-softmax iteration."""
    hp = fresh_hparams
    hp.KMEANS_ITER = 3
    est = hp.get_estimator("kmeans")(hp, "e")
    params = est.init(jax.random.PRNGKey(2))
    embed, _, mix_pwr = _estimator_inputs(hp, seed=11)
    embed, mix_pwr = jnp.asarray(embed), jnp.asarray(mix_pwr)
    got = np.asarray(est.apply(params, embed, mix_pwr=mix_pwr))

    # oracle: explicit softmax iteration from the anchor init
    from danet_tpu.models.estimators import (AnchoredEstimator,
                                             _flatten_embed)
    init = AnchoredEstimator.apply(est, params, embed)
    e_flat = _flatten_embed(embed)
    w = mix_pwr.reshape(embed.shape[0], -1, 1).astype(e_flat.dtype)
    c = init
    for _ in range(3):
        logits = jnp.einsum("bke,bne->bkn", e_flat, c.astype(e_flat.dtype))
        assign = jax.nn.softmax(logits, axis=-1) * w
        sums = jnp.einsum("bkn,bke->bne", assign, e_flat)
        wsum = jnp.sum(assign, axis=1)[..., None]
        c = (sums / (wsum + hp.EPS)).astype(c.dtype)
    np.testing.assert_allclose(got, np.asarray(c), rtol=1e-3, atol=1e-4)


def test_separator_sigmoid_oracle(fresh_hparams):
    hp = fresh_hparams
    sep = hp.get_separator("dot-sigmoid-orig")(hp, "s")
    rng = np.random.RandomState(4)
    mix_pwr = np.abs(rng.randn(B, T, hp.FEATURE_SIZE)).astype(np.float32)
    attractors = rng.randn(B, N, hp.EMBED_SIZE).astype(np.float32)
    embed_flat = rng.randn(B, T * hp.FEATURE_SIZE, hp.EMBED_SIZE).astype(
        np.float32)
    out = np.asarray(sep.apply({}, jnp.asarray(mix_pwr),
                               jnp.asarray(attractors),
                               jnp.asarray(embed_flat)))
    logits = np.einsum("bke,bne->bkn", embed_flat, attractors).reshape(
        B, T, hp.FEATURE_SIZE, N)
    masks = 1 / (1 + np.exp(-logits))
    ref = np.transpose(mix_pwr[..., None] * masks, (0, 3, 1, 2))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_separator_softmax_masks_sum_to_one(fresh_hparams):
    hp = fresh_hparams
    sep = hp.get_separator("dot-softmax-orig")(hp, "s")
    rng = np.random.RandomState(5)
    mix_pwr = np.ones((B, T, hp.FEATURE_SIZE), np.float32)
    attractors = rng.randn(B, N, hp.EMBED_SIZE).astype(np.float32)
    embed_flat = rng.randn(B, T * hp.FEATURE_SIZE, hp.EMBED_SIZE).astype(
        np.float32)
    out = np.asarray(sep.apply({}, jnp.asarray(mix_pwr),
                               jnp.asarray(attractors),
                               jnp.asarray(embed_flat)))
    # with unit mixture power, per-bin source powers sum to 1 (softmax)
    np.testing.assert_allclose(out.sum(axis=1),
                               np.ones((B, T, hp.FEATURE_SIZE)), atol=1e-5)


def test_danet_infer_estimator_assertion(fresh_hparams):
    hp = fresh_hparams
    hp.TRAIN_ESTIMATOR_METHOD = "anchor"
    hp.INFER_ESTIMATOR_METHOD = "truth"
    with pytest.raises(AssertionError):
        DaNet()


def test_danet_three_speakers(fresh_hparams):
    hp = fresh_hparams
    hp.MAX_N_SIGNAL = 3
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp, n=3)
    loss, aux = jax.jit(model.train_loss)(params, src, None)
    assert np.isfinite(float(loss))
    sep = model.separate(params, jnp.asarray(src.sum(axis=1)))
    assert sep.shape == (B, 3, T, hp.FEATURE_SIZE, 2)


def test_separate_wav_end_to_end(fresh_hparams):
    """Fused wav->separated-wavs inference path compiles and produces
    sane output shapes/finite values in one jitted program."""
    hp = fresh_hparams
    hp.BATCH_SIZE = 2
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    wav = np.random.RandomState(0).randn(2, 4000).astype(np.float32) * 0.1
    out = np.asarray(jax.jit(model.separate_wav)(params, jnp.asarray(wav)))
    from danet_tpu.ops.dsp import stft_frame_count
    t = stft_frame_count(4000, hp.FFT_SIZE, hp.FFT_STRIDE)
    assert out.shape == (2, hp.MAX_N_SIGNAL, t * hp.FFT_STRIDE)
    assert np.isfinite(out).all()


def test_valid_metrics_si_snr(fresh_hparams):
    hp = fresh_hparams
    hp.BATCH_SIZE = B
    hp.EVAL_SI_SNR = True
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    m = jax.jit(model.valid_metrics)(params, _src(hp))
    assert "SI_SNR" in m and np.isfinite(float(m["SI_SNR"]))


def test_reg_apply_changes_loss(fresh_hparams):
    from danet_tpu.models.danet import reg_loss
    hp = fresh_hparams
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    base, _ = model.train_loss(params, src, None)
    hp.REG_APPLY = True
    with_reg, _ = model.train_loss(params, src, None)
    expected = reg_loss(params, hp.REG_TYPE, hp.REG_SCALE)
    np.testing.assert_allclose(float(with_reg), float(base) + float(expected),
                               rtol=1e-5)
    # L1 also works; unknown type raises
    assert np.isfinite(float(reg_loss(params, "L1", 0.01)))
    with pytest.raises(ValueError):
        reg_loss(params, "L3", 0.01)


def test_dropout_through_model(fresh_hparams):
    """DROPOUT_KEEP_PROB < 1 changes the train-path output with an rng and
    is inert at validation (fixes the reference's disconnected dropout)."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.BATCH_SIZE = B
    hp.DROPOUT_KEEP_PROB = 0.5
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    l1, _ = model.train_loss(params, src, jax.random.PRNGKey(1))
    l2, _ = model.train_loss(params, src, jax.random.PRNGKey(2))
    assert float(l1) != float(l2)  # different dropout masks
    # valid path has no dropout: deterministic
    v1 = model.valid_metrics(params, src)["loss"]
    v2 = model.valid_metrics(params, src)["loss"]
    assert float(v1) == float(v2)


def test_legacy_cell_changes_encoder_output(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "lstm-orig"
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    l_std, _ = model.train_loss(params, src, None)
    hp.LSTM_LEGACY_CELL = True
    model2 = DaNet()
    l_leg, _ = model2.train_loss(params, src, None)
    assert float(l_std) != float(l_leg)


def test_anchor_aux_loss_trains_anchors(fresh_hparams):
    hp = fresh_hparams
    hp.BATCH_SIZE = B
    src = _src(hp)
    # without aux loss: zero anchor gradient (reference behavior)
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    g0 = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    assert float(jnp.abs(g0["infer_estimator"]["anchors"]).sum()) == 0.0
    # with aux loss: anchors receive gradient
    hp.ANCHOR_AUX_LOSS = 0.5
    g1 = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    assert float(jnp.abs(g1["infer_estimator"]["anchors"]).sum()) > 0.0


def test_separate_long_streaming(fresh_hparams):
    """Chunked long-form separation: shape, finiteness, and cross-chunk
    source consistency on a mixture of two disjoint-band sources."""
    hp = fresh_hparams
    hp.BATCH_SIZE = 4  # chunk count becomes the batch
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    t = 300  # forces multiple chunks with chunk=128
    lo = np.zeros((t, hp.FEATURE_SIZE), np.complex64)
    hi = np.zeros((t, hp.FEATURE_SIZE), np.complex64)
    lo[:, 5:20] = rng.randn(t, 15) + 1j * rng.randn(t, 15)
    hi[:, 60:75] = rng.randn(t, 15) + 1j * rng.randn(t, 15)
    mix = lo + hi
    mix_ri = np.stack([mix.real, mix.imag], -1).astype(np.float32)
    out = jax.jit(lambda p, x: model.separate_long(
        p, x, chunk_frames=128, overlap_frames=32))(params, mix_ri)
    out = np.asarray(out)
    assert out.shape == (hp.MAX_N_SIGNAL, t, hp.FEATURE_SIZE, 2)
    assert np.isfinite(out).all()
    # short inputs fall back to a single chunk
    out1 = np.asarray(model.separate_long(
        params, jnp.asarray(mix_ri[:100]), 128, 32))
    assert out1.shape == (hp.MAX_N_SIGNAL, 100, hp.FEATURE_SIZE, 2)


def test_remat_matches_no_remat(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    g_plain = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    hp.REMAT = True
    g_remat = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_plain),
                    jax.tree_util.tree_leaves(g_remat)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)


def test_kmeans_estimator(fresh_hparams):
    """k-means estimator: convergent weighted centroids, usable as the
    inference method end to end."""
    hp = fresh_hparams
    hp.BATCH_SIZE = B
    est = hp.get_estimator("kmeans")(hp, "e")
    params = est.init(jax.random.PRNGKey(0))
    embed, src_pwr, mix_pwr = _estimator_inputs(hp, seed=9)
    out = np.asarray(est.apply(params, jnp.asarray(embed),
                               mix_pwr=jnp.asarray(mix_pwr)))
    assert out.shape == (B, hp.MAX_N_SIGNAL, hp.EMBED_SIZE)
    assert np.isfinite(out).all()
    # full model with kmeans inference path
    hp.INFER_ESTIMATOR_METHOD = "kmeans"
    model = DaNet()
    p = model.init(jax.random.PRNGKey(1))
    m = jax.jit(model.valid_metrics)(p, _src(hp))
    assert np.isfinite(float(m["loss"]))


def test_gru_encoder_end_to_end(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "gru-v1"
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    loss, aux = jax.jit(model.train_loss)(params, _src(hp), None)
    assert np.isfinite(float(loss))


def test_attention_encoder_end_to_end(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 64
    hp.ATTN_LAYERS = 2
    hp.ATTN_HEADS = 4
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    loss, aux = jax.jit(model.train_loss)(params, src, None)
    assert np.isfinite(float(loss))
    g = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    gsum = sum(float(jnp.abs(x).sum())
               for x in jax.tree_util.tree_leaves(g["encoder"]))
    assert np.isfinite(gsum) and gsum > 0
    # dropout path
    hp.DROPOUT_KEEP_PROB = 0.8
    l1, _ = model.train_loss(params, src, jax.random.PRNGKey(1))
    l2, _ = model.train_loss(params, src, jax.random.PRNGKey(2))
    assert float(l1) != float(l2)


def _small_tcn(hp):
    hp.TCN_DIM = 32
    hp.TCN_HIDDEN = 48
    hp.TCN_BLOCKS = 3
    hp.TCN_REPEATS = 2


def test_tcn_encoder_end_to_end(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "tcn-v1"
    _small_tcn(hp)
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    loss, aux = jax.jit(model.train_loss)(params, src, None)
    assert np.isfinite(float(loss))
    g = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    gsum = sum(float(jnp.abs(x).sum())
               for x in jax.tree_util.tree_leaves(g["encoder"]))
    assert np.isfinite(gsum) and gsum > 0
    # dropout path draws per-block masks
    hp.DROPOUT_KEEP_PROB = 0.8
    l1, _ = model.train_loss(params, src, jax.random.PRNGKey(1))
    l2, _ = model.train_loss(params, src, jax.random.PRNGKey(2))
    assert float(l1) != float(l2)


def test_tcn_stream_hidden_chunk_continuation(fresh_hparams):
    """Causal TCN streaming: splitting a sequence into chunks with carried
    tail buffers reproduces the one-shot causal forward exactly."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "tcn-v1"
    _small_tcn(hp)
    hp.TCN_CAUSAL = True
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(5).randn(
        2, 40, hp.FEATURE_SIZE).astype(np.float32))
    full, _ = enc.stream_hidden(
        params, x, enc.stream_state_init(2))
    state = enc.stream_state_init(2)
    outs = []
    for lo, hi in ((0, 13), (13, 26), (26, 40)):  # uneven chunking
        h, state = enc.stream_hidden(params, x[:, lo:hi], state)
        outs.append(h)
    chunked = jnp.concatenate(outs, axis=1)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               atol=1e-5, rtol=1e-5)


def _small_dprnn(hp):
    hp.DPRNN_DIM = 24
    hp.DPRNN_HIDDEN = 16
    hp.DPRNN_CHUNK = 8
    hp.DPRNN_BLOCKS = 2


def test_dprnn_segment_merge_roundtrip(fresh_hparams):
    """Count-normalized overlap-add inverts the half-overlap segmentation
    exactly, including when T is not a multiple of the hop."""
    from danet_tpu.models.encoders import DprnnEncoder
    for t in (16, 19, 8, 5):
        x = jnp.asarray(np.random.RandomState(t).randn(
            3, t, 6).astype(np.float32))
        chunks, seg = DprnnEncoder._segment(x, min(8, t))
        back = DprnnEncoder._merge(chunks, seg)
        np.testing.assert_allclose(np.asarray(back), np.asarray(x),
                                   atol=1e-6)


def test_dprnn_encoder_end_to_end(fresh_hparams):
    """dprnn-v1 trains through the full DaNet objective; the online
    (inter-causal) variant differs from the offline one."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "dprnn-v1"
    _small_dprnn(hp)
    hp.BATCH_SIZE = B
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = _src(hp)
    loss, aux = jax.jit(model.train_loss)(params, src, None)
    assert np.isfinite(float(loss))
    g = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    gsum = sum(float(jnp.abs(x).sum())
               for x in jax.tree_util.tree_leaves(g["encoder"]))
    assert np.isfinite(gsum) and gsum > 0
    # dropout draws per-path masks
    hp.DROPOUT_KEEP_PROB = 0.8
    l1, _ = model.train_loss(params, src, jax.random.PRNGKey(1))
    l2, _ = model.train_loss(params, src, jax.random.PRNGKey(2))
    assert float(l1) != float(l2)
    # online variant: unidirectional inter-chunk LSTM (different params)
    hp.DPRNN_INTER_CAUSAL = True
    enc = hp.get_encoder()(hp, "e")
    p2 = enc.init(jax.random.PRNGKey(0))
    assert p2["block0"]["inter"]["wx"].shape[0] == hp.DPRNN_DIM
    out = enc.apply(p2, jnp.asarray(np.random.RandomState(1).randn(
        B, T, hp.FEATURE_SIZE).astype(np.float32)))
    assert out.shape == (B, T, hp.FEATURE_SIZE, hp.EMBED_SIZE)
    assert np.isfinite(np.asarray(out)).all()


def test_dprnn_stream_hidden_chunk_continuation(fresh_hparams):
    """Online DPRNN (causal inter-chunk RNN, non-overlapping segments):
    chunked streaming with carried inter state reproduces the one-shot
    forward; separate_stream output is chunk-size invariant."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "dprnn-v1"
    _small_dprnn(hp)
    hp.DPRNN_HOP = hp.DPRNN_CHUNK
    hp.DPRNN_INTER_CAUSAL = True
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(5).randn(
        2, 48, hp.FEATURE_SIZE).astype(np.float32))
    full, _ = enc.stream_hidden(params, x, enc.stream_state_init(2))
    state = enc.stream_state_init(2)
    outs = []
    for lo, hi in ((0, 16), (16, 24), (24, 48)):  # segment-aligned chunks
        h, state = enc.stream_hidden(params, x[:, lo:hi], state)
        outs.append(h)
    chunked = jnp.concatenate(outs, axis=1)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               atol=1e-5, rtol=1e-5)
    # unaligned chunks are rejected
    with pytest.raises(ValueError):
        enc.stream_hidden(params, x[:, :12], enc.stream_state_init(2))

    from danet_tpu.models import DaNet
    model = DaNet()
    p = model.init(jax.random.PRNGKey(1))
    mix = jnp.asarray(np.random.RandomState(7).randn(
        40, hp.FEATURE_SIZE, 2).astype(np.float32))
    out8 = model.separate_stream(p, mix, chunk_frames=8, warmup_frames=16)
    out16 = model.separate_stream(p, mix, chunk_frames=16,
                                  warmup_frames=16)
    assert out8.shape == (2, 40, hp.FEATURE_SIZE, 2)
    np.testing.assert_allclose(np.asarray(out8), np.asarray(out16),
                               atol=1e-5)
    # misaligned chunk_frames is rejected up front
    with pytest.raises(ValueError):
        model.separate_stream(p, mix, chunk_frames=12, warmup_frames=16)


def test_dprnn_stream_requires_online_config(fresh_hparams):
    """Offline DPRNN configs (overlapping segments or bidirectional
    inter-chunk RNN) cannot stream."""
    from danet_tpu.models import DaNet
    hp = fresh_hparams
    hp.ENCODER_TYPE = "dprnn-v1"
    _small_dprnn(hp)
    model = DaNet()
    p = model.init(jax.random.PRNGKey(0))
    mix = jnp.asarray(np.random.RandomState(0).randn(
        24, hp.FEATURE_SIZE, 2).astype(np.float32))
    with pytest.raises(ValueError):
        model.separate_stream(p, mix, chunk_frames=8, warmup_frames=8)
    hp.DPRNN_INTER_CAUSAL = True  # still overlapping: hop != chunk
    with pytest.raises(ValueError):
        DaNet().separate_stream(p, mix, chunk_frames=8, warmup_frames=8)


def test_attention_padding_invariance(fresh_hparams):
    """Zero-padded frames must not change real frames' embeddings."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 64
    hp.ATTN_LAYERS = 2
    hp.BATCH_SIZE = B
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(0))
    x = np.abs(np.random.RandomState(0).randn(
        B, 24, hp.FEATURE_SIZE)).astype(np.float32) + 0.1
    base = np.asarray(enc.apply(params, jnp.asarray(x)))[:, :24]
    xp = np.pad(x, [(0, 0), (0, 16), (0, 0)])  # bucket-style zero pad
    padded = np.asarray(enc.apply(params, jnp.asarray(xp)))[:, :24]
    np.testing.assert_allclose(padded, base, atol=1e-4)


def test_attention_dim_validation(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 255
    with pytest.raises(ValueError):
        hp.get_encoder()(hp, "e").init(jax.random.PRNGKey(0))
    hp.ATTN_DIM = 256
    hp.ATTN_HEADS = 6
    with pytest.raises(ValueError):
        hp.get_encoder()(hp, "e").init(jax.random.PRNGKey(0))


def test_separate_wav_matches_host_dsp(fresh_hparams):
    """Device wav->wav pipeline == host scipy STFT + device separate +
    host iSTFT (integration of the DSP parity guarantees)."""
    from danet_tpu.data import audio
    hp = fresh_hparams
    hp.BATCH_SIZE = 1
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    wav = (np.random.RandomState(0).randn(4000) * 0.1).astype(np.float32)
    device = np.asarray(jax.jit(model.separate_wav)(
        params, jnp.asarray(wav[None])))[0]

    z = audio.stft_np(wav)
    sep_ri = np.asarray(model.separate(
        params, jnp.asarray(audio.to_ri(z[None]))))[0]
    host = np.stack([
        audio.istft_np(audio.from_ri(s)) for s in sep_ri])
    np.testing.assert_allclose(device, host, atol=1e-4)


def test_separate_wav_flagship_batch_matches_host_dsp(fresh_hparams):
    """The serving path of the flagship (bilstm-orig, batch 2, a length
    that is not a multiple of the stride): output shape, and each row ==
    host scipy STFT + device separate + host iSTFT of that row."""
    from danet_tpu.data import audio
    from danet_tpu.ops.dsp import stft_frame_count
    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.BATCH_SIZE = 2
    model = DaNet()
    params = model.init(jax.random.PRNGKey(1))
    wav = (np.random.RandomState(1).randn(2, 3001) * 0.1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        device = np.asarray(jax.jit(model.separate_wav)(
            params, jnp.asarray(wav)))
        t = stft_frame_count(3001, hp.FFT_SIZE, hp.FFT_STRIDE)
        assert device.shape == (2, hp.MAX_N_SIGNAL, t * hp.FFT_STRIDE)
        z = np.stack([audio.stft_np(w) for w in wav])
        sep_ri = np.asarray(model.separate(
            params, jnp.asarray(audio.to_ri(z))))
    for row in range(2):
        host = np.stack([audio.istft_np(audio.from_ri(s))
                         for s in sep_ri[row]])
        np.testing.assert_allclose(device[row], host, atol=1e-4)


def test_apply_debug_without_tap_kwarg(fresh_hparams):
    """User encoders that predate the tap hook (no tap kwarg) must still
    work through apply_debug — they just contribute no fetches."""
    import jax.numpy as jnp
    import numpy as np
    from danet_tpu.models.base import Encoder

    class Legacy(Encoder):
        def init(self, rng):
            return {}

        def apply(self, params, log_spectra, train=False, rng=None):
            hp = self.hp
            b, t = log_spectra.shape[:2]
            return jnp.zeros((b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE))

    hp = fresh_hparams
    enc = Legacy(hp, "legacy")
    x = np.zeros((1, 4, hp.FEATURE_SIZE), np.float32)
    embed, fetches = enc.apply_debug({}, x)
    assert embed.shape == (1, 4, hp.FEATURE_SIZE, hp.EMBED_SIZE)
    assert fetches == {}


@pytest.mark.parametrize("enc", ["lstm-orig", "gru-v1", "tcn-v1",
                                 "attn-v1"])
def test_separate_stream_chunk_invariance(fresh_hparams, enc):
    """Causal streaming separation: carried encoder state (RNN carry, or
    TCN conv-tail buffers) makes the output EXACTLY invariant to the chunk
    size (state continuation reproduces the full-sequence forward);
    warmup stats/attractors are frozen identically."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = enc
    hp.BATCH_SIZE = 1
    if enc == "tcn-v1":
        _small_tcn(hp)
        hp.TCN_CAUSAL = True
    if enc == "attn-v1":
        _small_attn_causal(hp)
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    t = 40
    mix = jnp.asarray(np.random.RandomState(3).randn(
        t, hp.FEATURE_SIZE, 2).astype(np.float32))
    out_big = model.separate_stream(params, mix, chunk_frames=24,
                                    warmup_frames=16)
    out_small = model.separate_stream(params, mix, chunk_frames=4,
                                      warmup_frames=16)
    assert out_big.shape == (hp.MAX_N_SIGNAL, t, hp.FEATURE_SIZE, 2)
    np.testing.assert_allclose(np.asarray(out_small), np.asarray(out_big),
                               atol=2e-5, rtol=1e-4)
    # padding path: T not divisible by the chunk size
    out_pad = model.separate_stream(params, mix, chunk_frames=7,
                                    warmup_frames=16)
    np.testing.assert_allclose(np.asarray(out_pad), np.asarray(out_big),
                               atol=2e-5, rtol=1e-4)


def test_separate_stream_rejects_noncausal(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    mix = jnp.zeros((8, hp.FEATURE_SIZE, 2))
    with pytest.raises(ValueError, match="causal"):
        model.separate_stream(params, mix)
    # tcn-v1 without TCN_CAUSAL is non-causal (SAME-padded convs)
    hp.ENCODER_TYPE = "tcn-v1"
    _small_tcn(hp)
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="causal"):
        model.separate_stream(params, mix)


def test_dc_aux_loss_changes_loss_and_grad(fresh_hparams):
    """DC_LOSS_WEIGHT>0 adds the scale-matched deep-clustering auxiliary:
    the contribution is exactly dc_w x |primary loss| in value (the
    stop-gradient ratio normalization — a fixed absolute weight cannot be
    calibrated across objectives whose scales differ by orders of
    magnitude), the encoder still receives finite gradients, and the
    gradient DIRECTION depends on the bin weighting; weight 0 is exactly
    the base objective."""
    hp = fresh_hparams
    hp.BATCH_SIZE = B
    src = _src(hp)
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    l0, aux0 = model.train_loss(params, src, None)
    assert "dc" not in aux0
    hp.DC_LOSS_WEIGHT = 1.0
    l1, aux1 = model.train_loss(params, src, None)
    # relative semantics: contribution == dc_w * |primary| exactly
    np.testing.assert_allclose(float(l1), 2.0 * float(l0), rtol=1e-5)
    assert float(aux1["dc"]) > 0.0  # raw DC value exposed for diagnostics
    g1 = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    leaves = jax.tree_util.tree_leaves(g1["encoder"])
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    # unweighted variant: same loss VALUE by construction, but the DC
    # gradient direction must differ from the magnitude-ratio weighting
    hp.DC_WEIGHT_TYPE = "none"
    l2, _ = model.train_loss(params, src, None)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    g2 = jax.grad(lambda p: model.train_loss(p, src, None)[0])(params)
    diffs = [float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
             for a, b in zip(jax.tree_util.tree_leaves(g1["encoder"]),
                             jax.tree_util.tree_leaves(g2["encoder"]))]
    assert max(diffs) > 0.0


def _small_attn_causal(hp):
    hp.ATTN_DIM = 32
    hp.ATTN_HEADS = 4
    hp.ATTN_LAYERS = 2
    hp.ATTN_CAUSAL = True
    hp.ATTN_LOOKBACK = 12


def test_attn_causal_banded_attention(fresh_hparams):
    """ATTN_CAUSAL windowed attention: frame t's embedding is unchanged
    by FUTURE frames (causality) and — with one layer — by frames older
    than ATTN_LOOKBACK (bandedness).  Perturbations are sum-preserving
    (+d on one frame, -d on another) so apply()'s global mean-centering
    statistic stays fixed and the comparison isolates the band mask."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    _small_attn_causal(hp)
    hp.ATTN_LAYERS = 1  # receptive field == the band itself
    hp.digest()
    from danet_tpu.models.encoders import AttentionEncoder
    enc = AttentionEncoder(hp, "enc")
    params = enc.init(jax.random.PRNGKey(0))
    t, w = 32, hp.ATTN_LOOKBACK
    x = np.random.RandomState(0).randn(1, t, hp.FEATURE_SIZE) \
        .astype(np.float32) + 3.0  # offset: no accidental zero frames
    base = np.asarray(enc.apply(params, jnp.asarray(x)))

    probe = 20
    fut = x.copy()
    fut[:, probe + 2] += 5.0    # two future frames change, sum preserved
    fut[:, probe + 4] -= 5.0
    got = np.asarray(enc.apply(params, jnp.asarray(fut)))
    np.testing.assert_allclose(got[:, :probe + 1], base[:, :probe + 1],
                               atol=2e-5, rtol=1e-5)
    assert np.abs(got[:, probe + 2] - base[:, probe + 2]).max() > 1e-3

    old = x.copy()
    old[:, 2] += 5.0            # frames outside probe's lookback window
    old[:, 4] -= 5.0            # (probe - w + 1 = 9 > 4), sum preserved
    got = np.asarray(enc.apply(params, jnp.asarray(old)))
    np.testing.assert_allclose(got[:, probe:], base[:, probe:],
                               atol=2e-5, rtol=1e-5)
    assert np.abs(got[:, 2] - base[:, 2]).max() > 1e-3


def test_attn_apply_uses_external_causal_attn_fn(fresh_hparams):
    """ATTN_CAUSAL + an externally supplied attn_fn declaring
    attn_fn_is_causal=True (the DaNet.separate_sp path) must actually
    CALL that attn_fn.  Regression: the single-program causal branch
    used to overwrite it with dense banded attention, silently
    discarding the sequence-parallel collective (and its memory
    scaling) while producing numerically identical outputs."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    _small_attn_causal(hp)
    hp.digest()
    from danet_tpu.models.encoders import AttentionEncoder
    from danet_tpu.ops import nn as nn_ops
    enc = AttentionEncoder(hp, "enc")
    params = enc.init(jax.random.PRNGKey(0))
    t = 16
    x = jnp.asarray(np.random.RandomState(0).randn(
        1, t, hp.FEATURE_SIZE).astype(np.float32) + 1.0)
    w = enc._causal_window()
    band = nn_ops.causal_band(jnp.arange(t)[:, None],
                              jnp.arange(t)[None, :], w)
    calls = []

    def counting_causal_attn(q, k, v, key_mask):
        calls.append(1)
        return enc._dense_attention(q, k, v, key_mask, band=band)

    out = np.asarray(enc.apply(params, x, attn_fn=counting_causal_attn,
                               attn_fn_is_causal=True))
    assert len(calls) == int(hp.ATTN_LAYERS), calls
    # identical band semantics: equals the plain causal forward
    ref = np.asarray(enc.apply(params, x))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_attn_lookback_zero_rejected(fresh_hparams):
    """An explicit ATTN_LOOKBACK=0 must hit the >= 1 guard, not be
    silently coerced to the 128-frame default (regression: `0 or 128`
    made the guard unreachable from config)."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    _small_attn_causal(hp)
    hp.ATTN_LOOKBACK = 0
    hp.digest()
    from danet_tpu.models.encoders import AttentionEncoder
    enc = AttentionEncoder(hp, "enc")
    with pytest.raises(ValueError, match="ATTN_LOOKBACK"):
        enc._causal_window()


def test_attn_causal_guards(fresh_hparams):
    """Causality cannot be silently dropped: an external attn_fn that
    does not declare band handling is rejected, and the stream hooks
    refuse a non-causal (bidirectional) configuration."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    _small_attn_causal(hp)
    hp.digest()
    from danet_tpu.models.encoders import AttentionEncoder
    enc = AttentionEncoder(hp, "enc")
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.zeros((1, 16, hp.FEATURE_SIZE))
    with pytest.raises(ValueError, match="attn_fn"):
        enc.apply(params, x, attn_fn=enc._dense_attention)
    # non-causal attention must refuse the stream hooks
    hp.ATTN_CAUSAL = False
    with pytest.raises(ValueError, match="ATTN_CAUSAL"):
        enc.stream_state_init(1)


@pytest.mark.parametrize("family", ["attn-v1", "moe-v1", "moe-topk"])
def test_attn_stream_matches_full_causal_forward(fresh_hparams, family):
    """Chunked streaming with the K/V cache == the full-sequence causal
    forward, across chunk boundaries and beyond the lookback window.
    Covers the MoE subclass too (inherited hooks route through its
    expert MLP — dense soft-mixture and top-k routed)."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1" if family == "attn-v1" else "moe-v1"
    _small_attn_causal(hp)
    if family != "attn-v1":
        hp.MOE_EXPERTS = 4
        if family == "moe-topk":
            hp.MOE_TOP_K = 2
    hp.digest()
    enc = hp.get_encoder()(hp, "enc")
    params = enc.init(jax.random.PRNGKey(1))
    t = 48  # > 2 * lookback: the cache rolls over several times
    x = jnp.asarray(np.random.RandomState(1).randn(
        1, t, hp.FEATURE_SIZE).astype(np.float32) + 1.0)

    # full causal forward through the stream hooks in ONE chunk
    full, _ = enc.stream_hidden(params, x, enc.stream_state_init(1))
    # chunked: 4 + 11 + 33 (irregular sizes cross the window boundary)
    state = enc.stream_state_init(1)
    outs = []
    for beg, end in ((0, 4), (4, 15), (15, 48)):
        h, state = enc.stream_hidden(params, x[:, beg:end], state)
        outs.append(h)
    np.testing.assert_allclose(
        np.asarray(jnp.concatenate(outs, axis=1)), np.asarray(full),
        atol=2e-5, rtol=1e-4)

    # and the hooks agree with apply() modulo its masked centering:
    # pre-center the input exactly as apply does (no zero frames here)
    mu = jnp.mean(x, axis=(1, 2), keepdims=True)
    h_stream, _ = enc.stream_hidden(
        params, x - mu, enc.stream_state_init(1))
    want = enc.apply(params, x)
    got = enc.stream_head(params, h_stream, 0.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


# ---- chunked banded attention (ops/local_attention.py) ----------------

def _banded_ref(q, k, v, key_mask, window):
    """Dense banded oracle via the encoder's own dense path."""
    from danet_tpu.models.encoders import AttentionEncoder
    from danet_tpu.ops import nn as nn_ops
    t = q.shape[1]
    band = nn_ops.causal_band(jnp.arange(t)[:, None],
                              jnp.arange(t)[None, :], window)
    return AttentionEncoder._dense_attention(q, k, v, key_mask, band=band)


def test_banded_chunked_matches_dense(fresh_hparams):
    """banded_attention_chunked == dense causal_band attention (fwd and
    gradients) across window/chunk geometries, incl. windows that do not
    divide T and chunk == window-1 (the minimum coverage chunk)."""
    from danet_tpu.ops.local_attention import banded_attention_chunked
    rng = np.random.RandomState(0)
    b, h, d = 2, 3, 8
    for t, w, c in [(24, 5, 4), (24, 12, 12), (32, 8, 8), (30, 7, 6),
                    (16, 1, 4), (16, 16, None)]:
        q, k, v = (jnp.asarray(rng.randn(b, t, h, d).astype(np.float32))
                   for _ in range(3))
        km = jnp.ones((b, t), bool)
        ref = np.asarray(_banded_ref(q, k, v, km, w))
        got = np.asarray(banded_attention_chunked(q, k, v, km, w, chunk=c))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5,
                                   err_msg="t=%d w=%d c=%r" % (t, w, c))

    # gradients (sum-of-squares consumer) match the dense path
    t, w, c = 24, 5, 4
    q, k, v = (jnp.asarray(rng.randn(b, t, h, d).astype(np.float32))
               for _ in range(3))
    km = jnp.ones((b, t), bool)
    g_ref = jax.grad(lambda a, b_, c_: jnp.sum(jnp.square(
        _banded_ref(a, b_, c_, km, w))), argnums=(0, 1, 2))(q, k, v)
    g_got = jax.grad(lambda a, b_, c_: jnp.sum(jnp.square(
        banded_attention_chunked(a, b_, c_, km, w, chunk=c))),
        argnums=(0, 1, 2))(q, k, v)
    for gr, gg in zip(g_ref, g_got):
        np.testing.assert_allclose(np.asarray(gg), np.asarray(gr),
                                   atol=1e-5, rtol=1e-5)


def test_banded_chunked_key_padding(fresh_hparams):
    """Padded keys are invisible; real-query rows match the dense path
    even with tail padding (padded-query rows are garbage in both paths
    and excluded, as in the flash wrapper's contract)."""
    from danet_tpu.ops.local_attention import banded_attention_chunked
    rng = np.random.RandomState(1)
    b, t, h, d, w, c = 2, 24, 2, 8, 6, 6
    q, k, v = (jnp.asarray(rng.randn(b, t, h, d).astype(np.float32))
               for _ in range(3))
    km = jnp.asarray(np.arange(t)[None, :] < np.array([[24], [17]]))
    ref = np.asarray(_banded_ref(q, k, v, km, w))
    got = np.asarray(banded_attention_chunked(q, k, v, km, w, chunk=c))
    real = np.asarray(km)
    np.testing.assert_allclose(got[real], ref[real], atol=1e-5, rtol=1e-5)


def test_banded_pick_chunk_and_resolve(fresh_hparams):
    """pick_chunk returns the smallest covering divisor; resolve honors
    ATTN_LOCAL_CHUNK = -1 (dense) / 0 (auto, >= 8 chunks) / N (forced)."""
    from danet_tpu.ops import local_attention as la
    assert la.pick_chunk(24, 5) == 4       # smallest divisor >= w-1
    assert la.pick_chunk(24, 13) == 12
    assert la.pick_chunk(16, 16) == 16     # degenerate single chunk
    assert la.pick_chunk(7, 7) == 7        # prime t: only c = t covers

    hp = fresh_hparams
    dense_calls = []

    def dense_fn(q, k, v, km, band=None):
        dense_calls.append(1)
        return q

    hp.ATTN_LOCAL_CHUNK = -1
    fn = la.resolve_banded_attn_fn(hp, 512, 16, dense_fn)
    fn(jnp.zeros((1, 512, 1, 4)), jnp.zeros((1, 512, 1, 4)),
       jnp.zeros((1, 512, 1, 4)), jnp.ones((1, 512), bool))
    assert dense_calls  # -1 forces dense

    hp.ATTN_LOCAL_CHUNK = 0
    fn = la.resolve_banded_attn_fn(hp, 512, 16, dense_fn)
    assert fn.func is la.banded_attention_chunked  # auto engages at 512
    fn_short = la.resolve_banded_attn_fn(hp, 24, 16, dense_fn)
    assert getattr(fn_short, "func", None) is not \
        la.banded_attention_chunked  # < 4 chunks stays dense

    hp.ATTN_LOCAL_CHUNK = 64
    fn = la.resolve_banded_attn_fn(hp, 512, 16, dense_fn)
    assert fn.keywords["chunk"] == 64


def test_attn_encoder_chunked_causal_matches_dense(fresh_hparams):
    """Full AttentionEncoder.apply with the auto-chunked causal path
    (long T) equals the forced-dense banded forward."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    _small_attn_causal(hp)
    hp.ATTN_LOOKBACK = 16
    hp.digest()
    from danet_tpu.models.encoders import AttentionEncoder
    enc = AttentionEncoder(hp, "enc")
    params = enc.init(jax.random.PRNGKey(0))
    t = 128  # pick_chunk(128, 16) = 16 -> 8 chunks, auto engages
    x = jnp.asarray(np.random.RandomState(2).randn(
        2, t, hp.FEATURE_SIZE).astype(np.float32) + 1.0)
    got = np.asarray(enc.apply(params, x))
    hp.ATTN_LOCAL_CHUNK = -1
    ref = np.asarray(enc.apply(params, x))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("enc", ["toy", "lstm-orig", "bilstm-orig",
                                 "conv-bilstm-v1", "attn-v1", "gru-v1",
                                 "moe-v1", "tcn-v1", "dprnn-v1"])
def test_train_grads_under_bf16(fresh_hparams, enc):
    """Every encoder family must take gradients under COMPUTE_DTYPE=
    bfloat16 — the production training dtype.  Regression: conv2d_apply's
    f32-output override made the conv VJP see an f32 cotangent against
    bf16 operands, so conv-bilstm-v1 could not train in bf16 at all
    (forward-only unit tests never caught it)."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = enc
    hp.BATCH_SIZE = B
    hp.COMPUTE_DTYPE = "bfloat16"
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = jnp.asarray(_src(hp))
    (loss, _), grads = jax.value_and_grad(model.train_loss, has_aux=True)(
        params, src, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))
    flat = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    assert all(np.isfinite(g).all() for g in flat)
    assert any(np.abs(g).max() > 0 for g in flat)
