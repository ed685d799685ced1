"""AOT serving artifact tests: export -> deserialize -> numerical parity
with the live model, bucket padding/trimming, manifest validation.

The reference has no serving surface at all (demo mode only,
main.py:655-716); serve.py is the production path.
"""
import json
import os

import jax
import numpy as np
import pytest

from danet_tpu.hparams import hparams
from danet_tpu import serve


@pytest.fixture()
def tiny_model():
    import danet_tpu  # noqa: F401 (registries)
    from danet_tpu.models import DaNet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = "toy"
    hparams.BATCH_SIZE = 1
    hparams.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    return model, params


def test_export_roundtrip_matches_live_model(tiny_model, tmp_path):
    model, params = tiny_model
    out_dir = str(tmp_path / "artifact")
    manifest = serve.export_separator(
        model, params, out_dir, lengths=[4096, 8192], batch=1)
    assert manifest["lengths"] == [4096, 8192]
    assert os.path.exists(os.path.join(out_dir, "manifest.json"))

    bundle = serve.load_separator(out_dir)
    assert bundle.lengths == [4096, 8192]

    wav = np.random.RandomState(0).randn(3000).astype(np.float32) * 0.1
    got = bundle.separate(wav)
    assert got.shape[0] == hparams.MAX_N_SIGNAL
    assert got.shape[1] <= 3000

    # live model on the same zero-padded bucket must match exactly
    padded = np.zeros((1, 4096), dtype=np.float32)
    padded[0, :3000] = wav
    want = np.asarray(jax.jit(
        lambda w: model.separate_wav(params, w))(padded))[0]
    np.testing.assert_allclose(got, want[:, :got.shape[1]],
                               rtol=1e-5, atol=1e-6)


def test_export_does_not_mutate_shared_hparams(tiny_model, tmp_path):
    """Exports drop training-time MESH_* strategies on a COPY of the
    config — the caller's shared hparams must be left untouched
    (advisor r1: the old save/restore pattern was not reentrant and
    leaked mid-export state to concurrent readers)."""
    model, params = tiny_model
    hparams.MESH_SEQ = 2
    serve.export_separator(model, params, str(tmp_path / "a"),
                           lengths=[4096], platforms=["cpu"])
    assert hparams.MESH_SEQ == 2
    assert model.hp.MESH_SEQ == 2  # caller's model untouched too


def test_bucket_selection_and_errors(tiny_model, tmp_path):
    model, params = tiny_model
    out_dir = str(tmp_path / "artifact")
    serve.export_separator(model, params, out_dir, lengths=[4096], batch=1)
    bundle = serve.load_separator(out_dir)

    with pytest.raises(ValueError, match="exceeds the largest"):
        bundle.separate(np.zeros(10000, dtype=np.float32))
    with pytest.raises(ValueError, match="batch=1"):
        bundle.separate(np.zeros((2, 1000), dtype=np.float32))
    # batched rank-2 request of the exported batch size works
    out = bundle.separate(np.zeros((1, 1000), dtype=np.float32))
    assert out.ndim == 3 and out.shape[0] == 1


def test_manifest_format_guard(tmp_path):
    os.makedirs(tmp_path / "bad", exist_ok=True)
    with open(tmp_path / "bad" / "manifest.json", "w") as f:
        json.dump({"format": "something-else"}, f)
    with pytest.raises(ValueError, match="not a danet-tpu serving"):
        serve.load_separator(str(tmp_path / "bad"))


def test_partial_restore_rejects_wrong_architecture(tiny_model, tmp_path):
    """A checkpoint from a different config must fail partial restore with
    a clear error, not deep inside export tracing."""
    from danet_tpu.train import checkpoint as ckpt_lib
    model, params = tiny_model
    path = str(tmp_path / "ckpt")
    ckpt_lib.save_checkpoint(path, {"params": params, "step": 3})

    import jax.numpy as jnp
    bad = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape + (2,), x.dtype), params)
    with pytest.raises(ValueError, match="architecture"):
        ckpt_lib.load_checkpoint(path, {"params": bad}, partial=True)
    with pytest.raises(KeyError, match="lacks keys"):
        ckpt_lib.load_checkpoint(path, {"nonexistent": 1}, partial=True)
    # correct template round-trips and selects only the requested key
    got = ckpt_lib.load_checkpoint(path, {"params": params}, partial=True)
    assert set(got) == {"params"}


def test_load_wav_raw_scaling(tmp_path):
    """Integer PCM of every width loads to the same +-1.0-scale float."""
    import scipy.io.wavfile
    from danet_tpu.data import audio
    t = np.arange(4000)
    wav = 0.5 * np.sin(2 * np.pi * 440 * t / 8000.0)
    cases = {
        "i16.wav": (wav * 32767).astype(np.int16),
        "i32.wav": (wav * 2147483647).astype(np.int32),
        "u8.wav": ((wav * 127) + 128).astype(np.uint8),
        "f32.wav": wav.astype(np.float32),
    }
    for name, pcm in cases.items():
        path = str(tmp_path / name)
        scipy.io.wavfile.write(path, 8000, pcm)
        got = audio.load_wav_raw(path, 8000)
        peak = float(np.max(np.abs(got)))
        assert 0.4 < peak < 0.6, (name, peak)
        assert abs(float(np.mean(got))) < 0.01, (name, "dc offset")


def test_export_attn_encoder_roundtrip(tmp_path):
    """Serving export of the transformer encoder (tiny dims)."""
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = "attn-v1"
    hparams.ATTN_DIM = 32
    hparams.ATTN_HEADS = 2
    hparams.ATTN_LAYERS = 1
    hparams.BATCH_SIZE = 1
    hparams.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    out_dir = str(tmp_path / "attn")
    serve.export_separator(model, params, out_dir, lengths=[4096], batch=1)
    bundle = serve.load_separator(out_dir)
    wav = np.random.RandomState(0).randn(4096).astype(np.float32) * 0.1
    got = bundle.separate(wav)
    want = np.asarray(jax.jit(
        lambda w: model.separate_wav(params, w))(wav[None]))[0]
    np.testing.assert_allclose(got, want[:, :got.shape[1]],
                               rtol=1e-5, atol=1e-6)


def test_export_kmeans_inference_estimator(tmp_path):
    """The shipping inference config (configs/shipping.json) uses the kmeans
    estimator; its unrolled-fori refinement must export cleanly."""
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = "toy"
    hparams.INFER_ESTIMATOR_METHOD = "kmeans"
    hparams.BATCH_SIZE = 1
    hparams.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    out_dir = str(tmp_path / "km")
    serve.export_separator(model, params, out_dir, lengths=[4096], batch=1)
    bundle = serve.load_separator(out_dir)
    assert bundle.manifest["infer_estimator"] == "kmeans"
    wav = np.random.RandomState(0).randn(4096).astype(np.float32) * 0.1
    got = bundle.separate(wav)
    want = np.asarray(jax.jit(
        lambda w: model.separate_wav(params, w))(wav[None]))[0]
    np.testing.assert_allclose(got, want[:, :got.shape[1]],
                               rtol=1e-5, atol=1e-6)


def _small_causal_config(encoder: str) -> None:
    if encoder == "tcn-v1":
        hparams.ENCODER_TYPE = "tcn-v1"
        hparams.TCN_CAUSAL = True
        hparams.TCN_DIM = 16
        hparams.TCN_HIDDEN = 24
        hparams.TCN_BLOCKS = 2
        hparams.TCN_REPEATS = 1
    elif encoder == "attn-v1":
        hparams.ENCODER_TYPE = "attn-v1"
        hparams.ATTN_CAUSAL = True
        hparams.ATTN_LOOKBACK = 8
        hparams.ATTN_DIM = 32
        hparams.ATTN_HEADS = 4
        hparams.ATTN_LAYERS = 2
    else:
        hparams.ENCODER_TYPE = "dprnn-v1"
        hparams.DPRNN_DIM = 16
        hparams.DPRNN_HIDDEN = 12
        hparams.DPRNN_CHUNK = 4
        hparams.DPRNN_HOP = 4
        hparams.DPRNN_BLOCKS = 2
        hparams.DPRNN_INTER_CAUSAL = True


@pytest.mark.parametrize("encoder", ["tcn-v1", "dprnn-v1", "attn-v1"])
def test_export_streamer_roundtrip(tmp_path, encoder):
    """Streaming artifact: warmup+step programs reproduce the live
    stream_init/stream_step pipeline exactly, state threading included
    (conv-tail buffers for the causal TCN, per-position inter-chunk
    carries for the online DPRNN)."""
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hparams.load_json(os.path.join(repo, "default.json"))
    _small_causal_config(encoder)
    hparams.BATCH_SIZE = 1
    hparams.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))

    stride = hparams.FFT_STRIDE
    warm_n, chunk_n = 8 * stride, 4 * stride
    out_dir = str(tmp_path / "stream")
    manifest = serve.export_streamer(
        model, params, out_dir, chunk_samples=chunk_n,
        warmup_samples=warm_n, batch=1)
    assert manifest["latency_samples"] == hparams.FFT_SIZE - stride

    rng = np.random.RandomState(0)
    warm = rng.randn(1, warm_n).astype(np.float32) * 0.1
    chunks = [rng.randn(1, chunk_n).astype(np.float32) * 0.1
              for _ in range(3)]

    bundle = serve.load_streamer(out_dir)
    got = [bundle.start(warm)] + [bundle.feed(c) for c in chunks]

    out, state = model.stream_init(params, warm)
    want = [np.asarray(out)]
    for c in chunks:
        out, state = model.stream_step(params, state, c)
        want.append(np.asarray(out))

    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # stream must be started before feeding
    fresh = serve.load_streamer(out_dir)
    with pytest.raises(RuntimeError, match="start"):
        fresh.feed(chunks[0])


def test_stream_chunk_invariance_wav_level(tmp_path):
    """Waveform-level streaming output is invariant to the chunking (all
    state — STFT tail, encoder carry, OLA tail — threads exactly)."""
    import jax.numpy as jnp
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = "tcn-v1"
    hparams.TCN_CAUSAL = True
    hparams.TCN_DIM = 16
    hparams.TCN_HIDDEN = 24
    hparams.TCN_BLOCKS = 2
    hparams.TCN_REPEATS = 1
    hparams.BATCH_SIZE = 1
    hparams.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    stride = hparams.FFT_STRIDE
    wav = np.random.RandomState(3).randn(1, 24 * stride).astype(
        np.float32) * 0.1
    warm, rest = wav[:, :8 * stride], wav[:, 8 * stride:]

    _, st = model.stream_init(params, jnp.asarray(warm))
    big, _ = model.stream_step(params, st, jnp.asarray(rest))
    parts, st2 = [], st
    for i in range(0, rest.shape[1], 2 * stride):
        o, st2 = model.stream_step(
            params, st2, jnp.asarray(rest[:, i:i + 2 * stride]))
        parts.append(np.asarray(o))
    np.testing.assert_allclose(
        np.concatenate(parts, axis=-1), np.asarray(big),
        atol=1e-6, rtol=1e-5)


def test_stream_init_rejects_noncausal():
    import danet_tpu  # noqa: F401
    from danet_tpu.models import DaNet
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = "bilstm-orig"
    hparams.BATCH_SIZE = 1
    hparams.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="causal"):
        model.stream_init(params, np.zeros((1, 512), np.float32))


def test_export_bf16_weights(tiny_model, tmp_path):
    """weights_dtype='bfloat16' bakes reduced-precision params: the
    artifact shrinks vs the f32 export and stays numerically close to
    the live f32 model (bf16 has ~3 decimal digits)."""
    model, params = tiny_model
    d32 = str(tmp_path / "f32")
    d16 = str(tmp_path / "bf16")
    serve.export_separator(model, params, d32, lengths=[4096], batch=1)
    m = serve.export_separator(model, params, d16, lengths=[4096],
                               batch=1, weights_dtype="bfloat16")
    assert m["weights_dtype"] == "bfloat16"
    s32 = os.path.getsize(os.path.join(d32, "sep_4096.jaxexport"))
    s16 = os.path.getsize(os.path.join(d16, "sep_4096.jaxexport"))
    assert s16 < 0.75 * s32, (s16, s32)

    wav = np.random.RandomState(1).randn(4096).astype(np.float32) * 0.1
    got16 = serve.load_separator(d16).separate(wav)
    got32 = serve.load_separator(d32).separate(wav)
    assert np.isfinite(got16).all()
    # masks are bounded [0,1] * mixture magnitude; bf16 weight rounding
    # perturbs outputs at the ~1e-2 level on this scale
    np.testing.assert_allclose(got16, got32, atol=5e-2)

    with pytest.raises(ValueError, match="float dtype"):
        serve.export_separator(model, params, str(tmp_path / "bad"),
                               lengths=[4096], weights_dtype="int8")
