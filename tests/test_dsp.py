"""DSP parity tests: GEMM-native STFT/iSTFT vs scipy / reference overlap-add
(SURVEY.md §7 step 2: scipy-parity golden tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal

from danet_tpu.data import audio
from danet_tpu.hparams import WINDOW_REGISTRY
from danet_tpu.ops import dsp


def _window(n=256):
    return WINDOW_REGISTRY["sqrt-hann"](n).astype(np.float32)


def _ref_istft(X, stride, window):
    """The reference's overlap-add loop (app/utils.py:53-75), as oracle."""
    fftsize = (X.shape[1] - 1) * 2
    x = np.zeros(X.shape[0] * stride)
    wsum = np.zeros(X.shape[0] * stride)
    for n, i in enumerate(range(0, len(x) - fftsize, stride)):
        x[i:i + fftsize] += np.real(np.fft.irfft(X[n])) * window
        wsum[i:i + fftsize] += window ** 2.0
    pos = wsum != 0
    x[pos] /= wsum[pos]
    return x


def test_stft_matches_scipy():
    rng = np.random.RandomState(0)
    x = rng.randn(5000).astype(np.float32)
    w = _window()
    z_ref = scipy.signal.stft(
        x, window=w, nperseg=256, noverlap=256 - 64)[2].T
    z = np.asarray(dsp.stft(jnp.asarray(x), 256, 64, w))
    assert z.shape == z_ref.shape
    np.testing.assert_allclose(z, z_ref, atol=2e-6)


def test_stft_batched():
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 2000).astype(np.float32)
    w = _window()
    z = np.asarray(dsp.stft(jnp.asarray(xs), 256, 64, w))
    for i in range(3):
        z_ref = scipy.signal.stft(
            xs[i], window=w, nperseg=256, noverlap=256 - 64)[2].T
        np.testing.assert_allclose(z[i], z_ref, atol=2e-6)


def test_stft_frame_count():
    w = _window()
    for n in [1000, 2048, 4097]:
        z = np.asarray(dsp.stft(jnp.asarray(np.zeros(n, np.float32)),
                                256, 64, w))
        assert z.shape[0] == dsp.stft_frame_count(n, 256, 64)


def test_fused_mag_logmag():
    rng = np.random.RandomState(2)
    x = rng.randn(3000).astype(np.float32)
    w = _window()
    mag, logmag = dsp.stft_mag_logmag(jnp.asarray(x), 256, 64, w)
    z = dsp.stft(jnp.asarray(x), 256, 64, w)
    np.testing.assert_allclose(np.asarray(mag), np.abs(np.asarray(z)),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(logmag),
                               np.log1p(np.abs(np.asarray(z))), atol=2e-6)


def test_istft_matches_reference_overlap_add():
    rng = np.random.RandomState(3)
    x = rng.randn(4000).astype(np.float32)
    w = _window()
    z = scipy.signal.stft(x, window=w, nperseg=256, noverlap=192)[2].T
    y_ref = _ref_istft(z, 64, w)
    y = np.asarray(dsp.istft(jnp.asarray(z), 64, w))
    np.testing.assert_allclose(y, y_ref, atol=2e-6)
    # host-side numpy istft agrees too (data/audio.py)
    y_np = audio.istft_np(z, 64, w)
    np.testing.assert_allclose(y_np, y_ref, atol=1e-10)


def test_wav_roundtrip(tmp_path, fresh_hparams):
    """WAV -> STFT -> iSTFT -> WAV round-trip: reconstruction error small
    in the interior (windows overlap fully)."""
    hp = fresh_hparams
    rng = np.random.RandomState(4)
    x = (rng.randn(8000) * 0.1).astype(np.float32)
    z = audio.stft_np(x)
    y = audio.istft_np(z)
    # scipy stft scales by 1/sum(w); the reference istft does NOT undo it,
    # so round-trip gain is 1/sum(w) (documented reference behaviour).
    gain = 1.0 / np.sum(hp.FFT_WND_ARRAY)
    # interior samples (skip boundary half-windows + scipy zero boundary)
    core = slice(512, 7500)
    shift = hp.FFT_SIZE // 2  # scipy boundary zeros offset
    np.testing.assert_allclose(
        y[core.start + shift:core.stop + shift] / gain,
        x[core], atol=5e-3)


def test_save_load_wavfile(tmp_path, fresh_hparams):
    hp = fresh_hparams
    rng = np.random.RandomState(5)
    x = (rng.randn(6000) * 0.05).astype(np.float32)
    z = audio.stft_np(x)
    path = str(tmp_path / "test.wav")
    audio.save_wavfile(path, z)
    z2 = audio.load_wavfile(path)
    t = min(len(z), len(z2))
    # round-trip through the WAV file preserves the spectra up to the
    # 1/sum(w) gain and boundary frames
    ratio = np.abs(z2[8:t - 8]).sum() / np.abs(z[8:t - 8]).sum()
    gain = 1.0 / np.sum(hp.FFT_WND_ARRAY)
    np.testing.assert_allclose(ratio, gain, rtol=0.05)


def test_random_zeropad():
    x = np.ones((5, 3))
    y = audio.random_zeropad(x, 4, axis=0)
    assert y.shape == (9, 3)
    assert y.sum() == x.sum()
    assert np.array_equal(audio.random_zeropad(x, 0, axis=0), x)


def test_ri_roundtrip():
    z = (np.random.randn(4, 5) + 1j * np.random.randn(4, 5)).astype(
        np.complex64)
    np.testing.assert_allclose(audio.from_ri(audio.to_ri(z)), z)


def test_stft_ri_matches_complex():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3000).astype(np.float32)
    w = _window()
    z = np.asarray(dsp.stft(jnp.asarray(x), 256, 64, w))
    ri = np.asarray(dsp.stft_ri(jnp.asarray(x), 256, 64, w))
    np.testing.assert_allclose(ri[..., 0], z.real, atol=1e-6)
    np.testing.assert_allclose(ri[..., 1], z.imag, atol=1e-6)


def test_istft_ri_matches_complex():
    rng = np.random.RandomState(7)
    x = rng.randn(3500).astype(np.float32)
    w = _window()
    z = scipy.signal.stft(x, window=w, nperseg=256, noverlap=192)[2].T
    y_c = np.asarray(dsp.istft(jnp.asarray(z), 64, w))
    ri = np.stack([z.real, z.imag], -1).astype(np.float32)
    y_ri = np.asarray(dsp.istft_ri(jnp.asarray(ri), 64, w))
    np.testing.assert_allclose(y_ri, y_c, atol=1e-5)


def test_streaming_stft_istft_roundtrip():
    """Streaming STFT -> iSTFT with carried tails reconstructs the input
    exactly (lagged by fft-stride samples), independent of the chunking
    (ops/dsp.py streaming convention; the serving stream pipeline's DSP)."""
    fft, stride = 256, 64
    w = _window()
    p = fft - stride
    rng = np.random.RandomState(11)
    wav = rng.randn(1, 48 * stride).astype(np.float32)
    scale = float(np.sum(w))  # undo analysis 1/sum(w) for pure round-trip

    def run(chunk_frames):
        tail = jnp.zeros((1, p), jnp.float32)
        ola = jnp.zeros((1, p), jnp.float32)
        outs = []
        step = chunk_frames * stride
        for i in range(0, wav.shape[1], step):
            frames, tail = dsp.stream_frames(
                tail, jnp.asarray(wav[:, i:i + step]), fft, stride)
            spec = dsp.stft_frames_ri(frames, w)
            o, ola = dsp.istft_stream_ri(spec * scale, stride, w, ola)
            outs.append(np.asarray(o))
        return np.concatenate(outs, axis=-1)

    big = run(16)
    # reconstruction: output lags input by p samples
    np.testing.assert_allclose(big[:, p:], wav[:, :big.shape[1] - p],
                               atol=2e-5, rtol=1e-5)
    # chunk invariance
    np.testing.assert_allclose(run(4), big, atol=1e-6)


def test_ola_periodic_denom():
    """Steady-state window^2 normalizer equals the brute-force overlap sum
    at interior positions."""
    fft, stride = 256, 64
    w = _window()
    denom = dsp.ola_periodic_denom(w, stride)
    n_frames = 40
    wsum = np.zeros(n_frames * stride + fft)
    for i in range(n_frames):
        wsum[i * stride:i * stride + fft] += np.asarray(w) ** 2
    interior = wsum[fft:fft + 4 * stride]
    np.testing.assert_allclose(
        np.tile(denom, 4), interior, rtol=1e-6)


def test_stft_ri_logmag_features_match_scipy():
    """The model's input features — log1p(|STFT|) from the device ri
    spectra, as DaNet._mix_features computes them — match scipy on a
    batch of odd-length signals at the default 256/64 Hann framing.
    At precision="highest" the GEMM DFT is float32-exact to ~1e-6."""
    rng = np.random.RandomState(3)
    xs = (rng.randn(2, 8001) * 0.3).astype(np.float32)
    w = _window()
    with jax.default_matmul_precision("highest"):
        ri = np.asarray(dsp.stft_ri(jnp.asarray(xs), 256, 64, w))
    logmag = np.log1p(np.sqrt(np.sum(np.square(ri), axis=-1)))
    for i in range(2):
        z_ref = scipy.signal.stft(
            xs[i], window=w, nperseg=256, noverlap=256 - 64)[2].T
        assert logmag[i].shape == z_ref.shape == (
            dsp.stft_frame_count(8001, 256, 64), 129)
        np.testing.assert_allclose(logmag[i], np.log1p(np.abs(z_ref)),
                                   atol=2e-6)
