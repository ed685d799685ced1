"""STFT / iSTFT as GEMM-native DFT.

The reference computes STFT on the host with ``scipy.signal.stft``
(/root/reference/app/utils.py:117-122) and iSTFT with a Python overlap-add
loop (utils.py:53-75).  Here the transform is a *matmul against a
precomputed DFT basis*: framing is a static gather, and the windowed DFT of
all frames is a single ``[num_frames, fft_size] @ [fft_size, 2*feature]``
GEMM.  No FFT primitive is needed for speech-sized FFTs (256-1024 points),
and the GEMM fuses with neighbouring elementwise ops (window, log1p) in one
XLA computation.  Whether cuFFT beats it on the GPU is not measured yet.

Conventions match ``scipy.signal.stft`` with ``boundary='zeros'``,
``padded=True``, one-sided output, and ``1/window.sum()`` scaling, so that
device-side spectra are interchangeable with the host preprocessing output
(tested to ~1e-6 in tests/test_dsp.py).

The inverse transform reproduces the reference's overlap-add with window**2
normalization (utils.py:53-75), including its frame-count convention.

Complex dtypes stay off the device, so the *_ri
variants (trailing (real, imag) axis) are the device-side API; the complex
variants serve host-side/CPU tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def stft_frame_count(n_samples: int, fft_size: int, stride: int) -> int:
    """Number of STFT frames scipy.signal.stft produces for n_samples."""
    padded = n_samples + fft_size  # boundary='zeros' adds fft_size//2 twice
    nadd = (-(padded - fft_size) % stride) % stride
    return (padded + nadd - fft_size) // stride + 1


@functools.lru_cache(maxsize=8)
def _dft_basis(fft_size: int, dtype_name: str):
    """Real/imag DFT basis, windowless: B[n, k] = exp(-2i*pi*n*k/N)."""
    n = np.arange(fft_size)[:, None]
    k = np.arange(fft_size // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / fft_size
    cos_b = np.cos(ang).astype(dtype_name)
    sin_b = (-np.sin(ang)).astype(dtype_name)
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def _idft_basis(fft_size: int, dtype_name: str):
    """Real iDFT basis: x[n] = Re @ C[k,n] + Im @ S[k,n] (one-sided input)."""
    feat = fft_size // 2 + 1
    k = np.arange(feat)[:, None]
    n = np.arange(fft_size)[None, :]
    ang = 2.0 * np.pi * k * n / fft_size
    # irfft: x[n] = (1/N) * sum_k w_k * (re_k cos - im_k sin),
    # w_k = 1 for k in {0, N/2}, else 2.
    wk = np.full((feat, 1), 2.0)
    wk[0] = 1.0
    if fft_size % 2 == 0:
        wk[-1] = 1.0
    cos_b = (wk * np.cos(ang) / fft_size).astype(dtype_name)
    sin_b = (-wk * np.sin(ang) / fft_size).astype(dtype_name)
    return cos_b, sin_b


def frame_signal(x: jnp.ndarray, fft_size: int, stride: int) -> jnp.ndarray:
    """Frame a zero-boundary-padded signal: [..., L] -> [..., T, fft_size].

    Applies scipy.signal.stft's boundary ('zeros': fft_size//2 each side) and
    end padding so the signal divides into whole frames.
    """
    n = x.shape[-1]
    half = fft_size // 2
    padded = n + 2 * half
    nadd = (-(padded - fft_size) % stride) % stride
    pad = [(0, 0)] * (x.ndim - 1) + [(half, half + nadd)]
    xp = jnp.pad(x, pad)
    n_frames = (padded + nadd - fft_size) // stride + 1
    idx = (np.arange(n_frames)[:, None] * stride
           + np.arange(fft_size)[None, :])
    return xp[..., idx]


def _stft_core(x: jnp.ndarray, fft_size: int, stride: int,
               window: np.ndarray):
    """Shared framing + windowed-DFT GEMM: returns (re, im) [..., T, F]."""
    dtype = str(window.dtype)
    frames = frame_signal(x.astype(dtype), fft_size, stride)
    cos_b, sin_b = _dft_basis(fft_size, dtype)
    scale = 1.0 / float(np.sum(window))
    wcos = jnp.asarray(window[:, None] * cos_b * scale)
    wsin = jnp.asarray(window[:, None] * sin_b * scale)
    re = jnp.matmul(frames, wcos, preferred_element_type=frames.dtype)
    im = jnp.matmul(frames, wsin, preferred_element_type=frames.dtype)
    return re, im


def stft(x: jnp.ndarray, fft_size: int, stride: int,
         window: np.ndarray) -> jnp.ndarray:
    """STFT of real signal(s) [..., L] -> complex [..., T, F].

    scipy.signal.stft-compatible (boundary zeros, padded, onesided,
    1/window.sum() scaling). Reference usage: app/utils.py:117-122.
    """
    re, im = _stft_core(x, fft_size, stride, window)
    return jax.lax.complex(re, im)


def stft_ri(x: jnp.ndarray, fft_size: int, stride: int,
            window: np.ndarray) -> jnp.ndarray:
    """STFT -> ri layout [..., T, F, 2]; no complex dtype anywhere."""
    re, im = _stft_core(x, fft_size, stride, window)
    return jnp.stack([re, im], axis=-1)


def stft_mag_logmag(x: jnp.ndarray, fft_size: int, stride: int,
                    window: np.ndarray):
    """Fused STFT -> (|Z|, log1p|Z|) front-end; all-real math, fully fusable.

    Avoids materializing complex spectra when only the DaNet feature path
    (magnitude + log-magnitude, reference main.py:239-240) is needed.
    """
    re, im = _stft_core(x, fft_size, stride, window)
    mag = jnp.sqrt(re * re + im * im)
    return mag, jnp.log1p(mag)


def _istft_core(re: jnp.ndarray, im: jnp.ndarray, stride: int,
                window: np.ndarray, length: int | None):
    """Shared iDFT GEMM + scatter overlap-add with window**2 normalization.

    Matches the reference's overlap-add semantics (app/utils.py:53-75):
    output length ``T*stride``; frames placed at ``i*stride`` for
    ``i*stride < T*stride - fft_size``; zero-division-guarded
    normalization.
    """
    fft_size = (re.shape[-1] - 1) * 2
    dtype = str(window.dtype)
    out_len = re.shape[-2] * stride
    # reference loop: for n, i in enumerate(range(0, out_len - fft_size,
    # stride)) — trailing frames past that bound are dropped
    n_used = max(0, -(-(out_len - fft_size) // stride))

    cos_b, sin_b = _idft_basis(fft_size, dtype)
    re = re[..., :n_used, :].astype(dtype)
    im = im[..., :n_used, :].astype(dtype)
    frames = (jnp.matmul(re, jnp.asarray(cos_b),
                         preferred_element_type=re.dtype)
              + jnp.matmul(im, jnp.asarray(sin_b),
                           preferred_element_type=im.dtype))
    frames = frames * jnp.asarray(window)

    idx = (np.arange(n_used)[:, None] * stride
           + np.arange(fft_size)[None, :])  # [n_used, fft_size]
    out = jnp.zeros(frames.shape[:-2] + (out_len,), dtype=frames.dtype)
    out = out.at[..., idx.reshape(-1)].add(
        frames.reshape(frames.shape[:-2] + (-1,)))

    # static window-power normalization
    wsum = np.zeros(out_len, dtype=np.float64)
    w2 = np.asarray(window, dtype=np.float64) ** 2
    for i in range(n_used):
        wsum[i * stride:i * stride + fft_size] += w2
    denom = np.where(wsum != 0, wsum, 1.0).astype(dtype)
    out = out / jnp.asarray(denom)
    if length is not None:
        out = out[..., :length]
    return out


# ---------------------------------------------------------------------------
# Streaming STFT / iSTFT: fixed-size chunks with carried boundary state.
#
# Convention (differs from the scipy-offline framing above, by design): the
# stream is conceptually left-padded with ``fft_size - stride`` zeros and
# frame i covers padded samples [i*stride, i*stride + fft_size) — every new
# ``stride`` input samples yield exactly ONE new frame whose window ENDS at
# the newest sample (no lookahead).  Correspondingly the emitted output lags
# the input by ``fft_size - stride`` samples, the minimal OLA latency.  With
# this lead-in every emitted sample's window**2 normalizer is the full
# stride-periodic steady-state sum, so no ramp handling is needed anywhere.
# ---------------------------------------------------------------------------

def stream_frames(wav_tail: jnp.ndarray, wav_chunk: jnp.ndarray,
                  fft_size: int, stride: int):
    """Frame a chunk with the carried input tail.

    Args:
        wav_tail: [..., fft_size - stride] previous samples (zeros at
            stream start — the conceptual lead-in padding).
        wav_chunk: [..., K*stride] new samples.
    Returns:
        (frames [..., K, fft_size], new_tail [..., fft_size - stride]).
    """
    p = fft_size - stride
    assert wav_tail.shape[-1] == p, (wav_tail.shape, p)
    assert wav_chunk.shape[-1] % stride == 0, \
        "chunk length must be a multiple of the stride"
    x = jnp.concatenate([wav_tail, wav_chunk], axis=-1)
    k = wav_chunk.shape[-1] // stride
    idx = (np.arange(k)[:, None] * stride
           + np.arange(fft_size)[None, :])
    return x[..., idx], x[..., x.shape[-1] - p:]


def stft_frames_ri(frames: jnp.ndarray, window: np.ndarray) -> jnp.ndarray:
    """Windowed DFT of pre-framed samples [..., K, fft_size] -> ri
    [..., K, F, 2] (same scaling as stft_ri)."""
    fft_size = frames.shape[-1]
    dtype = str(window.dtype)
    cos_b, sin_b = _dft_basis(fft_size, dtype)
    scale = 1.0 / float(np.sum(window))
    frames = frames.astype(dtype)
    re = jnp.matmul(frames, jnp.asarray(window[:, None] * cos_b * scale),
                    preferred_element_type=frames.dtype)
    im = jnp.matmul(frames, jnp.asarray(window[:, None] * sin_b * scale),
                    preferred_element_type=frames.dtype)
    return jnp.stack([re, im], axis=-1)


def ola_periodic_denom(window: np.ndarray, stride: int) -> np.ndarray:
    """[stride] steady-state window**2 overlap-add normalizer:
    denom[j] = sum over offsets o == j (mod stride), o < fft_size of
    w^2[o]."""
    w2 = np.asarray(window, dtype=np.float64) ** 2
    fft_size = w2.shape[0]
    denom = np.zeros(stride, dtype=np.float64)
    for o in range(fft_size):
        denom[o % stride] += w2[o]
    return denom.astype(window.dtype)


def istft_stream_ri(spectra_ri: jnp.ndarray, stride: int,
                    window: np.ndarray, ola_tail: jnp.ndarray):
    """Streaming inverse STFT of K frames with carried overlap-add tail.

    Args:
        spectra_ri: [..., K, F, 2] frame spectra (stream_frames framing).
        ola_tail: [..., fft_size - stride] accumulated (un-normalized)
            overlap-add numerator carried from the previous chunk (zeros
            at stream start).
    Returns:
        (out [..., K*stride] normalized emitted samples,
         new_tail [..., fft_size - stride]).
    """
    fft_size = (spectra_ri.shape[-2] - 1) * 2
    p = fft_size - stride
    dtype = str(window.dtype)
    k = spectra_ri.shape[-3]
    cos_b, sin_b = _idft_basis(fft_size, dtype)
    re = spectra_ri[..., 0].astype(dtype)
    im = spectra_ri[..., 1].astype(dtype)
    frames = (jnp.matmul(re, jnp.asarray(cos_b),
                         preferred_element_type=re.dtype)
              + jnp.matmul(im, jnp.asarray(sin_b),
                           preferred_element_type=im.dtype))
    frames = frames * jnp.asarray(window)            # [..., K, fft]

    idx = (np.arange(k)[:, None] * stride
           + np.arange(fft_size)[None, :])           # [K, fft]
    buf = jnp.zeros(frames.shape[:-2] + (k * stride + p,),
                    dtype=frames.dtype)
    buf = buf.at[..., idx.reshape(-1)].add(
        frames.reshape(frames.shape[:-2] + (-1,)))
    buf = buf.at[..., :p].add(ola_tail.astype(frames.dtype))

    denom = np.tile(ola_periodic_denom(window, stride), k)
    out = buf[..., :k * stride] / jnp.asarray(denom)
    return out, buf[..., k * stride:]


def istft(spectra: jnp.ndarray, stride: int, window: np.ndarray,
          length: int | None = None) -> jnp.ndarray:
    """Inverse STFT via iDFT matmul + scatter overlap-add.

    Args:
        spectra: complex [..., T, F]
        stride: hop size
        window: synthesis window of length (F-1)*2
        length: optional output trim length
    Returns:
        real [..., T*stride]
    """
    return _istft_core(jnp.real(spectra), jnp.imag(spectra), stride,
                       window, length)


def istft_ri(spectra_ri: jnp.ndarray, stride: int, window: np.ndarray,
             length: int | None = None) -> jnp.ndarray:
    """Inverse STFT from ri layout [..., T, F, 2]; no complex dtype."""
    return _istft_core(spectra_ri[..., 0], spectra_ri[..., 1], stride,
                       window, length)
