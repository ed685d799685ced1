"""Losses and metrics: permutation-invariant MSE, batched SNR.

Reimplementation of the reference op library's loss/metric ops
(/root/reference/app/ops.py:191-222 batch_snr, ops.py:374-431 pit_mse_loss).
The permutation search is a dense einsum against a constant one-hot
permutation stack — N! is tiny (N=2..4 speakers), so the full cost matrix +
argmin maps onto one fused XLA computation with no data-dependent control
flow.
"""
from __future__ import annotations

import itertools
from math import factorial

import jax
import jax.numpy as jnp
import numpy as np


def permutations_array(n: int) -> np.ndarray:
    """All permutations of range(n) as an int32 [n!, n] array."""
    return np.asarray(list(itertools.permutations(range(n))), dtype=np.int32)


def _squared_error(x: jnp.ndarray, y: jnp.ndarray,
                   complex_ri: bool) -> jnp.ndarray:
    """Complex-aware squared error (reference ops.py:414-421).

    With complex_ri=True the trailing axis holds (real, imag) and the
    squared error is re^2 + im^2 of the difference — the device-side
    representation of complex spectra (complex dtypes stay off device;
    see ops/dsp.py).
    """
    d = x - y
    if complex_ri:
        return jnp.sum(jnp.square(d), axis=-1)
    if jnp.iscomplexobj(x) and jnp.iscomplexobj(y):
        return jnp.square(jnp.real(d)) + jnp.square(jnp.imag(d))
    return jnp.square(d)


def pit_mse_loss(x: jnp.ndarray, y: jnp.ndarray, pit_axis: int = 1,
                 complex_ri: bool = False, method: str = "gemm"):
    """Permutation-invariant MSE between per-source tensors.

    Semantics match reference ops.py:374-431: per-(i,j) mean squared error
    over all non-PIT axes, cost of a permutation = SUM over sources of the
    per-pair means, argmin over the N! permutations, mean over batch.

    Args:
        x: target, [B, N, ...] (real, complex, or ri-stacked)
        y: prediction, [B, N, ...]
        pit_axis: axis holding the N sources (must be 1 currently)
        complex_ri: last axis of x/y is a (real, imag) pair; squared error
            sums over it, and it is excluded from the mean (so the loss
            equals the complex-input formulation exactly).
        method: 'gemm' (default) or 'dense'.  'gemm' computes the pairwise
            cost matrix in Gram form, ``||x_i - y_j||^2 = ||x_i||^2 +
            ||y_j||^2 - 2<x_i, y_j>`` — the cross term is ONE tiny batched
            [N, D] @ [D, N] GEMM instead of a materialized [B, N, N, ...]
            difference tensor (4x the spectra, fwd AND bwd) — then
            recomputes the loss of the WINNING permutation exactly from the
            un-permuted difference, so the returned value (and its
            gradient) is identical to 'dense' up to f32 reduction order in
            the argmin inputs; an exactly tied permutation pair may resolve
            differently (both costs equal).  'dense' is the literal
            reference formulation (complex dtypes; oracle tests).

    Returns:
        (loss, perms, perm_idx): scalar loss; int32 [N!, N] permutation
        table; int32 [B] chosen permutation index per batch element.
        ``perms[perm_idx[b], i]`` gives the prediction index matched to
        target source i — use with jnp.take_along_axis to un-permute.
    """
    assert pit_axis == 1, "PIT axis must be the source axis (1)"
    n = x.shape[pit_axis]
    perms = permutations_array(n)
    n_perm = factorial(n)
    # one-hot permutation stack: [P, N, N]
    onehot = np.zeros((n_perm, n, n), dtype=np.float32)
    onehot[np.arange(n_perm)[:, None], np.arange(n)[None, :], perms] = 1.0

    if method == "gemm" and not jnp.iscomplexobj(x):
        b = x.shape[0]
        # D = all non-(B, N) elements; the ri axis flattens in (|z|^2 =
        # re^2 + im^2), but the mean divisor excludes it (see complex_ri).
        d_mean = int(np.prod(x.shape[2:]))
        if complex_ri:
            d_mean //= x.shape[-1]
        xf = x.reshape(b, n, -1)
        yf = y.reshape(b, n, -1)
        # costs only pick the permutation — no gradient flows through them
        xf_s = jax.lax.stop_gradient(xf)
        yf_s = jax.lax.stop_gradient(yf)
        xx = jnp.sum(jnp.square(xf_s), axis=-1)            # [B, N]
        yy = jnp.sum(jnp.square(yf_s), axis=-1)            # [B, N]
        xy = jnp.einsum("bid,bjd->bij", xf_s, yf_s,
                        preferred_element_type=jnp.float32)
        cross = (xx[:, :, None] + yy[:, None, :] - 2.0 * xy) / d_mean
        loss_sets = jnp.einsum("bij,pij->bp", cross, jnp.asarray(onehot))
        perm_idx = jnp.argmin(loss_sets, axis=1)
        # exact loss of the winning permutation (differentiable path);
        # un-permute via the one-hot matrix: its VJP is another einsum
        # (GEMM), where take_along_axis would put a scatter-add on the
        # gradient path
        sel_oh = jnp.asarray(onehot)[perm_idx]             # [B, N, N]
        y_pit = jnp.einsum("bnm,bmd->bnd", sel_oh, yf)
        # = sum over sources of the per-pair means (the dense loss_sets
        # gather), then mean over batch
        loss = jnp.mean(jnp.sum(jnp.square(xf - y_pit), axis=(1, 2))
                        / d_mean)
        return loss, jnp.asarray(perms), perm_idx

    xs = jnp.expand_dims(x, pit_axis + 1)   # [B, N, 1, ...]
    ys = jnp.expand_dims(y, pit_axis)       # [B, 1, N, ...]
    sq = _squared_error(xs, ys, complex_ri)
    reduce_axes = tuple(range(3, sq.ndim))
    cross = jnp.mean(sq, axis=reduce_axes)  # [B, N, N]
    loss_sets = jnp.einsum("bij,pij->bp", cross, jnp.asarray(onehot))
    perm_idx = jnp.argmin(loss_sets, axis=1)
    loss = jnp.mean(jnp.take_along_axis(
        loss_sets, perm_idx[:, None], axis=1))
    return loss, jnp.asarray(perms), perm_idx


def pit_mse_masked_ri(src_ri: jnp.ndarray, sep_pwr: jnp.ndarray,
                      phase_unit: jnp.ndarray, eps: float = 1e-7):
    """PIT complex-MSE of a masked reconstruction WITHOUT materializing it.

    The training tail reconstructs ``sep_ri = sep_pwr * phase_unit`` only
    to immediately difference it against the targets (models/danet.py
    train path; reference main.py:289-309 does the same through tf
    gather_nd).  Since the reconstruction is a rank-1 scaling of the
    per-bin phase vector p, the squared error folds algebraically:

        ||x - m p||^2 = ||x||^2 - 2 m <x, p> + m^2 ||p||^2

    so neither the [B, N, T, F, 2] separated tensor nor its gradient is
    ever materialized — the PIT cost matrix, the winning-permutation
    loss, AND the SNR metric all come from three [B, N, T, F]-shaped
    reductions plus one [N, TF] x [TF, N] Gram GEMM (half the D of the
    ri-domain Gram).  Exactly equal to
    ``pit_mse_loss(src_ri, sep_pwr[..., None] * phase_unit[:, None],
    complex_ri=True)`` (+ unpermute + batch_snr) up to f32 reassociation;
    ``phase_unit`` need not be exactly unit (the EPS-guarded mixture
    phase is handled by the explicit ||p||^2 term).

    Args:
        src_ri: targets [B, N, T, F, 2].
        sep_pwr: masked magnitudes m [B, N, T, F] (separator output).
        phase_unit: per-bin phase vector p [B, T, F, 2].
        eps: batch_snr's log-domain epsilon (hp.EPS) so the returned SNR
            matches the unfused metric bit-for-bit in semantics.

    Returns:
        (loss, perms, perm_idx, snr): scalar loss; the [N!, N] table and
        [B] chosen index (same contract as pit_mse_loss); snr [B] in dB,
        identical in semantics to ``batch_snr(src_ri, unpermute(sep_ri),
        complex_ri=True)``.
    """
    b, n = src_ri.shape[0], src_ri.shape[1]
    perms = permutations_array(n)
    n_perm = factorial(n)
    onehot = np.zeros((n_perm, n, n), dtype=np.float32)
    onehot[np.arange(n_perm)[:, None], np.arange(n)[None, :], perms] = 1.0
    onehot = jnp.asarray(onehot)

    d_mean = int(np.prod(src_ri.shape[2:-1]))           # T*F (ri excluded)
    src_sq = jnp.sum(jnp.square(src_ri), axis=-1)       # [B, N, T, F]
    s_proj = jnp.sum(src_ri * phase_unit[:, None], axis=-1)
    p2 = jnp.sum(jnp.square(phase_unit), axis=-1)       # [B, T, F]
    m2p = jnp.square(sep_pwr) * p2[:, None]             # [B, N, T, F]

    # cost matrix picks the permutation only — no gradient through it
    sp_s = jax.lax.stop_gradient(s_proj).reshape(b, n, -1)
    m_s = jax.lax.stop_gradient(sep_pwr).reshape(b, n, -1)
    xx = jnp.sum(jax.lax.stop_gradient(src_sq), axis=(2, 3))   # [B, N]
    pp = jnp.sum(jax.lax.stop_gradient(m2p), axis=(2, 3))      # [B, N]
    xy = jnp.einsum("bid,bjd->bij", sp_s, m_s,
                    preferred_element_type=jnp.float32)
    cost = (xx[:, :, None] + pp[:, None, :] - 2.0 * xy) / d_mean
    perm_idx = jnp.argmin(
        jnp.einsum("bij,pij->bp", cost, onehot), axis=1)

    # exact winning-permutation loss (differentiable path); one-hot
    # un-permute keeps the VJP a GEMM (see pit_mse_loss)
    sel_oh = onehot[perm_idx]                            # [B, N, N]
    m_pit = jnp.einsum("bnm,bmd->bnd", sel_oh,
                       sep_pwr.reshape(b, n, -1)).reshape(sep_pwr.shape)
    err = jnp.sum(
        src_sq - 2.0 * m_pit * s_proj
        + jnp.square(m_pit) * p2[:, None], axis=(2, 3))  # [B, N]
    loss = jnp.mean(jnp.sum(err, axis=1) / d_mean)

    # batch_snr semantics: mean magnitude-squared over (N, T, F), eps in
    # the log domain (ops/loss.py::batch_snr, reference ops.py:191-222)
    coeff = 4.342944819
    sig_pwr = jnp.sum(src_sq, axis=(1, 2, 3)) / (n * d_mean)
    # the expanded form can go epsilon-negative at very high SNR
    # (cancellation of ||x||^2 against 2m<x,p>); clamp for the log
    noise_pwr = jnp.maximum(jnp.sum(err, axis=1), 0.0) / (n * d_mean)
    snr = coeff * (jnp.log(sig_pwr + eps) - jnp.log(noise_pwr + eps))
    return loss, jnp.asarray(perms), perm_idx, snr


def unpermute(y: jnp.ndarray, perms: jnp.ndarray,
              perm_idx: jnp.ndarray) -> jnp.ndarray:
    """Reorder predictions [B, N, ...] by the chosen PIT permutation.

    Equivalent of the reference's gather_nd un-permute (main.py:293-306):
    output[b, i] = y[b, perms[perm_idx[b], i]].
    """
    sel = perms[perm_idx]  # [B, N]
    sel = sel.reshape(sel.shape + (1,) * (y.ndim - 2))
    return jnp.take_along_axis(y, sel.astype(jnp.int32), axis=1)


def batch_snr(clear_signal: jnp.ndarray, noisy_signal: jnp.ndarray,
              eps: float = 1e-7, complex_ri: bool = False) -> jnp.ndarray:
    """Batched SNR in dB, zero-mean assumption (reference ops.py:191-222).

    Complex inputs (dtype-complex, or ri-stacked when complex_ri=True) are
    compared via squared magnitudes of signal and of the complex residual;
    note |z|^2 = re^2 + im^2 needs no sqrt. Returns a vector [batch].
    """
    noise = clear_signal - noisy_signal
    if complex_ri:
        # mean over all non-batch axes of the *magnitude squared*: sum the
        # ri axis but keep the mean's denominator excluding it.
        reduce_axes = tuple(range(1, clear_signal.ndim - 1))
        sig_pwr = jnp.mean(
            jnp.sum(jnp.square(clear_signal), axis=-1), axis=reduce_axes)
        noise_pwr = jnp.mean(
            jnp.sum(jnp.square(noise), axis=-1), axis=reduce_axes)
    else:
        if jnp.iscomplexobj(clear_signal):
            clear_signal = jnp.abs(clear_signal)
            noise = jnp.abs(noise)
        reduce_axes = tuple(range(1, clear_signal.ndim))
        sig_pwr = jnp.mean(jnp.square(clear_signal), axis=reduce_axes)
        noise_pwr = jnp.mean(jnp.square(noise), axis=reduce_axes)
    coeff = 4.342944819  # 10 / ln(10)
    return coeff * (jnp.log(sig_pwr + eps) - jnp.log(noise_pwr + eps))


def si_snr(target: jnp.ndarray, estimate: jnp.ndarray,
           eps: float = 1e-8) -> jnp.ndarray:
    """Scale-invariant SNR (dB) over the last axis; extra eval metric.

    Not present in the reference (which reports plain SNR); standard for
    modern speech-separation evaluation on WSJ0-2mix.
    """
    target = target - jnp.mean(target, axis=-1, keepdims=True)
    estimate = estimate - jnp.mean(estimate, axis=-1, keepdims=True)
    dot = jnp.sum(target * estimate, axis=-1, keepdims=True)
    t_pwr = jnp.sum(jnp.square(target), axis=-1, keepdims=True)
    proj = dot / (t_pwr + eps) * target
    noise = estimate - proj
    ratio = (jnp.sum(jnp.square(proj), axis=-1)
             / (jnp.sum(jnp.square(noise), axis=-1) + eps))
    return 10.0 * jnp.log10(ratio + eps)


def pit_si_snr_loss(target_wav: jnp.ndarray, estimate_wav: jnp.ndarray,
                    eps: float = 1e-8):
    """Permutation-invariant negative SI-SNR on waveforms (uPIT objective).

    Modern waveform-domain training criterion for WSJ0-2mix-style
    separation; not in the reference (which trains complex-spectrogram
    PIT-MSE only, ops.py:374-431).  Select with TRAIN_LOSS_TYPE
    'pit-si-snr'; targets/estimates are on-device iSTFT reconstructions.

    Args:
        target_wav: [B, N, L] true source waveforms
        estimate_wav: [B, N, L] separated waveforms
    Returns:
        (loss, perms, perm_idx) with the same un-permute contract as
        pit_mse_loss; loss = -mean over batch of the permutation-optimal
        mean SI-SNR (dB), so lower is better.
    """
    n = target_wav.shape[1]
    perms = permutations_array(n)
    n_perm = factorial(n)
    onehot = np.zeros((n_perm, n, n), dtype=np.float32)
    onehot[np.arange(n_perm)[:, None], np.arange(n)[None, :], perms] = 1.0

    # Pairwise SI-SNR in Gram form: with zero-mean t_i, e_j and
    # d_ij = <t_i, e_j>, the projection norms are ||proj||^2 = d^2/||t||^2
    # and ||noise||^2 = ||e||^2 - d^2/||t||^2 — so the whole [N, N] cross
    # matrix needs ONE batched [N, L] @ [L, N] GEMM plus per-signal powers;
    # no [B, N, N, L] broadcast tensors (they dominate fwd+bwd HBM traffic
    # of the uPIT objective at waveform length L).
    t = target_wav - jnp.mean(target_wav, axis=-1, keepdims=True)
    e = estimate_wav - jnp.mean(estimate_wav, axis=-1, keepdims=True)
    d = jnp.einsum("bil,bjl->bij", t, e,
                   preferred_element_type=jnp.float32)     # [B, N, N]
    t_pwr = jnp.sum(jnp.square(t), axis=-1)                # [B, N]
    e_pwr = jnp.sum(jnp.square(e), axis=-1)                # [B, N]
    proj_pwr = jnp.square(d) / (t_pwr[:, :, None] + eps)
    # the Gram form can go epsilon-negative when e is a near-exact scaled
    # copy of t (the elementwise form is a sum of squares, >= 0); clamp
    noise_pwr = jnp.maximum(e_pwr[:, None, :] - proj_pwr, 0.0)
    cross = 10.0 * jnp.log10(
        proj_pwr / (noise_pwr + eps) + eps)                # [B, N, N]
    score_sets = jnp.einsum(
        "bij,pij->bp", cross, jnp.asarray(onehot)) / n    # [B, P]
    perm_idx = jnp.argmax(score_sets, axis=1)
    loss = -jnp.mean(jnp.take_along_axis(
        score_sets, perm_idx[:, None], axis=1))
    return loss, jnp.asarray(perms), perm_idx


def bss_eval_sources(ref: jnp.ndarray, est: jnp.ndarray,
                     filt_len: int = 512, eps: float = 1e-10,
                     rcond: float = 1e-6):
    """BSS-eval SDR / SIR / SAR with a time-invariant distortion filter.

    The standard source-separation evaluation (Vincent et al. 2006, BSS
    Eval v3 `bss_eval_sources` semantics): each estimate is decomposed as
    ``est = s_target + e_interf + e_artif`` where

      * ``s_target`` is the least-squares projection of the estimate onto
        the span of the matching reference source delayed by 0..L-1
        samples (an allowed L-tap distortion filter), and
      * ``s_target + e_interf`` is the projection onto the span of ALL
        reference sources' delays.

    Not present in the reference repo (which reports only spectral SNR,
    /root/reference/app/ops.py:191-222); this is the metric the DaNet
    paper's WSJ0-mix numbers are quoted in.  Inputs must be PIT-aligned
    (est[i] estimates ref[i]) — align with pit_si_snr_loss/unpermute first.

    All correlations are computed with one batched rFFT and the projection
    coefficients with one dense solve of the [N*L, N*L] block-Toeplitz
    Gram system — no data-dependent control flow, so the whole metric jits
    to one program.  Computed in f32: the Gram-solve precision
    caps a *perfect* estimate at roughly 30 dB SDR, far above any real
    separation quality; oracle-tested vs an explicit float64 least-squares
    decomposition (tests/test_loss.py).

    Args:
        ref: [N, T] true source waveforms.
        est: [N, T] separated waveforms, source-aligned with ref.
        filt_len: allowed distortion filter length L (512 = standard).
        eps: floor inside the dB ratios.
        rcond: relative Tikhonov ridge for the Gram solves (scaled by
            mean diagonal energy).

    Identifiability caveat: when sources genuinely SHARE spectral
    components (e.g. narrowband tonal material with coinciding
    frequencies), the target/interference split is non-identifiable —
    P_all vs P_own assign the shared component differently and SIR/SDR
    become meaningless regardless of solver precision (mir_eval's
    bss_eval has the same property).  Use SNR/SI-SNR on such material;
    BSS-eval is intended for broadband sources (speech).

    Returns:
        dict with "sdr", "sir", "sar": each a [N] vector in dB.
    """
    n, t = ref.shape
    ell = int(filt_len)
    nfft = 1
    while nfft < t + ell:  # linear (non-circular) correlations
        nfft *= 2

    ref32 = ref.astype(jnp.float32)
    est32 = est.astype(jnp.float32)
    rf = jnp.fft.rfft(ref32, nfft, axis=-1)           # [N, K]
    ef = jnp.fft.rfft(est32, nfft, axis=-1)           # [N, K]

    # cross-correlations between references at lags -(L-1)..(L-1):
    # r[j, j', k] = sum_t ref_j[t - a] ref_j'[t - b] with k = a - b + L-1
    #            = sum_t ref_j[t] ref_j'[t + (a - b)]
    cc = jnp.fft.irfft(jnp.conj(rf[:, None]) * rf[None, :], nfft,
                       axis=-1)                        # [N, N, nfft]
    # lag m = a - b in [-(L-1), L-1]; circular indexing folds negatives.
    lags = jnp.arange(-(ell - 1), ell) % nfft
    cc = cc[:, :, lags]                                # [N, N, 2L-1]
    # Toeplitz blocks: G[j a, j' b] = cc[j, j', (a - b) + L - 1]
    a_idx = jnp.arange(ell)
    toep = cc[:, :, a_idx[:, None] - a_idx[None, :] + ell - 1]  # [N,N,L,L]
    gram = toep.transpose(0, 2, 1, 3).reshape(n * ell, n * ell)

    # correlation of each estimate with each delayed reference:
    # c[i, j, a] = sum_t est_i[t] ref_j[t - a] = sum_u ref_j[u] est_i[u + a]
    ec = jnp.fft.irfft(jnp.conj(rf[None, :]) * ef[:, None], nfft,
                       axis=-1)                        # [N_est, N_ref, nfft]
    c_all = ec[:, :, :ell]                             # lags 0..L-1

    # Projection coefficients via a Tikhonov-regularized solve.  An SVD/
    # eigh-cutoff pseudo-inverse is worse here: f32 eigh of these
    # ill-conditioned Toeplitz Grams misestimates the small eigenpairs and
    # the reconstructed inverse explodes, whereas the ridge-shifted direct
    # solve stays bounded.  (On genuinely
    # rank-deficient material the metric itself is non-identifiable — see
    # the caveat above — regardless of solver.)
    ridge = rcond * jnp.trace(gram) / (n * ell)
    eye_full = jnp.eye(n * ell, dtype=gram.dtype)
    h_all = jnp.linalg.solve(gram + ridge * eye_full,
                             c_all.reshape(n, n * ell).T)    # [NL, N_est]
    h_all = h_all.T.reshape(n, n, ell)                 # [N_est, N_ref, L]

    # projection onto the OWN source's delays (batched per-source solve)
    gram_own = toep[jnp.arange(n), jnp.arange(n)]      # [N, L, L]
    eye_own = jnp.eye(ell, dtype=gram.dtype)
    c_own = c_all[jnp.arange(n), jnp.arange(n)]        # [N_est, L]
    h_own = jnp.linalg.solve(gram_own + ridge * eye_own,
                             c_own[..., None])[..., 0]  # [N_est, L]

    # synthesize the filtered projections in the frequency domain
    hf_all = jnp.fft.rfft(h_all, nfft, axis=-1)        # [N_est, N_ref, K]
    p_all = jnp.fft.irfft(jnp.sum(hf_all * rf[None, :], axis=1),
                          nfft, axis=-1)[:, :t + ell - 1]
    hf_own = jnp.fft.rfft(h_own, nfft, axis=-1)        # [N_est, K]
    p_own = jnp.fft.irfft(hf_own * rf, nfft, axis=-1)[:, :t + ell - 1]

    est_pad = jnp.pad(est32, ((0, 0), (0, ell - 1)))
    s_target = p_own
    e_interf = p_all - p_own
    e_artif = est_pad - p_all

    def _pow(x):
        return jnp.sum(jnp.square(x), axis=-1)

    db = lambda num, den: 10.0 * (jnp.log10(num + eps) - jnp.log10(den + eps))
    return {
        "sdr": db(_pow(s_target), _pow(e_interf + e_artif)),
        "sir": db(_pow(s_target), _pow(e_interf)),
        "sar": db(_pow(s_target + e_interf), _pow(e_artif)),
    }


def combinations_gather(data: jnp.ndarray, subset_size: int) -> jnp.ndarray:
    """Gather all C(total, subset_size) row subsets (reference ops.py:273-292).

    data: [total, ...] -> [C(total, k), k, ...]
    """
    total = data.shape[0]
    combs = np.asarray(
        list(itertools.combinations(range(total), subset_size)),
        dtype=np.int32)
    return data[jnp.asarray(combs)]


def batch_cross_snr(clear_signal: jnp.ndarray, noisy_signal: jnp.ndarray,
                    eps: float = 1e-7,
                    complex_ri: bool = False) -> jnp.ndarray:
    """Pairwise SNR matrix [B, m, n] between per-source stacks
    (reference ops.py:225-258)."""
    xs = jnp.expand_dims(clear_signal, 2)   # [B, m, 1, ...]
    ys = jnp.expand_dims(noisy_signal, 1)   # [B, 1, n, ...]
    noise = xs - ys
    if complex_ri:
        reduce_axes = tuple(range(3, xs.ndim - 1))
        sig_pwr = jnp.mean(jnp.sum(jnp.square(xs), axis=-1),
                           axis=reduce_axes)
        noise_pwr = jnp.mean(jnp.sum(jnp.square(noise), axis=-1),
                             axis=reduce_axes)
    else:
        if jnp.iscomplexobj(xs):
            xs, noise = jnp.abs(xs), jnp.abs(noise)
        reduce_axes = tuple(range(3, xs.ndim))
        sig_pwr = jnp.mean(jnp.square(xs), axis=reduce_axes)
        noise_pwr = jnp.mean(jnp.square(noise), axis=reduce_axes)
    coeff = 4.342944819
    return coeff * (jnp.log(sig_pwr + eps) - jnp.log(noise_pwr + eps))


def dc_loss(embed: jnp.ndarray, src_pwr: jnp.ndarray,
            weights: jnp.ndarray = None, eps: float = 1e-8) -> jnp.ndarray:
    """Deep-clustering objective (Hershey et al. 2016) in Gram form.

    Pulls each T-F bin's embedding toward the embeddings of bins
    dominated by the same source — exactly the structure the anchored /
    k-means inference estimators cluster at test time, so it is the
    natural auxiliary objective for DaNet's inference path (the DaNet
    paper positions the attractor network as the successor of this loss;
    chimera networks train both jointly).  Not in the reference (which
    trains the mask path only, /root/reference/main.py:289-309).

    The naive affinity formulation ||VV^T - YY^T||_F^2 is quadratic in
    the number of bins (TF ~ 16k -> a 260M-entry affinity matrix).  The
    standard low-rank expansion makes it three tiny Gram GEMMs:

        ||V^T V||_F^2 - 2 ||V^T Y||_F^2 + ||Y^T Y||_F^2

    with V [B, TF, E] row-normalized embeddings and Y [B, TF, N] one-hot
    dominant-source labels, each row scaled by sqrt(w) when per-bin
    weights are given (magnitude-ratio weighting of chimera++ — pass
    weights=mix_pwr to focus the objective on audible bins).

    Args:
        embed: [B, T, F, E] bin embeddings (any dtype; math runs in f32).
        src_pwr: [B, N, T, F] per-source magnitudes; the dominant source
            (argmax over N) defines each bin's cluster label, as the
            truth estimators do (reference modules.py:396).
        weights: optional [B, T, F] nonnegative per-bin weights; None
            means uniform.  Normalized per example, so only relative
            weights matter.
    Returns:
        scalar loss, mean over batch of ||VV^T - YY^T||_F^2 / (sum w)^2
        (with w normalized to sum to TF, this is O(1) regardless of
        sequence length).
    """
    b, t, f, e = embed.shape
    n = src_pwr.shape[1]
    v = embed.reshape(b, t * f, e).astype(jnp.float32)
    v = v * jax.lax.rsqrt(jnp.sum(jnp.square(v), axis=-1,
                                  keepdims=True) + eps)
    labels = jnp.argmax(src_pwr, axis=1).reshape(b, t * f)   # [B, TF]
    y = jax.nn.one_hot(labels, n, dtype=jnp.float32)          # [B, TF, N]
    if weights is not None:
        w = weights.reshape(b, t * f).astype(jnp.float32)
        w = w * (t * f / (jnp.sum(w, axis=-1, keepdims=True) + eps))
        sw = jnp.sqrt(w)[..., None]
        v = v * sw
        y = y * sw
    vtv = jnp.einsum("bte,btd->bed", v, v,
                     preferred_element_type=jnp.float32)      # [B, E, E]
    vty = jnp.einsum("bte,btn->ben", v, y,
                     preferred_element_type=jnp.float32)      # [B, E, N]
    yty = jnp.einsum("btn,btm->bnm", y, y,
                     preferred_element_type=jnp.float32)      # [B, N, N]
    per_ex = (jnp.sum(jnp.square(vtv), axis=(1, 2))
              - 2.0 * jnp.sum(jnp.square(vty), axis=(1, 2))
              + jnp.sum(jnp.square(yty), axis=(1, 2)))
    return jnp.mean(per_ex) / float(t * f) ** 2
