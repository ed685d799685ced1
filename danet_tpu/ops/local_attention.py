"""Memory-linear EXACT banded causal attention (ATTN_CAUSAL, long T).

The single-program ATTN_CAUSAL path in models/encoders.py masks dense
[B, H, T, T] logits with the causal band — exact, but quadratic in T,
which defeats the point of a finite ATTN_LOOKBACK at the tl=512+
curriculum stages and long-form offline inference.  A banded flash
kernel is not needed: with a lookback window w and a chunk
size C >= w-1, every query in chunk s can only see keys in chunks s-1
and s, so banded attention decomposes into S = T/C independent
[C x 2C]-logit blocks — the standard sliding-window chunking (Longformer
local attention; also how the streaming K/V cache path already works,
one chunk at a time).

This is pure XLA: two batched GEMMs per layer on [B, S, C, 2C] logits —
O(T * C) memory instead of O(T^2) — with a clean autodiff gradient, and
it runs identically on CPU meshes.  The band
semantics are nn.causal_band, shared with the dense, ring/Ulysses SP and
streaming paths; since qpos - kpos depends only on in-chunk offsets, ONE
[C, 2C] band matrix serves every chunk.

Exactness: each query's visible key set (band AND key padding AND
existence) is identical to the dense banded path's, so the softmax sums
the same terms — equal up to float summation order (tested to tolerance,
forward and gradients).  Fully-masked rows (queries whose whole band is
padding) produce garbage in BOTH paths; downstream estimators weight
such frames by their (zero) mixture power, the same argument as the
flash wrapper's padded-query note.

No counterpart in the reference (no attention at all there); the
reference's long-sequence story is crop only (main.py MAX_TRAIN_LEN).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from danet_tpu.ops import nn


def pick_chunk(t: int, window: int) -> int | None:
    """Smallest divisor C of t with C >= w-1 (the coverage condition:
    query s*C+i's oldest visible key s*C+i-w+1 must lie in chunk s-1 or
    later, i.e. C >= w-1).  C = t (a single chunk) is allowed as the
    degenerate fallback; None only when even that is excluded."""
    need = max(1, window - 1)
    for c in range(need, t + 1):
        if t % c == 0:
            return c
    return None


def banded_attention_chunked(q, k, v, key_mask, window: int,
                             chunk: int | None = None):
    """attn_fn-contract banded causal attention: q/k/v [B, T, H, D],
    key_mask [B, T] bool -> [B, T, H, D].  Exact vs the dense
    causal_band path for every non-fully-masked query row."""
    b, t, h, d = q.shape
    c = chunk if chunk else pick_chunk(t, window)
    if c is None or t % c != 0 or c < max(1, window - 1):
        raise ValueError(
            "no valid chunk for T=%d, window=%d (chunk=%r)"
            % (t, window, chunk))
    s = t // c
    qc = q.reshape(b, s, c, h, d)
    kc = k.reshape(b, s, c, h, d)
    vc = v.reshape(b, s, c, h, d)
    # context = previous chunk ++ own chunk (zeros before chunk 0 —
    # masked out below via the context key mask, never attended)
    zk = jnp.zeros_like(kc[:, :1])
    kctx = jnp.concatenate(
        [jnp.concatenate([zk, kc[:, :-1]], axis=1), kc], axis=2)
    vctx = jnp.concatenate(
        [jnp.concatenate([zk, vc[:, :-1]], axis=1), vc], axis=2)
    km = key_mask.reshape(b, s, c)
    kmctx = jnp.concatenate(
        [jnp.concatenate([jnp.zeros_like(km[:, :1]), km[:, :-1]],
                         axis=1), km], axis=2)          # [B, S, 2C]

    # one band matrix for all chunks: the query's context position is
    # c + i, the key's is j; qpos - kpos = (c + i) - j is s-independent
    band = nn.causal_band(c + jnp.arange(c)[:, None],
                          jnp.arange(2 * c)[None, :], window)

    logits = nn.ee("bsqhd,bskhd->bshqk", qc, kctx) / jnp.sqrt(
        jnp.asarray(d, q.dtype))
    mask = kmctx[:, :, None, None, :] & band[None, None, None]
    logits = jnp.where(mask, logits.astype(jnp.float32),
                       jnp.asarray(-1e9, jnp.float32))
    attn = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    out = nn.ee("bshqk,bskhd->bsqhd", attn, vctx)
    return out.reshape(b, t, h, d)


def resolve_banded_attn_fn(hp, t: int, window: int, dense_fn):
    """Pick the single-program ATTN_CAUSAL implementation for length t.

    ATTN_LOCAL_CHUNK: 0/absent = auto (chunked when at least 8 chunks
    fit: with fewer the memory saving is small and the reshapes cost
    time; the crossover on the H100 is not measured yet,
    benchmarks/banded_attention.py); -1 = always dense; >0 = force that
    chunk size.
    """
    cfg = int(getattr(hp, "ATTN_LOCAL_CHUNK", 0) or 0)
    if cfg < 0:
        c = None
    elif cfg > 0:
        c = cfg
    else:
        c = pick_chunk(t, window)
        if c is not None and t // c < 8:
            c = None
    if c is None:
        band = nn.causal_band(jnp.arange(t)[:, None],
                              jnp.arange(t)[None, :], window)
        return functools.partial(dense_fn, band=band)
    return functools.partial(banded_attention_chunked,
                             window=window, chunk=c)
