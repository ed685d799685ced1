"""Dense-banded vs chunked banded causal attention at long T (GPU).

ops/local_attention.py decomposes the ATTN_CAUSAL banded softmax into
T/C independent [C x 2C] blocks (exact; tests/test_modules.py).  The
claim to verify on hardware: at long T with a finite ATTN_LOOKBACK the
chunked form wins on both memory (O(T*C) vs O(T^2) logits) and time
(the dense form spends memory bandwidth materializing and masking mostly
-inf logits).  This prints per-layer forward and fwd+bwd times for both
paths across T, at the attn-v1 head geometry.

Method: 50 iterations ended by jax.block_until_ready; the dense path is
skipped where its [B, H, T, T] f32 logits would not fit device memory.

Run on the real chip:  python benchmarks/banded_attention.py
"""
from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

B, H, D, W = 8, 4, 64, 128


def timed(fn, *args, n_warmup=3, n_iters=50):
    import jax
    for _ in range(n_warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iters


def main():
    import jax
    import jax.numpy as jnp
    from danet_tpu.ops import nn
    from danet_tpu.ops.local_attention import (banded_attention_chunked,
                                               pick_chunk)
    from danet_tpu.models.encoders import AttentionEncoder

    rng = np.random.RandomState(0)
    ts = tuple(int(a) for a in sys.argv[1:]) or (512, 1024, 2048, 4096, 8192)
    print("%-7s %-6s %13s %13s %9s" % (
        "T", "chunk", "dense ms", "chunked ms", "speedup"), flush=True)
    for t in ts:
        c = pick_chunk(t, W)
        q, k, v = (jax.device_put(rng.randn(B, t, H, D).astype(np.float32))
                   for _ in range(3))
        km = jax.device_put(np.ones((B, t), bool))

        def dense(q, k, v, km, t=t):
            band = nn.causal_band(jnp.arange(t)[:, None],
                                  jnp.arange(t)[None, :], W)
            return AttentionEncoder._dense_attention(q, k, v, km, band=band)

        chunked = functools.partial(banded_attention_chunked,
                                    window=W, chunk=c)
        for tag, grad in (("fwd", False), ("fwd+bwd", True)):
            rows = {}
            for name, f in (("dense", dense), ("chunked", chunked)):
                if name == "dense" and B * H * t * t * 4 > 8e9:
                    rows[name] = None  # logits would blow HBM
                    continue
                if grad:
                    f = jax.grad(
                        lambda a, b_, c_, f=f: jnp.sum(
                            jnp.square(f(a, b_, c_, km))),
                        argnums=0)
                    g = jax.jit(lambda a, b_, c_, f=f: jnp.sum(f(a, b_, c_)))
                else:
                    g = jax.jit(lambda a, b_, c_, f=f: jnp.sum(f(a, b_, c_, km)))
                rows[name] = 1e3 * timed(g, q, k, v)
            d, ch = rows["dense"], rows["chunked"]
            print("%-7s %-6d %13s %13.3f %9s" % (
                "%d/%s" % (t, tag), c,
                "oom-skip" if d is None else "%.3f" % d, ch,
                "-" if d is None else "%.2fx" % (d / ch)), flush=True)


if __name__ == "__main__":
    main()
