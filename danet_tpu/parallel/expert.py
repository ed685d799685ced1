"""Expert parallelism: MoE MLP sharded over an 'expert' axis.

SURVEY.md §2.4 marks EP out of scope for the reference (no MoE) but
requires that the registry design not preclude one; the 'moe-v1' encoder
(models/encoders.py) adds a mixture-of-experts MLP, and this module is its
multi-chip execution path.  Two dispatch forms:

* **Soft mixture** (``moe_mlp`` / ``moe_mlp_ep``, MOE_TOP_K=0): every
  token activates every expert, gated by a softmax.  EP shards expert
  weights one-group-per-device; every device computes its local experts'
  contributions for all tokens and the gated sum reduces with one psum —
  exact and all-to-all-free, but compute AND communication scale with
  the full activation set.  Right at small MOE_EXPERTS.

* **Top-k routed** (``moe_mlp_topk`` / ``moe_mlp_ep_routed``,
  MOE_TOP_K>=1): each token is dispatched to its top-k experts only,
  with a per-expert capacity C = ceil(k * tokens / E * MOE_CAPACITY
  _FACTOR) (GShard/Switch semantics: over-capacity tokens are dropped
  from that expert slot, earlier top-k slots claim capacity first; the
  kept top-k gates renormalize to sum 1).  EP shards the TOKENS over the
  'expert' axis too: each device routes its local token shard, packs
  [E, C, d] expert inputs, and one ``all_to_all`` sends each expert
  group to its owner device; the expert FFN runs on routed tokens only;
  a second ``all_to_all`` returns outputs for the local combine.
  Communication scales with routed tokens (k/E of the soft form's
  per-expert compute) — the form that scales to many experts.  Capacity
  is accounted per token shard (each device's C slots per expert), so
  the EP result is bit-identical to the dense oracle applied shard-wise
  (tested).  Routing runs in f32; dispatch/combine one-hots are
  constants to the gradient, gates are differentiated through (the
  standard straight-through-free top-k MoE gradient).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from danet_tpu.ops.nn import ee


def moe_mlp(params, x):
    """Dense soft-mixture MoE MLP on one device.

    params: router [d, E], w_in [E, d, ff], w_out [E, ff, d]
    x: [B, T, d] -> [B, T, d]
    """
    # gate logits + softmax in f32 (same policy as the attention softmax;
    # the gate tensor is tiny, precision matters for routing gradients)
    gate = jax.nn.softmax(
        jnp.einsum("btd,de->bte", x, params["router"].astype(x.dtype),
                   preferred_element_type=jnp.float32), axis=-1)
    hid = jax.nn.gelu(
        ee("btd,edh->ebth", x, params["w_in"].astype(x.dtype)))
    y = ee("ebth,ehd->ebtd", hid, params["w_out"].astype(x.dtype))
    return jnp.einsum("ebtd,bte->btd", y,
                      gate.astype(y.dtype),
                      preferred_element_type=jnp.float32).astype(x.dtype)


def moe_mlp_ep(params, x, mesh, expert_axis: str = "expert"):
    """Expert-parallel MoE MLP: experts sharded over `expert_axis`.

    Each device computes its local expert group for all tokens; the gated
    mixture reduces with one psum over the axis.
    """
    n_dev = mesh.shape[expert_axis]
    n_exp = params["w_in"].shape[0]
    assert n_exp % n_dev == 0, "experts must divide across the axis"

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=({"router": P(None, expert_axis),
                   "w_in": P(expert_axis), "w_out": P(expert_axis)}, P()),
        out_specs=P())
    def run(p, x_rep):
        # local gate logits for this device's expert slice; the softmax
        # normalizer needs all experts -> compute from gathered logits
        logits_local = jnp.einsum(
            "btd,de->bte", x_rep, p["router"].astype(x_rep.dtype),
            preferred_element_type=jnp.float32)
        logits = jax.lax.all_gather(
            logits_local, expert_axis, axis=2, tiled=True)
        gate = jax.nn.softmax(logits, axis=-1)
        # this device's slice of the gate
        idx = jax.lax.axis_index(expert_axis)
        per = n_exp // n_dev
        gate_local = jax.lax.dynamic_slice_in_dim(
            gate, idx * per, per, axis=2)

        hid = jax.nn.gelu(
            ee("btd,edh->ebth", x_rep, p["w_in"].astype(x_rep.dtype)))
        y = ee("ebth,ehd->ebtd", hid, p["w_out"].astype(x_rep.dtype))
        part = jnp.einsum("ebtd,bte->btd", y,
                          gate_local.astype(y.dtype),
                          preferred_element_type=jnp.float32
                          ).astype(x_rep.dtype)
        return jax.lax.psum(part, expert_axis)

    return run(params, x)


def moe_mlp_topk_dropless(params, x, k: int = 2):
    """Top-k routed MoE MLP with NO capacity dropping — the inference /
    streaming form.

    Capacity dropping (``moe_mlp_topk``) is a batch-global operation: a
    token's output depends on which OTHER tokens claimed its experts'
    slots, so a capacity-dropped forward is not positionwise-pure and
    cannot be reproduced by causal chunked streaming (different chunking
    -> different drops).  Serving-grade MoE inference is dropless: every
    token reaches its top-k experts.  Same gate semantics as
    ``_topk_dispatch`` (full-E softmax, kept gates renormalized to sum
    1), so wherever nothing would have dropped the two forms agree
    exactly.  Compute is the dense all-experts form gated sparsely —
    right at inference-scale MOE_EXPERTS."""
    probs = jax.nn.softmax(
        jnp.einsum("btd,de->bte", x, params["router"].astype(x.dtype),
                   preferred_element_type=jnp.float32).astype(
                       jnp.float32), axis=-1)
    gvals, gidx = jax.lax.top_k(probs, k)                 # [B, T, k]
    gvals = gvals / (jnp.sum(gvals, axis=-1, keepdims=True) + 1e-9)
    n_exp = params["w_in"].shape[0]
    gates = jnp.sum(
        jax.nn.one_hot(gidx, n_exp, dtype=jnp.float32)
        * gvals[..., None], axis=2)                       # [B, T, E]
    hid = jax.nn.gelu(
        ee("btd,edh->ebth", x, params["w_in"].astype(x.dtype)))
    y = ee("ebth,ehd->ebtd", hid, params["w_out"].astype(x.dtype))
    return jnp.einsum("ebtd,bte->btd", y, gates.astype(y.dtype),
                      preferred_element_type=jnp.float32).astype(x.dtype)


def _capacity(n_tokens: int, n_experts: int, k: int,
              capacity_factor: float) -> int:
    import math
    cap = max(1, int(math.ceil(k * n_tokens / n_experts
                               * capacity_factor)))
    # an expert can never hold more than every token: slots beyond
    # n_tokens are unoccupiable padding (reachable when E < k*cf), and
    # C scales the [N, E, C] dispatch/combine tensors directly
    return min(cap, n_tokens)


def _topk_dispatch(logits, k: int, cap: int):
    """GShard-style top-k dispatch/combine tensors from router logits.

    logits: [N, E] (f32).  Returns (dispatch [N, E, C] 0/1, combine
    [N, E, C] gated) — token n occupies slot c of expert e when it is
    among the first C tokens (in token order, earlier top-k slots first)
    routed to e.  Gates are the softmax probabilities of the KEPT top-k
    experts, renormalized to sum 1 per token (before capacity dropping,
    the standard order: renormalize, then drop).

    Scaling note: this is GShard's dense einsum dispatch — the [N, E, C]
    tensors are O(k * cf * N^2) elements since C grows with N, and the
    dispatch einsums add O(N * E * C * d) FLOPs.  That is the standard
    form (scatter-free, exact, clean VJP) and is cheap at this
    repo's MoE scales (N <= a few thousand per shard; under expert
    parallelism N is the PER-DEVICE token count, so the quadratic term
    shrinks with the mesh).  For very long sequences a sort/segment_sum
    packing would be the next step; the dropless inference form
    (``moe_mlp_topk_dropless``) already avoids C entirely."""
    n, e = logits.shape
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gvals, gidx = jax.lax.top_k(probs, k)                   # [N, k]
    gvals = gvals / (jnp.sum(gvals, axis=-1, keepdims=True) + 1e-9)
    dispatch = jnp.zeros((n, e, cap), jnp.float32)
    combine = jnp.zeros((n, e, cap), jnp.float32)
    taken = jnp.zeros((e,), jnp.float32)  # slots claimed by earlier k
    for s in range(k):
        oh = jax.nn.one_hot(gidx[:, s], e, dtype=jnp.float32)  # [N, E]
        pos = jnp.cumsum(oh, axis=0) - oh + taken[None, :]     # [N, E]
        keep = (pos < cap).astype(jnp.float32) * oh
        slot = jax.nn.one_hot(
            pos.astype(jnp.int32), cap, dtype=jnp.float32)     # [N, E, C]
        d_s = keep[..., None] * slot
        dispatch = dispatch + d_s
        combine = combine + jax.lax.stop_gradient(d_s) \
            * gvals[:, s][:, None, None]
        taken = taken + jnp.sum(keep, axis=0)
    return jax.lax.stop_gradient(dispatch), combine


def _routed_ffn(p_in, p_out, expert_in, dtype):
    """Expert FFN on packed inputs [E, C, d] -> [E, C, d]."""
    hid = jax.nn.gelu(ee("ecd,edh->ech", expert_in.astype(dtype),
                         p_in.astype(dtype)))
    return ee("ech,ehd->ecd", hid, p_out.astype(dtype))


def moe_mlp_topk(params, x, k: int = 2, capacity_factor: float = 1.25):
    """Dense (single-device) top-k routed MoE MLP — also the oracle the
    expert-parallel form is tested against.

    params: router [d, E], w_in [E, d, ff], w_out [E, ff, d]
    x: [B, T, d] -> [B, T, d]
    """
    b, t, d = x.shape
    n_exp = params["w_in"].shape[0]
    xf = x.reshape(b * t, d)
    logits = jnp.einsum("nd,de->ne", xf,
                        params["router"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    cap = _capacity(b * t, n_exp, k, capacity_factor)
    dispatch, combine = _topk_dispatch(logits, k, cap)
    expert_in = jnp.einsum("nec,nd->ecd", dispatch,
                           xf.astype(jnp.float32))
    y = _routed_ffn(params["w_in"], params["w_out"], expert_in, x.dtype)
    out = jnp.einsum("nec,ecd->nd", combine, y.astype(jnp.float32),
                     preferred_element_type=jnp.float32)
    return out.astype(x.dtype).reshape(b, t, d)


def moe_mlp_ep_routed(params, x, mesh, k: int = 2,
                      capacity_factor: float = 1.25,
                      expert_axis: str = "expert"):
    """Top-k routed expert-parallel MoE MLP (module docstring).

    Tokens shard over `expert_axis` (the T axis; T must divide), expert
    weights shard one-group-per-device; two all_to_alls move exactly the
    routed [E, C, d] token packets.  Bit-identical to ``moe_mlp_topk``
    applied per token shard (capacity accounts per shard).
    """
    n_dev = mesh.shape[expert_axis]
    n_exp = params["w_in"].shape[0]
    assert n_exp % n_dev == 0, "experts must divide across the axis"
    assert x.shape[1] % n_dev == 0, "T must divide across the expert axis"
    per = n_exp // n_dev

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=({"router": P(None, expert_axis),
                   "w_in": P(expert_axis), "w_out": P(expert_axis)},
                  P(None, expert_axis)),
        out_specs=P(None, expert_axis))
    def run(p, x_loc):
        b, t_loc, d = x_loc.shape
        n = b * t_loc
        xf = x_loc.reshape(n, d)
        # the router needs ALL experts' logits; the router matrix is
        # sharded [d, E/n_dev] — gather it (tiny) rather than the tokens
        router = jax.lax.all_gather(p["router"], expert_axis,
                                    axis=1, tiled=True)
        logits = jnp.einsum("nd,de->ne", xf, router.astype(xf.dtype),
                            preferred_element_type=jnp.float32)
        cap = _capacity(n, n_exp, k, capacity_factor)
        dispatch, combine = _topk_dispatch(logits, k, cap)
        expert_in = jnp.einsum("nec,nd->ecd", dispatch,
                               xf.astype(jnp.float32))
        # dispatch all_to_all: [E, C, d] -> each device keeps its own
        # `per` experts with every shard's C slots concatenated
        recv = jax.lax.all_to_all(expert_in, expert_axis,
                                  split_axis=0, concat_axis=1, tiled=True)
        y = _routed_ffn(p["w_in"], p["w_out"], recv, x_loc.dtype)
        # return all_to_all: [per, n_dev*C, d] -> [E, C, d] back in the
        # dispatching shard's layout
        y = jax.lax.all_to_all(y.astype(jnp.float32), expert_axis,
                               split_axis=1, concat_axis=0, tiled=True)
        out = jnp.einsum("nec,ecd->nd", combine, y,
                         preferred_element_type=jnp.float32)
        return out.astype(x_loc.dtype).reshape(b, t_loc, d)

    return run(params, x)
