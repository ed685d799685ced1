"""Device mesh + sharding rules: data / tensor parallelism via GSPMD.

The reference is single-process, single-device (README.md:226, SURVEY.md
§2.4).  This module is the replacement: a ``('data', 'model')``
``jax.sharding.Mesh``, path-based PartitionSpec rules for the parameter
pytree, and helpers to place batches/params.  XLA's SPMD partitioner then
inserts the collectives (gradient psum over 'data'; all-gathers for the
tensor-sharded LSTM gate GEMMs over 'model') — no hand-written NCCL/MPI.

Sharding layout:
  * batch axis of every input  -> 'data'   (pure data parallelism)
  * LSTM gate weights [in,4,h] -> shard h on 'model' (each gate's hidden
    slice is local to a shard; gate elementwise math needs no comms)
  * gate biases [4,h]          -> shard h on 'model'
  * output-head / MLP weights [in, out] -> shard out on 'model'
  * conv kernels, anchors, small biases -> replicated
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from danet_tpu.hparams import hparams


class MeshUnavailableError(RuntimeError):
    """The configured mesh factors do not fit the available devices.

    The ONE mesh failure model code may fall back densely on (the
    inference-host case: a MESH_* training config running demo/serving
    on a small host).  Any other error escaping mesh construction is a
    genuine bug and must propagate (VERDICT r3 item 9 — the old blanket
    ``except Exception`` in encoders._route_mesh silently routed broken
    configs dense)."""


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              devices=None, n_pipe: int = 1, n_expert: int = 1,
              n_seq: int = 1) -> Mesh:
    """Build a mesh over the available devices.

    Axes: always ('data', 'model'); a 'seq' axis (sequence-parallel
    chunks, parallel/seq_parallel.py + ring/ulysses attention), a 'pipe'
    axis (pipeline stages, parallel/pipeline.py) and an 'expert' axis
    (MoE expert groups, parallel/expert.py) are appended only when their
    size exceeds 1, so plain dp/tp meshes keep their 2-axis shape.  Axis
    order carries no topology assumption: NVLink joins the cards all to
    all.  With no explicit factors, all devices go to the 'data' axis
    (pure DP is the north-star upgrade over the reference's single-GPU
    limit).
    """
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    n_pipe = int(n_pipe or 1)
    n_expert = int(n_expert or 1)
    n_seq = int(n_seq or 1)
    rest = n_pipe * n_expert * n_seq
    if n_data is None and n_model is None:
        n_data, n_model = n_dev // rest, 1
    elif n_data is None:
        n_data = n_dev // (n_model * rest)
    elif n_model is None:
        n_model = n_dev // (n_data * rest)
    elif n_data * n_model * rest < n_dev:
        # fully-explicit factors that need fewer devices than available:
        # use a prefix of the device list, leave the rest idle
        devices = devices[: n_data * n_model * rest]
        n_dev = len(devices)
    if n_data * n_model * rest != n_dev:
        raise MeshUnavailableError(
            "mesh %dx%dx%dx%dx%d != %d devices"
            % (n_data, n_model, n_pipe, n_expert, n_seq, n_dev))
    shape = [n_data, n_model]
    names = ["data", "model"]
    if n_pipe > 1:
        shape.append(n_pipe)
        names.append("pipe")
    if n_expert > 1:
        shape.append(n_expert)
        names.append("expert")
    if n_seq > 1:
        shape.append(n_seq)
        names.append("seq")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=tuple(names))


def mesh_from_hparams(hp=None, devices=None) -> Mesh:
    """Mesh from MESH_DATA/MESH_MODEL/MESH_PIPE/MESH_EXPERT/MESH_SEQ
    config; the default (all-1 config on a multi-device host)
    data-parallelizes over as many devices as the batch size divides
    into, leaving the rest idle rather than failing."""
    hp = hp if hp is not None else hparams
    n_data = getattr(hp, "MESH_DATA", None) or None
    n_model = getattr(hp, "MESH_MODEL", None) or None
    n_pipe = int(getattr(hp, "MESH_PIPE", 1) or 1)
    n_expert = int(getattr(hp, "MESH_EXPERT", 1) or 1)
    n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
    devices = devices if devices is not None else jax.devices()
    if (n_data or 1) * (n_model or 1) * n_pipe * n_expert * n_seq > 1:
        return make_mesh(n_data, n_model, devices,
                         n_pipe=n_pipe, n_expert=n_expert, n_seq=n_seq)
    batch = getattr(hp, "BATCH_SIZE", len(devices))
    # largest device count that evenly divides the batch (gcd would
    # under-utilize, e.g. 8 devices / batch 12 -> 4 instead of 6)
    n_data = max(k for k in range(1, len(devices) + 1) if batch % k == 0)
    return make_mesh(n_data, 1, devices=devices[:n_data])


# ---------------------------------------------------------------------------
# active mesh: lets model code (encoders) reach the trainer's mesh for
# shard_map-based strategies (pipeline / expert parallelism) that cannot be
# expressed as parameter PartitionSpecs alone
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    """Register the mesh shard_map-based model paths should use (the
    Trainer calls this with its mesh at construction)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Mesh:
    """The registered mesh, or one freshly derived from hparams."""
    return _ACTIVE_MESH if _ACTIVE_MESH is not None else mesh_from_hparams()


# ---------------------------------------------------------------------------
# parameter partition rules
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, leaf, n_model: int = 1, n_expert: int = 1) -> P:
    """PartitionSpec for one parameter leaf, by name pattern + rank.

    A dimension is only sharded if divisible by the axis size; otherwise
    the leaf is replicated (e.g. hdim=300 on an 8-way model axis falls
    back cleanly).  On a mesh with an 'expert' axis, MoE expert weights
    shard one-group-per-device along their leading expert dim (matching
    parallel/expert.moe_mlp_ep's in_specs — no resharding at dispatch).
    """
    ndim = getattr(leaf, "ndim", 0)
    shape = getattr(leaf, "shape", ())
    last = path.split("/")[-1]

    def ok(dim_idx):
        return n_model <= 1 or shape[dim_idx] % n_model == 0

    def ok_e(dim_idx):
        return n_expert > 1 and shape[dim_idx] % n_expert == 0

    if last in ("wx", "wh", "wgx", "wgh") and ndim == 3 and ok(2):
        return P(None, None, "model")             # gates [in, G, h]
    if last in ("b", "bg") and ndim == 2 and ok(1):
        return P(None, "model")                   # gate bias [G, h]
    if last == "router" and ndim == 2 and ok_e(1):
        return P(None, "expert")                  # MoE router [d, E]
    if last in ("w", "wcx", "wch") and ndim == 2 and ok(1):
        return P(None, "model")                   # linear [in, out]
    if last == "w_in" and ndim == 3:
        if ok_e(0):
            return P("expert", None,
                     "model" if ok(2) else None)  # MoE [E, d, ff]
        if ok(2):
            return P(None, None, "model")         # col-par fallback
    if last == "w_out" and ndim == 3:
        if ok_e(0):
            return P("expert",
                     "model" if ok(1) else None, None)  # MoE [E, ff, d]
        if ok(1):
            return P(None, "model", None)         # row-par fallback
    if last in ("b", "bc") and ndim == 1 and ok(0):
        return P("model")                         # linear bias [out]
    return P()  # replicate (convs, anchors, scalars, indivisible dims)


def _path_str(path) -> str:
    parts = []
    for k in path:
        parts.append(str(getattr(k, "key", getattr(k, "idx", k))))
    return "/".join(parts)


def param_pspecs(params, mesh: Optional[Mesh] = None) -> dict:
    """PartitionSpec pytree matching a parameter pytree.

    If a mesh is given, dims not divisible by its 'model' axis size are
    replicated instead of sharded.
    """
    n_model = mesh.shape.get("model", 1) if mesh is not None else 1
    n_expert = mesh.shape.get("expert", 1) if mesh is not None else 1
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _leaf_spec(
            _path_str(path), leaf, n_model, n_expert),
        params)


def named_shardings(mesh: Mesh, pspecs):
    return jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), pspecs,
        is_leaf=lambda x: isinstance(x, P))


def shard_params(mesh: Mesh, params):
    """Place a parameter pytree onto the mesh per the partition rules."""
    shardings = named_shardings(mesh, param_pspecs(params, mesh))
    return jax.device_put(params, shardings)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Inputs are sharded along the leading batch axis over 'data'."""
    return NamedSharding(mesh, P("data"))


def stacked_batch_sharding(mesh: Mesh) -> NamedSharding:
    """[K, B, ...] stacks of K batches (TRAIN_STEPS_PER_CALL): the scan
    axis K is unsharded, the batch axis shards over 'data'."""
    return NamedSharding(mesh, P(None, "data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
