"""Parallelism tests on the 8-device virtual CPU mesh: DP numerical
equivalence with single-device, TP sharding rules, full dp x tp step
(SURVEY.md §2.4 / §4 multi-chip strategy)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from danet_tpu import optim as optim_lib
from danet_tpu.models import DaNet
from danet_tpu.parallel import (batch_sharding, make_mesh, param_pspecs,
                                replicated, shard_params)


def _build(hp, encoder="toy", batch=8):
    hp.ENCODER_TYPE = encoder
    hp.BATCH_SIZE = batch
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = np.random.RandomState(0).randn(
        batch, hp.MAX_N_SIGNAL, 16, hp.FEATURE_SIZE, 2).astype(np.float32)
    return model, params, src


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_param_pspec_rules(fresh_hparams):
    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    specs = param_pspecs(params)
    lstm0 = specs["encoder"]["lstm0"]["fwd"]
    assert lstm0["wx"] == P(None, None, "model")
    assert lstm0["wh"] == P(None, None, "model")
    assert lstm0["b"] == P(None, "model")
    assert specs["encoder"]["output"]["w"] == P(None, "model")
    assert specs["infer_estimator"]["anchors"] == P()


def test_dp_matches_single_device(fresh_hparams):
    """Data-parallel loss/grads over 8 devices == single-device values."""
    model, params, src = _build(fresh_hparams, batch=8)

    def loss_fn(p, x):
        return model.train_loss(p, x, None)[0]

    # single device
    l1 = jax.jit(loss_fn)(params, src)
    g1 = jax.jit(jax.grad(loss_fn))(params, src)

    # 8-way data parallel
    mesh = make_mesh(8, 1)
    p_sh = shard_params(mesh, params)
    x_sh = jax.device_put(src, batch_sharding(mesh))
    l8 = jax.jit(loss_fn)(p_sh, x_sh)
    g8 = jax.jit(jax.grad(loss_fn))(p_sh, x_sh)

    np.testing.assert_allclose(float(l1), float(l8), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g8)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=1e-4)


def test_tp_matches_single_device(fresh_hparams):
    """Tensor-parallel (model-axis) forward == replicated forward."""
    model, params, src = _build(fresh_hparams, encoder="bilstm-orig",
                                batch=4)

    def loss_fn(p, x):
        return model.train_loss(p, x, None)[0]

    l1 = float(jax.jit(loss_fn)(params, src))
    mesh = make_mesh(2, 4)  # 4-way TP (hdim=300 divides by 4, not 8)
    p_sh = shard_params(mesh, params)
    x_sh = jax.device_put(src, batch_sharding(mesh))
    l8 = float(jax.jit(loss_fn)(p_sh, x_sh))
    np.testing.assert_allclose(l1, l8, rtol=1e-4)

    # on an 8-way model axis, indivisible dims fall back to replication
    mesh8 = make_mesh(1, 8)
    specs8 = param_pspecs(params, mesh8)
    assert specs8["encoder"]["lstm0"]["fwd"]["wx"] == P()   # h=300 % 8 != 0
    assert specs8["encoder"]["output"]["w"] == P()          # 2580 % 8 != 0


def test_full_sharded_train_step_dp_tp(fresh_hparams):
    """One full fwd+bwd+update step on a 4x2 (data x model) mesh."""
    hp = fresh_hparams
    model, params, src = _build(hp, encoder="bilstm-orig", batch=8)
    mesh = make_mesh(4, 2)
    optimizer = optim_lib.make_optimizer(hp)
    p_sh = shard_params(mesh, params)
    opt_state = jax.jit(optimizer.init)(p_sh)
    x_sh = jax.device_put(src, batch_sharding(mesh))

    @jax.jit
    def step(p, s, x):
        (loss, aux), grads = jax.value_and_grad(
            model.train_loss, has_aux=True)(p, x, None)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    p2, s2, loss = step(p_sh, opt_state, x_sh)
    jax.block_until_ready(p2)
    assert np.isfinite(float(loss))
    # params actually moved
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(p2)))
    assert moved


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    loss, snr = jax.jit(fn)(*args)
    assert np.isfinite(float(loss)) and np.isfinite(float(snr))


def test_host_batch_slice_single_process():
    from danet_tpu.parallel import multihost
    assert multihost.host_batch_slice(32) == slice(0, 32)
    assert multihost.initialize() is False  # no coordinator configured


def test_multihost_two_process_training(tmp_path):
    """REAL multi-process training: 2 CPU processes (4 virtual devices
    each) join a jax.distributed cluster over gloo and run 2 Trainer
    epochs on the toy dataset.  Exercises multihost.initialize,
    host_batch_slice, make_array_from_process_local_data assembly and the
    crc32-seeded shared epoch shuffles; asserts both hosts end with
    identical parameters (SURVEY.md §2.4 elasticity row)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(tmp_path)],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")[-4000:]

    results = []
    for pid in range(2):
        with open(os.path.join(str(tmp_path), "result_%d.json" % pid)) as f:
            results.append(json.load(f))
    assert results[0]["epoch"] == results[1]["epoch"] == 2
    assert results[0]["step"] == results[1]["step"] == 20
    assert np.isfinite(results[0]["checksum"])
    # identical replicated state on both hosts
    np.testing.assert_allclose(
        results[0]["checksum"], results[1]["checksum"], rtol=1e-6)
    np.testing.assert_allclose(results[0]["lr"], results[1]["lr"])


def test_sequence_parallel_bilstm_halo(fresh_hparams):
    """Chunked BiLSTM over a 'seq' mesh axis: error vs the exact scan is
    bounded at the chunk boundaries and shrinks with halo length."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.seq_parallel import bilstm_stack_sp
    from danet_tpu.ops import rnn

    B, T, F, H = 2, 128, 12, 16
    layers = [rnn.bilstm_init(jax.random.PRNGKey(i), F if i == 0 else 2 * H,
                              H) for i in range(2)]
    x = jnp.asarray(np.random.RandomState(0).randn(B, T, F)
                    .astype(np.float32))

    # exact sequential reference
    y = x
    for p in layers:
        y = rnn.bilstm_apply(p, y, "tanh")
    exact = np.asarray(y)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))

    def err(halo):
        out = np.asarray(bilstm_stack_sp(layers, x, mesh, halo=halo,
                                         scheme="halo"))
        return np.abs(out - exact).mean()

    e_small, e_big = err(4), err(24)
    assert e_big < e_small, (e_small, e_big)
    assert e_big < 0.05 * np.abs(exact).mean() + 1e-3, e_big


def test_sequence_parallel_bilstm_relay_exact(fresh_hparams):
    """The default SP_RNN_SCHEME='relay' reproduces the dense BiLSTM stack
    EXACTLY at S=4 — forward outputs and parameter gradients (VERDICT r2:
    the flagship family's SP was the only approximate one)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.seq_parallel import bilstm_stack_sp
    from danet_tpu.ops import rnn

    B, T, F, H = 2, 64, 12, 16
    layers = [rnn.bilstm_init(jax.random.PRNGKey(i), F if i == 0 else 2 * H,
                              H) for i in range(2)]
    x = jnp.asarray(np.random.RandomState(0).randn(B, T, F)
                    .astype(np.float32))

    def dense(ps):
        y = x
        for p in ps:
            y = rnn.bilstm_apply(p, y, "tanh")
        return y

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    out = np.asarray(bilstm_stack_sp(layers, x, mesh))
    np.testing.assert_allclose(out, np.asarray(dense(layers)),
                               atol=2e-5, rtol=1e-5)

    g_dense = jax.grad(lambda ps: jnp.sum(dense(ps) ** 2))(layers)
    g_sp = jax.grad(lambda ps: jnp.sum(
        bilstm_stack_sp(ps, x, mesh) ** 2))(layers)
    for a, b in zip(jax.tree_util.tree_leaves(g_dense),
                    jax.tree_util.tree_leaves(g_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=1e-4)


def test_sequence_parallel_gru_relay_exact(fresh_hparams):
    """gru relay SP == dense GRU stack at S=4, fwd + grads."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.seq_parallel import gru_stack_sp
    from danet_tpu.ops import rnn

    B, T, F, H = 2, 64, 10, 12
    layers = [rnn.gru_init(jax.random.PRNGKey(i), F if i == 0 else H, H)
              for i in range(2)]
    x = jnp.asarray(np.random.RandomState(1).randn(B, T, F)
                    .astype(np.float32))

    def dense(ps):
        y = x
        for p in ps:
            y = rnn.gru_apply(p, y)
        return y

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    out = np.asarray(gru_stack_sp(layers, x, mesh))
    np.testing.assert_allclose(out, np.asarray(dense(layers)),
                               atol=2e-5, rtol=1e-5)
    g_dense = jax.grad(lambda ps: jnp.sum(dense(ps) ** 2))(layers)
    g_sp = jax.grad(lambda ps: jnp.sum(
        gru_stack_sp(ps, x, mesh) ** 2))(layers)
    for a, b in zip(jax.tree_util.tree_leaves(g_dense),
                    jax.tree_util.tree_leaves(g_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=1e-4)


def test_sequence_parallel_conv_bilstm_exact(fresh_hparams):
    """conv_bilstm_sp == the dense ConvBiLstmEncoder at S=2 and S=4, fwd
    + parameter gradients (VERDICT r4 item 5: first-class SP for the
    reference's measured-strongest architecture).  Conv halos, psum
    centerings and the relay BiLSTM core are all exact mechanisms."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.models.encoders import ConvBiLstmEncoder
    from danet_tpu.parallel.seq_parallel import conv_bilstm_sp

    hp = fresh_hparams
    hp.FFT_SIZE = 32  # FEATURE_SIZE 17 -> conv grid 32/8 = 4
    hp.EMBED_SIZE = 4
    hp.digest()
    enc = ConvBiLstmEncoder(hp, "encoder")
    params = enc.init(jax.random.PRNGKey(0))
    B, T = 2, 32
    x = jnp.asarray(np.random.RandomState(0).randn(
        B, T, hp.FEATURE_SIZE).astype(np.float32))

    dense = np.asarray(enc.apply(params, x))
    for s in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:s]), axis_names=("seq",))
        out = np.asarray(conv_bilstm_sp(
            params, x, mesh, hp.FFT_SIZE, hp.FEATURE_SIZE,
            hp.EMBED_SIZE, hp.RELU_LEAKAGE, "tanh"))
        np.testing.assert_allclose(out, dense, atol=2e-5, rtol=1e-5,
                                   err_msg="S=%d" % s)

    # dp x sp co-sharding: batch over 'data' in the same shard_map
    mesh_dp = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                   axis_names=("data", "seq"))
    out_dp = np.asarray(conv_bilstm_sp(
        params, x, mesh_dp, hp.FFT_SIZE, hp.FEATURE_SIZE,
        hp.EMBED_SIZE, hp.RELU_LEAKAGE, "tanh"))
    np.testing.assert_allclose(out_dp, dense, atol=2e-5, rtol=1e-5,
                               err_msg="dp2xsp2")

    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("seq",))
    g_dense = jax.grad(
        lambda p: jnp.sum(enc.apply(p, x) ** 2))(params)
    g_sp = jax.grad(lambda p: jnp.sum(conv_bilstm_sp(
        p, x, mesh, hp.FFT_SIZE, hp.FEATURE_SIZE, hp.EMBED_SIZE,
        hp.RELU_LEAKAGE, "tanh") ** 2))(params)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(g_dense),
            jax.tree_util.tree_leaves_with_path(g_sp)):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=1e-4, err_msg=str(ka))


def test_trainer_seq_parallel_conv_bilstm_step(fresh_hparams):
    """Trainer-reachable: MESH_SEQ=2 + ENCODER_TYPE=conv-bilstm-v1
    routes sequence-parallel and matches the dense single-device train
    step numerically."""
    import jax.numpy as jnp  # noqa: F401
    from danet_tpu.models import DaNet
    from danet_tpu.parallel import make_mesh
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "conv-bilstm-v1"
    hp.FFT_SIZE = 32
    hp.EMBED_SIZE = 4
    hp.BATCH_SIZE = 2
    hp.digest()
    flat = np.random.RandomState(0).rand(
        2 * hp.MAX_N_SIGNAL, 16, hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, 2, hp.MAX_N_SIGNAL)

    def one_step(n_seq):
        hp.MESH_SEQ = n_seq
        trainer = Trainer(DaNet(), name="cbsp%d" % n_seq)
        state = trainer.init_state(jax.random.PRNGKey(0))
        _, _, m = trainer._train_step(
            state["params"], state["opt_state"],
            trainer._put_batch(batch), jax.random.PRNGKey(1))
        return {k: float(v) for k, v in m.items()}

    m_sp = one_step(2)
    m_ref = one_step(1)
    for k in ("loss", "SNR"):
        np.testing.assert_allclose(
            m_sp[k], m_ref[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_sequence_parallel_relay_dp_cosharding(fresh_hparams):
    """relay SP with the batch co-sharded over 'data' (dp2 x sp2) still
    matches the dense stack exactly."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.seq_parallel import bilstm_stack_sp
    from danet_tpu.ops import rnn

    B, T, F, H = 4, 32, 8, 8
    layers = [rnn.bilstm_init(jax.random.PRNGKey(7), F, H)]
    x = jnp.asarray(np.random.RandomState(2).randn(B, T, F)
                    .astype(np.float32))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                axis_names=("data", "seq"))
    out = np.asarray(bilstm_stack_sp(layers, x, mesh))
    dense = np.asarray(rnn.bilstm_apply(layers[0], x, "tanh"))
    np.testing.assert_allclose(out, dense, atol=2e-5, rtol=1e-5)


def test_separate_sp_full_model(fresh_hparams):
    """Full sequence-parallel inference: matches single-device separate()
    closely with a generous halo."""
    from jax.sharding import Mesh
    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.BATCH_SIZE = 2
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    mix = np.random.RandomState(0).randn(
        2, 128, hp.FEATURE_SIZE, 2).astype(np.float32)

    exact = np.asarray(model.separate(params, jnp.asarray(mix)))
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    sp = np.asarray(model.separate_sp(params, jnp.asarray(mix), mesh,
                                      halo=24))
    assert sp.shape == exact.shape
    rel = np.abs(sp - exact).mean() / (np.abs(exact).mean() + 1e-9)
    assert rel < 0.05, rel


def test_pipeline_parallel_bilstm_stack(fresh_hparams):
    """GPipe microbatch pipeline over 4 stages == sequential stack."""
    from jax.sharding import Mesh
    from danet_tpu.parallel.pipeline import bilstm_stack_pipelined
    from danet_tpu.ops import rnn
    import jax.numpy as jnp

    B, T, F, H = 8, 12, 10, 7
    layers = [rnn.bilstm_init(jax.random.PRNGKey(i),
                              F if i == 0 else 2 * H, H)
              for i in range(4)]
    x = jnp.asarray(np.random.RandomState(0).randn(B, T, F)
                    .astype(np.float32))
    y = x
    for p in layers:
        y = rnn.bilstm_apply(p, y, "tanh")
    exact = np.asarray(y)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("pipe",))
    out = np.asarray(bilstm_stack_pipelined(
        layers, x, mesh, n_micro=4))
    np.testing.assert_allclose(out, exact, atol=2e-5, rtol=1e-4)


def test_pipeline_parallel_gradients(fresh_hparams):
    """Differentiating THROUGH the GPipe schedule (ppermute + cond +
    fori_loop) matches the sequential stack's gradients — for 4 stages of
    1 layer and 2 stages of 2 layers."""
    from jax.sharding import Mesh
    from danet_tpu.parallel.pipeline import bilstm_stack_pipelined
    from danet_tpu.ops import rnn

    B, T, F, H = 8, 12, 10, 7
    layers = [rnn.bilstm_init(jax.random.PRNGKey(i),
                              F if i == 0 else 2 * H, H)
              for i in range(4)]
    x = jnp.asarray(np.random.RandomState(0).randn(B, T, F)
                    .astype(np.float32))

    def seq_loss(ls):
        y = x
        for p in ls:
            y = rnn.bilstm_apply(p, y, "tanh")
        return jnp.sum(jnp.sin(y))

    l_ref, g_ref = jax.value_and_grad(seq_loss)(layers)

    for n_stages, n_micro in ((4, 4), (2, 2)):
        mesh = Mesh(np.asarray(jax.devices()[:n_stages]), ("pipe",))

        def pp_loss(ls):
            return jnp.sum(jnp.sin(bilstm_stack_pipelined(
                ls, x, mesh, n_micro=n_micro)))

        l_pp, g_pp = jax.jit(jax.value_and_grad(pp_loss))(layers)
        np.testing.assert_allclose(float(l_ref), float(l_pp), rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                        jax.tree_util.tree_leaves(g_pp)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=5e-5, rtol=1e-4)


def test_mesh_from_hparams_pipe_expert(fresh_hparams):
    """MESH_PIPE/MESH_EXPERT configs produce meshes with the extra axes."""
    from danet_tpu.parallel.sharding import mesh_from_hparams
    hp = fresh_hparams
    hp.MESH_DATA, hp.MESH_PIPE = 2, 4
    mesh = mesh_from_hparams(hp)
    assert dict(mesh.shape) == {"data": 2, "model": 1, "pipe": 4}
    hp.MESH_PIPE, hp.MESH_EXPERT = 1, 2
    hp.MESH_DATA = 4
    mesh = mesh_from_hparams(hp)
    assert dict(mesh.shape) == {"data": 4, "model": 1, "expert": 2}


def test_trainer_pipeline_parallel_step(fresh_hparams):
    """A Trainer train step with MESH_PIPE=4 (dp=2 x pp=4) runs on the CPU
    mesh and matches the unpipelined step numerically (dropout off)."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.BATCH_SIZE = 8
    # 4 microbatches of 2 rows: 2 rows split over dp=2 ENGAGES the
    # pipeline's data-sharded row path (regression: the loop carries must
    # be varying over 'data' too, not just 'pipe')
    hp.PIPE_MICROBATCHES = 4
    hp.DROPOUT_KEEP_PROB = 1.0
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_pipe, n_data):
        hp.MESH_PIPE, hp.MESH_DATA = n_pipe, n_data
        trainer = Trainer(DaNet(), name="pp%d" % n_pipe)
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_pp, params_pp = one_step(4, 2)
    loss_ref, params_ref = one_step(1, 1)
    np.testing.assert_allclose(loss_pp, loss_ref, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                    jax.tree_util.tree_leaves(params_pp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-5, rtol=1e-4)


def test_mesh_from_hparams_seq(fresh_hparams):
    """MESH_SEQ config produces a mesh with a trailing 'seq' axis."""
    from danet_tpu.parallel.sharding import mesh_from_hparams
    hp = fresh_hparams
    hp.MESH_DATA, hp.MESH_SEQ = 2, 4
    mesh = mesh_from_hparams(hp)
    assert dict(mesh.shape) == {"data": 2, "model": 1, "seq": 4}


def test_mesh_strategy_encoder_guard(fresh_hparams):
    """Configuring a MESH_* strategy the encoder cannot route fails at
    model build instead of silently replicating."""
    hp = fresh_hparams
    hp.ENCODER_TYPE = "toy"
    hp.digest()
    for key in ("MESH_SEQ", "MESH_PIPE", "MESH_EXPERT"):
        setattr(hp, key, 2)
        with pytest.raises(ValueError):
            DaNet()
        setattr(hp, key, 1)
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.MESH_PIPE = hp.MESH_SEQ = 2  # mutually exclusive routes
    with pytest.raises(ValueError):
        DaNet()


def test_effective_bucket_seq_alignment(fresh_hparams):
    """Under MESH_SEQ the time bucket rounds up so every padded T divides
    over the 'seq' axis."""
    from danet_tpu.train.trainer import effective_bucket
    hp = fresh_hparams
    hp.TIME_BUCKET, hp.MESH_SEQ = 12, 1
    assert effective_bucket(hp) == 12
    hp.MESH_SEQ = 8
    assert effective_bucket(hp) == 24    # lcm(12, 8)
    hp.TIME_BUCKET = None
    assert effective_bucket(hp) == 8     # unbucketed -> pad to n_seq
    hp.MESH_SEQ = 1
    assert effective_bucket(hp) is None
    # segment-granular encoder: pad unit widens to DPRNN_CHUNK * MESH_SEQ
    hp.ENCODER_TYPE = "dprnn-v1"
    hp.DPRNN_CHUNK = 8
    hp.MESH_SEQ, hp.TIME_BUCKET = 2, 12
    assert effective_bucket(hp) == 48    # lcm(12, 8*2)
    hp.TIME_BUCKET = None
    assert effective_bucket(hp) == 16    # unbucketed -> P * n_seq
    # conv-bilstm: chunks must land on the double-pooled grid (4 * S)
    hp.ENCODER_TYPE = "conv-bilstm-v1"
    hp.MESH_SEQ, hp.TIME_BUCKET = 2, 12
    assert effective_bucket(hp) == 24    # lcm(12, 4*2)
    hp.TIME_BUCKET = None
    assert effective_bucket(hp) == 8     # unbucketed -> 4 * n_seq


def test_trainer_seq_parallel_attention_step(fresh_hparams):
    """A Trainer train step with MESH_SEQ=2 (dp=2 x sp=2, attn-v1)
    matches the single-device step numerically for both SP collective
    patterns — T-sharded attention is exact."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 32
    hp.ATTN_LAYERS = 2
    hp.ATTN_HEADS = 4
    hp.BATCH_SIZE = 4
    hp.DROPOUT_KEEP_PROB = 1.0
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_seq, n_data, sp_attn):
        hp.MESH_SEQ, hp.MESH_DATA, hp.SP_ATTN = n_seq, n_data, sp_attn
        trainer = Trainer(DaNet(), name="sp%d%s" % (n_seq, sp_attn))
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_ref, params_ref = one_step(1, 1, "ring")
    for kind in ("ring", "ulysses"):
        loss_sp, params_sp = one_step(2, 2, kind)
        np.testing.assert_allclose(loss_sp, loss_ref, rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                        jax.tree_util.tree_leaves(params_sp)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=5e-5, rtol=1e-4)


def test_trainer_seq_parallel_bilstm_step(fresh_hparams):
    """A Trainer train step with MESH_SEQ=2 (dp=2 x sp=2, bilstm-orig):
    with halo == chunk length the 2-chunk halo scheme is exact, so the
    step matches the single-device step numerically; and the dropout
    path runs finite."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "bilstm-orig"
    hp.BATCH_SIZE = 4
    hp.DROPOUT_KEEP_PROB = 1.0
    hp.SP_HALO = 8   # == T/2: full-chunk warmup -> exact at S=2
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_seq, n_data, keep=1.0):
        hp.MESH_SEQ, hp.MESH_DATA = n_seq, n_data
        hp.DROPOUT_KEEP_PROB = keep
        trainer = Trainer(DaNet(), name="spb%d_%g" % (n_seq, keep))
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_sp, params_sp = one_step(2, 2)
    loss_ref, params_ref = one_step(1, 1)
    np.testing.assert_allclose(loss_sp, loss_ref, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                    jax.tree_util.tree_leaves(params_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-5, rtol=1e-4)
    loss_drop, _ = one_step(2, 2, keep=0.8)
    assert np.isfinite(loss_drop)


def test_trainer_seq_parallel_gru_step(fresh_hparams):
    """A Trainer train step with MESH_SEQ=2 (gru-v1): exact at S=2 with
    halo == chunk, matching the single-device step."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "gru-v1"
    hp.BATCH_SIZE = 4
    hp.SP_HALO = 8
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_seq, n_data):
        hp.MESH_SEQ, hp.MESH_DATA = n_seq, n_data
        trainer = Trainer(DaNet(), name="spg%d" % n_seq)
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_sp, params_sp = one_step(2, 2)
    loss_ref, params_ref = one_step(1, 1)
    np.testing.assert_allclose(loss_sp, loss_ref, rtol=1e-5)
    # hdim=600 accumulations: a handful of elements land ~1e-4 apart from
    # reduction-order alone
    for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                    jax.tree_util.tree_leaves(params_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-4)


def test_trainer_expert_parallel_step(fresh_hparams):
    """A Trainer train step with MESH_EXPERT=2 (dp=4 x ep=2, moe-v1)
    matches the dense-MoE step numerically."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "moe-v1"
    hp.ATTN_DIM = 32
    hp.ATTN_LAYERS = 2
    hp.MOE_EXPERTS = 4
    hp.BATCH_SIZE = 4
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_expert, n_data):
        hp.MESH_EXPERT, hp.MESH_DATA = n_expert, n_data
        trainer = Trainer(DaNet(), name="ep%d" % n_expert)
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_ep, params_ep = one_step(2, 4)
    loss_ref, params_ref = one_step(1, 1)
    np.testing.assert_allclose(loss_ep, loss_ref, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                    jax.tree_util.tree_leaves(params_ep)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-5, rtol=1e-4)


def test_expert_parallel_moe(fresh_hparams):
    """Expert-sharded MoE MLP == dense single-device MoE; and the moe-v1
    encoder trains end to end."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.expert import moe_mlp, moe_mlp_ep
    from danet_tpu.ops import nn as nnops

    d, ff, E = 16, 32, 4
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {
        "router": nnops.uniform_init(k[0], (d, E), 0.1),
        "w_in": nnops.uniform_init(k[1], (E, d, ff), 0.2),
        "w_out": nnops.uniform_init(k[2], (E, ff, d), 0.2),
    }
    x = jnp.asarray(np.random.RandomState(0).randn(2, 6, d)
                    .astype(np.float32))
    dense = np.asarray(moe_mlp(params, x))
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("expert",))
    ep = np.asarray(moe_mlp_ep(params, x, mesh))
    np.testing.assert_allclose(ep, dense, atol=1e-5, rtol=1e-4)

    # full model with the moe-v1 encoder
    hp = fresh_hparams
    hp.ENCODER_TYPE = "moe-v1"
    hp.ATTN_DIM = 32
    hp.ATTN_LAYERS = 2
    hp.MOE_EXPERTS = 4
    hp.BATCH_SIZE = 2
    model = DaNet()
    p = model.init(jax.random.PRNGKey(0))
    src = np.random.RandomState(0).randn(
        2, hp.MAX_N_SIGNAL, 16, hp.FEATURE_SIZE, 2).astype(np.float32)
    loss, _ = jax.jit(model.train_loss)(p, src, None)
    assert np.isfinite(float(loss))
    g = jax.grad(lambda q: model.train_loss(q, src, None)[0])(p)
    gmoe = float(jnp.abs(g["encoder"]["block0"]["moe"]["w_in"]).sum())
    assert np.isfinite(gmoe) and gmoe > 0


def test_ring_attention_exact(fresh_hparams):
    """Ring attention over a 'seq' mesh == full attention, incl. key mask."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.ring_attention import ring_attention

    B, T, H, D = 2, 32, 3, 8
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    k = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    v = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    mask = jnp.asarray(rng.rand(B, T) > 0.2)

    # dense reference
    scale = 1.0 / np.sqrt(D)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = jnp.where(np.asarray(mask)[:, None, None, :], logits, -1e9)
    ref = jnp.einsum("bhqk,bkhd->bqhd",
                     jax.nn.softmax(logits, axis=-1), v)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    out = ring_attention(q, k, v, mesh, key_mask=mask)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_separate_sp_attention_exact(fresh_hparams):
    """Ring-attention SP inference is EXACT vs single-device separate()."""
    from jax.sharding import Mesh
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 64
    hp.ATTN_LAYERS = 2
    hp.BATCH_SIZE = 2
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    mix = np.random.RandomState(0).randn(
        2, 32, hp.FEATURE_SIZE, 2).astype(np.float32)
    exact = np.asarray(model.separate(params, jnp.asarray(mix)))
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    sp = np.asarray(model.separate_sp(params, jnp.asarray(mix), mesh))
    np.testing.assert_allclose(sp, exact, atol=2e-4, rtol=1e-3)


def test_ulysses_attention_exact(fresh_hparams):
    """Ulysses all-to-all attention over a 'seq' mesh == full attention,
    incl. key mask (H=4 heads, S=4 devices -> 1 head per device)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.ulysses import ulysses_attention

    B, T, H, D = 2, 32, 4, 8
    rng = np.random.RandomState(1)
    q = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    k = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    v = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    mask = jnp.asarray(rng.rand(B, T) > 0.2)

    scale = 1.0 / np.sqrt(D)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = jnp.where(np.asarray(mask)[:, None, None, :], logits, -1e9)
    ref = jnp.einsum("bhqk,bkhd->bqhd",
                     jax.nn.softmax(logits, axis=-1), v)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    out = ulysses_attention(q, k, v, mesh, key_mask=mask)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("pattern,window", [
    ("ring", 0), ("ulysses", 0), ("ring", 7), ("ulysses", 7)])
def test_sp_attention_gradients(fresh_hparams, pattern, window):
    """Both SP attention patterns differentiate EXACTLY like dense
    attention (q/k/v grads) — sequence-parallel TRAINING is supported,
    not just inference; window > 0 additionally runs the ATTN_CAUSAL
    band through the backward pass."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    if pattern == "ring":
        from danet_tpu.parallel.ring_attention import ring_attention as f
    else:
        from danet_tpu.parallel.ulysses import ulysses_attention as f

    B, T, H, D = 2, 16, 4, 8
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    k = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    v = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    mask = jnp.asarray(rng.rand(B, T) > 0.2)
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))

    def dense(q, k, v):
        s = 1.0 / np.sqrt(D)
        lg = jnp.einsum("bqhd,bkhd->bhqk", q, k) * s
        full = np.asarray(mask)[:, None, None, :]
        if window:
            qi, ki = np.arange(T)[:, None], np.arange(T)[None, :]
            full = full & ((ki <= qi) & (ki > qi - window))[None, None]
        lg = jnp.where(full, lg, -1e9)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(lg, -1), v)

    loss_sp = lambda q, k, v: jnp.sum(jnp.sin(f(q, k, v, mesh,
                                                key_mask=mask,
                                                causal_window=window)))
    loss_dn = lambda q, k, v: jnp.sum(jnp.sin(dense(q, k, v)))
    gs = jax.grad(loss_sp, argnums=(0, 1, 2))(q, k, v)
    gd = jax.grad(loss_dn, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(gs, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-5, rtol=1e-3)


@pytest.mark.parametrize("pattern", ["ring", "ulysses"])
def test_sp_attention_causal_window_exact(fresh_hparams, pattern):
    """The ATTN_CAUSAL banded mask composes EXACTLY with both SP
    collectives: causal_window > 0 equals dense attention under the same
    global band (ring rebuilds the band per fold from global block
    offsets; ulysses applies it on the gathered full sequence).  The
    window deliberately straddles device-chunk boundaries (w=11 with
    T/S=8 chunks)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    if pattern == "ring":
        from danet_tpu.parallel.ring_attention import ring_attention as f
    else:
        from danet_tpu.parallel.ulysses import ulysses_attention as f

    B, T, H, D, W = 2, 32, 4, 8, 11
    rng = np.random.RandomState(2)
    q = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    k = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    v = jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    mask = jnp.asarray(rng.rand(B, T) > 0.2)

    scale = 1.0 / np.sqrt(D)
    qi, ki = np.arange(T)[:, None], np.arange(T)[None, :]
    band = (ki <= qi) & (ki > qi - W)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    full = np.asarray(mask)[:, None, None, :] & band[None, None]
    logits = jnp.where(full, logits, -1e9)
    ref = jnp.einsum("bhqk,bkhd->bqhd",
                     jax.nn.softmax(logits, axis=-1), v)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    out = f(q, k, v, mesh, key_mask=mask, causal_window=W)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("sp_attn", ["ring", "ulysses"])
def test_separate_sp_causal_attention_exact(fresh_hparams, sp_attn):
    """Causal windowed attn-v1 (the online family) runs sequence-parallel
    EXACTLY: separate_sp over a 4-way 'seq' mesh == single-device
    separate() with the same ATTN_CAUSAL band."""
    from jax.sharding import Mesh
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 64
    hp.ATTN_LAYERS = 2
    hp.ATTN_CAUSAL = True
    hp.ATTN_LOOKBACK = 12   # straddles the T/S=8 device chunks
    hp.SP_ATTN = sp_attn
    hp.BATCH_SIZE = 2
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    mix = np.random.RandomState(0).randn(
        2, 32, hp.FEATURE_SIZE, 2).astype(np.float32)
    exact = np.asarray(model.separate(params, jnp.asarray(mix)))
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    sp = np.asarray(model.separate_sp(params, jnp.asarray(mix), mesh,
                                      sp_attn=sp_attn))
    np.testing.assert_allclose(sp, exact, atol=2e-4, rtol=1e-3)


def test_separate_sp_ulysses_exact(fresh_hparams):
    """Ulysses SP inference is EXACT vs single-device separate()."""
    from jax.sharding import Mesh
    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 64
    hp.ATTN_LAYERS = 2
    hp.BATCH_SIZE = 2
    hp.digest()
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    mix = np.random.RandomState(0).randn(
        2, 32, hp.FEATURE_SIZE, 2).astype(np.float32)
    exact = np.asarray(model.separate(params, jnp.asarray(mix)))
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    sp = np.asarray(model.separate_sp(params, jnp.asarray(mix), mesh,
                                      sp_attn="ulysses"))
    np.testing.assert_allclose(sp, exact, atol=2e-4, rtol=1e-3)


def test_trainer_full_epoch_on_mesh(fresh_hparams, tmp_path):
    """End-to-end Trainer.train over a dp=4 x tp=2 mesh (not just the
    step fns): batch sharding via _put_batch, sharded metrics flow,
    checkpoint save of sharded params."""
    import jax
    from danet_tpu.data.dataset import WhiteNoiseData
    from danet_tpu.models import DaNet
    from danet_tpu.train.trainer import Trainer

    hp = fresh_hparams
    hp.BATCH_SIZE = 8
    hp.MAX_TRAIN_LEN = 32
    hp.TIME_BUCKET = 32
    hp.MESH_DATA = 4
    hp.MESH_MODEL = 2
    hp.digest()
    ds = WhiteNoiseData()
    ds.install_and_load()
    trainer = Trainer(DaNet(), name="mesh", save_dir=str(tmp_path))
    assert dict(zip(trainer.mesh.axis_names, trainer.mesh.devices.shape)) \
        == {"data": 4, "model": 2}
    state = trainer.train(1, ds, save_on_epoch=True, valid_on_epoch=True)
    assert state["epoch"] == 1
    import os
    assert os.path.isdir(trainer.save_path(1))


def test_mesh_from_hparams_max_divisor(fresh_hparams):
    """Device-count selection takes the largest divisor of the batch, not
    the gcd (8 devices / batch 12 should use 6, not 4)."""
    from danet_tpu.parallel.sharding import mesh_from_hparams
    hp = fresh_hparams
    hp.MESH_DATA = 0
    hp.MESH_MODEL = 0
    hp.BATCH_SIZE = 12
    mesh = mesh_from_hparams(hp)  # 8 virtual devices in conftest
    assert mesh.shape["data"] == 6
    hp.BATCH_SIZE = 9
    assert mesh_from_hparams(hp).shape["data"] == 3


def test_sp_halo_zero_rejected(fresh_hparams):
    from danet_tpu.parallel.seq_parallel import bilstm_stack_sp
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    x = jnp.zeros((2, 64, 8), jnp.float32)
    with pytest.raises(AssertionError, match="halo must be >= 1"):
        bilstm_stack_sp([], x, mesh, halo=0, scheme="halo")
    with pytest.raises(ValueError, match="SP_RNN_SCHEME"):
        bilstm_stack_sp([], x, mesh, scheme="bogus")


def test_inference_dense_fallback_without_strategy_mesh(fresh_hparams):
    """A TRAINING config with MESH_SEQ/MESH_EXPERT > 1 must still run
    densely on hosts whose active mesh lacks those axes (demo, serving
    export) — matching the strategy-free output exactly — instead of
    demanding the multi-device training mesh."""
    from danet_tpu.parallel import set_active_mesh

    hp = fresh_hparams
    hp.ENCODER_TYPE = "moe-v1"
    hp.ATTN_DIM = 32
    hp.ATTN_LAYERS = 1
    hp.MOE_EXPERTS = 4
    hp.digest()
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(1).randn(
        2, 16, hp.FEATURE_SIZE).astype(np.float32))
    base = np.asarray(enc.apply(params, x))

    hp.MESH_SEQ, hp.MESH_EXPERT = 2, 2
    set_active_mesh(make_mesh(8, 1))  # inference-style mesh: no seq/expert
    try:
        out = np.asarray(enc.apply(params, x))
    finally:
        set_active_mesh(None)
        hp.MESH_SEQ, hp.MESH_EXPERT = 1, 1
    np.testing.assert_allclose(out, base, atol=1e-6)


def test_sp_remat_gradients_match(fresh_hparams):
    """REMAT must keep applying on the sequence-parallel routes (it was
    silently dropped there): checkpointed SP gradients == plain SP
    gradients, for the halo BiLSTM and the dual-path stacks."""
    from jax.sharding import Mesh
    from danet_tpu.ops import rnn as rnn_ops
    from danet_tpu.parallel.seq_parallel import (bilstm_stack_sp,
                                                 dprnn_stack_sp)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    k = jax.random.PRNGKey(0)
    layers = [rnn_ops.bilstm_init(jax.random.fold_in(k, 0), 6, 5),
              rnn_ops.bilstm_init(jax.random.fold_in(k, 1), 10, 5)]
    x = jnp.asarray(np.random.RandomState(1).randn(2, 32, 6)
                    .astype(np.float32))

    def loss(ps, remat):
        return jnp.sum(bilstm_stack_sp(ps, x, mesh, halo=8,
                                       remat=remat) ** 2)

    g_plain = jax.jit(jax.grad(lambda ps: loss(ps, False)))(layers)
    # checkpoint-inside-shard_map requires jit (as the Trainer provides)
    g_remat = jax.jit(jax.grad(lambda ps: loss(ps, True)))(layers)
    for a, b in zip(jax.tree_util.tree_leaves(g_plain),
                    jax.tree_util.tree_leaves(g_remat)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-4)

    hp = fresh_hparams
    hp.ENCODER_TYPE = "dprnn-v1"
    hp.DPRNN_DIM = 8
    hp.DPRNN_HIDDEN = 6
    hp.DPRNN_CHUNK = 8
    hp.DPRNN_HOP = 8
    hp.DPRNN_BLOCKS = 1
    hp.digest()
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(2))
    body = {key: v for key, v in params.items() if key != "output"}
    xd = jnp.asarray(np.random.RandomState(3).randn(
        2, 32, hp.FEATURE_SIZE).astype(np.float32))

    def dloss(ps, remat):
        return jnp.sum(dprnn_stack_sp(ps, xd, mesh, 8, 1, False,
                                      remat=remat) ** 2)

    g_plain = jax.jit(jax.grad(lambda ps: dloss(ps, False)))(body)
    g_remat = jax.jit(jax.grad(lambda ps: dloss(ps, True)))(body)
    for a, b in zip(jax.tree_util.tree_leaves(g_plain),
                    jax.tree_util.tree_leaves(g_remat)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-4)


def test_two_trainers_interleaved_meshes(fresh_hparams):
    """The active-mesh registry must bind each trainer's traces to ITS
    mesh: constructing a second Trainer (side eval) between another
    trainer's construction and its lazily-traced first step must not
    re-target the first's shard_map routes."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "attn-v1"
    hp.ATTN_DIM = 32
    hp.ATTN_LAYERS = 1
    hp.BATCH_SIZE = 4
    hp.MESH_SEQ, hp.MESH_DATA = 2, 2
    hp.digest()
    trainer_a = Trainer(DaNet(), name="mesh-a")
    state_a = trainer_a.init_state(jax.random.PRNGKey(0))

    # a second trainer with a seq-less mesh registers its own mesh
    hp.MESH_SEQ, hp.MESH_DATA = 1, 4
    hp.ENCODER_TYPE = "toy"
    Trainer(DaNet(), name="mesh-b")

    # back to A's config: its FIRST step traces now and must route over
    # A's dp2 x sp2 mesh, not B's
    hp.MESH_SEQ, hp.MESH_DATA = 2, 2
    hp.ENCODER_TYPE = "attn-v1"
    flat = np.random.RandomState(0).rand(
        hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16, hp.FEATURE_SIZE).astype(
            np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)
    _, _, m = trainer_a._train_step(
        state_a["params"], state_a["opt_state"],
        trainer_a._put_batch(batch), jax.random.PRNGKey(1))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("causal", [False, True])
def test_tcn_stack_sp_exact(fresh_hparams, causal):
    """Sequence-parallel TCN == dense TCN EXACTLY (finite conv context;
    the halo exchange reproduces the dense computation, and the ppermute
    zero-fill at ring edges is the conv's own zero padding)."""
    from jax.sharding import Mesh
    from danet_tpu.models.encoders import _LstmHead
    from danet_tpu.parallel.seq_parallel import tcn_stack_sp

    hp = fresh_hparams
    hp.ENCODER_TYPE = "tcn-v1"
    hp.TCN_DIM = 16
    hp.TCN_HIDDEN = 24
    hp.TCN_BLOCKS = 3
    hp.TCN_REPEATS = 2
    hp.TCN_CAUSAL = causal
    hp.digest()
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(1).randn(
        2, 64, hp.FEATURE_SIZE).astype(np.float32))

    dense = np.asarray(enc.apply(params, x))

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    xc = x - jnp.mean(x, axis=(1, 2), keepdims=True)
    body = {k: v for k, v in params.items() if k != "output"}
    h = tcn_stack_sp(
        body, xc, mesh,
        dilations=[enc._dilation(i) for i in range(enc._n_blocks())],
        kernel=3, causal=causal, alpha=hp.RELU_LEAKAGE)
    sp = np.asarray(_LstmHead.apply(params["output"], hp, h))
    np.testing.assert_allclose(sp, dense, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("inter_causal", [False, True])
def test_dprnn_stack_sp_exact(fresh_hparams, inter_causal):
    """Sequence-parallel DPRNN == dense DPRNN EXACTLY (non-overlapping
    segments shard cleanly; the inter-chunk scan re-shards positionwise
    via all_to_all — no halos, no approximation)."""
    from jax.sharding import Mesh
    from danet_tpu.models.encoders import _LstmHead
    from danet_tpu.parallel.seq_parallel import dprnn_stack_sp

    hp = fresh_hparams
    hp.ENCODER_TYPE = "dprnn-v1"
    hp.DPRNN_DIM = 16
    hp.DPRNN_HIDDEN = 12
    hp.DPRNN_CHUNK = 8
    hp.DPRNN_HOP = 8
    hp.DPRNN_BLOCKS = 2
    hp.DPRNN_INTER_CAUSAL = inter_causal
    hp.digest()
    enc = hp.get_encoder()(hp, "e")
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(1).randn(
        2, 64, hp.FEATURE_SIZE).astype(np.float32))
    dense = np.asarray(enc.apply(params, x))

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    xc = x - jnp.mean(x, axis=(1, 2), keepdims=True)
    body = {k: v for k, v in params.items() if k != "output"}
    h = dprnn_stack_sp(body, xc, mesh, 8, 2, inter_causal)
    sp = np.asarray(_LstmHead.apply(params["output"], hp, h))
    np.testing.assert_allclose(sp, dense, atol=5e-5, rtol=1e-4)


def test_trainer_seq_parallel_dprnn_step(fresh_hparams):
    """A Trainer train step with MESH_SEQ=2 (dp=2 x sp=2, dprnn-v1)
    matches the single-device step numerically; overlapping-segment
    configs are rejected up front."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "dprnn-v1"
    hp.DPRNN_DIM = 16
    hp.DPRNN_HIDDEN = 12
    hp.DPRNN_CHUNK = 8
    hp.DPRNN_HOP = 8
    hp.DPRNN_BLOCKS = 2
    hp.BATCH_SIZE = 4
    hp.DROPOUT_KEEP_PROB = 1.0
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_seq, n_data):
        hp.MESH_SEQ, hp.MESH_DATA = n_seq, n_data
        trainer = Trainer(DaNet(), name="spd%d" % n_seq)
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_sp, params_sp = one_step(2, 2)
    loss_ref, params_ref = one_step(1, 1)
    np.testing.assert_allclose(loss_sp, loss_ref, rtol=1e-5)
    # atol 2e-4: Adam's g/(sqrt(g^2)+eps) at step 1 amplifies the f32
    # reduction-order noise the all_to_all introduces in the head grad
    for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                    jax.tree_util.tree_leaves(params_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-4, rtol=1e-4)
    # overlapping segments (the offline default hop=P//2) cannot SP
    hp.MESH_SEQ, hp.MESH_DATA = 2, 2
    hp.DPRNN_HOP = 4
    trainer = Trainer(DaNet(), name="spd_bad")
    state = trainer.init_state(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="DPRNN_HOP == DPRNN_CHUNK"):
        trainer._train_step(state["params"], state["opt_state"],
                            trainer._put_batch(batch), jax.random.PRNGKey(1))


def test_trainer_seq_parallel_tcn_step(fresh_hparams):
    """A Trainer train step with MESH_SEQ=2 (dp=2 x sp=2, tcn-v1) matches
    the single-device step numerically — conv SP is exact."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "tcn-v1"
    hp.TCN_DIM = 16
    hp.TCN_HIDDEN = 24
    hp.TCN_BLOCKS = 3
    hp.TCN_REPEATS = 1
    hp.BATCH_SIZE = 4
    hp.DROPOUT_KEEP_PROB = 1.0
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def one_step(n_seq, n_data):
        hp.MESH_SEQ, hp.MESH_DATA = n_seq, n_data
        trainer = Trainer(DaNet(), name="spt%d" % n_seq)
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        return float(m["loss"]), jax.device_get(state["params"])

    loss_sp, params_sp = one_step(2, 2)
    loss_ref, params_ref = one_step(1, 1)
    np.testing.assert_allclose(loss_sp, loss_ref, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(params_ref),
                    jax.tree_util.tree_leaves(params_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-5, rtol=1e-4)


def test_moe_topk_dropless_matches_capacity_when_no_drops(fresh_hparams):
    """The dropless inference form == the capacity form whenever capacity
    cannot drop (cf large enough for every token) — same router, same
    gate renormalization; and it IS positionwise-pure: chunking the T
    axis changes nothing (the property streaming relies on)."""
    import jax.numpy as jnp
    from danet_tpu.parallel.expert import (moe_mlp_topk,
                                           moe_mlp_topk_dropless)
    from danet_tpu.ops import nn

    B, T, D, E, FF = 2, 24, 12, 4, 16
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    params = {
        "router": nn.uniform_init(ks[0], (D, E), 0.5),
        "w_in": nn.uniform_init(ks[1], (E, D, FF), 0.3),
        "w_out": nn.uniform_init(ks[2], (E, FF, D), 0.3),
    }
    x = jnp.asarray(np.random.RandomState(4).randn(B, T, D)
                    .astype(np.float32))
    want = moe_mlp_topk(params, x, k=2, capacity_factor=float(E))
    got = moe_mlp_topk_dropless(params, x, k=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    chunked = jnp.concatenate([
        moe_mlp_topk_dropless(params, x[:, :7], k=2),
        moe_mlp_topk_dropless(params, x[:, 7:], k=2)], axis=1)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(got),
                               atol=1e-6, rtol=1e-6)


def test_routed_moe_ep_matches_dense_oracle(fresh_hparams):
    """Top-k routed expert parallelism (all_to_all token dispatch with
    capacity) == the dense gather oracle applied per token shard, and
    the gate gradients survive the routing (VERDICT r2 item 5)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from danet_tpu.parallel.expert import moe_mlp_topk, moe_mlp_ep_routed
    from danet_tpu.ops import nn

    B, T, D, E, FF = 2, 32, 12, 4, 24
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {
        "router": nn.uniform_init(ks[0], (D, E), 0.5),
        "w_in": nn.uniform_init(ks[1], (E, D, FF), 0.3),
        "w_out": nn.uniform_init(ks[2], (E, FF, D), 0.3),
    }
    x = jnp.asarray(np.random.RandomState(0).randn(B, T, D)
                    .astype(np.float32))
    n_dev = 4
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), axis_names=("expert",))

    for k, cf in [(1, 1.0), (2, 1.25)]:
        # dense oracle applied shard-wise (capacity accounts per shard)
        t_loc = T // n_dev
        want = jnp.concatenate([
            moe_mlp_topk(params, x[:, s * t_loc:(s + 1) * t_loc],
                         k=k, capacity_factor=cf)
            for s in range(n_dev)], axis=1)
        got = moe_mlp_ep_routed(params, x, mesh, k=k, capacity_factor=cf)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)

    # gradients: router and expert weights both receive signal through
    # the routed path, and EP grads match the shard-wise oracle's
    def loss_ep(p):
        return jnp.sum(moe_mlp_ep_routed(p, x, mesh, k=2) ** 2)

    def loss_dense(p):
        t_loc = T // n_dev
        y = jnp.concatenate([
            moe_mlp_topk(p, x[:, s * t_loc:(s + 1) * t_loc], k=2)
            for s in range(n_dev)], axis=1)
        return jnp.sum(y ** 2)

    g_ep = jax.grad(loss_ep)(params)
    g_dense = jax.grad(loss_dense)(params)
    for key in ("router", "w_in", "w_out"):
        assert float(jnp.abs(g_ep[key]).sum()) > 0, key
        np.testing.assert_allclose(np.asarray(g_ep[key]),
                                   np.asarray(g_dense[key]),
                                   atol=1e-4, rtol=1e-4)


def test_routed_moe_capacity_drops_overflow(fresh_hparams):
    """With capacity far below demand, over-capacity tokens contribute
    zero (dropped), never garbage: a router forced to send every token
    to expert 0 with cap=1 keeps exactly one routed token."""
    import jax.numpy as jnp
    from danet_tpu.parallel.expert import _topk_dispatch

    N, E = 6, 4
    logits = jnp.zeros((N, E)).at[:, 0].set(10.0)  # all pick expert 0
    dispatch, combine = _topk_dispatch(logits, k=1, cap=1)
    # only token 0 occupies expert 0 slot 0; all others dropped
    assert float(dispatch.sum()) == 1.0
    assert float(dispatch[0, 0, 0]) == 1.0
    assert float(combine[1:].sum()) == 0.0


def test_routed_moe_trainer_step(fresh_hparams):
    """MOE_TOP_K>0 routes the moe-v1 trainer step through the routed EP
    dispatch; the step runs finite on a dp2 x ep2 mesh and moves the
    router."""
    from danet_tpu.train.trainer import Trainer, prepare_batch

    hp = fresh_hparams
    hp.ENCODER_TYPE = "moe-v1"
    hp.ATTN_DIM = 32
    hp.ATTN_LAYERS = 2
    hp.ATTN_HEADS = 4
    hp.MOE_EXPERTS = 4
    hp.MOE_TOP_K = 2
    hp.BATCH_SIZE = 4
    hp.MESH_DATA = 2
    hp.MESH_EXPERT = 2
    hp.digest()
    rngnp = np.random.RandomState(0)
    flat = rngnp.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 16,
                      hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)
    trainer = Trainer(DaNet(), name="ep-routed")
    state = trainer.init_state(jax.random.PRNGKey(0))
    r0 = np.asarray(state["params"]["encoder"]["block0"]["moe"]["router"])
    src = trainer._put_batch(batch)
    state["params"], state["opt_state"], m = trainer._train_step(
        state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["loss"]))
    r1 = np.asarray(state["params"]["encoder"]["block0"]["moe"]["router"])
    assert np.abs(r1 - r0).max() > 0  # router received gradient


def test_route_mesh_dense_fallback_is_narrow(fresh_hparams):
    """_route_mesh falls back DENSE only on the specific too-few-devices
    failure (MeshUnavailableError); any other mesh-construction error is
    a real bug and must propagate instead of silently dropping the
    configured parallelism (VERDICT r3 item 9)."""
    from danet_tpu.models.encoders import _route_mesh
    from danet_tpu.parallel import set_active_mesh
    hp = fresh_hparams
    set_active_mesh(None)
    try:
        hp.MESH_SEQ = 64  # cannot fit the 8 virtual devices -> dense
        assert _route_mesh("seq", 64) is None
        hp.MESH_SEQ = 1
        hp.MESH_PIPE = "garbage"  # broken config: must raise, not hide
        with pytest.raises((TypeError, ValueError)):
            _route_mesh("pipe", 2)
    finally:
        hp.MESH_SEQ = 1
        hp.MESH_PIPE = 1
        set_active_mesh(None)
