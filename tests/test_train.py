"""End-to-end training smoke tests: loss decreases, checkpoints round-trip,
LR decay policies (SURVEY.md §4: toy-dataset train-smoke)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from danet_tpu.data.dataset import WhiteNoiseData
from danet_tpu.models import DaNet
from danet_tpu.train.trainer import Trainer, prepare_batch
from danet_tpu.parallel import make_mesh


def _tiny_hp(hp):
    hp.BATCH_SIZE = 4
    hp.MAX_TRAIN_LEN = 32
    hp.TIME_BUCKET = 32
    hp.digest()
    return hp


def test_loss_decreases_on_fixed_batch(fresh_hparams):
    """The core learning smoke: repeated steps on one batch reduce loss."""
    hp = _tiny_hp(fresh_hparams)
    hp.LR = 1e-3
    model = DaNet()
    trainer = Trainer(model, name="smoke",
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    # separable-by-construction sources: disjoint frequency supports, so an
    # ideal mask exists and gradient descent has signal to follow
    flat = rng.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 32,
                    hp.FEATURE_SIZE).astype(np.float32)
    flat[0::2, :, 1::2] = 0.0   # even utterances: even bins only
    flat[1::2, :, 0::2] = 0.0   # odd utterances: odd bins only
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)
    src = trainer._put_batch(batch)
    losses = []
    for i in range(25):
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src,
            jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses


def test_trainer_epoch_and_checkpoint_roundtrip(fresh_hparams, tmp_path):
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    model = DaNet()
    trainer = Trainer(model, name="ckpt-test", save_dir=str(tmp_path / "sv"))
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    state = trainer.train(1, dataset, save_on_epoch=True,
                          valid_on_epoch=True)
    assert state["step"] == 10  # toy dataset yields 10 batches/epoch
    assert os.path.exists(trainer.save_path(1))

    # checkpoint round-trip restores params AND optimizer state
    restored = trainer.load_params(
        trainer.init_state(jax.random.PRNGKey(42)), trainer.save_path(1))
    for a, b in zip(jax.tree_util.tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(restored["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(state["opt_state"]),
                    jax.tree_util.tree_leaves(restored["opt_state"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_lr_decay_fixed(fresh_hparams, tmp_path):
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    hp.LR_DECAY_TYPE = "fixed"
    hp.NUM_EPOCH_PER_LR_DECAY = 1
    model = DaNet()
    trainer = Trainer(model, name="lr-test", save_dir=str(tmp_path / "sv"))
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    state = trainer.train(2, dataset, save_on_epoch=False,
                          valid_on_epoch=False)
    lr = trainer.get_learn_rate(state)
    np.testing.assert_allclose(lr, hp.LR * hp.LR_DECAY ** 2, rtol=1e-5)


def test_lr_decay_cosine(fresh_hparams, tmp_path):
    """Cosine anneal: ends at LR * LR_DECAY after the invocation's
    epochs, decreasing monotonically."""
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    hp.LR_DECAY_TYPE = "cosine"
    hp.LR_DECAY = 0.1
    model = DaNet()
    trainer = Trainer(model, name="lr-cos", save_dir=str(tmp_path / "sv"))
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    state = trainer.init_state(jax.random.PRNGKey(0))
    lrs = []
    for _ in range(3):
        state = trainer.train(1, dataset, save_on_epoch=False,
                              valid_on_epoch=False, state=state,
                              lr=None if lrs else hp.LR)
        lrs.append(trainer.get_learn_rate(state))
    # 1-epoch invocations each anneal to their own floor; chained stages
    # keep decaying (each stage's base is the previous stage's end LR)
    assert lrs[0] < hp.LR and lrs[1] < lrs[0] and lrs[2] < lrs[1]
    np.testing.assert_allclose(lrs[0], hp.LR * hp.LR_DECAY, rtol=1e-5)


def test_adamw_optimizer(fresh_hparams, tmp_path):
    """adamw: registered, trains, and actually decays weights (a pure
    zero-gradient parameter shrinks toward zero)."""
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    hp.OPTIMIZER_TYPE = "adamw"
    hp.WEIGHT_DECAY = 0.1
    model = DaNet()
    trainer = Trainer(model, name="adamw", save_dir=str(tmp_path / "sv"))
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    state = trainer.train(1, dataset, save_on_epoch=False,
                          valid_on_epoch=False)
    assert np.isfinite(trainer.get_learn_rate(state))
    import optax
    from danet_tpu import optim as optim_lib
    opt = optim_lib.make_optimizer(hp)
    p = {"w": jnp.ones((4,))}
    s = opt.init(p)
    updates, s = opt.update({"w": jnp.zeros((4,))}, s, p)
    p2 = optax.apply_updates(p, updates)
    assert float(jnp.max(p2["w"])) < 1.0  # decay pulls toward zero


def test_unknown_lr_decay_raises(fresh_hparams, tmp_path):
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    hp.LR_DECAY_TYPE = "bogus"
    model = DaNet()
    trainer = Trainer(model, name="x", save_dir=str(tmp_path / "sv"))
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    with pytest.raises(ValueError):
        trainer.train(1, dataset, save_on_epoch=False, valid_on_epoch=False)


def test_prepare_batch_crop_and_bucket(fresh_hparams):
    hp = fresh_hparams
    flat = np.random.rand(6, 100, hp.FEATURE_SIZE).astype(np.float32)
    out = prepare_batch(flat, 3, 2, max_len=40, bucket=32)
    assert out.shape == (3, 2, 64, hp.FEATURE_SIZE, 2)  # 40 -> pad to 64
    assert (out[..., 1] == 0).all()  # real input -> zero imag
    out2 = prepare_batch(flat, 3, 2, max_len=None, bucket=None)
    assert out2.shape == (3, 2, 100, hp.FEATURE_SIZE, 2)


def test_determinism_same_seed_same_loss(fresh_hparams, tmp_path):
    """Same seed => identical loss sequence (functional-purity analogue of
    race detection, SURVEY.md §5)."""
    hp = _tiny_hp(fresh_hparams)
    model = DaNet()
    trainer = Trainer(model, name="det",
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    flat = np.random.RandomState(7).rand(
        hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 32, hp.FEATURE_SIZE).astype(
            np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    def run():
        state = trainer.init_state(jax.random.PRNGKey(5))
        src = trainer._put_batch(batch)
        out = []
        for i in range(3):
            state["params"], state["opt_state"], m = trainer._train_step(
                state["params"], state["opt_state"], src,
                jax.random.PRNGKey(i))
            out.append(float(m["loss"]))
        return out

    assert run() == run()


def test_nan_checks_mode(fresh_hparams, tmp_path):
    """NAN_CHECKS=true surfaces a NaN inside the step with checkify."""
    hp = _tiny_hp(fresh_hparams)
    hp.NAN_CHECKS = True
    model = DaNet()
    trainer = Trainer(model, name="nan",
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0))
    flat = np.random.RandomState(0).rand(
        hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 32, hp.FEATURE_SIZE).astype(
            np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)
    # clean batch passes
    state["params"], state["opt_state"], m = trainer._train_step(
        state["params"], state["opt_state"], trainer._put_batch(batch),
        jax.random.PRNGKey(1))
    assert np.isfinite(float(m["loss"]))
    # poisoned batch raises
    bad = batch.copy()
    bad[0, 0, 0, 0, 0] = np.nan
    with pytest.raises(Exception):
        out = trainer._train_step(
            state["params"], state["opt_state"], trainer._put_batch(bad),
            jax.random.PRNGKey(2))
        float(out[2]["loss"])


def test_si_snr_objective_learns(fresh_hparams):
    """TRAIN_LOSS_TYPE='pit-si-snr' (waveform uPIT through the on-device
    iSTFT) is differentiable end-to-end and reduces the loss."""
    hp = _tiny_hp(fresh_hparams)
    hp.TRAIN_LOSS_TYPE = "pit-si-snr"
    hp.LR = 1e-3
    model = DaNet()
    trainer = Trainer(model, name="sisnr",
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    flat = rng.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 32,
                    hp.FEATURE_SIZE).astype(np.float32)
    flat[0::2, :, 1::2] = 0.0
    flat[1::2, :, 0::2] = 0.0
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)
    src = trainer._put_batch(batch)
    losses = []
    for i in range(25):
        state["params"], state["opt_state"], m = trainer._train_step(
            state["params"], state["opt_state"], src,
            jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    # negative SI-SNR in dB: must drop by a few dB from the random init
    assert losses[-1] < losses[0] - 2.0, losses


def test_mix_snr_augmentation(fresh_hparams):
    """MIX_SNR_DB>0 draws per-source level offsets in-graph: the loss
    changes with the rng, and disabling it reproduces the baseline."""
    hp = _tiny_hp(fresh_hparams)
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    src = np.random.RandomState(0).rand(
        hp.BATCH_SIZE, hp.MAX_N_SIGNAL, 32, hp.FEATURE_SIZE, 2).astype(
            np.float32)
    base, _ = jax.jit(model.train_loss)(params, src, jax.random.PRNGKey(1))

    hp.MIX_SNR_DB = 10.0
    a, _ = jax.jit(model.train_loss)(params, src, jax.random.PRNGKey(1))
    b, _ = jax.jit(model.train_loss)(params, src, jax.random.PRNGKey(2))
    assert float(a) != float(base)  # gains applied
    assert float(a) != float(b)     # rng-dependent
    # gains are bounded: a 10 dB window cannot blow the loss up wildly
    assert 0.1 * float(base) < float(a) < 10.0 * float(base)

    hp.MIX_SNR_DB = 0.0
    off, _ = jax.jit(model.train_loss)(params, src, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(off), float(base), rtol=1e-6)


def test_unknown_train_loss_type_raises(fresh_hparams):
    hp = _tiny_hp(fresh_hparams)
    hp.TRAIN_LOSS_TYPE = "nope"
    model = DaNet()
    batch = np.zeros((hp.BATCH_SIZE, hp.MAX_N_SIGNAL, 32,
                      hp.FEATURE_SIZE, 2), np.float32)
    params = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        model.train_loss(params, batch, None)


def test_checkpoint_counters_restore_as_ints(fresh_hparams, tmp_path):
    """Resume regression: step/epoch must come back as python ints (a 0-d
    ndarray step breaks the JSONL metrics writer on the resumed run)."""
    hp = _tiny_hp(fresh_hparams)
    model = DaNet()
    trainer = Trainer(model, name="ints", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0))
    state["step"], state["epoch"] = 7, 3
    trainer.save_params(state, str(tmp_path / "ck"))
    restored = trainer.load_params(
        trainer.init_state(jax.random.PRNGKey(1)), str(tmp_path / "ck"))
    assert type(restored["step"]) is int and restored["step"] == 7
    assert type(restored["epoch"]) is int and restored["epoch"] == 3


def test_resumed_training_accumulates_epochs(fresh_hparams, tmp_path):
    """Epoch numbering is cumulative across checkpointed stages."""
    hp = _tiny_hp(fresh_hparams)
    ds = WhiteNoiseData()
    ds.install_and_load()
    model = DaNet()
    trainer = Trainer(model, name="cum", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.train(2, ds, save_on_epoch=False, valid_on_epoch=False)
    assert state["epoch"] == 2
    trainer.save_params(state, str(tmp_path / "latest"))
    state2 = trainer.load_params(
        trainer.init_state(jax.random.PRNGKey(1)), str(tmp_path / "latest"))
    state2 = trainer.train(1, ds, save_on_epoch=False,
                           valid_on_epoch=False, state=state2)
    assert state2["epoch"] == 3
    assert state2["step"] == state["step"] + 10  # 10 toy batches/epoch


def test_lr_survives_resume(fresh_hparams, tmp_path):
    """A resumed run continues at the checkpointed (decayed) LR unless the
    caller overrides it explicitly — mid-stage resume of a decaying run
    must NOT silently restart at hp.LR."""
    hp = _tiny_hp(fresh_hparams)
    hp.LR_DECAY_TYPE = "fixed"
    hp.NUM_EPOCH_PER_LR_DECAY = 1
    ds = WhiteNoiseData()
    ds.install_and_load()
    model = DaNet()
    trainer = Trainer(model, name="lrres", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.train(2, ds, save_on_epoch=False, valid_on_epoch=False)
    decayed = trainer.get_learn_rate(state)
    np.testing.assert_allclose(decayed, hp.LR * hp.LR_DECAY ** 2, rtol=1e-5)
    trainer.save_params(state, str(tmp_path / "mid"))

    restored = trainer.load_params(
        trainer.init_state(jax.random.PRNGKey(1)), str(tmp_path / "mid"))
    # the restored state already carries the decayed LR...
    np.testing.assert_allclose(
        trainer.get_learn_rate(restored), decayed, rtol=1e-6)
    # ...and train() without an explicit lr keeps decaying FROM it
    restored = trainer.train(1, ds, save_on_epoch=False,
                             valid_on_epoch=False, state=restored)
    np.testing.assert_allclose(
        trainer.get_learn_rate(restored), decayed * hp.LR_DECAY, rtol=1e-5)
    # an explicit override still wins
    restored = trainer.train(1, ds, save_on_epoch=False,
                             valid_on_epoch=False, state=restored, lr=0.5)
    np.testing.assert_allclose(
        trainer.get_learn_rate(restored), 0.5 * hp.LR_DECAY, rtol=1e-5)


def test_epoch_data_stream_is_seeded(fresh_hparams, tmp_path):
    """Two identical runs draw identical shuffled/cropped batches (the
    reference depends on the ambient unseeded np.random); a different
    data_seed draws a different stream."""
    from danet_tpu.train import trainer as trainer_mod

    captured = []
    orig = trainer_mod.prepare_batch

    def capture(*a, **k):
        out = orig(*a, **k)
        captured.append(out.copy())
        return out

    hp = _tiny_hp(fresh_hparams)
    ds = WhiteNoiseData()
    ds.install_and_load()
    trainer = Trainer(DaNet(), name="seed", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    trainer_mod.prepare_batch = capture
    try:
        def run(seed):
            captured.clear()
            trainer.train(1, ds, save_on_epoch=False, valid_on_epoch=False,
                          state=trainer.init_state(jax.random.PRNGKey(0)),
                          data_seed=seed)
            return np.stack(captured)

        a, b, c = run(0), run(0), run(1)
    finally:
        trainer_mod.prepare_batch = orig
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_save_best_keeps_best_valid_checkpoint(fresh_hparams, tmp_path):
    hp = _tiny_hp(fresh_hparams)
    ds = WhiteNoiseData()
    ds.install_and_load()
    model = DaNet()
    trainer = Trainer(model, name="best", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    trainer.train(2, ds, save_on_epoch=False, valid_on_epoch=True,
                  save_best=True)
    assert os.path.isdir(os.path.join(str(tmp_path), "best_best"))


def test_grad_accum_matches_full_batch(fresh_hparams):
    """GRAD_ACCUM=k microbatched steps produce the same parameter update
    as the whole-batch step (deterministic: dropout off)."""
    hp = _tiny_hp(fresh_hparams)
    hp.BATCH_SIZE = 8
    hp.DROPOUT_KEEP_PROB = 1.0
    hp.digest()
    rng = np.random.RandomState(3)
    flat = rng.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 32,
                    hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    results = {}
    for accum in (1, 4):
        hp.GRAD_ACCUM = accum
        trainer = Trainer(DaNet(), name="ga%d" % accum,
                          mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        for i in range(2):
            state["params"], state["opt_state"], m = trainer._train_step(
                state["params"], state["opt_state"], src,
                jax.random.PRNGKey(i))
        results[accum] = (jax.device_get(state["params"]), float(m["loss"]))
    hp.GRAD_ACCUM = 1

    p1, l1 = results[1]
    p4, l4 = results[4]
    np.testing.assert_allclose(l1, l4, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p4)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_grad_accum_must_divide_batch(fresh_hparams):
    hp = _tiny_hp(fresh_hparams)
    hp.BATCH_SIZE = 4
    hp.GRAD_ACCUM = 3
    hp.digest()
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        Trainer(DaNet(), name="bad",
                mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    hp.GRAD_ACCUM = 1


def test_prefetch_worker_exits_when_consumer_abandons():
    """Abandoning the prefetch generator must release the worker thread
    (it must not block forever on a full queue)."""
    import threading
    import time
    from danet_tpu.train.trainer import prefetch_to_device

    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = prefetch_to_device(gen(), lambda x: x, depth=1)
    assert next(it) == 0
    it.close()  # abandon mid-stream -> finally sets the stop flag
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 100  # producer stopped early


def test_epoch_checkpoint_embeds_completed_epoch(fresh_hparams, tmp_path):
    """saves/<name>_eK must embed epoch=K so a resume continues at K."""
    hp = _tiny_hp(fresh_hparams)
    from danet_tpu.data.dataset import WhiteNoiseData
    ds = WhiteNoiseData()
    ds.install_and_load()
    trainer = Trainer(DaNet(), name="epk", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0))
    state = trainer.train(2, ds, save_on_epoch=True, valid_on_epoch=False,
                          state=state)
    fresh = trainer.init_state(jax.random.PRNGKey(1))
    restored = trainer.load_params(fresh, str(tmp_path / "epk_e2"))
    assert restored["epoch"] == 2


def test_ema_updates_and_drives_eval(fresh_hparams, tmp_path):
    """EMA (Polyak) averaging: the 'ema' tree must track training (diverge
    from the init copy), differ from the raw params, and be the weights
    the valid sweep / separate() actually run on (ADVICE r2: the update
    and the eval routing were previously dead)."""
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    hp.EMA_DECAY = 0.5
    model = DaNet()
    trainer = Trainer(model, name="ema-test", save_dir=str(tmp_path / "sv"))
    init = trainer.init_state(jax.random.PRNGKey(0))
    init_copy = jax.tree_util.tree_map(np.asarray, init["params"])
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    state = trainer.train(1, dataset, save_on_epoch=False,
                          valid_on_epoch=False, state=init)

    def maxdiff(a, b):
        return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
                   for x, y in zip(jax.tree_util.tree_leaves(a),
                                   jax.tree_util.tree_leaves(b)))

    assert maxdiff(state["ema"], init_copy) > 1e-6      # EMA moved
    assert maxdiff(state["ema"], state["params"]) > 1e-8  # lags raw params
    # eval routing: eval_params picks the EMA tree
    for a, b in zip(jax.tree_util.tree_leaves(trainer.eval_params(state)),
                    jax.tree_util.tree_leaves(state["ema"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the sweep actually runs on it: metrics computed via the trainer
    # equal metrics computed directly with the EMA weights (the toy
    # dataset draws fresh noise per epoch() call — seed both draws)
    np.random.seed(123)
    report = trainer.test(state, dataset, subset="valid", name="ema")
    np.random.seed(123)
    batches = [prepare_batch(d[0], hp.BATCH_SIZE, hp.MAX_N_SIGNAL,
                             bucket=hp.TIME_BUCKET)
               for d in dataset.epoch(
                   "valid", hp.BATCH_SIZE * hp.MAX_N_SIGNAL, shuffle=False)]
    accs = [trainer._valid_step(state["ema"], trainer._put_batch(b))
            for b in batches]
    want = float(np.mean([float(m["loss"]) for m in accs]))
    np.testing.assert_allclose(report["loss"], want, rtol=1e-5)


def test_ema_checkpoint_compat_both_directions(fresh_hparams, tmp_path):
    """A pre-EMA checkpoint restores under EMA_DECAY>0 (ema re-seeded from
    params), and an EMA checkpoint restores under EMA_DECAY=0 (extra tree
    dropped) — neither direction may fail the template restore."""
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    model = DaNet()
    # 1) save WITHOUT ema
    trainer0 = Trainer(model, name="compat", save_dir=str(tmp_path / "sv"))
    state0 = trainer0.init_state(jax.random.PRNGKey(1))
    path0 = str(tmp_path / "sv" / "pre_ema")
    trainer0.save_params(state0, path0)
    # restore WITH ema enabled: ema re-seeded from restored params
    hp.EMA_DECAY = 0.9
    trainer1 = Trainer(model, name="compat", save_dir=str(tmp_path / "sv"))
    state1 = trainer1.load_params(
        trainer1.init_state(jax.random.PRNGKey(2)), path0)
    assert "ema" in state1
    for a, b in zip(jax.tree_util.tree_leaves(state1["ema"]),
                    jax.tree_util.tree_leaves(state1["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # 2) save WITH ema, restore WITHOUT
    path1 = str(tmp_path / "sv" / "with_ema")
    trainer1.save_params(state1, path1)
    hp.EMA_DECAY = 0.0
    trainer2 = Trainer(model, name="compat", save_dir=str(tmp_path / "sv"))
    state2 = trainer2.load_params(
        trainer2.init_state(jax.random.PRNGKey(3)), path1)
    assert "ema" not in state2
    for a, b in zip(jax.tree_util.tree_leaves(state0["params"]),
                    jax.tree_util.tree_leaves(state2["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_eval_params_prefers_ema(fresh_hparams, tmp_path):
    """Serving/eval consumers (ckpt_lib.load_eval_params) must pick the EMA
    tree when the checkpoint has one and fall back to raw params."""
    from danet_tpu.train import checkpoint as ckpt_lib
    hp = _tiny_hp(fresh_hparams)
    model = DaNet()
    params = model.init(jax.random.PRNGKey(0))
    fake_ema = jax.tree_util.tree_map(lambda x: x + 1.0, params)
    p_ema = str(tmp_path / "ck_ema")
    ckpt_lib.save_checkpoint(p_ema, {"params": params, "ema": fake_ema,
                                     "step": 0, "epoch": 0})
    got = ckpt_lib.load_eval_params(p_ema, params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(fake_ema)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    p_raw = str(tmp_path / "ck_raw")
    ckpt_lib.save_checkpoint(p_raw, {"params": params, "step": 0,
                                     "epoch": 0})
    got = ckpt_lib.load_eval_params(p_raw, params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grad_clip_norm_bounds_update(fresh_hparams):
    """GRAD_CLIP_NORM global-norm clipping (not in the reference — its only
    clip is elementwise at +/-GRAD_CLIP_THRES, which never fires on the
    small-but-collectively-huge gradients of a bf16 loss spike)."""
    from danet_tpu import optim as optim_lib
    hp = fresh_hparams
    hp.OPTIMIZER_TYPE = "sgd"
    hp.LR = 1.0
    hp.GRAD_CLIP_NORM = 1e-3
    hp.GRAD_CLIP_THRES = 1e9
    opt = optim_lib.make_optimizer(hp)
    params = {"w": jnp.zeros((4, 4)), "b": jnp.zeros((4,))}
    grads = {"w": 100.0 * jnp.ones((4, 4)), "b": -50.0 * jnp.ones((4,))}
    opt_state = opt.init(params)
    updates, _ = opt.update(grads, opt_state, params)
    gnorm = float(jnp.sqrt(sum(
        jnp.sum(u * u) for u in jax.tree_util.tree_leaves(updates))))
    assert abs(gnorm - 1e-3) < 1e-6, gnorm
    # direction preserved (pure rescale, not elementwise truncation)
    ratio = np.asarray(updates["w"]).flatten()[0] / \
        np.asarray(updates["b"]).flatten()[0]
    assert abs(ratio - (-2.0)) < 1e-5

    # stateless transform: enabling/disabling either clip must not change
    # the opt_state TREE STRUCTURE (a restore matches leaves by tree path,
    # so a structure change would break checkpoint resume across the
    # toggle — the exact workflow of arming spike protection mid-run)
    hp.GRAD_CLIP_NORM = 0.0
    opt_off = optim_lib.make_optimizer(hp)
    s_on = jax.tree_util.tree_structure(opt_state)
    s_off = jax.tree_util.tree_structure(opt_off.init(params))
    assert s_on == s_off, (s_on, s_off)
    hp.GRAD_CLIP_THRES = None
    opt_none = optim_lib.make_optimizer(hp)
    assert jax.tree_util.tree_structure(opt_none.init(params)) == s_off
    # and the no-clip configuration must leave updates untouched
    upd_none, _ = opt_none.update(grads, opt_none.init(params), params)
    np.testing.assert_allclose(np.asarray(upd_none["w"]),
                               -100.0 * np.ones((4, 4)), rtol=1e-6)


def test_valid_crash_rollback_restores_best(fresh_hparams, tmp_path):
    """VALID_CRASH_FACTOR: a finite (non-NaN) valid-loss spike rolls the
    run back to the keep-best checkpoint and replays with perturbed seeds
    — the failure mode where a stage-final excursion wrecks every later
    resumed stage (the NaN sentinel never fires on a finite spike)."""
    hp = _tiny_hp(fresh_hparams)
    hp.VALID_CRASH_FACTOR = 2.0
    ds = WhiteNoiseData()
    ds.install_and_load()
    model = DaNet()
    trainer = Trainer(model, name="crash", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    scripted = [0.001, 100.0, 0.0009]  # good -> spike -> replay recovers
    calls = []

    def fake_sweep(state, dataset, subset, bucket):
        v = scripted[min(len(calls), len(scripted) - 1)]
        calls.append(v)
        return {"loss": v, "SNR": 0.0}

    trainer._metrics_sweep = fake_sweep
    state = trainer.train(2, ds, save_on_epoch=False, valid_on_epoch=True,
                          save_best=True)
    # epoch 1 set best; epoch 2 spiked and rolled back to best; the
    # replayed epoch 2 recovered -> exactly 3 valid sweeps, 2 epochs done
    assert calls == [0.001, 100.0, 0.0009], calls
    assert int(state["epoch"]) == 2
    assert os.path.isdir(os.path.join(str(tmp_path), "crash_best"))


def test_valid_crash_rollback_epoch_checkpoint_path(fresh_hparams,
                                                    tmp_path):
    """The rollback must also work in the plain save_on_epoch workflow
    (no keep-best): best_valid_loss is tracked unconditionally and the
    rollback target falls back to the previous epoch's checkpoint."""
    hp = _tiny_hp(fresh_hparams)
    hp.VALID_CRASH_FACTOR = 2.0
    ds = WhiteNoiseData()
    ds.install_and_load()
    model = DaNet()
    trainer = Trainer(model, name="crash3", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    scripted = [0.001, 100.0, 0.0009]
    calls = []

    def fake_sweep(state, dataset, subset, bucket):
        v = scripted[min(len(calls), len(scripted) - 1)]
        calls.append(v)
        return {"loss": v, "SNR": 0.0}

    trainer._metrics_sweep = fake_sweep
    # the spiked epoch's checkpoint is written BEFORE the valid sweep can
    # detect the spike; the rollback must remove it from disk (or a
    # preemption during the replay window would resume from the poisoned
    # newest-epoch checkpoint).  Spy on load_params — the deletion happens
    # just before the rollback restore.
    seen = {}
    orig_load = trainer.load_params

    def spy_load(state, path):
        seen["spiked_ckpt_exists_at_rollback"] = os.path.isdir(
            trainer.save_path(2))
        return orig_load(state, path)

    trainer.load_params = spy_load
    state = trainer.train(2, ds, save_on_epoch=True, valid_on_epoch=True,
                          save_best=False)
    # epoch 1 good; epoch 2 spiked -> rolled back to the epoch-1
    # checkpoint (no keep-best dir exists); replay recovered
    assert calls == [0.001, 100.0, 0.0009], calls
    assert int(state["epoch"]) == 2
    assert not os.path.isdir(os.path.join(str(tmp_path), "crash3_best"))
    assert seen["spiked_ckpt_exists_at_rollback"] is False
    # the replayed epoch 2 re-saved its (clean) checkpoint
    assert os.path.isdir(trainer.save_path(2))


def test_valid_crash_rollback_caps_retries(fresh_hparams, tmp_path):
    """A divergence that recurs after every rollback must not replay the
    best->crash window forever: after 3 rollbacks the guard disables and
    the run completes."""
    hp = _tiny_hp(fresh_hparams)
    hp.VALID_CRASH_FACTOR = 2.0
    ds = WhiteNoiseData()
    ds.install_and_load()
    model = DaNet()
    trainer = Trainer(model, name="crash2", save_dir=str(tmp_path),
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    calls = []

    def fake_sweep(state, dataset, subset, bucket):
        calls.append(1)
        return {"loss": 0.001 if len(calls) == 1 else 100.0, "SNR": 0.0}

    trainer._metrics_sweep = fake_sweep
    state = trainer.train(2, ds, save_on_epoch=False, valid_on_epoch=True,
                          save_best=True)
    assert int(state["epoch"]) == 2
    # 1 good + (3 rollback replays + 1 accepted) spikes = 5 sweeps
    assert len(calls) == 5, calls


def test_steps_per_call_matches_single_steps(fresh_hparams, tmp_path):
    """TRAIN_STEPS_PER_CALL=4 (scan K steps per dispatch) reproduces the
    single-step loop: same step count, same final params, same epoch
    metrics — including the epoch remainder (10 toy batches = 2 stacked
    calls of 4 + 2 single steps) and the per-step rng fold."""
    hp = _tiny_hp(fresh_hparams)
    hp.SUMMARY_DIR = str(tmp_path / "logs")

    def run(k, ema=0.0):
        hp.TRAIN_STEPS_PER_CALL = k
        hp.EMA_DECAY = ema
        trainer = Trainer(DaNet(), name="spc%d-%s" % (k, ema),
                          save_dir=str(tmp_path / ("sv%d-%s" % (k, ema))),
                          mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
        ds = WhiteNoiseData()
        ds.install_and_load()
        state = trainer.train(1, ds, save_on_epoch=False,
                              valid_on_epoch=False)
        return state

    s1 = run(1)
    s4 = run(4)
    assert int(s1["step"]) == int(s4["step"]) == 10
    for a, b in zip(jax.tree_util.tree_leaves(s1["params"]),
                    jax.tree_util.tree_leaves(s4["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)

    # EMA composes inside the scanned call
    e1 = run(1, ema=0.9)
    e4 = run(4, ema=0.9)
    for a, b in zip(jax.tree_util.tree_leaves(e1["ema"]),
                    jax.tree_util.tree_leaves(e4["ema"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    hp.TRAIN_STEPS_PER_CALL = 1
    hp.EMA_DECAY = 0.0


def test_steps_per_call_flushes_on_shape_change(fresh_hparams, tmp_path):
    """TRAIN_STEPS_PER_CALL on a variable-length corpus (wav-dir/TIMIT/
    WSJ0 pad each batch only to its own bucketed T): a shape change
    mid-group must flush the buffered batches as single steps instead of
    crashing np.stack or compiling a fresh partial-stack shape (ADVICE
    r3), and the mixed grouped/single run must reproduce the pure
    single-step loop exactly."""
    from danet_tpu.hparams import hparams as ghp
    hp = _tiny_hp(fresh_hparams)
    hp.TIME_BUCKET = 16
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    hp.digest()

    class VaryingLenData(WhiteNoiseData):
        # two bucketed lengths interleaved so a k=4 epoch exercises: a
        # mid-group flush, a full stacked group, and the tail remainder
        LENS = [32, 32, 16, 32, 32, 32, 32, 16, 32, 32]

        def epoch(self, subset, batch_size, shuffle=False):
            for t in self.LENS:
                yield (np.random.rand(batch_size, t, ghp.FEATURE_SIZE)
                       .astype(ghp.FLOATX),)

    def run(k):
        hp.TRAIN_STEPS_PER_CALL = k
        trainer = Trainer(DaNet(), name="spcvar%d" % k,
                          save_dir=str(tmp_path / ("sv%d" % k)),
                          mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
        ds = VaryingLenData()
        ds.install_and_load()
        return trainer.train(1, ds, save_on_epoch=False,
                             valid_on_epoch=False)

    s1 = run(1)
    s4 = run(4)
    assert int(s1["step"]) == int(s4["step"]) == 10
    for a, b in zip(jax.tree_util.tree_leaves(s1["params"]),
                    jax.tree_util.tree_leaves(s4["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    hp.TRAIN_STEPS_PER_CALL = 1


def test_dc_metric_notice_under_grad_accum(fresh_hparams, capsys):
    """DC_LOSS_WEIGHT>0 with GRAD_ACCUM>1 drops the raw-DC diagnostic
    column (fixed scan-carry structure) — the trainer must say so at
    build time, not bury it in a code comment (ADVICE r3)."""
    hp = _tiny_hp(fresh_hparams)
    hp.GRAD_ACCUM = 2
    hp.DC_LOSS_WEIGHT = 0.3
    Trainer(DaNet(), name="dcnotice",
            mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    assert "raw-DC diagnostic" in capsys.readouterr().out
    hp.GRAD_ACCUM = 1
    hp.DC_LOSS_WEIGHT = 0.0


def test_hang_watchdog_fires_on_stale_heartbeat(fresh_hparams, monkeypatch):
    """WATCHDOG_SECS>0: a heartbeat that goes stale fires the watchdog
    (hang detection — a hung device or collective blocks the dispatch
    thread forever with no exception);
    a regularly-refreshed heartbeat must NOT fire it."""
    import threading
    import time

    from danet_tpu.train import trainer as trainer_mod

    hp = _tiny_hp(fresh_hparams)
    hp.WATCHDOG_SECS = 0.5
    tr = Trainer(DaNet(), name="wd",
                 mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    fired = threading.Event()
    monkeypatch.setattr(trainer_mod.os, "_exit", lambda code: fired.set())
    with tr._hang_watchdog():
        # healthy phase: refresh faster than the limit — no fire
        for _ in range(5):
            tr._heartbeat = time.monotonic()
            time.sleep(0.2)
        assert not fired.is_set()
        # hang phase: stop refreshing — must fire within a few polls
        assert fired.wait(5.0), "watchdog did not fire on stale heartbeat"
    # watchdog thread is stopped on context exit; nested use is a no-op
    fired.clear()
    with tr._hang_watchdog():
        assert tr._watchdog_on
        with tr._hang_watchdog():  # nested (test() inside train())
            pass
        assert tr._watchdog_on  # inner exit must not tear down the outer


def test_hang_watchdog_exits_hung_training_process(fresh_hparams, tmp_path):
    """End-to-end: a training subprocess whose data source hangs after a
    few batches exits WATCHDOG_EXIT_CODE (114) with a diagnosis instead of
    blocking forever — the recipes' retry loops key off a nonzero exit to
    relaunch + resume."""
    import subprocess
    import sys as _sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "hang_train.py"
    script.write_text(textwrap.dedent("""
        import sys, time
        import numpy as np
        sys.path.insert(0, %r)
        import jax
        from danet_tpu.hparams import hparams
        import danet_tpu  # registries

        hparams.load_json(%r)
        hparams.BATCH_SIZE = 2
        hparams.MAX_TRAIN_LEN = 16
        hparams.TIME_BUCKET = 16
        hparams.WATCHDOG_SECS = 45  # > toy-step compile time on CPU
        hparams.digest()

        from danet_tpu.models import DaNet
        from danet_tpu.train.trainer import Trainer

        class HangingData:
            def epoch(self, subset, batch_size, shuffle=False):
                rng = np.random.RandomState(0)
                for _ in range(3):
                    yield (rng.rand(batch_size, 16, hparams.FEATURE_SIZE)
                           .astype(np.float32),)
                print("HANGING-NOW", flush=True)
                time.sleep(600)  # a dead device link, in effect

        t = Trainer(DaNet(), name="wd", save_dir=%r)
        t.train(1, HangingData(), save_on_epoch=False,
                valid_on_epoch=False)
        print("UNREACHABLE", flush=True)
    """ % (repo, os.path.join(repo, "default.json"),
           str(tmp_path / "sv"))))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [_sys.executable, str(script)], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300)
    from danet_tpu.train.trainer import WATCHDOG_EXIT_CODE
    assert proc.returncode == WATCHDOG_EXIT_CODE, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:])
    assert "HANGING-NOW" in proc.stdout  # steps ran before the hang
    assert "UNREACHABLE" not in proc.stdout
    assert "[watchdog]" in proc.stdout + proc.stderr


def test_transfer_dtype_bf16_wire(fresh_hparams):
    """TRANSFER_DTYPE='bfloat16' halves host->device bytes; the jitted
    steps upcast to f32 at entry, so the train loss matches the f32 wire
    up to input quantization (~1e-2 relative here)."""
    hp = _tiny_hp(fresh_hparams)
    rng = np.random.RandomState(0)
    flat = rng.rand(hp.BATCH_SIZE * hp.MAX_N_SIGNAL, 32,
                    hp.FEATURE_SIZE).astype(np.float32)
    batch = prepare_batch(flat, hp.BATCH_SIZE, hp.MAX_N_SIGNAL)

    losses = {}
    for wire in ("float32", "bfloat16"):
        hp.TRANSFER_DTYPE = wire
        trainer = Trainer(DaNet(), name="wire-" + wire[:2],
                          mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
        state = trainer.init_state(jax.random.PRNGKey(0))
        src = trainer._put_batch(batch)
        if wire == "bfloat16":
            assert src.dtype == jnp.bfloat16  # half the wire bytes
        else:
            assert src.dtype == jnp.float32
        _, _, m = trainer._train_step(
            state["params"], state["opt_state"], src, jax.random.PRNGKey(1))
        losses[wire] = float(m["loss"])
    assert np.isfinite(losses["bfloat16"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=2e-2)


def test_transfer_dtype_bf16_full_loop(fresh_hparams, tmp_path):
    """The bf16 wire drives the full train loop (prefetch, k-groups,
    valid sweep) end-to-end, including TRAIN_STEPS_PER_CALL stacking."""
    hp = _tiny_hp(fresh_hparams)
    hp.TRANSFER_DTYPE = "bfloat16"
    hp.TRAIN_STEPS_PER_CALL = 4
    hp.SUMMARY_DIR = str(tmp_path / "logs")
    trainer = Trainer(DaNet(), name="wire16",
                      save_dir=str(tmp_path / "sv"))
    dataset = WhiteNoiseData()
    dataset.install_and_load()
    state = trainer.train(1, dataset, save_on_epoch=False,
                          valid_on_epoch=True)
    assert state["step"] == 10
