"""Extended convergence experiment on the separable synth corpus.

Two-stage checkpointed training of the flagship bilstm-orig DaNet
(reference experiments/timit_1.sh is the staged-training analogue; this
script additionally exercises checkpoint/resume across process restarts,
which the reference supports via -i/-o in main.py:634-649).

Stage A:  python experiments/synth_extended.py --epochs 12
Stage B:  python experiments/synth_extended.py --epochs 12 --resume

Uses the same recipe that reached 13.2 dB held-out anchor-path SNR in
PARITY.md: SYNTH_BATCHES=60 (960 mixtures), B=16, bf16,
ANCHOR_AUX_LOSS=0.5, adaptive LR decay.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax  # noqa: E402

from danet_tpu.hparams import apply_overrides  # noqa: E402
from danet_tpu.hparams import hparams  # noqa: E402
import danet_tpu  # noqa: F401,E402 (populates registries)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-dir", default="saves/synth_extended")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--dataset", default="synth",
                    choices=["synth", "synth-speech"],
                    help="synthetic corpus: narrowband tones or broadband "
                         "formant speech (data/synth_speech.py)")
    ap.add_argument("--loss", default="pit-mse",
                    choices=["pit-mse", "pit-si-snr"],
                    help="training objective (pit-si-snr = waveform uPIT "
                         "fine-tune stage)")
    ap.add_argument("--n-signal", type=int, default=2)
    ap.add_argument("--eval-si-snr", action="store_true",
                    help="also report waveform SI-SNR on valid sweeps")
    ap.add_argument("--encoder", default="bilstm-orig",
                    help="encoder registry key (bilstm-orig, attn-v1, ...)")
    ap.add_argument("--infer-est", default="anchor",
                    help="inference estimator (anchor, kmeans); with "
                         "ANCHOR_AUX_LOSS the aux gradient flows through "
                         "it (kmeans = unrolled k-means training)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", dest="overrides",
                    help="extra hparam overrides (JSON-typed values), "
                         "e.g. --set TCN_BLOCKS=5 — applied last, before "
                         "digest")
    args = ap.parse_args()

    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = args.encoder
    hparams.DATASET_TYPE = args.dataset
    hparams.BATCH_SIZE = 16
    hparams.COMPUTE_DTYPE = "bfloat16"
    hparams.LR = args.lr
    hparams.LR_DECAY_TYPE = "adaptive"
    hparams.NUM_EPOCH_PER_LR_DECAY = 4
    hparams.ANCHOR_AUX_LOSS = 0.5
    hparams.TRAIN_LOSS_TYPE = args.loss
    hparams.MAX_N_SIGNAL = args.n_signal
    hparams.EVAL_SI_SNR = args.eval_si_snr
    hparams.INFER_ESTIMATOR_METHOD = args.infer_est
    hparams.SYNTH_BATCHES = args.batches
    hparams.METRICS_EVERY = 10
    # hang watchdog: a hung device op otherwise leaves the stage blocked
    # forever; exit 114 lets the recipes' retry loops
    # relaunch + resume (overridable via --set WATCHDOG_SECS=...)
    hparams.WATCHDOG_SECS = 900
    hparams.SUMMARY_TITLE = "synth extended"
    apply_overrides(hparams, args.overrides)
    hparams.digest()

    from danet_tpu.train.trainer import Trainer

    dataset = hparams.get_dataset()()
    dataset.install_and_load()
    trainer = Trainer(hparams.get_model()(), name="synthext", save_dir=args.save_dir)
    state = trainer.init_state(jax.random.PRNGKey(0))
    latest = os.path.join(args.save_dir, "latest")
    if args.resume:
        state = trainer.load_params(state, latest)
        print("resumed from step %d (epoch %d)"
              % (state["step"], state["epoch"]), flush=True)
    state = trainer.train(args.epochs, dataset, save_on_epoch=False,
                          valid_on_epoch=True, state=state, save_best=True,
                          lr=args.lr)  # staged recipes pin LR per stage
    trainer.save_params(state, latest)
    print("saved at step %d" % state["step"], flush=True)


if __name__ == "__main__":
    main()
