"""Headline evaluation of a trained checkpoint on the synth corpus.

One metrics pass per inference estimator (anchor / kmeans) over a chosen
subset, reporting spectral SNR (reference parity metric), waveform SI-SNR,
and BSS-eval SDR/SIR/SAR (EVAL_SDR).  The reference has no eval-only
entry point beyond `-m test` (main.py:512-532); this adds the estimator
sweep used for the PARITY.md quality tables.

    python experiments/eval_checkpoint.py --ckpt saves/synth_big/latest \
        --batches 120 [--subset valid] [--estimators anchor,kmeans]
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
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--batches", type=int, default=120)
    ap.add_argument("--dataset", default="synth",
                    choices=["synth", "synth-speech"])
    ap.add_argument("--subset", default="valid", choices=["valid", "test"])
    ap.add_argument("--estimators", default="anchor,kmeans")
    ap.add_argument("--encoder", default="bilstm-orig")
    ap.add_argument("--n-signal", type=int, default=2)
    ap.add_argument("--no-sdr", action="store_true",
                    help="skip the BSS-eval solve (faster)")
    ap.add_argument("--kmeans-iter", type=int, default=None,
                    help="override KMEANS_ITER for the kmeans estimator")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", dest="overrides",
                    help="extra hparam overrides (JSON-typed values); must "
                         "match the training run's architecture overrides")
    args = ap.parse_args()

    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
    hparams.load_json(os.path.join(repo, "default.json"))
    hparams.ENCODER_TYPE = args.encoder
    hparams.DATASET_TYPE = args.dataset
    hparams.BATCH_SIZE = 16
    hparams.COMPUTE_DTYPE = "bfloat16"
    hparams.MAX_N_SIGNAL = args.n_signal
    hparams.SYNTH_BATCHES = args.batches
    hparams.EVAL_SI_SNR = True
    hparams.EVAL_SDR = not args.no_sdr
    if args.kmeans_iter is not None:
        hparams.KMEANS_ITER = args.kmeans_iter
    # hang watchdog (same default as synth_extended.py): a hung device
    # op otherwise blocks the metrics sweep forever and hangs any queue
    # driving this script.  Trainer.test arms the watchdog itself when
    # WATCHDOG_SECS > 0.
    hparams.WATCHDOG_SECS = 900
    apply_overrides(hparams, args.overrides)
    hparams.digest()

    from danet_tpu.train.trainer import Trainer
    from danet_tpu.train import checkpoint as ckpt_lib

    dataset = hparams.get_dataset()()
    dataset.install_and_load()

    results = {}
    params = None
    for est in args.estimators.split(","):
        hparams.INFER_ESTIMATOR_METHOD = est
        hparams.digest()
        trainer = Trainer(hparams.get_model()(), name="eval")
        state = trainer.init_state(jax.random.PRNGKey(0))
        if params is None:
            state = ckpt_lib.load_checkpoint(
                args.ckpt, {"params": state["params"]}, partial=True)
            params = state["params"]
        report = trainer.test({"params": params}, dataset,
                              subset=args.subset, name="eval[%s]" % est)
        results[est] = report
        print(flush=True)

    print("\n=== %s (%s, N=%d, %d batches)" % (
        args.ckpt, args.subset, args.n_signal, args.batches), flush=True)
    for est, report in results.items():
        print("%-8s %s" % (est, " ".join(
            "%s=%.2f" % (k, v) for k, v in sorted(report.items()))),
            flush=True)


if __name__ == "__main__":
    main()
