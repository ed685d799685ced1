#!/bin/bash
# Extended-scale staged training on the synth corpus (2x the corpus of the
# PARITY.md "staged recipe" run): PIT-MSE warmup -> LR-dropped PIT-MSE ->
# waveform uPIT SI-SNR fine-tune -> unrolled-kmeans SI-SNR fine-tune.
# Reference analogue: experiments/timit_1.sh staged curriculum.
set -e
cd "$(dirname "$0")/.."
SAVE=saves/synth_big
mkdir -p "$SAVE"

# Every stage is checkpoint-resumable, so transient failures (a
# watchdog exit, a preempted host) just retry the stage.
. experiments/lib.sh

PY="python experiments/synth_extended.py --save-dir $SAVE --batches 120 --eval-si-snr"

echo "=== stage A: PIT-MSE @ 1e-3 (12 epochs)"
retry $PY --epochs 12 --lr 1e-3
echo "=== stage B: PIT-MSE @ 3e-4 (12 epochs)"
retry $PY --epochs 12 --lr 3e-4 --resume
echo "=== stage C: waveform uPIT SI-SNR @ 1e-4 (16 epochs)"
retry $PY --epochs 16 --lr 1e-4 --loss pit-si-snr --resume
echo "=== stage D: unrolled-kmeans SI-SNR @ 1e-4 (16 epochs)"
retry $PY --epochs 16 --lr 1e-4 --loss pit-si-snr --infer-est kmeans --resume
echo "=== all stages done"
