#!/bin/bash
# Reference-recipe parity A/B (VERDICT r3 item 6): put a MEASURED number
# under the PARITY.md claim that the reference training objective
# (pit-mse with TRAIN_ESTIMATOR_METHOD=truth-weighted,
# /root/reference/default.json + main.py:208-399) gives the anchor
# inference path zero gradient — the structural weakness behind the
# reference's "anchored DaNet won't learn well" disclaimer.
#
# Two arms, identical except ANCHOR_AUX_LOSS:
#   A (reference objective): pit-mse only, ANCHOR_AUX_LOSS=0
#   B (ours):                pit-mse + ANCHOR_AUX_LOSS=0.5
# Both: bilstm-orig with LSTM_LEGACY_CELL=true (the reference's no-tanh
# cell, configs/reference-parity.json), broadband corpus, 40 epochs,
# LR 3e-4 adaptive, anchor AND kmeans eval.  bf16 compute is the one
# deviation (the claim under test is objective-level).
set -e
cd "$(dirname "$0")/.."

. experiments/lib.sh

for arm in noaux aux; do
  SAVE=saves/ref_parity_$arm
  mkdir -p "$SAVE"
  if [ "$arm" = noaux ]; then AUX=0.0; else AUX=0.5; fi
  echo "=== arm $arm: 40 epochs pit-mse, ANCHOR_AUX_LOSS=$AUX"
  retry python experiments/synth_extended.py --save-dir "$SAVE" \
      --batches 120 --dataset synth-speech --eval-si-snr \
      --epochs 40 --lr 3e-4 \
      --set ANCHOR_AUX_LOSS=$AUX --set LSTM_LEGACY_CELL=true \
      --set VALID_CRASH_FACTOR=1.5 --set TRAIN_STEPS_PER_CALL=8 --set TRANSFER_DTYPE=\"bfloat16\"
  echo "=== eval arm $arm (latest)"
  retry python -u experiments/eval_checkpoint.py --ckpt "$SAVE/latest" \
      --dataset synth-speech --batches 120 \
      --set LSTM_LEGACY_CELL=true
done
echo "=== all done rc=$? $(date)"
