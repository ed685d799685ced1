"""Roofline verdict for the flagship train step.

Prints, for the compiled attn-v1 B=64 shipping step (and any --encoder/
--batch/--seqlen override): XLA's own FLOP count and bytes-accessed for
the lowered program, the arithmetic intensity FLOP/byte, the card's
ridge point (bf16 peak / memory bandwidth, from bench.PEAKS), and the
implied bound — whether the measured ceiling is the memory system or
the tensor cores.

Run on the chip:  python benchmarks/roofline.py [--encoder E] [--batch B]
                  [--seqlen T] [--measured-ms MS]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", default="attn-v1")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seqlen", type=int, default=128)
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="measured ms/step (bench.py) to place on the "
                         "roofline; omit to just print the program stats")
    args = ap.parse_args()

    import bench
    bench.ENCODER = args.encoder
    bench.BATCH = args.batch
    bench.T = args.seqlen
    # the shipping step shape: configs/shipping.json aux losses etc.
    import json
    with open(bench.SHIPPING_CONFIG) as f:
        cfg = json.load(f)
    cfg["ENCODER_TYPE"] = args.encoder
    bench.CONFIG_OVERRIDES = cfg

    import jax
    step, params, opt_state, src = bench.build_step()
    compiled = step.lower(params, opt_state, src).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    kind = jax.devices()[0].device_kind
    entry = bench.peak_for(kind)
    peak = entry["bf16_tflops"] if entry else None
    bw = entry["hbm_tb_per_s"] * 1e3 if entry else None  # GB/s
    print("device: %s" % kind)
    print("program: %s B=%d T=%d (shipping config overrides)"
          % (args.encoder, args.batch, args.seqlen))
    print("flops/step: %.3f GFLOP" % (flops / 1e9))
    print("bytes accessed/step (XLA cost model): %.1f MB" % (byts / 1e6))
    if byts > 0:
        inten = flops / byts
        print("arithmetic intensity: %.0f FLOP/byte" % inten)
        if peak:
            ridge = peak * 1e12 / (bw * 1e9)
            print("ridge point (%s): %.0f FLOP/byte  ->  %s-bound regime"
                  % (kind, ridge,
                     "memory" if inten < ridge else "compute"))
            mem_ms = byts / (bw * 1e9) * 1e3
            tc_ms = flops / (peak * 1e12) * 1e3
            floor = max(mem_ms, tc_ms)
            print("lower bounds: memory %.3f ms, tensor cores %.3f ms -> "
                  "speed-of-light %.3f ms/step" % (mem_ms, tc_ms, floor))
            if args.measured_ms:
                print("measured %.3f ms/step = %.1f%% of program "
                      "speed-of-light (MFU vs bf16 peak %.1f%%)"
                      % (args.measured_ms,
                         100.0 * floor / args.measured_ms,
                         100.0 * tc_ms / args.measured_ms))


if __name__ == "__main__":
    main()
