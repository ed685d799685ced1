"""danet_tpu CLI driver.

Same public surface as the reference driver (/root/reference/main.py:551-740):
modes train/valid/test/demo/debug/interactive; flags -n/-m/-i/-o/-c/-ne/
--no-save-on-epoch/--no-valid-on-epoch/-if/-ds/-lr/-tl/-bs; layered config
default.json -> -c JSON -> CLI overrides.  Runs on whatever backend JAX
picks (the GPU when there is one; CPU with JAX_PLATFORMS=cpu).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from danet_tpu.compile_cache import enable_compile_cache
from danet_tpu.hparams import hparams
import danet_tpu  # noqa: F401  (populates registries)
from danet_tpu.data import audio
from danet_tpu.models import DaNet
from danet_tpu.train.trainer import Trainer, prepare_batch

g_args = None
g_model = None
g_trainer = None
g_state = None
g_dataset = None


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", "--name", default="UnnamedExperiment",
                        help="name of experiment, affects checkpoint saves")
    parser.add_argument("-m", "--mode", default="train",
                        help='Mode: "train", "valid", "test", "demo", '
                             '"debug" or "interactive"')
    parser.add_argument("-i", "--input-pfile",
                        help="path to input model parameter file")
    parser.add_argument("-o", "--output-pfile",
                        help="path to output model parameters file")
    parser.add_argument("-c", "--hparams-file",
                        help="path to hyperparameters (config) JSON file")
    parser.add_argument("-ne", "--num-epoch", type=int, default=10,
                        help="number of training epochs")
    parser.add_argument("--no-save-on-epoch", action="store_true",
                        help="don't save parameters after each epoch")
    parser.add_argument("--no-valid-on-epoch", action="store_true",
                        help="don't sweep validation set after each epoch")
    parser.add_argument("-if", "--input-file",
                        help='input WAV file for "demo" mode')
    parser.add_argument("-ds", "--dataset",
                        help="dataset to use, overrides hparams.DATASET_TYPE")
    parser.add_argument("-lr", "--learn-rate",
                        help="learn rate, overrides hparams.LR")
    parser.add_argument("-tl", "--train-length",
                        help="training segment length, overrides "
                             "hparams.MAX_TRAIN_LEN")
    parser.add_argument("-bs", "--batch-size",
                        help="batch size, overrides hparams.BATCH_SIZE")
    parser.add_argument("--seed", type=int, default=0,
                        help="PRNG seed for init/dropout")
    parser.add_argument("--stream", action="store_true",
                        help='"demo" mode: causal ONLINE separation with '
                             "carried encoder state (lstm-orig/gru-v1/"
                             "causal tcn-v1; DaNet.separate_stream)")
    parser.add_argument("--stream-chunk", type=int, default=64,
                        help="--stream: frames per streaming chunk")
    parser.add_argument("--stream-warmup", type=int, default=128,
                        help="--stream: warmup frames for attractor/"
                             "centering estimation")
    return parser


def load_config(args):
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "default.json")
    hparams.load_json(base)
    if args.hparams_file is not None:
        hparams.load_json(args.hparams_file)
    if args.learn_rate is not None:
        hparams.LR = float(args.learn_rate)
        assert hparams.LR >= 0.0
    if args.train_length is not None:
        hparams.MAX_TRAIN_LEN = int(args.train_length)
        assert hparams.MAX_TRAIN_LEN >= 2
    if args.dataset is not None:
        hparams.DATASET_TYPE = args.dataset
    if args.batch_size is not None:
        hparams.BATCH_SIZE = int(args.batch_size)
        assert hparams.BATCH_SIZE > 0
    hparams.digest()


def _draw_test_mixture(dataset, n_signal):
    """Draw N test utterances, align-pad, and sum into a mixture
    (reference main.py:662-674)."""
    for data_pt in dataset.epoch("test", n_signal):
        break
    sigs = data_pt[0]
    max_len = max(len(x) for x in sigs)
    max_len += (-max_len) % hparams.LENGTH_ALIGN
    src = np.stack([
        audio.random_zeropad(x, max_len - len(x), axis=-2) for x in sigs])
    return src


def run_demo(args):
    import jax
    if args.input_file is None:
        filename = "demo.wav"
        src = _draw_test_mixture(g_dataset, hparams.MAX_N_SIGNAL)
        raw_mixture = np.sum(src, axis=0)            # [T, F] complex
        audio.save_wavfile(filename, raw_mixture)
        print("Mixture written to %s" % filename)
    else:
        filename = args.input_file
        raw_mixture = audio.load_wavfile(args.input_file)
        t = len(raw_mixture)
        pad = (-t) % hparams.LENGTH_ALIGN
        if pad:
            raw_mixture = np.pad(raw_mixture, [(0, pad), (0, 0)])

    mix_ri = audio.to_ri(raw_mixture[None])           # [1, T, F, 2]
    chunk = int(getattr(hparams, "DEMO_CHUNK_FRAMES", 0) or 0)
    if args.stream:
        # causal online path: fixed per-chunk latency, RNN state carried
        # across chunks, attractors frozen from the warmup window
        import jax as _jax
        sep_ri = np.asarray(_jax.jit(
            lambda p, x: g_model.separate_stream(
                p, x, args.stream_chunk, args.stream_warmup))(
            g_trainer.eval_params(g_state), mix_ri[0]))[None]
    elif chunk and mix_ri.shape[1] > chunk:
        # streaming long-form path: chunked separation with cross-chunk
        # source alignment and crossfade (DaNet.separate_long)
        import jax as _jax
        sep_ri = np.asarray(_jax.jit(
            lambda p, x: g_model.separate_long(
                p, x, chunk, int(hparams.DEMO_OVERLAP_FRAMES)))(
            g_trainer.eval_params(g_state), mix_ri[0]))[None]
    else:
        sep_ri = g_trainer.separate(g_state, mix_ri)
    signals = audio.from_ri(sep_ri[0])                # [N, T, F] complex
    base, ext = os.path.splitext(filename)
    for i, s in enumerate(signals):
        out = base + ("_separated_%d" % (i + 1)) + (ext or ".wav")
        audio.save_wavfile(out, s)
        print("Separated source written to %s" % out)

    # color-composite spectrogram plot (reference main.py:697-716)
    if "DISPLAY" not in os.environ:
        print("Warning: no display found, not generating plot")
        return
    from colorsys import hsv_to_rgb
    import matplotlib.pyplot as plt
    colors = np.asarray([
        hsv_to_rgb(h, 0.95, 0.98)
        for h in np.arange(hparams.MAX_N_SIGNAL, dtype=np.float32)
        / hparams.MAX_N_SIGNAL])
    logmags = np.log1p(np.abs(signals))
    composite = -np.einsum("nwh,nc->nwhc", logmags, colors)
    composite /= np.min(composite)
    n = len(signals)
    for i in range(n):
        plt.subplot(1, n + 2, i + 1)
        plt.imshow(composite[i])
    plt.subplot(1, n + 2, n + 1)
    plt.imshow(0.9 * composite.sum(axis=0))
    plt.subplot(1, n + 2, n + 2)
    plt.imshow(np.log1p(np.abs(raw_mixture)))
    plt.show()


def run_debug(args):
    """Dump inputs/embeddings/attractors/masks for one test batch to
    debug/debug_data.mat (reference main.py:717-737)."""
    import jax
    import scipy.io
    for data_pt in g_dataset.epoch(
            "test", hparams.MAX_N_SIGNAL, shuffle=True):
        break
    sigs = data_pt[0]
    max_len = max(len(x) for x in sigs)
    max_len += (-max_len) % hparams.LENGTH_ALIGN
    src = np.stack([
        audio.random_zeropad(x, max_len - len(x), axis=-2) for x in sigs])
    src_ri = audio.to_ri(src[None])                   # [1, N, T, F, 2]

    from danet_tpu.models.danet import mixture_features
    params = g_trainer.eval_params(g_state)
    model = g_model

    if not isinstance(model, DaNet):
        # waveform-domain family: dump the basis features / masks /
        # separated waveforms via the tap hook instead of the DaNet
        # embedding/attractor pipeline
        def debug_fetch_tasnet(params, src_ri):
            fetches = {}
            wav_src = model._src_wavs(src_ri)
            mix = jnp.sum(wav_src, axis=1)
            padded = model._pad_len(mix.shape[-1])
            mix_p = jnp.pad(mix, [(0, 0), (0, padded - mix.shape[-1])])
            sep = model._separate_wav_padded(
                params, mix_p,
                tap=lambda k, v: fetches.__setitem__(k, v))
            return dict(fetches, mixture=mix, output=sep)

        import jax.numpy as jnp
        data = jax.jit(debug_fetch_tasnet)(params, src_ri)
        data = {k: np.asarray(v) for k, v in data.items()}
        data["input"] = np.stack([src.real, src.imag], -1)
        os.makedirs("debug", exist_ok=True)
        scipy.io.savemat("debug/debug_data.mat", data)
        print("Debug data written to debug/debug_data.mat")
        return

    def debug_fetch(params, src_ri):
        hp = model.hp
        (mix_ri, src_pwr, mix_pwr, logmag,
         phase_unit) = mixture_features(src_ri, hp.EPS)
        # encoder internals (per-layer hidden sequences / conv
        # activations) ride along via the tap hook — the functional
        # equivalent of the reference's encoder.debug_fetches
        # (reference modules.py:375-377, main.py:387-397)
        cdt = getattr(hp, "COMPUTE_DTYPE", "float32")
        embed, enc_fetches = model.encoder.apply_debug(
            params["encoder"], logmag.astype(cdt))
        embed_flat = embed.reshape(embed.shape[0], -1, embed.shape[-1])
        attractors = model.train_estimator.apply(
            params["train_estimator"], embed,
            src_pwr=src_pwr, mix_pwr=mix_pwr)
        sep_pwr = model.separator.apply(
            params["separator"], mix_pwr, attractors, embed_flat)
        sep_ri = sep_pwr[..., None] * phase_unit[:, None]
        return dict(embed=embed, attrs=attractors, masks=sep_pwr,
                    output=sep_ri, **enc_fetches)

    data = jax.jit(debug_fetch)(params, src_ri)
    data = {k: np.asarray(v) for k, v in data.items()}
    data["input"] = np.stack([src.real, src.imag], -1)
    os.makedirs("debug", exist_ok=True)
    scipy.io.savemat("debug/debug_data.mat", data)
    print("Debug data written to debug/debug_data.mat")


def main():
    global g_args, g_model, g_trainer, g_state, g_dataset
    parser = build_argparser()
    g_args = parser.parse_args()
    enable_compile_cache()
    load_config(g_args)

    sys.stdout.write('Preparing dataset "%s" ... ' % hparams.DATASET_TYPE)
    sys.stdout.flush()
    g_dataset = hparams.get_dataset()()
    g_dataset.install_and_load()
    sys.stdout.write("done\n")

    print('Encoder type: "%s"' % hparams.ENCODER_TYPE)
    print('Separator type: "%s"' % hparams.SEPARATOR_TYPE)
    print('Training estimator type: "%s"' % hparams.TRAIN_ESTIMATOR_METHOD)
    print('Inference estimator type: "%s"' % hparams.INFER_ESTIMATOR_METHOD)

    if g_args.mode in ("demo", "debug"):
        hparams.BATCH_SIZE = 1
        print('  Warning: setting hparams.BATCH_SIZE to 1 for "%s" mode'
              % g_args.mode)
        if g_args.mode == "debug":
            hparams.DEBUG = True

    sys.stdout.write("Building model ... ")
    sys.stdout.flush()
    import jax
    from danet_tpu.parallel import multihost
    if multihost.initialize():
        print("multi-host: process %d/%d"
              % (jax.process_index(), jax.process_count()))
    g_model = hparams.get_model()()   # MODEL_TYPE: danet | tasnet-v1
    g_trainer = Trainer(g_model, name=g_args.name)
    g_state = g_trainer.init_state(jax.random.PRNGKey(g_args.seed))
    print("done (%d parameters, %d device(s): %s)" % (
        g_model.parameter_count(g_state["params"]),
        len(jax.devices()), jax.devices()[0].platform))

    if g_args.input_pfile is not None:
        sys.stdout.write(
            "Loading parameters from %s ... " % g_args.input_pfile)
        g_state = g_trainer.load_params(g_state, g_args.input_pfile)
        sys.stdout.write("done\n")

    if g_args.mode == "interactive":
        print("Now in interactive mode, you should run this with python -i")
        return
    elif g_args.mode == "train":
        # only an explicit -lr (or a resume-less fresh init, which already
        # carries hp.LR) overrides the LR; resuming via -i keeps the
        # checkpointed (possibly decayed) learning rate
        explicit_lr = (float(g_args.learn_rate)
                       if g_args.learn_rate is not None else
                       (hparams.LR if g_args.input_pfile is None else None))
        g_state = g_trainer.train(
            n_epoch=g_args.num_epoch, dataset=g_dataset,
            save_on_epoch=not g_args.no_save_on_epoch,
            valid_on_epoch=not g_args.no_valid_on_epoch,
            state=g_state, rng=jax.random.PRNGKey(g_args.seed + 1),
            lr=explicit_lr, data_seed=g_args.seed)
        if g_args.output_pfile is not None:
            sys.stdout.write(
                "Saving parameters into %s ... " % g_args.output_pfile)
            g_trainer.save_params(g_state, g_args.output_pfile)
            sys.stdout.write("done\n")
    elif g_args.mode == "test":
        g_trainer.test(g_state, g_dataset)
    elif g_args.mode == "valid":
        g_trainer.test(g_state, g_dataset, "valid", "Valid")
    elif g_args.mode == "demo":
        run_demo(g_args)
    elif g_args.mode == "debug":
        run_debug(g_args)
    else:
        raise ValueError('Unknown mode "%s"' % g_args.mode)


if __name__ == "__main__":
    main()
