"""AOT serving artifacts: portable exported inference programs.

The reference repo's only inference surface is the interactive demo mode
(/root/reference/main.py:655-716 — rebuild the graph in-process, feed a WAV
through the session).  This module adds the production path: the fused
waveform->separated-waveforms program (`DaNet.separate_wav` — GEMM-native
STFT, encoder, attractors, masking, iSTFT, one XLA program) is
ahead-of-time exported with `jax.export` into a serialized StableHLO
artifact with the model parameters baked in as constants.  Serving then
needs no model code, no config files and no tracing: deserialize + call.

Two design points:

  * **Static shapes.**  XLA compiles one program per input shape; a serving
    fleet wants a small, fixed set of compiled programs, not a recompile
    per request.  Artifacts are therefore *length-bucketed*: one exported
    program per waveform length bucket, requests are zero-padded up to the
    smallest admitting bucket (the same static-shape bucketing strategy the
    trainer uses for TIME_BUCKET).
  * **Platform pinning.**  An artifact lists the platforms it was lowered
    for.  By default we export for the platform JAX is running on; pass
    ``platforms=("cuda", "cpu")`` for a multi-platform artifact.

Layout of an artifact directory:

    manifest.json            bucket lengths, batch, model/config summary
    sep_<LENGTH>.jaxexport   StableHLO bytecode of the exported program
    sep_<LENGTH>.jaxexport.json  its calling convention (_save_exported)
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

MANIFEST_NAME = "manifest.json"
FORMAT = "danet-tpu-serve-v2"
STREAM_FORMAT = "danet-tpu-serve-stream-v2"


def _bucket_file(length: int) -> str:
    return "sep_%d.jaxexport" % length


def _save_exported(path: str, exp) -> None:
    """Write a ``jax.export.Exported`` as its StableHLO bytecode (``path``)
    and a JSON header (``path + ".json"``).

    ``Exported.serialize`` needs the ``flatbuffers`` package, which a
    serving host need not have.  The programs exported here run on one
    device with no effects, so the header carries everything ``call``
    needs: the pytree structures, the argument and result shapes and
    dtypes, the platforms and the calling convention."""
    import base64
    unsharded = all(s is None for s in
                    exp.in_shardings_hlo + exp.out_shardings_hlo)
    if (exp.nr_devices != 1 or not unsharded or exp.ordered_effects
            or exp.unordered_effects or exp.disabled_safety_checks):
        raise ValueError("only single-device, effect-free programs can be "
                         "saved as serving artifacts")
    header = {
        "fun_name": exp.fun_name,
        "in_tree": base64.b64encode(
            exp.in_tree.serialize_using_proto()).decode(),
        "out_tree": base64.b64encode(
            exp.out_tree.serialize_using_proto()).decode(),
        "in_avals": [[list(a.shape), str(a.dtype)] for a in exp.in_avals],
        "out_avals": [[list(a.shape), str(a.dtype)] for a in exp.out_avals],
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
    }
    with open(path, "wb") as f:
        f.write(exp.mlir_module_serialized)
    with open(path + ".json", "w") as f:
        json.dump(header, f, indent=1)


def _load_exported(path: str):
    """Inverse of _save_exported: a callable ``jax.export.Exported``."""
    import base64

    import jax
    import jax.numpy as jnp
    from jax import export as jexport
    with open(path + ".json") as f:
        h = json.load(f)
    with open(path, "rb") as f:
        module = f.read()

    def tree(b64):
        return jax.tree_util.PyTreeDef.deserialize_using_proto(
            jax.tree_util.default_registry, base64.b64decode(b64))

    def avals(specs):
        return tuple(jax.core.ShapedArray(tuple(shape), jnp.dtype(dtype))
                     for shape, dtype in specs)

    n_in, n_out = len(h["in_avals"]), len(h["out_avals"])
    return jexport.Exported(
        fun_name=h["fun_name"], in_tree=tree(h["in_tree"]),
        in_avals=avals(h["in_avals"]), out_tree=tree(h["out_tree"]),
        out_avals=avals(h["out_avals"]), nr_devices=1,
        in_shardings_hlo=(None,) * n_in, out_shardings_hlo=(None,) * n_out,
        _has_named_shardings=True, _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        platforms=tuple(h["platforms"]), ordered_effects=(),
        unordered_effects=(), disabled_safety_checks=(),
        mlir_module_serialized=module,
        calling_convention_version=h["calling_convention_version"],
        module_kept_var_idx=tuple(h["module_kept_var_idx"]),
        uses_global_constants=h["uses_global_constants"], _get_vjp=None)


def _cast_weights(params, weights_dtype: Optional[str]):
    """Cast floating-point parameter leaves to a reduced serving dtype.

    bf16-baked weights halve the artifact size and feed the tensor cores'
    bf16 path at inference; model code upcasts where f32 math is required
    (ops.nn.mm/ee accumulate f32), so this is a pure storage/GEMM-operand
    change.  Non-float leaves (if any) pass through untouched.
    """
    if not weights_dtype:
        return params
    import jax
    import jax.numpy as jnp
    dt = jnp.dtype(weights_dtype)
    if dt not in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float32),
                  jnp.dtype(jnp.float16)):
        raise ValueError("weights_dtype must be a float dtype, got %r"
                         % (weights_dtype,))
    return jax.tree.map(
        lambda x: x.astype(dt)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        params)


def export_separator(model, params, out_dir: str,
                     lengths: Sequence[int], batch: int = 1,
                     platforms: Optional[Sequence[str]] = None,
                     weights_dtype: Optional[str] = None) -> dict:
    """Export `model.separate_wav(params, .)` for each length bucket.

    Args:
        model: a built DaNet (its hparams pin the DSP/encoder config).
        params: trained parameter pytree (baked into the artifact).
        out_dir: artifact directory (created if needed).
        lengths: waveform-length buckets (samples), e.g. 8k/16k/32k.
        batch: static batch size of the exported program.
        platforms: lowering platforms, e.g. ("cuda",), ("cuda", "cpu").
            None = the current default platform.
        weights_dtype: optional reduced dtype for the baked-in parameters
            (e.g. "bfloat16" — half the artifact size, bf16 serving
            GEMMs; see _cast_weights).

    Returns:
        The manifest dict (also written to out_dir/manifest.json).
    """
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    hp = model.hp
    lengths = sorted(int(l) for l in lengths)
    if platforms is not None:
        platforms = tuple(str(p) for p in platforms)

    # Exported artifacts are single-program: drop any training-time
    # MESH_* strategy from the (copied) config so the encoder routes
    # densely instead of baking multi-device shard_map collectives into
    # the artifact.  (The encoders also fall back densely on their own
    # when the active mesh lacks the axis; this makes it explicit.)
    if any(int(getattr(hp, k, 1) or 1) > 1 for k in
           ("MESH_MODEL", "MESH_PIPE", "MESH_EXPERT", "MESH_SEQ")):
        import copy
        hp = copy.copy(hp)
        hp.MESH_DATA = hp.MESH_MODEL = 1
        hp.MESH_PIPE = hp.MESH_EXPERT = hp.MESH_SEQ = 1
        model = type(model)(hp, name=model.name)

    os.makedirs(out_dir, exist_ok=True)
    # bake parameters in as program constants; normalize to unsharded jax
    # arrays (numpy leaves would break traced indexing inside modules)
    params = jax.tree.map(jnp.asarray, jax.device_get(params))
    params = _cast_weights(params, weights_dtype)

    def fn(wav):
        return model.separate_wav(params, wav)

    for length in lengths:
        spec = jax.ShapeDtypeStruct((batch, length), jnp.float32)
        exp = jexport.export(jax.jit(fn), platforms=platforms)(spec)
        _save_exported(os.path.join(out_dir, _bucket_file(length)), exp)

    manifest = {
        "format": FORMAT,
        "lengths": lengths,
        "batch": int(batch),
        "platforms": list(platforms) if platforms is not None
        else [jexport.default_export_platform()],
        "n_signal": int(hp.MAX_N_SIGNAL),
        "smprate": int(hp.SMPRATE),
        "fft_size": int(hp.FFT_SIZE),
        "fft_stride": int(hp.FFT_STRIDE),
        "encoder": str(hp.ENCODER_TYPE),
        "infer_estimator": str(hp.INFER_ESTIMATOR_METHOD),
        "separator": str(hp.SEPARATOR_TYPE),
        "weights_dtype": str(weights_dtype or "float32"),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


class SeparatorBundle:
    """Loaded serving artifact: bucketed exported programs + manifest.

    ``separate(wav)`` zero-pads the request up to the smallest admitting
    bucket, runs the exported program, and trims the outputs back to the
    request length.
    """

    def __init__(self, directory: str):
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError("not a danet-tpu serving artifact: %r"
                             % (directory,))
        self._programs = {
            int(length): _load_exported(
                os.path.join(directory, _bucket_file(length)))
            for length in self.manifest["lengths"]}

    @property
    def lengths(self):
        return sorted(self._programs)

    def _pick_bucket(self, length: int) -> int:
        for cand in self.lengths:
            if cand >= length:
                return cand
        raise ValueError(
            "request length %d exceeds the largest exported bucket %d"
            % (length, self.lengths[-1]))

    def separate(self, wav: np.ndarray) -> np.ndarray:
        """[L] or [B, L] float waveform -> [B, N, <=L] separated sources
        (B=1 squeezed back out for rank-1 input)."""
        wav = np.asarray(wav, dtype=np.float32)
        squeeze = wav.ndim == 1
        if squeeze:
            wav = wav[None]
        batch = self.manifest["batch"]
        if wav.shape[0] != batch:
            raise ValueError(
                "artifact was exported with batch=%d, got %d"
                % (batch, wav.shape[0]))
        length = wav.shape[1]
        bucket = self._pick_bucket(length)
        padded = np.zeros((batch, bucket), dtype=np.float32)
        padded[:, :length] = wav
        out = np.asarray(self._programs[bucket].call(padded))
        out = out[..., :length]
        return out[0] if squeeze else out


def load_separator(directory: str) -> SeparatorBundle:
    return SeparatorBundle(directory)


# ---------------------------------------------------------------------------
# Streaming (stateful) serving: real-time causal separation as two AOT
# programs — warmup (wav -> sep + state) and step (state, chunk -> sep,
# state').  All state is an explicit pytree (DaNet.stream_init/stream_step),
# so jax.export captures the full pipeline: STFT input tail, encoder
# recurrent/conv state, overlap-add tail, frozen warmup statistics.
# ---------------------------------------------------------------------------

STREAM_WARMUP_FILE = "stream_warmup.jaxexport"
STREAM_STEP_FILE = "stream_step.jaxexport"


def export_streamer(model, params, out_dir: str, chunk_samples: int,
                    warmup_samples: int, batch: int = 1,
                    platforms: Optional[Sequence[str]] = None,
                    weights_dtype: Optional[str] = None) -> dict:
    """Export the causal streaming pipeline as a two-program artifact.

    Requires a causal encoder (lstm-orig, gru-v1, tcn-v1+TCN_CAUSAL —
    DaNet.stream_init's gate).  ``chunk_samples``/``warmup_samples`` must
    be multiples of FFT_STRIDE; the step program has a fixed per-call
    input size (constant latency — the point of streaming serving).
    """
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    hp = model.hp
    # sample granularity / output lag come from the model when it
    # exposes them (tasnet-v1: TASNET_STRIDE / win-stride); the STFT
    # convention (FFT_STRIDE / FFT_SIZE-FFT_STRIDE) is the DaNet default
    gran_fn = getattr(model, "stream_granularity_samples", None)
    stride = int(gran_fn()) if gran_fn else int(hp.FFT_STRIDE)
    lat_fn = getattr(model, "stream_latency_samples", None)
    latency = (int(lat_fn()) if lat_fn
               else int(hp.FFT_SIZE) - int(hp.FFT_STRIDE))
    if chunk_samples % stride or warmup_samples % stride:
        raise ValueError(
            "chunk_samples/warmup_samples must be multiples of the "
            "stream granularity %d" % stride)
    if platforms is not None:
        platforms = tuple(str(p) for p in platforms)
    os.makedirs(out_dir, exist_ok=True)
    params = jax.tree.map(jnp.asarray, jax.device_get(params))
    params = _cast_weights(params, weights_dtype)

    def warmup_fn(wav):
        return model.stream_init(params, wav)

    def step_fn(state, chunk):
        return model.stream_step(params, state, chunk)

    wspec = jax.ShapeDtypeStruct((batch, warmup_samples), jnp.float32)
    cspec = jax.ShapeDtypeStruct((batch, chunk_samples), jnp.float32)
    _, state_spec = jax.eval_shape(warmup_fn, wspec)

    exp_w = jexport.export(jax.jit(warmup_fn), platforms=platforms)(wspec)
    exp_s = jexport.export(jax.jit(step_fn), platforms=platforms)(
        state_spec, cspec)
    _save_exported(os.path.join(out_dir, STREAM_WARMUP_FILE), exp_w)
    _save_exported(os.path.join(out_dir, STREAM_STEP_FILE), exp_s)

    from jax import export as _je
    manifest = {
        "format": STREAM_FORMAT,
        "chunk_samples": int(chunk_samples),
        "warmup_samples": int(warmup_samples),
        "batch": int(batch),
        "latency_samples": latency,
        "platforms": list(platforms) if platforms is not None
        else [_je.default_export_platform()],
        "n_signal": int(hp.MAX_N_SIGNAL),
        "smprate": int(hp.SMPRATE),
        "fft_size": int(hp.FFT_SIZE),
        "fft_stride": stride,
        "encoder": str(hp.ENCODER_TYPE),
        "infer_estimator": str(hp.INFER_ESTIMATOR_METHOD),
        "separator": str(hp.SEPARATOR_TYPE),
        "weights_dtype": str(weights_dtype or "float32"),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


class StreamerBundle:
    """Loaded streaming artifact: hold the state, feed fixed-size chunks.

    Usage::

        s = load_streamer(dir)
        sep0 = s.start(wav[:warmup])          # [B, N, warmup]
        for chunk in chunks(wav, s.chunk_samples):
            sep = s.feed(chunk)               # [B, N, chunk]

    Output audio lags input by ``manifest['latency_samples']`` samples.
    """

    def __init__(self, directory: str):
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != STREAM_FORMAT:
            raise ValueError("not a danet-tpu streaming artifact: %r"
                             % (directory,))
        self._warmup = _load_exported(
            os.path.join(directory, STREAM_WARMUP_FILE))
        self._step = _load_exported(os.path.join(directory, STREAM_STEP_FILE))
        self._state = None

    @property
    def chunk_samples(self) -> int:
        return int(self.manifest["chunk_samples"])

    @property
    def warmup_samples(self) -> int:
        return int(self.manifest["warmup_samples"])

    def start(self, wav_warmup: np.ndarray) -> np.ndarray:
        wav_warmup = np.asarray(wav_warmup, dtype=np.float32)
        if wav_warmup.ndim == 1:
            wav_warmup = wav_warmup[None]
        out, state = self._warmup.call(wav_warmup)
        self._state = state
        return np.asarray(out)

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        if self._state is None:
            raise RuntimeError("call start(warmup) before feed(chunk)")
        chunk = np.asarray(chunk, dtype=np.float32)
        if chunk.ndim == 1:
            chunk = chunk[None]
        out, self._state = self._step.call(self._state, chunk)
        return np.asarray(out)


def load_streamer(directory: str) -> StreamerBundle:
    return StreamerBundle(directory)


# ---------------------------------------------------------------------------
# CLI: python -m danet_tpu.serve {export,run} ...
# ---------------------------------------------------------------------------

def _main():
    import argparse
    ap = argparse.ArgumentParser(
        description="export / run AOT separation serving artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="export a trained model")
    ex.add_argument("-c", "--hparams-file", default=None)
    ex.add_argument("-i", "--input-pfile", required=True,
                    help="checkpoint to export")
    ex.add_argument("-o", "--out-dir", required=True)
    ex.add_argument("--lengths", default="16000,40000,80000",
                    help="comma-separated waveform-length buckets")
    ex.add_argument("--batch", type=int, default=1)
    ex.add_argument("--platforms", default=None,
                    help="comma-separated lowering platforms (e.g. "
                         "'cuda,cpu'); default = current platform")
    ex.add_argument("--weights-dtype", default=None,
                    help="reduced dtype for the baked-in parameters "
                         "(e.g. 'bfloat16': half the artifact size, "
                         "bf16 serving GEMMs)")

    rn = sub.add_parser("run", help="separate a WAV with an artifact")
    rn.add_argument("-d", "--artifact-dir", required=True)
    rn.add_argument("-if", "--input-file", required=True)
    rn.add_argument("-o", "--output-prefix", default="separated")

    exs = sub.add_parser(
        "export-stream",
        help="export the causal streaming pipeline (stateful two-program "
             "artifact; requires a causal encoder)")
    exs.add_argument("-c", "--hparams-file", default=None)
    exs.add_argument("-i", "--input-pfile", required=True)
    exs.add_argument("-o", "--out-dir", required=True)
    exs.add_argument("--chunk", type=int, default=4096,
                     help="step-program chunk size in samples "
                          "(multiple of FFT_STRIDE)")
    exs.add_argument("--warmup", type=int, default=16384,
                     help="warmup-program window in samples")
    exs.add_argument("--batch", type=int, default=1)
    exs.add_argument("--platforms", default=None)
    exs.add_argument("--weights-dtype", default=None)

    rs = sub.add_parser(
        "run-stream",
        help="separate a WAV by simulated streaming through a stream "
             "artifact")
    rs.add_argument("-d", "--artifact-dir", required=True)
    rs.add_argument("-if", "--input-file", required=True)
    rs.add_argument("-o", "--output-prefix", default="separated")
    args = ap.parse_args()

    from danet_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.cmd == "export":
        import jax
        from danet_tpu.hparams import hparams
        import danet_tpu  # noqa: F401 (registries)
        from danet_tpu.models import DaNet  # noqa: F401
        from danet_tpu.train import checkpoint as ckpt_lib

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        hparams.load_json(os.path.join(repo, "default.json"))
        if args.hparams_file:
            hparams.load_json(args.hparams_file)
        hparams.digest()
        model = hparams.get_model()()  # MODEL_TYPE
        params = model.init(jax.random.PRNGKey(0))
        params = ckpt_lib.load_eval_params(args.input_pfile, params)
        platforms = (args.platforms.split(",")
                     if args.platforms else None)
        manifest = export_separator(
            model, params, args.out_dir,
            [int(x) for x in args.lengths.split(",")],
            batch=args.batch, platforms=platforms,
            weights_dtype=args.weights_dtype)
        print(json.dumps(manifest, indent=2, sort_keys=True))
    elif args.cmd == "export-stream":
        import jax
        from danet_tpu.hparams import hparams
        import danet_tpu  # noqa: F401 (registries)
        from danet_tpu.models import DaNet  # noqa: F401
        from danet_tpu.train import checkpoint as ckpt_lib

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        hparams.load_json(os.path.join(repo, "default.json"))
        if args.hparams_file:
            hparams.load_json(args.hparams_file)
        hparams.digest()
        model = hparams.get_model()()  # MODEL_TYPE
        params = model.init(jax.random.PRNGKey(0))
        params = ckpt_lib.load_eval_params(args.input_pfile, params)
        platforms = (args.platforms.split(",")
                     if args.platforms else None)
        manifest = export_streamer(
            model, params, args.out_dir,
            chunk_samples=args.chunk, warmup_samples=args.warmup,
            batch=args.batch, platforms=platforms,
            weights_dtype=args.weights_dtype)
        print(json.dumps(manifest, indent=2, sort_keys=True))
    elif args.cmd == "run-stream":
        from danet_tpu.data import audio
        bundle = load_streamer(args.artifact_dir)
        wav = audio.load_wav_raw(args.input_file,
                                 bundle.manifest["smprate"])
        warm, chunk = bundle.warmup_samples, bundle.chunk_samples
        total = max(len(wav), warm)
        n_chunks = -(-(total - warm) // chunk)
        padded = np.zeros(warm + n_chunks * chunk, dtype=np.float32)
        padded[:len(wav)] = wav
        parts = [bundle.start(padded[:warm])]
        for i in range(n_chunks):
            lo = warm + i * chunk
            parts.append(bundle.feed(padded[lo:lo + chunk]))
        # Streaming output lags input by latency_samples (stream_init
        # docstring): the last lag-window of real content flushes into
        # the zero-pad tail.  Keep len(wav) + latency and drop the rest
        # of the padding — lossless, unlike trimming at len(wav).
        lag = int(bundle.manifest.get(
            "latency_samples", bundle.manifest["fft_size"]
            - bundle.manifest["fft_stride"]))
        out = np.concatenate(parts, axis=-1)[0][..., :len(wav) + lag]
        scale = max(float(np.max(np.abs(out))), 1.0)
        for i, src in enumerate(out):
            path = "%s_%d.wav" % (args.output_prefix, i)
            audio.save_wav_raw(path, src, bundle.manifest["smprate"],
                               scale=scale)
            print("wrote", path)
    else:
        from danet_tpu.data import audio
        bundle = load_separator(args.artifact_dir)
        wav = audio.load_wav_raw(args.input_file,
                                 bundle.manifest["smprate"])
        out = bundle.separate(wav)
        # one shared normalization across all stems: relative source
        # levels survive (per-file peak scaling would distort them)
        scale = max(float(np.max(np.abs(out))), 1.0)
        for i, src in enumerate(out):
            path = "%s_%d.wav" % (args.output_prefix, i)
            audio.save_wav_raw(path, src, bundle.manifest["smprate"],
                               scale=scale)
            print("wrote", path)


if __name__ == "__main__":
    _main()
