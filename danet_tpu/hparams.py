"""Hyperparameter system: layered JSON config + component registries.

Mirrors the public surface of the reference config layer
(/root/reference/app/hparams.py:15-130): a singleton ``hparams`` object whose
UPPERCASE attributes are the configuration namespace, ``load``/``load_json``
for layered overrides (defaults JSON -> user JSON -> CLI flags), ``digest()``
for derived parameters, and five decorator registries
(encoder/estimator/separator/optimizer/dataset) so user components are
selectable by config string.

Differences from the reference (deliberate):
  * The window function is resolved through a named window registry instead of
    ``eval``-ing a Python expression from JSON
    (reference security bug at hparams.py:41-42).
  * Extra keys for the runtime: mesh shape, compute dtype, bucketing.
  * ``digest()`` precomputes the STFT window as a numpy array once.
"""
from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict

import numpy as np


# ---------------------------------------------------------------------------
# Window registry (replaces the reference's `eval(self.FFT_WND)`)
# ---------------------------------------------------------------------------

def _hann_symmetric(n: int) -> np.ndarray:
    # scipy.signal.hann(n) default is the *symmetric* window; the reference
    # evaluates `np.sqrt(scipy.signal.hann(self.FFT_SIZE))`. scipy's
    # get_window(..., fftbins=True) would be periodic; hann(n) is symmetric.
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / max(n - 1, 1))


WINDOW_REGISTRY: Dict[str, Callable[[int], np.ndarray]] = {
    # reference default: sqrt(hann(FFT_SIZE))  (default.json:7)
    "sqrt-hann": lambda n: np.sqrt(_hann_symmetric(n)),
    "hann": _hann_symmetric,
    "rect": lambda n: np.ones(n, dtype=np.float64),
    "hamming": lambda n: 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(n) / max(n - 1, 1)),
}


class Hyperparameter:
    """Singleton hyperparameter namespace + component registries."""

    # reference pattern is [A-Z_]+ (hparams.py:19); digits allowed here
    # so corpus-numbered keys (WSJ0_PATH) validate — still must start
    # uppercase
    pattern = r"[A-Z][A-Z0-9_]*"
    encoder_registry: Dict[str, Any] = {}
    model_registry: Dict[str, Any] = {}
    estimator_registry: Dict[str, Any] = {}
    separator_registry: Dict[str, Any] = {}
    ozer_registry: Dict[str, Any] = {}
    dataset_registry: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # digest / derived params
    # ------------------------------------------------------------------
    def digest(self) -> None:
        """Recompute derived hyperparameters after any update.

        Mirrors reference hparams.py:29-42 (COMPLEXX, FEATURE_SIZE, window)
        minus the `eval` hole.
        """
        self.COMPLEXX = dict(
            float32="complex64", float64="complex128")[self.FLOATX]
        self.FEATURE_SIZE = 1 + self.FFT_SIZE // 2
        assert isinstance(self.DROPOUT_KEEP_PROB, float)
        assert 0.0 < self.DROPOUT_KEEP_PROB <= 1.0

        wnd_name = getattr(self, "FFT_WND", "sqrt-hann")
        if wnd_name not in WINDOW_REGISTRY:
            raise KeyError(
                "Unknown FFT_WND %r; valid options: %s"
                % (wnd_name, sorted(WINDOW_REGISTRY)))
        self.FFT_WND_ARRAY = WINDOW_REGISTRY[wnd_name](
            self.FFT_SIZE).astype(self.FLOATX)

    # ------------------------------------------------------------------
    # layered loading
    # ------------------------------------------------------------------
    def load(self, di: dict) -> None:
        assert isinstance(di, dict)
        pat = re.compile(self.pattern)
        for k, v in di.items():
            if pat.fullmatch(k) is None:
                raise NameError("Bad hyperparameter key %r" % (k,))
            assert isinstance(v, (str, int, float, bool, type(None))), (
                "Hyperparameter %s has non-scalar value %r" % (k, v))
        self.__dict__.update(di)

    def load_json(self, file_) -> None:
        if isinstance(file_, (str, bytes)):
            with open(file_, "r") as f:
                di = json.load(f)
        else:
            di = json.load(file_)
        self.load(di)

    # ------------------------------------------------------------------
    # registries (same decorator surface as reference hparams.py:72-120)
    # ------------------------------------------------------------------
    @classmethod
    def register_encoder(cls_, name):
        def wrapper(cls):
            cls_.encoder_registry[name] = cls
            return cls
        return wrapper

    def get_encoder(self, name=None):
        return type(self).encoder_registry[
            self.ENCODER_TYPE if name is None else name]

    @classmethod
    def register_model(cls_, name):
        """Model-family registry (new, no reference analogue — the
        reference has exactly one Model class, main.py:61).  Selected by
        MODEL_TYPE: 'danet' (default) or 'tasnet-v1'."""
        def wrapper(cls):
            cls_.model_registry[name] = cls
            return cls
        return wrapper

    def get_model(self, name=None):
        return type(self).model_registry[
            (getattr(self, "MODEL_TYPE", "danet") or "danet")
            if name is None else name]

    @classmethod
    def register_estimator(cls_, name):
        def wrapper(cls):
            cls_.estimator_registry[name] = cls
            return cls
        return wrapper

    def get_estimator(self, name):
        return type(self).estimator_registry[name]

    @classmethod
    def register_separator(cls_, name):
        def wrapper(cls):
            cls_.separator_registry[name] = cls
            return cls
        return wrapper

    def get_separator(self, name):
        return type(self).separator_registry[name]

    @classmethod
    def register_optimizer(cls_, name):
        def wrapper(fn):
            cls_.ozer_registry[name] = fn
            return fn
        return wrapper

    def get_optimizer(self, name=None):
        return type(self).ozer_registry[
            self.OPTIMIZER_TYPE if name is None else name]

    @classmethod
    def register_dataset(cls_, name):
        def wrapper(fn):
            cls_.dataset_registry[name] = fn
            return fn
        return wrapper

    def get_dataset(self, name=None):
        return type(self).dataset_registry[
            self.DATASET_TYPE if name is None else name]


def apply_overrides(hp, pairs) -> None:
    """Apply CLI ``--set KEY=VALUE`` overrides (shared by the experiment
    drivers so training and eval parse overrides identically).

    Values are JSON-typed (``--set TCN_BLOCKS=5`` -> int 5,
    ``--set TCN_CAUSAL=true`` -> bool) with a bare-string fallback.
    A missing '=' is an error; a key the loaded config does not already
    carry gets a loud stderr warning (likely a typo — a misspelled
    architecture override would otherwise silently train the default
    architecture, since encoders getattr their dims with defaults)."""
    import sys as _sys
    for kv in pairs:
        key, eq, val = kv.partition("=")
        if not eq:
            raise ValueError(
                "--set expects KEY=VALUE, got %r" % (kv,))
        try:
            val = json.loads(val)
        except ValueError:
            pass  # bare string value
        if not hasattr(hp, key):
            print("WARNING: --set %s: key not present in the loaded "
                  "config (new key, or a typo?)" % key, file=_sys.stderr)
        hp.load({key: val})


hparams = Hyperparameter()
