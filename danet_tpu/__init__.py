"""danet_tpu: a JAX/XLA speech-separation framework
with the capabilities of khaotik/DaNet-Tensorflow.

Importing this package populates the component registries
(encoders/estimators/separators/optimizers/datasets), mirroring the
reference's import-time registration (/root/reference/main.py:29-35).
"""
from danet_tpu.hparams import hparams  # noqa: F401
import danet_tpu.models  # noqa: F401
import danet_tpu.optim  # noqa: F401
import danet_tpu.data  # noqa: F401

__version__ = "0.1.0"
