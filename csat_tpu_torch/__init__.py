"""csat_tpu_torch: the PyTorch/CUDA port of csat_tpu for NVIDIA Hopper.

The JAX package ``csat_tpu`` is the reference; this package mirrors its
module layout (``configs``, ``data``, ``ops``, ``models``, ``serve``,
``train``, ``resilience``) so each module's counterpart is easy to find.  It
imports ``torch`` and ``numpy`` only.  Every TPU kernel on the serving and
training paths is a hand-written CUDA kernel under ``ops/csrc`` (built at
first use by ``ops/build.py``); each has a plain PyTorch version beside it,
which runs for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise instead of falling back.
"""

from csat_tpu_torch.configs import Config, get_config
from csat_tpu_torch.utils import resolve_device

__all__ = ["Config", "get_config", "resolve_device"]
