"""Special-token ids and the device rule shared by every entry point.

Token ids mirror the JAX package's ``utils/tokens.py`` (the reference's
``utils/vocab.py:10-19``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

PAD = 0
UNK = 1
BOS = 2
EOS = 3

SELF_WORD = "<self>"
PAD_WORD = "<pad>"
UNK_WORD = "<unk>"
BOS_WORD = "<s>"
EOS_WORD = "</s>"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else.  Raises when CUDA is asked for (or defaulted to) and
    absent — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
