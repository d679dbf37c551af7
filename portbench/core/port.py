"""The program's side of a run: the port's ``Config`` and model for a cell.

Everything here imports ``csat_tpu_torch`` inside the function that needs it,
so the yardstick's modules (the reference, the counts, the gates) load
without the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

__all__ = ["port_config", "port_model"]


def port_config(model: Dict, mix: Dict, root: Path):
    """The port's ``Config``: the registry entry the configuration file
    starts from, every field the file states, and the mix's settings."""
    from csat_tpu_torch.configs import Config, get_config

    fields = set(Config.__dataclass_fields__) - {"name"}
    over = {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items() if k in fields}
    over.update({k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in mix.get("settings", {}).items()})
    over["output_dir"] = str(root / "build" / "portbench" / "outputs")
    return get_config(model["registry"], **over)


def port_model(cfg, model: Dict, weights: Dict[str, torch.Tensor], device):
    """The port's model for ``cfg``, its parameters copied from ``weights``."""
    from csat_tpu_torch.train.state import make_model

    net = make_model(cfg, model["src_vocab_size"], model["tgt_vocab_size"], device=device)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(weights[name])
    return net
