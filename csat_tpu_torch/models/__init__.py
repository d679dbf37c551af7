"""The CSA-Trans model in PyTorch (serving path)."""

from csat_tpu_torch.models.csa_trans import CSATrans

__all__ = ["CSATrans"]
