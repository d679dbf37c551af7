"""The CSA-Trans model in PyTorch (training and serving)."""

from csat_tpu_torch.models.csa_trans import CSATrans

__all__ = ["CSATrans"]
