"""AdamW as the reference runs it: no bias correction, eps 1e-6, decoupled decay.

Counterpart of the JAX package's ``train/optimizer.py`` at
``correct_bias=False``, the only setting the reference runs (it vendors
HuggingFace's AdamW, ``script/optimizer.py:49-106``):

    m ← b1·m + (1 − b1)·g,   v ← b2·v + (1 − b2)·g²
    p ← p − lr·(m / (√v + eps) + wd·p)

with ``m``, ``v`` the uncorrected moments.  ``torch.optim.AdamW`` always
bias-corrects, so the update is written here.
Parameters and moments are updated in place (no second copy of either), with
``torch._foreach_*`` so one step is a few launches over all tensors rather
than several per tensor.  The moments of all parameters of one device and
dtype are views into one buffer, so the non-finite guard (``ok``, a 0-d
bool tensor the update never reads on the host) selects the old or the new
moments with one ``torch.where`` per buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch

__all__ = ["AdamW", "AdamWState"]

# each moment view starts on a multiple of this many elements (64 bytes in
# f32), so the vectorised paths of the _foreach kernels see aligned tensors
_ALIGN = 16


@dataclasses.dataclass
class AdamWState:
    # an int, or a 0-d int64 tensor on the parameters' device once a guarded
    # update has counted on it
    count: Union[int, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    # the buffers mu's and nu's tensors are views of, one per (device, dtype)
    buffers: List[torch.Tensor] = dataclasses.field(default_factory=list)


def _zeros_in_buffers(params: Dict[str, torch.Tensor]):
    """``({name: zeros like params[name]}, [buffers])``: each tensor a view
    into one flat buffer per (device, dtype)."""
    groups: Dict[tuple, List[str]] = {}
    for k, p in params.items():
        groups.setdefault((p.device, p.dtype), []).append(k)
    views, buffers = {}, []
    for (device, dtype), keys in groups.items():
        sizes = [-(-params[k].numel() // _ALIGN) * _ALIGN for k in keys]
        flat = torch.zeros(sum(sizes), device=device, dtype=dtype)
        offset = 0
        for k, size in zip(keys, sizes):
            views[k] = flat[offset:offset + params[k].numel()].view(params[k].shape)
            offset += size
        buffers.append(flat)
    return views, buffers


class AdamW:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        mu, mu_bufs = _zeros_in_buffers(params)
        nu, nu_bufs = _zeros_in_buffers(params)
        return AdamWState(count=0, mu=mu, nu=nu, buffers=mu_bufs + nu_bufs)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: AdamWState, ok: Optional[torch.Tensor] = None) -> None:
        """One step on ``params`` and ``state``, in place.  With ``ok`` (a
        0-d bool tensor) the step applies only where it is true, decided on
        the device: a false ``ok`` leaves parameters, moments and count
        bitwise as they were, a true one gives the unguarded step's bits."""
        keys = list(params)
        p: List[torch.Tensor] = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        # a non-finite g makes the new moments NaN, and NaN·0 is NaN: the
        # old moments are kept aside whole and selected back, one launch
        # per buffer
        if ok is not None and not state.buffers:
            raise ValueError("a guarded update needs the moments in buffers (AdamW.init)")
        kept = [b.clone() for b in state.buffers] if ok is not None else None
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
        if ok is None:
            state.count += 1
        else:
            for buf, old in zip(state.buffers, kept):
                torch.where(ok, buf, old, out=buf)
            state.count = state.count + ok.to(torch.int64)
        # from the selected moments: finite whenever they are, so a rejected
        # step's update is a finite number times 0
        step = torch._foreach_div(mu, torch._foreach_add(torch._foreach_sqrt(nu), self.eps))
        if self.weight_decay > 0:
            step = torch._foreach_add(step, torch._foreach_mul(p, self.weight_decay))
        delta = torch._foreach_mul(step, -self.lr)
        if ok is not None:
            # ×1 is exact and ×0 adds a zero: p + 0 is p
            delta = torch._foreach_mul(delta, ok.to(delta[0].dtype))
        torch._foreach_add_(p, delta)
