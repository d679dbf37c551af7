"""Carry flax ``CSATrans`` weights (or their gradients) into the port's modules.

``convert_params`` maps a flax param tree (nested dicts of numpy arrays,
``variables["params"]``) — or a gradient tree of the same structure, as
``jax.grad`` returns it — onto the port's ``named_parameters()`` names, so
weights load into the model and gradients line up with each parameter's
``.grad``:

* a ``Dense`` ``kernel`` ``(in, out)`` becomes a ``Linear`` ``weight``
  ``(out, in)`` (transposed);
* a ``LayerNorm`` ``scale`` becomes ``weight``;
* an ``Embeddings`` module's ``embedding`` table becomes its ``weight`` and its
  ``LayerNorm_0`` its ``norm``;
* ``clusters`` ``(h·kk, dh)``, ``L_q``/``T_q`` ``(R, d)`` and the tree-PE
  decays ``tree_pos_enc/p`` keep their shape; the triplet table
  ``triplet_emb/embedding`` becomes ``triplet_emb.weight``;
* flax's auto-named submodules get the port's names: ``layer_i`` →
  ``layers.i``, ``transformer_i`` → ``blocks.i``, ``DisentangledAttn_0`` /
  ``SBMAttention_0`` → ``attn``, ``ClusterProj_0`` → ``proj``,
  ``FeedForward_0`` → ``ff``, ``Dense_k`` → ``fc{k+1}``, and inside a CSE layer
  or SBM block ``LayerNorm_0``/``LayerNorm_1`` → ``attn_norm``/``ff_norm``.

A flax leaf no rule maps fails loudly, and so does (with ``model``) any port
parameter left unfilled or any shape that disagrees.

A whole train state goes both ways as numpy: :func:`load_train_state` fills a
port ``TrainState`` from the JAX ``TrainState``'s parts (params, the AdamW
``mu``/``nu`` trees and ``count`` of its optax state, ``step``), so a fit can
start from a JAX state; :func:`export_tree` / :func:`export_train_state` map
the port's tensors back onto a flax tree's structure.  The noise generators
are not convertible (JAX threads a PRNG key, the port a ``torch.Generator``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["convert_params", "load_flax_params", "flatten", "flax_path", "load_train_state",
           "export_tree", "export_train_state"]

_SEGMENT = {
    "DisentangledAttn_0": "attn",
    "SBMAttention_0": "attn",
    "ClusterProj_0": "proj",
    "FeedForward_0": "ff",
    "embedding": "weight",
}
_LAYER_NORMS = {"LayerNorm_0": "attn_norm", "LayerNorm_1": "ff_norm"}
_KNOWN = {
    "src_embedding", "tgt_embedding", "src_pe_embedding", "pegen", "encoder",
    "decoder", "generator", "L_q", "T_q", "wq", "wk", "wv", "wo", "l_q", "l_k",
    "t_q", "t_k", "pe_expand", "out", "clusters", "self_attn", "cross_attn",
    "q", "k", "v", "ff", "norm", "norm1", "norm2", "norm3", "bias", "kernel",
    "scale", "tree_pos_enc", "p", "triplet_emb",
}


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested param dict → ``{path tuple: array}``."""
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _map_path(path: Tuple[str, ...]) -> Tuple[str, str]:
    """Flax path → (port state_dict key, leaf kind)."""
    names = []
    for i, seg in enumerate(path):
        parent = path[i - 1] if i else ""
        m = re.fullmatch(r"(layer|transformer)_(\d+)", seg)
        if m:
            names.append(("layers" if m.group(1) == "layer" else "blocks") + "." + m.group(2))
        elif seg in _LAYER_NORMS and re.fullmatch(r"(layer|transformer)_\d+", parent):
            names.append(_LAYER_NORMS[seg])
        elif seg == "LayerNorm_0":
            names.append("norm")
        elif re.fullmatch(r"Dense_\d+", seg):
            names.append(f"fc{int(seg.split('_')[1]) + 1}")
        elif seg in _SEGMENT:
            names.append(_SEGMENT[seg])
        elif seg in _KNOWN:
            names.append(seg)
        else:
            raise KeyError(f"flax leaf {'/'.join(path)}: no rule for {seg!r}")
    leaf = path[-1]
    if leaf == "kernel":
        names[-1] = "weight"
    elif leaf == "scale":
        names[-1] = "weight"
    return ".".join(names), leaf


_NORMS = {"norm", "norm1", "norm2", "norm3", "attn_norm", "ff_norm"}
_TABLES = {"src_embedding", "tgt_embedding", "src_pe_embedding", "triplet_emb"}


def flax_path(name: str) -> str:
    """The inverse of the map above: a port parameter name → its flax path,
    ``/``-joined (``decoder.layers.0.self_attn.q.weight`` →
    ``decoder/layer_0/self_attn/q/kernel``)."""
    parts = name.split(".")
    top = parts[0]
    out = []
    i = 0
    while i < len(parts):
        seg = parts[i]
        if seg in ("layers", "blocks"):
            out.append(("layer_" if seg == "layers" else "transformer_") + parts[i + 1])
            i += 2
            continue
        if i == len(parts) - 1 and seg == "weight":
            prev = parts[i - 1]
            seg = "scale" if prev in _NORMS else "embedding" if prev in _TABLES else "kernel"
        elif seg == "attn":
            seg = "DisentangledAttn_0" if top == "pegen" else "SBMAttention_0"
        elif seg == "proj":
            seg = "ClusterProj_0"
        elif seg == "ff" and top == "pegen":
            seg = "FeedForward_0"
        elif seg in ("attn_norm", "ff_norm"):
            seg = "LayerNorm_0" if seg == "attn_norm" else "LayerNorm_1"
        elif seg == "norm" and name != "decoder.norm." + parts[-1]:
            seg = "LayerNorm_0"
        elif re.fullmatch(r"fc\d+", seg):
            seg = f"Dense_{int(seg[2:]) - 1}"
        out.append(seg)
        i += 1
    return "/".join(out)


def convert_params(flax_params: Mapping, model: Optional[nn.Module] = None
                   ) -> Dict[str, torch.Tensor]:
    """Flax ``CSATrans`` params or gradients → ``{port parameter name: CPU
    f32 tensor}``.  With ``model``, also checks that every parameter of
    ``model.named_parameters()`` is filled exactly once with the right
    shape."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in flatten(flax_params).items():
        key, leaf = _map_path(path)
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        sd[key] = t.T.contiguous() if leaf == "kernel" else t
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.named_parameters()}
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise KeyError(f"unfilled port parameters {missing}; unconsumed flax "
                           f"leaves {extra}")
        bad = [(k, tuple(sd[k].shape), want[k]) for k in want if tuple(sd[k].shape) != want[k]]
        if bad:
            raise ValueError(f"shape mismatches (key, flax, port): {bad}")
    return sd


@torch.no_grad()
def load_flax_params(model: nn.Module, flax_params: Mapping) -> nn.Module:
    """Convert and load into ``model`` in place (onto its device)."""
    sd = convert_params(flax_params, model)
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def load_train_state(state, flax_params: Mapping, mu: Optional[Mapping] = None,
                     nu: Optional[Mapping] = None, count: int = 0, step: int = 0):
    """Fill the port's ``TrainState`` in place from the parts of a JAX one
    (numpy trees): parameters, and — when given — the AdamW first and second
    moments, their count and the step.  The generator is left as it is."""
    def fill(dst: Dict[str, torch.Tensor], tree: Mapping) -> None:
        src = convert_params(tree)
        if set(src) != set(dst):
            raise KeyError(f"state and tree disagree on {sorted(set(src) ^ set(dst))}")
        for key, t in dst.items():
            t.copy_(src[key])

    fill(state.params, flax_params)
    if mu is not None:
        fill(state.opt_state.mu, mu)
        fill(state.opt_state.nu, nu)
    state.opt_state.count = int(count)
    state.step = int(step)
    return state


def export_tree(tensors: Mapping[str, torch.Tensor], flax_template: Mapping) -> Dict:
    """The inverse of :func:`convert_params`: the port's ``{name: tensor}``
    as a nested dict of numpy arrays with ``flax_template``'s structure (a
    ``Dense`` kernel transposed back to ``(in, out)``)."""
    out: Dict = {}
    for path in flatten(flax_template):
        key, leaf = _map_path(path)
        arr = tensors[key].detach().cpu().numpy()
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(arr.T) if leaf == "kernel" else arr.copy()
    return out


def export_train_state(state, flax_template: Mapping) -> Dict:
    """The port's ``TrainState`` as the numpy parts of a JAX one: ``params``,
    ``mu``, ``nu`` (flax trees), ``count`` and ``step``."""
    return {"params": export_tree(state.params, flax_template),
            "mu": export_tree(state.opt_state.mu, flax_template),
            "nu": export_tree(state.opt_state.nu, flax_template),
            "count": int(state.opt_state.count), "step": int(state.step)}
