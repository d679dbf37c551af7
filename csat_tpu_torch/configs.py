"""Config: the fields of the JAX package's ``configs.Config`` that the port
reads, under the same names and defaults, plus the named registry.

Field names are identical to the reference's so one set of overrides builds
both configs.  Fields that only select JAX/TPU machinery (``backend``,
meshes, compilation caches, ``flex_bwd``), the trainer's loop (data paths,
epochs, bucketing, checkpoints, eval decode) or serving features outside this
port are absent: the port picks kernel or plain path by the device a tensor
lies on, and a field it never reads is not one it pretends to honour.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "python"

    # model (reference defaults: config/python.py)
    seed: int = 2021
    use_pegen: str = "pegen"
    pe_dim: int = 256
    pegen_dim: int = 512
    sbm_enc_dim: int = 512
    num_layers: int = 4  # CSE depth
    sbm_layers: int = 4
    clusters: Tuple[int, ...] = (10, 10, 10, 10)
    full_att: bool = False
    num_heads: int = 8
    hidden_size: int = 512
    dim_feed_forward: int = 2048
    decoder_layers: int = 4
    tree_pos_width: int = 8
    tree_pos_height: int = 16

    max_tgt_len: int = 50
    max_src_len: int = 150

    # SBM graph: Bernoulli clamp floor, the noise of the sampled graph
    # ("shared": uniform noise from the generator through the STE, the
    # sbm_graph mod; "counter": the hash stream drawn in-kernel, the
    # sbm_sampled mod), and the eval-time graph ("expected" = the Bernoulli
    # mean clip(Q̂SK̂ᵀ, floor, .99), the deterministic graph served; "sample"
    # draws a graph at eval too)
    sbm_floor: float = 0.01
    noise_mode: str = "shared"
    eval_graph: str = "sample"
    bucket_src_lens: Tuple[int, ...] = ()

    # training (reference: config/python.py, script/train.py)
    dropout: float = 0.2
    attention_dropout: float = 0.2  # fixed 0.2 in the reference
    sw: float = 1e-2  # sparsity-regularizer weight
    learning_rate: float = 1e-4
    smoothing: float = 0.0  # label smoothing
    batch_size: int = 64
    nonfinite_guard: bool = True

    # serving: slot pool and the block-paged KV pool
    serve_slots: int = 8
    serve_prefill_budget: int = 0
    serve_page_size: int = 16
    serve_num_pages: int = 0

    # reference-compat quirk flags (same meanings as the JAX package)
    generator_dropout: bool = True
    pad_row: str = "zero"
    cse_empty_rows: str = "uniform"

    @property
    def head_dim(self) -> int:
        return self.sbm_enc_dim // self.num_heads

    @property
    def src_emb_dim(self) -> int:
        return self.sbm_enc_dim - self.pe_dim

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.use_pegen in (
            "pegen", "laplacian", "sequential", "treepos", "triplet"), self.use_pegen
        assert self.pad_row in ("zero", "frozen"), self.pad_row
        assert self.cse_empty_rows in ("uniform", "zero"), self.cse_empty_rows
        assert self.eval_graph in ("sample", "expected"), self.eval_graph
        assert self.noise_mode in ("shared", "counter"), self.noise_mode
        assert 0.0 <= self.dropout < 1.0 and 0.0 <= self.attention_dropout < 1.0
        assert self.sbm_enc_dim % self.num_heads == 0
        assert self.hidden_size % self.num_heads == 0
        assert self.num_heads % 2 == 0, "CSE splits heads into L and T halves"
        assert len(self.clusters) == self.sbm_layers
        assert self.serve_slots >= 1, self.serve_slots
        assert self.serve_page_size >= 1, self.serve_page_size
        assert self.serve_num_pages >= 0, self.serve_num_pages
        assert self.serve_prefill_budget >= 0, self.serve_prefill_budget
        assert all(n >= 1 for n in self.bucket_src_lens), self.bucket_src_lens
        if self.use_pegen == "sequential":
            assert self.pe_dim == 0
        else:
            assert 0 < self.pe_dim < self.sbm_enc_dim


# the registry holds the variants the port serves (pegen PE, SBM encoder);
# the reference's other PE variants and full attention return with their ports
_PY = Config(name="python")
_JAVA = _PY.replace(name="java", pe_dim=128, sbm_enc_dim=768)

_REGISTRY = {}


def _reg(cfg: Config) -> Config:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


_reg(_PY)
_reg(_JAVA)


def get_config(name: str, **overrides) -> Config:
    """Look up a named variant; keyword overrides are applied on top."""
    cfg = _REGISTRY[name]
    if overrides:
        cfg = cfg.replace(**overrides)
        cfg.validate()
    return cfg
