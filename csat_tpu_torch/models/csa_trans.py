"""CSATrans: the encoder–decoder model, trained and served.

Counterpart of the JAX package's ``models/csa_trans.py:72-261``: source
embedding ``sbm_enc_dim - pe_dim`` wide, one of the five positional
encodings (``cfg.use_pegen``: ``pegen`` — the CSE stack over a second token
embedding; ``laplacian``, ``treepos``, ``triplet`` — ``models/pe.py``;
``sequential`` — a sinusoidal table added inside the encoder), the SBM
encoder (or full attention under ``cfg.full_att``), and a decoder run
teacher-forced over the whole target (``forward``, the training pass) or
stepped one token per slot over the paged KV pool (``decode_step``,
serving).  Submodules carry flax's names (``src_pe_embedding``, ``pegen``,
``tree_pos_enc``, ``triplet_emb``) and exist only for their variant.

``dtype`` is the compute dtype ``cfg.compute_dtype`` names (bf16 or f32, as
the JAX ``make_model`` picks it): the parameters stay f32 master weights,
every module computes in ``dtype`` with f32 attention islands
(``models/components.py``), the PE inputs are cast to it, and the
log-probabilities come out f32.

Under a ``model`` axis (``parallel.mesh.shard_model``) each module runs its
member's heads and hidden units (``models/components.py``); the per-head
sparsities come back whole from every SBM layer (gathered over the line),
so the sparsity term — their mean over heads and layers — and the loss are
the same on every member.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.dataset import Batch
from csat_tpu_torch.models.components import Decoder, Embeddings, Generator, make_std_mask
from csat_tpu_torch.models.cse import CSE
from csat_tpu_torch.models.init import init_params
from csat_tpu_torch.models.pe import (
    TRIPLET_VOCAB_FALLBACK, TreePositionalEncodings, TripletEmbedding, laplacian_pe)
from csat_tpu_torch.models.sbm import SBMEncoder
from csat_tpu_torch.utils import PAD, resolve_device


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A batch field the PE variants read as a tensor on ``device``:
    ``data.dataset.batch_to_device`` leaves ``num_node``, ``adj``,
    ``tree_pos`` and ``triplet`` on the host, since the pegen models never
    read them."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


class CSATrans(nn.Module):
    """Built on ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``) with weights drawn from ``seed`` (default
    ``cfg.seed``) under ``cfg.init_scheme`` — or load converted flax weights
    afterwards (``convert.load_flax_params``).  ``triplet_vocab_size`` sizes
    the triplet table (0: the reference's per-language fallback;
    ``train.state.make_model`` checks it against the dictionary on disk)."""

    def __init__(self, cfg: Config, src_vocab_size: int, tgt_vocab_size: int,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: Optional[int] = None, triplet_vocab_size: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.cfg = cfg
        self.dtype = dtype
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.triplet_vocab_size = 0
        self.src_embedding = Embeddings(src_vocab_size, cfg.src_emb_dim, cfg.dropout,
                                        pad_row=cfg.pad_row, dtype=dtype)
        self.tgt_embedding = Embeddings(tgt_vocab_size, cfg.hidden_size, cfg.dropout,
                                        with_pos=True, pad_row=cfg.pad_row, dtype=dtype)
        if cfg.use_pegen == "pegen":
            self.src_pe_embedding = Embeddings(src_vocab_size, cfg.pegen_dim, cfg.dropout,
                                               pad_row=cfg.pad_row, dtype=dtype)
            self.pegen = CSE(cfg, dtype)
        elif cfg.use_pegen == "treepos":
            self.tree_pos_enc = TreePositionalEncodings(
                cfg.tree_pos_height, cfg.tree_pos_width,
                cfg.pegen_dim // (cfg.tree_pos_height * cfg.tree_pos_width))
        elif cfg.use_pegen == "triplet":
            self.triplet_vocab_size = triplet_vocab_size or TRIPLET_VOCAB_FALLBACK[cfg.lang]
            self.triplet_emb = TripletEmbedding(self.triplet_vocab_size, cfg.pegen_dim, dtype)
        self.encoder = SBMEncoder(cfg, dtype)
        self.decoder = Decoder(cfg.decoder_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.dim_feed_forward, cfg.dropout, dtype)
        self.generator = Generator(cfg.hidden_size, tgt_vocab_size,
                                   reference_dropout=cfg.generator_dropout,
                                   dropout=cfg.dropout)
        init_params(self, cfg.seed if seed is None else seed, cfg.init_scheme)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.generator.fc1.weight.device

    @torch.no_grad()
    def encode(self, batch: Batch, deterministic: bool = True,
               gen: Optional[torch.Generator] = None,
               shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch`` with tensors on the model's device
        (``data.dataset.batch_to_device``) → ``(memory (B, N, hidden),
        sparsity scalar)``, without gradients (serving's prefill).  Sampled
        graphs draw from ``gen``, a generator on the model's device; ``shard``
        (a :class:`~csat_tpu_torch.parallel.mesh.DataShard`) runs the encoder
        along its ``seq`` or ``pipe`` axis (every process of the axis gets
        the whole memory)."""
        return self._encode(batch, deterministic, gen, shard)[:2]

    @torch.no_grad()
    def encode_pe(self, batch: Batch, deterministic: bool = True,
                  gen: Optional[torch.Generator] = None):
        """:meth:`encode` plus the post-expansion PE ``(B, N, pe_dim)`` the
        encoder concatenates to the token embedding — the probe's input
        (None for ``sequential``, which has none)."""
        return self._encode(batch, deterministic, gen)

    def _encode(self, batch: Batch, deterministic: bool, gen: Optional[torch.Generator],
                shard=None):
        """The encoder half under autograd → ``(memory, sparsity, pe)``
        (``deterministic=False`` drops and samples from ``gen``; ``shard``,
        a :class:`~csat_tpu_torch.parallel.mesh.DataShard`, places the batch
        in a data-parallel step's global batch)."""
        cfg = self.cfg
        dev = batch.src_seq.device
        src_mask = batch.src_seq == PAD
        src_emb = self.src_embedding(batch.src_seq, deterministic=deterministic, gen=gen,
                                     shard=shard)
        if cfg.use_pegen == "pegen":
            pe_emb = self.src_pe_embedding(batch.src_seq, deterministic=deterministic, gen=gen,
                                           shard=shard)
            src_pe = self.pegen(pe_emb, batch.L, batch.T, batch.L_mask, batch.T_mask,
                                deterministic, gen, shard)
        elif cfg.use_pegen == "laplacian":
            src_pe = laplacian_pe(_on(batch.adj, dev, torch.float32),
                                  _on(batch.num_node, dev, torch.long),
                                  cfg.pegen_dim).to(self.dtype)
        elif cfg.use_pegen == "treepos":
            src_pe = self.tree_pos_enc(_on(batch.tree_pos, dev, torch.float32)).to(self.dtype)
        elif cfg.use_pegen == "triplet":
            src_pe = self.triplet_emb(_on(batch.triplet, dev, torch.long))
        else:  # sequential: the encoder adds its sinusoidal table
            src_pe = None
        memory, sparsities, pe = self.encoder(src_emb, src_pe, src_mask, deterministic, gen,
                                              shard)
        if cfg.full_att:
            sparsity = torch.ones((), device=dev)
        else:
            sparsity = torch.mean(torch.stack([torch.mean(s) for s in sparsities]))
        return memory, sparsity, pe

    def forward(self, batch: Batch, deterministic: bool = True,
                gen: Optional[torch.Generator] = None,
                shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass → ``(log_probs (B, T, V), sparsity scalar)``,
        the training forward of the JAX ``CSATrans.__call__``.  ``shard``
        (a :class:`~csat_tpu_torch.parallel.mesh.DataShard`) makes it this
        process's share of a data-parallel step on the global batch: the
        sampled graphs and the sparsity are the global batch's (its
        sparsity is this process's term of the global mean)."""
        memory, sparsity, _ = self._encode(batch, deterministic, gen, shard)
        tgt = self.tgt_embedding(batch.tgt_seq, deterministic=deterministic, gen=gen,
                                 shard=shard)
        dec = self.decoder.teacher_forced(tgt, memory, make_std_mask(batch.tgt_seq, PAD),
                                          batch.src_seq == PAD, deterministic, gen, shard)
        return self.generator(dec, deterministic, gen, shard), sparsity

    @torch.no_grad()
    def project_cross_kv(self, memory: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """Per-layer cross-attention K/V ``(B, H, N, dh)`` of the memory."""
        return [layer.cross_attn.project_kv(memory) for layer in self.decoder.layers]

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, pos: torch.Tensor, caches: List[Dict],
                    src_mask: torch.Tensor, prev_pad: torch.Tensor):
        """One token per slot.  ``tok`` (S, 1) inputs at per-slot positions
        ``pos`` (S,); ``caches`` per decoder layer ``{"self": ..., "cross":
        ...}`` page views (``serve/pages.py``); ``src_mask`` (S, N) True on
        padded keys; ``prev_pad`` (S, T) pad flags of the inputs so far (a
        generated PAD is masked out of later self attention).  Returns
        ``(log_probs (S, V), [(k_step, v_step)] per layer)``."""
        max_len = prev_pad.shape[1]
        emb = self.tgt_embedding(tok, pos=pos)
        future = torch.arange(max_len, device=tok.device)[None, :] > pos[:, None]
        self_mask = prev_pad | future                       # (S, T)
        dec_out, steps = self.decoder(emb, self_mask, src_mask, caches)
        return self.generator(dec_out[:, -1]), steps

    def init_page_pool(self, num_pages: int, page_size: int,
                       kv_dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """Zeroed per-layer K/V page arrays ``(num_pages, H, page, dh)``
        stored in ``kv_dtype`` (f32, bf16 or int8) with f32 per-row scales
        of 1.0 (untouched pages, the null page included, dequantize to exact
        zeros)."""
        cfg = self.cfg
        shape = (num_pages, cfg.num_heads, page_size, cfg.hidden_size // cfg.num_heads)
        dev = self.device
        return [
            {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
             "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
             "k_scale": torch.ones(shape[:-1] + (1,), device=dev),
             "v_scale": torch.ones(shape[:-1] + (1,), device=dev)}
            for _ in self.decoder.layers
        ]
