"""Attention ops of the serving and training paths: each a CUDA kernel plus
its plain PyTorch version (``flex_core``/``mods``: the encoder's blocked
attention, forward and backward; ``hashrng``: the counter hash stream of the
sampled graph and of attention dropout; ``paged_decode``: the decoder's paged
attention; ``build``: compile, load, count launches)."""
