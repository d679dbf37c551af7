"""Attention ops of the serving path: each a CUDA kernel plus its plain
PyTorch version (``flex_core``/``mods``: the encoder's blocked attention;
``paged_decode``: the decoder's paged attention; ``build``: compile, load,
count launches)."""
