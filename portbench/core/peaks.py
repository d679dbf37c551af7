"""The card's peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet,
dense rates without sparsity, at its full 700 W power limit.

``tc`` is the tensor-core rate an implementation exact to the configuration's
dtype can reach: for f32, 3xTF32 (three TF32 products per f32 product,
495 / 3 TFLOP/s), so no f32-exact implementation reads above 100 %; for
bf16, the bf16 rate.  ``f32`` is the rate outside the tensor cores and
``hbm`` the memory bandwidth.
"""

PEAKS = {
    "float32": {"tc": 495e12 / 3, "f32": 67e12, "hbm": 3.35e12},
    "bfloat16": {"tc": 989e12, "f32": 67e12, "hbm": 3.35e12},
}
