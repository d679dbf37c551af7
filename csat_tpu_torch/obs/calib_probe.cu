// The compile probe's fixed source (obs/calibrate.py): a small kernel that
// the probe builds with the port's nvcc flags and never launches.  It is
// kept constant so that its build time measures the toolchain and the host,
// not the code: y = softmax(tanh(x · w1) · w2) row by row, one block a row.

#include <cuda_runtime.h>

namespace {

constexpr int D_IN = 64, D_HID = 128, D_OUT = 32;

__global__ void calib_probe_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                                   const float* __restrict__ w2, float* __restrict__ y,
                                   int rows) {
    __shared__ float xs[D_IN], hs[D_HID], ys[D_OUT];
    const int row = blockIdx.x;
    if (row >= rows) return;
    for (int i = threadIdx.x; i < D_IN; i += blockDim.x) xs[i] = x[row * D_IN + i];
    __syncthreads();
    for (int j = threadIdx.x; j < D_HID; j += blockDim.x) {
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < D_IN; ++i) acc += xs[i] * w1[i * D_HID + j];
        hs[j] = tanhf(acc);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < D_OUT; j += blockDim.x) {
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < D_HID; ++i) acc += hs[i] * w2[i * D_OUT + j];
        ys[j] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = ys[0], s = 0.f;
        for (int j = 1; j < D_OUT; ++j) m = fmaxf(m, ys[j]);
        for (int j = 0; j < D_OUT; ++j) s += __expf(ys[j] - m);
        for (int j = 0; j < D_OUT; ++j) y[row * D_OUT + j] = __expf(ys[j] - m) / s;
    }
}

}  // namespace

extern "C" int calib_probe(const float* x, const float* w1, const float* w2, float* y,
                           int rows, cudaStream_t stream) {
    if (rows <= 0) return -1;
    calib_probe_kernel<<<rows, 128, 0, stream>>>(x, w1, w2, y, rows);
    return static_cast<int>(cudaGetLastError());
}
