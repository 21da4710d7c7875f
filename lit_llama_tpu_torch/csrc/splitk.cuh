// The fixed-order sum of a GEMM's K splits, used by the Hopper mainloop of K3
// and K6 at M > 1 (gemm_sm90.cuh); the f32 tile (gemm_f32.cuh) and K6's M == 1
// body (gemv_int8_sm90.cuh) merge their splits in the kernel, behind a
// counter. Each split writes its raw
// f32 partial, and one thread sums a result's partials in split order, so
// the result does not depend on the schedule.
#pragma once

#include "common.cuh"

namespace splitk {

// out[i] = OT(sum over z of ws[z, i]), times qscale[i % N] where qscale is
// given; i runs over the M * N results; OT the compute dtype, bf16 or f32
template <typename OT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ qscale,
                                     OT* __restrict__ out, size_t MN, int N, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN; i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * MN + i];
    out[i] = from_f32<OT>(qscale != nullptr ? v * qscale[i % N] : v);
  }
}

template <typename OT>
inline void launch_splitk_reduce(const float* ws, const float* qscale, OT* out, size_t MN, int N,
                                 int splits, cudaStream_t st) {
  const size_t blocks = (MN + 255) / 256;
  splitk_reduce_kernel<OT><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(ws, qscale, out, MN, N,
                                                                                       splits);
}

}  // namespace splitk
