// Batched k x k SPD solve for the ALS normal equations, as one CUDA kernel
// called from JAX through the XLA FFI (ycnr_tpu/ops/cuda_solve.py).
//
// For every system s it solves  (sym(A_s) + reg_s * I) x_s = b_s,  where
// sym(A) = (A + A^T) / 2, exactly the contract of the XLA path in
// ops/gram.guarded_batched_solve. One thread block owns one system: the
// matrix is read from device memory once into shared memory (k * (k + 1)
// floats, 16.6 KB at k = 64), regularised, symmetrised,
// factored and substituted there, and only x is written back.
//
// The factorisation is the square-root-free form A = L D L^T, right-looking
// over columns with the forward substitution fused in as one more column:
//   for j:  d_j = 1 / S_jj
//           S_rc -= S_rj * d_j * S_cj   (j < c <= r)      trailing update
//           y_r  -= S_rj * d_j * y_j    (r > j)           forward solve
// after which  x_j = (y_j - sum_{i>j} S_ij x_i) * d_j  runs backwards in one
// warp. Column j is only read while the trailing part is written, so each
// column costs one __syncthreads().
//
// Built for sm_90a (the H100) by ops/cuda_solve.build_library(), which
// runs nvcc with jax.ffi.include_dir() on the include path.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxRank = 64;  // MAX_RANK in cuda_solve.py

// Row stride of the shared-memory matrix: odd, so that walking a column
// (stride ld) across the 32 lanes of a warp touches 32 distinct banks.
__host__ __device__ inline int smem_ld(int k) { return (k % 2 == 0) ? k + 1 : k; }

inline size_t smem_bytes(int k) {
  return sizeof(float) * (static_cast<size_t>(k) * smem_ld(k) + 2 * k);
}

template <int NT>
__global__ void __launch_bounds__(NT)
    spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     const float* __restrict__ reg, float* __restrict__ x,
                     int k, int64_t n_sys) {
  constexpr int NW = NT / 32;
  extern __shared__ float smem[];
  const int ld = smem_ld(k);
  float* S = smem;           // [k][ld] working matrix (lower triangle used)
  float* y = S + k * ld;     // [k] right-hand side -> solution
  float* dinv = y + k;       // [k] 1 / pivot
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int64_t s = blockIdx.x; s < n_sys; s += gridDim.x) {
    const float* As = A + s * k * k;
    for (int r = warp; r < k; r += NW)
      for (int c = lane; c < k; c += 32) S[r * ld + c] = As[r * k + c];
    for (int i = threadIdx.x; i < k; i += NT) y[i] = b[s * k + i];
    __syncthreads();

    // symmetrise into the lower triangle and add the ridge on the diagonal
    // (reads only the strict upper triangle, which nothing writes)
    const float ridge = reg[s];
    for (int r = warp; r < k; r += NW)
      for (int c = lane; c <= r; c += 32)
        S[r * ld + c] = (c == r) ? S[r * ld + c] + ridge
                                 : 0.5f * (S[r * ld + c] + S[c * ld + r]);
    __syncthreads();

    for (int j = 0; j < k; ++j) {
      const float dj = 1.0f / S[j * ld + j];
      if (threadIdx.x == 0) dinv[j] = dj;
      const float yj = y[j];
      for (int r = j + 1 + warp; r < k; r += NW) {
        const float srj = S[r * ld + j] * dj;
        for (int c = j + 1 + lane; c <= r; c += 32)
          S[r * ld + c] -= srj * S[c * ld + j];
        if (lane == 0) y[r] -= srj * yj;
      }
      __syncthreads();
    }

    // back substitution in warp 0: lane (i % 32) owns y[i] for the whole
    // sweep, so only x_j itself crosses lanes (one shuffle per column)
    if (warp == 0) {
      for (int j = k - 1; j >= 0; --j) {
        const int owner = j & 31;
        float xj = 0.0f;
        if (lane == owner) {
          xj = y[j] * dinv[j];
          y[j] = xj;
        }
        xj = __shfl_sync(0xffffffffu, xj, owner);
        for (int i = lane; i < j; i += 32) y[i] -= S[j * ld + i] * xj;
      }
      for (int i = lane; i < k; i += 32) x[s * k + i] = y[i];
    }
    __syncthreads();
  }
}

template <int NT>
cudaError_t launch(cudaStream_t stream, const float* A, const float* b,
                   const float* reg, float* x, int k, int64_t n_sys) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      spd_solve_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxRank)));
  if (err != cudaSuccess) return err;
  const int64_t max_grid = 2147483647;
  const unsigned grid =
      static_cast<unsigned>(n_sys < max_grid ? n_sys : max_grid);
  spd_solve_kernel<NT><<<grid, NT, smem, stream>>>(A, b, reg, x, k, n_sys);
  return cudaGetLastError();
}

ffi::Error SpdSolveImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> a,
                        ffi::Buffer<ffi::F32> b, ffi::Buffer<ffi::F32> reg,
                        ffi::ResultBuffer<ffi::F32> x) {
  const auto dims = a.dimensions();
  if (dims.size() < 2 || dims[dims.size() - 1] != dims[dims.size() - 2])
    return ffi::Error::InvalidArgument("A must be [..., k, k]");
  const int64_t k = dims[dims.size() - 1];
  if (k < 1 || k > kMaxRank)
    return ffi::Error::InvalidArgument("rank k must be in [1, 64], got " +
                                       std::to_string(k));
  const int64_t n_sys = static_cast<int64_t>(reg.element_count());
  if (static_cast<int64_t>(a.element_count()) != n_sys * k * k ||
      static_cast<int64_t>(b.element_count()) != n_sys * k ||
      static_cast<int64_t>(x->element_count()) != n_sys * k)
    return ffi::Error::InvalidArgument(
        "shapes disagree: A [B, k, k], b [B, k], reg [B], x [B, k]");
  if (n_sys == 0) return ffi::Error::Success();
  const int kk = static_cast<int>(k);
  const float* pa = a.typed_data();
  const float* pb = b.typed_data();
  const float* pr = reg.typed_data();
  float* px = x->typed_data();
  cudaError_t err;
  if (kk <= 16)
    err = launch<32>(stream, pa, pb, pr, px, kk, n_sys);
  else if (kk <= 32)
    err = launch<64>(stream, pa, pb, pr, px, kk, n_sys);
  else
    err = launch<128>(stream, pa, pb, pr, px, kk, n_sys);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("spd_solve launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(YcnrSpdSolve, SpdSolveImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
