// The fused banded-extension step as a CUDA kernel behind an XLA FFI
// handler: one lane per thread, each running bw_fused_lane
// (../banded_extend.h, shared with the host build the CPU tests reach).
// A block keeps its lanes' eh band rows and queries in shared memory,
// laid out [row][lane] so the threads of a warp hit distinct banks
// whatever columns they are at.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a by
// bwamem_tpu/native.cuda_library(); called through jax.ffi
// (ops/extend_step.fused_cuda).
#include <cuda_runtime.h>

#include "../banded_extend.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

__global__ void fused_kernel(const int8_t* ql, const int8_t* tl,
                             const int8_t* qr, const int8_t* tr,
                             const int32_t* scal, const int32_t* prm,
                             int32_t* out, int64_t B, int32_t qmax_l,
                             int32_t qmax_r, int32_t eh_rows) {
  extern __shared__ int32_t smem[];
  const int lanes = blockDim.x;
  int32_t* eh_h = smem + threadIdx.x;
  int32_t* eh_e = smem + eh_rows * lanes + threadIdx.x;
  int8_t* sq_l =
      reinterpret_cast<int8_t*>(smem + 2 * eh_rows * lanes) + threadIdx.x;
  int8_t* sq_r = sq_l + qmax_l * lanes;
  const int64_t lane = (int64_t)blockIdx.x * lanes + threadIdx.x;
  const bool live = lane < B;
  // stage the block's queries in shared memory (row by row: coalesced)
  for (int32_t j = 0; j < qmax_l; ++j)
    sq_l[j * lanes] = live ? ql[j * B + lane] : 4;
  for (int32_t j = 0; j < qmax_r; ++j)
    sq_r[j * lanes] = live ? qr[j * B + lane] : 4;
  if (!live) return;
  const BwPrm p = {prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6]};
  // targets, scalars and outputs keep the global stride B; the staged
  // queries and the eh rows have stride `lanes`
  bw_fused_lane(sq_l, sq_r, lanes, tl + lane, tr + lane, B, scal + lane,
                out + lane, B, p, eh_h, eh_e, lanes);
}

}  // namespace

static ffi::Error FusedImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> ql,
                            ffi::Buffer<ffi::S8> tl, ffi::Buffer<ffi::S8> qr,
                            ffi::Buffer<ffi::S8> tr,
                            ffi::Buffer<ffi::S32> scal,
                            ffi::Buffer<ffi::S32> prm,
                            ffi::ResultBuffer<ffi::S32> out) {
  const auto dl = ql.dimensions(), dr = qr.dimensions();
  const int64_t B = scal.dimensions()[1];
  const int32_t qmax_l = (int32_t)dl[0], qmax_r = (int32_t)dr[0];
  const int32_t eh_rows = (qmax_l > qmax_r ? qmax_l : qmax_r) + 1;
  // 32 lanes per block while their shared memory fits; fewer for very
  // long queries
  int lanes = 32;
  auto bytes = [&](int l) {
    return (size_t)l * (2 * eh_rows * sizeof(int32_t) + qmax_l + qmax_r);
  };
  while (lanes > 1 && bytes(lanes) > 200 * 1024) lanes >>= 1;
  if (bytes(lanes) > 200 * 1024)
    return ffi::Error::InvalidArgument("query too long for shared memory");
  cudaFuncSetAttribute(fused_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes(lanes));
  const int64_t blocks = (B + lanes - 1) / lanes;
  if (blocks > 0)
    fused_kernel<<<(unsigned)blocks, lanes, bytes(lanes), stream>>>(
        ql.typed_data(), tl.typed_data(), qr.typed_data(), tr.typed_data(),
        scal.typed_data(), prm.typed_data(), out->typed_data(), B, qmax_l,
        qmax_r, eh_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BwamemBandedFused, FusedImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());
