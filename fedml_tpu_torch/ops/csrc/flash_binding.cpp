// PyTorch binding of the three flash-attention kernels. The only source that
// includes PyTorch's headers; the kernels themselves (flash_*.cu) have a
// plain C interface. The Python wrappers (ops/flash_attention.py) check
// devices, dtypes, shapes and contiguity and allocate every output; this file
// passes pointers and the current stream through and raises on a launch
// error.
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

extern "C" {
int fedml_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bhq,
                    int hq, int hkv, int t, int d, int causal, int block_q, int block_k,
                    int is_bf16, void* stream);
int fedml_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int bhq, int hq, int hkv,
                       int t, int d, int causal, int block_q, int block_k, int is_bf16,
                       void* stream);
int fedml_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int bhkv,
                        int hq, int hkv, int t, int d, int causal, int block_q, int block_k,
                        int is_bf16, void* stream);
}

namespace {

void* stream_of(const torch::Tensor& x) {
  return static_cast<void*>(c10::cuda::getCurrentCUDAStream(x.get_device()).stream());
}

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void fwd(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor o, torch::Tensor lse,
         bool causal, int64_t hq, int64_t hkv, int64_t block_q, int64_t block_k) {
  check(fedml_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr<float>(), q.size(0), hq, hkv, q.size(1), q.size(2), causal,
                        block_q, block_k, q.scalar_type() == torch::kBFloat16, stream_of(q)),
        "flash_fwd");
}

void bwd_dq(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor dout,
            torch::Tensor lse, torch::Tensor delta, torch::Tensor dq, bool causal, int64_t hq,
            int64_t hkv, int64_t block_q, int64_t block_k) {
  check(fedml_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                           lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
                           q.size(0), hq, hkv, q.size(1), q.size(2), causal, block_q, block_k,
                           q.scalar_type() == torch::kBFloat16, stream_of(q)),
        "flash_bwd_dq");
}

void bwd_dkv(torch::Tensor q, torch::Tensor k, torch::Tensor v, torch::Tensor dout,
             torch::Tensor lse, torch::Tensor delta, torch::Tensor dk, torch::Tensor dv,
             bool causal, int64_t hq, int64_t hkv, int64_t block_q, int64_t block_k) {
  check(fedml_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(),
                            dv.data_ptr(), k.size(0), hq, hkv, q.size(1), q.size(2), causal,
                            block_q, block_k, q.scalar_type() == torch::kBFloat16, stream_of(q)),
        "flash_bwd_dkv");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fwd", &fwd);
  m.def("bwd_dq", &bwd_dq);
  m.def("bwd_dkv", &bwd_dkv);
}
