"""The port's profiling tool (``otfusion_tpu_torch.cli.profile_flagship``):
its kernel buckets, and a rehearsal of every phase on the CPU at a tiny
size."""

import json

import pytest

from otfusion_tpu_torch.cli import profile_flagship


@pytest.mark.parametrize("name,bucket", [
    ("void (anonymous namespace)::gw_cluster_kernel<1, 2>(float const*, "
     "float const*)", "port_k1"),
    ("void (anonymous namespace)::sinkhorn_solve_kernel<true>(float const*, "
     "float const*)", "port_k2"),
    ("void (anonymous namespace)::sinkhorn_solve_kernel<false>(float "
     "const*, float const*)", "port_k2"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
     "at::native::WelfordOps<float, float, int>>>", "batchnorm"),
    ("void at::native::batch_norm_backward_reduce_channels_last_kernel<4>",
     "batchnorm"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv_gemm"),
    ("nvjet_tst_96x64_64x8_1x2_h_bz_splitK_NTN", "conv_gemm"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", "copy_cast"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<3>>",
     "optimizer"),
    ("void at::native::max_pool3d_with_indices_single_out_frame<BFloat16>",
     "pool"),
    ("void at::native::vectorized_elementwise_kernel<8, "
     "CUDAFunctor_add<c10::BFloat16>>", "other"),
])
def test_bucket_of(name, bucket):
    assert profile_flagship.bucket_of(name) == bucket


def test_profile_rehearsal_on_cpu(tmp_path):
    result = profile_flagship.main([
        "--device", "cpu", "--model-depth", "10", "--target-side", "16",
        "--n-per-class", "4", "--max-jax-samples", "4", "--batch-size", "2",
        "--warmup", "1", "--steps", "1", "--repeats", "1",
        "--profiled-steps", "1", "--out", str(tmp_path)])
    saved = json.loads((tmp_path / "profile.json").read_text())
    assert saved["coupling"] == result["coupling"]
    assert len(saved["train_step_ms"]) == 1
    assert saved["coupling"]["samples"] == 8
    assert len(saved["coupling"]["gw_iters"]) == 2
    assert saved["coupling"]["fot_iters"] > 0
    # the CPU has no device activity to bucket
    for key in ("train_profile", "pipeline_profile"):
        assert saved[key]["device_ms"] == 0.0
        assert saved[key]["wall_ms"] > 0.0
