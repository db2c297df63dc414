"""The kernel-name table and the names the breakdown prints."""
import pytest

from bench.harness import trace


@pytest.mark.parametrize("name,cls", [
    ("void fa_fwd_bf16_kernel<128, 128, 128>(CUtensorMap, Args)", "b1"),
    ("void fa_fwd_f32_kernel<128, 32>(Args)", "b1"),
    ("void fa_bwd_dq_bf16_kernel<128, 128>(CUtensorMap, Args)", "b2"),
    ("void fa_bwd_dkv_bf16_kernel<128, 64>(CUtensorMap, Args)", "b3"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NTN", "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>"
     "(Params)", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, AUnaryFunctor>"
     "(int)", "other"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_kernel_class(name, cls):
    assert trace.kernel_class(name) == cls


def test_short_names():
    assert trace.short("void (anonymous namespace)::reduce_kernel<4>(int)"
                       ) == "reduce_kernel<4>"
    assert trace.short("nvjet_tst_192x192") == "nvjet_tst_192x192"
    assert len(trace.short("x" * 300)) == 96


def test_innermost_range():
    r = trace.Ranges([(0, 100, "bench.step"), (10, 20, "aten::mm")])
    assert r.containing(15)[2] == "aten::mm"
    assert r.containing(50)[2] == "bench.step"
    assert r.containing(150) is None
