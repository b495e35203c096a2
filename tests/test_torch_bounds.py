"""The kernels' bounds in ``chip_smoke.py`` against hand counts.

Each bound is the larger of a kernel's FLOPs at the H100's bf16 peak and its
bytes at the memory rate.  ``bound`` is replaced here by one that returns the
raw ``(FLOPs, bytes)``, and each formula is held at one small shape against
the products and tensors counted out below: the FLOPs of the function (two
n_q x n_k products forward for attention, five backward: q·kᵀ, dO·vᵀ, dv, dq
and dk; the dgrad GEMMs of a block's backward), each input read once and
each output written once (bf16 tensors, f32 lse and parameter sums).  The
script imports only the standard library at module level, so the CPU can
import it.  The profile phase's names for the hybrid tier's kernels are
pinned too, and so is the bound of one forward GEMM (the measurement behind
``launch_forward_gemm``'s threshold).
"""

import pytest

import chip_smoke


@pytest.fixture
def raw(monkeypatch):
    monkeypatch.setattr(chip_smoke, "bound", lambda flops, nbytes: (flops, nbytes))


def test_bound_takes_the_larger_time():
    ms, by = chip_smoke.bound(989e12, 3.35e12 / 2)  # 1 s of products, 0.5 s of bytes
    assert ms == pytest.approx(1000.0) and by == "operations"
    ms, by = chip_smoke.bound(989e12 / 4, 3.35e12)
    assert ms == pytest.approx(1000.0) and by == "bytes"


def test_flash_bounds(raw):
    # b 1, 2 heads, 10 queries, 20 keys, q/k 40 wide, v 32: 400 pairs.
    qk_product, pv_product = 2 * 400 * 40, 2 * 400 * 32   # 32,000 and 25,600 FLOPs
    q, k, v, o, lse = 2 * 20 * 40, 2 * 40 * 40, 2 * 40 * 32, 2 * 20 * 32, 4 * 20
    got = chip_smoke.flash_bounds(1, 2, 10, 20, 40, 32)
    assert got["flash_attention"] == (qk_product + pv_product, q + k + v + o + lse)
    # s and dq, dk at width 40; dp and dv at 32.
    assert got["flash_backward"] == (3 * qk_product + 2 * pv_product,
                                     2 * (q + k + v + o) + lse)
    assert got["flash_backward"][0] == 147_200


def test_cross_bounds(raw):
    # b 1, 8 queries of c 16, 2 heads, 4 keys, dh_k 40, dh_v 32: 8 rows, 64 pairs.
    q_gemm, out_gemm = 2 * 8 * 16 * 80, 2 * 8 * 64 * 16     # xn·Wqᵀ, oattn·Woᵀ
    qk_product, pv_product = 2 * 64 * 40, 2 * 64 * 32
    act, w, kv = 2 * 8 * 16, 2 * 16 * (80 + 64), 2 * 4 * (80 + 64)
    got = chip_smoke.cross_bounds(1, 8, 16, 2, 4, 40, 32)
    # x, xn, Wq, k, v, Wo, bo in; y out.
    assert got["fused_cross_attention"] == (q_gemm + out_gemm + qk_product + pv_product,
                                            3 * act + kv + w + 2 * 16)
    # dy·Wo and dq·Wq; dy, q, k, v, oattn, lse, Wq, Wo in; dxn, dq, dk, dv, f32 dbo out.
    q_bytes, o_bytes, lse = 2 * 8 * 80, 2 * 8 * 64, 4 * 2 * 8
    assert got["fused_cross_attention_bwd"] == (
        out_gemm + q_gemm + 3 * qk_product + 2 * pv_product,
        act + q_bytes + 2 * kv + o_bytes + lse + w + act + q_bytes + 4 * 16)


def test_block_bounds(raw):
    # b 2, n 10, d 16, 2 heads of 8, hidden 32: 20 rows, inner 16.
    fc, qkv_gemm, proj_gemm = 2 * 20 * 16 * 32, 2 * 20 * 16 * 48, 2 * 20 * 16 * 16
    attn = 2 * 2 * 2 * 10 * 10 * 8  # one n x n x dim_head product
    act, h, qkv = 2 * 20 * 16, 2 * 20 * 32, 2 * 20 * 48
    w_mlp, w_attn = 2 * 2 * 16 * 32, 2 * (48 * 16 + 16 * 16)
    got = chip_smoke.block_bounds(2, 10, 16, 2, 8, 32)
    assert got["fused_mlp"] == (2 * fc, act + w_mlp + 2 * (3 * 16 + 32) + act)
    # the dgrads dy·W2 and dh·W1; dy, x, h, γ, W1, W2 in; dx, dh, gact, f32 sums out.
    assert got["fused_mlp_bwd"] == (2 * fc, 2 * act + h + 2 * 16 + w_mlp + act + 2 * h
                                    + 4 * (3 * 16 + 32))
    assert got["fused_attention_block"] == (qkv_gemm + proj_gemm + 2 * attn,
                                            act + w_attn + 2 * 3 * 16 + act)
    # dy·Wo and dqkv·Wqkv, and five attention products.
    assert got["fused_attention_block_bwd"] == (proj_gemm + qkv_gemm + 5 * attn,
                                                2 * act + qkv + w_attn + 2 * 16 + act + qkv
                                                + 4 * 3 * 16)


def test_short_bounds(raw):
    # b 2, 3 heads, 10 queries, 20 keys, d 32: 1200 pairs.
    product = 2 * 1200 * 32
    q, k = 2 * 2 * 3 * 10 * 32, 2 * 2 * 3 * 20 * 32
    got = chip_smoke.short_bounds(2, 3, 10, 20, 32)
    assert got["short_attention"] == (2 * product, q + 2 * k + q)  # q, k, v in; out
    # q, k, v, dout in; dq, dk, dv out.
    assert got["short_attention_bwd"] == (5 * product, 2 * q + 2 * k + q + 2 * k)


def test_hybrid_bounds(raw):
    # b 2, n 5, d 16, 2 heads of 8, hidden 32: 10 rows, inner 16.
    qkv_gemm, proj_gemm, fc = 2 * 10 * 16 * 48, 2 * 10 * 16 * 16, 2 * 10 * 16 * 32
    act, qkv, o, h = 2 * 10 * 16, 2 * 10 * 48, 2 * 10 * 16, 2 * 10 * 32
    w_qkv, w_mlp = 2 * 48 * 16, 2 * (16 * 16 + 2 * 16 * 32)
    got = chip_smoke.hybrid_bounds(2, 5, 16, 2, 8, 32)
    assert got["ln_gemm"] == (qkv_gemm, act + 2 * 2 * 16 + w_qkv + qkv)
    assert got["ln_gemm_bwd"] == (qkv_gemm, qkv + act + 2 * 16 + w_qkv + act + 2 * 4 * 16)
    pairs_product = 2 * (2 * 2 * 5 * 5) * 8
    assert got["attention_nb"] == (2 * pairs_product, 4 * o)
    assert got["attention_nb_bwd"] == (5 * pairs_product, 7 * o)  # q, k, v, do; dq, dk, dv
    # x, o, Wo, W1, W2, bo, γ, β, b2, b1 in; z out.
    assert got["proj_mlp"] == (proj_gemm + 2 * fc,
                               act + o + w_mlp + 2 * (4 * 16 + 32) + act)
    # dz·W2, dh·W1, dy·Wo; dz, y, h, γ, weights in; dy, do, dh, gact, f32 dγ dβ dbo db2 db1 out.
    assert got["proj_mlp_bwd"] == (2 * fc + proj_gemm,
                                   2 * act + h + 2 * 16 + w_mlp + act + o + 2 * h
                                   + 4 * (4 * 16 + 32))
    assert got["proj_mlp"][1] == 3_712 and got["proj_mlp_bwd"][1] == 6_176


def test_gemm_bound(raw):
    rows, n, k = 6, 16, 8
    a, w, out, b = 2 * rows * k, 2 * n * k, 2 * rows * n, 2 * n
    flops = 2 * rows * n * k
    assert chip_smoke.gemm_bound(rows, n, k, "store") == (flops, a + w + out)
    assert chip_smoke.gemm_bound(rows, n, k, "bias_gelu") == (flops, a + w + b + out)
    # h kept beside g; the residual read.
    assert chip_smoke.gemm_bound(rows, n, k, "bias_gelu_save") == (flops, a + w + b + 2 * out)
    assert chip_smoke.gemm_bound(rows, n, k, "bias_residual") == (flops, a + w + b + 2 * out)


@pytest.mark.parametrize("kernel,group", [
    ("void vit::(anonymous namespace)::short_bwd_kernel<__nv_bfloat16, 64, 80, 80>(CUtensorMap)",
     "short_bwd_kernel (d 64, 80-key tiles)"),
    ("void vit::(anonymous namespace)::short_bwd_wg_kernel<__nv_bfloat16, 64>(CUtensorMap)",
     "short_bwd_wg_kernel (d 64)"),
    ("void vit::(anonymous namespace)::short_fwd_kernel<__nv_bfloat16, 64, 80>(CUtensorMap)",
     "short_fwd_kernel (d 64, 80-key tiles)"),
    ("void vit::(anonymous namespace)::gemm_wgmma_kernel<__nv_bfloat16, 3>(CUtensorMap)",
     "gemm_wgmma_kernel bias+GELU, keeps h (fc1)"),
    ("void vit::(anonymous namespace)::gemm_wgmma_kernel<__nv_bfloat16, 0>(CUtensorMap)",
     "gemm_wgmma_kernel store (QKV, doattn)"),
    ("void vit::(anonymous namespace)::gemm_wgmma_kernel<__nv_bfloat16, 4, 1>(CUtensorMap)",
     "gemm_wgmma_kernel dGELU (dy·W2)"),
    ("void vit::(anonymous namespace)::gemm_wgmma_kernel<__nv_bfloat16, 5, 1>(CUtensorMap)",
     "gemm_wgmma_kernel f32 out (dxn)"),
    # the dgrad whose epilogue is the LayerNorm backward (rows 2, 4, 12, 14)
    ("void vit::(anonymous namespace)::gemm_wgmma_kernel<__nv_bfloat16, 6, 1>(CUtensorMap, "
     "CUtensorMap, vit::(anonymous namespace)::Operands<__nv_bfloat16>, int, int, int)",
     "gemm_wgmma_kernel LN backward (dxn on chip)"),
    ("void vit::(anonymous namespace)::mha_fwd_kernel<__nv_bfloat16, 64, false>(const "
     "__nv_bfloat16 *, const float *, unsigned long, __nv_bfloat16 *, int, int, float)",
     "mha_fwd_kernel"),
    ("void vit::(anonymous namespace)::mha_fwd_kernel<__nv_bfloat16, 64, true>(const "
     "__nv_bfloat16 *, const float *, unsigned long, __nv_bfloat16 *, int, int, float)",
     "mha_fwd_kernel (bias)"),
    ("void vit::(anonymous namespace)::mha_bwd_dq_kernel<__nv_bfloat16, 64, true>(const "
     "__nv_bfloat16 *)", "mha_bwd_dq_kernel (bias)"),
    # proj_mlp's backward: its three dgrads on gemm_wgmma, W as it lies
    ("void vit::(anonymous namespace)::gemm_wgmma_kernel<__nv_bfloat16, 0, 1>(CUtensorMap)",
     "gemm_wgmma_kernel store (QKV, doattn)"),
    # the cross-attention block's: one kernel and its fixed-order reduction
    ("void vit::(anonymous namespace)::cross_bwd_kernel<__nv_bfloat16, 40, 32, 64>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const float "
     "*, __nv_bfloat16 *, __nv_bfloat16 *, float *, int, int, int, int, int, float)",
     "cross_bwd_kernel (dk 40, dv 32)"),
    ("void vit::(anonymous namespace)::cross_bwd_reduce_kernel<__nv_bfloat16>(const float *, "
     "__nv_bfloat16 *, __nv_bfloat16 *, float *, int, long long, long long, int, int)",
     "cross_bwd_reduce_kernel"),
    ("void vit::(anonymous namespace)::cross_fwd_kernel<__nv_bfloat16, 32, 32, 64>(CUtensorMap)",
     "cross_fwd_kernel (dk 32, dv 32)"),
])
def test_profile_groups_the_hybrid_kernels(kernel, group):
    assert chip_smoke.kernel_group(kernel) == group
