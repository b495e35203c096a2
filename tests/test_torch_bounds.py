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


def test_block_bounds_with_an_inner_width_other_than_the_model(raw):
    """The objectives' blocks have 8 heads of 64 in 1024: the attention
    block's GEMMs and weights scale with the inner width, not the model's.
    b 2, n 10, d 16, 2 heads of 16 (inner 32), hidden 32."""
    qkv_gemm, proj_gemm = 2 * 20 * 16 * 96, 2 * 20 * 32 * 16
    attn = 2 * 2 * 2 * 10 * 10 * 16
    act, qkv = 2 * 20 * 16, 2 * 20 * 96
    w_attn = 2 * (96 * 16 + 16 * 32)
    got = chip_smoke.block_bounds(2, 10, 16, 2, 16, 32)
    assert got["fused_attention_block"] == (qkv_gemm + proj_gemm + 2 * attn,
                                            act + w_attn + 2 * 3 * 16 + act)
    assert got["fused_attention_block_bwd"] == (proj_gemm + qkv_gemm + 5 * attn,
                                                2 * act + qkv + w_attn + 2 * 16 + act + qkv
                                                + 4 * 3 * 16)


def test_block_bounds_at_pit_stage_1(raw):
    """PiT@224's stage-1 block at batch 64 (961 patches and the cls token,
    d 256, 16 heads of 64: inner 1024 over d), the mha route's shape:
    its GEMMs and its two n x n products, about 129 and 243 GFLOP forward."""
    b, n, d, inner = 64, 962, 256, 1024
    rows = b * n
    qkv_gemm, proj_gemm = 2 * rows * d * 3 * inner, 2 * rows * inner * d
    attn = 2 * b * 16 * n * n * 64
    got = chip_smoke.block_bounds(b, n, d, 16, 64, 2048)
    assert got["fused_attention_block"][0] == qkv_gemm + proj_gemm + 2 * attn
    assert got["fused_attention_block_bwd"][0] == qkv_gemm + proj_gemm + 5 * attn
    assert qkv_gemm + proj_gemm == 129_117_454_336
    assert 2 * attn == 242_599_591_936
    assert got["fused_mlp"][0] == 4 * rows * d * 2048 == 129_117_454_336


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
    # the block's mha route (past 512 tokens) on the flash kernels: PiT's
    # unbiased stage 1 and the biased block's instances; the dbias call's
    # row statistics
    ("void vit::(anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64, 64, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16 *, vit::(anonymous namespace)::"
     "Strides, float *, vit::(anonymous namespace)::Bias, int, int, int, float)",
     "flash_fwd_kernel (dk 64, dv 64: the flash op or the block's mha route)"),
    ("void vit::(anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64, 64, true>("
     "CUtensorMap, CUtensorMap, CUtensorMap)",
     "flash_fwd_kernel (dk 64, dv 64, bias: the biased block's mha route)"),
    ("void vit::(anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 32, 32, true>("
     "CUtensorMap)", "flash_bwd_dq_kernel (dk 32, dv 32, bias: the biased block's mha route)"),
    # the names the profiler gives: PiT's unbiased dq and dk/dv kernels, and
    # the dbias call's row statistics
    ("void vit::(anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 64, 64, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, int, __nv_"
     "bflo", "flash_bwd_dq_kernel (dk 64, dv 64: the flash op or the block's mha route)"),
    ("void vit::(anonymous namespace)::mha_row_stats_kernel<__nv_bfloat16, 32>(__nv_"
     "bfloat16 const*)", "mha_row_stats_kernel"),
    ("void vit::(anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, 64, 64, 3, false>("
     "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*)",
     "flash_bwd_dkv_kernel (dk 64, dv 64: the flash op or the block's mha route)"),
    # flash instances no block runs keep their widths only
    ("void vit::(anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, 192, 192, 2, false>("
     "CUtensorMap)", "flash_bwd_dkv_kernel (dk 192, dv 192)"),
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


def test_mlp_bounds_at_t2t_widths(raw):
    """The fused MLP over rows at the module's widths, whatever the kernels
    pad to: 147 over T2T's 64 x 3136 rows and 1323 over its 64 x 784, each
    two GEMMs of 2·rows·d·hidden; x, γ, β, W1, b1, W2, b2 in and y out
    (dy, x, h, γ, W1, W2 in and dx, dh, gact, f32 sums out backward)."""
    for rows, d in ((64 * 3136, 147), (64 * 784, 1323)):
        act, w = 2 * rows * d, 2 * 2 * d * d
        got = chip_smoke.mlp_bounds(rows, d, d)
        assert got["fused_mlp"] == (4 * rows * d * d, act + w + 2 * 4 * d + act)
        assert got["fused_mlp_bwd"] == (4 * rows * d * d, 3 * act + 3 * act + w + 2 * d
                                        + 4 * 4 * d)
    assert chip_smoke.mlp_bounds(64 * 3136, 147, 147)["fused_mlp"][0] == 17_348_050_944
    assert chip_smoke.mlp_bounds(64 * 784, 1323, 1323)["fused_mlp"][0] == 351_298_031_616
    block = chip_smoke.block_bounds(2, 10, 16, 2, 8, 32)
    assert {k: block[k] for k in ("fused_mlp", "fused_mlp_bwd")} == \
        chip_smoke.mlp_bounds(20, 16, 32)


@pytest.mark.parametrize("tag,n,d", chip_smoke.DENSE_MLP_SHAPES)
def test_mlp_bounds_at_the_dense_family_shapes(raw, tag, n, d):
    """Rows 1-2 at CrossViT's encoders and after the patch merger (batch
    64, hidden 2048), as :func:`chip_smoke.dense_kernel_phase` times them:
    the two GEMMs' 4·rows·d·2048 FLOPs; x and y, the weights and the
    vectors forward; dy, x, dx and h, dh, gact (rows x 2048) backward."""
    rows, hidden = 64 * n, 2048
    act, w = 2 * rows * d, 2 * 2 * d * hidden
    got = chip_smoke.mlp_bounds(rows, d, hidden)
    assert got["fused_mlp"] == (4 * rows * d * hidden, 2 * act + w + 2 * (3 * d + hidden))
    assert got["fused_mlp_bwd"] == (4 * rows * d * hidden, 3 * act + 3 * 2 * rows * hidden + w
                                    + 2 * d + 4 * (3 * d + hidden))
    assert {"CrossViT small branch": 25_870_467_072, "CrossViT large branch": 3_422_552_064,
            "PatchMerger ViT after the merger": 4_294_967_296}[tag] == got["fused_mlp"][0]


def test_flash_bounds_at_t2t_true_width():
    """T2T's first token transformer, (64, 1, 3136, 3136) at its true head
    width 147 (the kernels compute at 192; the function's work is the same):
    370 GFLOP forward, 0.374 ms at 989 TFLOP/s; 925 GFLOP backward, 0.936
    ms; the tensor cores bound both."""
    got = chip_smoke.flash_bounds(64, 1, 3136, 3136, 147)
    pairs = 64 * 3136 * 3136
    assert got["flash_attention"][0] == pytest.approx(2 * pairs * 294 / 989e12 * 1e3)
    assert got["flash_attention"] == (pytest.approx(0.3742, abs=1e-4), "operations")
    assert got["flash_backward"] == (pytest.approx(0.9355, abs=1e-4), "operations")


def test_tp_bounds(raw):
    # One rank's slice: b 1, n 4, d 16, 2 local heads of 8 (inner 16), 32
    # local hidden units: 4 rows, one 4 x 4 x 8 product a head.
    rows, d, inner, hidden = 4, 16, 16, 32
    attn = 2 * 1 * 2 * 4 * 4 * 8                           # 512 FLOPs
    act, acc = 2 * rows * d, 4 * rows * d                  # bf16 (rows, d); its f32 sum
    qkv, out = 2 * rows * d * 3 * inner, 2 * rows * inner * d
    got = chip_smoke.tp_bounds(1, 4, 16, 2, 8, 32)
    # x, γ, β, Wqkv_r, Wo_r in; the f32 partial s out.
    assert got["fused_attention_block_split"] == (qkv + out + 2 * attn,
                                                  act + 4 * d + 2 * 4 * inner * d + acc)
    # dy·Wo_r, five products, dqkv·Wqkv_r; dy, qkv, oattn, lse, weights in; dqkv,
    # doattn and the f32 dxn out.
    assert got["fused_attention_block_split_bwd"] == (
        out + 5 * attn + qkv,
        act + 2 * (2 * rows * 3 * inner + 2 * rows * inner) + 4 * 2 * 4 + 2 * 4 * inner * d
        + acc)
    # fc1 and fc2: x, γ, β, W1_r, b1_r, W2_r in; s out.
    assert got["fused_mlp_split"] == (2 * 2 * rows * d * hidden,
                                      act + 4 * d + 2 * 2 * d * hidden + 2 * hidden + acc)
    # dy·W2_r and dh·W1_r: dy, h, W1_r, W2_r in; dh, gact, f32 db1 and dxn out.
    assert got["fused_mlp_split_bwd"] == (2 * 2 * rows * d * hidden,
                                          act + 3 * 2 * rows * hidden + 2 * 2 * d * hidden
                                          + 4 * hidden + acc)
    assert got["forward_gemm_f32"] == (out, 2 * rows * inner + 2 * d * inner + acc)
    assert got["forward_gemm_f32 (fc2)"] == (2 * rows * d * hidden,
                                             2 * rows * hidden + 2 * d * hidden + acc)
    assert got["bias_residual"] == (2 * rows * d, acc + 2 * act + 2 * d)
    # x, dy, f32 dxn, γ in; dx and the f32 [dγ | dβ | Σ dy] out.
    assert got["ln_bwd"][1] == 3 * act + acc + 2 * d + 4 * 3 * d


def test_tp_cross_bounds(raw):
    # One rank's slice: b 1, 8 queries of c 16, 2 local heads of 8 (hk 16), 4
    # keys: 8 rows, 64 (query, key) pairs over the heads.
    rows, c, hk, pairs, dh = 8, 16, 16, 64, 8
    q_gemm = out_gemm = 2 * rows * c * hk                  # xn·Wq_rᵀ, oattn·Wo_rᵀ
    qk_product = pv_product = 2 * pairs * dh
    act, acc, w, kv = 2 * rows * c, 4 * rows * c, 2 * 2 * c * hk, 2 * 2 * 4 * hk
    q = oattn = 2 * rows * hk
    got = chip_smoke.tp_cross_bounds(1, 8, 16, 2, 4, 8)
    # xn, Wq_r, k_r, v_r, Wo_r in; the f32 partial s out (serving keeps no oattn).
    assert got["fused_cross_attention_split"] == (q_gemm + out_gemm + qk_product + pv_product,
                                                  act + w + kv + acc)
    # dy·Wo_r, the five attention products, dq·Wq_r; dy, q, k_r, v_r, oattn, lse,
    # Wq_r, Wo_r in; the f32 dxn, dq, dk, dv and the f32 dbo out.
    lse = 4 * 2 * 8
    assert got["fused_cross_attention_split_bwd"] == (
        out_gemm + q_gemm + 3 * qk_product + 2 * pv_product,
        act + q + kv + oattn + lse + w + acc + q + kv + 4 * c)


@pytest.mark.parametrize("hb, dbias", [(1, True), (2, True), (1, False)],
                         ids=["shared", "per-head", "lsa"])
def test_tp_bias_bounds(raw, hb, dbias):
    # Row 5's split form at one rank's slice: b 1, n 4, d 16, 2 local heads of
    # 8 (inner 16), as test_tp_bounds; an f32 (hb, 4, 4) bias: the shared table
    # once (hb 1) or the local heads' (hb 2), read by both directions, dbias
    # written by the backward when asked.
    rows, d, inner = 4, 16, 16
    attn = 2 * 1 * 2 * 4 * 4 * 8
    act, acc = 2 * rows * d, 4 * rows * d
    qkv, out = 2 * rows * d * 3 * inner, 2 * rows * inner * d
    bias = 4 * hb * 4 * 4
    got = chip_smoke.tp_bounds(1, 4, 16, 2, 8, 32, hb, dbias)
    # x, γ, β, Wqkv_r, Wo_r, the bias in; the f32 partial s out.
    assert got["fused_attention_block_bias_split"] == (
        qkv + out + 2 * attn, act + 4 * d + 2 * 4 * inner * d + acc + bias)
    # dy, qkv, oattn, lse, weights, the bias in; dqkv, doattn, the f32 dxn and
    # (with dbias) the f32 dbias out.
    assert got["fused_attention_block_bias_split_bwd"] == (
        out + 5 * attn + qkv,
        act + 2 * (2 * rows * 3 * inner + 2 * rows * inner) + 4 * 2 * 4 + 2 * 4 * inner * d
        + acc + bias + (bias if dbias else 0))
    # The unbiased split forms are unchanged by a bias argument.
    assert got["fused_attention_block_split"] == chip_smoke.tp_bounds(1, 4, 16, 2, 8, 32)[
        "fused_attention_block_split"]


@pytest.mark.parametrize("tag,n,d", chip_smoke.DENSE_MLP_SHAPES)
def test_tp_mlp_bounds_at_the_dense_family_shapes(raw, tag, n, d):
    """Rows 1-2's split form at rank 0's slice of the dense family's MLPs
    (batch 64, 1024 of 2048 hidden units), as
    :func:`chip_smoke.tp_dense_kernel_phase` times it: half the unsplit
    GEMMs' FLOPs; x, γ, β, the local weights and b1 in, the f32 partial out;
    dy, h, the local weights in, dh, gact, the f32 db1 and dxn out."""
    rows, hidden = 64 * n, 1024
    act, acc, w = 2 * rows * d, 4 * rows * d, 2 * 2 * d * hidden
    got = chip_smoke.tp_bounds(64, n, d, 8, 64, hidden)
    assert got["fused_mlp_split"] == (4 * rows * d * hidden, act + 4 * d + w + 2 * hidden + acc)
    assert got["fused_mlp_split_bwd"] == (4 * rows * d * hidden,
                                          act + 3 * 2 * rows * hidden + w + 4 * hidden + acc)
    assert 2 * got["fused_mlp_split"][0] == chip_smoke.mlp_bounds(rows, d, 2048)["fused_mlp"][0]
