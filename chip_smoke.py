#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card,
and check them.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one line each (any failure raises and exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32 off
   for the plain versions and the f32 references.
2. build: compiles ``vit_tpu_torch/csrc`` with nvcc, one process per source
   (timed); then ptxas's registers, static shared memory and spills of each
   instance of the kernels built on wgmma and TMA (the flash forward, the
   flash backward's dq and dk/dv kernels, the short-attention forward and
   backward kernels, the wgmma GEMM of the blocks' and the hybrid layer's
   GEMMs).
3. forward GEMMs: the blocks' forward GEMMs (fc1 keeping h, fc2, QKV, the
   out-projection) at ViT-B/32's, ViT-B/16's and ScalableViT's four stage
   widths, on gemm_wgmma.cu's kernel and on linear.cu's, each against the
   plain GEMM, timed in turns: the measurement behind launch_forward_gemm's
   threshold.  Then kernels: each forward kernel against its plain PyTorch
   version (the attention block on the short route also against that
   route's own plain version) and twice bit for bit, at the ViT-B/16 @224
   shapes (b=64, n=197, d=768, 12 heads of 64, h=3072), bench.py's B/32
   (b=128, n=65, d=1024, 16 heads of 64, h=2048), the entry shapes (b=8)
   and the objectives' (b=64, 8 heads of 64, h=2048: MAE's encoder at n=16,
   d=1024, its decoder at n=64, d=512), bf16 inputs from a seeded generator; times of the kernel, its plain
   version and the plain modules (bf16 through PyTorch's own GEMMs) with CUDA
   events around runs of back-to-back calls.
4. training kernels, at the B/16 training shapes (b=64), the B/32 ones
   (b=128, n=65) and the objectives' two, from seeded bf16 inputs and
   cotangent: each training
   forward (the kernels that keep xn, h and xn, qkv, oattn, lse) against its
   plain version, output by output, twice bit for bit; then each backward
   kernel, fed those kept
   residuals, against its plain backward on them, output by output; times of
   the backward kernel, its plain version and PyTorch autograd through the
   plain bf16 modules for the same outputs, and of the kernel plus its dW
   GEMMs against autograd with the weight gradients.
5. serving: ViT-B/16 @224, random weights from a seed, bf16 via
   ``cast_params``, eval, ``inference_mode``; three requests of 64 NHWC
   images.  Each forward must launch each kernel ``depth`` times; logits must
   be finite, (64, 1000), and agree with the same weights under
   ``fused_attention="never", fused_mlp="never"`` in bf16 (the plain path)
   and in f32 (the reference): the kernel path must be as close to the f32
   reference as the plain bf16 path is (within 2x its largest logit error,
   and agreeing with its top-1 at least as often), and agree with the plain
   path on 99% of the top-1s that the plain path's bf16 noise cannot flip.
   Median forward times of both paths.
6. entry: the same at ViT-B/32 @256 (dim 1024, depth 6), batch 8.
7. training: ``make_train_step`` over ``ViT(..., compute_dtype=bf16)`` with
   f32 parameters and ``torch.optim.SGD(lr=1e-3)``, at bench.py's config
   (ViT-B/32 @256, dim 1024, depth 6, heads 16, mlp 2048, batch 128, labels
   ``arange(128) % 1000``) and at ViT-B/16 @224, batch 64.  The step-1
   gradients of the kernel path and of the plain bf16 path are held against
   an f32 model of the same weights; then four steps on one batch, each
   launching each of the four kernels ``depth`` times, with finite, falling
   losses; median step times of both paths.
8. biased kernels, at the small-dataset ViT's block (b=64, n=257, d=1024, 16
   heads of 64), bf16 inputs from a seeded generator, with (i) LSA's
   diagonal -f32.max bias and scale 1.0, (ii) a random (1, n, n) bias, (iii)
   a random (16, n, n) bias, on the short route: the serving and the
   training forward and the backward against their plain versions (the TPU
   kernel's rounding points and the route's own), output by output, dbias for
   (ii) and (iii) against both under its bound (:func:`check_dbias`) and
   twice, bit for bit; times of the kernel, the
   unbiased kernel on the same inputs, the plain version and the bf16
   modules with ``scaled_dot_product_attention`` (``attn_mask=bias``;
   autograd through them for the backward).
9. SPT: the small-dataset tokenizer's convolution form against its eager
   form, both bf16, and the f32 eager form, at 256 px, patch 16, dim 1024,
   batch 64; times of both.
10. small-dataset serving and training: phases 5 and 7 for
   ``vit_for_small_dataset.ViT`` at ``benchmarks/run_benchmarks.py``'s
   config (256/16, dim 1024, depth 6, heads 16, mlp 2048), batch 64: each
   forward launches the biased block and the MLP kernels ``depth`` times
   (each step their backwards too) and the unbiased block never.  Top-1
   against f32 is held to the plain path's up to chance (a sign test): the
   plain LSA keeps an exact f32 softmax that the kernel route does not.
   Each temperature's step-1 gradient is held to one bf16 unit of the
   terms it sums (:func:`check_temperatures`), at the phase's seed and a
   second one.
11. flash kernels, bf16 inputs from a seeded generator laid out as CvT hands
   them over (q a view of a channels-last (b, n, h·d) map, k and v views of
   the two halves of one (b, n, 2·h·d) projection), at CvT-13's shapes
   (64, 1, 3136 | 784, 64), (64, 1, 9216 | 2304, 64) and (64, 3, 2304 | 576,
   64), at (4, 16, 8192, 64) through ``scaled_dot_product_attention`` (vit_tpu's
   flash_attention_v2 tier) and at (64, 2, 4096, 32): out and lse against the
   plain version, dq/dk/dv against the plain backward fed the kernel's own out
   and lse, the backward twice bit for bit; times of the kernel, its plain
   version and PyTorch's ``scaled_dot_product_attention`` (autograd through it
   for the backward), and the bound.  Then, below the 1024 gate, at CvT's
   stage-2 and stage-3 shapes: the kernel against the dispatcher's plain path
   and SDPA, forward and backward.  Then T2T-ViT's token transformers'
   kernels (:func:`t2t_kernel_phase`): the flash kernels' (192, 192) instance
   at (64, 1, 3136, 3136) from 147-wide q, k, v zero-padded as the
   dispatcher pads them, and the fused MLP at d = hidden = 147 over 200,704
   rows and at 1323 over 50,176 (zero-padded weight copies), each against its
   plain version, twice bit for bit, timed beside SDPA or the bf16 modules,
   bounds at the true widths.
12. CvT-13 (``vit_tpu``'s CvT defaults, ``benchmarks/run_benchmarks.py:91``)
   serving at 224 and 384 px, batch 64, as phase 5 (its plain path is
   ``use_flash="never"``): the flash kernel launches once per forward at 224
   (stage 1) and three times at 384 (stages 1 and 2); and training at 224 and
   384, batch 64, as phase 7, the flash forward and backward launched 1 and 3
   times per step, BatchNorm's running statistics finite and updated.
13. cross-attention block (``fused_cross_attention``), at ScalableViT's four
   SSA shapes, batch 64 (4096 | 1024 | 256 | 64 queries of 64 | 128 | 256 |
   512 channels, 2 | 4 | 8 | 16 heads, 64 keys, q/k 40 wide and v 32 at
   stages 1-3, both 32 at stage 4: one ``cross_fwd`` launch, from 256
   channels with the y GEMM) and at ScalableViT@384's stage 1 (144 keys, batch
   16: the three-launch forward), seeded bf16 inputs: the serving and the
   training forward (y, q, oattn, lse) against the plain version, the
   backward (dxn, dq, dk, dv, dbo), fed the training forward's residuals, on
   the route its shape takes (one ``cross_bwd`` kernel and its reduction up
   to 128 channels, ``cross_bwd`` between two ``gemm_wgmma`` dgrads from 129,
   the four steps past 128 keys), against the plain backward and twice bit
   for bit, and at the ``cross_bwd`` shapes the other designs (the four
   steps; the split at stages 1-2) against theirs; times of the kernels, the
   other designs, the plain versions and F.linear + SDPA + F.linear
   (autograd through it), with and without the dW GEMMs, and the bounds; at
   the four SSA shapes the backward's device time launch by launch on its
   route and on the four steps.
14. packed flash (``flash_attention_packed``), channel-packed (b, n, heads·d)
   inputs at ScalableViT's IWSA windows (64, 4096, 2x32) and (64, 1024,
   4x32) and at dk 40, dv 32: out and lse against the plain version, the
   backward on the packed strides against the plain backward, twice bit for
   bit; times against SDPA on the head views, and the bounds.
15. ScalableViT (``benchmarks/run_benchmarks.py:140-144``: dim 64, heads 2 /
   4 / 8 / 16, depths 2 / 2 / 8 / 2, SSA keys 40 / 40 / 40 / 32, reductions
   8 / 4 / 2 / 1, windows 64 / 32 / whole / whole) at 256 px, batch 64:
   serving as phase 5 and training as phase 7, its plain path
   ``fused_attention="never", fused_mlp="never"``; each forward launches the
   cross-attention block 14 times, the packed flash op 4 times (the IWSA
   windows of 1024 tokens and more) and the fused MLP 28 times, each step
   their backwards as often (the cross-attention backward 4 times as one
   ``cross_bwd`` kernel, at stages 1-2, and 10 times split, at 3-4).
16. hybrid kernels (the short-sequence tier's ``ln_gemm``, ``attention_nb``
   and ``proj_mlp``) at ViT-B/32's layer, batch 128: each training forward
   against its plain version, chained as the layer chains them; each
   backward fed its forward's residuals against the plain backward, twice
   bit for bit; times beside the bf16 library compositions and the bounds.
17. short attention (explicit use only): its public op under autograd once
   (its path), then its kernels at SHORT_SHAPES against the plain versions,
   the backward twice bit for bit, timed beside SDPA and the flash kernels.
18. ViT-B/32 @256 with ``fused_attention="hybrid"``, serving (3 requests of
   128) and training (batch 128) as phases 5 and 7: 6 launches each of
   ``ln_gemm``, ``attention_nb`` and ``proj_mlp`` per forward, of their
   backwards per step, none of the block kernels; then the two B/32 tiers'
   step times side by side.
19. the blocks past 512 tokens, on the mha route (the flash kernels,
   biased instances included, and mha_dbias): first its path, every counter
   from 0, the unbiased block at
   ViT-B/16@384's shape and the biased one at the small-dataset ViT's at 384
   px (577 tokens, batch 16, a learned per-head bias, so dbias too) under
   autograd, forward and backward once; then phases 3, 4 and 8 at those
   shapes (LSA's mask, a shared and a per-head bias), each route counter
   checked, and the unbiased block beside F.layer_norm + F.linear + SDPA +
   F.linear (:func:`block_library_phase`); then the biased block at 197
   tokens (LSA's mask, batch 64) timed
   on both routes, forward and backward: the evidence for the 512-token
   threshold with a bias.
20. the training objectives (``benchmarks/run_benchmarks.py:105-128``, the
   encoder a ViT at 256 px, patch 32, dim 1024, depth 6, 8 heads of 64, mlp
   2048; batch 64): MAE (decoder 512 wide, depth 6, ratio 0.75), SimMIM
   (ratio 0.5), MPP (patch 32, its defaults, pixels in [0, 1)) and DeiT
   distillation (a ViT teacher and a DistillableViT student of that shape,
   soft, T = 1, alpha 0.5), each trained as phase 7 trains a classifier but
   through ``make_loss_train_step`` with AdamW(1e-5), on one fixed batch and
   one fixed mask draw (a generator of one seed at every step): rows 1-4 at
   every block of the encoder (and of MAE's decoder) each way per step, the
   teacher's forward on the serving kernels (rows 1 and 3 only).  Then
   T2T-ViT@224 (``benchmarks/run_benchmarks.py:55-56``: dim 512, depth 5,
   8 heads of 64, mlp 512), batch 64: serving as phase 5, training as phase
   7 (SGD(1e-3)), and DeiT distillation over a T2T-ViT teacher and a
   DistillableT2TViT student as the objectives train; a forward launches the
   flash forward once (the first token transformer: 3136 tokens, one head of
   147 padded to 192; the second's 784 tokens take the plain path), the
   fused MLP 7 times (147, 1323 and the encoder's 512) and the block 5 times,
   a step each backward as often; the plain path is every Transformer on
   ``"never"``, the token attention included.
21. Twins-SVT (``benchmarks/run_benchmarks.py:65``, ``TwinsSVT(num_classes=
   1000)``: widths 64/128/256/512, depths 1/1/5/4 after a one-block
   pre-transformer a stage, 8 heads of 64, 7 x 7 windows, global k 7) at 224
   px, batch 64.  First its kernels (:func:`twins_kernel_phase`): the fused
   MLP at each stage's rows and widths, the attention block over the folded
   windows (4096 | 1024 | 256 groups of 49 tokens, 64 | 128 | 256 channels,
   eps 1e-5) and the cross-attention block at the four global attentions
   (64, 16, 4 and 1 keys), as phases 3, 4 and 13 hold them, each route
   printed; the library convolutions of its attentions timed beside them
   (:func:`twins_conv_phase`).  Then serving as phase 5 and training as phase 7, its plain path
   ``fused_attention="never", fused_mlp="never"``: a forward launches the
   fused MLP 25 times, the block 10 times and the cross-attention block 15,
   a step each backward as often (the cross-attention backward split, past
   heads·dh_k 256, at all 15).
22. CrossFormer (``benchmarks/run_benchmarks.py:66``, ``CrossFormer(
   num_classes=1000)``: dims 64/128/256/512, depths 2/2/8/2, global windows
   8/4/2/1, local 7, heads of 32) at 224 px, batch 64.  First its kernels
   (:func:`crossformer_kernel_phase`): the biased block at its six window
   shapes (short 7 x 7 at each stage, long 8 x 8 and 4 x 4 at stages 1-2;
   a shared f32 bias asking for dbias, eps 1e-5) as phase 8 holds it; the
   position bias and the folds launch by launch; the stem's two merged forms
   and the separate convolutions on cuDNN.  Then serving as phase 5 and
   training as phase 7 (plain path ``"never"``, top-1 by the sign test): a
   forward launches the biased block 18 times (stages 3-4's long windows of
   4 and 1 tokens run plain, vit_tpu's n < 8 gate) and the fused MLP 28, a
   step their backwards as often, dbias at each; the DPB tensors' step-1
   gradients held stacked across the attentions (:func:`stacked_groups`),
   and the same check on a control path with only the MLPs on the kernels.
23. RegionViT (``benchmarks/run_benchmarks.py:79-82``, ``RegionViT(
   num_classes=1000)``: dims 64/128/256/512, depths 2/2/8/2, window 7, local
   patch 4, 4 heads of 32) at 224 px, batch 64.  First its kernels
   (:func:`regionvit_kernel_phase`): the block at its four region
   self-attentions (64 groups of 64, 16, 4 and 1 tokens) as phases 3 and 4
   hold it, the one-key block's dq and dk held to 0 exactly; the biased
   block at its four joint attentions (4096 | 1024 | 256 | 64 windows of 50
   tokens, a per-head (4, 50, 50) bias asking for dbias) as phase 8 holds
   it.  Then serving as phase 5 and training as phase 7 (plain path
   ``"never"``, top-1 by the sign test): a forward launches the block 14
   times and the biased block 14 (both attentions of each layer; its MLPs
   plain, as in vit_tpu), a step their backwards as often, dbias at each;
   the position tables' step-1 errors printed.
24. NesT (``benchmarks/run_benchmarks.py:59-61``: 224 px, patch 4, dim 96,
   heads 3, 3 hierarchies, block repeats (2, 2, 8), mlp_mult 4) at batch
   64.  First its kernels (:func:`nest_kernel_phase`): the fused MLP and the
   block over the folded 14 x 14 blocks (1024 | 256 | 64 groups of 196
   tokens, 96 | 192 | 384 channels, heads of 32, eps 1e-5: the unbiased
   208-key ``short_fwd`` and ``short_bwd_wg`` at dh 32) as phases 3 and 4
   hold them.  Then serving as phase 5 and training as phase 7 (plain path
   ``"never"`` for both, top-1 by the sign test): a forward launches the
   block and the fused MLP 12 times each, a step their backwards as often.
25. PiT (``benchmarks/run_benchmarks.py:57-58``: 224 px, patch 14 at stride
   7, dim 256, depth (3, 3, 3), 16 heads of 64, mlp 2048) at batch 64.
   First its kernels (:func:`pit_kernel_phase`): the fused MLP and the block
   at its three stages (962 tokens at d 256 on the block's mha route, 257 at
   512 and 65 at 1024 on its short route; eps 1e-3) as phases 3 and 4 hold
   them, then stage 1's block forward and backward timed beside F.layer_norm
   + F.linear + SDPA + F.linear (autograd through it) and its bounds
   (:func:`block_library_phase`), and its cuDNN convolutions (the patch
   embedding and the pools', :func:`pit_conv_phase`) timed with their
   backward kernels by name.  Then serving as phase 5 and training as phase
   7 (plain path ``"never"``): a forward launches the block and the fused
   MLP 9 times each, 3 of the block's on the mha route, a step their
   backwards as often.
26. LeViT (``benchmarks/run_benchmarks.py:62-64``: 224 px, dims (256, 384,
   512), depth 4, heads (4, 6, 8), mlp_mult 2, dim_key 32, dim_value 64) and
   MobileViT (``:68-71``: 256 px, dims (96, 120, 144), channels (16, 32, 48,
   48, 64, 64, 80, 80, 96, 96, 384), depths (2, 4, 3)), batch 64, which
   ``vit_tpu`` runs on no Pallas kernel.  First their library convolutions
   (:func:`plain_conv_phase`: LeViT's stem, MobileViT's depthwise ones)
   timed with their backward kernels by name.  Then each served
   (:func:`plain_serving_phase`) and trained (:func:`plain_training_phase`,
   SGD(1e-3)) with every BatchNorm seeded nonzero (LeViT's ``to_out_bn``
   starts at γ = 0; seeded in [0.1, 0.3], :func:`seed_batch_norms`) and
   every kernel counter at 0; there is no plain path apart from the model
   itself, so the bf16 path is held against the f32 model of the same
   weights: logits within 0.1·max|f32|, the first loss within 1e-2, each
   step-1 gradient's error printed beside the f32 model's own sensitivity
   to inputs moved by 1e-3, falling losses, the running statistics moved;
   times and peak memory.
27. The dense-token family at ``benchmarks/run_benchmarks.py``'s configs,
   batch 64 (:337): DeepViT (``:49-51``: 256/32, dim 1024, depth 6, 16
   heads, mlp 2048), the ViT with a PatchMerger (``:152-155``: 256/16, dim
   1024, depth 12, 8 heads, merged to 8 tokens after layer 6), CrossViT
   (``:72-76``: 256 px, branches of 192 (patch 16) and 384 (patch 64), encoder
   depths 2 and 3, 4 rounds, dropout 0), CaiT (``:52-54``: 256/32, dim 1024,
   depth 12, cls_depth 2, 16 heads) and Parallel ViT (``:98-101``: 256/32,
   dim 1024, depth 6, 8 heads, 2 branches).  First rows 1–2 at the new
   shapes (:func:`dense_kernel_phase`: CrossViT's two encoders, d 192 over
   64·257 rows and d 384 over 64·17, the merger's 64·8 rows at d 1024, mlp
   2048), as phases 3–4 hold them.  Then DeepViT, the patch merger's ViT and
   CrossViT served and trained as phases 5 and 7 (a forward launches the
   fused MLP 6, 12 and 20 times, a step its backward as often, every other
   kernel 0; plain path ``fused_mlp="never"``, CrossViT's encoders through
   :func:`plain_modules`; top-1 by the sign test: both paths share every
   attention), CaiT and Parallel ViT, which ``vit_tpu`` runs on no Pallas
   kernel, as phase 26 (no BatchNorm to seed).
28. ATS-ViT (``benchmarks/run_benchmarks.py:145-148``: 256/16, dim 1024,
   depth 6, tokens (256, 128, 64, 32, 16, 8), 16 heads of 64, mlp 2048) and
   CCT-14 (``:136-139``: 224 px, embedding 384, 2 conv layers of 7 x 7 at
   stride 2, 14 layers, 6 heads, mlp_ratio 3, learned positions, attention
   dropout and stochastic depth 0.1), batch 64.  First rows 1–2 at two of
   ATS-ViT's token counts (:func:`dense_kernel_phase` over ATS_MLP_SHAPES:
   64·129 and 64·9 rows at d 1024), as phases 3–4 hold them.  Then ATS-ViT
   served and trained as phases 5 and 7 with ``fused_mlp="auto"`` (a forward
   launches the fused MLP 6 times, at 257, 129, 65, 33, 17 and 9 tokens, a
   step its backward as often) against ``vit_tpu``'s default
   ``fused_mlp="never"`` (every counter 0), every model on the same Gumbel
   draws, with the share of sampled ids on which the kernel path, the plain
   path and the f32 model agree at each sampling layer
   (:func:`ats_agreement`); CCT-14 as phase 26, every counter 0, the bf16
   and the f32 model on the same dropout and stochastic-depth masks.
29. profile: ``torch.profiler`` over train steps at twenty-seven training
   configs (B/32 on both tiers, B/16, the small-dataset ViT, CvT-13 at 224
   and 384, ScalableViT, the four objectives, T2T-ViT, Twins-SVT,
   CrossFormer, RegionViT, NesT, PiT, LeViT, MobileViT, DeepViT, the patch
   merger's ViT, CrossViT, CaiT, Parallel ViT, ATS-ViT, CCT-14); device time and launches per
   step by kernel group (the LayerNorm-backward dgrad's launches counted by
   the library where it launches them, ``vit_take_launch_count``),
   idle share, the host's enqueue time per step and the synchronising calls
   in a step.
30. data-parallel (:func:`data_parallel_phase`): ViT-B/32@256 (bench.py),
   bf16 compute, f32 parameters, batch 128, SGD(1e-3, momentum 0.9), on a
   one-rank NCCL group (``initialize_distributed`` from a launcher's
   environment on a free localhost port, ``make_mesh()``): 3 steps of
   ``make_train_step(..., mesh=mesh)`` fed by ``prefetch(ThreadedLoader,
   device_put=shard_batch)`` from host numpy against the bare step's 3 fed by
   synchronous copies, from the same weights: parameters and losses bit for
   bit, rows 1-4 six times each a step.  Then checkpoint and resume
   (``CheckpointManager.save(wait=False)``, one more step, ``wait()``, a
   fresh model and optimizer restored take that step too: bit for bit; save,
   write and restore seconds, bytes on disk); step ms with and without the
   mesh; the prefetched feed against synchronous copies (wall ms a step and
   the profile's idle share); ``op_breakdown`` of the data-parallel step's
   trace beside ``launch_breakdown`` of the bare step.  The group is
   destroyed at the end.
31. export (:func:`export_phase`): ``export_forward`` / ``load_forward`` of
   the entry ViT-B/32@256 at batch 8 (rows 1 and 3; both layouts), the
   hybrid ViT at batch 128 (rows 12-14: the tier's gate needs b >= 64), the
   small-dataset ViT (row 5), CvT-13@224 (row 7) and ScalableViT@256 (rows
   6 and 10) at batch 8, baked, and one-op modules of ``short_attention`` at
   (64, 12, 197, 197, 64) (row 11) and of the flash op at its streamed shape
   (4, 16, 8192, 8192, 64) (row 9): the loaded output bit for bit eager's,
   each op in the graph as often as the eager forward launches it, the
   loaded forward moving every counter as the eager one; export and load
   seconds, the loaded forward's ms beside eager's.
32. the example trainer (:func:`example_phase`):
   ``examples/train_classifier_torch.py --model vit --steps 20 --batch 64
   --bf16`` as a subprocess with a checkpoint directory and an artifact:
   exit 0, finite losses, a checkpoint at step 20, an artifact that serves.
33. tensor-parallel kernels (:func:`tp_kernel_phase`, after the hybrid
   kernels): rows 1-4's split forms at one rank's slice of bench.py's B/32
   over TP = 2 ranks (8 heads of 64, 1024 hidden units): the f32-partial
   forward GEMM on both GEMM kernels, the bias-residual pass, both blocks'
   partial forwards and backwards and the LayerNorm-backward entry, each
   against its plain version and twice bit for bit; the two ranks' partials
   summed and ended by the pass or the LayerNorm backward against the
   unsplit kernels' y, dx and sums; times beside the plain versions, the
   composition at 8 heads, the bounds and the unsplit kernels.  Then
   (:func:`tp_twins_kernel_phase`) row 6's split form at rank 0's slice of
   Twins-SVT@224's global attentions at stages 1 and 3 (4 of 8 heads of 64),
   forward and backward against the plain versions, twice bit for bit, the
   two ranks emulated against the unsplit kernels, timed beside F.linear +
   SDPA + F.linear at 4 heads and :func:`tp_cross_bounds`; and rows 1-4's
   split forms at Twins-SVT's stage-1 local attention and conv-MLP.  Then
   (:func:`tp_biased_kernel_phase`) row 5's split form at rank 0's slice of
   the small-dataset ViT@256's block (LSA's mask), CrossFormer@224's
   stage-1 short windows (the shared table, dbias) and RegionViT@224's
   stage-1 joint rows (the per-head table, dbias): forward and backward
   against the plain versions, twice bit for bit, the two ranks emulated
   against the unsplit row 5 (y, dxn, dx, sums, dbias), timed beside
   F.layer_norm + F.linear + SDPA(attn_mask) + F.linear at the local heads,
   the unsplit kernel and :func:`tp_bounds`.  Then
   (:func:`tp_dense_kernel_phase`) rows 1-2's split form at the dense
   family's MLPs, and (:func:`tp_scalable_kernel_phase`) row 10, the packed
   flash op, over rank 0's heads at ScalableViT's IWSA stages 1-2 (one of 2
   heads over 4096 tokens, 2 of 4 over 1024) and row 6's split form at its
   SSA stages 1 and 3 ((40, 32), 64 keys): each against its plain version,
   twice bit for bit, the two ranks' heads concatenated or summed against
   the unsplit kernels, timed beside SDPA (or F.linear + SDPA + F.linear)
   at the local heads, the unsplit kernels and the bounds.
34. tensor-parallel (:func:`tp_path_phase`, after phase 30): ViT-B/32
   split over a (1, 2) mesh, two processes on the one card over gloo, from
   the bare step's weights: serving 3 x 128 images and 3 training steps,
   rows 1-4 on their split forms 6 times each way a step on each rank; the
   logits held by the serving check, the gathered step-1 gradients against
   the plain bf16 path's error, the losses; the step and its collectives
   timed (two processes time-sharing one card: not a TP speed).  Then
   (:func:`tp_hybrid_phase`, one more spawn of two processes for all of
   TP_TABLES) Twins-SVT@224
   on the kernel route (row 6's split form 15 times a forward a rank, rows
   3-4's 10, rows 1-2's 25, the unsplit ones never) and CvT-13@224,
   LeViT@224 and MobileViT@256 on the plain modules: each serves 64 images
   and trains 2 steps (batch 64 for Twins-SVT, 16 for the others), the
   ranks' logits and losses bit for bit, the logits by the serving check,
   the first loss against the one-process path's, the gathered step-1
   gradients against the plain bf16 path's error.  Then (TP_BIASED) the
   small-dataset ViT@256, CrossFormer@224,
   RegionViT@224 and NesT@224 on the kernel route (row 5's split form at
   their biased blocks, rows 3-4's and 1-2's at the others, NesT's
   three-head hierarchy whole, the unsplit row 5 never), each serving 64
   images and training 2 steps at batch 16, held as above, LSA's
   temperatures by their terms.  Then over TP_DENSE (DeepViT, the patch
   merger's ViT and CrossViT on rows 1-2's split form, CaiT and Parallel ViT
   plain) and TP_REST: ATS-ViT@256 (rows 1-2's split form, its first loss
   held over the images whose sampled sets agree on both paths), CCT-14@224
   (plain, one fixed dropout draw), ScalableViT@256 (row 6's split form at
   its 14 SSAs, row 10 over the local heads at its 4 IWSAs, rows 1-2's at its
   28 conv-MLPs) and T2T-ViT@224 (its token transformers whole on the
   unsplit flash kernels and rows 1-2, its encoder on rows 1-4's split
   forms), held as above.

Each main path (short attention; serving B/16, B/32, small-dataset, B/32
hybrid, CvT-13 @224 and @384, ScalableViT, T2T-ViT, Twins-SVT; training
B/32, B/32 hybrid, B/16, small-dataset, CvT-13 @224 and @384, ScalableViT,
MAE, SimMIM, MPP, distillation, T2T-ViT, T2T distillation, Twins-SVT,
CrossFormer, RegionViT, NesT, PiT, LeViT, MobileViT, DeepViT, the patch
merger's ViT, CrossViT, CaiT, Parallel ViT, ATS-ViT, CCT-14 (serving and
training); the blocks past 512 tokens; the data-parallel B/32 step; the
exported programs' forwards; the tensor-parallel path, its ranks'
serving and training runs of B/32, Twins-SVT, CvT-13, LeViT, MobileViT,
the small-dataset ViT, CrossFormer, RegionViT, NesT, DeepViT, the patch
merger's ViT, CrossViT, CaiT, Parallel ViT, ATS-ViT, CCT-14, ScalableViT
and T2T-ViT, each from 0)
runs with every kernel's launch
counter set to 0 just before it and
read just after, and each counter must move on one of them; the attention
block's routes are counted each way (short_fwd / short_bwd on the ViTs'
blocks, the small-dataset ViT's biased one too; the flash kernels past 512
tokens: PiT's stage 1); LeViT's, MobileViT's, CaiT's, Parallel ViT's and
CCT-14's paths must launch none, and so must ATS-ViT's plain path.  A model
whose forward takes a generator (ATS-ViT, CCT, CaiT) gets one reseeded to
the phase's seed at every call (:func:`draws`), the kernel path, the plain
path and the f32 model alike: one fixed draw of noise and masks.
The line before the last is the card as ``nvidia-smi`` names it; before that
the dense family's and ATS-ViT's rows 1-2 at their shapes, PiT's rows 1-4 at its stages (stage 1's block beside the library composition),
NesT's (with ptxas's registers and spills of its two dh-32 instances),
RegionViT's, CrossFormer's and Twins-SVT's kernel times at their shapes
beside the card's name and power limit; before that a JSON line with each kernel's launches (over the main paths, and per path),
error, times and bound (the kernels rebuilt on wgmma and TMA also name their
``design``), after a line that cites the earlier designs' times from PERF.md,
constants that this run did not measure.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

B16 = dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12,
           heads=12, mlp_dim=3072)
ENTRY = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6,
             heads=16, mlp_dim=2048)
# vit_for_small_dataset.ViT as benchmarks/run_benchmarks.py:149-151 ran it: n=257.
SMALL_DATASET = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6,
                     heads=16, mlp_dim=2048)
# CvT-13, vit_tpu's CvT defaults, as benchmarks/run_benchmarks.py:91 builds
# it; served and trained at 224 px (the JAX package's config) and at 384 px
# (the CvT paper's CvT-13↑384 fine-tuning resolution).
CVT13 = dict(num_classes=1000)
# The training objectives' encoder (BASELINE.md workload 5,
# benchmarks/run_benchmarks.py:105-128): a ViT at 256 px, patch 32, dim 1024,
# depth 6, 8 heads of 64 (inner 512 in a 1024-wide model), mlp 2048; the
# objectives trained at its batch 64 (run_benchmarks.py:337).
OBJ_ENCODER = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=8,
                   mlp_dim=2048)
OBJECTIVE_BATCH = 64
# The objectives train with AdamW (the optimizer of the MAE, SimMIM and DeiT
# recipes).  SGD at 1e-3 moves SimMIM's weights, whose loss keeps the
# reference's extra 1/num_masked, by parts in 1e8 a step: below a bf16 unit,
# so the bf16 weights and the loss would not move at all.  AdamW moves each
# weight by about lr a step, whatever its gradient's scale: at 1e-4 MPP's
# loss on one batch went 9.47, 3.58, 8.02, 11.45 (its logits come from the
# encoder's last residual stream, 1024 wide, with no LayerNorm before
# to_bits); at 1e-5 a step still moves a weight by a twelfth of a bf16 unit
# at |w| 0.03, which the f32 master weights carry to the bf16 ones as a
# fraction of weights that step by one unit.
OBJECTIVE_LR = 1e-5
# Kernel against its plain version on the same bf16 inputs, for a residual
# block y = T(x + T(f(x))): both round at the same points and differ by f32
# summation order, which can flip a rounding of an intermediate by one bf16
# unit.  So each element may differ by one bf16 unit of y (the final add,
# where the residual x ~ N(0, 1) makes a unit up to 0.03) plus 2e-2 of the
# block's own output max|ref - x| (a few bf16 units of f(x)).
KERNEL_REL_TOL = 2e-2
# Kernel path against the plain module path through the whole model: the
# plain path rounds elsewhere (fc1 output before GELU, bf16-stored softmax
# logits and probabilities), and the differences compound over depth; a
# tenth of the largest logit still catches a wrong kernel, which gives
# errors of the order of the logits themselves.
LOGIT_REL_TOL = 1e-1
# Against the f32 reference (the same bf16 weights, plain path, in f32) the
# kernel path may deviate at most this many times as far as the plain bf16
# path does, and must agree with it on top-1 at least as often as it.  Top-1
# against the plain bf16 path over all images is printed, not held to a
# fixed share:
# with random weights the 1000 logits' top-2 margin (median 0.079 at B/16) is
# of the order of the bf16 noise of either path (max 0.04 against f32), and
# the plain bf16 path itself agrees with its f32 version on only 93% of top-1s
# (measured on an H100 80GB HBM3 at a 700 W limit).  It is held to
# TOP1_CONFIDENT over the confident images: those whose f32 top-2 margin is
# above twice the plain bf16 path's largest logit error, which that path's
# noise cannot flip.
MAX_ERR_VS_PLAIN_BF16 = 2.0
TOP1_CONFIDENT = 0.99
# Where the plain path is not less precise than the kernel path (the
# small-dataset ViT, whose plain LSA keeps an exact f32 softmax that the
# kernel route, like vit_tpu's, does not; Twins-SVT, whose plain attentions,
# vit_tpu's einsums, keep f32 logits and softmax as the kernels do, where the
# other models' plain attention stores bf16 logits), top-1 against f32 is
# held by a sign test instead: over the images where exactly one of the two
# paths agrees with f32's top-1, each is as likely to be that one when the
# two are equally accurate, so plain_only - kernel_only <= 2.33·sqrt(
# plain_only + kernel_only) holds with 99 % probability; "at least as often"
# would fail on a one-image coin flip half the time there.  On its random
# weights (median f32 top-2 margin 0.045) the small-dataset ViT's kernel path
# agreed with f32 on 91.1 % of 192 images, the plain path on 93.2 %;
# Twins-SVT's on 186 and 187 of 192, with kernel/plain agreement 1.0 over
# the 154 images its noise cannot flip (H100 80GB HBM3, 700 W).
SIGN_TEST_Z = 2.33
# Training: at step 1, each parameter's gradient on the kernel path may be at
# most this many times as far (relative L2) from the f32 model's as the plain
# bf16 path's is; the two paths' first losses agree within LOSS_REL_TOL.
MAX_GRAD_ERR_VS_PLAIN_BF16 = 2.0
LOSS_REL_TOL = 1e-2
# Each tensor is held on its own, except the 0-d ones (LSA's one temperature
# per layer): they are held as one (depth,) vector, the stack of them across
# layers, and each on its own by check_temperatures; and CrossFormer's dynamic
# position bias (``.dpb.``), each of its 14 tensors held as the stack of that
# tensor across the 28 attentions (stacked_groups).  The DPB's gradient comes
# from dbias, a sum over every (window, head) pair of the layer that nearly
# cancels, so each one's error against f32 is bf16 noise of a few per cent
# on any bf16 path, and one path's against another's is a coin flip: at
# batch 64 the per-tensor check failed on 21 of the 392 DPB tensors with the
# kernels, their median error the plain path's (0.0384 and 0.0384), and it
# fails the same way on a path that shares no attention kernel with it
# (crossformer_mlp_kernels: the control line); the out.bias gradients,
# exactly 0 by the softmax's shift invariance (f32: about 1e-9), are bf16
# rounding on every path (H100 80GB HBM3, 700 W; PERF.md §6).  Stacked,
# each path's error is held to the same 2x of the plain path's; the
# per-tensor ratios are printed.
# A temperature's gradient is Σ dWq⊙Wq over the q-third of to_qkv (rows
# [:inner]), a sum of 1M products that nearly cancels in some layers, so its
# relative error can be of any size on a bf16 route: 0.75 on the kernel route
# against the plain path's 0.038 in one layer of six, where the f32 gradient
# was 1/20 of the others' (H100 80GB HBM3, 700 W).  So each temperature's
# error is held to TEMPERATURE_TERMS_TOL·Σ|dWq⊙Wq| (the f32 model's dWq):
# one bf16 unit of every term, all rounded the same way.  A fold that loses
# the exp(temperature) factor or the q-third's gradient misses it in every
# layer whose gradient is not itself below that bound.
TEMPERATURE_TERMS_TOL = 2.0 ** -8
# dbias (f32) against its plain version: both sum the same f32 terms
# p·(dp - dsum), from the same bf16 inputs, in another order, over the images
# (and the heads); the only rounding that can differ is that of doattn =
# T(dy·Wo), where a flip moves one term by a few parts in 1e4.  1e-3 of
# max|ref| leaves a wide margin over that and still catches a bias missing
# from one of the recomputed softmaxes, which moves dbias by the order of
# max|ref|.
DBIAS_REL_TOL = 1e-3
# Flash kernel against its plain version on the same bf16 inputs: both round
# P (and in the backward ds and p) to bf16, the kernel against its key tile's
# running max, the plain version against the row's max, and they sum in
# another order, so a rounding of a P element may differ by one unit.  Summed
# over hundreds of keys with random signs, that stays a few bf16 units of the
# output: each element of out, dq, dk and dv may differ by one unit of its
# dtype plus KERNEL_REL_TOL·max|ref| (check_outputs with no residual).  A
# kernel that drops the ragged-key mask, the running rescale or the scale
# misses that, or LSE_ABS_TOL: lse is f32 on both sides, from the same bf16
# products, and differs only by f32 summation order (1e-6); a key past n_k
# left in the sum moves it by 1e-2 and more.
LSE_ABS_TOL = 1e-3
TRAIN_STEPS = 4
# The H100 SXM's dense bf16 tensor-core peak and memory rate (NVIDIA's data
# sheet, at the full 700 W), for each kernel's bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


WALL = {}  # wall seconds of each phase of main(), printed before the kernels' line
STEP_MS = {}  # median step ms of each training path: {tag: {"kernels": ms, "plain": ms}}


@contextlib.contextmanager
def clock(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        WALL[label] = round(time.perf_counter() - t0, 2)


def interleaved_medians(torch, fns: dict, rounds: int, calls: int, warmup: int = 3) -> dict:
    """Median device ms per call of each fn: CUDA events around ``calls``
    back-to-back calls, so the host's enqueue overlaps the device; ``rounds``
    rounds taken in turns, so that clock drift hits every fn alike, after
    ``warmup`` calls of each."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            samples[k].append(start.elapsed_time(end) / calls)
    return {k: statistics.median(v) for k, v in samples.items()}


def launch_breakdown(torch, fn, calls: int = 5, group=None) -> dict | None:
    """The device kernels one call of ``fn`` launches, by ``group`` (a
    function of the kernel's name; :func:`kernel_group` by default):
    ``{group: (device ms a call, launches a call)}``, from torch.profiler
    over ``calls`` calls after one of warm-up, for the times only (the checks
    count launches with :func:`counted_launches` and the wrappers' counters).
    A session can drop the records of the kernels launched as its tracing
    starts (on an H100: none recorded, 1 of 5 launches of a kernel, the first
    kernel of the window), so each session opens with a warm-up step whose
    records it throws away (the profiler's schedule), and its recorded window
    with four of ``torch.cuda._sleep``'s spin kernels and 20 ms on the host,
    all left out, before the ``calls`` calls.  ``fn`` launches the same
    kernels at every call, so a session in which a kernel's launches are not
    a multiple of ``calls``, or with no device activity at all, still dropped
    records: it is taken again, up to five times, and after five such
    sessions the times are not measured (None)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in evt.key]
        if events and all(evt.count % calls == 0 for evt in events):
            break
    else:
        return None
    rows, group = {}, group or kernel_group
    for evt in events:
        ms, count = rows.get(group(evt.key), (0.0, 0.0))
        rows[group(evt.key)] = (ms + evt.self_device_time_total / 1e3 / calls,
                                count + evt.count / calls)
    return rows


def breakdown_text(rows: dict | None) -> str:
    """A :func:`launch_breakdown` launch by launch, for the log."""
    if rows is None:
        return "not measured (the profiler dropped device records in five sessions)"
    return "; ".join(f"{g} x{cnt:g} {ms:.4f}" for g, (ms, cnt) in rows.items())


def ln_device_text(device, rows) -> str:
    """A backward's device ms a call and its LayerNorm-backward dgrad's, from
    :func:`check_ln_epilogue`, for the log."""
    if rows is None:
        return f"device ms {breakdown_text(rows)}"
    return (f"device ms a call {device:.4f}, of it the LayerNorm-backward dgrad "
            f"{rows.get(LN_EPILOGUE, (0.0, 0))[0]:.4f}")


# csrc/kernels.cuh Counted: the launches the library counts on the host where
# it makes them (vit_take_launch_count).
COUNTED = {"gemm_wgmma": 0, "ln_epilogue": 1, "ln_passes": 2, "linear": 3}


def counted_launches(torch, fn) -> dict:
    """The launches one call of ``fn`` makes of each kind in COUNTED, as the
    library counts them where it launches them: gemm_wgmma.cu's kernel (every
    epilogue), its LayerNorm-backward instance, layernorm.cu's backward
    passes (one a call of them) and linear.cu's GEMM."""
    from vit_tpu_torch.ops import _build

    lib = _build.load()
    torch.cuda.synchronize()
    for which in COUNTED.values():
        lib.vit_take_launch_count(which)
    fn()
    torch.cuda.synchronize()
    return {name: lib.vit_take_launch_count(which) for name, which in COUNTED.items()}


def check_ln_epilogue(torch, name, fn, linear=True):
    """A backward whose LayerNorm backward is the dgrad's epilogue
    (``gemm_wgmma.cu``'s kEpiLnBwd, at the widths of ``ln_bwd_fused``): raises
    unless one call of ``fn`` launches that instance once and
    ``layernorm.cu``'s backward passes never, nor, unless ``linear``,
    ``linear.cu``'s GEMM (:func:`counted_launches`).  Returns the call's
    counts, its :func:`launch_breakdown` and its device ms (None where not
    measured)."""
    counts = counted_launches(torch, fn)
    if counts["ln_epilogue"] != 1 or counts["ln_passes"] or (not linear and counts["linear"]):
        raise AssertionError(f"{name}: launches a call {counts}: one of the LayerNorm-backward "
                             f"dgrad, none of the LayerNorm backward's passes"
                             + ("" if linear else " and none of linear.cu") + " expected")
    rows = launch_breakdown(torch, fn)
    return counts, rows, None if rows is None else sum(ms for ms, _ in rows.values())


def check_ln_backward(torch, name, fn, d):
    """A block backward's LayerNorm backward at width ``d``: the dgrad's
    epilogue where ``ln_bwd_fused(d)`` holds (no f32 dxn, no layernorm.cu
    passes: :func:`check_ln_epilogue`), else the f32 dxn and one run of
    layernorm.cu's passes a call; raises unless one call of ``fn`` launches
    the one that applies.  Returns its :func:`launch_breakdown`, its device
    ms (None where not measured) and a text for the log."""
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.ops._shared import ln_bwd_fused

    if ln_bwd_fused(d):
        _, rows, device = check_ln_epilogue(torch, name, fn)
        return rows, device, (ln_device_text(device, rows) + f" on "
                              f"{_build.load().vit_ln_bwd_clusters(d)} clusters of {d // 256} "
                              f"CTAs, counted once a call (no {' or '.join(LN_PASSES)})")
    counts = counted_launches(torch, fn)
    if counts["ln_epilogue"] or counts["ln_passes"] != 1:
        raise AssertionError(f"{name}: launches a call {counts}: the LayerNorm backward's "
                             f"passes once, its dgrad epilogue never, expected at d {d}")
    rows = launch_breakdown(torch, fn)
    return rows, None if rows is None else sum(ms for ms, _ in rows.values()), (
        f"device ms a call {breakdown_text(rows)}; the LayerNorm backward on layernorm.cu's "
        f"passes, counted once a call (d {d}: no LN-backward dgrad)")


def ln_library(torch, dxn32, x, gamma, eps):
    """One ``torch.ops.aten.native_layer_norm_backward`` over the f32 dxn
    ``(rows, d)`` with x and gamma in f32: PyTorch's call for the LayerNorm
    backward the epilogue computes (dx_ln, dγ, dβ), the statistics made once
    outside it."""
    d = x.shape[-1]
    x32, g32 = x.reshape(-1, d).float(), gamma.float()
    b32 = torch.zeros_like(g32)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x32, [d], g32, b32, eps)
    return lambda: torch.ops.aten.native_layer_norm_backward(dxn32, x32, [d], mean, rstd, g32,
                                                             b32, [True, True, True])


def block_error(torch, out, ref, x):
    """``(max|out - ref|, excess, tol)`` for a residual block's kernel output
    ``out`` against its plain version ``ref`` on input ``x``: ``excess`` is
    the largest amount by which an element differs beyond one unit of the
    output dtype (the final residual add's rounding), and must not pass
    ``tol`` = KERNEL_REL_TOL·max|ref - x|, a few units of the block's own
    output."""
    diff = (out.float() - ref.float()).abs()
    _, exp = torch.frexp(torch.maximum(out.float().abs(), ref.float().abs()))
    unit = torch.ldexp(torch.full_like(diff, torch.finfo(out.dtype).eps), exp - 1)
    excess = (diff - unit).clamp_min(0).max().item()
    tol = KERNEL_REL_TOL * (ref.float() - x.float()).abs().max().item()
    return diff.max().item(), excess, tol


def check_outputs(torch, name, out, ref, residuals):
    """Hold a kernel's outputs ``out`` against its plain version's ``ref``,
    output by output, with :func:`block_error`: an output that adds a
    residual (``residuals[i]``: x for a block's y, dy for dx) is held to 2e-2
    of its own part, the others to 2e-2·max|ref|, each beyond one unit of
    its dtype.  Returns the largest error; raises on a miss."""
    worst = 0.0
    for i, (o, r) in enumerate(zip(out, ref)):
        if o.shape != r.shape or o.dtype != r.dtype or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name} output {i}: {tuple(o.shape)} {o.dtype}, "
                                 f"expected {tuple(r.shape)} {r.dtype}, finite")
        base = residuals.get(i, torch.zeros_like(r))
        err, excess, tol = block_error(torch, o, r, base)
        if not excess <= tol:
            raise AssertionError(f"{name} output {i} differs from its plain version by "
                                 f"{excess} beyond one unit > {tol}")
        worst = max(worst, err)
    return worst


def check_dbias(torch, name, out, ref, what="dbias"):
    """Hold a kernel's f32 sum over the batch (``what``: dbias, or the cross-
    attention block's dbo) against its plain version's within
    DBIAS_REL_TOL·max|ref|; returns max|out - ref|, raises on a miss."""
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name} {what}: {tuple(out.shape)} {out.dtype}, expected "
                             f"{tuple(ref.shape)} {ref.dtype}, finite")
    err = (out - ref).abs().max().item()
    tol = DBIAS_REL_TOL * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name} {what} differs from its plain version by {err} > {tol}")
    return err


def bound(flops, nbytes):
    """The least time in ms the card could take: the larger of the FLOPs at
    the bf16 peak and the bytes at the memory rate; and which bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def mlp_bounds(rows, d, hidden):
    """Bounds of the fused MLP's forward and backward over ``rows`` rows at
    the module's widths d and hidden (bf16 activations and weights, f32
    parameter-gradient sums): its two GEMMs' FLOPs; each input read once
    and each output written once.  At widths off 8 the kernels compute at
    the padded widths, but the function's work is the same."""
    act = rows * d * 2  # one (rows, d) bf16 tensor
    return {
        # x, γ, β, W1, b1, W2, b2 -> y
        "fused_mlp": bound(4 * rows * d * hidden,
                           2 * act + 4 * d * hidden + 2 * (3 * d + hidden)),
        # dy, x, h, γ, W1, W2 -> dx, dh, gact and f32 dγ, dβ, db1, db2
        "fused_mlp_bwd": bound(4 * rows * d * hidden,
                               3 * act + 3 * rows * hidden * 2 + 4 * d * hidden
                               + 2 * d + 4 * (3 * d + hidden)),
    }


def block_bounds(b, n, d, heads, dim_head, hidden, hb=0, dbias=False):
    """Bounds of the four kernels at one block shape (bf16 activations and
    weights, f32 parameter-gradient sums): FLOPs of the TPU kernels' own
    work; each input read once and each output written once.  With an f32
    ``(hb, n, n)`` logits bias (hb > 0) the attention block's entries read
    it too, and the backward writes dbias when ``dbias``; the bias adds and
    dbias's sums are not tensor-core work."""
    rows, inner = b * n, heads * dim_head
    attn = 2 * b * heads * n * n * dim_head  # one n x n x dim_head product
    act = rows * d * 2  # one (rows, d) bf16 tensor
    bias = 4 * hb * n * n
    return {
        **mlp_bounds(rows, d, hidden),
        # x, γ, β, Wqkv, Wo, bo -> y
        "fused_attention_block": bound(8 * rows * d * inner + 2 * attn,
                                       2 * act + 8 * d * inner + 6 * d + bias),
        # dy, x, qkv, γ, Wqkv, Wo (, bias) -> dx, dqkv and f32 dγ, dβ, dbo (, dbias)
        "fused_attention_block_bwd": bound(8 * rows * d * inner + 5 * attn,
                                           3 * act + 2 * rows * 3 * inner * 2
                                           + 8 * d * inner + 2 * d + 12 * d
                                           + bias * (2 if dbias else 1)),
    }


def kernel_phase(torch, tag, b, n, d, heads, dim_head, hidden, results, eps=1e-3,
                 kernels=("fused_mlp", "fused_attention_block")):
    """The serving forwards of the fused MLP and the attention block at one
    shape, seeded bf16 inputs: each against its plain version (the block on
    the short route also against that route's own plain version), twice bit
    for bit, the block's route counted; times of the kernel, its plain
    version and the bf16 modules.  ``eps`` is the LayerNorm's (1e-5 where
    the block stands for a ChannelLayerNorm, Twins-SVT's); ``kernels`` the
    ones to run."""
    from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm
    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops.fused_attention_block import (
        fused_attention_block, fused_attention_block_reference,
    )
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rn(b, n, d).to(dt)
    gamma, beta = (1.0 + rn(d, scale=0.1)).to(dt), rn(d, scale=0.1).to(dt)
    mlp_w = (rn(hidden, d, scale=d ** -0.5).to(dt), rn(hidden, scale=0.1).to(dt),
             rn(d, hidden, scale=hidden ** -0.5).to(dt), rn(d, scale=0.1).to(dt))
    attn_w = (rn(3 * inner, d, scale=d ** -0.5).to(dt),
              rn(d, inner, scale=inner ** -0.5).to(dt), rn(d, scale=0.1).to(dt))

    norm = LayerNorm(d, eps, device=dev, dtype=dt)
    mlp = MLP(d, hidden, device=dev, dtype=dt)
    attn = Attention(d, heads, dim_head, device=dev, dtype=dt)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
        for p, w in zip((mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias), mlp_w):
            p.copy_(w)
        for p, w in zip((attn.to_qkv.weight, attn.to_out[0].weight, attn.to_out[0].bias), attn_w):
            p.copy_(w)
    norm.eval(), mlp.eval(), attn.eval()

    route = fab.attention_route(n)
    cases = {
        "fused_mlp": (fused_mlp,
                      lambda: fused_mlp(x, gamma, beta, *mlp_w, eps),
                      lambda: fused_mlp_reference(x, gamma, beta, *mlp_w, eps),
                      lambda: x + mlp(norm(x)), None),
        "fused_attention_block": (
            fused_attention_block,
            lambda: fused_attention_block(x, gamma, beta, *attn_w, heads, dim_head, eps=eps),
            lambda: fused_attention_block_reference(x, gamma, beta, *attn_w, heads,
                                                    dim_head, eps=eps),
            lambda: x + attn(norm(x)),
            (lambda: fab.fused_attention_block_short_forward_reference(
                x, gamma, beta, *attn_w, heads, dim_head, eps=eps)[0])
            if route == "short" else None),
    }
    with torch.inference_mode():
        for name, (wrapper, kernel, plain, modules, own_plain) in cases.items():
            if name not in kernels:
                continue
            before, routes = wrapper.launches, fab.FORWARD_ROUTES[route].launches
            out = kernel()
            torch.cuda.synchronize()
            if wrapper.launches != before + 1:
                raise AssertionError(f"{name}: launch counter did not move")
            if name == "fused_attention_block" and \
                    fab.FORWARD_ROUTES[route].launches != routes + 1:
                raise AssertionError(f"{name}: the {route} route's counter did not move")
            ref = plain()
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
            if not torch.equal(out, kernel()):
                raise AssertionError(f"{name}: two runs differ")
            err, excess, tol = block_error(torch, out, ref, x)
            own = ""
            if own_plain:
                own_err, own_excess, own_tol = block_error(torch, out, own_plain(), x)
                if not own_excess <= own_tol:
                    raise AssertionError(f"{name}: kernel differs from the {route} route's "
                                         f"plain version by {own_excess} > {own_tol}")
                own = (f"; against the {route} route's plain version (p normalised before "
                       f"P·V) {own_err:.6g}, beyond one unit {own_excess:.6g}")
            ms = interleaved_medians(torch, {"kernel": kernel, "plain": plain,
                                             "modules": modules}, rounds=5, calls=10)
            via = f", attention on the {route} route" if wrapper is fused_attention_block else ""
            log(f"kernel {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
                f"h={hidden} eps={eps:g}{via}]: max|kernel-plain|={err:.6g}, beyond one bf16 unit of "
                f"the output {excess:.6g} tol={tol:.6g} (2e-2*max|ref-x|: a few bf16 "
                f"units of the block's own output){own}; the same bits in two runs; ms "
                f"kernel={ms['kernel']:.4f} plain={ms['plain']:.4f} "
                f"modules={ms['modules']:.4f}")
            if not excess <= tol:
                raise AssertionError(f"{name}: kernel differs from its plain version "
                                     f"by {excess} beyond one output unit > {tol}")
            results.setdefault(name, {})[tag] = dict(
                err=err, **ms, bound=block_bounds(b, n, d, heads, dim_head, hidden)[name])


# The blocks' forward GEMMs (fc1 keeping h, fc2, QKV, out-projection; csrc/
# gemm_wgmma.cu launch_forward_gemm) at the main paths' shapes: (tag, rows, n,
# k, epilogue).  ViT-B/32 @256 at batch 128 (bench.py's step) and 8 (the
# entry's serving), ViT-B/16 @224 at batch 64, and ScalableViT @256's
# conv-MLPs at batch 64 (dim 64 · 2^s, hidden 4x, (64 / 2^s)² tokens an
# image at stage s + 1): the shapes on both sides of the threshold.
FORWARD_GEMM_SHAPES = [
    ("B/32 QKV", 8320, 3072, 1024, "store"),
    ("B/32 out-proj", 8320, 1024, 1024, "bias_residual"),
    ("B/32 fc1", 8320, 2048, 1024, "bias_gelu_save"),
    ("B/32 fc2", 8320, 1024, 2048, "bias_residual"),
    ("B/32 serving fc1, batch 8", 520, 2048, 1024, "bias_gelu"),
    ("B/16 QKV", 12608, 2304, 768, "store"),
    ("B/16 out-proj", 12608, 768, 768, "bias_residual"),
    ("B/16 fc1", 12608, 3072, 768, "bias_gelu_save"),
    ("B/16 fc2", 12608, 768, 3072, "bias_residual"),
    ("ScalableViT stage 1 fc1", 262144, 256, 64, "bias_gelu_save"),
    ("ScalableViT stage 1 fc2", 262144, 64, 256, "bias_residual"),
    ("ScalableViT stage 2 fc1", 65536, 512, 128, "bias_gelu_save"),
    ("ScalableViT stage 2 fc2", 65536, 128, 512, "bias_residual"),
    ("ScalableViT stage 3 fc1", 16384, 1024, 256, "bias_gelu_save"),
    ("ScalableViT stage 3 fc2", 16384, 256, 1024, "bias_residual"),
    ("ScalableViT stage 4 fc1", 4096, 2048, 512, "bias_gelu_save"),
    ("ScalableViT stage 4 fc2", 4096, 512, 2048, "bias_residual"),
]
FORWARD_GEMM_MIN_N = 256  # csrc/gemm_wgmma.cu kForwardMinN: launch_forward_gemm's rule


def gemm_bound(rows, n, k, epilogue):
    """Bound of one forward GEMM (bf16): 2·rows·n·k FLOPs; A and W read, the
    bias and the residual read as the epilogue takes them, out (and h for
    ``bias_gelu_save``) written."""
    outs = 2 if epilogue == "bias_gelu_save" else 1
    nbytes = 2 * (rows * k + n * k + outs * rows * n)
    if epilogue != "store":
        nbytes += 2 * n
    if epilogue == "bias_residual":
        nbytes += 2 * rows * n
    return bound(2 * rows * n * k, nbytes)


def forward_gemm_phase(torch, smi):
    """The blocks' forward GEMMs at FORWARD_GEMM_SHAPES on both kernels that
    launch_forward_gemm chooses between: gemm_wgmma.cu's wgmma GEMM and
    linear.cu's mma.sync one (``fused_hybrid.gemm_wgmma(kernel=...)``),
    seeded bf16 inputs.  Each output against the plain GEMM (one unit plus
    2e-2 of its own part, the residual's part apart); times of both kernels
    in turns, the bound, and which one the rule (n >= FORWARD_GEMM_MIN_N on
    gemm_wgmma) takes.  Returns ``{tag: {wgmma, mma_sync, bound}}`` ms."""
    from vit_tpu_torch.ops import fused_hybrid as fh

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for tag, rows, n, k, epilogue in FORWARD_GEMM_SHAPES:
        a = torch.randn(rows, k, generator=g, device=dev).to(dt)
        w = (torch.randn(n, k, generator=g, device=dev) * k ** -0.5).to(dt)
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(dt)
        res = torch.randn(rows, n, generator=g, device=dev).to(dt) \
            if epilogue == "bias_residual" else None
        ref = fh.gemm_reference(a, w, epilogue, bias, res)
        ref = tuple(t for t in ref if t is not None)
        fns = {}
        for kernel in fh.GEMM_KERNELS:
            def fn(kernel=kernel):
                return fh.gemm_wgmma(a, w, epilogue, bias, res, kernel=kernel)

            got = tuple(t for t in fn() if t is not None)
            check_outputs(torch, f"forward GEMM {tag} on {kernel}", got, ref,
                          {0: res} if res is not None else {})
            fns[kernel] = fn
        ms = interleaved_medians(torch, fns, rounds=5, calls=10)
        limit, by = gemm_bound(rows, n, k, epilogue)
        takes = "wgmma" if n >= FORWARD_GEMM_MIN_N else "mma_sync"
        log(f"forward GEMM {tag} [rows={rows} n={n} k={k} {epilogue}]: ms gemm_wgmma="
            f"{ms['wgmma']:.4f} linear.cu mma.sync={ms['mma_sync']:.4f} bound={limit:.4f} "
            f"({by}); launch_forward_gemm takes {takes}; both within one unit plus 2e-2 of "
            f"the plain GEMM, on {smi}")
        out[tag] = dict(ms, bound=limit, takes=takes)
        del a, w, res, ref, fns
    return out


def backward_phase(torch, tag, b, n, d, heads, dim_head, hidden, results, eps=1e-3,
                   kernels=("fused_mlp", "fused_attention_block")):
    """At a training shape, from seeded bf16 inputs and cotangent: each
    training forward (the kernels that keep the residuals, as under grad)
    against its plain version, output by output, twice bit for bit, the
    block's lse (kept for the short route of its backward) within
    LSE_ABS_TOL; then each backward kernel, fed the residuals the forward
    kernels kept, against its plain backward on the same residuals, and twice
    bit for bit (the block's attention on the route ``attention_route`` gives
    it, as in training).  Times of the backward kernel, its plain version, the
    kernel with the two weight-gradient GEMMs (the op's whole backward), and
    PyTorch autograd through the plain bf16 modules, once for the kernel's
    own outputs (dx and the γ, β and bias gradients) and once with the weight
    gradients too.  ``eps`` and ``kernels`` as :func:`kernel_phase`; at a
    width where the LayerNorm backward is not the dgrad's epilogue
    (``ln_bwd_fused``), each backward must run layernorm.cu's passes once
    instead."""
    from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm
    from vit_tpu_torch.ops import _build, fused_attention_block as fab, fused_mlp as fm
    from vit_tpu_torch.ops import fused_hybrid as fh
    from vit_tpu_torch.ops._shared import ln_bwd_fused, weight_grad

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
    gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dt), rn(d, scale=0.1)
    mlp_w = (rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
             rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))
    attn_w = (rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5),
              rn(d, scale=0.1))
    w1, _, w2, _ = mlp_w
    wqkv, wo, _ = attn_w
    scale = dim_head ** -0.5

    # The training forwards and the residuals they keep (the block's lse for
    # the short route of its backward, where that route applies).
    route = fab.attention_route(n)

    def mlp_forward():
        return fm._launch_forward(x, gamma, beta, *mlp_w, eps, save_residuals=True)

    def attn_forward():
        return fab._launch_forward(x, gamma, beta, *attn_w, heads, dim_head, scale, eps,
                                   training=True)

    attn_fwd = attn_forward()
    fwd = {
        "fused_mlp": (mlp_forward, mlp_forward(),
                      fm.fused_mlp_forward_reference(x, gamma, beta, *mlp_w, eps),
                      "y, xn, h"),
        "fused_attention_block": (
            lambda: attn_forward()[:4], attn_fwd[:4],
            fab.fused_attention_block_forward_reference(x, gamma, beta, *attn_w, heads,
                                                        dim_head, scale, eps),
            f"y, xn, qkv, oattn; attention on the {route} route"),
    }
    torch.cuda.synchronize()
    for name, (again, out, ref, outputs) in fwd.items():
        if name not in kernels:
            continue
        err = check_outputs(torch, f"{name} training forward", out, ref, {0: x})
        if not all(torch.equal(a, b_) for a, b_ in zip(out, again())):
            raise AssertionError(f"{name} training forward: two runs differ")
        log(f"training forward {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
            f"h={hidden} eps={eps:g}]: ({outputs}) each within one bf16 unit plus 2e-2*max|its own "
            f"part| of the plain version, the same bits in two runs; "
            f"max|kernel-plain|={err:.6g}")
        results.setdefault(name, {}).setdefault(tag, {})["train_fwd_err"] = err
    _, xn_m, h = fwd["fused_mlp"][1]
    _, xn_a, qkv, oattn, lse = attn_fwd
    if lse is not None:  # f32 on both sides, from the same bf16 qkv: summation order only
        lse_err = (lse - fab.attention_lse_reference(qkv, heads, dim_head, scale)).abs().max()
        if not lse_err.item() <= LSE_ABS_TOL:
            raise AssertionError(f"fused_attention_block training forward lse differs from its "
                                 f"plain version by {lse_err.item()} > {LSE_ABS_TOL}")

    norm = LayerNorm(d, eps, device=dev, dtype=dt)
    mlp = MLP(d, hidden, device=dev, dtype=dt)
    attn = Attention(d, heads, dim_head, device=dev, dtype=dt)
    with torch.no_grad():
        for prm, w in zip((norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias,
                           mlp.fc2.weight, mlp.fc2.bias, attn.to_qkv.weight,
                           attn.to_out[0].weight, attn.to_out[0].bias),
                          (gamma, beta, *mlp_w, *attn_w)):
            prm.copy_(w)
    xg = x.detach().requires_grad_()

    def autograd_through(module, weights):
        y = xg + module(norm(xg))
        inputs = [xg, *norm.parameters(), *(prm for key, prm in module.named_parameters()
                                            if weights or key.endswith("bias"))]
        return lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)

    def mlp_kernel():
        return fm.fused_mlp_backward(dy, x, h, gamma, w1, w2, eps)

    def mlp_whole():
        out = mlp_kernel()
        return out, weight_grad(out[1], xn_m), weight_grad(dy, out[2])

    def attn_kernel():
        return fab.fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads,
                                                  dim_head, scale, eps, oattn, lse)

    def attn_whole():
        out = attn_kernel()
        return out, weight_grad(out[1], xn_a), weight_grad(dy, oattn)

    cases = {
        "fused_mlp_bwd": (fm.fused_mlp_backward, mlp_kernel,
                          lambda: fm.fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, eps),
                          mlp_whole, mlp, w1),
        "fused_attention_block_bwd": (
            fab.fused_attention_block_backward, attn_kernel,
            lambda: fab.fused_attention_block_backward_reference(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps),
            attn_whole, attn, wqkv),
    }
    fused = ln_bwd_fused(d)
    for name, (wrapper, kernel, plain, whole, module, w_ln) in cases.items():
        if name.removesuffix("_bwd") not in kernels:
            continue
        before, routes = wrapper.launches, fab.BACKWARD_ROUTES[route].launches
        out = kernel()
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"{name}: launch counter did not move")
        if name == "fused_attention_block_bwd" and \
                fab.BACKWARD_ROUTES[route].launches != routes + 1:
            raise AssertionError(f"{name}: the {route} route's counter did not move")
        err = check_outputs(torch, name, out, plain(), {0: dy})
        if name == "fused_attention_block_bwd":  # the route's own plain version: p from the
            # forward's lse, D = rowsum(dO∘O) from its oattn
            err = max(err, check_outputs(
                torch, f"{name}, {route} route", out,
                fab.fused_attention_block_lse_backward_reference(
                    dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dim_head, scale, eps),
                {0: dy}))
        if not all(torch.equal(a, b_) for a, b_ in zip(out, kernel())):
            raise AssertionError(f"{name}: two runs differ")
        one_key = ""
        if name == "fused_attention_block_bwd" and n == 1:
            # One key: the softmax is 1 and ds = p·(dp - Σ p·dp) = 0, so dq
            # and dk are 0 exactly in the TPU kernel and its plain version.
            dq, dk = out[1][..., :inner], out[1][..., inner:2 * inner]
            if torch.count_nonzero(dq) or torch.count_nonzero(dk):
                raise AssertionError(f"{name} over one key: dq and dk must be 0 exactly, got "
                                     f"max|dq|={dq.abs().max().item():.6g} "
                                     f"max|dk|={dk.abs().max().item():.6g}")
            one_key = "; one key: dq and dk exactly 0"
        # PyTorch's LayerNorm backward timed on the f32 dxn (dh·W1 or
        # dqkv·Wqkv, from its own output).
        rows, device, ln = check_ln_backward(torch, name, kernel, d)
        grad_in = out[1].reshape(-1, out[1].shape[-1])
        dxn32 = fh.gemm_wgmma(grad_in, w_ln, "f32", layout="kn",
                              kernel="wgmma" if fused else "mma_sync")[0]
        ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain, "whole": whole,
            "library": autograd_through(module, weights=False),
            "library_whole": autograd_through(module, weights=True),
            "library_ln": ln_library(torch, dxn32, x, gamma, eps)}, rounds=5, calls=5)
        del dxn32
        limit, by = block_bounds(b, n, d, heads, dim_head, hidden)[name]
        via = f", attention on the {route} route" if name == "fused_attention_block_bwd" else ""
        log(f"backward {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} h={hidden} "
            f"eps={eps:g}]: fed the forward kernel's residuals{via}; max|kernel-plain| over the "
            f"outputs={err:.6g}, each within one unit plus 2e-2*max|its own part|, the same bits "
            f"in two runs{one_key}; ms kernel={ms['kernel']:.4f} "
            f"plain={ms['plain']:.4f} autograd through the bf16 modules for the same outputs="
            f"{ms['library']:.4f}; with the weight gradients: kernel+dW GEMMs="
            f"{ms['whole']:.4f} autograd={ms['library_whole']:.4f}; bound={limit:.4f} ({by}); "
            + ln + f"; native_layer_norm_backward on the same f32 dxn={ms['library_ln']:.4f}")
        results.setdefault(name, {})[tag] = dict(err=err, **ms, device=device,
                                                 bound=(limit, by))


def biased_phase(torch, b, n, d, heads, dim_head, hidden, results, tag=None, eps=1e-3,
                 kinds=("lsa", "shared", "per-head")):
    """The biased block at the small-dataset ViT's shapes, for LSA's mask
    (scale 1.0, no dbias), a shared and a per-head random bias (``kinds``:
    those to run; ``eps`` the LayerNorm's), on the route
    ``attention_route`` gives it (short_fwd / short_bwd with the bias up to
    512 tokens, counted): serving and training forwards (lse within
    LSE_ABS_TOL), backward fed the training forward's residuals (dbias within
    DBIAS_REL_TOL), each against the TPU kernel's rounding points and against
    the route's own plain version, twice bit for bit; times beside the
    unbiased kernel on the same inputs and the bf16 modules with
    ``scaled_dot_product_attention``.  dbias is held to both plain versions:
    the short route's dbias call takes each row's dsum = Σ p·dp (the row
    statistics it computes first), as the TPU kernel; D = rowsum(dO∘O) from
    the bf16 O took a dbias past DBIAS_REL_TOL of the TPU kernel's at some
    inputs (PERF.md §6).  The backward's LayerNorm backward is checked by
    :func:`check_ln_backward`.  Results go under the bias's kind, with ``, tag``
    after it when given (another shape)."""
    import torch.nn.functional as F

    from vit_tpu_torch.layers.common import Attention, LayerNorm
    from vit_tpu_torch.models.vit_for_small_dataset import lsa_bias
    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops._shared import weight_grad

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
    gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dt), rn(d, scale=0.1)
    wqkv, wo, bo = rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5), \
        rn(d, scale=0.1)
    args = (x, gamma, beta, wqkv, wo, bo)
    norm = LayerNorm(d, eps, device=dev, dtype=dt)
    attn = Attention(d, heads, dim_head, device=dev, dtype=dt)
    with torch.no_grad():
        for prm, w in zip((norm.weight, norm.bias, attn.to_qkv.weight, attn.to_out[0].weight,
                           attn.to_out[0].bias), (gamma, beta, wqkv, wo, bo)):
            prm.copy_(w)
    xg = x.detach().requires_grad_()
    route = fab.attention_route(n)
    short = route == "short"
    biases = {"lsa": (lsa_bias(n, dev), 1.0),
              "shared": (torch.randn(1, n, n, generator=g, device=dev) * 0.5, dim_head ** -0.5),
              "per-head": (torch.randn(heads, n, n, generator=g, device=dev) * 0.5,
                           dim_head ** -0.5)}
    for kind in kinds:
        bias, scale = biases[kind]
        want_dbias = kind != "lsa"
        shape = f"[{kind} bias {tuple(bias.shape)}, scale {scale:.4g}, " \
                + (f"{tag}, " if tag else "") + \
                f"b={b} n={n} d={d} heads={heads}x{dim_head} eps={eps:g}]"

        def modules(mask):
            """The block in bf16 modules, attention by PyTorch's SDPA."""
            q, k, v = (t.reshape(b, n, heads, dim_head).transpose(1, 2)
                       for t in attn.to_qkv(norm(xg)).chunk(3, dim=-1))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
            return xg + attn.to_out[0](o.transpose(1, 2).reshape(b, n, inner))

        mask = bias.to(dt)
        with torch.inference_mode():
            before = fab.fused_attention_block_bias.launches
            routes = fab.FORWARD_ROUTES[route].launches
            out = fab.fused_attention_block_bias(*args, bias, heads, dim_head, scale, eps)
            torch.cuda.synchronize()
            if fab.fused_attention_block_bias.launches != before + 1:
                raise AssertionError(f"biased forward {kind}: launch counter did not move")
            if fab.FORWARD_ROUTES[route].launches != routes + 1:
                raise AssertionError(f"biased forward {kind}: the {route} route's counter did "
                                     f"not move")
            ref = fab.fused_attention_block_reference(*args, heads, dim_head, scale, eps, bias)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"biased forward {kind}: non-finite output")
            err, excess, tol = block_error(torch, out, ref, x)
            if not excess <= tol:
                raise AssertionError(f"biased forward {kind}: differs from its plain version "
                                     f"by {excess} beyond one output unit > {tol}")
            if not torch.equal(out, fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                                   scale, eps)):
                raise AssertionError(f"biased forward {kind}: two runs differ")
            own_err = 0.0
            if short:  # the short route's own plain version (its rounding points)
                own_err, own_excess, own_tol = block_error(
                    torch, out, fab.fused_attention_block_short_forward_reference(
                        *args, heads, dim_head, scale, eps, bias)[0], x)
                if not own_excess <= own_tol:
                    raise AssertionError(f"biased forward {kind}: differs from the short "
                                         f"route's plain version by {own_excess} > {own_tol}")
            fwd_ms = interleaved_medians(torch, {
                "kernel": lambda: fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                                 scale, eps),
                "unbiased": lambda: fab.fused_attention_block(*args, heads, dim_head, scale, eps),
                "plain": lambda: fab.fused_attention_block_reference(*args, heads, dim_head,
                                                                     scale, eps, bias),
                "library": lambda: modules(mask)}, rounds=5, calls=10)
        train = fab._launch_forward(*args, heads, dim_head, scale, eps, bias, training=True)
        train_err = check_outputs(
            torch, f"biased training forward {kind}", train[:4],
            fab.fused_attention_block_forward_reference(*args, heads, dim_head, scale, eps,
                                                        bias), {0: x})
        if short:
            train_err = max(train_err, check_outputs(
                torch, f"biased training forward {kind}, short route", train[:4],
                fab.fused_attention_block_short_forward_reference(*args, heads, dim_head, scale,
                                                                  eps, bias)[:4], {0: x}))
        again = fab._launch_forward(*args, heads, dim_head, scale, eps, bias, training=True)
        if not all(torch.equal(a, b_) for a, b_ in zip(train, again) if a is not None):
            raise AssertionError(f"biased training forward {kind}: two runs differ")
        del again
        _, xn, qkv, oattn, lse = train
        # f32 on both sides, from the same bf16 qkv: summation order only
        lse_err = (lse - fab.attention_lse_reference(qkv, heads, dim_head, scale, bias)
                   ).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"biased training forward {kind}: lse differs from its "
                                 f"plain version by {lse_err} > {LSE_ABS_TOL}")
        # The unbiased block on the same inputs, timed beside: its own
        # training forward's residuals, for the route its backward takes.
        unbiased = fab._launch_forward(*args, heads, dim_head, scale, eps, training=True)
        bounds = block_bounds(b, n, d, heads, dim_head, hidden, bias.shape[0], want_dbias)
        fwd_bound = bounds["fused_attention_block"]
        bwd_bound = bounds["fused_attention_block_bwd"]
        log(f"biased forward {shape}, attention on the {route} route: serving "
            f"max|kernel-plain|={err:.6g}, beyond one bf16 unit {excess:.6g} tol={tol:.6g}"
            + (f", against the route's own plain version {own_err:.6g}" if short else "")
            + f"; training forward (y, xn, qkv, oattn) max {train_err:.6g}, lse "
            f"{lse_err:.6g}; the same bits in two runs; ms "
            f"kernel={fwd_ms['kernel']:.4f} unbiased kernel on the same "
            f"inputs={fwd_ms['unbiased']:.4f} plain={fwd_ms['plain']:.4f} bf16 modules with "
            f"SDPA(attn_mask=bias)={fwd_ms['library']:.4f}; bound={fwd_bound[0]:.4f} "
            f"({fwd_bound[1]})")

        def kernel():
            return fab.fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias,
                                                           heads, dim_head, scale, eps,
                                                           need_dbias=want_dbias, oattn=oattn,
                                                           lse=lse)

        def whole():
            out = kernel()
            return out, weight_grad(out[1], xn), weight_grad(dy, oattn)

        def plain():
            return fab.fused_attention_block_backward_reference(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, bias, want_dbias)

        def autograd_through(weights):
            mask_g = mask.detach().requires_grad_(want_dbias)
            y = modules(mask_g)
            inputs = [xg, *norm.parameters(), attn.to_out[0].bias]
            inputs += [mask_g] if want_dbias else []
            inputs += [attn.to_qkv.weight, attn.to_out[0].weight] if weights else []
            return lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)

        before = fab.fused_attention_block_bias_backward.launches
        routes = fab.BACKWARD_ROUTES[route].launches
        got = kernel()
        torch.cuda.synchronize()
        if fab.fused_attention_block_bias_backward.launches != before + 1:
            raise AssertionError(f"biased backward {kind}: launch counter did not move")
        if fab.BACKWARD_ROUTES[route].launches != routes + 1:
            raise AssertionError(f"biased backward {kind}: the {route} route's counter did not "
                                 f"move")
        tpu = plain()  # the TPU kernel's rounding points
        bwd_err = check_outputs(torch, f"biased backward {kind}", got[:5], tpu[:5], {0: dy})
        # the route's own plain version (either route): p from the forward's lse, D =
        # rowsum(dO∘O), or with dbias the row statistics' dsum
        want = fab.fused_attention_block_lse_backward_reference(
            dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dim_head, scale, eps, bias,
            want_dbias)
        bwd_err = max(bwd_err, check_outputs(torch, f"biased backward {kind}, {route} route",
                                             got[:5], want[:5], {0: dy}))
        again = kernel()
        if not all(torch.equal(a, b_) for a, b_ in zip(got[:5], again[:5])):
            raise AssertionError(f"biased backward {kind}: two runs differ")
        dbias_err = dbias_max = dbias_tpu = plain_gap = None
        if want_dbias:
            dbias_err = check_dbias(torch, f"biased backward {kind}", got[5], want[5])
            dbias_max = want[5].abs().max().item()
            tpu_max = tpu[5].abs().max().item()
            dbias_tpu = check_dbias(torch, f"biased backward {kind}, TPU rounding points",
                                    got[5], tpu[5]) / tpu_max
            plain_gap = (want[5] - tpu[5]).abs().max().item() / tpu_max
            if not torch.equal(got[5], again[5]):
                raise AssertionError(f"biased backward {kind}: dbias differs between two runs")
        elif got[5] is not None:
            raise AssertionError(f"biased backward {kind}: dbias computed unasked")
        del want, tpu, again
        ln_rows, device, ln = check_ln_backward(torch, f"biased backward {kind}", kernel, d)
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel,
            "unbiased": lambda: fab.fused_attention_block_backward(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, *unbiased[3:]),
            "plain": plain, "whole": whole, "library": autograd_through(weights=False),
            "library_whole": autograd_through(weights=True)}, rounds=5, calls=5)
        log(f"biased backward {shape}: fed the forward kernel's residuals, attention on the "
            f"{route} route; max|kernel-plain| over (dx, dqkv, dγ, dβ, dbo)={bwd_err:.6g}, each "
            f"within one unit plus 2e-2*max|its own part| of the TPU kernel's rounding points "
            f"and of the route's own plain version, the same bits in two runs; dbias "
            + (f"max|kernel-plain|={dbias_err:.6g} of max|ref|={dbias_max:.6g} (<= "
               f"{DBIAS_REL_TOL}*max|ref|, the route's own plain version), against the TPU "
               f"kernel's rounding points {dbias_tpu:.6g}*max|ref| (<= {DBIAS_REL_TOL}; the "
               f"two plain versions differ by {plain_gap:.6g}*max|ref|), the same bits in two "
               f"runs"
               if want_dbias else "not asked for, not computed")
            + f"; ms kernel={bwd_ms['kernel']:.4f} unbiased kernel on the same inputs="
            f"{bwd_ms['unbiased']:.4f} plain={bwd_ms['plain']:.4f} autograd through the bf16 "
            f"modules with SDPA for the same outputs={bwd_ms['library']:.4f}; with the weight "
            f"gradients: kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd="
            f"{bwd_ms['library_whole']:.4f}; bound={bwd_bound[0]:.4f} ({bwd_bound[1]}); " + ln)
        key = kind if tag is None else f"{kind}, {tag}"
        results.setdefault("fused_attention_block_bias", {})[key] = dict(
            err=max(err, own_err, train_err), lse_err=lse_err, **fwd_ms, bound=fwd_bound)
        results.setdefault("fused_attention_block_bias_bwd", {})[key] = dict(
            err=bwd_err, dbias_err=dbias_err, dbias_vs_tpu_rel=dbias_tpu,
            dbias_plain_gap_rel=plain_gap, **bwd_ms, device=device, bound=bwd_bound)


# The blocks past 512 tokens, on the mha route: ViT-B/16 at 384 px (24² + 1 =
# 577 tokens, the ViT paper's fine-tuning resolution) and the small-dataset ViT
# at 384 px (577 tokens at its width, 16 heads of 64), batch 16: (tag, b, n,
# d, heads, dim_head, hidden).
MHA_SHAPES = [("B/16@384", 16, 577, 768, 12, 64, 3072),
              ("small-dataset@384", 16, 577, 1024, 16, 64, 2048)]
# The biased block below the threshold, where the short route's one key tile
# is widest (208 keys): ViT-B/16's 197 tokens at the small-dataset ViT's width
# with LSA's mask, batch 64: (b, n, d, heads, dim_head).
THRESHOLD_SHAPE = (64, 197, 1024, 16, 64)


def mha_route_phase(torch, results, smi, counters):
    """The attention blocks past 512 tokens, on the mha route (flash_fwd and
    the flash backward, their biased instances with the bias, mha_row_stats
    and mha_dbias with dbias).  First its path: every counter from 0, the unbiased
    block at MHA_SHAPES[0] and the biased one at MHA_SHAPES[1] with a learned
    per-head bias (so dbias too) under autograd, forward and backward, once
    each; the counters read right after are the phase's launches, and every
    gradient must be finite.  Then the kernels at those shapes as phases 3,
    4 and 8 hold them (each against its plain version, twice bit for bit,
    each route counter checked).  Last, the biased block at THRESHOLD_SHAPE
    on both routes (the route function replaced for the call): y and the
    backward against the plain versions, and the times of each."""
    from unittest import mock

    from vit_tpu_torch.models.vit_for_small_dataset import lsa_bias
    from vit_tpu_torch.ops import fused_attention_block as fab

    dev, dt, eps = torch.device("cuda"), torch.bfloat16, 1e-3
    g = torch.Generator(device=dev).manual_seed(90)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def block_args(b, n, d, heads, dim_head):
        inner = heads * dim_head
        return [rn(b, n, d), 1.0 + rn(d, scale=0.1), rn(d, scale=0.1),
                rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5),
                rn(d, scale=0.1)]

    (_, b, n, d, heads, dim_head, _), (_, b2, n2, d2, heads2, dim_head2, _) = MHA_SHAPES
    unbiased = [t.requires_grad_() for t in block_args(b, n, d, heads, dim_head)]
    biased = [t.requires_grad_() for t in block_args(b2, n2, d2, heads2, dim_head2)]
    bias = (torch.randn(heads2, n2, n2, generator=g, device=dev) * 0.5).requires_grad_()
    dys = rn(b, n, d, scale=0.1), rn(b2, n2, d2, scale=0.1)
    for c in counters.values():
        c.launches = 0
    fab.fused_attention_block(*unbiased, heads, dim_head).backward(dys[0])
    fab.fused_attention_block_bias(*biased, bias, heads2, dim_head2).backward(dys[1])
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    check_launches("mha route", "one forward and backward of each block", counters, {
        "fused_attention_block": 1, "fused_attention_block_bwd": 1,
        "fused_attention_block_bias": 1, "fused_attention_block_bias_bwd": 1,
        "mha route, forward": 2, "mha route": 2}, 1)
    grads = [t.grad for t in (*unbiased, *biased, bias)]
    if not all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads):
        raise AssertionError("mha route: a gradient is missing or not finite")
    log(f"mha route: the unbiased block at {MHA_SHAPES[0][0]} (b={b} n={n} d={d} "
        f"heads={heads}x{dim_head}) and the biased one at {MHA_SHAPES[1][0]} (b={b2} n={n2} "
        f"d={d2} heads={heads2}x{dim_head2}, a learned ({heads2}, {n2}, {n2}) bias) under "
        f"autograd: launches {json.dumps({k: v for k, v in launches.items() if v})}, every "
        f"gradient finite, dbias included")
    del unbiased, biased, bias, dys, grads

    tag, b, n, d, heads, dim_head, hidden = MHA_SHAPES[0]
    kernel_phase(torch, tag, b, n, d, heads, dim_head, hidden, results)
    backward_phase(torch, tag, b, n, d, heads, dim_head, hidden, results)
    block_library_phase(torch, tag, b, n, d, heads, dim_head, results, smi)
    tag, b, n, d, heads, dim_head, hidden = MHA_SHAPES[1]
    biased_phase(torch, b, n, d, heads, dim_head, hidden, results, tag=tag)
    torch.cuda.empty_cache()

    b, n, d, heads, dim_head = THRESHOLD_SHAPE
    args = block_args(b, n, d, heads, dim_head)
    x, gamma, _, wqkv, wo, _ = args
    bias, scale, dy = lsa_bias(n, dev), 1.0, rn(b, n, d, scale=0.1)

    def on(route, fn):  # fn with the blocks' attention on ``route``
        def run():
            with mock.patch.object(fab, "attention_route", lambda n: route):
                return fn()
        return run

    y_ref = fab.fused_attention_block_reference(*args, heads, dim_head, scale, eps, bias)
    fns = {}
    for route in ("short", "mha"):
        before = fab.FORWARD_ROUTES[route].launches
        out = on(route, lambda: fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                               scale, eps))()
        _, _, qkv, oattn, lse = on(route, lambda: fab._launch_forward(
            *args, heads, dim_head, scale, eps, bias, training=True))()
        if fab.FORWARD_ROUTES[route].launches != before + 2:
            raise AssertionError(f"biased block at n={n}: the {route} route was not taken")
        _, excess, tol = block_error(torch, out, y_ref, x)
        if not excess <= tol:
            raise AssertionError(f"biased block at n={n}, {route} route: differs from its plain "
                                 f"version by {excess} beyond one output unit > {tol}")

        def backward(qkv=qkv, oattn=oattn, lse=lse):
            return fab.fused_attention_block_bias_backward(
                dy, x, qkv, gamma, wqkv, wo, bias, heads, dim_head, scale, eps,
                need_dbias=False, oattn=oattn, lse=lse)

        check_outputs(torch, f"biased backward at n={n}, {route} route", on(route, backward)()[:5],
                      fab.fused_attention_block_backward_reference(
                          dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, bias,
                          need_dbias=False)[:5], {0: dy})
        fns[f"{route} forward"] = on(route, lambda: fab.fused_attention_block_bias(
            *args, bias, heads, dim_head, scale, eps))
        fns[f"{route} backward"] = on(route, backward)
    ms = interleaved_medians(torch, fns, rounds=5, calls=5)
    log(f"biased block on both routes [LSA's mask, scale 1, b={b} n={n} d={d} "
        f"heads={heads}x{dim_head}]: y and the backward (dx, dqkv, dγ, dβ, dbo) on each within "
        f"one unit plus 2e-2*max|its own part| of the plain versions; ms forward "
        f"short={ms['short forward']:.4f} mha={ms['mha forward']:.4f}, backward "
        f"short={ms['short backward']:.4f} mha={ms['mha backward']:.4f} on {smi}")
    results["route threshold"] = {f"n={n}": ms}
    return launches


def spt_phase(torch, batch, size, patch, dim, smi):
    """The small-dataset tokenizer: its convolution form (the model's path)
    against the eager concat → patchify → LN → Dense form, both in bf16, and
    the eager form in f32; the convolution form may be at most twice as far
    from f32 as the eager bf16 form.  Times of both bf16 forms, and of the
    convolution form with cuDNN's TF32 allowed (PyTorch's default, which the
    smoke turns off for its f32 references): its main convolution follows
    the caller's setting, and its 16-bit operands are exact in TF32."""
    from vit_tpu_torch import cast_params
    from vit_tpu_torch.models.vit_for_small_dataset import SPT

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    spt32 = SPT(dim, patch, device=dev, generator=g)
    with torch.no_grad():
        spt32.norm.weight.add_(torch.randn(spt32.norm.weight.shape, generator=g, device=dev) * 0.1)
        spt32.norm.bias.normal_(0.0, 0.1, generator=g)
    spt = cast_params(SPT(dim, patch, device=dev), torch.bfloat16)
    spt.load_state_dict(spt32.state_dict())
    # Pixels with a non-zero mean, where the convolution form subtracts nearly
    # equal terms.
    img = (torch.rand(batch, size, size, 3, generator=g, device=dev)).to(torch.bfloat16)
    def conv_tf32():
        torch.backends.cudnn.allow_tf32 = True
        try:
            return spt(img)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    with torch.inference_mode():
        conv, eager, truth = spt(img), spt.plain(img), spt32.plain(img.float())
        err_c, err_e = ((t.float() - truth).abs().max().item() for t in (conv, eager))
        diff = (conv.float() - conv_tf32().float()).abs().max().item()
        ms = interleaved_medians(torch, {"conv": lambda: spt(img), "conv_tf32": conv_tf32,
                                         "eager": lambda: spt.plain(img)}, rounds=5, calls=10)
    log(f"spt [b={batch} {size}px patch {patch} dim {dim}, pixels in [0, 1)]: tokens "
        f"{tuple(conv.shape)}; against the f32 eager form max|conv-f32|={err_c:.6g} "
        f"max|eager bf16-f32|={err_e:.6g} (conv <= {MAX_ERR_VS_PLAIN_BF16}x eager); with cuDNN's "
        f"TF32 allowed max|diff|={diff:.6g}; ms convolution form={ms['conv']:.4f} "
        f"(TF32 allowed {ms['conv_tf32']:.4f}) eager form={ms['eager']:.4f} on {smi}")
    if not (bool(torch.isfinite(conv).all()) and err_c <= MAX_ERR_VS_PLAIN_BF16 * err_e):
        raise AssertionError(f"spt: convolution form {err_c} from f32, eager bf16 {err_e}")


PLAIN_KW = dict(fused_attention="never", fused_mlp="never")  # the ViTs' plain path

# (tag, b, heads, n_q, n_k, d): CvT-13's flash shapes at batch 64, the tier
# above n_k = 4096 (vit_tpu's flash_attention_v2) and ScalableViT's IWSA width.
FLASH_SHAPES = [
    ("CvT-13@224 stage 1", 64, 1, 3136, 784, 64),
    ("CvT-13@384 stage 1", 64, 1, 9216, 2304, 64),
    ("CvT-13@384 stage 2", 64, 3, 2304, 576, 64),
    ("n=8192, through the dispatcher", 4, 16, 8192, 8192, 64),
    ("n=4096, d=32", 64, 2, 4096, 4096, 32),
]
# CvT-13's attention shapes below the 1024 gate, where the plain path runs.
BELOW_GATE_SHAPES = [
    ("CvT-13@224 stage 2", 64, 3, 784, 196, 64),
    ("CvT-13@384 stage 3", 64, 6, 576, 144, 64),
    ("CvT-13@224 stage 3", 64, 6, 196, 49, 64),
]


def flash_inputs(torch, b, h, n_q, n_k, d, seed):
    """Seeded bf16 q, k, v and cotangent as CvT hands them over: q and the
    cotangent (b, h, n, d) views of channels-last (b, n, h·d) maps, k and v
    views of the two halves of one (b, n_k, 2·h·d) projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def fold(t):
        return t.reshape(b, t.shape[1], h, d).permute(0, 2, 1, 3)

    k, v = (fold(t) for t in rn(b, n_k, 2 * h * d).chunk(2, dim=-1))
    return fold(rn(b, n_q, h * d)), k, v, fold(rn(b, n_q, h * d))


def flash_bounds(b, h, n_q, n_k, dk, dv=None):
    """Bounds of the two flash kernels: the FLOPs of the function, two
    n_q x n_k products forward (q·kᵀ at width dk, P·v at dv) and five
    backward (the q·kᵀ recompute, dq and dk at dk; dO·vᵀ and dv at dv: the
    second q·kᵀ and dO·vᵀ of the two-pass split are the kernels' own
    recomputation, not the gradient's work); q, k, v (and out, lse, dout)
    read once, out and lse (dq, dk, dv) written once, bf16 with f32 lse."""
    dv = dk if dv is None else dv
    pairs = b * h * n_q * n_k
    q, o = 2 * b * h * n_q * dk, 2 * b * h * n_q * dv
    k, v = 2 * b * h * n_k * dk, 2 * b * h * n_k * dv
    lse = 4 * b * h * n_q
    return {"flash_attention": bound(2 * pairs * (dk + dv), q + k + v + o + lse),
            "flash_backward": bound(2 * pairs * (3 * dk + 2 * dv),
                                    2 * (q + k + v + o) + lse)}


def sdpa_backward(torch, F, q, k, v, do, scale):
    """Autograd through PyTorch's scaled_dot_product_attention for dq, dk, dv."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    y = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    return lambda: torch.autograd.grad(y, (qg, kg, vg), do, retain_graph=True)


def flash_phase(torch, results, smi):
    """The flash kernels at FLASH_SHAPES: out and lse against the plain
    version; dq, dk, dv against the plain backward fed the kernel's own out
    and lse, and twice bit for bit; times of the kernels, their plain
    versions and PyTorch's SDPA (autograd through it for the backward)."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops.attention import scaled_dot_product_attention

    for i, (tag, b, h, n_q, n_k, d) in enumerate(FLASH_SHAPES):
        q, k, v, do = flash_inputs(torch, b, h, n_q, n_k, d, seed=20 + i)
        scale = d ** -0.5
        shape = f"[{tag}: b={b} heads={h} n_q={n_q} n_k={n_k} d={d}]"
        before = fa.flash_attention.launches
        with torch.inference_mode():
            via = scaled_dot_product_attention(q, k, v, scale=scale) if n_k > 4096 else None
            out, lse = fa.flash_attention_forward(q, k, v, scale)
        torch.cuda.synchronize()
        if fa.flash_attention.launches != before + 1 + (via is not None):
            raise AssertionError(f"flash forward {shape}: launch counter did not move")
        if via is not None and not torch.equal(via, out):
            raise AssertionError(f"flash forward {shape}: the dispatcher's output differs")
        ref_out, ref_lse = fa.flash_attention_forward_reference(q, k, v, scale)
        err = check_outputs(torch, f"flash forward {shape}", (out,), (ref_out,), {})
        lse_err = (lse - ref_lse).abs().max().item()
        if not (lse.dtype == torch.float32 and lse_err <= LSE_ABS_TOL):
            raise AssertionError(f"flash forward {shape}: lse differs by {lse_err}")
        del ref_out, ref_lse
        before = fa.flash_backward.launches
        grads = fa.flash_backward(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        if fa.flash_backward.launches != before + 1:
            raise AssertionError(f"flash backward {shape}: launch counter did not move")
        bwd_err = check_outputs(torch, f"flash backward {shape}", grads,
                                fa.flash_backward_reference(q, k, v, out, lse, do, scale), {})
        again = fa.flash_backward(q, k, v, out, lse, do, scale)
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
            raise AssertionError(f"flash backward {shape}: two runs differ")
        del grads, again
        bounds = flash_bounds(b, h, n_q, n_k, d)
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_attention_forward(q, k, v, scale),
            "plain": lambda: fa.flash_attention_forward_reference(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)},
            rounds=3, calls=3)
        bwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_backward(q, k, v, out, lse, do, scale),
            "plain": lambda: fa.flash_backward_reference(q, k, v, out, lse, do, scale),
            "library": sdpa_backward(torch, F, q, k, v, do, scale)}, rounds=3, calls=3)
        fb, bb = bounds["flash_attention"], bounds["flash_backward"]
        log(f"flash {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| of the "
            f"plain version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g} (<= "
            f"{LSE_ABS_TOL}); dq, dk, dv (fed the kernel's out and lse) max|diff|={bwd_err:.6g}, "
            f"the same bits in two runs"
            + ("; the dispatcher launched it, the same bits" if via is not None else "")
            + f"; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"SDPA={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms kernel="
            f"{bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through SDPA="
            f"{bwd_ms['library']:.4f} bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("flash_attention", {})[tag] = dict(
            err=err, lse_err=lse_err, **fwd_ms, bound=fb)
        results.setdefault("flash_backward", {})[tag] = dict(err=bwd_err, **bwd_ms, bound=bb)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def below_gate_phase(torch, results, smi):
    """Below the 1024 gate, at BELOW_GATE_SHAPES, where ``"auto"`` runs the
    plain path: the flash kernels against the dispatcher's plain path
    (``plain_attention``; autograd through it for the backward) and SDPA, for
    the crossover a later change of the gate would rest on."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops.attention import plain_attention

    for i, (tag, b, h, n_q, n_k, d) in enumerate(BELOW_GATE_SHAPES):
        q, k, v, do = flash_inputs(torch, b, h, n_q, n_k, d, seed=40 + i)
        scale = d ** -0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        y = plain_attention(qg, kg, vg, scale=scale)
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_attention_forward(q, k, v, scale),
            "plain": lambda: plain_attention(q, k, v, scale=scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)},
            rounds=5, calls=10)
        bwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_backward(q, k, v, out, lse, do, scale),
            "plain": lambda: torch.autograd.grad(y, (qg, kg, vg), do, retain_graph=True),
            "library": sdpa_backward(torch, F, q, k, v, do, scale)}, rounds=5, calls=10)
        log(f"below the gate [{tag}: b={b} heads={h} n_q={n_q} n_k={n_k} d={d}]: forward ms "
            f"flash kernel={fwd_ms['kernel']:.4f} plain path={fwd_ms['plain']:.4f} "
            f"SDPA={fwd_ms['library']:.4f}; backward ms flash kernel={bwd_ms['kernel']:.4f} "
            f"autograd through the plain path={bwd_ms['plain']:.4f} autograd through SDPA="
            f"{bwd_ms['library']:.4f} on {smi}")
        results.setdefault("below_gate", {})[tag] = {"forward": fwd_ms, "backward": bwd_ms}


# T2T-ViT @224 as benchmarks/run_benchmarks.py:55-56 builds it: dim 512, depth
# 5, 8 heads of 64, mlp 512, the default t2t_layers ((7, 4), (3, 2), (3, 2)).
T2T = dict(image_size=224, num_classes=1000, dim=512, depth=5, heads=8, mlp_dim=512)
T2T_BATCH = 64
# Its token transformers at batch 64: (tag, tokens an image, width), one head
# as wide as the model and an MLP as wide (3·7·7 = 147 over 56², 147·3·3 = 1323
# over 28²); the first one's attention on the flash tier (3136 >= 1024, 147
# padded to 192), the second one's below it.
T2T_TOKEN_SHAPES = [("T2T-ViT@224 token transformer 0", 3136, 147),
                    ("T2T-ViT@224 token transformer 1", 784, 1323)]
T2T_FLASH_WIDTH = 192  # ops/attention.py _flash: 147 zero-padded to a multiple of 64


def t2t_kernel_phase(torch, results, smi):
    """T2T-ViT's token transformers' kernels at batch 64, seeded bf16
    inputs.  The flash forward and backward at (64, 1, 3136, 3136) from
    147-wide q, k, v (views of one to_qkv output) zero-padded to 192 as
    ``ops/attention.py``'s ``_flash`` pads them, and once through the
    dispatcher: out and lse against the plain version, dq, dk, dv against
    the plain backward fed the kernel's out and lse, each twice bit for bit,
    timed beside SDPA on the same inputs (autograd through it for the
    backward), bounds at the true width 147.  The fused MLP at d = hidden =
    147 over 200,704 rows and 1323 over 50,176: the serving and the training
    forward (xn and h at the padded widths, their pad columns 0) and the
    backward fed the training forward's residuals and the padded parameter
    copies, as the op's backward runs, against the plain versions, twice bit
    for bit, its LayerNorm backward on layernorm.cu's passes; timed beside
    the bf16 modules (autograd through them for the backward's own outputs)."""
    import torch.nn.functional as F

    from vit_tpu_torch.layers.common import MLP, LayerNorm
    from vit_tpu_torch.ops import flash_attention as fa, fused_mlp as fm
    from vit_tpu_torch.ops.attention import scaled_dot_product_attention

    dev, dt, eps, b = torch.device("cuda"), torch.bfloat16, 1e-3, T2T_BATCH
    g = torch.Generator(device=dev).manual_seed(16)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    tag, n, d = T2T_TOKEN_SHAPES[0]
    q, k, v = (t.reshape(b, n, 1, d).transpose(1, 2) for t in rn(b, n, 3 * d).chunk(3, dim=-1))
    qp, kp, vp, dop = (F.pad(t, (0, T2T_FLASH_WIDTH - d)) for t in (q, k, v, rn(b, 1, n, d)))
    scale = d ** -0.5
    shape = f"[{tag}: b={b} heads=1 n={n} d={d} padded to {T2T_FLASH_WIDTH}]"
    before = fa.flash_attention.launches
    with torch.inference_mode():
        via = scaled_dot_product_attention(q, k, v, scale=scale)
        out, lse = fa.flash_attention_forward(qp, kp, vp, scale)
        again = fa.flash_attention_forward(qp, kp, vp, scale)
    torch.cuda.synchronize()
    if fa.flash_attention.launches != before + 3:
        raise AssertionError(f"flash forward {shape}: launch counter did not move")
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"flash forward {shape}: two runs differ")
    if not torch.equal(via, out[..., :d]) or bool(out[..., d:].any()):
        raise AssertionError(f"flash forward {shape}: the dispatcher's output differs, or a "
                             f"pad column is not 0")
    ref_out, ref_lse = fa.flash_attention_forward_reference(qp, kp, vp, scale)
    err = check_outputs(torch, f"flash forward {shape}", (out,), (ref_out,), {})
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"flash forward {shape}: lse differs by {lse_err}")
    del ref_out, ref_lse, again
    before = fa.flash_backward.launches
    grads = fa.flash_backward(qp, kp, vp, out, lse, dop, scale)
    torch.cuda.synchronize()
    if fa.flash_backward.launches != before + 1:
        raise AssertionError(f"flash backward {shape}: launch counter did not move")
    bwd_err = check_outputs(torch, f"flash backward {shape}", grads,
                            fa.flash_backward_reference(qp, kp, vp, out, lse, dop, scale), {})
    if not all(torch.equal(a, b_) for a, b_ in
               zip(grads, fa.flash_backward(qp, kp, vp, out, lse, dop, scale))):
        raise AssertionError(f"flash backward {shape}: two runs differ")
    del grads
    bounds = flash_bounds(b, 1, n, n, d)  # the function's work, at the true width
    fwd_ms = interleaved_medians(torch, {
        "kernel": lambda: fa.flash_attention_forward(qp, kp, vp, scale),
        "plain": lambda: fa.flash_attention_forward_reference(qp, kp, vp, scale),
        "library": lambda: F.scaled_dot_product_attention(qp, kp, vp, scale=scale)},
        rounds=3, calls=3)
    bwd_ms = interleaved_medians(torch, {
        "kernel": lambda: fa.flash_backward(qp, kp, vp, out, lse, dop, scale),
        "plain": lambda: fa.flash_backward_reference(qp, kp, vp, out, lse, dop, scale),
        "library": sdpa_backward(torch, F, qp, kp, vp, dop, scale)}, rounds=3, calls=3)
    fb, bb = bounds["flash_attention"], bounds["flash_backward"]
    log(f"flash {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| of the plain "
        f"version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g} (<= {LSE_ABS_TOL}); "
        f"the dispatcher's 147-wide output the same bits, pad columns 0; dq, dk, dv (fed the "
        f"kernel's out and lse) max|diff|={bwd_err:.6g}; each the same bits in two runs; forward "
        f"ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} SDPA (the same padded "
        f"inputs)={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}, at width {d}); backward "
        f"ms kernel={bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through SDPA="
        f"{bwd_ms['library']:.4f} bound={bb[0]:.4f} ({bb[1]}) on {smi}")
    results.setdefault("flash_attention", {})[tag] = dict(err=err, lse_err=lse_err, **fwd_ms,
                                                          bound=fb)
    results.setdefault("flash_backward", {})[tag] = dict(err=bwd_err, **bwd_ms, bound=bb)
    del q, k, v, qp, kp, vp, dop, out, lse
    torch.cuda.empty_cache()

    for tag, n, d in T2T_TOKEN_SHAPES:
        rows, shape = b * n, f"[{tag}: rows={b * n} d=hidden={d}]"
        x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
        gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dt), rn(d, scale=0.1)
        w = (rn(d, d, scale=d ** -0.5), rn(d, scale=0.1), rn(d, d, scale=d ** -0.5),
             rn(d, scale=0.1))
        ops = fm.kernel_operands(gamma, beta, *w)  # the op's padded copies, kept for its backward
        norm, mlp = LayerNorm(d, device=dev, dtype=dt), MLP(d, d, device=dev, dtype=dt)
        with torch.no_grad():
            for prm, t in zip((norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias,
                               mlp.fc2.weight, mlp.fc2.bias), (gamma, beta, *w)):
                prm.copy_(t)

        def serve():
            return fm.fused_mlp(x, gamma, beta, *w)

        def plain():
            return fm.fused_mlp_reference(x, gamma, beta, *w, eps)

        with torch.inference_mode():
            before = fm.fused_mlp.launches
            y = serve()
            torch.cuda.synchronize()
            if fm.fused_mlp.launches != before + 1:
                raise AssertionError(f"fused_mlp {shape}: launch counter did not move")
            if not torch.equal(y, serve()):
                raise AssertionError(f"fused_mlp {shape}: two runs differ")
            err = check_outputs(torch, f"fused_mlp {shape}", (y,), (plain(),), {0: x})
            train = fm._launch_forward(x, *ops, eps, save_residuals=True)
            ref = fm.fused_mlp_forward_reference(x, gamma, beta, *w, eps)
            train_err = check_outputs(torch, f"fused_mlp training forward {shape}",
                                      (train[0], train[1][..., :d], train[2][..., :d]), ref,
                                      {0: x})
            if bool(train[1][..., d:].any()) or bool(train[2][..., d:].any()) or not all(
                    torch.equal(a, c) for a, c in
                    zip(train, fm._launch_forward(x, *ops, eps, save_residuals=True))):
                raise AssertionError(f"fused_mlp training forward {shape}: a pad column of xn "
                                     f"or h is not 0, or two runs differ")
            fwd_ms = interleaved_medians(torch, {"kernel": serve, "plain": plain,
                                                 "library": lambda: x + mlp(norm(x))},
                                         rounds=5, calls=5)
        h = train[2]

        def kernel_bwd():
            return fm.fused_mlp_backward(dy, x, h, ops[0], ops[2], ops[4], eps)

        def plain_bwd():
            return fm.fused_mlp_backward_reference(dy, x, ref[2], gamma, w[0], w[2], eps)

        before = fm.fused_mlp_backward.launches
        got = kernel_bwd()
        torch.cuda.synchronize()
        if fm.fused_mlp_backward.launches != before + 1:
            raise AssertionError(f"fused_mlp_bwd {shape}: launch counter did not move")
        crop = (got[0], got[1][..., :d], got[2][..., :d], *got[3:5], got[5][:d], got[6])
        bwd_err = check_outputs(torch, f"fused_mlp_bwd {shape}", crop, plain_bwd(), {0: dy})
        if not all(torch.equal(a, c) for a, c in zip(got, kernel_bwd())):
            raise AssertionError(f"fused_mlp_bwd {shape}: two runs differ")
        counts = counted_launches(torch, kernel_bwd)
        if counts["ln_epilogue"] or counts["ln_passes"] != 1:
            raise AssertionError(f"fused_mlp_bwd {shape}: launches a call {counts}: the "
                                 f"LayerNorm backward's passes once, its dgrad epilogue never, "
                                 f"expected (d % 256 != 0)")
        xg = x.detach().requires_grad_()
        out = xg + mlp(norm(xg))
        inputs = [xg, norm.weight, norm.bias, mlp.fc1.bias, mlp.fc2.bias]
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel_bwd, "plain": plain_bwd,
            "library": lambda: torch.autograd.grad(out, inputs, dy, retain_graph=True)},
            rounds=5, calls=5)
        bounds = mlp_bounds(rows, d, d)
        fb, bb = bounds["fused_mlp"], bounds["fused_mlp_bwd"]
        log(f"fused MLP {shape} (kernel widths {ops[2].shape[1]} and {ops[2].shape[0]}): serving "
            f"y max|kernel-plain|={err:.6g}, training forward y, xn, h {train_err:.6g} (pad "
            f"columns 0), backward fed its residuals and the padded copies {bwd_err:.6g}, each "
            f"within one unit plus 2e-2*max|its own part| and the same bits in two runs; "
            f"LayerNorm backward on its passes ({counts}); forward ms kernel="
            f"{fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} bf16 modules="
            f"{fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms kernel="
            f"{bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through the bf16 "
            f"modules (dx, dγ, dβ, db1, db2)={bwd_ms['library']:.4f} bound={bb[0]:.4f} ({bb[1]}) "
            f"on {smi}")
        results.setdefault("fused_mlp", {})[tag] = dict(err=err, train_fwd_err=train_err,
                                                        **fwd_ms, bound=fb)
        results.setdefault("fused_mlp_bwd", {})[tag] = dict(err=bwd_err, **bwd_ms, bound=bb)
        del x, dy, train, ref, h, got, crop, out, xg, inputs
        torch.cuda.empty_cache()


# ScalableViT as benchmarks/run_benchmarks.py:140-144 builds it, at 256 px.
SCALABLE = dict(num_classes=1000, dim=64, heads=(2, 4, 8, 16), depth=(2, 2, 8, 2),
                ssa_dim_key=(40, 40, 40, 32), reduction_factor=(8, 4, 2, 1),
                window_size=(64, 32, None, None))
SCALABLE_SIZE = 256
# (tag, b, n, c, heads, n_k, dh_k, dh_v): its SSA blocks at batch 64.
SSA_SHAPES = [
    ("ScalableViT stage 1", 64, 4096, 64, 2, 64, 40, 32),
    ("ScalableViT stage 2", 64, 1024, 128, 4, 64, 40, 32),
    ("ScalableViT stage 3", 64, 256, 256, 8, 64, 40, 32),
    ("ScalableViT stage 4", 64, 64, 512, 16, 64, 32, 32),
]
# The cross-attention phase's shapes: the SSA_SHAPES, then ScalableViT at 384
# px, stage 1 (96² queries, 12² = 144 keys: past cross_fwd's 128, so the
# three-launch forward), batch 16.
CROSS_SHAPES = SSA_SHAPES + [("ScalableViT@384 stage 1", 16, 9216, 64, 2, 144, 40, 32)]
# (tag, b, n, heads, dk, dv): the packed flash op at its IWSA windows (stages
# 1 and 2, batch 64), and with q/k wider than v.
PACKED_SHAPES = [
    ("ScalableViT IWSA stage 1", 64, 4096, 2, 32, 32),
    ("ScalableViT IWSA stage 2", 64, 1024, 4, 32, 32),
    ("dk 40, dv 32", 64, 1024, 2, 40, 32),
]


def cross_bounds(b, n, c, heads, n_k, dh_k, dh_v):
    """Bounds of the cross-attention block: the q and output GEMMs and the
    flash FLOPs (:func:`flash_bounds`), forward; the doattn and dxn GEMMs and
    the flash backward's, backward.  Bytes: forward x, xn, Wq, k, v, Wo, bo in
    and y out; backward dy, q, k, v, oattn, lse, Wq, Wo in and dxn, dq, dk,
    dv, f32 dbo out (bf16 tensors, f32 lse)."""
    rows, hk, hv = b * n, heads * dh_k, heads * dh_v
    pairs = b * heads * n * n_k
    act, w = 2 * rows * c, 2 * c * (hk + hv)
    kv = 2 * b * n_k * (hk + hv)
    gemms = 2 * rows * c * (hk + hv)
    return {
        "fused_cross_attention": bound(gemms + 2 * pairs * (dh_k + dh_v),
                                       3 * act + kv + w + 2 * c),
        "fused_cross_attention_bwd": bound(
            gemms + 2 * pairs * (3 * dh_k + 2 * dh_v),
            2 * act + 2 * kv + 2 * rows * (2 * hk + hv) + 4 * b * heads * n + w + 4 * c),
    }


def cross_attention_phase(torch, results, smi, shapes=None):
    """The fused cross-attention block at ``shapes`` (CROSS_SHAPES by
    default; Twins-SVT's TWINS_GLOBAL_SHAPES), bf16 inputs from a
    seeded generator: the serving forward on the route the library gives
    the shape (one cross_fwd launch keeping no residual below 256 channels,
    cross_fwd and the y GEMM keeping oattn from 256, the three launches
    keeping q, oattn and lse past 128 keys) and the training
    forward (y, q, oattn; lse against the plain attention on the kernel's q)
    against the plain version, each twice bit for bit; the backward, fed the
    training forward's residuals, against the plain backward on them (dxn,
    dq, dk, dv within one unit plus 2e-2·max|ref|, dbo within
    DBIAS_REL_TOL·max|ref|), twice bit for bit.  Times of the kernels, the
    plain versions and the library composition (F.linear +
    scaled_dot_product_attention + F.linear in bf16, autograd through it for
    the backward), and the bounds."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.ops import flash_attention_packed as fap
    from vit_tpu_torch.ops import fused_cross_attention as fca
    from vit_tpu_torch.ops._shared import weight_grad

    for i, (tag, b, n, c, heads, n_k, dh_k, dh_v) in enumerate(shapes or CROSS_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(50 + i)

        def rn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

        hk, hv = heads * dh_k, heads * dh_v
        args = (rn(b, n, c), rn(b, n, c), rn(hk, c, scale=c ** -0.5), rn(b, n_k, hk),
                rn(b, n_k, hv), rn(c, hv, scale=hv ** -0.5), rn(c, scale=0.1))
        x, xn, wq, k, v, wo, bo = args
        dy = rn(b, n, c, scale=0.1)
        cfg = (heads, dh_k, dh_v)
        scale = dh_k ** -0.5
        shape = f"[{tag}: b={b} n={n} c={c} heads={heads} n_k={n_k} dh_k={dh_k} dh_v={dh_v}]"
        # The forward's route (csrc/fused_cross_attention.cu cross_mode): 1,
        # the one cross_fwd kernel (stages 1-2); 2, cross_fwd then the y GEMM
        # (c >= 256: stages 3-4); 0, the three launches (n_k > 128: 384 px).
        route = _build.load().vit_fused_cross_attention_fused(b, n, n_k, c, heads, dh_k, dh_v)
        expected = 0 if n_k > 128 else 1 if c < 256 else 2
        # The backward's (cross_bwd_plan): 1, one cross_bwd kernel and its
        # reduction (c <= 128 and heads·dh_k <= 256: ScalableViT's stages
        # 1-2); 2, cross_bwd between launch_dgrad's two dgrads (its stages
        # 3-4; Twins-SVT's four, heads·dh_k 512); 0, the four steps (n_k >
        # 128: 384 px).
        bwd_route = fca.backward_route(b, n, n_k, c, heads, dh_k, dh_v)
        if bwd_route != (0 if n_k > 128 else 1 if c <= 128 and heads * dh_k <= 256 else 2):
            raise AssertionError(f"cross-attention backward {shape}: route {bwd_route}")
        with torch.inference_mode():
            before = fca.fused_cross_attention.launches
            out = fca.fused_cross_attention(*args, *cfg)
            torch.cuda.synchronize()
            if fca.fused_cross_attention.launches != before + 1:
                raise AssertionError(f"cross-attention {shape}: launch counter did not move")
            err, excess, tol = block_error(torch, out, fca.fused_cross_attention_reference(
                *args, *cfg), x)
            if not torch.equal(out, fca.fused_cross_attention(*args, *cfg)):
                raise AssertionError(f"cross-attention {shape}: two serving runs differ")
            kept = [t is not None for t in fca._launch_forward(*args, *cfg, scale)[1:]]
        if not (bool(torch.isfinite(out).all()) and excess <= tol):
            raise AssertionError(f"cross-attention {shape}: differs from its plain version by "
                                 f"{excess} beyond one output unit > {tol}")
        if route != expected or kept != [route == 0, route != 1, route == 0]:
            raise AssertionError(f"cross-attention {shape}: route {route}, serving kept "
                                 f"(q, oattn, lse) {kept}")
        train = fca._launch_forward(*args, *cfg, scale, training=True)
        ref = fca.fused_cross_attention_forward_reference(*args, *cfg)
        train_err = check_outputs(torch, f"cross-attention training forward {shape}", train[:3],
                                  ref[:3], {0: x})
        if not all(torch.equal(a, b_) for a, b_ in
                   zip(train, fca._launch_forward(*args, *cfg, scale, training=True))):
            raise AssertionError(f"cross-attention training forward {shape}: two runs differ")
        _, q, oattn, lse = train
        # lse against the plain attention on the kernel's own q: a one-unit
        # flip of a q element between the two q GEMMs moves a logit, and so
        # lse, by up to a unit of q times |k|·scale (5e-3 here).
        lse_err = (lse - fap.flash_attention_packed_forward_reference(q, k, v, heads, scale)[1]
                   ).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"cross-attention training forward {shape}: lse differs by "
                                 f"{lse_err}")
        del ref

        def kernel(route=None):
            return fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg,
                                                      route=route)

        def whole():
            out = kernel()
            return out, weight_grad(out[1], xn), weight_grad(dy, oattn)

        def plain(route=bwd_route):  # the four steps take D from the stored output
            return fca.fused_cross_attention_backward_reference(
                dy, q, k, v, oattn, lse, wq, wo, *cfg, stored_output_d=route == 0)

        before = fca.fused_cross_attention_backward.launches
        on_route = fca.BACKWARD_ROUTES[bwd_route].launches
        got = kernel()
        torch.cuda.synchronize()
        if fca.fused_cross_attention_backward.launches != before + 1 or \
                fca.BACKWARD_ROUTES[bwd_route].launches != on_route + 1:
            raise AssertionError(f"cross-attention backward {shape}: launch counter did not move")
        want = plain()
        bwd_err = check_outputs(torch, f"cross-attention backward {shape}", got[:4], want[:4], {})
        if n_k == 1 and any(bool(t.any()) for t in (got[0], got[1], got[2])):
            raise AssertionError(f"cross-attention backward {shape}: over one key dxn, dq and "
                                 f"dk must be exactly 0 (p = 1, ds = 0)")
        dbo_err = check_dbias(torch, f"cross-attention backward {shape}", got[4], want[4], "dbo")
        if not all(torch.equal(a, b_) for a, b_ in zip(got, kernel())):
            raise AssertionError(f"cross-attention backward {shape}: two runs differ")
        del got, want
        # The other designs at this shape, each held against its plain version:
        # the four steps (the earlier design, route 0) wherever cross_bwd runs,
        # and cross_bwd split from its dgrads (route 2) where it takes them.
        designs = {name: r for name, r in (("four steps", 0), ("split", 2))
                   if bwd_route != 0 and r != bwd_route}
        for name, r in designs.items():
            got, want = kernel(r), plain(r)
            # Over one key (Twins-SVT's stage 4) dq, dk and dxn are exactly 0:
            # cross_bwd gives 0 (held above), but the four steps take p from
            # the forward's lse and D from the stored output, both 1 and dp
            # only to rounding, so their dq, dk, dxn and the plain version's
            # are rounding noise about 0 that no share of max|ref| bounds;
            # there the four steps are held on dv and dbo.
            held = [3] if n_k == 1 and r == 0 else [0, 1, 2, 3]
            check_outputs(torch, f"cross-attention backward {shape}, {name}",
                          [got[i] for i in held], [want[i] for i in held], {})
            check_dbias(torch, f"cross-attention backward {shape}, {name}", got[4], want[4],
                        "dbo")
            del got, want
        if bwd_route != 0:  # where the device time goes, launch by launch, on both designs
            for name, r in ((f"route {bwd_route}", None), ("four steps", 0)):
                rows = launch_breakdown(torch, lambda: kernel(r))
                log(f"cross-attention backward {shape}, {name}: "
                    + (f"{sum(cnt for _, cnt in rows.values()):g} launches, device ms "
                       f"{sum(ms for ms, _ in rows.values()):.4f}: " if rows else "")
                    + f"{breakdown_text(rows)} on {smi}")

        def library(xn_, wq_, k_, v_, wo_, bo_):
            o = F.scaled_dot_product_attention(fap.split_heads(F.linear(xn_, wq_), heads),
                                               fap.split_heads(k_, heads),
                                               fap.split_heads(v_, heads), scale=scale)
            return x + F.linear(fap.merge_heads(o), wo_, bo_)

        leaves = [t.detach().requires_grad_() for t in (xn, wq, k, v, wo, bo)]
        y_lib = library(*leaves)
        own = [leaves[0], leaves[2], leaves[3], leaves[5]]  # the kernel's own outputs' inputs
        with torch.inference_mode():
            fwd_ms = interleaved_medians(torch, {
                "kernel": lambda: fca.fused_cross_attention(*args, *cfg),
                "plain": lambda: fca.fused_cross_attention_reference(*args, *cfg),
                "library": lambda: library(xn, wq, k, v, wo, bo)}, rounds=5, calls=5)
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain, "whole": whole,
            **{name: (lambda r=r: kernel(r)) for name, r in designs.items()},
            "library": lambda: torch.autograd.grad(y_lib, own, dy, retain_graph=True),
            "library_whole": lambda: torch.autograd.grad(y_lib, leaves, dy, retain_graph=True)},
            rounds=5, calls=5)
        bounds = cross_bounds(b, n, c, heads, n_k, dh_k, dh_v)
        fb, bb = bounds["fused_cross_attention"], bounds["fused_cross_attention_bwd"]
        log(f"cross-attention {shape}: forward "
            + ("one cross_fwd launch, serving keeps no residual" if route == 1 else
               "cross_fwd, then gemm_wgmma for y from oattn, serving keeps oattn only"
               if route == 2 else "three launches (linear.cu q GEMM, the (dh_k, dh_v) flash "
               "forward, linear.cu output GEMM), serving keeps q, oattn and lse")
            + f"; serving y within one bf16 unit plus 2e-2*max|ref-x|, "
            f"max|kernel-plain|={err:.6g}; training forward (y, q, oattn) max {train_err:.6g}, "
            f"lse {lse_err:.3g}; backward "
            + ("one cross_bwd kernel and its reduction" if bwd_route == 1 else
               f"{'gemm_wgmma' if heads * dh_v >= 256 else 'linear.cu'} dy·Wo, cross_bwd over "
               f"head groups, {'gemm_wgmma' if c >= 256 else 'linear.cu'} dq·Wq, column sums, "
               "the reduction" if bwd_route == 2 else "four steps (linear.cu dy·Wo, the "
               "(dh_k, dh_v) flash backward, linear.cu dq·Wq, column sums)")
            + f" (dxn, dq, dk, dv) fed the forward's residuals max "
            f"{bwd_err:.6g}, dbo {dbo_err:.3g} (<= {DBIAS_REL_TOL}*max|ref|), the same bits in "
            f"two runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"F.linear+SDPA+F.linear={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); "
            f"backward ms kernel={bwd_ms['kernel']:.4f} "
            + "".join(f"{name}={bwd_ms[name]:.4f} " for name in designs)
            + f"plain={bwd_ms['plain']:.4f} autograd "
            f"through the library composition={bwd_ms['library']:.4f}; with dWq, dWo: "
            f"kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd={bwd_ms['library_whole']:.4f}; "
            f"bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("fused_cross_attention", {})[tag] = dict(
            err=max(err, train_err), lse_err=lse_err, route=route, **fwd_ms, bound=fb)
        results.setdefault("fused_cross_attention_bwd", {})[tag] = dict(
            err=bwd_err, dbo_err=dbo_err, route=bwd_route, **bwd_ms, bound=bb)
        del args, x, xn, wq, k, v, wo, bo, dy, train, q, oattn, lse, leaves, own, y_lib
        torch.cuda.empty_cache()


# Twins-SVT as benchmarks/run_benchmarks.py:65 builds it, TwinsSVT(num_classes=
# 1000): stage widths 64/128/256/512, patch sizes 4/2/2/2, depths 1/1/5/4 after
# each stage's one-block pre-transformer, 8 heads of 64, 7 x 7 local windows,
# global k 7, PEG kernel 3; at 224 px and the benchmark's batch 64
# (run_benchmarks.py:337).
TWINS = dict(num_classes=1000)
TWINS_SIZE = 224
TWINS_BATCH = 64
TWINS_BLOCKS = (2, 2, 6, 5)  # blocks a stage: the pre-transformer's one and depth's
TWINS_EPS = 1e-5             # its ChannelLayerNorms'
# (tag, groups, c): its local attentions at batch 64, the 7 x 7 windows (49
# tokens) folded into the batch, 8 heads of 64 (inner 512) over c channels;
# its conv-MLPs over the same groups·49 rows, c / 4c wide (stage 4: 3136 rows
# of 512 / 2048, no local attention).
TWINS_LOCAL_SHAPES = [
    ("Twins-SVT stage 1", 4096, 64),
    ("Twins-SVT stage 2", 1024, 128),
    ("Twins-SVT stage 3", 256, 256),
    ("Twins-SVT stage 4", 64, 512),
]
# (tag, b, n, c, heads, n_k, dh_k, dh_v): its global attentions at batch 64,
# keys from the 7 x 7 stride-7 reduction: 8², 4², 2², 1.
TWINS_GLOBAL_SHAPES = [
    ("Twins-SVT stage 1", 64, 3136, 64, 8, 64, 64, 64),
    ("Twins-SVT stage 2", 64, 784, 128, 8, 16, 64, 64),
    ("Twins-SVT stage 3", 64, 196, 256, 8, 4, 64, 64),
    ("Twins-SVT stage 4", 64, 49, 512, 8, 1, 64, 64),
]


def twins_kernel_phase(torch, results, smi):
    """Rows 1-4 and 6 at Twins-SVT's shapes, batch 64, seeded bf16 inputs:
    at each stage the fused MLP (rows groups·49, c / 4c) and, at stages 1-3,
    the attention block over the folded windows (groups × 49 × c, 8 heads of
    64, eps 1e-5), serving and training forwards and backwards as
    :func:`kernel_phase` and :func:`backward_phase` hold them (the
    LayerNorm backward on layernorm.cu's passes at c 64 and 128, the dgrad's
    epilogue from 256); then the cross-attention block at its four global
    attentions (:func:`cross_attention_phase`), each stage's forward and
    backward route printed."""
    for tag, groups, c in TWINS_LOCAL_SHAPES:
        kernels = ("fused_mlp",) if c == 512 else ("fused_mlp", "fused_attention_block")
        for phase in (kernel_phase, backward_phase):
            phase(torch, tag, groups, 49, c, 8, 64, 4 * c, results, eps=TWINS_EPS,
                  kernels=kernels)
        torch.cuda.empty_cache()
    cross_attention_phase(torch, results, smi, TWINS_GLOBAL_SHAPES)
    twins_conv_phase(torch, smi)


def twins_conv_phase(torch, smi):
    """The library convolutions of Twins-SVT's attentions at batch 64,
    outside every kernel here as in ``vit_tpu``: at each stage the global
    attention's k/v reduction (7 x 7, stride 7, c -> 1024, no bias) and the
    PEG (3 x 3 depthwise, SAME), bf16 NHWC through the port's ``Conv``
    (cuDNN on the channels_last view); device ms of the forward and of the
    backward (input and weight gradients, autograd)."""
    from vit_tpu_torch.layers.common import Conv, GroupedConv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    times = {}
    for (tag, b, n, c, *_), side in zip(TWINS_GLOBAL_SHAPES, (56, 28, 14, 7)):
        x = torch.randn(b, side, side, c, generator=g, device=dev).to(torch.bfloat16)
        x.requires_grad_()
        for name, conv in (("k/v 7x7/7", Conv(c, 1024, 7, 7, use_bias=False, device=dev,
                                              dtype=torch.bfloat16, generator=g)),
                           ("PEG 3x3 depthwise", GroupedConv(c, 3, device=dev,
                                                             dtype=torch.bfloat16,
                                                             generator=g))):
            y = conv(x)
            dy = torch.randn_like(y)
            params = [x, *conv.parameters()]
            with torch.no_grad():
                fwd = interleaved_medians(torch, {"forward": lambda: conv(x)}, rounds=3,
                                          calls=3)["forward"]
            bwd = interleaved_medians(torch, {"backward": lambda: torch.autograd.grad(
                y, params, dy, retain_graph=True)}, rounds=3, calls=3)["backward"]
            times[f"{tag} {name}"] = {"forward": round(fwd, 4), "backward": round(bwd, 4)}
            del y, dy
        del x
    torch.cuda.empty_cache()
    log(f"Twins-SVT's library convolutions (cuDNN, bf16 NHWC, batch 64), ms on {smi}: "
        + json.dumps(times))


# CrossFormer as benchmarks/run_benchmarks.py:66 builds it, CrossFormer(
# num_classes=1000), vit_tpu's defaults: dims 64/128/256/512, depths 2/2/8/2,
# global windows 8/4/2/1, local windows 7, cross-embed kernels (4, 8, 16, 32)
# at stride 4 and (2, 4) at stride 2, heads of 32, MLP mult 4; at 224 px and
# the benchmark's batch 64 (run_benchmarks.py:337).
CROSSFORMER = dict(num_classes=1000)
CROSSFORMER_SIZE = 224
CROSSFORMER_BATCH = 64
CROSSFORMER_DEPTH = (2, 2, 8, 2)
CROSSFORMER_GLOBAL = (8, 4, 2, 1)
CROSSFORMER_EPS = 1e-5  # its ChannelLayerNorms'
# (tag, groups, n, c): its attentions on the biased block at batch 64, the
# windows folded into the batch, c / 32 heads of 32, a (1, n, n) position
# bias the heads share: short 7 x 7 windows at every stage, long dilated
# windows of 8 x 8 and 4 x 4 tokens at stages 1-2 (stages 3-4's 2 x 2 and
# 1 x 1 take the plain modules by vit_tpu's n < 8 gate).  Its MLPs take the
# fused MLP at TWINS_LOCAL_SHAPES' rows and widths.
CROSSFORMER_WINDOWS = [
    ("CrossFormer short stage 1", 4096, 49, 64),
    ("CrossFormer short stage 2", 1024, 49, 128),
    ("CrossFormer short stage 3", 256, 49, 256),
    ("CrossFormer short stage 4", 64, 49, 512),
    ("CrossFormer long stage 1", 3136, 64, 64),
    ("CrossFormer long stage 2", 3136, 16, 128),
]


def crossformer_kernel_phase(torch, results, smi):
    """Row 5 at CrossFormer's windows (CROSSFORMER_WINDOWS), batch 64, seeded
    bf16 inputs and a shared random f32 bias that asks for dbias, eps 1e-5:
    the serving and the training forward and the backward as
    :func:`biased_phase` holds them (each result twice bit for bit, dbias
    within DBIAS_REL_TOL of the short route's own, its distance from the TPU
    kernel's rounding points printed), timed beside the unbiased kernel, the
    plain version and the bf16 modules with SDPA; then the position bias and
    the folds around it (:func:`crossformer_pieces_phase`) and the stem
    (:func:`crossformer_stem_phase`)."""
    for tag, groups, n, c in CROSSFORMER_WINDOWS:
        biased_phase(torch, groups, n, c, c // 32, 32, 4 * c, results, tag=tag,
                     eps=CROSSFORMER_EPS, kinds=("shared",))
        torch.cuda.empty_cache()
    crossformer_pieces_phase(torch, smi)
    crossformer_stem_phase(torch, smi)


def crossformer_pieces_phase(torch, smi):
    """What each CrossFormer attention runs around the block, at stage 1
    (c 64, batch 64), both kinds: the dynamic position bias (the DPB MLP
    over the (2w+1)² coordinates in bf16, gathered to the f32 (1, n, n)
    bias) forward, and its backward from a dbias, launch by launch; and the
    fold of the 56 x 56 map into windows and its inverse (strided permutes
    made contiguous), timed against their bound, the map's bytes read and
    written once each way.  Every attention call computes the DPB once, 28
    a forward."""
    from vit_tpu_torch.models.crossformer import CrossFormerAttention, _fold, _unfold

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(25)
    b, side, c = CROSSFORMER_BATCH, CROSSFORMER_SIZE // 4, 64
    x = torch.randn(b, side, side, c, generator=g, device=dev).to(dt)
    limit, by = bound(0, 2 * x.numel() * x.element_size())
    for kind, w in (("short", 7), ("long", CROSSFORMER_GLOBAL[0])):
        attn = CrossFormerAttention(c, kind, w, device=dev, generator=g)
        params = list(attn.dpb.parameters())

        def dpb_forward():
            return attn.position_bias(dt).float()[None].contiguous()

        bias = dpb_forward()
        dbias = torch.randn_like(bias)

        def dpb_backward():
            return torch.autograd.grad(bias, params, dbias, retain_graph=True)

        folded = _fold(x, kind, w)
        if not torch.equal(_unfold(folded, kind, b, side, side, w), x):
            raise AssertionError(f"CrossFormer {kind} fold: its inverse does not give the map")
        with torch.no_grad():
            fwd_rows = launch_breakdown(torch, dpb_forward)
        bwd_rows = launch_breakdown(torch, dpb_backward)
        ms = interleaved_medians(torch, {
            "fold": lambda: _fold(x, kind, w),
            "unfold": lambda: _unfold(folded, kind, b, side, side, w)}, rounds=5, calls=10)
        log(f"CrossFormer {kind} attention's pieces at stage 1 [w={w}, n={w * w}, "
            f"{folded.shape[0]} groups, c={c}]: the position bias forward "
            f"{breakdown_text(fwd_rows)}; its backward from dbias {breakdown_text(bwd_rows)} "
            f"(device ms and launches a call, 28 calls a forward and a backward a step); fold "
            f"{ms['fold']:.4f} ms, unfold {ms['unfold']:.4f} ms, bound {limit:.4f} ({by}, the "
            f"map read and written once); on {smi}")
        del bias, dbias, folded
    del x
    torch.cuda.empty_cache()


def crossformer_stem_phase(torch, smi):
    """CrossFormer's cross-embedding layers at stage 1 (224² x 3 -> 56² x 64,
    kernels 4/8/16/32 at stride 4) and stage 2 (56² x 64 -> 28² x 128, 2/4 at
    stride 2), batch 64, bf16 NHWC on cuDNN, library calls outside every
    kernel here as in vit_tpu: the form the layer takes, (b) space-to-depth,
    against (a) the merged strided convolution on the same weights, within
    one bf16 unit plus 2e-2 of max|ref|; device ms of the forward and of the
    backward (autograd: the kernels' and biases' gradients, the map's at
    stage 2) of (b), (a) and (c), the separate convolutions concatenated."""
    from vit_tpu_torch.models.crossformer import CrossEmbedLayer, stem_strided

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(24)
    times = {}
    for tag, side, cin, cout, kernels, stride in (
            ("stage 1", CROSSFORMER_SIZE, 3, 64, (4, 8, 16, 32), 4),
            ("stage 2", CROSSFORMER_SIZE // 4, 64, 128, (2, 4), 2)):
        layer = CrossEmbedLayer(cin, cout, kernels, stride, device=dev, generator=g)
        x = torch.randn(CROSSFORMER_BATCH, side, side, cin, generator=g, device=dev).to(dt)
        x.requires_grad_(tag != "stage 1")
        if layer.form(side, side) != "space_to_depth":
            raise AssertionError(f"CrossFormer stem {tag}: form {layer.form(side, side)}")
        forms = {"b": lambda: layer(x),
                 "a": lambda: stem_strided(x, *layer.merged(x), stride),
                 "c": lambda: torch.cat([conv(x) for conv in layer.convs()], dim=-1)}
        with torch.no_grad():
            out, ref = forms["b"](), forms["a"]()
        err = check_outputs(torch, f"CrossFormer stem {tag} space-to-depth", (out,), (ref,), {})
        params = [*layer.parameters()] + ([x] if x.requires_grad else [])
        backward = {}
        for name, fn in forms.items():
            y = fn()
            dy = torch.randn_like(y)
            backward[name] = (lambda y=y, dy=dy:
                              torch.autograd.grad(y, params, dy, retain_graph=True))
        with torch.no_grad():
            fwd = interleaved_medians(torch, {k: f for k, f in forms.items()}, rounds=3, calls=3)
        bwd = interleaved_medians(torch, backward, rounds=3, calls=3)
        times[tag] = {f"({k}) {what}": round(ms[k], 4) for k in forms
                      for what, ms in (("forward", fwd), ("backward", bwd))}
        log(f"CrossFormer stem {tag} [{side}² x {cin} -> {side // stride}² x {cout}, kernels "
            f"{kernels}, stride {stride}, batch {CROSSFORMER_BATCH}]: takes space-to-depth (b); "
            f"(b) against the merged strided convolution (a) max|b-a|={err:.6g}, within one bf16 "
            f"unit plus 2e-2*max|ref|; ms {json.dumps(times[tag])}; on {smi}")
        del layer, x, out, ref, backward
    torch.cuda.empty_cache()
    return times



# RegionViT as benchmarks/run_benchmarks.py:79-82 builds it, RegionViT(
# num_classes=1000), vit_tpu's defaults: dims 64/128/256/512, depths 2/2/8/2,
# window 7, local patch 4, 4 heads of 32 (inner 128), LayerNorms at eps 1e-3;
# at 224 px and the benchmark's batch 64 (run_benchmarks.py:337).
REGIONVIT = dict(num_classes=1000)
REGIONVIT_SIZE = 224
REGIONVIT_BATCH = 64
REGIONVIT_DEPTH = (2, 2, 8, 2)
# (tag, groups, n, c): its two attentions a layer, one module between them.
# The region self-attention on the block (rows 3-4): one group an image of
# 8², 4², 2² and 1 region tokens.  The joint attention on the biased block
# (row 5): each region token before its 7 x 7 window of local tokens (50
# tokens), the windows folded into the batch, a per-head (4, 50, 50)
# position bias that trains (dbias).
REGIONVIT_REGION_SHAPES = [
    ("RegionViT region stage 1", 64, 64, 64),
    ("RegionViT region stage 2", 64, 16, 128),
    ("RegionViT region stage 3", 64, 4, 256),
    ("RegionViT region stage 4", 64, 1, 512),
]
REGIONVIT_JOINT_SHAPES = [
    ("RegionViT joint stage 1", 4096, 50, 64),
    ("RegionViT joint stage 2", 1024, 50, 128),
    ("RegionViT joint stage 3", 256, 50, 256),
    ("RegionViT joint stage 4", 64, 50, 512),
]


def regionvit_kernel_phase(torch, results, smi):
    """Rows 3-5 at RegionViT's attentions, batch 64, seeded bf16 inputs, 4
    heads of 32, eps 1e-3: the block at the four region self-attentions
    (REGIONVIT_REGION_SHAPES; 64, 16, 4 and 1 tokens, each one 64-key tile
    of the short route), serving and training forwards and backwards as
    :func:`kernel_phase` and :func:`backward_phase` hold them (the one-key
    block's dq and dk held to 0 exactly there); then the biased block at the
    four joint attentions (REGIONVIT_JOINT_SHAPES) with a per-head random f32
    bias that asks for dbias, as :func:`biased_phase` holds it (dbias within
    DBIAS_REL_TOL of both plain versions, twice bit for bit), timed beside
    the unbiased kernel, the plain version and the bf16 modules with SDPA."""
    for tag, groups, n, c in REGIONVIT_REGION_SHAPES:
        for phase in (kernel_phase, backward_phase):
            phase(torch, tag, groups, n, c, 4, 32, 4 * c, results,
                  kernels=("fused_attention_block",))
    for tag, groups, n, c in REGIONVIT_JOINT_SHAPES:
        biased_phase(torch, groups, n, c, 4, 32, 4 * c, results, tag=tag, kinds=("per-head",))
        torch.cuda.empty_cache()


# NesT as benchmarks/run_benchmarks.py:59-61 builds it: 224 px, patch 4,
# dim 96, heads 3, 3 hierarchies, block repeats (2, 2, 8), mlp_mult 4; at the
# benchmark's batch 64 (run_benchmarks.py:337).
NEST = dict(image_size=224, patch_size=4, num_classes=1000, dim=96, heads=3, num_hierarchies=3,
            block_repeats=(2, 2, 8))
NEST_BATCH = 64
NEST_EPS = 1e-5  # its ChannelLayerNorms'
# (tag, groups, c): its hierarchies at batch 64, the 14 x 14 blocks (196
# tokens) folded into the batch, c / 32 heads of 32 (inner = c) on the block
# (rows 3-4: short_fwd's 208-key tile, short_bwd_wg); its conv-MLPs on the
# fused MLP over the same groups·196 rows, c / 4c wide (rows 1-2).
NEST_SHAPES = [
    ("NesT hierarchy 1", 1024, 96),
    ("NesT hierarchy 2", 256, 192),
    ("NesT hierarchy 3", 64, 384),
]


def nest_kernel_phase(torch, results, smi):
    """Rows 1-4 at NesT's hierarchies (NEST_SHAPES), batch 64, seeded bf16
    inputs, eps 1e-5: the fused MLP (rows groups·196, c / 4c) and the
    attention block over the folded blocks (groups × 196 × c, c / 32 heads of
    32: the unbiased 208-key ``short_fwd`` and ``short_bwd_wg`` at dh 32),
    serving and training forwards and backwards as :func:`kernel_phase` and
    :func:`backward_phase` hold them, each LayerNorm backward on
    layernorm.cu's passes (96, 192 and 384 are not multiples of 256)."""
    for tag, groups, c in NEST_SHAPES:
        for phase in (kernel_phase, backward_phase):
            phase(torch, tag, groups, 196, c, c // 32, 32, 4 * c, results, eps=NEST_EPS)
        torch.cuda.empty_cache()


# PiT as benchmarks/run_benchmarks.py:57-58 builds it: 224 px, patch 14 (stride
# 7: 31 x 31 overlapping patches and the cls token), dim 256, depth (3, 3, 3),
# 16 heads of 64, mlp 2048; at the benchmark's batch 64 (run_benchmarks.py:337).
PIT = dict(image_size=224, patch_size=14, num_classes=1000, dim=256, depth=(3, 3, 3), heads=16,
           mlp_dim=2048)
PIT_BATCH = 64
# (tag, n, d): its stages at batch 64, 16 heads of 64 (inner 1024) and mlp 2048
# at every width, eps 1e-3; each pool doubles d.  962 tokens take the block's
# mha route (flash_fwd, the flash backward), 257 (two 144-key tiles) and 65 its
# short one.
PIT_SHAPES = [("PiT stage 1", 962, 256), ("PiT stage 2", 257, 512), ("PiT stage 3", 65, 1024)]


def pit_kernel_phase(torch, results, smi):
    """Rows 1-4 at PiT's stages (PIT_SHAPES), batch 64, seeded bf16 inputs,
    eps 1e-3: the fused MLP (rows 64·n, d / 2048) and the attention block (16
    heads of 64 over d), serving and training forwards and backwards as
    :func:`kernel_phase` and :func:`backward_phase` hold them (each route
    counter checked: the mha route at stage 1, the short one at stages 2-3;
    every LayerNorm backward on the dgrad's epilogue, d 256, 512 and 1024);
    then stage 1's block beside PyTorch's library composition
    (:func:`block_library_phase`)."""
    for tag, n, d in PIT_SHAPES:
        for phase in (kernel_phase, backward_phase):
            phase(torch, tag, PIT_BATCH, n, d, 16, 64, 2048, results)
        torch.cuda.empty_cache()
    tag, n, d = PIT_SHAPES[0]
    block_library_phase(torch, tag, PIT_BATCH, n, d, 16, 64, results, smi)
    torch.cuda.empty_cache()


def block_library_phase(torch, tag, b, n, d, heads, dim_head, results, smi, eps=1e-3):
    """The attention block at one shape beside PyTorch's library composition
    of the same function in bf16: ``F.layer_norm``, ``F.linear`` (qkv),
    ``F.scaled_dot_product_attention``, ``F.linear`` (out-projection and its
    bias) and the residual; its forward under inference mode, its backward by
    autograd, once for the kernel's own outputs (dx, dγ, dβ, dbo) and once
    with the weight gradients.  The kernel's y and dx are held against the
    composition's (one unit plus 2e-2 of their own parts: two bf16 routes of
    one function).  Times of the serving forward kernel, of the backward
    kernel fed the training forward's residuals and of it with its two dW
    GEMMs, beside the composition's, and the bounds (:func:`block_bounds`);
    stored as ``sdpa`` / ``sdpa_whole`` under ``results[name][tag]``."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops._shared import weight_grad

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    inner, scale = heads * dim_head, dim_head ** -0.5

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    args = [rn(b, n, d), 1.0 + rn(d, scale=0.1), rn(d, scale=0.1),
            rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5),
            rn(d, scale=0.1)]
    x, gamma, _, wqkv, wo, _ = args
    dy = rn(b, n, d, scale=0.1)

    def library(x_, gamma_, beta_, wqkv_, wo_, bo_):
        xn = F.layer_norm(x_, (d,), gamma_, beta_, eps)
        q, k, v = F.linear(xn, wqkv_).view(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return x_ + F.linear(o.transpose(1, 2).reshape(b, n, inner), wo_, bo_)

    route = fab.attention_route(n)
    _, xn, qkv, oattn, lse = fab._launch_forward(*args, heads, dim_head, scale, eps,
                                                 training=True)

    def kernel():
        return fab.fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dim_head,
                                                  scale, eps, oattn, lse)

    def whole():
        out = kernel()
        return out, weight_grad(out[1], xn), weight_grad(dy, oattn)

    leaves = [t.detach().requires_grad_() for t in args]
    y_lib = library(*leaves)
    own = [leaves[i] for i in (0, 1, 2, 5)]
    with torch.inference_mode():
        y = fab.fused_attention_block(*args, heads, dim_head, scale, eps)
        fwd = interleaved_medians(torch, {
            "kernel": lambda: fab.fused_attention_block(*args, heads, dim_head, scale, eps),
            "library": lambda: library(*args)}, rounds=5, calls=5)
    y_err, excess, tol = block_error(torch, y, y_lib.detach(), x)
    if not excess <= tol:
        raise AssertionError(f"{tag}: the block differs from the library composition by "
                             f"{excess} beyond one output unit > {tol}")
    dx_lib = torch.autograd.grad(y_lib, leaves[0], dy, retain_graph=True)[0]
    dx_err = check_outputs(torch, f"{tag} backward against the library composition",
                           kernel()[:1], [dx_lib], {0: dy})
    bwd = interleaved_medians(torch, {
        "kernel": kernel, "whole": whole,
        "library": lambda: torch.autograd.grad(y_lib, own, dy, retain_graph=True),
        "library_whole": lambda: torch.autograd.grad(y_lib, leaves, dy, retain_graph=True)},
        rounds=5, calls=5)
    bounds = block_bounds(b, n, d, heads, dim_head, 4 * d)
    fb, bb = bounds["fused_attention_block"], bounds["fused_attention_block_bwd"]
    log(f"block beside the library [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
        f"eps={eps:g}, attention on the {route} route]: y and dx within one unit plus 2e-2 of "
        f"their own parts of F.layer_norm + F.linear + SDPA + F.linear (max|diff| "
        f"{y_err:.6g}, {dx_err:.6g}); forward ms kernel={fwd['kernel']:.4f} "
        f"library={fwd['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms "
        f"kernel={bwd['kernel']:.4f} autograd through the library={bwd['library']:.4f}; with "
        f"the weight gradients kernel+dW GEMMs={bwd['whole']:.4f} "
        f"autograd={bwd['library_whole']:.4f}; bound={bb[0]:.4f} ({bb[1]}) on {smi}")
    results["fused_attention_block"][tag].update(sdpa=fwd["library"])
    results["fused_attention_block_bwd"][tag].update(sdpa=bwd["library"],
                                                     sdpa_whole=bwd["library_whole"])
    del args, leaves, y_lib, xn, qkv, oattn, lse


def library_conv_times(torch, cases, batch, g) -> dict:
    """Device ms of library convolutions, bf16 NHWC through the port's
    modules (cuDNN on the channels_last view), at ``batch``: ``cases`` are
    ``(name, side, channels, module, image)``, the input ``side x side x
    channels``; the forward, the backward as a train step takes it (autograd:
    the weight gradients, and the input's unless ``image``), and the device
    kernels of each backward by name, as the profiler names them
    (:func:`launch_breakdown`)."""
    times = {}
    for name, side, c, conv, image in cases:
        x = torch.randn(batch, side, side, c, generator=g, device="cuda").to(torch.bfloat16)
        x.requires_grad_(not image)
        y = conv(x)
        dy = torch.randn_like(y)
        params = [*([] if image else [x]), *conv.parameters()]

        def backward(y=y, dy=dy, params=params):
            return torch.autograd.grad(y, params, dy, retain_graph=True)

        with torch.no_grad():
            fwd = interleaved_medians(torch, {"forward": lambda: conv(x)}, rounds=3,
                                      calls=3)["forward"]
        bwd = interleaved_medians(torch, {"backward": backward}, rounds=3, calls=3)["backward"]
        rows = launch_breakdown(torch, backward, calls=3, group=lambda key: key[:120])
        times[name] = {"forward": round(fwd, 4), "backward": round(bwd, 4),
                       "backward kernels": breakdown_text(rows)}
        del x, y, dy, params
    torch.cuda.empty_cache()
    return times


def pit_conv_phase(torch, smi):
    """PiT's library convolutions at batch 64, outside every kernel here as
    in ``vit_tpu`` (:func:`library_conv_times`): the overlapping patch
    embedding (14 x 14, stride 7, VALID, 3 -> 256) and each pool's grouped
    3 x 3, stride-2 TF-SAME convolution (d -> 2d, groups d: 31 -> 16 at d
    256, 16 -> 8 at 512) and its pointwise one (a GEMM)."""
    from vit_tpu_torch.layers.common import Conv, GroupedConv
    from vit_tpu_torch.models.pit import OverlapPatchEmbed

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(27)
    kw = dict(device=dev, dtype=dt, generator=g)
    cases = [("patch embedding 14x14/7", 224, 3, OverlapPatchEmbed(256, 14, 7, **kw), True)]
    for side, c in ((31, 256), (16, 512)):
        cases += [(f"pool {side}->{-(-side // 2)} grouped 3x3/2", side, c,
                   GroupedConv(c, 3, 2, out_channels=2 * c, **kw), False),
                  (f"pool {side}->{-(-side // 2)} pointwise", -(-side // 2), 2 * c,
                   Conv(2 * c, 2 * c, 1, **kw), False)]
    times = library_conv_times(torch, cases, PIT_BATCH, g)
    log(f"PiT's library convolutions (bf16 NHWC, batch 64), ms on {smi}: " + json.dumps(times))


# LeViT as benchmarks/run_benchmarks.py:62-64 builds it: 224 px, 3 stages of
# widths (256, 384, 512), depth 4, heads (4, 6, 8), mlp_mult 2, dim_key 32 and
# dim_value 64 (its defaults); batch 64 (run_benchmarks.py:337).  Its maps are
# 14 x 14, 7 x 7 and 4 x 4: 196 tokens, then 49 queries over 196 keys at the
# first shrink, 49, then 16 over 49, then 16.
LEVIT = dict(image_size=224, num_classes=1000, stages=3, dim=(256, 384, 512), depth=4,
             heads=(4, 6, 8), mlp_mult=2)
LEVIT_SIZE = 224
LEVIT_BATCH = 64
# MobileViT as run_benchmarks.py:68-71 builds it (MobileViT-XS's widths): 256
# px, dims (96, 120, 144), channels (16, 32, 48, 48, 64, 64, 80, 80, 96, 96,
# 384), depths (2, 4, 3), patches of 2 x 2; batch 64.  Its transformers run
# over 4 sequences of 256, 64 and 16 tokens an image.
MOBILEVIT = dict(image_size=(256, 256), dims=(96, 120, 144),
                 channels=(16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384), num_classes=1000)
MOBILEVIT_SIZE = 256
MOBILEVIT_BATCH = 64
# The dense-token family as benchmarks/run_benchmarks.py builds it, at its
# batch 64 (:337), no depth cut.  DeepViT (:49-51) and CaiT (:52-54) at 256
# px, patch 32 (65 and 64 + 1 tokens), dim 1024, 16 heads, mlp 2048; the ViT
# with a PatchMerger (:152-155) at 256/16 (256 tokens), 8 heads, merged to 8
# tokens after layer 6 of 12; CrossViT (:72-76) at 256 px, a 192-wide branch
# of patch 16 (257 tokens) and a 384-wide one of patch 64 (17), encoder
# depths 2 and 3, 4 rounds, dropout 0 (its constructor's 0.1 would take the
# plain MLPs in training); Parallel ViT (:98-101) at 256/32, 8 heads, two
# branches.
DEEPVIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=16,
               mlp_dim=2048)
PATCH_MERGER = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=12, heads=8,
                    patch_merge_layer=6, mlp_dim=2048)
CROSSVIT = dict(image_size=256, num_classes=1000, sm_dim=192, lg_dim=384, sm_patch_size=16,
                lg_patch_size=64, sm_enc_depth=2, lg_enc_depth=3, depth=4, dropout=0.0,
                emb_dropout=0.0)
CAIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=12, cls_depth=2,
            heads=16, mlp_dim=2048)
PARALLEL_VIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=8,
                    mlp_dim=2048, num_parallel_branches=2)
DENSE_BATCH = 64
# (tag, n, d): rows 1-2 at the family's shapes not timed elsewhere, batch 64,
# mlp 2048: CrossViT's two encoders (d 192: fc2 on linear.cu, under
# launch_forward_gemm's n 256; neither 192 nor 384 is a multiple of 256, so
# each LayerNorm backward runs on layernorm.cu's passes) and the patch
# merger's layers after it (8 tokens an image: 512 rows).  DeepViT's 64·65
# rows at d 1024 are B/32's at batch 64.
DENSE_MLP_SHAPES = [("CrossViT small branch", 257, 192), ("CrossViT large branch", 17, 384),
                    ("PatchMerger ViT after the merger", 8, 1024)]
# ATS-ViT as run_benchmarks.py:145-148 builds it (256/16, 257 tokens sampled
# down to 129, 65, 33, 17 and 9 slots by layers 2-6) and CCT-14 as
# run_benchmarks.py:136-139 builds it (224 px, two 7 x 7 stride-2 convolutions
# and pools: 196 tokens; CCT's default attention dropout and stochastic depth
# 0.1, dropout 0), at the benchmark's batch 64 (:337), no depth cut.
ATS = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6,
           max_tokens_per_depth=(256, 128, 64, 32, 16, 8), heads=16, mlp_dim=2048)
CCT14 = dict(img_size=224, embedding_dim=384, n_conv_layers=2, kernel_size=7, stride=2,
             num_layers=14, num_heads=6, mlp_ratio=3.0, num_classes=1000,
             positional_embedding="learnable")
CCT_SIZE = 224
# (tag, n, d): rows 1-2 at two of ATS-ViT's six token counts, batch 64, mlp
# 2048: layer 2's 129 slots and layer 6's 9 (576 rows).  Layer 1's 257 is
# the small-dataset ViT's shape at d 1024.
ATS_MLP_SHAPES = [("ATS-ViT layer 2", 129, 1024), ("ATS-ViT layer 6", 9, 1024)]


def dense_kernel_phase(torch, results, smi, shapes=DENSE_MLP_SHAPES):
    """Rows 1-2 at ``shapes`` (DENSE_MLP_SHAPES, ATS_MLP_SHAPES), batch 64,
    seeded bf16 inputs, eps 1e-3: the fused MLP's serving and training
    forwards and its backward as :func:`kernel_phase` and
    :func:`backward_phase` hold them (the block's arguments there, 8 heads of
    64, are unused: only the fused MLP runs)."""
    for tag, n, d in shapes:
        for phase in (kernel_phase, backward_phase):
            phase(torch, tag, DENSE_BATCH, n, d, 8, 64, 2048, results, kernels=("fused_mlp",))
        torch.cuda.empty_cache()


def draws(torch, model, seed):
    """``kw()``: the keyword arguments of one fixed draw for ``model``'s
    forward or train step, ``{"generator": g}`` with ``g`` a generator
    reseeded to ``seed`` at every call, where the forward takes a generator
    (ATS-ViT's Gumbel noise, CCT's dropout and stochastic depth, CaiT's layer
    dropout), else ``{}``; ``g`` on the model's device (the card).  The models compared on one path draw from one
    seed, so the bf16 and the f32 models see the same noise and masks (the
    draws are f32 whatever the model's dtype)."""
    if "generator" not in inspect.signature(model.forward).parameters:
        return lambda: {}
    g = torch.Generator(device=next(model.parameters()).device)
    return lambda: {"generator": g.manual_seed(seed)}


def ats_sampled_ids(torch, model, images, kw) -> list:
    """The token ids each sampling layer of ATS-ViT ``model`` keeps on
    ``images`` (one forward under ``no_grad`` with the draw ``kw()``, in the
    model's mode), ``{layer (from 1): (b, k + 1) ids}``: 0 at the cls slot
    and at padding, patch p at p + 1.  Read by forward hooks on the
    attentions, which return the ids they sampled (None where a layer keeps
    its tokens)."""
    from vit_tpu_torch.models.ats_vit import ATSAttention

    sampled = []
    hooks = [m.register_forward_hook(lambda mod, args, out: sampled.append(out[2]))
             for m in model.modules() if isinstance(m, ATSAttention)]
    try:
        with torch.no_grad():
            model(images, **kw())
    finally:
        for hook in hooks:
            hook.remove()
    tokens = torch.arange(model.pos_embedding.shape[1], device=images.device)
    tokens, kept = tokens.expand(images.shape[0], -1), {}
    for layer, ids in enumerate(sampled, 1):
        if ids is not None:
            tokens = kept[layer] = tokens.gather(1, ids)
    return kept


def ats_agreement(torch, models: dict, batches: list, seed):
    """At each sampling layer of ATS-ViT, over the images of ``batches`` (one
    forward a batch, from the draw each path's own forwards take): the share
    of the f32 model's sampled tokens that the kernel path and the plain path
    (``models``: ``kernels``, ``plain``, ``f32``) sampled too, and the share
    of images whose sampled sets the three (and the two bf16 paths) agree on
    exactly.  Each model draws the same Gumbel noise (:func:`draws`); bf16
    rounding of the pseudo-logits can still flip a near tie of the
    Gumbel-max, and a flipped token changes what the later layers see, so
    the three compute the same network only on the images whose sets agree
    at every layer.  Returns a text for the log and those images (a bool
    vector)."""
    sets = {}
    for name, m in models.items():
        kw, parts = draws(torch, m, seed), {}
        for images in batches:
            for layer, ids in ats_sampled_ids(torch, m, images, kw).items():
                parts.setdefault(layer, []).append(ids)
        sets[name] = {layer: torch.cat(ids) for layer, ids in parts.items()}
    n, dev = models["f32"].pos_embedding.shape[1], batches[0].device
    rows, alike = [], torch.ones(sum(b.shape[0] for b in batches), dtype=torch.bool, device=dev)
    for layer in sets["f32"]:
        hot = [torch.zeros(sets[k][layer].shape[0], n, dtype=torch.bool, device=dev)
               .scatter_(1, sets[k][layer], True)[:, 1:] for k in ("kernels", "plain", "f32")]
        share = ((hot[0] & hot[1] & hot[2]).sum() / hot[2].sum()).item()
        here = (hot[0] == hot[2]).all(1) & (hot[1] == hot[2]).all(1)
        alike &= here
        same = here.float().mean().item()
        bf16 = (hot[0] == hot[1]).all(1).float().mean().item()
        rows.append(f"layer {layer} ({int(hot[2].sum(1).float().mean().item())} tokens an "
                    f"image on f32): {share:.4f} of f32's tokens on all three, images alike "
                    f"on all three {same:.4f}, on the two bf16 paths {bf16:.4f}")
    return ("sampled ids, one Gumbel draw for all three models: " + "; ".join(rows)
            + f"; images alike on all three at every layer {int(alike.sum())} of "
            f"{alike.numel()}; "), alike


def seed_batch_norms(torch, model, g):
    """Every BatchNorm of ``model`` to seeded nonzero values: γ and the
    running variance uniform in [0.5, 1.5], β and the running mean 0.1·N(0,
    1); LeViT's ``to_out_bn`` γ uniform in [0.1, 0.3].  That one starts at
    γ = 0, with which each attention adds exactly 0 in serving and q, k, v
    and the position bias get no gradient at step 1: a check would pass
    having tested nothing.  It scales each attention's residual branch, and
    LeViT starts it at 0 to keep the stream in hand: at [0.5, 1.5] the
    fourteen branches make the step-1 gradient chaotic (inputs moved by 1e-3
    move the f32 model's by a large part of its norm; see
    :func:`plain_training_phase`'s sensitivity), and no bf16 run can then
    agree with it."""
    from vit_tpu_torch.layers.common import BatchNorm

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                low, width = (0.1, 0.2) if name.endswith("to_out_bn") else (0.5, 1.0)
                m.weight.copy_(low + width * torch.rand(m.weight.shape, generator=g,
                                                        device=m.weight.device))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g,
                                                     device=m.running_var.device))
                for t in (m.bias, m.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=g, device=t.device))


def has_batch_norm(model) -> bool:
    from vit_tpu_torch.layers.common import BatchNorm

    return any(isinstance(m, BatchNorm) for m in model.modules())


def batch_norm_text(model) -> str:
    return "every BatchNorm seeded nonzero" if has_batch_norm(model) else "no BatchNorm"


def plain_serving_phase(torch, tag, build, cfg, batch, requests, size, seed, smi, counters):
    """Serve a model that ``vit_tpu`` runs on no Pallas kernel (LeViT,
    MobileViT, CaiT, Parallel ViT, CCT): ``requests`` batches of ``size`` px
    through the bf16 model (``cast_params``, eval, inference mode; its
    BatchNorms, if any, seeded, :func:`seed_batch_norms`), every counter from
    0 and still 0 after each
    forward: no hand-written kernel runs on this path, as none runs in
    ``vit_tpu``.  Its plain path would be the same bf16 model, so the
    reference is the f32 model of the same weights (TF32 off): logits finite,
    ``(batch, classes)``, within LOGIT_REL_TOL·max|f32|; top-1 agreement
    printed; median forward ms of both, and the bf16 forwards' peak memory.
    Both models draw from one seed (:func:`draws`; nothing draws in eval
    mode).  Returns each kernel's launches over them (all 0)."""
    from vit_tpu_torch import cast_params

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = build(**cfg, device=dev, generator=g)
    seed_batch_norms(torch, model, g)
    f32 = build(**cfg, device=dev).eval()
    f32.load_state_dict(model.state_dict())
    model = cast_params(model, torch.bfloat16).eval()
    kw, kw32 = draws(torch, model, seed), draws(torch, f32, seed)
    images = [torch.randn(batch, size, size, 3, generator=g, device=dev)
              for _ in range(requests)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The main path's run: counters from 0, read right after.
        for c in counters.values():
            c.launches = 0
        outs = []
        for i, img in enumerate(images):
            outs.append(model(img, **kw()))
            check_launches(tag, f"forward {i}", counters, {}, i + 1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {name: c.launches for name, c in counters.items()}
        logits = torch.cat(outs).float()
        truth = torch.cat([f32(img, **kw32()) for img in images])
        err = (logits - truth).abs().max().item()
        tol = LOGIT_REL_TOL * truth.abs().max().item()
        top1 = (logits.argmax(-1) == truth.argmax(-1)).float().mean().item()
        ms = interleaved_medians(torch, {"bf16": lambda: model(images[0], **kw()),
                                         "f32": lambda: f32(images[0], **kw32())},
                                 rounds=5, calls=4)
    log(f"serving {tag}: {requests} requests x {batch} images, logits {tuple(outs[0].shape)}, "
        f"{batch_norm_text(model)}; hand-written kernel launches per forward 0 (vit_tpu "
        f"runs no Pallas kernel here); against the f32 model of the same weights "
        f"max|bf16-f32|={err:.6g} tol={tol:.6g} (1e-1*max|f32|), relative L2 "
        f"{rel_l2(torch, logits, truth):.4g}, top-1 agreement {top1:.4f}; peak GB allocated "
        f"over the bf16 forwards {peak:.2f}; median forward ms bf16={ms['bf16']:.3f} "
        f"f32={ms['f32']:.3f} ({batch / ms['bf16'] * 1e3:.1f} vs {batch / ms['f32'] * 1e3:.1f} "
        f"img/s) on {smi}")
    if tuple(outs[0].shape) != (batch, cfg["num_classes"]):
        raise AssertionError(f"{tag}: logits shape {tuple(outs[0].shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    if not err <= tol:
        raise AssertionError(f"{tag}: logits differ from the f32 model's by {err} > {tol}")
    return launches


def plain_training_phase(torch, tag, build, cfg, batch, size, seed, smi, counters):
    """Train a model that ``vit_tpu`` runs on no Pallas kernel (LeViT,
    MobileViT, CaiT, Parallel ViT, CCT): ``build(..., compute_dtype=bf16)`` with
    f32 parameters and its BatchNorms, if any, seeded
    (:func:`seed_batch_norms`), SGD(1e-3), one fixed batch
    of ``size`` px.  The reference is the f32 model of the same weights (TF32
    off): each parameter's step-1 gradient (every one nonzero, and f32) with
    its relative L2 error against the f32 model's printed, beside the f32
    model's own sensitivity (its step-1 gradient at inputs moved by 1e-3
    relative, against the unmoved one), and the first loss within
    LOSS_REL_TOL of the f32 model's.  Then TRAIN_STEPS steps with
    every counter from 0 and still 0 after each step (no hand-written
    kernel), finite and falling losses, the BatchNorm running statistics (in
    a model that has BatchNorms) finite and moved; the bf16 step timed
    beside the f32 one, and its peak
    memory.  A model that draws in training (CCT's dropout and stochastic
    depth) gets one fixed draw at every forward and step, the bf16 and the
    f32 model alike (:func:`draws`), so that the gradients compared are
    those of one network.  Returns each kernel's launches over the steps
    (all 0)."""
    from vit_tpu_torch.parallel.train import cross_entropy_loss, make_train_step

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = build(**cfg, compute_dtype=torch.bfloat16, device=dev, generator=g)
    seed_batch_norms(torch, model, g)
    f32 = build(**cfg, device=dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    f32.load_state_dict(start)
    images = torch.randn(batch, size, size, 3, generator=g, device=dev)
    labels = torch.arange(batch, device=dev) % cfg["num_classes"]
    kw = {"bf16": draws(torch, model, seed), "f32": draws(torch, f32, seed)}
    grads, first = {}, {}
    for name, m in (("bf16", model), ("f32", f32)):
        m.train().zero_grad(set_to_none=True)
        loss = cross_entropy_loss(m(images, **kw[name]()), labels)
        loss.backward()
        first[name] = loss.item()
        grads[name] = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                       for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        m.load_state_dict(start)  # the step-1 forward moved the running statistics
    # The f32 gradient's own sensitivity: the same step 1 at inputs moved by
    # 1e-3 relative, a floor under which no bf16 run can be expected to agree.
    f32.train().zero_grad(set_to_none=True)
    nudge = 1 + 1e-3 * torch.randn(images.shape, generator=g, device=dev)
    cross_entropy_loss(f32(images * nudge, **kw["f32"]()), labels).backward()
    moved = {k: p.grad.detach().clone() for k, p in f32.named_parameters() if p.grad is not None}
    f32.zero_grad(set_to_none=True)
    f32.load_state_dict(start)
    sensitivity = rel_l2(torch, torch.cat([v.flatten() for v in moved.values()]),
                         torch.cat([grads["f32"][k].flatten() for k in moved]))
    zero = [k for k, v in grads["f32"].items() if not bool(v.any())]
    if zero or any(v.dtype != torch.float32 for v in grads["bf16"].values()):
        raise AssertionError(f"{tag}: step-1 gradients zero {zero} or not f32")
    errs = {k: rel_l2(torch, grads["bf16"][k], ref) for k, ref in grads["f32"].items()}
    overall = rel_l2(torch, torch.cat([v.flatten() for v in grads["bf16"].values()]),
                     torch.cat([v.flatten() for v in grads["f32"].values()]))
    # A bias before a BatchNorm in training mode (LeViT's to_out and, before
    # a shrink, its residual stream) has a gradient of 0 in exact arithmetic:
    # f32 leaves rounding noise there, against which a relative error means
    # nothing.  Those are counted apart from the worst.
    norms = {k: torch.linalg.vector_norm(v).item() for k, v in grads["f32"].items()}
    floor = 1e-3 * statistics.median(norms.values())
    tiny = [k for k, v in norms.items() if v < floor]
    worst = sorted((k for k in errs if k not in tiny), key=errs.get)[-3:]
    loss_rel = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    log(f"gradients {tag}: step-1 relative L2 error of each parameter's gradient, bf16 "
        f"compute against the f32 model: " + json.dumps({k: float(f"{v:.4g}")
                                                         for k, v in errs.items()}))

    def run_of(m):
        step, draw = make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-3)), \
            draws(torch, m, seed)
        return lambda: step(images, labels, **draw())

    run = run_of(model)
    stats = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The main path: counters from 0, TRAIN_STEPS steps, read right after.
    for c in counters.values():
        c.launches = 0
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(run()["loss"].item())
        check_launches(tag, f"step {i}", counters, {}, i + 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: c.launches for name, c in counters.items()}
    buffers = dict(model.named_buffers())
    stale = [k for k, before in stats.items() if torch.equal(buffers[k], before)
             or not bool(torch.isfinite(buffers[k]).all())]
    ms = interleaved_medians(torch, {"bf16": run, "f32": run_of(f32)}, rounds=3, calls=3)
    STEP_MS[tag] = ms
    log(f"training {tag}: batch {batch}, f32 params, bf16 compute, SGD(1e-3), "
        f"{batch_norm_text(model)}; step-1 loss bf16={first['bf16']:.6f} "
        f"f32={first['f32']:.6f} (within {LOSS_REL_TOL} relative: {loss_rel:.3g}); step-1 "
        f"gradients against the f32 model, relative L2 over all {len(errs)} parameters "
        f"{overall:.4g} (the f32 model's own at inputs moved by 1e-3 relative: "
        f"{sensitivity:.4g}), median {statistics.median(errs.values()):.4g}, worst "
        + ", ".join(f"{k} {errs[k]:.4g}" for k in reversed(worst))
        + f" ({len(tiny)} gradients below 1e-3 of the median norm, 0 in exact arithmetic, "
        f"left out of the worst); losses over {TRAIN_STEPS} steps {[round(v, 6) for v in losses]}; hand-written "
        f"kernel launches per step 0 (vit_tpu runs no Pallas kernel here); "
        f"{len(stats)} BatchNorm running statistics finite and updated; peak GB allocated "
        f"over the bf16 steps {peak:.2f} of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; median step ms "
        f"bf16={ms['bf16']:.3f} f32={ms['f32']:.3f} ({batch / ms['bf16'] * 1e3:.1f} vs "
        f"{batch / ms['f32'] * 1e3:.1f} img/s) on {smi}")
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(f"{tag}: first losses differ by {loss_rel} relative")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite and falling")
    if (has_batch_norm(model) and not stats) or stale:
        raise AssertionError(f"{tag}: BatchNorm statistics missing, not finite or not "
                             f"updated: {stale}")
    return launches


def plain_conv_phase(torch, smi):
    """The library convolutions of LeViT's stem and of MobileViT's MV2
    blocks at batch 64 (:func:`library_conv_times`), outside every kernel
    here as in ``vit_tpu``: the stem's four 3 x 3, stride-2 TF-SAME
    convolutions with bias (224 → 112 → 56 → 28 → 14 px, 3 → 32 → 64 → 128 →
    256 channels) and each distinct depthwise 3 x 3 convolution of
    MobileViT@256 (hidden = 4·dim_in channels; ``stem_3``'s is ``stem_2``'s
    shape)."""
    from vit_tpu_torch.layers.common import Conv, GroupedConv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    kw = dict(device=dev, dtype=torch.bfloat16, generator=g)
    stem, side, c = [], LEVIT_SIZE, 3
    for i, features in enumerate((32, 64, 128, LEVIT["dim"][0])):
        stem.append((f"conv_embedding_{i} 3x3/2 {side}->{side // 2} {c}->{features}", side, c,
                     Conv(c, features, 3, 2, **kw), i == 0))
        side, c = side // 2, features
    ch = MOBILEVIT["channels"]
    depthwise = [(f"{block} depthwise 3x3/{stride} {side}->{-(-side // stride)} x{4 * din}", side,
                  4 * din, GroupedConv(4 * din, 3, stride, use_bias=False, **kw), False)
                 for block, side, din, stride in (
                     ("stem_0", 128, ch[0], 1), ("stem_1", 128, ch[1], 2), ("stem_2", 64, ch[2], 1),
                     ("trunk_conv_0", 64, ch[3], 2), ("trunk_conv_1", 32, ch[5], 2),
                     ("trunk_conv_2", 16, ch[7], 2))]
    log(f"LeViT's stem convolutions (bf16 NHWC, batch {LEVIT_BATCH}), ms on {smi}: "
        + json.dumps(library_conv_times(torch, stem, LEVIT_BATCH, g)))
    log(f"MobileViT's depthwise convolutions (bf16 NHWC, batch {MOBILEVIT_BATCH}), ms on "
        f"{smi}: " + json.dumps(library_conv_times(torch, depthwise, MOBILEVIT_BATCH, g)))


def packed_phase(torch, results, smi):
    """The channel-packed flash op at PACKED_SHAPES, seeded bf16 (b, n,
    heads·d) inputs: out and lse against the plain version; dq, dk, dv (the
    flash backward on the packed strides, as the op's autograd runs it) fed
    the kernel's own out and lse against the plain backward, twice bit for
    bit; times of the kernels, their plain versions and SDPA on the head
    views (autograd through it for the backward), and the bounds."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops import flash_attention_packed as fap

    for i, (tag, b, n, heads, dk, dv) in enumerate(PACKED_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(60 + i)
        q, k, v, do = (torch.randn(b, n, heads * d, generator=g, device="cuda")
                       .to(torch.bfloat16) for d in (dk, dk, dv, dv))
        scale = dk ** -0.5
        shape = f"[{tag}: b={b} n={n} heads={heads} dk={dk} dv={dv}, channel-packed]"

        def heads_of(*ts):
            return [fap.split_heads(t, heads) for t in ts]

        before = fap.flash_attention_packed.launches
        with torch.inference_mode():
            out, lse = fap.flash_attention_packed_forward(q, k, v, heads, scale)
        torch.cuda.synchronize()
        if fap.flash_attention_packed.launches != before + 1:
            raise AssertionError(f"packed flash {shape}: launch counter did not move")
        ref_out, ref_lse = fap.flash_attention_packed_forward_reference(q, k, v, heads, scale)
        err = check_outputs(torch, f"packed flash forward {shape}", (out,), (ref_out,), {})
        lse_err = (lse - ref_lse).abs().max().item()
        if not (lse.dtype == torch.float32 and lse_err <= LSE_ABS_TOL):
            raise AssertionError(f"packed flash forward {shape}: lse differs by {lse_err}")
        del ref_out, ref_lse

        def kernel():
            return [fap.merge_heads(t) for t in fa.flash_backward(
                *heads_of(q, k, v, out), lse, fap.split_heads(do, heads), scale)]

        def plain():
            return fap.flash_attention_packed_backward_reference(q, k, v, out, lse, do, heads,
                                                                 scale)

        before = fa.flash_backward.launches
        grads = kernel()
        torch.cuda.synchronize()
        if fa.flash_backward.launches != before + 1:
            raise AssertionError(f"packed flash backward {shape}: launch counter did not move")
        bwd_err = check_outputs(torch, f"packed flash backward {shape}", grads, plain(), {})
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, kernel())):
            raise AssertionError(f"packed flash backward {shape}: two runs differ")
        del grads
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fap.flash_attention_packed_forward(q, k, v, heads, scale),
            "plain": lambda: fap.flash_attention_packed_forward_reference(q, k, v, heads, scale),
            "library": lambda: F.scaled_dot_product_attention(*heads_of(q, k, v), scale=scale)},
            rounds=3, calls=3)
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain,
            "library": sdpa_backward(torch, F, *heads_of(q, k, v, do), scale)},
            rounds=3, calls=3)
        bounds = flash_bounds(b, heads, n, n, dk, dv)
        fb, bb = bounds["flash_attention"], bounds["flash_backward"]
        log(f"packed flash {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| of "
            f"the plain version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g}; dq, "
            f"dk, dv (fed the kernel's out and lse) max|diff|={bwd_err:.6g}, the same bits in two "
            f"runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} SDPA on "
            f"the head views={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms "
            f"kernel={bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through SDPA="
            f"{bwd_ms['library']:.4f} bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("flash_attention_packed", {})[tag] = dict(
            err=err, lse_err=lse_err, **fwd_ms, bound=fb)
        results.setdefault("flash_backward (packed)", {})[tag] = dict(
            err=bwd_err, **bwd_ms, bound=bb)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


# (tag, b, h, n_q, n_k, d): the short-attention op at ViT-B/16's attention
# (vit_tpu's own v5e measurement of the op, short_attention.py:15-17), CvT-13
# @224's stage 3 below the flash gate, the MAX_SEQ edge at d 64 and 128, and a
# ragged cross-attention.
SHORT_SHAPES = [
    ("ViT-B/16 attention", 64, 12, 197, 197, 64),
    ("CvT-13@224 stage 3", 64, 6, 196, 49, 64),
    ("n=512, d=64", 16, 8, 512, 512, 64),
    ("n=512, d=128", 16, 8, 512, 512, 128),
    ("cross-attention, ragged", 2, 2, 65, 130, 32),
]


# The kernels rebuilt for Hopper (csrc/hopper.cuh: TMA rings on mbarriers,
# wgmma), and the times of the designs they replaced (mma.sync with
# synchronous staging; for proj_mlp, the block forwards' GEMMs and the block
# backwards' dgrads, linear.cu's cp.async GEMM, and for the unbiased block's
# attention the mma.sync mha_fwd's online softmax and mha_bwd's FA2 split, since
# retired; for ln_gemm, the
# earlier one-tile-a-CTA wgmma GEMM), ms on an H100 80GB HBM3 at 700 W:
# constants cited from PERF.md's kernel table and its findings on the
# rebuilds, printed on a line of their own beside the kernels' line, never in
# it (every number there is this run's).  The flash forward's rebuild also
# runs the packed op's forward; the short backward's runs attention_nb's.  The
# biased block's and the cross-attention block's forward's are the parent
# design's (mha_fwd / mha_bwd, retired; q GEMM + flash forward + output GEMM); the
# cross-attention block's backward's the four steps (linear.cu's dy·Wo, the
# flash backward, linear.cu's dq·Wq, column sums).  Rows 2, 4, 5 (backward),
# 12 and 14's backwards: the design before the LayerNorm-backward epilogue
# (PERF.md's table), the dgrad into the LayerNorm backward writing an f32 dxn
# that layernorm.cu's passes read back, row 12's dgrad on linear.cu.
DESIGNS = {"flash_attention": "wgmma+tma", "flash_backward": "wgmma+tma",
           "fused_cross_attention": "one cross_fwd kernel (wgmma+tma): per head q = xn·Wq_h, "
                                    "softmax and P·V in registers, then y = oattn·Wo over the "
                                    "heads with bias and residual; no residual when serving",
           "flash_attention_packed": "wgmma+tma",
           "short_attention": "wgmma+tma", "ln_gemm": "wgmma+tma, warp-specialised, persistent",
           "attention_nb": "wgmma+tma", "proj_mlp": "wgmma+tma, warp-specialised, persistent",
           "short_attention_bwd": "tma ring, key block sized to n; mma.sync, wgmma at 129-256 keys",
           "attention_nb_bwd": "tma ring, key block sized to n; mma.sync, wgmma at 129-256 keys",
           "fused_mlp_bwd": "dgrads on gemm_wgmma (wgmma+tma, warp-specialised, persistent, B "
                            "MN-major) from n 256, linear.cu below: dy·W2 with the dGELU "
                            "epilogue, dh·W1 with the LayerNorm backward as its epilogue on a "
                            "thread-block cluster (dxn on chip, row partials through DSMEM) "
                            "at d % 256 == 0 in 256..2048",
           "fused_attention_block_bwd": "dgrads on gemm_wgmma with B MN-major, dqkv·Wqkv with "
                                        "the LayerNorm backward as its epilogue on a cluster "
                                        "(dxn on chip); attention on short_bwd up to 512 "
                                        "tokens, past them the flash backward (wgmma+tma: "
                                        "flash_bwd_dq, flash_bwd_dkv) from the forward's lse "
                                        "and D = rowsum(dO∘O)",
           "fused_attention_block_bias_bwd": "dgrads on gemm_wgmma with B MN-major, dqkv·Wqkv "
                                             "with the LayerNorm backward as its epilogue on a "
                                             "cluster; attention on short_bwd with the bias "
                                             "(two 144-key blocks at n 257) up to 512 tokens, "
                                             "past them the flash backward's biased instances "
                                             "(flash_bwd_dq_kernel<T, dh, dh, bias>, "
                                             "flash_bwd_dkv_kernel<T, dh, dh, 3, bias>); with "
                                             "dbias the rows' exact dsum first (mha_row_stats) "
                                             "and mha_dbias in a fixed order",
           "ln_gemm_bwd": "dqkv·W on gemm_wgmma (B MN-major) with the LayerNorm backward, no "
                          "residual, as its epilogue on a thread-block cluster: dxn on chip, "
                          "row partials through DSMEM, fixed-order column sums",
           "fused_mlp": "fc1 and fc2 on gemm_wgmma (wgmma+tma, warp-specialised, persistent, "
                        "fused epilogues) from n 256, linear.cu below",
           "fused_attention_block": "QKV and out-projection on gemm_wgmma from n 256; attention "
                                    "on short_fwd (wgmma+tma, keeps lse in training) up to 512 "
                                    "tokens, flash_fwd (wgmma+tma, keeps lse in training) past "
                                    "them",
           "fused_attention_block_bias": "QKV and out-projection on gemm_wgmma from n 256; "
                                         "attention on short_fwd with the bias (two 144-key "
                                         "tiles at n 257, keeps lse in training) up to 512 "
                                         "tokens, past them flash_fwd's biased instances "
                                         "(flash_fwd_kernel<T, dh, dh, bias>, the f32 bias "
                                         "read into the score fragment)",
           "fused_cross_attention_bwd": "one cross_bwd kernel (wgmma+tma) up to c 128: per "
                                        "head doattn = dy·Wo_h, p from lse, dsum = Σ p·dp, ds "
                                        "and dq on chip, dk/dv over a span of query blocks in "
                                        "registers, then dxn = dq·Wq; f32 partials summed in "
                                        "a fixed order; from c 129 cross_bwd over head groups "
                                        "between gemm_wgmma's dgrads; four steps past 128 keys",
           "proj_mlp_bwd": "three dgrads on gemm_wgmma (wgmma+tma, warp-specialised, "
                           "persistent, B MN-major): dGELU, the LayerNorm backward on a "
                           "cluster (dxn on chip), store"}
EARLIER_DESIGN_MS = {
    "flash_attention": {"CvT-13@224 stage 1": 0.3540, "CvT-13@384 stage 1": 2.2336,
                        "CvT-13@384 stage 2": 0.5668, "n=8192, through the dispatcher": 6.7406},
    "flash_attention_packed": {"ScalableViT IWSA stage 1": 2.4982},
    "fused_cross_attention": {"ScalableViT stage 1": 0.2648},
    "fused_cross_attention_bwd": {"ScalableViT stage 1": 0.6243, "ScalableViT stage 2": 0.2868,
                                  "ScalableViT stage 3": 0.1601, "ScalableViT stage 4": 0.1118},
    "ln_gemm": {"B/32": 0.1517},
    "proj_mlp": {"B/32": 0.4404},
    "proj_mlp_bwd": {"B/32": 0.3592},
    "ln_gemm_bwd": {"B/32": 0.2490},
    "flash_backward": {"CvT-13@224 stage 1": 1.3212, "CvT-13@384 stage 1": 8.2769,
                       "CvT-13@384 stage 2": 1.8241, "n=8192, through the dispatcher": 24.0999,
                       "n=4096, d=32": 9.6678},
    "flash_backward (packed)": {"ScalableViT IWSA stage 1": 9.7670,
                                "ScalableViT IWSA stage 2": 1.5143, "dk 40, dv 32": 0.9418},
    "short_attention": {"ViT-B/16 attention": 0.3046, "CvT-13@224 stage 3": 0.0819,
                        "n=512, d=64": 0.2990, "n=512, d=128": 0.4042,
                        "cross-attention, ragged": 0.0673},
    "attention_nb": {"B/32": 0.1732},
    "short_attention_bwd": {"ViT-B/16 attention": 0.6722, "CvT-13@224 stage 3": 0.1721,
                            "n=512, d=64": 0.4995, "n=512, d=128": 0.7270,
                            "cross-attention, ragged": 0.1301},
    "attention_nb_bwd": {"B/32": 0.4285},
    "fused_mlp_bwd": {"B/16": 0.5082, "B/32": 0.3059},
    "fused_attention_block_bwd": {"B/16": 0.4540, "B/32": 0.3488, "PiT stage 1": 8.3642},
    "fused_attention_block_bias_bwd": {"lsa": 1.0548, "shared": 1.9904, "per-head": 1.7430},
    "fused_mlp": {"B/16": 0.5743, "B/32": 0.3257},
    "fused_attention_block": {"B/16": 0.4872, "B/32": 0.4362, "PiT stage 1": 3.1139},
    "fused_attention_block_bias": {"lsa": 0.6170, "shared": 0.6236, "per-head": 0.6210},
}


def short_bounds(b, h, n_q, n_k, d):
    """Bounds of the short-attention kernels (and of attention_nb, the same
    kernels over the (n, b, heads·dh) layout): the FLOPs of the function,
    two n_q x n_k products forward (q·kᵀ, p·v) and five backward (q·kᵀ, dO·vᵀ,
    dv, dq, dk); bytes: forward q, k, v read and out written (the serving
    forward, no lse), backward q, k, v, dout read and dq, dk, dv written, the
    inputs the TPU kernel's backward takes (the port's also reads the stored
    out and lse, for D and the softmax statistics), bf16."""
    pairs = b * h * n_q * n_k
    q, k = 2 * b * h * n_q * d, 2 * b * h * n_k * d
    return {"short_attention": bound(4 * pairs * d, 2 * q + 2 * k),
            "short_attention_bwd": bound(10 * pairs * d, 3 * q + 4 * k)}


def hybrid_bounds(b, n, d, heads, dim_head, hidden):
    """Bounds of the hybrid layer's kernels at one shape (t = b·n rows, bf16
    activations and weights, f32 parameter-gradient sums): the FLOPs of the
    TPU kernels' own GEMMs and attention products; each input read once and
    each output written once.  ln_gemm: x, γ, β, Wqkv -> q|k|v (serving, no
    xn); backward dqkv, x, γ, Wqkv -> dx, f32 dγ, dβ, over the dxn GEMM.
    attention_nb: :func:`short_bounds`.  proj_mlp: x, o, Wo, bo, γ, β, W1,
    b1, W2, b2 -> z over three GEMMs; backward dz, y, h, γ, Wo, W1, W2 -> dy,
    do, dh, gact and f32 dγ, dβ, dbo, db1, db2 over three dgrad GEMMs."""
    t, inner = b * n, heads * dim_head
    act, qkv, o, h = 2 * t * d, 2 * t * 3 * inner, 2 * t * inner, 2 * t * hidden
    w_qkv = 2 * 3 * inner * d
    w_mlp = 2 * (inner * d + 2 * d * hidden)  # Wo, W1, W2
    mlp_flops = 2 * t * (inner * d + 2 * d * hidden)
    short = short_bounds(b, heads, n, n, dim_head)
    return {
        "ln_gemm": bound(2 * t * d * 3 * inner, act + w_qkv + 4 * d + qkv),
        "ln_gemm_bwd": bound(2 * t * 3 * inner * d, qkv + act + 2 * d + w_qkv + act + 8 * d),
        "attention_nb": short["short_attention"],
        "attention_nb_bwd": short["short_attention_bwd"],
        "proj_mlp": bound(mlp_flops, act + o + w_mlp + 2 * (4 * d + hidden) + act),
        "proj_mlp_bwd": bound(mlp_flops, 2 * act + h + 2 * d + w_mlp + act + o + 2 * h
                              + 4 * (4 * d + hidden)),
    }


def short_attention_phase(torch, results, smi, counters):
    """The short-attention op at SHORT_SHAPES, seeded bf16 (b, h, n, d)
    inputs.  First its path: every counter from 0, the public op under
    autograd, forward and backward, once, at the first shape; the counters
    read right after are the phase's launches.  Then at each shape: out and
    lse against the plain version; dq, dk, dv fed the kernel's own out and
    lse against the plain backward, twice bit for bit; times of the kernels,
    their plain versions, PyTorch's SDPA (autograd through it for the
    backward) and the port's flash kernels on the same inputs, and the
    bounds."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops import short_attention as sa

    def inputs(b, h, n_q, n_k, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
                for n in (n_q, n_k, n_k, n_q)]

    q, k, v, do = inputs(*SHORT_SHAPES[0][1:], seed=70)
    for c in counters.values():
        c.launches = 0
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sa.short_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    check_launches("short attention", "one forward and backward", counters,
                   {"short_attention": 1, "short_attention_bwd": 1}, 1)
    del leaves

    for i, (tag, b, h, n_q, n_k, d) in enumerate(SHORT_SHAPES):
        q, k, v, do = inputs(b, h, n_q, n_k, d, seed=70 + i)
        scale = d ** -0.5
        shape = f"[{tag}: b={b} heads={h} n_q={n_q} n_k={n_k} d={d}]"
        out, lse = sa.short_attention_forward(q, k, v, scale)
        ref_out, ref_lse = sa.short_attention_forward_reference(q, k, v, scale)
        err = check_outputs(torch, f"short attention forward {shape}", (out,), (ref_out,), {})
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"short attention forward {shape}: lse differs by {lse_err}")
        del ref_out, ref_lse
        grads = sa.short_attention_backward(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        bwd_err = check_outputs(torch, f"short attention backward {shape}", grads,
                                sa.short_attention_backward_reference(q, k, v, out, lse, do,
                                                                      scale), {})
        again = sa.short_attention_backward(q, k, v, out, lse, do, scale)
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
            raise AssertionError(f"short attention backward {shape}: two runs differ")
        del grads, again
        f_out, f_lse = fa.flash_attention_forward(q, k, v, scale)
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: sa.short_attention_forward(q, k, v, scale, need_lse=False),
            "plain": lambda: sa.short_attention_forward_reference(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            "flash": lambda: fa.flash_attention_forward(q, k, v, scale)}, rounds=3, calls=3)
        bwd_ms = interleaved_medians(torch, {
            "kernel": lambda: sa.short_attention_backward(q, k, v, out, lse, do, scale),
            "plain": lambda: sa.short_attention_backward_reference(q, k, v, out, lse, do, scale),
            "library": sdpa_backward(torch, F, q, k, v, do, scale),
            "flash": lambda: fa.flash_backward(q, k, v, f_out, f_lse, do, scale)},
            rounds=3, calls=3)
        bounds = short_bounds(b, h, n_q, n_k, d)
        fb, bb = bounds["short_attention"], bounds["short_attention_bwd"]
        log(f"short attention {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| "
            f"of the plain version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g}; dq, "
            f"dk, dv (fed the kernel's out and lse) max|diff|={bwd_err:.6g}, the same bits in two "
            f"runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"SDPA={fwd_ms['library']:.4f} flash kernel={fwd_ms['flash']:.4f} bound={fb[0]:.4f} "
            f"({fb[1]}); backward ms kernel={bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} "
            f"autograd through SDPA={bwd_ms['library']:.4f} flash kernels={bwd_ms['flash']:.4f} "
            f"bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("short_attention", {})[tag] = dict(
            err=err, lse_err=lse_err, **fwd_ms, bound=fb)
        results.setdefault("short_attention_bwd", {})[tag] = dict(err=bwd_err, **bwd_ms, bound=bb)
        del q, k, v, do, out, lse, f_out, f_lse
        torch.cuda.empty_cache()
    return launches


def hybrid_phase(torch, tag, b, n, d, heads, dim_head, hidden, results, smi):
    """The hybrid layer's kernels at one layer shape, seeded bf16 inputs in
    the (n, b, ·) row order of the tier: ln_gemm's training forward (q|k|v,
    xn), attention_nb's (o, lse; on the kernel's q, k, v, column views of
    its one output) and proj_mlp's (z, y, xn, h; on the kernel's o) against
    their plain versions; then each backward, fed the residuals its own
    forward kept (proj_mlp's from a seeded dz, attention_nb's from proj_mlp's
    do, ln_gemm's from attention_nb's one dq|dk|dv buffer), against its plain
    backward on them, and twice bit for bit.  Times of the serving forwards
    and of the backwards, their plain versions and the library: bf16
    ``F.layer_norm`` + ``F.linear`` (ln_gemm), SDPA on the head views
    (attention_nb) and the bf16 out-projection + LayerNorm + MLP (proj_mlp),
    autograd through them for the backwards (for the kernels' own outputs,
    and with the weight gradients beside the kernel plus its dW GEMMs)."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_hybrid as fh
    from vit_tpu_torch.ops import short_attention as sa
    from vit_tpu_torch.ops._shared import weight_grad

    dev, dt, eps = torch.device("cuda"), torch.bfloat16, 1e-3
    g = torch.Generator(device=dev).manual_seed(80)
    t, inner = b * n, heads * dim_head
    scale = dim_head ** -0.5

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x = rn(t, d)
    ln1 = (rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1))
    wqkv = rn(3 * inner, d, scale=d ** -0.5)
    wo, bo = rn(d, inner, scale=inner ** -0.5), rn(d, scale=0.1)
    ln2 = (rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1))
    mlp_w = (rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
             rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))
    w1, _, w2, _ = mlp_w
    dz = rn(t, d, scale=0.1)
    shape = f"[{tag}: t={t} (n={n}, b={b}) d={d} heads={heads}x{dim_head} h={hidden}]"

    def nb(a):
        return a.reshape(n, b, a.shape[-1])

    # The training forwards, chained as the layer chains them.
    qkv, xn1 = fh._launch_ln_gemm(x, *ln1, wqkv, eps)
    errs = {"ln_gemm": check_outputs(torch, f"ln_gemm {shape}", (qkv, xn1),
                                     fh.ln_gemm_forward_reference(x, *ln1, wqkv, eps), {})}
    q, k, v = (nb(a) for a in qkv.chunk(3, -1))
    o, lse = fh.attention_nb_forward(q, k, v, heads, dim_head)
    ref_o, ref_lse = fh.attention_nb_forward_reference(q, k, v, heads, dim_head)
    errs["attention_nb"] = check_outputs(torch, f"attention_nb {shape}", (o,), (ref_o,), {})
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"attention_nb {shape}: lse differs by {lse_err}")
    o2 = o.reshape(t, inner)
    z, y, xn2, h = fh._launch_proj_mlp(x, o2, wo, bo, *ln2, *mlp_w, eps, save_residuals=True)
    ref = fh.proj_mlp_forward_reference(x, o2, wo, bo, *ln2, *mlp_w, eps)
    errs["proj_mlp"] = check_outputs(torch, f"proj_mlp {shape}", (z, y, xn2, h), ref,
                                     {0: ref[1], 1: x})
    del ref, ref_o, ref_lse

    # The backwards, each fed its forward's residuals, twice.
    def twice(name, kernel, plain, residuals):
        got = kernel()
        torch.cuda.synchronize()
        errs[name + "_bwd"] = check_outputs(torch, f"{name} backward {shape}", got, plain(),
                                            residuals)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, kernel())):
            raise AssertionError(f"{name} backward {shape}: two runs differ")
        return got

    def proj_bwd():
        return fh.proj_mlp_backward(dz, y, h, ln2[0], wo, w1, w2, eps)

    dy, do, dh, gact = twice("proj_mlp", proj_bwd, lambda: fh.proj_mlp_backward_reference(
        dz, y, h, ln2[0], wo, w1, w2, eps), {0: dz})[:4]
    do_nb = nb(do)
    # Its three dgrads run on gemm_wgmma (launch_dgrad, n >= 256 here): none on
    # linear.cu; dh·W1's epilogue is the LayerNorm backward.
    rows, device = {}, {}
    counts, rows["proj_mlp"], device["proj_mlp"] = check_ln_epilogue(
        torch, f"proj_mlp backward {shape}", proj_bwd, linear=False)
    log(f"hybrid proj_mlp backward {shape}: device ms launch by launch "
        f"{breakdown_text(rows['proj_mlp'])} on {smi}")
    if counts["gemm_wgmma"] != 3:
        raise AssertionError(f"proj_mlp backward {shape}: its dgrads are not gemm_wgmma's three: "
                             f"{counts}")

    def attn_bwd():
        return fh.attention_nb_backward(do_nb, q, k, v, o, lse, heads, dim_head)

    attn_grads = twice("attention_nb", attn_bwd, lambda: fh.attention_nb_backward_reference(
        do_nb, q, k, v, o, lse, heads, dim_head), {})
    dqkv = fh._joined([a.reshape(t, inner) for a in attn_grads])
    if dqkv.data_ptr() != attn_grads[0].data_ptr():
        raise AssertionError(f"attention_nb backward {shape}: dq, dk, dv are not one buffer")

    def ln_bwd():
        return fh.ln_gemm_backward(dqkv, x, ln1[0], wqkv, eps)

    twice("ln_gemm", ln_bwd, lambda: fh.ln_gemm_backward_reference(dqkv, x, ln1[0], wqkv, eps),
          {})
    # Its GEMM is the LayerNorm-backward dgrad: no linear_kernel.
    _, rows["ln_gemm"], device["ln_gemm"] = check_ln_epilogue(
        torch, f"ln_gemm backward {shape}", ln_bwd, linear=False)
    log(f"hybrid ln_gemm backward {shape}: device ms launch by launch "
        f"{breakdown_text(rows['ln_gemm'])} on {smi}")
    # PyTorch's LayerNorm backward on the f32 dxn each keeps on chip.
    ln_lib = {"ln_gemm": ln_library(torch, fh.gemm_wgmma(dqkv, wqkv, "f32", layout="kn")[0], x,
                                    ln1[0], eps),
              "proj_mlp": ln_library(torch, fh.gemm_wgmma(dh, w1, "f32", layout="kn")[0], y,
                                     ln2[0], eps)}

    # The library compositions, bf16, with autograd for the backwards.
    leaf = {name: a.detach().requires_grad_() for name, a in dict(
        x=x, g1=ln1[0], b1n=ln1[1], wqkv=wqkv, q=q, k=k, v=v, o=o2, wo=wo, bo=bo, g2=ln2[0],
        b2n=ln2[1], w1=w1, b1=mlp_w[1], w2=w2, b2=mlp_w[3]).items()}

    def lib_ln_gemm(p):
        return F.linear(F.layer_norm(p["x"], (d,), p["g1"], p["b1n"], eps), p["wqkv"])

    def lib_attention(p):
        return sa.nb_merge(F.scaled_dot_product_attention(
            *(sa.nb_heads(p[c], heads) for c in "qkv"), scale=scale))

    def lib_proj_mlp(p):
        y_ = p["x"] + F.linear(p["o"], p["wo"], p["bo"])
        hid = F.gelu(F.linear(F.layer_norm(y_, (d,), p["g2"], p["b2n"], eps), p["w1"], p["b1"]))
        return y_ + F.linear(hid, p["w2"], p["b2"])

    def autograd(fn, cot, own, weights=()):
        out = fn(leaf)
        ins = [leaf[c] for c in own + weights]
        return lambda: torch.autograd.grad(out, ins, cot, retain_graph=True)

    cases = {
        "ln_gemm": (lambda: fh.ln_gemm(x, *ln1, wqkv, eps),
                    lambda: fh.ln_gemm_forward_reference(x, *ln1, wqkv, eps),
                    lambda: lib_ln_gemm(leaf)),
        "attention_nb": (lambda: fh.attention_nb(q, k, v, heads, dim_head),
                         lambda: fh.attention_nb_forward_reference(q, k, v, heads, dim_head),
                         lambda: lib_attention(leaf)),
        "proj_mlp": (lambda: fh.proj_mlp(x, o2, wo, bo, *ln2, *mlp_w, eps),
                     lambda: fh.proj_mlp_forward_reference(x, o2, wo, bo, *ln2, *mlp_w, eps),
                     lambda: lib_proj_mlp(leaf)),
    }
    backward = {
        "ln_gemm": (ln_bwd, lambda: fh.ln_gemm_backward_reference(dqkv, x, ln1[0], wqkv, eps),
                    lambda: (ln_bwd(), weight_grad(dqkv, xn1)),
                    autograd(lib_ln_gemm, dqkv, ("x", "g1", "b1n")),
                    autograd(lib_ln_gemm, dqkv, ("x", "g1", "b1n"), ("wqkv",))),
        "attention_nb": (attn_bwd, lambda: fh.attention_nb_backward_reference(
            do_nb, q, k, v, o, lse, heads, dim_head), None,
            autograd(lib_attention, do_nb, ("q", "k", "v")), None),
        "proj_mlp": (proj_bwd, lambda: fh.proj_mlp_backward_reference(
            dz, y, h, ln2[0], wo, w1, w2, eps),
            lambda: (proj_bwd(), weight_grad(dy, o2), weight_grad(dh, xn2), weight_grad(dz, gact)),
            autograd(lib_proj_mlp, dz, ("x", "o", "bo", "g2", "b2n", "b1", "b2")),
            autograd(lib_proj_mlp, dz, ("x", "o", "bo", "g2", "b2n", "b1", "b2"),
                     ("wo", "w1", "w2"))),
    }
    bounds = hybrid_bounds(b, n, d, heads, dim_head, hidden)
    for name, (kernel, plain, library) in cases.items():
        with torch.inference_mode():
            fwd_ms = interleaved_medians(torch, {"kernel": kernel, "plain": plain,
                                                 "library": library}, rounds=5, calls=5)
        bk, bp, bw, bl, blw = backward[name]
        fns = {"kernel": bk, "plain": bp, "library": bl}
        if bw is not None:
            fns.update(whole=bw, library_whole=blw)
        if name in ln_lib:
            fns.update(library_ln=ln_lib[name])
        bwd_ms = interleaved_medians(torch, fns, rounds=5, calls=5)
        fb, bb = bounds[name], bounds[name + "_bwd"]
        log(f"hybrid {name} {shape}: training forward within one bf16 unit plus "
            f"{KERNEL_REL_TOL}*max|its own part| of the plain version, max|kernel-plain|="
            f"{errs[name]:.6g}" + (f", lse {lse_err:.3g}" if name == "attention_nb" else "")
            + f"; backward fed the forward's residuals {errs[name + '_bwd']:.6g}, the same bits "
            f"in two runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"library={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms kernel="
            f"{bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through the library="
            f"{bwd_ms['library']:.4f}"
            + (f"; with the weight gradients: kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd="
               f"{bwd_ms['library_whole']:.4f}" if bw is not None else "")
            + (f"; {ln_device_text(device[name], rows[name])}; native_layer_norm_backward "
               f"on the same f32 dxn={bwd_ms['library_ln']:.4f}" if name in ln_lib else "")
            + f"; bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault(name, {})[tag] = dict(err=errs[name], **fwd_ms, bound=fb)
        results.setdefault(name + "_bwd", {})[tag] = dict(
            err=errs[name + "_bwd"], **bwd_ms, bound=bb,
            **({"device": device[name]} if name in device else {}))


def hybrid_vit(fused_attention="hybrid", **kw):
    """``ViT`` with the short-sequence tier opted into (a caller's
    ``fused_attention`` overrides it: the plain path passes ``"never"``)."""
    from vit_tpu_torch import ViT

    return ViT(fused_attention=fused_attention, **kw)


def serving_phase(torch, tag, vit, cfg, batch, requests, seed, smi, counters, per_forward,
                  top1_sign_test=False, size=None, plain_kw=PLAIN_KW, inspect_models=None):
    """Serve ``requests`` batches of ``size`` px (``cfg["image_size"]`` by
    default) through the model class ``vit``; the plain path is ``vit`` with
    ``plain_kw``.  Each forward must launch each kernel ``per_forward[name]``
    times (0 if not named).  The kernel path must agree with the f32 reference's top-1 at
    least as often as the plain bf16 path does; with ``top1_sign_test``, for
    a model whose plain path keeps more precision than the kernel route
    (the small-dataset ViT's exact f32 LSA softmax), less often only by
    chance (SIGN_TEST_Z).  Every model draws from one seed (:func:`draws`:
    ATS-ViT's Gumbel noise).  ``inspect_models(torch, {"kernels", "plain",
    "f32"}, requests, seed)``, where given, returns a text for the log and the
    images on which the three models compute one network
    (:func:`ats_agreement`: ATS-ViT's sampled sets alike at every layer):
    the logit and top-1 checks are held over those, at least one, and the
    largest errors over the others are printed.  Returns each kernel's
    launches over them."""
    from vit_tpu_torch import cast_params

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = cast_params(vit(**cfg, device=dev, generator=g), torch.bfloat16).eval()
    plain = vit(**cfg, **plain_kw, device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(model.state_dict())
    kw, kw_plain = draws(torch, model, seed), draws(torch, plain, seed)
    size = size or cfg["image_size"]
    images = [torch.randn(batch, size, size, 3, generator=g, device=dev)
              for _ in range(requests)]

    with torch.inference_mode():
        # The main path's run: counters from 0, read right after.
        for c in counters.values():
            c.launches = 0
        outs = []
        for i, img in enumerate(images):
            outs.append(model(img, **kw()))
            check_launches(tag, f"forward {i}", counters, per_forward, i + 1)
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        refs = [plain(img, **kw_plain()) for img in images]
        f32 = vit(**cfg, **plain_kw, device=dev, dtype=torch.float32).eval()
        f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        kw32 = draws(torch, f32, seed)
        truths = [f32(img, **kw32()) for img in images]
        inspected, held = inspect_models(torch, {"kernels": model, "plain": plain, "f32": f32},
                                         images, seed) if inspect_models else ("", None)
        del f32
        torch.cuda.synchronize()

        logits, ref = torch.cat(outs).float(), torch.cat(refs).float()
        truth = torch.cat(truths)
        if tuple(outs[0].shape) != (batch, cfg["num_classes"]):
            raise AssertionError(f"{tag}: logits shape {tuple(outs[0].shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: non-finite logits")
        if held is not None:
            if not bool(held.any()):
                raise AssertionError(f"{tag}: no image on which the models compute one network")
            apart = ~held
            errs = [(a - b)[apart].abs().max().item() if apart.any() else 0.0
                    for a, b in ((logits, ref), (logits, truth), (ref, truth))]
            inspected += (f"the logit and top-1 checks that follow held over those "
                          f"{int(held.sum())} images; over the other {int(apart.sum())}, where "
                          f"each path computes another network, max|kernel-plain|={errs[0]:.6g} "
                          f"max|kernel-f32|={errs[1]:.6g} max|plain-f32|={errs[2]:.6g}; ")
            logits, ref, truth = logits[held], ref[held], truth[held]
        err = (logits - ref).abs().max().item()
        tol = LOGIT_REL_TOL * ref.abs().max().item()
        err_k, err_p = ((t - truth).abs().max().item() for t in (logits, ref))
        l2_k, l2_p = (rel_l2(torch, t, truth) for t in (logits, ref))

        def top1(a, b):
            return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

        top1_kp, top1_kf, top1_pf = top1(logits, ref), top1(logits, truth), top1(ref, truth)
        right_k, right_p = (t.argmax(-1) == truth.argmax(-1) for t in (logits, ref))
        kernel_only = int((right_k & ~right_p).sum().item())
        plain_only = int((right_p & ~right_k).sum().item())
        slack = SIGN_TEST_Z * math.sqrt(kernel_only + plain_only)
        top2 = truth.topk(2, dim=-1).values
        margins = top2[:, 0] - top2[:, 1]
        margin = margins.median().item()
        confident = margins > 2 * err_p
        n_confident = int(confident.sum().item())
        top1_conf = top1(logits[confident], ref[confident]) if n_confident else 0.0
        ms = interleaved_medians(torch, {"kernels": lambda: model(images[0], **kw()),
                                         "plain": lambda: plain(images[0], **kw_plain())},
                                 rounds=5, calls=4)
    log(f"serving {tag}: {requests} requests x {batch} images, logits "
        f"{tuple(outs[0].shape)} finite; kernel launches per forward {per_forward}; {inspected}"
        f"max|kernel-plain|={err:.6g} tol={tol:.6g} (1e-1*max|ref|); "
        f"vs f32 reference max|kernel-f32|={err_k:.6g} max|plain-f32|={err_p:.6g} "
        f"(kernel <= {MAX_ERR_VS_PLAIN_BF16}x plain), relative L2 kernels={l2_k:.4g} "
        f"plain={l2_p:.4g}; top-1 agreement "
        f"kernel/plain={top1_kp:.4f} kernel/f32={top1_kf:.4f} plain/f32={top1_pf:.4f} ("
        + (f"sign test: images where only the kernel path / only the plain path has f32's "
           f"top-1 {kernel_only} / {plain_only}, plain-only minus kernel-only <= "
           f"{SIGN_TEST_Z}*sqrt(their sum) = {slack:.3g}" if top1_sign_test
           else "kernel/f32 >= plain/f32")
        + f"); median top-2 margin of the f32 logits "
        f"{margin:.4g}; kernel/plain top-1 over the {n_confident} images with an "
        f"f32 margin above 2*max|plain-f32| = {top1_conf:.4f} (>= {TOP1_CONFIDENT}); "
        f"median forward ms kernels={ms['kernels']:.3f} "
        f"plain={ms['plain']:.3f} ({batch / ms['kernels'] * 1e3:.1f} vs "
        f"{batch / ms['plain'] * 1e3:.1f} img/s) on {smi}")
    if not err <= tol:
        raise AssertionError(f"{tag}: logits differ by {err} > {tol}")
    if not err_k <= MAX_ERR_VS_PLAIN_BF16 * err_p:
        raise AssertionError(f"{tag}: kernel path {err_k} from the f32 reference, "
                             f"plain bf16 path {err_p}")
    if top1_sign_test and plain_only - kernel_only > slack:
        raise AssertionError(f"{tag}: top-1 agreement with the f32 reference {top1_kf} below "
                             f"the plain bf16 path's {top1_pf} beyond chance: only the plain "
                             f"path right on {plain_only} images, only the kernel path on "
                             f"{kernel_only}")
    if not top1_sign_test and top1_kf < top1_pf:
        raise AssertionError(f"{tag}: top-1 agreement with the f32 reference {top1_kf} < "
                             f"the plain bf16 path's {top1_pf}")
    if not (n_confident and top1_conf >= TOP1_CONFIDENT):
        raise AssertionError(f"{tag}: kernel/plain top-1 agreement {top1_conf} over "
                             f"{n_confident} confident images, need {TOP1_CONFIDENT}")
    return launches


def check_launches(tag, when, counters, expected, times):
    """Each counter must read ``times · expected[name]`` (0 when unnamed)."""
    got = {name: c.launches for name, c in counters.items()}
    want = {name: times * expected.get(name, 0) for name in counters}
    if got != want:
        raise AssertionError(f"{tag}: after {when} the kernels were launched {got} times, "
                             f"expected {want}")


def rel_l2(torch, a, ref):
    return (torch.linalg.vector_norm((a - ref).float())
            / torch.linalg.vector_norm(ref.float()).clamp_min(1e-30)).item()


def training_models(torch, vit, cfg, batch, seed, size=None, plain_kw=PLAIN_KW):
    """The kernel path ``vit(..., compute_dtype=bf16)`` with f32 parameters
    from a seeded initialisation, the plain bf16 path (``plain_kw``) and the
    f32 model on the same weights, and one seeded batch of images of ``size``
    px (``cfg["image_size"]`` by default) and labels."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
    plain = vit(**cfg, compute_dtype=torch.bfloat16, **plain_kw)
    f32 = vit(**cfg, **plain_kw)
    for twin in (plain, f32):
        twin.load_state_dict(model.state_dict())
    size = size or cfg["image_size"]
    images = torch.randn(batch, size, size, 3, generator=g, device=dev)
    labels = torch.arange(batch, device=dev) % cfg["num_classes"]
    return model, plain, f32, images, labels


def check_temperatures(torch, tag, grads, weights):
    """Hold each LSA temperature's step-1 gradient (a 0-d ``…attn.temperature``)
    on the kernel path within TEMPERATURE_TERMS_TOL·Σ|dWq⊙Wq| of the f32
    model's: Wq the q-third of the same layer's ``to_qkv.weight``
    (``weights``, the f32 model's parameters), dWq its gradient in the f32
    model, whose Σ dWq⊙Wq is the temperature's gradient (held to the same
    bound, so that the terms are the right ones).  Returns a summary for
    the log, empty without temperatures; raises on a miss."""
    rows, misses = [], []
    for k in sorted(k for k, v in grads["f32"].items() if v.dim() == 0):
        w = k.rsplit(".", 1)[0] + ".to_qkv.weight"
        inner = weights[w].shape[0] // 3
        terms = grads["f32"][w][:inner] * weights[w][:inner]
        total, size = terms.sum().item(), terms.abs().sum().item()
        ref = grads["f32"][k].item()
        err_k, err_p = (abs(grads[n][k].item() - ref) for n in ("kernels", "plain"))
        rows.append(f"{k.split('.attn')[0]} f32 {ref:.6g} (Σ dWq⊙Wq {total:.6g}) kernels "
                    f"{grads['kernels'][k].item():.6g} plain {grads['plain'][k].item():.6g} "
                    f"Σ|terms| {size:.6g} |error|/Σ|terms| kernels {err_k / size:.3g} plain "
                    f"{err_p / size:.3g}")
        if not (err_k <= TEMPERATURE_TERMS_TOL * size
                and abs(total - ref) <= TEMPERATURE_TERMS_TOL * size):
            misses.append(rows[-1])
    if misses:
        raise AssertionError(f"{tag}: temperature gradients beyond {TEMPERATURE_TERMS_TOL} of "
                             f"their terms: {misses}")
    return (f"temperatures (each within {TEMPERATURE_TERMS_TOL:.4g}*Σ|terms| of f32): "
            + "; ".join(rows) + "; ") if rows else ""


def step1_gradients(torch, tag, models, images, labels, loss_of=None):
    """Step-1 gradients of the kernel path, the plain bf16 path and the f32
    model (``models``, in that order, on the same weights), of the
    cross-entropy of ``m(images)`` against ``labels`` or, for a module whose
    forward is the loss, of ``loss_of(m)``: each parameter's on the kernel
    path within MAX_GRAD_ERR_VS_PLAIN_BF16 times the plain path's relative
    L2 error against f32, the 0-d ones as one stacked vector and each by
    :func:`check_temperatures`, CrossFormer's DPB tensors each as a stack
    across its attentions (:func:`stacked_groups`; each on its own printed).  Parameters the loss does not reach (an
    objective's encoder head, a teacher) get a gradient on none of the three.
    Returns the first losses and a summary for the log; raises on a miss."""
    from vit_tpu_torch.parallel.train import cross_entropy_loss

    if any(p.dtype != torch.float32 for p in models[0].parameters()):
        raise AssertionError(f"{tag}: parameters are not f32")
    grads, first, peak = {}, {}, {}
    for name, m in zip(("kernels", "plain", "f32"), models):
        m.train().zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        loss = loss_of(m) if loss_of else cross_entropy_loss(m(images), labels)
        loss.backward()
        first[name] = loss.item()
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        grads[name] = {k: p.grad.detach().clone() for k, p in m.named_parameters()
                       if p.grad is not None}
        m.zero_grad(set_to_none=True)
    if any(v.dtype != torch.float32 for v in grads["kernels"].values()):
        raise AssertionError(f"{tag}: gradients are not f32")
    if not set(grads["kernels"]) == set(grads["plain"]) == set(grads["f32"]):
        raise AssertionError(f"{tag}: the paths' gradients reach other parameters")
    no_grad = sum(1 for _ in models[0].parameters()) - len(grads["kernels"])
    temperatures = check_temperatures(torch, tag, grads, dict(models[2].named_parameters()))
    stacks = stacked_groups(grads["f32"])
    dpb = sorted(k for keys in stacks.values() for k in keys if ".dpb." in k)
    dpb_text = ""
    if dpb:  # each DPB tensor on its own, printed, not held
        ratios = {k: rel_l2(torch, grads["kernels"][k], grads["f32"][k])
                  / max(rel_l2(torch, grads["plain"][k], grads["f32"][k]), 1e-30) for k in dpb}
        worst = max(ratios, key=ratios.get)
        medians = {n: statistics.median(rel_l2(torch, grads[n][k], grads["f32"][k]) for k in dpb
                                        if not k.endswith("out.bias"))
                   for n in ("kernels", "plain")}
        dpb_text = (f"the DPB's {len(dpb)} tensors each on its own (printed, not held): "
                    f"{sum(r > MAX_GRAD_ERR_VS_PLAIN_BF16 for r in ratios.values())} past "
                    f"{MAX_GRAD_ERR_VS_PLAIN_BF16}x the plain path's error, worst "
                    f"{ratios[worst]:.3g} ({worst}), median error but out.bias kernels="
                    f"{medians['kernels']:.4g} plain={medians['plain']:.4g}; ")
    tables = sorted(k for k in grads["f32"] if "local_rel_pos_bias" in k)
    table_text = ""
    if tables:  # RegionViT's position tables, each held on its own below
        table_text = "the position tables' relative L2 errors, kernels / plain: " + ", ".join(
            f"{k.split('.')[0]} {rel_l2(torch, grads['kernels'][k], grads['f32'][k]):.4g} / "
            f"{rel_l2(torch, grads['plain'][k], grads['f32'][k]):.4g}" for k in tables) + "; "
    for name in grads:
        held = {k: v for k, v in grads[name].items()
                if not any(k in keys for keys in stacks.values())}
        for label, keys in stacks.items():
            held[label] = torch.cat([grads[name][k].flatten() for k in keys])
        grads[name] = held
    worst_ratio, worst_name, misses = 0.0, "", []
    for k, ref in grads["f32"].items():
        err_k, err_p = (rel_l2(torch, grads[n][k], ref) for n in ("kernels", "plain"))
        ratio = err_k / max(err_p, 1e-30)
        if ratio > worst_ratio:
            worst_ratio, worst_name = ratio, k
        if not err_k <= MAX_GRAD_ERR_VS_PLAIN_BF16 * err_p:
            misses.append(f"{k}: {err_k:.4g} vs plain {err_p:.4g}")
    cat = {n: torch.cat([v.flatten() for v in grads[n].values()]) for n in grads}
    all_k, all_p = (rel_l2(torch, cat[n], cat["f32"]) for n in ("kernels", "plain"))
    summary = (f"step-1 gradients, relative L2 error against the f32 model over all "
               f"parameters: kernels={all_k:.4g} plain={all_p:.4g}"
               + (f" ({no_grad} parameter tensors the loss does not reach: no gradient on "
                  f"any path)" if no_grad else "")
               + f"; worst per-tensor ratio "
               f"kernels/plain={worst_ratio:.3f} ({worst_name}; <= "
               f"{MAX_GRAD_ERR_VS_PLAIN_BF16}); peak GB allocated in the step-1 forward and "
               f"backward (the three models' weights included) kernels={peak['kernels']:.2f} "
               f"plain={peak['plain']:.2f} f32={peak['f32']:.2f}; {temperatures}{dpb_text}"
               f"{table_text}")
    if misses:
        raise AssertionError(f"{tag}: kernel-path gradients beyond "
                             f"{MAX_GRAD_ERR_VS_PLAIN_BF16}x the plain path's error: {misses}; "
                             f"{summary}")
    return first, summary


def stacked_groups(grads: dict) -> dict:
    """The parameters whose step-1 gradients are held as one vector, the
    stack of them across layers (MAX_GRAD_ERR_VS_PLAIN_BF16's comment says
    why): ``{label: sorted names}``, the 0-d ones together and each tensor of
    CrossFormer's dynamic position bias across its attentions."""
    groups = {}
    for k, v in grads.items():
        if v.dim() == 0:
            groups.setdefault("0-d parameters of every layer, stacked", []).append(k)
        elif ".dpb." in k:
            role = k.split(".dpb.")[1]
            groups.setdefault(f"dpb.{role} of every attention, stacked", []).append(k)
    return {label: sorted(keys) for label, keys in groups.items()}


def gradient_phase(torch, tag, vit, cfg, batch, seed, smi, size=None):
    """:func:`step1_gradients` at another seed than the training phase's, or
    of another kernel path (``vit``) at its seed, on ``size`` px images."""
    model, plain, f32, images, labels = training_models(torch, vit, cfg, batch, seed, size)
    first, summary = step1_gradients(torch, tag, (model, plain, f32), images, labels)
    log(f"gradients {tag}: batch {batch}, seed {seed}; step-1 loss kernels="
        f"{first['kernels']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f}; {summary}"
        f"on {smi}")


def training_phase(torch, tag, vit, cfg, batch, seed, smi, counters, per_step, size=None,
                   plain_kw=PLAIN_KW, timing=None, inspect_models=None):
    """Train ``vit(..., compute_dtype=bf16)`` (f32 parameters) with SGD on one
    fixed batch; hold its step-1 gradients (:func:`step1_gradients`) and its
    loss against the plain bf16 path (``plain_kw``) and an f32 model of the
    same weights; check that each step launches each kernel
    ``per_step[name]`` times (0 if not named), and that BatchNorm's running
    statistics, where the model has them, stay finite and move; time a step
    on both paths (:func:`interleaved_medians` with ``timing``, 3 rounds of
    3 steps by default).  Every model draws from one seed at every forward
    and step (:func:`draws`: ATS-ViT's Gumbel noise); ``inspect_models``, as
    :func:`serving_phase` takes it, on the three models in training mode
    and the training batch, its text printed (the step-1 gradients are the
    whole batch's, held as they are)."""
    from vit_tpu_torch.parallel.train import cross_entropy_loss, make_train_step

    model, plain, f32, images, labels = training_models(torch, vit, cfg, batch, seed, size,
                                                        plain_kw)
    inspected = ""
    if inspect_models:
        for m in (model, plain, f32):
            m.train()
        inspected, _ = inspect_models(torch, {"kernels": model, "plain": plain, "f32": f32},
                                      [images], seed)
    kw = {id(m): draws(torch, m, seed) for m in (model, plain, f32)}
    first, summary = step1_gradients(
        torch, tag, (model, plain, f32), images, labels,
        loss_of=lambda m: cross_entropy_loss(m(images, **kw[id(m)]()), labels))
    del f32
    torch.cuda.empty_cache()

    def run_of(m):
        step, draw = make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-3)), \
            draws(torch, m, seed)
        return lambda: step(images, labels, **draw())

    return train_path(torch, tag, batch, model, plain, first, inspected + summary, run_of,
                      "SGD(1e-3)", smi, counters, per_step, timing)


def train_path(torch, tag, batch, model, plain, first, summary, run_of, optimizer, smi, counters,
               per_step, timing=None):
    """The main path of a training phase: ``run_of(m)`` is one train step
    of ``m`` (a call without arguments); TRAIN_STEPS steps of ``model`` with
    the counters from 0 (each step launching each kernel ``per_step[name]``
    times), finite and falling losses, BatchNorm's running statistics moved,
    the first losses of the kernel and the plain path (``first``) within
    LOSS_REL_TOL, and the step timed on both paths."""
    loss_rel = abs(first["kernels"] - first["plain"]) / abs(first["plain"])
    # The main path: counters from 0, TRAIN_STEPS steps, read right after.
    run = run_of(model)
    stats = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
    for c in counters.values():
        c.launches = 0
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(run()["loss"].item())
        check_launches(tag, f"step {i}", counters, per_step, i + 1)
    launches = {name: c.launches for name, c in counters.items()}
    buffers = dict(model.named_buffers())
    stale = [k for k, before in stats.items() if torch.equal(buffers[k], before)
             or not bool(torch.isfinite(buffers[k]).all())]
    if stale:
        raise AssertionError(f"{tag}: BatchNorm statistics not finite or not updated: {stale}")
    ms = interleaved_medians(torch, {"kernels": run, "plain": run_of(plain)},
                             **(timing or dict(rounds=3, calls=3)))
    STEP_MS[tag] = ms
    log(f"training {tag}: batch {batch}, f32 params, bf16 compute, {optimizer}; step-1 loss "
        f"kernels={first['kernels']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f} "
        f"(kernels/plain within {LOSS_REL_TOL} relative: {loss_rel:.3g}); {summary}losses "
        f"over {TRAIN_STEPS} steps {[round(v, 6) for v in losses]}; launches per step "
        f"{per_step}; peak GB since the f32 model's step 1, both paths' timed steps "
        f"included: allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}, reserved "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f}, of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
        + (f"{len(stats)} BatchNorm running statistics finite and updated; " if stats else "")
        + f"median step ms kernels={ms['kernels']:.3f} "
        f"plain={ms['plain']:.3f} ({batch / ms['kernels'] * 1e3:.1f} vs "
        f"{batch / ms['plain'] * 1e3:.1f} img/s) on {smi}")
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(f"{tag}: first losses differ by {loss_rel} relative")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite and falling")
    return launches


def crossformer_mlp_kernels(**kw):
    """``CrossFormer`` with its MLPs on the kernels and its attentions on the
    plain modules (``fused_attention="never"``, the plain path's): the control
    of its step-1 gradient check, a bf16 path that shares no attention kernel
    with the kernel path."""
    from vit_tpu_torch import CrossFormer

    return CrossFormer(**{"fused_attention": "never", **kw})


def ats_kernels(fused_mlp="auto", **kw):
    """ATS-ViT with its MLPs on the kernels (``vit_tpu``'s default is
    ``"never"``; a caller's ``fused_mlp`` overrides it: the plain path passes
    ``"never"``)."""
    from vit_tpu_torch.models import ats_vit

    return ats_vit.ViT(fused_mlp=fused_mlp, **kw)


def t2t_vit(plain=False, distillable=False, **kw):
    """``T2TViT`` (``DistillableT2TViT`` with ``distillable``); with
    ``plain``, its plain path (:func:`plain_modules`: the token transformers'
    attention included): its constructor, ``vit_tpu``'s, takes no such
    switch."""
    from vit_tpu_torch import DistillableT2TViT, T2TViT

    model = (DistillableT2TViT if distillable else T2TViT)(**kw)
    return plain_modules(model) if plain else model


def plain_modules(model):
    """``model`` with each of its ``Transformer`` s on the plain modules
    (``fused_attention`` and ``fused_mlp`` ``"never"``, which also keeps an
    attention without an output projection off the flash tier), and each
    of CrossViT's ``NormedTransformer`` s (``fused_mlp="never"``): the plain
    path of a model whose constructor takes no such switch."""
    from vit_tpu_torch.layers.common import Transformer
    from vit_tpu_torch.models.cross_vit import NormedTransformer

    for m in model.modules():
        if isinstance(m, Transformer):
            m.fused_attention = m.fused_mlp = "never"
        elif isinstance(m, NormedTransformer):
            m.fused_mlp = "never"
    return model


def cross_vit(plain=False, **kw):
    """``CrossViT``; with ``plain``, its plain path (:func:`plain_modules`):
    its constructor, ``vit_tpu``'s, takes no such switch."""
    from vit_tpu_torch import CrossViT

    model = CrossViT(**kw)
    return plain_modules(model) if plain else model


class Objective:
    """A training objective's path: ``build(plain=False, **kw)`` makes the
    loss module (``kw``: ``compute_dtype``, ``generator``, ``dtype``) on the
    card, ``batch(g)`` what its forward takes first, from the seeded
    generator ``g``; ``draws``: whether the forward draws masks (its
    ``generator=``)."""

    def __init__(self, build, batch, draws=True):
        self.build, self.batch, self.draws = build, batch, draws

    def run(self, torch, model, batch, seed):
        """One ``make_loss_train_step`` step of ``model`` (AdamW at
        OBJECTIVE_LR) on ``batch``, a call without arguments; its masks drawn
        from a generator seeded ``seed`` at every step: one mask draw."""
        from vit_tpu_torch.parallel.train import make_loss_train_step

        step = make_loss_train_step(model, torch.optim.AdamW(model.parameters(), lr=OBJECTIVE_LR))
        if not self.draws:
            return lambda: step(batch)
        masks = torch.Generator(device="cuda")
        return lambda: step(batch, generator=masks.manual_seed(seed))


def objectives(torch):
    """The four objectives at run_benchmarks.py:105-128's configs: MAE
    (decoder 512 wide, depth 6, ratio 0.75), SimMIM (ratio 0.5), MPP (patch
    32, its defaults; pixels in [0, 1) as its buckets need), DeiT
    distillation (a ViT teacher, a DistillableViT student of the same shape,
    soft, T = 1, alpha 0.5, labels arange(64) % 1000); and T2T distillation,
    the same over a T2T-ViT@224 teacher and a DistillableT2TViT student of
    T2T's config."""
    from vit_tpu_torch import MAE, MPP, DistillableViT, DistillWrapper, SimMIM, ViT

    def images(g, uniform=False, size=OBJ_ENCODER["image_size"]):
        shape = (OBJECTIVE_BATCH, size, size, 3)
        return (torch.rand if uniform else torch.randn)(*shape, generator=g, device="cuda")

    def build(make):
        def built(plain=False, **kw):
            model = make(**kw)
            return plain_modules(model) if plain else model
        return built

    def distill(**kw):
        return DistillWrapper(ViT(**OBJ_ENCODER, **kw), DistillableViT(**OBJ_ENCODER, **kw),
                              temperature=1.0, alpha=0.5, **kw)

    def distill_t2t(**kw):
        return DistillWrapper(t2t_vit(**T2T, **kw), t2t_vit(**T2T, distillable=True, **kw),
                              temperature=1.0, alpha=0.5, **kw)

    labels = torch.arange(OBJECTIVE_BATCH, device="cuda") % OBJ_ENCODER["num_classes"]
    return {
        "MAE": Objective(build(lambda **kw: MAE(ViT(**OBJ_ENCODER, **kw), decoder_dim=512,
                                                masking_ratio=0.75, decoder_depth=6, **kw)),
                         images),
        "SimMIM": Objective(build(lambda **kw: SimMIM(ViT(**OBJ_ENCODER, **kw),
                                                      masking_ratio=0.5, **kw)), images),
        "MPP": Objective(build(lambda **kw: MPP(ViT(**OBJ_ENCODER, **kw),
                                               patch_size=OBJ_ENCODER["patch_size"], **kw)),
                         lambda g: images(g, uniform=True)),
        "DeiT distillation": Objective(build(distill), lambda g: (images(g), labels),
                                       draws=False),
        "T2T distillation": Objective(
            build(distill_t2t), lambda g: (images(g, size=T2T["image_size"]), labels),
            draws=False),
    }


def objective_phase(torch, tag, objective, seed, smi, counters, per_step, timing=None):
    """Train a training objective (``make_loss_train_step``, AdamW, f32
    parameters, bf16 compute) on one fixed batch and one fixed mask draw, as
    :func:`training_phase` trains a classifier: step-1 loss and gradients of
    the kernel path against the plain bf16 path and the f32 model of the same
    weights (TF32 off), TRAIN_STEPS steps with the launch counts of
    ``per_step``, finite falling losses, the step timed on both paths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    model = objective.build(compute_dtype=torch.bfloat16, generator=g)
    plain = objective.build(compute_dtype=torch.bfloat16, plain=True)
    f32 = objective.build(plain=True)
    for twin in (plain, f32):
        twin.load_state_dict(model.state_dict())
    batch = objective.batch(g)
    masks = torch.Generator(device="cuda")

    def loss_of(m):
        return m(batch, generator=masks.manual_seed(seed)) if objective.draws else m(batch)

    first, summary = step1_gradients(torch, tag, (model, plain, f32), None, None, loss_of)
    del f32
    torch.cuda.empty_cache()
    return train_path(torch, tag, OBJECTIVE_BATCH, model, plain, first, summary,
                      lambda m: objective.run(torch, m, batch, seed), f"AdamW({OBJECTIVE_LR:g})",
                      smi, counters, per_step, timing)


# csrc/kernels.cuh Epilogue, for the names of the linear_kernel instances.
EPILOGUES = {0: "store (QKV, doattn)", 1: "bias+GELU", 2: "bias+residual (out-proj, fc2)",
             3: "bias+GELU, keeps h (fc1)", 4: "dGELU (dy·W2)", 5: "f32 out (dxn)",
             6: "LN backward (dxn on chip)"}
# The dgrad whose epilogue is the LayerNorm backward, and the LayerNorm
# backward's passes over a stored f32 dxn that it replaces.
LN_EPILOGUE = "gemm_wgmma_kernel " + EPILOGUES[6]
LN_PASSES = ("ln_bwd_rows_kernel", "ln_bwd_cols_kernel")
PROFILE_STEPS = 5  # profiled steps, after 3 of warm-up


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's own kernels by role, the rest by
    kind."""
    m = re.search(r"linear_kernel<[^,]+, (\d+), (\d+)>", name)
    if m:
        return f"linear_kernel {EPILOGUES.get(int(m.group(1)), m.group(1))}"
    m = re.search(r"(flash_\w+_kernel)<[^,]+, (\d+), (\d+)(?:, \d+)?(?:, (true|false))?>",
                  name)
    if m:  # <T, dk, dv[, PARTS], BIAS>: the instances the block's mha route runs named so
        label = f"{m[1]} (dk {m[2]}, dv {m[3]}"
        if m[4] == "true":
            return label + ", bias: the biased block's mha route)"
        if m[2] == m[3] and int(m[2]) in (32, 64, 128):
            return label + ": the flash op or the block's mha route)"
        return label + ")"
    m = re.search(r"(short_\w+_kernel)<[^,]+, (\d+)(?:, (\d+))?(?:, \d+)?(, true)?(?:, false)?>",
                  name)
    if m:
        return f"{m.group(1)} (d {m.group(2)}" + (f", {m.group(3)}-key tiles" if m.group(3)
                                                  else "") + (", bias)" if m.group(4) else ")")
    m = re.search(r"(cross_fwd_kernel|cross_bwd_kernel)<[^,]+, (\d+), (\d+), \d+>", name)
    if m:
        return f"{m.group(1)} (dk {m.group(2)}, dv {m.group(3)})"
    if "cross_bwd_reduce_kernel" in name:  # before PyTorch's reductions
        return "cross_bwd_reduce_kernel"
    m = re.search(r"gemm_wgmma_kernel<[^,]+, (\d+)(?:, \d+)?>", name)
    if m:  # before the library's GEMMs: its name holds "gemm"
        return f"gemm_wgmma_kernel {EPILOGUES.get(int(m.group(1)), m.group(1))}"
    for own in ("mha_row_stats_kernel", "mha_bwd_dbias_kernel", "ln_bwd_rows_kernel",
                "ln_bwd_cols_kernel", "layernorm_kernel", "colsum_kernel", "rows_cols_kernel",
                "flash_bwd_dsum_kernel", "short_dq_sum_kernel", "layernorm_ragged_kernel",
                "ln_bwd_rows_ragged_kernel", "copy_rows_kernel"):
        if own in name:
            return own + (" (bias)" if "true>" in name else "")
    if re.search(r"conv|fprop|dgrad|wgrad", name, re.I):
        return ("cuDNN convolutions (SPT; CvT's embeddings and depthwise projections; "
                "ScalableViT's stem, k/v reductions, local modules, PEG, downsampling; "
                "Twins-SVT's k/v reductions and PEGs; CrossFormer's stems; NesT's aggregates; "
                "PiT's patch embedding and pools; LeViT's stem and stride-2 q; MobileViT's "
                "3x3 and depthwise convolutions)")
    if re.search(r"gemm|xmma|cutlass|sm90_|nvjet", name, re.I):
        return "cuBLAS GEMM (dW, patch embedding, head; 1x1 convs outside the kernels)"
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    if re.search(r"layer_norm|LayerNorm", name):
        return "PyTorch layer_norm (CvT's channel LayerNorms; NesT's aggregate and head norms)"
    if re.search(r"batch_norm|batchnorm", name, re.I):
        return "PyTorch batch_norm (CvT's projections; LeViT's and MobileViT's BatchNorms)"
    if "elementwise" in name:
        return "PyTorch elementwise (casts, adds, GELU, pads)"
    if "reduce" in name.lower():
        return "PyTorch reductions (statistics, loss, bias gradients)"
    return "other PyTorch kernels (copies, embedding, loss)"


def classifier_step(torch, vit, cfg, batch, size=None):
    """A :func:`profile_phase` builder: ``vit``'s classification train step
    (SGD at 1e-3) on a seeded batch, labels ``arange(batch) % classes``, one
    fixed draw where the model draws (:func:`draws`)."""
    from vit_tpu_torch.parallel.train import make_train_step

    def build(g):
        model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
        side = size or cfg["image_size"]
        images = torch.randn(batch, side, side, 3, generator=g, device="cuda")
        labels = torch.arange(batch, device="cuda") % cfg["num_classes"]
        draw = draws(torch, model, 0)
        return (lambda: step(images, labels, **draw())), "SGD(1e-3)"
    return build


def objective_step(torch, objective, seed=0):
    """A :func:`profile_phase` builder: an :class:`Objective`'s train step
    (AdamW at OBJECTIVE_LR) on its seeded batch and one mask draw."""
    def build(g):
        model = objective.build(compute_dtype=torch.bfloat16, generator=g)
        return objective.run(torch, model, objective.batch(g), seed), f"AdamW({OBJECTIVE_LR:g})"
    return build


def profile_phase(torch, tag, build, batch, seed, smi, ln_epilogues=None, ln_passes=False,
                  top=0):
    """Where a train step's device time goes: ``torch.profiler`` over a few
    steps of the training path, ``run, optimizer = build(g)`` (a train step
    without arguments and its optimizer's name, from the generator ``g``
    seeded ``seed``: :func:`classifier_step`, :func:`objective_step`).
    Prints the wall time per step (host clock around synchronised steps,
    profiler off and on), the device's busy time per step (the sum of its
    kernel times: one stream, so kernels do not overlap), the idle share
    against either wall time, the host's enqueue time per step (until the
    step returns, before the synchronise: a step whose enqueue time is its
    wall time is host-bound), the synchronising calls in one step
    (``torch.cuda.set_sync_debug_mode("warn")``), and the kernels grouped by
    what they do, with their time and launches per step.  A first one-step
    profile, thrown away, takes the profiler's start-up out of the timed one.
    Only the device's activity is recorded: the host's ops would add tens of
    thousands of events a step to process at a launch-bound config, and its
    time is the enqueue time above.  With ``ln_epilogues``, raises unless a
    step launches the LayerNorm-backward dgrad that many times and
    layernorm.cu's backward passes ``ln_passes`` times (False: none; True:
    any number), as the library counts them (:func:`counted_launches`).
    With ``top``, also the ``top`` kernels of the most device time a step,
    by name, ungrouped."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    run, optimizer = build(torch.Generator(device="cuda").manual_seed(seed))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    if ln_epilogues is not None:
        counts = counted_launches(torch, run)
        if counts["ln_epilogue"] != ln_epilogues or (
                ln_passes is not True and counts["ln_passes"] != int(ln_passes)):
            raise AssertionError(f"profile {tag}: launches a step {counts} ({ln_epilogues} of "
                                 f"the LayerNorm-backward dgrad expected"
                                 + ("" if ln_passes is True else
                                    f", {int(ln_passes)} of its passes") + ")")
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        run()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        t1 = time.perf_counter()
        run()
        enqueue.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CUDA]):
        run()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    groups, kernels = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((evt.self_device_time_total / 1e3 / PROFILE_STEPS, evt.count /
                        PROFILE_STEPS, evt.key))
        ms, count = groups.get(kernel_group(evt.key), (0.0, 0.0))
        groups[kernel_group(evt.key)] = (ms + evt.self_device_time_total / 1e3 / PROFILE_STEPS,
                                         count + evt.count / PROFILE_STEPS)
    busy = sum(ms for ms, _ in groups.values())
    if busy <= 0:
        log(f"profile {tag}: the profiler saw no device time; not measured")
        return
    log(f"profile {tag}: batch {batch}, f32 params, bf16 compute, {optimizer}, {PROFILE_STEPS} "
        f"steps on {smi}; wall ms/step {wall_ms:.3f} (profiler off), {prof_wall_ms:.3f} "
        f"(profiler on); device busy ms/step {busy:.3f}; idle share "
        f"{1 - busy / wall_ms:.3f} against the profiler-off wall time, "
        f"{1 - busy / prof_wall_ms:.3f} against the profiler-on one; host enqueue ms/step "
        f"median {statistics.median(enqueue):.3f} (profiler off); synchronising calls in "
        f"one step: {len(syncs)}")
    log("| kernels | ms / step | launches / step |")
    log("|---|---|---|")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"| {name} | {ms:.3f} | {count:g} |")
    if top:
        log(f"profile {tag}: the {top} kernels of the most device time a step")
        log("| kernel | group | ms / step | launches / step |")
        log("|---|---|---|---|")
        for ms, count, name in sorted(kernels, reverse=True)[:top]:
            log(f"| {name[:160]} | {kernel_group(name)} | {ms:.3f} | {count:g} |")


def kernel_entry(results, by_path, name, src, tpu, main_shape):
    """A kernel's line of the JSON summary: its launches over the main paths
    ``by_path`` (and per path), its largest error over every check, and its
    times and bound at ``main_shape`` (the block kernels' B/16, the biased
    block's small-dataset shape with LSA's bias, the flash kernels'
    CvT-13@224 stage 1, the cross-attention block's ScalableViT stage 1, the
    packed op's IWSA stage 1), its other timed shapes or biases under
    ``by_shape`` / ``by_bias``.  The block forwards' library call is
    PyTorch's bf16 modules, the block backwards' autograd through them for
    the kernel's own outputs (with the weight gradients beside the kernel
    plus its dW GEMMs); the flash kernels' is PyTorch's
    ``scaled_dot_product_attention`` (autograd through it for the backward);
    the cross-attention block's F.linear + SDPA + F.linear.  The flash
    backward's times through the packed op are under ``packed``."""
    kinds = results[name]
    r = kinds[main_shape]
    line = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": max(max(k.get("err", 0.0), k.get("train_fwd_err", 0.0))
                               for k in kinds.values()),
            "ms": r["kernel"], "plain_ms": r["plain"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library", r.get("modules")),
            "shape": main_shape}
    if "whole" in r:
        line.update(whole_ms=r["whole"], library_whole_ms=r["library_whole"])
    if "device" in r:  # the backwards whose LayerNorm backward is the dgrad's epilogue
        line.update(device_ms=r["device"])
    if "library_ln" in r:
        line.update(library_ln_ms=r["library_ln"])

    def table(rows):  # the timed records (a training forward's check has no times)
        return {tag: {k: v for k, v in k_r.items() if k != "bound"}
                | {"bound_ms": k_r["bound"][0]} for tag, k_r in rows.items() if "bound" in k_r}

    if len(table(kinds)) > 1:
        line["by_bias" if "bias" in name else "by_shape"] = table(kinds)
    if name in ("flash_attention", "flash_backward"):
        line["below_gate"] = {tag: times["forward" if name == "flash_attention" else "backward"]
                              for tag, times in results["below_gate"].items()}
    if name == "flash_backward":
        line["packed"] = table(results["flash_backward (packed)"])
    if name in ("fused_attention_block_bias", "fused_attention_block_bias_bwd"):
        # the biased block below the threshold on both routes (mha_route_phase)
        way = "forward" if name == "fused_attention_block_bias" else "backward"
        line["route_threshold_ms"] = {
            tag: {route: ms[f"{route} {way}"] for route in ("short", "mha")}
            for tag, ms in results["route threshold"].items()}
    if name in ("fused_attention_block", "fused_attention_block_bwd"):
        # the routes of both blocks (biased and not), forward and backward
        suffix = ", forward" if name == "fused_attention_block" else ""
        line["launches_by_route"] = {
            route: sum(counts[route + suffix] for counts in by_path.values())
            for route in ("short route", "mha route")}
    if name in DESIGNS:
        line["design"] = DESIGNS[name]
    return line


def ptxas_report(build_log: str) -> dict:
    """ptxas's registers, static shared memory and spill bytes of each
    instance of the wgmma+tma kernels, from the build's ``-Xptxas -v`` log:
    ``{"flash_bwd_dkv_kernel<bf16,64,64>": "212 registers, 0 bytes smem,
    0/0 bytes spilled (stores/loads)", ...}``."""
    report, name = {}, None
    pattern = re.compile(r"(flash_fwd_kernel|flash_bwd_dq_kernel|flash_bwd_dkv_kernel|"
                         r"short_fwd_kernel|short_bwd_kernel|short_bwd_wg_kernel|gemm_wgmma_kernel|"
                         r"cross_fwd_kernel|cross_bwd_kernel)I(6__half|13__nv_bfloat16)"
                         r"((?:L[ib]\d+E)*)")
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = pattern.search(line)
            name = m and ",".join([f"{m[1]}<{'f16' if m[2] == '6__half' else 'bf16'}",
                                   *(v if kind == "i" else "bias" for kind, v in
                                     re.findall(r"L([ib])(\d+)E", m[3])
                                     if kind == "i" or v == "1")]) + ">"
            spill = None
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            smem = re.search(r"(\d+) bytes smem", line)
            report[name] = (f"{regs} registers, {smem[1] if smem else 0} bytes smem, "
                            f"{'/'.join(spill or ['?', '?'])} bytes spilled (stores/loads)")
            name = None
    return report


# ---- the infrastructure: data-parallel step, checkpoints, export, the example trainer --------

INFRA_BATCH = 128   # bench.py's batch: the data-parallel step at ViT-B/32@256
INFRA_STEPS = 3     # steps of the bare and the data-parallel step from the same weights
FEED_STEPS = 8      # steps timed per way of feeding the batches (after 2 of warm-up)
EXPORT_BATCH = 8    # __graft_entry__.entry()'s batch: every export but the hybrid tier's
# The serving ops as the exported graphs name them, and the counter each counts on.
EXPORT_OPS = ("fused_mlp", "fused_attention_block", "fused_attention_block_bias",
              "fused_cross_attention", "flash_attention", "flash_attention_packed",
              "short_attention", "ln_gemm", "attention_nb", "proj_mlp")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_batches(count, batch, size, classes, seed):
    """``count`` batches of host memory as a loader hands them over: numpy
    f32 images ``(batch, size, size, 3)`` and int64 labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((batch, size, size, 3), dtype=np.float32),
             "label": (np.arange(batch) + i) % classes} for i in range(count)]


def max_param_diff(torch, a, b) -> float:
    """max |a - b| over two modules' state_dicts (0.0 when bit for bit equal)."""
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].float() - sb[k].float()).abs().max()) for k in sa)


def idle_share(trace_dir) -> tuple:
    """``(idle share, kernels' busy ms, window ms)`` of the newest Chrome trace
    under ``trace_dir``: the share of the window from the first to the last
    device event (kernels and copies) in which no kernel ran."""
    import glob

    path = max(glob.glob(os.path.join(trace_dir, "*.json")), key=os.path.getmtime)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        return None, 0.0, 0.0
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy, reach = 0.0, start
    for e in sorted((e for e in events if e["cat"] == "kernel"), key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], reach), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            reach = hi
    return 1.0 - busy / (end - start), busy / 1e3, (end - start) / 1e3


def data_parallel_phase(torch, smi, counters, workdir):
    """ViT-B/32@256 (bench.py), bf16 compute, f32 parameters, batch 128,
    SGD(1e-3, momentum 0.9: a state for the checkpoint to carry) on a
    single-process NCCL group (``initialize_distributed`` from a launcher's
    environment on a free localhost port, ``make_mesh()``): INFRA_STEPS steps
    of ``make_train_step(..., mesh=mesh)`` fed by ``prefetch(ThreadedLoader,
    device_put=shard_batch)`` from host numpy against the bare step's fed by
    synchronous copies, from the same weights: the parameters bit for bit
    (one rank: the all-reduce is an identity), rows 1-4 six times each a step
    (its main path, counters from 0).  Then checkpoint and resume
    (:func:`checkpoint_phase`), step ms with and without the mesh, the
    prefetched against the synchronous feed (step ms and the profile's idle
    share) and ``op_breakdown`` of the data-parallel step's trace beside
    ``launch_breakdown`` of the bare step.  The group is destroyed at the
    end."""
    from functools import partial

    from vit_tpu_torch import ViT
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.train import make_train_step
    from vit_tpu_torch.utils.data import ThreadedLoader, prefetch, shard_batch
    from vit_tpu_torch.utils.profiling import op_breakdown, trace

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(env)
    try:
        group = initialize_distributed(timeout_s=300)
        backend = torch.distributed.get_backend()
        if group != (0, 1) or backend != "nccl":
            raise AssertionError(f"data-parallel: group {group} on {backend}, expected (0, 1) "
                                 f"on nccl")
        mesh = make_mesh()
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(46)
        bare_model = ViT(**ENTRY, compute_dtype=torch.bfloat16, generator=g)
        dp_model = ViT(**ENTRY, compute_dtype=torch.bfloat16)
        dp_model.load_state_dict(bare_model.state_dict())

        def sgd(m):
            return torch.optim.SGD(m.parameters(), lr=1e-3, momentum=0.9)

        bare = make_train_step(bare_model, sgd(bare_model))
        dp = make_train_step(dp_model, sgd(dp_model), mesh=mesh)
        host = host_batches(INFRA_STEPS + 1, INFRA_BATCH, ENTRY["image_size"],
                            ENTRY["num_classes"], 47)

        def synchronous(batch):
            return (torch.from_numpy(batch["image"]).to(dev),
                    torch.from_numpy(batch["label"]).to(dev))

        bare_losses = [bare(*synchronous(host[i]))["loss"].item() for i in range(INFRA_STEPS)]
        loader = ThreadedLoader(lambda i: host[i], INFRA_STEPS)
        batches = prefetch(iter(loader), device_put=partial(shard_batch, mesh=mesh))
        for c in counters.values():
            c.launches = 0
        dp_losses = [dp(b["image"], b["label"])["loss"].item() for b in batches]
        launches = {name: c.launches for name, c in counters.items()}
        per_step = per_layer(ENTRY, "fused_attention_block", "fused_mlp",
                                    "fused_attention_block_bwd", "fused_mlp_bwd",
                                    "short route", "short route, forward")
        check_launches("data-parallel B/32", f"{INFRA_STEPS} steps", counters, per_step,
                       INFRA_STEPS)
        diff = max_param_diff(torch, bare_model, dp_model)
        log(f"data-parallel ViT-B/32@256: batch {INFRA_BATCH}, bf16 compute, f32 params, "
            f"SGD(1e-3, momentum 0.9), NCCL group of 1 on {mesh}; losses over {INFRA_STEPS} "
            f"steps: mesh {dp_losses}, bare {bare_losses}; max|params mesh - bare| = {diff} "
            f"(one rank: the all-reduce of the flat f32 gradients is an identity, and "
            f"prefetch's side-stream copies give the synchronous copies' bits); launches "
            f"per step {per_step}")
        if diff != 0.0 or dp_losses != bare_losses:
            raise AssertionError(f"data-parallel: the mesh step differs from the bare one "
                                 f"by {diff} (losses {dp_losses} against {bare_losses})")

        checkpoint_phase(torch, smi, mesh, dp, dp_model, synchronous(host[INFRA_STEPS]),
                         sgd, workdir)

        images, labels = synchronous(host[0])
        ms = interleaved_medians(torch, {"bare": lambda: bare(images, labels),
                                         "mesh": lambda: dp(images, labels)}, rounds=3,
                                 calls=3)
        feed = {}
        for way in ("synchronous", "prefetch"):
            def run(steps, way=way):
                if way == "synchronous":
                    for i in range(steps):
                        dp(*synchronous(host[i % 2]))
                else:
                    loader = ThreadedLoader(lambda i: host[i % 2], steps)
                    for b in prefetch(iter(loader), device_put=partial(shard_batch, mesh=mesh)):
                        dp(b["image"], b["label"])
                torch.cuda.synchronize()

            run(2)
            t0 = time.perf_counter()
            run(FEED_STEPS)
            wall = (time.perf_counter() - t0) / FEED_STEPS * 1e3
            trace_dir = os.path.join(workdir, f"trace_{way}")
            with trace(trace_dir):
                run(4)
            feed[way] = (wall, *idle_share(trace_dir))
        rows = op_breakdown(os.path.join(workdir, "trace_prefetch"), top=8)
        bare_rows = launch_breakdown(torch, lambda: bare(images, labels))
        log(f"data-parallel step ms (median of 3 rounds of 3, one fixed device batch): mesh "
            f"{ms['mesh']:.3f}, bare {ms['bare']:.3f} ({ms['mesh'] / ms['bare']:.3f}x); fed "
            f"from host numpy, wall ms a step over {FEED_STEPS} steps and the profile's idle "
            f"share (busy / window ms over 4 steps): synchronous copies "
            f"{feed['synchronous'][0]:.3f}, idle {feed['synchronous'][1]:.3f} "
            f"({feed['synchronous'][2]:.3f} / {feed['synchronous'][3]:.3f}); prefetch on a "
            f"side stream {feed['prefetch'][0]:.3f}, idle {feed['prefetch'][1]:.3f} "
            f"({feed['prefetch'][2]:.3f} / {feed['prefetch'][3]:.3f}) on {smi}")
        log("data-parallel step's trace, op_breakdown over 4 prefetched steps (ms, share): "
            + "; ".join(f"{r['name'][:60]} x{r['occurrences']} {r['total_ms']:.3f} "
                        f"({r['pct']:.1f}%)" for r in rows)
            + f" | the bare step, launch_breakdown a step: {breakdown_text(bare_rows)}")
        return launches
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def per_layer(cfg, *names):
    """``{name: cfg["depth"]}``: one launch of each named kernel a layer."""
    return {name: cfg["depth"] for name in names}


def checkpoint_phase(torch, smi, mesh, step, model, batch, optimizer_of, workdir):
    """``CheckpointManager.save(step, state, wait=False)`` of the data-parallel
    step's state, one more step, ``wait()``; a fresh model and optimizer
    restored from it take that step too, and must end bit for bit where the
    original did.  Save (the host snapshot), write and restore seconds, bytes
    on disk."""
    import shutil

    from vit_tpu_torch import ViT
    from vit_tpu_torch.interop.checkpoint import CheckpointManager
    from vit_tpu_torch.parallel.train import make_train_step

    directory = os.path.join(workdir, "checkpoints")
    manager = CheckpointManager(directory, max_to_keep=2)
    saved_at = step.state.step
    t0 = time.perf_counter()
    manager.save(saved_at, step.state, wait=False)
    save_s = time.perf_counter() - t0
    step(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.wait()
    wait_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(directory, f)) for f in os.listdir(directory))
    fresh = ViT(**ENTRY, compute_dtype=torch.bfloat16)
    resumed = make_train_step(fresh, optimizer_of(fresh), mesh=mesh)
    t0 = time.perf_counter()
    manager.restore(target=resumed.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_step = resumed.state.step
    resumed(*batch)
    diff = max_param_diff(torch, model, fresh)
    momentum = max(float((a["momentum_buffer"] - b["momentum_buffer"]).abs().max())
                   for a, b in zip(step.state.optimizer.state.values(),
                                   resumed.state.optimizer.state.values()))
    log(f"checkpoint and resume (ViT-B/32@256, the data-parallel step's state at step "
        f"{saved_at}): save returned in {save_s:.3f} s (host snapshot), the write done "
        f"{wait_s:.3f} s after one more step, {nbytes} bytes on disk; restore "
        f"{restore_s:.3f} s into a fresh model and optimizer (step {restored_step}); after one "
        f"more step each, max|params resumed - original| = {diff}, max|momentum diff| = "
        f"{momentum}, step {resumed.state.step} and {step.state.step}, on {smi}")
    shutil.rmtree(directory)
    if diff != 0.0 or momentum != 0.0 or restored_step != saved_at \
            or resumed.state.step != step.state.step:
        raise AssertionError("checkpoint: the resumed run does not continue bit for bit")


def one_op(torch, fn):
    """``fn`` as a module, ``forward(*args) = fn(*args)``, for export."""
    class Module(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    return Module()


def export_phase(torch, smi, counters):
    """Each serving model exported with ``export_forward`` (rows 1 and 3 at
    the entry ViT-B/32 in both layouts, rows 12-14 at the hybrid tier, row 5
    at the small-dataset ViT, row 7 at CvT-13@224, rows 6 and 10 at
    ScalableViT@256; baked but the first), and one-op modules of
    ``short_attention`` (row 11) and of the flash op at its streamed shape
    (row 9), loaded back with ``load_forward``: the loaded output equals the
    eager model's bit for bit, the graph holds each op as often as the eager
    forward launches it, and a loaded forward moves every counter (the
    routes' too) as the eager one does.  Export and load seconds, and the
    loaded forward's ms beside the eager one.  Returns the launches of the
    loaded forwards (its main path: counters from 0 before each)."""
    from vit_tpu_torch import CvT, ScalableViT, ViT
    from vit_tpu_torch.interop.export import export_forward, load_forward, model_params
    from vit_tpu_torch.models import vit_for_small_dataset
    from vit_tpu_torch.ops.flash_attention import flash_attention
    from vit_tpu_torch.ops.short_attention import short_attention

    dev = torch.device("cuda")

    def model_case(build, cfg, batch, size, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        model = build(**cfg, compute_dtype=torch.bfloat16, generator=g).eval()
        img = torch.randn(batch, size, size, 3, generator=g, device=dev)
        return model, (img,)

    def attention_case(fn, b, h, n_q, n_k, d, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(torch.bfloat16)
                   for n in (n_q, n_k, n_k))
        return one_op(torch, fn), (q, k, v)

    short = SHORT_SHAPES[0][1:]
    streamed = next(s for s in FLASH_SHAPES if s[0].startswith("n=8192"))[1:]
    # (tag, module, inputs, bake_params; None for a one-op module, exported as it is)
    entry = model_case(ViT, ENTRY, EXPORT_BATCH, 256, 50)
    cases = [
        ("ViT-B/32@256 (entry), params an input", *entry, False),
        ("ViT-B/32@256 (entry), baked", *entry, True),
        # The hybrid tier's gate (b >= 64, b·n >= 2048) holds at bench.py's batch, not at 8.
        ("ViT-B/32@256 hybrid, batch 128", *model_case(hybrid_vit, ENTRY, 128, 256, 51), True),
        ("small-dataset ViT 256/16", *model_case(vit_for_small_dataset.ViT, SMALL_DATASET,
                                                 EXPORT_BATCH, 256, 52), True),
        ("CvT-13@224", *model_case(CvT, CVT13, EXPORT_BATCH, 224, 53), True),
        ("ScalableViT@256", *model_case(ScalableViT, SCALABLE, EXPORT_BATCH, SCALABLE_SIZE, 54),
         True),
        (f"short_attention {short}", *attention_case(short_attention, *short, 55), None),
        (f"flash_attention {streamed}", *attention_case(flash_attention, *streamed, 56), None),
    ]
    total = {name: 0 for name in counters}
    for tag, model, args, bake in cases:
        def count(fn):
            for c in counters.values():
                c.launches = 0
            with torch.no_grad():
                out = fn()
            torch.cuda.synchronize()
            return out, {name: c.launches for name, c in counters.items()}

        eager, eager_counts = count(lambda: model(*args))
        t0 = time.perf_counter()
        if bake is None:
            with torch.no_grad():
                program = torch.export.export(model, args)
            buffer = io.BytesIO()
            torch.export.save(program, buffer)
            data = buffer.getvalue()
        else:
            data = export_forward(model, args[0].shape, bake_params=bake)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_forward(data)
        load_s = time.perf_counter() - t0
        call_args = (model_params(model), *args) if bake is False else args
        served, served_counts = count(lambda: loaded(*call_args))
        nodes = {}
        for node in loaded.graph.nodes:
            name = str(node.target).split(".")
            if name[0] == "vit_tpu_torch":
                nodes[name[1]] = nodes.get(name[1], 0) + 1
        want_nodes = {name: eager_counts[name] for name in EXPORT_OPS if eager_counts[name]}
        with torch.no_grad():
            ms = interleaved_medians(torch, {"eager": lambda: model(*args),
                                             "loaded": lambda: loaded(*call_args)},
                                     rounds=3, calls=3, warmup=2)
        equal = torch.equal(served, eager)
        log(f"export {tag}: {len(data)} bytes, export {export_s:.2f} s, load {load_s:.2f} s; "
            f"ops in the graph {nodes}, eager launches "
            f"{ {k: v for k, v in eager_counts.items() if v} }; loaded output "
            f"{'equals' if equal else 'DIFFERS from'} eager bit for bit "
            f"(max|diff| {float((served.float() - eager.float()).abs().max())}); forward ms "
            f"loaded {ms['loaded']:.3f}, eager {ms['eager']:.3f} on {smi}")
        if not equal or nodes != want_nodes or served_counts != eager_counts or not nodes:
            raise AssertionError(f"export {tag}: output equal {equal}, graph {nodes} against "
                                 f"eager launches {want_nodes}, loaded launches "
                                 f"{served_counts} against {eager_counts}")
        for name, n in served_counts.items():
            total[name] += n
        del loaded
    return total


def example_phase(torch, smi, workdir):
    """``examples/train_classifier_torch.py --model vit --steps 20 --batch 64
    --bf16`` as a subprocess (one process, no group), with a checkpoint
    directory and a serving artifact: exit 0, a JSON line with a finite loss
    for each of the 20 steps (its logger flushes every 10), a checkpoint at
    step 20, an artifact that loads and serves."""
    from vit_tpu_torch.interop.export import load_forward_file

    ckpt, artifact = os.path.join(workdir, "example_ckpt"), os.path.join(workdir, "vit.pt2")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "examples/train_classifier_torch.py", "--model", "vit", "--steps",
         "20", "--batch", "64", "--bf16", "--ckpt-dir", ckpt, "--export", artifact],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    losses = [line["loss"] for line in lines]
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    served = None
    if proc.returncode == 0 and os.path.exists(artifact):
        with torch.no_grad():
            # The example exports for its compute dtype's images, as vit_tpu's does.
            served = load_forward_file(artifact)(
                torch.randn(64, 224, 224, 3, device="cuda").to(torch.bfloat16))
    log(f"example trainer (vit, 20 steps, batch 64, bf16): exit {proc.returncode} in "
        f"{wall:.1f} s; losses {losses}; checkpoints {files}; artifact "
        f"{os.path.getsize(artifact) if os.path.exists(artifact) else 0} bytes, served "
        f"{None if served is None else tuple(served.shape)} on {smi}")
    steps = [line["step"] for line in lines]
    if proc.returncode != 0 or steps != list(range(1, 21)) \
            or not all(math.isfinite(v) for v in losses) \
            or files != ["checkpoint_20.pt"] or served is None \
            or not bool(torch.isfinite(served).all()):
        raise AssertionError(f"example trainer failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-4000:]}")


# ---- tensor parallelism (the mesh's model axis) -------------------------------

TP = 2                    # the model axis of the tensor-parallel phases
# bench.py's ViT-B/32 block: b, n, d, heads, dim_head, hidden; per rank at tp 2:
# 8 heads (local qkv width 1536, out-projection K 512) and 1024 hidden units.
TP_SHAPE = (128, 65, 1024, 16, 64, 2048)
TP_STEPS = 3
TP_SEED = 71
TP_LABEL = "two processes time-sharing one card over gloo: not a TP speed"
TP_JOIN_S = 600
# The split forms' JSON names, each with its source and the TPU kernels
# whose split form it is (vit_tpu has none of its own: GSPMD gathers a
# Pallas call's operands).
TP_SOURCES = {
    "fused_attention_block_split": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                    "vit_tpu/ops/fused_attention_block.py:106"),
    "fused_attention_block_split_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                        "vit_tpu/ops/fused_attention_block.py:169"),
    "fused_mlp_split": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:147"),
    "fused_mlp_split_bwd": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:177"),
    "fused_attention_block_bias_split": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                         "vit_tpu/ops/fused_attention_block.py:515"),
    "fused_attention_block_bias_split_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                             "vit_tpu/ops/fused_attention_block.py:545"),
    "fused_cross_attention_split": ("vit_tpu_torch/csrc/fused_cross_attention.cu",
                                    "vit_tpu/ops/fused_cross_attention.py:212"),
    "fused_cross_attention_split_bwd": ("vit_tpu_torch/csrc/fused_cross_attention.cu",
                                        "vit_tpu/ops/fused_cross_attention.py:256"),
    "flash_attention_packed_split": ("vit_tpu_torch/csrc/flash_attention.cu",
                                     "vit_tpu/ops/flash_attention_packed.py:114"),
    "flash_attention_packed_split_bwd": ("vit_tpu_torch/csrc/flash_attention.cu",
                                         "vit_tpu/ops/flash_attention_packed.py:190, "
                                         "vit_tpu/ops/flash_backward.py:41, :72"),
    "forward_gemm_f32": ("vit_tpu_torch/csrc/gemm_wgmma.cu",
                         "vit_tpu/ops/fused_attention_block.py:106, vit_tpu/ops/fused_mlp.py:147"),
    "bias_residual": ("vit_tpu_torch/csrc/bias_residual.cu",
                      "vit_tpu/ops/fused_attention_block.py:106, vit_tpu/ops/fused_mlp.py:147"),
    "ln_bwd": ("vit_tpu_torch/csrc/layernorm.cu",
               "vit_tpu/ops/fused_attention_block.py:169, vit_tpu/ops/fused_mlp.py:177"),
}
COUNTED_F32 = 4  # csrc/kernels.cuh kCountForwardF32: launch_forward_gemm's f32 partial sums


def counter_objects():
    """Every kernel's launch counter by name, as the main paths read them
    (each wrapper's ``.launches``; the blocks' attention middles and the
    cross-attention backward also by route)."""
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.ops.flash_attention import flash_attention, flash_backward
    from vit_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from vit_tpu_torch.ops.fused_attention_block import (
        BACKWARD_ROUTES, FORWARD_ROUTES, fused_attention_block, fused_attention_block_backward,
        fused_attention_block_bias, fused_attention_block_bias_backward,
        fused_attention_block_bias_partial_backward, fused_attention_block_bias_partial_forward,
        fused_attention_block_partial_backward, fused_attention_block_partial_forward,
    )
    from vit_tpu_torch.ops.fused_cross_attention import (
        BACKWARD_ROUTES as CROSS_BACKWARD_ROUTES, fused_cross_attention,
        fused_cross_attention_backward, fused_cross_attention_partial_backward,
        fused_cross_attention_partial_forward,
    )
    from vit_tpu_torch.ops.fused_hybrid import (
        attention_nb, attention_nb_backward, ln_gemm, ln_gemm_backward, proj_mlp,
        proj_mlp_backward,
    )
    from vit_tpu_torch.ops.fused_mlp import (
        fused_mlp, fused_mlp_backward, fused_mlp_partial_backward, fused_mlp_partial_forward,
    )
    from vit_tpu_torch.ops.short_attention import short_attention, short_attention_backward

    return {"fused_attention_block": fused_attention_block, "fused_mlp": fused_mlp,
            "fused_attention_block_bwd": fused_attention_block_backward,
            "fused_mlp_bwd": fused_mlp_backward,
            "fused_attention_block_bias": fused_attention_block_bias,
            "fused_attention_block_bias_bwd": fused_attention_block_bias_backward,
            # the blocks' attention middles by route (fused_attention_block.py
            # attention_route), each direction: short_fwd / short_bwd up to 512 tokens,
            # with or without a bias, else the flash kernels (PiT's stage 1 and the
            # "mha route" path; the other paths hold them at 0)
            "short route": BACKWARD_ROUTES["short"], "mha route": BACKWARD_ROUTES["mha"],
            "short route, forward": FORWARD_ROUTES["short"],
            "mha route, forward": FORWARD_ROUTES["mha"],
            "flash_attention": flash_attention, "flash_backward": flash_backward,
            "fused_cross_attention": fused_cross_attention,
            "fused_cross_attention_bwd": fused_cross_attention_backward,
            # its backward by route (fused_cross_attention.py backward_route): one
            # cross_bwd kernel up to 128 channels, cross_bwd between gemm_wgmma's
            # dgrads from 129 (the four steps past 128 keys run on no main path:
            # the cross-attention phase holds them at 384 px)
            "cross backward, one kernel": CROSS_BACKWARD_ROUTES[1],
            "cross backward, split": CROSS_BACKWARD_ROUTES[2],
            "flash_attention_packed": flash_attention_packed,
            "short_attention": short_attention,
            "short_attention_bwd": short_attention_backward,
            "ln_gemm": ln_gemm, "ln_gemm_bwd": ln_gemm_backward,
            "attention_nb": attention_nb, "attention_nb_bwd": attention_nb_backward,
            "proj_mlp": proj_mlp, "proj_mlp_bwd": proj_mlp_backward,
            # rows 1-4's split forms (tensor parallelism; the tensor-parallel path
            # alone, in its two processes) and the passes that end them
            "fused_attention_block_split": fused_attention_block_partial_forward,
            "fused_attention_block_split_bwd": fused_attention_block_partial_backward,
            "fused_mlp_split": fused_mlp_partial_forward,
            "fused_mlp_split_bwd": fused_mlp_partial_backward,
            # row 5's split form (the small-dataset ViT's, CrossFormer's and
            # RegionViT's biased blocks; the tensor-parallel path alone)
            "fused_attention_block_bias_split": fused_attention_block_bias_partial_forward,
            "fused_attention_block_bias_split_bwd": fused_attention_block_bias_partial_backward,
            # row 6's split form (Twins-SVT's global attentions; its backward
            # also counts on "cross backward, split", the route it takes)
            "fused_cross_attention_split": fused_cross_attention_partial_forward,
            "fused_cross_attention_split_bwd": fused_cross_attention_partial_backward,
            "bias_residual": tp.bias_residual, "ln_bwd": tp.ln_backward}


def tp_bounds(b, n, d, heads, dim_head, hidden, hb=0, dbias=False):
    """Bounds of the split forms at one rank's shape (``heads`` and
    ``hidden`` the local counts; bf16 activations and weights, f32 partial
    sums), each input read once and each output written once.  Row 5's
    split form reads an f32 ``(hb, n, n)`` logits bias besides (hb 1 for a
    shared table, read once; the local heads for a per-head one), and its
    backward writes dbias of that shape when ``dbias``; the bias adds and
    dbias's sums are not tensor-core work."""
    rows, inner = b * n, heads * dim_head
    attn = 2 * b * heads * n * n * dim_head
    act, acc = rows * d * 2, rows * d * 4  # one (rows, d) bf16 tensor; its f32 sum
    bias = 4 * hb * n * n
    fwd = (8 * rows * d * inner + 2 * attn, act + 4 * d + 8 * d * inner + acc)
    bwd = (8 * rows * d * inner + 5 * attn,
           act + 2 * (rows * 4 * inner * 2) + 4 * b * heads * n + 8 * d * inner + acc)
    return {
        # x, γ, β, Wqkv_r, Wo_r -> s
        "fused_attention_block_split": bound(*fwd),
        # dy, qkv, oattn, lse, Wqkv_r, Wo_r -> dqkv, doattn, dxn
        "fused_attention_block_split_bwd": bound(*bwd),
        # ... and the bias in; ... and the bias in, dbias out
        "fused_attention_block_bias_split": bound(fwd[0], fwd[1] + bias),
        "fused_attention_block_bias_split_bwd": bound(bwd[0],
                                                      bwd[1] + bias * (2 if dbias else 1)),
        # x, γ, β, W1_r, b1_r, W2_r -> s
        "fused_mlp_split": bound(4 * rows * d * hidden, act + 4 * d + 4 * d * hidden
                                 + 2 * hidden + acc),
        # dy, h, W1_r, W2_r -> dh, gact, db1, dxn
        "fused_mlp_split_bwd": bound(4 * rows * d * hidden,
                                     act + 3 * rows * hidden * 2 + 4 * d * hidden
                                     + 4 * hidden + acc),
        # oattn_r (rows, inner) · Wo_rᵀ -> f32; g_r (rows, hidden) · W2_rᵀ -> f32
        "forward_gemm_f32": bound(2 * rows * d * inner, rows * inner * 2 + d * inner * 2 + acc),
        "forward_gemm_f32 (fc2)": bound(2 * rows * d * hidden,
                                        rows * hidden * 2 + d * hidden * 2 + acc),
        # s, b, x -> y
        "bias_residual": bound(2 * rows * d, acc + 2 * act + 2 * d),
        # x, dxn, γ, dy -> dx and f32 [dγ | dβ | Σ dy]
        "ln_bwd": bound(10 * rows * d, 3 * act + acc + 2 * d + 12 * d),
    }


def tp_kernel_phase(torch, results, smi):
    """The split forms of rows 1-4 at one rank's shapes of bench.py's
    ViT-B/32 split over TP = 2 ranks (b 128, n 65, d 1024, 8 heads of 64,
    1024 hidden units), seeded bf16 inputs and one full set of weights cut
    into the ranks' slices (``parallel/sharding.py``'s ``shard_tensor``):
    each against its plain version, twice bit for bit (the f32-partial
    forward GEMM on both GEMM kernels at the out-projection's K 512 and fc2's
    K 1024; the bias-residual pass; both blocks' partial forwards and, fed
    their own residuals, backwards; the LayerNorm-backward entry).  Then the
    two ranks emulated in one process, their partials summed (the all-reduce
    of two ranks adds the same two terms) and the block ended by the pass or
    the LayerNorm backward, against the unsplit kernels' y, dx and sums at
    the full shape.  Times of each split form (rank 0's slice), its plain
    version, PyTorch's composition of the same function at 8 heads
    (F.layer_norm + F.linear + SDPA + F.linear; autograd through it for the
    backwards) and the bound, beside the unsplit kernel at the full shape;
    stored under ``results["tensor-parallel"]``."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops import fused_hybrid as fh
    from vit_tpu_torch.ops import fused_mlp as fm
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.parallel.sharding import COLUMN, QKV, ROW, shard_tensor

    b, n, d, heads, dh, hidden = TP_SHAPE
    hl, hid = heads // TP, hidden // TP
    rows, inner, scale, eps = b * n, heads * dh, dh ** -0.5, 1e-3
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(TP_SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x, gamma, beta = rn(b, n, d), 1.0 + rn(d, scale=0.1), rn(d, scale=0.1)
    wqkv, wo, bo = rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5), \
        rn(d, scale=0.1)
    w1, b1 = rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1)
    w2, b2 = rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1)
    dy = rn(b, n, d, scale=0.1)
    ranks = [dict(wqkv=shard_tensor(wqkv, QKV, r, TP), wo=shard_tensor(wo, ROW, r, TP),
                  w1=shard_tensor(w1, COLUMN, r, TP), b1=shard_tensor(b1, COLUMN, r, TP),
                  w2=shard_tensor(w2, ROW, r, TP)) for r in range(TP)]
    w = ranks[0]
    bounds = tp_bounds(b, n, d, hl, dh, hid)
    out = {}

    def twice(name, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for i, (p, q) in enumerate(zip(first, again)):
            if p is not None and not torch.equal(p, q):
                raise AssertionError(f"{name} output {i}: two runs differ")
        return first

    def hold(name, got, ref, residuals, f32_sums=()):
        err = check_outputs(torch, name, [t for i, t in enumerate(got) if i not in f32_sums],
                            [t for i, t in enumerate(ref) if i not in f32_sums], residuals)
        for i in f32_sums:
            err = max(err, check_dbias(torch, name, got[i], ref[i], f"sum {i}"))
        return err

    # The f32-partial forward GEMM (kEpiStoreF32 over kWeightNK) on both kernels.
    gemm = {}
    for label, k in (("out-projection", hl * dh), ("fc2", hid)):
        a, wt = rn(rows, k), (w["wo"] if k == hl * dh else w["w2"])
        ref = fh.gemm_reference(a, wt, "f32")[:1]
        for kernel in ("wgmma", "mma_sync"):
            got = twice(f"forward GEMM f32 {label} {kernel}",
                        lambda: fh.gemm_wgmma(a, wt, "f32", kernel=kernel)[:1])
            gemm[f"{label} {kernel}"] = hold(f"forward GEMM f32 {label} {kernel}", got, ref, {})
        ms = interleaved_medians(torch, {
            "kernel": lambda: fh.gemm_wgmma(a, wt, "f32"),
            "mma_sync": lambda: fh.gemm_wgmma(a, wt, "f32", kernel="mma_sync"),
            "plain": lambda: fh.gemm_reference(a, wt, "f32"),
            "library": lambda: F.linear(a, wt)}, rounds=3, calls=5)
        key = "forward_gemm_f32" if label == "out-projection" else "forward_gemm_f32 (fc2)"
        out[key] = dict(err=max(gemm.values()), kernel=ms["kernel"], mma_sync=ms["mma_sync"],
                        plain=ms["plain"], library=ms["library"], bound=bounds[key])

    # The bias-residual pass.
    s = torch.randn(b, n, d, generator=g, device=dev)
    got = twice("bias_residual", lambda: [tp.bias_residual(s, bo, x)])
    err = hold("bias_residual", got, [tp.bias_residual_reference(s, bo, x)], {0: x})
    ms = interleaved_medians(torch, {"kernel": lambda: tp.bias_residual(s, bo, x),
                                     "plain": lambda: tp.bias_residual_reference(s, bo, x)},
                             rounds=3, calls=10)
    out["bias_residual"] = dict(err=err, kernel=ms["kernel"], plain=ms["plain"], library=None,
                                bound=bounds["bias_residual"])

    # The attention block's split form, forward (serving and training) and backward.
    def attn_fwd(training=False, r=w):
        return fab.fused_attention_block_partial_forward(x, gamma, beta, r["wqkv"], r["wo"], hl,
                                                         dh, scale, eps, training)

    got = twice("fused_attention_block split", lambda: attn_fwd(True))
    ref = fab.fused_attention_block_partial_forward_reference(x, gamma, beta, w["wqkv"], w["wo"],
                                                              hl, dh, scale, eps)
    err = hold("fused_attention_block split", got[:4], ref[:4], {})
    # lse on the kernel's own qkv: a flipped rounding of qkv moves it past 1e-3
    lse_err = (got[4] - fab.attention_lse_reference(got[2], hl, dh, scale)).abs().max().item()
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"fused_attention_block split: lse differs by {lse_err}")
    _, _, qkv_r, oattn_r, lse_r = got

    def attn_bwd():
        return fab.fused_attention_block_partial_backward(dy, qkv_r, oattn_r, lse_r, w["wqkv"],
                                                          w["wo"], hl, dh, scale)

    got_b = twice("fused_attention_block split backward", attn_bwd)
    ref_b = fab.fused_attention_block_partial_backward_reference(dy, qkv_r, oattn_r, lse_r,
                                                                 w["wqkv"], w["wo"], hl, dh, scale)
    err_b = hold("fused_attention_block split backward", got_b, ref_b, {})

    xn_leaf = F.layer_norm(x, (d,), gamma, beta, eps).detach().requires_grad_()

    def attn_library(xn_):
        q, k, v = F.linear(xn_, w["wqkv"]).view(b, n, 3, hl, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return F.linear(o.transpose(1, 2).reshape(b, n, hl * dh), w["wo"])

    lib_y = attn_library(xn_leaf)
    with torch.inference_mode():
        fwd = interleaved_medians(torch, {
            "kernel": attn_fwd,
            "plain": lambda: fab.fused_attention_block_partial_forward_reference(
                x, gamma, beta, w["wqkv"], w["wo"], hl, dh, scale, eps),
            "library": lambda: attn_library(F.layer_norm(x, (d,), gamma, beta, eps)),
            "with the pass": lambda: tp.bias_residual(attn_fwd()[0], bo, x),
            "unsplit": lambda: fab.fused_attention_block(x, gamma, beta, wqkv, wo, bo, heads,
                                                         dh, scale, eps)}, rounds=3, calls=5)
    bwd = interleaved_medians(torch, {
        "kernel": attn_bwd,
        "plain": lambda: fab.fused_attention_block_partial_backward_reference(
            dy, qkv_r, oattn_r, lse_r, w["wqkv"], w["wo"], hl, dh, scale),
        "library": lambda: torch.autograd.grad(lib_y, xn_leaf, dy, retain_graph=True)},
        rounds=3, calls=5)
    out["fused_attention_block_split"] = dict(
        err=err, kernel=fwd["kernel"], plain=fwd["plain"], library=fwd["library"],
        with_pass=fwd["with the pass"], unsplit=fwd["unsplit"],
        bound=bounds["fused_attention_block_split"])
    out["fused_attention_block_split_bwd"] = dict(
        err=err_b, kernel=bwd["kernel"], plain=bwd["plain"], library=bwd["library"],
        bound=bounds["fused_attention_block_split_bwd"])
    del lib_y, xn_leaf

    # The fused MLP's split form.
    def mlp_fwd(training=False, r=w):
        return fm.fused_mlp_partial_forward(x, gamma, beta, r["w1"], r["b1"], r["w2"], eps,
                                            training)

    got = twice("fused_mlp split", lambda: mlp_fwd(True))
    ref = fm.fused_mlp_partial_forward_reference(x, gamma, beta, w["w1"], w["b1"], w["w2"], eps)
    err = hold("fused_mlp split", got, ref, {})
    h_r = got[2]

    def mlp_bwd():
        return fm.fused_mlp_partial_backward(dy, h_r, w["w1"], w["w2"])

    got_b = twice("fused_mlp split backward", mlp_bwd)
    ref_b = fm.fused_mlp_partial_backward_reference(dy, h_r, w["w1"], w["w2"])
    err_b = hold("fused_mlp split backward", got_b, ref_b, {}, f32_sums=(3,))
    xn_leaf = F.layer_norm(x, (d,), gamma, beta, eps).detach().requires_grad_()

    def mlp_library(xn_):
        return F.linear(F.gelu(F.linear(xn_, w["w1"], w["b1"])), w["w2"])

    lib_y = mlp_library(xn_leaf)
    with torch.inference_mode():
        fwd = interleaved_medians(torch, {
            "kernel": mlp_fwd,
            "plain": lambda: fm.fused_mlp_partial_forward_reference(x, gamma, beta, w["w1"],
                                                                    w["b1"], w["w2"], eps),
            "library": lambda: mlp_library(F.layer_norm(x, (d,), gamma, beta, eps)),
            "with the pass": lambda: tp.bias_residual(mlp_fwd()[0], b2, x),
            "unsplit": lambda: fm.fused_mlp(x, gamma, beta, w1, b1, w2, b2, eps)},
            rounds=3, calls=5)
    bwd = interleaved_medians(torch, {
        "kernel": mlp_bwd,
        "plain": lambda: fm.fused_mlp_partial_backward_reference(dy, h_r, w["w1"], w["w2"]),
        "library": lambda: torch.autograd.grad(lib_y, xn_leaf, dy, retain_graph=True)},
        rounds=3, calls=5)
    out["fused_mlp_split"] = dict(err=err, kernel=fwd["kernel"], plain=fwd["plain"],
                                  library=fwd["library"], with_pass=fwd["with the pass"],
                                  unsplit=fwd["unsplit"], bound=bounds["fused_mlp_split"])
    out["fused_mlp_split_bwd"] = dict(err=err_b, kernel=bwd["kernel"], plain=bwd["plain"],
                                      library=bwd["library"], bound=bounds["fused_mlp_split_bwd"])
    del lib_y, xn_leaf

    # The LayerNorm-backward entry, from an f32 dxn.
    dxn = torch.randn(rows, d, generator=g, device=dev) * 0.1
    got = twice("ln_bwd", lambda: tp.ln_backward(x, dxn, gamma, dy, eps))
    ref = tp.ln_backward_residual_reference(x, dxn, gamma, dy, eps)
    err = hold("ln_bwd", got, ref, {0: dy}, f32_sums=(1, 2, 3))
    ms = interleaved_medians(torch, {
        "kernel": lambda: tp.ln_backward(x, dxn, gamma, dy, eps),
        "plain": lambda: tp.ln_backward_residual_reference(x, dxn, gamma, dy, eps),
        "library": ln_library(torch, dxn, x, gamma, eps)}, rounds=3, calls=10)
    out["ln_bwd"] = dict(err=err, kernel=ms["kernel"], plain=ms["plain"],
                         library=ms["library"], bound=bounds["ln_bwd"])

    # Two ranks emulated: their partials summed, then the pass or the LayerNorm
    # backward, against the unsplit kernels at the full shape.
    emulated = {}
    y, xn, qkv, oattn, lse = fab._launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dh, scale,
                                                 eps, training=True)
    split = [attn_fwd(True, r) for r in ranks]
    y_split = tp.bias_residual(sum(p[0] for p in split), bo, x)
    emulated["attention y"] = hold("two ranks' attention block", [y_split], [y], {0: x})
    full_b = fab.fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh, scale, eps,
                                                oattn=oattn, lse=lse)
    dxn_sum = sum(fab.fused_attention_block_partial_backward(dy, p[2], p[3], p[4], r["wqkv"],
                                                             r["wo"], hl, dh, scale)[0]
                  for p, r in zip(split, ranks))
    got = tp.ln_backward(x, dxn_sum, gamma, dy, eps)
    emulated["attention dx"] = hold("two ranks' attention block backward", got,
                                    [full_b[0], *full_b[2:5]], {0: dy}, f32_sums=(1, 2, 3))
    y, xn, h = fm._launch_forward(x, gamma, beta, w1, b1, w2, b2, eps, save_residuals=True)
    split = [mlp_fwd(True, r) for r in ranks]
    y_split = tp.bias_residual(sum(p[0] for p in split), b2, x)
    emulated["mlp y"] = hold("two ranks' fused MLP", [y_split], [y], {0: x})
    full_b = fm.fused_mlp_backward(dy, x, h, gamma, w1, w2, eps)
    dxn_sum = sum(fm.fused_mlp_partial_backward(dy, p[2], r["w1"], r["w2"])[0]
                  for p, r in zip(split, ranks))
    got = tp.ln_backward(x, dxn_sum, gamma, dy, eps)
    emulated["mlp dx"] = hold("two ranks' fused MLP backward", got,
                              [full_b[0], full_b[3], full_b[4], full_b[6]], {0: dy},
                              f32_sums=(1, 2, 3))
    torch.cuda.synchronize()
    results["tensor-parallel"] = out

    def text(name):
        r = out[name]
        extra = "".join(f" {k}={r[k]:.4f}" for k in ("mma_sync", "with_pass", "unsplit")
                        if k in r)
        lib = "null" if r["library"] is None else f"{r['library']:.4f}"
        return (f"{name} kernel={r['kernel']:.4f} plain={r['plain']:.4f} library={lib}{extra} "
                f"bound={r['bound'][0]:.4f} ({r['bound'][1]}) max|err|={r['err']:.4g}")

    log(f"tensor-parallel kernels [rank 0 of {TP} at B/32: b={b} n={n} d={d} {hl} heads of "
        f"{dh}, {hid} hidden units]: each split form against its plain version within one "
        f"unit plus {KERNEL_REL_TOL} and twice bit for bit; two ranks emulated (partials "
        f"summed, then the pass or the LayerNorm backward) against the unsplit kernels, max|err| "
        f"{json.dumps({k: round(v, 6) for k, v in emulated.items()})}; ms (library: the "
        f"composition at {hl} heads, F.layer_norm + F.linear + SDPA + F.linear, autograd for "
        f"the backwards; with_pass: the partial and the pass; unsplit: the unsplit kernel at "
        f"the full shape): " + "; ".join(text(k) for k in out) + f" on {smi}")
    del x, dy, s, dxn, split
    torch.cuda.empty_cache()
    tp_twins_kernel_phase(torch, results, smi)
    tp_biased_kernel_phase(torch, results, smi)
    tp_dense_kernel_phase(torch, results, smi)
    tp_scalable_kernel_phase(torch, results, smi)


def tp_cross_bounds(b, n, c, heads, n_k, dh_k, dh_v=None):
    """Bounds of row 6's split form at one rank's shape (``heads`` the local
    count, head widths dh_k for q and k and dh_v for v, dh_k by default;
    bf16 tensors, f32 partials and lse), each input read once and each
    output written once: forward xn, Wq_r, k_r, v_r, Wo_r in, the f32 s out
    (the serving call the phase times: oattn is the two-launch design's
    intermediate, not the function's output, as :func:`tp_bounds` counts the
    block's); backward dy, q, k_r, v_r, oattn, lse, Wq_r, Wo_r in, the f32
    dxn, dq, dk, dv and the f32 dbo out."""
    dh_v = dh_k if dh_v is None else dh_v
    rows, hk, hv = b * n, heads * dh_k, heads * dh_v
    pairs = b * heads * n * n_k
    act, acc = 2 * rows * c, 4 * rows * c
    w, kv = 2 * c * (hk + hv), 2 * b * n_k * (hk + hv)
    gemms = 2 * rows * c * (hk + hv)
    return {
        "fused_cross_attention_split": bound(gemms + 2 * pairs * (dh_k + dh_v),
                                             act + w + kv + acc),
        "fused_cross_attention_split_bwd": bound(
            gemms + 2 * pairs * (3 * dh_k + 2 * dh_v),
            act + 2 * rows * hk + kv + 2 * rows * hv + 4 * b * heads * n + w + acc
            + 2 * rows * hk + kv + 4 * c),
    }


# Row 6's split form at rank 0's slice of Twins-SVT@224's global attentions
# (b, n, c, heads, n_k, dh: 4 of 8 heads of 64 a rank at TP = 2), stages 1
# and 3; and rows 1-4's split forms at its stage-1 local attention and
# conv-MLP (4096 windows of 49 tokens, c 64, 4 of 8 heads, 128 of 256 hidden
# units a rank).
TP_TWINS_CROSS = [("Twins-SVT stage 1", 64, 3136, 64, 8, 64, 64),
                  ("Twins-SVT stage 3", 64, 196, 256, 8, 4, 64)]
TP_TWINS_BLOCK = ("Twins-SVT stage 1", 4096, 49, 64, 8, 64, 256)


def tp_cross_split(torch, g, shapes):
    """Row 6's split form at ``shapes`` ((tag, b, n, c, heads, n_k, dh_k,
    dh_v)), inputs drawn in bf16 from ``g`` and one full set of weights cut
    into the ranks' heads (Wq's rows, the packed k's and v's columns, Wo's
    columns): rank 0's partial forward (training) and, fed its residuals, its
    partial backward against their plain versions within one unit plus
    KERNEL_REL_TOL, twice bit for bit, lse on the kernel's own q; the two
    ranks emulated (partials summed, then the pass; the f32 dxn summed, then
    rounded) against the unsplit ``fused_cross_attention``'s y and dxn.
    Times of rank 0's partial forward and backward beside their plain
    versions, PyTorch's composition at the local heads (F.linear + SDPA +
    F.linear; autograd for dxn, dk and dv), the partial with the pass, the
    unsplit kernel at the full shape, and :func:`tp_cross_bounds`.  Returns
    ``({tag: {name: entry}}, {check: max|err|})`` for the two ranks'
    checks."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_cross_attention as fca
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.ops.flash_attention_packed import flash_attention_packed_forward_reference
    from vit_tpu_torch.parallel.sharding import COLUMN, ROW, shard_tensor

    dev, dt = torch.device("cuda"), torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def twice(name, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for i, (p, q) in enumerate(zip(first, again)):
            if p is not None and not torch.equal(p, q):
                raise AssertionError(f"{name} output {i}: two runs differ")
        return first

    def heads_of(t, r):
        width = t.shape[-1] // TP
        return t[..., r * width:(r + 1) * width].contiguous()

    cross, emulated = {}, {}
    for tag, b, n, c, heads, n_k, dh_k, dh_v in shapes:
        hl, hk, hv, scale = heads // TP, heads * dh_k, heads * dh_v, dh_k ** -0.5
        widths = (dh_k, dh_v, scale)
        x, xn, dy = rn(b, n, c), rn(b, n, c), rn(b, n, c, scale=0.1)
        wq, wo, bo = rn(hk, c, scale=c ** -0.5), rn(c, hv, scale=hv ** -0.5), rn(c, scale=0.1)
        k, v = rn(b, n_k, hk), rn(b, n_k, hv)
        ranks = [(shard_tensor(wq, COLUMN, r, TP), heads_of(k, r), heads_of(v, r),
                  shard_tensor(wo, ROW, r, TP)) for r in range(TP)]
        w = ranks[0]

        def fwd(training=False, r=w):
            return fca.fused_cross_attention_partial_forward(xn, *r, hl, *widths, training)

        got = twice(f"fused_cross_attention split {tag}", lambda: fwd(True))
        ref = fca.fused_cross_attention_partial_forward_reference(xn, *w, hl, *widths)
        err = check_outputs(torch, f"fused_cross_attention split {tag}", got[:3], ref[:3], {})
        lse = flash_attention_packed_forward_reference(got[1], w[1], w[2], hl, scale)[1]
        lse_err = (got[3] - lse).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"fused_cross_attention split {tag}: lse differs by {lse_err}")
        _, q_r, oattn_r, lse_r = got

        def bwd():
            return fca.fused_cross_attention_partial_backward(dy, q_r, w[1], w[2], oattn_r,
                                                              lse_r, w[0], w[3], hl, *widths)

        got_b = twice(f"fused_cross_attention split backward {tag}", bwd)
        ref_b = fca.fused_cross_attention_partial_backward_reference(
            dy, q_r, w[1], w[2], oattn_r, lse_r, w[0], w[3], hl, *widths)
        err_b = check_outputs(torch, f"fused_cross_attention split backward {tag}", got_b[:4],
                              ref_b[:4], {})
        err_b = max(err_b, check_dbias(torch, f"fused_cross_attention split backward {tag}",
                                       got_b[4], ref_b[4], "dbo"))
        route = fca.partial_backward_route(b, n, n_k, c, hl, dh_k, dh_v)

        # Two ranks emulated against the unsplit kernels at the full shape.
        y, q, oattn, lse = fca._launch_forward(x, xn, wq, k, v, wo, bo, heads, *widths,
                                               training=True)
        split = [fwd(True, r) for r in ranks]
        y_split = tp.bias_residual(sum(p[0] for p in split), bo, x)
        emulated[f"{tag} y"] = check_outputs(torch, f"two ranks' cross-attention {tag}",
                                             [y_split], [y], {0: x})
        full = fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, heads,
                                                  *widths)
        dxn = sum(fca.fused_cross_attention_partial_backward(dy, p[1], r[1], r[2], p[2], p[3],
                                                             r[0], r[3], hl, *widths)[0]
                  for p, r in zip(split, ranks)).to(dt)
        emulated[f"{tag} dxn"] = check_outputs(
            torch, f"two ranks' cross-attention backward {tag}", [dxn], [full[0]], {})
        del y, q, oattn, lse, split, full, dxn

        xn_leaf, k_leaf, v_leaf = (t.detach().requires_grad_() for t in (xn, w[1], w[2]))

        def library(xn_, k_, v_):
            qh = F.linear(xn_, w[0]).view(b, n, hl, dh_k).transpose(1, 2)
            kh = k_.view(b, n_k, hl, dh_k).transpose(1, 2)
            vh = v_.view(b, n_k, hl, dh_v).transpose(1, 2)
            o = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            return F.linear(o.transpose(1, 2).reshape(b, n, hl * dh_v), w[3])

        lib_y = library(xn_leaf, k_leaf, v_leaf)
        with torch.inference_mode():
            f_ms = interleaved_medians(torch, {
                "kernel": fwd,
                "plain": lambda: fca.fused_cross_attention_partial_forward_reference(
                    xn, *w, hl, *widths),
                "library": lambda: library(xn, w[1], w[2]),
                "with the pass": lambda: tp.bias_residual(fwd()[0], bo, x),
                "unsplit": lambda: fca.fused_cross_attention(x, xn, wq, k, v, wo, bo, heads,
                                                             *widths)}, rounds=3, calls=5)
        b_ms = interleaved_medians(torch, {
            "kernel": bwd,
            "plain": lambda: fca.fused_cross_attention_partial_backward_reference(
                dy, q_r, w[1], w[2], oattn_r, lse_r, w[0], w[3], hl, *widths),
            "library": lambda: torch.autograd.grad(lib_y, (xn_leaf, k_leaf, v_leaf), dy,
                                                   retain_graph=True)}, rounds=3, calls=5)
        bounds = tp_cross_bounds(b, n, c, hl, n_k, dh_k, dh_v)
        shape = f"{tag} rank 0 of {TP}: b={b} n={n} c={c} {hl} of {heads} heads of " \
                f"({dh_k}, {dh_v}), {n_k} keys"
        cross[tag] = {
            "fused_cross_attention_split": dict(
                err=err, kernel=f_ms["kernel"], plain=f_ms["plain"], library=f_ms["library"],
                with_pass=f_ms["with the pass"], unsplit=f_ms["unsplit"],
                bound=bounds["fused_cross_attention_split"], shape=shape),
            "fused_cross_attention_split_bwd": dict(
                err=err_b, kernel=b_ms["kernel"], plain=b_ms["plain"], library=b_ms["library"],
                bound=bounds["fused_cross_attention_split_bwd"], shape=shape,
                backward_route=route)}
        del lib_y, xn_leaf, k_leaf, v_leaf, x, xn, dy, k, v, ranks, got, got_b
        torch.cuda.empty_cache()
    return cross, emulated


def tp_twins_kernel_phase(torch, results, smi):
    """Row 6's split form at TP_TWINS_CROSS (:func:`tp_cross_split`).  Then
    rows 1-4's split forms at TP_TWINS_BLOCK (eps 1e-5), each against its
    plain version and timed beside its plain version and PyTorch's
    composition at the local heads or hidden units.  Stored under
    ``results["tensor-parallel"]``: row 6's entries with stage 1 as their
    shape and stage 3 under ``by_shape``, rows 1-4's Twins-SVT times under
    their entries' ``by_shape``."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops import fused_mlp as fm
    from vit_tpu_torch.parallel.sharding import COLUMN, QKV, ROW, shard_tensor

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(TP_SEED + 1)
    out = results["tensor-parallel"]

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def twice(name, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for i, (p, q) in enumerate(zip(first, again)):
            if p is not None and not torch.equal(p, q):
                raise AssertionError(f"{name} output {i}: two runs differ")
        return first

    cross, emulated = tp_cross_split(torch, g, [(*shape, shape[-1]) for shape in TP_TWINS_CROSS])
    first, *rest = (t for t, *_ in TP_TWINS_CROSS)
    for name in ("fused_cross_attention_split", "fused_cross_attention_split_bwd"):
        out[name] = dict(cross[first][name],
                         by_shape={t: {k: v for k, v in cross[t][name].items() if k != "shape"}
                                   for t in rest})

    # Rows 1-4's split forms at Twins-SVT's stage-1 local attention and conv-MLP.
    tag, groups, n, c, heads, dh, hidden = TP_TWINS_BLOCK
    hl, hid, scale, eps = heads // TP, hidden // TP, dh ** -0.5, TWINS_EPS
    x, dy = rn(groups, n, c), rn(groups, n, c, scale=0.1)
    gamma, beta = 1.0 + rn(c, scale=0.1), rn(c, scale=0.1)
    wqkv = shard_tensor(rn(3 * heads * dh, c, scale=c ** -0.5), QKV, 0, TP)
    wo = shard_tensor(rn(c, heads * dh, scale=(heads * dh) ** -0.5), ROW, 0, TP)
    w1 = shard_tensor(rn(hidden, c, scale=c ** -0.5), COLUMN, 0, TP)
    b1 = shard_tensor(rn(hidden, scale=0.1), COLUMN, 0, TP)
    w2 = shard_tensor(rn(c, hidden, scale=hidden ** -0.5), ROW, 0, TP)
    bounds = tp_bounds(groups, n, c, hl, dh, hid)
    blocks = {}
    a_got = twice(f"fused_attention_block split {tag}",
                  lambda: fab.fused_attention_block_partial_forward(x, gamma, beta, wqkv, wo, hl,
                                                                    dh, scale, eps, True))
    a_err = check_outputs(torch, f"fused_attention_block split {tag}", a_got[:4],
                          fab.fused_attention_block_partial_forward_reference(
                              x, gamma, beta, wqkv, wo, hl, dh, scale, eps)[:4], {})
    _, _, qkv_r, oattn_r, lse_r = a_got
    a_bwd = twice(f"fused_attention_block split backward {tag}",
                  lambda: fab.fused_attention_block_partial_backward(
                      dy, qkv_r, oattn_r, lse_r, wqkv, wo, hl, dh, scale))
    a_err_b = check_outputs(torch, f"fused_attention_block split backward {tag}", a_bwd,
                            fab.fused_attention_block_partial_backward_reference(
                                dy, qkv_r, oattn_r, lse_r, wqkv, wo, hl, dh, scale), {})
    m_got = twice(f"fused_mlp split {tag}",
                  lambda: fm.fused_mlp_partial_forward(x, gamma, beta, w1, b1, w2, eps, True))
    m_err = check_outputs(torch, f"fused_mlp split {tag}", m_got,
                          fm.fused_mlp_partial_forward_reference(x, gamma, beta, w1, b1, w2,
                                                                 eps), {})
    h_r = m_got[2]
    m_bwd = twice(f"fused_mlp split backward {tag}",
                  lambda: fm.fused_mlp_partial_backward(dy, h_r, w1, w2))
    m_ref = fm.fused_mlp_partial_backward_reference(dy, h_r, w1, w2)
    m_err_b = max(check_outputs(torch, f"fused_mlp split backward {tag}", m_bwd[:3], m_ref[:3],
                                {}),
                  check_dbias(torch, f"fused_mlp split backward {tag}", m_bwd[3], m_ref[3],
                              "db1"))
    xn_leaf = F.layer_norm(x, (c,), gamma, beta, eps).detach().requires_grad_()

    def attn_library(xn_):
        q, k, v = F.linear(xn_, wqkv).view(groups, n, 3, hl, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return F.linear(o.transpose(1, 2).reshape(groups, n, hl * dh), wo)

    def mlp_library(xn_):
        return F.linear(F.gelu(F.linear(xn_, w1, b1)), w2)

    attn_y, mlp_y = attn_library(xn_leaf), mlp_library(xn_leaf)
    with torch.inference_mode():
        f_ms = interleaved_medians(torch, {
            "attention": lambda: fab.fused_attention_block_partial_forward(
                x, gamma, beta, wqkv, wo, hl, dh, scale, eps),
            "attention plain": lambda: fab.fused_attention_block_partial_forward_reference(
                x, gamma, beta, wqkv, wo, hl, dh, scale, eps),
            "attention library": lambda: attn_library(F.layer_norm(x, (c,), gamma, beta, eps)),
            "mlp": lambda: fm.fused_mlp_partial_forward(x, gamma, beta, w1, b1, w2, eps),
            "mlp plain": lambda: fm.fused_mlp_partial_forward_reference(x, gamma, beta, w1, b1,
                                                                        w2, eps),
            "mlp library": lambda: mlp_library(F.layer_norm(x, (c,), gamma, beta, eps))},
            rounds=3, calls=5)
    b_ms = interleaved_medians(torch, {
        "attention": lambda: fab.fused_attention_block_partial_backward(
            dy, qkv_r, oattn_r, lse_r, wqkv, wo, hl, dh, scale),
        "attention plain": lambda: fab.fused_attention_block_partial_backward_reference(
            dy, qkv_r, oattn_r, lse_r, wqkv, wo, hl, dh, scale),
        "attention library": lambda: torch.autograd.grad(attn_y, xn_leaf, dy,
                                                         retain_graph=True),
        "mlp": lambda: fm.fused_mlp_partial_backward(dy, h_r, w1, w2),
        "mlp plain": lambda: fm.fused_mlp_partial_backward_reference(dy, h_r, w1, w2),
        "mlp library": lambda: torch.autograd.grad(mlp_y, xn_leaf, dy, retain_graph=True)},
        rounds=3, calls=5)
    for name, key, ms, e in (("fused_attention_block_split", "attention", f_ms, a_err),
                             ("fused_attention_block_split_bwd", "attention", b_ms, a_err_b),
                             ("fused_mlp_split", "mlp", f_ms, m_err),
                             ("fused_mlp_split_bwd", "mlp", b_ms, m_err_b)):
        blocks[name] = dict(err=e, kernel=ms[key], plain=ms[f"{key} plain"],
                            library=ms[f"{key} library"], bound=bounds[name])
        out[name].setdefault("by_shape", {})[tag] = blocks[name]
    torch.cuda.synchronize()
    del x, dy, a_got, a_bwd, m_got, m_bwd, h_r, xn_leaf, attn_y, mlp_y
    torch.cuda.empty_cache()

    def text(r):
        extra = "".join(f" {k}={r[k]:.4f}" for k in ("library", "with_pass", "unsplit")
                        if r.get(k) is not None)
        return (f"kernel={r['kernel']:.4f} plain={r['plain']:.4f}{extra} "
                f"bound={r['bound'][0]:.4f} ({r['bound'][1]}) max|err|={r['err']:.4g}")

    log(f"tensor-parallel Twins-SVT kernels [rank 0 of {TP}]: row 6's split form (4 of 8 "
        f"heads of 64; the forward on cross_fwd writing oattn and the f32-partial GEMM, the "
        f"backward on route 2) and rows 1-4's at {tag}'s local attention and conv-MLP "
        f"({groups} windows of {n}, c {c}, {hl} heads, {hid} hidden units), each against its "
        f"plain version within one unit plus {KERNEL_REL_TOL} and twice bit for bit; two ranks "
        f"emulated against the unsplit cross-attention kernels, max|err| "
        f"{json.dumps({k: round(v, 6) for k, v in emulated.items()})}; ms (library: "
        f"F.linear + SDPA + F.linear at {TP_TWINS_CROSS[0][4] // TP} heads, autograd for dxn, "
        f"dk and dv; rows 1-4's, F.layer_norm + F.linear + SDPA + F.linear and F.layer_norm + "
        f"F.linear + GELU + F.linear at the local heads and hidden units, autograd for dxn; "
        f"with_pass: the partial and the pass; unsplit: the unsplit kernel at 8 heads): "
        + "; ".join(f"{name} [{t}, backward route "
                    f"{cross[t]['fused_cross_attention_split_bwd']['backward_route']}] "
                    f"{text(cross[t][name])}" for t in cross for name in cross[t])
        + "; " + "; ".join(f"{name} [{tag}] {text(r)}" for name, r in blocks.items())
        + f" on {smi}")


# Row 5's split form at rank 0's slice over TP ranks of the three biased
# models' blocks: (tag, b, n, d, heads, dim_head, bias kind, eps).  The
# small-dataset ViT@256 (64 images of 257 tokens, 8 of 16 heads of 64, LSA's
# mask at scale 1, no dbias), CrossFormer@224's stage-1 short windows (4096 of
# 49 tokens, 1 of 2 heads of 32, the shared DPB table and its dbias, eps
# 1e-5) and RegionViT@224's stage-1 joint rows (4096 of 50 tokens, 2 of 4
# heads of 32, their per-head table and its dbias).
TP_BIASED_SHAPES = [("small-dataset ViT@256", 64, 257, 1024, 16, 64, "lsa", 1e-3),
                    ("CrossFormer@224 stage 1", 4096, 49, 64, 2, 32, "shared", CROSSFORMER_EPS),
                    ("RegionViT@224 stage 1", 4096, 50, 64, 4, 32, "per-head", 1e-3)]


def tp_biased_kernel_phase(torch, results, smi):
    """Row 5's split form at TP_BIASED_SHAPES, seeded bf16 inputs, one full
    set of weights and one f32 bias (per head: cut with the heads) made into
    the ranks' slices: rank 0's partial forward (training) and, fed its
    residuals, its partial backward against their plain versions within one
    unit plus KERNEL_REL_TOL, dbias within DBIAS_REL_TOL, twice bit for bit,
    lse on the kernel's own qkv; the two ranks emulated (partials summed,
    then the pass; the f32 dxn summed, then the LayerNorm backward; dbias
    summed for a shared bias, joined for a per-head one) against the
    unsplit row 5's y, dxn, dx, sums and dbias.  Times of rank 0's partial
    forward and backward beside their plain versions, PyTorch's composition
    at the local heads (F.layer_norm + F.linear + SDPA(attn_mask) + F.linear;
    autograd for dxn and, with dbias, the mask's gradient), the partial with
    the pass, the unsplit kernels at the full shape, and :func:`tp_bounds`.
    Stored under ``results["tensor-parallel"]``: the small-dataset ViT's as
    the entries' shape, the others under ``by_shape``."""
    import torch.nn.functional as F

    from vit_tpu_torch.models.vit_for_small_dataset import lsa_bias
    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.parallel.sharding import QKV, ROW, shard_tensor

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(TP_SEED + 10)
    out = results["tensor-parallel"]

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def twice(name, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for i, (p, q) in enumerate(zip(first, again)):
            if p is not None and not torch.equal(p, q):
                raise AssertionError(f"{name} output {i}: two runs differ")
        return first

    entries, emulated = {}, {}
    for tag, b, n, d, heads, dh, kind, eps in TP_BIASED_SHAPES:
        hl, inner = heads // TP, heads * dh
        need_dbias = kind != "lsa"
        x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
        gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dt), rn(d, scale=0.1)
        wqkv, wo, bo = rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5), \
            rn(d, scale=0.1)
        if kind == "lsa":
            bias, scale = lsa_bias(n, dev), 1.0
        else:
            bias = torch.randn(heads if kind == "per-head" else 1, n, n, generator=g,
                               device=dev) * 0.5
            scale = dh ** -0.5
        ranks = [(shard_tensor(wqkv, QKV, r, TP), shard_tensor(wo, ROW, r, TP),
                  bias[r * hl:(r + 1) * hl].contiguous() if kind == "per-head" else bias)
                 for r in range(TP)]
        w = ranks[0]
        name = f"row 5 split {tag}"

        def fwd(training=False, r=w):
            return fab.fused_attention_block_bias_partial_forward(x, gamma, beta, r[0], r[1],
                                                                  r[2], hl, dh, scale, eps,
                                                                  training)

        got = twice(name, lambda: fwd(True))
        ref = fab.fused_attention_block_partial_forward_reference(x, gamma, beta, *w[:2], hl, dh,
                                                                  scale, eps, w[2])
        err = check_outputs(torch, name, got[:4], ref[:4], {})
        lse_err = (got[4] - fab.attention_lse_reference(got[2], hl, dh, scale, w[2])
                   ).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"{name}: lse differs by {lse_err}")
        _, _, qkv_r, oattn_r, lse_r = got

        def bwd(parts=got, r=w):
            return fab.fused_attention_block_bias_partial_backward(
                dy, *parts[2:], r[0], r[1], r[2], hl, dh, scale, need_dbias)

        got_b = twice(f"{name} backward", bwd)
        ref_b = fab.fused_attention_block_partial_backward_reference(
            dy, qkv_r, oattn_r, lse_r, *w[:2], hl, dh, scale, w[2], need_dbias)
        err_b = check_outputs(torch, f"{name} backward", got_b[:3], ref_b[:3], {})
        if need_dbias:
            err_b = max(err_b, check_dbias(torch, f"{name} backward", got_b[3], ref_b[3]))
        elif got_b[3] is not None:
            raise AssertionError(f"{name} backward: dbias computed unasked")

        # Two ranks emulated against the unsplit row 5 at the full shape.
        y, _, qkv, oattn, lse = fab._launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dh,
                                                    scale, eps, bias, training=True)
        split = [got] + [fwd(True, r) for r in ranks[1:]]
        y_split = tp.bias_residual(sum(p[0] for p in split), bo, x)
        emulated[f"{tag} y"] = check_outputs(torch, f"two ranks' {name}", [y_split], [y], {0: x})
        full = fab.fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads,
                                                       dh, scale, eps, need_dbias=need_dbias,
                                                       oattn=oattn, lse=lse)
        backs = [got_b] + [bwd(p, r) for p, r in zip(split[1:], ranks[1:])]
        dxn = sum(bk[0] for bk in backs)
        dxn_full = full[1].reshape(-1, 3 * inner).float() @ wqkv.float()
        emulated[f"{tag} dxn"] = check_outputs(torch, f"two ranks' {name} dxn", [dxn],
                                               [dxn_full], {})
        ln = tp.ln_backward(x, dxn, gamma, dy, eps)
        emulated[f"{tag} dx"] = check_outputs(torch, f"two ranks' {name} backward", ln[:1],
                                              full[:1], {0: dy})
        emulated[f"{tag} sums"] = max(check_dbias(torch, f"two ranks' {name} backward", got_s,
                                                  want_s, what)
                                      for got_s, want_s, what in zip(ln[1:], full[2:5],
                                                                     ("dγ", "dβ", "dbo")))
        if need_dbias:
            parts = [bk[3] for bk in backs]
            joined = torch.cat(parts) if kind == "per-head" else sum(parts)
            emulated[f"{tag} dbias"] = check_dbias(torch, f"two ranks' {name}", joined, full[5])
        del y, qkv, oattn, lse, split, full, backs, dxn, dxn_full, ln

        xn_leaf = F.layer_norm(x, (d,), gamma, beta, eps).detach().requires_grad_()
        mask = w[2].to(dt)
        mask_leaf = mask.detach().requires_grad_(need_dbias)

        def library(xn_, mask_):
            q, k, v = F.linear(xn_, w[0]).view(b, n, 3, hl, dh).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask_, scale=scale)
            return F.linear(o.transpose(1, 2).reshape(b, n, hl * dh), w[1])

        lib_y = library(xn_leaf, mask_leaf)
        lib_inputs = (xn_leaf, mask_leaf) if need_dbias else (xn_leaf,)
        with torch.inference_mode():
            f_ms = interleaved_medians(torch, {
                "kernel": fwd,
                "plain": lambda: fab.fused_attention_block_partial_forward_reference(
                    x, gamma, beta, *w[:2], hl, dh, scale, eps, w[2]),
                "library": lambda: library(F.layer_norm(x, (d,), gamma, beta, eps), mask),
                "with the pass": lambda: tp.bias_residual(fwd()[0], bo, x),
                "unsplit": lambda: fab.fused_attention_block_bias(x, gamma, beta, wqkv, wo, bo,
                                                                  bias, heads, dh, scale, eps)},
                rounds=3, calls=5)
        b_ms = interleaved_medians(torch, {
            "kernel": bwd,
            "plain": lambda: fab.fused_attention_block_partial_backward_reference(
                dy, qkv_r, oattn_r, lse_r, *w[:2], hl, dh, scale, w[2], need_dbias),
            "library": lambda: torch.autograd.grad(lib_y, lib_inputs, dy, retain_graph=True)},
            rounds=3, calls=5)
        bounds = tp_bounds(b, n, d, hl, dh, 4 * d, w[2].shape[0], need_dbias)
        shape = (f"{tag} rank 0 of {TP}: b={b} n={n} d={d} {hl} of {heads} heads of {dh}, "
                 f"{kind} bias {tuple(w[2].shape)}" + (", dbias" if need_dbias else ""))
        entries[tag] = {
            "fused_attention_block_bias_split": dict(
                err=err, kernel=f_ms["kernel"], plain=f_ms["plain"], library=f_ms["library"],
                with_pass=f_ms["with the pass"], unsplit=f_ms["unsplit"],
                bound=bounds["fused_attention_block_bias_split"], shape=shape),
            "fused_attention_block_bias_split_bwd": dict(
                err=err_b, kernel=b_ms["kernel"], plain=b_ms["plain"], library=b_ms["library"],
                bound=bounds["fused_attention_block_bias_split_bwd"], shape=shape)}
        del lib_y, xn_leaf, mask_leaf, mask, x, dy, got, got_b, ranks, w, bias
        torch.cuda.empty_cache()
    first, *rest = (t for t, *_ in TP_BIASED_SHAPES)
    for name in ("fused_attention_block_bias_split", "fused_attention_block_bias_split_bwd"):
        out[name] = dict(entries[first][name],
                         by_shape={t: {k: v for k, v in entries[t][name].items() if k != "shape"}
                                   for t in rest})

    def text(r):
        extra = "".join(f" {k}={r[k]:.4f}" for k in ("library", "with_pass", "unsplit")
                        if r.get(k) is not None)
        return (f"kernel={r['kernel']:.4f} plain={r['plain']:.4f}{extra} "
                f"bound={r['bound'][0]:.4f} ({r['bound'][1]}) max|err|={r['err']:.4g}")

    log(f"tensor-parallel row 5 [rank 0 of {TP}]: the biased block's split form at the small-"
        f"dataset ViT's, CrossFormer's and RegionViT's blocks, each against its plain version "
        f"within one unit plus {KERNEL_REL_TOL} (dbias within {DBIAS_REL_TOL}*max|ref|) and "
        f"twice bit for bit; two ranks emulated (partials summed, then the pass; dxn summed, "
        f"then the LayerNorm backward; dbias summed or joined) against the unsplit row 5, "
        f"max|err| {json.dumps({k: round(v, 6) for k, v in emulated.items()})}; ms (library: "
        f"F.layer_norm + F.linear + SDPA(attn_mask) + F.linear at the local heads, autograd for "
        f"dxn and the mask's gradient where dbias is asked; with_pass: the partial and the "
        f"pass; unsplit: the unsplit kernel at every head): "
        + "; ".join(f"{name} [{entries[t][name]['shape']}] {text(entries[t][name])}"
                    for t in entries for name in entries[t]) + f" on {smi}")


def tp_dense_kernel_phase(torch, results, smi):
    """Rows 1-2's split form at rank 0's slice over TP ranks of the dense
    family's MLPs (DENSE_MLP_SHAPES: CrossViT's small and large branches and
    the patch merger's ViT after the merger, batch DENSE_BATCH, 1024 of 2048
    hidden units), seeded bf16 inputs and one full set of weights cut into
    the ranks' slices: rank 0's partial forward (training) and, fed its h,
    its partial backward against their plain versions within one unit plus
    KERNEL_REL_TOL, db1 within DBIAS_REL_TOL, twice bit for bit; the two
    ranks emulated (partials summed, then the pass; the f32 dxn summed, then
    the LayerNorm backward) against the unsplit rows 1-2's y, dxn, dx and
    sums.  Times of rank 0's partial forward and backward beside their plain
    versions, PyTorch's composition at the local hidden units (F.layer_norm
    + F.linear + GELU + F.linear; autograd for dxn), the forward with the
    pass, the backward with the LayerNorm-backward entry, the unsplit
    kernels at the full shape, and :func:`tp_bounds`.  Stored under the
    split entries' ``by_shape``."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_mlp as fm
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.parallel.sharding import COLUMN, ROW, shard_tensor

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(TP_SEED + 11)
    out, hidden, eps, b = results["tensor-parallel"], 2048, 1e-3, DENSE_BATCH
    hid = hidden // TP

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def twice(name, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for i, (p, q) in enumerate(zip(first, again)):
            if p is not None and not torch.equal(p, q):
                raise AssertionError(f"{name} output {i}: two runs differ")
        return first

    entries, emulated = {}, {}
    for tag, n, d in DENSE_MLP_SHAPES:
        x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
        gamma, beta = 1.0 + rn(d, scale=0.1), rn(d, scale=0.1)
        w1, b1 = rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1)
        w2, b2 = rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1)
        ranks = [(shard_tensor(w1, COLUMN, r, TP), shard_tensor(b1, COLUMN, r, TP),
                  shard_tensor(w2, ROW, r, TP)) for r in range(TP)]
        w = ranks[0]
        name = f"fused_mlp split {tag}"

        def fwd(training=False, r=w):
            return fm.fused_mlp_partial_forward(x, gamma, beta, *r, eps, training)

        got = twice(name, lambda: fwd(True))
        err = check_outputs(torch, name, got,
                            fm.fused_mlp_partial_forward_reference(x, gamma, beta, *w, eps), {})
        h_r = got[2]

        def bwd(h=h_r, r=w):
            return fm.fused_mlp_partial_backward(dy, h, r[0], r[2])

        got_b = twice(f"{name} backward", bwd)
        ref_b = fm.fused_mlp_partial_backward_reference(dy, h_r, w[0], w[2])
        err_b = max(check_outputs(torch, f"{name} backward", got_b[:3], ref_b[:3], {}),
                    check_dbias(torch, f"{name} backward", got_b[3], ref_b[3], "db1"))

        # Two ranks emulated against the unsplit rows 1-2 at the full shape.
        y, _, h = fm._launch_forward(x, gamma, beta, w1, b1, w2, b2, eps, save_residuals=True)
        split = [got] + [fwd(True, r) for r in ranks[1:]]
        y_split = tp.bias_residual(sum(p[0] for p in split), b2, x)
        emulated[f"{tag} y"] = check_outputs(torch, f"two ranks' {name}", [y_split], [y], {0: x})
        full = fm.fused_mlp_backward(dy, x, h, gamma, w1, w2, eps)
        dxn = sum(bwd(p[2], r)[0] for p, r in zip(split, ranks))
        dxn_full = full[1].reshape(-1, hidden).float() @ w1.float()
        emulated[f"{tag} dxn"] = check_outputs(torch, f"two ranks' {name} dxn", [dxn],
                                               [dxn_full], {})
        ln = tp.ln_backward(x, dxn, gamma, dy, eps)
        emulated[f"{tag} dx"] = check_outputs(torch, f"two ranks' {name} backward", ln[:1],
                                              full[:1], {0: dy})
        emulated[f"{tag} sums"] = max(
            check_dbias(torch, f"two ranks' {name} backward", got_s, want_s, what)
            for got_s, want_s, what in zip(ln[1:], (full[3], full[4], full[6]),
                                           ("dγ", "dβ", "db2")))
        del y, split, full, dxn, dxn_full, ln

        xn_leaf = F.layer_norm(x, (d,), gamma, beta, eps).detach().requires_grad_()

        def library(xn_):
            return F.linear(F.gelu(F.linear(xn_, w[0], w[1])), w[2])

        lib_y = library(xn_leaf)
        with torch.inference_mode():
            f_ms = interleaved_medians(torch, {
                "kernel": fwd,
                "plain": lambda: fm.fused_mlp_partial_forward_reference(x, gamma, beta, *w, eps),
                "library": lambda: library(F.layer_norm(x, (d,), gamma, beta, eps)),
                "with the pass": lambda: tp.bias_residual(fwd()[0], b2, x),
                "unsplit": lambda: fm.fused_mlp(x, gamma, beta, w1, b1, w2, b2, eps)},
                rounds=3, calls=5)
        b_ms = interleaved_medians(torch, {
            "kernel": bwd,
            "plain": lambda: fm.fused_mlp_partial_backward_reference(dy, h_r, w[0], w[2]),
            "library": lambda: torch.autograd.grad(lib_y, xn_leaf, dy, retain_graph=True),
            "with the LN entry": lambda: tp.ln_backward(x, bwd()[0], gamma, dy, eps),
            "unsplit": lambda: fm.fused_mlp_backward(dy, x, h, gamma, w1, w2, eps)},
            rounds=3, calls=5)
        bounds = tp_bounds(b, n, d, 8, 64, hid)
        shape = f"{tag} rank 0 of {TP}: {b}x{n} rows, d={d}, {hid} of {hidden} hidden units"
        entries[tag] = {
            "fused_mlp_split": dict(
                err=err, kernel=f_ms["kernel"], plain=f_ms["plain"], library=f_ms["library"],
                with_pass=f_ms["with the pass"], unsplit=f_ms["unsplit"],
                bound=bounds["fused_mlp_split"], shape=shape),
            "fused_mlp_split_bwd": dict(
                err=err_b, kernel=b_ms["kernel"], plain=b_ms["plain"], library=b_ms["library"],
                with_ln=b_ms["with the LN entry"], unsplit=b_ms["unsplit"],
                bound=bounds["fused_mlp_split_bwd"], shape=shape)}
        for key, entry in entries[tag].items():
            out[key].setdefault("by_shape", {})[tag] = {k: v for k, v in entry.items()
                                                      if k != "shape"}
        del lib_y, xn_leaf, x, dy, got, got_b, h, h_r, ranks, w
        torch.cuda.empty_cache()

    def text(r):
        extra = "".join(f" {k}={r[k]:.4f}" for k in ("library", "with_pass", "with_ln",
                                                     "unsplit") if r.get(k) is not None)
        return (f"kernel={r['kernel']:.4f} plain={r['plain']:.4f}{extra} "
                f"bound={r['bound'][0]:.4f} ({r['bound'][1]}) max|err|={r['err']:.4g}")

    log(f"tensor-parallel rows 1-2 at the dense family's MLPs [rank 0 of {TP}]: the fused MLP's "
        f"split form, each against its plain version within one unit plus {KERNEL_REL_TOL} "
        f"(db1 within {DBIAS_REL_TOL}*max|ref|) and twice bit for bit; two ranks emulated "
        f"(partials summed, then the pass; dxn summed, then the LayerNorm backward) against "
        f"the unsplit rows 1-2, max|err| "
        f"{json.dumps({k: round(v, 6) for k, v in emulated.items()})}; ms (library: "
        f"F.layer_norm + F.linear + GELU + F.linear at the local hidden units, autograd for "
        f"dxn; with_pass: the partial and the pass; with_ln: the partial backward and the "
        f"LayerNorm-backward entry; unsplit: the unsplit kernel at every hidden unit): "
        + "; ".join(f"{name} [{entries[t][name]['shape']}] {text(entries[t][name])}"
                    for t in entries for name in entries[t]) + f" on {smi}")


# Row 10 over rank 0's heads at ScalableViT@256's IWSA stages 1-2 (tag, b, n,
# heads, d: batch 64, one window of 4096 and of 1024 tokens an image, 2 and
# 4 heads of 32 over TP ranks), and row 6's split form at its SSA stages 1
# and 3 (tag, b, n, c, heads, n_k, dh_k, dh_v: 64 keys, q and k 40 wide, v
# 32), the widths Twins-SVT's (64, 64) did not reach.
TP_PACKED_SHAPES = [("ScalableViT IWSA stage 1", 64, 4096, 2, 32),
                    ("ScalableViT IWSA stage 2", 64, 1024, 4, 32)]
TP_SSA_CROSS = [("ScalableViT stage 1", 64, 4096, 64, 2, 64, 40, 32),
                ("ScalableViT stage 3", 64, 256, 256, 8, 64, 40, 32)]


def tp_scalable_kernel_phase(torch, results, smi):
    """Row 10, the packed flash op, over rank 0's heads of TP at
    TP_PACKED_SHAPES, seeded bf16 channel-packed q, k, v and dout cut into
    the ranks' heads (contiguous columns, as IWSA's column-split q and k and
    its slice of the whole v): the forward (out, lse) and the backward on
    the packed strides (dq, dk, dv, fed the kernel's own out and lse)
    against their plain versions within one unit plus KERNEL_REL_TOL, twice
    bit for bit; the two ranks' outputs, lse and gradients concatenated
    against the unsplit op at every head.  Times beside the plain versions,
    SDPA on the packed head views at the local heads (autograd through it for
    the backward), the unsplit op and :func:`flash_bounds` at the local
    heads.  Then row 6's split form at TP_SSA_CROSS (:func:`tp_cross_split`).
    Stored under ``results["tensor-parallel"]``: row 10's split entries with
    stage 1 as their shape and stage 2 under ``by_shape``, row 6's SSA
    shapes under its split entries' ``by_shape``."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops import flash_attention_packed as fap

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(TP_SEED + 17)
    out = results["tensor-parallel"]

    def twice(name, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        for i, (p, q) in enumerate(zip(first, again)):
            if not torch.equal(p, q):
                raise AssertionError(f"{name} output {i}: two runs differ")
        return first

    packed, emulated = {}, {}
    for tag, b, n, heads, d in TP_PACKED_SHAPES:
        hl, scale = heads // TP, d ** -0.5
        q, k, v, do = ((torch.randn(b, n, heads * d, generator=g, device=dev)).to(dt)
                       for _ in range(4))
        ranks = [[t[..., r * hl * d:(r + 1) * hl * d].contiguous() for t in (q, k, v, do)]
                 for r in range(TP)]
        name = f"packed flash split {tag}"

        def fwd(r=ranks[0], h=hl):
            return fap.flash_attention_packed_forward(*r[:3], h, scale)

        def bwd(r, o, lse, h=hl):
            views = (fap.split_heads(t, h) for t in (*r[:3], o))
            return [fap.merge_heads(t) for t in fa.flash_backward(
                *views, lse, fap.split_heads(r[3], h), scale)]

        got = twice(name, fwd)
        ref = fap.flash_attention_packed_forward_reference(*ranks[0][:3], hl, scale)
        err = check_outputs(torch, name, got[:1], ref[:1], {})
        lse_err = (got[1] - ref[1]).abs().max().item()
        if not (got[1].dtype == torch.float32 and lse_err <= LSE_ABS_TOL):
            raise AssertionError(f"{name}: lse differs by {lse_err}")
        out_r, lse_r = got
        del ref
        got_b = twice(f"{name} backward", lambda: bwd(ranks[0], out_r, lse_r))
        err_b = check_outputs(torch, f"{name} backward", got_b,
                              fap.flash_attention_packed_backward_reference(
                                  *ranks[0][:3], out_r, lse_r, ranks[0][3], hl, scale), {})
        del got_b

        # The two ranks' heads concatenated against the unsplit op.
        full_out, full_lse = fap.flash_attention_packed_forward(q, k, v, heads, scale)
        split = [fwd(r) for r in ranks]
        emulated[f"{tag} out"] = check_outputs(torch, f"two ranks' {name}",
                                               [torch.cat([s[0] for s in split], -1)],
                                               [full_out], {})
        emulated[f"{tag} lse"] = (torch.cat([s[1] for s in split], 1) - full_lse).abs().max().item()
        if not emulated[f"{tag} lse"] <= LSE_ABS_TOL:
            raise AssertionError(f"two ranks' {name}: lse differs by {emulated[f'{tag} lse']}")
        full = bwd([q, k, v, do], full_out, full_lse, heads)
        grads = [bwd(r, *s) for r, s in zip(ranks, split)]
        emulated[f"{tag} dq, dk, dv"] = check_outputs(
            torch, f"two ranks' {name} backward",
            [torch.cat([gr[i] for gr in grads], -1) for i in range(3)], full, {})
        del full_out, full_lse, split, full, grads

        views = [fap.split_heads(t, hl) for t in ranks[0]]
        with torch.inference_mode():
            f_ms = interleaved_medians(torch, {
                "kernel": fwd,
                "plain": lambda: fap.flash_attention_packed_forward_reference(
                    *ranks[0][:3], hl, scale),
                "library": lambda: F.scaled_dot_product_attention(*views[:3], scale=scale),
                "unsplit": lambda: fap.flash_attention_packed_forward(q, k, v, heads, scale)},
                rounds=3, calls=3)
        b_ms = interleaved_medians(torch, {
            "kernel": lambda: bwd(ranks[0], out_r, lse_r),
            "plain": lambda: fap.flash_attention_packed_backward_reference(
                *ranks[0][:3], out_r, lse_r, ranks[0][3], hl, scale),
            "library": sdpa_backward(torch, F, *views, scale)}, rounds=3, calls=3)
        bounds = flash_bounds(b, hl, n, n, d)
        shape = f"{tag} rank 0 of {TP}: b={b} n={n} {hl} of {heads} heads of {d}, channel-packed"
        packed[tag] = {
            "flash_attention_packed_split": dict(
                err=err, kernel=f_ms["kernel"], plain=f_ms["plain"], library=f_ms["library"],
                unsplit=f_ms["unsplit"], bound=bounds["flash_attention"], shape=shape),
            "flash_attention_packed_split_bwd": dict(
                err=err_b, kernel=b_ms["kernel"], plain=b_ms["plain"], library=b_ms["library"],
                bound=bounds["flash_backward"], shape=shape)}
        del q, k, v, do, ranks, views, out_r, lse_r
        torch.cuda.empty_cache()
    first, *rest = (t for t, *_ in TP_PACKED_SHAPES)
    for name in ("flash_attention_packed_split", "flash_attention_packed_split_bwd"):
        out[name] = dict(packed[first][name],
                         by_shape={t: {k: v for k, v in packed[t][name].items() if k != "shape"}
                                   for t in rest})

    cross, cross_emulated = tp_cross_split(torch, g, TP_SSA_CROSS)
    emulated.update(cross_emulated)
    for tag, entries in cross.items():
        for name, entry in entries.items():
            out[name].setdefault("by_shape", {})[tag] = {k: v for k, v in entry.items()
                                                         if k != "shape"}

    def text(r):
        extra = "".join(f" {k}={r[k]:.4f}" for k in ("library", "with_pass", "unsplit")
                        if r.get(k) is not None)
        route = f" backward_route={r['backward_route']}" if "backward_route" in r else ""
        return (f"kernel={r['kernel']:.4f} plain={r['plain']:.4f}{extra} "
                f"bound={r['bound'][0]:.4f} ({r['bound'][1]}){route} max|err|={r['err']:.4g}")

    log(f"tensor-parallel ScalableViT kernels [rank 0 of {TP}]: row 10 (the packed flash op) "
        f"over the local heads at IWSA stages 1-2 and row 6's split form at SSA stages 1 and 3 "
        f"((40, 32), 64 keys), each against its plain version within one unit plus "
        f"{KERNEL_REL_TOL} and twice bit for bit; the two ranks' heads concatenated (row 10) or "
        f"summed (row 6) against the unsplit kernels, max|err| "
        f"{json.dumps({k: round(v, 6) for k, v in emulated.items()})}; ms (library: SDPA on "
        f"the packed head views at the local heads, autograd through it for the backward; row "
        f"6's F.linear + SDPA + F.linear at the local heads, autograd for dxn, dk and dv; "
        f"with_pass: the partial and the pass; unsplit: the unsplit kernel at every head): "
        + "; ".join(f"{name} [{entries[name]['shape']}] {text(entries[name])}"
                    for entries in (*packed.values(), *cross.values()) for name in entries)
        + f" on {smi}")


def tp_rank(rank, port, workdir):
    """One rank of :func:`tp_path_phase` (a spawned process on the one card):
    joins a gloo group of TP processes, lays a (1, TP) mesh, and on
    ViT-B/32@256 from TP_SEED's weights serves three requests of
    INFRA_BATCH images (``cast_params`` bf16, eval, inference mode) and
    trains (bf16 compute, f32 parameters, SGD(1e-3)): the step-1 gradients,
    gathered to their whole shapes; TP_STEPS steps of ``make_train_step``
    over the mesh, each counter from 0; the step timed.  Writes what it saw
    to ``tp_rank<r>.pt`` in ``workdir``."""
    import torch

    from vit_tpu_torch import ViT, cast_params
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.parallel.mesh import (
        data_group, initialize_distributed, make_mesh, model_group,
    )
    from vit_tpu_torch.parallel.sharding import gather_tensor, shard_params
    from vit_tpu_torch.parallel.train import cross_entropy_loss, make_train_step

    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        initialize_distributed(f"127.0.0.1:{port}", TP, rank, backend="gloo", timeout_s=300)
        mesh = make_mesh((1, TP))
        lib, counters = _build.load(), counter_objects()
        dev, size = torch.device("cuda"), ENTRY["image_size"]
        f32_gemms = [0]  # the library's count since zero(): each take resets it there

        def zero():
            for c in counters.values():
                c.launches = 0
            lib.vit_take_launch_count(COUNTED_F32)
            f32_gemms[0] = 0

        def counts():
            f32_gemms[0] += lib.vit_take_launch_count(COUNTED_F32)
            return {**{k: c.launches for k, c in counters.items()},
                    "forward_gemm_f32": f32_gemms[0]}

        # Serving, as serving_phase draws its weights and requests.
        g = torch.Generator(device=dev).manual_seed(TP_SEED)
        served = shard_params(mesh, cast_params(ViT(**ENTRY, device=dev, generator=g),
                                                torch.bfloat16).eval())
        requests = [torch.randn(INFRA_BATCH, size, size, 3, generator=g, device=dev)
                    for _ in range(3)]
        zero()
        logits, per_forward = [], []
        with torch.inference_mode():
            for img in requests:
                logits.append(served(img).float())
                per_forward.append(counts())
        out.update(logits=[t.cpu() for t in logits], serving_counts=per_forward)
        del served, requests, logits

        # Training, as training_models draws its weights and batch.
        g = torch.Generator(device=dev).manual_seed(TP_SEED)
        model = shard_params(mesh, ViT(**ENTRY, compute_dtype=torch.bfloat16, generator=g))
        images = torch.randn(INFRA_BATCH, size, size, 3, generator=g, device=dev)
        labels = torch.arange(INFRA_BATCH, device=dev) % ENTRY["num_classes"]
        plan = model.tensor_parallel
        model.train()
        loss = cross_entropy_loss(model(images), labels)
        loss.backward()
        grads = {k: gather_tensor(p.grad, plan.kinds[k], plan.shard) if k in plan.kinds
                 else p.grad for k, p in model.named_parameters()}
        out.update(first=loss.item(), grads={k: v.cpu() for k, v in grads.items()} if rank == 0
                   else {})
        model.zero_grad(set_to_none=True)
        del grads, loss
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3), mesh=mesh)
        zero()
        losses, per_step = [], []
        for _ in range(TP_STEPS):
            losses.append(step(images, labels)["loss"].item())
            per_step.append(counts())
        out.update(losses=losses, train_counts=per_step)
        torch.distributed.barrier()
        ms = interleaved_medians(torch, {"step": lambda: step(images, labels)}, rounds=3,
                                 calls=1, warmup=0)
        out["step_ms"] = ms["step"]
        # Where the step's time goes here: a block's f32 partial summed over the
        # model group (two a block a step, each way), and the gradients' one sum
        # over the data axis of 1; wall ms, the host staging gloo's copies.
        tokens = (size // ENTRY["patch_size"]) ** 2 + 1
        block = torch.zeros(INFRA_BATCH * tokens, ENTRY["dim"], device=dev)
        flat = torch.zeros(sum(p.numel() for p in model.parameters()), device=dev)
        for name, t, group in (("model all-reduce", block, model_group(mesh)),
                               ("data all-reduce", flat, data_group(mesh))):
            walls = []
            for _ in range(4):
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.distributed.all_reduce(t, group=group)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[name] = (statistics.median(walls[1:]), t.numel() * 4)
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(workdir, f"tp_rank{rank}.pt"))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def hold_logits(torch, tag, logits, refs, truths, sign_test=False, confident_images=True):
    """The serving check of :func:`serving_phase` on logits already taken:
    within LOGIT_REL_TOL of the plain bf16 path's, at most
    MAX_ERR_VS_PLAIN_BF16 times as far from the f32 model's as the plain
    path, top-1 against f32 at least the plain path's, and the plain path's
    top-1 on TOP1_CONFIDENT of the images its noise cannot flip.  Returns a
    summary; raises on a miss."""
    err = (logits - refs).abs().max().item()
    tol = LOGIT_REL_TOL * refs.abs().max().item()
    err_k, err_p = ((t - truths).abs().max().item() for t in (logits, refs))

    def top1(a, c):
        return (a.argmax(-1) == c.argmax(-1)).float().mean().item()

    top2 = truths.topk(2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 2 * err_p
    top1_conf = top1(logits[confident], refs[confident]) if bool(confident.any()) else 0.0
    summary = (f"max|split-plain|={err:.6g} tol={tol:.6g}; vs f32 max|split-f32|={err_k:.6g} "
               f"max|plain-f32|={err_p:.6g}; top-1 split/f32={top1(logits, truths):.4f} "
               f"plain/f32={top1(refs, truths):.4f}, split/plain over the "
               f"{int(confident.sum())} confident images {top1_conf:.4f}")
    if sign_test:  # serving_phase's top1_sign_test, for a plain path as precise as the split
        hit_s, hit_p = (a.argmax(-1) == truths.argmax(-1) for a in (logits, refs))
        split_only, plain_only = int((hit_s & ~hit_p).sum()), int((hit_p & ~hit_s).sum())
        top1_ok = plain_only - split_only <= SIGN_TEST_Z * math.sqrt(plain_only + split_only)
        summary += f"; images only split / only plain agree with f32 on {split_only} / " \
                   f"{plain_only} (sign test)"
    else:
        top1_ok = top1(logits, truths) >= top1(refs, truths)
    if not (err <= tol and err_k <= MAX_ERR_VS_PLAIN_BF16 * err_p and top1_ok
            and (top1_conf >= TOP1_CONFIDENT or not confident_images)):
        raise AssertionError(f"{tag}: {summary}")
    return summary


def tp_path_phase(torch, smi, workdir):
    """ViT-B/32@256 (bench.py) split over a ``model`` axis of TP: TP
    processes on the one card (:func:`tp_rank`), a gloo group between them
    (NCCL takes no two ranks on one device), so that the collectives stage
    the card's tensors through the host.  Held here against the one-process
    models of the same weights: the served logits by :func:`hold_logits`
    against the plain bf16 path and the f32 model; the step-1 gradients,
    gathered, each within MAX_GRAD_ERR_VS_PLAIN_BF16 times the plain bf16
    path's error against the f32 model (TF32 off); the first loss within
    LOSS_REL_TOL of the plain path's, falling losses; on every rank rows 1-4
    on their split forms depth times each way a forward and a step (the
    unsplit kernels never), the pass and the LayerNorm backward twice that.
    Times: each rank's step, labelled TP_LABEL.  Returns rank 0's launches
    over the serving and training runs."""
    import torch.multiprocessing as mp

    from vit_tpu_torch import ViT, cast_params
    from vit_tpu_torch.parallel.train import cross_entropy_loss

    port = free_port()
    ctx = mp.start_processes(tp_rank, args=(port, workdir), nprocs=TP, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TP_JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"tensor-parallel: the ranks did not finish in "
                                     f"{TP_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(workdir, f"tp_rank{r}.pt"), weights_only=False)
             for r in range(TP)]
    depth = ENTRY["depth"]
    forward = {"fused_attention_block_split": depth, "fused_mlp_split": depth,
               "short route, forward": depth, "bias_residual": 2 * depth,
               "forward_gemm_f32": 2 * depth}
    step_each = {**forward, "fused_attention_block_split_bwd": depth,
                 "fused_mlp_split_bwd": depth, "short route": depth, "ln_bwd": 2 * depth}
    for r, rank in enumerate(ranks):
        for way, runs, each in (("serving", rank["serving_counts"], forward),
                                ("training", rank["train_counts"], step_each)):
            for i, got in enumerate(runs):
                want = {k: (i + 1) * each.get(k, 0) for k in got}
                if got != want:
                    raise AssertionError(f"tensor-parallel rank {r} {way}: after call {i + 1} "
                                         f"the kernels were launched {got}, expected {want}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(TP_SEED)
    served = cast_params(ViT(**ENTRY, device=dev, generator=g), torch.bfloat16).eval()
    size = ENTRY["image_size"]
    requests = [torch.randn(INFRA_BATCH, size, size, 3, generator=g, device=dev)
                for _ in range(3)]
    plain = ViT(**ENTRY, **PLAIN_KW, device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(served.state_dict())
    f32 = ViT(**ENTRY, **PLAIN_KW, device=dev, dtype=torch.float32).eval()
    f32.load_state_dict({k: v.float() for k, v in served.state_dict().items()})
    with torch.inference_mode():
        refs = torch.cat([plain(img).float() for img in requests])
        truths = torch.cat([f32(img).float() for img in requests])
    logits = [torch.cat(rank["logits"]).to(dev) for rank in ranks]
    if not torch.equal(logits[0], logits[1]) or tuple(logits[0].shape) != (
            3 * INFRA_BATCH, ENTRY["num_classes"]) or not bool(torch.isfinite(logits[0]).all()):
        raise AssertionError("tensor-parallel serving: the ranks' logits differ, or are not "
                             "finite (384, 1000)")
    serving = hold_logits(torch, "tensor-parallel serving", logits[0], refs, truths)
    del served, plain, f32, requests

    _, plain, f32, images, labels = training_models(torch, ViT, ENTRY, INFRA_BATCH, TP_SEED)
    grads, first = {}, {}
    for name, m in (("plain", plain), ("f32", f32)):
        m.train()
        loss = cross_entropy_loss(m(images), labels)
        loss.backward()
        first[name] = loss.item()
        grads[name] = {k: p.grad.detach() for k, p in m.named_parameters()}
    split = {k: v.to(dev) for k, v in ranks[0]["grads"].items()}
    misses, worst, worst_name = [], 0.0, ""
    for k, ref in grads["f32"].items():
        err_s, err_p = rel_l2(torch, split[k], ref), rel_l2(torch, grads["plain"][k], ref)
        if err_s / max(err_p, 1e-30) > worst:
            worst, worst_name = err_s / max(err_p, 1e-30), k
        if not err_s <= MAX_GRAD_ERR_VS_PLAIN_BF16 * err_p:
            misses.append(f"{k}: {err_s:.4g} vs plain {err_p:.4g}")
    cat = {n: torch.cat([v.flatten() for v in grads[n].values()]) for n in grads}
    all_s = rel_l2(torch, torch.cat([split[k].flatten() for k in grads["f32"]]), cat["f32"])
    all_p = rel_l2(torch, cat["plain"], cat["f32"])
    losses = ranks[0]["losses"]
    loss_rel = abs(ranks[0]["first"] - first["plain"]) / abs(first["plain"])
    log(f"tensor-parallel ViT-B/32@256 over a (1, {TP}) mesh, {TP} processes on one card over "
        f"gloo, batch {INFRA_BATCH}, bf16 compute, f32 parameters, SGD(1e-3): serving 3 x "
        f"{INFRA_BATCH} images, the ranks' logits bit for bit: {serving}; step-1 loss split="
        f"{ranks[0]['first']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f} "
        f"(|split-plain|/plain={loss_rel:.3g} <= {LOSS_REL_TOL}); step-1 gradients gathered, "
        f"relative L2 against f32 over all parameters split={all_s:.4g} plain={all_p:.4g}, "
        f"worst per-tensor ratio split/plain={worst:.3f} ({worst_name}; <= "
        f"{MAX_GRAD_ERR_VS_PLAIN_BF16}); losses over {TP_STEPS} steps rank 0 {losses}, rank 1 "
        f"{ranks[1]['losses']}; launches per forward {forward} and per step {step_each} on "
        f"each rank; step ms rank 0 {ranks[0]['step_ms']:.3f}, rank 1 "
        f"{ranks[1]['step_ms']:.3f} ({TP_LABEL}; the one-process B/32 step "
        f"{STEP_MS.get('ViT-B/32@256 (bench.py)', {}).get('kernels', float('nan')):.3f}); "
        f"rank 0's wall ms of one all-reduce over gloo: a block's f32 partial over the model "
        f"group {ranks[0]['model all-reduce'][0]:.3f} ({ranks[0]['model all-reduce'][1]} "
        f"bytes; {4 * depth} a step), the gradients over the data axis of 1 "
        f"{ranks[0]['data all-reduce'][0]:.3f} ({ranks[0]['data all-reduce'][1]} bytes; one "
        f"a step) on {smi}")
    if misses:
        raise AssertionError(f"tensor-parallel: gradients beyond {MAX_GRAD_ERR_VS_PLAIN_BF16}x "
                             f"the plain path's error: {misses}")
    if not loss_rel <= LOSS_REL_TOL or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] or losses != ranks[1]["losses"]:
        raise AssertionError(f"tensor-parallel: losses {losses} and {ranks[1]['losses']}, "
                             f"first {ranks[0]['first']} against the plain path's "
                             f"{first['plain']}")
    launches = {k: ranks[0]["serving_counts"][-1][k] + ranks[0]["train_counts"][-1][k]
                for k in ranks[0]["train_counts"][-1]}
    models = tp_hybrid_phase(torch, smi, workdir)
    return {k: launches.get(k, 0) + models.get(k, 0) for k in {**launches, **models}}


# The conv hybrids split over TP ranks, as run_benchmarks.py builds them:
# (tag, class, configuration, side, serving batch, training batch, seed, the
# plain path's keywords).  Twins-SVT@224 (:65) at its batch 64 on the kernel
# route (at 16 its first loss lies 1.04e-3 from the one-process path's, past
# TP_LOSS_REL_TOL: bf16 noise over fewer images); CvT-13@224 (:91), LeViT@224
# (:62-64) and MobileViT@256 (:68-71) on the plain modules (CvT-13's flash
# stage whole), serving 64 images and training at a batch cut to 16 to keep
# the phase in time.
TP_HYBRIDS = [
    ("Twins-SVT@224", "TwinsSVT", TWINS, TWINS_SIZE, TWINS_BATCH, TWINS_BATCH, TP_SEED + 2,
     PLAIN_KW),
    ("CvT-13@224", "CvT", CVT13, 224, 64, 16, TP_SEED + 3, dict(use_flash="never")),
    ("LeViT@224", "LeViT", LEVIT, LEVIT_SIZE, LEVIT_BATCH, 16, TP_SEED + 4, {}),
    ("MobileViT@256", "MobileViT", MOBILEVIT, MOBILEVIT_SIZE, MOBILEVIT_BATCH, 16, TP_SEED + 5,
     {}),
]
# The biased and windowed models split over TP ranks, as run_benchmarks.py
# builds them (the smoke's SMALL_DATASET, CROSSFORMER, REGIONVIT and NEST), on
# the kernel route, serving 64 images (enough for the confident-image check)
# and training at a batch cut to 16: this path measures no TP speed.
TP_BIASED = [
    ("small-dataset ViT@256", "vit_for_small_dataset.ViT", SMALL_DATASET, 256, 64, 16,
     TP_SEED + 6, PLAIN_KW),
    ("CrossFormer@224", "CrossFormer", CROSSFORMER, CROSSFORMER_SIZE, 64, 16, TP_SEED + 7,
     PLAIN_KW),
    ("RegionViT@224", "RegionViT", REGIONVIT, REGIONVIT_SIZE, 64, 16, TP_SEED + 8,
     dict(fused_attention="never")),
    ("NesT@224", "NesT", NEST, NEST["image_size"], 64, 16, TP_SEED + 9, PLAIN_KW),
]
# The dense five split over TP ranks, at the smoke's configurations
# (run_benchmarks.py's: DEEPVIT, PATCH_MERGER, CROSSVIT, CAIT, PARALLEL_VIT),
# serving 64 images and training at a batch cut to 16: DeepViT, the merger's
# ViT and CrossViT on the kernel route (their MLPs on rows 1-2's split form),
# CaiT and Parallel ViT on plain modules (vit_tpu runs no kernel there).
TP_DENSE = [
    ("DeepViT@256", "DeepViT", DEEPVIT, 256, 64, 16, TP_SEED + 12, dict(fused_mlp="never")),
    ("PatchMerger ViT@256", "vit_with_patch_merger.ViT", PATCH_MERGER, 256, 64, 16,
     TP_SEED + 13, dict(fused_mlp="never")),
    ("CrossViT@256", cross_vit, CROSSVIT, 256, 64, 16, TP_SEED + 14, dict(plain=True)),
    ("CaiT@256", "CaiT", CAIT, 256, 64, 16, TP_SEED + 15, {}),
    ("Parallel ViT@256", "parallel_vit.ViT", PARALLEL_VIT, 256, 64, 16, TP_SEED + 16, {}),
]
# The rest of the zoo split over TP ranks, at the smoke's configurations
# (run_benchmarks.py's ATS, CCT14, SCALABLE and T2T), serving 64 images and
# training at a batch cut to 16: ATS-ViT with its MLPs on rows 1-2's split
# form, CCT-14 on plain modules (vit_tpu runs no kernel there; its attention
# dropout and stochastic depth on one fixed draw), ScalableViT on row 6's and
# row 10's split forms and rows 1-2's, T2T-ViT's token transformers whole on
# the unsplit rows 7-8 and 1-2 and its encoder on rows 1-4's split forms.
TP_REST = [
    ("ATS-ViT@256", ats_kernels, ATS, 256, 64, 16, TP_SEED + 18, dict(fused_mlp="never")),
    ("CCT-14@224", "CCT", CCT14, CCT_SIZE, 64, 16, TP_SEED + 19, {}),
    ("ScalableViT@256", "ScalableViT", SCALABLE, SCALABLE_SIZE, 64, 16, TP_SEED + 20,
     PLAIN_KW),
    ("T2T-ViT@224", t2t_vit, T2T, 224, 64, 16, TP_SEED + 21, dict(plain=True)),
]
TP_TABLES = {"hybrids": TP_HYBRIDS, "biased": TP_BIASED, "dense": TP_DENSE, "rest": TP_REST}
# The models whose first loss is held over the images whose sampled token
# sets agree on the split and the one-process path (:func:`tp_sampled`).
TP_SAMPLED = ("ATS-ViT@256",)
TP_HYBRID_STEPS = 2
TP_LOSS_REL_TOL = 1e-3  # the split path's first loss against the one-process path's


def tp_hybrid_counts():
    """Each TP_HYBRIDS model's launches a forward and a step on every rank:
    Twins-SVT's residuals all on the split forms (rows 3-4's block at its 10
    local attentions, row 6's at its 15 global ones, rows 1-2's at its 25
    conv-MLPs; each partial ended by the pass after one f32-partial GEMM; the
    backwards as often, the cross-attention's on route 2, the blocks' and
    MLPs' LayerNorm backwards on ``ln_bwd``), the unsplit rows 1-4 and 6
    never; CvT-13's stage-1 flash attention whole; nothing on LeViT and
    MobileViT."""
    local, every = sum(TWINS_BLOCKS[:3]), sum(TWINS_BLOCKS)
    twins = {"fused_attention_block_split": local, "short route, forward": local,
             "fused_cross_attention_split": every, "fused_mlp_split": local + every,
             "bias_residual": 2 * local + 2 * every, "forward_gemm_f32": 2 * local + 2 * every}
    twins_step = {**twins, "fused_attention_block_split_bwd": local, "short route": local,
                  "fused_cross_attention_split_bwd": every, "cross backward, split": every,
                  "fused_mlp_split_bwd": local + every, "ln_bwd": 2 * local + every}
    cvt = {"flash_attention": 1}
    return {"Twins-SVT@224": (twins, twins_step), "CvT-13@224": (cvt, {**cvt, "flash_backward": 1}),
            "LeViT@224": ({}, {}), "MobileViT@256": ({}, {}), **tp_biased_counts(),
            **tp_dense_counts(), **tp_rest_counts()}


def tp_split_counts(bias=0, block=0, whole=0, mlp=0):
    """The launches a forward and a step on every rank of a model whose
    ``bias`` biased and ``block`` unbiased attention blocks and ``mlp`` MLPs
    run split on the kernel route and ``whole`` attention blocks whole: each
    partial ended by the pass after one f32-partial GEMM, the backwards as
    often, every split LayerNorm backward on ``ln_bwd``."""
    split = bias + block
    forward = {"fused_attention_block_bias_split": bias, "fused_attention_block_split": block,
               "fused_attention_block": whole, "short route, forward": split + whole,
               "fused_mlp_split": mlp, "bias_residual": split + mlp,
               "forward_gemm_f32": split + mlp}
    step = {**forward, "fused_attention_block_bias_split_bwd": bias,
            "fused_attention_block_split_bwd": block, "fused_attention_block_bwd": whole,
            "short route": split + whole, "fused_mlp_split_bwd": mlp, "ln_bwd": split + mlp}
    return ({k: v for k, v in forward.items() if v}, {k: v for k, v in step.items() if v})


def tp_biased_counts():
    """Each TP_BIASED model's launches a forward and a step on every rank
    (:func:`tp_split_counts`), the unsplit row 5 never.  The small-dataset
    ViT: row 5 and rows 1-2 at its 6 layers.  CrossFormer: row 5 at its 14
    short windows and stages 1-2's 4 long ones (stages 3-4's 2 x 2 and 1 x 1
    plain), rows 1-2 at its 28 MLPs.  RegionViT: rows 3-4 at its 14 region
    self-attentions and row 5 at its 14 joint rows (its MLPs plain).  NesT:
    hierarchy 1's 2 three-head attentions whole on the unsplit rows 3-4, the
    other 10 split, rows 1-2 at its 12 MLPs."""
    counts = tp_split_counts
    depth = SMALL_DATASET["depth"]
    return {"small-dataset ViT@256": counts(bias=depth, mlp=depth),
            "CrossFormer@224": counts(bias=sum(CROSSFORMER_DEPTH) + sum(CROSSFORMER_DEPTH[:2]),
                                      mlp=2 * sum(CROSSFORMER_DEPTH)),
            "RegionViT@224": counts(bias=sum(REGIONVIT_DEPTH), block=sum(REGIONVIT_DEPTH)),
            "NesT@224": counts(block=sum(NEST["block_repeats"][1:]),
                               whole=NEST["block_repeats"][0], mlp=sum(NEST["block_repeats"]))}


def tp_dense_counts():
    """Each TP_DENSE model's launches a forward and a step on every rank
    (:func:`tp_split_counts`): rows 1-2's split form at DeepViT's 6 MLPs, the
    merger's ViT's 12 and CrossViT's 4 x (2 + 3); none on CaiT and Parallel
    ViT; the unsplit rows 1-2 never (the attentions plain)."""
    return {"DeepViT@256": tp_split_counts(mlp=DEEPVIT["depth"]),
            "PatchMerger ViT@256": tp_split_counts(mlp=PATCH_MERGER["depth"]),
            "CrossViT@256": tp_split_counts(mlp=CROSSVIT["depth"] * (
                CROSSVIT["sm_enc_depth"] + CROSSVIT["lg_enc_depth"])),
            "CaiT@256": ({}, {}), "Parallel ViT@256": ({}, {})}


def tp_rest_counts():
    """Each TP_REST model's launches a forward and a step on every rank
    (:func:`tp_split_counts`).  ATS-ViT: rows 1-2's split form at its 6
    MLPs.  CCT-14: none.  ScalableViT: row 6's split form at its 14 SSAs
    (the backward on route 2), rows 1-2's at its 28 conv-MLPs, row 10 over
    the local heads at its 4 IWSAs of stages 1-2 (a window of 1024 tokens or
    more; the backward on the flash backward), the unsplit rows 1-2 and 6
    never.  T2T-ViT: its token transformers whole, token transformer 0's
    attention on the unsplit flash kernels (3136 tokens) and both token MLPs
    on the unsplit rows 1-2; rows 1-4's split forms at its encoder's 5
    layers."""
    blocks = sum(SCALABLE["depth"])
    windows = [SCALABLE_SIZE // 4 // 2 ** i if w is None else w
               for i, w in enumerate(SCALABLE["window_size"])]
    packed = sum(d for d, w in zip(SCALABLE["depth"], windows) if w * w >= 1024)
    forward, step = tp_split_counts(mlp=2 * blocks)
    split = {"fused_cross_attention_split": blocks, "bias_residual": blocks,
             "forward_gemm_f32": blocks, "flash_attention_packed": packed}
    forward = {k: forward.get(k, 0) + split.get(k, 0) for k in {**forward, **split}}
    step = {k: step.get(k, 0) + split.get(k, 0) for k in {**step, **split}}
    step.update({"fused_cross_attention_split_bwd": blocks, "cross backward, split": blocks,
                 "flash_backward": packed})
    depth = T2T["depth"]
    t2t, t2t_step = tp_split_counts(block=depth, mlp=depth)
    token = {"flash_attention": 1, "fused_mlp": 2}
    return {"ATS-ViT@256": tp_split_counts(mlp=ATS["depth"]), "CCT-14@224": ({}, {}),
            "ScalableViT@256": (forward, step),
            "T2T-ViT@224": ({**t2t, **token},
                            {**t2t_step, **token, "flash_backward": 1, "fused_mlp_bwd": 2})}


def ids_alike(sets):
    """The images on which every one of ``sets`` of ATS-ViT's sampled ids
    (``{layer: (b, k + 1) ids}``, :func:`ats_sampled_ids`) agrees at every
    layer: a bool vector on the host."""
    first, *rest = sets
    alike = None
    for layer, ids in first.items():
        for other in rest:
            same = (other[layer].cpu() == ids.cpu()).all(1)
            alike = same if alike is None else alike & same
    return alike


def tp_sampled(torch, model, images, labels, draw):
    """ATS-ViT ``model``'s sampled ids at each sampling layer and each
    image's loss, one forward each under ``no_grad`` in training mode on the
    draw ``draw()`` (:func:`ats_sampled_ids`), on the host."""
    import torch.nn.functional as F

    model.train()
    ids = ats_sampled_ids(torch, model, images, draw)
    with torch.no_grad():
        per_image = F.cross_entropy(model(images, **draw()).float(), labels, reduction="none")
    return {"ids": {layer: v.cpu() for layer, v in ids.items()}, "per_image": per_image.cpu()}


def tp_model_class(name):
    """A TP_TABLES class by its name in ``vit_tpu_torch`` (``module.Class``
    for the models named ``ViT``), or the function given in its place
    (CrossViT's, whose plain path is no constructor argument)."""
    import vit_tpu_torch

    if callable(name):
        return name

    module, _, cls = name.rpartition(".")
    return getattr(getattr(vit_tpu_torch, module) if module else vit_tpu_torch, cls)


def tp_hybrid_model(torch, name, cfg, size, batch, seed, **kw):
    """A TP_TABLES model from ``seed`` (its BatchNorms seeded,
    :func:`seed_batch_norms`) and one seeded batch: what each rank builds and
    what the one-process references load."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = tp_model_class(name)(**cfg, device=dev, generator=g, **kw)
    seed_batch_norms(torch, model, g)
    images = torch.randn(batch, size, size, 3, generator=g, device=dev)
    return model, images, torch.arange(batch, device=dev) % cfg["num_classes"]


def tp_models(tables=None):
    """The models of TP_TABLES' ``tables`` (every table by default), in
    order: what one spawn of :func:`tp_hybrid_rank` runs."""
    return [model for table in (tables or TP_TABLES) for model in TP_TABLES[table]]


def tp_hybrid_rank(rank, port, workdir, tables=None):
    """One rank of :func:`tp_hybrid_phase` (a spawned process on the one
    card): joins a gloo group of TP processes, lays a (1, TP) mesh, and for
    each model of :func:`tp_models` serves one batch (``cast_params`` bf16, eval,
    inference mode) and trains (bf16 compute, f32 parameters, SGD(1e-3))
    TP_HYBRID_STEPS steps of ``make_train_step`` over the mesh, each counter
    from 0 before the serving forward and before the steps, read after each;
    step 1's loss and gradients, gathered whole; each step's wall ms and the
    model's seconds.  Writes what it saw to ``tp_models_rank<r>.pt`` in
    ``workdir``."""
    import torch

    from vit_tpu_torch import cast_params
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.sharding import gather_tensor, shard_params
    from vit_tpu_torch.parallel.train import make_train_step

    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        initialize_distributed(f"127.0.0.1:{port}", TP, rank, backend="gloo", timeout_s=300)
        mesh = make_mesh((1, TP))
        lib, counters = _build.load(), counter_objects()
        f32_gemms = [0]

        def zero():
            for c in counters.values():
                c.launches = 0
            lib.vit_take_launch_count(COUNTED_F32)
            f32_gemms[0] = 0

        def counts():
            f32_gemms[0] += lib.vit_take_launch_count(COUNTED_F32)
            return {**{k: c.launches for k, c in counters.items()},
                    "forward_gemm_f32": f32_gemms[0]}

        for tag, name, cfg, size, serve_batch, batch, seed, _ in tp_models(tables):
            started = time.perf_counter()
            model, images, _ = tp_hybrid_model(torch, name, cfg, size, serve_batch, seed)
            served = shard_params(mesh, cast_params(model, torch.bfloat16).eval())
            draw = draws(torch, served, seed)
            zero()
            with torch.inference_mode():
                logits = served(images, **draw()).float()
                serving = counts()
                served_ids = {k: v.cpu() for k, v in ats_sampled_ids(
                    torch, served, images, draw).items()} if tag in TP_SAMPLED else None
            whole = list(served.tensor_parallel.whole)
            del served, model, images

            model, images, labels = tp_hybrid_model(torch, name, cfg, size, batch, seed,
                                                    compute_dtype=torch.bfloat16)
            shard_params(mesh, model)
            plan = model.tensor_parallel
            draw = draws(torch, model, seed)
            sampled = tp_sampled(torch, model, images, labels, draw) if tag in TP_SAMPLED \
                else None
            step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3),
                                   mesh=mesh)
            torch.distributed.barrier()
            zero()
            losses, per_step, walls, grads = [], [], [], {}
            for i in range(TP_HYBRID_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(images, labels, **draw())["loss"].item())
                walls.append((time.perf_counter() - t0) * 1e3)
                per_step.append(counts())
                if i == 0:  # step 1's gradients, left in .grad until step 2 zeroes them
                    grads = {k: gather_tensor(p.grad, plan.kinds[k], plan.shard)
                             if k in plan.kinds else p.grad for k, p in model.named_parameters()}
                    grads = {k: v.cpu() for k, v in grads.items()} if rank == 0 else {}
            out[tag] = dict(logits=logits.cpu(), serving_counts=serving, first=losses[0],
                            grads=grads, losses=losses, train_counts=per_step, step_ms=walls,
                            whole=whole, split=len(plan.kinds), sampled=sampled,
                            served_ids=served_ids,
                            seconds=time.perf_counter() - started)
            del model, step, images, labels
            torch.cuda.empty_cache()
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(workdir, f"tp_models_rank{rank}.pt"))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def tp_spawn(torch, fn, workdir, prefix, *args):
    """Run ``fn(rank, port, workdir, *args)`` in TP processes on the one card
    and load what each wrote to ``<prefix><r>.pt``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(free_port(), workdir, *args), nprocs=TP, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TP_JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"tensor-parallel: the ranks did not finish in "
                                     f"{TP_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(workdir, f"{prefix}{r}.pt"), weights_only=False)
            for r in range(TP)]


def tp_gradient_check(torch, tag, split, grads, weights):
    """Each gathered step-1 gradient of the split path within
    MAX_GRAD_ERR_VS_PLAIN_BF16 times the unsplit plain bf16 path's relative
    L2 error against the f32 model's, the 0-d ones (LSA's temperatures) and
    each tensor of CrossFormer's position-bias MLPs as one stack across the
    layers (:func:`stacked_groups`, as :func:`step1_gradients` holds them)
    and each temperature by :func:`check_temperatures` (``weights``: the f32
    model's parameters), but those below 1e-3 of the median norm (0 in exact
    arithmetic: LeViT's biases before a BatchNorm in training, as
    :func:`plain_training_phase` leaves them out); a summary."""
    dev = torch.device("cuda")
    grads = {"kernels": {k: v.to(dev) for k, v in split.items()}, **grads}
    temperatures = check_temperatures(torch, f"tensor-parallel {tag}", grads, weights)
    stacks = stacked_groups(grads["f32"])
    for path in ("kernels", "plain", "f32"):
        held = {k: v for k, v in grads[path].items()
                if not any(k in keys for keys in stacks.values())}
        for label, keys in stacks.items():
            held[label] = torch.cat([grads[path][k].flatten() for k in keys])
        grads[path] = held
    norms = {k: torch.linalg.vector_norm(v).item() for k, v in grads["f32"].items()}
    floor = 1e-3 * statistics.median(norms.values())
    misses, worst, worst_name = [], 0.0, ""
    for k, ref in grads["f32"].items():
        if norms[k] < floor:
            continue
        err_s, err_p = rel_l2(torch, grads["kernels"][k], ref), rel_l2(torch, grads["plain"][k],
                                                                       ref)
        if err_s / max(err_p, 1e-30) > worst:
            worst, worst_name = err_s / max(err_p, 1e-30), k
        if not err_s <= MAX_GRAD_ERR_VS_PLAIN_BF16 * err_p:
            misses.append(f"{k}: {err_s:.4g} vs plain {err_p:.4g}")
    cat = {n: torch.cat([v.flatten() for v in grads[n].values()]) for n in grads}
    all_s, all_p = (rel_l2(torch, cat[n], cat["f32"]) for n in ("kernels", "plain"))
    if misses:
        raise AssertionError(f"tensor-parallel {tag}: gradients beyond "
                             f"{MAX_GRAD_ERR_VS_PLAIN_BF16}x the plain path's error: {misses}")
    return (f"step-1 gradients gathered, relative L2 against f32 over all parameters "
            f"split={all_s:.4g} plain={all_p:.4g}, worst per-tensor ratio split/plain="
            f"{worst:.3f} ({worst_name}; <= {MAX_GRAD_ERR_VS_PLAIN_BF16}; "
            f"{sum(v < floor for v in norms.values())} below 1e-3 of the median norm left out"
            f"{'; ' + ', '.join(stacks) if stacks else ''}); {temperatures}")


def tp_hybrid_phase(torch, smi, workdir, tables=None):
    """The models of :func:`tp_models` (the conv hybrids, the biased and
    windowed models, the dense five and the rest: every table by default)
    split over a ``model`` axis of TP, TP processes on the one card over
    gloo, one spawn for them all (:func:`tp_hybrid_rank`), held here
    against one-process models of the same weights: both ranks' logits and
    losses bit for bit equal; the served logits by :func:`hold_logits`
    against the unsplit plain bf16 path and the f32 model (top-1 by the sign
    test: the plain paths keep f32 logits and softmax where the kernels do);
    the first loss within TP_LOSS_REL_TOL of the one-process path's on the
    same route; the step-1 gradients, gathered, by
    :func:`tp_gradient_check` (TF32 off); falling losses; the launches of
    :func:`tp_hybrid_counts` on every rank, after each forward and step.
    Step times labelled TP_LABEL.  Returns rank 0's launches over its
    serving and training runs, summed over the models."""
    from vit_tpu_torch import cast_params
    from vit_tpu_torch.parallel.train import cross_entropy_loss

    ranks = tp_spawn(torch, tp_hybrid_rank, workdir, "tp_models_rank", tables)
    for r, rank in enumerate(ranks):
        if "error" in rank:
            raise AssertionError(f"tensor-parallel rank {r}: {rank['error']}")
    expected = tp_hybrid_counts()
    dev = torch.device("cuda")
    launches = {}
    for tag, name, cfg, size, serve_batch, batch, seed, plain_kw in tp_models(tables):
        started = time.perf_counter()
        cls = tp_model_class(name)
        forward, step_each = expected[tag]
        for r, rank in enumerate(ranks):
            got = rank[tag]["serving_counts"]
            want = {k: forward.get(k, 0) for k in got}
            if got != want:
                raise AssertionError(f"tensor-parallel {tag} rank {r} serving: launched {got}, "
                                     f"expected {want}")
            for i, got in enumerate(rank[tag]["train_counts"]):
                want = {k: (i + 1) * step_each.get(k, 0) for k in got}
                if got != want:
                    raise AssertionError(f"tensor-parallel {tag} rank {r} training: after step "
                                         f"{i + 1} launched {got}, expected {want}")
        a, b = (rank[tag] for rank in ranks)
        if not torch.equal(a["logits"], b["logits"]) or a["losses"] != b["losses"] \
                or a["first"] != b["first"]:
            raise AssertionError(f"tensor-parallel {tag}: the ranks' logits or losses differ")
        for k, v in a["serving_counts"].items():
            launches[k] = launches.get(k, 0) + v + a["train_counts"][-1][k]
        packed = a["serving_counts"]["flash_attention_packed"]
        if packed:  # row 10 over the local heads: IWSA's, every flash backward its own
            step = a["train_counts"][-1]
            for key, count in (("flash_attention_packed_split",
                                packed + step["flash_attention_packed"]),
                               ("flash_attention_packed_split_bwd", step["flash_backward"])):
                launches[key] = launches.get(key, 0) + count

        model, images, _ = tp_hybrid_model(torch, name, cfg, size, serve_batch, seed)
        norms = batch_norm_text(model)
        state = cast_params(model, torch.bfloat16).state_dict()
        plain = cls(**cfg, **plain_kw, device=dev, dtype=torch.bfloat16).eval()
        plain.load_state_dict(state)
        f32 = cls(**cfg, **plain_kw, device=dev).eval()
        f32.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in state.items()})
        with torch.inference_mode():
            refs, truths = (m(images, **draws(torch, m, seed)()).float() for m in (plain, f32))
        logits = a["logits"].to(dev)
        if tuple(logits.shape) != (serve_batch, cfg["num_classes"]) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"tensor-parallel {tag}: logits {tuple(logits.shape)}")
        over = ""
        if tag in TP_SAMPLED:  # over the images on which the three compute one network
            alike = ids_alike([a["served_ids"], *(ats_sampled_ids(
                torch, m, images, draws(torch, m, seed)) for m in (plain, f32))]).to(dev)
            if not bool(alike.any()):
                raise AssertionError(f"tensor-parallel {tag}: no image on which the split, "
                                     f"plain and f32 models sample one token set")
            over = (f"held over the {int(alike.sum())} of {serve_batch} images whose sampled "
                    f"sets agree on the split, plain and f32 models at every layer: ")
            logits, refs, truths = logits[alike], refs[alike], truths[alike]
        # A path that runs no kernel (LeViT, MobileViT) is held as
        # plain_serving_phase holds it, without the confident images: at
        # these random weights its top-2 margins lie under the bf16 noise.
        serving = over + hold_logits(torch, f"tensor-parallel {tag} serving", logits, refs,
                                     truths, sign_test=True, confident_images=bool(forward))
        del model, plain, f32, images, refs, truths

        model, images, labels = tp_hybrid_model(torch, name, cfg, size, batch, seed,
                                                compute_dtype=torch.bfloat16)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        plain = cls(**cfg, **plain_kw, device=dev, compute_dtype=torch.bfloat16)
        f32 = cls(**cfg, **plain_kw, device=dev)
        grads, first = {}, {}
        for path, m in (("one-process", model), ("plain", plain), ("f32", f32)):
            m.load_state_dict(start)
            m.train()
            draw = draws(torch, m, seed)
            if path == "one-process" and tag in TP_SAMPLED:
                sampled = tp_sampled(torch, m, images, labels, draw)
            loss = cross_entropy_loss(m(images, **draw()), labels)
            loss.backward()
            first[path] = loss.item()
            grads[path] = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach()
                           for k, p in m.named_parameters()}
        gradients = tp_gradient_check(torch, tag, a["grads"], grads,
                                      dict(f32.named_parameters()))
        del model, plain, f32, grads, images, labels
        torch.cuda.empty_cache()
        loss_rel = abs(a["first"] - first["one-process"]) / abs(first["one-process"])
        held = ""
        if tag in TP_SAMPLED:  # over the images whose sampled sets agree at every layer
            alike = ids_alike([a["sampled"]["ids"], sampled["ids"]])
            split_loss, one_loss = (p["per_image"][alike].mean().item()
                                    for p in (a["sampled"], sampled))
            loss_rel = abs(split_loss - one_loss) / abs(one_loss)
            held = (f"sampled sets alike on both paths at every layer on {int(alike.sum())} of "
                    f"{batch} images ({batch - int(alike.sum())} differ), their mean loss "
                    f"split={split_loss:.6f} one-process={one_loss:.6f}; ")
        losses = a["losses"]
        log(f"tensor-parallel {tag} over a (1, {TP}) mesh, {TP} processes on one card over gloo "
            f"({'the kernel route' if forward else 'plain modules'}; "
            f"{a['split']} tensors split, whole: {a['whole'] or 'none'}), bf16 compute, f32 "
            f"parameters, SGD(1e-3), {norms}: serving "
            f"{serve_batch} images, the ranks' logits bit for bit: {serving}; step-1 loss at "
            f"batch {batch} split={a['first']:.6f} one-process={first['one-process']:.6f} "
            f"plain={first['plain']:.6f} f32={first['f32']:.6f} ({held}|split-one-process|/"
            f"one-process={loss_rel:.3g} <= {TP_LOSS_REL_TOL}); {gradients}; losses over "
            f"{TP_HYBRID_STEPS} steps {losses} on both ranks; launches per forward "
            f"{expected[tag][0]} and per step {expected[tag][1]} on each rank; step wall ms "
            f"rank 0 {[round(v, 3) for v in a['step_ms']]}, rank 1 "
            f"{[round(v, 3) for v in b['step_ms']]} ({TP_LABEL}); rank 0 {a['seconds']:.1f} s "
            f"for the model, the references here {time.perf_counter() - started:.1f} s on "
            f"{smi}")
        if not loss_rel <= TP_LOSS_REL_TOL or not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"tensor-parallel {tag}: losses {losses}, first "
                                 f"{a['first']} against the one-process path's "
                                 f"{first['one-process']}")
    return launches


def tp_entries(results, tp_launches):
    """The split forms' lines of the kernels' JSON: launches on the
    tensor-parallel path (rank 0's, B/32 and the conv hybrids), the largest
    error of their checks, their times and bounds at rank 0's slice of B/32
    (row 6's at Twins-SVT's stage 1), other shapes under ``by_shape``."""
    lines = []
    for name, (src, tpu) in TP_SOURCES.items():
        r = results["tensor-parallel"][name]
        line = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": tp_launches[name], "max_abs_err": r["err"], "ms": r["kernel"],
                "plain_ms": r["plain"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library"], "shape": r.get("shape", f"B/32 rank 0 of {TP}")}
        line.update({k: r[k] for k in ("mma_sync", "with_pass", "unsplit", "backward_route")
                     if k in r})
        if "by_shape" in r:
            line["by_shape"] = {tag: {k: (v[0] if k == "bound" else v) for k, v in entry.items()}
                                for tag, entry in r["by_shape"].items()}
        if name == "forward_gemm_f32":
            line["fc2"] = {k: (v if k != "bound" else v[0])
                           for k, v in results["tensor-parallel"]["forward_gemm_f32 (fc2)"].items()}
        lines.append(line)
    return lines


def main() -> int:
    # ScalableViT's plain training path peaks at 72 GB of the card's 80 (its
    # stage-1 IWSA keeps (64, 2, 4096, 4096) score maps for the backward);
    # beside the blocks the kernel path's steps leave in PyTorch's cache,
    # fixed-size segments fragment and a 16 GiB request fails.  Growable
    # segments avoid that.  Set before CUDA starts.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from vit_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s); TF32 off")

    t0 = time.perf_counter()
    path, build_log = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = [int(line.split("Used ")[1].split()[0])
            for line in build_log.splitlines() if "Used " in line and "registers" in line]
    spills = sum("0 bytes spill stores" not in line
                 for line in build_log.splitlines() if "spill stores" in line)
    log(f"build: {build_s:.2f} s, {path.name}, {len(regs)} kernels compiled, "
        f"max {max(regs, default=0)} registers, {spills} with spills")
    ptxas = ptxas_report(build_log)
    log(f"ptxas, the wgmma+tma kernels (dynamic shared memory is set at launch): "
        f"{json.dumps(ptxas)}")

    from vit_tpu_torch import (
        CaiT, CrossFormer, CvT, DeepViT, LeViT, MobileViT, NesT, PiT, RegionViT, ScalableViT,
        TwinsSVT, ViT,
    )
    from vit_tpu_torch.models import (
        ats_vit, cct, parallel_vit, vit_for_small_dataset, vit_with_patch_merger,
    )

    results = {}
    with clock("forward GEMMs"):
        gemms = forward_gemm_phase(torch, smi)
    log(f"forward GEMMs, ms by kernel at each shape (launch_forward_gemm: gemm_wgmma from n = "
        f"{FORWARD_GEMM_MIN_N}, linear.cu below) on {smi}: {json.dumps(gemms)}")
    with clock("block kernels, SPT"):
        kernel_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
        kernel_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
        kernel_phase(torch, "B/32-entry", 8, 65, 1024, 16, 64, 2048, results)
        # The objectives' blocks: 8 heads of 64 in 1024 (MAE's encoder, 16
        # visible tokens) and in 512 (its decoder, 64 tokens).
        for tag, n, d in (("MAE encoder", 16, 1024), ("MAE decoder", 64, 512)):
            kernel_phase(torch, tag, OBJECTIVE_BATCH, n, d, 8, 64, 2048, results)
        backward_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
        backward_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
        for tag, n, d in (("MAE encoder", 16, 1024), ("MAE decoder", 64, 512)):
            backward_phase(torch, tag, OBJECTIVE_BATCH, n, d, 8, 64, 2048, results)
        biased_phase(torch, 64, 257, 1024, 16, 64, 2048, results)
        spt_phase(torch, 64, 256, 16, 1024, smi)
    with clock("flash kernels"):
        flash_phase(torch, results, smi)
        below_gate_phase(torch, results, smi)
    with clock("T2T token transformer kernels"):
        t2t_kernel_phase(torch, results, smi)
    with clock("cross-attention block"):
        cross_attention_phase(torch, results, smi)
    with clock("packed flash"):
        packed_phase(torch, results, smi)
    with clock("Twins-SVT kernels"):
        twins_kernel_phase(torch, results, smi)
    with clock("CrossFormer kernels"):
        crossformer_kernel_phase(torch, results, smi)
    with clock("RegionViT kernels"):
        regionvit_kernel_phase(torch, results, smi)
    with clock("NesT kernels"):
        nest_kernel_phase(torch, results, smi)
    with clock("PiT kernels"):
        pit_kernel_phase(torch, results, smi)
        pit_conv_phase(torch, smi)
    with clock("LeViT and MobileViT convolutions"):
        plain_conv_phase(torch, smi)
    with clock("dense family kernels"):
        dense_kernel_phase(torch, results, smi)
    with clock("ATS-ViT kernels"):
        dense_kernel_phase(torch, results, smi, ATS_MLP_SHAPES)
    with clock("hybrid kernels"):
        hybrid_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results, smi)
    with clock("tensor-parallel kernels"):
        tp_kernel_phase(torch, results, smi)

    # The main paths, each with the counters from 0 just before it and read
    # just after.
    counters = counter_objects()

    def path(name, phase, *args, **kwargs):
        torch.cuda.empty_cache()
        with clock(name):
            by_path[name] = phase(torch, *args, **kwargs)

    small = vit_for_small_dataset.ViT
    by_path = {}
    # The explicit-use op: its public entry under autograd, then its checks.
    path("short attention", short_attention_phase, results, smi, counters)
    path("serving B/16", serving_phase, "ViT-B/16@224 bf16", ViT, B16, 64, 3, 0, smi, counters,
         per_layer(B16, "fused_attention_block", "fused_mlp", "short route, forward"))
    path("serving B/32", serving_phase, "ViT-B/32@256 bf16 (entry)", ViT, ENTRY, 8, 3, 1, smi,
         counters, per_layer(ENTRY, "fused_attention_block", "fused_mlp", "short route, forward"))
    path("serving small-dataset", serving_phase, "small-dataset ViT 256/16 bf16", small,
         SMALL_DATASET, 64, 3, 4, smi, counters,
         per_layer(SMALL_DATASET, "fused_attention_block_bias", "fused_mlp",
                   "short route, forward"),
         top1_sign_test=True)
    path("training B/32", training_phase, "ViT-B/32@256 (bench.py)", ViT, ENTRY, 128, 2, smi,
         counters, per_layer(ENTRY, "fused_attention_block", "fused_mlp",
                             "fused_attention_block_bwd", "fused_mlp_bwd", "short route",
                             "short route, forward"))
    # The short-sequence tier (fused_attention="hybrid") at bench.py's model.
    hybrid = per_layer(ENTRY, "ln_gemm", "attention_nb", "proj_mlp")
    path("serving B/32 hybrid", serving_phase, "ViT-B/32@256 hybrid bf16", hybrid_vit, ENTRY,
         128, 3, 1, smi, counters, hybrid)
    path("training B/32 hybrid", training_phase, "ViT-B/32@256 hybrid (bench.py)", hybrid_vit,
         ENTRY, 128, 2, smi, counters,
         {**hybrid, **per_layer(ENTRY, "ln_gemm_bwd", "attention_nb_bwd", "proj_mlp_bwd")})
    rows, tier = STEP_MS["ViT-B/32@256 (bench.py)"], STEP_MS["ViT-B/32@256 hybrid (bench.py)"]
    log(f"B/32 train step, batch 128, median ms: hybrid tier {tier['kernels']:.3f} against "
        f"rows 1-4 {rows['kernels']:.3f} (plain path {tier['plain']:.3f} and "
        f"{rows['plain']:.3f} in the two phases) on {smi}")
    path("training B/16", training_phase, "ViT-B/16@224", ViT, B16, 64, 3, smi, counters,
         per_layer(B16, "fused_attention_block", "fused_mlp", "fused_attention_block_bwd",
                   "fused_mlp_bwd", "short route", "short route, forward"))
    path("training small-dataset", training_phase, "small-dataset ViT 256/16", small,
         SMALL_DATASET, 64, 5, smi, counters,
         per_layer(SMALL_DATASET, "fused_attention_block_bias", "fused_mlp",
                   "fused_attention_block_bias_bwd", "fused_mlp_bwd", "short route",
                   "short route, forward"))
    with clock("gradients small-dataset"):
        gradient_phase(torch, "small-dataset ViT 256/16", small, SMALL_DATASET, 64, 6, smi)
    # CvT-13: flash at stage 1 (224 px; n_q 3136, n_k 784), stages 1 and 2 (384 px).
    cvt = dict(plain_kw=dict(use_flash="never"))
    for size, flash in ((224, 1), (384, 3)):
        path(f"serving CvT-13@{size}", serving_phase, f"CvT-13@{size} bf16", CvT, CVT13, 64, 3,
             7, smi, counters, {"flash_attention": flash}, size=size, **cvt)
        path(f"training CvT-13@{size}", training_phase, f"CvT-13@{size}", CvT, CVT13, 64, 8, smi,
             counters, {"flash_attention": flash, "flash_backward": flash}, size=size, **cvt)
    # ScalableViT: the cross-attention block in every SSA, the packed flash op
    # in every IWSA whose window holds 1024 tokens or more (stages 1 and 2),
    # two conv-MLPs per block.  Its plain path takes 1.0-1.7 s a step at
    # batch 64 (H100 80GB HBM3, 700 W), so its step is timed in 3 rounds of
    # one step after one of warm-up.
    blocks = sum(SCALABLE["depth"])
    windows = [SCALABLE_SIZE // 4 // 2 ** i if w is None else w
               for i, w in enumerate(SCALABLE["window_size"])]
    packed = sum(d for d, w in zip(SCALABLE["depth"], windows) if w * w >= 1024)
    scalable_forward = {"fused_cross_attention": blocks, "flash_attention_packed": packed,
                        "fused_mlp": 2 * blocks}
    path("serving ScalableViT", serving_phase, "ScalableViT@256 bf16", ScalableViT, SCALABLE,
         64, 3, 9, smi, counters, scalable_forward, size=SCALABLE_SIZE)
    one_kernel = sum(d for i, d in enumerate(SCALABLE["depth"]) if SCALABLE["dim"] << i <= 128)
    path("training ScalableViT", training_phase, "ScalableViT@256", ScalableViT, SCALABLE, 64,
         10, smi, counters,
         {**scalable_forward, "fused_cross_attention_bwd": blocks, "flash_backward": packed,
          "fused_mlp_bwd": 2 * blocks, "cross backward, one kernel": one_kernel,
          "cross backward, split": blocks - one_kernel}, size=SCALABLE_SIZE,
         timing=dict(rounds=3, calls=1, warmup=1))
    # The training objectives (BASELINE.md workload 5) on the objectives'
    # encoder: rows 1-4 at 16, 64, 65 and 66 tokens with 8 heads of 64 in 1024
    # (MAE's decoder: in 512); the distillation teacher's forward under
    # no_grad on the serving kernels, so rows 2 and 4 run for the student only.
    forward = ("fused_attention_block", "fused_mlp", "short route, forward")
    backward = ("fused_attention_block_bwd", "fused_mlp_bwd", "short route")

    def each(count, *names):
        return {name: count for name in names}

    layers = OBJ_ENCODER["depth"]
    objective = objectives(torch)
    path("training MAE", objective_phase, "MAE (decoder 512, depth 6)", objective["MAE"], 11,
         smi, counters, each(2 * layers, *forward, *backward))
    for seed, name in enumerate(("SimMIM", "MPP"), 12):
        path(f"training {name}", objective_phase, name, objective[name], seed, smi, counters,
             each(layers, *forward, *backward))
    path("training distillation", objective_phase, "DeiT distillation (soft, T 1, alpha 0.5)",
         objective["DeiT distillation"], 14, smi, counters,
         {**each(2 * layers, *forward), **each(layers, *backward)})
    # T2T-ViT@224: its first token transformer's attention on the (192, 192)
    # flash kernels (3136 tokens; the second one's 784 on the plain path, by
    # the 1024 gate), both token MLPs on the fused MLP at 147 and 1323, the
    # encoder's five blocks on rows 1-4 at 197 tokens (198 for the
    # distillable student).
    t2t = dict(plain_kw=dict(plain=True))
    t2t_forward = {"flash_attention": 1, "fused_mlp": 2 + T2T["depth"],
                   **each(T2T["depth"], "fused_attention_block", "short route, forward")}
    t2t_backward = {"flash_backward": 1, "fused_mlp_bwd": 2 + T2T["depth"],
                    **each(T2T["depth"], "fused_attention_block_bwd", "short route")}
    path("serving T2T", serving_phase, "T2T-ViT@224 bf16", t2t_vit, T2T, T2T_BATCH, 3, 15, smi,
         counters, t2t_forward, **t2t)
    path("training T2T", training_phase, "T2T-ViT@224", t2t_vit, T2T, T2T_BATCH, 16, smi,
         counters, {**t2t_forward, **t2t_backward}, **t2t)
    path("training T2T distillation", objective_phase,
         "T2T distillation (soft, T 1, alpha 0.5)", objective["T2T distillation"], 17, smi,
         counters, {**{name: 2 * count for name, count in t2t_forward.items()}, **t2t_backward})
    # Twins-SVT@224: the block over the folded 7 x 7 windows at every local
    # attention (stages 1-3), the cross-attention block at every global one
    # (stage 4's one key included; its backward split at every stage, past
    # heads·dh_k 256), the fused MLP at every conv-MLP.
    local, every = sum(TWINS_BLOCKS[:3]), sum(TWINS_BLOCKS)
    twins_forward = {"fused_mlp": local + every, "fused_cross_attention": every,
                     **each(local, "fused_attention_block", "short route, forward")}
    path("serving Twins-SVT", serving_phase, "Twins-SVT@224 bf16", TwinsSVT, TWINS, TWINS_BATCH,
         3, 18, smi, counters, twins_forward, top1_sign_test=True, size=TWINS_SIZE)
    path("training Twins-SVT", training_phase, "Twins-SVT@224", TwinsSVT, TWINS, TWINS_BATCH,
         19, smi, counters,
         {**twins_forward, "fused_mlp_bwd": local + every, "fused_cross_attention_bwd": every,
          "cross backward, split": every,
          **each(local, "fused_attention_block_bwd", "short route")}, size=TWINS_SIZE)
    # CrossFormer@224: the biased block over the folded windows at every short
    # attention and at the long ones of at least 8 tokens (stages 1-2), its
    # dbias at each in a step; the fused MLP at every MLP.
    cf_layers = sum(CROSSFORMER_DEPTH)
    biased = cf_layers + sum(d for d, w in zip(CROSSFORMER_DEPTH, CROSSFORMER_GLOBAL)
                             if w * w >= 8)
    crossformer_forward = {"fused_mlp": 2 * cf_layers,
                           **each(biased, "fused_attention_block_bias", "short route, forward")}
    path("serving CrossFormer", serving_phase, "CrossFormer@224 bf16", CrossFormer, CROSSFORMER,
         CROSSFORMER_BATCH, 3, 20, smi, counters, crossformer_forward, top1_sign_test=True,
         size=CROSSFORMER_SIZE)
    path("training CrossFormer", training_phase, "CrossFormer@224", CrossFormer, CROSSFORMER,
         CROSSFORMER_BATCH, 21, smi, counters,
         {**crossformer_forward, "fused_mlp_bwd": 2 * cf_layers,
          **each(biased, "fused_attention_block_bias_bwd", "short route")},
         size=CROSSFORMER_SIZE)
    with clock("gradients CrossFormer, attentions plain"):
        gradient_phase(torch, "CrossFormer@224, control: the MLPs on the kernels, the "
                       "attentions plain", crossformer_mlp_kernels, CROSSFORMER,
                       CROSSFORMER_BATCH, 21, smi, size=CROSSFORMER_SIZE)
    # RegionViT@224: in every layer the block at the region self-attention and
    # the biased block at the joint attention (per-head bias, dbias at each
    # in a step); its MLPs plain.
    rv_layers = sum(REGIONVIT_DEPTH)
    regionvit_forward = {"short route, forward": 2 * rv_layers,
                         **each(rv_layers, "fused_attention_block", "fused_attention_block_bias")}
    rv = dict(plain_kw=dict(fused_attention="never"), size=REGIONVIT_SIZE)
    path("serving RegionViT", serving_phase, "RegionViT@224 bf16", RegionViT, REGIONVIT,
         REGIONVIT_BATCH, 3, 22, smi, counters, regionvit_forward, top1_sign_test=True, **rv)
    path("training RegionViT", training_phase, "RegionViT@224", RegionViT, REGIONVIT,
         REGIONVIT_BATCH, 23, smi, counters,
         {**regionvit_forward, "short route": 2 * rv_layers,
          **each(rv_layers, "fused_attention_block_bwd", "fused_attention_block_bias_bwd")},
         **rv)
    # NesT@224: at every transformer layer the block over the folded 14 x 14
    # blocks (196 tokens: short_fwd's 208-key tile, short_bwd_wg at dh 32) and
    # the fused MLP over the loose conv pair.
    nest_layers = sum(NEST["block_repeats"])
    nest_forward = each(nest_layers, "fused_attention_block", "fused_mlp", "short route, forward")
    path("serving NesT", serving_phase, "NesT@224 bf16", NesT, NEST, NEST_BATCH, 3, 24, smi,
         counters, nest_forward, top1_sign_test=True)
    path("training NesT", training_phase, "NesT@224", NesT, NEST, NEST_BATCH, 25, smi, counters,
         {**nest_forward,
          **each(nest_layers, "fused_attention_block_bwd", "fused_mlp_bwd", "short route")})
    # PiT@224: rows 1-4 at every layer of its three stages; stage 1's 962
    # tokens on the block's mha route (the flash kernels), stages 2-3's 257 and
    # 65 on its short route.
    pit_layers, pit_long = sum(PIT["depth"]), PIT["depth"][0]
    pit_forward = {**each(pit_layers, "fused_attention_block", "fused_mlp"),
                   "mha route, forward": pit_long, "short route, forward": pit_layers - pit_long}
    path("serving PiT", serving_phase, "PiT@224 bf16", PiT, PIT, PIT_BATCH, 3, 26, smi, counters,
         pit_forward)
    path("training PiT", training_phase, "PiT@224", PiT, PIT, PIT_BATCH, 27, smi, counters,
         {**pit_forward, **each(pit_layers, "fused_attention_block_bwd", "fused_mlp_bwd"),
          "mha route": pit_long, "short route": pit_layers - pit_long})
    # LeViT@224 and MobileViT@256: vit_tpu runs no Pallas kernel in either, so
    # every counter stays at 0; each bf16 path is held against the f32 model.
    for name, build, cfg, size, batch, seed in (
            ("LeViT", LeViT, LEVIT, LEVIT_SIZE, LEVIT_BATCH, 28),
            ("MobileViT", MobileViT, MOBILEVIT, MOBILEVIT_SIZE, MOBILEVIT_BATCH, 30)):
        path(f"serving {name}", plain_serving_phase, f"{name}@{size} bf16", build, cfg, batch,
             3, size, seed, smi, counters)
        path(f"training {name}", plain_training_phase, f"{name}@{size}", build, cfg, batch, size,
             seed + 1, smi, counters)
    # The dense-token family.  DeepViT, the patch merger's ViT and CrossViT:
    # every MLP on rows 1-2 (CrossViT's in each branch's encoder, 2 + 3 a
    # round), every attention plain, as in vit_tpu, on both paths alike; so
    # the two paths' top-1s against f32 differ only by the MLPs' rounding,
    # and are held by the sign test.  CaiT and Parallel ViT: no kernel.
    crossvit_mlps = CROSSVIT["depth"] * (CROSSVIT["sm_enc_depth"] + CROSSVIT["lg_enc_depth"])
    for name, build, cfg, mlps, seed, plain_kw in (
            ("DeepViT", DeepViT, DEEPVIT, DEEPVIT["depth"], 32, dict(fused_mlp="never")),
            ("PatchMerger ViT", vit_with_patch_merger.ViT, PATCH_MERGER, PATCH_MERGER["depth"], 34,
             dict(fused_mlp="never")),
            ("CrossViT", cross_vit, CROSSVIT, crossvit_mlps, 36, dict(plain=True))):
        tag = f"{name}@{cfg['image_size']}"
        path(f"serving {name}", serving_phase, f"{tag} bf16", build, cfg, DENSE_BATCH, 3, seed,
             smi, counters, {"fused_mlp": mlps}, top1_sign_test=True, plain_kw=plain_kw)
        path(f"training {name}", training_phase, tag, build, cfg, DENSE_BATCH, seed + 1, smi,
             counters, {"fused_mlp": mlps, "fused_mlp_bwd": mlps}, plain_kw=plain_kw)
    for name, build, cfg, seed in (("CaiT", CaiT, CAIT, 38),
                                   ("Parallel ViT", parallel_vit.ViT, PARALLEL_VIT, 40)):
        size = cfg["image_size"]
        path(f"serving {name}", plain_serving_phase, f"{name}@{size} bf16", build, cfg,
             DENSE_BATCH, 3, size, seed, smi, counters)
        path(f"training {name}", plain_training_phase, f"{name}@{size}", build, cfg, DENSE_BATCH,
             size, seed + 1, smi, counters)
    # ATS-ViT@256: on the kernel path (fused_mlp="auto") every MLP on rows
    # 1-2, at 257, 129, 65, 33, 17 and 9 tokens, its attention plain; the
    # plain path is vit_tpu's default, fused_mlp="never", and launches
    # nothing.  Top-1 by the sign test: both paths share every attention.
    # CCT-14@224: no kernel, as in vit_tpu.
    ats_kw = dict(plain_kw=dict(fused_mlp="never"), inspect_models=ats_agreement)
    ats_mlps = ATS["depth"]
    path("serving ATS-ViT", serving_phase, "ATS-ViT@256 bf16", ats_kernels, ATS, DENSE_BATCH,
         3, 42, smi, counters, {"fused_mlp": ats_mlps}, top1_sign_test=True, **ats_kw)
    path("training ATS-ViT", training_phase, "ATS-ViT@256", ats_kernels, ATS, DENSE_BATCH, 43,
         smi, counters, {"fused_mlp": ats_mlps, "fused_mlp_bwd": ats_mlps}, **ats_kw)
    path("serving ATS-ViT plain", serving_phase, "ATS-ViT@256 bf16, vit_tpu's default",
         ats_vit.ViT, ATS, DENSE_BATCH, 1, 42, smi, counters, {}, top1_sign_test=True,
         plain_kw={}, inspect_models=ats_agreement)
    path("serving CCT", plain_serving_phase, "CCT-14@224 bf16", cct.CCT, CCT14, DENSE_BATCH, 3,
         CCT_SIZE, 44, smi, counters)
    path("training CCT", plain_training_phase, "CCT-14@224", cct.CCT, CCT14, DENSE_BATCH,
         CCT_SIZE, 45, smi, counters)
    # The blocks past 512 tokens: the mha route's path, then its kernels' checks.
    path("mha route", mha_route_phase, results, smi, counters)
    # The infrastructure: the data-parallel step (then checkpoint and resume),
    # the serving exports, the example trainer; scratch files under build/.
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    path("data-parallel B/32", data_parallel_phase, smi, counters, workdir)
    path("tensor-parallel", tp_path_phase, smi, workdir)
    path("export", export_phase, smi, counters)
    with clock("example trainer"):
        example_phase(torch, smi, workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    with clock("profiles"):
        # The LayerNorm-backward dgrad: rows 2 and 4 (or 5) of every ViT
        # layer, rows 12 and 14 on the hybrid tier, with no layernorm.cu
        # backward pass; ScalableViT's conv-MLPs at stages 3-4 (256 and 512
        # channels: d % 256 == 0), its narrower stages and its cross-attention
        # blocks on the passes; none at CvT's widths.
        two = 2 * ENTRY["depth"]
        profile_phase(torch, "ViT-B/32@256 (bench.py)", classifier_step(torch, ViT, ENTRY, 128),
                      128, 0, smi, ln_epilogues=two)
        profile_phase(torch, "ViT-B/32@256 hybrid (bench.py)",
                      classifier_step(torch, hybrid_vit, ENTRY, 128), 128, 0, smi,
                      ln_epilogues=two)
        profile_phase(torch, "ViT-B/16@224", classifier_step(torch, ViT, B16, 64), 64, 0, smi,
                      ln_epilogues=2 * B16["depth"])
        profile_phase(torch, "small-dataset ViT 256/16",
                      classifier_step(torch, small, SMALL_DATASET, 64), 64, 0, smi,
                      ln_epilogues=2 * SMALL_DATASET["depth"])
        for size in (224, 384):
            profile_phase(torch, f"CvT-13@{size}", classifier_step(torch, CvT, CVT13, 64, size),
                          64, 0, smi, ln_epilogues=0, ln_passes=True)
        wide = sum(2 * depth for i, depth in enumerate(SCALABLE["depth"])
                   if (SCALABLE["dim"] << i) % 256 == 0)
        profile_phase(torch, "ScalableViT@256",
                      classifier_step(torch, ScalableViT, SCALABLE, 64, SCALABLE_SIZE), 64, 0,
                      smi, ln_epilogues=wide, ln_passes=True)
        # Every block of the objectives is 1024 or 512 wide: each backward on
        # the LayerNorm-backward dgrad.
        for name, student_layers in (("MAE", 4 * layers), ("SimMIM", 2 * layers),
                                     ("MPP", 2 * layers), ("DeiT distillation", 2 * layers)):
            profile_phase(torch, name, objective_step(torch, objective[name]), OBJECTIVE_BATCH,
                          0, smi, ln_epilogues=student_layers)
        # T2T-ViT: its encoder's blocks (d 512) on the LayerNorm-backward
        # dgrad, its two token MLPs (147 and 1323) on the passes.
        profile_phase(torch, "T2T-ViT@224", classifier_step(torch, t2t_vit, T2T, T2T_BATCH),
                      T2T_BATCH, 0, smi, ln_epilogues=2 * T2T["depth"], ln_passes=2, top=12)
        # Twins-SVT: the LayerNorm-backward dgrad in each block and conv-MLP
        # backward at 256 (stage 3: local block, ff1, ff2) and 512 (stage 4:
        # ff2), their passes at 64 and 128 (stages 1-2); the global
        # attentions' ChannelLayerNorms run outside the kernels.
        profile_phase(torch, "Twins-SVT@224",
                      classifier_step(torch, TwinsSVT, TWINS, TWINS_BATCH, TWINS_SIZE),
                      TWINS_BATCH, 0, smi, ln_epilogues=3 * TWINS_BLOCKS[2] + TWINS_BLOCKS[3],
                      ln_passes=3 * (TWINS_BLOCKS[0] + TWINS_BLOCKS[1]), top=12)
        # CrossFormer: the LayerNorm-backward dgrad in each block and MLP
        # backward at 256 and 512 (stages 3-4: the short block and both MLPs
        # of a layer; the long attentions there run plain), the passes at 64
        # and 128 (stages 1-2: both blocks and both MLPs of a layer).
        narrow, wide = CROSSFORMER_DEPTH[:2], CROSSFORMER_DEPTH[2:]
        profile_phase(torch, "CrossFormer@224",
                      classifier_step(torch, CrossFormer, CROSSFORMER, CROSSFORMER_BATCH,
                                      CROSSFORMER_SIZE), CROSSFORMER_BATCH, 0, smi,
                      ln_epilogues=3 * sum(wide), ln_passes=4 * sum(narrow), top=12)
        # RegionViT: the LayerNorm-backward dgrad in both blocks of a layer at
        # 256 and 512 (stages 3-4), the passes at 64 and 128 (stages 1-2); its
        # MLPs' LayerNorms run outside the kernels.
        narrow, wide = REGIONVIT_DEPTH[:2], REGIONVIT_DEPTH[2:]
        profile_phase(torch, "RegionViT@224",
                      classifier_step(torch, RegionViT, REGIONVIT, REGIONVIT_BATCH,
                                      REGIONVIT_SIZE), REGIONVIT_BATCH, 0, smi,
                      ln_epilogues=2 * sum(wide), ln_passes=2 * sum(narrow), top=12)
        # NesT: every block and MLP backward on the passes (96, 192 and 384
        # channels); the aggregate and head norms run outside the kernels.
        profile_phase(torch, "NesT@224", classifier_step(torch, NesT, NEST, NEST_BATCH),
                      NEST_BATCH, 0, smi, ln_epilogues=0, ln_passes=2 * nest_layers, top=12)
        # PiT: every block and MLP backward on the LayerNorm-backward dgrad (256,
        # 512 and 1024 channels); the head norm runs outside the kernels.
        profile_phase(torch, "PiT@224", classifier_step(torch, PiT, PIT, PIT_BATCH), PIT_BATCH,
                      0, smi, ln_epilogues=2 * pit_layers, top=12)
        # LeViT and MobileViT: no kernel of the library at all.
        profile_phase(torch, "LeViT@224", classifier_step(torch, LeViT, LEVIT, LEVIT_BATCH,
                                                          LEVIT_SIZE), LEVIT_BATCH, 0, smi,
                      ln_epilogues=0, top=12)
        profile_phase(torch, "MobileViT@256",
                      classifier_step(torch, MobileViT, MOBILEVIT, MOBILEVIT_BATCH,
                                      MOBILEVIT_SIZE), MOBILEVIT_BATCH, 0, smi, ln_epilogues=0,
                      top=12)
        # The dense family: DeepViT's and the patch merger's MLP backwards (d
        # 1024) on the LayerNorm-backward dgrad, CrossViT's (192 and 384) on
        # the passes; their attentions' LayerNorms run outside the kernels;
        # CaiT and Parallel ViT launch none of the library's kernels.
        for name, build, cfg, epilogues, passes in (
                ("DeepViT@256", DeepViT, DEEPVIT, DEEPVIT["depth"], False),
                ("PatchMerger ViT@256", vit_with_patch_merger.ViT, PATCH_MERGER,
                 PATCH_MERGER["depth"], False),
                ("CrossViT@256", cross_vit, CROSSVIT, 0, crossvit_mlps),
                ("CaiT@256", CaiT, CAIT, 0, False),
                ("Parallel ViT@256", parallel_vit.ViT, PARALLEL_VIT, 0, False),
                ("ATS-ViT@256", ats_kernels, ATS, ats_mlps, False)):
            profile_phase(torch, name, classifier_step(torch, build, cfg, DENSE_BATCH),
                          DENSE_BATCH, 0, smi, ln_epilogues=epilogues, ln_passes=passes, top=12)
        # ATS-ViT's MLP backwards (d 1024) on the LayerNorm-backward dgrad, its
        # attentions' LayerNorms outside the kernels; CCT launches none.
        profile_phase(torch, "CCT-14@224", classifier_step(torch, cct.CCT, CCT14, DENSE_BATCH,
                                                           CCT_SIZE), DENSE_BATCH, 0, smi,
                      ln_epilogues=0, top=12)
    log(f"wall seconds by phase (build {build_s:.2f} before them): {json.dumps(WALL)}")

    # name: (source, the TPU kernel it replaces, the shape of its times)
    sources = {
        "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:147", "B/16"),
        "fused_attention_block": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                  "vit_tpu/ops/fused_attention_block.py:106", "B/16"),
        "fused_mlp_bwd": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:177",
                          "B/16"),
        "fused_attention_block_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                      "vit_tpu/ops/fused_attention_block.py:169", "B/16"),
        "fused_attention_block_bias": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                       "vit_tpu/ops/fused_attention_block.py:515", "lsa"),
        "fused_attention_block_bias_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                           "vit_tpu/ops/fused_attention_block.py:545", "lsa"),
        "flash_attention": ("vit_tpu_torch/csrc/flash_attention.cu",
                            "vit_tpu/ops/flash_attention.py:51, "
                            "vit_tpu/ops/flash_attention_v2.py:38", FLASH_SHAPES[0][0]),
        "flash_backward": ("vit_tpu_torch/csrc/flash_attention.cu",
                           "vit_tpu/ops/flash_backward.py:41, :72", FLASH_SHAPES[0][0]),
        "fused_cross_attention": ("vit_tpu_torch/csrc/fused_cross_attention.cu",
                                  "vit_tpu/ops/fused_cross_attention.py:71", SSA_SHAPES[0][0]),
        "fused_cross_attention_bwd": ("vit_tpu_torch/csrc/fused_cross_attention.cu",
                                      "vit_tpu/ops/fused_cross_attention.py:115",
                                      SSA_SHAPES[0][0]),
        "flash_attention_packed": ("vit_tpu_torch/csrc/flash_attention.cu",
                                   "vit_tpu/ops/flash_attention_packed.py:58",
                                   PACKED_SHAPES[0][0]),
        "short_attention": ("vit_tpu_torch/csrc/short_attention.cu",
                            "vit_tpu/ops/short_attention.py:82", SHORT_SHAPES[0][0]),
        "short_attention_bwd": ("vit_tpu_torch/csrc/short_attention.cu",
                                "vit_tpu/ops/short_attention.py:97", SHORT_SHAPES[0][0]),
        "ln_gemm": ("vit_tpu_torch/csrc/fused_hybrid.cu", "vit_tpu/ops/fused_hybrid.py:105",
                    "B/32"),
        "ln_gemm_bwd": ("vit_tpu_torch/csrc/fused_hybrid.cu", "vit_tpu/ops/fused_hybrid.py:125",
                        "B/32"),
        "attention_nb": ("vit_tpu_torch/csrc/short_attention.cu",
                         "vit_tpu/ops/fused_hybrid.py:317", "B/32"),
        "attention_nb_bwd": ("vit_tpu_torch/csrc/short_attention.cu",
                             "vit_tpu/ops/fused_hybrid.py:345", "B/32"),
        "proj_mlp": ("vit_tpu_torch/csrc/fused_hybrid.cu", "vit_tpu/ops/fused_hybrid.py:504",
                     "B/32"),
        "proj_mlp_bwd": ("vit_tpu_torch/csrc/fused_hybrid.cu",
                         "vit_tpu/ops/fused_hybrid.py:531", "B/32"),
    }
    launches = {name: sum(path[name] for path in by_path.values()) for name in counters}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: not launched on any main path")

    log("earlier designs' kernel ms, constants cited from PERF.md (not measured in this run): "
        + json.dumps(EARLIER_DESIGN_MS))
    log(json.dumps({"kernels": [kernel_entry(results, by_path, name, *where)
                                for name, where in sources.items()]
                    + tp_entries(results, by_path["tensor-parallel"])}))
    twins = {name: {tag: {k: v for k, v in r.items() if k in (
                 "kernel", "plain", "library", "modules", "device", "route")}
                 | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                 for tag, r in results[name].items() if tag.startswith("Twins") and "bound" in r}
             for name in ("fused_mlp", "fused_mlp_bwd", "fused_attention_block",
                          "fused_attention_block_bwd", "fused_cross_attention",
                          "fused_cross_attention_bwd")}
    log(f"Twins-SVT's kernels at its shapes (also under by_shape above), ms, on {smi}: "
        + json.dumps(twins))
    crossformer = {name: {tag.removeprefix("shared, "): {k: v for k, v in r.items() if k in (
                       "kernel", "unbiased", "plain", "library", "device", "dbias_err",
                       "dbias_vs_tpu_rel", "dbias_plain_gap_rel")}
                   | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                   for tag, r in results[name].items() if "CrossFormer" in tag}
                   for name in ("fused_attention_block_bias", "fused_attention_block_bias_bwd")}
    log(f"CrossFormer's row 5 at its windows (also under by_bias above), ms, on {smi}: "
        + json.dumps(crossformer))
    regionvit = {name: {tag.removeprefix("per-head, "): {k: v for k, v in r.items() if k in (
                     "kernel", "unbiased", "plain", "library", "modules", "device", "dbias_err",
                     "dbias_vs_tpu_rel", "dbias_plain_gap_rel")}
                 | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                 for tag, r in results[name].items() if "RegionViT" in tag and "bound" in r}
                 for name in ("fused_attention_block", "fused_attention_block_bwd",
                              "fused_attention_block_bias", "fused_attention_block_bias_bwd")}
    log(f"RegionViT's rows 3-5 at its attentions (also under by_shape and by_bias above), ms, "
        f"on {smi}: " + json.dumps(regionvit))
    nest = {name: {tag: {k: v for k, v in r.items() if k in (
                "kernel", "plain", "library", "modules", "device")}
            | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            for tag, r in results[name].items() if tag.startswith("NesT") and "bound" in r}
            for name in ("fused_mlp", "fused_mlp_bwd", "fused_attention_block",
                         "fused_attention_block_bwd")}
    instances = {name: ptxas.get(name, "not in this run's build log") for name in (
        "short_fwd_kernel<bf16,32,208>", "short_bwd_wg_kernel<bf16,32>")}
    log(f"NesT's rows 1-4 at its hierarchies (also under by_shape above), ms, on {smi}; its "
        f"dh-32 instances {json.dumps(instances)}: " + json.dumps(nest))
    pit = {name: {tag: {k: v for k, v in r.items() if k in (
               "kernel", "plain", "modules", "library", "sdpa", "whole", "library_whole",
               "sdpa_whole", "device")}
           | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
           for tag, r in results[name].items() if tag.startswith("PiT") and "bound" in r}
           for name in ("fused_mlp", "fused_mlp_bwd", "fused_attention_block",
                        "fused_attention_block_bwd")}
    dense = {name: {tag: {k: v for k, v in r.items() if k in (
                 "kernel", "plain", "modules", "library", "whole", "library_whole", "device")}
                 | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                 for tag, r in results[name].items()
                 if tag in [t for t, _, _ in DENSE_MLP_SHAPES] and "bound" in r}
             for name in ("fused_mlp", "fused_mlp_bwd")}
    log(f"the dense family's rows 1-2 at CrossViT's encoders and after the patch merger (also "
        f"under by_shape above), ms, on {smi}: " + json.dumps(dense))
    ats = {name: {tag: {k: v for k, v in r.items() if k in (
               "kernel", "plain", "modules", "library", "whole", "library_whole", "device")}
               | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
               for tag, r in results[name].items()
               if tag in [t for t, _, _ in ATS_MLP_SHAPES] and "bound" in r}
           for name in ("fused_mlp", "fused_mlp_bwd")}
    log(f"ATS-ViT's rows 1-2 at layer 2's 129 tokens and layer 6's 9 (also under by_shape "
        f"above), ms, on {smi}: " + json.dumps(ats))
    log(f"PiT's rows 1-4 at its stages (also under by_shape above; stage 1's block on the mha "
        f"route, sdpa: F.layer_norm + F.linear + SDPA + F.linear), ms, on {smi}: "
        + json.dumps(pit))
    mha_instances = {name: ptxas.get(name, "not in this run's build log")
                     for dh in (32, 64, 128) for bias in ("", ",bias") for name in (
                         f"flash_fwd_kernel<bf16,{dh},{dh}{bias}>",
                         f"flash_bwd_dq_kernel<bf16,{dh},{dh}{bias}>",
                         f"flash_bwd_dkv_kernel<bf16,{dh},{dh},3{bias}>")}
    row5 = {name: {tag: {k: v for k, v in r.items() if k in (
                "kernel", "unbiased", "plain", "library", "whole", "library_whole", "device",
                "dbias_err", "dbias_vs_tpu_rel")}
            | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            for tag, r in results[name].items() if "@384" in tag and "bound" in r}
            for name in ("fused_attention_block_bias", "fused_attention_block_bias_bwd")}
    log(f"the mha route (past 512 tokens, the flash kernels): row 5 at 577 tokens (also under "
        f"by_bias above), ms, on {smi}: {json.dumps(row5)}; its instances' registers and "
        f"spills: {json.dumps(mha_instances)}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
