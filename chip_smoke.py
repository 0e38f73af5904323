"""Drive the PyTorch port's inference paths, without GGS, with GGS from a
matches file, and with GGS from matches extracted from the images, DDIM,
the Co3D evaluation (test_torch.py), its training path and data-parallel
training, with the DINO ViT-S/16, DINOv2 ViT-S/14, DINO ViT-B/16,
ResNet-50 and ResNet-101 backbones, DINOv2 ViT-g/14's train step, and the
learnability experiment's model at its widths, once on an NVIDIA card.

    python3 chip_smoke.py             # from the repository root, one CUDA card
    python3 chip_smoke.py --profile   # also: torch.profiler over one GGS inference,
                                      # from a matches table and from the images
    python3 chip_smoke.py --parent DIR
        # also, first: the calls a serving or training user waits for (the
        # inferences without GGS, with GGS from a table and from the images,
        # the matcher, a DINO step in f32 and in the bf16 train mode, a
        # DINOv2 and a ViT-B train step) and the
        # redesigned kernels at their largest cases (SuperGlue's scores at
        # one matcher chunk, act_dropout_bwd at the ViT's fc1 beside
        # aten.gelu_backward, attention_bwd,
        # linear_wgrad at fc1 in both modes, linear's float32 products
        # beside torch.addmm /
        # torch.matmul, both GGS kernels' 200-iteration phases at 20 frames,
        # 100 and 1,024 matches a pair, layernorm_bwd beside F.layer_norm's
        # backward, with
        # its device time by kernel; the serving ViT's bf16 qkv and fc1
        # products, the extractor, ViT-B's trunk and the LayerNorm forward
        # at the serving and train shapes, with CUDA-graph times), each
        # timed in a child process with
        # this checkout's port and with DIR's
        # (the parent commit's posediffusion_tpu_torch/ and cfgs/, unpacked
        # with git archive into a gitignored directory; its kernels build
        # under DIR/build/kernels), in the order new, parent, parent, new
    python3 chip_smoke.py --parent DIR --rounds N
        # the same, that order repeated N times (host-bound calls spread
        # more from one process to the next than within one)
    python3 chip_smoke.py --attention   # the attention cases alone
    python3 chip_smoke.py --resnet      # the ResNet phases alone ([resnet], [viz],
                                        # [resnet-train], [dp])
    python3 chip_smoke.py --fsdp        # [fsdp], [train-336] and [dinov2-bf16]
                                        # alone
    python3 chip_smoke.py --learn       # [learn] alone
    python3 chip_smoke.py --vitg        # [vitg] alone
    python3 chip_smoke.py --wgrad       # bf16 mode's weight gradient and its
                                        # train step alone
    python3 chip_smoke.py --ptxas       # registers, spills and shared memory
                                        # of every kernel (nvcc -Xptxas -v), alone

Phases (any failure exits non-zero and prints no result line):
  1. build   the CUDA kernels from posediffusion_tpu_torch/csrc (one nvcc per
             source, in parallel);
  2. parity  each kernel against its plain PyTorch version at the paths'
             shapes: ViT-S/16 over 20 frames x 264 packed tokens (224px) and
             x 593 (336px); the sampler's 20 frames, 8 layers, 100 steps, its
             three fold-in entries (prologue, epilogue, step boundary) at 20
             and 3 rows, steps 0 and R - 2, four launches bitwise equal, its
             four 20-row products on the few-rows route of linear (with and
             without the folded LayerNorm, and bitwise against themselves);
             the denoiser trunk of the GGS steps; the GGS phases at 100 and 1,024
             matches per pair, then both GGS kernels at 6, 20 and 50 frames
             (100 and 1,024 a pair, the five phases' flags; equal bitwise,
             repeated launches bitwise, the cluster each took printed), a
             whole 5-phase cond_fn and the 10-step conditioned tail; f32 and
             default (bf16) mode; SuperGlue at 32
             pairs of 1,024 keypoints (products, key-mask attention self and
             cross, coupling, Sinkhorn, matches, the whole matcher);
  3. main    demo_torch's flow on samples/apple (20 frames, 224px, seeded
             random weights, GGS off): finite cameras and ARE, and every
             kernel of that path launched during it; a sampler step is 41
             launches (1 + 5 L: the layers and one boundary launch), an
             inference 1 prologue, 99 boundaries and 1 epilogue, and
             neither the sampler nor the GGS tail launches layernorm;
  4. ggs     demo_torch's flow with GGS on, from synthetic matches projected
             through samples/apple's ground-truth cameras: 20 frames at 100
             and at 1,024 matches per pair, and the first 6 frames at 100;
             finite cameras, every kernel of the GGS path launched, 50 GGS
             phases an inference, and one phase from the ground truth plus
             noise lowers the Sampson error;
  4b. match  demo_torch's flow with GGS on and matches extracted from the
             full-resolution images (SuperPoint, SuperGlue on the kernels,
             RANSAC; random MagicLeap weights written to a matcher directory):
             20 frames at 1,024 keypoints (190 pairs), and the first 6 frames
             at the default 4,096; finite cameras, matches reaching GGS, every
             kernel of the path launched;
  4c. ddim   DDIM at 10 of 100 steps (model.sample(sampling_timesteps=10)),
             each step on the denoiser trunk kernel: one step against the
             plain trunk tightly, 10 steps at eta 0 and 1 and with GGS by
             the chaos rule; the pred_x0 whole-loop sampler's entries at
             steps 0 and 98 and its 100-step chain against plain; the path
             driven at eta 0, eta 1 and with GGS at 100/pair (10 fused_trunk
             passes an inference, no sampler launch), its times; one DINO
             train step at pred_x0 / l2 on 64 images (loss finite,
             parameters moved);
  4d. eval   test_torch.main, the Co3D evaluation, twice on a Co3D-format
             tree of samples/apple (10 frames, 224px, GGS from the images
             with random MagicLeap weights): the results JSON finite with
             test.py's keys, every kernel of the path launched, a
             sequence's sampling and match times, and its match extraction
             split by stage (matcher weights, decode, SuperPoint,
             SuperGlue, RANSAC, GGS tables; PhaseTimer);
  5. train   the training slice (TPU kernels 9 and 10): the train kernels
             (attention_bwd, layernorm_bwd, linear_wgrad and dgrad,
             act_dropout_bwd, the dropout masks bitwise) against their plain
             versions at the ViT's and the denoiser's train shapes (the
             tensor-core attention_bwd and linear_wgrad in both modes, and
             bitwise against themselves: attention_bwd at 64 x 264 and
             2,880 x 16, linear_wgrad at fc1 and qkv, and bf16 mode's
             wgmma kernel at fc1, qkv, fc2 and the encoder's in_proj,
             timed beside torch.matmul),
             act_dropout_bwd at fc1 (GELU), the encoder's ReLU with its
             mff mask and its mask-only m2 site, layernorm_bwd, and
             linear's float32 dgrad of fc1 and qkv product beside
             torch.matmul and torch.addmm); both
             train trunks forward and backward (12 blocks x 64 images, f32
             and bf16; 8 layers x 2,880 x 16 with dropout 0.1, and the
             same with GELU for ReLU as a kink-free witness); one whole
             train step, kernel route against plain route; then
             train_torch.py at cfgs/default_train.yaml on a Co3D-format tree
             of samples/apple (2 epochs of 3 steps of 512 images,
             batch_repeat 90, one batched eval, checkpoints): finite losses,
             moved parameters, every kernel of the path launched; the
             train timings and peak memory; and one DINO step of the bf16
             train mode (both compute_dtypes bfloat16): finite loss, moved
             parameters, 80 linear_wgrad launches, its time and peak memory;
  5b. backbones  DINOv2 ViT-S/14 (LayerScale) and DINO ViT-B/16: linear
             with a gain and layerscale_bwd against their plain versions at
             DINOv2's 512 x 348 rows (dgamma bitwise across two runs),
             attention_bwd at 64 x 348 with DINOv2's packing bias; the
             LayerScale train trunk kernel against plain route (12 blocks x
             64 images, f32 and bf16); demo_torch with DINOv2 without GGS and
             with GGS from a matches table; train_torch.py with DINOv2 at
             the reference train config (4 steps, one eval, checkpoints; 24
             layerscale_bwd launches a step, every gain moved); the DINOv2
             step's time on both routes and its peak memory; ViT-B's
             fused_vit_trunk at 20 x 264 x 768, layernorm_bwd at 135,168 x
             768 and one train step at 512 images with its peak memory;
  5c. resnet ResNet-50 and ResNet-101 (cuDNN, float32 with TF32 off):
             demo_torch with ResNet-50 without GGS and with GGS from a
             100/pair table, ResNet-101, and ResNet-50 at
             compute_dtype=bfloat16 (finite cameras, the path's kernels
             launched and no ViT kernel), the sampler's three entries on
             ResNet-50's 2,048-wide features against plain, each
             inference's and extractor's time beside the convolutions'
             bound; [viz] the demo's cameras.html (and cameras.png where
             matplotlib is installed); [resnet-train] ResNet-50 train steps
             at 64 and 128 images (time, peak memory, every BatchNorm
             statistic moved); [dp] a data-parallel step over NCCL at world
             size 1 against the one-process step, and train_torch.run under
             torchrun's variables;
  5d. fsdp, 336px, DINOv2 bf16  [fsdp] a DINO model sharded by
             parallel/mesh.shard_model on a (1, 1) mesh over NCCL at world
             size 1 (torchrun's variables, as [dp]): one step of 64 images
             against the one-process step, every gradient present and every
             parameter moved, the train kernels launched, the eval on the
             sharded model equal to the gathered weights' sample, the whole
             checkpoint loaded strictly into one process (fsdp >= 2 is
             proven on the CPU only); [train-336] one DINO step at
             train.img_size=336 (593 packed tokens) at 512 images (or the
             largest of 384 and 256 that fits), its time, peak memory and
             ViT trunk forward and backward, beside the same four at 224px
             measured the same way; [dinov2-bf16] demo_torch with
             DINOv2 at compute_dtype=bfloat16 (kernels 2 and 5 launched, no
             kernel of the fused ViT trunk), its inference and extractor
             times beside the float32 route's;
  5e. learn  experiments/synthetic_learnability_torch.py's model and data
             (ViT D 192, 4 blocks, 17 tokens at 64px; denoiser D 256, 4
             layers; init_flax_weights), float32: the ViT and encoder train
             trunks, fused_vit_trunk, the sampler's three entries, a
             fused_trunk pass and a GGS phase on the chunked route (6
             frames, 5,985 exact matches) against their plain versions at
             these widths; the first 200 steps of the 10,000-step card run
             (its batches, schedule and draws), the loss's fall checked
             against that run's curve; one held-out sequence sampled with
             GGS (finite cameras, the launches of kernels 1, 2, 3, 5 and 7
             as predicted); each kernel at its [learn] width in the kernels
             line;
  5f. vitg   DINOv2 ViT-g/14 at the benchmark cell's step (96 images, 348
             tokens, D 1,536, 40 blocks): one train step's launches (the
             gated w12 products, swiglu_bwd and layerscale_bwd required,
             every weight gradient on linear_wgrad.by_route's tf32_wgmma),
             then the gated product, swiglu_bwd, layernorm_bwd,
             layerscale_bwd at D 1,536 and the float32 weight gradients of
             w12 and w3 against their plain versions at its 33,408 rows,
             each in the kernels line with its device time and bound (the
             weight gradients also beside torch.matmul with TF32 off and
             on, and their route);
  6. timing  CUDA-event medians of the inferences, the conditioned tail,
             the match extraction stages, and each kernel beside its plain
             version, its bound (bytes or operations over the H100's peaks)
             and a one-call PyTorch yardstick where one exists (the four
             20-row products also by device time, beside torch.matmul on a
             float32 copy of the weight; linear's bf16 route at the ViT's
             qkv beside torch.addmm on the same bf16 operands, and at the
             serving ViTs' twelve product shapes by CUDA graph; the
             LayerNorm forward at the train shapes beside F.layer_norm, by
             CUDA graph; sum_partials_kernel, the weight gradients' sum
             of partials, at fc1's f32 partials beside torch.sum, by CUDA
             graph with the partials in the L2 and from memory, and its
             launches a DINO step in both modes); a sampler step's device
             time (also from a child
             process, with its fold-ins' share) and the ViT trunk's
             CUDA-graph time against their wall times; every
             attention forward the port runs (SuperGlue self and cross, the
             ViT at 264 and 593 tokens, the denoiser, DINOv2, the train
             trunks) against its plain version and bitwise against itself,
             beside SDPA (float32, and bf16 operands for the bf16 cases).
Then one JSON line of the kernels, the card's name and power limit, and the
result line {"ok": true, "device": {...}}.

The card is required: without CUDA the script exits 2 before doing anything.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_TIMED = 10
IMAGE_SIZE = 224
MATCH_DENSITIES = (100, 1024)  # matches per pair: SuperGlue-like, 4096 keypoints
SUBSET_FRAMES = 6  # a short sequence: its table takes the one-block GGS kernel
DEMO_INFERENCES = 2  # demo_torch.run samples twice (the first call, then steady)

# max |kernel - plain| / max(1, max |plain|), per precision of the case
TOL_F32 = 1e-4  # float32 sums in another order
TOL_BF16 = 2.0**-7  # a summation-order flip of one bf16 rounding (2^-8 rel.)
TOL_VIT_F32 = 1e-4  # 12 blocks, float32 mode (absolute)
TOL_VIT_BF16 = 5e-2  # 12 blocks, bf16 mode: the JAX bf16-kernel tolerance
# Reverse-step chains (absolute). One step is pinned tightly. Over many
# steps the chain is chaotic at random weights (the harmonic embedding
# multiplies a state difference by up to 2^9 each step), so the bound is
# the larger of a floor and CHAOS_FACTOR times the spread that perturbing
# x0 by CHAOS_PERTURBATION causes in the plain chain itself, measured in
# the run. The perturbation, 2^-22, is one float32 ulp of a value in [2, 4)
# and the size of one kernel step's difference from the plain step.
TOL_STEPS = {1: 1e-5, 10: 1e-4, 100: 1e-2}
CHAOS_PERTURBATION = 2.0**-22
CHAOS_FACTOR = 10.0
# GGS (absolute, on the (N, 9) encodings). 30 momentum iterations: the JAX
# GGS kernel test's bound; the one-block and chunked kernels sum each pair
# in the same order, so they agree to 1e-5. The 700-iteration cond_fn and
# the conditioned tail use the chaos rule above (the momentum loop and the
# sampson < sampson_max cut turn an ulp into a flipped match), with floors.
TOL_GGS_30 = 5e-5
TOL_GGS_CHUNKED = 1e-5
# (frames, matches a pair) of the GGS kernels' parity grid, each at the five
# phases' update flags; and the frame counts at 100/pair (128 padded) whose
# 200-iteration phases time the route between the two kernels
GGS_GRID = ((6, 100), (6, 1024), (20, 100), (20, 1024), (50, 100), (50, 1024))
GGS_ROUTE_FRAMES = (3, 4, 5, 6, 8, 10, 20)
TOL_GGS_CONDFN = 1e-4
TOL_GGS_TAIL = 1e-3
GGS_PHASE = dict(lr=1e-2, momentum=0.9, alpha=1e-4, min_matches=10.0)
# SuperGlue: the coupling is held to TOL_F32 relative, Z (50 Sinkhorn
# iterations of float32 log-sum-exps in another order) to TOL_F32 absolute on
# the live cells. The kernel and plain routes' matches may differ only at
# rows whose plain Z holds a near-tie: a top-two margin (of the row, or of a
# column either route chose) under NEAR_TIE, ten times the bound on Z, since
# the whole 18-layer GNN in front of it also sums in another order.
NEAR_TIE = 1e-3

TRAIN_SITE = "posediffusion_tpu/ops/vit_train_kernel.py"
TRUNK_SITES = ("posediffusion_tpu/ops/vit_kernel.py:49 (_vit_block_kernel); "
               "posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math, "
               "in _sampler_kernel and fused_trunk :151); "
               f"{TRAIN_SITE}:800 (_fwd_call -> :832, _attn_residual / _mlp_residual)")
SUPERGLUE_SITE = "posediffusion_tpu/ops/superglue_kernel.py:285 (fused_match_pairs)"
TPU_KERNELS = {
    "layernorm": TRUNK_SITES,
    "linear": f"{TRUNK_SITES}; {SUPERGLUE_SITE}, its GNN and final products",
    "linear_rows": ("posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math: "
                    "_layer_norm + jnp.dot :55-57, :76, :80-81, :83) in "
                    "posediffusion_tpu/ops/sampler_kernel.py:141 (fused_sample_loop -> :362) "
                    "and posediffusion_tpu/ops/denoiser_kernel.py:151 (fused_trunk -> :176)"),
    "attention": (f"{TRUNK_SITES}; posediffusion_tpu/ops/attention.py:66 "
                  "(_pallas_attention, key mask) and :125 (_pallas_attention_bias); "
                  f"{SUPERGLUE_SITE}, its per-head attention"),
    "superglue_coupling": f"{SUPERGLUE_SITE}, final step :218-244 (scores, dustbin, marginals)",
    "superglue_sinkhorn": f"{SUPERGLUE_SITE}, final step :246-261 (log-domain Sinkhorn)",
    "superglue_matches": f"{SUPERGLUE_SITE}, final step :262-275 (mutual-max matches)",
    "sampler_prologue": "posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel, l == 0)",
    "sampler_epilogue": "posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel, l == L-1)",
    "sampler_boundary": ("posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel: step t's "
                         "l == L-1 :115-128, then step t+1's l == 0 :91-101)"),
    "ggs_phase": "posediffusion_tpu/ops/ggs_kernel.py:97 (ggs_phase_fused)",
    "ggs_phase_chunked": "posediffusion_tpu/ops/ggs_kernel.py:223 (ggs_phase_fused_chunked)",
    "attention_bwd": f"{TRAIN_SITE}:866 (_bwd_call -> :905), _attn_residual_bwd :356, "
                     "its head_bwd :400-431",
    "layernorm_bwd": f"{TRAIN_SITE}:866 (_bwd_call -> :905), _ln_bwd :265-275 with the "
                     "residual cotangent :353, :488",
    "linear_wgrad": f"{TRAIN_SITE}:866 (_bwd_call -> :905), the weight gradients of "
                    "_mlp_residual_bwd :278 and _attn_residual_bwd :356, partials summed :937-940",
    "act_dropout_bwd": f"{TRAIN_SITE}:866 (_bwd_call -> :905), _mlp_residual_bwd :330-340 "
                       "(dropout and activation backward) and the m1/m2 masks :314, :434",
    "layerscale_bwd": f"{TRAIN_SITE}:866 (_bwd_call -> :905), the LayerScale gradients "
                      ":316-319 and :436-456 (_LS_KEYS :85)",
    "swiglu_bwd": "none: the TPU kernels have no SwiGLU feed-forward (DINOv2 ViT-g/14's gate)",
}
SOURCES = {
    "layernorm": "posediffusion_tpu_torch/csrc/layernorm.cu",
    "linear": "posediffusion_tpu_torch/csrc/linear.cu",
    "linear_rows": "posediffusion_tpu_torch/csrc/linear.cu",
    "attention": "posediffusion_tpu_torch/csrc/attention.cu",
    "sampler_prologue": "posediffusion_tpu_torch/csrc/sampler.cu",
    "sampler_epilogue": "posediffusion_tpu_torch/csrc/sampler.cu",
    "sampler_boundary": "posediffusion_tpu_torch/csrc/sampler.cu",
    "ggs_phase": "posediffusion_tpu_torch/csrc/ggs.cu",
    "ggs_phase_chunked": "posediffusion_tpu_torch/csrc/ggs.cu",
    "superglue_coupling": "posediffusion_tpu_torch/csrc/superglue.cu",
    "superglue_sinkhorn": "posediffusion_tpu_torch/csrc/superglue.cu",
    "superglue_matches": "posediffusion_tpu_torch/csrc/superglue.cu",
    "attention_bwd": "posediffusion_tpu_torch/csrc/attention_bwd.cu",
    "layernorm_bwd": "posediffusion_tpu_torch/csrc/layernorm.cu",
    "linear_wgrad": "posediffusion_tpu_torch/csrc/linear.cu",
    "act_dropout_bwd": "posediffusion_tpu_torch/csrc/train.cu",
    "layerscale_bwd": "posediffusion_tpu_torch/csrc/train.cu",
    "swiglu_bwd": "posediffusion_tpu_torch/csrc/train.cu",
}
# The kernels around the sampler's products; the sampler's products take the
# few-rows route (linear_rows) up to 32 rows: the serving paths' 20 frames,
# not the in-training eval's batched sequences.
TRUNK_KERNELS = ("layernorm", "linear", "attention", "sampler_prologue", "sampler_epilogue",
                 "sampler_boundary")
SAMPLER_ENTRIES = ("sampler_prologue", "sampler_epilogue", "sampler_boundary")
NO_GGS_PATH = TRUNK_KERNELS + ("linear_rows",)
GGS_PATH = NO_GGS_PATH + ("ggs_phase", "ggs_phase_chunked")
SUPERGLUE_KERNELS = ("superglue_coupling", "superglue_sinkhorn", "superglue_matches")
MATCH_PATH = GGS_PATH + SUPERGLUE_KERNELS
TRAIN_KERNELS = ("attention_bwd", "layernorm_bwd", "linear_wgrad", "act_dropout_bwd")
# the kernels of linear's float32 tensor-core routes (kernels.linear_route):
# mma.sync, or TF32 wgmma after its split of W
LINEAR_F32_KERNELS = ("linear_tf32_kernel", "tf32_split_kernel", "linear_tf32_wgmma_kernel")
# the kernels of linear_wgrad's float32 routes (csrc/linear.cu): mma.sync and TF32 wgmma
WGRAD_F32_KERNELS = ("wgrad_tf32_kernel", "wgrad_tf32_wgmma_kernel")
# DDIM (sampling_timesteps 10 of 100) on samples/apple: the ViT, kernel 3 a
# step, and at t < DDIM_COND_START (its last step) the GGS phases
DDIM_STEPS = 10
DDIM_COND_START = 10
DDIM_PATH = ("layernorm", "linear", "attention", "linear_rows", "ggs_phase_chunked")
PRED_X0_IMAGES = 64  # the pred_x0 / l2 train step's cut batch (4 sequences of 16)
# test_torch.main on the Co3D tree of samples/apple: the ViT, the whole-loop
# sampler, the GGS tail and phases, and the matcher
EVAL_RUNS = 2
MATCH_SPLIT_ROUNDS = 3  # the eval sequence's match extraction timed by stage
EVAL_PATH = NO_GGS_PATH + SUPERGLUE_KERNELS
TRAIN_CU = "posediffusion_tpu_torch/csrc/train.cu"
SUM_PARTIALS_COLD = 4  # 4 x 26 MB of partials, more than the H100's 50 MB L2
# the in-training eval samples its batch of sequences through
# denoiser_train_apply, as the JAX package does: no sampler kernels
TRAIN_PATH = ("layernorm", "linear", "attention") + TRAIN_KERNELS
# The train path: train_torch.py at cfgs/default_train.yaml (512 images a step,
# 32 sequences x 16 frames at 224px, batch_repeat 90, dropout 0.1) on a
# Co3D-format tree of samples/apple.
TRAIN_OVERRIDES = ("train.category=apple", "train.min_num_images=20",
                   "train.images_per_seq=[16,17]", "train.frame_buckets=[16]",
                   "train.epochs=2", "train.len_train=3", "train.len_eval=1",
                   "train.eval_interval=1", "train.ckpt_interval=1")
# DINOv2 ViT-S/14 (LayerScale): serving and training at full width and depth;
# 257 + 65 + 26 = 348 packed tokens at 224px. DINO ViT-B/16 (D 768, 12 heads).
DINOV2 = "MODEL.IMAGE_FEATURE_EXTRACTOR.modelname=dinov2_vits14"
VITB = "MODEL.IMAGE_FEATURE_EXTRACTOR.modelname=dino_vitb16"
DINOV2_TRAIN_PATH = TRAIN_PATH + ("layerscale_bwd",)
# DINOv2 serves through its module blocks (attention on the kernel), so its
# serving path's LayerNorms and products are the sampler's, all folded
DINOV2_SERVE_PATH = ("linear_rows", "attention") + SAMPLER_ENTRIES
LS_PER_STEP = 24  # layerscale_bwd: 2 sites x 12 blocks (the encoder has no gains)
# DINOv2 ViT-g/14 (D 1,536, 40 blocks, 24 heads, SwiGLU hidden 4,096) at the
# benchmark cell dinov2g-train-f32's step: 96 images (6 sequences of 16) x
# 348 packed tokens = 33,408 trunk rows
VITG = "MODEL.IMAGE_FEATURE_EXTRACTOR.modelname=dinov2_vitg14"
VITG_IMAGES = 96
VITG_D, VITG_HIDDEN, VITG_DEPTH = 1536, 4096, 40
# a ViT-g step: the gated w12 product forward and recompute, swiglu_bwd, 2
# LayerScale sites a block, and the weight gradients of w12 and w3, one each
# a block
VITG_PER_STEP = {"gated": 2 * VITG_DEPTH, "swiglu_bwd": VITG_DEPTH,
                 "layerscale_bwd": 2 * VITG_DEPTH, "wgrad w12": VITG_DEPTH,
                 "wgrad w3": VITG_DEPTH}
# ResNet-50 and ResNet-101 (torchvision's Bottleneck ResNets on cuDNN, float32
# with TF32 off, or their bf16 convolutions): serving on the sampler, GGS and
# denoiser kernels with z 2,048 wide, the ViT kernels off the path; training
# through autograd, the denoiser on the encoder train trunk (kernels 9-10).
RESNET50 = "MODEL.IMAGE_FEATURE_EXTRACTOR.modelname=resnet50"
RESNET101 = "MODEL.IMAGE_FEATURE_EXTRACTOR.modelname=resnet101"
RESNET_BF16 = "MODEL.IMAGE_FEATURE_EXTRACTOR.compute_dtype=bfloat16"
RESNET_SERVE_PATH = ("linear_rows", "attention") + SAMPLER_ENTRIES
# cfgs/default_train.yaml's 512 images a step, cut: a float32 ResNet-50
# backward over 512 x 3 scales would hold ~70 GB of activations
RESNET_TRAIN_IMAGES = (64, 128)
TOL_DP = 1e-6  # the data-parallel step at world size 1 against one process
FSDP_IMAGES = 64  # [fsdp]'s cut step (4 sequences of 16): the path, not its scale
# [learn]: experiments/synthetic_learnability_torch.py at 64px; the first
# LEARN_STEPS steps of its LEARN_SCHEDULE-step card run (the same batches,
# schedule and draws), whose last 100 steps' mean loss must fall under
# LEARN_LOSS_MAX. That run (experiments/synthetic_learnability_torch.json,
# loss_mean_per_100; NVIDIA H100 80GB HBM3, 700 W) fell from 0.80375 over
# steps 0-99 to 0.79489 over steps 100-199 (its learning rate warms up
# from 1e-7: 2e-6 at step 200); the threshold is their midpoint, so the
# phase must show at least half that fall (a margin of 0.0044 above the
# run's own 0.79489, which the phase reproduced to the last digit). The GGS
# sample's unconditioned steps end at LEARN_GGS_START.
LEARN_IMG = 64
LEARN_STEPS = 200
LEARN_SCHEDULE = 10_000
LEARN_LOSS_MAX = (0.80375 + 0.79489) / 2
LEARN_GGS_START = 10
LEARN_GGS_ITERS = 100  # the timed GGS phase: the experiment's GGS.iter_num
# [train-336]: cfgs/default_train.yaml's 512 images at train.img_size=336,
# or the largest of the rest that fits
TRAIN336_IMAGES = (512, 384, 256)
DINOV2_BF16 = "MODEL.IMAGE_FEATURE_EXTRACTOR.compute_dtype=bfloat16"
# The LayerNorm forward at the train trunks' shapes (TPU kernel 9's forward):
# (rows, D, what); the serving ViT's 5,280 x 384 bf16 case is the layernorm
# entry of the kernels line
LN_TRAIN_CASES = ((512 * 264, 384, "DINO ViT-S/16 train"), (512 * 348, 384, "DINOv2 train"),
                  (512 * 264, 768, "ViT-B train"), (2880 * 16, 512, "encoder train"))
# (rows, D) -> (path, layernorm launches at that shape), from each path's run
LN_LAUNCHES = {}
# the serving ViTs' products on linear's bf16 wgmma route: (M, K, N) at 224px
# and 336px (ViT-S/16) and ViT-B/16 at 224px
BF16_PATH_SHAPES = tuple((m, k, n) for m in (20 * 264, 20 * 593)
                         for k, n in ((384, 1152), (384, 384), (384, 1536), (1536, 384))) + \
    tuple((20 * 264, k, n) for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)))
VIT_CHUNK = 64  # images in the ViT train-trunk parity cases
VIT_IMAGES = 512  # a train step's images (max_images)
ENC_ROWS = 2880  # the denoiser's rows: 32 sequences x batch_repeat 90
# The bf16 train mode (both compute_dtypes bfloat16): every weight gradient
# of a DINO step takes round_in, (12 ViT blocks + 8 encoder layers) x 4
# products on csrc/wgrad.cu's kernel; its cases (name, M, K, N): the ViT's
# fc1, qkv and fc2 at 512 images and the encoder's in_proj
BF16_TRAIN = ("MODEL.IMAGE_FEATURE_EXTRACTOR.compute_dtype=bfloat16",
              "MODEL.DENOISER.TRANSFORMER.compute_dtype=bfloat16")
WGRAD_PER_STEP = 80
WGRAD_SOURCE = "posediffusion_tpu_torch/csrc/wgrad.cu"
WGRAD_BF16_CASES = (("fc1", VIT_IMAGES * 264, 384, 1536), ("qkv", VIT_IMAGES * 264, 384, 1152),
                    ("fc2", VIT_IMAGES * 264, 1536, 384), ("enc in_proj", ENC_ROWS * 16, 512, 1536))
TOL_TRAIN_F32 = 1e-3  # a train trunk, float32: sums in another order, 12 blocks x 2
TOL_TRAIN_BF16 = 7e-2  # bf16 operands and residuals: the JAX bf16 train-kernel bound
# The encoder's ReLU: a float32 ulp that moves a pre-activation across 0
# flips that element's share of the gradients. At 46,080 rows x 8 layers a
# few hundred such flips each move a whole column of a weight gradient (and,
# through attention, the earlier layers) by up to ~1/sqrt(46,080) of its
# largest entry: measured on an H100, the largest relative error 6.6e-3,
# the mean 4.4e-5, 0.07% of elements beyond 1e-3. A wrong mask or half
# would move every element by O(0.1), so the guard is statistical, as the
# JAX package's own bf16 encoder test (tests/test_vit_train_kernel.py
# :360-367): the mean error (about 3x the 4.4e-5 measured), and the share
# of elements beyond ENCODER_GRAD_OUTLIER, both relative to max(1,
# |plain|). The witness of that cause: the same encoder case with GELU,
# which has no kink, is held to TOL_F32 in every element.
TOL_ENCODER_GRAD_MEAN = 1.5e-4
ENCODER_GRAD_OUTLIER = 1e-2
TOL_ENCODER_GRAD_SHARE = 1e-3
TOL_STEP_LOSS = 1e-4  # a whole train step, kernel route against plain route
TOL_STEP_NORM = 1e-3
TOL_STEP_CHANGE = 5e-2  # Adam's first step is ~lr sign(g): only near-zero g flip
# Roofline of one NVIDIA H100 SXM (published peak rates):
HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12  # dense TF32 tensor-core FLOP/s
GGS_FLOP_PER_MATCH = 120  # Sampson residual and its analytic gradient, per iteration


def bound(nbytes, flops, peak=PEAK_F32):
    """(least ms, what bounds it) for work that must move ``nbytes`` through
    HBM and do ``flops`` operations at ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


DEAD_BIAS = -1e8  # csrc/attention.cu kDeadBias: a key at or below it is masked


def attention_bound(qkv, attn_bias=None, key_bias=None, round_in=False):
    """Least ms of ``kernels.attention`` on (B, N, 3D) qkv, for the route the
    kernel takes: q.k^T and p.V (4 D operations per live (query, key) cell;
    a masked key adds exactly 0, and the kernel skips tiles of them) as bf16
    MMAs with ``round_in``, else as 3xTF32 MMAs (three TF32 products each)."""
    B, N, D3 = qkv.shape
    cells = B * N * N
    if attn_bias is not None:
        cells = B * int((attn_bias > DEAD_BIAS).sum())
    if key_bias is not None:
        cells = N * int((key_bias > DEAD_BIAS).sum())
    ops = 4 * cells * (D3 // 3)
    return bound(nbytes(qkv, attn_bias, key_bias) + B * N * D3 // 3 * 4,
                 ops if round_in else 3 * ops, PEAK_BF16 if round_in else PEAK_TF32)


def block_flops(tokens, N, D, F):
    """Operations of one pre-norm block over ``tokens`` rows of sequences of
    N: (products, attention) for the forward, where products are the four
    matrix products (qkv, out, two FF) and attention is q k^T and p v."""
    return 2 * tokens * D * (3 * D + D + 2 * F), 4 * tokens * N * D


def attention_bwd_bound(qkv, attn_bias=None, key_bias=None, round_in=False):
    """Least ms of ``kernels.attention_bwd`` on (B, N, 3D) qkv: the five
    products of the backward (q.k^T and do.v^T to recompute p and dp, then
    p_d^T do, ds k and ds^T q: 10 D operations per live (query, key) cell; a
    masked cell's p is exactly 0) as bf16 MMAs with ``round_in``, else as
    3xTF32 MMAs; qkv, dout and the bias read once, dqkv written once."""
    B, N, D3 = qkv.shape
    cells = B * N * N
    if attn_bias is not None:
        cells = B * int((attn_bias > DEAD_BIAS).sum())
    if key_bias is not None:
        cells = N * int((key_bias > DEAD_BIAS).sum())
    ops = 10 * cells * (D3 // 3)
    return bound(2 * nbytes(qkv) + nbytes(attn_bias, key_bias) + B * N * D3 // 3 * 4,
                 ops if round_in else 3 * ops, PEAK_BF16 if round_in else PEAK_TF32)


def linear_work(ops, w_bf16, round_a):
    """(operations, peak) of ``kernels.linear`` on more than 32 rows for the
    route it takes: bf16 MMAs for a bf16 W with round_a; else TF32 MMAs, three
    products each (3xTF32), two where the bf16 W or the rounded a is exact."""
    if w_bf16 and round_a:
        return ops, PEAK_BF16
    return (3 - int(bool(w_bf16)) - int(bool(round_a))) * ops, PEAK_TF32


def linear_bound(a, w, bias=None, residual=None, gain=None, round_a=False, trans_w=False):
    """Least ms of ``kernels.linear``: a, W, bias, gain and the residual read
    once, y written once; 2 M K N operations as ``linear_work`` counts them."""
    (M, K_), N = a.shape, w.shape[0] if trans_w else w.shape[1]
    return bound(nbytes(a, w, bias, residual, gain) + M * N * 4,
                 *linear_work(2 * M * K_ * N, w.element_size() == 2, round_a))  # bf16 W


def wgrad_bound(x, dy, round_in=False):
    """Least ms of ``kernels.linear_wgrad``: x and dy read once, dW and db
    written once; 2 M K N operations as bf16 MMAs with ``round_in``, else as
    3xTF32 MMAs (three TF32 products each)."""
    (M, K_), N = x.shape, dy.shape[1]
    ops = 2 * M * K_ * N
    return bound(nbytes(x, dy) + (K_ + 1) * N * 4, ops if round_in else 3 * ops,
                 PEAK_BF16 if round_in else PEAK_TF32)


def trunk_bounds(tokens, N, D, F, L, act_bytes, weight_bytes, saved=2):
    """Least ms of a float32 train trunk's forward (saving ``saved`` (tokens,
    D) arrays per layer: x and x1, and with LayerScale the two pre-gain
    outputs) and of its backward as the port does it: the recomputed qkv and
    first FF products, the dgrad of the four products, the four weight
    gradients and the attention products (forward q.k^T and p.V; backward
    dv, dp, dq, dk and the recomputed s), all on the tensor cores as 3xTF32
    MMAs (three TF32 products each)."""
    P, A = block_flops(tokens, N, D, F)
    tc = 3 / PEAK_TF32
    fwd_ops = L * (P + A) * tc
    bwd_ops = L * ((P + 2 * tokens * D * (3 * D + F)) * tc + P * tc + 2.5 * A * tc)
    x = tokens * D * act_bytes
    fwd = max((2 * x + saved * L * x + weight_bytes) / HBM_BYTES_PER_S, fwd_ops) * 1e3
    bwd = max((saved * L * x + 2 * x + 2 * weight_bytes) / HBM_BYTES_PER_S, bwd_ops) * 1e3
    return fwd, bwd
# Match extraction with random matcher weights: 1,024 keypoints per frame
# (the regime where the JAX package runs its fused SuperGlue kernel), then the
# default 4,096 on the first 6 frames; threshold 0 and an accept-all RANSAC
# so that random weights still pass matches through to GGS.
MATCH_KEYPOINTS = 1024
SG_PAIRS = 32  # pairs per matcher chunk (extract_match's pair_chunk)
RANSAC_ACCEPT_ALL = 1e6
MATCH_ARGS = ("GGS.match_threshold=0", f"GGS.ransac_threshold_px={RANSAC_ACCEPT_ALL}")


def synthetic_matches(folder, per_pair, seed, image_size=IMAGE_SIZE, frames=None):
    """(kp1, kp2, i12) of ``per_pair`` matches for every frame pair: seeded
    world points around the intersection of the ground-truth cameras'
    optical axes, projected through those cameras (``cameras_to_opencv``),
    keeping points in front of both cameras and inside the image."""
    from posediffusion_tpu_torch.data.camera_np import intersect_skew_lines, optical_axes
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, cameras_to_opencv

    gt = np.load(os.path.join(folder, "gt_cameras.npz"))
    R, T, fl = gt["gtR"], gt["gtT"], gt["gtFL"]
    if frames is not None:
        R, T, fl = R[:frames], T[:frames], fl[:frames]
    centers, dirs = optical_axes(R, T, fl, np.zeros_like(fl))
    target = intersect_skew_lines(centers, dirs)
    spread = 0.1 * np.linalg.norm(centers - target, axis=1).mean()
    X = target + np.random.default_rng(seed).normal(size=(4 * per_pair, 3)) * spread
    cam = PerspectiveCameras.create(R=R, T=T, focal_length=fl)
    R_cv, t_cv, K = (a.double().numpy() for a in cameras_to_opencv(cam, (image_size,) * 2))
    xc = np.einsum("nij,mj->nmi", R_cv, X) + t_cv[:, None]
    pix = np.einsum("nij,nmj->nmi", K, xc)
    uv = pix[..., :2] / pix[..., 2:]
    seen = (xc[..., 2] > 0) & (uv >= 0).all(-1) & (uv < image_size).all(-1)
    kp1, kp2, i12 = [], [], []
    for a in range(len(R)):
        for b in range(a + 1, len(R)):
            idx = np.flatnonzero(seen[a] & seen[b])[:per_pair]
            if len(idx) < per_pair:
                raise ValueError(f"pair ({a}, {b}) sees {len(idx)} < {per_pair} points")
            kp1.append(uv[a, idx])
            kp2.append(uv[b, idx])
            i12.append(np.repeat([[a, b]], per_pair, axis=0))
    return (np.concatenate(kp1).astype(np.float32), np.concatenate(kp2).astype(np.float32),
            np.concatenate(i12).astype(np.int64))


def write_matches(path, folder, per_pair, seed, frames=None):
    kp1, kp2, i12 = synthetic_matches(folder, per_pair, seed, frames=frames)
    np.savez(path, kp1=kp1, kp2=kp2, i12=i12)
    return path


def ggs_scene(torch, n, per_pair, seed, dev):
    """(x (n, 9), GroupedMatches) of a seeded scene longer than samples/apple
    can give: n cameras at ~4 units around the origin, looking at it,
    ``per_pair`` points near it projected into every pair, the encodings
    perturbed by 0.05."""
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, cameras_to_opencv
    from posediffusion_tpu_torch.geometry.pose_codec import camera_to_pose_encoding
    from posediffusion_tpu_torch.ops.ggs_grad import pack_matches_grouped

    r = np.random.default_rng(seed)
    Rs, Ts = [], []
    for c in r.normal(size=(n, 3)) * 0.8 + np.array([0, 0, -4.0]):
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], 1)
        Rs.append(R)
        Ts.append(-c @ R)
    cam = PerspectiveCameras.create(R=np.stack(Rs), T=np.stack(Ts),
                                    focal_length=np.full((n, 2), 2.0))
    R_cv, t_cv, Kp = (a.numpy().astype(np.float64)
                      for a in cameras_to_opencv(cam, (IMAGE_SIZE,) * 2))
    X = r.normal(size=(per_pair, 3)) * 0.3
    uv = np.einsum("nij,nmj->nmi", Kp, np.einsum("nij,mj->nmi", R_cv, X) + t_cv[:, None])
    uv = uv[..., :2] / uv[..., 2:]
    a_, b_ = np.triu_indices(n, k=1)
    kp1 = uv[a_].reshape(-1, 2).astype(np.float32)
    kp2 = uv[b_].reshape(-1, 2).astype(np.float32)
    i12 = np.repeat(np.stack([a_, b_], 1), per_pair, axis=0)
    gm = pack_matches_grouped(kp1, kp2, i12, n, device=dev)
    enc = camera_to_pose_encoding(cam).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return (enc + 0.05 * torch.randn(enc.shape, generator=g, device=dev)).contiguous(), gm


def ggs_grid(report, torch, dev):
    """The GGS kernels at GGS_GRID's sizes and the five phases' flags, 30
    iterations, against the plain phase (the one-block kernel where one
    block holds its pairs), the two kernels bitwise equal, repeated launches
    bitwise equal, the launched cluster printed. Returns each kernel's
    largest error."""
    from posediffusion_tpu_torch.diffusion.ggs import PHASES
    from posediffusion_tpu_torch.ops import ggs_kernel as GK
    from posediffusion_tpu_torch.ops import kernels as K

    worst = {"ggs_phase": 0.0, "ggs_phase_chunked": 0.0}
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    kw = dict(iters=30, **GGS_PHASE)
    for n, d in GGS_GRID:
        x, gm = ggs_scene(torch, n, d, SEED + n + d, dev)
        P, Q = gm.valid.shape
        one_block = K.ggs_smem_bytes(n, P, P, Q) <= K._MAX_SMEM
        for i, flags in enumerate(PHASES):
            tag = f"{n} frames, {d}/pair, phase {i} {flags}, 30 iterations"
            ref = GK.ggs_phase_fused_plain(x, gm, hw, *flags, 10.0, **kw)
            chk = GK.ggs_phase_fused_chunked(x, gm, hw, *flags, 10.0, **kw)
            err = (chk - ref).abs().max().item()
            worst["ggs_phase_chunked"] = max(worst["ggs_phase_chunked"], err)
            report.check(f"ggs_phase_chunked {tag}", err, TOL_GGS_30)
            if one_block:
                res = GK.ggs_phase_fused(x, gm, hw, *flags, 10.0, **kw)
                err = (res - ref).abs().max().item()
                worst["ggs_phase"] = max(worst["ggs_phase"], err)
                report.check(f"ggs_phase {tag}", err, TOL_GGS_30)
                report.require(f"ggs_phase_chunked equals ggs_phase bitwise ({tag})",
                               torch.equal(chk, res))
        again = GK.ggs_phase_fused_chunked(x, gm, hw, *PHASES[-1], 10.0, **kw)
        report.require(f"ggs_phase_chunked repeats bitwise ({n} frames, {d}/pair)",
                       torch.equal(again, chk))
        chunk = GK.default_chunk_pairs(gm)
        cluster = K.ggs_phase_chunked.cluster
        where = ("shared" if K.ggs_table_resident(n, chunk, chunk * cluster, Q)
                 else "global")
        print(f"  ggs_phase_chunked {n} frames x {d}/pair ({P} pairs x {Q}): a cluster of "
              f"{cluster} blocks (the card schedules {K.ggs_cluster_size(n, P, Q)}), {chunk} "
              f"pairs a block, table in {where} memory; ggs_phase "
              f"{'runs' if one_block else 'does not fit one block'}")
    return worst


def subset_folder(src, dst, frames):
    """The first ``frames`` images of ``src`` (sorted, as the loader reads
    them) and their ground-truth cameras, in ``dst``."""
    os.makedirs(dst, exist_ok=True)
    names = sorted(f for f in os.listdir(src) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    for name in names[:frames]:
        shutil.copy(os.path.join(src, name), dst)
    gt = np.load(os.path.join(src, "gt_cameras.npz"))
    np.savez(os.path.join(dst, "gt_cameras.npz"), **{k: v[:frames] for k, v in gt.items()})
    return dst


def write_co3d_tree(root, folder, category="apple", reduce=4):
    """A Co3D-format tree from a sample folder's frames and ground-truth
    cameras (the layout of tests/test_data.py's ``make_co3d_fixture``): the
    frames, downscaled by ``reduce`` (the loader crops and resizes to 224px
    anyway, and NDC intrinsics do not change with the scale), under
    ``<root>/data/<category>/seq0/``, and one annotation file per split,
    ``<root>/ann/<category>_{train,test}.jgz``, with the full-frame bbox.
    Returns (CO3D_DIR, CO3D_ANNOTATION_DIR)."""
    import gzip

    from PIL import Image

    img_dir, ann_dir = os.path.join(root, "data"), os.path.join(root, "ann")
    seq_dir = os.path.join(img_dir, category, "seq0")
    os.makedirs(seq_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    gt = np.load(os.path.join(folder, "gt_cameras.npz"))
    names = sorted(f for f in os.listdir(folder) if f.lower().endswith(".jpg"))
    frames = []
    for i, name in enumerate(names):
        img = Image.open(os.path.join(folder, name))
        img = img.reduce(reduce) if reduce > 1 else img
        img.save(os.path.join(seq_dir, name))
        frames.append({
            "filepath": f"{category}/seq0/{name}", "bbox": [0, 0, img.width, img.height],
            "R": gt["gtR"][i].tolist(), "T": gt["gtT"][i].tolist(),
            "focal_length": gt["gtFL"][i].tolist(), "principal_point": [0.0, 0.0],
        })
    for split in ("train", "test"):
        with gzip.open(os.path.join(ann_dir, f"{category}_{split}.jgz"), "wt") as f:
            f.write(json.dumps({"seq0": frames}))
    return img_dir, ann_dir


def random_superpoint_sd(seed):
    """A SuperPoint state dict in MagicLeap's layout, He-normal weights and
    zero biases from ``seed`` (torch's default init passes almost no signal
    through its 8 convolutions, so every keypoint would score ~1/65)."""
    import torch

    from posediffusion_tpu_torch.matching.superpoint import SuperPointNet

    r = np.random.default_rng(seed)
    sd = {}
    for k, v in SuperPointNet().state_dict().items():
        fan_in = int(np.prod(v.shape[1:])) if k.endswith("weight") else 0
        a = r.normal(size=v.shape) * np.sqrt(2 / fan_in) if fan_in else np.zeros(v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    return sd


def random_superglue_sd(seed, gnn_layers=9):
    """A SuperGlue state dict in MagicLeap's layout from ``seed``: kernel-1
    convs normal / sqrt(fan_in) x 0.5, zero biases, identity BatchNorms,
    bin_score 1 (the JAX package's tests/test_matching.random_superglue_sd)."""
    import torch

    r = np.random.default_rng(seed)
    sd = {}

    def conv(key, i, o):
        sd[f"{key}.weight"] = torch.tensor(r.normal(size=(o, i, 1)) / np.sqrt(i) * 0.5,
                                           dtype=torch.float32)
        sd[f"{key}.bias"] = torch.zeros(o)

    def bn(key, c):
        sd.update({f"{key}.weight": torch.ones(c), f"{key}.bias": torch.zeros(c),
                   f"{key}.running_mean": torch.zeros(c), f"{key}.running_var": torch.ones(c)})

    dims = [3, 32, 64, 128, 256, 256]
    for li, idx in enumerate([0, 3, 6, 9, 12]):
        conv(f"kenc.encoder.{idx}", dims[li], dims[li + 1])
        if li < 4:
            bn(f"kenc.encoder.{idx + 1}", dims[li + 1])
    for i in range(2 * gnn_layers):
        for p in range(3):
            conv(f"gnn.layers.{i}.attn.proj.{p}", 256, 256)
        conv(f"gnn.layers.{i}.attn.merge", 256, 256)
        conv(f"gnn.layers.{i}.mlp.0", 512, 512)
        bn(f"gnn.layers.{i}.mlp.1", 512)
        conv(f"gnn.layers.{i}.mlp.3", 512, 256)
    conv("final_proj", 256, 256)
    sd["bin_score"] = torch.tensor(1.0)
    return sd


def write_matcher_weights(folder, seed):
    """Random ``superpoint_v1.pth`` and ``superglue_outdoor.pth`` in
    ``folder``, for ``GGS.matcher_ckpt_dir``."""
    import torch

    os.makedirs(folder, exist_ok=True)
    torch.save(random_superpoint_sd(seed), os.path.join(folder, "superpoint_v1.pth"))
    torch.save(random_superglue_sd(seed + 1), os.path.join(folder, "superglue_outdoor.pth"))
    return folder


def match_mismatches(x, mask0, mask1, stacks, m_kernel, m_plain, iters=50):
    """Rows where the kernel route's matches differ from the plain route's,
    and the largest of their tie gaps in the plain route's Z: a row's gap is
    the smallest of its own top-two margin and the top-two margins of the
    columns either route chose. Returns (count, largest gap; 0 if none)."""
    import torch

    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.superglue_kernel import gnn_projections

    bad = (m_kernel != m_plain).nonzero().tolist()
    if not bad:
        return 0, 0.0
    f0, f1 = mask0.float().contiguous(), mask1.float().contiguous()
    m = gnn_projections(K.PLAIN, x, mask0, mask1, stacks)
    Z = K.superglue_sinkhorn_plain(*K.superglue_coupling_plain(m, f0, f1, stacks["bin"]), iters)
    Kk = f0.shape[1]
    live = (f0 > 0.5)[:, :, None] & (f1 > 0.5)[:, None, :]
    z = torch.where(live, Z[:, :Kk, :Kk], K.SG_DEAD)
    margin = lambda v: (lambda t: (t[0] - t[1]).item())(v.topk(2).values)
    worst = 0.0
    for c, i in bad:
        gap = margin(z[c, i])
        for j in {int(m_kernel[c, i]), int(m_plain[c, i])} - {-1}:
            gap = min(gap, margin(z[c, :, j]))
        worst = max(worst, gap)
    return len(bad), worst


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _nvcc_version():
    from posediffusion_tpu_torch.ops.kernels import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def ptxas_report():
    """Compile each csrc/*.cu with the library's flags and -Xptxas -v and
    print one line per kernel: registers, spills, shared memory."""
    import re

    from posediffusion_tpu_torch.ops.kernels import _CSRC, _NVCC_FLAGS, _nvcc

    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, src.stem + ".o"), str(src)]
                for src in sorted(_CSRC.glob("*.cu"))]
        procs = [subprocess.Popen(c, stderr=subprocess.PIPE, text=True) for c in cmds]
        outs = [(c[-1], p.communicate()[1], p.returncode) for c, p in zip(cmds, procs)]
    filt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")

    def demangle(sym):
        if not os.path.exists(filt):
            return sym
        return subprocess.run([filt, sym], capture_output=True, text=True).stdout.strip() or sym

    for src, err, rc in outs:
        if rc:
            raise SystemExit(f"nvcc failed on {src}:\n{err}")
        name = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = demangle(m.group(1))
                name = name[:name.rfind("(")] if name.endswith(")") else name  # no parameters
            elif name and "Used" in line:
                print(f"  {os.path.basename(src)} {name}: {line.split('info    :')[-1].strip()}")
            elif name and "spill" in line:
                print(f"  {os.path.basename(src)} {name}: {line.strip()}")
            elif "warning" in line.lower():
                print(f"  {os.path.basename(src)}: {line.strip()}")
    from posediffusion_tpu_torch.ops import kernels as K

    # dynamic: ptxas reports static shared memory only
    print(f"  linear.cu linear_bf16_wgmma_kernel: dynamic shared memory "
          f"{K.linear_bf16_smem_bytes()} B")
    print(f"  linear.cu linear_tf32_wgmma_kernel: dynamic shared memory "
          f"{K.linear_tf32_wgmma_smem_bytes()} B")
    return 0


def _time_ms(torch, fn, reps=N_TIMED, inner=1, warmup=2):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _graph_ms(torch, fn, calls=20, reps=5):
    """Device time per call of ``fn`` without the host's launch cost:
    ``calls`` calls captured in one CUDA graph (after two warm-up calls on
    a side stream), the graph's replays timed by CUDA events, the median of
    ``reps`` over ``calls``. The graph's kernels run back to back, about a
    microsecond apart. Used where torch.profiler's kernel time under-reads
    (PERF.md section 7)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = _time_ms(torch, graph.replay, reps=reps, warmup=1) / calls
    del graph
    return ms


def _kernel_device_ms(torch, fn, kernel="attention_kernel", calls=20):
    """Device time of ``kernel`` (a name, a tuple of names, or every kernel
    and copy when None) per call of ``fn``, from torch.profiler's CUDA
    activity: the kernels' own time, without the host's launch cost that
    CUDA events around a short call measure instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (names is None or any(n in e.key for n in names)))
    return us / 1e3 / calls


def _linear_f32_device(torch, K, fn):
    """{"device_ms", "linear_route"}: the device time of the kernels of
    linear's float32 routes per call of ``fn``, and the routes one call
    took (``linear.by_route``)."""
    K.linear.by_route.clear()
    fn()
    routes = dict(K.linear.by_route)
    return {"device_ms": _kernel_device_ms(torch, fn, LINEAR_F32_KERNELS), "linear_route": routes}


def _wgrad_f32_device(torch, K, x, dy):
    """The device time per call of linear_wgrad's float32 kernel on (x, dy)
    and of torch.matmul(x^T, dy) with allow_tf32 False and True (library
    yardsticks the port never calls), and the route one call took
    (``linear_wgrad.by_route``)."""
    fn = lambda: K.linear_wgrad(x, dy)  # noqa: E731
    K.linear_wgrad.by_route.clear()
    fn()
    route = dict(K.linear_wgrad.by_route)
    out = {"device_ms": _kernel_device_ms(torch, fn, WGRAD_F32_KERNELS), "wgrad_route": route}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out[f"library_device_ms_tf32_{'on' if tf32 else 'off'}"] = _kernel_device_ms(
            torch, lambda: torch.matmul(x.t(), dy), None)
    torch.backends.cuda.matmul.allow_tf32 = False
    return out


def _kernel_split_ms(torch, fn, calls=20):
    """{kernel or copy name: device ms per call of ``fn``} from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


# csrc/superglue.cu's kernels one by one: (their wrapper, launches per
# wrapper call). The match path runs Sinkhorn for matching/extract.py's
# default 50 iterations.
SG_SINKHORN_ITERS = 50
SG_SOURCE = "posediffusion_tpu_torch/csrc/superglue.cu"
SG_KERNELS = {
    "sg_marginals_kernel": ("superglue_coupling", 1),
    "sg_tiles_kernel": ("superglue_coupling", 1),
    "sg_scores_kernel": ("superglue_coupling", 1),
    "sg_sinkhorn_rows_kernel": ("superglue_sinkhorn", SG_SINKHORN_ITERS),
    "sg_sinkhorn_cols_kernel": ("superglue_sinkhorn", SG_SINKHORN_ITERS),
    "sg_assign_kernel": ("superglue_sinkhorn", 1),
    "sg_colarg_kernel": ("superglue_matches", 1),
    "sg_rowmatch_kernel": ("superglue_matches", 1),
}


def kernel_line(source, name):
    """The line of ``source`` (a path in the repository) where the CUDA
    kernel ``name`` is defined: its ``__global__`` line."""
    with open(os.path.join(REPO, source)) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if line.startswith(f"{name}("):
            return i if i and lines[i - 1].startswith("__global__") else i + 1
    raise ValueError(f"no kernel {name} in {source}")


def _device_ms_by_name(torch, fn, names, calls=5):
    """{name: device ms per call of ``fn``} summed over the kernels whose
    profiler key contains the name (one torch.profiler window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.key:
                    out[name] += e.self_device_time_total / 1e3 / calls
    return out


def sg_split(C, Kk, D):
    """--sg-split C K D (a child process of the main run, where torch.profiler
    under-reads): the device ms per wrapper call of each csrc/superglue.cu
    kernel on seeded inputs of one matcher chunk's shapes (masks keeping 60%
    to 100% of the keypoints, as the main run's), printed as the last line."""
    sys.path.insert(0, REPO)
    import torch

    from posediffusion_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = torch.randn((C, 2, Kk, D), generator=g, device=dev)
    keep = lambda: (torch.arange(Kk, device=dev)[None] < torch.randint(  # noqa: E731
        int(0.6 * Kk), Kk + 1, (C, 1), generator=g, device=dev)).float()
    f0, f1, b = keep(), keep(), torch.ones(1, device=dev)
    cpl = K.superglue_coupling(m, f0, f1, b)
    Z = K.superglue_sinkhorn(*cpl, SG_SINKHORN_ITERS)
    calls = {
        "superglue_coupling": lambda: K.superglue_coupling(m, f0, f1, b),
        "superglue_sinkhorn": lambda: K.superglue_sinkhorn(*cpl, SG_SINKHORN_ITERS),
        "superglue_matches": lambda: K.superglue_matches(Z, f0, f1, 0.0),
    }
    out = {}
    for wrapper, fn in calls.items():
        out.update(_device_ms_by_name(
            torch, fn, [k for k, (w, _) in SG_KERNELS.items() if w == wrapper]))
    print(json.dumps(out))
    return 0


def device_times():
    """--device-times (a child process of the main run, where torch.profiler
    under-reads): device ms per call, by kernel, of bf16 mode's weight
    gradient at WGRAD_BF16_CASES and of torch.matmul on the same rounded
    operands, and of csrc/sampler.cu's three entries (prologue, epilogue,
    step boundary) at the no-GGS path's inputs (seeded random weights, bf16
    stacks); printed as the last line, one JSON object."""
    sys.path.insert(0, REPO)
    import torch

    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.sampler_kernel import prepare_sampler
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    pin_full_float32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    out = {}
    for name, M, Kk, N in WGRAD_BF16_CASES:
        x = torch.randn((M, Kk), generator=gen, device=dev)
        dy = torch.randn((M, N), generator=gen, device=dev)
        xr, dyr = K.round_bf16(x), K.round_bf16(dy)
        out[f"linear_wgrad bf16 {name}"] = _device_ms_by_name(
            torch, lambda: K.linear_wgrad(x, dy, True),
            ["wgrad_bf16_wgmma_kernel", "sum_partials_kernel"])
        out[f"torch.matmul rounded f32 {name}"] = _kernel_device_ms(
            torch, lambda: torch.matmul(xr.t(), dyr), None)
        del x, dy, xr, dyr
        torch.cuda.empty_cache()
    model = PoseDiffusionModel(PoseDiffusionConfig())
    init_random_weights(model, SEED)
    model.to(dev)
    images = torch.as_tensor(load_and_preprocess_images(
        os.path.join(REPO, "samples", "apple"), IMAGE_SIZE)[0], device=dev)
    n = images.shape[0]
    with torch.no_grad():
        z = model.extract_features(images[None])
        x0 = torch.randn((1, n, 9), generator=gen, device=dev)
        noises = torch.randn((model.config.timesteps, 1, n, 9), generator=gen, device=dev)
        inp = prepare_sampler(model.diffuser.model, model.schedule, z,
                              weight_dtype=torch.bfloat16, x0=x0, noises=noises)
        for key, call in sampler_entry_calls(K, inp).items():
            out[key] = _kernel_device_ms(torch, call, "sampler_step_kernel", calls=20)
        # a whole sampler's device time a step, and its fold-ins' share
        from posediffusion_tpu_torch.ops.sampler_kernel import fused_sample_loop

        T = model.config.timesteps
        run = lambda: fused_sample_loop(model.diffuser.model, model.schedule, z,  # noqa: E731
                                        x0=x0, noises=noises)
        out["sampler step device (child process)"] = _kernel_device_ms(
            torch, run, None, calls=3) / T
        out["sampler_step_kernel a step inside the sampler (child process)"] = _kernel_device_ms(
            torch, run, "sampler_step_kernel", calls=3) / T
    print(json.dumps(out))
    return 0


def run_device_times():
    """``device_times`` in a child process; its JSON object."""
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--device-times"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise RuntimeError(f"--device-times exited {child.returncode}: {child.stderr[-2000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def wgrad_bf16_entries(report, torch, K, dev, by_shape, dev_ms):
    """bf16 mode's weight gradient (csrc/wgrad.cu) at WGRAD_BF16_CASES: dW
    and db against the plain version within TOL_F32 and repeated bitwise;
    then one kernels-line entry each: CUDA-event ms, the device ms from
    ``device_times`` (a child process), plain ms, torch.matmul on the same
    rounded operands in float32 (the same function: library_ms; timed only)
    and on bf16 copies (a bf16 result from half the bytes: a reference
    point), the bound (x and dy read once, dW and db written once; 2 M K N
    operations at the bf16 rate) and the launches at that shape in one bf16
    DINO train step (``by_shape``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    line = kernel_line(WGRAD_SOURCE, "wgrad_bf16_wgmma_kernel")
    entries = []
    for name, M, Kk, N in WGRAD_BF16_CASES:
        x = torch.randn((M, Kk), generator=gen, device=dev)
        dy = torch.randn((M, N), generator=gen, device=dev)
        tag = f"linear_wgrad bf16 {name} ({M}x{Kk})^T ({M}x{N})"
        dw, db = K.linear_wgrad(x, dy, True)
        pw, pb = K.linear_wgrad_plain(x, dy, True)
        err = max(_close_rel(report, f"{tag} dW", dw, pw, TOL_F32),
                  _close_rel(report, f"{tag} db", db, pb, TOL_F32))
        again = K.linear_wgrad(x, dy, True)
        report.require(f"{tag}: dW and db repeat bitwise",
                       torch.equal(dw, again[0]) and torch.equal(db, again[1]))
        del dw, db, pw, pb, again
        xr, dyr = K.round_bf16(x), K.round_bf16(dy)
        xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        bound_ms, bound_by = wgrad_bound(x, dy, round_in=True)
        split = dev_ms[f"linear_wgrad bf16 {name}"]
        e = {
            "name": f"linear_wgrad bf16 {name}", "route": "cuda",
            "source": f"{WGRAD_SOURCE}:{line}", "replaces": TPU_KERNELS["linear_wgrad"],
            "launches": by_shape.get((M, Kk, N), 0), "max_abs_err": err,
            "ms": _time_ms(torch, lambda: K.linear_wgrad(x, dy, True), reps=5),
            "plain_ms": _time_ms(torch, lambda: K.linear_wgrad_plain(x, dy, True), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(torch, lambda: torch.matmul(xr.t(), dyr), reps=5),
            "device_ms": split["wgrad_bf16_wgmma_kernel"],
            "sum_partials_device_ms": split["sum_partials_kernel"],
            "library_device_ms": dev_ms[f"torch.matmul rounded f32 {name}"],
            "bf16_matmul_ms": _time_ms(torch, lambda: torch.matmul(xb.t(), dyb), reps=5),
            "case": f"{tag} (launches: one bf16 DINO train step, this shape; library: "
                    f"torch.matmul on the rounded operands in float32; device: child process)",
        }
        print(f"  {tag}: kernel {e['ms']:.4f} ms (device {e['device_ms']:.4f}, "
              f"{100 * bound_ms / e['device_ms']:.1f}% of its bound; sum_partials "
              f"{e['sum_partials_device_ms']:.4f}), plain {e['plain_ms']:.4f}, torch.matmul "
              f"rounded f32 {e['library_ms']:.4f} (device {e['library_device_ms']:.4f}), bf16 "
              f"copies {e['bf16_matmul_ms']:.4f}, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{e['launches']} launches a bf16 step, max_abs_err {err:.3e}", flush=True)
        entries.append(e)
        del x, dy, xr, dyr, xb, dyb
        torch.cuda.empty_cache()
    return entries


def bf16_train_step(report, torch, K, dev, work, batch, draws):
    """The bf16 train mode's DINO step (BF16_TRAIN) on ``batch``: its loss
    finite, the parameters moved, every train kernel launched and
    linear_wgrad WGRAD_PER_STEP times; then its CUDA-event time and peak
    memory. Returns (timings, launches, linear_wgrad launches by shape)."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg

    cfg = _train_cfg(work, "train_bf16", *BF16_TRAIN)
    t = cfg.train
    model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    init_random_weights(model, SEED)
    model.to(dev)
    opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                            clip_grad=t.clip_grad)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = []
    step = lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws)  # noqa: E731
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    launches = _step_launches(K, lambda: out.append(step()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_shape = dict(K.linear_wgrad.by_shape)
    change = max((p.detach() - start[k]).abs().max().item() for k, p in model.named_parameters())
    report.require("bf16 train step: loss finite", bool(np.isfinite(out[0]["loss"])),
                   f"(loss {out[0]['loss']})")
    report.require("bf16 train step: parameters moved", change > 0, f"(largest {change:.3e})")
    _check_launches(report, "bf16 train step", TRAIN_PATH, launches)
    report.require(f"bf16 train step: {WGRAD_PER_STEP} linear_wgrad launches",
                   launches["linear_wgrad"] == WGRAD_PER_STEP, f"({launches['linear_wgrad']})")
    timings = {"DINO bf16 train step (512 images, batch_repeat 90)":
               _time_ms(torch, step, reps=3, warmup=1),
               "peak memory of a bf16 train step (GB)": peak_gb,
               "memory resident before the bf16 train step (GB)": resident_gb}
    print(f"  bf16 train step: loss {out[0]['loss']:.6f}, largest parameter change "
          f"{change:.3e}, {timings['DINO bf16 train step (512 images, batch_repeat 90)']:.3f} "
          f"ms, peak {peak_gb:.2f} GB ({resident_gb:.2f} resident before it), launches "
          f"{launches}, linear_wgrad by shape {by_shape}",
          flush=True)
    del model, opt, start
    torch.cuda.empty_cache()
    return timings, launches, by_shape


def superglue_kernel_entries(torch, K, m, f0, f1, bin_score, cpl, Z, launches, errs, tag):
    """One kernels-line entry per csrc/superglue.cu kernel on one matcher
    chunk: its device time per launch (torch.profiler in a child process,
    ``sg_split``), the plain PyTorch lines of the same step (the wrappers'
    plain versions, step by step), its bound, and for the scores one
    torch.baddbmm of the same product (timed only). The scores' bound counts
    the route they take: three TF32 products (3xTF32) of 2 D operations per
    live cell (both keypoints valid; the kernel skips tiles of masked ones).
    Launches: the match path's wrapper count times the kernel's launches per
    call; the error is its wrapper's."""
    C, _, Kk, D = m.shape
    K1 = Kk + 1
    cp, log_mu, log_nu, norm = cpl
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    v0, v1 = f0 > 0.5, f1 > 0.5
    live = v0[:, :, None] & v1[:, None, :]
    ma, mb = m[:, 0], m[:, 1]
    scores = torch.empty((C, Kk, Kk), device=m.device)
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--sg-split", str(C),
                            str(Kk), str(D)], capture_output=True, text=True, timeout=300)
    if child.returncode:
        raise RuntimeError(f"--sg-split exited {child.returncode}: {child.stderr[-2000:]}")
    dev_ms = json.loads(child.stdout.strip().splitlines()[-1])

    def marginals():
        out = torch.empty((C, K1, K1), device=m.device)
        out[:, :Kk, Kk] = torch.where(v0, bin_score, K.SG_NEG)
        out[:, Kk, :Kk] = torch.where(v1, bin_score, K.SG_NEG)
        ms_, ns_ = v0.sum(1).float(), v1.sum(1).float()
        nrm = -torch.log(ms_ + ns_)
        return (torch.cat([torch.where(v0, nrm[:, None], K.SG_NEG),
                           (torch.log(ns_) + nrm)[:, None]], 1),
                torch.cat([torch.where(v1, nrm[:, None], K.SG_NEG),
                           (torch.log(ms_) + nrm)[:, None]], 1))

    def rowmatch(colarg):
        z = torch.where(live, Z[:, :Kk, :Kk], K.SG_DEAD)
        rowmax, idx0 = z.amax(2), z.argmax(2)
        mutual = (colarg.gather(1, idx0) == torch.arange(Kk, device=m.device)) & live.gather(
            2, idx0[..., None])[..., 0]
        return torch.where(mutual, idx0, -1), torch.where(mutual, torch.exp(rowmax), 0.0)

    def tile_list():  # the scores' tiles, the live ones first
        n = -(-Kk // K.SG_TILE)
        pad = torch.zeros((C, n * K.SG_TILE), dtype=torch.bool, device=m.device)
        rows, cols = pad.clone(), pad
        rows[:, :Kk], cols[:, :Kk] = v0, v1
        tl = (rows.view(C, n, -1).any(2)[:, :, None] & cols.view(C, n, -1).any(2)[:, None, :])
        idx = torch.arange(tl.numel(), device=m.device)
        tl = tl.reshape(-1)
        return torch.cat([idx[tl], idx[~tl].flip(0), tl.sum()[None]])

    colarg = torch.where(live, Z[:, :Kk, :Kk], K.SG_DEAD).argmax(1)
    plain = {
        "sg_scores_kernel": lambda: torch.where(live, (ma @ mb.transpose(1, 2)) / D**0.5, K.SG_NEG),
        "sg_marginals_kernel": marginals,
        "sg_tiles_kernel": tile_list,
        "sg_sinkhorn_rows_kernel": lambda: log_mu - torch.logsumexp(cp + v[:, None, :], dim=2),
        "sg_sinkhorn_cols_kernel": lambda: log_nu - torch.logsumexp(cp + u[:, :, None], dim=1),
        "sg_assign_kernel": lambda: cp + u[:, :, None] + v[:, None, :] - norm[:, None, None],
        "sg_colarg_kernel": lambda: torch.where(live, Z[:, :Kk, :Kk], K.SG_DEAD).argmax(1),
        "sg_rowmatch_kernel": lambda: rowmatch(colarg),
    }
    cells, vec = C * K1 * K1 * 4, C * K1 * 4
    n_t = -(-Kk // K.SG_TILE)
    bounds = {
        "sg_tiles_kernel": bound(2 * C * n_t * 4 + (C * n_t * n_t + 1) * 4, C * n_t * n_t),
        "sg_scores_kernel": bound(nbytes(m, f0, f1) + C * Kk * Kk * 4,
                                  3 * 2 * int(live.sum()) * D, PEAK_TF32),
        "sg_marginals_kernel": bound(nbytes(f0, f1, bin_score) + 4 * vec + C * 4
                                     + 2 * C * n_t * 4, 2 * C * Kk),
        "sg_sinkhorn_rows_kernel": bound(cells + 3 * vec, 3 * C * K1 * K1),
        "sg_sinkhorn_cols_kernel": bound(cells + 3 * vec, 3 * C * K1 * K1),
        "sg_assign_kernel": bound(2 * cells + 2 * vec + C * 4, 3 * C * K1 * K1),
        "sg_colarg_kernel": bound(C * Kk * Kk * 4 + nbytes(f0, f1) + C * Kk * 4, C * Kk * Kk),
        "sg_rowmatch_kernel": bound(C * Kk * Kk * 4 + nbytes(f0, f1) + 3 * C * Kk * 4,
                                    C * Kk * Kk),
    }
    library = _time_ms(torch, lambda: torch.baddbmm(scores, ma, mb.transpose(1, 2), beta=0.0,
                                                    alpha=D**-0.5), reps=5)
    entries = []
    for name, (wrapper, per_call) in SG_KERNELS.items():
        e = {
            "name": name, "route": "cuda",
            "source": f"{SG_SOURCE}:{kernel_line(SG_SOURCE, name)}",
            "replaces": TPU_KERNELS[wrapper], "launches": launches[wrapper] * per_call,
            "max_abs_err": errs[wrapper], "ms": dev_ms[name] / per_call,
            "plain_ms": _time_ms(torch, plain[name], reps=5),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": library if name == "sg_scores_kernel" else None,
            "case": f"one launch in {wrapper} on one matcher chunk, {tag}; ms: the "
                    f"profiler's device time in a child process (launches: match path)",
        }
        print(f"  {name}: {e}")
        entries.append(e)
    return entries


def sampler_entry_args(K, inp, step=0, rows=None):
    """The arguments of csrc/sampler.cu's three entries at ``step`` on the
    sampler's inputs ``inp`` (prepare_sampler; its first ``rows`` rows when
    given), h the plain prologue's output, each with its own copy of the
    state x: {wrapper name: args}."""
    n = inp.x0.shape[0] if rows is None else rows
    x = inp.x0[:n].contiguous()
    wsin, wcos, wx, zf, tc = inp.prologue
    prologue = (wsin, wcos, wx, zf[:n].contiguous(), tc)
    head = (K.sampler_prologue_plain(x, *prologue, step), *inp.head, inp.coef,
            inp.noise[:, :n].contiguous())
    return {
        "sampler_prologue": (x.clone(), *prologue, step),
        "sampler_epilogue": (*head, x.clone(), step, inp.head_eps),
        "sampler_boundary": (*head, x.clone(), step, *prologue, inp.head_eps),
    }


def sampler_bound(key, args):
    """(least ms, what bounds it) of one sampler entry on ``args``
    (sampler_entry_args): each weight and input read once (tc's and the
    noise's rows of the step), h and x written once, x read once also in a
    boundary launch (its prologue takes the new x on chip); the products'
    FMAs at the float32 rate."""
    head = None if key == "sampler_prologue" else args[:9]
    x = args[0] if head is None else args[9]
    prologue = args[1:6] if head is None else args[11:16] if key == "sampler_boundary" else None
    rows, TD = x.shape
    moved, flops = nbytes(x) * (1 if head is None else 2), 0
    if head is not None:
        h, w0, b0, gh, bh, w1, b1 = head[:7]
        moved += nbytes(h, w0, b0, gh, bh, w1, b1) + rows * TD * 4
        flops += 2 * rows * (h.shape[1] * w0.shape[1] + w0.shape[1] * TD)
    if prologue is not None:
        wsin, wcos, wx, zf, tc = prologue
        D = wsin.shape[1]
        moved += nbytes(wsin, wcos, wx, zf) + D * 4 + rows * D * 4
        flops += 2 * rows * (2 * wsin.shape[0] + TD) * D
    return bound(moved, flops)


def sampler_entry_calls(K, inp):
    """{wrapper name: a call} of the three entries at step 0 (each call
    updates its own copy of x in place)."""
    return {key: (lambda f=getattr(K, key), a=args: f(*a))
            for key, args in sampler_entry_args(K, inp).items()}


def sampler_parity(report, torch, K, inp, mode, rows):
    """The three entries of csrc/sampler.cu against their plain versions at
    ``rows`` rows, steps 0 and R - 2: the output and the state x within
    TOL_F32, four launches bitwise equal. The boundary's next h is held to
    the plain prologue on the state the kernel wrote (the harmonic embedding
    multiplies a last-ulp difference of the state by up to 2^9). {wrapper
    name: (case name, args at step 0, max error)}."""
    out = {}
    for step in (0, inp.coef.shape[0] - 2):
        for key, args in sampler_entry_args(K, inp, step, rows).items():
            xi = 0 if key == "sampler_prologue" else 9  # where x sits in the arguments
            name = f"{key} {mode} ({rows} rows, step {step})"

            def run(fn):
                a = list(args)
                a[xi] = a[xi].clone()
                return fn(*a), a[xi]

            runs = [run(getattr(K, key)) for _ in range(4)]
            ref, x_ref = run(getattr(K, f"{key}_plain"))
            if key == "sampler_boundary":
                ref = K.sampler_prologue_plain(runs[0][1], *args[11:16], step + 1)
            torch.cuda.synchronize()
            err = max((runs[0][0] - ref).abs().max().item(),
                      (runs[0][1] - x_ref).abs().max().item())
            report.check(name, err, TOL_F32, max(1.0, ref.abs().max().item(),
                                                 x_ref.abs().max().item()))
            report.require(f"{name}: four launches bitwise equal",
                           all(torch.equal(o, runs[0][0]) and torch.equal(x, runs[0][1])
                               for o, x in runs[1:]))
            if step == 0:
                out[key] = (name, args, err)
    return out


def rows_products(lw, x, attn, hff):
    """The four products of one denoiser layer (weights ``lw`` in
    encoder_layer_math's order) as the sampler runs them at 20 rows: (name,
    linear args, linear kwargs) with the pre-norm LayerNorms folded in."""
    g1, b1, wqkv, bqkv, wout, bout, g2, b2, wl1, bl1, wl2, bl2 = lw
    return [
        ("in_proj", (x, wqkv, bqkv), dict(ln=(g1, b1, 1e-5))),
        ("out_proj", (attn, wout, bout), dict(residual=x)),
        ("linear1", (x, wl1, bl1), dict(act="relu", ln=(g2, b2, 1e-5))),
        ("linear2", (hff, wl2, bl2), dict(residual=x)),
    ]


def layer_product_calls(torch, K, lw, gen, dev):
    """The four products of one denoiser layer at 20 rows as ``K`` (a
    kernels module, this checkout's or a parent commit's) runs them inside
    ``encoder_layer_math``: LayerNorm folded into in_proj and linear1 where
    ``linear`` takes ``ln``, else a layernorm launch and then the product."""
    import inspect

    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    x, attn, hff = rnd(20, 512), rnd(20, 512), torch.relu(rnd(20, 1024))
    folds = "ln" in inspect.signature(K.linear).parameters
    calls = {}
    for name, args, kw in rows_products(lw, x, attn, hff):
        if "ln" in kw and not folds:
            ln, rest = kw["ln"], {k: v for k, v in kw.items() if k != "ln"}
            calls[name] = lambda a=args, ln=ln, kw=rest: K.linear(
                K.layernorm(a[0], *ln), *a[1:], **kw)
        else:
            calls[name] = lambda a=args, kw=kw: K.linear(*a, **kw)
    return calls


def timed_calls(root):
    """--timed-calls ROOT (a child process of --parent): time, with the port
    imported from ROOT (this checkout, or a directory holding a parent
    commit's posediffusion_tpu_torch/ and cfgs/), the calls that --parent
    compares, and print them as the last line, one JSON object."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import posediffusion_tpu_torch

    found = os.path.dirname(os.path.abspath(posediffusion_tpu_torch.__file__))
    if found != os.path.join(os.path.abspath(root), "posediffusion_tpu_torch"):
        raise SystemExit(f"the port came from {found}, not from {root}")
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.diffusion import ggs as G
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
    from posediffusion_tpu_torch.geometry.pose_codec import camera_to_pose_encoding
    from posediffusion_tpu_torch.matching import extract as X
    from posediffusion_tpu_torch.matching.superglue import encode_keypoints
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops import superglue_kernel as SGK
    from posediffusion_tpu_torch.ops.denoiser_kernel import layer_weights, stack_trunk_params
    from posediffusion_tpu_torch.ops.ggs_grad import ggs_tables, pack_matches_grouped
    from posediffusion_tpu_torch.ops.sampler_kernel import fused_sample_loop
    from posediffusion_tpu_torch.ops.vit_kernel import fused_vit_trunk, stack_vit_params
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    pin_full_float32()
    dev = torch.device("cuda")
    apple = os.path.join(REPO, "samples", "apple")
    work = os.path.join(REPO, "outputs", "chip_smoke", "timed_calls")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    K.load_library()
    print(f"  [{root}] kernels built in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    t = {}
    model = PoseDiffusionModel(PoseDiffusionConfig())
    init_random_weights(model, SEED)
    model.to(dev)
    den = model.diffuser.model
    imgs = torch.as_tensor(load_and_preprocess_images(apple, IMAGE_SIZE)[0], device=dev)[None]
    n = imgs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.randn((1, n, 9), generator=gen, device=dev)
    noises = torch.randn((model.config.timesteps, 1, n, 9), generator=gen, device=dev)
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    gm = pack_matches_grouped(*synthetic_matches(apple, 100, SEED + 100), n, device=dev)
    cond = G.make_ggs_cond_fn(None, hw, G.GGSConfig(), gm, K.KERNELS)
    with torch.no_grad():
        t["inference without GGS (20 frames)"] = _time_ms(
            torch, lambda: model.sample(imgs, x0=x0, noises=noises))
        t["GGS inference, 100/pair"] = _time_ms(
            torch, lambda: model.sample(imgs, x0=x0, noises=noises, cond_fn=cond,
                                        cond_start_step=10), reps=5)
        # both GGS kernels, one 200-iteration phase at 20 frames, as the
        # tree routes and chunks it (plan_ggs)
        gt = np.load(os.path.join(apple, "gt_cameras.npz"))
        x_g = (camera_to_pose_encoding(PerspectiveCameras.create(
            R=gt["gtR"], T=gt["gtT"], focal_length=gt["gtFL"], device=dev))
            + 0.05 * torch.randn((n, 9), generator=gen, device=dev)).contiguous()
        kw = dict(iters=200, **GGS_PHASE)
        for d in MATCH_DENSITIES:
            gmd = gm if d == 100 else pack_matches_grouped(
                *synthetic_matches(apple, d, SEED + d), n, device=dev)
            plan, tab1 = G.plan_ggs(gmd), ggs_tables(gmd)
            t[f"ggs_phase_chunked 200 iterations, 20 frames, {d}/pair"] = _time_ms(
                torch, lambda: K.ggs_phase_chunked(x_g, plan.tables, hw, True, True, True,
                                                   10.0, chunk=plan.chunk, **kw), reps=5)
            t[f"ggs_phase 200 iterations, 20 frames, {d}/pair"] = _time_ms(
                torch, lambda: K.ggs_phase(x_g, tab1, hw, True, True, True, 10.0, **kw),
                reps=5)
        z = model.extract_features(imgs)
        t["sampler (fused_sample_loop, 100 steps)"] = _time_ms(
            torch, lambda: fused_sample_loop(den, model.schedule, z, x0=x0, noises=noises))
        # a step's device time, and of it the fold-ins' (the parent's
        # prologue and epilogue kernels, this tree's one cluster kernel)
        T = model.config.timesteps
        run = lambda: fused_sample_loop(den, model.schedule, z, x0=x0,  # noqa: E731
                                        noises=noises)
        t["sampler step (device, profiler)"] = _kernel_device_ms(torch, run, None, calls=3) / T
        t["sampler fold-ins a step (device, profiler)"] = _kernel_device_ms(
            torch, run, "sampler_", calls=3) / T
        lw = layer_weights(stack_trunk_params(den._trunk))[0]
        for name, call in layer_product_calls(torch, K, lw, gen, dev).items():
            t[f"{name}, 20 rows (CUDA events)"] = _time_ms(torch, call, inner=10)
            t[f"{name}, 20 rows (device)"] = _kernel_device_ms(torch, call, None)
        # the extractor (fused_vit_trunk in bf16 mode) and its bf16 products
        # at 5,280 rows on linear's bf16 route
        t["extractor (model.extract_features, 20 frames, 224px)"] = _time_ms(
            torch, lambda: model.extract_features(imgs))
        st = stack_vit_params(model.image_feature_extractor._net, torch.bfloat16)
        hv = torch.randn((20 * 264, 384), generator=gen, device=dev)
        for pname, wk, bk, act in (("qkv", "wqkv", "bqkv", "none"), ("fc1 + GELU", "wfc1", "bfc1",
                                                                     "gelu")):
            call = lambda w=st[wk][0], b=st[bk][0], act=act: K.linear(  # noqa: E731
                hv, w, b, act=act, round_a=True)
            name = f"linear bf16 ViT {pname} (5280x384 @ 384x{st[wk].shape[2]})"
            t[f"{name} (CUDA events)"] = _time_ms(torch, call, inner=10)
            t[f"{name} (device)"] = _kernel_device_ms(torch, call, None)
            t[f"{name} (CUDA graph)"] = _graph_ms(torch, call)
    del model, den, z
    torch.cuda.empty_cache()
    # ViT-B/16's serving trunk (D 768, 12 heads) at 224px, bf16
    cfg_path = os.path.join(REPO, "cfgs", "default_train.yaml")
    vb_cfg = model_config_from_cfg(load_config(cfg_path, [VITB]).MODEL)
    vb = PoseDiffusionModel(vb_cfg)
    init_random_weights(vb, SEED)
    vb.to(dev)
    with torch.no_grad():
        vbn = vb.image_feature_extractor._net
        tokb, biasb, _ = _embed_pack_scales(vbn, imgs[0], vb_cfg.scale_factors)
        stb = stack_vit_params(vbn, torch.bfloat16)
        t["ViT-B vit trunk (fused_vit_trunk, bf16, 20x264x768)"] = _time_ms(
            torch, lambda: fused_vit_trunk(tokb, stb, 12, True, biasb))
    del vb, vbn, tokb, stb
    torch.cuda.empty_cache()
    # the LayerNorm forward: the serving ViT's bf16 case and the train shapes,
    # CUDA events and device time
    for rows, D, what in ((20 * 264, 384, "serving ViT-S, bf16"),) + LN_TRAIN_CASES:
        x = torch.randn((rows, D), generator=gen, device=dev)
        g, b = 1 + 0.1 * torch.randn(D, generator=gen, device=dev), torch.zeros(D, device=dev)
        call = lambda x=x, g=g, b=b, r=what.endswith("bf16"): K.layernorm(x, g, b, 1e-6, r)  # noqa: E731
        t[f"layernorm {what} ({rows}x{D}) (CUDA events)"] = _time_ms(torch, call, inner=10)
        t[f"layernorm {what} ({rows}x{D}) (device)"] = _kernel_device_ms(torch, call, "layernorm")
        t[f"layernorm {what} ({rows}x{D}) (CUDA graph)"] = _graph_ms(torch, call, calls=10)
        del x

    # the train backward's two redesigned kernels at their largest cases:
    # fc1's weight gradient and the ViT's attention backward, float32
    M, Dv, Nv = VIT_IMAGES * 264, 384, 264
    x_fc = torch.randn((M, Dv), generator=gen, device=dev)
    dy_fc = torch.randn((M, 4 * Dv), generator=gen, device=dev)
    t[f"linear_wgrad fc1 f32 ({M}x{Dv})^T ({M}x{4 * Dv})"] = _time_ms(
        torch, lambda: K.linear_wgrad(x_fc, dy_fc), reps=5)
    # and in bf16 mode (the bf16 train mode's weight gradient), by events and
    # by the device time of all the call's kernels
    call = lambda: K.linear_wgrad(x_fc, dy_fc, True)  # noqa: E731
    t[f"linear_wgrad fc1 bf16 ({M}x{Dv})^T ({M}x{4 * Dv})"] = _time_ms(torch, call, reps=5)
    t[f"linear_wgrad fc1 bf16 ({M}x{Dv})^T ({M}x{4 * Dv}) (device)"] = _kernel_device_ms(
        torch, call, None)
    del x_fc, dy_fc
    seg = torch.tensor([0] * 197 + [1] * 50 + [2] * 17, device=dev)
    vbias = torch.where(seg[:, None] == seg[None], 0.0, K.NEG).contiguous()
    qkv = torch.randn((VIT_CHUNK, Nv, 3 * Dv), generator=gen, device=dev)
    dout = torch.randn((VIT_CHUNK, Nv, Dv), generator=gen, device=dev)
    t[f"attention_bwd vit f32 ({VIT_CHUNK}x{Nv}, 6 heads, packing bias)"] = _time_ms(
        torch, lambda: K.attention_bwd(qkv, dout, 6, attn_bias=vbias), reps=5)
    del qkv, dout
    torch.cuda.empty_cache()
    # the SuperGlue scores at one matcher chunk (masks keeping 60-100% of
    # the keypoints), and act_dropout_bwd at the ViT's fc1 beside
    # aten.gelu_backward
    Cs, Ks = SG_PAIRS, MATCH_KEYPOINTS
    m_s = torch.randn((Cs, 2, Ks, 256), generator=gen, device=dev)
    keep = lambda: (torch.arange(Ks, device=dev)[None] < torch.randint(  # noqa: E731
        int(0.6 * Ks), Ks + 1, (Cs, 1), generator=gen, device=dev)).float()
    f0s, f1s, b_s = keep(), keep(), torch.ones(1, device=dev)
    call = lambda: K.superglue_coupling(m_s, f0s, f1s, b_s)  # noqa: E731
    t[f"superglue_coupling ({Cs} pairs, K {Ks}, D 256)"] = _time_ms(torch, call, reps=5, inner=5)
    t[f"sg_scores_kernel ({Cs} pairs, K {Ks}, D 256) (device)"] = _kernel_device_ms(
        torch, call, "sg_scores_kernel")
    del m_s
    dh_a, a_a = (torch.randn((M, 4 * Dv), generator=gen, device=dev) for _ in range(2))
    act = lambda: K.act_dropout_bwd(dh_a, a_a, "gelu")  # noqa: E731
    gelu = lambda: torch.ops.aten.gelu_backward(dh_a, a_a)  # noqa: E731
    t[f"act_dropout_bwd vit fc1 gelu ({M}x{4 * Dv})"] = _time_ms(torch, act, reps=5, inner=5)
    t[f"aten.gelu_backward ({M}x{4 * Dv})"] = _time_ms(torch, gelu, reps=5, inner=5)
    t[f"act_dropout_bwd vit fc1 gelu ({M}x{4 * Dv}) (device)"] = _kernel_device_ms(
        torch, act, "act_dropout_bwd_kernel")
    t[f"aten.gelu_backward ({M}x{4 * Dv}) (device)"] = _kernel_device_ms(torch, gelu, None)
    del dh_a, a_a
    torch.cuda.empty_cache()

    # the f32 products of linear at the train and match paths' largest cases,
    # beside one torch.addmm / torch.matmul where one computes the same
    import torch.nn.functional as F

    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    Mv, Md = VIT_IMAGES * Nv, VIT_IMAGES * 348
    hm, res2 = rnd(Md, 4 * Dv), rnd(Md, Dv)
    w2, b2, gain = rnd(4 * Dv, Dv) / (4 * Dv) ** 0.5, rnd(Dv), 1 + 0.1 * rnd(Dv)
    t[f"linear f32 DINOv2 fc2 + gain + residual ({Md}x{4 * Dv} @ {4 * Dv}x{Dv})"] = _time_ms(
        torch, lambda: K.linear(hm, w2, b2, residual=res2, gain=gain), reps=5)
    del hm, res2
    cat, w1, b1 = rnd(65536, 512), rnd(512, 512) / 512**0.5, rnd(512)
    t["linear f32 SuperGlue w1 + ReLU (65536x512 @ 512x512)"] = _time_ms(
        torch, lambda: K.linear(cat, w1, b1, act="relu"), reps=5)
    hs, ws, bs = rnd(65536, 256), rnd(256, 768) / 16, rnd(768)
    t["linear f32 SuperGlue qkv (65536x256 @ 256x768)"] = _time_ms(
        torch, lambda: K.linear(hs, ws, bs), reps=5)
    t["torch.addmm SuperGlue qkv"] = _time_ms(torch, lambda: torch.addmm(bs, hs, ws), reps=5)
    del cat, hs
    h, wq, bq = rnd(Mv, Dv), rnd(Dv, 3 * Dv) / Dv**0.5, rnd(3 * Dv)
    t[f"linear f32 ViT qkv ({Mv}x{Dv} @ {Dv}x{3 * Dv})"] = _time_ms(
        torch, lambda: K.linear(h, wq, bq), reps=5)
    t["torch.addmm ViT qkv"] = _time_ms(torch, lambda: torch.addmm(bq, h, wq), reps=5)
    dy, w1t = rnd(Mv, 4 * Dv), rnd(Dv, 4 * Dv) / Dv**0.5
    t[f"linear f32 dgrad fc1 ({Mv}x{4 * Dv} @ ({Dv}x{4 * Dv})^T)"] = _time_ms(
        torch, lambda: K.linear(dy, w1t, None, trans_w=True), reps=5)
    t["torch.matmul dgrad fc1"] = _time_ms(torch, lambda: torch.matmul(dy, w1t.t()), reps=5)
    del h, dy
    # layernorm_bwd at ViT-S's and ViT-B's widths, beside F.layer_norm's
    # backward (which reads no residual), and its device time by kernel
    split = {}
    for D in (Dv, 2 * Dv):
        x, dh, res = rnd(Mv, D), rnd(Mv, D), rnd(Mv, D)
        g = 1 + 0.1 * rnd(D)
        call = lambda: K.layernorm_bwd(x, g, dh, 1e-6, residual=res)  # noqa: E731
        t[f"layernorm_bwd ({Mv}x{D}, + residual)"] = _time_ms(torch, call, reps=5)
        xs, gs = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        y = F.layer_norm(xs, (D,), gs, torch.zeros(D, device=dev), 1e-6)
        t[f"F.layer_norm backward ({Mv}x{D})"] = _time_ms(
            torch, lambda: torch.autograd.grad(y, [xs, gs], dh, retain_graph=True), reps=5)
        split[f"layernorm_bwd ({Mv}x{D}, + residual)"] = _kernel_split_ms(torch, call)
        del x, dh, res, xs, gs, y
    torch.cuda.empty_cache()

    # one DINO train step at the reference train config (512 images)
    cfg = _train_cfg(work, "train", cfg=cfg_path)
    tm = PoseDiffusionModel(model_config_from_cfg(load_config(cfg_path).MODEL))
    init_random_weights(tm, SEED)
    tm.to(dev)
    batch, draws, _ = _train_batch(cfg, dev, tm.config.timesteps)
    tr = cfg.train
    opt, _ = make_optimizer(tm, lr=tr.lr, T_0=tr.restart_num, iters_per_epoch=tr.len_train,
                            clip_grad=tr.clip_grad)
    t["DINO train step (512 images, batch_repeat 90)"] = _time_ms(
        torch, lambda: train_step(tm, opt, batch, tr.batch_repeat, draws=draws), reps=3, warmup=1)
    del tm, opt
    torch.cuda.empty_cache()
    # the same in the bf16 train mode (both compute_dtypes bfloat16)
    tm = PoseDiffusionModel(model_config_from_cfg(load_config(cfg_path, list(BF16_TRAIN)).MODEL))
    init_random_weights(tm, SEED)
    tm.to(dev)
    opt, _ = make_optimizer(tm, lr=tr.lr, T_0=tr.restart_num, iters_per_epoch=tr.len_train,
                            clip_grad=tr.clip_grad)
    t["DINO bf16 train step (512 images, batch_repeat 90)"] = _time_ms(
        torch, lambda: train_step(tm, opt, batch, tr.batch_repeat, draws=draws), reps=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    train_step(tm, opt, batch, tr.batch_repeat, draws=draws)
    t["DINO bf16 train step peak memory (GB)"] = torch.cuda.max_memory_allocated() / 1e9
    del tm, opt, batch
    torch.cuda.empty_cache()
    # the same with DINOv2 ViT-S/14 and DINO ViT-B/16
    for bb, override, reps in (("DINOv2", DINOV2, 3), ("ViT-B", VITB, 2)):
        cfg_b = _train_cfg(work, f"train_{bb}", override, cfg=cfg_path)
        tm = PoseDiffusionModel(model_config_from_cfg(load_config(cfg_path, [override]).MODEL))
        init_random_weights(tm, SEED)
        tm.to(dev)
        batch, draws, _ = _train_batch(cfg_b, dev, tm.config.timesteps)
        tr = cfg_b.train
        opt, _ = make_optimizer(tm, lr=tr.lr, T_0=tr.restart_num,
                                iters_per_epoch=tr.len_train, clip_grad=tr.clip_grad)
        t[f"{bb} train step (512 images, batch_repeat 90)"] = _time_ms(
            torch, lambda: train_step(tm, opt, batch, tr.batch_repeat, draws=draws), reps=reps,
            warmup=1)
        del tm, opt, batch
        torch.cuda.empty_cache()

    # the matcher: 190 pairs of the 20 frames at 1,024 keypoints
    sp_net, sg_net = X.load_matcher_weights(write_matcher_weights(
        os.path.join(work, "matcher"), SEED), dev)
    paths = sorted(os.path.join(apple, f) for f in os.listdir(apple) if f.endswith(".jpg"))
    grays, sizes = X.load_grays(paths)
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    with torch.no_grad():
        kp, sc, de, va = X.stack_feats(X.detect_frames(sp_net, grays, MATCH_KEYPOINTS))
        x_all = encode_keypoints(sg_net, de, kp, sc,
                                 torch.as_tensor(np.asarray(sizes, np.float32), device=dev))
        st = SGK.stack_superglue_params(sg_net)
        ia = torch.as_tensor([p[0] for p in pairs], device=dev)
        ib = torch.as_tensor([p[1] for p in pairs], device=dev)

        def matcher():
            for i0 in range(0, len(pairs), SG_PAIRS):
                sa, sb = ia[i0:i0 + SG_PAIRS], ib[i0:i0 + SG_PAIRS]
                SGK.fused_match_pairs(torch.stack([x_all[sa], x_all[sb]], 1), va[sa], va[sb],
                                      st, match_threshold=0.0)

        t[f"matcher (fused_match_pairs, {len(pairs)} pairs, K {x_all.shape[1]})"] = _time_ms(
            torch, matcher, reps=3, warmup=1)
        # the demo's default: GGS with matches extracted from the images
        _, info = load_and_preprocess_images(apple, IMAGE_SIZE)

        def ggs_with_extraction():
            kp1, kp2, i12 = X.extract_match(
                image_paths=info["paths"], image_info=info, weights=(sp_net, sg_net),
                max_keypoints=MATCH_KEYPOINTS, match_threshold=0.0,
                ransac_threshold_px=RANSAC_ACCEPT_ALL, device=dev)
            cond = G.build_cond_fn(kp1, kp2, i12, n, hw, G.GGSConfig(), dev)
            return model.sample(imgs, x0=x0, noises=noises, cond_fn=cond, cond_start_step=10)

        model = PoseDiffusionModel(PoseDiffusionConfig())
        init_random_weights(model, SEED)
        model.to(dev)
        t["GGS inference with extraction (images -> matches -> cameras)"] = _time_ms(
            torch, ggs_with_extraction, reps=3, warmup=1)
    print(json.dumps({"timed_calls": t, "device_split": split, "root": root}))
    return 0


def parent_phase(report, parent_dir, smi, rounds=1):
    """--parent DIR [--rounds N]: ``timed_calls`` in 4 N child processes,
    this checkout's port and DIR's in the order new, parent, parent, new,
    N times; each call's mean over the runs of each. Returns {call:
    numbers}."""
    print(f"[parent] the same calls with this checkout and with {parent_dir} (the parent "
          f"commit), in child processes, order new, parent, parent, new, {rounds} time(s); "
          f"card: {smi}", flush=True)
    runs = {"new": [], "parent": []}
    splits = {"new": [], "parent": []}
    order = ("new", "parent", "parent", "new") * rounds
    for who in order:
        root = REPO if who == "new" else os.path.abspath(parent_dir)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--timed-calls", root],
                             capture_output=True, text=True, timeout=900)
        print(out.stderr.strip()[-2000:] if out.returncode else "", end="")
        if out.returncode != 0 or not out.stdout.strip():
            report.failures.append(f"--parent: the {who} run exited {out.returncode}")
            print(out.stdout[-2000:])
            return None
        last = json.loads(out.stdout.strip().splitlines()[-1])
        runs[who].append(last["timed_calls"])
        splits[who].append(last.get("device_split", {}))
        print(f"  {who} run in {time.perf_counter() - t0:.0f} s", flush=True)
    result = {}
    for name in runs["new"][0]:
        new = [r[name] for r in runs["new"]]
        old = [r[name] for r in runs["parent"]]
        result[name] = {"new": statistics.mean(new), "parent": statistics.mean(old),
                        "new_runs": new, "parent_runs": old}
        seq = {"new": iter(new), "parent": iter(old)}
        print(f"  {name}: {statistics.mean(new):.4f} ms, parent {statistics.mean(old):.4f} ms "
              f"({100 * (statistics.mean(new) / statistics.mean(old) - 1):+.2f}%); runs in order "
              + ", ".join(f"{next(seq[who]):.4f}" for who in order), flush=True)
    for who in ("new", "parent"):
        for call, ms in splits[who][0].items():
            print(f"  device time of {call}, {who}: {ms}")
    result["device_split"] = {who: splits[who][0] for who in ("new", "parent")}
    return result


def rows_entries(torch, F, cases, rows_by_shape):
    """Kernels-line entries of the few-rows route at the sampler's four
    product shapes (bf16 weights, 20 rows), and the 20 x 512 LayerNorm case
    on the layernorm entry's side: CUDA-event and device (profiler) times,
    the plain version's, the bound, and the library yardstick, timed only:
    torch.matmul on a float32 copy of the weight (TF32 off), after
    F.layer_norm where the LayerNorm is folded in. Device times are means of
    two measurements in the order kernel, library, matmul, matmul, library,
    kernel (the card's clocks drift between them). ``launches`` is the
    no-GGS path's count at the entry's (M, K, N)."""
    entries = []
    for pname in ("in_proj", "out_proj", "linear1", "linear2"):
        name, kernel, plain, args, kwargs, err = cases[f"linear_rows {pname}"]
        a, w, b = args[:3]
        (Mm, Kk), Nn = a.shape, w.shape[1]
        wf, ln = w.float(), kwargs.get("ln")
        call = lambda: kernel(*args, **kwargs)  # noqa: E731
        matmul = lambda: torch.matmul(a, wf)  # noqa: E731
        library = matmul if ln is None else (
            lambda: torch.matmul(F.layer_norm(a, (Kk,), ln[0], ln[1], ln[2]), wf))
        b_ms, b_by = bound(nbytes(a, w, b, kwargs.get("residual"), *(ln[:2] if ln else ()))
                           + Mm * Nn * 4, 2 * Mm * Nn * Kk + (8 * Mm * Kk if ln else 0))
        dev_ms = {"kernel": [], "library": [], "matmul": []}
        for who in ("kernel", "library", "matmul", "matmul", "library", "kernel"):
            fn, kern = {"kernel": (call, "linear_rows_kernel"), "library": (library, None),
                        "matmul": (matmul, None)}[who]
            dev_ms[who].append(_kernel_device_ms(torch, fn, kern))
        e = {
            "name": f"linear_rows {pname}", "route": "cuda", "source": SOURCES["linear_rows"],
            "replaces": TPU_KERNELS["linear_rows"], "launches": rows_by_shape.get((Mm, Kk, Nn), 0),
            "max_abs_err": err, "ms": _time_ms(torch, call, inner=10),
            "plain_ms": _time_ms(torch, lambda: plain(*args, **kwargs), inner=10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": _time_ms(torch, library, inner=10),
            "device_ms": statistics.mean(dev_ms["kernel"]),
            "library_device_ms": statistics.mean(dev_ms["library"]),
            "matmul_device_ms": statistics.mean(dev_ms["matmul"]),
            "case": f"{name} (launches: no-GGS path)",
        }
        print(f"  {e['name']}: device {e['device_ms']:.4f} ms (torch.matmul f32 "
              f"{e['matmul_device_ms']:.4f}, with F.layer_norm {e['library_device_ms']:.4f}), "
              f"events {e['ms']:.4f} ms, plain {e['plain_ms']:.4f}, library {e['library_ms']:.4f}, "
              f"bound {b_ms:.5f} ms ({b_by}), {e['launches']} launches")
        entries.append(e)
    name, kernel, plain, args, _, err = cases["layernorm_rows"]
    x, g, b, eps = args[:4]
    library = lambda: F.layer_norm(x, (x.shape[1],), g, b, eps)  # noqa: E731
    b_ms, b_by = bound(2 * nbytes(x) + 2 * x.shape[1] * 4, 8 * x.numel())
    rows20 = {
        "case": name, "max_abs_err": err, "ms": _time_ms(torch, lambda: kernel(*args), inner=10),
        "device_ms": _kernel_device_ms(torch, lambda: kernel(*args), "layernorm"),
        "plain_ms": _time_ms(torch, lambda: plain(*args), inner=10), "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": _time_ms(torch, library, inner=10),
        "library_device_ms": _kernel_device_ms(torch, library, None),
        "launches": 0,  # the sampler and the GGS tail fold their LayerNorms
    }
    print(f"  layernorm {name}: {rows20}")
    return entries, rows20


class Report:
    def __init__(self):
        self.failures = []

    def check(self, name, err, tol, scale=1.0):
        ok = bool(err <= tol * scale)
        print(f"  {'ok  ' if ok else 'FAIL'} {name}: max_abs_err {err:.3e} "
              f"(tolerance {tol:.1e} x {scale:.3g})", flush=True)
        if not ok:
            self.failures.append(f"{name}: {err:.3e} > {tol:.1e} x {scale:.3g}")
        return ok

    def require(self, name, ok, detail=""):
        print(f"  {'ok  ' if ok else 'FAIL'} {name} {detail}", flush=True)
        if not ok:
            self.failures.append(f"{name} {detail}")


def demo_cfg(work, folder, *extra):
    """cfgs/default.yaml for demo_torch on ``folder``: random weights from
    SEED, outputs under ``work``, then ``extra``."""
    from posediffusion_tpu_torch.utils.config import load_config

    return load_config("default", [
        f"image_folder={folder}", "ckpt=random", f"seed={SEED}",
        f"out_dir={os.path.join(work, 'out')}", *extra])


def _check_launches(report, path, names, launches):
    print(f"  launches during the {path} path: {launches}")
    for name in names:
        if launches[name] == 0:
            report.failures.append(f"kernel {name} was not launched on the {path} path")


def _check_cameras(report, out, n, what):
    shapes = (out["R"].shape, out["T"].shape, out["focal_length"].shape)
    finite = all(np.isfinite(out[k]).all() for k in ("R", "T", "focal_length"))
    print(f"  {what}: cameras {shapes} finite={finite}, ARE {out.get('ARE_deg')} deg")
    if shapes != ((n, 3, 3), (n, 3), (n, 2)) or not finite:
        report.failures.append(f"{what}: cameras {shapes}, finite={finite}")
    if "ARE_deg" not in out or not np.isfinite(out["ARE_deg"]):
        report.failures.append(f"{what}: no finite ARE")


def _note_layernorm_shapes(K, path):
    """Keep the first path's layernorm launches at each (rows, D)."""
    for shape, n in K.layernorm.by_shape.items():
        LN_LAUNCHES.setdefault(shape, (path, n))


def layernorm_entries(report, torch, F, K, dev, gen):
    """Kernels-line entries of the LayerNorm forward at the train trunks'
    shapes (LN_TRAIN_CASES, kernel 9's forward): the kernel against its
    plain version and bitwise against itself, its CUDA-event, profiler and
    CUDA-graph times beside F.layer_norm's, the plain version's and the
    bound (x read and y written once)."""
    entries = []
    for rows, D, what in LN_TRAIN_CASES:
        x = 3 * torch.randn((rows, D), generator=gen, device=dev) + 1
        g = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        b = 0.1 * torch.randn(D, generator=gen, device=dev)
        name = f"layernorm {what} ({rows}x{D})"
        y = K.layernorm(x, g, b, 1e-6)
        err = _close_rel(report, name, y, K.layernorm_plain(x, g, b, 1e-6), TOL_F32)
        report.require(f"{name} repeats bitwise",
                       all(torch.equal(y, K.layernorm(x, g, b, 1e-6)) for _ in range(2)))
        del y
        call = lambda: K.layernorm(x, g, b, 1e-6)  # noqa: E731
        library = lambda: F.layer_norm(x, (D,), g, b, 1e-6)  # noqa: E731
        b_ms, b_by = bound(2 * nbytes(x) + 2 * D * 4, 8 * x.numel())
        path, n = LN_LAUNCHES.get((rows, D), ("no path run", 0))
        e = {
            "name": f"layernorm {what}", "route": "cuda", "source": SOURCES["layernorm"],
            "replaces": TPU_KERNELS["layernorm"], "launches": n, "max_abs_err": err,
            "ms": _time_ms(torch, call), "plain_ms": _time_ms(
                torch, lambda: K.layernorm_plain(x, g, b, 1e-6), reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": _time_ms(torch, library),
            "device_ms": _kernel_device_ms(torch, call, "layernorm_kernel"),
            "library_device_ms": _kernel_device_ms(torch, library, None),
            "graph_ms": _graph_ms(torch, call, calls=10),
            "library_graph_ms": _graph_ms(torch, library, calls=10),
            "case": f"{name}, f32 (launches: {path}, this shape)",
        }
        print(f"  {e['name']}: CUDA graph {e['graph_ms']:.4f} ms (F.layer_norm "
              f"{e['library_graph_ms']:.4f}), profiler {e['device_ms']:.4f} ms (F.layer_norm "
              f"{e['library_device_ms']:.4f}), events {e['ms']:.4f} ms (F.layer_norm "
              f"{e['library_ms']:.4f}), plain {e['plain_ms']:.4f}, bound {b_ms:.4f} ms "
              f"({b_by}), {n} launches")
        entries.append(e)
        del x
    return entries


def bf16_linear_entries(report, torch, K, cases, launches_by_shape):
    """The serving ViT's bf16 qkv (5,280 x 384 -> 1,152) on linear's wgmma
    route as a kernels-line entry: CUDA-event, profiler and CUDA-graph times
    beside one torch.addmm on the same bf16 operands (float32 output where
    this PyTorch takes out_dtype, else bf16 output, named in the entry), the
    bound, and the route bitwise against itself; then the route timed (CUDA
    graph) at each of the serving ViTs' product shapes (BF16_PATH_SHAPES)
    beside the same library call and the bound, and held bitwise against
    itself there. Returns (entry, {shape: times})."""
    name, kern, plain, args, kwargs, err = cases["linear_qkv"]
    a, w, b = args[:3]
    call = lambda: kern(*args, **kwargs)  # noqa: E731
    a16, b16 = K.round_bf16(a).to(torch.bfloat16), b.to(torch.bfloat16)
    library, lib_name = (lambda: torch.addmm(b, a16, w, out_dtype=torch.float32),
                         "torch.addmm(f32 bias, bf16 a, bf16 W, out_dtype=float32)")
    try:
        library()
    except (TypeError, RuntimeError) as exc:  # a PyTorch without out_dtype
        print(f"  {lib_name}: not taken here ({type(exc).__name__})")
        library, lib_name = (lambda: torch.addmm(b16, a16, w),
                             "torch.addmm(bf16 bias, bf16 a, bf16 W), bf16 output")
    y = call()
    report.require(f"{name} repeats bitwise", all(torch.equal(y, call()) for _ in range(3)))
    b_ms, b_by = linear_bound(a, w, b, round_a=True)
    (M, K_), N = a.shape, w.shape[1]
    e = {
        "name": "linear bf16 vit qkv", "route": "cuda", "source": SOURCES["linear"],
        "replaces": TPU_KERNELS["linear"], "launches": launches_by_shape.get((M, K_, N, False), 0),
        "max_abs_err": err, "ms": _time_ms(torch, call, inner=10),
        "plain_ms": _time_ms(torch, lambda: plain(*args, **kwargs), inner=10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": _time_ms(torch, library, inner=10),
        "library": lib_name,
        "device_ms": _kernel_device_ms(torch, call, "linear_bf16"),
        "library_device_ms": _kernel_device_ms(torch, library, None),
        "graph_ms": _graph_ms(torch, call), "library_graph_ms": _graph_ms(torch, library),
        "case": f"{name} (launches: no-GGS path, this shape)",
    }
    print(f"  {e['name']}: CUDA graph {e['graph_ms']:.4f} ms ({lib_name} "
          f"{e['library_graph_ms']:.4f}), profiler {e['device_ms']:.4f} ms (library "
          f"{e['library_device_ms']:.4f}), events {e['ms']:.4f} ms (library "
          f"{e['library_ms']:.4f}), plain {e['plain_ms']:.4f}, bound {b_ms:.4f} ms ({b_by}), "
          f"{e['launches']} launches")
    shapes = {}
    gen = torch.Generator(device=a.device).manual_seed(SEED)
    for M, K_, N in BF16_PATH_SHAPES:
        x = torch.randn((M, K_), generator=gen, device=a.device)
        wt = (torch.randn((K_, N), generator=gen, device=a.device) / K_**0.5).to(torch.bfloat16)
        bt = torch.randn(N, generator=gen, device=a.device)
        x16, bt16 = K.round_bf16(x).to(torch.bfloat16), bt.to(torch.bfloat16)
        for act in ("none", "gelu") if N == 4 * K_ else ("none",):
            call = lambda: K.linear(x, wt, bt, act=act, round_a=True)  # noqa: E731
            y = call()
            report.require(f"bf16 tile at {M} x {K_} -> {N} ({act}) repeats bitwise",
                           all(torch.equal(y, call()) for _ in range(2)))
            row = {"graph_ms": _graph_ms(torch, call),
                   "bound_ms": linear_bound(x, wt, bt, round_a=True)[0]}
            if act == "none":  # the library has no fused GELU
                lib = ((lambda: torch.addmm(bt, x16, wt, out_dtype=torch.float32))
                       if "out_dtype" in lib_name else (lambda: torch.addmm(bt16, x16, wt)))
                row["library_graph_ms"] = _graph_ms(torch, lib)
            shapes[f"{M}x{K_}->{N} {act}"] = row
            print(f"  bf16 tile at {M} x {K_} -> {N} ({act}): CUDA graph {row['graph_ms']:.4f} ms"
                  + (f", {lib_name} {row['library_graph_ms']:.4f}" if act == "none" else "")
                  + f", bound {row['bound_ms']:.4f} ms")
        del x, wt
    return e, shapes


def _close_rel(report, name, out, ref, tol):
    """Check max |out - ref| against tol x max(1, max |ref|); returns the error."""
    err = (out - ref).abs().max().item()
    report.check(name, err, tol, max(1.0, ref.abs().max().item()))
    return err


def _route(V, plain):
    """The train trunks' plain route inside the block when ``plain``."""
    return V.plain_route() if plain else contextlib.nullcontext()


def _library_grad_ms(torch, fn, inputs, cot, reps=5):
    """CUDA-event time of the backward alone of ``fn(*inputs)`` under autograd."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return _time_ms(torch, lambda: torch.autograd.grad(out, ins, cot, retain_graph=True),
                    reps=reps)


def _trunk_grads(run, x, stacks, cot):
    """[(name, tensor)] of a train trunk's output, input gradient and the
    gradient of every stack (the LayerScale gains too), from ``run(x, stacks)``."""
    xs = x.detach().clone().requires_grad_(True)
    st = {k: v.clone().requires_grad_(True) for k, v in stacks.items()}
    y = run(xs, st)
    y.backward(cot)
    return [("y", y.detach()), ("dx", xs.grad)] + [(k, st[k].grad) for k in stacks]


def _worst_rel(outs_a, outs_b):
    """(largest |a - b| / max(1, |b|), its name) over paired (name, tensor) lists."""
    return max(((a - b).abs().max().item() / max(1.0, b.abs().max().item()), name)
               for (name, a), (_, b) in zip(outs_a, outs_b))


def _train_cfg(work, exp, *extra, cfg="default_train"):
    """cfgs/default_train.yaml (or the file ``cfg``) on the Co3D tree of
    samples/apple (written under build/), with TRAIN_OVERRIDES, then
    ``extra``."""
    from posediffusion_tpu_torch.utils.config import load_config

    co3d_dir, ann_dir = write_co3d_tree(os.path.join(REPO, "build", "co3d_apple"),
                                        os.path.join(REPO, "samples", "apple"))
    return load_config(cfg, [
        f"train.CO3D_DIR={co3d_dir}", f"train.CO3D_ANNOTATION_DIR={ann_dir}", *TRAIN_OVERRIDES,
        f"exp_dir={os.path.join(work, exp)}", f"seed={SEED}", *extra])


def _train_batch(cfg, dev, timesteps):
    """One train batch of the config's sampler (512 images) on the card, and
    fixed draws for its loss (t, noise, dropout seed)."""
    import torch

    from posediffusion_tpu_torch.data.factory import get_co3d_dataset
    from posediffusion_tpu_torch.data.sampler import DynamicBatchSampler, collate_batch

    t = cfg.train
    dataset, _ = get_co3d_dataset(cfg)
    sampler = DynamicBatchSampler(len(dataset), dataset_len=1, max_images=t.max_images,
                                  images_per_seq=tuple(t.images_per_seq),
                                  frame_buckets=tuple(t.frame_buckets), seed=SEED)
    spec = next(iter(sampler))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in collate_batch(
        [dataset[s] for s in spec], pad_frames_to=sampler.bucket_for(spec[0][1])).items()}
    n_rows = batch["images"].shape[0] * t.batch_repeat
    cpu = torch.Generator().manual_seed(SEED + 11)
    draws = dict(t=torch.randint(0, timesteps, (n_rows,), generator=cpu),
                 noise=torch.randn((n_rows, *batch["pose_encodings"].shape[1:]), generator=cpu),
                 drop_seed=1234)
    return batch, draws, n_rows


def _step_launches(K, step):
    """Launch counts of one call of ``step``, with ``sum_partials`` (the
    weight gradients' in-order sum of partials, a helper launch)."""
    import torch

    K.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    return {**K.launch_counts(), "sum_partials": K._sum_partials.launches}


def train_slice(report, dev, work, smi, t_start, dev_ms):
    """The training slice: its kernels against their plain versions at the
    path's shapes (parity), train_torch.py at the reference train config
    (the path), and its timings, then one DINO step of the bf16 train mode
    and its weight gradients (``dev_ms``: ``device_times``' result).
    Returns (kernel JSON entries, timings, the path's launch counts, the
    bf16 step's launch counts)."""
    import torch
    import torch.nn.functional as F

    import train_torch
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.layers import key_bias_from_mask
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops import vit_train_kernel as V
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    apple = os.path.join(REPO, "samples", "apple")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    errs, cases = {}, {}

    # ---- parity: the new kernels at the path's shapes
    print("[train-parity] the train kernels against their plain versions")
    Bv, Nv, Hv, Dv = VIT_CHUNK, 264, 6, 384
    seg = torch.tensor([0] * 197 + [1] * 50 + [2] * 17, device=dev)
    vbias = torch.where(seg[:, None] == seg[None], 0.0, K.NEG).contiguous()
    qkv_v, dout_v = rnd(Bv, Nv, 3 * Dv), rnd(Bv, Nv, Dv)
    Be, Ne, He, De = ENC_ROWS, 16, 4, 512
    frames = torch.randint(8, Ne + 1, (Be, 1), generator=gen, device=dev)
    ebias = key_bias_from_mask(torch.arange(Ne, device=dev)[None] < frames, Be, Ne, dev)
    qkv_e, dout_e = rnd(Be, Ne, 3 * De), rnd(Be, Ne, De)
    d_attn = K.drop_args(SEED, 0, "attn", 0.1)
    for mode in (False, True):
        tag = "bf16" if mode else "f32"
        kw = dict(attn_bias=vbias, round_in=mode)
        errs[("attention_bwd", mode)] = _close_rel(
            report, f"attention_bwd vit {tag} ({Bv}x{Nv}, {Hv} heads, packing bias)",
            K.attention_bwd(qkv_v, dout_v, Hv, **kw),
            K.attention_bwd_plain(qkv_v, dout_v, Hv, **kw), TOL_BF16 if mode else TOL_F32)
    cases["attention_bwd"] = (
        f"attention_bwd vit f32 ({Bv}x{Nv}, {Hv} heads)",
        lambda: K.attention_bwd(qkv_v, dout_v, Hv, attn_bias=vbias),
        lambda: K.attention_bwd_plain(qkv_v, dout_v, Hv, attn_bias=vbias),
        lambda: _library_grad_ms(
            torch, lambda q: F.scaled_dot_product_attention(
                *q.view(Bv, Nv, 3, Hv, 64).permute(2, 0, 3, 1, 4), attn_mask=vbias),
            [qkv_v], dout_v.view(Bv, Nv, Hv, 64).transpose(1, 2)),
        attention_bwd_bound(qkv_v, vbias))
    report.require(f"attention_bwd vit f32 ({Bv}x{Nv}) repeats bitwise", torch.equal(
        K.attention_bwd(qkv_v, dout_v, Hv, attn_bias=vbias),
        K.attention_bwd(qkv_v, dout_v, Hv, attn_bias=vbias)))
    kw = dict(key_bias=ebias, drop=d_attn)
    _close_rel(report, f"attention dropout enc f32 ({Be}x{Ne}, {He} heads, p 0.1)",
               K.attention(qkv_e, He, **kw), K.attention_plain(qkv_e, He, **kw), TOL_F32)
    for mode in (False, True):
        tag = "bf16" if mode else "f32"
        out_e = K.attention_bwd(qkv_e, dout_e, He, round_in=mode, **kw)
        errs[("attention_bwd", f"enc {tag}")] = _close_rel(
            report, f"attention_bwd enc {tag} ({Be}x{Ne}, {He} heads, key bias, dropout 0.1)",
            out_e, K.attention_bwd_plain(qkv_e, dout_e, He, round_in=mode, **kw),
            TOL_BF16 if mode else TOL_F32)
        report.require(f"attention_bwd enc {tag} repeats bitwise",
                       torch.equal(out_e, K.attention_bwd(qkv_e, dout_e, He, round_in=mode, **kw)))
    del out_e

    M, Df = VIT_IMAGES * Nv, 4 * Dv  # the ViT's rows at the full batch, fc1's width
    x_ln, dh_ln, res_ln = rnd(M, Dv), rnd(M, Dv), rnd(M, Dv)
    g_ln = 1 + 0.1 * rnd(Dv)
    out_k = K.layernorm_bwd(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln)
    out_p = K.layernorm_bwd_plain(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln)
    errs["layernorm_bwd"] = max(_close_rel(report, f"layernorm_bwd {part} vit ({M}x{Dv})",
                                           a, b, TOL_F32)
                                for part, a, b in zip(("dx", "dg", "db"), out_k, out_p))
    report.require(f"layernorm_bwd vit ({M}x{Dv}) dx, dg and db repeat bitwise", all(
        torch.equal(a, b) for a, b in zip(out_k, K.layernorm_bwd(x_ln, g_ln, dh_ln, 1e-6,
                                                                  residual=res_ln))))
    b_ln = torch.zeros(Dv, device=dev)
    cases["layernorm_bwd"] = (
        f"layernorm_bwd vit ({M}x{Dv}, + residual)",
        lambda: K.layernorm_bwd(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln),
        lambda: K.layernorm_bwd_plain(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln),
        lambda: _library_grad_ms(torch, lambda x, g: F.layer_norm(x, (Dv,), g, b_ln, 1e-6),
                                 [x_ln, g_ln], dh_ln),
        bound(nbytes(x_ln, dh_ln, res_ln, g_ln) + nbytes(x_ln) + 2 * Dv * 4, 12 * M * Dv))
    del out_k, out_p

    x_fc, dy_fc = rnd(M, Dv), rnd(M, Df)
    w_fc = rnd(Dv, Df) / Dv**0.5
    for mode in (False, True):
        tag = "bf16" if mode else "f32"
        w = w_fc.to(torch.bfloat16) if mode else w_fc
        dgrad = K.linear(dy_fc, w, None, trans_w=True, round_a=mode)
        err = _close_rel(report, f"linear dgrad fc1 {tag} ({M}x{Df} @ ({Dv}x{Df})^T)", dgrad,
                         K.linear_plain(dy_fc, w, None, trans_w=True, round_a=mode), TOL_F32)
        if not mode:
            errs["linear dgrad"] = err
            report.require("linear dgrad fc1 f32 repeats bitwise",
                           torch.equal(dgrad, K.linear(dy_fc, w, None, trans_w=True)))
        del dgrad
        dw_k, db_k = K.linear_wgrad(x_fc, dy_fc, mode)
        dw_p, db_p = K.linear_wgrad_plain(x_fc, dy_fc, mode)
        errs[("linear_wgrad", mode)] = max(
            _close_rel(report, f"linear_wgrad fc1 dW {tag} ({M}x{Dv})^T ({M}x{Df})",
                       dw_k, dw_p, TOL_F32),
            _close_rel(report, f"linear_wgrad fc1 db {tag}", db_k, db_p, TOL_F32))
        report.require(f"linear_wgrad fc1 {tag} repeats bitwise",
                       torch.equal(dw_k, K.linear_wgrad(x_fc, dy_fc, mode)[0]))
    cases["linear dgrad"] = (
        f"linear f32 dgrad fc1 ({M}x{Df} @ ({Dv}x{Df})^T)",
        lambda: K.linear(dy_fc, w_fc, None, trans_w=True),
        lambda: K.linear_plain(dy_fc, w_fc, None, trans_w=True),
        lambda: _time_ms(torch, lambda: torch.matmul(dy_fc, w_fc.t()), reps=5),
        linear_bound(dy_fc, w_fc, trans_w=True))
    # the ViT's qkv product, f32, beside one torch.addmm
    w_q, b_q = rnd(Dv, 3 * Dv) / Dv**0.5, rnd(3 * Dv)
    qkv_k = K.linear(x_fc, w_q, b_q)
    errs["linear qkv"] = _close_rel(report, f"linear qkv f32 ({M}x{Dv} @ {Dv}x{3 * Dv})",
                                    qkv_k, K.linear_plain(x_fc, w_q, b_q), TOL_F32)
    report.require("linear qkv f32 repeats bitwise", torch.equal(qkv_k, K.linear(x_fc, w_q, b_q)))
    del qkv_k
    cases["linear qkv"] = (
        f"linear f32 vit qkv ({M}x{Dv} @ {Dv}x{3 * Dv}, + bias)",
        lambda: K.linear(x_fc, w_q, b_q), lambda: K.linear_plain(x_fc, w_q, b_q),
        lambda: _time_ms(torch, lambda: torch.addmm(b_q, x_fc, w_q), reps=5),
        linear_bound(x_fc, w_q, b_q))
    cases["linear_wgrad"] = (
        f"linear_wgrad fc1 f32 ({M}x{Dv})^T ({M}x{Df})",
        lambda: K.linear_wgrad(x_fc, dy_fc), lambda: K.linear_wgrad_plain(x_fc, dy_fc),
        lambda: _time_ms(torch, lambda: torch.matmul(x_fc.t(), dy_fc), reps=5),
        wgrad_bound(x_fc, dy_fc))
    del dw_k, db_k, dw_p, db_p

    a_fc = rnd(M, Df)
    errs["act_dropout_bwd"] = _close_rel(
        report, f"act_dropout_bwd vit fc1 gelu ({M}x{Df})",
        K.act_dropout_bwd(dy_fc, a_fc, "gelu"), K.act_dropout_bwd_plain(dy_fc, a_fc, "gelu"),
        TOL_F32)
    cases["act_dropout_bwd"] = (
        f"act_dropout_bwd vit fc1 gelu ({M}x{Df})",
        lambda: K.act_dropout_bwd(dy_fc, a_fc, "gelu"),
        lambda: K.act_dropout_bwd_plain(dy_fc, a_fc, "gelu"),
        lambda: _time_ms(torch, lambda: torch.ops.aten.gelu_backward(dy_fc, a_fc), reps=5,
                         inner=10),
        bound(3 * nbytes(a_fc), 20 * M * Df))
    # the encoder's two other sites: ReLU' with the mff mask (fc1) and the
    # m1 / m2 masks alone (act none)
    Me, Fe = Be * Ne, 1024
    d_mff, d_m2 = K.drop_args(SEED, 3, "mff", 0.1), K.drop_args(SEED, 3, "m2", 0.1)
    dh_e, a_e, dm_e = rnd(Me, Fe), rnd(Me, Fe), rnd(Me, De)
    errs[("act_dropout_bwd enc relu", 0)] = _close_rel(
        report, f"act_dropout_bwd enc relu + mff mask ({Me}x{Fe})",
        K.act_dropout_bwd(dh_e, a_e, "relu", d_mff),
        K.act_dropout_bwd_plain(dh_e, a_e, "relu", d_mff), TOL_F32)
    errs[("act_dropout_bwd enc none", 0)] = _close_rel(
        report, f"act_dropout_bwd enc none + m2 mask ({Me}x{De})",
        K.act_dropout_bwd(dm_e, None, "none", d_m2),
        K.act_dropout_bwd_plain(dm_e, None, "none", d_m2), TOL_F32)
    mask = K.dropout_mask(d_mff, (Me, Fe), dev)
    ones = torch.ones(Me, Fe, device=dev)
    report.require(f"dropout mask bitwise: act_dropout_bwd ({Me}x{Fe}, site mff)",
                   torch.equal(K.act_dropout_bwd(ones, None, "none", d_mff), mask))
    report.require(f"dropout mask bitwise: linear epilogue ({Me}x{Fe})", torch.equal(
        K.linear(torch.zeros(Me, 8, device=dev), torch.zeros(8, Fe, device=dev),
                 torch.ones(Fe, device=dev), drop=d_mff), mask))
    qkv1 = torch.zeros(Be, 1, 3 * De, device=dev)
    qkv1[..., 2 * De:] = 1.0
    report.require(f"dropout mask bitwise: attention p ({Be} x {He} heads, site attn)", torch.equal(
        K.attention(qkv1, He, drop=d_attn).view(Be, He, -1)[..., 0],
        K.dropout_mask(d_attn, (Be, He, 1, 1), dev).view(Be, He)))
    print(f"  dropout rate at site mff: {float((mask == 0).float().mean()):.5f} "
          f"of {mask.numel()} (p 0.1)")
    del dh_e, a_e, dm_e, mask, ones

    # the two train trunks, forward and gradients, kernel route against plain
    model = PoseDiffusionModel(model_config_from_cfg(load_config("default_train").MODEL))
    init_random_weights(model, SEED)
    model.to(dev)
    vit, den = model.image_feature_extractor._net, model.diffuser.model
    imgs20 = torch.as_tensor(load_and_preprocess_images(apple, IMAGE_SIZE)[0], device=dev)
    with torch.no_grad():
        tok20, _, _ = _embed_pack_scales(vit, imgs20, model.config.scale_factors)
    tok = tok20.repeat(VIT_CHUNK // 20 + 1, 1, 1)[:VIT_CHUNK].contiguous()
    with torch.no_grad():
        vst = {k: v.detach().clone() for k, v in V.stack_vit_params_train(vit).items()}
        est = {k: v.detach().clone() for k, v in V.stack_encoder_trunk_params(den._trunk).items()}
    cot_v = rnd(*tok.shape)
    h_e = rnd(Be, Ne, De)
    cot_e = rnd(Be, Ne, De)

    def vit_run(mode, plain):
        def run(x, st):
            with _route(V, plain):
                return V.fused_vit_trunk_train(x, st, vbias, 6, mode, mode)
        return run

    def enc_run(plain, act="relu"):
        def run(x, st):
            with _route(V, plain):
                if act == "relu":
                    return V.fused_encoder_trunk_train(x, st, ebias, SEED, 4, dropout=0.1)
                spec = V.TrunkSpec(nhead=4, eps=1e-5, act=act, dropout=0.1, seed=SEED)
                return V.train_trunk(x, st, spec, key_bias=ebias)
        return run

    for mode in (False, True):
        tag = "bf16 operands and residuals" if mode else "f32"
        worst = _worst_rel(_trunk_grads(vit_run(mode, False), tok, vst, cot_v),
                           _trunk_grads(vit_run(mode, True), tok, vst, cot_v))
        report.check(f"fused_vit_trunk_train {tag} (12 blocks, {VIT_CHUNK}x{Nv}): output and "
                     f"every gradient, worst {worst[1]}", worst[0],
                     TOL_TRAIN_BF16 if mode else TOL_TRAIN_F32)
        errs[("trunk_vit", mode)] = worst[0]
    outs = list(zip(_trunk_grads(enc_run(False), h_e, est, cot_e),
                    _trunk_grads(enc_run(True), h_e, est, cot_e)))
    tag = f"(8 layers, {Be}x{Ne}, dropout 0.1)"
    _close_rel(report, f"fused_encoder_trunk_train f32 y {tag}", outs[0][0][1], outs[0][1][1],
               TOL_TRAIN_F32)
    mean_err, share, worst = 0.0, 0.0, 0.0
    for (name, a), (_, b) in outs[1:]:
        rel = (a - b).abs() / max(1.0, b.abs().max().item())
        mean_err = max(mean_err, rel.mean().item())
        share = max(share, (rel > ENCODER_GRAD_OUTLIER).float().mean().item())
        worst = max(worst, rel.max().item())
    print(f"  fused_encoder_trunk_train f32 dx and weight gradients {tag}: largest relative "
          f"error {worst:.3e} (ReLU kinks)")
    report.check(f"fused_encoder_trunk_train f32 gradients, largest mean relative error {tag}",
                 mean_err, TOL_ENCODER_GRAD_MEAN)
    report.check(f"fused_encoder_trunk_train f32 gradients, largest share beyond "
                 f"{ENCODER_GRAD_OUTLIER:.0e} {tag}", share, TOL_ENCODER_GRAD_SHARE)
    worst = _worst_rel(_trunk_grads(enc_run(False, "gelu"), h_e, est, cot_e),
                       _trunk_grads(enc_run(True, "gelu"), h_e, est, cot_e))
    report.check(f"encoder train trunk with GELU for ReLU, f32 {tag}: output and every "
                 f"gradient, worst {worst[1]} (no kinks)", worst[0], TOL_F32)
    del outs
    torch.cuda.synchronize()

    # one whole train step, kernel route against plain route, same weights/draws
    cfg = _train_cfg(work, "train")
    t = cfg.train
    batch, draws, n_rows = _train_batch(cfg, dev, model.config.timesteps)
    print(f"  train batch {tuple(batch['images'].shape)}, batch_repeat {t.batch_repeat}: "
          f"{n_rows} diffusion rows")
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step_out = {}
    for plain in (False, True):
        model.load_state_dict(start)
        opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                                clip_grad=t.clip_grad)
        with _route(V, plain):
            m = train_step(model, opt, batch, t.batch_repeat, draws=draws)
        change = max((p.detach() - start[k]).abs().max().item()
                     for k, p in model.named_parameters())
        step_out[plain] = (m["loss"], m["grad_norm"], change)
    (lk, nk, ck), (lp, np_, cp) = step_out[False], step_out[True]
    print(f"  train step kernel / plain: loss {lk:.6f} / {lp:.6f}, grad norm {nk:.6f} / "
          f"{np_:.6f}, largest parameter change {ck:.4e} / {cp:.4e}")
    report.check("train step loss, kernel route vs plain (relative)", abs(lk - lp) / abs(lp),
                 TOL_STEP_LOSS)
    report.check("train step gradients' global norm (relative)", abs(nk - np_) / np_,
                 TOL_STEP_NORM)
    report.check("train step largest parameter change (relative)", abs(ck - cp) / cp,
                 TOL_STEP_CHANGE)
    print(f"  [train-parity] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- the path: train_torch.py at the reference train config
    print("[train] train_torch.py on a Co3D tree of samples/apple, cfgs/default_train.yaml: "
          + " ".join(TRAIN_OVERRIDES))
    shutil.rmtree(os.path.join(work, "train"), ignore_errors=True)
    K.reset_launch_counts()
    result = train_torch.run(cfg)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    _note_layernorm_shapes(K, "train path")
    wgrad_by_shape = dict(K.linear_wgrad.by_shape)
    linear_by_shape = dict(K.linear.by_shape)
    act_by_shape = dict(K.act_dropout_bwd.by_shape)
    _check_launches(report, "train", TRAIN_PATH, launches)
    print(f"  {result['steps']} steps, losses {[round(x, 5) for x in result['losses']]}, "
          f"step seconds (host clock) {[round(x, 3) for x in result['step_seconds']]}, "
          f"eval {result['eval']}, checkpoint {result['checkpoint']}")
    report.require("train losses finite", result["finite"])
    report.require("parameters moved", result["param_change"] > 0,
                   f"(largest change {result['param_change']:.3e})")
    report.require("checkpoint written", bool(result["checkpoint"])
                   and os.path.exists(result["checkpoint"]))
    report.require("eval metrics finite", result["eval"] is not None
                   and all(np.isfinite(v) for v in result["eval"].values()))
    report.require("stats.jsonl written",
                   os.path.exists(os.path.join(cfg.exp_dir, "stats.jsonl")))
    print(f"  [train] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- timings (CUDA events after warm-up)
    print(f"[train-timing] card: {smi}")
    timings = {}
    opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                            clip_grad=t.clip_grad)
    for plain in (False, True):
        name = "train step " + ("plain route" if plain else "kernel route")
        with _route(V, plain):
            step = lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws)  # noqa: E731
            timings[f"{name} (512 images, batch_repeat 90)"] = _time_ms(
                torch, step, reps=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step_launches = _step_launches(
        K, lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches of one train step: {step_launches}")
    timings["optimizer step (clip + AdamW)"] = _time_ms(torch, opt.step, reps=5)
    full = tok20.repeat(VIT_IMAGES // 20 + 1, 1, 1)[:VIT_IMAGES].contiguous()
    cot_full = rnd(*full.shape)
    for plain in (False, True):
        r = " plain" if plain else ""
        timings[f"vit trunk fwd+bwd{r}"] = _time_ms(
            torch, lambda: _trunk_grads(vit_run(False, plain), full, vst, cot_full), reps=3,
            warmup=1)
        timings[f"encoder trunk fwd+bwd{r}"] = _time_ms(
            torch, lambda: _trunk_grads(enc_run(plain), h_e, est, cot_e), reps=3, warmup=1)
        with torch.no_grad():
            timings[f"vit trunk fwd{r}"] = _time_ms(
                torch, lambda: vit_run(False, plain)(full, vst), reps=3, warmup=1)
            timings[f"encoder trunk fwd{r}"] = _time_ms(
                torch, lambda: enc_run(plain)(h_e, est), reps=3, warmup=1)
    print(f"  trunk cases: vit {VIT_IMAGES}x{Nv}, 12 blocks, f32; encoder {Be}x{Ne}, "
          "8 layers, dropout 0.1, f32; the backward is fwd+bwd less fwd")
    for name, ms in timings.items():
        print(f"  {name}: {ms:.3f} ms")
    print(f"  peak memory of a train step: {peak_gb:.2f} GB "
          "(torch.cuda.max_memory_allocated)")

    # the qkv product's weight gradient (27 tiles of 128 x 128), made after
    # the step's peak memory is read
    Dq = 3 * Dv
    dy_q = rnd(M, Dq)
    dw_k, db_k = K.linear_wgrad(x_fc, dy_q)
    errs[("linear_wgrad qkv", False)] = max(
        _close_rel(report, f"linear_wgrad qkv dW f32 ({M}x{Dv})^T ({M}x{Dq})", dw_k,
                   K.linear_wgrad_plain(x_fc, dy_q)[0], TOL_F32),
        _close_rel(report, "linear_wgrad qkv db f32", db_k, dy_q.sum(0), TOL_F32))
    report.require("linear_wgrad qkv f32 repeats bitwise",
                   torch.equal(dw_k, K.linear_wgrad(x_fc, dy_q)[0]))
    cases["linear_wgrad qkv"] = (
        f"linear_wgrad qkv f32 ({M}x{Dv})^T ({M}x{Dq})",
        lambda: K.linear_wgrad(x_fc, dy_q), lambda: K.linear_wgrad_plain(x_fc, dy_q),
        lambda: _time_ms(torch, lambda: torch.matmul(x_fc.t(), dy_q), reps=5),
        wgrad_bound(x_fc, dy_q))
    # act_dropout_bwd's timed encoder cases, made after the step's peak memory
    # is read: ReLU' with the mff mask (12 bytes an element) and the mask
    # alone (act none: dh read, da written, 8 bytes an element); no one
    # PyTorch call computes either with the hashed mask
    dh_e, a_e, dm_e = rnd(Me, Fe), rnd(Me, Fe), rnd(Me, De)
    cases["act_dropout_bwd enc relu"] = (
        f"act_dropout_bwd enc relu + mff mask ({Me}x{Fe})",
        lambda: K.act_dropout_bwd(dh_e, a_e, "relu", d_mff),
        lambda: K.act_dropout_bwd_plain(dh_e, a_e, "relu", d_mff), lambda: None,
        bound(3 * nbytes(a_e), 20 * Me * Fe))
    cases["act_dropout_bwd enc none"] = (
        f"act_dropout_bwd enc none + m2 mask ({Me}x{De})",
        lambda: K.act_dropout_bwd(dm_e, None, "none", d_m2),
        lambda: K.act_dropout_bwd_plain(dm_e, None, "none", d_m2), lambda: None,
        bound(2 * nbytes(dm_e), 20 * Me * De))
    kernels_json = []
    # launches on the train path: the kernel's, or at the entry's shape
    shape_launches = {
        "linear_wgrad qkv": wgrad_by_shape.get((M, Dv, 3 * Dv), 0),
        "linear dgrad": linear_by_shape.get((M, Df, Dv, True), 0),
        "linear qkv": linear_by_shape.get((M, Dv, 3 * Dv, False), 0),
        "act_dropout_bwd enc relu": act_by_shape.get(((Me, Fe), "relu"), 0),
        "act_dropout_bwd enc none": act_by_shape.get(((Me, De), "none"), 0),
    }
    entry_keys = TRAIN_KERNELS + ("act_dropout_bwd enc relu", "act_dropout_bwd enc none",
                                  "linear_wgrad qkv", "linear dgrad", "linear qkv")
    for key in entry_keys:
        name, kern, plain, library, (bound_ms, bound_by) = cases[key]
        kernel = key.split()[0]
        # act_dropout_bwd and its yardstick over 10 calls an event pair: the
        # wrapper's host cost (tens of us) is not the kernel's
        ms = _time_ms(torch, kern, reps=5, inner=10 if kernel == "act_dropout_bwd" else 1)
        plain_ms = _time_ms(torch, plain, reps=5)
        library_ms = library()
        err = max(v for k, v in errs.items() if (k if isinstance(k, str) else k[0]) == key)
        n = launches[kernel] if key == kernel else shape_launches[key]
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  {name}: kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of its bound), plain "
              f"{plain_ms:.4f} ms, library {lib}, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{n} launches")
        kernels_json.append({
            "name": key if kernel != "linear" else key.replace("linear", "linear f32", 1),
            "route": "cuda", "source": SOURCES[kernel],
            "replaces": TPU_KERNELS[kernel], "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "case": f"{name} (launches: train path{'' if key == kernel else ', this shape'}"
                    f"{'; ms over 10 calls an event pair' if kernel == 'act_dropout_bwd' else ''})",
        })
    # device time by the profiler: attention_bwd's two kernels, and the
    # weight gradient's kernel beside cuBLAS's on the same operands
    for e, key in zip(kernels_json, entry_keys):
        kern = cases[key][1]
        if key.startswith("linear "):  # the tensor-core tile beside cuBLAS's one call
            library = ((lambda: torch.matmul(dy_fc, w_fc.t())) if key == "linear dgrad"
                       else (lambda: torch.addmm(b_q, x_fc, w_q)))
            e.update(_linear_f32_device(torch, K, kern))
            e["library_device_ms"] = _kernel_device_ms(torch, library, None)
        elif e["name"] == "attention_bwd":
            e["device_ms"] = {k: _kernel_device_ms(torch, kern, k)
                              for k in ("attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")}
        elif e["name"].startswith("linear_wgrad"):
            dy = dy_fc if e["name"] == "linear_wgrad" else dy_q
            e.update(_wgrad_f32_device(torch, K, x_fc, dy))
            e["library_device_ms"] = e["library_device_ms_tf32_off"]
        if "device_ms" in e:
            print(f"  {e['name']} by device time: {e['device_ms']}, library "
                  f"{e.get('library_device_ms')}"
                  + (f", TF32 on {e['library_device_ms_tf32_on']}"
                     if "library_device_ms_tf32_on" in e else "")
                  + (f", route {e['linear_route']}" if "linear_route" in e else "")
                  + (f", route {e['wgrad_route']}" if "wgrad_route" in e else ""))
    timings["peak memory of a train step (GB)"] = peak_gb
    # the bf16 train mode: one DINO step, then its weight gradients (csrc/wgrad.cu)
    # at the step's shapes, their device times read in a child process
    del x_fc, dy_fc, dy_q, a_fc, dh_e, a_e, dm_e
    torch.cuda.empty_cache()
    print(f"[train-timing] the bf16 train mode ({' '.join(BF16_TRAIN)})", flush=True)
    bf_timings, bf_launches, bf_by_shape = bf16_train_step(report, torch, K, dev, work, batch,
                                                           draws)
    timings.update(bf_timings)
    kernels_json += wgrad_bf16_entries(report, torch, K, dev, bf_by_shape, dev_ms)
    return kernels_json, timings, step_launches, bf_launches

def backbones_slice(report, dev, work, smi, t_start, dino_step_launches):
    """DINOv2 ViT-S/14 (TPU kernels 9 and 10 with LayerScale) and DINO
    ViT-B/16: linear with a gain and layerscale_bwd against their plain
    versions at DINOv2's train shapes, the LayerScale train trunk kernel
    against plain route, demo_torch serving DINOv2 without and with GGS,
    train_torch.py with DINOv2 at the reference train config, the timings;
    then ViT-B: fused_vit_trunk at D 768, layernorm_bwd at 135,168 x 768 and
    one train step at 512 images. Returns (kernel JSON entries, timings,
    TPU-kernel rows, the launches of one DINOv2 and one ViT-B train step)."""
    import torch
    import torch.nn.functional as F

    import demo_torch
    import train_torch
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops import vit_train_kernel as V
    from posediffusion_tpu_torch.ops.vit_kernel import (
        fused_vit_trunk,
        fused_vit_trunk_plain,
        stack_vit_params,
    )
    from posediffusion_tpu_torch.training.checkpoints import restore
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    apple = os.path.join(REPO, "samples", "apple")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    timings, cases = {}, {}
    imgs20 = torch.as_tensor(load_and_preprocess_images(apple, IMAGE_SIZE)[0], device=dev)

    # ---- parity: the gain in linear's epilogue and layerscale_bwd at
    # DINOv2's train shapes (512 images x 348 tokens)
    print("[dinov2-parity] linear + gain, layerscale_bwd, the LayerScale train trunk")
    Nv, Dv, Fv = 348, 384, 1536
    M = VIT_IMAGES * Nv
    hm, res = rnd(M, Fv), rnd(M, Dv)
    w2, b2, gain = rnd(Fv, Dv) / Fv**0.5, rnd(Dv), 1 + 0.1 * rnd(Dv)
    for mode in (False, True):
        tag = "bf16" if mode else "f32"
        w = w2.to(torch.bfloat16) if mode else w2
        kw = dict(residual=res, round_a=mode, round_out=mode, gain=gain, want_pre=True)
        (y, pre), (yp, prep) = K.linear(hm, w, b2, **kw), K.linear_plain(hm, w, b2, **kw)
        name = f"linear fc2 + gain + residual {tag} ({M}x{Fv} @ {Fv}x{Dv})"
        err = max(_close_rel(report, name, y, yp, TOL_BF16 if mode else TOL_F32),
                  _close_rel(report, f"{name}: pre-gain output", pre, prep, TOL_F32))
        report.require(f"{name} repeats bitwise", torch.equal(y, K.linear(hm, w, b2, **kw)[0]))
        kw.pop("want_pre")
        cases[f"linear+gain {tag}"] = (
            name, lambda w=w, kw=kw: K.linear(hm, w, b2, **kw),
            lambda w=w, kw=kw: K.linear_plain(hm, w, b2, **kw),
            linear_bound(hm, w, b2, res, gain, mode), err)
        del y, pre, yp, prep
    dy_ls, o_ls = rnd(M, Dv), rnd(M, Dv)
    d_m2 = K.drop_args(SEED, 0, "m2", 0.1)
    out_k, dg_k = K.layerscale_bwd(dy_ls, o_ls, gain, d_m2)
    out_p, dg_p = K.layerscale_bwd_plain(dy_ls, o_ls, gain, d_m2)
    ls_err = max(_close_rel(report, f"layerscale_bwd cotangent ({M}x{Dv}, dropout 0.1)",
                            out_k, out_p, TOL_F32),
                 _close_rel(report, "layerscale_bwd dgamma", dg_k, dg_p, TOL_F32))
    report.require("layerscale_bwd dgamma repeats bitwise",
                   torch.equal(dg_k, K.layerscale_bwd(dy_ls, o_ls, gain, d_m2)[1]))
    del out_k, out_p

    # the DINOv2 train trunk (12 blocks, LayerScale), kernel route against plain
    cfg_model = model_config_from_cfg(load_config("default_train", [DINOV2]).MODEL)
    model = PoseDiffusionModel(cfg_model)
    init_random_weights(model, SEED)
    model.to(dev)
    vit = model.image_feature_extractor._net
    with torch.no_grad():
        tok20, bias, _ = _embed_pack_scales(vit, imgs20, model.config.scale_factors)
        vst = {k: v.detach().clone() for k, v in V.stack_vit_params_train(vit).items()}
    tok = tok20.repeat(VIT_CHUNK // 20 + 1, 1, 1)[:VIT_CHUNK].contiguous()
    cot = rnd(*tok.shape)
    report.require(f"DINOv2 packs {Nv} tokens at 224px", tok.shape[1] == Nv,
                   f"({tuple(tok.shape)})")
    # attention_bwd at DINOv2's 348 tokens and its packing bias (257 / 65 / 26)
    qkv_d, dout_d = rnd(VIT_CHUNK, Nv, 3 * Dv), rnd(VIT_CHUNK, Nv, Dv)
    abwd_err = 0.0
    for mode in (False, True):
        tag = "bf16" if mode else "f32"
        out_d = K.attention_bwd(qkv_d, dout_d, 6, attn_bias=bias, round_in=mode)
        abwd_err = max(abwd_err, _close_rel(
            report, f"attention_bwd DINOv2 {tag} ({VIT_CHUNK}x{Nv}, 6 heads, packing bias)",
            out_d, K.attention_bwd_plain(qkv_d, dout_d, 6, attn_bias=bias, round_in=mode),
            TOL_BF16 if mode else TOL_F32))
        report.require(f"attention_bwd DINOv2 {tag} repeats bitwise", torch.equal(
            out_d, K.attention_bwd(qkv_d, dout_d, 6, attn_bias=bias, round_in=mode)))
    del out_d
    abwd_case = f"attention_bwd DINOv2 f32 ({VIT_CHUNK}x{Nv}, 6 heads, packing bias)"
    abwd = dict(
        ms=_time_ms(torch, lambda: K.attention_bwd(qkv_d, dout_d, 6, attn_bias=bias), reps=5),
        plain_ms=_time_ms(torch, lambda: K.attention_bwd_plain(qkv_d, dout_d, 6, attn_bias=bias),
                          reps=5),
        library_ms=_library_grad_ms(
            torch, lambda q: F.scaled_dot_product_attention(
                *q.view(VIT_CHUNK, Nv, 3, 6, 64).permute(2, 0, 3, 1, 4), attn_mask=bias),
            [qkv_d], dout_d.view(VIT_CHUNK, Nv, 6, 64).transpose(1, 2)))
    ab_bound = attention_bwd_bound(qkv_d, bias)
    timings[abwd_case] = abwd["ms"]
    timings[f"{abwd_case} plain"] = abwd["plain_ms"]
    timings[f"{abwd_case} SDPA backward"] = abwd["library_ms"]
    print(f"  {abwd_case}: kernel {abwd['ms']:.4f} ms, plain {abwd['plain_ms']:.4f} ms, SDPA "
          f"backward {abwd['library_ms']:.4f} ms, bound {ab_bound[0]:.4f} ms ({ab_bound[1]})")
    del qkv_d, dout_d

    def ls_run(mode, plain):
        def run(x, st):
            with _route(V, plain):
                return V.fused_vit_trunk_train(x, st, bias, 6, mode, mode, layer_scale=True)
        return run

    for mode in (False, True):
        tag = "bf16 operands and residuals" if mode else "f32"
        worst = _worst_rel(_trunk_grads(ls_run(mode, False), tok, vst, cot),
                           _trunk_grads(ls_run(mode, True), tok, vst, cot))
        report.check(f"DINOv2 fused_vit_trunk_train {tag} (12 blocks, LayerScale, "
                     f"{VIT_CHUNK}x{Nv}): output and all 14 gradient stacks, worst {worst[1]}",
                     worst[0], TOL_TRAIN_BF16 if mode else TOL_TRAIN_F32)
    torch.cuda.synchronize()
    print(f"  [dinov2-parity] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- serving: demo_torch with DINOv2, without GGS and with GGS from a table
    print("[dinov2-serve] demo_torch on samples/apple, modelname dinov2_vits14")
    matches = write_matches(os.path.join(work, "matches_dinov2_100.npz"), apple, 100, SEED + 100)
    # 20 frames at 100/pair: 19,000 matches take the chunked GGS kernel
    for what, extra, path in (("no GGS", ["GGS.enable=False"], DINOV2_SERVE_PATH),
                              ("GGS 100/pair", ["GGS.enable=True", f"GGS.matches_file={matches}"],
                               DINOV2_SERVE_PATH + ("ggs_phase_chunked",))):
        K.reset_launch_counts()
        out = demo_torch.run(demo_cfg(work, apple, DINOV2, *extra), dev.type)
        torch.cuda.synchronize()
        _check_launches(report, f"DINOv2 {what}", path, K.launch_counts())
        _check_cameras(report, out, imgs20.shape[0], f"DINOv2 {what}")
    print(f"  [dinov2-serve] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- training: train_torch.py with DINOv2 at the reference train config
    cfg = _train_cfg(work, "train_dinov2", DINOV2, "train.len_train=2")
    print("[dinov2-train] train_torch.py, modelname dinov2_vits14, cfgs/default_train.yaml: "
          + " ".join(TRAIN_OVERRIDES) + " train.len_train=2")
    shutil.rmtree(cfg.exp_dir, ignore_errors=True)
    K.reset_launch_counts()
    result = train_torch.run(cfg)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    _note_layernorm_shapes(K, "DINOv2 train path")
    linear_shapes = dict(K.linear.by_shape)
    _check_launches(report, "DINOv2 train", DINOV2_TRAIN_PATH, launches)
    print(f"  {result['steps']} steps, losses {[round(x, 5) for x in result['losses']]}, "
          f"step seconds (host clock) {[round(x, 3) for x in result['step_seconds']]}, "
          f"eval {result['eval']}")
    report.require("DINOv2 layerscale_bwd launches per train step",
                   launches["layerscale_bwd"] == LS_PER_STEP * result["steps"],
                   f"({launches['layerscale_bwd']} in {result['steps']} steps)")
    report.require("DINOv2 train losses finite", result["finite"])
    report.require("DINOv2 eval metrics finite", result["eval"] is not None
                   and all(np.isfinite(v) for v in result["eval"].values()))
    report.require("DINOv2 checkpoint written", bool(result["checkpoint"])
                   and os.path.exists(result["checkpoint"]))
    init = PoseDiffusionModel(cfg_model)
    init_random_weights(init, SEED)
    trained = PoseDiffusionModel(cfg_model)
    restore(result["checkpoint"], trained)
    moved = {k: (trained.state_dict()[k] - v).abs().max().item()
             for k, v in init.state_dict().items() if not k.startswith("diffuser.") or
             k.startswith("diffuser.model.")}
    gammas = {k: v for k, v in moved.items() if k.endswith(".gamma")}
    others = {k: v for k, v in moved.items() if not k.endswith(".gamma")}
    print(f"  from the checkpoint: {len(gammas)} gains, smallest change "
          f"{min(gammas.values()):.3e}; {sum(v > 0 for v in others.values())} of "
          f"{len(others)} other parameters moved, largest change {max(others.values()):.3e}")
    report.require("DINOv2 every LayerScale gain moved",
                   len(gammas) == 2 * cfg_model.vit_depth and min(gammas.values()) > 0)
    report.require("DINOv2 other parameters moved", max(others.values()) > 0)
    del init, trained
    print(f"  [dinov2-train] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- timings (CUDA events after warm-up)
    print(f"[dinov2-timing] card: {smi}")
    t = cfg.train
    batch, draws, _ = _train_batch(cfg, dev, model.config.timesteps)
    opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                            clip_grad=t.clip_grad)
    for plain in (False, True):
        with _route(V, plain):
            name = "DINOv2 train step " + ("plain route" if plain else "kernel route")
            step = lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws)  # noqa: E731
            timings[name] = _time_ms(torch, step, reps=2, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step = _step_launches(K, lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws))
    timings["DINOv2 peak memory of a train step (GB)"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches of one DINOv2 train step: {step}")
    report.require("DINOv2 train step: 24 layerscale_bwd launches",
                   step["layerscale_bwd"] == LS_PER_STEP, f"({step['layerscale_bwd']})")
    report.require("DINOv2 train step: as many linear launches as DINO's",
                   step["linear"] == dino_step_launches["linear"],
                   f"({step['linear']} and {dino_step_launches['linear']})")
    full = tok20.repeat(VIT_IMAGES // 20 + 1, 1, 1)[:VIT_IMAGES].contiguous()
    cot_full = rnd(*full.shape)
    for plain in (False, True):
        r = " plain" if plain else ""
        timings[f"DINOv2 vit trunk fwd+bwd{r}"] = _time_ms(
            torch, lambda: _trunk_grads(ls_run(False, plain), full, vst, cot_full), reps=2,
            warmup=1)
        with torch.no_grad():
            timings[f"DINOv2 vit trunk fwd{r}"] = _time_ms(
                torch, lambda: ls_run(False, plain)(full, vst), reps=2, warmup=1)
    del full, cot_full, batch, opt
    for name, kern, plain, (b_ms, b_by), _ in cases.values():
        timings[name] = _time_ms(torch, kern, reps=5)
        timings[f"{name} plain"] = _time_ms(torch, plain, reps=5)
        print(f"  {name}: kernel {timings[name]:.4f} ms, plain {timings[name + ' plain']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})")
    name, kern, plain, (b_ms, b_by), err = cases["linear+gain f32"]
    fc2_json = {
        "name": "linear f32 dinov2 fc2", "route": "cuda", "source": SOURCES["linear"],
        "replaces": TPU_KERNELS["linear"], "launches": linear_shapes.get((M, Fv, Dv, False), 0),
        "max_abs_err": err, "ms": timings[name], "plain_ms": timings[f"{name} plain"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **_linear_f32_device(torch, K, kern),
        "case": f"{name} (launches: DINOv2 train path, this shape)",
    }
    del cases, hm
    ls_ms = _time_ms(torch, lambda: K.layerscale_bwd(dy_ls, o_ls, gain, d_m2), reps=10)
    ls_plain_ms = _time_ms(torch, lambda: K.layerscale_bwd_plain(dy_ls, o_ls, gain, d_m2),
                           reps=10)
    ls_bound = bound(nbytes(dy_ls, o_ls, gain) + nbytes(dy_ls) + Dv * 4, 3 * M * Dv)
    ls_case = f"layerscale_bwd DINOv2 m2 ({M}x{Dv}, dropout 0.1)"
    timings[ls_case] = ls_ms
    timings[f"{ls_case} plain"] = ls_plain_ms
    del dy_ls, o_ls, res
    kernels_json = [fc2_json, {
        "name": "attention_bwd dinov2", "route": "cuda", "source": SOURCES["attention_bwd"],
        "replaces": TPU_KERNELS["attention_bwd"], "launches": launches["attention_bwd"],
        "max_abs_err": abwd_err, "bound_ms": ab_bound[0], "bound_by": ab_bound[1], **abwd,
        "case": f"{abwd_case} (launches: DINOv2 train path)",
    }, {
        "name": "layerscale_bwd", "route": "cuda", "source": SOURCES["layerscale_bwd"],
        "replaces": TPU_KERNELS["layerscale_bwd"], "launches": launches["layerscale_bwd"],
        "max_abs_err": ls_err, "ms": ls_ms, "plain_ms": ls_plain_ms, "bound_ms": ls_bound[0],
        "bound_by": ls_bound[1], "library_ms": None,
        "case": f"{ls_case} (launches: DINOv2 train path)",
    }]
    print(f"  {ls_case}: kernel {ls_ms:.4f} ms, plain {ls_plain_ms:.4f} ms, bound "
          f"{ls_bound[0]:.4f} ms ({ls_bound[1]})")
    L_v = 12
    w_vit = L_v * (4 * Dv * Dv + 2 * Dv * Fv)
    tb = trunk_bounds(M, Nv, Dv, Fv, L_v, 4, 4 * w_vit, saved=4)
    tt = timings
    rows = [
        (9, f"_fwd_call DINOv2 {VIT_IMAGES}x{Nv}, f32, LayerScale", tt["DINOv2 vit trunk fwd"],
         tt["DINOv2 vit trunk fwd plain"], tb[0], None),
        (10, f"_bwd_call DINOv2 {VIT_IMAGES}x{Nv}, f32, LayerScale (fwd+bwd less fwd)",
         tt["DINOv2 vit trunk fwd+bwd"] - tt["DINOv2 vit trunk fwd"],
         tt["DINOv2 vit trunk fwd+bwd plain"] - tt["DINOv2 vit trunk fwd plain"], tb[1], None),
    ]
    del model, vit, vst, tok, cot, tok20
    torch.cuda.empty_cache()
    print(f"  [dinov2-timing] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- DINO ViT-B/16: D 768, 12 heads, FF 3,072
    print("[vitb] fused_vit_trunk at D 768, layernorm_bwd at D 768, one train step")
    cfg_b = model_config_from_cfg(load_config("default_train", [VITB]).MODEL)
    vitb_model = PoseDiffusionModel(cfg_b)
    init_random_weights(vitb_model, SEED)
    vitb_model.to(dev)
    vitb = vitb_model.image_feature_extractor._net
    Db, Fb = vitb.embed_dim, 4 * vitb.embed_dim
    with torch.no_grad():
        tokb, biasb, _ = _embed_pack_scales(vitb, imgs20, cfg_b.scale_factors)
        for wdt, act, tol in ((torch.float32, False, TOL_VIT_F32),
                              (torch.bfloat16, True, TOL_VIT_BF16)):
            st = stack_vit_params(vitb, wdt)
            err = (fused_vit_trunk(tokb, st, 12, act, biasb)
                   - fused_vit_trunk_plain(tokb, st, 12, act, biasb)).abs().max().item()
            report.check(f"ViT-B fused_vit_trunk {'bf16' if act else 'f32'} (12 blocks, "
                         f"{tuple(tokb.shape)}, 12 heads)", err, tol)
        stb = stack_vit_params(vitb, torch.bfloat16)
        timings["ViT-B vit trunk (fused_vit_trunk, bf16, 20x264x768)"] = _time_ms(
            torch, lambda: fused_vit_trunk(tokb, stb, 12, True, biasb))
        timings["ViT-B vit trunk plain (fused_vit_trunk_plain, bf16)"] = _time_ms(
            torch, lambda: fused_vit_trunk_plain(tokb, stb, 12, True, biasb))
    Mb = VIT_IMAGES * tokb.shape[1]
    x_ln, dh_ln, res_ln = rnd(Mb, Db), rnd(Mb, Db), rnd(Mb, Db)
    g_ln = 1 + 0.1 * rnd(Db)
    out_k = K.layernorm_bwd(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln)
    out_p = K.layernorm_bwd_plain(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln)
    lnb_err = max(_close_rel(report, f"layernorm_bwd {part} ViT-B ({Mb}x{Db})", a, b, TOL_F32)
                  for part, a, b in zip(("dx", "dg", "db"), out_k, out_p))
    again = K.layernorm_bwd(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln)
    report.require(f"layernorm_bwd ViT-B ({Mb}x{Db}) dx, dg and db repeat bitwise",
                   all(torch.equal(a, b) for a, b in zip(out_k, again)))
    lnb = f"layernorm_bwd ViT-B ({Mb}x{Db}, + residual)"
    lnb_call = lambda: K.layernorm_bwd(x_ln, g_ln, dh_ln, 1e-6, residual=res_ln)  # noqa: E731
    timings[lnb] = _time_ms(torch, lnb_call, reps=5)
    timings[f"{lnb} plain"] = _time_ms(torch, lambda: K.layernorm_bwd_plain(
        x_ln, g_ln, dh_ln, 1e-6, residual=res_ln), reps=5)
    b0 = torch.zeros(Db, device=dev)
    timings[f"{lnb} F.layer_norm backward"] = _library_grad_ms(
        torch, lambda x, g: F.layer_norm(x, (Db,), g, b0, 1e-6), [x_ln, g_ln], dh_ln)
    lnb_bound = bound(nbytes(x_ln, dh_ln, res_ln, g_ln) + nbytes(x_ln) + 2 * Db * 4, 12 * Mb * Db)
    lnb_json = {
        "name": "layernorm_bwd vitb", "route": "cuda", "source": SOURCES["layernorm_bwd"],
        "replaces": TPU_KERNELS["layernorm_bwd"], "max_abs_err": lnb_err, "ms": timings[lnb],
        "plain_ms": timings[f"{lnb} plain"], "bound_ms": lnb_bound[0],
        "bound_by": lnb_bound[1], "library_ms": timings[f"{lnb} F.layer_norm backward"],
        "device_ms": _kernel_device_ms(torch, lnb_call, None),
        "case": f"{lnb} (launches: one ViT-B train step)",
    }
    print(f"  {lnb}: kernel {timings[lnb]:.4f} ms, plain {timings[lnb + ' plain']:.4f} ms, "
          f"F.layer_norm backward {lnb_json['library_ms']:.4f} ms, bound "
          f"{lnb_bound[0]:.4f} ms ({lnb_bound[1]})")
    del out_k, out_p, again, x_ln, dh_ln, res_ln
    torch.cuda.empty_cache()
    cfg_vb = _train_cfg(work, "train_vitb", VITB)
    batch, draws, _ = _train_batch(cfg_vb, dev, cfg_b.timesteps)
    tb_ = cfg_vb.train
    opt, _ = make_optimizer(vitb_model, lr=tb_.lr, T_0=tb_.restart_num,
                            iters_per_epoch=tb_.len_train, clip_grad=tb_.clip_grad)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    m = train_step(vitb_model, opt, batch, tb_.batch_repeat, draws=draws)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    vitb_step = K.launch_counts()
    _note_layernorm_shapes(K, "one ViT-B train step")
    lnb_json["launches"] = vitb_step["layernorm_bwd"]
    kernels_json.append(lnb_json)
    print(f"  launches of one ViT-B train step: {vitb_step}")
    timings["ViT-B peak memory of a train step (GB)"] = torch.cuda.max_memory_allocated() / 1e9
    report.require("ViT-B train step loss finite", np.isfinite(m["loss"]), f"({m['loss']:.5f})")
    timings["ViT-B train step kernel route (512 images, batch_repeat 90)"] = _time_ms(
        torch, lambda: train_step(vitb_model, opt, batch, tb_.batch_repeat, draws=draws),
        reps=1, warmup=0)
    print(f"  ViT-B first train step {first * 1e3:.1f} ms (host clock); loss {m['loss']:.5f}")
    Pb, Ab = block_flops(20 * tokb.shape[1], tokb.shape[1], Db, Fb)
    w_b = 12 * (4 * Db * Db + 2 * Db * Fb)
    rows.append((1, "fused_vit_trunk ViT-B 20x264x768, bf16",
                 timings["ViT-B vit trunk (fused_vit_trunk, bf16, 20x264x768)"],
                 timings["ViT-B vit trunk plain (fused_vit_trunk_plain, bf16)"],
                 max(bound(2 * nbytes(tokb) + 2 * w_b, 0)[0], 12 * (Pb + Ab) / PEAK_BF16 * 1e3),
                 None))
    del vitb_model, vitb, opt, batch
    torch.cuda.empty_cache()
    for name, v in timings.items():
        print(f"  {name}: {v:.3f}{'' if '(GB)' in name else ' ms'}")
    print(f"  [vitb] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return kernels_json, timings, rows, {"DINOv2": step, "ViT-B": vitb_step}


def attention_slice(report, dev, smi):
    """Every attention forward the port runs, at its path's shape: the kernel
    against its plain version (and against itself, bitwise), then its time
    (CUDA events around the call, and the kernel's device time alone, which
    is what the short cases' host-bound calls hide) beside the plain
    version's, SDPA's (float32, and bf16 operands as a second yardstick for
    the bf16-mode cases) and its bound. Returns {case: numbers}."""
    import torch
    import torch.nn.functional as F

    from posediffusion_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731

    def packing(lengths):  # the block-diagonal bias of scales packed in one row
        seg = torch.cat([torch.full((n,), i, device=dev) for i, n in enumerate(lengths)])
        return torch.where(seg[:, None] == seg[None], 0.0, K.NEG).contiguous()

    def key_mask(B, N, least, neg):  # the first 'least'..N keys of each sequence live
        live = torch.arange(N, device=dev)[None] < torch.randint(
            least, N + 1, (B, 1), generator=gen, device=dev)
        return torch.where(live, 0.0, neg).contiguous()

    sg_self = key_mask(2 * SG_PAIRS, MATCH_KEYPOINTS, int(0.6 * MATCH_KEYPOINTS), K.SG_NEG)
    sg_cross = sg_self.view(SG_PAIRS, 2, -1).flip(1).reshape(2 * SG_PAIRS, -1).contiguous()
    den = torch.zeros(1, 20, device=dev)
    den[:, -3:] = K.NEG
    d_attn = K.drop_args(SEED, 0, "attn", 0.1)
    # (name, qkv, heads, kwargs)
    cases = [
        ("row 4: SuperGlue self 64x1024, 4 heads of 64, f32, key mask",
         rnd(2 * SG_PAIRS, MATCH_KEYPOINTS, 768), 4, dict(key_bias=sg_self)),
        ("SuperGlue cross 64x1024, 4 heads of 64, f32, key mask",
         rnd(2 * SG_PAIRS, MATCH_KEYPOINTS, 768), 4, dict(key_bias=sg_cross)),
        ("row 5: ViT 20x264, 6 heads of 64, bf16 mode, packing bias",
         rnd(20, 264, 1152), 6, dict(attn_bias=packing((197, 50, 17)), round_in=True)),
        ("ViT 336px 20x593, 6 heads of 64, bf16 mode, packing bias",
         rnd(20, 593, 1152), 6, dict(attn_bias=packing((442, 101, 50)), round_in=True)),
        ("denoiser 1x20, 4 heads of 128, f32, key bias",
         rnd(1, 20, 1536), 4, dict(key_bias=den)),
        ("ViT 20x264, 6 heads of 64, f32, packing bias",
         rnd(20, 264, 1152), 6, dict(attn_bias=packing((197, 50, 17)))),
        ("DINOv2 20x348, 6 heads of 64, f32, packing bias",
         rnd(20, 348, 1152), 6, dict(attn_bias=packing((257, 65, 26)))),
        (f"train ViT {VIT_IMAGES}x264, 6 heads of 64, f32, dropout 0.1",
         rnd(VIT_IMAGES, 264, 1152), 6, dict(attn_bias=packing((197, 50, 17)), drop=d_attn)),
        (f"train encoder {ENC_ROWS}x16, 4 heads of 128, f32, key bias, dropout 0.1",
         rnd(ENC_ROWS, 16, 1536), 4, dict(key_bias=key_mask(ENC_ROWS, 16, 8, K.NEG),
                                          drop=d_attn)),
    ]
    print(f"[attention] every attention forward of the port, card: {smi}")
    out = {}
    with torch.no_grad():
        for name, qkv, H, kw in cases:
            bf16 = kw.get("round_in", False)
            y = K.attention(qkv, H, **kw)
            err = _close_rel(report, f"attention {name}", y, K.attention_plain(qkv, H, **kw),
                             TOL_BF16 if bf16 else TOL_F32)
            report.require(f"attention {name}: two calls bitwise equal",
                           torch.equal(y, K.attention(qkv, H, **kw)))
            del y
            B, N, D3 = qkv.shape
            inner = 10 if B * N * N < 1 << 24 else 1
            row = {"max_abs_err": err}
            row["ms"] = _time_ms(torch, lambda: K.attention(qkv, H, **kw), inner=inner)
            row["device_ms"] = _kernel_device_ms(torch, lambda: K.attention(qkv, H, **kw))
            row["plain_ms"] = _time_ms(torch, lambda: K.attention_plain(qkv, H, **kw),
                                       reps=5, inner=inner)
            bias_key = "attn_bias" if "attn_bias" in kw else "key_bias"
            if not bf16 and bias_key in kw:
                # masked entries at -1e7, above the kernel's skip threshold:
                # the same function (e = 0 either way), no tile skipped
                kw_all = dict(kw, **{bias_key: kw[bias_key].clamp_min(-1e7)})
                report.require(f"attention {name}: skipping masked tiles changes no bit",
                               torch.equal(K.attention(qkv, H, **kw),
                                           K.attention(qkv, H, **kw_all)))
                row["ms_no_skip"] = _time_ms(torch, lambda: K.attention(qkv, H, **kw_all),
                                             inner=inner)
            q, k, v = qkv.view(B, N, 3, H, D3 // 3 // H).permute(2, 0, 3, 1, 4)
            bias = kw.get("attn_bias")
            if "key_bias" in kw:
                bias = kw["key_bias"][:, None, None, :]
            # SDPA has no dropout of the normalised p with a given mask: no
            # yardstick for the train cases
            if "drop" not in kw:
                row["sdpa_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias), inner=inner)
                if bf16:
                    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
                    bb = bias.to(torch.bfloat16)
                    row["sdpa_bf16_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qb, kb, vb, attn_mask=bb), inner=inner)
            row["bound_ms"], row["bound_by"] = attention_bound(
                qkv, kw.get("attn_bias"), kw.get("key_bias"), bf16)
            out[name] = row
            print(f"  {name}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
                flush=True)
            del q, k, v
    del cases
    torch.cuda.empty_cache()
    return out


def ddim_slice(report, dev, work, t_start, model, images, x0, noises, gen, matches100,
               cond100, cond100_plain):
    """[ddim] DDIM (``model.sample(sampling_timesteps=DDIM_STEPS)``) and the
    pred_x0 objective: the DDIM chain on kernel 3 against its plain route
    (one step tightly, DDIM_STEPS steps at eta 0 and 1 and with GGS by the
    chaos rule); the pred_x0 whole-loop sampler's entries at steps 0 and 98
    and its 100-step chain against plain; then the DDIM path driven through
    ``model.sample`` at eta 0, eta 1 and with GGS from a 100/pair table
    (counts set to 0 just before): DDIM_STEPS fused_trunk passes an
    inference and no sampler launch, the ViT's kernels and the GGS kernels
    launched, finite encodings; their CUDA-event times; last one DINO train
    step at pred_x0 / l2 on a cut batch (kernels 9 and 10): loss finite,
    parameters moved. Returns (timings, launches of the DDIM path, launches
    of the pred_x0 train step)."""
    import torch

    from posediffusion_tpu_torch.diffusion import ggs as G
    from posediffusion_tpu_torch.diffusion.gaussian import ddim_sample_loop
    from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera
    from posediffusion_tpu_torch.models.denoiser import denoiser_apply_fused
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.denoiser_kernel import (
        fused_trunk,
        fused_trunk_plain,
        stack_trunk_params,
    )
    from posediffusion_tpu_torch.ops.sampler_kernel import (
        fused_sample_loop,
        fused_sample_loop_plain,
        prepare_sampler,
    )

    print(f"[ddim] DDIM at {DDIM_STEPS} steps and the pred_x0 objective, 20 frames, 224px",
          flush=True)
    den = model.diffuser.model
    S, n = DDIM_STEPS, images.shape[0]
    imgs = images[None]
    d_noises = torch.randn((S, 1, n, 9), generator=gen, device=dev)
    moved = x0 + CHAOS_PERTURBATION * torch.randn(x0.shape, generator=gen, device=dev)
    with torch.no_grad():
        z = model.extract_features(imgs)
        stk = stack_trunk_params(den._trunk, model.weight_dtype)

        def chain(trunk, start, steps, eta, cond=None):
            fn = lambda xt, t: denoiser_apply_fused(den, xt, t, z, None, stk,  # noqa: E731
                                                    trunk=trunk)
            return ddim_sample_loop(model.schedule, fn, start.shape, dev, steps, eta, x0=start,
                                    noises=d_noises[:steps], cond_fn=cond,
                                    cond_start_step=DDIM_COND_START)

        err = (chain(fused_trunk, x0, 1, 0.0) - chain(fused_trunk_plain, x0, 1, 0.0)).abs()
        report.check("DDIM one step (t 99 -> -1), fused_trunk vs plain", err.max().item(),
                     TOL_STEPS[1])
        for what, eta, cond, cond_plain, floor in (
                ("eta 0", 0.0, None, None, TOL_STEPS[10]),
                ("eta 1", 1.0, None, None, TOL_STEPS[10]),
                ("eta 0, GGS 100/pair", 0.0, cond100, cond100_plain, TOL_GGS_TAIL)):
            ref = chain(fused_trunk_plain, x0, S, eta, cond_plain)
            spread = (chain(fused_trunk_plain, moved, S, eta, cond_plain) - ref).abs().max().item()
            err = (chain(fused_trunk, x0, S, eta, cond) - ref).abs().max().item()
            report.check(f"DDIM {S} steps {what} (plain chain spread under a "
                         f"{CHAOS_PERTURBATION:.1e} x0 perturbation: {spread:.2e})",
                         err, max(floor, CHAOS_FACTOR * spread))

        # the whole-loop sampler at pred_x0: per-step scalars (c2, -c1)
        inp = prepare_sampler(den, model.schedule, z, weight_dtype=model.weight_dtype, x0=x0,
                              noises=noises, objective="pred_x0")
        sampler_parity(report, torch, K, inp, "bf16 pred_x0", n)

        def loop(fn, start):
            return fn(den, model.schedule, z, weight_dtype=model.weight_dtype, x0=start,
                      noises=noises, objective="pred_x0")

        ref = loop(fused_sample_loop_plain, x0)
        spread = (loop(fused_sample_loop_plain, moved) - ref).abs().max().item()
        err = (loop(fused_sample_loop, x0) - ref).abs().max().item()
        report.check(f"pred_x0 whole-loop sampler, 100 steps (plain chain spread under a "
                     f"{CHAOS_PERTURBATION:.1e} x0 perturbation: {spread:.2e})",
                     err, max(TOL_STEPS[100], CHAOS_FACTOR * spread))

    # the DDIM path through model.sample, counts set to 0 just before
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    cond = G.build_cond_fn(*matches100, n, hw, G.GGSConfig(), dev)
    runs = {"eta 0": dict(ddim_eta=0.0), "eta 1": dict(ddim_eta=1.0),
            "eta 0, GGS 100/pair": dict(cond_fn=cond, cond_start_step=DDIM_COND_START)}
    passes = {}
    K.reset_launch_counts()
    fused_trunk.launches = 0
    for what, kw in runs.items():
        before = fused_trunk.launches
        enc = model.sample(imgs, x0=x0, noises=d_noises, sampling_timesteps=S, **kw)
        torch.cuda.synchronize()
        passes[what] = fused_trunk.launches - before
        cams = pose_encoding_to_camera(enc)
        finite = all(bool(torch.isfinite(t).all()) for t in (enc, cams.R, cams.T))
        report.require(f"DDIM {what}: finite encodings and cameras of shape (1, {n}, 9)",
                       finite and tuple(enc.shape) == (1, n, 9))
    launches = K.launch_counts()
    print(f"  launches during the DDIM path (3 inferences): {launches}; fused_trunk passes "
          f"{passes}")
    _check_launches(report, "DDIM", DDIM_PATH, launches)
    report.require(f"a DDIM inference is {S} fused_trunk passes", all(
        v == S for v in passes.values()), f"({passes})")
    report.require("the DDIM path launches no sampler entry",
                   all(launches[k] == 0 for k in SAMPLER_ENTRIES))
    report.require("the DDIM path with GGS launches the GGS kernels",
                   launches["ggs_phase"] + launches["ggs_phase_chunked"] > 0)
    with torch.no_grad():
        timings = {
            f"DDIM-{S} inference (extract + {S} steps, eta 0)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=d_noises,
                                            sampling_timesteps=S), reps=5),
            f"DDIM-{S} inference with GGS (100/pair, last step conditioned)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=d_noises, sampling_timesteps=S,
                                            cond_fn=cond, cond_start_step=DDIM_COND_START),
                reps=5),
        }
    for name, ms in timings.items():
        print(f"  {name}: {ms:.3f} ms", flush=True)
    train_launches = pred_x0_train_step(report, torch, K, dev, work)
    print(f"  [ddim] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return timings, {**launches, "fused_trunk passes": passes}, train_launches


def pred_x0_train_step(report, torch, K, dev, work):
    """One DINO train step at MODEL.DIFFUSER.objective=pred_x0 and
    loss_type=l2 on a cut batch (PRED_X0_IMAGES images): loss finite, the
    parameters moved, the train kernels launched. Returns its launches."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg

    cfg = _train_cfg(work, "train_x0", "MODEL.DIFFUSER.objective=pred_x0",
                     "MODEL.DIFFUSER.loss_type=l2", f"train.max_images={PRED_X0_IMAGES}")
    t = cfg.train
    model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    report.require("the train config maps pred_x0 / l2",
                   (model.config.objective, model.config.loss_type) == ("pred_x0", "l2"))
    init_random_weights(model, SEED)
    model.to(dev)
    batch, draws, n_rows = _train_batch(cfg, dev, model.config.timesteps)
    opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                            clip_grad=t.clip_grad)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = []
    launches = _step_launches(K, lambda: out.append(
        train_step(model, opt, batch, t.batch_repeat, draws=draws)))
    change = max((p.detach() - start[k]).abs().max().item() for k, p in model.named_parameters())
    report.require("pred_x0 / l2 train step: loss finite", bool(np.isfinite(out[0]["loss"])),
                   f"(loss {out[0]['loss']})")
    report.require("pred_x0 / l2 train step: parameters moved", change > 0,
                   f"(largest {change:.3e})")
    _check_launches(report, "pred_x0 / l2 train step", TRAIN_PATH, launches)
    B, F = batch["images"].shape[:2]
    print(f"  pred_x0 / l2 train step ({B} sequences x {F} frames, {n_rows} diffusion "
          f"sequences): loss {out[0]['loss']:.6f}, largest parameter change {change:.3e}",
          flush=True)
    del model, opt, start, batch
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


def match_stages(torch, cfg, paths, hw, dev, rounds=MATCH_SPLIT_ROUNDS):
    """A sequence's match extraction as ``demo_torch.get_matches`` runs it
    for test_torch.py, stage by stage under a ``PhaseTimer`` (a
    synchronize at each stage's end): loading the MagicLeap weights, the
    frames' decode (host), SuperPoint (cuDNN, top-k), SuperGlue (the
    kernels, then its matches to the host), RANSAC (host) and the GGS
    tables (``build_cond_fn``); the first round warms up, the others are
    averaged. The stages are extract_match's own calls, in its order, with
    the config's arguments and demo_torch's defaults. Returns {stage: ms}."""
    from posediffusion_tpu_torch.diffusion.ggs import build_cond_fn
    from posediffusion_tpu_torch.matching import extract as X
    from posediffusion_tpu_torch.utils.config import build_ggs_config
    from posediffusion_tpu_torch.utils.profiling import PhaseTimer

    g = cfg.GGS
    n = len(paths)
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    timer = PhaseTimer()
    for r in range(rounds + 1):
        t = timer if r else PhaseTimer()
        with t.phase("matcher weights (load)"):
            sp, sg = X.load_matcher_weights(str(g.matcher_ckpt_dir), dev)
        with t.phase("decode (host)"):
            grays, sizes = X.load_grays(paths)
        with t.phase("SuperPoint"):
            feats = X.detect_frames(sp, grays, int(g.get("max_keypoints", 4096)))
        with t.phase("SuperGlue"):
            kpts, matches = X.match_all_pairs(sg, feats, sizes, pairs, 50,
                                              float(g.get("match_threshold", 0.2)))
        with t.phase("RANSAC (host)"):
            kp1, kp2, i12 = X.verify_pairs(kpts, matches, pairs, n,
                                           float(g.get("ransac_threshold_px", 4.0)),
                                           int(g.get("min_pair_matches", 8)))
        with t.phase("GGS tables (build_cond_fn)"):
            build_cond_fn(np.concatenate(kp1), np.concatenate(kp2), np.concatenate(i12), n, hw,
                          build_ggs_config(g), dev)
    print("  a sequence's match extraction by stage (PhaseTimer, "
          f"{rounds} rounds after one warm-up):\n    "
          + timer.summary().replace("\n", "\n    "))
    return {name: 1e3 * timer.totals[name] / timer.counts[name] for name in timer.totals}


def eval_slice(report, dev, work, t_start, wdir):
    """[eval] test_torch.main, the Co3D evaluation, on the Co3D-format tree
    of samples/apple (one category, one sequence of 20 frames) at
    default_test.yaml's 10 frames and 224px, GGS from matches extracted
    from the images with random MagicLeap weights (``wdir``), EVAL_RUNS
    times (the later runs time a sequence without first-call costs); counts
    set to 0 just before. The results JSON finite with test.py's keys, every
    kernel of the path launched; then the last sequence's match extraction
    split into its stages (``match_stages``). Returns (timings, launches)."""
    import torch

    import test_torch
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.denoiser_kernel import fused_trunk

    print("[eval] test_torch.main on a Co3D tree of samples/apple, 10 frames, GGS from the "
          "images", flush=True)
    co3d_dir, ann_dir = write_co3d_tree(os.path.join(REPO, "build", "co3d_apple"),
                                        os.path.join(REPO, "samples", "apple"))
    results = os.path.join(work, "eval_results.json")
    args = [f"test.CO3D_DIR={co3d_dir}", f"test.CO3D_ANNOTATION_DIR={ann_dir}",
            "test.category=apple", "test.min_num_images=20", f"seed={SEED}",
            f"results_file={results}", "GGS.enable=True", f"GGS.matcher_ckpt_dir={wdir}",
            *MATCH_ARGS]
    records = []
    K.reset_launch_counts()
    fused_trunk.launches = 0
    for _ in range(EVAL_RUNS):
        test_torch.main(args, records)
    torch.cuda.synchronize()
    launches = {**K.launch_counts(), "fused_trunk passes": fused_trunk.launches}
    print(f"  launches during the eval path ({EVAL_RUNS} runs): {launches}")
    _check_launches(report, "eval", EVAL_PATH, launches)
    report.require("the eval path launches a GGS kernel",
                   launches["ggs_phase"] + launches["ggs_phase_chunked"] > 0)
    report.require("the eval path runs fused_trunk (the GGS tail)", fused_trunk.launches > 0)
    with open(results) as f:
        saved = json.load(f)
    values = [v for m in test_torch.METRIC_NAMES for v in saved.get(m, {}).values()]
    report.require("eval results: test.py's keys, the category and the mean, all finite",
                   list(saved) == test_torch.METRIC_NAMES
                   and all(set(saved[m]) == {"apple", "mean"} for m in saved)
                   and all(np.isfinite(v) for v in values), f"({saved})")
    report.require(f"eval: {EVAL_RUNS} sequences sampled with GGS",
                   len(records) == EVAL_RUNS and all(r["ggs"] for r in records))
    report.require("eval: finite encodings and errors", all(
        np.isfinite(r["pose_encoding"]).all() and np.isfinite(r["r_deg"]).all()
        and np.isfinite(r["t_deg"]).all() for r in records))
    seconds = [r["seconds"] for r in records]
    matching = [r["match_seconds"] for r in records]
    timings = {"eval sequence sampling, first run (10 frames, GGS; ms)": 1e3 * seconds[0],
               "eval sequence sampling, repeat (10 frames, GGS; ms)":
               1e3 * statistics.median(seconds[1:]),
               "eval sequence matches, repeat (10 frames, from the images; ms)":
               1e3 * statistics.median(matching[1:])}
    print(f"  a sequence's sampling {[round(1e3 * s, 2) for s in seconds]} ms, its matches "
          f"{[round(1e3 * s, 2) for s in matching]} ms (first run, then repeats); Racc_30 "
          f"{saved['Racc_30']['apple']:.3f}, AUC_30 "
          f"{saved['Auc_30']['apple']:.3f} (random weights)")
    # the frames of the last sequence, as Co3dDataset.get_data orders them
    from posediffusion_tpu_torch.utils.config import load_config

    cfg = load_config("default_test", args)
    seq_dir = os.path.join(co3d_dir, "apple", "seq0")
    names = sorted(f for f in os.listdir(seq_dir) if f.lower().endswith(".jpg"))
    paths = sorted(os.path.join(seq_dir, names[i]) for i in records[-1]["ids"])
    hw = (int(cfg.test.img_size), int(cfg.test.img_size))
    for stage, ms in match_stages(torch, cfg, paths, hw, dev).items():
        timings[f"eval sequence matches: {stage} (ms)"] = ms
    print(f"  [eval] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return timings, launches


def _device_ms_and_launches(torch, fn, calls=3):
    """(device ms, kernels and copies launched) per call of ``fn``, from
    torch.profiler's CUDA activity after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls)


def resnet_conv_flops(torch, net, fn):
    """The operations (2 x multiply-adds) of every convolution of ``net``
    that ``fn`` runs: the ResNet extractor's work, nearly all of it."""
    total = [0]

    def count(mod, inp, out):
        kh, kw = mod.kernel_size
        total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resnet_slice(report, dev, work, smi, t_start):
    """[resnet] and [viz]: the ResNet backbones serving on the card, at
    cfgs/default.yaml's 224px, three scales and 20 frames of samples/apple,
    seeded random weights: demo_torch with ResNet-50 without GGS and with
    GGS from a 100/pair matches table, ResNet-101 without GGS, ResNet-50 at
    compute_dtype=bfloat16 without GGS, each run's counts set to 0 just
    before it and its path's kernels required; the sampler's three entries
    (kernel 2) on ResNet-50's zf against their plain versions; each
    inference's and extractor's time (CUDA events after warm-up) beside the
    extractor's convolutions' bound; [viz]: the ResNet-50 run's
    cameras.html and, where matplotlib imports, cameras.png. Returns
    (kernel JSON entries, timings, launches by run)."""
    import torch

    import demo_torch
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.diffusion import ggs as G
    from posediffusion_tpu_torch.models.feature_extractor import extract_features_resnet
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.sampler_kernel import prepare_sampler
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    print("[resnet] demo_torch on samples/apple: ResNet-50 without and with GGS (100/pair), "
          "ResNet-101, ResNet-50 at compute_dtype=bfloat16", flush=True)
    apple = os.path.join(REPO, "samples", "apple")
    imgs = torch.as_tensor(load_and_preprocess_images(apple, IMAGE_SIZE)[0], device=dev)[None]
    n = imgs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    x0 = torch.randn((1, n, 9), generator=gen, device=dev)
    matches = write_matches(os.path.join(work, "matches_resnet_100.npz"), apple, 100, SEED + 100)
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    m_np = np.load(matches)
    cond = G.build_cond_fn(m_np["kp1"], m_np["kp2"], m_np["i12"], n, hw, G.GGSConfig(), dev)
    out_dir = os.path.join(work, "out_resnet")
    shutil.rmtree(out_dir, ignore_errors=True)
    runs = (("ResNet-50", (RESNET50,), ("GGS.enable=False",), RESNET_SERVE_PATH),
            ("ResNet-50 GGS 100/pair", (RESNET50,),
             ("GGS.enable=True", f"GGS.matches_file={matches}"),
             RESNET_SERVE_PATH + ("ggs_phase_chunked",)),
            ("ResNet-101", (RESNET101,), ("GGS.enable=False",), RESNET_SERVE_PATH),
            ("ResNet-50 bf16", (RESNET50, RESNET_BF16), ("GGS.enable=False",),
             RESNET_SERVE_PATH))
    timings, launches, models = {}, {}, {}
    for what, model_args, ggs_args, path in runs:
        K.reset_launch_counts()
        out = demo_torch.run(demo_cfg(work, apple, *model_args, *ggs_args,
                                      f"out_dir={out_dir}"), dev.type)
        torch.cuda.synchronize()
        launches[what] = K.launch_counts()
        _check_launches(report, what, path, launches[what])
        _check_cameras(report, out, n, what)
        if what == "ResNet-50":
            viz_check(report, out, out_dir)
        if model_args not in models:
            model = PoseDiffusionModel(model_config_from_cfg(
                load_config("default", list(model_args)).MODEL))
            init_random_weights(model, SEED)
            models[model_args] = model.to(dev)
        model = models[model_args]
        noises = torch.randn((model.config.timesteps, 1, n, 9), generator=gen, device=dev)
        c_fn, c_start = (cond, 10) if "GGS" in what else (None, 0)
        with torch.no_grad():
            ms = _time_ms(torch, lambda: model.sample(imgs, x0=x0, noises=noises, cond_fn=c_fn,
                                                      cond_start_step=c_start), reps=5)
            timings[f"{what} inference (20 frames, 224px; ms)"] = ms
            if c_fn is None:
                net = model.image_feature_extractor._net
                ext = _time_ms(torch, lambda: model.extract_features(imgs), reps=5)
                # counted on the float32 route: the bf16 route runs the same
                # convolutions (on rounded operands), outside the modules' forward
                flops = resnet_conv_flops(torch, net, lambda: extract_features_resnet(
                    net, imgs[0], model.config.scale_factors))
                b_ms = flops / PEAK_F32 * 1e3
                dev_ms, n_launch = _device_ms_and_launches(
                    torch, lambda: model.extract_features(imgs))
                timings[f"{what} extractor (ms)"] = ext
                timings[f"{what} extractor device (ms, profiler)"] = dev_ms
                timings[f"{what} extractor launches (kernels and copies)"] = n_launch
                timings[f"{what} extractor convolutions (GFLOP)"] = flops / 1e9
                timings[f"{what} extractor bound (ms, ops at the float32 rate)"] = b_ms
                print(f"  {what}: inference {ms:.3f} ms, extractor {ext:.3f} ms "
                      f"({100 * ext / ms:.1f}% of it; {flops / 1e9:.1f} GFLOP of convolutions, "
                      f"bound {b_ms:.3f} ms, {100 * b_ms / ext:.1f}% of it); the extractor's "
                      f"device time {dev_ms:.3f} ms in {n_launch:.0f} launches "
                      f"({100 * (1 - dev_ms / ext):.1f}% of its wall time the card is idle)")
            else:
                print(f"  {what}: inference {ms:.3f} ms")
    print(f"  launches of the ResNet runs ({DEMO_INFERENCES} inferences each): {launches}")
    report.require("ResNet serving: no ViT kernel (layernorm, linear) on the path",
                   all(launches[w]["layernorm"] == 0 and launches[w]["linear"] == 0
                       for w in launches), "")

    # kernel 2's entries on ResNet-50's 2,048-wide features (projected to zf
    # by prepare_sampler's plain product), against their plain versions
    model = models[(RESNET50,)]
    with torch.no_grad():
        z = model.extract_features(imgs)
        report.require("ResNet-50 features (1, 20, 2048), finite",
                       tuple(z.shape) == (1, n, 2048) and bool(torch.isfinite(z).all()))
        noises = torch.randn((model.config.timesteps, 1, n, 9), generator=gen, device=dev)
        inp = prepare_sampler(model.diffuser.model, model.schedule, z,
                              weight_dtype=model.weight_dtype, x0=x0, noises=noises)
        kernels_json = []
        for key, (name, args, err) in sampler_parity(report, torch, K, inp, "resnet50 bf16",
                                                     n).items():
            kern, plain = getattr(K, key), getattr(K, f"{key}_plain")
            args_k = [a.clone() if torch.is_tensor(a) else a for a in args]
            b_ms, b_by = sampler_bound(key, args)
            kernels_json.append({
                "name": f"{key} resnet50", "route": "cuda", "source": SOURCES[key],
                "replaces": TPU_KERNELS[key], "launches": launches["ResNet-50"][key],
                "max_abs_err": err, "ms": _time_ms(torch, lambda: kern(*args_k), inner=10),
                "plain_ms": _time_ms(torch, lambda: plain(*args_k), inner=10),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "case": f"{name} on ResNet-50's zf (launches: the ResNet-50 no-GGS path, "
                        f"{DEMO_INFERENCES} inferences)",
            })
            print(f"  {kernels_json[-1]['name']}: {kernels_json[-1]}")
    del models, model, inp, z
    torch.cuda.empty_cache()
    print(f"  [resnet] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return kernels_json, timings, launches


def viz_check(report, out, out_dir):
    """[viz] demo_torch's plots: cameras.html always, cameras.png where
    matplotlib imports (else the demo said it skipped it)."""
    html, png = (os.path.join(out_dir, f) for f in ("cameras.html", "cameras.png"))
    try:
        import matplotlib  # noqa: F401

        has_mpl = True
    except ImportError:
        has_mpl = False
    print(f"[viz] {out['plots']} (matplotlib {'found' if has_mpl else 'not installed'})")
    report.require("[viz] cameras.html written and not empty",
                   os.path.isfile(html) and os.path.getsize(html) > 0)
    if has_mpl:
        report.require("[viz] cameras.png written and not empty",
                       os.path.isfile(png) and os.path.getsize(png) > 0)
    else:
        report.require("[viz] no cameras.png without matplotlib", png not in out["plots"])


def resnet_train_slice(report, dev, work, smi, t_start):
    """[resnet-train] ResNet-50 train steps at cfgs/default_train.yaml on the
    Co3D tree of samples/apple, the step cut from 512 images to
    RESNET_TRAIN_IMAGES (the extractor's activations for its backward, in
    float32, would not fit 512): one step's launches (the denoiser on the
    encoder train trunk, kernels 9-10), each size's step time (CUDA events,
    three after one warm-up) and peak memory (``device_memory_stats``), the
    losses finite, every BatchNorm statistic and the other parameters moved
    over the steps. Returns (timings, the launches of one step)."""
    import torch

    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg
    from posediffusion_tpu_torch.utils.profiling import device_memory_stats

    print(f"[resnet-train] ResNet-50 train steps, cfgs/default_train.yaml cut to "
          f"{' and '.join(map(str, RESNET_TRAIN_IMAGES))} images a step", flush=True)
    cfg = _train_cfg(work, "train_resnet", RESNET50)
    t = cfg.train
    model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    init_random_weights(model, SEED)
    model.to(dev)
    opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                            clip_grad=t.clip_grad)
    initial = {k: p.detach().clone() for k, p in model.named_parameters()}
    timings, step_launches, losses = {}, None, []
    for n_img in RESNET_TRAIN_IMAGES:
        batch, draws, rows = _train_batch(
            _train_cfg(work, "train_resnet", RESNET50, f"train.max_images={n_img}"), dev,
            model.config.timesteps)

        def step():
            losses.append(train_step(model, opt, batch, t.batch_repeat, draws=draws)["loss"])

        if step_launches is None:
            step_launches = _step_launches(K, step)
            _check_launches(report, "ResNet-50 train step", TRAIN_PATH, step_launches)
            print(f"  launches of one ResNet-50 train step: {step_launches}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        card = f"cuda:{torch.cuda.current_device()}"
        resident = device_memory_stats()[card]["allocated_bytes.all.current"] / 1e9
        ms = _time_ms(torch, step, reps=3, warmup=1)
        peak = device_memory_stats()[card]["allocated_bytes.all.peak"] / 1e9
        timings[f"ResNet-50 train step, {n_img} images, batch_repeat {t.batch_repeat} (ms)"] = ms
        timings[f"ResNet-50 peak memory of a train step, {n_img} images (GB)"] = peak
        timings[f"ResNet-50 train step's own memory, {n_img} images (GB: peak less resident)"] = \
            peak - resident
        print(f"  ResNet-50 train step, {tuple(batch['images'].shape)} images ({rows} denoiser "
              f"rows): {ms:.2f} ms, peak {peak:.2f} GB ({resident:.2f} GB resident before "
              f"it, {peak - resident:.2f} GB the step's own) (card: {smi})")
        del batch, draws
    report.require("ResNet-50 train losses finite", bool(np.isfinite(losses).all()),
                   f"({[round(x, 5) for x in losses]})")
    moved = {k: (p.detach() - initial[k]).abs().max().item()
             for k, p in model.named_parameters()}
    stats = {k: v for k, v in moved.items() if k.endswith(("running_mean", "running_var"))}
    others = {k: v for k, v in moved.items() if k not in stats}
    print(f"  after {opt.step_count} steps: {sum(v > 0 for v in stats.values())} of "
          f"{len(stats)} BatchNorm statistics moved (smallest change "
          f"{min(stats.values()):.3e}), {sum(v > 0 for v in others.values())} of {len(others)} "
          f"other parameters")
    report.require("ResNet-50 train: every BatchNorm mean and variance moved",
                   len(stats) == 2 * 53 and min(stats.values()) > 0)
    report.require("ResNet-50 train: the other parameters moved", max(others.values()) > 0)
    del model, opt, initial
    torch.cuda.empty_cache()
    print(f"  [resnet-train] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return timings, step_launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _torchrun_world_one():
    """torchrun's variables for one process (RANK 0 of WORLD_SIZE 1,
    MASTER_ADDR localhost, a free port) inside the block, restored after;
    a process group still up at the end is taken down."""
    import torch.distributed as dist

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_slice(report, dev, work, t_start):
    """[dp] data parallelism at world size 1 over NCCL, under torchrun's
    variables (MASTER_ADDR localhost): one ResNet-50 train step (64 images)
    through ``train_step(distributed=True)`` against the one-process step
    from the same state and draws (parameters within TOL_DP, and said
    whether bitwise); then train_torch.run under the variables: 2 steps on
    the NCCL group it sets up and takes down, the path's kernels launched,
    finite losses, a checkpoint. Returns the data-parallel path's launches."""
    import copy

    import torch
    import torch.distributed as dist

    import train_torch
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg

    n_img = RESNET_TRAIN_IMAGES[0]
    print(f"[dp] world size 1 over NCCL: a ResNet-50 step ({n_img} images) through the "
          "data-parallel path against the one-process step; train_torch.run under torchrun's "
          "variables", flush=True)
    with _torchrun_world_one():
        cfg = _train_cfg(work, "train_dp", RESNET50, f"train.max_images={n_img}")
        t = cfg.train
        one = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
        init_random_weights(one, SEED)
        one.to(dev)
        par = copy.deepcopy(one)
        batch, draws, _ = _train_batch(cfg, dev, one.config.timesteps)
        report.require("[dp] maybe_initialize_distributed sets up NCCL at world size 1",
                       maybe_initialize_distributed("cuda") and dist.get_backend() == "nccl"
                       and dist.get_world_size() == 1)
        steps = {}
        for name, model, distributed in (("one process", one, False), ("data-parallel", par, True)):
            opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num,
                                    iters_per_epoch=t.len_train, clip_grad=t.clip_grad)
            steps[name] = train_step(model, opt, batch, t.batch_repeat, draws=draws,
                                     distributed=distributed)
        dist.destroy_process_group()
        pa = dict(one.named_parameters())
        diffs = [(p.detach() - pa[k].detach()).abs().max().item() for k, p in par.named_parameters()]
        bitwise = all(torch.equal(p, pa[k]) for k, p in par.named_parameters())
        print(f"  loss {steps['one process']['loss']:.6f} / {steps['data-parallel']['loss']:.6f}, "
              f"gradient norm {steps['one process']['grad_norm']:.6f} / "
              f"{steps['data-parallel']['grad_norm']:.6f}; parameters bitwise equal: {bitwise}")
        report.check("[dp] data-parallel step vs one-process step: parameters", max(diffs), TOL_DP)
        report.check("[dp] data-parallel step vs one-process step: loss",
                     abs(steps["one process"]["loss"] - steps["data-parallel"]["loss"]), TOL_DP)
        del one, par, batch, draws
        torch.cuda.empty_cache()

        cfg = _train_cfg(work, "train_dp_run", RESNET50, f"train.max_images={n_img}",
                         "train.epochs=1", "train.len_train=2")
        shutil.rmtree(cfg.exp_dir, ignore_errors=True)
        K.reset_launch_counts()
        result = train_torch.run(cfg)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        _check_launches(report, "data-parallel train", TRAIN_PATH, launches)
        print(f"  train_torch.run: rank {result['rank']} of {result['world_size']} on "
              f"{result['device']}, backend {result['backend']}, {result['steps']} steps, losses "
              f"{[round(x, 5) for x in result['losses']]}")
        report.require("[dp] train_torch.run trained on NCCL at world size 1",
                       result["backend"] == "nccl" and result["world_size"] == 1
                       and result["steps"] == 2 and result["finite"])
        report.require("[dp] train_torch.run wrote its checkpoint and took its group down",
                       bool(result["checkpoint"]) and os.path.exists(result["checkpoint"])
                       and not dist.is_initialized())
    print(f"  [dp] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return launches


def fsdp_slice(report, dev, work, t_start):
    """[fsdp] parameter sharding (parallel/mesh.shard_model, FSDP2) over NCCL
    at world size 1, under torchrun's variables as [dp]: a DINO model
    sharded on a (1, 1) ("dp", "fsdp") mesh takes one step of FSDP_IMAGES
    images through train_step against the one-process step from the same
    state and draws (TOL_DP), every parameter's gradient present and every
    parameter moved, the train kernels launched; the in-training eval on
    the sharded model equal to the gathered weights' sample; the full
    checkpoint written and loaded strictly into one process. A world of
    one card shards nothing: fsdp >= 2 is proven on the CPU only (gloo,
    tests/test_torch_fsdp.py). Returns the sharded step's launches."""
    import copy

    import torch
    import torch.distributed as dist

    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from posediffusion_tpu_torch.parallel.mesh import (
        full,
        full_state_dict,
        is_sharded,
        make_mesh,
        shard_model,
    )
    from posediffusion_tpu_torch.training.checkpoints import restore, save
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import eval_step, train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg

    print(f"[fsdp] world size 1 over NCCL, a (1, 1) mesh: one DINO step ({FSDP_IMAGES} images) "
          "of the sharded model against the one-process step, its eval and its checkpoint; "
          "fsdp >= 2 is proven on the CPU only (gloo, 2 and 4 processes)", flush=True)
    with _torchrun_world_one():
        cfg = _train_cfg(work, "train_fsdp", f"train.max_images={FSDP_IMAGES}")
        t = cfg.train
        config = model_config_from_cfg(cfg.MODEL)
        one = PoseDiffusionModel(config)
        init_random_weights(one, SEED)
        one.to(dev)
        sharded = copy.deepcopy(one)
        initial = {k: v.detach().clone() for k, v in one.named_parameters()}
        batch, draws, _ = _train_batch(cfg, dev, config.timesteps)
        report.require("[fsdp] maybe_initialize_distributed sets up NCCL at world size 1",
                       maybe_initialize_distributed(dev.type) and dist.get_backend() == "nccl"
                       and dist.get_world_size() == 1)
        shard_model(sharded, make_mesh(1, 1, dev.type))
        report.require("[fsdp] shard_model made one FSDP unit, every parameter a DTensor",
                       is_sharded(sharded) and all(type(p).__name__ == "DTensor"
                                                   for p in sharded.parameters()))
        steps = {}
        for name, model in (("one process", one), ("sharded", sharded)):
            opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num,
                                    iters_per_epoch=t.len_train, clip_grad=t.clip_grad)
            if name == "sharded":
                K.reset_launch_counts()
            steps[name] = train_step(model, opt, batch, t.batch_repeat, draws=draws)
            torch.cuda.synchronize()
        launches = K.launch_counts()
        _check_launches(report, "FSDP train", TRAIN_PATH, launches)
        pa = dict(one.named_parameters())
        diffs = [(full(p).detach() - pa[k].detach()).abs().max().item()
                 for k, p in sharded.named_parameters()]
        bitwise = all(torch.equal(full(p), pa[k]) for k, p in sharded.named_parameters())
        print(f"  loss {steps['one process']['loss']:.6f} / {steps['sharded']['loss']:.6f}, "
              f"gradient norm {steps['one process']['grad_norm']:.6f} / "
              f"{steps['sharded']['grad_norm']:.6f}; parameters bitwise equal: {bitwise}")
        report.check("[fsdp] sharded step vs one-process step: parameters", max(diffs), TOL_DP)
        report.check("[fsdp] sharded step vs one-process step: loss",
                     abs(steps["one process"]["loss"] - steps["sharded"]["loss"]), TOL_DP)
        params = list(sharded.named_parameters())
        report.require("[fsdp] every parameter's gradient arrived",
                       all(p.grad is not None for _, p in params), f"({len(params)} parameters)")
        still = [k for k, p in params if torch.equal(full(p), initial[k])]
        report.require("[fsdp] every parameter moved", not still, f"({still[:3]})")

        # the in-training eval on the sharded model, against the gathered weights
        rows = batch["images"].shape[0] // 2
        ev = {k: v[:rows] for k, v in batch.items()}
        gathered = PoseDiffusionModel(config).to(dev)
        gathered.load_state_dict(full_state_dict(sharded), strict=True)
        K.reset_launch_counts()
        enc, _ = eval_step(sharded, ev, generator=torch.Generator(dev).manual_seed(SEED))
        torch.cuda.synchronize()
        eval_launches = {k: v for k, v in K.launch_counts().items() if v}
        print(f"  eval of {rows} sequences on the sharded model: launches {eval_launches}")
        ref, _ = eval_step(gathered, ev, generator=torch.Generator(dev).manual_seed(SEED))
        report.require("[fsdp] eval on the sharded model equals the gathered weights' sample",
                       torch.equal(enc, ref) and bool(torch.isfinite(enc).all()),
                       f"(max diff {(enc - ref).abs().max().item():.3e})")

        # the full checkpoint, into one process strictly
        path = save(os.path.join(work, "fsdp_ckpt"), sharded, opt, opt.step_count)
        loaded = PoseDiffusionModel(config)
        state = restore(path, loaded)
        same = all(torch.equal(loaded.state_dict()[k].to(dev), full(v))
                   for k, v in sharded.state_dict().items())
        report.require("[fsdp] the checkpoint holds whole tensors and loads strictly into "
                       "one process", same and state["step"] == 1
                       and len(state["optimizer"]["mu"]) == len(params))
        del one, sharded, gathered, loaded, batch, draws
        torch.cuda.empty_cache()
    print(f"  [fsdp] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return {k: v for k, v in launches.items() if v}


def train336_slice(report, dev, work, smi, t_start):
    """[train-336] one DINO train step at train.img_size=336 (442 + 101 + 50
    = 593 packed tokens) at the reference's 512 images (cut to the largest
    of TRAIN336_IMAGES that fits), and beside it the same measurements at
    224px (264 tokens) in the same way: every kernel of the train path
    launched, finite loss, every parameter moved; the step's time (CUDA
    events), its peak memory (from a reset before the step) beside what
    was resident before it (the model, its optimizer, the batch and
    whatever earlier phases hold), and its ViT trunk's
    forward and forward + backward (N x tokens, 12 blocks, f32). Returns
    (timings, launches of one 336px step)."""
    import torch

    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops import vit_train_kernel as V
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg

    timings = {}
    for px, sizes in ((336, TRAIN336_IMAGES), (224, (512,))):
        for n_img in sizes:
            print(f"[train-336] one DINO train step at train.img_size={px}, {n_img} images "
                  f"(cfgs/default_train.yaml: 512), batch_repeat 90; card: {smi}", flush=True)
            cfg = _train_cfg(work, f"train_{px}", f"train.img_size={px}",
                             f"train.max_images={n_img}")
            t = cfg.train
            model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
            init_random_weights(model, SEED)
            model.to(dev)
            initial = {k: v.detach().clone() for k, v in model.named_parameters()}
            batch, draws, _ = _train_batch(cfg, dev, model.config.timesteps)
            opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num,
                                    iters_per_epoch=t.len_train, clip_grad=t.clip_grad)
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident_gb = torch.cuda.memory_allocated() / 1e9
                step_launches = _step_launches(
                    K, lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws))
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                break
            except torch.cuda.OutOfMemoryError:
                print(f"  {n_img} images do not fit in the card's memory", flush=True)
                del model, initial, batch, draws, opt
                torch.cuda.empty_cache()
        if px == 336:
            launches = step_launches
        report.require(f"[train-336] the batch is {px}px",
                       tuple(batch["images"].shape[-2:]) == (px, px),
                       f"({tuple(batch['images'].shape)})")
        _check_launches(report, f"{px}px train", TRAIN_PATH, step_launches)
        moved = [k for k, p in model.named_parameters() if not torch.equal(p, initial[k])]
        report.require(f"[train-336] {px}px: every parameter moved", len(moved) == len(initial),
                       f"({len(moved)} of {len(initial)})")
        metrics = train_step(model, opt, batch, t.batch_repeat, draws=draws)
        report.require(f"[train-336] {px}px: finite loss", bool(np.isfinite(metrics["loss"])),
                       f"({metrics['loss']:.6f})")
        step_ms = _time_ms(torch, lambda: train_step(model, opt, batch, t.batch_repeat,
                                                     draws=draws), reps=2, warmup=1)
        vit = model.image_feature_extractor._net
        with torch.no_grad():
            tok, bias, _ = _embed_pack_scales(vit, batch["images"].flatten(0, 1)[:n_img],
                                              model.config.scale_factors)
            vst = {k: v.detach().clone() for k, v in V.stack_vit_params_train(vit).items()}
        n_tok = {224: 264, 336: 593}[px]
        report.require(f"[train-336] {n_tok} packed tokens a row at {px}px",
                       tok.shape[1] == n_tok, f"({tuple(tok.shape)})")
        cot = torch.randn(tok.shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(SEED))
        run = lambda x, st: V.fused_vit_trunk_train(x, st, bias, 6, False, False)  # noqa: E731
        timings[f"{px}px train step ({n_img} images, batch_repeat 90)"] = step_ms
        timings[f"{px}px peak memory of a train step (GB)"] = peak_gb
        timings[f"{px}px memory resident before the step (GB)"] = resident_gb
        timings[f"{px}px vit trunk fwd+bwd ({n_img}x{n_tok})"] = _time_ms(
            torch, lambda: _trunk_grads(run, tok, vst, cot), reps=2, warmup=1)
        with torch.no_grad():
            timings[f"{px}px vit trunk fwd ({n_img}x{n_tok})"] = _time_ms(
                torch, lambda: run(tok, vst), reps=2, warmup=1)
        # the trunk's bounds as rows 9-10 of the kernel table take them
        D_v, F_v, L_v = vit.embed_dim, 4 * vit.embed_dim, len(vit.blocks)
        w_vit = L_v * (4 * D_v * D_v + 2 * D_v * F_v)
        fwd_b, bwd_b = trunk_bounds(n_img * n_tok, n_tok, D_v, F_v, L_v, 4, 4 * w_vit)
        timings[f"{px}px vit trunk fwd bound ({n_img}x{n_tok})"] = fwd_b
        timings[f"{px}px vit trunk bwd bound ({n_img}x{n_tok})"] = bwd_b
        timings[f"{px}px train images"] = n_img
        del model, opt, batch, draws, tok, vst, cot, initial
        torch.cuda.empty_cache()
    for name, v in timings.items():
        print(f"  {name}: {v:.3f}")
    print(f"  [train-336] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return timings, {k: v for k, v in launches.items() if v}


def dinov2_bf16_slice(report, dev, work, smi, t_start):
    """[dinov2-bf16] demo_torch with dinov2_vits14 at compute_dtype=bfloat16
    on samples/apple without GGS: finite cameras, attention (TPU kernel 5)
    and the sampler's entries (kernel 2) launched, no LayerNorm or product
    kernel of the fused ViT trunk (kernel 1); the inference's and the
    extractor's times beside the float32 route's. Returns (timings,
    launches)."""
    import torch

    import demo_torch
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    apple = os.path.join(REPO, "samples", "apple")
    print(f"[dinov2-bf16] demo_torch on samples/apple, dinov2_vits14 at "
          f"compute_dtype=bfloat16, no GGS; card: {smi}", flush=True)
    K.reset_launch_counts()
    out = demo_torch.run(demo_cfg(work, apple, DINOV2, DINOV2_BF16, "GGS.enable=False"),
                         dev.type)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    _check_launches(report, "DINOv2 bf16", DINOV2_SERVE_PATH, launches)
    report.require("[dinov2-bf16] no kernel of the fused ViT trunk (kernel 1)",
                   launches["layernorm"] == 0 and launches["linear"] == 0,
                   f"(layernorm {launches['layernorm']}, linear {launches['linear']})")
    imgs = torch.as_tensor(load_and_preprocess_images(apple, IMAGE_SIZE)[0], device=dev)[None]
    _check_cameras(report, out, imgs.shape[1], "DINOv2 bf16")
    timings = {}
    for dtype in ("bfloat16", "float32"):
        cfg = load_config("default", [DINOV2,
                                      f"MODEL.IMAGE_FEATURE_EXTRACTOR.compute_dtype={dtype}"])
        model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
        init_random_weights(model, SEED)
        model.to(dev)
        gen = lambda: torch.Generator(dev).manual_seed(SEED)  # noqa: E731
        with torch.no_grad():
            z = model.extract_features(imgs)
            report.require(f"[dinov2-bf16] {dtype} features finite",
                           bool(torch.isfinite(z).all()), f"({tuple(z.shape)})")
            timings[f"DINOv2 {dtype} inference (extract + 100-step sampler, 20 frames)"] = (
                _time_ms(torch, lambda: model.sample(imgs, generator=gen()), reps=5))
            timings[f"DINOv2 {dtype} extractor (20 frames)"] = _time_ms(
                torch, lambda: model.extract_features(imgs), reps=5)
        del model
    for name, v in timings.items():
        print(f"  {name}: {v:.3f} ms")
    torch.cuda.empty_cache()
    print(f"  [dinov2-bf16] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return timings, {k: v for k, v in launches.items() if v}


def vitg_slice(report, dev, work, smi, t_start):
    """[vitg] DINOv2 ViT-g/14's train path at the cell dinov2g-train-f32's
    shapes: one train step of 96 images (after a warm-up step; launch counts
    reset just before it, the gate's launches required, every weight
    gradient on TF32 wgmma), then the kernels the path adds or widens
    against their plain versions at its 33,408 rows with TOL_F32 -- the
    gated w12 product (forward, and with its pre-activation as the
    recompute takes it), swiglu_bwd, layernorm_bwd at D 1,536 (the wide
    kernel, with the residual), layerscale_bwd at D 1,536 and the float32
    weight gradients of w12 and w3 -- each timed beside its plain version,
    with its device time and a bound from its inputs. Returns
    (kernels-line entries, timings, the step's launches)."""
    import torch

    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg

    print(f"[vitg] DINOv2 ViT-g/14: one train step at {VITG_IMAGES} images, its kernels at "
          "the step's shapes")
    t_phase = time.perf_counter()
    cfg = _train_cfg(work, "train_vitg", VITG, f"train.max_images={VITG_IMAGES}")
    cfg_model = model_config_from_cfg(cfg.MODEL)
    with torch.device(dev):
        model = PoseDiffusionModel(cfg_model)
    model.to(dev)
    init_random_weights(model, SEED)
    batch, draws, n_rows = _train_batch(cfg, dev, cfg_model.timesteps)
    t = cfg.train
    opt, _ = make_optimizer(model, lr=t.lr, T_0=t.restart_num, iters_per_epoch=t.len_train,
                            clip_grad=t.clip_grad)
    images = batch["images"].shape[0] * batch["images"].shape[1]
    step = lambda: train_step(model, opt, batch, t.batch_repeat, draws=draws)  # noqa: E731
    m = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches = _step_launches(K, step)
    step_ms = (time.perf_counter() - t0) * 1e3
    routes, shapes = dict(K.linear.by_route), dict(K.linear.by_shape)
    wgrad_routes, wgrad_shapes = dict(K.linear_wgrad.by_route), dict(K.linear_wgrad.by_shape)
    timings = {"[vitg] train step ms (host clock, one step)": step_ms,
               "[vitg] peak memory of a train step (GB)": torch.cuda.max_memory_allocated() / 1e9}
    rows = images * 348
    gated = shapes.get((rows, VITG_D, 2 * VITG_HIDDEN, False), 0)
    # the step's weight gradients of w12 (D -> 2H) and w3 (H -> D), by (M, K, N)
    wgrads = {"w12": wgrad_shapes.get((rows, VITG_D, 2 * VITG_HIDDEN), 0),
              "w3": wgrad_shapes.get((rows, VITG_HIDDEN, VITG_D), 0)}
    print(f"  {images} images ({rows} trunk rows, {n_rows} denoiser rows); launches of one step: "
          f"{launches}; linear by route {routes}; linear_wgrad by route {wgrad_routes}; gated "
          f"w12 products {gated}; weight gradients of w12 and w3 {wgrads}")
    report.require(f"[vitg] every weight gradient of the step on TF32 wgmma "
                   f"({launches['linear_wgrad']})",
                   wgrad_routes == {"tf32_wgmma": launches["linear_wgrad"]}, f"({wgrad_routes})")
    report.require(f"[vitg] the step's images are the cell's {VITG_IMAGES}",
                   images == VITG_IMAGES, f"({images})")
    report.require("[vitg] train step loss finite", np.isfinite(m["loss"]), f"({m['loss']:.5f})")
    counted = {"gated": gated, "wgrad w12": wgrads["w12"], "wgrad w3": wgrads["w3"]}
    for key, want in VITG_PER_STEP.items():
        got = counted[key] if key in counted else launches[key]
        report.require(f"[vitg] a step launches {want} {key}", got == want, f"({got})")
    del model, opt, batch, draws, m
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    D, H, M = VITG_D, VITG_HIDDEN, rows
    entries = []

    def entry(key, name, case, err, n, kern, plain, b, device):
        e = {"name": name, "route": "cuda", "source": SOURCES[key], "replaces": TPU_KERNELS[key],
             "launches": n, "max_abs_err": err, "ms": _time_ms(torch, kern, reps=5),
             "plain_ms": _time_ms(torch, plain, reps=5), "bound_ms": b[0], "bound_by": b[1],
             "library_ms": None, **device, "case": f"[vitg] {case}"}
        print(f"  {name} {case}: kernel {e['ms']:.4f} ms (device {e['device_ms']:.4f}), plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"{n} launches", flush=True)
        entries.append(e)
        timings[f"[vitg] {name}"] = e["ms"]

    with torch.no_grad():
        # the gated product: a (M, D) @ w12 (D, 2H) interleaved -> y (M, H);
        # the forward writes y, the backward's recompute y and the (M, 2H) pre
        a = rnd(M, D)
        w = rnd(D, 2 * H) / D**0.5
        b = 0.1 * rnd(2 * H)
        errs = []
        for want_pre in (False, True):
            out = K.linear(a, w, b, act="swiglu", want_pre=want_pre)
            ref = K.linear_plain(a, w, b, act="swiglu", want_pre=want_pre)
            pairs = zip(("y", "pre"), out, ref) if want_pre else [("y", out, ref)]
            errs += [_close_rel(report, f"[vitg] linear swiglu {part} ({M}x{D} @ {D}x{2 * H}"
                                f"{', want_pre' if want_pre else ''})", o, r, TOL_F32)
                     for part, o, r in pairs]
            del out, ref
        ops, peak = linear_work(2 * M * D * 2 * H, False, False)
        fwd = lambda: K.linear(a, w, b, act="swiglu")  # noqa: E731
        entry("linear", "linear f32 vitg w12 swiglu", f"the gated w12 product ({M}x{D} @ "
              f"{D}x{2 * H} -> {M}x{H}; launches: forward and recompute a step)", max(errs),
              gated, fwd, lambda: K.linear_plain(a, w, b, act="swiglu"),
              bound(nbytes(a, w, b) + M * H * 4, ops, peak), _linear_f32_device(torch, K, fwd))
        rec = lambda: K.linear(a, w, b, act="swiglu", want_pre=True)  # noqa: E731
        entry("linear", "linear f32 vitg w12 swiglu recompute", f"the same with its "
              f"({M}x{2 * H}) pre-activation (launches: as above)", max(errs), gated, rec,
              lambda: K.linear_plain(a, w, b, act="swiglu", want_pre=True),
              bound(nbytes(a, w, b) + M * H * 4 + M * 2 * H * 4, ops, peak),
              _linear_f32_device(torch, K, rec))
        del a, w, b
        torch.cuda.empty_cache()
        # the gate's backward: dh (M, H) and pre (M, 2H) read, dx12 (M, 2H) written
        dh, pre = rnd(M, H), 2 * rnd(M, 2 * H)
        err = _close_rel(report, f"[vitg] swiglu_bwd ({M}x{H})", K.swiglu_bwd(dh, pre),
                         K.swiglu_bwd_plain(dh, pre), TOL_F32)
        call = lambda: K.swiglu_bwd(dh, pre)  # noqa: E731
        entry("swiglu_bwd", "swiglu_bwd", f"({M}x{H}, pre {M}x{2 * H})", err,
              launches["swiglu_bwd"], call, lambda: K.swiglu_bwd_plain(dh, pre),
              bound(nbytes(dh, pre) + nbytes(pre), 12 * dh.numel()),
              {"device_ms": _kernel_device_ms(torch, call, "swiglu_bwd_kernel")})
        del dh, pre
        torch.cuda.empty_cache()
        # layernorm_bwd at D 1,536 with the residual's cotangent (the wide kernel)
        x, dhl, res = rnd(M, D), rnd(M, D), rnd(M, D)
        g = 1 + 0.1 * rnd(D)
        err = max(_close_rel(report, f"[vitg] layernorm_bwd {part} ({M}x{D}, + residual)", o, r,
                             TOL_F32)
                  for part, o, r in zip(("dx", "dg", "db"),
                                        K.layernorm_bwd(x, g, dhl, 1e-6, residual=res),
                                        K.layernorm_bwd_plain(x, g, dhl, 1e-6, residual=res)))
        call = lambda: K.layernorm_bwd(x, g, dhl, 1e-6, residual=res)  # noqa: E731
        entry("layernorm_bwd", "layernorm_bwd vitg", f"({M}x{D}, + residual; launches: the "
              "step's, 80 of them at D 1,536)", err, launches["layernorm_bwd"], call,
              lambda: K.layernorm_bwd_plain(x, g, dhl, 1e-6, residual=res),
              bound(nbytes(x, dhl, res, g) + nbytes(x) + 2 * D * 4, 12 * M * D),
              {"device_ms": _kernel_device_ms(torch, call, None)})
        del x, dhl, res
        # layerscale_bwd at D 1,536 (no dropout: the SwiGLU trunk has none)
        dy, o_pre = rnd(M, D), rnd(M, D)
        err = max(_close_rel(report, f"[vitg] layerscale_bwd {part} ({M}x{D})", o, r, TOL_F32)
                  for part, o, r in zip(("dx", "dgamma"), K.layerscale_bwd(dy, o_pre, g),
                                        K.layerscale_bwd_plain(dy, o_pre, g)))
        call = lambda: K.layerscale_bwd(dy, o_pre, g)  # noqa: E731
        entry("layerscale_bwd", "layerscale_bwd vitg", f"({M}x{D}, its columns over a grid y "
              "of 2)", err, launches["layerscale_bwd"], call,
              lambda: K.layerscale_bwd_plain(dy, o_pre, g),
              bound(nbytes(dy, o_pre, g) + nbytes(dy) + D * 4, 3 * M * D),
              {"device_ms": _kernel_device_ms(torch, call, None)})
        del dy, o_pre, g
        torch.cuda.empty_cache()
        # the weight gradients of w12 (D -> 2H, the interleaved halves) and w3
        # (H -> D), float32
        for name, Kw, Nw in (("w12", D, 2 * H), ("w3", H, D)):
            x, dy = rnd(M, Kw), rnd(M, Nw)
            dw, db = K.linear_wgrad(x, dy)
            dw_p, db_p = K.linear_wgrad_plain(x, dy)
            err = max(_close_rel(report, f"[vitg] linear_wgrad {name} dW ({M}x{Kw})^T ({M}x{Nw})",
                                 dw, dw_p, TOL_F32),
                      _close_rel(report, f"[vitg] linear_wgrad {name} db", db, db_p, TOL_F32))
            report.require(f"[vitg] linear_wgrad {name} repeats bitwise",
                           torch.equal(dw, K.linear_wgrad(x, dy)[0]))
            del dw, db, dw_p, db_p
            call = lambda x=x, dy=dy: K.linear_wgrad(x, dy)  # noqa: E731
            entry("linear_wgrad", f"linear_wgrad f32 vitg {name}", f"({M}x{Kw})^T ({M}x{Nw}) "
                  "(launches: a step's at this shape)", err, wgrads[name], call,
                  lambda x=x, dy=dy: K.linear_wgrad_plain(x, dy), wgrad_bound(x, dy),
                  _wgrad_f32_device(torch, K, x, dy))
            e = entries[-1]
            e["library_ms"] = e["library_device_ms_tf32_off"]
            print(f"    library by device time: TF32 off {e['library_device_ms_tf32_off']:.4f} ms, "
                  f"on {e['library_device_ms_tf32_on']:.4f} ms; route {e['wgrad_route']}",
                  flush=True)
            del x, dy
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    timings["[vitg] seconds"] = time.perf_counter() - t_phase
    print(f"  [vitg] done at {time.perf_counter() - t_start:.0f} s, card {smi}", flush=True)
    return entries, timings, {"train step": launches, "linear by route": routes,
                              "linear_wgrad by route": wgrad_routes, "gated w12 products": gated,
                              "weight gradients of w12 and w3": wgrads}


def learnability_module():
    """experiments/synthetic_learnability_torch.py, imported by path."""
    import importlib.util

    path = os.path.join(REPO, "experiments", "synthetic_learnability_torch.py")
    spec = importlib.util.spec_from_file_location("synthetic_learnability_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _diff_counts(K, before):
    """Kernel launches since ``before`` (a ``K.launch_counts()``), nonzero only."""
    return {k: v - before[k] for k, v in K.launch_counts().items() if v - before[k]}


def learn_entry(torch, key, case, err, launches, kernel, plain, b, library=None,
                slow_plain=False):
    """One kernels-line entry of [learn]: CUDA-event times of ``kernel``,
    ``plain`` (three single calls when ``slow_plain``) and ``library`` (a
    one-call PyTorch yardstick, or None)."""
    plain_ms = (_time_ms(torch, plain, reps=3, warmup=1) if slow_plain
                else _time_ms(torch, plain, inner=10))
    e = {"name": key, "route": "cuda", "source": SOURCES[key], "replaces": TPU_KERNELS[key],
         "launches": launches.get(key, 0), "max_abs_err": err,
         "ms": _time_ms(torch, kernel, inner=10), "plain_ms": plain_ms,
         "bound_ms": b[0], "bound_by": b[1],
         "library_ms": None if library is None else _time_ms(torch, library, inner=10),
         "case": f"[learn] {case}"}
    print(f"  {key} {case}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
          f"{e['library_ms']}, bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
          f"{e['launches']} launches", flush=True)
    return e


def learn_slice(report, dev, smi, t_start):
    """[learn] experiments/synthetic_learnability_torch.py's model and data
    (ViT z_dim 192, 4 blocks, 3 heads, 17 tokens at 64px; denoiser d_model
    256, 4 layers; B 8 x N 6, batch_repeat 8; init_flax_weights), float32:
    at step 0 its kernels at these widths against their plain versions (the
    ViT train trunk forward and backward at 48 x 17 x 192 in both modes, the
    encoder train trunk at 64 x 6 x 256, fused_vit_trunk at 48 x 17 x 192 in
    both modes, the sampler's three entries and one fused_trunk pass at 6
    rows of 256, a 30-iteration GGS phase on the chunked cluster route at 6
    frames and the exact matches of the first GGS sequence); then the first
    LEARN_STEPS steps of the LEARN_SCHEDULE-step card run (its batches,
    schedule and draws): finite losses, their last 100 steps' mean under
    LEARN_LOSS_MAX, the train kernels launched; then that sequence sampled
    with GGS: finite cameras and the launches predicted by
    LEARN_GGS_LAUNCHES. Returns (kernels-line entries, timings, launches)."""
    import torch
    import torch.nn.functional as F

    from posediffusion_tpu_torch.diffusion import ggs as G
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops import vit_train_kernel as V
    from posediffusion_tpu_torch.ops.denoiser_kernel import (
        fused_trunk,
        fused_trunk_plain,
        stack_trunk_params,
    )
    from posediffusion_tpu_torch.ops.ggs_grad import (
        ggs_tables,
        loss_and_grad_core,
        pack_matches_grouped,
    )
    from posediffusion_tpu_torch.ops.ggs_kernel import (
        default_chunk_pairs,
        ggs_phase_fused_chunked,
        ggs_phase_fused_plain,
    )
    from posediffusion_tpu_torch.ops.sampler_kernel import prepare_sampler
    from posediffusion_tpu_torch.ops.vit_kernel import (
        fused_vit_trunk,
        fused_vit_trunk_plain,
        stack_vit_params,
    )
    from posediffusion_tpu_torch.training.step import pose_metrics

    t_phase = time.perf_counter()
    Lm = learnability_module()
    print(f"[learn] experiments/synthetic_learnability_torch.py's model and data, f32; card: "
          f"{smi}", flush=True)
    model = Lm.build_model("float32", SEED).to(dev)
    c = model.config
    vit, den = model.image_feature_extractor._net, model.diffuser.model
    hw = (LEARN_IMG, LEARN_IMG)
    rng = np.random.default_rng(SEED)
    texture = Lm.make_texture(rng)
    held = Lm.make_batch(np.random.default_rng(Lm.EVAL_SEED0), texture, Lm.B, Lm.N, LEARN_IMG,
                         dev)
    seq, enc, matches = Lm.make_eval_sequence_with_matches(
        np.random.default_rng(Lm.GGS_SEED0), texture, Lm.GGS_FRAMES, LEARN_IMG, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    with torch.no_grad():
        tok, vbias, _ = _embed_pack_scales(vit, held["images"].flatten(0, 1), c.scale_factors)
    Bv, Nv, Dv = tok.shape
    H = c.vit_heads
    print(f"  ViT tokens {tuple(tok.shape)}, {H} heads; encoder {c.d_model} wide, "
          f"{c.num_encoder_layers} layers", flush=True)
    errs = {}

    # the train trunks, forward and every gradient, kernel route against plain
    vst = {k: v.detach().clone() for k, v in V.stack_vit_params_train(vit).items()}
    cot_v = rnd(*tok.shape)

    def vit_run(mode, plain):
        def run(x, st):
            with _route(V, plain):
                return V.fused_vit_trunk_train(x, st, vbias, H, mode, mode)
        return run

    for mode in (False, True):
        tag = "bf16 operands and residuals" if mode else "f32"
        worst = _worst_rel(_trunk_grads(vit_run(mode, False), tok, vst, cot_v),
                           _trunk_grads(vit_run(mode, True), tok, vst, cot_v))
        report.check(f"[learn] fused_vit_trunk_train {tag} ({c.vit_depth} blocks, {Bv}x{Nv}x"
                     f"{Dv}): output and every gradient, worst {worst[1]}", worst[0],
                     TOL_TRAIN_BF16 if mode else TOL_TRAIN_F32)
    Be, De = Lm.B * Lm.BATCH_REPEAT, c.d_model
    est = {k: v.detach().clone() for k, v in V.stack_encoder_trunk_params(den._trunk).items()}
    h_e, cot_e = rnd(Be, Lm.N, De), rnd(Be, Lm.N, De)
    ebias = torch.zeros((Be, Lm.N), device=dev)

    def enc_run(plain):
        def run(x, st):
            with _route(V, plain):
                return V.fused_encoder_trunk_train(x, st, ebias, SEED, c.nhead, dropout=c.dropout)
        return run

    outs = list(zip(_trunk_grads(enc_run(False), h_e, est, cot_e),
                    _trunk_grads(enc_run(True), h_e, est, cot_e)))
    tag = f"({c.num_encoder_layers} layers, {Be}x{Lm.N}x{De})"
    _close_rel(report, f"[learn] fused_encoder_trunk_train f32 y {tag}", outs[0][0][1],
               outs[0][1][1], TOL_TRAIN_F32)
    mean_err, share = 0.0, 0.0
    for (name, a), (_, b) in outs[1:]:
        rel = (a - b).abs() / max(1.0, b.abs().max().item())
        mean_err = max(mean_err, rel.mean().item())
        share = max(share, (rel > ENCODER_GRAD_OUTLIER).float().mean().item())
    report.check(f"[learn] fused_encoder_trunk_train f32 gradients, largest mean relative "
                 f"error {tag}", mean_err, TOL_ENCODER_GRAD_MEAN)
    report.check(f"[learn] fused_encoder_trunk_train f32 gradients, largest share beyond "
                 f"{ENCODER_GRAD_OUTLIER:.0e} {tag}", share, TOL_ENCODER_GRAD_SHARE)
    del outs

    # the serving trunks: fused_vit_trunk, the sampler's entries, fused_trunk
    sampler_args = {}
    with torch.no_grad():
        for mode, wdt, act in (("f32", torch.float32, False), ("bf16", torch.bfloat16, True)):
            st = stack_vit_params(vit, wdt)
            err = (fused_vit_trunk(tok, st, H, act, vbias)
                   - fused_vit_trunk_plain(tok, st, H, act, vbias)).abs().max().item()
            report.check(f"[learn] fused_vit_trunk {mode} ({c.vit_depth} blocks, {Bv}x{Nv}x{Dv})",
                         err, TOL_VIT_BF16 if act else TOL_VIT_F32)
            z = model.extract_features(seq)
            n = seq.shape[1]
            x0 = rnd(1, n, 9)
            inp = prepare_sampler(den, model.schedule, z, weight_dtype=wdt, x0=x0,
                                  noises=rnd(c.timesteps, 1, n, 9))
            for key, (name, args, e) in sampler_parity(report, torch, K, inp, mode, n).items():
                if mode == "bf16":
                    sampler_args[key] = (name, args, e)
            hp = K.sampler_prologue_plain(inp.x0, *inp.prologue, 0)
            stk = stack_trunk_params(den._trunk, wdt)
            zb = torch.zeros(n, device=dev)
            _close_rel(report, f"[learn] fused_trunk {mode} ({c.num_encoder_layers} layers, "
                       f"{n} rows of {De})", fused_trunk(hp, zb, stk, c.nhead),
                       fused_trunk_plain(hp, zb, stk, c.nhead), TOL_F32)
        rows_args = rows_products(inp.layers[0], hp, None, None)[0]
        errs["linear_rows"] = _close_rel(
            report, f"[learn] linear_rows in_proj bf16 ({n}x{De} @ {De}x{3 * De}, LayerNorm "
            "folded)", K.linear(*rows_args[1], **rows_args[2]),
            K.linear_plain(*rows_args[1], **rows_args[2]), TOL_F32)

    # one GGS phase on the chunked cluster route (kernel 7) at the sequence's matches
    gm = pack_matches_grouped(*matches, n, device=dev)
    n_match = int(gm.valid.sum().item())
    P, Q = gm.valid.shape
    report.require(f"[learn] the GGS table ({n} frames, {n_match} matches, {P} x {Q}) takes "
                   "the chunked route", not G.fused_fits(gm), f"({P * Q} entries)")
    x_g = (enc[0] + 0.05 * rnd(*enc[0].shape)).contiguous()
    kw = dict(iters=30, **GGS_PHASE)
    ref = ggs_phase_fused_plain(x_g, gm, hw, True, True, True, 10.0, **kw)
    chk = ggs_phase_fused_chunked(x_g, gm, hw, True, True, True, 10.0, **kw)
    errs["ggs_phase_chunked"] = (chk - ref).abs().max().item()
    report.check(f"[learn] ggs_phase_chunked ({n} frames, {n_match} matches, 30 iterations)",
                 errs["ggs_phase_chunked"], TOL_GGS_30)
    report.require("[learn] the GGS phase moved x", not torch.equal(chk, x_g))
    torch.cuda.synchronize()
    print(f"  [learn] parity done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # the first LEARN_STEPS steps of the card run
    before = K.launch_counts()
    run = Lm.train(model, texture, rng, LEARN_SCHEDULE, LEARN_IMG, dev, SEED,
                   run_steps=LEARN_STEPS, log=lambda s: print(f"  {s}", flush=True))
    torch.cuda.synchronize()
    train_launches = _diff_counts(K, before)
    losses = np.asarray(run["losses"])
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    report.require(f"[learn] {LEARN_STEPS} train steps: every loss finite",
                   bool(np.isfinite(losses).all()))
    report.require(f"[learn] mean loss of steps {LEARN_STEPS - 100}-{LEARN_STEPS - 1} under "
                   f"{LEARN_LOSS_MAX:.5f}", last < LEARN_LOSS_MAX,
                   f"(steps 0-99 {first:.4f}, last 100 {last:.4f})")
    print(f"  launches of one train step: {run['launches']}; of {LEARN_STEPS} steps: "
          f"{train_launches}", flush=True)
    for name in TRAIN_PATH:
        if not run["launches"].get(name):
            report.failures.append(f"[learn] kernel {name} was not launched in a train step")

    # one held-out sequence sampled with GGS from its exact matches
    before, ft0 = K.launch_counts(), fused_trunk.launches
    out = Lm.ggs_sample(model, seq, matches, LEARN_IMG, dev, Lm.GGS_SEED0)
    torch.cuda.synchronize()
    ggs_launches = {**_diff_counts(K, before), "fused_trunk": fused_trunk.launches - ft0}
    report.require("[learn] GGS sample: finite (1, 6, 9) encodings",
                   tuple(out.shape) == (1, n, 9) and bool(torch.isfinite(out).all()))
    L_enc, T = c.num_encoder_layers, c.timesteps
    R = T - LEARN_GGS_START
    predicted = {  # kernels 1 (its ViT), 2 (the sampler), 3 and 7 (the tail), 5 (attention)
        "layernorm": 2 * c.vit_depth, "linear": 4 * c.vit_depth,
        "attention": c.vit_depth + L_enc * T, "linear_rows": 4 * L_enc * T,
        "sampler_prologue": 1, "sampler_boundary": R - 1, "sampler_epilogue": 1,
        "ggs_phase_chunked": 5 * LEARN_GGS_START, "fused_trunk": LEARN_GGS_START}
    report.require("[learn] GGS sample: the predicted launches", ggs_launches == predicted,
                   f"({ggs_launches}; predicted {predicted})")
    with torch.no_grad():
        m = pose_metrics(out, enc)
    print(f"  [learn] the GGS sample after {LEARN_STEPS} steps: Racc@15 {m['Racc_15']:.3f}, "
          f"Tacc@15 {m['Tacc_15']:.3f}", flush=True)

    # the kernels line: each kernel at its [learn] width
    x2 = tok.reshape(-1, Dv).contiguous()
    blk = vit.blocks[0]
    g1, b1 = blk.norm1.weight.detach(), blk.norm1.bias.detach()
    wq, bq = blk.attn.qkv.weight.detach().t().contiguous(), blk.attn.qkv.bias.detach()
    entries = []
    with torch.no_grad():
        h = K.layernorm_plain(x2, g1, b1, 1e-6)
        e = _close_rel(report, f"[learn] layernorm f32 ({x2.shape[0]}x{Dv})",
                       K.layernorm(x2, g1, b1, 1e-6), h, TOL_F32)
        entries.append(learn_entry(
            torch, "layernorm", f"ViT norm1 f32 ({x2.shape[0]}x{Dv}; launches: the train steps)",
            e, train_launches, lambda: K.layernorm(x2, g1, b1, 1e-6),
            lambda: K.layernorm_plain(x2, g1, b1, 1e-6),
            bound(2 * nbytes(x2) + 2 * Dv * 4, 8 * x2.numel()),
            lambda: F.layer_norm(x2, (Dv,), g1, b1, 1e-6)))
        qkv = K.linear_plain(h, wq, bq)
        e = _close_rel(report, f"[learn] linear qkv f32 ({x2.shape[0]}x{Dv} @ {Dv}x{3 * Dv})",
                       K.linear(h, wq, bq), qkv, TOL_F32)
        entries.append(learn_entry(
            torch, "linear", f"ViT qkv f32 ({x2.shape[0]}x{Dv} @ {Dv}x{3 * Dv}; launches: the "
            "train steps)", e, train_launches, lambda: K.linear(h, wq, bq),
            lambda: K.linear_plain(h, wq, bq), linear_bound(h, wq, bq),
            lambda: torch.addmm(bq, h, wq)))
        qkv = qkv.view(Bv, Nv, 3 * Dv)
        e = _close_rel(report, f"[learn] attention f32 ({Bv}x{Nv}, {H} heads)",
                       K.attention(qkv, H, attn_bias=vbias),
                       K.attention_plain(qkv, H, attn_bias=vbias), TOL_F32)
        q, k_, v = qkv.view(Bv, Nv, 3, H, Dv // H).permute(2, 0, 3, 1, 4)
        entries.append(learn_entry(
            torch, "attention", f"ViT f32 ({Bv}x{Nv}, {H} heads; launches: the train steps)",
            e, train_launches, lambda: K.attention(qkv, H, attn_bias=vbias),
            lambda: K.attention_plain(qkv, H, attn_bias=vbias),
            attention_bound(qkv, attn_bias=vbias),
            lambda: F.scaled_dot_product_attention(q, k_, v, attn_mask=vbias)))
        dout = rnd(Bv, Nv, Dv)
        e = _close_rel(report, f"[learn] attention_bwd f32 ({Bv}x{Nv}, {H} heads)",
                       K.attention_bwd(qkv, dout, H, attn_bias=vbias),
                       K.attention_bwd_plain(qkv, dout, H, attn_bias=vbias), TOL_F32)
    sdpa = lambda a, b_, c_: F.scaled_dot_product_attention(a, b_, c_, attn_mask=vbias)  # noqa
    entries.append(learn_entry(
        torch, "attention_bwd", f"ViT f32 ({Bv}x{Nv}, {H} heads; launches: the train steps)",
        e, train_launches, lambda: K.attention_bwd(qkv, dout, H, attn_bias=vbias),
        lambda: K.attention_bwd_plain(qkv, dout, H, attn_bias=vbias),
        attention_bwd_bound(qkv, attn_bias=vbias)))
    entries[-1]["library_ms"] = _library_grad_ms(
        torch, sdpa, [q, k_, v], dout.view(Bv, Nv, H, Dv // H).permute(0, 2, 1, 3))
    with torch.no_grad():
        dh = rnd(*x2.shape)
        e = max(_close_rel(report, f"[learn] layernorm_bwd f32 ({x2.shape[0]}x{Dv}) {name}", a,
                           b_, TOL_F32)
                for name, a, b_ in zip(("dx", "dg", "db"), K.layernorm_bwd(x2, g1, dh, 1e-6),
                                       K.layernorm_bwd_plain(x2, g1, dh, 1e-6)))
        entries.append(learn_entry(
            torch, "layernorm_bwd", f"ViT norm1 f32 ({x2.shape[0]}x{Dv}; launches: the train "
            "steps)", e, train_launches, lambda: K.layernorm_bwd(x2, g1, dh, 1e-6),
            lambda: K.layernorm_bwd_plain(x2, g1, dh, 1e-6),
            bound(nbytes(x2, dh, g1) + nbytes(x2) + 2 * Dv * 4, 12 * x2.numel())))
    entries[-1]["library_ms"] = _library_grad_ms(
        torch, lambda a, g: F.layer_norm(a, (Dv,), g, b1, 1e-6), [x2, g1], dh)
    with torch.no_grad():
        dy = rnd(x2.shape[0], 3 * Dv)
        e = max(_close_rel(report, f"[learn] linear_wgrad f32 ({x2.shape[0]}x{Dv})^T "
                           f"({x2.shape[0]}x{3 * Dv}) {name}", a, b_, TOL_F32)
                for name, a, b_ in zip(("dW", "db"), K.linear_wgrad(h, dy),
                                       K.linear_wgrad_plain(h, dy)))
        entries.append(learn_entry(
            torch, "linear_wgrad", f"ViT qkv f32 ({x2.shape[0]}x{Dv})^T ({x2.shape[0]}x"
            f"{3 * Dv}; launches: the train steps)", e, train_launches,
            lambda: K.linear_wgrad(h, dy), lambda: K.linear_wgrad_plain(h, dy),
            wgrad_bound(h, dy), lambda: torch.matmul(h.t(), dy)))
        a_fc, dh_fc = rnd(x2.shape[0], 4 * Dv), rnd(x2.shape[0], 4 * Dv)
        e = _close_rel(report, f"[learn] act_dropout_bwd gelu ({x2.shape[0]}x{4 * Dv})",
                       K.act_dropout_bwd(dh_fc, a_fc, "gelu"),
                       K.act_dropout_bwd_plain(dh_fc, a_fc, "gelu"), TOL_F32)
        entries.append(learn_entry(
            torch, "act_dropout_bwd", f"ViT fc1 GELU ({x2.shape[0]}x{4 * Dv}; launches: the "
            "train steps)", e, train_launches, lambda: K.act_dropout_bwd(dh_fc, a_fc, "gelu"),
            lambda: K.act_dropout_bwd_plain(dh_fc, a_fc, "gelu"),
            bound(3 * nbytes(a_fc), 20 * a_fc.numel()),
            lambda: torch.ops.aten.gelu_backward(dh_fc, a_fc)))
        for key, (name, args, e) in sampler_args.items():
            a_k = [t.clone() if torch.is_tensor(t) else t for t in args]  # x updated in place
            entries.append(learn_entry(
                torch, key, f"{name} (launches: the GGS sample)", e, ggs_launches,
                lambda f=getattr(K, key), a=a_k: f(*a),
                lambda f=getattr(K, f"{key}_plain"), a=a_k: f(*a), sampler_bound(key, args)))
        ra, rk = rows_args[1], rows_args[2]
        entries.append(learn_entry(
            torch, "linear_rows", f"denoiser in_proj bf16, LayerNorm folded ({n}x{De} @ "
            f"{De}x{3 * De}; launches: the GGS sample)", errs["linear_rows"], ggs_launches,
            lambda: K.linear(*ra, **rk), lambda: K.linear_plain(*ra, **rk),
            linear_bound(ra[0], ra[1], ra[2])))
    chunk = default_chunk_pairs(gm)
    tab = ggs_tables(G.pad_grouped_pairs(gm, chunk))
    kw100 = dict(iters=LEARN_GGS_ITERS, **GGS_PHASE)
    call = lambda: K.ggs_phase_chunked(x_g, tab, hw, True, True, True, 10.0,  # noqa: E731
                                       chunk=chunk, **kw100)
    _, count, _ = loss_and_grad_core(call(), tab.kp1x, tab.kp1y, tab.kp2x, tab.kp2y, tab.valid,
                                     tab.B1, tab.B2, hw, True, True, True, 10.0)
    report.require("[learn] the timed GGS phase never stopped",
                   count.item() / n >= GGS_PHASE["min_matches"], f"({count.item():.0f} matches)")
    e = learn_entry(
        torch, "ggs_phase_chunked", f"{LEARN_GGS_ITERS}-iteration phase, {n} frames, "
        f"{n_match} matches (cluster {K.ggs_phase_chunked.cluster}; launches: the GGS sample)",
        errs["ggs_phase_chunked"], ggs_launches, call,
        lambda: K.ggs_phase_chunked_plain(x_g, tab, hw, True, True, True, 10.0, chunk=chunk,
                                          **kw100),
        bound(5 * nbytes(gm.valid) + 2 * nbytes(x_g),
              LEARN_GGS_ITERS * n_match * GGS_FLOP_PER_MATCH), slow_plain=True)
    entries.append(e)
    render, step = np.asarray(run["render_ms"][1:]), np.asarray(run["step_ms"][1:])
    timings = {"[learn] render ms a step (host, median)": float(np.median(render)),
               "[learn] train step ms (median)": float(np.median(step)),
               f"[learn] mean loss steps 0-99": first,
               f"[learn] mean loss steps {LEARN_STEPS - 100}-{LEARN_STEPS - 1}": last,
               "[learn] seconds": time.perf_counter() - t_phase}
    for name, v in timings.items():
        print(f"  {name}: {v:.4f}")
    print(f"  [learn] done at {time.perf_counter() - t_start:.0f} s", flush=True)
    return entries, timings, {"train step": run["launches"], f"{LEARN_STEPS} train steps":
                              train_launches, "GGS sample": ggs_launches}


def sum_partials_entry(report, torch, K, dev, f32_step, bf16_step):
    """The kernels-line entry of csrc/train.cu's sum_partials_kernel (the
    weight gradients' in-order sum of float32 partials) at fc1's f32 weight
    gradient, (S, 384, 1,536) partials at 512 images: against the same
    in-order sum in plain PyTorch (bitwise) and ``torch.sum`` over S; its
    bound the bytes (S + 1) x 384 x 1,536 x 4; device time by CUDA graph,
    with the partials L2-resident (as in a step) and over SUM_PARTIALS_COLD
    buffers in turn (from memory); launches one f32 DINO train step (the
    bf16 step's beside it)."""
    M, Kk, N = VIT_IMAGES * 264, 384, 1536
    S = -(-M // K.wgrad_rows(M, Kk, N, False))
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    part = torch.randn((S, Kk, N), generator=gen, device=dev)

    def plain():
        out = torch.zeros((Kk, N), device=dev)
        for k in range(S):
            out += part[k]
        return out

    with open(os.path.join(REPO, TRAIN_CU)) as f:
        line = next(i + 1 for i, text in enumerate(f) if "void sum_partials_kernel(" in text)
    err = (K._sum_partials(part) - plain()).abs().max().item()
    report.check(f"sum_partials ({S} x {Kk} x {N}) against the in-order sum", err, 0.0)
    cold = [part] + [torch.randn_like(part) for _ in range(SUM_PARTIALS_COLD - 1)]
    b_ms, b_by = bound(nbytes(part) + Kk * N * 4, S * Kk * N)
    e = {
        "name": "sum_partials", "route": "cuda",
        "source": f"{TRAIN_CU}:{line}",
        "replaces": TPU_KERNELS["linear_wgrad"], "launches": f32_step.get("sum_partials", 0),
        "launches_bf16_step": bf16_step.get("sum_partials", 0), "max_abs_err": err,
        "ms": _time_ms(torch, lambda: K._sum_partials(part), inner=10),
        "plain_ms": _time_ms(torch, plain, reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": _time_ms(torch, lambda: torch.sum(part, 0), inner=10),
        "device_ms": _graph_ms(torch, lambda: K._sum_partials(part)),
        "device_ms_l2_cold": _graph_ms(
            torch, lambda: [K._sum_partials(p) for p in cold]) / len(cold),
        "case": f"fc1's f32 partials ({S} x {Kk} x {N}); launches: one f32 DINO train step "
                f"(launches_bf16_step: one bf16 step); device_ms by CUDA graph, the partials "
                f"L2-resident as in the step (written by linear_wgrad just before); "
                f"device_ms_l2_cold over {SUM_PARTIALS_COLD} buffers in turn, more than the L2",
    }
    print(f"  sum_partials: {e}", flush=True)
    del part, cold
    return e


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    import demo_torch
    from posediffusion_tpu_torch.diffusion import ggs as G
    from posediffusion_tpu_torch.diffusion.gaussian import p_sample_loop
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
    from posediffusion_tpu_torch.geometry.pose_codec import camera_to_pose_encoding
    from posediffusion_tpu_torch.matching import extract as X
    from posediffusion_tpu_torch.matching.superglue import SuperGlue, encode_keypoints
    from posediffusion_tpu_torch.models.denoiser import denoiser_apply_fused
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.denoiser_kernel import (
        fused_trunk,
        fused_trunk_plain,
        stack_trunk_params,
    )
    from posediffusion_tpu_torch.ops.ggs_grad import (
        ggs_tables,
        loss_and_grad_core,
        pack_matches_grouped,
    )
    from posediffusion_tpu_torch.ops.ggs_kernel import (
        default_chunk_pairs,
        ggs_phase_fused,
        ggs_phase_fused_chunked,
        ggs_phase_fused_plain,
    )
    from posediffusion_tpu_torch.ops import superglue_kernel as SGK
    from posediffusion_tpu_torch.ops.sampler_kernel import (
        fused_sample_loop,
        fused_sample_loop_plain,
        prepare_sampler,
    )
    from posediffusion_tpu_torch.ops.vit_kernel import (
        VIT_KEYS,
        fused_vit_trunk,
        fused_vit_trunk_plain,
        stack_vit_params,
    )
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    dev = torch.device("cuda")
    smi = _smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {_nvcc_version()}, python {sys.version.split()[0]}")
    pin_full_float32()
    report = Report()
    t_start = time.perf_counter()
    apple = os.path.join(REPO, "samples", "apple")
    work = os.path.join(REPO, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)

    # ---- 1. build
    t0 = time.perf_counter()
    K.load_library()
    print(f"[build] {K.library_path().name} in {time.perf_counter() - t0:.1f} s")
    parent_calls = None
    if "--parent" in argv:
        rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 1
        parent_calls = parent_phase(report, argv[argv.index("--parent") + 1], smi, rounds)
    if "--wgrad" in argv:  # bf16 mode's weight gradient and its train step alone
        cfg = _train_cfg(work, "train")
        batch, draws, _ = _train_batch(cfg, dev, PoseDiffusionConfig().timesteps)
        bf_timings, bf_launches, bf_by_shape = bf16_train_step(report, torch, K, dev, work,
                                                               batch, draws)
        del batch, draws
        entries = wgrad_bf16_entries(report, torch, K, dev, bf_by_shape, run_device_times())
        print(json.dumps({"wgrad_bf16": entries, "timings_ms": bf_timings, "card": smi}))
        if report.failures:
            print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
            return 1
        return 0
    if "--resnet" in argv:  # the ResNet phases alone: serving, [viz], training, [dp]
        resnet_json, resnet_timings, _ = resnet_slice(report, dev, work, smi, t_start)
        resnet_timings.update(resnet_train_slice(report, dev, work, smi, t_start)[0])
        dp_slice(report, dev, work, t_start)
        print(json.dumps({"kernels": resnet_json, "timings_ms": resnet_timings, "card": smi}))
        if report.failures:
            print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
            return 1
        return 0
    if "--fsdp" in argv:  # [fsdp], [train-336] and [dinov2-bf16] alone
        launches = {"fsdp": fsdp_slice(report, dev, work, t_start)}
        t336, launches["train-336"] = train336_slice(report, dev, work, smi, t_start)
        v2bf, launches["dinov2-bf16"] = dinov2_bf16_slice(report, dev, work, smi, t_start)
        print(json.dumps({"timings_ms": {**t336, **v2bf}, "launches": launches, "card": smi}))
        if report.failures:
            print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
            return 1
        return 0
    if "--learn" in argv:  # [learn] alone
        learn_json, learn_timings, learn_launches = learn_slice(report, dev, smi, t_start)
        print(json.dumps({"kernels": learn_json, "timings_ms": learn_timings,
                          "learn_launches": learn_launches, "card": smi}))
        if report.failures:
            print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
            return 1
        return 0
    if "--vitg" in argv:  # [vitg] alone
        vitg_json, vitg_timings, vitg_launches = vitg_slice(report, dev, work, smi, t_start)
        print(json.dumps({"kernels": vitg_json, "timings_ms": vitg_timings,
                          "vitg_launches": vitg_launches, "card": smi}))
        if report.failures:
            print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
            return 1
        return 0
    if "--attention" in argv:  # the attention cases alone
        attn = attention_slice(report, dev, smi)
        print(json.dumps({"attention_cases": attn, "card": smi}))
        if report.failures:
            print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
            return 1
        return 0

    # ---- 2. kernel parity at the paths' shapes
    print("[parity] kernels against their plain versions")
    model = PoseDiffusionModel(PoseDiffusionConfig())
    init_random_weights(model, SEED)
    model.to(dev)
    vit = model.image_feature_extractor._net
    den = model.diffuser.model
    images_np, _ = load_and_preprocess_images(apple, IMAGE_SIZE)
    images = torch.as_tensor(images_np, device=dev)  # (20, 3, 224, 224)
    n_frames = images.shape[0]
    images336 = torch.as_tensor(load_and_preprocess_images(apple, 336)[0], device=dev)
    with torch.no_grad():
        tokens, bias, _ = _embed_pack_scales(vit, images, model.config.scale_factors)
        tokens336, bias336, _ = _embed_pack_scales(vit, images336, model.config.scale_factors)
    B, N, D = tokens.shape
    print(f"  ViT tokens {tuple(tokens.shape)} (224px), {tuple(tokens336.shape)} (336px); "
          f"sampler rows {n_frames}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.randn((1, n_frames, 9), generator=gen, device=dev)
    noises = torch.randn((model.config.timesteps, 1, n_frames, 9), generator=gen, device=dev)

    cases = {}  # name -> (kernel fn, plain fn, precision) for the JSON line

    def case(name, kernel, plain, args, kwargs, bf16, key=None):
        out_k = kernel(*[a.clone() if torch.is_tensor(a) else a for a in args], **kwargs)
        out_p = plain(*[a.clone() if torch.is_tensor(a) else a for a in args], **kwargs)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        scale = max(1.0, out_p.abs().max().item())
        report.check(name, err, TOL_BF16 if bf16 else TOL_F32, scale)
        if key:
            cases[key] = (name, kernel, plain, args, kwargs, err)
        return out_p

    with torch.no_grad():
        for mode, wdt, act in (("f32", torch.float32, False), ("bf16", torch.bfloat16, True)):
            st = stack_vit_params(vit, wdt)
            w = [st[k][0] for k in VIT_KEYS]
            g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2 = w
            x2 = tokens.reshape(B * N, D).contiguous()
            tag = lambda s: s if mode == "bf16" else None
            h = case(f"layernorm vit {mode} ({B * N}x{D})", K.layernorm, K.layernorm_plain,
                     (x2, g1, b1, 1e-6, act), {}, act, tag("layernorm"))
            qkv = case(f"linear vit qkv {mode} ({B * N}x{D} @ {D}x{3 * D})", K.linear,
                       K.linear_plain, (h, wqkv, bqkv), dict(round_a=act), False,
                       tag("linear_qkv"))
            a = case(f"attention vit {mode} ({B}x{N}, 6 heads)", K.attention,
                     K.attention_plain, (qkv.view(B, N, -1), 6),
                     dict(attn_bias=bias, round_in=act), act, tag("attention"))
            x1 = case(f"linear vit proj+res {mode}", K.linear, K.linear_plain,
                      (a.reshape(B * N, D), wproj, bproj),
                      dict(residual=x2, round_a=act), False)
            h2 = K.layernorm_plain(x1, g2, b2, 1e-6, act)
            f = case(f"linear vit fc1+gelu {mode} ({B * N}x{D} @ {D}x{4 * D})", K.linear,
                     K.linear_plain, (h2, wfc1, bfc1), dict(act="gelu", round_a=act),
                     False, tag("linear"))
            case(f"linear vit fc2+res {mode}", K.linear, K.linear_plain,
                 (f, wfc2, bfc2), dict(residual=x1, round_a=act), False)

            vk = fused_vit_trunk(tokens, st, nhead=6, act_bf16=act, attn_bias=bias)
            vp = fused_vit_trunk_plain(tokens, st, nhead=6, act_bf16=act, attn_bias=bias)
            report.check(f"fused_vit_trunk {mode} (12 blocks)",
                         (vk - vp).abs().max().item(),
                         TOL_VIT_BF16 if act else TOL_VIT_F32)

            # 336px: 442 + 101 + 50 = 593 tokens, keys tiled in the attention kernel
            B3, N3, _ = tokens336.shape
            x3 = tokens336.reshape(B3 * N3, D).contiguous()
            q3 = K.linear_plain(K.layernorm_plain(x3, g1, b1, 1e-6, act), wqkv, bqkv,
                                round_a=act)
            case(f"attention vit 336px {mode} ({B3}x{N3}, 6 heads)", K.attention,
                 K.attention_plain, (q3.view(B3, N3, -1), 6),
                 dict(attn_bias=bias336, round_in=act), act)
            vk = fused_vit_trunk(tokens336, st, nhead=6, act_bf16=act, attn_bias=bias336)
            vp = fused_vit_trunk_plain(tokens336, st, nhead=6, act_bf16=act, attn_bias=bias336)
            report.check(f"fused_vit_trunk 336px {mode} (12 blocks, {N3} tokens)",
                         (vk - vp).abs().max().item(),
                         TOL_VIT_BF16 if act else TOL_VIT_F32)

            z = model.extract_features(images[None])
            inp = prepare_sampler(den, model.schedule, z, weight_dtype=wdt, x0=x0,
                                  noises=noises)
            # csrc/sampler.cu's three entries at the path's 20 rows and a
            # short sequence's 3 (the kernels line takes bf16 mode's 20 rows)
            for n_rows in (n_frames, 3):
                for key, (name, args, err) in sampler_parity(report, torch, K, inp, mode,
                                                             n_rows).items():
                    if mode == "bf16" and n_rows == n_frames:
                        cases[key] = (name, getattr(K, key), getattr(K, f"{key}_plain"),
                                      args, {}, err)
            hp = K.sampler_prologue_plain(inp.x0, *inp.prologue, 0)
            lw = inp.layers[0]
            rows = hp.shape[0]
            hl = case(f"layernorm den {mode} ({rows}x512)", K.layernorm, K.layernorm_plain,
                      (hp, lw[0], lw[1], 1e-5, False), {}, False, tag("layernorm_rows"))
            qd = case(f"linear den qkv {mode} ({rows}x512 @ 512x1536)", K.linear,
                      K.linear_plain, (hl, lw[2], lw[3]), {}, False)
            ad = case(f"attention den {mode} (1x{rows}, 4 heads)", K.attention,
                      K.attention_plain, (qd.view(1, rows, -1), 4),
                      dict(key_bias=inp.key_bias), False)
            case(f"linear den ff1+relu {mode}", K.linear, K.linear_plain,
                 (hl, lw[8], lw[9]), dict(act="relu"), False)
            # the four products of a layer as the sampler runs them: the
            # few-rows route, LayerNorm folded into in_proj and linear1
            hff = torch.relu(K.linear_plain(hp, lw[8], lw[9], ln=(lw[6], lw[7], 1e-5)))
            for pname, args, kw in rows_products(lw, hp, ad.reshape(rows, -1), hff):
                tagged = tag(f"linear_rows {pname}")
                case(f"linear_rows {pname} {mode} ({rows}x{args[1].shape[0]} @ "
                     f"{args[1].shape[0]}x{args[1].shape[1]})", K.linear, K.linear_plain,
                     args, kw, False, tagged)
                y = K.linear(*args, **kw)
                report.require(f"linear_rows {pname} {mode}: four calls bitwise equal",
                               all(torch.equal(y, K.linear(*args, **kw)) for _ in range(3)))
                if "ln" in kw:  # the same product on the LayerNorm's output
                    h_ln = K.layernorm_plain(args[0], *kw["ln"])
                    case(f"linear_rows {pname} {mode} on a normalised input",
                         K.linear, K.linear_plain,
                         (h_ln, *args[1:]), {k: v for k, v in kw.items() if k != "ln"}, False)

            stk = stack_trunk_params(den._trunk, wdt)
            trunk_bias = torch.zeros(n_frames, device=dev)
            trunk_bias[-3:] = K.NEG  # three masked frames
            report.check(f"fused_trunk {mode} (8 layers, {n_frames} rows, key mask)",
                         (fused_trunk(hp, trunk_bias, stk, 4)
                          - fused_trunk_plain(hp, trunk_bias, stk, 4)).abs().max().item(),
                         TOL_F32, max(1.0, hp.abs().max().item()))

            T = model.config.timesteps
            x0_moved = x0 + CHAOS_PERTURBATION * torch.randn(
                x0.shape, generator=gen, device=dev)
            for steps, floor in TOL_STEPS.items():
                def chain(fn, start):
                    return fn(den, model.schedule, z, n_cond=T - steps, weight_dtype=wdt,
                              x0=start, noises=noises[:steps])
                ref = chain(fused_sample_loop_plain, x0)
                spread = (chain(fused_sample_loop_plain, x0_moved) - ref).abs().max().item()
                err = (chain(fused_sample_loop, x0) - ref).abs().max().item()
                report.check(f"{steps} reverse steps {mode} (plain chain spread under a "
                             f"{CHAOS_PERTURBATION:.1e} x0 perturbation: {spread:.2e})",
                             err, max(floor, CHAOS_FACTOR * spread))

    # GGS: synthetic matches through the ground-truth cameras, f32
    gt = np.load(os.path.join(apple, "gt_cameras.npz"))
    gt_enc = camera_to_pose_encoding(PerspectiveCameras.create(
        R=gt["gtR"], T=gt["gtT"], focal_length=gt["gtFL"], device=dev))
    x_ggs = (gt_enc + 0.05 * torch.randn(gt_enc.shape, generator=gen, device=dev)).contiguous()
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    matches = {d: synthetic_matches(apple, d, SEED + d) for d in MATCH_DENSITIES}
    grouped = {d: pack_matches_grouped(*matches[d], n_frames, device=dev)
               for d in MATCH_DENSITIES}
    ggs_cases = {}
    for d in MATCH_DENSITIES:
        gm = grouped[d]
        kw = dict(iters=30, **GGS_PHASE)
        ref = ggs_phase_fused_plain(x_ggs, gm, hw, True, True, True, 10.0, **kw)
        res = ggs_phase_fused(x_ggs, gm, hw, True, True, True, 10.0, **kw)
        chk = ggs_phase_fused_chunked(x_ggs, gm, hw, True, True, True, 10.0, **kw)
        torch.cuda.synchronize()
        tag = f"{d}/pair, table {tuple(gm.valid.shape)}, 30 iterations"
        e_res = (res - ref).abs().max().item()
        e_chk = (chk - ref).abs().max().item()
        report.check(f"ggs_phase {tag}", e_res, TOL_GGS_30)
        report.check(f"ggs_phase_chunked {tag}", e_chk, TOL_GGS_30)
        report.check(f"ggs_phase_chunked vs ggs_phase {tag}",
                     (chk - res).abs().max().item(), TOL_GGS_CHUNKED)
        report.require(f"ggs phase moved x ({tag})", not torch.equal(res, x_ggs))
        ggs_cases[("ggs_phase", d)] = e_res
        ggs_cases[("ggs_phase_chunked", d)] = e_chk
        starved = gm._replace(valid=torch.zeros_like(gm.valid))
        starved.valid[0, :5] = 1.0
        for name, fn in (("ggs_phase", ggs_phase_fused),
                         ("ggs_phase_chunked", ggs_phase_fused_chunked)):
            out = fn(x_ggs, starved, hw, True, True, True, 10.0, iters=10, **GGS_PHASE)
            report.require(f"{name} early stop leaves x bit-identical ({d}/pair)",
                           torch.equal(out, x_ggs))
    print("[ggs-grid] the GGS kernels at 6, 20 and 50 frames, 100 and 1,024 matches a pair, "
          "the five phases", flush=True)
    for key, err in ggs_grid(report, torch, dev).items():
        ggs_cases[(key, "grid")] = err

    # one whole 5-phase cond_fn (700 iterations) and the 10-step conditioned tail
    cfg_full = G.GGSConfig()
    x_moved = x_ggs + CHAOS_PERTURBATION * torch.randn(x_ggs.shape, generator=gen, device=dev)
    gm100 = grouped[MATCH_DENSITIES[0]]
    cond100 = G.make_ggs_cond_fn(None, hw, cfg_full, gm100, K.KERNELS)
    cond100_plain = G.make_ggs_cond_fn(None, hw, cfg_full, gm100, K.PLAIN)
    ref = cond100_plain(x_ggs[None], 0)
    spread = (cond100_plain(x_moved[None], 0) - ref).abs().max().item()
    err = (cond100(x_ggs[None], 0) - ref).abs().max().item()
    report.check(f"GGS cond_fn, 5 phases, 700 iterations, 100/pair (plain spread under a "
                 f"{CHAOS_PERTURBATION:.1e} perturbation: {spread:.2e})",
                 err, max(TOL_GGS_CONDFN, CHAOS_FACTOR * spread))

    cfg_tail = G.GGSConfig(iter_num=10)
    wdt = model.weight_dtype
    with torch.no_grad():
        z = model.extract_features(images[None])
        n_cond = cfg_tail.start_step
        x_head = fused_sample_loop(den, model.schedule, z, n_cond=n_cond, weight_dtype=wdt,
                                   x0=x0, noises=noises[:model.config.timesteps - n_cond])
        stk = stack_trunk_params(den._trunk, wdt)

        def tail(ops, start, cfg=cfg_tail):
            trunk = fused_trunk if ops is K.KERNELS else fused_trunk_plain
            return p_sample_loop(
                model.schedule,
                lambda xt, t: denoiser_apply_fused(den, xt, t, z, None, stk, trunk=trunk),
                start.shape, dev, noises=torch.zeros((n_cond, *start.shape), device=dev),
                x_init=start, from_t=n_cond,
                cond_fn=G.make_ggs_cond_fn(None, hw, cfg, gm100, ops),
                cond_start_step=n_cond)

        ref = tail(K.PLAIN, x_head)
        spread = (tail(K.PLAIN, x_head + CHAOS_PERTURBATION) - ref).abs().max().item()
        err = (tail(K.KERNELS, x_head) - ref).abs().max().item()
        report.check(f"conditioned tail, 10 steps, GGS.iter_num 10, 100/pair (plain spread "
                     f"under a {CHAOS_PERTURBATION:.1e} perturbation: {spread:.2e})",
                     err, max(TOL_GGS_TAIL, CHAOS_FACTOR * spread))
        # the sampler and the tail's trunk passes launch no layernorm: both
        # LayerNorms of a layer ride its products (1 + 5 L launches a step:
        # the layers and one boundary launch, and step 0's prologue)
        L = model.config.num_encoder_layers
        T = model.config.timesteps
        counts = {}
        for what, run in (("the sampler", lambda: fused_sample_loop(
                              den, model.schedule, z, x0=x0, noises=noises)),
                          ("the GGS tail", lambda: tail(K.KERNELS, x_head))):
            K.reset_launch_counts()
            run()
            torch.cuda.synchronize()
            counts[what] = K.launch_counts()
            print(f"  launches of {what}: {counts[what]}")
            report.require(f"{what} launches no layernorm and runs linear_rows",
                           counts[what]["layernorm"] == 0 and counts[what]["linear_rows"] > 0)
        total = sum(counts["the sampler"].values())
        per_step = (total - 1) / T
        report.require(f"a sampler step is 1 + 5 L = {1 + 5 * L} launches (and step 0's "
                       "prologue)", total == T * (1 + 5 * L) + 1, f"({total} in {T} steps)")
        entries = {k: counts["the sampler"][k] for k in SAMPLER_ENTRIES}
        report.require(f"the sampler launches 1 prologue, {T - 1} boundaries and 1 epilogue",
                       entries == {"sampler_prologue": 1, "sampler_boundary": T - 1,
                                   "sampler_epilogue": 1}, f"({entries})")
    torch.cuda.synchronize()

    # SuperGlue at the matcher's shapes: 32 pairs of 1,024 keypoints, f32,
    # partial masks; tokens from seeded descriptors through the keypoint encoder
    sg_model = SuperGlue()
    sg_model.load_state_dict(random_superglue_sd(SEED + 1), strict=True)
    sg_model.eval().to(dev)
    sg_st = SGK.stack_superglue_params(sg_model)
    Cp, Kp, Dp = SG_PAIRS, MATCH_KEYPOINTS, 256
    r = np.random.default_rng(SEED)
    desc = r.normal(size=(2 * Cp, Kp, Dp))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x_sg = encode_keypoints(
        sg_model, f32(desc), f32(r.uniform(0, [1896, 1072], size=(2 * Cp, Kp, 2))),
        f32(r.uniform(size=(2 * Cp, Kp))), f32(np.tile([1072, 1896], (2 * Cp, 1)))
    ).view(Cp, 2, Kp, Dp).contiguous()
    keep = lambda: torch.as_tensor(
        np.arange(Kp)[None] < r.integers(int(0.6 * Kp), Kp + 1, size=(Cp, 1)), device=dev)
    sg_m0, sg_m1 = keep(), keep()
    sg_f0, sg_f1 = sg_m0.float(), sg_m1.float()
    sg_tag = f"{Cp} pairs, K {Kp}"
    h_sg = x_sg.reshape(-1, Dp)
    qkv_sg = case(f"linear superglue qkv ({h_sg.shape[0]}x{Dp} @ {Dp}x{3 * Dp})", K.linear,
                  K.linear_plain, (h_sg, sg_st["wqkv"][0], sg_st["bqkv"][0]), {}, False,
                  "linear_sg_qkv")
    report.require("linear superglue qkv f32 repeats bitwise", torch.equal(
        K.linear(h_sg, sg_st["wqkv"][0], sg_st["bqkv"][0]),
        K.linear(h_sg, sg_st["wqkv"][0], sg_st["bqkv"][0])))
    cat_sg = torch.cat([h_sg, qkv_sg[:, :Dp]], 1)
    case(f"linear superglue w1+relu ({h_sg.shape[0]}x{2 * Dp} @ {2 * Dp}x{2 * Dp})",
         K.linear, K.linear_plain, (cat_sg, sg_st["w1"][0], sg_st["b1"][0]), dict(act="relu"),
         False, "linear_sg")
    bias_self = torch.where(torch.stack([sg_m0, sg_m1], 1), 0.0, K.SG_NEG).reshape(2 * Cp, Kp)
    bias_cross = bias_self.view(Cp, 2, Kp).flip(1).reshape(2 * Cp, Kp).contiguous()
    qkv_sg = qkv_sg.view(2 * Cp, Kp, 3 * Dp)
    case(f"attention superglue self ({2 * Cp}x{Kp}, 4 heads, key mask)", K.attention,
         K.attention_plain, (qkv_sg, 4), dict(key_bias=bias_self.contiguous()), False,
         "attention_sg")
    # cross layout: k | v (and the key bias) from the other set of each pair
    qkv_x = qkv_sg.view(Cp, 2, Kp, 3 * Dp)
    qkv_x = torch.cat([qkv_x[..., :Dp], qkv_x[..., Dp:].flip(1)], -1)
    case(f"attention superglue cross ({2 * Cp}x{Kp}, 4 heads, key mask)", K.attention,
         K.attention_plain, (qkv_x.reshape(2 * Cp, Kp, 3 * Dp).contiguous(), 4),
         dict(key_bias=bias_cross), False)

    m_sg = SGK.gnn_projections(K.PLAIN, x_sg, sg_m0, sg_m1, sg_st)
    cp_k = K.superglue_coupling(m_sg, sg_f0, sg_f1, sg_st["bin"])
    cp_p = K.superglue_coupling_plain(m_sg, sg_f0, sg_f1, sg_st["bin"])
    ones = torch.ones_like(sg_f0[:, :1])
    live = ((torch.cat([sg_f0, ones], 1) > 0.5)[:, :, None]
            & (torch.cat([sg_f1, ones], 1) > 0.5)[:, None, :])
    sg_err = {"superglue_coupling": (cp_k[0][live] - cp_p[0][live]).abs().max().item()}
    report.check(f"superglue_coupling ({sg_tag}, live cells)", sg_err["superglue_coupling"],
                 TOL_F32, max(1.0, cp_p[0][live].abs().max().item()))
    report.require("superglue_coupling masked cells equal (-1e9)",
                   torch.equal(cp_k[0][~live], cp_p[0][~live]))
    report.require("superglue_coupling repeats bitwise", torch.equal(
        cp_k[0], K.superglue_coupling(m_sg, sg_f0, sg_f1, sg_st["bin"])[0]))
    report.check("superglue_coupling marginals and norm",
                 max((a - b).abs().max().item() for a, b in zip(cp_k[1:], cp_p[1:])), TOL_F32)
    Zk = K.superglue_sinkhorn(*cp_p, 50)
    Zp = K.superglue_sinkhorn_plain(*cp_p, 50)
    sg_err["superglue_sinkhorn"] = (Zk[live] - Zp[live]).abs().max().item()
    report.check(f"superglue_sinkhorn Z ({sg_tag}, 50 iterations, live cells)",
                 sg_err["superglue_sinkhorn"], TOL_F32)
    mk, sk = K.superglue_matches(Zp, sg_f0, sg_f1, 0.0)
    mp, sp = K.superglue_matches_plain(Zp, sg_f0, sg_f1, 0.0)
    sg_err["superglue_matches"] = (sk - sp).abs().max().item()
    report.require("superglue_matches identical on the same Z",
                   torch.equal(mk, mp), f"({(mk != mp).sum().item()} rows differ)")
    report.check("superglue_matches mscores", sg_err["superglue_matches"], TOL_F32)
    fk, fsk = SGK.fused_match_pairs(x_sg, sg_m0, sg_m1, sg_st, match_threshold=0.0)
    fp, fsp = SGK.fused_match_pairs_plain(x_sg, sg_m0, sg_m1, sg_st, match_threshold=0.0)
    n_bad, gap = match_mismatches(x_sg, sg_m0, sg_m1, sg_st, fk, fp)
    print(f"  fused_match_pairs ({sg_tag}): {(fp >= 0).sum().item()} plain matches, "
          f"{(fk >= 0).sum().item()} kernel matches, {n_bad} rows differ, largest tie gap "
          f"{gap:.3e}")
    report.require(f"fused_match_pairs kernel vs plain: rows differ only at near-ties "
                   f"(gap < {NEAR_TIE:.0e})", gap < NEAR_TIE)
    agree = (fk == fp) & (fp >= 0)
    report.check("fused_match_pairs mscores of agreeing matches",
                 (fsk[agree] - fsp[agree]).abs().max().item(), TOL_F32)
    torch.cuda.synchronize()
    print(f"  [parity] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- 3. main path: demo_torch's flow on samples/apple, GGS off
    print("[main] demo_torch on samples/apple, GGS off, random weights")

    K.reset_launch_counts()
    out_plain = demo_torch.run(demo_cfg(work, apple, "GGS.enable=False"), "cuda")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    _check_launches(report, "no-GGS", NO_GGS_PATH, launches)
    T = model.config.timesteps
    per_inference = {k: launches[k] / DEMO_INFERENCES for k in SAMPLER_ENTRIES}
    report.require(f"an inference launches 1 prologue, {T - 1} step boundaries and 1 epilogue",
                   per_inference == {"sampler_prologue": 1, "sampler_boundary": T - 1,
                                     "sampler_epilogue": 1}, f"({per_inference})")
    main_linear_shapes = dict(K.linear.by_shape)
    _note_layernorm_shapes(K, "no-GGS path")
    rows_by_shape = dict(K.linear_rows.by_shape)
    print(f"  linear_rows launches by (M, K, N): {rows_by_shape}")
    _check_cameras(report, out_plain, n_frames, "no-GGS")

    # ---- 4. GGS path: the same flow with GGS on, from synthetic matches
    print("[ggs] demo_torch on samples/apple, GGS on, synthetic matches")
    subset = subset_folder(apple, os.path.join(work, f"apple{SUBSET_FRAMES}"), SUBSET_FRAMES)
    runs = [(apple, d, None) for d in MATCH_DENSITIES] + [
        (subset, MATCH_DENSITIES[0], SUBSET_FRAMES)]
    files = [write_matches(os.path.join(work, f"matches_{os.path.basename(f)}_{d}.npz"),
                           apple, d, SEED + d, frames=fr) for f, d, fr in runs]
    K.reset_launch_counts()
    fused_trunk.launches = 0
    ggs_outs = []
    ggs_per_inference = {}  # GGS kernel launches of one inference (a run makes two)
    for (folder, d, fr), path in zip(runs, files):
        before = K.launch_counts()
        out = demo_torch.run(demo_cfg(work, folder, "GGS.enable=True",
                                      f"GGS.matches_file={path}"), "cuda")
        after = K.launch_counts()
        what = f"{fr or n_frames} frames, {d}/pair"
        ggs_per_inference[what] = {k: (after[k] - before[k]) // DEMO_INFERENCES
                                   for k in ("ggs_phase", "ggs_phase_chunked")}
        _check_cameras(report, out, fr or n_frames, f"GGS {what}")
        ggs_outs.append(out)
    print(f"  GGS kernel launches per inference: {ggs_per_inference}")
    for what, c in ggs_per_inference.items():
        report.require(f"one GGS inference ({what}) launches 50 GGS phases",
                       c["ggs_phase"] + c["ggs_phase_chunked"] == 50, f"({c})")
    torch.cuda.synchronize()
    ggs_launches = K.launch_counts()
    _check_launches(report, "GGS", GGS_PATH, ggs_launches)
    print(f"  fused_trunk passes on the card: {fused_trunk.launches}")
    report.require("fused_trunk ran on the GGS path", fused_trunk.launches > 0)
    flat = G.pack_matches(*matches[100], n_frames, pad_to=1 << 15, device=dev)
    samp = {name: G.sampson_report(torch.as_tensor(o["pose_encoding"], device=dev), flat, hw).item()
            for name, o in (("no GGS", out_plain), ("GGS", ggs_outs[0]))}
    print(f"  mean Sampson error (clamped at 10) on the 100/pair matches: "
          f"no GGS {samp['no GGS']:.4f}, GGS {samp['GGS']:.4f} px^2 (random weights)")
    report.require("Sampson error of the GGS output is finite", np.isfinite(samp["GGS"]))
    x_noisy = gt_enc + 0.01 * torch.randn(gt_enc.shape, generator=gen, device=dev)
    before = G.sampson_report(x_noisy[None], flat, hw).item()
    one = ggs_phase_fused_chunked(x_noisy, gm100, hw, True, True, True, 10.0, iters=200,
                                  **GGS_PHASE)
    after = G.sampson_report(one[None], flat, hw).item()
    report.require("one phase from the ground truth + 0.01 lowers sampson_report",
                   after < before, f"({before:.4f} -> {after:.4f})")
    print(f"  [ggs] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- 4b. match path: demo_torch with GGS on and matches extracted
    print("[match] demo_torch on samples/apple, GGS on, matches extracted from the images "
          "(random MagicLeap weights)")
    wdir = write_matcher_weights(os.path.join(work, "matcher"), SEED)
    K.reset_launch_counts()
    for folder, n, kp in ((apple, n_frames, MATCH_KEYPOINTS), (subset, SUBSET_FRAMES, None)):
        extra = [] if kp is None else [f"GGS.max_keypoints={kp}"]
        out = demo_torch.run(demo_cfg(work, folder, "GGS.enable=True",
                                      f"GGS.matcher_ckpt_dir={wdir}", *MATCH_ARGS, *extra),
                             "cuda")
        what = f"extracted matches, {n} frames, max_keypoints {kp or 4096}"
        _check_cameras(report, out, n, what)
        report.require(f"{what}: GGS sampled with matches", out["ggs_matches"] > 0,
                       f"({out['ggs_matches']} matches)")
    torch.cuda.synchronize()
    match_launches = K.launch_counts()
    match_linear_shapes = dict(K.linear.by_shape)
    _check_launches(report, "match", MATCH_PATH, match_launches)
    print(f"  [match] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- 4c. DDIM and pred_x0; 4d. the Co3D evaluation (test_torch.main)
    ddim_timings, ddim_launches, x0_step = ddim_slice(
        report, dev, work, t_start, model, images, x0, noises, gen, matches[100], cond100,
        cond100_plain)
    eval_timings, eval_launches = eval_slice(report, dev, work, t_start, wdir)

    # ---- 5. the training slice: parity of its kernels, train_torch.py, timings
    # device times of bf16 mode's weight gradient and the sampler's prologue
    # and epilogue, read in a child process (the profiler under-reads here)
    child_ms = run_device_times()
    train_json, train_timings, dino_step, dino_bf16_step = train_slice(report, dev, work, smi,
                                                                       t_start, child_ms)
    # ---- 5b. DINOv2 (LayerScale) serving and training, and ViT-B
    bb_json, bb_timings, bb_rows, bb_steps = backbones_slice(report, dev, work, smi, t_start,
                                                             dino_step)
    # ---- 5c. the ResNet backbones: serving ([resnet], [viz]), training, data parallelism
    resnet_json, resnet_timings, resnet_launches = resnet_slice(report, dev, work, smi, t_start)
    resnet_train_timings, resnet_step = resnet_train_slice(report, dev, work, smi, t_start)
    dp_launches = dp_slice(report, dev, work, t_start)
    # ---- 5d. FSDP at world size 1, a train step at 336px, DINOv2 at bf16
    fsdp_launches = fsdp_slice(report, dev, work, t_start)
    t336_timings, t336_launches = train336_slice(report, dev, work, smi, t_start)
    v2bf_timings, v2bf_launches = dinov2_bf16_slice(report, dev, work, smi, t_start)
    # ---- 5e. the learnability experiment's widths: parity, train steps, a GGS sample
    learn_json, learn_timings, learn_launches = learn_slice(report, dev, smi, t_start)
    # ---- 5f. DINOv2 ViT-g/14: a train step, its gate and wide kernels at its shapes
    vitg_json, vitg_timings, vitg_launches = vitg_slice(report, dev, work, smi, t_start)

    # ---- 6. timing (default mode, CUDA events after warm-up)
    print(f"[timing] medians of {N_TIMED}, card: {smi}")
    imgs = images[None]
    with torch.no_grad():
        z = model.extract_features(imgs)
        stb = stack_vit_params(vit, torch.bfloat16)
        timings = {
            "inference (extract + 100-step sampler)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=noises)),
            "GGS inference (extract + 90 steps + 10 GGS steps, 100/pair)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=noises, cond_fn=cond100,
                                            cond_start_step=10), reps=5),
            "conditioned tail (10 GGS steps, 100/pair)": _time_ms(
                torch, lambda: tail(K.KERNELS, x_head, cfg_full), reps=5),
            "GGS cond_fn (5 phases, 700 iterations, 100/pair)": _time_ms(
                torch, lambda: cond100(x_ggs[None], 0), reps=5),
            "extractor (extract_features)": _time_ms(torch, lambda: model.extract_features(imgs)),
            "sampler (fused_sample_loop, 100 steps)": _time_ms(
                torch, lambda: fused_sample_loop(den, model.schedule, z, x0=x0, noises=noises)),
            "sampler plain (fused_sample_loop_plain)": _time_ms(
                torch, lambda: fused_sample_loop_plain(den, model.schedule, z, x0=x0,
                                                       noises=noises)),
            "vit trunk (fused_vit_trunk, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk(tokens, stb, 6, True, bias)),
            "vit trunk plain (fused_vit_trunk_plain, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk_plain(tokens, stb, 6, True, bias)),
            "vit trunk 336px (fused_vit_trunk, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk(tokens336, stb, 6, True, bias336)),
            "vit trunk 336px plain (fused_vit_trunk_plain, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk_plain(tokens336, stb, 6, True, bias336)),
        }
        # the trunk's device time without the host's launch cost (84
        # launches), and so the share of its wall time the card is idle
        for px, tok, bb in ((224, tokens, bias), (336, tokens336, bias336)):
            dev_ms = _graph_ms(torch, lambda: fused_vit_trunk(tok, stb, 6, True, bb), calls=2)
            wall = timings[f"vit trunk{'' if px == 224 else ' 336px'} (fused_vit_trunk, bf16)"]
            timings[f"vit trunk {px}px CUDA graph (device)"] = dev_ms
            print(f"  fused_vit_trunk {px}px: {dev_ms:.3f} ms on the card (CUDA graph) of "
                  f"{wall:.3f} ms wall ({100 * (1 - dev_ms / wall):.1f}% idle)")
        hd = torch.randn((n_frames, 512), generator=gen, device=dev)
        zb = torch.zeros(n_frames, device=dev)
        timings["fused_trunk (8 layers, 20 rows, bf16)"] = _time_ms(
            torch, lambda: fused_trunk(hd, zb, stk, 4), inner=10)
        timings["fused_trunk plain"] = _time_ms(
            torch, lambda: fused_trunk_plain(hd, zb, stk, 4), inner=10)
        timings["fused_trunk device (profiler)"] = _kernel_device_ms(
            torch, lambda: fused_trunk(hd, zb, stk, 4), None)
        # a sampler step's host/device split: the kernels' device time (the
        # once-per-call set-up amortised over the steps) against the wall time
        step_dev = _kernel_device_ms(torch, lambda: fused_sample_loop(
            den, model.schedule, z, x0=x0, noises=noises), None, calls=3) / T
        step_wall = timings["sampler (fused_sample_loop, 100 steps)"] / T
        timings["sampler step device (profiler)"] = step_dev
        timings["sampler step wall (CUDA events)"] = step_wall
        # the route's mean device time inside the loop, where the 8 layers'
        # weights (33.6 MB in bf16) cycle through the 50 MB L2, beside the
        # same products called alone (the kernels line, weights warm)
        timings["linear_rows mean per launch inside the sampler (device)"] = _kernel_device_ms(
            torch, lambda: fused_sample_loop(den, model.schedule, z, x0=x0, noises=noises),
            "linear_rows_kernel", calls=3) / (4 * L * T)
        print(f"  a sampler step: device {1e3 * step_dev:.2f} us of {1e3 * step_wall:.2f} us "
              f"wall ({100 * (1 - step_dev / step_wall):.1f}% of the step the card is idle, "
              f"{1 + 5 * L} launches)")
        step_key = "sampler step device (child process)"
        fold_key = "sampler_step_kernel a step inside the sampler (child process)"
        timings[step_key], timings[fold_key] = child_ms[step_key], child_ms[fold_key]
        print(f"  a sampler step in a child process: device {1e3 * child_ms[step_key]:.2f} us "
              f"of {1e3 * step_wall:.2f} us wall, of it {1e3 * child_ms[fold_key]:.2f} us in "
              "the step's boundary launch")
        for tok, bb, px in ((tokens, bias, 224), (tokens336, bias336, 336)):
            Bt, Nt, _ = tok.shape
            qkv_t = torch.randn((Bt, Nt, 3 * D), generator=gen, device=dev)
            timings[f"attention {Nt} tokens ({px}px, bf16 mode)"] = _time_ms(
                torch, lambda: K.attention(qkv_t, 6, attn_bias=bb, round_in=True), inner=10)
            timings[f"attention {Nt} tokens plain"] = _time_ms(
                torch, lambda: K.attention_plain(qkv_t, 6, attn_bias=bb, round_in=True),
                inner=10)
    ggs_ms = {}
    kw = dict(iters=200, **GGS_PHASE)
    for d in MATCH_DENSITIES:
        gm = grouped[d]
        chunk = default_chunk_pairs(gm)
        tab_r = ggs_tables(gm)
        tab_c = ggs_tables(G.pad_grouped_pairs(gm, chunk))
        for name, call, plain in (
            ("ggs_phase",
             lambda: K.ggs_phase(x_ggs, tab_r, hw, True, True, True, 10.0, **kw),
             lambda: K.ggs_phase_plain(x_ggs, tab_r, hw, True, True, True, 10.0, **kw)),
            ("ggs_phase_chunked",
             lambda: K.ggs_phase_chunked(x_ggs, tab_c, hw, True, True, True, 10.0,
                                         chunk=chunk, **kw),
             lambda: K.ggs_phase_chunked_plain(x_ggs, tab_c, hw, True, True, True, 10.0,
                                               chunk=chunk, **kw)),
        ):
            ms = _time_ms(torch, call, reps=5)
            plain_ms = _time_ms(torch, plain, reps=3, warmup=1)
            ggs_ms[(name, d)] = (ms, plain_ms)
            timings[f"{name} 200 iterations {d}/pair"] = ms
            timings[f"{name} plain 200 iterations {d}/pair"] = plain_ms
            print(f"  {name} 20 frames, {d}/pair: {ms:.4f} ms per 200 iterations, "
                  f"{1e3 * ms / 200:.3f} us an iteration (plain {plain_ms:.2f} ms)")
        b_d = bound(5 * nbytes(gm.valid) + 2 * nbytes(x_ggs),
                    200 * gm.valid.sum().item() * GGS_FLOP_PER_MATCH)
        timings[f"GGS phase bound, 200 iterations, 20 frames, {d}/pair ({b_d[1]})"] = b_d[0]
        # the timed phase ran all 200 iterations: no sticky stop at its end
        _, count, _ = loss_and_grad_core(
            call(), tab_c.kp1x, tab_c.kp1y, tab_c.kp2x, tab_c.kp2y, tab_c.valid,
            tab_c.B1, tab_c.B2, hw, True, True, True, 10.0)
        report.require(f"the timed GGS phase ({d}/pair) never stopped",
                       count.item() / n_frames >= GGS_PHASE["min_matches"],
                       f"({count.item():.0f} matches at its end)")
    # the route between the kernels (diffusion/ggs.py RESIDENT_MAX_ELEMENTS):
    # both at 100/pair (128 padded) over GGS_ROUTE_FRAMES frames
    for n_r in GGS_ROUTE_FRAMES:
        x_r, gm_r = ggs_scene(torch, n_r, 100, SEED + n_r, dev)
        P_r, Q_r = gm_r.valid.shape
        ch_r = default_chunk_pairs(gm_r)
        t1_r = ggs_tables(gm_r)
        tc_r = ggs_tables(G.pad_grouped_pairs(gm_r, ch_r))
        one = _time_ms(torch, lambda: K.ggs_phase(x_r, t1_r, hw, True, True, True, 10.0,
                                                   **kw), reps=5)
        clu = _time_ms(torch, lambda: K.ggs_phase_chunked(x_r, tc_r, hw, True, True, True,
                                                           10.0, chunk=ch_r, **kw), reps=5)
        timings[f"GGS route, {n_r} frames x {Q_r} ({P_r * Q_r} entries): ggs_phase"] = one
        if n_r == SUBSET_FRAMES:  # the one-block kernel's case on the GGS path
            ggs_ms[("ggs_phase", "route")] = (one, _time_ms(
                torch, lambda: K.ggs_phase_plain(x_r, t1_r, hw, True, True, True, 10.0, **kw),
                reps=3, warmup=1))
            ggs_route_bound = bound(5 * nbytes(gm_r.valid) + 2 * nbytes(x_r),
                                    200 * gm_r.valid.sum().item() * GGS_FLOP_PER_MATCH)
        timings[f"GGS route, {n_r} frames x {Q_r} ({P_r * Q_r} entries): ggs_phase_chunked "
                f"(cluster {K.ggs_phase_chunked.cluster})"] = clu
        print(f"  GGS route {n_r} frames x {Q_r} ({P_r * Q_r} entries), 200 iterations: "
              f"ggs_phase {one:.4f} ms, ggs_phase_chunked {clu:.4f} ms (cluster "
              f"{K.ggs_phase_chunked.cluster}); diffusion/ggs.py routes it to "
              f"{'ggs_phase' if G.fused_fits(gm_r) else 'ggs_phase_chunked'}")

    # match extraction, stage by stage, at the match path's shapes (20 frames,
    # 1,024 keypoints, 190 pairs)
    sp_net, sg_net = X.load_matcher_weights(wdir, dev)
    paths = sorted(os.path.join(apple, f) for f in os.listdir(apple) if f.endswith(".jpg"))
    grays, sizes = X.load_grays(paths)
    pairs = [(a, b) for a in range(n_frames) for b in range(a + 1, n_frames)]
    with torch.no_grad():
        timings["SuperPoint (20 frames, 1896x1072, top 1,024)"] = _time_ms(
            torch, lambda: X.detect_frames(sp_net, grays, MATCH_KEYPOINTS), reps=3, warmup=1)
        feats = X.detect_frames(sp_net, grays, MATCH_KEYPOINTS)
        kp_all, sc_all, de_all, va_all = X.stack_feats(feats)
        x_all = encode_keypoints(sg_net, de_all, kp_all, sc_all,
                                 f32(np.asarray(sizes, np.float32)))
        st_all = SGK.stack_superglue_params(sg_net)
        a_idx = torch.as_tensor([p[0] for p in pairs], device=dev)
        b_idx = torch.as_tensor([p[1] for p in pairs], device=dev)

        def matcher(fn):
            for i0 in range(0, len(pairs), SG_PAIRS):
                sa, sb = a_idx[i0:i0 + SG_PAIRS], b_idx[i0:i0 + SG_PAIRS]
                fn(torch.stack([x_all[sa], x_all[sb]], 1), va_all[sa], va_all[sb], st_all,
                   match_threshold=0.0)

        print(f"  matcher input: {len(pairs)} pairs, K_eff {x_all.shape[1]}, "
              f"{int(va_all.sum())} valid keypoints in {n_frames} frames")
        timings[f"matcher (fused_match_pairs, {len(pairs)} pairs, K {x_all.shape[1]})"] = \
            _time_ms(torch, lambda: matcher(SGK.fused_match_pairs), reps=3, warmup=1)
        timings["matcher plain (fused_match_pairs_plain)"] = _time_ms(
            torch, lambda: matcher(SGK.fused_match_pairs_plain), reps=3, warmup=1)
        kpts_np, all_m = X.match_all_pairs(sg_net, feats, sizes, pairs, 50, 0.0)
        ransac = []
        for _ in range(3):
            t0 = time.perf_counter()
            X.verify_pairs(kpts_np, all_m, pairs, n_frames, RANSAC_ACCEPT_ALL, 8)
            ransac.append((time.perf_counter() - t0) * 1e3)
        timings[f"RANSAC (host clock, {len(pairs)} pairs, "
                f"{int((all_m >= 0).sum())} matches, accept-all threshold)"] = \
            statistics.median(ransac)
        _, info = load_and_preprocess_images(apple, IMAGE_SIZE)

        def ggs_with_extraction():
            kp1, kp2, i12 = X.extract_match(
                image_paths=info["paths"], image_info=info, weights=(sp_net, sg_net),
                max_keypoints=MATCH_KEYPOINTS, match_threshold=0.0,
                ransac_threshold_px=RANSAC_ACCEPT_ALL, device=dev)
            cond = G.build_cond_fn(kp1, kp2, i12, n_frames, hw, G.GGSConfig(), dev)
            return model.sample(imgs, x0=x0, noises=noises, cond_fn=cond, cond_start_step=10)

        sub_grays = X.load_grays(paths[:SUBSET_FRAMES])[0]
        k_sub = X.stack_feats(X.detect_frames(sp_net, sub_grays))[0].shape[1]
        report.require(f"{SUBSET_FRAMES} frames at the default 4,096 keypoints match at K 4,096",
                       k_sub == 4096, f"(K_eff {k_sub})")
        timings["GGS inference with extraction (images -> matches -> cameras)"] = _time_ms(
            torch, ggs_with_extraction, reps=3, warmup=1)

        # the SuperGlue kernels at one chunk's shapes, beside their plain versions
        sg_calls = {
            "superglue_coupling": (K.superglue_coupling, K.superglue_coupling_plain,
                                   (m_sg, sg_f0, sg_f1, sg_st["bin"])),
            "superglue_sinkhorn": (K.superglue_sinkhorn, K.superglue_sinkhorn_plain,
                                   (*cp_p, 50)),
            "superglue_matches": (K.superglue_matches, K.superglue_matches_plain,
                                  (Zp, sg_f0, sg_f1, 0.0)),
        }
        sg_ms = {}
        for name, (kern, plain, args) in sg_calls.items():
            sg_ms[name] = (_time_ms(torch, lambda: kern(*args), reps=5),
                           _time_ms(torch, lambda: plain(*args), reps=5))
            timings[f"{name} ({sg_tag})"] = sg_ms[name][0]
            timings[f"{name} plain ({sg_tag})"] = sg_ms[name][1]
        for key in ("attention_sg", "linear_sg", "linear_sg_qkv"):
            name, kern, plain, args, kwargs, _ = cases[key]
            timings[name] = _time_ms(torch, lambda: kern(*args, **kwargs), reps=5)
            timings[f"{name} plain"] = _time_ms(torch, lambda: plain(*args, **kwargs), reps=5)
        h_q, w_q, b_q = cases["linear_sg_qkv"][3]
        timings["linear superglue qkv torch.addmm"] = _time_ms(
            torch, lambda: torch.addmm(b_q, h_q, w_q), reps=5)
    for name, ms in timings.items():
        print(f"  {name}: {ms:.3f} ms")

    # bounds (bytes each input read once and each output written once, and the
    # algorithm's operations) and a one-call library yardstick where one exists
    def case_bound(key, args, kwargs):
        if key == "layernorm":
            x = args[0]
            return bound(2 * nbytes(x) + 2 * x.shape[1] * 4, 8 * x.numel())
        if key == "linear":
            return linear_bound(*args[:3], kwargs.get("residual"), kwargs.get("gain"),
                                kwargs.get("round_a", False), kwargs.get("trans_w", False))
        if key == "attention":
            return attention_bound(args[0], kwargs.get("attn_bias"), kwargs.get("key_bias"),
                                   kwargs.get("round_in", False))
        return sampler_bound(key, args)  # the sampler's three entries

    def case_library(key, args, kwargs):
        if key == "layernorm":
            x, g, b, eps = args[:4]
            return lambda: F.layer_norm(x, (x.shape[1],), g, b, eps)
        if key == "attention":
            qkv, H = args[:2]
            Bq, Nq, D3 = qkv.shape
            q, k, v = qkv.view(Bq, Nq, 3, H, D3 // 3 // H).permute(2, 0, 3, 1, 4)
            return lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=kwargs.get("attn_bias"))
        return None  # a fused epilogue or a sampler fold-in: no one-call equivalent

    import torch.nn.functional as F

    kernels_json = []
    with torch.no_grad():
        for key in TRUNK_KERNELS:
            name, kernel, plain, args, kwargs, err = cases[key]
            args_k = [a.clone() if torch.is_tensor(a) else a for a in args]
            ms = _time_ms(torch, lambda: kernel(*args_k, **kwargs), inner=10)
            plain_ms = _time_ms(torch, lambda: plain(*args_k, **kwargs), inner=10)
            lib = case_library(key, args_k, kwargs)
            library_ms = None if lib is None else _time_ms(torch, lib, inner=10)
            bound_ms, bound_by = case_bound(key, args_k, kwargs)
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{library_ms}, bound {bound_ms:.4f} ms ({bound_by})")
            kernels_json.append({
                "name": key, "route": "cuda", "source": SOURCES[key],
                "replaces": TPU_KERNELS[key], "launches": launches[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "case": name,
            })
            if key in SAMPLER_ENTRIES:  # and its device time, from a child process
                e = kernels_json[-1]
                e["device_ms"] = child_ms[key]
                e["launches_per_inference"] = launches[key] // DEMO_INFERENCES
                print(f"  {name}: device {e['device_ms']:.4f} ms a launch (child process), "
                      f"{e['launches_per_inference']} launches an inference")
            if key in ("layernorm", "linear"):  # and without the host's launch cost
                kname = {"layernorm": "layernorm_kernel", "linear": "linear_bf16"}
                e = kernels_json[-1]
                e["device_ms"] = _kernel_device_ms(
                    torch, lambda: kernel(*args_k, **kwargs), kname[key])
                e["graph_ms"] = _graph_ms(torch, lambda: kernel(*args_k, **kwargs))
                if lib is not None:
                    e["library_device_ms"] = _kernel_device_ms(torch, lib, None)
                    e["library_graph_ms"] = _graph_ms(torch, lib)
                print(f"  {name}: CUDA graph {e['graph_ms']:.4f} ms (library "
                      f"{e.get('library_graph_ms')}), profiler {e['device_ms']:.4f} ms, library "
                      f"{e.get('library_device_ms')}")
        rows_json, ln_rows20 = rows_entries(torch, F, cases, rows_by_shape)
        kernels_json[TRUNK_KERNELS.index("layernorm")]["rows20"] = ln_rows20
        kernels_json += rows_json
        qkv_json, bf16_shapes = bf16_linear_entries(report, torch, K, cases, main_linear_shapes)
        kernels_json.append(qkv_json)
        timings["bf16 tile at the serving shapes (CUDA graph ms)"] = bf16_shapes
    Ks1 = Kp + 1
    # the coupling's scores as 3xTF32 products over the live cells only
    sg_live = int(((sg_f0 > 0.5).sum(1) * (sg_f1 > 0.5).sum(1)).sum())
    sg_bounds = {
        "superglue_coupling": bound(nbytes(m_sg, sg_f0, sg_f1) + Cp * Ks1 * (Ks1 + 2) * 4,
                                    3 * 2 * sg_live * Dp, PEAK_TF32),
        "superglue_sinkhorn": bound(nbytes(*cp_p) + Cp * Ks1 * Ks1 * 4, 50 * 2 * 3 * Cp * Ks1**2),
        "superglue_matches": bound(nbytes(Zp, sg_f0, sg_f1) + 2 * Cp * Kp * 4, 2 * Cp * Kp**2),
    }
    for key in SUPERGLUE_KERNELS:
        bound_ms, bound_by = sg_bounds[key]
        kernels_json.append({
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": TPU_KERNELS[key], "launches": match_launches[key],
            "max_abs_err": sg_err[key], "ms": sg_ms[key][0], "plain_ms": sg_ms[key][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "case": f"one matcher chunk, {sg_tag} (launches: match path)",
        })
    kernels_json += superglue_kernel_entries(torch, K, m_sg, sg_f0, sg_f1, sg_st["bin"], cp_p,
                                             Zp, match_launches, sg_err, sg_tag)
    # the match path's f32 products on the tensor-core tile: SuperGlue's w1 +
    # ReLU and its qkv, beside one torch.addmm (launches: the match path, at
    # every row count of that (K, N))
    with torch.no_grad():
        for key, library in (("linear_sg", None),
                             ("linear_sg_qkv", "linear superglue qkv torch.addmm")):
            name, kern, plain, args, kwargs, err = cases[key]
            a, w = args[:2]
            call = lambda: kern(*args, **kwargs)  # noqa: E731
            b_ms, b_by = linear_bound(*args[:3])
            e = {
                "name": "linear f32 superglue " + ("w1" if key == "linear_sg" else "qkv"),
                "route": "cuda", "source": SOURCES["linear"], "replaces": TPU_KERNELS["linear"],
                "launches": sum(v for (_, k_, n_, t_), v in match_linear_shapes.items()
                                if (k_, n_, t_) == (a.shape[1], w.shape[1], False)),
                "max_abs_err": err, "ms": timings[name], "plain_ms": timings[f"{name} plain"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timings[library] if library else None,
                **_linear_f32_device(torch, K, call),
                "case": f"{name} (launches: match path, this K and N)",
            }
            if library:
                e["library_device_ms"] = _kernel_device_ms(
                    torch, lambda: torch.addmm(args[2], a, w), None)
            print(f"  {e['name']}: {e}")
            kernels_json.append(e)
    d = MATCH_DENSITIES[0]
    gm = grouped[d]
    ggs_bound = bound(5 * nbytes(gm.valid) + 2 * nbytes(x_ggs),
                      200 * gm.valid.sum().item() * GGS_FLOP_PER_MATCH)
    # each kernel at the case the GGS path routes to it: the one-block kernel
    # at SUBSET_FRAMES frames, the cluster kernel at 20
    for key, case, b_ms, where in (
            ("ggs_phase", ("ggs_phase", "route"), ggs_route_bound,
             f"{SUBSET_FRAMES} frames, 100/pair"),
            ("ggs_phase_chunked", ("ggs_phase_chunked", d), ggs_bound, f"20 frames, {d}/pair")):
        ms, plain_ms = ggs_ms[case]
        kernels_json.append({
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": TPU_KERNELS[key], "launches": ggs_launches[key],
            "max_abs_err": max(ggs_cases[(key, dd)] for dd in (*MATCH_DENSITIES, "grid")),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms[0],
            "bound_by": b_ms[1], "library_ms": None,
            "case": f"200-iteration phase, {where} (launches: GGS path, {DEMO_INFERENCES} "
                    f"inferences a run)",
        })
    kernels_json += train_json + bb_json + resnet_json + learn_json + vitg_json
    kernels_json.append(sum_partials_entry(report, torch, K, dev, dino_step, dino_bf16_step))
    with torch.no_grad():
        kernels_json += layernorm_entries(report, torch, F, K, dev, gen)
    attention_cases = attention_slice(report, dev, smi)
    timings.update(train_timings)
    timings.update(bb_timings)
    timings.update(ddim_timings)
    timings.update(eval_timings)
    timings.update(resnet_timings)
    timings.update(resnet_train_timings)
    timings.update(t336_timings)
    timings.update(v2bf_timings)
    timings.update(learn_timings)
    timings.update(vitg_timings)

    # the ten TPU kernels' rows (PERF.md section 6): each row's case, its
    # kernel route and plain route, its bound and a one-call yardstick
    jk = {e["name"]: e for e in kernels_json}
    L_v, D_v, F_v = 12, 384, 1536
    w_vit = L_v * (4 * D_v * D_v + 2 * D_v * F_v)
    P1, A1 = block_flops(B * N, N, D_v, F_v)
    row1 = bound(2 * nbytes(tokens) + 2 * w_vit, 0)[0], L_v * (P1 + A1) / PEAK_BF16 * 1e3
    L_d, D_d, F_d = 8, 512, 1024
    w_den = L_d * (4 * D_d * D_d + 2 * D_d * F_d)
    Pd, Ad = block_flops(n_frames, n_frames, D_d, F_d)
    step_ops = L_d * (Pd + Ad) / PEAK_F32 * 1e3
    T_steps = model.config.timesteps
    sg_name, _, _, sg_args, sg_kwargs, _ = cases["attention_sg"]
    qsg = sg_args[0]
    Bs, Ns, D3s = qsg.shape
    ksg = sg_kwargs["key_bias"]
    qs, ks, vs = qsg.view(Bs, Ns, 3, 4, D3s // 12).permute(2, 0, 3, 1, 4)
    with torch.no_grad():
        sdpa_key_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=ksg[:, None, None, :]), reps=5)
    K_eff = x_all.shape[1]
    # per pair: the GNN's and the final products, its attention and the
    # coupling's scores on the tensor cores as 3xTF32 MMAs; Sinkhorn in float32
    tc_ops = 18 * (2 * 2 * K_eff * 256 * (768 + 256) + 2 * 2 * K_eff * 512 * 768
                   + 4 * 2 * K_eff * K_eff * 256) + 2 * 2 * K_eff * 256 * 256 \
        + 2 * K_eff * K_eff * 256
    f32_ops = 50 * 2 * 3 * (K_eff + 1) ** 2
    per_pair_ms = (3 * tc_ops / PEAK_TF32 + f32_ops / PEAK_F32) * 1e3
    vit_tok, enc_tok = VIT_IMAGES * N, ENC_ROWS * 16
    tb_vit = trunk_bounds(vit_tok, N, D_v, F_v, L_v, 4, 4 * w_vit)
    tb_enc = trunk_bounds(enc_tok, 16, D_d, F_d, L_d, 4, 4 * w_den)
    tt = timings
    rows = [
        (1, "fused_vit_trunk 20x264, bf16", tt["vit trunk (fused_vit_trunk, bf16)"],
         tt["vit trunk plain (fused_vit_trunk_plain, bf16)"], max(row1), None),
        (2, "fused_sample_loop 100 steps, 20 rows", tt["sampler (fused_sample_loop, 100 steps)"],
         tt["sampler plain (fused_sample_loop_plain)"],
         max(T_steps * step_ops, bound(2 * w_den, 0)[0]), None),
        (3, "fused_trunk one pass, 20 rows, bf16", tt["fused_trunk (8 layers, 20 rows, bf16)"],
         tt["fused_trunk plain"], max(step_ops, bound(2 * w_den, 0)[0]), None),
        (4, sg_name, tt[sg_name], tt[f"{sg_name} plain"],
         attention_bound(qsg, key_bias=ksg)[0],
         sdpa_key_ms),
        (5, jk["attention"]["case"], jk["attention"]["ms"], jk["attention"]["plain_ms"],
         jk["attention"]["bound_ms"], jk["attention"]["library_ms"]),
        (6, jk["ggs_phase"]["case"], jk["ggs_phase"]["ms"], jk["ggs_phase"]["plain_ms"],
         jk["ggs_phase"]["bound_ms"], None),
        (7, jk["ggs_phase_chunked"]["case"], jk["ggs_phase_chunked"]["ms"],
         jk["ggs_phase_chunked"]["plain_ms"], jk["ggs_phase_chunked"]["bound_ms"], None),
        (8, f"fused_match_pairs {len(pairs)} pairs, K {K_eff}",
         tt[f"matcher (fused_match_pairs, {len(pairs)} pairs, K {K_eff})"],
         tt["matcher plain (fused_match_pairs_plain)"], len(pairs) * per_pair_ms, None),
        (9, f"_fwd_call vit {VIT_IMAGES}x{N}, f32", tt["vit trunk fwd"], tt["vit trunk fwd plain"],
         tb_vit[0], None),
        (9, f"_fwd_call encoder {ENC_ROWS}x16, dropout 0.1", tt["encoder trunk fwd"],
         tt["encoder trunk fwd plain"], tb_enc[0], None),
        (10, f"_bwd_call vit {VIT_IMAGES}x{N}, f32 (fwd+bwd less fwd)",
         tt["vit trunk fwd+bwd"] - tt["vit trunk fwd"],
         tt["vit trunk fwd+bwd plain"] - tt["vit trunk fwd plain"], tb_vit[1], None),
        (10, f"_bwd_call encoder {ENC_ROWS}x16 (fwd+bwd less fwd)",
         tt["encoder trunk fwd+bwd"] - tt["encoder trunk fwd"],
         tt["encoder trunk fwd+bwd plain"] - tt["encoder trunk fwd plain"], tb_enc[1], None),
    ]
    rows = sorted(rows + bb_rows, key=lambda r: r[0])
    # rows 9 and 10 by train step: the kernels one step launches, per backbone
    train_steps = {"DINO": {k: v for k, v in dino_step.items() if v},
                   "DINO bf16": {k: v for k, v in dino_bf16_step.items() if v},
                   "ResNet-50": {k: v for k, v in resnet_step.items() if v},
                   **{b: {k: v for k, v in c.items() if v} for b, c in bb_steps.items()}}
    for b, c in train_steps.items():
        print(f"  launches of one {b} train step: {c}")
    for r in rows:
        print(f"  TPU kernel {r[0]}: {r[1]}: kernel {r[2]:.3f} ms, plain {r[3]:.3f} ms, "
              f"bound {r[4]:.4f} ms, library {r[5]}")
    rows_json = [dict(zip(("row", "case", "ms", "plain_ms", "bound_ms", "library_ms"), r))
                 for r in rows]

    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for what, fn in (
            ("GGS inference", lambda: model.sample(imgs, x0=x0, noises=noises, cond_fn=cond100,
                                                   cond_start_step=10)),
            ("GGS inference with extraction", ggs_with_extraction),
        ):
            with torch.no_grad():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            avg = prof.key_averages()
            # kernels and copies only: an aten op's device time repeats theirs
            dev_us = sum(e.self_device_time_total for e in avg
                         if e.device_type == DeviceType.CUDA)
            print(f"[profile] {what} under torch.profiler: wall {wall:.2f} ms, device "
                  f"{dev_us / 1e3:.2f} ms, idle {100 * (1 - dev_us / 1e3 / wall):.1f}%")
            print(avg.table(sort_by="self_device_time_total", row_limit=15))

    print(f"[done] {time.perf_counter() - t_start:.0f} s after the start")
    if report.failures:
        print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
        return 1
    if parent_calls is not None:
        print(json.dumps({"parent_calls": parent_calls, "card": smi}))
    print(json.dumps({"rows": rows_json}))
    print(json.dumps({"attention_cases": attention_cases}))
    print(json.dumps({"timings_ms": timings, "card": smi,
                      "launches_per_sampler_step": per_step,
                      "ggs_launches_per_inference": ggs_per_inference,
                      "launches_per_train_step": train_steps,
                      "ddim_launches": ddim_launches, "pred_x0_step_launches": x0_step,
                      "eval_launches": eval_launches, "resnet_launches": resnet_launches,
                      "dp_launches": dp_launches, "fsdp_launches": fsdp_launches,
                      "train336_launches": t336_launches,
                      "dinov2_bf16_launches": v2bf_launches,
                      "learn_launches": learn_launches, "vitg_launches": vitg_launches}))
    print(json.dumps({"kernels": kernels_json}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--ptxas" in sys.argv:
        sys.path.insert(0, REPO)
        sys.exit(ptxas_report())
    if "--timed-calls" in sys.argv:
        sys.exit(timed_calls(sys.argv[sys.argv.index("--timed-calls") + 1]))
    if "--device-times" in sys.argv:
        sys.exit(device_times())
    if "--sg-split" in sys.argv:
        i = sys.argv.index("--sg-split")
        sys.exit(sg_split(*map(int, sys.argv[i + 1:i + 4])))
    sys.exit(main(sys.argv[1:]))
