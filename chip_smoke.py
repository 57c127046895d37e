#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hivae_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR] [--parent DIR]

Phases (any failure exits non-zero without the final result line):

1. build the hand-written CUDA kernels from ``hivae_tpu_torch/csrc`` (one
   ``nvcc`` per library, all at once: each source, and each attention
   source again with ``-DHV_F16`` for its fp16 forms) into
   ``hivae_tpu_torch/build/``;
2. hold each kernel against its plain PyTorch version: the forward
   kernels (bf16) at the shapes the clip-reconstruction path gives them,
   plus check-only cases (a masked camera case with a fully masked key row,
   which must give the uniform average, not NaN; the largest full-block
   shape, (4, 16, 1024, 64); q of 300 rows against 700 keys, masked and
   not), each full-block forward and backward launched twice and held to
   the same bits; the delta pre-pass of the backward against its plain
   version; the fused qk-norm forward at the same shapes
   and its autograd gradients at the camera-joint shape; the streaming
   forward at the serving shape and check-only cases (a fully masked key
   row, D 64 and 256); the int8 fused FFN-up + GELU + requantise kernel at
   the three FFN row counts of the int8 clip and check-only cases (M 1, 70
   and a ragged 200, N 8192 past one portable cluster, and M 68, the A2M
   head's rows, which must give its plain version's bits), with its
   epilogue's floor counted from its SASS; the backward kernels at every
   training shape for
   N = 4 and N = 1 clips, plus masked cases; the streaming backward (its
   delta pre-pass, dQ and dK/dV kernels) at run B's shape and at
   ``STREAM_BWD_CHECKS`` (D 64 and 128 at 2048 tokens, masked cases with a
   fully masked key block that must get no gradient), each launched twice
   and held to the same bits. The dual-encoder AMD family adds full-block
   forward and backward check cases at its shapes: S 268 (the encoders),
   282 (the DiT's joint block), 416 (the dual DiT's temporal motion
   block), 538 (AMD_S_RecSplit), AMD_L's 16-head encoders and its D 96
   DiT (masked too), and the training shapes at N = 4; and an FFN-up case
   at M 4512 (the int8 AMD_S clip). The other A2M heads add the grid
   head's joint block, S 528 at N = 1 and 4, forward and backward, and an
   FFN-up case at M 84 (the LearnableToken head's joint block). The other
   models add the T2M head's joint block at D 128 (S 269, 281 and 298,
   N = 1, which serves and trains) and the MAE's decoder at D 32 (S 257,
   N = 32 and 4) and MAE_L's encoder at mask 0 (D 64), forward and
   backward, and the CNN motion AE's ``MapConv`` attention at D 640
   ((16, 1, 1024, 640), masked too) on the streaming forward, delta, dQ
   and dK/dV kernels. The long tail adds the streaming forward's fp32
   variant at the fp32 SD-VAE's (16, 1, 1024, 512) and check cases (17
   frames, masked and not, a fully masked key row, D 64 to 640 at ragged
   lengths), held to its fp32 plain version within ``KERNEL_F32_ATOL``
   and timed beside SDPA in fp32, its bound its three TF32 products at
   TF32's peak. The fp32 siblings with a gradient (``check_f32_kernels``)
   add the fp32 full-block forward and its qk-norm variant, the fp32
   full-block backward and its delta pre-pass at ``FULL_BLOCK_F32_CASES``
   (the `--mp no` step's three sites at N = 2, a masked case with a fully
   masked key row, Sq != Sk, D 32, 96 and 128), and the fp32 streaming
   delta, dQ and dK/dV at (16, 1, 1024, 512) and ``STREAM_BWD_CHECKS``
   (with its fully masked key block, which must get no gradient), each
   within ``KERNEL_F32_ATOL`` x max(1, max|plain|) of its fp32 plain
   version, launched twice to the same bits, and timed beside SDPA in fp32
   and its plain version; with ``--parent`` the fp32 streaming forward,
   the full-block delta pre-pass and the streaming delta, dQ and dK/dV
   must give the parent's bits, and the parent's fp32 full-block forward,
   qk-norm forward and backward are timed beside these. The fp16 forms
   (``check_f16_kernels``) add the full-block forward and its
   qk-norm variant at the clip's sites, the full-block backward and delta
   at the fp16 step's, the streaming forward at the SD-VAE mid-block and
   its delta, dQ and dK/dV at the perceptual leg's decode, all on fp16
   operands, each within ``KERNEL_ATOL`` (``BWD_RTOL`` relative for
   gradients) of its plain version, twice to the same bits, timed beside
   SDPA in fp16. Each
   kernel, its plain
   version and one PyTorch call that computes the same function (a
   yardstick only: the port never calls it; for a backward, the time of
   ``F.scaled_dot_product_attention`` forward plus backward minus its
   forward; for the qk-norm kernel two ``F.layer_norm`` and one SDPA; for the
   FFN kernel ``torch._int_mm`` of its GEMM alone) are timed with CUDA
   events;
   2b. ``sdpa`` in fp32 and fp16 above 256^2 logits: each launches its
   dtype's kernels of its shape's route once (the SD-VAE mid-block's the
   streaming forward, the object encoder's the full-block forward) and,
   with a gradient, the backward's delta pre-pass and kernels once each,
   its gradients within ``_grad_gate`` of the plain path's, ``sdpa_plain``
   0; bf16 operands in a layout the kernels cannot read, which the
   kernel's wrapper copies; an fp32 ``AutoencoderKL`` encoding one clip
   (one fp32 streaming launch, ``sdpa_plain`` 0); ``quant_dense`` and
   ``fused_quant_ffn`` at 1, 16 and 17 rows against the same calls on
   the CPU;
   2c. ``sdpa`` at head dims off the kernels' tiles (8, 24, 40,
   72, 80, 136, 200, 320, 600) and on them (32 to 640), in bf16, fp16 and
   fp32, forward and with a gradient, at (2, 4, 300, D) masked and not and
   (2, 1, 2048, D): each call's route (full-block to D 128, streaming
   beyond), exact launches on its dtype's counters, ``sdpa_plain`` 0, the
   same bits twice, within ``KERNEL_ATOL`` (bf16, fp16) or
   ``KERNEL_F32_ATOL`` x max(1, max|plain|) (fp32) of the plain path and
   its gradients within ``_grad_gate``; the fused qk-norm route at D 40
   and 72; one call at D 2056, past every tile, counted once in
   ``sdpa_plain``;
   2d. the wide streaming kernels (head dims past 640, a cluster of CTAs
   along D): ``sdpa`` at D 648, 776, 1024, 1288, 1536 and 2048 in bf16,
   fp16 and fp32, forward and with a gradient, at (2, 2, 300, D) masked
   and not and (2, 1, 1024, D), with phase 2c's gates on the wide
   counters; the gradient of a row with no key where the JAX rule runs its
   full-block kernel ((2, 2, 272, 136), (2, 2, 300, 512) and (2, 2, 300,
   1024): the full-block plain version's autograd) and where it streams
   ((1, 1, 2048, 136): the plain streaming backward); a port
   ``AttentionBlock2D`` at 1024 channels over a 32 x 32 map in bf16,
   forward and backward, against its plain-attention run; the wide
   forward and dQ + dK/dV + delta timed at (4, 1, 1024, 1024) and (4, 1,
   1024, 2048) in each dtype beside their bounds, plain versions and SDPA
   (its backend named). On every main path below, ``sdpa_plain`` must
   count 0;
3. build the full-width flagship AMD_N (``configs/amd/amd_n_t1d512_spatial.json``)
   and the SD-VAE in bf16 on seeded random weights and reconstruct one
   synthetic 17 x 3 x 256 x 256 clip at ``sample_step=10`` through
   ``AMDReconstructionPipeline.sample_pixels``: one warm-up, then a timed run with
   the kernels' launch counters set to 0 just before and read just after
   (248 full-block and 3 streaming launches per clip). The decoded clip
   must be finite before quantisation, uint8 of the expected shape, and
   agree with the same clip run with the plain attention versions in
   place of the kernels;
   3c. the same clip with ``ops.attention.QKNORM_FUSE = True``: 248 launches
   of the fused qk-norm kernel, none of the plain full-block one, 3
   streaming; it must agree with phase 3's clip; then both clips timed in
   turns, 4 of each;
   3w. the same clip on AMD_N and the SD-VAE built at full width
   and depth in fp16 from phase 3's seed: 248 full-block and 3 streaming
   launches of the fp16 forms, ``sdpa_plain`` 0, finite before
   quantisation, against its run on the plain attention versions (phase
   3's gates), with its latency and peak device memory;
   3d-3h. the serving paths on the same models, each one warm-up run
   and one timed run with exact launch counts (``sdpa_plain`` 0), uint8 of
   the expected shape, finite before quantisation, and in agreement with
   the same run on the plain attention versions (phase 3's tolerances):
   3d. the clip with the Heun solver (two DiT calls a step);
   3e. the clip with camera and object mask ratios 0.5 (the camera joint
   block at 128 + 256 tokens; the object encoder at 4 + 128 tokens, below
   the kernels' 256^2 logits);
   3f. the windowed long-video reconstruction of a 38-frame clip (two
   windows and a ragged tail of 5), then of 257 frames (``max_frames``
   256, 16 windows) in its own timed run, with its peak device memory
   (finite output and counts only);
   3g. the cross-video clip (camera motion of one clip, appearance of
   another; only the camera stream in the DiT);
   3h. the GT-motion ablation over 2 windows;
   3i. the checkpoint round trip: the flagship's weights written as a
   reference-named ``.safetensors`` (a writer of this script's own),
   loaded by ``load_pretrain_partial`` and by the CLI's ``load_amd`` with
   the flagship config, both equal to the live weights; where OpenCV
   imports, ``python -m hivae_tpu_torch.cli.amd_inference`` end to end on
   an mp4 written here (its frame count, shape and launches);
   3m. audio to video (after 3i, on the same AMD_N and SD-VAE): the
   flagship A2M head (``configs/a2m/cross_audio_t1d512_l16_dim1024.yaml``
   with ``motion_num_token`` set to AMD_N's 4 object tokens, 361.2 M,
   bf16, seeded random weights) and ``ImageAudio2VideoPipeline`` on a
   seeded reference frame and a synthetic (41, 50, 384) whisper embedding
   (two windows of 16 and a ragged tail of 8) at the CLI's 8 motion and 20
   video steps: one warm-up and one timed run with exact launches (752
   full-block: the object encoder on the 8 padded reference frames, then
   a window each on its reference frame and 12 DiT joint blocks x 20
   steps; 2 streaming; the A2M attentions stay plain and uncounted,
   ``sdpa_plain`` 0), the windows' times (CUDA events) and the peak
   device memory, against its run on the plain attention versions (phase
   3's tolerances); one run with ``need_motion_extract_model`` (8 more
   encoder launches a window after the first; window 0 bit-equal, later
   windows moved); ``cli.get_whisper_emb`` on a synthetic mp4 and its
   wav, then ``cli.a2v_inference`` end to end on reference-named
   ``.safetensors`` of both models written here, with ``--audio_wav``:
   the container read back (frames and size by OpenCV, an audio stream
   in it) and exact launches at 2 steps; the shipped yaml as it is (1
   token a frame) must end in the port's token-count ``ValueError``. After
   3b, on the models built again from their seeds at full width and
   ``INT8_A2V_DEPTH`` (AMD_N at ``EXPORT_DEPTH``, the head at
   ``A2M_CLI_LAYERS``): the int8 A2V clip with all three tables (DiT, VAE
   decoder, A2M; fused FFN-up launches from the layers: the head's two
   FFNs a layer and motion step, the DiT's two a layer and video step),
   against its run with the plain FFN-up version and, as 3b, its run on
   all plain versions;
   3n. (after 3m, on AMD_N at ``EXPORT_DEPTH`` and the SD-VAE) the A2V
   clip of 3m with the ``A2MModel_LearnableToken`` and
   ``A2MModel_SimpleAdaLN`` heads (the flagship yaml with ``model_type``
   swapped, at ``A2M_CLI_LAYERS`` layers): exact launches (from the
   depth, 2 streaming: their own attentions, 84 tokens, stay plain),
   against their runs on the plain attention versions (3m's gates);
   after 3m's int8 leg, LearnableToken's int8 A2V clip on the models
   built again at ``INT8_A2V_DEPTH`` (one FFN a layer from the head),
   gated as 3m's;
   3o. the grid head (``A2MModelMlp`` at the ``A2MConfig`` defaults,
   194.7 M, seeded): ``sample_grid`` in bf16 at N = 1 and 10 steps (80
   full-block launches over 528 tokens, within ``GRID_REL_L2`` of its
   plain-attention run), then its loss at N = 4, fp32 weights under bf16
   autocast, forward and backward (8 forward, 8 delta and 8 backward
   launches; loss and gradient against the plain versions as run A);
   3p. ``cli.vis`` on the shipped PosePre yaml as json (542.5 M, fp32 as
   the JAX CLI) over 4 synthetic pose mp4s and embeddings of 17 frames:
   the grid video's shape and dtype, finite decoded pixels, exactly 2
   fp32 streaming launches (the fp32 VAE's encode and decode mid-block
   attentions), no other launch and ``sdpa_plain`` 0;
   3s. ``cli.frequency_filter_decode`` (fp32 VAE) on a synthetic mp4,
   ``fft`` and ``wavelet``: 3 and 5 fp32 streaming launches, nothing
   else, each band within ``FREQ_MAX_LEVELS`` of its plain-attention run;
   3t. ``cli.evaluate`` at full width (AMD_N and the SD-VAE in bf16) on
   2 synthetic mp4s at 20 steps with seeded LPIPS weights: 488
   full-block and 3 streaming launches a clip, finite PSNR, SSIM and
   LPIPS within ``EVAL_*_ATOL`` of its plain-attention run;
   3u. ``rope_attention``, ``VelocityDiTSplitInput`` and ``DiT2Condition``
   in bf16 above 256^2 logits: 1, 2 and 2 full-block launches (the DiTs
   at ``LONGTAIL_LAYERS``), within
   ``LONGTAIL_REL_L2`` of their plain runs;
   3q. T2M ``sample`` (after 3n, on the same AMD_N and SD-VAE): the
   default ``T2MConfig`` (3.0 B parameters, 2048 wide, 16 heads of 128,
   20 layers) with AMD_N's 4 object tokens, bf16 on seeded weights built
   on the card, on phase 3's clip's camera target and reference latents,
   an int label and the text fallback's embedding; Euler and Heun at 10
   steps, each timed with exact launches (200 / 400 full-block at (16,
   16, 269, 128)), finite, its motion (sample - z0) within
   ``T2M_MOTION_REL_L2`` of its plain run's;
   3r. the CNN motion AE (forward and its loss's backward on 16 frames of
   32 x 32 latents: ``MapConv``'s attention at (16, 1, 1024, 640) on the
   streaming kernels, exactly one forward, delta, dQ and dK/dV launch and
   no ``sdpa_plain``) and the six discriminators at their defaults (train
   and eval: no launch), finite, expected shapes;
   3v. (after 3b, on models built anew at full width and phase 8's
   depth, ``EXPORT_DEPTH``) ``cli.export_sampler``'s
   ``ClipSampler``, bf16 then int8: exported with ``torch.export``, saved, loaded and run
   on phase 3's clip and seeded noise; its uint8 frames against the live
   module's and its launches equal to the live run's and to the clip's
   formula at ``EXPORT_STEPS``;
   3b. (run after 3c-3i and 3m, since it strips the models' float weights) the int8
   clip through ``AMDReconstructionPipeline(vae, amd, quant="int8")`` on
   the same weights: 360 fused FFN-up launches (36 FFNs x 10 Euler steps),
   248 full-block and 3 streaming; uint8, finite before quantisation, and
   in agreement with the same int8 clip run with the plain FFN-up version
   and with the plain versions of all kernels (see ``CLIP_INT8_NOISE_RATIO``
   for how each reference is held); its distance and PSNR to phase 3's
   bf16 clip and the serving models' device memory, bf16 against stripped
   int8, are printed;
3j. (run after 3b) the dual-encoder AMD family on a fresh bf16 SD-VAE (seeded random
   weights, ``AMD_S``/``AMD_L`` factories with ``use_filter`` and
   ``use_grey``): the AMD_S clip (136 full-block launches: 2 x 8 encoder
   layers and 12 DiT joint blocks x 10 steps; 3 streaming), the
   diff-motion clip (camera motion of another clip; 136 / 4, and it must
   differ from the clip), the refimg-motion path through one GT-motion
   window (136 / 2), the clip with the ``dual`` DiT (256 / 3: its temporal
   motion block over 416 tokens adds one launch a layer) and with the
   ``spatial`` DiT (136 / 3), each one warm-up and one timed run with
   exact launches and against its plain-attention run (phase 3's
   tolerances); AMD_S_RecSplit's forward on seeded latents (28 launches,
   within ``REC_REL_L2`` of its plain run);
   3k. the int8 AMD_S clip (+ 120 FFN-up launches), against its plain
   FFN-up run;
   3l. the AMD_L clip (1011.2 M; 176 / 3) with its peak device memory;
4. training run A, the flagship script's settings on one card: AMD_N with
   fp32 master weights and bf16 compute, remat ``full``, AdamW (lr 1e-4,
   decay 1e-2, clip 1.0, bf16 first moment) on N = 4 synthetic clips with
   the MSE loss; one warm-up step, then 3 timed steps with exact launch
   counts; finite loss and grad_norm, parameters that moved, and one step
   with the plain attention versions in place of the kernels from the same
   state, batch and draws (loss and gradient against the kernel step);
   4b. one run-A step (loss and gradients, no update; the flagship at
   ``PAR_DEPTH``) under no remat and under each remat policy (``full``,
   ``dots``, ``dots_sans_ffn``, ``dots_offload``) from the same state,
   batch and draws: exact launches,
   loss within ``REMAT_LOSS_RTOL`` of ``full``'s and gradient cosine at
   least ``REMAT_GRAD_COS``, with each one's time and peak memory (a policy
   that does not fit at N = 4 runs at N = 2, with ``full`` again there);
5. training run B: the flagship at ``PAR_DEPTH``, N = 1 with the
   perceptual loss (weight 0.5, seeded random LPIPS weights) and both mask
   ratios at 0.5, one warm-up step and
   2 timed steps with exact launch counts (now with the streaming backward
   kernels and their delta pre-pass), the same plain-step check, then a
   checkpoint save, a resume in a new trainer, and one more step from each
   that must agree bit for bit;
   5b. ``AMDTrainer.validate`` on N = 4 clips at ``sample_step=2``: exact
   launches, uint8 of its shape, and agreement with its run on the plain
   attention versions (phase 3's tolerances);
   5c. `--mp no` training, as ``cli.train_amd --mp no`` runs it: AMD_N
   at full width and ``PAR_DEPTH`` (fp32 weights, remat ``full``)
   computing in fp32 on an fp32 SD-VAE: run F at N = 2 (a warm-up, 2
   timed steps), one step with the perceptual loss at N = 1 (the fp32
   streaming backward: 1 delta, 1 dQ, 1 dK/dV) and one under
   ``QKNORM_FUSE`` at N = 1 (the fp32 qk-norm forward); exact launches
   on the fp32 kernels (``_expected_step_launches(..., f32=True)``), the
   bf16 counters and
   ``sdpa_plain`` 0, loss within ``F32_STEP_LOSS_RTOL``, gradient
   cosine at least ``F32_STEP_GRAD_COS`` and gradient relative L2 within
   ``F32_STEP_GRAD_REL_L2`` of the same step on the plain attention
   versions (the plain step with TF32 matmuls logged beside it as the
   control the gate must reject), step ms and peak memory;
   5d. fp16 training of AMD_N at full width and ``PAR_DEPTH``
   (fp32 master weights computing under fp16 autocast, as the JAX
   package's ``AMD_N(dtype=float16)`` computes over fp32 params) on an
   fp16 SD-VAE: one loss and gradient at N = 2 (run A's launches on the
   fp16 forms), then one with the perceptual loss under ``QKNORM_FUSE``
   at N = 1 (the fp16 qk-norm forward, the streaming delta, dQ and dK/dV);
   ``sdpa_plain`` 0, finite, loss within ``STEP_LOSS_RTOL`` and gradient
   cosine at least ``STEP_GRAD_COS`` of the same call on the plain
   attention versions, with its time and peak memory;
6. one training step (after a warm-up) of each config variant of
   ``VARIANTS``, at ``PAR_DEPTH`` and N = 4 with remat ``full``:
   ``use_camera_down`` with ``need_motion_transformer`` (the camera joint
   block at 16 + 256 tokens)
   and ``diffusion_model_type="default"`` (the TempMotion DiT, one joint
   block a layer); exact launches and the plain-step check of run A;
6b. training steps of the dual-encoder family, remat ``full``, each after
   a warm-up with exact launches and the plain-step check of run A: AMD_S
   at N = 4 (2 timed steps), AMD_S with ``use_regularizers`` (``KLloss``
   finite) and with the ``dual`` DiT (one step each), AMD_L at N = 1 (one
   step);
7. the training CLI, ``hivae_tpu_torch.cli.train_amd``, in this process on
   8 synthetic 256² mp4s written here (a textured pan under a moving
   disc): the flagship JSON at ``PAR_DEPTH`` (its widths), N = 4, bf16,
   remat, 3 steps with a
   checkpoint at step 2 (its ``config.json``, ``args.txt`` and
   checkpoints checked), then, with step 3's checkpoint removed, a resume
   that must start at step 2 and end at step 4, then ``cli.amd_inference``
   on the checkpoint it wrote and one of the mp4s. Exact launches, steps/s,
   clips/s, frames/s, peak memory, the loader's host time a batch alone and
   ``fit``'s wait on it a step (its one-batch prefetch should hide it);
   7b. the CLI with ``--use_mask true`` (flow masks on the host) at
   ``PAR_DEPTH``, 2 steps;
   7c. the CLI with ``--model_type AMD_S`` (AMD_S's config at
   ``PAR_DEPTH`` as ``--amd_config``), 2 steps, then on its checkpoint
   ``cli.amd_inference --model_type AMD_S`` and ``cli.amd_inference_single --diff_motion``
   (exact launches, the mp4s' frames);
   7d. ``hivae_tpu_torch.cli.train_a2m`` in this process: the flagship A2M
   head's widths at AMD_N's 4 tokens and ``A2M_CLI_LAYERS`` layers (fp32
   weights, bf16 autocast) on a frozen
   bf16 AMD_N (a reference-named ``.safetensors`` written here) and
   SD-VAE, a ``.pkl`` index of phase 7's mp4s with seeded embeddings and a
   pose stream, N = 4 clips of 16 frames: 3 steps (checkpoints at 2 and
   3), a resume to step 4, then ``cli.a2v_inference`` on the checkpoint
   it wrote; exact launches (a step: 16 full-block for the two
   ``extract_motion`` calls, 4 streaming for the four VAE encodes), step
   ms, clips/s and peak memory;
   7e. T2M training on a tree of two class directories of mp4s: one
   timed step of ``cli.train_t2m.T2MTrainer`` at full depth (20 layers),
   N = 1, with its peak memory (fp32 weights and AdamW moments: 48 GB;
   running out of the card's memory fails the phase), then the CLI in
   this process at ``T2M_CLI_LAYERS`` layers, 2 steps and a resume to 3;
   exact launches (8 + layers full-block forward, layers delta and
   backward, 4 streaming a step); then one `--mp no` step of
   ``T2MTrainer`` at ``T2M_CLI_LAYERS`` (the head and its frozen AMD_N and
   SD-VAE in fp32): the same launches on the fp32 kernels,
   ``sdpa_plain`` 0;
   7f. ``hivae_tpu_torch.cli.train_mae`` with MAE_L on 32 frames a step,
   2 steps and a resume to 3 (8 full-block forward, delta and backward at
   (32, 16, 257, 32) and 1 streaming a step), one `--mp no` step of
   ``MAETrainer`` (fp32 compute on an fp32 SD-VAE: the same launches on
   the fp32 kernels, ``sdpa_plain`` 0), then ``reconstruct`` with its
   checkpoint's weights (32 full-block) within ``MAE_REL_L2`` of its
   plain run;
8. parallelism. NCCL refuses two ranks on one device, so the ranks are
   processes that share this card over gloo (``spawn_ranks``: this script
   with ``--rank-phase``, a time limit each), whose collectives the port
   stages through pinned host memory; no time here is a collective's on a
   cluster, and no scaling is measured. Its models keep the flagship's
   widths at ``PAR_DEPTH`` (1 encoder layer each, 1 DiT layer), since
   these host-staged collectives take time in step with the parameters.
   8a. the ring's two hop kinds timed at 512, 1024 and 2048 local tokens
   (this card's crossover), then ``sequence_sharded_sdpa`` at
   (1, 16, 4096, 64) over rings of 2 and 4 ranks (2048 and 1024 local
   tokens: kernel hops), unmasked and with a whole local block masked:
   exact launches on each rank (P streaming forwards, one delta pre-pass,
   P dQ and P dK/dV), the ranks' outputs and gradients bit-equal, and
   held to one process's ``sdpa`` on the whole sequence and to the plain
   version; on the ring of 2 also one fp32 call with a gradient on the
   fp32 kernel hops (2 fp32 streaming forwards, 1 delta, 2 dQ, 2 dK/dV),
   the ranks bit-equal, within the fp32 gate of one process's fp32
   ``sdpa`` and of the plain version;
   8b. the flagship's training step on the mesh (2, 1, 1), 2 clips a rank,
   against one process's step on the 4 clips and the same draws (loss
   within ``STEP_LOSS_RTOL``, gradient cosine at least ``STEP_GRAD_COS``),
   exact launches, ``sdpa_plain`` 0, the ranks' parameters bit-equal
   after the update;
   8c. the same on the mesh (1, 1, 2) with ``attn_impl="ring"`` (2 clips:
   every attention of the step rings, all plain hops at the 17-frame
   window); then one sampling call at the 64-frame window of
   ``benchmarks/bench_longwindow.py`` (flagship widths, ``PAR_DEPTH``)
   with the VAE encodes and decode, under ring over 2 ranks with the
   launches its sites' local blocks give, against the same call under
   ``auto`` in one process (phase 3's tolerances);
   8d. the FSDP step on the mesh (1, 2, 1) (FSDP2's collectives on CUDA
   tensors through gloo), as 8b without the bit-equality of unsharded
   parameters, then a checkpoint save of the sharded state: its peak
   device memory above what each rank held (at most twice the largest
   whole tensor: the state is gathered one tensor at a time into rank 0's
   host memory); ``init_distributed`` on its default backend on CUDA
   (NCCL) at world size 1;
   8e. ``python -m hivae_tpu_torch.cli.train_amd --mesh 2,1,1
   --dist_backend gloo`` in 2 processes for 2 steps on phase 7's mp4s,
   then ``cli.amd_inference`` in this process on its checkpoint, and in
   2 processes with the config's ``attn_impl`` set to ``ring``: exact
   ring calls from the shapes, ``sdpa_plain`` 0, rank 0 alone writes, and
   its frames against the one-process run's (phase 3's tolerances); and
   ``cli.train_amd --mesh 1,1,2`` (the weights split over ``tensor``) for
   2 steps in phase 8g's ranks, rank 0 alone printing, launches a rank
   exact, its checkpoint served by ``cli.amd_inference`` here;
   8f. the flagship's step on the mesh (1, 1, 2) with the weights split
   over ``tensor`` (``attn_impl`` auto: each rank's kernels on 8 of the
   16 heads), bf16 (``STEP_LOSS_RTOL``, ``STEP_GRAD_COS``), then one
   ``--mp no`` step on an fp32 SD-VAE (``TP_F32_LOSS_RTOL``,
   ``TP_F32_GRAD_REL_L2``), each against one process's step on the same
   global batch and draws: exact launches a rank, ``sdpa_plain`` 0, the
   ranks' gathered parameters bit-equal; the bf16 step's checkpoint
   resumed by one process bit for bit; in the 4-rank spawn of 8a, the
   step on (1, 2, 2) (FSDP2 over (data, fsdp) on the split weights)
   against one process's on rank 0;
   8g. ``cli.train_a2m`` (phase 7d's index and head at
   ``A2M_CLI_LAYERS``), ``cli.train_t2m`` (at ``T2M_CLI_LAYERS``) and
   ``cli.train_mae`` (MAE_L) on 2 gloo ranks, 2 steps each, their
   ``main`` called in turn in one spawn (``rank_clis``), which runs while
   8d and 8e do: launches a rank exact, rank 0 alone prints, the ranks'
   parameters equal; each first step run again in this process on the
   ranks' global batch (their rows in rank order) from the same weights
   and draws: its loss within ``HEAD_LOSS_RTOL``, its grad_norm and
   gradients within ``HEAD_GRAD_RTOL`` of the ranks' averaged ones
   (sketched: ``_sketch``); each 2-rank checkpoint resumed here with the
   ranks' parameters;
9. print the card's name and power limit, one JSON line of per-kernel
   numbers, and as the last line the device record.

Float32 matmuls and convolutions run without TF32 here
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` both False), and cuDNN picks
deterministic algorithms. ``--profile DIR`` also writes a
``torch.profiler`` table of one clip to ``DIR/profile_clip.txt``, of one
int8 clip to ``DIR/profile_clip_int8.txt``, of one run-A training step
to ``DIR/profile_train.txt``, of one ``validate`` call to
``DIR/profile_validate.txt``, of one step of the ``default`` DiT to
``DIR/profile_train_default_dit.txt`` and of one CLI step (the CLI's own
``--profile_steps 1`` window, two more steps resumed from step 4) to
``DIR/profile_train_cli.txt``. ``--parent DIR`` builds the kernels of
another checkout too (the parent commit unpacked with ``git archive``) and
times its full-block forward, qk-norm forward, backward, streaming forward
(bf16 and fp32), streaming backward (dQ and dK/dV), fp32 full-block
forward, qk-norm forward and backward and int8 FFN-up in phase 2 beside
this checkout's, in the same process; its custom ops stay
out of torch's registry (``_LocalOp``), so this checkout's calls still
reach this checkout's kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import math
import re
import struct
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "amd", "amd_n_t1d512_spatial.json")
SEED = 0
WINDOW = 16
SIZE = 256
SAMPLE_STEP = 10
# the serving paths of phases 3e-3h: mask ratios of the masked clip, the
# long clips' frames (reference + 2 windows + a ragged tail of 5; then
# max_frames 256 + the reference), the GT-motion ablation's windows
MASK_RATIO = 0.5
LONG_FRAMES = 38
LONG_MAX_FRAMES = 256
GT_WINDOWS = 2

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12

KERNEL_ATOL = 2e-2   # bf16 outputs of unit scale: P rounded at other points
LSE_ATOL = 1e-3      # fp32 LSE, sums in another order
# the fp32 streaming forward against its fp32 plain version: three TF32
# products (hi/lo split) on tensor cores that truncate as they accumulate,
# against full fp32 ones (1-2e-6 on outputs and LSEs of unit scale; one
# TF32 product would be ~2e-4)
KERNEL_F32_ATOL = 1e-5
# The kernel path and the plain path round P to bf16 at different points of
# each softmax; over 10 Euler steps of a random-weight model that may move a
# decoded pixel by a few uint8 levels. Mean |diff| stays well below one.
CLIP_MEAN_ATOL = 1.0
CLIP_P99_ATOL = 8
# An int8 network carries a rounding flip on: an activation one step off on
# its grid moves the next layer's inputs, which flips more values there, and
# so on. Against its run with the plain attention versions (P rounded to
# bf16 at other points) the int8 clip therefore differs by about as much as
# int8 differs from bf16 on these random weights (measured on an H100 80GB
# HBM3 at 700 W: 4.61 levels mean against 3.61). So that run is held to a
# multiple of its own distance from phase 3's bf16 clip, a scale that does
# not depend on the clip under test; the run with only the FFN kernel's
# plain version in place, which the kernel matches bit for bit, to
# CLIP_MEAN_ATOL and CLIP_P99_ATOL.
CLIP_INT8_NOISE_RATIO = 2.0
# bf16 and qk-norm clips timed in turns, this many of each
QKNORM_TURNS = 4
# The fused FFN kernel against its plain version: the kernel spells out the
# plain version's roundings and gives its bits (against PyTorch's fused
# GELU and a division by a Python number it was 2 elements of 33.5 M one
# step off); the tolerance stays at one step on 0.1% of the elements.
FFN_MAX_STEP = 1
FFN_OFF_BY_ONE_SHARE = 1e-3
FFN_SCALE_RTOL = 1e-6
FFN_DEQUANT_RTOL = 1e-3
# (name, rows M, launches per int8 clip) of the FFN-up at K 1024, N 4096:
# 12 layers x 10 Euler steps each
FFN_CASES = [("DiT object joint", 16 * 266, 12 * SAMPLE_STEP),
             ("DiT camera joint", 16 * 512, 12 * SAMPLE_STEP),
             ("DiT per-pixel temporal", 256 * 16, 12 * SAMPLE_STEP)]
FFN_K, FFN_N = 1024, 4096

# phase 3m, audio to video: the flagship A2M head (the shipped yaml with
# motion_num_token set to AMD_N's 4 object tokens) on a synthetic whisper
# embedding of 41 frames (the reference's and 40 driven: two windows of 16
# and a ragged tail), the CLI's step counts, 8 reference frames
A2M_CONFIG = os.path.join(ROOT, "configs", "a2m",
                          "cross_audio_t1d512_l16_dim1024.yaml")
A2V_FRAMES = 41
A2V_MOTION_STEPS, A2V_VIDEO_STEPS = 8, 20
A2V_REF_FRAMES = 8
A2V_FPS = 25
WAV_RATE = 16000
# the A2M FFN's rows: 4 tokens of the reference and of 16 frames
A2M_FFN_ROWS = 4 * (WINDOW + 1)
# the CLI leg's step counts (its launches exact at these)
A2V_CLI_STEPS = 2
# phases 3n-3p, the other A2M heads: LearnableToken and SimpleAdaLN (the
# flagship yaml with only model_type swapped, at AMD_N's 4 tokens) on
# phase 3m's A2V clip, LearnableToken's int8 leg too; the grid head at the
# A2MConfig defaults (16 x 64, 8 layers, 128-channel 4 x 4 grids, 32^2
# latents in 2 x 2 patches): sample_grid over GRID_FRAMES frames at
# GRID_STEPS steps and its loss at GRID_LOSS_CLIPS clips; cli.vis on the
# shipped PosePre yaml, VIS_PAIRS embeddings and pose mp4s of VIS_FRAMES
A2M_HEAD_TYPES = {"A2MModel_LearnableToken": "learnable_token",
                  "A2MModel_SimpleAdaLN": "simple_adaln"}
A2M_POSEPRE_CONFIG = os.path.join(
    ROOT, "configs", "a2m", "cross_audio_posepre_t1d512_l16_dim1024.yaml")
GRID_FRAMES, GRID_STEPS, GRID_LOSS_CLIPS = 16, 10, 4
# the grid head's joint block: 16 frames of 4 x 4 motion patches, 16 x 16
# image patches and 16 audio tokens
GRID_TOKENS = GRID_FRAMES * 16 + 256 + GRID_FRAMES
# a sampled grid against its run on the plain attention versions (bf16
# activations through 8 layers and 10 Euler steps): relative L2 distance
GRID_REL_L2 = 2e-2
VIS_PAIRS, VIS_FRAMES = 4, 17
# the LearnableToken head's FFN rows a clip: 4 tokens of 16 frames and of
# the reference, and the 16 audio tokens
A2M_JOINT_FFN_ROWS = 4 * (WINDOW + 1) + WINDOW
# phase 7d, cli.train_a2m: clips a step, steps, then one resumed step; the
# CLI's serving leg at A2V_CLI_STEPS
A2M_TRAIN_CLIPS, A2M_TRAIN_STEPS = 4, 3
# phase 7d trains the flagship A2M head's widths at a cut depth (it has 8
# layers): its fp32 checkpoints with the optimizer state were the bulk of
# the phase, cut when phase 3v's exports took the script past 800 s
A2M_CLI_LAYERS = 2
# phases 3q, 3r, 7e and 7f, the other models: the T2M head at the default
# T2MConfig widths with AMD_N's 4 object tokens a frame (its default 16 do
# not pair with AMD_N: cli.train_t2m refuses them), sampled at T2M_STEPS
# on an int label and on the text fallback's embedding; its training at
# full depth and its CLI at T2M_CLI_LAYERS on T2M_VIDEOS mp4s in two class directories; MAE_L
# trained at MAE_TRAIN_CLIPS frames a step, then reconstructing MAE_RECON
T2M_OVERRIDES = {"object_token_num": 4}
T2M_STEPS, T2M_LABEL = 10, 3
T2M_TEXT = "a person waves at the camera"
# A T2M sample against its run on the plain attention versions (bf16
# through 20 layers and 10 steps), held on the motion the solver
# integrated, sample - z0: the shared start noise z0 is most of a sample
# and would hide a fault in the velocity. Relative L2 distance (measured
# 0.0023-0.0033 on an H100 80GB HBM3 at 700 W).
T2M_MOTION_REL_L2 = 1e-2
# the text label must move that motion by this many times the largest
# kernel-vs-plain distance of the same runs (measured 6.4x)
T2M_LABEL_MOVES = 3
# MAE_L's reconstruct against its plain-attention run (bf16 through 24
# encoder and 8 decoder blocks): relative L2 distance of the latents
MAE_REL_L2 = 1e-2
T2M_CLI_LAYERS = 2
T2M_VIDEOS, T2M_VIDEO_FRAMES = 4, 24
MAE_TRAIN_CLIPS, MAE_VIDEO_FRAMES, MAE_RECON = 32, 4, 4

# (name, q shape, launches per clip at sample_step=10)
FULL_BLOCK_CASES = [
    ("object encoder", (32, 8, 260, 64), 8),
    ("DiT object joint", (16, 16, 266, 64), 12 * SAMPLE_STEP),
    ("DiT camera joint", (16, 16, 512, 64), 12 * SAMPLE_STEP),
]
STREAM_CASES = [("SD-VAE mid-block", (17, 1, 1024, 512), 3)]
# check-only streaming cases (label, q shape, masked): a fully masked key
# row (batch 0) at the serving width, and the other head dims of the body
STREAM_CHECKS = [
    ("SD-VAE mid-block, masked, a fully masked key row", (4, 1, 1024, 512),
     True),
    ("D 64", (4, 8, 1024, 64), False),
    ("D 256", (4, 2, 1024, 256), True),
    # the long path's VAE encodes and decode (phase 3f), 3 launches each
    ("SD-VAE mid-block, long clip (F 38)", (38, 1, 1024, 512), False),
    ("SD-VAE mid-block, long clip (F 257)", (257, 1, 1024, 512), False),
    # the ring's kernel hops of phase 8a: 4096 tokens over 2 and 4 ranks
    ("ring hop, P 2 (2048 local tokens)", (1, 16, 2048, 64), False),
    ("ring hop, P 4 (1024 local tokens), masked", (1, 16, 1024, 64), True),
    # the CNN motion AE's MapConv (phase 3r): 16 frames of 32 x 32 latents
    # at 640 channels, one head
    ("AE MapConv (D 640)", (16, 1, 1024, 640), False),
    ("AE MapConv, masked (D 640)", (4, 1, 1024, 640), True),
]
# the fp32 streaming forward (name, q shape, launches a path): the fp32
# SD-VAE's mid-block at 16 frames (cli.vis's decode, cli.frequency_filter
# _decode's encode and each band's decode), then check-only cases (label,
# q shape, masked): 17 frames, masked and not, a fully masked key row, and
# the other head dims at ragged lengths
STREAM_F32_CASES = [("fp32 SD-VAE mid-block", (16, 1, 1024, 512), 1)]
STREAM_F32_CHECKS = [
    ("fp32 SD-VAE mid-block, 17 frames", (17, 1, 1024, 512), False),
    ("fp32 SD-VAE mid-block, 17 frames, masked", (17, 1, 1024, 512), True),
    ("fp32 SD-VAE mid-block, 16 frames, masked", (16, 1, 1024, 512), True),
    ("fp32 D 64, Sq 1000", (2, 2, 1000, 64), True),
    ("fp32 D 128", (2, 2, 1024, 128), False),
    ("fp32 D 256, Sq 1030", (2, 1, 1030, 256), True),
    ("fp32 D 640", (2, 1, 1024, 640), True),
]
# check-only full-block cases (label, q shape, Sk or None, weight 0,
# masked): a fully masked key row; the largest shape ``full_block_fits``
# admits at D = 64, which runs the streamed copy ring; Sq != Sk
FULL_BLOCK_CHECKS = [
    ("DiT camera joint, masked", (16, 16, 512, 64), None, 0, True),
    ("largest full-block shape", (4, 16, 1024, 64), None, 0, False),
    ("Sq 300, Sk 700", (2, 4, 300, 64), 700, 0, False),
    ("Sq 300, Sk 700, masked", (2, 4, 300, 64), 700, 0, True),
    # the masked clip's camera joint block (phase 3e): 128 kept sites + 256
    # patches, 12 x 10 launches a clip there
    ("DiT camera joint, masked clip (S 384)", (16, 16, 384, 64), None, 0,
     False),
    # the camera_down variant's camera joint block (phase 6): 16 sites of
    # the 8x8 camera grid + 256 patches, at N = 4 clips
    ("DiT camera joint, camera_down step (S 272)", (64, 16, 272, 64), None,
     0, False),
] + [
    # the dual-encoder AMD family (phases 3j-3l, 6b, 7c): the pair-temporal
    # encoders (12 tokens + 256 patches over 2T frames), the default DiT's
    # joint block (2 * 12 + 2 motion tokens + 256 patches), the dual DiT's
    # temporal motion block (T * 26 tokens a clip), AMD_S_RecSplit's
    # reconstruction blocks (256 + 256 + 26), AMD_L's encoders (16 heads)
    # and DiT (16 heads of 96); serving shapes, then the training ones at
    # N = 4 (AMD_L's step runs at N = 1, its serving shapes)
    (label, shape, None, 0, masked) for label, shape, masked in (
        ("AMD_S encoders (S 268)", (32, 8, 268, 64), False),
        ("AMD_S DiT joint (S 282)", (16, 16, 282, 64), False),
        ("dual DiT motion temporal (S 416)", (1, 16, 416, 64), False),
        ("AMD_S_RecSplit (S 538)", (16, 16, 538, 64), False),
        ("AMD_L encoders (S 268)", (32, 16, 268, 64), False),
        ("AMD_L DiT joint (S 282, D 96)", (16, 16, 282, 96), False),
        ("AMD_L DiT joint, masked (D 96)", (4, 16, 282, 96), True),
        ("AMD_S encoders N=4", (128, 8, 268, 64), False),
        ("AMD_S DiT joint N=4", (64, 16, 282, 64), False),
        ("dual DiT motion temporal N=4", (4, 16, 416, 64), False),
        # the A2M grid head's joint block (phase 3o): sample_grid at N = 1
        # and its loss at N = 4
        ("A2M grid joint (S 528)", (1, 16, 528, 64), False),
        ("A2M grid joint N=4 (S 528)", (4, 16, 528, 64), False),
        # the T2M head's joint block (phases 3q, 7e; N = 1 serves and
        # trains): 16 x 128 over AMD_N's 4 + 1 + 8 motion tokens and 256
        # patches, and at the default 16 object tokens, with and without an
        # object source; the MAE decoder (16 x 32 over 1 + 256 tokens) at
        # the training N = 32 (phase 7f) and MAE_L's encoder (16 x 64) and
        # decoder at mask 0 on MAE_RECON frames
        ("T2M joint (S 269, D 128)", (16, 16, 269, 128), False),
        ("T2M joint, default tokens (S 281, D 128)", (16, 16, 281, 128),
         False),
        ("T2M joint, object source (S 298, D 128)", (16, 16, 298, 128),
         False),
        ("MAE decoder N=32 (S 257, D 32)", (32, 16, 257, 32), False),
        ("MAE_L encoder, mask 0 (S 257, D 64)", (4, 16, 257, 64), False),
        ("MAE decoder, mask 0 (S 257, D 32)", (4, 16, 257, 32), False))
]

# training: clips per step in runs A and B, timed steps, frames per clip
RUN_A_CLIPS, RUN_A_STEPS = 4, 3
RUN_B_CLIPS, RUN_B_STEPS = 1, 2
# check-only streaming backward cases (label, q shape, masked): the old
# masked serving-width case, 16 heads of 64 (the DiT width) past the
# full-block limit, D 128, and the shape of
# ``benchmarks/bench_attention.py --b 2 --h 8 --s 2048 --d 64 --grad``; a
# masked case also masks the key block STREAM_MASKED_KEYS in every row
STREAM_BWD_CHECKS = [
    ("SD-VAE mid-block, masked", (4, 1, 1024, 512), True),
    ("DiT width, 2048 tokens", (4, 16, 2048, 64), False),
    ("D 128, 2048 tokens", (2, 8, 2048, 128), False),
    ("bench_attention --grad, masked", (2, 8, 2048, 64), True),
    # the ring's kernel hops of phase 8a (a hop's dQ and dK/dV)
    ("ring hop, P 2 (2048 local tokens)", (1, 16, 2048, 64), False),
    ("ring hop, P 4 (1024 local tokens), masked", (1, 16, 1024, 64), True),
    # the CNN motion AE's loss backward (phase 3r)
    ("AE MapConv (D 640)", (16, 1, 1024, 640), False),
    ("AE MapConv, masked (D 640)", (4, 1, 1024, 640), True),
    # ragged: the last 64-row block of a cluster and zero-filled walked rows
    ("SD-VAE mid-block, ragged, masked (Sq 1000)", (2, 1, 1000, 512), True),
    ("AE MapConv, ragged, masked (Sq 1000, D 640)", (2, 1, 1000, 640),
     True),
]
STREAM_MASKED_KEYS = slice(64, 128)
# Gradients of bf16 attention, held relative to their largest element: both
# sides round P and dS to bf16 from sums taken in another order, and the
# full-block kernel takes delta = rowsum(dO * O) from the bf16 output where
# its plain version takes rowsum(dP * P) in fp32.
BWD_RTOL = 2e-2
# delta = rowsum(dO * O) against its plain version: fp32 sums over D in
# another order, held relative to the row's sum of |dO * O|
DELTA_RTOL = 1e-5
# A training step with the kernels against the same step with the plain
# attention versions, from the same state, batch and draws. The two differ
# only by where bf16 rounds inside ~120 attentions of a random-weight
# model; over one step that moves the fp32 loss by well under 1% and
# leaves the 696 M-element gradient pointing the same way.
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_COS = 0.99
# The same in fp32 (`--mp no`): the kernels' 3xTF32 products and sums in
# another order against the plain versions' fp32 ones, ~1e-6 a call
F32_STEP_LOSS_RTOL = 1e-3
F32_STEP_GRAD_COS = 0.999
# and the gradient's relative L2 distance, which the cosine is too coarse
# to read: 1-2e-7 on the kernels on an H100, where the plain step with its
# matmuls in TF32 (the control the step logs beside it) reads far above it
F32_STEP_GRAD_REL_L2 = 1e-5
# A remat policy changes what the backward keeps, not what it computes:
# against remat full from the same state, batch and draws, only the order
# of bf16 roundings in the recomputed matmuls may differ.
REMAT_LOSS_RTOL = 1e-5
REMAT_GRAD_COS = 0.9999
REMAT_POLICIES = (None, "full", "dots", "dots_sans_ffn", "dots_offload")
# the training CLI (phase 7): synthetic mp4s, clips a step, steps before
# and after the resume, steps of the use_mask run (7b)
CLI_VIDEOS, CLI_VIDEO_FRAMES = 8, 24
CLI_STEPS, CLI_SAVE_EVERY, CLI_RESUME_TO, CLI_MASK_STEPS = 3, 2, 4, 2
# the config variants trained for one step in phase 6, each with the
# modules its training forward does not run (no gradient; as in the JAX
# package, the motion transformer serves extract_motion and refimg-motion
# sampling, and the TempMotion DiT reads no camera stream)
VARIANTS = {
    "camera_down_motion_transformer": (
        dict(use_camera_down=True, need_motion_transformer=True),
        ("motion_transformer.",)),
    "default_dit": (dict(diffusion_model_type="default"),
                    ("camera_motion_encoder.",)),
}
VALIDATE_STEPS = 2


def full_block_bwd_cases(clips):
    """(label, q shape, launches per training step) at N clips of 16
    frames: 8 object-encoder layers over 2T frames, 12 DiT layers with an
    object and a camera joint block."""
    nt = clips * WINDOW
    return [(f"object encoder N={clips}", (2 * nt, 8, 260, 64), 8),
            (f"DiT object joint N={clips}", (nt, 16, 266, 64), 12),
            (f"DiT camera joint N={clips}", (nt, 16, 512, 64), 12)]


# the fp32 full-block kernels' cases (label, q shape, Sk or None, forward
# and backward launches a `--mp no` step of the flagship at N =
# F32_STEP_CLIPS (the DiT's forward twice under remat), masked): its three
# sites at that N, then check-only cases: a masked one with a fully masked
# key row, Sq != Sk, and the other heads' widths (the T2M joint block at D
# 128, the MAE decoder at D 32, MAE_L's encoder at mask 0 at D 64, AMD_L's
# DiT at D 96, masked)
F32_STEP_CLIPS = 2
FULL_BLOCK_F32_CASES = [
    (label, shape, None, n * (1 if "encoder" in label else 2), n, False)
    for label, shape, n in full_block_bwd_cases(F32_STEP_CLIPS)] + [
    ("DiT camera joint N=2, masked", (32, 16, 512, 64), None, 0, 0, True),
    ("Sq 300, Sk 700, masked", (2, 4, 300, 64), 700, 0, 0, True),
    ("T2M joint (S 269, D 128)", (16, 16, 269, 128), None, 0, 0, False),
    ("MAE decoder N=32 (S 257, D 32)", (32, 16, 257, 32), None, 0, 0, False),
    ("MAE_L encoder, mask 0 (S 257, D 64)", (4, 16, 257, 64), None, 0, 0,
     False),
    ("AMD_L DiT joint, masked (D 96)", (4, 16, 282, 96), None, 0, 0, True),
]


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    """A line on stderr; a phase's first line carries the seconds since
    the script started, so the log shows where its time went."""
    if msg.startswith("phase "):
        msg = f"{msg}  [{time.perf_counter() - _T0:.1f} s]"
    print(msg, file=sys.stderr, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _ptxas_summary(log: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output:
    kernel<D>, registers, static shared memory, spills. (The full-block
    kernels' dynamic shared memory is their launch plan's, logged per shape
    in phase 2.)"""
    kernel, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN2hv(\d+)(\w+)'", line)
        if m:
            d = re.search(r"ILi(\d+)E(Lb1E)?", m.group(2))
            e = re.search(r"I(f|13__nv_bfloat16|6__half)(Lb([01])E)?E",
                          m.group(2))
            kernel = m.group(2)[:int(m.group(1))] + (
                f"<{d.group(1)}{', qknorm' if d.group(2) else ''}>" if d
                else f"<{ {'f': 'fp32', '6__half': 'fp16'}.get(e.group(1), 'bf16')}"
                f"{'' if not e.group(2) else ', dkv' if e.group(3) == '1' else ', dq'}>"
                if e else "")
        elif "spill" in line:
            spill = line.strip()
        elif re.search(r"Used \d+ registers", line):
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            yield (f"{kernel}: {regs.group(1) if regs else '?'} registers, "
                   f"{smem.group(1) if smem else 0} bytes static smem, "
                   f"{spill}")


def _time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, key: str, n: int = 10):
    """ms of device time a call of ``fn`` in kernels whose names hold
    ``key``, from ``torch.profiler``'s CUDA activity over n calls after
    one: the kernels alone, where CUDA events around calls that take less
    device time than their launch path time the host. None where three
    traces caught no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace that caught no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if key in e.key:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
        if us > 0:
            return us / n / 1e3
    return None   # not measured: the profiler caught no such kernel


def _ms_or_none(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _bound(shape, with_bias: bool, with_lse: bool, tensors: int = 4,
           stats: int = 0, flop_factor: int = 4, sk=None, elem_bytes=2,
           peak=PEAK_BF16_FLOPS):
    """(bytes ms, operations ms) of one attention call at the card's peaks.
    Bytes: ``tensors`` tensors of ``elem_bytes`` (bf16: 2) each read or
    written once, half of them (B, H, Sq, D) and half (B, H, Sk, D)
    (forward: q, o and k, v), the fp32 bias row, the fp32 LSE and ``stats``
    more fp32 (B, H, Sq) rows. Operations: ``flop_factor``*B*H*Sq*Sk*D
    matmul flops (forward: 4, Q.K^T and P.V) at ``peak`` (the bf16
    tensor-core peak; for fp32 operands fp32's)."""
    b, h, s, d = shape
    sk = s if sk is None else sk
    nbytes = tensors * b * h * (s + sk) * d * elem_bytes // 2
    nbytes += b * sk * 4 if with_bias else 0
    nbytes += b * h * s * 4 * ((1 if with_lse else 0) + stats)
    flops = flop_factor * b * h * s * sk * d
    return nbytes / PEAK_HBM_BYTES * 1e3, flops / peak * 1e3


def _library_bwd_ms(q, k, v, do, mask, scale, iters):
    """F.scaled_dot_product_attention forward + backward minus forward."""
    import torch
    import torch.nn.functional as F
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                             scale=scale)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                           scale=scale)
    return _time_ms(fwd_bwd, iters) - _time_ms(fwd, iters)


def _plan_str(plan):
    return (f"forward {plan.fwd_stages} slots"
            f"{' resident' if plan.resident else ''} {plan.fwd_smem} B, "
            f"backward {plan.bwd_stages} slots {plan.bwd_smem} B")


def _abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _rel_err(got, want):
    return _abs_err(got, want) / want.float().abs().max().item()


def check_bwd_kernels(fa, failures, parent=None):
    """Phase 2, backward kernels. Returns the per-kernel records. With
    ``parent``, its full-block backward is timed beside this one's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def masked_bias(b, s, full_row=True):
        keep = torch.rand((b, s), generator=gen, device="cuda") > 0.3
        keep[:, 0] = True
        if full_row:
            keep[0] = False   # one fully masked row
        return torch.where(keep, 0.0, -1e30).to(torch.float32)

    # (label, q shape, Sk or None, launches per step, clips, masked)
    cases = []
    for clips in (RUN_A_CLIPS, RUN_B_CLIPS):
        cases += [(label, shape, None, per_step, clips, False)
                  for label, shape, per_step in full_block_bwd_cases(clips)]
    cases += [("object encoder N=1, masked", (32, 8, 260, 64), None, 0, 0,
               True)]
    cases += [(label, shape, sk, 0, 0, masked)
              for label, shape, sk, _, masked in FULL_BLOCK_CHECKS]
    fb, deltas = [], []
    for label, shape, sk, per_step, clips, masked in cases:
        kv = shape if sk is None else shape[:2] + (sk, shape[3])
        q, k, v, do = rand(shape), rand(kv), rand(kv), rand(shape)
        scale = shape[3] ** -0.5
        bias = masked_bias(shape[0], kv[2]) if masked else None
        out, m, l = fa._full_block_fwd(q, k, v, bias, scale, stats=True)
        got = fa.full_block_attention_bwd(q, k, v, do, out, m, l,
                                          scale=scale, bias=bias)
        again = fa.full_block_attention_bwd(q, k, v, do, out, m, l,
                                            scale=scale, bias=bias)
        want = fa.full_block_attention_bwd_plain(q, k, v, do, scale=scale,
                                                 bias=bias)
        delta, inv_l = fa.full_block_attention_delta(do, out, l)
        want_delta, want_il = fa.full_block_attention_delta_plain(do, out, l)
        torch.cuda.synchronize()
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        abs_err = max(_abs_err(g, w) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (finite and max(errs) <= BWD_RTOL):
            failures.append(f"full_block_bwd {label}: rel err dq/dk/dv "
                            f"{errs} finite {finite}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            failures.append(f"full_block_bwd {label}: two launches differ")
        # delta: fp32 sums over D in another order; 1/l the same reciprocal
        d_err = _abs_err(delta, want_delta)
        d_scale = (do.float().abs() * out.float().abs()).sum(-1).max().item()
        if not (d_err <= DELTA_RTOL * d_scale and torch.equal(inv_l, want_il)):
            failures.append(f"full_block_delta {label}: max|err| {d_err} "
                            f"(scale {d_scale}), 1/l equal "
                            f"{torch.equal(inv_l, want_il)}")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        ms = _time_ms(lambda: fa.full_block_attention_bwd(
            q, k, v, do, out, m, l, scale=scale, bias=bias), 20)
        plain_ms = _time_ms(lambda: fa.full_block_attention_bwd_plain(
            q, k, v, do, scale=scale, bias=bias), 5)
        lib_ms = _library_bwd_ms(q, k, v, do, mask, scale, 20)
        parent_ms = None
        if parent is not None:
            pout, pm, pl = parent._full_block_fwd(q, k, v, bias, scale,
                                                  stats=True)
            parent_ms = _time_ms(lambda: parent.full_block_attention_bwd(
                q, k, v, do, pout, pm, pl, scale=scale, bias=bias), 20)
        bytes_ms, ops_ms = _bound(shape, bias is not None, False, tensors=7,
                                  stats=3, flop_factor=10, sk=kv[2])
        weight = per_step if clips == RUN_A_CLIPS else 0
        fb.append(dict(label=label, shape=list(shape), sk=kv[2], clips=clips,
                       per_step=per_step, weight=weight,
                       max_abs_err=abs_err, max_rel_err=max(errs), ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       parent_ms=parent_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                       err_dq_dk_dv=errs))
        d_ms = _time_ms(lambda: fa.full_block_attention_delta(do, out, l), 20)
        d_plain = _time_ms(lambda: fa.full_block_attention_delta_plain(
            do, out, l), 20)
        d_lib = _time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1), 20)
        b, h, sq, d = shape
        # dO and O read once, l read, delta and 1/l written; 2 B H Sq D
        # fp32 operations
        d_bytes = (2 * b * h * sq * d * 2 + 3 * b * h * sq * 4)
        deltas.append(dict(label=label, shape=list(shape), weight=weight,
                           max_abs_err=d_err, ms=d_ms, plain_ms=d_plain,
                           library_ms=d_lib,
                           bytes_ms=d_bytes / PEAK_HBM_BYTES * 1e3,
                           ops_ms=2 * b * h * sq * d / PEAK_FP32_FLOPS * 1e3))
        _log(f"  full_block_bwd {label} {shape} Sk {kv[2]}: rel err dq "
             f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}  kernel "
             f"{ms:.4f} ms (delta pre-pass {d_ms:.4f}, plain {d_plain:.4f}) "
             f" parent {parent_ms} ms"
             f" plain {plain_ms:.4f} ms  sdpa bwd {lib_ms:.4f} ms  bound "
             f"{max(bytes_ms, ops_ms):.4f} ms")

    dq_cases, dkv_cases, sdeltas = [], [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, shape, per_step, clips, masked in [
            ("SD-VAE decoder mid-block N=1", (16, 1, 1024, 512), 1,
             RUN_B_CLIPS, False)] + [
            (lab, shape, 0, 0, masked)
            for lab, shape, masked in STREAM_BWD_CHECKS]:
        q, k, v, do = (rand(shape) for _ in range(4))
        scale = shape[3] ** -0.5
        bias = None
        if masked:
            # masked keys and a fully masked key block, in rows that attend
            # to some key: the streaming backward takes P from the LSE, as
            # the TPU kernels do, and a row with no key to attend to has no
            # LSE that keeps its 1/l at -1e30
            bias = masked_bias(shape[0], shape[2], full_row=False)
            bias[:, STREAM_MASKED_KEYS] = -1e30
        kw = dict(scale=scale, bias=bias)
        out, lse = fa.stream_attention(q, k, v, **kw)
        delta = fa.stream_attention_delta(do, out)
        dq = fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        again = (fa.stream_attention_delta(do, out),
                 fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
        want = fa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
        want_delta = fa._delta(do, out)
        torch.cuda.synchronize()
        errs = [_rel_err(g, w) for g, w in zip((dq, dk, dv), want)]
        abs_errs = [_abs_err(g, w) for g, w in zip((dq, dk, dv), want)]
        finite = all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
        if not (finite and max(errs) <= BWD_RTOL):
            failures.append(f"stream_bwd {label}: rel err dq/dk/dv {errs} "
                            f"finite {finite}")
        if not all(torch.equal(a, b) for a, b in
                   zip((delta, dq, dk, dv), again)):
            failures.append(f"stream_bwd {label}: two launches differ")
        if bias is not None and max(
                dk[:, :, STREAM_MASKED_KEYS].abs().max().item(),
                dv[:, :, STREAM_MASKED_KEYS].abs().max().item()) != 0:
            failures.append(f"stream_bwd {label}: a fully masked key block "
                            f"got a gradient")
        d_err = _abs_err(delta, want_delta)
        d_scale = (do.float().abs() * out.float().abs()).sum(-1).max().item()
        if not d_err <= DELTA_RTOL * d_scale:
            failures.append(f"stream_delta {label}: max|err| {d_err} (scale "
                            f"{d_scale})")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        iters = 20
        dq_ms = _time_ms(lambda: fa.stream_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw), iters)
        dkv_ms = _time_ms(lambda: fa.stream_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw), iters)
        d_ms = _time_ms(lambda: fa.stream_attention_delta(do, out), iters)
        d_plain = _time_ms(lambda: fa._delta(do, out), iters)
        d_lib = _time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1), iters)
        plain_ms = _time_ms(lambda: fa.stream_attention_bwd_plain(
            q, k, v, do, out, lse, **kw), 5)
        lib_ms = _library_bwd_ms(q, k, v, do, mask, scale, iters)
        parent_dq = parent_dkv = None
        if parent is not None:
            parent_dq = _time_ms(lambda: parent.stream_attention_bwd_dq(
                q, k, v, do, lse, delta, **kw), iters)
            parent_dkv = _time_ms(lambda: parent.stream_attention_bwd_dkv(
                q, k, v, do, lse, delta, **kw), iters)
        plan = fa._stream_bwd_plan(shape[3])
        ctas = -(-shape[2] // plan.rows) * shape[0] * shape[1] * plan.cluster
        common = dict(label=label, shape=list(shape), clips=clips,
                      per_step=per_step, weight=per_step, plain_ms=plain_ms,
                      library_ms=lib_ms, plan=dataclasses.asdict(plan),
                      ctas=ctas, waves=ctas / sms)
        b_ms, o_ms = _bound(shape, bias is not None, True, tensors=5,
                            stats=1, flop_factor=6)
        dq_cases.append(dict(common, max_abs_err=abs_errs[0],
                             max_rel_err=errs[0], ms=dq_ms,
                             parent_ms=parent_dq, bytes_ms=b_ms,
                             ops_ms=o_ms))
        b_ms2, o_ms2 = _bound(shape, bias is not None, True, tensors=6,
                              stats=1, flop_factor=8)
        dkv_cases.append(dict(common, max_abs_err=max(abs_errs[1:]),
                              max_rel_err=max(errs[1:]), ms=dkv_ms,
                              parent_ms=parent_dkv, bytes_ms=b_ms2,
                              ops_ms=o_ms2))
        b, h, sq, d = shape
        # dO and O read once, delta written; 2 B H Sq D fp32 operations
        d_bytes = 2 * b * h * sq * d * 2 + b * h * sq * 4
        sdeltas.append(dict(label=label, shape=list(shape), weight=per_step,
                            max_abs_err=d_err, ms=d_ms, plain_ms=d_plain,
                            library_ms=d_lib,
                            bytes_ms=d_bytes / PEAK_HBM_BYTES * 1e3,
                            ops_ms=2 * b * h * sq * d / PEAK_FP32_FLOPS * 1e3))
        _log(f"  stream_bwd {label} {shape}: rel err dq {errs[0]:.3g} dk "
             f"{errs[1]:.3g} dv {errs[2]:.3g}, delta {d_err:.3g}  dq kernel "
             f"{dq_ms:.4f} ms (parent {parent_dq}, bound "
             f"{max(b_ms, o_ms):.4f})  dkv kernel {dkv_ms:.4f} ms (parent "
             f"{parent_dkv}, bound {max(b_ms2, o_ms2):.4f})  delta "
             f"{d_ms:.4f} ms (plain {d_plain:.4f})  sum "
             f"{d_ms + dq_ms + dkv_ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
             f"bwd {lib_ms:.4f} ms  ({plan.rows} rows a CTA, cluster "
             f"{plan.cluster}, {plan.stages} "
             f"slots, {plan.smem} B, {ctas} "
             f"CTAs, {ctas / sms:.2f} waves of one a SM on {sms} SMs)")

    src = "hivae_tpu_torch/csrc/"
    tpu = "hivae_tpu/ops/pallas/flash_attention.py:"

    def record(name, source, line, cs):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": tpu + line, "cases": cs}
    bwd = record("full_block_attention_bwd", "flash_full_block_bwd.cu", "188",
                 fb)
    # the backward's delta pre-pass: its own launch and counter, listed
    # under the backward's record
    bwd["delta"] = record("full_block_attention_delta",
                          "flash_full_block_bwd.cu", "188", deltas)
    dq_rec = record("stream_attention_bwd_dq", "flash_stream_bwd.cu", "512",
                    dq_cases)
    # the streaming backward's delta pre-pass: its own launch and counter,
    # listed under the dQ record (the JAX package computes delta in XLA)
    dq_rec["delta"] = record("stream_attention_delta", "flash_stream_bwd.cu",
                             "512", sdeltas)
    return [bwd, dq_rec,
            record("stream_attention_bwd_dkv", "flash_stream_bwd.cu", "552",
                   dkv_cases)]


def check_kernels(fa, failures, parent=None):
    """Phase 2. Returns the per-kernel records (before launches). With
    ``parent`` (another checkout's flash_attention module) its full-block
    and streaming forwards are timed beside this one's."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(shape, sk=None):
        kv = shape if sk is None else shape[:2] + (sk, shape[3])
        return [torch.randn(x, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for x in (shape, kv, kv)]

    def record(name, src, replaces, cases):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "cases": cases}

    fb_cases = []
    for label, shape, sk, per_clip, masked in [
            (lab, shape, None, n, False) for lab, shape, n in FULL_BLOCK_CASES
    ] + FULL_BLOCK_CHECKS:
        q, k, v = qkv(shape, sk)
        scale = shape[3] ** -0.5
        bias = None
        if masked:
            keep = torch.rand((shape[0], k.shape[2]), generator=gen,
                              device="cuda") > 0.3
            keep[0] = False   # one fully masked row
            bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        got = fa.full_block_attention(q, k, v, scale=scale, bias=bias)
        again = fa.full_block_attention(q, k, v, scale=scale, bias=bias)
        want = fa.full_block_attention_plain(q, k, v, scale=scale, bias=bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        if not torch.equal(got, again):
            failures.append(f"full_block {label}: two launches differ")
        if masked:
            uniform = v[0].float().mean(dim=1, keepdim=True)
            err_u = (got[0].float() - uniform).abs().max().item()
            _log(f"  {label}: fully masked row vs uniform average "
                 f"max|err| {err_u:.3g}")
            if not err_u <= KERNEL_ATOL:
                failures.append(f"full_block {label}: masked row not uniform "
                                f"({err_u})")
        if not (finite and err <= KERNEL_ATOL):
            failures.append(f"full_block {label} {shape}: max|err| {err} "
                            f"finite {finite}")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        iters = 50
        ms = _time_ms(lambda: fa.full_block_attention(q, k, v, scale=scale,
                                                      bias=bias), iters)
        plain_ms = _time_ms(lambda: fa.full_block_attention_plain(
            q, k, v, scale=scale, bias=bias), 10)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters)
        parent_ms = None if parent is None else _time_ms(
            lambda: parent.full_block_attention(q, k, v, scale=scale,
                                                bias=bias), iters)
        bytes_ms, ops_ms = _bound(shape, bias is not None, False,
                                  sk=k.shape[2])
        plan = fa._full_block_plan(shape[2], k.shape[2], shape[3])
        fb_cases.append(dict(label=label, shape=list(shape), sk=k.shape[2],
                             per_clip=per_clip, weight=per_clip,
                             max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             parent_ms=parent_ms,
                             bytes_ms=bytes_ms, ops_ms=ops_ms,
                             plan=dataclasses.asdict(plan)))
        _log(f"  full_block {label} {shape} Sk {k.shape[2]}: max|err| "
             f"{err:.3g}  kernel {ms:.4f} ms  parent {parent_ms} ms  plain "
             f"{plain_ms:.4f} ms  sdpa "
             f"{lib_ms:.4f} ms  bound {max(bytes_ms, ops_ms):.4f} ms  "
             f"({_plan_str(plan)})")

    st_cases = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, shape, per_clip, masked in [
            (lab, shape, n, False) for lab, shape, n in STREAM_CASES] + [
            (lab, shape, 0, masked) for lab, shape, masked in STREAM_CHECKS]:
        q, k, v = qkv(shape)
        scale = shape[3] ** -0.5
        bias = None
        if masked:
            keep = torch.rand((shape[0], shape[2]), generator=gen,
                              device="cuda") > 0.3
            keep[0] = False   # one fully masked key row
            bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        kw = dict(scale=scale, bias=bias)
        out, lse = fa.stream_attention(q, k, v, **kw)
        wo, wl = fa.stream_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - wo.float()).abs().max().item()
        err_lse = (lse - wl).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        if not (finite and err <= KERNEL_ATOL and err_lse <= LSE_ATOL):
            failures.append(f"stream {label} {shape}: max|err| {err} lse "
                            f"{err_lse} finite {finite}")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        ms = _time_ms(lambda: fa.stream_attention(q, k, v, **kw), 20)
        plain_ms = _time_ms(lambda: fa.stream_attention_plain(q, k, v, **kw),
                            10)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), 20)
        parent_ms = None if parent is None else _time_ms(
            lambda: parent.stream_attention(q, k, v, **kw), 20)
        bytes_ms, ops_ms = _bound(shape, masked, True)
        plan = fa._stream_plan(shape[3])
        ctas = -(-shape[2] // fa.STREAM_ROWS) * shape[0] * shape[1]
        st_cases.append(dict(label=label, shape=list(shape),
                             per_clip=per_clip, weight=per_clip,
                             max_abs_err=max(err, err_lse),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             parent_ms=parent_ms, bytes_ms=bytes_ms,
                             ops_ms=ops_ms, plan=dataclasses.asdict(plan),
                             ctas=ctas, waves=ctas / sms))
        _log(f"  stream {label} {shape}: max|err| O {err:.3g} LSE "
             f"{err_lse:.3g}  kernel {ms:.4f} ms  parent {parent_ms} ms  "
             f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
             f"{max(bytes_ms, ops_ms):.4f} ms  ({plan.stages} slots, "
             f"{plan.smem} B, {ctas} CTAs, {ctas / sms:.2f} waves of one a "
             f"SM on {sms} SMs)")

    return [
        record("full_block_attention",
               "hivae_tpu_torch/csrc/flash_full_block.cu",
               "hivae_tpu/ops/pallas/flash_attention.py:167", fb_cases),
        record("stream_attention", "hivae_tpu_torch/csrc/flash_stream.cu",
               "hivae_tpu/ops/pallas/flash_attention.py:468", st_cases),
        record("stream_attention_f32",
               "hivae_tpu_torch/csrc/flash_stream.cu",
               "hivae_tpu/ops/pallas/flash_attention.py:468",
               check_stream_f32(fa, failures, gen, sms, parent)),
    ]


def check_stream_f32(fa, failures, gen, sms, parent=None):
    """Phase 2, the fp32 streaming forward (``stream_attention_f32``) on
    fp32 operands: against its fp32 plain version within KERNEL_F32_ATOL
    (outputs and LSE), two launches to the same bits, a fully masked key
    row as the uniform average, timed beside its plain version, SDPA in
    fp32 (TF32 off, as this script sets it) and ``parent``'s kernel. Its
    bound: the fp32 bytes of q, k, v, o and the LSE, and its three TF32
    products (the hi/lo split) at TF32's tensor-core peak; the flops at
    fp32's peak outside the tensor cores are logged beside it. Returns the
    cases."""
    import torch
    import torch.nn.functional as F

    cases = []
    for label, shape, weight, masked in [
            (lab, shape, n, False) for lab, shape, n in STREAM_F32_CASES] + [
            (lab, shape, 0, masked) for lab, shape, masked in
            STREAM_F32_CHECKS]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        scale = shape[3] ** -0.5
        bias = None
        if masked:
            keep = torch.rand((shape[0], shape[2]), generator=gen,
                              device="cuda") > 0.3
            keep[0] = False   # one fully masked key row
            bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        kw = dict(scale=scale, bias=bias)
        out, lse = fa.stream_attention(q, k, v, **kw)
        again, _ = fa.stream_attention(q, k, v, **kw)
        wo, wl = fa.stream_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _abs_err(out, wo)
        err_lse = (lse - wl).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        if not torch.equal(out, again):
            failures.append(f"stream fp32 {label}: two launches differ")
        if masked:
            err_u = (out[0].float() - v[0].float().mean(
                dim=1, keepdim=True)).abs().max().item()
            if not err_u <= KERNEL_F32_ATOL:
                failures.append(f"stream fp32 {label}: masked row not "
                                f"uniform ({err_u})")
        if not (finite and out.dtype == torch.float32 and
                err <= KERNEL_F32_ATOL and err_lse <= KERNEL_F32_ATOL):
            failures.append(f"stream fp32 {label} {shape}: max|err| {err} "
                            f"lse {err_lse} finite {finite}")
        mask = None if bias is None else bias[:, None, None, :]
        ms = _time_ms(lambda: fa.stream_attention(q, k, v, **kw), 20)
        plain_ms = _time_ms(lambda: fa.stream_attention_plain(q, k, v, **kw),
                            10)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), 20)
        parent_ms = None
        if parent is not None:
            # the kernel's code is the parent's: the same bits
            pout, plse = parent.stream_attention(q, k, v, **kw)
            if not (torch.equal(out, pout) and torch.equal(lse, plse)):
                failures.append(f"stream fp32 {label}: the parent's kernel "
                                f"gives other bits")
            parent_ms = _time_ms(
                lambda: parent.stream_attention(q, k, v, **kw), 20)
        bytes_ms, ops_ms = _bound(shape, masked, True, elem_bytes=4,
                                  flop_factor=12, peak=PEAK_TF32_FLOPS)
        simt_ms = _bound(shape, masked, True, elem_bytes=4,
                         peak=PEAK_FP32_FLOPS)[1]
        plan = fa._stream_f32_plan(shape[3])
        ctas = -(-shape[2] // plan.rows) * shape[0] * shape[1]
        cases.append(dict(label=label, shape=list(shape), per_clip=weight,
                          weight=weight, max_abs_err=max(err, err_lse),
                          ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          parent_ms=parent_ms, bytes_ms=bytes_ms,
                          ops_ms=ops_ms, fp32_simt_ms=simt_ms,
                          plan=dataclasses.asdict(plan), ctas=ctas,
                          waves=ctas / sms))
        _log(f"  stream fp32 {label} {shape}: max|err| O {err:.3g} LSE "
             f"{err_lse:.3g}  kernel {ms:.4f} ms  parent {parent_ms} ms  "
             f"plain {plain_ms:.4f} ms  sdpa fp32 {lib_ms:.4f} ms  bound "
             f"{max(bytes_ms, ops_ms):.4f} ms (3xTF32 {ops_ms:.4f}, bytes "
             f"{bytes_ms:.4f}; fp32 outside the tensor cores {simt_ms:.4f})"
             f"  ({plan.rows} rows, {plan.tile}-key tiles, {plan.stages} "
             f"slots, {plan.smem} B, {ctas} CTAs, {ctas / sms:.2f} waves)")
    return cases


def _f32_gate(got, want):
    """(max|err|, whether it is within KERNEL_F32_ATOL * max(1, max|want|))
    of an fp32 kernel's output against its fp32 plain version."""
    err = _abs_err(got, want)
    return err, err <= KERNEL_F32_ATOL * max(1.0, want.abs().max().item())


def check_f32_kernels(fa, failures, sms, parent=None):
    """Phase 2, the fp32 full-block forward (and its qk-norm variant) and
    the fp32 backward kernels (full-block backward and delta; streaming
    delta, dQ and dK/dV) on fp32 operands, each against its fp32 plain
    version (TF32 off, as this script sets it) within ``_f32_gate``,
    launched twice to the same bits; a fully masked key row (full-block)
    must give the uniform average and a fully masked key block (streaming)
    no gradient. Each is timed beside its plain version and one PyTorch
    call in fp32 (SDPA's forward; for a backward SDPA forward + backward
    minus forward); its bound is its TF32 products (three a matmul) at
    TF32's peak or its fp32 bytes, the larger. With ``parent`` (another
    checkout's flash_attention module) the parent's fp32 full-block
    forward, qk-norm forward and backward are timed beside these on the
    same inputs (``parent_ms``), and the kernels whose code the parent
    shares must give its bits: the full-block delta pre-pass and the
    streaming delta, dQ and dK/dV. The full-block kernels' device time
    alone (``_device_ms``) goes beside each, and the parent's
    (``device_ms``, ``parent_device_ms``). Returns the records."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def masked_bias(b, s, full_row):
        keep = torch.rand((b, s), generator=gen, device="cuda") > 0.3
        keep[:, 0] = True
        if full_row:
            keep[0] = False   # one fully masked key row
        return torch.where(keep, 0.0, -1e30).to(torch.float32)

    fwd, qkn, bwd, fdelta = [], [], [], []
    for label, shape, sk, fwd_w, bwd_w, masked in FULL_BLOCK_F32_CASES:
        kv = shape if sk is None else shape[:2] + (sk, shape[3])
        q, k, v, do = rand(shape), rand(kv), rand(kv), rand(shape)
        scale = shape[3] ** -0.5
        bias = masked_bias(shape[0], kv[2], True) if masked else None
        kw = dict(scale=scale, bias=bias)
        out, m, l = fa._full_block_fwd(q, k, v, bias, scale, stats=True)
        again = fa.full_block_attention(q, k, v, **kw)
        want = fa.full_block_attention_plain(q, k, v, **kw)
        norms = _norm_params(gen, shape[3])
        qn = fa.full_block_attention_qknorm(q, k, v, *norms, **kw)
        qn2 = fa.full_block_attention_qknorm(q, k, v, *norms, **kw)
        qn_want = fa.full_block_attention_qknorm_plain(q, k, v, *norms, **kw)
        grads = fa.full_block_attention_bwd(q, k, v, do, out, m, l, **kw)
        grads2 = fa.full_block_attention_bwd(q, k, v, do, out, m, l, **kw)
        gwant = fa.full_block_attention_bwd_plain(q, k, v, do, **kw)
        delta, inv_l = fa.full_block_attention_delta(do, out, l)
        delta2, _ = fa.full_block_attention_delta(do, out, l)
        dwant, ilwant = fa.full_block_attention_delta_plain(do, out, l)
        if parent is not None and not all(
                torch.equal(a, b) for a, b in zip(
                    (delta, inv_l),
                    parent.full_block_attention_delta(do, out, l))):
            failures.append(f"full_block fp32 {label}: the parent's delta "
                            f"pre-pass gives other bits")
        torch.cuda.synchronize()
        err, ok = _f32_gate(out, want)
        qerr, qok = _f32_gate(qn, qn_want)
        gerrs = [_f32_gate(g, w) for g, w in zip(grads, gwant)]
        derr, dok = _f32_gate(delta, dwant)
        finite = all(bool(torch.isfinite(x).all())
                     for x in (out, qn, delta, *grads))
        if not (finite and ok and qok and all(g[1] for g in gerrs) and dok
                and torch.equal(inv_l, ilwant)):
            failures.append(f"full_block fp32 {label} {shape} Sk {kv[2]}: "
                            f"max|err| out {err} qknorm {qerr} dq/dk/dv "
                            f"{[g[0] for g in gerrs]} delta {derr}, 1/l "
                            f"equal {torch.equal(inv_l, ilwant)}, finite "
                            f"{finite}")
        if not (torch.equal(out, again) and torch.equal(qn, qn2) and all(
                torch.equal(a, b) for a, b in zip(grads, grads2)) and
                torch.equal(delta, delta2)):
            failures.append(f"full_block fp32 {label}: two launches differ")
        if masked:
            err_u = (out[0] - v[0].mean(dim=1, keepdim=True)).abs().max()
            if not err_u.item() <= KERNEL_F32_ATOL:
                failures.append(f"full_block fp32 {label}: masked row not "
                                f"uniform ({err_u.item()})")
        mask = None if bias is None else bias[:, None, None, :]
        ms = _time_ms(lambda: fa.full_block_attention(q, k, v, **kw), 20)
        plain_ms = _time_ms(lambda: fa.full_block_attention_plain(
            q, k, v, **kw), 5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), 20)
        q_ms = _time_ms(lambda: fa.full_block_attention_qknorm(
            q, k, v, *norms, **kw), 20)
        q_plain = _time_ms(lambda: fa.full_block_attention_qknorm_plain(
            q, k, v, *norms, **kw), 5)
        p_ms = pq_ms = pb_ms = None
        # the kernels' device time alone (this checkout's forward goes
        # through its custom op, the parent's through a plain function:
        # their launch paths differ, and small shapes time those)
        calls = {"fwd": lambda mod: mod.full_block_attention(q, k, v, **kw),
                 "qkn": lambda mod: mod.full_block_attention_qknorm(
                     q, k, v, *norms, **kw),
                 "bwd": lambda mod: mod.full_block_attention_bwd(
                     q, k, v, do, out, m, l, **kw)}
        dev = {n: _device_ms(lambda: c(fa), "full_block")
               for n, c in calls.items()}
        pdev = dict.fromkeys(calls)
        if parent is not None:
            p_ms = _time_ms(lambda: parent.full_block_attention(q, k, v,
                                                                **kw), 20)
            pq_ms = _time_ms(lambda: parent.full_block_attention_qknorm(
                q, k, v, *norms, **kw), 20)
            pb_ms = _time_ms(lambda: parent.full_block_attention_bwd(
                q, k, v, do, out, m, l, **kw), 20)
            pdev = {n: _device_ms(lambda: c(parent), "full_block")
                    for n, c in calls.items()}

        def ln_sdpa():
            d = shape[3]
            qq = F.layer_norm(q, (d,), norms[0], norms[1], 1e-6)
            kk = F.layer_norm(k, (d,), norms[2], norms[3], 1e-6)
            return F.scaled_dot_product_attention(qq, kk, v, attn_mask=mask,
                                                  scale=scale)
        q_lib = _time_ms(ln_sdpa, 20)
        b_ms = _time_ms(lambda: fa.full_block_attention_bwd(
            q, k, v, do, out, m, l, **kw), 20)
        b_plain = _time_ms(lambda: fa.full_block_attention_bwd_plain(
            q, k, v, do, **kw), 5)
        b_lib = _library_bwd_ms(q, k, v, do, mask, scale, 20)
        d_ms = _time_ms(lambda: fa.full_block_attention_delta(do, out, l),
                        20)
        d_plain = _time_ms(lambda: fa.full_block_attention_delta_plain(
            do, out, l), 20)
        d_lib = _time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1), 20)
        f_bytes, f_ops = _bound(shape, masked, False, stats=2, sk=kv[2],
                                flop_factor=12, elem_bytes=4,
                                peak=PEAK_TF32_FLOPS)
        b_bytes, b_ops = _bound(shape, masked, False, tensors=7, stats=3,
                                sk=kv[2], flop_factor=30, elem_bytes=4,
                                peak=PEAK_TF32_FLOPS)
        b, h, sq, d = shape
        common = dict(label=label, shape=list(shape), sk=kv[2])
        fwd.append(dict(common, weight=fwd_w, max_abs_err=err, ms=ms,
                        parent_ms=p_ms, device_ms=dev["fwd"],
                        parent_device_ms=pdev["fwd"], plain_ms=plain_ms,
                        library_ms=lib_ms, bytes_ms=f_bytes, ops_ms=f_ops))
        qkn.append(dict(common, weight=fwd_w, max_abs_err=qerr, ms=q_ms,
                        parent_ms=pq_ms, device_ms=dev["qkn"],
                        parent_device_ms=pdev["qkn"], plain_ms=q_plain,
                        library_ms=q_lib, bytes_ms=f_bytes, ops_ms=f_ops))
        bwd.append(dict(common, weight=bwd_w,
                        max_abs_err=max(g[0] for g in gerrs), ms=b_ms,
                        parent_ms=pb_ms, device_ms=dev["bwd"],
                        parent_device_ms=pdev["bwd"], plain_ms=b_plain,
                        library_ms=b_lib,
                        bytes_ms=b_bytes, ops_ms=b_ops,
                        plan=dataclasses.asdict(fa._full_block_f32_plan(d))))
        # dO and O read, l read, delta and 1/l written; 2 B H Sq D fp32 ops
        fdelta.append(dict(common, weight=bwd_w, max_abs_err=derr, ms=d_ms,
                           plain_ms=d_plain, library_ms=d_lib,
                           bytes_ms=(2 * b * h * sq * d + 3 * b * h * sq)
                           * 4 / PEAK_HBM_BYTES * 1e3,
                           ops_ms=2 * b * h * sq * d / PEAK_FP32_FLOPS * 1e3))
        _log(f"  full_block fp32 {label} {shape} Sk {kv[2]}: max|err| out "
             f"{err:.3g} qknorm {qerr:.3g} dq/dk/dv "
             f"{', '.join(f'{g[0]:.3g}' for g in gerrs)} delta {derr:.3g}; "
             f"forward {ms:.4f} ms (parent {p_ms}, plain "
             f"{plain_ms:.4f}, sdpa fp32 {lib_ms:.4f}, bound "
             f"{max(f_bytes, f_ops):.4f}); qknorm {q_ms:.4f} ms (parent "
             f"{pq_ms}, plain {q_plain:.4f}, layer_norm + sdpa "
             f"{q_lib:.4f}); backward {b_ms:.4f} ms (parent {pb_ms}) with "
             f"delta {d_ms:.4f} (vecdot {d_lib:.4f}; plain "
             f"{b_plain:.4f}, sdpa fp32 bwd {b_lib:.4f}, bound "
             f"{max(b_bytes, b_ops):.4f}); device time forward / qknorm "
             f"/ backward with delta "
             f"{' / '.join(_ms_or_none(dev[n]) for n in calls)} ms "
             f"(parent {' / '.join(_ms_or_none(pdev[n]) for n in calls)})")

    dq_cases, dkv_cases, sdelta = [], [], []
    for label, shape, weight, masked in [
            ("SD-VAE decoder mid-block, perceptual leg (N=1)",
             (16, 1, 1024, 512), 1, False)] + [
            (lab, shape, 0, masked) for lab, shape, masked in
            STREAM_BWD_CHECKS]:
        q, k, v, do = (rand(shape) for _ in range(4))
        scale = shape[3] ** -0.5
        bias = None
        if masked:
            bias = masked_bias(shape[0], shape[2], False)
            bias[:, STREAM_MASKED_KEYS] = -1e30
        kw = dict(scale=scale, bias=bias)
        out, lse = fa.stream_attention(q, k, v, **kw)
        delta = fa.stream_attention_delta(do, out)
        dq = fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        again = (fa.stream_attention_delta(do, out),
                 fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
        want = fa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
        dwant = fa._delta(do, out)
        torch.cuda.synchronize()
        gerrs = [_f32_gate(g, w) for g, w in zip((dq, dk, dv), want)]
        derr, dok = _f32_gate(delta, dwant)
        finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
        if not (finite and dok and all(g[1] for g in gerrs)):
            failures.append(f"stream_bwd fp32 {label} {shape}: max|err| "
                            f"dq/dk/dv {[g[0] for g in gerrs]} delta {derr} "
                            f"finite {finite}")
        if not all(torch.equal(a, b) for a, b in
                   zip((delta, dq, dk, dv), again)):
            failures.append(f"stream_bwd fp32 {label}: two launches differ")
        if parent is not None and not all(
                torch.equal(a, b) for a, b in zip(
                    (delta, dq, dk, dv),
                    (parent.stream_attention_delta(do, out),
                     parent.stream_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    **kw),
                     *parent.stream_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, **kw)))):
            failures.append(f"stream_bwd fp32 {label}: the parent's delta, "
                            f"dq or dk/dv gives other bits")
        if bias is not None and max(
                dk[:, :, STREAM_MASKED_KEYS].abs().max().item(),
                dv[:, :, STREAM_MASKED_KEYS].abs().max().item()) != 0:
            failures.append(f"stream_bwd fp32 {label}: a fully masked key "
                            f"block got a gradient")
        mask = None if bias is None else bias[:, None, None, :]
        dq_ms = _time_ms(lambda: fa.stream_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw), 10)
        dkv_ms = _time_ms(lambda: fa.stream_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw), 10)
        parent_dq = parent_dkv = None
        if parent is not None:
            parent_dq = _time_ms(lambda: parent.stream_attention_bwd_dq(
                q, k, v, do, lse, delta, **kw), 10)
            parent_dkv = _time_ms(lambda: parent.stream_attention_bwd_dkv(
                q, k, v, do, lse, delta, **kw), 10)
        d_ms = _time_ms(lambda: fa.stream_attention_delta(do, out), 20)
        d_plain = _time_ms(lambda: fa._delta(do, out), 20)
        d_lib = _time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1), 20)
        plain_ms = _time_ms(lambda: fa.stream_attention_bwd_plain(
            q, k, v, do, out, lse, **kw), 3)
        lib_ms = _library_bwd_ms(q, k, v, do, mask, scale, 10)
        plan = fa._stream_bwd_f32_plan(shape[3])
        b, h, sq, d = shape
        common = dict(label=label, shape=list(shape), weight=weight,
                      plain_ms=plain_ms, library_ms=lib_ms)
        q_bytes, q_ops = _bound(shape, masked, True, tensors=5, stats=1,
                                flop_factor=18, elem_bytes=4,
                                peak=PEAK_TF32_FLOPS)
        k_bytes, k_ops = _bound(shape, masked, True, tensors=6, stats=1,
                                flop_factor=24, elem_bytes=4,
                                peak=PEAK_TF32_FLOPS)
        # clusters of `cluster` CTAs (1 below D 512), one CTA a SM
        clusters = {n: -(-sq // p.rows) * b * h for n, p in
                    (("dq", plan.dq), ("dkv", plan.dkv))}
        ctas = {n: clusters[n] * p.cluster for n, p in
                (("dq", plan.dq), ("dkv", plan.dkv))}
        dq_cases.append(dict(common, max_abs_err=gerrs[0][0], ms=dq_ms,
                             parent_ms=parent_dq, bytes_ms=q_bytes,
                             ops_ms=q_ops, plan=dataclasses.asdict(plan.dq),
                             clusters=clusters["dq"], ctas=ctas["dq"],
                             waves=ctas["dq"] / sms))
        dkv_cases.append(dict(common, max_abs_err=max(g[0] for g in
                                                      gerrs[1:]),
                              ms=dkv_ms, parent_ms=parent_dkv,
                              bytes_ms=k_bytes, ops_ms=k_ops,
                              plan=dataclasses.asdict(plan.dkv),
                              clusters=clusters["dkv"], ctas=ctas["dkv"],
                              waves=ctas["dkv"] / sms))
        sdelta.append(dict(label=label, shape=list(shape), weight=weight,
                           max_abs_err=derr, ms=d_ms, plain_ms=d_plain,
                           library_ms=d_lib,
                           bytes_ms=(2 * b * h * sq * d + b * h * sq) * 4
                           / PEAK_HBM_BYTES * 1e3,
                           ops_ms=2 * b * h * sq * d / PEAK_FP32_FLOPS * 1e3))
        _log(f"  stream_bwd fp32 {label} {shape}: max|err| dq/dk/dv "
             f"{', '.join(f'{g[0]:.3g}' for g in gerrs)} delta {derr:.3g}; "
             f"dq {dq_ms:.4f} ms (parent {parent_dq}, bound "
             f"{max(q_bytes, q_ops):.4f}, {plan.dq.rows} rows, "
             f"{plan.dq.tile}-row tiles, {ctas['dq']} CTAs in "
             f"{clusters['dq']} clusters) dkv {dkv_ms:.4f} ms (parent "
             f"{parent_dkv}, bound {max(k_bytes, k_ops):.4f}, "
             f"{plan.dkv.rows} rows, {plan.dkv.tile}-row tiles, "
             f"{ctas['dkv']} CTAs in {clusters['dkv']} clusters) delta "
             f"{d_ms:.4f} ms (plain {d_plain:.4f}, vecdot {d_lib:.4f}); sum "
             f"{dq_ms + dkv_ms + d_ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"sdpa fp32 bwd {lib_ms:.4f} ms")

    src = "hivae_tpu_torch/csrc/"
    tpu = "hivae_tpu/ops/pallas/flash_attention.py:"

    def record(name, source, line, cases):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": tpu + line, "cases": cases}
    bwd_rec = record("full_block_attention_bwd_f32", "flash_full_block_bwd.cu",
                     "188", bwd)
    bwd_rec["delta"] = record("full_block_attention_delta_f32",
                              "flash_full_block_bwd.cu", "188", fdelta)
    dq_rec = record("stream_attention_bwd_dq_f32", "flash_stream_bwd.cu",
                    "512", dq_cases)
    dq_rec["delta"] = record("stream_attention_delta_f32",
                             "flash_stream_bwd.cu", "512", sdelta)
    return [record("full_block_attention_f32", "flash_full_block.cu", "167",
                   fwd),
            record("full_block_attention_qknorm_f32", "flash_full_block.cu",
                   "140", qkn),
            bwd_rec, dq_rec,
            record("stream_attention_bwd_dkv_f32", "flash_stream_bwd.cu",
                   "552", dkv_cases)]


# the fp16 forms' cases (label, q shape, weight: launches on the path the
# record's time averages over): the forward and its qk-norm variant at the
# fp16 clip's sites (phase 3w), the full-block backward and delta at the
# fp16 step's (phase 5d: N 2 at PAR_DEPTH, one launch a site), the
# streaming forward at the clip's SD-VAE mid-block and its backward at
# the perceptual step's decode (N 1)
F16_FWD_CASES = FULL_BLOCK_CASES
F16_BWD_CASES = [(label, shape, 1) for label, shape, _ in
                 full_block_bwd_cases(2)]
F16_STREAM_CASES = STREAM_CASES
F16_STREAM_BWD_CASES = [("SD-VAE decoder mid-block, perceptual leg (N=1)",
                         (16, 1, 1024, 512), 1)]


def check_f16_kernels(fa, failures):
    """Phase 2, the fp16 forms (the 16-bit sources built with -DHV_F16):
    the full-block forward, its qk-norm variant, backward and delta, the
    streaming forward, delta, dQ and dK/dV on fp16 operands at the fp16
    paths' shapes, each against its plain version on the same inputs
    (``KERNEL_ATOL`` on outputs, ``BWD_RTOL`` relative on gradients,
    ``DELTA_RTOL`` on delta, ``LSE_ATOL`` on the LSE), launched twice to the
    same bits, and timed beside its plain version and SDPA in fp16; the
    bound is its bf16-rate (fp16's is the same, 989 TFLOP/s) operations or
    its fp16 bytes. Beside each, the device time (``_device_ms``) of the
    fp16 form and of its bf16 sibling on the same values in bf16
    (``device_ms``, ``bf16_device_ms``): CUDA events at these grids time
    the launch path too. Returns the records."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").half()

    fwd, qkn, bwd, fdelta = [], [], [], []
    for label, shape, weight in F16_FWD_CASES:
        q, k, v = rand(shape), rand(shape), rand(shape)
        scale = shape[3] ** -0.5
        norms = _norm_params(gen, shape[3])
        kw = dict(scale=scale, bias=None)
        got = [fa.full_block_attention(q, k, v, **kw) for _ in range(2)]
        qn = [fa.full_block_attention_qknorm(q, k, v, *norms, **kw)
              for _ in range(2)]
        want = fa.full_block_attention_plain(q, k, v, **kw)
        qwant = fa.full_block_attention_qknorm_plain(q, k, v, *norms, **kw)
        torch.cuda.synchronize()
        err, qerr = _abs_err(got[0], want), _abs_err(qn[0], qwant)
        if not (err <= KERNEL_ATOL and qerr <= KERNEL_ATOL and
                torch.equal(*got) and torch.equal(*qn) and
                bool(torch.isfinite(got[0]).all())):
            failures.append(f"full_block fp16 {label}: max|err| {err} "
                            f"qknorm {qerr}, bits equal "
                            f"{torch.equal(*got)} {torch.equal(*qn)}")
        f_bytes, f_ops = _bound(shape, False, False, stats=0)

        def ln_sdpa():
            d = shape[3]
            qq = F.layer_norm(q, (d,), norms[0].half(), norms[1].half(), 1e-6)
            kk = F.layer_norm(k, (d,), norms[2].half(), norms[3].half(), 1e-6)
            return F.scaled_dot_product_attention(qq, kk, v, scale=scale)
        common = dict(label=label, shape=list(shape), weight=weight,
                      bytes_ms=f_bytes, ops_ms=f_ops)
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        dev = {"fwd": _device_ms(lambda: fa.full_block_attention(
                   q, k, v, **kw), "full_block"),
               "fwd_bf16": _device_ms(lambda: fa.full_block_attention(
                   qb, kb, vb, **kw), "full_block"),
               "qkn": _device_ms(lambda: fa.full_block_attention_qknorm(
                   q, k, v, *norms, **kw), "full_block"),
               "qkn_bf16": _device_ms(lambda: fa.full_block_attention_qknorm(
                   qb, kb, vb, *norms, **kw), "full_block")}
        fwd.append(dict(common, max_abs_err=err, device_ms=dev["fwd"],
                        bf16_device_ms=dev["fwd_bf16"], ms=_time_ms(
            lambda: fa.full_block_attention(q, k, v, **kw), 20),
            plain_ms=_time_ms(lambda: fa.full_block_attention_plain(
                q, k, v, **kw), 5),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), 20)))
        qkn.append(dict(common, max_abs_err=qerr, device_ms=dev["qkn"],
                        bf16_device_ms=dev["qkn_bf16"], ms=_time_ms(
            lambda: fa.full_block_attention_qknorm(q, k, v, *norms, **kw),
            20), plain_ms=_time_ms(
                lambda: fa.full_block_attention_qknorm_plain(
                    q, k, v, *norms, **kw), 5),
            library_ms=_time_ms(ln_sdpa, 20)))
        _log(f"  full_block fp16 {label} {shape}: max|err| {err:.3g} "
             f"qknorm {qerr:.3g}; forward {fwd[-1]['ms']:.4f} ms (plain "
             f"{fwd[-1]['plain_ms']:.4f}, sdpa fp16 "
             f"{fwd[-1]['library_ms']:.4f}, bound "
             f"{max(f_bytes, f_ops):.4f}); qknorm {qkn[-1]['ms']:.4f} ms "
             f"(plain {qkn[-1]['plain_ms']:.4f}, layer_norm + sdpa "
             f"{qkn[-1]['library_ms']:.4f}); device time fp16 / bf16: "
             f"forward {_ms_or_none(dev['fwd'])} / "
             f"{_ms_or_none(dev['fwd_bf16'])}, qknorm "
             f"{_ms_or_none(dev['qkn'])} / {_ms_or_none(dev['qkn_bf16'])} "
             f"ms")

    for label, shape, weight in F16_BWD_CASES:
        q, k, v, do = (rand(shape) for _ in range(4))
        scale = shape[3] ** -0.5
        kw = dict(scale=scale, bias=None)
        out, m, l = fa._full_block_fwd(q, k, v, None, scale, stats=True)
        grads = [fa.full_block_attention_bwd(q, k, v, do, out, m, l, **kw)
                 for _ in range(2)]
        deltas = [fa.full_block_attention_delta(do, out, l)
                  for _ in range(2)]
        gwant = fa.full_block_attention_bwd_plain(q, k, v, do, **kw)
        dwant, ilwant = fa.full_block_attention_delta_plain(do, out, l)
        torch.cuda.synchronize()
        gerrs = [_grad_gate(g, w) for g, w in zip(grads[0], gwant)]
        dscale = (do.float().abs() * out.float().abs()).sum(-1)
        dok = bool(((deltas[0][0] - dwant).abs()
                    <= DELTA_RTOL * dscale + 1e-6).all())
        derr = _abs_err(deltas[0][0], dwant)
        if not (all(ok for _, ok in gerrs) and dok and
                torch.equal(deltas[0][1], ilwant) and
                all(torch.equal(a, b) for a, b in zip(*grads)) and
                all(torch.equal(a, b) for a, b in zip(*deltas))):
            failures.append(f"full_block_bwd fp16 {label}: dq/dk/dv "
                            f"{[e for e, _ in gerrs]}, delta {derr}, bits "
                            f"equal or 1/l off")
        b_bytes, b_ops = _bound(shape, False, False, tensors=7, stats=3,
                                flop_factor=10)
        b_ms = _time_ms(lambda: fa.full_block_attention_bwd(
            q, k, v, do, out, m, l, **kw), 20)
        b_plain = _time_ms(lambda: fa.full_block_attention_bwd_plain(
            q, k, v, do, **kw), 5)
        b_lib = _library_bwd_ms(q, k, v, do, None, scale, 20)
        qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
        ob, mb, lb = fa._full_block_fwd(qb, kb, vb, None, scale, stats=True)
        b_dev = _device_ms(lambda: fa.full_block_attention_bwd(
            q, k, v, do, out, m, l, **kw), "full_block")
        b_dev_bf16 = _device_ms(lambda: fa.full_block_attention_bwd(
            qb, kb, vb, dob, ob, mb, lb, **kw), "full_block")
        d_ms = _time_ms(lambda: fa.full_block_attention_delta(do, out, l),
                        20)
        d_plain = _time_ms(lambda: fa.full_block_attention_delta_plain(
            do, out, l), 20)
        d_lib = _time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1), 20)
        b, h, sq, d = shape
        bwd.append(dict(label=label, shape=list(shape), weight=weight,
                        max_abs_err=max(e for e, _ in gerrs), ms=b_ms,
                        device_ms=b_dev, bf16_device_ms=b_dev_bf16,
                        plain_ms=b_plain, library_ms=b_lib,
                        bytes_ms=b_bytes, ops_ms=b_ops))
        fdelta.append(dict(label=label, shape=list(shape), weight=weight,
                           max_abs_err=derr, ms=d_ms, plain_ms=d_plain,
                           library_ms=d_lib,
                           bytes_ms=(2 * b * h * sq * d * 2 + 3 * b * h * sq
                                     * 4) / PEAK_HBM_BYTES * 1e3,
                           ops_ms=2 * b * h * sq * d / PEAK_FP32_FLOPS
                           * 1e3))
        _log(f"  full_block_bwd fp16 {label} {shape}: max|err| dq/dk/dv "
             f"{', '.join(f'{e:.3g}' for e, _ in gerrs)} delta {derr:.3g}; "
             f"backward {b_ms:.4f} ms (plain {b_plain:.4f}, sdpa fp16 bwd "
             f"{b_lib:.4f}, bound {max(b_bytes, b_ops):.4f}); delta "
             f"{d_ms:.4f} ms (plain {d_plain:.4f}, vecdot {d_lib:.4f}); "
             f"device time with delta fp16 / bf16 {_ms_or_none(b_dev)} / "
             f"{_ms_or_none(b_dev_bf16)} ms")

    sfwd, dq_cases, dkv_cases, sdelta = [], [], [], []
    for label, shape, weight in F16_STREAM_CASES:
        q, k, v = rand(shape), rand(shape), rand(shape)
        scale = shape[3] ** -0.5
        runs = [fa.stream_attention(q, k, v, scale=scale) for _ in range(2)]
        wo, wl = fa.stream_attention_plain(q, k, v, scale=scale)
        torch.cuda.synchronize()
        err, lerr = _abs_err(runs[0][0], wo), _abs_err(runs[0][1], wl)
        if not (err <= KERNEL_ATOL and lerr <= LSE_ATOL and
                all(torch.equal(a, b) for a, b in zip(*runs))):
            failures.append(f"stream fp16 {label}: max|err| {err} lse "
                            f"{lerr}")
        f_bytes, f_ops = _bound(shape, False, True)
        sfwd.append(dict(label=label, shape=list(shape), weight=weight,
                         max_abs_err=err, ms=_time_ms(
                             lambda: fa.stream_attention(q, k, v,
                                                         scale=scale), 10),
                         plain_ms=_time_ms(lambda: fa.stream_attention_plain(
                             q, k, v, scale=scale), 3),
                         library_ms=_time_ms(
                             lambda: F.scaled_dot_product_attention(
                                 q, k, v, scale=scale), 10),
                         bytes_ms=f_bytes, ops_ms=f_ops))
        _log(f"  stream fp16 {label} {shape}: max|err| {err:.3g} lse "
             f"{lerr:.3g}; {sfwd[-1]['ms']:.4f} ms (plain "
             f"{sfwd[-1]['plain_ms']:.4f}, sdpa fp16 "
             f"{sfwd[-1]['library_ms']:.4f}, bound "
             f"{max(f_bytes, f_ops):.4f})")

    for label, shape, weight in F16_STREAM_BWD_CASES:
        q, k, v, do = (rand(shape) for _ in range(4))
        scale = shape[3] ** -0.5
        kw = dict(scale=scale, bias=None)
        out, lse = fa.stream_attention(q, k, v, **kw)
        runs = []
        for _ in range(2):
            delta = fa.stream_attention_delta(do, out)
            runs.append((delta,
                         fa.stream_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    **kw),
                         *fa.stream_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, **kw)))
        want = fa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
        dwant = fa._delta(do, out)
        torch.cuda.synchronize()
        gerrs = [_grad_gate(g, w) for g, w in zip(runs[0][1:], want)]
        dscale = (do.float().abs() * out.float().abs()).sum(-1)
        derr = _abs_err(runs[0][0], dwant)
        dok = bool(((runs[0][0] - dwant).abs()
                    <= DELTA_RTOL * dscale + 1e-6).all())
        if not (dok and all(ok for _, ok in gerrs) and
                all(torch.equal(a, b) for a, b in zip(*runs))):
            failures.append(f"stream_bwd fp16 {label}: dq/dk/dv "
                            f"{[e for e, _ in gerrs]} delta {derr}")
        delta = runs[0][0]
        dq_ms = _time_ms(lambda: fa.stream_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw), 10)
        dkv_ms = _time_ms(lambda: fa.stream_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw), 10)
        d_ms = _time_ms(lambda: fa.stream_attention_delta(do, out), 20)
        d_plain = _time_ms(lambda: fa._delta(do, out), 20)
        d_lib = _time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1), 20)
        plain_ms = _time_ms(lambda: fa.stream_attention_bwd_plain(
            q, k, v, do, out, lse, **kw), 3)
        lib_ms = _library_bwd_ms(q, k, v, do, None, scale, 10)
        q_bytes, q_ops = _bound(shape, False, True, tensors=5, stats=1,
                                flop_factor=6)
        k_bytes, k_ops = _bound(shape, False, True, tensors=6, stats=1,
                                flop_factor=8)
        b, h, sq, d = shape
        common = dict(label=label, shape=list(shape), weight=weight,
                      plain_ms=plain_ms, library_ms=lib_ms)
        dq_cases.append(dict(common, max_abs_err=gerrs[0][0], ms=dq_ms,
                             bytes_ms=q_bytes, ops_ms=q_ops))
        dkv_cases.append(dict(common, max_abs_err=max(e for e, _ in
                                                      gerrs[1:]),
                              ms=dkv_ms, bytes_ms=k_bytes, ops_ms=k_ops))
        sdelta.append(dict(label=label, shape=list(shape), weight=weight,
                           max_abs_err=derr, ms=d_ms, plain_ms=d_plain,
                           library_ms=d_lib,
                           bytes_ms=(2 * b * h * sq * d * 2 + b * h * sq * 4)
                           / PEAK_HBM_BYTES * 1e3,
                           ops_ms=2 * b * h * sq * d / PEAK_FP32_FLOPS
                           * 1e3))
        _log(f"  stream_bwd fp16 {label} {shape}: max|err| dq/dk/dv "
             f"{', '.join(f'{e:.3g}' for e, _ in gerrs)} delta {derr:.3g}; "
             f"dq {dq_ms:.4f} ms (bound {max(q_bytes, q_ops):.4f}) dkv "
             f"{dkv_ms:.4f} ms (bound {max(k_bytes, k_ops):.4f}) delta "
             f"{d_ms:.4f} ms (plain {d_plain:.4f}, vecdot {d_lib:.4f}); "
             f"plain {plain_ms:.4f} ms, sdpa fp16 bwd {lib_ms:.4f} ms")

    src = "hivae_tpu_torch/csrc/"
    tpu = "hivae_tpu/ops/pallas/flash_attention.py:"

    def record(name, source, line, cases):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": tpu + line, "cases": cases}
    bwd_rec = record("full_block_attention_bwd_f16", "flash_full_block_bwd.cu",
                     "188", bwd)
    bwd_rec["delta"] = record("full_block_attention_delta_f16",
                              "flash_full_block_bwd.cu", "188", fdelta)
    dq_rec = record("stream_attention_bwd_dq_f16", "flash_stream_bwd.cu",
                    "512", dq_cases)
    dq_rec["delta"] = record("stream_attention_delta_f16",
                             "flash_stream_bwd.cu", "512", sdelta)
    return [record("full_block_attention_f16", "flash_full_block.cu", "167",
                   fwd),
            record("full_block_attention_qknorm_f16", "flash_full_block.cu",
                   "140", qkn),
            bwd_rec,
            record("stream_attention_f16", "flash_stream.cu", "468", sfwd),
            dq_rec,
            record("stream_attention_bwd_dkv_f16", "flash_stream_bwd.cu",
                   "552", dkv_cases)]


# phase 2c: head dims off the kernels' tiles (each on the smallest tile >=
# it) beside the tiles themselves, each through ``sdpa`` forward and with
# a gradient in bf16, fp16 and fp32, at a full-block shape (masked and
# not; the streaming kernels past D 128) and a streaming one; the fused
# qk-norm route at two of them; D 2056, past every tile, counted plain
HEAD_DIMS_ODD = (8, 24, 40, 72, 80, 136, 200, 320, 600)
HEAD_DIMS_TILES = (32, 64, 96, 128, 256, 512, 640)
HEAD_DIM_QKNORM = (40, 72)
HEAD_DIM_PLAIN = 2056


def check_head_dims(failures):
    """Phase 2c. ``sdpa`` at every head dim of ``HEAD_DIMS_ODD`` and
    ``HEAD_DIMS_TILES``, in bf16, fp16 and fp32, forward and with a
    gradient, at (2, 4, 300, D) masked and not (the full-block kernels to D
    128, the streaming ones beyond) and (2, 1, 2048, D) (the streaming
    kernels): the route and exact launches on the dtype's counters
    (forward; with a gradient forward, delta and backward), ``sdpa_plain``
    0, the same bits twice, the output within ``KERNEL_ATOL`` (bf16, fp16)
    or ``KERNEL_F32_ATOL`` x max(1, max|plain|) (fp32) of the plain path's
    and the gradients within ``_grad_gate``; the fused qk-norm route at D
    ``HEAD_DIM_QKNORM``; D 72 on the 96 tile and D 600 on the 640 tile
    timed against the tile's own D (bf16, forward and backward, CUDA
    events and device time); and one call at ``HEAD_DIM_PLAIN`` (2056),
    which no kernel takes, counted once in ``sdpa_plain``. Returns the
    calls checked."""
    import torch
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    calls = 0

    def run(fn, q, k, v, mask, do):
        out = fn(q, k, v, mask)
        if do is None:
            return (out,)
        return (out,) + torch.autograd.grad(out, (q, k, v), do)

    def sdpa(q, k, v, mask):
        return attn_ops.sdpa(q, k, v, key_mask=mask)

    def plain(q, k, v, mask):
        return attn_ops._sdpa_plain(q, k, v, q.shape[3] ** -0.5, mask)

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        sx = DTYPE_SUFFIX[str(dtype)]
        worst, worst_g = 0.0, 0.0
        for d in HEAD_DIMS_ODD + HEAD_DIMS_TILES:
            for shape, masked in (((2, 4, 300, d), False),
                                  ((2, 4, 300, d), True),
                                  ((2, 1, 2048, d), False)):
                for grad in (False, True):
                    q, k, v = (torch.randn(shape, generator=gen,
                                           device="cuda").to(dtype)
                               .requires_grad_(grad) for _ in range(3))
                    mask = None
                    if masked:
                        mask = torch.rand((shape[0], shape[2]), generator=gen,
                                          device="cuda") > 0.3
                        mask[:, 0] = True
                    route = attn_ops.kernel_route(q, k, v)
                    want_route = "full_block" if (
                        attn_ops.full_block_fits(shape, shape) and d <= 128
                    ) else "stream"
                    do = torch.randn(shape, generator=gen,
                                     device="cuda").to(dtype) if grad \
                        else None
                    _zero_counts()
                    got = run(sdpa, q, k, v, mask, do)
                    counts = {n: c for n, c in _read_counts().items() if c}
                    again = run(sdpa, q, k, v, mask, do)
                    ref = [x.detach().clone().requires_grad_(grad)
                           for x in (q, k, v)]
                    want = run(plain, *ref, mask, do)
                    torch.cuda.synchronize()
                    if route == "stream":
                        names = ["stream_attention"] + (
                            ["stream_attention_delta",
                             "stream_attention_bwd_dq",
                             "stream_attention_bwd_dkv"] if grad else [])
                    else:
                        names = ["full_block_attention"] + (
                            ["full_block_attention_delta",
                             "full_block_attention_bwd"] if grad else [])
                    want_counts = {n + sx: 1 for n in names}
                    out_err = _abs_err(got[0].detach(), want[0].detach())
                    out_ok = out_err <= (
                        KERNEL_F32_ATOL * max(1.0, want[0].abs().max().item())
                        if dtype == torch.float32 else KERNEL_ATOL)
                    gerr = [_grad_gate(g, w) for g, w in zip(got[1:],
                                                             want[1:])]
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    finite = all(bool(torch.isfinite(x).all()) for x in got)
                    worst = max(worst, out_err)
                    worst_g = max([worst_g] + [e for e, _ in gerr])
                    calls += 1
                    if not (route == want_route and counts == want_counts
                            and out_ok and all(ok for _, ok in gerr) and same
                            and finite):
                        failures.append(
                            f"head dim {d} {dtype} {shape} masked {masked} "
                            f"grad {grad}: route {route} (want "
                            f"{want_route}), launches {counts} (want "
                            f"{want_counts}), max|err| {out_err}, gradients "
                            f"{[e for e, _ in gerr]}, same bits {same}, "
                            f"finite {finite}")
        for d in HEAD_DIM_QKNORM:
            shape = (2, 4, 300, d)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            norms = _norm_params(gen, d)
            attn_ops.QKNORM_FUSE = True
            try:
                _zero_counts()
                got = attn_ops.sdpa(q, k, v, qk_norm=norms)
                counts = {n: c for n, c in _read_counts().items() if c}
                again = attn_ops.sdpa(q, k, v, qk_norm=norms)
            finally:
                attn_ops.QKNORM_FUSE = False
            want = fa.full_block_attention_qknorm_plain(
                q, k, v, *norms, scale=d ** -0.5)
            torch.cuda.synchronize()
            err = _abs_err(got, want)
            ok = err <= (KERNEL_F32_ATOL * max(1.0, want.abs().max().item())
                         if dtype == torch.float32 else KERNEL_ATOL)
            calls += 1
            if not (ok and torch.equal(got, again) and counts == {
                    f"full_block_attention_qknorm{sx}": 1}):
                failures.append(f"head dim {d} {dtype} qk-norm: launches "
                                f"{counts}, max|err| {err}")
        _log(f"  head dims {dtype}: {len(HEAD_DIMS_ODD + HEAD_DIMS_TILES)} "
             f"dims x 3 shapes x (forward, gradient) and qk-norm at "
             f"{HEAD_DIM_QKNORM}: worst max|err| output {worst:.3g}, "
             f"gradients {worst_g:.3g}")

    # an odd head dim against its tile's own: the full-block forward and
    # backward (delta included) at the DiT's object joint site, the
    # streaming forward and backward at the SD-VAE mid-block's, in bf16
    for kind, base, pairs in (("full_block", (16, 16, 266), (72, 96)),
                              ("stream", (16, 1, 1024), (600, 640))):
        times = {}
        for d in pairs:
            q, k, v, do = (torch.randn(base + (d,), generator=gen,
                                       device="cuda").bfloat16()
                           for _ in range(4))
            kw = dict(scale=d ** -0.5)
            if kind == "full_block":
                out, m, l = fa._full_block_fwd(q, k, v, None, kw["scale"],
                                               stats=True)
                fns = (lambda: fa.full_block_attention(q, k, v, **kw),
                       lambda: fa.full_block_attention_bwd(
                           q, k, v, do, out, m, l, **kw))
            else:
                out, lse = fa.stream_attention(q, k, v, **kw)
                delta = fa.stream_attention_delta(do, out)

                def bwd():
                    fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
                    fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                **kw)
                fns = (lambda: fa.stream_attention(q, k, v, **kw), bwd)
            times[d] = [(_time_ms(f, 20), _device_ms(f, kind.split("_")[0]))
                        for f in fns]
        _log(f"  {kind} bf16 at {base} + (D,), D "
             f"{pairs[0]} on the {pairs[1]} tile against D {pairs[1]}: "
             + "; ".join(
                 f"{name} {times[pairs[0]][i][0]:.4f} / "
                 f"{times[pairs[1]][i][0]:.4f} ms (device "
                 f"{_ms_or_none(times[pairs[0]][i][1])} / "
                 f"{_ms_or_none(times[pairs[1]][i][1])})"
                 for i, name in enumerate(("forward", "backward"))))

    shape = (2, 4, 300, HEAD_DIM_PLAIN)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").half()
               for _ in range(3))
    _zero_counts()
    got = attn_ops.sdpa(q, k, v)
    counts = {n: c for n, c in _read_counts().items() if c}
    err = _abs_err(got, attn_ops._sdpa_plain(q, k, v, shape[3] ** -0.5,
                                             None))
    calls += 1
    _log(f"  D {HEAD_DIM_PLAIN} fp16 {shape}: route "
         f"{attn_ops.kernel_route(q, k, v)}, launches {counts}, max|err| "
         f"{err:.3g}")
    if counts != {"sdpa_plain": 1} or err != 0:
        failures.append(f"D {HEAD_DIM_PLAIN}: launches {counts}, err {err}")
    return calls


# phase 2d: the wide streaming kernels (tiles 768 to 2048, a cluster of
# tile / 256 CTAs along D) through ``sdpa``: head dims on and off their
# tiles at phase 2c's shapes; the keyless row's gradient under both rules;
# a model block at 1024 channels; times at two shapes
HEAD_DIMS_WIDE = (648, 776, 1024, 1288, 1536, 2048)
WIDE_KEYLESS = ((2, 2, 272, 136), (2, 2, 300, 512), (2, 2, 300, 1024),
                (1, 1, 2048, 136))
WIDE_BLOCK = (2, 1024, 32, 32)      # AttentionBlock2D: N, C, H, W
WIDE_TIMED = ((4, 1, 1024, 1024), (4, 1, 1024, 2048))
WIDE_NAMES = ("stream_attention", "stream_attention_delta",
              "stream_attention_bwd_dq", "stream_attention_bwd_dkv")


def _sdpa_backend(q, k, v, scale):
    """The backend ``F.scaled_dot_product_attention`` picks for these
    operands (``torch._fused_sdp_choice``)."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=scale)).name


def _wide_sweep(failures, rand, gen):
    """Phase 2d's ``sdpa`` sweep (``check_wide_head_dims``): returns its
    launches."""
    import torch
    from hivae_tpu_torch.ops import attention as attn_ops

    def run(fn, q, k, v, mask, do):
        out = fn(q, k, v, mask)
        if do is None:
            return (out,)
        return (out,) + torch.autograd.grad(out, (q, k, v), do)

    def sdpa(q, k, v, mask):
        return attn_ops.sdpa(q, k, v, key_mask=mask)

    def plain(q, k, v, mask):
        return attn_ops._sdpa_plain(q, k, v, q.shape[3] ** -0.5, mask)

    sweep = _no_launches()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        sx = DTYPE_SUFFIX[str(dtype)]
        worst, worst_g = 0.0, 0.0
        for d in HEAD_DIMS_WIDE:
            for shape, masked in (((2, 2, 300, d), False),
                                  ((2, 2, 300, d), True),
                                  ((2, 1, 1024, d), False)):
                for grad in (False, True):
                    q, k, v = (rand(shape, dtype).requires_grad_(grad)
                               for _ in range(3))
                    mask = None
                    if masked:
                        mask = torch.rand((shape[0], shape[2]), generator=gen,
                                          device="cuda") > 0.3
                        mask[:, 0] = True
                    do = rand(shape, dtype) if grad else None
                    route = attn_ops.kernel_route(q, k, v)
                    _zero_counts()
                    got = run(sdpa, q, k, v, mask, do)
                    counts = {n: c for n, c in _read_counts().items() if c}
                    for n, c in counts.items():
                        sweep[n] += c
                    again = run(sdpa, q, k, v, mask, do)
                    ref = [x.detach().clone().requires_grad_(grad)
                           for x in (q, k, v)]
                    want = run(plain, *ref, mask, do)
                    torch.cuda.synchronize()
                    names = WIDE_NAMES if grad else WIDE_NAMES[:1]
                    want_counts = {f"{n}_wide{sx}": 1 for n in names}
                    out_err = _abs_err(got[0].detach(), want[0].detach())
                    out_ok = out_err <= (
                        KERNEL_F32_ATOL * max(1.0, want[0].abs().max().item())
                        if dtype == torch.float32 else KERNEL_ATOL)
                    gerr = [_grad_gate(g, w) for g, w in zip(got[1:],
                                                             want[1:])]
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    finite = all(bool(torch.isfinite(x).all()) for x in got)
                    worst = max(worst, out_err)
                    worst_g = max([worst_g] + [e for e, _ in gerr])
                    if not (route == "stream" and counts == want_counts
                            and out_ok and all(ok for _, ok in gerr) and same
                            and finite):
                        failures.append(
                            f"wide head dim {d} {dtype} {shape} masked "
                            f"{masked} grad {grad}: route {route}, launches "
                            f"{counts} (want {want_counts}), max|err| "
                            f"{out_err}, gradients {[e for e, _ in gerr]}, "
                            f"same bits {same}, finite {finite}")
        _log(f"  wide head dims {dtype}: {HEAD_DIMS_WIDE} x 3 shapes x "
             f"(forward, gradient): worst max|err| output {worst:.3g}, "
             f"gradients {worst_g:.3g}")
    return sweep


def _wide_keyless(failures, rand, gen):
    """Phase 2d's keyless rows (``check_wide_head_dims``)."""
    import torch
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.ops.kernels import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for shape in WIDE_KEYLESS:
            q, k, v = (rand(shape, dtype).requires_grad_() for _ in range(3))
            do = rand(shape, dtype)
            mask = torch.rand((shape[0], shape[2]), generator=gen,
                              device="cuda") > 0.3
            mask[0] = False
            full = attn_ops.full_block_fits(shape, shape)
            got = attn_ops.sdpa(q, k, v, key_mask=mask,
                                implementation="pallas")
            grads = torch.autograd.grad(got, (q, k, v), do)
            bias = torch.zeros(mask.shape, device="cuda").masked_fill(
                ~mask, attn_ops.MASK_NEG)
            kw = dict(scale=shape[3] ** -0.5, bias=bias)
            if full:
                ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
                wgrads = torch.autograd.grad(
                    fa.full_block_attention_plain(*ref, **kw), ref, do)
            else:
                qd, kd, vd = (x.detach() for x in (q, k, v))
                out, lse = fa.stream_attention(qd, kd, vd, **kw)
                wgrads = fa.stream_attention_bwd_plain(qd, kd, vd, do, out,
                                                       lse, **kw)
            torch.cuda.synchronize()
            gerr = [_grad_gate(g, w) for g, w in zip(grads, wgrads)]
            _log(f"  keyless row {dtype} {shape} "
                 f"({'full-block' if full else 'streaming'} rule): "
                 f"gradients max|err| "
                 f"{', '.join(f'{e:.3g}' for e, _ in gerr)}")
            if not all(ok for _, ok in gerr):
                failures.append(f"keyless row {dtype} {shape}: gradients "
                                f"{[e for e, _ in gerr]}")


def _wide_block(failures, rand):
    """Phase 2d's ``AttentionBlock2D`` at 1024 channels
    (``check_wide_head_dims``): returns its launches."""
    import torch
    from hivae_tpu_torch.models import conv_blocks

    torch.manual_seed(SEED + 11)
    _, c, h, w = WIDE_BLOCK
    block = conv_blocks.AttentionBlock2D(c).cuda().bfloat16()
    x = rand(WIDE_BLOCK, torch.bfloat16).requires_grad_()
    dy = rand(WIDE_BLOCK, torch.bfloat16)
    names, params = zip(("x", x), *block.named_parameters())
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    y = block(x)
    grads = torch.autograd.grad(y, params, dy)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _read_counts()
    with _plain_kernels(("stream_attention",)):
        y_plain = block(x)
        grads_plain = torch.autograd.grad(y_plain, params, dy)
    torch.cuda.synchronize()
    errs = [_grad_gate(y, y_plain)]
    for name, g, gp in zip(names, grads, grads_plain):
        if name == "to_k.bias":
            # a shift of every key by one vector moves each row's logits by
            # one constant: the softmax, and this gradient, are 0 but for
            # rounding; held against the scale of to_k.weight's
            err = _abs_err(g, gp)
            errs.append((err, err <= BWD_RTOL * grads_plain[
                names.index("to_k.weight")].float().abs().max().item()))
        else:
            errs.append(_grad_gate(g, gp))
    want = dict(_no_launches(), **{f"{n}_wide": 1 for n in WIDE_NAMES})
    _log(f"  AttentionBlock2D({c}) bf16 on {WIDE_BLOCK} (attention "
         f"({WIDE_BLOCK[0]}, 1, {h * w}, {c})): forward and backward "
         f"{ms:.2f} ms (first call); output and gradients max|err| against "
         f"the plain run {max(e for e, _ in errs):.3g}; launches "
         f"{ {k: n for k, n in launches.items() if n} }")
    if not (launches == want and all(ok for _, ok in errs)):
        failures.append(f"AttentionBlock2D({c}): launches {launches} want "
                        f"{want}, errors {[e for e, _ in errs]}")
    return launches


def _wide_times(failures, rand, dtype, parent=None):
    """Phase 2d's times of the wide forms in ``dtype`` at ``WIDE_TIMED``
    (``check_wide_head_dims``), with ``parent``'s forward timed before and
    after this one's: {counter name: cases}."""
    import torch
    import torch.nn.functional as F
    from hivae_tpu_torch.ops.kernels import flash_attention as fa

    f32 = dtype == torch.float32
    elem = 4 if f32 else 2
    # fp32: three TF32 products a product, at TF32's peak
    peak, terms = (PEAK_TF32_FLOPS, 3) if f32 else (PEAK_BF16_FLOPS, 1)
    cases = {n: [] for n in WIDE_NAMES}
    for shape in WIDE_TIMED:
        q, k, v, do = (rand(shape, dtype) for _ in range(4))
        scale = shape[3] ** -0.5
        kw = dict(scale=scale)
        out, lse = fa.stream_attention(q, k, v, **kw)
        delta = fa.stream_attention_delta(do, out)
        wo, _ = fa.stream_attention_plain(q, k, v, **kw)
        want = fa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
        dq = fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ferr = _abs_err(out, wo)
        gerr = [_grad_gate(g, w) for g, w in zip((dq, dk, dv), want)]
        derr = _abs_err(delta, fa._delta(do, out))
        if not (all(ok for _, ok in gerr) and ferr <= (
                KERNEL_F32_ATOL * max(1.0, wo.abs().max().item())
                if f32 else KERNEL_ATOL)):
            failures.append(f"wide {dtype} {shape}: output {ferr}, "
                            f"gradients {[e for e, _ in gerr]}")
        del want, dq, dk, dv

        def bwd():
            dl = fa.stream_attention_delta(do, out)
            fa.stream_attention_bwd_dq(q, k, v, do, lse, dl, **kw)
            fa.stream_attention_bwd_dkv(q, k, v, do, lse, dl, **kw)

        def bwd_plain():
            fa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
        b, h, sq, d = shape
        timed = {   # (kernel, plain version, library call, bound, error)
            "stream_attention": (
                lambda: fa.stream_attention(q, k, v, **kw),
                lambda: fa.stream_attention_plain(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                _bound(shape, False, True, elem_bytes=elem,
                       flop_factor=4 * terms, peak=peak), ferr),
            "stream_attention_bwd_dq": (
                lambda: fa.stream_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   **kw), bwd_plain, None,
                _bound(shape, False, True, tensors=5, stats=1,
                       elem_bytes=elem, flop_factor=6 * terms, peak=peak),
                gerr[0][0]),
            "stream_attention_bwd_dkv": (
                lambda: fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    **kw), bwd_plain, None,
                _bound(shape, False, True, tensors=6, stats=1,
                       elem_bytes=elem, flop_factor=8 * terms, peak=peak),
                max(e for e, _ in gerr[1:])),
            "stream_attention_delta": (
                lambda: fa.stream_attention_delta(do, out),
                lambda: fa._delta(do, out),
                lambda: torch.linalg.vecdot(do, out, dim=-1),
                ((2 * b * h * sq * d * elem + b * h * sq * 4)
                 / PEAK_HBM_BYTES * 1e3,
                 2 * b * h * sq * d / PEAK_FP32_FLOPS * 1e3), derr)}
        lib_bwd = _library_bwd_ms(q, k, v, do, None, scale, 5)
        backend = _sdpa_backend(q, k, v, scale)
        par = par_ms = par_dev = None
        if parent is not None:
            def par():
                return parent.stream_attention(q, k, v, **kw)
            par_ms = _time_ms(par, 10)
        fwd_dev = _device_ms(lambda: fa.stream_attention(q, k, v, **kw),
                             "stream_fwd_wide")
        bwd_ms = _time_ms(bwd, 10)
        bwd_dev = _device_ms(bwd, "stream_")
        for name, (fn, pfn, lfn, (bb, bo), err) in timed.items():
            cases[name].append(dict(
                label=str(list(shape)), shape=list(shape), weight=1,
                max_abs_err=err, ms=_time_ms(fn, 10),
                plain_ms=_time_ms(pfn, 3),
                library_ms=_time_ms(lfn, 5) if lfn else lib_bwd,
                bytes_ms=bb, ops_ms=bo, sdpa_backend=backend,
                device_ms=fwd_dev if name == "stream_attention" else None,
                bwd_ms=None if name == "stream_attention" else bwd_ms,
                bwd_device_ms=None if name == "stream_attention"
                else bwd_dev))
        fw, dlc, dqc, dkc = (cases[n][-1] for n in WIDE_NAMES)
        if par is not None:
            par_ms = (par_ms + _time_ms(par, 10)) / 2
            par_dev = _device_ms(par, "stream_fwd_wide")
            fw.update(parent_ms=par_ms, parent_device_ms=par_dev)
        bwd_bound = sum(max(c["bytes_ms"], c["ops_ms"])
                        for c in (dqc, dkc, dlc))
        _log(f"  wide {dtype} {shape}, {d // 256}-CTA clusters: forward "
             f"{fw['ms']:.4f} ms (device {_ms_or_none(fwd_dev)}; parent "
             f"{_ms_or_none(par_ms)}, device {_ms_or_none(par_dev)}; bound "
             f"{max(fw['bytes_ms'], fw['ops_ms']):.4f}, plain "
             f"{fw['plain_ms']:.4f}, SDPA {backend} "
             f"{fw['library_ms']:.4f}); dQ + dK/dV + delta {bwd_ms:.4f} ms "
             f"(device {_ms_or_none(bwd_dev)}; dQ {dqc['ms']:.4f}, dK/dV "
             f"{dkc['ms']:.4f}, delta {dlc['ms']:.4f}; bound "
             f"{bwd_bound:.4f}, plain {dqc['plain_ms']:.4f}, SDPA {backend} "
             f"backward {lib_bwd:.4f})")
    return {f"{n}_wide{DTYPE_SUFFIX[str(dtype)]}": c
            for n, c in cases.items()}


def check_wide_head_dims(failures, parent=None):
    """Phase 2d. ``sdpa`` at ``HEAD_DIMS_WIDE`` in bf16, fp16 and fp32,
    forward and with a gradient, at (2, 2, 300, D) masked and not (the JAX
    rule's full-block shapes: the streaming kernels with the full-block
    flag) and (2, 1, 1024, D): the route ``stream``, exact launches on the
    dtype's wide counters, ``sdpa_plain`` 0, the same bits twice, phase
    2c's gates against the plain path. The keyless row's gradient
    through ``sdpa(..., implementation="pallas")`` at ``WIDE_KEYLESS``
    (batch 0 keyless): within ``_grad_gate`` of the full-block plain
    version's autograd where ``full_block_fits`` holds, of the plain
    streaming backward (from the kernels' O and LSE) where it does not. A
    port ``AttentionBlock2D`` at 1024 channels over a 32 x 32 map in bf16,
    forward and backward (its input's and parameters' gradients), against
    the same with the plain streaming forward in place of the kernel
    (``_grad_gate`` on each), with its launches. Each wide form timed at
    ``WIDE_TIMED`` (forward; dQ, dK/dV and delta) by CUDA events and
    device time, beside its bound, its plain version and SDPA (the backend
    it picks named), and the forward beside ``parent``'s (another
    checkout's flash_attention module) where it is given; the clusters of
    the forward the card holds at once at each wide cluster size. Returns
    (the kernels line's records, {path: launches})."""
    import torch
    from hivae_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    paths = {"head_dims_wide": _wide_sweep(failures, rand, gen)}
    _wide_keyless(failures, rand, gen)
    paths["attention_block_1024"] = _wide_block(failures, rand)
    cases = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        active = {c: fa.wide_fwd_active_clusters(dtype, c)
                  for c in fa.WIDE_CLUSTERS}
        _log(f"  wide forward {dtype}: clusters the card holds at once, by "
             f"cluster size: {active}")
        cases.update(_wide_times(failures, rand, dtype, parent))

    def record(name, source, line):
        return {"name": name, "route": "cuda",
                "source": "hivae_tpu_torch/csrc/" + source,
                "replaces": "hivae_tpu/ops/pallas/flash_attention.py:" + line,
                "cases": cases[name]}
    records = []
    for sx in ("", "_f16", "_f32"):
        dq = record(f"stream_attention_bwd_dq_wide{sx}",
                    "flash_stream_bwd.cu", "512")
        dq["delta"] = record(f"stream_attention_delta_wide{sx}",
                             "flash_stream_bwd.cu", "512")
        records += [record(f"stream_attention_wide{sx}", "flash_stream.cu",
                           "468"), dq,
                    record(f"stream_attention_bwd_dkv_wide{sx}",
                           "flash_stream_bwd.cu", "552")]
    return records, paths


class _LocalOp:
    """Stands in for ``torch.library.custom_op`` while another checkout's
    kernel modules import: their ops stay plain functions that launch that
    checkout's kernels. Registered, they would replace this checkout's
    ``torch.ops.hivae.*`` (torch lets a custom op be defined anew), and
    every later call, this checkout's wrappers' included, would run the
    other checkout's kernels. A call takes the implementation registered
    for its first tensor's device."""

    def __init__(self, fn):
        self._impls = {"cuda": fn}

    def __call__(self, *args, **kwargs):
        return self._impls[args[0].device.type](*args, **kwargs)

    def register_kernel(self, device, *args, **kwargs):
        def register(fn):
            self._impls[device] = fn
            return fn
        return register

    def register_fake(self, fn):
        return fn


def _load_kernels(root):
    """``hivae_tpu_torch.ops.kernels`` ``flash_attention`` and ``quant_ffn``
    of the checkout at ``root``, imported as their own package
    (``parent_kernels``) so that they build and load that checkout's sources
    into that checkout's build directory, with their custom ops kept out of
    torch's registry (``_LocalOp``)."""
    import importlib
    import importlib.util
    from unittest import mock
    import torch
    kdir = os.path.join(os.path.abspath(root), "hivae_tpu_torch", "ops",
                        "kernels")
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(kdir, "__init__.py"),
        submodule_search_locations=[kdir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = mod
    spec.loader.exec_module(mod)
    with mock.patch.object(torch.library, "custom_op",
                           lambda *a, **k: _LocalOp):
        return (importlib.import_module("parent_kernels.flash_attention"),
                importlib.import_module("parent_kernels.quant_ffn"))


def _norm_params(gen, d):
    """gamma/beta of q and k, fp32, drawn away from (1, 0)."""
    import torch

    def draw(mean, std):
        return mean + std * torch.randn((d,), generator=gen, device="cuda")
    return [draw(1.0, 0.5), draw(0.0, 0.3), draw(1.0, 0.5), draw(0.0, 0.3)]


def check_qknorm(fa, failures, parent=None):
    """Phase 2, the fused qk-norm forward at the full-block shapes (raw q
    and k far from normalised), its autograd gradients at the camera-joint
    shape, and its times (with ``parent``'s beside them). Returns the
    kernel's record."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def rand(shape, mean=0.0, std=1.0):
        return (mean + std * torch.randn(shape, generator=gen,
                                         device="cuda")).bfloat16()

    cases = []
    for label, shape, per_clip in FULL_BLOCK_CASES + [
            ("DiT camera joint, masked", (16, 16, 512, 64), 0)]:
        q, k, v = rand(shape, 1.0, 3.0), rand(shape, -1.0, 2.0), rand(shape)
        norms = _norm_params(gen, shape[3])
        scale = shape[3] ** -0.5
        bias = None
        if per_clip == 0:
            keep = torch.rand((shape[0], shape[2]), generator=gen,
                              device="cuda") > 0.3
            keep[0] = False   # one fully masked row
            bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        kw = dict(scale=scale, bias=bias)
        got = fa.full_block_attention_qknorm(q, k, v, *norms, **kw)
        want = fa.full_block_attention_qknorm_plain(q, k, v, *norms, **kw)
        torch.cuda.synchronize()
        err = _abs_err(got, want)
        finite = bool(torch.isfinite(got).all())
        if not (finite and err <= KERNEL_ATOL):
            failures.append(f"full_block_qknorm {label}: max|err| {err} "
                            f"finite {finite}")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        d = shape[3]

        def library():
            qn = F.layer_norm(q, (d,), norms[0].bfloat16(),
                              norms[1].bfloat16(), 1e-6)
            kn = F.layer_norm(k, (d,), norms[2].bfloat16(),
                              norms[3].bfloat16(), 1e-6)
            return F.scaled_dot_product_attention(qn, kn, v, attn_mask=mask,
                                                  scale=scale)
        ms = _time_ms(lambda: fa.full_block_attention_qknorm(
            q, k, v, *norms, **kw), 50)
        plain_ms = _time_ms(lambda: fa.full_block_attention_qknorm_plain(
            q, k, v, *norms, **kw), 10)
        lib_ms = _time_ms(library, 50)
        parent_ms = None if parent is None else _time_ms(
            lambda: parent.full_block_attention_qknorm(q, k, v, *norms, **kw),
            50)
        bytes_ms, ops_ms = _bound(shape, bias is not None, False)
        cases.append(dict(label=label, shape=list(shape), per_clip=per_clip,
                          weight=per_clip, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          parent_ms=parent_ms, bytes_ms=bytes_ms,
                          ops_ms=ops_ms))
        _log(f"  full_block_qknorm {label} {shape}: max|err| {err:.3g}  "
             f"kernel {ms:.4f} ms  parent {parent_ms} ms  plain "
             f"{plain_ms:.4f} ms  layer_norm x2 + "
             f"sdpa {lib_ms:.4f} ms  bound {max(bytes_ms, ops_ms):.4f} ms")

    # gradients: autograd through the fused kernel (its backward recomputes
    # the unfused composition on the full-block kernels) against autograd
    # through the plain version. beta_k's gradient is zero in exact
    # arithmetic (softmax ignores a shift shared by all keys): both sides
    # hold rounding noise there, held against gamma_k's scale.
    shape = (16, 16, 512, 64)
    base = [rand(shape), rand(shape), rand(shape)] + _norm_params(gen, 64)
    do = rand(shape)
    grads = []
    for fn in (fa.full_block_attention_qknorm,
               fa.full_block_attention_qknorm_plain):
        leaves = [x.detach().requires_grad_() for x in base]
        fn(*leaves, scale=0.125).backward(do)
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    errs = [_rel_err(g, w) for g, w in zip(grads[0][:6], grads[1][:6])]
    errs.append(_abs_err(grads[0][6], grads[1][6])
                / grads[1][5].float().abs().max().item())
    finite = all(bool(torch.isfinite(g).all()) for g in grads[0])
    _log(f"  full_block_qknorm gradients {shape}: rel err q/k/v/gq/bq/gk/bk "
         + " ".join(f"{e:.3g}" for e in errs))
    if not (finite and max(errs) <= BWD_RTOL):
        failures.append(f"full_block_qknorm gradients: rel err {errs} "
                        f"finite {finite}")
    return {"name": "full_block_attention_qknorm", "route": "cuda",
            "source": "hivae_tpu_torch/csrc/flash_full_block.cu",
            "replaces": "hivae_tpu/ops/pallas/flash_attention.py:140",
            "cases": cases, "grad_rel_err": errs}


def _ffn_bound(m, k, n):
    """(bytes ms, operations ms) of one FFN-up call: xq (M K), w8 (K N)
    and yq (M N) int8 once each, the fp32 sx read and sy written (8 M), ws
    and bias (8 N); 2 M K N int8 operations at the int8 tensor-core peak."""
    nbytes = m * k + k * n + m * n + 8 * m + 8 * n
    return (nbytes / PEAK_HBM_BYTES * 1e3,
            2 * m * k * n / PEAK_INT8_OPS * 1e3)


# check-only FFN-up cases (label, M, N) at K 1024: one row, a row count
# below one CTA's 64, a ragged row count past one cluster's rows, and an N
# wider than one portable cluster of 8 CTAs x 512 columns
FFN_CHECKS = [("one row", 1, FFN_N), ("70 rows", 70, FFN_N),
              ("200 rows (ragged)", 200, FFN_N),
              ("N 8192 (two column chunks)", 16 * 266, 2 * FFN_N),
              # the AMD_S int8 clip's DiT joint block (phase 3k)
              ("AMD_S DiT joint, M 4512", 16 * 282, FFN_N),
              # the A2M head's FFNs on the int8 A2V path (phase 3m): the
              # reference's and 16 frames' 4 tokens, held bit-equal
              ("A2M joint, M 68", A2M_FFN_ROWS, FFN_N),
              # the LearnableToken head's joint block on its int8 A2V
              # path (phase 3n): 4 tokens of 17 frames and 16 audio tokens
              ("A2M LearnableToken joint, M 84", A2M_JOINT_FFN_ROWS,
               FFN_N)]
# check cases that must give the plain version's bits exactly
FFN_EXACT = ("A2M joint, M 68",)
# SASS opcodes by the pipe that issues them, for the epilogue's floor
SASS_PIPES = {"fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL",
                       "FCHK"),
              "mufu": ("MUFU",), "conv": ("I2F", "F2I", "FRND", "F2F")}
# issue rate a SM a clock of each pipe (H100: 128 fp32 lanes, 16 MUFU and
# 16 conversion lanes)
SASS_RATES = {"fp32": 128, "mufu": 16, "conv": 16}


def _ffn_epilogue_counts():
    """SASS instructions of the FFN-up kernel by pipe (``cuobjdump -sass``
    of the built library, static counts), per element of its epilogue: the
    unrolled epilogue covers a thread's 128 accumulators once for the GELU
    and once for the requantise, and the main loop issues no float work.
    None where cuobjdump is missing."""
    from hivae_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build._lib_path("quant_ffn"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = sass[sass.index("quant_ffn_up_kernel"):]
    counts = {pipe: 0 for pipe in SASS_PIPES}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         body):
        for pipe, ops in SASS_PIPES.items():
            if m.group(1) in ops:
                counts[pipe] += 1
    return {pipe: n / 128 for pipe, n in counts.items()}


def _max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def _ffn_plain(qf, xq, sx, w8, ws, bias):
    """The plain version; fewer than 17 rows (``torch._int_mm`` needs
    more) are padded with zero rows, which change no other row."""
    import torch
    m = xq.shape[0]
    if m > 16:
        return qf.fused_ffn_up_quant_plain(xq, sx, w8, ws, bias)
    pad = 17 - m
    xq = torch.cat([xq, xq.new_zeros((pad, xq.shape[1]))])
    sx = torch.cat([sx, sx.new_ones((pad, 1))])
    yq, sy = qf.fused_ffn_up_quant_plain(xq, sx, w8, ws, bias)
    return yq[:m], sy[:m]


def check_quant_ffn(qf, failures, parent=None):
    """Phase 2, the fused int8 FFN-up kernel at the int8 clip's three row
    counts and the check-only ``FFN_CHECKS``, on per-token int8 of a random
    bf16 activation and a per-channel int8 weight, with ``parent``'s
    (another checkout's quant_ffn module) time beside it, and the
    epilogue's floor from the kernel's SASS. Returns the kernel's record."""
    import torch
    from hivae_tpu_torch.ops import quant as quant_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    weights = {}

    def weight(n):
        if n not in weights:
            w = torch.randn((n, FFN_K), generator=gen, device="cuda") / 32
            w8, ws = quant_ops._quantize_kernel(w)
            bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
            weights[n] = (w8, ws, bias)
        return weights[n]

    per_elem = _ffn_epilogue_counts()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    _log(f"  fused_ffn_up_quant epilogue, SASS instructions an element: "
         f"{per_elem} at {clock / 1e6:.0f} MHz on {sms} SMs")
    cases = []
    for label, m, n, per_clip in [(lab, m, FFN_N, c)
                                  for lab, m, c in FFN_CASES] + [
            (lab, m, n, 0) for lab, m, n in FFN_CHECKS]:
        w8, ws, bias = weight(n)
        x = torch.randn((m, FFN_K), generator=gen, device="cuda").bfloat16()
        xq, sx = quant_ops.quant_act(x)
        args = (xq, sx, w8, ws, bias)
        yq, sy = qf.fused_ffn_up_quant(*args)
        wq, wsy = _ffn_plain(qf, *args)
        torch.cuda.synchronize()
        step = (yq.int() - wq.int()).abs()
        worst, off = step.max().item(), (step == 1).float().mean().item()
        rel_s = ((sy - wsy).abs() / wsy).max().item()
        want = wq.float() * wsy
        l2 = ((yq.float() * sy - want).norm() / want.norm()).item()
        exact = label in FFN_EXACT
        if exact and not (worst == 0 and torch.equal(sy, wsy)):
            failures.append(f"fused_ffn_up_quant {label}: not bit-equal to "
                            f"its plain version (max step {worst})")
        if not (worst <= FFN_MAX_STEP and off <= FFN_OFF_BY_ONE_SHARE
                and rel_s <= FFN_SCALE_RTOL and l2 <= FFN_DEQUANT_RTOL):
            failures.append(f"fused_ffn_up_quant {label} M={m} N={n}: max "
                            f"step {worst}, off by one {off}, scale rel "
                            f"{rel_s}, dequant L2 {l2}")
        ms = _time_ms(lambda: qf.fused_ffn_up_quant(*args), 20)
        plain_ms = _time_ms(lambda: _ffn_plain(qf, *args), 5)
        lib_ms = None if m <= 16 else _time_ms(
            lambda: torch._int_mm(xq, w8.t()), 20)
        parent_ms = None if parent is None else _time_ms(
            lambda: parent.fused_ffn_up_quant(*args), 20)
        bytes_ms, ops_ms = _ffn_bound(m, FFN_K, n)
        floor = None if per_elem is None else {
            pipe: m * n * cnt / (sms * SASS_RATES[pipe] * clock) * 1e3
            for pipe, cnt in per_elem.items()}
        plan = qf._ffn_plan(m, FFN_K, n)
        cases.append(dict(label=label, shape=[m, FFN_K, n],
                          per_clip=per_clip, weight=per_clip,
                          max_abs_err=worst, off_by_one_share=off,
                          scale_rel_err=rel_s, dequant_rel_l2=l2, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          parent_ms=parent_ms, bytes_ms=bytes_ms,
                          ops_ms=ops_ms, epilogue_floor_ms=floor,
                          plan=dataclasses.asdict(plan)))
        _log(f"  fused_ffn_up_quant {label} ({m}, {FFN_K}) x ({FFN_K}, "
             f"{n}): max step {worst}, off by one {off:.3g}, scale rel "
             f"{rel_s:.3g}, dequant L2 {l2:.3g}  kernel {ms:.4f} ms  parent "
             f"{parent_ms} ms  plain {plain_ms:.4f} ms  _int_mm {lib_ms} ms"
             f"  bound {max(bytes_ms, ops_ms):.4f} ms  epilogue floor "
             f"{floor} ms  (cluster {plan.cluster}, {plan.chunks} chunk(s), "
             f"{plan.smem} B)")
    return {"name": "fused_ffn_up_quant", "route": "cuda",
            "source": "hivae_tpu_torch/csrc/quant_ffn.cu",
            "replaces": "hivae_tpu/ops/pallas/quant_ffn.py:78",
            "cases": cases, "epilogue_sass_per_element": per_elem}


# sdpa above 256^2 logits in dtypes the kernels do not take (label, q
# shape, masked): the gate sends them to the plain path
SDPA_DTYPE_CASES = [("object encoder width", (2, 16, 260, 64), True),
                    ("SD-VAE mid-block", (4, 1, 1024, 512), False)]
# int8 layers at row counts around torch._int_mm's least M (17)
INT8_SMALL_M = (1, 16, 17)


def _sdpa_dtype_want(dtype, label, grad):
    """(route, launches of the forward, launches of forward and backward)
    ``sdpa`` must take in phase 2b: fp32 and fp16 to their kernels
    (``<name>_f32``, ``<name>_f16``) of the route its shape picks (the
    SD-VAE mid-block's the streaming kernels, the object encoder's the
    full-block ones; with a gradient, the backward's delta pre-pass and
    kernels too)."""
    sx = DTYPE_SUFFIX[str(dtype)]
    if "mid-block" in label:
        fwd = {f"stream_attention{sx}": 1}
        bwd = dict(fwd, **{f"stream_attention_delta{sx}": 1,
                           f"stream_attention_bwd_dq{sx}": 1,
                           f"stream_attention_bwd_dkv{sx}": 1})
        return "stream", fwd, bwd if grad else fwd
    fwd = {f"full_block_attention{sx}": 1}
    bwd = dict(fwd, **{f"full_block_attention_delta{sx}": 1,
                       f"full_block_attention_bwd{sx}": 1})
    return "full_block", fwd, bwd if grad else fwd


def _grad_gate(got, want):
    """(max|err|, whether it is within the gate) of a kernel gradient
    against its plain version's: fp32 ``_f32_gate``; bf16 and fp16
    ``BWD_RTOL`` of the largest plain element (both round P and dS to the
    dtype from sums taken in another order)."""
    import torch
    if want.dtype == torch.float32:
        return _f32_gate(got, want)
    err = _abs_err(got, want)
    return err, err <= BWD_RTOL * max(want.float().abs().max().item(), 1e-6)


def check_repairs(failures):
    """Phase 2b. ``sdpa`` in fp32 and fp16 above 256^2 logits against its
    plain path: each launches its dtype's kernels of its shape's route once
    (the SD-VAE mid-block the streaming forward, the object encoder the
    full-block forward), and with a gradient the backward's delta
    pre-pass and kernels once each, its gradients within ``_grad_gate`` of
    the plain path's, ``sdpa_plain`` 0; bf16 in a layout the kernels cannot
    read, copied and launched; an fp32 ``AutoencoderKL`` encoding one clip
    (one fp32 streaming launch, ``sdpa_plain`` 0); ``quant_dense`` and
    ``fused_quant_ffn`` at M 1, 16 and 17 on the card against the same
    calls on the CPU (their plain versions)."""
    import torch
    from hivae_tpu_torch.models import vae as vae_mod
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.ops import quant as quant_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for dtype, grad in ((torch.float32, False), (torch.float32, True),
                        (torch.float16, False), (torch.float16, True)):
        for label, shape, masked in SDPA_DTYPE_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype).requires_grad_(grad) for _ in range(3))
            mask = None
            if masked:
                mask = torch.rand((shape[0], shape[2]), generator=gen,
                                  device="cuda") > 0.3
            route = attn_ops.kernel_route(q, k, v)
            _zero_counts()
            got = attn_ops.sdpa(q, k, v, key_mask=mask)
            launched = {n: c for n, c in _read_counts().items() if c}
            gerr = []
            if grad:
                gout = torch.randn(shape, generator=gen, device="cuda")
                grads = torch.autograd.grad(got, (q, k, v), gout)
                ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
                want_g = torch.autograd.grad(attn_ops._sdpa_plain(
                    *ref, shape[3] ** -0.5, mask), ref, gout)
                gerr = [_grad_gate(g, w) for g, w in zip(grads, want_g)]
            both = {n: c for n, c in _read_counts().items() if c}
            with torch.no_grad():
                want = attn_ops._sdpa_plain(q, k, v, shape[3] ** -0.5, mask)
            torch.cuda.synchronize()
            err = _abs_err(got.detach(), want)
            want_route, want_fwd, want_both = _sdpa_dtype_want(dtype, label,
                                                               grad)
            ok = (route == want_route and launched == want_fwd
                  and both == want_both and got.dtype == dtype
                  and bool(torch.isfinite(got).all())
                  and err <= (KERNEL_F32_ATOL * max(1.0, want.abs().max()
                                                    .item())
                              if dtype == torch.float32 else KERNEL_ATOL)
                  and all(g_ok for _, g_ok in gerr))
            _log(f"  sdpa {dtype}{' (grad)' if grad else ''} {label} "
                 f"{shape}: route {route}, launches {launched} (with the "
                 f"backward {both}), max|err| vs plain {err:.3g}"
                 f"{f', gradients {[e for e, _ in gerr]}' if gerr else ''}")
            if not ok:
                failures.append(f"sdpa {dtype} grad {grad} {label}: route "
                                f"{route} want {want_route}, launches "
                                f"{launched} want {want_fwd}, with the "
                                f"backward {both} want {want_both}, err "
                                f"{err}, gradients {gerr}")

    # bf16 operands whose rows the kernels cannot read (every other column
    # of a wider tensor): sdpa copies them to the kernels' layout and
    # launches the kernel its shape picks
    for label, shape, masked in SDPA_DTYPE_CASES:
        q, k, v = (torch.randn(shape[:3] + (2 * shape[3],), generator=gen,
                               device="cuda").bfloat16()[..., ::2]
                   for _ in range(3))
        route = attn_ops.kernel_route(q, k, v)
        _zero_counts()
        got = attn_ops.sdpa(q, k, v)
        launched = {n: c for n, c in _read_counts().items() if c}
        want = attn_ops._sdpa_plain(q, k, v, shape[3] ** -0.5, None)
        torch.cuda.synchronize()
        err = _abs_err(got, want)
        kernel = ("full_block_attention" if route == "full_block"
                  else "stream_attention")
        _log(f"  sdpa bf16 strided {label} {shape}: route {route}, launches "
             f"{launched}, max|err| vs plain {err:.3g}")
        if not (route != "plain" and launched == {kernel: 1}
                and err <= KERNEL_ATOL):
            failures.append(f"sdpa bf16 strided {label}: route {route}, "
                            f"launches {launched}, err {err}")

    torch.manual_seed(SEED + 6)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.float32).eval()
    rgb, _ = synthetic_clip()
    _zero_counts()
    lat = vae_mod.vae_encode(vae, torch.from_numpy(rgb).cuda()[None])
    torch.cuda.synchronize()
    launched = {n: c for n, c in _read_counts().items() if c}
    want_shape = (1, WINDOW + 1, vae.cfg.latent_channels, SIZE // 8,
                  SIZE // 8)
    _log(f"  fp32 AutoencoderKL encode: latents {tuple(lat.shape)} "
         f"{lat.dtype}, finite {bool(torch.isfinite(lat).all())}, launches "
         f"{launched}")
    if tuple(lat.shape) != want_shape or lat.dtype != torch.float32 or \
            not bool(torch.isfinite(lat).all()) or \
            launched != {"stream_attention_f32": 1}:
        failures.append(f"fp32 AutoencoderKL encode: {tuple(lat.shape)} "
                        f"{lat.dtype}, launches {launched}")
    del vae, lat

    def entry(n, k):
        w = torch.randn((n, k), generator=gen, device="cuda") / k ** 0.5
        w8, ws = quant_ops._quantize_kernel(w)
        return {"w8": w8, "scale": ws,
                "bias": 0.1 * torch.randn((n,), generator=gen, device="cuda")}

    def cpu(e):
        return {n: t.cpu() for n, t in e.items()}
    up, down = entry(FFN_N, FFN_K), entry(FFN_K, FFN_N)
    for m in INT8_SMALL_M:
        x = torch.randn((m, FFN_K), generator=gen, device="cuda").bfloat16()
        _zero_counts()
        got = [quant_ops.quant_dense(x, up["w8"], up["scale"], up["bias"]),
               quant_ops.fused_quant_ffn(x, up, down)]
        ffn_launches = _read_counts()["fused_ffn_up_quant"]
        want = [quant_ops.quant_dense(x.cpu(), up["w8"].cpu(),
                                      up["scale"].cpu(), up["bias"].cpu()),
                quant_ops.fused_quant_ffn(x.cpu(), cpu(up), cpu(down))]
        torch.cuda.synchronize()
        rel = [((g.float().cpu() - w.float()).norm() / w.float().norm()).item()
               for g, w in zip(got, want)]
        _log(f"  int8 M={m}: quant_dense rel L2 {rel[0]:.3g}, "
             f"fused_quant_ffn rel L2 {rel[1]:.3g}, FFN-up launches "
             f"{ffn_launches}")
        if not (max(rel) <= FFN_DEQUANT_RTOL and ffn_launches == 1 and
                all(bool(torch.isfinite(g).all()) for g in got)):
            failures.append(f"int8 M={m}: rel L2 {rel}, FFN-up launches "
                            f"{ffn_launches}")


def summarise(rec, launches):
    """One kernel's line entry. Times and bounds are per launch, averaged
    over the launch mix of the path the kernel's weights describe (the clip
    for the forward kernels, training run A for the full-block backward,
    run B for the streaming backward); the per-shape numbers stay under
    ``cases``. ``launches`` is the sum over the timed paths, which are
    listed per path under ``launches_per_path``."""
    cases = rec.pop("cases")
    weighted = [c for c in cases if c["weight"] > 0]
    n = sum(c["weight"] for c in weighted)

    def avg(key):
        return sum(c[key] * c["weight"] for c in weighted) / n

    bytes_ms, ops_ms = avg("bytes_ms"), avg("ops_ms")
    rec.update(launches=sum(launches.values()),
               launches_per_path=launches,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               ms=avg("ms"), plain_ms=avg("plain_ms"),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=None if any(c["library_ms"] is None for c in weighted)
               else avg("library_ms"), cases=cases)
    return rec


def synthetic_clip(seed: int = SEED, frames: int = None):
    """(frames, 3, 256, 256) RGB in [-1, 1] (smooth colour waves, drawn
    anew each frame, with seeded noise; 17 frames by default) and its grey
    clip (ITU-R 601 luma in all 3 channels)."""
    import numpy as np
    frames = WINDOW + 1 if frames is None else frames
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, SIZE), np.linspace(0, 1, SIZE),
                         indexing="ij")
    clip = []
    for t in range(frames):
        chans = [np.sin(2 * np.pi * (f * xx + g * yy) + 0.3 * t + ph)
                 for f, g, ph in rng.uniform(0.5, 3.0, (3, 3))]
        clip.append(np.stack(chans))
    rgb = np.stack(clip) * 0.8 + 0.1 * rng.randn(frames, 3, SIZE, SIZE)
    rgb = np.clip(rgb, -1, 1).astype(np.float32)
    luma = np.tensordot(np.array([0.299, 0.587, 0.114], np.float32), rgb,
                        axes=([0], [1]))
    grey = np.repeat(luma[:, None], 3, axis=1).astype(np.float32)
    return rgb, grey


def build_serving_models(depth=None, dtype=None):
    """Full-width flagship AMD_N (its layer counts replaced by ``depth``,
    where given) and the SD-VAE in ``dtype`` (default bf16), seeded random
    weights, on the card."""
    import torch
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.models import vae as vae_mod

    dtype = dtype or torch.bfloat16
    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    amd = amd_mod.AMDModelNew(cfg.replace(**(depth or {})), device="cuda",
                              dtype=dtype).eval()
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=dtype).eval()
    n_amd = sum(p.numel() for p in amd.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    _log(f"  AMD_N {n_amd / 1e6:.1f} M params, SD-VAE {n_vae / 1e6:.1f} M, "
         f"{str(dtype)[6:]}, built in {time.perf_counter() - t0:.1f} s")
    return amd, vae


def _timed_path(label, run, vae, want_shape, want_launches, failures,
                warm: bool = True):
    """One warm-up run of ``run`` (unless ``warm`` is False), then a timed
    one with the launch counters set to 0 just before and read just after.
    Checks the uint8 shape, finite decoded pixels before quantisation (the
    decoder's last conv, observed from outside the port) and the launches
    (every counter not in ``want_launches`` must read 0). Returns (output,
    launches, latency s)."""
    import torch
    decoded = []
    hook = vae.decoder.conv_out.register_forward_hook(
        lambda _m, _i, out: decoded.append(torch.isfinite(out).all()))
    try:
        if warm:
            run()
            torch.cuda.synchronize()
        decoded.clear()
        _zero_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        hook.remove()

    if tuple(out.shape) != tuple(want_shape) or out.dtype != torch.uint8:
        failures.append(f"{label}: got {tuple(out.shape)} {out.dtype}, want "
                        f"{tuple(want_shape)} uint8")
    if not (decoded and all(bool(x) for x in decoded)):
        failures.append(f"{label}: decoded pixels not finite before "
                        "quantisation")
    want = dict(_no_launches(), **want_launches)
    if launches != want:
        failures.append(f"{label}: launches {launches}, want {want}")
    o = out.float()
    frames = want_shape[0] - 1
    _log(f"  {label} {tuple(out.shape)} {out.dtype}: mean {o.mean():.2f} std "
         f"{o.std():.2f}; latency {latency * 1e3:.2f} ms, "
         f"{frames / latency:.2f} reconstructed frames/s; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    return out, launches, latency


def _timed_clip(pipe, label, failures, want_launches):
    """Phase 3's clip through ``pipe.sample_pixels`` (``_timed_path``).
    Returns (clip fn, clip, launches, latency s)."""
    import torch
    rgb, grey = synthetic_clip()
    pixels = torch.from_numpy(rgb).cuda()
    grey = torch.from_numpy(grey).cuda()

    def clip():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return pipe.sample_pixels(pixels, grey,
                                  video_sample_step=SAMPLE_STEP,
                                  generator=gen)

    out, launches, latency = _timed_path(
        label, clip, pipe.vae, (WINDOW + 1, 3, SIZE, SIZE), want_launches,
        failures)
    return clip, out, launches, latency


def _clip_diff(label, got, want, failures=None):
    """Mean, p99 and max |diff| in uint8 levels and the PSNR of ``got``
    against ``want``; with ``failures``, gated by CLIP_MEAN_ATOL and
    CLIP_P99_ATOL."""
    import torch
    diff = (got.int() - want.int()).abs().float()
    mean_d = diff.mean().item()
    p99 = torch.quantile(diff.flatten(), 0.99).item()
    mse = diff.square().mean().item()
    psnr = 10 * math.log10(255.0 ** 2 / mse) if mse else float("inf")
    _log(f"  {label}: mean|diff| {mean_d:.4f} levels, p99 {p99:.0f}, max "
         f"{diff.max().item():.0f}, PSNR {psnr:.2f} dB")
    if failures is not None and not (mean_d <= CLIP_MEAN_ATOL
                                     and p99 <= CLIP_P99_ATOL):
        failures.append(f"{label}: mean {mean_d} p99 {p99}")
    return mean_d, psnr


def run_clip(models, args, failures):
    """Phase 3. Returns (launches per kernel name, latency s, clip)."""
    from hivae_tpu_torch.pipelines import AMDReconstructionPipeline

    amd, vae = models
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)
    clip, out, launches, latency = _timed_clip(
        pipe, "clip", failures,
        dict(full_block_attention=248, stream_attention=3))
    # reference: the same clip with the plain attention versions in place
    # of the kernels, on the same card and weights
    with _plain_kernels():
        ref = clip()
    _clip_diff("clip vs plain-attention clip", out, ref, failures)
    if args.profile:
        profile_clip(pipe, clip, args.profile)
    return launches, latency, out


def run_f16_clip(failures):
    """Phase 3w: phase 3's clip on AMD_N and the SD-VAE built at full width
    and depth in fp16 from phase 3's seed: every attention on the fp16
    forms (248 full-block, 3 streaming; ``sdpa_plain`` 0), finite before
    quantisation, against the same clip on the plain attention versions
    (phase 3's gates); its latency and peak device memory. Returns
    (launches, latency s)."""
    import torch
    from hivae_tpu_torch.pipelines import AMDReconstructionPipeline

    amd, vae = build_serving_models(dtype=torch.float16)
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clip, out, launches, latency = _timed_clip(
        pipe, "fp16 clip", failures,
        dict(full_block_attention_f16=248, stream_attention_f16=3))
    peak = torch.cuda.max_memory_allocated()
    with _plain_kernels():
        ref = clip()
    _clip_diff("fp16 clip vs its plain-attention clip", out, ref, failures)
    _log(f"  fp16 clip: peak device memory {peak / 2**30:.2f} GiB (models "
         f"{_model_bytes(amd, vae) / 2**30:.2f} GiB)")
    return launches, latency


def run_qknorm_clip(models, bf16_clip, failures):
    """Phase 3c: phase 3's clip with the q/k LayerNorm fused into the
    full-block kernel, then both clips timed in turns (the host-side spread
    of one clip is larger than their difference). Returns (launches,
    latency s)."""
    import statistics
    import torch
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.pipelines import AMDReconstructionPipeline

    amd, vae = models
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)
    attn_ops.QKNORM_FUSE = True
    try:
        clip, out, launches, latency = _timed_clip(
            pipe, "qk-norm clip", failures,
            dict(full_block_attention_qknorm=248, stream_attention=3))
        _clip_diff("qk-norm clip vs phase 3 clip", out, bf16_clip, failures)
        turns = {False: [], True: []}
        for _ in range(QKNORM_TURNS):
            for fuse in (False, True):
                attn_ops.QKNORM_FUSE = fuse
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                clip()
                torch.cuda.synchronize()
                turns[fuse].append((time.perf_counter() - t0) * 1e3)
    finally:
        attn_ops.QKNORM_FUSE = False
    _log("  clip latency ms in turns: q/k LayerNorm outside the kernel "
         + " ".join(f"{x:.2f}" for x in turns[False])
         + f" (median {statistics.median(turns[False]):.2f}); fused "
         + " ".join(f"{x:.2f}" for x in turns[True])
         + f" (median {statistics.median(turns[True]):.2f})")
    return launches, latency


def _serving_launches(cfg):
    """Kernel launches of each serving path of phases 3d-3h at
    ``SAMPLE_STEP`` steps: the object encoder's layers at 4 + 256 tokens
    and the DiT's object and camera joint blocks per layer and velocity
    call run the full-block kernel, each VAE encode and decode one
    streaming forward. Masked (ratio 0.5), the object encoder runs at 4 +
    128 tokens on the plain path (below 256^2 logits, as the JAX package's
    XLA path) and the camera joint block at 128 + 256. The cross clip runs
    the camera stream only and encodes the camera clip (grey) and the
    appearance clip once each; the long path 3 windows of 38 frames (2 and
    the ragged tail) and 16 of 257, one encode of the clip, RGB and grey,
    and one decode; the GT-motion ablation per window 8 layers on the
    window, 8 on its reference frame and the object stream only, with one
    encode and one decode of the whole clip."""
    enc, dit = cfg.object_enc_num_layers, cfg.diffusion_num_layers
    clip = enc + 2 * dit * SAMPLE_STEP

    def windows(frames):
        return -(-(frames - 1) // WINDOW)

    def fb(n):
        return dict(full_block_attention=n, stream_attention=3)
    return {"clip_heun": fb(enc + 2 * dit * 2 * SAMPLE_STEP),
            "clip_masked": fb(2 * dit * SAMPLE_STEP),
            "long": fb(windows(LONG_FRAMES) * clip),
            "long_257": fb(windows(LONG_MAX_FRAMES + 1) * clip),
            "cross": fb(dit * SAMPLE_STEP),
            "gt_motion": dict(full_block_attention=GT_WINDOWS * (
                2 * enc + dit * SAMPLE_STEP), stream_attention=2)}


def run_serving_paths(models, failures):
    """Phases 3d-3h. Returns the launches of each path's timed run."""
    import torch
    from hivae_tpu_torch.pipelines import (AMDCrossVideoPipeline,
                                           AMDReconstructionPipeline,
                                           GTMotionAblationPipeline)

    amd, vae = models
    want = _serving_launches(amd.cfg)
    paths = {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    def cuda(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    def check(name, label, run, frames):
        out, paths[name], _ = _timed_path(label, run, vae,
                                          (frames, 3, SIZE, SIZE),
                                          want[name], failures)
        with _plain_kernels():
            ref = run()
        _clip_diff(f"{label} vs the same run on the plain attention "
                   "versions", out, ref, failures)

    rgb, grey = cuda(*synthetic_clip())
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)
    _log("phase 3d: the clip with the Heun solver")
    check("clip_heun", "Heun clip", lambda: pipe.sample_pixels(
        rgb, grey, SAMPLE_STEP, gen(), solver="heun"), WINDOW + 1)
    _log(f"phase 3e: the clip with mask ratios {MASK_RATIO}")
    check("clip_masked", "masked clip", lambda: pipe.sample_pixels(
        rgb, grey, SAMPLE_STEP, gen(), camera_mask_ratio=MASK_RATIO,
        object_mask_ratio=MASK_RATIO), WINDOW + 1)

    _log(f"phase 3f: long-video reconstruction, {LONG_FRAMES} frames, then "
         f"{LONG_MAX_FRAMES + 1}")
    lrgb, lgrey = cuda(*synthetic_clip(SEED + 20, LONG_FRAMES))
    check("long", f"long clip ({LONG_FRAMES} frames)",
          lambda: pipe.sample_long_pixels(lrgb, lgrey, SAMPLE_STEP,
                                          generator=gen()), LONG_FRAMES)
    del lrgb, lgrey
    frgb, fgrey = cuda(*synthetic_clip(SEED + 21, LONG_MAX_FRAMES + 1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, paths["long_257"], _ = _timed_path(
        f"long clip ({LONG_MAX_FRAMES + 1} frames)",
        lambda: pipe.sample_long_pixels(frgb, fgrey, SAMPLE_STEP,
                                        generator=gen()),
        vae, (LONG_MAX_FRAMES + 1, 3, SIZE, SIZE), want["long_257"],
        failures, warm=False)
    _log(f"  long clip ({LONG_MAX_FRAMES + 1} frames): peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
         f"(torch.cuda.max_memory_allocated, models included)")
    del frgb, fgrey
    torch.cuda.empty_cache()

    _log("phase 3g: cross-video motion transfer")
    crgb, cgrey = cuda(*synthetic_clip(SEED + 22))
    cpipe = AMDCrossVideoPipeline(vae, amd, window=WINDOW)
    check("cross", "cross clip", lambda: cpipe.sample_cross_pixels(
        crgb, rgb, cgrey, SAMPLE_STEP, gen()), WINDOW + 1)

    _log(f"phase 3h: GT-motion ablation, {GT_WINDOWS} windows")
    (gpix,) = cuda(synthetic_clip(SEED + 23, GT_WINDOWS * WINDOW + 1)[0])
    gpipe = GTMotionAblationPipeline(vae, amd, window=WINDOW)
    check("gt_motion", "GT-motion ablation", lambda: gpipe.reconstruct_pixels(
        gpix, GT_WINDOWS, SAMPLE_STEP, gen()), GT_WINDOWS * WINDOW + 1)
    return paths


# torch dtype -> safetensors dtype name
_ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float32": "F32",
              "torch.float16": "F16"}


def write_safetensors(path, state):
    """Write ``state`` (name -> tensor) as a ``.safetensors`` file: an
    8-byte little-endian header length, the JSON header (each tensor's
    dtype, shape and byte range), padded to 8 bytes, then each tensor's
    raw little-endian bytes."""
    import torch
    header, offset = {}, 0
    for name, v in state.items():
        n = v.numel() * v.element_size()
        header[name] = {"dtype": _ST_DTYPES[str(v.dtype)],
                        "shape": list(v.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for v in state.values():
            f.write(v.detach().contiguous().cpu().reshape(-1).view(
                torch.uint8).numpy().tobytes())


def _reference_named(model):
    """The model's state dict as the reference names and lays it out: each
    ``PatchEmbed`` Linear (O, I*p*p) as a stride-p conv (O, I, p, p)."""
    from hivae_tpu_torch.models.blocks import PatchEmbed
    state = dict(model.state_dict())
    for name, mod in model.named_modules():
        if isinstance(mod, PatchEmbed):
            key = f"{name}.proj.weight"
            p = mod.patch_size
            state[key] = state[key].reshape(state[key].shape[0], -1, p, p)
    return state


def run_checkpoint_roundtrip(models, failures):
    """Phase 3i. Returns the CLI run's launches, or None where OpenCV does
    not import (the mp4 leg does not run)."""
    import argparse
    import shutil
    import torch
    from hivae_tpu_torch.cli import common as cli_common
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.training import checkpoint as ckpt_lib

    amd, _ = models
    live = amd.state_dict()
    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "amd_n.safetensors")

    def differing(model):
        return [k for k, v in model.state_dict().items()
                if not torch.equal(v, live[k])]
    try:
        t0 = time.perf_counter()
        write_safetensors(path, _reference_named(amd))
        write_s = time.perf_counter() - t0
        fresh = amd_mod.AMDModelNew(amd.cfg, device="cuda",
                                    dtype=torch.bfloat16).eval()
        t0 = time.perf_counter()
        report = ckpt_lib.load_pretrain_partial(fresh, path)
        load_s = time.perf_counter() - t0
        diff = differing(fresh)
        _log(f"  reference-named checkpoint {os.path.getsize(path) / 2**30:.3f}"
             f" GiB written in {write_s:.1f} s, loaded in {load_s:.1f} s: "
             f"missing {len(report['missing'])}, unused "
             f"{len(report['unused'])}, tensors differing {len(diff)}")
        if report["missing"] or report["unused"] or diff:
            failures.append(f"checkpoint round trip: report {report}, "
                            f"differing {diff[:5]}")
        del fresh
        args = argparse.Namespace(model_type="AMD_N", amd_config=CONFIG,
                                  amd_ckpt=path, video_frames=WINDOW)
        cli_model = cli_common.load_amd(args, "cuda")
        diff = differing(cli_model)
        _log(f"  cli load_amd with {os.path.relpath(CONFIG, ROOT)}: tensors "
             f"differing {len(diff)}")
        if diff or cli_model.cfg != amd.cfg.replace(video_frames=WINDOW):
            failures.append(f"cli load_amd: differing {diff[:5]}")
        del cli_model

        try:
            import cv2  # noqa: F401  (the mp4 leg reads and writes with it)
        except ImportError as e:
            _log(f"  mp4 leg not run: OpenCV does not import on this machine "
                 f"({e}); the device half of every path ran in phases 3-3h")
            return None
        from hivae_tpu_torch.data import video as vio
        videos, out_dir = (os.path.join(work, d) for d in ("videos", "out"))
        os.makedirs(videos)
        rgb, _ = synthetic_clip(SEED + 30, WINDOW + 4)
        frames = ((rgb.transpose(0, 2, 3, 1) + 1.0) * 127.5).clip(0, 255)
        vio.write_video(os.path.join(videos, "synthetic.mp4"),
                        frames.astype("uint8"), fps=8)
        return run_inference_cli(CONFIG, path, videos, out_dir, amd.cfg,
                                 failures)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_inference_cli(config, ckpt, videos, out_dir, cfg, failures,
                      label="python -m hivae_tpu_torch.cli.amd_inference",
                      model_type="AMD_N"):
    """``cli.amd_inference`` at 2 Euler steps on the one mp4 in
    ``videos``: its exit code, the output's frames and shape, and exact
    launches. Returns the launches."""
    import torch
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.data import video as vio

    cli_steps = 2
    name = os.path.splitext(os.listdir(videos)[0])[0]
    _zero_counts()
    t0 = time.perf_counter()
    rc = amd_inference.main([
        "--amd_config", config, "--amd_ckpt", ckpt, "--video_dir", videos,
        "--output_dir", out_dir, "--sample_step", str(cli_steps),
        "--model_type", model_type])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = _read_counts()
    out = os.path.join(out_dir, f"{name}_recon.mp4")
    total = vio.video_metadata(out)[0] if os.path.exists(out) else 0
    shape = vio.read_video_frames(out, range(total)).shape if total \
        else None
    if model_type == "AMD_N":
        want = dict(_no_launches(), full_block_attention=(
            cfg.object_enc_num_layers + 2 * cfg.diffusion_num_layers *
            cli_steps), stream_attention=3)
    else:
        want = dict(_no_launches(), **_dual_launches(cfg, cli_steps))
    _log(f"  {label}: rc {rc}, {out} frames {shape}, {cli_s:.1f} s with "
         f"model build; launches { {k: v for k, v in launches.items() if v} }")
    if rc != 0 or shape != (WINDOW + 1, SIZE, SIZE, 3) or launches != want:
        failures.append(f"{label}: rc {rc}, frames {shape}, launches "
                        f"{launches}, want {want}")
    return launches


def _model_bytes(*mods):
    return sum(t.numel() * t.element_size() for m in mods
               for t in list(m.parameters()) + list(m.buffers()))


def _table_bytes(*tables):
    return sum(t.numel() * t.element_size() for table in tables
               for e in table.values() for t in e.values())


def run_int8_clip(models, bf16_clip, bf16_latency, args, failures):
    """Phase 3b: the int8 clip through AMDReconstructionPipeline(quant=
    "int8"), which strips the models' covered float weights. Returns
    (launches, latency s)."""
    import gc
    import torch
    from hivae_tpu_torch.pipelines import AMDReconstructionPipeline

    amd, vae = models
    gc.collect()
    torch.cuda.synchronize()
    before, model_bf16 = torch.cuda.memory_allocated(), _model_bytes(amd, vae)
    t0 = time.perf_counter()
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW, quant="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    model_int8 = _model_bytes(amd, vae) + _table_bytes(pipe.quant_table,
                                                       pipe.vae_quant_table)
    gib = 2.0 ** 30
    _log(f"  int8 tables: DiT {len(pipe.quant_table)} layers, VAE decoder "
         f"{len(pipe.vae_quant_table)}, built and stripped in {build_s:.2f} "
         f"s; serving models bf16 {model_bf16 / gib:.3f} GiB vs int8 "
         f"{model_int8 / gib:.3f} GiB; torch.cuda.memory_allocated "
         f"{before / gib:.3f} -> {after / gib:.3f} GiB")
    clip, out, launches, latency = _timed_clip(
        pipe, "int8 clip", failures,
        dict(fused_ffn_up_quant=360, full_block_attention=248,
             stream_attention=3))
    with _plain_kernels(("fused_ffn_up_quant",)):
        ref = clip()
    _clip_diff("int8 clip vs the int8 clip with the plain FFN-up version",
               out, ref, failures)
    _clip_diff("int8 clip vs phase 3 bf16 clip (random weights)", out,
               bf16_clip)
    with _plain_kernels():
        ref = clip()
    to_plain, _ = _clip_diff("int8 clip vs the int8 clip on all plain "
                             "versions", out, ref)
    noise, _ = _clip_diff("int8 clip on all plain versions vs phase 3 bf16 "
                          "clip", ref, bf16_clip)
    if not to_plain <= CLIP_INT8_NOISE_RATIO * noise:
        failures.append(f"int8 clip vs all plain versions: mean {to_plain}, "
                        f"more than {CLIP_INT8_NOISE_RATIO} x their run's "
                        f"distance {noise} from the bf16 clip")
    _log(f"  latency: bf16 clip {bf16_latency * 1e3:.2f} ms, int8 clip "
         f"{latency * 1e3:.2f} ms")
    if args.profile:
        profile_clip(pipe, clip, args.profile, "profile_clip_int8.txt")
    return launches, latency


# -- audio to video (phase 3m) --------------------------------------------------


def a2m_spec():
    """The shipped flagship A2M spec {model_type, model}."""
    from hivae_tpu_torch.cli import a2v_inference
    return a2v_inference.load_spec(A2M_CONFIG)


def build_a2m(tokens, seed=SEED + 40, model_type=None, layers=None):
    """The flagship A2M head with ``motion_num_token`` = ``tokens`` and no
    other field changed (``model_type`` swapped, ``layers`` layers, where
    given), bf16 on the card, seeded random weights."""
    import torch
    from hivae_tpu_torch.cli import a2v_inference

    spec = a2m_spec()
    spec = dict(spec, model=dict(spec["model"], motion_num_token=tokens))
    if layers:
        spec["model"]["diffusion_num_layers"] = layers
    if model_type:
        spec["model_type"] = model_type
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    a2m = a2v_inference.build_a2m(spec, "cuda", torch.bfloat16).eval()
    n = sum(p.numel() for p in a2m.parameters())
    _log(f"  A2M head ({spec['model_type']}, motion_num_token {tokens}): "
         f"{n / 1e6:.1f} M params, bf16, built in "
         f"{time.perf_counter() - t0:.1f} s")
    return a2m


def a2v_inputs():
    """The reference frame's pixels (3, 256, 256) in [-1, 1] and a
    synthetic whisper embedding (A2V_FRAMES, 50, 384) from a numpy seed,
    on the card."""
    import numpy as np
    import torch
    spec = a2m_spec()["model"]
    rng = np.random.RandomState(SEED + 41)
    emb = rng.randn(A2V_FRAMES, spec["audio_block"],
                    spec["audio_inchannel"]).astype(np.float32)
    pixels = synthetic_clip(SEED + 42, 1)[0][0]
    return torch.from_numpy(pixels).cuda(), torch.from_numpy(emb).cuda()


def _a2v_launches(amd_cfg, a2m_cfg=None, frames=A2V_FRAMES - 1,
                  video_steps=A2V_VIDEO_STEPS,
                  motion_steps=A2V_MOTION_STEPS, extract=False,
                  int8=False, a2m_ffns=2):
    """Launches of one A2V run over ``frames`` driven frames: the object
    encoder's layers (4 + 256 tokens) once on the 8 padded reference
    frames, once a window on its reference frame and, with
    ``need_motion_extract_model``, once more a window after the first on
    the previous 8 generated latents; the DiT's object joint block (4 + 4
    + 256 tokens) per layer and video step of each window (the camera
    stream is off, the per-pixel temporal blocks' 16 tokens stay plain);
    one streaming forward for the VAE encode of the reference frames and
    one for the decode of the clip. The A2M head's attentions (68 tokens;
    4 queries against 32 keys) stay plain and uncounted. In int8 the
    fused FFN-up runs in each of the A2M head's ``a2m_ffns`` FFNs a layer
    (the cross head's self- and cross-attention blocks: 2; the
    LearnableToken head's joint block: 1) per motion step and in the
    DiT's object joint and temporal blocks per video step."""
    enc, dit = amd_cfg.object_enc_num_layers, amd_cfg.diffusion_num_layers
    windows = -(-frames // WINDOW)
    out = dict(full_block_attention=enc + windows * (enc + dit * video_steps)
               + extract * (windows - 1) * enc, stream_attention=2)
    if int8:
        out["fused_ffn_up_quant"] = windows * (
            a2m_ffns * a2m_cfg.diffusion_num_layers * motion_steps
            + 2 * dit * video_steps)
    return out


class _window_times:
    """CUDA events around each ``pipeline.a2v_window`` call: the windows'
    device spans of the run inside, read after it synchronised."""

    def __enter__(self):
        import torch
        from hivae_tpu_torch.pipelines import pipeline as pipe_mod
        self.mod, self.fn, self.events = pipe_mod, pipe_mod.a2v_window, []

        def timed(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = self.fn(*a, **k)
            end.record()
            self.events.append((start, end))
            return out
        pipe_mod.a2v_window = timed
        return self

    def __exit__(self, *exc):
        self.mod.a2v_window = self.fn

    def ms(self):
        return [s.elapsed_time(e) for s, e in self.events]


def _has_audio(path):
    """True when the container at ``path`` carries an audio stream: an
    AVI's 'auds' stream header and its 01wb chunks, or an mp4's 'soun'
    handler."""
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".avi"):
        return b"auds" in data and b"01wb" in data
    return b"soun" in data


def write_wav(path, seconds, seed=SEED + 43):
    """A seeded 16 kHz 16-bit mono wav of ``seconds`` (a tone and noise)."""
    import wave
    import numpy as np
    n = int(round(seconds * WAV_RATE))
    rng = np.random.RandomState(seed)
    t = np.arange(n) / WAV_RATE
    pcm = (6000 * np.sin(2 * np.pi * 180 * t) + 2000 * rng.randn(n))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(WAV_RATE)
        w.writeframes(np.clip(pcm, -32768, 32767).astype("<i2").tobytes())


def run_a2v(models, card, failures):
    """Phase 3m (bf16, on phase 3's AMD_N and SD-VAE): the A2V clip through
    ``ImageAudio2VideoPipeline.sample_pixels`` (one warm-up, one timed run
    with exact launches and the windows' times, against its run on the
    plain attention versions), one run with ``need_motion_extract_model``,
    then the CLIs (``run_a2v_cli``). Returns {path: launches}."""
    import torch
    from hivae_tpu_torch.pipelines import ImageAudio2VideoPipeline

    amd, vae = models
    a2m = build_a2m(amd.cfg.object_motion_token_num)
    pixels, emb = a2v_inputs()
    shape = (A2V_FRAMES, 3, SIZE, SIZE)
    paths = {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    def pipe(**kw):
        return ImageAudio2VideoPipeline(
            vae, amd, a2m, window=WINDOW, a2m_ref_num_frame=A2V_REF_FRAMES,
            sample_size=SIZE, **kw)

    bf16 = pipe()

    def run():
        return bf16.sample_pixels(pixels, emb, A2V_MOTION_STEPS,
                                  A2V_VIDEO_STEPS, gen())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _window_times() as windows:
        out, paths["a2v"], latency = _timed_path(
            "A2V clip (bf16)", run, vae, shape, _a2v_launches(amd.cfg),
            failures)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    win = windows.ms()[-3:]
    _log(f"  A2V clip (bf16): {latency * 1e3:.2f} ms, "
         f"{(A2V_FRAMES - 1) / latency:.2f} generated frames/s; windows "
         f"(CUDA events) {' '.join(f'{w:.2f}' for w in win)} ms; peak "
         f"device memory {peak:.2f} GiB (models included); {card}")
    with _plain_kernels():
        ref = run()
    _clip_diff("A2V clip vs the same run on the plain attention versions",
               out, ref, failures)
    del ref

    extract = pipe(need_motion_extract_model=True)
    reex, paths["a2v_motion_extract"], _ = _timed_path(
        "A2V clip, need_motion_extract_model", lambda: extract.sample_pixels(
            pixels, emb, A2V_MOTION_STEPS, A2V_VIDEO_STEPS, gen()), vae,
        shape, _a2v_launches(amd.cfg, extract=True), failures, warm=False)
    # window 0 has no generated video to re-extract from: its frames (and
    # the reference's) are the same run's; later windows differ
    first = WINDOW + 1
    same = torch.equal(reex[:first], out[:first])
    moved, _ = _clip_diff("A2V clip with need_motion_extract_model vs "
                          "without, windows after the first", reex[first:],
                          out[first:])
    if not (same and moved > 0):
        failures.append(f"need_motion_extract_model: window 0 equal {same}, "
                        f"later windows' distance {moved}")
    del reex, extract, bf16
    paths.update(run_a2v_cli(amd, a2m, failures))
    del a2m
    torch.cuda.empty_cache()
    return paths, out, latency


def run_a2v_cli(amd, a2m, failures):
    """Phase 3m, the CLIs: ``cli.get_whisper_emb`` on a synthetic mp4 and
    its wav, then ``cli.a2v_inference`` end to end on reference-named
    ``.safetensors`` of AMD_N and of the A2M head written here from the
    random weights, with ``--audio_wav``: the container read back (frame
    count and size by OpenCV, an audio stream in it) and exact launches;
    then the shipped A2M yaml as it is (``motion_num_token`` 1 against
    AMD_N's 4 tokens a frame), which must end in the port's ValueError.
    Returns {path: launches}."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import a2v_inference, get_whisper_emb
    from hivae_tpu_torch.data import video as vio

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_a2v")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "videos"))
    try:
        import cv2
        rgb, _ = synthetic_clip(SEED + 44, A2V_FRAMES)
        frames = ((rgb.transpose(0, 2, 3, 1) + 1) * 127.5).clip(0, 255)
        mp4 = os.path.join(work, "videos", "talk.mp4")
        vio.write_video(mp4, frames.astype(np.uint8), fps=A2V_FPS)
        wav = os.path.join(work, "videos", "talk.wav")
        write_wav(wav, A2V_FRAMES / A2V_FPS)
        ref_png = os.path.join(work, "ref.png")
        cv2.imwrite(ref_png, cv2.cvtColor(frames[0].astype(np.uint8),
                                          cv2.COLOR_RGB2BGR))
        t0 = time.perf_counter()
        rc = get_whisper_emb.main(["--video_dir", os.path.join(work, "videos"),
                                   "--output_dir", work])
        emb = np.load(os.path.join(work, "talk.npy"))
        spec = a2m_spec()["model"]
        want = (A2V_FRAMES, spec["audio_block"], spec["audio_inchannel"])
        _log(f"  cli.get_whisper_emb: rc {rc}, {emb.shape} {emb.dtype}, "
             f"finite {bool(np.isfinite(emb).all())}, "
             f"{time.perf_counter() - t0:.1f} s")
        if rc != 0 or emb.shape != want or not np.isfinite(emb).all():
            failures.append(f"cli.get_whisper_emb: rc {rc}, {emb.shape}")

        amd_st, a2m_st = (os.path.join(work, f) for f in (
            "amd_n.safetensors", "a2m.safetensors"))
        write_safetensors(amd_st, _reference_named(amd))
        write_safetensors(a2m_st, _reference_named(a2m))
        a2m_json = os.path.join(work, "a2m.json")
        with open(a2m_json, "w") as f:
            json.dump(dict(a2m_spec(), model=a2m.cfg.to_dict()), f)
        out = os.path.join(work, "out", "talk.mp4")
        argv = ["--amd_config", CONFIG, "--amd_ckpt", amd_st,
                "--a2m_ckpt", a2m_st, "--ref_image", ref_png,
                "--audio_emb", os.path.join(work, "talk.npy"),
                "--audio_wav", wav, "--output", out,
                "--motion_sample_step", str(A2V_CLI_STEPS),
                "--video_sample_step", str(A2V_CLI_STEPS)]
        printed = io.StringIO()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = a2v_inference.main(argv + ["--a2m_config", a2m_json])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = _read_counts()
        line = [x for x in printed.getvalue().splitlines()
                if x.startswith("generated")]
        written = line[0].split(" -> ")[1].split(" (")[0] if line else None
        total = size = None
        if written and os.path.exists(written):
            cap = cv2.VideoCapture(written)
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            size = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                    int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
            cap.release()
        audio = bool(written) and _has_audio(written)
        want = dict(_no_launches(), **_a2v_launches(
            amd.cfg, video_steps=A2V_CLI_STEPS, motion_steps=A2V_CLI_STEPS))
        _log(f"  cli.a2v_inference: rc {rc}, printed {line}, read back "
             f"{total} frames of {size}, audio stream {audio}, "
             f"{cli_s:.1f} s with the models' load; launches "
             f"{ {k: v for k, v in launches.items() if v} }")
        if not (rc == 0 and total == A2V_FRAMES and size == (SIZE, SIZE)
                and audio and launches == want):
            failures.append(f"cli.a2v_inference: rc {rc}, {line}, frames "
                            f"{total} {size}, audio {audio}, launches "
                            f"{launches}, want {want}")

        # the shipped yaml as it is: 1 token a frame in its position table
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                a2v_inference.main(argv + ["--a2m_config", A2M_CONFIG,
                                           "--output",
                                           os.path.join(work, "x.mp4")])
            err = None
        except ValueError as e:
            err = str(e)
        _log(f"  cli.a2v_inference with {os.path.relpath(A2M_CONFIG, ROOT)} "
             f"as shipped: ValueError {err!r}")
        if not err or "motion_num_token 1" not in err:
            failures.append(f"shipped A2M config: no token-count ValueError "
                            f"({err!r})")
        return {"a2v_cli": launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_a2v_int8(card, failures, model_type=None):
    """Phase 3m (and 3n with ``model_type`` A2MModel_LearnableToken), the
    int8 leg (after phase 3b, on AMD_N, the SD-VAE and the A2M head built
    again from their seeds, at full width and INT8_A2V_DEPTH): the A2V
    clip in bf16 (the int8 run's yardstick), then through
    ``ImageAudio2VideoPipeline(quant="int8")``
    with all three tables (warm-up, timed run with exact launches), held
    to its run with the plain FFN-up version (phase 3's tolerances) and,
    as phase 3b holds the int8 clip, to its run on all plain versions
    within ``CLIP_INT8_NOISE_RATIO`` times that run's distance from bf16.
    Returns {path: launches}."""
    import gc
    import torch
    from hivae_tpu_torch.pipelines import ImageAudio2VideoPipeline

    amd, vae = build_serving_models(INT8_A2V_DEPTH)
    a2m = build_a2m(amd.cfg.object_motion_token_num, model_type=model_type,
                    layers=A2M_CLI_LAYERS)
    label = "A2V clip" if model_type is None else f"A2V clip, {model_type}"
    joint = model_type in A2M_HEAD_TYPES
    pixels, emb = a2v_inputs()

    def run(pipe):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return pipe.sample_pixels(pixels, emb, A2V_MOTION_STEPS,
                                  A2V_VIDEO_STEPS, gen)
    kw = dict(window=WINDOW, a2m_ref_num_frame=A2V_REF_FRAMES,
              sample_size=SIZE)
    t0 = time.perf_counter()
    bf16 = run(ImageAudio2VideoPipeline(vae, amd, a2m, **kw))
    torch.cuda.synchronize()
    bf16_latency = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = ImageAudio2VideoPipeline(vae, amd, a2m, quant="int8", **kw)
    torch.cuda.synchronize()
    _log(f"  int8 tables: DiT {len(pipe.quant_table)}, VAE decoder "
         f"{len(pipe.vae_quant_table)}, A2M {len(pipe.a2m_quant_table)} "
         f"layers, built and stripped in {time.perf_counter() - t0:.2f} s")
    shape = (A2V_FRAMES, 3, SIZE, SIZE)
    out, launches, latency = _timed_path(
        f"{label} (int8)", lambda: run(pipe), vae, shape,
        _a2v_launches(amd.cfg, a2m.cfg, int8=True,
                      a2m_ffns=1 if joint else 2), failures)
    with _plain_kernels(("fused_ffn_up_quant",)):
        ref = run(pipe)
    _clip_diff(f"int8 {label} vs the same with the plain FFN-up version",
               out, ref, failures)
    with _plain_kernels():
        ref = run(pipe)
    to_plain, _ = _clip_diff(f"int8 {label} vs the same on all plain "
                             "versions", out, ref)
    noise, _ = _clip_diff(f"int8 {label} on all plain versions vs the bf16 "
                          "run", ref, bf16)
    if not to_plain <= CLIP_INT8_NOISE_RATIO * noise:
        failures.append(f"int8 {label} vs all plain versions: mean "
                        f"{to_plain}, more than {CLIP_INT8_NOISE_RATIO} x "
                        f"their run's distance {noise} from the bf16 clip")
    _log(f"  {label} latency: bf16 {bf16_latency * 1e3:.2f} ms "
         f"({(A2V_FRAMES - 1) / bf16_latency:.2f} frames/s), int8 "
         f"{latency * 1e3:.2f} ms ({(A2V_FRAMES - 1) / latency:.2f} "
         f"frames/s); {card}")
    del amd, vae, a2m, pipe, out, ref, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return {"a2v_int8" if model_type is None else
            f"a2v_int8_{A2M_HEAD_TYPES[model_type]}": launches}


# -- the other A2M heads (phases 3n-3p) ---------------------------------------


def run_a2v_heads(models, card, failures):
    """Phase 3n (bf16, on ``models``: AMD_N at EXPORT_DEPTH and the
    SD-VAE): phase 3m's A2V clip with each head of ``A2M_HEAD_TYPES`` (the
    flagship yaml with ``model_type`` swapped, at A2M_CLI_LAYERS layers:
    both cut from the full depth when the parallel phases 8e-8g took the
    script to 934 s): one warm-up and one timed run with exact
    launches (the heads' own attentions, 84 tokens, stay plain and
    uncounted), against its run on the plain attention versions (phase
    3's tolerances). Returns {path: launches}."""
    import torch
    from hivae_tpu_torch.pipelines import ImageAudio2VideoPipeline

    amd, vae = models
    pixels, emb = a2v_inputs()
    shape = (A2V_FRAMES, 3, SIZE, SIZE)
    paths = {}
    for model_type, short in A2M_HEAD_TYPES.items():
        a2m = build_a2m(amd.cfg.object_motion_token_num,
                        model_type=model_type, layers=A2M_CLI_LAYERS)
        pipe = ImageAudio2VideoPipeline(
            vae, amd, a2m, window=WINDOW, a2m_ref_num_frame=A2V_REF_FRAMES,
            sample_size=SIZE)

        def run():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            return pipe.sample_pixels(pixels, emb, A2V_MOTION_STEPS,
                                      A2V_VIDEO_STEPS, gen)
        label = f"A2V clip, {model_type} (bf16)"
        out, paths[f"a2v_{short}"], latency = _timed_path(
            label, run, vae, shape, _a2v_launches(amd.cfg), failures)
        _log(f"  {label}: {latency * 1e3:.2f} ms, "
             f"{(A2V_FRAMES - 1) / latency:.2f} generated frames/s; {card}")
        with _plain_kernels():
            ref = run()
        _clip_diff(f"{label} vs the same on the plain attention versions",
                   out, ref, failures)
        del a2m, pipe, out, ref
        torch.cuda.empty_cache()
    return paths


def _grid_inputs(n, gen):
    """Reference image latents (n, 4, 32, 32) and whisper-like features
    (n, GRID_FRAMES, 50, 384) on the card."""
    import torch
    return (torch.randn((n, 4, 32, 32), generator=gen, device="cuda"),
            torch.randn((n, GRID_FRAMES, 50, 384), generator=gen,
                        device="cuda"))


def run_grid_head(card, failures):
    """Phase 3o: the grid head (``A2MModelMlp`` at the ``A2MConfig``
    defaults, seeded random weights). ``sample_grid`` in bf16 at N = 1,
    GRID_STEPS steps: one warm-up and one timed run with exact launches
    (a full-block forward a layer and step over GRID_TOKENS tokens),
    finite, within GRID_REL_L2 of its run on the plain attention versions.
    Then its training loss at N = GRID_LOSS_CLIPS with fp32 weights under
    bf16 autocast, forward and backward (timestep and noise fixed): exact
    launches (a forward, a delta pre-pass and a backward a layer) and,
    against the same on the plain versions, loss within STEP_LOSS_RTOL and
    gradient cosine at least STEP_GRAD_COS. Returns {path: launches}."""
    import torch
    from hivae_tpu_torch.models import a2m as a2m_mod

    cfg = a2m_mod.A2MConfig()
    layers = cfg.diffusion_num_layers
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    torch.manual_seed(SEED + 50)
    head = a2m_mod.A2MModelMlp(cfg, device="cuda", dtype=torch.float32)
    n = sum(p.numel() for p in head.parameters())
    _log(f"  grid head (A2MModelMlp, A2MConfig defaults): {n / 1e6:.1f} M "
         f"params, joint block over {GRID_TOKENS} tokens")
    paths = {}

    sampler = a2m_mod.A2MModelMlp(cfg, device="cuda", dtype=torch.bfloat16)
    sampler.load_state_dict(head.state_dict())
    sampler.eval()
    ref_img, audio = _grid_inputs(1, gen)

    def sample():
        g = torch.Generator(device="cuda").manual_seed(SEED + 51)
        return a2m_mod.sample_grid(sampler, ref_img, audio,
                                   sample_step=GRID_STEPS, generator=g)
    sample()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = sample()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    paths["grid_sample"] = launches = _read_counts()
    want = dict(_no_launches(), full_block_attention=layers * GRID_STEPS)
    with _plain_kernels():
        ref = sample()
    rel = ((out - ref).norm() / ref.norm()).item()
    shape = (1, GRID_FRAMES, cfg.motion_in_channel, cfg.motion_height,
             cfg.motion_width)
    finite = bool(torch.isfinite(out).all())
    _log(f"  sample_grid (bf16, N=1, {GRID_STEPS} steps) "
         f"{tuple(out.shape)}: {ms:.2f} ms; vs plain attention rel L2 "
         f"{rel:.3g}; finite {finite}; launches "
         f"{ {k: v for k, v in launches.items() if v} }; {card}")
    if not (launches == want and tuple(out.shape) == shape and finite
            and rel <= GRID_REL_L2):
        failures.append(f"sample_grid: launches {launches} want {want}, "
                        f"shape {tuple(out.shape)}, finite {finite}, rel "
                        f"{rel}")
    del sampler, out, ref

    nb = GRID_LOSS_CLIPS
    ref_img, audio = _grid_inputs(nb, gen)
    motion = torch.randn((nb,) + shape[1:], generator=gen, device="cuda")
    noise = torch.randn(motion.shape, generator=gen, device="cuda")
    ts = torch.randint(0, cfg.num_step + 1, (nb,), generator=gen,
                       device="cuda")
    params = list(head.parameters())

    def loss_and_grads():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = head(motion, ref_img, audio, time_step=ts,
                        noise=noise)["loss"]
        return loss.detach(), torch.autograd.grad(loss, params)
    loss_and_grads()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    lk, gk = loss_and_grads()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    paths["grid_loss"] = launches = _read_counts()
    want = dict(_no_launches(), full_block_attention=layers,
                full_block_attention_delta=layers,
                full_block_attention_bwd=layers)
    with _plain_kernels():
        lp, gp = loss_and_grads()
    rel = abs(lk.item() - lp.item()) / abs(lp.item())
    dot = sum((a.float() * b.float()).sum() for a, b in zip(gk, gp)).item()
    nk = sum(a.float().square().sum() for a in gk).item() ** 0.5
    npl = sum(b.float().square().sum() for b in gp).item() ** 0.5
    cos = dot / (nk * npl)
    _log(f"  grid head loss, forward and backward (N={nb}): {ms:.2f} ms; "
         f"loss {lk.item():.6f} vs plain {lp.item():.6f} (rel {rel:.3g}), "
         f"grad norm {nk:.5f} vs {npl:.5f}, cosine {cos:.6f}; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    if not (launches == want and rel <= STEP_LOSS_RTOL
            and cos >= STEP_GRAD_COS):
        failures.append(f"grid head loss: launches {launches} want {want}, "
                        f"loss rel {rel}, gradient cosine {cos}")
    del head, gk, gp
    torch.cuda.empty_cache()
    return paths


def run_vis_cli(card, failures):
    """Phase 3p: ``python -m hivae_tpu_torch.cli.vis`` in this process on
    the shipped PosePre yaml written out as json (random weights from seed
    0), VIS_PAIRS synthetic pose mp4s and embeddings of VIS_FRAMES + 3
    frames. fp32 as the JAX CLI: the SD-VAE's two mid-block attentions
    (the reference poses' encode, the predicted poses' decode) launch the
    fp32 streaming kernel, 2 launches exactly, ``sdpa_plain`` 0 and no
    other kernel. The video handed to the writer: (VIS_FRAMES, 3, 256,
    VIS_PAIRS x 256) uint8, the decoded pixels finite before
    quantisation. Returns {path: launches}."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import a2v_inference, vis
    from hivae_tpu_torch.data import video as vio
    from hivae_tpu_torch.models import vae as vae_mod

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_vis")
    shutil.rmtree(work, ignore_errors=True)
    for sub in ("emb", "poses"):
        os.makedirs(os.path.join(work, sub))
    spec = a2v_inference.load_spec(A2M_POSEPRE_CONFIG)
    cfg = spec["model"]
    with open(os.path.join(work, "posepre.json"), "w") as f:
        json.dump(spec, f)
    write_training_videos(os.path.join(work, "poses"), count=VIS_PAIRS,
                          frames=VIS_FRAMES + 3)
    rng = np.random.RandomState(SEED + 60)
    for i in range(VIS_PAIRS):
        np.save(os.path.join(work, "emb", f"train{i}.npy"), rng.randn(
            VIS_FRAMES + 3, cfg["audio_block"],
            cfg["audio_inchannel"]).astype(np.float32))
    written, finite = [], []
    write, decode = vio.write_video, vae_mod.vae_decode

    def record(path, video, *a, **k):
        written.append(np.asarray(video))
        return write(path, video, *a, **k)

    def checked(*a, **k):
        out = decode(*a, **k)
        finite.append(bool(torch.isfinite(out).all()))
        return out
    out_path = os.path.join(work, "vis.mp4")
    argv = ["--a2m_config", os.path.join(work, "posepre.json"),
            "--audio_emb_dir", os.path.join(work, "emb"),
            "--pose_video_dir", os.path.join(work, "poses"),
            "--output_path", out_path, "--batch", str(VIS_PAIRS),
            "--sample_frames", str(VIS_FRAMES)]
    try:
        vio.write_video, vae_mod.vae_decode = record, checked
        np.random.seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = vis.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        vio.write_video, vae_mod.vae_decode = write, decode
        shutil.rmtree(work, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict(_no_launches(), stream_attention_f32=2)
    shape = (VIS_FRAMES, 3, SIZE, VIS_PAIRS * SIZE)
    got = tuple(written[0].shape) if written else None
    _log(f"  cli.vis (PosePre yaml, fp32, {VIS_PAIRS} pairs of "
         f"{VIS_FRAMES} frames): rc {rc}, grid {got} "
         f"{written[0].dtype if written else None}, decoded finite "
         f"{finite}; {wall:.1f} s with the models' build, peak "
         f"{peak:.2f} GiB; launches "
         f"{ {k: v for k, v in launches.items() if v} }; {card}")
    if not (rc == 0 and got == shape and written[0].dtype == np.uint8
            and finite == [True] and launches == want):
        failures.append(f"cli.vis: rc {rc}, grid {got} want {shape}, "
                        f"finite {finite}, launches {launches} want {want}")
    torch.cuda.empty_cache()
    return {"vis_cli": launches}


# -- the long tail (phases 3s-3v) ----------------------------------------------

# cli.frequency_filter_decode: the fp32 kernel's bands against the plain
# version's, in uint8 levels (fp32 sums in another order: a value on a
# rounding edge may move one level)
FREQ_MAX_LEVELS = 1
# cli.evaluate on EVAL_VIDEOS clips at the JAX CLI's default 20 steps, bf16,
# against its run on the plain attention versions (P rounded to bf16 at
# other points over 20 Euler steps of random weights): PSNR in dB, SSIM and
# LPIPS absolute
EVAL_VIDEOS, EVAL_STEPS = 2, 20
EVAL_PSNR_ATOL, EVAL_SSIM_ATOL, EVAL_LPIPS_ATOL = 0.25, 0.01, 0.01
# the unused DiTs and rope_attention in bf16 against their plain runs; the
# DiTs at their default widths and a cut depth (no model builds them)
LONGTAIL_REL_L2 = 2e-2
LONGTAIL_LAYERS = 2
# cli.export_sampler's module, exported at full width: Euler steps. Cut
# from the CLI's 10: torch.export's trace, save and load grow with the
# graph (H100 80GB HBM3 host, bf16: 44,482 nodes at 10 steps traced in
# 116.9 s, saved in 61.9, loaded in 83.5; 7,176 nodes at 1 step in 23.2,
# 14.6 and 11.4), and at 10 steps the two exports alone would take
# this script past its time limit; one step still runs the whole chain
# (encode, motion, a velocity call, decode) through the kernels' ops. Both
# exports run AMD_N at full width and a cut depth, EXPORT_DEPTH, on one
# model built for them: at full depth
# the int8 export's 15,411 nodes took 68.1 s to trace, 17.9 to save and
# 25.1 to load (cut when the fp32 phases took the script to 764.8 s), the
# bf16 export's 7,177 nodes 17.1, 13.8 and 15.8 s (cut when the script
# read 790.2 s, 10 s under its 800 s target); then from 2 + 2 encoder and
# 2 DiT layers to 1 + 1 and 1 (53.7 s of the script for both exports) when
# the fp16 and head-dim phases took it to 830 s
EXPORT_STEPS = 1
EXPORT_DEPTH = dict(object_enc_num_layers=1, camera_enc_num_layers=1,
                    diffusion_num_layers=1)
# the int8 A2V clips (phases 3m, 3n) run AMD_N and the A2M heads at full
# width and a cut depth: AMD_N at EXPORT_DEPTH, the heads at
# A2M_CLI_LAYERS (cut from the full depth, 72 s of the script, when the
# parallel phases 8e-8g took it to 934 s); phase 3m's bf16 A2V clip keeps
# the full depth
INT8_A2V_DEPTH = EXPORT_DEPTH


def _counted_run(fn):
    """(fn(), launches): the counters set to 0 just before, read after."""
    import torch
    _zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _read_counts()


def run_frequency_decode_cli(card, failures):
    """Phase 3s: ``cli.frequency_filter_decode`` in this process on one
    synthetic 256^2 mp4 of WINDOW frames, in ``fft`` and ``wavelet``
    modes, the VAE in fp32 (seed 0) as the JAX CLI builds it: its
    mid-block attention takes the fp32 streaming kernel, once for the
    encode and once a band (3 and 5 launches), nothing else launches and
    ``sdpa_plain`` reads 0; each band's frames within FREQ_MAX_LEVELS of
    the same run on the plain attention version. Returns {path:
    launches}."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import frequency_filter_decode as freqdec
    from hivae_tpu_torch.data import video as vio

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_freq")
    shutil.rmtree(work, ignore_errors=True)
    write_training_videos(work, count=1, frames=WINDOW + 2)
    paths, write = {}, vio.write_video
    try:
        for mode, bands in (("fft", 2), ("wavelet", 4)):
            argv = ["--video_path", os.path.join(work, "train0.mp4"),
                    "--output_dir", os.path.join(work, mode), "--frames",
                    str(WINDOW), "--mode", mode]
            runs = []
            for plain in (False, True):
                frames = []
                vio.write_video = lambda path, video, *a, **k: (
                    frames.append(np.asarray(video)), write(path, video, *a,
                                                            **k))[1]
                ctx = _plain_kernels() if plain else contextlib.nullcontext()
                t0 = time.perf_counter()
                with ctx, contextlib.redirect_stdout(io.StringIO()):
                    _, launches = _counted_run(lambda: freqdec.main(argv))
                runs.append((frames, launches, time.perf_counter() - t0))
            (frames, launches, wall), (ref, _, _) = runs
            want = dict(_no_launches(), stream_attention_f32=1 + bands)
            diff = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                       for a, b in zip(frames, ref)) if ref else None
            shapes = {tuple(f.shape) for f in frames}
            _log(f"  cli.frequency_filter_decode --mode {mode}: {len(frames)}"
                 f" bands {shapes} uint8, {wall:.1f} s with the VAE's build; "
                 f"max|diff| vs plain attention {diff} levels; launches "
                 f"{ {k: v for k, v in launches.items() if v} }; {card}")
            if not (launches == want and len(frames) == bands == len(ref)
                    and shapes == {(WINDOW, 3, SIZE, SIZE)}
                    and diff <= FREQ_MAX_LEVELS):
                failures.append(f"cli.frequency_filter_decode {mode}: "
                                f"launches {launches} want {want}, {len(frames)}"
                                f" bands {shapes}, max|diff| {diff}")
            paths[f"frequency_decode_{mode}"] = launches
    finally:
        vio.write_video = write
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


def _eval_launches(cfg, clips, steps):
    """``cli.evaluate``'s launches: per clip the object encoder's layers and
    the DiT's two joint blocks a layer a step on the full-block kernel, and
    three streaming forwards (the clip's encode, its grey encode, the
    decode)."""
    enc, dit = cfg.object_enc_num_layers, cfg.diffusion_num_layers
    return dict(_no_launches(), full_block_attention=clips * (
        enc + 2 * dit * steps), stream_attention=clips * 3)


def run_evaluate_cli(card, failures):
    """Phase 3t: ``cli.evaluate`` in this process at full width (AMD_N of
    CONFIG and the SD-VAE in bf16, seeded random weights: the checkpoint
    given holds no key of the model), on EVAL_VIDEOS synthetic mp4s at
    EVAL_STEPS steps with seeded LPIPS weights written under torchvision's
    and the LPIPS heads' names: exact launches, ``sdpa_plain`` 0, finite
    metrics, ``num_videos`` EVAL_VIDEOS, and PSNR, SSIM and LPIPS within
    their tolerances of the run on the plain attention versions. Returns
    {path: launches}."""
    import contextlib
    import io
    import shutil
    import torch
    from hivae_tpu_torch.cli import evaluate
    from hivae_tpu_torch.losses.lpips import LPIPS
    from hivae_tpu_torch.models import amd as amd_mod

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    write_training_videos(os.path.join(work, "videos"), count=EVAL_VIDEOS,
                          frames=WINDOW + 3)
    write_safetensors(os.path.join(work, "none.safetensors"),
                      {"no_key_of_the_model": torch.zeros(1)})
    torch.manual_seed(SEED + 70)
    state = LPIPS().state_dict()
    write_safetensors(os.path.join(work, "vgg16.safetensors"),
                      {k[len("net."):]: v for k, v in state.items()
                       if k.startswith("net.")})
    write_safetensors(os.path.join(work, "head.safetensors"),
                      {f"lin{k}.model.1.weight": state[f"lin{k}.weight"].abs()
                       for k in range(5)})
    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    argv = ["--amd_config", CONFIG, "--amd_ckpt",
            os.path.join(work, "none.safetensors"), "--video_dir",
            os.path.join(work, "videos"), "--sample_step", str(EVAL_STEPS),
            "--lpips_vgg", os.path.join(work, "vgg16.safetensors"),
            "--lpips_head", os.path.join(work, "head.safetensors"),
            "--output_json", os.path.join(work, "result.json")]
    score, clip_s = evaluate.score_clip, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = score(*a, **k)
        clip_s.append(time.perf_counter() - t0)
        return out
    try:
        evaluate.score_clip = timed
        results = []
        for plain in (False, True):
            ctx = _plain_kernels() if plain else contextlib.nullcontext()
            out = io.StringIO()
            t0 = time.perf_counter()
            with ctx, contextlib.redirect_stdout(out):
                res, launches = _counted_run(lambda: evaluate.main(argv))
            results.append((res, launches, time.perf_counter() - t0,
                            out.getvalue()))
            if not plain:
                with open(os.path.join(work, "result.json")) as f:
                    written = json.load(f)
    finally:
        evaluate.score_clip = score
        shutil.rmtree(work, ignore_errors=True)
    (res, launches, wall, text), (ref, _, ref_wall, _) = results
    want = _eval_launches(cfg, EVAL_VIDEOS, EVAL_STEPS)
    lines = [l for l in text.splitlines() if "PSNR" in l or "FAILED" in l]
    _log(f"  cli.evaluate ({EVAL_VIDEOS} clips, {EVAL_STEPS} steps, bf16, "
         f"LPIPS): {res}; {wall:.1f} s with the models' build (plain "
         f"attention {ref_wall:.1f} s), a clip (read, encode, sample, "
         f"decode, metrics) "
         f"{', '.join(f'{x * 1e3:.1f}' for x in clip_s[:EVAL_VIDEOS])} ms "
         f"(plain attention "
         f"{', '.join(f'{x * 1e3:.1f}' for x in clip_s[EVAL_VIDEOS:])}); "
         f"launches "
         f"{ {k: v for k, v in launches.items() if v} }; {card}")
    for line in lines:
        _log(f"    {line}")
    _log(f"  plain-attention run: {ref}")
    close = all(res[k] is not None and ref[k] is not None and
                math.isfinite(res[k]) and abs(res[k] - ref[k]) <= tol
                for k, tol in (("psnr_mean", EVAL_PSNR_ATOL),
                               ("ssim_mean", EVAL_SSIM_ATOL),
                               ("lpips_mean", EVAL_LPIPS_ATOL)))
    if not (launches == want and res["num_videos"] == EVAL_VIDEOS and close
            and written == res):
        failures.append(f"cli.evaluate: {res} vs plain {ref}, launches "
                        f"{launches} want {want}, written {written}")
    torch.cuda.empty_cache()
    return {"evaluate_cli": launches}


def run_longtail_blocks(card, failures):
    """Phase 3u: the modules no model builds, in bf16 on the card at
    widths and token counts above 256^2 logits, seeded: ``rope_attention``
    at (2, 512, 16, 64), ``VelocityDiTSplitInput`` and ``DiT2Condition`` at
    their default widths (20 heads of 64) and ``LONGTAIL_LAYERS`` layers on
    32^2 latents with a 4 x 4 motion grid (528 tokens). Each launches the
    full-block kernel (once, and once a layer; nothing else, ``sdpa_plain``
    0), finite, within LONGTAIL_REL_L2 of its plain-attention run. Returns
    {path: launches}."""
    import torch
    from hivae_tpu_torch.models import dit as dit_mod
    from hivae_tpu_torch.ops import rope

    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    torch.manual_seed(SEED + 81)
    with torch.device("cuda"):
        split = dit_mod.VelocityDiTSplitInput(
            num_layers=LONGTAIL_LAYERS).to(torch.bfloat16).eval()
        two = dit_mod.DiT2Condition(
            num_layers=LONGTAIL_LAYERS).to(torch.bfloat16).eval()
    t = torch.tensor([250.0, 750.0], device="cuda")
    cases = [
        ("rope_attention (2, 512, 16, 64)",
         (randn(2, 512, 16, 64), randn(2, 512, 16, 64),
          randn(2, 512, 16, 64)), rope.rope_attention, 1),
        ("VelocityDiTSplitInput (528 tokens)",
         (randn(2, 128, 4, 4), randn(2, 8, 32, 32), t), split,
         LONGTAIL_LAYERS),
        ("DiT2Condition (528 tokens)",
         (randn(2, 4, 32, 32), randn(2, 4, 32, 32), randn(2, 128, 4, 4), t),
         two, LONGTAIL_LAYERS)]
    paths = {}
    for label, args, fn, n in cases:
        with torch.no_grad():
            out, launches = _counted_run(lambda: fn(*args))
            with _plain_kernels():
                ref = fn(*args)
        rel = _rel_l2(out, ref)
        want = dict(_no_launches(), full_block_attention=n)
        _log(f"  {label}: {tuple(out.shape)} {out.dtype}, rel L2 vs plain "
             f"{rel:.3g}, launches "
             f"{ {k: v for k, v in launches.items() if v} }; {card}")
        if not (launches == want and bool(torch.isfinite(out).all())
                and rel <= LONGTAIL_REL_L2):
            failures.append(f"{label}: launches {launches} want {want}, "
                            f"rel L2 {rel}")
        paths[label.split(" ")[0]] = launches
    del split, two
    torch.cuda.empty_cache()
    return paths


def run_export_sampler(models, quant, card, failures):
    """Phase 3v: ``cli.export_sampler``'s module at full width (AMD_N,
    WINDOW frames at 256^2, EXPORT_STEPS steps; ``quant="int8"`` builds the
    tables and strips the models' covered float weights): exported with
    ``torch.export``, saved, loaded, and run on the same inputs (phase 3's
    clip, its grey clip, seeded start noise) as the live module. The
    loaded program's uint8 frames against the live run's (equal, or the
    largest difference logged and gated by phase 3's tolerances), and its
    launches of every kernel equal to the live run's and to the clip's
    formula. Returns {path: launches}."""
    import shutil
    import torch
    from hivae_tpu_torch.cli import export_sampler as ex

    amd, vae = models
    label = f"export_{quant or 'bf16'}"
    work = os.path.join(ROOT, "hivae_tpu_torch", "build",
                        "chip_smoke_export")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, f"{label}.pt2")
    rgb, grey = synthetic_clip()
    _, _, noise = ex.example_inputs(amd, WINDOW, SIZE, "cuda", seed=SEED)
    inputs = (torch.from_numpy(rgb).cuda(), torch.from_numpy(grey).cuda(),
              noise)
    try:
        t0 = time.perf_counter()
        sampler = ex.build_sampler(vae, amd, EXPORT_STEPS, quant)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = ex.export(sampler, inputs)
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.export.save(program, path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        del program
        t0 = time.perf_counter()
        loaded = torch.export.load(path).module()
        load_s = time.perf_counter() - t0
        ops = sorted({str(n.target) for n in loaded.graph.nodes
                      if "hivae" in str(n.target)})
        with torch.no_grad():
            live, live_launches = _counted_run(lambda: sampler(*inputs))
            t0 = time.perf_counter()
            got, launches = _counted_run(lambda: loaded(*inputs))
            run_s = time.perf_counter() - t0
        nodes = len(loaded.graph.nodes)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cfg = amd.cfg
    want = dict(_no_launches(), full_block_attention=(
        cfg.object_enc_num_layers + 2 * cfg.diffusion_num_layers *
        EXPORT_STEPS), stream_attention=3)
    if quant:
        want["fused_ffn_up_quant"] = 3 * cfg.diffusion_num_layers * \
            EXPORT_STEPS
    diff = (got.int() - live.int()).abs().max().item()
    _log(f"  {label} ({EXPORT_STEPS} steps): built {build_s:.1f} s, traced "
         f"{trace_s:.1f} s ({nodes} nodes; custom ops {ops}), saved "
         f"{save_s:.1f} s ({size / 1e6:.1f} MB), loaded {load_s:.1f} s, "
         f"run {run_s * 1e3:.1f} ms; output {tuple(got.shape)} {got.dtype}, "
         f"max|diff| vs live {diff} levels; launches "
         f"{ {k: v for k, v in launches.items() if v} }; {card}")
    if diff:
        _clip_diff(f"{label} vs live", got, live, failures)
    if not (launches == live_launches == want and got.dtype == torch.uint8
            and tuple(got.shape) == (WINDOW + 1, 3, SIZE, SIZE)):
        failures.append(f"{label}: launches {launches} live {live_launches} "
                        f"want {want}, {tuple(got.shape)} {got.dtype}")
    del sampler, loaded
    torch.cuda.empty_cache()
    return {label: launches}


# -- the dual-encoder AMD family (phases 3j-3l) --------------------------------

# AMD_S and AMD_L as the JAX package's factories build them, with the band
# filters and grey streams of the flagship's serving path
FAMILY_KW = dict(use_filter=True, use_grey=True)
# AMD_S_RecSplit's forward against its run on the plain attention versions:
# relative L2 distance of the predicted latents (bf16 activations through
# 8 encoder and 12 reconstruction layers; P rounded at other points)
REC_REL_L2 = 2e-2


# phase 6b: (label, factory, config over FAMILY_KW, clips, timed steps),
# each after a warm-up step and with the plain-step check, remat full
FAMILY_STEPS = [("AMD_S", "AMD_S", {}, RUN_A_CLIPS, 2),
                ("AMD_S_kl", "AMD_S", dict(use_regularizers=True),
                 RUN_A_CLIPS, 1),
                ("AMD_S_dual", "AMD_S", dict(diffusion_model_type="dual"),
                 RUN_A_CLIPS, 1),
                ("AMD_L", "AMD_L", {}, 1, 1)]


def _dual_launches(cfg, steps=SAMPLE_STEP, encodes=2, decodes=1,
                   encoders=True):
    """Launches of one clip of a dual-encoder AMDModel: each encoder layer
    (12 + 256 tokens over 2T frames) and each joint block of the DiT (26 +
    256 tokens; the dual DiT adds its temporal motion block over T * 26
    tokens, the spatial DiT a per-pixel block over T = 16 tokens, which
    stays plain) run the full-block kernel, each VAE encode and decode one
    streaming forward."""
    per_layer = 2 if cfg.diffusion_model_type == "dual" else 1
    enc = cfg.object_enc_num_layers + cfg.camera_enc_num_layers
    return dict(full_block_attention=(enc if encoders else 0) + per_layer *
                cfg.diffusion_num_layers * steps,
                stream_attention=encodes + decodes)


def build_family_model(name, dtype, seed, **over):
    """``models.amd.AMD_MODELS[name]`` at full width on the card, seeded
    random weights."""
    import torch
    from hivae_tpu_torch.models import amd as amd_mod

    torch.manual_seed(seed)
    t0 = time.perf_counter()
    model = amd_mod.AMD_MODELS[name](device="cuda", dtype=dtype,
                                     **dict(FAMILY_KW, **over))
    n = sum(p.numel() for p in model.parameters())
    _log(f"  {name} {over or ''}: {n / 1e6:.1f} M params, {dtype}, built "
         f"in {time.perf_counter() - t0:.1f} s")
    return model.eval() if dtype == torch.bfloat16 else model


def run_amd_family(failures):
    """Phases 3j-3l: AMD_S (the clip, the diff-motion clip, the GT-motion
    ablation over one window, the clip with the ``dual`` and with the
    ``spatial`` DiT, AMD_S_RecSplit's forward, then the int8 clip) and
    AMD_L (one clip and its peak memory), on a fresh bf16 SD-VAE. Each
    timed run has exact launches (``sdpa_plain`` 0) and agrees with its run
    on the plain attention versions. Returns {path: launches}."""
    import gc
    import torch
    from hivae_tpu_torch.models import vae as vae_mod
    from hivae_tpu_torch.pipelines import (AMDDiffMotionPipeline,
                                           AMDReconstructionPipeline,
                                           GTMotionAblationPipeline)

    bf16 = torch.bfloat16
    torch.manual_seed(SEED)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=bf16).eval()
    paths = {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    rgb, grey = (torch.from_numpy(a).cuda() for a in synthetic_clip())
    crgb, cgrey = (torch.from_numpy(a).cuda()
                   for a in synthetic_clip(SEED + 22))
    clip_shape = (WINDOW + 1, 3, SIZE, SIZE)

    def check(name, label, run, want, shape=clip_shape):
        out, paths[name], latency = _timed_path(label, run, vae, shape, want,
                                                failures)
        with _plain_kernels():
            ref = run()
        _clip_diff(f"{label} vs the same run on the plain attention "
                   "versions", out, ref, failures)
        return out, latency

    _log("phase 3j: AMD_S (dual-encoder AMDModel), bf16")
    amd = build_family_model("AMD_S", bf16, SEED)
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)
    clip, s_latency = check(
        "amd_s_clip", "AMD_S clip", lambda: pipe.sample_pixels(
            rgb, grey, SAMPLE_STEP, gen()), _dual_launches(amd.cfg))
    dpipe = AMDDiffMotionPipeline(vae, amd, window=WINDOW)
    diff, _ = check(
        "amd_s_diff_motion", "AMD_S diff-motion clip (camera from another "
        "clip)", lambda: dpipe.sample_diff_pixels(rgb, grey, cgrey,
                                                  SAMPLE_STEP, gen()),
        _dual_launches(amd.cfg, encodes=3))
    moved, _ = _clip_diff("AMD_S diff-motion clip vs AMD_S clip", diff, clip)
    if not moved > 0:
        failures.append("AMD_S diff-motion clip equals the clip: the camera "
                        "clip moved nothing")
    (gpix,) = (torch.from_numpy(synthetic_clip(SEED + 23)[0]).cuda(),)
    gpipe = GTMotionAblationPipeline(vae, amd, window=WINDOW)
    enc = amd.cfg.object_enc_num_layers
    want = _dual_launches(amd.cfg, encodes=1, encoders=False)
    # the window's extraction and the (ref, ref) pair's, object encoder
    want["full_block_attention"] += 2 * enc
    check("amd_s_refimg", "AMD_S refimg-motion window (GT-motion ablation)",
          lambda: gpipe.reconstruct_pixels(gpix, 1, SAMPLE_STEP, gen()),
          want)
    for dit in ("dual", "spatial"):
        variant = build_family_model("AMD_S", bf16, SEED,
                                     diffusion_model_type=dit)
        vpipe = AMDReconstructionPipeline(vae, variant, window=WINDOW)
        check(f"amd_s_{dit}", f"AMD_S clip, {dit} DiT",
              lambda: vpipe.sample_pixels(rgb, grey, SAMPLE_STEP, gen()),
              _dual_launches(variant.cfg))
        del variant, vpipe
    rec_split(failures, paths)
    gc.collect()
    torch.cuda.empty_cache()

    _log("phase 3k: the int8 AMD_S clip")
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW, quant="int8")
    _log(f"  int8 tables: DiT {len(pipe.quant_table)} layers, VAE decoder "
         f"{len(pipe.vae_quant_table)}")
    want = dict(_dual_launches(amd.cfg), fused_ffn_up_quant=(
        amd.cfg.diffusion_num_layers * SAMPLE_STEP))
    run = lambda: pipe.sample_pixels(rgb, grey, SAMPLE_STEP, gen())  # noqa
    out, paths["amd_s_int8"], latency = _timed_path(
        "AMD_S int8 clip", run, vae, clip_shape, want, failures)
    with _plain_kernels(("fused_ffn_up_quant",)):
        ref = run()
    _clip_diff("AMD_S int8 clip vs the same with the plain FFN-up version",
               out, ref, failures)
    _clip_diff("AMD_S int8 clip vs the AMD_S bf16 clip (random weights)",
               out, clip)
    _log(f"  latency: AMD_S bf16 clip {s_latency * 1e3:.2f} ms, int8 clip "
         f"{latency * 1e3:.2f} ms")
    del amd, pipe, dpipe, gpipe, vae
    gc.collect()
    torch.cuda.empty_cache()

    _log("phase 3l: AMD_L, bf16")
    torch.manual_seed(SEED)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=bf16).eval()
    amd = build_family_model("AMD_L", bf16, SEED)
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)
    torch.cuda.reset_peak_memory_stats()
    check("amd_l_clip", "AMD_L clip", lambda: pipe.sample_pixels(
        rgb, grey, SAMPLE_STEP, gen()), _dual_launches(amd.cfg))
    _log(f"  AMD_L clip: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
         f"(torch.cuda.max_memory_allocated, models included; its plain "
         f"reference run included)")
    del amd, pipe, vae
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def rec_split(failures, paths):
    """AMD_S_RecSplit's forward (no timestep; 8 + 8 encoder layers and 12
    reconstruction layers over 256 + 256 + 26 tokens) on seeded latents:
    exact launches, finite, and within ``REC_REL_L2`` of its run on the
    plain attention versions."""
    import torch

    rec = build_family_model("AMD_S_RecSplit", torch.bfloat16, SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    video, ref = (torch.randn((1, WINDOW, 4, 32, 32), generator=g,
                              device="cuda", dtype=torch.bfloat16)
                  for _ in range(2))
    ref = ref[:, :1].expand(video.shape)
    with torch.no_grad():
        rec(video, ref)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        pre, losses = rec(video, ref)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        paths["amd_s_recsplit"] = launches = _read_counts()
        with _plain_kernels():
            want_pre, _ = rec(video, ref)
    want = dict(_no_launches(), full_block_attention=(
        rec.cfg.object_enc_num_layers * 2 + rec.cfg.diffusion_num_layers))
    dist = ((pre.float() - want_pre.float()).norm() /
            want_pre.float().norm()).item()
    finite = bool(torch.isfinite(pre).all())
    _log(f"  AMD_S_RecSplit forward {tuple(pre.shape)}: {ms:.2f} ms, "
         f"rec_loss {losses['rec_loss'].item():.5f}, rel L2 vs the plain "
         f"attention run {dist:.3g}; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want or not finite or not dist <= REC_REL_L2:
        failures.append(f"AMD_S_RecSplit: launches {launches}, want {want}, "
                        f"finite {finite}, rel L2 {dist}")


COUNTERS = ("full_block_attention", "full_block_attention_qknorm",
            "full_block_attention_bwd", "full_block_attention_delta",
            "stream_attention", "stream_attention_f32",
            "stream_attention_delta",
            "stream_attention_bwd_dq", "stream_attention_bwd_dkv",
            "full_block_attention_f32", "full_block_attention_qknorm_f32",
            "full_block_attention_bwd_f32", "full_block_attention_delta_f32",
            "stream_attention_delta_f32", "stream_attention_bwd_dq_f32",
            "stream_attention_bwd_dkv_f32",
            "full_block_attention_f16", "full_block_attention_qknorm_f16",
            "full_block_attention_bwd_f16", "full_block_attention_delta_f16",
            "stream_attention_f16", "stream_attention_delta_f16",
            "stream_attention_bwd_dq_f16", "stream_attention_bwd_dkv_f16",
            *(f"{n}_wide{sx}" for n in ("stream_attention",
                                        "stream_attention_delta",
                                        "stream_attention_bwd_dq",
                                        "stream_attention_bwd_dkv")
              for sx in ("", "_f16", "_f32")),
            "fused_ffn_up_quant", "sdpa_plain")
# the counter suffix of each kernel dtype's forms
DTYPE_SUFFIX = {"torch.bfloat16": "", "torch.float16": "_f16",
                "torch.float32": "_f32"}


def _sibling_counts(counts, suffix):
    """A path's launches on another dtype's kernels: each named bf16 count
    moved to its sibling's counter (``<name>_f32``, ``<name>_f16``)."""
    moved = {k: v for k, v in counts.items() if v}
    return dict(_no_launches(), **{
        (k if k.endswith(suffix) else f"{k}{suffix}"): v
        for k, v in moved.items()})


def _f32_counts(counts):
    """A path's launches on the fp32 kernels (``_sibling_counts``)."""
    return _sibling_counts(counts, "_f32")


def _wrappers():
    """Each counted kernel wrapper by its counter's name, and ``sdpa``'s
    counted plain path for a call no kernel takes (``sdpa_plain``: 0 on
    every main path)."""
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.ops.kernels import flash_attention as fa
    from hivae_tpu_torch.ops.kernels import quant_ffn as qf
    mods = {"fused_ffn_up_quant": qf, "sdpa_plain": attn_ops}
    return {name: getattr(mods.get(name, fa), name) for name in COUNTERS}


def _no_launches():
    return {name: 0 for name in COUNTERS}


def _zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


class _plain_kernels:
    """The plain versions in place of the forward kernels named (default
    all of them; the sdpa dispatch and the int8 FFN call them through their
    modules), for a reference run."""

    FORWARD = ("full_block_attention", "full_block_attention_qknorm",
               "stream_attention", "fused_ffn_up_quant")

    def __init__(self, names=FORWARD):
        self.names = names

    def __enter__(self):
        from hivae_tpu_torch.ops.kernels import flash_attention as fa
        from hivae_tpu_torch.ops.kernels import quant_ffn as qf
        self.mods = [qf if n == "fused_ffn_up_quant" else fa
                     for n in self.names]
        self.kernels = [getattr(m, n) for m, n in zip(self.mods, self.names)]
        for m, n in zip(self.mods, self.names):
            setattr(m, n, getattr(m, n + "_plain"))

    def __exit__(self, *exc):
        for m, n, fn in zip(self.mods, self.names, self.kernels):
            setattr(m, n, fn)


def build_training_models():
    """Full-width AMD_N with fp32 master weights (remat on, from the JSON),
    the SD-VAE in bf16 (frozen) and LPIPS (fp32, frozen), seeded random
    weights."""
    import torch
    from hivae_tpu_torch.losses.lpips import LPIPS
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.models import vae as vae_mod

    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    torch.manual_seed(SEED + 2)
    amd = amd_mod.AMDModelNew(cfg, device="cuda", dtype=torch.float32)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.bfloat16).eval()
    lpips = LPIPS().cuda().eval()
    for mod in (vae, lpips):
        mod.requires_grad_(False)
    return amd, vae, lpips


def _expected_step_launches(cfg, perceptual: bool, remat=None,
                            dual: bool = False, f32: bool = False,
                            qknorm: bool = False, f16: bool = False):
    """Kernel launches of one training step of the flagship or a variant:
    the object encoder's layers and the DiT's joint blocks (two a layer in
    the spatial DiT, one in the ``default`` TempMotion DiT) run the
    full-block kernels, the DiT's forward twice under remat (``remat``,
    else the config's); each VAE encode (4 with grey clips, else 2) runs
    one streaming forward, and the perceptual leg's decode one more
    streaming forward and its backward: the delta pre-pass and the dQ and
    dK/dV kernels. ``dual``: the dual-encoder AMDModel, whose two encoders'
    layers and each DiT layer's joint block (and the dual DiT's temporal
    motion block) run the full-block kernels. ``f32``: a ``--mp no`` step
    (fp32 compute, an fp32 SD-VAE), whose launches are the fp32 kernels'.
    ``f16``: an fp16 step (fp16 autocast, an fp16 SD-VAE), on the fp16
    forms. ``qknorm``: under ``QKNORM_FUSE``, the forward's calls launch the
    fused qk-norm kernel, and each backward recomputes the unfused forward
    before its delta and backward."""
    remat = cfg.remat if remat is None else remat
    if dual:
        enc = cfg.object_enc_num_layers + cfg.camera_enc_num_layers
        joints = 2 if cfg.diffusion_model_type == "dual" else 1
    else:
        enc = cfg.object_enc_num_layers
        joints = 1 if cfg.diffusion_model_type == "default" else \
            int(cfg.use_object) + int(cfg.use_camera)
    dit = joints * cfg.diffusion_num_layers
    forward = enc + dit * (2 if remat else 1)
    counts = dict(_no_launches(),
                  full_block_attention=enc + dit if qknorm else forward,
                  full_block_attention_qknorm=forward if qknorm else 0,
                  full_block_attention_bwd=enc + dit,
                  full_block_attention_delta=enc + dit,
                  stream_attention=(4 if cfg.use_grey else 2) +
                  int(perceptual),
                  stream_attention_delta=int(perceptual),
                  stream_attention_bwd_dq=int(perceptual),
                  stream_attention_bwd_dkv=int(perceptual))
    if f32:
        return _f32_counts(counts)
    return _sibling_counts(counts, "_f16") if f16 else counts


def run_training(fa, models, failures, *, label, clips, steps,
                 perceptual=False, mask_ratio=None, resume_check=False,
                 profile_dir=None, profile_name="profile_train.txt",
                 unused=(), mp="bf16"):
    """Phases 4, 5, 5c and 6. Every parameter must move in the timed
    steps, except those under the ``unused`` name prefixes, which the
    training forward does not run. ``mp`` "no": fp32 compute (the VAE of
    ``models`` fp32 too), the fp32 kernels' launches, and the fp32 gates
    against the plain-attention step. Under ``QKNORM_FUSE`` the launches
    are the fused qk-norm kernel's. Returns (launches in the timed steps,
    step ms)."""
    import dataclasses
    import shutil
    import torch
    from hivae_tpu_torch.models.amd import AMDModel
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.training.trainer import (AMDTrainer, TrainConfig,
                                                  batch_from_clips)

    amd, vae, lpips = models
    dual = isinstance(amd, AMDModel)
    ckpt_dir = os.path.join(ROOT, "hivae_tpu_torch", "build",
                            "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = TrainConfig(output_dir=ckpt_dir, learning_rate=1e-4,
                     weight_decay=1e-2, max_grad_norm=1.0,
                     mixed_precision=mp, mu_dtype="bf16", seed=SEED,
                     perceptual_weight=0.5 if perceptual else 0.0,
                     camera_mask_ratio=mask_ratio,
                     object_mask_ratio=mask_ratio, checkpoint_total_limit=1)
    trainer = AMDTrainer(amd, vae, tc, lpips=lpips if perceptual else None)
    pairs = [synthetic_clip(SEED + 10 + i) for i in range(clips)]
    batch = trainer._to_device(batch_from_clips([p[0] for p in pairs],
                                                [p[1] for p in pairs]))
    params = list(trainer.state.params.values())
    trained = [p for n, p in trainer.state.params.items()
               if not n.startswith(tuple(unused))] if unused else params

    t0 = time.perf_counter()
    trainer.train_step(batch)   # warm-up
    torch.cuda.synchronize()
    _log(f"  {label}: warm-up step {time.perf_counter() - t0:.2f} s")
    before = [p.detach().clone() for p in trained]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in _expected_step_launches(
        amd.cfg, perceptual, dual=dual, f32=mp == "no",
        qknorm=attn_ops.QKNORM_FUSE).items()}
    if launches != want:
        failures.append(f"{label}: launches {launches}, want {want}")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()) or (
                dual and amd.cfg.use_regularizers and "KLloss" not in m):
            failures.append(f"{label}: metrics {m}")
    moved = sum(bool((p.detach() != b).any()) for p, b in zip(trained,
                                                              before))
    if moved != len(trained):
        failures.append(f"{label}: {len(trained) - moved} of {len(trained)} "
                        f"trained parameter tensors did not change")
    del before
    frames = clips * WINDOW
    _log(f"  {label}: {steps} steps, losses "
         f"{[round(m['loss'], 5) for m in metrics]}, grad_norm "
         f"{[round(m['grad_norm'], 4) for m in metrics]}; step "
         f"{step_s * 1e3:.2f} ms, {clips / step_s:.3f} clips/s, "
         f"{frames / step_s:.2f} frames/s, peak memory "
         f"{peak / 2**30:.2f} GiB; {moved} parameter tensors moved; "
         f"launches {launches}")
    _log(f"  {label}: metrics of the last step {metrics[-1]}")

    # the same step with the plain attention versions, from the same state,
    # batch and draws
    draws = trainer.draw(batch)
    mk, gk = trainer.loss_and_grads(batch, draws)
    with _plain_kernels():
        mp_, gp = trainer.loss_and_grads(batch, draws)
    rel = abs(mk["loss"].item() - mp_["loss"].item()) / abs(
        mp_["loss"].item())
    dot = sum((a * b).sum() for a, b in zip(gk, gp)).item()
    nk = sum(a.square().sum() for a in gk).item() ** 0.5
    npl = sum(b.square().sum() for b in gp).item() ** 0.5
    cos = dot / (nk * npl)
    grad_rel = sum((a - b).square().sum()
                   for a, b in zip(gk, gp)).item() ** 0.5 / npl
    del gk
    control = ""
    if mp == "no":
        # the control: the plain step with its matmuls in TF32, which the
        # gradient gate must reject
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with _plain_kernels():
                mc, gc = trainer.loss_and_grads(batch, draws)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ctl_rel = sum((a - b).square().sum()
                      for a, b in zip(gc, gp)).item() ** 0.5 / npl
        ctl_loss = abs(mc["loss"].item() - mp_["loss"].item()) / abs(
            mp_["loss"].item())
        del gc
        control = (f"; control (plain, TF32 matmuls): loss rel "
                   f"{ctl_loss:.3g}, gradient rel L2 {ctl_rel:.3g}")
    del gp
    _log(f"  {label}: kernel step vs plain-attention step: loss "
         f"{mk['loss'].item():.6f} vs {mp_['loss'].item():.6f} (rel "
         f"{rel:.3g}), grad norm {nk:.5f} vs {npl:.5f}, cosine {cos:.6f}, "
         f"gradient rel L2 {grad_rel:.3g}{control}")
    loss_rtol, grad_cos, grad_l2 = (
        (F32_STEP_LOSS_RTOL, F32_STEP_GRAD_COS, F32_STEP_GRAD_REL_L2)
        if mp == "no" else (STEP_LOSS_RTOL, STEP_GRAD_COS, math.inf))
    if not (rel <= loss_rtol and cos >= grad_cos and grad_rel <= grad_l2):
        failures.append(f"{label}: kernel vs plain step: loss rel {rel}, "
                        f"gradient cosine {cos}, rel L2 {grad_rel}")

    if profile_dir:
        profile_step(trainer, batch, profile_dir, profile_name)

    if resume_check:
        t0 = time.perf_counter()
        path = trainer.save()
        save_s = time.perf_counter() - t0
        trainer.train_step(batch)
        live = [p.detach().clone() for p in params]
        live_step = trainer.global_step
        del trainer
        t0 = time.perf_counter()
        resumed = AMDTrainer(amd, vae, dataclasses.replace(tc, resume=True),
                             lpips=lpips if perceptual else None)
        load_s = time.perf_counter() - t0
        if resumed.global_step != live_step - 1:
            failures.append(f"{label}: resumed at step {resumed.global_step},"
                            f" want {live_step - 1}")
        resumed.train_step(batch)
        diff = max((p.detach() - q).abs().max().item()
                   for p, q in zip(resumed.state.params.values(), live))
        _log(f"  {label}: checkpoint {os.path.basename(path)} saved in "
             f"{save_s:.1f} s, resumed in {load_s:.1f} s; one more step from "
             f"each: max |param diff| {diff}")
        if diff != 0:
            failures.append(f"{label}: resumed step differs from the live "
                            f"step by {diff}")
        del live, resumed
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, step_s * 1e3


def run_training_f32(fa, models, failures):
    """Phase 5c: `--mp no` training of the flagship, as ``cli.train_amd
    --mp no`` runs it: AMD_N's fp32 weights (``models``: full width at
    ``PAR_DEPTH``, remat ``full``) computing in fp32 on an fp32 SD-VAE
    (built here from its seed) and fp32 LPIPS. Run F at N =
    F32_STEP_CLIPS (a warm-up and 2 timed steps), one step with the
    perceptual loss at N = 1 (the
    fp32 streaming backward), one under ``QKNORM_FUSE`` at N = 1 (the fp32
    qk-norm forward): each with exact launches on the fp32 kernels (the
    bf16 counters and ``sdpa_plain`` 0) and held to its plain-attention
    step within F32_STEP_LOSS_RTOL, F32_STEP_GRAD_COS and
    F32_STEP_GRAD_REL_L2 (``run_training``). Returns {path: launches}."""
    import contextlib
    from unittest import mock
    import torch
    from hivae_tpu_torch.models import vae as vae_mod
    from hivae_tpu_torch.ops import attention as attn_ops

    amd, _, lpips = models
    torch.manual_seed(SEED + 6)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.float32).eval()
    vae.requires_grad_(False)
    paths = {}
    for path, label, clips, steps, perceptual, qknorm in (
            ("train_F", "run F (--mp no)", F32_STEP_CLIPS, 2, False, False),
            ("train_F_perceptual", "run F, perceptual loss", 1, 1, True,
             False),
            ("train_F_qknorm", "run F, QKNORM_FUSE", 1, 1, False, True)):
        with (mock.patch.object(attn_ops, "QKNORM_FUSE", True) if qknorm
              else contextlib.nullcontext()):
            paths[path], _ = run_training(
                fa, (amd, vae, lpips), failures, label=label, clips=clips,
                steps=steps, perceptual=perceptual, mp="no")
        torch.cuda.empty_cache()
    return paths


# phase 5d, fp16 training: clips of the step, then of the perceptual and
# QKNORM_FUSE step
F16_STEP_CLIPS = 2


def _f16_step(amd, vae, lpips, failures, *, label, clips, perceptual,
              qknorm):
    """One fp16 loss and gradient of ``amd`` (fp32 master weights computing
    under fp16 autocast, as the JAX package's ``AMD_N(dtype=float16)``
    computes over fp32 params) on the fp16 ``vae``: a warm-up, then one
    timed call with exact launches on the fp16 forms (``sdpa_plain`` 0),
    finite, against the same call on the plain attention versions from the
    same state, batch and draws (``STEP_LOSS_RTOL``, ``STEP_GRAD_COS``).
    Returns the launches."""
    import contextlib
    from unittest import mock
    import torch
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.training.trainer import (AMDTrainer, TrainConfig,
                                                  batch_from_clips)

    tc = TrainConfig(output_dir=os.path.join(ROOT, "hivae_tpu_torch",
                                             "build", "chip_smoke_f16"),
                     mixed_precision="bf16", seed=SEED,
                     perceptual_weight=0.5 if perceptual else 0.0)
    trainer = AMDTrainer(amd, vae, tc, lpips=lpips if perceptual else None)
    trainer._autocast = lambda: torch.autocast(device_type="cuda",
                                               dtype=torch.float16)
    pairs = [synthetic_clip(SEED + 30 + i) for i in range(clips)]
    batch = trainer._to_device(batch_from_clips([p[0] for p in pairs],
                                                [p[1] for p in pairs]))
    draws = trainer.draw(batch)
    with (mock.patch.object(attn_ops, "QKNORM_FUSE", True) if qknorm
          else contextlib.nullcontext()):
        trainer.loss_and_grads(batch, draws)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        mk, gk = trainer.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        with _plain_kernels():
            mp_, gp = trainer.loss_and_grads(batch, draws)
    want = _expected_step_launches(amd.cfg, perceptual, f16=True,
                                   qknorm=qknorm)
    if launches != want:
        failures.append(f"{label}: launches {launches}, want {want}")
    finite = all(math.isfinite(v.item()) for v in mk.values()) and all(
        bool(torch.isfinite(g).all()) for g in gk)
    rel = abs(mk["loss"].item() - mp_["loss"].item()) / abs(
        mp_["loss"].item())
    dot = sum((a * b).sum() for a, b in zip(gk, gp)).item()
    nk = sum(a.square().sum() for a in gk).item() ** 0.5
    npl = sum(b.square().sum() for b in gp).item() ** 0.5
    cos = dot / (nk * npl)
    _log(f"  {label}: loss and gradients {ms:.2f} ms, peak memory "
         f"{peak / 2**30:.2f} GiB; loss {mk['loss'].item():.6f} vs plain "
         f"{mp_['loss'].item():.6f} (rel {rel:.3g}), grad norm {nk:.5f} vs "
         f"{npl:.5f}, cosine {cos:.6f}; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    if not (finite and rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS):
        failures.append(f"{label}: finite {finite}, loss rel {rel}, "
                        f"gradient cosine {cos}")
    return launches


def run_training_f16(amd, lpips, failures):
    """Phase 5d: fp16 training of the flagship (``amd``: full width at
    ``PAR_DEPTH``, fp32 master weights, remat ``full``) on an fp16 SD-VAE
    built from its seed: one loss and gradient at N = F16_STEP_CLIPS (run
    A's launches on the fp16 forward, backward, delta and streaming
    forward kernels), then one at N = 1 with the perceptual loss under
    ``QKNORM_FUSE`` (the fp16 qk-norm forward, and the streaming delta, dQ
    and dK/dV of the decode); ``_f16_step``. Returns {path: launches}."""
    import torch
    from hivae_tpu_torch.models import vae as vae_mod

    torch.manual_seed(SEED + 6)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.float16).eval()
    vae.requires_grad_(False)
    paths = {
        "train_f16": _f16_step(amd, vae, lpips, failures,
                               label="fp16 step", clips=F16_STEP_CLIPS,
                               perceptual=False, qknorm=False),
        "train_f16_perceptual_qknorm": _f16_step(
            amd, vae, lpips, failures,
            label="fp16 step, perceptual loss and QKNORM_FUSE", clips=1,
            perceptual=True, qknorm=True)}
    del vae
    torch.cuda.empty_cache()
    return paths


def profile_step(trainer, batch, out_dir, filename="profile_train.txt"):
    """One training step under torch.profiler (``profile_call``), written
    to DIR/``filename``."""
    profile_call(lambda: trainer.train_step(batch), out_dir, filename,
                 "training step")


def profile_clip(pipe, clip, out_dir, filename="profile_clip.txt"):
    """Five timed clips (the spread of the latency), the stream time spent
    in each stage's module (CUDA events at its forward hooks), and one clip
    under torch.profiler: the kernel table by device time and the device's
    busy share of the clip's wall time. Written to DIR/``filename``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    lines = [f"card: {_card_line()}"]

    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lines.append("clip latency ms, 5 runs: " +
                 " ".join(f"{x:.2f}" for x in lat))

    stages = {"vae.encoder (RGB + grey)": pipe.vae.encoder,
              "object motion encoder": pipe.amd.object_motion_encoder,
              "camera motion encoder": pipe.amd.camera_motion_encoder,
              "velocity DiT (10 steps)": pipe.amd.diffusion_transformer,
              "vae.decoder": pipe.vae.decoder}
    spans = {name: [] for name in stages}
    handles = []
    for name, mod in stages.items():
        def pre(_m, _i, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name].append([ev, None])

        def post(_m, _i, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for h in handles:
        h.remove()
    lines.append(f"stage spans (stream time between module entry and exit) "
                 f"in a {wall:.2f} ms clip:")
    for name, evs in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in evs)
        lines.append(f"  {name}: {ms:.2f} ms over {len(evs)} calls "
                     f"({100 * ms / wall:.1f}%)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    lines.append(f"profiled clip wall {wall * 1e3:.2f} ms, device busy "
                 f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}%)")
    for line in lines:
        _log("  " + line)
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    _log(f"  profile written to {path}")


def run_remat_policies(models, failures):
    """Phase 4b: one run-A step (loss and gradients, no update) under no
    remat and each remat policy, from the same state, batch and draws;
    each against ``full``. A policy that does not fit at N = 4 clips runs
    at N = 2 (with ``full`` again there). Returns {path: launches}."""
    import shutil
    import torch
    from hivae_tpu_torch.training.trainer import (AMDTrainer, TrainConfig,
                                                  batch_from_clips)

    amd, vae, _ = models
    dit = amd.diffusion_transformer
    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_remat")
    trainer = AMDTrainer(amd, vae, TrainConfig(
        output_dir=work, mixed_precision="bf16", mu_dtype="bf16", seed=SEED))
    dev = torch.device("cuda")

    def step(policy, batch, draws):
        """One warm-up call (the allocator's and, for ``dots_offload``,
        the pinned host pool's growth), then the timed call."""
        dit.remat, dit.remat_policy = policy is not None, policy or "full"
        trainer.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rest = torch.cuda.memory_allocated()
        _zero_counts()
        t0 = time.perf_counter()
        metrics, grads = trainer.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (metrics["loss"].item(), grads, ms, _read_counts(),
                torch.cuda.max_memory_allocated(), rest)

    done, paths = {}, {}
    try:
        for clips in (RUN_A_CLIPS, 2):
            todo = [p for p in REMAT_POLICIES if p not in done]
            if not todo:
                break
            pairs = [synthetic_clip(SEED + 10 + i) for i in range(clips)]
            batch = trainer._to_device(batch_from_clips(
                [p[0] for p in pairs], [p[1] for p in pairs]))
            draws = trainer.draw(batch)
            ref = None
            for policy in ["full"] + [p for p in todo if p != "full"]:
                name = policy or "none"
                try:
                    loss, grads, ms, launches, peak, rest = step(
                        policy, batch, draws)
                except torch.cuda.OutOfMemoryError:
                    torch.cuda.empty_cache()
                    _log(f"  remat {name}: out of memory at N={clips}")
                    continue
                want = dict(_expected_step_launches(
                    amd.cfg, False, remat=policy is not None))
                if launches != want:
                    failures.append(f"remat {name} N={clips}: launches "
                                    f"{launches}, want {want}")
                if ref is None:
                    ref = (loss, [g.cpu() for g in grads])
                    rel, cos = 0.0, 1.0
                else:
                    rel = abs(loss - ref[0]) / abs(ref[0])
                    dot = na = nb = 0.0
                    for g, r in zip(grads, ref[1]):
                        r = r.to(dev)
                        dot += (g * r).sum().item()
                        na += g.square().sum().item()
                        nb += r.square().sum().item()
                    cos = dot / math.sqrt(na * nb)
                del grads
                if policy != "full" or clips == RUN_A_CLIPS:
                    done[policy] = clips
                    paths[f"remat_{name}"] = launches
                _log(f"  remat {name}, N={clips}: loss {loss:.6f} (rel "
                     f"{rel:.3g} to full), gradient cosine {cos:.7f}, step "
                     f"(loss and gradients) {ms:.2f} ms, peak "
                     f"{peak / 2**30:.2f} GiB ({(peak - rest) / 2**30:.2f} "
                     f"above the resting {rest / 2**30:.2f})")
                if not (rel <= REMAT_LOSS_RTOL and cos >= REMAT_GRAD_COS):
                    failures.append(f"remat {name} N={clips}: loss rel {rel},"
                                    f" gradient cosine {cos}")
            del batch, draws, ref
        missing = [p or "none" for p in REMAT_POLICIES if p not in done]
        if missing:
            failures.append(f"remat policies {missing} did not fit at N=2")
    finally:
        dit.remat, dit.remat_policy = amd.cfg.remat, amd.cfg.remat_policy
        del trainer
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return paths


def run_validate(models, failures, profile_dir=None):
    """Phase 5b: ``AMDTrainer.validate`` on N = 4 clips at
    ``sample_step=2``: exact launches, uint8 of its shape, and agreement
    with the same call on the plain attention versions. Returns the
    launches."""
    import shutil
    import torch
    from hivae_tpu_torch.training.trainer import (AMDTrainer, TrainConfig,
                                                  batch_from_clips)

    amd, vae, _ = models
    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_val")
    trainer = AMDTrainer(amd, vae, TrainConfig(
        output_dir=work, mixed_precision="bf16", seed=SEED))
    pairs = [synthetic_clip(SEED + 40 + i) for i in range(RUN_A_CLIPS)]
    batch = batch_from_clips([p[0] for p in pairs], [p[1] for p in pairs])

    def run():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        out = trainer.validate(batch, sample_step=VALIDATE_STEPS,
                               generator=gen)
        torch.cuda.synchronize()
        return out

    try:
        run()   # warm-up
        _zero_counts()
        t0 = time.perf_counter()
        out = run()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
        with _plain_kernels():
            ref = run()
        cfg = amd.cfg
        want = dict(_no_launches(), full_block_attention=(
            cfg.object_enc_num_layers +
            2 * cfg.diffusion_num_layers * VALIDATE_STEPS),
            stream_attention=(4 if cfg.use_grey else 2) + 1)
        shape = (RUN_A_CLIPS, WINDOW, 3, SIZE, SIZE)
        _log(f"  validate, N={RUN_A_CLIPS}, sample_step {VALIDATE_STEPS}: "
             f"{ms:.2f} ms, out {out.shape} {out.dtype}, launches "
             f"{ {k: v for k, v in launches.items() if v} }")
        if launches != want or out.shape != shape or out.dtype.name != \
                "uint8":
            failures.append(f"validate: launches {launches}, want {want}, "
                            f"out {out.shape} {out.dtype}")
        _clip_diff("validate vs its plain-attention run",
                   torch.from_numpy(out), torch.from_numpy(ref), failures)
        if profile_dir:
            profile_call(run, profile_dir, "profile_validate.txt",
                         "validate")
    finally:
        del trainer
        shutil.rmtree(work, ignore_errors=True)
    return launches


def build_variant(over):
    """The flagship's config with ``over`` (remat full, from the JSON),
    fp32 master weights on the card, seeded random weights."""
    import torch
    from hivae_tpu_torch.models import amd as amd_mod

    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f)).replace(**over)
    torch.manual_seed(SEED + 3)
    return amd_mod.AMDModelNew(cfg, device="cuda", dtype=torch.float32)


def write_training_videos(directory, count=CLI_VIDEOS,
                          frames=CLI_VIDEO_FRAMES, start=0):
    """``count`` mp4s of ``frames`` 256² frames at 8 fps
    (``train{start}.mp4`` on): a blocky texture panning a few pixels a
    frame under a disc moving the other way, so that the optical-flow
    camera masks are not trivial."""
    import numpy as np
    from hivae_tpu_torch.data import video as vio

    os.makedirs(directory, exist_ok=True)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    for i in range(start, start + count):
        rng = np.random.RandomState(SEED + 100 + i)
        pan = 2 + i % 4
        width = SIZE + pan * frames
        tex = rng.randint(0, 256, (SIZE // 8, width // 8 + 1, 3))
        tex = np.kron(tex, np.ones((8, 8, 1))).astype(np.uint8)
        cy, cx = rng.randint(SIZE // 4, 3 * SIZE // 4, 2)
        vy, vx = rng.randint(-6, 7, 2)
        clip = []
        for t in range(frames):
            f = tex[:, t * pan:t * pan + SIZE].copy()
            disc = (yy - cy - vy * t) ** 2 + (xx - cx + (pan + 3) * t) ** 2
            f[disc < (SIZE // 10) ** 2] = (240, (40 + 20 * i) % 256, 60)
            clip.append(f)
        vio.write_video(os.path.join(directory, f"train{i}.mp4"),
                        np.stack(clip), fps=8)


class _cli_timing:
    """Records, while the training CLI runs: the host time at each step's
    start (``AMDTrainer._step``), the end of ``fit`` (after a device
    synchronise) and its metrics, and each wait of ``fit`` on the loader
    (``train_amd.batch_stream``)."""

    def __enter__(self):
        import torch
        from hivae_tpu_torch.cli import train_amd
        from hivae_tpu_torch.training import trainer as trainer_mod

        cls = trainer_mod.AMDTrainer
        self.saved = (cls._step, cls.fit, cls.save, train_amd.batch_stream)
        step, fit, save, stream = self.saved
        self.starts, self.waits, self.end, self.metrics = [], [], None, None
        self.saves = []

        def timed_save(trainer, *a, **kw):
            t0 = time.perf_counter()
            out = save(trainer, *a, **kw)
            self.saves.append((t0, time.perf_counter()))
            return out

        def timed_step(trainer, *a, **kw):
            self.starts.append(time.perf_counter())
            return step(trainer, *a, **kw)

        def timed_fit(trainer, *a, **kw):
            out = fit(trainer, *a, **kw)
            torch.cuda.synchronize()
            self.end, self.metrics = time.perf_counter(), out
            return out

        def timed_stream(loader):
            it = stream(loader)
            while True:
                t0 = time.perf_counter()
                batch = next(it)
                self.waits.append(time.perf_counter() - t0)
                yield batch

        cls._step, cls.fit, cls.save = timed_step, timed_fit, timed_save
        train_amd.batch_stream = timed_stream
        return self

    def periods(self):
        """Host time from each step's start to the next one's (the last:
        to the end of ``fit``), less the checkpoint saves inside it."""
        ends = self.starts[1:] + [self.end]
        return [b - a - sum(s1 - s0 for s0, s1 in self.saves
                            if a <= s0 < b)
                for a, b in zip(self.starts, ends)]

    def __exit__(self, *exc):
        from hivae_tpu_torch.cli import train_amd
        from hivae_tpu_torch.training import trainer as trainer_mod

        cls = trainer_mod.AMDTrainer
        cls._step, cls.fit, cls.save, train_amd.batch_stream = self.saved
        return False


def _loader_ms(argv):
    """Host ms a batch of the CLI's loader alone (one epoch, its worker
    threads as the CLI sets them)."""
    from hivae_tpu_torch.cli import train_amd

    args = train_amd.parse_args(argv)
    loader = train_amd.build_loader(args, train_amd.build_config(args))
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) * 1e3 / n


def run_cli(argv, label, steps, failures):
    """``python -m hivae_tpu_torch.cli.train_amd`` in this process, its
    standard output echoed: exit code, exact launches of ``steps`` steps,
    finite final metrics. Returns (launches, stdout, record)."""
    import contextlib
    import gc
    import io
    import torch
    from hivae_tpu_torch.cli import train_amd

    args = train_amd.parse_args(argv)
    cfg, n = train_amd.build_config(args), args.train_batch_size
    dual = args.model_type != "AMD_N"
    buf = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with _cli_timing() as timing, contextlib.redirect_stdout(buf):
        rc = train_amd.main(argv)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    out = buf.getvalue()
    for line in out.splitlines():
        _log(f"    | {line}")
    gc.collect()
    torch.cuda.empty_cache()
    periods = timing.periods()
    later = sorted(periods[1:] or periods)
    steady = later[(len(later) - 1) // 2]
    waits = timing.waits[1:len(periods)]
    wait = sum(waits) / len(waits) if waits else 0.0
    rec = dict(step_ms=steady * 1e3, steps_per_s=1 / steady,
               clips_per_s=n / steady, frames_per_s=n * WINDOW / steady,
               peak_gib=peak / 2**30, first_wait_ms=timing.waits[0] * 1e3,
               wait_ms=wait * 1e3, wall_s=wall)
    _log(f"  {label}: rc {rc}, {len(periods)} steps, step periods less "
         f"saves {[round(p * 1e3, 2) for p in periods]} ms (saves "
         f"{[round(b - a, 2) for a, b in timing.saves]} s; median after "
         f"the first step {rec['step_ms']:.2f} ms: "
         f"{rec['steps_per_s']:.3f} steps/s, "
         f"{rec['clips_per_s']:.3f} clips/s, {rec['frames_per_s']:.2f} "
         f"frames/s), peak {rec['peak_gib']:.2f} GiB; fit waited on the "
         f"loader {rec['first_wait_ms']:.1f} ms for the first batch and "
         f"{rec['wait_ms']:.2f} ms a step after it "
         f"({100 * wait / steady:.2f}% of a step); {wall:.1f} s with model "
         f"build and saves; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    want = {k: v * steps for k, v in
            _expected_step_launches(cfg, False, dual=dual).items()}
    metrics = timing.metrics or {}
    if rc != 0 or len(periods) != steps or launches != want or not all(
            math.isfinite(metrics.get(k, math.nan))
            for k in ("loss", "grad_norm")):
        failures.append(f"{label}: rc {rc}, steps {len(periods)}, metrics "
                        f"{metrics}, launches {launches}, want {want}")
    return launches, out, rec


def run_train_cli(failures, profile_dir=None):
    """Phases 7 and 7b: the training CLI on synthetic mp4s (flagship JSON
    at ``PAR_DEPTH``, N = 4, bf16, remat), a resume from step 2's
    checkpoint, the inference CLI on the checkpoint it wrote, then the
    flags' flagship at ``PAR_DEPTH`` with ``--use_mask true``. Returns
    {path: launches}."""
    import shutil
    import torch
    from hivae_tpu_torch.cli import train_amd

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    videos = os.path.join(work, "videos")
    exp = os.path.join(work, "exp")
    run_dir = os.path.join(exp, "cli")
    ckpts = os.path.join(run_dir, "checkpoints")
    common = ["--video_dir", videos, "--output_dir", exp,
              "--train_batch_size", str(RUN_A_CLIPS), "--mp", "bf16",
              "--remat", "true", "--mu_dtype", "bf16", "--seed", str(SEED),
              "--save_checkpoint_interval_step", str(CLI_SAVE_EVERY)]
    config = os.path.join(work, "config_cli.json")
    base = common + ["--exp_name", "cli", "--amd_config", config]
    paths = {}
    try:
        os.makedirs(work)
        with open(CONFIG) as f:
            cli_cfg = dict(json.load(f), **PAR_DEPTH)
        with open(config, "w") as f:
            json.dump(cli_cfg, f)
        try:
            import torch.utils.tensorboard  # noqa: F401
            _log("  torch.utils.tensorboard imports here: the CLI logs to "
                 "TensorBoard")
        except ImportError as e:
            _log(f"  torch.utils.tensorboard does not import here ({e}): the "
                 f"CLI logs to stdout")
        t0 = time.perf_counter()
        write_training_videos(videos)
        _log(f"  {CLI_VIDEOS} synthetic mp4s of {CLI_VIDEO_FRAMES} frames "
             f"written in {time.perf_counter() - t0:.1f} s")

        argv = base + ["--max_train_steps", str(CLI_STEPS)]
        _log(f"  the CLI's loader alone: {_loader_ms(argv):.1f} host ms a "
             f"batch of {RUN_A_CLIPS} clips (decode, transform, grey twins)")
        paths["train_cli"], _, _ = run_cli(
            argv, "train_amd, 3 steps", CLI_STEPS, failures)
        cfg = train_amd.build_config(train_amd.parse_args(argv))
        with open(os.path.join(run_dir, "config.json")) as f:
            written = json.load(f)
        saved = sorted(os.listdir(ckpts))
        ok = written == cfg.to_dict() and os.path.exists(
            os.path.join(run_dir, "args.txt")) and saved == [
            f"checkpoint-{CLI_SAVE_EVERY}", f"checkpoint-{CLI_STEPS}"]
        _log(f"  config.json equals its --amd_config (the flagship at "
             f"{PAR_DEPTH}): {written == cfg.to_dict()}; checkpoints "
             f"{saved}")
        if not ok:
            failures.append(f"train_amd outputs: checkpoints {saved}, "
                            f"config equal {written == cfg.to_dict()}")

        # as if the run had stopped after step 2's checkpoint
        shutil.rmtree(os.path.join(ckpts, f"checkpoint-{CLI_STEPS}"))
        argv = base + ["--max_train_steps", str(CLI_RESUME_TO),
                       "--resume_training", "true"]
        paths["train_cli_resume"], out, _ = run_cli(
            argv, "train_amd, resumed to step 4",
            CLI_RESUME_TO - CLI_SAVE_EVERY, failures)
        last = os.path.join(ckpts, f"checkpoint-{CLI_RESUME_TO}", "state.pt")
        step = torch.load(last, mmap=True, weights_only=True)["step"] \
            if os.path.exists(last) else None
        if f"resumed at step {CLI_SAVE_EVERY}" not in out or \
                step != CLI_RESUME_TO:
            failures.append(f"train_amd resume: state step {step}, output "
                            f"{out[-300:]!r}")

        one = os.path.join(work, "one")
        os.makedirs(one)
        shutil.copy(os.path.join(videos, "train0.mp4"), one)
        paths["cli_mp4_trained"] = run_inference_cli(
            os.path.join(run_dir, "config.json"), ckpts, one,
            os.path.join(work, "recon"), cfg, failures,
            label="amd_inference on the trained checkpoint")

        if profile_dir:
            argv = base + ["--max_train_steps", str(CLI_RESUME_TO + 2),
                           "--resume_training", "true", "--profile_steps",
                           "1"]
            run_cli(argv, "train_amd under its profiler (step 6)", 2,
                    failures)
            table = os.path.join(run_dir, "profile", "table.txt")
            os.makedirs(profile_dir, exist_ok=True)
            dest = os.path.join(profile_dir, "profile_train_cli.txt")
            with open(table) as src, open(dest, "w") as f:
                f.write(f"card: {_card_line()}\n{src.read()}")
            _log(f"  CLI step profile written to {dest}")
        shutil.rmtree(exp, ignore_errors=True)

        _log(f"phase 7b: the training CLI with --use_mask true, "
             f"{CLI_MASK_STEPS} steps")
        argv = common + ["--exp_name", "mask", "--use_mask", "true",
                         "--max_train_steps", str(CLI_MASK_STEPS)] + [
            f"--{k}={v}" for k, v in PAR_DEPTH.items()]
        _log(f"  the loader alone with flow masks: {_loader_ms(argv):.1f} "
             f"host ms a batch")
        paths["train_cli_mask"], _, _ = run_cli(
            argv, "train_amd --use_mask true", CLI_MASK_STEPS, failures)
        written = train_amd.build_config(train_amd.parse_args(argv))
        if not written.use_mask:
            failures.append("train_amd --use_mask: the config has no mask")
        paths.update(run_amd_s_cli(common, work, videos, failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


def run_amd_s_cli(common, work, videos, failures):
    """Phase 7c: ``cli.train_amd --model_type AMD_S`` (AMD_S's factory
    config at ``PAR_DEPTH`` as ``--amd_config``) for ``CLI_MASK_STEPS``
    steps on phase 7's
    mp4s, then on its checkpoint ``cli.amd_inference --model_type AMD_S``
    and ``cli.amd_inference_single --diff_motion``. Returns {path:
    launches}."""
    import torch
    from hivae_tpu_torch.cli import amd_inference_single
    from hivae_tpu_torch.data import video as vio
    from hivae_tpu_torch.models import amd as amd_mod

    _log(f"phase 7c: the training CLI with --model_type AMD_S, "
         f"{CLI_MASK_STEPS} steps, then its checkpoint served")
    paths = {}
    config = os.path.join(work, "amd_s.json")
    cfg = amd_mod.AMD_S(device="meta", remat=True, **FAMILY_KW).cfg.replace(
        **PAR_DEPTH)
    with open(config, "w") as f:
        json.dump(cfg.to_dict(), f)
    argv = common + ["--exp_name", "amd_s", "--model_type", "AMD_S",
                     "--amd_config", config,
                     "--max_train_steps", str(CLI_MASK_STEPS)]
    paths["train_cli_amd_s"], _, _ = run_cli(
        argv, "train_amd --model_type AMD_S", CLI_MASK_STEPS, failures)
    run_dir = os.path.join(work, "exp", "amd_s")
    ckpts = os.path.join(run_dir, "checkpoints")
    one = os.path.join(work, "one")
    paths["cli_mp4_amd_s"] = run_inference_cli(
        os.path.join(run_dir, "config.json"), ckpts, one,
        os.path.join(work, "recon_amd_s"), cfg, failures,
        label="amd_inference --model_type AMD_S on the trained checkpoint",
        model_type="AMD_S")

    cli_steps = 2
    out = os.path.join(work, "diff_motion.mp4")
    _zero_counts()
    t0 = time.perf_counter()
    rc = amd_inference_single.main([
        "--amd_config", os.path.join(run_dir, "config.json"), "--amd_ckpt",
        ckpts, "--model_type", "AMD_S", "--diff_motion", "--video_path_1",
        os.path.join(videos, "train1.mp4"), "--video_path_2",
        os.path.join(videos, "train0.mp4"), "--output_path", out,
        "--sample_step", str(cli_steps)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    paths["cli_diff_motion"] = launches = _read_counts()
    total = vio.video_metadata(out)[0] if os.path.exists(out) else 0
    shape = vio.read_video_frames(out, range(total)).shape if total \
        else None
    want = dict(_no_launches(), **_dual_launches(cfg, cli_steps, encodes=3))
    _log(f"  amd_inference_single --diff_motion: rc {rc}, {out} frames "
         f"{shape}, {cli_s:.1f} s with model build; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    if rc != 0 or shape != (WINDOW + 1, SIZE, SIZE, 3) or launches != want:
        failures.append(f"amd_inference_single --diff_motion: rc {rc}, "
                        f"frames {shape}, launches {launches}, want {want}")
    return paths


def run_train_a2m_cli(card, failures):
    """Phase 7d: ``python -m hivae_tpu_torch.cli.train_a2m`` in this
    process. An index (a ``.pkl`` of {video_path, audio_emb_path,
    pose_path}, the JAX CLI's format) of phase 7's synthetic mp4s, seeded
    embeddings and a second set of mp4s as the pose stream; a frozen
    AMD_N (its random weights written as a reference-named
    ``.safetensors``) and SD-VAE in bf16; the flagship head at AMD_N's 4
    tokens and ``A2M_CLI_LAYERS`` layers (its widths) with fp32 weights
    under bf16 autocast; N = A2M_TRAIN_CLIPS
    clips of 16 frames. A2M_TRAIN_STEPS steps (a checkpoint at step 2 and
    the final one), then a resume to one step more, then
    ``cli.a2v_inference`` on the checkpoint it wrote. Each step runs the
    object encoder's layers on the clip's and on the reference's latents
    (full-block) and four VAE encodes (clip, reference, pose stream,
    reference pose; streaming): launches exact; step ms (each step timed
    to a device synchronise), clips/s and peak memory printed. Returns
    {path: launches}."""
    import contextlib
    import io
    import pickle
    import shutil
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import a2v_inference, train_a2m

    work = os.path.join(ROOT, "hivae_tpu_torch", "build",
                        "chip_smoke_a2m_train")
    shutil.rmtree(work, ignore_errors=True)
    videos, poses = (os.path.join(work, d) for d in ("videos", "poses"))
    write_training_videos(videos)
    write_training_videos(poses)
    rng = np.random.RandomState(SEED + 70)
    spec = a2m_spec()
    model = spec["model"]
    index = []
    for i in range(CLI_VIDEOS):
        emb = os.path.join(videos, f"train{i}.npy")
        np.save(emb, rng.randn(CLI_VIDEO_FRAMES, model["audio_block"],
                               model["audio_inchannel"]).astype(np.float32))
        index.append({"video_path": os.path.join(videos, f"train{i}.mp4"),
                      "audio_emb_path": emb,
                      "pose_path": os.path.join(poses, f"train{i}.mp4")})
    with open(os.path.join(work, "index.pkl"), "wb") as f:
        pickle.dump(index, f)
    amd, _ = build_serving_models()
    enc_layers = amd.cfg.object_enc_num_layers
    amd_cfg = amd.cfg
    amd_st = os.path.join(work, "amd_n.safetensors")
    write_safetensors(amd_st, _reference_named(amd))
    del amd
    torch.cuda.empty_cache()
    a2m_json = os.path.join(work, "a2m.json")
    with open(a2m_json, "w") as f:
        json.dump(dict(spec, model=dict(
            model, motion_num_token=amd_cfg.object_motion_token_num,
            diffusion_num_layers=A2M_CLI_LAYERS)), f)
    argv = ["--a2m_config", a2m_json, "--amd_config", CONFIG,
            "--amd_ckpt", amd_st, "--video_dir",
            os.path.join(work, "index.pkl"), "--output_dir", work,
            "--exp_name", "run", "--train_batch_size", str(A2M_TRAIN_CLIPS),
            "--video_frames", str(WINDOW), "--save_checkpoint_interval_step",
            "2", "--dataloader_num_workers", "4"]
    step_fn = train_a2m.A2MTrainer.train_step
    times = []

    def timed(trainer, *a, **k):
        t0 = time.perf_counter()
        out = step_fn(trainer, *a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    per_step = dict(_no_launches(), full_block_attention=2 * enc_layers,
                    stream_attention=4)
    paths = {}
    try:
        train_a2m.A2MTrainer.train_step = timed
        for label, steps, extra in (
                ("train", A2M_TRAIN_STEPS, []),
                ("resume", 1, ["--resume_training", "true"])):
            total = A2M_TRAIN_STEPS + (label == "resume")
            buf = io.StringIO()
            times.clear()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_a2m.main(argv + ["--max_train_steps", str(total)]
                                    + extra)
            wall = time.perf_counter() - t0
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out = buf.getvalue()
            paths[f"train_a2m_{label}"] = launches
            want = {k: v * steps for k, v in per_step.items()}
            ckpts = sorted(os.listdir(os.path.join(work, "run",
                                                   "checkpoints")))
            later = sorted(times[1:] or times)
            step_s = later[(len(later) - 1) // 2]
            final = [x for x in out.splitlines()
                     if x.startswith("final metrics")]
            _log(f"  cli.train_a2m ({label}): rc {rc}, {len(times)} steps "
                 f"of {A2M_TRAIN_CLIPS} clips, step times "
                 f"{[round(t * 1e3, 2) for t in times]} ms (median after "
                 f"the first {step_s * 1e3:.2f} ms, "
                 f"{A2M_TRAIN_CLIPS / step_s:.3f} clips/s), peak "
                 f"{peak:.2f} GiB, {wall:.1f} s with the models' build and "
                 f"saves; checkpoints {ckpts}; {final}; launches "
                 f"{ {k: v for k, v in launches.items() if v} }; {card}")
            resumed = label != "resume" or \
                f"resumed at step {A2M_TRAIN_STEPS}" in out
            if not (rc == 0 and len(times) == steps and launches == want
                    and final and f"checkpoint-{total}" in ckpts
                    and resumed):
                failures.append(f"cli.train_a2m ({label}): rc {rc}, steps "
                                f"{len(times)}, launches {launches} want "
                                f"{want}, checkpoints {ckpts}, {final}, "
                                f"resumed {resumed}")
    finally:
        train_a2m.A2MTrainer.train_step = step_fn

    try:
        import cv2
        frames = ((synthetic_clip(SEED + 71, 1)[0][0].transpose(1, 2, 0)
                   + 1) * 127.5).clip(0, 255).astype(np.uint8)
        ref_png = os.path.join(work, "ref.png")
        cv2.imwrite(ref_png, cv2.cvtColor(frames, cv2.COLOR_RGB2BGR))
        # phase 3m's length: two windows and a tail past the 8 reference
        # frames (a tail needs W + R driven frames before it)
        talk = os.path.join(work, "talk.npy")
        np.save(talk, rng.randn(A2V_FRAMES, model["audio_block"],
                                model["audio_inchannel"]).astype(np.float32))
        out_path = os.path.join(work, "out", "talk.mp4")
        buf = io.StringIO()
        _zero_counts()
        with contextlib.redirect_stdout(buf):
            rc = a2v_inference.main([
                "--amd_config", CONFIG, "--amd_ckpt", amd_st,
                "--a2m_config", os.path.join(work, "run", "config.json"),
                "--a2m_ckpt", os.path.join(work, "run", "checkpoints"),
                "--ref_image", ref_png, "--audio_emb", talk,
                "--output", out_path,
                "--motion_sample_step", str(A2V_CLI_STEPS),
                "--video_sample_step", str(A2V_CLI_STEPS)])
        launches = _read_counts()
        paths["train_a2m_served"] = launches
        line = [x for x in buf.getvalue().splitlines()
                if x.startswith("generated")]
        want = dict(_no_launches(), **_a2v_launches(
            amd_cfg, video_steps=A2V_CLI_STEPS, motion_steps=A2V_CLI_STEPS))
        _log(f"  cli.a2v_inference on the trained checkpoint: rc {rc}, "
             f"{line}, launches "
             f"{ {k: v for k, v in launches.items() if v} }")
        if not (rc == 0 and line and launches == want):
            failures.append(f"cli.a2v_inference on the cli.train_a2m "
                            f"checkpoint: rc {rc}, {line}, launches "
                            f"{launches} want {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


# -- phases 3q, 3r, 7e and 7f: the other models -------------------------------


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def run_t2m_sample(models, card, failures):
    """Phase 3q: T2M ``sample`` on the card. The default ``T2MConfig``
    (2048 wide, 16 heads of 128, 20 layers, ``time_embed_dim`` 768,
    ``label_dim`` 512) with AMD_N's 4 object tokens (``T2M_OVERRIDES``), in
    bf16 on seeded random weights built on the card; conditioned on the
    camera target of phase 3's clip through AMD_N's ``encode`` (cut to 8
    sites of 8 channels) and its reference latents, and on an int label
    and on ``TextEncoder``'s fallback embedding of ``T2M_TEXT``. Euler and
    Heun at ``T2M_STEPS``: one warm-up, then each run timed with exact
    launches (a full-block forward at (16, 16, 269, 128) a layer and
    velocity call; ``sdpa_plain`` 0), finite, and its integrated motion
    (sample - z0) within ``T2M_MOTION_REL_L2`` of the same run's on the
    plain attention versions. Returns {path: launches}."""
    import torch
    from hivae_tpu_torch.data.text import TextEncoder
    from hivae_tpu_torch.models import t2m as t2m_mod
    from hivae_tpu_torch.models import vae as vae_mod

    amd, vae = models
    cfg = t2m_mod.T2MConfig(**T2M_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(SEED + 80)
    t0 = time.perf_counter()
    head = t2m_mod.Label2MotionDiffusionDecoder(
        cfg, device="cuda", dtype=torch.bfloat16).eval()
    build_s = time.perf_counter() - t0
    n = sum(p.numel() for p in head.parameters())
    rgb, grey = synthetic_clip()
    with torch.no_grad():
        z, zg = (vae_mod.vae_encode(vae, torch.from_numpy(x)[None].cuda())
                 for x in (rgb, grey))
        ref = z[:, :1].expand(-1, WINDOW, -1, -1, -1)
        cam_t = amd.encode(z[:, 1:], ref, zg[:, 1:],
                           zg[:, :1].expand(-1, WINDOW, -1, -1, -1))[0]
    cam = cam_t[:, :, :cfg.camera_token_num, :cfg.camera_channel]
    tokens = cfg.object_token_num + 1 + cfg.camera_token_num + \
        (cfg.refimg_height // cfg.refimg_patch_size) * \
        (cfg.refimg_width // cfg.refimg_patch_size)
    _log(f"  T2M head {n / 1e6:.1f} M params (bf16, built on the card in "
         f"{build_s:.1f} s), joint block (16, 16, {tokens}, "
         f"{cfg.attention_head_dim}); camera target {tuple(cam_t.shape)} "
         f"cut to {tuple(cam.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    z0 = torch.randn((WINDOW, cfg.object_token_num, cfg.object_channel),
                     generator=gen, device="cuda")
    label = torch.tensor([T2M_LABEL], device="cuda")
    text = torch.from_numpy(TextEncoder(width=cfg.label_dim)(
        [T2M_TEXT])[1]).cuda()
    paths, outs, rels = {}, {}, []
    for name, lab, solver, calls in (("t2m_euler", label, "euler", 1),
                                     ("t2m_heun", label, "heun", 2),
                                     ("t2m_text", text, "euler", 1)):
        def run():
            return t2m_mod.sample(head, lab, ref, cam,
                                  sample_steps=T2M_STEPS, solver=solver,
                                  z0=z0)
        if not outs:
            run()
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        paths[name] = launches = _read_counts()
        want = dict(_no_launches(), full_block_attention=(
            calls * cfg.num_layers * T2M_STEPS))
        with _plain_kernels():
            plain = run()
        rel = _rel_l2(out - z0, plain - z0)
        rels.append(rel)
        finite = bool(torch.isfinite(out).all())
        outs[name] = out
        shape = (WINDOW, cfg.object_token_num, cfg.object_channel)
        _log(f"  T2M sample {name} ({solver}, {T2M_STEPS} steps, N 1 of "
             f"{WINDOW} frames): {ms:.2f} ms; motion (sample - z0) vs plain "
             f"attention rel L2 {rel:.3g} (whole sample "
             f"{_rel_l2(out, plain):.3g}); finite {finite}; launches "
             f"{ {k: v for k, v in launches.items() if v} }; {card}")
        if not (launches == want and tuple(out.shape) == shape and finite
                and rel <= T2M_MOTION_REL_L2):
            failures.append(f"T2M sample {name}: launches {launches} want "
                            f"{want}, shape {tuple(out.shape)}, finite "
                            f"{finite}, rel {rel}")
    moved = _rel_l2(outs["t2m_text"] - z0, outs["t2m_euler"] - z0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _log(f"  T2M text vs int label: motion rel L2 {moved:.3g} apart "
         f"({moved / max(rels):.3g}x the largest kernel-vs-plain distance, "
         f"{T2M_LABEL_MOVES}x asked); peak {peak:.2f} GiB")
    if not moved > T2M_LABEL_MOVES * max(rels):
        failures.append(f"T2M sample: the text label moved the motion by "
                        f"{moved}, within {T2M_LABEL_MOVES}x the rounding "
                        f"noise {max(rels)}")
    del head
    torch.cuda.empty_cache()
    return paths


def _write_t2m_inputs(work, layers):
    """A T2M config json (``T2M_OVERRIDES`` at ``layers`` layers) under
    ``work``; returns its path."""
    path = os.path.join(work, f"t2m_{layers}.json")
    with open(path, "w") as f:
        json.dump(dict(T2M_OVERRIDES, num_layers=layers), f)
    return path


def _t2m_step_at_depth(train_t2m, base_argv, work, layers, card, mp="bf16"):
    """One timed step of ``T2MTrainer`` (built by the CLI's ``build``) at
    ``layers`` layers, N 1, after a warm-up step, under ``--mp mp`` ->
    (launches, ms, peak GiB, metrics)."""
    import torch
    from hivae_tpu_torch.data.datasets import DataLoader

    args = train_t2m.parse_args(base_argv + [
        "--t2m_config", _write_t2m_inputs(work, layers), "--exp_name",
        f"depth{layers}_{mp}", "--train_batch_size", "1", "--mp", mp])
    torch.cuda.reset_peak_memory_stats()
    cfg, head, amd, vae, dataset = train_t2m.build(args, torch.device("cuda"))
    trainer = train_t2m.T2MTrainer(head, amd, vae, args,
                                   os.path.join(work, f"depth{layers}"))
    batches = iter(DataLoader(dataset, 1, num_workers=2))
    trainer.train_step(next(batches))
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    metrics = trainer.train_step(next(batches))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in metrics.items()}
    n = sum(p.numel() for p in head.parameters())
    _log(f"  T2M training step at {layers} layers ({n / 1e6:.1f} M trained "
         f"params, fp32 weights and AdamW moments, --mp {mp}; N 1 of "
         f"{WINDOW} frames): {ms:.2f} ms, peak {peak:.2f} GiB, {metrics}; "
         f"launches { {k: v for k, v in launches.items() if v} }; {card}")
    return launches, ms, peak, metrics


def run_train_t2m(card, failures):
    """Phase 7e: T2M training. A tree of two class directories of
    synthetic mp4s, the frozen AMD_N (its random weights written as a
    reference-named ``.safetensors``) and SD-VAE in bf16, the head with
    fp32 weights under bf16 autocast, N 1 of 16 frames. First one timed
    step of ``cli.train_t2m.T2MTrainer`` at full depth (20 layers), with
    its peak memory (an out-of-memory error fails the phase). Then the CLI
    itself in this process at ``T2M_CLI_LAYERS`` layers (full width; its
    checkpoints are 12 bytes a parameter): 2 steps (a checkpoint at step
    2), then a resume to step 3. Each step: the object encoder's layers
    and the head's joint blocks forward (full-block), the joint blocks'
    delta and backward, four VAE encodes (streaming): launches exact,
    ``sdpa_plain`` 0, metrics finite. Returns {path: launches}."""
    import contextlib
    import io
    import shutil
    import torch
    from hivae_tpu_torch.cli import train_t2m
    from hivae_tpu_torch.models import t2m as t2m_mod

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_t2m")
    shutil.rmtree(work, ignore_errors=True)
    tree = os.path.join(work, "videos")
    for i, cls in enumerate(("clsA", "clsB")):
        write_training_videos(os.path.join(tree, cls), count=T2M_VIDEOS // 2,
                              frames=T2M_VIDEO_FRAMES,
                              start=i * T2M_VIDEOS // 2)
    amd, _ = build_serving_models()
    enc_layers = amd.cfg.object_enc_num_layers
    amd_st = os.path.join(work, "amd_n.safetensors")
    write_safetensors(amd_st, _reference_named(amd))
    del amd, _
    torch.cuda.empty_cache()
    base = ["--amd_config", CONFIG, "--amd_ckpt", amd_st, "--video_dir",
            tree, "--output_dir", work, "--video_frames", str(WINDOW),
            "--dataloader_num_workers", "2"]

    def per_step(layers):
        return dict(_no_launches(), full_block_attention=enc_layers + layers,
                    full_block_attention_bwd=layers,
                    full_block_attention_delta=layers, stream_attention=4)
    paths = {}
    full = t2m_mod.T2MConfig().num_layers
    try:
        launches, ms, peak, metrics = _t2m_step_at_depth(
            train_t2m, base, work, full, card)
    except torch.OutOfMemoryError as e:
        failures.append(f"T2M training step ({full} layers): out of the "
                        f"card's memory ({str(e).splitlines()[0][:160]})")
    else:
        paths["train_t2m_step"] = launches
        finite = all(math.isfinite(v) for v in metrics.values())
        if not (launches == per_step(full) and finite):
            failures.append(f"T2M training step ({full} layers): launches "
                            f"{launches} want {per_step(full)}, metrics "
                            f"{metrics}")
    torch.cuda.empty_cache()

    argv = base + ["--t2m_config", _write_t2m_inputs(work, T2M_CLI_LAYERS),
                   "--exp_name", "run", "--train_batch_size", "1",
                   "--save_checkpoint_interval_step", "2"]
    try:
        for label, steps, extra in (("train", 2, []),
                                    ("resume", 1, ["--resume_training",
                                                   "true"])):
            total = 2 + (label == "resume")
            buf = io.StringIO()
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_t2m.main(argv + ["--max_train_steps", str(total)]
                                    + extra)
            wall = time.perf_counter() - t0
            launches = _read_counts()
            out = buf.getvalue()
            paths[f"train_t2m_{label}"] = launches
            want = {k: v * steps for k, v in per_step(T2M_CLI_LAYERS).items()}
            ckpts = sorted(os.listdir(os.path.join(work, "run",
                                                   "checkpoints")))
            final = [x for x in out.splitlines()
                     if x.startswith("final metrics")]
            resumed = label != "resume" or "resumed at step 2" in out
            _log(f"  cli.train_t2m ({label}, {T2M_CLI_LAYERS} layers): rc "
                 f"{rc}, {wall:.1f} s with the models' build and saves; "
                 f"checkpoints {ckpts}; {final}; launches "
                 f"{ {k: v for k, v in launches.items() if v} }")
            if not (rc == 0 and launches == want and final and resumed
                    and f"checkpoint-{total}" in ckpts
                    and "nan" not in final[0]):
                failures.append(f"cli.train_t2m ({label}): rc {rc}, "
                                f"launches {launches} want {want}, "
                                f"checkpoints {ckpts}, {final}, resumed "
                                f"{resumed}")
        # the `--mp no` step: the head computing in fp32 on the frozen
        # AMD_N and SD-VAE in fp32, on the fp32 kernels
        launches, ms, peak, metrics = _t2m_step_at_depth(
            train_t2m, base, work, T2M_CLI_LAYERS, card, mp="no")
        paths["train_t2m_mp_no"] = launches
        want = _f32_counts(per_step(T2M_CLI_LAYERS))
        if not (launches == want and
                all(math.isfinite(v) for v in metrics.values())):
            failures.append(f"T2M --mp no step: launches {launches} want "
                            f"{want}, metrics {metrics}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


def run_train_mae(card, failures):
    """Phase 7f: ``python -m hivae_tpu_torch.cli.train_mae`` in this
    process: MAE_L (328.1 M) with fp32 weights under bf16 autocast on a
    bf16 SD-VAE, ``--train_batch_size`` MAE_TRAIN_CLIPS (one frame of each
    of as many synthetic mp4s), mask ratio 0.75: 2 steps (a checkpoint at
    step 2), then a resume to step 3; each step one VAE encode
    (streaming), the decoder's 8 blocks at (32, 16, 257, 32) forward,
    delta and backward (full-block), the encoder's 65 tokens plain:
    launches exact, metrics finite, step time and peak memory printed.
    Then ``reconstruct`` (mask ratio 0) of MAE_RECON latent frames with
    the checkpoint's weights: the encoder at 257 tokens (D 64) and the
    decoder on the full-block kernel, exact launches, within MAE_REL_L2 of
    its run on the plain attention versions. Returns {path: launches}."""
    import contextlib
    import io
    import shutil
    import torch
    from hivae_tpu_torch.cli import train_mae
    from hivae_tpu_torch.models import mae as mae_mod
    from hivae_tpu_torch.models import vae as vae_mod
    from hivae_tpu_torch.training import checkpoint as ckpt_lib

    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_mae")
    shutil.rmtree(work, ignore_errors=True)
    videos = os.path.join(work, "videos")
    write_training_videos(videos, count=MAE_TRAIN_CLIPS,
                          frames=MAE_VIDEO_FRAMES)
    argv = ["--video_dir", videos, "--model_type", "MAE_L",
            "--train_batch_size", str(MAE_TRAIN_CLIPS), "--output_dir", work,
            "--exp_name", "run", "--save_checkpoint_interval_step", "2",
            "--lr_warmup_steps", "1", "--dataloader_num_workers", "4"]
    dec = 8
    per_step = dict(_no_launches(), full_block_attention=dec,
                    full_block_attention_bwd=dec,
                    full_block_attention_delta=dec, stream_attention=1)
    step_fn = train_mae.MAETrainer.train_step
    times = []

    def timed(trainer, *a, **k):
        t0 = time.perf_counter()
        out = step_fn(trainer, *a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    paths = {}
    try:
        train_mae.MAETrainer.train_step = timed
        for label, steps, extra in (("train", 2, []),
                                    ("resume", 1, ["--resume_training",
                                                   "true"])):
            total = 2 + (label == "resume")
            buf = io.StringIO()
            times.clear()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_mae.main(argv + ["--max_train_steps", str(total)]
                                    + extra)
            wall = time.perf_counter() - t0
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out = buf.getvalue()
            paths[f"train_mae_{label}"] = launches
            want = {k: v * steps for k, v in per_step.items()}
            ckpts = sorted(os.listdir(os.path.join(work, "run",
                                                   "checkpoints")))
            final = [x for x in out.splitlines()
                     if x.startswith("final metrics")]
            resumed = label != "resume" or "resumed at step 2" in out
            _log(f"  cli.train_mae ({label}, MAE_L, N={MAE_TRAIN_CLIPS}): "
                 f"rc {rc}, step times "
                 f"{[round(t * 1e3, 2) for t in times]} ms, peak "
                 f"{peak:.2f} GiB, {wall:.1f} s with the models' build and "
                 f"saves; checkpoints {ckpts}; {final}; launches "
                 f"{ {k: v for k, v in launches.items() if v} }; {card}")
            if not (rc == 0 and len(times) == steps and launches == want
                    and final and resumed and "nan" not in final[0]
                    and f"checkpoint-{total}" in ckpts):
                failures.append(f"cli.train_mae ({label}): rc {rc}, steps "
                                f"{len(times)}, launches {launches} want "
                                f"{want}, checkpoints {ckpts}, {final}, "
                                f"resumed {resumed}")
        model = mae_mod.MAE_L(device="cuda").eval()
        model.load_state_dict(ckpt_lib.load_trained_params(
            os.path.join(work, "run", "checkpoints")), strict=True)
        paths["train_mae_mp_no"] = _mae_step_mp_no(
            train_mae, argv, work, _f32_counts(per_step), card, failures)
    finally:
        train_mae.MAETrainer.train_step = step_fn
        shutil.rmtree(work, ignore_errors=True)

    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.bfloat16).eval()
    rgb, _ = synthetic_clip(SEED + 90, MAE_RECON)
    with torch.no_grad():
        imgs = vae_mod.vae_encode(vae, torch.from_numpy(rgb)[None].cuda())[0]
    del vae

    def recon():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            return model.reconstruct(imgs.float()).float()
    recon()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = recon()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    paths["mae_reconstruct"] = launches = _read_counts()
    want = dict(_no_launches(), full_block_attention=(
        len(model.transformer_blocks) + len(model.decoder_blocks)))
    with _plain_kernels():
        plain = recon()
    rel = _rel_l2(out, plain)
    finite = bool(torch.isfinite(out).all())
    _log(f"  MAE_L reconstruct of {MAE_RECON} latent frames "
         f"{tuple(out.shape)}: {ms:.2f} ms; vs plain attention rel L2 "
         f"{rel:.3g}; finite {finite}; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    if not (launches == want and finite and rel <= MAE_REL_L2
            and out.shape == imgs.shape):
        failures.append(f"MAE reconstruct: launches {launches} want {want}, "
                        f"finite {finite}, rel {rel}, shape "
                        f"{tuple(out.shape)}")
    del model
    torch.cuda.empty_cache()
    return paths


def _mae_step_mp_no(train_mae, argv, work, want, card, failures):
    """One `--mp no` step of ``MAETrainer`` (built by the CLI's ``build``:
    MAE_L computing in fp32 on an fp32 SD-VAE) on one batch of
    MAE_TRAIN_CLIPS frames, after a warm-up step on the same batch: exact
    launches ``want`` on the fp32 kernels, finite metrics, step ms and peak
    memory logged -> launches."""
    import torch
    from hivae_tpu_torch.data.datasets import DataLoader

    args = train_mae.parse_args(argv + ["--mp", "no", "--exp_name",
                                        "mp_no"])
    model, vae, dataset = train_mae.build(args, torch.device("cuda"))
    trainer = train_mae.MAETrainer(model, vae, args,
                                   os.path.join(work, "mp_no"))
    batch = next(iter(DataLoader(dataset, MAE_TRAIN_CLIPS, num_workers=4)))
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in metrics.items()}
    _log(f"  MAE_L --mp no step (N={MAE_TRAIN_CLIPS}, fp32 compute): "
         f"{ms:.2f} ms, peak {peak:.2f} GiB, {metrics}; launches "
         f"{ {k: v for k, v in launches.items() if v} }; {card}")
    if not (launches == want and
            all(math.isfinite(v) for v in metrics.values())):
        failures.append(f"MAE --mp no step: launches {launches} want {want}, "
                        f"metrics {metrics}")
    del trainer, model, vae
    torch.cuda.empty_cache()
    return launches


def run_other_models(card, failures):
    """Phase 3r: the CNN motion AE and the discriminators at their default
    widths, fp32 weights under bf16 autocast, on the card. The AE on a
    16-frame clip of 32 x 32 latents, forward and its loss's backward:
    finite, the clip's shape; its ``MapConv`` attends over the 32 x 32 grid
    at 640 channels, (16, 1, 1024, 640), on the streaming kernels: one
    forward, delta, dQ and dK/dV launch each, ``sdpa_plain`` 0 (its
    16-token mid-block attentions stay plain, as in JAX's ``auto``). Each
    discriminator forward
    in ``train=True`` and ``train=False``, and the GAN losses of the
    logits: finite, expected shapes, no launch, ``sdpa_plain`` 0. Returns
    {path: launches}."""
    import torch
    from hivae_tpu_torch.losses import discriminator as disc
    from hivae_tpu_torch.models import model_ae

    gen = torch.Generator(device="cuda").manual_seed(SEED + 95)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    torch.manual_seed(SEED + 95)
    paths = {}
    ae = model_ae.CNNMotionAE(device="cuda")
    video = rand(1, WINDOW, 4, 32, 32)
    params = list(ae.parameters())
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        pred = ae(video)
        loss = ae.loss(pred, video)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    paths["cnn_motion_ae"] = launches = _read_counts()
    finite = bool(torch.isfinite(pred).all()) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    n = sum(p.numel() for p in params)
    _log(f"  CNNMotionAE ({n / 1e6:.1f} M) forward and loss backward on "
         f"(1, {WINDOW}, 4, 32, 32): {ms:.2f} ms (first call); loss "
         f"{loss.item():.5f}; finite {finite}; launches "
         f"{ {k: v for k, v in launches.items() if v} }; {card}")
    want = dict(_no_launches(), stream_attention=1,
                stream_attention_delta=1, stream_attention_bwd_dq=1,
                stream_attention_bwd_dkv=1)
    if not (launches == want and finite and pred.shape == video.shape):
        failures.append(f"CNNMotionAE: launches {launches} want {want}, "
                        f"finite {finite}, shape {tuple(pred.shape)}")
    del ae, grads, pred
    ts = torch.tensor([17.0, 250.0, 601.0, 999.0], device="cuda")
    cases = (
        ("NLayerDiscriminator", dict(in_channels=3), (rand(2, 3, 256, 256),),
         (2, 1, 30, 30)),
        ("NLayerDiscriminator3D", dict(in_channels=3),
         (rand(1, 3, 32, 128, 128),), (1, 1, 2, 14, 14)),
        ("Discriminator3DConv", dict(in_channels=4),
         (rand(2, 4, WINDOW, 32, 32),), (2,)),
        ("Discriminator2DConv", dict(in_channels=4), (rand(4, 4, 32, 32),),
         (4,)),
        ("Discriminator2DConvVel", dict(in_channels=8),
         (rand(4, 8, 32, 32), ts), (4,)),
        ("Discriminator2DAttn", dict(in_channels=8), (rand(4, 8, 32, 32), ts),
         (4,)))
    _zero_counts()
    for name, kw, args, shape in cases:
        model = getattr(disc, name)(device="cuda", **kw)
        modes = (True, False) if name != "Discriminator2DAttn" else (None,)
        outs = []
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            for train in modes:
                extra = {} if train is None else dict(train=train)
                outs.append(model(*args, **extra).float())
        torch.cuda.synchronize()
        losses = [disc.hinge_d_loss(outs[0], -outs[0]),
                  disc.vanilla_d_loss(outs[0], -outs[0]),
                  disc.generator_loss(outs[0])]
        ok = all(tuple(o.shape) == shape and bool(torch.isfinite(o).all())
                 for o in outs) and all(math.isfinite(x.item())
                                        for x in losses)
        n = sum(p.numel() for p in model.parameters())
        _log(f"  {name} ({n / 1e6:.2f} M): out {tuple(outs[0].shape)} "
             f"finite {ok}; hinge {losses[0].item():.4f}")
        if not ok:
            failures.append(f"{name}: shapes {[tuple(o.shape) for o in outs]}"
                            f" want {shape}, or not finite")
        del model
    paths["discriminators"] = launches = _read_counts()
    if launches != _no_launches():
        failures.append(f"discriminators: launches {launches}, want none")
    torch.cuda.empty_cache()
    return paths


# -- phase 8: parallelism over ranks that share the one card ------------------
#
# NCCL refuses two ranks on one device, so the multi-rank phases run their
# ranks as processes on this card over gloo, whose collectives the port
# stages through pinned host memory (parallel/comm.py). They run the ring's
# kernel hops at real shapes and check the data-parallel, ring and FSDP
# steps against one process's; no time they print is a collective's on a
# cluster.

# sequence_sharded_sdpa at the kernel-hop shapes: 4096 tokens over rings of
# 2 and 4 ranks (2048 and 1024 local tokens, at or past _FLASH_MIN_LOCAL)
RING_SHAPE = (1, 16, 4096, 64)
RING_SIZES = (2, 4)
# local tokens at which a kernel hop and a plain hop are timed (the ring's
# hop crossover on this card)
HOP_TOKENS = (512, 1024, 2048)
# global batches of the data-parallel (2, 1, 1) and ring (1, 1, 2) steps,
# and the FSDP (1, 2, 1) step
PAR_DP_CLIPS, PAR_RING_CLIPS, PAR_FSDP_CLIPS = 4, 2, 2
# the weight tensor-parallel (1, 1, 2) steps of phase 8f: bf16, then one
# `--mp no` step, held to one process's step on the same global batch.
# fp32: the row-parallel layers' partial products summed in another order
# than one matmul's, ~1e-7 a layer
PAR_TP_CLIPS = 2
TP_F32_LOSS_RTOL = 1e-4
TP_F32_GRAD_REL_L2 = 1e-5
# the long window of benchmarks/bench_longwindow.py (flagship widths) and
# its Euler steps here
LONG_WINDOW, LONG_WINDOW_STEPS = 64, 2
# phase 8's models, and phases 7 and 7b's (the training CLI), keep the
# flagship's widths at a cut depth: phase 8's gloo collectives move every
# gradient and checkpoint tensor through host memory, so their time
# follows the parameter count, and the CLI writes full checkpoints with
# the optimizer state (8 GB at full depth). Cut from 4 encoder and 4 DiT
# layers (phase 8) and the full depth (phase 7) when phase 3v's exports
# took the script past 800 s; the full depth trains in phases 4 and 5.
# Phases 4b (remat policies), 5c (`--mp no`) and 6 (variants) run at this
# depth too since the parallel phases 8e-8g took the script to 934 s; run
# B (phase 5, its checkpoint resumed), 5d (fp16) and phase 7c's AMD_S CLI
# since the fp16 and head-dim phases took it to 830 s, when the depth was
# cut from 2 + 2 encoder and 2 DiT layers to 1 + 1 and 1 (phase 8 took
# 185 s of it); the full depth trains in phase 4
PAR_DEPTH = dict(object_enc_num_layers=1, camera_enc_num_layers=1,
                 diffusion_num_layers=1)
RANK_TIMEOUT = 600


_PORTS = set()   # the ports handed to spawns in this run


def _free_port() -> int:
    """A free port no other spawn of this run was given (two spawns may
    work side by side)."""
    import socket
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _PORTS:
            _PORTS.add(port)
            return port


def start_ranks(phase, world, workdir, cmd=None, env=None):
    """Start ``world`` processes of ``phase`` (this script's
    ``--rank-phase``, or ``cmd``), each on this card, its output in
    ``workdir`` -> a handle for ``wait_ranks``."""
    os.makedirs(workdir, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(workdir, f"{phase}_rank{r}.log"), "w")
            logs.append(log)
            argv = cmd or [sys.executable, os.path.abspath(__file__),
                           "--rank-phase", phase, "--workdir", workdir]
            penv = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                        LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), **(env or {}))
            procs.append(subprocess.Popen(argv, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          env=penv, cwd=ROOT))
    except BaseException:
        wait_ranks((phase, workdir, procs, logs, time.perf_counter()), 0)
        raise
    return phase, workdir, procs, logs, time.perf_counter()


def wait_ranks(handle, timeout=RANK_TIMEOUT):
    """Wait for ``start_ranks``'s processes, killing them all ``timeout``
    s after their start. Returns [(exit code, output, result dict or
    None)] by rank."""
    phase, workdir, procs, logs, t0 = handle
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        _log(f"  {phase}: ranks ran past {timeout} s; killed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"{phase}_rank{r}.log")) as f:
            text = f.read()
        res = os.path.join(workdir, f"{phase}_rank{r}.json")
        result = None
        if os.path.exists(res):
            with open(res) as f:
                result = json.load(f)
        out.append((p.returncode, text, result))
    return out


def spawn_ranks(phase, world, workdir, cmd=None, env=None,
                timeout=RANK_TIMEOUT):
    """``start_ranks`` then ``wait_ranks``: [(exit code, output, result
    dict or None)] by rank."""
    return wait_ranks(start_ranks(phase, world, workdir, cmd, env), timeout)


def _rank_results(label, ranks, failures):
    """Each rank's result dict; a rank that failed, or left no result,
    fails the phase with the end of its output."""
    results = []
    for r, (rc, text, res) in enumerate(ranks):
        if res is None:
            failures.append(f"{label}: rank {r} exited {rc}, no result:\n"
                            f"{text[-3000:]}")
            continue
        failures.extend(f"{label} (rank {r}): {f}" for f in res["failures"])
        if rc != 0 and not res["failures"]:
            failures.append(f"{label}: rank {r} exited {rc}:\n{text[-3000:]}")
        results.append(res)
    return results


def _bits_digest(tensors):
    """SHA-256 of the tensors' bytes, in order (for bit-equality across
    ranks)."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _sketch(tensors):
    """Random projections of the tensors, one N(0, 1) vector each, seeded
    by its index: the L2 distance of two lists' sketches estimates the
    L2 distance of the tensors (a list of floats, cheap to send)."""
    import torch
    out = []
    for i, t in enumerate(tensors):
        gen = torch.Generator(device=t.device).manual_seed(SEED + i)
        r = torch.randn(t.numel(), generator=gen, device=t.device)
        out.append(float(torch.dot(t.detach().float().flatten(), r)))
    return out


def _sketch_rel(a, b):
    """||a - b|| / ||b|| of two sketches (nan where one is missing)."""
    import numpy as np
    if not a or not b or len(a) != len(b):
        return float("nan")
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _keep_grad_sketch(trainer, into):
    """Have ``trainer``'s next gradients (the averaged ones, in parameter
    order) sketched into ``into["grad_sketch"]``; returns the undo."""
    grads = trainer.grads

    def kept(loss):
        g = grads(loss)
        into["grad_sketch"] = _sketch(g)
        return g
    trainer.grads = kept
    return lambda: trainer.__dict__.pop("grads", None)


def _cosine(a, b):
    dot = sum((x.float() * y.float()).sum() for x, y in zip(a, b)).item()
    na = sum(x.float().square().sum() for x in a).item() ** 0.5
    nb = sum(y.float().square().sum() for y in b).item() ** 0.5
    return dot / (na * nb)


def _ring_mask(s, world, device):
    """A (1, s) key mask that drops the whole second local block of a ring
    of ``world``: that hop merges with weight 0."""
    import torch
    keep = torch.ones((1, s), dtype=torch.bool, device=device)
    blk = s // world
    keep[:, blk:2 * blk] = False
    return keep


def rank_ring_hops(res):
    """Phase 8a, one rank: ``sequence_sharded_sdpa`` at RING_SHAPE over a
    ring of every rank, unmasked and with a whole local block masked:
    exact launches on this rank (a streaming forward a hop, one delta
    pre-pass, a dQ and a dK/dV kernel a hop), every rank's output and
    gradients bit-equal, and on rank 0 held to one process's ``sdpa`` on
    the whole sequence (the streaming kernel and its backward) and to the
    plain version."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.ops.kernels import flash_attention as fa
    from hivae_tpu_torch.parallel.mesh import create_mesh
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = create_mesh((1, 1, world), device_type="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    res["counts"], res["ms"] = _no_launches(), {}
    # warm-up: the ring's first rotations set up gloo's pairs
    warm = [x.clone().requires_grad_() for x in (q, k, v)]
    sequence_sharded_sdpa(*warm, mesh).backward(do)
    torch.cuda.synchronize()
    del warm
    for masked in (False, True):
        label = f"P {world}, {'masked' if masked else 'unmasked'}"
        mask = _ring_mask(RING_SHAPE[2], world, "cuda") if masked else None
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        _zero_counts()
        sequence_sharded_sdpa.calls.update(kernel=0, plain=0)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sequence_sharded_sdpa(*xs, mesh, key_mask=mask)
        out.backward(do)
        torch.cuda.synchronize()
        res["ms"][label] = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        for name, n in counts.items():
            res["counts"][name] += n
        want = dict(_no_launches(), stream_attention=world,
                    stream_attention_delta=1,
                    stream_attention_bwd_dq=world,
                    stream_attention_bwd_dkv=world)
        if counts != want or sequence_sharded_sdpa.calls != {"kernel": 1,
                                                             "plain": 0}:
            res["failures"].append(f"ring {label}: launches {counts}, want "
                                   f"{want}; ring calls "
                                   f"{sequence_sharded_sdpa.calls}")
        got = [out] + [x.grad for x in xs]
        digests = [None] * world
        dist.all_gather_object(digests, _bits_digest(got))
        if len(set(digests)) != 1:
            res["failures"].append(f"ring {label}: ranks' outputs or "
                                   f"gradients differ")
        if rank != 0:
            continue
        ref = [x.clone().requires_grad_() for x in (q, k, v)]
        o1 = attn_ops.sdpa(*ref, key_mask=mask, implementation="auto")
        o1.backward(do)
        pl = [x.clone().requires_grad_() for x in (q, k, v)]
        bias = None if mask is None else torch.zeros(
            mask.shape, device="cuda").masked_fill(~mask, -1e30)
        o2 = fa.stream_attention_plain(*pl, scale=RING_SHAPE[3] ** -0.5,
                                       bias=bias)[0]
        o2.backward(do)
        for name, want_t in (("one-process sdpa", [o1] + [x.grad for x in
                                                          ref]),
                             ("plain version", [o2] + [x.grad for x in
                                                       pl])):
            err = _abs_err(got[0], want_t[0])
            rel = [_rel_err(g, w) for g, w in zip(got[1:], want_t[1:])]
            res.setdefault("errors", {})[f"{label} vs {name}"] = [err] + rel
            if not (err <= KERNEL_ATOL and max(rel) <= BWD_RTOL):
                res["failures"].append(
                    f"ring {label} vs {name}: out max|err| {err}, gradient "
                    f"rel err {rel}")
        del ref, pl, o1, o2
    if world == 2:
        _ring_f32_call(res, mesh, gen)
    res["calls"] = dict(sequence_sharded_sdpa.calls)


def _ring_f32_call(res, mesh, gen):
    """Phase 8a, ring of 2: one fp32 ``sequence_sharded_sdpa`` call with a
    gradient at RING_SHAPE on the kernel hops (the fp32 streaming forward
    a hop, one fp32 delta, an fp32 dQ and dK/dV a hop): exact launches,
    the ranks bit-equal, and on rank 0 within ``_f32_gate`` of one
    process's fp32 ``sdpa`` (its fp32 streaming kernels) and of the fp32
    plain version."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.ops.kernels import flash_attention as fa
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa

    world = dist.get_world_size()
    label = f"P {world}, fp32"
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device="cuda")
                   for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    _zero_counts()
    sequence_sharded_sdpa.calls.update(kernel=0, plain=0)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sequence_sharded_sdpa(*xs, mesh)
    out.backward(do)
    torch.cuda.synchronize()
    res["ms"][label] = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    for name, n in counts.items():
        res["counts"][name] += n
    want = dict(_no_launches(), stream_attention_f32=world,
                stream_attention_delta_f32=1,
                stream_attention_bwd_dq_f32=world,
                stream_attention_bwd_dkv_f32=world)
    if counts != want or sequence_sharded_sdpa.calls != {"kernel": 1,
                                                         "plain": 0}:
        res["failures"].append(f"ring {label}: launches {counts}, want "
                               f"{want}; ring calls "
                               f"{sequence_sharded_sdpa.calls}")
    got = [out] + [x.grad for x in xs]
    digests = [None] * world
    dist.all_gather_object(digests, _bits_digest(got))
    if len(set(digests)) != 1:
        res["failures"].append(f"ring {label}: ranks' outputs or gradients "
                               f"differ")
    if dist.get_rank() != 0:
        return
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    o1 = attn_ops.sdpa(*ref, implementation="auto")
    o1.backward(do)
    pl = [x.clone().requires_grad_() for x in (q, k, v)]
    o2 = fa.stream_attention_plain(*pl, scale=RING_SHAPE[3] ** -0.5)[0]
    o2.backward(do)
    for name, want_t in (("one-process sdpa", [o1] + [x.grad for x in ref]),
                         ("plain version", [o2] + [x.grad for x in pl])):
        gates = [_f32_gate(g, w) for g, w in zip(got, want_t)]
        res.setdefault("errors", {})[f"{label} vs {name}"] = [
            e for e, _ in gates]
        if not all(ok for _, ok in gates):
            res["failures"].append(f"ring {label} vs {name}: max|err| out, "
                                   f"dq, dk, dv {[e for e, _ in gates]}")


def _expected_ring_step_calls(cfg, remat=None):
    """Ring calls of one training step (all attention of the step rings: 4
    VAE encodes, every encoder layer, the DiT's three attentions a layer,
    twice under remat)."""
    remat = cfg.remat if remat is None else remat
    joints = 1 if cfg.diffusion_model_type == "default" else \
        int(cfg.use_object) + int(cfg.use_camera)
    dit = (joints + 1) * cfg.diffusion_num_layers
    return 4 + cfg.object_enc_num_layers + cfg.camera_enc_num_layers + \
        dit * (2 if remat else 1)


def _par_batch(trainer, clips):
    from hivae_tpu_torch.training.trainer import batch_from_clips
    pairs = [synthetic_clip(SEED + 10 + i) for i in range(clips)]
    return trainer._to_device(batch_from_clips([p[0] for p in pairs],
                                               [p[1] for p in pairs]))


def _par_trainer(amd, vae, mesh, workdir, mp="bf16", out="trainer",
                 resume=False):
    from hivae_tpu_torch.training.trainer import AMDTrainer, TrainConfig
    tc = TrainConfig(output_dir=os.path.join(workdir, out),
                     learning_rate=1e-4, weight_decay=1e-2,
                     max_grad_norm=1.0, mixed_precision=mp,
                     mu_dtype="bf16", seed=SEED, resume=resume)
    return AMDTrainer(amd, vae, tc, mesh=mesh)


def _whole(part, like):
    """The whole tensor of which ``part`` is this rank's part in ``like``'s
    layout, on every rank (all-gathered over each split mesh dim)."""
    import torch
    from hivae_tpu_torch.parallel import comm
    mesh = getattr(like, "device_mesh", None)
    if mesh is None:
        return part
    out = part
    for m, pl in reversed(list(enumerate(like.placements))):
        if pl.is_shard():
            d, size = pl.dim, like.shape[pl.dim]
            chunk = -(-size // mesh.size(m))
            pad = [0, 0] * (out.dim() - d - 1) + [0, chunk - out.shape[d]]
            out = comm.all_gather(torch.nn.functional.pad(out, pad),
                                  mesh.get_group(m), d).narrow(d, 0, size)
    return out


def _tp_checkpoint(res, label, trainer, workdir, mp, save):
    """Phase 8f, after the tensor-parallel step: every rank's parameters,
    gathered whole, bit-equal; with ``save``, ``trainer.save()`` (the
    split weights gathered to rank 0, which writes) and on rank 0 that
    checkpoint resumed by a one-process trainer on a model built anew, its
    parameters bit-equal to the gathered ones."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.parallel.mesh import local_mesh
    from hivae_tpu_torch.parallel.sharding import local

    whole = {k: _whole(local(p).detach(), p)
             for k, p in trainer.state.params.items()}
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, _bits_digest(list(whole.values())))
    res["params_equal"] = len(set(digests)) == 1
    if save:
        t0 = time.perf_counter()
        trainer.save()
        res["save_s"] = time.perf_counter() - t0
    if save and dist.get_rank() == 0:
        amd, _ = _training_models()
        one = _par_trainer(amd, trainer.vae, local_mesh(), workdir, mp=mp,
                           out=f"trainer_tp_{mp}", resume=True)
        res["resumed_equal"] = one.global_step == 1 and all(
            torch.equal(p.detach(), whole[k])
            for k, p in one.state.params.items())
        if not res["resumed_equal"]:
            res["failures"].append(f"{label}: its checkpoint resumed in one "
                                   f"process differs from the ranks' "
                                   f"parameters")
        del one, amd
    if not res["params_equal"]:
        res["failures"].append(f"{label}: the ranks' gathered parameters "
                               f"differ after the step")
    dist.barrier()


def _step_against_reference(res, label, amd, vae, mesh, clips, workdir,
                            ring_calls=None, mp="bf16", ref_everywhere=True,
                            save=True):
    """One training step on ``mesh`` (each rank its rows of a global batch
    of ``clips``, the global batch's draws) against one process's step on
    the whole batch and the same draws, computed first on the same weights
    (on rank 0; on every rank where ``mesh`` shards the parameters, over
    ``fsdp`` or, without the ring, over ``tensor``, so that each holds the
    reference of its shards): loss within STEP_LOSS_RTOL and gradient
    cosine at least STEP_GRAD_COS (``mp="no"``: loss within
    TP_F32_LOSS_RTOL and gradient relative L2 within TP_F32_GRAD_REL_L2),
    exact launches (``ring_calls``: every attention rings, no kernel) and,
    unsharded, every rank's parameters bit-equal after the update; split
    over ``tensor``, ``_tp_checkpoint`` (``save``: with its checkpoint
    resumed in one process). ``ref_everywhere=False``: the
    reference on rank 0 alone, against the gradients gathered whole (four
    ranks on one card cannot each hold a reference step)."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.parallel.mesh import local_mesh
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa
    from hivae_tpu_torch.parallel.sharding import batch_rows, local, part_of
    from hivae_tpu_torch.training.train_state import mesh_sum

    rank = dist.get_rank()
    split = mesh.shape["tensor"] > 1 and amd.cfg.attn_impl != "ring"
    sharded = mesh.shape["fsdp"] > 1 or split
    ref = None
    if rank == 0 or (sharded and ref_everywhere):
        # a ring config on one rank runs auto attention (with a warning)
        one = _par_trainer(amd, vae, local_mesh(), workdir, mp=mp)
        batch = _par_batch(one, clips)
        m1, g1 = one.loss_and_grads(batch, one.draw(batch))
        ref = (m1["loss"].item(), [g.detach() for g in g1])
        del one, batch, g1
        torch.cuda.empty_cache()
    dist.barrier()
    trainer = _par_trainer(amd, vae, mesh, workdir, mp=mp,
                           out=f"trainer_tp_{mp}" if split else "trainer")
    batch = _par_batch(trainer, clips)
    rows = batch_rows(trainer.mesh, clips)
    batch = {k: v[rows] for k, v in batch.items()}
    draws = trainer.draw(batch)
    _zero_counts()
    sequence_sharded_sdpa.calls.update(kernel=0, plain=0)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, grads = trainer.loss_and_grads(batch, draws)
    torch.cuda.synchronize()
    res["ms"] = (time.perf_counter() - t0) * 1e3
    res["clips_per_s"] = clips / res["ms"] * 1e3
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["counts"] = counts = _read_counts()
    res["calls"] = dict(sequence_sharded_sdpa.calls)
    if ring_calls is None:
        want = _expected_step_launches(amd.cfg, False, f32=mp == "no")
        want_calls = {"kernel": 0, "plain": 0}
    else:
        want, want_calls = _no_launches(), {"kernel": 0, "plain": ring_calls}
    if counts != want or res["calls"] != want_calls:
        res["failures"].append(f"{label}: launches {counts}, want {want}; "
                               f"ring calls {res['calls']}, want "
                               f"{want_calls}")
    res["loss"] = metrics["loss"].item()
    gathered = sharded and not ref_everywhere
    if gathered:    # every rank takes part; rank 0 compares
        grads_cmp = [_whole(local(g), g) for g in grads]
    if ref is not None:
        # the cosine and distance from each rank's parts (whole tensors
        # when unsharded or gathered), added over the mesh axes each is
        # split on
        rows = []
        for g, rg in zip(grads_cmp if gathered else grads, ref[1]):
            a, b = local(g).double(), part_of(rg, g).double()
            rows.append(torch.stack([(a * b).sum(), a.square().sum(),
                                     b.square().sum(),
                                     (a - b).square().sum()]))
        likes = grads if sharded and not gathered else [None] * len(grads)
        dot, na, nb, nd = mesh_sum(rows, likes).tolist()
        rel = abs(res["loss"] - ref[0]) / abs(ref[0])
        cos = dot / (na * nb) ** 0.5
        rel_l2 = (nd / nb) ** 0.5
        res.update(loss_rel=rel, grad_cos=cos, grad_rel_l2=rel_l2,
                   ref_loss=ref[0])
        ok = (rel <= TP_F32_LOSS_RTOL and rel_l2 <= TP_F32_GRAD_REL_L2
              if mp == "no" else
              rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS)
        if not ok:
            res["failures"].append(f"{label}: loss rel {rel}, gradient "
                                   f"cosine {cos}, relative L2 {rel_l2} "
                                   f"against one process")
    del ref
    if gathered:
        del grads_cmp
    trainer.state.apply_gradients(grads)
    if split:
        del grads
        _tp_checkpoint(res, label, trainer, workdir, mp, save)
    elif sharded:
        del grads
        _save_peak(res, label, trainer)
    else:
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, _bits_digest(
            list(trainer.state.params.values())))
        res["params_equal"] = len(set(digests)) == 1
        if not res["params_equal"]:
            res["failures"].append(f"{label}: the ranks' parameters differ "
                                   f"after the step")
        del grads
    del trainer, batch
    torch.cuda.empty_cache()


def _save_peak(res, label, trainer):
    """Phase 8d: ``trainer.save()`` of the sharded state. Its peak device
    memory above what this rank held before must stay within twice the
    largest whole tensor of the state (``gather_to_first`` gathers one
    tensor at a time into rank 0's host memory; a gather of the whole
    state to every rank would add the state's size)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    path = trainer.save()
    torch.cuda.synchronize()
    res["save_s"] = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - base
    largest = max(p.numel() * p.element_size()
                  for p in trainer.state.params.values())
    res.update(save_peak_extra_gib=extra / 2 ** 30,
               largest_tensor_gib=largest / 2 ** 30)
    if path is not None:
        res["state_gib"] = os.path.getsize(
            os.path.join(path, "state.pt")) / 2 ** 30
    if extra > 2 * largest:
        res["failures"].append(f"{label}: a save took {extra} bytes of "
                               f"device memory, over twice the largest "
                               f"tensor ({largest})")


def _training_models(over=None):
    import torch
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.models import vae as vae_mod

    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    torch.manual_seed(SEED + 2)
    amd = amd_mod.AMDModelNew(cfg.replace(**PAR_DEPTH, **(over or {})),
                              device="cuda", dtype=torch.float32)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.bfloat16).eval()
    vae.requires_grad_(False)
    return amd, vae


def _long_window_sites(cfg, world):
    """(site, tokens a call, calls) of one long-window sampling call with
    the VAE encodes and decode: the attentions whose local block reaches
    ``_FLASH_MIN_LOCAL`` run kernel hops."""
    lat = cfg.image_height * cfg.image_width // cfg.image_patch_size ** 2
    steps, layers = LONG_WINDOW_STEPS, cfg.diffusion_num_layers
    return [("VAE mid-block (4 encodes, 1 decode)", 1024, 5),
            ("object encoder", cfg.object_motion_token_num + lat,
             cfg.object_enc_num_layers),
            ("camera encoder", cfg.video_frames, cfg.camera_enc_num_layers),
            ("DiT object joint", 2 * cfg.object_motion_token_num + 2 + lat,
             layers * steps),
            ("DiT camera joint", 2 * lat, layers * steps),
            ("DiT temporal", cfg.video_frames, layers * steps)]


def rank_long_window(res, vae):
    """Phase 8c, second part: one sampling call at the long window of
    ``benchmarks/bench_longwindow.py`` (flagship widths, 64 frames, 64
    camera tokens) with ring attention over 2 ranks: the VAE encodes, the
    sampler and the decode, with the launches the sites' local blocks
    give (a kernel-hop call: P streaming forwards), against the same call
    with ``auto`` attention in one process (rank 0; CLIP_MEAN_ATOL and
    CLIP_P99_ATOL)."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.models import vae as vae_mod
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.parallel.mesh import create_mesh
    from hivae_tpu_torch.parallel.ring_attention import (
        _FLASH_MIN_LOCAL, sequence_sharded_sdpa)

    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = amd_mod.AMDConfig(
        enc_nhead=8, enc_ndim=64, diffusion_attn_head_dim=64,
        diffusion_attn_num_heads=16, diffusion_out_channels=4,
        use_filter=True, use_grey=True, video_frames=LONG_WINDOW,
        camera_motion_token_num=LONG_WINDOW, camera_motion_token_channel=16,
        object_motion_token_num=4, object_motion_token_channel=512,
        motion_token_channel=512, diffusion_model_type="spatial",
        attn_impl="ring", **PAR_DEPTH)
    torch.manual_seed(SEED + 3)
    amd = amd_mod.AMDModelNew(cfg, device="cuda", dtype=torch.bfloat16).eval()
    sites = _long_window_sites(cfg, world)
    kernel_calls = sum(n for _, s, n in sites
                       if s // world >= _FLASH_MIN_LOCAL)
    plain_calls = sum(n for _, s, n in sites) - kernel_calls
    res["sites"] = [(name, s, s // world, n) for name, s, n in sites]
    rgb, grey = synthetic_clip(SEED + 60, frames=LONG_WINDOW + 1)

    def run():
        with torch.no_grad():
            pix = torch.from_numpy(rgb).cuda()[None]
            gpix = torch.from_numpy(grey).cuda()[None]
            lat = [vae_mod.vae_encode(vae, x) for x in (
                pix[:, 1:], pix[:, :1].expand_as(pix[:, 1:]), gpix[:, 1:],
                gpix[:, :1].expand_as(gpix[:, 1:]))]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
            _, z, _ = amd_mod.sample(amd, *lat,
                                     sample_step=LONG_WINDOW_STEPS,
                                     generator=gen)
            return vae_mod.latents_to_rgb(vae_mod.vae_decode(vae, z.float()))

    attn_ops.install_attn_impl(cfg, create_mesh((1, 1, world),
                                                device_type="cuda"))
    _zero_counts()
    sequence_sharded_sdpa.calls.update(kernel=0, plain=0)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    res["ms"] = (time.perf_counter() - t0) * 1e3
    res["counts"] = counts = _read_counts()
    res["calls"] = dict(sequence_sharded_sdpa.calls)
    want = dict(_no_launches(), stream_attention=world * kernel_calls)
    want_calls = {"kernel": kernel_calls, "plain": plain_calls}
    if counts != want or res["calls"] != want_calls:
        res["failures"].append(f"long window: launches {counts}, want "
                               f"{want}; ring calls {res['calls']}, want "
                               f"{want_calls}")
    res["shape"] = list(out.shape)
    if rank == 0:
        attn_ops.set_default_implementation("auto")
        want_out = run()
        diff = (out.int() - want_out.int()).abs().float()
        res["mean_diff"] = diff.mean().item()
        res["p99_diff"] = torch.quantile(diff.flatten()[::7], 0.99).item()
        if not (res["mean_diff"] <= CLIP_MEAN_ATOL and
                res["p99_diff"] <= CLIP_P99_ATOL):
            res["failures"].append(f"long window vs auto: mean "
                                   f"{res['mean_diff']} p99 "
                                   f"{res['p99_diff']}")
    del amd
    torch.cuda.empty_cache()


def rank_parallel_steps(res, workdir):
    """On 2 ranks, phases 8a (ring of 2), 8b (data parallel), 8c (ring
    step and long window), 8d (the FSDP step) and 8f (the weight
    tensor-parallel steps, bf16 and fp32)."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.parallel.mesh import create_mesh

    sub = res.setdefault("phases", {})
    failures = res["failures"]

    def phase(name, fn, *args):
        # an error ends this rank (the others then fail in their next
        # collective), since its peers' collectives would no longer match
        import traceback
        r = {"failures": []}
        print(f"rank {dist.get_rank()}: {name}", flush=True)
        try:
            fn(r, *args)
        except Exception:
            r["failures"].append(traceback.format_exc())
            raise
        finally:
            sub[name] = r
            failures.extend(f"{name}: {f}" for f in r["failures"])

    def mesh(shape):
        return create_mesh(shape, device_type="cuda")

    amd, vae = _training_models()
    phase("ring_hops", rank_ring_hops)
    phase("dp_step", _step_against_reference, "data-parallel step (2, 1, 1)",
          amd, vae, mesh((2, 1, 1)), PAR_DP_CLIPS, workdir)
    del amd
    torch.cuda.empty_cache()
    amd, _ = _training_models(dict(attn_impl="ring"))
    phase("ring_step", _step_against_reference, "ring step (1, 1, 2)", amd,
          vae, mesh((1, 1, 2)), PAR_RING_CLIPS, workdir,
          _expected_ring_step_calls(amd.cfg))
    del amd
    torch.cuda.empty_cache()
    phase("long_window", rank_long_window, vae)
    # FSDP2's own collectives (all-gather, reduce-scatter) take CUDA
    # tensors through gloo here; sharding.gather_to_first/part_of avoid DTensor's
    # functional collectives, which crash in gloo's CUDA path
    amd, _ = _training_models()
    phase("fsdp_step", _step_against_reference, "FSDP step (1, 2, 1)", amd,
          vae, mesh((1, 2, 1)), PAR_FSDP_CLIPS, workdir)
    del amd
    torch.cuda.empty_cache()
    # phase 8f: the weights split over 'tensor' (attn_impl auto: the
    # kernels on each rank's 8 of 16 heads), bf16, then `--mp no` on an
    # fp32 SD-VAE
    amd, _ = _training_models()
    phase("tp_step", _step_against_reference,
          "tensor-parallel step (1, 1, 2)", amd, vae, mesh((1, 1, 2)),
          PAR_TP_CLIPS, workdir)
    del amd, vae
    torch.cuda.empty_cache()
    from hivae_tpu_torch.models import vae as vae_mod
    torch.manual_seed(SEED + 6)
    vae32 = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                  dtype=torch.float32).eval()
    vae32.requires_grad_(False)
    amd, _ = _training_models()
    phase("tp_step_f32", _step_against_reference,
          "tensor-parallel --mp no step (1, 1, 2)", amd, vae32,
          mesh((1, 1, 2)), PAR_TP_CLIPS, workdir, None, "no", True, False)


def rank_four(res, workdir):
    """The 4-rank spawn: phase 8a's ring of 4, then phase 8f's (1, 2, 2)
    step, FSDP2 over (data, fsdp) on the weights split over ``tensor``,
    against one process's step on rank 0 (``fsdp_tp``)."""
    import torch
    from hivae_tpu_torch.parallel.mesh import create_mesh

    rank_ring_hops(res)
    torch.cuda.empty_cache()
    sub = res["fsdp_tp"] = {"failures": []}
    amd, vae = _training_models()
    try:
        _step_against_reference(
            sub, "FSDP x tensor-parallel step (1, 2, 2)", amd, vae,
            create_mesh((1, 2, 2), device_type="cuda"), PAR_TP_CLIPS,
            workdir, ref_everywhere=False, save=False)
    finally:
        res["failures"].extend(sub["failures"])


def rank_nccl_init(res):
    """Phase 8d, first part: ``init_distributed`` with its default backend
    on CUDA (NCCL) at world size 1: an all-reduce and the mesh."""
    import torch
    import torch.distributed as dist
    from hivae_tpu_torch.parallel.mesh import create_mesh, init_distributed

    rank, world, dev = init_distributed()
    x = torch.full((8,), 3.0, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    mesh = create_mesh()
    res.update(backend=str(dist.get_backend()), world=world,
               device=str(dev), mesh=mesh.shape)
    if res["backend"] != "nccl" or x.sum().item() != 24.0 or \
            mesh.shape != {"data": 1, "fsdp": 1, "tensor": 1}:
        res["failures"].append(f"NCCL init: {res}, all-reduce sum "
                               f"{x.sum().item()}")


def rank_ring_serve(res, workdir):
    """Phase 8e, last part: one rank of ``cli.amd_inference`` (argv in
    ``<workdir>/serve_argv.json``) under a 2-rank launch with a ``ring``
    config: its ring calls against the attention calls whose sequences
    divide by the ring (kernel hops where the local block reaches
    ``_FLASH_MIN_LOCAL``), no ``sdpa_plain``, rank 0 alone writes; rank 0
    saves the frames it hands to the mp4 writer as ``serve_frames.npy``."""
    import numpy as np
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.data import video as vio
    from hivae_tpu_torch.ops import attention as attn_ops
    from hivae_tpu_torch.parallel import ring_attention as ra

    with open(os.path.join(workdir, "serve_argv.json")) as f:
        argv = json.load(f)
    want = {"kernel": 0, "plain": 0}
    route = attn_ops.kernel_route

    def counted_route(q, k, v=None, implementation=None):
        if q.shape[2] % 2 == 0 and k.shape[2] % 2 == 0:
            want["kernel" if q.shape[2] // 2 >= ra._FLASH_MIN_LOCAL
                 else "plain"] += 1
        return route(q, k, v, implementation)
    attn_ops.kernel_route = counted_route
    frames = {}
    write = vio.write_video

    def record(path, video, *a, **k):
        frames[os.path.basename(path)] = np.asarray(video)
        return write(path, video, *a, **k)
    vio.write_video = record
    _zero_counts()
    ra.sequence_sharded_sdpa.calls.update(kernel=0, plain=0)
    t0 = time.perf_counter()
    rc = amd_inference.main(argv)
    res.update(rc=rc, s=time.perf_counter() - t0,
               calls=dict(ra.sequence_sharded_sdpa.calls), want_calls=want,
               counts=_read_counts(), wrote=sorted(frames))
    first = os.environ["RANK"] == "0"
    if rc != 0 or res["calls"] != want or not sum(want.values()) or \
            res["counts"]["sdpa_plain"] or len(frames) != int(first):
        res["failures"].append(f"ring serve: rc {rc}, ring calls "
                               f"{res['calls']}, want {want}, launches "
                               f"{res['counts']}, wrote {sorted(frames)}")
    for video in frames.values():
        np.save(os.path.join(workdir, "serve_frames.npy"), video)


def rank_main(args) -> int:
    """One rank of a phase-8 process group (``--rank-phase``): this card,
    gloo from torchrun's variables (NCCL for ``nccl``); writes
    ``<workdir>/<phase>_rank<r>.json``."""
    import faulthandler
    import traceback
    import torch
    import torch.distributed as dist

    faulthandler.enable()   # a crash in native code still shows where
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.set_device(0)
    rank = int(os.environ["RANK"])
    res = {"failures": []}
    try:
        if args.rank_phase == "nccl":
            rank_nccl_init(res)
        elif args.rank_phase == "serve":   # the CLI starts its own group
            rank_ring_serve(res, args.workdir)
        else:
            dist.init_process_group(
                "gloo", init_method="env://",
                world_size=int(os.environ["WORLD_SIZE"]), rank=rank)
            if args.rank_phase == "ring_hops":
                rank_ring_hops(res)
            elif args.rank_phase == "four":
                rank_four(res, args.workdir)
            elif args.rank_phase == "clis":
                rank_clis(res, args.workdir)
            else:
                rank_parallel_steps(res, args.workdir)
    except Exception:
        res["failures"].append(traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(args.workdir,
                           f"{args.rank_phase}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 1 if res["failures"] else 0


def time_hops(fa):
    """The ring's two hop kinds at HOP_TOKENS local tokens (a block of 16
    heads of 64, q against one visiting block): forward and backward ms
    with CUDA events, back to back. Returns {tokens: {...}}."""
    import torch
    from hivae_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    table = {}
    for s in HOP_TOKENS:
        shape = (1, 16, s, 64)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        scale = 64 ** -0.5
        out, lse = fa.stream_attention(q, k, v, scale=scale)
        delta = fa.stream_attention_delta(do, out)
        dfp = (do.float() * out.float()).sum(-1, keepdim=True)
        row = dict(
            kernel_fwd=_time_ms(lambda: ra._hop_fwd_kernel(q, k, v, None,
                                                           scale), 20),
            plain_fwd=_time_ms(lambda: ra._hop_fwd_plain(q, k, v, None,
                                                         scale), 20),
            kernel_bwd=_time_ms(lambda: ra._hop_bwd_kernel(
                q, k, v, None, do, lse, delta, scale), 20),
            plain_bwd=_time_ms(lambda: ra._hop_bwd_plain(
                q, k, v, None, do, lse, dfp, scale), 20))
        table[s] = row
        _log(f"  hop at {s} local tokens {shape}: kernel fwd "
             f"{row['kernel_fwd']:.4f} ms, plain fwd {row['plain_fwd']:.4f}"
             f" ms; kernel bwd (dQ + dK/dV) {row['kernel_bwd']:.4f} ms, "
             f"plain bwd {row['plain_bwd']:.4f} ms")
    return table


def _log_phases(result):
    """Log rank 0's sub-phases of phase 8 -> {path: launches}."""
    paths = {}
    for name, sub in result["phases"].items():
        _log(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in sub.items()
                                       if k not in ("failures", "counts")))
        for f in sub["failures"]:
            _log(f"  {name} FAILED: {f}")
        if "counts" in sub:
            _log(f"  {name}: launches "
                 f"{ {k: n for k, n in sub['counts'].items() if n} }")
            paths[f"par_{name}"] = sub["counts"]
    return paths


def run_parallel(fa, failures):
    """Phase 8. Returns {path: launches} of rank 0's runs."""
    import shutil
    work = os.path.join(ROOT, "hivae_tpu_torch", "build", "chip_smoke_par")
    shutil.rmtree(work, ignore_errors=True)
    paths = {}
    try:
        _log(f"phase 8: parallelism; the ranks are processes sharing this "
             f"card over gloo (NCCL refuses two ranks on one device): no "
             f"time here is a collective's on a cluster; {_card_line()}")
        _log("phase 8a: ring hops at their kernel and plain shapes")
        time_hops(fa)
        # the 4-rank spawn works beside the 2-rank one: six processes
        # share the card and the host, so both take longer than alone
        t0 = time.perf_counter()
        four = start_ranks("four", 4, work)
        try:
            ranks = spawn_ranks("steps", 2, work)
        finally:
            ranks_four = wait_ranks(four)
        res = _rank_results("phase 8 (2 ranks)", ranks, failures)
        _log(f"  2 and 4 ranks side by side: {time.perf_counter() - t0:.1f} "
             f"s with process start and model builds")
        if res:
            paths.update(_log_phases(res[0]))
            save = res[-1]["phases"].get("fsdp_step", {})
            _log(f"  fsdp_step save (rank {len(res) - 1}): peak extra "
                 f"{save.get('save_peak_extra_gib')} GiB, "
                 f"{save.get('save_s')} s")
        res = _rank_results("phase 8a, 8f (4 ranks)", ranks_four, failures)
        if res:
            _log(f"  ring of 4 (rank 0): ms {res[0].get('ms')}, errors "
                 f"{res[0].get('errors')}")
            paths["par_ring_hops_4"] = res[0].get("counts", _no_launches())
            paths.update(_log_phases({"phases": {
                "fsdp_tp_step": res[0].get("fsdp_tp", {"failures": []})}}))
        # phase 8g's ranks (with 8e's --mesh 1,1,2 run) work while 8d and
        # the rest of 8e run: two groups of processes share the card and
        # the host, so their times are longer than alone
        _log("phase 8g: cli.train_a2m, cli.train_t2m and cli.train_mae on 2 "
             "ranks (data parallel, gloo), after cli.train_amd --mesh 1,1,2; "
             "started here, read after phase 8e")
        clis = start_parallel_clis(os.path.join(work, "clis"))
        try:
            _log("phase 8d: init_distributed on its default backend (NCCL) "
                 "at world size 1")
            res = _rank_results("phase 8d (NCCL)",
                                spawn_ranks("nccl", 1, work), failures)
            if res:
                _log(f"  NCCL: {res[0]}")
            _log("phase 8e: the training CLI on 2 ranks, --mesh 2,1,1 "
                 "(gloo)")
            paths.update(run_parallel_cli(work, failures))
        finally:
            _log("phases 8e (--mesh 1,1,2) and 8g: the ranks' results")
            paths.update(finish_parallel_clis(clis, _card_line(), failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


def run_parallel_cli(work, failures):
    """Phase 8e: ``python -m hivae_tpu_torch.cli.train_amd --mesh 2,1,1
    --dist_backend gloo`` in 2 processes on phase 7's synthetic mp4s, 2
    steps at a global batch of RUN_A_CLIPS, then ``cli.amd_inference`` in
    this process on the checkpoint it wrote, and in 2 processes with its
    config's ``attn_impl`` set to ``ring`` (``rank_ring_serve``), whose
    frames are held to this process's. (Its ``--mesh 1,1,2`` run goes
    with phase 8g's ranks.)"""
    import shutil
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import train_amd
    from hivae_tpu_torch.data import video as vio

    videos = os.path.join(work, "videos")
    exp = os.path.join(work, "exp")
    ckpts = os.path.join(exp, "mesh", "checkpoints")
    write_training_videos(videos)
    with open(CONFIG) as f:
        par_cfg = dict(json.load(f), **PAR_DEPTH)
    par_config = os.path.join(work, "config_par.json")
    with open(par_config, "w") as f:
        json.dump(par_cfg, f)
    argv = ["--video_dir", videos, "--output_dir", exp, "--exp_name", "mesh",
            "--amd_config", par_config,
            "--train_batch_size", str(RUN_A_CLIPS),
            "--mp", "bf16", "--remat", "true", "--mu_dtype", "bf16",
            "--seed", str(SEED), "--max_train_steps", "2",
            "--save_checkpoint_interval_step", "2", "--mesh", "2,1,1",
            "--dist_backend", "gloo"]
    t0 = time.perf_counter()
    ranks = spawn_ranks("cli", 2, work, cmd=[
        sys.executable, "-m", "hivae_tpu_torch.cli.train_amd"] + argv)
    wall = time.perf_counter() - t0
    for r, (rc, text, _) in enumerate(ranks):
        if rc != 0:
            failures.append(f"train_amd --mesh 2,1,1: rank {r} exited {rc}:"
                            f"\n{text[-3000:]}")
    out0 = ranks[0][1]
    final = [l for l in out0.splitlines() if l.startswith("final metrics")]
    _log(f"  2 ranks, 2 steps: {wall:.1f} s with process start, model "
         f"build and checkpoint; {final[-1] if final else 'no metrics'}")
    if not final or any("final metrics" in t for _, t, _ in ranks[1:]) or \
            sorted(os.listdir(ckpts)) != ["checkpoint-2"]:
        failures.append(f"train_amd --mesh 2,1,1: rank 0 output "
                        f"{out0[-500:]!r}")
        return {}
    one = os.path.join(work, "one")
    os.makedirs(one)
    shutil.copy(os.path.join(videos, "train0.mp4"), one)
    cfg = train_amd.build_config(train_amd.parse_args(argv))
    config = os.path.join(exp, "mesh", "config.json")
    frames = {}
    write = vio.write_video

    def record(path, video, *a, **k):
        frames["one"] = torch.from_numpy(np.asarray(video).copy())
        return write(path, video, *a, **k)
    vio.write_video = record
    try:
        launches = run_inference_cli(
            config, ckpts, one, os.path.join(work, "recon"), cfg, failures,
            label="amd_inference on the 2-rank checkpoint")
    finally:
        vio.write_video = write

    # the same checkpoint served by 2 ranks with a ring config
    with open(config) as f:
        ring_cfg = dict(json.load(f), attn_impl="ring")
    ring_config = os.path.join(work, "config_ring.json")
    with open(ring_config, "w") as f:
        json.dump(ring_cfg, f)
    with open(os.path.join(work, "serve_argv.json"), "w") as f:
        json.dump(["--amd_config", ring_config, "--amd_ckpt", ckpts,
                   "--video_dir", one, "--output_dir",
                   os.path.join(work, "recon_ring"), "--sample_step", "2",
                   "--dist_backend", "gloo"], f)
    t0 = time.perf_counter()
    res = _rank_results("phase 8e (ring serve)",
                        spawn_ranks("serve", 2, work), failures)
    _log(f"  amd_inference, ring config, 2 ranks: "
         f"{time.perf_counter() - t0:.1f} s with process start and model "
         f"build; " + "; ".join(
             f"rank {r}: ring calls {x.get('calls')}, wrote {x.get('wrote')}"
             for r, x in enumerate(res)))
    got = os.path.join(work, "serve_frames.npy")
    if "one" in frames and os.path.exists(got):
        _clip_diff("ring serve (2 ranks) vs one process",
                   torch.from_numpy(np.load(got)), frames["one"], failures)
    else:
        failures.append("phase 8e (ring serve): no frames to compare")
    return {"cli_mp4_mesh_trained": launches}


# phase 8g: the head training CLIs over 2 ranks: global batches (A2M as
# phase 7d, T2M 1 clip a rank, MAE_L as phase 7f), steps each; phase 8e's
# `--mesh 1,1,2` training CLI goes first in the same ranks, at a global
# batch of TP_CLI_CLIPS (both ranks of the tensor group take every row)
HEAD_CLIS = ("a2m", "t2m", "mae")
HEAD_STEPS = 2
HEAD_LOSS_RTOL = 1e-2
# the first step's grad_norm and averaged gradients (their sketches'
# relative L2) against one process's: a sum the ranks do not divide, or
# an average over the wrong group, is off by O(1) (the parameters after
# one AdamW step cannot show it: its first update is g / |g|)
HEAD_GRAD_RTOL = 1e-2
TP_CLI_CLIPS = 2


def _head_module(kind):
    from hivae_tpu_torch.cli import train_a2m, train_amd, train_mae, train_t2m
    return {"a2m": train_a2m, "t2m": train_t2m, "mae": train_mae,
            "tp": train_amd}[kind]


def _head_trainer_class(kind):
    return getattr(_head_module(kind), f"{kind.upper()}Trainer")


def _cli_inputs(work):
    """Phase 8g's inputs under ``work``: phase 7d's A2M index (mp4s,
    seeded embeddings, a pose stream) and head at A2M_CLI_LAYERS, phase
    7e's T2M tree at T2M_CLI_LAYERS, phase 7f's MAE videos, one frozen
    AMD_N as a reference-named ``.safetensors``, and phase 8e's flagship
    config at ``PAR_DEPTH`` -> ({kind: argv}, {kind: launches a rank})."""
    import pickle
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import train_amd

    videos, poses = (os.path.join(work, d) for d in ("videos", "poses"))
    write_training_videos(videos)
    write_training_videos(poses)
    rng = np.random.RandomState(SEED + 70)
    spec = a2m_spec()
    model = spec["model"]
    index = []
    for i in range(CLI_VIDEOS):
        emb = os.path.join(videos, f"train{i}.npy")
        np.save(emb, rng.randn(CLI_VIDEO_FRAMES, model["audio_block"],
                               model["audio_inchannel"]).astype(np.float32))
        index.append({"video_path": os.path.join(videos, f"train{i}.mp4"),
                      "audio_emb_path": emb,
                      "pose_path": os.path.join(poses, f"train{i}.mp4")})
    with open(os.path.join(work, "index.pkl"), "wb") as f:
        pickle.dump(index, f)
    tree = os.path.join(work, "tree")
    for i, cls in enumerate(("clsA", "clsB")):
        write_training_videos(os.path.join(tree, cls), count=T2M_VIDEOS // 2,
                              frames=T2M_VIDEO_FRAMES,
                              start=i * T2M_VIDEOS // 2)
    mae_videos = os.path.join(work, "mae_videos")
    write_training_videos(mae_videos, count=MAE_TRAIN_CLIPS,
                          frames=MAE_VIDEO_FRAMES)
    amd, _ = build_serving_models()
    cfg = amd.cfg
    amd_st = os.path.join(work, "amd_n.safetensors")
    write_safetensors(amd_st, _reference_named(amd))
    del amd, _
    torch.cuda.empty_cache()
    a2m_json = os.path.join(work, "a2m.json")
    with open(a2m_json, "w") as f:
        json.dump(dict(spec, model=dict(
            model, motion_num_token=cfg.object_motion_token_num,
            diffusion_num_layers=A2M_CLI_LAYERS)), f)
    with open(CONFIG) as f:
        par_cfg = dict(json.load(f), **PAR_DEPTH)
    par_config = os.path.join(work, "config_par.json")
    with open(par_config, "w") as f:
        json.dump(par_cfg, f)
    run = ["--output_dir", work, "--max_train_steps", str(HEAD_STEPS),
           "--save_checkpoint_interval_step", "1000",
           "--dataloader_num_workers", "2", "--dist_backend", "gloo"]
    frozen = ["--amd_config", CONFIG, "--amd_ckpt", amd_st,
              "--video_frames", str(WINDOW)]
    argv = {
        "tp": ["--video_dir", videos, "--amd_config", par_config,
               "--exp_name", "tp", "--train_batch_size", str(TP_CLI_CLIPS),
               "--mp", "bf16", "--mu_dtype", "bf16", "--seed", str(SEED),
               "--mesh", "1,1,2"] + run,
        "a2m": ["--a2m_config", a2m_json, "--video_dir",
                os.path.join(work, "index.pkl"), "--exp_name", "a2m",
                "--train_batch_size", str(A2M_TRAIN_CLIPS)] + frozen + run,
        "t2m": ["--video_dir", tree, "--exp_name", "t2m",
                "--t2m_config", _write_t2m_inputs(work, T2M_CLI_LAYERS),
                "--train_batch_size", "2"] + frozen + run,
        "mae": ["--video_dir", mae_videos, "--model_type", "MAE_L",
                "--exp_name", "mae", "--train_batch_size",
                str(MAE_TRAIN_CLIPS), "--lr_warmup_steps", "1"] + run}
    enc = cfg.object_enc_num_layers
    tp_cfg = train_amd.build_config(train_amd.parse_args(argv["tp"]))
    per_step = {
        "tp": {k: v for k, v in
               _expected_step_launches(tp_cfg, False).items() if v},
        "a2m": dict(full_block_attention=2 * enc, stream_attention=4),
        "t2m": dict(full_block_attention=enc + T2M_CLI_LAYERS,
                    full_block_attention_bwd=T2M_CLI_LAYERS,
                    full_block_attention_delta=T2M_CLI_LAYERS,
                    stream_attention=4),
        "mae": dict(full_block_attention=8, full_block_attention_bwd=8,
                    full_block_attention_delta=8, stream_attention=1)}
    return argv, per_step


def rank_clis(res, workdir):
    """Phases 8e (``--mesh 1,1,2``) and 8g, one rank: ``cli.train_amd``,
    then ``cli.train_a2m``, ``cli.train_t2m`` and ``cli.train_mae``
    ``main`` in turn, in the process group this rank started (argv in
    ``<workdir>/clis_argv.json``): each run's exit code, launches and
    whether it printed its final metrics; for the heads each step timed
    to a device synchronise, the first step's rows of the batch saved
    (rank order makes the global batch) with its metrics and a sketch of
    its averaged gradients (``_sketch``), and a digest of the parameters
    at the end."""
    import contextlib
    import io
    import numpy as np
    import torch
    import torch.distributed as dist

    with open(os.path.join(workdir, "clis_argv.json")) as f:
        argv, per_step = json.load(f)
    rank = dist.get_rank()
    for kind in ("tp",) + HEAD_CLIS:
        rec = {"times": [], "failures": []}
        res[kind] = rec
        seen = {}
        cls = None if kind == "tp" else _head_trainer_class(kind)
        step_fn = None if cls is None else cls.train_step

        def timed(trainer, batch, *a, **k):
            undo = None
            if not rec["times"]:
                np.savez(os.path.join(workdir, f"{kind}_batch{rank}.npz"),
                         **{n: np.asarray(v) for n, v in batch.items()
                            if not isinstance(v, list)})
                undo = _keep_grad_sketch(trainer, rec)
            t0 = time.perf_counter()
            out = step_fn(trainer, batch, *a, **k)
            torch.cuda.synchronize()
            rec["times"].append(time.perf_counter() - t0)
            if undo is not None:
                undo()
            if "metrics" not in rec:
                rec["metrics"] = {n: float(v) for n, v in out.items()}
            seen["trainer"] = trainer
            return out
        if cls is not None:
            cls.train_step = timed
        buf = io.StringIO()
        try:
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rec["rc"] = _head_module(kind).main(argv[kind])
            rec["s"] = time.perf_counter() - t0
        finally:
            if cls is not None:
                cls.train_step = step_fn
            print(buf.getvalue(), flush=True)
        rec["printed"] = "final metrics" in buf.getvalue()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["counts"] = counts = _read_counts()
        want = dict(_no_launches(), **{n: v * HEAD_STEPS
                                       for n, v in per_step[kind].items()})
        tr = seen.get("trainer")
        rec["digest"] = None if tr is None else _bits_digest(
            list(tr.state.params.values()))
        if rec["rc"] != 0 or counts != want or \
                (cls is not None and len(rec["times"]) != HEAD_STEPS):
            rec["failures"].append(f"cli.train_{kind} (2 ranks): rc "
                                   f"{rec['rc']}, steps {len(rec['times'])}"
                                   f", launches {counts} want {want}")
        res["failures"].extend(rec["failures"])
        del seen, tr
        torch.cuda.empty_cache()


def start_parallel_clis(work):
    """Write phase 8g's inputs and start its 2 ranks (``rank_clis``) ->
    (handle, argv, launches a step)."""
    argv, per_step = _cli_inputs(work)
    with open(os.path.join(work, "clis_argv.json"), "w") as f:
        json.dump([argv, per_step], f)
    return start_ranks("clis", 2, work), argv, per_step


def finish_parallel_clis(started, card, failures):
    """Phases 8e (``--mesh 1,1,2``) and 8g, after ``start_parallel_clis``:
    the 2 ranks' runs (launches a rank exact, rank 0 alone prints); the
    ``--mesh 1,1,2`` checkpoint served by ``cli.amd_inference`` in this
    process; each head CLI's first step run again here on the same global
    batch (the ranks' rows in rank order), draws and initial weights:
    its loss within HEAD_LOSS_RTOL of the ranks', its grad_norm and
    gradients within HEAD_GRAD_RTOL of the ranks' averaged ones (both
    ranks' the same bits), and its 2-rank checkpoint resumed here, the
    parameters' digest the ranks'. Returns {path: launches}."""
    import shutil
    import numpy as np
    import torch
    from hivae_tpu_torch.cli import train_amd
    from hivae_tpu_torch.training import checkpoint as ckpt_lib

    handle, argv, _ = started
    work = handle[1]
    t0 = time.perf_counter()
    ranks = wait_ranks(handle)
    res = _rank_results("phases 8e, 8g (2 ranks)", ranks, failures)
    _log(f"  2 ranks: {time.perf_counter() - t0:.1f} s after the other "
         f"phase 8e runs, with process start, the models' builds and saves")
    paths = {}
    kinds = ("tp",) + HEAD_CLIS
    if len(res) != 2 or any("counts" not in r.get(k, {})
                            for r in res for k in kinds):
        failures.append("phases 8e, 8g: a rank ended before its CLI runs: "
                        f"{[sorted(r) for r in res]}")
        return paths
    r0, r1 = res[0]["tp"], res[1]["tp"]
    paths["par_cli_tp"] = r0["counts"]
    ckpts = os.path.join(work, "tp", "checkpoints")
    found = sorted(os.listdir(ckpts)) if os.path.isdir(ckpts) else []
    _log(f"  cli.train_amd --mesh 1,1,2, 2 ranks, {HEAD_STEPS} steps of "
         f"{TP_CLI_CLIPS} clips: {r0['s']:.1f} s with the model build and "
         f"checkpoint, peak {r0['peak_gib']:.2f} GiB a rank; launches a "
         f"rank { {k: v for k, v in r0['counts'].items() if v} }; "
         f"checkpoints {found}; {card}")
    if not (r0["printed"] and not r1["printed"] and
            found == [f"checkpoint-{HEAD_STEPS}"]):
        failures.append(f"train_amd --mesh 1,1,2: rank 0 prints "
                        f"{r0['printed']}, rank 1 {r1['printed']}, "
                        f"checkpoints {found}")
    else:
        one = os.path.join(work, "one")
        os.makedirs(one, exist_ok=True)
        shutil.copy(os.path.join(work, "videos", "train0.mp4"), one)
        paths["cli_mp4_tp_trained"] = run_inference_cli(
            os.path.join(work, "tp", "config.json"), ckpts, one,
            os.path.join(work, "recon_tp"),
            train_amd.build_config(train_amd.parse_args(argv["tp"])),
            failures, label="amd_inference on the --mesh 1,1,2 checkpoint")
    for kind in HEAD_CLIS:
        r0, r1 = res[0][kind], res[1][kind]
        times = r0.get("times") or [float("nan")]
        later = sorted(times[1:] or times)
        step_s = later[(len(later) - 1) // 2]
        clips = {"a2m": A2M_TRAIN_CLIPS, "t2m": 2,
                 "mae": MAE_TRAIN_CLIPS}[kind]
        paths[f"par_heads_{kind}"] = r0["counts"]
        mod = _head_module(kind)
        args = mod.parse_args(argv[kind] + ["--device", "cuda"])
        batch = {}
        for r in range(2):
            with np.load(os.path.join(work, f"{kind}_batch{r}.npz")) as z:
                for n in z.files:
                    batch.setdefault(n, []).append(z[n])
        batch = {n: np.concatenate(v) for n, v in batch.items()}
        built = mod.build(args, torch.device("cuda"))
        # (model, vae) of the MAE, (head, frozen AMD, vae) of the heads
        modules = built[:2] if kind == "mae" else built[1:4]
        one = _head_trainer_class(kind)(*modules, args,
                                        os.path.join(work, f"ref_{kind}"))
        mine = {}
        undo = _keep_grad_sketch(one, mine)
        metrics = one.train_step(batch)
        undo()
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        want = r0.get("metrics", {}).get("loss", float("nan"))
        rel = abs(loss - want) / abs(loss)
        gn_rel = abs(gnorm - r0.get("metrics", {}).get(
            "grad_norm", float("nan"))) / abs(gnorm)
        g_rel = _sketch_rel(r0.get("grad_sketch"), mine.get("grad_sketch"))
        same = r0.get("grad_sketch") == r1.get("grad_sketch")
        one.state.load_state_dict(ckpt_lib.CheckpointManager(
            os.path.join(work, kind, "checkpoints")).restore(
                map_location="cuda"))
        digest = _bits_digest(list(one.state.params.values()))
        resumed = one.state.step == HEAD_STEPS and digest == r0["digest"]
        _log(f"  cli.train_{kind}, 2 ranks of {clips // 2} clips: step "
             f"times {[round(t * 1e3, 2) for t in times]} ms (median after "
             f"the first {step_s * 1e3:.2f} ms, {clips / step_s:.3f} "
             f"clips/s), peak {r0['peak_gib']:.2f} GiB a rank, "
             f"{r0['s']:.1f} s with build and save; first loss {want} "
             f"against one process's {loss} (rel {rel:.2e}), grad_norm "
             f"rel {gn_rel:.2e}, averaged gradients' rel L2 {g_rel:.2e} "
             f"(sketched; ranks' the same bits {same}); launches a "
             f"rank { {k: v for k, v in r0['counts'].items() if v} }; "
             f"checkpoint resumed here: {resumed}; {card}; gloo through "
             f"host memory on one card, not NCCL")
        if not (rel <= HEAD_LOSS_RTOL and gn_rel <= HEAD_GRAD_RTOL and
                g_rel <= HEAD_GRAD_RTOL and same and resumed and
                r0["printed"] and not r1["printed"] and
                r0["digest"] == r1["digest"]):
            failures.append(f"cli.train_{kind} (2 ranks): first loss {want} "
                            f"against one process's {loss}, grad_norm rel "
                            f"{gn_rel:.2e}, gradients' rel L2 {g_rel:.2e} "
                            f"(ranks' equal {same}), resumed "
                            f"{resumed}, rank 0 alone prints "
                            f"{r0['printed'] and not r1['printed']}, ranks' "
                            f"digests equal {r0['digest'] == r1['digest']}")
        del one, built, modules
        torch.cuda.empty_cache()
    return paths


def profile_call(fn, out_dir, filename, label):
    """One call of ``fn`` under torch.profiler: the device's busy share of
    its wall time and the kernel table, written to DIR/``filename``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    line = (f"profiled {label} wall {wall * 1e3:.2f} ms, device busy "
            f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}%)")
    _log("  " + line)
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        f.write(f"card: {_card_line()}\n{line}\n\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=50))
    _log(f"  profile written to {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also write torch.profiler tables and the kernels "
                         "line (kernels.json) here")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout (e.g. the parent commit unpacked "
                         "under _archive/): build its kernels too and time "
                         "its full-block forward, qk-norm forward, "
                         "backward, streaming forward and backward and "
                         "int8 FFN-up beside these")
    ap.add_argument("--rank-phase",
                    choices=["steps", "ring_hops", "four", "nccl", "serve",
                             "clis"],
                    help=argparse.SUPPRESS)   # one rank of phase 8
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        _log("chip_smoke: no CUDA device; this script runs on an NVIDIA card")
        return 2
    if args.rank_phase:
        return rank_main(args)
    sys.path.insert(0, ROOT)
    from hivae_tpu_torch.ops.kernels import _build
    from hivae_tpu_torch.ops.kernels import flash_attention as fa
    from hivae_tpu_torch.ops.kernels import quant_ffn as qf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    start = time.perf_counter()
    failures = []
    card = _card_line()
    _log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    _log("phase 1: build")
    t0 = time.perf_counter()
    _build.build()
    _log(f"  built {', '.join(_build.KERNEL_SOURCES)} in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in _ptxas_summary(log):
            _log(f"  {name}: {line}")
    parent = parent_qf = None
    if args.parent:
        parent, parent_qf = _load_kernels(args.parent)
        parent._build.build()
        _log(f"  built the kernels of {args.parent}")

    _log("phase 2: kernels vs plain versions")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = (check_kernels(fa, failures, parent=parent)
               + [check_qknorm(fa, failures, parent),
                  check_quant_ffn(qf, failures, parent_qf)]
               + check_bwd_kernels(fa, failures, parent=parent)
               + check_f32_kernels(fa, failures, sms, parent)
               + check_f16_kernels(fa, failures))
    _log("phase 2b: sdpa in fp32 and fp16, an fp32 VAE encode, int8 at "
         "M <= 17")
    check_repairs(failures)
    _log(f"phase 2c: sdpa at head dims {HEAD_DIMS_ODD} and the tiles "
         f"{HEAD_DIMS_TILES} in bf16, fp16 and fp32, D {HEAD_DIM_PLAIN} "
         f"plain")
    check_head_dims(failures)
    _log(f"phase 2d: sdpa at head dims {HEAD_DIMS_WIDE} on the wide "
         f"streaming kernels in bf16, fp16 and fp32, the keyless row's "
         f"gradient, AttentionBlock2D at 1024 channels, times at "
         f"{WIDE_TIMED}")
    t0 = time.perf_counter()
    wide_records, wide_paths = check_wide_head_dims(failures, parent)
    records += wide_records
    _log(f"  phase 2d took {time.perf_counter() - t0:.1f} s")

    _log("phase 3: full-width AMD_N + SD-VAE clip reconstruction")
    serving = build_serving_models()
    paths = dict(wide_paths)
    paths["clip"], latency, bf16_clip = run_clip(serving, args, failures)
    _log("phase 3c: the same clip with the fused qk-norm kernel")
    paths["clip_qknorm"], _ = run_qknorm_clip(serving, bf16_clip, failures)
    _log("phase 3w: the same clip with AMD_N and the SD-VAE in fp16")
    paths["clip_f16"], _ = run_f16_clip(failures)
    torch.cuda.empty_cache()
    paths.update(run_serving_paths(serving, failures))
    _log("phase 3i: checkpoint round trip and the inference CLI")
    cli_launches = run_checkpoint_roundtrip(serving, failures)
    if cli_launches is not None:
        paths["cli_mp4"] = cli_launches
    _log("phase 3m: audio to video, the flagship A2M head and AMD_N")
    a2v_paths, _, _ = run_a2v(serving, card, failures)
    paths.update(a2v_paths)
    _log(f"phase 3n: A2V with the LearnableToken and SimpleAdaLN heads at "
         f"{A2M_CLI_LAYERS} layers, AMD_N at {EXPORT_DEPTH}")
    heads_models = build_serving_models(EXPORT_DEPTH)
    paths.update(run_a2v_heads(heads_models, card, failures))
    del heads_models
    _log("phase 3q: T2M sample at full width (20 layers, 16 x 128) on "
         "AMD_N's camera tokens, an int and a text label")
    paths.update(run_t2m_sample(serving, card, failures))
    _log("phase 3b: the int8 (w8a8) clip")
    paths["clip_int8"], _ = run_int8_clip(serving, bf16_clip, latency,
                                          args, failures)
    del serving
    torch.cuda.empty_cache()
    _log(f"phase 3v: cli.export_sampler's module exported at full width "
         f"and a cut depth (AMD_N built anew, {WINDOW} frames, "
         f"{EXPORT_STEPS} steps), bf16 then int8 (--quant int8), saved, "
         f"loaded and run against the live module")
    export_models = build_serving_models(EXPORT_DEPTH)
    paths.update(run_export_sampler(export_models, None, card, failures))
    paths.update(run_export_sampler(export_models, "int8", card, failures))
    del export_models
    _log("phase 3m: the int8 A2V clip (AMD_N and the head at a cut "
         "depth)")
    paths.update(run_a2v_int8(card, failures))
    _log("phase 3n: the int8 A2V clip with the LearnableToken head")
    paths.update(run_a2v_int8(card, failures,
                              model_type="A2MModel_LearnableToken"))
    _log("phase 3o: the grid A2M head, sample_grid and its loss")
    paths.update(run_grid_head(card, failures))
    _log("phase 3p: cli.vis on the PosePre yaml (fp32)")
    paths.update(run_vis_cli(card, failures))
    _log("phase 3s: cli.frequency_filter_decode, fft and wavelet (fp32 VAE)")
    paths.update(run_frequency_decode_cli(card, failures))
    _log(f"phase 3t: cli.evaluate at full width, {EVAL_VIDEOS} clips, "
         f"{EVAL_STEPS} steps, LPIPS")
    paths.update(run_evaluate_cli(card, failures))
    _log("phase 3u: rope_attention, VelocityDiTSplitInput and "
         "DiT2Condition in bf16")
    paths.update(run_longtail_blocks(card, failures))
    _log("phase 3r: the CNN motion AE and the discriminators")
    paths.update(run_other_models(card, failures))
    paths.update(run_amd_family(failures))

    _log(f"phase 4: training run A, N={RUN_A_CLIPS}, MSE loss")
    models = build_training_models()
    paths["train_A"], _ = run_training(
        fa, models, failures, label="run A", clips=RUN_A_CLIPS,
        steps=RUN_A_STEPS, profile_dir=args.profile)
    torch.cuda.empty_cache()
    _log(f"phase 4b: one run-A step under each remat policy (the "
         f"flagship at {PAR_DEPTH})")
    paths.update(run_remat_policies((build_variant(PAR_DEPTH),) +
                                    models[1:], failures))
    torch.cuda.empty_cache()

    _log(f"phase 5: training run B, N={RUN_B_CLIPS}, perceptual loss, "
         f"mask ratios 0.5, the flagship at {PAR_DEPTH}")
    paths["train_B"], _ = run_training(
        fa, (build_variant(PAR_DEPTH),) + models[1:], failures,
        label="run B", clips=RUN_B_CLIPS, steps=RUN_B_STEPS, perceptual=True,
        mask_ratio=0.5, resume_check=True)
    torch.cuda.empty_cache()
    _log(f"phase 5b: validate, N={RUN_A_CLIPS}, sample_step "
         f"{VALIDATE_STEPS}")
    paths["validate"] = run_validate(models, failures, args.profile)
    _log(f"phase 5c: --mp no training (fp32 compute, an fp32 SD-VAE; the "
         f"flagship at {PAR_DEPTH}), N={F32_STEP_CLIPS}, then the "
         f"perceptual loss and QKNORM_FUSE at N=1")
    paths.update(run_training_f32(fa, (build_variant(PAR_DEPTH),) +
                                  models[1:], failures))
    torch.cuda.empty_cache()
    _log(f"phase 5d: fp16 training (fp16 autocast, an fp16 SD-VAE; the "
         f"flagship at {PAR_DEPTH}), N={F16_STEP_CLIPS}, then the perceptual "
         f"loss under QKNORM_FUSE at N=1")
    paths.update(run_training_f16(build_variant(PAR_DEPTH), models[2],
                                  failures))
    _, vae, lpips = models
    del models
    torch.cuda.empty_cache()

    for name, (over, unused) in VARIANTS.items():
        _log(f"phase 6: one training step of the {name} variant {over}, "
             f"N={RUN_A_CLIPS}, at {PAR_DEPTH}")
        amd = build_variant(dict(over, **PAR_DEPTH))
        profile = args.profile if name == "default_dit" else None
        paths[f"train_{name}"], _ = run_training(
            fa, (amd, vae, lpips), failures, label=name, clips=RUN_A_CLIPS,
            steps=1, unused=unused, profile_dir=profile,
            profile_name=f"profile_train_{name}.txt")
        del amd
        torch.cuda.empty_cache()
    for label, name, over, clips, steps in FAMILY_STEPS:
        _log(f"phase 6b: training {name} {over}, N={clips}, {steps} timed "
             f"step(s)")
        amd = build_family_model(name, torch.float32, SEED + 3, remat=True,
                                 **over)
        paths[f"train_{label}"], _ = run_training(
            fa, (amd, vae, lpips), failures, label=label, clips=clips,
            steps=steps)
        del amd
        torch.cuda.empty_cache()
    del vae, lpips
    torch.cuda.empty_cache()

    _log(f"phase 7: the training CLI on {CLI_VIDEOS} mp4s, N={RUN_A_CLIPS}")
    paths.update(run_train_cli(failures, args.profile))
    torch.cuda.empty_cache()
    _log(f"phase 7d: cli.train_a2m, N={A2M_TRAIN_CLIPS}, then a resume and "
         f"cli.a2v_inference on its checkpoint")
    paths.update(run_train_a2m_cli(card, failures))
    _log("phase 7e: T2M training, the step at full depth and cli.train_t2m")
    paths.update(run_train_t2m(card, failures))
    _log(f"phase 7f: cli.train_mae, MAE_L, N={MAE_TRAIN_CLIPS}, then "
         f"reconstruct")
    paths.update(run_train_mae(card, failures))

    paths.update(run_parallel(fa, failures))

    for rec in records + [r["delta"] for r in records if "delta" in r]:
        if not any(p[rec["name"]] for p in paths.values()):
            failures.append(f"{rec['name']}: launched by no timed path")
    _log(f"total {time.perf_counter() - start:.1f} s")
    if failures:
        _log("FAILED:\n  " + "\n  ".join(failures))
        return 1
    print(card)
    def launches(name):
        return {path: counts[name] for path, counts in paths.items()}
    for r in records:
        if "delta" in r:
            summarise(r["delta"], launches(r["delta"]["name"]))
    line = json.dumps({"kernels": [summarise(r, launches(r["name"]))
                                   for r in records]})
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        with open(os.path.join(args.profile, "kernels.json"), "w") as f:
            f.write(f"{card}\n{line}\n")
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
