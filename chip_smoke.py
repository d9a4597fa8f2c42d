#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hma_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,2,3,...]   (default: all twenty-six)

Phases, each failing the run on any error:
  1. device: the card's name and power limit (nvidia-smi), the device count;
  2. build: the seven CUDA sources from hma_tpu_torch/csrc with nvcc, one
     process each, with the build time, what `-Xptxas -v` reports and the
     HMMA (tensor-core) instructions of each kernel's SASS;
  3. kernels against their plain PyTorch versions at the main paths' shapes
     (phase 14's rollout and training shapes, and phase 18's simulator steps
     at B 1: K1' (1, 320, 8, 32) and (1, 128, 8, 64), K6' at N 6) and one
     ragged shape each, fp32 and bf16:
     - K1' (spatial) and K3' (temporal) forwards, out and lse. fp32: atol =
       rtol = 1e-5. bf16: lse to 1e-5, out to a limit per kernel (BF16_TOL)
       and at most 1 % of outputs differing from the plain version at all;
       a negative control must exceed that share: for K1' the plain version
       without the bf16 rounding of the probs, for K3' (which keeps fp32
       probs, as its TPU kernel does) the plain version with it;
     - K2' and K4' backwards, dq, dk and dv from the same out, lse and a
       strided dout. fp32: atol = rtol = BWD_FP32_TOL. bf16: BWD_BF16_TOL
       and the 1 % share; the negative control is the plain backward with
       the other kernel's rounding of p and ds (K2' rounds, K4' does not);
     - K5' (the resident layout's entry) forward and backward at the d512
       card's (B, T, S, H, D) = (8, 12, 128, 8, 64) and a ragged shape, on
       views of one (B, T, S, 3, H, D) projection, with K3''s and K4''s
       limits and controls, and bit for bit against K3'/K4' on the same
       values regrouped to (B*S, T, H, D);
     - K6' (the fused denoise loop) against its plain version after all K
       steps, at the d512 card's shape (K 100, N 48, C 16, H 1024, depth 4),
       at the reference algorithm's (N 512: 7 bf16 passes of 80 rows), a
       ragged one (N 45, `domain_ln`), a small one, one with no residual
       block, and the two ends of the shared-memory budget over more than
       one bf16 pass (H 1152 at N 100, H 128 at N 170), with and without classifier-free
       mixing (n_half, cfg 2.0), clipping both ways, temperature 0.8, each
       case on inputs from a seed of its own, as max |x - ref| / max |ref|:
       fp32 against the plain version computed in fp64 (K6_FP32_TOL), bf16
       against the plain version in bf16 (K6_BF16_TOL); two negative
       controls in fp32 must exceed the fp32 limit: the plain version
       reading `mods` in forward order, and the plain version adding noise
       at the last step too; and one bf16 step
       at a mid-schedule row, through all blocks and through the first
       alone, where the kernel must be K6_STEP_MARGIN times nearer to the
       plain version than two bf16 controls are: the plain version computed
       in fp32, and with each bias added before the product is rounded;
     - K1' and K2' also at edge shapes (SPATIAL_EDGES: S 1, 17, 320 and
       1024, causal and not, D 32 and 64, the other cards' D 16 and 61, and
       D 12, 20, 24, 27 and 40, in bf16 blocks of 2 and of 4 warps; at S 1
       no control applies, p being 1), K3' and K4' at theirs
       (TEMPORAL_EDGES: T 1, 12 and 16, a ragged last site tile, 3 heads,
       D 16, 61, 12, 20, 24, 27 and 40 besides 32 and 64) and K5' at T 1, 12
       and 16 with a ragged S (RESIDENT_EDGES, D 16, 61, 12, 20, 24 and 27
       too), with the same limits and controls; every D but 16, 32 and 64
       runs the ragged path (zero-padded to the next of them inside the
       kernel);
     - K1'-K5' on rows one element past a 16-byte boundary: at D 64 each
       forward must raise ValueError and, on copies, equal the plain
       version, and each backward copies a misaligned dout itself; at D 61
       (views of a (..., 3, H, 61) projection) forward and backward take
       the views as they are and equal the plain version;
     then kernel, plain and library times with CUDA events, device-bound
     (`cuda_ms`: a sleep queued before the start event holds the device
     until the host has enqueued every timed call, and the start event must
     still be pending when the end event is enqueued; K6''s plain loop is
     captured in a CUDA graph and replayed), with the host's enqueue time
     beside each and, but for K6', two input sets cycled so that B 96 inputs
     are not served from the L2 (the library call is a yardstick the port
     never calls: SDPA's forward for K1'/K3',
     the backward alone of SDPA, on a retained graph, for K2'/K4'; no one
     PyTorch call computes K6''s function; SDPA's causal forward / backward
     on the regrouped sites for K5'); and K6' at depth 0 and 4, N 1, 48
     and 512, to tell a residual block's time from the rest of a step;
  4. rollouts at full width: the d256 card (32 layers, d 256, T 12, S 256 +
     64 action tokens, 2 x 512 vocab) with the 40-domain synthetic action
     fields and random weights from seed 0. The cached per-frame forward is
     held to the full forward in fp32 at B = 1 (EXACT_TOL), and two planted
     cache faults must exceed that limit; then the KV-cached rollout and
     the full-recompute rollout run at B = 8, 2 prompt frames, 2 MaskGIT
     steps, bf16, temperature 0, with the kernels' launch counts set to 0
     just before each and read just after;
  5. entry point: `hma_tpu_torch.generate.main` on a synthetic dataset and a
     2-layer d256 checkpoint written to a temporary directory;
  6. training at full width: the same card in bf16 with remat ("full") and
     the domain-sliced AdamW (lr 1e-4, wd 0.01), B = 8 of bench.py's batch
     (random tokens from seed 0, the first half of each frame 1.. masked).
     One warm-up step, then TRAIN_STEPS timed steps with the launch counts
     set to 0 just before and read just after (64/32/64/32 of K1'/K2'/K3'/
     K4' per step: remat runs each forward twice); median step time,
     tokens/s, peak memory, a profiler breakdown and the device's busy
     share; finite loss and grad norm, nothing skipped. Then OVERFIT_STEPS
     steps on the fixed batch at lr 3e-4, wd 0: the loss must fall by at
     least OVERFIT_MARGIN;
  7. gradient exactness: a 2-layer d256 card at B = 2 in fp32, one loss and
     backward with the kernels on the card against the plain versions on
     the CPU: loss to 1e-5 relative, every parameter gradient to
     max |dg| <= GRAD_TOL * max |g| per tensor;
  8. entry point: `hma_tpu_torch.train_multi.main` for a few steps of a
     2-layer d256 card on a synthetic dataset, then phase 5's generate from
     the checkpoint it wrote;
  9. the continuous family at full width: the d512 STMAR card (32 layers,
     d 512, 8 heads of 64, T 12, 64 patch tokens of dim 16 + 64 action
     tokens, diffusion head depth 4 x width 1024, 100 sampling steps, 16
     MaskGIT steps) with the 40-domain synthetic action fields, random
     weights from seed 0, synthetic latents and actions. (a) fp32, B = 1:
     the cached per-frame `frame_latents` against `compute_latents`
     (MAR_EXACT_TOL), and a planted cache fault must exceed the limit;
     (a') fp32, N 48: K6' inside `DiffLoss.sample` against the whole net at
     every step (premod=False) on the card's diffusion head and its
     40-domain twin with live adaLN and final_linear weights, without
     guidance and with cfg 2.0 (LIVE_HEAD_TOL), and the same sample with
     its normals shifted by one step must exceed the limit;
     (b) bf16, B = 8, 2 prompt frames, 10 generated, 16 x 100, no guidance:
     one warm-up rollout, then MAR_REPEATS timed ones with the launch counts
     set to 0 just before and read just after (160 of K6', 5504 of K1' a
     rollout), finite output, prompt frames unchanged, frames/s, peak
     memory; the profiler breakdown over a 4-frame window (2 generated);
     (c) the reference algorithm (`generate_latents_reference_algo`) once
     on the full 12-frame window with 11 prompt frames, so 1 generated
     frame: 16 full forwards (K1' and K3' at B T = 96) and 16 sampler calls
     of N = 512 rows;
 10. entry point: `hma_tpu_torch.generate.main(["--use_feature", ...])` on a
     synthetic latent dataset and a 2-layer d512 STMAR checkpoint;
 11. STMAR training at full width: the d512 card (mlp_drop 0.05 live) in
     bf16 with remat and the domain-sliced AdamW (fp32 moments), B = 8 of
     phase 9's latents and actions masked by the port's latent collator. In
     each temporal layout, "transpose" then "resident" (the same model): one
     warm-up step, then TRAIN_STEPS timed steps with the launch counts set to
     0 just before and read just after (64/32 of K1'/K2' per step, and
     64/32 of K3'/K4' or of K5' forward/backward), median step time, patch
     and trunk tokens/s, peak memory, a profiler breakdown; finite loss and
     grad norm, nothing skipped; the two medians' difference (reported, not
     claimed). Then MAR_OVERFIT_STEPS steps on the fixed batch at lr 3e-4,
     wd 0, with the diffusion timesteps, noise and dropout masks fixed: the
     loss must fall by at least MAR_OVERFIT_MARGIN;
 12. STMAR gradient exactness: a 2-layer d512 card at B = 2 in fp32 with
     every parameter perturbed, in both layouts, the draws and dropout masks
     handed in: loss to 1e-5 relative and every gradient to GRAD_TOL, the
     kernels on the card against the plain versions on the CPU;
 13. entry point: `hma_tpu_torch.train_multi.main(["--model_type",
     "continuous", ...])` for a few steps of a 2-layer d512 STMAR card on a
     synthetic latent dataset, then phase 10's generate from its checkpoint;
 14. the four other shipped cards (OTHER_CARDS: magvit d128, D 16; magvit
     d512, d_model 488, D 61; mar d128, D 16; mar d256, D 32) at full width
     and depth with the 40-domain synthetic action fields and random
     weights from seed 0: (i) the fp32 cached forward against the full
     forward at B 1 (EXACT_TOL, MAR_EXACT_TOL) and a zeroed cache slot that
     must exceed the limit; (ii) one bf16 training step at B 8 after a
     warm-up (remat, the domain-sliced AdamW), in both temporal layouts but
     on the magvit d128 card, finite, nothing skipped, with the launches of
     `train_launches`; their counts fill the timed rows of these shapes;
     (iii) one KV-cached rollout at B 8, bf16, 2 prompt + 2 generated
     frames (MaskGIT: 2 steps at temperature 0; MAR: 16 x 100, no
     guidance) with its K1' and K6' launches and its time a frame; the K1'
     launches fill the timed row of the card's rollout shape (B 8) and the
     mar cards' K6' launches phase 9's row (the denoise head is the same on
     every mar card). Every launch count of (ii) and (iii) must land in a
     record, so a main-path shape that phase 3 never checked fails the run;
 15. the evaluation rollout surface on the d256 card at full width and depth
     (B 8, T 12, bf16, weights from seed 0): (a) fp32 at B 1,
     `window_logits` over frames [2, 5) against `compute_logits`' frames
     (EXACT_TOL) and with slot 1 zeroed, which must exceed it; (b)
     `autoregressive_logits` with the prompt over all 12 frames equals
     `teacher_forced_logits` bit for bit, and with a 1-frame prompt its
     logits must move; (c) `generate_horizon` over frame 11 equals
     `generate_tokens_full`'s frame 11 token for token under the same
     draws, and other draws must change tokens; (d) teacher_forced_logits,
     autoregressive_logits (2 prompt frames), generate_horizon over frames
     [2, 4) and window_logits over [2, 5), 2 MaskGIT steps at temperature 0,
     each after a warm-up with its launch counts set to 0 just before and
     read just after (K1' 1056, 1408, 64 with 64 of K3', 32), frames/s and a
     profiler breakdown (the two cached paths' over a 4-frame window); every
     count lands in a phase-3 record (the window's K1' at B 24);
 16. the evaluation entry points on the card: `hma_tpu_torch.evaluate.main`
     teacher-forced (and once as `python -m hma_tpu_torch.evaluate`) and
     with --autoregressive_time on a 2-layer d256 checkpoint and a synthetic
     token dataset; `evaluate_feature.main` in both modes and `evaluate
     --use_feature` on a 2-layer d512 STMAR checkpoint and a synthetic latent
     dataset (4 MaskGIT steps); each JSON against the library functions on
     the same weights, batch and generator seed (EVAL_TOL), with its
     launch counts;
 17. the MagVit2 codec at full width (`VQConfig()`, 65.5M parameters, 256²
     images <-> 16² tokens, weights from seed 0: conv weights N(0, 1 /
     fan_in), zero biases, GroupNorm 1 and 0), on smooth synthetic frames:
     (a) fp32 on the card against the CPU at B 2: latents to CODEC_Z_TOL of
     max|z|, every token mismatch from a channel with |z| under that margin,
     decoded uint8 pixels within 1 level on >= 99 %; (b) bf16 against fp32
     on the card at B 8: the share of tokens that differ and the PSNR of the
     images decoded from the same tokens, each in its window
     (CODEC_BF16_TOKEN_SHARE, CODEC_BF16_PSNR), which three faults planted
     in the bf16 model must each leave (GroupNorm in bf16, its statistics
     rounded to bf16, the conv weights left in fp32); (c) bf16 times, device-bound: bench.py's
     encode_fps_256_b8, decode_fps_256_b8 and dec_time_ms_b1, peak memory,
     each against its bound (the convs' operations counted by hooks, the
     weights read once); (d) `evaluate --tokenizer_ckpt` (a full-width
     `.ckpt` in the reference layout, the weights as EMA shadows) with 2
     ΔPSNR trials on a 2-layer d256 checkpoint, then `--raw_image_data` on
     a synthetic 256² raw-image dataset: psnr, ssim, psnr_copy_prev and
     psnr_vs_copy against the library functions on the same samples
     (EVAL_TOL), delta_psnr and dec_time finite, launch counts;
 18. the simulator: GenieSimulator on the d256 card at full width and depth
     (bf16, 3 prompt frames, 2 MaskGIT steps, temperature 0) with phase 17's
     codec as its decoder, one warm-up step then 20 timed ones: model p50
     and IQR mean, the decode-inclusive p50 (bench.py's
     p50_onchip_ms_with_decode), a profiler breakdown and the busy share,
     its K1' launches; the fp32 2-layer card on the card against the CPU, 3
     steps at 1 MaskGIT step, token for token; the d512 STMAR card's
     simulator (16 x 100, latents out) for 3 steps after a warm-up, with
     its K1' and K6' launches; `sim.app.build_simulator` on a 2-layer d256
     checkpoint and the `.ckpt`, then `InteractiveDigitalWorld.run(3)`;
 19. the continuous family's pixel side: the SVD temporal VAE at full width
     (`SVDTemporalVAE()`, 97.7M parameters, weights from seed 0, every tensor
     perturbed, written as a diffusers-layout state-dict file): (a) fp32 on
     the card against the CPU through `load_svd_decoder` (a (1, 3, 8, 8, 4)
     clip of raw latents) and `encode` (its 64² frames), VAE_CARD_TOL of
     max|x|; (b) bf16 against fp32 on the card at the d512 card's grid (T
     12, 16² -> 128²): the PSNR in VAE_BF16_PSNR, which three faults planted
     in the bf16 VAE must each leave (GroupNorm in bf16, the residual stream
     in bf16, the conv weights left in fp32); (c) bf16 times as CUDA-graph
     replays, each against its bound (convs, linears and attention counted
     by hooks), with peak memory: decode at 16² and 32² (T 12), encode B 8
     at 256²; (d) InceptionV3 and I3D (videogpt, styleganv) in fp32 with
     TF32 off, BatchNorm statistics from the inputs: features card against
     CPU (BACKBONE_TOL), then 32 frames and 8 clips of 128² at the fp32
     bound; (e) `sim.app.build_simulator` on a full-width d512 STMAR
     checkpoint and the VAE file, at phase 18's settings: 3 steps after a
     warm-up, model p50 and with the 128² decode, a profile, 640 K1′ and 16
     K6′ a step; (f) `evaluate_feature --vae_checkpoint --compute_fid
     --compute_fvd` (styleganv) on a 2-layer d512 checkpoint, B 8, T 12:
     fid and fvd against the library functions on the same decoded clips
     (EVAL_TOL), with its launches;
 20. LPIPS and the tokenizer's GAN training: (a) LPIPS VGG and AlexNet from
     seeded state-dict files in the lpips layout (AlexNet's heads under
     `lins.`), fp32 card (TF32 off) against the CPU on 256² pairs
     (LPIPS_CARD_TOL), d(x, x) = 0, then B 8 at 256² against the fp32 bound
     (convs counted by hooks); (b) one GAN step of the full-width codec
     (`VQConfig()`, 65.49M) with the VGG LPIPS, fp32, card against CPU on a
     64² batch at gen_loss_weight 0.1 and None, and without LPIPS and the
     entropy term: logs, LeCam EMAs and running statistics (GAN_LOG_TOL),
     Adam moments (GAN_MOMENT_TOL; GAN_PLAIN_MOMENT_TOL in the last case),
     parameters and EMA where the moment fixes the update's sign
     (GAN_MASKED_PARAM_TOL); then bf16, GAN_BF16_STEPS steps at B 8 on one 256²
     batch, where reconstruct_loss must fall: step ms, images/s, peak
     memory, x bound, a profile; (c) `python -m hma_tpu_torch.train_tokenizer`
     (defaults: VQConfig(), B 8) on a synthetic 256² raw-image set for 4
     steps with the VGG LPIPS: its first step's logs against the library's
     step on the same batch (EVAL_TOL), `load_magvit2` returns its newest
     EMA, and `evaluate --tokenizer_ckpt` (B 8) runs on it; (d) train_multi
     on the 2-layer d256 card, B 8, with `--tokenizer_checkpoint` (that
     directory) and `--lpips_weights` (AlexNet): vis/rollout_psnr and
     vis/rollout_lpips against the library functions on the rollout's
     tokens (EVAL_TOL), every launch (training, eval, rollout) in a phase-3
     record; (e) `generate` (B 8) on a 2-layer d256 and a 2-layer d512 STMAR
     checkpoint (2 prompt and 2 generated frames), then `visualize` on each
     output (the trained tokenizer; a full-width SVD-VAE file): its frames
     equal the library's decode bit for bit, and its GIF and PNG files where
     Pillow imports;
 21. the encode pipeline and the native loader: (a) toyworld's train
     shards 0 and 1 of 60 at 256² (16 episodes, 640 frames) through
     `encode_extern.main --encoder_type magvit` (the released codec,
     `VQConfig()`, seed-0 weights written as phase 17 writes them, bf16, B
     64) with the resize, the codec and the file writing timed, a val shard,
     `merge_shards` and the token dataset; the fp32 codec on the card and on
     the CPU against an fp64 witness on the CPU, CARD_CPU_FRAMES frames: the
     card's distance at most FP64_WITNESS_RATIO times the CPU's, the bf16
     codec (a control) beyond it, the tokens that differ counted; the bf16
     share of tokens differing from fp32 on the card, first 64 frames, in
     phase 17's window; (b) `resize_image` on synthetic
     480x640 and 256x320 frames to 256², ms a frame on the host, against a
     plain float64 resize (jax.image.resize's triangle filter, weights
     written out): one level on at most RESIZE_SHARE of values; (c) toyworld
     at 128² through `make_svd_encoder` (the released SVD-VAE architecture,
     seed 0, bf16) and `encode_episodes`, and the merge; the fp32 encoder on
     the card before the float16 cast against the fp64 witness as in (a),
     the bf16 encode's float16 latents in the window SVD_BF16_WITNESS_RATIO,
     which four faults (GroupNorm in bf16, the conv weights left in fp32,
     SVD_SCALE left out, h and w swapped) must each leave;
     (d) `train_multi` on the merged tokens, the d256 card at full width and
     depth, B 8, TRAIN_STEPS steps with `--use_native_loader` and as many
     with the Python assembler (each run's batches counted: all from the
     loader, or all from the assembler): step cadence, the batches' host time, the
     device's busy share of one iteration under the profiler, the launches
     of phase 6's steps; then `--model_type continuous --use_native_loader`
     on the merged latents, the d512 STMAR card at 2 layers, 2 steps, finite
     losses and their launches; (e) GenieSimulator prompted with 3 uint8
     toyworld frames through `encode_image`: the d256 card (bf16, full
     depth) with (a)'s encoder, whose prompt tokens must equal (a)'s, and the
     d512 STMAR card at 2 layers with (c)'s (K6′ at N 6), whose prompt
     latents must equal (c)'s; one step each after a warm-up, timed;
 22. the rest of the model and training surface: (a) the d256 card with
     `action_network` "concat+cross_attention" and `jointly_predict_actions`
     (JOINT_CARD, written at run time; 40 domains, full width and depth):
     the training step as phase 6's (B 8, bf16, remat, the sliced AdamW;
     64/32/64/32 of K1'-K4' a step, finite loss and action_loss) beside
     phase 6's median; the 2-layer card in fp32 with the action mask handed
     in, card against CPU: logits and action_pred to 1e-5 of max|ref|, both
     losses likewise, every gradient to GRAD_TOL (the cross-attention's and
     the readout's among them); fp32 frame_logits = compute_logits
     (EXACT_TOL) with and without actions; the reference compat's full
     forward runs and its frame_logits raises; the cached rollout at B 8
     (2 prompt frames, 2 MaskGIT steps) with its K1' launches;
     `train_multi --action_network concat+cross_attention --mu_transfer` at
     2 layers, then `generate` from its checkpoint. (b) the d512 STMAR card
     at full width and depth, B 8: the step with fp32 moments and no muP,
     then with muP (width mult 2, the model built with use_mup) and bf16
     moments, each as phase 11's transpose step, with peak memory; its fall
     against the moments' bytes reckoned; every moment bf16;
     `stochastic_round` on the card against the CPU bit for bit on
     SR_ELEMENTS values with the specials; `train_multi --model_type
     continuous --mu_transfer --adam_moment_dtype bfloat16` at 2 layers,
     resumed from step 2, bit for bit with the straight run at step 4;
 23. sliced gradients and data parallelism: (a) the d512 STMAR card at
     full width and depth, B 8, as phase 22 (b)'s steps, with fp32 moments
     and then with muP and bf16 moments, each on one model and optimizer
     without and with sliced gradients in turns (full, sliced, sliced,
     full, ...; SLICED_STEPS timed steps of each), and the d256 card at
     phase 6's shapes likewise: median step, busy share (a profile), the
     peak memory of each step, and the fall in peak beside the stacked
     tables' fp32 grads reckoned; the launches of phase 6's steps; then the 2-layer fp32 cards of both
     families (STMAR's dropout live) one step with and one without sliced
     gradients at domain 5: parameters and moments within SLICED_TOL. (b)
     two ranks on the one card, a gloo group over CUDA tensors (this script
     started twice with --dp_worker), one sliced-gradient step of the
     2-layer d256 card in fp32, B 8 split 4 and 4 with unequal masked
     counts, against one process on the whole batch: loss and every grad
     the optimizer receives within DP_TOL, the ranks' parameters equal bit
     for bit; beside them `python -m hma_tpu_torch.train_multi` under
     torchrun's variables, a 1-rank NCCL group, on a 2-domain synthetic set
     (sliced gradients on, the row grads reduced over the group), 4 steps;
 24. fsdp: (a) in a 1-rank NCCL group in this process, FSDP2 over its mesh
     (`parallel.mesh.shard_model`) against the unwrapped model on the same
     weights and batch: the 2-layer fp32 cards of both families (40
     domains, STMAR's dropout live), 2 steps, parameters and moments within
     FSDP_TOL, the d256 one's (2 domains) FSDP2 checkpoint gathered and read
     into one unwrapped model bit for bit; the d512 STMAR card at full width
     and depth, B 8, with fp32 and then bf16 moments, and the d256 card at
     phase 6's shapes, full grads, FSDP_STEPS timed steps of each (the
     unwrapped run first, then the FSDP2 one): losses (the first bit for
     bit), median step, peak memory, 64/32/64/32 of K1'-K4' a d256 step;
     one STMAR `sample_tokens` through K6' on the gathered head against the
     unwrapped model, bit for bit, twice; (b) fsdp 2 over two gloo ranks
     sharing the card (this script started twice with --fsdp_worker),
     phase 23 (b)'s case, one full-grad step against one process: loss and
     each rank's shard of every grad within DP_TOL, each rank half the
     state's bytes; (c) beside (b), `train_multi --fsdp 1` in a 1-rank NCCL
     group resumed from (a)'s checkpoint for 4 steps.
25. tp (the heads and MLP features split over tensor-parallel ranks,
     `parallel.tensor_parallel`), gloo ranks sharing the card (this script
     started with --tp_worker), each against one process on the same
     weights, batch and draws: (a) tp 2, the d256 card at full width (8
     heads, 4 a rank, D 32) and TP_LAYERS["d256"] layers, one bf16 training
     step at B 8 (K1'-K4' at H 4; loss and each rank's grads against the
     matching dealt columns of one process's within TP_BF16_TOL), then the
     fp32 cached rollout greedy for 2 frames after 10 prompt frames (tokens
     equal in at least TP_TOKEN_SHARE); (b) tp 2, the d512 STMAR card at
     full width and TP_LAYERS["d512"] layers, the resident layout's bf16
     step (K5' at H 4) likewise, then the fp32 cached MAR rollout of one
     frame at B 2 with handed-in draws, K6' on the diffusion head gathered
     whole (latents within TP_FP32_TOL of max); (c) (fsdp 2, tp 2), four
     ranks, phase 23 (b)'s 2-layer fp32 d256 case, one full-grad step: loss
     and each rank's shard of every grad within DP_TOL. Each rank's launch
     counts, peak memory and step time beside one process's; phase 3's H 4
     records take (a)'s and (b)'s launches.
 26. sp (every frame's tokens split over sequence-parallel ranks,
     `parallel.sequence_parallel`), SP_RANKS gloo ranks sharing the card
     (this script started with --tp_worker at sp 2), each against one
     process on phase 25's weights, batches and draws (one process's runs
     are made once for both phases): (a) the d256 bf16 step, spatial
     attention through the all-to-all to whole frames of H 4 (K1'/K2' at
     (96, 320, 4, 32)), the temporal passes on a rank's 1280 sites (K3'/K4'
     at H 8), loss and every (whole) grad within TP_BF16_TOL, then the fp32
     cached rollout (tokens equal in at least TP_TOKEN_SHARE); (b) the d512
     STMAR resident bf16 step (K5' on a rank's 64 of 128 tokens) likewise,
     then the fp32 cached MAR rollout with handed-in draws (K6' on the
     gathered rows; within TP_FP32_TOL); each rank's caches hold half of a
     row's sites; its launch counts, bytes, peak memory and step time
     beside one process's; the exchange's time at (a)'s shapes. Phase 3's
     K1'/K2' (96, 320, 4, 32) records add (a)'s launches to phase 25's, its
     N 1280 and (8, 12, 64, 8, 64) records take (a)'s and (b)'s.

Prints one JSON line of kernel records, then the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores (TF32 off)
FP32_TOL = 1e-5  # fp32 out and lse; bf16 lse (it is fp32 in both)
# bf16 out, atol = rtol: about twice the worst reading on the card. Both
# versions round probs and out to bf16, so a different exp or summation
# order flips an output by one bf16 ulp now and then: ~1e-3 at K1''s
# |out| ~ 0.2, ~8e-3 at K3''s |out| ~ 1 (few frames, so larger outputs).
BF16_TOL = {"K1'": 4e-3, "K3'": 1e-2}
# Share of bf16 outputs that may differ from the plain version at all:
# such flips are rare (< 0.1 %), while a kernel that skips rounding the
# probs to bf16 before p v moves ~30-40 % of its outputs.
MISMATCH_LIMIT = 0.01
EXACT_TOL = 1e-5  # fp32 cached-vs-full logits, 32 layers deep
REPEATS = 3  # timed runs of each rollout
# K1'/K2' edge shapes, checked untimed: one key (the negative controls
# cannot apply: p is 1 exactly), a partial 16-row and 8-key fragment, 320
# keys and 16 key tiles; causal and not, D 32 and 64, the d128 cards' D 16,
# the magvit d512 card's D 61 (the ragged path, padded to 64), and the
# ragged path at every padded width: D 12 (padded to 16), 20, 24 and 27
# (to 32), 40 (to 64), with bf16 blocks of 2 warps (few blocks) and of 4
# (B 40: 320 blocks)
SPATIAL_EDGES = [((2, 1, 2, 32), False), ((2, 1, 2, 64), True),
                 ((2, 17, 3, 64), True), ((2, 17, 3, 32), False),
                 ((1, 1024, 2, 32), True), ((1, 1024, 2, 64), False),
                 ((2, 1, 2, 16), True), ((2, 1, 2, 61), False),
                 ((2, 17, 3, 16), False), ((2, 17, 3, 61), True),
                 ((2, 320, 2, 16), True), ((2, 320, 2, 61), False),
                 ((2, 320, 2, 61), True), ((3, 77, 4, 12), True),
                 ((40, 128, 4, 12), False), ((2, 17, 3, 24), False),
                 ((40, 128, 4, 24), True), ((3, 77, 4, 20), True),
                 ((40, 128, 4, 27), False), ((3, 77, 2, 40), True)]
# K3'/K4' edge shapes (N, T, H, D), checked untimed: one frame (no control
# applies, p being 1), 12 and MAX_T frames, a last site tile left ragged (N H
# not a multiple of the tile's rows), 3 heads; D 32, 64, 16, 61, and the
# ragged path at every padded width: D 12, 20, 24, 27 and 40
TEMPORAL_EDGES = [(77, 1, 8, 32), (77, 16, 8, 64), (45, 16, 3, 32), (45, 1, 3, 64),
                  (77, 1, 8, 16), (45, 12, 3, 16), (45, 16, 3, 16),
                  (77, 1, 8, 61), (45, 12, 3, 61), (45, 16, 3, 61), (45, 5, 3, 12),
                  (45, 12, 3, 24), (77, 16, 8, 20), (45, 5, 3, 27), (45, 12, 3, 40)]
# K5' edge shapes (B, T, S, H, D): one frame, 12 and MAX_T frames, with an S
# that leaves the last site tile ragged; D 64, 32, 16, 61, and the ragged
# path at DP 16 and 32: D 12, 20, 24 and 27
RESIDENT_EDGES = [(2, 1, 11, 8, 64), (2, 16, 13, 3, 32), (2, 1, 11, 8, 16),
                  (2, 16, 13, 3, 61), (2, 12, 13, 3, 16), (2, 12, 11, 8, 61),
                  (3, 5, 7, 3, 12), (2, 12, 13, 3, 24), (2, 16, 11, 8, 20),
                  (3, 5, 7, 3, 27)]
# Backward limits on dq, dk, dv. fp32: on an H100 (700 W) K2' reads 0 (the
# plain version's cuBLAS sums in the kernel's order) and K4' 7e-7 of
# max |g|. bf16, atol = rtol: about twice what the H100 readings need, a
# 1-ulp flip at |g| ~ 10 (K4': 6.25e-2 at |g| 35; K2': 0).
BWD_FP32_TOL = 1e-4
BWD_BF16_TOL = {"K2'": 1e-2, "K4'": 1e-2}
TRAIN_STEPS = 6  # timed training steps after one warm-up
OVERFIT_STEPS = 60
# The loss must fall by at least this much over OVERFIT_STEPS: half of the
# fall an H100 (700 W) reads (12.4258 -> 9.4164, from the weights the timed
# steps leave). The first ~30 steps rise and fall around the start (12.97 at
# step 5) before the batch is learnt: over 30 steps K1'/K2''s plain versions
# on the card read a fall of only 0.149 and the kernels 0.157; over 60, 3.39
# and 3.01.
OVERFIT_MARGIN = 1.5
GRAD_TOL = 1e-4  # phase 7: max |dg| <= GRAD_TOL * max |g| per tensor
# K6' after all K steps, as max |x - ref| / max |ref|. fp32: against the
# plain version computed in fp64 (every sum exact to fp32's eye). The kernel
# and the plain fp32 version each sum the products and LayerNorms in their
# own order (rsqrtf, expf and the division are the same functions), ~1e-7 a
# product, and on most inputs they stay within 1.5e-6 of the fp64 version
# and of each other. On one input (N 170, n_half 37, cfg 2.0, seed 67) the
# plain fp32 version lies 1.81e-5 from fp64 and the kernel 2.76e-6, so fp32
# against fp32 would read 2.09e-5 there with the kernel the nearer to exact
# (H100 80GB HBM3, 700 W). The kernel reads up to 2.8e-6 against fp64; the
# limit is 1e-5. bf16: both round at the same
# places, but a sum in another order flips a rounding now and then and every
# later layer and step carries it on; an H100 reads up to 7.2e-3, less than
# what bf16 rounding itself moves (bf16 plain against fp32 plain: up to
# 1.4e-2); the limit is about three times the worst reading.
K6_FP32_TOL = 1e-5
K6_BF16_TOL = 2e-2
# One bf16 step of K6' at a mid-schedule row, as mean |x - plain| / max
# |plain|: how many times nearer to the bf16 plain version the kernel must
# be than each of two controls (the plain version computed in fp32 on the
# same bf16 inputs; the bias added before the product is rounded). The 100-
# step limit above cannot tell these apart: it lies over what bf16 rounding
# itself moves. Through the first block alone few flipped roundings are
# carried on: an H100 reads the kernel 34 to 760 times nearer (1.2e-8 to
# 1.4e-6 against 8.2e-6 to 5.0e-5). At depth 4 one flip disturbs its whole
# row in every later layer (9 to 33 % of outputs differ) and the kernel reads
# 4.1 to 6.7 times nearer. Shapes of fewer than 512 outputs are left out:
# a handful of flips decides their mean.
K6_STEP_MARGIN = {"first block": 10.0, "all blocks": 3.0}
# fp32 cached frame_latents against compute_latents on the d512 card, 32
# layers deep, |z| <= 4.8: an H100 reads 5.0e-6 (the two paths sum their
# attention in other orders); ten times that, and 300 times under what the
# planted fault reads (1.6e-2).
MAR_EXACT_TOL = 5e-5
# Phase 9 (a'): K6' inside DiffLoss.sample against the whole net at every
# step, fp32, on the d512 head with live adaLN and final_linear weights, as
# max |x - net| / max |net|. The adaLN weights are drawn N(0, (scale /
# sqrt(fan_in))^2): at scale 1 the gates of these heads average |g| ~ 0.04
# and the residual blocks barely reach the sample; at 10, ~0.4. The two sum
# their products and LayerNorms in other orders: an H100 reads 1.043e-6
# first (card head, no guidance), up to 1.609e-6 over the four samples; the
# limit is ten times the first reading, and the normals shifted by one step
# read 0.41 to 0.65.
LIVE_ADALN_SCALE = 10.0
LIVE_HEAD_TOL = 1.043e-5
MAR_REPEATS = 1  # timed full rollouts of the d512 card after one warm-up
MAR_OVERFIT_STEPS = 30
# The d512 STMAR loss must fall by at least this much over MAR_OVERFIT_STEPS
# with its draws fixed: half of the fall an H100 (700 W) reads (0.7030 ->
# 0.4973, from the weights phase 11's timed steps leave).
MAR_OVERFIT_MARGIN = 0.1


def print_hmma_counts(build) -> None:
    """Phase 2: the tensor-core instructions (HMMA) in the SASS of each built
    library's kernels, as `cuobjdump --dump-sass` lists them."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  HMMA counts: cuobjdump not found", flush=True)
        return
    for name in build.SOURCES:
        sass = subprocess.run([tool, "--dump-sass", str(build._target(name))],
                              capture_output=True, text=True, timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and re.search(r"\bHMMA\b", line):
                counts[fn] += 1
        print(f"  HMMA in {name}: " + "; ".join(f"{f} {n}" for f, n in counts.items()),
              flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_config(num_domains: int = 40):
    """The d256 card plus synthetic per-domain action fields, the same ones
    `__graft_entry__._flagship_config` builds from seed 0 for the JAX bench."""
    from hma_tpu_torch.config import GenieConfig

    return with_synthetic_domains(GenieConfig.from_pretrained(
        str(ROOT / "hma_tpu_torch" / "configs" / "magvit_n32_h8_d256_action.json")),
        num_domains)


def mar_flagship_config(num_domains: int = 40):
    """The d512 STMAR card plus the same synthetic action fields, as
    `experiments/mar_probe.py:_config` builds them for the JAX bench."""
    from hma_tpu_torch.config import load_config

    return with_synthetic_domains(load_config(
        str(ROOT / "hma_tpu_torch" / "configs" / "mar_n32_h8_d512_action.json")),
        num_domains)


def with_synthetic_domains(cfg, num_domains: int):
    rng = np.random.default_rng(0)
    cfg.action_domains = [f"domain_{i}" for i in range(num_domains)]
    cfg.d_actions, cfg.action_stats = [], []
    for _ in range(num_domains):
        base = int(rng.integers(2, 8))
        stride = int(rng.integers(1, 4))
        cfg.d_actions.append(base * stride)
        cfg.action_stats.append([rng.normal(size=base).tolist(),
                                 (np.abs(rng.normal(size=base)) + 0.5).tolist()])
    return cfg


_CYCLES_PER_MS = []  # the card's clock, as torch.cuda._sleep counts it


def cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` a millisecond, measured once."""
    import torch

    if not _CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10**6)  # wake the clocks
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(10**7 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


class Timing(float):
    """A device time in ms (a float) with its host enqueue time, `host_ms`,
    and the sleep that held the device while the host enqueued, `held_ms`."""

    def __new__(cls, ms, host_ms, held_ms, graph):
        t = super().__new__(cls, ms)
        t.host_ms, t.held_ms, t.graph = host_ms, held_ms, graph
        return t

    def __str__(self):
        return (f"{float(self):.4f} ms (host {self.host_ms:.4f} ms a call; "
                f"{'one graph replay, ' if self.graph else ''}held by a "
                f"{self.held_ms:.1f} ms sleep, still pending at the end event)")


def cuda_ms(calls, iters: int = 20, warmup: int = 3, graph: bool = False) -> Timing:
    """Device time of one call, in ms: calls[i % len(calls)]() for i <
    iters, timed with CUDA events, device-bound. `calls` is a callable or a
    list of them (the same function on other input sets, so that inputs
    larger than half the 50 MB L2 are not served from it).

    A `torch.cuda._sleep` queued before the start event holds the device
    until the host has enqueued every timed call and the end event: the
    events then time the device's work back to back, not the host's enqueue
    rate. The check: an event recorded right after the sleep (the start) must
    still be pending once the end event is enqueued; if it is not, the sleep
    doubles and the timing repeats, four times at most, then the run fails.
    With `graph`, the calls are captured once in a CUDA graph and one replay
    is timed, held the same way: for a call of thousands of launches (K6''s
    plain loop), which would fill the device's launch queue and stall the
    host behind the sleep."""
    import torch

    calls = list(calls) if isinstance(calls, (list, tuple)) else [calls]
    for i in range(warmup):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                calls[i % len(calls)]()
        body = g.replay
    else:
        def body():
            for i in range(iters):
                calls[i % len(calls)]()
    t0 = time.perf_counter()
    body()  # sizes the sleep: twice the host's unsynchronised enqueue time
    held = max(2e3 * (time.perf_counter() - t0), 1.0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        torch.cuda._sleep(int(held * cycles_per_ms()))
        start.record()
        t0 = time.perf_counter()
        body()
        end.record()
        host = time.perf_counter() - t0
        pending = not start.query()
        torch.cuda.synchronize()
        if pending:
            return Timing(start.elapsed_time(end) / iters, host * 1e3 / iters, held, graph)
        held *= 2
    raise RuntimeError(f"chip_smoke: the device woke before the host had enqueued "
                       f"{iters} calls, even after a sleep of {held / 2:.1f} ms")


def strided_qkv(lead, H, D, dtype, seed):
    """q, k, v as SelfAttention._qkv hands them over: unit-stride views into
    one (..., 3, H, D) projection, q pre-scaled."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(*lead, 3, H, D, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(-3)
    return q * D**-0.5, k, v


def check_kernel(kernel, plain, control, args, tol, label):
    """Hold kernel(*args) to plain(*args); returns max |out - plain|. In
    bf16 also the share of outputs that differ, beside that of the negative
    control, control(*args)."""
    import torch

    out, lse = kernel(*args)
    torch.cuda.synchronize()
    want, want_lse = plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{label} out: {m}")
    torch.testing.assert_close(lse, want_lse, atol=FP32_TOL, rtol=FP32_TOL,
                               msg=lambda m: f"{label} lse: {m}")
    line = (f"  {label}: max|out-plain| {err:.3e} (tol {tol})  "
            f"max|lse-plain| {lse_err:.3e} (tol {FP32_TOL})")
    if out.dtype == torch.bfloat16:
        ctl = control(*args)
        share = (out != want).float().mean().item()
        ctl_share = (ctl != want).float().mean().item()
        ctl_err = (ctl.float() - want.float()).abs().max().item()
        line += (f"  differ {share:.4%} (limit {MISMATCH_LIMIT:.0%}); "
                 f"control: differ {ctl_share:.4%}, max err {ctl_err:.3e}")
        require(share <= MISMATCH_LIMIT, f"{label}: {share:.4%} of outputs differ")
        if args[1].shape[1] > 1:
            require(ctl_share > MISMATCH_LIMIT,
                    f"{label}: the check cannot tell the control apart")
        else:
            line += " (one key: p is 1 exactly, so no control applies)"
    print(line, flush=True)
    return err


def check_bwd(kernel, plain, control, args, tol, label):
    """Hold kernel(*args) = (dq, dk, dv) to plain(*args); returns the
    largest max |d - plain| of the three. In bf16 also the share of
    outputs that differ, beside the negative control's."""
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    ctl = control(*args) if got[0].dtype == torch.bfloat16 else None
    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for i, name in enumerate(("dq", "dk", "dv")):
        g, w = got[i], want[i]
        require(g.dtype == w.dtype and g.is_contiguous(), f"{label} {name} layout")
        err = (g.float() - w.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{label} {name}: {m}")
        part = f"{name} {err:.3e} (|g| <= {w.float().abs().max().item():.2f})"
        if ctl is not None:
            share = (g != w).float().mean().item()
            ctl_share = (ctl[i] != w).float().mean().item()
            part += f" differ {share:.4%}, control {ctl_share:.4%}"
            require(share <= MISMATCH_LIMIT, f"{label} {name}: {share:.4%} differ")
            if args[1].shape[1] > 1:  # one key: p is 1 exactly, no control applies
                require(ctl_share > MISMATCH_LIMIT,
                        f"{label} {name}: the check cannot tell the control apart")
        parts.append(part)
    print(f"  {label} (tol {tol}): " + "; ".join(parts), flush=True)
    return worst


def sdpa_forward(qkv, causal):
    """A call of SDPA's forward: the library yardstick of K1', K3' and K5'."""
    from torch.nn import functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in qkv)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=1.0)


def sdpa_backward(qkv, dout, causal):
    """A call of SDPA's backward alone, on a retained graph: the library
    yardstick of K2', K4' and K5' (q, k, v, dout in the kernels' layout)."""
    import torch
    from torch.nn import functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in qkv)
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=1.0)
    go = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True)


def strided_dout(lead, H, D, dtype, seed):
    """dout as a view with a unit D stride and larger strides elsewhere."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(*lead, 2, H, D, generator=g, device="cuda").to(dtype)[..., 0, :, :]


def bound(n_bytes, n_ops, flop_per_s=None):
    """The least time in ms: bytes at HBM's rate, or operations at the peak
    rate for their type (bf16 tensor cores unless told otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (flop_per_s or BF16_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timed_record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops, source,
                 replaces):
    """One kernel's record of the JSON line, printed: device-bound times
    (Timing) of the kernel, its plain version and the library call (None
    where there is none), the bound, and the errors {dtype: max abs err}."""
    import torch

    bound_ms, bound_by = bound(n_bytes, n_ops)
    host = {k: (None if t is None else t.host_ms)
            for k, t in (("host_ms", ms), ("plain_host_ms", plain_ms),
                         ("library_host_ms", library_ms))}
    lib = None if library_ms is None else float(library_ms)
    print(f"  {name} {shape} bf16: kernel {ms}; plain {plain_ms}; library "
          f"{library_ms if library_ms is not None else 'none'}; bound {bound_ms:.4f} ms "
          f"({bound_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP)"
          + (f"; {float(ms) / lib:.2f} x library" if lib else "")
          + f"; {float(ms) / bound_ms:.1f} x bound", flush=True)
    return {"name": name, "shape": list(shape), "dtype": "bf16", "route": "cuda",
            "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": errs[torch.bfloat16], "max_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32], "ms": float(ms),
            "kernel_ms": float(ms), "plain_ms": float(plain_ms), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, **host}


def kernel_phase():
    """Phase 3: correctness at every shape, times at the main-path shapes."""
    import torch

    from hma_tpu_torch.ops.fused_attention import (
        attention_bwd_plain, fused_attention, fused_attention_bwd,
        fused_attention_bwd_plain, fused_attention_plain)
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_bwd,
        fused_temporal_attention_bwd_plain, fused_temporal_attention_plain)

    records = []
    src = {"K1'": ("fused_attention_fwd", "hma_tpu/ops/fused_attention.py:54"),
           "K2'": ("fused_attention_bwd", "hma_tpu/ops/fused_attention.py:79"),
           "K3'": ("temporal_attention_fwd", "hma_tpu/ops/temporal_attention.py:36"),
           "K4'": ("temporal_attention_bwd", "hma_tpu/ops/temporal_attention.py:63")}

    def record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops):
        records.append(timed_record(name, shape, errs, ms, plain_ms, library_ms,
                                    n_bytes, n_ops, f"hma_tpu_torch/csrc/{src[name][0]}.cu",
                                    src[name][1]))

    def rounded_probs(q, k, v):  # K3''s control: probs rounded as K1 does
        return fused_attention_plain(q, k, v, True)[0]

    def unrounded_probs(q, k, v, causal):  # K1''s control
        return fused_attention_plain(q, k, v, causal, dtype=torch.float32)[0]

    # main-path shapes (timed): the d256 card's (B 24: phase 15's window of 3
    # frames; B 1: phase 18's simulator step, as the d512 STMAR card's), the
    # d512 STMAR card's, then
    # the four other cards' (phase 14): magvit d128, magvit d512 (d_model
    # 488, D 61), mar d128, mar d256, each card's cached rollout at B 8 and
    # its training step at B 8 x T 12 in the transpose layout
    spatial = [((8, 320, 8, 32), False, True), ((96, 320, 8, 32), False, True),
               ((24, 320, 8, 32), False, True),
               ((1, 320, 8, 32), False, True), ((1, 128, 8, 64), False, True),
               ((8, 128, 8, 64), False, True), ((96, 128, 8, 64), False, True),
               ((8, 320, 8, 16), False, True), ((8, 320, 8, 61), False, True),
               ((8, 128, 8, 16), False, True), ((8, 128, 8, 32), False, True),
               ((96, 320, 8, 16), False, True), ((96, 320, 8, 61), False, True),
               ((96, 128, 8, 16), False, True), ((96, 128, 8, 32), False, True),
               ((3, 77, 4, 64), True, False),
               # phases 25 and 26 (H 4 a rank after tp's split or sp's
               # exchange): the d256 step, the d512 STMAR step, the d256
               # cached rollout (B 8) and the MAR rollout (B 2)
               ((96, 320, 4, 32), False, True), ((96, 128, 4, 64), False, True),
               ((8, 320, 4, 32), False, True), ((2, 128, 4, 64), False, True)]
    spatial += [(s, c, False) for s, c in SPATIAL_EDGES]
    temporal = [((2560, 12, 8, 32), True), ((1024, 12, 8, 64), True),
                ((2560, 12, 8, 16), True), ((2560, 12, 8, 61), True),
                ((1024, 12, 8, 16), True), ((1024, 12, 8, 32), True),
                ((1000, 5, 3, 64), False), ((2560, 12, 4, 32), True),
                ((1280, 12, 8, 32), True)]  # phase 26's sp 2 d256 step: a rank's sites
    temporal += [(s, False) for s in TEMPORAL_EDGES]
    cases = ([("K1'", s, c, main) for s, c, main in spatial]
             + [("K3'", s, True, main) for s, main in temporal])
    for name, shape, causal, main in cases:
        lead, H, D = shape[:2], shape[2], shape[3]
        spatial_k = name == "K1'"
        kernel, plain, control = (
            (fused_attention, fused_attention_plain, unrounded_probs) if spatial_k
            else (fused_temporal_attention, fused_temporal_attention_plain,
                  rounded_probs))
        extra = (causal,) if spatial_k else ()
        errs = {}
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL[name])):
            q, k, v = strided_qkv(lead, H, D, dtype, seed=len(records))
            errs[dtype] = check_kernel(kernel, plain, control, (q, k, v, *extra), tol,
                                       f"{name} {shape} causal={causal} {dtype}")
        if not main:
            continue
        # two input sets, cycled: a B 96 set is 50-64 MB, more than half the L2
        sets = [strided_qkv(lead, H, D, torch.bfloat16, seed=seed) for seed in (1, 2)]
        ms = cuda_ms([lambda a=a: kernel(*a, *extra) for a in sets])
        plain_ms = cuda_ms([lambda a=a: plain(*a, *extra) for a in sets])
        library_ms = cuda_ms([sdpa_forward(a, causal) for a in sets])
        del sets
        n_rows = math.prod(lead) * H  # query rows
        n_bytes = 4 * math.prod(shape) * 2 + n_rows * 4  # q, k, v, out bf16; lse fp32
        keys = shape[1]
        pairs = keys * (keys + 1) // 2 if causal else keys * keys
        n_ops = 4 * (n_rows // keys) * pairs * D  # q.k and p.v, 2 ops per MAC
        record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops)

    # backward kernels, from the forward kernel's out and lse
    bwd_cases = [("K2'", (96, 320, 8, 32), False, True), ("K2'", (96, 128, 8, 64), False, True),
                 ("K2'", (96, 320, 8, 16), False, True), ("K2'", (96, 320, 8, 61), False, True),
                 ("K2'", (96, 128, 8, 16), False, True), ("K2'", (96, 128, 8, 32), False, True),
                 ("K2'", (3, 77, 4, 64), True, False), ("K2'", (96, 320, 4, 32), False, True),
                 ("K2'", (96, 128, 4, 64), False, True),
                 *(("K2'", s, c, False) for s, c in SPATIAL_EDGES),
                 ("K4'", (2560, 12, 8, 32), True, True), ("K4'", (1024, 12, 8, 64), True, True),
                 ("K4'", (2560, 12, 8, 16), True, True), ("K4'", (2560, 12, 8, 61), True, True),
                 ("K4'", (1024, 12, 8, 16), True, True), ("K4'", (1024, 12, 8, 32), True, True),
                 ("K4'", (1000, 5, 3, 64), True, False), ("K4'", (2560, 12, 4, 32), True, True),
                 ("K4'", (1280, 12, 8, 32), True, True),
                 *(("K4'", s, True, False) for s in TEMPORAL_EDGES)]
    for name, shape, causal, main in bwd_cases:
        lead, H, D = shape[:2], shape[2], shape[3]
        if name == "K2'":
            fwd = lambda q, k, v: fused_attention(q, k, v, causal)
            kernel = lambda *a: fused_attention_bwd(*a, causal)
            plain = lambda *a: fused_attention_bwd_plain(*a, causal)
            control = lambda *a: attention_bwd_plain(*a, causal, False)
        else:
            fwd = fused_temporal_attention
            kernel, plain = fused_temporal_attention_bwd, fused_temporal_attention_bwd_plain
            control = lambda *a: attention_bwd_plain(*a, True, True)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL[name]
            q, k, v = strided_qkv(lead, H, D, dtype, seed=10 + len(records))
            out, lse = fwd(q, k, v)
            dout = strided_dout(lead, H, D, dtype, seed=20 + len(records))
            errs[dtype] = check_bwd(kernel, plain, control, (q, k, v, out, lse, dout),
                                    tol, f"{name} {shape} causal={causal} {dtype}")
        if not main:
            continue
        sets = []
        for seed in (1, 2):  # two input sets, cycled, as for the forwards
            q, k, v = strided_qkv(lead, H, D, torch.bfloat16, seed=seed)
            sets.append((q, k, v, *fwd(q, k, v),
                         strided_dout(lead, H, D, torch.bfloat16, seed=seed + 2)))
        ms = cuda_ms([lambda a=a: kernel(*a) for a in sets])
        plain_ms = cuda_ms([lambda a=a: plain(*a) for a in sets])
        library_ms = cuda_ms([sdpa_backward(a[:3], a[5], causal) for a in sets])
        del sets
        n_rows = math.prod(lead) * H
        n_bytes = 8 * math.prod(shape) * 2 + n_rows * 4  # 5 in, 3 out bf16; lse
        keys = shape[1]
        pairs = keys * (keys + 1) // 2 if causal else keys * keys
        n_ops = 10 * (n_rows // keys) * pairs * D  # 5 products, 2 ops per MAC
        record(name, shape, errs, ms, plain_ms, library_ms, n_bytes, n_ops)
    misaligned_check()
    return records + resident_kernel_phase() + denoise_kernel_phase()


def misaligned_check():
    """Phase 3: K1'-K5' on rows that do not start 16-byte aligned. q, k, v
    as views one element into a buffer: at D 64 the forward raises
    ValueError (its cp.async copies need aligned rows); on copies of them it
    equals the plain version on the views. dout misaligned: the backward
    copies it first and equals the plain version. At D 61 (the ragged path,
    which copies each row's covering 16-byte-aligned chunks and shifts the
    row into place in shared memory) the forward and the backward take the
    views as they are and equal the plain version."""
    import torch

    from hma_tpu_torch.ops.fused_attention import (
        attention_bwd_plain, fused_attention, fused_attention_bwd,
        fused_attention_bwd_plain, fused_attention_plain)
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_bwd,
        fused_temporal_attention_bwd_plain, fused_temporal_attention_plain,
        fused_temporal_attention_resident, fused_temporal_attention_resident_bwd,
        temporal_resident_bwd_plain, temporal_resident_plain)

    def slots(fn):  # K5''s backward as (dq, dk, dv)
        return lambda *a: tuple(g.contiguous() for g in fn(*a).unbind(3))

    def resident_control_fwd(q, k, v):  # probs rounded as K1 does
        out = fused_attention_plain(to_sites(q), to_sites(k), to_sites(v), True)[0]
        return from_sites(out, q.shape[0], q.shape[2])

    def resident_control_bwd(q, k, v, out, lse, dout):  # p and ds rounded, as K2 does
        grads = attention_bwd_plain(*(to_sites(x) for x in (q, k, v, out)), lse,
                                    to_sites(dout), True, True)
        return tuple(from_sites(g, q.shape[0], q.shape[2]) for g in grads)

    cases = [  # name, lead, fwd, plain fwd, control fwd, bwd, plain bwd, control bwd
        ("K1'/K2'", (3, 77), lambda *a: fused_attention(*a, False),
         lambda *a: fused_attention_plain(*a, False),
         lambda *a: fused_attention_plain(*a, False, dtype=torch.float32)[0],
         lambda *a: fused_attention_bwd(*a, False),
         lambda *a: fused_attention_bwd_plain(*a, False),
         lambda *a: attention_bwd_plain(*a, False, False)),
        ("K3'/K4'", (35, 5), fused_temporal_attention, fused_temporal_attention_plain,
         lambda *a: fused_attention_plain(*a, True)[0], fused_temporal_attention_bwd,
         fused_temporal_attention_bwd_plain, lambda *a: attention_bwd_plain(*a, True, True)),
        ("K5'", (2, 5, 7), fused_temporal_attention_resident, temporal_resident_plain,
         resident_control_fwd, slots(fused_temporal_attention_resident_bwd),
         slots(temporal_resident_bwd_plain), resident_control_bwd)]
    H = 4
    for (name, lead, fwd, plain, control, bwd, bwd_plain, bwd_control), D in (
            (c, D) for c in cases for D in (64, 61)):
        n = math.prod(lead) * H * D
        spatial = name == "K1'/K2'"
        for dtype in (torch.float32, torch.bfloat16):
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL["K1'" if spatial else "K3'"]
            bwd_tol = (BWD_FP32_TOL if dtype == torch.float32
                       else BWD_BF16_TOL["K2'" if spatial else "K4'"])
            g = torch.Generator("cuda").manual_seed(40)
            flat = (torch.randn(3 * n + 1, generator=g, device="cuda") * 0.4).to(dtype)
            q, k, v = flat[1:].view(*lead, 3, H, D).unbind(-3)
            label = f"{name} misaligned {(*lead, H, D)} {dtype}"
            dout = torch.randn(n + 1, generator=g, device="cuda").to(dtype)[1:].view(*lead, H, D)
            if D == 61:  # the ragged path reads the views as they are
                check_kernel(fwd, plain, control, (q, k, v), tol, label + " fwd on the views")
                out, lse = fwd(q, k, v)
                check_bwd(bwd, bwd_plain, bwd_control, (q, k, v, out, lse, dout), bwd_tol,
                          label + " bwd on the views, dout misaligned")
                continue
            try:
                fwd(q, k, v)
                raised = "nothing"
            except ValueError as e:
                raised = f"ValueError ({e})"
            print(f"  {label}: the forward on the views raises {raised}", flush=True)
            require(raised != "nothing", f"{label}: the forward took misaligned rows")
            copy = lambda *xs: [x.clone(memory_format=torch.contiguous_format) for x in xs]
            check_kernel(lambda q, k, v: fwd(*copy(q, k, v)), plain, control, (q, k, v),
                         tol, label + " fwd on copies")
            out, lse = fwd(*copy(q, k, v))
            check_bwd(lambda *a: bwd(*copy(*a[:3]), *a[3:]), bwd_plain, bwd_control,
                      (q, k, v, out, lse, dout), bwd_tol, label + " bwd, dout misaligned")


def resident_qkv(shape, dtype, seed):
    """K5''s inputs as `FusedTemporalResident` hands them over: k and v
    views of one (B, T, S, 3, H, D) projection, q its slot scaled (a new
    tensor)."""
    import torch

    B, T, S, H, D = shape
    g = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(B, T, S, 3, H, D, generator=g, device="cuda").to(dtype)
    return qkv[..., 0, :, :] * D**-0.5, qkv[..., 1, :, :], qkv[..., 2, :, :]


def to_sites(x):
    """(B, T, S, H, D) -> (B*S, T, H, D), the layout K3'/K4' read."""
    B, T, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * S, T, H, D)


def from_sites(x, B, S):
    """(B*S, T, ...) -> (B, T, S, ...) contiguous."""
    return x.reshape(B, S, *x.shape[1:]).transpose(1, 2).contiguous()


def resident_kernel_phase():
    """Phase 3, K5': the resident layout's forward and backward against the
    plain version (fp32, bf16 with a negative control), and bit for bit
    against K3'/K4' on the same values regrouped; times at the d512 card's
    training shape, with SDPA's causal forward / backward as the library."""
    import torch

    from hma_tpu_torch.ops.fused_attention import attention_bwd_plain, fused_attention_plain
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_bwd,
        fused_temporal_attention_resident, fused_temporal_attention_resident_bwd,
        temporal_resident_bwd_plain, temporal_resident_plain)

    def rounded_probs(q, k, v):  # the forward's control: probs rounded as K1 does
        out = fused_attention_plain(to_sites(q), to_sites(k), to_sites(v), True)[0]
        return from_sites(out, q.shape[0], q.shape[2])

    def slots(dqkv):
        return tuple(g.contiguous() for g in dqkv.unbind(3))

    def bwd_kernel(*a):
        return slots(fused_temporal_attention_resident_bwd(*a))

    def bwd_plain(*a):
        return slots(temporal_resident_bwd_plain(*a))

    def bwd_control(q, k, v, out, lse, dout):  # p and ds rounded, as K2 does
        B, S = q.shape[0], q.shape[2]
        grads = attention_bwd_plain(*(to_sites(x) for x in (q, k, v, out)), lse,
                                    to_sites(dout), True, True)
        return tuple(from_sites(g, B, S) for g in grads)

    records = []
    for shape, main in (((8, 12, 128, 8, 64), True), ((8, 12, 128, 4, 64), True),
                        ((8, 12, 64, 8, 64), True),  # phase 26: a rank's 64 of 128 tokens
                        ((8, 12, 320, 8, 61), True),
                        ((8, 12, 128, 8, 16), True), ((8, 12, 128, 8, 32), True),
                        ((3, 5, 7, 3, 32), False), *((s, False) for s in RESIDENT_EDGES)):
        B, T, S, H, D = shape
        errs, bwd_errs = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            fwd_tol = FP32_TOL if dtype == torch.float32 else BF16_TOL["K3'"]
            bwd_tol = BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL["K4'"]
            q, k, v = resident_qkv(shape, dtype, seed=30)
            label = f"K5' {shape} {dtype}"
            errs[dtype] = check_kernel(fused_temporal_attention_resident,
                                       temporal_resident_plain, rounded_probs,
                                       (q, k, v), fwd_tol, label + " fwd")
            out, lse = fused_temporal_attention_resident(q, k, v)
            dout = strided_dout((B, T, S), H, D, dtype, seed=31)
            bwd_errs[dtype] = check_bwd(bwd_kernel, bwd_plain, bwd_control,
                                        (q, k, v, out, lse, dout), bwd_tol, label + " bwd")
            # the same values regrouped through K3' and K4': bit for bit
            out3, lse3 = fused_temporal_attention(to_sites(q), to_sites(k), to_sites(v))
            grads3 = fused_temporal_attention_bwd(to_sites(q), to_sites(k), to_sites(v),
                                                  out3, lse3, to_sites(dout))
            dqkv = fused_temporal_attention_resident_bwd(q, k, v, out, lse, dout)
            torch.cuda.synchronize()
            same = (torch.equal(to_sites(out), out3) and torch.equal(lse, lse3)
                    and all(torch.equal(to_sites(g), g3)
                            for g, g3 in zip(dqkv.unbind(3), grads3)))
            print(f"  {label}: out, lse, dq, dk, dv equal K3'/K4''s on the regrouped "
                  f"values bit for bit: {same}", flush=True)
            require(same, f"{label}: K5' differs from K3'/K4' on the same values")
        if not main:
            continue
        sets = []  # two input sets, cycled: one is 50 MB
        for seed in (1, 2):
            q, k, v = resident_qkv(shape, torch.bfloat16, seed=seed)
            sets.append((q, k, v, *fused_temporal_attention_resident(q, k, v),
                         strided_dout((B, T, S), H, D, torch.bfloat16, seed=seed + 2)))
        n_rows, pairs = B * S * H * T, T * (T + 1) // 2
        numel = math.prod(shape)
        timings = {
            "K5' fwd": ([lambda a=a: fused_temporal_attention_resident(*a[:3]) for a in sets],
                        [lambda a=a: temporal_resident_plain(*a[:3]) for a in sets],
                        [sdpa_forward([to_sites(x) for x in a[:3]], True) for a in sets],
                        4 * numel * 2 + n_rows * 4, 4 * (n_rows // T) * pairs * D, errs,
                        "hma_tpu/ops/temporal_attention.py:273"),
            "K5' bwd": ([lambda a=a: fused_temporal_attention_resident_bwd(*a) for a in sets],
                        [lambda a=a: temporal_resident_bwd_plain(*a) for a in sets],
                        [sdpa_backward([to_sites(x) for x in a[:3]], to_sites(a[5]), True)
                         for a in sets],
                        8 * numel * 2 + n_rows * 4, 10 * (n_rows // T) * pairs * D,
                        bwd_errs, "hma_tpu/ops/temporal_attention.py:278")}
        for name, (kern, plain, lib, n_bytes, n_ops, e, where) in timings.items():
            src = "temporal_resident_fwd" if name.endswith("fwd") else "temporal_resident_bwd"
            records.append(timed_record(name, shape, e, cuda_ms(kern), cuda_ms(plain),
                                        cuda_ms(lib), n_bytes, n_ops,
                                        f"hma_tpu_torch/csrc/{src}.cu", where))
        del sets, timings
    return records


def denoise_inputs(K, N, C, H, depth, seed):
    """Random fp32 inputs of the denoise loop on the card, from a seed: linears
    N(0, 1/in) (final_linear 0.3 of that, so that eps stays near the scale
    of x), LayerNorm scales near 1, mods N(0, 0.5^2), and the K-step cosine
    schedule table."""
    import torch

    from hma_tpu_torch.diffusion.gaussian import make_schedule
    from hma_tpu_torch.ops.diffusion_sampler import schedule_table

    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def linear(i, o, scale=1.0):
        return {"kernel": randn(i, o, scale=scale / math.sqrt(i)),
                "bias": randn(o, scale=0.1)}

    fc = {"input_proj": linear(C, H), "final_linear": linear(H, 2 * C, 0.3)}
    for j in range(depth):
        fc[f"res_{j}_fc1"] = linear(H, H)
        fc[f"res_{j}_fc2"] = linear(H, H)
        fc[f"res_{j}_ln"] = {"scale": 1 + randn(H, scale=0.1), "bias": randn(H, scale=0.1)}
    M = depth * 3 * H + 2 * H
    sched = torch.from_numpy(schedule_table(make_schedule("cosine", 1000, str(K)))).cuda()
    return dict(x_noise=randn(N, C), zs=randn(K, N, C),
                mods=randn(K, N, M, scale=0.5), sched_tbl=sched, fc_params=fc)


def cast_denoise_inputs(inp, dtype):
    """The same inputs with mods and the linears' weights in `dtype`."""
    fc = {n: ({k: v.to(dtype) for k, v in p.items()} if "kernel" in p else p)
          for n, p in inp["fc_params"].items()}
    return {**inp, "mods": inp["mods"].to(dtype), "fc_params": fc}


def denoise_kernel_phase():
    """Phase 3, K6': the fused denoise loop against its plain version."""
    import torch

    from hma_tpu_torch.ops import diffusion_sampler
    from hma_tpu_torch.ops.diffusion_sampler import (
        denoise_step_plain, fused_denoise_loop, fused_denoise_loop_plain)

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def mean_err(a, b):
        return ((a - b).abs().mean() / b.abs().max()).item()

    def bias_before_rounding(inp, **kw):  # control: (a @ w + b) rounded once
        def dot(a, p, dtype):
            return (a.to(dtype).float() @ p["kernel"].float() + p["bias"].float()).to(dtype)

        kept, diffusion_sampler._dot = diffusion_sampler._dot, dot
        try:
            return fused_denoise_loop_plain(**inp, **kw)
        finally:
            diffusion_sampler._dot = kept

    def forward_mods(inp, **kw):  # control: mods read with idx = i
        return fused_denoise_loop_plain(**{**inp, "mods": inp["mods"].flip(0)}, **kw)

    def ungated_last(inp, **kw):  # control: the last step adds its noise too
        K = inp["zs"].shape[0]
        x = inp["x_noise"].float()
        for i in range(K):
            x = denoise_step_plain(x, inp["zs"][i], inp["mods"][K - 1 - i],
                                   inp["sched_tbl"][K - 1 - i], inp["fc_params"],
                                   nonzero=1.0, **kw)
        return x

    main_shape = (100, 48, 16, 1024, 4)
    sim_shape = (100, 6, 16, 1024, 4)  # phase 18's STMAR simulator step, B 1
    # the reference algorithm's: in bf16 7 passes of 80 rows on the tensor
    # cores, the last of 32; in fp32 11 tiles of 48 rows, the last of 32
    ref_shape = (100, 512, 16, 1024, 4)
    # (K, N, C, H, depth), domain_ln, n_half, cfg, clip_denoised, the seed
    # of the case's inputs (its own, so that a new case changes no other)
    cases = [
        (main_shape, False, 0, 1.0, True, 60),
        (ref_shape, False, 0, 1.0, True, 61),
        (main_shape, False, 24, 2.0, False, 62),
        ((100, 45, 16, 1024, 4), True, 0, 1.0, False, 62),
        ((20, 6, 5, 128, 2), True, 3, 2.0, True, 63),
        ((20, 6, 5, 128, 0), False, 3, 2.0, True, 64),  # no residual block
        # the two ends of the shared-memory budget, each over more than one
        # bf16 pass with a ragged last one: 80 + 20 rows (an m16 tile of 4
        # rows) at H 1152, whose 144 column tiles give 12 blocks two; 80 + 80
        # + 10 rows at H 128
        ((20, 100, 16, 1152, 2), True, 0, 1.0, True, 65),
        ((20, 170, 5, 128, 2), False, 37, 2.0, True, 66),
        ((20, 170, 5, 128, 2), False, 37, 2.0, True, 67),
        (sim_shape, False, 0, 1.0, True, 67)]
    errs = {}
    for shape, domain_ln, n_half, cfg, clip, seed in cases:
        depth = shape[4]
        kw = dict(depth=depth, temperature=0.8, clip_denoised=clip,
                  domain_ln=domain_ln, n_half=n_half, cfg=cfg)
        inp32 = denoise_inputs(*shape, seed=seed)
        label = (f"K6' {shape} domain_ln={domain_ln} n_half={n_half} cfg={cfg} "
                 f"clip={clip} seed={seed}")
        got32 = fused_denoise_loop(**inp32, dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        want32 = fused_denoise_loop_plain(**inp32, dtype=torch.float32, **kw)
        require(bool(torch.isfinite(got32).all()) and got32.shape == want32.shape
                and got32.dtype == torch.float32, f"{label}: fp32 output")
        e32 = rel_err(got32, want32)
        # the fp64 witness: how far each fp32 side lies from exact arithmetic
        want64 = fused_denoise_loop_plain(**cast_denoise_inputs(inp32, torch.float64),
                                          dtype=torch.float64, **kw)
        k64, p64 = rel_err(got32, want64), rel_err(want32, want64)
        ctl = {name: rel_err(fn(inp32, dtype=torch.float32, **kw), want64)
               for name, fn in (("mods in forward order", forward_mods),
                                ("last step not gated", ungated_last))}
        inp16 = cast_denoise_inputs(inp32, torch.bfloat16)
        got16 = fused_denoise_loop(**inp16, dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        want16 = fused_denoise_loop_plain(**inp16, dtype=torch.bfloat16, **kw)
        require(bool(torch.isfinite(got16).all()), f"{label}: bf16 output")
        e16 = rel_err(got16, want16)
        noise16 = rel_err(want16, want32)  # what bf16 rounding alone moves
        mean16 = ((got16 - want16).abs().mean() / want16.abs().max()).item()
        print(f"  {label}: max|x| {want32.abs().max().item():.3f}; fp32 "
              f"against the fp64 plain version {k64:.3e} (tol {K6_FP32_TOL}), the fp32 "
              f"plain version {p64:.3e}; kernel vs fp32 plain {e32:.3e}; controls "
              f"against fp64 "
              + ", ".join(f"{n} {e:.3e}" for n, e in ctl.items())
              + f"; bf16 {e16:.3e} (tol {K6_BF16_TOL}), mean {mean16:.3e}; bf16 "
              f"plain vs fp32 plain {noise16:.3e}", flush=True)
        require(k64 <= K6_FP32_TOL, f"{label}: fp32 error {k64:.3e}")
        require(e16 <= K6_BF16_TOL, f"{label}: bf16 error {e16:.3e}")
        # one bf16 step at a mid-schedule row: where each rounding sits. At
        # full depth, and through the first block alone, where fewer flipped
        # roundings are carried on and a single misplaced one shows more
        mid, H = shape[0] // 2, shape[3]
        for d in sorted({depth, 1}, reverse=True) if shape[1] * shape[2] >= 512 else ():
            margin = K6_STEP_MARGIN["first block" if d == 1 else "all blocks"]
            mods = inp16["mods"][mid:mid + 1]
            one = {**inp16, "zs": inp16["zs"][:1], "sched_tbl": inp16["sched_tbl"][mid:mid + 1],
                   "mods": torch.cat([mods[..., :d * 3 * H], mods[..., depth * 3 * H:]], -1)}
            kw1 = {**kw, "depth": d}
            got1 = fused_denoise_loop(**one, dtype=torch.bfloat16, **kw1)
            torch.cuda.synchronize()
            want1 = fused_denoise_loop_plain(**one, dtype=torch.bfloat16, **kw1)
            step = mean_err(got1, want1)
            step_ctl = {
                "plain in fp32": fused_denoise_loop_plain(**one, dtype=torch.float32, **kw1),
                "bias before rounding": bias_before_rounding(
                    one, dtype=torch.bfloat16, **kw1)}
            print(f"    one bf16 step (row {mid}, depth {d}): mean|x-plain|/max|x| "
                  f"{step:.3e}, max {rel_err(got1, want1):.3e}, differ "
                  f"{(got1 != want1).float().mean().item():.2%}; controls "
                  + ", ".join(f"{n} {mean_err(c, want1):.3e} (differ "
                              f"{(c != want1).float().mean().item():.2%})"
                              for n, c in step_ctl.items())
                  + f"; must be {margin:g} x nearer than either", flush=True)
            for name, c in step_ctl.items():
                require(margin * step <= mean_err(c, want1),
                        f"{label}: one bf16 step at depth {d} is not told from '{name}'")
        # without clipping, x of a random net grows to 1e4-1e5 and the last
        # step's noise (~1e-2) is below fp32's resolution at that scale
        for name, e in ctl.items():
            if clip or name != "last step not gated":
                require(e > K6_FP32_TOL, f"{label}: the limit misses the control '{name}'")
        errs.setdefault(shape, {torch.float32: k64, torch.bfloat16: e16})

    records = []
    for shape, iters in ((main_shape, 5), (ref_shape, 2), (sim_shape, 5)):
        K, N, C, H, depth = shape
        kw = dict(depth=depth, temperature=0.8, clip_denoised=True, domain_ln=False,
                  n_half=0, cfg=1.0, dtype=torch.bfloat16)
        # one input set: its mods alone are 137 MB (1.47 GB at N 512), past the L2
        inp = cast_denoise_inputs(denoise_inputs(*shape, seed=1), torch.bfloat16)
        ms = cuda_ms(lambda: fused_denoise_loop(**inp, **kw), iters=iters, warmup=1)
        # the plain loop's ~8000 launches a call overflow the launch queue: a graph
        plain_ms = cuda_ms(lambda: fused_denoise_loop_plain(**inp, **kw), iters=2, warmup=1,
                           graph=True)
        n_weights = C * H + 2 * depth * H * H + 2 * C * H
        n_bias = H + 2 * depth * H + 2 * C
        M = depth * 3 * H + 2 * H
        # every input read once, x written once: x_noise, zs, sched fp32; mods,
        # weights and biases bf16; LayerNorm scales and biases fp32
        n_bytes = (4 * (N * C + K * N * C + K * 8 + 2 * depth * H)
                   + 2 * (K * N * M + n_weights + n_bias) + 4 * N * C)
        n_ops = 2 * K * N * n_weights
        records.append(timed_record("K6'", shape, errs[shape], ms, plain_ms, None, n_bytes,
                                    n_ops, "hma_tpu_torch/csrc/denoise_loop.cu",
                                    "hma_tpu/ops/diffusion_sampler.py:66"))
        del inp
    denoise_breakdown()
    return records


def denoise_breakdown():
    """Where a K6' call's time goes: the bf16 loop (K 100, C 16, H 1024) at
    depth 0 (a step is the first row phase, final_linear and 2 grid syncs)
    and depth 4 (3 more syncs, fc1, fc2 and a row phase a block), at N 1
    (the latency of the phases, little data), 48 and 512."""
    import torch

    from hma_tpu_torch.ops.diffusion_sampler import fused_denoise_loop

    K = 100
    for N in (1, 48, 512):
        ms = {}
        for depth in (0, 4):
            kw = dict(depth=depth, temperature=0.8, clip_denoised=True, domain_ln=False,
                      n_half=0, cfg=1.0, dtype=torch.bfloat16)
            inp = cast_denoise_inputs(denoise_inputs(K, N, 16, 1024, depth, seed=2),
                                      torch.bfloat16)
            ms[depth] = cuda_ms(lambda: fused_denoise_loop(**inp, **kw), iters=3, warmup=1)
        print(f"  K6' breakdown, bf16, K {K}, N {N}, C 16, H 1024: depth 0 "
              f"{float(ms[0]):.4f} ms ({1e3 * ms[0] / K:.2f} us a step), depth 4 "
              f"{float(ms[4]):.4f} ms ({1e3 * ms[4] / K:.2f} us a step): a residual "
              f"block {1e3 * (ms[4] - ms[0]) / (4 * K):.2f} us a step", flush=True)


def device_profile():
    """A torch.profiler context that records the card's activity only: the
    host's op trace costs tens of seconds a profile and nothing reads it."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_times(prof) -> dict:
    """{name: [device ms, count]} of the stopped profile's device events,
    read from its raw results (building the FunctionEvents that
    key_averages aggregates costs tens of seconds on a profile of ~1e5
    launches)."""
    import torch

    times = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = times.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return times


def profile_run(label, go, secs):
    """One more run of `go` under torch.profiler: device-busy share and the
    kernels that take the most device time (launches here are not counted)."""
    import torch

    with device_profile() as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_times(prof)
    if not rows:
        print(f"  {label} profile: the profiler saw no device time", flush=True)
        return
    busy_ms = sum(ms for ms, _ in rows.values())
    print(f"  {label} profile: device busy {busy_ms:.2f} ms, "
          f"{busy_ms / (secs * 1e3):.1%} of the {secs * 1e3:.2f} ms median wall "
          f"time without the profiler, {busy_ms / (wall * 1e3):.1%} of the "
          f"{wall * 1e3:.2f} ms under it; top device time:", flush=True)
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:9.3f} ms  {n:6d} x  {name[:90]}", flush=True)


def main_path_phase(records):
    """Phase 4: the full-width d256 rollouts through the kernels."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.ops.fused_attention import fused_attention
    from hma_tpu_torch.ops.temporal_attention import fused_temporal_attention
    from hma_tpu_torch.rollout.maskgit import generate_tokens, generate_tokens_full

    cfg = flagship_config(40)
    t0 = time.perf_counter()
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  d256 card, 40 domains: {n_params / 1e6:.1f}M params "
          f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)

    B, P, STEPS = 8, 2, 2
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.image_vocab_size,
                                           (B, cfg.T, cfg.S))).cuda()
    actions = torch.from_numpy(rng.normal(size=(B, cfg.T, cfg.max_d_action))
                               .astype(np.float32)).cuda()

    # cached exactness in fp32 at B = 1
    model32 = STMaskGIT(cfg, dtype=torch.float32, device="cuda").eval()
    model32.load_state_dict(model.state_dict())
    with torch.no_grad():
        full, _ = model32.compute_logits(tokens[:1], actions[:1], 0)
        k, v = model32.init_cache(1)
        worst = 0.0
        for t in range(cfg.T):
            got, _, _ = model32.frame_logits(tokens[:1, t], t, k, v, actions[:1], 0)
            want = full[:, :, t].reshape(1, 2, -1, cfg.S).permute(0, 3, 1, 2)
            worst = max(worst, (got - want).abs().max().item())
        scale = full.abs().max().item()
        print(f"  fp32 frame_logits vs compute_logits, {cfg.T} frames, B=1: max "
              f"abs err {worst:.3e} (|logits| <= {scale:.2f}, tol {EXACT_TOL})",
              flush=True)
        require(math.isfinite(worst) and worst <= EXACT_TOL, "cached path not exact")
        # planted faults at the last frame: the limit must catch each
        t = cfg.T - 1
        want = full[:, :, t].reshape(1, 2, -1, cfg.S).permute(0, 3, 1, 2)
        kz, vz = k.clone(), v.clone()
        kz[:, :, t - 1] = 0
        vz[:, :, t - 1] = 0  # frame t-1's slot left unwritten
        kr, vr = k.clone(), v.clone()
        masked = torch.full_like(tokens[:1, t - 1], model32.mask_token_id)
        model32.frame_logits(masked, t - 1, kr, vr, actions[:1], 0)  # a refinement
        # pass over frame t-1 that writes its (all-mask) keys and values
        for fault, (kf, vf) in (("slot t-1 zeroed", (kz, vz)),
                                ("a refinement pass wrote slot t-1", (kr, vr))):
            got, _, _ = model32.frame_logits(tokens[:1, t], t, kf, vf, actions[:1],
                                             0, update_cache=False)
            err = (got - want).abs().max().item()
            print(f"  planted fault, {fault}: max abs err {err:.3e} "
                  f"(tol {EXACT_TOL})", flush=True)
            require(err > EXACT_TOL, f"the exactness limit misses: {fault}")
    del model32, full, k, v, kz, vz, kr, vr

    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode="random")
    runs = {}
    for label, fn in (("cached", generate_tokens), ("full", generate_tokens_full)):
        def go():
            gen = torch.Generator("cuda").manual_seed(1)
            return fn(model, tokens, P, actions, 0, gen, **kw)

        go()  # warm-up, not counted
        torch.cuda.synchronize()
        fused_attention.launches = fused_temporal_attention.launches = 0
        t0 = time.perf_counter()
        out = go()
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
        counts = (fused_attention.launches, fused_temporal_attention.launches)
        same = True
        for _ in range(REPEATS - 1):  # the spread of the host-bound wall time
            t0 = time.perf_counter()
            same &= torch.equal(go(), out)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        frames = B * (cfg.T - P)
        runs[label] = (out, counts)
        print(f"  {label} rollout: {frames} frames in "
              f"{', '.join(f'{t:.4f}' for t in secs)} s; median "
              f"{frames / sorted(secs)[len(secs) // 2]:.2f} frames/s; "
              f"launches K1'={counts[0]} K3'={counts[1]}; repeats give the "
              f"same tokens: {same}", flush=True)
        require(torch.equal(out[:, :P], tokens[:, :P]), f"{label}: prompt changed")
        require(bool(((out >= 0) & (out < cfg.image_vocab_size)).all()),
                f"{label}: tokens out of range")
        profile_run(f"{label} rollout", go, sorted(secs)[len(secs) // 2])
    (cached, (c_k1, c_k3)), (full_out, (f_k1, f_k3)) = runs["cached"], runs["full"]
    forwards_cached = P + (cfg.T - P) * (STEPS + 1)
    require(c_k1 == forwards_cached * cfg.num_layers and c_k3 == 0,
            f"cached rollout launches K1'={c_k1} K3'={c_k3}")
    forwards_full = (cfg.T - P) * STEPS
    require(f_k1 == forwards_full * cfg.num_layers
            and f_k3 == forwards_full * cfg.num_layers,
            f"full rollout launches K1'={f_k1} K3'={f_k3}")
    agree = (cached[:, P:] == full_out[:, P:]).float().mean().item()
    agree_first = (cached[:, P] == full_out[:, P]).float().mean().item()
    print(f"  cached vs full-recompute tokens agree on {agree:.4f} of generated "
          f"tokens, {agree_first:.4f} of the first generated frame's (bf16 may "
          f"break near-ties; a changed token changes every later frame)", flush=True)
    set_launches(records, {("K1'", (B, 320, 8, 32)): c_k1,
                           ("K1'", (B * cfg.T, 320, 8, 32)): f_k1,
                           ("K3'", (B * 320, cfg.T, 8, 32)): f_k3})
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)


def set_launches(records, counts, add=False):
    """Write main-path launch counts into the records of {(name, shape): n},
    or add them to what a path before wrote (`add`, where two main paths run
    a kernel at one shape); each must have a record."""
    for (name, shape), n in counts.items():
        hit = [r for r in records if r["name"] == name and tuple(r["shape"]) == shape]
        if records:  # empty when phase 3 was not asked for
            require(len(hit) == 1, f"no kernel record for {name} {shape}")
            hit[0]["launches"] = n + ((hit[0]["launches"] or 0) if add else 0)


def mar_data(cfg, B):
    """Synthetic latents (B, T, h, w, C) and actions (B, T, max_d_action) on
    the card, drawn from seed 0 in the order `experiments/mar_probe.py:_data`
    draws them for the JAX bench (latents, a mask it does not use, actions)."""
    import torch

    rng = np.random.default_rng(0)
    h = cfg.h
    lat = rng.normal(size=(B, cfg.T, h, h, cfg.vae_embed_dim)).astype(np.float32)
    rng.uniform(size=(B, cfg.T, h, h))
    actions = rng.normal(size=(B, cfg.T, cfg.max_d_action)).astype(np.float32)
    return torch.from_numpy(lat).cuda(), torch.from_numpy(actions).cuda()


def live_heads(cfg, patch_dim, device="cuda"):
    """The d512 card's diffusion head in fp32 (depth 4 x width 1024, C 16, 100
    steps) as it stands, and its 40-domain twin (the domain-stacked net,
    whose LayerNorms take the two-pass variance), each with its adaLN and
    final_linear weights drawn from seed 3: random weights zero them, and
    then no row of the net reaches the sample."""
    import torch

    from hma_tpu_torch.models.diffloss import DiffLoss

    heads = {}
    for domains in (0, 40):
        g = torch.Generator(device).manual_seed(3)
        head = DiffLoss(patch_dim, cfg.d_model, cfg.diffloss_d, cfg.diffloss_w,
                        cfg.num_sampling_steps, num_domains=domains, dtype=torch.float32,
                        device=device)
        head.reset_parameters(g)
        with torch.no_grad():
            for name, mod in head.net.named_modules():
                leaf = name.rsplit(".", 1)[-1]
                if leaf.endswith("adaLN") or leaf == "final_linear":
                    w = mod.kernel if domains else mod.weight
                    fan_in = w.shape[-2] if domains else w.shape[-1]
                    scale = 0.3 if leaf == "final_linear" else LIVE_ADALN_SCALE
                    w.normal_(0.0, scale / math.sqrt(fan_in), generator=g)
        heads["card head" if not domains else "40-domain head"] = head
    return heads


def live_head_check():
    """Phase 9 (a'): K6' inside `DiffLoss.sample` (premod=True) against the
    whole net at every step (premod=False, no kernel) on the live heads of
    `live_heads`, fp32, N 48, without guidance and with cfg 2.0, on the same
    start noise and per-step normals; and a planted fault, the normals
    shifted by one step, that the limit must catch."""
    import torch

    cfg = mar_flagship_config(40)
    patch_dim = cfg.vae_embed_dim * cfg.patch_size ** 2
    N, K = 48, int(cfg.num_sampling_steps)
    g = torch.Generator("cuda").manual_seed(4)
    readings = []
    for label, head in live_heads(cfg, patch_dim).items():
        domain_id = 7 if head.num_domains else None
        for cfg_scale in (1.0, 2.0):
            rows = N // 2 if cfg_scale != 1.0 else N
            z = torch.randn(N, cfg.d_model, generator=g, device="cuda")
            noise = torch.randn(rows, patch_dim, generator=g, device="cuda")
            zs = torch.randn(K, N, patch_dim, generator=g, device="cuda")
            kw = dict(temperature=1.0, cfg=cfg_scale, clip_denoised=True, domain_id=domain_id,
                      noise=noise)
            reset_counts()
            got = head.sample(z, premod=True, zs=zs, **kw)
            torch.cuda.synchronize()
            launched = read_counts()["K6'"]
            want = head.sample(z, premod=False, zs=zs, **kw)
            planted = head.sample(z, premod=True, zs=zs.roll(1, 0), **kw)
            scale = want.abs().max().item()
            err = (got - want).abs().max().item() / scale
            err_planted = (planted - want).abs().max().item() / scale
            print(f"  {label}, cfg {cfg_scale}: K6' sample vs the whole net every step, "
                  f"fp32, N {N}: max|x-net|/max|x| {err:.3e} (tol {LIVE_HEAD_TOL}, "
                  f"max|x| {scale:.3f}); planted fault, normals shifted a step: "
                  f"{err_planted:.3e}", flush=True)
            readings.append((f"{label}, cfg {cfg_scale}", launched,
                             bool(torch.isfinite(got).all()), err, err_planted))
    for label, launched, finite, err, err_planted in readings:
        require(launched == 1 and finite, f"{label}: K6' not launched once or output not finite")
        require(err <= LIVE_HEAD_TOL, f"{label}: K6' sample error {err:.3e}")
        require(err_planted > LIVE_HEAD_TOL, f"{label}: the limit misses shifted normals")


def mar_path_phase(records):
    """Phase 9: the full-width d512 STMAR rollouts through K1', K3' and K6'."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR, patchify
    from hma_tpu_torch.rollout.mar import generate_latents, generate_latents_reference_algo

    torch.cuda.empty_cache()
    cfg = mar_flagship_config(40)
    t0 = time.perf_counter()
    model = STMAR(cfg, dtype=torch.bfloat16, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  d512 STMAR card, 40 domains: {n_params / 1e6:.1f}M params "
          f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)
    B, P = 8, 2
    lat, actions = mar_data(cfg, B)

    # (a) cached exactness in fp32 at B = 1. The zero-init tensors (adaLN,
    # final_linear, positional embeddings, mask tokens) stay zero here, as
    # in the JAX bench; the trunk and the readout are what the cache feeds.
    model32 = STMAR(cfg, dtype=torch.float32, device="cuda").eval()
    model32.load_state_dict(model.state_dict())
    with torch.no_grad():
        patches = patchify(lat[:1], cfg.patch_size).flatten(2, 3)
        full, _ = model32.compute_latents(patches, actions[:1], 0)
        k, v = model32.init_cache(1)
        worst = 0.0
        for t in range(cfg.T):
            got, _, _, _ = model32.frame_latents(patches[:, t], t, k, v, actions[:1], 0)
            worst = max(worst, (got - full[:, t]).abs().max().item())
        print(f"  fp32 frame_latents vs compute_latents, {cfg.T} frames, B=1: max abs "
              f"err {worst:.3e} (|z| <= {full.abs().max().item():.2f}, tol "
              f"{MAR_EXACT_TOL})", flush=True)
        require(math.isfinite(worst) and worst <= MAR_EXACT_TOL, "cached path not exact")
        t = cfg.T - 1
        kz, vz = k.clone(), v.clone()
        kz[:, :, t - 1] = 0
        vz[:, :, t - 1] = 0  # frame t-1's slot left unwritten
        got, _, _, _ = model32.frame_latents(patches[:, t], t, kz, vz, actions[:1], 0,
                                             update_cache=False)
        err = (got - full[:, t]).abs().max().item()
        print(f"  planted fault, slot t-1 zeroed: max abs err {err:.3e} "
              f"(tol {MAR_EXACT_TOL})", flush=True)
        require(err > MAR_EXACT_TOL, "the exactness limit misses a zeroed cache slot")
    del model32, full, k, v, kz, vz
    torch.cuda.empty_cache()
    live_head_check()

    # (b) the KV-cached rollout, bench.py's setting: 16 x 100, no guidance
    def go(window=cfg.T):
        gen = torch.Generator("cuda").manual_seed(1)
        return generate_latents(model, lat[:, :window], P, actions[:, :window], 0, gen,
                                maskgit_steps=cfg.maskgit_steps)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    go()  # warm-up, not counted
    torch.cuda.synchronize()
    print(f"  warm-up rollout {time.perf_counter() - t0:.2f} s", flush=True)
    secs = []
    for i in range(MAR_REPEATS):
        reset_counts()
        t0 = time.perf_counter()
        out = go()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
    frames = B * (cfg.T - P)
    med = sorted(secs)[len(secs) // 2]
    print(f"  cached rollout ({cfg.maskgit_steps} MaskGIT x {cfg.num_sampling_steps} "
          f"denoise steps): {frames} frames in "
          f"{', '.join(f'{t:.4f}' for t in secs)} s; median {frames / med:.2f} frames/s; "
          f"launches {counts}; |out| <= {out.abs().max().item():.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    require(out.shape == lat.shape and bool(torch.isfinite(out).all()),
            "rollout output not finite or misshapen")
    require(torch.equal(out[:, :P], lat[:, :P]), "prompt frames changed")
    require(bool((out[:, P:] != lat[:, P:]).any()), "nothing was generated")
    forwards = P + (cfg.T - P) * (cfg.maskgit_steps + 1)
    samplers = (cfg.T - P) * cfg.maskgit_steps
    require(counts["K1'"] == forwards * cfg.num_layers and counts["K6'"] == samplers
            and counts["K3'"] == 0, f"cached rollout launches {counts}")
    # the breakdown over a 4-frame window (2 generated frames): the whole
    # rollout is 5 x as many kernel events for the same per-frame picture
    go(P + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    go(P + 2)
    torch.cuda.synchronize()
    short = time.perf_counter() - t0
    profile_run("cached rollout, 2 generated frames", lambda: go(P + 2), short)

    # (c) the reference algorithm on the full window, 1 generated frame
    P_ref = cfg.T - 1
    reset_counts()
    t0 = time.perf_counter()
    ref = generate_latents_reference_algo(
        model, lat, P_ref, actions, 0, torch.Generator("cuda").manual_seed(1),
        maskgit_steps=cfg.maskgit_steps)
    torch.cuda.synchronize()
    ref_secs = time.perf_counter() - t0
    ref_counts = read_counts()
    print(f"  reference algorithm, {cfg.T - P_ref} generated frame(s) of B={B} "
          f"(cut from {cfg.T - P}): {ref_secs:.4f} s, {B * (cfg.T - P_ref) / ref_secs:.2f} "
          f"frames/s (first call, no warm-up); launches {ref_counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    require(bool(torch.isfinite(ref).all()) and torch.equal(ref[:, :P_ref], lat[:, :P_ref]),
            "reference algorithm output")
    full_forwards = (cfg.T - P_ref) * cfg.maskgit_steps
    require(ref_counts["K1'"] == full_forwards * cfg.num_layers
            and ref_counts["K3'"] == full_forwards * cfg.num_layers
            and ref_counts["K6'"] == full_forwards, f"reference launches {ref_counts}")
    tokens = model.seq_len + cfg.action_token_size
    heads, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    set_launches(records, {
        ("K1'", (B, tokens, heads, hd)): counts["K1'"],
        ("K1'", (B * cfg.T, tokens, heads, hd)): ref_counts["K1'"],
        ("K3'", (B * tokens, cfg.T, heads, hd)): ref_counts["K3'"],
        ("K6'", (100, B * 6, model.patch_dim, cfg.diffloss_w, cfg.diffloss_d)): counts["K6'"],
        ("K6'", (100, B * model.seq_len, model.patch_dim, cfg.diffloss_w,
                 cfg.diffloss_d)): ref_counts["K6'"]})


def feature_entry_phase():
    """Phase 10: the generate CLI's --use_feature branch on a 2-layer d512
    STMAR checkpoint and a synthetic latent dataset."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = mar_flagship_config(40)
    cfg.num_layers = 2
    model = STMAR(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_latent_dataset(tmp / "data", cfg, seed=5)
        save_checkpoint(str(tmp), "ckpt", model.state_dict(), cfg)
        check_generate_feature(tmp / "ckpt", tmp / "data", tmp / "out", cfg)


def write_latent_dataset(path, cfg, seed):
    """A synthetic 40-frame float16 latent dataset for domain_0 of `cfg`."""
    from hma_tpu_torch.data.datasets import write_token_dataset

    rng = np.random.default_rng(seed)
    n, side, C = 40, cfg.h, cfg.vae_embed_dim
    write_token_dataset(
        path, rng.normal(size=(n, C, side, side)).astype(np.float16),
        np.repeat(np.arange(n // 20), 20),
        rng.normal(size=(n, cfg.d_actions[0])).astype(np.float32),
        {"name": "domain_0", "latent_channels": C})


def check_generate_feature(ckpt_dir, data_dir, out_dir, cfg):
    """`hma_tpu_torch.generate.main(["--use_feature", ...])` on the card from
    a 2-layer STMAR checkpoint; checks what it wrote and its launches."""
    from hma_tpu_torch.generate import main as generate_main

    reset_counts()
    generate_main(["--checkpoint_dir", str(ckpt_dir), "--val_data_dir", str(data_dir),
                   "--output_dir", str(out_dir), "--batch_size", "2",
                   "--num_prompt_frames", "2", "--use_feature", "--device", "cuda"])
    counts = read_counts()
    meta = json.loads((Path(out_dir) / "metadata.json").read_text())
    video = np.fromfile(Path(out_dir) / "video.bin", dtype=np.float16)
    T, side, C = cfg.T, cfg.h, cfg.vae_embed_dim
    require(meta["num_images"] == 2 * (2 * T - 2) and meta["token_dtype"] == "float16"
            and meta["latent_channels"] == C and meta["h"] == side
            and meta["generation_layout"] == "prompt,pred,gt", f"metadata {meta}")
    require(video.size == meta["num_images"] * C * side * side, "video.bin size")
    require(bool(np.isfinite(video.astype(np.float32)).all()), "video.bin not finite")
    steps = (T - 2) * cfg.maskgit_steps
    require(counts["K6'"] == steps and counts["K1'"] == (2 + (T - 2) + steps) * 2,
            f"generate --use_feature launches {counts}")
    print(f"  generate --use_feature from {Path(ckpt_dir).name}: {meta['num_images']} "
          f"float16 latent frames of ({C}, {side}, {side}) written; launches {counts}",
          flush=True)


def write_dataset(path, cfg, seed):
    """A synthetic 40-frame token dataset for domain_0 of `cfg`."""
    from hma_tpu_torch.data.datasets import write_token_dataset

    rng = np.random.default_rng(seed)
    n, side = 40, math.isqrt(cfg.S)
    write_token_dataset(
        path, rng.integers(0, cfg.image_vocab_size, (n, side, side)).astype(np.uint32),
        np.repeat(np.arange(n // 20), 20),
        rng.normal(size=(n, cfg.d_actions[0])).astype(np.float32),
        {"name": "domain_0", "vocab_size": cfg.image_vocab_size})


def check_generate(ckpt_dir, data_dir, out_dir, T, S, vocab):
    """`hma_tpu_torch.generate.main` on the card; checks what it wrote and
    that it launched K1'."""
    from hma_tpu_torch.generate import main as generate_main
    from hma_tpu_torch.ops.fused_attention import fused_attention

    fused_attention.launches = 0
    generate_main(["--checkpoint_dir", str(ckpt_dir), "--val_data_dir", str(data_dir),
                   "--output_dir", str(out_dir), "--batch_size", "2",
                   "--num_prompt_frames", "2", "--device", "cuda"])
    meta = json.loads((Path(out_dir) / "metadata.json").read_text())
    video = np.fromfile(Path(out_dir) / "video.bin", dtype=np.uint32)
    require(meta["num_images"] == 2 * (2 * T - 2), f"metadata {meta}")
    require(video.size == meta["num_images"] * S, "video.bin size")
    require(int(video.max()) < vocab, "video.bin token range")
    require(fused_attention.launches > 0, "generate CLI did not launch K1'")
    print(f"  generate CLI from {Path(ckpt_dir).name}: {meta['num_images']} frames "
          f"written, K1' launches {fused_attention.launches}", flush=True)


def entry_point_phase():
    """Phase 5: the generate CLI on a 2-layer d256 checkpoint."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = flagship_config(40)
    cfg.num_layers = 2
    model = STMaskGIT(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(2))
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(Path(tmp) / "data", cfg, seed=2)
        save_checkpoint(tmp, "ckpt", model.state_dict(), cfg)
        check_generate(Path(tmp) / "ckpt", Path(tmp) / "data", Path(tmp) / "out",
                       cfg.T, cfg.S, cfg.image_vocab_size)


def kernel_counters():
    from hma_tpu_torch.ops.diffusion_sampler import fused_denoise_loop
    from hma_tpu_torch.ops.fused_attention import fused_attention, fused_attention_bwd
    from hma_tpu_torch.ops.temporal_attention import (
        fused_temporal_attention, fused_temporal_attention_bwd,
        fused_temporal_attention_resident, fused_temporal_attention_resident_bwd)

    return {"K1'": fused_attention, "K2'": fused_attention_bwd,
            "K3'": fused_temporal_attention, "K4'": fused_temporal_attention_bwd,
            "K5' fwd": fused_temporal_attention_resident,
            "K5' bwd": fused_temporal_attention_resident_bwd,
            "K6'": fused_denoise_loop}


TRAINING_KERNELS = ("K1'", "K2'", "K3'", "K4'")  # the training path runs no K6'


def train_launches(layers, layout):
    """Launches per training step with remat (each forward runs twice):
    the temporal pass through K3'/K4' ("transpose") or K5' ("resident")."""
    want = {name: 0 for name in kernel_counters()}
    want.update({"K1'": 2 * layers, "K2'": layers})
    if layout == "transpose":
        want.update({"K3'": 2 * layers, "K4'": layers})
    else:
        want.update({"K5' fwd": 2 * layers, "K5' bwd": layers})
    return want


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def train_batch(cfg, B, device):
    """bench.py's batch: random tokens and actions from seed 0, the first
    half of each frame 1.. masked, domain 0."""
    import torch

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.image_vocab_size, (B, cfg.T, cfg.S))
    actions = rng.normal(size=(B, cfg.T, cfg.max_d_action)).astype(np.float32)
    inp = tokens.copy()
    inp[:, 1:, : cfg.S // 2] = cfg.image_vocab_size
    return {"input_ids": torch.from_numpy(inp).to(device),
            "labels": torch.from_numpy(tokens).to(device),
            "action_ids": torch.from_numpy(actions).to(device), "domain_id": 0}


def training_phase(records):
    """Phase 6: the full-width d256 training step through the kernels."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT, smoothed_ce_floor
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    torch.cuda.empty_cache()
    cfg = flagship_config(40)
    B = 8
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                      generator=torch.Generator("cuda").manual_seed(0))
    mask = stacked_param_mask(model, cfg)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=mask,
                                      num_domains=cfg.num_domains)
    step = make_train_step(model.train(), tx)
    batch = train_batch(cfg, B, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step(batch)  # warm-up, not counted
    torch.cuda.synchronize()
    print(f"  warm-up step {time.perf_counter() - t0:.2f} s, loss "
          f"{m['loss'].item():.4f}", flush=True)
    reset_counts()
    secs, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for m in metrics:
        require(math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item()),
                f"training step not finite: {m}")
        require(m["skipped"].item() == 0.0, "a training step was skipped")
    med = sorted(secs)[len(secs) // 2]
    tokens = B * cfg.T * cfg.S
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    print(f"  {TRAIN_STEPS} steps at B={B}: {', '.join(f'{t:.4f}' for t in secs)} s; "
          f"median {med:.4f} s, {tokens / med:.1f} tokens/s ({tokens} per step); "
          f"loss {metrics[0]['loss'].item():.4f} -> {metrics[-1]['loss'].item():.4f}, "
          f"grad norm {metrics[-1]['grad_norm'].item():.4f}, skipped 0; launches "
          f"per step {per_step}; peak memory {peak / 2**30:.2f} GiB", flush=True)
    want = train_launches(cfg.num_layers, "transpose")
    require(per_step == want, f"launches per step {per_step}, want {want}")
    set_launches(records, {("K2'", (B * cfg.T, 320, 8, 32)): counts["K2'"],
                           ("K4'", (B * 320, cfg.T, 8, 32)): counts["K4'"]})
    for r in records:
        if tuple(r["shape"][1:]) in ((320, 8, 32), (12, 8, 32)):  # the d256 card's
            r["train_launches_per_step"] = per_step[r["name"]]
    profile_run("training step", lambda: step(batch), med)

    # overfit the fixed batch from the trained weights, lr 3e-4, wd 0
    del tx, step
    of_tx = make_domain_sliced_optimizer(model, 3e-4, weight_decay=0.0,
                                         stacked_mask=mask, num_domains=cfg.num_domains)
    of_step = make_train_step(model, of_tx)
    losses, accs = [], []
    for _ in range(OVERFIT_STEPS):
        m = of_step(batch)
        losses.append(m["loss"].item())
        accs.append(m["acc"].item())
    floor = smoothed_ce_floor(cfg.num_factored_vocabs, cfg.factored_vocab_size)
    print(f"  overfit {OVERFIT_STEPS} steps (lr 3e-4, wd 0): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (every 5th: {', '.join(f'{x:.3f}' for x in losses[::5])}), "
          f"acc {accs[-1]:.4f}, smoothing floor {floor:.4f}; must fall by "
          f">= {OVERFIT_MARGIN}", flush=True)
    require(all(math.isfinite(x) for x in losses), "overfit loss not finite")
    require(losses[-1] <= losses[0] - OVERFIT_MARGIN, "overfit loss did not fall")
    return med


def exactness_phase():
    """Phase 7: fp32 loss and gradients, kernels on the card vs plain on the CPU."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    cfg = flagship_config(40)
    cfg.num_layers = 2
    card = STMaskGIT(cfg, dtype=torch.float32, device="cuda", remat=True,
                     generator=torch.Generator("cuda").manual_seed(3))
    host = STMaskGIT(cfg, dtype=torch.float32, device="cpu", remat=True)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    losses, grads = [], []
    reset_counts()
    for model, device in ((card, "cuda"), (host, "cpu")):
        b = train_batch(cfg, 2, device)
        loss = model(b["input_ids"], b["labels"], b["action_ids"], 0)["loss"]
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
    counts = read_counts()
    require(all(counts[k] for k in TRAINING_KERNELS),
            f"the card's pass missed a kernel: {counts}")
    require(grads[0].keys() == grads[1].keys(), "gradient sets differ")
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, worst_name = 0.0, ""
    for n, want in grads[1].items():
        scale = want.abs().max().item()
        err = (grads[0][n] - want).abs().max().item()
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"  2-layer d256, B=2, fp32: loss card {losses[0]:.6f} cpu {losses[1]:.6f} "
          f"(rel err {loss_err:.3e}, tol 1e-5); {len(grads[1])} gradient tensors, "
          f"worst max|dg|/max|g| {worst:.3e} at {worst_name} (tol {GRAD_TOL}); "
          f"launches {counts}", flush=True)
    require(loss_err <= 1e-5, "card loss differs from the CPU's")
    require(worst <= GRAD_TOL, f"gradient {worst_name} differs: {worst:.3e}")


def train_entry_phase():
    """Phase 8: the train_multi CLI on the card, then generate from its
    checkpoint."""
    from hma_tpu_torch.train_multi import main as train_main

    cfg = flagship_config(1)
    cfg.num_layers = 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "domain_0_magvit_max1000000_train"
        write_dataset(data, cfg, seed=4)
        cfg.save_pretrained(str(tmp / "config.json"))
        (tmp / "split.yaml").write_text("domains: domain_0\n")
        reset_counts()
        train_main(["--genie_config", str(tmp / "config.json"),
                    "--output_dir", str(tmp / "run"), "--train_split",
                    str(tmp / "split.yaml"), "--data_root", str(tmp),
                    "--window_size", str(cfg.T), "--per_device_train_batch_size", "2",
                    "--per_device_eval_batch_size", "2", "--max_train_steps", "4",
                    "--overfit_first_batch", "--checkpointing_steps", "2",
                    "--eval_every_n_steps", "4", "--max_eval_steps", "1",
                    "--log_every", "1", "--num_warmup_steps", "1",
                    "--learning_rate", "3e-4"])
        counts = read_counts()
        lines = [json.loads(l) for l in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        losses = [l["train/loss"] for l in lines if "train/loss" in l]
        print(f"  train_multi CLI: {len(losses)} steps, losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; launches {counts}; "
              f"checkpoints {sorted(d.name for d in (tmp / 'run').iterdir() if d.is_dir())}",
              flush=True)
        require(len(losses) == 4 and all(math.isfinite(x) for x in losses),
                "train_multi losses")
        require(all(counts[k] for k in TRAINING_KERNELS),
                f"train_multi missed a kernel: {counts}")
        require((tmp / "run" / "final_checkpt" / "train_state.pt").is_file(),
                "no final checkpoint")
        check_generate(tmp / "run", data, tmp / "gen", cfg.T, cfg.S, cfg.image_vocab_size)


def mar_batch(cfg, B, device):
    """The d512 card's training batch: `mar_data`'s latents and actions,
    masked by the port's latent collator (its RNG from seed 0), domain 0."""
    import torch

    from hma_tpu_torch.data.collators import maskgit_collate_feature

    lat, actions = (x.cpu() for x in mar_data(cfg, B))
    h, C = cfg.h, cfg.vae_embed_dim
    items = [{"input_ids": lat[b].reshape(cfg.T * h * h, C).numpy(), "h": h, "w": h,
              "domain": "domain_0", "action_ids": actions[b].numpy()} for b in range(B)]
    mask = maskgit_collate_feature(items, cfg, np.random.default_rng(0))
    return {"input_ids": lat.to(device), "labels": lat.to(device),
            "masked_tokens_indicator": torch.from_numpy(
                mask["masked_tokens_indicator"]).to(device),
            "action_ids": actions.to(device), "domain_id": 0}


def mar_training_phase(records):
    """Phase 11: the full-width d512 STMAR training step through the kernels,
    in both temporal layouts, then an overfit run with fixed draws."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    torch.cuda.empty_cache()
    cfg = mar_flagship_config(40)
    require(cfg.mlp_drop == 0.05, f"the d512 card's mlp_drop is {cfg.mlp_drop}")
    B, T = 8, cfg.T
    t0 = time.perf_counter()
    model = STMAR(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                  generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    mask = stacked_param_mask(model, cfg)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=mask,
                                      num_domains=cfg.num_domains)
    step = make_train_step(model.train(), tx, continuous=True,
                           action_loss_weight=cfg.action_loss_weight)
    batch = mar_batch(cfg, B, "cuda")
    S_p, S_tot = model.seq_len, model.seq_len + cfg.action_token_size
    heads, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    patch_tokens, trunk_tokens = B * T * S_p, B * T * S_tot
    masked = batch["masked_tokens_indicator"].float().mean().item()
    print(f"  d512 STMAR card, 40 domains: {n_params / 1e6:.1f}M params, mlp_drop "
          f"{cfg.mlp_drop}, remat, sliced AdamW (fp32 moments); B={B}, {masked:.1%} of "
          f"latents masked (built in {time.perf_counter() - t0:.1f} s)", flush=True)
    runs = {}
    for i, layout in enumerate(("transpose", "resident")):
        for block in model.decoder.layers:
            block.temporal_layout = layout
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(batch, rng=100 * i)  # warm-up, not counted
        torch.cuda.synchronize()
        print(f"  [{layout}] warm-up step {time.perf_counter() - t0:.2f} s, loss "
              f"{m['loss'].item():.4f}", flush=True)
        reset_counts()
        secs, metrics = [], []
        for j in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(step(batch, rng=100 * i + j + 1))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        for m in metrics:
            require(math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item()),
                    f"[{layout}] training step not finite: {m}")
            require(m["skipped"].item() == 0.0, f"[{layout}] a training step was skipped")
        med = sorted(secs)[len(secs) // 2]
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        print(f"  [{layout}] {TRAIN_STEPS} steps: {', '.join(f'{t:.4f}' for t in secs)} s; "
              f"median {med:.4f} s, {patch_tokens / med:.1f} patch tokens/s "
              f"({patch_tokens} a step; {trunk_tokens / med:.1f} trunk tokens/s of "
              f"{trunk_tokens}); loss {metrics[0]['loss'].item():.4f} -> "
              f"{metrics[-1]['loss'].item():.4f}, grad norm "
              f"{metrics[-1]['grad_norm'].item():.4f}, skipped 0; launches per step "
              f"{per_step}; peak memory {peak / 2**30:.2f} GiB", flush=True)
        want = train_launches(cfg.num_layers, layout)
        require(per_step == want, f"[{layout}] launches per step {per_step}, want {want}")
        profile_run(f"d512 STMAR training step ({layout})",
                    lambda: step(batch, rng=100 * i + 99), med)
        runs[layout] = (med, counts, per_step)
    (t_med, t_counts, t_per), (r_med, r_counts, r_per) = runs["transpose"], runs["resident"]
    print(f"  resident minus transpose, median step: {(r_med - t_med) * 1e3:+.2f} ms "
          f"({(r_med - t_med) / t_med:+.2%}; one call, not a claim)", flush=True)
    set_launches(records, {("K1'", (B * T, S_tot, heads, hd)): t_counts["K1'"],
                           ("K3'", (B * S_tot, T, heads, hd)): t_counts["K3'"]}, add=True)
    set_launches(records, {("K2'", (B * T, S_tot, heads, hd)): t_counts["K2'"],
                           ("K4'", (B * S_tot, T, heads, hd)): t_counts["K4'"],
                           ("K5' fwd", (B, T, S_tot, heads, hd)): r_counts["K5' fwd"],
                           ("K5' bwd", (B, T, S_tot, heads, hd)): r_counts["K5' bwd"]})
    for r in records:
        shape = tuple(r["shape"])
        if shape in ((B * T, S_tot, heads, hd), (B * S_tot, T, heads, hd)):
            r["train_launches_per_step"] = t_per[r["name"]]
        elif r["name"].startswith("K5'") and shape == (B, T, S_tot, heads, hd):
            r["train_launches_per_step"] = r_per[r["name"]]

    # overfit the fixed batch with the diffusion draws and the dropout masks
    # fixed too, so that the loss moves only with the weights (transpose)
    for block in model.decoder.layers:
        block.temporal_layout = "transpose"
    del tx, step
    of_tx = make_domain_sliced_optimizer(model, 3e-4, weight_decay=0.0,
                                         stacked_mask=mask, num_domains=cfg.num_domains)
    of_step = make_train_step(model, of_tx, continuous=True,
                              action_loss_weight=cfg.action_loss_weight)
    g = torch.Generator("cuda").manual_seed(7)
    draws = {"t": torch.randint(0, 1000, (patch_tokens,), generator=g, device="cuda"),
             "noise": torch.randn(patch_tokens, model.patch_dim, generator=g, device="cuda")}
    losses = [of_step(batch, rng=0, draws=draws)["loss"].item()
              for _ in range(MAR_OVERFIT_STEPS)]
    print(f"  overfit {MAR_OVERFIT_STEPS} steps (lr 3e-4, wd 0, fixed t, noise and "
          f"dropout masks): loss {losses[0]:.4f} -> {losses[-1]:.4f} (every 5th: "
          f"{', '.join(f'{x:.4f}' for x in losses[::5])}); must fall by >= "
          f"{MAR_OVERFIT_MARGIN}", flush=True)
    require(all(math.isfinite(x) for x in losses), "overfit loss not finite")
    require(losses[-1] <= losses[0] - MAR_OVERFIT_MARGIN, "overfit loss did not fall")


def mar_exactness_phase():
    """Phase 12: a 2-layer d512 STMAR card in fp32, loss and every gradient
    with the kernels on the card against the plain versions on the CPU, in
    both layouts, the draws and the dropout masks handed in."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR

    cfg = mar_flagship_config(40)
    cfg.num_layers = 2
    B, T = 2, cfg.T
    g = torch.Generator().manual_seed(3)
    host = STMAR(cfg, dtype=torch.float32, device="cpu", remat=True, generator=g)
    with torch.no_grad():  # wake the zero-init heads and tokens
        for p in host.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    batch = mar_batch(cfg, B, "cpu")
    rows = B * T * host.seq_len
    draws = {"t": torch.randint(0, 1000, (rows,), generator=g),
             "noise": torch.randn(rows, host.patch_dim, generator=g)}
    S_tot, C = host.seq_len + cfg.action_token_size, cfg.d_model
    hidden = int(C * cfg.mlp_ratio)
    keep = 1.0 - cfg.mlp_drop
    for layout in ("transpose", "resident"):
        lead = (B * S_tot, T) if layout == "transpose" else (B, T, S_tot)
        masks = [(torch.rand(*lead, hidden, generator=g) < keep,
                  torch.rand(*lead, C, generator=g) < keep) for _ in range(cfg.num_layers)]
        card = STMAR(cfg, dtype=torch.float32, device="cuda", remat=True,
                     temporal_layout=layout)
        card.load_state_dict({k: v.cuda() for k, v in host.state_dict().items()})
        for block in host.decoder.layers:
            block.temporal_layout = layout
        losses, grads = [], []
        reset_counts()
        for model, device in ((card, "cuda"), (host, "cpu")):
            host.zero_grad()
            b = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in batch.items()}
            out = model(b["input_ids"], b["labels"], b["action_ids"], 0,
                        b["masked_tokens_indicator"],
                        dropout=[tuple(m.to(device) for m in pair) for pair in masks],
                        draws={k: v.to(device) for k, v in draws.items()})
            out["loss"].backward()
            losses.append(out["loss"].item())
            grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None})
        counts = read_counts()
        want = train_launches(cfg.num_layers, layout)
        require(all(counts[k] for k, n in want.items() if n),
                f"[{layout}] the card's pass missed a kernel: {counts}")
        require(grads[0].keys() == grads[1].keys(), "gradient sets differ")
        loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
        worst, worst_name = 0.0, ""
        for n, w in grads[1].items():
            scale = w.abs().max().item()
            err = (grads[0][n] - w).abs().max().item()
            ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            if ratio > worst:
                worst, worst_name = ratio, n
        print(f"  [{layout}] 2-layer d512 STMAR, B={B}, fp32, dropout {cfg.mlp_drop}: loss "
              f"card {losses[0]:.6f} cpu {losses[1]:.6f} (rel err {loss_err:.3e}, tol 1e-5); "
              f"{len(grads[1])} gradient tensors, worst max|dg|/max|g| {worst:.3e} at "
              f"{worst_name} (tol {GRAD_TOL}); launches {counts}", flush=True)
        require(loss_err <= 1e-5, f"[{layout}] card loss differs from the CPU's")
        require(worst <= GRAD_TOL, f"[{layout}] gradient {worst_name} differs: {worst:.3e}")
        del card


def mar_train_entry_phase():
    """Phase 13: `train_multi --model_type continuous` on the card for a few
    steps of a 2-layer d512 STMAR card on a synthetic latent dataset, then
    `generate --use_feature` from the checkpoint it wrote."""
    from hma_tpu_torch.train_multi import main as train_main

    cfg = mar_flagship_config(1)
    cfg.num_layers = 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "domain_0_vae_max1000000_train"
        write_latent_dataset(data, cfg, seed=6)
        cfg.save_pretrained(str(tmp / "config.json"))
        (tmp / "split.yaml").write_text("domains: domain_0\n")
        reset_counts()
        train_main(["--genie_config", str(tmp / "config.json"), "--model_type", "continuous",
                    "--output_dir", str(tmp / "run"), "--train_split",
                    str(tmp / "split.yaml"), "--data_root", str(tmp),
                    "--window_size", str(cfg.T), "--per_device_train_batch_size", "2",
                    "--per_device_eval_batch_size", "2", "--max_train_steps", "4",
                    "--overfit_first_batch", "--checkpointing_steps", "2",
                    "--eval_every_n_steps", "4", "--max_eval_steps", "1",
                    "--log_every", "1", "--num_warmup_steps", "1",
                    "--learning_rate", "3e-4"])
        counts = read_counts()
        lines = [json.loads(l) for l in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        losses = [l["train/loss"] for l in lines if "train/loss" in l]
        val = [l["val/loss"] for l in lines if "val/loss" in l]
        print(f"  train_multi --model_type continuous: {len(losses)} steps, losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}, val loss {val}; launches "
              f"{counts}; checkpoints "
              f"{sorted(d.name for d in (tmp / 'run').iterdir() if d.is_dir())}", flush=True)
        require(len(losses) == 4 and all(math.isfinite(x) for x in losses + val) and val,
                "train_multi losses")
        require(all(counts[k] for k in TRAINING_KERNELS),
                f"train_multi missed a kernel: {counts}")
        require((tmp / "run" / "final_checkpt" / "train_state.pt").is_file(),
                "no final checkpoint")
        check_generate_feature(tmp / "run", data, tmp / "gen", cfg)


# Phase 14: the four shipped cards that phases 4-13 do not run, and the
# temporal layouts each one's training step runs in
OTHER_CARDS = {"magvit_n32_h8_d128_action.json": ("transpose",),
               "magvit_n32_h8_d512_action.json": ("transpose", "resident"),
               "mar_n32_h8_d128_action.json": ("transpose", "resident"),
               "mar_n32_h8_d256_action.json": ("transpose", "resident")}


def card_config(name: str, num_domains: int = 40):
    """A shipped card from hma_tpu_torch/configs plus the synthetic action
    fields of `with_synthetic_domains`."""
    from hma_tpu_torch.config import load_config

    return with_synthetic_domains(load_config(str(ROOT / "hma_tpu_torch" / "configs" / name)),
                                  num_domains)


def other_cards_phase(records):
    """Phase 14: each of OTHER_CARDS at full width and depth, 40 synthetic
    domains, random weights from seed 0: (i) the fp32 cached forward held
    to the full forward at B 1 (EXACT_TOL for logits, MAR_EXACT_TOL for
    latents) and a zeroed cache slot that must exceed the limit; (ii) one
    bf16 training step at B 8 after a warm-up step (remat, the domain-sliced
    AdamW) in each of the card's temporal layouts, finite, nothing skipped,
    the launches of train_launches; (iii) one KV-cached rollout at B 8 in
    bf16, 2 prompt and 2 generated frames (MaskGIT: 2 steps at temperature
    0; MAR: the card's 16 x 100 steps, no guidance) after a warm-up one,
    with its K1', K3' and K6' launches and its time a frame."""
    import torch

    for name, layouts in OTHER_CARDS.items():
        t0 = time.perf_counter()
        other_card(name, layouts, records)
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def other_card(name, layouts, records):
    import torch

    from hma_tpu_torch.config import DiffusionGenieConfig
    from hma_tpu_torch.models.st_mar import STMAR, patchify
    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.rollout.mar import generate_latents
    from hma_tpu_torch.rollout.maskgit import generate_tokens
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    cfg = card_config(name)
    mar = isinstance(cfg, DiffusionGenieConfig)
    Model = STMAR if mar else STMaskGIT
    B, T, L, H = 8, cfg.T, cfg.num_layers, cfg.num_heads
    hd = cfg.d_model // H
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                  generator=torch.Generator("cuda").manual_seed(0))
    S_tot = (model.seq_len if mar else cfg.S) + cfg.action_token_size
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {name}: {n_params / 1e6:.1f}M params, d_model {cfg.d_model}, {H} heads of "
          f"{hd}, {L} layers, {S_tot} tokens a frame", flush=True)
    rng = np.random.default_rng(0)
    if mar:
        lat, actions = mar_data(cfg, B)
    else:
        tokens = torch.from_numpy(rng.integers(0, cfg.image_vocab_size, (B, T, cfg.S))).cuda()
        actions = torch.from_numpy(rng.normal(size=(B, T, cfg.max_d_action))
                                   .astype(np.float32)).cuda()

    # (i) the fp32 cached forward against the full forward at B 1
    model32 = Model(cfg, dtype=torch.float32, device="cuda").eval()
    model32.load_state_dict(model.state_dict())
    tol = MAR_EXACT_TOL if mar else EXACT_TOL
    with torch.no_grad():
        if mar:
            x = patchify(lat[:1], cfg.patch_size).flatten(2, 3)
            full, _ = model32.compute_latents(x, actions[:1], 0)
            want = [full[:, t] for t in range(T)]

            def frame(t, k, v, **kw):
                return model32.frame_latents(x[:, t], t, k, v, actions[:1], 0, **kw)[0]
        else:
            x = tokens[:1]
            full, _ = model32.compute_logits(x, actions[:1], 0)
            want = [full[:, :, t].reshape(1, 2, -1, cfg.S).permute(0, 3, 1, 2)
                    for t in range(T)]

            def frame(t, k, v, **kw):
                return model32.frame_logits(x[:, t], t, k, v, actions[:1], 0, **kw)[0]
        k, v = model32.init_cache(1)
        worst = max((frame(t, k, v) - want[t]).abs().max().item() for t in range(T))
        k[:, :, T - 2] = 0
        v[:, :, T - 2] = 0  # frame T-2's slot left unwritten
        planted = (frame(T - 1, k, v, update_cache=False) - want[T - 1]).abs().max().item()
    print(f"  (i) fp32 cached vs full forward, {T} frames, B=1: max abs err {worst:.3e} "
          f"(tol {tol}, max |out| {full.abs().max().item():.2f}); planted fault, slot "
          f"t-1 zeroed: {planted:.3e}", flush=True)
    require(math.isfinite(worst) and worst <= tol, f"{name}: cached path not exact")
    require(planted > tol, f"{name}: the exactness limit misses a zeroed cache slot")
    del model32, full, k, v, want

    # (ii) one bf16 training step after a warm-up, in each temporal layout
    mask = stacked_param_mask(model, cfg)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=mask,
                                      num_domains=cfg.num_domains)
    kw = dict(continuous=True, action_loss_weight=cfg.action_loss_weight) if mar else {}
    step = make_train_step(model.train(), tx, **kw)
    batch = mar_batch(cfg, B, "cuda") if mar else train_batch(cfg, B, "cuda")
    for i, layout in enumerate(layouts):
        for block in model.decoder.layers:
            block.temporal_layout = layout
        step(batch, rng=100 * i)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        m = step(batch, rng=100 * i + 1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        want = train_launches(L, layout)
        print(f"  (ii) [{layout}] bf16 training step, B={B}: {secs:.4f} s, loss "
              f"{m['loss'].item():.4f}, grad norm {m['grad_norm'].item():.4f}, skipped "
              f"{m['skipped'].item():.0f}; launches {counts}", flush=True)
        require(math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item()),
                f"{name} [{layout}]: training step not finite")
        require(m["skipped"].item() == 0.0, f"{name} [{layout}]: the step was skipped")
        require(counts == want, f"{name} [{layout}]: launches {counts}, want {want}")
        rows = {("K1'", (B * T, S_tot, H, hd)): counts["K1'"],
                ("K2'", (B * T, S_tot, H, hd)): counts["K2'"],
                ("K3'", (B * S_tot, T, H, hd)): counts["K3'"],
                ("K4'", (B * S_tot, T, H, hd)): counts["K4'"],
                ("K5' fwd", (B, T, S_tot, H, hd)): counts["K5' fwd"],
                ("K5' bwd", (B, T, S_tot, H, hd)): counts["K5' bwd"]}
        set_launches(records, {key: n for key, n in rows.items() if n}, add=True)
    del tx, step, batch
    model.eval()

    # (iii) one KV-cached rollout, 2 prompt and 2 generated frames
    P, W = 2, 4
    if mar:
        def go():
            return generate_latents(model, lat[:, :W], P, actions[:, :W], 0,
                                    torch.Generator("cuda").manual_seed(1),
                                    maskgit_steps=cfg.maskgit_steps)
        steps = cfg.maskgit_steps
    else:
        def go():
            return generate_tokens(model, tokens[:, :W], P, actions[:, :W], 0,
                                   torch.Generator("cuda").manual_seed(1), maskgit_steps=2,
                                   temperature=0.0, unmask_mode="random")
        steps = 2
    with torch.no_grad():
        go()  # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = go()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = read_counts()
    frames = B * (W - P)
    print(f"  (iii) cached rollout, B={B}, {P} prompt + {W - P} generated frames, "
          f"{steps} MaskGIT steps{' x ' + str(cfg.num_sampling_steps) + ' denoise' if mar else ''}: "
          f"{secs:.4f} s, {1e3 * secs / frames:.2f} ms a frame ({frames / secs:.2f} frames/s); "
          "launches " + ", ".join(f"{k}={counts[k]}" for k in ("K1'", "K3'", "K6'")),
          flush=True)
    prompt = lat if mar else tokens
    require(torch.equal(out[:, :P], prompt[:, :P]), f"{name}: prompt frames changed")
    if mar:
        require(out.shape == lat[:, :W].shape and bool(torch.isfinite(out).all())
                and bool((out[:, P:] != lat[:, P:W]).any()), f"{name}: rollout output")
    else:
        require(bool(((out >= 0) & (out < cfg.image_vocab_size)).all()),
                f"{name}: tokens out of range")
    forwards = P + (W - P) * (steps + 1)
    require(counts["K1'"] == forwards * L and counts["K3'"] == 0
            and counts["K6'"] == ((W - P) * steps if mar else 0),
            f"{name}: rollout launches {counts}")
    rows = {("K1'", (B, S_tot, H, hd)): counts["K1'"]}
    if mar:  # the denoise head does not depend on d_model: phase 9's shape
        rows[("K6'", (100, B * 6, model.patch_dim, cfg.diffloss_w,
                       cfg.diffloss_d))] = counts["K6'"]
    set_launches(records, rows, add=True)
    del model


def eval_batch(model, fn, *args, **kw):
    """fn(model, ...) under no_grad, synchronised: one evaluation call."""
    import torch

    with torch.no_grad():
        out = fn(model, *args, **kw)
    torch.cuda.synchronize()
    return out


def rollout_surface_phase(records):
    """Phase 15: the evaluation rollout surface on the d256 card at full width
    and depth (B 8, T 12, bf16, weights from seed 0): teacher_forced_logits,
    autoregressive_logits (2 prompt frames), generate_horizon over frames
    [2, 4) and window_logits over frames [2, 5), with their identities and
    planted faults, frames/s, busy shares and launch counts."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.rollout.maskgit import (
        autoregressive_logits, generate_horizon, generate_tokens_full,
        teacher_forced_logits)

    cfg = flagship_config(40)
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0)).eval()
    B, P, STEPS, T0, F = 8, 2, 2, 2, 3
    T, S, L = cfg.T, cfg.S, cfg.num_layers
    nv, fv = cfg.num_factored_vocabs, cfg.factored_vocab_size
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.image_vocab_size, (B, T, S))).cuda()
    actions = torch.from_numpy(rng.normal(size=(B, T, cfg.max_d_action))
                               .astype(np.float32)).cuda()
    kw = dict(maskgit_steps=STEPS, temperature=0.0, unmask_mode="random")
    gen = lambda seed=1: torch.Generator("cuda").manual_seed(seed)
    t_phase = time.perf_counter()

    # (a) fp32 at B 1: window_logits = compute_logits' frames [T0, T0+F)
    model32 = STMaskGIT(cfg, dtype=torch.float32, device="cuda").eval()
    model32.load_state_dict(model.state_dict())
    x, a = tokens[:1], actions[:1]
    with torch.no_grad():
        full, _ = model32.compute_logits(x, a, 0)
        want = full[:, :, T0:T0 + F].reshape(1, nv, fv, F, S).permute(0, 3, 4, 1, 2)
        k, v = model32.init_cache(1)
        for t in range(T0):
            model32.frame_logits(x[:, t], t, k, v, a, 0)
        got, _, _ = model32.window_logits(x[:, T0:T0 + F], T0, k, v, a, 0)
        err = (got - want).abs().max().item()
        k[:, :, T0 - 1] = 0
        v[:, :, T0 - 1] = 0  # frame T0-1's slot left unwritten
        bad, _, _ = model32.window_logits(x[:, T0:T0 + F], T0, k, v, a, 0)
        planted = (bad - want).abs().max().item()
    print(f"  (a) fp32 window_logits, frames [{T0}, {T0 + F}), vs compute_logits, B=1: "
          f"max abs err {err:.3e} (tol {EXACT_TOL}); planted fault, slot {T0 - 1} "
          f"zeroed: {planted:.3e}", flush=True)
    require(math.isfinite(err) and err <= EXACT_TOL, "window_logits not exact")
    require(planted > EXACT_TOL, "the window limit misses a zeroed cache slot")
    del model32, full, want, k, v, got, bad

    # (b) autoregressive_logits with the prompt over every frame is
    # teacher_forced_logits, bit for bit; with a 1-frame prompt slot t-1
    # holds the model's sample and the logits must move
    tf = eval_batch(model, teacher_forced_logits, tokens, actions, 0, gen(), **kw)
    ar_all = eval_batch(model, autoregressive_logits, tokens, T, actions, 0, gen(), **kw)
    ar_one = eval_batch(model, autoregressive_logits, tokens, 1, actions, 0, gen(), **kw)
    moved = (ar_one[1] - tf[1]).abs().max().item()
    same = torch.equal(ar_all[0], tf[0]) and torch.equal(ar_all[1], tf[1])
    print(f"  (b) autoregressive_logits, prompt = all {T} frames, vs teacher_forced_logits: "
          f"bit for bit {same}; planted fault, 1-frame prompt: max abs logit diff "
          f"{moved:.3e} (limit 0)", flush=True)
    require(same, "autoregressive_logits over a full prompt is not teacher_forced_logits")
    require(moved > 0, "the bit-for-bit check misses a sampled history")

    # (c) generate_horizon over one frame is generate_tokens_full's frame
    g = gen(3)
    draws = torch.rand((1, STEPS, B, S), generator=g, device="cuda")
    other = torch.rand((STEPS, B, S), generator=g, device="cuda")
    hz = eval_batch(model, generate_horizon, tokens, T - 1, T, actions, 0,
                    unmask_draws=draws[0], **kw)
    ref = eval_batch(model, generate_tokens_full, tokens, T - 1, actions, 0,
                     unmask_draws=draws, **kw)[:, T - 1:]
    hz_other = eval_batch(model, generate_horizon, tokens, T - 1, T, actions, 0,
                          unmask_draws=other, **kw)
    fault = (hz_other != ref).float().mean().item()
    print(f"  (c) generate_horizon [{T - 1}, {T}) vs generate_tokens_full's frame {T - 1}: "
          f"token for token {torch.equal(hz, ref)}; planted fault, other draws: "
          f"{fault:.4%} of tokens differ (limit 0)", flush=True)
    require(torch.equal(hz, ref), "generate_horizon over one frame is not the full rollout's")
    require(fault > 0, "the token check misses other unmasking draws")

    # (d) timed runs, counted; (b) warmed the two cached paths up. The
    # profiles of those two run over a 4-frame window (3 decoded frames): the
    # whole window is ~4 x as many events for the same per-frame picture,
    # and torch.profiler takes tens of seconds to sum 10^5 events
    print(f"  (a)-(c): {time.perf_counter() - t_phase:.1f} s", flush=True)
    k_w, v_w = model.init_cache(B)
    with torch.no_grad():
        for t in range(T0):
            model.frame_logits(tokens[:, t], t, k_w, v_w, actions, 0)

    def tf_run(w=T):
        return eval_batch(model, teacher_forced_logits, tokens[:, :w], actions[:, :w], 0,
                          gen(), **kw)

    def ar_run(w=T):
        return eval_batch(model, autoregressive_logits, tokens[:, :w], P, actions[:, :w],
                          0, gen(), **kw)

    runs = {
        "teacher_forced_logits": (tf_run, B * (T - 1), {"K1'": L * (T - 1) * (STEPS + 1)},
                                  lambda: tf_run(4)),
        "autoregressive_logits": (ar_run, B * (T - 1), {"K1'": L * (T - 1) * (STEPS + 2)},
                                  lambda: ar_run(4)),
        "generate_horizon": (
            lambda: eval_batch(model, generate_horizon, tokens, 2, 4, actions, 0, gen(),
                               **kw),
            B * 2, {"K1'": L * STEPS, "K3'": L * STEPS}, None),
        "window_logits": (
            lambda: eval_batch(model, lambda m, *a: m.window_logits(*a),
                               tokens[:, T0:T0 + F], T0, k_w, v_w, actions, 0),
            B * F, {"K1'": L}, None),
    }
    counted = {}
    for label, (go, frames, want, short) in runs.items():
        if short is None:
            go()  # warm-up, not counted
        reset_counts()
        t0 = time.perf_counter()
        go()
        secs = time.perf_counter() - t0
        counts = read_counts()
        full_want = {name: want.get(name, 0) for name in counts}
        print(f"  (d) {label}: {frames} frames in {secs:.4f} s, {frames / secs:.2f} "
              f"frames/s; launches " + ", ".join(f"{n}={c}" for n, c in counts.items() if c),
              flush=True)
        require(counts == full_want, f"{label} launches {counts}, want {full_want}")
        counted[label] = counts
        if short is None:
            profile_run(label, go, secs)
        else:
            t0 = time.perf_counter()
            short()
            profile_run(f"{label}, a 4-frame window", short, time.perf_counter() - t0)
    set_launches(records, {
        ("K1'", (B, 320, 8, 32)): counted["teacher_forced_logits"]["K1'"]
        + counted["autoregressive_logits"]["K1'"],
        ("K1'", (B * T, 320, 8, 32)): counted["generate_horizon"]["K1'"],
        ("K3'", (B * 320, T, 8, 32)): counted["generate_horizon"]["K3'"]}, add=True)
    set_launches(records, {("K1'", (B * F, 320, 8, 32)): counted["window_logits"]["K1'"]})
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def rel_diff(a: dict, b: dict, keys) -> float:
    """Largest relative difference of two metric dicts over `keys` (lists
    element by element)."""
    worst = 0.0
    for k in keys:
        x, y = np.atleast_1d(np.asarray(a[k], float)), np.atleast_1d(np.asarray(b[k], float))
        require(x.shape == y.shape, f"{k}: shapes {x.shape} and {y.shape}")
        worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
    return worst


EVAL_TOL = 1e-6  # phase 16: a CLI's metrics against the library's, relative


def eval_entry_phase():
    """Phase 16: `python -m hma_tpu_torch.evaluate` (teacher-forced and
    --autoregressive_time) on a 2-layer d256 checkpoint and a synthetic token
    dataset, and `evaluate --use_feature` and `evaluate_feature` in both modes
    on a 2-layer d512 STMAR checkpoint and a synthetic latent dataset, on the
    card; each JSON against the library functions on the same weights, batch
    and generator seed (EVAL_TOL)."""
    import os

    import torch

    from hma_tpu_torch.data.datasets import RawFeatureDataset, RawTokenDataset
    from hma_tpu_torch.evaluate import main as evaluate_main
    from hma_tpu_torch.evaluate_feature import load_mar_model
    from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
    from hma_tpu_torch.generate import load_model
    from hma_tpu_torch.metrics.token import teacher_forced_metrics
    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.rollout.mar import generate_latents, teacher_forced_latents
    from hma_tpu_torch.rollout.maskgit import autoregressive_logits, teacher_forced_logits
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    B, P = 2, 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_discrete_checkpoint(tmp)
        base = ["--checkpoint_dir", str(tmp / "ckpt"), "--val_data_dir", str(tmp / "data"),
                "--batch_size", str(B), "--max_examples", str(B), "--seed", "4",
                "--device", "cuda"]
        model, cfg = load_model(str(tmp / "ckpt"), "cuda", torch.bfloat16)
        ds = RawTokenDataset(tmp / "data", window_size=cfg.T, use_actions=True)
        items = [ds[i] for i in range(B)]
        tokens = torch.from_numpy(np.stack([it["input_ids"] for it in items])
                                  .reshape(B, cfg.T, -1).astype(np.int64)).cuda()
        acts = np.stack([it["action_ids"] for it in items]).astype(np.float32)
        acts = torch.from_numpy(np.pad(acts, ((0, 0), (0, 0),
                                              (0, cfg.max_d_action - acts.shape[-1])))).cuda()
        keys = ("loss", "perplexity", "acc")
        for mode in ("teacher_forced", "autoregressive"):
            extra = ["--autoregressive_time", "--num_prompt_frames", str(P)] \
                if mode == "autoregressive" else []
            reset_counts()
            got = evaluate_main([*base, "--output_dir", str(tmp / mode), *extra])
            counts = read_counts()
            g = torch.Generator("cuda").manual_seed(4)
            with torch.no_grad():
                if mode == "autoregressive":
                    _, logits = autoregressive_logits(model, tokens, P, acts, 0, g)
                else:
                    _, logits = teacher_forced_logits(model, tokens, acts, 0, g)
            want = {k: float(v) for k, v in teacher_forced_metrics(
                logits, tokens[:, 1:], cfg.factored_vocab_size).items()}
            diff = rel_diff(got, want, keys)
            k1 = counts["K1'"]
            print(f"  evaluate [{mode}]: {json.dumps(got)}; library {want}; max rel diff "
                  f"{diff:.3e} (tol {EVAL_TOL}); launches K1'={k1}", flush=True)
            require(diff <= EVAL_TOL and got["num_examples"] == B, f"evaluate [{mode}]")
            per_frame = 3 if mode == "teacher_forced" else 4  # 2 MaskGIT steps + fills
            require(k1 == cfg.num_layers * (cfg.T - 1) * per_frame,
                    f"evaluate [{mode}] launches {counts}")
            if mode == "teacher_forced":
                proc = subprocess.run(
                    [sys.executable, "-m", "hma_tpu_torch.evaluate", *base,
                     "--output_dir", str(tmp / "module")], cwd=ROOT, capture_output=True,
                    text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
                require(proc.returncode == 0, f"python -m hma_tpu_torch.evaluate: {proc.stderr}")
                mod = json.loads(proc.stdout.strip().splitlines()[-1])
                diff = rel_diff(mod, got, keys)
                print(f"  python -m hma_tpu_torch.evaluate: {json.dumps(mod)}; max rel diff "
                      f"to the in-process run {diff:.3e}", flush=True)
                require(diff <= EVAL_TOL, "python -m hma_tpu_torch.evaluate")
        del model, logits

        cfg = mar_flagship_config(40)
        cfg.num_layers = 2
        model = STMAR(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
        write_latent_dataset(tmp / "lat", cfg, seed=5)
        save_checkpoint(str(tmp), "mar", model.state_dict(), cfg)
        del model
        STEPS = 4
        base = ["--checkpoint_dir", str(tmp / "mar"), "--val_data_dir", str(tmp / "lat"),
                "--batch_size", str(B), "--max_examples", str(B), "--seed", "6",
                "--maskgit_steps", str(STEPS), "--num_prompt_frames", str(P),
                "--device", "cuda"]
        model, cfg = load_mar_model(str(tmp / "mar"), "cuda", torch.bfloat16)
        ds = RawFeatureDataset(tmp / "lat", window_size=cfg.T, use_actions=True)
        items = [ds[i] for i in range(B)]
        lat = torch.from_numpy(np.stack([it["input_ids"] for it in items]).reshape(
            B, cfg.T, cfg.h, cfg.h, cfg.vae_embed_dim).astype(np.float32)).cuda()
        acts = np.stack([it["action_ids"] for it in items]).astype(np.float32)
        acts = torch.from_numpy(np.pad(acts, ((0, 0), (0, 0),
                                              (0, cfg.max_d_action - acts.shape[-1])))).cuda()
        keys = ("latent_mse", "latent_mse_per_frame")
        for mode in ("teacher_forced", "autoregressive"):
            reset_counts()
            got = evaluate_feature_main([*base, "--output_dir", str(tmp / f"f_{mode}"),
                                         "--eval_mode", mode])
            counts = read_counts()
            via = evaluate_main([*base, "--output_dir", str(tmp / f"v_{mode}"),
                                 "--use_feature", "--temperature", "1.0",
                                 *(["--autoregressive_time"] if mode == "autoregressive"
                                   else [])])
            g = torch.Generator("cuda").manual_seed(6)
            with torch.no_grad():
                if mode == "teacher_forced":
                    out = torch.cat([lat[:, :1], teacher_forced_latents(
                        model, lat, acts, 0, g, maskgit_steps=STEPS)], 1)
                else:
                    out = generate_latents(model, lat, P, acts, 0, g, maskgit_steps=STEPS)
            t1 = 1 if mode == "teacher_forced" else P
            err = (out[:, t1:].float() - lat[:, t1:]) ** 2
            want = {"latent_mse": err.mean().item(),
                    "latent_mse_per_frame": err.mean(dim=(0, 2, 3, 4)).double().tolist()}
            diff = max(rel_diff(got, want, keys), rel_diff(via, got, keys))
            frames = cfg.T - t1
            print(f"  evaluate_feature [{mode}]: latent_mse {got['latent_mse']:.6f} "
                  f"(library {want['latent_mse']:.6f}, evaluate --use_feature "
                  f"{via['latent_mse']:.6f}), gen_time {got['gen_time']:.4f} s a frame; "
                  f"max rel diff {diff:.3e} (tol {EVAL_TOL}); launches {counts}", flush=True)
            require(diff <= EVAL_TOL and got["num_examples"] == B,
                    f"evaluate_feature [{mode}]")
            require(math.isfinite(got["latent_mse"]) and len(got["latent_mse_per_frame"])
                    == frames, f"evaluate_feature [{mode}] output")
            # a frame: STEPS refinement forwards and a cache fill, and in
            # teacher forcing a ground-truth fill; autoregressive: P prefills
            forwards = (frames * (STEPS + 2) if mode == "teacher_forced"
                        else P + frames * (STEPS + 1))
            require(counts["K6'"] == frames * STEPS
                    and counts["K1'"] == cfg.num_layers * forwards,
                    f"evaluate_feature [{mode}] launches {counts}")


# Phase 17: the MagVit2 codec. fp32 card against CPU (cuDNN's TF32 is off):
# latents to CODEC_Z_TOL of max|z|, tokens equal but where a channel's |z| is
# under that margin, decoded uint8 pixels within 1 level on >= 99 %.
CODEC_Z_TOL = 1e-4
CODEC_PIXEL_SHARE = 0.99
# bf16 against fp32 on the card, on the same inputs: the share of tokens that
# differ (a token differs when any of its 18 channel signs does) and the PSNR
# of the images decoded from the same tokens, in [-1, 1]. Each must lie in
# its window, and three faults planted in the bf16 model must each fall out
# of one. An H100 80GB HBM3 (700 W) reads, as tokens and PSNR: the sound
# codec 7.52 % and 48.94 dB; GroupNorm in bf16 (no fp32 upcast) 8.98 % and
# 47.88 dB; GroupNorm's statistics rounded to bf16 8.74 % and 47.30 dB; the
# conv weights left in fp32 (nearer to fp32, not the reference's rounding)
# 6.69 % and 50.23 dB. Each bound lies about halfway between the sound
# reading and the nearest fault's. The inputs and cuDNN's choices are fixed:
# the sound codec has read the same to the last digit in three calls.
CODEC_BF16_TOKEN_SHARE = (0.071, 0.081)
CODEC_BF16_PSNR = (48.4, 49.6)


def codec_model(dtype, device="cuda"):
    """The released MagVit2 architecture (`VQConfig()`, 65.5M parameters)
    from seed 0: conv weights N(0, 1 / fan_in), zero biases, GroupNorm 1 and
    0 (`VQModel.reset_parameters`), drawn in fp32 on the card; in `dtype`
    on `device`."""
    import torch

    from hma_tpu_torch.tokenizer.magvit2 import VQModel

    model = VQModel(dtype=torch.float32, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    if dtype == torch.float32 and device == "cuda":
        return model.eval()
    out = VQModel(model.config, dtype=dtype, device=device)
    out.load_state_dict(model.state_dict())
    return out.eval()


def write_tokenizer_ckpt(path, state):
    """A reference-layout `.ckpt` of the codec: zeros under `state_dict`, the
    weights as LitEma shadows (`model_ema.<name without dots>`), which the
    loader must prefer, and a quantizer key it must ignore."""
    import torch

    state = {k: v.detach().float().cpu() for k, v in state.items()}
    torch.save({"state_dict": {**{k: torch.zeros_like(v) for k, v in state.items()},
                               **{f"model_ema.{k.replace('.', '')}": v
                                  for k, v in state.items()},
                               "model_ema.num_updates": torch.tensor(1),
                               "quantize.codebook": torch.zeros(1)}}, path)


def synthetic_frames(n, seed, side=256):
    """(n, side, side, 3) uint8 frames: smooth random colour fields (a few
    low-frequency sinusoids a channel) with pixel noise, from `seed`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side), indexing="ij")
    out = np.empty((n, side, side, 3), np.float32)
    for i in range(n):
        for c in range(3):
            f = rng.uniform(0.5, 3, (3, 2))
            ph = rng.uniform(0, 2 * np.pi, 3)
            out[i, ..., c] = sum(np.sin(2 * np.pi * (f[j, 0] * yy + f[j, 1] * xx) + ph[j])
                                 for j in range(3))
    out = 127.5 + 40 * out + rng.normal(0, 8, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def conv_flops(model, call):
    """2 x the multiply-adds of every conv (2-D and 3-D) and linear layer
    `call` runs on `model`, and of the SVD-VAE's two attention products (by
    hooks)."""
    import torch

    from hma_tpu_torch.tokenizer.svd_vae import AttnBlock

    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
        elif isinstance(mod, AttnBlock):  # q k^T and p v: 2 x (B, HW, HW, C)
            B, C, H, W = inp[0].shape
            total[0] += 4 * B * (H * W) ** 2 * C
        else:
            total[0] += (2 * out.numel() * (mod.in_channels // mod.groups)
                         * math.prod(mod.kernel_size))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear, AttnBlock))]
    try:
        with torch.no_grad():
            call()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def write_discrete_checkpoint(root, seed=2, layers=2):
    """A `layers`-layer d256 checkpoint (40 synthetic domains, weights from
    `seed`) at root/ckpt and a token dataset at root/data; returns the card."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = flagship_config(40)
    cfg.num_layers = layers
    model = STMaskGIT(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
    write_dataset(root / "data", cfg, seed=seed)
    save_checkpoint(str(root), "ckpt", model.state_dict(), cfg)
    return cfg


def codec_phase():
    """Phase 17: the MagVit2 codec at full width (VQConfig(), 256² <-> 16²):
    fp32 card against CPU, bf16 against fp32, device-bound times against
    their bounds, then `evaluate --tokenizer_ckpt` and `--raw_image_data`
    on a 2-layer d256 checkpoint against the library functions."""
    import torch
    from torch.nn import functional as F

    from hma_tpu_torch.rollout.decode import make_token_decoder
    from hma_tpu_torch.tokenizer.magvit2 import GroupNorm, normalize_image, unnormalize_image

    model32 = codec_model(torch.float32)
    enc_n = sum(p.numel() for p in model32.encoder.parameters())
    dec_n = sum(p.numel() for p in model32.decoder.parameters())
    print(f"  VQConfig(): {(enc_n + dec_n) / 1e6:.2f}M params (encoder {enc_n / 1e6:.2f}M, "
          f"decoder {dec_n / 1e6:.2f}M)", flush=True)
    imgs = torch.from_numpy(synthetic_frames(8, seed=0)).cuda()
    x8 = normalize_image(imgs).permute(0, 3, 1, 2)  # NCHW view, channels-last in memory

    # (a) fp32, card against CPU, B 2
    cpu32 = codec_model(torch.float32, "cpu")
    with torch.no_grad():
        t0 = time.perf_counter()
        z_cpu = cpu32.encode_without_quantize(x8[:2].cpu()).permute(0, 2, 3, 1)
        z_gpu = model32.encode_without_quantize(x8[:2]).permute(0, 2, 3, 1).cpu()
        scale = z_cpu.abs().max().item()
        z_err = (z_gpu - z_cpu).abs().max().item() / scale
        tok_cpu = cpu32.encode(x8[:2].cpu()).indices
        tok_gpu = model32.encode(x8[:2]).indices.cpu()
        flipped = (z_gpu > 0) != (z_cpu > 0)  # channels whose sign differs
        worst_flip = z_cpu.abs()[flipped].max().item() / scale if flipped.any() else 0.0
        px_cpu = unnormalize_image(cpu32.decode_code(tok_cpu))
        px_gpu = unnormalize_image(model32.decode_code(tok_cpu.cuda())).cpu()
        cpu_s = time.perf_counter() - t0
    diff = (px_gpu.int() - px_cpu.int()).abs()
    same = (diff == 0).float().mean().item()
    print(f"  fp32 card vs CPU, B 2: latents max|dz|/max|z| {z_err:.3e} (max|z| {scale:.3f}, "
          f"tol {CODEC_Z_TOL}); tokens differ at {(tok_gpu != tok_cpu).sum().item()} of "
          f"{tok_cpu.numel()} ({flipped.sum().item()} flipped channels, largest |z| among "
          f"them {worst_flip:.3e} of max|z|); decoded pixels max diff {diff.max().item()}, "
          f"{same:.4%} equal (CPU side {cpu_s:.1f} s)", flush=True)
    require(z_err <= CODEC_Z_TOL and worst_flip <= CODEC_Z_TOL, "codec latents card vs CPU")
    require(diff.max().item() <= 1 and same >= CODEC_PIXEL_SHARE, "codec pixels card vs CPU")
    del cpu32

    # (b) bf16 against fp32 on the card, B 8, then the same with a fault
    # planted in the bf16 model, which the limits must catch
    model16 = codec_model(torch.bfloat16)
    with torch.no_grad():
        z32 = model32.encode_without_quantize(x8).float()
        tok32 = model32.encode(x8).indices
        px32 = model32.decode_code(tok32).float()

    def drift(model):
        with torch.no_grad():
            z = model.encode_without_quantize(x8).float()
            tok = model.encode(x8).indices
            px = model.decode_code(tok32).float()
        mse = ((px - px32) ** 2).mean().item()
        return (tok, (z - z32).abs().max().item() / z32.abs().max().item(),
                ((z > 0) != (z32 > 0)).float().mean().item(),
                (tok != tok32).float().mean().item(),
                10 * math.log10(4.0 / max(mse, 1e-20)))  # images in [-1, 1]

    def gn_bf16(m, x):  # GroupNorm in the compute dtype, no fp32 upcast
        return F.group_norm(x, m.num_groups, m.weight.to(x.dtype), m.bias.to(x.dtype), m.eps)

    def gn_stats_bf16(m, x):  # mean and variance rounded to bf16 at each op
        g = x.reshape(x.shape[0], m.num_groups, -1)
        mu = g.mean(-1, keepdim=True)
        y = (g - mu) * torch.rsqrt((g - mu).square().mean(-1, keepdim=True) + m.eps)
        return (y.reshape(x.shape) * m.weight.to(x.dtype)[:, None, None]
                + m.bias.to(x.dtype)[:, None, None])

    convs32 = dict(zip((m for m in model16.modules() if isinstance(m, torch.nn.Conv2d)),
                       (m for m in model32.modules() if isinstance(m, torch.nn.Conv2d))))
    norms = [m for m in model16.modules() if isinstance(m, GroupNorm)]
    faults = {"GroupNorm in bf16": (norms, gn_bf16),
              "GroupNorm statistics in bf16": (norms, gn_stats_bf16),
              "conv weights left in fp32": (
                  list(convs32), lambda m, x: convs32[m](x.float()).to(x.dtype))}

    def inside(share, db):
        return (CODEC_BF16_TOKEN_SHARE[0] <= share <= CODEC_BF16_TOKEN_SHARE[1]
                and CODEC_BF16_PSNR[0] <= db <= CODEC_BF16_PSNR[1])

    tok16, z_rel, bit_share, tok_share, dec_psnr = drift(model16)
    print(f"  bf16 vs fp32 on the card, B 8: latents max|dz|/max|z| {z_rel:.3e}; channel "
          f"signs differ {bit_share:.4%}, tokens {tok_share:.4%} (window "
          f"{CODEC_BF16_TOKEN_SHARE}); decoded images (same tokens) PSNR "
          f"{dec_psnr:.2f} dB (window {CODEC_BF16_PSNR} dB)", flush=True)
    require(inside(tok_share, dec_psnr), "codec bf16 drift")
    for name, (mods, forward) in faults.items():
        for m in mods:
            m.forward = functools.partial(forward, m)
        try:
            _, z_rel, bit_share, share, fpsnr = drift(model16)
        finally:
            for m in mods:
                del m.forward
        print(f"    control '{name}': latents {z_rel:.3e}, channel signs {bit_share:.4%}, "
              f"tokens {share:.4%}, PSNR {fpsnr:.2f} dB", flush=True)
        require(not inside(share, fpsnr), f"the codec's bf16 limits miss the control '{name}'")
    del model32, z32, px32, convs32

    # (c) device-bound times in bf16, bench.py's tokenizer quantities
    tok8 = tok16
    enc_flops = conv_flops(model16, lambda: model16.encode(x8[:1]))
    dec_flops = conv_flops(model16, lambda: model16.decode_code(tok8[:1]))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():  # 340-450 launches a call would fill the launch queue: graphs
        enc_ms = cuda_ms(lambda: model16.encode(x8).indices, iters=10, warmup=2, graph=True)
        dec_ms = cuda_ms(lambda: unnormalize_image(model16.decode_code(tok8)), iters=10,
                         warmup=2, graph=True)
        dec1_ms = cuda_ms(lambda: unnormalize_image(model16.decode_code(tok8[:1])), iters=20,
                          warmup=2, graph=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    enc_w = 2 * sum(p.numel() for p in model16.encoder.parameters())
    dec_w = 2 * sum(p.numel() for p in model16.decoder.parameters())
    for label, ms, B, w, flops, n_in, n_out in (
            ("encode", enc_ms, 8, enc_w, enc_flops, 4 * 3 * 256**2, 4 * 16**2),
            ("decode", dec_ms, 8, dec_w, dec_flops, 4 * 16**2, 3 * 256**2),
            ("decode", dec1_ms, 1, dec_w, dec_flops, 4 * 16**2, 3 * 256**2)):
        b_ms, b_by = bound(w + B * (n_in + n_out), B * flops)
        print(f"  {label} B {B}, bf16: {ms}; {B / float(ms) * 1e3:.1f} images/s; bound "
              f"{b_ms:.4f} ms ({b_by}: {B * flops / 1e9:.1f} GFLOP of convs, "
              f"{flops / 1e9:.1f} an image); {float(ms) / b_ms:.1f} x bound", flush=True)
    print(f"  bench quantities: encode_fps_256_b8 {8e3 / float(enc_ms):.1f}, "
          f"decode_fps_256_b8 {8e3 / float(dec_ms):.1f}, dec_time_ms_b1 {float(dec1_ms):.4f}; "
          f"peak memory {peak:.2f} GiB", flush=True)

    # (d) the entry point: evaluate --tokenizer_ckpt, then --raw_image_data
    from hma_tpu_torch.data.datasets import RawImageDataset, RawTokenDataset, write_token_dataset
    from hma_tpu_torch.data.encode_openx import make_magvit_encoder
    from hma_tpu_torch.evaluate import main as evaluate_main
    from hma_tpu_torch.generate import load_model
    from hma_tpu_torch.metrics.image import batch_psnr, batch_ssim
    from hma_tpu_torch.rollout.maskgit import teacher_forced_logits

    decode = make_token_decoder(model16)
    encode = make_magvit_encoder(model16)
    B, SEED = 2, 4
    keys = ("psnr", "ssim", "psnr_copy_prev", "psnr_vs_copy")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_tokenizer_ckpt(tmp / "magvit2.ckpt", codec_model(torch.float32).state_dict())
        cfg = write_discrete_checkpoint(tmp)
        frames = synthetic_frames(40, seed=5)
        write_token_dataset(tmp / "raw", frames, np.repeat(np.arange(2), 20),
                            np.random.default_rng(5).normal(size=(40, cfg.d_actions[0]))
                            .astype(np.float32), {"name": "domain_0"})
        model, cfg = load_model(str(tmp / "ckpt"), "cuda", torch.bfloat16)
        for raw in (False, True):
            label = "--raw_image_data" if raw else "--tokenizer_ckpt"
            reset_counts()
            got = evaluate_main([
                "--checkpoint_dir", str(tmp / "ckpt"), "--val_data_dir",
                str(tmp / ("raw" if raw else "data")), "--output_dir", str(tmp / f"o{raw}"),
                "--batch_size", str(B), "--max_examples", str(B), "--seed", str(SEED),
                "--tokenizer_ckpt", str(tmp / "magvit2.ckpt"), "--num_action_trials", "2",
                "--device", "cuda", *(["--raw_image_data"] if raw else [])])
            counts = read_counts()
            if raw:
                ds = RawImageDataset(tmp / "raw", window_size=cfg.T, use_actions=True)
                items = [ds[i] for i in range(B)]
                raw_px = np.stack([it["images"] for it in items]).astype(np.uint8)
                tokens = encode(raw_px.reshape(-1, 256, 256, 3)).reshape(B, cfg.T, -1)
            else:
                ds = RawTokenDataset(tmp / "data", window_size=cfg.T, use_actions=True)
                items = [ds[i] for i in range(B)]
                tokens = np.stack([it["input_ids"] for it in items]).reshape(B, cfg.T, -1)
            tokens = torch.from_numpy(tokens.astype(np.int64)).cuda()
            acts = np.stack([it["action_ids"] for it in items]).astype(np.float32)
            acts = torch.from_numpy(np.pad(acts, ((0, 0), (0, 0),
                                                  (0, cfg.max_d_action - acts.shape[-1])))).cuda()
            g = torch.Generator("cuda").manual_seed(SEED)
            samples, _ = teacher_forced_logits(model, tokens, acts, 0, g)
            frames_of = lambda t: decode(t.reshape(-1, cfg.h, cfg.w))
            pred = frames_of(samples)
            if raw:
                gt, copy = (raw_px[:, 1:].reshape(-1, 256, 256, 3),
                            raw_px[:, :-1].reshape(-1, 256, 256, 3))
            else:
                gt, copy = frames_of(tokens[:, 1:]), frames_of(tokens[:, :-1])
            psnr = float(np.mean(batch_psnr(pred, gt, device="cuda")))
            copy_psnr = float(np.mean(batch_psnr(copy, gt, device="cuda")))
            want = {"psnr": psnr, "ssim": float(np.mean(batch_ssim(pred, gt, device="cuda"))),
                    "psnr_copy_prev": copy_psnr, "psnr_vs_copy": psnr - copy_psnr}
            d, k1 = rel_diff(got, want, keys), counts["K1'"]
            print(f"  evaluate {label}: {json.dumps(got)}; library "
                  f"{json.dumps(want)}; max rel diff {d:.3e} (tol {EVAL_TOL}); launches "
                  f"K1'={k1}", flush=True)
            require(d <= EVAL_TOL and got["num_examples"] == B, f"evaluate {label}")
            require(all(math.isfinite(got[k]) for k in ("delta_psnr", "dec_time")),
                    f"evaluate {label}: delta_psnr / dec_time")
            # 3 cached forwards a frame, and 2 x 3 more for the two trials
            require(k1 == cfg.num_layers * (cfg.T - 1) * 3 * 3,
                    f"evaluate {label} launches {counts}")



def simulator_phase(records):
    """Phase 18: GenieSimulator on the d256 card at full width and depth with
    phase 17's codec as its decoder (bf16), the 2-layer fp32 card on the card
    against the CPU, the d512 STMAR card's simulator (latents), and
    `sim.app.build_simulator` + `InteractiveDigitalWorld`."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.rollout.decode import make_token_decoder
    from hma_tpu_torch.sim.simulator import GenieSimulator

    H, STEPS = 3, 20
    decode = make_token_decoder(codec_model(torch.bfloat16))
    cfg = flagship_config(40)
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.image_vocab_size, (H, cfg.h, cfg.w)).astype(np.int32)
    prompt_actions = rng.normal(size=(H, cfg.max_d_action)).astype(np.float32)
    moves = rng.normal(size=(STEPS + 1, cfg.d_actions[0])).astype(np.float32)
    sim = GenieSimulator(model, prompt_horizon=H, maskgit_steps=2, temperature=0.0,
                         decode_tokens=decode)
    sim.set_initial_state(prompt, prompt_actions)
    sim.step(moves[0])  # warm-up
    sim._step_times.clear()
    torch.cuda.synchronize()
    reset_counts()
    walls = []
    for move in moves[1:]:
        t0 = time.perf_counter()
        px = sim.step(move)
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    stats = sim.measure_step_time()
    with_decode = float(np.median(walls)) * 1e3
    k1 = counts["K1'"]
    print(f"  d256 simulator, B 1, {STEPS} steps (2 MaskGIT steps, temperature 0, bf16): "
          f"model p50 {stats['p50_ms']:.2f} ms, IQR mean {stats['iqr_mean_ms']:.2f} ms; with "
          f"the 256² decode p50_onchip_ms_with_decode {with_decode:.2f} ms; launches {counts} "
          f"({k1 / STEPS:g} K1' a step)", flush=True)
    require(px.shape == (256, 256, 3) and px.dtype == np.uint8, "simulator frame")
    forwards = H + 2 + 1  # prefill, 2 refinements, the cache write
    require(counts["K1'"] == STEPS * forwards * cfg.num_layers and counts["K3'"] == 0,
            f"simulator launches {counts}")
    set_launches(records, {("K1'", (1, 320, 8, 32)): counts["K1'"]})
    profile_run("simulator step with decode", lambda: sim.step(moves[0]), with_decode / 1e3)
    del sim, model

    # fp32, 2 layers: the card against the CPU, token for token
    small = flagship_config(40)
    small.num_layers = 2
    m_gpu = STMaskGIT(small, dtype=torch.float32, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(3)).eval()
    m_cpu = STMaskGIT(small, dtype=torch.float32, device="cpu").eval()
    m_cpu.load_state_dict(m_gpu.state_dict())
    sims = [GenieSimulator(m, prompt_horizon=H, maskgit_steps=1) for m in (m_gpu, m_cpu)]
    for s in sims:
        s.set_initial_state(prompt, prompt_actions)
    agree = []
    for move in moves[:3]:
        a, b = (s.step(move) for s in sims)
        agree.append(float((a == b).mean()))
    print(f"  fp32 2-layer simulator, card vs CPU, 3 steps at 1 MaskGIT step: tokens agree "
          f"{agree}", flush=True)
    require(agree == [1.0] * 3 and np.array_equal(sims[0]._token_cache, sims[1]._token_cache),
            "simulator card vs CPU")
    del sims, m_gpu, m_cpu

    # the d512 STMAR simulator, latents out (phase 19 runs it with pixels)
    torch.cuda.empty_cache()
    mcfg = mar_flagship_config(40)
    mar = STMAR(mcfg, dtype=torch.bfloat16, device="cuda",
                generator=torch.Generator("cuda").manual_seed(0)).eval()
    lat, acts = mar_data(mcfg, 1)
    msim = GenieSimulator(mar, prompt_horizon=H, maskgit_steps=mcfg.maskgit_steps,
                          temperature=1.0)
    msim.set_initial_state(lat[0, :H].cpu().numpy(), acts[0, :H].cpu().numpy())
    msim.step(moves[0])  # warm-up
    msim._step_times.clear()
    reset_counts()
    for move in moves[1:4]:
        out = msim.step(move)
    counts = read_counts()
    mstats = msim.measure_step_time()
    print(f"  d512 STMAR simulator, B 1, 3 steps ({mcfg.maskgit_steps} MaskGIT x "
          f"{mcfg.num_sampling_steps} denoise steps, bf16): p50 {mstats['p50_ms']:.2f} ms, "
          f"IQR mean {mstats['iqr_mean_ms']:.2f} ms a step; |latent| <= "
          f"{np.abs(out).max():.3f}; launches {counts}", flush=True)
    require(out.shape == (mcfg.h, mcfg.h, mcfg.vae_embed_dim) and np.isfinite(out).all(),
            "STMAR simulator latents")
    forwards = H + mcfg.maskgit_steps + 1
    require(counts["K1'"] == 3 * forwards * mcfg.num_layers
            and counts["K6'"] == 3 * mcfg.maskgit_steps, f"STMAR simulator launches {counts}")
    set_launches(records, {
        ("K1'", (1, mar.seq_len + mcfg.action_token_size, mcfg.num_heads,
                 mcfg.d_model // mcfg.num_heads)): counts["K1'"],
        ("K6'", (100, 6, mar.patch_dim, mcfg.diffloss_w, mcfg.diffloss_d)): counts["K6'"]})
    del msim, mar

    # the entry point: build_simulator, then the driver
    from hma_tpu_torch.sim.app import build_simulator
    from hma_tpu_torch.sim.main import InteractiveDigitalWorld

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_tokenizer_ckpt(tmp / "magvit2.ckpt", codec_model(torch.float32).state_dict())
        small = write_discrete_checkpoint(tmp)
        app_sim = build_simulator(str(tmp / "ckpt"), str(tmp / "magvit2.ckpt"),
                                  domain="domain_0")
        app_sim.set_initial_state(prompt, prompt_actions)
        reset_counts()
        stats = InteractiveDigitalWorld(app_sim, save_dir=str(tmp / "world")).run(3)
        counts = read_counts()
        saved = np.load(tmp / "world" / "frames.npy")
        print(f"  build_simulator + InteractiveDigitalWorld.run(3): frames {saved.shape} "
              f"{saved.dtype}, {stats}; launches {counts}", flush=True)
        require(saved.shape == (4, 256, 256, 3) and saved.dtype == np.uint8
                and counts["K1'"] == 3 * (H + 3) * small.num_layers, "the simulator app")


# Phase 19: the SVD temporal VAE and the metric backbones. (a) fp32 on the
# card against fp32 on the CPU (cuDNN's TF32 off): one clip of raw latents
# (B 1, T 3, 8² -> 64² frames) through load_svd_decoder on each device, and
# its frames encoded again, as max |dx| / max |x|. An H100 (700 W) reads
# 3.245e-06 and 2.493e-06; the limit is about ten times that.
VAE_CARD_TOL = 3e-5
# (b) bf16 against fp32 on the card, the d512 card's grid (T 12, 16² ->
# 128²): the PSNR of the bf16 frames against the fp32 ones, 10 log10(4 /
# mse) (frames nominally in [-1, 1]). It must lie in the window, and three
# faults planted in the bf16 VAE must each leave it. An H100 80GB HBM3 (700
# W) reads: sound 45.97 dB; GroupNorm in bf16 44.81; the residual stream
# left in bf16 after each AlphaBlender (torch's rule for a 0-dim fp32 alpha
# would keep it bf16; JAX's promotion makes it fp32) 43.96; the conv weights
# left in fp32 48.07. Each bound lies halfway between the sound reading and
# the nearest fault's. The attention scores rounded to bf16 read 45.90: one
# attention block over 256 positions moves the frames by 0.07 dB, which no
# window can tell from the sound decoder.
VAE_BF16_PSNR = (45.39, 47.02)
# (d) the metric backbones' features, card against CPU, fp32 (TF32 off), as
# max |df| / max |f|, with BatchNorm statistics from the compared inputs
# (small variances amplify the two devices' summation orders): an H100
# (700 W) reads 8.425e-05 (InceptionV3), 4.680e-05 and 1.715e-05 (I3D
# videogpt, styleganv); the limit is about 3.5 times the largest
BACKBONE_TOL = 3e-4


def svd_vae_state(seed=0):
    """The released SVD-VAE architecture (`SVDTemporalVAE()`) from `seed` on
    the card in fp32, every tensor plus 0.05 N(0, 1) noise, so that the
    GroupNorm scales, the zero biases and mix_factor take part: its state
    dict, fp32 on the CPU."""
    import torch

    from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE

    g = torch.Generator("cuda").manual_seed(seed)
    vae = SVDTemporalVAE(dtype=torch.float32, device="cuda", generator=g)
    return {k: (v + 0.05 * torch.randn(v.shape, generator=g, device="cuda")).cpu()
            for k, v in vae.state_dict().items()}


def group_norm_bf16(m, x):
    """A planted fault: the port's GroupNorm in bf16, without its fp32 upcast."""
    import torch
    import torch.nn.functional as F

    return F.group_norm(x.to(torch.bfloat16), m.num_groups, m.weight.to(torch.bfloat16),
                        m.bias.to(torch.bfloat16), m.eps)


def svd_vae(state, dtype, device="cuda"):
    import torch

    from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE

    vae = SVDTemporalVAE(dtype=dtype, device=device,
                         generator=torch.Generator(device).manual_seed(1))
    vae.load_state_dict(state)
    return vae.eval()


def raw_latents(shape, seed):
    """Raw (unscaled) latents as the decoders get them: N(0, 1) x SVD_SCALE
    latents divided back and clamped to +/-25."""
    from hma_tpu_torch.data.datasets import SVD_SCALE

    z = np.random.default_rng(seed).normal(size=shape) / SVD_SCALE
    return np.clip(z, -25.0, 25.0).astype(np.float32)


def psnr_pm1(x, ref):
    """PSNR of frames against reference frames, both nominally in [-1, 1]."""
    mse = float(((x.float() - ref.float()) ** 2).mean())
    return 10 * math.log10(4.0 / max(mse, 1e-30))


def vae_phase_checks(state, path):
    """Phase 19 (a)-(c): the VAE card against CPU in fp32, bf16 against fp32
    with planted faults, and its bf16 times."""
    import torch

    from hma_tpu_torch.rollout.decode import load_svd_decoder
    from hma_tpu_torch.tokenizer.magvit2 import GroupNorm
    from hma_tpu_torch.tokenizer.svd_vae import SpatioTemporalResBlock

    # (a) fp32, card against CPU
    z = raw_latents((1, 3, 8, 8, 4), seed=0)
    t0 = time.perf_counter()
    dec_cpu = load_svd_decoder(str(path), dtype=torch.float32, device="cpu")(z)
    dec_gpu = load_svd_decoder(str(path), dtype=torch.float32, device="cuda")(z)
    vae32, cpu32 = svd_vae(state, torch.float32), svd_vae(state, torch.float32, "cpu")
    frames = torch.from_numpy(np.clip(dec_cpu[0], -1, 1))
    with torch.no_grad():
        enc_cpu = cpu32.encode(frames)
        enc_gpu = vae32.encode(frames.cuda()).cpu()
    cpu_s = time.perf_counter() - t0
    del cpu32
    dec_err = float(np.abs(dec_gpu - dec_cpu).max() / np.abs(dec_cpu).max())
    enc_err = float((enc_gpu - enc_cpu).abs().max() / enc_cpu.abs().max())
    print(f"  (a) fp32 card vs CPU, raw latents (1, 3, 8, 8, 4): load_svd_decoder's 64² "
          f"frames max|dx|/max|x| {dec_err:.3e} (max|x| {np.abs(dec_cpu).max():.3f}); encode "
          f"of those 3 frames {enc_err:.3e} (max|z| {enc_cpu.abs().max().item():.3f}); tol "
          f"{VAE_CARD_TOL} (CPU side {cpu_s:.1f} s)", flush=True)

    # (b) bf16 against fp32 on the card, the d512 card's grid; planted faults
    vae16 = svd_vae(state, torch.bfloat16)
    z12 = torch.from_numpy(raw_latents((1, 12, 16, 16, 4), seed=1)).cuda()
    with torch.no_grad():
        x32 = vae32.decode(z12)

    def drift():
        with torch.no_grad():
            return psnr_pm1(vae16.decode(z12), x32)

    def mix_bf16(m, x, T):  # the residual stream left in bf16 after the blend
        return m.__class__.forward(m, x, T).to(torch.bfloat16)

    convs = (torch.nn.Conv2d, torch.nn.Conv3d)
    convs32 = dict(zip((m for m in vae16.modules() if isinstance(m, convs)),
                       (m for m in vae32.modules() if isinstance(m, convs))))
    faults = {
        "GroupNorm in bf16": ([m for m in vae16.modules() if isinstance(m, GroupNorm)],
                              group_norm_bf16),
        "conv weights left in fp32": (list(convs32),
                                      lambda m, x: convs32[m](x.float()).to(torch.bfloat16)),
        "residual stream in bf16": ([m for m in vae16.modules()
                                     if isinstance(m, SpatioTemporalResBlock)], mix_bf16)}
    sound = drift()
    readings = {}
    for name, (mods, forward) in faults.items():
        for m in mods:
            m.forward = functools.partial(forward, m)
        try:
            readings[name] = drift()
        finally:
            for m in mods:
                del m.forward
    inside = lambda db: VAE_BF16_PSNR[0] <= db <= VAE_BF16_PSNR[1]  # noqa: E731
    print(f"  (b) bf16 vs fp32 on the card, (1, 12, 16, 16, 4) -> 128² frames: PSNR "
          f"{sound:.2f} dB (window {VAE_BF16_PSNR} dB; max|x| fp32 "
          f"{x32.abs().max().item():.3f}); controls: "
          + ", ".join(f"'{k}' {v:.2f} dB" for k, v in readings.items()), flush=True)
    require(dec_err <= VAE_CARD_TOL and enc_err <= VAE_CARD_TOL, "SVD-VAE card vs CPU")
    require(inside(sound), "SVD-VAE bf16 drift")
    for name, db in readings.items():
        require(not inside(db), f"the SVD-VAE's bf16 window misses the control '{name}'")
    del vae32, x32, convs32

    # (c) bf16 times, CUDA-graph replays (a decode is ~900 launches)
    dec_w = sum(p.numel() * p.element_size() for p in vae16.decoder.parameters())
    enc_w = sum(p.numel() * p.element_size() for p in vae16.encoder.parameters()) + sum(
        p.numel() * p.element_size() for p in vae16.quant_conv.parameters())
    z32 = torch.from_numpy(raw_latents((1, 12, 32, 32, 4), seed=2)).cuda()
    img8 = torch.from_numpy(synthetic_frames(8, seed=3)).cuda().float().div(127.5).sub(1)
    cases = (("decode, d512 grid: (1, 12, 16, 16, 4) -> 12 frames of 128²",
              lambda: vae16.decode(z12), 12, dec_w, 12 * 16 * 16 * 4 * 4, 12 * 128 * 128 * 3 * 2),
             ("decode, (1, 12, 32, 32, 4) -> 12 frames of 256²",
              lambda: vae16.decode(z32), 12, dec_w, 12 * 32 * 32 * 4 * 4, 12 * 256 * 256 * 3 * 2),
             ("encode, B 8 frames of 256²", lambda: vae16.encode(img8), 8, enc_w,
              8 * 256 * 256 * 3 * 4, 8 * 32 * 32 * 4 * 2))
    for label, call, frames_n, w_bytes, in_bytes, out_bytes in cases:
        flops = conv_flops(vae16, call)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms = cuda_ms(call, iters=5, warmup=2, graph=True)
        b_ms, b_by = bound(w_bytes + in_bytes + out_bytes, flops)
        print(f"  (c) {label}, bf16: {ms}; {frames_n / float(ms) * 1e3:.1f} frames/s; bound "
              f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} GFLOP of convs, linears and "
              f"attention); {float(ms) / b_ms:.1f} x bound; peak memory {peak:.2f} GiB",
              flush=True)


def backbone_checks():
    """Phase 19 (d): InceptionV3 and both I3D variants, fp32 with TF32 off,
    card against CPU on the same weights (seeded, BatchNorm statistics from
    the inputs), then their throughput at the batches evaluate_feature gives
    them (32 frames, 8 clips of 12 frames of 128², the d512 card's decode)."""
    import torch

    from hma_tpu_torch.metrics.fid import (
        InceptionV3FID, backbone, fp32_convs, inception_inputs, make_inception_embed_fn)
    from hma_tpu_torch.metrics.fvd import InceptionI3D, i3d_inputs, make_i3d_embed_fn

    frames = synthetic_frames(32, seed=6, side=128)
    clips = synthetic_frames(8 * 12, seed=7, side=128).reshape(8, 12, 128, 128, 3)
    nets = {"InceptionV3": (InceptionV3FID, make_inception_embed_fn, {}, frames[:4],
                            lambda x: inception_inputs(x), frames, "images")}
    for backend, classes in (("videogpt", None), ("styleganv", 400)):
        nets[f"I3D {backend}"] = (
            functools.partial(InceptionI3D, classes), make_i3d_embed_fn, {"backend": backend},
            clips[:2], functools.partial(i3d_inputs, resize=224, backend=backend), clips,
            "clips")
    for name, (make, embed_fn, kw, few, prep, batch, unit) in nets.items():
        # BatchNorm statistics from `few` (with a fresh net's identity ones
        # the global pool leaves features that barely differ between inputs)
        model = backbone(make, None, "cuda", seed=0)
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.momentum = None
        model.train()
        with torch.no_grad(), fp32_convs():
            model(prep(torch.from_numpy(few).cuda()))
        state = {k: v.cpu() for k, v in model.eval().state_dict().items()}
        t0 = time.perf_counter()
        f_cpu = embed_fn(state, device="cpu", **kw)(few)
        cpu_s = time.perf_counter() - t0
        f_gpu = embed_fn(state, device="cuda", **kw)(few)
        err = float(np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max())
        spread = float(np.abs(f_cpu - f_cpu.mean(0)).max() / np.abs(f_cpu).max())
        x = torch.from_numpy(batch).cuda()
        flops = conv_flops(model, lambda: model(prep(x)))
        with torch.no_grad(), fp32_convs():
            ms = cuda_ms(lambda: model(prep(x)), iters=5, warmup=2, graph=True)
        w_bytes = sum(p.numel() * 4 for p in model.parameters())
        b_ms, b_by = bound(w_bytes + x.numel() + len(batch) * f_cpu.shape[1] * 4, flops,
                           FP32_FLOP_PER_S)
        print(f"  (d) {name}: features {f_cpu.shape[1]}-d, card vs CPU on {len(few)} {unit} "
              f"max|df|/max|f| {err:.3e} (tol {BACKBONE_TOL}; the features differ between "
              f"inputs by {spread:.3f} of max|f|; CPU side {cpu_s:.1f} s); "
              f"{len(batch)} {unit} of 128², fp32: {ms}; {len(batch) / float(ms) * 1e3:.1f} "
              f"{unit}/s; bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} GFLOP at 67 "
              f"TFLOP/s fp32); {float(ms) / b_ms:.1f} x bound", flush=True)
        require(err <= BACKBONE_TOL and np.isfinite(f_gpu).all(), f"{name} card vs CPU")
        del model, x


def stmar_pixel_simulator(records, vae_path):
    """Phase 19 (e): build_simulator on a full-width d512 STMAR checkpoint and
    the VAE file, at phase 18's settings, 3 steps after a warm-up: step p50
    with and without the decode, busy share, K1'/K6' launches a step (phase
    18's)."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.sim.app import build_simulator
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    H, STEPS = 3, 3
    mcfg = mar_flagship_config(40)
    with tempfile.TemporaryDirectory() as tmp:
        mar = STMAR(mcfg, dtype=torch.bfloat16, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
        seq = mar.seq_len + mcfg.action_token_size
        save_checkpoint(tmp, "mar", mar.state_dict(), mcfg)
        del mar
        t0 = time.perf_counter()
        sim = build_simulator(str(Path(tmp) / "mar"), str(vae_path), domain="domain_0")
        load_s = time.perf_counter() - t0
    # build_simulator keeps hma_tpu's defaults (2 MaskGIT steps at temperature
    # 0); phase 18 runs the card's 16 at temperature 1, and so does this
    sim.maskgit_steps, sim.temperature = mcfg.maskgit_steps, 1.0
    lat, acts = mar_data(mcfg, 1)
    moves = np.random.default_rng(0).normal(size=(STEPS + 1, mcfg.d_actions[0])).astype(
        np.float32)
    sim.set_initial_state(lat[0, :H].cpu().numpy(), acts[0, :H].cpu().numpy())
    sim.step(moves[0])  # warm-up
    sim._step_times.clear()
    torch.cuda.synchronize()
    reset_counts()
    walls = []
    for move in moves[1:]:
        t0 = time.perf_counter()
        px = sim.step(move)
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    stats = sim.measure_step_time()
    with_decode = float(np.median(walls)) * 1e3
    per_step = {k: v / STEPS for k, v in counts.items() if v}
    print(f"  (e) build_simulator, d512 STMAR + SVD-VAE (bf16; loaded in {load_s:.1f} s), B 1, "
          f"{STEPS} steps ({mcfg.maskgit_steps} MaskGIT x {mcfg.num_sampling_steps} denoise "
          f"steps): model p50 {stats['p50_ms']:.2f} ms, with the 128² decode "
          f"{with_decode:.2f} ms; frame {px.shape} {px.dtype}; launches a step {per_step}",
          flush=True)
    require(px.shape == (8 * mcfg.h, 8 * mcfg.h, 3) and px.dtype == np.uint8,
            "STMAR simulator pixels")
    forwards = H + mcfg.maskgit_steps + 1  # as phase 18's
    require(counts["K1'"] == STEPS * forwards * mcfg.num_layers
            and counts["K6'"] == STEPS * mcfg.maskgit_steps, f"STMAR pixel simulator {counts}")
    set_launches(records, {("K1'", (1, seq, mcfg.num_heads, mcfg.d_model // mcfg.num_heads)):
                           counts["K1'"],
                           ("K6'", (100, 6, mcfg.vae_embed_dim * mcfg.patch_size**2,
                                    mcfg.diffloss_w, mcfg.diffloss_d)): counts["K6'"]},
                 add=True)
    profile_run("STMAR simulator step with the decode", lambda: sim.step(moves[0]),
                with_decode / 1e3)


def pixel_eval_entry(records, vae_path):
    """Phase 19 (f): evaluate_feature --vae_checkpoint --compute_fid
    --compute_fvd (styleganv) on a 2-layer d512 checkpoint, B 8, T 12, 16
    MaskGIT steps; fid and fvd against the library functions on the clips
    the same windows decode to (EVAL_TOL)."""
    import torch

    from hma_tpu_torch.data.datasets import RawFeatureDataset
    from hma_tpu_torch.evaluate_feature import FID_SEED, load_mar_model
    from hma_tpu_torch.evaluate_feature import main as evaluate_feature_main
    from hma_tpu_torch.metrics.fid import calculate_fid
    from hma_tpu_torch.metrics.fvd import calculate_fvd
    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.rollout.decode import decode_clips, load_svd_decoder
    from hma_tpu_torch.rollout.mar import teacher_forced_latents
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    B = 8
    cfg = mar_flagship_config(40)
    cfg.num_layers = 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model = STMAR(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
        write_latent_dataset(tmp / "lat", cfg, seed=5)
        save_checkpoint(str(tmp), "mar", model.state_dict(), cfg)
        del model
        reset_counts()
        t0 = time.perf_counter()
        got = evaluate_feature_main([
            "--checkpoint_dir", str(tmp / "mar"), "--val_data_dir", str(tmp / "lat"),
            "--output_dir", str(tmp / "out"), "--batch_size", str(B), "--max_examples", str(B),
            "--vae_checkpoint", str(vae_path), "--compute_fid", "--compute_fvd",
            "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        counts = read_counts()
        model, cfg = load_mar_model(str(tmp / "mar"), "cuda", torch.bfloat16)
        ds = RawFeatureDataset(tmp / "lat", window_size=cfg.T, use_actions=True)
        items = [ds[i] for i in range(B)]
    lat = torch.from_numpy(np.stack([it["input_ids"] for it in items]).reshape(
        B, cfg.T, cfg.h, cfg.h, cfg.vae_embed_dim).astype(np.float32)).cuda()
    acts = np.stack([it["action_ids"] for it in items]).astype(np.float32)
    acts = torch.from_numpy(np.pad(acts, ((0, 0), (0, 0),
                                          (0, cfg.max_d_action - acts.shape[-1])))).cuda()
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = torch.cat([lat[:, :1], teacher_forced_latents(
            model, lat, acts, 0, torch.Generator("cuda").manual_seed(FID_SEED))], 1)
    decode = load_svd_decoder(str(vae_path))
    pred_px = decode_clips(decode, pred.float().cpu().numpy())
    gt_px = decode_clips(decode, lat.cpu().numpy())
    want = {"fid": calculate_fid(pred_px.reshape(-1, *pred_px.shape[2:]),
                                 gt_px.reshape(-1, *gt_px.shape[2:])),
            "fvd": calculate_fvd(pred_px, gt_px, backend="styleganv")}
    lib_s = time.perf_counter() - t0
    d = rel_diff(got, want, ("fid", "fvd"))
    frames = cfg.T - 1
    print(f"  (f) evaluate_feature --vae_checkpoint --compute_fid --compute_fvd, B {B}, T "
          f"{cfg.T} ({cli_s:.1f} s): fid {got['fid']!r}, fvd {got['fvd']!r}, fid_latent "
          f"{got['fid_latent']:.4f}, fvd_latent {got['fvd_latent']:.4f}; library fid "
          f"{want['fid']!r}, fvd {want['fvd']!r} ({lib_s:.1f} s); max rel diff {d:.3e} (tol "
          f"{EVAL_TOL}); {pred_px.shape} uint8 clips; launches {counts}", flush=True)
    require(d <= EVAL_TOL and all(math.isfinite(got[k]) for k in ("fid", "fvd")),
            "evaluate_feature --vae_checkpoint")
    # two teacher-forced passes (the metrics' and FID/FVD's), each a frame
    # STEPS refinements, a cache fill and a ground-truth fill
    require(counts["K6'"] == 2 * frames * cfg.maskgit_steps
            and counts["K1'"] == 2 * frames * (cfg.maskgit_steps + 2) * cfg.num_layers,
            f"evaluate_feature --vae_checkpoint launches {counts}")
    # B 8 at 16 MaskGIT steps: phase 9's rollout shapes, K6' at N 48
    set_launches(records, {
        ("K1'", (B, model.seq_len + cfg.action_token_size, cfg.num_heads,
                 cfg.d_model // cfg.num_heads)): counts["K1'"],
        ("K6'", (100, 48, cfg.vae_embed_dim * cfg.patch_size**2, cfg.diffloss_w,
                 cfg.diffloss_d)): counts["K6'"]}, add=True)


def pixel_metrics_phase(records):
    """Phase 19: the SVD temporal VAE at full width (card vs CPU, bf16 window
    with planted faults, times), InceptionV3 and I3D (card vs CPU, times),
    the d512 STMAR simulator with pixels through build_simulator, and
    evaluate_feature --vae_checkpoint --compute_fid --compute_fvd."""
    import torch

    state = svd_vae_state()
    n = sum(v.numel() for v in state.values())
    n_dec = sum(v.numel() for k, v in state.items() if k.startswith("decoder."))
    print(f"  SVDTemporalVAE(): {n / 1e6:.2f}M params (decoder {n_dec / 1e6:.2f}M)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "svd_vae.pt"
        torch.save(state, path)
        vae_phase_checks(state, path)
        torch.cuda.empty_cache()
        backbone_checks()
        torch.cuda.empty_cache()
        stmar_pixel_simulator(records, path)
        torch.cuda.empty_cache()
        pixel_eval_entry(records, path)


# Phase 20: LPIPS, the tokenizer's GAN training, train_tokenizer, the
# trainer's pixel metrics and visualize. (a) LPIPS distances, fp32 card
# (TF32 off) against the CPU on 256² pairs, relative to the largest: an
# H100 80GB HBM3 (700 W) reads 0 (VGG) and 1.366e-07 (AlexNet).
LPIPS_CARD_TOL = 1e-6
# (b) one fp32 GAN step of the full-width codec, card against CPU on a 64²
# batch, in three cases: the VGG LPIPS at gen_loss_weight 0.1 and None, and
# neither LPIPS nor the entropy term (codebook_weight 0). The logs, the
# LeCam EMAs and the discriminator's running statistics relative to the
# value (to each tensor's largest): the H100 reads up to 2.382e-05
# (d_weight, the adaptive weight's ratio of gradient norms), the rest <=
# 2.4e-6. The Adam moments (the gradients' sums) relative to each tensor's
# largest: the entropy term's per-bit sigmoid(4 z / 0.01) multiplies the
# two devices' rounding differences in the latents by up to 100, so the
# codec's gradients agree less closely than its forward does: the H100
# reads up to 1.847e-03 (the discriminator's 5.9e-6); without the entropy
# term up to 1.464e-05, held to GAN_PLAIN_MOMENT_TOL. The parameters and
# their EMA: Adam's first step moves an element by lr times the sign of its
# gradient whatever the gradient's size, so where a gradient is ~0 the two
# devices may move it 2 lr apart (the H100 reads 2.000 lr with the entropy
# term, 1.178 lr without it, in the discriminator), and a limit over all
# elements says nothing. So the parameters are held where the first moment
# exceeds twice the case's moment limit times its tensor's largest (there
# the moment limit fixes the gradient's sign, and the update is lr times
# it) to GAN_MASKED_PARAM_TOL lr: the H100 reads 5.960e-04 and 1.192e-03
# lr with the entropy term, 1.192e-03 lr without (the parameters'
# rounding). That holds 0.861 and 0.857 of the elements with the entropy
# term, 0.997 without; fewer than GAN_MIN_SHARE_HELD fails.
GAN_LOG_TOL = 1e-4
GAN_MOMENT_TOL = 5e-3
GAN_PLAIN_MOMENT_TOL = 1e-4
GAN_MASKED_PARAM_TOL = 0.02
GAN_MIN_SHARE_HELD = 0.8
GAN_LR = 1e-4
GAN_BF16_STEPS = 30


def lpips_file(path, net, seed):
    """An LPIPS state-dict file in the lpips package's layout: the trunk from
    `seed` (conv weights N(0, 1 / fan_in), biases 0), the heads drawn U(0, 1)
    so that they take part; AlexNet's heads under the newer `lins.` keys.
    Returns the state dict."""
    import torch

    from hma_tpu_torch.metrics.lpips import LPIPS

    g = torch.Generator().manual_seed(seed)
    sd = {(k.replace("lin", "lins.", 1) if net == "alex" and k.startswith("lin") else k):
          (torch.rand(v.shape, generator=g) if k.startswith("lin") else v)
          for k, v in LPIPS(net, device="cpu", generator=g).state_dict().items()}
    torch.save(sd, path)
    return sd


def pm1_frames(n, seed, side=256, device="cuda"):
    """synthetic_frames as (n, 3, side, side) fp32 in [-1, 1] on `device`."""
    import torch

    x = torch.from_numpy(synthetic_frames(n, seed=seed, side=side)).float() / 127.5 - 1.0
    return x.permute(0, 3, 1, 2).contiguous().to(device)


def lpips_checks(tmp):
    """Phase 20 (a): LPIPS VGG and AlexNet from state-dict files, fp32 card
    (TF32 off) against the CPU on B 2 pairs of 256² frames, d(x, x) = 0,
    then B 8 at 256² against the fp32 bound (convs counted by hooks)."""
    import torch

    from hma_tpu_torch.metrics.lpips import LPIPS, load_lpips_torch_weights

    x, y = pm1_frames(8, seed=8), pm1_frames(8, seed=9)
    for net, seed in (("vgg", 0), ("alex", 1)):
        sd = lpips_file(tmp / f"lpips_{net}.pt", net, seed)
        cpu = load_lpips_torch_weights(LPIPS(net, device="cpu"), sd)
        card = load_lpips_torch_weights(LPIPS(net, device="cuda"), sd)
        with torch.no_grad():
            t0 = time.perf_counter()
            d_cpu = cpu(x[:2].cpu(), y[:2].cpu())
            cpu_s = time.perf_counter() - t0
            d_gpu = card(x[:2], y[:2]).cpu()
            same = card(x[:2], x[:2]).cpu()
        err = ((d_gpu - d_cpu).abs().max() / d_cpu.abs().max()).item()
        flops = conv_flops(card, lambda: card(x, y))
        with torch.no_grad():  # as phase 19's backbones: graph replays
            ms = cuda_ms(lambda: card(x, y), iters=5, warmup=2, graph=True)
        w_bytes = 4 * sum(p.numel() for p in card.parameters())
        b_ms, b_by = bound(w_bytes + 4 * (x.numel() + y.numel() + 8), flops, FP32_FLOP_PER_S)
        print(f"  (a) LPIPS {net}: card vs CPU, B 2 at 256²: d {d_cpu.tolist()}, max|dd|/max|d| "
              f"{err:.3e} (tol {LPIPS_CARD_TOL}; CPU side {cpu_s:.1f} s); d(x, x) "
              f"{same.tolist()}; B 8 at 256², fp32: {ms}; {8 / float(ms) * 1e3:.1f} pairs/s; "
              f"bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} GFLOP at 67 TFLOP/s fp32); "
              f"{float(ms) / b_ms:.1f} x bound", flush=True)
        require(err <= LPIPS_CARD_TOL and bool((same == 0).all()), f"LPIPS {net} card vs CPU")


def gan_states(cfg, devices, lr, dtype=None):
    """init_vq_train_state on each device, all from the first's weights."""
    import torch

    from hma_tpu_torch.tokenizer.train_vq import init_vq_train_state

    states = [init_vq_train_state(cfg, 0, lr=lr, warmup_steps=1, dtype=dtype, device=d)
              for d in devices]
    for st in states[1:]:
        st.gen.load_state_dict(states[0].gen.state_dict())
        st.disc.load_state_dict(states[0].disc.state_dict())
        st.ema = {n: p.detach().clone() for n, p in st.gen.named_parameters()}
    return states


def gan_view(st, logs):
    """A GAN state and its step's logs as CPU fp32 tensors."""
    return {"logs": {k: v.float().cpu() for k, v in logs.items()},
            "gen": {k: v.cpu() for k, v in st.gen.state_dict().items()},
            "ema": {k: v.cpu() for k, v in st.ema.items()},
            "disc": {k: v.float().cpu() for k, v in st.disc.state_dict().items()
                     if "num_batches" not in k},
            "gen_m": {k: v.cpu() for k, v in st.gen_opt.m.items()},
            "gen_v": {k: v.cpu() for k, v in st.gen_opt.v.items()},
            "disc_m": {k: v.cpu() for k, v in st.disc_opt.m.items()},
            "lecam": {"real": st.lecam.real_ema.cpu(), "fake": st.lecam.fake_ema.cpu()}}


def gan_compare(got, want, lr, moment_tol):
    """Largest relative differences {group: (err, key)} of two gan_view()s;
    the largest parameter difference in units of lr over the elements whose
    first moment exceeds 2 moment_tol of its tensor's largest, and the
    share of elements that are."""
    out = {}
    for group in ("logs", "lecam", "gen_m", "gen_v", "disc_m", "disc"):
        errs = [(((got[group][k] - v).abs().max() / v.abs().max().clamp(min=1e-12)).item(), k)
                for k, v in want[group].items() if group != "disc" or "running" in k]
        out[group] = max(errs)
    masked, n_held, n_all = [], 0, 0
    for g, mg in (("gen", "gen_m"), ("ema", "gen_m"), ("disc", "disc_m")):
        for k, v in want[g].items():
            if "running" in k:
                continue
            m = want[mg][k].abs()
            sel = m > 2 * moment_tol * m.max()
            d = (got[g][k] - v).abs()[sel] / lr
            masked.append((d.max().item() if d.numel() else 0.0, f"{g} {k}"))
            n_held, n_all = n_held + d.numel(), n_all + v.numel()
    out["params where held / lr"] = max(masked)
    out["share held"] = (n_held / n_all, "gen, ema, disc")
    return out


def gan_step_flops(st, lpips, images):
    """(bf16, fp32) operations of one GAN step at the default fixed GAN
    weight, from each net's forward convs counted by hooks: the codec's
    forward and its backward (3x, bf16), LPIPS on the input and on the
    reconstruction and back through the latter (3 forwards, fp32), the
    discriminator on the reconstruction and back to it (2x), then on the
    real and fake batches with their backwards (6x), fp32."""
    import torch

    codec = conv_flops(st.gen, lambda: st.gen(images))
    lp = conv_flops(lpips, lambda: lpips(images, images)) / 2
    disc = conv_flops(st.disc, lambda: st.disc(images))
    return 3 * codec, 3 * lp + 8 * disc


def gan_step_checks(vgg_path):
    """Phase 20 (b): the GAN step at full width (VQConfig(), 256², B 8, the
    VGG LPIPS): one fp32 step card against CPU on a 64² batch at both GAN
    weights, and without LPIPS and the entropy term; then bf16 on the card,
    GAN_BF16_STEPS steps on a fixed batch where reconstruct_loss must fall,
    timed."""
    import dataclasses

    import torch

    from hma_tpu_torch.metrics.lpips import LPIPS, load_lpips_torch_weights
    from hma_tpu_torch.tokenizer.magvit2 import VQConfig
    from hma_tpu_torch.tokenizer.train_vq import make_vq_train_step

    sd = torch.load(vgg_path, weights_only=True)
    lpips = {d: load_lpips_torch_weights(LPIPS("vgg", device=d), sd) for d in ("cpu", "cuda")}
    x64 = pm1_frames(2, seed=10, side=64, device="cpu")
    for glw, with_lpips, codebook_weight, moment_tol in (
            (0.1, True, 0.1, GAN_MOMENT_TOL), (None, True, 0.1, GAN_MOMENT_TOL),
            (0.1, False, 0.0, GAN_PLAIN_MOMENT_TOL)):
        cfg = dataclasses.replace(VQConfig(), gen_loss_weight=glw,
                                  codebook_weight=codebook_weight)
        cpu, card = gan_states(cfg, ("cpu", "cuda"), GAN_LR, dtype=torch.float32)
        t0 = time.perf_counter()
        want = gan_view(cpu, make_vq_train_step(
            cpu, cfg, lpips["cpu"] if with_lpips else None)(x64))
        cpu_s = time.perf_counter() - t0
        got = gan_view(card, make_vq_train_step(
            card, cfg, lpips["cuda"] if with_lpips else None)(x64.cuda()))
        errs = gan_compare(got, want, GAN_LR, moment_tol)
        print(f"  (b) fp32 GAN step, card vs CPU, B 2 at 64², gen_loss_weight {glw}, "
              f"{'VGG LPIPS' if with_lpips else 'no LPIPS'}, codebook_weight {codebook_weight}: "
              f"d_weight {want['logs']['d_weight'].item():.4f}, total "
              f"{want['logs']['total_loss'].item():.4f}; "
              + "; ".join(f"{k} {e:.3e} ({n})" for k, (e, n) in errs.items())
              + f" (tols: logs, LeCam, running stats {GAN_LOG_TOL}; moments {moment_tol}; "
              f"params where |m| > 2 x {moment_tol} of the tensor's largest "
              f"{GAN_MASKED_PARAM_TOL} lr, on at least {GAN_MIN_SHARE_HELD} of them; CPU side "
              f"{cpu_s:.1f} s)", flush=True)
        require(all(errs[g][0] <= GAN_LOG_TOL for g in ("logs", "lecam", "disc"))
                and all(errs[g][0] <= moment_tol for g in ("gen_m", "gen_v", "disc_m"))
                and errs["params where held / lr"][0] <= GAN_MASKED_PARAM_TOL
                and errs["share held"][0] >= GAN_MIN_SHARE_HELD,
                f"GAN step card vs CPU, weight {glw}, LPIPS {with_lpips}")
        del cpu, card, got, want

    # bf16 on the card: GAN_BF16_STEPS steps on one batch, the first a warm-up
    cfg = VQConfig()
    (st,) = gan_states(cfg, ("cuda",), GAN_LR)
    n_params = sum(p.numel() for p in st.gen.parameters())
    step = make_vq_train_step(st, cfg, lpips["cuda"])
    x = pm1_frames(8, seed=11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recs, secs = [], []
    for _ in range(GAN_BF16_STEPS):
        t0 = time.perf_counter()
        logs = step(x)
        recs.append(float(logs["reconstruct_loss"]))  # waits for the step
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(secs[1:]))
    f16, f32 = gan_step_flops(st, lpips["cuda"], x)
    ops_ms = (f16 / BF16_FLOP_PER_S + f32 / FP32_FLOP_PER_S) * 1e3
    # Adam (p, m, v read and written, the gradient read) and the EMA (read
    # and written), fp32, for codec and discriminator
    n_all = n_params + sum(p.numel() for p in st.disc.parameters())
    bytes_ms = 4 * 9 * n_all / HBM_BYTES_PER_S * 1e3
    b_ms = max(ops_ms, bytes_ms)
    first, last = np.mean(recs[:5]), np.mean(recs[-5:])
    print(f"  (b) bf16 GAN step, VQConfig() ({n_params / 1e6:.2f}M), B 8 at 256², VGG LPIPS, "
          f"gen_loss_weight 0.1, lr {GAN_LR}: reconstruct_loss {recs[0]:.4f} -> {recs[-1]:.4f} "
          f"(mean of the first 5 {first:.4f}, of the last 5 {last:.4f}); median step "
          f"{med * 1e3:.2f} ms over {len(secs) - 1} steps after the first ({secs[0]:.2f} s), "
          f"{8 / med:.1f} images/s; peak memory {peak:.2f} GiB; bound {b_ms:.2f} ms "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: {f16 / 1e12:.2f} TFLOP bf16 "
          f"at 989, {f32 / 1e12:.2f} TFLOP fp32 at 67 TFLOP/s); {med * 1e3 / b_ms:.1f} x bound",
          flush=True)
    require(all(math.isfinite(r) for r in recs) and last < first,
            "bf16 GAN steps: reconstruct_loss does not fall")
    profile_run("bf16 GAN step", lambda: step(x), med)


def tokenizer_cli_checks(tmp, vgg_path, records):
    """Phase 20 (c): `python -m hma_tpu_torch.train_tokenizer` (VQConfig(),
    B 8, 256²) for 4 steps with the VGG LPIPS and a checkpoint every 2; its
    first step's logs against the library's step on the same batch;
    load_magvit2 reads the EMA back; `evaluate --tokenizer_ckpt` on it."""
    import os

    import torch

    from hma_tpu_torch.data.datasets import RawImageDataset, write_token_dataset
    from hma_tpu_torch.evaluate import main as evaluate_main
    from hma_tpu_torch.metrics.lpips import LPIPS, load_lpips_torch_weights
    from hma_tpu_torch.tokenizer.convert import TOKENIZER_FILE, load_magvit2
    from hma_tpu_torch.tokenizer.magvit2 import VQConfig
    from hma_tpu_torch.tokenizer.train_vq import init_vq_train_state, make_vq_train_step

    write_token_dataset(tmp / "raw", synthetic_frames(16, seed=12), np.zeros(16), None,
                        {"name": "raw"})
    out = tmp / "tok"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hma_tpu_torch.train_tokenizer", "--train_data_dir",
         str(tmp / "raw"), "--output_dir", str(out), "--max_train_steps", "4",
         "--checkpointing_steps", "2", "--log_every", "1", "--warmup_steps", "1",
         "--lpips_weights", str(vgg_path), "--seed", "3", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"python -m hma_tpu_torch.train_tokenizer: {proc.stderr}")
    logs = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    logs = [l for l in logs if "tok/total_loss" in l]
    tags = sorted(p.name for p in out.iterdir() if p.is_dir())

    # the library's first step from the same seed on the same draw
    ds = RawImageDataset(tmp / "raw", window_size=1, compute_stride_from_freq_table=False,
                         filter_interrupts=False)
    idx = np.random.default_rng(3).integers(0, len(ds), 8)
    images = (torch.from_numpy(np.stack([ds[int(i)]["images"][0] for i in idx])).cuda()
              / 127.5 - 1.0).permute(0, 3, 1, 2)
    st = init_vq_train_state(VQConfig(), 3, device="cuda")
    lpips = load_lpips_torch_weights(LPIPS("vgg", device="cuda"),
                                     torch.load(vgg_path, weights_only=True))
    lib = {f"tok/{k}": float(v) for k, v in make_vq_train_step(st, VQConfig(), lpips)(
        images).items()}
    del st
    d = rel_diff(logs[0], lib, list(lib))
    state, cfg = load_magvit2(str(out))
    saved = torch.load(out / "step_4" / TOKENIZER_FILE, weights_only=True)
    ema_ok = all(torch.equal(state[k], saved["ema"][k]) for k in state)
    losses = ", ".join(f"{line['tok/total_loss']:.4f}" for line in logs)
    print(f"  (c) python -m hma_tpu_torch.train_tokenizer ({cli_s:.1f} s): tags {tags}, "
          f"{len(logs)} logged steps, total_loss {losses}; step 1 against the "
          f"library's step on the same batch: max rel diff {d:.3e} (tol {EVAL_TOL}); "
          f"load_magvit2 returns step_4's EMA: {ema_ok}", flush=True)
    require(tags == ["final_checkpt", "step_2", "step_4"] and len(logs) == 4
            and d <= EVAL_TOL and ema_ok and cfg == VQConfig(), "train_tokenizer CLI")

    B = 8
    cfg = write_discrete_checkpoint(tmp)
    reset_counts()
    got = evaluate_main(["--checkpoint_dir", str(tmp / "ckpt"), "--val_data_dir",
                         str(tmp / "data"), "--output_dir", str(tmp / "eval"),
                         "--batch_size", str(B), "--max_examples", str(B),
                         "--tokenizer_ckpt", str(out), "--num_action_trials", "0",
                         "--device", "cuda"])
    counts = read_counts()
    print(f"  (c) evaluate --tokenizer_ckpt <train_tokenizer dir>, B {B}: {json.dumps(got)}; "
          f"launches {counts}", flush=True)
    require(all(math.isfinite(got[k]) for k in ("psnr", "ssim", "dec_time")),
            "evaluate --tokenizer_ckpt on the trained tokenizer")
    k1 = cfg.num_layers * (cfg.T - 1) * 3  # 3 cached forwards a frame
    require(counts["K1'"] == k1 and counts["K3'"] == 0, f"evaluate launches {counts}")
    set_launches(records, {("K1'", (B, 320, 8, 32)): k1}, add=True)
    return out


def trainer_vis_checks(tmp, tok_dir, alex_path, records):
    """Phase 20 (d): train_multi on the 2-layer d256 card, B 8, with
    --tokenizer_checkpoint (the train_tokenizer directory) and
    --lpips_weights (AlexNet), the rollout eval at step 1: vis/rollout_psnr
    and vis/rollout_lpips against the library functions on the tokens that
    rollout gave; every launch in a phase-3 record."""
    import torch

    from hma_tpu_torch.metrics.image import batch_psnr
    from hma_tpu_torch.metrics.lpips import make_lpips_fn
    from hma_tpu_torch.rollout.decode import make_token_decoder
    from hma_tpu_torch.tokenizer.convert import load_magvit2
    from hma_tpu_torch.train import trainer
    from hma_tpu_torch.train_multi import main as train_main

    cfg = flagship_config(1)
    cfg.num_layers = 2
    B, L = 8, cfg.num_layers
    write_dataset(tmp / "domain_0_magvit_max1000000_train", cfg, seed=13)
    cfg.save_pretrained(str(tmp / "card.json"))
    (tmp / "split.yaml").write_text("domains: domain_0\n")
    seen, parts = [], {}
    generate, run_eval = trainer.generate_tokens, trainer.run_eval

    def counted(name, fn):
        def call(*a, **kw):
            before = read_counts()
            out = fn(*a, **kw)
            after = read_counts()
            parts[name] = {k: parts.get(name, {}).get(k, 0) + after[k] - before[k]
                           for k in after}
            if name == "rollout":
                seen.append((a[1].clone(), out.clone()))
            return out
        return call

    trainer.generate_tokens = counted("rollout", generate)
    trainer.run_eval = counted("eval", run_eval)
    try:
        reset_counts()
        train_main(["--genie_config", str(tmp / "card.json"), "--output_dir", str(tmp / "run"),
                    "--train_split", str(tmp / "split.yaml"), "--data_root", str(tmp),
                    "--window_size", str(cfg.T), "--per_device_train_batch_size", str(B),
                    "--per_device_eval_batch_size", str(B), "--max_train_steps", "2",
                    "--overfit_first_batch", "--vis_every_n_steps", "1",
                    "--eval_every_n_steps", "2", "--max_eval_steps", "1", "--log_every", "1",
                    "--num_warmup_steps", "1", "--tokenizer_checkpoint", str(tok_dir),
                    "--lpips_weights", str(alex_path), "--device", "cuda"])
        total = read_counts()
    finally:
        trainer.generate_tokens, trainer.run_eval = generate, run_eval
    lines = [json.loads(l) for l in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
    vis = [l for l in lines if "vis/rollout_psnr" in l]
    require(len(vis) == 1 and len(seen) == 1, f"train_multi vis lines {vis}")
    labels, out = seen[0]
    p = cfg.num_prompt_frames
    decode = make_token_decoder(*load_magvit2(str(tok_dir)))
    side = math.isqrt(cfg.S)
    pred_px = decode(out[:, p:].reshape(-1, side, side))
    gt_px = decode(labels[:, p:].reshape(-1, side, side))
    want = {"vis/rollout_psnr": float(np.mean(batch_psnr(pred_px, gt_px))),
            "vis/rollout_lpips": float(np.mean(make_lpips_fn(
                torch.load(alex_path, weights_only=True), net="alex")(pred_px, gt_px)))}
    d = rel_diff(vis[0], want, list(want))
    train = {k: total[k] - parts["rollout"][k] - parts["eval"][k] for k in total}
    want_train = {k: 2 * n for k, n in train_launches(L, "transpose").items()}
    rollout_k1 = L * (p + (cfg.T - p) * 3)  # 2 MaskGIT steps + the cache fill a frame
    print(f"  (d) train_multi --tokenizer_checkpoint --lpips_weights (alex), B {B}: "
          f"{json.dumps({k: v for k, v in vis[0].items() if k.startswith('vis/')})}; library "
          f"{json.dumps(want)} on {tuple(pred_px.shape)} frames; max rel diff {d:.3e} (tol "
          f"{EVAL_TOL}); launches: training {train}, eval {parts['eval']}, rollout "
          f"{parts['rollout']}", flush=True)
    require(d <= EVAL_TOL, "train_multi rollout_psnr / rollout_lpips")
    require(train == want_train and parts["eval"]["K1'"] == L and parts["eval"]["K3'"] == L
            and parts["rollout"]["K1'"] == rollout_k1
            and sum(parts["rollout"].values()) == rollout_k1, "train_multi launches")
    T, S = cfg.T, cfg.S + cfg.action_token_size
    set_launches(records, {("K1'", (B * T, S, 8, 32)): train["K1'"] + L,
                           ("K2'", (B * T, S, 8, 32)): train["K2'"],
                           ("K3'", (B * S, T, 8, 32)): train["K3'"] + L,
                           ("K4'", (B * S, T, 8, 32)): train["K4'"],
                           ("K1'", (B, S, 8, 32)): rollout_k1}, add=True)


def visualize_checks(tmp, tok_dir, records):
    """Phase 20 (e): `generate` at B 8 (windows of 2 prompt and 2 generated
    frames) on a 2-layer d256 checkpoint and on a 2-layer d512 STMAR one,
    then `visualize` on each output (the trained tokenizer; a full-width
    SVD-VAE file): its frames against the library's decode bit for bit,
    then the GIF and comic PNG files where Pillow imports."""
    import importlib.util

    import torch

    from hma_tpu_torch import visualize
    from hma_tpu_torch.generate import main as generate_main
    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.rollout.decode import load_svd_decoder, make_token_decoder
    from hma_tpu_torch.tokenizer.convert import load_magvit2
    from hma_tpu_torch.utils.checkpoint import save_checkpoint

    B, W = 8, 4
    dcfg = write_discrete_checkpoint(tmp / "d")
    mcfg = mar_flagship_config(40)
    mcfg.num_layers = 2
    mar = STMAR(mcfg, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    seq = mar.seq_len + mcfg.action_token_size
    write_latent_dataset(tmp / "m" / "lat", mcfg, seed=14)
    save_checkpoint(str(tmp / "m"), "mar", mar.state_dict(), mcfg)
    del mar
    torch.save(svd_vae_state(), tmp / "vae.pt")
    pil = importlib.util.find_spec("PIL") is not None
    print("  (e) Pillow " + ("imports: the GIF and PNG files are written" if pil
                             else "does not import: the frames alone are checked"), flush=True)
    cases = (("tokens", tmp / "d" / "ckpt", tmp / "d" / "data", [], str(tok_dir)),
             ("latents", tmp / "m" / "mar", tmp / "m" / "lat", ["--use_feature"],
              str(tmp / "vae.pt")))
    for name, ckpt, data, extra, codec in cases:
        reset_counts()
        generate_main(["--checkpoint_dir", str(ckpt), "--val_data_dir", str(data),
                       "--output_dir", str(tmp / name), "--batch_size", str(B),
                       "--num_prompt_frames", "2", "--window_size", str(W), "--device", "cuda",
                       *extra])
        counts = read_counts()
        args = ["--token_dir", str(tmp / name), "--tokenizer_ckpt", codec, "--max_examples",
                "2", "--device", "cuda"]
        frames = list(visualize.decode_examples(visualize.parse_args(args)))
        meta = json.loads((tmp / name / "metadata.json").read_text())
        per_ex = meta["num_prompt_frames"] + 2 * (meta["window_size"] - meta["num_prompt_frames"])
        if name == "tokens":
            video = np.fromfile(tmp / name / "video.bin", np.dtype(meta["token_dtype"])
                                ).reshape(-1, meta["h"], meta["w"])
            lib = make_token_decoder(*load_magvit2(codec))
            want = [lib(video[i * per_ex:(i + 1) * per_ex]) for i in range(2)]
        else:
            C = meta["latent_channels"]
            video = np.fromfile(tmp / name / "video.bin", np.float16).reshape(
                -1, C, meta["h"], meta["w"]).transpose(0, 2, 3, 1)
            dec = load_svd_decoder(codec)
            want = [np.clip((dec(np.clip(video[i * per_ex:(i + 1) * per_ex], -25.0, 25.0)
                                 .astype(np.float32)[None])[0] + 1) * 127.5, 0, 255)
                    .astype(np.uint8) for i in range(2)]
        same = len(frames) == 2 and all(np.array_equal(px, w) for (_, px, *_), w in
                                        zip(frames, want))
        files = []
        if pil:
            visualize.main([*args, "--output_dir", str(tmp / f"vis_{name}")])
            files = sorted(p.name for p in (tmp / f"vis_{name}").iterdir())
        print(f"  (e) visualize on generate's {name} (B {B}; launches {counts}): 2 examples of "
              f"{frames[0][1].shape} uint8 frames, equal to the library decode bit for bit: "
              f"{same}; files {files}", flush=True)
        require(same, f"visualize {name} frames")
        require(not pil or files == ["example_0.gif", "example_0_comic.png", "example_1.gif",
                                     "example_1_comic.png"], f"visualize {name} files")
        if name == "tokens":
            k1 = dcfg.num_layers * (2 + (W - 2) * 3)  # 2 MaskGIT steps + the cache fill
            require(counts["K1'"] == k1, f"generate launches {counts}")
            set_launches(records, {("K1'", (B, 320, 8, 32)): k1}, add=True)
        else:
            k6 = (W - 2) * mcfg.maskgit_steps
            k1 = (2 + (W - 2) + k6) * mcfg.num_layers
            require(counts["K6'"] == k6 and counts["K1'"] == k1, f"generate launches {counts}")
            set_launches(records, {
                ("K1'", (B, seq, mcfg.num_heads, mcfg.d_model // mcfg.num_heads)): k1,
                ("K6'", (100, B * 6, mcfg.vae_embed_dim * mcfg.patch_size**2, mcfg.diffloss_w,
                         mcfg.diffloss_d)): k6}, add=True)


def tokenizer_training_phase(records):
    """Phase 20: LPIPS, the GAN step, the train_tokenizer CLI, the trainer's
    pixel metrics and visualize."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lpips_checks(tmp)
        torch.cuda.empty_cache()
        gan_step_checks(tmp / "lpips_vgg.pt")
        torch.cuda.empty_cache()
        tok_dir = tokenizer_cli_checks(tmp, tmp / "lpips_vgg.pt", records)
        trainer_vis_checks(tmp / "train", tok_dir, tmp / "lpips_alex.pt", records)
        visualize_checks(tmp / "vis", tok_dir, records)


# Phase 21: the encode pipeline and the native loader. Toyworld's train split
# has 480 episodes of 40 frames: shards 0 and 1 of 60 are 16 episodes, 640
# frames; shard 0 of 48 of the val split is one episode.
ENCODE_TRAIN_SHARDS = (0, 1)
ENCODE_NUM_SHARDS = 60
CARD_CPU_FRAMES = 4  # (a), (c): fp32 card and CPU against fp64 on these frames
# The card's fp32 encoders against an fp64 witness on the CPU, as max|dz| /
# max|z|, may be at most this many times the CPU fp32's own distance to the
# witness. Toyworld's flat frames amplify rounding, so phase 17's and phase
# 19's fixed card-vs-CPU limits (set on smooth frames, where the card reads
# 3.585e-06 and 2.493e-06) do not transfer: on 4 toyworld frames the CPU's
# fp32 codec reads 8.811e-05 and the card's 4.047e-04 (4.6 x), the SVD-VAE
# encoder 2.015e-05 and 9.936e-05 (4.9 x) (an H100 80GB HBM3 at 700 W). The
# bf16 codec, a control, must exceed the limit (181 x).
FP64_WITNESS_RATIO = 20
# (c) the bf16 SVD-VAE encode's float16 latents against the same witness, in
# the same units, in a window that four faults must each leave. The same
# H100 reads: sound 1239.6 x (the same in every call: fixed inputs and
# cuDNN choices); GroupNorm in bf16 1414.9 x; the conv weights left in fp32
# 1024.8 x; SVD_SCALE left out 221980.8 x; h and w swapped 59935.2 x. Each
# bound lies halfway between the sound reading and the nearest fault's.
SVD_BF16_WITNESS_RATIO = (1132, 1327)
RESIZE_SHARE = 1e-3  # (b): uint8 values off the plain resize, by one level at most
LOADER_BATCHES = 20  # batches timed on the host a loader


class Stopwatch:
    """Summed wall time per label, and the time a label's last call ended."""

    def __init__(self):
        self.secs, self.ended = {}, {}

    def add(self, label, secs):
        self.secs[label] = self.secs.get(label, 0.0) + secs

    def wrap(self, label, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.ended[label] = time.perf_counter()
            self.add(label, self.ended[label] - t0)
            return out
        return timed


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def timed_episodes(watch, encode_episodes):
    """encode_episodes under `watch`: its wall time, and the file writing,
    from the encoder's last return to its own."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        meta = encode_episodes(*a, **kw)
        t1 = time.perf_counter()
        watch.add("episodes", t1 - t0)
        watch.add("write", t1 - watch.ended.get("codec", t0))
        return meta
    return run


def encode_extern_timed(argv, watch):
    """`encode_extern.main(argv)` with the resize, the encoder and
    encode_episodes under `watch`; returns its metadata and wall time."""
    from hma_tpu_torch.data import encode_extern, encode_openx

    make = encode_extern.make_magvit_encoder

    def make_timed(*a, **kw):
        enc = make(*a, **kw)
        timed = watch.wrap("codec", enc)
        timed.vocab_size = enc.vocab_size
        return timed

    out = io.StringIO()
    with patched(encode_openx, "resize_image", watch.wrap("resize", encode_openx.resize_image)), \
            patched(encode_extern, "make_magvit_encoder", make_timed), \
            patched(encode_extern, "encode_episodes",
                    timed_episodes(watch, encode_extern.encode_episodes)), \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        encode_extern.main(argv)
        wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    require(len(lines) == 1, f"encode_extern printed {lines[:-1]}")  # no episode failed
    return json.loads(lines[-1]), wall


def toy_shard(tmp, suffix, i, n, split):
    """The directory encode_extern writes toyworld's shard i of n to."""
    from hma_tpu_torch.data.merge_shards import SHARD_DATA_FORMAT

    return SHARD_DATA_FORMAT.format(root=str(tmp / "shards"), name="toyworld", suffix=suffix,
                                    i=i, n=n, split=split)


def toyworld_frames(n, image_size, shard=0):
    """The first n frames of toyworld's train shard `shard` of 60."""
    from hma_tpu_torch.data.extern.toyworld import toyworld_episode_generator

    frames = [s["image"] for ep in toyworld_episode_generator(shard, ENCODE_NUM_SHARDS,
                                                              image_size=image_size)
              for s in ep["steps"]]
    return np.stack(frames[:n])


def shares(watch, total):
    return ", ".join(f"{k} {watch.secs.get(k, 0.0):.3f} s ({watch.secs.get(k, 0.0) / total:.1%})"
                     for k in ("resize", "codec", "write"))


def encode_discrete(tmp):
    """Phase 21 (a): toyworld's train shards 0 and 1 of 60 at 256² through
    `encode_extern.main --encoder_type magvit` (the released codec from seed
    0, bf16, B 64), a val shard, `merge_shards`, the token dataset; the fp32
    codec on the card against an fp64 witness, the bf16 share of differing
    tokens. Returns the checkpoint and the merged token video."""
    import torch

    from hma_tpu_torch.data import merge_shards
    from hma_tpu_torch.data.datasets import RawTokenDataset
    from hma_tpu_torch.data.encode_openx import make_magvit_encoder
    from hma_tpu_torch.rollout.decode import codec
    from hma_tpu_torch.tokenizer.image_ops import normalize_image_np
    from hma_tpu_torch.tokenizer.lfq import lfq_quantize

    state = codec_model(torch.float32).state_dict()
    ckpt = tmp / "magvit2.ckpt"
    write_tokenizer_ckpt(ckpt, state)
    common = ["--dataset_name", "toyworld", "--encoder_type", "magvit", "--encoder_name_or_path",
              str(ckpt), "--out_root", str(tmp / "shards"), "--image_size", "256"]
    watch, wall, frames = Stopwatch(), 0.0, 0
    for i in ENCODE_TRAIN_SHARDS:
        meta, secs = encode_extern_timed(common + ["--shard_ind", str(i), "--num_shards",
                                                   str(ENCODE_NUM_SHARDS)], watch)
        wall += secs
        frames += meta["num_images"]
    enc_s = watch.secs["episodes"]
    print(f"  (a) encode_extern --encoder_type magvit (bf16, B 64), toyworld train shards "
          f"{ENCODE_TRAIN_SHARDS} of {ENCODE_NUM_SHARDS} at 256²: {frames} frames in {enc_s:.3f} "
          f"s, {frames / enc_s:.1f} frames/s end to end ({frames / wall:.1f} with loading the "
          f"checkpoint and building the codec, {wall:.3f} s); {shares(watch, enc_s)}", flush=True)
    encode_extern_timed(common + ["--data_split", "val", "--shard_ind", "0",
                                  "--num_shards", "48"], Stopwatch())
    data = tmp / "data"
    for split, n, shards_ in (("train", ENCODE_NUM_SHARDS, ENCODE_TRAIN_SHARDS),
                              ("val", 48, (0,))):
        merged = merge_shards.merge_shards(
            [toy_shard(tmp, "magvit", i, n, split) for i in shards_],
            str(data / f"toyworld_magvit_max1000000_{split}"))
    meta = json.loads((data / "toyworld_magvit_max1000000_train" / "metadata.json").read_text())
    ds = RawTokenDataset(data / "toyworld_magvit_max1000000_train", window_size=12,
                         use_actions=True)
    video = np.fromfile(data / "toyworld_magvit_max1000000_train" / "video.bin",
                        np.uint32).reshape(-1, 16, 16)
    item = ds[len(ds) - 1]
    print(f"  merged: {meta}; val {merged['num_images']} frames; the token dataset reads "
          f"{len(ds)} windows, the last {item['input_ids'].shape} ids, actions "
          f"{item['action_ids'].shape}", flush=True)
    require(meta["vocab_size"] == 2**18 and meta["h"] == meta["w"] == 16
            and meta["token_dtype"] == "uint32" and meta["num_images"] == frames == 640
            and meta["num_episodes"] == 16 and len(ds) > 0, "merged token dataset")
    require(int(item["input_ids"].max()) < 2**18, "token dataset ids")

    # fp32 card and CPU against an fp64 witness on the CPU (toyworld's flat
    # frames amplify rounding: CPU fp32 itself is ~3e-4 of max|z| off fp64)
    pixels = toyworld_frames(CARD_CPU_FRAMES, 256)
    x = torch.from_numpy(normalize_image_np(pixels)).permute(0, 3, 1, 2)
    t0 = time.perf_counter()
    with torch.no_grad():
        z64 = codec(state, device="cpu", dtype=torch.float64).encode_without_quantize(
            x.double()).permute(0, 2, 3, 1)
        z32 = codec(state, device="cpu", dtype=torch.float32).encode_without_quantize(
            x).permute(0, 2, 3, 1)
    cpu_s = time.perf_counter() - t0
    gpu = codec(state, device="cuda", dtype=torch.float32)
    with torch.no_grad():
        zg = gpu.encode_without_quantize(x.cuda()).permute(0, 2, 3, 1).cpu()
        zb = codec(state, device="cuda").encode_without_quantize(x.cuda()).permute(
            0, 2, 3, 1).float().cpu()  # the control: bf16
    e32, eg, eb = witness_errors(z64, z32, zg, zb)
    tok_cpu = lfq_quantize(z32).indices.numpy()
    tok64 = lfq_quantize(z64.float()).indices.numpy()
    gpu32 = make_magvit_encoder(gpu)(toyworld_frames(64, 256))
    flipped = (zg > 0) != (z64 > 0)
    worst = float(z64.abs()[flipped].max() / z64.abs().max()) if flipped.any() else 0.0
    share = float((video[:64] != gpu32).mean())
    print(f"  fp32 against an fp64 witness on the CPU, first {CARD_CPU_FRAMES} frames, as "
          f"max|dz|/max|z| (max|z| {float(z64.abs().max()):.3f}): CPU fp32 {e32:.3e}, card "
          f"fp32 {eg:.3e} ({eg / e32:.1f} x, limit {FP64_WITNESS_RATIO} x), control card bf16 "
          f"{eb:.3e} ({eb / e32:.1f} x, must exceed the limit); card fp32 tokens differ from "
          f"the CPU's at {int((gpu32[:CARD_CPU_FRAMES] != tok_cpu).sum())} and from fp64's at "
          f"{int((gpu32[:CARD_CPU_FRAMES] != tok64).sum())} of {tok64.size} ({int(flipped.sum())} "
          f"flipped channels, largest fp64 |z| among them {worst:.3e} of max|z|; CPU side "
          f"{cpu_s:.1f} s); first 64 frames: the bf16 encode's tokens differ from fp32 on the "
          f"card at {share:.4%} (phase 17's window {CODEC_BF16_TOKEN_SHARE}); "
          f"{len(np.unique(gpu32))} distinct fp32 tokens", flush=True)
    require(eg <= FP64_WITNESS_RATIO * e32, "fp32 codec card vs the fp64 witness")
    require(eb > FP64_WITNESS_RATIO * e32, "the witness limit misses the bf16 control")
    require(CODEC_BF16_TOKEN_SHARE[0] <= share <= CODEC_BF16_TOKEN_SHARE[1],
            "bf16 token share")
    return ckpt, video


def witness_errors(z64, *zs):
    """max|z - z64| / max|z64| of each z, against the fp64 witness."""
    scale = z64.abs().max()
    return [float((z.double() - z64).abs().max() / scale) for z in zs]


def plain_resize_weights(n_in, n_out):
    """(n_out, n_in) float64 weights of jax.image.resize's "bilinear":
    a triangle kernel widened by the scale on a shrink, normalised, with
    half-pixel centres."""
    inv = n_in / n_out
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n_in)[None]) / kernel_scale)
    w /= w.sum(1, keepdims=True)
    return w


def resize_check():
    """Phase 21 (b): resize_image on frames of the data's real shapes against
    a plain float64 resize in numpy."""
    from hma_tpu_torch.tokenizer.image_ops import center_crop_to_square, resize_image

    for h, w in ((480, 640), (256, 320)):
        frames = synthetic_frames(8, seed=h, side=w)[:, (w - h) // 2:(w - h) // 2 + h]
        resize_image(frames[0], 256)  # warm-up
        t0 = time.perf_counter()
        got = np.stack([resize_image(f, 256) for f in frames])
        ms = (time.perf_counter() - t0) / len(frames) * 1e3
        sq = np.stack([center_crop_to_square(f) for f in frames]).astype(np.float64)
        wy = plain_resize_weights(sq.shape[1], 256)
        rows = np.tensordot(wy, sq, axes=([1], [1]))  # (256, n, side, c)
        want = np.tensordot(rows, wy, axes=([2], [1])).transpose(1, 0, 3, 2)
        want = np.clip(np.round(want), 0, 255)
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        share = float((diff > 0).mean())
        print(f"  (b) resize_image {h}x{w} -> 256² on the host: {ms:.3f} ms a frame; against the "
              f"plain float64 resize: max diff {diff.max()}, {share:.4%} of values differ "
              f"(limit 1 level on {RESIZE_SHARE:.1%})", flush=True)
        require(diff.max() <= 1 and share <= RESIZE_SHARE, f"resize {h}x{w}")


def svd_encoder_faults(vae32, frames):
    """`make_svd_encoder` over a bf16 copy of `vae32` on the uint8 `frames`,
    as (N, h, w, C) float32 of its float16 latents: "sound", and with a fault
    planted in the model (GroupNorm in bf16, the conv weights left in fp32)
    or in its output (SVD_SCALE left out, h and w swapped)."""
    import torch

    from hma_tpu_torch.data.datasets import SVD_SCALE
    from hma_tpu_torch.data.encode_openx import make_svd_encoder
    from hma_tpu_torch.tokenizer.magvit2 import GroupNorm
    from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE

    vae16 = SVDTemporalVAE(dtype=torch.bfloat16, device="cuda").eval()
    vae16.load_state_dict(vae32.state_dict())
    convs = (torch.nn.Conv2d, torch.nn.Conv3d)
    convs32 = dict(zip((m for m in vae16.modules() if isinstance(m, convs)),
                       (m for m in vae32.modules() if isinstance(m, convs))))
    planted = {
        "GroupNorm in bf16": ([m for m in vae16.modules() if isinstance(m, GroupNorm)],
                              group_norm_bf16),
        "conv weights left in fp32": (list(convs32),
                                      lambda m, x: convs32[m](x.float()).to(torch.bfloat16))}
    encode = make_svd_encoder(vae16)
    nhwc = lambda z: torch.from_numpy(z.astype(np.float32)).permute(0, 2, 3, 1)  # noqa: E731
    out = {"sound": nhwc(encode(frames))}
    for name, (mods, forward) in planted.items():
        for m in mods:
            m.forward = functools.partial(forward, m)
        try:
            out[name] = nhwc(encode(frames))
        finally:
            for m in mods:
                del m.forward
    out["SVD_SCALE left out"] = out["sound"] / SVD_SCALE
    out["h and w swapped"] = out["sound"].transpose(1, 2)
    return out


def encode_continuous(tmp):
    """Phase 21 (c): the SVD-VAE encoder (the released architecture, seed 0)
    in fp32 on the card and the CPU against an fp64 witness before the
    float16 cast; toyworld at 128² through `make_svd_encoder` (bf16) and
    `encode_episodes`, and the merge; the merged bf16 latents in a window
    against the same witness that planted faults must leave. Returns the
    bf16 encoder and the merged latent video."""
    import torch

    from hma_tpu_torch.data import merge_shards
    from hma_tpu_torch.data.datasets import SVD_SCALE, RawFeatureDataset
    from hma_tpu_torch.data.encode_openx import encode_episodes, make_svd_encoder
    from hma_tpu_torch.data.extern.toyworld import toyworld_episode_generator
    from hma_tpu_torch.tokenizer.image_ops import normalize_image_np
    from hma_tpu_torch.tokenizer.svd_vae import SVDTemporalVAE

    g = torch.Generator("cuda").manual_seed(0)
    vae = SVDTemporalVAE(dtype=torch.float32, device="cuda", generator=g).eval()
    x = torch.from_numpy(normalize_image_np(toyworld_frames(CARD_CPU_FRAMES, 128)))
    t0 = time.perf_counter()
    with torch.no_grad():
        zs = []
        for dtype in (torch.float64, torch.float32):
            cpu = SVDTemporalVAE(dtype=dtype, device="cpu").eval()
            cpu.load_state_dict(vae.state_dict())
            zs.append(cpu.encode(x.to(dtype)) * SVD_SCALE)
        cpu_s = time.perf_counter() - t0
        zg = (vae.encode(x.cuda()) * SVD_SCALE).cpu()
    z64, z32 = zs
    del cpu
    watch = Stopwatch()
    enc = make_svd_encoder(device="cuda")  # bf16, B 32
    timed = watch.wrap("codec", enc)
    from hma_tpu_torch.data import encode_openx

    frames = 0
    with patched(encode_openx, "resize_image", watch.wrap("resize", encode_openx.resize_image)):
        run = timed_episodes(watch, encode_episodes)
        for i in ENCODE_TRAIN_SHARDS:
            meta = run(toyworld_episode_generator(i, ENCODE_NUM_SHARDS, image_size=128),
                       toy_shard(tmp, "vae", i, ENCODE_NUM_SHARDS, "train"), "toyworld",
                       encode_batch=timed, image_size=128)
            frames += meta["num_images"]
    enc_s = watch.secs["episodes"]
    print(f"  (c) make_svd_encoder (bf16, B 32) + encode_episodes, train shards "
          f"{ENCODE_TRAIN_SHARDS} at 128²: {frames} frames in {enc_s:.3f} s, "
          f"{frames / enc_s:.1f} frames/s; {shares(watch, enc_s)}", flush=True)
    encode_episodes(toyworld_episode_generator(0, 48, split="val", image_size=128),
                    toy_shard(tmp, "vae", 0, 48, "val"),
                    "toyworld", encode_batch=enc, image_size=128)
    data = tmp / "data"
    for split, n, shards_ in (("train", ENCODE_NUM_SHARDS, ENCODE_TRAIN_SHARDS),
                              ("val", 48, (0,))):
        merge_shards.merge_shards(
            [toy_shard(tmp, "vae", i, n, split) for i in shards_],
            str(data / f"toyworld_vae_max1000000_{split}"))
    path = data / "toyworld_vae_max1000000_train"
    meta = json.loads((path / "metadata.json").read_text())
    video = np.fromfile(path / "video.bin", np.float16).reshape(-1, 4, 16, 16)
    ds = RawFeatureDataset(path, window_size=12, use_actions=True)
    nhwc = lambda z: torch.from_numpy(np.asarray(z, np.float32)).permute(0, 2, 3, 1)  # noqa: E731
    merged = nhwc(video[:CARD_CPU_FRAMES])
    e32, eg, eb = witness_errors(z64, z32, zg, merged)
    faults = svd_encoder_faults(vae, toyworld_frames(CARD_CPU_FRAMES, 128))
    same = torch.equal(faults.pop("sound"), merged)
    readings = {k: e / e32 for k, e in zip(faults, witness_errors(z64, *faults.values()))}
    del vae
    lo, hi = SVD_BF16_WITNESS_RATIO
    print(f"  SVD-VAE encode x SVD_SCALE against an fp64 witness on the CPU, "
          f"{CARD_CPU_FRAMES} toyworld frames at 128², as max|dz|/max|z| (max|z| "
          f"{float(z64.abs().max()):.3f}): CPU fp32 {e32:.3e}, card fp32 {eg:.3e} "
          f"({eg / e32:.1f} x, limit {FP64_WITNESS_RATIO} x); the bf16 encode's float16 "
          f"latents as merged {eb:.3e} ({eb / e32:.1f} x, window {lo}-{hi} x; the same "
          f"frames encoded alone equal them: {same}); "
          f"faults: " + ", ".join(f"'{k}' {v:.1f} x" for k, v in readings.items())
          + f" (CPU side {cpu_s:.1f} s)", flush=True)
    require(eg <= FP64_WITNESS_RATIO * e32, "SVD-VAE encode card vs the fp64 witness")
    require(lo <= eb / e32 <= hi, "SVD-VAE bf16 encode against the fp64 witness")
    require(same, "the bf16 encoder alone against the merged latents")
    require(lo > FP64_WITNESS_RATIO, "the bf16 window overlaps the fp32 limit")
    for name, r in readings.items():
        require(not lo <= r <= hi, f"the SVD-VAE bf16 window misses the fault '{name}'")
    print(f"  merged: {meta}; the latent dataset reads {len(ds)} windows", flush=True)
    require(meta["latent_channels"] == 4 and meta["h"] == meta["w"] == 16
            and meta["token_dtype"] == "float16" and meta["num_images"] == 640
            and len(ds) > 0 and np.isfinite(video.astype(np.float32)).all(),
            "merged latent dataset")
    return enc, video


def train_cli_timed(argv, n_steps):
    """`train_multi.main(argv)` with each training step timed (the card
    synchronised), its batches' host time (the loader's or the assembler's,
    the copy to the card included), and one loop iteration (step 4's start
    to step 5's) under the profiler. Returns (step cadences s, host batch s
    list, device busy s and wall s of the profiled iteration, and the calls:
    loaders made, native batches and assembler batches)."""
    import torch

    from hma_tpu_torch.train import trainer
    from hma_tpu_torch.train_multi import main as train_main

    starts, batch_secs, prof = [], [], {}
    make_step = trainer.make_train_step

    def make_timed(*a, **kw):
        step = make_step(*a, **kw)

        def run(batch, rng=0):
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            if len(starts) == 5:
                prof["p"].stop()
                prof["wall"] = starts[4] - starts[3]
            if len(starts) == 4:
                prof["p"] = device_profile()
                prof["p"].start()
            out = step(batch, rng)
            torch.cuda.synchronize()
            if len(starts) == n_steps:
                starts.append(time.perf_counter())
            return out
        return run

    watch, calls = Stopwatch(), {"loaders": 0, "native": 0, "assembler": 0}
    make_loaders = trainer.make_native_loaders

    def counted(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    def timed_loaders(*a, **kw):
        made = make_loaders(*a, **kw)
        calls["loaders"] += len(made)
        for ld in made:
            ld.next_batch = watch.wrap("batch", ld.next_batch)
        return made

    call = trainer.BatchAssembler.__call__
    with patched(trainer, "make_train_step", make_timed), \
            patched(trainer, "make_native_loaders", timed_loaders), \
            patched(trainer, "native_batch",
                    counted("native", watch.wrap("batch", trainer.native_batch))), \
            patched(trainer.BatchAssembler, "__call__",
                    counted("assembler", watch.wrap("batch", call))):
        train_main(argv)
    busy = sum(ms for ms, _ in device_times(prof["p"]).values()) / 1e3
    return np.diff(starts), watch.secs["batch"], busy, prof["wall"], calls


def training_from_encoded(tmp, records):
    """Phase 21 (d): train_multi on the merged tokens, the d256 card at full
    width and depth, B 8, 6 steps with the native loader and 6 with the
    assembler; then the continuous family from the merged latents with the
    native loader, the d512 STMAR card at 2 layers."""
    from hma_tpu_torch.config import load_config
    from hma_tpu_torch.train_multi import main as train_main

    (tmp / "split.yaml").write_text("domains: toyworld\n")
    steps = TRAIN_STEPS
    base = ["--train_split", str(tmp / "split.yaml"), "--data_root", str(tmp / "data"),
            "--window_size", "12", "--per_device_train_batch_size", "8",
            "--per_device_eval_batch_size", "8", "--max_eval_steps", "0", "--log_every", "1",
            "--num_warmup_steps", "1", "--device", "cuda"]
    card = str(ROOT / "hma_tpu_torch" / "configs" / "magvit_n32_h8_d256_action.json")
    want = {k: steps * v for k, v in train_launches(32, "transpose").items()}
    for native in (True, False):
        label = "--use_native_loader" if native else "the assembler"
        reset_counts()
        cadence, batch_s, busy, wall, calls = train_cli_timed(
            ["--genie_config", card, "--output_dir", str(tmp / "run"),
             "--max_train_steps", str(steps), *base,
             *(["--use_native_loader"] if native else [])], steps)
        counts = read_counts()
        lines = [json.loads(l) for l in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        losses = [l["train/loss"] for l in lines if "train/loss" in l]
        shutil.rmtree(tmp / "run")
        med = float(np.median(cadence[1:]))
        print(f"  (d) train_multi, d256 card (32 layers), B 8, {steps} steps with {label}: "
              f"step cadence {', '.join(f'{c:.4f}' for c in cadence)} s, median (after the "
              f"first) {med:.4f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; batches on the "
              f"host {steps / batch_s:.1f} /s ({batch_s / steps * 1e3:.2f} ms a batch, the copy "
              f"to the card included); device busy {busy * 1e3:.2f} ms in step 4's iteration, "
              f"{busy / wall:.1%} of its {wall * 1e3:.1f} ms under the profiler, {busy / med:.1%} "
              f"of the median; launches {counts}; batches from {calls}", flush=True)
        require(len(losses) == steps and all(math.isfinite(x) for x in losses),
                f"train_multi {label} losses")
        # the run labelled native took its batches from the loader, the other
        # from the assembler
        want_calls = ({"loaders": 1, "native": steps, "assembler": 0} if native
                      else {"loaders": 0, "native": 0, "assembler": steps})
        require(calls == want_calls, f"train_multi {label} batches {calls}, want {want_calls}")
        require(counts == want, f"train_multi {label} launches {counts}, want {want}")
        set_launches(records, {("K1'", (96, 320, 8, 32)): counts["K1'"],
                               ("K2'", (96, 320, 8, 32)): counts["K2'"],
                               ("K3'", (2560, 12, 8, 32)): counts["K3'"],
                               ("K4'", (2560, 12, 8, 32)): counts["K4'"]}, add=True)

    mcfg = load_config(str(ROOT / "hma_tpu_torch" / "configs" / "mar_n32_h8_d512_action.json"))
    mcfg.num_layers = 2
    mcfg.save_pretrained(str(tmp / "mar2.json"))
    reset_counts()
    train_main(["--genie_config", str(tmp / "mar2.json"), "--model_type", "continuous",
                "--output_dir", str(tmp / "mrun"), "--max_train_steps", "2",
                "--use_native_loader", *base])
    counts = read_counts()
    lines = [json.loads(l) for l in (tmp / "mrun" / "metrics.jsonl").read_text().splitlines()]
    losses = [l["train/loss"] for l in lines if "train/loss" in l]
    shutil.rmtree(tmp / "mrun")
    print(f"  train_multi --model_type continuous --use_native_loader, d512 STMAR card at 2 "
          f"layers, B 8, 2 steps: losses {losses}; launches {counts}", flush=True)
    want = {k: 2 * v for k, v in train_launches(2, "transpose").items()}
    require(len(losses) == 2 and all(math.isfinite(x) for x in losses), "STMAR native losses")
    require(counts == want, f"STMAR native launches {counts}, want {want}")
    set_launches(records, {("K1'", (96, 128, 8, 64)): counts["K1'"],
                           ("K2'", (96, 128, 8, 64)): counts["K2'"],
                           ("K3'", (1024, 12, 8, 64)): counts["K3'"],
                           ("K4'", (1024, 12, 8, 64)): counts["K4'"]}, add=True)


def pixel_prompt_simulators(ckpt, tokens, svd_encode, latents, records):
    """Phase 21 (e): GenieSimulator prompted with 3 uint8 toyworld frames
    through `encode_image`: the d256 card (bf16, full depth) with (a)'s
    encoder, the d512 STMAR card at 2 layers with (c)'s; the prompts equal
    what (a) and (c) wrote for those frames; one step each after a warm-up."""
    import torch

    from hma_tpu_torch.data.datasets import SVD_SCALE
    from hma_tpu_torch.data.encode_openx import make_magvit_encoder
    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.sim.simulator import GenieSimulator
    from hma_tpu_torch.tokenizer.convert import load_magvit2

    H = 3
    encode = make_magvit_encoder(*load_magvit2(str(ckpt)), device="cuda")  # as (a): bf16, B 64
    cfg = flagship_config(40)
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0)).eval()
    moves = np.random.default_rng(0).normal(size=(2, cfg.d_actions[0])).astype(np.float32)
    sim = GenieSimulator(model, prompt_horizon=H, maskgit_steps=2, temperature=0.0,
                         encode_image=lambda f: encode(f[None])[0])
    t0 = time.perf_counter()
    sim.set_initial_state(toyworld_frames(H, 256))
    prompt_ms = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(sim._token_cache, tokens[:H].astype(np.int32))
    sim.step(moves[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = sim.step(moves[1])
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    print(f"  (e) d256 simulator (bf16, 32 layers, B 1) prompted with 3 toyworld frames at 256² "
          f"through encode_image: encode {prompt_ms:.2f} ms, prompt tokens equal (a)'s "
          f"{same}; one step {ms:.2f} ms (model {sim._step_times[-1] * 1e3:.2f} ms), tokens "
          f"{out.shape}; launches {counts}", flush=True)
    require(same, "pixel prompt tokens")
    require(counts["K1'"] == (H + 2 + 1) * cfg.num_layers and out.shape == (16, 16),
            f"pixel-prompted simulator {counts}")
    set_launches(records, {("K1'", (1, 320, 8, 32)): counts["K1'"]}, add=True)
    del sim, model

    mcfg = mar_flagship_config(40)
    mcfg.num_layers = 2
    mar = STMAR(mcfg, dtype=torch.bfloat16, device="cuda",
                generator=torch.Generator("cuda").manual_seed(0)).eval()
    # the prompt in the datasets' convention: the stored latents x SVD_SCALE
    msim = GenieSimulator(
        mar, prompt_horizon=H, maskgit_steps=mcfg.maskgit_steps, temperature=1.0,
        encode_image=lambda f: svd_encode(f[None])[0].transpose(1, 2, 0).astype(np.float32)
        * SVD_SCALE)
    msim.set_initial_state(toyworld_frames(H, 128))
    want = latents[:H].astype(np.float32).transpose(0, 2, 3, 1) * SVD_SCALE
    same = np.array_equal(msim._token_cache, want)
    msim.step(moves[0])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = msim.step(moves[1])
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    print(f"  d512 STMAR simulator (bf16, 2 layers, B 1, {mcfg.maskgit_steps} MaskGIT x "
          f"{mcfg.num_sampling_steps} denoise steps) prompted with 3 toyworld frames at 128²: "
          f"prompt latents equal (c)'s {same}; one step {ms:.2f} ms, latents {out.shape}, "
          f"finite {bool(np.isfinite(out).all())}; launches {counts}", flush=True)
    require(same and np.isfinite(out).all() and out.shape == (16, 16, 4), "STMAR pixel prompt")
    require(counts["K1'"] == (H + mcfg.maskgit_steps + 1) * mcfg.num_layers
            and counts["K6'"] == mcfg.maskgit_steps, f"STMAR pixel-prompted simulator {counts}")
    set_launches(records, {
        ("K1'", (1, mar.seq_len + mcfg.action_token_size, 8, 64)): counts["K1'"],
        ("K6'", (100, 6, mar.patch_dim, mcfg.diffloss_w, mcfg.diffloss_d)): counts["K6'"]},
        add=True)


def encode_pipeline_phase(records):
    """Phase 21: the encode pipeline, the native loader under train_multi and
    the pixel-prompted simulators."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt, tokens = encode_discrete(tmp)
        resize_check()
        torch.cuda.empty_cache()
        svd_encode, latents = encode_continuous(tmp)
        torch.cuda.empty_cache()
        training_from_encoded(tmp, records)
        torch.cuda.empty_cache()
        pixel_prompt_simulators(ckpt, tokens, svd_encode, latents, records)


# Phase 22: the rest of the model and training surface. The d256 card with
# cross-attention action injection and joint action prediction is written
# at run time (JOINT_CARD's fields changed, no other), so the port's configs/
# holds no card that hma_tpu's lacks.
JOINT_CARD = {"action_network": "concat+cross_attention", "jointly_predict_actions": True}
SR_ELEMENTS = 1 << 20  # stochastic rounding, card against CPU, bit for bit


def joint_config(tmp, num_domains: int = 40, num_layers=None):
    """The d256 card with JOINT_CARD's fields, written to `tmp` and read
    back, plus the synthetic action domains."""
    from hma_tpu_torch.config import GenieConfig

    card = json.loads((ROOT / "hma_tpu_torch" / "configs" /
                       "magvit_n32_h8_d256_action.json").read_text())
    path = Path(tmp) / "magvit_n32_h8_d256_joint_cross_attention.json"
    path.write_text(json.dumps({**card, **JOINT_CARD}, indent=1))
    cfg = with_synthetic_domains(GenieConfig.from_pretrained(str(path)), num_domains)
    if num_layers is not None:
        cfg.num_layers = num_layers
    return cfg


def timed_steps(step, batch, label, want, rng0=0):
    """One warm-up step, then TRAIN_STEPS timed ones with the launch counts
    set to 0 just before and read just after: (median s, launches per step,
    peak bytes, the last step's metrics). Every step finite, none skipped,
    the launches `want`'s."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    step(batch, rng=rng0)
    torch.cuda.synchronize()
    reset_counts()
    secs, metrics = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(batch, rng=rng0 + i + 1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    per_step = {k: v / TRAIN_STEPS for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    for m in metrics:
        vals = [m[k].item() for k in ("loss", "grad_norm", "action_loss") if k in m]
        require(all(math.isfinite(x) for x in vals), f"{label}: step not finite: {m}")
        require(m["skipped"].item() == 0.0, f"{label}: a step was skipped")
    require(per_step == want, f"{label}: launches per step {per_step}, want {want}")
    med = sorted(secs)[len(secs) // 2]
    print(f"  {label}: {TRAIN_STEPS} steps {', '.join(f'{t:.4f}' for t in secs)} s, "
          f"median {med:.4f} s; last {', '.join(f'{k} {v.item():.4f}' for k, v in metrics[-1].items())}; "
          f"launches per step {per_step}; peak memory {peak / 2**30:.2f} GiB", flush=True)
    return med, per_step, peak, metrics[-1]


def joint_training(cfg, records, timings):
    """(a) the joint cross-attention d256 card's training step, B 8, bf16."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    B = 8
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                      generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    n_action = sum(p.numel() for n, p in model.named_parameters()
                   if "action_projector" in n or "action_readout" in n)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=stacked_param_mask(model, cfg),
                                      num_domains=cfg.num_domains)
    step = make_train_step(model.train(), tx, action_loss_weight=cfg.action_loss_weight)
    batch = train_batch(cfg, B, "cuda")
    med, per_step, _, last = timed_steps(step, batch, "joint cross-attention d256 step, B 8",
                                         train_launches(cfg.num_layers, "transpose"))
    require("action_loss" in last, "the joint card's step has no action_loss")
    base = timings.get("d256 step")
    tokens = B * cfg.T * cfg.S
    print(f"  {n_params / 1e6:.1f}M params ({n_action / 1e6:.2f}M in the "
          f"cross-attention and the readout); {tokens / med:.1f} tokens/s; phase 6's "
          f"d256 step in this call: "
          f"{'not run' if base is None else f'{base:.4f} s, joint / phase 6 {med / base:.3f}'}",
          flush=True)
    set_launches(records, {("K1'", (B * cfg.T, 320, 8, 32)): per_step["K1'"] * TRAIN_STEPS,
                           ("K2'", (B * cfg.T, 320, 8, 32)): per_step["K2'"] * TRAIN_STEPS,
                           ("K3'", (B * 320, cfg.T, 8, 32)): per_step["K3'"] * TRAIN_STEPS,
                           ("K4'", (B * 320, cfg.T, 8, 32)): per_step["K4'"] * TRAIN_STEPS},
                 add=True)
    profile_run("joint cross-attention d256 step", lambda: step(batch, rng=99), med)


def joint_exactness(cfg2):
    """(a) the 2-layer joint card in fp32, card against CPU: logits,
    action_pred, both losses and every gradient, the action mask handed in;
    then cached = full on the card, and the reference compat's full forward
    and its refusal in frame_logits. Returns the card's fp32 model."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    g = torch.Generator().manual_seed(3)
    host = STMaskGIT(cfg2, dtype=torch.float32, device="cpu", remat=True, generator=g)
    with torch.no_grad():  # wake the zero-init tokens, biases and readout
        for p in host.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    card = STMaskGIT(cfg2, dtype=torch.float32, device="cuda", remat=True)
    card.load_state_dict({k: v.cuda() for k, v in host.state_dict().items()})
    B, T = 2, cfg2.T
    mask = (torch.rand(B, T, 1, 1, generator=g) < 0.5).float()
    mask[0, :, 0, 0] = torch.arange(T) % 2
    outs, grads = [], []
    reset_counts()
    for model, device in ((card, "cuda"), (host, "cpu")):
        b = train_batch(cfg2, B, device)
        am = mask.to(device)
        with torch.no_grad():
            logits, pred = model.compute_logits(b["input_ids"], b["action_ids"], 0, am)
        out = model(b["input_ids"], b["labels"], b["action_ids"], 0, action_mask=am)
        (out["loss"] + cfg2.action_loss_weight * out["action_loss"]).backward()
        outs.append({"logits": logits.cpu(), "action_pred": pred.cpu(),
                     "loss": out["loss"].detach().cpu(),
                     "action_loss": out["action_loss"].detach().cpu()})
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
    counts = read_counts()
    require(all(counts[k] for k in TRAINING_KERNELS), f"the card's pass missed a kernel: {counts}")
    require(grads[0].keys() == grads[1].keys(), "gradient sets differ")
    errs = {k: ((outs[0][k] - outs[1][k]).abs().max() / outs[1][k].abs().max()).item()
            for k in outs[1]}
    worst, worst_name = 0.0, ""
    for n, want in grads[1].items():
        scale = want.abs().max().item()
        err = (grads[0][n] - want).abs().max().item()
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if ratio > worst:
            worst, worst_name = ratio, n
    named = [n for n in grads[1] if "action_projector" in n or "action_readout" in n]
    print(f"  2-layer joint card, B=2, fp32, card vs CPU: max|d|/max|ref| "
          f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol 1e-5); "
          f"{len(grads[1])} gradient tensors ({len(named)} of the cross-attention and "
          f"the readout), worst max|dg|/max|g| {worst:.3e} at {worst_name} "
          f"(tol {GRAD_TOL}); launches {counts}", flush=True)
    # per layer to_q, to_k, to_v, proj (kernel and bias) and the qk-LN's two;
    # the readout's kernel and bias
    require(len(named) == cfg2.num_layers * 7 + 2, f"cross-attention / readout grads {named}")
    require(all(v <= 1e-5 for v in errs.values()), f"card differs from the CPU: {errs}")
    require(worst <= GRAD_TOL, f"gradient {worst_name} differs: {worst:.3e}")

    # cached = full on the card, fp32, B 1, with actions (cross-attention
    # reads every frame's action embedding) and without (the mask tokens)
    card.eval()
    b = train_batch(cfg2, 1, "cuda")
    worst = 0.0
    with torch.no_grad():
        for acts in (b["action_ids"], None):
            full, _ = card.compute_logits(b["labels"], acts, 0)
            k, v = card.init_cache(1, with_actions=acts is not None)
            for t in range(T):
                got, _, _ = card.frame_logits(b["labels"][:, t], t, k, v, acts, 0)
                want = full[:, :, t].reshape(1, 2, -1, cfg2.S).permute(0, 3, 1, 2)
                worst = max(worst, (got - want).abs().max().item())
        ref = STMaskGIT(dataclasses.replace(cfg2, cross_attention_compat="reference"),
                        dtype=torch.float32, device="cuda").eval()
        ref.load_state_dict(card.state_dict())
        ref_logits, ref_pred = ref.compute_logits(b["labels"], b["action_ids"], 0)
        fixed, _ = card.compute_logits(b["labels"], b["action_ids"], 0)
        moved = (ref_logits - fixed).abs().max().item()
        k, v = ref.init_cache(1)
        try:
            ref.frame_logits(b["labels"][:, 0], 0, k, v, b["action_ids"], 0)
            refused = False
        except NotImplementedError:
            refused = True
    print(f"  fp32 frame_logits vs compute_logits on the joint card, {T} frames, with "
          f"and without actions: max abs err {worst:.3e} (tol {EXACT_TOL}); "
          f"compat='reference': full forward finite "
          f"{bool(torch.isfinite(ref_logits).all() and torch.isfinite(ref_pred).all())}, "
          f"{moved:.3e} from the fixed mode's logits, frame_logits refused {refused}",
          flush=True)
    require(math.isfinite(worst) and worst <= EXACT_TOL, "joint card: cached path not exact")
    require(bool(torch.isfinite(ref_logits).all()) and moved > 0 and refused,
            "compat='reference': full forward or cached refusal")


def joint_rollout(cfg, records):
    """(a) the joint card's cached rollout at B 8, full depth, bf16."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.rollout.maskgit import generate_tokens

    B, P, STEPS = 8, 2, 2
    model = STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0)).eval()
    b = train_batch(cfg, B, "cuda")

    def go():
        return generate_tokens(model, b["labels"], P, b["action_ids"], 0,
                               torch.Generator("cuda").manual_seed(1), maskgit_steps=STEPS,
                               temperature=0.0)

    go()  # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = go()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    frames = B * (cfg.T - P)
    want = (P + (cfg.T - P) * (STEPS + 1)) * cfg.num_layers
    print(f"  joint card cached rollout, B {B}, {P} prompt + {cfg.T - P} frames, "
          f"{STEPS} MaskGIT steps: {secs:.4f} s, {frames / secs:.2f} frames/s; "
          f"launches {counts} (K1' want {want})", flush=True)
    require(counts["K1'"] == want and counts["K3'"] == 0, f"joint rollout launches {counts}")
    require(torch.equal(out[:, :P], b["labels"][:, :P]), "joint rollout: prompt changed")
    require(bool(((out >= 0) & (out < cfg.image_vocab_size)).all()),
            "joint rollout: tokens out of range")
    set_launches(records, {("K1'", (B, 320, 8, 32)): counts["K1'"]}, add=True)
    profile_run("joint card cached rollout", go, secs)


def joint_entry(tmp):
    """(a) train_multi --action_network concat+cross_attention --mu_transfer on
    the 2-layer joint card, then generate from its checkpoint."""
    from hma_tpu_torch.config import load_config
    from hma_tpu_torch.train_multi import main as train_main

    cfg = joint_config(tmp, 1, num_layers=2)
    cfg.action_network = "concat+modulate"  # the flag sets it
    data = tmp / "domain_0_magvit_max1000000_train"
    write_dataset(data, cfg, seed=4)
    cfg.save_pretrained(str(tmp / "joint.json"))
    (tmp / "split.yaml").write_text("domains: domain_0\n")
    reset_counts()
    train_main(["--genie_config", str(tmp / "joint.json"), "--output_dir", str(tmp / "run"),
                "--train_split", str(tmp / "split.yaml"), "--data_root", str(tmp),
                "--window_size", str(cfg.T), "--per_device_train_batch_size", "2",
                "--per_device_eval_batch_size", "2", "--max_train_steps", "4",
                "--overfit_first_batch", "--checkpointing_steps", "2",
                "--eval_every_n_steps", "4", "--max_eval_steps", "1", "--log_every", "1",
                "--num_warmup_steps", "1", "--learning_rate", "3e-4",
                "--action_network", "concat+cross_attention", "--mu_transfer"])
    counts = read_counts()
    lines = [json.loads(l) for l in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [(l["train/loss"], l["train/action_loss"]) for l in lines if "train/loss" in l]
    saved = load_config(str(tmp / "run" / "final_checkpt" / "config.json"))
    print(f"  train_multi --action_network concat+cross_attention --mu_transfer: "
          f"{len(losses)} steps, (loss, action_loss) "
          f"{', '.join(f'({a:.4f}, {b:.4f})' for a, b in losses)}; the checkpoint's card: "
          f"{saved.action_network}, use_mup {saved.use_mup}; launches {counts}", flush=True)
    require(len(losses) == 4 and all(math.isfinite(x) for l in losses for x in l),
            "train_multi losses")
    require(saved.action_network == "concat+cross_attention" and saved.use_mup,
            "the checkpoint's card")
    require(all(counts[k] for k in TRAINING_KERNELS), f"train_multi missed a kernel: {counts}")
    check_generate(tmp / "run", data, tmp / "gen", cfg.T, cfg.S, cfg.image_vocab_size)


def lowp_training(records):
    """(b) the d512 STMAR card's B 8 step with fp32 moments and no muP, then
    with muP and bf16 moments (the model rebuilt with use_mup, as
    --mu_transfer builds it), peak memory of each."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import mup_base_model, stacked_param_mask

    B = 8
    base_cfg = mar_flagship_config(40)
    runs = {}
    for label, mup in (("fp32 moments, no muP", False), ("muP + bf16 moments", True)):
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(base_cfg, use_mup=mup)
        model = STMAR(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                      generator=torch.Generator("cuda").manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        kw = {}
        if mup:
            kw = dict(mup_width_mult=cfg.d_model / 256, mup_base=mup_base_model(model, cfg),
                      moment_dtype="bfloat16")
        tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=stacked_param_mask(model, cfg),
                                          num_domains=cfg.num_domains, **kw)
        step = make_train_step(model.train(), tx, continuous=True,
                               action_loss_weight=cfg.action_loss_weight)
        batch = mar_batch(cfg, B, "cuda")
        med, per_step, peak, _ = timed_steps(step, batch, f"d512 STMAR step, {label}",
                                             train_launches(cfg.num_layers, "transpose"))
        dtypes = {t.dtype for t in [*tx.m.values(), *tx.v.values()]}
        matrices = sum(m != 1.0 for m in tx.lr_mult.values())
        print(f"  [{label}] {n_params / 1e6:.1f}M params; moment dtypes {dtypes}; "
              f"{matrices} matrix-like tensors at lr / {kw.get('mup_width_mult', 1)}",
              flush=True)
        require(dtypes == ({torch.bfloat16} if mup else {torch.float32}),
                f"{label}: moment dtypes {dtypes}")
        require((matrices > 0) == mup, f"{label}: {matrices} muP matrices")
        profile_run(f"d512 STMAR step, {label}", lambda: step(batch, rng=99), med)
        S_tot = cfg.S // cfg.patch_size**2 + cfg.action_token_size
        set_launches(records, {("K1'", (B * cfg.T, S_tot, 8, 64)): per_step["K1'"] * TRAIN_STEPS,
                               ("K2'", (B * cfg.T, S_tot, 8, 64)): per_step["K2'"] * TRAIN_STEPS,
                               ("K3'", (B * S_tot, cfg.T, 8, 64)): per_step["K3'"] * TRAIN_STEPS,
                               ("K4'", (B * S_tot, cfg.T, 8, 64)): per_step["K4'"] * TRAIN_STEPS},
                     add=True)
        runs[mup] = (med, peak, n_params)
        del model, tx, step, batch
    (m0, p0, n), (m1, p1, _) = runs[False], runs[True]
    reckoned = n * 2 * 2 / 1e9
    print(f"  muP + bf16 moments against fp32 moments: median step {m1:.4f} / {m0:.4f} s "
          f"({m1 / m0:.3f} x); peak memory {p1 / 1e9:.2f} / {p0 / 1e9:.2f} GB, a fall of "
          f"{(p0 - p1) / 1e9:.2f} GB against {reckoned:.2f} GB reckoned ({n / 1e6:.1f}M "
          f"params x 2 moments x 2 B)", flush=True)
    require(p1 < p0, "bf16 moments did not lower the peak")


def stochastic_round_check():
    """(b) stochastic_round on the card against the CPU, bit for bit, on
    SR_ELEMENTS values across magnitudes with +-0, +-inf and NaNs."""
    import torch

    from hma_tpu_torch.train.lowp import stochastic_round

    g = torch.Generator().manual_seed(5)
    x = torch.randn(SR_ELEMENTS, generator=g) * torch.pow(
        10.0, torch.randint(-30, 30, (SR_ELEMENTS,), generator=g).float())
    x[:10] = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, -math.nan,
                           3.4028235e38, -3.4028235e38, 1e-45, 1.0])
    bits = torch.randint(-2**31, 2**31 - 1, (SR_ELEMENTS,), generator=g, dtype=torch.int32)
    host = stochastic_round(x, bits)
    card = stochastic_round(x.cuda(), bits.cuda()).cpu()
    differ = (host.view(torch.int16) != card.view(torch.int16)).sum().item()
    print(f"  stochastic_round, {SR_ELEMENTS} values with +-0, +-inf, NaN: card vs CPU "
          f"{differ} bf16 patterns differ", flush=True)
    require(differ == 0, "stochastic rounding differs between the card and the CPU")


def lowp_resume(tmp):
    """(b) train_multi --model_type continuous --mu_transfer
    --adam_moment_dtype bfloat16 on the 2-layer d512 STMAR card: a run
    resumed from step 2 ends where the straight one does, bit for bit."""
    import torch

    from hma_tpu_torch.train_multi import main as train_main

    cfg = mar_flagship_config(1)
    cfg.num_layers = 2
    data = tmp / "domain_0_vae_max1000000_train"
    write_latent_dataset(data, cfg, seed=6)
    cfg.save_pretrained(str(tmp / "mar.json"))
    (tmp / "split.yaml").write_text("domains: domain_0\n")

    def run(out, *extra):
        train_main(["--genie_config", str(tmp / "mar.json"), "--model_type", "continuous",
                    "--output_dir", str(out), "--train_split", str(tmp / "split.yaml"),
                    "--data_root", str(tmp), "--window_size", str(cfg.T),
                    "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
                    "--max_train_steps", "4", "--overfit_first_batch",
                    "--checkpointing_steps", "2", "--eval_every_n_steps", "4",
                    "--max_eval_steps", "1", "--log_every", "1", "--num_warmup_steps", "1",
                    "--learning_rate", "3e-4", "--mu_transfer", "--adam_moment_dtype",
                    "bfloat16", *extra])

    reset_counts()
    run(tmp / "straight")
    run(tmp / "resumed", "--resume_from_checkpoint", str(tmp / "straight" / "step_2"))
    counts = read_counts()
    differ, n = [], 0
    for name in ("model.pt", "train_state.pt"):
        a, b = (torch.load(tmp / d / "step_4" / name, map_location="cpu", weights_only=True)
                for d in ("straight", "resumed"))
        if name == "train_state.pt":
            require(a["step"] == b["step"] == 4, "resume steps")
            a, b = ({f"{k}.{p}": t for k in ("m", "v") for p, t in s["opt_state"][k].items()}
                    for s in (a, b))
            require(all(t.dtype == torch.bfloat16 for t in a.values()),
                    "the checkpoint's moments are not bf16")
        require(a.keys() == b.keys(), f"{name}: keys differ")
        n += len(a)
        differ += [k for k in a if not torch.equal(a[k], b[k])]
    print(f"  train_multi --model_type continuous --mu_transfer --adam_moment_dtype "
          f"bfloat16, 2 layers: resumed from step_2 vs straight at step_4, {n} tensors "
          f"(bf16 moments among them), {len(differ)} differ; launches {counts}", flush=True)
    require(not differ, f"resume is not bit for bit: {differ[:5]}")
    require(all(counts[k] for k in TRAINING_KERNELS), f"train_multi missed a kernel: {counts}")


def surface_phase(records, timings):
    """Phase 22: cross-attention action injection, joint action prediction,
    muP and bf16 moments through the kernels."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = joint_config(tmp)
        joint_training(cfg, records, timings)
        torch.cuda.empty_cache()
        joint_exactness(joint_config(tmp, num_layers=2))
        joint_rollout(cfg, records)
        torch.cuda.empty_cache()
        (tmp / "entry").mkdir()
        joint_entry(tmp / "entry")
    torch.cuda.empty_cache()
    lowp_training(records)
    stochastic_round_check()
    with tempfile.TemporaryDirectory() as tmp:
        lowp_resume(Path(tmp))


# ------------------------------------------------------------------ phase 23

SLICED_TOL = 1e-6  # (a) sliced against full grads, 2-layer fp32: max|d| / max|x| a tensor
DP_TOL = 1e-5  # (b) 2 ranks against 1 process: loss relative, grads max|dg| / max|g|
DP_LR = 1e-4


def stacked_grad_bytes(model, mask) -> tuple:
    """(bytes of the stacked tables' fp32 grads at full size, at one row)."""
    params = dict(model.named_parameters())
    names = [n for n, s in mask.items() if s]
    return (sum(params[n].numel() for n in names) * 4,
            sum(params[n][0].numel() for n in names) * 4)


SLICED_STEPS = 3  # timed steps of each kind a card in phase 23 (a)
PROFILE_PAIRS = 12  # --sliced_profile: full/sliced pairs of the d512 fp32-moment step


class HostAccount:
    """Host time of the train step's parts, summed while `on`: the row swap
    (`train/step.domain_rows`, in and out), the optimizer's `step` call (as
    the host sees it) and Python's garbage collector (time, collections)."""

    def __init__(self, step_module, tx):
        import gc

        self.t = {"swap": 0.0, "optimizer": 0.0, "gc": 0.0, "collections": 0}
        self.on, self._gc_t0 = False, 0.0
        rows, update = step_module.domain_rows, tx.step

        @contextlib.contextmanager
        def timed_rows(owners, d):
            with self.timed("swap"):
                cm = rows(owners, d)
                leaves = cm.__enter__()
            try:
                yield leaves
            finally:
                with self.timed("swap"):
                    cm.__exit__(None, None, None)

        def timed_update(*a, **kw):
            with self.timed("optimizer"):
                return update(*a, **kw)

        def on_gc(phase, info):
            if phase == "start":
                self._gc_t0 = time.perf_counter()
            elif self.on:
                self.t["gc"] += time.perf_counter() - self._gc_t0
                self.t["collections"] += 1

        step_module.domain_rows, tx.step = timed_rows, timed_update
        gc.callbacks.append(on_gc)
        self._undo = lambda: (setattr(step_module, "domain_rows", rows),
                              gc.callbacks.remove(on_gc))

    @contextlib.contextmanager
    def timed(self, key):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.on:
                self.t[key] += time.perf_counter() - t0

    def take(self) -> dict:
        """The sums since the last take, then zero."""
        out = dict(self.t)
        self.t = {k: 0 * v for k, v in self.t.items()}
        return out

    def close(self):
        self._undo()


def host_profile(label, go, out_path=None):
    """`go` (two steps) under cProfile: the 14 functions of most own time,
    and the whole table, by cumulative time, in `out_path` where given."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    go()
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
    print(f"  {label}, host profile of two steps (cProfile, own time first):", flush=True)
    for line in text.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            print(f"    {line}", flush=True)
    if out_path is not None:
        full = io.StringIO()
        pstats.Stats(prof, stream=full).sort_stats("cumulative").print_stats()
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(full.getvalue())


def sliced_pair(label, build, batch, continuous, shapes, records, n_steps=SLICED_STEPS,
                host=False, profile_dir=None, **tx_kw):
    """One card's full-width step without and with sliced gradients on one
    model and optimizer, in turns (full, sliced, sliced, full, ...;
    `n_steps` timed steps of each after a warm-up of each), with the launch
    counts set to 0 just before each step and read just after, and the peak
    memory of each step (params and moments included): median s of each
    kind, busy share (a profile of each), peak memory. The launches land in
    phase 3's records at `shapes`. Prints the fall in peak memory beside the
    stacked tables' fp32 grads reckoned. With `host`, also each adjacent
    pair's wall ratio, the host time of the step's parts a step
    (`HostAccount`) and a cProfile of two steps of each kind (the whole
    tables in `profile_dir`, where given)."""
    import torch

    from hma_tpu_torch.train import step as step_module
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    torch.cuda.empty_cache()
    model, cfg = build()
    mask = stacked_param_mask(model, cfg)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=mask,
                                      num_domains=cfg.num_domains, **tx_kw)
    steps = {sliced: make_train_step(model.train(), tx, continuous=continuous,
                                     action_loss_weight=cfg.action_loss_weight,
                                     stacked_mask=mask if sliced else None)
             for sliced in (False, True)}
    want = train_launches(cfg.num_layers, "transpose")
    secs, peaks = {False: [], True: []}, {False: [], True: []}
    parts = {False: [], True: []}  # with `host`: (s to return, HostAccount sums) a step
    account = HostAccount(step_module, tx) if host else None
    for sliced in (False, True):  # warm-up, not counted
        steps[sliced](batch, rng=0)
    order = [False, True, True, False] * (n_steps // 2)
    for i, sliced in enumerate(order):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        if account:
            account.take()
            account.on = True
        t0 = time.perf_counter()
        m = steps[sliced](batch, rng=i + 1)
        returned = time.perf_counter() - t0
        torch.cuda.synchronize()
        secs[sliced].append(time.perf_counter() - t0)
        if account:
            account.on = False
            parts[sliced].append((returned, account.take()))
        peaks[sliced].append(torch.cuda.max_memory_allocated())
        counts = read_counts()
        require(counts == want, f"{label}: launches of a step {counts}, want {want}")
        require(math.isfinite(m["loss"].item()) and m["skipped"].item() == 0.0,
                f"{label}: step not finite or skipped: {m}")
        set_launches(records, {(k, shapes[k]): counts[k] for k in TRAINING_KERNELS},
                     add=True)
    med = {k: sorted(v)[len(v) // 2] for k, v in secs.items()}
    for sliced in (False, True):
        name = f"{label}, {'sliced' if sliced else 'full'} grads"
        print(f"  {name}: steps {', '.join(f'{t:.4f}' for t in secs[sliced])} s, median "
              f"{med[sliced]:.4f} s; peak memory a step "
              f"{', '.join(f'{p / 1e9:.2f}' for p in peaks[sliced])} GB", flush=True)
        if account:
            n = len(parts[sliced])
            mean = lambda k: sum(t[k] for _, t in parts[sliced]) / n
            print(f"  {name}, host a step (mean of {n}): returns after "
                  f"{sum(r for r, _ in parts[sliced]) / n * 1e3:.2f} ms; row swap "
                  f"{mean('swap') * 1e3:.3f} ms, optimizer call {mean('optimizer') * 1e3:.2f} "
                  f"ms, garbage collector {mean('gc') * 1e3:.3f} ms in "
                  f"{mean('collections'):.2f} collections", flush=True)
        profile_run(name, lambda: steps[sliced](batch, rng=99), med[sliced])
    if account:
        account.close()
        # each sliced step against the full step beside it in the ABBA order
        ratios = sorted(b / a - 1 for a, b in zip(secs[False], secs[True]))
        print(f"  {label}: {len(ratios)} adjacent pairs, sliced / full wall - 1: median "
              f"{ratios[len(ratios) // 2]:+.2%}, min {ratios[0]:+.2%}, max {ratios[-1]:+.2%}; "
              f"{', '.join(f'{r:+.2%}' for r in ratios)}", flush=True)
        for sliced in (False, True):
            tag = "sliced" if sliced else "full"
            host_profile(f"{label}, {tag} grads",
                         lambda: [steps[sliced](batch, rng=200 + j) for j in range(2)],
                         profile_dir and Path(profile_dir) / f"host_profile_{tag}.txt")
    full, row = stacked_grad_bytes(model, mask)
    p0, p1 = max(peaks[False]), max(peaks[True])
    print(f"  {label}: sliced against full grads, median step {med[True]:.4f} / "
          f"{med[False]:.4f} s ({med[True] / med[False] - 1:+.2%}); peak memory "
          f"{p1 / 1e9:.2f} / {p0 / 1e9:.2f} GB, a fall of {(p0 - p1) / 1e9:.2f} GB against "
          f"{(full - row) / 1e9:.2f} GB reckoned (the stacked tables' fp32 grads, "
          f"{full / 1e9:.2f} GB full, {row / 1e9:.3f} GB a row)", flush=True)
    require(max(peaks[True]) < min(peaks[False]),
            f"{label}: sliced grads did not lower the peak")
    del model, tx, steps


def sliced_exactness(label, model, batch, continuous, draws=None):
    """(a) a 2-layer fp32 card: one step with sliced grads and one without
    from the same weights and draws; parameters and moments must agree."""
    import copy

    import torch

    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    out = []
    for sliced in (False, True):
        m = copy.deepcopy(model)
        mask = stacked_param_mask(m, m.config)
        tx = make_domain_sliced_optimizer(m, 1e-3, stacked_mask=mask,
                                          num_domains=m.config.num_domains)
        step = make_train_step(m, tx, continuous=continuous,
                               action_loss_weight=m.config.action_loss_weight,
                               stacked_mask=mask if sliced else None)
        metrics = step(batch, rng=5, draws=draws)
        require(metrics["skipped"].item() == 0.0, f"{label}: the step was skipped")
        out.append({"params": dict(m.named_parameters()), "m": tx.m, "v": tx.v})
    worst, where = 0.0, ""
    for what in ("params", "m", "v"):
        for n, want in out[0][what].items():
            scale = want.abs().max().item()
            err = (out[1][what][n] - want).abs().max().item()
            ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            if ratio >= worst:
                worst, where = ratio, f"{what} {n}"
    print(f"  {label}: sliced against full grads after one step, worst max|d|/max|x| "
          f"{worst:.3e} at {where} (tol {SLICED_TOL})", flush=True)
    require(worst <= SLICED_TOL, f"{label}: sliced and full grads differ: {worst:.3e}")


def d512_sliced_case(B=8):
    """(config, K1'-K4' shapes of its step, batch on the card) of phase 23
    (a)'s d512 STMAR step."""
    cfg = mar_flagship_config(40)
    S_tot = cfg.S // cfg.patch_size**2 + cfg.action_token_size
    shapes = {"K1'": (B * cfg.T, S_tot, 8, 64), "K2'": (B * cfg.T, S_tot, 8, 64),
              "K3'": (B * S_tot, cfg.T, 8, 64), "K4'": (B * S_tot, cfg.T, 8, 64)}
    return cfg, shapes, mar_batch(cfg, B, "cuda")


def sliced_profile(profile_dir=None) -> int:
    """`--sliced_profile`: phase 23 (a)'s d512 STMAR step with fp32 moments,
    PROFILE_PAIRS full/sliced pairs on one model, with the host's accounting
    and a cProfile of each kind (`sliced_pair(host=True)`), the whole tables
    in `profile_dir` where given; the kernels are built on first use."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR

    print(nvidia_smi_line(), flush=True)
    cfg, shapes, batch = d512_sliced_case()
    t0 = time.perf_counter()
    sliced_pair("d512 STMAR step, fp32 moments",
                lambda: (STMAR(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                               generator=torch.Generator("cuda").manual_seed(0)), cfg),
                batch, True, shapes, [], n_steps=PROFILE_PAIRS, host=True,
                profile_dir=profile_dir)
    print(f"sliced profile: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def sliced_grads_phase(records):
    """(a) sliced gradients on the card."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.models.st_mask_git import STMaskGIT
    from hma_tpu_torch.train.trainer import mup_base_model

    B = 8
    mar_cfg, mar_shapes, mar_b = d512_sliced_case(B)
    for label, mup in (("d512 STMAR step, fp32 moments", False),
                       ("d512 STMAR step, muP + bf16 moments", True)):
        cfg = dataclasses.replace(mar_cfg, use_mup=mup)

        def build(cfg=cfg):
            return STMAR(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                         generator=torch.Generator("cuda").manual_seed(0)), cfg

        kw = {}
        if mup:
            kw = dict(mup_width_mult=cfg.d_model / 256, moment_dtype="bfloat16",
                      mup_base=mup_base_model(STMAR(cfg, dtype=torch.bfloat16, device="meta"),
                                              cfg))
        sliced_pair(label, build, mar_b, True, mar_shapes, records, **kw)
    del mar_b
    cfg = flagship_config(40)
    d256_shapes = {"K1'": (B * cfg.T, 320, 8, 32), "K2'": (B * cfg.T, 320, 8, 32),
                   "K3'": (B * 320, cfg.T, 8, 32), "K4'": (B * 320, cfg.T, 8, 32)}

    def build256():
        return STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                         generator=torch.Generator("cuda").manual_seed(0)), cfg

    sliced_pair("d256 step, fp32 moments", build256, train_batch(cfg, B, "cuda"), False,
                d256_shapes, records)

    # exactness on the 2-layer fp32 cards, both families (STMAR's dropout live)
    torch.cuda.empty_cache()
    small = flagship_config(40)
    small.num_layers = 2
    model = STMaskGIT(small, dtype=torch.float32, device="cuda", remat=True,
                      generator=torch.Generator("cuda").manual_seed(3))
    batch = train_batch(small, 2, "cuda")
    batch["domain_id"] = 5
    sliced_exactness("2-layer d256, fp32, domain 5", model, batch, False)
    small = mar_flagship_config(40)
    small.num_layers = 2
    model = STMAR(small, dtype=torch.float32, device="cuda", remat=True,
                  generator=torch.Generator("cuda").manual_seed(3))
    with torch.no_grad():  # wake the zero-init heads and tokens
        g = torch.Generator("cuda").manual_seed(4)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    batch = mar_batch(small, 2, "cuda")
    batch["domain_id"] = 5
    sliced_exactness("2-layer d512 STMAR, fp32, domain 5", model, batch, True)


def write_dp_case(tmp) -> None:
    """(b)'s case, written once for every process: the 2-layer d256 card (40
    domains, seed 3) and a B 8 batch whose halves hold unequal masked counts
    (half of each frame 1.. in rows 0-3, three quarters in rows 4-7),
    domain 5."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    cfg = flagship_config(40)
    cfg.num_layers = 2
    model = STMaskGIT(cfg, dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    batch = train_batch(cfg, 8, "cpu")
    batch["input_ids"][4:, 1:, : 3 * cfg.S // 4] = cfg.image_vocab_size
    batch["domain_id"] = 5
    torch.save({"state": model.state_dict(), "batch": batch}, Path(tmp) / "dp_case.pt")


def load_dp_case(tmp):
    """(model in fp32 on the card, batch on the card) of `write_dp_case`."""
    import torch

    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    cfg = flagship_config(40)
    cfg.num_layers = 2
    case = torch.load(Path(tmp) / "dp_case.pt", weights_only=False)
    model = STMaskGIT(cfg, dtype=torch.float32, device="cuda", remat=True)
    model.load_state_dict(case["state"])
    return model, {k: (v.cuda() if torch.is_tensor(v) else v)
                   for k, v in case["batch"].items()}


def dp_step(model, batch, group=None):
    """One sliced-gradient step (the sliced AdamW) on `batch` — with
    `group`, on this rank's rows — capturing the grads the optimizer gets:
    (loss, {name: grad}, {name: param after the step})."""
    import torch

    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    mask = stacked_param_mask(model, model.config)
    tx = make_domain_sliced_optimizer(model, DP_LR, stacked_mask=mask,
                                      num_domains=model.config.num_domains)
    seen = {}
    update = tx.step

    def spy(params, grads, d, ok, noise=None):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return update(params, grads, d, ok, noise)

    tx.step = spy
    if group is not None:
        B = batch["input_ids"].shape[0]
        rank, world = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
        rows = slice(rank * B // world, (rank + 1) * B // world)
        batch = {k: (v[rows] if torch.is_tensor(v) else v) for k, v in batch.items()}
    step = make_train_step(model, tx, stacked_mask=mask, group=group)
    metrics = step(batch)
    return (metrics["loss"].item(), seen,
            {n: p.detach().clone() for n, p in model.named_parameters()})


def dp_worker(spec: str) -> int:
    """A rank of (b): joins a gloo group over the card's CUDA tensors,
    takes one step on its rows, saves what it saw."""
    import torch

    rank, world, port, tmp = json.loads(spec)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    reset_counts()
    model, batch = load_dp_case(tmp)
    loss, grads, params = dp_step(model, batch, torch.distributed.group.WORLD)
    counts = read_counts()
    torch.save({"loss": loss, "grads": {n: g.cpu() for n, g in grads.items()},
                "params": {n: p.cpu() for n, p in params.items()}, "counts": counts},
               Path(tmp) / f"dp_rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def data_parallel_phase(tmp):
    """(b) the dp path on one card: 2 gloo ranks against 1 process, and
    beside them a 1-rank NCCL group through train_multi."""
    import torch

    write_dp_case(tmp)
    port = free_port()
    nccl = start_nccl_train_multi(Path(tmp) / "nccl")  # runs beside the gloo ranks
    procs = [nccl[0]]
    try:
        procs += [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                    "--dp_worker", json.dumps([r, 2, port, str(tmp)])],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for r in range(2)]
        t0 = time.perf_counter()
        model, batch = load_dp_case(tmp)
        reset_counts()
        loss, grads, params = dp_step(model, batch)
        counts = read_counts()
        outs = [p.communicate(timeout=300)[0] for p in procs[1:]]
        gloo_secs = time.perf_counter() - t0
        check_nccl_train_multi(*nccl)
    finally:  # every process this phase started ends with it
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs[1:], outs)):
        require(p.returncode == 0, f"dp rank {r} failed:\n{out[-4000:]}")
    ranks = [torch.load(Path(tmp) / f"dp_rank{r}.pt", weights_only=True) for r in range(2)]
    loss_err = max(abs(r["loss"] - loss) / abs(loss) for r in ranks)
    worst, where = 0.0, ""
    for n, want in grads.items():
        scale = want.abs().max().item()
        err = (ranks[0]["grads"][n] - want.cpu()).abs().max().item()
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if ratio >= worst:
            worst, where = ratio, n
    same = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in params)
    print(f"  2 gloo ranks on one card (CUDA tensors), 2-layer d256, B 8 (4 a rank, "
          f"unequal masked counts), fp32, one sliced-grad step: loss {ranks[0]['loss']:.6f} "
          f"against 1 process {loss:.6f} (rel err {loss_err:.3e}, tol {DP_TOL}); "
          f"{len(grads)} grads, worst max|dg|/max|g| {worst:.3e} at {where} (tol {DP_TOL}); "
          f"the ranks' params after the step equal bit for bit: {same}; launches a rank "
          f"{[r['counts'] for r in ranks]}, 1 process {counts}; {gloo_secs:.1f} s",
          flush=True)
    require(loss_err <= DP_TOL, "2 ranks' loss differs from 1 process's")
    require(worst <= DP_TOL, f"2 ranks' grad {where} differs: {worst:.3e}")
    require(same, "the ranks' params differ after the step")
    require(all(r["counts"][k] for r in ranks for k in TRAINING_KERNELS),
            "a rank missed a kernel")


def start_nccl_train_multi(root, *extra):
    """(b) `python -m hma_tpu_torch.train_multi` under torchrun's variables,
    a 1-rank NCCL group, on a 2-domain synthetic set of the 2-layer d256
    card, started in the background, with the flags `extra` last: (process,
    root, start time)."""
    import os

    cfg = flagship_config(2)
    cfg.num_layers = 2
    for d in cfg.action_domains:
        write_domain_dataset(root / f"{d}_magvit_max1000000_train", cfg, d, seed=7)
    cfg.save_pretrained(str(root / "config.json"))
    (root / "split.yaml").write_text(f"domains: {','.join(cfg.action_domains)}\n")
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    proc = subprocess.Popen(
        [sys.executable, "-m", "hma_tpu_torch.train_multi", "--genie_config",
         str(root / "config.json"), "--output_dir", str(root / "run"), "--train_split",
         str(root / "split.yaml"), "--data_root", str(root), "--window_size", str(cfg.T),
         "--per_device_train_batch_size", "4", "--max_train_steps", "4",
         "--overfit_first_batch", "--checkpointing_steps", "2", "--eval_every_n_steps", "4",
         "--max_eval_steps", "1", "--log_every", "1", "--num_warmup_steps", "1",
         "--learning_rate", "3e-4", *extra],
        cwd=str(ROOT), env=env, stdout=(root / "log.txt").open("w"),
        stderr=subprocess.STDOUT)
    return proc, root, time.perf_counter()


def check_nccl_train_multi(proc, root, t0):
    proc.wait(timeout=300)
    out = (root / "log.txt").read_text()
    require(proc.returncode == 0, f"train_multi under a 1-rank NCCL group failed:\n"
            f"{out[-6000:]}")
    lines = [json.loads(l) for l in (root / "run" / "metrics.jsonl").read_text().splitlines()]
    conf = lines[0]["_config"]
    losses = [l["train/loss"] for l in lines if "train/loss" in l]
    print(f"  train_multi, 1-rank NCCL group (torchrun's variables), 2-layer d256, 2 "
          f"domains, B 4: process group {conf['process_group']}, world {conf['world_size']}, "
          f"sliced grads {conf['sliced_grads_active']}, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; {time.perf_counter() - t0:.1f} s "
          "(beside the gloo ranks)", flush=True)
    require(conf["process_group"] == "nccl" and conf["world_size"] == 1,
            "train_multi did not run in the NCCL group")
    require(len(losses) == 4 and all(math.isfinite(x) for x in losses),
            "train_multi losses under NCCL")
    require((root / "run" / "final_checkpt" / "train_state.pt").is_file(),
            "no final checkpoint under NCCL")


def write_domain_dataset(path, cfg, domain, seed):
    """A synthetic 40-frame token dataset named `domain`, with its actions."""
    from hma_tpu_torch.data.datasets import write_token_dataset

    rng = np.random.default_rng(seed)
    n, side = 40, math.isqrt(cfg.S)
    d = cfg.action_domains.index(domain)
    write_token_dataset(
        path, rng.integers(0, cfg.image_vocab_size, (n, side, side)).astype(np.uint32),
        np.repeat(np.arange(n // 20), 20),
        rng.normal(size=(n, cfg.d_actions[d])).astype(np.float32),
        {"name": domain, "vocab_size": cfg.image_vocab_size})


def sliced_dp_phase(records):
    """Phase 23: sliced gradients (a) and the data-parallel path (b)."""
    sliced_grads_phase(records)
    with tempfile.TemporaryDirectory() as tmp:
        data_parallel_phase(tmp)


# ------------------------------------------------------------------ phase 24

FSDP_TOL = 1e-6  # (a) 2-layer fp32 cards: FSDP2 against unwrapped, max|d| / max|x| a tensor
FSDP_STEPS = 3  # (a) timed steps of each kind after one warm-up, full-width cards


def one_rank_mesh():
    """A 1-rank NCCL process group in this process, its address and rank
    given here, and its (dp 1, fsdp 1) mesh."""
    import torch

    from hma_tpu_torch.parallel.mesh import make_mesh

    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
        device_id=torch.device("cuda", 0))
    return make_mesh(fsdp=1)


def fsdp_steps(build, batch, continuous, mesh, n_steps, want=None, **tx_kw):
    """`build()`'s model, sharded by FSDP2 over `mesh` (None: unwrapped),
    with the domain-sliced AdamW and full grads: one warm-up step, then
    `n_steps` timed, the launch counts set to 0 just before each and read
    just after. ({"losses" (warm-up first), "secs", "peaks", "counts"},
    model, optimizer)."""
    import gc

    import torch

    from hma_tpu_torch.parallel.mesh import data_group, shard_model
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    gc.collect()  # the model before, FSDP2's cycles included, off the card
    torch.cuda.empty_cache()
    model, cfg = build()
    mask = stacked_param_mask(model, cfg)
    if mesh is not None:
        shard_model(model, mesh)
    tx = make_domain_sliced_optimizer(model, 1e-4, stacked_mask=mask,
                                      num_domains=cfg.num_domains, **tx_kw)
    step = make_train_step(model.train(), tx, continuous=continuous,
                           action_loss_weight=cfg.action_loss_weight,
                           group=None if mesh is None else data_group(mesh))
    out = {"losses": [], "secs": [], "peaks": [], "counts": []}
    for i in range(n_steps + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m = step(batch, rng=i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        require(math.isfinite(m["loss"].item()) and m["skipped"].item() == 0.0,
                f"step not finite or skipped: {m}")
        require(want is None or counts == want, f"launches of a step {counts}, want {want}")
        out["losses"].append(m["loss"].item())
        if i:
            out["secs"].append(secs)
            out["peaks"].append(torch.cuda.max_memory_allocated())
            out["counts"].append(counts)
    return out, model, tx


def fsdp_full_width(label, build, layers, batch, continuous, mesh, shapes, records,
                    **tx_kw):
    """(a) one full-width card: the unwrapped step, then the FSDP2 step from
    the same weights (`build` draws them from a seed) on the same batch and
    draws; the first step's loss must agree bit for bit. Launches land in
    phase 3's records. Returns the FSDP2 model."""
    import torch

    want = train_launches(layers, "transpose")
    runs = {}
    for kind in ("unwrapped", "FSDP2"):
        runs[kind], model, tx = fsdp_steps(build, batch, continuous,
                                           mesh if kind == "FSDP2" else None, FSDP_STEPS,
                                           want, **tx_kw)
        for counts in runs[kind]["counts"]:
            set_launches(records, {(k, shapes[k]): counts[k] for k in TRAINING_KERNELS},
                         add=True)
        if kind == "unwrapped":
            del model, tx
    med = {k: sorted(r["secs"])[len(r["secs"]) // 2] for k, r in runs.items()}
    peak = {k: max(r["peaks"]) for k, r in runs.items()}
    for kind, r in runs.items():
        print(f"  {label}, {kind}: losses {', '.join(f'{x:.6f}' for x in r['losses'])}; "
              f"steps {', '.join(f'{t:.4f}' for t in r['secs'])} s, median {med[kind]:.4f} "
              f"s; peak memory {', '.join(f'{p / 1e9:.2f}' for p in r['peaks'])} GB",
              flush=True)
    print(f"  {label}: FSDP2 / unwrapped median step {med['FSDP2'] / med['unwrapped'] - 1:+.2%}"
          f", peak {peak['FSDP2'] / 1e9:.2f} / {peak['unwrapped'] / 1e9:.2f} GB "
          f"({(peak['FSDP2'] - peak['unwrapped']) / 1e9:+.2f} GB); launches a step "
          f"{runs['FSDP2']['counts'][0]}", flush=True)
    require(runs["FSDP2"]["losses"][0] == runs["unwrapped"]["losses"][0],
            f"{label}: the first step's loss differs under FSDP2")
    del tx
    return model


def fsdp_exactness(label, model, batch, continuous, mesh, ckpt_root=None):
    """(a) a 2-layer fp32 card: 2 steps unwrapped and 2 under FSDP2 from the
    same weights; parameters and moments (gathered whole) within FSDP_TOL.
    With `ckpt_root`, the FSDP2 run's training checkpoint is written there
    as the trainer writes it (gathered, then saved) and read back into one
    unwrapped process, bit for bit."""
    import copy

    import torch

    from hma_tpu_torch.parallel.mesh import full
    from hma_tpu_torch.utils.checkpoint import gather_state, load_checkpoint, save_checkpoint

    out = {}
    for kind in ("unwrapped", "FSDP2"):
        run, m, tx = fsdp_steps(lambda: (copy.deepcopy(model), model.config), batch,
                                continuous, mesh if kind == "FSDP2" else None, 1)
        out[kind] = {"params": {n: full(p.detach()) for n, p in m.named_parameters()},
                     "m": {n: full(x) for n, x in tx.m.items()},
                     "v": {n: full(x) for n, x in tx.v.items()}, "losses": run["losses"]}
    worst, where = 0.0, ""
    for what in ("params", "m", "v"):
        for n, want in out["unwrapped"][what].items():
            scale = want.abs().max().item()
            err = (out["FSDP2"][what][n] - want).abs().max().item()
            ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            if ratio >= worst:
                worst, where = ratio, f"{what} {n}"
    print(f"  {label}: FSDP2 against unwrapped after 2 steps, losses "
          f"{out['FSDP2']['losses']} / {out['unwrapped']['losses']}, worst max|d|/max|x| "
          f"{worst:.3e} at {where} (tol {FSDP_TOL})", flush=True)
    require(worst <= FSDP_TOL, f"{label}: FSDP2 and unwrapped differ: {worst:.3e}")
    if ckpt_root is None:
        return
    state, opt = gather_state(m.state_dict()), gather_state(tx.state_dict())
    path = save_checkpoint(str(ckpt_root), "step_2", state, m.config, opt_state=opt, step=2)
    one, _ = load_checkpoint(path, "cuda", dtype=torch.float32)
    same = all(torch.equal(v, state[k]) for k, v in one.state_dict().items())
    print(f"  {label}: the FSDP2 run's checkpoint (gathered) read into one unwrapped "
          f"model equals it bit for bit: {same}", flush=True)
    require(same and set(one.state_dict()) == set(state),
            f"{label}: the FSDP2 checkpoint does not load into one process")


def fsdp_sampling(label, model, cfg):
    """(a) one STMAR sampling call of the FSDP2-sharded model (K6' on the
    head gathered whole) against an unwrapped copy of its weights: the same
    tokens bit for bit, one K6' launch."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.utils.checkpoint import gather_state

    plain = STMAR(cfg, dtype=torch.bfloat16, device="cuda")
    plain.load_state_dict(gather_state(model.state_dict()))
    z = torch.randn(48, cfg.d_model, generator=torch.Generator("cuda").manual_seed(9),
                    device="cuda")
    got = []
    for m in (model, plain, model):  # the second sharded call reads no stale buffers
        reset_counts()
        with torch.no_grad():
            got.append(m.eval().sample_tokens(z, torch.Generator("cuda").manual_seed(10)))
        counts = read_counts()
        require(counts["K6'"] == 1, f"{label}: K6' launches {counts}")
    same = torch.equal(got[0], got[1]) and torch.equal(got[2], got[1])
    print(f"  {label}: sample_tokens (N 48, K 100) through K6' on the gathered head equals "
          f"the unwrapped model's bit for bit: {same}", flush=True)
    require(same, f"{label}: FSDP2 sampling differs")
    del plain


def fsdp_dp_step(model, batch, mask, group=None):
    """One full-grad step of the domain-sliced AdamW (`mask` found before
    any sharding) on `batch` (with `group`, on this rank's rows), capturing
    this rank's shard of each grad the optimizer gets and its index in the
    whole: (loss, {name: (grad shard, index)}, optimizer). Nothing is
    gathered: DTensor's gather (functional collectives) crashes over gloo
    on CUDA tensors, where c10d's collectives, FSDP2's, work."""
    import torch

    from hma_tpu_torch.parallel.mesh import local, shard_slices
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step

    tx = make_domain_sliced_optimizer(model, DP_LR, stacked_mask=mask,
                                      num_domains=model.config.num_domains)
    seen = {}
    update = tx.step

    def spy(params, grads, d, ok, noise=None):
        seen.update({n: (local(g).detach().cpu().clone(),
                         tuple((s.start, s.stop) for s in shard_slices(g)))
                     for n, g in grads.items()})
        return update(params, grads, d, ok, noise)

    tx.step = spy
    if group is not None:
        B = batch["input_ids"].shape[0]
        rank, world = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
        rows = slice(rank * B // world, (rank + 1) * B // world)
        batch = {k: (v[rows] if torch.is_tensor(v) else v) for k, v in batch.items()}
    metrics = make_train_step(model, tx, group=group)(batch)
    return metrics["loss"].item(), seen, tx


def fsdp_worker(spec: str) -> int:
    """A rank of (b): a gloo group over the card's CUDA tensors, a (dp 1,
    fsdp 2) CUDA mesh, phase 23 (b)'s 2-layer d256 case sharded by FSDP2,
    one step on its rows; saves the loss, its shards of the grads and the
    bytes of its shards of the parameters and of the moments."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from hma_tpu_torch.parallel.mesh import AXES, local, shard_model
    from hma_tpu_torch.train.trainer import stacked_param_mask

    rank, world, port, tmp = json.loads(spec)
    torch.cuda.set_device(0)  # both ranks share the one card
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    mesh = init_device_mesh("cuda", (1, world, 1, 1), mesh_dim_names=AXES)
    model, batch = load_dp_case(tmp)
    mask = stacked_param_mask(model, model.config)
    shard_model(model, mesh)
    loss, grads, tx = fsdp_dp_step(model, batch, mask, torch.distributed.group.WORLD)
    nbytes = lambda ts: sum(local(t).numel() * local(t).element_size() for t in ts)
    torch.save({"loss": loss, "grads": grads,
                "bytes": (nbytes(model.parameters()),
                          nbytes([*tx.m.values(), *tx.v.values()]))},
               Path(tmp) / f"fsdp_rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def fsdp_two_ranks(tmp):
    """(b) fsdp 2 on the one card: two gloo ranks (this script started twice
    with --fsdp_worker) against one unwrapped process on the whole batch."""
    import torch

    from hma_tpu_torch.train.trainer import stacked_param_mask

    write_dp_case(tmp)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--fsdp_worker", json.dumps([r, 2, port, str(tmp)])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        model, batch = load_dp_case(tmp)
        loss, grads, tx = fsdp_dp_step(model, batch, stacked_param_mask(model, model.config))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"fsdp rank {r} failed (exit {p.returncode}):\n"
                f"{out[-12000:]}")
    ranks = [torch.load(Path(tmp) / f"fsdp_rank{r}.pt", weights_only=True) for r in range(2)]
    loss_err = max(abs(r["loss"] - loss) / abs(loss) for r in ranks)
    worst, where = 0.0, ""
    for n, (want, _) in grads.items():
        scale = want.abs().max().item()
        for r in ranks:  # each rank's shard against its part of the whole
            got, index = r["grads"][n]
            part = want[tuple(slice(a, b) for a, b in index)]
            err = (got - part).abs().max().item() if got.numel() else 0.0
            ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            if ratio >= worst:
                worst, where = ratio, n
    whole = (sum(p.numel() * 4 for p in model.parameters()),
             sum(x.numel() * x.element_size() for x in [*tx.m.values(), *tx.v.values()]))
    print(f"  fsdp 2: 2 gloo ranks on one card (CUDA tensors, FSDP2), 2-layer d256, B 8 "
          f"(4 a rank, unequal masked counts), fp32, one full-grad step: loss "
          f"{ranks[0]['loss']:.6f} against 1 process {loss:.6f} (rel err {loss_err:.3e}, "
          f"tol {DP_TOL}); {len(grads)} grads, worst max|dg|/max|g| {worst:.3e} at {where} "
          f"(tol {DP_TOL}); bytes of parameters / moments a rank "
          f"{[r['bytes'] for r in ranks]}, 1 process {whole}", flush=True)
    require(loss_err <= DP_TOL, "fsdp 2's loss differs from 1 process's")
    require(worst <= DP_TOL, f"fsdp 2's grad {where} differs: {worst:.3e}")
    require(all(2 * r["bytes"][k] <= whole[k] * 1.01 for r in ranks for k in (0, 1)),
            "a rank holds more than its half of the state")


def fsdp_phase(records):
    """Phase 24: fsdp, (a) FSDP2 over a 1-rank NCCL mesh in this process,
    (b) fsdp 2 over two gloo ranks sharing the card, (c) train_multi --fsdp
    1 in a 1-rank NCCL group resumed from (a)'s FSDP2 checkpoint."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    mesh = one_rank_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        small = flagship_config(2)  # (c)'s card
        small.num_layers = 2
        model = STMaskGIT(small, dtype=torch.float32, device="cuda", remat=True,
                          generator=torch.Generator("cuda").manual_seed(3))
        batch = train_batch(small, 2, "cuda")
        batch["domain_id"] = 1
        fsdp_exactness("2-layer d256, fp32, 2 domains, domain 1", model, batch, False, mesh,
                       tmp / "ckpt")
        small = mar_flagship_config(40)
        small.num_layers = 2
        model = STMAR(small, dtype=torch.float32, device="cuda", remat=True,
                      generator=torch.Generator("cuda").manual_seed(3))
        with torch.no_grad():  # wake the zero-init heads and tokens
            g = torch.Generator("cuda").manual_seed(4)
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
        batch = mar_batch(small, 2, "cuda")
        batch["domain_id"] = 5
        fsdp_exactness("2-layer d512 STMAR, fp32, domain 5", model, batch, True, mesh)
        del model, batch

        mar_cfg, mar_shapes, mar_b = d512_sliced_case(8)

        def build512():
            return STMAR(mar_cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                         generator=torch.Generator("cuda").manual_seed(0)), mar_cfg

        layers = mar_cfg.num_layers
        fsdp_full_width("d512 STMAR step, fp32 moments", build512, layers, mar_b, True, mesh,
                        mar_shapes, records)
        model = fsdp_full_width("d512 STMAR step, bf16 moments", build512, layers, mar_b, True,
                                mesh, mar_shapes, records, moment_dtype="bfloat16")
        fsdp_sampling("d512 STMAR, FSDP2", model, mar_cfg)
        del model, mar_b
        cfg = flagship_config(40)
        shapes = {"K1'": (8 * cfg.T, 320, 8, 32), "K2'": (8 * cfg.T, 320, 8, 32),
                  "K3'": (8 * 320, cfg.T, 8, 32), "K4'": (8 * 320, cfg.T, 8, 32)}
        fsdp_full_width("d256 step, fp32 moments",
                        lambda: (STMaskGIT(cfg, dtype=torch.bfloat16, device="cuda", remat=True,
                                           generator=torch.Generator("cuda").manual_seed(0)),
                                 cfg), cfg.num_layers, train_batch(cfg, 8, "cuda"), False, mesh,
                        shapes, records)
        torch.cuda.empty_cache()

        nccl = start_nccl_train_multi(tmp / "nccl", "--fsdp", "1", "--resume_from_checkpoint",
                                      str(tmp / "ckpt" / "step_2"), "--max_train_steps", "6")
        try:  # (c) beside (b)
            fsdp_two_ranks(tmp)
            check_nccl_train_multi(*nccl)
        finally:
            nccl[0].kill()
        steps = [json.loads(l).get("_step") for l in
                 (tmp / "nccl" / "run" / "metrics.jsonl").read_text().splitlines()
                 if "train/loss" in l]
        print(f"  train_multi --fsdp 1 resumed from the FSDP2 run's step-2 checkpoint: "
              f"steps {steps}", flush=True)
        require(steps == [3, 4, 5, 6], "train_multi did not resume from the FSDP2 checkpoint")
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 25: tensor parallelism (tp) on gloo ranks sharing the card

TP_LAYERS = {"d256": 4, "d512": 2}  # (a), (b): the full-width cards cut to this depth
TP_BF16_TOL = 5e-2  # (a), (b) bf16 steps: loss relative, grads max|dg| / max|g| a tensor
TP_FP32_TOL = 1e-3  # (b) fp32 MAR rollout: max |d latent| / max |latent|
TP_TOKEN_SHARE = 0.99  # (a) fp32 greedy rollout: least share of tokens equal to one process's
TP_MAR_STEPS = 2  # (b) MaskGIT steps of the MAR rollout's one frame
TP_ONE = {}  # one process's runs of (a) and (b), made once for phases 25 and 26
SP_RANKS = 2  # phase 26: sequence-parallel ranks sharing the card
EXCHANGE_REPS = 20  # phase 26: timed calls of each direction of the spatial exchange


def tp_model(case, dtype, state):
    """(a)'s d256 or (b)'s d512 STMAR card at TP_LAYERS, in `dtype`, with
    `state`'s weights; (b) in the resident layout."""
    import torch

    from hma_tpu_torch.models.st_mar import STMAR
    from hma_tpu_torch.models.st_mask_git import STMaskGIT

    if case == "d256":
        cfg = flagship_config(40)
        cfg.num_layers = TP_LAYERS[case]
        model = STMaskGIT(cfg, dtype=dtype, device="cuda", remat=True)
    else:
        cfg = mar_flagship_config(40)
        cfg.num_layers = TP_LAYERS[case]
        model = STMAR(cfg, dtype=dtype, device="cuda", remat=True, temporal_layout="resident")
    if state is not None:
        model.load_state_dict(state)
    return model


def write_tp_cases(tmp) -> None:
    """(a)'s and (b)'s cases, written once for every process: seeded weights
    (the d512 heads and zero-init tokens woken by noise), the step's batch
    (B 8, domain 5), the rollouts' prompts and the MAR rollout's draws."""
    import torch

    from hma_tpu_torch.rollout.mar import mar_subset_schedule

    out = {}
    for case, seed in (("d256", 5), ("d512", 6)):
        model = tp_model(case, torch.float32, None)
        model.reset_parameters(torch.Generator("cuda").manual_seed(seed))
        cfg = model.config
        with torch.no_grad():
            g = torch.Generator("cuda").manual_seed(seed + 1)
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
        batch = (train_batch if case == "d256" else mar_batch)(cfg, 8, "cpu")
        batch["domain_id"] = 5
        if case == "d256":
            roll = {"tokens": batch["labels"].clone(),
                    "actions": batch["action_ids"].clone()}
        else:
            B, S, C = 2, model.seq_len, model.patch_dim
            _, counts = mar_subset_schedule(S, TP_MAR_STEPS)
            rows, K = B * max(counts), int(cfg.num_sampling_steps)
            g = torch.Generator().manual_seed(7)
            roll = {"latents": batch["input_ids"][:B].clone(),
                    "actions": batch["action_ids"][:B].clone(),
                    "draws": {"orders": torch.stack([torch.randperm(S, generator=g)
                                                     for _ in range(B)])[None],
                              "noise": torch.randn(1, TP_MAR_STEPS, rows, C, generator=g),
                              "zs": torch.randn(1, TP_MAR_STEPS, K, rows, C, generator=g)}}
        out[case] = {"state": {k: v.cpu() for k, v in model.state_dict().items()},
                     "batch": batch, "rollout": roll}
        del model
    torch.save(out, Path(tmp) / "tp_cases.pt")
    torch.cuda.empty_cache()


def tp_one_process(tmp):
    """One process's `tp_run` of (a) and (b), which phases 25 and 26 compare
    their ranks with: made once a script run (the cases are seeded), and
    the cases written to tmp for the ranks each time."""
    import torch

    write_tp_cases(tmp)
    if not TP_ONE:
        cases = torch.load(Path(tmp) / "tp_cases.pt", weights_only=False)
        TP_ONE.update({case: tp_run(case, cases[case]) for case in ("d256", "d512")})
    return TP_ONE


def tp_run(case, spec, mesh=None):
    """Two bf16 full-grad steps of the domain-sliced AdamW on (a)'s or (b)'s
    model (split over `mesh`'s tp axis where given): the first's loss and
    grads are compared, the second is timed, its launches counted from just
    before to just after and its peak memory read (less what the process
    held before the model was built); then the fp32 cached
    rollout. ({"loss", "grads": {name: the local grad}, "secs", "peak",
    "bytes", "counts", "rollout", "rollout_counts", "cache_heads",
    "cache_sites", "parts"}."""
    import gc

    import torch

    from hma_tpu_torch.parallel.mesh import shard_model
    from hma_tpu_torch.rollout.mar import generate_latents
    from hma_tpu_torch.rollout.maskgit import generate_tokens
    from hma_tpu_torch.train.step import make_domain_sliced_optimizer, make_train_step
    from hma_tpu_torch.train.trainer import stacked_param_mask

    gc.collect()  # the last case's optimizer and model (a spy makes a cycle)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()  # what the process held already
    model = tp_model(case, torch.bfloat16, spec["state"])
    mask = stacked_param_mask(model, model.config)
    if mesh is not None:
        shard_model(model, mesh)
    tx = make_domain_sliced_optimizer(model, DP_LR, stacked_mask=mask,
                                      num_domains=model.config.num_domains)
    seen = {}
    update = tx.step

    def spy(params, grads, d, ok, noise=None):
        seen.update({n: g.detach().float().cpu().clone() for n, g in grads.items()})
        return update(params, grads, d, ok, noise)

    tx.step = spy
    step = make_train_step(model, tx, continuous=case == "d512")
    batch = {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in spec["batch"].items()}
    loss = step(batch)["loss"].item()  # the step compared; the next one timed
    first = dict(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    step(batch)["loss"].item()
    secs = time.perf_counter() - t0
    seen = first
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out = {"loss": loss, "grads": seen, "secs": secs, "counts": read_counts(),
           "peak": torch.cuda.max_memory_allocated() - before,
           "bytes": (nbytes(model.parameters()), nbytes([*tx.m.values(), *tx.v.values()])),
           "parts": {n: tuple(p) for n, p in getattr(model, "tp_parts", {}).items()}}
    del model, tx, step, spy, update
    gc.collect()
    torch.cuda.empty_cache()

    model = tp_model(case, torch.float32, spec["state"]).eval()
    if mesh is not None:
        shard_model(model, mesh)
    roll = spec["rollout"]
    g = torch.Generator("cuda").manual_seed(0)
    reset_counts()
    with torch.no_grad():
        if case == "d256":
            T = model.config.T
            got = generate_tokens(model, roll["tokens"].cuda(), T - 2, roll["actions"].cuda(),
                                  5, g, maskgit_steps=2, temperature=0.0)[:, T - 2:]
        else:
            got = generate_latents(model, roll["latents"].cuda(), model.config.T - 1,
                                   roll["actions"].cuda(), 5, g,
                                   maskgit_steps=TP_MAR_STEPS,
                                   draws={k: v.cuda() for k, v in roll["draws"].items()})[:, -1]
    torch.cuda.synchronize()
    cache = model.init_cache(1)[0]
    out.update(rollout=got.cpu(), rollout_counts=read_counts(),
               cache_heads=cache.shape[-2], cache_sites=cache.shape[1])
    del model
    torch.cuda.empty_cache()
    return out


def tp_worker(spec: str) -> int:
    """A rank of phase 25 or 26: a gloo group over the card's CUDA tensors
    and its (1, fsdp, tp, sp) mesh (tp the rest of the world); with fsdp 1,
    (a) and (b) (`tp_run`), under sp with the exchange's time beside them,
    with fsdp 2, phase 25 (c): phase 23 (b)'s case split over tp and sharded
    by FSDP2, one step on its data index's rows. Saves what it saw."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from hma_tpu_torch.parallel import distributed
    from hma_tpu_torch.parallel.mesh import AXES, shard_model, use_mesh
    from hma_tpu_torch.train.trainer import stacked_param_mask

    rank, world, port, tmp, fsdp, sp = json.loads(spec)
    torch.cuda.set_device(0)  # every rank shares the one card
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    mesh = use_mesh(init_device_mesh("cuda", (1, fsdp, world // (fsdp * sp), sp),
                                     mesh_dim_names=AXES))
    if fsdp == 1:
        cases = torch.load(Path(tmp) / "tp_cases.pt", weights_only=False)
        out = {case: tp_run(case, cases[case], mesh) for case in ("d256", "d512")}
        if sp > 1:
            out["exchange"] = exchange_ms(mesh)
    else:
        model, batch = load_dp_case(tmp)
        mask = stacked_param_mask(model, model.config)
        shard_model(model, mesh)
        reset_counts()
        loss, grads, _ = fsdp_dp_step(model, batch, mask, distributed.data_group())
        out = {"loss": loss, "grads": grads, "counts": read_counts(),
               "parts": {n: tuple(p) for n, p in model.tp_parts.items()}}
    torch.save(out, Path(tmp) / f"tp_rank{rank}_{world}_sp{sp}.pt")
    torch.distributed.destroy_process_group()
    return 0


def start_tp_workers(tmp, world, fsdp, sp=1):
    port = free_port()
    return [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp_worker",
                              json.dumps([r, world, port, str(tmp), fsdp, sp])],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_workers(procs, what, timeout=600):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:  # every process this phase started ends with it
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{what} rank {r} failed (exit {p.returncode}):\n"
                f"{out[-12000:]}")


def worst_part(grads, want, parts, rank, world, slices=None):
    """(max over tensors of max|dg| / max|g|, where) of a rank's grads
    against one process's `want`, each taken to the rank's dealt columns
    (`parts`) and, with `slices` {name: ((start, stop), ...)}, its shard."""
    from hma_tpu_torch.parallel.tensor_parallel import Part, take

    worst, where = 0.0, ""
    for n, w in want.items():
        scale = w.abs().max().item()
        if n in parts:
            w = take(w, Part(*parts[n]), rank, world)
        if slices is not None:
            w = w[tuple(slice(a, b) for a, b in slices[n])]
        got = grads[n]
        err = (got - w).abs().max().item() if got.numel() else 0.0
        ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if ratio >= worst:
            worst, where = ratio, n
    return worst, where


def split_launches(rank) -> dict:
    """A phase-25 or phase-26 rank's K1'/K2' launches by phase-3 record:
    each runs on H 4 of the 8 heads a rank (after tp's split, or sp's
    exchange at sp 2), at (a)'s step (B 8 x T 12 frames of 320 tokens, D
    32), (b)'s (of 128 tokens, D 64), (a)'s cached rollout (B 8 a frame)
    and (b)'s (B 2)."""
    a, b = rank["d256"], rank["d512"]
    return {("K1'", (96, 320, 4, 32)): a["counts"]["K1'"],
            ("K2'", (96, 320, 4, 32)): a["counts"]["K2'"],
            ("K1'", (96, 128, 4, 64)): b["counts"]["K1'"],
            ("K2'", (96, 128, 4, 64)): b["counts"]["K2'"],
            ("K1'", (8, 320, 4, 32)): a["rollout_counts"]["K1'"],
            ("K1'", (2, 128, 4, 64)): b["rollout_counts"]["K1'"]}


def tp_phase(records):
    """Phase 25: (a) and (b) on two tp ranks, (c) on four (fsdp 2, tp 2)
    ranks, each against one process."""
    import torch

    from hma_tpu_torch.train.trainer import stacked_param_mask

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        one = tp_one_process(tmp)
        write_dp_case(tmp)
        t0 = time.perf_counter()
        wait_workers(start_tp_workers(tmp, 2, 1), "tp 2")
        secs = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"tp_rank{r}_2_sp1.pt", weights_only=False)
                 for r in range(2)]
        for case, label in (("d256", f"d256 at {TP_LAYERS['d256']} layers, K1'-K4'"),
                            ("d512", f"d512 STMAR at {TP_LAYERS['d512']} layers, resident, "
                                     "K5'")):
            want = one[case]
            for r, got in enumerate(g[case] for g in ranks):
                loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
                worst, where = worst_part(got["grads"], want["grads"], got["parts"], r, 2)
                print(f"  tp 2 rank {r}, {label}, B 8, bf16 step: loss {got['loss']:.6f} "
                      f"against 1 process {want['loss']:.6f} (rel err {loss_err:.3e}); "
                      f"{len(got['grads'])} grads ({len(got['parts'])} split), worst "
                      f"max|dg|/max|g| {worst:.3e} at {where} (tol {TP_BF16_TOL}); step "
                      f"{got['secs']:.3f} s (1 process {want['secs']:.3f} s); parameter / "
                      f"moment bytes {got['bytes']} (1 process {want['bytes']}); peak memory "
                      f"{got['peak'] / 1e9:.2f} GB (1 process {want['peak'] / 1e9:.2f} GB); "
                      f"launches {got['counts']} (1 process {want['counts']}); cache heads "
                      f"{got['cache_heads']}", flush=True)
                require(loss_err <= TP_BF16_TOL, f"tp 2 {case}: loss differs")
                require(worst <= TP_BF16_TOL, f"tp 2 {case}: grad {where} differs: {worst:.3e}")
                require(got["counts"] == want["counts"], f"tp 2 {case}: launches differ")
                require(got["cache_heads"] == 4, f"tp 2 {case}: caches of {got['cache_heads']} heads")
                if case == "d256":
                    share = (got["rollout"] == want["rollout"]).float().mean().item()
                    print(f"  tp 2 rank {r}, d256 fp32 cached rollout, B 8, 2 greedy frames "
                          f"after 10: tokens equal to 1 process's {share:.5f} (least "
                          f"{TP_TOKEN_SHARE}); launches {got['rollout_counts']}", flush=True)
                    require(share >= TP_TOKEN_SHARE, "tp 2 d256 rollout tokens differ")
                    require(got["rollout_counts"]["K1'"] > 0, "tp 2 rollout missed K1'")
                else:
                    err = ((got["rollout"] - want["rollout"]).abs().max()
                           / want["rollout"].abs().max()).item()
                    print(f"  tp 2 rank {r}, d512 STMAR fp32 cached MAR rollout, B 2, one "
                          f"frame, {TP_MAR_STEPS} MaskGIT steps, handed-in draws, K6' on the "
                          f"gathered head: max|d|/max|x| {err:.3e} (tol {TP_FP32_TOL}); "
                          f"launches {got['rollout_counts']}", flush=True)
                    require(err <= TP_FP32_TOL, "tp 2 MAR rollout differs")
                    require(got["rollout_counts"]["K6'"] > 0 and got["rollout_counts"]["K1'"] > 0,
                            "tp 2 MAR rollout missed K1' or K6'")
        print(f"  tp 2: both ranks, (a) and (b), {secs:.1f} s", flush=True)
        set_launches(records, split_launches(ranks[0]))
        c = ranks[0]["d256"]["counts"]
        set_launches(records, {("K3'", (2560, 12, 4, 32)): c["K3'"],
                               ("K4'", (2560, 12, 4, 32)): c["K4'"]})
        c = ranks[0]["d512"]["counts"]
        set_launches(records, {("K5' fwd", (8, 12, 128, 4, 64)): c["K5' fwd"],
                               ("K5' bwd", (8, 12, 128, 4, 64)): c["K5' bwd"]})
        del one, ranks

        model, batch = load_dp_case(tmp)
        loss, grads, _ = fsdp_dp_step(model, batch, stacked_param_mask(model, model.config))
        grads = {n: g for n, (g, _) in grads.items()}
        del model
        t0 = time.perf_counter()
        wait_workers(start_tp_workers(tmp, 4, 2), "(fsdp 2, tp 2)")
        secs = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"tp_rank{r}_4_sp1.pt", weights_only=False)
                 for r in range(4)]
        for r, got in enumerate(ranks):
            loss_err = abs(got["loss"] - loss) / abs(loss)
            worst, where = worst_part({n: g for n, (g, _) in got["grads"].items()}, grads,
                                      got["parts"], r % 2, 2,
                                      {n: i for n, (_, i) in got["grads"].items()})
            print(f"  (fsdp 2, tp 2) rank {r}, 2-layer d256, fp32, B 8 (4 a data index): "
                  f"loss {got['loss']:.6f} against 1 process {loss:.6f} (rel err "
                  f"{loss_err:.3e}); worst max|dg|/max|g| {worst:.3e} at {where} (tol "
                  f"{DP_TOL}); launches {got['counts']}", flush=True)
            require(loss_err <= DP_TOL, "(fsdp 2, tp 2): loss differs")
            require(worst <= DP_TOL, f"(fsdp 2, tp 2): grad {where} differs: {worst:.3e}")
            require(all(got["counts"][k] for k in TRAINING_KERNELS),
                    "(fsdp 2, tp 2): a rank missed a kernel")
        print(f"  (fsdp 2, tp 2): four ranks {secs:.1f} s", flush=True)


def exchange_ms(mesh) -> dict:
    """Phase 26: this rank's time for the spatial attention's exchange at
    (a)'s step shapes (the d256 card, B 8: B T = 96 frames, 8 heads of 32):
    `tokens_to_heads` of q, k, v stacked (96, 320 / sp, 3, 8, 32) bf16, then
    `heads_to_tokens` of the (96, 320, 1, 8 / sp, 32) output, each over
    EXCHANGE_REPS calls after one, on the host's clock with the card
    synchronised (a gloo all-to-all of CUDA tensors goes through the host)."""
    import torch

    from hma_tpu_torch.parallel import sequence_parallel as seqp
    from hma_tpu_torch.parallel.mesh import sp_group
    from hma_tpu_torch.parallel.tensor_parallel import group_of

    sp = group_of(sp_group(mesh))
    cfg = flagship_config(40)
    S_tot, H = cfg.S + cfg.action_token_size, cfg.num_heads
    D, BT = cfg.d_model // H, 8 * cfg.T
    x = torch.randn(BT, S_tot // sp.size, 3, H, D, device="cuda", dtype=torch.bfloat16)
    y = torch.randn(BT, S_tot, 1, H // sp.size, D, device="cuda", dtype=torch.bfloat16)
    out = {}
    for name, fn, arg in (("tokens_to_heads", seqp.tokens_to_heads, x),
                          ("heads_to_tokens", seqp.heads_to_tokens, y)):
        fn(arg, sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXCHANGE_REPS):
            fn(arg, sp)
        torch.cuda.synchronize()
        out[name] = ((time.perf_counter() - t0) / EXCHANGE_REPS * 1e3, arg.numel() * 2)
    return out


def sp_phase(records):
    """Phase 26: (a) and (b) of phase 25 on two sp ranks, each rank's trunk
    on its half of every frame's tokens, against one process; the
    exchange's time."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        one = tp_one_process(tmp)
        t0 = time.perf_counter()
        wait_workers(start_tp_workers(tmp, SP_RANKS, 1, SP_RANKS), f"sp {SP_RANKS}")
        secs = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"tp_rank{r}_{SP_RANKS}_sp{SP_RANKS}.pt", weights_only=False)
                 for r in range(SP_RANKS)]
    for case, label in (("d256", f"d256 at {TP_LAYERS['d256']} layers, K1'-K4'"),
                        ("d512", f"d512 STMAR at {TP_LAYERS['d512']} layers, resident, K5'")):
        want = one[case]
        for r, got in enumerate(g[case] for g in ranks):
            loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            worst, where = worst_part(got["grads"], want["grads"], {}, r, SP_RANKS)
            print(f"  sp {SP_RANKS} rank {r}, {label}, B 8, bf16 step: loss {got['loss']:.6f} "
                  f"against 1 process {want['loss']:.6f} (rel err {loss_err:.3e}); "
                  f"{len(got['grads'])} grads, worst max|dg|/max|g| {worst:.3e} at {where} "
                  f"(tol {TP_BF16_TOL}); step {got['secs']:.3f} s (1 process "
                  f"{want['secs']:.3f} s); parameter / moment bytes {got['bytes']} (1 process "
                  f"{want['bytes']}); peak memory {got['peak'] / 1e9:.2f} GB (1 process "
                  f"{want['peak'] / 1e9:.2f} GB); launches {got['counts']} (1 process "
                  f"{want['counts']}); cache sites of a row {got['cache_sites']} (1 process "
                  f"{want['cache_sites']}), heads {got['cache_heads']}", flush=True)
            require(loss_err <= TP_BF16_TOL, f"sp {case}: loss differs")
            require(worst <= TP_BF16_TOL, f"sp {case}: grad {where} differs: {worst:.3e}")
            require(got["counts"] == want["counts"], f"sp {case}: launches differ")
            require(got["cache_sites"] * SP_RANKS == want["cache_sites"]
                    and got["cache_heads"] == want["cache_heads"],
                    f"sp {case}: caches of {got['cache_sites']} sites, {got['cache_heads']} heads")
            if case == "d256":
                share = (got["rollout"] == want["rollout"]).float().mean().item()
                print(f"  sp {SP_RANKS} rank {r}, d256 fp32 cached rollout, B 8, 2 greedy "
                      f"frames after 10: tokens equal to 1 process's {share:.5f} (least "
                      f"{TP_TOKEN_SHARE}); launches {got['rollout_counts']}", flush=True)
                require(share >= TP_TOKEN_SHARE, "sp d256 rollout tokens differ")
                require(got["rollout_counts"]["K1'"] > 0, "sp rollout missed K1'")
            else:
                err = ((got["rollout"] - want["rollout"]).abs().max()
                       / want["rollout"].abs().max()).item()
                print(f"  sp {SP_RANKS} rank {r}, d512 STMAR fp32 cached MAR rollout, B 2, "
                      f"one frame, {TP_MAR_STEPS} MaskGIT steps, handed-in draws, K6' on the "
                      f"gathered rows: max|d|/max|x| {err:.3e} (tol {TP_FP32_TOL}); launches "
                      f"{got['rollout_counts']}", flush=True)
                require(err <= TP_FP32_TOL, "sp MAR rollout differs")
                require(got["rollout_counts"]["K6'"] > 0 and got["rollout_counts"]["K1'"] > 0,
                        "sp MAR rollout missed K1' or K6'")
    for r, got in enumerate(ranks):
        print(f"  sp {SP_RANKS} rank {r}, the spatial exchange at (a)'s shapes, "
              + "; ".join(f"{name} {ms:.3f} ms ({n / 1e6:.1f} MB)"
                          for name, (ms, n) in got["exchange"].items()), flush=True)
    print(f"  sp {SP_RANKS}: both ranks, (a) and (b), {secs:.1f} s", flush=True)
    set_launches(records, split_launches(ranks[0]), add=True)
    c = ranks[0]["d256"]["counts"]
    set_launches(records, {("K3'", (1280, 12, 8, 32)): c["K3'"],
                           ("K4'", (1280, 12, 8, 32)): c["K4'"]})
    c = ranks[0]["d512"]["counts"]
    set_launches(records, {("K5' fwd", (8, 12, 64, 8, 64)): c["K5' fwd"],
                           ("K5' bwd", (8, 12, 64, 8, 64)): c["K5' bwd"]})


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(str(i) for i in range(1, 27)),
                   help="comma-separated phases to run (1 and 2 always run)")
    p.add_argument("--dp_worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fsdp_worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--tp_worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--sliced_profile", action="store_true",
                   help="only the d512 STMAR fp32-moment step, full against sliced "
                        f"grads in {PROFILE_PAIRS} pairs, with a host profile")
    p.add_argument("--profile_dir", default=None,
                   help="with --sliced_profile: write the whole cProfile tables here")
    args = p.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")} | {1, 2}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.dp_worker:  # a rank of phase 23 (b), started by the phase itself
        return dp_worker(args.dp_worker)
    if args.fsdp_worker:  # a rank of phase 24 (b)
        return fsdp_worker(args.fsdp_worker)
    if args.tp_worker:  # a rank of phase 25 or 26
        return tp_worker(args.tp_worker)
    if args.sliced_profile:
        return sliced_profile(args.profile_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    print(f"[1] device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    from hma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in report.items():
        print(f"  {name}.cu: {r['seconds']:.1f} s\n{r['log']}", flush=True)
    print_hmma_counts(_build)

    records = []
    timings = {}  # phase 6's median step, read beside phase 22's
    steps = [(3, "kernels vs plain versions", lambda: records.extend(kernel_phase())),
             (4, "rollouts, d256 card", lambda: main_path_phase(records)),
             (5, "entry point: generate", entry_point_phase),
             (6, "training step, d256 card",
              lambda: timings.update({"d256 step": training_phase(records)})),
             (7, "gradient exactness, card vs CPU", exactness_phase),
             (8, "entry point: train_multi, then generate", train_entry_phase),
             (9, "rollouts, d512 STMAR card", lambda: mar_path_phase(records)),
             (10, "entry point: generate --use_feature", feature_entry_phase),
             (11, "training step, d512 STMAR card, both layouts",
              lambda: mar_training_phase(records)),
             (12, "STMAR gradient exactness, card vs CPU, both layouts", mar_exactness_phase),
             (13, "entry point: train_multi --model_type continuous, then generate",
              mar_train_entry_phase),
             (14, "the four other shipped cards", lambda: other_cards_phase(records)),
             (15, "the evaluation rollout surface, d256 card",
              lambda: rollout_surface_phase(records)),
             (16, "entry points: evaluate, evaluate --use_feature, evaluate_feature",
              eval_entry_phase),
             (17, "the MagVit2 codec; entry point: evaluate --tokenizer_ckpt "
                  "[--raw_image_data]", codec_phase),
             (18, "the simulator, d256 and d512 STMAR cards; entry point: build_simulator",
              lambda: simulator_phase(records)),
             (19, "the SVD temporal VAE and the metric backbones; entry points: "
                  "build_simulator (STMAR, pixels), evaluate_feature --vae_checkpoint",
              lambda: pixel_metrics_phase(records)),
             (20, "LPIPS and the tokenizer's GAN training; entry points: train_tokenizer, "
                  "train_multi --tokenizer_checkpoint --lpips_weights, visualize",
              lambda: tokenizer_training_phase(records)),
             (21, "the encode pipeline (encode_extern, make_svd_encoder, merge_shards, "
                  "resize_image); train_multi --use_native_loader; pixel-prompted simulators",
              lambda: encode_pipeline_phase(records)),
             (22, "cross-attention action injection, joint action prediction, muP, bf16 "
                  "Adam moments; entry points: train_multi --action_network "
                  "concat+cross_attention --mu_transfer, then generate; train_multi "
                  "--model_type continuous --mu_transfer --adam_moment_dtype bfloat16, "
                  "resumed", lambda: surface_phase(records, timings)),
             (23, "sliced gradients (d512 STMAR and d256 steps with and without, "
                  "exactness); data parallelism: 2 gloo ranks on one card against 1 "
                  "process, train_multi in a 1-rank NCCL group",
              lambda: sliced_dp_phase(records)),
             (24, "fsdp: FSDP2 on a 1-rank NCCL mesh against the unwrapped step (d512 STMAR "
                  "both moment dtypes, d256; 2-layer exactness; K6' on the gathered head; "
                  "the gathered checkpoint); fsdp 2 on 2 gloo ranks against 1 process; "
                  "train_multi --fsdp 1 resumed from the FSDP2 checkpoint",
              lambda: fsdp_phase(records)),
             (25, "tp: tp 2 on 2 gloo ranks (d256 step at H 4 and its cached rollout; d512 "
                  "STMAR resident step, K5' at H 4, and its cached MAR rollout, K6' on the "
                  "gathered head); (fsdp 2, tp 2) on 4 ranks; each against 1 process",
              lambda: tp_phase(records)),
             (26, "sp: sp 2 on 2 gloo ranks (d256 step, K1'/K2' on whole frames of H 4 "
                  "after the all-to-all, K3'/K4' on a rank's 1280 sites, and its cached "
                  "rollout; d512 STMAR resident step, K5' on a rank's 64 tokens, and its "
                  "cached MAR rollout); each against 1 process; the exchange's time",
              lambda: sp_phase(records))]
    for n, title, run in steps:
        if n in phases:
            t0 = time.perf_counter()
            print(f"[{n}] {title}", flush=True)
            run()
            print(f"  phase {n}: {time.perf_counter() - t0:.1f} s", flush=True)

    # every kernel of the main paths was launched
    if {3, 4, 6, 9, 11, 14, 15, 18, 25, 26} <= phases:
        for r in records:
            require(r["launches"], f"{r['name']} {r['shape']} never launched")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
