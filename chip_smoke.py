#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, no result):
  1. device: the card's name and power limit; TF32 switched off for
     float32 matmuls and convolutions (the comparisons below are float32;
     the pipelines themselves run bfloat16);
  2. build: every kernel of the port's serving, training and scoring
     paths and its measurement tool, from ``vae_gslm_tpu_torch/csrc`` with
     one nvcc per source, all started together (K1 ``fused_decode.cu``,
     K2 ``mega_step.cu``, K3/K3b/K4/K4b/K5/K5b ``flash_attention.cu``, K6
     ``flash_decode.cu``, K7 ``stream.cu``), with nvcc's register and
     spill lines, and beside them the g++ build of ``native/dataio.cc``;
  3. K1 against its plain PyTorch version at the cache states its
     cluster design makes likely to break (an empty cold cache at pos 0,
     pos == flushed, 9 and 40 cold blocks: more than a portable cluster's
     8 CTAs, B = 1, and head_dim 16, 32, 128 and 256, the last past 8
     blocks through its plane ring; one launch a call), then at the
     flagship width (16 layers, 16 heads, head_dim 64) at B = 8 and 32
     over the cache states the 150 -> 650 rollout passes through; kernel
     and plain device times (torch.profiler), the time per call with the
     wrapper (CUDA events), the HBM-bytes bound;
  4. K2 (the whole 16-layer trunk step) against its plain version at the
     flagship width, B = 1, 2 and 8 with s8 x s8 products (K2-a8: one
     persistent cooperative launch a step, int8 tensor-core products) and
     B = 17 and 32 with bf16 products (K2-bf16: the other persistent
     kernel, FP64 tensor-core products), over five (flushed, pos) cache
     states of the rollout and a full tail with an empty stage, at max
     |diff| <= 2e-3 |want| + 2e-4, each call counted once under its
     branch and, at B = 8 and 32, one call one launch in a profiler
     window; then K2-a8's times at B = 8 and K2-bf16's at B = 32 (the
     CLI's chunks) at the rollout's position 351 (kernel by profiler,
     wrapper by CUDA events, plain, bytes bound), their phase lines by
     batch (block 0's global timer: B = 1, 8 and 1, 17, 32), and one of
     their grid barriers alone (a probe launch of 1000);
  4b. K2-w4 (the same step on nibble-packed int4 weights, the a8 step's
     kernel) against its plain version over those cache states at B = 8
     with group 128, at B = 32 with group 128 (the CLI's chunks under
     ``VAE_GSLM_MEGA_W4=1``) and at B = 32 with group 64 (its ``=64``
     setting), at K2's tolerance (the weights packed by the port's
     ``pack_mega_w4`` on the card from K2's int8 weights, bitwise equal to
     the same packing on the CPU); one call one launch;
     its times at B = 32 with group 128 at position 351 and its
     phase lines at B = 9, 17 and 32;
  4c. ``k2_widths``: K2's instantiations at head widths 128 (8 heads)
     and 32 (32 heads) at d1024 against their plain version over
     ``K2_STATES`` (a8 at B 1, 2, 8; bf16 at B 17, 32; w4 at B 32, group
     128, and group 64 at width 32), one launch each, each branch timed
     at position 351 beside its plain version and bound, its plan and
     phase lines;
  5. K3 (packed ALiBi flash attention forward: o, lse) and K3b (its
     backward: dq, dk, dv) against their plain versions at the training
     shapes (B 8, T 640, 16 heads of 64, q/k/v views of one projection,
     lengths down to 1), float32 and bfloat16, with ALiBi and without,
     the bf16 outputs also element by element (2 ulps + a share of the
     rms) and in relative L2, and in bf16 at T 1000 and 1024 (the wgmma
     forward's largest resident K), in float32 at T 37, 100 and 1000
     (below one 128-row query tile of the one-pass float32 body, and
     ragged; lengths 0 and 1); K3 float32 at the scoring path's
     call (B 64, the short batch's padded length and lengths) and its
     time beside SDPA's (float32, float mask) and the bound; K3/K3b's
     bf16 times beside the plain versions', SDPA's with a float mask
     (K3: forward, and the kernel's ratio to it; K3b: backward alone,
     and forward+backward) and the bound;
  5b. K5 (the q-tiled forward) at B 8, 16 heads of 64, T 1750, lengths
     down to 0 and 1, and Tq 96 x Tk 256 non-causal, and K4 (the (B, H,
     T, D) full forward with lse) at B 8, T 640 with 15 heads (no packed
     head grouping), against their plain versions, float32 and bfloat16,
     with ALiBi and without, at K3's tolerances, and in float32 at the
     one-pass body's edges (Tq 37 x Tk 300, Tq 96 x Tk 8192 non-causal,
     Tq = Tk = 8192 and 1100 causal, K4 at T 5 and T 300 non-causal,
     lengths 0 and 1), and in bf16 (the streaming
     ``k5_fwd_wgmma_kernel``) at Tq = Tk = 8192 causal and Tq 96 x Tk
     8192 non-causal, lengths 0 and 1; K5 float32 at the scoring path's
     calls (B 64, T 1750, each long batch's lengths) and its time there
     beside the bound and SDPA's (float32, float mask, in 8-row chunks
     summed); its float32 and bf16 times at B 8, each beside the plain
     version's, SDPA's forward with a float mask of its type and its
     bound;
  5c. K4 (with lse) and K4b (the (B, H, T, D) full backward from K4's
     lse) at the data-parallel training call (B 8, T 640, 16 heads,
     lengths down to 0 and 1; K4's o and lse at K3's forward
     tolerances) and K5b (the blockwise backward) at B 2, T 1536
     (lengths 1536 and 1) and Tq 96 x Tk 256 non-causal (lengths 256, 0,
     1), float32 and bfloat16, against their plain versions, K4b/K5b at
     K3b's tolerances (f32 1e-4 x max|ref|; bf16 2e-2 x max|ref|,
     element by element 2 bf16 ulps + 2e-2 rms(ref), relative L2 1e-3:
     dk and dv sum every query row's share in float32 in another order
     than the plain einsum, and a ds one ulp apart rounds to another
     bf16 value); K4 bf16 also at T 200, 1000 and 1024, with and
     without lse; the bf16 backward (K4b and K5b's ``bwd_wgmma``) also
     at K4b T 200, 1000 and 1024 and K5b T 1100 and 8192 (Tk at the
     envelope's edge), lengths 0 and 1 among them; their bf16 times (K4
     and K4b at the training call, K5b at B 2 x T 1536: 2 kernels per
     call, its row statistics inside the dq kernel) beside the plain
     versions', SDPA's with a float mask (forward for K4, with the
     ratio; backward alone, with the ratio, and forward+backward for
     K4b/K5b) and the bound; then the float32 backward's times (the
     trainer's default precision: ``k4b_``/``k5b_{dq,dkv}_kernel``, 2
     kernels per call) at the same two calls beside the plain versions',
     SDPA's float32 backward alone and the float32 operations bound;
  5d. K6 (single-query decode attention over an int8 per-layer cache,
     reading only the blocks up to ``pos``) against its plain version at
     the per-layer path's calls: B 128, 16 heads of 64, T 768 (the
     651-position rollout rounded up to 256), a bf16 q as a view of one
     qkv projection, at pos 151, 255, 256, 400, 511, 512 and 650, to
     1e-5 x max|ref| (float32, both summing in 256-key blocks); then
     over every 50th position of
     the rollout its device time, the time per call with the wrapper,
     the plain version's time, JAX's route as ported (``decode_attention``
     over the cache at the sampler's segment window: the A/B beside the
     kernel) and the bytes bound;
  5e. K7 (the weight-stream probe) on a seed-0 (16, 1024, 12288) int8
     stack: its per-layer sums and the TPU kernel's tile sum equal to the
     plain version's; the plain version's and one ``torch.sum``'s times;
     then ``scripts/bench_slope.py``'s slopes: K7's microseconds per call
     and GB/s (beside the 3.35 TB/s of the data sheet, which the bounds
     keep), K2's full step at flushed 0 and 512;
  6. agreement on a small input: a small LVTR (head_dim 64)
     continues a prompt by 300 frames on the card (through the kernels)
     and on the CPU (through the plain versions), float32, temperature 0,
     with bf16 weights through K1 across a 256-position flush, with
     int8 weights through K2 (dim 256) across 8-step merges and two
     128-position flushes, at B = 2 (K2-a8) and B = 12 (K2-bf16: exactly
     300 launches and no other K2), and with int4 weights (group 128) through
     K2-w4 (exactly 300 K2-w4 launches and no other K2 on the card); then
     the int8-weight model (dim 256) at B = 72, past the mega batches, on
     the per-layer route three times: an int8 cache through
     ``decode_attention``, the same through K6 (exactly 600 launches) and
     a float32 cache (``kv_dtype`` None), none launching K1 or K2: the
     token streams agree until at least step 150, the latents of the
     first 64 steps to 1e-2;
  7. one small training step (accumulation 2, utterance encoder) on the
     card through K3/K3b and on the CPU through the plain versions, same
     weights, batch and draws, float32: loss terms to 1e-4 relative,
     every gradient leaf to 1e-3 of its max |g|;
  7b. ``LVTR.likelihood`` of a small float32 LVTR with three heads of 64
     (no packed head grouping) on the card and on the CPU, pinned initial
     state: at T = 300 through K4 and at T = 1100 through K5, scores to
     1e-4 relative;
  7c. two ranks of the small training step on the card: two processes
     of this script (worker mode, ``--dp-worker``) join a gloo process
     group through JAX's launch variables and share the one card; each
     takes its half of a global batch with pinned draws through K4/K4b
     (the data-mesh route); against the single-process step over the
     whole batch on the card (K3/K3b): metrics to 1e-4 relative, the
     summed gradients to 1e-3 x max|g|, the ranks' parameters bitwise
     equal, 4 K4 and 4 K4b launches per rank and no K3/K3b;
  8. the serving paths: a 3 s -> 10 s continuation at B = 8 at the full
     width of ``configs/train/speech/vae-gslm.yaml`` (weights from seed
     0; without the utterance encoder, which the serving path does not
     run), int8 KV cache,
     temperature 0.85, DDIM-100 at eta 0.5, then the HiFi-GAN of
     ``configs/train/vocoder/hfgan_16k_50hz_librispeech.yaml`` (weight
     norm folded, as ``HiFiGAN.from_pretrained`` leaves it); each run
     once, with the kernels' counts set to 0 just before a run and read
     just after:
       - bf16 weights (the hybrid path): exactly 16 x 500 K1 launches and
         no K2 launch per run;
       - int8 weights quantized from the float32 weights, the rest cast
         to bf16 (the shipped ``weight_dtype: int8`` path): exactly 500
         K2 launches and no K1 launch per run (B = 64 runs in phase 11);
     then, for each path, a profile of 64 AR steps: the device busy
     share and the kernels that take it;
  8b. the per-layer paths at that width, ``CUT_L`` = 8 layers (cut from
     16 for the time limit), and B = 128 (past the mega
     batches), same prompts, stages and checks: int8 weights and an
     int8 cache through JAX's route (``decode_attention``; no K1, K2 or
     K6 launch), then with ``flash_decode=True`` (exactly 8 x 500 K6
     launches, no K1 or K2), the two routes' token agreement and latent
     difference reported, each with its real-time factor, stage times,
     ms per AR step and peak memory, and a profile of 32 AR steps of
     each; then bf16 weights with a bf16 cache (``kv_dtype`` None; no
     kernel launch on the AR loop);
  9. the training path: ``LVTRTrainer`` on that config at full width with
     its utterance encoder (16-mixed, AdamW, accumulation 2), synthetic
     B = 8 x 640 batches from seed 0: one warm-up and five timed
     ``run_step`` calls, each with exactly 32 K3 and 32 K3b launches
     (counts set to 0 just before each step), the plain attention
     versions refused; ms per step, tokens/s, peak memory, then one
     profiled step;
  9b. the data-parallel training path: two ranks sharing the card (gloo)
     run ``scripts/train.py`` -> ``LVTRTrainer.fit`` on the shipped
     config, its data paths pointed at a synthetic corpus written from
     seed 0 (96 WAVs of 13-20 s, their token ids, and the mels that
     ``scripts/preprocess_mels.py`` writes from them on the card):
     8 rows per rank x accumulation 2 x 640 frames, 16-mixed, three
     optimizer steps, each with its counts set to 0 just before and read
     just after (exactly 32 K4 and 32 K4b launches per rank and no other
     attention kernel; the plain versions refused), the ranks'
     parameters bitwise equal and their logged metrics equal, rank 0's
     ``last-cpt.npz`` read back strictly and equal to them; ms per step,
     tokens/s per rank, the all-reduce's share and peak memory per rank
     (two ranks on one card: no scaling claim); then one step past 1024
     frames (``token_segment_size`` 1536 and its post-padding, the only
     changes, 2 rows per rank, accumulation 1, 4 WAVs of 31-35 s):
     exactly 16 K5 and 16 K5b launches per rank;
  10. the scoring path: ``LikelihoodEstimator`` at the full width of that
     config with its utterance encoder (weights from seed 0 written once
     by ``save_compact`` beside a seed-1 vocoder directory and shared
     with phase 11, read back strictly), float32, over 192 synthetic
     WAVs from seed 0 with the
     infer config's data settings (batch 64) and a uniform length mix
     made to run both routes: 64 utterances of 5-20 s (one batch <= 1024
     frames: 16 K3 launches) and 128 of 5-35 s (two batches padded to
     1750 frames: 16 K5 launches each), no K4 launch and no plain
     version, each batch's lengths those phases 5 and 5b held K3 and K5
     at; utterances/s, seconds of audio scored per wall second, model
     and data time, peak memory, one profiled batch, and the device time
     of one loader pass alone;
  11. the speech-continuation CLI, three times: ``scripts/infer.py``'s
     ``main`` in this process on the shipped
     ``configs/infer/speech/vae-gslm.yaml``
     with only ``ckpt_path`` (phase 10's checkpoint), ``vocoder.path``,
     ``data.path``, ``data.wavdir`` and ``output_dir`` pointed at a
     temporary directory holding 64 synthetic WAVs of 5-13 s from seed 0
     and their tokens file: one batch of 64 (two sequential B = 32 chunks
     of 500 AR steps, 16-mixed, int8 KV cache, int8 weights, DDIM-100 at
     eta 0.5 with the utterance embedding, HiFi-GAN, the energy-VAD trim),
     the kernels' counts set to 0 just before ``main`` and read just
     after: exactly 1000 K2-bf16 launches and no K2-a8, K2-w4 or K1
     launch; then with
     ``VAE_GSLM_MEGA_W4=1``, exactly 1000 K2-w4 launches and no K2 or K1
     launch; then one batch of 128 over 128 such WAVs (``data.batch_size``
     128, the per-layer int8 route: no K1, K2, K2-w4 or K6 launch) on a
     copy of the checkpoint at ``CUT_L`` layers.  Each
     run writes exactly one finite 16 kHz WAV per input, none longer than
     the 3 s prompt + 10 s; the real-time factor over the whole ``main``
     call (n x 10 s over its wall time: model build, data, sampling,
     vocoder and WAV writing included), the stage times and the peak
     memory;
  12. the HiFi-GAN training path (no port kernel launches on it; both
     phases check the counters): ``hfgan_small``, one G+D
     ``HiFiGANTrainer.run_step`` of the tiny config of ``tests/
     test_trainers.py::_hfgan_hp`` on the card and on the CPU from the
     same weights and a seeded batch, float32, TF32 set on before the
     step (the trainer's own scope must turn it off): the metrics to 1e-5
     relative, every gradient to 1e-4 x its leaf's max |g|, the
     parameters after the step, and a control step with TF32 left on;
     then ``hfgan_fit``: ``scripts/train.py``
     -> ``fit`` on the shipped
     ``configs/train/vocoder/hfgan_16k_50hz_librispeech.yaml`` at full
     width (B 24 x 1 s, MPD periods 2-11, MRD at three resolutions),
     only its data paths (48 + 4 synthetic WAVs from seed 0) and
     ``total_steps`` (``--max_steps 8``) changed: ms per G+D step with its
     D and G halves, its FLOPs and rate, peak memory, one profiled step's
     busy share and top operations, the one validation batch's mel L1;
     then
     ``HiFiGAN.from_pretrained`` on the written directory decodes four 1 s
     clips' mels on the card, equal to the trainer's generator;
  13. the rest of the nn layers at full width (``lvtr_options``): the
     shipped training config with, overridden in memory, a 3-layer
     ``ResNet`` encoder, Rotary trunk positions, a 4-layer spline flow
     and a ``ConditionalUNet`` denoiser with GroupNorm
     (``options_config``) at ``CUT_L`` = 8 layers: one
     ``LVTRTrainer.run_step`` at B 8 x 640,
     16-mixed, accumulation 2 (exactly 16 K3 and 16 K3b launches with no
     slopes), a B = 8 continuation of 500 per-layer int8 steps through
     ``decode_attention`` and then through K6 (exactly 4000 launches,
     zero slopes) with DDIM-100 and the HiFi-GAN, one float32 scoring
     batch of 4 x 1100 frames (exactly 8 K5 launches); one call of each
     of these kernels held against its plain version and timed at its
     path's shape; then the same configuration at 2 layers and convs of
     64/256 on the card against the CPU (loss terms, gradients, scores
     past 1024 frames, a per-layer K6 continuation); 13b.
     ``lvtr_options_small``: the same card-against-CPU checks on 2-layer
     d256 LVTRs with T5 positions, ``ConvCoupling`` and a GroupNorm
     encoder, and with SinCos positions and cross-attention over a
     memory;
  14. K5 past 8192 keys (``k5_long``), where it raised before: float32
     and bf16 at Tk 12288, self (B 1, 2 heads, causal) and cross (B 2,
     16 heads, Tq 256, lengths 12288 and 9001), against the plain version
     at phase 5b's gates, one launch a call, and its time at B 1 x 16
     heads x 12288 causal beside the bound and SDPA's (in 2048-row
     chunks, CUDA events); ``FlashAttention`` at T 9000
     (K5, then the dense backward: no K5b) against autograd of the plain
     reference; ``LikelihoodEstimator`` on one 180 s utterance with a
     small LVTR against the CPU;
  15. the token LM small (``discrete_small``): a 2-layer DiscreteAR card
     against CPU on the hybrid route (K1, across a flush) and the
     per-layer route (argmax draws, tokens equal), ``likelihood`` at T 300
     (K3) and 1100 (K5), and one ``DiscreteARTrainer`` step (K3/K3b,
     float32: CE and every gradient);
  16. ``discrete_train``: ``scripts/train.py`` -> ``DiscreteARTrainer.fit``
     at full width and ``CUT_L`` = 8 layers (phases 16, 18 and 19 share
     the checkpoint; the shipped trunk without its flow, single-VQ over
     200 tokens, the full-width HuBERT codec and the 80-bin vocoder on
     random weights), 16-mixed, B 8 x accumulation 2 x 640 tokens on a
     synthetic 48 x 13 s corpus, 4 steps with exactly 16 K3 and 16 K3b
     launches each (plain versions refused); step times, peak memory;
  17. ``hubert_decoder_fit``: ``HuBERTDecoderTrainer`` at full width (a
     3-layer 512/2048 ``ResNet`` embed encoder, the shipped 6-layer
     diffusion decoder), 4 float32 steps at B 8 x 640 frames (no port
     kernel), then ``save_checkpoint`` read back by
     ``HuBERTIO.from_pretrained``;
  18. ``discrete_serve``: ``DiscreteARSampler(kv_dtype=torch.int8)`` at B
     8, 150 -> 500 tokens, bf16 weights (exactly 4000 K1 launches, no
     other kernel), then ``scripts/infer.py`` with
     ``inference.speech.hubert.SpeechInferer`` on 8 utterances (the
     per-layer float32 route, HuBERT DDIM-100, HiFi-GAN): 8 continuations
     and 8 decoded prompts, finite and of the right lengths;
  19. ``discrete_score``: ``LikelihoodEstimator`` (the token LM branch),
     float32, one batch under 1024 tokens (8 K3) and one past it (8
     K5), plain versions refused;
  20. ``head_widths``: every templated flash body and K6 at head widths
     32 and 128 against its plain version at the D = 64 gates
     (``phase_head_widths``: K3/K3b bf16 and float32 at T 640 and 1024,
     the latter past the D = 128 resident plan; K4/K4b at T 300 causal
     and not and at T 1024; K5/K5b at 1536, 1100, 96 x 256 and 1750 (its
     bf16 gradients by ``hold_flips``: a ds rounding flip passes where the
     kernel stays within the bf16 rounding bound of the float64 gradient,
     ``grad_bounds``); K5 at Tk 9000; lengths 0, 1 and full; K6 across
     block edges; the bodies the wide paths do not launch timed, K4/K4b
     and K5b bf16 among them, beside SDPA and the bound);
  21. ``wide_heads_8`` and ``wide_heads_32``: the shipped LVTR with 8
     heads of 128, then 32 of 32, at ``CUT_L`` = 8 layers, on the port's
     entry points (``phase_wide_heads``): a warm-up and one timed
     ``LVTRTrainer`` step (16 K3 + 16 K3b each),
     ``LikelihoodEstimator`` over a batch under 1024 frames (8 K3
     float32) and one past it (8 K5), a B 8 continuation on the hybrid
     route with bf16 weights (K1 at the width), int8-weight
     continuations on K2 at the width (B 8 on K2-a8, B 32 on K2-bf16 and
     on K2-w4: exactly 500 launches of the branch, no K1) and per layer
     with K6; each flash kernel and K1 held at its
     call (K3b by ``hold_flips``) and timed beside its plain version,
     SDPA and the bound; the
     new kernel-line entries carry the width in their names;
  22. ``soundstream``: ``scripts/train.py`` -> ``SoundStreamTrainer.fit``
     on a config derived from the shipped encoder block (VQ of 1024 x
     512), float32 with TF32 off, 4 steps at B 8 x 2 x 640 frames over
     synthetic WAVs (no K1-K7 launch), the compact checkpoint resumed by
     a fresh trainer, equal;
  23. ``reconstruction`` (run beside phase 11, on its checkpoint):
     ``ReconstructionEvaluator.run`` with tasks ``f0mse`` and ``mcd`` on
     8 synthetic WAVs of 2-3 s at batch 8, float32, DDIM-100 (no K1-K7
     launch), finite scores, utterances/s;
  24. ``tts_small``: a small LVTTS (the JAX trainer test's sizes, its
     trunk d128 with 4 heads of 32) card against CPU on the forward's loss
     terms and one backward (K3/K3b on the card), then on the card the
     TTS sampler's stacked route against its per-layer route at
     temperature 0 and the ``return_attn`` maps summing to 1;
  25. ``tts_fit``: ``scripts/train.py`` -> ``LVTTSTrainer.fit`` on a
     TTS config derived from ``configs/train/speech/vae-gslm.yaml``
     (``tts_model_config``: the shipped 16-layer d1024 trunk with
     cross-attention of 16 heads, a 6-layer d512 text encoder, the eos
     head and a speaker encoder), 16-mixed, B 8 x accumulation 2 x 640
     frames on 32 synthetic 12 s WAVs with character texts: a warm-up and
     three timed steps, exactly 32 K3 and 32 K3b launches each (the text
     encoder and the cross-attention dense), one profiled step, the
     compact checkpoint with ``symbols.json`` resumed by a fresh trainer,
     equal; 26. ``tts_serve``: ``scripts/infer.py`` -> ``TTSInferer.run``
     on that checkpoint, B 8, at most 10 s (at least 1 s), temperature
     1.0, EOS threshold 0.5, DDIM-100 at eta 0.5: the stacked route, no
     K1-K7 launch, 8 finite ``N.wav``/``N_c.wav`` and ``N.txt``; the
     per-layer route with ``return_attn`` over 50 steps; both routes
     against each other over 50 steps at temperature 0 (float32: lengths
     equal, frames within rtol 1e-3 / atol 1e-4; 16-mixed: the band
     logged).
Output: one line per measurement, then the ``{"kernels": [...]}`` line
(an entry time that CUDA events took, where the profiler recorded no
device operation at all, carries ``ms_source``, ``plain_ms_source`` or
``library_ms_source``: "cuda_events"), the nvidia-smi name/power line,
and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
L, H, D = 16, 16, 64              # flagship trunk: 16 layers, 16 x 64
PROMPT, LENGTH = 150, 500         # 3 s -> 10 s at 50 frames/s
# the trunk depth of the earlier paths cut to keep the whole run inside
# its time limit (the per-layer serving at B 128 and its CLI run, the
# options LVTR, the wide-heads trunks, the token LM); the main serving,
# training, scoring and TTS paths keep the shipped 16 layers
CUT_L = 8
HBM_BYTES_PER_S = 3.35e12         # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS = 0.989e15
FP64_TENSOR_FLOPS = 67e12         # H100 SXM FP64 tensor cores (data sheet)
FP32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> str:
    """ptxas's registers and spill stores of each templated kernel of
    ``text`` (nvcc's -Xptxas -v log), by kernel and head width."""
    import re

    rows, name, spill = [], None, None
    for line in text.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"(_Z\w+)", line)
        if m:
            k = re.search(r"(k\d+b?_[a-z0-9_]+_kernel|flash_decode_kernel)"
                          r"I(?:Lb(\d)E)?Li(\d+)E", m.group(1))
            flag = {"0": "false, ", "1": "true, "}.get(k.group(2), "") \
                if k else ""
            name = (f"{k.group(1)}<{flag}{k.group(3)}>" if k
                    else m.group(1)[-40:])
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name} {m.group(1)} regs"
                        + (f" {spill} B spilled" if spill else ""))
            name, spill = None, None
    return ", ".join(sorted(set(rows)))


def cuda_ms(fn, n: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``n`` calls (CUDA
    events), after one warm-up loop."""
    import torch

    fn(0)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _profiled(fn, n: int, only=()):
    """(name, device microseconds, launches) of each device operation
    that torch.profiler's CUDA activity records over ``n`` calls of
    ``fn``: with ``only``, just the kernels whose names contain one of
    its strings.  The runtime calls that the activity also records
    (launches, synchronizes) are host events and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and (not only or any(s in e.key for s in only))]


def _kernel_name(key: str) -> str:
    """A profiler key without its namespace and argument list."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


def device_ms(fn, n: int, only=(), per_call: int = 0, tries: int = 4
              ) -> float:
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler's CUDA activity (their own durations: host gaps
    between launches are left out), after one warm-up call.  With
    ``only``, just the kernels whose names contain one of its strings.
    On the H100 a window has recorded as few as 6 of 10 launches of one
    kernel, so a window's total over ``n`` can read low.  With
    ``per_call`` (the port's kernels: that many kernels per call, each
    launched once under a name of its own) the time per call is the sum
    of each name's mean recorded duration, and a window must record
    every name, else it is profiled again, up to ``tries`` windows; then
    the run fails.  Without it (plain versions and K2: many launches of
    few names, of which windows have lost a few in thousands or, once,
    5 %), the fuller of two windows' total over ``n``; library calls go
    through ``library_ms``.  Where no window recorded a named kernel,
    ``no_launch_ms`` decides."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    if not per_call:
        evs = max((_profiled(fn, n, only) for _ in range(2)),
                  key=lambda w: sum(c for _, _, c in w))
        if not evs:
            return no_launch_ms(fn, n, only)
        return sum(us for _, us, _ in evs) / 1e3 / n
    seen = []
    for _ in range(tries):
        evs = _profiled(fn, n, only)
        seen.append([c for _, _, c in evs])
        if len(evs) == per_call:
            got = sum(c for _, _, c in evs)
            if got != n * per_call or len(seen) > 1:
                log(f"  (profiler windows recorded {seen} launches per "
                    f"kernel name of {n} calls; the time is the mean of "
                    "the recorded launches)")
            return sum(us / c for _, us, c in evs) / 1e3
    if not any(seen):
        return no_launch_ms(fn, n, only)
    raise AssertionError(f"the profiler windows recorded {seen} launches per "
                         f"kernel name, {per_call} names expected")


class EventsMs(float):
    """A time per call taken by CUDA events (host gaps between launches
    included) where torch.profiler's windows recorded no device operation
    at all; the kernels line marks it (``mark_event_times``)."""


def no_launch_ms(fn, n: int, only=()) -> float:
    """The time per call of ``fn`` where the profiler's windows recorded
    none of the kernels named in ``only`` (or nothing, without it).  If
    one unfiltered window records other device operations, the named
    kernels did not run and the run fails; if it too records nothing
    (seen on the H100 late in a run: ``k5_long`` once, and the streamed
    K3's SDPA call once), the time comes from CUDA events (``cuda_ms``),
    as an ``EventsMs`` and with a log line that says so."""
    others = _profiled(fn, n) if only else []
    if others:
        raise AssertionError(
            f"the profiler recorded no kernel named {list(only)}, but "
            f"{sorted({_kernel_name(k) for k, _, _ in others})} ran")
    ms = EventsMs(cuda_ms(fn, n))
    log(f"  (the profiler's windows recorded no device operation: "
        f"{ms:.4f} ms per call from CUDA events)")
    return ms


def mean_ms(times) -> float:
    """The mean of several times, an ``EventsMs`` if any of them is."""
    ms = statistics.mean(times)
    return EventsMs(ms) if any(isinstance(t, EventsMs) for t in times) \
        else ms


def mark_event_times(entries: list) -> list:
    """Each kernels-line entry with, for every time of it that CUDA events
    took (``EventsMs``), ``<key>_source``: "cuda_events"."""
    for entry in entries:
        for key in ("ms", "plain_ms", "library_ms"):
            if isinstance(entry.get(key), EventsMs):
                entry[key + "_source"] = "cuda_events"
    return entries


def library_ms(fn, n: int, windows: int = 3) -> float:
    """Device ms per call of a library call ``fn`` that launches the same
    kernels on every call: each kernel name's median mean recorded
    duration over ``windows`` profiler windows of ``n`` calls, times its
    launches per call (the most any window recorded, in whole calls).  A
    window that loses launches leaves this as it is, where its total over
    ``n`` reads low (on an H100 80GB HBM3 at 700 W, SDPA at K5's bf16 call
    read 0.27 and 0.34 ms that way, against 0.57 with every launch
    recorded).  Where no window recorded any device operation,
    ``no_launch_ms`` decides."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    means, per_call = {}, {}
    for _ in range(windows):
        for name, us, count in _profiled(fn, n):
            means.setdefault(name, []).append(us / count)
            per_call[name] = max(per_call.get(name, 0), -(-count // n))
    if not means:
        return no_launch_ms(fn, n)
    return sum(statistics.median(means[k]) * per_call[k]
               for k in means) / 1e3


# ------------------------------------------------------------------ K1
def k1_inputs(b: int, dev, seed: int = 0):
    """Random int8 hybrid cache (capacity for the 651-position rollout)
    and bfloat16 q/k/v rows as views of one fused qkv projection, as
    ``decode_hybrid`` hands them to the kernel."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    nb = max((PROMPT + 1 + LENGTH) // 256 * 256, 256) // 256

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02

    cache = (i8(L, nb, b, H, D, 256), i8(L, nb, b, H, D, 256),
             sc(L, nb, b, H, 256), sc(L, nb, b, H, 256),
             i8(L, b, H, 256, D), i8(L, b, H, 256, D),
             sc(L, b, H, 256), sc(L, b, H, 256))
    qkv = torch.randn((b, 3 * H * D), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv.view(b, 3, H, D).unbind(1)
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return cache, q, k, v, slopes


def k1_bytes_ops(b: int, pos: int):
    """Bytes the call must move (each input read once, the output written
    once) and its int8 operations, for this call's valid rows."""
    rows = pos                       # cold + tail rows below pos
    cache_bytes = b * H * rows * (2 * D + 2 * 4)
    io_bytes = 3 * b * H * D * 2 + b * H * D * 4 + H * 4
    ops = 2 * 2 * b * H * rows * D   # QK and PV multiply-adds
    return cache_bytes + io_bytes, ops


# K1's cluster design at the states it makes likely to break: (b, heads,
# head_dim, cold capacity, flushed, pos) -- an empty cold cache at pos 0,
# pos == flushed, more cold blocks than a portable cluster has CTAs (the
# CTAs then own several blocks, and at head_dim 256 stream them through
# a ring), B = 1, and every head_dim the kernel is instantiated for
K1_EDGES = ((8, H, D, 1, 0, 0), (8, H, D, 3, 512, 512), (1, H, D, 3, 256, 400),
            (2, 4, D, 12, 9 * 256, 9 * 256 + 77),
            (2, 4, D, 41, 40 * 256, 40 * 256 + 255),
            (4, 4, 16, 12, 10 * 256, 10 * 256 + 3), (4, 4, 32, 3, 512, 700),
            (4, 4, 128, 10, 9 * 256, 9 * 256 + 100),
            (4, 2, 256, 3, 512, 600), (2, 2, 256, 12, 11 * 256, 11 * 256 + 9))


def k1_edge_inputs(dev, b: int, h: int, d: int, nb: int, seed: int):
    """A random two-layer int8 hybrid cache of ``nb`` cold blocks and
    bfloat16 q/k/v rows as views of one fused projection."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02

    cache = (i8(2, nb, b, h, d, 256), i8(2, nb, b, h, d, 256),
             sc(2, nb, b, h, 256), sc(2, nb, b, h, 256),
             i8(2, b, h, 256, d), i8(2, b, h, 256, d),
             sc(2, b, h, 256), sc(2, b, h, 256))
    qkv = torch.randn((b, 3 * h * d), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv.view(b, 3, h, d).unbind(1)
    return cache, q, k, v, -torch.tensor(alibi_slopes(h), device=dev)


def phase_k1(dev):
    import torch

    from vae_gslm_tpu_torch.ops.fused_decode import (
        fused_decode_attention as k1, fused_decode_attention_plain as plain,
        k1_plan)

    worst = 0.0
    for b, h, d, nb, flushed, pos in K1_EDGES:
        cache, q, k, v, slopes = k1_edge_inputs(dev, b, h, d, nb, pos)
        for li in (0, 1):
            before = k1.launches
            got = k1(q, *cache, pos, li, slopes, k, v, flushed)
            want = plain(q, *cache, pos, li, slopes, k, v, flushed)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = (1e-4 + 1e-3 * want.abs()).sub(
                (got - want).abs()).min().item()
            log(f"K1 check B={b} H={h} head_dim={d} flushed={flushed} "
                f"pos={pos} li={li} ({k1_plan(d, flushed // 256)}): "
                f"max_abs_err={err:.3e}")
            if tol < 0 or not math.isfinite(err) or k1.launches != before + 1:
                raise AssertionError(
                    f"K1 disagrees with its plain version beyond rtol 1e-3 / "
                    f"atol 1e-4, or did not launch once (B={b}, head_dim={d}, "
                    f"flushed={flushed}, pos={pos})")
            worst = max(worst, err)
        del cache, q, k, v
    for b in (8, 32):
        for flushed, pos in ((0, 151), (0, 255), (256, 256), (256, 511),
                             (512, 650)):
            cache, q, k, v, slopes = k1_inputs(b, dev)
            for li in (0, L - 1):
                got = k1(q, *cache, pos, li, slopes, k, v, flushed)
                want = plain(q, *cache, pos, li, slopes, k, v, flushed)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = (1e-4 + 1e-3 * want.abs()).sub(
                    (got - want).abs()).min().item()
                log(f"K1 check B={b} flushed={flushed} pos={pos} li={li}: "
                    f"max_abs_err={err:.3e}")
                if tol < 0 or not math.isfinite(err):
                    raise AssertionError(
                        f"K1 disagrees with its plain version beyond "
                        f"rtol 1e-3 / atol 1e-4 (B={b}, pos={pos})")
                worst = max(worst, err)
    # Times over the main path's cache states at B = 8: every 50th
    # position of the 151 -> 650 rollout; the layer index cycles so the
    # 16-layer cache (> L2) is read cold, as in the pipeline.  The
    # kernel's and the plain version's device times come from the
    # profiler; the time per call with the wrapper's host work (checks,
    # pointers, launch) from CUDA events around back-to-back calls.
    ks, calls, ps, bs = [], [], [], []
    for pos in range(PROMPT + 1, PROMPT + 1 + LENGTH, 50):
        flushed = pos // 256 * 256
        cache, q, k, v, slopes = k1_inputs(8, dev, seed=pos)

        def kernel(i):
            return k1(q, *cache, pos, i % L, slopes, k, v, flushed)

        ks.append(device_ms(kernel, n=200, only=("fused_decode_kernel",),
                            per_call=1))
        calls.append(cuda_ms(kernel, n=200))
        ps.append(device_ms(lambda i: plain(q, *cache, pos, i % L, slopes, k,
                                            v, flushed), n=10))
        nbytes, ops = k1_bytes_ops(8, pos)
        bs.append(max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3)
        log(f"K1 time B=8 pos={pos}: kernel {ks[-1] * 1e3:.2f} us, "
            f"{calls[-1] * 1e3:.2f} us per call with the wrapper, plain "
            f"{ps[-1] * 1e3:.2f} us, bound {bs[-1] * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB)")
    log(f"K1 mean over the rollout: kernel {statistics.mean(ks) * 1e3:.2f} "
        f"us, {statistics.mean(calls) * 1e3:.2f} us per call with the "
        f"wrapper, plain {statistics.mean(ps) * 1e3:.2f} us, bound "
        f"{statistics.mean(bs) * 1e3:.2f} us")
    log("K1 library_ms: null (no single PyTorch call computes this "
        "int8-requantized attention over the cold/tail cache)")
    return {"name": "fused_decode_attention", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/fused_decode.cu",
            "replaces": "vae_gslm_tpu/ops/fused_decode.py:229",
            "launches": None, "max_abs_err": worst,
            "ms": mean_ms(ks), "plain_ms": mean_ms(ps),
            "bound_ms": statistics.mean(bs), "bound_by": "bytes",
            "library_ms": None}


# ------------------------------------------------------------------ K2
K2_CASES = ((128, 151), (128, 255), (256, 256), (384, 500), (640, 650))
# the rollout's states and a full tail with an empty stage (flushed + 128)
K2_STATES = K2_CASES + ((512, 640),)


def k2_inputs(b: int, dev, seed: int = 0, h: int = H):
    """Random int8 weights of the flagship trunk (column scales of a
    uniform(+-1/sqrt(din)) init), a random three-tier cache with room for
    the 651-position rollout (``h`` heads of d1024 / h), and a residual
    row x."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops.mega_step import BLK, STAGE, TAIL

    g = torch.Generator(dev).manual_seed(seed)
    d = H * D
    dh = d // h
    nb = (PROMPT + 1 + LENGTH) // BLK + 1

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    weights = {}
    for w, s, din, dout in (("wq", "sq", d, 3 * d), ("wo", "so", d, d),
                            ("w1", "s1", d, 4 * d), ("w2", "s2", 4 * d, d)):
        weights[w] = i8(L, din, dout)
        weights[s] = u(L, dout, lo=0.5, hi=1.0) / (127 * math.sqrt(din))
    weights["n1"] = u(L, d, lo=0.8, hi=1.2)
    weights["n3"] = u(L, d, lo=0.8, hi=1.2)
    for name, n in (("bq", 3 * d), ("bo", d), ("b1", 4 * d), ("b2", d)):
        weights[name] = torch.zeros((L, n), device=dev)
    cache = {
        "k_cold": i8(L, nb, h, b, dh, BLK),
        "v_cold": i8(L, nb, h, b, dh, BLK),
        "kc_scale": u(L, nb, h, b, BLK, hi=0.02),
        "vc_scale": u(L, nb, h, b, BLK, hi=0.02),
        "k_tail": i8(L, h, b, TAIL, dh), "v_tail": i8(L, h, b, TAIL, dh),
        "kt_scale": u(L, h, b, TAIL, hi=0.02),
        "vt_scale": u(L, h, b, TAIL, hi=0.02),
        "k_stage": (torch.randn((L, STAGE, h, b, dh), generator=g,
                                device=dev) * 0.3).to(torch.bfloat16),
        "v_stage": (torch.randn((L, STAGE, h, b, dh), generator=g,
                                device=dev) * 0.3).to(torch.bfloat16),
    }
    x = torch.randn((b, d), generator=g, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    return x, weights, cache, slopes


def k2_bytes_ops(b: int, pos: int, flushed: int, a8: bool, group: int = 0,
                 h: int = H):
    """Bytes one call must move (int8 weights and their float32 vectors,
    the valid cache rows of every layer, x in and out, the new K/V rows)
    and its operations (dense multiply-adds; QK and PV over the valid
    rows), and the card's peak rate for their type.  With ``group``
    (K2-w4): nibble-packed weights and their float32 group scales in
    place of the int8 weights and column scales; s8 x s8 products.  At
    ``h`` heads of d1024 / h (the cache bytes and QK/PV operations do not
    depend on the split)."""
    d = H * D
    dh = d // h
    stage_base = pos - (pos - flushed) % 8
    weight_bytes = L * (12 * d * d + 4 * (2 * 9 * d + 2 * d))
    if group:
        weight_bytes = L * (6 * d * d + 4 * 12 * d * d // group
                            + 4 * (9 * d + 2 * d))
    rows_i8 = stage_base                      # cold + merged tail rows
    rows_bf16 = pos - stage_base              # stage rows
    cache_bytes = L * b * h * (rows_i8 * 2 * (dh + 4) + rows_bf16 * 4 * dh)
    io_bytes = 2 * b * d * 4 + 2 * L * h * b * dh * 2 + h * 4
    ops = 2 * b * L * 12 * d * d + L * b * h * 4 * dh * (pos + 1)
    peak = INT8_OPS_PER_S if a8 or group else BF16_FLOPS
    return weight_bytes + cache_bytes + io_bytes, ops, peak


def k2_check(where: str, dev, b: int, weights, x, cache, slopes,
             a8: bool, counter: str, states=K2_STATES) -> float:
    """The kernel against its plain version at each cache state, at
    max |diff| <= 2e-3 |want| + 2e-4, each call one launch counted under
    ``counter``.  Returns the largest abs error."""
    import torch

    from vae_gslm_tpu_torch.ops.mega_step import (
        fused_trunk_step as k2, fused_trunk_step_plain as plain)

    worst = 0.0
    for flushed, pos in states:
        before = getattr(k2, counter)
        got = k2(x, weights, cache, pos, slopes, flushed, a8=a8)
        want = plain(x, weights, cache, pos, slopes, flushed, a8=a8)
        torch.cuda.synchronize()
        if getattr(k2, counter) != before + 1:
            raise AssertionError(f"{where}: the call did not count once "
                                 f"under {counter}")
        errs = []
        for name, gt, wt in zip(("x", "k_new", "v_new"), got, want):
            gt, wt = gt.float(), wt.float()
            diff = (gt - wt).abs()
            errs.append(diff.max().item())
            slack = (2e-4 + 2e-3 * wt.abs() - diff).min().item()
            if slack < 0 or not math.isfinite(errs[-1]):
                raise AssertionError(
                    f"{where} {name} disagrees with its plain version beyond "
                    f"rtol 2e-3 / atol 2e-4 (B={b}, flushed={flushed}, "
                    f"pos={pos}): max abs {errs[-1]:.3e}")
        log(f"{where} check B={b} flushed={flushed} pos={pos}: max_abs_err x "
            f"{errs[0]:.3e}, k_new {errs[1]:.3e}, v_new {errs[2]:.3e}")
        worst = max(worst, *errs)
    return worst


def k2_one_launch(where: str, fn, kernel: str) -> None:
    """A profiler window around one call records one launch of ``kernel``
    and no other kernel, beside the memset that zeroes its scratch words
    (a window that recorded nothing is taken again, up to 10 windows:
    windows lose launches, and four empty ones in a row were seen).  If
    all ten lose it (seen at ``k2_bf16_step_kernel<128>``), windows of 5
    calls must record this kernel alone, between 1 and 5 launches: at
    most one a call."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    n = 1
    for tries in (10, 4):
        for _ in range(tries):
            evs = [(k, c) for k, _, c in _profiled(fn, n)
                   if not k.startswith("Memset")]
            if evs:
                break
        if evs:
            break
        n = 5
    if len(evs) != 1 or kernel not in evs[0][0] or not 1 <= evs[0][1] <= n:
        raise AssertionError(f"{where}: {n} call(s) launched {evs}, not one "
                             f"{kernel} a call")
    if n == 1:
        log(f"{where}: one call is one launch of {_kernel_name(evs[0][0])} "
            "(torch.profiler)")
    else:
        log(f"{where}: {n} calls recorded {evs[0][1]} launches of "
            f"{_kernel_name(evs[0][0])} and no other kernel (torch.profiler;"
            " ten one-call windows recorded none)")


def k2_times(where: str, dev, b: int, weights, x, cache, slopes, a8: bool,
             group: int, kernel: str, h: int = H,
             positions=(PROMPT + 1 + 200,)) -> tuple:
    """Kernel, wrapper, plain and bound times over ``positions`` (by
    default position 351, the middle of the 150 -> 650 rollout: on an
    H100 each branch's mean over the five positions 151-551 read within
    2.1 % of it, and was cut for time).  Returns the means (ms)."""
    from vae_gslm_tpu_torch.ops.mega_step import (
        fused_trunk_step as k2, fused_trunk_step_plain as plain)

    ks, calls, ps, bs = [], [], [], []
    for pos in positions:
        flushed = pos // 128 * 128

        def kernel_call(i):
            return k2(x, weights, cache, pos, slopes, flushed, a8=a8)

        ks.append(device_ms(kernel_call, n=20, only=(kernel,), per_call=1))
        calls.append(cuda_ms(kernel_call, n=20, reps=3))
        ps.append(device_ms(lambda i: plain(x, weights, cache, pos, slopes,
                                            flushed, a8=a8), n=2))
        nbytes, ops, peak = k2_bytes_ops(b, pos, flushed, a8, group, h)
        bs.append(max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3)
        log(f"{where} time B={b} pos={pos}: kernel {ks[-1] * 1e3:.1f} us, "
            f"{calls[-1] * 1e3:.1f} us per call with the wrapper, plain "
            f"{ps[-1] * 1e3:.1f} us, bound {bs[-1] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB)")
    out = tuple(statistics.mean(v) for v in (ks, calls, ps, bs))
    log(f"{where} mean over {len(ks)} position(s) (B={b}): kernel "
        f"{out[0] * 1e3:.1f} "
        f"us, {out[1] * 1e3:.1f} us per call with the wrapper, plain "
        f"{out[2] * 1e3:.1f} us, bound {out[3] * 1e3:.1f} us")
    return out


def k2_phase_lines(where: str, dev, weights_for, batches, a8: bool,
                   h: int = H) -> None:
    """The step's phases (block 0's global timer, each phase's grid
    barrier included; mean of 3 steps) at position 351 for each batch,
    on one line."""
    from vae_gslm_tpu_torch.ops import mega_step

    pos = PROMPT + 1 + 200                   # 351, as mega_ab.py
    flushed = pos // 128 * 128
    by_b = []
    for b in batches:
        x, weights, cache, slopes = k2_inputs(b, dev, seed=2, h=h)
        weights = weights_for(weights)
        ph = [mega_step.step_phases(x, weights, cache, pos, slopes, flushed,
                                    a8=a8) for _ in range(4)][1:]
        by_b.append(f"B={b} " + " ".join(
            f"{k} {statistics.mean(p[k] for p in ph):.2f}" for k in ph[0]))
        del x, cache
    log(f"{where} pos={pos} phases by batch (us a layer, tail and total "
        "us): " + "; ".join(by_b))


def phase_k2(dev):
    """K2 on int8 weights against its plain version at the flagship width
    (B = 1, 2 and 8 with the s8 x s8 products, one persistent launch a
    call; B = 17 and 32 with bf16 products, the other persistent kernel)
    over the rollout's cache states and a full tail; one call of each
    branch one launch (torch.profiler); the a8 times at B = 8 and the
    bf16 times at B = 32 (the CLI's chunks) at the rollout's position 351,
    beside the bytes bound (and, for bf16, the FP64 tensor cores' rate for
    its exact float64 sums); the phase lines by batch; one grid barrier
    alone.  Returns the K2-a8 and K2-bf16 entries."""
    from vae_gslm_tpu_torch.ops import mega_step

    worst = {True: 0.0, False: 0.0}
    for b, a8 in ((1, True), (2, True), (8, True), (17, False),
                  (32, False)):
        x, weights, cache, slopes = k2_inputs(b, dev, seed=b)
        worst[a8] = max(worst[a8], k2_check(
            "K2-a8" if a8 else "K2-bf16", dev, b, weights, x, cache, slopes,
            a8, "launches" if a8 else "launches_bf16"))
        if b in (8, 32):
            k2_one_launch(f"K2-{'a8' if a8 else 'bf16'} B={b}", lambda i: (
                mega_step.fused_trunk_step(x, weights, cache, 351, slopes,
                                           256, a8=a8)),
                "k2_i8_step_kernel" if a8 else "k2_bf16_step_kernel")
        del x, weights, cache
    # K2-a8 at B = 8 at the main path's position 351
    x, weights, cache, slopes = k2_inputs(8, dev, seed=1)
    ms, call_ms, plain_ms, bound = k2_times(
        "K2-a8", dev, 8, weights, x, cache, slopes, True, 0,
        "k2_i8_step_kernel")
    plan = mega_step.step_plan_for(8, H * D, H, dev, a8=True)
    log(f"K2-a8 plan B=8: {plan.grid} blocks x {mega_step.STEP_THREADS} "
        f"threads, {plan.bytes} bytes of shared memory each, splits "
        f"{plan.splits}, tiles per piece {plan.tp}")
    log("K2 library_ms: null (no single PyTorch call computes a whole "
        "int8-weight trunk step)")
    a8_entry = {"name": "fused_trunk_step", "route": "cuda",
                "source": "vae_gslm_tpu_torch/csrc/mega_step.cu",
                "replaces": "vae_gslm_tpu/ops/mega_step.py:427",
                "launches": None, "max_abs_err": worst[True],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": None}
    del x, weights, cache
    k2_phase_lines("K2-a8", dev, lambda w: w, (1, 8), True)
    # the bf16 branch at B = 32 (the CLI's chunks), as K2-a8's
    x, weights, cache, slopes = k2_inputs(32, dev, seed=2)
    ms, call_ms, plain_ms, bound = k2_times(
        "K2-bf16", dev, 32, weights, x, cache, slopes, False, 0,
        "k2_bf16_step_kernel")
    plan = mega_step.step_plan_for(32, H * D, H, dev)
    fp64 = 2 * 32 * L * 12 * (H * D) ** 2 / FP64_TENSOR_FLOPS * 1e3
    del x, weights, cache
    k2_phase_lines("K2-bf16", dev, lambda w: w, (1, 17, 32), False)
    n_bar = 1000
    bar_us = cuda_ms(lambda i: mega_step.barrier_probe(n_bar, 32, H * D, H,
                                                       dev), n=5) * 1e3
    log(f"K2-bf16: one cooperative launch of {plan.grid} blocks x "
        f"{mega_step.STEP_THREADS} threads, {plan.bytes} bytes of shared "
        f"memory each; the exact float64 sums' FP64 tensor-core ceiling "
        f"{fp64 * 1e3:.1f} us; a grid barrier alone {bar_us / n_bar:.2f} us "
        f"({n_bar} in one probe launch), {5 * L - 1} per bf16 step, "
        f"{8 * L} per a8/w4 step")
    bf16_entry = {"name": "fused_trunk_step_bf16", "route": "cuda",
                  "source": "vae_gslm_tpu_torch/csrc/mega_step.cu",
                  "replaces": "vae_gslm_tpu/ops/mega_step.py:427",
                  "launches": None, "max_abs_err": worst[False],
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": "bytes", "library_ms": None}
    return a8_entry, bf16_entry


def phase_k2_w4(dev):
    """K2-w4 (the nibble-packed int4 branch, one persistent launch a call)
    against its plain version at the flagship width over the rollout's
    cache states and a full tail: at B = 8 and 32 with group 128 (the
    CLI's chunks under ``VAE_GSLM_MEGA_W4=1``) and at B = 32 with group 64
    (its ``=64`` setting), at K2's tolerance; the w4 weights built by the
    port's ``pack_mega_w4`` on the card from ``k2_inputs``' int8 weights
    and held bitwise equal to the same build on the CPU.
    Then one call one launch, its times at B = 32, group 128 over the
    CLI's position 351, and the phase lines at B = 9, 17, 32."""
    import torch

    from vae_gslm_tpu_torch.nn.transformer import pack_mega_w4
    from vae_gslm_tpu_torch.ops import mega_step

    def w4_weights(weights, group):
        w4 = pack_mega_w4(weights, group, D)
        cpu = pack_mega_w4({k: v.cpu() for k, v in weights.items()}, group,
                           D)
        for k in cpu:
            a, b = w4[k].cpu(), cpu[k]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"the card's w4 build of {k} (group "
                                     f"{group}) differs from the CPU's")
        mb = sum(v.numel() * v.element_size() for k, v in w4.items()
                 if k[0] in "wg") / 1e6
        log(f"K2-w4 build group={group}: card and CPU bitwise equal "
            f"({mb:.1f} MB of packed weights and group scales)")
        return w4

    worst = 0.0
    for b, group in ((8, 128), (32, 128), (32, 64)):
        x, weights, cache, slopes = k2_inputs(b, dev, seed=b)
        w4 = w4_weights(weights, group)
        del weights
        worst = max(worst, k2_check(f"K2-w4 group={group}", dev, b, w4, x,
                                    cache, slopes, False, "launches_w4"))
        if b == 32 and group == 128:
            k2_one_launch("K2-w4 B=32", lambda i: mega_step.fused_trunk_step(
                x, w4, cache, 351, slopes, 256), "k2_i8_step_kernel")
        del x, w4, cache
    # the CLI's calls: B = 32, group 128, at position 351
    x, weights, cache, slopes = k2_inputs(32, dev, seed=32)
    w4 = pack_mega_w4(weights, 128, D)
    del weights
    ms, call_ms, plain_ms, bound = k2_times(
        "K2-w4", dev, 32, w4, x, cache, slopes, False, 128,
        "k2_i8_step_kernel")
    plan = mega_step.step_plan_for(32, H * D, H, dev, group=128)
    log(f"K2-w4 plan B=32 group=128: {plan.grid} blocks x "
        f"{mega_step.STEP_THREADS} threads, {plan.bytes} bytes of shared "
        f"memory each, splits {plan.splits}, tiles per piece {plan.tp}")
    del x, w4, cache
    k2_phase_lines("K2-w4", dev, lambda w: pack_mega_w4(w, 128, D),
                   (9, 17, 32), False)
    log("K2-w4 library_ms: null (no single PyTorch call computes a whole "
        "int4-weight trunk step)")
    return {"name": "fused_trunk_step_w4", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/mega_step.cu",
            "replaces": "vae_gslm_tpu/ops/mega_step.py:143",
            "launches": None, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


# ------------------------------------------------ K2 at head widths
K2_WIDTHS = ((8, 128), (32, 32))  # (heads, head_dim) at d1024 beside 16 x 64


def phase_k2_widths(dev) -> dict:
    """K2's instantiations at head widths 128 (8 heads; one K/V buffer an
    attention group) and 32 (32 heads) against their plain version at
    d1024 over the rollout's cache states and a full tail
    (``K2_STATES``), at K2's tolerance, each call counted once under its
    branch: a8 at B 1, 2 and 8, bf16 at B 17 and 32, w4 at B 32 with
    group 128 (and group 64 at width 32: a group is a multiple of the
    width); one call of each branch one launch (torch.profiler); the
    a8 times at B 8 and the bf16 and w4 (group 128) times at B 32 at the
    rollout's middle position (351; the D = 64 rows time five, which
    ``phase_k2`` keeps) beside the plain version and the bytes bound, and
    each plan (grid, shared bytes, splits).  Returns the
    kernel-line entries by (branch, head_dim), launches to be filled by
    the rollouts of ``phase_wide_heads``."""
    from vae_gslm_tpu_torch.nn.transformer import pack_mega_w4
    from vae_gslm_tpu_torch.ops import mega_step

    k2 = mega_step.fused_trunk_step
    kernels = {"a8": "k2_i8_step_kernel", "bf16": "k2_bf16_step_kernel",
               "w4": "k2_i8_step_kernel"}
    counters = {"a8": "launches", "bf16": "launches_bf16",
                "w4": "launches_w4"}
    names = {"a8": "fused_trunk_step", "bf16": "fused_trunk_step_bf16",
             "w4": "fused_trunk_step_w4"}
    replaces = {"a8": "vae_gslm_tpu/ops/mega_step.py:427",
                "bf16": "vae_gslm_tpu/ops/mega_step.py:427",
                "w4": "vae_gslm_tpu/ops/mega_step.py:143"}
    entries = {}
    for h, dh in K2_WIDTHS:
        cases = [("a8", 1, 0), ("a8", 2, 0), ("a8", 8, 0), ("bf16", 17, 0),
                 ("bf16", 32, 0), ("w4", 32, 128)]
        if dh <= 64:
            cases.append(("w4", 32, 64))
        worst = {}
        for branch, b, group in cases:
            x, weights, cache, slopes = k2_inputs(b, dev, seed=b + h, h=h)
            if group:
                weights = pack_mega_w4(weights, group, dh)
            tag = f"K2-{branch} head_dim {dh}" + (f" group={group}"
                                                  if group else "")
            worst[branch] = max(worst.get(branch, 0.0), k2_check(
                tag, dev, b, weights, x, cache, slopes, branch == "a8",
                counters[branch]))
            if (branch, b) in (("a8", 8), ("bf16", 32)) or (
                    branch == "w4" and group == 128):
                k2_one_launch(f"{tag} B={b}", lambda i: k2(
                    x, weights, cache, 351, slopes, 256, a8=branch == "a8"),
                    kernels[branch])
            del x, weights, cache
        for branch, b in (("a8", 8), ("bf16", 32), ("w4", 32)):
            group = 128 if branch == "w4" else 0
            x, weights, cache, slopes = k2_inputs(b, dev, seed=7, h=h)
            if group:
                weights = pack_mega_w4(weights, group, dh)
            tag = f"K2-{branch} head_dim {dh}"
            ms, _, plain_ms, bound = k2_times(
                tag, dev, b, weights, x, cache, slopes, branch == "a8",
                group, kernels[branch], h=h, positions=(PROMPT + 1 + 200,))
            plan = mega_step.step_plan_for(b, H * D, h, dev,
                                           a8=branch == "a8", group=group)
            log(f"{tag} plan B={b}: {plan.grid} blocks x "
                f"{mega_step.STEP_THREADS} threads, {plan.bytes} bytes of "
                "shared memory each (an attention group's scratch "
                f"{mega_step.group_smem(dh)} bytes, "
                f"{mega_step.kv_buffers(dh)} K/V buffer(s))"
                + (f", splits {plan.splits}, tiles per piece {plan.tp}"
                   if branch != "bf16" else f", weight slots {plan.slot}"))
            del x, weights, cache
            entries[(branch, dh)] = {
                "name": f"{names[branch]} (head_dim {dh}, {h} heads: "
                        f"{kernels[branch]}<" + {"a8": "false, ", "w4":
                                                  "true, "}.get(branch, "")
                        + f"{dh}>)",
                "route": "cuda",
                "source": "vae_gslm_tpu_torch/csrc/mega_step.cu",
                "replaces": replaces[branch], "launches": None,
                "max_abs_err": worst[branch], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": None}
        k2_phase_lines(f"K2-a8 head_dim {dh}", dev, lambda w: w, (8,), True,
                       h=h)
        k2_phase_lines(f"K2-bf16 head_dim {dh}", dev, lambda w: w, (32,),
                       False, h=h)
    return entries


# -------------------------------------------------------------- K3/K3b
K3_B, K3_T = 8, 640               # the training micro-batch
K3_KERNELS = ("k3_fwd", "k3b_dkv", "k3b_dq")   # kernel name prefixes
K3_LENGTHS = [640, 320, 300, 640, 1, 639, 512, 64]
# bf16 K3/K4 checks at the largest resident key sets (16 tiles at 1024)
K3_LONG = ((4, 1000, 4, [1000, 0, 1, 611]), (4, 1024, 4, [1024, 1, 0, 700]))
K3_F32_EDGES = ((3, 37, 2, [37, 0, 1]), (2, 100, 2, [100, 1]),
                (2, 1000, 4, [1000, 1]))


def k3_inputs(dtype, dev, seed: int = 0, b: int = K3_B, t: int = K3_T,
              h: int = H, lengths=K3_LENGTHS):
    """q/k/v as views of one (B, T, 3 H D) projection, dO, lengths and
    the port's ALiBi slopes."""
    import torch

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * D), generator=g, device=dev).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    do = torch.randn((b, t, h * D), generator=g, device=dev).to(dtype)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    return q, k, v, do, lengths, slopes


def k3_bytes_ops(itemsize: int, b: int = K3_B, t: int = K3_T,
                 lengths=K3_LENGTHS, h: int = H, d: int = D):
    """Bytes and FLOPs of one K3 call and of K3b's two kernels (the
    timed part: ``delta`` comes in computed) on the inputs of
    ``k3_inputs``.  Bytes: each input read once, each output written
    once, key and value rows only below each batch row's length (a row
    of length 0 reads all T): K3 reads q, k, v and writes o, lse; K3b
    reads q, k, v, dO, lse, delta and writes dq, dk, dv.  FLOPs: the
    (query, key) pairs this run's causal and length masks leave, 2 D per
    pair and product: 2 products forward (QK, PV), 5 backward (QK, dO V,
    dS K, dS^T Q, P^T dO), at ``h`` heads of ``d``."""
    row = h * d * itemsize
    n = b * t * row                          # one full (B, T, H D) tensor
    n_kv = sum(ln if ln >= 1 else t for ln in lengths) * row
    stats = b * h * t * 4                    # lse or delta, float32
    small = b * 4 + h * 4
    rows = sum(sum(min(r + 1, ln) if ln >= 1 else t
                   for r in range(t)) for ln in lengths)
    pairs = h * rows
    return ((2 * n + 2 * n_kv + stats + small, 2 * 2 * pairs * d),
            (5 * n + 2 * n_kv + 2 * stats + small, 5 * 2 * pairs * d))


def sdpa_mask(lengths, slopes, dtype, dev, tq: int = K3_T, tk: int = K3_T,
              causal: bool = True):
    """The explicit float mask (ALiBi + length, causal or not) that makes
    ``scaled_dot_product_attention`` compute the flash kernels'
    function."""
    import torch

    q_pos = torch.arange(tq, device=dev)
    k_pos = torch.arange(tk, device=dev)
    bias = slopes[:, None, None] * (k_pos[None, :]
                                    - q_pos[:, None]).abs()[None]
    valid = k_pos[None, None, None, :] < lengths[:, None, None, None]
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])[None, None]
    return torch.where(valid, bias[None], float("-inf")).to(dtype)


def sdpa_bwd_ms(q, k, v, do, mask) -> float:
    """Device ms of SDPA's backward alone (float mask): one
    ``torch.autograd.grad`` call on a retained forward graph, the
    library call that computes a backward kernel's function."""
    import torch
    import torch.nn.functional as F

    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    ms = library_ms(lambda i: torch.autograd.grad(out, (q, k, v), do,
                                                  retain_graph=True), n=10)
    del out
    return ms


def ulp_bf16(x):
    """One bfloat16 unit in the last place of each |x| (0 where x is 0)."""
    import torch

    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def hold(where: str, name: str, got, want, tol: float, floor: float,
         bf16: bool):
    """Fails unless max |diff| <= tol x max(floor, max|ref|) and, for a
    bf16 output other than lse, |diff| <= 2 bf16 ulps of |ref| + tol x
    rms(ref) element by element and ||diff|| <= 1e-3 ||ref||: a length-1
    row makes one dv row the sum of all T dO rows, whose max |ref| alone
    would let a wrong entry elsewhere through.  Returns the max |diff|
    and its log text."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    ref = max(floor, want.abs().max().item())
    text = f"{name} {err:.3e}"
    if not err <= tol * ref:
        raise AssertionError(f"{name} disagrees with its plain version: max "
                             f"abs {err:.3e} > {tol} x {ref:.3e} ({where})")
    if bf16 and name != "lse":
        rms = want.pow(2).mean().sqrt().item()
        excess = (diff - 2 * ulp_bf16(want)).clamp_min(0).max().item() / rms
        rel = (diff.norm() / want.norm()).item()
        text += f" ({excess:.1e} rms past 2 ulp, L2 {rel:.1e})"
        if not (excess <= tol and rel <= 1e-3):
            raise AssertionError(
                f"{name} disagrees with its plain version: {excess:.3e} x "
                f"rms(ref) past 2 bf16 ulps (limit {tol}), relative L2 "
                f"{rel:.3e} (limit 1e-3) ({where})")
    return err, text


def grad_bounds(q, k, v, o, g, lse, lengths, slopes, causal: bool,
                nheads=None):
    """The float64 gradients (dq, dk, dv) of a bf16 flash backward's
    inputs, and for each element a bound on its distance from them that
    holds for any implementation that rounds p and ds to bfloat16 (to
    nearest) and sums in float32, as K3b/K4b/K5b and their plain versions
    do: the rounding of every ds (p for dv) that sums into the element,
    the float32 errors of the logits, of p (ex2.approx, the row
    statistics), of dP = dO V^T and of delta = rowsum(dO O), and the
    output's rounding, with unit roundoffs 2^-8 (bf16) and 2^-22 (four
    times float32's, for the tensor cores' accumulation).  ``lse`` as K3b
    and K4b take it, None for K5b (its own row statistics); packed (B, T,
    H D) operands with ``nheads``, else (B, H, T, D).  One ds that the
    kernel and the plain version round the two ways moves an element by
    up to a bf16 ulp of its largest term, past ``hold``'s element-wise
    limit where those terms cancel; the bound is what such an element is
    held to."""
    import math

    import torch

    from vae_gslm_tpu_torch.ops import flash_attention as fa

    def heads(x):
        return (fa._heads(x, nheads) if nheads else x).double()

    def gamma(n):
        return n * e32 / (1 - n * e32)

    u, e32 = 2.0 ** -8, 2.0 ** -22
    qh, kh, vh, gh, oh = (heads(x) for x in (q, k, v, g, o))
    s, _ = fa._logits(qh, kh, lengths, slopes, causal)
    live = s > fa.NEG_INF / 2
    if lse is None:     # a row with no key: p = 1 / Tk, as the softmax
        p = torch.softmax(s, -1)
        norm = torch.logsumexp(s, -1, keepdim=True)
    else:       # a row with no key: p as float32 gives it, s - lse = 0
        norm = lse.double()[..., None]
        p = torch.where(live, torch.exp(s - norm),
                        torch.exp(s.float() - lse.float()[..., None]).double())
    d, tq, tk = qh.shape[-1], s.shape[-2], s.shape[-1]
    scale = 1.0 / math.sqrt(d)
    aq, ak, av, ag, ao = (x.abs() for x in (qh, kh, vh, gh, oh))
    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    # relative error of p: the logit (a D-term dot product, the scale,
    # the slope term), the exponent and ex2.approx, the row statistics
    eps_p = torch.where(
        live, gamma(d + 3) * (2 * scale * (aq @ t(ak)) + s.abs())
        + 4 * e32 * ((s - norm).abs() + norm.abs()) + 2.0 ** -20
        + gamma(tk), 0.0)
    dp, delta = gh @ t(vh), (gh * oh).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    e_ds = p * (gamma(d + 4) * (ag @ t(av) + (ag * ao).sum(-1, keepdim=True))
                + (eps_p + gamma(4)) * (dp - delta).abs())
    e_ds = e_ds + u * (ds.abs() + e_ds)             # ds rounded to bf16
    e_p = p * eps_p
    e_p = e_p + u * (p + e_p)                       # p rounded to bf16
    exact = (scale * (ds @ kh), scale * (t(ds) @ qh), t(p) @ gh)
    bounds = (scale * (e_ds @ ak + gamma(tk + 1) * ((ds.abs() + e_ds) @ ak)),
              scale * (t(e_ds) @ aq
                       + gamma(tq + 1) * (t(ds.abs() + e_ds) @ aq)),
              t(e_p) @ ag + gamma(tq + 1) * (t(p + e_p) @ ag))
    out = []
    for x, bound in zip(exact, bounds):
        bound = bound + u * (x.abs() + bound)       # the output's rounding
        out.append((fa._packed(x), fa._packed(bound)) if nheads
                   else (x, bound))
    return tuple(x for x, _ in out), tuple(bd for _, bd in out)


def hold_flips(where: str, name: str, got, want, exact, bound, tol: float):
    """``hold``'s bf16 gate for a gradient (max |diff| <= tol x max|ref|,
    relative L2 <= 1e-3, and element by element |diff| <= 2 bf16 ulps of
    |ref| + tol x rms(ref)), except that an element past that limit
    passes where the kernel there is within ``bound`` of the float64
    gradient ``exact`` (``grad_bounds``): a ds that the kernel and the
    plain version round the two ways (on the trunk's own activations,
    K3b at 8 x 128 heads; K5b at 1750 frames with ALiBi at D = 128).
    Returns the max |diff| and its log text."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    err = diff.max().item()
    ref = want.abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    past = diff > 2 * ulp_bf16(want) + tol * rms
    far = (got - exact).abs() > bound
    norm = want.norm().item()
    rel = diff.norm().item() / norm if norm else (0.0 if not err else 1.0)
    excess = (diff - 2 * ulp_bf16(want)).clamp_min(0).max().item() / (
        rms or 1.0)
    plain_far = int(((want - exact).abs() > bound).sum())
    text = (f"{name} {err:.3e} ({excess:.1e} rms past 2 ulp, L2 {rel:.1e}; "
            f"{int(past.sum())} past the element-wise limit, "
            f"{int((past & far).sum())} of them past the rounding bound; "
            f"plain version past it at {plain_far})")
    if not (err <= tol * ref and rel <= 1e-3 and not (past & far).any()):
        raise AssertionError(
            f"{name} disagrees with its plain version: max abs {err:.3e} "
            f"(limit {tol} x {ref:.3e}), relative L2 {rel:.3e} (limit "
            f"1e-3), {int((past & far).sum())} elements past {tol} x "
            f"rms(ref) + 2 bf16 ulps and past the rounding bound of the "
            f"float64 gradient ({where})")
    return err, text


def in_chunks(fn, b: int, step: int):
    """``fn(rows)`` over slices of ``step`` batch rows, the outputs joined
    along the batch (tuples element by element): the plain versions'
    (B, H, T, T) logits at the scoring batch of 64 would take tens of
    GB at once."""
    import torch

    outs = [fn(slice(i, i + step)) for i in range(0, b, step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def phase_k3(dev):
    """K3 (o, lse) and K3b (dq, dk, dv) against their plain versions at
    the training shapes (B 8, T 640, 16 heads of 64) and at T 200 (a
    partial last tile), float32 and bfloat16, and in bfloat16 at T 1000
    and 1024 (lengths 0 and 1 among them: the bf16 forward's largest
    resident key sets), with ALiBi and without; K3 float32 at the
    scoring path's shape (B 64, the short batch's padded length and
    lengths) and its time there beside SDPA's (float32, float mask) and
    the bound; then K3/K3b's bf16 times beside the plain versions',
    SDPA's (K3: its forward and the ratio; K3b: its backward alone, and
    forward+backward) and the bound; in bf16 K3b is ``bwd_wgmma``
    (``k3b_dq_wgmma_kernel`` then ``k3b_dkv_wgmma_kernel``).  Every output
    is held by ``hold`` at tol x max|ref| (tol 1e-5 on f32 o and lse,
    1e-4 on f32 gradients, bf16: 1e-2 on o, 1e-5 on lse, 2e-2 on
    gradients), a bf16 o, dq, dk or dv also element by element and in
    relative L2."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.ops.flash_attention import (
        flash_backward_packed as k3b, flash_backward_packed_plain as k3b_plain,
        flash_forward_packed as k3, flash_forward_packed_plain as k3_plain)

    worst_f, worst_b = 0.0, 0.0
    shapes = ((K3_B, K3_T, H, K3_LENGTHS), (4, 200, 2, [200, 77, 1, 130]))
    cases = list(itertools.product(shapes, (torch.float32, torch.bfloat16)))
    # the bf16 forward's largest resident K: T 1000 and 1024
    cases += [(shape, torch.bfloat16) for shape in K3_LONG]
    # the float32 forward below one 128-row query tile and at a ragged T
    cases += [(shape, torch.float32) for shape in K3_F32_EDGES]
    for (b, t, h, lengths), dtype in cases:
        bf16 = dtype == torch.bfloat16
        q, k, v, do, lengths, slopes = k3_inputs(dtype, dev, 0, b, t, h,
                                                 lengths)
        for sl in (slopes, None):
            o, lse = k3(q, k, v, lengths, sl, True, h)
            o_ref, lse_ref = k3_plain(q, k, v, lengths, sl, True, h)
            grads = k3b(q, k, v, o, do, lse, lengths, sl, True, h)
            refs = k3b_plain(q, k, v, o, do, lse, lengths, sl, True, h)
            torch.cuda.synchronize()
            checks = [("o", o, o_ref, 1e-2 if bf16 else 1e-5,
                       0.0 if bf16 else 1.0), ("lse", lse, lse_ref, 1e-5, 1.0)]
            checks += [(n, g_, r_, 2e-2 if bf16 else 1e-4, 0.0)
                       for n, g_, r_ in zip(("dq", "dk", "dv"), grads, refs)]
            errs = []
            for name, got, want, tol, floor in checks:
                where = f"K3/K3b, {dtype}, T={t}, alibi={sl is not None}"
                err, text = hold(where, name, got, want, tol, floor, bf16)
                errs.append(text)
                if name in ("o", "lse"):
                    worst_f = max(worst_f, err)
                else:
                    worst_b = max(worst_b, err)
            log(f"K3/K3b check B={b} T={t} H={h} {str(dtype)[6:]} "
                f"alibi={sl is not None}: max_abs_err " + ", ".join(errs))

    # The scoring path's K3 call: float32, B 64, the short batch's padded
    # length and lengths; the plain version in chunks of 16 rows.
    lens = scoring_batches()[0]
    ts = max(lens)
    q, k, v, _, lengths, slopes = k3_inputs(torch.float32, dev, 2,
                                            SCORE_BATCH, ts, H, lens)

    def plain_s(i):
        return in_chunks(lambda s: k3_plain(q[s], k[s], v[s], lengths[s],
                                            slopes, True, H), SCORE_BATCH, 16)

    o, lse = k3(q, k, v, lengths, slopes, True, H)
    o_ref, lse_ref = plain_s(0)
    torch.cuda.synchronize()
    where = f"K3 at the scoring shape, float32, B={SCORE_BATCH}, T={ts}"
    errs = []
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref)):
        err, text = hold(where, name, got, want, 1e-5, 1.0, False)
        worst_f = max(worst_f, err)
        errs.append(text)
    log(f"K3 check B={SCORE_BATCH} T={ts} H={H} float32 alibi=True (the "
        f"scoring corpus's short batch, lengths {min(lens)}-{max(lens)}): "
        f"max_abs_err " + ", ".join(errs))
    del o, lse, o_ref, lse_ref
    ks = device_ms(lambda i: k3(q, k, v, lengths, slopes, True, H), n=10,
                   only=K3_KERNELS[:1], per_call=1)
    cs = cuda_ms(lambda i: k3(q, k, v, lengths, slopes, True, H), n=10)
    ps = device_ms(plain_s, n=2)
    mask = sdpa_mask(lengths, slopes, torch.float32, dev, ts, ts)
    q4, k4, v4 = (x.view(SCORE_BATCH, ts, H, D).transpose(1, 2)
                  for x in (q, k, v))

    def sdpa_s(i):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    ls = library_ms(sdpa_s, n=3)
    del mask
    (sb, so), _ = k3_bytes_ops(4, SCORE_BATCH, ts, lens)
    bound_s = max(sb / HBM_BYTES_PER_S, so / F32_FLOPS) * 1e3
    by_s = "bytes" if sb / HBM_BYTES_PER_S > so / F32_FLOPS else "operations"
    log(f"K3 time B={SCORE_BATCH} T={ts} float32 (the scoring path's call): "
        f"kernel {ks:.4f} ms, {cs:.4f} ms per call with the wrapper, plain "
        f"{ps:.4f} ms (16-row chunks), SDPA (float32, float mask) forward "
        f"{ls:.4f} ms, bound {bound_s:.4f} ms ({by_s}; {sb / 1e6:.1f} MB, "
        f"{so / 1e9:.2f} GFLOP at the float32 FMA rate)")
    del q, k, v, q4, k4, v4

    # Times at the training path's type (bf16, ALiBi).
    q, k, v, do, lengths, slopes = k3_inputs(torch.bfloat16, dev, seed=1)
    o, lse = k3(q, k, v, lengths, slopes, True, H)

    def fwd(i):
        return k3(q, k, v, lengths, slopes, True, H)

    def bwd(i):
        return k3b(q, k, v, o, do, lse, lengths, slopes, True, H)

    kf = device_ms(fwd, n=20, only=K3_KERNELS[:1], per_call=1)
    kb = device_ms(bwd, n=20, only=K3_KERNELS[1:], per_call=2)
    cf, cb = cuda_ms(fwd, n=20), cuda_ms(bwd, n=20)
    pf = device_ms(lambda i: k3_plain(q, k, v, lengths, slopes, True, H), n=3)
    pb = device_ms(lambda i: k3b_plain(q, k, v, o, do, lse, lengths, slopes,
                                       True, H), n=3)
    mask = sdpa_mask(lengths, slopes, torch.bfloat16, dev)
    q4, k4, v4 = (x.view(K3_B, K3_T, H, D).transpose(1, 2).detach()
                  .requires_grad_() for x in (q, k, v))
    do4 = do.view(K3_B, K3_T, H, D).transpose(1, 2)

    def sdpa_fwd(i):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def sdpa_fwd_bwd(i):
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask).backward(
            do4)

    lf = library_ms(sdpa_fwd, n=20)
    lfb = library_ms(sdpa_fwd_bwd, n=10)
    lb = sdpa_bwd_ms(q4, k4, v4, do4, mask)
    (fb, fo), (bb, bo) = k3_bytes_ops(2)
    bound_f = max(fb / HBM_BYTES_PER_S, fo / BF16_FLOPS) * 1e3
    bound_b = max(bb / HBM_BYTES_PER_S, bo / BF16_FLOPS) * 1e3
    by_f = "bytes" if fb / HBM_BYTES_PER_S > fo / BF16_FLOPS else "operations"
    by_b = "bytes" if bb / HBM_BYTES_PER_S > bo / BF16_FLOPS else "operations"
    log(f"K3 time B={K3_B} T={K3_T} bf16: kernel {kf:.4f} ms, {cf:.4f} ms "
        f"per call with the wrapper, plain {pf:.4f} ms, SDPA (float mask) "
        f"forward {lf:.4f} ms (kernel / SDPA {kf / lf:.3f}), bound "
        f"{bound_f:.4f} ms ({by_f}; {fb / 1e6:.1f} MB, {fo / 1e9:.2f} "
        f"GFLOP)")
    log(f"K3b time B={K3_B} T={K3_T} bf16: kernels {kb:.4f} ms, {cb:.4f} ms "
        f"per call with the wrapper (delta included), plain {pb:.4f} ms, "
        f"SDPA (float mask) backward alone {lb:.4f} ms (kernels / SDPA "
        f"backward {kb / lb:.3f}), forward+backward {lfb:.4f} ms, bound of "
        f"the kernels {bound_b:.4f} ms ({by_b}; {bb / 1e6:.1f} MB, "
        f"{bo / 1e9:.2f} GFLOP)")
    return (
        {"name": "flash_forward_packed", "route": "cuda",
         "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vae_gslm_tpu/ops/flash_attention.py:230",
         "launches": None, "max_abs_err": worst_f, "ms": kf, "plain_ms": pf,
         "bound_ms": bound_f, "bound_by": by_f, "library_ms": lf},
        {"name": "flash_backward_packed", "route": "cuda",
         "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vae_gslm_tpu/ops/flash_attention.py:359",
         "launches": None, "max_abs_err": worst_b, "ms": kb, "plain_ms": pb,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": lb})


# --------------------------------------------------------------- K4/K5
K5_B, K5_T = 8, 1750              # a scoring batch padded to 35 s
K5_LENGTHS = [1750, 1000, 1, 0, 1749, 64, 1700, 900]
K4_B, K4_T, K4_H = 8, 640, 15     # 15 heads: no packed head grouping
K4_LENGTHS = [640, 320, 300, 640, 1, 639, 0, 64]
# the one-pass float32 body at the shapes it makes likely to break: Tq
# below one 128-row query tile, Tq not a multiple of it, Tk 8192 (the
# envelope's longest walk, causal and not), lengths 0 and 1
F32_EDGES = (("K5", 3, 37, 300, 3, [300, 0, 1], True),
             ("K5", 3, 96, 8192, H, [8192, 0, 1], False),
             ("K5", 2, 8192, 8192, 2, [8192, 1], True),
             ("K5", 2, 1100, 1100, 3, [1100, 1], True),
             ("K4", 3, 5, 5, 3, [5, 1, 0], True),
             ("K4", 3, 300, 300, 3, [300, 1, 0], False))
F32_FLOPS = 67e12                 # H100 SXM float32 FMA units (data sheet)
# the streaming bf16 K5 body at the envelope's longest key walk, causal
# and not, lengths 0 and 1
K5_BF16_EDGES = (("K5", 3, 8192, 8192, 2, [8192, 0, 1], True),
                 ("K5", 3, 96, 8192, H, [8192, 0, 1], False))


def bhtd_inputs(dtype, dev, b: int, tq: int, tk: int, h: int, seed: int):
    """q (B, H, Tq, D) and k, v (B, H, Tk, D) as strided views of packed
    (B, T, H D) projections, as the scoring path hands them over."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    xq = torch.randn((b, tq, h * D), generator=g, device=dev).to(dtype)
    xkv = torch.randn((b, tk, 2 * h * D), generator=g, device=dev).to(dtype)
    q = xq.view(b, tq, h, D).transpose(1, 2)
    k, v = (x.view(b, tk, h, D).transpose(1, 2)
            for x in xkv.chunk(2, dim=-1))
    return q, k, v


def bhtd_bytes_ops(b: int, tq: int, tk: int, h: int, lengths, causal: bool,
                   itemsize: int, d: int = D):
    """Bytes and FLOPs of one K4/K5 forward on these inputs: q read and o
    written once, key and value rows only below each length (a row of
    length 0 reads all Tk), no lse; the (query, key) pairs the causal and
    length masks leave (all Tk for a row of length 0), 2 products of 2 D
    FLOPs each (``h`` heads of ``d``)."""
    row = h * d * itemsize
    kv_rows = sum(ln if ln >= 1 else tk for ln in lengths)
    nbytes = 2 * b * tq * row + 2 * kv_rows * row + b * 4 + h * 4

    def keys(r, ln):
        if ln < 1:
            return tk
        return min(r + 1, ln) if causal else min(ln, tk)

    pairs = h * sum(sum(keys(r, ln) for r in range(tq)) for ln in lengths)
    return nbytes, 2 * 2 * d * pairs


def phase_k45(dev):
    """K5 (the q-tiled forward) at the scoring shapes (B 8, 16 heads of
    64, Tq = Tk = 1750, lengths down to 0 and 1; and Tq 96 x Tk 256,
    non-causal) and K4 (the (B, H, T, D) full forward with lse) at B 8,
    T 640 with 15 heads (the odd-head case; phase_k45b holds it at the
    training call), against their plain versions, float32 and bfloat16,
    with ALiBi and without, at K3's tolerances (f32 1e-5 x max(1,
    max|ref|); bf16 o 1e-2 x max|ref| and element by element 2 ulps +
    1e-2 x rms, relative L2 1e-3; lse 1e-5 x max(1, max|ref|)); K5
    float32 at the scoring path's shape (B 64, T 1750, each long batch's
    lengths) and its time there beside the bound; K5 bf16 (the streaming
    ``k5_fwd_wgmma_kernel``) also at Tk 8192, causal (Tq 8192) and not (Tq
    96), lengths 0 and 1, the plain version one batch row at a time.
    Then K5's float32 time (the scoring path's type) and bf16 time (the
    16-mixed training path's) at B 8, each beside its plain version's,
    SDPA's forward with a float mask of its type and its bound.  Returns
    K4's worst error, K5's float32 entry and its bf16 entry."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    worst = {"K4": 0.0, "K5": 0.0, "K5bf16": 0.0}
    cases = (("K5", K5_B, K5_T, K5_T, H, K5_LENGTHS, True),
             ("K5", 3, 96, 256, H, [256, 0, 131], False),
             ("K4", K4_B, K4_T, K4_T, K4_H, K4_LENGTHS, True))
    runs = list(itertools.product(cases, (torch.float32, torch.bfloat16)))
    runs += [(case, torch.float32) for case in F32_EDGES]
    runs += [(case, torch.bfloat16) for case in K5_BF16_EDGES]
    for (name, b, tq, tk, h, lens, causal), dtype in runs:
        bf16 = dtype == torch.bfloat16
        q, k, v = bhtd_inputs(dtype, dev, b, tq, tk, h, seed=tq)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        slopes = -torch.tensor(alibi_slopes(h), device=dev)
        for sl in (slopes, None):
            where = (f"{name} B={b} Tq={tq} Tk={tk} H={h} {str(dtype)[6:]} "
                     f"causal={causal} alibi={sl is not None}")
            errs = []
            if name == "K5":
                got = fa.flash_forward_tiled(q, k, v, lengths, sl, causal)
                want = in_chunks(lambda r: fa.flash_forward_tiled_plain(
                    q[r], k[r], v[r], lengths[r], sl, causal), b,
                    1 if tq * tk > 1 << 24 else b)
                pairs = [("o", got, want)]
            else:
                got, lse = fa.flash_forward_full(q, k, v, lengths, sl, causal,
                                                 with_stats=True)
                want, lse_ref = fa.flash_forward_full_plain(
                    q, k, v, lengths, sl, causal, with_stats=True)
                pairs = [("o", got, want), ("lse", lse, lse_ref)]
            torch.cuda.synchronize()
            for n, g_, r_ in pairs:
                tol = 1e-2 if bf16 and n == "o" else 1e-5
                floor = 0.0 if bf16 and n == "o" else 1.0
                err, text = hold(where, n, g_, r_, tol, floor, bf16)
                errs.append(text)
                if n == "o":
                    key = "K5bf16" if name == "K5" and bf16 else name
                    worst[key] = max(worst[key], err)
            log(f"{name} check {where}: max_abs_err " + ", ".join(errs))
            del got, want

    # The scoring path's K5 calls: float32, B 64, each long batch's padded
    # length and lengths, q/k/v the (B, H, T, D) views of one packed
    # projection that flash_attention_packed hands over; the plain
    # version in chunks of 8 rows.  The last batch's call is timed.
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    for bi, lens in enumerate(scoring_batches()[1:], 1):
        ts = max(lens)
        qp, kp, vp, _, lengths, _ = k3_inputs(torch.float32, dev, 10 + bi,
                                              SCORE_BATCH, ts, H, lens)
        q, k, v = (fa._heads(x, H) for x in (qp, kp, vp))

        def plain_s(i):
            return in_chunks(lambda s: fa.flash_forward_tiled_plain(
                q[s], k[s], v[s], lengths[s], slopes, True), SCORE_BATCH, 8)

        got = fa.flash_forward_tiled(q, k, v, lengths, slopes, True)
        want = plain_s(0)
        torch.cuda.synchronize()
        where = (f"K5 at the scoring shape, float32, batch {bi}, "
                 f"B={SCORE_BATCH}, T={ts}")
        err, text = hold(where, "o", got, want, 1e-5, 1.0, False)
        worst["K5"] = max(worst["K5"], err)
        log(f"K5 check B={SCORE_BATCH} Tq=Tk={ts} H={H} float32 causal=True "
            f"alibi=True (the scoring corpus's batch {bi}, lengths "
            f"{min(lens)}-{max(lens)}): max_abs_err {text}")
        del got, want
    ks = device_ms(lambda i: fa.flash_forward_tiled(q, k, v, lengths, slopes,
                                                    True), n=5,
                   only=("k5_fwd",), per_call=1)
    cs = cuda_ms(lambda i: fa.flash_forward_tiled(q, k, v, lengths, slopes,
                                                  True), n=5)
    ps = device_ms(plain_s, n=1)
    # SDPA (float32, float mask) at the same call: the (B, H, T, T) mask
    # of all 64 rows would take 12.5 GB, so 8-row chunks, their times
    # summed
    ls = 0.0
    for r in range(0, SCORE_BATCH, 8):
        mask = sdpa_mask(lengths[r:r + 8], slopes, torch.float32, dev, ts,
                         ts)

        def sdpa_chunk(i, r=r, mask=mask):
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    q[r:r + 8], k[r:r + 8], v[r:r + 8], attn_mask=mask)

        ls += library_ms(sdpa_chunk, n=2)
        del mask
    nbytes, flops = bhtd_bytes_ops(SCORE_BATCH, ts, ts, H, lens, True, 4)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / F32_FLOPS \
        else "operations"
    log(f"K5 time B={SCORE_BATCH} T={ts} H={H} float32 (the scoring path's "
        f"call, batch {bi}): kernel {ks:.4f} ms, {cs:.4f} ms per call with "
        f"the wrapper, plain {ps:.4f} ms (8-row chunks), SDPA (float32, "
        f"float mask, 8-row chunks summed) forward {ls:.4f} ms, bound "
        f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
        f"GFLOP at the float32 FMA rate)")
    del q, k, v, qp, kp, vp

    b, tq, h, lens = K5_B, K5_T, H, K5_LENGTHS
    fn, plain = fa.flash_forward_tiled, fa.flash_forward_tiled_plain
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    times, entries = {}, {}
    for dtype, flops_rate, itemsize in ((torch.bfloat16, BF16_FLOPS, 2),
                                        (torch.float32, F32_FLOPS, 4)):
        q, k, v = bhtd_inputs(dtype, dev, b, tq, tq, h, seed=1)
        ks = device_ms(lambda i: fn(q, k, v, lengths, slopes, True), n=10,
                       only=("k5_fwd",), per_call=1)
        cs = cuda_ms(lambda i: fn(q, k, v, lengths, slopes, True), n=10)
        ps = device_ms(lambda i: plain(q, k, v, lengths, slopes, True), n=2)
        mask = sdpa_mask(lengths, slopes, dtype, dev, tq, tq, True)

        def sdpa(i):
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)

        ls = library_ms(sdpa, n=5)
        del mask
        nbytes, flops = bhtd_bytes_ops(b, tq, tq, h, lens, True, itemsize)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_rate
        bound = max(t_b, t_o) * 1e3
        by = "bytes" if t_b > t_o else "operations"
        times[dtype] = (ks, cs, ps, ls, bound, by, nbytes, flops)
        bf16 = dtype == torch.bfloat16
        entries[dtype] = {
            "name": ("flash_forward_tiled (bf16: k5_fwd_wgmma_kernel)" if bf16
                     else "flash_forward_tiled (float32: k5_fwd_kernel)"),
            "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
            "replaces": "vae_gslm_tpu/ops/flash_attention.py:443",
            "launches": None,
            "max_abs_err": worst["K5bf16" if bf16 else "K5"], "ms": ks,
            "plain_ms": ps, "bound_ms": bound, "bound_by": by,
            "library_ms": ls}
        del q, k, v
    for dtype, what in ((torch.float32, "float32"),
                        (torch.bfloat16, "bf16")):
        ks, cs, ps, ls, bound, by, nbytes, flops = times[dtype]
        rate = "bf16 tensor-core" if dtype == torch.bfloat16 else \
            "float32 FMA"
        log(f"K5 time B={b} T={tq} H={h} {what}: kernel {ks:.4f} ms, "
            f"{cs:.4f} ms per call with the wrapper, plain {ps:.4f} ms, SDPA "
            f"({what}, float mask) forward {ls:.4f} ms (kernel / SDPA "
            f"{ks / ls:.3f}), bound {bound:.4f} ms ({by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the {rate} "
            f"rate)")
    return worst["K4"], entries[torch.float32], entries[torch.bfloat16]


# ----------------------------------------------------- small agreement
SMALL_YAML = """
tokens: {embedding_dim: 32, vocab_size: 50}
latent_dim: 4
encoder:
    identifier: BottleNeckResNet
    num_layers: 1
    init_channel: 32
    out_channels: [32]
    hidden_channels: [64]
    resample_rates: [1]
    resample_ksize: [1]
    final_norm: true
    layer:
        kernel_size: 7
        causal_padding: true
        norm: {identifier: InstanceNorm, eps: 1.0e-6}
        activation: {identifier: ReLU}
transformer:
    num_layers: 2
    bias: false
    rpe: {identifier: ALiBi, maxpos: 1024}
    layer:
        dim: 128
        ffd_size: 512
        norm: {identifier: RMSNorm, eps: 1.0e-6}
        activation: {identifier: GELU}
        self_attn: {nheads: 2, causal: true}
    flow:
        num_layers: 2
        conditional: true
        layer:
            hidden_dim: 16
            mean_only: false
            scale_range: [0.5, 2.0]
            activation: {identifier: GELU}
            norm: {identifier: LayerNorm, eps: 1.0e-6}
decoder:
    diffusion:
        identifier: ConditionalBottleNeckUNet
        timesteps: 50
        beta_schedule: {identifier: cosine}
        objective: pred_noise
        input_scale: 5.0
        clamp_range: [-3.0, 1.2]
        sampling_timesteps: 5
        ddim_sampling_eta: 0.0
    cond_unet:
        unet:
            condition_dim: 16
            num_layers: 2
            init_channel: 32
            out_channels: [32, 32]
            hidden_channels: [64, 64]
            resample_rates: [1, 1]
            resample_ksize: [1, 1]
            conditional: [false, true]
            skip_connection: [null, 0]
            connection_type: concat
            final_norm: true
            layer:
                kernel_size: 7
                causal_padding: true
                condition_type: concat
                norm: {identifier: InstanceNorm, eps: 1.0e-6}
                activation: {identifier: SiLU}
        time_embedding:
            dim: 32
            maxpos: 50
            activation: {identifier: SiLU}
"""


def small_hparams(mega: bool):
    """SMALL_YAML; for the mega path widened to K2's smallest width (dim
    256, 4 heads of 64, ffd 1024)."""
    from vae_gslm_tpu_torch.hparams.hp import Hparams

    d = Hparams.from_yaml(SMALL_YAML).to_dict()
    if mega:
        d["transformer"]["layer"].update(dim=256, ffd_size=1024)
        d["transformer"]["layer"]["self_attn"]["nheads"] = 4
    return Hparams.from_dict(d)


def phase_small(dev, quantize: bool, w4: int = 0, per_layer: str = "",
                batch: int = 2):
    """A small LVTR continues a prompt by 300 frames on the card (through
    the kernels) and on the CPU (through the plain versions), float32,
    temperature 0: bf16 weights through K1, or int8 weights through K2
    (a8 at B = 2; at ``batch`` 12 the bf16 branch, exactly 300 K2-bf16
    launches and no other K2) across eight-step merges and two tail ->
    cold flushes, or with ``w4`` nibble-packed int4 weights of that scale
    group through K2-w4 (exactly 300 K2-w4 launches and no other K2 on
    the card).  With
    ``per_layer`` the int8-weight model (dim 256) at B = 72, past the mega
    batches, on the per-layer route: "int8" (an int8 cache through
    ``decode_attention``, no kernel), "k6" (the same through K6: exactly
    600 launches on the card) or "float" (``kv_dtype`` None: a float32
    cache, no kernel); no K1 or K2 launch."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step

    quantize = quantize or bool(per_layer)
    rng = np.random.RandomState(1)
    b, tp, length = (72 if per_layer else batch), 20, 300
    prompt = np.concatenate([rng.randint(0, 50, (b, tp, 1)),
                             rng.randn(b, tp, 80)], -1).astype(np.float32)
    # the CPU and the card draw different streams from one seed, so the
    # uniform initial AR state is pinned on both, as the tests pin it
    init = torch.from_numpy(rng.rand(b, 1, 32).astype(np.float32) * 2 - 1)
    route = ("per_layer" if per_layer else "mega" if quantize
             else "hybrid")
    runs = {}
    for where in ("cpu", dev):
        model = LVTR(small_hparams(quantize), input_dim=80, device=where,
                     generator=torch.Generator("cpu").manual_seed(3)
                     if where == "cpu" else None)
        model.initial_state = (
            lambda generator, bsize, nfeat=None, where=where: init.to(where))
        if where == "cpu":      # float weights; each side quantizes its own
            runs["cpu_state"] = {k: v.clone()
                                 for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(runs["cpu_state"])
        sampler = ARTRSampler(
            model, kv_dtype=None if per_layer == "float" else torch.int8,
            quantize_weights=quantize, device=where, mega_w4=w4,
            flash_decode=per_layer == "k6")
        if sampler.route(b) != route:
            raise AssertionError(f"the small model took the "
                                 f"{sampler.route(b)} route, not {route}")
        x = torch.from_numpy(prompt).to(where)
        fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
        fused_trunk_step.launches_bf16 = 0
        fused_decode_attention.launches = flash_decode_int8.launches = 0
        out = sampler(length, Masked.from_lengths(x, [tp] * b),
                      torch.Generator(where).manual_seed(0),
                      temperature=0.0, token_temperature=1e-6,
                      encoder_temperature=0.0)
        counts = (fused_decode_attention.launches, fused_trunk_step.launches,
                  fused_trunk_step.launches_bf16,
                  fused_trunk_step.launches_w4, flash_decode_int8.launches)
        want = None
        if w4:
            want = (0, 0, 0, length, 0)
        elif per_layer:
            want = (0, 0, 0, 0, 2 * length if per_layer == "k6" else 0)
        elif quantize:
            want = (0, length, 0, 0, 0) if b <= 8 else (0, 0, length, 0, 0)
        if want and str(where) != "cpu" and counts != want:
            raise AssertionError(f"K1 / K2-a8 / K2-bf16 / K2-w4 / K6 "
                                 f"launches {counts}, expected {want}")
        runs[str(where)] = out["frames"].value.float().cpu().numpy()
    cpu, gpu = runs["cpu"][:, tp:], runs[str(dev)][:, tp:]
    neq = (cpu[..., 0] != gpu[..., 0]).any(0)
    first = int(neq.argmax()) if neq.any() else length
    lat_err = float(np.abs(cpu[:, :64, 1:] - gpu[:, :64, 1:]).max())
    what = (f"int4 weights (group {w4}) through K2-w4" if w4
            else {"int8": "per-layer int8 cache through decode_attention",
                  "k6": "per-layer int8 cache through K6",
                  "float": "per-layer float32 cache"}[per_layer]
            if per_layer else "int8 weights through K2-"
            + ("a8" if b <= 8 else "bf16") if quantize
            else "bf16 through K1")
    log(f"small-input agreement (card {what} vs CPU plain, B={b}, {length} "
        f"steps): tokens equal for the first {first} steps, first-64-step "
        f"latent max error {lat_err:.2e}")
    if first < 150 or not lat_err < 1e-2:
        raise AssertionError("the card and the CPU disagree on a small "
                             "input")


# ------------------------------------------------------------ training
VOCODER_YAML = os.path.join(ROOT, "configs", "train", "vocoder",
                            "hfgan_16k_50hz_librispeech.yaml")
TRAIN_YAML = os.path.join(ROOT, "configs", "train", "speech",
                          "vae-gslm.yaml")
TRAIN_T, TRAIN_B, TRAIN_ACCUM = 640, 8, 2
TRAIN_LENGTHS = [640] * 6 + [400, 520]


def vocoder_dir(tmp: str) -> str:
    """A vocoder directory holding the 80-bin vocoder config as
    ``hp.yaml``: the trainer reads the model's mel width from it."""
    import shutil

    shutil.copy(VOCODER_YAML, os.path.join(tmp, "hp.yaml"))
    return tmp


def train_batches(rng, b: int, t: int, lengths, t_utt: int, vocab: int):
    """Two synthetic micro-batches stacked on the accumulation axis:
    [token, 80-bin mel] frames of the given lengths and utterance mel
    crops of 50 %-100 % of ``t_utt`` frames (numpy draws)."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.training.trainer import stack_batches

    mbs = []
    for _ in range(TRAIN_ACCUM):
        ln = torch.tensor(lengths, dtype=torch.int32)
        utt = torch.from_numpy(rng.randint(t_utt // 2, t_utt + 1, b)
                               .astype(np.int32))
        mbs.append({
            "mel": Masked(torch.from_numpy(
                rng.randn(b, t, 80).astype(np.float32)), ln),
            "tokens": Masked(torch.from_numpy(
                rng.randint(0, vocab, (b, t)).astype(np.int32)), ln),
            "cropped_mel_utt": Masked(torch.from_numpy(
                rng.randn(b, t_utt, 80).astype(np.float32)), utt)})
    return stack_batches(mbs)


def train_draws(rng, b: int, t: int, latent: int, nfeat: int, steps: int):
    """One micro-batch's random draws of ``LVTR.forward`` (numpy), so that
    the card and the CPU take the same ones."""
    import numpy as np
    import torch

    f = (lambda a: torch.from_numpy(a.astype(np.float32)))
    return {"posterior": f(rng.randn(b, t, latent)),
            "initial": f(rng.uniform(-1, 1, (b, 1, nfeat))),
            "prior": f(rng.randn(b, t, latent)),
            "t": torch.from_numpy(rng.randint(0, steps, b)),
            "noise": f(rng.randn(b, t, 80))}


def small_train_hparams(vdir: str):
    """SMALL_YAML's LVTR (dim 128, two heads of 64: the kernels' head_dim)
    with a two-layer strided utterance encoder, under the flagship's
    training block with float32 compute, clipping and accumulation 2."""
    import yaml

    from vae_gslm_tpu_torch.hparams.hp import Hparams

    with open(TRAIN_YAML) as f:
        cfg = yaml.safe_load(f)
    model = yaml.safe_load(SMALL_YAML)
    model["utterance_encoder"] = {
        "embedding_dim": 16, "num_layers": 2, "init_channel": 16,
        "out_channels": [16, 32], "resample_rates": [-2, -2],
        "resample_ksize": [4, 4],
        "layer": cfg["model"]["utterance_encoder"]["layer"]}
    cfg["model"] = model
    cfg["vocoder"]["path"] = vdir
    cfg["trainer"]["precision"] = "32"
    cfg["training"]["gradient_clip_val"] = 1.0
    return Hparams.from_dict(cfg)


def phase_train_small(dev):
    """One optimizer step (accumulation 2) of a small LVTR on the card
    (K3/K3b) and on the CPU (plain versions) from the same weights,
    batch and draws, float32: loss terms within 1e-4 relative, every
    gradient leaf within 1e-3 x its max |g|."""
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.ops.flash_attention import (
        flash_backward_packed, flash_forward_packed)
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    b, t = 3, 100
    with tempfile.TemporaryDirectory() as tmp:
        hp = small_train_hparams(vocoder_dir(tmp))
        cpu = LVTRTrainer(hp, seed=3, device="cpu")
        gpu = LVTRTrainer(small_train_hparams(tmp), seed=3, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.RandomState(2)
    batch = train_batches(rng, b, t, [100, 61, 1], 40, 50)
    draws = [train_draws(rng, b, t, 4, 32, cpu.model.decoder.num_timesteps)
             for _ in range(TRAIN_ACCUM)]
    cpu.global_step = gpu.global_step = 40000    # past the KLD warm-up
    want = cpu.run_step(batch, draws=draws)
    flash_forward_packed.launches = flash_backward_packed.launches = 0
    got = gpu.run_step(batch, draws=draws)
    torch.cuda.synchronize()
    launches = (flash_forward_packed.launches, flash_backward_packed.launches)
    n_layers = len(gpu.model.transformer.layers)
    if launches != (n_layers * TRAIN_ACCUM,) * 2:
        raise AssertionError(f"small step: K3/K3b launches {launches}")
    worst_m = 0.0
    for k in ("rec_loss", "kld", "token_kld", "log_p", "log_q"):
        g, w = float(got[k]), float(want[k])
        worst_m = max(worst_m, abs(g - w) / max(abs(w), 1e-12))
    worst_g = 0.0
    for name, pg, pc in zip(gpu.names, gpu.params, cpu.params):
        gg, gc = pg.grad.double().cpu(), pc.grad.double()
        err = (gg - gc).abs().max().item()
        scale = gc.abs().max().item()
        if not err <= 1e-3 * scale + 1e-30:
            raise AssertionError(f"small step: gradient of {name} differs "
                                 f"by {err:.3e} (max |g| {scale:.3e})")
        worst_g = max(worst_g, err / max(scale, 1e-30))
    log(f"small train step (card K3/K3b vs CPU plain, accumulation 2, "
        f"float32): loss terms max rel err {worst_m:.2e}, gradients max "
        f"err {worst_g:.2e} x max|g| over {len(gpu.params)} leaves; "
        f"K3/K3b launches {launches}")
    if not worst_m <= 1e-4:
        raise AssertionError("small step: the card's loss differs from "
                             "the CPU's")


def phase_train(dev, gpu: str, seed: int = 0):
    """The full-width LVTR training step of ``configs/train/speech/
    vae-gslm.yaml`` (16-mixed, AdamW, accumulation 2, utterance encoder):
    one warm-up and five timed ``run_step`` calls on synthetic B = 8 x 640
    batches, each with the kernels' counts set to 0 just before and read
    just after (exactly 32 K3 and 32 K3b launches; the plain attention
    versions and the dense ``attend`` raise if reached); then one
    profiled step.  Returns the K3 and K3b counts of the last step."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    with tempfile.TemporaryDirectory() as tmp:
        hp = Hparams.from_yamlfile(TRAIN_YAML)
        hp.vocoder.path = vocoder_dir(tmp)
        t0 = time.perf_counter()
        trainer = LVTRTrainer(hp, seed=seed, device=dev)
    nparams = sum(p.numel() for p in trainer.params)
    torch.cuda.synchronize()
    log(f"train: LVTR {nparams / 1e6:.1f} M parameters (float32, bf16 "
        f"compute, utterance encoder on) and AdamW state built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    batch = trainer.prepare_batch(train_batches(
        rng, TRAIN_B, TRAIN_T, TRAIN_LENGTHS, 200,
        hp.model.tokens.vocab_size))
    tokens = TRAIN_B * TRAIN_ACCUM * TRAIN_T
    want = 16 * TRAIN_ACCUM

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"the training path reached {what} on "
                                 "the card")
        return fn

    saved = (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
             attn_mod.attend)
    fa.flash_forward_packed_plain = refuse("the plain K3")
    fa.flash_backward_packed_plain = refuse("the plain K3b")
    attn_mod.attend = refuse("the dense attention")
    opt_step, opt_s = trainer.opt.step, []

    def timed_opt_step(grads):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt_step(grads)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - t1)

    trainer.opt.step = timed_opt_step
    watch = {n: p for n, p in zip(trainer.names, trainer.params)
             if n in ("transformer.layers.0.self_attn.in_proj.weight",
                      "transformer.layers.15.linear2.weight",
                      "encoder_net.layers.0.conv1.weight",
                      "utterance_net.layers.0.conv.weight",
                      "decoder.model.unet.layers.5.conv2.weight")}
    before = {n: p.detach().clone() for n, p in watch.items()}
    steps, counts = [], None
    try:
        torch.cuda.reset_peak_memory_stats()
        for i in range(6):
            fa.flash_forward_packed.launches = 0
            fa.flash_backward_packed.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = trainer.run_step(batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            counts = (fa.flash_forward_packed.launches,
                      fa.flash_backward_packed.launches)
            trainer.global_step += 1
            loss_terms = {k: float(metrics[k]) for k in
                          ("rec_loss", "kld", "token_kld", "grad_norm")}
            log(f"train step {i}{' (warm-up)' if i == 0 else ''}: "
                f"{sec * 1e3:.1f} ms, optimizer {opt_s[-1] * 1e3:.1f} ms; "
                f"K3 {counts[0]}, K3b {counts[1]} launches; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in loss_terms.items()))
            if counts != (want, want):
                raise AssertionError(f"K3/K3b launches {counts} per step, "
                                     f"expected ({want}, {want})")
            if not all(math.isfinite(v) for v in loss_terms.values()):
                raise AssertionError(f"non-finite training metrics "
                                     f"{loss_terms}")
            if i:
                steps.append(sec)
        peak = torch.cuda.max_memory_allocated()
        moved = {n: (watch[n].detach() - before[n]).abs().max().item()
                 for n in watch}
        if len(watch) != 5 or not all(v > 0 for v in moved.values()):
            raise AssertionError(f"parameters did not move: {moved}")
        s = sorted(steps)
        med = statistics.median(s)
        opt_med = statistics.median(opt_s[1:])
        log(f"train step B={TRAIN_B} x accumulation {TRAIN_ACCUM} x "
            f"T={TRAIN_T} (16-mixed): median {med * 1e3:.1f} ms, range "
            f"{s[0] * 1e3:.1f}-{s[-1] * 1e3:.1f} ms over {len(s)} steps; "
            f"{tokens / med:.0f} tokens/s; forward+backward "
            f"{(med - opt_med) * 1e3:.1f} ms, optimizer {opt_med * 1e3:.1f} "
            f"ms; peak memory {peak / 2 ** 30:.2f} GiB ({gpu})")
        # model FLOPs: 6 per parameter per frame for the weights the
        # frames pass through (the utterance encoder's strided crops
        # counted as full frames: an overestimate of <1 %), plus causal
        # attention's 3 x 2 products of 2 D FLOPs per (query, key) pair
        # of every layer and head
        pairs = sum(sum(min(r + 1, ln) for r in range(TRAIN_T))
                    for ln in TRAIN_LENGTHS) * TRAIN_ACCUM * L * H
        flops = 6 * nparams * tokens + 3 * 2 * 2 * D * pairs
        rate = flops / med
        log(f"train model FLOPs per step ~{flops / 1e12:.1f} TFLOP: "
            f"{rate / 1e12:.1f} TFLOP/s, MFU {rate / BF16_FLOPS:.1%} of the "
            f"bf16 dense peak ({gpu})")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.run_step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        trainer.global_step += 1
    finally:
        (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
         attn_mod.attend) = saved
        trainer.opt.step = opt_step
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    if not kernels:
        log("train step profile: device time not measured (the profiler "
            "recorded no kernel)")
        return counts
    busy = sum(k[0] for k in kernels)
    attn = sum(k[0] for k in kernels if any(s in k[2] for s in K3_KERNELS))
    h2d = sum(k[1] for k in kernels if "HtoD" in k[2])
    log(f"train step profile (profiler on): wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms ({busy / wall_ms:.1%}), K3+K3b {attn:.1f} ms "
        f"({attn / busy:.1%} of busy), {sum(k[1] for k in kernels)} device "
        f"ops of which {h2d} host-to-device copies ({gpu})")
    for ms, n, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:.3f} ms, {n}x: {name[:90]}")
    return counts


# --------------------------------------------------------- main paths
def build_pipeline(dev, quantize: bool, kv_dtype="int8", nheads: int = 0,
                   layers: int = 0):
    """The full-width LVTR of ``configs/train/speech/vae-gslm.yaml``
    (weights from seed 0, the utterance encoder left out), its sampler
    with an int8 KV cache (``kv_dtype`` None: a cache in the compute
    dtype, bf16), and the HiFi-GAN.  With ``quantize`` the trunk is
    quantized to int8 from the float32 weights; the remaining float
    parameters are then cast to bf16.  ``nheads`` replaces the config's
    16 heads (K2 takes head widths 32, 64 and 128, so an int8-weight trunk
    of 8, 16 or 32 heads serves on the mega route), ``layers`` the
    config's 16 layers."""
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.models.vocoder.hfgan import Generator

    precision.set_policy(precision.bf16_mixed())
    hp = Hparams.from_yamlfile(TRAIN_YAML)
    del hp.model.__dict__["utterance_encoder"]
    if nheads:
        hp.model.transformer.layer.self_attn.nheads = nheads
    if layers:
        hp.model.transformer.num_layers = layers
    voc_hp = Hparams.from_yamlfile(os.path.join(
        ROOT, "configs", "train", "vocoder",
        "hfgan_16k_50hz_librispeech.yaml"))
    t0 = time.perf_counter()
    model = LVTR(hp.model, input_dim=80, device=dev,
                 generator=torch.Generator(dev).manual_seed(0))
    model.decoder.override_sampling(sampling_timesteps=100,
                                    ddim_sampling_eta=0.5)
    sampler = ARTRSampler(model, kv_dtype=kv_dtype and torch.int8,
                          quantize_weights=quantize, device=dev)
    mega = quantize and kv_dtype == "int8"
    if sampler.use_mega != mega:
        raise AssertionError(f"the trunk's mega route is {sampler.use_mega}"
                             f", expected {mega}")
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    vocoder = Generator(voc_hp.model.generator, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    vocoder.remove_weight_norm()          # as HiFiGAN.from_pretrained
    vocoder.requires_grad_(False)
    nparams = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"pipeline: LVTR {nparams / 1e6:.1f} M parameters "
        f"({'int8 trunk, ' if quantize else ''}bf16) built in "
        f"{time.perf_counter() - t0:.1f} s")
    return sampler, vocoder


def make_prior(batch: int, dev):
    """Synthetic 150-frame prompts ([token, mel] frames), as bench.py
    makes them."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked

    rng = np.random.RandomState(0)
    toks = rng.randint(0, 200, (batch, PROMPT, 1)).astype(np.float32)
    mel = (rng.randn(batch, PROMPT, 80) * 0.5 - 1.0).astype(np.float32)
    return Masked.from_lengths(
        torch.from_numpy(np.concatenate([toks, mel], -1)).to(dev),
        [PROMPT] * batch)


def run_once(sampler, vocoder, prior, dev, seed: int, kw: dict,
             length: int = 0):
    """One continuation of ``length`` frames (``LENGTH`` unless given)
    and its vocoding with the decode kernels' counts set to 0 just before
    and read just after.  Returns (stage seconds, (K1, K2, K6) launches,
    the sampler's outputs)."""
    import torch

    length = length or LENGTH
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step

    batch = prior.value.shape[0]
    fused_decode_attention.launches = 0
    fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
    fused_trunk_step.launches_bf16 = 0
    flash_decode_int8.launches = 0
    timings = {}
    out = sampler(length, prior, torch.Generator(dev).manual_seed(seed),
                  timings=timings, **kw)
    t0 = time.perf_counter()
    wave = vocoder(out["output"])
    torch.cuda.synchronize()
    timings["vocoder"] = time.perf_counter() - t0
    counts = (fused_decode_attention.launches,
              fused_trunk_step.launches + fused_trunk_step.launches_w4
              + fused_trunk_step.launches_bf16,
              flash_decode_int8.launches)
    if batch <= 8 and not getattr(sampler, "mega_w4", 0) and \
            fused_trunk_step.launches != counts[1]:   # B <= 8: a8 alone
        raise AssertionError(f"K2 at B={batch} ran {counts[1]} steps, "
                             f"{fused_trunk_step.launches} of them s8 x s8")
    check_outputs(out, wave, batch, length)
    return timings, counts, out


def phase_pipeline(dev, gpu: str, quantize: bool):
    """The 3 s -> 10 s continuation at B = 8, once: bf16 weights through
    K1 (16 x 500 launches, no K2) or int8 weights through K2 (500
    launches, a8, no K1).  Then a profile of 64 AR steps.  Returns the
    path's kernel count."""
    import torch

    path = "int8 weights, K2" if quantize else "bf16 weights, K1"
    sampler, vocoder = build_pipeline(dev, quantize)
    prior = make_prior(8, dev)
    kw = dict(temperature=0.85, token_temperature=0.85)
    want = (0, LENGTH, 0) if quantize else (L * LENGTH, 0, 0)

    # warm-up (allocator, cuBLAS/cuDNN handles, lazily loaded kernels) on
    # a short continuation and its vocoding
    vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                    **kw)["output"])
    torch.cuda.synchronize()
    timings, counts, _ = run_once(sampler, vocoder, prior, dev, 1, kw)
    if counts != want:
        raise AssertionError(f"launches (K1, K2, K6) = {counts}, expected "
                             f"{want}")
    audio_s = 8 * LENGTH / 50.0
    log(f"pipeline B=8 ({path}): K1 launches {counts[0]}, K2 launches "
        f"{counts[1]}; " + ", ".join(
            f"{name} {sec * 1e3:.1f} ms" for name, sec in timings.items())
        + f"; {audio_s:.0f} s of audio, real-time factor "
        f"{audio_s / sum(timings.values()):.2f}x ({gpu})")
    profile_ar_loop(sampler, prior, dev, gpu, kw, path)
    return counts[1] if quantize else counts[0]


PL_B = 128                          # past the mega batches: per layer


def phase_per_layer(dev, gpu: str) -> int:
    """The per-layer serving paths at full width and ``CUT_L`` layers (cut
    from 16 for time), B = 128 synthetic
    150-frame prompts, 500 AR steps, DDIM-100, HiFi-GAN, each run with
    the decode kernels' counts set to 0 just before and read just after:
    int8 weights and an int8 cache through JAX's route
    (``decode_attention``; no K1, K2 or K6 launch), then the same prompts
    and seed with ``flash_decode=True`` (exactly CUT_L x 500 K6 launches and
    no K1 or K2); the two routes' token agreement and latent difference
    (reported, not gated); then bf16 weights with a bf16 cache
    (``kv_dtype`` None; no kernel launch on the AR loop).  Real-time
    factor, stage times, peak memory and ms per AR step of each, and a
    profile of 32 AR steps of the two int8 routes.  Returns the K6
    launches."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler

    kw = dict(temperature=0.85, token_temperature=0.85)
    prior = make_prior(PL_B, dev)
    audio_s = PL_B * LENGTH / 50.0

    def run(name, sampler, vocoder, want):
        if sampler.route(PL_B) != "per_layer":
            raise AssertionError(f"{name}: route {sampler.route(PL_B)}")
        vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                        **kw)["output"])                # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timings, counts, out = run_once(sampler, vocoder, prior, dev, 1, kw)
        peak = torch.cuda.max_memory_allocated()
        if counts != want:
            raise AssertionError(f"{name}: launches (K1, K2, K6) = {counts}"
                                 f", expected {want}")
        log(f"per-layer B={PL_B} ({CUT_L} layers, {name}): K1 {counts[0]}, "
            f"K2 {counts[1]}, "
            f"K6 {counts[2]} launches; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in timings.items())
            + f"; {timings['ar_loop'] / LENGTH * 1e3:.2f} ms per AR step; "
            f"real-time factor {audio_s / sum(timings.values()):.2f}x; peak "
            f"memory {peak / 2 ** 30:.2f} GiB ({gpu})")
        return out["frames"].value[:, PROMPT:].float().cpu().numpy(), counts

    sampler, vocoder = build_pipeline(dev, quantize=True, layers=CUT_L)
    k6_sampler = ARTRSampler(sampler.model, kv_dtype=torch.int8,
                             flash_decode=True, device=dev)
    ref, _ = run("int8 weights, int8 cache, JAX's route", sampler, vocoder,
                 (0, 0, 0))
    got, counts = run("int8 weights, int8 cache, K6", k6_sampler, vocoder,
                      (0, 0, CUT_L * LENGTH))
    same = float((ref[..., 0] == got[..., 0]).mean())
    log(f"per-layer B={PL_B}: K6 route against JAX's route, same prompts and "
        f"seed: tokens equal at {same:.1%} of the steps, latent max |diff| "
        f"{float(np.abs(ref[..., 1:] - got[..., 1:]).max()):.3e} (reported, "
        f"not gated: K6 does not quantize q)")
    for s, path in ((sampler, "per-layer int8, JAX's route"),
                    (k6_sampler, "per-layer int8, K6")):
        profile_ar_loop(s, prior, dev, gpu, kw, path, steps=32)
    del sampler, k6_sampler, vocoder
    gc.collect()
    sampler, vocoder = build_pipeline(dev, quantize=False, kv_dtype=None,
                                      layers=CUT_L)
    run("bf16 weights, bf16 cache", sampler, vocoder, (0, 0, 0))
    del sampler, vocoder
    gc.collect()
    return counts[2]


def check_outputs(out, wave, batch: int, length: int = 0) -> None:
    """Shapes, finiteness and token ids of one continuation of
    ``length`` frames (``LENGTH`` unless given)."""
    import torch

    length = length or LENGTH
    frames = out["frames"].value
    mel_out = out["output"].value
    w = wave.value
    if tuple(w.shape) != (batch, (PROMPT + length) * 320):
        raise AssertionError(f"wave shape {tuple(w.shape)}")
    if tuple(mel_out.shape) != (batch, PROMPT + length, 80):
        raise AssertionError(f"mel shape {tuple(mel_out.shape)}")
    toks_out = frames[:, PROMPT:, 0]
    if not (bool(torch.isfinite(w).all()) and bool(torch.isfinite(
            mel_out).all()) and bool(torch.isfinite(frames).all())):
        raise AssertionError("non-finite output")
    if not bool(((toks_out >= 0) & (toks_out < 200)
                 & (toks_out == toks_out.round())).all()):
        raise AssertionError("generated token ids outside the vocabulary")


def profile_ar_loop(sampler, prior, dev, gpu: str, kw: dict, path: str,
                    steps: int = 64) -> None:
    """Where the AR loop's time goes: the device busy share over
    ``steps`` steps and the kernels that take it (torch.profiler's CUDA
    activity; host clock around the loop, the profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_gslm_tpu_torch.inference.speech.sampler import (
        hybrid_scan_segments, mega_scan_segments)

    model = sampler.model
    batch = prior.value.shape[0]
    route = sampler.route(batch)
    g = torch.Generator(dev).manual_seed(2)
    with torch.no_grad():
        enc = model.encode(prior, g)
        pos0 = enc.value.shape[1] + 1
        if route == "per_layer":
            frame, caches = sampler.prefill_per_layer(enc, steps, g, **kw)

            def run():
                sampler.per_layer_scan(frame, caches, pos0, steps, g, **kw)
        else:
            stacked = model.transformer.build_stacked_decode()
            frame, cache, flushed = sampler.prefill(
                enc, steps, stacked, g, mega=route == "mega", **kw)
        if route == "mega":
            weights = model.transformer.build_mega_decode()

            def run():
                mega_scan_segments(frame, cache, flushed, pos0, steps,
                                   lambda fr, c, p, f: model.step_mega(
                                       fr, weights, c, p, f, g, **kw))
        elif route == "hybrid":
            def run():
                hybrid_scan_segments(model, frame, cache, flushed, pos0,
                                     steps, lambda fr, c, p, f:
                                     model.step_hybrid(fr, stacked, c, p, f,
                                                       g, **kw))

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [(e.self_device_time_total / 1e3 / steps, e.count / steps,
                e.key) for e in prof.key_averages()
               if e.self_device_time_total > 0]
    if not kernels:
        log(f"AR loop profile ({path}): device time not measured (the "
            "profiler recorded no kernel)")
        return
    busy_ms = sum(k[0] for k in kernels)
    log(f"AR loop profile ({path}), {steps} steps at B={batch} (profiler "
        f"on): "
        f"wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
        f"({busy_ms / wall_ms:.1%}), {sum(k[1] for k in kernels):.0f} "
        f"device ops/step ({gpu})")
    for ms, n, name in sorted(kernels, reverse=True)[:8]:
        log(f"  {ms:.4f} ms/step, {n:.0f}/step: {name[:90]}")


# ------------------------------------------------------------- scoring
def phase_likelihood_small(dev) -> int:
    """``LVTR.likelihood`` of a small float32 LVTR with an unpackable head
    layout (dim 192, three heads of 64, 2 layers, tokens + flow) on the
    card (through the kernels) and on the CPU (through the plain
    versions), same weights, batch and pinned initial state: at T = 300
    (K4 in both layers, no K3/K5) and T = 1100 (K5), scores to 1e-4
    relative.  Returns the K4 launches of the T = 300 run."""
    import numpy as np
    import torch
    import yaml

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    d = yaml.safe_load(SMALL_YAML)
    d["transformer"]["layer"].update(dim=192, ffd_size=768)
    d["transformer"]["layer"]["self_attn"]["nheads"] = 3
    d["transformer"]["rpe"]["maxpos"] = 2048
    hp = Hparams.from_dict(d)
    rng = np.random.RandomState(4)
    k4_launches = None
    with precision.policy_scope(precision.Policy()):
        cpu = LVTR(hp, input_dim=80, device="cpu",
                   generator=torch.Generator("cpu").manual_seed(5))
        gpu = LVTR(hp, input_dim=80, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        for t, lens, want in ((300, [300, 1, 211], (0, 2, 0)),
                              (1100, [1100, 1030, 2], (0, 0, 2))):
            b = len(lens)
            x = np.concatenate([rng.randint(0, 50, (b, t, 1)),
                                rng.randn(b, t, 80)], -1).astype(np.float32)
            init = torch.from_numpy(
                (rng.rand(b, 1, 32) * 2 - 1).astype(np.float32))
            scores = []
            for model, where in ((cpu, "cpu"), (gpu, dev)):
                model.initial_state = (lambda generator, bsize, nfeat=None,
                                       where=where: init.to(where))
                xm = Masked.from_lengths(torch.from_numpy(x).to(where), lens)
                fa.flash_forward_packed.launches = 0
                fa.flash_forward_full.launches = 0
                fa.flash_forward_tiled.launches = 0
                with torch.no_grad():
                    scores.append(model.likelihood(xm, None).cpu().double())
                counts = (fa.flash_forward_packed.launches,
                          fa.flash_forward_full.launches,
                          fa.flash_forward_tiled.launches)
            torch.cuda.synchronize()
            rel = ((scores[1] - scores[0]).abs()
                   / scores[0].abs().clamp_min(1e-12)).max().item()
            log(f"small likelihood (dim 192, 3 heads, card vs CPU plain, "
                f"float32) T={t}: scores {scores[1].tolist()}, max rel err "
                f"{rel:.2e}; card launches (K3, K4, K5) {counts}")
            if counts != want:
                raise AssertionError(f"small likelihood T={t}: launches "
                                     f"(K3, K4, K5) {counts}, expected "
                                     f"{want}")
            if not rel <= 1e-4 or not bool(torch.isfinite(scores[1]).all()):
                raise AssertionError(f"small likelihood T={t}: the card and "
                                     "the CPU disagree")
            if t == 300:
                k4_launches = counts[1]
    return k4_launches


SCORE_SHORT, SCORE_LONG = 64, 128   # utterances of 5-20 s, then 5-35 s
SCORE_BATCH = 64                    # the infer config's batch_size


def scoring_frames(rng):
    """The synthetic corpus's lengths in 50 Hz frames, drawn uniformly
    (a length mix made to run both attention routes, not a measured
    corpus's): 64 of 250-1000 (5-20 s), then 128 of 250-1750 (5-35 s),
    each long batch holding one of exactly 1750."""
    import numpy as np

    frames = np.concatenate([rng.randint(250, 1001, SCORE_SHORT),
                             rng.randint(250, 1751, SCORE_LONG)])
    frames[SCORE_SHORT] = frames[SCORE_SHORT + SCORE_BATCH] = 1750
    return frames


def scoring_batches(seed: int = 0):
    """The frame lengths of each batch the scoring path reads from the
    corpus of ``seed`` (sequential sampler, no utterance filtered out)."""
    import numpy as np

    frames = [int(f) for f in scoring_frames(np.random.RandomState(seed))]
    return [frames[i:i + SCORE_BATCH]
            for i in range(0, len(frames), SCORE_BATCH)]


def write_scoring_corpus(root: str, seed: int = 0) -> float:
    """192 WAVs (16 kHz, 16-bit) from ``seed`` and a ``tokens.txt`` of
    random token ids at 50 Hz, of the lengths ``scoring_frames`` draws.
    Every duration is a whole number of 20 ms frames, so an utterance's
    mel frames equal its tokens.  Returns the seconds of audio."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return write_wav_corpus(root, scoring_frames(rng), rng)


def write_wav_corpus(root: str, frames, rng) -> float:
    """WAVs (16 kHz, 16-bit) of ``frames`` 50 Hz frames each (a sum of
    harmonics with a slow envelope and noise, from ``rng``) and a
    ``tokens.txt`` of random token ids at 50 Hz.  Returns the seconds of
    audio."""
    import numpy as np

    from vae_gslm_tpu_torch.data import audio

    lines = []
    for i, nf in enumerate(frames):
        n = int(nf) * 320
        t = np.arange(n, dtype=np.float32) / 16000.0
        f0 = rng.uniform(90, 250)
        wave = sum(rng.uniform(0.02, 0.1) / h
                   * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.3))
                   for h in range(1, 6))
        wave = (wave * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
                + 0.01 * rng.randn(n)).astype(np.float32)
        name = f"utt{i:03d}.wav"
        audio.save_wav(os.path.join(root, name), wave, 16000)
        lines.append(f"{name}|{' '.join(map(str, rng.randint(0, 200, nf)))}")
    with open(os.path.join(root, "tokens.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return float(np.sum(frames)) / 50.0


SCORE_INFER_YAML = """
identifier: "inference.speech.likelihood.LikelihoodEstimator"
ckpt_path: "{ckpt}"
model: {{identifier: "models.speech.lvtr.LVTR"}}
data:
    path: "{corpus}/tokens.txt"
    wavdir: "{corpus}"
    sample_rate: 16000
    with_text: false
    with_tokens: true
    batch_size: 64
    num_workers: 8
    min_audio_length: 5.0
    bits_per_second: 32000
    pad: {{multiple_of: 320, mode: "constant"}}
    sampler: {{type: "standard", shuffle: false}}
trainer: {{distributed: false}}
"""


def write_flagship(root: str, dev, seed: int = 0, nheads: int = 0,
                   layers: int = 0):
    """The checkpoint directory of the full-width LVTR of
    ``configs/train/speech/vae-gslm.yaml`` with its utterance encoder
    (weights from ``seed``, float32, saved by the port's ``save_compact``
    with the train config as ``hp.yaml``) and a HiFi-GAN directory of
    the 80-bin vocoder config (weights from seed 1, ``save_pretrained``),
    written once under ``root`` for the scoring and the CLI phases
    (``nheads``: the trunk's heads instead of the config's 16; ``layers``
    its layers).  Returns (checkpoint directory, vocoder directory)."""
    import torch

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
    from vae_gslm_tpu_torch.training.checkpoint import save_compact

    ckpt, voc = os.path.join(root, "ckpt"), os.path.join(root, "voc")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    HiFiGAN(Hparams.from_yamlfile(VOCODER_YAML), device=dev,
            generator=torch.Generator(dev).manual_seed(1)
            ).save_pretrained(voc)
    hp = Hparams.from_yamlfile(TRAIN_YAML)
    hp.vocoder.path = voc
    if nheads:
        hp.model.transformer.layer.self_attn.nheads = nheads
    if layers:
        hp.model.transformer.num_layers = layers
    model = LVTR(hp.model, input_dim=80, device=dev,
                 generator=torch.Generator(dev).manual_seed(seed))
    nparams = sum(p.numel() for p in model.parameters())
    save_compact(model, os.path.join(ckpt, "last-cpt.npz"))
    hp.save(os.path.join(ckpt, "hp.yaml"))
    del model
    log(f"flagship: LVTR {nparams / 1e6:.1f} M parameters (with the "
        f"utterance encoder) saved with save_compact, and the vocoder, in "
        f"{time.perf_counter() - t0:.1f} s")
    return ckpt, voc


def phase_score(dev, gpu: str, ckpt: str, seed: int = 0) -> int:
    """The scoring path at full width: ``LikelihoodEstimator`` on the
    flagship checkpoint directory (``write_flagship``: the LVTR of
    ``configs/train/speech/vae-gslm.yaml``, weights from seed 0, and the
    80-bin vocoder directory), over a synthetic
    corpus of 192 WAVs with the infer config's data settings (batch 64,
    ``min_audio_length`` 5.0, padding to a multiple of 320 samples;
    ``bits_per_second`` 32000, the rate of 16-bit 16 kHz WAV), float32
    with TF32 off.  One warm-up batch, then the whole corpus with the
    kernels' counts set to 0 just before each batch and read just after:
    exactly 16 K3 launches per batch padded to <= 1024 frames, exactly
    16 K5 launches per batch past it, no K4 launch and no plain version
    (both refused); finite scores, all <= 0.  Then one profiled batch
    past 1024 frames.  Returns the K5 launches of the scored corpus."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.likelihood import \
        LikelihoodEstimator
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    tmp = tempfile.mkdtemp(prefix="score_")
    saved = (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
             fa.flash_forward_full_plain, fa.flash_forward_full,
             fa.attention_reference, attn_mod.attend)

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"the scoring path reached {what} on the "
                                 "card")
        return fn

    try:
        with precision.policy_scope(precision.Policy()):
            corpus = os.path.join(tmp, "corpus")
            os.makedirs(corpus)
            t0 = time.perf_counter()
            audio_s = write_scoring_corpus(corpus, seed)
            t2 = time.perf_counter()
            est = LikelihoodEstimator(Hparams.from_yaml(SCORE_INFER_YAML.format(
                ckpt=ckpt, corpus=corpus)), device=dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            log(f"score: corpus of {SCORE_SHORT + SCORE_LONG} WAVs "
                f"({audio_s:.1f} s of audio) written in {t2 - t0:.1f} s; "
                f"LikelihoodEstimator (checkpoint and vocoder loaded "
                f"strictly) built in {t3 - t2:.1f} s")
            (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
             fa.flash_forward_full_plain, fa.flash_forward_full,
             fa.attention_reference, attn_mod.attend) = (
                refuse("the plain K3"), refuse("the plain K5"),
                refuse("the plain K4"), refuse("K4"),
                refuse("the dense attention reference"),
                refuse("the dense attention"))
            step, per_batch = est.test_step, []

            def counted(batch, generator):
                fa.flash_forward_packed.launches = 0
                fa.flash_forward_tiled.launches = 0
                out = step(batch, generator)
                per_batch.append((int(batch["tokens"].value.shape[1]),
                                  fa.flash_forward_packed.launches,
                                  fa.flash_forward_tiled.launches,
                                  batch["tokens"].lengths.tolist()))
                return out

            est.test_step = counted
            est.run(seed=seed, max_batches=1)          # warm-up
            per_batch.clear()
            # reference cycles of earlier phases can still hold device
            # tensors here; collect them so that the peak is this path's
            before = torch.cuda.memory_allocated()
            gc.collect()
            resident = torch.cuda.memory_allocated()
            log(f"score: {resident / 2 ** 30:.2f} GiB allocated before the "
                f"timed run, {(before - resident) / 2 ** 30:.2f} GiB more "
                "before collecting earlier phases' garbage")
            torch.cuda.reset_peak_memory_stats()
            timings = {}
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            scores = est.run(seed=seed, timings=timings)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t4
            peak = torch.cuda.max_memory_allocated()
            for i, (t, k3n, k5n, _) in enumerate(per_batch):
                log(f"score batch {i}: padded to {t} frames, K3 launches "
                    f"{k3n}, K5 launches {k5n}")
                want = (16, 0) if t <= 1024 else (0, 16)
                if (k3n, k5n) != want:
                    raise AssertionError(f"batch {i} ({t} frames): (K3, K5) "
                                         f"launches {(k3n, k5n)}, expected "
                                         f"{want}")
            batches = scoring_batches(seed)
            if [(t, lens) for t, _, _, lens in per_batch] != [
                    (max(lens), lens) for lens in batches] \
                    or not any(max(lens) > 1024 for lens in batches):
                raise AssertionError(
                    f"batches padded to {[b[0] for b in per_batch]} frames: "
                    "expected the padded lengths and lengths that phases 5 "
                    f"and 5b hold K3 and K5 at ({[max(x) for x in batches]}"
                    "), one past 1024 frames or more")
            n = SCORE_SHORT + SCORE_LONG
            if scores.shape != (n,) or not np.isfinite(scores).all() \
                    or not (scores <= 0).all():
                raise AssertionError(f"scores: shape {scores.shape}, finite "
                                     f"{np.isfinite(scores).all()}, max "
                                     f"{scores.max()}")
            log(f"score: {n} utterances ({audio_s:.1f} s of audio) in "
                f"{wall:.3f} s: {n / wall:.2f} utterances/s, "
                f"{audio_s / wall:.1f} s of audio scored per wall second; "
                f"model {timings['model']:.3f} s, data (waiting for the "
                f"loader) {timings['data']:.3f} s; peak memory "
                f"{peak / 2 ** 30:.2f} GiB ({gpu}); scores mean "
                f"{scores.mean():.4f}, range {scores.min():.4f} to "
                f"{scores.max():.4f}")
            k5_launches = sum(b[2] for b in per_batch)

            batches = iter(est.test_dataloader())
            next(batches)
            long_batch = next(batches)
            batches.close()
            g = torch.Generator(dev).manual_seed(seed)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t5 = time.perf_counter()
                step(long_batch, g)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t5) * 1e3
            # The loader's threads issue the mel kernels on the stream the
            # model uses, so kernels of prefetched batches fall inside the
            # model time; one loader pass alone says how much they are.
            with profile(activities=[ProfilerActivity.CUDA]) as dprof:
                t6 = time.perf_counter()
                for _ in est.test_dataloader():
                    pass
                torch.cuda.synchronize()
                data_wall = time.perf_counter() - t6
    finally:
        (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
         fa.flash_forward_full_plain, fa.flash_forward_full,
         fa.attention_reference, attn_mod.attend) = saved
        shutil.rmtree(tmp, ignore_errors=True)
    data_busy = sum(e.self_device_time_total
                    for e in dprof.key_averages()) / 1e3
    log(f"score data path alone (one loader pass over the corpus, no model, "
        f"profiler on): wall {data_wall:.3f} s, device busy {data_busy:.1f} "
        f"ms, the most of the model time above that is mel work of "
        f"prefetched batches ({gpu})")
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    if not kernels:
        log("score batch profile: device time not measured (the profiler "
            "recorded no kernel)")
        return k5_launches
    busy = sum(k[0] for k in kernels)
    k5 = sum(k[0] for k in kernels if "k5_fwd" in k[2])
    log(f"score batch profile (B=64, {long_batch['tokens'].value.shape[1]} "
        f"frames, profiler on): wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), K5 {k5:.1f} ms "
        f"({k5 / busy:.1%} of busy), {sum(k[1] for k in kernels)} device "
        f"ops ({gpu})")
    for ms, cnt, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:.3f} ms, {cnt}x: {name[:90]}")
    return k5_launches


# ------------------------------------------------------------------ CLI
INFER_YAML = os.path.join(ROOT, "configs", "infer", "speech",
                          "vae-gslm.yaml")
CLI_UTTERANCES = 64                 # the infer config's batch_size


def write_cli_corpus(root: str, n: int = CLI_UTTERANCES,
                     seed: int = 0) -> str:
    """``n`` WAVs of 5-13 s and their tokens file from ``seed`` (the
    training corpus writer, without mels), and the shipped infer config
    with only ``ckpt_path``, ``vocoder.path``, ``data.path``,
    ``data.wavdir`` and ``output_dir`` pointed under ``root`` (the corpus
    in ``corpus{n}``), and ``data.batch_size`` set to ``n`` where it is
    not the config's.  Returns the config's path."""
    import yaml

    corpus = os.path.join(root, f"corpus{n}")
    os.makedirs(corpus)
    write_train_corpus(corpus, None, n, 5.0, 13.0, seed)
    with open(INFER_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["ckpt_path"] = os.path.join(root, "ckpt")
    cfg["vocoder"]["path"] = os.path.join(root, "voc")
    cfg["data"].update(path=os.path.join(corpus, "tokens.txt"),
                       wavdir=corpus, batch_size=n)
    cfg["output_dir"] = os.path.join(root, f"samples{n}")
    path = os.path.join(root, f"infer{n}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_cli(dev, gpu: str, config: str, w4: bool = False,
              n_wavs: int = CLI_UTTERANCES) -> int:
    """The speech-continuation CLI at full width: ``scripts/infer.py``'s
    ``main`` in this process on the shipped infer config (``write_cli_
    corpus``), one batch of ``n_wavs`` (500 AR steps, DDIM-100 at eta 0.5
    with the utterance embedding, HiFi-GAN, the energy-VAD trim), the
    bf16-mixed policy, int8 KV cache and int8 weights; with ``w4`` under
    ``VAE_GSLM_MEGA_W4=1``.  The decode kernels' counts are set to 0 just
    before ``main`` and read just after: at 64 (two sequential B = 32
    chunks) exactly 1000 launches of K2's bf16 branch (int8; one
    persistent launch a step) or of K2-w4 (w4), no other K2 and no K1 or
    K6; at 128 (the per-layer int8 route, JAX's ``decode_attention``) no
    K1, K2, K2-w4 or K6 launch.  Checks
    ``n_wavs`` finite 16 kHz WAVs, none longer than the prompt + 10 s.
    Reports the real-time factor over the whole ``main`` call (model
    build, data, sampling, vocoder, WAV writing: ``n_wavs`` x 10 s over
    its wall time), the stage times and the peak memory.  Returns the
    K2-bf16 or K2-w4 launches."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from vae_gslm_tpu_torch.data import audio
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step
    from vae_gslm_tpu_torch.scripts import infer as infer_cli

    with open(config) as f:
        out_dir = yaml.safe_load(f)["output_dir"]
    shutil.rmtree(out_dir, ignore_errors=True)
    chunked = n_wavs <= 64
    path = ("int4 weights, K2-w4" if w4 else "int8 weights, K2-bf16"
            if chunked else "int8 weights, per-layer int8 cache")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    old = os.environ.pop("VAE_GSLM_MEGA_W4", None)
    if w4:
        os.environ["VAE_GSLM_MEGA_W4"] = "1"
    try:
        fused_decode_attention.launches = flash_decode_int8.launches = 0
        fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
        fused_trunk_step.launches_bf16 = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = infer_cli.main(["-c", config, "--max_batches", "1", "--seed",
                            "0"], timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fused_decode_attention.launches, fused_trunk_step.launches,
                  fused_trunk_step.launches_bf16,
                  fused_trunk_step.launches_w4, flash_decode_int8.launches)
    finally:
        os.environ.pop("VAE_GSLM_MEGA_W4", None)
        if old is not None:
            os.environ["VAE_GSLM_MEGA_W4"] = old
    peak = torch.cuda.max_memory_allocated()
    k2 = n_wavs // 32 * LENGTH if chunked else 0
    want = (0, 0, 0, k2, 0) if w4 else (0, 0, k2, 0, 0)
    if counts != want:
        raise AssertionError(f"CLI ({path}): launches (K1, K2-a8, K2-bf16, "
                             f"K2-w4, K6) = {counts}, expected {want}")
    names = sorted(os.listdir(out_dir), key=lambda n: int(n.split(".")[0]))
    if n != n_wavs or names != [f"{i}.wav" for i in range(1, n_wavs + 1)]:
        raise AssertionError(f"CLI ({path}): {n} outputs, files {names[:4]}"
                             f"... ({len(names)})")
    lens = []
    for name in names:
        wave, sr = audio.load_audio(os.path.join(out_dir, name))
        lens.append(len(wave))
        if sr != 16000 or not 0 < len(wave) <= (PROMPT + LENGTH) * 320 \
                or not np.isfinite(wave).all():
            raise AssertionError(f"CLI ({path}) {name}: {len(wave)} samples "
                                 f"at {sr} Hz")
    trimmed = sum(x < (PROMPT + LENGTH) * 320 for x in lens)
    audio_s = n_wavs * LENGTH / 50.0
    how = "as two B=32 chunks" if chunked else "per layer"
    log(f"CLI ({path}), B={n_wavs} {how}: K1 {counts[0]}, K2-a8 "
        f"{counts[1]}, K2-bf16 {counts[2]}, K2-w4 {counts[3]}, K6 "
        f"{counts[4]} launches; {n} "
        f"WAVs of {min(lens) / 16000:.2f}-{max(lens) / 16000:.2f} s ({trimmed}"
        f" shortened by the VAD trim); " + ", ".join(
            f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; main wall {wall:.3f} s, real-time factor "
        f"{audio_s / wall:.2f}x with model build, data and WAV writing "
        f"({audio_s / sum(timings.values()):.2f}x over the timed stages); "
        f"peak memory {peak / 2 ** 30:.2f} GiB ({gpu})")
    return counts[3] if w4 else counts[2]


# --------------------------------------------------------------- K4b/K5b
K4B_LENGTHS = [640, 320, 300, 640, 1, 639, 0, 64]
K5B_T, K5B_LENGTHS = 1536, [1536, 1]
# the bf16 backward (bwd_wgmma) held at more shapes: (name, B, T, H,
# lengths), causal, Tq = Tk; partial last tiles, K4b's largest T, and
# K5b at the envelope's edge, Tk 8192
BWD_BF16_MORE = (("K4b", 4, 200, 2, [200, 77, 1, 0]),
                 ("K4b", 4, 1000, 4, [1000, 0, 1, 611]),
                 ("K4b", 4, 1024, 4, [1024, 1, 0, 700]),
                 ("K5b", 3, 1100, 3, [1100, 1, 0]),
                 ("K5b", 3, 8192, 2, [8192, 1, 0]))


def bhtd_grad(dtype, dev, b: int, tq: int, h: int, seed: int):
    """dO (B, H, Tq, D) as a strided view of a packed (B, Tq, H D) tensor,
    as the backward of the packed output hands it over."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((b, tq, h * D), generator=g, device=dev).to(dtype)
    return x.view(b, tq, h, D).transpose(1, 2)


def bwd_bytes_ops(b: int, tq: int, tk: int, h: int, lengths, causal: bool,
                  itemsize: int, n_stats: int, d: int = D):
    """Bytes and FLOPs of one K4b/K5b call's kernels on these inputs
    (``delta`` comes in computed, as K3b's): q and dO read and dq
    written (B x Tq rows), k and v read below each length (all Tk for a
    row of length 0), dk and dv written (B x Tk rows), ``n_stats``
    float32 (B, H, Tq) rows read (delta, and K4b's lse); the 5 products
    (QK, dO V, dS K, dS^T Q, P^T dO) of 2 D FLOPs over the (query, key)
    pairs the causal and length masks leave (``h`` heads of ``d``)."""
    row = h * d * itemsize
    kv = sum(ln if ln >= 1 else tk for ln in lengths) * row
    nbytes = (3 * b * tq + 2 * b * tk) * row + 2 * kv \
        + n_stats * b * h * tq * 4 + b * 4 + h * 4

    def keys(r, ln):
        if ln < 1:
            return tk
        return min(r + 1, ln) if causal else min(ln, tk)

    pairs = h * sum(sum(keys(r, ln) for r in range(tq)) for ln in lengths)
    return nbytes, 5 * 2 * d * pairs


def phase_k45b(dev, k4_worst: float):
    """K4 (the (B, H, T, D) full forward with lse) and K4b (its backward
    from that lse) at the data-parallel training call (B 8, 16 heads of
    64, T 640, causal, lengths down to 0 and 1), and K5b (the blockwise
    backward) at the long-segment call (B 2, T 1536, lengths 1536 and 1)
    and at Tq 96 x Tk 256 (non-causal, lengths 256, 0, 1), float32 and
    bfloat16, ALiBi, from strided views of packed projections with o
    from K4/K5, against their plain versions: K4's o and lse at
    phase_k45's tolerances; K4b and K5b at K3b's, float32 1e-4 x
    max|ref|, bf16 2e-2 x max|ref| and element by element 2 bf16 ulps +
    2e-2 rms(ref), relative L2 1e-3 (dk and dv sum every query row's
    share in float32 in another order than the plain einsum, and a ds
    one ulp apart rounds to another bf16 value).  Then their bf16 times
    (the 16-mixed path's type), K4 and K4b at the training call, K5b at
    the long-segment one: kernels (profiler, every launch of the window
    counted), per call with the wrapper (CUDA events; K4b/K5b's delta
    included), plain, SDPA with a float mask (forward for K4, with the
    ratio; for K4b/K5b its backward alone, the library time, and
    forward+backward, with the kernels' ratio to the backward alone),
    and the bound.  K4 bf16 is also held at T 200, 1000 and 1024
    (lengths 0 and 1 among them), with lse and without, and the bf16
    backward (``bwd_wgmma``) at ``BWD_BF16_MORE``: K4b at T 200, 1000 and
    1024 and K5b at T 1100 and 8192 (Tk at the envelope's edge; its
    plain version one batch row at a time), at the same tolerances.
    Returns the K4, K4b and K5b entries (K4's error also covers
    phase_k45's odd-head case, ``k4_worst``)."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    worst = {"K4": k4_worst, "K4b": 0.0, "K5b": 0.0, "f32": 0.0}
    cases = (("K4b", K3_B, K3_T, K3_T, K4B_LENGTHS, True),
             ("K5b", 2, K5B_T, K5B_T, K5B_LENGTHS, True),
             ("K5b", 3, 96, 256, [256, 0, 1], False))
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    for (name, b, tq, tk, lens, causal), dtype in \
            itertools.product(cases, (torch.float32, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        q, k, v = bhtd_inputs(dtype, dev, b, tq, tk, H, seed=tq + 1)
        do = bhtd_grad(dtype, dev, b, tq, H, seed=tq + 2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        if name == "K4b":
            o, lse = fa.flash_forward_full(q, k, v, lengths, slopes, causal,
                                           with_stats=True)
            o_ref, lse_ref = fa.flash_forward_full_plain(
                q, k, v, lengths, slopes, causal, with_stats=True)
            torch.cuda.synchronize()
            where = (f"K4 B={b} T={tq} H={H} {str(dtype)[6:]} "
                     f"causal={causal} alibi=True (the training call)")
            errs = []
            for n, g_, r_ in (("o", o, o_ref), ("lse", lse, lse_ref)):
                tol = 1e-2 if bf16 and n == "o" else 1e-5
                err, text = hold(where, n, g_, r_, tol,
                                 0.0 if bf16 and n == "o" else 1.0, bf16)
                errs.append(text)
                if n == "o":
                    worst["K4"] = max(worst["K4"], err)
            log(f"K4 check {where}: max_abs_err " + ", ".join(errs))
            del o_ref, lse_ref
            extra = (lse,)
            fn, plain = fa.flash_backward_full, fa.flash_backward_full_plain
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
            extra = ()
            fn, plain = (fa.flash_backward_blockwise,
                         fa.flash_backward_blockwise_plain)
        got = fn(q, k, v, o, do, *extra, lengths, slopes, causal)
        want = plain(q, k, v, o, do, *extra, lengths, slopes, causal)
        torch.cuda.synchronize()
        where = (f"{name} B={b} Tq={tq} Tk={tk} H={H} {str(dtype)[6:]} "
                 f"causal={causal}")
        errs = []
        for n, g_, r_ in zip(("dq", "dk", "dv"), got, want):
            if g_.dtype != dtype or g_.shape != r_.shape:
                raise AssertionError(f"{where}: {n} is {g_.dtype} "
                                     f"{tuple(g_.shape)}")
            err, text = hold(where, n, g_, r_, 2e-2 if bf16 else 1e-4, 0.0,
                             bf16)
            worst[name] = max(worst[name], err)
            if not bf16:
                worst["f32"] = max(worst["f32"], err)
            errs.append(text)
        log(f"{name} check {where}: max_abs_err " + ", ".join(errs))
        del got, want

    # the bf16 K4 forward at a partial last tile and at its largest
    # resident key sets, with lse and without (the scoring route's call)
    for b, t, h, lens in ((4, 200, 2, [200, 77, 1, 0]),) + K3_LONG:
        q, k, v = bhtd_inputs(torch.bfloat16, dev, b, t, t, h, seed=t + 3)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sl = -torch.tensor(alibi_slopes(h), device=dev)
        o, lse = fa.flash_forward_full(q, k, v, lengths, sl, True,
                                       with_stats=True)
        o_only = fa.flash_forward_full(q, k, v, lengths, sl, True)
        o_ref, lse_ref = fa.flash_forward_full_plain(q, k, v, lengths, sl,
                                                     True, with_stats=True)
        torch.cuda.synchronize()
        where = f"K4 B={b} T={t} H={h} bfloat16 causal=True alibi=True"
        errs = []
        for n, g_, r_ in (("o", o, o_ref), ("lse", lse, lse_ref),
                          ("o without lse", o_only, o_ref)):
            err, text = hold(where, n, g_, r_, 1e-5 if n == "lse" else 1e-2,
                             1.0 if n == "lse" else 0.0, True)
            errs.append(text)
            if n != "lse":
                worst["K4"] = max(worst["K4"], err)
        log(f"K4 check {where}: max_abs_err " + ", ".join(errs))
        del q, k, v, o, lse, o_only, o_ref, lse_ref

    # the bf16 backward at partial last tiles, K4b's largest T and K5b's
    # largest Tk (its plain version one batch row at a time)
    for name, b, t, h, lens in BWD_BF16_MORE:
        q, k, v = bhtd_inputs(torch.bfloat16, dev, b, t, t, h, seed=t + 5)
        do = bhtd_grad(torch.bfloat16, dev, b, t, h, seed=t + 6)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sl = -torch.tensor(alibi_slopes(h), device=dev)
        if name == "K4b":
            o, lse = fa.flash_forward_full(q, k, v, lengths, sl, True,
                                           with_stats=True)
            got = fa.flash_backward_full(q, k, v, o, do, lse, lengths, sl,
                                         True)
            want = in_chunks(lambda r: fa.flash_backward_full_plain(
                q[r], k[r], v[r], o[r], do[r], lse[r], lengths[r], sl,
                True), b, 1)
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, sl, True)
            got = fa.flash_backward_blockwise(q, k, v, o, do, lengths, sl,
                                              True)
            want = in_chunks(lambda r: fa.flash_backward_blockwise_plain(
                q[r], k[r], v[r], o[r], do[r], lengths[r], sl, True), b, 1)
        torch.cuda.synchronize()
        where = f"{name} B={b} T={t} H={h} bfloat16 causal=True alibi=True"
        errs = []
        for n, g_, r_ in zip(("dq", "dk", "dv"), got, want):
            err, text = hold(where, n, g_, r_, 2e-2, 0.0, True)
            worst[name] = max(worst[name], err)
            errs.append(text)
        log(f"{name} check {where}: max_abs_err " + ", ".join(errs))
        del q, k, v, do, o, got, want

    def entry(name, fn_name, line, ms, plain_ms, bound, by, lib):
        return {"name": fn_name, "route": "cuda",
                "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"vae_gslm_tpu/ops/flash_attention.py:{line}",
                "launches": None, "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": lib}

    def bound_of(nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations"

    out = {}
    dtype = torch.bfloat16
    for name, b, t, lens in (("K4b", K3_B, K3_T, K4B_LENGTHS),
                             ("K5b", 2, K5B_T, K5B_LENGTHS)):
        q, k, v = bhtd_inputs(dtype, dev, b, t, t, H, seed=1)
        do = bhtd_grad(dtype, dev, b, t, H, seed=2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = sdpa_mask(lengths, slopes, dtype, dev, t, t, True)
        if name == "K4b":
            def fwd(i):
                return fa.flash_forward_full(q, k, v, lengths, slopes, True,
                                             with_stats=True)

            def fwd_plain(i):
                return fa.flash_forward_full_plain(q, k, v, lengths, slopes,
                                                   True, with_stats=True)

            def sdpa_fwd(i):
                with torch.no_grad():
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask)

            kf = device_ms(fwd, n=20, only=("k4_fwd",), per_call=1)
            cf = cuda_ms(fwd, n=20)
            pf = device_ms(fwd_plain, n=3)
            lf = library_ms(sdpa_fwd, n=20)
            nbytes, flops = bhtd_bytes_ops(b, t, t, H, lens, True, 2)
            nbytes += b * H * t * 4                    # lse written
            bound, by = bound_of(nbytes, flops)
            log(f"K4 time B={b} T={t} H={H} bf16 with lse (the training "
                f"call): kernel {kf:.4f} ms, {cf:.4f} ms per call with the "
                f"wrapper, plain {pf:.4f} ms, SDPA (float mask) forward "
                f"{lf:.4f} ms (kernel / SDPA {kf / lf:.3f}), bound "
                f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP)")
            out["K4"] = entry("K4", "flash_forward_full", 406, kf, pf, bound,
                              by, lf)
            o, lse = fwd(0)

            def call(i):
                return fa.flash_backward_full(q, k, v, o, do, lse, lengths,
                                              slopes, True)

            def plain(i):
                return fa.flash_backward_full_plain(q, k, v, o, do, lse,
                                                    lengths, slopes, True)
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, slopes, True)

            def call(i):
                return fa.flash_backward_blockwise(q, k, v, o, do, lengths,
                                                   slopes, True)

            def plain(i):
                return fa.flash_backward_blockwise_plain(
                    q, k, v, o, do, lengths, slopes, True)
        # the dq and dk/dv kernels (K5b's row statistics inside dq)
        kt = device_ms(call, n=20, only=(name.lower() + "_",),
                       per_call=2 if name == "K4b" else fa.K5B_BF16_KERNELS)
        ct = cuda_ms(call, n=20)
        pt = device_ms(plain, n=3)
        q4, k4, v4 = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd(i):
            F.scaled_dot_product_attention(q4, k4, v4,
                                           attn_mask=mask).backward(do)

        lt = library_ms(sdpa_fwd_bwd, n=10)
        lb = sdpa_bwd_ms(q, k, v, do, mask)
        del mask
        nbytes, flops = bwd_bytes_ops(b, t, t, H, lens, True, 2,
                                      2 if name == "K4b" else 1)
        bound, by = bound_of(nbytes, flops)
        log(f"{name} time B={b} T={t} H={H} bf16: kernels {kt:.4f} ms, "
            f"{ct:.4f} ms per call with the wrapper (delta included), plain "
            f"{pt:.4f} ms, SDPA (float mask) backward alone {lb:.4f} ms "
            f"(kernels / SDPA backward {kt / lb:.3f}), "
            f"forward+backward {lt:.4f} ms, bound of the kernels "
            f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        out[name] = entry(name, "flash_backward_full" if name == "K4b"
                          else "flash_backward_blockwise",
                          735 if name == "K4b" else 682, kt, pt, bound, by,
                          lb)
        del q, k, v, do, o

    # the float32 backward (dq_f32 then dkv_f32: the trainer's default
    # precision) at the same two calls, beside SDPA's float32 backward
    # alone and the float32 operations bound
    dtype, f32 = torch.float32, {}
    for name, b, t, lens in (("K4b", K3_B, K3_T, K4B_LENGTHS),
                             ("K5b", 2, K5B_T, K5B_LENGTHS)):
        q, k, v = bhtd_inputs(dtype, dev, b, t, t, H, seed=1)
        do = bhtd_grad(dtype, dev, b, t, H, seed=2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        if name == "K4b":
            o, lse = fa.flash_forward_full(q, k, v, lengths, slopes, True,
                                           with_stats=True)
            args = (q, k, v, o, do, lse, lengths, slopes, True)
            fn, plain = fa.flash_backward_full, fa.flash_backward_full_plain
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, slopes, True)
            args = (q, k, v, o, do, lengths, slopes, True)
            fn, plain = (fa.flash_backward_blockwise,
                         fa.flash_backward_blockwise_plain)
        kt = device_ms(lambda i: fn(*args), n=10, only=(name.lower() + "_",),
                       per_call=2 if name == "K4b" else fa.K5B_F32_KERNELS)
        ct = cuda_ms(lambda i: fn(*args), n=10)
        pt = device_ms(lambda i: plain(*args), n=2)
        mask = sdpa_mask(lengths, slopes, dtype, dev, t, t, True)
        lb = sdpa_bwd_ms(q, k, v, do, mask)
        del mask
        nbytes, flops = bwd_bytes_ops(b, t, t, H, lens, True, 4,
                                      2 if name == "K4b" else 1)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        bound = max(t_b, t_o) * 1e3
        by = "bytes" if t_b > t_o else "operations"
        log(f"{name} time B={b} T={t} H={H} float32: kernels {kt:.4f} ms, "
            f"{ct:.4f} ms per call with the wrapper (delta included), plain "
            f"{pt:.4f} ms, SDPA (float32, float mask) backward alone "
            f"{lb:.4f} ms (kernels / SDPA backward {kt / lb:.3f}), bound of "
            f"the kernels {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP at the float32 FMA rate)")
        f32[name] = (kt, pt, bound, by, lb)
        del q, k, v, do, o
    kt, pt, bound, by, lb = f32["K4b"]
    out["f32"] = {
        "name": "flash_backward_full (float32: k4b_dq_kernel, "
                "k4b_dkv_kernel; K3b's and K5b's on the same body)",
        "route": "cuda",
        "source": "vae_gslm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vae_gslm_tpu/ops/flash_attention.py:735",
        "launches": None, "max_abs_err": worst["f32"], "ms": kt,
        "plain_ms": pt, "bound_ms": bound, "bound_by": by, "library_ms": lb}
    return out["K4"], out["K4b"], out["K5b"], out["f32"]


# ------------------------------------------------------------------ K6
K6_B, K6_T = 128, 768               # the per-layer path's batch; 651 -> 768
K6_CASES = (151, 255, 256, 400, 511, 512, 650)


def k6_inputs(dev, seed: int = 0):
    """An int8 per-layer cache (B 128, 16 heads, T 768) quantized from
    normal rows by the port's ``quantize_i8``, a bfloat16 q as a view of one fused qkv projection (as the per-layer
    step hands it over) and the ALiBi slopes."""
    import torch

    from vae_gslm_tpu_torch.nn.attention import quantize_i8
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes

    g = torch.Generator(dev).manual_seed(seed)
    k8, ks = quantize_i8(torch.randn((K6_B, H, K6_T, D), generator=g,
                                     device=dev))
    v8, vs = quantize_i8(torch.randn((K6_B, H, K6_T, D), generator=g,
                                     device=dev))
    qkv = torch.randn((K6_B, 3 * H * D), generator=g, device=dev).to(
        torch.bfloat16)
    q = qkv.view(K6_B, 3, H, D)[:, 0]
    slopes = -torch.tensor(alibi_slopes(H), device=dev)
    return q, k8, v8, ks, vs, slopes


def k6_bytes(pos: int, q_itemsize: int = 2) -> int:
    """Bytes one call must move: the valid rows' int8 K and V and their
    two float32 scales, q in, the float32 output, the slopes."""
    return (K6_B * H * ((pos + 1) * (2 * D + 8) + D * (q_itemsize + 4))
            + H * 4)


def phase_k6(dev):
    """K6 against its plain version at the per-layer path's calls (B 128,
    16 heads of 64, T 768) at the rollout's cache states ``K6_CASES``,
    to ``1e-5 * max|ref|`` (float32, both
    summing in 256-key blocks); then, over every 50th position of the
    151 -> 650 rollout, its device time, the time per call with the
    wrapper, the plain version's time, JAX's route as ported
    (``decode_attention`` over the int8 cache at the sampler's segment
    window, the A/B beside the kernel) and the bytes bound."""
    import torch

    from vae_gslm_tpu_torch.inference.speech.sampler import (
        n_segments, segment_windows)
    from vae_gslm_tpu_torch.ops.decode_attention import decode_attention
    from vae_gslm_tpu_torch.ops.flash_decode import (
        flash_decode_int8 as k6, flash_decode_int8_plain as plain)

    q, k8, v8, ks, vs, slopes = k6_inputs(dev)
    worst = 0.0
    for pos in K6_CASES:
        want = plain(q, k8, v8, ks, vs, pos, slopes)
        got = k6(q, k8, v8, ks, vs, pos, slopes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        log(f"K6 check B={K6_B} T={K6_T} pos={pos}: "
            f"max_abs_err={err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"pos {pos}")
        worst = max(worst, err)
    pos0 = PROMPT + 1
    segments = segment_windows(pos0, LENGTH, n_segments(LENGTH),
                               pos0 + LENGTH)
    ks_, calls, ps, js, bs = [], [], [], [], []
    for pos in range(pos0, pos0 + LENGTH, 50):
        window = next(w for a, e, w in segments if a <= pos - pos0 < e)

        def kernel(i):
            return k6(q, k8, v8, ks, vs, pos, slopes)

        ks_.append(device_ms(kernel, n=100, only=("flash_decode_kernel",),
                             per_call=1))
        calls.append(cuda_ms(kernel, n=100))
        ps.append(device_ms(lambda i: plain(q, k8, v8, ks, vs, pos, slopes),
                            n=5))
        js.append(device_ms(lambda i: decode_attention(
            q, k8, v8, pos, slopes, window=window, k_scale=ks, v_scale=vs),
            n=10))
        bs.append(k6_bytes(pos) / HBM_BYTES_PER_S * 1e3)
        log(f"K6 time B={K6_B} pos={pos}: kernel {ks_[-1] * 1e3:.2f} us, "
            f"{calls[-1] * 1e3:.2f} us per call with the wrapper, plain "
            f"{ps[-1] * 1e3:.1f} us, JAX's route (decode_attention, window "
            f"{window}) {js[-1] * 1e3:.1f} us, bound {bs[-1] * 1e3:.2f} us "
            f"({k6_bytes(pos) / 1e6:.1f} MB)")
    log(f"K6 mean over the rollout: kernel {statistics.mean(ks_) * 1e3:.2f} "
        f"us, {statistics.mean(calls) * 1e3:.2f} us per call with the "
        f"wrapper, plain {statistics.mean(ps) * 1e3:.1f} us, JAX's route "
        f"{statistics.mean(js) * 1e3:.1f} us, bound "
        f"{statistics.mean(bs) * 1e3:.2f} us")
    log("K6 library_ms: null (no single PyTorch call computes this "
        "int8-dequantizing decode attention)")
    return {"name": "flash_decode_int8", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/flash_decode.cu",
            "replaces": "vae_gslm_tpu/ops/flash_decode.py:131",
            "launches": None, "max_abs_err": worst,
            "ms": mean_ms(ks_), "plain_ms": mean_ms(ps),
            "bound_ms": statistics.mean(bs), "bound_by": "bytes",
            "library_ms": None}


# ------------------------------------------------------------------ K7
def phase_k7(dev, gpu: str):
    """K7's per-layer and tile sums against its plain version on the
    seed-0 (16, 1024, 12288) int8 stack, exactly; its plain version's and
    one ``torch.sum`` call's device times; then
    ``scripts/bench_slope.py``'s slopes (K7's microseconds per call and
    GB/s, K2's full step at flushed 0 and 512) with K7's count set to 0
    just before and read just after."""
    import torch

    from vae_gslm_tpu_torch.ops.stream import stream_sums, stream_sums_plain
    from vae_gslm_tpu_torch.scripts import bench_slope

    g = torch.Generator(dev).manual_seed(0)
    w = torch.randint(-127, 128, (bench_slope.L, bench_slope.R,
                                  bench_slope.C), generator=g, device=dev,
                      dtype=torch.int8)
    got, want = stream_sums(w), stream_sums_plain(w)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("K7's sums differ from its plain version's")
    log(f"K7 check: per-layer sums and k_block's tile sum "
        f"({int(got[1])}) equal to the plain version's")
    plain_ms = device_ms(lambda i: stream_sums_plain(w), n=5)
    lib_ms = library_ms(lambda i: w.sum(dim=(1, 2)), n=5)
    nbytes = w.numel()
    del w, got, want
    stream_sums.launches = 0
    res = bench_slope.run(dev)
    launches = stream_sums.launches
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    share = res["stream_gb_s"] * 1e9 / HBM_BYTES_PER_S
    log(f"bench_slope: K7 {res['stream_us']:.2f} us per call, "
        f"{res['stream_gb_s']:.1f} GB/s ({share:.1%} of the data sheet's "
        f"3.35 TB/s), bound {bound * 1e3:.2f} us "
        f"({nbytes / 1e6:.1f} MB), {launches} launches; plain "
        f"{plain_ms * 1e3:.1f} us, torch.sum {lib_ms * 1e3:.1f} us; K2 "
        f"full step B=8 a8: {res['mega_us_flushed_0']:.1f} us at flushed 0, "
        f"{res['mega_us_flushed_512']:.1f} us at flushed 512 ({gpu})")
    return {"name": "stream_sums", "route": "cuda",
            "source": "vae_gslm_tpu_torch/csrc/stream.cu",
            "replaces": "tools/bench_slope.py:56",
            "launches": launches, "max_abs_err": 0.0,
            "ms": res["stream_us"] / 1e3, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms}


# ------------------------------------------------------ data parallel
DP_WORLD = 2
DP_STEPS = 3                        # optimizer steps of the two-rank fit
DP_FLASH = ("flash_forward_packed", "flash_backward_packed",
            "flash_forward_full", "flash_backward_full",
            "flash_forward_tiled", "flash_backward_blockwise")


def run_ranks(args: dict, work: str, timeout: float):
    """``DP_WORLD`` ranks of this script in worker mode (``--dp-worker``)
    on the card, over gloo: JAX's launch variables, one log file each.
    Every rank is killed if the ranks are not done in ``timeout``
    seconds.  Returns each rank's result dict."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = os.path.join(work, "args.json")
    with open(path, "w") as f:
        json.dump(args, f)
    procs, logs = [], []
    try:
        for r in range(DP_WORLD):
            env = dict(os.environ, VAE_GSLM_COORDINATOR=f"127.0.0.1:{port}",
                       VAE_GSLM_NUM_PROCESSES=str(DP_WORLD),
                       VAE_GSLM_PROCESS_ID=str(r), PYTHONPATH=ROOT)
            logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker",
                 path], cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                log(f"rank {r} failed (exit {procs[r].returncode}):\n"
                    + f.read()[-4000:])
        raise AssertionError(f"ranks {bad} of the {args['mode']} phase "
                             "failed")
    out = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _refuse_plain(where: str, dense: bool = True):
    """Make every plain attention version raise (the kernels must run),
    and with ``dense`` the dense attention too (a path whose non-causal or
    cross-attention runs it, as the text-to-speech trunk's, passes False);
    returns a callable that undoes it."""
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    names = ("flash_forward_packed_plain", "flash_backward_packed_plain",
             "flash_forward_full_plain", "flash_forward_tiled_plain",
             "flash_backward_full_plain", "flash_backward_blockwise_plain",
             "attention_reference")
    saved = {n: getattr(fa, n) for n in names}
    saved_attend = attn_mod.attend

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"{where} reached {what} on the card")
        return fn

    for n in names:
        setattr(fa, n, refuse(n))
    if dense:
        attn_mod.attend = refuse("the dense attention")

    def undo():
        for n, f in saved.items():
            setattr(fa, n, f)
        attn_mod.attend = saved_attend

    return undo


def _param_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_small_rank(args: dict, rank: int) -> dict:
    """One rank of ``phase_dp_small``: the step on this rank's rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.parallel import mesh
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    mesh.init_distributed("gloo")
    try:
        dev = mesh.rank_device()
        work, b = args["work"], args["rows"]
        tr = LVTRTrainer(small_train_hparams(args["vocoder"]), seed=3,
                         device=dev)
        tr.model.load_state_dict(torch.load(
            os.path.join(work, "model.pt"), map_location=dev))
        tr.global_step = args["step"]
        data = torch.load(os.path.join(work, "batch.pt"))
        lo, hi = rank * b, (rank + 1) * b
        batch = {k: Masked(data[k][:, lo:hi], data[k + ".len"][:, lo:hi], 1)
                 for k in ("mel", "tokens", "cropped_mel_utt")}
        draws = [{k[len(f"draw{i}."):]: v[lo:hi] for k, v in data.items()
                  if k.startswith(f"draw{i}.")}
                 for i in range(TRAIN_ACCUM)]
        undo = _refuse_plain("the two-rank small step")
        for n in DP_FLASH:
            getattr(fa, n).launches = 0
        with tr.parallel_context():
            metrics = tr.run_step(batch, draws=draws)
        torch.cuda.synchronize()
        counts = {n: getattr(fa, n).launches for n in DP_FLASH}
        undo()
        np.savez(os.path.join(work, f"grads{rank}.npz"),
                 **{n: p.grad.cpu().numpy() for n, p in zip(tr.names,
                                                             tr.params)})
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "counts": counts, "digest": _param_digest(tr.params)}
    finally:
        dist.destroy_process_group()


def _dp_fit_rank(args: dict, rank: int) -> dict:
    """One rank of ``phase_dp_fit``: ``scripts/train.py`` (gloo), each
    optimizer step timed and its kernel counts set to 0 just before and
    read just after, the all-reduces timed, the plain versions refused."""
    import torch

    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.parallel import mesh
    from vae_gslm_tpu_torch.scripts import train as train_cli
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    steps, reduce_s, holder = [], [], {}
    run_step, all_reduce = LVTRTrainer.run_step, mesh.all_reduce_sum

    def counted(self, stacked, draws=None):
        holder["trainer"] = self
        for n in DP_FLASH:
            getattr(fa, n).launches = 0
        torch.cuda.synchronize()
        t0, r0 = time.perf_counter(), sum(reduce_s)
        metrics = run_step(self, stacked, draws)
        torch.cuda.synchronize()
        tok = stacked["tokens"]
        steps.append({
            "sec": time.perf_counter() - t0,
            "reduce_sec": sum(reduce_s) - r0,
            "counts": {n: getattr(fa, n).launches for n in DP_FLASH},
            "shape": list(tok.value.shape),
            "tokens": int(tok.lengths.sum()),
            "metrics": {k: float(v) for k, v in metrics.items()}})
        return metrics

    def timed_reduce(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce(tensors)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    LVTRTrainer.run_step = counted
    mesh.all_reduce_sum = timed_reduce
    undo = _refuse_plain("the two-rank fit")
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)       # the allocator exists before its reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    train_cli.main(["-c", args["config"], "--backend", "gloo",
                    "--max_steps", str(args["steps"]), "-n", "dp",
                    "-log", "WARNING"])
    wall = time.perf_counter() - t0
    undo()
    tr = holder["trainer"]
    return {"steps": steps, "wall": wall, "device": str(tr.device),
            "world": tr.world_size,
            "peak": torch.cuda.max_memory_allocated(dev),
            "nparams": sum(p.numel() for p in tr.params),
            "digest": _param_digest(tr.params)}


def dp_worker(args_path: str) -> int:
    """Worker mode: one rank of a two-rank phase (launched by
    ``run_ranks`` with the launch variables set)."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args_path) as f:
        args = json.load(f)
    rank = int(os.environ["VAE_GSLM_PROCESS_ID"])
    out = (_dp_small_rank(args, rank) if args["mode"] == "small"
           else _dp_fit_rank(args, rank))
    with open(os.path.join(args["work"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_dp_small(dev):
    """Two ranks on the card (gloo, one process each) take one float32
    step of the small LVTR (accumulation 2, utterance encoder) on their
    halves of a global batch with pinned draws, through K4/K4b (the
    data-mesh route); the single-process step over the whole batch on
    the card (K3/K3b) is the reference: metrics to 1e-4 relative (token
    sums and grad_norm), the summed gradients to 1e-3 x max|g| per leaf
    (1e-3: two kernels summing in other orders, then the cross-rank sum);
    the ranks' parameters bitwise equal.  Exactly 2 x accumulation K4
    and K4b launches per rank, no K3/K3b.  Returns rank 0's K4b launches
    (float32: the float32 backward's main path)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    b_rank, t = 2, 100
    work = tempfile.mkdtemp(prefix="dp_small_")
    try:
        with precision.policy_scope(precision.Policy()):
            vdir = vocoder_dir(work)
            single = LVTRTrainer(small_train_hparams(vdir), seed=3,
                                 device=dev)
            torch.save(single.model.state_dict(),
                       os.path.join(work, "model.pt"))
            rng = np.random.RandomState(4)
            batch = train_batches(rng, DP_WORLD * b_rank, t,
                                  [100, 61, 1, 77], 40, 50)
            draws = [train_draws(rng, DP_WORLD * b_rank, t, 4, 32,
                                 single.model.decoder.num_timesteps)
                     for _ in range(TRAIN_ACCUM)]
            data = {}
            for k, v in batch.items():
                data[k], data[k + ".len"] = v.value, v.lengths
            for i, d in enumerate(draws):
                data.update({f"draw{i}.{k}": x for k, x in d.items()})
            torch.save(data, os.path.join(work, "batch.pt"))
            step = 40000                           # past the KLD warm-up
            single.global_step = step
            want = single.run_step(batch, draws=draws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks = run_ranks({"mode": "small", "work": work,
                               "vocoder": vdir, "rows": b_rank,
                               "step": step}, work, timeout=300)
            sec = time.perf_counter() - t0
            grads = []
            for r in range(DP_WORLD):
                with np.load(os.path.join(work, f"grads{r}.npz")) as z:
                    grads.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_layers = len(single.model.transformer.layers)
    wantc = n_layers * TRAIN_ACCUM
    worst_m, worst_g = 0.0, 0.0
    for r, res in enumerate(ranks):
        c = res["counts"]
        if (c["flash_forward_full"], c["flash_backward_full"],
                c["flash_forward_packed"], c["flash_backward_packed"]) != \
                (wantc, wantc, 0, 0):
            raise AssertionError(f"rank {r}: launches {c}, expected "
                                 f"{wantc} K4 and K4b and no K3/K3b")
        for k in ("rec_loss", "kld", "token_kld", "log_p", "log_q",
                  "grad_norm"):
            g, w = res["metrics"][k], float(want[k])
            worst_m = max(worst_m, abs(g - w) / max(abs(w), 1e-12))
        for name, p in zip(single.names, single.params):
            ref = p.grad.double().cpu().numpy()
            scale = np.abs(ref).max()
            err = np.abs(grads[r][name] - ref).max()
            if not err <= 1e-3 * scale + 1e-30:
                raise AssertionError(f"rank {r}: summed gradient of {name} "
                                     f"differs by {err:.3e} (max |g| "
                                     f"{scale:.3e})")
            worst_g = max(worst_g, err / max(scale, 1e-30))
    if not worst_m <= 1e-4:
        raise AssertionError(f"two-rank metrics differ from the single "
                             f"process by {worst_m:.3e} relative")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("the ranks' parameters differ after the step")
    log(f"two-rank small step on the card (gloo, K4/K4b, float32) vs the "
        f"single-process step (K3/K3b): metrics max rel err {worst_m:.2e}, "
        f"summed gradients max err {worst_g:.2e} x max|g| over "
        f"{len(single.params)} leaves; parameters bitwise equal across "
        f"ranks; launches per rank {ranks[0]['counts']}; {sec:.1f} s with "
        "the ranks' start")
    return ranks[0]["counts"]["flash_backward_full"]


def write_train_corpus(root: str, mels, n: int, lo_s: float,
                       hi_s: float, seed: int = 0) -> float:
    """``n`` WAVs (16 kHz, 16-bit) of ``lo_s``-``hi_s`` s from ``seed``
    and a ``tokens.txt`` of random token ids at 50 Hz; unless ``mels`` is
    None, ``scripts/preprocess_mels.py`` then writes each WAV's 80-bin
    log-mel (the vocoder config's frontend, on the card) as ``.npy``
    under ``mels``, the tree the training data reads.  Every duration is
    a whole number of 20 ms frames.  Returns the seconds of audio."""
    import logging

    import numpy as np
    import yaml

    from vae_gslm_tpu_torch.data import audio
    from vae_gslm_tpu_torch.scripts import preprocess_mels

    rng = np.random.RandomState(seed)
    frames = rng.randint(int(lo_s * 50), int(hi_s * 50) + 1, n)
    lines = []
    for i, nf in enumerate(frames):
        m = int(nf) * 320
        t = np.arange(m, dtype=np.float32) / 16000.0
        f0 = rng.uniform(90, 250)
        wave = sum(rng.uniform(0.02, 0.1) / h
                   * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.3))
                   for h in range(1, 6))
        wave = (wave * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
                + 0.01 * rng.randn(m)).astype(np.float32)
        name = f"utt{i:03d}"
        audio.save_wav(os.path.join(root, name + ".wav"), wave, 16000)
        lines.append(f"{name}.wav|"
                     f"{' '.join(map(str, rng.randint(0, 200, nf)))}")
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w") as f:
        f.write("\n".join(lines) + "\n")
    if mels is not None:
        with open(VOCODER_YAML) as f:
            cfg = yaml.safe_load(f)
        cfg["data"] = {"path": tokens, "wavdir": root, "sample_rate": 16000,
                       "with_text": False, "with_tokens": True}
        path = os.path.join(os.path.dirname(os.path.abspath(mels)),
                            "preprocess_mels.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        level = logging.getLogger().level     # the CLI logs at INFO
        wrote = preprocess_mels.main(["-c", path, "-o", mels,
                                      "--device", "cuda"])
        logging.getLogger().setLevel(level)
        if wrote != n:
            raise AssertionError(f"preprocess_mels wrote {wrote} mels of "
                                 f"{n} WAVs")
    return float(frames.sum()) / 50.0


def phase_dp_fit(dev, gpu: str, long: bool = False):
    """Two ranks on the card (gloo) train the full-width LVTR of
    ``configs/train/speech/vae-gslm.yaml`` through ``scripts/train.py``
    -> ``LVTRTrainer.fit``, its data paths pointed at a synthetic corpus
    written from seed 0 (WAVs, tokens and mels from ``scripts/
    preprocess_mels.py``; a uniform
    length mix, not a measured corpus's).  The shipped settings: 8 rows
    per rank x accumulation 2 x 640-frame segments, 16-mixed, AdamW,
    ``DP_STEPS`` optimizer steps over 96 utterances of 13-20 s (one
    epoch); exactly 32 K4 and 32 K4b launches per rank per step and no
    K3/K3b; the ranks' parameters bitwise equal at the end; rank 0's
    ``last-cpt.npz`` read back strictly and equal to them.  With
    ``long``: one step past 1024 frames (``token_segment_size`` 1536 and
    its post-padding, 2 rows per rank, accumulation 1) over 4 utterances
    of 31-35 s: exactly 16 K5 and 16 K5b launches per rank.  Both ranks
    share the one card: their times say nothing about scaling.  Returns
    rank 0's launches of the kernels over the run."""
    import shutil
    import tempfile

    import yaml

    tmp = tempfile.mkdtemp(prefix="dp_fit_")
    try:
        corpus, mels = os.path.join(tmp, "corpus"), os.path.join(tmp, "mels")
        os.makedirs(corpus)
        steps = 1 if long else DP_STEPS
        n_utt = 4 if long else DP_WORLD * TRAIN_B * TRAIN_ACCUM * steps
        t0 = time.perf_counter()
        audio_s = write_train_corpus(corpus, mels, n_utt,
                                     31.0 if long else 13.0,
                                     35.0 if long else 20.0)
        with open(TRAIN_YAML) as f:
            cfg = yaml.safe_load(f)
        cfg["vocoder"]["path"] = vocoder_dir(tmp)
        cfg["logging"]["log_dir"] = os.path.join(tmp, "logs")
        data = cfg["data"]["train"]
        data.update(path=os.path.join(corpus, "tokens.txt"), wavdir=corpus,
                    preprocess_mels=mels)
        if long:
            data.update(token_segment_size=K5B_T, batch_size=2,
                        post_pad={"tokens": {"num_tokens": K5B_T},
                                  "mel": {"length": K5B_T / 50.0}})
            cfg["training"]["gradient_accumulation"] = 1
        path = os.path.join(tmp, "train.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        log(f"dp{' long' if long else ''}: corpus of {n_utt} WAVs "
            f"({audio_s:.1f} s of audio) with mels written in "
            f"{time.perf_counter() - t0:.1f} s")
        ranks = run_ranks({"mode": "fit", "work": tmp, "config": path,
                           "steps": steps}, tmp, timeout=600)
        ckpt = os.path.join(tmp, "logs", "dp", "ckpt", "version_0")
        names = sorted(os.listdir(ckpt))
        want_names = sorted([f"step={steps}-cpt.npz", "last-cpt.npz",
                             "hp.yaml", "full_state.pt"])
        if names != want_names:
            raise AssertionError(f"rank 0 wrote {names}, expected "
                                 f"{want_names}")
        if not long:
            read_back(os.path.join(ckpt, "last-cpt.npz"), cfg, dev,
                      ranks[0]["digest"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seg = K5B_T if long else TRAIN_T
    rows = 2 if long else TRAIN_B
    accum = 1 if long else TRAIN_ACCUM
    want = L * accum
    kernels = (("flash_forward_tiled", "flash_backward_blockwise") if long
               else ("flash_forward_full", "flash_backward_full"))
    for r, res in enumerate(ranks):
        if res["world"] != DP_WORLD or len(res["steps"]) != steps:
            raise AssertionError(f"rank {r}: world {res['world']}, "
                                 f"{len(res['steps'])} steps")
        for i, st in enumerate(res["steps"]):
            c = st["counts"]
            others = {n: v for n, v in c.items() if n not in kernels and v}
            if (c[kernels[0]], c[kernels[1]]) != (want, want) or others:
                raise AssertionError(
                    f"rank {r} step {i}: launches {c}, expected {want} of "
                    f"{kernels[0]} and {kernels[1]} and no other")
            if st["shape"] != [accum, rows, seg]:
                raise AssertionError(f"rank {r} step {i}: batch "
                                     f"{st['shape']}, expected "
                                     f"{[accum, rows, seg]}")
            terms = [st["metrics"][k] for k in ("rec_loss", "kld",
                                                "token_kld", "grad_norm")]
            if not all(math.isfinite(x) for x in terms):
                raise AssertionError(f"rank {r} step {i}: metrics "
                                     f"{st['metrics']}")
        log(f"dp{' long' if long else ''} rank {r} on {res['device']}: "
            + "; ".join(
                f"step {i} {st['sec'] * 1e3:.1f} ms (all-reduce "
                f"{st['reduce_sec'] * 1e3:.1f} ms), {st['tokens']} tokens, "
                f"{kernels[0]} {st['counts'][kernels[0]]}, {kernels[1]} "
                f"{st['counts'][kernels[1]]}, rec_loss "
                f"{st['metrics']['rec_loss']:.4f}, grad_norm "
                f"{st['metrics']['grad_norm']:.4f}"
                for i, st in enumerate(res["steps"]))
            + f"; peak memory {res['peak'] / 2 ** 30:.2f} GiB; fit wall "
              f"{res['wall']:.1f} s")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("the ranks' parameters differ after fit")
    for i in range(steps):
        a, b = (res["steps"][i]["metrics"] for res in ranks)
        if a != b:
            raise AssertionError(f"step {i}: the ranks logged {a} and {b}")
    timed = [res["steps"][1:] or res["steps"] for res in ranks]
    sec = statistics.median(st["sec"] for st in timed[0])
    red = statistics.median(st["reduce_sec"] for st in timed[0])
    tokens = statistics.median(st["tokens"] for st in timed[0])
    log(f"dp{' long' if long else ''} summary ({DP_WORLD} ranks sharing one "
        f"card over gloo: no scaling claim; {ranks[0]['nparams'] / 1e6:.1f} "
        f"M parameters): median step {sec * 1e3:.1f} ms over "
        f"{len(timed[0])} step(s) of rank 0 ({rows} rows x accumulation "
        f"{accum} x {seg} frames per rank), {tokens / sec:.0f} tokens/s per "
        f"rank, all-reduce {red / sec:.1%} of the step, peak memory per "
        f"rank {', '.join(f'{r_['peak'] / 2 ** 30:.2f}' for r_ in ranks)} "
        f"GiB; parameters and logged metrics equal across ranks ({gpu})")
    return {n: sum(st["counts"][n] for st in ranks[0]["steps"])
            for n in kernels}


def read_back(path: str, cfg: dict, dev, digest: str) -> None:
    """Strictly load rank 0's compact checkpoint into a fresh LVTR of the
    config; its parameters must equal rank 0's at the end of fit."""
    import torch

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.training.checkpoint import load_compact

    model = LVTR(Hparams.from_dict(cfg["model"]), input_dim=80, device=dev,
                 generator=torch.Generator(dev).manual_seed(9))
    load_compact(model, path)
    got = _param_digest(p for _, p in model.named_parameters())
    if got != digest:
        raise AssertionError("last-cpt.npz read back differs from rank 0's "
                             "parameters")
    log("dp: rank 0's last-cpt.npz read back strictly, equal to the ranks' "
        "parameters")
    del model


# ------------------------------------------------------------ HiFi-GAN
HFGAN_SMALL_YAML = """
trainer:
    identifier: "trainers.vocoder.hfgan.HiFiGANTrainer"
    total_steps: 4
    limit_val_batches: 1
    precision: "32"
    distributed: false
logging: {log_dir: "unused", num_samples: 1}
feature:
    sample_rate: 16000
    n_fft: 513
    win_length: 400
    hop_length: 320
    n_mels: 20
    f_min: 0
    f_max: 8000
    power: 1.0
    log_scale: true
model:
    generator:
        weight_norm: true
        upsample_rates: [5, 4, 4, 2, 2]
        upsample_kernel_sizes: [10, 8, 8, 4, 4]
        upsample_initial_channel: 64
        resblock_kernel_sizes: [3]
        resblock_dilation_sizes:
            - [1, 2]
        in_channels: 20
        kernel_size: 7
    mrd:
        weight_norm: true
        resolutions:
            - [128, 32, 64]
    mpd: {weight_norm: true, periods: [2, 3]}
training:
    generator:
        optimizer: {identifier: Adam, lr: 1.0e-4, beta1: 0.8, beta2: 0.98}
        scheduler: {identifier: triangle, flat_steps: 1}
    discriminator:
        optimizer: {identifier: Adam, lr: 1.0e-4, beta1: 0.8, beta2: 0.98}
        scheduler: {identifier: triangle, flat_steps: 1}
    mel_loss_weight: 40.0
data: {}
"""
HFGAN_STEPS = 8                     # G+D steps of the full-width fit
HFGAN_TRAIN_WAVS, HFGAN_VAL_WAVS = 48, 4


def port_kernel_counts() -> dict:
    """Every port kernel's launch counter (K1-K7), by wrapper."""
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step
    from vae_gslm_tpu_torch.ops.stream import stream_sums

    out = {"fused_decode_attention": fused_decode_attention.launches,
           "fused_trunk_step": fused_trunk_step.launches
           + fused_trunk_step.launches_w4 + fused_trunk_step.launches_bf16,
           "flash_decode_int8": flash_decode_int8.launches,
           "stream_sums": stream_sums.launches}
    for name in ("flash_forward_packed", "flash_backward_packed",
                 "flash_forward_full", "flash_backward_full",
                 "flash_forward_tiled", "flash_backward_blockwise"):
        out[name] = getattr(fa, name).launches
    return out


def _unit_gain_generator(trainer, seed: int) -> None:
    """Redraw the generator's v at unit gain (N(0, 1/fan in)), g = ||v||,
    from a numpy seed.  At the trainer's own 0.01 its wave is the last
    bias's constant plus a faint signal, whose near-silent mel bands make
    the mel loss's gradient float32 noise on any device (3 % of its max
    between float32 and float64 on the CPU); at unit gain the card and
    the CPU must agree."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.models.vocoder import hfgan as th

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in trainer.generator.modules():
            if isinstance(m, (th.WNConv1d, th.WNConvT1d)):
                v = rng.randn(*m.weight_v.shape) / math.sqrt(m.fan_in)
                m.weight_v.copy_(torch.from_numpy(v))
                m.weight_g.copy_(m.weight_v.square().sum(
                    dim=(1, 2), keepdim=True).sqrt())


def _hfgan_step_errs(got, want, gpu, cpu):
    """A card step's distance from the CPU's: the metrics' max relative
    error, and per leaf (both sets, in order) the gradient's max error
    over its max |g| and, after the step, the parameter's max error
    overall and where |g| >= 1e-2 x max |g|."""
    from vae_gslm_tpu_torch.trainers.vocoder.hfgan import METRICS

    worst_m = max(abs(float(got[k]) - float(want[k]))
                  / max(abs(float(want[k])), 1e-12) for k in METRICS)
    leaves = []
    for name, pg, pc in zip(gpu.g_names + gpu.d_names,
                            gpu.g_params + gpu.d_params,
                            cpu.g_params + cpu.d_params):
        gg, gc = pg.grad.double().cpu(), pc.grad.double()
        scale = gc.abs().max().item()
        diff = (pg.detach().double().cpu() - pc.detach().double()).abs()
        big = gc.abs() >= 1e-2 * scale
        leaves.append((name, (gg - gc).abs().max().item() / max(scale, 1e-30),
                       diff.max().item(),
                       diff[big].max().item() if big.any() else 0.0))
    return worst_m, leaves


def phase_hfgan_small(dev):
    """One G+D ``run_step`` of the tiny HiFi-GAN config of ``tests/
    test_trainers.py::_hfgan_hp`` (0.2 s segments, MPD periods 2 and 3, one
    MRD resolution) on the card and on the CPU from the same weights
    (drawn on the CPU from seed 0; the generator redrawn at unit gain)
    and the same seeded batch, one row post-padded with zeros, float32.
    Both TF32 flags are set on before the card's step: the trainer's own
    ``policy_scope`` must turn them off (forward hooks read both off on
    every generator and discriminator call) and put them back after.  The
    four metrics to 1e-5 relative, every gradient (both sets) to 1e-4 x
    its leaf's max |g| (the CPU tests' limit against JAX), the parameters
    after the step to 1e-2 x lr where the gradient is at least 1e-2 of
    its leaf's max and to 2 x lr everywhere (Adam's first step moves a
    parameter by lr times its gradient's sign).  Then a control: the same
    step on the card with TF32 left on (the trainer's scope replaced by
    one that sets the policy alone), its distance printed beside the
    gate's.  No port kernel launches."""
    import contextlib

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.trainers.vocoder import hfgan as hf

    hp = Hparams.from_yaml(HFGAN_SMALL_YAML)
    cpu = hf.HiFiGANTrainer(hp, seed=0, device="cpu")
    _unit_gain_generator(cpu, 1)

    def on_card():
        t = hf.HiFiGANTrainer(Hparams.from_yaml(HFGAN_SMALL_YAML), seed=0,
                              device=dev)
        t.generator.load_state_dict(cpu.generator.state_dict())
        t.disc.load_state_dict(cpu.disc.state_dict())
        return t

    gpu, tf32 = on_card(), on_card()
    lengths = [[3200, 2500]]
    x = (np.random.RandomState(0).randn(1, 2, 3200) * 0.2).astype(
        np.float32)
    x[0, 1, 2500:] = 0.0

    def batch():
        return {"audio": Masked(torch.from_numpy(x.copy()),
                                torch.tensor(lengths, dtype=torch.int32), 1)}

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        want = cpu.run_step(batch())
    finally:
        torch.set_num_threads(threads)
    flags_in_step = set()
    hooks = [m.register_forward_pre_hook(
        lambda *_: flags_in_step.add(precision.tf32_flags()))
        for m in (gpu.generator, gpu.disc)]
    def set_tf32(matmul, cudnn):
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn

    outer = precision.tf32_flags()
    set_tf32(True, True)
    try:
        before = port_kernel_counts()
        got = gpu.run_step(batch())
        torch.cuda.synchronize()
        if port_kernel_counts() != before:
            raise AssertionError("the HiFi-GAN step launched a port kernel")
        if precision.tf32_flags() != (True, True):
            raise AssertionError("hfgan small: run_step left the TF32 "
                                 f"flags at {precision.tf32_flags()}")

        @contextlib.contextmanager
        def policy_only(policy):
            prev = precision.get_policy()
            precision.set_policy(policy)
            try:
                yield
            finally:
                precision.set_policy(prev)

        scope, hf.policy_scope = hf.policy_scope, policy_only
        try:
            got_tf32 = tf32.run_step(batch())
            torch.cuda.synchronize()
        finally:
            hf.policy_scope = scope
    finally:
        set_tf32(*outer)
        for h in hooks:
            h.remove()
    if flags_in_step != {(False, False)}:
        raise AssertionError(f"hfgan small: TF32 flags inside run_step "
                             f"{sorted(flags_in_step)}, not both off")
    lr = float(hp.training.generator.optimizer.lr)
    worst_m, leaves = _hfgan_step_errs(got, want, gpu, cpu)
    tf32_m, tf32_leaves = _hfgan_step_errs(got_tf32, want, tf32, cpu)
    worst_g = max(g for _, g, _, _ in leaves)
    worst_p = max(p for _, _, _, p in leaves)
    tf32_g = max(g for _, g, _, _ in tf32_leaves)
    log(f"hfgan small (card vs CPU, tiny config, one G+D step, float32; "
        f"TF32 set on, run_step read both off): metrics " + ", ".join(
            f"{k} {float(got[k]):.5f}/{float(want[k]):.5f}"
            for k in hf.METRICS)
        + f" (max rel err {worst_m:.2e}, limit 1e-5); gradients max err "
        f"{worst_g:.2e} x max|g| over {len(leaves)} leaves (limit 1e-4); "
        f"parameters after the step max err {worst_p:.2e} where |g| >= "
        f"1e-2 max|g| (lr {lr:g})")
    log(f"hfgan small control (the same step on the card with TF32 left "
        f"on): metrics max rel err {tf32_m:.2e}, gradients max err "
        f"{tf32_g:.2e} x max|g|: "
        + ("fails" if tf32_m > 1e-5 or tf32_g > 1e-4 else "passes")
        + " the gate")
    for name, g, p_all, p_big in leaves:
        if not g <= 1e-4:
            raise AssertionError(f"hfgan small: gradient of {name} differs "
                                 f"by {g:.3e} x max|g|")
        if p_all > 2 * lr or p_big > 1e-2 * lr:
            raise AssertionError(f"hfgan small: {name} after the step "
                                 f"differs by {p_all:.3e}")
    if not worst_m <= 1e-5:
        raise AssertionError("hfgan small: the card's metrics differ from "
                             "the CPU's")


def phase_hfgan_fit(dev, gpu: str):
    """The shipped ``configs/train/vocoder/hfgan_16k_50hz_librispeech.yaml``
    at full width (generator 512 initial channels, rates 5.4.2.2.2.2; MPD
    periods 2-11; MRD at three resolutions; batch 24 x 1 s; Adam, float32)
    through ``scripts/train.py`` -> ``BaseTrainer.fit`` ->
    ``HiFiGANTrainer.run_step``, only the data paths (a synthetic corpus
    from seed 0: 48 training WAVs of 2-3 s, 4 validation WAVs of 5-6 s,
    written as ``write_train_corpus`` writes the data-parallel corpus)
    and ``total_steps`` (``--max_steps 8``) changed: ms per G+D step
    (median of steps 1-5; each step between syncs, so the loader's wait
    is outside it) with its D half (mel, G forward, D step and update)
    and G half, the FLOPs of step 6 (torch's FLOP counter) and their rate
    against the 67 TFLOP/s float32 peak, peak memory, and one profiled
    step (the last): busy share and top device operations; the one
    validation batch's mel L1.  No port kernel launches.  Then
    ``HiFiGAN.from_pretrained`` on the checkpoint directory decodes the
    mels of four 1 s clips on the card: finite, frames x 320 samples,
    equal to the trainer's own generator on the same mels to 1e-5."""
    import json as _json
    import logging
    import shutil
    import tempfile

    import numpy as np
    import torch
    import yaml
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
    from vae_gslm_tpu_torch.scripts import train as train_cli
    from vae_gslm_tpu_torch.trainers.vocoder import hfgan as hf

    tmp = tempfile.mkdtemp(prefix="hfgan_fit_")
    run_step, apply = hf.HiFiGANTrainer.run_step, hf.HiFiGANTrainer._apply
    seen = {"steps": [], "halves": [], "trainer": None, "prof": None}

    def timed_apply(self, opt, params, grads):
        apply(self, opt, params, grads)
        torch.cuda.synchronize()
        seen["halves"][-1].append(time.perf_counter())

    def timed_run_step(self, stacked):
        seen["trainer"] = self
        torch.cuda.synchronize()
        seen["halves"].append([time.perf_counter()])
        i = len(seen["steps"])
        if i == HFGAN_STEPS - 2:
            with FlopCounterMode(display=False) as counter:
                out = run_step(self, stacked)
            seen["flops"] = counter.get_total_flops()
        elif i == HFGAN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = run_step(self, stacked)
                torch.cuda.synchronize()
            seen["prof"] = prof
        else:
            out = run_step(self, stacked)
        torch.cuda.synchronize()
        if i == HFGAN_STEPS - 3:       # the last timed step
            seen["peak"] = torch.cuda.max_memory_allocated()
        t0, t_d, t_g = seen["halves"][-1]
        seen["steps"].append((t_g - t0, t_d - t0, t_g - t_d,
                              {k: float(v) for k, v in out.items()},
                              tuple(stacked["audio"].value.shape)))
        return out

    try:
        corpus, val = os.path.join(tmp, "train"), os.path.join(tmp, "val")
        os.makedirs(corpus)
        os.makedirs(val)
        t0 = time.perf_counter()
        audio_s = (write_train_corpus(corpus, None, HFGAN_TRAIN_WAVS, 2.0,
                                      3.0, seed=0)
                   + write_train_corpus(val, None, HFGAN_VAL_WAVS, 5.0, 6.0,
                                        seed=1))
        with open(VOCODER_YAML) as f:
            cfg = yaml.safe_load(f)
        for split, root in (("train", corpus), ("val", val)):
            cfg["data"][split].update(
                path=os.path.join(root, "tokens.txt"), wavdir=root)
        cfg["logging"]["log_dir"] = os.path.join(tmp, "logs")
        path = os.path.join(tmp, "hfgan.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        log(f"hfgan fit: {HFGAN_TRAIN_WAVS} + {HFGAN_VAL_WAVS} WAVs "
            f"({audio_s:.1f} s of audio) written in "
            f"{time.perf_counter() - t0:.1f} s")
        hf.HiFiGANTrainer.run_step = timed_run_step
        hf.HiFiGANTrainer._apply = timed_apply
        before = port_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        level = logging.getLogger().level     # the CLI logs at INFO
        t0 = time.perf_counter()
        try:
            train_cli.main(["-c", path, "--max_steps", str(HFGAN_STEPS),
                            "-n", "hfgan"])
        finally:
            hf.HiFiGANTrainer.run_step = run_step
            hf.HiFiGANTrainer._apply = apply
            logging.getLogger().setLevel(level)
        wall = time.perf_counter() - t0
        peak = seen["peak"]
        if port_kernel_counts() != before:
            raise AssertionError("the HiFi-GAN fit launched a port kernel")
        trainer, steps = seen["trainer"], seen["steps"]
        if len(steps) != HFGAN_STEPS or trainer.global_step != HFGAN_STEPS:
            raise AssertionError(f"hfgan fit ran {len(steps)} steps")
        nparams = [sum(p.numel() for p in ps)
                   for ps in (trainer.g_params, trainer.d_params)]
        data = cfg["data"]["train"]
        rows, samples = data["batch_size"], int(data["segment_size"] * 16000)
        for i, (sec, d_sec, g_sec, m, shape) in enumerate(steps):
            if shape != (1, rows, samples) or not all(
                    math.isfinite(v) for v in m.values()):
                raise AssertionError(f"hfgan step {i}: batch {shape}, "
                                     f"metrics {m}")
            note = {0: " (warm-up)", HFGAN_STEPS - 2: " (FLOP count)",
                    HFGAN_STEPS - 1: " (profiled)"}.get(i, "")
            log(f"hfgan step {i}{note}: {sec * 1e3:.1f} ms (D half "
                f"{d_sec * 1e3:.1f}, G half {g_sec * 1e3:.1f}); " + ", ".join(
                    f"{k} {v:.4f}" for k, v in m.items()))
        mid = steps[1:-2]
        med = [statistics.median(s[j] for s in mid) for j in range(3)]
        ckpt = os.path.join(tmp, "logs", "hfgan", "ckpt", "version_0")
        with open(os.path.join(tmp, "logs", "hfgan", "log", "version_0",
                               "metrics.jsonl")) as f:
            val_mel = [_json.loads(line)["value"] for line in f
                       if '"val/mel"' in line]
        if len(val_mel) != 1 or not math.isfinite(val_mel[0]):
            raise AssertionError(f"hfgan fit: val/mel {val_mel}")
        log(f"hfgan fit (B={rows} x {samples} samples, float32, generator "
            f"{nparams[0] / 1e6:.2f} M + discriminators "
            f"{nparams[1] / 1e6:.2f} M parameters): median G+D step "
            f"{med[0] * 1e3:.1f} ms over steps 1-{HFGAN_STEPS - 3} (D half "
            f"{med[1] * 1e3:.1f} ms: mel, G forward, D step and update; G "
            f"half {med[2] * 1e3:.1f} ms), {rows / med[0]:.1f} clips/s; "
            f"{seen['flops'] / 1e12:.3f} TFLOP a step (torch's FLOP "
            f"counter), {seen['flops'] / med[0] / 1e12:.1f} TFLOP/s, "
            f"{seen['flops'] / med[0] / FP32_FLOPS:.1%} of the float32 "
            f"FMA peak; peak memory {peak / 2 ** 30:.2f} GiB over steps "
            f"0-{HFGAN_STEPS - 3}; validation mel L1 {val_mel[0]:.4f} over one batch; "
            f"scripts/train.py wall {wall:.1f} s; files "
            f"{sorted(os.listdir(ckpt))} ({gpu})")
        kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
                   for e in seen["prof"].key_averages()
                   if e.self_device_time_total > 0]
        if kernels:
            busy = sum(k[0] for k in kernels)
            log(f"hfgan step profile (profiler on): wall "
                f"{steps[-1][0] * 1e3:.1f} ms, device busy {busy:.1f} ms "
                f"({busy / (steps[-1][0] * 1e3):.1%}), "
                f"{sum(k[1] for k in kernels)} device ops ({gpu})")
            for ms, n, name in sorted(kernels, reverse=True)[:10]:
                log(f"  {ms:.3f} ms, {n}x: {name[:90]}")
        else:
            log("hfgan step profile: device time not measured (the "
                "profiler recorded no kernel)")

        voc = HiFiGAN.from_pretrained(ckpt, device=dev)
        if voc.model.conv_pre.weight_norm:
            raise AssertionError("from_pretrained left weight norm on")
        rng = np.random.RandomState(2)
        clips = torch.from_numpy((rng.randn(4, 16000) * 0.1).astype(
            np.float32)).to(dev)
        with precision.policy_scope(precision.Policy()), torch.no_grad():
            mel = trainer.features.encode(Masked.from_lengths(
                clips, torch.tensor([16000, 16000, 12800, 8000],
                                    device=dev)))
            wave = voc.decode(mel)
            ref = trainer.generator(mel).apply_mask()
        frames = mel.value.shape[1]
        err = (wave.value - ref.value).abs().max().item()
        if wave.value.shape != (4, frames * 320) or not bool(
                torch.isfinite(wave.value).all()) or not err <= 1e-5:
            raise AssertionError(f"hfgan vocoder: shape "
                                 f"{tuple(wave.value.shape)}, max diff "
                                 f"{err:.3e} against the trainer's "
                                 "generator")
        log(f"hfgan vocoder: HiFiGAN.from_pretrained on the fit's checkpoint "
            f"decodes 4 x {frames} frames to {tuple(wave.value.shape)} on "
            f"the card, finite, max |diff| {err:.2e} against the trainer's "
            "generator")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------- the rest of the nn layers
OPT_PROMPT_B = 8                    # the continuation's batch
OPT_SCORE_B, OPT_SCORE_T = 4, 1100  # one scoring batch past 1024: K5
OPT_SCORE_LENGTHS = [1100, 1100, 1003, 1071]


def options_config(layers: int = L, conv=(512, 2048), groups: int = 32
                   ) -> dict:
    """``configs/train/speech/vae-gslm.yaml`` with the options of the rest
    of the nn layers, overridden in memory: a 3-layer ``ResNet`` encoder
    (the shipped bottleneck's widths ``conv``, k 7, causal, InstanceNorm,
    ReLU, final norm), Rotary trunk positions (``layers`` layers, d1024,
    16 x 64 heads, FFN 4096 as shipped), a 4-layer conditional
    rational-quadratic spline flow (8 bins, tail bound 5, hidden 64 as the
    shipped flow's), a ``ConditionalUNet`` denoiser whose ``cond_net`` and
    ``unet`` are 6-layer ``ResNet``s at ``conv`` with SiLU (the unet's
    blocks GroupNorm of ``groups`` groups, concat-conditioned on the cond
    net's output), the shipped time embedding, tokens and utterance
    encoder."""
    import copy

    import yaml

    with open(TRAIN_YAML) as f:
        cfg = yaml.safe_load(f)
    m = cfg["model"]
    cin, chid = conv

    def block(norm, act):
        return {"in_channels": cin, "hidden_channels": chid,
                "kernel_size": 7, "causal_padding": True, "norm": norm,
                "activation": {"identifier": act}}

    inorm = {"identifier": "InstanceNorm", "eps": 1e-6}
    gnorm = {"identifier": "GroupNorm", "num_groups": groups, "eps": 1e-5}
    m["encoder"] = {"identifier": "ResNet", "num_layers": 3,
                    "final_norm": True, "layer": block(inorm, "ReLU")}
    tr = m["transformer"]
    tr["num_layers"] = layers
    tr["rpe"] = {"identifier": "Rotary"}
    tr["flow"] = {"identifier": "RationalQuadraticSplineCoupling",
                  "num_layers": 4, "conditional": True,
                  "layer": {"hidden_dim": 64, "num_bins": 8,
                            "tail_bound": 5.0,
                            "activation": {"identifier": "GELU"},
                            "norm": {"identifier": "LayerNorm",
                                     "eps": 1e-6}}}
    dec = m["decoder"]
    dec["diffusion"]["identifier"] = "ConditionalUNet"
    dec["cond_unet"] = {
        "cond_net": {"num_layers": 6, "layer": block(inorm, "SiLU")},
        "unet": {"num_layers": 6, "final_norm": True,
                 "layer": dict(block(gnorm, "SiLU"), condition_type="concat",
                               in_dim=chid)},
        "time_embedding": copy.deepcopy(dec["cond_unet"]["time_embedding"])}
    return cfg


def zero_kernel_counts() -> None:
    """Every port kernel's launch counter to 0."""
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step
    from vae_gslm_tpu_torch.ops.stream import stream_sums

    for fn in (fused_decode_attention, flash_decode_int8, stream_sums,
               fa.flash_forward_packed, fa.flash_backward_packed,
               fa.flash_forward_full, fa.flash_backward_full,
               fa.flash_forward_tiled, fa.flash_backward_blockwise):
        fn.launches = 0
    fused_trunk_step.launches = fused_trunk_step.launches_w4 = 0
    fused_trunk_step.launches_bf16 = 0


def expect_counts(where: str, want: dict) -> dict:
    """The kernels' counts; fails unless those in ``want`` equal it and
    every other is 0."""
    got = port_kernel_counts()
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{where}: kernel launches {bad}, expected "
                             f"{want} and no other")
    return got


class Capture:
    """Records the arguments of a wrapper's first call (``when`` decides
    which call counts) while the module attribute ``name`` of ``mod``
    points at a spy; the wrapper itself still runs, and its launch count
    (which it keeps on its module attribute) reads and writes through to
    the wrapper's own."""

    def __init__(self, mod, name: str, when=None):
        self.mod, self.name, self.when = mod, name, when
        self.fn, self.args = getattr(mod, name), None

    def __enter__(self):
        cap = self

        class Spy:
            @property
            def launches(self):
                return cap.fn.launches

            @launches.setter
            def launches(self, n):
                cap.fn.launches = n

            def __call__(self, *args):
                if cap.args is None and (cap.when is None
                                         or cap.when(args)):
                    cap.args = tuple(a.detach() if hasattr(a, "detach")
                                     else a for a in args)
                return cap.fn(*args)

        setattr(self.mod, self.name, Spy())
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def _terms(out) -> list:
    """A forward's loss terms, and one scalar of them to differentiate."""
    t = [out["log_p"].value.sum(), out["log_q"].value.sum(),
         out["rec_loss"], out["ce_loss"]]
    return t, t[0] + t[1] - t[2] - t[3]


def options_agree(dev, cfg_model: dict, what: str, memory_dim=None,
                  flash: bool = True) -> None:
    """A small LVTR under the options on the card (through the kernels)
    and on the CPU (through the plain versions), float32, same weights,
    inputs and draws: the training forward's loss terms to 1e-4
    relative and every gradient to 1e-3 x its max |g| (B 2 x 100 frames,
    an utterance crop where the model has an utterance encoder, a memory
    where the trunk has cross-attention); ``likelihood`` at T = 1100
    (K5 with ``flash``) with a pinned initial state, to 1e-4 relative; a
    100-step continuation on the per-layer route over the int8 cache
    (through K6 on the card), temperature 0 and a pinned initial state:
    tokens equal for at least the first 50 steps, the first 32 steps'
    latents to 1e-2.  ``flash``: the trunk's attention is the kernels'
    (K3/K3b, K5, K6 each once a layer a call; T5's dense attention takes
    none but K6)."""
    import copy

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR

    rng = np.random.RandomState(6)
    b, t, t_utt = 2, 100, 40
    torch.cuda.reset_peak_memory_stats()
    nl = cfg_model["transformer"]["num_layers"]
    emb = cfg_model["tokens"]["embedding_dim"]
    vocab = cfg_model["tokens"]["vocab_size"]
    with precision.policy_scope(precision.Policy()):
        models = {}
        for where in ("cpu", dev):
            models[str(where)] = LVTR(
                Hparams.from_dict(copy.deepcopy(cfg_model)), input_dim=80,
                device=where, memory_dim=memory_dim,
                generator=torch.Generator("cpu").manual_seed(3)
                if where == "cpu" else None)
        cpu, gpu = models["cpu"], models[str(dev)]
        gpu.load_state_dict(cpu.state_dict())
        for m in (cpu, gpu):
            m.decoder.override_sampling(sampling_timesteps=5,
                                        ddim_sampling_eta=0.0)
        x = np.concatenate([rng.randint(0, vocab, (b, t, 1)),
                            rng.randn(b, t, 80)], -1).astype(np.float32)
        utt = rng.randn(b, t_utt, 80).astype(np.float32)
        mem = rng.randn(b, 30, memory_dim or 1).astype(np.float32)
        draws = train_draws(rng, b, t, cfg_model["latent_dim"], emb,
                            cpu.decoder.num_timesteps)

        def inputs(where):
            xm = Masked.from_lengths(torch.from_numpy(x).to(where), [t, 61])
            um = (Masked.from_lengths(torch.from_numpy(utt).to(where),
                                      [t_utt, 31])
                  if cpu.utterance_net is not None else None)
            cm = (Masked.from_lengths(torch.from_numpy(mem).to(where),
                                      [30, 17]) if memory_dim else None)
            return xm, um, cm

        terms, grads = {}, {}
        for name, model, where in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
            xm, um, cm = inputs(where)
            zero_kernel_counts()
            model.zero_grad()
            ts, total = _terms(model(xm, None, c=cm, utterance=um,
                                     draws={k: v.to(where)
                                            for k, v in draws.items()}))
            total.backward()
            terms[name] = [float(v.detach()) for v in ts]
            grads[name] = {n: p.grad.double().cpu()
                           for n, p in model.named_parameters()
                           if p.grad is not None}
        torch.cuda.synchronize()
        k3 = nl if flash else 0
        launched = {}
        launched["step"] = expect_counts(f"{what} step", {
            "flash_forward_packed": k3, "flash_backward_packed": k3})
        rel = max(abs(g - w) / max(abs(w), 1e-12)
                  for g, w in zip(terms["gpu"], terms["cpu"]))
        worst = 0.0
        if set(grads["gpu"]) != set(grads["cpu"]):
            raise AssertionError(f"{what}: gradient leaves differ")
        for n, gc_ in grads["cpu"].items():
            err = (grads["gpu"][n] - gc_).abs().max().item()
            scale = gc_.abs().max().item()
            if not err <= 1e-3 * scale + 1e-30:
                raise AssertionError(f"{what}: gradient of {n} differs by "
                                     f"{err:.3e} (max |g| {scale:.3e})")
            worst = max(worst, err / max(scale, 1e-30))
        if not rel <= 1e-4 or not all(math.isfinite(v)
                                      for v in terms["gpu"]):
            raise AssertionError(f"{what}: loss terms {terms}")

        # scores past 1024 frames
        ts_ = OPT_SCORE_T
        xs = np.concatenate([rng.randint(0, vocab, (b, ts_, 1)),
                             rng.randn(b, ts_, 80)], -1).astype(np.float32)
        init = torch.from_numpy((rng.rand(b, 1, emb) * 2 - 1).astype(
            np.float32))
        scores = {}
        for name, model, where in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
            model.initial_state = (lambda generator, bsize, nfeat=None,
                                   where=where: init.to(where))
            cs = (Masked.from_lengths(torch.from_numpy(mem).to(where),
                                      [30, 17]) if memory_dim else None)
            zero_kernel_counts()
            with torch.no_grad():
                scores[name] = model.likelihood(Masked.from_lengths(
                    torch.from_numpy(xs).to(where), [ts_, 1041]), None,
                    c=cs).double().cpu()
        torch.cuda.synchronize()
        launched["scores"] = expect_counts(
            f"{what} scores", {"flash_forward_tiled": nl if flash else 0})
        srel = ((scores["gpu"] - scores["cpu"]).abs()
                / scores["cpu"].abs().clamp_min(1e-12)).max().item()
        if not srel <= 1e-4 or not bool(torch.isfinite(scores["gpu"]).all()):
            raise AssertionError(f"{what}: scores {scores}")

        # the per-layer continuation over the int8 cache (K6 on the card)
        tp, length = 20, 100
        prompt = x[:, :tp]
        frames = {}
        for name, model, where in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
            sampler = ARTRSampler(model, kv_dtype=torch.int8,
                                  flash_decode=True, device=where)
            if sampler.route(b) != "per_layer":
                raise AssertionError(f"{what}: route {sampler.route(b)}")
            zero_kernel_counts()
            out = sampler(length, Masked.from_lengths(
                torch.from_numpy(prompt).to(where), [tp] * b),
                torch.Generator(where).manual_seed(0), temperature=0.0,
                token_temperature=1e-6, encoder_temperature=0.0)
            frames[name] = out["frames"].value.float().cpu().numpy()[:, tp:]
            if not bool(torch.isfinite(out["output"].value).all()):
                raise AssertionError(f"{what}: non-finite mel")
        torch.cuda.synchronize()
        launched["continuation"] = expect_counts(f"{what} continuation",
                      {"flash_decode_int8": nl * length})
    neq = (frames["cpu"][..., 0] != frames["gpu"][..., 0]).any(0)
    first = int(neq.argmax()) if neq.any() else length
    lat = float(np.abs(frames["cpu"][:, :32, 1:]
                       - frames["gpu"][:, :32, 1:]).max())
    log(f"{what} (card kernels vs CPU plain, float32): loss terms max rel "
        f"err {rel:.2e}, gradients max err {worst:.2e} x max|g| over "
        f"{len(grads['cpu'])} leaves; scores at T={ts_} max rel err "
        f"{srel:.2e}; per-layer int8 continuation (K6) tokens equal for "
        f"the first {first} of {length} steps, first-32-step latent max "
        f"error {lat:.2e}")
    log(f"{what}: card peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card "
        "launches " + "; ".join(
            f"{run} " + (", ".join(f"{k} {v}" for k, v in c.items() if v)
                         or "none") for run, c in launched.items()))
    if first < 50 or not lat < 1e-2:
        raise AssertionError(f"{what}: the card and the CPU continuations "
                             "disagree")


def phase_lvtr_options_small(dev) -> None:
    """The options the full-width phase leaves out, each on a 2-layer d256
    LVTR (4 heads of 64, narrow convs), card against CPU
    (``options_agree``): T5 relative positions with ``ConvCoupling`` and a
    GroupNorm ``ResNet`` encoder (dense attention: no K3/K5), and SinCos
    positions with cross-attention layers over a 64-wide memory (K3/K3b,
    K5, K6)."""
    import copy

    base = options_config(layers=2, conv=(64, 128), groups=8)["model"]
    base["transformer"]["layer"].update(dim=256, ffd_size=1024)
    base["transformer"]["layer"]["self_attn"]["nheads"] = 4
    del base["utterance_encoder"]
    t5 = copy.deepcopy(base)
    t5["encoder"]["layer"]["norm"] = {"identifier": "GroupNorm",
                                      "num_groups": 8, "eps": 1e-5}
    t5["transformer"]["rpe"] = {"identifier": "T5RPE",
                                "bidirectional": False, "num_buckets": 32,
                                "max_distance": 128}
    t5["transformer"]["flow"] = {
        "identifier": "ConvCoupling", "num_layers": 2, "conditional": True,
        "layer": {"hidden_dim": 32, "kernel_size": 3, "causal_padding": True,
                  "mean_only": False, "scale_range": [0.5, 2.0],
                  "activation": {"identifier": "GELU"},
                  "norm": {"identifier": "LayerNorm", "eps": 1e-6}}}
    options_agree(dev, t5, "options small (T5RPE, ConvCoupling, GroupNorm "
                  "encoder)", flash=False)
    cross = copy.deepcopy(base)
    cross["transformer"]["rpe"] = {"identifier": "SinCos", "maxpos": 2048}
    cross["transformer"]["layer"]["cross_attn"] = {"nheads": 4}
    options_agree(dev, cross, "options small (SinCos, cross-attention over "
                  "a memory)", memory_dim=64)


def phase_lvtr_options(dev, gpu: str) -> dict:
    """The options at full width (``options_config``: ``CUT_L`` layers, cut
    from 16 for time, d1024,
    Rotary, ResNet encoder, spline flow, ConditionalUNet with GroupNorm),
    weights from seed 0, each run with every kernel count set to 0 just
    before and read just after:
      (a) ``LVTRTrainer.run_step`` at B 8 x 640 frames, 16-mixed,
          accumulation 2, after one warm-up step: exactly 2 CUT_L K3 and
          2 CUT_L K3b launches (bf16, ``slopes=None``) and no other kernel; the loss
          terms and every gradient finite;
      (b) ``ARTRSampler`` at B 8: a 3 s prompt, 500 AR steps on the
          per-layer route over the int8 cache, once through
          ``decode_attention`` (no kernel) and once with
          ``flash_decode=True`` (exactly CUT_L x 500 K6 launches, zero
          slopes), DDIM-100 at eta 0.5, the seed-1 HiFi-GAN (bf16
          weights), outputs checked as the serving phases check them;
      (c) one ``LVTR.likelihood`` batch, float32 with TF32 off, 4 x 1100
          frames: exactly CUT_L K5 launches.
    One call of each kernel on the path (K3 and K3b from the step, K6 at
    position 400 of the flash rollout, K5 from the scores) is held against
    its plain version on the same inputs, then timed at those shapes
    beside its plain version, one library call and its bound.  Then
    ``options_agree`` on the same configuration at 2 trunk layers and
    convs of 64/256.  Returns the launches of (a), (b) and (c) by
    wrapper."""
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.models.vocoder.hfgan import Generator
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    cfg = options_config(layers=CUT_L)
    launches = {}

    # (a) the training step
    with tempfile.TemporaryDirectory() as tmp:
        cfg["vocoder"]["path"] = vocoder_dir(tmp)
        cfg["trainer"]["precision"] = "16-mixed"
        t0 = time.perf_counter()
        trainer = LVTRTrainer(Hparams.from_dict(cfg), seed=0, device=dev)
    nparams = sum(p.numel() for p in trainer.params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = trainer.prepare_batch(train_batches(
        np.random.RandomState(0), TRAIN_B, TRAIN_T, TRAIN_LENGTHS, 200,
        cfg["model"]["tokens"]["vocab_size"]))
    trainer.run_step(batch)                           # warm-up
    trainer.global_step += 1
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    with Capture(fa, "flash_forward_packed") as cf, \
            Capture(fa, "flash_backward_packed") as cb:
        t0 = time.perf_counter()
        metrics = trainer.run_step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = CUT_L * TRAIN_ACCUM
    launches.update(expect_counts("options step", {
        "flash_forward_packed": want, "flash_backward_packed": want}))
    terms = {k: float(metrics[k]) for k in ("rec_loss", "kld", "token_kld",
                                            "grad_norm")}
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in trainer.params if p.grad is not None)
    if not finite or not all(math.isfinite(v) for v in terms.values()):
        raise AssertionError(f"options step: non-finite loss or gradients "
                             f"{terms}")
    tokens = TRAIN_B * TRAIN_ACCUM * TRAIN_T
    log(f"options train step ({CUT_L} layers, Rotary, ResNet encoder, "
        f"spline flow, ConditionalUNet + GroupNorm; "
        f"{nparams / 1e6:.1f} M parameters, "
        f"built in {build_s:.1f} s) B={TRAIN_B} x accumulation "
        f"{TRAIN_ACCUM} x T={TRAIN_T}, 16-mixed: {step_s * 1e3:.1f} ms "
        f"({tokens / step_s:.0f} tokens/s), peak memory "
        f"{peak / 2 ** 30:.2f} GiB; K3 {want}, K3b {want} launches; "
        + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + f" ({gpu})")
    if cf.args[4] is not None or cb.args[7] is not None:
        raise AssertionError("the Rotary trunk handed K3/K3b slopes")
    timings = call_k3_times(dev, gpu, "options at the step's call (Rotary "
                            "q/k, slopes None)", cf.args, cb.args, D)
    del trainer, metrics, cf, cb
    gc.collect()

    # (b) the continuation
    model_cfg = options_config(layers=CUT_L)["model"]
    del model_cfg["utterance_encoder"]       # as the serving phases
    voc_hp = Hparams.from_yamlfile(VOCODER_YAML)
    prior = make_prior(OPT_PROMPT_B, dev)
    kw = dict(temperature=0.85, token_temperature=0.85)
    audio_s = OPT_PROMPT_B * LENGTH / 50.0
    with precision.policy_scope(precision.bf16_mixed()):
        model = LVTR(Hparams.from_dict(model_cfg), input_dim=80, device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
        model.decoder.override_sampling(sampling_timesteps=100,
                                        ddim_sampling_eta=0.5)
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
        vocoder = Generator(voc_hp.model.generator, device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
        vocoder.remove_weight_norm()
        vocoder.requires_grad_(False)
        frames = {}
        for flash in (False, True):
            name = "K6" if flash else "decode_attention"
            sampler = ARTRSampler(model, kv_dtype=torch.int8,
                                  flash_decode=flash, device=dev)
            if sampler.route(OPT_PROMPT_B) != "per_layer":
                raise AssertionError(f"options continuation: route "
                                     f"{sampler.route(OPT_PROMPT_B)}")
            vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                            **kw)["output"])              # warm-up
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            with Capture(attn_mod, "flash_decode_int8",
                         when=lambda a: a[5] == 400) as c6:
                run_t, counts, out = run_once(sampler, vocoder, prior, dev, 1,
                                              kw)
            peak = torch.cuda.max_memory_allocated()
            got = expect_counts(f"options continuation ({name})",
                                {"flash_decode_int8": CUT_L * LENGTH
                                 if flash else 0})
            if flash:
                launches["flash_decode_int8"] = got["flash_decode_int8"]
                k6_args = c6.args
            frames[name] = out["frames"].value[:, PROMPT:].float().cpu()
            log(f"options continuation B={OPT_PROMPT_B} (per-layer int8 "
                f"cache, {name}): K6 launches {counts[2]}; " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in run_t.items())
                + f"; {run_t['ar_loop'] / LENGTH * 1e3:.2f} ms per AR step; "
                f"real-time factor {audio_s / sum(run_t.values()):.2f}x; "
                f"peak memory {peak / 2 ** 30:.2f} GiB ({gpu})")
    ref_f, k6_f = frames["decode_attention"], frames["K6"]
    log(f"options continuation: K6 route against decode_attention, same "
        f"prompts and seed: tokens equal at "
        f"{float((ref_f[..., 0] == k6_f[..., 0]).float().mean()):.1%} of "
        f"the steps (reported, not gated)")
    if bool(k6_args[6].any()):
        raise AssertionError("the Rotary trunk handed K6 non-zero slopes")
    timings.update(call_k6_times(gpu, "options at the rollout's call (zero "
                                 "slopes)", k6_args, D))
    del model, sampler, vocoder, k6_args, out
    gc.collect()

    # (c) one scoring batch past 1024 frames, float32
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.randint(0, 200, (OPT_SCORE_B, OPT_SCORE_T, 1)),
                        rng.randn(OPT_SCORE_B, OPT_SCORE_T, 80)],
                       -1).astype(np.float32)
    with precision.policy_scope(precision.Policy()):
        model = LVTR(Hparams.from_dict(model_cfg), input_dim=80, device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
        xm = Masked.from_lengths(torch.from_numpy(x).to(dev),
                                 OPT_SCORE_LENGTHS)
        with torch.no_grad():
            model.likelihood(xm, torch.Generator(dev).manual_seed(1))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        with Capture(fa, "flash_forward_tiled") as c5, torch.no_grad():
            t0 = time.perf_counter()
            scores = model.likelihood(xm, torch.Generator(dev).manual_seed(1))
            torch.cuda.synchronize()
            score_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    launches.update({k: v for k, v in expect_counts(
        "options scores", {"flash_forward_tiled": CUT_L}).items() if v})
    if tuple(scores.shape) != (OPT_SCORE_B,) or not bool(
            torch.isfinite(scores).all()):
        raise AssertionError(f"options scores {scores}")
    audio = sum(OPT_SCORE_LENGTHS) / 50.0
    log(f"options scores B={OPT_SCORE_B} x T={OPT_SCORE_T} (float32, TF32 "
        f"off): {score_s * 1e3:.1f} ms ({audio / score_s:.0f} s of audio "
        f"per second), peak memory {peak / 2 ** 30:.2f} GiB; K5 launches "
        f"{CUT_L}; scores {[round(float(s), 4) for s in scores]} ({gpu})")
    if c5.args[4] is not None:
        raise AssertionError("the Rotary trunk handed K5 slopes")
    timings.update(call_k5_times(dev, gpu, "options at the scores' call "
                                 "(slopes None)", c5.args, D))
    del model, c5
    gc.collect()

    # the same configuration at 2 trunk layers and narrow convs, card
    # against CPU
    small = options_config(layers=2, conv=(64, 256))["model"]
    options_agree(dev, small, "options (2 layers, convs 64/256)")
    for name, (ms, plain, lib, bound, err, _) in timings.items():
        log(f"options kernel line {name}: ms {ms:.4f}, plain_ms "
            f"{plain:.4f}, library_ms "
            f"{'null' if lib is None else f'{lib:.4f}'}, bound_ms "
            f"{bound:.4f}, max_abs_err {err:.3e}")
    return launches


# ------------------------------------------------ head widths 32 and 128
HW_WIDTHS = (32, 128)             # the instantiations beside 64
# (kernel, Tq, Tk, heads, lengths, causal, backward gate) of the width
# checks on the (B, H, T, D) layout: K4 with lse and K4b at T 300 (3
# heads: no packed grouping) and at T 1024 (at D = 128 past the resident
# plan: K streamed, lse written); K5 and K5b at the D = 64 checks' shapes
# (the long-segment step's B 2 x 1536, 1100 and 96 x 256) and at the
# scoring path's 1750 frames, where at D = 128 with ALiBi a dk element
# sits past the element-wise limit by a ds rounding flip (``hold_flips``);
# K5 alone past K5b's 8192 keys
HW_BHTD = (("K4", 300, 300, 3, [300, 0, 1], True, "hold"),
           ("K4", 300, 300, 3, [300, 1, 0], False, "hold"),
           ("K4", 1024, 1024, 2, [1024, 0, 1], True, "hold"),
           ("K5", 1536, 1536, 2, [1536, 1], True, "hold"),
           ("K5", 1100, 1100, 3, [1100, 1, 0], True, "hold"),
           ("K5", 96, 256, 3, [256, 0, 1], False, "hold"),
           ("K5", 1750, 1750, 2, [1750, 0, 1], True, "flips"),
           ("K5", 96, 9000, 2, [9000, 0, 1], False, ""))
HW_K6_POS = (151, 255, 256, 400, 511, 512, 650)


def hw_views(dev, dtype, b: int, tq: int, tk: int, h: int, d: int,
             seed: int):
    """q, dO (B, H, Tq, D) and k, v (B, H, Tk, D) as strided views of
    packed projections, as the trunk hands them over."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    xq = torch.randn((b, tq, 2 * h * d), generator=g, device=dev).to(dtype)
    xkv = torch.randn((b, tk, 2 * h * d), generator=g, device=dev).to(dtype)
    q, do = (x.view(b, tq, h, d).transpose(1, 2) for x in xq.chunk(2, -1))
    k, v = (x.view(b, tk, h, d).transpose(1, 2) for x in xkv.chunk(2, -1))
    return q, k, v, do


def phase_head_widths(dev, gpu: str) -> dict:
    """The templated bodies at D = 32 and 128 against their plain
    versions, at the D = 64 checks' gates (``hold``: float32 o and lse
    1e-5 x max(1, max|ref|), gradients 1e-4 x max|ref|; bf16 o 1e-2 and
    gradients 2e-2 x max|ref|, element by element and in relative L2),
    bf16 and float32, ALiBi on and off, one launch a call:
      - ``fwd_wgmma``/``fwd_stream_wgmma`` and ``bwd_wgmma`` (bf16) and
        ``fwd_f32``/``dq_f32``/``dkv_f32`` (float32) through K3/K3b on
        the packed layout at T 640 and 1024 (lengths T, 0, 1 and one
        between; at D = 128 T 1024 is past the resident plan's 704 keys,
        so K3 streams K), causal;
      - K4 (o, lse) then K4b at T 300, causal and not, and at T 1024
        (at D = 128 past the resident plan); K5 then K5b at the D = 64
        checks' shapes (B 2 x T 1536, T 1100, Tq 96 x Tk 256
        non-causal) and at T 1750, whose bf16 gradients ``hold_flips``
        holds; K5 alone at Tq 96 x Tk 9000 (past K5b's 8192 keys);
      - K6 at B 8, H x D = 1024, a 768-position int8 cache, positions
        across the 256-key block edges, to 1e-5 x max|ref|.
    Then ``hw_times`` at each width.  Returns the worst max |diff| by
    (kernel, head width, dtype)."""
    import torch

    from vae_gslm_tpu_torch.nn.attention import quantize_i8
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.ops import flash_decode as fd

    worst = {}

    def held(key, where, checks, bf16, exact=None):
        texts = []
        for name, got, want, tol, floor in checks:
            if exact is not None and name in exact:
                err, text = hold_flips(where, name, got, want,
                                       *exact[name], tol)
            else:
                err, text = hold(where, name, got, want, tol, floor, bf16)
            k = key[0] if name in ("o", "lse") else key[1]
            worst[(k, *key[2:])] = max(worst.get((k, *key[2:]), 0.0), err)
            texts.append(text)
        log(f"head_widths check {where}: max_abs_err " + ", ".join(texts))

    def fwd_tols(bf16):
        return (1e-2, 0.0) if bf16 else (1e-5, 1.0)

    for d in HW_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            fk = "bf16" if bf16 else "f32"
            gtol = 2e-2 if bf16 else 1e-4
            h = 4 if d == 32 else 2
            for t, lens in ((640, [640, 0, 1, 323]), (1024, [1024, 1, 0, 700])):
                g = torch.Generator(dev).manual_seed(t + d)
                qkv = torch.randn((4, t, 3 * h * d), generator=g,
                                  device=dev).to(dtype)
                q, k, v = qkv.chunk(3, dim=-1)
                do = torch.randn((4, t, h * d), generator=g,
                                 device=dev).to(dtype)
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                for sl in (-torch.tensor(alibi_slopes(h), device=dev), None):
                    n0 = (fa.flash_forward_packed.launches,
                          fa.flash_backward_packed.launches)
                    o, lse = fa.flash_forward_packed(q, k, v, lengths, sl,
                                                     True, h)
                    o_ref, lse_ref = fa.flash_forward_packed_plain(
                        q, k, v, lengths, sl, True, h)
                    grads = fa.flash_backward_packed(q, k, v, o, do, lse,
                                                     lengths, sl, True, h)
                    refs = fa.flash_backward_packed_plain(
                        q, k, v, o, do, lse, lengths, sl, True, h)
                    torch.cuda.synchronize()
                    if (fa.flash_forward_packed.launches,
                            fa.flash_backward_packed.launches) != (
                            n0[0] + 1, n0[1] + 1):
                        raise AssertionError("K3/K3b did not launch once")
                    plan = fa.fwd_smem_plan(t, d) if bf16 else None
                    held(("K3", "K3b", d, fk),
                         f"K3/K3b head_dim {d} {fk} B=4 T={t} H={h} "
                         f"alibi={sl is not None}"
                         + (f" (K {'streamed' if not plan.tiles else 'resident'})"
                            if bf16 else ""),
                         [("o", o, o_ref, *fwd_tols(bf16)),
                          ("lse", lse, lse_ref, 1e-5, 1.0)]
                         + [(n, a, r, gtol, 0.0) for n, a, r in
                            zip(("dq", "dk", "dv"), grads, refs)], bf16)
                del qkv, q, k, v, do, o, lse, o_ref, lse_ref, grads, refs
            for kind, tq, tk, hh, lens, causal, backward in HW_BHTD:
                q, k, v, do = hw_views(dev, dtype, len(lens), tq, tk, hh, d,
                                       tq + tk + d)
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                sl = -torch.tensor(alibi_slopes(hh), device=dev)
                fwd_tol, fwd_floor = fwd_tols(bf16)
                if kind == "K4":
                    o, lse = fa.flash_forward_full(q, k, v, lengths, sl,
                                                   causal, with_stats=True)
                    o_ref, lse_ref = fa.flash_forward_full_plain(
                        q, k, v, lengths, sl, causal, True)
                    checks = [("o", o, o_ref, fwd_tol, fwd_floor),
                              ("lse", lse, lse_ref, 1e-5, 1.0)]
                    bwd, plain, extra = (fa.flash_backward_full,
                                         fa.flash_backward_full_plain, (lse,))
                else:
                    o = fa.flash_forward_tiled(q, k, v, lengths, sl, causal)
                    o_ref = fa.flash_forward_tiled_plain(q, k, v, lengths, sl,
                                                         causal)
                    checks = [("o", o, o_ref, fwd_tol, fwd_floor)]
                    bwd, plain, extra = (fa.flash_backward_blockwise,
                                         fa.flash_backward_blockwise_plain, ())
                exact = None
                if backward:
                    n0 = bwd.launches
                    grads = bwd(q, k, v, o, do, *extra, lengths, sl, causal)
                    refs = plain(q, k, v, o, do, *extra, lengths, sl, causal)
                    if bwd.launches != n0 + 1:
                        raise AssertionError(f"{kind}b did not launch once")
                    checks += [(n, a, r, gtol, 0.0) for n, a, r in
                               zip(("dq", "dk", "dv"), grads, refs)]
                    if backward == "flips" and bf16:
                        exact = dict(zip(("dq", "dk", "dv"), zip(
                            *grad_bounds(q, k, v, o, do, extra[0] if extra
                                         else None, lengths, sl, causal))))
                torch.cuda.synchronize()
                held((kind, kind + "b", d, fk),
                     f"{kind}{'/' + kind + 'b' if backward else ''} "
                     f"head_dim {d} {fk} B={len(lens)} Tq={tq} Tk={tk} "
                     f"H={hh} causal={causal}", checks, bf16, exact)
                del q, k, v, do, o, o_ref, checks, exact
        # K6: B 8, H x D = 1024, a bf16 q as a view of one projection
        h = 1024 // d
        g = torch.Generator(dev).manual_seed(d)
        k8, ks = quantize_i8(torch.randn((8, h, K6_T, d), generator=g,
                                         device=dev))
        v8, vs = quantize_i8(torch.randn((8, h, K6_T, d), generator=g,
                                         device=dev))
        q = torch.randn((8, 3 * h * d), generator=g, device=dev).to(
            torch.bfloat16).view(8, 3, h, d)[:, 0]
        sl = -torch.tensor(alibi_slopes(h), device=dev)
        errs = []
        for pos in HW_K6_POS:
            n0 = fd.flash_decode_int8.launches
            got = fd.flash_decode_int8(q, k8, v8, ks, vs, pos, sl)
            want = fd.flash_decode_int8_plain(q, k8, v8, ks, vs, pos, sl)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= 1e-5 * want.abs().max().item() or \
                    fd.flash_decode_int8.launches != n0 + 1:
                raise AssertionError(f"K6 at head_dim {d} disagrees with its "
                                     f"plain version at pos {pos} ({err:.3e})"
                                     " or did not launch once")
            errs.append(err)
            worst[("K6", d, "f32")] = max(worst.get(("K6", d, "f32"), 0.0),
                                          err)
        log(f"head_widths check K6 head_dim {d} B=8 H={h} T={K6_T} at pos "
            f"{list(HW_K6_POS)}: max_abs_err {max(errs):.3e} (tolerance 1e-5 x "
            "max|ref|)")
        del k8, v8, ks, vs, q
        gc.collect()
        hw_times(dev, gpu, d)
    return worst


def hw_times(dev, gpu: str, d: int) -> None:
    """The bodies that the 8 x 128 and 32 x 32 paths do not launch, timed
    at head width ``d`` at the D = 64 rows' calls of ``PERF.md`` section 6
    (H x D = 1024): K5's bf16 ``fwd_stream_wgmma`` at B 8 x T 1750
    (``K5_LENGTHS``), K3b's float32 ``dq_f32``/``dkv_f32`` at the training
    call (B 8 x T 640, ``K3_LENGTHS``) and, at D = 128, K3's bf16 forward
    past the resident plan (B 8 x T 1024, streamed); each beside its plain
    version, SDPA (forward, or backward alone) and the bound; then K4
    (with lse), K4b and K5b in bf16 at their D = 64 rows' calls (B 8 x T
    640 and B 2 x T 1536), which the wide paths do not launch either."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    h = H * D // d
    sl = -torch.tensor(alibi_slopes(h), device=dev)

    def bound_of(nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations"

    for name, b, t, lens in (("K4b", K3_B, K3_T, K4B_LENGTHS),
                             ("K5b", 2, K5B_T, K5B_LENGTHS)):
        q, k, v, do = hw_views(dev, torch.bfloat16, b, t, t, h, d, 11)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = sdpa_mask(lengths, sl, torch.bfloat16, dev, t, t, True)
        if name == "K4b":
            km = device_ms(lambda i: fa.flash_forward_full(
                q, k, v, lengths, sl, True, with_stats=True), n=10,
                only=("k4_fwd",), per_call=1)
            pm = device_ms(lambda i: fa.flash_forward_full_plain(
                q, k, v, lengths, sl, True, with_stats=True), n=2)

            def sdpa_fwd(i):
                with torch.no_grad():
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask)

            lm = library_ms(sdpa_fwd, n=10)
            nb, no = bhtd_bytes_ops(b, t, t, h, lens, True, 2, d)
            nb += b * h * t * 4                         # lse written
            bound, by = bound_of(nb, no)
            log(f"head_widths K4 time B={b} T={t} H={h} head_dim {d} bf16 "
                f"with lse (k4_fwd_wgmma_kernel<{d}>, the D = 64 row's "
                f"call): kernel {km:.4f} ms, plain {pm:.4f} ms, SDPA (float "
                f"mask) forward {lm:.4f} ms, bound {bound:.4f} ms ({by}; "
                f"{nb / 1e6:.1f} MB, {no / 1e9:.2f} GFLOP) ({gpu})")
            o, lse = fa.flash_forward_full(q, k, v, lengths, sl, True,
                                           with_stats=True)
            args = (q, k, v, o, do, lse, lengths, sl, True)
            fn, plain = fa.flash_backward_full, fa.flash_backward_full_plain
            per_call = 2
        else:
            o = fa.flash_forward_tiled(q, k, v, lengths, sl, True)
            args = (q, k, v, o, do, lengths, sl, True)
            fn, plain = (fa.flash_backward_blockwise,
                         fa.flash_backward_blockwise_plain)
            per_call = fa.K5B_BF16_KERNELS
        km = device_ms(lambda i: fn(*args), n=10, only=(name.lower() + "_",),
                       per_call=per_call)
        pm = device_ms(lambda i: plain(*args), n=2)
        lb = sdpa_bwd_ms(q, k, v, do, mask)
        nb, no = bwd_bytes_ops(b, t, t, h, lens, True, 2,
                               2 if name == "K4b" else 1, d)
        bound, by = bound_of(nb, no)
        log(f"head_widths {name} time B={b} T={t} H={h} head_dim {d} bf16 "
            f"(bwd_wgmma<{d}>, the D = 64 row's call): kernels {km:.4f} ms, "
            f"plain {pm:.4f} ms, SDPA (float mask) backward alone "
            f"{lb:.4f} ms, bound {bound:.4f} ms ({by}; {nb / 1e6:.1f} MB, "
            f"{no / 1e9:.2f} GFLOP) ({gpu})")
        del q, k, v, do, o, mask, args
    q, k, v, _ = hw_views(dev, torch.bfloat16, K5_B, K5_T, K5_T, h, d, 5)
    lengths = torch.tensor(K5_LENGTHS, dtype=torch.int32, device=dev)
    km = device_ms(lambda i: fa.flash_forward_tiled(
        q, k, v, lengths, sl, True), n=10, only=("k5_fwd",), per_call=1)
    pm = device_ms(lambda i: fa.flash_forward_tiled_plain(
        q, k, v, lengths, sl, True), n=2)
    mask = sdpa_mask(lengths, sl, torch.bfloat16, dev, K5_T, K5_T)
    lm = library_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), n=10)
    nb, no = bhtd_bytes_ops(K5_B, K5_T, K5_T, h, K5_LENGTHS, True, 2, d)
    bound = max(nb / HBM_BYTES_PER_S, no / BF16_FLOPS) * 1e3
    log(f"head_widths K5 time B={K5_B} T={K5_T} H={h} head_dim {d} bf16 "
        f"(fwd_stream_wgmma<{d}>): kernel {km:.4f} ms, plain {pm:.4f} ms, "
        f"SDPA (float mask) forward {lm:.4f} ms, bound {bound:.4f} ms "
        f"({'bytes' if nb / HBM_BYTES_PER_S > no / BF16_FLOPS else 'operations'}"
        f"; {nb / 1e6:.1f} MB, {no / 1e9:.2f} GFLOP); launches on the "
        f"{h} x {d} paths: 0 ({gpu})")
    del q, k, v, mask
    g = torch.Generator(dev).manual_seed(d)
    for dtype, t in ((torch.float32, K3_T),) + (
            ((torch.bfloat16, 1024),) if fa.fwd_smem_plan(1024, d).tiles == 0
            else ()):
        qkv = torch.randn((K3_B, t, 3 * h * d), generator=g, device=dev).to(
            dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        do = torch.randn((K3_B, t, h * d), generator=g, device=dev).to(dtype)
        lens = [min(x, t) for x in K3_LENGTHS]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q4, k4, v4 = (x.reshape(K3_B, t, h, d).transpose(1, 2)
                      for x in (q, k, v))
        mask = sdpa_mask(lengths, sl, dtype, dev, t, t)
        (fb, fo), (bb, bo) = k3_bytes_ops(q.element_size(), K3_B, t, lens, h,
                                          d)
        if dtype == torch.float32:
            o, lse = fa.flash_forward_packed_plain(q, k, v, lengths, sl, True,
                                                   h)
            km = device_ms(lambda i: fa.flash_backward_packed(
                q, k, v, o, do, lse, lengths, sl, True, h), n=5,
                only=K3_KERNELS[1:], per_call=2)
            pm = device_ms(lambda i: fa.flash_backward_packed_plain(
                q, k, v, o, do, lse, lengths, sl, True, h), n=2)
            lm = sdpa_bwd_ms(q4, k4, v4, do.reshape(K3_B, t, h, d).transpose(
                1, 2), mask)
            bound = max(bb / HBM_BYTES_PER_S, bo / F32_FLOPS) * 1e3
            what = (f"K3b time B={K3_B} T={t} H={h} head_dim {d} float32 "
                    f"(dq_f32<{d}>, dkv_f32<{d}>): kernels")
            lib = "SDPA (float32, float mask) backward alone"
            nbytes, ops = bb, bo
            del o, lse
        else:
            km = device_ms(lambda i: fa.flash_forward_packed(
                q, k, v, lengths, sl, True, h), n=10, only=K3_KERNELS[:1],
                per_call=1)
            pm = device_ms(lambda i: fa.flash_forward_packed_plain(
                q, k, v, lengths, sl, True, h), n=2)
            lm = library_ms(lambda i: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask), n=10)
            bound = max(fb / HBM_BYTES_PER_S, fo / BF16_FLOPS) * 1e3
            what = (f"K3 time B={K3_B} T={t} H={h} head_dim {d} bf16 (past "
                    f"the resident plan: k3_fwd_stream_kernel<{d}>): kernel")
            lib = "SDPA (float mask) forward"
            nbytes, ops = fb, fo
        log(f"head_widths {what} {km:.4f} ms, plain {pm:.4f} ms, {lib} "
            f"{lm:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} GFLOP); launches on the {h} x {d} paths: 0 "
            f"({gpu})")
        del qkv, q, k, v, do, q4, k4, v4, mask
    gc.collect()


WIDE_SCORE_B = 8                  # utterances a scoring batch
# frames of the wide scoring corpus: a batch under 1024 frames (K3), then
# one past it (K5)
WIDE_SCORE_FRAMES = [1000, 640, 873, 512, 999, 300, 777, 951,
                     1100, 1030, 640, 1099, 400, 1050, 870, 1075]
WIDE_PL_STEPS = 200               # the per-layer (K6) rollout's steps


def call_k3_times(dev, gpu: str, where: str, fwd_args, bwd_args, d: int,
                  flips: bool = False):
    """K3 at the arguments ``fwd_args`` of a call captured on a path (and
    K3b at ``bwd_args``, unless None): held against the plain versions by
    ``hold`` (with ``flips``, a bf16 K3b by ``hold_flips``), then kernel,
    plain, SDPA (the forward with a float mask, zero where the trunk
    takes no slopes; the backward alone) and the bound.  Returns {name:
    (ms, plain_ms, library_ms, bound_ms, max_abs_err, bound_by)}."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.ops import flash_attention as fa

    q, k, v, lengths, slopes, causal, nh = fwd_args
    bf16 = q.dtype == torch.bfloat16
    b, t = q.shape[:2]
    lens = lengths.tolist()
    o, lse = fa.flash_forward_packed(q, k, v, lengths, slopes, causal, nh)
    o_ref, lse_ref = fa.flash_forward_packed_plain(q, k, v, lengths, slopes,
                                                   causal, nh)
    torch.cuda.synchronize()
    ef, tf = hold(where, "o", o, o_ref, 1e-2 if bf16 else 1e-5,
                  0.0 if bf16 else 1.0, bf16)
    el, tl = hold(where, "lse", lse, lse_ref, 1e-5, 1.0, bf16)
    log(f"{where} K3 check (B={b} T={t} H={nh} head_dim {d} "
        f"{str(q.dtype)[6:]}): max_abs_err {tf}, {tl}")
    del o, lse, o_ref, lse_ref
    rate = BF16_FLOPS if bf16 else F32_FLOPS
    out = {}
    kf = device_ms(lambda i: fa.flash_forward_packed(
        q, k, v, lengths, slopes, causal, nh), n=10 if bf16 else 5,
        only=K3_KERNELS[:1], per_call=1)
    pf = device_ms(lambda i: fa.flash_forward_packed_plain(
        q, k, v, lengths, slopes, causal, nh), n=2)
    mask = sdpa_mask(lengths, slopes if slopes is not None else
                     torch.zeros(nh, device=dev), q.dtype, dev, t, t)
    q4, k4, v4 = (x.reshape(b, t, nh, d).transpose(1, 2) for x in (q, k, v))
    lf = library_ms(lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), n=10 if bf16 else 3)
    (fb, fo), (bb, bo) = k3_bytes_ops(q.element_size(), b, t, lens, nh, d)
    bound_f = max(fb / HBM_BYTES_PER_S, fo / rate) * 1e3
    by_f = "bytes" if fb / HBM_BYTES_PER_S > fo / rate else "operations"
    out["K3"] = (kf, pf, lf, bound_f, max(ef, el), by_f)
    log(f"{where} K3 time (head_dim {d}, {str(q.dtype)[6:]}): kernel "
        f"{kf:.4f} ms, plain {pf:.4f} ms, SDPA (float mask) forward "
        f"{lf:.4f} ms, bound {bound_f:.4f} ms ({by_f}; {fb / 1e6:.1f} MB, "
        f"{fo / 1e9:.2f} GFLOP) ({gpu})")
    if bwd_args is not None:
        bq, bk, bv, bo_, bg, blse = bwd_args[:6]
        grads = fa.flash_backward_packed(bq, bk, bv, bo_, bg, blse, lengths,
                                         slopes, causal, nh)
        refs = fa.flash_backward_packed_plain(bq, bk, bv, bo_, bg, blse,
                                              lengths, slopes, causal, nh)
        exact, bounds = grad_bounds(
            bq, bk, bv, bo_, bg, blse, lengths, slopes, causal, nh) \
            if flips and bf16 else ((None,) * 3, (None,) * 3)
        torch.cuda.synchronize()
        eb, texts = 0.0, []
        tol = 2e-2 if bf16 else 1e-4
        for name, a, r, x, bd in zip(("dq", "dk", "dv"), grads, refs, exact,
                                     bounds):
            err, text = (hold(where, name, a, r, tol, 0.0, bf16) if x is None
                         else hold_flips(where, name, a, r, x, bd, tol))
            eb = max(eb, err)
            texts.append(text)
        log(f"{where} K3b check: max_abs_err " + ", ".join(texts))
        del grads, refs, exact, bounds
        kb = device_ms(lambda i: fa.flash_backward_packed(
            bq, bk, bv, bo_, bg, blse, lengths, slopes, causal, nh), n=10,
            only=K3_KERNELS[1:], per_call=2)
        pb = device_ms(lambda i: fa.flash_backward_packed_plain(
            bq, bk, bv, bo_, bg, blse, lengths, slopes, causal, nh), n=2)
        lb = sdpa_bwd_ms(q4, k4, v4, bg.reshape(b, t, nh, d).transpose(1, 2),
                         mask)
        bound_b = max(bb / HBM_BYTES_PER_S, bo / rate) * 1e3
        by_b = "bytes" if bb / HBM_BYTES_PER_S > bo / rate else "operations"
        out["K3b"] = (kb, pb, lb, bound_b, eb, by_b)
        log(f"{where} K3b time (head_dim {d}, {str(q.dtype)[6:]}): kernels "
            f"{kb:.4f} ms, plain {pb:.4f} ms, SDPA backward alone "
            f"{lb:.4f} ms, bound {bound_b:.4f} ms ({by_b}; "
            f"{bb / 1e6:.1f} MB, {bo / 1e9:.2f} GFLOP) ({gpu})")
    del mask, q4, k4, v4
    gc.collect()
    return out


def call_k5_times(dev, gpu: str, where: str, args, d: int):
    """K5 (float32) at the arguments of a call captured on a scoring path,
    as ``call_k3_times``."""
    import torch
    import torch.nn.functional as F

    from vae_gslm_tpu_torch.ops import flash_attention as fa

    q, k, v, lengths, slopes, causal = args
    b, h, t = q.shape[:3]
    o = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
    o_ref = fa.flash_forward_tiled_plain(q, k, v, lengths, slopes, causal)
    torch.cuda.synchronize()
    err, text = hold(where, "o", o, o_ref, 1e-5, 1.0, False)
    log(f"{where} K5 check (B={b} Tq=Tk={t} H={h} head_dim {d} float32): "
        f"max_abs_err {text}")
    del o, o_ref
    km = device_ms(lambda i: fa.flash_forward_tiled(
        q, k, v, lengths, slopes, causal), n=5, only=("k5_fwd",),
        per_call=1)
    pm = device_ms(lambda i: fa.flash_forward_tiled_plain(
        q, k, v, lengths, slopes, causal), n=2)
    mask = sdpa_mask(lengths, slopes if slopes is not None else
                     torch.zeros(h, device=dev), torch.float32, dev, t, t)
    lm = library_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), n=3)
    nb, no = bhtd_bytes_ops(b, t, t, h, lengths.tolist(), causal, 4, d)
    bound = max(nb / HBM_BYTES_PER_S, no / F32_FLOPS) * 1e3
    by = "bytes" if nb / HBM_BYTES_PER_S > no / F32_FLOPS else "operations"
    log(f"{where} K5 time (head_dim {d}, float32): kernel {km:.4f} ms, "
        f"plain {pm:.4f} ms, SDPA (float32, float mask) {lm:.4f} ms, bound "
        f"{bound:.4f} ms ({by}; {nb / 1e6:.1f} MB, {no / 1e9:.2f} GFLOP) "
        f"({gpu})")
    del mask
    return {"K5": (km, pm, lm, bound, err, by)}


def call_k6_times(gpu: str, where: str, args, d: int):
    """K6 at the arguments of a call captured on a per-layer rollout: held
    against the plain version (1e-5 x max|ref|), then kernel, plain and
    the bytes bound (no library call computes it)."""
    import torch

    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.ops.flash_decode import flash_decode_int8_plain

    q6, k8, v8, ks, vs, pos, sl = args
    got = attn_mod.flash_decode_int8(q6, k8, v8, ks, vs, pos, sl)
    want = flash_decode_int8_plain(q6, k8, v8, ks, vs, pos, sl)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= 1e-5 * want.float().abs().max().item():
        raise AssertionError(f"{where}: K6 disagrees with its plain version "
                             f"({err:.3e})")
    b, h = q6.shape[:2]
    ms = device_ms(lambda i: attn_mod.flash_decode_int8(
        q6, k8, v8, ks, vs, pos, sl), n=100, only=("flash_decode_kernel",),
        per_call=1)
    plain = device_ms(lambda i: flash_decode_int8_plain(
        q6, k8, v8, ks, vs, pos, sl), n=5)
    nbytes = b * h * ((pos + 1) * (2 * d + 8) + d * (q6.element_size() + 4)
                      ) + h * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{where} K6 (B={b}, H={h}, head_dim {d}, pos {pos}, cache "
        f"T={k8.shape[2]}): max_abs_err {err:.3e}; kernel {ms * 1e3:.2f} us, "
        f"plain {plain * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB; no library call) ({gpu})")
    return {"K6": (ms, plain, None, bound, err, "bytes")}


def phase_wide_heads(dev, gpu: str, nheads: int, worst: dict):
    """The shipped LVTR (``configs/train/speech/vae-gslm.yaml``: d1024,
    FFN 4096, ALiBi, RMSNorm, the 4-layer conditional flow) with
    ``transformer.layer.self_attn.nheads`` set to ``nheads`` (8: head_dim
    128; 32: head_dim 32) and ``CUT_L`` layers (cut from 16 for time), on
    the
    port's entry points, each run with every kernel count set to 0 just
    before and read just after (no other kernel may launch):
      (a) ``LVTRTrainer.run_step`` at B 8 x 640 frames, 16-mixed,
          accumulation 2, utterance encoder: a warm-up and one timed
          step, exactly 2 CUT_L K3 and 2 CUT_L K3b launches each, the plain
          versions and the dense attention refused;
      (b) ``LikelihoodEstimator.run``, float32 with TF32 off, on the
          model saved by ``save_compact`` (weights from seed 0) and 16
          synthetic WAVs at batch 8: a batch padded to 1000 frames
          (exactly CUT_L K3) and one to 1100 (exactly CUT_L K5), the plain
          versions refused;
      (c) ``ARTRSampler`` (a 3 s prompt, int8 KV cache, DDIM-100 at eta
          0.5, the seed-1 HiFi-GAN): 500 AR steps at B 8 on the hybrid
          route with bf16 weights (exactly CUT_L x 500 K1 launches), then
          with int8 weights on the mega route at this width: B 8 on
          K2-a8, B 32 on K2-bf16 and B 32 on K2-w4 (group 128), exactly
          500 launches of that branch each and no K1; then
          ``WIDE_PL_STEPS`` per-layer steps with ``flash_decode=True``
          (exactly CUT_L per step K6 launches).
    One call of each flash kernel on the path (K3/K3b from the step, K3
    and K5 from the scoring batches, K6 at position 250) is held against
    its plain version and timed beside the plain version, SDPA and the
    bound; K1 at the rollout's position 400 too.  Returns (kernel line
    entries, K1 launches, K2 launches by branch)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.likelihood import \
        LikelihoodEstimator
    from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
    from vae_gslm_tpu_torch.nn import attention as attn_mod
    from vae_gslm_tpu_torch.nn import transformer as tr_mod
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.ops.fused_decode import \
        fused_decode_attention_plain
    from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

    d = H * D // nheads
    tag = f"wide_heads {nheads} x {d}"
    times, launches = {}, {}

    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"{tag}: the path reached {what} on the "
                                 "card")
        return fn

    # (a) the training step
    with tempfile.TemporaryDirectory() as tmp:
        hp = Hparams.from_yamlfile(TRAIN_YAML)
        hp.vocoder.path = vocoder_dir(tmp)
        hp.model.transformer.layer.self_attn.nheads = nheads
        hp.model.transformer.num_layers = CUT_L
        t0 = time.perf_counter()
        trainer = LVTRTrainer(hp, seed=0, device=dev)
    nparams = sum(p.numel() for p in trainer.params)
    batch = trainer.prepare_batch(train_batches(
        np.random.RandomState(0), TRAIN_B, TRAIN_T, TRAIN_LENGTHS, 200,
        hp.model.tokens.vocab_size))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want = CUT_L * TRAIN_ACCUM
    saved = (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
             attn_mod.attend)
    steps = []
    try:
        (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
         attn_mod.attend) = (refuse("the plain K3"), refuse("the plain K3b"),
                             refuse("the dense attention"))
        torch.cuda.reset_peak_memory_stats()
        for i in range(2):
            zero_kernel_counts()
            with Capture(fa, "flash_forward_packed") as cf, \
                    Capture(fa, "flash_backward_packed") as cb:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                metrics = trainer.run_step(batch)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t1
            trainer.global_step += 1
            got = expect_counts(f"{tag} step {i}", {
                "flash_forward_packed": want, "flash_backward_packed": want})
            terms = {k: float(metrics[k]) for k in ("rec_loss", "kld",
                                                     "token_kld", "grad_norm")}
            if not all(math.isfinite(x) for x in terms.values()):
                raise AssertionError(f"{tag}: non-finite metrics {terms}")
            log(f"{tag} train step {i}{' (warm-up)' if i == 0 else ''}: "
                f"{sec * 1e3:.1f} ms; K3 {got['flash_forward_packed']}, K3b "
                f"{got['flash_backward_packed']}; " + ", ".join(
                    f"{k} {x:.4f}" for k, x in terms.items()))
            if i:
                steps.append(sec)
        peak = torch.cuda.max_memory_allocated()
    finally:
        (fa.flash_forward_packed_plain, fa.flash_backward_packed_plain,
         attn_mod.attend) = saved
    med = statistics.median(steps)
    tokens = TRAIN_B * TRAIN_ACCUM * TRAIN_T
    log(f"{tag} train (LVTR {nparams / 1e6:.1f} M parameters, built in "
        f"{build_s:.1f} s; B={TRAIN_B} x accumulation {TRAIN_ACCUM} x "
        f"T={TRAIN_T}, 16-mixed): median step {med * 1e3:.1f} ms over "
        f"{len(steps)} steps (range {min(steps) * 1e3:.1f}-"
        f"{max(steps) * 1e3:.1f}), {tokens / med:.0f} tokens/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB ({gpu})")
    launches["K3 bf16"] = 2 * want           # the warm-up and the timed step
    launches["K3b bf16"] = 2 * want
    del trainer, metrics, batch
    gc.collect()
    for k, x in call_k3_times(dev, gpu, f"{tag} at the training call",
                              cf.args, cb.args, d, flips=True).items():
        times[f"{k} bf16"] = x
    del cf, cb
    gc.collect()

    # (b) scoring, float32
    root = tempfile.mkdtemp(prefix="wide_")
    try:
        with precision.policy_scope(precision.Policy()):
            ckpt, _ = write_flagship(root, dev, nheads=nheads, layers=CUT_L)
            corpus = os.path.join(root, "corpus")
            os.makedirs(corpus)
            audio_s = write_wav_corpus(corpus, WIDE_SCORE_FRAMES,
                                       np.random.RandomState(nheads))
            est = LikelihoodEstimator(Hparams.from_yaml(
                SCORE_INFER_YAML.format(ckpt=ckpt, corpus=corpus).replace(
                    "batch_size: 64", f"batch_size: {WIDE_SCORE_B}")),
                device=dev)
            est.run(seed=0, max_batches=1)            # warm-up
            saved = (fa.flash_forward_packed_plain,
                     fa.flash_forward_tiled_plain, fa.flash_forward_full,
                     attn_mod.attend)
            step, per_batch = est.test_step, []

            def counted(batch, generator):
                zero_kernel_counts()
                out = step(batch, generator)
                per_batch.append((int(batch["tokens"].value.shape[1]),
                                  port_kernel_counts()))
                return out

            try:
                (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
                 fa.flash_forward_full, attn_mod.attend) = (
                    refuse("the plain K3"), refuse("the plain K5"),
                    refuse("K4"), refuse("the dense attention"))
                est.test_step = counted
                timings = {}
                with Capture(fa, "flash_forward_packed") as c3, \
                        Capture(fa, "flash_forward_tiled") as c5:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    scores = est.run(seed=0, timings=timings)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                (fa.flash_forward_packed_plain, fa.flash_forward_tiled_plain,
                 fa.flash_forward_full, attn_mod.attend) = saved
                est.test_step = step
            padded = [max(WIDE_SCORE_FRAMES[i:i + WIDE_SCORE_B]) for i in
                      range(0, len(WIDE_SCORE_FRAMES), WIDE_SCORE_B)]
            if [t for t, _ in per_batch] != padded or \
                    not min(padded) <= fa.MAX_T < max(padded):
                raise AssertionError(f"{tag}: scoring batches padded to "
                                     f"{[t for t, _ in per_batch]} frames, "
                                     f"expected {padded} across {fa.MAX_T}")
            for t, counts in per_batch:
                name = "flash_forward_packed" if t <= fa.MAX_T else \
                    "flash_forward_tiled"
                bad = {k: x for k, x in counts.items()
                       if x != (CUT_L if k == name else 0)}
                if bad:
                    raise AssertionError(f"{tag}: scoring batch of {t} "
                                         f"frames launched {bad}, expected "
                                         f"{CUT_L} {name} and no other")
            n = len(WIDE_SCORE_FRAMES)
            if scores.shape != (n,) or not np.isfinite(scores).all() \
                    or not (scores <= 0).all():
                raise AssertionError(f"{tag}: scores {scores}")
            log(f"{tag} score (LikelihoodEstimator, float32, batch "
                f"{WIDE_SCORE_B}, batches padded to {padded} frames): "
                f"{n} utterances ({audio_s:.1f} s of audio) in {wall:.3f} s, "
                f"{n / wall:.2f} utterances/s; model {timings['model']:.3f} "
                f"s; K3 {CUT_L} and K5 {CUT_L} launches; scores mean "
                f"{scores.mean():.4f} ({gpu})")
            launches["K3 f32"] = CUT_L
            launches["K5 f32"] = CUT_L
            del est
            gc.collect()
            for k, x in call_k3_times(dev, gpu, f"{tag} at the scoring call",
                                      c3.args, None, d).items():
                times[f"{k} f32"] = x
            for k, x in call_k5_times(dev, gpu, f"{tag} at the scoring call",
                                      c5.args, d).items():
                times[f"{k} f32"] = x
            del c3, c5
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()

    # (c) serving: bf16 weights on the hybrid route (K1), then int8
    # weights on K2 at this width (a8 at B 8, bf16 and w4 at B 32)
    prior = make_prior(8, dev)
    kw = dict(temperature=0.85, token_temperature=0.85)
    sampler, vocoder = build_pipeline(dev, False, nheads=nheads,
                                      layers=CUT_L)
    if sampler.route(8) != "hybrid":
        raise AssertionError(f"{tag}: B = 8 with bf16 weights takes the "
                             f"{sampler.route(8)} route")
    vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                    **kw)["output"])
    zero_kernel_counts()
    with Capture(tr_mod, "fused_decode_attention",
                 when=lambda a: a[9] == PROMPT + LENGTH // 2) as c1:
        run_t, _, _ = run_once(sampler, vocoder, prior, dev, 1, kw)
    expect_counts(f"{tag} serving (bf16 weights)",
                  {"fused_decode_attention": CUT_L * LENGTH})
    k1_launches = CUT_L * LENGTH
    hybrid_step = run_t["ar_loop"] / LENGTH * 1e3
    hybrid_rtf = 8 * LENGTH / 50.0 / sum(run_t.values())
    log(f"{tag} serving B=8 (bf16 weights, hybrid route): K1 launches "
        f"{CUT_L * LENGTH}; " + ", ".join(
            f"{k} {x:.3f} s" for k, x in run_t.items())
        + f"; {hybrid_step:.2f} ms per AR step; real-time factor "
        f"{hybrid_rtf:.2f}x ({gpu})")
    model, keep_vocoder, k1_args = sampler.model, vocoder, c1.args
    del sampler
    gc.collect()
    from vae_gslm_tpu_torch.ops.mega_step import fused_trunk_step
    sampler, vocoder = build_pipeline(dev, True, nheads=nheads,
                                      layers=CUT_L)
    k2_launches = {}
    for b, w4, branch, counter in ((8, 0, "a8", "launches"),
                                   (32, 0, "bf16", "launches_bf16"),
                                   (32, 128, "w4", "launches_w4")):
        sampler.mega_w4 = w4
        route = sampler.route(b)
        if route != "mega":
            raise AssertionError(f"{tag}: B = {b} with int8 weights "
                                 f"(w4 {w4}) takes the {route} route")
        prior_b = make_prior(b, dev)
        vocoder(sampler(8, prior_b, torch.Generator(dev).manual_seed(99),
                        **kw)["output"])
        zero_kernel_counts()
        run_t, counts, _ = run_once(sampler, vocoder, prior_b, dev, 1, kw)
        expect_counts(f"{tag} serving B={b} (K2-{branch})",
                      {"fused_trunk_step": LENGTH})
        if getattr(fused_trunk_step, counter) != LENGTH:
            raise AssertionError(f"{tag}: B = {b} ran {counts[1]} K2 steps, "
                                 f"not {LENGTH} of K2-{branch}")
        k2_launches[branch] = LENGTH
        step_ms = run_t["ar_loop"] / LENGTH * 1e3
        rtf = b * LENGTH / 50.0 / sum(run_t.values())
        log(f"{tag} serving B={b} (int8 weights{', w4 group 128' if w4 else ''}"
            f", mega route: K2-{branch} launches {LENGTH}, K1 0); "
            + ", ".join(f"{k} {x:.3f} s" for k, x in run_t.items())
            + f"; {step_ms:.2f} ms per AR step, real-time factor "
            f"{rtf:.2f}x (the hybrid route's at B=8 with bf16 weights: "
            f"{hybrid_step:.2f} ms, {hybrid_rtf:.2f}x) ({gpu})")
        del prior_b
    del sampler, vocoder
    gc.collect()
    # K1 at position 400 of the bf16 rollout
    qa, *cache_a = k1_args[:9]
    pos, li, sl1, ka, va, flushed = k1_args[9:15]
    got = tr_mod.fused_decode_attention(qa, *cache_a, pos, li, sl1, ka, va,
                                        flushed)
    want = fused_decode_attention_plain(qa, *cache_a, pos, li, sl1, ka, va,
                                        flushed)
    torch.cuda.synchronize()
    k1_err = (got - want).abs().max().item()
    if not bool(((got - want).abs() <= 1e-4 + 1e-3 * want.abs()).all()):
        raise AssertionError(f"{tag}: K1 disagrees with its plain version "
                             f"({k1_err:.3e})")
    k1_ms = device_ms(lambda i: tr_mod.fused_decode_attention(
        qa, *cache_a, pos, i % CUT_L, sl1, ka, va, flushed), n=200,
        only=("fused_decode_kernel",), per_call=1)
    nb = 8 * nheads * pos * (2 * d + 8) + 3 * 8 * nheads * d * 2 \
        + 8 * nheads * d * 4 + nheads * 4
    log(f"{tag} K1 at the rollout's call (B=8, H={nheads}, head_dim {d}, "
        f"pos {pos}): max_abs_err {k1_err:.3e}; kernel {k1_ms * 1e3:.2f} us, "
        f"bound {nb / HBM_BYTES_PER_S * 1e6:.2f} us ({nb / 1e6:.2f} MB) "
        f"({gpu})")
    del k1_args, qa, cache_a, ka, va
    # the per-layer route with K6, bf16 weights
    vocoder = keep_vocoder
    sampler = ARTRSampler(model, kv_dtype=torch.int8, flash_decode=True,
                          device=dev)
    sampler.use_hybrid = False               # B 8 per layer
    if sampler.route(8) != "per_layer":
        raise AssertionError(f"{tag}: the K6 rollout took "
                             f"{sampler.route(8)}")
    vocoder(sampler(8, prior, torch.Generator(dev).manual_seed(99),
                    **kw)["output"])
    zero_kernel_counts()
    with Capture(attn_mod, "flash_decode_int8",
                 when=lambda a: a[5] == PROMPT + WIDE_PL_STEPS // 2) as c6:
        run_t, _, _ = run_once(sampler, vocoder, prior, dev, 1, kw,
                               length=WIDE_PL_STEPS)
    expect_counts(f"{tag} per-layer serving (K6)",
                  {"flash_decode_int8": CUT_L * WIDE_PL_STEPS})
    launches["K6"] = CUT_L * WIDE_PL_STEPS
    log(f"{tag} serving B=8 (per-layer int8 cache, K6, bf16 weights, "
        f"{WIDE_PL_STEPS} steps): K6 launches {CUT_L * WIDE_PL_STEPS}; "
        + ", ".join(f"{k} {x:.3f} s" for k, x in run_t.items())
        + f"; {run_t['ar_loop'] / WIDE_PL_STEPS * 1e3:.2f} ms per AR step "
        f"({gpu})")
    del sampler, vocoder, keep_vocoder, model
    gc.collect()
    for k, x in call_k6_times(gpu, f"{tag} at the rollout's call", c6.args,
                              d).items():
        times[k] = x
    del c6
    gc.collect()

    # the kernels line: each kernel of the path at this width
    names = {"K3 bf16": ("flash_forward_packed", ("k3_fwd_wgmma_kernel",),
                         "vae_gslm_tpu/ops/flash_attention.py:230"),
             "K3b bf16": ("flash_backward_packed",
                          ("k3b_dq_wgmma_kernel", "k3b_dkv_wgmma_kernel"),
                          "vae_gslm_tpu/ops/flash_attention.py:359"),
             "K3 f32": ("flash_forward_packed", ("k3_fwd_kernel",),
                        "vae_gslm_tpu/ops/flash_attention.py:230"),
             "K5 f32": ("flash_forward_tiled", ("k5_fwd_kernel",),
                        "vae_gslm_tpu/ops/flash_attention.py:443"),
             "K6": ("flash_decode_int8", ("flash_decode_kernel",),
                    "vae_gslm_tpu/ops/flash_decode.py:131")}
    entries = []
    for key, (ms, plain, lib, bound, err, by) in times.items():
        fn, symbols, replaces = names[key]
        kind = key.split()[0]
        dt = key.split()[1] if " " in key else "f32"
        err = max(err, worst.get((kind, d, dt), 0.0))
        entries.append({
            "name": f"{fn} (head_dim {d}, {nheads} heads: " + ", ".join(
                f"{sym}<{d}>" for sym in symbols) + ")",
            "route": "cuda",
            "source": ("vae_gslm_tpu_torch/csrc/flash_decode.cu"
                       if kind == "K6" else
                       "vae_gslm_tpu_torch/csrc/flash_attention.cu"),
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib})
    return entries, k1_launches, k2_launches


# ------------------------------------------------- K5 past 8192 keys
K5_LONG_TK = 12288                # 245.8 s at 50 Hz
K5_LONG_DENSE_T = 9000            # past K5b's 8192: the dense backward
K5_LONG_UTT_FRAMES = 9000         # one 180 s utterance to score


def phase_k5_long(dev, gpu: str):
    """K5 past 8192 keys, where it raised before: float32 and bfloat16 at
    Tk 12288, self-attention (B 1, 2 heads, causal, Tq 12288) and a cross
    call (B 2, 16 heads, Tq 256, lengths 12288 and 9001, non-causal),
    against the plain version one batch row at a time at phase 5b's gates;
    the time per call (CUDA events) at B 1 x 16 heads x Tq = Tk 12288
    causal beside its bound; then ``FlashAttention`` at Tq = Tk 9000 (K5 forward, then the
    dense recomputed backward: no K5b launch) against autograd of the
    plain reference, float32, gradients to 1e-4 x max|ref|; then
    ``LikelihoodEstimator`` on one 180 s utterance (9000 frames) with a
    small float32 LVTR (2 layers, 2 heads of 64), its initial AR state
    pinned, against the same model's ``likelihood`` on the CPU (plain
    versions) to 1e-4 relative.  Returns the estimator's K5 launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    import yaml

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.likelihood import \
        LikelihoodEstimator
    from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
    from vae_gslm_tpu_torch.nn.positions import alibi_slopes
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.training.checkpoint import save_compact

    tk = K5_LONG_TK
    cases = (("self", 1, tk, 2, [tk], True),
             ("cross", 2, 256, H, [tk, 9001], False))
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for what, b, tq, h, lens, causal in cases:
            q, k, v = bhtd_inputs(dtype, dev, b, tq, tk, h, seed=tq + 1)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            slopes = -torch.tensor(alibi_slopes(h), device=dev)
            where = (f"K5 {what} B={b} Tq={tq} Tk={tk} H={h} "
                     f"{str(dtype)[6:]} causal={causal}")
            fa.flash_forward_tiled.launches = 0
            got = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
            torch.cuda.synchronize()
            n_launch = fa.flash_forward_tiled.launches
            if n_launch != 1:
                raise AssertionError(f"{where}: {n_launch} launches, "
                                     "expected 1")
            want = in_chunks(lambda r: fa.flash_forward_tiled_plain(
                q[r], k[r], v[r], lengths[r], slopes, causal), b, 1)
            _, text = hold(where, "o", got, want, 1e-2 if bf16 else 1e-5,
                           0.0 if bf16 else 1.0, bf16)
            log(f"k5_long check {where}: max_abs_err {text}")
            del q, k, v, got, want
        q, k, v = bhtd_inputs(dtype, dev, 1, tk, tk, H, seed=5)
        lengths = torch.tensor([tk], dtype=torch.int32, device=dev)
        slopes = -torch.tensor(alibi_slopes(H), device=dev)
        # CUDA events: after the CLI phases the profiler's windows have
        # recorded no kernel here, and one call of several ms makes the
        # wrapper's share negligible
        ks = cuda_ms(lambda i: fa.flash_forward_tiled(
            q, k, v, lengths, slopes, True), n=3, reps=3)
        nbytes, flops = bhtd_bytes_ops(1, tk, tk, H, [tk], True,
                                       q.element_size())
        rate = BF16_FLOPS if bf16 else FP32_FLOPS
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
        bound = max(t_b, t_o) * 1e3
        # SDPA with a float mask in query-row chunks of 2048 (the whole
        # call's mask is 16 x 12288^2 of this type), summed: CUDA events
        # around the chunks' calls, as the kernel's time here
        k_pos = torch.arange(tk, device=dev)
        masks = []
        for r0 in range(0, tk, 2048):
            q_pos = torch.arange(r0, min(r0 + 2048, tk), device=dev)
            bias = slopes[:, None, None] * (k_pos[None, :]
                                            - q_pos[:, None]).abs()[None]
            masks.append((r0, torch.where(
                (k_pos[None, :] <= q_pos[:, None])[None, None], bias[None],
                float("-inf")).to(dtype)))

        def sdpa_rows(i):
            with torch.no_grad():
                for r0, m in masks:
                    F.scaled_dot_product_attention(
                        q[:, :, r0:r0 + m.shape[2]], k, v, attn_mask=m)

        ls = cuda_ms(sdpa_rows, n=2, reps=3)
        del masks
        log(f"K5 time B=1 Tq=Tk={tk} H={H} causal {str(dtype)[6:]}: "
            f"{ks:.4f} ms per call (CUDA events), bound {bound:.4f} ms "
            f"({'bytes' if t_b > t_o else 'operations'}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); SDPA (float "
            f"mask) forward in 2048-row chunks {ls:.4f} ms (CUDA events); "
            f"plain not measured at this size ({gpu})")
        del q, k, v

    # FlashAttention autograd past K5b's envelope: K5, then the dense
    # backward, against autograd of the plain reference
    t = K5_LONG_DENSE_T
    ins = [x.detach().clone().requires_grad_() for x in
           bhtd_inputs(torch.float32, dev, 1, t, t, 2, seed=9)]
    lengths = torch.tensor([t - 7], dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(2), device=dev)
    g = torch.randn(ins[0].shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(3))
    fa.flash_forward_tiled.launches = 0
    fa.flash_backward_blockwise.launches = 0
    fa.flash_attention_bhtd(*ins, lengths, slopes).backward(g)
    torch.cuda.synchronize()
    counts = (fa.flash_forward_tiled.launches,
              fa.flash_backward_blockwise.launches)
    ref = [x.detach().clone().requires_grad_() for x in ins]
    fa.attention_reference(*ref, lengths, slopes, True).backward(g)
    worst = 0.0
    for name, a, w in zip("qkv", ins, ref):
        err = (a.grad - w.grad).abs().max().item()
        scale = w.grad.abs().max().item()
        if not err <= 1e-4 * scale:
            raise AssertionError(f"FlashAttention T={t}: d{name} differs by "
                                 f"{err:.3e} (max |ref| {scale:.3e})")
        worst = max(worst, err / scale)
    log(f"k5_long FlashAttention T={t} (float32, K5 forward, dense "
        f"backward): gradients max err {worst:.2e} x max|ref|; (K5, K5b) "
        f"launches {counts}")
    if counts != (1, 0):
        raise AssertionError(f"FlashAttention T={t}: (K5, K5b) launches "
                             f"{counts}, expected (1, 0)")
    del ins, ref

    # one 180 s utterance through LikelihoodEstimator (it raised on the
    # card before), against the CPU
    tmp = tempfile.mkdtemp(prefix="k5_long_")
    try:
        corpus, ckpt, voc = (os.path.join(tmp, n)
                             for n in ("corpus", "ckpt", "voc"))
        for d_ in (corpus, ckpt):
            os.makedirs(d_)
        sec = K5_LONG_UTT_FRAMES / 50.0
        write_train_corpus(corpus, None, 1, sec, sec, seed=4)
        HiFiGAN(Hparams.from_yamlfile(VOCODER_YAML), device=dev,
                generator=torch.Generator(dev).manual_seed(1)
                ).save_pretrained(voc)
        with open(TRAIN_YAML) as f:
            cfg = yaml.safe_load(f)
        cfg["model"] = yaml.safe_load(SMALL_YAML)
        cfg["model"]["tokens"]["vocab_size"] = 200     # the corpus's ids
        cfg["vocoder"]["path"] = voc
        hp = Hparams.from_dict(cfg)
        model = LVTR(hp.model, input_dim=80, device="cpu",
                     generator=torch.Generator().manual_seed(7))
        save_compact(model, os.path.join(ckpt, "last-cpt.npz"))
        hp.save(os.path.join(ckpt, "hp.yaml"))
        infer = Hparams.from_yaml(SCORE_INFER_YAML.format(ckpt=ckpt,
                                                          corpus=corpus))
        infer.data.batch_size = 1
        est = LikelihoodEstimator(infer, device=dev)
        init = torch.from_numpy((np.random.RandomState(8).rand(1, 1, 32) * 2
                                 - 1).astype(np.float32))
        est.model.initial_state = (lambda generator, bsize, nfeat=None:
                                   init.to(dev))
        fa.flash_forward_tiled.launches = 0
        got = est.run()
        torch.cuda.synchronize()
        launches = fa.flash_forward_tiled.launches
        batch = next(iter(est.test_dataloader()))
        x = est.model_input(batch)
        model.initial_state = lambda generator, bsize, nfeat=None: init
        with precision.policy_scope(precision.Policy()), torch.no_grad():
            want = model.likelihood(Masked(x.value.cpu(), x.lengths.cpu(), 1),
                                    None).numpy()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"k5_long LikelihoodEstimator: one {sec:.0f} s utterance "
            f"({int(x.lengths[0])} frames), score {got.tolist()} against the "
            f"CPU's {want.tolist()} (max rel err {rel:.2e}); K5 launches "
            f"{launches}")
        if launches != len(model.transformer.layers) or not rel <= 1e-4 \
                or not np.isfinite(got).all():
            raise AssertionError("k5_long: the estimator's score or launches "
                                 "are wrong")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------- the token LM (slice 16)
DAR_B, DAR_T = 8, 640             # the trainer's batch: 8 x 12.8 s
DAR_STEPS = 4                     # fit's optimizer steps (one warm-up)
HUB_STEPS = 4                     # the HuBERT decoder trainer's steps


def token_lm_config(codec: str, corpus: str, layers=None):
    """The token LM's training config, built from ``TRAIN_YAML`` (no
    DiscreteAR config ships): its ``model.transformer`` without ``flow``
    (``layers`` to cut the depth), single-VQ over the codec's vocabulary,
    ``DiscreteARTrainer`` at ``16-mixed`` with the shipped training block
    and train data settings on ``corpus`` (mels computed, no
    preprocessing; no utterance crops), no validation audio."""
    import copy

    import yaml

    from vae_gslm_tpu_torch.hparams.hp import Hparams

    with open(TRAIN_YAML) as f:
        cfg = yaml.safe_load(f)
    tr = copy.deepcopy(cfg["model"]["transformer"])
    tr.pop("flow", None)
    if layers is not None:
        tr["num_layers"] = layers
    cfg["model"] = {"transformer": tr}
    cfg["hubert"] = {"path": codec, "sample_rate": 50}
    cfg["trainer"].update(identifier="trainers.speech.discrete."
                          "DiscreteARTrainer", distributed=False,
                          limit_val_batches=1, val_check_interval=None)
    cfg["logging"]["num_samples"] = 0
    data = cfg["data"]["train"]
    for key in ("preprocess_mels", "preprocess_mels_recursive_dir",
                "random_crop_mel_utt", "min_audio_length"):
        data.pop(key, None)
    data.update(path=os.path.join(corpus, "tokens.txt"), wavdir=corpus,
                bits_per_second=32000, batch_size=DAR_B, num_workers=4,
                token_segment_size=DAR_T)
    data["post_pad"] = {"tokens": {"num_tokens": DAR_T}}
    cfg["data"] = {"train": data, "val": copy.deepcopy(data)}
    return Hparams.from_dict(cfg)


def codec_config(voc: str):
    """The HuBERT token -> mel codec at full width: embedding 64 over the
    shipped token vocabulary (no dedup, 50 Hz), a 3-layer ``ResNet``
    ``embed_encoder`` at the shipped encoder's widths (512 channels, 2048
    hidden, k 7, InstanceNorm, ReLU), the shipped ``model.decoder`` with
    ``condition_dim`` the embedding's, over the vocoder at ``voc``."""
    import copy

    import yaml

    from vae_gslm_tpu_torch.hparams.hp import Hparams

    with open(TRAIN_YAML) as f:
        m = yaml.safe_load(f)["model"]
    enc = m["encoder"]
    decoder = copy.deepcopy(m["decoder"])
    decoder["cond_unet"]["unet"]["condition_dim"] = 64
    model = {
        "embedding_dim": 64,
        "hubert": {"vocab_size": m["tokens"]["vocab_size"],
                   "deduplicate": False, "sample_rate": 50},
        "embed_encoder": {
            "num_layers": enc["num_layers"], "final_norm": True,
            "layer": {"in_channels": enc["init_channel"],
                      "hidden_channels": enc["hidden_channels"][0],
                      **copy.deepcopy(enc["layer"])}},
        "decoder": decoder}
    return Hparams.from_dict({"model": model, "vocoder": {"path": voc}})


def token_lm_dirs(root: str, dev):
    """Under ``root``: the 80-bin vocoder (seed 1), the full-width codec
    (``HuBERTIO.save_pretrained``, seed 2), a 48-utterance corpus of
    13 s each from seed 5 (WAVs and 200-token ids at 50 Hz), and the
    full-width token LM's checkpoint directory (``CUT_L`` layers,
    ``save_compact``, seed 0,
    its training config as ``hp.yaml``).  Returns their paths."""
    import torch

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.speech.discrete import DiscreteAR
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN, HuBERTIO
    from vae_gslm_tpu_torch.training.checkpoint import save_compact

    paths = {n: os.path.join(root, n)
             for n in ("voc", "codec", "corpus", "ckpt")}
    for n in ("corpus", "ckpt"):
        os.makedirs(paths[n])
    t0 = time.perf_counter()
    HiFiGAN(Hparams.from_yamlfile(VOCODER_YAML), device=dev,
            generator=torch.Generator(dev).manual_seed(1)
            ).save_pretrained(paths["voc"])
    codec = HuBERTIO(codec_config(paths["voc"]), device=dev,
                     generator=torch.Generator(dev).manual_seed(2))
    codec.save_pretrained(paths["codec"])
    # one length, so that the micro-batches' audio rows stack
    write_train_corpus(paths["corpus"], None, 48, 13.0, 13.0, seed=5)
    hp = token_lm_config(paths["codec"], paths["corpus"], layers=CUT_L)
    model = DiscreteAR(hp.model, codec.hp_vq, input_dim=80, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    save_compact(model, os.path.join(paths["ckpt"], "last-cpt.npz"))
    hp.save(os.path.join(paths["ckpt"], "hp.yaml"))
    n_lm = sum(p.numel() for p in model.parameters())
    n_codec = sum(p.numel() for p in codec.model.parameters())
    log(f"token LM: DiscreteAR {n_lm / 1e6:.1f} M parameters, HuBERT codec "
        f"{n_codec / 1e6:.1f} M, the vocoder and a 48-utterance corpus "
        f"written in {time.perf_counter() - t0:.1f} s")
    return paths


def _argmax_draws(model):
    """The token draw replaced by the argmax of the logits (the
    deterministic protocol across devices, whose Gumbel streams differ);
    the top-two gap of each draw's logits recorded."""
    import torch

    gaps = []

    def draw(h, generator, temperature):
        logits = model.transformer.out(h).float()
        top = torch.topk(logits[:, -1], 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).cpu())
        return logits.argmax(-1)

    model._sample_from_hidden = draw
    return gaps


def phase_discrete_small(dev):
    """A 2-layer DiscreteAR (d 128, two heads of 64, its output layer
    scaled by 10) on the card (through the kernels) and on the CPU
    (through the plain versions), same weights, float32: the hybrid route
    (int8 cache, K1, across a 256-position flush) and the per-layer route
    (float32 cache), 300 tokens from a 41-token prompt at B 2 with argmax
    draws: tokens equal up to a draw whose CPU top-two gap is under 5e-3
    (none expected), at least 150 steps; ``likelihood`` at T 300 (K3) and
    1100 (K5) to 1e-4 relative; one ``DiscreteARTrainer`` step (float32,
    accumulation 2, B 3 x 100) card against CPU: the CE to 1e-4 relative,
    every gradient to 1e-3 x its max |g|."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.sampler import \
        DiscreteARSampler
    from vae_gslm_tpu_torch.models.speech.discrete import DiscreteAR
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN, HuBERTIO
    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.trainers.speech.discrete import DiscreteARTrainer
    from vae_gslm_tpu_torch.training.trainer import stack_batches

    small = {"num_layers": 2, "bias": False,
             "rpe": {"identifier": "ALiBi", "maxpos": 1024},
             "layer": {"dim": 128, "ffd_size": 512,
                       "norm": {"identifier": "RMSNorm", "eps": 1e-6},
                       "activation": {"identifier": "GELU"},
                       "self_attn": {"nheads": 2, "causal": True}}}
    vq = Hparams(num_quantizers=1, codebook_size=200, dim=64)
    hp = Hparams.from_dict({"transformer": small})
    rng = np.random.RandomState(11)
    with precision.policy_scope(precision.Policy()):
        cpu = DiscreteAR(hp, vq, device="cpu",
                         generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            cpu.transformer.out.weight.mul_(10.0)
        gpu = DiscreteAR(hp, vq, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        prompt = rng.randint(0, 200, (2, 41))
        for route, kv in (("hybrid", torch.int8), ("per_layer", None)):
            outs, gaps = [], None
            for model, where in ((cpu, "cpu"), (gpu, dev)):
                g = _argmax_draws(model)
                gaps = g if where == "cpu" else gaps
                samp = DiscreteARSampler(model, kv_dtype=kv, device=where)
                if samp.route(2) != route:
                    raise AssertionError(f"discrete_small: route "
                                         f"{samp.route(2)}, not {route}")
                fused_decode_attention.launches = 0
                out = samp(300, Masked.from_lengths(
                    torch.from_numpy(prompt).to(where), [41, 41]),
                    temperature=1e-4)
                outs.append(out.value.cpu().numpy())
                k1 = fused_decode_attention.launches
                del model._sample_from_hidden
            torch.cuda.synchronize()
            want_k1 = 2 * 300 if route == "hybrid" else 0
            gap = torch.stack(gaps, 1).numpy()
            agree = []
            for r in range(2):
                diff = np.flatnonzero(outs[0][r] != outs[1][r])
                n = outs[0].shape[1] if not diff.size else int(diff[0])
                if diff.size and not gap[r, n - 41] < 5e-3:
                    raise AssertionError(
                        f"discrete_small {route}: row {r} parts at "
                        f"{n} with a top-two gap of {gap[r, n - 41]:.3e}")
                agree.append(n - 41)
            log(f"discrete_small {route} (B 2, 300 tokens, card vs CPU, "
                f"argmax): tokens agree for {agree} steps; K1 launches {k1}")
            if min(agree) < 150 or k1 != want_k1:
                raise AssertionError(f"discrete_small {route}: agreement "
                                     f"{agree}, K1 launches {k1} (expected "
                                     f"{want_k1})")
        for t, lens, want in ((300, [300, 1, 211], (2, 0)),
                              (1100, [1100, 1030, 2], (0, 2))):
            x = rng.randint(0, 200, (3, t))
            scores = []
            for model, where in ((cpu, "cpu"), (gpu, dev)):
                fa.flash_forward_packed.launches = 0
                fa.flash_forward_tiled.launches = 0
                with torch.no_grad():
                    scores.append(model.likelihood(Masked.from_lengths(
                        torch.from_numpy(x).to(where), lens)).cpu().double())
                counts = (fa.flash_forward_packed.launches,
                          fa.flash_forward_tiled.launches)
            rel = ((scores[1] - scores[0]).abs()
                   / scores[0].abs()).max().item()
            log(f"discrete_small likelihood T={t} (float32): scores "
                f"{scores[1].tolist()}, max rel err {rel:.2e}; card (K3, K5) "
                f"launches {counts}")
            if counts != want or not rel <= 1e-4:
                raise AssertionError(f"discrete_small likelihood T={t}")

    # one trainer step card vs CPU over a small codec
    with tempfile.TemporaryDirectory() as tmp:
        voc, codec_dir = os.path.join(tmp, "voc"), os.path.join(tmp, "codec")
        HiFiGAN(Hparams.from_yaml(HFGAN_SMALL_YAML), device="cpu",
                generator=torch.Generator().manual_seed(1)
                ).save_pretrained(voc)
        ccfg = codec_config(voc).to_dict()
        ccfg["model"]["embed_encoder"]["layer"].update(in_channels=32,
                                                       hidden_channels=64)
        ccfg["model"]["decoder"] = yaml_small_decoder()
        HuBERTIO(Hparams.from_dict(ccfg), device="cpu").save_pretrained(
            codec_dir)
        cfg = token_lm_config(codec_dir, tmp).to_dict()
        cfg["model"] = {"transformer": copy.deepcopy(small)}
        cfg["trainer"]["precision"] = "32"
        cfg["training"]["gradient_clip_val"] = 1.0
        trainers = [DiscreteARTrainer(Hparams.from_dict(copy.deepcopy(cfg)),
                                      seed=4, device=d_)
                    for d_ in ("cpu", dev)]
    trainers[1].model.load_state_dict(trainers[0].model.state_dict())
    toks = rng.randint(0, 200, (2, 3, 100))
    lens = [100, 61, 1]
    batch = stack_batches([{"tokens": Masked.from_lengths(
        torch.from_numpy(toks[i]), lens)} for i in range(2)])
    metrics = []
    for tr in trainers:
        fa.flash_forward_packed.launches = 0
        fa.flash_backward_packed.launches = 0
        metrics.append(tr.run_step(batch))
    torch.cuda.synchronize()
    counts = (fa.flash_forward_packed.launches,
              fa.flash_backward_packed.launches)
    rel = abs(float(metrics[1]["kld"]) - float(metrics[0]["kld"])) / abs(
        float(metrics[0]["kld"]))
    worst = 0.0
    for name, pc, pg in zip(trainers[0].names, trainers[0].params,
                            trainers[1].params):
        gc_, gg = pc.grad.double(), pg.grad.double().cpu()
        err, scale = (gg - gc_).abs().max().item(), gc_.abs().max().item()
        if not err <= 1e-3 * scale + 1e-30:
            raise AssertionError(f"discrete_small step: gradient of {name} "
                                 f"differs by {err:.3e} (max |g| "
                                 f"{scale:.3e})")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"discrete_small trainer step (float32, accumulation 2, card K3/K3b "
        f"vs CPU plain): CE per token {float(metrics[1]['kld']):.5f} (rel "
        f"err {rel:.2e}), gradients max err {worst:.2e} x max|g|; K3/K3b "
        f"launches {counts}")
    if counts != (4, 4) or not rel <= 1e-4:
        raise AssertionError(f"discrete_small step: launches {counts}, CE "
                             f"rel err {rel:.2e}")


def yaml_small_decoder() -> dict:
    """SMALL_YAML's diffusion decoder (condition width 64)."""
    import copy

    import yaml

    d = copy.deepcopy(yaml.safe_load(SMALL_YAML)["decoder"])
    d["cond_unet"]["unet"]["condition_dim"] = 16
    return d


def phase_discrete_train(dev, gpu: str, paths: dict):
    """``scripts/train.py`` -> ``DiscreteARTrainer.fit`` at full width (the
    shipped trunk without its flow, 201 M trunk parameters, 16-mixed,
    AdamW, accumulation 2) on ``paths``' corpus: B 8 x 640 tokens, mels
    computed by the dataset on the card, ``DAR_STEPS`` optimizer steps,
    each step's kernel counts set to 0 just before ``run_step`` and read
    just after (exactly 2 CUT_L K3 and 2 CUT_L K3b launches: ``CUT_L``
    layers, cut from 16 for time, x 2 micro-batches; the plain attention
    versions refused), then the final
    validation and checkpoint.  Returns the last step's (K3, K3b)."""
    import torch
    import yaml

    from vae_gslm_tpu_torch.ops import flash_attention as fa
    from vae_gslm_tpu_torch.scripts import train as train_cli
    from vae_gslm_tpu_torch.trainers.speech.discrete import DiscreteARTrainer

    cfg = token_lm_config(paths["codec"], paths["corpus"],
                          layers=CUT_L).to_dict()
    cfg["logging"]["log_dir"] = os.path.join(paths["corpus"], "..", "logs")
    config = os.path.join(paths["ckpt"], "..", "train_lm.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    run_step = DiscreteARTrainer.run_step
    steps, counts = [], []
    accum = cfg["training"]["gradient_accumulation"]
    want = cfg["model"]["transformer"]["num_layers"] * accum

    def timed(self, stacked):
        fa.flash_forward_packed.launches = 0
        fa.flash_backward_packed.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step(self, stacked)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        counts.append((fa.flash_forward_packed.launches,
                       fa.flash_backward_packed.launches))
        log(f"discrete_train step {len(steps) - 1}: {steps[-1] * 1e3:.1f} ms,"
            f" CE per token {float(out['kld']):.4f}; K3/K3b {counts[-1]}")
        if counts[-1] != (want, want) or not math.isfinite(
                float(out["kld"])):
            raise AssertionError(f"discrete_train: K3/K3b {counts[-1]} "
                                 f"(expected {want} each), CE {out['kld']}")
        return out

    undo = _refuse_plain("discrete_train")
    DiscreteARTrainer.run_step = timed
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.main(["-c", config, "--max_steps", str(DAR_STEPS)])
        wall = time.perf_counter() - t0
    finally:
        DiscreteARTrainer.run_step = run_step
        undo()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(steps[1:])
    tokens = DAR_B * accum * DAR_T
    log(f"discrete_train (scripts/train.py, B={DAR_B} x accumulation "
        f"{accum} x {DAR_T} tokens, 16-mixed): median step "
        f"{med * 1e3:.1f} ms over {len(steps) - 1} steps after a warm-up, "
        f"{tokens / med:.0f} tokens/s; the whole CLI {wall:.1f} s; peak "
        f"memory {peak / 2 ** 30:.2f} GiB; K3/K3b per step {counts[-1]} "
        f"({gpu})")
    if len(steps) != DAR_STEPS:
        raise AssertionError(f"discrete_train ran {len(steps)} steps")
    return counts[-1]


def phase_hubert_decoder_fit(dev, gpu: str, paths: dict):
    """``HuBERTDecoderTrainer`` at full width (the codec of
    ``codec_config``, float32, AdamW of the shipped training block) for
    ``HUB_STEPS`` steps on synthetic B 8 x 640-frame batches (tokens and
    80-bin mels from seed 6; no port kernel: the counts stay 0), then
    ``save_checkpoint`` and ``HuBERTIO.from_pretrained`` reading it back
    strictly, equal to the trainer's weights."""
    import copy

    import numpy as np
    import torch
    import yaml

    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HuBERTIO
    from vae_gslm_tpu_torch.trainers.vocoder.hubert import \
        HuBERTDecoderTrainer
    from vae_gslm_tpu_torch.training.trainer import stack_batches

    with open(TRAIN_YAML) as f:
        shipped = yaml.safe_load(f)
    cfg = codec_config(paths["voc"]).to_dict()
    cfg.update(trainer={"identifier": "trainers.vocoder.hubert."
                        "HuBERTDecoderTrainer",
                        "total_steps": shipped["trainer"]["total_steps"],
                        "precision": "32"},
               logging={"log_dir": "unused", "num_samples": 0},
               training=copy.deepcopy(shipped["training"]), data={})
    t0 = time.perf_counter()
    tr = HuBERTDecoderTrainer(Hparams.from_dict(cfg), seed=3, device=dev)
    nparams = sum(p.numel() for p in tr.params)
    built = time.perf_counter() - t0
    rng = np.random.RandomState(6)
    lens = [DAR_T] * (DAR_B - 2) + [DAR_T * 25 // 32, DAR_T // 2]
    batch = stack_batches([{
        "tokens": Masked.from_lengths(torch.from_numpy(
            rng.randint(0, 200, (DAR_B, DAR_T))), lens),
        "mel": Masked.from_lengths(torch.from_numpy(
            rng.randn(DAR_B, DAR_T, 80).astype(np.float32)), lens)}])
    zero_kernel_counts()
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(HUB_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = tr.run_step(batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t1)
        tr.global_step += 1
        if not math.isfinite(float(m["rec_loss"])):
            raise AssertionError(f"hubert_decoder_fit: rec_loss {m}")
    expect_counts("hubert_decoder_fit", {})
    peak = torch.cuda.max_memory_allocated()
    out_dir = os.path.join(paths["codec"] + "_trained")
    os.makedirs(out_dir)
    tr.save_checkpoint(os.path.join(out_dir, "last-cpt.npz"))
    back = HuBERTIO.from_pretrained(out_dir, device=dev)
    for (name, a), b in zip(tr.model.state_dict().items(),
                            back.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"hubert_decoder_fit: {name} read back "
                                 "differently")
    log(f"hubert_decoder_fit: HuBERT decoder {nparams / 1e6:.1f} M "
        f"parameters and AdamW built in {built:.1f} s; B={DAR_B} x {DAR_T} "
        f"frames, float32: steps "
        f"{', '.join(f'{s * 1e3:.1f}' for s in steps)} ms (median after the "
        f"first {statistics.median(steps[1:]) * 1e3:.1f} ms), rec_loss "
        f"{float(m['rec_loss']):.4f}; peak memory {peak / 2 ** 30:.2f} GiB; "
        f"saved and read back by HuBERTIO.from_pretrained, equal ({gpu})")


DAR_PRIOR_S, DAR_CONT_S = 3.0, 10.0  # the shipped infer config's
DAR_INFER_YAML = """
identifier: "inference.speech.hubert.SpeechInferer"
precision: "16-mixed"
output_dir: "{out}"
ckpt_path: "{ckpt}"
model: {{identifier: "models.speech.discrete.DiscreteAR"}}
sample_prior_length: {prior}
sample_length: {cont}
temperature: 0.85
diffusion: {{sampling_timesteps: 100, ddim_sampling_eta: 0.5}}
data:
    path: "{corpus}/tokens.txt"
    wavdir: "{corpus}"
    sample_rate: 16000
    with_text: false
    with_tokens: true
    batch_size: 8
    num_workers: 4
    min_audio_length: 5.0
    bits_per_second: 32000
    pad: {{multiple_of: 320, mode: "constant"}}
    sampler: {{type: "standard", shuffle: false}}
trainer: {{distributed: false}}
"""


def phase_discrete_serve(dev, gpu: str, paths: dict) -> int:
    """The token LM's serving at full width, bf16 weights: first
    ``DiscreteARSampler(kv_dtype=torch.int8)`` at B 8 on 150-token prompts
    for 500 tokens, the hybrid route (exactly CUT_L x 500 K1 launches, no
    other kernel), its ms per AR step; then ``scripts/infer.py`` with the
    token-LM ``SpeechInferer`` (``inference/speech/hubert.py``) on 8 of the
    corpus's utterances at B 8: the per-layer float32 route (no kernel on
    the AR loop), HuBERT DDIM-100, HiFi-GAN, 8 continuations and 8 decoded
    prompts written, each finite and at most 13 s (3 s).  Returns the
    sampler's K1 launches."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.data import audio
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.sampler import \
        DiscreteARSampler
    from vae_gslm_tpu_torch.models.speech.discrete import DiscreteAR
    from vae_gslm_tpu_torch.ops.fused_decode import fused_decode_attention
    from vae_gslm_tpu_torch.scripts import infer as infer_cli
    from vae_gslm_tpu_torch.training.checkpoint import load_compact

    hp = Hparams.from_yamlfile(os.path.join(paths["ckpt"], "hp.yaml"))
    with precision.policy_scope(precision.bf16_mixed()):
        model = DiscreteAR(hp.model, Hparams(num_quantizers=1,
                                             codebook_size=200, dim=64),
                           input_dim=80, device=dev)
        load_compact(model, os.path.join(paths["ckpt"], "last-cpt.npz"))
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
        sampler = DiscreteARSampler(model, kv_dtype=torch.int8, device=dev)
        nl = len(model.transformer.layers)
        if sampler.route(DAR_B) != "hybrid":
            raise AssertionError("discrete_serve: not the hybrid route")
        prior = Masked.from_lengths(torch.from_numpy(np.random.RandomState(
            7).randint(0, 200, (DAR_B, PROMPT))).to(dev), [PROMPT] * DAR_B)
        gen = torch.Generator(dev).manual_seed(0)
        sampler(8, prior, gen, temperature=0.85)          # warm-up
        zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(LENGTH, prior, gen, temperature=0.85)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = expect_counts("discrete_serve hybrid",
                           {"fused_decode_attention": nl * LENGTH})
    toks = out.value
    if toks.shape != (DAR_B, PROMPT + LENGTH) or not bool(
            ((toks >= 0) & (toks < 200)).all()):
        raise AssertionError(f"discrete_serve: tokens {tuple(toks.shape)}")
    log(f"discrete_serve hybrid (B={DAR_B}, {PROMPT} -> {LENGTH} tokens, "
        f"bf16 weights, int8 cache): {sec:.2f} s, "
        f"{sec / LENGTH * 1e3:.2f} ms per AR step (prefill included); K1 "
        f"launches {counts['fused_decode_attention']} ({gpu})")
    del model, sampler

    out_dir = os.path.join(paths["ckpt"], "..", "lm_out")
    config = os.path.join(paths["ckpt"], "..", "infer_lm.yaml")
    corpus8 = os.path.join(paths["ckpt"], "..", "corpus8")
    os.makedirs(corpus8)
    with open(os.path.join(paths["corpus"], "tokens.txt")) as f:
        lines = f.read().splitlines()[:DAR_B]
    for line in lines:
        name = line.split("|")[0]
        os.symlink(os.path.join(paths["corpus"], name),
                   os.path.join(corpus8, name))
    with open(os.path.join(corpus8, "tokens.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(config, "w") as f:
        f.write(DAR_INFER_YAML.format(out=out_dir, ckpt=paths["ckpt"],
                                      corpus=corpus8, prior=DAR_PRIOR_S,
                                      cont=DAR_CONT_S))
    prior_n, cont_n = int(DAR_PRIOR_S * 50), int(DAR_CONT_S * 50)
    zero_kernel_counts()
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = infer_cli.main(["-c", config, "--max_batches", "1"], timings=timings)
    wall = time.perf_counter() - t0
    expect_counts("discrete_serve CLI", {})
    peak = torch.cuda.max_memory_allocated()
    names = sorted(os.listdir(out_dir))
    if n != DAR_B or len(names) != 2 * DAR_B:
        raise AssertionError(f"discrete_serve CLI: {n} continuations, files "
                             f"{names}")
    longest = 0
    for name in names:
        wave, sr = audio.load_audio(os.path.join(out_dir, name))
        limit = (prior_n if name.endswith("_ov.wav")
                 else prior_n + cont_n) * 320
        if sr != 16000 or not 0 < len(wave) <= limit or not \
                np.isfinite(wave).all():
            raise AssertionError(f"discrete_serve CLI: {name} has {len(wave)}"
                                 f" samples at {sr} Hz")
        longest = max(longest, len(wave))
    log(f"discrete_serve CLI (scripts/infer.py, inference.speech.hubert."
        f"SpeechInferer, B={DAR_B}, per-layer float32 cache, 16-mixed, "
        f"HuBERT DDIM-100, HiFi-GAN): {n} continuations and their prompts "
        f"in {wall:.1f} s, AR loop {timings['ar_loop']:.2f} s "
        f"({timings['ar_loop'] / cont_n * 1e3:.1f} ms per step), codec "
        f"{timings['codec']:.2f} s; longest wave {longest / 16000:.2f} s; "
        f"real-time factor {n * DAR_CONT_S / wall:.1f}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB ({gpu})")
    return counts["fused_decode_attention"]


def phase_discrete_score(dev, gpu: str, paths: dict):
    """``LikelihoodEstimator`` (the token LM branch) at full width,
    float32, on 8 utterances at batch 4: one batch of 10-20 s (padded to
    <= 1024 tokens: exactly CUT_L K3 launches) and one of 22-25 s (past
    1024: exactly CUT_L K5 launches), the plain versions refused; finite
    scores <= 0.  Returns (K3, K5) launches."""
    import shutil

    import numpy as np
    import torch

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.likelihood import \
        LikelihoodEstimator
    from vae_gslm_tpu_torch.ops import flash_attention as fa

    root = os.path.join(paths["ckpt"], "..", "score_corpus")
    parts = []
    for i, (lo, hi) in enumerate(((10.0, 20.0), (22.0, 25.0))):
        d_ = os.path.join(root, str(i))
        os.makedirs(d_)
        write_train_corpus(d_, None, 4, lo, hi, seed=20 + i)
        with open(os.path.join(d_, "tokens.txt")) as f:
            parts += [f"{i}/{line}" for line in f.read().splitlines()]
    with open(os.path.join(root, "tokens.txt"), "w") as f:
        f.write("\n".join(parts) + "\n")
    hp = Hparams.from_yaml(SCORE_INFER_YAML.format(ckpt=paths["ckpt"],
                                                   corpus=root))
    hp.model.identifier = "models.speech.discrete.DiscreteAR"
    hp.data.batch_size = 4
    est = LikelihoodEstimator(hp, device=dev)
    undo = _refuse_plain("discrete_score")
    try:
        est.run(max_batches=1)                      # warm-up
        zero_kernel_counts()
        timings = {}
        t0 = time.perf_counter()
        scores = est.run(timings=timings)
        wall = time.perf_counter() - t0
    finally:
        undo()
    counts = (fa.flash_forward_packed.launches,
              fa.flash_forward_tiled.launches)
    nl = len(est.model.transformer.layers)
    expect_counts("discrete_score", {"flash_forward_packed": nl,
                                     "flash_forward_tiled": nl})
    if scores.shape != (8,) or not np.isfinite(scores).all() or not \
            (scores <= 0).all():
        raise AssertionError(f"discrete_score: scores {scores}")
    log(f"discrete_score (float32, 8 utterances at batch 4, one batch past "
        f"1024 tokens): {8 / wall:.2f} utterances/s ({wall:.2f} s, model "
        f"{timings['model']:.2f} s); scores {np.round(scores, 4).tolist()}; "
        f"(K3, K5) launches {counts} ({gpu})")
    shutil.rmtree(root, ignore_errors=True)
    return counts


# ------------------------------------------------------------ SoundStream
SS_STEPS = 4                      # optimizer steps: a warm-up and three
SS_UTTERANCES = 16                # 13 s WAVs: one step of B 8 x 2


def soundstream_config(voc: str, corpus: str, log_dir: str) -> dict:
    """A SoundStream training config derived from ``TRAIN_YAML`` (no
    SoundStream config ships): the shipped ``model.encoder`` block as the
    encoder and as the decoder (3 x BottleNeckResNet, 512 channels, hidden
    2048, causal k 7, InstanceNorm), the quantizer ``{identifier: VQ, dim:
    512, codebook_size: 1024}``; ``SoundStreamTrainer`` in float32 with the
    shipped training block (AdamW, accumulation 2, the mel rescale); B 8
    x 12.8 s (640 frames) of ``corpus``'s WAVs, mels computed on the
    card; the vocoder at ``voc`` (the mel settings)."""
    import copy

    import yaml

    with open(TRAIN_YAML) as f:
        shipped = yaml.safe_load(f)
    enc = shipped["model"]["encoder"]
    data = {"path": os.path.join(corpus, "tokens.txt"), "wavdir": corpus,
            "sample_rate": 16000, "with_text": False, "with_tokens": False,
            "batch_size": 8, "num_workers": 4, "segment_size": 12.8,
            "post_pad": {"mel": {"length": 12.8}},
            "sampler": {"type": "standard", "shuffle": True}}
    return {
        "trainer": {"identifier": "trainers.speech.soundstream."
                    "SoundStreamTrainer",
                    "total_steps": shipped["trainer"]["total_steps"],
                    "precision": "32", "distributed": False,
                    "limit_val_batches": 1, "val_check_interval": None},
        "logging": {"log_dir": log_dir, "num_samples": 0},
        "vocoder": {"path": voc},
        "model": {"encoder": copy.deepcopy(enc),
                  "decoder": copy.deepcopy(enc),
                  "quantizer": {"identifier": "VQ", "dim": 512,
                                "codebook_size": 1024}},
        "training": copy.deepcopy(shipped["training"]),
        "data": {"train": data,
                 "val": dict(copy.deepcopy(data),
                             sampler={"type": "standard",
                                      "shuffle": False})}}


def phase_soundstream(dev, gpu: str, root: str) -> None:
    """``scripts/train.py`` -> ``SoundStreamTrainer.fit`` on
    ``soundstream_config`` for ``SS_STEPS`` optimizer steps (a warm-up and
    three timed), float32 with TF32 off, over ``SS_UTTERANCES`` synthetic
    13 s WAVs (seed 7) and the seed-1 HiFi-GAN saved under ``root``; each
    step's kernel counts set to 0 just before ``run_step`` and read just
    after (no K1-K7 kernel may launch); then the compact checkpoint that
    ``fit`` saved, resumed by a fresh trainer (seed 5): its parameters
    equal the fitted trainer's.  Logs ms a step, frames a second and peak
    memory."""
    import torch
    import yaml

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
    from vae_gslm_tpu_torch.scripts import train as train_cli
    from vae_gslm_tpu_torch.trainers.speech.soundstream import \
        SoundStreamTrainer

    voc, corpus = os.path.join(root, "voc"), os.path.join(root, "corpus")
    os.makedirs(corpus)
    HiFiGAN(Hparams.from_yamlfile(VOCODER_YAML), device=dev,
            generator=torch.Generator(dev).manual_seed(1)
            ).save_pretrained(voc)
    audio_s = write_train_corpus(corpus, None, SS_UTTERANCES, 13.0, 13.0,
                                 seed=7)
    cfg = soundstream_config(voc, corpus, os.path.join(root, "logs"))
    config = os.path.join(root, "soundstream.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    run_step = SoundStreamTrainer.run_step
    steps, trainers = [], []

    def timed(self, stacked):
        zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step(self, stacked)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        expect_counts(f"soundstream step {len(steps) - 1}", {})
        terms = {k: float(out[k]) for k in ("rec_loss", "aux_loss")}
        if not all(math.isfinite(x) for x in terms.values()):
            raise AssertionError(f"soundstream: non-finite metrics {terms}")
        if self not in trainers:
            trainers.append(self)
        log(f"soundstream step {len(steps) - 1}"
            f"{' (warm-up)' if len(steps) == 1 else ''}: "
            f"{steps[-1] * 1e3:.1f} ms; " + ", ".join(
                f"{k} {x:.4f}" for k, x in terms.items()))
        return out

    SoundStreamTrainer.run_step = timed
    try:
        with precision.policy_scope(precision.Policy()):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_cli.main(["-c", config, "--max_steps", str(SS_STEPS),
                            "-n", "run"])
            wall = time.perf_counter() - t0
    finally:
        SoundStreamTrainer.run_step = run_step
    peak = torch.cuda.max_memory_allocated()
    if len(steps) != SS_STEPS or len(trainers) != 1:
        raise AssertionError(f"soundstream: {len(steps)} steps by "
                             f"{len(trainers)} trainers")
    trainer = trainers[0]
    ckpt = os.path.join(root, "logs", "run", "ckpt", "version_0",
                        "last-cpt.npz")
    again = SoundStreamTrainer(Hparams.from_dict(cfg), seed=5, device=dev)
    again.resume(ckpt)
    for name, a, b in zip(trainer.names, trainer.params, again.params):
        if not torch.equal(a, b):
            raise AssertionError(f"soundstream: {name} resumed from the "
                                 "compact checkpoint differs")
    nparams = sum(p.numel() for p in trainer.params)
    accum = cfg["training"]["gradient_accumulation"]
    med = statistics.median(steps[1:])
    frames = 8 * accum * 640
    log(f"soundstream (scripts/train.py -> SoundStreamTrainer.fit, "
        f"{nparams / 1e6:.1f} M parameters, B=8 x accumulation {accum} x "
        f"640 frames, float32, TF32 off; {SS_UTTERANCES} WAVs, "
        f"{audio_s:.0f} s of audio): median step {med * 1e3:.1f} ms over "
        f"{len(steps) - 1} steps after a warm-up (range "
        f"{min(steps[1:]) * 1e3:.1f}-{max(steps[1:]) * 1e3:.1f}), "
        f"{frames / med:.0f} frames/s; the whole CLI {wall:.1f} s; peak "
        f"memory {peak / 2 ** 30:.2f} GiB; no K1-K7 launch; the compact "
        f"checkpoint resumed by a fresh trainer, equal ({gpu})")


# ---------------------------------------------------- text-to-speech
TTS_STEPS = 4                     # fit's optimizer steps: a warm-up and three
TTS_UTTERANCES = 32               # 12 s WAVs: two steps of B 8 x 2 an epoch
TTS_SERVE_B = 8                   # the inferer's batch
TTS_MAX_S, TTS_MIN_S = 10.0, 1.0  # at most 500 frames, an EOS after 50
TTS_ROUTE_STEPS = 50              # the per-layer timing and the route check
TTS_SMALL_T = 40                  # frames of the small card-against-CPU step
RECON_UTTERANCES = 8              # 2-3 s WAVs, one batch
TTS_CHARS = "abcdefghijklmnopqrstuvwxyz_"


def tts_model_config(layers=None) -> dict:
    """The LVTTS model derived from ``TRAIN_YAML`` (no TTS config ships):
    the shipped ``latent_dim``, encoder, decoder and trunk (``layers``
    layers, 16 unless given) with ``cross_attn: {nheads: 16}`` in each
    trunk layer, no tokens and no utterance encoder (TTS batches carry
    neither); ``text``: a 512-wide embedding and a 6-layer d512 encoder (8
    heads, FFN 2048, RMSNorm, GELU, ALiBi maxpos 1024, non-causal, no
    bias); ``eos``: one GELU/LayerNorm block of 1024; ``spkr``: the shipped
    utterance encoder's channels and strides (64 -> 128/256/512, rates -2,
    kernel 4) as a ``BottleNeckResNet`` with hidden channels 4x its out
    channels and the shipped encoder's block (k 7, causal, InstanceNorm,
    ReLU), to a 512-wide embedding."""
    import copy

    import yaml

    with open(TRAIN_YAML) as f:
        shipped = yaml.safe_load(f)["model"]
    m = {k: copy.deepcopy(shipped[k]) for k in ("latent_dim", "encoder",
                                                "decoder", "transformer")}
    m["transformer"]["layer"]["cross_attn"] = {"nheads": 16}
    if layers:
        m["transformer"]["num_layers"] = layers
    rms = {"identifier": "RMSNorm", "eps": 1e-6}
    m["text"] = {"embedding_dim": 512, "encoder": {
        "num_layers": 6, "bias": False,
        "rpe": {"identifier": "ALiBi", "maxpos": 1024},
        "layer": {"dim": 512, "ffd_size": 2048, "norm": rms,
                  "activation": {"identifier": "GELU"},
                  "self_attn": {"nheads": 8, "causal": False}}}}
    m["eos"] = {"num_layers": 1, "layer": {
        "hidden_dim": 1024, "activation": {"identifier": "GELU"},
        "norm": {"identifier": "LayerNorm", "eps": 1e-6}}}
    utt = shipped["utterance_encoder"]
    m["spkr"] = {"embedding_dim": 512, "num_layers": utt["num_layers"],
                 "init_channel": utt["init_channel"],
                 "out_channels": list(utt["out_channels"]),
                 "hidden_channels": [4 * c for c in utt["out_channels"]],
                 "resample_rates": list(utt["resample_rates"]),
                 "resample_ksize": list(utt["resample_ksize"]),
                 "layer": copy.deepcopy(shipped["encoder"]["layer"])}
    return m


def tts_data(metadata: str, corpus: str, shuffle: bool, b: int = 8) -> dict:
    """The TTS data settings: character symbols, texts padded to 256
    symbols, mels post-padded to 12.8 s (640 frames), a 2-3 s speaker
    crop, batch ``b``."""
    return {"path": metadata, "wavdir": corpus, "sample_rate": 16000,
            "with_text": True, "delimiter": " ", "batch_size": b,
            "num_workers": 4, "pad_text": {"length": 256},
            "post_pad": {"text": {"length": 256}, "mel": {"length": 12.8}},
            "random_crop_mel": {"min_seg_sec": 2.0, "max_seg_sec": 3.0},
            "sampler": {"type": "standard", "shuffle": shuffle}}


def tts_config(voc: str, corpus: str, log_dir: str) -> dict:
    """The LVTTS training config: ``tts_model_config`` and the shipped
    training block (AdamW, accumulation 2, the mel rescale), 16-mixed, B 8
    on ``corpus``'s ``text.txt``; validation on one batch of it, no audio
    samples."""
    import copy

    import yaml

    with open(TRAIN_YAML) as f:
        shipped = yaml.safe_load(f)
    meta = os.path.join(corpus, "text.txt")
    return {
        "trainer": {"identifier": "trainers.tts.lvtts.LVTTSTrainer",
                    "total_steps": shipped["trainer"]["total_steps"],
                    "precision": "16-mixed", "distributed": False,
                    "limit_val_batches": 1, "val_check_interval": None},
        "logging": {"log_dir": log_dir, "num_samples": 0, "temperature": 1.0,
                    "max_sample_length": TTS_MAX_S,
                    "min_sample_length": TTS_MIN_S, "plot_attn": False},
        "vocoder": {"path": voc},
        "model": tts_model_config(),
        "training": copy.deepcopy(shipped["training"]),
        "data": {"train": tts_data(meta, corpus, True),
                 "val": tts_data(meta, corpus, False)}}


def write_tts_corpus(root: str, n: int, seed: int) -> float:
    """``n`` WAVs of 12 s (the training corpus writer; one length, so that
    the micro-batches' audio rows stack) and a ``text.txt`` of
    ``name|-|text`` lines: 60-180 random characters of ``TTS_CHARS``
    (``_`` for a space), space-delimited.  Returns the seconds of
    audio."""
    import numpy as np

    audio_s = write_train_corpus(root, None, n, 12.0, 12.0, seed)
    rng = np.random.RandomState(seed + 1)
    lines = []
    with open(os.path.join(root, "tokens.txt")) as f:
        for line in f:
            name = line.strip().split("|", 1)[0]
            text = " ".join(rng.choice(list(TTS_CHARS),
                                       size=rng.randint(60, 181)))
            lines.append(f"{name}|-|{text}")
    with open(os.path.join(root, "text.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return audio_s


def tts_small_config() -> dict:
    """The LVTTS of the JAX trainer test (``tests/test_trainers.py::
    _tts_hp``: latent 4, a 1-layer d16 text encoder, the eos head, the
    speaker encoder, the bottleneck encoder and denoiser), its trunk
    widened to d128 with 4 heads of 32 (the flash kernels take head widths
    32, 64 and 128, and K3 packs heads into 128 columns)."""
    inorm = {"identifier": "InstanceNorm", "eps": 1e-6}
    rms = {"identifier": "RMSNorm", "eps": 1e-6}

    def bottleneck(rates, ksize, causal=True):
        return {"num_layers": 1, "resample_rates": rates,
                "resample_ksize": ksize, "init_channel": 16,
                "out_channels": [16], "hidden_channels": [32],
                "layer": {"kernel_size": 3, "causal_padding": causal,
                          "norm": inorm,
                          "activation": {"identifier": "ReLU"}}}

    enc = dict(bottleneck([1], [1]), identifier="BottleNeckResNet",
               final_norm=True)
    unet = dict(bottleneck([1], [1]), condition_dim=8, conditional=[True],
                final_norm=True)
    unet["layer"] = dict(unet["layer"], condition_type="concat",
                         activation={"identifier": "SiLU"})
    return {
        "latent_dim": 4,
        "text": {"embedding_dim": 8, "encoder": {
            "bias": False, "num_layers": 1,
            "rpe": {"identifier": "ALiBi", "maxpos": 64},
            "layer": {"ffd_size": 32, "dim": 16, "norm": rms,
                      "activation": {"identifier": "GELU"},
                      "self_attn": {"nheads": 4, "causal": False}}}},
        "eos": {"num_layers": 1, "layer": {
            "hidden_dim": 16, "activation": {"identifier": "GELU"},
            "norm": {"identifier": "LayerNorm", "eps": 1e-6}}},
        "spkr": dict(bottleneck([-2], [4], causal=False), embedding_dim=8),
        "encoder": enc,
        "decoder": {"diffusion": {
            "timesteps": 8, "sampling_timesteps": 3, "loss_type": "l1",
            "input_scale": 5.0, "objective": "pred_noise",
            "ddim_sampling_eta": 0.0, "clamp_range": [-3.0, 1.2],
            "beta_schedule": {"identifier": "cosine"},
            "identifier": "ConditionalBottleNeckUNet"},
            "cond_unet": {"unet": unet, "time_embedding": {
                "dim": 16, "maxpos": 8,
                "activation": {"identifier": "SiLU"}}}},
        "transformer": {
            "bias": False, "rpe": {"identifier": "ALiBi", "maxpos": 64},
            "num_layers": 1,
            "layer": {"ffd_size": 256, "dim": 128, "norm": rms,
                      "activation": {"identifier": "GELU"},
                      "self_attn": {"nheads": 4, "causal": True},
                      "cross_attn": {"nheads": 4}}}}


def _tts_inputs(rng, b: int, t: int, tt: int, ts: int, n_mels: int,
                num_symbols: int, dev):
    """(mel, text, speaker crop) ``Masked`` of random values on ``dev``,
    ragged lengths."""
    import torch

    from vae_gslm_tpu_torch.core.masked import Masked

    def masked(x, lengths):
        return Masked.from_lengths(torch.from_numpy(x).to(dev), lengths)

    mel = masked(rng.randn(b, t, n_mels).astype("float32"),
                 [t] + [t * 2 // 3] * (b - 1))
    text = masked(rng.randint(2, num_symbols, (b, tt)).astype("int64"),
                  [tt] + [tt // 2] * (b - 1))
    spkr = masked(rng.randn(b, ts, n_mels).astype("float32"),
                  [ts] + [ts * 3 // 4] * (b - 1))
    return mel, text, spkr


def tts_route_pair(sampler, text, spkr, generator_seed: int, steps: int,
                   min_frames: int, dev):
    """The stacked and the per-layer route of ``sampler`` on the same
    inputs and seed at temperature 0 (the deterministic protocol: the
    initial state is the first draw of each run's generator, the prior
    sample its mean): their outputs."""
    import torch

    kw = dict(max_frames=steps, min_frames=min_frames, temperature=0.0,
              eos_threshold=0.5)
    b = text.value.shape[0]
    if sampler.route(b) != "stacked":
        raise AssertionError(f"B = {b} takes the {sampler.route(b)} route")
    stacked = sampler(text, spkr, torch.Generator(dev).manual_seed(
        generator_seed), **kw)
    sampler.route = lambda batch, return_attn=False: "per_layer"
    try:
        per_layer = sampler(text, spkr, torch.Generator(dev).manual_seed(
            generator_seed), **kw)
    finally:
        del sampler.route
    return stacked, per_layer


def check_maps(where: str, out, text_lengths) -> float:
    """Every row of the returned maps sums to 1 (within the bfloat16
    rounding of each step's row; the text encoder's float32); returns the
    largest deviation."""
    import torch

    worst = 0.0
    for name, tol in (("self_attn", 2e-2), ("cross_attn", 2e-2),
                      ("text_self_attn", 1e-5)):
        rows = out[name].sum(-1)
        if name == "text_self_attn":
            valid = (torch.arange(rows.shape[-1], device=rows.device)
                     < text_lengths[:, None])[:, None, None]
            rows = torch.where(valid, rows, torch.ones_like(rows))
        dev_ = (rows - 1).abs().max().item()
        worst = max(worst, dev_)
        if not math.isfinite(dev_) or dev_ > tol:
            raise AssertionError(f"{where}: {name} rows sum to 1 within "
                                 f"{dev_:.3e}, not {tol}")
    return worst


def phase_tts_small(dev) -> None:
    """The small LVTTS (``tts_small_config``) on the card and on the CPU
    from the same weights, inputs and draws, float32 with TF32 off: the
    forward's loss terms (rec, KLD, EOS BCE) within 1e-4 relative and one
    backward's every gradient within 1e-3 x its max |g| (the trunk's
    self-attention through K3/K3b on the card, its plain versions on the
    CPU; the text encoder and the cross-attention dense on both); then on
    the card ``ARTRTTSSampler``'s stacked route against its per-layer
    route under the deterministic protocol (lengths equal, frames within
    rtol 1e-4 / atol 1e-5), again with the eos head's output bias raised
    so that every row ends at its first step past ``min_frames`` (the
    frames after it zero), and the ``return_attn`` maps summing to 1."""
    import numpy as np
    import torch

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.losses import eos_loss, masked_loss
    from vae_gslm_tpu_torch.data.symbols import Symbols
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.tts.sampler import ARTRTTSSampler
    from vae_gslm_tpu_torch.models.tts.lvtr import LVTTS

    symbols = Symbols(set(TTS_CHARS), " ")
    hp = Hparams.from_dict(tts_small_config())
    b, t = 3, TTS_SMALL_T
    with precision.policy_scope(precision.Policy()):
        cpu = LVTTS(hp, symbols, input_dim=80, device="cpu",
                    generator=torch.Generator().manual_seed(3))
        card = LVTTS(hp, symbols, input_dim=80, device=dev)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.RandomState(4)
        inputs = _tts_inputs(rng, b, t, 12, 24, 80, symbols.num_symbols,
                             "cpu")
        draws = {"posterior": rng.randn(b, t, 4), "prior": rng.randn(b, t, 4),
                 "initial": rng.uniform(-1, 1, (b, 1, 4)),
                 "t": rng.randint(0, 8, (b,)), "noise": rng.randn(b, t, 80)}
        draws = {k: torch.from_numpy(np.asarray(
            v, np.int64 if k == "t" else np.float32)) for k, v in
            draws.items()}

        def loss_terms(model, where):
            moved = [type(x)(x.value.to(where), x.lengths.to(where),
                             x.time_axis) for x in inputs]
            out = model(moved[0], None, text=moved[1], spkr=moved[2],
                        draws={k: v.to(where) for k, v in draws.items()})
            terms = [out["rec_loss"], masked_loss(
                out["log_q"], out["log_p"], fn=lambda x, y: x - y),
                eos_loss(out["eos"])]
            sum(terms).backward()
            return [float(x.detach()) for x in terms]

        want = loss_terms(cpu, "cpu")
        zero_kernel_counts()
        got = loss_terms(card, dev)
        torch.cuda.synchronize()
        nl = len(card.transformer.layers)
        expect_counts("tts_small step", {"flash_forward_packed": nl,
                                         "flash_backward_packed": nl})
        worst_m = max(abs(g - w) / max(abs(w), 1e-12)
                      for g, w in zip(got, want))
        if not worst_m <= 1e-4:
            raise AssertionError(f"tts_small: loss terms {got} against the "
                                 f"CPU's {want}")
        worst_g = 0.0
        for (name, pg), pc in zip(card.named_parameters(), cpu.parameters()):
            if pc.grad is None:
                if pg.grad is not None and bool(pg.grad.any()):
                    raise AssertionError(f"tts_small: {name} has a card "
                                         "gradient and no CPU gradient")
                continue
            gg, gc_ = pg.grad.double().cpu(), pc.grad.double()
            err = (gg - gc_).abs().max().item()
            scale = gc_.abs().max().item()
            if not err <= 1e-3 * scale + 1e-30:
                raise AssertionError(f"tts_small: gradient of {name} differs "
                                     f"by {err:.3e} (max |g| {scale:.3e})")
            worst_g = max(worst_g, err / max(scale, 1e-30))
        # the sampler's routes on the card
        card.zero_grad(set_to_none=True)
        _, text, spkr = _tts_inputs(np.random.RandomState(5), 2, t, 12, 24,
                                    80, symbols.num_symbols, dev)
        sampler = ARTRTTSSampler(card, device=dev)
        zero_kernel_counts()
        a, p = tts_route_pair(sampler, text, spkr, 7, 30, 3, dev)
        expect_counts("tts_small sampling", {})
        la, lp = a["lengths"].cpu(), p["lengths"].cpu()
        fa_, fp = a["frames"].value.cpu(), p["frames"].value.cpu()
        if not torch.equal(la, lp) or not torch.allclose(
                fa_, fp, rtol=1e-4, atol=1e-5):
            raise AssertionError(
                f"tts_small: stacked route lengths {la.tolist()}, per-layer "
                f"{lp.tolist()}, frames max |diff| "
                f"{(fa_ - fp).abs().max().item():.3e}")
        # the eos head's output bias raised: every row ends at its first
        # step past min_frames on both routes, its frames zero after it
        bias = card.eos_head.out_linear.bias
        saved_bias = bias.detach().clone()
        with torch.no_grad():
            bias.fill_(30.0)
        a, p = tts_route_pair(sampler, text, spkr, 7, 30, 3, dev)
        with torch.no_grad():
            bias.copy_(saved_bias)
        le, fe = a["lengths"].cpu(), a["frames"].value.cpu()
        if (le.tolist() != [4, 4] or not torch.equal(le, p["lengths"].cpu())
                or fe[:, 4:].any() or not torch.allclose(
                    fe, p["frames"].value.cpu(), rtol=1e-4, atol=1e-5)):
            raise AssertionError(
                f"tts_small: with every row ending, lengths {le.tolist()} "
                f"and {p['lengths'].tolist()}, frames past them nonzero or "
                "apart")
        maps = sampler(text, spkr, torch.Generator(dev).manual_seed(7),
                       max_frames=30, min_frames=3, temperature=0.0,
                       return_attn=True)
        map_err = check_maps("tts_small", maps, text.lengths)
    log(f"tts_small (LVTTS of the JAX test's sizes, trunk d128 with 4 "
        f"heads of 32; card against CPU, float32): loss terms max rel err "
        f"{worst_m:.2e}, gradients max err {worst_g:.2e} x max|g|, K3/K3b "
        f"{nl}/{nl}; the stacked route against the per-layer route over 30 "
        f"steps: lengths {la.tolist()} both, frames max |diff| "
        f"{(fa_ - fp).abs().max().item():.2e}; with the eos bias raised "
        f"lengths {le.tolist()} both; return_attn rows sum to 1 "
        f"within {map_err:.2e}")


def phase_tts_fit(dev, gpu: str, root: str):
    """``scripts/train.py`` -> ``LVTTSTrainer.fit`` on ``tts_config`` at
    full width and depth (the 16-layer d1024 trunk with cross-attention,
    16-mixed, AdamW, accumulation 2, B 8) for ``TTS_STEPS`` optimizer
    steps (a warm-up and three timed) over ``TTS_UTTERANCES`` synthetic
    12 s WAVs with character texts (seed 9) and the seed-1 HiFi-GAN
    saved under ``root``; each step's kernel counts set to 0 just before
    ``run_step`` and read just after (exactly 32 K3 and 32 K3b launches: 16
    causal trunk layers x 2 micro-batches; the text encoder and the
    cross-attention dense, no other kernel; the plain flash versions
    refused), and the rest of the CLI after the last step counted too
    (the final validation batch: exactly 16 K3, nothing else); the fit's
    launches are the steps' and the validation's summed; one more step
    under torch.profiler, its K3 and K3b kernels
    counted; then the compact checkpoint that ``fit`` saved, with
    ``hp.yaml`` and ``symbols.json``, resumed by a fresh trainer (seed 5):
    its parameters equal the fitted trainer's.  Logs ms a step, the
    parameter count and peak memory.  Returns (K3, K3b launches of the
    fit, the run's checkpoint directory, the corpus)."""
    import torch
    import yaml

    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.models.vocoder.vocoder import HiFiGAN
    from vae_gslm_tpu_torch.scripts import train as train_cli
    from vae_gslm_tpu_torch.trainers.tts.lvtts import LVTTSTrainer

    voc, corpus = os.path.join(root, "voc"), os.path.join(root, "corpus")
    os.makedirs(corpus)
    HiFiGAN(Hparams.from_yamlfile(VOCODER_YAML), device=dev,
            generator=torch.Generator(dev).manual_seed(1)
            ).save_pretrained(voc)
    audio_s = write_tts_corpus(corpus, TTS_UTTERANCES, seed=9)
    cfg = tts_config(voc, corpus, os.path.join(root, "logs"))
    config = os.path.join(root, "tts.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    accum = cfg["training"]["gradient_accumulation"]
    nl = cfg["model"]["transformer"]["num_layers"]
    want = nl * accum
    run_step = LVTTSTrainer.run_step
    steps, trainers, last = [], [], []
    fit_counts = {"flash_forward_packed": 0, "flash_backward_packed": 0}

    def timed(self, stacked):
        # nothing launched since the CLI started or the last step ended
        expect_counts(f"tts before step {len(steps)}", {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step(self, stacked)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        expect_counts(f"tts step {len(steps) - 1}", {
            "flash_forward_packed": want, "flash_backward_packed": want})
        for k in fit_counts:
            fit_counts[k] += want
        zero_kernel_counts()
        terms = {k: float(out[k]) for k in ("rec_loss", "kld", "eos_loss")}
        if not all(math.isfinite(x) for x in terms.values()):
            raise AssertionError(f"tts: non-finite metrics {terms}")
        if self not in trainers:
            trainers.append(self)
        last[:] = [stacked]
        log(f"tts step {len(steps) - 1}"
            f"{' (warm-up)' if len(steps) == 1 else ''}: "
            f"{steps[-1] * 1e3:.1f} ms; K3 {want}, K3b {want}; " + ", ".join(
                f"{k} {x:.4f}" for k, x in terms.items()))
        return out

    undo = _refuse_plain("tts_fit", dense=False)
    LVTTSTrainer.run_step = timed
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        t0 = time.perf_counter()
        train_cli.main(["-c", config, "--max_steps", str(TTS_STEPS),
                        "-n", "run"])
        wall = time.perf_counter() - t0
        # the CLI after the last step: the final validation batch's
        expect_counts("tts fit (after the last step)", {
            "flash_forward_packed": nl})
        fit_counts["flash_forward_packed"] += nl
    finally:
        LVTTSTrainer.run_step = run_step
        undo()
    peak = torch.cuda.max_memory_allocated()
    if len(steps) != TTS_STEPS or len(trainers) != 1:
        raise AssertionError(f"tts: {len(steps)} steps by {len(trainers)} "
                             "trainers")
    trainer = trainers[0]
    ckpt = os.path.join(root, "logs", "run", "ckpt", "version_0")
    missing = {"last-cpt.npz", "hp.yaml", "symbols.json"} - set(
        os.listdir(ckpt))
    if missing:
        raise AssertionError(f"tts: the checkpoint directory lacks {missing}")
    again = LVTTSTrainer(Hparams.from_dict(cfg), seed=5, device=dev)
    again.resume(os.path.join(ckpt, "last-cpt.npz"))
    saved = dict(zip(trainer.names, [p.detach().clone()
                                     for p in trainer.params]))
    for name, p in zip(again.names, again.params):
        if not torch.equal(p, saved[name]):
            raise AssertionError(f"tts: {name} resumed from the compact "
                                 "checkpoint differs")
    del again, saved
    batch = trainer.prepare_batch(last[0])
    ev = _profiled(lambda i: trainer.run_step(batch), 1,
                   only=("k3_fwd", "k3b_dq", "k3b_dkv"))
    prof = {_kernel_name(k): c for k, _, c in ev}
    nparams = sum(p.numel() for p in trainer.params)
    med = statistics.median(steps[1:])
    frames = 8 * accum * 640
    log(f"tts fit (scripts/train.py -> LVTTSTrainer.fit, LVTTS "
        f"{nparams / 1e6:.1f} M parameters, {nl} x d1024 trunk with "
        f"cross-attention, B=8 x accumulation {accum} x 640 frames, "
        f"16-mixed; {TTS_UTTERANCES} WAVs, {audio_s:.0f} s of audio): median "
        f"step {med * 1e3:.1f} ms over {len(steps) - 1} steps after a "
        f"warm-up (range {min(steps[1:]) * 1e3:.1f}-"
        f"{max(steps[1:]) * 1e3:.1f}), {frames / med:.0f} frames/s; the "
        f"whole CLI {wall:.1f} s; peak memory {peak / 2 ** 30:.2f} GiB; K3/"
        f"K3b per step {want}/{want}, in the whole fit "
        f"{fit_counts['flash_forward_packed']}/"
        f"{fit_counts['flash_backward_packed']} ({TTS_STEPS} steps and "
        f"the validation's {nl} K3); one "
        f"profiled step's kernels {prof}; the compact checkpoint with "
        f"symbols.json resumed by a fresh trainer, equal ({gpu})")
    del trainer, trainers, batch, last
    gc.collect()
    return (fit_counts["flash_forward_packed"],
            fit_counts["flash_backward_packed"], ckpt, corpus)


def phase_tts_serve(dev, gpu: str, root: str, ckpt: str,
                    corpus: str) -> None:
    """Text-to-speech serving at full width on ``phase_tts_fit``'s
    checkpoint: ``scripts/infer.py -v 0`` -> ``TTSInferer.run`` on the
    first ``TTS_SERVE_B`` utterances of the corpus at B 8 (16-mixed,
    ``max_sample_length`` 10 s, ``min_sample_length`` 1 s, temperature
    1.0, ``eos_threshold`` 0.5, DDIM-100 at eta 0.5 as
    ``configs/infer/speech/vae-gslm.yaml``), the stacked route, no K1-K7
    launch; 8 finite ``N.wav``, ``N_c.wav`` and ``N.txt``.  Then on the
    same checkpoint and batch: the per-layer route with ``return_attn``
    over ``TTS_ROUTE_STEPS`` steps (its rows summing to 1), and the two
    routes against each other over ``TTS_ROUTE_STEPS`` steps under the
    deterministic protocol, at 16-mixed (the band reported) and float32
    (lengths equal, frames within rtol 1e-3 / atol 1e-4).  Logs ms per AR
    step, the steps run and the real-time factor of each."""
    import numpy as np
    import torch
    import yaml

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.core.masked import Masked
    from vae_gslm_tpu_torch.data import audio
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.tts.inferer import TTSInferer
    from vae_gslm_tpu_torch.inference.tts.sampler import ARTRTTSSampler
    from vae_gslm_tpu_torch.scripts import infer as infer_cli

    with open(os.path.join(corpus, "text.txt")) as f:
        lines = f.read().splitlines()[:TTS_SERVE_B]
    meta = os.path.join(root, "serve.txt")
    with open(meta, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(INFER_YAML) as f:
        shipped = yaml.safe_load(f)
    out_dir = os.path.join(root, "tts_out")
    cfg = {"identifier": "inference.tts.inferer.TTSInferer",
           "exp_dir": os.path.dirname(os.path.dirname(ckpt)),
           "output_dir": out_dir,
           "model": {"identifier": "models.tts.lvtr.LVTTS"},
           "precision": shipped["precision"],
           "max_sample_length": TTS_MAX_S, "min_sample_length": TTS_MIN_S,
           "temperature": 1.0, "eos_threshold": 0.5,
           "diffusion": shipped["diffusion"],
           "data": tts_data(meta, corpus, False, TTS_SERVE_B),
           "trainer": {"distributed": False}}
    config = os.path.join(root, "tts_infer.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    routes = []
    call = ARTRTTSSampler.__call__

    def spy(self, text, spkr, *a, **kw):
        routes.append(self.route(text.value.shape[0],
                                 kw.get("return_attn", False)))
        return call(self, text, spkr, *a, **kw)

    timings = {}
    ARTRTTSSampler.__call__ = spy
    try:
        zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = infer_cli.main(["-c", config, "-v", "0", "--max_batches", "1"],
                           timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts("tts serving (scripts/infer.py)", {})
    finally:
        ARTRTTSSampler.__call__ = call
    if routes != ["stacked"] or n != TTS_SERVE_B:
        raise AssertionError(f"tts serving: routes {routes}, {n} rows")
    gen = 0
    for i in range(1, n + 1):
        for name in (f"{i}.wav", f"{i}_c.wav"):
            wave, sr = audio.load_audio(os.path.join(out_dir, name))
            if sr != 16000 or not 0 < len(wave) <= TTS_MAX_S * 16000 * 1.3 \
                    or not np.isfinite(wave).all():
                raise AssertionError(f"tts serving {name}: {len(wave)} "
                                     f"samples at {sr} Hz")
            if name.endswith("_c.wav"):
                continue
            gen += len(wave) / 16000.0
        with open(os.path.join(out_dir, f"{i}.txt")) as f:
            if not f.read():
                raise AssertionError(f"tts serving {i}.txt is empty")
    ar_steps = int(timings["ar_steps"])
    log(f"tts serving (scripts/infer.py -> TTSInferer.run, B={n}, stacked "
        f"route, 16-mixed, DDIM-{shipped['diffusion']['sampling_timesteps']}"
        f"): {ar_steps} AR steps run (at most {int(TTS_MAX_S * 50)}); "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()
                    if k != "ar_steps")
        + f"; {timings['ar_loop'] / ar_steps * 1e3:.2f} ms per AR step; "
        f"{gen:.1f} s of speech in {wall:.2f} s of main, real-time factor "
        f"{gen / wall:.2f}x ({gen / sum(v for k, v in timings.items() if k != 'ar_steps'):.2f}x "
        f"over the timed stages); no K1-K7 launch ({gpu})")
    # the routes on the checkpoint and the same batch
    inf = TTSInferer(Hparams.from_dict(dict(cfg, ckpt_path=ckpt)),
                     device=dev)
    batch = next(iter(inf.test_dataloader()))
    text, spkr = inf._rows(batch, "text"), inf._rows(batch, "cropped_mel")
    sampler = inf.sampler
    zero_kernel_counts()
    with precision.policy_scope(precision.bf16_mixed()):
        sampler(text, spkr, torch.Generator(dev).manual_seed(3),
                max_frames=8, return_attn=True)             # warm-up
        t_pl = {}
        out = sampler(text, spkr, torch.Generator(dev).manual_seed(3),
                      max_frames=TTS_ROUTE_STEPS, min_frames=1,
                      temperature=1.0, return_attn=True, timings=t_pl)
        map_err = check_maps("tts serving", out, text.lengths)
    log(f"tts serving per-layer route (return_attn, B={n}, "
        f"{TTS_ROUTE_STEPS} steps, 16-mixed): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in t_pl.items() if k != "ar_steps")
        + f"; {t_pl['ar_loop'] / t_pl['ar_steps'] * 1e3:.2f} ms per AR "
        f"step; maps (B, L, H, Q, KV) {tuple(out['self_attn'].shape)}, "
        f"cross {tuple(out['cross_attn'].shape)}, text "
        f"{tuple(out['text_self_attn'].shape)}, rows sum to 1 within "
        f"{map_err:.2e} ({gpu})")
    del out
    for policy, name in ((precision.bf16_mixed(), "16-mixed"),
                         (precision.Policy(), "float32")):
        with precision.policy_scope(policy):
            a, p = tts_route_pair(sampler, text, spkr, 11, TTS_ROUTE_STEPS,
                                  1, dev)
        la, lp = a["lengths"].cpu(), p["lengths"].cpu()
        diff = (a["frames"].value - p["frames"].value).abs()
        rel = (diff / (1e-4 + p["frames"].value.abs())).max().item()
        log(f"tts serving routes at full width ({name}, B={n}, "
            f"{TTS_ROUTE_STEPS} steps, temperature 0): lengths stacked "
            f"{la.tolist()}, per-layer {lp.tolist()}; frames max |diff| "
            f"{diff.max().item():.3e}, max |diff| / (1e-4 + |frame|) "
            f"{rel:.3e} ({gpu})")
        if name == "float32" and (not torch.equal(la, lp) or not
                                  torch.allclose(a["frames"].value,
                                                 p["frames"].value,
                                                 rtol=1e-3, atol=1e-4)):
            raise AssertionError("tts serving: the stacked and the "
                                 "per-layer routes disagree at float32")
    expect_counts("tts serving routes", {})
    del inf, sampler, a, p, batch
    gc.collect()


def phase_reconstruction(dev, gpu: str, ckpt: str, root: str) -> None:
    """Resynthesis evaluation (``ReconstructionEvaluator.run``, tasks
    ``f0mse`` and ``mcd``) on the flagship checkpoint (with tokens and the
    utterance encoder, float32, TF32 off) over ``RECON_UTTERANCES``
    synthetic WAVs of 2-3 s from the scoring corpus's writer (seed 4; the
    scoring corpus's 192 utterances of 5-35 s would take the numpy
    metrics most of an hour), at batch 8 with the infer config's DDIM
    settings: no K1-K7 launch (the encoder, the diffusion decoder and the
    vocoder are convolutions); the scores finite.  Logs utterances/s with
    the model's and the metrics' seconds."""
    import numpy as np
    import yaml

    from vae_gslm_tpu_torch.core import precision
    from vae_gslm_tpu_torch.hparams.hp import Hparams
    from vae_gslm_tpu_torch.inference.speech.reconstruction import \
        ReconstructionEvaluator

    corpus = os.path.join(root, "recon_corpus")
    os.makedirs(corpus)
    rng = np.random.RandomState(4)
    audio_s = write_wav_corpus(corpus, rng.randint(100, 151,
                                                   RECON_UTTERANCES), rng)
    cfg = yaml.safe_load(SCORE_INFER_YAML.format(ckpt=ckpt, corpus=corpus))
    with open(INFER_YAML) as f:
        diffusion = yaml.safe_load(f)["diffusion"]
    cfg.update(identifier="inference.speech.reconstruction."
               "ReconstructionEvaluator", tasks=["f0mse", "mcd"],
               diffusion=diffusion)
    cfg["data"].update(batch_size=RECON_UTTERANCES, min_audio_length=1.0,
                       num_workers=2)
    with precision.policy_scope(precision.Policy()):
        ev = ReconstructionEvaluator(Hparams.from_dict(cfg), device=dev)
        zero_kernel_counts()
        timings = {}
        t0 = time.perf_counter()
        scores = ev.run(seed=0, timings=timings)
        wall = time.perf_counter() - t0
    expect_counts("reconstruction", {})
    if "mcd" not in scores or not all(math.isfinite(v)
                                      for v in scores.values()):
        raise AssertionError(f"reconstruction: scores {scores}")
    n = timings["utterances"]
    if n != RECON_UTTERANCES:
        raise AssertionError(f"reconstruction scored {n} utterances")
    log(f"reconstruction (ReconstructionEvaluator.run on the flagship "
        f"checkpoint, float32, DDIM-{diffusion['sampling_timesteps']}, "
        f"{n} utterances, {audio_s:.1f} s of audio): {n / wall:.2f} "
        f"utterances/s over {wall:.2f} s (model {timings['model']:.2f} s, "
        f"the numpy metrics {timings['score']:.2f} s on the host); scores "
        + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
        + f"; no K1-K7 launch ({gpu})")


def main() -> int:
    # keep CUPTI set up between profiler windows (torch's own workaround
    # for its re-initialisation, which has left windows with no kernel)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2])
    sys.path.insert(0, ROOT)
    import vae_gslm_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    gpu = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"device: {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for float32 matmul and cuDNN")

    from concurrent.futures import ThreadPoolExecutor

    from vae_gslm_tpu_torch.data import native
    from vae_gslm_tpu_torch.ops import build
    names = ("fused_decode", "mega_step", "flash_attention", "flash_decode",
             "stream")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:   # one nvcc per source
        jobs = [pool.submit(build.load, n) for n in names]
        jobs.append(pool.submit(native.get_lib))   # g++ of native/dataio.cc
        for job in jobs:
            job.result()
    log(f"build: {', '.join(n + '.cu' for n in names)} (K1, K2, "
        f"K3/K3b/K4/K4b/K5/K5b, K6, K7) and native/dataio.cc in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (sec, text) in build.BUILD_LOG.items():
        if name in ("flash_attention", "flash_decode", "mega_step"):
            log(f"nvcc {name} ({sec:.1f} s): " + ptxas_summary(text))
            continue
        log(f"nvcc {name} ({sec:.1f} s): "
            + " | ".join(x.strip() for x in text.splitlines()
                         if "registers" in x or "spill" in x))

    spent = []

    def timed(name, fn, *args, **kw):
        """``fn``'s result; its wall seconds go to the closing log line."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        spent.append(f"{name} {time.perf_counter() - t:.1f}")
        return out

    k1 = timed("k1", phase_k1, dev)
    k2, k2bf16 = timed("k2", phase_k2, dev)
    k2w4 = timed("k2_w4", phase_k2_w4, dev)
    # K2 at head widths 128 and 32, early: profiler windows late in a
    # run have recorded no launch, and each branch's one launch is held
    # in a window here
    k2_wide = timed("k2_widths", phase_k2_widths, dev)
    k3, k3b = timed("k3", phase_k3, dev)
    k4_worst, k5, k5bf16 = timed("k45", phase_k45, dev)
    k4, k4b, k5b, bwdf32 = timed("k45b", phase_k45b, dev, k4_worst)
    k6 = timed("k6", phase_k6, dev)
    k7 = timed("k7", phase_k7, dev, gpu)
    timed("small_k1", phase_small, dev, quantize=False)
    timed("small_k2", phase_small, dev, quantize=True)
    timed("small_k2_bf16", phase_small, dev, quantize=True, batch=12)
    timed("small_w4", phase_small, dev, quantize=True, w4=128)
    for per_layer in ("int8", "k6", "float"):
        timed(f"small_{per_layer}", phase_small, dev, quantize=True,
              per_layer=per_layer)
    timed("train_small", phase_train_small, dev)
    timed("likelihood_small", phase_likelihood_small, dev)
    bwdf32["launches"] = timed("dp_small", phase_dp_small, dev)
    k1["launches"] = timed("pipeline_k1", phase_pipeline, dev, gpu,
                           quantize=False)
    k2["launches"] = timed("pipeline_k2", phase_pipeline, dev, gpu,
                           quantize=True)
    k6["launches"] = timed("per_layer", phase_per_layer, dev, gpu)
    k3["launches"], k3b["launches"] = timed("train", phase_train, dev, gpu)
    dp = timed("dp_fit", phase_dp_fit, dev, gpu)
    k4["launches"] = dp["flash_forward_full"]
    k4b["launches"] = dp["flash_backward_full"]
    long_counts = timed("dp_fit_long", phase_dp_fit, dev, gpu, long=True)
    k5bf16["launches"] = long_counts["flash_forward_tiled"]
    k5b["launches"] = long_counts["flash_backward_blockwise"]
    timed("hfgan_small", phase_hfgan_small, dev)
    timed("hfgan_fit", phase_hfgan_fit, dev, gpu)
    opt = timed("lvtr_options", phase_lvtr_options, dev, gpu)
    timed("lvtr_options_small", phase_lvtr_options_small, dev)
    k3["launches"] += opt["flash_forward_packed"]
    k3b["launches"] += opt["flash_backward_packed"]
    k6["launches"] += opt["flash_decode_int8"]
    import shutil
    import tempfile

    flagship = tempfile.mkdtemp(prefix="flagship_")
    try:
        ckpt, _ = timed("flagship", write_flagship, flagship, dev)
        k5["launches"] = (timed("score", phase_score, dev, gpu, ckpt)
                          + opt["flash_forward_tiled"])
        config = write_cli_corpus(flagship)
        k2bf16["launches"] = timed("cli_k2", phase_cli, dev, gpu, config,
                                   w4=False)
        k2w4["launches"] = timed("cli_w4", phase_cli, dev, gpu, config,
                                 w4=True)
        # the per-layer CLI run on a CUT_L-layer copy of the checkpoint
        cut = os.path.join(flagship, "cut")
        timed("flagship_cut", write_flagship, cut, dev, layers=CUT_L)
        timed("cli_per_layer", phase_cli, dev, gpu,
              write_cli_corpus(cut, n=PL_B), n_wavs=PL_B)
        timed("reconstruction", phase_reconstruction, dev, gpu, ckpt,
              flagship)
    finally:
        shutil.rmtree(flagship, ignore_errors=True)
    # the token-LM baseline (slice 16) and K5 past 8192 keys
    k5_long_launches = timed("k5_long", phase_k5_long, dev, gpu)
    timed("discrete_small", phase_discrete_small, dev)
    lm_root = tempfile.mkdtemp(prefix="token_lm_")
    try:
        paths = timed("token_lm_dirs", token_lm_dirs, lm_root, dev)
        lm_k3, lm_k3b = timed("discrete_train", phase_discrete_train, dev,
                              gpu, paths)
        timed("hubert_decoder_fit", phase_hubert_decoder_fit, dev, gpu,
              paths)
        k1["launches"] += timed("discrete_serve", phase_discrete_serve, dev,
                                gpu, paths)
        score_k3, score_k5 = timed("discrete_score", phase_discrete_score,
                                   dev, gpu, paths)
    finally:
        shutil.rmtree(lm_root, ignore_errors=True)
    k3["launches"] += lm_k3 + score_k3
    k3b["launches"] += lm_k3b
    k5["launches"] += score_k5 + k5_long_launches
    # head widths 32 and 128: the templated bodies against
    # their plain versions, then the 8 x 128 and 32 x 32 trunks' paths
    widths = timed("head_widths", phase_head_widths, dev, gpu)
    wide = []
    for nheads in (8, 32):
        entries, k1_wide, k2_runs = timed(f"wide_heads_{nheads}",
                                          phase_wide_heads, dev, gpu, nheads,
                                          widths)
        wide += entries
        k1["launches"] += k1_wide
        for branch, n in k2_runs.items():
            k2_wide[(branch, H * D // nheads)]["launches"] = n
    wide += list(k2_wide.values())
    # SoundStream (Queue 1 item 7): no kernel on its path
    ss_root = tempfile.mkdtemp(prefix="soundstream_")
    try:
        timed("soundstream", phase_soundstream, dev, gpu, ss_root)
    finally:
        shutil.rmtree(ss_root, ignore_errors=True)
    # text-to-speech (Queue 1 item 8): K3/K3b on the training path
    timed("tts_small", phase_tts_small, dev)
    tts_root = tempfile.mkdtemp(prefix="tts_")
    try:
        tts_k3, tts_k3b, tts_ckpt, tts_corpus = timed(
            "tts_fit", phase_tts_fit, dev, gpu, tts_root)
        timed("tts_serve", phase_tts_serve, dev, gpu, tts_root, tts_ckpt,
              tts_corpus)
    finally:
        shutil.rmtree(tts_root, ignore_errors=True)
    k3["launches"] += tts_k3
    k3b["launches"] += tts_k3b
    log("phase seconds: " + ", ".join(spent))
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": mark_event_times(
        [k1, k2, k2bf16, k2w4, k3, k3b, k4, k4b, k5, k5bf16, k5b, bwdf32, k6,
         k7] + wide)}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
