#!/usr/bin/env python3
"""Drive the PyTorch port's JiT-B/16 class-to-image sampler and training step,
its text-conditioned JiT sampler over the Qwen3-VL-2B text tower, its
on-disk image feed (C loader, worker pool) into the training step, its
perceptual and shortcut losses,
its JiT variant trainers (U-JiT, Cross-JiT, IG, LoIG, TREAD) and the x-loss
config, its latent-cache tool and latent JiT 1024^2 trainer, its SDXL 1024^2
text-to-image sampler (bf16 and NF4), LoRA / QLoRA and flow-match trainers,
its IP-Adapter and PFG (prompt-free) trainers and samplers over CLIP and
timm vision towers, its RoPE-distillation, DRaFT+ and style-tokenizer
trainers, its optax optimizers and int8 training linears, its
CogView4-6B 1024^2 sampler (bf16, NF4, int8, layer-group offload), its ``short`` attention
backend and its two attention probes, and its inference server (NF4 + LoRA
over loopback HTTP, with the quantize and import tools), on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-3 (with nf4_kernel,
                                           # short_kernel, nf4_timing,
                                           # short_timing and tread_timing)
                                           # alone, no result line

Phases, one JSON line each; any failure raises and the script exits non-zero
without a result line:

1. device: the card, its power limit, and the build of every CUDA kernel of
   the paths from the sources in ``vision_pt_tpu_torch/csrc`` (one ``nvcc``
   per source, started together), with the ptxas register and spill report;
2. kernel: each kernel against its plain PyTorch version, on the card, at the
   paths' shapes and at edge shapes (for the attention kernels the edges of
   their key tiles too: S 129, 257, 1025 and 1153, Sq 200 with Sk 320), in
   bf16, fp16 and fp32. Every element
   must lie within tol * (RMS(ref) + |ref|), tol 2e-2 for bf16, 5e-3 for
   fp16 (attention) and 1e-4 for fp32, and the forwards' LSE within 1e-4
   absolute; a kv_len 0 row must be exactly 0, and so must the key-gradient
   rows past kv_len. At the latent shape the same limits must fail the
   kernel's results against a plain version whose kv_len is 64 keys short,
   at its tile edge, or one key short, and in fp16 (and for the packed
   kernels in bf16) one key short. Autograd through
   ``short_attention_packed`` (bf16 and fp16) and ``flash_attention`` must
   give exactly the explicit backward, and two calls of the packed backward
   must give the same bits;
3. timing: each kernel's device ms per launch (``device_timing``: the
   median of 5 windows under torch.profiler, with the fastest and slowest
   window; the plain versions by CUDA events, host time included), its bound on an H100
   SXM from the bytes and operations of these inputs, the plain version's ms,
   and one PyTorch library call that computes the same function, at the
   sampler shape (forward) and the training-step shape (forward, backward)
   of the packed kernels and at the latent trainer's shape (B 16, S 4106) of
   the flash kernels (their plain versions over the same batch in calls of
   2 rows);
4. sampler: ``JiTModel.new_with_config`` at the full width of JiT-B/16, 256^2,
   bf16 compute, answering 3 requests of ``generate`` (batch 8, CFG, 20
   Euler steps); the forward kernel must launch 80 times per request and the
   backward never;
5. train_step: the JAX package's headline training step (``bench_headline``)
   in the port: JiT-B/16, 256^2, batch 64, bf16 compute, fp32 parameters, 32
   unmasked context tokens, AdamW 1e-4; one warm-up and 10 timed steps; 12
   forward and 12 backward kernel launches per step; one profiled step;
6. trainer: the port's entry point (``train.jit.class_to_image.run``) on
   ``configs/jit/synthetic_class_to_image.yml`` widened to JiT-B/16, 256^2,
   batch 64, bf16, 6 steps, with clipping, EMA, a cosine schedule, a
   safetensors save and a 4-step preview; 4 forward and 4 backward launches
   per step (blocks 0-3, before the shipped context_start_block 4),
   ``trainer.deterministic`` (torch's deterministic algorithms, so a second
   run gives the same bits); the saved file must load back through
   ``JiTModel.from_pretrained``; the fourth step runs under the profiler.
   Then the same run with train-state checkpointing, stopped by a SIGTERM
   during step 2 (it must save step 2 and stop), and resumed: steps 3-6
   within 1e-3 of the unbroken run's losses;
6b. mesh_trainer (after inference_server, beside the worker's last CPU
   halves): the trainer phase's config under ``torchrun
   --standalone --nproc_per_node 1 -m vision_pt_tpu_torch.train.jit.class_to_image``
   with ``trainer.mesh`` {data 1, fsdp 1, tensor 1, seq 1},
   ``distributed_init`` and a ``profile_dir`` (steps 1-2): the group must be
   NCCL, every step's loss within 1e-5 relative of the trainer phase's, the
   saved model and EMA files equal to its files, and the chrome trace must
   hold as many launches of #1 and of #2 a profiled step as the trainer
   phase counted a step (4 + 4), and its 4-step preview must be written,
   sampled under the mesh; s/step of both runs as the trainer logs it;
6c. ring (after mesh_trainer): ``ops.ring_attention.ring_attention`` over the seq axis of a
   one-rank NCCL mesh (no point-to-point send runs with one rank) at B 2,
   S 4096, H 16, D 64, bf16, kv_lens (4096, 1000): forward and backward
   against plain attention in fp32 on the same inputs within the bf16 limit,
   the short row's key gradients past kv_len exactly 0; its device ms
   forward and backward beside #7 / #8's on the same inputs;
7. train_parity: one training step's loss and gradients, same weights, batch
   and injected draws, on the card (kernels) and on the CPU (plain versions
   of the same path), batch 2, in fp32, bf16 and fp16 (the fp16 loss scaled
   by 2^12 before the backward: see LOSS_SCALE; fp16 at depth 5, batch 1,
   see FP16_PARITY_DEPTH), through ``tools.bench.step_parity``;
8. parity: the same weights and injected noise through the sampler on the
   card (kernel) and on the CPU (plain versions), batch 1, CFG, 2 steps;
   PSNR at least 50 dB in fp32 (under ``attention_dtype(None)``) and 30 dB
   in bf16;
9. cache_latents (after attention_probes): the port's caching tool (``tools.data.cache_latents.run``)
   on the card over 64 synthetic 1024^2 images with captions of 1-4 of four
   classes, batch 2, the SDXL VAE at full width with random weights from a
   seed, fp32 inputs, an fp16 store, PyTorch's default TF32 switches
   (cuDNN convolutions on; the phase line states them);
   the first image's cached mean and std within 1e-2 relative L2 of the
   same image encoded on the CPU in fp32, a limit that must fail the image
   flipped left-right; no kernel launches (the VAE's attention
   is a plain product);
9b. latent_trainer: the port's latent entry point
   (``train.jit.latent_class_to_image.run``) on
   ``configs/jit/latent_arb_1024.yml`` with every model and dataset field as
   shipped (depth 24, 768 wide, patch 2 over a 128 x 128 x 4 latent, so
   S = 4170 in every block; batch 16, bf16, gradient checkpointing, AdamW
   1e-4) and only its paths rewritten: the 64 latents cache_latents wrote,
   one epoch = 4 steps, ``trainer.deterministic``; exactly 48 flash
   forward, 24 flash backward and no packed launches per step; the last
   step runs under the profiler;
9c. latent_mesh_trainer (started beside mesh_trainer, so the two torchrun
   processes' start-up and load overlap): the latent_trainer phase's config
   under ``torchrun --standalone --nproc_per_node 1`` on the latent entry
   point with ``trainer.mesh`` {data 1, fsdp 1, tensor 1, seq 1},
   ``distributed_init`` and a ``profile_dir`` (steps 1-2): the group must be
   NCCL, the 4 losses and the saved file bit-equal to the latent_trainer
   phase's, the trace 2 x 48 launches of #7 and 2 x 24 of #8; s/step and
   peak memory per rank beside the no-mesh run's, and the seconds it adds
   past mesh_trainer's run;
10. latent_parity: one training step of the latent workload at full width,
   depth cut to 2 (fp16: 1, batch 1), a 64 x 64 latent (S = 1098, still the
   flash path), batch 2, on the card (kernels) and on the CPU (plain versions),
   fp32, bf16 and fp16, against the train_parity floors;
11. sdxl_sampler: SDXL-base at full width (UNet 320/640/1280, context 2048,
   CLIP-L + bigG, the VAE), random weights from a seed, built on the card,
   bf16 compute with fp32 parameters, through the CLI's ``run``
   (``tools.inference_cli``) at 1024^2, batch 1, CFG 5, 5 steps, with the
   word-hash tokenizer: a warm and a timed request in bf16, then again after
   ``quantize_inplace(..., "bnb_nf4")`` with the CLI's keys; exactly 350
   flash launches per request, and 700 of kernel #9 under NF4 (0 without);
   a profiled 2-step request each; the image finite and not constant;
12. sdxl_parity: full widths at reduced depth (layers_per_block 1, one
   transformer per stage), 512^2, bf16, one UNet call and a 2-step CFG
   generate with injected latents and noise, on the card (kernels) and on
   the CPU (plain versions), before and after NF4 quantization; the floors
   must also fail the card's run with kernel #9 given one scale row 25% off,
   or that chunk left out, in every launch;
13. short_path (after train_step): ``dot_product_attention(...,
   backend="short")`` forward and backward at JiT-B/16 width (B 64, S 298,
   12 x 64, bf16, kv_lens in [266, 298] with one row at 0), then
   ``short_attention_bhsd`` on the same tensors transposed; exactly one
   forward and one backward launch of the matching entry per call (#3/#4,
   then #5/#6) and none of any other kernel; a mask or ``is_causal`` must be
   refused;
14. attention_probes (after short_path): the two probe tools' ``main()``
   (``tools.bench.attention_pairing_probe``, ``tools.bench.attention_roofline``,
   the roofline's training step with 5 steps a window), each printing its
   JSON line; #10 and #11 launch exactly as their timing asks;
15. sdxl_lora_trainer (after cogview4_parity): the SDXL entry point
   (``train.sdxl.text_to_image.run``) on ``configs/sdxl/text_to_image_lora.yml`` at full width and depth, 1024^2,
   batch 2, RAdamScheduleFree and per-layer recompute as shipped; cut to
   random weights, the word-hash tokenizer, 2 synthetic images (2 steps) and
   a 2-step preview, each cut listed in the phase line; s/step of step 2,
   peak memory, losses; exactly 140 launches of #7 and 70 of #8 a step;
   a LoRA file of the 700 adapted linears;
16. sdxl_qlora_trainer: the same for ``text_to_image_qlora_nf4.yml`` (AdamW8bit)
   on a random-weight checkpoint whose UNet linears ``quantize_state_dict``
   NF4-prequantized on the card; 280 launches of #9 a step besides; then one
   more step under the profiler;
16b. sdxl_flow_match_trainer: the flow-match entry point
   (``train.sdxl.flow_match.run``) on ``configs/sdxl/flow_match/config.yml``
   at full width and depth, 1024^2, batch 2, velocity prediction, LoRA rank
   8, RAdamScheduleFree and recompute as shipped, its 16-step CFG-4 preview
   as shipped; cut as sdxl_lora_trainer; 140 launches of #7 and 70 of #8 a
   step, 16 x 70 of #7 in the preview, a LoRA file of 2,100 tensors;
16c. sdxl_mesh_trainer (after the SDXL trainers, before inference_server,
   which deletes the NF4 file): the sdxl_lora_trainer and sdxl_qlora_trainer
   configs (both under ``trainer.deterministic``) under ``torchrun
   --standalone --nproc_per_node 1``, the two runs side by side, with
   ``trainer.mesh`` {data 1, fsdp 1}, ``distributed_init`` and a
   ``profile_dir`` (step 1): the group must be NCCL rank 0 of 1, each loss
   within 1e-5 relative of its no-mesh run's, the LoRA file equal to its
   file, and the chrome trace must hold that run's per-step launches of #7,
   #8 and #9 (140 / 70 / 0 and 140 / 70 / 280), and each run must write its
   phase's 2-step preview, sampled under the mesh; s/step and the peak
   memory over the steps of both runs;
16d. sdxl_adapter_mesh_trainer (started beside sdxl_mesh_trainer's two
   runs): ip_adapter_trainer's config (``train.sdxl.ip_adapter_ref`` at full
   width and depth, 1024^2, batch 2, the full-size CLIP tower, both sides
   ``trainer.deterministic``; no preview, as in that phase) the same way:
   NCCL rank 0 of 1, the losses and the adapter file bit for bit,
   140 / 69 / 0 launches of #7 / #8 / #9 in the profiled step, peak memory
   within 1% of the no-mesh run's, and how long it ran past
   sdxl_mesh_trainer's runs;
16e. sdxl_adapter_mesh_reduced (one torchrun process started after
   sdxl_adapter_mesh_trainer, beside cogview4_sampler and inference_server,
   collected after them): PFG, RoPE
   distillation, DRaFT+ (2 sampler steps, the small PickScore), the style
   tokenizer, LoHa over an NF4 base and LoRA under prodigy and under
   adafactor at sdxl_parity's size (512^2, one layer and transformer per
   stage), each run without the mesh and then under {data 1, fsdp 1} in the
   process: losses and files bit for bit, the mesh run's trace the no-mesh
   second step's #7 / #8 / #9 (#9 only over the NF4 base);
17. sdxl_lora_parity: one LoRA training step (nonzero lora_up, a cached
   latent, batch 1: SDXL_LORA_PARITY_CUT, injected draws) of sdxl_parity's
   model at 512^2, card (kernels) against
   CPU (plain versions), bf16, then with the UNet NF4: the loss within 2e-2
   and every LoRA gradient within 1e-1 relative L2, or within 1.5 times the
   witness's error (the card's plain versions against the CPU) where bf16
   alone puts it further (SDXL_LORA_PARITY_FLOOR); 3 + 3 flash launches, and
   84 of #9 under NF4; the floors must fail the same step with #7 / #8
   dropping the last key tile, and with #9's scale row 3 25% off; then the
   bf16 step's fp32 witness: the same weights and adapters in fp32 on the
   card (kernels) and the CPU, attention in fp32, TF32 off, every gradient
   within 1e-3 (SDXL_FP32_WITNESS_FLOOR), its relative L2 printed;
17b. sdxl_flow_match_parity: sdxl_lora_parity's model with the flow-match
   config's LoRA, from an image (batch 1, FLOW_MATCH_PARITY_CUT) with
   injected VAE noise, timestep and noise:
   the LoRA step under sdxl_lora_parity's floors and wrong kernels, a 1-step
   CFG ``SDXLFlowMatch.generate`` from injected latents within 7.5e-2
   relative L2 (3 launches of #7), the step's fp32 witness, and the step
   with LoHa adapters over the UNet NF4 (84 launches of #9);
17d. cogview4_sampler: CogView4-6B at full width (the 28-layer DiT, 32 x
   128 heads; the 40-layer GLM-4-9B text tower; the 16-channel VAE), random
   weights from seed 0 drawn on the card, bf16 parameters and compute, the
   GLM word-hash tokenizer, through the compare tool's ``compare``
   (``tools.cogview4_quant_compare``) at 1024^2, batch 1, CFG 5, 5 steps,
   over its settings bf16, NF4 and int8: per setting a fresh model, a
   2-step warm request, the timed request and a profiled 2-step one;
   exactly 140 launches of #7 a request (28 a denoiser call), 280 of #9
   under NF4 (the shared feed-forward over the text stream's 2 x 16 rows),
   none else; 168 quantized linears under NF4 and int8, 0 in the text
   encoder; the image finite and not constant; then, on the bf16 model, a
   2-step request with the DiT's blocks offloaded in 4 groups to pinned
   host memory: the same latents bit for bit at a lower peak;
17e. cogview4_parity (after sdxl_slice14_parity): full widths, 2 DiT and
   2 GLM layers, 512^2 (S 1040,
   still #7), bf16: the text embeddings, one denoiser call and a 2-step CFG
   generate from injected latents, card (kernels) against CPU (plain
   versions), within 2e-2, 2e-2 and 7.5e-2 relative L2; the denoiser floor
   must fail #7 with one head's output zeroed in every launch, and every
   floor #7 writing nothing;
17f. vision_towers, ip_adapter_trainer, prompt_free_trainer (after
   sdxl_flow_match_parity): random towers from a seed written in their file
   layouts, fp16 (CLIP-L/14's shape as an HF directory, 257 tokens; a WD
   tagger's ViT-B/16 at 448^2 as a timm file, 785 tokens) and read back by
   ``AutoImageEncoder``; ``train.sdxl.ip_adapter_ref`` (the 2 synthetic
   images with metadata naming synthetic references) and
   ``train.sdxl.prompt_free_self`` on ``configs/sdxl/text_to_image_lora.yml``'s
   trainer settings with the adapter's model (``IPAdapterConfig()`` /
   ``PFGConfig()`` defaults over those towers) and no LoRA, SDXL-base at
   full width and depth, 1024^2, batch 2, 2 steps, no preview:
   exactly 140 + 69 launches of #7 / #8 a step (no backward through the
   first self-attention, which comes before every adapter and image
   token); exactly the 144 (IP) and 2
   (PFG) adapter and projector tensors trained and changed (fp64
   fingerprints of every parameter, the tower's too); the adapter file saved
   and loaded back equal; then one timed 2-step CFG-5 1024^2 request with a
   reference image, exactly 140 launches of #7; one more IP step
   profiled after the timed ones;
17g. adapter_entry_points: ``ip_adapter_self``, ``ip_adapter_kyara`` and
   ``prompt_free_ref`` one step each at sdxl_parity's depth, 512^2 (6 + 2
   launches), exactly the adapter tensors changed, kyara dropping no image;
17h. sdxl_adapter_parity: sdxl_lora_parity's model at 512^2 over 2-layer
   towers of the same token counts, batch 1: each family's Self step from an
   image (no image dropped), card (kernels) against CPU under
   SDXL_LORA_PARITY_FLOOR with the card's plain versions as the witness, and
   against the card's plain run within ADAPTER_KERNEL_FLOOR, the
   dropped-tile #7 / #8 failing the floors (3 + 2 launches); its fp32
   witness within SDXL_FP32_WITNESS_FLOOR; a 1-step CFG-5 sample with a
   reference image from injected latents and step noise within
   max(7.5e-2, 1.5 x the card's plain versions' error) relative L2 (3
   launches of #7);
17i. slice14_towers, rope_distill_trainer, draft_plus_trainer,
   style_tokenizer_trainer (after sdxl_adapter_parity): towers written once
   (PickScore_v1's CLIP-H/14 shape as an HF CLIP directory, fp16, random
   from a seed; the ViT-B/16-448 timm file); ``train.sdxl.rope_distill``,
   ``draft_plus`` and ``style_tokenizer`` on
   ``configs/sdxl/text_to_image_lora.yml``'s trainer settings (its LoRA for
   the first two, none for the style tokenizer) at SDXL-base's full width
   and depth, 1024^2, batch 2, 2 steps (step 2 timed): RoPE distillation
   with the workload's defaults (#7 240, #8 80 a step; a 2-step preview, 140),
   DRaFT+ over the PickScore tower (2 sampler steps, truncation 1, CFG 5:
   #7 280, #8 70 a step; its first, untimed step profiled, device-only), the style
   tokenizer's StyleTokenizerConfig() over the timm tower on the referenced
   images with ``<|style|>`` in every caption (#7 140, #8 70; a 2-step
   preview with a reference image, 140); exactly the LoRA tensors (or the 4
   projector tensors) changed, the reward towers and the vision tower not,
   the logged metrics finite, the student unlike its teacher;
17j. sdxl_slice14_parity: the three workloads' steps at sdxl_lora_parity's
   model, 512^2, batch 1, card (kernels) against CPU under
   SDXL_LORA_PARITY_FLOOR with the card's plain versions as the witness, and
   against the card's plain run within SLICE_KERNEL_FLOOR (RoPE, style), the
   dropped-tile #7 / #8 failing them; each step's fp32 witness within 1e-3
   (DRaFT+: 5e-3, SLICE_WITNESS_FLOOR);
17c. optimizers: prodigy, lion, adafactor, rmsprop and adagrad 20 steps on
   the same numpy-made parameters (a linear, a conv, a bias, two weights
   adafactor factors) and gradients, card against CPU within 1e-5 relative
   L2; ``Int8TrainLinear`` forward and backward at an SDXL shape and a
   padded one, the int32 product equal, the output within one bf16
   rounding;
18. jit_variants_trainer (after latent_parity): U-JiT, ARB U-JiT, Cross, IG,
   LoIG and TREAD through their entry points (``train.jit.*.run``, the
   card by default) at JiT-B/16 width and depth (U-JiT: depth 5 with 12
   blocks), 256^2, batch 16, bf16 compute, fp32 parameters, 3 steps and a
   2-step CFG preview each (ARB U-JiT on synthetic tagged 256^2 images
   through the x-loss config's dataset and optimizer); s/step, peak memory;
   exactly (#1, #2) launches a step of (0, 0) U-JiT, (11, 11) Cross, (4, 4)
   IG and LoIG, (6, 6) TREAD (blocks 0-1 and 8-11 at S 330 with suffix
   kv_lens), and #1 per preview denoiser call 0, 11, 4, 4 and 12; TREAD's
   last step runs under the profiler;
19. x_loss_trainer: ``configs/jit/x_loss/config.yml`` as shipped through
   ``train.jit.arb_class_to_image`` (depth 24, context from block 0, so
   every block masked and no kernel launch; gradient checkpointing,
   RAdamScheduleFree), cut to 16 synthetic 256^2 ``.webp`` images with
   ``.tags.json`` metadata, 4 steps, a 2-step preview of its prompts and
   temporary output paths, each cut listed; s/step, peak memory, a save;
20. jit_variants_parity: one bf16 training step of each variant at
   JiT-B/16 width and 4 blocks (context from block 2; U-JiT depth 1 with 4
   blocks), batch 2, the same seeded weights, batch and draws (TREAD's
   permutation among them) on the card (kernels) and on the CPU (plain
   versions), held to the bf16 train_parity floors, with 3 (Cross), 2 (IG,
   LoIG, TREAD) and 0 (U-JiT) launches of #1 and #2; then a 2-step
   IG-guided (ig_scale 2) CFG sample of the IG model, at least 30 dB PSNR
   card against CPU, 4 launches of #1.

After phase 2, short_kernel holds kernels #3-#6 (the short backend's BSHD
and BHSD entries, forward and backward) against their plain versions at the
JiT-B/16 train shape and at edge shapes (S 37; Sq 266 with Sk 77; kv_lens
full, partial and 0; D 128; bf16 and fp32) under phase 2's limits, which must
fail a plain version one key short; autograd through both entries must give
exactly their backward; #10 and #11 at the probes' shape (B 64, S 304, 12 x
64) and at S that cut their 64-row tiles (S 37, 65, 129, 257, 298) under the
same limits, which must fail a plain version with one head's output left out
and one that drops the last key; fp16 cases of #3-#6 likewise. short_timing
times #3-#6 at the train shape (SDPA forward, and forward and backward, as
the yardsticks), #10 and #11 at theirs (SDPA forward and backward with the
adds; seven bf16 matmuls; with the products each executes) and #2 again.
nf4_kernel holds kernel #9 (``dequant_matmul_4bit``) against
its plain version at the sampler's shapes and at edge shapes (M 1, 37, 1024;
K 128, 5120; N 8, 136, 10240), nf4 and fp4, bf16, fp16 and fp32, under
phase 2's limits (fp16's tol 2e-3), which must fail a plain version with one absmax row 25% off or one
64-row chunk left out, and on both sides of each block-shape boundary (M 1,
64, 65, 128, 129, 154, 256, 257, 1024 at K 2048, N 1280, which K splits);
two calls at M 64 and 154 must give the same bits; the QLoRA trainer's M 454
and the NF4 CogView4 sampler's (M 32; K 4096, N 16384 and K 16384, N 4096)
are held too. tread_timing times #1 (with its lse) and #2 at TREAD's
unrouted blocks (B 16, S 330, suffix kv_lens of 267-270), beside SDPA with
the equivalent boolean key mask, bounded by the valid key rows. Phase 3
also times kernels #7 and #8 at SDXL's two self-attention shapes and #7 at
CogView4's (B 2, S 4112, 32 x 128), #7 and #8 at RoPE distillation's low-res
shape (B 2, S 1024, 10 heads), and
nf4_timing times kernel #9 at the sampler's, the QLoRA trainer's and the
CogView4 sampler's shapes and at the JAX package's bench shape (M 64, K =
N = 8192), beside F.linear on the weight dequantized beforehand.

21. import_sdxl and inference_server (last, in the SDXL trainers' directory):
   the fp16 random-weight sgm file that sdxl_qlora_trainer's checkpoint was
   quantized from (``tools.quantize_model.quantize_file`` on the card wrote
   the NF4 file) through ``tools.checkpoint.import_sdxl.run_import``: a
   strict load, a UNet forward at 128 x 128 latents and a 2-step 1024^2
   generate (210 launches of #7). Then ``tools.inference_server.T2IModel``
   on the QLoRA config (the NF4 file, word-hash) with the LoRA that
   sdxl_qlora_trainer saved, served on 127.0.0.1:0 from a thread and driven
   from threads through ``tools.inference_client.generate_image``: /health,
   a seeded request at the server's defaults (768 x 1024, 25 steps, CFG
   6.5), 8 seedless 1024^2 requests (CFG 5, 5 steps) queued while it runs,
   which the batcher folds into one call (sampler calls [1, 8]), and a
   malformed body (422); untimed 2-step warm-ups of both shapes first. The
   group launches #7 350 times and #9 never (16 x 77 context rows, over
   the kernel's 1,024), the default request #7 250 and #9 3,500 times; every
   response a webp of its size, finite and not constant; the seeded
   response's bytes those of the same ``generate`` made directly and encoded
   as the server encodes it (or, if the card's sampler were not repeatable,
   within one level before encoding); the peaks that ``check_memory`` and
   ``snapshot_max_memory`` read equal ``torch.cuda.max_memory_allocated``;
   a profiled 2-step group of 8.

22. text_sampler (after parity): text-conditioned JiT at full width: an
   HF-style Qwen3-VL directory written from a seed on the card (a
   ``config.json`` nesting ``text_config``; the 2048-wide text tower cut to
   TEXT_TOWER_LAYERS = 4 of its 28 layers (the line gives the parameters), bf16
   safetensors in 2 shards; norm scales drawn, not ones; the seconds the
   cut saves, from this run's write and load rate), loaded through ``JiTModel`` with ``TextContextConfig``
   (``TextEncoder.from_local``, fp32 as in the JAX package) and JiT-B/16
   with context 2048, bf16; the Qwen word-hash tokenizer; 3 requests of
   ``generate`` at 256^2, 8 prompts of 1-12 words, CFG 2, 20 steps: exactly
   80 launches of #1 a request (blocks 0-3; the masked blocks take plain
   attention) and none else; load, encode and request seconds, steps/s,
   peak memory; a profiled 2-step request;
23. text_parity: the tower at full width and vocabulary cut to 2 layers
   (written from a seed on the host) and JiT-B/16 from seed 0, card
   (kernels) against CPU (plain versions): the penultimate state of 2
   prompts and their negatives in fp32 (the pipeline's tower) within 1e-4
   and in bf16 within 2e-2 relative L2, and a 2-step CFG ``generate`` from
   injected noise at PSNR >= 50 dB (fp32) and 30 dB (bf16); 8 launches of
   #1 on the card; its CPU halves queued before the build;
24. losses: ``PerceptualLoss`` with SSIM and LPIPS (random VGG16 weights
   written in the lpips package's layout) over 8 image pairs at 256^2, and
   the shortcut durations, teacher targets and self-consistency loss over
   the JiT-B/16 denoiser (fp32, seed 0, 32 unmasked context tokens, batch
   4) with injected draws: card against CPU within 1e-4 relative; 36
   launches of #1 (3 denoiser calls of 12 blocks);
25. e2e_feed (after the CPU halves are in, so the worker process does not
   share the host): 512 JPEGs with captions written from a seed (the JAX
   package's e2e image set: 320-384 x 288-384, quality 85), a uint8
   ``TextToImageBucket`` at 256^2, batch 64, through the C loader (the phase
   fails if g++ and the libjpeg, libpng and libwebp headers are there and
   it did not build or the bucket did not take it; without them it says so
   and feeds through PIL); the host decode rate in-process; then
   ``BatchWorkerPool`` (one worker per core but one, depth 3) into the
   headline JiT-B/16 step (``_jit_train_setup``, bf16, fp32 parameters):
   each batch copied to the card (an event waited on before its slot is
   recycled), mapped from uint8 to [-1, 1] there; the first batches equal
   the in-process ``get_batch`` of the same indices; 3 windows of 10 fed
   steps: exactly 12 + 12 launches of #1 / #2 a step; images/s, consumer
   wait, worker decode and copy seconds, the same step on a resident batch;
   then a synthetic latent cache (512 items, 32 x 32 x 4, fp16) through
   ``CachedLatentBucket`` and the pool into the latent step of the JAX
   package's ``bench_latent_e2e`` (patch 4, S 74: no kernel), order and
   content checked, steps/s.

The parity phases' CPU halves (train_parity, parity, cache_latents' CPU
encode, latent_parity, text_parity, losses, jit_variants_parity,
sdxl_parity, sdxl_lora_parity, sdxl_flow_match_parity, sdxl_adapter_parity,
sdxl_slice14_parity, cogview4_parity) run in one spawned worker process beside the card's
phases (see ``CpuHalves``); the halves that need no card state are queued
before the build and run beside it, the others when their card half runs
(cache_latents runs right after attention_probes, so its half follows the
early ones with no gap in the worker's queue), and each
phase's comparison runs when both halves are in, before the kernels line.
The SDXL LoRA, flow-match, adapter and slice-14 parity phases run before
their trainers, and every phase that submits a CPU half (cogview4_parity
the last) before the SDXL LoRA, QLoRA and flow-match trainers, so the
worker's jobs overlap the trainers and samplers with no wait for the next
submission; a ``cpu_halves`` line gives every job's span.

Every kernel launch counter is set to 0 just before a path is driven and read
just after. Then the ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi prints them, and the result line.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vision_pt_tpu_torch.tools.bench import device_timing, event_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# attention in fp16: its weights and ds are rounded to 11 significant bits
# (bf16: 8), so a sum in another order flips a rounding 8 times smaller than
# in bf16; 5e-3 keeps the bf16 limit's headroom (largest bf16 share ~0.5)
# and still fails a plain version one key short
ATTN_TOL = {**TOL, torch.float16: 5e-3}
# the flash forward's LSE (fp32 on both sides, about 8.3 at S 4106): absolute
LSE_ATOL = 1e-4
STEPS, BATCH, REQUESTS = 20, 8, 3
LAUNCHES_PER_REQUEST = 4 * STEPS  # blocks 0-3 (before context_start_block)
PSNR_FLOOR_DB = {"float32": 50.0, "bfloat16": 30.0}
TRAIN_BATCH, TIMED_STEPS = 64, 10
# train_parity floors, largest over the parameters of the relative L2 error
# of the gradient, card vs CPU. fp32: both sides compute in fp32 and differ
# only in the order of sums (measured errors ~1e-5 on the CPU against JAX).
# bf16: every activation is rounded to 8 mantissa bits and the card's and
# the CPU's matmuls round at other places, so a few percent is expected; a
# wrong kernel gives errors of order 1.
# fp16 backwards scale the loss by 2^12 first, as fp16 training under
# torch.amp's GradScaler does; the port's trainer, like the JAX package's,
# does not scale, so this step is not the trainer's path. Unscaled, the
# attention backward's ds = p (dp - delta) rounds to 0 in fp16 for 39-87%
# (JiT) and 91-100% (latent) of its nonzero values, on either side: the
# CPU's own fp16 gradients miss the fp32 step's by 150% and 108%, and card
# and CPU differ by 0.83 and 0.26 whether the card runs the kernels or their
# plain versions. Scaled, each side is within 0.0066 of the fp32 step
# (tools/bench/step_parity.py on an H100).
LOSS_SCALE = {"float16": 4096.0}
TRAIN_PARITY_FLOOR = {"float32": {"loss": 1e-4, "grad": 1e-3},
                      "bfloat16": {"loss": 2e-2, "grad": 1e-1},
                      # above the scaled fp16 readings, card vs CPU (grad
                      # <= 0.0070, loss <= 2.4e-6), below the bf16 steps'
                      # grad (0.041-0.050), so a step at bf16 precision
                      # fails; the loss alone does not separate the two
                      "float16": {"loss": 1e-5, "grad": 2e-2}}
ROOT = os.path.dirname(os.path.abspath(__file__))
# the port's own kernels among a profile's device kernels
PORT_KERNEL = re.compile(
    r"attn_(fwd|bwd_dq|bwd_dkdv)_|(packed|flash)_bwd_(dq|dkdv)_|nf4_matmul|"
    r"(pairing|dots)_probe_")
SOURCES = ("short_attention", "short_attention_bwd", "flash_attention",
           "flash_attention_bwd", "nf4_matmul", "attention_probe")
LATENT_BATCH, LATENT_SIDE, LATENT_ITEMS = 16, 128, 64
# the kernel launch counters, in the order of every launch-count tuple:
# kernels #1-#11 (their wrappers in _wrappers())
N_KERNELS = 11


def _expect(launches: dict[int, int]) -> tuple[int, ...]:
    """A launch-count tuple from {kernel number: launches}, 0 elsewhere."""
    return tuple(launches.get(i, 0) for i in range(1, N_KERNELS + 1))


# flash launches per latent training step: 24 blocks forward, 24 recomputed
# under gradient checkpointing, 24 backward
LATENT_STEP_LAUNCHES = _expect({7: 48, 8: 24})


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, stamped with the seconds since the script started and
    the CPU-half jobs not done at the time."""
    at = round(time.perf_counter() - _STARTED, 1)
    if _HALVES is not None:
        fields.setdefault("cpu_halves_beside", _HALVES.beside())
    print(json.dumps({"phase": phase, "at_seconds": at, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def psnr(ours: np.ndarray, theirs: np.ndarray) -> float:
    mse = float(np.mean((ours - theirs) ** 2))
    peak = float(theirs.max() - theirs.min())
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


# ------------------------------------------------ the CPU halves, beside the card

# The parity phases' CPU halves (the same weights and draws through the
# plain versions on the host) run in one spawned worker process, one job at
# a time in the order they were submitted, while the card goes on with the
# later phases; each phase's comparison runs when both halves are in (at the
# end of the run, before the kernels line). The worker takes all cores but
# one, which the card's dispatching thread keeps. Every phase line names the
# jobs not yet done when it was printed (``cpu_halves_beside``: the first is
# running, the rest wait), because a host-bound s/step can move while one
# runs. A card object reaches the worker, which makes its CPU twin
# (``_cpu_twin``): pickled with every tensor copied to the host, each tensor whose
# content the worker holds from the previous shipment sent by a key (shape,
# dtype and two sums of its values) instead.
_HALVES = None  # the CpuHalves of the run
_STARTED_WALL = time.time()


def _cpu_worker_init(threads: int) -> None:
    torch.set_num_threads(threads)


def _run_job(ship, fn, *args):
    """A worker job: the shipped object (if any) unpacked, then ``fn``;
    returns its result and the job's wall-clock span."""
    started = time.time()
    args = (_unship(ship), *args) if ship is not None else args
    result = fn(*args)
    return {"result": result, "span": (started, time.time())}


_WORKER_CACHE: dict = {}  # the worker's tensors of the previous shipment


class _Collector(pickle.Pickler):
    """Pickles an object graph with its tensors left out, by index."""

    def __init__(self, file):
        super().__init__(file, protocol=4)
        self.tensors, self.index = [], {}

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            if id(obj) not in self.index:
                self.index[id(obj)] = len(self.tensors)
                self.tensors.append(obj)
            return ("tensor", self.index[id(obj)])
        if isinstance(obj, torch.Generator):
            return ("generator", obj.initial_seed())
        return None


class _Restorer(pickle.Unpickler):
    def __init__(self, file, manifest):
        super().__init__(file)
        self.manifest, self.made = manifest, {}

    def persistent_load(self, pid):
        kind, value = pid
        if kind == "generator":
            return torch.Generator().manual_seed(value)
        if value not in self.made:
            key, is_param, requires_grad = self.manifest[value]
            tensor = _WORKER_CACHE[key].detach()
            self.made[value] = (torch.nn.Parameter(tensor, requires_grad=requires_grad)
                                if is_param else tensor.requires_grad_(requires_grad))
        return self.made[value]


def _content_keys(tensors) -> list[str]:
    """A key per tensor from its shape, dtype and two sums of its values
    (plain and position-weighted), computed where the tensor lies."""
    keys = []
    for t in tensors:
        v = t.detach().reshape(-1).float()
        w = torch.arange(v.numel(), device=v.device, dtype=torch.float32).remainder_(7919)
        a, b = torch.stack([v.sum(), (v * w).sum()]).tolist()
        keys.append(f"{tuple(t.shape)}|{t.dtype}|{a!r}|{b!r}")
    return keys


def _unship(ship: dict):
    """The object of a shipment, its tensors on the host; the worker keeps
    this shipment's tensors for the next one."""
    global _WORKER_CACHE
    new = torch.load(ship["tensors"], weights_only=True) if ship["tensors"] else {}
    if ship["tensors"]:
        os.remove(ship["tensors"])
    cache = {key: new[key] if key in new else _WORKER_CACHE[key]
             for key, _, _ in ship["manifest"]}
    _WORKER_CACHE = cache
    return _Restorer(io.BytesIO(ship["skeleton"]), ship["manifest"]).load()


class CpuHalves:
    """The worker process and its jobs (see above)."""

    def __init__(self, work: str):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.work, self.threads = work, max((os.cpu_count() or 2) - 1, 1)
        self.pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(self.threads,))
        self.jobs: list[list] = []  # [name, future, finish]
        self.early: dict = {}
        self.previous: set[str] = set()
        self.shipped = {"count": 0, "bytes": 0, "sent_bytes": 0, "seconds": 0.0}

    def ship(self, obj) -> dict:
        """``obj`` pickled for the worker: the tensors it lacks written to a
        file, the others named by their keys."""
        t0 = time.perf_counter()
        buf = io.BytesIO()
        collector = _Collector(buf)
        collector.dump(obj)
        keys = _content_keys(collector.tensors)
        manifest = [(key, isinstance(t, torch.nn.Parameter), t.requires_grad)
                    for key, t in zip(keys, collector.tensors)]
        new = {}
        for key, t in zip(keys, collector.tensors):
            if key not in self.previous and key not in new:
                new[key] = t.detach().cpu()
        path = None
        if new:
            path = os.path.join(self.work, f"ship{self.shipped['count']}.pt")
            torch.save(new, path)
        self.previous = set(keys)
        self.shipped["count"] += 1
        self.shipped["bytes"] += sum(t.numel() * t.element_size()
                                     for t in {id(t): t for t in collector.tensors}.values())
        self.shipped["sent_bytes"] += sum(t.numel() * t.element_size() for t in new.values())
        self.shipped["seconds"] += time.perf_counter() - t0
        return {"skeleton": buf.getvalue(), "manifest": manifest, "tensors": path}

    def submit(self, name: str, fn, *args, ship=None, finish=None):
        """Queue ``fn(*args)`` (with the shipped object first); ``finish``
        takes its result when the run drains."""
        future = self.pool.submit(_run_job, ship, fn, *args)
        self.jobs.append([name, future, finish])
        return future

    def early_submit(self, key, name: str, fn, *args) -> None:
        """A job whose inputs need no card work, queued at the start; the
        phase that compares takes it with ``take``."""
        self.early[key] = self.submit(name, fn, *args)

    def take(self, key, name: str, fn, *args):
        """The future of an early job, or the job queued now."""
        return self.early.pop(key, None) or self.submit(name, fn, *args)

    def then(self, future, finish) -> None:
        for job in self.jobs:
            if job[1] is future:
                job[2] = finish

    def beside(self) -> list[str]:
        return [name for name, future, _ in self.jobs if not future.done()]

    def drain(self) -> None:
        """Each job's result through its ``finish``, in submission order;
        then one line of the worker's jobs and their spans."""
        spans = []
        t0 = time.perf_counter()
        for name, future, finish in self.jobs:
            out = future.result()
            started, ended = (round(t - _STARTED_WALL, 1) for t in out["span"])
            spans.append({"job": name, "started_at": started, "ended_at": ended})
            if finish is not None:
                finish(out["result"], {"cpu_half": "worker", "cpu_started_at": started,
                                        "cpu_ended_at": ended})
        emit("cpu_halves", threads=self.threads, cpu_count=os.cpu_count(),
             waited_seconds=time.perf_counter() - t0, jobs=spans,
             shipped_objects=self.shipped["count"], shipped_bytes=self.shipped["bytes"],
             sent_bytes=self.shipped["sent_bytes"],
             ship_seconds=self.shipped["seconds"])
        self.jobs = []

    def close(self) -> None:
        processes = list((self.pool._processes or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for process in processes:
            process.terminate()
            process.join(timeout=30)


# ------------------------------------------------------------------ phases


def phase_device() -> str:
    from vision_pt_tpu_torch.ops import _build

    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build(list(SOURCES))
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for log, _ in _build.build_logs.values()
             for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    spills = [line for line in ptxas if "spill" in line
              and not line.startswith("0 bytes stack frame, 0 bytes spill")]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(seconds, 3), ptxas=ptxas, spills=spills)
    return smi


def _attention_inputs(gen, batch, sq, sk, heads, dim, dtype):
    return [torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def _kv_lens(gen, lens, batch, sk):
    if lens == "range":  # kv_lens in [min(266, Sk), Sk], row 1 at 0
        kv_lens = torch.randint(min(266, sk), sk + 1, (batch,), generator=gen,
                                device="cuda")
        kv_lens[1] = 0
        return kv_lens
    return None if lens is None else torch.tensor(lens, device="cuda")


def _compare(out, ref, tol, atol=None):
    """The largest |out - ref|, and the largest share of its limit
    atol + tol * |ref| that an element uses (at most 1 to agree). ``atol``
    defaults to tol times the RMS of ref, so the limit follows the size of
    what is compared: at S = 4170 an attention output or gradient is about
    0.025 in RMS, and a fixed 2e-2 would pass a kernel that drops a key
    tile."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    if atol is None:
        atol = tol * float(ref.square().mean().sqrt())
    limit = (atol + tol * ref.abs()).clamp_min(1e-30)
    return float(diff.max()), float((diff / limit).max())


def _agree(compared) -> tuple[float, float, bool]:
    """(largest error, largest limit share, every tensor within its limit)
    over the ``_compare`` results of one kernel's outputs."""
    err = max(e for e, _ in compared)
    share = max(s for _, s in compared)
    return err, share, share <= 1.0


def phase_kernel() -> dict:
    """Both kernels against their plain versions; returns the largest error
    of each at the training-step shape."""
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
        short_attention_packed_bwd_reference,
        short_attention_packed_reference,
        short_attention_packed_with_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # (name, batch, sq, sk, heads, dim, dtype, bounded, kv_lens)
        ("train_s298", 64, 298, 298, 12, 64, bf16, True, None),
        ("train_s266", 64, 266, 266, 12, 64, bf16, True, None),
        ("sampler_s266", 16, 266, 266, 12, 64, bf16, True, None),
        ("s37", 2, 37, 37, 2, 64, bf16, True, [37, 21]),
        ("s37_unbounded", 2, 37, 37, 2, 64, bf16, False, [37, 21]),
        ("s330_kv", 16, 330, 330, 12, 64, bf16, True, "range"),
        ("s330_kv_unbounded", 16, 330, 330, 12, 64, bf16, False, "range"),
        ("sq266_sk330", 16, 266, 330, 12, 64, bf16, True, "range"),
        ("d128", 4, 266, 266, 6, 128, bf16, False, "range"),
        ("s129", 4, 129, 129, 12, 64, bf16, False, [128, 0, 129, 64]),
        ("s266_fp32", 16, 266, 266, 12, 64, f32, True, None),
        ("d128_fp32", 4, 266, 330, 6, 128, f32, False, "range"),
        ("train_s298_fp16", 64, 298, 298, 12, 64, f16, True, None),
        ("s330_kv_fp16", 16, 330, 330, 12, 64, f16, True, "range"),
        ("s330_kv_unbounded_fp16", 16, 330, 330, 12, 64, f16, False, "range"),
        ("d128_fp16", 4, 266, 330, 6, 128, f16, False, "range"),
    ]
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, bounded, lens in cases:
        q, k, v = _attention_inputs(gen, batch, sq, sk, heads, dim, dtype)
        do = torch.randn(batch, sq, heads * dim, generator=gen, device="cuda").to(dtype)
        kv_lens = _kv_lens(gen, lens, batch, sk)
        tol = ATTN_TOL[dtype]
        out, lse = short_attention_packed_with_lse(q, k, v, heads, kv_lens,
                                                   bounded=bounded)
        grads = short_attention_packed_bwd(q, k, v, lse, do, heads, kv_lens,
                                           bounded=bounded)
        torch.cuda.synchronize()
        ref, ref_lse = short_attention_packed_reference(
            q, k, v, heads, kv_lens, bounded=bounded, return_lse=True)
        # the backward's plain version takes the kernel's lse, as #8's
        ref_grads = short_attention_packed_bwd_reference(
            q, k, v, lse, do, heads, kv_lens, bounded=bounded)
        for kernel, outs, compared in (
                ("short_attention_packed", [out],
                 [_compare(out, ref, tol), _compare(lse, ref_lse, 0.0, LSE_ATOL)]),
                ("short_attention_packed_bwd", grads,
                 [_compare(g, r, tol) for g, r in zip(grads, ref_grads)])):
            err, share, within = _agree(compared)
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            zero_row = past_kv_zero = None
            if kv_lens is not None and int(kv_lens[1]) == 0:
                zero_row = all(bool((o[1] == 0).all()) for o in outs)
            if kernel.endswith("bwd") and kv_lens is not None:
                k0 = int(kv_lens[0])
                past_kv_zero = all(bool((g[0, k0:] == 0).all()) for g in grads[1:])
            emit("kernel", kernel=kernel, case=name,
                 shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                 bounded=bounded, max_abs_err=err, tolerance=tol,
                 lse_atol=LSE_ATOL if kernel == "short_attention_packed" else None,
                 limit_share=share, finite=finite, zero_row=zero_row,
                 past_kv_zero=past_kv_zero)
            check(finite and within and zero_row is not False
                  and past_kv_zero is not False,
                  f"{kernel} disagrees with its plain version at {name}")
            if name == "train_s298":
                errors[kernel] = err
        if name == "train_s298":
            # repeated calls give the same bits: no atomics, fixed order
            again = short_attention_packed_bwd(q, k, v, lse, do, heads,
                                               bounded=bounded)
            same = all(torch.equal(a, b) for a, b in zip(again, grads))
            emit("kernel", kernel="short_attention_packed_bwd", case="repeat",
                 bitwise_equal=same)
            check(same, "two calls of the packed backward differ")
        if name.startswith("s330_kv"):
            # the limits must fail the kernel's row 0 against the plain
            # version of that row with one key fewer
            n = int(kv_lens[0])
            wrong = torch.tensor([n - 1], device="cuda")
            row = [x[:1] for x in (q, k, v, lse, do)]
            refs = [short_attention_packed_reference(*row[:3], heads, wrong,
                                                     bounded=bounded),
                    *short_attention_packed_bwd_reference(*row, heads, wrong,
                                                          bounded=bounded)]
            shares = [_compare(o, r, tol)[1] for o, r in
                      zip([out[:1], *(g[:1] for g in grads)], refs)]
            emit("kernel", kernel="short_attention_packed", case="limits_can_fail",
                 dtype=str(dtype), bounded=bounded, kv_len=n,
                 one_key_fewer_shares=shares)
            check(shares[0] > 1 and max(shares[1:]) > 1,
                  f"the packed limits pass a kernel one key short at {name}: {shares}")
        del q, k, v, do, out, lse, grads, ref, ref_lse, ref_grads
        torch.cuda.empty_cache()

    # autograd through the Function runs exactly the backward kernel
    for dtype in (bf16, f16):
        q, k, v = (x.requires_grad_() for x in
                   _attention_inputs(gen, 4, 266, 266, 12, 64, dtype))
        do = torch.randn(4, 266, 768, generator=gen, device="cuda").to(dtype)
        out = short_attention_packed(q, k, v, 12, bounded=True)
        auto = torch.autograd.grad(out, (q, k, v), do)
        leaves = [x.detach() for x in (q, k, v)]
        again, lse = short_attention_packed_with_lse(*leaves, 12, bounded=True)
        explicit = short_attention_packed_bwd(*leaves, lse, do, 12,
                                              bounded=True)
        equal = torch.equal(out, again) and all(
            torch.equal(a, b) for a, b in zip(auto, explicit))
        emit("kernel", kernel="short_attention_packed_bwd", case="autograd",
             dtype=str(dtype), autograd_equals_explicit=equal)
        check(equal, "autograd through short_attention_packed differs from its "
              f"backward ({dtype})")
    return errors


FLASH_CASES = [
    # (name, batch, sq, sk, heads, dim, dtype, causal, kv_lens)
    ("path_s4170_kv", 4, 4170, 4170, 12, 64, torch.bfloat16, False,
     [4106, 4170, 4107, 0]),
    ("path_s4106", 4, 4106, 4106, 12, 64, torch.bfloat16, False, None),
    # the SDXL sampler's self-attentions at 1024^2 (B 2 with CFG)
    ("sdxl_s4096", 2, 4096, 4096, 10, 64, torch.bfloat16, False, None),
    ("sdxl_s1024", 2, 1024, 1024, 20, 64, torch.bfloat16, False, None),
    # RoPE distillation's low-res pass (512^2): stage 2's 10 heads at S 1024
    ("sdxl_lowres_s1024", 2, 1024, 1024, 10, 64, torch.bfloat16, False, None),
    # the CogView4 sampler's joint self-attention at 1024^2 (B 2 with CFG):
    # 4096 image + 16 text tokens, a partial last key and query tile of 16
    ("cogview4_s4112", 2, 4112, 4112, 32, 128, torch.bfloat16, False, None),
    ("s1000_kv", 2, 1000, 1000, 12, 64, torch.bfloat16, False, [1000, 0]),
    ("sq1000_sk1500", 2, 1000, 1500, 6, 64, torch.bfloat16, False, [1337, 0]),
    ("causal_s1000", 2, 1000, 1000, 12, 64, torch.bfloat16, True, [1000, 777]),
    ("d128", 2, 1000, 1100, 6, 128, torch.bfloat16, False, [1100, 0]),
    ("fp32_s1000", 2, 1000, 1000, 4, 64, torch.float32, False, [1000, 0]),
    ("fp32_d128_causal", 2, 700, 700, 2, 128, torch.float32, True, [700, 333]),
    ("fp16_s1000_kv", 2, 1000, 1000, 12, 64, torch.float16, False, [777, 0]),
    ("fp16_d128_causal", 2, 700, 700, 2, 128, torch.float16, True, [700, 333]),
    # the edges of the key tiles (64 keys below Sk 1024, 128 from it on at
    # D 64): one key past a tile, causal with kv_len one past a tile, Sq !=
    # Sk at D 128 with a zero row
    *((f"{tag}_{label}", batch, sq, sk, heads, dim, dtype, causal, lens)
      for tag, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
      for label, batch, sq, sk, heads, dim, causal, lens in (
          ("s129", 1, 129, 129, 1, 64, False, [128]),
          ("s257_causal", 2, 257, 257, 2, 64, True, [257, 129]),
          ("sq200_sk320_d128", 2, 200, 320, 1, 128, False, [255, 0]),
          ("s1025", 2, 1025, 1025, 2, 64, False, [1025, 1024]),
          ("s1153_causal", 2, 1153, 1153, 2, 64, True, [1153, 1025]))),
]


def _bshd(gen, batch, s, heads, dim, dtype):
    return torch.randn(batch, s, heads, dim, generator=gen, device="cuda").to(dtype)


def _flash_compare(outs, refs, tol):
    """``_compare`` over (out, lse) or (dq, dk, dv); the LSE, the one (B, H,
    Sq) tensor, is held to LSE_ATOL absolute."""
    return [_compare(o, r, 0.0, LSE_ATOL) if o.dim() == 3 else _compare(o, r, tol)
            for o, r in zip(outs, refs)]


def _flash_limits_can_fail(q, k, v, do, out, lse, grads, lens, tol):
    """The limits must fail a kernel that is slightly wrong: the kernel's
    results for row 2 (kv_len 4107) against the plain version of that row
    with 64 keys fewer, with kv_len rounded down to its tile edge (4096) and
    with one key fewer. Each must make the forward and the backward
    disagree; 64 keys fewer must make every tensor disagree on its own."""
    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    i, n = 2, lens[2]
    row = [x[i:i + 1] for x in (q, k, v, out, lse, do)]
    kernel = [out[i:i + 1], lse[i:i + 1], *(g[i:i + 1] for g in grads)]
    shares = {}
    for label, wrong in (("64_keys_fewer", n - 64), ("tile_edge", n // 64 * 64),
                         ("one_key_fewer", n - 1)):
        wrong_lens = torch.tensor([wrong], device="cuda")
        refs = [*flash_attention_reference(*row[:3], wrong_lens),
                *flash_attention_bwd_reference(*row, wrong_lens)]
        shares[label] = dict(zip(("out", "lse", "dq", "dk", "dv"), (
            s for _, s in (_flash_compare(kernel[:2], refs[:2], tol)
                           + _flash_compare(kernel[2:], refs[2:], tol)))))
    emit("kernel", kernel="flash_attention", case="limits_can_fail", kv_len=n,
         limit_shares=shares)
    for label, s in shares.items():
        check(max(s["out"], s["lse"]) > 1 and max(s["dq"], s["dk"], s["dv"]) > 1,
              f"the flash limits pass a kernel with kv_len off ({label}): {s}")
    check(min(shares["64_keys_fewer"].values()) > 1,
          f"a flash limit passes 64 keys left out: {shares['64_keys_fewer']}")


def phase_flash_kernel() -> dict:
    """Kernels #7 and #8 against their plain versions; returns the largest
    error of each at the latent trainer's shape (S 4170 with kv_lens), and of
    #7 at each SDXL shape and the CogView4 shape (by case name)."""
    from vision_pt_tpu_torch.ops.flash_attention import (
        NEG_INF,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_attention_with_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, causal, lens in FLASH_CASES:
        q, do = (_bshd(gen, batch, sq, heads, dim, dtype) for _ in range(2))
        k, v = (_bshd(gen, batch, sk, heads, dim, dtype) for _ in range(2))
        kv_lens = None if lens is None else torch.tensor(lens, device="cuda")
        tol = ATTN_TOL[dtype]
        out, lse = flash_attention_with_lse(q, k, v, kv_lens, causal=causal)
        # the backward's plain version takes the kernel's (out, lse) too
        grads = flash_attention_bwd(q, k, v, out, lse, do, kv_lens, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, kv_lens, causal=causal)
        ref_grads = flash_attention_bwd_reference(q, k, v, out, lse, do, kv_lens,
                                                  causal=causal)
        zero_rows = [i for i, n in enumerate(lens or []) if n == 0]
        partial = [(i, n) for i, n in enumerate(lens or []) if 0 < n < sk]
        for kernel, outs, refs in (("flash_attention", [out, lse], [ref, ref_lse]),
                                   ("flash_attention_bwd", grads, ref_grads)):
            err, share, within = _agree(_flash_compare(outs, refs, tol))
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            # a kv_len 0 row: output and gradients 0, LSE -1e30
            zero_row = all(bool((o[i] == (NEG_INF if o is lse else 0)).all())
                           for o in outs for i in zero_rows) if zero_rows else None
            past_kv_zero = None
            if kernel.endswith("bwd") and partial:
                past_kv_zero = all(bool((g[i, n:] == 0).all())
                                   for g in grads[1:] for i, n in partial)
            emit("kernel", kernel=kernel, case=name,
                 shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                 causal=causal, kv_lens=lens, max_abs_err=err, tolerance=tol,
                 lse_atol=LSE_ATOL if kernel == "flash_attention" else None,
                 limit_share=share, finite=finite, zero_row=zero_row,
                 past_kv_zero=past_kv_zero)
            check(finite and within and zero_row is not False
                  and past_kv_zero is not False,
                  f"{kernel} disagrees with its plain version at {name}")
            if name == "path_s4170_kv":
                errors[kernel] = err
            elif name.startswith(("sdxl", "cogview4")) and kernel == "flash_attention":
                errors[name] = err
        if name == "path_s4170_kv":
            _flash_limits_can_fail(q, k, v, do, out, lse, grads, lens, tol)
        if dtype == torch.float16:
            # the fp16 limits must fail the kernel's partial row against the
            # plain version of that row with one key fewer
            i, n = partial[0]
            wrong = torch.tensor([n - 1], device="cuda")
            row = [x[i:i + 1] for x in (q, k, v, out, lse, do)]
            refs = [flash_attention_reference(*row[:3], wrong, causal=causal)[0],
                    *flash_attention_bwd_reference(*row, wrong, causal=causal)]
            shares = [_compare(o, r, tol)[1] for o, r in
                      zip([out[i:i + 1], *(g[i:i + 1] for g in grads)], refs)]
            emit("kernel", kernel="flash_attention", case="limits_can_fail",
                 dtype=str(dtype), kv_len=n, one_key_fewer_shares=shares)
            check(shares[0] > 1 and max(shares[1:]) > 1,
                  f"the fp16 flash limits pass a kernel one key short: {shares}")
        del ref, ref_lse, ref_grads, grads
        torch.cuda.empty_cache()

    # autograd through the Function runs exactly the backward kernel
    q, k, v = (_bshd(gen, 2, 1000, 12, 64, torch.bfloat16).requires_grad_()
               for _ in range(3))
    do = _bshd(gen, 2, 1000, 12, 64, torch.bfloat16)
    kv_lens = torch.tensor([1000, 611], device="cuda")
    out = flash_attention(q, k, v, kv_lens)
    auto = torch.autograd.grad(out, (q, k, v), do)
    leaves = [x.detach() for x in (q, k, v)]
    again, lse = flash_attention_with_lse(*leaves, kv_lens)
    explicit = flash_attention_bwd(*leaves, again, lse, do, kv_lens)
    equal = torch.equal(out, again) and all(
        torch.equal(a, b) for a, b in zip(auto, explicit))
    emit("kernel", kernel="flash_attention_bwd", case="autograd",
         autograd_equals_explicit=equal)
    check(equal, "autograd through flash_attention differs from its backward")
    return errors


def _time_kernel(name, fn, plain, library, nbytes, flops, dtype, replaces,
                 source, shape, library_name, plain_chunk=None, iters=50,
                 phase="timing", executed_flops=None):
    """One row of the kernels line. Every time is of the same inputs: the
    kernel's and the library call's are device time (the median of 5
    windows of ``iters`` calls, with the fastest and slowest window,
    ``device_timing``), the plain version's one event window, host time
    included; ``plain_chunk`` notes that the plain version went over the
    batch in chunks of that many rows, one call each. ``executed_flops``,
    the products the kernel's design runs, adds their rate to the phase
    line (not to the row)."""
    kernel = device_timing(fn, iters)
    plain_ms = event_ms(plain, 3 if plain_chunk else 5, warmup=1 if plain_chunk else 3)
    library = device_timing(library, iters)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        ms=kernel.median, ms_range=[kernel.low, kernel.high],
        plain_ms=plain_ms, plain_chunk=plain_chunk,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library.median, library_ms_range=[library.low, library.high],
    )
    executed = {} if executed_flops is None else dict(
        executed_flops=executed_flops,
        executed_tflops=executed_flops / (kernel.median * 1e-3) / 1e12)
    emit(phase, shape=shape, dtype=str(dtype), bytes=nbytes, flops=flops,
         library=library_name, **row, **executed,
         ms_by_kernel={k[:80]: v for k, v in kernel.by_kernel.items()})
    return row


def phase_timing() -> dict:
    """Kernel #1 at the sampler shape; kernels #1 and #2 at the training
    step's shape (its blocks 4-11: S = 298). Returns the training rows."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
        short_attention_packed_bwd_reference,
        short_attention_packed_reference,
        short_attention_packed_with_lse,
    )

    heads, dim, dtype = 12, 64, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, batch, s in (("sampler", 16, 266), ("train", TRAIN_BATCH, 298)):
        q, k, v = _attention_inputs(gen, batch, s, s, heads, dim, dtype)
        qh, kh, vh = (x.view(batch, s, heads, dim).transpose(1, 2) for x in (q, k, v))
        size = q.numel() * q.element_size()
        attn_flops = 2 * batch * heads * s * s * dim  # one (S, S, D) product
        rows[label] = _time_kernel(
            "short_attention_packed",
            lambda: short_attention_packed(q, k, v, heads, bounded=True),
            lambda: short_attention_packed_reference(q, k, v, heads, bounded=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4 * size, 2 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:462",
            "vision_pt_tpu_torch/csrc/short_attention.cu",
            [label, batch, s, s, heads, dim], "F.scaled_dot_product_attention",
        )
        if label != "train":
            continue
        # the forward as a training step runs it: with its row log-sum-exp
        rows["train_lse"] = _time_kernel(
            "short_attention_packed_with_lse",
            lambda: short_attention_packed_with_lse(q, k, v, heads, bounded=True),
            lambda: short_attention_packed_reference(q, k, v, heads, bounded=True,
                                                     return_lse=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4 * size + 4 * batch * heads * s, 2 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:462",
            "vision_pt_tpu_torch/csrc/short_attention.cu",
            [label, batch, s, s, heads, dim], "F.scaled_dot_product_attention",
        )
        do = torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
        out, lse = short_attention_packed_with_lse(q, k, v, heads, bounded=True)
        leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        doh = do.view(batch, s, heads, dim).transpose(1, 2)
        rows["train_bwd"] = _time_kernel(
            "short_attention_packed_bwd",
            lambda: short_attention_packed_bwd(q, k, v, lse, do, heads,
                                               bounded=True),
            lambda: short_attention_packed_bwd_reference(q, k, v, lse, do,
                                                         heads, bounded=True),
            lambda: torch.autograd.grad(sdpa_out, leaves, doh, retain_graph=True),
            7 * size, 5 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:493",
            "vision_pt_tpu_torch/csrc/short_attention_bwd.cu",
            [label, batch, s, s, heads, dim],
            "torch.autograd.grad of F.scaled_dot_product_attention",
        )
    return rows


# (S, S, D) products that kernel #8 runs: s and dp in both of its launches,
# then dq; dv and dk (the function needs 5)
FLASH_BWD_PRODUCTS = 7

# kernels #7 and #8's timed shapes (bf16, no kv_lens; label, B, S, H, D,
# whether #8 is timed too): the latent trainer's, the SDXL sampler's and
# trainer's two self-attentions at 1024^2 (B 2: CFG, or the training batch),
# RoPE distillation's low-res pass at 512^2 (stage 2: S 1024, 10 heads), the
# CogView4 sampler's joint attention (forward only: no trainer), and the
# inference server's: a group of 8 at 1024^2 under CFG (B 16) in stages 2
# and 3, and the default 768 x 1024 request's stage 2 (S 3072; its stage 3,
# S 768, is under MIN_FLASH_SEQ), forward only
FLASH_TIMING_SHAPES = (("latent", LATENT_BATCH, 4106, 12, 64, True),
                       ("sdxl_s4096", 2, 4096, 10, 64, True),
                       ("sdxl_s1024", 2, 1024, 20, 64, True),
                       ("sdxl_lowres_s1024", 2, 1024, 10, 64, True),
                       ("cogview4_s4112", 2, 4112, 32, 128, False),
                       ("server_s4096", 16, 4096, 10, 64, False),
                       ("server_s1024", 16, 1024, 20, 64, False),
                       ("server_s3072", 2, 3072, 10, 64, False))


def phase_flash_timing() -> dict:
    """Kernels #7 and #8 at each of FLASH_TIMING_SHAPES, keyed by label (the
    backward as ``<label>_bwd``); their plain versions on
    the same inputs in calls of batch 2, whose (B, H, S, S) fp32 tensors are
    1.6 GB each at the latent shape (12.9 GB at batch 16)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_attention_with_lse,
    )

    dtype, chunk = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    library = "F.scaled_dot_product_attention (FLASH_ATTENTION backend)"
    rows = {}
    for label, batch, s, heads, dim, backward in FLASH_TIMING_SHAPES:
        q, k, v, do = (_bshd(gen, batch, s, heads, dim, dtype) for _ in range(4))
        out, lse = flash_attention_with_lse(q, k, v)
        chunks = [[x[i:i + chunk] for x in (q, k, v, out, lse, do)]
                  for i in range(0, batch, chunk)]
        plain_chunk = chunk if batch > chunk else None
        size = q.numel() * q.element_size()
        lse_bytes = lse.numel() * lse.element_size()
        product = 2 * batch * heads * s * s * dim  # one (S, S, D) product
        qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
        shape = [label, batch, s, s, heads, dim]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            rows[label] = _time_kernel(
                "flash_attention",
                lambda: flash_attention_with_lse(q, k, v),
                lambda: [flash_attention_reference(*c[:3]) for c in chunks],
                lambda: F.scaled_dot_product_attention(qh, kh, vh),
                4 * size + lse_bytes, 2 * product, dtype,
                "vision_pt_tpu/ops/flash_attention.py:115",
                "vision_pt_tpu_torch/csrc/flash_attention.cu", shape, library,
                plain_chunk=plain_chunk, iters=20, executed_flops=2 * product,
            )
            if backward:
                leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
                sdpa_out = F.scaled_dot_product_attention(*leaves)
                rows[f"{label}_bwd"] = _time_kernel(
                    "flash_attention_bwd",
                    lambda: flash_attention_bwd(q, k, v, out, lse, do),
                    lambda: [flash_attention_bwd_reference(*c) for c in chunks],
                    lambda: torch.autograd.grad(sdpa_out, leaves, doh,
                                                retain_graph=True),
                    8 * size + lse_bytes, 5 * product, dtype,
                    "vision_pt_tpu/ops/flash_attention.py:325",
                    "vision_pt_tpu_torch/csrc/flash_attention_bwd.cu", shape,
                    "torch.autograd.grad of " + library, plain_chunk=plain_chunk,
                    iters=20, executed_flops=FLASH_BWD_PRODUCTS * product,
                )
                del leaves, sdpa_out
        del q, k, v, do, out, lse, chunks, qh, kh, vh, doh
        torch.cuda.empty_cache()
    return rows


def _wrappers():
    """The kernel wrappers, in the order of every launch-count tuple:
    kernels #1-#11 (packed forward and backward, the short backend's BSHD
    and BHSD forwards and backwards, flash forward and backward, NF4
    dequant-matmul, the two attention probes)."""
    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import dequant_matmul_4bit
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention,
        short_attention_bhsd,
        short_attention_bhsd_bwd,
        short_attention_bwd,
        short_attention_packed,
        short_attention_packed_bwd,
    )
    from vision_pt_tpu_torch.tools.bench.attention_pairing_probe import run_variant
    from vision_pt_tpu_torch.tools.bench.attention_roofline import dots_variant

    return (short_attention_packed, short_attention_packed_bwd, short_attention,
            short_attention_bwd, short_attention_bhsd, short_attention_bhsd_bwd,
            flash_attention, flash_attention_bwd, dequant_matmul_4bit,
            run_variant, dots_variant)


def _reset_counts():
    for fn in _wrappers():
        fn.launches = 0


def _counts() -> tuple[int, ...]:
    return tuple(fn.launches for fn in _wrappers())


def _diff(after, before) -> tuple[int, ...]:
    return tuple(a - b for a, b in zip(after, before))


def _jit_b16_config(label2id: str, dtype: str):
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig

    return JiTConfig(
        context_encoder={"type": "class", "label2id_map_path": label2id},
        denoiser=JiT_B_16_Config(), dtype=dtype,
    )


def phase_sampler(label2id: str) -> tuple[int, ...]:
    from vision_pt_tpu_torch.models.jit import JiTModel

    t0 = time.perf_counter()
    model = JiTModel.new_with_config(_jit_b16_config(label2id, "bfloat16"), seed=0)
    build_s = time.perf_counter() - t0

    def request(seed):
        return model.generate(prompt=["c1"] * BATCH, width=256, height=256,
                              num_inference_steps=STEPS, cfg_scale=2.0,
                              seed=seed, return_arrays=True)

    request(100)  # warm-up: allocator, cuBLAS handles, rotary tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    seconds, per_request = [], []
    for i in range(REQUESTS):
        before = _counts()[0]
        t0 = time.perf_counter()
        out = request(i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_request.append(_counts()[0] - before)
        check(tuple(out.shape) == (BATCH, 256, 256, 3), f"shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite image")
    launches, bwd_launches, *others = _counts()
    emit("sampler", model="JiT-B/16", resolution=256, batch=BATCH, cfg=True,
         steps=STEPS, build_seconds=round(build_s, 3), request_seconds=seconds,
         steps_per_second=[STEPS / s for s in seconds],
         kernel_launches_per_request=per_request, bwd_launches=bwd_launches,
         other_launches=others,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    check(per_request == [LAUNCHES_PER_REQUEST] * REQUESTS and bwd_launches == 0
          and others == [0] * len(others),
          f"packed kernel launches per request {per_request} (backward "
          f"{bwd_launches}, kernels #3-#11 {others}), expected "
          f"{LAUNCHES_PER_REQUEST} (0)")
    profile("sampler", lambda: request(7))
    return launches, bwd_launches, *others


def profile(path: str, run):
    """Where the device time of one run of ``path`` goes (torch.profiler,
    the device traced alone: with the host's ops too, the profiler's own
    processing took 3-55 s a profile and ≈ 170 s of a whole run, which then
    ended 30 s short of its 1,200 s limit); returns what the run returns.
    The kernels are summed from the profiler's raw results: its own parse
    into events (``key_averages``) took up to a minute for a step of tens of
    thousands of kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels by name, less the ranges of annotated regions on the
    # device's timeline (e.g. "Optimizer.step#...", which spans the update)
    kernels: dict[str, list] = {}
    for event in prof.profiler.kineto_results.events():
        if event.device_type() != DeviceType.CUDA or event.is_user_annotation():
            continue
        if event.duration_ns() > 0:
            total = kernels.setdefault(event.name(), [0, 0])
            total[0] += event.duration_ns()
            total[1] += 1
    device_ns = sum(ns for ns, _ in kernels.values())

    def rows(names, n):
        top = sorted(names, key=lambda name: -kernels[name][0])[:n]
        return [{"name": name[:60], "device_ms": kernels[name][0] / 1e6,
                 "count": kernels[name][1]} for name in top]

    emit("profile", path=path, wall_seconds=wall, device_kernel_seconds=device_ns / 1e9,
         device_busy_share=(device_ns / 1e9) / wall,
         port_kernels=rows([k for k in kernels if PORT_KERNEL.search(k)], 8),
         top_kernels=rows(kernels, 8))
    return result


def phase_train_step() -> tuple[int, ...]:
    """``bench_headline``'s step (vision_pt_tpu/benchmarks.py:83-135) in the
    port, as ``vision_pt_tpu_torch.benchmarks._jit_train_setup`` builds it;
    returns the kernel launches of the timed steps."""
    from vision_pt_tpu_torch.benchmarks import CONTEXT_LEN, _jit_train_setup
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config

    batch = TRAIN_BATCH
    model, optimizer, step = _jit_train_setup(
        JiT_B_16_Config(), batch, 256, dtype=torch.bfloat16,
        param_dtype=torch.float32)
    step(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(1, TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TIMED_STEPS
    counts = _counts()
    fwd, bwd = counts[:2]
    losses = [float(x) for x in losses]
    emit("train_step", model="JiT-B/16", resolution=256, batch=batch,
         context_tokens=CONTEXT_LEN, compute="bfloat16", params="float32",
         optimizer="adamw 1e-4", timed_steps=TIMED_STEPS,
         seconds_per_step=seconds, images_per_second=batch / seconds,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         fwd_launches_per_step=fwd / TIMED_STEPS,
         bwd_launches_per_step=bwd / TIMED_STEPS)
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(counts == _expect({1: 12 * TIMED_STEPS, 2: 12 * TIMED_STEPS}),
          f"kernel launches {counts} over {TIMED_STEPS} steps, "
          "expected 12 + 12 packed per step and no flash")
    profile("train_step", lambda: step(TIMED_STEPS + 1))
    del model, optimizer, step
    torch.cuda.empty_cache()
    return counts


TRAINER_STEPS = 6  # 2 epochs of 3 batches


def phase_trainer(tmp: str) -> tuple[tuple[int, ...], dict]:
    """The port's entry point on the synthetic config at JiT-B/16 width;
    returns the kernel launches of the whole run (steps and preview), and
    the config, losses, launches, step times and saved files that
    ``mesh_trainer`` holds its run against."""
    import yaml

    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig, JiTModel
    from vision_pt_tpu_torch.train.jit.class_to_image import run
    from vision_pt_tpu_torch.training.trainer import Trainer

    with open(os.path.join(ROOT, "configs/jit/synthetic_class_to_image.yml")) as f:
        cfg = yaml.safe_load(f)
    label2id = os.path.join(tmp, "trainer_label2id.json")
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    model_cfg = cfg["model"]
    model_cfg["context_encoder"]["label2id_map_path"] = label2id
    model_cfg["denoiser"] = JiT_B_16_Config().model_dump()
    model_cfg["dtype"] = "bfloat16"
    model_cfg["max_token_length"] = 64
    cfg["dataset"].update(num_items=TRAINER_STEPS // 2 * TRAIN_BATCH, image_size=256,
                          batch_size=TRAIN_BATCH)
    cfg["scheduler"]["args"]["num_warmup_steps"] = 1
    cfg["saving"]["strategy"] = {"per_epochs": None}  # the final save only
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(tmp, "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(tmp, "preview")
    cfg["preview"]["data"]["data"][0].update(width=256, height=256)
    cfg["tracker"]["log_dir"] = os.path.join(tmp, "logs")
    # torch's deterministic algorithms: the class embedding's backward sums
    # its 64 x 64 rows without atomics, so mesh_trainer's run in another
    # process can give this run's bits (two runs without it differ in that
    # table's last bits, and Adam carries the difference everywhere)
    cfg["trainer"]["deterministic"] = True
    path = os.path.join(tmp, "trainer.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    per_step, step_seconds = [], []
    inner = Trainer.train_step

    def counting(self, *args, **kwargs):
        before = _counts()
        t0 = time.perf_counter()
        if len(per_step) == 3:  # the last step runs under the profiler
            out = profile("trainer", lambda: inner(self, *args, **kwargs))
        else:
            out = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), before))
        return out

    Trainer.train_step = counting
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
    seconds = time.perf_counter() - t0
    counts = _counts()
    with open(os.path.join(tmp, "logs", "verify_run.metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    saved = sorted(os.listdir(os.path.join(tmp, "out")))
    previews = os.listdir(os.path.join(tmp, "preview"))
    loaded = JiTModel.from_pretrained(
        JiTConfig.model_validate(model_cfg),
        os.path.join(tmp, "out", [n for n in saved if not n.startswith("ema_")][0]),
    )
    expected = trainer.model.model.state_dict()
    reloaded = all(torch.equal(v, expected[k]) for k, v in loaded.state_dict().items())
    emit("trainer", config="configs/jit/synthetic_class_to_image.yml",
         model="JiT-B/16", resolution=256, batch=TRAIN_BATCH, deterministic=True,
         steps=trainer.global_step, run_seconds=seconds,
         step_seconds=step_seconds, losses=losses,
         launches_per_step=per_step, run_launches=counts, saved=saved,
         previews=len(previews), reloaded=reloaded,
         qk_logit_bound=[r.get("train/qk_logit_bound") for r in records
                         if "train/loss" in r])
    check(trainer.global_step == TRAINER_STEPS and len(losses) == TRAINER_STEPS
          and all(np.isfinite(losses)), f"trainer losses {losses}")
    check(per_step == [_expect({1: 4, 2: 4})] * TRAINER_STEPS,
          f"launches per step {per_step}, expected 4 + 4 packed, no flash")
    check(len(saved) == 2 and len(previews) == 1 and reloaded,
          f"saved {saved}, previews {previews}, reloaded {reloaded}")
    del trainer, loaded
    torch.cuda.empty_cache()
    _trainer_resume(tmp, cfg, losses)
    run = {"cfg": cfg, "losses": losses, "per_step": per_step,
           "step_seconds": step_seconds, "out": os.path.join(tmp, "out"),
           "step_time": [r["train/step_time"] for r in records if "train/step_time" in r]}
    return counts, run


def _trainer_resume(tmp: str, cfg: dict, unbroken: list[float]) -> None:
    """The trainer run again with train-state checkpointing, stopped by a
    SIGTERM during step 2, then resumed from its checkpoint: steps 3-6 must
    give the unbroken run's losses within RESUME_REL_TOL."""
    import signal

    import yaml

    from vision_pt_tpu_torch.train.jit.class_to_image import run
    from vision_pt_tpu_torch.training.trainer import Trainer

    cfg = json.loads(json.dumps(cfg))
    cfg.update(saving=None, preview=None, tracker=None)
    cfg["trainer"]["checkpointing"] = {"save_dir": os.path.join(tmp, "train_state"),
                                       "resume": True}
    path = os.path.join(tmp, "trainer_resume.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    losses, kill, inner = [], [True], Trainer.train_step

    def recording(self, *args, **kwargs):
        if kill[0] and self.global_step == 1:  # during step 2
            os.kill(os.getpid(), signal.SIGTERM)
        loss, metrics = inner(self, *args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    Trainer.train_step = recording
    t0 = time.perf_counter()
    try:
        killed = run(path)
        stopped_at, preempted = killed.global_step, killed._preempted
        saved = killed.checkpointer.all_steps()
        del killed
        torch.cuda.empty_cache()
        kill[0] = False
        losses.clear()
        resumed = run(path)
    finally:
        Trainer.train_step = inner
    seconds = time.perf_counter() - t0
    resumed_losses = list(losses)
    gaps = [abs(a - b) / abs(b) for a, b in zip(resumed_losses, unbroken[2:])]
    emit("trainer", case="resume", stopped_at_step=stopped_at, preempted=preempted,
         checkpoints=saved, resumed_steps=resumed.global_step,
         losses_resumed=resumed_losses, losses_unbroken=unbroken[2:],
         rel_gap=gaps, tolerance=RESUME_REL_TOL, seconds=seconds)
    check(preempted and stopped_at == 2 and saved == [2],
          f"SIGTERM in step 2: stopped at {stopped_at}, checkpoints {saved}")
    check(resumed.global_step == TRAINER_STEPS
          and len(resumed_losses) == TRAINER_STEPS - 2 and max(gaps) <= RESUME_REL_TOL,
          f"resumed losses {resumed_losses} against {unbroken[2:]}")
    del resumed
    torch.cuda.empty_cache()


# a resumed run's losses against the unbroken run's: the same arithmetic on
# the same card; the slack covers kernels whose reductions may reorder
RESUME_REL_TOL = 1e-3

# the mesh run's losses against the trainer phase's: one rank, so the same
# arithmetic in another process
MESH_LOSS_RTOL = 1e-5
MESH_PROFILE_STEPS = 2


def _trace_launches(path: str) -> tuple[int, int, int]:
    """Launches of the attention forward, its backward and the NF4 kernel
    in a chrome trace of the trainer's profiler: the forward (#1 in JiT, #7
    in SDXL: their template ``attn_fwd_``), the backward (#2 / #8: a pair,
    dq then dk / dv, counted by its dq kernel) and #9 (``nf4_matmul_``,
    followed by a reduce kernel when it splits K)."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return (sum("attn_fwd_" in n for n in names),
            sum("attn_bwd_dq_" in n for n in names),
            sum("nf4_matmul_kernel" in n for n in names))


def phase_mesh_trainer(tmp: str, no_mesh: dict) -> dict:
    """The trainer phase's config through ``torchrun`` with the mesh, the
    distributed init and the profiler; its losses, files and launches
    against the trainer phase's run."""
    import yaml
    from safetensors.torch import load_file

    work = os.path.join(tmp, "mesh")
    cfg = json.loads(json.dumps(no_mesh["cfg"]))
    cfg["trainer"].update(mesh={"data": 1, "fsdp": 1, "tensor": 1, "seq": 1},
                          distributed_init=True, profile_dir=os.path.join(work, "profile"),
                          profile_steps=MESH_PROFILE_STEPS)
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(work, "preview")
    cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "trainer.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    command = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "vision_pt_tpu_torch.train.jit.class_to_image",
               "--config", path]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    log = os.path.join(work, "run.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(command, cwd=ROOT, env=env, stdout=f,
                              stderr=subprocess.STDOUT, timeout=600)
    seconds = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    check(proc.returncode == 0, f"torchrun exit {proc.returncode}: {text[-3000:]}")
    group = re.search(r"\[distributed\] (\w+) group: rank (\d+) of (\d+), device (\S+)",
                      text)
    with open(os.path.join(work, "logs", "verify_run.metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    step_time = [r["train/step_time"] for r in records if "train/step_time" in r]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, no_mesh["losses"])]
    trace = os.path.join(work, "profile", "trace_rank0.json")
    fwd, bwd, _ = _trace_launches(trace) if os.path.exists(trace) else (0, 0, 0)
    saved = sorted(os.listdir(os.path.join(work, "out")))
    theirs = sorted(os.listdir(no_mesh["out"]))
    previews = os.listdir(os.path.join(work, "preview"))
    equal = {}
    for ours_name, theirs_name in zip(saved, theirs):
        a = load_file(os.path.join(work, "out", ours_name))
        b = load_file(os.path.join(no_mesh["out"], theirs_name))
        equal[ours_name] = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    no_mesh_fwd, no_mesh_bwd = no_mesh["per_step"][0][:2]
    emit("mesh_trainer", command=" ".join(command[1:]), config="the trainer phase's",
         mesh=cfg["trainer"]["mesh"], group=group.groups() if group else None,
         run_seconds=seconds, losses=losses, losses_no_mesh=no_mesh["losses"],
         rel_gap=gaps, tolerance=MESH_LOSS_RTOL,
         step_time=step_time, step_time_no_mesh=no_mesh["step_time"],
         seconds_per_step=float(np.mean(step_time[1:])),
         seconds_per_step_no_mesh=float(np.mean(no_mesh["step_time"][1:])),
         trace=os.path.basename(trace), profiled_steps=MESH_PROFILE_STEPS,
         trace_launches={"fwd": fwd, "bwd": bwd},
         launches_per_step_no_mesh={"fwd": no_mesh_fwd, "bwd": no_mesh_bwd},
         saved=saved, saved_no_mesh=theirs, files_equal=equal, previews=len(previews))
    check(group is not None and group.group(1) == "nccl"
          and group.groups()[1:3] == ("0", "1"), f"process group {group and group.groups()}")
    check(len(losses) == len(no_mesh["losses"]) == TRAINER_STEPS
          and max(gaps) <= MESH_LOSS_RTOL,
          f"mesh losses {losses} against {no_mesh['losses']}")
    check(no_mesh_fwd > 0 and no_mesh_bwd > 0 and fwd == MESH_PROFILE_STEPS * no_mesh_fwd
          and bwd == MESH_PROFILE_STEPS * no_mesh_bwd,
          f"the trace's #1 / #2 launches {fwd} / {bwd} over {MESH_PROFILE_STEPS} "
          f"steps, the trainer phase's {no_mesh_fwd} / {no_mesh_bwd} a step")
    check(len(saved) == len(theirs) == 2 and all(equal.values()),
          f"saved {saved} against {theirs}: equal {equal}")
    # the trainer phase's preview, sampled under the mesh
    check(len(previews) == 1, f"mesh previews {previews}")
    return {"fwd": fwd, "bwd": bwd, "run_seconds": seconds}


def start_latent_mesh_trainer(tmp: str, no_mesh: dict) -> dict:
    """Start ``latent_mesh_trainer``'s torchrun process (it runs beside
    ``mesh_trainer``'s, so the two processes' start-up and load overlap);
    ``phase_latent_mesh_trainer`` waits for it."""
    torch.cuda.empty_cache()  # the card for the torchrun processes
    script = os.path.join(tmp, "latent_mesh_entry.py")
    with open(script, "w") as f:
        f.write(MESH_ENTRY_SCRIPT.format(entry="jit.latent_class_to_image"))
    mesh = {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    return _mesh_start(tmp, "latent", no_mesh, script, mesh, MESH_PROFILE_STEPS)


def phase_latent_mesh_trainer(started: dict, no_mesh: dict, beside: dict) -> dict:
    """The latent_trainer phase's run (``configs/jit/latent_arb_1024.yml`` as
    shipped, its paths rewritten, ``trainer.deterministic``) through
    ``torchrun`` on the latent entry point with a one-rank mesh over all four
    axes, the distributed init and the profiler over MESH_PROFILE_STEPS
    steps: its losses and saved file bit for bit, and the #7 / #8 launches of
    the trace against the latent_trainer phase's per step. ``beside`` is
    ``mesh_trainer``'s result: the seconds this run adds to the card's path
    are those past that run's."""
    r = _mesh_result(started, no_mesh)
    check(r["exit"] == 0, f"latent_mesh_trainer: torchrun exit {r['exit']}: {r['log_tail']}")
    steady = r["step_time"][1:]
    emit("latent_mesh_trainer", config="configs/jit/latent_arb_1024.yml (the latent_trainer "
         "phase's: depth 24, hidden 768, batch 16, S 4170)",
         beside="mesh_trainer's torchrun run, started together: the two processes' host-bound "
                "step times share the host",
         added_seconds=r["run_seconds"] - beside["run_seconds"],
         mesh_trainer_run_seconds=beside["run_seconds"],
         **{k: v for k, v in r.items() if k != "log_tail"},
         bit_equal=r["losses"] == no_mesh["losses"],
         seconds_per_step=float(np.mean(steady)) if steady else None,
         seconds_per_step_no_mesh=float(np.mean(no_mesh["step_seconds"][1:3])),
         expected_per_step={"#7": LATENT_STEP_LAUNCHES[6], "#8": LATENT_STEP_LAUNCHES[7]})
    group = r["group"]
    check(group is not None and group[0] == "nccl" and group[1:3] == ("0", "1"),
          f"latent_mesh_trainer: process group {group}")
    check(len(r["losses"]) == len(no_mesh["losses"]) == 4
          and r["losses"] == no_mesh["losses"],
          f"latent_mesh_trainer: losses {r['losses']} against {no_mesh['losses']}")
    check(r["trace_launches"] == r["expected_launches"] == {
              "#7": MESH_PROFILE_STEPS * LATENT_STEP_LAUNCHES[6],
              "#8": MESH_PROFILE_STEPS * LATENT_STEP_LAUNCHES[7], "#9": 0},
          f"latent_mesh_trainer: the trace's launches {r['trace_launches']}, expected "
          f"{MESH_PROFILE_STEPS} x 48 / 24")
    check(len(r["saved"]) == len(r["saved_no_mesh"]) == 1 and all(r["files_equal"].values()),
          f"latent_mesh_trainer: saved {r['saved']} against {r['saved_no_mesh']}: "
          f"equal {r['files_equal']}")
    return r


RING_SHAPE = (2, 4096, 16, 64)  # B, S, H, D
RING_KV_LENS = (4096, 1000)


def phase_ring() -> dict:
    """Ring attention over a one-rank NCCL seq group against plain
    attention, and its device time beside #7 / #8 on the same inputs."""
    import torch.distributed as dist

    from vision_pt_tpu_torch.ops.attention import plain_attention
    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_with_lse,
    )
    from vision_pt_tpu_torch.ops.ring_attention import ring_attention
    from vision_pt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "fsdp": 1, "tensor": 1, "seq": 1})
    backend = dist.get_backend()
    seq = mesh["seq"]
    b, s, h, d = RING_SHAPE
    dtype, tol = torch.bfloat16, ATTN_TOL[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (_bshd(gen, b, s, h, d, dtype) for _ in range(4))
    lens = torch.tensor(RING_KV_LENS, device="cuda", dtype=torch.int32)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = ring_attention(*leaves, seq, kv_lens=lens)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = plain_attention(*ref_leaves, kv_lens=lens)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    err, share, ok = _agree([_compare(o, r, tol) for o, r in
                             zip((out, *grads), (ref, *ref_grads))])
    short = RING_KV_LENS[1]
    zero_past = bool((grads[1][1, short:] == 0).all() and (grads[2][1, short:] == 0).all())
    del ref_leaves, ref, ref_grads
    torch.cuda.empty_cache()

    def forward():
        return ring_attention(q, k, v, seq, kv_lens=lens)

    def forward_backward():
        o = ring_attention(*leaves, seq, kv_lens=lens)
        return torch.autograd.grad(o, leaves, do)

    flash_out, flash_lse = flash_attention_with_lse(q, k, v, lens)
    ring_fwd = device_timing(forward, 3)
    ring_fwd_bwd = device_timing(forward_backward, 3)
    flash_fwd = device_timing(lambda: flash_attention_with_lse(q, k, v, lens), 10)
    flash_bwd = device_timing(
        lambda: flash_attention_bwd(q, k, v, flash_out, flash_lse, do, lens), 10)
    emit("ring", shape=list(RING_SHAPE), dtype=str(dtype), kv_lens=list(RING_KV_LENS),
         group_backend=backend, seq_ranks=seq.size(),
         point_to_point="none: one rank holds every block",
         reference="plain_attention in fp32 on the same inputs", max_abs_err=err,
         limit_share=share, tolerance=tol, key_grads_zero_past_kv_len=zero_past,
         ms_forward=ring_fwd.median, ms_forward_backward=ring_fwd_bwd.median,
         flash_ms_forward=flash_fwd.median, flash_ms_backward=flash_bwd.median,
         flash_ms_forward_backward=flash_fwd.median + flash_bwd.median)
    check(backend == "nccl" and seq.size() == 1, f"seq group {backend}, {seq.size()} ranks")
    check(ok and zero_past, f"ring attention against plain: max err {err}, "
          f"limit share {share}, key gradients past kv_len zero: {zero_past}")
    del q, k, v, do, leaves, out, grads, flash_out, flash_lse
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"max_abs_err": err}


def _cpu_step(model: str, dtype: str, label2id: str, loss_scale: float,
              depth: int | None, batch: int):
    """A worker job: one step of ``tools.bench.step_parity`` on the CPU
    (plain versions); (loss, gradients as arrays, seconds, launches)."""
    from vision_pt_tpu_torch.tools.bench.step_parity import step

    _reset_counts()
    host = step(model, dtype, "cpu", label2id, loss_scale=loss_scale, depth=depth,
                batch=batch)
    return host.loss, {n: g.numpy() for n, g in host.grads.items()}, host.seconds, _counts()


def _step_args(model: str, dtype: str, depth: int | None, label2id: str) -> tuple:
    """The arguments of one parity step: fp16 at batch 1 (the first of the
    two samples), the others at 2; the fp16 loss scaled by LOSS_SCALE."""
    return (model, dtype, label2id, LOSS_SCALE.get(dtype, 1.0), depth,
            1 if dtype == "float16" else 2)


def _step_parity(phase: str, model: str, label2id: str, cases, **fields) -> None:
    """One training step of ``model`` (``tools.bench.step_parity``) on the
    card (kernels), and on the CPU (plain versions) in the worker, for each
    (dtype, depth or None for the model's, launches) of ``cases``, held to
    TRAIN_PARITY_FLOOR when both are in; the card step must launch
    ``launches``."""
    from vision_pt_tpu_torch.tools.bench.step_parity import (
        Step,
        grad_errors,
        step,
        summary,
    )

    for dtype, depth, launches, *cut in cases:
        args = _step_args(model, dtype, depth, label2id)
        batch = args[-1]
        future = _HALVES.take((model, dtype), f"{phase} {dtype}", _cpu_step, *args)
        _reset_counts()
        card = step(model, dtype, "cuda", label2id, loss_scale=args[3], depth=depth,
                    batch=batch)
        counts_c = _counts()
        check(all(bool(torch.isfinite(g).all()) for g in card.grads.values()),
              "non-finite grads")
        check(counts_c == launches, f"the card step must launch {launches} ({counts_c})")

        def finish(result, where, dtype=dtype, depth=depth, batch=batch, card=card,
                   counts_c=counts_c, cut=cut):
            loss, grads, seconds, counts_h = result
            host = Step(loss, {n: torch.from_numpy(g) for n, g in grads.items()}, seconds)
            loss_err = abs(card.loss - host.loss) / abs(host.loss)
            errors = summary(grad_errors(card.grads, host.grads))
            floor = TRAIN_PARITY_FLOOR[dtype]
            if batch != 2:
                total = FP16_BATCH2_CPU_SECONDS[model]
                cut = [*cut, f"batch 1, not 2: ≈ {total - host.seconds:.0f} s saved (the "
                       f"CPU half {host.seconds:.0f} s, {total} s at batch 2)"]
            emit(phase, dtype=dtype, batch=batch, depth=depth, cuts=cut, **fields,
                 **where, loss_scale=LOSS_SCALE.get(dtype, 1.0), loss_cuda=card.loss,
                 loss_cpu=host.loss, loss_rel_err=loss_err,
                 grad_rel_l2_max=errors["max"], grad_rel_l2_median=errors["median"],
                 worst_params=errors["worst"], floor=floor, launches_cuda=counts_c,
                 launches_cpu=counts_h, seconds_cuda=card.seconds,
                 seconds_cpu=host.seconds)
            check(counts_h == _expect({}), f"the CPU step launched {counts_h}")
            check(loss_err <= floor["loss"] and errors["max"] <= floor["grad"],
                  f"{dtype} {phase}: loss {loss_err:.2e}, grad {errors['worst'][0]}")

        _HALVES.then(future, finish)
        del card
        torch.cuda.empty_cache()


# fp16 parity steps at reduced size: the card's host has no fast fp16 matrix
# path (a 1024^3 product 2.98 s, bf16 0.013 s, measured on the host of one
# NVIDIA H100 80GB HBM3 at 700 W), so the CPU side of an fp16 step took 150 s
# (JiT-B/16) and 300 s (latent, depth 6). JiT needs a depth over
# context_start_block (4), or the class encoder gets no gradient: depths 5
# and 1, the least that keep each model's structure, and batch 1, the first
# sample of the two (the fp32 and bf16 steps keep batch 2)
FP16_PARITY_DEPTH = {"jit": 5, "latent": 1}
# the fp16 CPU halves at batch 2 (seconds, on the same host): 75.4 and 87.3
FP16_BATCH2_CPU_SECONDS = {"jit": 75, "latent": 87}
# the latent fp32 and bf16 steps at 2 blocks, not 6 (their CPU halves
# took 5 and 7 s at depth 6)
LATENT_PARITY_DEPTH = 2


# (model, dtype, depth) of each parity step, fp16 at FP16_PARITY_DEPTH
STEP_PARITY_CASES = (("jit", "float32", None), ("jit", "bfloat16", None),
                     ("jit", "float16", FP16_PARITY_DEPTH["jit"]),
                     ("latent", "float32", LATENT_PARITY_DEPTH),
                     ("latent", "bfloat16", LATENT_PARITY_DEPTH),
                     ("latent", "float16", FP16_PARITY_DEPTH["latent"]))


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for fp32 matmuls (precision "highest") and cuDNN
    convolutions, restored after: the card-vs-CPU phases' floors hold fp32
    products at full precision, and every other phase runs as a user's run
    does (torch's defaults, or what its trainer config sets). Matmuls go
    through ``set_float32_matmul_precision``: a trainer config sets that
    ("high"), and torch refuses to read it once the legacy matmul switch
    disagrees. Also a decorator (``@_tf32_off()``)."""
    precision, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def phase_train_parity(label2id: str) -> None:
    """One JiT-B/16 training step's loss and gradients on the card and on
    the CPU (#1/#2 at S 298, blocks 0-3; fp16 at depth 5, batch 1)."""
    launches = _expect({1: 4, 2: 4})
    _step_parity("train_parity", "jit", label2id,
                 [(dtype, depth, launches) for model, dtype, depth in STEP_PARITY_CASES
                  if model == "jit"])


def _jit_sample(label2id: str, dtype: str, device: str):
    """The JiT-B/16 sampler from seed 0 on ``device``, batch 1, CFG, 2
    steps, from fixed noise; (output, launches of #1)."""
    from vision_pt_tpu_torch.models.jit import JiTModel
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    init = np.random.default_rng(0).normal(size=(1, 256, 256, 3)).astype(np.float32)
    model = JiTModel.new_with_config(_jit_b16_config(label2id, dtype), seed=0,
                                     device=device)
    _reset_counts()
    with attention_dtype(None if dtype == "float32" else torch.bfloat16):
        out = model.generate(
            prompt=["c1"], width=256, height=256, num_inference_steps=2,
            cfg_scale=2.0, execution_dtype=getattr(torch, dtype),
            initial_noise=init, return_arrays=True,
        )
    return out.float().cpu().numpy(), _counts()[0]


@_tf32_off()
def phase_parity(label2id: str) -> None:
    for dtype in ("float32", "bfloat16"):
        future = _HALVES.take(("parity", dtype), f"parity {dtype}", _jit_sample,
                              label2id, dtype, "cpu")
        card = _jit_sample(label2id, dtype, "cuda")
        check(np.isfinite(card[0]).all(), "non-finite parity output")
        check(card[1] == 4 * 2, "the card run must launch the kernel 8 times")

        def finish(host, where, dtype=dtype, card=card):
            value = psnr(card[0], host[0])
            emit("parity", dtype=dtype, batch=1, cfg=True, steps=2, **where,
                 psnr_db=value, floor_db=PSNR_FLOOR_DB[dtype],
                 kernel_launches_cuda=card[1], kernel_launches_cpu=host[1])
            check(host[1] == 0, "the CPU run must never launch the kernel")
            check(value >= PSNR_FLOOR_DB[dtype],
                  f"{dtype} card-vs-CPU PSNR {value:.2f} dB < {PSNR_FLOOR_DB[dtype]}")

        _HALVES.then(future, finish)


def _write_latent_images(folder: str, label2id: str) -> None:
    """LATENT_ITEMS 1024^2 images (smooth colour fields with noise) whose
    captions name 1-4 of four classes, so the context (and kv_lens) differ
    per row, and the label2id of those classes."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    side = 8 * LATENT_SIDE
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(LATENT_ITEMS):
        base = np.stack([np.sin((3 + i % 5) * xx + i), np.cos(2 * yy - i), xx * yy], -1)
        pixels = 127.5 * (base + 1) + rng.integers(-20, 21, size=base.shape)
        Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"img{i:03d}.png"), compress_level=0)
        with open(os.path.join(folder, f"img{i:03d}.txt"), "w") as f:
            f.write(" ".join(f"c{(i + j) % 4}" for j in range(1 + i % 4)))
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)


# cache_latents: the tool's batch, and the floor of one batch's cached mean
# and std against the same images encoded on the CPU in fp32 (relative L2;
# the store is fp16, 2^-11 relative, and the card's convolutions run TF32,
# PyTorch's default for cuDNN that the tool keeps, 2^-11 relative per
# product: 1.6e-3 measured with it on, 2.8e-4 off, NVIDIA H100 80GB HBM3
# 700 W)
CACHE_BATCH, CACHE_FLOOR = 2, 1e-2


def phase_cache_latents(tmp: str) -> tuple[int, ...]:
    """The port's caching tool (``tools.data.cache_latents.run``) on the card
    over LATENT_ITEMS synthetic 1024^2 images with a random-weight SDXL VAE
    at full width; its first batch held against the same images encoded on
    the CPU, which must fail with one image flipped left-right. The card
    runs with PyTorch's default TF32 settings (cuDNN convolutions on,
    matmuls off), whatever an earlier phase left, and they are restored
    after. Returns the kernel launches of the run (none: the VAE's attention
    is a plain product)."""
    from vision_pt_tpu_torch.tools.data.cache_latents import build_vae, run

    folder, cache = os.path.join(tmp, "latent_images"), os.path.join(tmp, "latent_cache")
    t0 = time.perf_counter()
    _write_latent_images(folder, os.path.join(tmp, "latent_label2id.json"))
    write_seconds = time.perf_counter() - t0
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        manifest = run(folder, cache, bucket_base_size=8 * LATENT_SIDE,
                       batch_size=CACHE_BATCH, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        card_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    peak = torch.cuda.max_memory_allocated()
    with open(manifest) as f:
        rows = [json.loads(line) for line in f]
    # the same VAE (the tool's seed) on the CPU, in the worker, over the
    # tool's first batch; the card's rows of that batch read now
    vae = build_vae(device="cuda")
    state = os.path.join(_HALVES.work, "cache_latents_vae.pt")
    torch.save({k: v.cpu() for k, v in vae.state_dict().items()}, state)
    del vae
    future = _HALVES.submit("cache_latents", _cpu_encode, state, folder)
    cached = []
    for row in rows[:CACHE_BATCH]:
        with np.load(os.path.join(cache, row["file"])) as z:
            cached.append((row["caption"], z["mean"].astype(np.float32),
                           z["std"].astype(np.float32)))
    check(len(rows) == LATENT_ITEMS and {(r["latent_height"], r["latent_width"])
                                         for r in rows} == {(LATENT_SIDE, LATENT_SIDE)},
          f"cache of {len(rows)} rows")
    check(counts == _expect({}), f"cache_latents launched {counts}")
    fields = dict(tool="vision_pt_tpu_torch.tools.data.cache_latents",
                  images=LATENT_ITEMS, resolution=8 * LATENT_SIDE, batch=CACHE_BATCH,
                  vae="SDXL VAE at full width, random weights from seed 0",
                  store="float16", matmul_allow_tf32=card_tf32[0],
                  cudnn_allow_tf32=card_tf32[1], write_images_seconds=write_seconds,
                  run_seconds=seconds, images_per_second=LATENT_ITEMS / seconds,
                  peak_memory_bytes=peak, rows=len(rows),
                  latent=[rows[0]["latent_height"], rows[0]["latent_width"], 4],
                  launches=counts)

    def finish(result, where):
        captions, mean, std, cpu_seconds = result
        errors, flipped = [], None
        for i, (caption, cached_mean, cached_std) in enumerate(cached):
            check(caption == captions[i], "cache rows out of batch order")
            errors.append((_rel_l2(cached_mean, mean[i]), _rel_l2(cached_std, std[i])))
            if i == 0:
                flipped = (_rel_l2(cached_mean, mean[-1]), _rel_l2(cached_std, std[-1]))
        emit("cache_latents", **fields, **where, cpu_encode_seconds=cpu_seconds,
             mean_std_rel_l2=errors, flipped_image_rel_l2=flipped, floor=CACHE_FLOOR)
        check(all(max(e) <= CACHE_FLOOR for e in errors),
              f"cached latents against the CPU's: {errors}")
        check(flipped[0] > CACHE_FLOOR, f"the floor passes a flipped image: {flipped}")

    _HALVES.then(future, finish)
    return counts


def _cpu_encode(state: str, folder: str):
    """A worker job: the cache tool's VAE with the card's weights on the
    CPU, encoding the tool's first batch and its first image flipped
    left-right; (captions, mean, std, seconds)."""
    from vision_pt_tpu_torch.data.text_to_image import TextToImageDatasetConfig
    from vision_pt_tpu_torch.tools.data.cache_latents import build_vae

    host = build_vae(device="cpu")
    host.load_state_dict(torch.load(state, weights_only=True))
    os.remove(state)
    batch = next(iter(TextToImageDatasetConfig(
        folder=folder, batch_size=CACHE_BATCH, bucket_base_size=8 * LATENT_SIDE,
        shuffle=False, num_repeats=1).get_dataset()))
    images = batch["image"]
    t0 = time.perf_counter()
    with torch.no_grad():
        dist = host.encode(torch.from_numpy(np.concatenate([images, images[:1, :, ::-1]])))
    seconds = time.perf_counter() - t0
    std = torch.exp(0.5 * torch.clamp(dist.logvar, -30.0, 20.0)).numpy()
    return list(batch["caption"]), dist.mean.numpy(), std, seconds


def phase_latent_trainer(tmp: str) -> tuple[tuple[int, ...], dict]:
    """The port's latent entry point on ``configs/jit/latent_arb_1024.yml`` as
    shipped, paths rewritten (and ``trainer.deterministic``, so that
    ``latent_mesh_trainer`` can hold its run to the bit), over the cache
    phase_cache_latents wrote; returns the kernel launches of the whole run
    (the sanity check and 4 steps) and the config, losses, step times, peak
    memory and saved file that ``latent_mesh_trainer`` reads."""
    import yaml

    from vision_pt_tpu_torch.train.jit.latent_class_to_image import run
    from vision_pt_tpu_torch.training.trainer import Trainer

    with open(os.path.join(ROOT, "configs/jit/latent_arb_1024.yml")) as f:
        cfg = yaml.safe_load(f)
    label2id = os.path.join(tmp, "latent_label2id.json")
    # the cache phase_cache_latents wrote with the port's tool
    cfg["model"]["context_encoder"]["label2id_map_path"] = label2id
    cfg["dataset"]["cache_dir"] = os.path.join(tmp, "latent_cache")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(tmp, "latent_out")
    cfg["tracker"]["log_dir"] = os.path.join(tmp, "latent_logs")
    cfg["num_train_epochs"] = 1
    cfg["trainer"]["deterministic"] = True
    path = os.path.join(tmp, "latent.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    per_step, step_seconds, context_lens = [], [], []
    inner = Trainer.train_step

    def counting(self, batch, *args, **kwargs):
        context_lens.append(batch["context_mask"].sum(dim=1).tolist())
        before = _counts()
        t0 = time.perf_counter()
        if len(per_step) == 3:  # the last step runs under the profiler
            out = profile("latent_trainer",
                          lambda: inner(self, batch, *args, **kwargs))
        else:
            out = inner(self, batch, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), before))
        return out

    Trainer.train_step = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(tmp, "latent_logs", "JiT", "latent-1024.metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    saved = sorted(os.listdir(os.path.join(tmp, "latent_out")))
    denoiser = trainer.model.model.denoiser
    tokens = (LATENT_SIDE // denoiser.config.patch_size) ** 2 + 6 + \
        denoiser.config.num_time_tokens + trainer.model.model_config.max_token_length
    steady = step_seconds[1:3]  # after the first, before the profiled step
    emit("latent_trainer", config="configs/jit/latent_arb_1024.yml",
         depth=denoiser.config.depth, hidden=denoiser.config.hidden_size,
         latent=[LATENT_SIDE, LATENT_SIDE, 4], tokens=tokens,
         batch=LATENT_BATCH, steps=trainer.global_step, run_seconds=seconds,
         step_seconds=step_seconds,
         seconds_per_step=sum(steady) / len(steady),
         latents_per_second=LATENT_BATCH * len(steady) / sum(steady),
         peak_memory_bytes=peak, losses=losses,
         context_tokens_per_step=context_lens,
         launches_per_step=per_step, run_launches=counts, saved=saved)
    check(denoiser.config.depth == 24 and tokens == 4170,
          f"latent config: depth {denoiser.config.depth}, {tokens} tokens")
    check(trainer.global_step == 4 and len(losses) == 4
          and all(np.isfinite(losses)), f"latent trainer losses {losses}")
    check(per_step == [LATENT_STEP_LAUNCHES] * 4,
          f"launches per step {per_step}, expected {LATENT_STEP_LAUNCHES}")
    check(len(saved) == 1, f"saved {saved}")
    del trainer, denoiser
    torch.cuda.empty_cache()
    return counts, {"config": path, "losses": losses, "step_seconds": step_seconds,
                    "peak_memory_bytes": peak, "out": os.path.join(tmp, "latent_out"),
                    "per_step": per_step}


@_tf32_off()
def phase_latent_parity(tmp: str) -> None:
    """One latent training step's loss and gradients on the card and on the
    CPU: full width, depth 2 (fp16: 1, batch 1), a 64 x 64 latent (S = 1098),
    batch 2
    (#7/#8, one launch each a block)."""
    cut = f"depth {LATENT_PARITY_DEPTH}, not 6 (≈ 8 s saved)"
    _step_parity("latent_parity", "latent", os.path.join(tmp, "latent_label2id.json"),
                 [(dtype, depth, _expect({7: depth, 8: depth}),
                   *([cut] if dtype != "float16" else []))
                  for model, dtype, depth in STEP_PARITY_CASES if model == "latent"],
                 latent=[64, 64, 4])


# ------------------------------------------------------------ SDXL phases

# kernel #9 at the sampler's shapes (the 2 x 77 context rows of every
# cross-attention to_k / to_v, K 2048, N 640 or 1280) and at edge shapes
# the sampler's cross-attention to_k / to_v over 154 context rows (CFG),
# then the QLoRA trainer's over 2 x 227 (batch 2, 225 tokens + bos/eos),
# then the NF4 CogView4 sampler's shared feed-forward over its text stream
# (2 x 16 rows; ff.proj 4096 -> 16384, ff.out 16384 -> 4096)
NF4_PATH_SHAPES = ((154, 2048, 640), (154, 2048, 1280), (454, 2048, 640),
                   (454, 2048, 1280), (32, 4096, 16384), (32, 16384, 4096))
NF4_EDGE_SHAPES = tuple((m, k, n) for m in (1, 37, 1024) for k in (128, 5120)
                        for n in (8, 136, 10240))
# kernel #9's block shapes change at M 64, 128 and 256, and its K splits
# with M and N (ops/quant/nf4_matmul.py:plan): both sides of each boundary
NF4_SPLIT_SHAPES = tuple((m, 2048, 1280) for m in (1, 64, 65, 128, 129, 256, 257,
                                                   1024))  # and M 154: the path
# 5 steps a timed request (the JAX bench's 20 cut so the time limit holds
# mesh_trainer and ring too; the launch counts follow)
SDXL_SIDE, SDXL_STEPS, SDXL_CFG, SDXL_TOKENS = 1024, 5, 5.0, 75
# per UNet call at 1024^2 with CFG: 70 self-attentions take flash (10 at
# S 4096 with 10 heads, 60 at S 1024 with 20), and the to_k / to_v of the 70
# cross-attentions (154 rows) take kernel #9 once the UNet is NF4
SDXL_LAUNCHES = {"bf16": _expect({7: 70 * SDXL_STEPS}),
                 "nf4": _expect({7: 70 * SDXL_STEPS, 9: 140 * SDXL_STEPS})}
SDXL_PROMPT = ("photo of a red fox in the snow, detailed fur",
               "blurry, ugly, low quality")
# sdxl_parity at 512^2, full widths, layers_per_block 1, one transformer per
# stage, one UNet call (batch 2) and a 2-step generate (two calls): flash at
# stage 2 (32 x 32 = 1024 tokens, 3 self-attentions a call); under NF4 the
# kernel takes every product of at most 1024 rows: the 6 context products
# of stage 2 and all 48 quantized products of stage 3 (2 x 256 rows)
SDXL_PARITY_LAUNCHES = {"bf16": _expect({7: 9}), "nf4": _expect({7: 9, 9: 162})}
# sdxl_parity floors on the relative L2 error, card vs CPU, in bf16: every
# activation is rounded to 8 mantissa bits through ~40 layers and the card's
# and the CPU's matmuls and convolutions round at other places (the JiT
# phases see a few percent in bf16; one UNet call measured 1.5e-2). The
# latents pass two steps of CFG 5, which scales the difference of the two
# predictions, and their error, by 5 (measured 3.3e-2 and 4.4e-2, an H100
# against its host, the same in every run). Each floor lies between those
# readings and those of a kernel #9 with one scale row 25% off in every
# launch (measured 8.6e-2 and 1.37e-1), which the phase runs to show it.
SDXL_PARITY_FLOOR = {"unet": 5e-2, "latents": 7.5e-2}


def phase_nf4_kernel() -> float:
    """Kernel #9 against its plain version, nf4 and fp4, bf16, fp16 and fp32;
    returns the largest error at the path's shape (154 x 2048 -> 1280, bf16,
    nf4)."""
    from vision_pt_tpu_torch.ops.quant.nf4 import quantize_4bit_device_kernel_layout
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import (
        dequant_matmul_4bit,
        dequant_matmul_4bit_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    weights, cases, path = {}, [], None
    for m, k, n in NF4_PATH_SHAPES + NF4_EDGE_SHAPES + NF4_SPLIT_SHAPES:
        for quant_type in ("nf4", "fp4"):
            if (k, n, quant_type) not in weights:
                w = torch.randn(n, k, generator=gen, device="cuda") * 0.05
                weights[k, n, quant_type] = quantize_4bit_device_kernel_layout(
                    w, quant_type)
            packed, absmax = weights[k, n, quant_type]
            for dtype in (torch.bfloat16, torch.float16, torch.float32):
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                out = dequant_matmul_4bit(x, packed, absmax, quant_type)
                torch.cuda.synchronize()
                ref = dequant_matmul_4bit_reference(x, packed, absmax, quant_type)
                err, share = _compare(out, ref, TOL[dtype])
                ok = (bool(torch.isfinite(out).all()) and share <= 1.0
                      and out.dtype == dtype and out.shape == ref.shape)
                cases.append([m, k, n, quant_type, str(dtype)[6:], err, share, ok])
                check(ok, f"dequant_matmul_4bit disagrees at {cases[-1]}")
                if (m, n, quant_type, dtype) == (154, 1280, "nf4", torch.bfloat16):
                    path = (x, packed, absmax, out, err)
                if (k, n, quant_type) == (2048, 1280, "nf4") and m in (64, 154):
                    # repeated calls give the same bits: the splits are added
                    # in a fixed order, no atomics
                    same = torch.equal(out, dequant_matmul_4bit(x, packed, absmax))
                    emit("nf4_kernel", kernel="dequant_matmul_4bit", case="repeat",
                         shape=[m, k, n], dtype=str(dtype), bitwise_equal=same)
                    check(same, f"two calls of dequant_matmul_4bit differ at {m}")
    emit("nf4_kernel", kernel="dequant_matmul_4bit",
         tolerance={str(dtype)[6:]: tol for dtype, tol in TOL.items()},
         columns=["m", "k", "n", "quant", "dtype", "max_abs_err", "limit_share", "ok"],
         cases=cases)
    # the limits must fail a plain version with one absmax row 25% off, or
    # with one 64-row chunk left out
    x, packed, absmax, out, err = path
    perturbed, dropped = absmax.clone(), absmax.clone()
    perturbed[3] *= 1.25
    dropped[3] = 0.0
    shares = {label: _compare(out, dequant_matmul_4bit_reference(x, packed, a),
                              TOL[torch.bfloat16])[1]
              for label, a in (("absmax_row_perturbed", perturbed),
                               ("chunk_dropped", dropped))}
    emit("nf4_kernel", kernel="dequant_matmul_4bit", case="limits_can_fail",
         limit_shares=shares)
    check(min(shares.values()) > 1, f"an NF4 limit passes a wrong kernel: {shares}")
    return err


def phase_nf4_timing() -> dict:
    """Kernel #9 at the sampler's two shapes, the QLoRA trainer's two and the
    JAX package's bench shape (M 64, K = N = 8192), bf16, nf4; the yardstick
    is F.linear on the weight dequantized to bf16 beforehand."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops.quant.layers import _dequant_deint
    from vision_pt_tpu_torch.ops.quant.nf4 import quantize_4bit_device_kernel_layout
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import (
        dequant_matmul_4bit,
        dequant_matmul_4bit_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for label, (m, k, n) in (("path_n640", NF4_PATH_SHAPES[0]),
                             ("path", NF4_PATH_SHAPES[1]),
                             ("qlora_n640", NF4_PATH_SHAPES[2]),
                             ("qlora_n1280", NF4_PATH_SHAPES[3]),
                             ("cogview4_ff_proj", NF4_PATH_SHAPES[4]),
                             ("cogview4_ff_out", NF4_PATH_SHAPES[5]),
                             ("bench", (64, 8192, 8192))):
        w = torch.randn(n, k, generator=gen, device="cuda") * 0.05
        packed, absmax = quantize_4bit_device_kernel_layout(w)
        dense = _dequant_deint(packed, absmax, "nf4", torch.bfloat16)  # (n, k)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        nbytes = 2 * m * k + packed.numel() + 4 * absmax.numel() + 2 * m * n
        rows[label] = _time_kernel(
            "dequant_matmul_4bit",
            lambda: dequant_matmul_4bit(x, packed, absmax),
            lambda: dequant_matmul_4bit_reference(x, packed, absmax),
            lambda: F.linear(x, dense),
            nbytes, 2 * m * k * n, torch.bfloat16,
            "vision_pt_tpu/ops/quant/pallas_nf4.py:167",
            "vision_pt_tpu_torch/csrc/nf4_matmul.cu", [label, m, k, n],
            "F.linear on the weight dequantized to bf16 beforehand",
            phase="nf4_timing",
        )
        del w, packed, absmax, dense
    return rows


def phase_sdxl_sampler() -> dict:
    """SDXL-base at full width, random weights from a seed, bf16 compute
    with fp32 parameters, built on the card; through the CLI's ``run`` at
    1024^2, batch 1, CFG 5, SDXL_STEPS steps: one warm and one timed request in
    bf16, then again with the UNet NF4 (the CLI's keys), each followed by a
    profiled 2-step request. Returns the timed requests' kernel launches."""
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel, WordHashTokenizer
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.tools import inference_cli as cli

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokenizer = WordHashTokenizer()
    model = SDXLModel.from_config(SDXLConfig(checkpoint_path="", dtype="bfloat16"),
                                  seed=0, device="cuda", tokenizer_1=tokenizer,
                                  tokenizer_2=tokenizer)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = {name: sum(p.numel() for p in module.parameters())
              for name, module in model._submodules().items()}

    def request(seed, steps=SDXL_STEPS):
        return cli.run(model, SDXL_PROMPT[0], SDXL_PROMPT[1], width=SDXL_SIDE,
                       height=SDXL_SIDE, num_inference_steps=steps,
                       cfg_scale=SDXL_CFG, seed=seed, max_token_length=SDXL_TOKENS)

    launches = {}
    for label in ("bf16", "nf4"):
        replaced, quant_s = [], None
        if label == "nf4":
            t0 = time.perf_counter()
            replaced = quantize_inplace(model.denoiser, "bnb_nf4",
                                        cli.INCLUDE_KEYS, cli.EXCLUDE_KEYS)
            torch.cuda.synchronize()
            quant_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
        request(100, steps=2)  # warm-up: allocator, cuDNN and cuBLAS plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        image = request(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        stats = image.float()
        emit("sdxl_sampler", model="SDXL-base (random weights, seed 0)",
             unet=label, params=params, quantized_linears=len(replaced),
             quantize_seconds=quant_s, resolution=SDXL_SIDE, batch=1,
             cfg=SDXL_CFG, steps=SDXL_STEPS, context_tokens=SDXL_TOKENS + 2,
             build_seconds=build_s, seconds_per_image=seconds,
             steps_per_second=SDXL_STEPS / seconds,
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             launches=counts, expected=SDXL_LAUNCHES[label],
             image_mean=float(stats.mean()), image_std=float(stats.std()))
        check(tuple(image.shape) == (1, SDXL_SIDE, SDXL_SIDE, 3),
              f"image shape {tuple(image.shape)}")
        check(bool(torch.isfinite(stats).all()) and float(stats.std()) > 1e-3,
              "the SDXL image is not finite, or constant")
        check(counts == SDXL_LAUNCHES[label],
              f"SDXL {label} launches {counts}, expected {SDXL_LAUNCHES[label]}")
        if label == "nf4":  # 70 blocks of 10 linears, 11 transformers of 2
            check(len(replaced) == 70 * 10 + 11 * 2,
                  f"{len(replaced)} quantized linears")
        launches[f"sdxl_{label}"] = counts
        # a 2-step request: the profiler's own processing of a 20-step one
        # (about 400 k events) takes minutes
        profile(f"sdxl_{label}_2_steps", lambda: request(2, steps=2))
    del model, image
    torch.cuda.empty_cache()
    return launches


def _rel_l2(ours: np.ndarray, theirs: np.ndarray) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


def _sdxl_parity_run(model, inputs: dict):
    """(UNet output, latents, launches, seconds) of one UNet call and the
    2-step generate of sdxl_parity on ``model``'s device, the flash and NF4
    gates open (the CPU runs the same path, through the plain versions)."""
    import vision_pt_tpu_torch.ops.attention as attention
    from vision_pt_tpu_torch.ops.quant import layers as qlayers

    bf16, device = torch.bfloat16, model.device
    args = [torch.from_numpy(a).to(device, bf16 if i in (0, 2, 3) else torch.float32)
            for i, a in enumerate(inputs["unet_args"])]
    _reset_counts()
    gates = attention._on_cuda, qlayers._on_cuda
    attention._on_cuda = qlayers._on_cuda = lambda x: True
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            unet_out = model.denoiser(*args)
        out = model.generate(SDXL_PROMPT[0], SDXL_PROMPT[1], width=512,
                             height=512, num_inference_steps=2,
                             cfg_scale=SDXL_CFG, execution_dtype=bf16,
                             latents=inputs["latents"], step_noise=inputs["noise"],
                             return_latents=True)
    finally:
        attention._on_cuda, qlayers._on_cuda = gates
    return (unet_out.float().cpu().numpy(), out.float().cpu().numpy(),
            _counts(), time.perf_counter() - t0)


def _cpu_model_run(model, run, *args):
    """A worker job: the shipped pipeline moved to the CPU, then ``run``."""
    return run(model.to("cpu"), *args)


@_tf32_off()
def phase_sdxl_parity() -> None:
    """The same weights and draws on the card (kernels) and on the CPU (the
    plain versions of the same path, in the worker): full widths,
    layers_per_block 1, one transformer per stage, 512^2, bf16; one UNet
    call (batch 2) and a 2-step CFG generate, before and after NF4
    quantization."""
    from vision_pt_tpu_torch.models.sdxl import (
        DenoiserConfig,
        SDXLConfig,
        SDXLModel,
        WordHashTokenizer,
    )
    from vision_pt_tpu_torch.ops.quant import layers as qlayers
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.tools import inference_cli as cli

    config = SDXLConfig(checkpoint_path="", dtype="bfloat16", denoiser=DenoiserConfig(
        layers_per_block=1, num_transformers_per_block=[1, 1, 1]))
    tokenizer = WordHashTokenizer()
    card = SDXLModel.from_config(config, seed=1, device="cuda",
                                 tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    rng = np.random.default_rng(5)
    unet_args = [
        rng.normal(size=(2, 64, 64, 4)).astype(np.float32),
        np.asarray([999.0, 500.0], np.float32),
        rng.normal(size=(2, 77, 2048)).astype(np.float32),
        rng.normal(size=(2, 1280)).astype(np.float32),
        np.full((2, 2), 512.0, np.float32), np.full((2, 2), 512.0, np.float32),
        np.zeros((2, 2), np.float32),
    ]
    sigma = card.scheduler.get_max_noise_sigma(
        card.scheduler.get_sigmas(card.scheduler.get_timesteps(2)))
    latents = rng.normal(size=(1, 64, 64, 4)).astype(np.float32) * sigma
    noise = [rng.normal(size=(1, 64, 64, 4)).astype(np.float32) for _ in range(2)]
    inputs = {"unet_args": unet_args, "latents": latents, "noise": noise}

    for label in ("bf16", "nf4"):
        if label == "nf4":
            quantize_inplace(card.denoiser, "bnb_nf4", cli.INCLUDE_KEYS,
                             cli.EXCLUDE_KEYS)
        future = _HALVES.submit(f"sdxl_parity {label}", _cpu_model_run,
                                _sdxl_parity_run, inputs, ship=_HALVES.ship(card))
        unet_c, lat_c, counts_c, sec_c = _sdxl_parity_run(card, inputs)
        check(np.isfinite(unet_c).all() and np.isfinite(lat_c).all(),
              "non-finite SDXL parity output")
        check(counts_c == SDXL_PARITY_LAUNCHES[label],
              f"SDXL parity launches: card {counts_c}, expected "
              f"{SDXL_PARITY_LAUNCHES[label]}")
        wrong_runs = {}
        if label == "nf4":
            # the floors must fail a kernel #9 that is slightly wrong in
            # every launch: its scale row 3 25% off, or that chunk left out
            kernel = qlayers.dequant_matmul_4bit
            for wrong_label, scale in (("absmax_row_perturbed", 1.25),
                                       ("chunk_dropped", 0.0)):
                def wrong(x, packed, absmax, quant_type="nf4", scale=scale):
                    absmax = absmax.clone()
                    absmax[3] *= scale
                    return kernel(x, packed, absmax, quant_type)

                qlayers.dequant_matmul_4bit = wrong
                try:
                    wrong_runs[wrong_label] = _sdxl_parity_run(card, inputs)[:2]
                finally:
                    qlayers.dequant_matmul_4bit = kernel

        def finish(result, where, label=label, card_run=(unet_c, lat_c, counts_c, sec_c),
                   wrong_runs=wrong_runs):
            unet_c, lat_c, counts_c, sec_c = card_run
            unet_h, lat_h, counts_h, sec_h = result
            errors = {"unet": _rel_l2(unet_c, unet_h), "latents": _rel_l2(lat_c, lat_h)}
            emit("sdxl_parity", unet=label, resolution=512, depth="layers_per_block 1, "
                 "one transformer per stage", **where, rel_l2=errors,
                 floor=SDXL_PARITY_FLOOR,
                 psnr_db={"unet": psnr(unet_c, unet_h), "latents": psnr(lat_c, lat_h)},
                 launches_cuda=counts_c, launches_cpu=counts_h,
                 expected_cuda=SDXL_PARITY_LAUNCHES[label], seconds_cuda=sec_c,
                 seconds_cpu=sec_h)
            check(counts_h == _expect({}), f"SDXL parity launches on the CPU: {counts_h}")
            check(all(errors[k] <= SDXL_PARITY_FLOOR[k] for k in errors),
                  f"SDXL {label} parity {errors} over {SDXL_PARITY_FLOOR}")
            if not wrong_runs:
                return
            wrong_errors = {name: {"unet": _rel_l2(unet_w, unet_h),
                                   "latents": _rel_l2(lat_w, lat_h)}
                            for name, (unet_w, lat_w) in wrong_runs.items()}
            emit("sdxl_parity", unet=label, case="limits_can_fail", rel_l2=wrong_errors,
                 floor=SDXL_PARITY_FLOOR)
            for wrong_label, e in wrong_errors.items():
                check(all(e[k] > SDXL_PARITY_FLOOR[k] for k in e),
                      f"an SDXL parity floor passes kernel #9 with {wrong_label}: {e}")

        _HALVES.then(future, finish)
    del card
    torch.cuda.empty_cache()


# ---------------------------------- SDXL LoRA / QLoRA training

# num_repeats 2, batch 2: 2 steps, the second timed (the shipped configs
# repeat 4 times; cut to leave room for mesh_trainer and ring in the time
# limit)
SDXL_TRAIN_IMAGES, SDXL_TRAIN_STEPS = 2, 2
# each SDXL training config: its file, its entry module under
# ``vision_pt_tpu_torch.train.sdxl``, its preview's steps (None: as shipped),
# and the launches of a training step and of the preview. A step at 1024^2,
# batch 2, per-layer recompute: the 70 self-attentions (10 at S 4096, 60 at
# S 1024) take #7 in the forward and again in the recompute and #8 once;
# under QLoRA the to_k / to_v of the 70 cross-attentions over the 2 x 227
# context rows take #9 in the forward and the recompute (every other NF4
# product has more than 1024 rows). A preview's UNet call (CFG, batch 2)
# takes #7 70 times, and #9 140 times under QLoRA; the flow-match preview
# (configs/sdxl/flow_match/preview.yml) runs 16 steps, the others are cut
# to 2.
SDXL_TRAIN_CONFIGS = {
    "lora": dict(path="configs/sdxl/text_to_image_lora.yml", entry="text_to_image",
                 preview_steps=2, launches=_expect({7: 140, 8: 70}),
                 preview_launches=_expect({7: 2 * 70})),
    "qlora": dict(path="configs/sdxl/text_to_image_qlora_nf4.yml", entry="text_to_image",
                  preview_steps=2, launches=_expect({7: 140, 8: 70, 9: 280}),
                  preview_launches=_expect({7: 2 * 70, 9: 2 * 140})),
    "flow_match": dict(path="configs/sdxl/flow_match/config.yml", entry="flow_match",
                       preview_steps=None, launches=_expect({7: 140, 8: 70}),
                       preview_launches=_expect({7: 16 * 70})),
}
# the QLoRA checkpoint's NF4 linears, by their sgm keys: the CLI's set (the
# transformers' attention and feed-forward linears and their projections)
QLORA_QUANT_KEYS = ["attn1.", "attn2.", "ff.net.", "proj_in.", "proj_out."]
# sdxl_lora_parity: sdxl_parity's model (full widths, one layer and one
# transformer per stage) at 512^2 from a cached latent, 75 tokens, batch 1;
# a step runs #7 / #8 in the level-2 self-attentions (S 1024: 1 down, 2 up)
# and, NF4, #9 in the products of at most 1024 rows: the 7 cross-attentions'
# to_k / to_v (77 rows), the 40 other quantized products of the level-3 and
# middle transformers (256 rows) and the 30 of the level-2 ones (1024 rows;
# 2048 at batch 2, dense)
SDXL_LORA_PARITY_LAUNCHES = {"bf16": _expect({7: 3, 8: 3}),
                             "nf4": _expect({7: 3, 8: 3, 9: 84})}
# its model is sdxl_parity's depth already, so it is cut to the first of the
# two samples it held: its CPU steps took 14, 5 (fp32 witness) and 17 s
# (NF4) at batch 2 on an H100's host, 7, 3 and 7 s at batch 1
SDXL_LORA_PARITY_CUT = "batch 1, not 2: ≈ 19 s saved over the three steps"

# sdxl_lora_parity's floors, card against CPU: the loss within the bf16
# training-step floor (2e-2); each LoRA gradient within 1e-1 relative L2 (the
# bf16 training-step floor), or within 1.5 times the witness's error where
# bf16 alone puts it further: the witness is the same step on the card with
# the plain versions (no kernel) against the CPU. A LoRA gradient summed over
# tokens cancels, so the two devices' bf16 roundings upstream of it move it by
# more than 1e-1 with no kernel in the step (measured 0.139 on a
# cross-attention to_q adapter, plain attention, no NF4, NVIDIA H100 80GB
# HBM3 700 W; median 0.038). Both floors must fail the wrong kernels the phase
# runs.
SDXL_LORA_PARITY_FLOOR = {"loss": 2e-2, "grad": 1e-1, "witness": 1.5}


def _write_sdxl_images(folder: str) -> None:
    """SDXL_TRAIN_IMAGES 1024^2 images (smooth colour fields with noise) with
    captions: the data the configs name is not in the repository."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:1024, 0:1024] / 1024.0
    for i in range(SDXL_TRAIN_IMAGES):
        base = np.stack([np.sin(3 * xx + i), np.cos(2 * yy - i), xx * yy], -1)
        pixels = (127.5 * (base + 1) + rng.normal(0, 12, size=base.shape))
        Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"img{i}.png"))
        with open(os.path.join(folder, f"img{i}.txt"), "w") as f:
            f.write(f"1girl, solo, looking at viewer, colorful background {i}, "
                    "masterpiece, high score, absurdres")


def _write_nf4_checkpoint(path: str) -> dict:
    """A random-weight SDXL checkpoint in the sgm layout, fp16, written to a
    file beside ``path``; the port's quantize tool (``tools.quantize_model``,
    its function, on the card) then writes ``path`` from it, the UNet's
    linears that QLORA_QUANT_KEYS name NF4-prequantized. The fp16 file stays
    for the server phase's import check."""
    from safetensors.numpy import save_file

    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel
    from vision_pt_tpu_torch.tools.quantize_model import quantize_file

    t0 = time.perf_counter()
    model = SDXLModel.from_config(SDXLConfig(checkpoint_path="", dtype="bfloat16"),
                                  seed=0, device="cuda", param_dtype=torch.float16)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    fp16 = path.replace(".bnb_nf4.safetensors", ".fp16.safetensors")
    t1 = time.perf_counter()
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, fp16)
    fp16_write = time.perf_counter() - t1
    del sd
    tool = quantize_file(fp16, path, "bnb_nf4",
                         [f"model.diffusion_model.*{k}" for k in QLORA_QUANT_KEYS], [],
                         device="cuda")
    return {"nf4_linears": tool["quantized"], "bytes": os.path.getsize(path),
            "seconds": time.perf_counter() - t0, "fp16_path": fp16,
            "fp16_bytes": os.path.getsize(fp16), "fp16_write_seconds": fp16_write,
            "quantize_tool": tool}


def _sdxl_train_config(tmp: str, label: str, checkpoint: str | None) -> tuple[str, list]:
    """The shipped config with its cuts: returns the written path and the
    cuts, listed."""
    import yaml

    spec = SDXL_TRAIN_CONFIGS[label]
    with open(os.path.join(ROOT, spec["path"])) as f:
        cfg = yaml.safe_load(f)
    with open(os.path.join(ROOT, cfg["preview"]["data"]["path"])) as f:
        preview = yaml.safe_load(f)[:1]
    work = os.path.join(tmp, label)
    os.makedirs(work, exist_ok=True)
    if spec["preview_steps"] is not None:
        preview[0]["num_steps"] = spec["preview_steps"]
    with open(os.path.join(work, "preview.yml"), "w") as f:
        yaml.safe_dump(preview, f)
    cfg["model"].update(checkpoint_path=checkpoint, tokenizer="word-hash")
    if label in SDXL_MESH_LABELS:
        cfg.setdefault("trainer", {})["deterministic"] = True
    cfg["dataset"].update(folder=os.path.join(tmp, "images"), num_repeats=SDXL_TRAIN_STEPS)
    cfg["num_train_epochs"] = 1
    cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(work, "preview")
    cfg["preview"]["data"]["path"] = os.path.join(work, "preview.yml")
    path = os.path.join(work, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    cuts = ["random weights from the seed" if checkpoint is None else
            "random weights from a seed, written fp16 and NF4-prequantized by the "
            "port's quantize tool (tools.quantize_model.quantize_file)",
            "word-hash tokenizer (the repository has no CLIP vocabulary)",
            f"{SDXL_TRAIN_IMAGES} synthetic 1024^2 images with captions, "
            f"num_repeats {SDXL_TRAIN_STEPS}, batch 2: 1 epoch of {SDXL_TRAIN_STEPS} steps",
            "output paths in a temporary directory",
            f"preview: the first prompt of {cfg['preview']['data']['path']}, "
            + (f"{spec['preview_steps']} steps" if spec["preview_steps"] is not None
               else f"as shipped ({preview[0]['num_steps']} steps)")]
    if label in SDXL_MESH_LABELS:
        cuts.append("trainer.deterministic: true, as in sdxl_mesh_trainer, which "
                    "compares its adapter file with this run's bit for bit")
    return path, cuts


def phase_sdxl_trainer(tmp: str, label: str) -> tuple[tuple[int, ...], dict]:
    """The port's SDXL entry point (``train.sdxl.text_to_image.run``, or
    ``train.sdxl.flow_match.run`` for the flow-match config) on the shipped
    LoRA, QLoRA or flow-match config at full width and depth, 1024^2, its
    cuts listed in the phase line; returns the kernel launches of the run,
    and the config, losses, launches, step times, peak memory and saved
    files that ``sdxl_mesh_trainer`` holds its runs against."""
    import importlib

    from vision_pt_tpu_torch.training.trainer import Trainer
    from vision_pt_tpu_torch.workloads.sdxl_text_to_image import (
        SDXLForTextToImageTraining as Workload,
    )

    spec = SDXL_TRAIN_CONFIGS[label]
    run = importlib.import_module(f"vision_pt_tpu_torch.train.sdxl.{spec['entry']}").run
    phase = f"sdxl_{label}_trainer"
    if not os.path.isdir(os.path.join(tmp, "images")):
        _write_sdxl_images(os.path.join(tmp, "images"))
    checkpoint, written = None, None
    if label == "qlora":
        checkpoint = os.path.join(tmp, "sdxl_random.bnb_nf4.safetensors")
        written = _write_nf4_checkpoint(checkpoint)
    path, cuts = _sdxl_train_config(tmp, label, checkpoint)
    per_step, step_seconds, peaks, inner = [], [], [], Trainer.train_step
    previews, inner_preview = [], Workload.preview_step

    def counting(self, *args, **kwargs):
        if not per_step:
            torch.cuda.reset_peak_memory_stats()
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), before))
        peaks.append(torch.cuda.max_memory_allocated())
        return out

    def previewing(self, *args, **kwargs):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_preview(self, *args, **kwargs)
        torch.cuda.synchronize()
        previews.append((time.perf_counter() - t0, _diff(_counts(), before)))
        return out

    Trainer.train_step = counting
    Workload.preview_step = previewing
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
        Workload.preview_step = inner_preview
    seconds = time.perf_counter() - t0
    counts = _counts()
    work = os.path.join(tmp, label)
    with open(os.path.join(work, "logs", os.listdir(os.path.join(work, "logs"))[0])) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    saved = os.listdir(os.path.join(work, "out"))
    from safetensors.torch import load_file

    lora = load_file(os.path.join(work, "out", saved[0])) if len(saved) == 1 else {}
    tree = trainer.model.trainable()
    adapters = sum(p.numel() for p in tree.parameters() if p.requires_grad)
    timed = step_seconds[1:]
    emit(phase, config=spec["path"], cuts=cuts, resolution=1024,
         batch=2, optimizer=trainer.config.optimizer.name,
         gradient_checkpointing=trainer.config.trainer.gradient_checkpointing,
         checkpoint=written, steps=trainer.global_step, run_seconds=seconds,
         step_seconds=step_seconds,
         seconds_per_step_after_first=sum(timed) / max(len(timed), 1),
         peak_memory_bytes=max(peaks) if peaks else None, losses=losses,
         launches_per_step=per_step, expected_per_step=spec["launches"],
         run_launches=counts, adapter_params=adapters, lora_file_keys=len(lora),
         previews=len(os.listdir(os.path.join(work, "preview"))),
         preview_seconds=[p[0] for p in previews],
         preview_launches=[p[1] for p in previews])
    check(trainer.global_step == SDXL_TRAIN_STEPS and len(losses) == SDXL_TRAIN_STEPS
          and all(np.isfinite(losses)), f"{phase} losses {losses}")
    check(per_step == [spec["launches"]] * SDXL_TRAIN_STEPS,
          f"{phase} launches per step {per_step}, expected {spec['launches']}")
    # 700 adapted linears (attn1, attn2, .ff.), 3 tensors each
    check(len(lora) == 3 * 700 and all(k.startswith("diffusion_model.") for k in lora),
          f"{phase} LoRA file with {len(lora)} tensors")
    check([p[1] for p in previews] == [spec["preview_launches"]],
          f"{phase} preview launches {[p[1] for p in previews]}, expected "
          f"{spec['preview_launches']}")
    if label == "qlora":
        # where a QLoRA step's time goes (the dense NF4 dequantization of the
        # products over 1024 rows among it): one more step, profiled
        batch = trainer.model.prepare_batch(next(iter(trainer.train_dataset)))
        profile(f"{phase}_step", lambda: trainer.train_step(batch,
                                                            trainer._next_generator()))
    del trainer, tree
    torch.cuda.empty_cache()
    return counts, {"config": path, "out": os.path.join(work, "out"), "losses": losses,
                    "per_step": per_step,
                    "step_seconds": step_seconds, "peak_memory_bytes": max(peaks)}


# sdxl_mesh_trainer: the LoRA and QLoRA trainer phases' configs through
# torchrun under the mesh {data 1, fsdp 1} (one NCCL rank: the card is one
# H100), the distributed init and the profiler, which traces the second step
# alone (the epoch's preview runs after the trace is closed)
SDXL_MESH_LABELS = ("lora", "qlora")
SDXL_MESH_PROFILE_STEPS = 1
# the command the torchrun phases run: an entry point's CLI, then this
# rank's peak device memory over the training steps, taken as the no-mesh
# phase takes it (reset at the first step, read after each)
MESH_ENTRY_SCRIPT = """import sys

import torch

from vision_pt_tpu_torch.train.{entry} import main
from vision_pt_tpu_torch.training.trainer import Trainer

peaks, inner = [], Trainer.train_step


def measured(self, *args, **kwargs):
    if not peaks:
        torch.cuda.reset_peak_memory_stats()
    out = inner(self, *args, **kwargs)
    peaks.append(torch.cuda.max_memory_allocated())
    return out


Trainer.train_step = measured
try:
    main(sys.argv[1:], standalone_mode=False)
finally:
    print(f"[peak_memory] {{max(peaks, default=0)}}", flush=True)
"""


def _mesh_start(tmp: str, label: str, no_mesh: dict, script: str, mesh: dict,
                profile_steps: int, nice: int = 0):
    """Start a no-mesh phase's config under torchrun with ``mesh``, the
    distributed init, the profiler over ``profile_steps`` steps,
    ``trainer.deterministic`` and the no-mesh run's preview, at niceness
    ``nice``; returns what ``_mesh_result`` reads."""
    import yaml

    work = os.path.join(tmp, f"mesh_{label}")
    os.makedirs(work, exist_ok=True)
    with open(no_mesh["config"]) as f:
        cfg = yaml.safe_load(f)
    cfg["trainer"].update(mesh=mesh, distributed_init=True,
                          profile_dir=os.path.join(work, "profile"),
                          profile_steps=profile_steps, deterministic=True)
    cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
    if cfg.get("preview"):
        cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(work, "preview")
    path = os.path.join(work, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    command = ["nice", "-n", str(nice)] * bool(nice) + [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "1", script, "--config", path]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    log = open(os.path.join(work, "run.log"), "w")
    proc = subprocess.Popen(command, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "work": work, "cfg": cfg, "command": command,
            "profile_steps": profile_steps, "t0": time.perf_counter()}


def _mesh_result(started: dict, no_mesh: dict) -> dict:
    """Wait for a run ``_mesh_start`` began (killed past 600 s); its exit
    code, group, losses, step times, peak memory, trace launches and files
    against ``no_mesh``, and its previews (None without a preview)."""
    from safetensors.torch import load_file

    proc, work = started["proc"], started["work"]
    try:
        proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - started["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    started["log"].close()
    seconds = time.perf_counter() - started["t0"]
    with open(os.path.join(work, "run.log")) as f:
        text = f.read()
    out = {"command": " ".join(started["command"][1:]), "exit": proc.returncode,
           "log_tail": text[-3000:] if proc.returncode else None, "run_seconds": seconds,
           "ended_wall": os.path.getmtime(os.path.join(work, "run.log"))}
    if proc.returncode:
        return out
    group = re.search(r"\[distributed\] (\w+) group: rank (\d+) of (\d+), device (\S+)",
                      text)
    peak = re.search(r"\[peak_memory\] (\d+)", text)
    trained = re.search(r"training finished in ([0-9.]+)s", text)
    logs = glob.glob(os.path.join(work, "logs", "**", "*.metrics.jsonl"), recursive=True)
    with open(logs[0]) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    step_time = [r["train/step_time"] for r in records if "train/step_time" in r]
    trace = os.path.join(work, "profile", "trace_rank0.json")
    traced = _trace_launches(trace) if os.path.exists(trace) else (0, 0, 0)
    # the traced steps, by the no-mesh run's counts of its second step
    profile_steps = started["profile_steps"]
    expected = tuple(profile_steps * no_mesh["per_step"][1][n - 1] for n in (7, 8, 9))
    saved = sorted(os.listdir(os.path.join(work, "out")))
    theirs = sorted(os.listdir(no_mesh["out"]))
    equal = {}
    for ours_name, theirs_name in zip(saved, theirs):
        a = load_file(os.path.join(work, "out", ours_name))
        b = load_file(os.path.join(no_mesh["out"], theirs_name))
        equal[ours_name] = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    preview = os.path.join(work, "preview")
    previews = (len(os.listdir(preview)) if os.path.isdir(preview) else 0
                ) if started["cfg"].get("preview") else None
    return {**out, "mesh": started["cfg"]["trainer"]["mesh"],
            "group": group.groups() if group else None,
            "train_seconds": float(trained.group(1)) if trained else None,
            "losses": losses, "losses_no_mesh": no_mesh["losses"],
            "rel_gap": [abs(a - b) / abs(b) for a, b in zip(losses, no_mesh["losses"])],
            "step_time": step_time, "step_time_no_mesh": no_mesh["step_seconds"],
            "peak_memory_bytes": int(peak.group(1)) if peak else None,
            "peak_memory_bytes_no_mesh": no_mesh["peak_memory_bytes"],
            "trace": os.path.basename(trace), "profiled_steps": profile_steps,
            "trace_launches": dict(zip(("#7", "#8", "#9"), traced)),
            "expected_launches": dict(zip(("#7", "#8", "#9"), expected)),
            "saved": saved, "saved_no_mesh": theirs, "files_equal": equal,
            "previews": previews}


def phase_sdxl_mesh_trainer(tmp: str, no_mesh: dict[str, dict]) -> dict:
    """The sdxl_lora_trainer and sdxl_qlora_trainer phases' configs (the
    QLoRA one on the NF4 file that phase wrote) through ``torchrun`` with
    the mesh, the distributed init and the profiler, the two runs side by
    side (each process's start and load overlap the other's steps); each
    run's losses, adapter file and #7 / #8 / #9 launches against those
    phases' runs."""
    torch.cuda.empty_cache()  # the card for the torchrun processes
    script = os.path.join(tmp, "sdxl_mesh_entry.py")
    with open(script, "w") as f:
        f.write(MESH_ENTRY_SCRIPT.format(entry="sdxl.text_to_image"))
    t0 = time.perf_counter()
    started = {label: _mesh_start(tmp, label, no_mesh[label], script,
                                  {"data": 1, "fsdp": 1}, SDXL_MESH_PROFILE_STEPS)
               for label in SDXL_MESH_LABELS}
    runs = {label: _mesh_result(run, no_mesh[label]) for label, run in started.items()}
    emit("sdxl_mesh_trainer", configs={k: SDXL_TRAIN_CONFIGS[k]["path"] for k in runs},
         cuts="the sdxl_lora_trainer / sdxl_qlora_trainer phases' (their files, 1024^2, "
              "batch 2, 2 steps, the 2-step preview), trainer.deterministic: true in both; "
              "the two torchrun runs side by side, so their host-bound step times share "
              "the host",
         tolerance=MESH_LOSS_RTOL, runs=runs, runs_seconds=time.perf_counter() - t0)
    for label, r in runs.items():
        check(r["exit"] == 0, f"sdxl_mesh_trainer {label}: torchrun exit {r['exit']}: "
                              f"{r['log_tail']}")
        group = r["group"]
        check(group is not None and group[0] == "nccl" and group[1:3] == ("0", "1"),
              f"sdxl_mesh_trainer {label}: process group {group}")
        check(len(r["losses"]) == len(r["losses_no_mesh"]) == SDXL_TRAIN_STEPS
              and max(r["rel_gap"]) <= MESH_LOSS_RTOL,
              f"sdxl_mesh_trainer {label}: losses {r['losses']} against "
              f"{r['losses_no_mesh']}")
        check(r["expected_launches"]["#7"] > 0 and r["expected_launches"]["#8"] > 0
              and r["trace_launches"] == r["expected_launches"],
              f"sdxl_mesh_trainer {label}: the trace's launches {r['trace_launches']}, "
              f"the no-mesh run's {r['expected_launches']}")
        check(len(r["saved"]) == len(r["saved_no_mesh"]) == 1 and all(r["files_equal"].values()),
              f"sdxl_mesh_trainer {label}: saved {r['saved']} against {r['saved_no_mesh']}: "
              f"equal {r['files_equal']}")
        # the no-mesh phase's preview, sampled under the mesh (the FSDP units
        # resharded after it)
        check(r["previews"] == 1, f"sdxl_mesh_trainer {label}: previews {r['previews']}")
    return runs


# ---------------------------------- the SDXL adapter trainers under the mesh

# sdxl_adapter_mesh_trainer: ip_adapter_trainer's run (train.sdxl.ip_adapter_ref,
# SDXL-base at full width and depth, 1024^2, batch 2, the full-size CLIP
# tower; both sides trainer.deterministic) through torchrun under
# {data 1, fsdp 1}, the profiler over its second step: #7 / #8 140 / 69.
# It starts beside sdxl_mesh_trainer's two runs: the three no-mesh peaks
# (23.8, 19.8 and 12.1 GB on one NVIDIA H100 80GB HBM3 at 700 W) fit the card
ADAPTER_MESH_FAMILIES = ("ip_adapter",)
# the adapter mesh processes run at this niceness: they have slack, and the
# parent's phases beside them (host-bound) then keep the host's cores
SIDE_NICE = 19
ADAPTER_MESH_TRACE = {"#7": 140, "#8": 69, "#9": 0}
ADAPTER_MESH_PEAK_RTOL = 0.01


def start_sdxl_adapter_mesh_trainer(tmp: str, no_mesh: dict) -> dict:
    """Start ip_adapter_trainer's config under torchrun with the mesh."""
    script = os.path.join(tmp, "sdxl_adapter_mesh_entry.py")
    with open(script, "w") as f:
        f.write(MESH_ENTRY_SCRIPT.format(entry="sdxl.ip_adapter_ref"))
    return _mesh_start(tmp, "ip_adapter", no_mesh, script, {"data": 1, "fsdp": 1},
                       SDXL_MESH_PROFILE_STEPS, nice=SIDE_NICE)


def phase_sdxl_adapter_mesh_trainer(started: dict, no_mesh: dict, beside: dict) -> dict:
    """The IP-Adapter run under the mesh against ip_adapter_trainer's: the
    losses and the adapter file bit for bit, #7 / #8 in the profiled step,
    peak memory within ADAPTER_MESH_PEAK_RTOL; how long it ran past
    sdxl_mesh_trainer's runs (``beside``), which it started with."""
    phase = "sdxl_adapter_mesh_trainer"
    r = _mesh_result(started, no_mesh)
    past = (r["ended_wall"] - max(b["ended_wall"] for b in beside.values())
            if r["exit"] == 0 and all(b["exit"] == 0 for b in beside.values()) else None)
    peak, theirs = r.get("peak_memory_bytes"), no_mesh["peak_memory_bytes"]
    emit(phase, entry="train.sdxl.ip_adapter_ref", config=SDXL_TRAIN_CONFIGS["lora"]["path"],
         cuts="ip_adapter_trainer's (its file and tower, 1024^2, batch 2, 2 steps), "
              "trainer.deterministic: true in both; started beside sdxl_mesh_trainer's two "
              "torchrun runs at niceness SIDE_NICE, so its host-bound step times share the "
              "host and the card",
         run=r, seconds_past_sdxl_mesh_trainer=past,
         peak_rel_gap=abs(peak - theirs) / theirs if peak else None)
    check(r["exit"] == 0, f"{phase}: torchrun exit {r['exit']}: {r['log_tail']}")
    group = r["group"]
    check(group is not None and group[0] == "nccl" and group[1:3] == ("0", "1"),
          f"{phase}: process group {group}")
    check(len(r["losses"]) == SDXL_TRAIN_STEPS and r["losses"] == r["losses_no_mesh"],
          f"{phase}: losses {r['losses']} against {r['losses_no_mesh']}")
    check(r["trace_launches"] == r["expected_launches"] == ADAPTER_MESH_TRACE,
          f"{phase}: the trace's launches {r['trace_launches']}, the no-mesh step's "
          f"{r['expected_launches']}, expected {ADAPTER_MESH_TRACE}")
    check(len(r["saved"]) == len(r["saved_no_mesh"]) == 1 and all(r["files_equal"].values()),
          f"{phase}: saved {r['saved']} against {r['saved_no_mesh']}: {r['files_equal']}")
    check(peak is not None and abs(peak - theirs) <= ADAPTER_MESH_PEAK_RTOL * theirs,
          f"{phase}: peak memory {peak} against {theirs}")
    return r


# sdxl_adapter_mesh_reduced: one torchrun process at sdxl_parity's size (512^2,
# full widths, one layer and one transformer per stage: stage 2's
# self-attentions at S 1024 take #7 / #8) runs each case twice, without the
# mesh and then under {data 1, fsdp 1}, both trainer.deterministic; the pair
# must give the same losses and file bit for bit, and the mesh run's
# profiled second step the no-mesh second step's #7 / #8 / #9. Reduced, not
# full: DRaFT+ alone peaks at 73.3 GB at full width (draft_plus_trainer's run),
# which no other run can sit beside. Each case: (entry point, shipped config,
# model, data folder, PEFT type or None, optimizer or None)
ADAPTER_MESH_REDUCED = {
    "prompt_free": ("prompt_free_self", "lora", "pfg", "images", None, None),
    "rope_distill": ("rope_distill", "lora", "rope", "images", "lora", None),
    "draft_plus": ("draft_plus", "lora", "draft", "images", "lora", None),
    "style_tokenizer": ("style_tokenizer", "lora", "style", "referenced", None, None),
    "loha_nf4": (None, "qlora", "nf4", "images", "loha", None),
    "prodigy": ("text_to_image", "lora", "base", "images", "lora",
                {"name": "prodigy", "args": {"lr": 1.0}}),
    "adafactor": ("text_to_image", "lora", "base", "images", "lora",
                  {"name": "adafactor", "args": {"lr": 1e-3}}),
}
ADAPTER_MESH_REDUCED_STEPS = 2
# the process's own script: this file's function that runs the cases
ADAPTER_MESH_REDUCED_SCRIPT = """import sys

import chip_smoke

chip_smoke.adapter_mesh_reduced_main(sys.argv[1])
"""


def _mesh_reduced_configs(tmp: str, records: dict) -> dict:
    """Each case's config pair (no mesh, mesh), written; the cuts."""
    import yaml

    reduced = {"layers_per_block": 1, "num_transformers_per_block": [1, 1, 1]}
    timm_path, timm_shape = records["timm_small"]
    timm = {"type": "timm", "weights_path": timm_path, "feature_dim": timm_shape["embed_dim"],
            "num_heads": timm_shape["num_heads"]}
    models = {
        "pfg": {"adapter": {"image_encoder": timm}},
        "rope": {}, "base": {}, "nf4": {},
        "draft": {"total_steps": ADAPTER_MESH_REDUCED_STEPS, "sample_height": PARITY_SIDE,
                  "sample_width": PARITY_SIDE,
                  "reward_models": [{"type": "pickscore",
                                     "weights_path": records["pickscore_small"],
                                     "tokenizer": "word-hash"}]},
        "style": {"adapter": {"image_encoder": timm}},
    }
    cases = {}
    for name, (entry, base, model, folder, peft, optimizer) in ADAPTER_MESH_REDUCED.items():
        with open(os.path.join(ROOT, SDXL_TRAIN_CONFIGS[base]["path"])) as f:
            cfg = yaml.safe_load(f)
        cfg["model"] = {"checkpoint_path": None, "dtype": cfg["model"]["dtype"],
                        "tokenizer": "word-hash", **models[model]}
        cfg["model"]["denoiser"] = {**cfg["model"].get("denoiser", {}), **reduced}
        if peft is None:
            cfg["peft"] = None
        else:
            cfg["peft"]["config"]["type"] = peft
        if optimizer is not None:
            cfg["optimizer"] = optimizer
        cfg["dataset"].update(folder=records[folder], bucket_base_size=PARITY_SIDE,
                              num_repeats=ADAPTER_MESH_REDUCED_STEPS)
        if name == "style_tokenizer":
            cfg["dataset"]["caption_processors"] = [{"type": "prefix",
                                                     "prefix": STYLE_PREFIX}]
        cfg["num_train_epochs"] = 1
        cfg["preview"] = None
        cfg.setdefault("trainer", {})["deterministic"] = True
        pair = {}
        for side in ("no_mesh", "mesh"):
            work = os.path.join(tmp, "adapter_mesh_reduced", name, side)
            os.makedirs(work, exist_ok=True)
            side_cfg = json.loads(json.dumps(cfg))
            side_cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
            side_cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
            if side == "mesh":
                side_cfg["trainer"].update(mesh={"data": 1, "fsdp": 1}, distributed_init=True,
                                           profile_dir=os.path.join(work, "profile"),
                                           profile_steps=1)
            path = os.path.join(work, "config.yml")
            with open(path, "w") as f:
                yaml.safe_dump(side_cfg, f)
            pair[side] = {"config": path, "out": os.path.join(work, "out"),
                          "trace": os.path.join(work, "profile", "trace_rank0.json")}
        cases[name] = {"entry": entry, **pair}
    cuts = ["sdxl_parity's model: full widths, one layer and one transformer per stage, "
            f"{PARITY_SIDE}^2 buckets", "random weights from the seed, word-hash tokenizer",
            f"{SDXL_TRAIN_IMAGES} synthetic images, num_repeats "
            f"{ADAPTER_MESH_REDUCED_STEPS}, batch 2: {ADAPTER_MESH_REDUCED_STEPS} steps",
            "preview: null", "trainer.deterministic: true on both sides",
            "the towers: sdxl_adapter_parity's small timm ViT and sdxl_slice14_parity's "
            "small PickScore (2 layers, 128 wide, the token counts kept)",
            f"DRaFT+ {ADAPTER_MESH_REDUCED_STEPS} sampler steps at {PARITY_SIDE}^2",
            "LoHa over NF4: the QLoRA config's UNet linears quantized in place on the card "
            "(QLORA_QUANT_KEYS' modules) instead of read from a prequantized file"]
    return {"cases": cases, "cuts": cuts}


def start_sdxl_adapter_mesh_reduced(tmp: str, records: dict) -> dict:
    """Write the cases' configs and start the torchrun process over them."""
    spec = _mesh_reduced_configs(tmp, records)
    work = os.path.join(tmp, "adapter_mesh_reduced")
    spec_path, script = os.path.join(work, "spec.json"), os.path.join(work, "cases.py")
    spec["result"] = os.path.join(work, "result.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with open(script, "w") as f:
        f.write(ADAPTER_MESH_REDUCED_SCRIPT)
    command = ["nice", "-n", str(SIDE_NICE), sys.executable, "-m", "torch.distributed.run",
               "--standalone", "--nproc_per_node", "1", script, spec_path]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    log = open(os.path.join(work, "run.log"), "w")
    proc = subprocess.Popen(command, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "work": work, "spec": spec, "command": command,
            "t0": time.perf_counter()}


def adapter_mesh_reduced_main(spec_path: str) -> None:
    """The torchrun process of sdxl_adapter_mesh_reduced: each case's config
    without the mesh, then under it, in this process (one mesh of one NCCL
    rank for all); per-step launches and losses, the trace's launches, the
    files compared; the results as one JSON file."""
    import importlib

    from safetensors.torch import load_file

    import vision_pt_tpu_torch.training.trainer as trainer_module
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.parallel.mesh import make_mesh
    from vision_pt_tpu_torch.train.sdxl.text_to_image import train
    from vision_pt_tpu_torch.training.trainer import Trainer
    from vision_pt_tpu_torch.workloads.sdxl_text_to_image import SDXLForTextToImageTraining

    class InPlaceNF4(SDXLForTextToImageTraining):
        """The QLoRA config's NF4 base, quantized on the card after the build."""

        def setup_model(self):
            super().setup_model()
            # QLORA_QUANT_KEYS' linears by their module paths
            quantize_inplace(self.model.denoiser, "bnb_nf4",
                             include_keys=["attn1", "attn2", ".ff.", "proj_in", "proj_out"])

    with open(spec_path) as f:
        spec = json.load(f)
    meshes = {}

    def cached_mesh(config=None, devices=None):
        # one DeviceMesh (one set of NCCL groups) for every case
        if "mesh" not in meshes:
            meshes["mesh"] = make_mesh(config, devices)
        return meshes["mesh"]

    trainer_module.make_mesh = cached_mesh
    inner = Trainer.train_step
    results = {}
    for name, case in spec["cases"].items():
        result = {}
        for side in ("no_mesh", "mesh"):
            per_step, losses, peaks = [], [], []

            def counting(self, *args, **kwargs):
                if not per_step:
                    torch.cuda.reset_peak_memory_stats()
                before = _counts()
                loss, metrics = inner(self, *args, **kwargs)
                per_step.append(_diff(_counts(), before))
                losses.append(float(loss))
                peaks.append(torch.cuda.max_memory_allocated())
                return loss, metrics

            Trainer.train_step = counting
            t0 = time.perf_counter()
            try:
                if case["entry"] is None:
                    trainer = train(case[side]["config"], None, InPlaceNF4)
                else:
                    trainer = importlib.import_module(
                        f"vision_pt_tpu_torch.train.sdxl.{case['entry']}").run(
                            case[side]["config"])
            except Exception as e:  # recorded; the parent's checks report it
                result[side] = {"error": f"{type(e).__name__}: {e}"}
                continue
            finally:
                Trainer.train_step = inner
            trace = case[side]["trace"]
            result[side] = {
                "seconds": time.perf_counter() - t0, "losses": losses, "per_step": per_step,
                "peak_memory_bytes": max(peaks, default=None), "steps": trainer.global_step,
                "mesh": list(trainer.mesh.shape) if trainer.mesh is not None else None,
                "saved": sorted(os.listdir(case[side]["out"])),
                "trace_launches": _trace_launches(trace) if os.path.exists(trace) else None}
            del trainer
            torch.cuda.empty_cache()
        if all("error" not in result[s] for s in ("no_mesh", "mesh")):
            files = [load_file(os.path.join(case[s]["out"], result[s]["saved"][0]))
                     for s in ("no_mesh", "mesh") if len(result[s]["saved"]) == 1]
            result["files_equal"] = len(files) == 2 and files[0].keys() == files[1].keys() \
                and all(torch.equal(files[0][k], files[1][k]) for k in files[0])
            result["file_keys"] = len(files[0]) if files else 0
        results[name] = result
        print(f"[adapter_mesh_reduced] {name}: {json.dumps(result)}", flush=True)
    with open(spec["result"], "w") as f:
        json.dump(results, f)


def phase_sdxl_adapter_mesh_reduced(started: dict, beside: dict) -> dict:
    """Wait for the reduced process (killed past 600 s); each case's pair:
    the same losses and file bit for bit, the mesh run under NCCL's one rank,
    its trace's #7 / #8 / #9 the no-mesh second step's, #7 and #8 launched
    (and #9 over the NF4 base)."""
    phase = "sdxl_adapter_mesh_reduced"
    proc = started["proc"]
    try:
        proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - started["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    started["log"].close()
    log = os.path.join(started["work"], "run.log")
    with open(log) as f:
        text = f.read()
    results = {}
    if proc.returncode == 0 and os.path.exists(started["spec"]["result"]):
        with open(started["spec"]["result"]) as f:
            results = json.load(f)
    ended = os.path.getmtime(log)
    emit(phase, command=" ".join(started["command"][1:]), exit=proc.returncode,
         log_tail=text[-3000:] if proc.returncode else None, cuts=started["spec"]["cuts"],
         run_seconds=ended - (time.time() - (time.perf_counter() - started["t0"])),
         seconds_past_beside=ended - max(b["ended_wall"] for b in beside.values()),
         beside=sorted(beside),
         cases=results)
    check(proc.returncode == 0 and set(results) == set(ADAPTER_MESH_REDUCED),
          f"{phase}: exit {proc.returncode}, cases {sorted(results)}: {text[-2000:]}")
    for name, r in results.items():
        bare, mesh = r["no_mesh"], r["mesh"]
        check("error" not in bare and "error" not in mesh, f"{phase} {name}: {r}")
        check(bare["mesh"] is None and mesh["mesh"] == [1, 1, 1, 1],
              f"{phase} {name}: meshes {bare['mesh']}, {mesh['mesh']}")
        check(len(bare["losses"]) == ADAPTER_MESH_REDUCED_STEPS
              and bare["losses"] == mesh["losses"] and all(np.isfinite(bare["losses"])),
              f"{phase} {name}: losses {mesh['losses']} against {bare['losses']}")
        check(r["files_equal"] and r["file_keys"] > 0,
              f"{phase} {name}: files {mesh['saved']} against {bare['saved']}")
        second = bare["per_step"][1]
        expected = [second[6], second[7], second[8]]
        check(mesh["per_step"] == bare["per_step"] and mesh["trace_launches"] == expected
              and expected[0] > 0 and expected[1] > 0
              and (expected[2] > 0) == (name == "loha_nf4"),
              f"{phase} {name}: trace {mesh['trace_launches']}, no-mesh step 2 {expected}, "
              f"per step {mesh['per_step']} against {bare['per_step']}")
    return results


# ---------------------------------- the inference server

# inference_server: the port's server (tools.inference_server) on the QLoRA
# trainer's NF4 file and LoRA, over loopback HTTP. A seeded request at the
# server's defaults (768 x 1024, 25 steps, CFG 6.5) runs alone; 8 seedless
# 1024^2 requests (CFG 5, SERVER_GROUP_STEPS steps) queued while it runs form one group.
# Launches: the group's UNet calls (B 16) take #7 in all 70 self-attentions
# (10 at S 4096, 60 at S 1024) and #9 never (16 x 77 = 1,232 context rows,
# over the kernel's 1,024); the default request takes #7 only in stage 2
# (S 3,072; stage 3's S 768 is under MIN_FLASH_SEQ) and #9 in the 140 to_k /
# to_v products over 2 x 77 rows
# the group's steps: 5, to leave room for mesh_trainer and ring
SERVER_GROUP, SERVER_GROUP_STEPS, SERVER_GROUP_CFG = 8, 5, 5.0
SERVER_GROUP_LAUNCHES = _expect({7: 70 * SERVER_GROUP_STEPS})
SERVER_DEFAULT_LAUNCHES = _expect({7: 10 * 25, 9: 140 * 25})
SERVER_SEED = 1234
SERVER_PROMPTS = ("a red fox in the snow, detailed fur", "a lighthouse at dusk",
                  "portrait of a cat wearing a hat", "a bowl of ramen, top view",
                  "a mountain lake at sunrise", "an old steam locomotive",
                  "a watercolor of a city street", "a robot reading a book")
# an import check of the fp16 file (tools.checkpoint.import_sdxl): a strict
# load, a UNet forward at 1024^2 (70 #7 launches) and a 2-step generate
IMPORT_STEPS = 2
IMPORT_LAUNCHES = _expect({7: 70 + 70 * IMPORT_STEPS})


def _webp_image(body: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(body))


def phase_import_sdxl(tmp: str, fp16: str) -> tuple[int, ...]:
    """The port's import tool's ``run_import`` on the fp16 checkpoint, on
    the card, without the quant matrix."""
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig
    from vision_pt_tpu_torch.tools.checkpoint import import_sdxl

    _reset_counts()
    t0 = time.perf_counter()
    report = import_sdxl.run_import(SDXLConfig(checkpoint_path=fp16),
                                    os.path.join(tmp, "import_sdxl"),
                                    num_inference_steps=IMPORT_STEPS)
    seconds = time.perf_counter() - t0
    counts = _counts()
    emit("import_sdxl", tool="vision_pt_tpu_torch.tools.checkpoint.import_sdxl",
         checkpoint="the random fp16 sgm file", report=report, seconds=seconds,
         launches=counts, expected=IMPORT_LAUNCHES)
    check(report["denoiser_forward"] == "ok" and report["bf16"]["pixel_std"] > 0,
          f"import_sdxl report {report}")
    check(counts == IMPORT_LAUNCHES, f"import_sdxl launches {counts}, expected "
          f"{IMPORT_LAUNCHES}")
    torch.cuda.empty_cache()
    return counts


def phase_inference_server(tmp: str) -> dict[str, tuple[int, ...]]:
    """The port's server over loopback HTTP, on the QLoRA trainer's config
    (the NF4 file the quantize tool wrote, word-hash) with the LoRA it saved,
    driven from threads through the port's client; see SERVER_* above.
    Returns the launches of the drive, of its group and of its default
    request."""
    import threading
    import urllib.error
    import urllib.request

    from vision_pt_tpu_torch.tools import inference_client, inference_server
    from vision_pt_tpu_torch.tools.bench import check_memory
    from vision_pt_tpu_torch.tools.snapshot_max_memory import live_stats

    checkpoint = os.path.join(tmp, "sdxl_random.bnb_nf4.safetensors")
    fp16 = checkpoint.replace(".bnb_nf4.safetensors", ".fp16.safetensors")
    launches = {"import_sdxl": phase_import_sdxl(tmp, fp16)}
    os.remove(fp16)
    lora_dir = os.path.join(tmp, "qlora", "out")
    lora = os.path.join(lora_dir, os.listdir(lora_dir)[0])
    t0 = time.perf_counter()
    t2i = inference_server.T2IModel(os.path.join(tmp, "qlora", "config.yml"), lora)
    load_seconds = time.perf_counter() - t0
    os.remove(checkpoint)
    calls, started = [], threading.Event()
    generate_batch = t2i.batcher._generate_batch

    def counting(params_list):
        started.set()
        before = _counts()
        t0 = time.perf_counter()
        out = generate_batch(params_list)
        calls.append((len(params_list), _diff(_counts(), before), time.perf_counter() - t0))
        return out

    t2i.batcher._generate_batch = counting
    encoded = []
    encode = inference_server.encode_webp

    def recording(image):
        body = encode(image)
        encoded.append((image, body))
        return body

    P = inference_server.GenerationParams
    default = P(prompt=SERVER_PROMPTS[0], seed=SERVER_SEED)
    group = [P(prompt=p, width=1024, height=1024, inference_steps=SERVER_GROUP_STEPS,
               cfg_scale=SERVER_GROUP_CFG) for p in SERVER_PROMPTS]
    # untimed warm-ups of both shapes, 2 steps
    t2i._generate_batch([default.model_copy(update={"inference_steps": 2})])
    t2i._generate_batch([g.model_copy(update={"inference_steps": 2}) for g in group])
    calls.clear()

    server = inference_server.serve(t2i, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results, failures = {}, []

    def client(key, params):
        try:
            t0 = time.perf_counter()
            images, status = inference_client.generate_image(
                url, params.prompt, params.negative_prompt, params.width, params.height,
                params.inference_steps, params.cfg_scale, seed=params.seed)
            results[key] = (images[0], time.perf_counter() - t0, status)
        except Exception as e:  # noqa: BLE001 - failed below, by name
            failures.append((key, repr(e)))

    inference_server.encode_webp = recording
    try:
        with urllib.request.urlopen(f"{url}/health") as resp:
            health = json.loads(resp.read())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        first = threading.Thread(target=client, args=("default", default))
        t_default = time.perf_counter()
        first.start()
        check(started.wait(timeout=600), "the seeded request never reached the sampler")
        t_group = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, g)) for i, g in enumerate(group)]
        for t in threads:
            t.start()
        first.join()
        for t in threads:
            t.join()
        group_seconds = time.perf_counter() - t_group
        drive_seconds = time.perf_counter() - t_default
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        reported = {"check_memory": check_memory.report("inference_server")[0][
            "peak_bytes_in_use"], "snapshot_max_memory": live_stats()[0]["peak_bytes_in_use"]}
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/predict", data=b'{"prompt": "x", "width": 1000}',
                headers={"Content-Type": "application/json"}))
            malformed = 200
        except urllib.error.HTTPError as e:
            malformed = e.code
    finally:
        inference_server.encode_webp = encode
        server.shutdown()
        server.server_close()
    check(not failures, f"requests failed: {failures}")
    check(health == {"status": "ok"}, f"/health answered {health}")
    sizes = [n for n, _, _ in calls]
    # the seeded response against the same request made directly and
    # encoded as the server encodes it
    served_image, served_body = next((image, body) for image, body in encoded
                                     if image.size == (default.width, default.height))
    direct = t2i.model.generate(
        prompt=[default.prompt], negative_prompt=[default.negative_prompt],
        num_inference_steps=default.inference_steps, cfg_scale=default.cfg_scale,
        width=default.width, height=default.height, seed=default.seed)[0]
    direct_body = encode(direct)
    pixel_gap = float(np.abs(np.asarray(direct, np.int16)
                             - np.asarray(served_image, np.int16)).max())
    same_bytes = direct_body == served_body
    for key, (image, seconds, _) in results.items():
        params = default if key == "default" else group[key]
        check(image.format == "WEBP" and image.size == (params.width, params.height),
              f"response {key}: {image.format} {image.size}")
        pixels = np.asarray(image.convert("RGB"), np.float32)
        check(np.isfinite(pixels).all() and pixels.std() > 0,
              f"response {key}: a constant or non-finite image")
    check(np.array_equal(np.asarray(results["default"][0].convert("RGB")),
                         np.asarray(_webp_image(served_body).convert("RGB"))),
          "the seeded response is not the image the server encoded")
    group_counts = next((c for n, c, _ in calls if n == SERVER_GROUP), None)
    default_counts = next((c for n, c, _ in calls if n == 1), None)
    group_call = next((sec for n, _, sec in calls if n == SERVER_GROUP), None)
    group_requests = [results[i][1] for i in range(SERVER_GROUP)]
    emit("inference_server", tool="vision_pt_tpu_torch.tools.inference_server",
         config="configs/sdxl/text_to_image_qlora_nf4.yml (the QLoRA trainer's copy)",
         checkpoint="NF4 file written by tools.quantize_model from the random fp16 file",
         lora=os.path.basename(lora), load_seconds=load_seconds,
         health=health, malformed_status=malformed, batch_sizes=sizes,
         default_request={"width": default.width, "height": default.height,
                          "steps": default.inference_steps, "cfg": default.cfg_scale,
                          "seconds": results["default"][1],
                          "sampler_seconds": next((sec for n, _, sec in calls if n == 1),
                                                  None)},
         group={"requests": SERVER_GROUP, "side": 1024, "steps": SERVER_GROUP_STEPS,
                "cfg": SERVER_GROUP_CFG, "sampler_seconds": group_call,
                "seconds_per_image": group_call / SERVER_GROUP,
                "images_per_second": SERVER_GROUP / group_call,
                "request_seconds": group_requests,
                "last_response_after_seconds": group_seconds},
         drive_seconds=drive_seconds, launches=counts,
         launches_group=group_counts, expected_group=SERVER_GROUP_LAUNCHES,
         launches_default=default_counts, expected_default=SERVER_DEFAULT_LAUNCHES,
         seeded_same_bytes=same_bytes, seeded_max_pixel_gap=pixel_gap,
         peak_memory_bytes=peak, reported_peaks=reported)
    check(malformed == 422, f"a malformed body got {malformed}, expected 422")
    check(sizes == [1, SERVER_GROUP], f"sampler calls of {sizes}, expected [1, 8]")
    check(group_counts == SERVER_GROUP_LAUNCHES,
          f"the group launched {group_counts}, expected {SERVER_GROUP_LAUNCHES}")
    check(default_counts == SERVER_DEFAULT_LAUNCHES,
          f"the default request launched {default_counts}, expected "
          f"{SERVER_DEFAULT_LAUNCHES}")
    check(same_bytes or pixel_gap <= 1,
          f"the seeded response differs from the direct generate: {pixel_gap} levels")
    check(reported == {"check_memory": peak, "snapshot_max_memory": peak},
          f"reported peaks {reported}, torch.cuda.max_memory_allocated {peak}")
    # where a group's time goes: 2 steps, profiled (device alone)
    profile("inference_server_group", lambda: t2i._generate_batch(
        [g.model_copy(update={"inference_steps": 2}) for g in group]))
    del t2i, direct
    torch.cuda.empty_cache()
    launches.update(inference_server=counts, inference_server_group=group_counts,
                    inference_server_default=default_counts)
    return launches


# the fp32 witness of a parity step: the same step in fp32 on the card
# (kernels) and on the CPU, attention in fp32 and TF32 off for matmuls and
# cuDNN convolutions on both sides; every adapter gradient within 1e-3
# relative L2 says the bf16 steps' gap is rounding, not a fault
SDXL_FP32_WITNESS_FLOOR = 1e-3


PARITY_SIDE = 512  # the SDXL parity phases' resolution
# the flow-match and adapter parity samples' steps: 2, so the sampler's
# state from one step to the next is compared too
PARITY_SAMPLE_STEPS = 2


def _parity_config(dtype: str, peft: dict, **model) -> dict:
    """sdxl_parity's model (full widths, one layer and one transformer per
    stage) with ``peft``, as a TrainConfig dict."""
    return {"model": {"checkpoint_path": None, "dtype": dtype, "tokenizer": "word-hash",
                      "max_token_length": 75,
                      "denoiser": {"layers_per_block": 1,
                                   "num_transformers_per_block": [1, 1, 1]}, **model},
            "dataset": {}, "peft": peft, "seed": 1}


def _parity_step(workload, batch: dict, draws: dict, kernels: bool = True):
    """Loss, adapter gradients, launches and seconds of one step; with
    ``kernels`` the gates are open (the CPU runs the same path through the
    plain versions), without, the card takes the plain versions."""
    import vision_pt_tpu_torch.ops.attention as attention
    from vision_pt_tpu_torch.ops.quant import layers as qlayers

    arrays = workload.prepare_batch(batch)
    trainable = workload.trainable()
    trainable.zero_grad(set_to_none=True)
    _reset_counts()
    gates = attention._on_cuda, qlayers._on_cuda
    attention._on_cuda = qlayers._on_cuda = lambda x: kernels
    t0 = time.perf_counter()
    try:
        loss, _ = workload.compute_loss(trainable, arrays, {
            k: [x.to(workload.device) for x in v] if isinstance(v, list)
            else v.to(workload.device) for k, v in draws.items()})
        loss.backward()
    finally:
        attention._on_cuda, qlayers._on_cuda = gates
    grads = {n: p.grad.float().cpu().numpy() for n, p in trainable.named_parameters()
             if p.requires_grad}
    return float(loss.detach()), grads, _counts(), time.perf_counter() - t0


def _parity_errors(ours, theirs):
    return (abs(ours[0] - theirs[0]) / abs(theirs[0]),
            {n: _rel_l2(ours[1][n], theirs[1][n]) for n in theirs[1]})


def _parity_verdict(run, host, witness):
    """The names of the gradients over SDXL_LORA_PARITY_FLOOR (the loss as
    "loss")."""
    loss_err, grad_err = _parity_errors(run, host)
    floor = SDXL_LORA_PARITY_FLOOR
    over = [n for n, e in grad_err.items()
            if e > max(floor["grad"], floor["witness"] * witness[n])]
    return over + (["loss"] if loss_err > floor["loss"] else [])


def _cpu_twin(workload_cls, config, card):
    """The shipped card workload's model and training tree as a CPU
    workload (the worker's copy is its own, so nothing is copied again)."""
    host = workload_cls(config, torch.device("cpu"))
    host.model, host._full_trainable = card.model, card._full_trainable
    host.model.to("cpu")
    host._is_peft = True
    if hasattr(card, "_drop_rng"):  # the image adapters' host-side draws
        host._drop_rng = card._drop_rng
    if hasattr(card, "reward_models"):  # DRaFT+'s frozen reward towers
        host.reward_models = card.reward_models
        for reward in host.reward_models:
            if getattr(reward, "model", None) is not None:
                reward.model.to("cpu")
    return host


def _exact_fp32():
    """TF32 off for matmuls and cuDNN (``_tf32_off``) and fp32 attention,
    for the fp32 witnesses; restored after."""
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    @contextlib.contextmanager
    def scope():
        with _tf32_off(), attention_dtype(None):
            yield

    return scope()


def _cpu_parity_step(card, workload_cls, config, batch: dict, draws: dict,
                     fp32: bool = False):
    """A worker job: one step of the shipped card workload's CPU twin, the
    gates open (the plain versions); in fp32 under ``_exact_fp32``."""
    host = _cpu_twin(workload_cls, config, card)
    if not fp32:
        return _parity_step(host, batch, draws)
    with _exact_fp32():
        return _parity_step(host, batch, draws)


def _perturb_adapters(tree, names: tuple[str, ...], seed: int, scale: float) -> None:
    """Draw the adapter factors that start at 0 (``lora_up``, ``hada_w2_a``)
    so every factor has a gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in tree.named_parameters():
            if name.endswith(names):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * scale)


def _attach(card, peft: dict, seed: int = 1) -> None:
    """Adapters from ``peft`` on the card workload's tree, the zero factors
    drawn, the base frozen."""
    from vision_pt_tpu_torch.peft import (
        PeftTargetConfig,
        freeze_all_but_adapters,
        replace_to_peft_layer,
    )

    tree = card._full_trainable
    replace_to_peft_layer(tree, peft["include_keys"], peft["exclude_keys"],
                          PeftTargetConfig.model_validate(peft).config, seed=seed)
    _perturb_adapters(tree, ("lora_up.weight", "hada_w2_a"), seed + 1, 0.05)
    freeze_all_but_adapters(tree)
    card._is_peft = True


def _generate_latents(pipeline, request: dict, kernels: bool = True):
    """``pipeline.generate(**request)``'s latents with the flash gate open
    (``kernels``: the CPU runs the plain versions of the same path) or
    closed; (latents, seconds, launches)."""
    import vision_pt_tpu_torch.ops.attention as attention

    opened = attention._on_cuda
    attention._on_cuda = lambda x: kernels
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out = pipeline.generate(**request, return_latents=True)
    finally:
        attention._on_cuda = opened
    return out.float().cpu().numpy(), time.perf_counter() - t0, _counts()


def _cpu_twin_generate(card, workload_cls, config, request: dict):
    """A worker job: ``_generate_latents`` on the shipped workload's CPU twin."""
    return _generate_latents(_cpu_twin(workload_cls, config, card).model, request)


def _fp32_witness(phase: str, workload_cls, config: dict, card, batch: dict,
                  draws: dict, floor: float = SDXL_FP32_WITNESS_FLOOR) -> None:
    """The bf16 card workload's step in fp32 on the card (kernels) and on the
    CPU (in the worker), from the same weights and adapters, held to
    ``floor``; emits every gradient's relative L2."""
    from vision_pt_tpu_torch.config import TrainConfig

    peft = config["peft"]
    if peft is not None:
        peft = {**peft, "config": {**peft["config"], "dtype": "float32"}}
    config = TrainConfig.model_validate(
        {**config, "model": {**config["model"], "dtype": "float32"}, "peft": peft})
    twin = workload_cls(config, torch.device("cuda"))
    twin.setup_model()
    if peft is not None:
        _attach(twin, peft)
    # the card tree's weights and adapters (parameters fp32, adapters bf16)
    twin._full_trainable.load_state_dict(
        {k: v.float() for k, v in card._full_trainable.state_dict().items()}, strict=True)
    future = _HALVES.submit(f"{phase} fp32_witness", _cpu_parity_step, workload_cls,
                            config, batch, draws, True, ship=_HALVES.ship(twin))
    with _exact_fp32():
        run = _parity_step(twin, batch, draws)
    check(np.isfinite(run[0]), f"{phase}: fp32 witness step")

    def finish(cpu, where):
        loss_err, grad_err = _parity_errors(run, cpu)
        worst = max(grad_err.values()) if grad_err else float("nan")
        short = {n.removeprefix("denoiser.").replace(".weight", ""): float(f"{e:.3g}")
                 for n, e in grad_err.items()}
        emit(phase, case="fp32_witness", dtype="float32", attention_dtype=None,
             tf32=False, **where, loss_cuda=run[0], loss_cpu=cpu[0],
             loss_rel_err=loss_err, grad_rel_l2_max=worst,
             grad_rel_l2_median=float(np.median(list(grad_err.values()))),
             floor=floor, launches_cuda=run[2], grad_rel_l2=short,
             seconds_cuda=run[3], seconds_cpu=cpu[3])
        check(len(grad_err) > 0, f"{phase}: fp32 witness step without gradients")
        check(worst <= floor and loss_err <= floor,
              f"{phase}: the fp32 step's card-vs-CPU gap {worst:.3g} (loss {loss_err:.3g}) "
              f"is over {floor}: a fault, not bf16 rounding")

    _HALVES.then(future, finish)
    del twin
    torch.cuda.empty_cache()


def _wrong_kernel_runs(step, nf4: bool) -> dict:
    """One card step with #7 / #8 dropping the last key tile (64 keys) and,
    under NF4, one with #9's scale row 3 25% off."""
    import vision_pt_tpu_torch.ops.attention as attention
    from vision_pt_tpu_torch.ops.quant import layers as qlayers

    kernel, flash = qlayers.dequant_matmul_4bit, attention.flash_attention

    def short_flash(q, k, v, kv_lens=None, **kw):
        lens = torch.full((q.shape[0],), k.shape[1] - 64, dtype=torch.int32,
                          device=q.device)
        return flash(q, k, v, lens, **kw)

    def wrong_nf4(x, packed, absmax, quant_type="nf4"):
        absmax = absmax.clone()
        absmax[3 % absmax.shape[0]] *= 1.25
        return kernel(x, packed, absmax, quant_type)

    runs = {}
    for label, module, name, fn in (
            ("flash_last_tile_dropped", attention, "flash_attention", short_flash),
            ("nf4_absmax_row_perturbed", qlayers, "dequant_matmul_4bit", wrong_nf4)):
        if module is qlayers and not nf4:
            continue
        real = getattr(module, name)
        setattr(module, name, fn)
        try:
            runs[label] = step()
        finally:
            setattr(module, name, real)
    return runs


def _wrong_kernel_verdicts(runs: dict, cpu, witness, plain,
                           kernel_floor: float | None = None) -> tuple[dict, dict]:
    """Each wrong step's verdict (the names over the floors, against the CPU
    and, with ``kernel_floor``, against ``plain``, the card's step through
    the plain versions) and its largest gradient error against ``plain``."""
    wrong, vs_plain = {}, {}
    for label, run in runs.items():
        vs_plain[label] = _parity_errors(run, plain)[1]
        wrong[label] = _parity_verdict(run, cpu, witness) + (
            [] if kernel_floor is None else
            [f"{n} vs plain" for n, e in vs_plain[label].items() if e > kernel_floor])
    return wrong, {label: max(errors.values()) for label, errors in vs_plain.items()}


def _parity_case(phase: str, label: str, workload_cls, config, card, batch, draws,
                 expected, n_grads, kernel_floor: float | None = None,
                 **fields) -> tuple[int, ...]:
    """One adapter step, card (kernels) against CPU (in the worker) with the
    card's plain versions as the witness, held to SDXL_LORA_PARITY_FLOOR
    and, with ``kernel_floor``, every gradient within that of the card's
    plain run; the floors must fail the wrong kernels. Emits the phase line
    when the CPU half is in; returns the card step's launches."""
    future = _HALVES.submit(f"{phase} {label}", _cpu_parity_step, workload_cls, config,
                            batch, draws, ship=_HALVES.ship(card))
    run = _parity_step(card, batch, draws)
    plain = _parity_step(card, batch, draws, kernels=False)
    runs = _wrong_kernel_runs(lambda: _parity_step(card, batch, draws), nf4=expected[8] > 0)
    check(np.isfinite(run[0]) and all(np.isfinite(g).all() for g in run[1].values()),
          f"non-finite {phase} {label} step")
    check(len(run[1]) == n_grads,
          f"{phase} {label}: {len(run[1])} adapter gradients, expected {n_grads}")
    check(run[2] == expected and plain[2] == _expect({}),
          f"{phase} {label} launches: card {run[2]}, expected {expected}; plain "
          f"{plain[2]}, expected none")

    def finish(cpu, where):
        loss_err, grad_err = _parity_errors(run, cpu)
        witness = _parity_errors(plain, cpu)[1]
        worst = max(grad_err, key=grad_err.get)
        kernel_err = _parity_errors(run, plain)[1]
        over = _parity_verdict(run, cpu, witness) + (
            [] if kernel_floor is None else
            [f"{n} vs plain" for n, e in kernel_err.items() if e > kernel_floor])
        wrong, wrong_vs_plain = _wrong_kernel_verdicts(runs, cpu, witness, plain,
                                                       kernel_floor)
        emit(phase, case=label, resolution=PARITY_SIDE, batch=len(batch["caption"]),
             depth="layers_per_block 1, one transformer per stage", **fields, **where,
             adapters=len(grad_err), loss_cuda=run[0], loss_cpu=cpu[0],
             loss_cuda_plain=plain[0], loss_rel_err=loss_err,
             grad_rel_l2_max=grad_err[worst], worst_param=worst,
             worst_witness=witness[worst],
             grad_rel_l2_median=float(np.median(list(grad_err.values()))),
             witness_max=max(witness.values()),
             witness_median=float(np.median(list(witness.values()))),
             card_vs_plain_max=max(kernel_err.values()), kernel_floor=kernel_floor,
             wrong_kernel_vs_plain_max=wrong_vs_plain,
             over_floor=over, wrong_kernel_over_floor=wrong,
             floor=SDXL_LORA_PARITY_FLOOR, launches_cuda=run[2],
             launches_cuda_plain=plain[2], launches_cpu=cpu[2], expected_cuda=expected,
             seconds_cuda=run[3], seconds_cpu=cpu[3])
        check(run[1].keys() == cpu[1].keys(),
              f"{phase} {label}: the card and CPU steps' adapter gradients differ in name")
        check(all(np.abs(g).max() > 0 for g in cpu[1].values()),
              f"{phase} {label}: an adapter gradient is 0")
        check(cpu[2] == _expect({}), f"{phase} {label} launches on the CPU: {cpu[2]}")
        check(not over, f"{phase} {label} over its floors: {over[:4]}")
        check(all(wrong.values()), f"a {phase} floor passes a wrong kernel: {wrong}")

    _HALVES.then(future, finish)
    return run[2]


@_tf32_off()
def phase_sdxl_lora_parity() -> None:
    """One LoRA training step, card against CPU: sdxl_parity's model at
    512^2, random weights, nonzero lora_up, cached latents, injected draws,
    bf16; its fp32 witness; then with the UNet NF4. Held to
    SDXL_LORA_PARITY_FLOOR, with the card's plain versions as the witness."""
    import yaml

    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.tools import inference_cli as cli
    from vision_pt_tpu_torch.workloads.sdxl_text_to_image import (
        SDXLForTextToImageTraining,
    )

    with open(os.path.join(ROOT, SDXL_TRAIN_CONFIGS["lora"]["path"])) as f:
        peft = yaml.safe_load(f)["peft"]
    raw = _parity_config("bfloat16", peft)
    config = TrainConfig.model_validate(raw)
    rng = np.random.default_rng(6)
    latent = (2, PARITY_SIDE // 8, PARITY_SIDE // 8, 4)
    # the first of the two samples (SDXL_LORA_PARITY_CUT)
    batch = {"latents": rng.normal(size=latent).astype(np.float32)[:1],
             "caption": ["1girl, solo, red hair, looking at viewer"],
             "original_size": np.full((1, 2), PARITY_SIDE, np.int32),
             "target_size": np.full((1, 2), PARITY_SIDE, np.int32),
             "crop_coords_top_left": np.zeros((1, 2), np.int32)}
    draws = {"timesteps": torch.tensor([150], dtype=torch.int32),
             "noise": torch.from_numpy(rng.normal(size=latent).astype(np.float32)[:1])}
    card = SDXLForTextToImageTraining(config, torch.device("cuda"))
    card.setup_model()
    for label in ("bf16", "nf4"):
        if label == "nf4":
            card.setup_model()
            quantize_inplace(card.model.denoiser, "bnb_nf4", cli.INCLUDE_KEYS,
                             cli.EXCLUDE_KEYS)
        _attach(card, peft)
        _parity_case("sdxl_lora_parity", label, SDXLForTextToImageTraining, config, card,
                     batch, draws, SDXL_LORA_PARITY_LAUNCHES[label], 2 * 70, unet=label,
                     cuts=[SDXL_LORA_PARITY_CUT],
                     inputs="a cached latent, 75 tokens, injected draws, lora_up nonzero")
        if label == "bf16":
            _fp32_witness("sdxl_lora_parity", SDXLForTextToImageTraining, raw, card,
                          batch, draws)
    del card
    torch.cuda.empty_cache()


# sdxl_flow_match_parity: sdxl_lora_parity's model, built once, with the
# flow-match config's LoRA (rank 8 on attn1 / attn2 / .ff.), from an image
# (batch 1): the LoRA step (#7 / #8 3 + 3, as sdxl_lora_parity),
# a PARITY_SAMPLE_STEPS-step CFG generate from injected latents (#7 3 a UNet
# call), the fp32
# witness of the step, and the step with LoHa over the UNet NF4 (#9 84, as
# sdxl_lora_parity's NF4 step; the LoHa product itself is dense)
FLOW_MATCH_PARITY_LAUNCHES = {"lora": _expect({7: 3, 8: 3}),
                              "loha_nf4": _expect({7: 3, 8: 3, 9: 84}),
                              "generate": _expect({7: 3 * PARITY_SAMPLE_STEPS})}
FLOW_MATCH_PARITY_LATENTS_FLOOR = SDXL_PARITY_FLOOR["latents"]
# its model is sdxl_parity's depth already, so it is cut to the first of the
# two samples it held: its CPU steps took 31-36 s (LoRA), 15-25 s (the fp32
# witness) and 41 s (LoHa NF4) at batch 2 on an H100's host, 15-17, 7-8 and
# 22-25 s at batch 1
FLOW_MATCH_PARITY_CUT = ("batch 1, not 2: ≈ 50 s saved over the LoRA step, its fp32 "
                         "witness and the LoHa NF4 step")


def _unwrap_adapters(tree) -> None:
    """Put each adapter's base linear back in its place."""
    from vision_pt_tpu_torch.peft.functional import peft_layers

    for path, layer in list(peft_layers(tree)):
        parent, _, name = path.rpartition(".")
        setattr(tree.get_submodule(parent) if parent else tree, name, layer.linear)


@_tf32_off()
def phase_sdxl_flow_match_parity() -> dict[str, tuple[int, ...]]:
    """The flow-match workload card against CPU at 512^2 on one model: (a) a
    LoRA step from images with injected VAE noise, timesteps and noise, (c)
    ``SDXLFlowMatch.generate`` 2 steps with CFG from injected latents, (d)
    the fp32 witness of (a), (b) the step with LoHa over the UNet NF4.
    Returns the card runs' launches."""
    import yaml

    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.tools import inference_cli as cli
    from vision_pt_tpu_torch.workloads.sdxl_flow_match import (
        SDXLForFlowMatchingTraining,
    )

    phase = "sdxl_flow_match_parity"
    with open(os.path.join(ROOT, SDXL_TRAIN_CONFIGS["flow_match"]["path"])) as f:
        shipped = yaml.safe_load(f)
    peft = shipped["peft"]
    fields = {k: shipped["model"][k] for k in ("model_prediction", "noise_scale",
                                                "clean_at_zero")}
    raw = _parity_config("bfloat16", peft, **fields)
    config = TrainConfig.model_validate(raw)
    rng = np.random.default_rng(7)
    side = PARITY_SIDE
    yy, xx = np.mgrid[0:side, 0:side] / side
    images = np.stack([np.stack([np.sin(3 * xx + i), np.cos(2 * yy - i), xx * yy - 0.5], -1)
                       for i in range(2)]) + rng.normal(0, 0.05, size=(2, side, side, 3))
    batch = {"image": np.clip(images, -1, 1).astype(np.float32)[:1],
             "caption": ["1girl, solo, red hair, looking at viewer"],
             "original_size": np.full((1, 2), side, np.int32),
             "target_size": np.full((1, 2), side, np.int32),
             "crop_coords_top_left": np.zeros((1, 2), np.int32)}
    latent = (2, side // 8, side // 8, 4)
    draws = {"vae_noise": torch.from_numpy(rng.normal(size=latent).astype(np.float32)[:1]),
             "timesteps": torch.tensor([310.0]),
             "noise": torch.from_numpy(rng.normal(size=latent).astype(np.float32)[:1])}
    card = SDXLForFlowMatchingTraining(config, torch.device("cuda"))
    card.setup_model()
    _attach(card, peft)
    common = dict(inputs="an image, 75 tokens, injected VAE noise, timestep and noise",
                  model_prediction=fields["model_prediction"],
                  cuts=[FLOW_MATCH_PARITY_CUT])
    launches = {"sdxl_flow_match_lora": _parity_case(
        phase, "lora", SDXLForFlowMatchingTraining, config, card, batch, draws,
        FLOW_MATCH_PARITY_LAUNCHES["lora"], 2 * 70, adapters_type="lora", **common)}

    # (c) the sampler, PARITY_SAMPLE_STEPS Euler steps with CFG 4 from the same latents
    init = rng.normal(size=(1, side // 8, side // 8, 4)).astype(np.float32)
    request = dict(prompt=[SDXL_PROMPT[0]], negative_prompt=[SDXL_PROMPT[1]], width=side,
                   height=side, num_inference_steps=PARITY_SAMPLE_STEPS, cfg_scale=4.0,
                   latents=init)
    future = _HALVES.submit(f"{phase} generate", _cpu_twin_generate,
                            SDXLForFlowMatchingTraining, config, request,
                            ship=_HALVES.ship(card))
    card_out = _generate_latents(card.model, request)
    check(np.isfinite(card_out[0]).all(), "non-finite flow-match latents")
    check(card_out[2] == FLOW_MATCH_PARITY_LAUNCHES["generate"],
          f"flow-match generate launches {card_out[2]} on the card")
    launches["sdxl_flow_match_generate"] = card_out[2]

    def finish(host_out, where):
        err = _rel_l2(card_out[0], host_out[0])
        emit(phase, case="generate", resolution=side, steps=PARITY_SAMPLE_STEPS, cfg=4.0,
             **where,
             latents_rel_l2=err, floor=FLOW_MATCH_PARITY_LATENTS_FLOOR,
             launches_cuda=card_out[2], launches_cpu=host_out[2],
             seconds_cuda=card_out[1], seconds_cpu=host_out[1])
        check(host_out[2] == _expect({}), f"flow-match generate launches {host_out[2]} "
              "on the CPU")
        check(err <= FLOW_MATCH_PARITY_LATENTS_FLOOR,
              f"flow-match generate card-vs-CPU latents {err:.3g}")

    _HALVES.then(future, finish)

    # (d) the fp32 witness of (a)
    _fp32_witness(phase, SDXLForFlowMatchingTraining, raw, card, batch, draws)

    # (b) LoHa over the UNet NF4, on the same base weights
    _unwrap_adapters(card._full_trainable)
    quantize_inplace(card.model.denoiser, "bnb_nf4", cli.INCLUDE_KEYS, cli.EXCLUDE_KEYS)
    loha = {**peft, "config": {"type": "loha", "rank": 8, "alpha": 1.0,
                               "dtype": "bfloat16"}}
    _attach(card, loha)
    loha_config = TrainConfig.model_validate({**raw, "peft": loha})
    launches["sdxl_flow_match_loha_nf4"] = _parity_case(
        phase, "loha_nf4", SDXLForFlowMatchingTraining, loha_config, card, batch, draws,
        FLOW_MATCH_PARITY_LAUNCHES["loha_nf4"], 4 * 70, adapters_type="loha", unet="nf4",
        **common)
    del card
    torch.cuda.empty_cache()
    return launches


# ---------------------------------- the optax optimizers and int8 training

# (name, args) of the optax rules the port ports (training/optax_optimizers.py)
OPTIMIZER_CASES = (("prodigy", {"lr": 1.0, "weight_decay": 1e-2}), ("lion", {"lr": 1e-3}),
                   ("adafactor", {"lr": 1e-2}), ("rmsprop", {"lr": 1e-3}),
                   ("adagrad", {"lr": 1e-2}))
# the port's layouts: a linear (out, in), a conv OIHW, a bias, and two
# weights adafactor factors (largest dims differing, and tied)
OPTIMIZER_SHAPES = ((7, 5), (6, 4, 3, 3), (300,), (160, 256), (128, 128))
OPTIMIZER_STEPS, OPTIMIZER_FLOOR = 20, 1e-5
# Int8TrainLinear at an SDXL feed-forward's shape (B 2, S 1024, 1280 -> 640)
# and at one that pads every operand of torch._int_mm (M 5, K 36, N 20)
INT8_SHAPES = ((2, 1024, 1280, 640), (1, 5, 36, 20))


@_tf32_off()
def phase_optimizers() -> tuple[int, ...]:
    """Each optax rule 20 steps on the same numpy-made parameters and
    gradients, card against CPU, every parameter within OPTIMIZER_FLOOR
    relative L2; then ``Int8TrainLinear`` forward and backward, card against
    CPU: the int32 product equal bit for bit, the bf16 output within one bf16
    rounding and the gradients within 1e-2 relative L2 (bf16 products
    summed in another order)."""
    from vision_pt_tpu_torch.ops.linear import Linear
    from vision_pt_tpu_torch.ops.quant.int8_training import (
        Int8TrainLinear,
        _rowwise_quant,
        int8_product,
    )
    from vision_pt_tpu_torch.training.optimizer import get_optimizer

    rng = np.random.default_rng(9)
    init = [rng.normal(size=s).astype(np.float32) * 0.5 for s in OPTIMIZER_SHAPES]
    steady = [rng.normal(size=s).astype(np.float32) for s in OPTIMIZER_SHAPES]
    grads = [[(d + 0.5 * rng.normal(size=d.shape)).astype(np.float32) for d in steady]
             for _ in range(OPTIMIZER_STEPS)]
    t_phase = time.perf_counter()
    _reset_counts()
    for name, args in OPTIMIZER_CASES:
        results, seconds = {}, {}
        for device in ("cuda", "cpu"):
            params = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(device))
                      for p in init]
            opt = get_optimizer(name, params, dict(args))
            steps = [[torch.from_numpy(g).to(device) for g in step] for step in grads]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in steps:
                for p, g in zip(params, step):
                    p.grad = g
                opt.step()
            torch.cuda.synchronize()
            seconds[device] = time.perf_counter() - t0
            results[device] = [p.detach().cpu().numpy() for p in params]
        errors = [_rel_l2(a, b) for a, b in zip(results["cuda"], results["cpu"])]
        moved = [_rel_l2(a, b) for a, b in zip(results["cpu"], init)]
        emit("optimizers", optimizer=name, optimizer_class=type(opt).__name__,
             args=args, steps=OPTIMIZER_STEPS, shapes=OPTIMIZER_SHAPES,
             rel_l2_card_vs_cpu=errors, moved_rel_l2=moved, floor=OPTIMIZER_FLOOR,
             seconds_cuda=seconds["cuda"], seconds_cpu=seconds["cpu"])
        check(max(errors) <= OPTIMIZER_FLOOR, f"{name} card vs CPU {errors}")
        check(min(moved) > 1e-6, f"{name} left a parameter where it was: {moved}")

    for batch, rows, din, dout in INT8_SHAPES:
        x = rng.normal(size=(batch, rows, din)).astype(np.float32)
        g = rng.normal(size=(batch, rows, dout)).astype(np.float32)
        out = {}
        base = Linear(din, dout, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(3), std=None)
        for device in ("cuda", "cpu"):
            lin = Linear(din, dout, dtype=torch.bfloat16).to(device)
            lin.load_state_dict(base.state_dict())
            lin.__class__ = Int8TrainLinear
            tx = torch.from_numpy(x).to(device, torch.bfloat16).requires_grad_()
            y = lin(tx)
            (y.float() * torch.from_numpy(g).to(device)).sum().backward()
            xq, _ = _rowwise_quant(tx.detach().reshape(-1, din))
            wq, _ = _rowwise_quant(lin.weight.detach().to(torch.bfloat16))
            out[device] = [t.detach().float().cpu().numpy() for t in
                           (int8_product(xq, wq), y, tx.grad, lin.weight.grad, lin.bias.grad)]
        card, host = out["cuda"], out["cpu"]
        product_equal = bool(np.array_equal(card[0], host[0]))
        errors = {k: _rel_l2(a, b) for k, a, b in
                  zip(("output", "dx", "dweight", "dbias"), card[1:], host[1:])}
        emit("optimizers", case="int8_train_linear", shape=[batch, rows, din, dout],
             dtype="bfloat16", int32_product_equal=product_equal, rel_l2=errors)
        check(product_equal, f"int8 product {batch}x{rows}x{din}x{dout} differs")
        check(errors["output"] <= 2**-8, f"int8 output card vs CPU {errors}")
        check(max(errors.values()) <= 1e-2, f"int8 gradients card vs CPU {errors}")
    counts = _counts()
    emit("optimizers", case="done", seconds=time.perf_counter() - t_phase,
         launches=counts)
    check(counts == _expect({}), f"the optimizers launched {counts}")
    return counts


# ---------------------------------- the short backend (#3-#6) and the probes

# (name, batch, sq, sk, heads, dim, dtype, kv_lens): the JiT-B/16 train shape,
# then edge shapes; "range" draws kv_lens in [266, Sk] with row 1 at 0
SHORT_CASES = [
    ("train_s298", 64, 298, 298, 12, 64, torch.bfloat16, None),
    ("train_s298_kv_fp16", 16, 298, 298, 12, 64, torch.float16, "range"),
    ("d128_fp16", 4, 266, 266, 6, 128, torch.float16, "range"),
    ("train_s298_kv", 16, 298, 298, 12, 64, torch.bfloat16, "range"),
    ("s37", 2, 37, 37, 2, 64, torch.bfloat16, [37, 21]),
    ("sq266_sk77", 4, 266, 77, 6, 64, torch.bfloat16, [77, 40, 0, 1]),
    ("d128", 4, 266, 266, 6, 128, torch.bfloat16, "range"),
    ("fp32_s266", 4, 266, 266, 12, 64, torch.float32, [266, 100, 0, 7]),
    ("fp32_d128_sq266_sk77", 2, 266, 77, 4, 128, torch.float32, [77, 0]),
]
SHORT_SHAPE = (64, 298, 12, 64)  # JiT-B/16's training step: B, S, H, D
PROBE_SHAPE = (64, 304, 12, 64)  # the probes' (S padded to 304 on the TPU)
# (name, batch, seq, heads) of the probes' cases (D 64, bf16): their shape,
# then S that cut their 64-row tiles, JiT-B/16's unpadded S 298 last
PROBE_CASES = [("probe", *PROBE_SHAPE[:3]), ("s37", 2, 37, 2), ("s65", 3, 65, 4),
               ("s129", 4, 129, 12), ("s257", 8, 257, 12), ("s298", 64, 298, 12)]
ROOFLINE_STEPS = 5  # training steps per timing window of the roofline probe


def _short_entries(layout):
    """(forward, forward with lse, backward, plain forward, plain backward,
    batch-first view of a BSHD tensor in this layout) of the short backend's
    BSHD or BHSD entry."""
    from vision_pt_tpu_torch.ops import short_attention as sa

    if layout == "bshd":
        return (sa.short_attention, sa.short_attention_with_lse,
                sa.short_attention_bwd, sa.short_attention_reference,
                sa.short_attention_bwd_reference, lambda x: x)
    return (sa.short_attention_bhsd, sa.short_attention_bhsd_with_lse,
            sa.short_attention_bhsd_bwd, sa.short_attention_bhsd_reference,
            sa.short_attention_bhsd_bwd_reference,
            lambda x: x.transpose(1, 2).contiguous())


def phase_short_kernel() -> dict:
    """Kernels #3-#6 (the short backend's forward and backward, BSHD and
    BHSD) and #10, #11 (the probes) against their plain versions; returns
    the largest error of each at the train shape (#3-#6) and at the probe
    shape (#10, #11)."""
    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline

    gen = torch.Generator(device="cuda").manual_seed(6)
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, lens in SHORT_CASES:
        q, do = (_bshd(gen, batch, sq, heads, dim, dtype) for _ in range(2))
        k, v = (_bshd(gen, batch, sk, heads, dim, dtype) for _ in range(2))
        kv_lens = _kv_lens(gen, lens, batch, sk)
        tol = ATTN_TOL[dtype]
        row_lens = [sk] * batch if kv_lens is None else kv_lens.clamp(0, sk).tolist()
        zero_rows = [i for i, n in enumerate(row_lens) if n == 0]
        partial = [(i, n) for i, n in enumerate(row_lens) if 0 < n < sk]
        for layout in ("bshd", "bhsd"):
            fwd, fwd_lse, bwd, plain_fwd, plain_bwd, view = _short_entries(layout)
            args = [view(x) for x in (q, k, v)]
            dout = view(do)
            out, lse = fwd_lse(*args, kv_lens)
            grads = bwd(*args, lse, dout, kv_lens)
            torch.cuda.synchronize()
            ref, ref_lse = plain_fwd(*args, kv_lens, return_lse=True)
            ref_grads = plain_bwd(*args, lse, dout, kv_lens)
            for kernel, outs, compared in (
                    (fwd.__name__, [out], [_compare(out, ref, tol),
                                           _compare(lse, ref_lse, 0.0, LSE_ATOL)]),
                    (bwd.__name__, grads,
                     [_compare(o, r, tol) for o, r in zip(grads, ref_grads)])):
                err, share, within = _agree(compared)
                finite = all(bool(torch.isfinite(o).all()) for o in outs)
                zero_row = all(bool((o[i] == 0).all()) for o in outs
                               for i in zero_rows) if zero_rows else None
                past_kv_zero = None
                if kernel.endswith("bwd") and partial:
                    rows = [g[i, n:] if layout == "bshd" else g[i, :, n:]
                            for g in grads[1:] for i, n in partial]
                    past_kv_zero = all(bool((r == 0).all()) for r in rows)
                emit("short_kernel", kernel=kernel, case=name, layout=layout,
                     shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                     kv_lens=row_lens if lens else None, max_abs_err=err,
                     tolerance=tol, limit_share=share, finite=finite,
                     zero_row=zero_row, past_kv_zero=past_kv_zero)
                check(finite and within and zero_row is not False
                      and past_kv_zero is not False,
                      f"{kernel} disagrees with its plain version at {name}")
                if name == "train_s298":
                    errors[kernel] = err
            if name.startswith("train_s298_kv"):
                # the limits must fail the kernel's results for row 0 against
                # the plain version of that row with one key fewer
                n = row_lens[0]
                wrong = torch.tensor([n - 1], device="cuda")
                row = [x[:1] for x in (*args, lse, dout)]
                kernel_row = [out[:1], *(g[:1] for g in grads)]
                refs = [plain_fwd(*row[:3], wrong), *plain_bwd(*row, wrong)]
                shares = [_compare(o, r, tol)[1] for o, r in zip(kernel_row, refs)]
                emit("short_kernel", kernel=fwd.__name__, layout=layout,
                     case="limits_can_fail", dtype=str(dtype), kv_len=n,
                     one_key_fewer_shares=shares)
                check(shares[0] > 1 and max(shares[1:]) > 1,
                      f"the {layout} limits pass a kernel one key short: {shares}")
        del q, k, v, do, out, lse, grads, ref, ref_lse, ref_grads
        torch.cuda.empty_cache()

    # autograd through both entries runs exactly their backward kernels
    q, k, v, do = (_bshd(gen, 4, 266, 12, 64, torch.bfloat16) for _ in range(4))
    kv_lens = torch.tensor([266, 200, 0, 31], device="cuda")
    for layout in ("bshd", "bhsd"):
        fwd, fwd_lse, bwd, _, _, view = _short_entries(layout)
        leaves = [view(x).detach().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(fwd(*leaves, kv_lens), leaves, view(do))
        detached = [x.detach() for x in leaves]
        _, lse = fwd_lse(*detached, kv_lens)
        explicit = bwd(*detached, lse, view(do), kv_lens)
        equal = all(torch.equal(a, b) for a, b in zip(auto, explicit))
        emit("short_kernel", kernel=bwd.__name__, layout=layout, case="autograd",
             autograd_equals_explicit=equal)
        check(equal, f"autograd through {fwd.__name__} differs from its backward")

    # the probes at their shape and at edges of their 64-row tiles; the
    # limits must fail a plain version that leaves out one head's output, and
    # one that drops the last key
    tol = TOL[torch.bfloat16]
    for name, batch, seq, heads in PROBE_CASES:
        dim = 64
        x = torch.randn(batch, seq, heads * dim, generator=gen,
                        device="cuda").to(torch.bfloat16)
        for kernel, run, plain in (
                ("run_variant", pairing.run_variant, pairing.run_variant_reference),
                ("dots_variant", lambda x, h: [roofline.dots_variant(x, h)],
                 lambda x, h, **kw: [roofline.dots_variant_reference(x, h, **kw)])):
            outs = run(x, heads)
            torch.cuda.synchronize()
            refs = plain(x, heads)
            err, share, within = _agree([_compare(o, r, tol) for o, r in zip(outs, refs)])
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            head = min(5, heads - 1)
            dropped = [r.clone() for r in refs]
            for r in dropped:
                r[..., head * dim:(head + 1) * dim] = 0
            dropped_share = max(_compare(o, r, tol)[1] for o, r in zip(outs, dropped))
            short_share = max(_compare(o, r, tol)[1]
                              for o, r in zip(outs, plain(x, heads, kv_len=seq - 1)))
            emit("short_kernel", kernel=kernel, case=name, shape=[batch, seq, heads, dim],
                 dtype="torch.bfloat16", max_abs_err=err, tolerance=tol,
                 limit_share=share, finite=finite, head_dropped_share=dropped_share,
                 one_key_short_share=short_share)
            check(finite and within, f"{kernel} disagrees with its plain version at {name}")
            check(dropped_share > 1, f"the {kernel} limits pass a head left out at "
                  f"{name}: {dropped_share}")
            check(short_share > 1, f"the {kernel} limits pass a kernel one key short "
                  f"at {name}: {short_share}")
            if name == "probe":
                errors[kernel] = err
        del x, outs, refs, dropped
    return errors


def phase_short_timing() -> dict:
    """Kernels #3-#6 at the JiT-B/16 train shape, #10 and #11 at the probes'
    shape, and #2 again at B 64, S 298; keyed by wrapper name (#2 as
    ``packed_bwd``)."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops import short_attention as sa
    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline
    from vision_pt_tpu_torch.tools.bench.kernel_ab import probe_yardsticks

    batch, s, heads, dim = SHORT_SHAPE
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (_bshd(gen, batch, s, heads, dim, bf16) for _ in range(4))
    size = q.numel() * q.element_size()
    product = 2 * batch * heads * s * s * dim  # one (S, S, D) product
    shape = [batch, s, s, heads, dim]
    rows = {}
    for layout, number in (("bshd", 3), ("bhsd", 5)):
        fwd, fwd_lse, bwd, plain_fwd, plain_bwd, view = _short_entries(layout)
        args = [view(x) for x in (q, k, v)]
        dout = view(do)
        _, lse = fwd_lse(*args)
        # SDPA on the same memory, as (B, H, S, D) views
        bhsd = [x.transpose(1, 2) if layout == "bshd" else x for x in (*args, dout)]
        leaves = [x.detach().requires_grad_() for x in bhsd[:3]]
        rows[fwd.__name__] = _time_kernel(
            fwd.__name__, lambda: fwd(*args), lambda: plain_fwd(*args),
            lambda: F.scaled_dot_product_attention(*bhsd[:3]),
            4 * size, 2 * product, bf16,
            f"vision_pt_tpu/ops/short_attention.py:{543 if number == 3 else 307}",
            "vision_pt_tpu_torch/csrc/short_attention.cu", [layout, *shape],
            "F.scaled_dot_product_attention", phase="short_timing")
        rows[bwd.__name__] = _time_kernel(
            bwd.__name__, lambda: bwd(*args, lse, dout),
            lambda: plain_bwd(*args, lse, dout),
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves),
                                        leaves, bhsd[3]),
            7 * size, 5 * product, bf16,
            f"vision_pt_tpu/ops/short_attention.py:{561 if number == 3 else 325}",
            "vision_pt_tpu_torch/csrc/short_attention_bwd.cu", [layout, *shape],
            "F.scaled_dot_product_attention forward and its torch.autograd.grad "
            "backward", phase="short_timing")
        del leaves

    # kernel #2 again, for the comparison with the code before its head stride
    packed = [x.view(batch, s, heads * dim) for x in (q, k, v)]
    _, lse = sa.short_attention_packed_with_lse(*packed, heads, bounded=True)
    packed += [lse, do.view(batch, s, heads * dim)]
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    rows["packed_bwd"] = _time_kernel(
        "short_attention_packed_bwd",
        lambda: sa.short_attention_packed_bwd(*packed, heads, bounded=True),
        lambda: sa.short_attention_packed_bwd_reference(*packed, heads, bounded=True),
        lambda: torch.autograd.grad(sdpa_out, leaves, do.transpose(1, 2),
                                    retain_graph=True),
        7 * size, 5 * product, bf16, "vision_pt_tpu/ops/short_attention.py:493",
        "vision_pt_tpu_torch/csrc/short_attention_bwd.cu", ["train", *shape],
        "torch.autograd.grad of F.scaled_dot_product_attention", phase="short_timing")
    del q, k, v, do, packed, leaves, sdpa_out, lse

    batch, s, heads, dim = PROBE_SHAPE
    x = torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(bf16)
    size = x.numel() * x.element_size()
    product = 2 * batch * heads * s * s * dim
    sdpa_pair, seven_matmuls = probe_yardsticks(x, heads)
    rows["run_variant"] = _time_kernel(
        "run_variant", lambda: pairing.run_variant(x),
        lambda: pairing.run_variant_reference(x), sdpa_pair,
        3 * size, 6 * product, bf16,
        "tools/bench/attention_pairing_probe.py:143",
        "vision_pt_tpu_torch/csrc/attention_probe.cu", ["probe", batch, s, s, heads, dim],
        "F.scaled_dot_product_attention forward and backward, and the two adds",
        phase="short_timing", executed_flops=pairing.PRODUCTS_EXECUTED * product)
    rows["dots_variant"] = _time_kernel(
        "dots_variant", lambda: roofline.dots_variant(x),
        lambda: roofline.dots_variant_reference(x), seven_matmuls,
        2 * size, 6 * product, bf16,  # q k^T is one product, computed twice
        "tools/bench/attention_roofline.py:252",
        "vision_pt_tpu_torch/csrc/attention_probe.cu", ["probe", batch, s, s, heads, dim],
        "the seven products as seven bf16 torch.matmul calls (no one call "
        "computes the function)", phase="short_timing",
        executed_flops=roofline.PRODUCTS_EXECUTED * product)
    return rows


def phase_short_path() -> tuple[int, ...]:
    """The short backend as a user calls it, at JiT-B/16 width:
    ``dot_product_attention(..., backend="short")`` forward and backward,
    then ``short_attention_bhsd`` on the same tensors transposed; each call
    must launch exactly its entry's forward and backward once and no other
    kernel. Returns the launches of both calls."""
    from vision_pt_tpu_torch.ops.attention import dot_product_attention
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_bhsd,
        short_attention_bwd_reference,
        short_attention_reference,
    )

    batch, s, heads, dim = SHORT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (_bshd(gen, batch, s, heads, dim, torch.bfloat16) for _ in range(4))
    kv_lens = _kv_lens(gen, "range", batch, s)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    counts, seconds = [], []
    for label in ("dot_product_attention", "short_attention_bhsd"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        if label == "dot_product_attention":
            out = dot_product_attention(*leaves, kv_lens=kv_lens, backend="short")
            grads = torch.autograd.grad(out, leaves, do)
        else:
            out = short_attention_bhsd(*(x.transpose(1, 2) for x in leaves), kv_lens)
            grads = torch.autograd.grad(out, leaves, do.transpose(1, 2))
            out = out.transpose(1, 2)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(_counts())
        if label == "dot_product_attention":
            first = (out, grads)
    refused = {}
    for kwargs in ({"mask": torch.ones(batch, s, dtype=torch.bool, device="cuda")},
                   {"is_causal": True}):
        try:
            dot_product_attention(q, k, v, backend="short", **kwargs)
        except ValueError as e:
            refused[next(iter(kwargs))] = str(e)
    tol = TOL[torch.bfloat16]
    ref, ref_lse = short_attention_reference(*(x.detach() for x in leaves), kv_lens,
                                             return_lse=True)
    ref_grads = short_attention_bwd_reference(*(x.detach() for x in leaves), ref_lse,
                                              do, kv_lens)
    err, share, within = _agree([_compare(o, r, tol) for o, r in
                                 zip((first[0].detach(), *first[1]), (ref, *ref_grads))])
    same = torch.equal(out, first[0]) and all(
        torch.equal(a, b) for a, b in zip(grads, first[1]))
    expected = [_expect({3: 1, 4: 1}), _expect({5: 1, 6: 1})]
    emit("short_path", shape=[batch, s, heads, dim], dtype="torch.bfloat16",
         kv_lens=kv_lens.tolist(), calls=["dot_product_attention(backend='short')",
                                          "short_attention_bhsd"],
         launches=counts, expected=expected, seconds=seconds, refused=refused,
         max_abs_err=err, limit_share=share, bhsd_equals_bshd=same)
    check(counts == expected, f"short path launches {counts}, expected {expected}")
    check(set(refused) == {"mask", "is_causal"} and all(
        "kv_lens only" in m for m in refused.values()),
        f"the short backend must refuse a mask and is_causal: {refused}")
    check(within and same and all(bool(torch.isfinite(x).all())
                                  for x in (out, *grads)),
          f"short path output: limit share {share}, BHSD equals BSHD {same}")
    return tuple(a + b for a, b in zip(*counts))


def phase_attention_probes() -> tuple[int, ...]:
    """Both probe tools' ``main()`` on the card; #10 and #11 must launch as
    often as their timing and comparison call for, and the roofline's
    sections 1-2 run kernels #1 and #2 (12 blocks per real training step,
    none with attention as identity; one each per timed layer). Returns the
    launches of both."""
    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline
    from vision_pt_tpu_torch.tools.bench import launches_of_timing

    _reset_counts()
    t0 = time.perf_counter()
    pair = pairing.main()
    pair_s = time.perf_counter() - t0
    pair_counts = _counts()
    _reset_counts()
    t0 = time.perf_counter()
    roof = roofline.main(steps=ROOFLINE_STEPS)
    roof_s = time.perf_counter() - t0
    roof_counts = _counts()
    packed = 12 * (1 + 3 * ROOFLINE_STEPS) + launches_of_timing(roofline.N_LAYERS)
    expected = [_expect({10: pairing.MAIN_LAUNCHES}),
                _expect({1: packed, 2: packed, 11: roofline.MAIN_LAUNCHES})]
    emit("attention_probes", seconds=[pair_s, roof_s],
         launches=[pair_counts, roof_counts], expected=expected)
    check([pair_counts, roof_counts] == expected,
          f"probe launches {[pair_counts, roof_counts]}, expected {expected}")
    numbers = [pair["per_head_ms_per_layer"], pair["max_abs_diff"],
               *(val for val in roof.values() if isinstance(val, float))]
    check(all(np.isfinite(numbers)) and roof["step_ms"] > roof["step_noattn_ms"] > 0,
          f"probe results {pair} {roof}")
    return tuple(a + b for a, b in zip(pair_counts, roof_counts))


# ------------------------------------------------------------ JiT variants

# the variant trainers: JiT-B/16 width and depth (a U-JiT of depth 5 and
# 12 blocks), 256^2, batch 16, bf16 compute, fp32 parameters, 3 steps and a
# 2-step CFG preview each, through their entry points
VARIANT_BATCH, VARIANT_STEPS = 16, 3
VARIANTS = {  # name -> (entry point, denoiser fields over JiT-B/16)
    "ujit": ("class_to_image_ujit", {"depth": 5, "num_blocks": 12}),
    "arb_ujit": ("arb_class_to_image_ujit", {"depth": 5, "num_blocks": 12}),
    "cross": ("class_to_image_cross", {}),
    "ig": ("class_to_image_ig", {}),
    "loig": ("class_to_image_loig", {}),
    "tread": ("class_to_image_tread", {}),
}
# (#1, #2) launches per training step and #1 per CFG denoiser call of the
# preview: Cross's 11 self-attention blocks (S 266, no mask); IG's and
# LoIG's blocks 0-3 (before context_start_block 4); TREAD's blocks 0-1 and
# 8-11 at S 330 with suffix kv_lens (blocks 2-7 route to S 202, below
# MIN_PACKED_SEQ) and all 12 when sampling; every U-JiT block is masked
VARIANT_LAUNCHES = {"ujit": (0, 0, 0), "arb_ujit": (0, 0, 0),
                    "cross": (11, 11, 11), "ig": (4, 4, 4), "loig": (4, 4, 4),
                    "tread": (6, 6, 12)}
PREVIEW_STEPS = 2
# the class vocabulary of the synthetic tagged images (the preview prompts
# of configs/jit/x_loss/preview.yml among them)
TAGS = ["1girl", "solo", "blue_hair", "blonde_hair", "smile", "long_hair",
        "short_hair", "red_eyes", "hat", "outdoors"]
X_LOSS_STEPS, X_LOSS_BATCH = 4, 4  # the shipped batch


def _write_tagged_images(folder: str, count: int, label2id: str) -> None:
    """``count`` 256^2 ``.webp`` images with ``.tags.json`` metadata of 3
    tags each, and the label2id of the tags: the data the x-loss config
    names (``data/animeface``) is not in the repository."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    for i in range(count):
        base = np.stack([np.sin(5 * xx + i), np.cos(4 * yy - i), xx * yy], -1)
        pixels = 127.5 * (base + 1) + rng.normal(0, 12, size=base.shape)
        Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"img{i}.webp"))
        with open(os.path.join(folder, f"img{i}.tags.json"), "w") as f:
            json.dump({"tags": " ".join(rng.choice(TAGS, 3, replace=False))}, f)
    with open(label2id, "w") as f:
        json.dump({tag: i for i, tag in enumerate(TAGS)}, f)


def _x_loss_config(tmp: str, name: str, images: str, label2id: str) -> dict:
    """``configs/jit/x_loss/config.yml`` with its data, label2id and output
    paths in ``tmp``, one epoch, and a preview of its prompts in
    PREVIEW_STEPS steps at the epoch's end (its per_steps 100 lies past the
    run)."""
    import yaml

    with open(os.path.join(ROOT, "configs/jit/x_loss/config.yml")) as f:
        cfg = yaml.safe_load(f)
    with open(os.path.join(ROOT, cfg["preview"]["data"]["path"])) as f:
        preview = yaml.safe_load(f)
    work = os.path.join(tmp, name)
    os.makedirs(work, exist_ok=True)
    for job in preview:
        job["num_steps"] = PREVIEW_STEPS
    with open(os.path.join(work, "preview.yml"), "w") as f:
        yaml.safe_dump(preview, f)
    cfg["model"]["context_encoder"]["label2id_map_path"] = label2id
    cfg["dataset"]["folder"] = images
    cfg["num_train_epochs"] = 1
    cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
    cfg["preview"]["strategy"]["per_steps"] = None
    cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(work, "preview")
    cfg["preview"]["data"]["path"] = os.path.join(work, "preview.yml")
    return cfg


def _variant_config(tmp: str, name: str, tagged: tuple[str, str]) -> str:
    """The trainer config of variant ``name``: the synthetic class-image
    config (the ARB U-JiT: the x-loss config's data) at JiT-B/16 width."""
    import yaml

    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config

    denoiser = {**JiT_B_16_Config().model_dump(), **VARIANTS[name][1]}
    work = os.path.join(tmp, name)
    if name == "arb_ujit":
        cfg = _x_loss_config(tmp, name, *tagged)
        cfg["dataset"]["batch_size"] = VARIANT_BATCH
        cfg["trainer"]["gradient_checkpointing"] = False
    else:
        with open(os.path.join(ROOT, "configs/jit/synthetic_class_to_image.yml")) as f:
            cfg = yaml.safe_load(f)
        os.makedirs(work, exist_ok=True)
        cfg["model"]["context_encoder"]["label2id_map_path"] = os.path.join(
            tmp, "trainer_label2id.json")
        cfg["model"]["max_token_length"] = 64
        cfg["dataset"].update(num_items=VARIANT_BATCH * VARIANT_STEPS,
                              image_size=256, batch_size=VARIANT_BATCH)
        cfg["scheduler"]["args"]["num_warmup_steps"] = 1
        cfg["num_train_epochs"] = 1
        cfg["preview"]["strategy"] = {"per_epochs": 1}
        cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(work, "preview")
        cfg["preview"]["data"]["data"][0].update(width=256, height=256,
                                                 num_steps=PREVIEW_STEPS)
    cfg["model"].update(denoiser=denoiser, dtype="bfloat16")
    cfg.update(saving=None, tracker=None)
    path = os.path.join(work, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _run_counted(run, path: str, profile_step: str | None = None):
    """``run(path)`` on the card, each training step timed and its kernel
    launches counted; returns (trainer, per-step launches, step seconds,
    losses, launches of the whole run, run seconds, peak memory)."""
    from vision_pt_tpu_torch.training.trainer import Trainer

    per_step, step_seconds, losses = [], [], []
    inner = Trainer.train_step

    def counting(self, *args, **kwargs):
        before = _counts()
        t0 = time.perf_counter()
        if profile_step is not None and len(per_step) == VARIANT_STEPS - 1:
            out = profile(profile_step, lambda: inner(self, *args, **kwargs))
        else:
            out = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), before))
        losses.append(float(out[0]))
        return out

    Trainer.train_step = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
    torch.cuda.synchronize()
    return (trainer, per_step, step_seconds, losses, _counts(),
            time.perf_counter() - t0, torch.cuda.max_memory_allocated())


def phase_jit_variants_trainer(tmp: str) -> dict[str, tuple[int, ...]]:
    """U-JiT, ARB U-JiT, Cross, IG, LoIG and TREAD through their entry
    points (``device=None``: the card) at JiT-B/16 width; returns each
    run's kernel launches. TREAD's last step runs under the profiler."""
    import importlib

    tagged = (os.path.join(tmp, "tagged_images"), os.path.join(tmp, "tag_label2id.json"))
    _write_tagged_images(tagged[0], VARIANT_BATCH * VARIANT_STEPS, tagged[1])
    with open(os.path.join(tmp, "trainer_label2id.json"), "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    launches = {}
    for name, (module, _) in VARIANTS.items():
        run = importlib.import_module(f"vision_pt_tpu_torch.train.jit.{module}").run
        path = _variant_config(tmp, name, tagged)
        profiled = name == "tread"
        (trainer, per_step, step_seconds, losses, counts, seconds,
         peak) = _run_counted(run, path, "tread_trainer" if profiled else None)
        fwd, bwd, per_call = VARIANT_LAUNCHES[name]
        preview = _diff(counts, tuple(map(sum, zip(*per_step))))
        previews = len(os.listdir(os.path.join(tmp, name, "preview")))
        # after the first step; the profiled step's time holds the
        # profiler's own processing
        steady = step_seconds[1:-1] if profiled else step_seconds[1:]
        denoiser = trainer.model.model.denoiser
        emit("jit_variants_trainer", variant=name, entry_point=module,
             denoiser=type(denoiser).__module__.rsplit(".", 1)[-1],
             blocks=sum(1 for m in denoiser.modules()
                        if m.__class__.__name__.endswith("Block")),
             hidden=denoiser.config.hidden_size, resolution=256,
             batch=VARIANT_BATCH, compute="bfloat16", params="float32",
             steps=trainer.global_step, step_seconds=step_seconds,
             profiled_step=VARIANT_STEPS if profiled else None,
             seconds_per_step=sum(steady) / len(steady),
             images_per_second=VARIANT_BATCH * len(steady) / sum(steady),
             peak_memory_bytes=peak, losses=losses, run_seconds=seconds,
             fwd_launches_per_step=[c[0] for c in per_step],
             bwd_launches_per_step=[c[1] for c in per_step],
             preview_launches=preview, previews=previews, card=nvidia_smi())
        check(trainer.global_step == VARIANT_STEPS and all(np.isfinite(losses)),
              f"{name}: steps {trainer.global_step}, losses {losses}")
        check(per_step == [_expect({1: fwd, 2: bwd})] * VARIANT_STEPS,
              f"{name}: launches per step {per_step}, expected {fwd} + {bwd}")
        calls = PREVIEW_STEPS * previews
        check(previews >= 1 and preview == _expect({1: per_call * calls}),
              f"{name}: preview launches {preview}, expected {per_call} "
              f"in each of {calls} CFG denoiser calls")
        launches[f"{name}_trainer"] = counts
        del trainer, denoiser
        torch.cuda.empty_cache()
    return launches


def phase_x_loss_trainer(tmp: str) -> tuple[int, ...]:
    """``configs/jit/x_loss/config.yml`` as shipped (JiT-B width at depth 24
    with the class context from block 0, bf16, RAdamScheduleFree, gradient
    checkpointing, caption shuffle) through ``train.jit.arb_class_to_image``,
    its cuts listed in the phase line; every block is masked, so no kernel
    launches, as in the JAX package."""
    import yaml

    from vision_pt_tpu_torch.train.jit.arb_class_to_image import run

    images, label2id = os.path.join(tmp, "x_loss_images"), os.path.join(tmp, "x_loss_label2id.json")
    _write_tagged_images(images, X_LOSS_STEPS * X_LOSS_BATCH, label2id)
    cfg = _x_loss_config(tmp, "x_loss", images, label2id)
    path = os.path.join(tmp, "x_loss", "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    (trainer, per_step, step_seconds, losses, counts, seconds,
     peak) = _run_counted(run, path)
    denoiser = trainer.model.model.denoiser
    saved = os.listdir(os.path.join(tmp, "x_loss", "out"))
    previews = os.listdir(os.path.join(tmp, "x_loss", "preview"))
    steady = step_seconds[1:]
    emit("x_loss_trainer", config="configs/jit/x_loss/config.yml",
         depth=denoiser.config.depth,
         context_start_block=denoiser.config.context_start_block,
         hidden=denoiser.config.hidden_size, resolution=256, batch=X_LOSS_BATCH,
         gradient_checkpointing=denoiser.gradient_checkpointing,
         cuts=[f"{X_LOSS_STEPS * X_LOSS_BATCH} synthetic 256^2 .webp images "
               "with .tags.json metadata (data/animeface is not in the "
               "repository), a label2id of their tags",
               f"1 epoch ({X_LOSS_STEPS} steps) of the shipped 100",
               f"preview: the shipped prompts in {PREVIEW_STEPS} steps at "
               "the epoch's end (per_steps 100 lies past the run)",
               "output paths in a temporary directory"],
         steps=trainer.global_step, step_seconds=step_seconds,
         seconds_per_step=sum(steady) / len(steady),
         images_per_second=X_LOSS_BATCH * len(steady) / sum(steady),
         peak_memory_bytes=peak, losses=losses, run_seconds=seconds,
         launches_per_step=per_step, run_launches=counts, saved=saved,
         previews=len(previews), card=nvidia_smi())
    check(denoiser.config.depth == 24 and denoiser.config.context_start_block == 0
          and denoiser.gradient_checkpointing,
          "the x-loss config: depth 24, context from block 0, checkpointing")
    check(trainer.global_step == X_LOSS_STEPS and all(np.isfinite(losses)),
          f"x-loss trainer: steps {trainer.global_step}, losses {losses}")
    check(counts == _expect({}), f"x-loss run launched {counts}: its blocks are masked")
    check(len(saved) == 1 and len(previews) == 2, f"saved {saved}, previews {previews}")
    del trainer, denoiser
    torch.cuda.empty_cache()
    return counts


# the variant parity steps: JiT-B/16 width at 4 blocks (context from block
# 2; U-JiT depth 1 with 4 blocks), 256^2, batch 2, bf16, against the
# bf16 train_parity floors; launches of #1/#2 on the card
PARITY_VARIANTS = {  # name -> (workload, denoiser fields, #1/#2 launches)
    "ujit": ("JiTForUJiTTraining", {"depth": 1, "num_blocks": 4}, 0),
    "arb_ujit": ("JiTForArbUJiTTraining", {"depth": 1, "num_blocks": 4}, 0),
    "cross": ("JiTForCrossTraining", {}, 3),
    "ig": ("JiTForIGTraining", {"intermediate_output_idx": 2}, 2),
    "loig": ("JiTForLoIGTraining", {}, 2),
    "tread": ("JiTForTreadTraining", {"tread_start_block": 1, "tread_end_block": 3}, 2),
}
IG_SAMPLE_LAUNCHES = 2 * 2  # 2 steps, blocks 0-1 before the context


def _variant_workload(name: str, device: str, label2id: str):
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config
    from vision_pt_tpu_torch.workloads import jit_variants

    workload_name, fields, _ = PARITY_VARIANTS[name]
    denoiser = {**JiT_B_16_Config().model_dump(), "depth": 4,
                "context_start_block": 2, **fields}
    config = TrainConfig.model_validate({
        "model": {"context_encoder": {"type": "class", "label2id_map_path": label2id},
                  "denoiser": denoiser, "dtype": "bfloat16",
                  "drop_context_rate": 0.0},
        "dataset": {}, "seed": 0,
    })
    workload = getattr(jit_variants, workload_name)(config, torch.device(device))
    workload.setup_model()
    return workload


def _variant_step(name: str, device: str, label2id: str):
    """One bf16 step of variant ``name`` on ``device``, the packed gate open
    on the CPU too (so it runs the kernels' plain versions); the same
    weights (the seeded init), batch and draws on either device."""
    import vision_pt_tpu_torch.models.jit.denoiser as gate
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.tools.bench.step_parity import Step

    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, size=(2, 256, 256, 3)).astype(np.float32),
             "caption": ["c1", "c2 c3"]}
    if name == "arb_ujit":
        batch.update(original_size=np.array([[384, 256], [256, 320]], np.int32),
                     target_size=np.full((2, 2), 256, np.int32),
                     crop_coords_top_left=np.array([[64, 0], [0, 32]], np.int32))
    draws = {"timesteps": torch.sigmoid(torch.from_numpy(
                 rng.normal(size=(2,)).astype(np.float32)) * 0.8 - 0.8),
             "noise": torch.from_numpy(rng.normal(size=(2, 256, 256, 3)).astype(np.float32)),
             "route_perm": torch.from_numpy(rng.permutation(256))}
    workload = _variant_workload(name, device, label2id)
    trainable = workload.trainable()
    batch = workload.prepare_batch(batch)
    draws = {k: v.to(device) for k, v in draws.items()}
    opened = gate._on_cuda
    gate._on_cuda = lambda x: True
    t0 = time.perf_counter()
    try:
        with attention_dtype(torch.bfloat16):
            loss, _ = workload.compute_loss(trainable, batch, draws)
            loss.backward()
    finally:
        gate._on_cuda = opened
    seconds = time.perf_counter() - t0
    grads = {n: p.grad.detach().float().cpu() for n, p in trainable.named_parameters()}
    return Step(float(loss.detach()), grads, seconds), workload


def _ig_sample(model):
    """A 2-step IG-guided CFG sample of ``model`` from fixed noise, the
    packed gate open; (output, launches)."""
    import vision_pt_tpu_torch.models.jit.denoiser as gate
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    init = np.random.default_rng(4).normal(size=(1, 256, 256, 3)).astype(np.float32)
    opened = gate._on_cuda
    gate._on_cuda = lambda x: True
    _reset_counts()
    try:
        with attention_dtype(torch.bfloat16):
            out = model.generate(prompt=["c1"], width=256, height=256,
                                 num_inference_steps=2, cfg_scale=2.0,
                                 ig_scale=2.0, execution_dtype=torch.bfloat16,
                                 initial_noise=init, return_arrays=True)
    finally:
        gate._on_cuda = opened
    return out.float().cpu().numpy(), _counts()


def _variant_steps(device: str, label2id: str):
    """Each variant's step on ``device`` (the CPU in the worker), then the
    IG model's sample: ({name: (loss, grads, seconds, launches)}, sample)."""
    steps, sample = {}, None
    for name in PARITY_VARIANTS:
        _reset_counts()
        step, workload = _variant_step(name, device, label2id)
        steps[name] = (step.loss, {n: g.numpy() for n, g in step.grads.items()},
                       step.seconds, _counts())
        if name == "ig":
            sample = _ig_sample(workload.model)
        del workload
        if device == "cuda":
            torch.cuda.empty_cache()
    return steps, sample


@_tf32_off()
def phase_jit_variants_parity(label2id: str) -> dict[str, tuple[int, ...]]:
    """Each variant's training step on the card (kernels) and on the CPU
    (plain versions, in the worker), then a 2-step IG-guided CFG sample;
    returns the card runs' launches."""
    from vision_pt_tpu_torch.tools.bench.step_parity import grad_errors, summary

    future = _HALVES.take("jit_variants", "jit_variants_parity", _variant_steps, "cpu",
                          label2id)
    card_steps, card_sample = _variant_steps("cuda", label2id)
    launches = {}
    for name, (_, _, n) in PARITY_VARIANTS.items():
        grads, counts_c = card_steps[name][1], card_steps[name][3]
        check(all(np.isfinite(g).all() for g in grads.values()), f"{name}: non-finite grads")
        check(counts_c == _expect({1: n, 2: n}),
              f"{name}: the card step must launch {n} + {n} ({counts_c})")
        launches[f"{name}_parity"] = counts_c
    check(np.isfinite(card_sample[0]).all(), "non-finite IG sample")
    check(card_sample[1] == _expect({1: IG_SAMPLE_LAUNCHES}),
          f"IG sample launches {card_sample[1]}, expected {IG_SAMPLE_LAUNCHES} on the card")
    launches["ig_sample"] = card_sample[1]

    def finish(result, where):
        host_steps, host_sample = result
        floor = TRAIN_PARITY_FLOOR["bfloat16"]
        for name in PARITY_VARIANTS:
            card, host = card_steps[name], host_steps[name]
            loss_err = abs(card[0] - host[0]) / abs(host[0])
            errors = summary(grad_errors(
                {n: torch.from_numpy(g) for n, g in card[1].items()},
                {n: torch.from_numpy(g) for n, g in host[1].items()}))
            emit("jit_variants_parity", variant=name, dtype="bfloat16", batch=2,
                 blocks=4, **where, loss_cuda=card[0], loss_cpu=host[0],
                 loss_rel_err=loss_err, grad_rel_l2_max=errors["max"],
                 grad_rel_l2_median=errors["median"], worst_params=errors["worst"],
                 floor=floor, launches_cuda=card[3], launches_cpu=host[3],
                 seconds_cuda=card[2], seconds_cpu=host[2])
            check(host[3] == _expect({}), f"{name}: the CPU step launched {host[3]}")
            check(loss_err <= floor["loss"] and errors["max"] <= floor["grad"],
                  f"{name} parity: loss {loss_err:.2e}, grad {errors['worst'][0]}")
        value = psnr(card_sample[0], host_sample[0])
        emit("jit_variants_parity", variant="ig_sample", dtype="bfloat16", batch=1,
             cfg=2.0, ig_scale=2.0, steps=2, **where, psnr_db=value,
             floor_db=PSNR_FLOOR_DB["bfloat16"], launches_cuda=card_sample[1],
             launches_cpu=host_sample[1])
        check(host_sample[1] == _expect({}), f"IG sample launched {host_sample[1]} on the CPU")
        check(value >= PSNR_FLOOR_DB["bfloat16"],
              f"IG sample card-vs-CPU PSNR {value:.2f} dB < {PSNR_FLOOR_DB['bfloat16']}")

    _HALVES.then(future, finish)
    torch.cuda.empty_cache()
    return launches


def phase_tread_timing() -> dict:
    """Kernels #1 (with its lse, as training runs it) and #2 at TREAD's
    unrouted blocks: B 16, S 330, suffix kv_lens (266 image, size and time
    tokens, then 1-4 valid of 64 class tokens), beside SDPA with the
    equivalent boolean key mask. The bound counts the key and value rows
    these kv_lens make valid, and the products over them."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed_bwd,
        short_attention_packed_bwd_reference,
        short_attention_packed_reference,
        short_attention_packed_with_lse,
    )

    heads, dim, dtype, batch, s = 12, 64, torch.bfloat16, VARIANT_BATCH, 330
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _attention_inputs(gen, batch, s, s, heads, dim, dtype)
    lens = torch.from_numpy(266 + np.random.default_rng(5).integers(1, 5, size=batch))
    lens = lens.to("cuda", torch.int32)
    key_mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qh, kh, vh = (x.view(batch, s, heads, dim).transpose(1, 2) for x in (q, k, v))
    row = heads * dim * q.element_size()  # bytes of one token's heads
    valid = int(lens.sum())
    lse_bytes = 4 * batch * heads * s
    product = 2 * heads * s * valid * dim  # one product over the valid keys
    shape = ["tread", batch, s, s, heads, dim, "kv_lens", lens.tolist()]
    rows = {"tread": _time_kernel(
        "short_attention_packed_with_lse",
        lambda: short_attention_packed_with_lse(q, k, v, heads, lens, bounded=True),
        lambda: short_attention_packed_reference(q, k, v, heads, lens, bounded=True,
                                                 return_lse=True),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_mask),
        2 * batch * s * row + 2 * valid * row + lse_bytes, 2 * product, dtype,
        "vision_pt_tpu/ops/short_attention.py:462",
        "vision_pt_tpu_torch/csrc/short_attention.cu", shape,
        "F.scaled_dot_product_attention with a boolean key mask",
        phase="tread_timing")}
    do = torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
    out, lse = short_attention_packed_with_lse(q, k, v, heads, lens, bounded=True)
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=key_mask)
    doh = do.view(batch, s, heads, dim).transpose(1, 2)
    # q and do read, dq, dk and dv written in full; the valid k and v rows
    rows["tread_bwd"] = _time_kernel(
        "short_attention_packed_bwd",
        lambda: short_attention_packed_bwd(q, k, v, lse, do, heads, lens, bounded=True),
        lambda: short_attention_packed_bwd_reference(q, k, v, lse, do, heads, lens,
                                                     bounded=True),
        lambda: torch.autograd.grad(sdpa_out, leaves, doh, retain_graph=True),
        5 * batch * s * row + 2 * valid * row + lse_bytes, 5 * product, dtype,
        "vision_pt_tpu/ops/short_attention.py:493",
        "vision_pt_tpu_torch/csrc/short_attention_bwd.cu", shape,
        "torch.autograd.grad of F.scaled_dot_product_attention with a boolean "
        "key mask", phase="tread_timing")
    del q, k, v, do, out, lse, leaves, sdpa_out
    torch.cuda.empty_cache()
    return rows


# ---------------------------------- CogView4 sampling

# 5 steps a timed request: the time limit holds mesh_trainer and ring too
COGVIEW4_SIDE, COGVIEW4_STEPS, COGVIEW4_CFG = 1024, 5, 5.0
COGVIEW4_LAYERS, COGVIEW4_OFFLOAD_GROUPS = 28, 4
# per denoiser call at 1024^2 with CFG, every one of the 28 joint
# self-attentions (B 2, 4096 image + 16 text tokens, 32 x 128) takes #7;
# under NF4 the feed-forward that the two streams share runs the text
# stream's 2 x 16 rows on its own, so its ff.proj and ff.out take #9 (the
# joint projections and the image stream's feed-forward, 2 x 4112 and
# 2 x 4096 rows, are over KERNEL_MAX_ROWS); int8 has no kernel
_COGVIEW4_ATTENTION = COGVIEW4_LAYERS * COGVIEW4_STEPS
COGVIEW4_LAUNCHES = {"bf16": _expect({7: _COGVIEW4_ATTENTION}),
                     "bnb_nf4": _expect({7: _COGVIEW4_ATTENTION,
                                         9: 2 * _COGVIEW4_ATTENTION}),
                     "bnb_int8": _expect({7: _COGVIEW4_ATTENTION})}
# the quantized linears of the DiT (to_q, to_k, to_v, to_out, ff.proj,
# ff.out of each block); the GLM tower is never reached, as in the JAX package
COGVIEW4_QUANTIZED = {"bf16": 0, "bnb_nf4": 6 * COGVIEW4_LAYERS,
                      "bnb_int8": 6 * COGVIEW4_LAYERS}
# cogview4_parity: full widths, 2 DiT and 2 GLM layers, 512^2 (1024 image +
# 16 text tokens: still #7); one denoiser call (2 launches) and a 2-step CFG
# generate (4)
COGVIEW4_PARITY_SIDE, COGVIEW4_PARITY_DEPTH = 512, 2
COGVIEW4_PARITY_LAUNCHES = _expect({7: 3 * COGVIEW4_PARITY_DEPTH})
# cogview4_parity floors on the relative L2 error, card vs CPU, in bf16.
# One denoiser call measured 4.0e-3 (an H100 against its host), and 3.6e-2
# with #7's head 0 zeroed in both layers: its floor lies between, below the
# SDXL UNet's 5e-2, which one zeroed head of 32 at depth 2 does not reach.
# The 2-step CFG latents measured 1.95e-2 (CFG 5 scales the difference of
# the two predictions, and its error) and 3.7e-2 with the zeroed head, too
# close to separate: they keep the SDXL sampler's 7.5e-2, which #7 writing
# nothing (0.118) fails. The text embeddings pass 2 bf16 GLM layers of plain
# PyTorch on both sides (2.7e-3).
COGVIEW4_PARITY_FLOOR = {"denoiser": 2e-2, "latents": SDXL_PARITY_FLOOR["latents"],
                         "text": 2e-2}


def _cogview4_model(config, **kw):
    from vision_pt_tpu_torch.models.cogview4 import CogView4Model, GLMWordHashTokenizer

    return CogView4Model.from_config(config, device="cuda", param_dtype=torch.bfloat16,
                                     tokenizer=GLMWordHashTokenizer(), **kw)


def _cogview4_offload(model, request) -> dict:
    """A 2-step request with the DiT's blocks offloaded in 4 groups (all
    parked on the host first) against the same request without: the latents
    must be the same bits and the peak lower."""
    from vision_pt_tpu_torch.ops.offload import LayerwiseOffloadStrategy

    blocks = list(model.denoiser.transformer_blocks)

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents = request(2, return_latents=True)
        torch.cuda.synchronize()
        return latents, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    plain, plain_s, plain_peak = run()
    strategy = LayerwiseOffloadStrategy.from_num_groups(COGVIEW4_LAYERS,
                                                        COGVIEW4_OFFLOAD_GROUPS)
    model.denoiser.set_offload_strategy(strategy)
    try:
        strategy.offload_all(blocks)
        offloaded, offload_s, offload_peak = run()
    finally:
        strategy.load_all(blocks)
        model.denoiser.set_offload_strategy(None)
    torch.cuda.synchronize()
    result = dict(groups=[list(g) for g in strategy.layer_groups],
                  bit_identical=torch.equal(plain, offloaded),
                  seconds=plain_s, offload_seconds=offload_s,
                  peak_memory_bytes=plain_peak, offload_peak_memory_bytes=offload_peak)
    check(result["bit_identical"], "offloaded CogView4 latents differ from the plain run")
    check(offload_peak < plain_peak,
          f"offload peak {offload_peak} is not below the plain peak {plain_peak}")
    return result


def phase_cogview4_sampler() -> dict:
    """CogView4-6B at full width (the 28-layer DiT, the 40-layer GLM-4-9B
    tower, the 16-channel VAE), random weights from seed 0 drawn on the card,
    bf16 parameters and compute, the GLM word-hash tokenizer, through the
    quant-compare tool's ``compare`` at 1024^2, CFG 5, COGVIEW4_STEPS steps, over its
    default settings (bf16, NF4, int8): per setting a fresh model, a 2-step
    warm request, the timed request and a profiled 2-step one; the
    bf16 model also runs the offload check. Returns the timed requests'
    launches."""
    from vision_pt_tpu_torch.models.cogview4 import CogView4Config
    from vision_pt_tpu_torch.tools import cogview4_quant_compare as tool

    config = CogView4Config(checkpoint_path="", dtype="bfloat16")
    launches, details = {}, {}

    def after(quant, model, images, request):
        counts = _counts()
        stats = images.float()
        details[quant] = dict(
            launches=counts, image_shape=list(images.shape),
            image_mean=float(stats.mean()), image_std=float(stats.std()),
            params={prefix: sum(p.numel() for p in module.parameters())
                    for prefix, module in model.modules().items()},
            param_bytes={prefix: sum(p.numel() * p.element_size()
                                     for p in module.parameters())
                         for prefix, module in model.modules().items()})
        launches[f"cogview4_{quant}"] = counts
        check(tuple(images.shape) == (1, COGVIEW4_SIDE, COGVIEW4_SIDE, 3),
              f"CogView4 image shape {tuple(images.shape)}")
        check(bool(torch.isfinite(stats).all()) and float(stats.std()) > 1e-3,
              "the CogView4 image is not finite, or constant")
        check(counts == COGVIEW4_LAUNCHES[quant],
              f"CogView4 {quant} launches {counts}, expected "
              f"{COGVIEW4_LAUNCHES[quant]}")
        profile(f"cogview4_{quant}_2_steps", lambda: request(2, return_latents=True))
        if quant == "bf16":
            details[quant]["offload"] = _cogview4_offload(model, request)

    results = tool.compare(
        lambda: _cogview4_model(config, seed=0), height=COGVIEW4_SIDE,
        width=COGVIEW4_SIDE, num_inference_steps=COGVIEW4_STEPS,
        cfg_scale=COGVIEW4_CFG, warmup_steps=2,
        before_timed=lambda quant: _reset_counts(), after_timed=after)
    for quant, result in results.items():
        emit("cogview4_sampler", model="CogView4-6B + GLM-4-9B (random weights, seed 0)",
             denoiser=quant, param_dtype="bfloat16", compute_dtype="bfloat16",
             resolution=COGVIEW4_SIDE, batch=1, cfg=COGVIEW4_CFG, steps=COGVIEW4_STEPS,
             tokenizer="GLM word-hash", seconds_per_image=result["seconds"],
             **{k: v for k, v in result.items() if k != "seconds"},
             expected=COGVIEW4_LAUNCHES[quant], **details[quant])
        check(result["quantized_linears"] == {"text_encoder": 0,
                                              "denoiser": COGVIEW4_QUANTIZED[quant]},
              f"CogView4 {quant} quantized linears {result['quantized_linears']}")
    torch.cuda.empty_cache()
    return launches


def _cogview4_parity_run(model, inputs: dict):
    """(text embeddings, denoiser output, latents), launches and seconds of
    cogview4_parity on ``model``'s device, the flash gate open (the CPU runs
    the same path, through the plain versions)."""
    import vision_pt_tpu_torch.ops.attention as attention
    from vision_pt_tpu_torch.tools.cogview4_quant_compare import DEFAULT_PROMPT as prompt

    bf16, side, device = torch.bfloat16, COGVIEW4_PARITY_SIDE, model.device
    args = [torch.from_numpy(a).to(device, bf16 if i in (0, 1) else torch.float32)
            for i, a in enumerate(inputs["dit_args"])]
    _reset_counts()
    gate = attention._on_cuda
    attention._on_cuda = lambda x: True
    t0 = time.perf_counter()
    try:
        enc = model.text_encoder.encode_prompts(prompt, "", use_negative_prompts=True)
        with torch.inference_mode():
            out = model.denoiser(*args)
        lat = model.generate(prompt, width=side, height=side, num_inference_steps=2,
                             cfg_scale=COGVIEW4_CFG, execution_dtype=bf16,
                             latents=inputs["latents"], return_latents=True)
    finally:
        attention._on_cuda = gate
    text = torch.cat([enc.positive_embeddings, enc.negative_embeddings])
    return ([x.float().cpu().numpy() for x in (text, out, lat)], _counts(),
            time.perf_counter() - t0)


@_tf32_off()
def phase_cogview4_parity() -> None:
    """The same weights and inputs on the card (kernels) and on the CPU (the
    plain versions of the same path, in the worker): full widths, 2 DiT and
    2 GLM layers, 512^2, bf16; the text embeddings, one denoiser call (batch
    2) and a 2-step CFG generate from injected latents. Then the card's
    denoiser call and generate with #7's output wrong in every launch: one
    head zeroed, and every head zeroed."""
    import vision_pt_tpu_torch.ops.attention as attention
    from vision_pt_tpu_torch.models.cogview4 import CogView4Config, DenoiserConfig

    side = COGVIEW4_PARITY_SIDE
    config = CogView4Config(
        checkpoint_path="", dtype="bfloat16",
        denoiser=DenoiserConfig(num_layers=COGVIEW4_PARITY_DEPTH),
        text_encoder_config={"num_hidden_layers": COGVIEW4_PARITY_DEPTH})
    card = _cogview4_model(config, seed=1)
    rng = np.random.default_rng(6)
    latent, channels = side // 8, card.config.denoiser.in_channels
    dit_args = [rng.normal(size=(2, latent, latent, channels)).astype(np.float32),
                rng.normal(size=(2, 16, card.config.denoiser.text_embed_dim)).astype(
                    np.float32),
                np.asarray([999.0, 500.0], np.float32),
                np.full((2, 2), float(side), np.float32),
                np.full((2, 2), float(side), np.float32), np.zeros((2, 2), np.float32)]
    latents = rng.normal(size=(1, latent, latent, channels)).astype(np.float32)
    inputs = {"dit_args": dit_args, "latents": latents}
    future = _HALVES.submit("cogview4_parity", _cpu_model_run, _cogview4_parity_run,
                            inputs, ship=_HALVES.ship(card))
    (text_c, dit_c, lat_c), counts_c, sec_c = _cogview4_parity_run(card, inputs)
    check(all(np.isfinite(x).all() for x in (text_c, dit_c, lat_c)),
          "non-finite CogView4 parity output")
    check(counts_c == COGVIEW4_PARITY_LAUNCHES,
          f"CogView4 parity launches: card {counts_c}, expected {COGVIEW4_PARITY_LAUNCHES}")

    # #7 wrong in every launch: its output with head 0 zeroed, or with every
    # head zeroed (a kernel that writes nothing)
    kernel, wrong_runs = attention.flash_attention, {}
    for label, heads in (("one_head_zeroed", 1), ("every_head_zeroed", None)):
        def wrong(*a, heads=heads, **kw):
            out = kernel(*a, **kw).clone()
            out[:, :, :heads] = 0
            return out

        attention.flash_attention = wrong
        try:
            wrong_runs[label] = _cogview4_parity_run(card, inputs)[0][1:]
        finally:
            attention.flash_attention = kernel

    def finish(result, where):
        (text_h, dit_h, lat_h), counts_h, sec_h = result
        errors = {"text": _rel_l2(text_c, text_h), "denoiser": _rel_l2(dit_c, dit_h),
                  "latents": _rel_l2(lat_c, lat_h)}
        emit("cogview4_parity", resolution=side, depth={"dit": COGVIEW4_PARITY_DEPTH,
                                                        "glm": COGVIEW4_PARITY_DEPTH},
             widths="full (DiT 32 x 128, GLM 4096)", dtype="bfloat16", **where,
             rel_l2=errors, floor=COGVIEW4_PARITY_FLOOR,
             psnr_db={"denoiser": psnr(dit_c, dit_h), "latents": psnr(lat_c, lat_h)},
             launches_cuda=counts_c, launches_cpu=counts_h,
             expected_cuda=COGVIEW4_PARITY_LAUNCHES, seconds_cuda=sec_c, seconds_cpu=sec_h)
        check(counts_h == _expect({}), f"CogView4 parity launches on the CPU: {counts_h}")
        check(all(errors[k] <= COGVIEW4_PARITY_FLOOR[k] for k in errors),
              f"CogView4 parity {errors} over {COGVIEW4_PARITY_FLOOR}")
        wrong_errors = {label: {"denoiser": _rel_l2(dit_w, dit_h),
                                "latents": _rel_l2(lat_w, lat_h)}
                        for label, (dit_w, lat_w) in wrong_runs.items()}
        floors = {k: COGVIEW4_PARITY_FLOOR[k] for k in ("denoiser", "latents")}
        emit("cogview4_parity", case="limits_can_fail", rel_l2=wrong_errors, floor=floors,
             card_vs_cpu=errors)
        e = wrong_errors["every_head_zeroed"]
        check(all(e[k] > floors[k] for k in e),
              f"a CogView4 parity floor passes #7 writing nothing: {e}")
        e = wrong_errors["one_head_zeroed"]["denoiser"]
        check(e > floors["denoiser"],
              f"the CogView4 denoiser floor passes #7 with one head zeroed: {e}")

    _HALVES.then(future, finish)
    del card
    torch.cuda.empty_cache()


# ---------------------------------- IP-Adapter and PFG

# the vision towers' shapes: openai/clip-vit-large-patch14's (IPAdapterConfig's
# default image encoder: 257 tokens at 224^2, pooled width 1024) and a WD
# tagger's ViT-B/16 at 448^2 (SmilingWolf/wd-vit-tagger-v3's shape, PFGConfig's
# default side: 785 tokens); both random from a seed, written in their HF and
# timm layouts and read back through AutoImageEncoder's loaders
CLIP_L14 = dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                num_attention_heads=16, image_size=224, patch_size=14,
                hidden_act="quick_gelu", projection_dim=768)
VIT_B16_448 = dict(embed_dim=768, depth=12, num_heads=12, patch_size=16, img_size=448)
# sdxl_adapter_parity's small towers: the same token counts, 2 layers, 128 wide
SMALL_TOWERS = {"clip": {**CLIP_L14, "hidden_size": 128, "intermediate_size": 512,
                         "num_hidden_layers": 2, "num_attention_heads": 2},
                "timm": {**VIT_B16_448, "embed_dim": 128, "depth": 2, "num_heads": 2}}
# each adapter family: the entry point the full-width phase drives, the
# entry points driven once at reduced depth, the workload of the parity
# step, the tower and whether it reads the referenced dataset. A training
# step at 1024^2 takes #7 140 times as the LoRA step does (70
# self-attentions, forward and recompute) but #8 69: the first
# self-attention comes before every adapter and image token, so autograd
# runs no backward through it. The image tokens (4 keys), PFG's longer
# context (2 x 241 rows), CLIP (S 257) and the ViT (S 785) all stay on plain
# attention, as the JAX gate sends them; a CFG request takes #7 70 times
# a step
ADAPTER_FAMILIES = {
    "ip_adapter": dict(entry="ip_adapter_ref", others=("ip_adapter_self", "ip_adapter_kyara"),
                       workload="sdxl_ip_adapter.SDXLIPAdapterSelfTraining", tower="clip",
                       referenced=True),
    "prompt_free": dict(entry="prompt_free_self", others=("prompt_free_ref",),
                        workload="sdxl_prompt_free.SDXLPFGSelfTraining", tower="timm",
                        referenced=False),
}
ADAPTER_STEP_LAUNCHES = _expect({7: 140, 8: 69})
# the adapter requests' steps: 2, not SDXL_STEPS (5), for the adapter mesh
# phases' seconds on the card's path
ADAPTER_REQUEST_STEPS = 2
ADAPTER_REQUEST_LAUNCHES = _expect({7: 70 * ADAPTER_REQUEST_STEPS})
# sdxl_adapter_parity: sdxl_lora_parity's model and floors; a step takes
# #7 3 times and #8 2 (stage 2's self-attentions at S 1024, the first one
# without a backward), a PARITY_SAMPLE_STEPS-step CFG sample #7 3 times a step
ADAPTER_PARITY_LAUNCHES = {"step": _expect({7: 3, 8: 2}),
                           "generate": _expect({7: 3 * PARITY_SAMPLE_STEPS})}
# the adapter gradients sit far from the self-attentions, so #7 / #8 dropping
# their last key tile moves them by less than the two devices' bf16
# roundings (0.031-0.033 against card-vs-CPU 0.031-0.036, batch 2, NVIDIA
# H100 80GB HBM3 700 W): the LoRA floors cannot see it. The same step on the
# card through the plain versions can: kernels against plain 0.0044-0.0059
# there. Each adapter gradient holds within this of the card's plain run
ADAPTER_KERNEL_FLOOR = 1.5e-2


def _adapter_model(family: str, weights_path: str, tower: dict) -> dict:
    """The adapter's model section: IPAdapterConfig() / PFGConfig() as the
    JAX package defaults them, over the given tower."""
    encoder = {"weights_path": weights_path}
    if family == "prompt_free":
        encoder.update(type="timm", feature_dim=tower["embed_dim"],
                       num_heads=tower["num_heads"])
    else:
        encoder.update(feature_dim=tower["hidden_size"])
    return {"adapter": {"image_encoder": encoder}}


def _write_tower(path: str, kind: str, shape: dict, seed: int) -> str:
    """A random tower in its file layout (fp16): an HF CLIP vision directory
    (config.json + model.safetensors) or a timm ViT safetensors file."""
    from safetensors.torch import save_file

    from vision_pt_tpu_torch.models import clip_vision, timm_vit

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        if kind == "clip":
            model = clip_vision.CLIPVisionModel(clip_vision.CLIPVisionConfig(**shape),
                                                generator=gen)
        else:
            model = timm_vit.TimmViT(timm_vit.TimmViTConfig(**shape), generator=gen)
    sd = {k: v.detach().half().cpu().contiguous() for k, v in model.state_dict().items()}
    del model
    if kind == "timm":
        save_file({k.replace("patch_embed_proj.", "patch_embed.proj."): v
                   for k, v in sd.items()}, path)
        return path
    os.makedirs(path, exist_ok=True)
    save_file({k.replace(".layers.", ".encoder.layers.", 1): v for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "clip_vision_model", **shape}, f)
    return path


def _reference_image(i: int, size=(768, 512)):
    """A synthetic reference (not square, so the letterbox pads it)."""
    from PIL import Image

    yy, xx = np.mgrid[0:size[1], 0:size[0]] / max(size)
    pixels = 127.5 * (np.stack([np.cos(4 * xx - i), np.sin(5 * yy + i), 1 - xx * yy], -1) + 1)
    return Image.fromarray(pixels.astype(np.uint8))


def _write_referenced_images(folder: str, images: str) -> None:
    """The synthetic training images with metadata JSONs naming a reference
    image and tag groups (ReferencedTextToImageDatasetConfig's layout)."""
    import shutil

    os.makedirs(folder, exist_ok=True)
    for i in range(SDXL_TRAIN_IMAGES):
        shutil.copy(os.path.join(images, f"img{i}.png"), os.path.join(folder, f"img{i}.png"))
        ref = os.path.join(folder, f"ref{i}.jpg")
        _reference_image(i).save(ref)
        with open(os.path.join(folder, f"img{i}.json"), "w") as f:
            json.dump({"reference_image": ref, "people": ["1girl"],
                       "character": [f"character {i}"], "general": ["solo", "smile"],
                       "meta": ["absurdres"]}, f)


def _adapter_train_config(tmp: str, name: str, model: dict, folder: str,
                          reduced: bool, deterministic: bool = False) -> tuple[str, list]:
    """configs/sdxl/text_to_image_lora.yml's trainer settings (bucket settings,
    optimizer, saving, recompute) with the adapter's model, no LoRA and no
    preview; full: SDXL_TRAIN_STEPS steps; reduced: sdxl_parity's depth at 512^2, 1 step;
    ``deterministic``: trainer.deterministic. Returns the path and the cuts."""
    import yaml

    with open(os.path.join(ROOT, SDXL_TRAIN_CONFIGS["lora"]["path"])) as f:
        cfg = yaml.safe_load(f)
    work = os.path.join(tmp, name)
    os.makedirs(work, exist_ok=True)
    cfg["model"] = {"checkpoint_path": None, "dtype": cfg["model"]["dtype"],
                    "tokenizer": "word-hash", **model}
    cfg["peft"] = None
    cfg["dataset"]["folder"] = folder
    cfg["num_train_epochs"] = 1
    cfg["preview"] = None
    cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
    cuts = ["random weights from the seed, random vision tower from a seed",
            "word-hash tokenizer (the repository has no CLIP vocabulary)",
            "peft: null (only the adapter and projector train)",
            "preview: null", "output paths in a temporary directory"]
    if deterministic:
        cfg.setdefault("trainer", {})["deterministic"] = True
        cuts.append("trainer.deterministic: true, as in sdxl_adapter_mesh_trainer, which "
                    "compares its losses and adapter file with this run's bit for bit")
    if reduced:
        cfg["model"]["denoiser"] = {"layers_per_block": 1,
                                    "num_transformers_per_block": [1, 1, 1]}
        cfg["dataset"].update(bucket_base_size=PARITY_SIDE, num_repeats=1)
        cuts += ["layers_per_block 1, one transformer per stage, 512^2 buckets",
                 f"{SDXL_TRAIN_IMAGES} synthetic images, num_repeats 1: 1 step"]
    else:
        cfg["dataset"]["num_repeats"] = SDXL_TRAIN_STEPS
        cuts += [f"{SDXL_TRAIN_IMAGES} synthetic 1024^2 images, num_repeats "
                 f"{SDXL_TRAIN_STEPS}, batch 2: 1 epoch of {SDXL_TRAIN_STEPS} steps"]
    path = os.path.join(work, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cuts


def _fingerprints(named) -> dict[str, tuple[float, float]]:
    """(sum, sum of squares) in fp64 of each parameter: what changed."""
    named = list(named)
    with torch.no_grad():
        stats = torch.stack([torch.stack([p.double().sum(), p.double().square().sum()])
                             for _, p in named]).cpu().numpy()
    return {n: tuple(s) for (n, _), s in zip(named, stats)}


def _adapter_run(entry: str, path: str, frozen=None,
                 profile_first: str | None = None) -> dict:
    """``train.sdxl.<entry>.run(path)`` on the card, each step timed and
    counted, the parameters (the frozen tower's too, or ``frozen(workload)``'s
    named parameters) fingerprinted before the first step and after the
    run; with ``profile_first`` the first step, which is not timed, runs
    under the profiler as that path."""
    import importlib

    from vision_pt_tpu_torch.training.trainer import Trainer

    run = importlib.import_module(f"vision_pt_tpu_torch.train.sdxl.{entry}").run
    per_step, step_seconds, peaks, before = [], [], [], {}
    inner_step, inner_prepare = Trainer.train_step, Trainer.prepare_optimizer

    def tower(workload):
        encoder = getattr(workload.model, "encoder", None) or workload.model.vision_encoder
        if encoder.model is None:
            encoder._load_model()
        return encoder.model

    def named(workload):
        others = (frozen(workload) if frozen is not None else
                  (("tower." + n, p) for n, p in tower(workload).named_parameters()))
        return [*workload.trainable().named_parameters(), *others]

    def preparing(self):
        inner_prepare(self)
        before.update(_fingerprints(named(self.model)))

    def counting(self, *args, **kwargs):
        if not per_step:
            torch.cuda.reset_peak_memory_stats()
        counts = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile_first is not None and not per_step:
            out = profile(profile_first, lambda: inner_step(self, *args, **kwargs))
        else:
            out = inner_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), counts))
        peaks.append(torch.cuda.max_memory_allocated())
        return out

    Trainer.train_step, Trainer.prepare_optimizer = counting, preparing
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step, Trainer.prepare_optimizer = inner_step, inner_prepare
    seconds = time.perf_counter() - t0
    after = _fingerprints(named(trainer.model))
    trained = {n for n, p in trainer.model.trainable().named_parameters() if p.requires_grad}
    return dict(trainer=trainer, per_step=per_step, step_seconds=step_seconds,
                peak=max(peaks) if peaks else None, seconds=seconds, run_launches=_counts(),
                changed={n for n in after if after[n] != before[n]}, trained=trained)


def _adapter_params(family: str, names) -> set[str]:
    """The names the family trains: every to_k_ip / to_v_ip and the image
    projector (IP-Adapter), the projector (PFG)."""
    if family == "ip_adapter":
        return {n for n in names if n.endswith(("attn2.to_k_ip", "attn2.to_v_ip"))
                or n.startswith("image_proj.")}
    return {n for n in names if n.startswith("projector.")}


def phase_adapter_trainer(tmp: str, family: str,
                          towers: dict) -> tuple[dict[str, tuple[int, ...]], dict]:
    """``train.sdxl.ip_adapter_ref`` / ``prompt_free_self`` at SDXL-base's full
    width and depth, 1024^2, batch 2, SDXL_TRAIN_STEPS steps, over the full-size tower; the
    adapter file saved, loaded back and compared; exactly the adapter's and
    projector's parameters changed; for the IP-Adapter one more step,
    profiled; then one timed ADAPTER_REQUEST_STEPS-step CFG-5 request with a
    reference image.
    Returns the run's and the request's launches, and the config, losses,
    launches, step times, peak memory and saved files that
    ``sdxl_adapter_mesh_trainer`` holds its run against."""
    from safetensors.torch import load_file

    spec = ADAPTER_FAMILIES[family]
    phase = f"{family}_trainer"
    images = os.path.join(tmp, "images")
    if not os.path.isdir(images):
        _write_sdxl_images(images)
    folder = images
    if spec["referenced"]:
        folder = os.path.join(tmp, "referenced")
        _write_referenced_images(folder, images)
    weights, shape = towers[family]
    path, cuts = _adapter_train_config(tmp, family, _adapter_model(family, weights, shape),
                                       folder, reduced=False,
                                       deterministic=family in ADAPTER_MESH_FAMILIES)
    out = _adapter_run(spec["entry"], path)
    trainer = out["trainer"]
    work = os.path.join(tmp, family)
    with open(os.path.join(work, "logs", os.listdir(os.path.join(work, "logs"))[0])) as f:
        losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    saved = os.listdir(os.path.join(work, "out"))
    model = trainer.model.model
    written = load_file(os.path.join(work, "out", saved[0])) if len(saved) == 1 else {}
    if family == "ip_adapter":
        model.load_adapter_state_dict(written)
        loaded = model.adapter_state_dict()
    else:
        model.manager.load_adapter_state(written)
        loaded = model.adapter_state_dict()
    round_trip = loaded.keys() == written.keys() and all(
        torch.equal(loaded[k], written[k]) for k in written)
    expected = _adapter_params(family, [n for n, _ in
                                        trainer.model.trainable().named_parameters()])
    if family == "ip_adapter":
        # where an adapter step's time goes: one step more, outside the timed
        # ones, profiled as the QLoRA step is
        batch = trainer.model.prepare_batch(next(iter(trainer.train_dataset)))
        profile(f"{phase}_step", lambda: trainer.train_step(batch, trainer._next_generator()))

    # the request: ADAPTER_REQUEST_STEPS steps, CFG 5, 1024^2, a reference image
    reference = {"ip_adapter": "reference_images", "prompt_free": "reference_image"}[family]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    image = model.generate(SDXL_PROMPT[0], negative_prompt=SDXL_PROMPT[1], width=SDXL_SIDE,
                           height=SDXL_SIDE, num_inference_steps=ADAPTER_REQUEST_STEPS,
                           cfg_scale=SDXL_CFG, seed=1, max_token_length=SDXL_TOKENS,
                           **{reference: _reference_image(7)})
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    request = _counts()
    pixels = np.asarray(image[0], dtype=np.float32)
    timed = out["step_seconds"][1:]
    emit(phase, entry=f"train.sdxl.{spec['entry']}", config=SDXL_TRAIN_CONFIGS["lora"]["path"],
         cuts=cuts, tower=spec["tower"], tower_shape=shape, resolution=SDXL_SIDE, batch=2,
         optimizer=trainer.config.optimizer.name,
         gradient_checkpointing=trainer.config.trainer.gradient_checkpointing,
         steps=trainer.global_step, run_seconds=out["seconds"],
         step_seconds=out["step_seconds"],
         seconds_per_step_after_first=sum(timed) / max(len(timed), 1),
         peak_memory_bytes=out["peak"], losses=losses, launches_per_step=out["per_step"],
         expected_per_step=ADAPTER_STEP_LAUNCHES, run_launches=out["run_launches"],
         trained_params=len(out["trained"]), changed_params=len(out["changed"]),
         adapter_file_keys=len(written), adapter_file_round_trip=round_trip,
         request_seconds_per_image=request_s,
         request_peak_memory_bytes=torch.cuda.max_memory_allocated(),
         request_launches=request, request_expected=ADAPTER_REQUEST_LAUNCHES,
         image_mean=float(pixels.mean()), image_std=float(pixels.std()))
    check(trainer.global_step == SDXL_TRAIN_STEPS and len(losses) == SDXL_TRAIN_STEPS
          and all(np.isfinite(losses)), f"{phase} losses {losses}")
    check(out["per_step"] == [ADAPTER_STEP_LAUNCHES] * SDXL_TRAIN_STEPS,
          f"{phase} launches per step {out['per_step']}, expected {ADAPTER_STEP_LAUNCHES}")
    n_keys = 70 * 2 + 4 if family == "ip_adapter" else 2
    check(len(written) == n_keys and round_trip,
          f"{phase}: adapter file of {len(written)} tensors (expected {n_keys}), "
          f"loaded back equal: {round_trip}")
    check(out["trained"] == expected and out["changed"] == expected and len(expected) == n_keys,
          f"{phase}: trained {len(out['trained'])}, changed {len(out['changed'])} parameters "
          f"(first others: {sorted(out['changed'] ^ expected)[:3]}), expected {n_keys}")
    check(request == ADAPTER_REQUEST_LAUNCHES,
          f"{phase} request launches {request}, expected {ADAPTER_REQUEST_LAUNCHES}")
    check(pixels.shape == (SDXL_SIDE, SDXL_SIDE, 3) and pixels.std() > 1.0,
          f"{phase}: the image is {pixels.shape}, std {pixels.std():.3g}")
    launches = {phase: out["run_launches"], f"{family}_request": request}
    no_mesh = {"config": path, "out": os.path.join(work, "out"), "losses": losses,
               "per_step": out["per_step"], "step_seconds": out["step_seconds"],
               "peak_memory_bytes": out["peak"]}
    del trainer, model, out
    torch.cuda.empty_cache()
    return launches, no_mesh


# a reduced-depth step (sdxl_parity's depth, 512^2, per-layer recompute as
# the config ships it): stage 2's 3 self-attentions at S 1024 take #7 in the
# forward and the recompute, #8 in the backward of the last 2
ADAPTER_REDUCED_STEP_LAUNCHES = _expect({7: 6, 8: 2})


def phase_adapter_entry_points(tmp: str, towers: dict) -> dict[str, tuple[int, ...]]:
    """The other entry points (``ip_adapter_self``, ``ip_adapter_kyara``,
    ``prompt_free_ref``) one step each on the card at sdxl_parity's depth,
    512^2, over the full-size towers: launches, what changed, the file."""
    from safetensors.torch import load_file

    launches = {}
    for family, spec in ADAPTER_FAMILIES.items():
        weights, shape = towers[family]
        for entry in spec["others"]:
            folder = os.path.join(tmp, "referenced" if entry.endswith(("_ref", "_kyara"))
                                  else "images")
            path, cuts = _adapter_train_config(tmp, entry, _adapter_model(family, weights, shape),
                                               folder, reduced=True)
            out = _adapter_run(entry, path)
            workload = out["trainer"].model
            saved = os.listdir(os.path.join(tmp, entry, "out"))
            written = load_file(os.path.join(tmp, entry, "out", saved[0])) if saved else {}
            expected = _adapter_params(family, [n for n, _ in
                                                workload.trainable().named_parameters()])
            emit("adapter_entry_points", entry=f"train.sdxl.{entry}", cuts=cuts,
                 step_seconds=out["step_seconds"], run_seconds=out["seconds"],
                 peak_memory_bytes=out["peak"], launches_per_step=out["per_step"],
                 expected_per_step=ADAPTER_REDUCED_STEP_LAUNCHES,
                 drop_image_rate=workload.model_config.drop_image_rate,
                 trained_params=len(out["trained"]), changed_params=len(out["changed"]),
                 adapter_file_keys=len(written))
            check(out["per_step"] == [ADAPTER_REDUCED_STEP_LAUNCHES],
                  f"{entry} launches {out['per_step']}, expected {ADAPTER_REDUCED_STEP_LAUNCHES}")
            check(out["trained"] == out["changed"] == expected and set(written) and
                  {k.split(".", 1)[0] for k in written} <= {"ip_adapter", "image_proj",
                                                          "projector"},
                  f"{entry}: trained {len(out['trained'])}, changed {len(out['changed'])}, "
                  f"expected {len(expected)}; file of {len(written)} tensors")
            check(entry != "ip_adapter_kyara" or workload.model_config.drop_image_rate == 0.0,
                  "ip_adapter_kyara drops images")
            launches[entry] = out["run_launches"]
            del out, workload
            torch.cuda.empty_cache()
    return launches


@_tf32_off()
def phase_sdxl_adapter_parity(tmp: str, towers: dict) -> dict[str, tuple[int, ...]]:
    """Card against CPU for each family at sdxl_lora_parity's model (512^2,
    full widths, one layer and one transformer per stage) over the small
    towers, batch 1 (the CPU's bf16 step is the phase's cost): one Self
    training step from an image (injected VAE noise, timestep and noise; no
    image dropped) under SDXL_LORA_PARITY_FLOOR with the card's plain
    versions as the witness, and within ADAPTER_KERNEL_FLOOR of the card's
    plain run, both failing the dropped-tile #7 / #8; its fp32 witness; a
    PARITY_SAMPLE_STEPS-step CFG-5 ``generate`` with a reference image from injected latents
    and step noise within max(SDXL_PARITY_FLOOR["latents"], 1.5 x the card's
    plain versions' error). Returns the card runs' launches."""
    import importlib

    from vision_pt_tpu_torch.config import TrainConfig

    phase = "sdxl_adapter_parity"
    side = PARITY_SIDE
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:side, 0:side] / side
    image = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy - 0.5], -1)
    batch = {"image": np.clip(image + rng.normal(0, 0.05, size=image.shape), -1, 1)
             .astype(np.float32)[None],
             "caption": ["1girl, solo, red hair, looking at viewer"],
             "original_size": np.full((1, 2), side, np.int32),
             "target_size": np.full((1, 2), side, np.int32),
             "crop_coords_top_left": np.zeros((1, 2), np.int32)}
    latent = (1, side // 8, side // 8, 4)
    draws = {"vae_noise": torch.from_numpy(rng.normal(size=latent).astype(np.float32)),
             "timesteps": torch.tensor([400], dtype=torch.int32),
             "noise": torch.from_numpy(rng.normal(size=latent).astype(np.float32))}
    init = rng.normal(size=latent).astype(np.float32)
    step_noise = [rng.normal(size=latent).astype(np.float32)
                  for _ in range(PARITY_SAMPLE_STEPS)]
    launches = {}
    for family, spec in ADAPTER_FAMILIES.items():
        module, name = spec["workload"].split(".")
        workload_cls = getattr(importlib.import_module(
            f"vision_pt_tpu_torch.workloads.{module}"), name)
        weights, shape = towers[family]
        model = {**_adapter_model(family, weights, shape), "drop_image_rate": 0.0}
        raw = _parity_config("bfloat16", None, **model)
        config = TrainConfig.model_validate(raw)
        card = workload_cls(config, torch.device("cuda"))
        card.setup_model()
        n_grads = 7 * 2 + 4 if family == "ip_adapter" else 2
        launches[f"{family}_parity_step"] = _parity_case(
            phase, family, workload_cls, config, card, batch, draws,
            ADAPTER_PARITY_LAUNCHES["step"], n_grads, kernel_floor=ADAPTER_KERNEL_FLOOR,
            tower=spec["tower"], tower_shape=shape,
            inputs="an image (the Self workload: its own reference), 75 tokens, "
                   "injected VAE noise, timestep and noise, no image dropped")
        witness = raw
        if family == "ip_adapter":  # the adapters in fp32 too
            witness = {**raw, "model": {**raw["model"], "adapter": {
                **raw["model"]["adapter"], "dtype": "float32"}}}
        _fp32_witness(phase, workload_cls, witness, card, batch, draws)

        reference = {"ip_adapter": "reference_images",
                     "prompt_free": "reference_image"}[family]
        request = dict(prompt=batch["caption"], negative_prompt=[SDXL_PROMPT[1]],
                       width=side, height=side, num_inference_steps=PARITY_SAMPLE_STEPS,
                       cfg_scale=SDXL_CFG,
                       latents=init, step_noise=step_noise,
                       **{reference: _reference_image(3)})
        future = _HALVES.submit(f"{phase} {family}_generate", _cpu_twin_generate,
                                workload_cls, config, request, ship=_HALVES.ship(card))
        outputs = {"cuda": _generate_latents(card.model, request),
                   "cuda_plain": _generate_latents(card.model, request, kernels=False)}
        counts = outputs["cuda"][2], outputs["cuda_plain"][2]
        check(np.isfinite(outputs["cuda"][0]).all(), f"non-finite {family} latents")
        check(counts == (ADAPTER_PARITY_LAUNCHES["generate"], _expect({})),
              f"{family} generate launches {counts[0]}, plain {counts[1]}")
        launches[f"{family}_parity_generate"] = outputs["cuda"][2]

        def finish(host_out, where, family=family, outputs=outputs):
            err = _rel_l2(outputs["cuda"][0], host_out[0])
            plain_err = _rel_l2(outputs["cuda_plain"][0], host_out[0])
            floor = max(SDXL_PARITY_FLOOR["latents"],
                        SDXL_LORA_PARITY_FLOOR["witness"] * plain_err)
            emit(phase, case=f"{family}_generate", resolution=side, steps=PARITY_SAMPLE_STEPS,
                 cfg=SDXL_CFG, **where, latents_rel_l2=err, witness_rel_l2=plain_err,
                 card_vs_plain=_rel_l2(outputs["cuda"][0], outputs["cuda_plain"][0]),
                 floor=floor, launches_cuda=outputs["cuda"][2],
                 launches_cuda_plain=outputs["cuda_plain"][2], launches_cpu=host_out[2],
                 seconds_cuda=outputs["cuda"][1], seconds_cpu=host_out[1])
            check(host_out[2] == _expect({}), f"{family} generate launches "
                  f"{host_out[2]} on the CPU")
            check(err <= floor,
                  f"{family} generate card-vs-CPU latents {err:.3g} over {floor:.3g}")

        _HALVES.then(future, finish)
        del card
        torch.cuda.empty_cache()
    return launches


def phase_adapters(tmp: str) -> tuple[dict[str, tuple[int, ...]], dict]:
    """The IP-Adapter and PFG phases over towers written once: the parity
    phase, the two full-width trainers, the other entry points. Returns the
    launches, and the IP-Adapter trainer's record and the small timm tower
    for the mesh phases."""
    t0 = time.perf_counter()
    full = {"ip_adapter": ("clip", CLIP_L14), "prompt_free": ("timm", VIT_B16_448)}
    towers, small = {}, {}
    for family, (kind, shape) in full.items():
        suffix = "" if kind == "clip" else ".safetensors"
        towers[family] = (_write_tower(os.path.join(tmp, f"{kind}{suffix}"), kind, shape,
                                       seed=3), shape)
        small[family] = (_write_tower(os.path.join(tmp, f"{kind}_small{suffix}"), kind,
                                      SMALL_TOWERS[kind], seed=4), SMALL_TOWERS[kind])
    emit("vision_towers", seconds=time.perf_counter() - t0,
         bytes={f: sum(os.path.getsize(os.path.join(d, n)) for d, _, files in os.walk(p)
                       for n in files) if os.path.isdir(p) else os.path.getsize(p)
                for f, (p, _) in towers.items()},
         shapes={f: s for f, (_, s) in towers.items()}, small=SMALL_TOWERS)
    # the parity phase first: its CPU halves run in the worker beside the
    # trainers
    launches = phase_sdxl_adapter_parity(tmp, small)
    records = {"timm_small": small["prompt_free"]}
    for family in ADAPTER_FAMILIES:
        family_launches, records[family] = phase_adapter_trainer(tmp, family, towers)
        launches.update(family_launches)
    launches.update(phase_adapter_entry_points(tmp, towers))
    return launches, records


# ---------------------------------- RoPE distillation, DRaFT+, style tokenizer

# PickScore_v1's shapes (CLIP-H/14: PickScoreModel.from_local's defaults),
# random from a seed and written as an HF CLIP directory in fp16; the parity
# phase's small one (tools.bench.draft_plus_gap.SMALL_PICKSCORE) keeps the
# token counts at 2 layers and 128 wide
PICKSCORE_H14 = {"projection_dim": 1024,
                 "text_config": dict(vocab_size=49408, hidden_size=1024, intermediate_size=4096,
                                     num_hidden_layers=24, num_attention_heads=16,
                                     max_position_embeddings=77, hidden_act="gelu"),
                 "vision_config": dict(hidden_size=1280, intermediate_size=5120,
                                       num_hidden_layers=32, num_attention_heads=16,
                                       image_size=224, patch_size=14, hidden_act="gelu")}
SLICE_STEPS = 2  # 2 images, num_repeats 2, batch 2
# DRaFT+'s sampler in its trainer phase: 2 steps, not the workload's 25
# (10 to leave room for mesh_trainer and ring, 2 for the adapter mesh
# phases): the differentiated last step is the same
DRAFT_SAMPLER_STEPS = 2
STYLE_PREFIX = "<|style|>, "
# the three entry points at 1024^2, batch 2, recompute (70 self-attentions at
# S >= 1024 a UNet call):
# - RoPE distillation: #7 70 (teacher) + 140 (student, forward and
#   recompute) + 20 (low-res student at 512^2: stage 2's 10 self-attentions
#   reach S 1024) + 10 (low-res teacher); #8 70 + 10; its 2-step CFG preview
#   #7 140;
# - DRaFT+: DRAFT_SAMPLER_STEPS - 1 sampler steps without autograd (70
#   each), the last one's forward and recompute, its reference call without
#   the adapters: #7 280, #8 70 (the UNet at B 4: 2 captions under CFG);
# - the style tokenizer: #7 140, #8 70: the pooled embedding of encoder 2
#   carries the style rows into the time embedding, so the gradient reaches
#   the first self-attention too (an IP-Adapter step's #8 is 69); its 2-step
#   CFG preview with a reference image #7 140
SLICE_TRAINERS = {
    "rope_distill": dict(entry="rope_distill", launches=_expect({7: 240, 8: 80}),
                         preview=_expect({7: 2 * 70}), peft=True,
                         metrics=("l2_loss", "distill_loss", "lowres_distill_loss")),
    "draft_plus": dict(entry="draft_plus",
                       launches=_expect({7: DRAFT_SAMPLER_STEPS * 70 + 2 * 70, 8: 70}),
                       preview=None, peft=True,
                       metrics=("reward", "reward_loss", "draft_reg_loss")),
    "style_tokenizer": dict(entry="style_tokenizer", launches=_expect({7: 140, 8: 70}),
                            preview=_expect({7: 2 * 70}), peft=False, metrics=("l2_loss",)),
}
# sdxl_slice14_parity at sdxl_parity's depth, 512^2, batch 1 (stage 2's 3
# self-attentions at S 1024 a UNet call): RoPE teacher 3 + student 3 (the
# 256^2 low-res pass stays plain), #8 3; DRaFT+ one sampler step, the
# differentiated one (the trainer phase runs the steps without autograd):
# 3 + 3 (reference), #8 3; style 3 + 3
SLICE_PARITY_LAUNCHES = {"rope_distill": _expect({7: 6, 8: 3}),
                         "draft_plus": _expect({7: 6, 8: 3}),
                         "style_tokenizer": _expect({7: 3, 8: 3})}
# each gradient's largest gap to the card's own plain-version step (bf16,
# measured on one NVIDIA H100 80GB HBM3 at 700 W): RoPE LoRA 0.0177 (the
# dropped key tile 0.25), the style projectors 0.0140 (0.026); ADAPTER_KERNEL_FLOOR's 1.5e-2
# cannot hold the LoRA gradients, which sum over cancelling tokens. DRaFT+'s
# sampled gradient moves 0.109 with the right kernels (2 steps, CFG 5, the
# VAE decoder: the fp32 step's card-vs-CPU gap is 8.3e-4, the RoPE step's
# 1.5e-5), so it takes no kernel floor: the dropped tile fails its LoRA floors
SLICE_KERNEL_FLOOR = {"rope_distill": 5e-2, "draft_plus": None, "style_tokenizer": 2e-2}
# DRaFT+'s fp32 witness reads 8.2e-4 where the others read 5e-6 to 2.4e-5:
# the reward clamps the decoded image to [-1, 1], and 3 of its 717k pixels
# inside the clamp fall on the other side of it on the CPU (a 1e-5 gap in
# the image), the gradient of each dropping to 0 there. That moves the
# image's gradient by about sqrt(3 / 717k) = 2e-3 and the worst LoRA
# gradient by 8.2e-4; the CPU's fp32 and fp64 steps differ as much, by 3 pixels
# (tools.bench.draft_plus_gap, one NVIDIA H100 80GB HBM3 at 700 W and its
# host). 5e-3 holds about 100 such pixels; a kernel fault moves it by 0.1+
SLICE_WITNESS_FLOOR = {"draft_plus": 5e-3}
SLICE_WORKLOADS = {"rope_distill": "sdxl_rope_distill.SDXLRoPEDistillTraining",
                   "draft_plus": "sdxl_draft_plus.SDXLDRaFTPlusTraining",
                   "style_tokenizer": "sdxl_style_tokenizer.SDXLStyleTokenizerTraining"}


def _slice_config(tmp: str, name: str, model: dict, folder: str, peft: bool,
                  preview: list | None, **dataset) -> tuple[str, list]:
    """configs/sdxl/text_to_image_lora.yml's trainer settings with ``model``,
    its LoRA (or none), SLICE_STEPS steps and ``preview`` (or none). Returns the path
    and the cuts."""
    import yaml

    with open(os.path.join(ROOT, SDXL_TRAIN_CONFIGS["lora"]["path"])) as f:
        cfg = yaml.safe_load(f)
    work = os.path.join(tmp, name)
    os.makedirs(work, exist_ok=True)
    cfg["model"] = {"checkpoint_path": None, "dtype": cfg["model"]["dtype"],
                    "tokenizer": "word-hash", **model}
    if not peft:
        cfg["peft"] = None
    cfg["dataset"].update(folder=folder, num_repeats=SLICE_STEPS, **dataset)
    cfg["num_train_epochs"] = 1
    cfg["tracker"]["log_dir"] = os.path.join(work, "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(work, "out")
    cuts = ["random weights from the seed", "word-hash tokenizer (the repository has no "
            "CLIP vocabulary)", f"{SDXL_TRAIN_IMAGES} synthetic 1024^2 images, num_repeats "
            f"{SLICE_STEPS}, batch 2: 1 epoch of {SLICE_STEPS} steps",
            "output paths in a temporary directory"]
    if preview is None:
        cfg["preview"] = None
        cuts.append("preview: null")
    else:
        with open(os.path.join(work, "preview.yml"), "w") as f:
            yaml.safe_dump(preview, f)
        cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(work, "preview")
        cfg["preview"]["data"]["path"] = os.path.join(work, "preview.yml")
        cuts.append("preview: the first prompt of configs/sdxl/preview.yml, 2 steps")
    path = os.path.join(work, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cuts


def _preview_jobs(style: bool, reference: str | None = None) -> list:
    import yaml

    with open(os.path.join(ROOT, "configs/sdxl/preview.yml")) as f:
        job = yaml.safe_load(f)[0]
    job["num_steps"] = 2
    if style:
        job["prompt"] = STYLE_PREFIX + job["prompt"]
        job["extra"] = {"reference_image_path": reference}
    return [job]


def phase_slice_trainer(tmp: str, name: str, model: dict, folder: str, frozen,
                        expected_trained, reference: str | None = None,
                        **dataset) -> tuple[int, ...]:
    """``train.sdxl.<name>`` at SDXL-base's full width and depth, 1024^2, batch
    2, SLICE_STEPS steps (the first not timed): launches per step, what changed (the
    trained tensors only: ``frozen(workload)`` and the whole training tree
    fingerprinted), the logged metrics finite; DRaFT+'s first step profiled.
    Returns the run's launches."""
    from safetensors.torch import load_file

    spec = SLICE_TRAINERS[name]
    phase = f"{name}_trainer"
    preview = (None if spec["preview"] is None
               else _preview_jobs(name == "style_tokenizer", reference))
    path, cuts = _slice_config(tmp, name, model, folder, spec["peft"], preview, **dataset)
    # where a DRaFT+ step's time goes: its first step (not timed), profiled
    out = _adapter_run(spec["entry"], path, frozen,
                       f"{phase}_step" if name == "draft_plus" else None)
    trainer = out["trainer"]
    work = os.path.join(tmp, name)
    with open(os.path.join(work, "logs", os.listdir(os.path.join(work, "logs"))[0])) as f:
        records = [json.loads(line) for line in f]
    logged = {m: [r[f"train/{m}"] for r in records if f"train/{m}" in r]
              for m in ("loss", *spec["metrics"])}
    previews = _diff(out["run_launches"], tuple(map(sum, zip(*out["per_step"]))))
    files = os.listdir(os.path.join(work, "out"))
    saved = load_file(os.path.join(work, "out", files[0])) if len(files) == 1 else {}
    expected = expected_trained({n for n, _ in trainer.model.trainable().named_parameters()})
    timed = out["step_seconds"][1:]
    emit(phase, entry=f"train.sdxl.{spec['entry']}", config=SDXL_TRAIN_CONFIGS["lora"]["path"],
         cuts=cuts, resolution=SDXL_SIDE, batch=2,
         optimizer=trainer.config.optimizer.name,
         gradient_checkpointing=trainer.config.trainer.gradient_checkpointing,
         steps=trainer.global_step, run_seconds=out["seconds"],
         step_seconds=out["step_seconds"],
         seconds_per_step_after_first=sum(timed) / max(len(timed), 1),
         peak_memory_bytes=out["peak"], metrics=logged, launches_per_step=out["per_step"],
         expected_per_step=spec["launches"], preview_launches=previews,
         expected_preview=spec["preview"] or _expect({}), run_launches=out["run_launches"],
         trained_params=len(out["trained"]), changed_params=len(out["changed"]),
         saved_file_keys=len(saved))
    check(trainer.global_step == SLICE_STEPS and all(
        len(v) == SLICE_STEPS and np.isfinite(v).all() for v in logged.values()),
          f"{phase}: metrics {logged}")
    check(out["per_step"] == [spec["launches"]] * SLICE_STEPS,
          f"{phase} launches per step {out['per_step']}, expected {spec['launches']}")
    check(previews == (spec["preview"] or _expect({})),
          f"{phase} preview launches {previews}, expected {spec['preview']}")
    check(out["trained"] == expected and out["changed"] == expected and expected,
          f"{phase}: trained {len(out['trained'])}, changed {len(out['changed'])}, expected "
          f"{len(expected)} (first others: {sorted(out['changed'] ^ expected)[:3]})")
    # LoRA: the 700 adapted linears' down, up and alpha; style: the projectors
    check(len(saved) == (3 * 700 if spec["peft"] else 4),
          f"{phase}: a saved file of {len(saved)} tensors")
    if name == "rope_distill":
        check(all(v > 0 for v in logged["distill_loss"] + logged["lowres_distill_loss"]),
              "rope_distill: the student's prediction equals the teacher's")
    launches = out["run_launches"]
    del trainer, out
    torch.cuda.empty_cache()
    return launches


@_tf32_off()
def phase_slice14_parity(towers: dict) -> dict[str, tuple[int, ...]]:
    """Card against CPU for the three workloads at sdxl_parity's model
    (512^2, full widths, one layer and one transformer per stage), batch 1,
    random weights from the seed, injected draws: the LoRA (RoPE, DRaFT+) or
    projector (style) step under SDXL_LORA_PARITY_FLOOR with the card's
    plain versions as the witness and within SLICE_KERNEL_FLOOR of the
    card's plain run (RoPE, style), the dropped-tile #7 / #8 failing them; then its fp32
    witness. DRaFT+ samples 1 step over the small PickScore; the style
    tokenizer reads the small timm tower. Returns the card steps' launches."""
    import importlib

    import yaml

    from vision_pt_tpu_torch.config import TrainConfig

    phase = "sdxl_slice14_parity"
    side = PARITY_SIDE
    with open(os.path.join(ROOT, SDXL_TRAIN_CONFIGS["lora"]["path"])) as f:
        peft = yaml.safe_load(f)["peft"]
    rng = np.random.default_rng(14)
    yy, xx = np.mgrid[0:side, 0:side] / side
    image = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy - 0.5], -1)
    image = np.clip(image + rng.normal(0, 0.05, size=image.shape), -1, 1).astype(np.float32)
    sizes = {"original_size": np.full((1, 2), side, np.int32),
             "target_size": np.full((1, 2), side, np.int32),
             "crop_coords_top_left": np.zeros((1, 2), np.int32)}
    latent, lowres = (1, side // 8, side // 8, 4), (1, side // 16, side // 16, 4)

    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    timm_path, timm_shape = towers["timm"]
    cases = {
        "rope_distill": (
            peft, {}, {"image": image[None], "caption": ["1girl, solo, red hair"], **sizes},
            {"vae_noise": normal(latent), "timesteps": torch.tensor([400], dtype=torch.int32),
             "noise": normal(latent), "lowres_vae_noise": normal(lowres),
             "lowres_noise": normal(lowres)}, 2 * 70),
        "draft_plus": (
            peft, {"total_steps": 1, "sample_height": side, "sample_width": side,
                   "reward_models": [{"type": "pickscore", "weights_path": towers["pickscore"],
                                      "tokenizer": "word-hash"}]},
            {"caption": ["a red fox in the snow, detailed fur"]},
            {"latents": normal(latent), "step_noise": [normal(latent)]},
            2 * 70),
        "style_tokenizer": (
            None, {"drop_image_rate": 0.0, "adapter": {"image_encoder": {
                "type": "timm", "weights_path": timm_path,
                "feature_dim": timm_shape["embed_dim"], "num_heads": timm_shape["num_heads"]}}},
            {"image": image[None], "caption": [STYLE_PREFIX + "1girl, solo, red hair"],
             **sizes},
            {"vae_noise": normal(latent), "timesteps": torch.tensor([400], dtype=torch.int32),
             "noise": normal(latent)}, 4),
    }
    launches = {}
    for name, (lora, model, batch, draws, n_grads) in cases.items():
        module, cls_name = SLICE_WORKLOADS[name].split(".")
        workload_cls = getattr(importlib.import_module(
            f"vision_pt_tpu_torch.workloads.{module}"), cls_name)
        raw = _parity_config("bfloat16", lora, **model)
        config = TrainConfig.model_validate(raw)
        card = workload_cls(config, torch.device("cuda"))
        card.setup_model()
        if lora is not None:
            _attach(card, lora)
        launches[f"{name}_parity_step"] = _parity_case(
            phase, name, workload_cls, config, card, batch, draws,
            SLICE_PARITY_LAUNCHES[name], n_grads, kernel_floor=SLICE_KERNEL_FLOOR[name],
            inputs=("1 sampler step, differentiated, the small PickScore"
                    if name == "draft_plus" else "an image, injected draws"))
        _fp32_witness(phase, workload_cls, raw, card, batch, draws,
                      SLICE_WITNESS_FLOOR.get(name, SDXL_FP32_WITNESS_FLOOR))
        del card
        torch.cuda.empty_cache()
    return launches


def phase_slice14(tmp: str) -> tuple[dict[str, tuple[int, ...]], dict]:
    """RoPE distillation, DRaFT+ and the style tokenizer: towers written once
    (PickScore's CLIP-H/14 and the small one, the ViT-B/16-448 timm tower and
    the small one), the parity phase, then the three full-width trainers.
    Returns the launches, and the small PickScore and the data folders for
    sdxl_adapter_mesh_reduced."""
    from vision_pt_tpu_torch.tools.bench.draft_plus_gap import (
        SMALL_PICKSCORE,
        write_pickscore,
    )

    t0 = time.perf_counter()
    images = os.path.join(tmp, "images")
    _write_sdxl_images(images)
    referenced = os.path.join(tmp, "referenced")
    _write_referenced_images(referenced, images)
    reference = os.path.join(tmp, "style_reference.jpg")
    _reference_image(5).save(reference)
    cuda = torch.device("cuda")
    towers = {"pickscore": write_pickscore(os.path.join(tmp, "pickscore"), PICKSCORE_H14, 5,
                                           cuda),
              "timm": _write_tower(os.path.join(tmp, "vit.safetensors"), "timm",
                                   VIT_B16_448, seed=3)}
    small = {"pickscore": write_pickscore(os.path.join(tmp, "pickscore_small"),
                                          SMALL_PICKSCORE, 6, cuda),
             "timm": (_write_tower(os.path.join(tmp, "vit_small.safetensors"), "timm",
                                   SMALL_TOWERS["timm"], seed=4), SMALL_TOWERS["timm"])}
    emit("slice14_towers", seconds=time.perf_counter() - t0,
         pickscore_bytes=os.path.getsize(os.path.join(towers["pickscore"],
                                                      "model.safetensors")),
         pickscore_shape=PICKSCORE_H14, timm_shape=VIT_B16_448)

    def lora_only(names):
        return {n for n in names if ".lora_" in n}

    def towers_of(workload):
        return [(f"reward{i}.{n}", p) for i, reward in enumerate(workload.reward_models)
                for n, p in reward.model.named_parameters()]

    def vision_tower(workload):
        encoder = workload.model.vision_encoder
        if encoder.model is None:
            encoder._load_model()
        return [("tower." + n, p) for n, p in encoder.model.named_parameters()]

    # the parity phase first: its CPU halves run in the worker beside the
    # trainers
    launches = phase_slice14_parity(small)
    launches.update({
        "rope_distill_trainer": phase_slice_trainer(
            tmp, "rope_distill", {}, images, lambda w: [], lora_only),
        "draft_plus_trainer": phase_slice_trainer(
            tmp, "draft_plus", {"total_steps": DRAFT_SAMPLER_STEPS, "reward_models": [{
                "type": "pickscore", "weights_path": towers["pickscore"],
                "tokenizer": "word-hash"}]}, images, towers_of, lora_only),
        "style_tokenizer_trainer": phase_slice_trainer(
            tmp, "style_tokenizer", {"adapter": {"image_encoder": {
                "type": "timm", "weights_path": towers["timm"],
                "feature_dim": VIT_B16_448["embed_dim"],
                "num_heads": VIT_B16_448["num_heads"]}}}, referenced, vision_tower,
            lambda names: {n for n in names if n.startswith(("projector_1.", "projector_2."))},
            reference=reference,
            caption_processors=[{"type": "prefix", "prefix": STYLE_PREFIX}]),
    })
    return launches, {"pickscore_small": small["pickscore"], "images": images,
                      "referenced": referenced}


# ---------------------------------- text-conditioned JiT, the feed, the losses

# 8 prompts of 1-12 words: the word-hash tokenizer gives each a word a token,
# so the context is 12 tokens long, most rows right-padded with 151643
TEXT_PROMPTS = ("a red fox in the snow", "lighthouse",
                "two cats asleep on a blue sofa at night near a window",
                "portrait of an old sailor", "a bowl of ramen, steam, top view",
                "mountains", "a city street in the rain with neon signs",
                "a small wooden boat on a calm lake")
TEXT_NEGATIVE = "blurry, low quality"
TEXT_LAUNCHES_PER_REQUEST = _expect({1: 4 * STEPS})  # blocks 0-3, 20 steps
TEXT_PARITY_LAYERS = 2
TEXT_PARITY_STEPS = 2
TEXT_PARITY_FLOOR = {"float32": {"text": 1e-4, "psnr_db": PSNR_FLOOR_DB["float32"]},
                     "bfloat16": {"text": 2e-2, "psnr_db": PSNR_FLOOR_DB["bfloat16"]}}
TEXT_PARITY_LAUNCHES = _expect({1: 4 * TEXT_PARITY_STEPS})
LOSSES_TOL = 1e-4
LOSSES_BATCH, SHORTCUT_BATCH = 8, 4
LOSSES_LAUNCHES = _expect({1: 3 * 12})  # 3 denoiser calls, 12 unmasked blocks
FEED_IMAGES, FEED_WINDOWS, FEED_STEPS = 512, 3, 10
FEED_HEADERS = ("/usr/include/jpeglib.h", "/usr/include/png.h", "/usr/include/webp/decode.h")


def _qwen_config(layers: int):
    import dataclasses

    from vision_pt_tpu_torch.models.jit.text_encoder import QWEN3_VL_2B_TEXT_CONFIG

    return dataclasses.replace(QWEN3_VL_2B_TEXT_CONFIG, num_hidden_layers=layers)


def _write_qwen_tower(path: str, layers: int, seed: int, device: str) -> float:
    """An HF-style Qwen3-VL directory (``config.json`` nesting the text
    config, bf16 safetensors in 2 shards under ``model.language_model.``)
    with random weights drawn on ``device`` from ``seed``: the linears and
    the embedding at 1/sqrt(fan in), the norm scales in [0.5, 1.5). Written
    once (a marker file); returns the seconds it took."""
    import dataclasses

    from safetensors.torch import save_file

    from vision_pt_tpu_torch.models.lm.model import DecoderLM

    done = os.path.join(path, ".complete")
    if os.path.exists(done):
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    config = _qwen_config(layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        tower = DecoderLM(config, param_dtype=torch.bfloat16, generator=gen)
        with torch.no_grad():
            for name, p in tower.named_parameters():
                if p.dim() == 1:
                    p.uniform_(0.5, 1.5, generator=gen)
    state = {f"model.language_model.{k}": v.cpu() for k, v in tower.state_dict().items()}
    del tower
    keys = sorted(state)
    half = len(keys) // 2
    for i, part in enumerate((keys[:half], keys[half:])):
        save_file({k: state[k] for k in part},
                  os.path.join(path, f"model-{i + 1:05d}-of-00002.safetensors"))
    hf = {k: v for k, v in dataclasses.asdict(config).items()
          if k not in ("arch", "partial_rotary_factor", "hidden_act")}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "qwen3_vl", "tie_word_embeddings": True,
                   "text_config": {**hf, "model_type": "qwen3_vl_text"}}, f)
    open(done, "w").close()
    return time.perf_counter() - t0


def _text_jit_config(tower: str, dtype: str):
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig, TextContextConfig

    return JiTConfig(dtype=dtype, context_encoder=TextContextConfig(pretrained_model=tower),
                     denoiser=JiT_B_16_Config(context_dim=2048))


# the text tower's depth in text_sampler: Qwen3-VL-2B's full width, 4 of its 28
# layers (the tower's attention is plain; no kernel runs in it): 8 paid for
# latent_mesh_trainer's seconds on the card's path, 4 for the adapter mesh
# phases'
TEXT_TOWER_LAYERS, QWEN3_VL_2B_LAYERS = 4, 28


def phase_text_sampler(tmp: str) -> tuple[int, ...]:
    """Text-conditioned JiT-B/16 over the Qwen3-VL-2B text tower at full
    width and TEXT_TOWER_LAYERS layers, loaded from a directory through
    ``from_local``; returns the launches of the 3 timed requests."""
    from vision_pt_tpu_torch.models.jit import JiTModel
    from vision_pt_tpu_torch.models.jit.text_encoder import QwenWordHashTokenizer

    tower = os.path.join(tmp, "qwen3_vl_2b_text")
    write_s = _write_qwen_tower(tower, TEXT_TOWER_LAYERS, 0, "cuda")
    file_bytes = sum(os.path.getsize(os.path.join(tower, f)) for f in os.listdir(tower))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = JiTModel.new_with_config(_text_jit_config(tower, "bfloat16"), seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    encoder = model.text_encoder
    # the directory has no tokenizer files; AutoTokenizer's answer is recorded
    found = None if encoder.tokenizer is None else type(encoder.tokenizer).__name__
    encoder.tokenizer = QwenWordHashTokenizer()
    tower_params = sum(p.numel() for p in encoder.model.parameters())
    layer_params = sum(p.numel() for p in encoder.model.layers[0].parameters())
    # the tower's write and load scale with its bytes: the seconds the cut
    # saves, at this run's rate
    full_params = tower_params + (QWEN3_VL_2B_LAYERS - TEXT_TOWER_LAYERS) * layer_params
    cut_saved_s = (write_s + load_s) * (full_params / tower_params - 1)
    prompts = list(TEXT_PROMPTS)

    def request(seed, steps=STEPS):
        return model.generate(prompt=prompts, negative_prompt=TEXT_NEGATIVE, width=256,
                              height=256, num_inference_steps=steps, cfg_scale=2.0,
                              seed=seed, return_arrays=True)

    request(100)  # warm-up
    encode_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encoder.encode_prompts(prompts, TEXT_NEGATIVE, use_negative_prompts=True,
                                     max_token_length=64)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
    context_len = enc.positive_embeddings.shape[1]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    seconds, per_request = [], []
    for i in range(3):
        before = _counts()
        t0 = time.perf_counter()
        out = request(i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_request.append(_diff(_counts(), before))
        check(tuple(out.shape) == (len(prompts), 256, 256, 3), f"shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite text sampler image")
    launches = _counts()
    emit("text_sampler", model="JiT-B/16 (context 2048) + Qwen3-VL-2B text tower "
         "(random weights, seed 0)", tower_layers=encoder.model.config.num_hidden_layers,
         cut=f"{TEXT_TOWER_LAYERS} of the tower's {QWEN3_VL_2B_LAYERS} layers, full width",
         cut_saved_seconds=cut_saved_s, full_tower_params=full_params,
         tower_params=tower_params, tower_param_dtype="float32", tower_file_bytes=file_bytes,
         tower_write_seconds=write_s, load_seconds=load_s, tokenizer="Qwen word-hash",
         tokenizer_from_directory=found,
         prompts=len(prompts), context_tokens=context_len, resolution=256, cfg=2.0,
         steps=STEPS, compute="bfloat16", encode_seconds=encode_s,
         request_seconds=seconds, steps_per_second=[STEPS / s for s in seconds],
         launches_per_request=per_request, expected=TEXT_LAUNCHES_PER_REQUEST,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         cpu_count=os.cpu_count())
    check(per_request == [TEXT_LAUNCHES_PER_REQUEST] * 3,
          f"text sampler launches per request {per_request}, expected "
          f"{TEXT_LAUNCHES_PER_REQUEST}")
    profile("text_sampler_2_steps", lambda: request(7, steps=2))
    del model, encoder, enc
    torch.cuda.empty_cache()
    return launches


def _text_parity_run(dtype: str, device: str, work: str) -> dict:
    """text_parity on ``device``: the 2-layer tower (written once on the host
    from seed 1 into ``work``), JiT-B/16 from seed 0; a 2-step CFG generate
    from injected noise in ``dtype``, and in the fp32 run only, the
    penultimate states of the pipeline's fp32 tower and of the same tower in
    bf16 (both towers are compared once)."""
    from vision_pt_tpu_torch.models.jit import JiTModel
    from vision_pt_tpu_torch.models.jit.text_encoder import (
        QwenWordHashTokenizer,
        TextEncoder,
    )
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    tower = os.path.join(work, f"qwen_parity_{device}")
    _write_qwen_tower(tower, TEXT_PARITY_LAYERS, 1, "cpu")
    prompts = list(TEXT_PROMPTS[:2])
    init = np.random.default_rng(5).normal(size=(2, 256, 256, 3)).astype(np.float32)
    model = JiTModel.new_with_config(_text_jit_config(tower, dtype), seed=0, device=device)
    model.text_encoder.tokenizer = QwenWordHashTokenizer()
    texts = {}
    if dtype == "float32":
        bf16_tower = TextEncoder.from_local(tower, dtype=torch.bfloat16, device=device)
        bf16_tower.tokenizer = QwenWordHashTokenizer()
        for name, encoder in (("float32", model.text_encoder), ("bfloat16", bf16_tower)):
            enc = encoder.encode_prompts(prompts, TEXT_NEGATIVE, use_negative_prompts=True)
            texts[name] = torch.cat([enc.positive_embeddings, enc.negative_embeddings]
                                    ).float().cpu().numpy()
        del bf16_tower
    _reset_counts()
    t0 = time.perf_counter()
    with attention_dtype(None if dtype == "float32" else torch.bfloat16):
        out = model.generate(prompt=prompts, negative_prompt=TEXT_NEGATIVE, width=256,
                             height=256, num_inference_steps=TEXT_PARITY_STEPS,
                             cfg_scale=2.0, execution_dtype=getattr(torch, dtype),
                             initial_noise=init, return_arrays=True)
    image = out.float().cpu().numpy()
    return {"text": texts, "image": image, "launches": _counts(),
            "seconds": time.perf_counter() - t0}


@_tf32_off()
def phase_text_parity(work: str) -> None:
    for dtype in ("float32", "bfloat16"):
        future = _HALVES.take(("text_parity", dtype), f"text_parity {dtype}",
                              _text_parity_run, dtype, "cpu", work)
        card = _text_parity_run(dtype, "cuda", work)
        check(np.isfinite(card["image"]).all(), "non-finite text parity image")
        check(card["launches"] == TEXT_PARITY_LAUNCHES,
              f"text parity launches {card['launches']}, expected {TEXT_PARITY_LAUNCHES}")

        def finish(host, where, dtype=dtype, card=card):
            floor = TEXT_PARITY_FLOOR[dtype]
            text = {k: _rel_l2(card["text"][k], host["text"][k]) for k in card["text"]}
            text_floor = {k: TEXT_PARITY_FLOOR[k]["text"] for k in text}
            value = psnr(card["image"], host["image"])
            emit("text_parity", dtype=dtype, tower_layers=TEXT_PARITY_LAYERS,
                 widths="full (Qwen3-VL-2B text tower, 151,936 tokens; JiT-B/16)",
                 batch=2, cfg=2.0, steps=TEXT_PARITY_STEPS, **where,
                 text_rel_l2=text, text_floor=text_floor,
                 psnr_db=value, floor_db=floor["psnr_db"],
                 launches_cuda=card["launches"], launches_cpu=host["launches"],
                 seconds_cuda=card["seconds"], seconds_cpu=host["seconds"])
            check(host["launches"] == _expect({}), f"text parity CPU launches {host['launches']}")
            check(len(text) == (2 if dtype == "float32" else 0),
                  f"text towers compared in the {dtype} run: {sorted(text)}")
            check(all(text[k] <= text_floor[k] for k in text),
                  f"text tower card-vs-CPU {text}")
            check(value >= floor["psnr_db"],
                  f"{dtype} text sampler card-vs-CPU PSNR {value:.2f} dB < {floor['psnr_db']}")

        _HALVES.then(future, finish)
        torch.cuda.empty_cache()


def _write_lpips(path: str, seed: int) -> str:
    """Random VGG16 convs and heads in the lpips package's layout (``.pth``),
    drawn on the host from ``seed``; written once."""
    if not os.path.exists(path):
        from vision_pt_tpu_torch.ops.loss import perceptual

        gen = torch.Generator().manual_seed(seed)
        sd = {}
        for k, (stage, idxs) in enumerate(zip(perceptual._VGG16_STAGES,
                                              perceptual._VGG16_CONV_IDX)):
            for (cin, cout), idx in zip(stage, idxs):
                sd[f"net.slice{k + 1}.{idx}.weight"] = torch.randn(
                    cout, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
                sd[f"net.slice{k + 1}.{idx}.bias"] = 0.05 * torch.randn(cout, generator=gen)
            sd[f"lin{k}.model.1.weight"] = 0.2 * torch.rand(1, stage[-1][1], 1, 1,
                                                            generator=gen)
        torch.save(sd, f"{path}.{os.getpid()}.tmp")
        os.replace(f"{path}.{os.getpid()}.tmp", path)
    return path


def _losses_run(device: str, work: str) -> dict:
    """losses on ``device``: PerceptualLoss (SSIM + LPIPS) over 8 pairs at
    256^2, and the shortcut durations (injected draws), teacher targets and
    loss over JiT-B/16 in fp32."""
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config
    from vision_pt_tpu_torch.models.jit.denoiser import Denoiser
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.ops.loss import perceptual, shortcut

    rng = np.random.default_rng(11)
    pred = rng.uniform(-1, 1, (LOSSES_BATCH, 256, 256, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.3, pred.shape), -1, 1).astype(np.float32)
    loss = perceptual.PerceptualLoss({"ssim": 1.0, "lpips": 1.0},
                                     lpips_weights_path=_write_lpips(
                                         os.path.join(work, "lpips_vgg16.pth"), 3),
                                     device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        values = loss(torch.from_numpy(pred).to(device), torch.from_numpy(target).to(device))
    values = {k: float(v) for k, v in values.items()}
    perceptual_s = time.perf_counter() - t0

    b = SHORTCUT_BATCH
    durations = shortcut.prepare_random_shortcut_durations(
        None, b, device=device, exponent=torch.from_numpy(rng.integers(1, 7, b)),
        raw=torch.from_numpy(rng.integers(0, 128, b)))
    latents = torch.from_numpy(rng.normal(size=(b, 256, 256, 3)).astype(np.float32)).to(device)
    context = torch.from_numpy(rng.normal(size=(b, 32, 768)).astype(np.float32)).to(device)
    sizes = torch.full((b, 2), 256.0, device=device)
    crop = torch.zeros(b, 2, device=device)
    model = Denoiser(JiT_B_16_Config(), generator=torch.Generator().manual_seed(0),
                     device=device).eval()

    def denoiser(x, ctx, t, dt):  # the JiT denoiser has no duration input
        return model(x, t, ctx, sizes, sizes, crop)

    _reset_counts()
    with attention_dtype(None):
        targets = shortcut.prepare_self_consistency_targets(
            denoiser, latents, context, durations.departure_timesteps,
            2 * durations.shortcut_duration)
        with torch.no_grad():
            double = denoiser(latents, context, durations.departure_timesteps,
                              2 * durations.shortcut_duration)
        value = shortcut.loss_with_shortcut_self_consistency(*targets, double)
    return {"perceptual": values, "perceptual_seconds": perceptual_s,
            "durations": [t.cpu().numpy() for t in durations],
            "targets": [t.float().cpu().numpy() for t in targets],
            "velocity": shortcut.get_shortcut_target_velocity(*targets).cpu().numpy(),
            "shortcut_loss": float(value), "launches": _counts()}


@_tf32_off()
def phase_losses(work: str) -> tuple[int, ...]:
    future = _HALVES.take("losses", "losses", _losses_run, "cpu", work)
    card = _losses_run("cuda", work)
    check(card["launches"] == LOSSES_LAUNCHES,
          f"losses launches {card['launches']}, expected {LOSSES_LAUNCHES}")
    check(all(np.isfinite(v) for v in card["perceptual"].values())
          and np.isfinite(card["shortcut_loss"]), "non-finite loss")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def finish(host, where):
        errors = {f"perceptual_{k}": rel(card["perceptual"][k], host["perceptual"][k])
                  for k in card["perceptual"]}
        errors["shortcut_loss"] = rel(card["shortcut_loss"], host["shortcut_loss"])
        errors["first_shortcut"], errors["second_shortcut"] = (
            _rel_l2(c, h) for c, h in zip(card["targets"], host["targets"]))
        errors["target_velocity"] = _rel_l2(card["velocity"], host["velocity"])
        emit("losses", batch={"perceptual": LOSSES_BATCH, "shortcut": SHORTCUT_BATCH},
             resolution=256, dtype="float32", lpips="random VGG16, lpips layout",
             denoiser="JiT-B/16 (seed 0), 32 context tokens", **where,
             values_cuda={**card["perceptual"], "shortcut": card["shortcut_loss"]},
             values_cpu={**host["perceptual"], "shortcut": host["shortcut_loss"]},
             rel_error=errors, tol=LOSSES_TOL, perceptual_seconds_cuda=card[
                 "perceptual_seconds"], launches_cuda=card["launches"],
             launches_cpu=host["launches"])
        for c, h in zip(card["durations"], host["durations"]):
            check(np.array_equal(c, h), "shortcut durations differ between card and CPU")
        check(host["launches"] == _expect({}), f"losses CPU launches {host['launches']}")
        check(all(e <= LOSSES_TOL for e in errors.values()),
              f"losses card-vs-CPU {errors} over {LOSSES_TOL}")

    _HALVES.then(future, finish)
    torch.cuda.empty_cache()
    return card["launches"]


def _write_feed_images(folder: str, n: int = FEED_IMAGES, seed: int = 0) -> list[dict]:
    """The JAX package's e2e image set (``_ensure_e2e_image_set``): textured
    gradients with noise at 320-384 x 288-384, JPEG quality 85, captions
    ``bench class {i % 16}``, from numpy draws of ``seed``."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    widths, heights = [320, 352, 384, 336], [288, 384, 320, 352]
    grids, items = {}, []
    for i in range(n):
        w, h = widths[i % 4], heights[(i // 4) % 4]
        if (h, w) not in grids:
            grids[(h, w)] = np.meshgrid(np.linspace(0, 4 * np.pi, w, dtype=np.float32),
                                        np.linspace(0, 4 * np.pi, h, dtype=np.float32))
        xs, ys = grids[(h, w)]
        phase = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
        base = np.stack([127 + 100 * np.sin(xs * (1 + c * 0.3) + ys + phase[c])
                         for c in range(3)], axis=-1)
        noise = rng.normal(0, 12, size=(h, w, 3)).astype(np.float32)
        path = os.path.join(folder, f"img_{i:05d}.jpg")
        Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8)).save(path, quality=85)
        with open(path[:-4] + ".txt", "w") as f:
            f.write(f"bench class {i % 16}")
        items.append({"image": path, "caption": f"bench class {i % 16}"})
    return items


def _write_latent_feed(folder: str, n: int = FEED_IMAGES, size: int = 32, ch: int = 4):
    """The JAX package's e2e latent cache (``_ensure_latent_cache``): fp16
    mean and std per item, its manifest rows."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        name = f"lat_{i:05d}.npz"
        np.savez(os.path.join(folder, name),
                 mean=rng.standard_normal((size, size, ch)).astype(np.float16),
                 std=(0.1 + 0.05 * rng.random((size, size, ch))).astype(np.float16))
        rows.append({"file": name, "caption": f"bench class {i % 16}",
                     "width": size * 8, "height": size * 8,
                     "original_size": [size * 8] * 2, "target_size": [size * 8] * 2,
                     "crop_coords_top_left": [0, 0], "scaling_factor": 0.13025})
    return rows


def phase_e2e_feed(tmp: str) -> dict[str, tuple[int, ...]]:
    """On-disk JPEGs -> C loader in worker processes -> shared memory -> the
    card -> the headline JiT-B/16 step; then cached latents into the latent
    step. Returns the fed steps' launches."""
    from vision_pt_tpu_torch.benchmarks import _jit_train_setup
    from vision_pt_tpu_torch.data import native_image
    from vision_pt_tpu_torch.data.latent_cache import CachedLatentBucket
    from vision_pt_tpu_torch.data.text_to_image import TextToImageBucket
    from vision_pt_tpu_torch.data.worker_pool import (
        BatchWorkerPool,
        infinite_indices,
        pool_cpu_budget,
        to_device,
    )
    from vision_pt_tpu_torch.models.jit import DenoiserConfig, JiT_B_16_Config

    batch, side, depth, workers = TRAIN_BATCH, 256, 3, pool_cpu_budget()
    # every checked batch comes from a worker (the schema probe is not
    # yielded), and the last two from slots already used once
    checked = depth + workers + 2
    headers = {h: os.path.exists(h) for h in FEED_HEADERS}
    toolchain = all(headers.values()) and shutil.which("g++") is not None
    shm = shutil.disk_usage("/dev/shm")
    t0 = time.perf_counter()
    items = _write_feed_images(os.path.join(tmp, "e2e_jpegs"))
    write_s = time.perf_counter() - t0
    native = native_image.native_available()
    emit("e2e_feed", case="host", headers=headers, gxx=shutil.which("g++"),
         c_loader=native, c_loader_error=native_image.build_error(),
         dev_shm_bytes={"total": shm.total, "free": shm.free},
         slot_bytes=batch * side * side * 3, slots=depth + workers, workers=workers,
         cpu_count=os.cpu_count(), images=len(items), write_seconds=write_s,
         decode_path="C loader" if native else "PIL (no C loader)")
    if toolchain:
        check(native, f"the C loader did not build: {native_image.build_error()}")
    # a slot written past the end of /dev/shm kills its worker with SIGBUS
    check(shm.free > 1.2 * (depth + workers) * batch * side * side * 3,
          f"/dev/shm has {shm.free} bytes free, too few for {depth + workers} slots")

    bucket = TextToImageBucket(items=items, batch_size=batch, width=side, height=side,
                               do_upscale=False, seed=0, output_dtype="uint8")
    calls = [0]
    load = native_image.load_cover_crop

    def counted(*args):
        calls[0] += 1
        return load(*args)

    native_image.load_cover_crop = counted
    try:
        for _ in range(2):
            bucket.get_batch(0)  # page cache, thread pool
        calls[0] = 0
        t0 = time.perf_counter()
        expected = [bucket.get_batch(i % bucket.num_batches) for i in range(checked)]
        host_rate = checked * batch / (time.perf_counter() - t0)
    finally:
        native_image.load_cover_crop = load
    if native:
        check(calls[0] == checked * batch,
              f"the bucket took the C loader for {calls[0]} of {checked * batch} images")

    model, optimizer, step = _jit_train_setup(JiT_B_16_Config(), batch, side,
                                              dtype=torch.bfloat16, param_dtype=torch.float32,
                                              device="cuda")
    copy_s = [0.0]

    def fed(b):
        t = time.perf_counter()
        out = to_device(b, "cuda")
        copy_s[0] += time.perf_counter() - t
        return out

    def normalize(img_u8):
        return img_u8.float() / 127.5 - 1.0

    pool = BatchWorkerPool(bucket.get_batch, infinite_indices(bucket.num_batches),
                           num_workers=workers, depth=depth, probe_index=0)
    try:
        it = pool.iter_device(fed)
        delivered = [next(it) for _ in range(checked)]
        same = [all(np.array_equal(d[k].cpu().numpy(), e[k])
                    for k in ("image", "original_size", "crop_coords_top_left"))
                and d["caption"] == e["caption"] for d, e in zip(delivered, expected)]
        check(all(same), f"fed batches differ from the in-process ones: {same}")
        step(0, images=normalize(delivered[0]["image"]))  # warm-up
        del delivered
        torch.cuda.synchronize()
        wait0, decode0, copy0 = pool.consumer_wait_s, pool.worker_decode_s, copy_s[0]
        _reset_counts()
        windows, losses, i = [], [], 1
        t_all = time.perf_counter()
        for _ in range(FEED_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(FEED_STEPS):
                losses.append(step(i, images=normalize(next(it)["image"])))
                i += 1
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / FEED_STEPS)
        measured_s = time.perf_counter() - t_all
        counts = _counts()
        wait, decode = pool.consumer_wait_s - wait0, pool.worker_decode_s - decode0
        copies = copy_s[0] - copy0
        resident = normalize(next(it)["image"])
    finally:
        pool.close()
    t0 = time.perf_counter()
    for _ in range(FEED_STEPS):
        step(i, images=resident)
        i += 1
    torch.cuda.synchronize()
    device_step = (time.perf_counter() - t0) / FEED_STEPS
    losses = [float(x) for x in losses]
    steps = FEED_WINDOWS * FEED_STEPS
    emit("e2e_feed", case="jit_b16_pixels", batch=batch, resolution=side,
         decode_path="C loader" if native else "PIL", workers=workers, depth=depth,
         slots=depth + workers, cpu_count=os.cpu_count(),
         host_decode_images_per_second=host_rate,
         seconds_per_step=windows, images_per_second=[batch / s for s in windows],
         best_images_per_second=batch / min(windows),
         resident_batch_images_per_second=batch / device_step,
         consumer_wait_seconds=wait, worker_decode_seconds=decode,
         host_to_device_seconds=copies, host_to_device_ms_per_batch=1e3 * copies / steps,
         measured_seconds=measured_s, consumer_wait_share=wait / measured_s,
         fed_steps=steps, checked_batches=checked, recycled_checked=checked - depth - workers,
         launches=counts,
         fwd_launches_per_step=counts[0] / steps, bwd_launches_per_step=counts[1] / steps,
         losses=losses[-3:])
    check(all(np.isfinite(losses)), f"non-finite fed loss {losses}")
    check(counts == _expect({1: 12 * steps, 2: 12 * steps}),
          f"fed step launches {counts} over {steps} steps, expected 12 + 12 a step")
    del model, optimizer, step, resident
    torch.cuda.empty_cache()

    rows = _write_latent_feed(os.path.join(tmp, "e2e_latents"))
    latents = CachedLatentBucket(rows, os.path.join(tmp, "e2e_latents"), batch_size=batch,
                                 sample=True, seed=0)
    config = DenoiserConfig(in_channels=4, out_channels=4, patch_size=4, hidden_size=768,
                            depth=12, num_heads=12, bottleneck_dim=128, context_dim=768,
                            context_start_block=4, rope_axes_dims=[16, 24, 24],
                            rope_axes_lens=[256, 64, 64])
    model, optimizer, step = _jit_train_setup(config, batch, 32, dtype=torch.bfloat16,
                                              param_dtype=torch.float32, device="cuda")
    expected = [latents.get_batch(i % latents.num_batches)["latents"]
                for i in range(checked)]
    pool = BatchWorkerPool(lambda i: {"latents": latents.get_batch(i)["latents"]},
                           infinite_indices(latents.num_batches), num_workers=workers,
                           depth=depth, probe_index=0)
    try:
        it = pool.iter_device(lambda b: to_device(b, "cuda"))
        delivered = [next(it)["latents"] for _ in range(checked)]
        check(all(np.array_equal(d.cpu().numpy(), e) for d, e in zip(delivered, expected)),
              "fed latents differ from the in-process ones")
        step(0, images=delivered[0])
        del delivered
        torch.cuda.synchronize()
        _reset_counts()
        wait0 = pool.consumer_wait_s
        t0 = time.perf_counter()
        for j in range(1, FEED_STEPS + 1):
            loss = step(j, images=next(it)["latents"])
        torch.cuda.synchronize()
        latent_s = (time.perf_counter() - t0) / FEED_STEPS
        latent_counts = _counts()
        wait = pool.consumer_wait_s - wait0
    finally:
        pool.close()
    emit("e2e_feed", case="jit_b_latent", batch=batch, latent="32 x 32 x 4 (fp16 cache)",
         tokens=74, workers=workers, checked_batches=checked, seconds_per_step=latent_s,
         steps_per_second=1 / latent_s, images_per_second=batch / latent_s,
         consumer_wait_seconds=wait, launches=latent_counts, loss=float(loss))
    check(np.isfinite(float(loss)), "non-finite latent loss")
    check(latent_counts == _expect({}), f"latent feed launches {latent_counts} (S 74)")
    del model, optimizer, step
    torch.cuda.empty_cache()
    return {"e2e_feed": counts}


def main(args: list[str]) -> int:
    if args not in ([], ["--kernels-only"]):
        print("usage: chip_smoke.py [--kernels-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    started = time.perf_counter()
    global _HALVES
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if not args:
            # the worker's queue is the run's critical path, and its first
            # jobs need no kernel: they start beside the build
            _start_cpu_halves(work)
        smi = phase_device()
        return _run(args, started, smi, work)
    finally:
        if _HALVES is not None:
            _HALVES.close()
            _HALVES = None
        shutil.rmtree(work, ignore_errors=True)


def _start_cpu_halves(work: str) -> None:
    """The worker, and the CPU halves that need no card work queued at once:
    text_parity and losses, the JiT and latent parity steps, the JiT sampler
    parity and the JiT variants' steps."""
    global _HALVES
    _HALVES = CpuHalves(work)
    label2id = os.path.join(work, "label2id.json")
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    for dtype in ("float32", "bfloat16"):
        _HALVES.early_submit(("text_parity", dtype), f"text_parity {dtype}",
                             _text_parity_run, dtype, "cpu", work)
    _HALVES.early_submit("losses", "losses", _losses_run, "cpu", work)
    phases = {"jit": "train_parity", "latent": "latent_parity"}
    for model, dtype, depth in STEP_PARITY_CASES:
        _HALVES.early_submit((model, dtype), f"{phases[model]} {dtype}", _cpu_step,
                             *_step_args(model, dtype, depth, label2id))
    for dtype in ("float32", "bfloat16"):
        _HALVES.early_submit(("parity", dtype), f"parity {dtype}", _jit_sample, label2id,
                             dtype, "cpu")
    _HALVES.early_submit("jit_variants", "jit_variants_parity", _variant_steps, "cpu",
                         label2id)


def _run(args: list[str], started: float, smi: str, work: str) -> int:
    errors = {**phase_kernel(), **phase_flash_kernel(),
              "dequant_matmul_4bit": phase_nf4_kernel(), **phase_short_kernel()}
    rows = phase_timing()
    rows.update(phase_flash_timing())
    nf4_rows = phase_nf4_timing()
    short_rows = phase_short_timing()
    tread_rows = phase_tread_timing()
    if args:  # no path was driven: no kernels line and no result line
        emit("done", seconds=time.perf_counter() - started)
        return 0
    launches = {}
    # every phase's files stay until the CPU halves are in (a worker job
    # may read them)
    tmp = tempfile.mkdtemp(dir=work)
    label2id = os.path.join(tmp, "label2id.json")
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    launches["sampler"] = phase_sampler(label2id)
    launches["train_step"] = phase_train_step()
    launches["short_path"] = phase_short_path()
    launches["attention_probes"] = phase_attention_probes()
    # early on the card's path, so its CPU half follows the early-queued
    # jobs with no idle gap in the worker
    launches["cache_latents"] = phase_cache_latents(tmp)
    launches["trainer"], no_mesh = phase_trainer(tmp)
    phase_train_parity(label2id)
    phase_parity(label2id)
    launches["text_sampler"] = phase_text_sampler(tmp)
    phase_text_parity(work)
    launches["losses"] = phase_losses(work)
    launches["latent_trainer"], latent_no_mesh = phase_latent_trainer(tmp)
    phase_latent_parity(tmp)
    launches.update(phase_jit_variants_trainer(tmp))
    launches["x_loss_trainer"] = phase_x_loss_trainer(tmp)
    launches.update(phase_jit_variants_parity(label2id))
    launches.update(phase_sdxl_sampler())
    phase_sdxl_parity()
    phase_sdxl_lora_parity()
    launches.update(phase_sdxl_flow_match_parity())
    # every phase that submits a CPU half runs before the SDXL trainers, so
    # the worker is never left waiting for its next job
    adapter_launches, adapter_records = phase_adapters(tempfile.mkdtemp(dir=work))
    launches.update(adapter_launches)
    slice_launches, slice_records = phase_slice14(tempfile.mkdtemp(dir=work))
    launches.update(slice_launches)
    phase_cogview4_parity()
    sdxl_tmp = tempfile.mkdtemp(dir=work)
    sdxl_runs = {}
    for label in ("lora", "qlora", "flow_match"):
        launches[f"sdxl_{label}_trainer"], sdxl_runs[label] = phase_sdxl_trainer(sdxl_tmp,
                                                                                  label)
    # before inference_server, which deletes the NF4 file the QLoRA run reads;
    # the adapter mesh runs start beside sdxl_mesh_trainer's two and end with them
    torch.cuda.empty_cache()
    adapter_started = start_sdxl_adapter_mesh_trainer(sdxl_tmp, adapter_records["ip_adapter"])
    sdxl_mesh_runs = phase_sdxl_mesh_trainer(sdxl_tmp, sdxl_runs)
    phase_sdxl_adapter_mesh_trainer(adapter_started, adapter_records["ip_adapter"],
                                    sdxl_mesh_runs)
    # the reduced adapter mesh cases' process runs beside the CogView4 sampler
    # and the server, device-bound phases whose peaks (38.8 and 36.6 GB) leave
    # the card room for its own (18.7 GB, its DRaFT+ case)
    reduced_started = start_sdxl_adapter_mesh_reduced(tempfile.mkdtemp(dir=work),
                                                      {**adapter_records, **slice_records})
    launches["optimizers"] = phase_optimizers()
    launches.update(phase_cogview4_sampler())
    launches.update(phase_inference_server(sdxl_tmp))
    phase_sdxl_adapter_mesh_reduced(reduced_started, {"inference_server": {
        "exit": 0, "ended_wall": time.time()}})
    # last on the card's path: the worker's queue ends last, and every
    # phase before these submits its CPU halves earlier
    latent_started = start_latent_mesh_trainer(tmp, latent_no_mesh)
    phase_latent_mesh_trainer(latent_started, latent_no_mesh,
                              phase_mesh_trainer(tmp, no_mesh))
    phase_ring()
    _HALVES.drain()
    launches.update(phase_e2e_feed(tempfile.mkdtemp(dir=work)))
    kernels = []
    # each kernel's launches are those of its main path: the training step
    # for the packed kernels (the JiT variants' trainers, parity steps and
    # IG sample beside it), the short backend's path for #3-#6, the latent
    # trainer for the flash kernels (the SDXL requests and trainers and the
    # CogView4 requests beside them), the NF4 SDXL request for kernel #9
    # (the QLoRA trainer, the NF4 CogView4 request and the inference server
    # beside it), the probe tools for #10 and #11
    for number, (row, kernel, path) in enumerate((
            (rows["train"], "short_attention_packed", "train_step"),
            (rows["train_bwd"], "short_attention_packed_bwd", "train_step"),
            (short_rows["short_attention"], "short_attention", "short_path"),
            (short_rows["short_attention_bwd"], "short_attention_bwd", "short_path"),
            (short_rows["short_attention_bhsd"], "short_attention_bhsd", "short_path"),
            (short_rows["short_attention_bhsd_bwd"], "short_attention_bhsd_bwd",
             "short_path"),
            (rows["latent"], "flash_attention", "latent_trainer"),
            (rows["latent_bwd"], "flash_attention_bwd", "latent_trainer"),
            (nf4_rows["path"], "dequant_matmul_4bit", "sdxl_nf4"),
            (short_rows["run_variant"], "run_variant", "attention_probes"),
            (short_rows["dots_variant"], "dots_variant", "attention_probes")),
            start=1):
        kernels.append({"number": number, **row,
                        "launches": launches[path][number - 1],
                        "launches_by_path": {k: v[number - 1] for k, v in launches.items()},
                        "max_abs_err": errors[kernel]})
        check(launches[path][number - 1] > 0, f"{kernel} never launched on {path}")
    kernels[0]["with_lse"] = rows["train_lse"]  # as the training step runs it
    kernels[0]["tread_timing"] = tread_rows["tread"]
    kernels[1]["tread_timing"] = tread_rows["tread_bwd"]
    kernels[1]["retimed_ms"] = short_rows["packed_bwd"]["ms"]  # short_timing
    kernels[6]["sdxl_timing"] = [{**rows[label], "max_abs_err": errors[label]}
                                 for label in ("sdxl_s4096", "sdxl_s1024",
                                               "sdxl_lowres_s1024")]
    kernels[6]["cogview4_timing"] = {**rows["cogview4_s4112"],
                                     "max_abs_err": errors["cogview4_s4112"]}
    kernels[6]["server_timing"] = [{**rows[label], "shape": label}
                                   for label in ("server_s4096", "server_s1024",
                                                 "server_s3072")]
    kernels[7]["sdxl_timing"] = [{**rows[f"{label}_bwd"], "shape": label}
                                 for label in ("sdxl_s4096", "sdxl_s1024",
                                               "sdxl_lowres_s1024")]
    kernels[8]["other_shapes"] = [{**nf4_rows[label], "shape": label} for label in
                                  ("path_n640", "qlora_n640", "qlora_n1280",
                                   "cogview4_ff_proj", "cogview4_ff_out", "bench")]
    emit("done", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
