#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py [--json PATH]

It imports nothing of JAX or of the JAX package, and it fails (exit code
1, no result line) when there is no CUDA device, when it runs without the
repository around it, or when any phase fails.  Phases:

1. Build the four kernel sources from ``src/repro_torch/kernels/csrc``
   (``vsmm.cu``, ``vsconv.cu``, ``vsconv_dw.cu``, ``flash_fwd.cu``; one
   nvcc per source, started together) and print their register use, the
   registers and spill bytes of each flash instantiation (the bf16 hd-128
   one must not spill), of each of the 26 stem-body and depthwise
   instantiations (8 f32 and 8 int8 stem bodies, 10 dw), of the 42 int8
   instantiations (vsmm's 5 phase-1 and 1 phase-2 kernels, the generic
   conv body's 16 phase-1 and 2 phase-2 int8 kernels, the 8 int8 stem
   bodies, 5 dw halo, 5 dw stack), of the 14 vsmm instantiations (f32
   per RT, int8 per RT and split, bf16 per row tile on the tensor cores:
   8, 16 and 32 rows decode, 64 prefill; the phase 2 kernels, f32 and
   bf16 sharing the f32 one) and
   of the 30 generic conv body instantiations
   (per layout: f32 at 128 and 64 rows x vn 128 and 64 and the general
   one; int8 the same four, split at 64 rows x vn 128 and 64, the general
   one whole and split; phase 2 f32 and int8); none of these may spill),
   and the flash kernel's dynamic shared memory per head dim and body.
2. Kernel phase.  Each kernel against its plain version on the card,
   within a relative error of 1e-5 of max|y| (1e-2 for the flash kernel
   on bf16 inputs), then timed (see below).  One JSON line per case.  The
   CNN kernels at batch 8, 224 px geometries, each case without and with
   the fused epilogue (bias + residual + ReLU):
   - halo conv: the ResNet-18 layers (stem 7x7/s2 vk 8; 3x3/s1 at 56;
     3x3/s2 64->128; 3x3 512->512 at Hout 7) and one Hout < 4 conv
     (layer4 at 32 px); vsmm: the 1x1/s2 projection and the FC head,
     and VGG-16's fc1, MobileNetV1's pw1, pw13 and head (`vsmm_cases`,
     f32 and int8); every vsmm row names its plan (``rows``,
     ``splits``: `vsmm_plan`);
   - depthwise halo: MobileNetV1's dw1 (112, C 32), dw2 (112 -> 56, C 64),
     dw7 (14, C 512), dw12 (14 -> 7, C 512), dw13 (7, C 1024);
   - stack conv: the ResNet-18 stem 7x7/s2, a 3x3/s1 at 56, a 3x3/s2
     64->128;
   - both layouts: the MobileNetV1 stem 3x3/s2 cin 3 -> 8 -> 32, a 7x7/s2
     stem at 227 px (Hout 114, which cuts the stem body's 8 x 16 tiles),
     one grouped 3x3 (64 -> 64, groups 4, 56 px);
   - depthwise stack: dw1, dw2 and dw12.
   The generic conv body (`generic_cases`): VGG-16's conv2 (224 px, vn
   64), conv9 (28 px), conv11 (14 px) and ResNet-18's layer4 (7 px), f32
   and int8 (bit-equal), both layouts, without and with the epilogue.
   Each conv row names its body (``"stem"`` where `use_stem_body` holds,
   else ``"generic"``); a generic row names its plan (``rows``,
   ``splits``: `conv_plan`), and where the plan splits the stored steps
   two launches must give the same bits.
   The int8 branches (`int8_kernel_cases`), each bit-equal to its plain
   version (max|Δ| 0), without and with the epilogue, on int8 tiles and
   activations quantized on the card: the halo and the stack conv at the
   stems (ResNet-18's 7x7/s2, MobileNetV1's 3x3/s2, VGG-16's conv1 and
   7x7/s2 at 227 px, on the int8 stem body), 3x3/s1 at 56, 3x3/s2
   64->128, 3x3 512->512 at Hout 7 and the Hout < 4 case; vsmm at the
   1x1/s2 projection and the FC head; the dw halo and dw stack at dw1,
   dw2, dw12.
   The dense-input mode (`skip_cases`): every kernel and branch (f32 and
   int8 generic and stem bodies in both layouts, at 3x3/s1 56 px and
   VGG-16's conv1; both dw kernels at dw2; vsmm at the 1x1/s2 projection
   and, split, at MobileNetV1's head) with ``skip_zero_inputs=False`` on
   a post-ReLU input whose
   first image is all zero: bit-equal to the skip on, equal to plain,
   both timed (``kernel_ms`` skip off, ``skip_on_ms``).
   The flash kernel (`flash_phase`): Qwen1.5-4B's admission prefill (BH
   160 = 8 x 20 heads, T 512, hd 128, causal) in bf16 and f32, a backfill
   length (T 528), a window of 1024 at T 2048 and hd 240, a q_offset of
   512 (Tq 64 against Tk 576), a bf16 hd-64 case (BH 64, T 1024), a
   non-causal hd 80 case and an odd length (T 33, hd 32), and the LM
   paths' prefill shapes (InternVL2-26B's BH 384 T 1280 hd 128 and
   HuBERT-XLarge's non-causal BH 128 T 1000 hd 80, bf16; the sparse Qwen
   serve's are the dense one's).  bf16 runs the tensor-core body, f32
   the CUDA-core one; each row names its body, and two launches of each
   case must give bit-equal outputs.
   vsmm's bf16 branch (`vsmm_bf16_cases`): the sparse FFN's products of
   Qwen1.5-4B (``wi``, vn 108; the merged ``wo``, vk 27) and Nemotron-4
   at full width (tiles drawn on the card by the schema's laws), and one
   weight pruned from a dense random matrix (K-tile ids that differ from
   strip to strip), each at M 8 and 1024 (Qwen's also at 4096, its
   sparse prefill's rows), bf16 in and f32 out: relative 1e-5 of its
   plain version, skip off bit-equal to skip on, the bf16 output the f32
   one rounded; library = ``torch.mm`` of the bf16 input and the decoded
   bf16 weight with an f32 output; the FLOP bound at the bf16 tensor-core
   peak.  Each row names its plan (``tiling``, ``rows``, ``splits``:
   `vsmm_bf16_plan`), its share of the bound and kernel_ms / library_ms.
   `vk27_staging` then times two ways of staging the 2-byte aligned
   activation rows of Qwen's merged ``wo`` (vk 27) at M 8 and 4096: the
   kernel's own (the 16-byte units spanning each row, shifted in shared
   memory) against padding x to vk 32 in the wrapper (the pad's time
   plus the kernel on the padded operands).
3. Serve phases, one per path.  Before each, every launch count is set
   to 0; the port's ``CNNServer(cfg, batch=8, impl=...)`` serves seeded
   224x224x3 requests, every wave by CUDA-graph replay (one graph per
   shape bucket, `BatchedApply`); the counts are read just after.  The
   first wave of a bucket runs its forward twice on the device, an eager
   warm-up and the first replay, and the capture between them runs
   nothing: the counts count what the device ran (`kernels.capture`), so
   they must be exactly the path's per-forward launches times (waves +
   graphs captured), with one graph and one replay a wave:
   - ResNet-18, halo (16 requests): 17 vsconv_halo + 4 vsmm per wave;
   - MobileNetV1, halo (16 requests):
     1 vsconv_halo + 13 vsconv_dw_halo + 14 vsmm per wave;
   - MobileNetV1, stack (8 requests, one wave): 1 vsconv_stack +
     13 vsconv_dw_stack + 14 vsmm;
   - ResNet-18, stack (8 requests, one wave): 17 vsconv_stack + 4 vsmm;
   - ResNet-18, int8 halo (``CNNServer(..., dtype="int8")``, 16
     requests): 17 vsconv_halo + 4 vsmm per wave, all int8 launches;
   - MobileNetV1, int8 halo (16 requests): 1 vsconv_halo + 13
     vsconv_dw_halo + 14 vsmm per wave, all int8 launches;
   - ResNet-18, int8 stack (``CNNServer(..., dtype="int8",
     impl="pallas-stack")``, 8 requests): 17 vsconv_stack + 4 vsmm, all
     int8 launches;
   - MobileNetV1, int8 stack (8 requests): 1 vsconv_stack + 13
     vsconv_dw_stack + 14 vsmm, all int8 launches;
   - VGG-16, halo (``vscnn-vgg16``, 16 requests): 13 vsconv_halo + 3
     vsmm per wave (conv1 on the stem body);
   - VGG-16, int8 stack (8 requests): 13 vsconv_stack + 3 vsmm, all int8
     launches;
   - ResNet-34, halo and int8 halo (16 requests each): 33 vsconv_halo
     (the stem and 32 3x3s) + 4 vsmm (3 projections, the head) per wave;
   - ResNet-50, halo and int8 halo (16 requests each): 17 vsconv_halo
     (the stem and 16 3x3s) + 37 vsmm (32 block 1x1s, every conv3 with
     the shortcut fused, 4 projections, the head) per wave.
   Each path must run the stem body exactly once a wave (the wrappers'
   ``stem_launches``; an int8 path its int8 twin), and every launch of an
   int8 path must be of an int8 branch (``int8_launches``), none of an
   f32 path.
   Every request must be delivered, finite, bit-equal to an eager
   ``net_apply`` with the path's impl on the same batches, and equal to a
   direct ``net_apply(impl="plain")`` on the card within 1e-5 (f32) or
   bit for bit (int8).  Every path then serves its traffic 5 more times,
   warm (no capture, one replay a wave): images/s and ms per wave.
   Partial waves (`bucket_mix_phase`, ResNet-18 halo f32 and int8): with
   the counts at 0 again, 4 requests capture a second bucket (batch 4)
   and 12 requests twice replay 8, 4, 8, 4, so two graphs that share one
   memory pool replay out of their capture order; every wave bit-equal
   to eager ``net_apply``, the counts exactly 6 forwards' (the warm-up and
   5 replays).
4. Profile.  One more warm serve of each path under `torch.profiler`:
   the device's busy time and idle share over that serve, and device time
   by kind.  The busy time over the unprofiled warm serve's wall clock is
   printed too, named as the estimate from two serves that it is.  The
   trace must hold device events, and one of each kernel for each launch
   the serve counted: CUPTI reports the kernels inside graph replays, and
   this is what shows that the replays, whose counts the capture
   recorded, ran them.
5. Per-forward breakdown.  Every sparse layer of one batch-8 forward of
   each halo path, and every layer that runs a stack kernel in each stack
   path (every layer of a stack path without a halo twin), is re-run at
   its real input (collected from the forward, FC inputs too; the
   residual is a seeded tensor of the right shape): kernel, plain version
   and the PyTorch library call (cuDNN conv — ``groups=C`` on the
   densified depthwise weight for the depthwise layers — or cuBLAS matmul
   on the densified weight, TF32 off, bias included, residual and ReLU
   not) are timed and checked.  The ``kernels`` line sums these per
   kernel over the layers timed above (a stack path's vsmm layers are its
   halo twin's, where it has one, timed once): ``ms``, ``plain_ms``,
   ``library_ms`` and ``bound_ms`` are per forward at batch 8 (the JSON
   file keeps the sums per path), ``launches`` the counts of the serve
   phases summed over the paths (per path in ``launches_by_path``; warm-ups
   and replays of the first serve, as the device ran them).  The
   ``vsconv_halo`` and ``vsconv_stack`` entries and their ``_int8`` twins
   carry ``stem_body``: the stem layers' share (launches, ms, plain, bound
   and library ms).
   Then the paper's dense-versus-sparse comparison on VGG-16
   (`dense_vs_sparse_phase`): device ms of a batch-8 forward summed over
   its layers at their real inputs, (a) as served (density 0.235, skip
   on), (b) skip off, (c) density 1.0 on the same kernels, skip off, (d)
   the dense net on cuDNN/cuBLAS f32; printed on one line before the
   card's line.
6. Fleet phase (`fleet_phase`, ResNet-50 f32 halo and int8 halo): two
   replicas on the card (`CNNServer(replicas=2)`) bit-identical to one
   with exact counts per replica, a hand-made dispatch of both replicas
   before either is collected, warm images/s at 1 and 2 replicas in
   alternating pairs with each one's idle share, and four fault runs
   (the seeded ``FaultPlan.random(0, replicas=2)``, a ``nan``, a
   ``die_collect``, a ``stall``) held to one outcome a request and to the
   bounds that the wave's size and members set (see `fleet_phase`).
7. The paper's cycle model, the cost model's drift gate and vscheck
   (no new kernel).  `paper_model_phase`: VGG-16's conv inputs at density
   0.235 for one image through the served halo path on the card
   (`collect_conv_traffic`), the cycle model (`core.accel_model`) on the
   config's two 168-PE arrays, printed beside the paper's points and the
   card's dense/sparse ratio of (5); the plain path's activations must
   give the same vscnn cycles within 0.1%.  `calibration_phase`:
   ``calibrate_torch.gate_calibration`` against the committed
   ``src/repro_torch/baselines/CALIB_cuda.json`` (ResNet-18's 21 layers
   re-measured at 224 px, batch 8, through the kernels: the constants'
   round trip exact, the model's features within 2%, each layer's time
   within 4x of its prediction after one machine scale).
   `vscheck_phase`: ``python -m repro_torch.analysis --all-nets --size
   224 --batch 8`` and ``--selftest`` (both must return 0).
8. CLI phase (`cli_phase`): ``python -m repro_torch.launch.serve`` run
   as a user runs it, on ResNet-50 with two replicas under chaos seed 0
   and on Qwen1.5-4B (reduced configs); both must exit 0 and print their
   summary.  Every phase's seconds are printed (``"phase": "seconds"``).
9. LM serve phase.  The port's ``Server(get_config("qwen1.5-4b"),
   batch=8, capacity=552)`` with bf16 weights from seed 0 at full depth
   and width (40 layers, d_model 2560, vocab 151936) serves 16 seeded
   requests (12 prompts of 497-512 tokens with max_new 8-32, 4 of 241-256
   tokens with max_new 16), counts zeroed before and read after: every
   request delivered with max_new tokens in [0, padded_vocab), and the
   flash kernel launched exactly 40 x (lockstep runs + backfills).  Then
   the first run's admitted batch is re-run directly: its admission
   prefill's logits through the kernel against the same prefill through
   `flash_fwd_plain` (with f32 weights within 1e-4 of max|logit|; in bf16
   within 2e-2, or within the spread of two other valid attention
   implementations where that is larger), and a greedy ``prefill`` +
   ``decode_step`` loop (no flash launch in its decode steps) must emit
   exactly the tokens the server delivered.  The server decodes by
   replaying one CUDA graph per (batch, capacity), once a step (checked).
   The traffic is served again warm (prefill seconds per run, decode
   tokens/s, ms per decode step).  Then (`lm_decode_phase`) one replayed
   decode step must equal an eager ``decode_step`` from the same caches
   and position bit for bit, and the step is timed at batch 8 (ms per
   served step, device ms per replay, device operations per step).  The
   traffic is served once more under `torch.profiler` (idle share, device
   time by kind: flash kernel, GEMMs, copies, other), and one batch-8,
   T-512 prefill is broken down into the flash kernel's share (per layer
   x 40: device, plain, library and bound ms) and the rest.  The
   ``kernels`` line's flash entry is per such prefill (40 launches);
   ``launches`` is the sum of the LM serve phases' counts (per arch in
   ``launches_by_path``).
10. LM arch phases (`lm_arch_phase`), one model on the card at a time
   (each server freed, device memory printed before and after).  Bf16
   weights drawn on the card from seed 0, batch 8, 16 new tokens a
   request, at full width: Phi-3-medium, Gemma-3-12B, Granite-MoE-3B and
   RWKV-6-3B at full depth (10 requests in one length bucket: one run, 2
   backfills; Gemma-3's prompts 1100-1600 tokens on an 800 ladder, so its
   1024-windows apply and its circular caches wrap), Jamba-v0.1 (one of
   4 blocks: 8 of 32 layers), Kimi-K2 (the dense stem and 1 MoE layer: 2
   of 61) and Nemotron-4 (2 of 96 layers) on 8 requests.  Each: every
   request delivered in range; flash launches = attention layers x (runs
   + backfills), none for RWKV, every launch at a shape of `flash_phase`
   (whose rows include each arch's admission and backfill prefills);
   one decode graph replayed once a step; a plain greedy loop emits the
   first run's tokens; prefill logits kernel vs plain within the bf16
   noise floor; one replay bit-equal to eager ``decode_step``; ms a
   decode step, ``setup_s``, ``serve_s`` and the idle share of a
   profiled warm serve.  RWKV-6-3B is then served sampled (temperature
   0.8, top-k 40, keys from the reference's threefry) twice: the streams
   must repeat.
11. ``bf16_flow`` (`lm_flow_phase`), on the Qwen serve's weights and
   capacity before they are freed: prefill logits within 2e-2 or the
   Qwen check's bf16 noise floor of the f32-out path's, the traffic
   served (flash 40 x prefills, one decode graph), a replay bit-equal to
   eager, ms and device operations a decode step.
12. The vector-sparse FFN (`LM_SPARSE`, through `lm_arch_phase`):
   Qwen1.5-4B whole (16 requests of 497-512 tokens: one run, 8
   backfills, at the dense Qwen serve's capacity) and Nemotron-4
   (relu2; 2 of 96 layers, 8 requests) with ``use_sparse_ffn=True``, the
   checks of (10), with vsmm launched exactly 3 (gated) or 2 a layer x
   (prefills + decode steps + the decode graph's warm-up), every launch of
   its bf16 branch; the plain path swaps both the flash kernel and vsmm
   for their plain versions (`_plain_kernels`).
13. The embedding-input archs (`frontend_phase`), whole: InternVL2-26B
   (19.3 B parameters, bf16) prefills 8 x 1280 synthetic patch
   embeddings and decodes 3 more, held against `lm_apply` over the whole
   sequence; HuBERT-XLarge's non-causal encoder runs `lm_apply` on 8 x
   1000 frames.  Each: flash launched once an attention layer at a held
   shape; logits through the kernels against their plain versions within
   the bf16 noise floor x 1.25 (or 2e-2) and, on the longest f32 prefix
   of layers that fits, within 1e-4; ms a forward.
14. Training (`train_phase`).  The port's training step
   (`launch.step_builders.build_train`) on Qwen1.5-4B at full width in
   bf16 with its own config (8 x 512 tokens a step in 4 microbatches,
   AdamW, remat per layer), weights drawn on the card from seed 0, whole
   when 16 bytes a parameter fit in the card's free memory (else cut to
   the most layers that fit, printed).  Steps 200-203 (lr > 0), counts
   zeroed before and read after: the flash kernel (under autograd,
   `flash_fwd_trainable`) launched exactly attention layers x
   microbatches x 2 (forward and remat recompute) a step, 320 whole;
   finite losses; every parameter's first-step gradient non-zero (its
   AdamW first moment); the update non-zero.  Printed: ms a step,
   tokens/s, MFU (`model_flops` over the step's time at the card's dense
   bf16 peak), peak allocated memory; one more step profiled (device time
   by kind, idle share).  Then `flash_grad_phase` (at Qwen's training
   attention shape, BH 40, T 512, hd 128: the Function's dq, dk, dv
   against autograd through `flash_fwd_plain`, f32 within 1e-5, bf16
   within 2e-2; the plain backward's device ms), `train_check_phase`
   (one full-width f32 layer: loss and gradient norm with the kernels
   against `_plain_kernels`, within 1e-4) and `train_resume_phase` (a
   reduced-config `TrainLoop` on the card: 4 steps, a checkpoint, a
   fresh loop resumes and takes step 5, equal to an uninterrupted run
   within 1e-5).  The ``kernels`` line's flash entry adds the steps'
   launches (``launches_by_path["train"]``).
15. Dry run (`dryrun_phase`).  (a) `launch.dryrun.run_cell` on meta for
   Qwen1.5-4B at ``train_4k``, ``prefill_32k`` and ``decode_32k`` and
   the sparse-FFN ``decode_32k`` cell, one line each (predictions for
   the H100 row).  (b) Three steps the smoke runs, Qwen1.5-4B whole in
   bf16: the training step (8 x 512, 4 microbatches), the batch-8 decode
   step at capacity 552 (eager) and one batch-8 prefill of 512 tokens
   into capacity 552, each counted on meta and then run on the card
   under the same counter (`utils.cost`): FLOPs, bytes and kernel
   launches by name must be equal, and the card's launch counters must
   move by its count.  (c) For each: the card's peak allocated memory
   against ``arg_bytes + temp_bytes`` of the meta count (within 15%),
   and one more run profiled: its device-busy ms against ``compute_s``
   and ``memory_s`` (busy must be at least ``compute_s``), and busy /
   max of the two.  (d) The same three steps as rank 0 of a one-rank
   1x1 mesh (`dryrun_mesh_phase`): counted on meta in a fake world
   (`launch.mesh.fake_world`) and on the card in a one-rank NCCL world,
   with equal FLOPs, bytes and launches by name and no wire byte on
   either side (``dryrun_mesh`` lines).  (e) A reduced Qwen1.5-4B train
   cell as rank 0 of a fake 2x2 world, its wire bytes by kind and by
   mesh dim (a ``dryrun_fake_world`` line).  The kernels' launches in
   (b) and (d) join the ``kernels`` line's ``launches_by_path``
   (``dryrun``).
16. Mesh (`mesh_cnn_phase`, `mesh_kernel_cases`, `mesh_lm_phase`): the
   smoke's own process joins a one-rank NCCL world (`launch.mesh`, a
   ``file://`` store) and serves under a 1x1 ``("data", "model")`` mesh
   (a ``("model",)`` one for the CNN heads) against the mesh-free
   servers of the phases above, in this call: (d) ResNet-50 f32 and
   int8 by `CNNServer(shard_fc=True)`, logits bit-equal, launches equal;
   (e) flash and vsmm at the rank-local shapes of a 2x2 mesh and a
   4-way model dim, each against its plain version (Qwen's ``sp`` query
   slices at their ``q_offset``, Gemma-3's heads / 4, the sparse FFN's
   ``wi`` strip shard and one rank's merged ``wo`` CSR, ResNet-50's head
   a quarter of its strips, f32 and int8); (a) Qwen1.5-4B whole on the
   ``lm`` phase's weights: streams, flash launches and shapes equal,
   prefill logits bit-equal, one decode graph, and decode ms a step and
   prefill s a run in alternating pairs; (b) the sparse-FFN Qwen (8
   layers, full width): every vsmm launch bf16, 3 a layer a forward,
   logits within `LOGITS_RTOL`; (c) Granite-MoE whole: streams equal,
   prefill logits bit-equal.  Any failed check fails the run.  The mesh
   serves' flash launches join ``launches_by_path`` (``mesh ...``).
17. Training under the mesh (`mesh_train_phase`, after `train`, in the
   same one-rank world): Qwen1.5-4B whole in bf16, 8 x 512 tokens a step
   in 4 microbatches, on the 1x1 mesh (params, AdamW state and batch
   DTensors; `build_train` with the mesh's context) against the
   mesh-free step, in two alternating passes of steps 200-201 each
   (`_mesh_train_pass`, the card freed between passes): step 1's loss,
   ce, aux and grad norm bit-equal, the params' fingerprints equal after
   step 2 (every pass the same), 320 flash launches a step on both
   sides (every count set to 0 before a step and read after it); ms a
   step and peak GB on each side.  Then a reduced `TrainLoop(mesh=)`
   saved at step 4 and resumed to 5, bit-equal to an uninterrupted run
   (`mesh_train_resume`); `FlashFwd` at the rank-local shapes of the
   same step on a 2x2 mesh (``sp``: BH 20, 256 queries at q_offset 0
   and 256 against 512 keys; ``heads``: BH 10, T 512; the kernel
   forward against the plain one with bound and SDPA time, dq / dk / dv
   against autograd through plain within 2e-2); `compressed_psum`
   bit-equal to the CPU's (sum, error, codes, scales) and
   `pipeline_apply` on the one rank (`mesh_collectives_phase`).  The
   steps' flash launches join ``launches_by_path`` (``mesh_train``).
   Before the mesh phases `cnn_shim_phase` runs `models.cnn.vgg16_apply`
   on the served VGG-16 against `graph.net_apply`, bit-equal with the
   path's launches (``launches_by_path["cnn.vgg16_apply"]``).
18. The last reference paths (`mesh_conv_phase`, `mesh_conv_cases`,
   `adamw8bit_phase`, `chunked_scan_phase`).  (a) ResNet-50 f32 and
   int8 and MobileNetV1 f32 (halo) served by `CNNServer(shard_fc=True)`
   in the one-rank world with the ``conv`` rule on ``model``: every conv
   entry a DTensor (`graph._sharded_conv` runs them), the same 16
   images as the mesh-free server, logits bit-equal and the same
   launches by kernel (counts set to 0 before the serve and read after:
   ``launches_by_path["mesh-conv ..."]``).  (b) `optim.adamw8bit`: three
   updates of one Qwen1.5-4B layer group's params (full width, bf16) by
   seeded gradients on the 1x1 mesh, against mesh-free on the card and
   against the CPU: codes, scales and params bit-equal.  (c) RWKV-6-3B
   and Jamba at full width, 8 of 32 layers, one training step's loss and
   gradients at T 2048, batch 1, chunked (``scan_chunk`` 256) against
   one chunk of 2048 (``scan_chunk`` 2048) where its meta peak fits:
   loss and gradients bit-equal (fingerprints), ``max_memory_allocated``
   of each, and the dry run's meta peak (arguments + temporaries) within
   15% of the card's.  (d) The rank-local conv rows: ResNet-50's
   sharded 3x3 convs (layer4's, 4 strips) with a quarter of their
   strips, f32 and int8, each against its plain version with its bound
   and cuDNN's time (rows labelled ``mesh conv``).

``kernel_ms``, ``plain_ms`` and ``library_ms`` are device time per call:
a run of calls is captured in one CUDA graph and its replays are timed
with CUDA events, so the host's launch overhead is not in them (the
device's gap between back-to-back launches is).  ``kernel_host_loop_ms``
is the CUDA event time of a host loop of kernel calls, launch overhead
included.  A stack kernel's time does not include building its stack.
Timings do not flush L2 between launches.

``bound_ms`` is max(FLOPs / peak, bytes / HBM bandwidth), with the peaks
of the SKU nvidia-smi names (NVIDIA's datasheet): the fp32 CUDA-core peak,
for the flash kernel on bf16 inputs the dense bf16 tensor-core peak, and
for the int8 branches the dense int8 tensor-core peak (1,979 TOP/s on
the H100 SXM), int8 operands counted at one byte.
Both count the real function: for the CNN kernels FLOPs those of the
stored tiles this run's weights hold (2 * pixels * vc * S per strip for a
depthwise conv), bytes the unpadded NHWC input, the stored tiles, bias and
residual read once and the output written once; the stems' zero-padded
input channels (3 -> 8) and the FC heads' padding columns (1000 -> 1024)
are left out of both.  For the flash kernel, FLOPs are 4 * hd per
unmasked (query, key) pair and bytes q, k, v read once and the output
written once.  For vsmm's bf16 branch, FLOPs are 2 M x the stored tiles'
elements and bytes x, the stored tiles and their ids read once and the
f32 output written once.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

RTOL = 1e-5
BF16_RTOL = 1e-2         # the flash kernel on bf16 inputs: p rounded at
                         # 64-key tiles, not 512-key blocks (flash_phase)
BATCH = 8
SIZE = 224
DENSITY = 0.235          # ResNet-18's pruning point
DW_DENSITY = 0.5         # MobileNetV1's


def _peaks(name: str) -> tuple[float, float, float, float]:
    """fp32 CUDA-core FLOP/s, HBM bytes/s, dense bf16 tensor-core FLOP/s
    and dense int8 tensor-core OP/s of the card: the datasheet table of
    `repro_torch.utils.roofline`."""
    from repro_torch.utils.roofline import card
    try:
        hw = card(name)
    except KeyError as e:
        raise SystemExit(f"chip_smoke: {e.args[0]}") from None
    return hw.f32_flops, hw.hbm_bw, hw.bf16_flops, hw.int8_ops


def _time_ms(fn, reps: int) -> float:
    """CUDA event time per call of a host loop of ``reps`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, replays: int = 3) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    ``replays`` replays of it timed with CUDA events, per call."""
    import torch
    from repro_torch.kernels.capture import no_collection
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _rel_err(y, ref) -> tuple[float, float]:
    """(max|y - ref| / max|ref|, max|y - ref|)."""
    d = float((y.double() - ref.double()).abs().max())
    return d / max(float(ref.double().abs().max()), 1e-30), d


def _check(label: str, y, ref, rtol: float = RTOL) -> float:
    rel, abs_err = _rel_err(y, ref)
    if not rel <= rtol:
        raise SystemExit(f"chip_smoke: {label}: kernel vs plain relative "
                         f"error {rel:.3e} > {rtol}")
    return abs_err


class Timer:
    """Times one layer's kernel, plain version and library call, and
    accumulates sums per kernel and per (path, kernel)."""

    def __init__(self, peak_flops: float, peak_bw: float, int8_peak: float):
        self.peak_flops, self.peak_bw = peak_flops, peak_bw
        self.int8_peak = int8_peak
        self.sums: dict = {}
        self.by_path: dict = {}
        self.max_abs_err: dict = {}

    def run(self, label: str, kernel: str, fk, fp, flib, flops: int,
            nbytes: int, reps: int = 20, rtol: float = RTOL,
            peak_flops: float | None = None, **extra) -> dict:
        """``peak_flops`` overrides the fp32 CUDA-core peak (the bf16
        tensor-core peak for bf16 inputs, the int8 one for int8 inputs).
        ``rtol`` 0 asks for bit equality (the int8 kernels)."""
        import torch
        y_k = fk()
        y_p = fp()
        torch.cuda.synchronize()
        err = _check(label, y_k, y_p, rtol)
        rel, _ = _rel_err(y_k, y_p)
        row = {
            "case": label, "kernel": kernel,
            "kernel_ms": _device_ms(fk, reps),
            "kernel_host_loop_ms": _time_ms(fk, reps),
            "plain_ms": _device_ms(fp, max(2, reps // 4)),
            "library_ms": None if flib is None else _device_ms(flib, reps),
            "flops": flops, "bytes": nbytes,
            "flops_bound_ms": flops / (peak_flops or self.peak_flops) * 1e3,
            "bytes_bound_ms": nbytes / self.peak_bw * 1e3,
            "max_abs_err": err, "rel_err": rel, "rtol": rtol, **extra,
        }
        row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["kernel_over_library"] = (None if row["library_ms"] is None
                                      else row["kernel_ms"] / row["library_ms"])
        self.max_abs_err[kernel] = max(self.max_abs_err.get(kernel, 0.0), err)
        print(json.dumps(row), flush=True)
        return row

    def add(self, path: str, row: dict) -> None:
        """Add a layer's row to its kernel's sums; a stem-body row also to
        ``"<kernel>:stem"``'s."""
        keys = [row["kernel"]]
        if row.get("body") == "stem":
            keys.append(row["kernel"] + ":stem")
        for table in (self.sums, self.by_path.setdefault(path, {})):
            for key in keys:
                self._add(table, key, row)

    @staticmethod
    def _add(table: dict, key: str, row: dict) -> None:
        s = table.setdefault(key, {
            "ms": 0.0, "host_loop_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "flops_bound_ms": 0.0,
            "bytes_bound_ms": 0.0, "layers": 0})
        s["host_loop_ms"] += row["kernel_host_loop_ms"]
        for k in ("flops_bound_ms", "bytes_bound_ms", "plain_ms",
                  "library_ms"):
            s[k] += row[k]
        s["ms"] += row["kernel_ms"]
        s["layers"] += 1
        if "int_mm_ms" in row:  # torch._int_mm, where it took the shape
            s.setdefault("int_mm_ms", 0.0)
            s.setdefault("int_mm_refused_layers", 0)
            if row["int_mm_ms"] is None:
                s["int_mm_refused_layers"] += 1
            else:
                s["int_mm_ms"] += row["int_mm_ms"]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _pruned(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
            density: float):
    """A seeded (kh*kh*cin, cout) f32 weight, balanced-pruned, and its
    tile mask."""
    import numpy as np
    import torch
    from repro_torch.core.pruning import prune_vectors_balanced

    w = (torch.randn(kh * kh * cin, cout, generator=gen)
         * (kh * kh * cin) ** -0.5).numpy()
    if density < 1.0:
        return prune_vectors_balanced(w, density, vk, vn)
    return w, np.ones((w.shape[0] // vk, cout // vn), bool)


def _encode(w, mask, kh: int, cin: int, vk: int, vn: int, device):
    """Encode as the port's sparsify does (cin-major for kh > 1)."""
    import torch
    from repro_torch.core.vector_sparse import conv_cin_major, from_mask

    vs = from_mask(torch.as_tensor(w, device=device), mask, vk, vn)
    return conv_cin_major(vs, cin // vk) if kh > 1 and vk > 1 else vs


def _sparse_weight(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
                   density: float, device):
    """A seeded weight encoded as the port's sparsify does.  ``cin`` is the
    channels per group of a grouped conv; a depthwise tap matrix is
    ``cin=1, vk=1`` (taps stay in ascending order)."""
    w, mask = _pruned(gen, kh, cin, cout, vk, vn, density)
    return _encode(w, mask, kh, cin, vk, vn, device)


def _int8_weight(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
                 density: float, device):
    """As `_sparse_weight`, quantized to int8 as ``sparsify(dtype="int8")``
    does (per-column power-of-two scales of the pruned weight): (the int8
    encoding, the scales on ``device``)."""
    w, mask = _pruned(gen, kh, cin, cout, vk, vn, density)
    return _quantized(w, mask, kh, cin, vk, vn, device)


def _quantized(w, mask, kh: int, cin: int, vk: int, vn: int, device):
    """A pruned weight quantized as ``sparsify(dtype="int8")`` does: (the
    int8 encoding, the per-column power-of-two scales on ``device``)."""
    import torch
    from repro_torch.models.graph import quantize_weights_int8, weight_scales

    s_w = weight_scales(w)
    return (_encode(quantize_weights_int8(w, s_w), mask, kh, cin, vk, vn,
                    device), torch.as_tensor(s_w, device=device))


def _quant_args(timer: Timer, x, quant):
    """The int8 side of a case: with ``quant = (sx, s_w)`` (x and the tiles
    int8) the kernel's kwargs gain the combined scale, the library call
    takes the dequantized input and weight, the bound counts int8
    operations at the int8 peak, the kernel's name gains ``_int8`` and the
    kernel must equal its plain version bit for bit.  Returns (kernel
    kwargs, x for the library, the weight's per-column factor, the peak
    override, the name suffix, the rtol)."""
    if quant is None:
        return {}, x, 1.0, None, "", RTOL
    sx, s_w = quant
    return ({"scale": sx * s_w}, x.float() * sx, s_w, timer.int8_peak,
            "_int8", 0.0)


def _skip_extra(label: str, kernel, reps: int) -> dict:
    """For a case run with the input-side skip off (``kernel(skip)`` calls
    the kernel with ``skip_zero_inputs=skip``): the skip-on output must
    have the skip-off output's bits; both are timed (device ms)."""
    import torch
    y_on, y_off = kernel(True), kernel(False)
    torch.cuda.synchronize()
    if not torch.equal(y_on, y_off):
        raise SystemExit(f"chip_smoke: {label}: skip off differs from skip "
                         f"on (max abs "
                         f"{float((y_on - y_off).abs().max()):.3e})")
    return {"skip_zero_inputs": False, "skip_off_bit_equal_to_on": True,
            "skip_on_ms": _device_ms(lambda: kernel(True), reps)}


def _conv_case(timer: Timer, label: str, x, vs, *, kh: int, stride: int,
               cin_real: int, groups: int = 1, layout: str = "halo",
               bias=None, residual=None, relu: bool = False,
               quant=None, skip: bool = True, reps: int = 20) -> dict:
    """Time a full conv kernel (``layout`` "halo" or "stack") on NHWC ``x``
    against its plain version and cuDNN on the densified (dequantized)
    weight.  ``x`` may carry zero padding channels beyond ``cin_real``;
    the bound counts only the real ones.  ``quant = (sx, s_w)``: x and the
    tiles are int8, the kernel's int8 branch runs, bit-equal to plain.
    ``skip=False``: the kernel runs with the input-side skip off (the row's
    ``kernel_ms``), checked bit-equal to and timed against the skip on
    (`_skip_extra`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels import vsconv as K

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, kh, stride)
    wo, pl, pr = same_pads(w, kh, stride)
    qkw, x_deq, w_scale, peak, suffix, rtol = _quant_args(timer, x, quant)
    if layout == "halo":
        buf = K.build_halo_input(x, kh=kh, kw=kh, stride=stride, vk=vs.vk)
        kernel, plain, name = (K.vsconv_halo_kernel, K.vsconv_plain,
                               "vsconv_halo")
    else:
        buf = K.build_row_tap_stack(x, kh=kh, kw=kh, stride=stride)
        kernel, plain, name = (K.vsconv_stack_kernel, K.vsconv_stack_plain,
                               "vsconv_stack")
    kw = dict(w_out=wo, kh=kh, kw=kh, stride=stride, groups=groups,
              bias=bias, residual=residual, fuse_relu=relu, **qkw)
    x_lib = F.pad(x_deq, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = (decode(vs).float() * w_scale).reshape(kh, kh, c // groups, -1) \
        .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out_numel = n * ho * wo * vs.shape[1]
    real = cin_real / c  # the padding channels' share of every stored tile
    stem = K.use_stem_body(c, vs.vk, groups, kh, kh, vs.vn, stride=stride,
                           int8=quant is not None)
    extra = {} if skip else _skip_extra(
        label, lambda on: kernel(buf, vs, skip_zero_inputs=on, **kw), reps)
    if not stem:  # the generic body's plan; a split must be deterministic
        nb, s_steps, vk, vn = vs.vals.shape
        extra["rows"], extra["splits"] = K.conv_plan(
            n * ho * wo, nb, s_steps, vk, vn, int8=quant is not None)
        if extra["splits"] > 1:
            y1, y2 = (kernel(buf, vs, skip_zero_inputs=skip, **kw)
                      for _ in range(2))
            if not torch.equal(y1, y2):
                raise SystemExit(f"chip_smoke: {label}: two launches of a "
                                 f"split conv differ")
            extra["two_launches_bit_equal"] = True
    return timer.run(
        label, name + suffix,
        lambda: kernel(buf, vs, skip_zero_inputs=skip, **kw),
        lambda: plain(buf, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride, groups=groups),
        flops=round(2 * n * ho * wo * vs.vals.numel() * real),
        nbytes=x.element_size() * n * h * w * cin_real
        + round(_nbytes(vs.vals) * real)
        + _nbytes(vs.idx, bias, residual, qkw.get("scale")) + 4 * out_numel,
        reps=reps, rtol=rtol, peak_flops=peak,
        buffer_bytes=_nbytes(buf), body="stem" if stem else "generic",
        **extra)


def _dw_case(timer: Timer, label: str, x, vs, *, stride: int,
             layout: str = "halo", bias=None, residual=None,
             relu: bool = False, quant=None, skip: bool = True,
             reps: int = 20) -> dict:
    """Time a 3x3 depthwise kernel (``layout`` "halo" or "stack") on NHWC
    ``x`` against its plain version and cuDNN's depthwise conv
    (``groups=C``) on the densified (dequantized) tap matrix; ``quant`` and
    ``skip`` as `_conv_case`'s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels import vsconv as K
    from repro_torch.kernels import vsconv_dw as D

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, 3, stride)
    wo, pl, pr = same_pads(w, 3, stride)
    qkw, x_deq, w_scale, peak, suffix, rtol = _quant_args(timer, x, quant)
    if layout == "halo":
        buf = K.build_halo_input(x, kh=3, kw=3, stride=stride, vk=vs.vn)
        kernel, plain, name = (D.vsconv_dw_halo_kernel, D.vsconv_dw_plain,
                               "vsconv_dw_halo")
    else:
        buf = K.build_row_tap_stack(x, kh=3, kw=3, stride=stride)
        kernel, plain, name = (D.vsconv_dw_stack_kernel,
                               D.vsconv_dw_stack_plain, "vsconv_dw_stack")
    kw = dict(w_out=wo, kh=3, kw=3, stride=stride, bias=bias,
              residual=residual, fuse_relu=relu, **qkw)
    x_lib = F.pad(x_deq, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = (decode(vs).float() * w_scale).reshape(3, 3, 1, c) \
        .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    extra = {} if skip else _skip_extra(
        label, lambda on: kernel(buf, vs, skip_zero_inputs=on, **kw), reps)
    return timer.run(
        label, name + suffix,
        lambda: kernel(buf, vs, skip_zero_inputs=skip, **kw),
        lambda: plain(buf, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride, groups=c),
        flops=2 * n * ho * wo * vs.vals.numel(),
        nbytes=_nbytes(x, vs.vals, vs.idx, bias, residual, qkw.get("scale"))
        + 4 * n * ho * wo * c,
        reps=reps, rtol=rtol, peak_flops=peak,
        buffer_bytes=_nbytes(buf), **extra)


def _int_mm(x, w):
    """torch._int_mm(x, w) (int8 x int8 -> int32, cuBLASLt) as a yardstick:
    (callable, None), or (None, the reason) where it refuses the shape."""
    import torch
    try:
        torch._int_mm(x, w)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0]
    return (lambda: torch._int_mm(x, w)), None


def _mm_case(timer: Timer, label: str, x, vs, *, n_real: int, bias=None,
             residual=None, relu: bool = False, quant=None,
             skip: bool = True, reps: int = 20) -> dict:
    """Time vsmm on (M, K) ``x`` against its plain version and cuBLAS on the
    densified (dequantized) weight.  Output columns past ``n_real`` are the
    zero padding of a remainder strip; the bound counts only the real
    ones.  ``quant`` and ``skip`` as `_conv_case`'s; int8 rows also time
    ``torch._int_mm`` on the densified int8 weight where it takes the
    shape (``int_mm_ms``; else null and ``int_mm_refused``).  Every row
    names the kernel's plan (``rows``, ``splits``: `vsmm_plan`)."""
    import torch
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels.vsmm import vsmm_kernel, vsmm_plain, vsmm_plan

    qkw, x_deq, w_scale, peak, suffix, rtol = _quant_args(timer, x, quant)
    kw = dict(bias=bias, residual=residual, fuse_relu=relu, **qkw)
    w_lib = decode(vs).float() * w_scale
    lib = ((lambda: torch.addmm(bias, x_deq, w_lib)) if bias is not None
           else (lambda: torch.mm(x_deq, w_lib)))
    extra = {} if skip else _skip_extra(
        label, lambda on: vsmm_kernel(x, vs, skip_zero_inputs=on, **kw),
        reps)
    if quant is not None:
        fn, refused = _int_mm(x, decode(vs))
        extra.update(int_mm_ms=None if fn is None else _device_ms(fn, reps),
                     int_mm_refused=refused)
    m, n_enc = x.shape[0], vs.shape[1]
    nb, s_steps, vk, vn = vs.vals.shape
    extra["rows"], extra["splits"] = vsmm_plan(m, nb, s_steps, vk, vn,
                                               quant is not None)
    real = n_real / n_enc  # balanced pruning: every strip holds S tiles
    return timer.run(
        label, "vsmm" + suffix,
        lambda: vsmm_kernel(x, vs, skip_zero_inputs=skip, **kw),
        lambda: vsmm_plain(x, vs, **kw),
        lib,
        flops=round(2 * m * vs.vals.numel() * real),
        nbytes=_nbytes(x, vs.idx) + round(_nbytes(vs.vals) * real)
        + round(_nbytes(bias, residual, qkw.get("scale")) * real)
        + 4 * m * n_real,
        reps=reps, rtol=rtol, peak_flops=peak, **extra)


def kernel_phase(timer: Timer, dev) -> None:
    """Each kernel at the main paths' geometries, without and with the
    epilogue."""
    import torch
    gen = torch.Generator().manual_seed(0)

    def act(*shape, zero_channels: int = 0):
        x = torch.relu(torch.randn(*shape, generator=gen))
        if zero_channels:
            x[..., -zero_channels:] = 0  # a stem's cin padding 3 -> 8
        return x.to(dev)

    def epilogue(n, ho, cout):
        return dict(bias=torch.randn(cout, generator=gen).to(dev),
                    residual=torch.randn(n, ho, ho, cout, generator=gen
                                         ).to(dev), relu=True)

    conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density,
        #             groups, layouts
        ("stem 7x7/s2 224px cin 3->8", 224, 8, 64, 7, 2, 8, 64, 1.0, 1,
         ("halo", "stack")),
        ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY, 1,
         ("halo", "stack")),
        ("3x3/s2 56px 64->128", 56, 64, 128, 3, 2, 32, 128, DENSITY, 1,
         ("halo", "stack")),
        ("3x3/s1 7px 512->512", 7, 512, 512, 3, 1, 32, 128, DENSITY, 1,
         ("halo",)),
        ("3x3/s1 1px 512->512 (32px layer4, Hout<4)", 1, 512, 512, 3, 1, 32,
         128, DENSITY, 1, ("halo",)),
        ("MobileNetV1 stem 3x3/s2 224px cin 3->8 ->32", 224, 8, 32, 3, 2, 8,
         32, 1.0, 1, ("halo", "stack")),
        ("stem 7x7/s2 227px cin 3->8 (Hout 114: ragged 8x16 tiles)", 227, 8,
         64, 7, 2, 8, 64, 1.0, 1, ("halo", "stack")),
        ("grouped 3x3/s1 56px 64->64 groups 4", 56, 64, 64, 3, 1, 16, 16,
         DW_DENSITY, 4, ("halo", "stack")),
    ]
    for (label, h, cin, cout, kh, s, vk, vn, d, groups,
         layouts) in conv_cases:
        vs = _sparse_weight(gen, kh, cin // groups, cout, vk, vn, d, dev)
        zc = 5 if cin == 8 else 0
        x = act(BATCH, h, h, cin, zero_channels=zc)
        ho = -(-h // s)
        epi = epilogue(BATCH, ho, cout)
        for layout in layouts:
            kw = dict(kh=kh, stride=s, cin_real=cin - zc, groups=groups,
                      layout=layout)
            _conv_case(timer, f"{layout} {label}", x, vs, **kw)
            _conv_case(timer, f"{layout} {label} +bias+residual+relu", x, vs,
                       **kw, **epi)
    dw_cases = [  # label, H, C, stride, layouts (MobileNetV1 at 224 px)
        ("dw1 112px C32 s1", 112, 32, 1, ("halo", "stack")),
        ("dw2 112->56px C64 s2", 112, 64, 2, ("halo", "stack")),
        ("dw7 14px C512 s1", 14, 512, 1, ("halo",)),
        ("dw12 14->7px C512 s2", 14, 512, 2, ("halo", "stack")),
        ("dw13 7px C1024 s1", 7, 1024, 1, ("halo",)),
    ]
    for label, h, c, s, layouts in dw_cases:
        vs = _sparse_weight(gen, 3, 1, c, 1, min(c, 128), DW_DENSITY, dev)
        x = act(BATCH, h, h, c)
        epi = epilogue(BATCH, -(-h // s), c)
        for layout in layouts:
            _dw_case(timer, f"{layout} {label}", x, vs, stride=s,
                     layout=layout)
            _dw_case(timer, f"{layout} {label} +bias+residual+relu", x, vs,
                     stride=s, layout=layout, **epi)
    mm_cases = [  # label, M, K, N (encoded), N (real), vk, vn
        ("1x1/s2 projection 56px 64->128", BATCH * 28 * 28, 64, 128, 128, 32,
         128),
        ("FC 512->1000 (1024, NB 8)", BATCH, 512, 1024, 1000, 32, 128),
    ]
    for label, m, k, n_out, n_real, vk, vn in mm_cases:
        vs = _sparse_weight(gen, 1, k, n_out, vk, vn, DENSITY, dev)
        x = act(m, k)
        _mm_case(timer, label, x, vs, n_real=n_real)
        _mm_case(
            timer, label + " +bias+residual+relu", x, vs, n_real=n_real,
            bias=torch.randn(n_out, generator=gen).to(dev),
            residual=torch.randn(m, n_out, generator=gen).to(dev), relu=True)
    vsmm_cases(timer, dev, gen, act)
    generic_cases(timer, dev, gen, act, epilogue)
    int8_kernel_cases(timer, dev, gen, act, epilogue)
    skip_cases(timer, dev, gen, act)


def generic_cases(timer: Timer, dev, gen, act, epilogue) -> None:
    """The generic conv body at the main paths' shapes that its plan cuts
    differently, f32 and int8 (bit-equal), both layouts, without and with
    the epilogue: VGG-16's conv2 (224 px, vn 64: 128-row tiles), conv9
    (28 px: 64-row tiles), conv11 (14 px: 2 chunks a strip) and ResNet-18's
    layer4 (7 px: 9 chunks a strip).  Each row names its plan; a split
    case must give the same bits in two launches (`_conv_case`)."""
    from repro_torch.models.graph import quantize_activations_int8

    cases = [  # label, H, cin, cout, vn
        ("VGG-16 conv2 3x3/s1 224px 64->64", 224, 64, 64, 64),
        ("VGG-16 conv9 3x3/s1 28px 512->512", 28, 512, 512, 128),
        ("VGG-16 conv11 3x3/s1 14px 512->512", 14, 512, 512, 128),
        ("ResNet-18 layer4 3x3/s1 7px 512->512", 7, 512, 512, 128),
    ]
    for label, h, cin, cout, vn in cases:
        w, mask = _pruned(gen, 3, cin, cout, 32, vn, DENSITY)
        vs = _encode(w, mask, 3, cin, 32, vn, dev)
        vs8, s_w = _quantized(w, mask, 3, cin, 32, vn, dev)
        x = act(BATCH, h, h, cin)
        xq, sx = quantize_activations_int8(x)
        epi = epilogue(BATCH, h, cout)
        for tag, xin, w_enc, quant in (("", x, vs, None),
                                       ("int8 ", xq, vs8, (sx, s_w))):
            for layout in ("halo", "stack"):
                kw = dict(kh=3, stride=1, cin_real=cin, layout=layout,
                          quant=quant)
                _conv_case(timer, f"{tag}{layout} {label}", xin, w_enc, **kw)
                _conv_case(timer, f"{tag}{layout} {label} "
                           f"+bias+residual+relu", xin, w_enc, **kw, **epi)


def vsmm_cases(timer: Timer, dev, gen, act) -> None:
    """vsmm at the main paths' shapes that the plan splits or tiles
    widest, f32 and int8 (bit-equal), without and with the epilogue:
    VGG-16's fc1 (8 rows, 16 chunks a strip), MobileNetV1's pw1 (128-row
    tiles), pw13 and head.  Each pruned weight serves both branches (int8:
    quantized as ``sparsify(dtype="int8")`` does)."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    cases = [  # label, M, K, N (encoded), N (real), vn, density
        ("VGG-16 fc1 25088->4096", BATCH, 25088, 4096, 4096, 128, DENSITY),
        ("MobileNetV1 pw1 112px 32->64", BATCH * 112 * 112, 32, 64, 64, 64,
         DW_DENSITY),
        ("MobileNetV1 pw13 7px 1024->1024", BATCH * 7 * 7, 1024, 1024, 1024,
         128, DW_DENSITY),
        ("MobileNetV1 head 1024->1000 (1024, NB 8)", BATCH, 1024, 1024, 1000,
         128, DW_DENSITY),
    ]
    for label, m, k, n_out, n_real, vn, d in cases:
        w, mask = _pruned(gen, 1, k, n_out, 32, vn, d)
        vs8, s_w = _quantized(w, mask, 1, k, 32, vn, dev)
        vs = _encode(w, mask, 1, k, 32, vn, dev)
        del w
        x = act(m, k)
        xq, sx = quantize_activations_int8(x)
        epi = dict(bias=torch.randn(n_out, generator=gen).to(dev),
                   residual=torch.randn(m, n_out, generator=gen).to(dev),
                   relu=True)
        quant = (sx, s_w)
        for tag, xin, w_enc, q in (("", x, vs, None), ("int8 ", xq, vs8,
                                                       quant)):
            _mm_case(timer, f"{tag}{label}", xin, w_enc, n_real=n_real,
                     quant=q)
            _mm_case(timer, f"{tag}{label} +bias+residual+relu", xin, w_enc,
                     n_real=n_real, quant=q, **epi)


def int8_kernel_cases(timer: Timer, dev, gen, act, epilogue) -> None:
    """The int8 branch of each kernel on the main int8 paths, at the f32
    cases' 224 px geometries, in both layouts, without and with the
    epilogue: int8 tiles and activations quantized on the card as the int8
    path does, each kernel bit-equal to its plain version.  The stems run
    the int8 stem body."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density
        ("stem 7x7/s2 224px cin 3->8", 224, 8, 64, 7, 2, 8, 64, 1.0),
        ("MobileNetV1 stem 3x3/s2 224px cin 3->8 ->32", 224, 8, 32, 3, 2, 8,
         32, 1.0),
        ("VGG-16 conv1 3x3/s1 224px cin 3->8 ->64", 224, 8, 64, 3, 1, 8, 64,
         1.0),
        ("stem 7x7/s2 227px cin 3->8 (Hout 114: ragged 8x16 tiles)", 227, 8,
         64, 7, 2, 8, 64, 1.0),
        ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY),
        ("3x3/s2 56px 64->128", 56, 64, 128, 3, 2, 32, 128, DENSITY),
        ("3x3/s1 7px 512->512", 7, 512, 512, 3, 1, 32, 128, DENSITY),
        ("3x3/s1 1px 512->512 (32px layer4, Hout<4)", 1, 512, 512, 3, 1,
         32, 128, DENSITY),
    ]
    for label, h, cin, cout, kh, s, vk, vn, d in conv_cases:
        vs, s_w = _int8_weight(gen, kh, cin, cout, vk, vn, d, dev)
        zc = 5 if cin == 8 else 0
        xq, sx = quantize_activations_int8(
            act(BATCH, h, h, cin, zero_channels=zc))
        epi = epilogue(BATCH, -(-h // s), cout)
        kw = dict(kh=kh, stride=s, cin_real=cin - zc, quant=(sx, s_w))
        for layout in ("halo", "stack"):
            _conv_case(timer, f"int8 {layout} {label}", xq, vs, **kw,
                       layout=layout)
            _conv_case(timer, f"int8 {layout} {label} +bias+residual+relu",
                       xq, vs, **kw, layout=layout, **epi)
    for label, h, c, s in [("dw1 112px C32 s1", 112, 32, 1),
                           ("dw2 112->56px C64 s2", 112, 64, 2),
                           ("dw12 14->7px C512 s2", 14, 512, 2)]:
        vs, s_w = _int8_weight(gen, 3, 1, c, 1, min(c, 128), DW_DENSITY, dev)
        xq, sx = quantize_activations_int8(act(BATCH, h, h, c))
        epi = epilogue(BATCH, -(-h // s), c)
        for layout in ("halo", "stack"):
            _dw_case(timer, f"int8 {layout} {label}", xq, vs, stride=s,
                     quant=(sx, s_w), layout=layout)
            _dw_case(timer, f"int8 {layout} {label} +bias+residual+relu", xq,
                     vs, stride=s, quant=(sx, s_w), layout=layout, **epi)
    for label, m, k, n_out, n_real in [
            ("1x1/s2 projection 56px 64->128", BATCH * 28 * 28, 64, 128, 128),
            ("FC 512->1000 (1024, NB 8)", BATCH, 512, 1024, 1000)]:
        vs, s_w = _int8_weight(gen, 1, k, n_out, 32, 128, DENSITY, dev)
        xq, sx = quantize_activations_int8(act(m, k))
        _mm_case(timer, f"int8 {label}", xq, vs, n_real=n_real,
                 quant=(sx, s_w))
        _mm_case(timer, f"int8 {label} +bias+residual+relu", xq, vs,
                 n_real=n_real, quant=(sx, s_w),
                 bias=torch.randn(n_out, generator=gen).to(dev),
                 residual=torch.randn(m, n_out, generator=gen).to(dev),
                 relu=True)


def skip_cases(timer: Timer, dev, gen, act) -> None:
    """``skip_zero_inputs=False`` in every CNN kernel and branch (f32 and
    int8 generic bodies, the f32 stem body, both layouts, the depthwise
    kernels, vsmm), at main-path geometries with the fused epilogue: the
    input is post-ReLU and its first image (vsmm: its first 32 rows; on
    the split path at MobileNetV1's head, 8 rows, half its K-tiles) is all
    zero, so the skip-on kernel skips whole tiles.  The skip-off output
    must have the skip-on bits (`_skip_extra`) and equal the plain version
    (bit for bit in int8); both are timed."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    def relu_input(*shape, zero_channels: int = 0):
        x = act(*shape, zero_channels=zero_channels)
        x[0 if len(shape) > 2 else slice(0, 32)] = 0
        return x

    def epi(shape, cout):
        return dict(bias=torch.randn(cout, generator=gen).to(dev),
                    residual=torch.randn(*shape, generator=gen).to(dev),
                    relu=True)

    for int8 in (False, True):
        tag = "int8 " if int8 else ""

        def prep(x, vs_f32, args):
            """(x, weight, quant) for the branch."""
            if not int8:
                return x, vs_f32, None
            vs, s_w = _int8_weight(gen, *args, dev)
            xq, sx = quantize_activations_int8(x)
            return xq, vs, (sx, s_w)

        conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density
            ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY),
            ("VGG-16 conv1 3x3/s1 224px cin 3->8 ->64", 224, 8, 64, 3, 1, 8,
             64, 1.0),
        ]
        for label, h, cin, cout, kh, s, vk, vn, d in conv_cases:
            args = (kh, cin, cout, vk, vn, d)
            zc = 5 if cin == 8 else 0
            x, vs, quant = prep(relu_input(BATCH, h, h, cin, zero_channels=zc),
                                _sparse_weight(gen, *args, dev), args)
            ho = -(-h // s)
            for layout in ("halo", "stack"):
                _conv_case(timer, f"skip off {tag}{layout} {label} "
                           f"+bias+residual+relu", x, vs, kh=kh, stride=s,
                           cin_real=cin - zc, layout=layout, quant=quant,
                           skip=False, **epi((BATCH, ho, ho, cout), cout))
        args = (3, 1, 64, 1, 64, DW_DENSITY)
        x, vs, quant = prep(relu_input(BATCH, 112, 112, 64),
                            _sparse_weight(gen, *args, dev), args)
        for layout in ("halo", "stack"):
            _dw_case(timer, f"skip off {tag}{layout} dw2 112->56px C64 s2 "
                     f"+bias+residual+relu", x, vs, stride=2, layout=layout,
                     quant=quant, skip=False, **epi((BATCH, 56, 56, 64), 64))
        m = BATCH * 28 * 28
        args = (1, 64, 128, 32, 128, DENSITY)
        x, vs, quant = prep(relu_input(m, 64),
                            _sparse_weight(gen, *args, dev), args)
        _mm_case(timer, f"skip off {tag}1x1/s2 projection 56px 64->128 "
                 f"+bias+residual+relu", x, vs, n_real=128, quant=quant,
                 skip=False, **epi((m, 128), 128))
        args = (1, 1024, 1024, 32, 128, DW_DENSITY)
        x = act(BATCH, 1024)
        x[:, :512] = 0
        x, vs, quant = prep(x, _sparse_weight(gen, *args, dev), args)
        _mm_case(timer, f"skip off {tag}split MobileNetV1 head 1024->1000 "
                 f"(1024) +bias+residual+relu", x, vs, n_real=1000,
                 quant=quant, skip=False, **epi((BATCH, 1024), 1024))


# The vector-sparse FFN's products at full width (`sparse_mlp_schema`,
# density 0.235, vk 32, vn 128, tp_hint 16; ``wo`` merged over K = F):
# arch, the FFN's label, and the M of a decode step and of a prefill
BF16_FFN_ARCHS = ("qwen1.5-4b", "nemotron-4-340b")
BF16_ROWS = {"qwen1.5-4b": (BATCH, 1024, 4096),
             "nemotron-4-340b": (BATCH, 1024), "pruned": (BATCH, 1024)}


def _bf16_case(timer: Timer, label: str, x, vs, bf16_peak: float,
               reps: int) -> dict:
    """vsmm's bf16 branch on (M, K) bf16 ``x`` with an f32 output (the
    FFN's accumulator) against `vsmm_plain` on the card (relative 1e-5)
    and ``torch.mm`` of bf16 ``x`` and the decoded bf16 weight with an f32
    output; the skip off must give the skip on's bits and the bf16
    output the f32 one's, rounded.  The bound: max(2 M NB S vk vn / the
    bf16 tensor-core peak, (x, the stored tiles, idx and the f32 output
    once) / HBM)."""
    import torch
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels.vsmm import (vsmm_bf16_plan, vsmm_kernel,
                                          vsmm_plain)

    f32 = torch.float32
    y = vsmm_kernel(x, vs, out_dtype=f32)
    off = vsmm_kernel(x, vs, out_dtype=f32, skip_zero_inputs=False)
    yb = vsmm_kernel(x, vs)
    torch.cuda.synchronize()
    if not torch.equal(y, off):
        raise SystemExit(f"chip_smoke: {label}: skip off differs from on")
    if yb.dtype != torch.bfloat16 or not torch.equal(yb, y.to(yb.dtype)):
        raise SystemExit(f"chip_smoke: {label}: the bf16 output is not "
                         f"the f32 output rounded")
    del off, yb
    w = decode(vs)
    m, n = x.shape[0], vs.shape[1]
    nb, s_steps, vk, vn = vs.vals.shape
    rows, splits = vsmm_bf16_plan(m, nb, s_steps, vk, vn)
    extra = {"skip_off_bit_equal_to_on": True,
             "tiling": "decode" if rows <= 32 else "prefill",
             "bf16_out_is_f32_out_rounded": True,
             "skip_off_ms": _device_ms(lambda: vsmm_kernel(
                 x, vs, out_dtype=f32, skip_zero_inputs=False), reps),
             "rows": rows, "splits": splits, "m": m,
             "tiles": [nb, s_steps, vk, vn],
             "distinct_ids": bool((vs.idx != vs.idx[:1]).any())}
    row = timer.run(
        label, "vsmm_bf16", lambda: vsmm_kernel(x, vs, out_dtype=f32),
        lambda: vsmm_plain(x, vs, out_dtype=f32),
        lambda: torch.mm(x, w, out_dtype=f32),
        flops=2 * m * vs.vals.numel(),
        nbytes=_nbytes(x, vs.vals, vs.idx) + 4 * m * n, reps=reps,
        peak_flops=bf16_peak, **extra)
    del w
    torch.cuda.empty_cache()
    return row


def _pad_vk(x, vs, vk_to: int):
    """x (M, KB*vk) and the tiles (NB, S, vk, vn) of ``vs`` padded with
    zeros to vk_to: x (M, KB*vk_to) and tiles (NB, S, vk_to, vn), the same
    product (each padding column of x meets a zero row of a tile)."""
    import torch.nn.functional as F
    from repro_torch.core.vector_sparse import VectorSparse

    m, k = x.shape
    nb, s_steps, vk, vn = vs.vals.shape
    kb = k // vk
    xp = F.pad(x.view(m, kb, vk), (0, vk_to - vk)).reshape(m, kb * vk_to)
    vals = F.pad(vs.vals, (0, 0, 0, vk_to - vk)).contiguous()
    return xp, VectorSparse(vals, vs.idx, (kb * vk_to, vs.shape[1]))


def vk27_staging(wo, *xs) -> dict:
    """Two ways to stage an odd vk's activation rows (2-byte aligned
    only), timed on Qwen1.5-4B's merged ``wo`` (vk 27) at each x's M: the
    kernel's own (``kernel_ms``, twice: before and after; the 16-byte
    units that span each row, shifted into place in shared memory)
    against padding x to vk 32 in the wrapper (``pad_ms``, one ``F.pad``)
    and the kernel on the padded operands, staged by plain 16-byte copies
    (``padded_kernel_ms``; its tiles padded too, so it reads 32/27 of the
    tiles' bytes: an upper bound on a wrapper that pads x alone).  The
    padded product must equal the unpadded one within 1e-5."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.vsmm import vsmm_bf16_plan, vsmm_kernel

    f32 = torch.float32
    nb, s_steps, vk, vn = wo.vals.shape
    out = {"phase": "vk27_staging", "tiles": [nb, s_steps, vk, vn]}
    for x in xs:
        m, k = x.shape
        xp, wp = _pad_vk(x, wo, 32)
        y = vsmm_kernel(x, wo, out_dtype=f32)
        _check(f"vk27 staging M {m}: padded vs the kernel's staging",
               vsmm_kernel(xp, wp, out_dtype=f32), y)
        reps = 20 if m <= 32 else 5
        own = [_device_ms(lambda: vsmm_kernel(x, wo, out_dtype=f32), reps)]
        pad = _device_ms(lambda: F.pad(x.view(m, k // vk, vk),
                                       (0, 32 - vk)), reps)
        padded = _device_ms(lambda: vsmm_kernel(xp, wp, out_dtype=f32), reps)
        own.append(_device_ms(lambda: vsmm_kernel(x, wo, out_dtype=f32),
                              reps))
        row = {"kernel_ms": own, "pad_ms": pad, "padded_kernel_ms": padded,
               "pad_total_ms": pad + padded,
               "plan": list(vsmm_bf16_plan(m, nb, s_steps, vk, vn)),
               "cheaper": ("kernel" if max(own) <= pad + padded
                           else "pad")}
        out[f"M {m}"] = row
        del xp, wp, y
    print(json.dumps(out), flush=True)
    return out


def vsmm_bf16_cases(timer: Timer, dev, bf16_peak: float) -> dict:
    """vsmm's bf16 branch at the sparse FFN's shapes on the card: Qwen1.5-
    4B's ``wi`` (a gate or up product, vn 108) and merged ``wo`` (vk 27),
    Nemotron-4's ``wi`` and merged ``wo``, each at M = 8 (a decode step)
    and 1024 (a prefill), their tiles drawn on the card by the schema's
    laws (the ``vs_idx`` ids, the same in every strip), and one weight
    pruned from a dense random matrix (`prune_vectors_balanced` +
    `from_mask`: ids differing from strip to strip) at both M.  Returns
    the rows by (arch or "pruned", "wi" or "wo merged", M)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import prune_vectors_balanced
    from repro_torch.core.vector_sparse import VectorSparse, from_mask
    from repro_torch.models.layers import init_params
    from repro_torch.models.sparse_lm import (prepare_sparse_mlp,
                                              sparse_mlp_schema)

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    def x_for(m: int, k: int, relu2: bool):
        x = torch.randn(m, k, generator=gen, device=dev)
        return (torch.relu(x) ** 2 if relu2 else x).to(torch.bfloat16)

    for arch in BF16_FFN_ARCHS:
        cfg = dataclasses.replace(get_config(arch), use_sparse_ffn=True)
        ffn = prepare_sparse_mlp(init_params(
            sparse_mlp_schema(cfg, cfg.sparsity), 0, dtype=torch.bfloat16,
            device=dev, draw_on_device=True), cfg)
        gated = ffn["wi_vals"].ndim == 5
        wi = VectorSparse(ffn["wi_vals"][0] if gated else ffn["wi_vals"],
                          ffn["wi_idx"][0] if gated else ffn["wi_idx"],
                          (cfg.d_model, cfg.d_ff))
        wo = VectorSparse(ffn["wo_csr_vals"], ffn["wo_csr_idx"],
                          (cfg.d_ff, cfg.d_model))
        for m in BF16_ROWS[arch]:
            reps = 5 if m * wi.vals.numel() > 1 << 36 else 20
            for name, vs, k, relu2 in (
                    ("wi" + (" (gate)" if gated else ""), wi, cfg.d_model,
                     False),
                    ("wo merged", wo, cfg.d_ff, not gated)):
                label = (f"vsmm bf16 {arch} sparse FFN {name} M {m} "
                         f"{tuple(vs.vals.shape)}")
                rows[(arch, name.split(" (")[0], m)] = _bf16_case(
                    timer, label, x_for(m, k, relu2), vs, bf16_peak, reps)
        if wo.vals.shape[2] % 2:  # Qwen1.5-4B's merged wo: vk 27
            vk27_staging(wo, x_for(BATCH, cfg.d_ff, False),
                         x_for(4096, cfg.d_ff, False))
        del ffn, wi, wo
        torch.cuda.empty_cache()
    k, n, vk, vn = 2560, 6912, 32, 108
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(5))
    pruned, mask = prune_vectors_balanced(w.numpy(), DENSITY, vk, vn)
    vs = from_mask(torch.from_numpy(pruned).to(dev, torch.bfloat16), mask,
                   vk, vn)
    for m in BF16_ROWS["pruned"]:
        label = (f"vsmm bf16 pruned random 2560->6912 vk 32 vn 108 M {m} "
                 f"{tuple(vs.vals.shape)}")
        rows[("pruned", "wi", m)] = _bf16_case(
            timer, label, x_for(m, k, False), vs, bf16_peak, 20)
    return rows


# label, BH, Tq, Tk, hd, causal, window, q_offset, dtype
FLASH_CASES = [
    ("Qwen admission prefill BH 160 T 512 hd 128 causal bf16", 160, 512,
     512, 128, True, None, 0, "bfloat16"),
    ("Qwen admission prefill BH 160 T 512 hd 128 causal f32", 160, 512, 512,
     128, True, None, 0, "float32"),
    ("Qwen backfill prefill BH 160 T 528 hd 128 causal bf16", 160, 528, 528,
     128, True, None, 0, "bfloat16"),
    ("window 1024 BH 32 T 2048 hd 240 causal bf16", 32, 2048, 2048, 240,
     True, 1024, 0, "bfloat16"),
    ("q_offset 512 BH 160 Tq 64 Tk 576 hd 128 causal bf16", 160, 64, 576,
     128, True, None, 512, "bfloat16"),
    ("hd 64 BH 64 T 1024 causal bf16", 64, 1024, 1024, 64, True, None, 0,
     "bfloat16"),
    ("non-causal BH 128 T 512 hd 80 f32", 128, 512, 512, 80, False, None, 0,
     "float32"),
    ("odd length BH 8 T 33 hd 32 causal f32", 8, 33, 33, 32, True, None, 0,
     "float32"),
    # the prefill shapes of `lm_arch_phase`'s serves (batch 8): admission at
    # the length bucket, backfill at cur = bucket + 15, on the 16-ladder
    # (plain attention) or exact (a windowed arch).  Gemma-3's lengths are
    # picked so that the plain version's blocks, the largest divisors of T
    # up to 256 queries and 512 keys, stay large: T 2063, a prime, makes
    # them 1 x 1 and the plain version takes hours
    ("Phi-3 admission prefill BH 320 T 128 hd 128 causal bf16", 320, 128,
     128, 128, True, None, 0, "bfloat16"),
    ("Phi-3 backfill prefill BH 320 T 144 hd 128 causal bf16", 320, 144,
     144, 128, True, None, 0, "bfloat16"),
    ("Gemma-3 local admission prefill BH 128 T 1600 hd 240 window 1024 "
     "bf16", 128, 1600, 1600, 240, True, 1024, 0, "bfloat16"),
    ("Gemma-3 global admission prefill BH 128 T 1600 hd 240 causal bf16",
     128, 1600, 1600, 240, True, None, 0, "bfloat16"),
    ("Gemma-3 local backfill prefill BH 128 T 1615 hd 240 window 1024 bf16",
     128, 1615, 1615, 240, True, 1024, 0, "bfloat16"),
    ("Gemma-3 global backfill prefill BH 128 T 1615 hd 240 causal bf16",
     128, 1615, 1615, 240, True, None, 0, "bfloat16"),
    ("Granite-MoE admission prefill BH 192 T 128 hd 64 causal bf16", 192,
     128, 128, 64, True, None, 0, "bfloat16"),
    ("Granite-MoE backfill prefill BH 192 T 144 hd 64 causal bf16", 192,
     144, 144, 64, True, None, 0, "bfloat16"),
    ("Jamba admission prefill BH 256 T 128 hd 128 causal bf16", 256, 128,
     128, 128, True, None, 0, "bfloat16"),
    ("Kimi-K2 admission prefill BH 512 T 128 hd 112 causal bf16", 512, 128,
     128, 112, True, None, 0, "bfloat16"),
    ("Nemotron-4 admission prefill BH 768 T 128 hd 192 causal bf16", 768,
     128, 128, 192, True, None, 0, "bfloat16"),
    # the embedding-input forwards (`frontend_phase`): InternVL2-26B's 5
    # tiles of 256 patch tokens, HuBERT-XLarge's 20 s of frames, non-causal
    ("InternVL2 prefill BH 384 T 1280 hd 128 causal bf16", 384, 1280, 1280,
     128, True, None, 0, "bfloat16"),
    ("HuBERT encoder BH 128 T 1000 hd 80 non-causal bf16", 128, 1000, 1000,
     80, False, None, 0, "bfloat16"),
]
QWEN_PREFILL_CASE = FLASH_CASES[0][0]


def _attn_mask(tq: int, tk: int, causal: bool, window, q_offset: int, dev):
    """(Tq, Tk) bool, True where query i (at q_offset + i) sees key j."""
    import torch
    qpos = q_offset + torch.arange(tq, device=dev)[:, None]
    kpos = torch.arange(tk, device=dev)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_phase(timer: Timer, dev, bf16_peak: float) -> dict:
    """The flash kernel against its plain version at the LM paths' shapes:
    relative error within 1e-5 of max|y| in f32 and 1e-2 in bf16 (the
    tensor-core body rounds p to bf16 at the running max of its own 64-key
    tiles, the plain version at that of its blocks of up to 512 keys: a
    bf16 ulp of an element here and there), and two launches bit-equal.
    Each row names the body that ran (`kernel_body`).  The
    library call is `scaled_dot_product_attention` with the same mask
    (``is_causal`` where the mask is plain causal, else an explicit mask)
    in the inputs' dtype.  FLOPs count 4 * hd per unmasked (query, key)
    pair; bytes are q, k, v read once and the output written once.  The
    FLOP bound takes the bf16 dense tensor-core peak for bf16 inputs
    (products of bf16 values are exact in a bf16 MMA with f32
    accumulation) and the fp32 CUDA-core peak for f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import (flash_fwd_kernel,
                                           flash_fwd_plain, kernel_body)

    gen = torch.Generator().manual_seed(2)
    rows = {}
    for (label, bh, tq, tk, hd, causal, window, q_offset,
         dtype) in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, hd, generator=gen).to(dev, dt)
                   for t in (tq, tk, tk))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        mask = _attn_mask(tq, tk, causal, window, q_offset, dev)
        pairs = int(mask.sum())
        # (1, BH, T, hd) views: SDPA's fused backends take 4-D inputs
        q4, k4, v4 = q[None], k[None], v[None]
        if causal and window is None and q_offset == 0 and tq == tk:
            lib = lambda q=q4, k=k4, v=v4: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)
        else:
            lib = lambda q=q4, k=k4, v=v4, m=mask: \
                F.scaled_dot_product_attention(q, k, v, attn_mask=m)
        bf16 = dt == torch.bfloat16
        fk = lambda q=q, k=k, v=v, kw=kw: flash_fwd_kernel(q, k, v, **kw)
        if not torch.equal(fk(), fk()):
            raise SystemExit(f"chip_smoke: flash {label}: two launches "
                             f"differ")
        rows[label] = timer.run(
            f"flash {label}", "flash_fwd", fk,
            lambda q=q, k=k, v=v, kw=kw: flash_fwd_plain(q, k, v, **kw),
            lib, flops=4 * bh * pairs * hd,
            nbytes=_nbytes(q, k, v) + q.numel() * q.element_size(),
            reps=10, rtol=BF16_RTOL if bf16 else RTOL,
            peak_flops=bf16_peak if bf16 else None, pairs_per_head=pairs,
            body=kernel_body(dt))
    return rows


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes per entry function from ``nvcc -Xptxas
    -v`` output: {mangled name: {"registers", "spill_stores",
    "spill_loads"}}."""
    usage, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            usage[name] = {"registers": None, "spill_stores": None,
                           "spill_loads": None}
        elif name is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            usage[name]["registers"] = int(m.group(1))
    return usage


def flash_instantiations(log: str) -> list:
    """One row per instantiation of ``flash_fwd.cu``'s two bodies: the
    tensor-core body per padded head dim (``hd``, a multiple of 16), the
    CUDA-core body per ``hd`` range of 32 (its slot count x 32)."""
    rows = []
    for name, use in ptxas_usage(log).items():
        if m := re.search(r"flash_mma_kernelILi(\d+)E", name):
            rows.append({"body": "mma", "hd": int(m.group(1)), **use})
        elif m := re.search(r"flash_simt_kernelIfLi(\d+)E", name):
            rows.append({"body": "simt", "hd": 32 * int(m.group(1)), **use})
    return sorted(rows, key=lambda r: (r["body"], r["hd"]))


def stencil_instantiations(conv_log: str, dw_log: str) -> list:
    """One row per instantiation of the stem bodies (``vsconv.cu``, f32 and
    int8: vn = 32 x NC, C input channels) and of the depthwise bodies
    (``vsconv_dw.cu``: VC, 0 for any runtime vc, and VEC floats a copy),
    with their registers and spill bytes."""
    rows = []
    for name, use in ptxas_usage(conv_log).items():
        if m := re.search(r"vsconv_(halo|stack)_stem_(int8_)?kernel"
                          r"ILi(\d+)ELi(\d+)E", name):
            rows.append({"kernel": f"vsconv_{m.group(1)}_stem"
                                   + ("_int8" if m.group(2) else ""),
                         "vn": 32 * int(m.group(3)), "c": int(m.group(4)),
                         **use})
    for name, use in ptxas_usage(dw_log).items():
        if m := re.search(r"vsconv_dw_(halo|stack)_kernelILi(\d+)ELi(\d+)E",
                          name):
            rows.append({"kernel": f"vsconv_dw_{m.group(1)}",
                         "vc": int(m.group(2)), "vec": int(m.group(3)),
                         **use})
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.capture import wrappers
    return wrappers()


# path -> (config, impl, dtype, requests, launches per wave, stem-body
# launches per wave).  The int8 paths launch the int8 branches only (their
# launches are filed under "<kernel>_int8"); their stems take the int8
# stem body.
PATHS = {
    "resnet18-halo": ("vscnn-resnet18", "auto", None, 16,
                      {"vsconv_halo": 17, "vsmm": 4}, 1),
    "mobilenet_v1-halo": ("vscnn-mobilenet-v1", "auto", None, 16,
                          {"vsconv_halo": 1, "vsconv_dw_halo": 13,
                           "vsmm": 14}, 1),
    "resnet18-int8-halo": ("vscnn-resnet18", "auto", "int8", 16,
                           {"vsconv_halo_int8": 17, "vsmm_int8": 4}, 1),
    "mobilenet_v1-int8-halo": ("vscnn-mobilenet-v1", "auto", "int8", 16,
                               {"vsconv_halo_int8": 1,
                                "vsconv_dw_halo_int8": 13,
                                "vsmm_int8": 14}, 1),
    "mobilenet_v1-stack": ("vscnn-mobilenet-v1", "pallas-stack", None, BATCH,
                           {"vsconv_stack": 1, "vsconv_dw_stack": 13,
                            "vsmm": 14}, 1),
    "resnet18-stack": ("vscnn-resnet18", "pallas-stack", None, BATCH,
                       {"vsconv_stack": 17, "vsmm": 4}, 1),
    "resnet18-int8-stack": ("vscnn-resnet18", "pallas-stack", "int8", BATCH,
                            {"vsconv_stack_int8": 17, "vsmm_int8": 4}, 1),
    "mobilenet_v1-int8-stack": ("vscnn-mobilenet-v1", "pallas-stack", "int8",
                                BATCH, {"vsconv_stack_int8": 1,
                                        "vsconv_dw_stack_int8": 13,
                                        "vsmm_int8": 14}, 1),
    "vgg16-halo": ("vscnn-vgg16", "auto", None, 16,
                   {"vsconv_halo": 13, "vsmm": 3}, 1),
    "vgg16-int8-stack": ("vscnn-vgg16", "pallas-stack", "int8", BATCH,
                         {"vsconv_stack_int8": 13, "vsmm_int8": 3}, 1),
    "resnet34-halo": ("vscnn-resnet34", "auto", None, 16,
                      {"vsconv_halo": 33, "vsmm": 4}, 1),
    "resnet34-int8-halo": ("vscnn-resnet34", "auto", "int8", 16,
                           {"vsconv_halo_int8": 33, "vsmm_int8": 4}, 1),
    "resnet50-halo": ("vscnn-resnet50", "auto", None, 16,
                      {"vsconv_halo": 17, "vsmm": 37}, 1),
    "resnet50-int8-halo": ("vscnn-resnet50", "auto", "int8", 16,
                           {"vsconv_halo_int8": 17, "vsmm_int8": 37}, 1),
}
WARM_SERVES = 5   # warm re-serves of a CNN path's traffic, timed together


def _zero_counters() -> None:
    from repro_torch.kernels.capture import add_counts, counts
    add_counts({k: -n for k, n in counts().items()})


def serve_phase(path: str, dev) -> dict:
    """One path: the port's CNN server answering seeded requests, with
    every kernel's launch count set to 0 just before and read just after.

    The server runs every wave by CUDA-graph replay (`BatchedApply`: one
    graph per shape bucket).  The first wave of a bucket warms the forward
    up eagerly, captures it and replays it: the warm-up's launches ran on
    the device and count, the capture ran nothing and counts nothing
    (`kernels.capture`), and every replay counts the graph's launches.  So
    over a first serve of ``waves`` waves that captured ``graphs`` graphs
    each kernel's count is its launches per wave times (waves + graphs)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import net_apply

    name, impl, dtype, n_req, per_wave, stem_per_wave = PATHS[path]
    int8 = dtype == "int8"
    cfg = get_config(name)
    t0 = time.perf_counter()
    srv = CNNServer(cfg, batch=BATCH, impl=impl, dtype=dtype, seed=0,
                    device=dev)
    setup_s = time.perf_counter() - t0
    apply = srv.backend.apply
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(n_req)]

    def requests():
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]

    reqs = requests()
    counters = _counters()
    stems = [k for k in counters.values() if hasattr(k, "stem_launches")]
    _zero_counters()
    t0 = time.perf_counter()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    suffix = "_int8" if int8 else ""
    launches = {n + suffix: k.launches for n, k in counters.items()
                if k.launches}
    stem_launches = sum(k.stem_launches for k in stems)
    int8_launches = {n: k.int8_launches for n, k in counters.items()
                     if getattr(k, "int8_launches", 0)}

    waves = sum(s["steps"] for s in stats)
    graphs, replays = apply.compiles, apply.replays
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != n_req:
        raise SystemExit(f"chip_smoke: {path}: {len(delivered)}/{n_req} "
                         f"delivered")
    if graphs != 1 or replays != waves:
        raise SystemExit(f"chip_smoke: {path}: {graphs} graphs captured "
                         f"and {replays} replays over {waves} waves, "
                         f"expected 1 and one a wave")
    runs = waves + graphs   # the replays and each graph's warm-up
    expected = {k: v * runs for k, v in per_wave.items()}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {path}: launches {launches} over "
                         f"{waves} waves and {graphs} warm-ups, expected "
                         f"{per_wave} per forward")
    if stem_launches != stem_per_wave * runs:
        raise SystemExit(f"chip_smoke: {path}: the stem body ran "
                         f"{stem_launches} times over {waves} waves and "
                         f"{graphs} warm-ups, expected {stem_per_wave} a "
                         f"forward")
    if int8_launches != ({n: k.launches for n, k in counters.items()
                          if k.launches} if int8 else {}):
        raise SystemExit(f"chip_smoke: {path}: int8 branch launches "
                         f"{int8_launches} of launches {launches}")
    served = np.stack([r.logits for r in reqs])
    if served.shape != (n_req, cfg.num_classes) or \
            not np.isfinite(served).all():
        raise SystemExit(f"chip_smoke: {path}: served logits {served.shape} "
                         f"not finite or of the wrong shape")

    def direct(impl_: str):
        with torch.inference_mode():
            return torch.cat([net_apply(
                srv.net, srv.params,
                torch.from_numpy(np.stack(images[i:i + BATCH])).to(dev),
                sparse=srv.sparse, impl=impl_)
                for i in range(0, n_req, BATCH)]).cpu()

    eager = direct(apply.impl)
    if not np.array_equal(served, eager.numpy()):
        raise SystemExit(f"chip_smoke: {path}: replayed logits differ from "
                         f"eager net_apply(impl={apply.impl!r}) (max abs "
                         f"{_rel_err(torch.from_numpy(served), eager)[1]:.3e})")
    ref = direct("plain")
    rel, abs_err = _rel_err(torch.from_numpy(served), ref)
    if int8 and not np.array_equal(served, ref.numpy()):
        raise SystemExit(f"chip_smoke: {path}: served int8 logits differ "
                         f"from plain net_apply (max abs {abs_err:.3e})")
    if not rel <= RTOL:
        raise SystemExit(f"chip_smoke: {path}: served vs plain net_apply "
                         f"relative error {rel:.3e} > {RTOL}")
    out = {
        "phase": "serve", "path": path, "config": cfg.name, "impl": impl,
        "dtype": dtype or "float32",
        "batch": BATCH, "requests": n_req, "delivered": len(delivered),
        "waves": waves, "graphs": graphs, "replays": replays,
        "launches": launches, "stem_launches": stem_launches,
        "setup_s": setup_s,
        "first_serve_s": serve_s, "first_images_per_s": n_req / serve_s,
        "served_vs_eager_bit_equal": True,
        "served_vs_plain_rel_err": rel,
        "served_vs_plain_bit_equal": bool(np.array_equal(served,
                                                         ref.numpy())),
    }
    # the same traffic again, now warm: steady-state rate, every wave a
    # replay of the captured graph
    t0 = time.perf_counter()
    stats2 = [st for _ in range(WARM_SERVES) for st in srv.serve(requests())]
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / WARM_SERVES
    warm_waves = sum(s["steps"] for s in stats2)
    if apply.compiles != graphs or apply.replays != replays + warm_waves:
        raise SystemExit(f"chip_smoke: {path}: the warm serves captured "
                         f"{apply.compiles - graphs} graphs and replayed "
                         f"{apply.replays - replays} of {warm_waves} waves")
    out.update(
        warm_serve_s=warm_s, warm_images_per_s=n_req / warm_s,
        warm_ms_per_wave=1e3 * sum(s["run_s"] for s in stats2) / warm_waves,
        warm_waves=warm_waves, warm_replays=apply.replays - replays)
    print(json.dumps(out), flush=True)
    return {"srv": srv, "images": images, "launches": launches,
            "stem_launches": stem_launches, "warm_s": warm_s,
            "summary": out}


BUCKET_MIX_PATHS = ("resnet18-halo", "resnet18-int8-halo")


def bucket_mix_phase(path: str, served: dict, dev) -> dict:
    """Partial waves on a served path: two shape buckets whose graphs share
    the instance's memory pool, replayed out of their capture order.  The
    server already holds the bucket of 8 (`serve_phase`); 4 requests
    capture the bucket of 4, then 12 requests twice replay 8, 4, 8, 4.
    Counts are set to 0 just before and read just after: each kernel's
    count is its launches per forward times 6 (the new bucket's warm-up
    and 5 replays).  Every wave's logits must equal eager `net_apply` with
    the path's impl on the same batch, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ImageRequest
    from repro_torch.models.graph import net_apply

    _, _, dtype, _, per_wave, _ = PATHS[path]
    srv, images = served["srv"], served["images"][:12]
    apply = srv.backend.apply
    suffix = "_int8" if dtype == "int8" else ""
    with torch.inference_mode():
        eager = {n: net_apply(
            srv.net, srv.params,
            torch.from_numpy(np.stack(images[i:i + n])).to(dev),
            sparse=srv.sparse, impl=apply.impl).cpu().numpy()
            for i, n in ((0, 8), (8, 4))}
    graphs, replays = apply.compiles, apply.replays
    counters = _counters()
    _zero_counters()
    served_logits = []
    for batch in (images[8:], images, images):
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(batch)]
        srv.serve(reqs)
        served_logits.append(np.stack([r.logits for r in reqs]))
    launches = {n + suffix: k.launches for n, k in counters.items()
                if k.launches}
    new_graphs, new_replays = apply.compiles - graphs, apply.replays - replays
    if (new_graphs, new_replays) != (1, 5):
        raise SystemExit(f"chip_smoke: {path}: partial waves captured "
                         f"{new_graphs} graphs and replayed {new_replays}, "
                         f"expected 1 and 5")
    if launches != {k: v * 6 for k, v in per_wave.items()}:
        raise SystemExit(f"chip_smoke: {path}: partial waves launched "
                         f"{launches}, expected {per_wave} x 6")
    waves = [(served_logits[0], eager[4])] + [
        (y[a:b], eager[b - a]) for y in served_logits[1:]
        for a, b in ((0, 8), (8, 12))]
    if not all(np.array_equal(y, e) for y, e in waves):
        raise SystemExit(f"chip_smoke: {path}: a partial wave's replayed "
                         f"logits differ from eager net_apply")
    out = {"phase": "bucket_mix", "path": path, "buckets": [8, 4],
           "replay_order": [4, 8, 4, 8, 4], "new_graphs": new_graphs,
           "replays": new_replays, "launches": launches,
           "served_vs_eager_bit_equal": True}
    print(json.dumps(out), flush=True)
    return out


FLEET_PATHS = ("resnet50-halo", "resnet50-int8-halo")
FLEET_PAIRS = 3    # alternating (1 replica, 2 replicas) timing pairs
FLEET_FAULT_REQUESTS = 20   # 2.5 waves: partial waves and steals can occur
FLEET_PROFILE_TRIES = 3


def _recording(backends: list, waves: dict) -> None:
    """Make each CNN backend record, per request it dispatches, the wave
    it ran in: ``waves[rid]`` = (the wave's request ids in slot order, its
    padded batch size).  A re-served request keeps its last wave."""
    for be in backends:
        def dispatch(state, slots, _orig=be.dispatch):
            occ, y = _orig(state, slots)
            wave = (tuple(slots[j].rid for j in occ), int(y.shape[0]))
            for j in occ:
                waves[slots[j].rid] = wave
            return occ, y
        be.dispatch = dispatch


def _fleet_counts(path: str, backends: list, stats: list, counters: dict,
                  launches: dict) -> dict:
    """Per replica: one graph, one replay a wave; the launches, summed
    over the replicas, exactly the path's per forward times (waves +
    graphs), every one of an int8 path an int8 launch."""
    _, _, dtype, _, per_wave, stem_per_wave = PATHS[path]
    int8_launches = {n: k.int8_launches for n, k in counters.items()
                     if getattr(k, "int8_launches", 0)}
    if int8_launches != ({n: k.launches for n, k in counters.items()
                          if k.launches} if dtype == "int8" else {}):
        raise SystemExit(f"chip_smoke: {path} fleet: int8 branch launches "
                         f"{int8_launches} of launches {launches}")
    per_replica = []
    for i, be in enumerate(backends):
        waves = sum(s["steps"] for s in stats if s["replica"] == i)
        apply = be.apply
        if apply.compiles != 1 or apply.replays != waves:
            raise SystemExit(f"chip_smoke: {path} fleet: replica {i} "
                             f"captured {apply.compiles} graphs and replayed "
                             f"{apply.replays} over {waves} waves")
        per_replica.append({"waves": waves, "graphs": apply.compiles,
                            "replays": apply.replays})
    runs = sum(r["waves"] + r["graphs"] for r in per_replica)
    if launches != {k: v * runs for k, v in per_wave.items()}:
        raise SystemExit(f"chip_smoke: {path} fleet: launches {launches} "
                         f"over {per_replica}, expected {per_wave} a "
                         f"forward")
    stems = sum(k.stem_launches for k in counters.values()
                if hasattr(k, "stem_launches"))
    if stems != stem_per_wave * runs:
        raise SystemExit(f"chip_smoke: {path} fleet: the stem body ran "
                         f"{stems} times over {runs} forwards")
    return {"per_replica": per_replica, "forwards": runs}


def fleet_phase(path: str, served: dict, dev) -> dict:
    """The replica fleet on one card (`CNNServer(replicas=2)`: a
    `ReplicaGroup` of two backends, each with its own weights and its own
    `BatchedApply`, behind `FleetScheduler`).

    1. With every count at 0, the path's 16 requests: every logit equal,
       bit for bit, to the one-replica server's (same seed, same images);
       per replica one graph and one replay a wave; the launches summed
       over the replicas exactly the path's per forward x (waves +
       graphs).  The fleet dispatches both replicas' waves before it
       collects either.
    2. Dispatch before collect, by hand: replica 0 and replica 1 each
       dispatch a wave of other images, then both are collected; each
       equal to eager `net_apply` on its batch, bit for bit.
    3. Warm images/s at 1 and 2 replicas, alternating, `FLEET_PAIRS`
       pairs of `WARM_SERVES` serves each (a measurement, no pass mark),
       then one profiled serve of each: the device's idle share.  Each
       trace must hold as many events of each kernel as the path's own
       profile did (the same graphs replay the same waves); a short one
       is taken again, up to `FLEET_PROFILE_TRIES` serves, and the run
       fails if every one is short.
    4. Faults, each on fresh `ChaosBackend`s around the two replicas'
       backends, over `FLEET_FAULT_REQUESTS` requests (the path's 16 and
       4 more): ``FaultPlan.random(0, replicas=2)``, one ``nan`` (replica
       0, its first dispatch), one ``die_collect`` (replica 1, its first
       dispatch) and one ``stall`` (replica 0, 2 ticks: the other replica
       steals half its queue, so waves change size).  Each must give
       exactly one terminal outcome a request, one emission a delivered
       request, a drained replica wherever a fault was not transient (a
       stall is not a fault), and delivered logits held against the
       one-replica server's on the same requests.  f32 logits depend on
       the wave's padded size (it sets the kernels' plans): bit for bit
       where it is the same, within 1e-5 relative where not.  int8 logits
       also depend on the wave's members (the activations' per-tensor
       scale is taken over the wave): bit for bit where the members are
       the same.  A request whose wave changed must equal eager
       `net_apply` on the wave it ran in, bit for bit.  The counts of
       such requests and the max |d| against one replica are printed.
    """
    import numpy as np
    import torch
    from repro_torch.launch.faults import ChaosBackend, Fault, FaultPlan
    from repro_torch.launch.scheduler import DRAINED, FleetScheduler
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import net_apply

    name, impl, dtype, n_req, _, _ = PATHS[path]
    int8 = dtype == "int8"
    suffix = "_int8" if int8 else ""
    one = served["srv"]
    images = served["images"]
    cfg = one.cfg
    t0 = time.perf_counter()
    fleet = CNNServer(cfg, batch=BATCH, impl=impl, dtype=dtype, seed=0,
                      replicas=2, device=dev)
    setup_s = time.perf_counter() - t0
    backends = fleet.group.backends
    if len({id(b.apply) for b in backends}) != 2 or \
            backends[0].apply.params["conv1"]["w"].data_ptr() == \
            backends[1].apply.params["conv1"]["w"].data_ptr():
        raise SystemExit(f"chip_smoke: {path} fleet: the replicas share a "
                         f"BatchedApply or weights")

    def requests(ims):
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(ims)]

    # 1. two replicas against one, with exact counts
    ref1 = np.stack([r.logits for r in _serve_one(one, images)])
    counters = _counters()
    _zero_counters()
    reqs = requests(images)
    stats = fleet.serve(reqs)
    torch.cuda.synchronize()
    launches = {n + suffix: k.launches for n, k in counters.items()
                if k.launches}
    if not all(r.outcome is not None and r.outcome.status == "delivered"
               for r in reqs):
        raise SystemExit(f"chip_smoke: {path} fleet: not every request "
                         f"delivered: {fleet.outcomes}")
    got = np.stack([r.logits for r in reqs])
    if not np.array_equal(got, ref1):
        raise SystemExit(f"chip_smoke: {path} fleet: 2 replicas differ from "
                         f"1 (max abs {np.abs(got - ref1).max():.3e})")
    counted = _fleet_counts(path, backends, stats, counters, launches)

    # 2. dispatch before collect, by hand
    rng = np.random.default_rng(7)
    extra = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
             for _ in range(2 * BATCH)]
    waves = [requests(extra[:BATCH]), requests(extra[BATCH:])]
    handles = []
    for be, wave in zip(backends, waves):
        state, _ = be.start(wave, BATCH)
        handles.append((state, be.dispatch(state, wave)))
    for be, wave, (state, h) in zip(backends, waves, handles):
        _, emis = be.collect(state, h, wave)
        with torch.inference_mode():
            eager = net_apply(
                be.apply.net, be.apply.params,
                torch.from_numpy(np.stack([r.image for r in wave])).to(dev),
                sparse=be.apply.sparse, impl=be.apply.impl).cpu().numpy()
        if not np.array_equal(np.stack(emis), eager):
            raise SystemExit(f"chip_smoke: {path} fleet: a wave dispatched "
                             f"before the other replica's was collected "
                             f"differs from eager net_apply")

    # 3. warm images/s at 1 and 2 replicas, alternating
    servers = {1: one, 2: fleet}
    rates: dict = {1: [], 2: []}
    for pair in range(FLEET_PAIRS):
        for n in ((1, 2) if pair % 2 == 0 else (2, 1)):
            t0 = time.perf_counter()
            for _ in range(WARM_SERVES):
                servers[n].serve(requests(images))
            torch.cuda.synchronize()
            rates[n].append(WARM_SERVES * n_req
                            / (time.perf_counter() - t0))
    idle = {}
    expect = served["profile"]["kernel_events_by_kind"]
    for n, srv in servers.items():
        prof = profile_phase(f"{path} x{n} replicas",
                             lambda srv=srv: srv.serve(requests(images)),
                             n_req / float(np.median(rates[n])), int8=int8,
                             expect=expect,
                             tries=FLEET_PROFILE_TRIES)
        idle[n] = {k: prof[k] for k in ("device_idle_share",
                                        "idle_share_est_two_serves",
                                        "device_busy_ms", "wall_ms",
                                        "attempts", "device_margin_us")}

    # 4. faults
    fault_images = images + [rng.standard_normal((SIZE, SIZE, 3)).astype(
        np.float32) for _ in range(FLEET_FAULT_REQUESTS - n_req)]
    ref_waves: dict = {}
    _recording([one.backend], ref_waves)
    ref_reqs = _serve_one(one, fault_images)
    del one.backend.dispatch
    ref = {r.rid: r.logits for r in ref_reqs}
    apply = backends[0].apply

    def eager(wave):
        """Eager `net_apply` on the padded batch a wave ran."""
        rids, nb = wave
        x = np.zeros((nb, SIZE, SIZE, 3), np.float32)
        for i, rid in enumerate(rids):
            x[i] = fault_images[rid]
        with torch.inference_mode():
            return net_apply(apply.net, apply.params,
                             torch.from_numpy(x).to(dev), sparse=apply.sparse,
                             impl=apply.impl).cpu().numpy()

    plans = {
        "random_seed_0": FaultPlan.random(0, replicas=2),
        "nan_r0w1": FaultPlan([Fault("nan", 0, 1)]),
        "die_collect_r1w1": FaultPlan([Fault("die_collect", 1, 1)]),
        "stall_r0w1": FaultPlan([Fault("stall", 0, 1, ticks=2)]),
    }
    faults = {}
    for label, plan in plans.items():
        got_waves: dict = {}
        _recording(backends, got_waves)
        try:
            chaos = [ChaosBackend(b, plan, replica=i)
                     for i, b in enumerate(backends)]
            sched = FleetScheduler(chaos, batch=BATCH)
            reqs = requests(fault_images)
            sched.serve(reqs)
            torch.cuda.synchronize()
        finally:
            for b in backends:
                del b.dispatch
        if set(sched.outcomes) != {r.rid for r in reqs} or \
                any(r.outcome is not sched.outcomes[r.rid] for r in reqs):
            raise SystemExit(f"chip_smoke: {path} {label}: not one terminal "
                             f"outcome a request")
        delivered = [r for r in reqs if r.outcome.status == "delivered"]
        if any(len(r.out) != 1 or r.logits is None for r in delivered):
            raise SystemExit(f"chip_smoke: {path} {label}: a delivered "
                             f"request has {[len(r.out) for r in reqs]} "
                             f"emissions")
        if any(sched.health[e["replica"]] != DRAINED
               for e in sched.fault_events if not e["transient"]):
            raise SystemExit(f"chip_smoke: {path} {label}: health "
                             f"{sched.health} after {sched.fault_events}")
        # f32 depends on the padded size (the kernels' plans), int8 also on
        # the wave's members (the per-tensor activation scale)
        size_changed = [r.rid for r in delivered
                        if got_waves[r.rid][1] != ref_waves[r.rid][1]]
        wave_changed = [r.rid for r in delivered
                        if set(got_waves[r.rid][0])
                        != set(ref_waves[r.rid][0])
                        or got_waves[r.rid][1] != ref_waves[r.rid][1]]
        same = (lambda rid: rid not in wave_changed) if int8 else \
            (lambda rid: rid not in size_changed)
        eagers: dict = {}
        max_d, max_rel = 0.0, 0.0
        for r in delivered:
            d = float(np.abs(r.logits.astype(np.float64)
                             - ref[r.rid]).max())
            rel = d / max(float(np.abs(ref[r.rid]).max()), 1e-30)
            if same(r.rid) and d != 0.0:
                raise SystemExit(f"chip_smoke: {path} {label}: request "
                                 f"{r.rid} (wave {got_waves[r.rid]}, alone "
                                 f"{ref_waves[r.rid]}) differs from the "
                                 f"one-replica server by {d:.3e}")
            if not int8 and rel > RTOL:
                raise SystemExit(f"chip_smoke: {path} {label}: request "
                                 f"{r.rid} relative error {rel:.3e} > {RTOL}")
            if not same(r.rid):
                wave = got_waves[r.rid]
                if wave not in eagers:
                    eagers[wave] = eager(wave)
                if not np.array_equal(r.logits,
                                      eagers[wave][wave[0].index(r.rid)]):
                    raise SystemExit(f"chip_smoke: {path} {label}: request "
                                     f"{r.rid} differs from eager net_apply "
                                     f"on the wave {wave} it ran in")
            max_d, max_rel = max(max_d, d), max(max_rel, rel)
        faults[label] = {
            "plan": plan.describe(), "requests": len(reqs),
            "delivered": len(delivered),
            "refused": sorted({r.outcome.reason for r in reqs
                               if r.outcome.status == "refused"}),
            "health": list(sched.health),
            "fault_events": [(e["wave"], e["replica"], e["fault"])
                             for e in sched.fault_events],
            "injected": [b.injected for b in chaos], "steals": sched.steals,
            "padded_size_changed": len(size_changed),
            "wave_members_changed": len(wave_changed),
            "checked_against_eager_on_own_wave": len(
                [r for r in delivered if not same(r.rid)]),
            "max_abs_diff_vs_one_replica": max_d,
            "max_rel_diff_vs_one_replica": max_rel}
    out = {"phase": "fleet", "path": path, "replicas": 2,
           "setup_s": setup_s, "requests": n_req, "launches": launches,
           **counted, "two_vs_one_bit_equal": True,
           "dispatch_before_collect_bit_equal": True,
           "warm_images_per_s": {str(n): v for n, v in rates.items()},
           "warm_images_per_s_median": {str(n): float(np.median(v))
                                        for n, v in rates.items()},
           "idle": {str(n): v for n, v in idle.items()}, "faults": faults}
    print(json.dumps(out), flush=True)
    return out


def _serve_one(srv, images) -> list:
    from repro_torch.launch.serve import ImageRequest
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
    srv.serve(reqs)
    if not all(r.outcome.status == "delivered" for r in reqs):
        raise SystemExit("chip_smoke: the one-replica server refused a "
                         "request")
    return reqs


CLI_RUNS = {
    "cnn": ["--cnn", "vscnn-resnet50", "--replicas", "2", "--chaos-seed",
            "0"],
    "lm": ["--arch", "qwen1.5-4b", "--requests", "4", "--tokens", "8"],
}


def cli_phase() -> dict:
    """The serve CLI as a user starts it, on the card, in processes of its
    own (``python -m repro_torch.launch.serve``, the reduced configs),
    both started together: ResNet-50 on two replicas under the seeded
    chaos plan, and Qwen1.5-4B with 4 requests of 8 tokens.  Each must
    exit 0 and print its summary line: every request accounted for
    (delivered + refused = 16), and 4 x 8 tokens."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    out = {"phase": "cli"}
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for label, argv in CLI_RUNS.items()}
    done = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            done[label] = (proc.returncode, stdout, stderr,
                           time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label, argv in CLI_RUNS.items():
        rc, text, stderr, secs = done[label]
        if rc != 0:
            raise SystemExit(f"chip_smoke: cli {label} exited {rc}:\n"
                             f"{text}\n{stderr[-4000:]}")
        if label == "cnn":
            m = re.search(r"served (\d+) images in (\d+) lockstep runs, "
                          r"([\d.]+) img/s", text)
            o = re.search(r"outcomes: (\d+) delivered, (\d+) refused", text)
            if m is None or o is None or \
                    int(o.group(1)) + int(o.group(2)) != 16 or \
                    int(m.group(1)) != int(o.group(1)):
                raise SystemExit(f"chip_smoke: cli {label}: summary not "
                                 f"parsed or requests lost:\n{text}")
            row = {"images": int(m.group(1)), "runs": int(m.group(2)),
                   "images_per_s": float(m.group(3)),
                   "delivered": int(o.group(1)), "refused": int(o.group(2))}
        else:
            m = re.search(r"served (\d+) requests in (\d+) lockstep runs: "
                          r"(\d+) tokens, ([\d.]+) tok/s", text)
            if m is None or int(m.group(1)) != 4 or int(m.group(3)) != 32:
                raise SystemExit(f"chip_smoke: cli {label}: summary not "
                                 f"parsed or tokens lost:\n{text}")
            row = {"requests": int(m.group(1)), "runs": int(m.group(2)),
                   "tokens": int(m.group(3)),
                   "decode_tok_s": float(m.group(4))}
        out[label] = {"argv": argv, "seconds": secs, **row,
                      "summary": text.splitlines()[0]}
    print(json.dumps(out), flush=True)
    return out


def _kind(name: str) -> str:
    # a stem body is filed under its kernel, vsmm's phase 2 under vsmm
    m = re.search(r"(vsconv_dw_halo|vsconv_dw_stack|vsconv_halo|"
                  r"vsconv_stack|vsmm|flash_fwd)_(?:stem_)?(int8_|bf16_)?"
                  r"(?:reduce_)?kernel", name)
    if m:
        return m.group(1) + ("_int8" if m.group(2) == "int8_" else "")
    if "flash_mma_kernel" in name or "flash_simt_kernel" in name:
        return "flash_fwd"   # the flash kernel's bf16 and f32 bodies
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if any(key in name for key in ("gemm", "nvjet", "xmma", "cutlass",
                                   "splitK")):
        return "gemm"
    return "other"


def _device_spans(events) -> list:
    """(start us, end us, name) of every device event of a profile."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA)


def _device_time(spans: list) -> tuple[float, dict]:
    """(busy us, the union of the spans' intervals; {name: (device ms,
    events)})."""
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us, by_name


PROFILE_SLACK_S = 0.05   # idle host time at each end of a profile window
SERVE_RANGE = "chip_smoke_serve"   # the profiled serve's `record_function`
PROFILE_TOP = 12   # the kernels of most device time a profile prints


def profile_phase(path: str, serve, warm_s: float, int8: bool = False,
                  expect: dict | None = None, tries: int = 1) -> dict:
    """One more warm serve of the path's traffic (``serve()``) under
    `torch.profiler`: the device's busy time (the union of its kernel and
    copy intervals) against the wall clock of the same serve, and device
    time by kind.  The profiler's own host overhead lengthens the wall
    clock, so that idle share is an upper bound.  The busy time over
    ``warm_s``, the wall clock of an earlier unprofiled serve of the same
    traffic, is printed as an estimate built from two serves.  A trace
    without device events fails the run: the launch counts of a replayed
    graph are the capture's record, and the trace is what shows that the
    device ran them.

    The serve replays CUDA graphs: CUPTI reports each kernel node of a
    replay as a device event of its own, and the busy time is the union of
    those (device events only; ``cudaGraphLaunch`` is a host event,
    counted apart as ``graph_launches``).  The trace must hold at least
    one device event of each kernel for each launch that the wrappers'
    counters gave the serve (a split vsmm or conv launch runs two kernels
    of its kind), ``int8`` naming the int8 branches, and at least the
    events of each kernel in ``expect`` (another profile of the same
    graphs on the same waves).  The profiler keeps only device events
    whose times fall inside its window, so the serve runs between two
    idle `PROFILE_SLACK_S` stretches, and ``device_margin_us`` says how
    far the first and last device events lay inside the serve's own host
    span (negative: outside it, a clock offset).  A short trace is taken
    again, up to ``tries`` serves in all (each shortfall is printed,
    ``profile_short``); the run fails if every one is short."""
    for attempt in range(1, tries + 1):
        out = _profile_once(path, serve, warm_s, int8, expect or {})
        if not out["unseen"]:
            break
        print(json.dumps({"phase": "profile_short", "path": path,
                          "attempt": attempt, "unseen": out["unseen"],
                          "graph_launches": out["graph_launches"],
                          "device_margin_us": out["device_margin_us"]}),
              flush=True)
    else:
        raise SystemExit(f"chip_smoke: {path}: {tries} profiles saw fewer "
                         f"kernel events than needed (events, needed): "
                         f"{out['unseen']}")
    out["attempts"] = attempt
    print(json.dumps(out), flush=True)
    return out


def _profile_once(path: str, serve, warm_s: float, int8: bool,
                  expect: dict) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    counters = _counters()
    before = {n: k.launches for n, k in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SLACK_S)
        t0 = time.perf_counter()
        with record_function(SERVE_RANGE):
            serve()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_SLACK_S)
    suffix = "_int8" if int8 else ""
    launched = {n + suffix: k.launches - before[n]
                for n, k in counters.items() if k.launches != before[n]}
    events = prof.events()
    # the range's device-side annotation spans all of its work: not work
    spans = _device_spans(events)
    annotations = sum(sp[2] == SERVE_RANGE for sp in spans)
    spans = [sp for sp in spans if sp[2] != SERVE_RANGE]
    graph_launches = sum(e.name == "cudaGraphLaunch" for e in events
                         if e.device_type == DeviceType.CPU)
    busy_us, by_name = _device_time(spans)
    by_kind: dict = {}
    events_by_kind: dict = {}
    for name, (ms, n) in by_name.items():
        kind = _kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        events_by_kind[kind] = events_by_kind.get(kind, 0) + n
    need = {k: max(n, expect.get(k, 0)) for k, n in launched.items()}
    unseen = {k: (events_by_kind.get(k, 0), n) for k, n in need.items()
              if events_by_kind.get(k, 0) < n}
    if not spans:
        raise SystemExit(f"chip_smoke: {path}: the profile holds no device "
                         f"event, so it cannot show that the counted "
                         f"launches {launched} ran")
    host = next(e.time_range for e in events
                if e.name == SERVE_RANGE
                and e.device_type == DeviceType.CPU)
    margin = [spans[0][0] - host.start,
              host.end - max(end for _, end, _ in spans)]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    return {"phase": "profile", "path": path, "wall_ms": wall_ms,
           "device_events": len(spans), "graph_launches": graph_launches,
           "launches": launched, "kernel_events_by_kind": events_by_kind,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
           "idle_share_est_two_serves": 1 - busy_us / 1e3 / (warm_s * 1e3),
           "device_ms_by_kind": by_kind, "unseen": unseen,
           "device_margin_us": margin, "annotations_dropped": annotations,
           "top_device_ms": [[name[:120], ms, n] for name, (ms, n) in top]}


LM_CONFIG = "qwen1.5-4b"
LM_BATCH = 8
LM_CAPACITY = 512 + 32 + 8   # the reference main's round_up(512, 16) + 32 + 8
LOGITS_RTOL = 2e-2           # bf16 prefill: kernel path vs plain path...
# ...unless other valid attention implementations (f32 attention with p
# unrounded, SDPA) already put the plain path's logits further apart: the
# bound is then that noise floor (see lm_check_phase)
F32_LOGITS_RTOL = 1e-4       # the same prefill with the weights in f32


def _lm_traffic(vocab: int) -> list:
    """Seeded traffic: 12 prompts of 497-512 tokens (one length bucket)
    with max_new drawn from 8-32, then 4 prompts of 241-256 tokens with
    max_new 16.  The first run admits 8 long prompts, retires the short
    budgets early and backfills from the other 4."""
    import numpy as np
    rng = np.random.default_rng(0)
    long = [(i, rng.integers(0, vocab, int(rng.integers(497, 513)),
                             dtype=np.int32), int(rng.integers(8, 33)))
            for i in range(12)]
    short = [(i, rng.integers(0, vocab, int(rng.integers(241, 257)),
                              dtype=np.int32), 16)
             for i in range(12, 16)]
    return long + short


def _lm_requests(traffic: list) -> list:
    from repro_torch.launch.serve import Request
    return [Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]


def _lm_stats(stats: list) -> dict:
    """A serve's stats, per lockstep run and summed."""
    return {
        "runs": len(stats),
        "prefill_s_per_run": [s["prefill_s"] for s in stats],
        "decode_s_per_run": [s["decode_s"] for s in stats],
        "decode_steps": sum(s["decode_steps"] for s in stats),
        "backfills": sum(s["backfills"] for s in stats),
        "tokens": sum(s["new_tokens"] for s in stats),
        "decode_tok_s": sum(s["new_tokens"] for s in stats)
        / sum(s["decode_s"] for s in stats),
        "ms_per_step_in_runs": 1e3 * sum(s["decode_s"] for s in stats)
        / max(sum(s["decode_steps"] for s in stats), 1),
    }


def lm_serve_phase(dev) -> dict:
    """The port's LM `Server` serving Qwen1.5-4B (full depth and width,
    bf16 weights from seed 0) at batch 8: every launch count set to 0 just
    before the serve and read just after.  Every request must be delivered
    with ``max_new`` tokens in [0, padded_vocab), and the flash kernel
    launched exactly once per layer per prefill: 40 x (lockstep runs +
    backfills), so none in decode steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server

    cfg = get_config(LM_CONFIG)
    t0 = time.perf_counter()
    srv = Server(cfg, batch=LM_BATCH, capacity=LM_CAPACITY, seed=0,
                 device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    traffic = _lm_traffic(cfg.vocab)
    reqs = _lm_requests(traffic)
    counters = _counters()
    _zero_counters()
    t0 = time.perf_counter()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counters.items() if k.launches}

    summary = _lm_stats(stats)
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != len(reqs):
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: {len(delivered)}/"
                         f"{len(reqs)} delivered")
    for r in reqs:
        if len(r.out) != r.max_new or not all(
                isinstance(t, int) and 0 <= t < cfg.padded_vocab
                for t in r.out):
            raise SystemExit(f"chip_smoke: {LM_CONFIG}: request {r.rid} "
                             f"emitted {r.out} for max_new {r.max_new}")
    prefills = summary["runs"] + summary["backfills"]
    expected = {"flash_fwd": cfg.total_layers * prefills}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: launches {launches}, "
                         f"expected {expected} ({summary['runs']} runs + "
                         f"{summary['backfills']} backfills)")
    graphs = srv.backend.graphs
    replays = sum(g.graph.replays for g in graphs.values())
    if list(graphs) != [(LM_BATCH, LM_CAPACITY)] or \
            replays != summary["decode_steps"]:
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: decode graphs "
                         f"{list(graphs)} replayed {replays} times over "
                         f"{summary['decode_steps']} decode steps, expected "
                         f"one graph at (batch, capacity) replayed each step")
    out = {"phase": "serve", "path": LM_CONFIG, "config": cfg.name,
           "layers": cfg.total_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "dtype": cfg.param_dtype, "batch": LM_BATCH,
           "capacity": LM_CAPACITY, "requests": len(reqs),
           "delivered": len(delivered), "launches": launches,
           "decode_graphs": len(graphs), "decode_replays": replays,
           "setup_s": setup_s, "first_serve_s": serve_s, **summary}
    print(json.dumps(out), flush=True)
    return {"srv": srv, "traffic": traffic, "reqs": reqs,
            "launches": launches, "summary": out}


def _plain_kernels():
    """A context in which the LM's kernel calls take their plain versions:
    the flash kernel (`models.attention`; also its autograd Function, so
    a training forward runs the plain version under autograd) and the
    sparse FFN's vsmm (`models.sparse_lm`)."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.flash import flash_fwd_plain
    from repro_torch.kernels.vsmm import vsmm_plain
    from repro_torch.models import attention, sparse_lm

    stack = contextlib.ExitStack()
    for name in ("flash_fwd_kernel", "flash_fwd_trainable"):
        stack.enter_context(mock.patch.object(attention, name,
                                              flash_fwd_plain))
    stack.enter_context(mock.patch.object(sparse_lm, "vsmm_kernel",
                                          vsmm_plain))
    return stack


def _float(t):
    """An f32 copy of a floating tensor; an integer one (a sparse FFN's
    K-tile ids) as it is."""
    return t.float() if t.is_floating_point() else t


def _logits_spread(srv, batch: dict, logits, logits_plain,
                   f32_weights: bool = True, forward=None) -> dict:
    """How far apart other valid attention implementations put the same
    bf16 prefill's logits (relative to max|logit|): the kernel run again
    (determinism); attention in f32 with p unrounded and the output
    rounded to bf16 (the reference's jnp flash); SDPA (with the window's
    mask where a layer has one); and, with ``f32_weights``, the whole
    prefill with the weights in f32, kernel vs plain (a model whose f32
    copy would not fit beside its bf16 weights leaves that out).
    ``forward(params, batch, cfg)`` replaces the prefill (an encoder's
    `lm_apply`)."""
    import dataclasses
    from unittest import mock

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import flash_fwd_plain
    from repro_torch.models import attention, transformer as tfm

    cfg, cap = srv.cfg, srv.capacity
    if forward is None:
        def forward(p, b, c):
            return tfm.prefill(p, b, c, capacity=cap)[0]

    def run(fn=None, params=None, c=cfg):
        params = srv.params if params is None else params
        if fn is None:
            return forward(params, batch, c)
        with mock.patch.object(attention, "flash_fwd_kernel", fn):
            return forward(params, batch, c)

    def f32_attention(q, k, v, **kw):
        return flash_fwd_plain(q.float(), k.float(), v.float(),
                               **kw).to(q.dtype)

    def sdpa(q, k, v, *, causal, window, q_offset):
        assert q_offset == 0
        if window is None:
            return F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=causal)[0]
        mask = _attn_mask(q.shape[1], k.shape[1], causal, window, 0,
                          q.device)
        return F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask)[0]

    out = {
        "kernel_vs_kernel_again": _rel_err(logits, run())[0],
        "plain_vs_f32_attention": _rel_err(logits_plain,
                                           run(f32_attention))[0],
        "plain_vs_sdpa": _rel_err(logits_plain, run(sdpa))[0],
    }
    if not f32_weights:
        return out
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                cache_dtype_str="float32")
    p32 = _tree_map(_float, srv.params)
    kernel32 = run(params=p32, c=cfg32)
    with _plain_kernels():
        plain32 = run(params=p32, c=cfg32)
    out["f32_weights_kernel_vs_plain"] = _rel_err(kernel32, plain32)[0]
    del p32
    torch.cuda.empty_cache()
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


F32_CHECK_MARGIN = 12 << 30  # device bytes left to an f32 prefill's
                             # activations beside its weights
NOISE_FACTOR = 1.25          # an added arch's bf16 bound: 1.25 x the floor


F32_HEAD_COLUMNS = 32768    # vocab columns of the f32 check's head


def _f32_prefix(cfg, params: dict, budget: int, batch: dict):
    """(cfg32, params32, batch32) for an f32 run of ``cfg``'s longest
    prefix of layers, at full width, whose weights in f32 fit in
    ``budget`` bytes; each layer a segment of its own, its weights f32
    copies of the served ones (integer leaves as they are).  The
    embedding keeps only the rows of the batch's ``tokens`` (renumbered),
    and an untied head its first `F32_HEAD_COLUMNS` columns (a tied one is
    the kept rows): an f32 copy of Nemotron-4's two vocab matrices alone
    would take 38 GB.  An embedding-input batch (``embeds``) is taken to
    f32."""
    import dataclasses

    import torch
    from repro_torch.configs.base import Segment

    def nbytes(tree) -> int:
        leaves = []
        _tree_map(leaves.append, tree)
        return sum(4 * t.numel() for t in leaves)

    top = {"final_norm": params["final_norm"]}
    if cfg.embed_inputs:
        rows = torch.unique(batch["tokens"])
        top["embed"] = params["embed"][rows]
    if "out_head" in params:
        top["out_head"] = params["out_head"][:, :F32_HEAD_COLUMNS]
    used = nbytes(top)
    specs, segs = [], []
    order = [(si, r, i, sp) for si, seg in enumerate(cfg.segments)
             for r in range(seg.repeat) for i, sp in enumerate(seg.layers)]
    for si, r, i, sp in order:
        layer = _tree_map(lambda t, r=r: t[r:r + 1],
                          params["segments"][si][f"l{i}"])
        used += nbytes(layer)
        if used > budget:
            break
        specs.append(sp)
        segs.append({"l0": _tree_map(_float, layer)})
    cfg32 = dataclasses.replace(
        cfg, segments=tuple(Segment(1, (sp,)) for sp in specs),
        n_layers=len(specs), param_dtype="float32",
        cache_dtype_str="float32")
    p32 = {k: v.float() for k, v in top.items()}
    p32["segments"] = segs
    if not cfg.embed_inputs:
        return cfg32, p32, {"embeds": batch["embeds"].float()}
    return cfg32, p32, {"tokens": torch.searchsorted(rows, batch["tokens"])}


def _f32_prefix_check(srv, batch: dict, forward=None) -> dict:
    """The admission prefill (or ``forward(params, batch, cfg)``) with
    the weights in f32, kernel vs plain (`_plain_kernels`), on the
    longest prefix of the model's layers whose f32 copy fits on the card
    beside the served bf16 weights (`_f32_prefix`): it must hold at least
    one attention layer (where the model has one), and the logits must
    agree within 1e-4 of max|logit|."""
    import torch
    from repro_torch.models import transformer as tfm

    if forward is None:
        def forward(p, b, c):
            return tfm.prefill(p, b, c, capacity=srv.capacity)[0]
    _free_cuda()
    budget = torch.cuda.mem_get_info()[0] - F32_CHECK_MARGIN
    cfg32, p32, b32 = _f32_prefix(srv.cfg, srv.params, budget, batch)
    attn = _attention_layers(cfg32)
    if _attention_layers(srv.cfg) and not attn:
        raise SystemExit(f"chip_smoke: {srv.cfg.name}: no attention layer "
                         f"fits the f32 check's {budget} bytes")
    logits = forward(p32, b32, cfg32)
    with _plain_kernels():
        plain = forward(p32, b32, cfg32)
    rel = _rel_err(logits, plain)[0]
    del p32, logits, plain
    _free_cuda()
    return {"f32_layers": cfg32.total_layers, "f32_attention_layers": attn,
            "f32_weights_kernel_vs_plain": rel}


def lm_check_phase(srv, reqs: list, dev, path: str = LM_CONFIG,
                   f32_weights: bool = True,
                   floor_factor: float = 1.0) -> dict:
    """The first run's admitted batch (the first bucket, longest prompts
    first, as the scheduler admits it), re-run directly on the card.

    Its admission prefill through the kernels against the same prefill
    through their plain versions (`flash_fwd_plain`, and `vsmm_plain` for
    a sparse FFN: `_plain_kernels`), relative to max|logit|: with the
    weights in
    f32 within 1e-4 (with ``f32_weights`` the whole model, else the
    longest prefix of its layers whose f32 copy fits beside the served
    weights: `_f32_prefix_check`); as served (bf16) within 2e-2 or,
    where two other
    valid attention implementations already differ from the plain path by
    more (`_logits_spread`: on this random-weight 40-layer model any
    bf16 rounding difference grows to about 2e-2), within that noise
    floor times ``floor_factor``.  A greedy `prefill` + `decode_step` loop over the batch must
    emit exactly the tokens the server delivered (lanes are independent:
    same shapes, same kernels).  The loop's decode steps must launch no
    flash kernel; their time per step is taken here (batch 8, one token a
    lane, CUDA-synchronized wall clock)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash import flash_fwd_kernel
    from repro_torch.kernels.vsmm import vsmm_kernel
    from repro_torch.models import transformer as tfm

    be, cfg = srv.backend, srv.cfg
    key = be.bucket_key(reqs[0])
    first = sorted([r for r in reqs if be.bucket_key(r) == key],
                   key=be.sort_key)[:LM_BATCH]
    toks = np.zeros((LM_BATCH, key), np.int64)
    for i, r in enumerate(first):
        toks[i, key - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    logits, caches = tfm.prefill(srv.params, batch, cfg,
                                 capacity=srv.capacity)
    with _plain_kernels():
        n0 = (flash_fwd_kernel.launches, vsmm_kernel.launches)
        logits_plain, _ = tfm.prefill(srv.params, batch, cfg,
                                      capacity=srv.capacity)
        if (flash_fwd_kernel.launches, vsmm_kernel.launches) != n0:
            raise SystemExit("chip_smoke: the plain prefill launched a "
                             "kernel")
    rel, _ = _rel_err(logits, logits_plain)
    spread = _logits_spread(srv, batch, logits, logits_plain, f32_weights)
    if not f32_weights:
        spread.update(_f32_prefix_check(srv, batch))
    floor = max(spread["plain_vs_f32_attention"], spread["plain_vs_sdpa"])
    f32_rel = spread["f32_weights_kernel_vs_plain"]
    print(json.dumps({"phase": "lm_logits_spread", "path": path,
                      "kernel_vs_plain": rel, **spread,
                      "bf16_noise_floor": floor,
                      "floor_factor": floor_factor,
                      "within_2e-2": rel <= 2e-2}), flush=True)
    if not f32_rel <= F32_LOGITS_RTOL:
        raise SystemExit(f"chip_smoke: {path}: f32-weight prefill "
                         f"logits, kernel vs plain, relative error "
                         f"{f32_rel:.3e} > {F32_LOGITS_RTOL}")
    if not rel <= max(LOGITS_RTOL, floor_factor * floor):
        raise SystemExit(f"chip_smoke: {path}: prefill logits, kernel "
                         f"vs plain, relative error {rel:.3e} > "
                         f"{LOGITS_RTOL} and > {floor_factor} x the bf16 "
                         f"noise floor {floor:.3e}")
    steps = max(r.max_new for r in first) - 1
    nxt = torch.argmax(logits, dim=-1)
    emitted = [nxt]
    n0 = flash_fwd_kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, caches = tfm.decode_step(srv.params, caches, nxt[:, None],
                                         key + i, cfg)
        nxt = torch.argmax(logits, dim=-1)
        emitted.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if flash_fwd_kernel.launches != n0:
        raise SystemExit("chip_smoke: a decode step launched the flash "
                         "kernel")
    direct = torch.stack(emitted, dim=1).cpu().numpy()
    bad = [r.rid for j, r in enumerate(first)
           if r.out != direct[j, :r.max_new].tolist()]
    if bad:
        raise SystemExit(f"chip_smoke: {path}: requests {bad} of the "
                         f"first run differ from the direct greedy loop")
    out = {"phase": "lm_check", "path": path,
           "first_run_rids": [r.rid for r in first],
           "prefill_logits_kernel_vs_plain_rel_err": rel,
           "logits_spread": spread,
           "greedy_loop_steps": steps, "greedy_loop_match": True,
           "decode_step_ms": 1e3 * decode_s / steps,
           "decode_tok_s_full_batch": LM_BATCH * steps / decode_s}
    print(json.dumps(out), flush=True)
    return out


def lm_warm_phase(srv, traffic: list) -> dict:
    """The same traffic again, warm: prefill seconds per run, decode
    tokens/s and ms per decode step (backfill prefills inside the runs
    included)."""
    import torch
    t0 = time.perf_counter()
    stats = srv.serve(_lm_requests(traffic))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    out = {"phase": "warm_serve", "path": LM_CONFIG, "warm_serve_s": warm_s,
           **_lm_stats(stats)}
    print(json.dumps(out), flush=True)
    return out


def _decode_weight_bytes(srv) -> int:
    """Bytes of the weights a decode step reads: every parameter but an
    untied embedding table, of which a step gathers one row a lane (a
    MoE layer's every expert: the port's expert product reads them all)."""
    leaves = []
    _tree_map(leaves.append, {k: v for k, v in srv.params.items()
                              if k != "embed" or srv.cfg.tie_embeddings})
    return sum(t.numel() * t.element_size() for t in leaves)


def lm_decode_phase(srv, traffic: list, dev, path: str = LM_CONFIG
                    ) -> dict:
    """The decode step at batch 8, warm, through the server's graph.

    The first 8 long prompts are admitted (`LMBackend.start`, a prefill
    into the backend's caches).  Then one replayed step's logits and
    caches must equal, bit for bit, an eager `decode_step` from copies of
    the same caches at the same tokens and position.  Then: ms per
    `LMBackend.step` (the replay, sampling and the tokens' copy to the
    host; CUDA-synchronized wall clock over 16 steps), device ms per
    replay (CUDA events over 10 replays of the graph at one position),
    and, under `torch.profiler`, the device operations and busy ms of one
    replay (5 replays) and its 15 costliest kernels by name.  The step's
    weight bytes over the card's HBM rate bound it from below
    (`_decode_weight_bytes`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tfm

    be, cfg = srv.backend, srv.cfg
    first = _lm_requests(traffic)[:LM_BATCH]
    state, _ = be.start(first, LM_BATCH)
    g = be.graphs[(LM_BATCH, srv.capacity)]
    pos = state["len"] + state["i"]
    copies = _tree_map(lambda t: t.clone(), state["caches"])
    g.tokens.copy_(state["nxt"])
    g.pos.fill_(pos)
    g.graph.replay()
    eager, copies = tfm.decode_step(srv.params, copies, state["nxt"], pos,
                                    cfg)
    torch.cuda.synchronize()
    if not torch.equal(g.logits, eager):
        raise SystemExit(f"chip_smoke: {path}: a replayed decode "
                         f"step's logits differ from eager decode_step (max "
                         f"abs {_rel_err(g.logits, eager)[1]:.3e})")
    leaves = []
    _tree_map(leaves.append, [state["caches"], copies])
    half = len(leaves) // 2
    if not all(torch.equal(a, b) for a, b in zip(leaves[:half],
                                                  leaves[half:])):
        raise SystemExit(f"chip_smoke: {path}: a replayed decode "
                         f"step's caches differ from eager decode_step's")
    del copies, leaves
    torch.cuda.empty_cache()
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = be.step(state, first)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        g.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            g.graph.replay()
        torch.cuda.synchronize()
    spans = _device_spans(prof.events())
    busy_us, by_name = _device_time(spans)
    by_kind: dict = {}
    for name, (ms, _) in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms / 5
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    weight_bytes = _decode_weight_bytes(srv)
    out = {"phase": "lm_decode", "path": path, "batch": LM_BATCH,
           "capacity": srv.capacity, "position": pos,
           "weight_bytes": weight_bytes,
           "weight_bytes_bound_ms":
               weight_bytes / _peaks(torch.cuda.get_device_name(0))[1] * 1e3,
           "replay_vs_eager_bit_equal": True,
           "step_ms": step_ms, "replay_device_ms": replay_ms,
           "device_ops_per_step": len(spans) / 5 if spans else None,
           "device_busy_ms_per_step": busy_us / 5e3 if spans else None,
           "device_ms_per_step_by_kind": by_kind,
           "top_kernels_per_step": [{"name": name[:120], "ms": ms / 5,
                                     "calls": n / 5}
                                    for name, (ms, n) in top],
           "decode_replays": g.graph.replays}
    print(json.dumps(out), flush=True)
    return out


def prefill_breakdown_phase(srv, flash_row: dict, dev) -> dict:
    """One batch-8, T-512 prefill of the served model: its time (CUDA
    events around a host loop of 3 prefills), the flash kernel's device
    time per layer and per prefill (x layers, from the kernel phase's
    Qwen bf16 case, the same shape), its plain, library and bound times
    likewise, and the rest of the prefill."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm

    cfg = srv.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (LM_BATCH, 512))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    prefill_ms = _time_ms(lambda: tfm.prefill(srv.params, batch, cfg,
                                              capacity=srv.capacity), 3)
    n = cfg.total_layers
    out = {"phase": "prefill_breakdown", "path": LM_CONFIG,
           "batch": LM_BATCH, "T": 512, "layers": n,
           "prefill_ms": prefill_ms,
           "flash_ms_per_layer": flash_row["kernel_ms"],
           "flash_ms_per_prefill": n * flash_row["kernel_ms"],
           "flash_host_loop_ms_per_prefill":
               n * flash_row["kernel_host_loop_ms"],
           "plain_ms_per_prefill": n * flash_row["plain_ms"],
           "library_ms_per_prefill": n * flash_row["library_ms"],
           "bound_ms_per_prefill": n * flash_row["bound_ms"],
           "rest_of_prefill_ms": prefill_ms - n * flash_row["kernel_ms"]}
    print(json.dumps(out), flush=True)
    return out


# name, layers served (None: every layer), requests, prompt lengths
# [lo, hi), length bucket.  Every prompt of an arch falls in one bucket,
# so 10 requests at batch 8 make one lockstep run with 2 backfills.
# Phi-3, Gemma-3, Granite and RWKV-6 are served at full width cut to a
# quarter of their depth (whole, RWKV-6's profiled serve alone took 103 s
# on an H100), so that the smoke keeps its time limit with the mesh
# training phase.
LM_ARCHS = [
    ("phi3-medium-14b", 10, 10, (113, 129), 16),
    ("gemma3-12b", 12, 10, (1100, 1601), 800),
    ("granite-moe-3b-a800m", 8, 10, (113, 129), 16),
    ("rwkv6-3b", 8, 10, (113, 129), 16),
    ("jamba-v0.1-52b", 8, 8, (113, 129), 16),
    ("kimi-k2-1t-a32b", 2, 8, (113, 129), 16),
    ("nemotron-4-340b", 2, 8, (113, 129), 16),
]
# name, layers served, requests, prompt lengths, length bucket, the config
# change, the path's name: the vector-sparse FFN (bf16 tiles, every FFN
# product a vsmm launch) on Qwen1.5-4B whole (16 requests: one run, 8
# backfills; prompts of 497-512 tokens, so capacity, decode position and
# prefill shapes are the dense Qwen serve's) and on Nemotron-4 (relu2)
# cut as in `LM_ARCHS`
LM_SPARSE = [
    ("qwen1.5-4b", None, 16, (497, 513), 16, {"use_sparse_ffn": True},
     "qwen1.5-4b-sparse"),
    ("nemotron-4-340b", 2, 8, (113, 129), 16, {"use_sparse_ffn": True},
     "nemotron-4-340b-sparse"),
]
LM_ARCH_NEW = 16             # new tokens a request
SAMPLED_ARCH = "rwkv6-3b"    # the README's sampled serve
SAMPLING = (0.8, 40)         # its temperature and top-k


def _cut_depth(cfg, layers: int):
    """``cfg`` at full width with its first ``layers`` layers, in the
    reference's order (whole repeats of each segment's layer group)."""
    import dataclasses

    from repro_torch.configs.base import Segment
    segs, left = [], layers
    for seg in cfg.segments:
        n = min(seg.repeat, left // len(seg.layers))
        if n:
            segs.append(Segment(n, seg.layers))
            left -= n * len(seg.layers)
    if left:
        raise SystemExit(f"chip_smoke: {cfg.name}: {layers} layers do not "
                         f"cut at a layer group's end")
    return dataclasses.replace(cfg, segments=tuple(segs), n_layers=layers)


def _attention_layers(cfg) -> int:
    return sum(seg.repeat * sum(sp.mixer == "attn" for sp in seg.layers)
               for seg in cfg.segments)


def _arch_traffic(vocab: int, n: int, lens: tuple, seed: int,
                  sampling: tuple | None = None) -> list:
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    t, k = sampling or (0.0, 0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(
        *lens)), dtype=np.int32), max_new=LM_ARCH_NEW, temperature=t,
        top_k=k) for i in range(n)]


def _flash_shapes() -> set:
    return {case[1:] for case in FLASH_CASES}


def _free_cuda() -> int:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _sparse_ffn_launches(cfg) -> int:
    """vsmm launches of one forward: 3 a gated sparse FFN layer (gate,
    up, the merged wo), 2 a plain one; 0 without the sparse FFN."""
    if not cfg.use_sparse_ffn:
        return 0
    per = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return per * sum(seg.repeat * sum(sp.ffn == "mlp" for sp in seg.layers)
                     for seg in cfg.segments)


def lm_arch_phase(name: str, layers, n_requests: int, lens: tuple,
                  len_bucket: int, dev, change: dict | None = None,
                  path: str | None = None) -> dict:
    """One more LM arch (with the config ``change``, served as ``path``)
    served by the port's `Server` at batch 8, bf16 weights drawn on the
    card from seed 0, at full width (and full depth unless ``layers``
    cuts it), ``n_requests`` seeded greedy requests of 16 new tokens,
    every launch count set to 0 just before the serve and read just
    after.  Every request delivered with 16 tokens in range; the flash
    kernel launched exactly attention layers x (runs + backfills) (none
    for RWKV), every launch at a shape that `flash_phase` held against
    the plain version; one decode graph at (batch, capacity) replayed once
    a step.  With the sparse FFN, vsmm launched exactly
    `_sparse_ffn_launches` x (runs + backfills + decode steps + the
    graph's warm-up), every launch of the bf16 branch.  Then `lm_check_phase` (the
    first run's batch: a plain greedy loop emits the served tokens, the
    prefill logits through the kernel within the bf16 noise floor of the
    plain path's), `lm_decode_phase` (a replay bit-equal to eager
    `decode_step`, logits and caches; ms a step), a warm serve and a
    profiled one (the device's idle share).  For `SAMPLED_ARCH` the
    traffic is served once more at temperature 0.8, top-k 40, twice:
    the sampled streams must repeat.  The server is freed before the
    next arch's is built; device memory is printed before and after."""
    import dataclasses
    from unittest import mock

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.vsmm import vsmm_kernel
    from repro_torch.launch.serve import Server, _round_up
    from repro_torch.models import attention

    cfg = get_config(name)
    if change:
        cfg = dataclasses.replace(cfg, **change)
    path = path or name
    full_layers = cfg.total_layers
    if layers is not None:
        cfg = _cut_depth(cfg, layers)
    mem_before = _free_cuda()
    bucket = _round_up(lens[1] - 1, len_bucket)
    capacity = bucket + 2 * LM_ARCH_NEW + 8
    t0 = time.perf_counter()
    srv = Server(cfg, batch=LM_BATCH, capacity=capacity, seed=0,
                 len_bucket=len_bucket, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem_model = torch.cuda.memory_allocated()
    reqs = _arch_traffic(cfg.vocab, n_requests, lens, seed=1)
    shapes = set()
    real = attention.flash_fwd_kernel

    def spy(q, k, v, *, causal=True, window=None, q_offset=0):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], causal,
                    window, q_offset, str(q.dtype).split(".")[-1]))
        return real(q, k, v, causal=causal, window=window, q_offset=q_offset)

    counters = _counters()
    _zero_counters()
    t0 = time.perf_counter()
    with mock.patch.object(attention, "flash_fwd_kernel", spy):
        stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    bf16_launches = vsmm_kernel.bf16_launches
    summary = _lm_stats(stats)
    bad = [r.rid for r in reqs if r.outcome is None
           or r.outcome.status != "delivered" or len(r.out) != r.max_new
           or not all(0 <= t < cfg.padded_vocab for t in r.out)]
    if bad:
        raise SystemExit(f"chip_smoke: {path}: requests {bad} not delivered "
                         f"with {LM_ARCH_NEW} tokens in range")
    graphs = srv.backend.graphs
    replays = sum(g.graph.replays for g in graphs.values())
    prefills = summary["runs"] + summary["backfills"]
    n_flash = _attention_layers(cfg) * prefills
    expected = {"flash_fwd": n_flash} if n_flash else {}
    n_vsmm = _sparse_ffn_launches(cfg) * (
        prefills + summary["decode_steps"] + len(graphs))
    if n_vsmm:
        expected["vsmm"] = n_vsmm
    if launches != expected or bf16_launches != expected.get("vsmm", 0):
        raise SystemExit(f"chip_smoke: {path}: launches {launches} (vsmm "
                         f"bf16 {bf16_launches}), expected {expected} "
                         f"({summary['runs']} runs + {summary['backfills']} "
                         f"backfills, {summary['decode_steps']} decode "
                         f"steps, {len(graphs)} graph warm-ups)")
    unheld = shapes - _flash_shapes()
    if unheld:
        raise SystemExit(f"chip_smoke: {path}: flash launched at shapes "
                         f"that flash_phase did not check: {unheld}")
    if list(graphs) != [(LM_BATCH, capacity)] or \
            replays != summary["decode_steps"]:
        raise SystemExit(f"chip_smoke: {path}: decode graphs {list(graphs)} "
                         f"replayed {replays} times over "
                         f"{summary['decode_steps']} decode steps")
    traffic = [(r.rid, r.prompt, r.max_new) for r in reqs]
    laps = {}
    t0 = time.perf_counter()
    check = lm_check_phase(srv, reqs, dev, path=path, f32_weights=False,
                           floor_factor=NOISE_FACTOR)
    laps["check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode = lm_decode_phase(srv, traffic, dev, path=path)
    laps["decode_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.serve(_lm_requests(traffic))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prof = profile_phase(path, lambda: srv.serve(_lm_requests(traffic)),
                         warm_s)
    laps["profile_s"] = time.perf_counter() - t0 - warm_s
    t0 = time.perf_counter()
    sampled = None
    if name == SAMPLED_ARCH:
        streams = []
        for _ in range(2):
            sreqs = _arch_traffic(cfg.vocab, n_requests, lens, seed=1,
                                  sampling=SAMPLING)
            srv.serve(sreqs)
            streams.append([r.out for r in sreqs])
        if streams[0] != streams[1] or not all(
                len(o) == LM_ARCH_NEW and all(0 <= t < cfg.padded_vocab
                                              for t in o)
                for o in streams[0]):
            raise SystemExit(f"chip_smoke: {name}: a sampled serve "
                             f"(temperature {SAMPLING[0]}, top-k "
                             f"{SAMPLING[1]}) did not repeat its streams")
        greedy = [r.out for r in reqs]
        sampled = {"temperature": SAMPLING[0], "top_k": SAMPLING[1],
                   "requests": n_requests, "repeated": True,
                   "streams_unlike_greedy": sum(
                       a != b for a, b in zip(streams[0], greedy)),
                   "first_stream": streams[0][0]}
    laps["sampled_s"] = time.perf_counter() - t0
    del srv, stats
    mem_after = _free_cuda()
    out = {"phase": "lm_arch", "path": path, "layers": cfg.total_layers,
           "full_layers": full_layers,
           "reduced": (None if layers is None else
                       f"{cfg.total_layers} of {full_layers} layers, "
                       f"full width"),
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "params": cfg.param_count(), "dtype": cfg.param_dtype,
           "batch": LM_BATCH, "capacity": capacity, "len_bucket": len_bucket,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "requests": len(reqs), "launches": launches,
           "vsmm_bf16_launches": bf16_launches,
           "vsmm_launches_per_forward": _sparse_ffn_launches(cfg),
           "attention_layers": _attention_layers(cfg),
           "flash_shapes": sorted(str(sh) for sh in shapes),
           "decode_graphs": len(graphs), "decode_replays": replays,
           "setup_s": setup_s, "serve_s": serve_s, "warm_serve_s": warm_s,
           "decode_step_ms": decode["step_ms"],
           "decode_replay_device_ms": decode["replay_device_ms"],
           "decode_device_ops_per_step": decode["device_ops_per_step"],
           "decode_weight_bytes": decode["weight_bytes"],
           "decode_weight_bytes_bound_ms": decode["weight_bytes_bound_ms"],
           "prefill_logits_kernel_vs_plain_rel_err":
               check["prefill_logits_kernel_vs_plain_rel_err"],
           "f32_prefix_layers": check["logits_spread"]["f32_layers"],
           "f32_prefix_kernel_vs_plain":
               check["logits_spread"]["f32_weights_kernel_vs_plain"],
           "device_idle_share": prof["device_idle_share"],
           "memory_allocated_before": mem_before,
           "memory_allocated_model": mem_model,
           "memory_allocated_after": mem_after, "sampled": sampled,
           "seconds": laps, **summary}
    print(json.dumps(out), flush=True)
    return out


FLOW_PATH = "qwen1.5-4b-bf16-flow"


def lm_flow_phase(srv, traffic: list, floor: float, dev) -> dict:
    """Qwen1.5-4B with ``bf16_flow=True`` (matmul outputs in the
    activations' dtype) on the served weights, at the Qwen serve's full
    width, depth and capacity: the first run's admitted batch's prefill
    logits against the f32-out path's within 2e-2 or the bf16 noise
    floor ``floor`` of the Qwen serve's check; the traffic served (every
    request delivered, flash launched 40 x (runs + backfills), one decode
    graph replayed once a step); then `lm_decode_phase` (a replay
    bit-equal to eager `decode_step`; ms and device operations a step)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(srv.cfg, bf16_flow=True)
    flow = Server(cfg, batch=LM_BATCH, capacity=srv.capacity, device=dev,
                  params=srv.params)
    reqs = _lm_requests(traffic)
    be = flow.backend
    key = be.bucket_key(reqs[0])
    first = sorted([r for r in reqs if be.bucket_key(r) == key],
                   key=be.sort_key)[:LM_BATCH]
    toks = np.zeros((LM_BATCH, key), np.int64)
    for i, r in enumerate(first):
        toks[i, key - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    f32_out = tfm.prefill(srv.params, batch, srv.cfg,
                          capacity=srv.capacity)[0]
    flowed = tfm.prefill(flow.params, batch, cfg, capacity=srv.capacity)[0]
    rel = _rel_err(flowed, f32_out)[0]
    if not rel <= max(LOGITS_RTOL, floor):
        raise SystemExit(f"chip_smoke: {FLOW_PATH}: prefill logits vs the "
                         f"f32-out path {rel:.3e} > {LOGITS_RTOL} and > the "
                         f"bf16 noise floor {floor:.3e}")
    counters = _counters()
    _zero_counters()
    stats = flow.serve(reqs)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    summary = _lm_stats(stats)
    graphs = flow.backend.graphs
    replays = sum(g.graph.replays for g in graphs.values())
    expected = {"flash_fwd": cfg.total_layers
                * (summary["runs"] + summary["backfills"])}
    bad = [r.rid for r in reqs if r.outcome is None
           or r.outcome.status != "delivered" or len(r.out) != r.max_new]
    if bad or launches != expected or replays != summary["decode_steps"] \
            or len(graphs) != 1:
        raise SystemExit(f"chip_smoke: {FLOW_PATH}: undelivered {bad}, "
                         f"launches {launches} (expected {expected}), "
                         f"{len(graphs)} graphs replayed {replays} times "
                         f"over {summary['decode_steps']} steps")
    decode = lm_decode_phase(flow, traffic, dev, path=FLOW_PATH)
    del flow
    _free_cuda()
    out = {"phase": "lm_flow", "path": FLOW_PATH,
           "prefill_logits_vs_f32_out_rel_err": rel,
           "bit_equal_to_f32_out": bool(torch.equal(flowed, f32_out)),
           "bf16_noise_floor": floor, "launches": launches,
           "decode_step_ms": decode["step_ms"],
           "decode_replay_device_ms": decode["replay_device_ms"],
           "decode_device_ops_per_step": decode["device_ops_per_step"],
           **summary}
    print(json.dumps(out), flush=True)
    return out


# name, batch, sequence (InternVL2: five 448-px tiles of 256 patch
# tokens; HuBERT: 20 s of audio at 50 frames/s), decode steps after it
FRONTENDS = [
    ("internvl2-26b", LM_BATCH, 1280, 3),
    ("hubert-xlarge", LM_BATCH, 1000, 0),
]


def frontend_phase(name: str, batch: int, t: int, steps: int, dev) -> dict:
    """An embedding-input arch whole, at full width and depth, bf16
    weights drawn on the card from seed 0, on `synthetic_embeddings`
    (the reference's frontend stub, drawn on the card), every launch
    count set to 0 just before its forward and read just after: a
    decoder (InternVL2-26B) runs `prefill` on ``t`` positions and
    ``steps`` `decode_step`s on the next embeddings, an encoder
    (HuBERT-XLarge, non-causal) `lm_apply`.  Flash launched once an
    attention layer (none in decode), at a shape `flash_phase` held;
    finite logits of the right shapes.  A decoder's prefill and decode
    logits against `lm_apply` over the whole sequence (the reference's
    serve-consistency check, `tests/test_models_smoke.py`); the
    forward's logits through the kernels against their plain versions,
    within the bf16 noise floor (x 1.25, or 2e-2) and, on the longest
    f32 prefix of the layers that fits, within 1e-4; ms a forward (CUDA
    events over a host loop of 3)."""
    import types
    from unittest import mock

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.threefry import prng_key
    from repro_torch.models import attention, transformer as tfm
    from repro_torch.models.frontend import synthetic_embeddings
    from repro_torch.models.layers import init_params

    cfg = get_config(name)
    mem_before = _free_cuda()
    t0 = time.perf_counter()
    params = init_params(tfm.lm_schema(cfg), 0, dtype=cfg.dtype,
                         device=dev, draw_on_device=True)
    emb = synthetic_embeddings(prng_key(0), batch, t + steps, cfg.d_model,
                               cfg.dtype, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cap = t + steps
    main = {"embeds": emb[:, :t]}

    def forward(p, b, c):
        if c.encoder_only:
            return tfm.lm_apply(p, b, c)
        return tfm.prefill(p, b, c, capacity=cap)[0]

    shapes = set()
    real = attention.flash_fwd_kernel

    def spy(q, k, v, *, causal=True, window=None, q_offset=0):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], causal,
                    window, q_offset, str(q.dtype).split(".")[-1]))
        return real(q, k, v, causal=causal, window=window, q_offset=q_offset)

    counters = _counters()
    _zero_counters()
    dec = []
    with mock.patch.object(attention, "flash_fwd_kernel", spy):
        if cfg.encoder_only:
            logits = tfm.lm_apply(params, main, cfg)
        else:
            logits, caches = tfm.prefill(params, main, cfg, capacity=cap)
            for i in range(steps):
                step, caches = tfm.decode_step(
                    params, caches, emb[:, t + i:t + i + 1], t + i, cfg)
                dec.append(step)
            del caches
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    expected = {"flash_fwd": _attention_layers(cfg)}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {name}: launches {launches}, "
                         f"expected {expected}")
    unheld = shapes - _flash_shapes()
    if unheld:
        raise SystemExit(f"chip_smoke: {name}: flash launched at shapes "
                         f"that flash_phase did not check: {unheld}")
    want = (batch, t, cfg.padded_vocab) if cfg.encoder_only else \
        (batch, cfg.padded_vocab)
    outs = [logits, *dec]
    if tuple(logits.shape) != want or not all(
            bool(torch.isfinite(o).all()) for o in outs):
        raise SystemExit(f"chip_smoke: {name}: logits {tuple(logits.shape)}"
                         f" (expected {want}) or not finite")
    srv = types.SimpleNamespace(cfg=cfg, params=params, capacity=cap)
    with _plain_kernels():
        plain = forward(params, main, cfg)
    rel = _rel_err(logits, plain)[0]
    spread = _logits_spread(srv, main, logits, plain, f32_weights=False,
                            forward=forward)
    spread.update(_f32_prefix_check(srv, main, forward=forward))
    floor = max(spread["plain_vs_f32_attention"], spread["plain_vs_sdpa"])
    bound = max(LOGITS_RTOL, NOISE_FACTOR * floor)
    consistency = None
    if steps:
        full = tfm.lm_apply(params, {"embeds": emb}, cfg)[:, t - 1:]
        consistency = _rel_err(torch.stack(outs, dim=1), full)[0]
        del full
    print(json.dumps({"phase": "lm_logits_spread", "path": name,
                      "kernel_vs_plain": rel, **spread,
                      "bf16_noise_floor": floor,
                      "prefill_decode_vs_lm_apply": consistency}),
          flush=True)
    if not spread["f32_weights_kernel_vs_plain"] <= F32_LOGITS_RTOL:
        raise SystemExit(f"chip_smoke: {name}: f32-weight logits, kernel "
                         f"vs plain, {spread['f32_weights_kernel_vs_plain']:.3e}"
                         f" > {F32_LOGITS_RTOL}")
    if not rel <= bound or not (consistency is None or consistency <= bound):
        raise SystemExit(f"chip_smoke: {name}: logits kernel vs plain "
                         f"{rel:.3e}, prefill + decode vs lm_apply "
                         f"{consistency}: over {bound:.3e} (the bf16 floor "
                         f"{floor:.3e} x {NOISE_FACTOR}, or {LOGITS_RTOL})")
    forward_ms = _time_ms(lambda: forward(params, main, cfg), 3)
    del params, emb, logits, plain, outs, dec, srv
    mem_after = _free_cuda()
    out = {"phase": "frontend", "path": name, "layers": cfg.total_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "dtype": cfg.param_dtype, "batch": batch, "positions": t,
           "decode_steps": steps, "causal": cfg.causal,
           "launches": launches,
           "flash_shapes": sorted(str(sh) for sh in shapes),
           "setup_s": setup_s, "forward_ms": forward_ms,
           "forward": "lm_apply" if cfg.encoder_only else "prefill",
           "logits_kernel_vs_plain_rel_err": rel,
           "bf16_noise_floor": floor,
           "f32_prefix_layers": spread["f32_layers"],
           "f32_prefix_kernel_vs_plain":
               spread["f32_weights_kernel_vs_plain"],
           "prefill_decode_vs_lm_apply_rel_err": consistency,
           "memory_allocated_before": mem_before,
           "memory_allocated_after": mem_after}
    print(json.dumps(out), flush=True)
    return out


TRAIN_CONFIG = "qwen1.5-4b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512   # the config's microbatches=4: 2 rows each
TRAIN_STEP0 = 200                 # the schedule's peak lr (at 0 it is 0)
TRAIN_STEPS = 4                   # timed steps of the main path
TRAIN_BYTES_PER_PARAM = 16        # bf16 param and grad, f32 m, v, accumulator
TRAIN_MARGIN = 12 << 30           # activations, CE logits, update temporaries
TRAIN_RESUME = {"batch": 4, "seq": 32, "steps": 5, "ckpt_at": 4}
FLASH_GRAD_DTYPES = (("float32", RTOL), ("bfloat16", 2e-2))
TRAIN_CHECK_RTOL = 1e-4           # one f32 layer: kernels vs plain


def _train_params(cfg, seed: int, dev):
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params
    return init_params(tfm.lm_schema(cfg), seed, dtype=cfg.dtype,
                       device=dev, draw_on_device=True)


def _train_batch(cfg, batch: int, seq: int, step: int, dev) -> dict:
    import torch
    from repro_torch.data.pipeline import LMBatchSpec, SyntheticLM
    spec = LMBatchSpec(global_batch=batch, seq_len=seq, vocab=cfg.vocab)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in SyntheticLM(spec, seed=0).batch_at(step).items()}


def _train_depth(cfg) -> tuple:
    """``cfg`` whole if 16 bytes a parameter and `TRAIN_MARGIN` fit in the
    card's free memory, else cut to the most layers that fit (printed)."""
    import torch
    free, _ = torch.cuda.mem_get_info()
    need = TRAIN_BYTES_PER_PARAM * cfg.param_count() + TRAIN_MARGIN
    if need <= free:
        return cfg, None
    layers = cfg.total_layers
    while layers > 1 and TRAIN_BYTES_PER_PARAM * _cut_depth(
            cfg, layers).param_count() + TRAIN_MARGIN > free:
        layers -= 1
    print(json.dumps({"phase": "train_cut", "layers": layers,
                      "of": cfg.total_layers, "free_bytes": free,
                      "whole_needs_bytes": need}), flush=True)
    return _cut_depth(cfg, layers), layers


def flash_grad_phase(dev, peak_flops: float, peak_bw: float,
                     bf16_peak: float) -> list:
    """The flash kernel under autograd (`flash_fwd_trainable`) at Qwen's
    training attention shape (a microbatch of 2 rows: BH 2 x 20, T 512,
    hd 128, causal): dq, dk, dv against autograd through `flash_fwd_plain`
    on the same inputs (f32 within 1e-5, bf16 within 2e-2 of max|grad|).
    Timed: the forward (kernel, plain, SDPA; device ms by graph replay)
    beside its bound, the plain backward (`flash_bwd_plain`, the
    yardstick of a CUDA backward to come), and a forward and backward
    under autograd (CUDA events over a host loop) against SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import (flash_bwd_plain, flash_fwd_plain,
                                           flash_fwd_trainable)
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, rtol in FLASH_GRAD_DTYPES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(40, TRAIN_SEQ, 128, generator=gen,
                                   device=dev).to(dt) for _ in range(4))
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        g_plain = torch.autograd.grad(flash_fwd_plain(*a), a, do)
        p = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_fwd_trainable(*p)
        g_fn = torch.autograd.grad(out, p, do)
        torch.cuda.synchronize()
        errs = {}
        for name, x, y in zip("qkv", g_fn, g_plain):
            rel, _ = _rel_err(x.float(), y.float())
            if not rel <= rtol or x.dtype != dt:
                raise SystemExit(f"chip_smoke: flash grad {dtype} d{name}: "
                                 f"Function vs plain relative error "
                                 f"{rel:.3e} > {rtol} ({x.dtype})")
            errs[f"d{name}_rel_err"] = rel
        o = out.detach()
        pairs = 40 * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
        flops_bound = 4 * 128 * pairs / (
            bf16_peak if dt == torch.bfloat16 else peak_flops) * 1e3
        bytes_bound = _nbytes(q, k, v, o) / peak_bw * 1e3
        # (1, BH, T, hd) views: SDPA's fused backends take 4-D inputs
        sdpa = lambda *a: F.scaled_dot_product_attention(
            *(t[None] for t in a), is_causal=True)[0]

        def fwd_bwd(fn):
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*xs), xs, do)
        row = {"phase": "flash_grad", "dtype": dtype, "shape": [40, TRAIN_SEQ,
                                                              128],
               "rtol": rtol, **errs,
               "fwd_kernel_ms": _device_ms(
                   lambda: flash_fwd_trainable(q, k, v), 5),
               "fwd_plain_ms": _device_ms(lambda: flash_fwd_plain(q, k, v),
                                          3),
               "fwd_library_ms": _device_ms(lambda: sdpa(q, k, v), 5),
               "fwd_bound_ms": max(flops_bound, bytes_bound),
               "fwd_bound_by": ("operations" if flops_bound >= bytes_bound
                                else "bytes"),
               "bwd_plain_ms": _device_ms(
                   lambda: flash_bwd_plain(q, k, v, o, do), 5),
               "fwd_bwd_ms": _time_ms(lambda: fwd_bwd(flash_fwd_trainable),
                                      5),
               "fwd_bwd_library_ms": _time_ms(lambda: fwd_bwd(sdpa), 5)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def train_check_phase(dev) -> dict:
    """Qwen1.5-4B at full width cut to one layer, f32 weights from seed 0,
    the first step's microbatch (2 x 512): the loss and every gradient
    with the kernels (the flash kernel under autograd: 2 launches, the
    forward and its remat recompute) against the same with the plain
    versions (`_plain_kernels`: none), within 1e-4 relative (a gradient
    leaf: of its max|g|)."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.step_builders import _grads_of
    from repro_torch.optim.optimizers import global_norm
    cfg = dataclasses.replace(_cut_depth(get_config(TRAIN_CONFIG), 1),
                              param_dtype="float32")
    params = _train_params(cfg, 0, dev)
    n = TRAIN_BATCH // cfg.microbatches
    batch = {k: v[:n] for k, v in _train_batch(
        cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEP0, dev).items()}
    counters = _counters()
    runs = {}
    for name in ("kernels", "plain"):
        _zero_counters()
        with _plain_kernels() if name == "plain" else contextlib.nullcontext():
            loss, _, grads = _grads_of(params, batch, cfg)
        torch.cuda.synchronize()
        runs[name] = (float(loss), grads, float(global_norm(grads)),
                      {k: c.launches for k, c in counters.items()
                       if c.launches})
    (loss_k, g_k, norm_k, n_k), (loss_p, g_p, norm_p, n_p) = \
        runs["kernels"], runs["plain"]
    grad_err = max(_rel_err(a, b)[0] for a, b in zip(g_k, g_p))
    out = {"phase": "train_check", "layers": 1, "dtype": "float32",
           "rows": n, "seq": TRAIN_SEQ, "loss": loss_k, "loss_plain": loss_p,
           "grad_norm": norm_k, "grad_norm_plain": norm_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_norm_rel_err": abs(norm_k - norm_p) / abs(norm_p),
           "grad_rel_err": grad_err, "launches": n_k,
           "launches_plain": n_p, "rtol": TRAIN_CHECK_RTOL}
    print(json.dumps(out), flush=True)
    if n_k != {"flash_fwd": 2} or n_p:
        raise SystemExit(f"chip_smoke: train check: launches {n_k} with "
                         f"the kernels (expected 2 flash), {n_p} plain")
    if not max(out["loss_rel_err"], out["grad_norm_rel_err"],
               grad_err) <= TRAIN_CHECK_RTOL:
        raise SystemExit(f"chip_smoke: train check: kernels vs plain loss "
                         f"{out['loss_rel_err']:.3e}, grad norm "
                         f"{out['grad_norm_rel_err']:.3e}, gradients "
                         f"{grad_err:.3e} > {TRAIN_CHECK_RTOL}")
    del params, runs, g_k, g_p
    _free_cuda()
    return out


def train_resume_phase(dev) -> dict:
    """`TrainLoop` on the card at the reduced Qwen1.5-4B config: 4 steps
    with a checkpoint at the end, a fresh loop that resumes from it and
    takes step 5, against an uninterrupted 5-step run: losses and every
    parameter and optimizer leaf within 1e-5 relative."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop
    from repro_torch.utils.tree import leaves
    cfg = get_config(TRAIN_CONFIG).reduce()
    r = TRAIN_RESUME
    kw = dict(batch=r["batch"], seq=r["seq"], device=dev)
    whole = TrainLoop(cfg, ckpt_dir=None, **kw)
    p_w, s_w, h_w = whole.run(r["steps"], log_every=10 ** 6)
    with tempfile.TemporaryDirectory() as d:
        TrainLoop(cfg, ckpt_dir=d, **kw).run(r["ckpt_at"],
                                              log_every=10 ** 6)
        resumed = TrainLoop(cfg, ckpt_dir=d, **kw)
        p_r, s_r, h_r = resumed.run(r["steps"], log_every=10 ** 6)
    worst = 0.0
    for a, b in zip(leaves(p_r) + leaves(s_r), leaves(p_w) + leaves(s_w)):
        worst = max(worst, _rel_err(a.float(), b.float())[0])
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(h_r, h_w[r["ckpt_at"]:]))
    out = {"phase": "train_resume", "config": f"{TRAIN_CONFIG} reduced",
           **r, "steps_after_resume": len(h_r), "losses": h_w,
           "loss_rel_err": loss_err, "state_rel_err": worst}
    print(json.dumps(out), flush=True)
    if len(h_r) != r["steps"] - r["ckpt_at"] or not (
            loss_err <= RTOL and worst <= RTOL):
        raise SystemExit(f"chip_smoke: train resume: {len(h_r)} steps "
                         f"after the resume, loss {loss_err:.3e}, state "
                         f"{worst:.3e} vs an uninterrupted run (> {RTOL})")
    return out


def train_phase(dev, smi: str, peaks: tuple) -> dict:
    """The port's training step (`step_builders.build_train`) on
    Qwen1.5-4B at full width in bf16 (its config: 8 x 512 tokens a step
    in 4 microbatches, AdamW, remat), weights drawn on the card from seed
    0, whole if its 16 bytes a parameter fit (else cut, printed).  Steps
    200-203 (lr > 0), each timed on its own; every launch count set to 0
    just before them and read just after: the flash kernel launched
    exactly attention layers x microbatches x 2 (forward and remat
    recompute) a step, 320 whole.  Hard checks: finite losses, every
    parameter's first-step gradient non-zero (its AdamW first moment, an
    f32 (1 - b1) x the clipped gradient), the update non-zero.  Printed:
    ms a step, tokens/s, MFU (`model_flops` over the step's seconds x the
    card's dense bf16 peak), peak allocated memory, the card.  Then one
    more step profiled (device time by kind, idle share), the flash
    Function's gradients (`flash_grad_phase`), one f32 layer kernels vs
    plain (`train_check_phase`) and the resume (`train_resume_phase`).
    ``peaks``: the card's fp32, HBM and dense bf16 rates (`_peaks`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import step_builders as sb
    from repro_torch.utils.tree import leaves, leaves_with_path

    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    cfg, cut = _train_depth(get_config(TRAIN_CONFIG))
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    params = _train_params(cfg, 0, dev)
    opt_state = sb.make_optimizer(cfg).init(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step_fn = sb.build_train(cfg, shape)
    batches = [_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEP0 + i,
                            dev) for i in range(TRAIN_STEPS + 1)]
    first = {path: x.clone() for path, x in leaves_with_path(params)
             if x.numel() <= 1 << 24}  # norms and biases
    counters = _counters()
    _zero_counters()
    times, metrics = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batches[i],
                                       TRAIN_STEP0 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:  # m = (1 - b1) x the first clipped gradient
            dead = [path for path, x in leaves_with_path(opt_state["m"])
                    if not bool(torch.any(x != 0))]
            bad = [path for path, x in leaves_with_path(opt_state["m"])
                   if not bool(torch.isfinite(x).all())]
            if dead or bad:
                raise SystemExit(f"chip_smoke: train: first-step gradient "
                                 f"zero for {dead[:5]} ({len(dead)} "
                                 f"leaves), not finite for {bad[:5]}")
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    attn = _attention_layers(cfg)
    expected = {"flash_fwd": attn * cfg.microbatches * 2 * TRAIN_STEPS}
    if launches != expected:
        raise SystemExit(f"chip_smoke: train: launches {launches}, expected "
                         f"{expected} ({attn} attention layers x "
                         f"{cfg.microbatches} microbatches x 2 x "
                         f"{TRAIN_STEPS} steps)")
    losses = [m["loss"] for m in metrics]
    now = dict(leaves_with_path(params))
    moved = min(float((x - now[path]).abs().max())
                for path, x in first.items())
    if not all(map(math.isfinite, losses)) or moved <= 0:
        raise SystemExit(f"chip_smoke: train: losses {losses}, smallest "
                         f"largest update {moved}")
    peak_alloc = torch.cuda.max_memory_allocated()
    warm_s = sum(times[1:]) / (len(times) - 1)
    flops = sb.model_flops(cfg, shape)
    bf16_peak = peaks[2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"phase": "train", "config": cfg.name, "layers": cfg.total_layers,
           "cut": cut, "d_model": cfg.d_model, "params": cfg.param_count(),
           "dtype": cfg.param_dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": cfg.microbatches, "optimizer": cfg.optimizer,
           "remat": cfg.remat, "steps": [TRAIN_STEP0 + i
                                         for i in range(TRAIN_STEPS)],
           "setup_s": setup_s, "step_ms": [t * 1e3 for t in times],
           "ms_per_step": warm_s * 1e3, "tokens_per_s": tokens / warm_s,
           "model_flops": flops, "mfu": flops / (warm_s * bf16_peak),
           "bound_ms": flops / bf16_peak * 1e3, "peak_allocated_gb":
           peak_alloc / 1e9, "losses": losses,
           "grad_norms": [m["grad_norm"] for m in metrics],
           "launches": launches, "launches_per_step": {
               k: v // TRAIN_STEPS for k, v in launches.items()},
           "gpu": smi}
    print(json.dumps(out), flush=True)
    out["profile"] = profile_phase(
        "train", lambda: step_fn(params, opt_state, batches[-1],
                                 TRAIN_STEP0 + TRAIN_STEPS), warm_s)
    del params, opt_state, batches, first
    _free_cuda()
    out["flash_grad"] = flash_grad_phase(dev, *peaks)
    out["check"] = train_check_phase(dev)
    out["resume"] = train_resume_phase(dev)
    return out


MESH_TRAIN_STEPS = 2    # steps 200 and 201 of each pass
MESH_TRAIN_PAIRS = 2    # alternating (mesh-free, 1x1 mesh) passes
MESH_TRAIN_CHUNK = 1 << 26   # values a fingerprint sums at a time
# Qwen1.5-4B's rank-local flash shapes of 8 x 512 training on a 2x2 mesh
# (4 microbatches of 2 rows, 1 a data rank): ``sp`` a model rank's 256
# queries at q_offset 0 or 256 against all 512 keys, 20 heads; ``heads``
# a model rank's 10 heads over 512
MESH_TRAIN_FLASH = [("sp q_offset 0", 20, 256, 512, 0),
                    ("sp q_offset 256", 20, 256, 512, 256),
                    ("heads", 10, 512, 512, 0)]


def _fingerprint(tree) -> list:
    """Per leaf of ``tree`` (DTensors: the local shard) two int64 sums of
    its bits (plain, and weighted by the index mod 8191 plus 1), summed
    ``MESH_TRAIN_CHUNK`` values at a time on the card: equal trees give
    equal prints, compared on the host."""
    import torch
    from repro_torch.utils.tree import leaves
    out = []
    for x in leaves(tree):
        x = x.to_local() if hasattr(x, "to_local") else x
        flat = x.detach().contiguous().view(-1)
        bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
        s = w = 0
        for a in range(0, bits.numel(), MESH_TRAIN_CHUNK):
            c = bits[a:a + MESH_TRAIN_CHUNK].to(torch.int64)
            idx = torch.arange(a, a + c.numel(), device=c.device) % 8191 + 1
            s += int(c.sum())
            w += int((c * idx).sum())
        out.append((s, w))
    return out


def _mesh_train_pass(cfg, ctx, dev) -> dict:
    """One pass of `mesh_train_phase`: ``cfg``'s weights drawn on the card
    from seed 0 (under the 1x1 mesh ``ctx``, DTensors), a fresh
    optimizer state, steps 200-201 of `build_train` (every count set to
    0 just before a step and read just after), then the params'
    fingerprints; the card is freed at the end."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd

    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params = _train_params(cfg, 0, dev)
    if ctx is not None:
        with shd.use_mesh(ctx.mesh, ctx.rules):
            params = tfm.shard_params(params, cfg)
    state = sb.init_opt_state(cfg, params, ctx)
    step_fn = sb.build_train(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"), ctx)
    counters = _counters()
    times, metrics, launches = [], [], []
    for i in range(MESH_TRAIN_STEPS):
        batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEP0 + i,
                             dev)
        if ctx is not None:
            batch = sb.shard_batch(cfg, batch, ctx)
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, TRAIN_STEP0 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append({n: k.launches for n, k in counters.items()
                         if k.launches})
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    del state, batch, m
    _free_cuda()
    prints = _fingerprint(params)
    del params
    _free_cuda()
    return {"step_ms": [t * 1e3 for t in times], "metrics": metrics,
            "launches": launches, "peak_allocated_gb": peak / 1e9,
            "fingerprints": prints}


def mesh_train_resume(dev) -> dict:
    """`TrainLoop(mesh=)` on the card under the 1x1 mesh at the reduced
    Qwen1.5-4B config: 4 steps and a checkpoint (each leaf gathered, then
    written), a fresh loop that resumes from it and takes step 5, against
    an uninterrupted 5-step run on the same mesh: losses and every
    parameter and optimizer leaf bit-equal."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.utils.tree import leaves
    cfg = get_config(TRAIN_CONFIG).reduce()
    r = TRAIN_RESUME
    mesh = make_local_mesh(1, 1)
    kw = dict(batch=r["batch"], seq=r["seq"], device=dev, mesh=mesh)
    p_w, s_w, h_w = TrainLoop(cfg, ckpt_dir=None, **kw).run(
        r["steps"], log_every=10 ** 6)
    with tempfile.TemporaryDirectory() as d:
        TrainLoop(cfg, ckpt_dir=d, **kw).run(r["ckpt_at"], log_every=10 ** 6)
        p_r, s_r, h_r = TrainLoop(cfg, ckpt_dir=d, **kw).run(
            r["steps"], log_every=10 ** 6)
    equal = all(torch.equal(a.to_local(), b.to_local()) for a, b in
                zip(leaves(p_r) + leaves(s_r), leaves(p_w) + leaves(s_w)))
    out = {"phase": "mesh_train_resume", "mesh": "1x1",
           "config": f"{TRAIN_CONFIG} reduced", **r,
           "steps_after_resume": len(h_r), "losses": h_w,
           "losses_equal": h_r == h_w[r["ckpt_at"]:], "state_equal": equal}
    print(json.dumps(out), flush=True)
    if len(h_r) != r["steps"] - r["ckpt_at"] or not (
            out["losses_equal"] and equal):
        raise SystemExit(f"chip_smoke: mesh train resume: {len(h_r)} steps "
                         f"after the resume, losses equal "
                         f"{out['losses_equal']}, state equal {equal}")
    return out


def mesh_flash_grad_cases(timer: Timer, dev, bf16_peak: float) -> list:
    """`FlashFwd` at the rank-local shapes of `MESH_TRAIN_FLASH` in bf16:
    the kernel forward against the plain one (`Timer.run`: device ms,
    bound, SDPA with the offset's mask), and dq, dk, dv of
    `flash_fwd_trainable` against autograd through `flash_fwd_plain` in
    f32 on the same inputs, within 2e-2 of max|grad|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import (flash_fwd_kernel,
                                           flash_fwd_plain,
                                           flash_fwd_trainable, kernel_body)
    gen = torch.Generator().manual_seed(11)
    bf = torch.bfloat16
    rows = []
    for name, bh, tq, tk, off in MESH_TRAIN_FLASH:
        q, do = (torch.randn(bh, tq, 128, generator=gen).to(dev, bf)
                 for _ in range(2))
        k, v = (torch.randn(bh, tk, 128, generator=gen).to(dev, bf)
                for _ in range(2))
        mask = _attn_mask(tq, tk, True, None, off, dev)
        label = (f"mesh train flash Qwen {name} (2x2): BH {bh} Tq {tq} at "
                 f"q_offset {off}, Tk {tk}, hd 128 bf16")
        row = timer.run(
            label, "flash_fwd",
            lambda: flash_fwd_kernel(q, k, v, q_offset=off),
            lambda: flash_fwd_plain(q, k, v, q_offset=off),
            lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                   v[None],
                                                   attn_mask=mask)[0],
            flops=4 * bh * int(mask.sum()) * 128,
            nbytes=_nbytes(q, k, v) + q.numel() * q.element_size(),
            reps=10, rtol=BF16_RTOL, peak_flops=bf16_peak,
            body=kernel_body(bf), mesh="2x2 train")
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        g_fn = torch.autograd.grad(flash_fwd_trainable(*a, q_offset=off),
                                   a, do)
        p = [t.float().requires_grad_() for t in (q, k, v)]
        g_plain = torch.autograd.grad(flash_fwd_plain(*p, q_offset=off), p,
                                      do.float())
        for n, x, y in zip("qkv", g_fn, g_plain):
            rel, _ = _rel_err(x.float(), y)
            if not rel <= 2e-2:
                raise SystemExit(f"chip_smoke: {label}: d{n} of the "
                                 f"Function vs autograd through plain "
                                 f"{rel:.3e} > 2e-2")
            row[f"d{n}_rel_err"] = rel
        print(json.dumps({"phase": "mesh_flash_grad", "case": label,
                          **{f"d{n}_rel_err": row[f"d{n}_rel_err"]
                             for n in "qkv"}}), flush=True)
        rows.append(row)
    return rows


def mesh_collectives_phase(dev) -> dict:
    """`compressed_psum` and `pipeline_apply` on the one-rank world: the
    fp8 sum of 4 M f32 values, its new error, its codes and its scales
    (the amax over 448, a true division on both devices) bit-equal to
    the same computed on the CPU; a 4-microbatch
    pipeline over a pod dim of one rank (a tanh-linear stage, D 1024)
    equals the sequential stage, gradients included, within 1e-5 (f32,
    TF32 off: the stage's products at another batch shape)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import compression as C
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.pipeline import pipeline_apply
    t0 = time.perf_counter()
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4 << 20, generator=gen)
    err = 1e-3 * torch.randn(4 << 20, generator=gen)
    xd, ed = x.to(dev), err.to(dev)
    with shd.use_mesh(mesh):
        tot, new = C.compressed_psum(xd, "pod", ed)
    qd, sd, _ = C.quantize_fp8_block(xd + ed)
    q, sc, pad = C.quantize_fp8_block(x + err)
    own = C.dequantize_fp8_block(q, sc, pad, tuple(x.shape))   # on the CPU
    comp = {"sum_equal_cpu": torch.equal(tot.cpu(), own),
            "err_equal_cpu": torch.equal(new.cpu(), (x + err) - own),
            "codes_equal_cpu": torch.equal(qd.view(torch.uint8).cpu(),
                                           q.view(torch.uint8)),
            "scales_equal_cpu": torch.equal(sd.cpu(), sc),
            "scales_rel_err_cpu": _rel_err(sd.cpu(), sc)[0],
            "rel_err_vs_exact": float((tot.cpu() - (x + err)).abs().max()
                                      / (x + err).abs().max())}
    w = (torch.randn(1, 1024, 1024, generator=gen) / 32).to(dev)
    b = (0.1 * torch.randn(1, 1024, generator=gen)).to(dev)
    xs = torch.randn(4, 2, 128, 1024, generator=gen).to(dev)
    params = {"w": shd.place(w, mesh, (Shard(0),)).requires_grad_(),
              "b": shd.place(b, mesh, (Shard(0),)).requires_grad_()}
    xd = shd.place(xs, mesh, (Replicate(),)).requires_grad_()
    stage = lambda sp, xi: torch.tanh(xi @ sp["w"] + sp["b"])  # noqa: E731
    y = pipeline_apply(mesh, stage, params, xd)
    gw, gx = torch.autograd.grad((y ** 2).sum(), [params["w"], xd])
    wt, xt = w.clone().requires_grad_(), xs.clone().requires_grad_()
    ref = torch.tanh(xt @ wt[0] + b[0])
    rw, rx = torch.autograd.grad((ref ** 2).sum(), [wt, xt])
    pipe = {"out_rel_err": _rel_err(y.full_tensor(), ref)[0],
            "dw_rel_err": _rel_err(gw.full_tensor(), rw)[0],
            "dx_rel_err": _rel_err(gx.full_tensor(), rx)[0]}
    out = {"phase": "mesh_collectives", "compressed_psum": comp,
           "pipeline_apply": pipe, "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    if not (comp["sum_equal_cpu"] and comp["err_equal_cpu"]
            and comp["codes_equal_cpu"] and comp["scales_equal_cpu"]
            and max(pipe.values()) <= 1e-5):
        raise SystemExit(f"chip_smoke: mesh collectives: {out}")
    del params, xd, y, gw, gx
    _free_cuda()
    return out


def mesh_train_phase(timer: Timer, dev, smi: str, bf16_peak: float) -> dict:
    """The port's training under a mesh on the card: Qwen1.5-4B whole (or
    cut as `_train_depth` cuts it) in bf16, 8 x 512 tokens a step in 4
    microbatches, AdamW, remat, on the one-rank NCCL world's 1x1 mesh
    (params, state and batch DTensors; `build_train` with ``ctx``)
    against the mesh-free step in the same call, in `MESH_TRAIN_PAIRS`
    alternating passes (`_mesh_train_pass`, the card freed between
    them).  Required: after step 1 loss, ce, aux and grad norm bit-equal;
    the params' fingerprints equal after step 2 (every pass the same);
    320 flash launches a step on both sides (attention layers x
    microbatches x 2); a save and resume on the mesh equal to an
    uninterrupted run (`mesh_train_resume`).  Reported: ms a step (each
    pass's second step) and peak GB on each side.  Then `FlashFwd` at the
    2x2 mesh's rank-local shapes (`mesh_flash_grad_cases`) and the
    collectives on one rank (`mesh_collectives_phase`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as shd

    t0 = time.perf_counter()
    _free_cuda()
    cfg, cut = _train_depth(get_config(TRAIN_CONFIG))
    ctx = shd.MeshContext(make_local_mesh(1, 1), shd.TRAIN_RULES)
    passes = {"mesh_free": [], "mesh_1x1": []}
    for _ in range(MESH_TRAIN_PAIRS):
        passes["mesh_free"].append(_mesh_train_pass(cfg, None, dev))
        passes["mesh_1x1"].append(_mesh_train_pass(cfg, ctx, dev))
    expected = {"flash_fwd": _attention_layers(cfg) * cfg.microbatches * 2}
    first = {side: p[0] for side, p in passes.items()}
    out = {"phase": "mesh_train", "config": cfg.name,
           "layers": cfg.total_layers, "cut": cut, "dtype": cfg.param_dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": cfg.microbatches, "mesh": "1x1 (one-rank NCCL)",
           "steps": [TRAIN_STEP0 + i for i in range(MESH_TRAIN_STEPS)],
           "step1_metrics": {side: p["metrics"][0]
                             for side, p in first.items()},
           "step1_bit_equal": first["mesh_free"]["metrics"][0]
           == first["mesh_1x1"]["metrics"][0],
           "fingerprints_equal": all(
               p["fingerprints"] == first["mesh_free"]["fingerprints"]
               for ps in passes.values() for p in ps),
           "launches_per_step": {side: [p["launches"] for p in ps]
                                 for side, ps in passes.items()},
           "expected_launches_per_step": expected,
           "step_ms": {side: [p["step_ms"] for p in ps]
                       for side, ps in passes.items()},
           "ms_per_step": {side: sum(p["step_ms"][-1] for p in ps) / len(ps)
                           for side, ps in passes.items()},
           "peak_allocated_gb": {side: max(p["peak_allocated_gb"]
                                           for p in ps)
                                 for side, ps in passes.items()},
           "gpu": smi}
    launches_ok = all(step == expected for ps in passes.values()
                      for p in ps for step in p["launches"])
    print(json.dumps(out), flush=True)
    if not (out["step1_bit_equal"] and out["fingerprints_equal"]
            and launches_ok):
        raise SystemExit(
            f"chip_smoke: mesh train: step 1 bit-equal "
            f"{out['step1_bit_equal']} ({out['step1_metrics']}), "
            f"fingerprints equal {out['fingerprints_equal']}, launches "
            f"{out['launches_per_step']} (expected {expected} a step)")
    out["launches"] = {"flash_fwd": sum(
        step.get("flash_fwd", 0) for ps in passes.values() for p in ps
        for step in p["launches"])}
    out["resume"] = mesh_train_resume(dev)
    out["flash"] = mesh_flash_grad_cases(timer, dev, bf16_peak)
    out["collectives"] = mesh_collectives_phase(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def cnn_shim_phase(vgg: dict, dev) -> dict:
    """`models.cnn.vgg16_apply` (the reference's PR-1-era entry point) on
    the served VGG-16 (`vgg16-halo`: its weights and sparse tree, its
    impl) against `graph.net_apply` on the same batch of 8: bit-equal,
    with the path's launches (13 conv, 3 vsmm), every count set to 0
    just before and read just after."""
    import numpy as np
    import torch
    from repro_torch.models import cnn, graph

    srv = vgg["srv"]
    impl = srv.backend.apply.impl
    x = torch.from_numpy(np.stack(vgg["images"][:BATCH])).to(dev)
    counters = _counters()
    with torch.inference_mode():
        torch.cuda.synchronize()
        _zero_counters()
        y = cnn.vgg16_apply(srv.params, x, sparse=srv.sparse, impl=impl)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in counters.items() if k.launches}
        ref = graph.net_apply(srv.net, srv.params, x, sparse=srv.sparse,
                              impl=impl)
    out = {"phase": "cnn_shim", "path": "vgg16-halo", "impl": impl,
           "bit_equal": bool(torch.equal(y, ref)), "launches": launches,
           "expected_launches": PATHS["vgg16-halo"][4]}
    print(json.dumps(out), flush=True)
    if not out["bit_equal"] or launches != out["expected_launches"]:
        raise SystemExit(f"chip_smoke: cnn shim: {out}")
    return out


DRYRUN_CELLS = [("train_4k", {}), ("prefill_32k", {}), ("decode_32k", {}),
                ("decode_32k", {"use_sparse_ffn": True})]
DRYRUN_MEMORY_RTOL = 0.15   # meta arg + temp bytes against the card's peak


DRYRUN_STEPS = ("prefill", "decode", "train")


def _dryrun_step(name: str, cfg, params, dev):
    """One of the smoke's three Qwen steps on ``params`` (on ``dev``), a
    `step_builders.Step` with its own arguments (the train step's
    optimizer state fresh): token ids empty on meta, seeded on the
    card."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(7)

    def ids(*shape):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.int64, device=dev)
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape)).to(dev)

    if name == "prefill":   # as `prefill_breakdown_phase` runs it
        return sb.Step(
            lambda p, b: tfm.prefill(p, b, cfg, capacity=LM_CAPACITY),
            (params, {"tokens": ids(LM_BATCH, 512)}))
    if name == "decode":    # the served step, eager
        return sb.Step(
            lambda p, c, t, q: tfm.decode_step(p, c, t, q, cfg),
            (params, tfm.init_cache(cfg, LM_BATCH, LM_CAPACITY, dev),
             ids(LM_BATCH, 1),
             torch.full((), 512, dtype=torch.int64, device=dev)))
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    return sb.Step(sb.build_train(cfg, shape), (
        params, sb.make_optimizer(cfg).init(params),
        {"tokens": ids(TRAIN_BATCH, TRAIN_SEQ).int(),
         "labels": ids(TRAIN_BATCH, TRAIN_SEQ).int()}, TRAIN_STEP0))


def _step_ms(step) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.fn(*step.args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def dryrun_phase(dev, smi: str) -> dict:
    """(a) `run_cell` on meta for `DRYRUN_CELLS`; (b) the smoke's three
    Qwen1.5-4B steps counted on meta and on the card, equal in FLOPs,
    bytes and kernel launches; (c) the card's peak memory and profiled
    device-busy time against the meta count's roofline terms; (d) and
    (e) the same steps as rank 0 of a one-rank mesh, and a reduced cell
    as rank 0 of a fake 2x2 world (`dryrun_mesh_phase`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params
    from repro_torch.utils.cost import count
    from repro_torch.utils.roofline import card_hw

    cells = []
    for shape, extra in DRYRUN_CELLS:
        t0 = time.perf_counter()
        row = dryrun.run_cell(LM_CONFIG, shape, verbose=False,
                              overrides={"microbatches": 1, **extra})
        row["host_s"] = time.perf_counter() - t0
        print(json.dumps({"phase": "dryrun_cell", **row}), flush=True)
        cells.append(row)

    hw = card_hw()
    cfg = get_config(LM_CONFIG)
    meta_dev = torch.device("meta")
    structs = sb.param_structs(cfg, meta_dev)
    metas = {}
    for name in DRYRUN_STEPS:
        step = _dryrun_step(name, cfg, structs, meta_dev)
        metas[name] = count(step.fn, *step.args)[1]
    _free_cuda()
    params = init_params(tfm.lm_schema(cfg), 0, dtype=cfg.dtype, device=dev,
                         draw_on_device=True)
    counters = _counters()
    steps, launches = {}, {}
    for name in DRYRUN_STEPS:
        step = _dryrun_step(name, cfg, params, dev)
        meta = metas[name]
        warm_ms = _step_ms(step)   # first call: plans, cuBLAS set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero_counters()
        t0 = time.perf_counter()
        card = count(step.fn, *step.args)[1]   # the outputs freed at once
        torch.cuda.synchronize()
        counted_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        moved = {n: k.launches for n, k in counters.items() if k.launches}
        launches[name] = moved
        step_ms = _step_ms(step)
        prof = profile_phase(f"dryrun-{name}", lambda: step.fn(*step.args),
                             step_ms / 1e3)
        busy_ms = prof["device_busy_ms"]
        compute_ms = meta.flops / hw.bf16_flops * 1e3
        memory_ms = meta.bytes / hw.hbm_bw * 1e3
        meta_mem = meta.arg_bytes + meta.temp_bytes
        diff = {op: (meta.ops.get(op), card.ops.get(op))
                for op in set(meta.ops) | set(card.ops)
                if meta.ops.get(op) != card.ops.get(op)}
        out = {"phase": "dryrun", "step": name, "config": cfg.name,
               "meta": {"flops": meta.flops, "bytes": meta.bytes,
                        "kernels": meta.kernels, "arg_bytes": meta.arg_bytes,
                        "temp_bytes": meta.temp_bytes,
                        "ops": sum(n for n, _, _ in meta.ops.values())},
               "card": {"flops": card.flops, "bytes": card.bytes,
                        "kernels": card.kernels, "arg_bytes": card.arg_bytes,
                        "temp_bytes": card.temp_bytes,
                        "launch_counters": moved,
                        "ops": sum(n for n, _, _ in card.ops.values())},
               "ops_differing": {k: v for k, v in list(diff.items())[:8]},
               "allocated_before_bytes": base,
               "peak_allocated_bytes": peak,
               "meta_arg_plus_temp_bytes": meta_mem,
               "memory_rel_err": abs(meta_mem - peak) / peak,
               "first_ms": warm_ms, "counted_ms": counted_ms,
               "step_ms": step_ms, "device_busy_ms": busy_ms,
               "compute_ms": compute_ms, "memory_ms": memory_ms,
               "busy_over_bound": busy_ms / max(compute_ms, memory_ms),
               "hbm_bytes": hw.hbm_bytes, "gpu": smi}
        print(json.dumps(out), flush=True)
        steps[name] = out
        if (meta.flops, meta.bytes, meta.kernels) != \
                (card.flops, card.bytes, card.kernels) or \
                moved != card.kernels:
            raise SystemExit(f"chip_smoke: dryrun {name}: the meta count "
                             f"is not the card's: {out}")
        if out["memory_rel_err"] > DRYRUN_MEMORY_RTOL:
            raise SystemExit(f"chip_smoke: dryrun {name}: meta arg + temp "
                             f"{meta_mem} bytes against the card's peak "
                             f"{peak} (beyond {DRYRUN_MEMORY_RTOL})")
        if busy_ms < compute_ms:
            raise SystemExit(f"chip_smoke: dryrun {name}: device busy "
                             f"{busy_ms} ms under the count's compute term "
                             f"{compute_ms} ms: the count is wrong")
        del step, card
        _free_cuda()
    mesh = dryrun_mesh_phase(dev, cfg, params, smi)
    launches.update({f"mesh {k}": v for k, v in mesh["launches"].items()})
    del params
    _free_cuda()
    return {"cells": cells, "steps": steps, "launches": launches,
            "mesh": mesh}


DRYRUN_FAKE_MESH = "2x2"   # (e): a reduced cell as rank 0 of this world


def _dryrun_mesh_step(name: str, cfg, params, dev, ctx):
    """`_dryrun_step`'s step under the mesh ``ctx`` (the training rules),
    as `step_builders.build` lays a step out under a mesh: the params by
    the schema (`transformer.shard_params`), the prefill and decode
    tokens on the batch dims, the decode caches by
    `transformer.cache_axes`, the train step's optimizer state and batch
    by `step_builders.init_opt_state` and `shard_batch`; the step run
    under the mesh."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd

    rng = np.random.default_rng(7)

    def ids(*shape):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.int64, device=dev)
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape)).to(dev)

    with shd.use_mesh(ctx.mesh, ctx.rules):
        sharded = tfm.shard_params(params, cfg)
        if name == "prefill":
            fn = lambda p, b: tfm.prefill(
                p, b, cfg, capacity=LM_CAPACITY)
            args = (sharded, {"tokens": shd.distribute(
                ids(LM_BATCH, 512), ("batch", None))})
        elif name == "decode":
            fn = lambda p, c, t, q: tfm.decode_step(
                p, c, t, q, cfg)
            args = (sharded, tfm.init_cache(cfg, LM_BATCH, LM_CAPACITY, dev),
                    shd.distribute(ids(LM_BATCH, 1), ("batch", None)),
                    torch.full((), 512, dtype=torch.int64, device=dev))
        else:
            shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
            fn = sb.build_train(cfg, shape, ctx)
            args = (sharded, sb.init_opt_state(cfg, sharded, ctx),
                    sb.shard_batch(cfg, {
                        "tokens": ids(TRAIN_BATCH, TRAIN_SEQ).int(),
                        "labels": ids(TRAIN_BATCH, TRAIN_SEQ).int()}, ctx),
                    TRAIN_STEP0)

    def run(*a):
        with shd.use_mesh(ctx.mesh, ctx.rules):
            return fn(*a)
    return sb.Step(run, args)


def dryrun_mesh_phase(dev, cfg, params, smi: str) -> dict:
    """The dry run of a mesh's rank on the card.  (d) The smoke's three
    Qwen1.5-4B steps (`_dryrun_mesh_step`) as rank 0 of a one-rank 1x1
    mesh: counted on meta in a fake world (`launch.mesh.fake_world`) and
    on the card in a one-rank NCCL world (`_mesh_world`), equal in FLOPs,
    bytes and kernel launches by name, with no wire byte on either side
    (a dim of one rank moves nothing).  (e) A reduced Qwen1.5-4B train
    cell counted by `launch.dryrun.run_cell` as rank 0 of a fake 2x2
    world: its wire bytes by kind and by mesh dim, printed."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import step_builders as sb
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.cost import CostCounter

    meta_dev = torch.device("meta")
    metas, meta_s = {}, {}
    structs = sb.param_structs(cfg, meta_dev)
    with fake_world("1x1") as fake:
        ctx = shd.MeshContext(fake, shd.TRAIN_RULES)
        for name in DRYRUN_STEPS:
            t0 = time.perf_counter()
            step = _dryrun_mesh_step(name, cfg, structs, meta_dev, ctx)
            with CostCounter(step.args, meta_dev, mesh=fake) as counter:
                step.fn(*step.args)
            metas[name] = counter.cost
            meta_s[name] = time.perf_counter() - t0
    counters = _counters()
    steps, launches = {}, {}
    store = _mesh_world(dev)
    try:
        mesh = make_local_mesh(1, 1)
        ctx = shd.MeshContext(mesh, shd.TRAIN_RULES)
        for name in DRYRUN_STEPS:
            meta = metas[name]
            step = _dryrun_mesh_step(name, cfg, params, dev, ctx)
            torch.cuda.synchronize()
            _zero_counters()
            t0 = time.perf_counter()
            with CostCounter(step.args, dev, mesh=mesh) as counter:
                step.fn(*step.args)
            torch.cuda.synchronize()
            counted_ms = (time.perf_counter() - t0) * 1e3
            card = counter.cost
            moved = {n: k.launches for n, k in counters.items()
                     if k.launches}
            launches[name] = moved
            diff = {op: (meta.ops.get(op), card.ops.get(op))
                    for op in set(meta.ops) | set(card.ops)
                    if meta.ops.get(op) != card.ops.get(op)}
            out = {"phase": "dryrun_mesh", "step": name,
                   "config": cfg.name, "mesh": "data1xmodel1", "rank": 0,
                   "meta": {"flops": meta.flops, "bytes": meta.bytes,
                            "coll_bytes": meta.coll_bytes,
                            "kernels": meta.kernels,
                            "arg_bytes": meta.arg_bytes,
                            "temp_bytes": meta.temp_bytes,
                            "ops": sum(n for n, _, _ in meta.ops.values()),
                            "host_s": meta_s[name]},
                   "card": {"flops": card.flops, "bytes": card.bytes,
                            "coll_bytes": card.coll_bytes,
                            "kernels": card.kernels,
                            "arg_bytes": card.arg_bytes,
                            "temp_bytes": card.temp_bytes,
                            "launch_counters": moved,
                            "ops": sum(n for n, _, _ in card.ops.values()),
                            "counted_ms": counted_ms},
                   "ops_differing": {k: v for k, v in
                                     list(diff.items())[:8]},
                   "gpu": smi}
            print(json.dumps(out), flush=True)
            steps[name] = out
            if (meta.flops, meta.bytes, meta.kernels) != \
                    (card.flops, card.bytes, card.kernels) or \
                    moved != card.kernels or meta.coll_bytes or \
                    card.coll_bytes:
                raise SystemExit(f"chip_smoke: dryrun mesh {name}: the "
                                 f"meta count of the 1x1 mesh is not the "
                                 f"card's: {out}")
            del step, counter, card
            _free_cuda()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    small = ShapeSpec("train_4k", 32, 4, "train")
    row = dryrun.run_cell(LM_CONFIG, "train_4k", cfg=cfg.reduce(),
                          shape=small, overrides={"microbatches": 1},
                          mesh=DRYRUN_FAKE_MESH, verbose=False)
    fake = {"phase": "dryrun_fake_world", "mesh": DRYRUN_FAKE_MESH,
            "rank": row["rank"], "config": f"{cfg.name} reduced",
            "shape": [small.global_batch, small.seq_len],
            "coll_by_kind": row["coll_by_kind"],
            "coll_by_dim": row["coll_by_dim"],
            "device_coll_bytes": row["device_coll_bytes"],
            "collective_ms": row["collective_ms"],
            "device_flops": row["device_flops"],
            "host_s": time.perf_counter() - t0}
    print(json.dumps(fake), flush=True)
    if row["status"] != "ok" or not row["device_coll_bytes"]:
        raise SystemExit(f"chip_smoke: dryrun fake world: {row}")
    return {"steps": steps, "launches": launches, "fake_world": fake}


# the mesh phase (one-rank NCCL world; PR 29)
MESH_PAIRS = 2          # alternating (mesh-free, mesh) timing pairs
MESH_SPARSE_LAYERS = 8  # the sparse-FFN Qwen at full width, 8 of 40 layers
MESH_MOE_REQUESTS = 8   # Granite-MoE whole: 8 requests of 113-128 tokens
MESH_TP = 4             # the model dim whose rank-local shapes (e) runs


def _mesh_world(dev):
    """A one-rank NCCL world through `launch.mesh` (a file:// store in a
    fresh temporary directory) -> the store's directory."""
    import tempfile

    from repro_torch.launch.mesh import init_process_group
    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    init_process_group(f"{store}/store", rank=0, world_size=1, device=dev)
    return store


def _spy_flash(shapes: list):
    """A stand-in for `models.attention.flash_fwd_kernel` that records
    each call's shape and passes it on."""
    from repro_torch.models import attention
    real = attention.flash_fwd_kernel

    def spy(q, k, v, *, causal=True, window=None, q_offset=0):
        shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       causal, window, q_offset, str(q.dtype)))
        return real(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return spy


def _served_pair(srv0, srv1, traffic: list, path: str) -> dict:
    """Serve ``traffic`` on the mesh-free ``srv0`` and the mesh ``srv1``
    with every count set to 0 before each: equal streams (bit-equal
    logits give equal greedy tokens), equal launch counts, flash at equal
    shapes in equal order.  Returns the counts and shapes."""
    from unittest import mock

    import torch
    from repro_torch.models import attention

    got = []
    for srv in (srv0, srv1):
        reqs = _lm_requests(traffic)
        shapes: list = []
        counters = _counters()
        _zero_counters()
        with mock.patch.object(attention, "flash_fwd_kernel",
                               _spy_flash(shapes)):
            stats = srv.serve(reqs)
        torch.cuda.synchronize()
        got.append({"streams": [r.out for r in reqs],
                    "launches": {n: k.launches for n, k in counters.items()
                                 if k.launches},
                    "bf16": counters["vsmm"].bf16_launches,
                    "shapes": shapes, "stats": _lm_stats(stats)})
    a, b = got
    if a["streams"] != b["streams"]:
        raise SystemExit(f"chip_smoke: mesh {path}: streams differ from "
                         f"the mesh-free server's")
    if a["launches"] != b["launches"] or a["bf16"] != b["bf16"] or \
            a["shapes"] != b["shapes"]:
        raise SystemExit(f"chip_smoke: mesh {path}: launches {b['launches']}"
                         f" (bf16 {b['bf16']}) against mesh-free "
                         f"{a['launches']} (bf16 {a['bf16']}), flash shapes "
                         f"equal: {a['shapes'] == b['shapes']}")
    return {"streams_equal": True, "launches": b["launches"],
            "vsmm_bf16_launches": b["bf16"],
            "flash_shapes": sorted(set(map(str, b["shapes"]))),
            "mesh_free": a["stats"], "mesh": b["stats"]}


def _prefill_pair(srv0, srv1, cfg, tokens, mesh) -> tuple:
    """One eager prefill of ``tokens`` on each server: (mesh-free logits,
    mesh logits gathered whole)."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd

    # no_grad, not inference_mode: DTensor's views of inference tensors
    # fail (torch 2.11), and the served path runs without either
    with torch.no_grad():
        y0, _ = tfm.prefill(srv0.params, {"tokens": tokens}, cfg,
                            capacity=srv0.capacity)
        with shd.use_mesh(mesh, shd.SERVE_RULES):
            y1, _ = tfm.prefill(srv1.params, {"tokens": shd.distribute(
                tokens, ("batch", None))}, cfg, capacity=srv1.capacity)
            y1 = y1.full_tensor()
    torch.cuda.synchronize()
    return y0, y1


def _alternate(srv0, srv1, traffic: list) -> dict:
    """Mesh-free then mesh, in `MESH_PAIRS` alternating pairs in this call:
    a served run's ms a decode step (its wall clock over its steps, the
    eager backfill prefills inside the run included), prefill s a run,
    and the decode graph's replay (device ms, CUDA events over 10
    replays): the host cost of DTensor dispatch (a prefill runs eagerly;
    a decode step is a graph replay)."""
    out = {"mesh_free": [], "mesh": []}
    for _ in range(MESH_PAIRS):
        for key, srv in (("mesh_free", srv0), ("mesh", srv1)):
            st = _lm_stats(srv.serve(_lm_requests(traffic)))
            g = next(iter(srv.backend.graphs.values())).graph
            out[key].append({"decode_ms_per_step": st["ms_per_step_in_runs"],
                             "prefill_s_per_run": st["prefill_s_per_run"],
                             "backfills": st["backfills"],
                             "replay_ms": _replay_ms(g, 10)})
    return out


def _replay_ms(graph, n: int) -> float:
    """Device ms a replay of a captured graph: CUDA events around ``n``
    replays, after one more."""
    import torch
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def mesh_cnn_phase(served: dict, dev) -> dict:
    """(d) ResNet-50, f32 and int8, served by `CNNServer(shard_fc=True)`
    in the one-rank world (its FC head's strips on the ``("model",)``
    mesh): the same 16 images as the mesh-free server of the serve
    phase, served warm (graphs captured) by each: logits bit-equal, the
    same launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from torch.distributed.tensor import DTensor

    out = {}
    for path in FLEET_PATHS:
        s = served[path]
        cfg_name, impl, dtype = PATHS[path][:3]
        srv_m = CNNServer(get_config(cfg_name), batch=BATCH, impl=impl,
                          dtype=dtype, seed=0, shard_fc=True, device=dev)
        fc = [e for e in srv_m.group.backends[0].apply.sparse.values()
              if isinstance(e.vs.vals, DTensor)]
        if len(fc) != 1 or srv_m.group.mesh.mesh_dim_names != ("model",):
            raise SystemExit(f"chip_smoke: mesh {path}: {len(fc)} sharded "
                             f"FC heads on {srv_m.group.mesh}")
        runs = []
        for srv in (s["srv"], srv_m):
            srv.serve([ImageRequest(rid=i, image=im)  # graphs captured
                       for i, im in enumerate(s["images"])])
            reqs = [ImageRequest(rid=i, image=im)
                    for i, im in enumerate(s["images"])]
            counters = _counters()
            _zero_counters()
            srv.serve(reqs)
            torch.cuda.synchronize()
            runs.append(({n: (k.launches, getattr(k, "int8_launches", 0))
                          for n, k in counters.items() if k.launches},
                         np.stack([r.logits for r in reqs])))
        (l0, y0), (l1, y1) = runs
        if not np.array_equal(y0, y1) or l0 != l1:
            raise SystemExit(f"chip_smoke: mesh {path}: logits bit-equal "
                             f"{np.array_equal(y0, y1)} (max |d| "
                             f"{float(np.abs(y0 - y1).max())}), launches "
                             f"{l1} against {l0}")
        out[path] = {"logits_bit_equal": True, "launches": l1,
                     "requests": len(y1)}
        del srv_m
        _free_cuda()
    print(json.dumps({"phase": "mesh_cnn", **out}), flush=True)
    return out


def mesh_lm_phase(lm: dict, dev) -> dict:
    """(a)-(c): LM servers on `make_local_mesh()` (one rank, 1x1) against
    the mesh-free ones, in this call.

    (a) Qwen1.5-4B whole, bf16, on the `lm` phase's weights (the mesh
    server's DTensors wrap the same storage) at batch 8, capacity 552:
    streams and flash launches (number and shapes) equal, prefill logits
    bit-equal, one decode graph per (batch, capacity), and decode ms a
    step and prefill s a run in alternating pairs.  (b) the sparse-FFN
    Qwen, full width, `MESH_SPARSE_LAYERS` layers: every vsmm launch
    bf16, 3 a layer a forward (the rank's ``wo`` shards merged into one
    CSR), logits within `LOGITS_RTOL` of the mesh-free path's.  (c)
    Granite-MoE whole: streams equal, prefill logits bit-equal."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.models.layers import init_params
    from repro_torch.models import transformer as tfm

    mesh = make_local_mesh()
    out = {"mesh": "data1xmodel1", "world": 1}
    # (a) Qwen1.5-4B dense, whole
    cfg = get_config(LM_CONFIG)
    srv0 = lm["srv"]
    srv1 = Server(cfg, batch=LM_BATCH, capacity=LM_CAPACITY,
                  params=srv0.params, device=dev, mesh=mesh)
    pair = _served_pair(srv0, srv1, lm["traffic"], LM_CONFIG)
    graphs = list(srv1.backend.graphs)
    if graphs != [(LM_BATCH, LM_CAPACITY)]:
        raise SystemExit(f"chip_smoke: mesh {LM_CONFIG}: decode graphs "
                         f"{graphs}")
    gen = torch.Generator().manual_seed(5)
    probe = torch.randint(0, cfg.vocab, (LM_BATCH, 512),
                          generator=gen).to(dev)
    y0, y1 = _prefill_pair(srv0, srv1, cfg, probe, mesh)
    if not torch.equal(y0, y1):
        raise SystemExit(f"chip_smoke: mesh {LM_CONFIG}: prefill logits "
                         f"differ, max |d| {float((y0 - y1).abs().max())}")
    out[LM_CONFIG] = {**pair, "prefill_logits_bit_equal": True,
                      "decode_graphs": len(graphs),
                      "timing": _alternate(srv0, srv1, lm["traffic"])}
    del srv1, y0, y1
    # (b) the sparse-FFN Qwen: the reference tree, served both ways
    cfg_s = _cut_depth(dataclasses.replace(
        get_config(LM_CONFIG), use_sparse_ffn=True), MESH_SPARSE_LAYERS)
    raw = init_params(tfm.lm_schema(cfg_s), 0, dtype=cfg_s.dtype,
                      device=dev, draw_on_device=True)
    capacity = 128 + 2 * LM_ARCH_NEW + 8
    srv0 = Server(cfg_s, batch=LM_BATCH, capacity=capacity, params=raw,
                  device=dev)
    srv1 = Server(cfg_s, batch=LM_BATCH, capacity=capacity, params=raw,
                  device=dev, mesh=mesh)
    traffic = [(r.rid, r.prompt, r.max_new) for r in _arch_traffic(
        cfg_s.vocab, 8, (113, 129), seed=1)]
    reqs = _lm_requests(traffic)
    counters = _counters()
    _zero_counters()
    stats = _lm_stats(srv1.serve(reqs))
    torch.cuda.synchronize()
    prefills = stats["runs"] + stats["backfills"]
    n_vsmm = _sparse_ffn_launches(cfg_s) * (
        prefills + stats["decode_steps"] + len(srv1.backend.graphs))
    vsmm = counters["vsmm"]
    if vsmm.launches != n_vsmm or vsmm.bf16_launches != n_vsmm:
        raise SystemExit(f"chip_smoke: mesh sparse FFN: vsmm {vsmm.launches}"
                         f" (bf16 {vsmm.bf16_launches}), expected {n_vsmm}")
    probe = torch.randint(0, cfg_s.vocab, (LM_BATCH, 128),
                          generator=gen).to(dev)
    y0, y1 = _prefill_pair(srv0, srv1, cfg_s, probe, mesh)
    rel = float((y0 - y1).abs().max() / y0.abs().max())
    if not rel <= LOGITS_RTOL:
        raise SystemExit(f"chip_smoke: mesh sparse FFN: logits rel {rel} > "
                         f"{LOGITS_RTOL}")
    free = _lm_requests(traffic)
    srv0.serve(free)
    out["qwen1.5-4b-sparse"] = {
        "layers": MESH_SPARSE_LAYERS, "vsmm_launches": n_vsmm,
        "vsmm_per_layer_forward": 3, "all_bf16": True,
        "prefill_logits_rel": rel,
        "prefill_logits_bit_equal": bool(torch.equal(y0, y1)),
        "streams_equal_mesh_free": [r.out for r in reqs] == [
            r.out for r in free], **stats}
    del srv0, srv1, raw, y0, y1
    _free_cuda()
    # (c) Granite-MoE whole
    cfg_m = get_config("granite-moe-3b-a800m")
    raw = init_params(tfm.lm_schema(cfg_m), 0, dtype=cfg_m.dtype,
                      device=dev, draw_on_device=True)
    capacity = 128 + 2 * LM_ARCH_NEW + 8
    srv0 = Server(cfg_m, batch=LM_BATCH, capacity=capacity, params=raw,
                  device=dev)
    srv1 = Server(cfg_m, batch=LM_BATCH, capacity=capacity, params=raw,
                  device=dev, mesh=mesh)
    traffic = [(r.rid, r.prompt, r.max_new) for r in _arch_traffic(
        cfg_m.vocab, MESH_MOE_REQUESTS, (113, 129), seed=1)]
    pair = _served_pair(srv0, srv1, traffic, cfg_m.name)
    probe = torch.randint(0, cfg_m.vocab, (LM_BATCH, 128),
                          generator=gen).to(dev)
    y0, y1 = _prefill_pair(srv0, srv1, cfg_m, probe, mesh)
    if not torch.equal(y0, y1):
        raise SystemExit(f"chip_smoke: mesh {cfg_m.name}: prefill logits "
                         f"differ, max |d| {float((y0 - y1).abs().max())}")
    out[cfg_m.name] = {**pair, "prefill_logits_bit_equal": True}
    del srv0, srv1, raw, y0, y1
    _free_cuda()
    print(json.dumps({"phase": "mesh_lm", **{
        k: ({kk: vv for kk, vv in v.items() if kk != "flash_shapes"}
            if isinstance(v, dict) else v) for k, v in out.items()}}),
        flush=True)
    return out


def mesh_kernel_cases(timer: Timer, dev, bf16_peak: float,
                      served: dict) -> dict:
    """(e) The two kernels whose shapes a mesh changes, at the rank-local
    shapes of a 2x2 mesh and of a `MESH_TP`-way model dim, each against
    its plain version on the card (`Timer.run`: bound, library time):

    * flash, Qwen1.5-4B ``sp`` at batch 8, T 512: each rank's 512 / 4
      queries at ``q_offset`` r x 128 against all 512 keys (BH 160, hd
      128, bf16; r = 0..3), and Gemma-3-12B ``heads`` / 4 (BH 8 x 16 / 4,
      T 1600, hd 240, global causal);
    * vsmm bf16, Qwen1.5-4B's sparse FFN on a 4-way model dim: one rank's
      ``wi`` gate strips (16 of 64) and its ``wo`` CSR (its 4 of 16
      shards merged), at M 8 (decode) and 1024 (prefill);
    * vsmm f32 and int8, ResNet-50's 1000-class head split 4 ways (2 of
      8 strips a rank), at batch 8, the serve phase's weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.vector_sparse import VectorSparse
    from repro_torch.kernels.flash import (flash_fwd_kernel,
                                           flash_fwd_plain, kernel_body)
    from repro_torch.models import sparse_lm
    from repro_torch.models.layers import init_params
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(7)
    rows = {}
    bf = torch.bfloat16
    cases = [(f"mesh flash Qwen sp rank {r}/4: BH 160 Tq 128 at q_offset "
              f"{128 * r}, Tk 512, hd 128 bf16", 160, 128, 512, 128, True,
              None, 128 * r) for r in range(MESH_TP)]
    cases.append(("mesh flash Gemma-3 heads/4: BH 32 T 1600 hd 240 causal "
                  "bf16", 32, 1600, 1600, 240, True, None, 0))
    for label, bh, tq, tk, hd, causal, window, q_offset in cases:
        q, k, v = (torch.randn(bh, t, hd, generator=gen).to(dev, bf)
                   for t in (tq, tk, tk))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        mask = _attn_mask(tq, tk, causal, window, q_offset, dev)
        pairs = int(mask.sum())
        lib = lambda q=q[None], k=k[None], v=v[None], m=mask: \
            F.scaled_dot_product_attention(q, k, v, attn_mask=m)
        rows[label] = timer.run(
            label, "flash_fwd",
            lambda q=q, k=k, v=v, kw=kw: flash_fwd_kernel(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: flash_fwd_plain(q, k, v, **kw),
            lib, flops=4 * bh * pairs * hd,
            nbytes=_nbytes(q, k, v) + q.numel() * q.element_size(),
            reps=10, rtol=BF16_RTOL, peak_flops=bf16_peak, body=kernel_body(bf),
            mesh="2x2 sp" if "sp" in label else f"model {MESH_TP}")
    # vsmm bf16 at one rank's shard of Qwen's sparse FFN (tp_hint 16)
    cfg = get_config(LM_CONFIG)
    ffn = init_params(sparse_lm.sparse_mlp_schema(cfg, cfg.sparsity), 0,
                      dtype=bf, device=dev, draw_on_device=True)
    nb_i = ffn["wi_vals"].shape[1] // MESH_TP
    n_loc = cfg.tp_hint // MESH_TP
    wo_v, wo_i = sparse_lm.merge_wo(ffn["wo_vals"][:n_loc],
                                    ffn["wo_idx"][:n_loc],
                                    cfg.d_ff // MESH_TP)
    wi = VectorSparse(vals=ffn["wi_vals"][0, :nb_i].contiguous(),
                      idx=ffn["wi_idx"][0, :nb_i].contiguous(),
                      shape=(cfg.d_model, nb_i * ffn["wi_vals"].shape[-1]))
    wo = VectorSparse(vals=wo_v, idx=wo_i,
                      shape=(cfg.d_ff // MESH_TP, cfg.d_model))
    for m in (8, 1024):
        for name, vs in (("wi gate strips 16 of 64", wi),
                         (f"wo CSR ({n_loc} of 16 shards merged)", wo)):
            x = torch.randn(m, vs.shape[0], generator=gen).to(dev, bf)
            label = f"mesh vsmm bf16 Qwen {name}, model {MESH_TP}, M {m}"
            rows[label] = _bf16_case(timer, label, x, vs, bf16_peak, reps=10)
    del ffn
    # vsmm f32 / int8 at one rank's strips of ResNet-50's head
    from repro_torch.models.graph import quantize_activations_int8
    for path in FLEET_PATHS:
        fc = served[path]["srv"].sparse["fc"]
        int8 = fc.scale is not None
        nb = fc.vs.vals.shape[0] // MESH_TP
        vs = VectorSparse(vals=fc.vs.vals[:nb].contiguous(),
                          idx=fc.vs.idx[:nb].contiguous(),
                          shape=(fc.vs.shape[0], nb * fc.vs.vals.shape[-1]))
        x = torch.relu(torch.randn(BATCH, vs.shape[0], generator=gen)).to(dev)
        cols = slice(0, vs.shape[1])
        bias = F.pad(fc.bias, (0, fc.vs.shape[1] - fc.bias.shape[0]))[cols]
        quant = None
        if int8:
            x, sx = quantize_activations_int8(x)
            quant = (sx, fc.scale[cols])
        label = (f"mesh vsmm {'int8' if int8 else 'f32'} ResNet-50 head, "
                 f"model {MESH_TP}: {nb} of {fc.vs.vals.shape[0]} strips, "
                 f"M {BATCH}")
        rows[label] = _mm_case(timer, label, x, vs, n_real=vs.shape[1],
                               bias=bias, quant=quant)
    _free_cuda()
    return rows


MESH_CONV_PATHS = ("resnet50-halo", "resnet50-int8-halo",
                   "mobilenet_v1-halo")
MESH_CONV_LAYERS = ("layer4_0_conv2", "layer4_1_conv2")   # (d): 4 strips


def mesh_conv_phase(served: dict, dev) -> dict:
    """(a) `MESH_CONV_PATHS` served by `CNNServer(shard_fc=True)` in the
    one-rank world with ``conv`` on ``model``: every conv entry a
    DTensor, the same images as the mesh-free server (both warm),
    logits bit-equal and the same launches by kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import SparseConv
    from repro_torch.parallel import sharding as shd
    from torch.distributed.tensor import DTensor

    rules = shd.SERVE_RULES.replace(conv="model")
    out = {}
    for path in MESH_CONV_PATHS:
        s = served[path]
        cfg_name, impl, dtype = PATHS[path][:3]
        srv_m = CNNServer(get_config(cfg_name), batch=BATCH, impl=impl,
                          dtype=dtype, seed=0, shard_fc=True, device=dev,
                          rules=rules)
        convs = [e for e in srv_m.group.backends[0].apply.sparse.values()
                 if isinstance(e, SparseConv)]
        n_dt = sum(isinstance(e.vs.vals, DTensor) for e in convs)
        if not convs or n_dt != len(convs):
            raise SystemExit(f"chip_smoke: mesh conv {path}: {n_dt} of "
                             f"{len(convs)} conv entries are DTensors")
        runs = []
        for srv in (s["srv"], srv_m):
            srv.serve([ImageRequest(rid=i, image=im)  # graphs captured
                       for i, im in enumerate(s["images"])])
            reqs = [ImageRequest(rid=i, image=im)
                    for i, im in enumerate(s["images"])]
            counters = _counters()
            _zero_counters()
            srv.serve(reqs)
            torch.cuda.synchronize()
            suffix = "_int8" if dtype == "int8" else ""
            runs.append(({n + suffix: k.launches for n, k in counters.items()
                          if k.launches},
                         np.stack([r.logits for r in reqs])))
        (l0, y0), (l1, y1) = runs
        if not np.array_equal(y0, y1) or l0 != l1:
            raise SystemExit(f"chip_smoke: mesh conv {path}: logits "
                             f"bit-equal {np.array_equal(y0, y1)} (max |d| "
                             f"{float(np.abs(y0 - y1).max())}), launches "
                             f"{l1} against {l0}")
        out[path] = {"logits_bit_equal": True, "launches": l1,
                     "conv_dtensors": len(convs), "requests": len(y1)}
        del srv_m
        _free_cuda()
    print(json.dumps({"phase": "mesh_conv", **out}), flush=True)
    return out


def mesh_conv_cases(timer: Timer, dev, served: dict) -> dict:
    """(d) ResNet-50's 3x3 convs that a `MESH_TP`-way ``conv`` rule
    shards (`MESH_CONV_LAYERS`, 4 strips each), one rank's quarter of
    their strips at their real input shapes (batch 8, 224 px), f32 and
    int8, against their plain versions (`_conv_case`: bound, cuDNN)."""
    import torch
    from repro_torch.core.vector_sparse import VectorSparse
    from repro_torch.models.graph import quantize_activations_int8

    gen = torch.Generator().manual_seed(11)
    hw = {"layer4_0_conv2": (14, 2), "layer4_1_conv2": (7, 1)}
    rows = {}
    for path in FLEET_PATHS:
        sparse = served[path]["srv"].sparse
        for name in MESH_CONV_LAYERS:
            spec = sparse[name]
            nb = spec.vs.vals.shape[0]
            if nb % MESH_TP:
                raise SystemExit(f"chip_smoke: {name}: {nb} strips do not "
                                 f"split {MESH_TP} ways")
            n_l = nb // MESH_TP
            vs = VectorSparse(vals=spec.vs.vals[:n_l].contiguous(),
                              idx=spec.vs.idx[:n_l].contiguous(),
                              shape=(spec.vs.shape[0],
                                     n_l * spec.vs.vals.shape[-1]))
            size, stride = hw[name]
            cin = spec.vs.shape[0] // 9
            x = torch.relu(torch.randn(BATCH, size, size, cin,
                                       generator=gen)).to(dev)
            cols = slice(0, vs.shape[1])
            quant = None
            if spec.scale is not None:
                x, sx = quantize_activations_int8(x)
                quant = (sx, spec.scale[cols].contiguous())
            label = (f"mesh conv ResNet-50 {name} "
                     f"{'int8' if quant else 'f32'}, model {MESH_TP}: "
                     f"{n_l} of {nb} strips, {size}px s{stride}")
            rows[label] = _conv_case(
                timer, label, x, vs, kh=3, stride=stride, cin_real=cin,
                bias=spec.bias[cols].contiguous(), relu=True, quant=quant,
                reps=10)
    _free_cuda()
    return rows


ADAM8_STEPS = 3


def adamw8bit_phase(dev) -> dict:
    """(b) `optim.adamw8bit`: `ADAM8_STEPS` updates of one Qwen1.5-4B
    layer group's params (full width, bf16) by seeded gradients at lr
    1e-3, three ways: laid out on the one-rank world's 1x1 mesh
    (DTensors; moments replicated), mesh-free on the card, mesh-free on
    the CPU.  Codes, scales and params bit-equal across all three."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import axes_tree, init_params
    from repro_torch.optim.optimizers import adamw8bit
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import leaves, tree_map

    t0 = time.perf_counter()
    cfg = get_config(LM_CONFIG)
    cfg = dataclasses.replace(cfg, segments=(dataclasses.replace(
        cfg.segments[0], repeat=1),), n_layers=len(cfg.segments[0].layers))
    schema = tfm.lm_schema(cfg)["segments"][0]
    host = init_params(schema, 0, dtype=cfg.dtype, device="cpu")
    gen = torch.Generator().manual_seed(5)
    grads = [tree_map(lambda p: (0.01 * torch.randn(
        p.shape, generator=gen)).to(p.dtype), host)
        for _ in range(ADAM8_STEPS)]
    ctx = shd.MeshContext(make_local_mesh(1, 1), shd.TRAIN_RULES)
    axes = axes_tree(schema)

    def run(device, mesh: bool) -> list:
        def lay(tree):
            tree = tree_map(lambda t: t.to(device, copy=True), tree)
            if not mesh:
                return tree
            return tree_map(lambda a, t: shd.distribute(t, a, ctx=ctx),
                            axes, tree, is_leaf=lambda n: isinstance(n, tuple))
        params = lay(host)
        opt = adamw8bit()
        state = opt.init(params)
        for g in grads:
            opt.update_(lay(g), state, params, 1e-3)
        whole = [x.full_tensor() if hasattr(x, "full_tensor") else x
                 for x in leaves(params) + leaves(state["moments"])]
        return [x.cpu() for x in whole]

    sides = {"mesh_1x1": run(dev, True), "card": run(dev, False),
             "cpu": run(torch.device("cpu"), False)}
    equal = {side: all(torch.equal(a, b) for a, b in
                       zip(vals, sides["cpu"]))
             for side, vals in sides.items() if side != "cpu"}
    n = sum(x.numel() for x in leaves(host))
    out = {"phase": "adamw8bit", "config": cfg.name,
           "params": n, "leaves": len(leaves(host)), "steps": ADAM8_STEPS,
           "dtype": cfg.param_dtype, "bit_equal_to_cpu": equal,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    if not all(equal.values()):
        raise SystemExit(f"chip_smoke: adamw8bit: codes, scales and params "
                         f"bit-equal to the CPU: {equal}")
    return out


CHUNK_ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")
CHUNK_LAYERS = 8
CHUNK_SEQ = 2048


def chunked_scan_phase(dev, smi: str) -> dict:
    """(c) One training step's loss and gradients (`step_builders.
    _grads_of`) of `CHUNK_ARCHS` at full width, `CHUNK_LAYERS` layers, T
    `CHUNK_SEQ`, batch 1: chunked (the config's ``scan_chunk``) and one
    chunk of T (``scan_chunk`` T) where its meta peak fits the free card.
    Loss and gradient fingerprints bit-equal; ``max_memory_allocated``
    of each (less what earlier phases left allocated: the card's
    allocation before the step beyond the step's arguments); the
    chunked step's meta count, arguments + temporaries, within
    `DRYRUN_MEMORY_RTOL` of that peak (one chunk's error reported)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params
    from repro_torch.utils.cost import count

    out = {}
    for name in CHUNK_ARCHS:
        t0 = time.perf_counter()
        base = dataclasses.replace(_cut_depth(get_config(name), CHUNK_LAYERS),
                                   microbatches=1)
        _free_cuda()
        params = init_params(tfm.lm_schema(base), 0, dtype=base.dtype,
                             device=dev, draw_on_device=True)
        rng = np.random.default_rng(3)
        batch = {k: torch.from_numpy(rng.integers(
            0, base.vocab, (1, CHUNK_SEQ), dtype=np.int32)).to(dev)
            for k in ("tokens", "labels")}
        meta_p = sb.param_structs(base)
        meta_b = {k: torch.empty((1, CHUNK_SEQ), dtype=torch.int32,
                                 device="meta") for k in batch}
        sides = {}
        for chunk in (base.scan_chunk, CHUNK_SEQ):
            cfg = dataclasses.replace(base, scan_chunk=chunk)
            meta = count(sb._grads_of, meta_p, meta_b, cfg)[1]
            meta_peak = meta.arg_bytes + meta.temp_bytes
            side = {"scan_chunk": chunk, "meta_peak_gb": meta_peak / 1e9,
                    "meta_temp_gb": meta.temp_bytes / 1e9}
            sides["chunked" if chunk < CHUNK_SEQ else "one_chunk"] = side
            free, _ = torch.cuda.mem_get_info()
            side["fits"] = meta.temp_bytes <= 0.9 * free
            if not side["fits"]:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # what earlier phases left allocated is not this step's
            other = torch.cuda.memory_allocated() - meta.arg_bytes
            t1 = time.perf_counter()
            try:
                loss, _, grads = sb._grads_of(params, batch, cfg)
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                if chunk < CHUNK_SEQ:
                    raise
                side["fits"] = False   # one chunk of T only
                _free_cuda()
                continue
            side.update(
                fits=True, step_s=time.perf_counter() - t1,
                loss=float(loss), other_allocated_gb=other / 1e9,
                peak_allocated_gb=(torch.cuda.max_memory_allocated()
                                   - other) / 1e9,
                fingerprints=_fingerprint(grads) + _fingerprint([loss]))
            side["memory_rel_err"] = abs(
                meta_peak / 1e9 - side["peak_allocated_gb"]) / \
                side["peak_allocated_gb"]
            del loss, grads
            _free_cuda()
        c, p = sides["chunked"], sides["one_chunk"]
        row = {"phase": "chunked_scan", "config": name,
               "layers": CHUNK_LAYERS, "seq": CHUNK_SEQ, "batch": 1,
               **{k: {kk: vv for kk, vv in v.items() if kk != "fingerprints"}
                  for k, v in sides.items()},
               "bit_equal": (None if not p["fits"] else
                             c["fingerprints"] == p["fingerprints"]),
               "seconds": time.perf_counter() - t0, "gpu": smi}
        print(json.dumps(row), flush=True)
        if not c["fits"] or row["bit_equal"] is False or \
                c["memory_rel_err"] > DRYRUN_MEMORY_RTOL:
            raise SystemExit(f"chip_smoke: chunked scan {name}: {row}")
        out[name] = row
        del params
        _free_cuda()
    return out


def _layer_inputs(net, params, sparse, x, impl: str) -> dict:
    """{layer name: its input} over one forward of ``x``: each conv's
    NHWC input (``net_apply``'s ``collect``) and each FC's (N, din) input
    (its ``collect_fc``)."""
    import torch
    from repro_torch.models.graph import net_apply

    rec: list = []
    fc_rec: list = []
    with torch.inference_mode():
        net_apply(net, params, x, sparse=sparse, impl=impl, collect=rec,
                  collect_fc=fc_rec)
    return {name: xin for name, xin, *_ in rec + fc_rec}


def forward_phase(timer: Timer, path: str, srv, images, dev, *,
                  stack_layers_only: bool = False) -> None:
    """Every sparse layer of one batch-8 forward of the path at its real
    input (``stack_layers_only``: only the layers that run a stack
    kernel, where the path's halo twin times the rest).  On an int8 path
    each layer's input is quantized as the path does it (its scale times
    the layer's weight scales is the kernel's combined scale).  A conv's
    residual is a seeded tensor of the output's shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models.graph import (Conv, FC,
                                          quantize_activations_int8)

    gen = torch.Generator().manual_seed(1)
    layout = "stack" if srv.backend.apply.impl == "pallas-stack" else "halo"
    x = torch.from_numpy(np.stack(images[:BATCH])).to(dev)
    inputs = _layer_inputs(srv.net, srv.params, srv.sparse, x,
                           srv.backend.apply.impl)

    def quantized(xin, spec):
        """(layer input, quant) as the path's kernel sees it."""
        if spec.scale is None:
            return xin, None
        xq, sx = quantize_activations_int8(xin)
        return xq, (sx, spec.scale)

    for l in srv.net.layers:
        if not isinstance(l, (Conv, FC)):
            continue
        pointwise = isinstance(l, FC) or (l.kh == 1 and l.kw == 1)
        if stack_layers_only and pointwise:
            continue
        label = f"forward {path} {l.name}"
        if isinstance(l, Conv):
            spec = srv.sparse[l.name]
            xin, quant = quantized(inputs[l.name], spec)
            cin_real = xin.shape[3]
            if spec.cin_pad:
                xin = F.pad(xin, (0, spec.cin_pad))
            ho = -(-xin.shape[1] // l.stride)
            res = None
            if l.residual:
                res = torch.randn(BATCH, ho, ho, l.cout, generator=gen
                                  ).to(dev)
            if pointwise:
                xs = xin[:, ::l.stride, ::l.stride].reshape(-1, xin.shape[3])
                row = _mm_case(timer, label, xs.contiguous(), spec.vs,
                               n_real=l.cout, bias=spec.bias, relu=l.relu,
                               residual=None if res is None
                               else res.reshape(-1, l.cout), quant=quant)
            elif l.groups == l.cin and l.groups > 1:
                row = _dw_case(timer, label, xin, spec.vs, stride=l.stride,
                               layout=layout, bias=spec.bias, residual=res,
                               relu=l.relu, quant=quant)
            else:
                row = _conv_case(timer, label, xin, spec.vs, kh=l.kh,
                                 stride=l.stride, cin_real=cin_real,
                                 groups=l.groups, layout=layout,
                                 bias=spec.bias, residual=res, relu=l.relu,
                                 quant=quant)
        else:
            spec = srv.sparse[l.name]
            n_enc = spec.vs.shape[1]
            bias = F.pad(spec.bias, (0, n_enc - spec.bias.shape[0]))
            xin, quant = quantized(inputs[l.name], spec)
            row = _mm_case(timer, label, xin, spec.vs,
                           n_real=spec.bias.shape[0], bias=bias, relu=l.relu,
                           quant=quant)
        timer.add(path, row)


def dense_vs_sparse_phase(srv, images, dev) -> dict:
    """The paper's comparison on this card: VGG-16's device ms for one
    batch-8, 224 px forward, summed over its 13 convs and 3 FCs, each at
    its real input, each call timed alone (`_device_ms`):

    (a) density 0.235 (the served weights) with the input-side skip on:
        the served forward;
    (b) the same with ``skip_zero_inputs=False``: the same bits per layer;
    (c) density 1.0 with the skip off: the dense network on the same
        kernels, at its own activations;
    (d) the dense network through cuDNN convs and cuBLAS matmuls, f32,
        TF32 off, bias included (the ReLUs, fused into the kernels, and
        the pools are in none of the four).

    Each sparse call is the dispatch (`kernels.ops`: the halo buffer's
    pad, then the kernel); each cuDNN call pads SAME itself.  Per layer,
    (c) must equal relu?(d) within 1e-5 relative."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.kernels import ops as kops
    from repro_torch.models.graph import FC, Conv

    cfg, net, params = srv.cfg, srv.net, srv.params
    x = torch.from_numpy(np.stack(images[:BATCH])).to(dev)
    dense_sparse, _ = net.sparsify(params, 1.0, vk=cfg.vk, vn=cfg.vn)
    layers = [l for l in net.layers if isinstance(l, (Conv, FC))]

    def sparse_calls(sparse, inputs, skip: bool) -> dict:
        calls = {}
        for l in layers:
            spec, xin = sparse[l.name], inputs[l.name]
            if isinstance(l, Conv):
                xin = F.pad(xin, (0, spec.cin_pad)) if spec.cin_pad else xin
                calls[l.name] = lambda xin=xin, spec=spec, l=l: kops.vsconv(
                    xin, spec.vs, kh=l.kh, kw=l.kw, stride=l.stride,
                    bias=spec.bias, fuse_relu=l.relu, impl="halo",
                    skip_zero_inputs=skip)
            else:
                n_enc = spec.vs.shape[1]
                bias = F.pad(spec.bias, (0, n_enc - spec.bias.shape[0]))
                calls[l.name] = lambda xin=xin, spec=spec, l=l, b=bias: \
                    kops.vsmm(xin, spec.vs, bias=b, fuse_relu=l.relu,
                              skip_zero_inputs=skip)
        return calls

    def library_calls(inputs) -> dict:
        calls = {}
        for l in layers:
            p, xin = params[l.name], inputs[l.name]
            if isinstance(l, Conv):
                _, pt, pb = same_pads(xin.shape[1], l.kh, l.stride)
                _, pl, pr = same_pads(xin.shape[2], l.kw, l.stride)
                xl = F.pad(xin, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
                wl = p["w"].permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                calls[l.name] = lambda xl=xl, wl=wl, b=p["b"], s=l.stride: \
                    F.conv2d(xl, wl, b, s)
            else:
                calls[l.name] = lambda xin=xin, w=p["w"], b=p["b"]: \
                    torch.addmm(b, xin, w)
        return calls

    sparse_in = _layer_inputs(net, params, srv.sparse, x, "auto")
    dense_in = _layer_inputs(net, params, dense_sparse, x, "auto")
    variants = {"a": sparse_calls(srv.sparse, sparse_in, True),
                "b": sparse_calls(srv.sparse, sparse_in, False),
                "c": sparse_calls(dense_sparse, dense_in, False),
                "d": library_calls(dense_in)}
    per_layer = {}
    for l in layers:
        ys = {k: v[l.name]() for k, v in variants.items()}
        torch.cuda.synchronize()
        if not torch.equal(ys["a"], ys["b"]):
            raise SystemExit(f"chip_smoke: VGG-16 {l.name}: skip off "
                             f"differs from skip on")
        ref = ys["d"].permute(0, 2, 3, 1) if ys["d"].dim() == 4 else ys["d"]
        ref = torch.relu(ref) if l.relu else ref
        _check(f"VGG-16 {l.name} density 1.0 kernel vs cuDNN/cuBLAS",
               ys["c"][..., :ref.shape[-1]], ref)
        per_layer[l.name] = {k: _device_ms(v[l.name], 5)
                             for k, v in variants.items()}
    sums = {k: sum(t[k] for t in per_layer.values()) for k in variants}
    out = {"phase": "dense_vs_sparse", "config": cfg.name, "batch": BATCH,
           "image_size": SIZE, "density": srv.density,
           "a_sparse_skip_on_ms": sums["a"],
           "b_sparse_skip_off_ms": sums["b"],
           "c_dense_weights_same_kernels_skip_off_ms": sums["c"],
           "d_dense_cudnn_cublas_f32_ms": sums["d"],
           "c_over_a": sums["c"] / sums["a"],
           "b_over_a": sums["b"] / sums["a"],
           "d_over_a": sums["d"] / sums["a"],
           "paper_vgg16_speedup_over_dense": 1.93,
           "paper_note": "the paper's 1.93x is its own 168-PE array's "
                         "cycle count (density 0.235 vs dense), not this "
                         "card",
           "per_layer_ms": per_layer}
    return out


def _quiet(fn, *args, **kw):
    """(fn's result, what it printed): the phases below keep the long
    tables of the tools they drive in the JSON file, not on stdout."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


VSCHECK_ARGS = ["--all-nets", "--size", str(SIZE), "--batch", str(BATCH)]


def vscheck_phase() -> dict:
    """vscheck's three passes (`repro_torch.analysis`) over the five nets
    at 224 px, batch 8 (IR, the layout and cost contract of every kernel
    plan under f32 and int8, the lint of the port's tree), then its
    selftest, which must catch every seeded violation.  Both must return
    0."""
    from repro_torch.analysis import main as vscheck

    t0 = time.perf_counter()
    rc, log = _quiet(vscheck, VSCHECK_ARGS)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_self, self_log = _quiet(vscheck, ["--selftest"])
    self_s = time.perf_counter() - t0
    if rc or rc_self:
        raise SystemExit(f"chip_smoke: vscheck {VSCHECK_ARGS} returned {rc}, "
                         f"--selftest {rc_self}:\n{log}\n{self_log}")
    plans = re.search(r"contracts: (\d+) kernel plans", log)
    files = re.search(r"lint: (\d+) files", log)
    out = {"phase": "vscheck", "args": VSCHECK_ARGS, "returned": rc,
           "kernel_plans": int(plans.group(1)),
           "lint_files": int(files.group(1)),
           "summary": log.strip().splitlines()[-1], "seconds": check_s,
           "selftest_returned": rc_self,
           "selftest_caught": self_log.count("caught"),
           "selftest_seconds": self_s}
    print(json.dumps(out), flush=True)
    return out


def calibration_phase(dev) -> dict:
    """The cost model's drift gate (`calibrate_torch.gate_calibration`)
    against the committed ``src/repro_torch/baselines/CALIB_cuda.json``:
    ResNet-18's 21 gated layers re-measured at 224 px, batch 8, through
    the kernels (each layer a CUDA graph, timed by CUDA events).  The
    constants must reproduce every stored prediction exactly, the model's
    features stay within 2%, and every layer's measured time, normalized
    by the median measured/predicted ratio (the machine's scale), within
    4x of its prediction."""
    import calibrate_torch

    gate, table = _quiet(calibrate_torch.gate_calibration, None, device=dev)
    if gate["failures"]:
        raise SystemExit("chip_smoke: calibration drift gate failed:\n"
                         + table)
    name, ratio = gate["worst"]
    out = {"phase": "calibration", "layers": gate["layers"],
           "scale": gate["scale"], "worst_layer": name,
           "worst_normalized_ratio": ratio, "failures": 0}
    print(json.dumps(out), flush=True)
    out["table"] = gate["lines"]
    return out


CYCLE_AGREEMENT = 1e-3   # kernel-path vs plain-path activations, vscnn cycles


def paper_model_phase(srv, images, dense_vs_sparse: dict, dev) -> dict:
    """The paper's PE-array cycle model (`core.accel_model`) on VGG-16 at
    density 0.235: one 224 px image through the served halo path on the
    card (`collect_conv_traffic`: every conv's real input, the kernels'
    activations), then `network_cycle_reports` on each of the config's
    ``pe_configs`` (the paper's two 168-PE arrays), beside the config's
    ``paper_*`` points and the card's own dense/sparse forward ratio
    (`dense_vs_sparse_phase`, (d)/(a)).  The same model over the same
    image's plain-path activations on the card must agree within 0.1% in
    vscnn cycles (only a ReLU output at f32 noise around 0 can differ)."""
    import numpy as np
    import torch
    from repro_torch.core.accel_model import aggregate, network_cycle_reports
    from repro_torch.core.vector_sparse import decode
    from repro_torch.models.graph import collect_conv_traffic

    cfg, net = srv.cfg, srv.net
    # the pruned dense weights the cycle model reads, decoded from the
    # served encoding (what `sparsify` returns as its pruned tree)
    params = dict(srv.params)
    for l in net.conv_layers():
        spec = srv.sparse[l.name]
        w = decode(spec.vs).reshape(l.kh, l.kw, l.cin + spec.cin_pad, l.cout)
        params[l.name] = {"w": w[:, :, :l.cin], "b": spec.bias}
    x = torch.from_numpy(np.asarray(images[0])[None]).to(dev)
    t0 = time.perf_counter()
    traffic = {impl: collect_conv_traffic(net, params, x, sparse=srv.sparse,
                                          impl=impl)
               for impl in ("auto", "plain")}
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    models = []
    for i, pe in enumerate(cfg.pe_configs):
        agg = {impl: aggregate([r for _, r in network_cycle_reports(t, pe)])
               for impl, t in traffic.items()}
        r, plain = agg["auto"], agg["plain"]
        if plain.dense != r.dense or \
                abs(plain.vscnn - r.vscnn) > CYCLE_AGREEMENT * r.vscnn:
            raise SystemExit(
                f"chip_smoke: VGG-16 cycle model on PE {pe}: kernel-path "
                f"activations give {r.vscnn} vscnn / {r.dense} dense "
                f"cycles, plain-path {plain.vscnn} / {plain.dense}")
        models.append({
            "pe": f"{pe.blocks}x{pe.rows}x{pe.cols}", "n_pe": pe.n_pe,
            "dense_cycles": r.dense, "vscnn_cycles": r.vscnn,
            "ideal_vector_cycles": r.ideal_vector,
            "ideal_fine_cycles": r.ideal_fine,
            "speedup": r.speedup,
            "frac_ideal_vector": r.frac_ideal_vector_exploited,
            "frac_ideal_fine": r.frac_ideal_fine_exploited,
            "plain_path_vscnn_cycles": plain.vscnn,
            "paper_speedup": cfg.paper_speedup[i],
            "paper_frac_ideal_vector": cfg.paper_frac_ideal_vector[i],
            "paper_frac_ideal_fine": cfg.paper_frac_ideal_fine[i]})
    out = {"phase": "paper_model", "config": cfg.name, "image_size": SIZE,
           "images": 1, "density": srv.density,
           "conv_layers": len(traffic["auto"]), "pe_configs": models,
           "card_dense_over_sparse_forward": dense_vs_sparse["d_over_a"],
           "forward_s": forward_s,
           "model_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


# kernel -> (CUDA source, the Pallas function it replaces); a "_int8"
# kernel is the int8 branch of the same CUDA kernel and Pallas function
SOURCES = {
    "vsconv_halo": ("src/repro_torch/kernels/csrc/vsconv.cu",
                    "src/repro/kernels/vsconv.py:623"),
    "vsmm": ("src/repro_torch/kernels/csrc/vsmm.cu",
             "src/repro/kernels/vsmm.py:172"),
    "vsconv_dw_halo": ("src/repro_torch/kernels/csrc/vsconv_dw.cu",
                       "src/repro/kernels/vsconv.py:1020"),
    "vsconv_stack": ("src/repro_torch/kernels/csrc/vsconv.cu",
                     "src/repro/kernels/vsconv.py:833"),
    "vsconv_dw_stack": ("src/repro_torch/kernels/csrc/vsconv_dw.cu",
                        "src/repro/kernels/vsconv.py:1162"),
}
SOURCES.update({f"{k}_int8": SOURCES[k] for k in list(SOURCES)})


def int8_instantiations(logs: dict) -> list:
    """One row per int8 kernel instantiation (``vsmm_int8_kernel`` per RT
    and SPLIT and its phase 2 ``vsmm_int8_reduce_kernel``,
    ``vsconv_{halo,stack}_int8_kernel``, the int8 stem bodies
    ``vsconv_{halo,stack}_stem_int8_kernel`` per NC and C,
    ``vsconv_dw_{halo,stack}_int8_kernel`` per VC and VEC) with its
    registers and spill bytes."""
    rows = []
    for source in ("vsmm", "vsconv", "vsconv_dw"):
        for name, use in ptxas_usage(logs[source]).items():
            if source == "vsmm":
                row = _vsmm_row(name)
                if row is not None and row["kernel"].startswith("vsmm_int8"):
                    rows.append({**row, **use})
                continue
            gen = _generic_row(name)
            if gen is not None:
                if gen["kernel"].endswith(("_int8", "_int8_reduce")):
                    rows.append({**gen, **use})
                continue
            m = re.search(r"(vsconv_halo|vsconv_stack|vsconv_dw_halo|"
                          r"vsconv_dw_stack)_(stem_)?int8_kernel"
                          r"(?:ILi(\d+)ELi(\d+)E)?", name)
            if m:
                row = {"kernel": f"{m.group(1)}_{m.group(2) or ''}int8"}
                if m.group(3) and m.group(2):
                    row.update(vn=32 * int(m.group(3)), c=int(m.group(4)))
                elif m.group(3):
                    row.update(vc=int(m.group(3)), vec=int(m.group(4)))
                rows.append({**row, **use})
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _generic_row(name: str) -> dict | None:
    """vsconv.cu's generic-body entry functions, by layout: phase 1 with
    its tile (``rows`` x ``vn`` outputs; f32 ``vsconv_*_kernel<RT, CT,
    kFast>``: 16*RT x 16*CT; int8 ``vsconv_*_int8_kernel<MI, WC, kFast,
    kSplit>``: 8/WC*16*MI x 32*WC), whether it is a fast instantiation
    (vk 32) or the general one, and (int8) whether it keeps split sums;
    and phase 2 (``vsconv_*_reduce_kernel``).  A name without template
    arguments gives the kernel alone."""
    m = re.search(r"(vsconv_halo|vsconv_stack)_(int8_)?(reduce_)?kernel"
                  r"(I(?:L[ib]\d+E)+E)?", name)
    if m is None:
        return None
    row = {"kernel": m.group(1) + ("_int8" if m.group(2) else "")
           + ("_reduce" if m.group(3) else "")}
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(4) or "")]
    if m.group(2) and len(args) == 4:
        mi, wc, fast, split = args
        row.update(rows=8 // wc * 16 * mi, vn=32 * wc, fast=bool(fast),
                   split=bool(split))
    elif not m.group(2) and len(args) == 3:
        rt, ct, fast = args
        row.update(rows=16 * rt, vn=16 * ct, fast=bool(fast))
    return row


def generic_instantiations(log: str) -> list:
    """One row per instantiation of ``vsconv.cu``'s generic body (f32 and
    int8, both layouts, both phases) with its registers and spill
    bytes."""
    rows = [{**row, **use} for name, use in ptxas_usage(log).items()
            if (row := _generic_row(name)) is not None]
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _vsmm_row(name: str) -> dict | None:
    """vsmm.cu's entry functions: the phase-1 kernels per RT (rows a
    thread) and, for int8, SPLIT; the bf16 tensor-core kernels per row
    tile; the phase-2 reduce kernels."""
    m = re.search(r"vsmm_(int8_|bf16_)?(reduce_)?kernel"
                  r"(?:ILi(\d+)E(?:Lb([01])E)?)?", name)
    if m is None:
        return None
    row = {"kernel": "vsmm" + ("_" + m.group(1)[:-1] if m.group(1) else "")
           + ("_reduce" if m.group(2) else "")}
    if m.group(3):
        row["rows" if m.group(1) == "bf16_" else "rt"] = int(m.group(3))
    if m.group(4):
        row["split"] = m.group(4) == "1"
    return row


def vsmm_instantiations(log: str) -> list:
    """One row per instantiation of ``vsmm.cu`` (f32, bf16 and int8, both
    phases) with its registers and spill bytes."""
    rows = [{**row, **use} for name, use in ptxas_usage(log).items()
            if (row := _vsmm_row(name)) is not None]
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _vsmm_bf16_entry(timer: Timer, rows: dict, sparse: dict) -> dict:
    """The ``kernels`` line's entry of vsmm's bf16 branch: launches of the
    sparse-FFN serves (by path); ms, plain, bound and library per
    Qwen1.5-4B sparse decode step at batch 8 (40 layers x the gate, up and
    merged wo products at M 8: 120 launches), from `vsmm_bf16_cases`."""
    from repro_torch.configs import get_config

    layers = get_config("qwen1.5-4b").total_layers
    wi = rows[("qwen1.5-4b", "wi", BATCH)]
    wo = rows[("qwen1.5-4b", "wo merged", BATCH)]

    def per_step(key: str) -> float:
        return layers * (2 * wi[key] + wo[key])

    flops = per_step("flops_bound_ms")
    nbytes = per_step("bytes_bound_ms")
    by_path = {path: a["launches"].get("vsmm", 0)
               for path, a in sparse.items()}
    return {
        "name": "vsmm_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vsmm.cu",
        "replaces": "src/repro/kernels/vsmm.py:172",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": timer.max_abs_err["vsmm_bf16"],
        "ms": per_step("kernel_ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": max(flops, nbytes),
        "bound_by": "operations" if flops >= nbytes else "bytes",
        "library_ms": per_step("library_ms"),
        "host_loop_ms": per_step("kernel_host_loop_ms"),
        "per": f"one Qwen1.5-4B sparse-FFN decode step, batch {BATCH} "
               f"({3 * layers} launches)",
        "library": "torch.mm of bf16 x and the decoded bf16 weight, f32 out",
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every result line to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ImageRequest
    from repro_torch.utils.roofline import smi_name_and_power

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_name_and_power()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, bf16_peak, int8_peak = _peaks(name)

    t0 = time.perf_counter()
    logs = _build.build("vsmm", "vsconv", "vsconv_dw", "flash_fwd")
    build_s = time.perf_counter() - t0
    for kernel, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {kernel}: {'; '.join(regs)}")
    flash = flash_instantiations(_build.build_log("flash_fwd"))
    spills = [r for r in flash if r["body"] == "mma" and r["hd"] == 128]
    if len(spills) != 1 or spills[0]["spill_stores"] != 0 or \
            spills[0]["spill_loads"] != 0:
        print(f"chip_smoke: the bf16 hd-128 flash instantiation spills or "
              f"is missing: {spills}", file=sys.stderr)
        return 1
    stencils = stencil_instantiations(_build.build_log("vsconv"),
                                      _build.build_log("vsconv_dw"))
    for r in stencils:
        print(f"built {r}")
    spilled = [r for r in stencils if r["spill_stores"] or r["spill_loads"]
               or r["spill_stores"] is None]
    if len(stencils) != 26 or spilled:
        print(f"chip_smoke: {len(stencils)} stem and depthwise "
              f"instantiations (expected 26: 8 f32 and 8 int8 stem bodies, "
              f"10 dw), spilling or unread: {spilled}", file=sys.stderr)
        return 1
    int8_rows = int8_instantiations(
        {k: _build.build_log(k) for k in ("vsmm", "vsconv", "vsconv_dw")})
    for r in int8_rows:
        print(f"built {r}")
    spilled = [r for r in int8_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(int8_rows) != 42 or spilled:
        print(f"chip_smoke: {len(int8_rows)} int8 instantiations (expected "
              f"42: vsmm's 5 phase-1 and 1 phase-2 kernels, the generic "
              f"body's 16 phase-1 and 2 phase-2 kernels, 8 stem bodies, 5 "
              f"dw halo, 5 dw stack), spilling or unread: {spilled}",
              file=sys.stderr)
        return 1
    generic_rows = generic_instantiations(_build.build_log("vsconv"))
    for r in generic_rows:
        print(f"built {r}")
    spilled = [r for r in generic_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(generic_rows) != 30 or spilled:
        print(f"chip_smoke: {len(generic_rows)} generic-body instantiations "
              f"(expected 30: per layout f32 phase 1 at 128 and 64 rows x "
              f"vn 128 and 64 and the general one, int8 phase 1 at 128 and "
              f"64 rows x vn 128 and 64, split at 64 rows x vn 128 and 64, "
              f"the general one whole and split, and phase 2 f32 and int8), "
              f"spilling or unread: {spilled}", file=sys.stderr)
        return 1
    vsmm_rows = vsmm_instantiations(_build.build_log("vsmm"))
    for r in vsmm_rows:
        print(f"built {r}")
    spilled = [r for r in vsmm_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(vsmm_rows) != 14 or spilled:
        print(f"chip_smoke: {len(vsmm_rows)} vsmm instantiations (expected "
              f"14: f32 phase 1 per RT 2/4/8, bf16 per row tile 8/16/32/64, "
              f"phase 2 (f32 and bf16), int8 phase 1 per RT unsplit and RT "
              f"2/4 split, and phase 2), "
              f"spilling or unread: {spilled}",
              file=sys.stderr)
        return 1
    lib = _build.load("flash_fwd")
    smem = {body: {hd: lib.flash_fwd_smem_bytes(hd, int(body == "mma"))
                   for hd in (32, 64, 80, 128, 240)}
            for body in ("mma", "simt")}
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "built": sorted(logs),
                      "flash_fwd_instantiations": flash,
                      "stencil_instantiations": stencils,
                      "int8_instantiations": int8_rows,
                      "generic_instantiations": generic_rows,
                      "vsmm_instantiations": vsmm_rows,
                      "flash_fwd_dynamic_smem_bytes_by_hd": smem}),
          flush=True)

    seconds = {"build": build_s}
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        seconds[phase] = now - clock[0]
        clock[0] = now

    timer = Timer(peak_flops, peak_bw, int8_peak)
    kernel_phase(timer, dev)
    lap("kernel")
    flash_rows = flash_phase(timer, dev, bf16_peak)
    lap("flash")
    bf16_rows = vsmm_bf16_cases(timer, dev, bf16_peak)
    lap("vsmm_bf16")
    served = {path: serve_phase(path, dev) for path in PATHS}
    lap("serve")
    bucket_mix = {path: bucket_mix_phase(path, served[path], dev)
                  for path in BUCKET_MIX_PATHS}
    lap("bucket_mix")
    profiled = {
        path: profile_phase(
            path, lambda s=s: s["srv"].serve(
                [ImageRequest(rid=i, image=im)
                 for i, im in enumerate(s["images"])]), s["warm_s"],
            int8=PATHS[path][2] == "int8")
        for path, s in served.items()}
    for path, s in served.items():
        s["profile"] = profiled[path]
        s["summary"]["device_idle_share"] = \
            profiled[path]["device_idle_share"]
    lap("profile")
    for path, s in served.items():
        forward_phase(timer, path, s["srv"], s["images"], dev,
                      stack_layers_only=path.replace("-stack", "-halo")
                      in PATHS and path.endswith("-stack"))
    lap("forward")
    fleets = {path: fleet_phase(path, served[path], dev)
              for path in FLEET_PATHS}
    lap("fleet")
    vgg = served["vgg16-halo"]
    dense_vs_sparse = dense_vs_sparse_phase(vgg["srv"], vgg["images"], dev)
    lap("dense_vs_sparse")
    paper_model = paper_model_phase(vgg["srv"], vgg["images"],
                                    dense_vs_sparse, dev)
    lap("paper_model")
    calibration = calibration_phase(dev)
    lap("calibration")
    vscheck = vscheck_phase()
    lap("vscheck")
    cnn_shim = cnn_shim_phase(served["vgg16-halo"], dev)
    lap("cnn_shim")
    import torch.distributed as dist
    mesh_store = _mesh_world(dev)
    mesh_cnn = mesh_cnn_phase(served, dev)
    lap("mesh_cnn")
    mesh_rows = mesh_kernel_cases(timer, dev, bf16_peak, served)
    lap("mesh_kernels")
    mesh_conv = mesh_conv_phase(served, dev)
    mesh_rows.update(mesh_conv_cases(timer, dev, served))
    lap("mesh_conv")
    cnn_launches = {path: s["launches"] for path, s in served.items()}
    cnn_launches.update({f"mesh-conv {path}": m["launches"]
                         for path, m in mesh_conv.items()})
    cnn_launches["cnn.vgg16_apply"] = cnn_shim["launches"]
    stem_launches = {path: s["stem_launches"] for path, s in served.items()}
    cnn_summaries = {path: s["summary"] for path, s in served.items()}
    served.clear()  # free the CNN servers before the 4 B-parameter model
    cli = cli_phase()
    lap("cli")

    lm = lm_serve_phase(dev)
    lm_check = lm_check_phase(lm["srv"], lm["reqs"], dev)
    lm_warm = lm_warm_phase(lm["srv"], lm["traffic"])
    lm_decode = lm_decode_phase(lm["srv"], lm["traffic"], dev)
    profiled[LM_CONFIG] = profile_phase(
        LM_CONFIG, lambda: lm["srv"].serve(_lm_requests(lm["traffic"])),
        lm_warm["warm_serve_s"])
    qwen_row = flash_rows[QWEN_PREFILL_CASE]
    breakdown = prefill_breakdown_phase(lm["srv"], qwen_row, dev)
    lap("lm")
    spread = lm_check["logits_spread"]
    flow = lm_flow_phase(lm["srv"], lm["traffic"],
                         max(spread["plain_vs_f32_attention"],
                             spread["plain_vs_sdpa"]), dev)
    lap("lm_flow")
    mesh_lm = mesh_lm_phase(lm, dev)
    lap("mesh_lm")
    seconds["mesh"] = sum(seconds[k] for k in
                          ("mesh_cnn", "mesh_kernels", "mesh_lm"))
    del lm["srv"]  # one model on the card at a time
    archs = {name: lm_arch_phase(name, layers, n, lens, bucket, dev)
             for name, layers, n, lens, bucket in LM_ARCHS}
    lap("lm_archs")
    sparse = {path: lm_arch_phase(name, layers, n, lens, bucket, dev,
                                  change=change, path=path)
              for name, layers, n, lens, bucket, change, path in LM_SPARSE}
    lap("lm_sparse")
    frontends = {name: frontend_phase(name, b, t, steps, dev)
                 for name, b, t, steps in FRONTENDS}
    lap("frontend")
    train = train_phase(dev, smi, (peak_flops, peak_bw, bf16_peak))
    lap("train")
    mesh_train = mesh_train_phase(timer, dev, smi, bf16_peak)
    lap("mesh_train")
    adam8 = adamw8bit_phase(dev)
    dist.destroy_process_group()
    shutil.rmtree(mesh_store, ignore_errors=True)
    lap("adamw8bit")
    chunked = chunked_scan_phase(dev, smi)
    lap("chunked_scan")
    dry = dryrun_phase(dev, smi)
    lap("dryrun")
    print(json.dumps({"phase": "seconds", **seconds}), flush=True)

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        s = timer.sums[kname]
        by_path = {path: v[kname] for path, v in cnn_launches.items()
                   if kname in v}
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": timer.max_abs_err[kname], "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": max(s["flops_bound_ms"], s["bytes_bound_ms"]),
            "bound_by": ("operations" if s["flops_bound_ms"]
                         >= s["bytes_bound_ms"] else "bytes"),
            "library_ms": s["library_ms"], "host_loop_ms": s["host_loop_ms"],
        })
        if kname.endswith("_int8"):
            kernels[-1]["library"] = ("f32 cuDNN conv / cuBLAS matmul on "
                                      "the dequantized input and weight")
            for key in ("int_mm_ms", "int_mm_refused_layers"):
                if key in s:
                    kernels[-1][key] = s[key]
        stem = timer.sums.get(f"{kname}:stem")
        if stem is not None:  # the stem body's share of the entry above
            kernels[-1]["stem_body"] = {
                "launches": sum(n for path, n in stem_launches.items()
                                if kname in cnn_launches[path]),
                "ms": stem["ms"], "plain_ms": stem["plain_ms"],
                "bound_ms": max(stem["flops_bound_ms"],
                                stem["bytes_bound_ms"]),
                "library_ms": stem["library_ms"]}
    kernels.append(_vsmm_bf16_entry(timer, bf16_rows, sparse))
    layers = lm["summary"]["layers"]
    flash_bound = {k: layers * qwen_row[f"{k}_bound_ms"]
                   for k in ("flops", "bytes")}
    flash_by_path = {LM_CONFIG: lm["launches"]["flash_fwd"],
                     FLOW_PATH: flow["launches"]["flash_fwd"],
                     **{name: a["launches"].get("flash_fwd", 0)
                        for name, a in {**archs, **sparse}.items()},
                     **{name: f["launches"]["flash_fwd"]
                        for name, f in frontends.items()},
                     "train": train["launches"]["flash_fwd"],
                     "mesh_train": mesh_train["launches"]["flash_fwd"],
                     **{f"mesh {name}": m["launches"].get("flash_fwd", 0)
                        for name, m in mesh_lm.items()
                        if isinstance(m, dict) and "launches" in m},
                     "dryrun": sum(v.get("flash_fwd", 0)
                                   for v in dry["launches"].values())}
    kernels.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash.py:92",
        "launches": sum(flash_by_path.values()),
        "launches_by_path": flash_by_path,
        "max_abs_err": timer.max_abs_err["flash_fwd"],
        "ms": layers * qwen_row["kernel_ms"],
        "plain_ms": layers * qwen_row["plain_ms"],
        "bound_ms": max(flash_bound.values()),
        "bound_by": ("operations" if flash_bound["flops"]
                     >= flash_bound["bytes"] else "bytes"),
        "library_ms": layers * qwen_row["library_ms"],
        "per": f"one Qwen1.5-4B prefill, batch {LM_BATCH}, T 512, bf16 "
               f"({layers} launches)",
        "ms_per_launch": qwen_row["kernel_ms"], "body": qwen_row["body"],
    })
    result = {"kernels": kernels}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"gpu": smi, "result": result, "per_forward": timer.sums,
             "per_forward_by_path": timer.by_path,
             "serve": cnn_summaries, "bucket_mix": bucket_mix,
             "fleet": fleets, "cli": cli,
             "flash": flash_rows,
             "vsmm_bf16": {" ".join(map(str, k)): v
                           for k, v in bf16_rows.items()},
             "lm": {"serve": lm["summary"], "check": lm_check,
                    "warm": lm_warm, "decode": lm_decode,
                    "prefill_breakdown": breakdown},
             "lm_flow": flow, "lm_archs": archs, "lm_sparse": sparse,
             "frontend": frontends, "train": train, "dryrun": dry,
             "profile": profiled, "dense_vs_sparse": dense_vs_sparse,
             "paper_model": paper_model, "calibration": calibration,
             "vscheck": vscheck, "seconds": seconds,
             "mesh": {"cnn": mesh_cnn, "lm": mesh_lm,
                      "local_shapes": mesh_rows, "train": mesh_train,
                      "conv": mesh_conv, "adamw8bit": adam8},
             "chunked_scan": chunked,
             "cnn_shim": cnn_shim},
            indent=1))
    print(json.dumps({k: v for k, v in dense_vs_sparse.items()
                      if k != "per_layer_ms"}))
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
