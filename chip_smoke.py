#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchacc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--layers 8] [--train-layers 4] [--train-steps 8]
                          [--quant-steps 6] [--data-steps 16]
                          [--fp16-steps 8] [--quant-rest-steps 4]
                          [--check-layers 2]
                          [--ckpt-layers 1] [--hf-layers 4] [--hf-steps 8]
                          [--gemma-layers 8] [--phi2-layers 8]
                          [--phi3-layers 4] [--mixtral-layers 2]
                          [--qwen3-moe-layers 4] [--reps 50] [--seed 0]
                          [--profile]

Phases, each of which exits non-zero when it fails:

1. the card: name and power limit as nvidia-smi reports them;
2. the build: every kernel source under torchacc_tpu_torch/csrc/ is
   compiled by nvcc for sm_90a, one process per source, all at once;
3. the paged-attention kernel phase: B4 (a tensor-core body for
   prefill chunks, a split-context body for decode) against its plain
   PyTorch version on the same CUDA tensors (bf16, Llama-3-8B heads
   H=32 KH=8 D=128, BS=16, shuffled block tables, decode S=8 T=1 with
   contexts 0..~2k, a prefill chunk S=1 T=256, softcap and window
   cases, a long decode with contexts on and beside the split
   boundaries up to 8192, and a batched prefill of chunks of 256, 100
   and 1 tokens with pad rows), then its time beside the plain
   version's, one library call on pre-gathered K/V
   (F.scaled_dot_product_attention, a yardstick the port never calls),
   the least time the card could take and the host's time to issue a
   call; then the same decode, prefill and long-decode cases with heads
   of 64 (Llama-3.2-1B's attention, 32/8 heads), checked and timed;
   then B4's f16 bodies (B-3: the model 8e trains served in its compute
   dtype) at the Llama-3-8B heads: decode, prefill, softcap, window and
   the long decode against the plain version at two f16 ulps (atol 2e-4
   + rtol 2e-3), decode and prefill timed as above;
4. the flash-attention kernel phase: B1 (forward), B2 (dq) and B3
   (dk/dv) against the plain version on the same CUDA tensors — the
   training shape b=2 s=4096 H=32 KH=8 D=128 bf16, causal, packed
   documents of numpy-seeded lengths; a window (1024, -1) + softcap 50
   case, an f32 case, and an sq != sk case with empty rows — then each
   kernel's time at the training shape beside the plain version's, SDPA
   with the same dense mask (forward; forward+backward minus forward for
   the backward), the least time the card could take, and each kernel's
   achieved TFLOP/s and share of that bound.  An ALiBi case
   and a dropout case (p = 0.1, a fixed seed) hold all three kernels to
   the same one-ulp tolerance (a wrong keep bit moves o by far more),
   and the dropped fraction is read back within 3 sigma of p.  The
   training shape again in float16 (the fp16 step's kernels) at two f16
   ulps (atol 2e-4 + rtol 2e-3), with its times, bounds and SDPA's f16
   time; its control, the bf16 kernels on the same inputs cast to bf16,
   must read above that tolerance for o, dq, dk and dv.  Then heads of
   64: the training shape in bf16 (checked and timed), the f32 case and
   the sq != sk case;
4b. the context-parallelism phase, on one card: B1-B3 at the global
   q/k/h/b offsets of a context-parallel step (B-1) against the plain
   versions at the same offsets, bf16, heads of 128 and 64, with packed
   segment ids, a sliding window, ALiBi and dropout (every EXTRA
   instantiation at an offset), a step whose shift is large and positive
   (every key visible) and one whose shift is negative under a window
   (rows that see no key: o = 0, lse = NEG_INF); the worst error beside
   the one-ulp limit, and a control, the kernels at zero offsets, that
   must exceed it.  Then Llama-3-8B's attention (32/8 heads of 128,
   bf16, b 1) over 32768 tokens of packed documents with dropout: the
   ring's schedule over 4 virtual ranks (chunks of 8192), through
   ring.py's own step, skip and merge functions and the offsets of
   cp_attention's CPLayout (tests/torch_cp_virtual.py),
   Ulysses over 2 head groups, and 2D (the ring within each group),
   each against one whole B1/B2/B3 call at 32768 (o, lse, dq, dk, dv;
   the same seed draws the same masks), B1-B3 launching exactly on the
   steps step_should_run keeps (10 of 16 causal steps a head group); the
   ring again against the plain version at 4096 split in 4; the ring's
   device time beside the whole call's;
4c. heads of 256 (the Gemma family, B-2): B4 at gemma-2b's heads (8 q
   heads over one kv head: decode, prefill, softcap 50, a window
   (128, -1) and the long decode), checked and timed; B1-B3 at
   gemma2-2b's (8/4 heads) at its training shape, one 8192-token row in
   bf16, as a sliding layer (window (4095, -1)) and a global one, both
   with the score softcap 50, checked and timed beside compiled
   flex_attention (the one PyTorch call with a softcap), and the
   sliding one again without the cap, timed beside SDPA; f16 with a
   window, the softcap and packed documents, f32 the same, and the
   sq != sk case with empty rows, checked.  Wherever the cap is on
   (here and in 4's window_softcap) q is 8x, so that the scores the
   softmax picks reach the cap's bend, and a control must fail: the
   kernels' dq and dk against a plain backward that drops the cap's
   derivative;
4d. heads of 80 (Phi-2, B-2): B1-B3 at Phi-2's 32 heads of 80 (MHA),
   b 2, s 2048, causal packed documents, in bf16 (one ulp), f16 (two
   ulps) and f32 (1e-5), with ALiBi and dropout in each, and a windowed
   sq != sk case, against the plain versions; the bf16 case timed
   beside SDPA at d 80 with a dense mask, each kernel's bound 4d, 6d and
   8d flops a visible pair and head at 989 TFLOP/s;
4e. B1-B3's ALiBi instantiation at GPT-2's heads (12 of 64, 8 x 1024
   packed tokens, the model's slopes), checked and timed beside SDPA
   with the bias in a dense float mask;
4f. heads of 96 (Phi-3-mini, B-2): B1-B3 at its 32 heads of 96 (MHA),
   b 2, s 4096, causal packed documents and one document under its
   2047-key window, in bf16 (one ulp; both timed beside SDPA at d 96
   with a dense mask, bounds 4d, 6d and 8d flops a visible pair and
   head at 989 TFLOP/s), f16 (two ulps) and f32 (1e-5), ALiBi and
   dropout in each, and an sq != sk case with rows that see no key;
5. the quantized-matmul kernel phase: B5 (a quantize pass and a wgmma
   GEMM, 8-bit for int8 and f16 for fp8's e4m3 values) against its
   plain version on the same CUDA tensors, int8
   and fp8, bf16, at the four shapes of a llama3-8b layer with M = 8192
   tokens (q/o 4096 -> 4096, k/v 4096 -> 1024, gate/up 4096 -> 14336,
   down 14336 -> 4096), ragged shapes, a K of 5 mod 16, both weight
   layouts, f32, and scales near the ends of the f32 range — the
   quantize pass bitwise the plain one, int8 bitwise, fp8 within a
   stated tolerance — then the call's time, split into the quantize
   pass (beside its bytes bound) and the GEMM (TOP/s), and the host's
   time to issue a call, beside the plain version's, library calls on
   operands quantized beforehand (torch._int_mm, torch._scaled_mm) and
   the bf16 torch.matmul of the same shape (yardsticks the port never
   calls), and the least time the card could take; and the fp8 sum
   against an f64 product of the same e4m3 operands at K = 14336,
   beside the plain f32 matmul's.  The same four shapes in float16 (the
   fp16 step's), and the 'head' site's shape, llama3-8b's vocab
   projection K 4096 -> N 128256 (501 tiles of 256), in bf16 and f16,
   and GPT-2's ragged one (K 768 -> N 50257) in f16: int8 bitwise, fp8
   within two f16 ulps (atol 1e-3 + rtol 2e-3) in f16, each timed as
   above;
6. the serving phase: the llama3-8b preset at full width (hidden 4096,
   32/8 heads, ffn 14336, vocab 128256) and --layers deep, bf16 weights
   from init_params(seed) on the card, served through ServeEngine —
   two waves of 4 greedy requests, prompts 64..2000 tokens, 32 new
   tokens each, the second wave submitted mid-decode.  The paged
   kernel's launch counts, kept per shape where it launches, must equal
   layers x decode iterations (T = 1) and layers x prefill dispatches
   (chunks); every request's last-prompt-position logits through the
   kernel must match the plain attention path within a bf16 tolerance,
   and two controls (plain attention with the GQA head map wrong, and
   with a chunk's last row blind to its own key) must not.  With
   --profile, one decode iteration (8 slots) and one 256-token prefill
   chunk run under torch.profiler: B4, cuBLAS and elementwise device
   ms, and the device's busy and idle share;
7. the training phase: llama3-8b at full width and --train-layers deep
   (the depth is the only cut: 32 layers of f32 masters and AdamW state
   need ~128 GB), through accelerate() -> Trainer.step with bf16
   compute over f32 masters and save_attn_mlp remat, stepping one
   numpy-seeded batch of 2 x 4096 packed tokens --train-steps times (the
   first 2 are warm-up).  Every loss must be finite and the last below
   the first; each flash kernel must have launched exactly layers x
   steps times (so remat never re-ran the forward kernel);
8. the quantized training phase: the same model, depth, seed, batch and
   configuration with compute.quant = 'int8' for --quant-steps steps
   (the first 2 are warm-up), then 'fp8' for 2 fewer.  Every loss must
   be finite and the last below the first; the first-step loss must lie
   within 2% of the unquantized phase's; B5 must have launched exactly
   7 x layers x steps times (remat never re-ran it); every amax history
   must hold min(steps, 16) non-zero entries, the newest first; the step
   time, tokens/s and peak memory are printed beside the unquantized
   ones;
8b. the data-fed training phase: accelerate(llama3-8b at full width,
   --train-layers deep, PackedDataset(numpy-seeded Zipf documents of
   256..2047 tokens, seq_len 4096, 4 rows), Config(grad_accum=2,
   data=DataConfig(max_length=4096, prefetch=2))) -> Trainer.fit over
   the AsyncLoader for --data-steps steps, bf16 shadow, save_attn_mlp,
   adamw(warmup_cosine(3e-4, steps, 1)) as in phase 7.  Every batch the trainer received must equal, bitwise, the batch the
   same PackedDataset yields on the host; the packer must be the native
   one and the loader's tensors CUDA tensors; each flash kernel must
   launch layers x steps x 2 times; every loss finite and the mean of
   the last 2 below the first.  A witness, grad_accum=1 over the same
   batches from the same weights, must give the same losses within a
   limit set from readings.  Step ms (beside the hand-fed step's),
   tokens/s, MFU, peak memory and the host's wait on the loader's queue
   a step are printed;
8c. the fp16 phase: the same model and depth with compute.dtype
   float16 under the loss scaler and the 'offload_dots' remat policy,
   fed by the AsyncLoader for --fp16-steps steps, one of which a custom
   loss forces to overflow: that step must leave the masters, both
   moments and the optimizer's count bitwise unchanged (digests of
   every tensor's 32-bit words) and halve the scale, and training must
   go on; 2 x tokens x hidden x 2 bytes a layer and step must go to host
   memory and back; B1 launches 2 x layers x steps (the recompute) and
   B2, B3 layers x steps, all in f16; peak memory beside 8b's, and the
   host's wait a step for the skip flag's copy (the optimizer's count);
8d. the pipeline phase, on one card: parallel/pp.py's own schedule over
   every virtual stage (tests/torch_pp_virtual.py), each stage calling
   the model's chunks, llama3-8b at full width and --train-layers deep,
   bf16 over f32 masters, save_attn_mlp, 4 x 4096 packed tokens: GPipe
   on 4 stages, 1F1B on 4, interleaved 1F1B on 2 stages of 2 chunks,
   and 1F1B on 4 with attention dropout 0.1, each with 4 micro-batches.
   The loss and every gradient of one step's gradient pass must lie
   within a relative 1e-3 of the unpipelined Trainer's (grad_accum 4 on
   the same weights and rows; for the dropout case each micro-batch
   drawing the 1F1B seed); controls that must exceed it: 1F1B with stage
   2 handed the previous micro-batch's activation, and the dropout case
   with GPipe's seeds; the dropout case runs twice, bitwise alike.
   B1/B2/B3 launch L x M times (GPipe), and B1 M x (2L - L/(PV)) under
   1F1B, whose backward tick re-runs the chunk; the live micro-batches a
   stage holds stay within min(2(P-1-d)+1, M).  Printed: each
   schedule's gradient-pass ms beside the unpipelined one's (one card
   runs every stage: no bubble and no transfer can be read), the peak
   memory and the live micro-batches by stage;
8e. quantized training, the rest (run after 8c, before 8d): the same
   model and depth with compute.dtype float16 under the loss scaler,
   int8 on ('attn', 'mlp', 'head') with the materialised head
   (fused_kernels=False),
   save_attn_mlp, one numpy-seeded batch of 2 x 4096 packed tokens for
   --quant-rest-steps (4) steps, a custom loss forcing the third to
   overflow.  The first-step loss must lie within 2% of the same
   weights' and batch's loss with quant off; only the forced step's
   loss may be non-finite; that step must leave the masters, both
   moments, the optimizer's count and every amax history bitwise
   unchanged (digests) and halve the scale; B5 must launch exactly
   (7 x layers + 1) x steps times, all in f16, the head's (N = 128256)
   once a step.  Step ms, tokens/s and peak memory are printed;
8f. fp16 serving: ServeEngine.from_train_state of 8e's trainer, in its
   float16 compute dtype: 4 greedy requests (prompts 64..1000, 16 new
   tokens); B4's f16 bodies launch layers x dispatches (decode and
   prefill); the last-prompt logits through B4 lie within
   F16_LOGITS_LIMIT of the plain attention path's, and the wrong-GQA and
   own-key-blind controls must not;
8g. the pipelined decode (A12d, run after 8d): llama3-8b at full width
   and 4 layers in bf16 over 2 stages in one process (each stage's
   blocks with their own KV cache; the activation handed on through
   the pipeline's transport), a ragged batch of 4 left-padded prompts
   of 128 to 512 tokens and 64 new tokens through generate(pipeline=):
   B1 launches layers x 64, the greedy tokens equal the unpipelined
   generate()'s; fed those tokens, the ragged prefill's and the last
   decode step's logits through B1 lie within the serving limit of the
   plain attention's; both decodes' tokens/s are printed;
6b. the request journal (A2b, run after 6): llama3-8b at full width and
   4 layers in f32; an engine journals 8 requests and is closed once
   half completed, a second engine recover()s the rest (B4 launches
   layers x dispatches over the recovered run) and their greedy streams
   equal generate()'s; under shed_deadlines and preempt_deadlines 2
   expired requests come back 'shed' and one whose deadline passes
   mid-decode 'preempted' with its partial tokens, each journaled;
9. the model-level check: --check-layers deep at full width, one
   forward + backward through the kernels and through
   attention_impl='torch' from the same weights and batch; the loss and
   the first layer's q/k/v-projection and the embedding gradients must
   agree within a limit set from readings, and a control (plain
   attention with the segment mask ignored) must not.  Then the same
   with quant = 'int8' through quant_impl='cuda' and 'torch' from the
   same weights, batch and mid-run amax histories: the kernel is bitwise
   the plain version, so the loss and the first layer's gradients must
   agree exactly (every reading was 0), and a control (a per-tensor
   weight scale in place of the per-channel one) must not; fp8 likewise
   within a limit set from readings.  Then gradient accumulation, in
   f32 through the kernels: grad_accum=2 over two micro-batches whose
   token counts differ against grad_accum=1 on the concatenated batch
   (the loss, the first layer's q/k/v and the embedding gradients)
   within a limit set from readings, with two controls that must
   exceed it: the mean of the micro-batches' mean losses, and the
   gradients summed in bf16.  Then 'offload_dots' against
   'save_attn_mlp' on the same weights and batch, the fp16 step's loss
   and gradients in f16, within a limit set from readings, with the
   bytes moved counted; its control (the copies to host memory held back
   and taken back without waiting for their events, so the backward
   reads buffers they have not reached) must exceed it;
10. the checkpoint phase: phase 8b's configuration at --ckpt-layers
   (1) deep, each checkpoint the state's 12 bytes a parameter (15.2 GB
   at one layer, 1.27 B parameters, most of them the embedding and the
   head; the phases write 3 checkpoints in all, which keeps a run's
   disk writes under 45 GiB).  Run A: fit(checkpoint_dir,
   checkpoint_every=6) for 6 steps, which saves steps 1 (the empty
   directory's first save) and 6; step 6's writer dies after part of
   its payload (injected), as a crash in its save would leave it: the
   close must report it, and step 6 have no step directory and no
   marker.  Run B, a new accelerate() made from another seed, runs
   fit(resume='auto'): it must restore step 1 from loader_state.json
   (no replay), receive run A's batches 1-5 and give its losses at
   steps 1-5 bitwise, save and mark step 6 again, and B1-B3 must launch
   layers x 5 x 2 times.  Two controls must part from run A's step-1
   loss: the same resume with the bf16 shadow not made again (run B's
   trainer, before run B), and step 1's state with the loader not
   repositioned.  The free disk and host memory are read first (too
   little fails the phase, naming the bytes); the directory is removed
   however the phases end.  Printed: the bytes a checkpoint, save()
   host ms and the device memory it adds, the device's stall on a save
   step against a plain step, the restore's ms and GB/s, the peak
   memory;
11. the mesh phase: a world-1 NCCL process group as torchrun
   starts one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a free
   MASTER_PORT) and accelerate() with Config(dist=DistConfig()), whose
   trainer must hold FSDP2 blocks and DTensor masters on the card.
   Phase 7's model, seed, batch and optimizer for --train-steps steps,
   bf16 over f32 masters: every loss must equal phase 7's bitwise, and
   a control (f32 param_dtype) must not; B1-B3 launch layers x steps
   times; step ms, tokens/s, MFU, peak memory and the collective calls
   a step are printed beside phase 7's.  Then int8 on the mesh: B5
   launches 7 x layers x steps, and the first loss lies within 0.02 of
   the bf16 mesh run's;
12. checkpoints across the mesh, run last: phase 7's configuration
   and batch at --ckpt-layers, run B's step 6 restored into a
   one-device trainer and into a new world-1 NCCL mesh trainer's
   DTensor masters (timed), each bitwise run B's saved state (step,
   count and a digest of every tensor's words) and the mesh's next loss
   bitwise the one device's; then the mesh trainer's state saved
   (blocking, timed) and restored into a one-device trainer (timed),
   bitwise, its next loss bitwise the mesh's;
13. the Hugging Face phase (run before the checkpoint phases):
   meta-llama/Llama-3.2-1B's published config.json (vocab 128256,
   hidden 2048, 32/8 heads of 64, ffn 8192, llama3 rope, tied
   embeddings) at --hf-layers (its 16) and its weights in HF's tensor
   names, bf16, normal(0.02) from numpy generators seeded from --seed,
   written by this script's own safetensors writer as 4 shards and an
   index in a directory of the run's own under /dev/shm (or the
   git-ignored chip_smoke_hf/ beside this script where /dev/shm lacks
   room; removed after the load).  accelerate(that
   directory, PackedDataset(Zipf documents, 4096, 2 rows), Config(bf16
   shadow, save_attn_mlp)) streams it into the f32 masters, which must
   equal the written weights bitwise; the loaded model's loss and
   first-layer gradients through B1-B3 lie within _grad_limit of the
   plain attention's, and the segments-ignored control must not; fit
   for --hf-steps steps with an eval_loader pass after the last:
   every loss finite, the last two below the first, B2/B3 at d = 64
   launching layers x steps times and B1 layers x (steps + evaluation
   batches).  ServeEngine.from_train_state(trainer) serves 4 greedy
   requests (prompts 64..1000, 16 new tokens) in bf16: B4 at d = 64
   launches layers x dispatches, the last-prompt logits lie within
   _logits_limit of the plain path and its two controls must not, the
   first divergence from generate() is printed; in f32 compute the
   served greedy streams must equal generate()'s on the same weights.
   Printed: the load time and GB/s, step ms, tokens/s, MFU, peak
   memory, serving tokens/s and TTFT;
13b. the Gemma2 training phase: google/gemma-2-2b's published
   config.json (vocab 256000, hidden 2304, 8/4 heads of 256, ffn 9216,
   window 4096 on every other layer, softcaps 50 and 30, tied) at
   --gemma-layers (8, a multiple of the period 2) with seeded bf16
   weights in HF's names (zero norms: Gemma's 1 + w), written by this
   script's writer and read by accelerate(path) -> Trainer.fit on rows
   of one 8192-token Zipf document each, so that the sliding layers'
   window masks.  The first batch's loss through B1 lies within 1e-4
   (relative) of the plain attention's, and the control (every window
   lifted) must not; every loss finite, the last two below the first;
   B1/B2/B3 at d 256 launch layers x steps times.  Printed: the losses,
   step ms, tokens/s, MFU and peak memory;
13c. the generate() phase: gemma3-1b at full width and one pattern
   period (6 layers: 5 sliding with a 512-key window and the local rope
   base, 1 global), bf16 from init_params(seed), 2 prompts of 1024
   tokens and 16 new: B1 launches layers x 16, the bf16 tokens' first
   divergence from the plain attention is printed, the f32 model's
   greedy tokens equal the plain attention's, and the prompts' last
   logits lie within _logits_limit of the plain path's while the
   window-lifted control does not;
13d. the Gemma serving phase: gemma-2b at full width and depth (18
   layers, MQA 8/1 of 256) from init_params(seed), bf16, through
   ServeEngine with 4 greedy requests (prompts 64..1000, 16 new
   tokens), the first layer's q projection tied to its kv head's so
   that a row attends to its own key there: B4 at d 256 launches
   layers x dispatches, and the last-prompt logits lie within
   _logits_limit of the plain path while two controls must not (a
   64-key window; the last row not seeing its own key);
13e. the Phi-2 phase: microsoft/phi-2's published config.json (vocab
   51200, hidden 2560, 32 heads of 80, ffn 10240, partial rotary 0.4,
   the parallel block, biases and a biased head, untied) at full width
   and --phi2-layers (8 of its 32) with seeded bf16 weights in
   Phi's HF names, through accelerate(path) (the materialising
   converter, as in JAX) -> Trainer.fit for 6 steps of 2 x 2048 packed
   tokens, the head bias taking the materialised logits: the first
   batch's loss through B1 at d 80 within 1e-4 of the plain
   attention's, and the control (partial rotary lifted to 1.0) above
   it; B1/B2/B3 launch layers x steps; then generate() (2 prompts of
   256, 8 new) through B1: launches layers x 8, f32 tokens equal to the
   plain attention's.  Printed: step ms, tokens/s, MFU by
   ModelConfig.num_params, peak memory, the host's wait on the loader;
13f. the GPT-2 phase: openai-community/gpt2's config.json (12 layers,
   12 heads of 64, hidden 768, 1024 learned positions, vocab 50257,
   tied) with seeded bf16 weights in its Conv1D layout, through
   accelerate(path) -> Trainer.fit for 6 steps of 8 x 1024 packed
   tokens (the loss must fall); ServeEngine.from_train_state serves 4
   greedy requests on B4 at d 64: launches layers x dispatches, the
   last-prompt logits within GPT2_LOGITS_LIMIT of the plain path, the
   64-key-window control above it;
13g. the ALiBi phase: GPT-2's width and depth with pos_emb='alibi' from
   init_params(seed), 2 fit steps of 8 x 1024 tokens on B1-B3's ALiBi
   instantiation (launches layers x steps), the first batch's loss
   within 1e-4 of the plain attention's and the halved-slopes control
   above it; generate() through B1 as in 13e;
13h. the Phi-3 phase: microsoft/Phi-3-mini-4k-instruct's config.json
   (transformers' Phi3Config() widths: hidden 3072, 32 heads of 96, ffn
   8192, vocab 32064, the published 2047-key sliding window) at
   --phi3-layers (its 32; 3.82 B parameters) with seeded bf16 weights
   in its packed qkv_proj/gate_up_proj layout, streamed by
   accelerate(path) -> Trainer.fit for 6 steps of one 4096-token
   document: the first batch's loss through B1 at d 96 within 1e-4 of
   the plain attention's, the window-lifted control above it; B1/B2/B3
   launch layers x steps; generate() as in 13e;
13i. longrope: Phi-3.5-mini-instruct's config (the same widths, 131072
   over an original 4096; its two 48-entry factor lists drawn from a
   seed) through config_from_hf, bf16 from init_params(seed):
   generate() from a 4090-token prompt for 16 new tokens rebuilds the
   cache at the crossing (a prefill of 4097 tokens seen by a tap); B1
   launches layers x 16; in f32 compute the tokens through B1 equal the
   plain path's, the last step's logits within 1e-3 of them, and the
   same step decoded without the rebuild must part by more;
13j. OLMo-2-1124-7B's widths (post-norms, the flat qk-norm) at 4 of 32
   layers and Command-R's (CohereConfig() widths: hidden 8192, 64 heads
   of 128, ffn 22528, a tied 256000-token vocabulary, logit_scale
   0.0625, interleaved RoPE) at 1 of 40, each through accelerate(path)
   -> fit (4 steps of one 4096-token document) and generate(): the
   first-batch loss through B1 within 1e-4 of the plain attention's;
   controls OLMo2's norms moved to pre (on the loss) and Command-R's
   RoPE taken half-split (on the final hidden, within _logits_limit
   through B1: the random model's scaled logits leave its loss at
   ln(vocab));
13k. YaRN served: phase 6's llama3-8b at 4 layers with a yarn
   rope_scaling (factor 4 over 8192) through ServeEngine: B4 launches
   layers x dispatches, the last-prompt logits within _logits_limit of
   the plain path, the yarn-lifted and wrong-GQA controls above it;
13l. the mixtures of experts: mixtral-8x7b's widths (hidden 4096, 8
   experts of 14336, top-2, 32/8 heads of 128; 1.45 B parameters a
   layer) at --mixtral-layers through accelerate(ModelConfig,
   PackedDataset) -> Trainer.fit over 2 x 4096 packed tokens a step,
   with dense dispatch (the first batch's loss through B1 within 1e-4
   of the plain attention's, the top expert alone at its full-softmax
   weight as the control) and then with ep.capacity_factor 1.25, each 4 steps: B1/B2/
   B3 launch layers x steps, the FLOPs each step computes (every
   expert on every token, or e x cap slots), step ms and peak memory;
   then 8 greedy tokens of generate() through B1 against the plain
   attention;
13m. Qwen/Qwen3-30B-A3B's config.json (128 experts of 768, top-8 with
   norm_topk_prob, per-head q/k norms, vocab 151936) at
   --qwen3-moe-layers with seeded bf16 weights in its HF names,
   streamed by accelerate(path) with ep.capacity_factor 1.25 (capacity
   dispatch, 'auto' picking JAX's sort mechanism): as 13j, the control
   the top-k renormalisation lifted.

Depths were cut so that the whole run, the mixtures of experts'
phases with it, aims at 600 s of script on an H100: the served
llama3-8b 8 of 32 layers (--layers), the trained one 4 (--train-layers;
it was 8), the Hugging Face Llama-3.2-1B 4 of 16 layers, phi-2 8 of
32, Phi-3-mini and Phi-3.5-mini 4 of 32 (--phi3-layers) and OLMo2 2 of
32; flex_attention's compiles for the d 256 yardstick are shared by
its two shapes, and a vocabulary table of a written checkpoint is drawn
in parts on threads of their own.  Each
phase's seconds are printed as it ends (``phase <name>: N s``) and
together before the JSON lines (``phase seconds:``); the checkpoint
phases, bound by the disk at one layer, take the largest share (stderr
has each kernel's registers and spills from nvcc's -Xptxas -v).

The last two lines of standard output are the ``kernels`` JSON object
and the ``{"ok": true, "device": ...}`` object.  Needs one card; exits
non-zero with no result where torch.cuda.is_available() is false.
"""

import argparse
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W); f16's
# dense tensor-core rate is bf16's
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# the f16 flash kernels against the plain version: two f16 ulps (2^-10 of
# the value each; both compute in f32 and round once to f16)
F16_TOL = dict(atol=2e-4, rtol=2e-3)
# q's factor in the flash cases with a softcap of 50: with q, k ~ N(0, 1)
# and the scale d^-0.5 the scores are ~N(0, 1), where tanh(s / 50) is
# linear to 4e-4 and a B2/B3 that dropped the cap's derivative would
# pass; at 8x the scores the softmax picks reach 25-35, where
# 1 - tanh^2(s / 50) is 0.6-0.8 (a power of two: exact in every dtype)
SOFTCAP_Q_MUL = 8.0

H, KH, D, BS = 32, 8, 128, 16           # Llama-3-8B attention geometry
# the pipelined decode's depth (2 stages of 2) and new tokens
PP_DECODE_LAYERS, PP_DECODE_NEW = 4, 64
# the journal phase's served depth, and the deadline that passes while
# its long request decodes (thousands of tokens take longer)
JOURNAL_LAYERS, PREEMPT_DEADLINE_S = 4, 0.5
KERNEL = dict(name="paged_attention", route="cuda",
              source="torchacc_tpu_torch/csrc/paged_attention.cu",
              replaces="torchacc_tpu/ops/paged_attention.py:103")
FLASH = {   # kernel -> the Pallas kernel it replaces
    "fwd": "torchacc_tpu/ops/flash_attention.py:176",
    "bwd_dq": "torchacc_tpu/ops/flash_attention.py:432",
    "bwd_dkv": "torchacc_tpu/ops/flash_attention.py:481",
}
FLASH_SOURCE = "torchacc_tpu_torch/csrc/flash_attention.cu"
# the kernel each flash entry point runs on bf16, the main path's dtype:
# wgmma fed by TMA through a producer/consumer ring
FLASH_BODY = {name: f"{kernel} (wgmma, TMA ring)" for name, kernel in (
    ("fwd", "fwd_wgmma_kernel"), ("bwd_dq", "bwd_dq_wgmma_kernel"),
    ("bwd_dkv", "bwd_dkv_wgmma_kernel"))}
PEAK_8BIT_OPS = 1979e12                 # int8 and fp8, dense
# the fp8 sum against an f64 product of its e4m3 operands, max |err| /
# max |ref|, at K = 14336: read 2.7e-6 on an H100 (the plain f32 matmul
# 7.6e-7; Hopper's e4m3 wgmma with each 64-deep sum added in f32 9.0e-5)
FP8_F64_LIMIT = 6e-6
QMM = dict(route="cuda",
           source="torchacc_tpu_torch/csrc/quantized_matmul.cu",
           replaces="torchacc_tpu/ops/quantized_matmul.py:175")
# one llama3-8b layer's quantized sites: name -> (K, N, launches a layer)
QMM_SITES = {"q_o": (4096, 4096, 2), "k_v": (4096, 1024, 2),
             "gate_up": (4096, 14336, 2), "down": (14336, 4096, 1)}
# the 'head' site: llama3-8b's vocab projection, (K, N)
QMM_HEAD = (4096, 128256)
# 8f: the largest relative difference allowed between the float16 served
# model's last-prompt logits through B4 and through the plain attention:
# read 1.44e-3..1.66e-3 on an H100 (seed 0, 4 layers), the controls
# 0.0992 and above (one row blind to its own key) and 1.48 (the GQA map
# wrong); the limit sits 6x above the one and 10x below the other
F16_LOGITS_LIMIT = 0.01
TRAIN_B, TRAIN_S = 2, 4096              # tokens per training step: 8192
# cycles the offload check's control holds the copies to host memory
# back: about a second at an H100's clock, longer than the check's
# forward and backward
LATE_COPY_CYCLES = 2_000_000_000


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _ptxas_report(log):
    """(kernel, 'registers; spills') for each kernel in nvcc's -Xptxas -v
    output, the kernel as its name and template arguments: a name in the
    anonymous namespace is mangled as ..._cu_<8 hex><length><name>I...E"""
    import re
    out, fn, seen = [], None, set()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled, fn = m.group(1), m.group(1)
            m2 = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if m2:
                n, at = int(m2.group(1)), m2.end()
                args = re.match(r"I(.*?)EE", mangled[at + n:])
                fn = mangled[at:at + n] + (
                    "<" + ", ".join(_template_args(args.group(1) + "E"))
                    + ">" if args else "")
            spill = None
            continue
        if fn is None:
            continue
        if "spill" in line:
            spill = line.strip()
        elif "registers" in line and fn not in seen:
            seen.add(fn)
            out.append((fn, f"{line.strip().removeprefix('ptxas info    : ')}; "
                            f"{spill}"))
    return out


def _template_args(mangled):
    """The template arguments of an Itanium-mangled argument list: types
    by name (``6__half`` -> __half, ``f`` -> float), integers and bools
    by value (``Li128E`` -> 128)."""
    import re
    out, i = [], 0
    while i < len(mangled):
        m = re.match(r"L[ib](\d+)E|(\d+)|f", mangled[i:])
        if m is None:
            break
        if m.group(1) is not None:
            out.append(m.group(1))
            i += m.end()
        elif m.group(2) is not None:
            n = int(m.group(2))
            start = i + m.end()
            out.append(mangled[start:start + n])
            i = start + n
        else:
            out.append("float")
            i += 1
    return out


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _paged_case(torch, rng, ctx, t, layers, dtype, q_start=None, d=D,
                heads=(H, KH)):
    """Per-layer pools with random contents and per-slot shuffled block
    tables (different per layer, so timing loops do not re-read one
    layer's pages out of L2), ``heads`` (q, kv) of ``d``.  Each slot's
    first query row sits at ctx - t unless ``q_start`` says otherwise."""
    H, KH = heads
    import numpy as np
    s = len(ctx)
    mb = max(1, -(-max(ctx) // BS))
    nb = s * mb + 1
    tables = np.zeros((layers, s, mb), np.int32)
    for l in range(layers):
        perm = rng.permutation(np.arange(1, nb)).tolist()
        for i, c in enumerate(ctx):
            n = -(-c // BS)
            tables[l, i, :n] = [perm.pop() for _ in range(n)]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    k = torch.randn((layers, nb, BS, KH, d), generator=gen, device="cuda",
                    dtype=dtype)
    v = torch.randn((layers, nb, BS, KH, d), generator=gen, device="cuda",
                    dtype=dtype)
    q = torch.randn((s, t, H, d), generator=gen, device="cuda", dtype=dtype)
    q_start = np.asarray(q_start if q_start is not None
                         else [max(c - t, 0) for c in ctx], np.int32)
    cuda_i32 = lambda a: torch.from_numpy(a).cuda()
    return (q, k, v, cuda_i32(tables), cuda_i32(np.asarray(ctx, np.int32)),
            cuda_i32(q_start))


def _work(ctx, q_start, t, window, elem, d=D, heads=(H, KH)):
    """(bytes, flops) the function needs for these inputs: each input
    read once (only the K/V rows some query row can see, the block-table
    entries that name them), each output written once; 4*d flops per
    visible (row, key) pair and head."""
    H, KH = heads
    left, right = window
    s = len(ctx)
    pairs, keys, entries = 0, 0, 0
    for c, q0 in zip(ctx, q_start):
        lo_all, hi_all = None, None
        for tt in range(t):
            qp = q0 + tt
            lo = 0 if left < 0 else max(0, qp - left)
            hi = min(c - 1, qp if right < 0 else min(qp, qp + right))
            if hi >= lo:
                pairs += hi - lo + 1
                lo_all = lo if lo_all is None else min(lo_all, lo)
                hi_all = hi if hi_all is None else max(hi_all, hi)
        if lo_all is not None:
            keys += hi_all - lo_all + 1
            entries += hi_all // BS - lo_all // BS + 1
    nbytes = (2 * s * t * H * d * elem          # q in, out
              + keys * KH * d * 2 * elem        # k and v rows
              + entries * 4 + 2 * s * 4)        # table entries, ctx, q_start
    return nbytes, 4 * d * H * pairs


def _host_ms(torch, fn, iters=20):
    """The host's time to issue fn() once (nothing in fn waits for the
    card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def _time_ms(torch, fn, iters, warm=3):
    for _ in range(warm):
        fn(0)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    # keep the card busy while the host queues the launches, so that a
    # kernel shorter than its host issue time is timed on the card and
    # not at the host's pace (~10 ms at the H100's clock)
    torch.cuda._sleep(20_000_000)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _kernel_phase(torch, args, pa, d=D, only=None, heads=(H, KH),
                  dtype=None):
    """B4 against its plain version at ``heads`` (q, kv) of ``d``
    (``only``: the cases to run, default all), in ``dtype`` (bf16, or
    f16: a model trained under the fp16 loss scaler served in its compute
    dtype), with times of the decode and prefill shapes."""
    H, KH = heads
    import numpy as np
    import torch.nn.functional as F
    dtype = dtype or torch.bfloat16
    rng = np.random.default_rng(args.seed)
    # bf16 outputs from f32 accumulation: both versions compute the same
    # f32 sums in another order (relative difference ~1e-6), so after the
    # cast to bf16 they differ by at most one bf16 ulp = 2^-7 of the
    # value; rtol 1e-2 covers that, atol 1e-3 the values near zero.  f16
    # (P as hi + lo in f16, ~22 bits): two f16 ulps, F16_TOL
    tol = (dict(atol=1e-3, rtol=1e-2) if dtype == torch.bfloat16
           else dict(F16_TOL))
    layers = 8                      # distinct pools cycled while timing
    decode_ctx = [0, 1, 17, 255, 1000, 1231, 1999, 2032]
    # long decode up to 8192: contexts on and one past where the kernel's
    # cut of a slot's keys into the plan's parts changes (the 128-key
    # minimum part; parts of two 64-key stages)
    parts = pa._paged_plan(
        (8, 1, H, d), (8 * 512 + 1, BS, KH, d), 8192 // BS, torch.bfloat16,
        torch.cuda.get_device_properties(0).multi_processor_count).splits
    long_ctx = [1, 127, 128, 129, 128 * parts, 128 * parts + 1, 6000, 8192]
    cases = {   # name: (contexts, T, window, softcap, q_start or None)
        "decode": (decode_ctx, 1, (-1, -1), 0.0, None),
        "prefill": ([1300], 256, (-1, -1), 0.0, None),
        "decode_softcap": (decode_ctx, 1, (-1, -1), 50.0, None),
        "prefill_window": ([1300], 256, (128, -1), 0.0, None),
        "decode_long": (long_ctx, 1, (-1, -1), 0.0, None),
        # three chunks of 256, 100 and 1 tokens in one 256-row dispatch:
        # the short ones leave pad rows past their context
        "prefill_batched": ([256, 800, 1501], 256, (-1, -1), 0.0,
                            [0, 700, 1500]),
    }
    timed = ("decode", "prefill", "decode_long")
    tag = "kernel" if d == D else f"kernel[d{d}]"
    if dtype != torch.bfloat16:
        tag = f"{tag}[{str(dtype).split('.')[-1]}]"
    results = {}
    for name, (ctx, t, window, cap, q0s) in cases.items():
        if only is not None and name not in only:
            continue
        q, k, v, tables, lens, q_start = _paged_case(
            torch, rng, ctx, t, layers, dtype, q0s, d, heads)
        kw = dict(window=window, logit_softcap=cap)
        out = pa.paged_attention(q, k[0], v[0], tables[0], lens, q_start,
                                 impl="cuda", **kw)
        ref = pa.paged_attention(q, k[0], v[0], tables[0], lens, q_start,
                                 impl="torch", **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all():
            _fail(f"{tag} case {name}: non-finite output")
        if any(c == 0 and out[i].abs().max().item() != 0.0
               for i, c in enumerate(ctx)):
            _fail(f"{tag} case {name}: a ctx=0 slot is not zero")
        try:
            torch.testing.assert_close(out.float(), ref.float(), **tol)
        except AssertionError as e:
            _fail(f"{tag} case {name} disagrees with the plain version: "
                  f"{e}")
        rec = {"max_abs_err": err, "tolerance": tol, "ctx": ctx, "t": t,
               "window": list(window), "softcap": cap, "dtype": str(dtype)}
        if name in timed:
            iters = args.reps
            rec["host_ms"] = _host_ms(torch, lambda: pa.paged_attention(
                q, k[0], v[0], tables[0], lens, q_start, impl="cuda", **kw))
            rec["ms"] = _time_ms(torch, lambda i: pa.paged_attention(
                q, k[i % layers], v[i % layers], tables[i % layers], lens,
                q_start, impl="cuda", **kw), iters)
            rec["plain_ms"] = _time_ms(torch, lambda i: pa.paged_attention(
                q, k[i % layers], v[i % layers], tables[i % layers], lens,
                q_start, impl="torch", **kw), max(3, iters // 10))
            # the yardstick: one SDPA call on K/V gathered beforehand
            mb = tables.shape[-1]
            def gather(pool, tt):      # [S, H, MB*BS, D], heads expanded
                return (pool[tt].reshape(len(ctx), mb * BS, KH, d)
                        .repeat_interleave(H // KH, dim=2).transpose(1, 2)
                        .contiguous())
            dense = [(gather(k[l], tables[l].long()),
                      gather(v[l], tables[l].long())) for l in range(layers)]
            kv_pos = torch.arange(mb * BS, device="cuda")
            q_pos = q_start.long()[:, None] + torch.arange(t, device="cuda")
            mask = ((kv_pos[None, None] < lens.long()[:, None, None])
                    & (kv_pos[None, None] <= q_pos[:, :, None]))[:, None]
            qt = q.transpose(1, 2)
            rec["library_ms"] = _time_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    qt, dense[i % layers][0], dense[i % layers][1],
                    attn_mask=mask), iters)
            del dense
            q0 = q_start.cpu().tolist()
            nbytes, flops = _work(ctx, q0, t, window, 2, d, heads)
            tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
            rec.update(bytes=nbytes, flops=flops,
                       bound_ms=max(tb, tf) * 1e3,
                       bound_by="bytes" if tb >= tf else "operations")
        results[name] = rec
        print(f"{tag} {name}: max_abs_err {err:.3g} (atol {tol['atol']}, "
              f"rtol {tol['rtol']})"
              + (f" kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                 f" ms, library {rec['library_ms']:.4f} ms, bound "
                 f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), host "
                 f"{rec['host_ms']:.4f} ms a call"
                 if "ms" in rec else ""), flush=True)
        del q, k, v, tables
    return results


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------

def _fmt(xs):
    return "[" + ", ".join(f"{x:.4g}" for x in xs) + "]"


def _logits_limit(layers):
    """Largest relative difference allowed between the last-prompt
    logits through the kernel and through the plain attention.  Set from
    readings (PERF.md) over seeds 0-2 at 2 and 32 layers: it lies about
    4x above the largest sound reading and 4x below the smallest reading
    of either control, and grows as the square root of the depth, as
    independent per-layer rounding differences do."""
    return 0.03 * layers ** 0.5


def _wrong_gqa(q, k_pool, *args, **kw):
    """Control: plain attention in which q head i reads kv head i % KH
    instead of i // group (a kernel with the GQA map wrong)."""
    import torch
    from torchacc_tpu_torch.ops.paged_attention import paged_attention
    h, kh = q.shape[2], k_pool.shape[2]
    i = torch.arange(h, device=q.device)
    j = (i % kh) * (h // kh) + i // kh      # plain head j reads kv j // group
    qp = torch.empty_like(q)
    qp[:, :, j] = q
    return paged_attention(qp, k_pool, *args, **kw)[:, :, j]


def _drop_own_key(q, k_pool, v_pool, tables, lens, q_start, **kw):
    """Control: plain attention in which the chunk's last row does not
    see its own key (an off-by-one at the end of the causal range)."""
    from torchacc_tpu_torch.ops.paged_attention import paged_attention
    return paged_attention(q, k_pool, v_pool, tables, (lens - 1).clamp(min=0),
                           q_start, **kw)


def _prompt_logits(torch, model, cfg, prompts, impl, attend=None):
    """Each prompt prefilled in 256-token chunks into a pool of its own;
    the f32 logits at its last position.  ``attend`` replaces the
    decoder's attention (a control)."""
    from torchacc_tpu_torch import ServeConfig
    from torchacc_tpu_torch.serve import PagedDecoder, make_pools
    import torchacc_tpu_torch.serve.scheduler as sched_mod
    one = ServeConfig(block_size=BS, prefill_chunk=256,
                      num_blocks=max(map(len, prompts)) // BS + 2)
    tables = torch.arange(1, one.num_blocks, dtype=torch.int32,
                          device="cuda")[None]
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    saved = sched_mod.paged_attention
    if attend is not None:
        sched_mod.paged_attention = attend
    out = []
    try:
        with torch.inference_mode():
            dec = PagedDecoder(model, one, attention_impl=impl)
            for p in prompts:
                pools = make_pools(cfg, one, torch.device("cuda"))
                for c0 in range(0, len(p), 256):
                    chunk = p[c0:c0 + 256]
                    last = dec.prefill(pools, tables, i32([c0]), i32([chunk]),
                                       i32([len(chunk)]),
                                       with_head=c0 + 256 >= len(p))
                out.append(last[0])
                del pools
    finally:
        sched_mod.paged_attention = saved
    return out


def _device_groups(prof, groups_of):
    """Device-side rows of a profile (kernels, copies, sets: an
    operator's row repeats the time of the kernels it launched), their
    busy ms and their ms summed by group_of(name)."""
    from torch.autograd import DeviceType
    kern = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and a.self_device_time_total > 0]
    kern.sort(key=lambda a: -a.self_device_time_total)
    groups = {}
    for a in kern:
        g = groups_of(a.key)
        groups[g] = groups.get(g, 0.0) + a.self_device_time_total / 1e3
    return kern, sum(a.self_device_time_total for a in kern) / 1e3, groups


def _serving_group(name):
    return ("paged attention (B4)" if "paged_" in name
            else "GEMM (cuBLAS)" if any(t in name for t in (
                "nvjet", "gemm", "gemv", "xmma", "cutlass"))
            else "elementwise, copy, reduce (aten)" if "at::native" in name
            or "Memcpy" in name or "Memset" in name else "other")


def _serving_profile(torch, model, cfg):
    """One decode iteration of 8 slots (contexts 65..2001, the serving
    run's table width) and one 256-token prefill chunk at position 1024,
    each through PagedDecoder under torch.profiler: B4, cuBLAS and
    elementwise device ms, and the device's busy and idle share of the
    step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from torchacc_tpu_torch import ServeConfig
    from torchacc_tpu_torch.serve import PagedDecoder, make_pools
    from torchacc_tpu_torch.serve.kv_cache import blocks_needed
    slots, used = 8, 2304 // BS                  # blocks a slot holds
    width = blocks_needed(cfg.max_seq_len + 2, BS)   # the engine's tables
    one = ServeConfig(block_size=BS, prefill_chunk=256, max_slots=slots,
                      num_blocks=slots * used + 1)
    pools = make_pools(cfg, one, torch.device("cuda"))
    tables = torch.zeros((slots, width), dtype=torch.int32, device="cuda")
    tables[:, :used] = 1 + torch.arange(slots * used, dtype=torch.int32,
                                        device="cuda").view(slots, used)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = lambda n: torch.randint(0, cfg.vocab_size, (n,), generator=g,
                                   device="cuda", dtype=torch.int32)
    seq_lens = i32([64, 700, 1337, 2000, 129, 1000, 1800, 333])
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    steps = {
        "decode": lambda dec: dec.decode(pools, toks(slots), tables, seq_lens,
                                         active, None, None, None, None,
                                         all_greedy=True),
        "prefill": lambda dec: dec.prefill(pools, tables[:1], i32([1024]),
                                           toks(256)[None], i32([256]),
                                           with_head=True),
    }
    with torch.inference_mode():
        dec = PagedDecoder(model, one)
        for what, step in steps.items():
            step(dec)                            # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(dec)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kern, busy_ms, groups = _device_groups(prof, _serving_group)
            print(f"profile serving {what}: one step, wall {wall_ms:.2f} ms "
                  f"(profiled), device busy {busy_ms:.2f} ms, idle share "
                  f"{1 - busy_ms / wall_ms:.3f}; " + "; ".join(
                      f"{g} {ms:.3f} ms" for g, ms in sorted(
                          groups.items(), key=lambda kv: -kv[1])), flush=True)
            for a in kern[:6]:
                print(f"profile serving {what}: "
                      f"{a.self_device_time_total / 1e3:9.3f} ms "
                      f"x{a.count:<5d} {a.key[:100]}", flush=True)
    del pools


def _serving_phase(torch, args, pa):
    import numpy as np
    from torchacc_tpu_torch import (
        Config, Request, ServeConfig, ServeEngine, get_preset, init_params)

    cfg = get_preset("llama3-8b", dtype=torch.bfloat16,
                     num_layers=args.layers)
    if args.layers != 32:
        print(f"serving: depth cut to {args.layers} of 32 layers "
              f"(full width kept)", flush=True)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=args.seed, device="cuda",
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"serving: llama3-8b x{args.layers} layers, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B "
          f"params bf16, made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    serve = ServeConfig(block_size=BS, num_blocks=2048, max_slots=8,
                        prefill_chunk=256, decode_depth=2)
    rng = np.random.default_rng(args.seed)
    lens = [[64, 700, 1337, 2000], [129, 1000, 1800, 333]]
    waves = [[rng.integers(0, cfg.vocab_size, size=n).tolist() for n in w]
             for w in lens]
    max_new = 32

    eng = ServeEngine(model, Config(serve=serve))
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    eng.generate([Request(prompt_ids=waves[0][0][:32], max_new_tokens=2)])
    eng.reset_stats()
    sched = eng.scheduler
    dec0, pre0 = sched.decode_dispatches, sched.prefill_dispatches

    for shape in pa.launch_counts:       # counts start here ...
        pa.launch_counts[shape] = 0
    t_run = time.perf_counter()
    resolved = []                        # tokens resolved, first wave
    ids = [eng.submit(Request(prompt_ids=p, max_new_tokens=max_new),
                      on_token=lambda tok, t: resolved.append(tok))
           for p in waves[0]]
    while len(resolved) < 8:
        eng.step()                       # first wave mid-decode
    ids += [eng.submit(Request(prompt_ids=p, max_new_tokens=max_new))
            for p in waves[1]]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(pa.launch_counts)    # ... and are read here
    decode_iters = sched.decode_dispatches - dec0
    prefill_disp = sched.prefill_dispatches - pre0
    results = [eng.result(i) for i in ids]
    stats = eng.stats()
    for r in results:
        if len(r.tokens) != max_new or r.finish_reason != "length":
            _fail(f"request {r.request_id} finished with "
                  f"{len(r.tokens)} tokens ({r.finish_reason})")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            _fail(f"request {r.request_id}: token out of the vocabulary")
    # no prompt here leaves a one-token chunk, so every T == 1 launch is
    # a decode one and every chunk launch a prefill one
    dispatches = {"decode": decode_iters, "prefill": prefill_disp}
    for shape, n in dispatches.items():
        if n == 0 or launches[shape] != cfg.num_layers * n:
            _fail(f"{shape} kernel launches {launches[shape]} != layers "
                  f"{cfg.num_layers} x {shape} dispatches {n}")
    print(f"serving: {len(results)} requests x {max_new} tokens in "
          f"{wall:.2f} s; {stats['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{stats['ttft_s_p50'] * 1e3:.1f} ms, per-token p50 "
          f"{stats['per_token_s_p50'] * 1e3:.2f} ms; kernel launches: decode "
          f"{launches['decode']} = {cfg.num_layers} x {decode_iters}, "
          f"prefill {launches['prefill']} = {cfg.num_layers} x "
          f"{prefill_disp}", flush=True)
    streams = [r.tokens for r in results]
    eng.close()
    del eng, sched
    torch.cuda.empty_cache()
    if args.profile:
        _serving_profile(torch, model, cfg)

    # last-prompt-position logits: kernel vs plain attention, same model,
    # same prompts; and two controls, plain attention made wrong on
    # purpose, to show what the check can and cannot tell apart
    prompts = waves[0] + waves[1]
    ref = _prompt_logits(torch, model, cfg, prompts, "torch")
    rel = {}
    for name, attend in (("kernel", None), ("wrong_gqa", _wrong_gqa),
                         ("drop_own_key", _drop_own_key)):
        got = _prompt_logits(torch, model, cfg, prompts,
                             "cuda" if attend is None else "torch", attend)
        if not all(torch.isfinite(a).all() for a in got):
            _fail(f"non-finite logits ({name})")
        rel[name] = [((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref)]
        if name == "kernel":
            top1 = sum(int(a.argmax() == b.argmax())
                       for a, b in zip(got, ref))
    limit = _logits_limit(cfg.num_layers)
    worst = max(rel["kernel"])
    print(f"serving: last-prompt logits vs plain attention, max rel err "
          f"per prompt: kernel {_fmt(rel['kernel'])} (limit {limit:.3g}), "
          f"argmax agree {top1}/{len(prompts)}; controls: wrong_gqa "
          f"{_fmt(rel['wrong_gqa'])}, drop_own_key "
          f"{_fmt(rel['drop_own_key'])}", flush=True)
    if worst > limit:
        _fail(f"logits through the kernel part from the plain path by "
              f"{worst:.3g} > {limit:.3g}")
    for name in ("wrong_gqa", "drop_own_key"):
        if max(rel[name]) <= limit:
            _fail(f"the {name} control stays within the limit {limit:.3g}: "
                  f"the logits check cannot tell a wrong kernel apart")

    # the plain path's greedy streams, for the first divergence (bf16
    # near-ties may flip an argmax, so this is printed, not asserted)
    plain_eng = ServeEngine(model, Config(serve=serve),
                            attention_impl="torch")
    plain = [r.tokens for r in plain_eng.generate(
        [Request(prompt_ids=p, max_new_tokens=max_new) for p in prompts])]
    plain_eng.close()
    firsts = [next((i for i, (x, y) in enumerate(zip(s1, s2)) if x != y),
                   None) for s1, s2 in zip(streams, plain)]
    print(f"serving: first greedy divergence kernel vs plain per request "
          f"(None = identical): {firsts}", flush=True)
    return launches, dispatches


def _journal_phase(torch, args, pa, card):
    """Serving's request journal and recovery (A2b): llama3-8b at full
    width and JOURNAL_LAYERS deep, f32 from init_params(seed), so that B4
    (the served streams) and B1 (generate()) agree token for token.
    Engine A journals 8 requests into a new directory and is closed once
    half of them completed; engine B over the same directory recover()s
    the rest under their ids, and its B4 launches, counted from 0 over
    that run, must be layers x its dispatches; the recovered streams
    must equal generate()'s greedy tokens on the same prompts.  Then,
    under shed_deadlines and preempt_deadlines, 2 requests whose
    deadlines passed before a step must come back 'shed' (no tokens),
    and 1 whose deadline passes mid-decode 'preempted' with its partial
    tokens, each counted and journaled."""
    import numpy as np
    from torchacc_tpu_torch import (
        Config, Request, ServeConfig, ServeEngine, get_preset, init_params)
    from torchacc_tpu_torch.models.generate import generate
    from torchacc_tpu_torch.serve.journal import read_journal, replay_state

    layers = JOURNAL_LAYERS
    cfg = get_preset("llama3-8b", dtype=torch.float32, num_layers=layers)
    model = init_params(cfg, seed=args.seed + 131, device="cuda",
                        dtype=torch.float32)
    rng = np.random.default_rng(args.seed + 132)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (40, 300, 129, 511, 77, 260, 1000, 16)]
    max_new = 24
    jdir = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    try:
        serve = dict(block_size=BS, num_blocks=1024, max_slots=4,
                     prefill_chunk=256, decode_depth=2, journal_dir=jdir)
        t0 = time.perf_counter()
        first = ServeEngine(model, Config(serve=ServeConfig(**serve)))
        ids = [first.submit(Request(prompt_ids=p, max_new_tokens=max_new))
               for p in prompts]
        while first._completed < len(prompts) // 2 and first.step():
            pass
        done = sorted(s.sid for s in first._all.values() if s.finished)
        first.close()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = ServeEngine(model, Config(serve=ServeConfig(**serve)))
        sched = second.scheduler
        for shape in pa.launch_counts:       # counts start here ...
            pa.launch_counts[shape] = 0
        rec = second.recover()
        second.run()
        torch.cuda.synchronize()
        launches = dict(pa.launch_counts)    # ... and are read here
        t_recover = time.perf_counter() - t0
        dispatches = {"decode": sched.decode_dispatches,
                      "prefill": sched.prefill_dispatches}
        if rec["completed"] != done or sorted(rec["replayed"]) != sorted(
                set(ids) - set(done)) or not rec["replayed"]:
            _fail(f"journal: recover() gave {rec}, the first engine had "
                  f"completed {done}")
        for shape, n in dispatches.items():
            if n == 0 or launches[shape] != layers * n:
                _fail(f"journal: {shape} B4 launches {launches[shape]} != "
                      f"layers {layers} x {shape} dispatches {n}")
        same = []
        for rid in rec["replayed"]:
            got = second.result(rid).tokens
            want = generate(model, [prompts[rid]], max_new_tokens=max_new,
                            attention_impl="cuda")[0, len(prompts[rid]):]
            same.append(got == want.tolist())
        second.close()
        if not all(same):
            _fail(f"journal: recovered streams differ from generate()'s: "
                  f"{same}")
        _, completed, shed = replay_state(read_journal(jdir))
        if sorted(completed) != sorted(ids) or shed:
            _fail(f"journal: the journal folds to completed "
                  f"{sorted(completed)}, shed {sorted(shed)}")

        # deadlines: 2 shed in the queue, 1 preempted mid-decode
        deadlines = ServeEngine(model, Config(serve=ServeConfig(
            **serve, shed_deadlines=True, preempt_deadlines=True)))
        deadlines.generate([Request(prompt_ids=prompts[0][:16],
                                    max_new_tokens=2)])     # warm-up
        late = [deadlines.submit(Request(prompt_ids=p, max_new_tokens=8,
                                         deadline_s=1e-3))
                for p in prompts[:2]]
        time.sleep(0.01)
        deadlines.step()
        slow = deadlines.submit(Request(prompt_ids=prompts[2],
                                        max_new_tokens=2000,
                                        deadline_s=PREEMPT_DEADLINE_S))
        deadlines.run()
        shed_r = [deadlines.result(r) for r in late]
        pre = deadlines.result(slow)
        stats = deadlines.stats()
        deadlines.close()
        if [(r.finish_reason, r.tokens) for r in shed_r] != [("shed", [])] * 2:
            _fail(f"journal: expired requests came back "
                  f"{[(r.finish_reason, len(r.tokens)) for r in shed_r]}")
        if pre.finish_reason != "preempted" or not 0 < len(pre.tokens) < 2000:
            _fail(f"journal: the mid-decode deadline gave "
                  f"{pre.finish_reason} with {len(pre.tokens)} tokens")
        if (stats["shed"], stats["preempted"]) != (2, 1):
            _fail(f"journal: stats count shed {stats['shed']}, preempted "
                  f"{stats['preempted']}")
        _, _, shed = replay_state(read_journal(jdir))
        if sorted(shed) != sorted(late + [slow]):
            _fail(f"journal: shed records {sorted(shed)}")
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    print(f"journal: llama3-8b x{layers} f32, 8 requests x {max_new} "
          f"tokens; engine A served {len(done)} then closed "
          f"({t_first:.2f} s); engine B recovered {len(rec['replayed'])} in "
          f"{t_recover:.2f} s, B4 launches decode {launches['decode']} = "
          f"{layers} x {dispatches['decode']}, prefill "
          f"{launches['prefill']} = {layers} x {dispatches['prefill']}, "
          f"streams equal to generate(): {sum(same)}/{len(same)}; shed 2 "
          f"(no tokens), preempted 1 after {len(pre.tokens)} tokens "
          f"(deadline {PREEMPT_DEADLINE_S} s); card: {card}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches,
            "recover_s": t_recover, "replayed": len(rec["replayed"]),
            "preempted_tokens": len(pre.tokens)}


# ---------------------------------------------------------------------------
# flash-attention kernel phase
# ---------------------------------------------------------------------------

def _packed_positions(rng, b, s, lo, hi):
    """Position ids of documents of lengths drawn from [lo, hi), packed
    into each of b rows of s tokens (the last document is cut)."""
    import numpy as np
    rows = []
    for _ in range(b):
        pos = []
        while len(pos) < s:
            pos += list(range(int(rng.integers(lo, hi))))
        rows.append(pos[:s])
    return np.asarray(rows, np.int32)


def _flash_inputs(torch, rng, b, sq, sk, dtype, segments, d=D,
                  heads=(H, KH)):
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    H, KH = heads
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda",
                                     dtype=dtype)
    q, k, v, do = rnd(b, sq, H, d), rnd(b, sk, KH, d), rnd(b, sk, KH, d), \
        rnd(b, sq, H, d)
    seg = None
    if segments:
        assert sq == sk
        pos = torch.from_numpy(_packed_positions(rng, b, sq, 256, 2048))
        seg = segment_ids_from_positions(pos).cuda()
    return q, k, v, do, seg


def _flash_work(torch, q, k, seg, causal, window):
    """(visible pairs per q head summed over the batch, bytes of fwd, dq,
    dkv) for these inputs: every input read once, every output written
    once, only the pairs the mask lets through counted."""
    from torchacc_tpu_torch.ops.attention import make_attention_mask
    b, sq, H, _ = q.shape
    sk = k.shape[1]
    mask = make_attention_mask(sq, sk, causal, window, seg, seg,
                               q_offset=sk - sq, device=q.device)
    pairs = int(mask.sum()) * (1 if mask.ndim == 3 else b)
    e = q.element_size()
    qb, kb = q.numel() * e, k.numel() * e           # q, o, do, dq alike
    rows = b * H * sq * 4                           # lse, delta (f32)
    segb = 0 if seg is None else 4 * b * (sq + sk)
    fwd = qb + 2 * kb + segb + qb + rows
    dq = 2 * qb + 2 * kb + 2 * rows + segb + qb
    dkv = 2 * qb + 2 * kb + 2 * rows + segb + 2 * kb
    return pairs, {"fwd": fwd, "bwd_dq": dq, "bwd_dkv": dkv}, mask


def _flash_phase(torch, args, d=D, only=None, heads=(H, KH), cases=None,
                 timed=("train", "train_f16")):
    """B1-B3 against the plain version at ``heads`` (q, kv) of ``d``
    (``only``: the cases to run, default all; ``cases``: other cases in
    place of these); times at the ``timed`` shapes."""
    H, KH = heads
    import numpy as np
    import torch.nn.functional as F
    import torchacc_tpu_torch.ops.flash_attention as fa
    rng = np.random.default_rng(args.seed + 1)
    # o: one bf16 ulp (both versions compute the same f32 sums in
    # another order and round once to bf16: atol 1e-3 + rtol 1e-2); lse:
    # f32 on both sides.  The backward kernels are held against the
    # plain backward from the same (o, lse), at one bf16 ulp too (f32:
    # 1e-4, dk/dv sum group x s products in another order); worst
    # readings in PERF.md
    tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
           torch.float16: F16_TOL,
           torch.float32: dict(atol=1e-5, rtol=1e-5)}
    grad_tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
                torch.float16: F16_TOL,
                torch.float32: dict(atol=1e-4, rtol=1e-4)}
    slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device="cuda",
                                         dtype=torch.float32) / H)
    # b, sq, sk, dtype, segments, causal, window, softcap, more
    cases = cases or {
        "train": (TRAIN_B, TRAIN_S, TRAIN_S, torch.bfloat16, True, True,
                  (-1, -1), 0.0, {}),
        "train_f16": (TRAIN_B, TRAIN_S, TRAIN_S, torch.float16, True, True,
                      (-1, -1), 0.0, {}),
        "window_softcap": (1, 2048, 2048, torch.bfloat16, False, True,
                           (1024, -1), 50.0, dict(q_mul=SOFTCAP_Q_MUL)),
        "f32": (1, 1024, 1024, torch.float32, True, True, (-1, -1), 0.0, {}),
        "sq_ne_sk_empty_rows": (1, 1536, 512, torch.bfloat16, False, True,
                                (-1, -1), 0.0, {}),
        "alibi": (1, 2048, 2048, torch.bfloat16, True, True, (-1, -1), 0.0,
                  dict(alibi_slopes=slopes)),
        "dropout": (1, 2048, 2048, torch.bfloat16, True, True, (-1, -1),
                    0.0, dict(dropout_p=0.1, dropout_seed=1234)),
        "dropout_alibi_f32": (1, 1024, 1024, torch.float32, True, True,
                              (-1, -1), 0.0,
                              dict(dropout_p=0.1, dropout_seed=99,
                                   alibi_slopes=slopes)),
    }
    results = {}
    tag = "flash" if d == D else f"flash[d{d}]"
    for name, (b, sq, sk, dtype, segments, causal, window, cap,
               more) in cases.items():
        if only is not None and name not in only:
            continue
        more = dict(more)
        q_mul = more.pop("q_mul", 1.0)
        q, k, v, do, seg = _flash_inputs(torch, rng, b, sq, sk, dtype,
                                         segments, d, heads)
        q *= q_mul
        scale = d ** -0.5
        kw = dict(causal=causal, window=window, logit_softcap=cap,
                  q_segment_ids=seg, kv_segment_ids=seg, **more)
        got, ref = {}, {}
        for impl, out in (("cuda", got), ("torch", ref)):
            out["o"], out["lse"] = fa.flash_attention(
                q, k, v, impl=impl, return_lse=True, **kw)
            # the backward from the kernel's forward on both sides
            out["dq"], out["dk"], out["dv"] = fa.flash_attention_bwd(
                q, k, v, got["o"], got["lse"], do, impl=impl, **kw)
        torch.cuda.synchronize()
        rec = {"b": b, "sq": sq, "sk": sk, "dtype": str(dtype),
               "segments": segments, "window": list(window), "softcap": cap,
               "q_mul": q_mul}
        for key in ("o", "lse", "dq", "dk", "dv"):
            a, r = got[key].float(), ref[key].float()
            if not torch.isfinite(a).all():
                _fail(f"{tag} case {name}: non-finite {key}")
            t = (dict(atol=1e-5, rtol=1e-5) if key == "lse" else
                 tol[dtype] if key == "o" else grad_tol[dtype])
            err = (a - r).abs()
            rec[key] = {"max_abs_err": err.max().item(),
                        "ref_max": r.abs().max().item(),
                        "worst_over_tol": (err / (t["atol"] + t["rtol"]
                                                  * r.abs())).max().item()}
            try:
                torch.testing.assert_close(a, r, **t)
            except AssertionError as e:
                _fail(f"{tag} case {name}: {key} disagrees with the plain "
                      f"version: {e}")
        if name == "sq_ne_sk_empty_rows":
            blind = sq - sk                     # query i sits at i + sk - sq
            if (got["o"][:, :blind].abs().max().item() != 0.0
                    or got["lse"][:, :, :blind].max().item() > -1e29
                    or got["dq"][:, :blind].abs().max().item() != 0.0):
                _fail("flash: rows that see no key must give o = 0, "
                      "lse = NEG_INF and dq = 0")
        print(f"{tag} {name}: " + ", ".join(
            f"{key} err {rec[key]['max_abs_err']:.3g} (ref max "
            f"{rec[key]['ref_max']:.3g}, worst/tol "
            f"{rec[key]['worst_over_tol']:.3g})"
            for key in ("o", "lse", "dq", "dk", "dv")), flush=True)
        if name == "train_f16":
            rec["control_bf16"] = _f16_control(torch, fa, q, k, v, do, kw,
                                               ref)
        if cap > 0.0:
            rec["control_no_dcap"] = _softcap_control(
                torch, fa, q, k, v, do, kw, got, grad_tol[dtype], tag, name)
        del got, ref
        if name in timed:
            rec.update(_flash_times(torch, F, fa, args, q, k, v, do, seg,
                                    scale, causal, window, cap,
                                    more.get("alibi_slopes")))
        results[name] = rec
        del q, k, v, do, seg
        torch.cuda.empty_cache()
    if only is None and d == D:
        results["dropped_fraction"] = _dropped_fraction(torch, fa)
    return results


def _f16_control(torch, fa, q, k, v, do, kw, ref):
    """The f16 tolerance must tell f16 from bf16: the bf16 kernels on the
    same inputs cast to bf16, against the f16 case's plain version, read
    above it for each of o, dq, dk and dv."""
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    o, lse = fa.flash_attention(*b16[:3], impl="cuda", return_lse=True,
                                **kw)
    got = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd(
        *b16[:3], o, lse, b16[3], impl="cuda", **kw)), o=o)
    worst = {}
    for key, a in got.items():
        r = ref[key].float()
        worst[key] = ((a.float() - r).abs() / (
            F16_TOL["atol"] + F16_TOL["rtol"] * r.abs())).max().item()
    print(f"flash train_f16 control (the bf16 kernels on the same inputs): "
          f"worst/tol {json.dumps({k: float(f'{x:.4g}') for k, x in worst.items()})} "
          f"(each must exceed 1)", flush=True)
    if min(worst.values()) <= 1.0:
        _fail(f"flash f16: the bf16 control stays within the f16 tolerance "
              f"({worst}): it cannot tell f16 from bf16")
    return worst


def _softcap_control(torch, fa, q, k, v, do, kw, got, tol, tag, name):
    """The gradient check must see the softcap's derivative: the
    kernels' dq and dk against a plain backward that applies the cap to
    the scores but drops its chain factor 1 - tanh^2 (a B2 or B3 with
    that fault) read above the tolerance, each."""
    import torchacc_tpu_torch.ops.attention as attn
    scores = attn._scores

    def no_dcap(*a, **k2):
        return scores(*a, **k2)[0], 1.0
    attn._scores = no_dcap
    try:
        bad = dict(zip(("dq", "dk"), fa.flash_attention_bwd(
            q, k, v, got["o"], got["lse"], do, impl="torch", **kw)))
    finally:
        attn._scores = scores
    worst = {}
    for key, r in bad.items():
        r = r.float()
        worst[key] = ((got[key].float() - r).abs() / (
            tol["atol"] + tol["rtol"] * r.abs())).max().item()
    print(f"{tag} {name} control (the plain backward without the softcap's "
          f"derivative): worst/tol {_fmt(worst.values())} for dq, dk (each "
          f"must exceed 1)", flush=True)
    if min(worst.values()) <= 1.0:
        _fail(f"{tag} {name}: the kernels' gradients stay within the "
              f"tolerance of a backward without the softcap's derivative "
              f"({worst}): the check cannot see that factor")
    return worst


def _dropped_fraction(torch, fa, p=0.1, seed=4321, s=2048):
    """The share of pairs the forward kernel drops, read back: with
    q = 0 every row's probabilities are uniform and with v = 1 an output
    entry is (kept pairs of the row) / (s * (1 - p)), so 1 - mean(o) *
    (1 - p) is the dropped share of the H * s * s pairs.  f32, so that
    the reading is exact to ~1e-7."""
    q = torch.zeros((1, s, H, D), device="cuda")
    k = torch.zeros((1, s, KH, D), device="cuda")
    o = fa.flash_attention(q, k, torch.ones_like(k), causal=False,
                           dropout_p=p, dropout_seed=seed, impl="cuda")
    dropped = 1.0 - o[..., 0].double().mean().item() * (1.0 - p)
    n = H * s * s
    sigma = (p * (1.0 - p) / n) ** 0.5
    print(f"flash dropout: dropped fraction {dropped:.6f} of {n} pairs at "
          f"p = {p} (sigma {sigma:.2g}, |diff| / sigma "
          f"{abs(dropped - p) / sigma:.2f})", flush=True)
    if abs(dropped - p) > 3 * sigma + 1e-6:
        _fail(f"flash dropout: dropped fraction {dropped} is further than "
              f"3 sigma from p = {p}")
    return dropped


def _flash_times(torch, F, fa, args, q, k, v, do, seg, scale, causal,
                 window, cap, alibi=None):
    """Kernel, plain, library and bound times of B1-B3 at these inputs
    (``alibi``: the slopes, on the kernels' ALiBi instantiation; SDPA
    then takes the bias in a float mask)."""
    reps = max(3, args.reps // 5)
    geo = (seg, seg, causal, window, scale, cap, alibi)
    o, lse = fa._fwd_cuda(q, k, v, *geo)
    delta = fa._bwd_delta(o, do)
    out = {}
    out["fwd_ms"] = _time_ms(torch, lambda i: fa._fwd_cuda(q, k, v, *geo),
                             reps)
    out["bwd_dq_ms"] = _time_ms(torch, lambda i: fa._dq_cuda(
        q, k, v, do, lse, delta, *geo), reps)
    out["bwd_dkv_ms"] = _time_ms(torch, lambda i: fa._dkv_cuda(
        q, k, v, do, lse, delta, *geo), reps)
    # the plain backward computes dq, dk and dv in one call: both
    # backward kernels are held against that one time
    kw = dict(causal=causal, window=window, scale=scale, logit_softcap=cap,
              q_segment_ids=seg, kv_segment_ids=seg, alibi_slopes=alibi)
    out["plain_fwd_ms"] = _time_ms(torch, lambda i: fa.attention_reference(
        q, k, v, return_lse=True, **kw), 2, warm=1)
    out["plain_bwd_ms"] = _time_ms(
        torch, lambda i: fa.attention_reference_bwd(q, k, v, o, lse, do,
                                                    **kw), 2, warm=1)
    # yardstick: SDPA with the same dense mask on BHSD copies with the kv
    # heads expanded (forward; forward+backward minus forward)
    pairs, nbytes, mask = _flash_work(torch, q, k, seg, causal, window)
    H = q.shape[2]
    if cap == 0.0:
        bh = lambda t: t.repeat_interleave(H // t.shape[2], dim=2) \
            .transpose(1, 2).contiguous()
        qt, kt, vt, dot = bh(q), bh(k), bh(v), bh(do)
        m4 = mask[:, None] if mask.ndim == 3 else mask
        if alibi is not None:
            # the bias the kernels add, -slope |i + sk - sq - j|, on the
            # visible pairs; -inf on the others
            sq, sk = q.shape[1], k.shape[1]
            dist = (torch.arange(sq, device="cuda")[:, None] + sk - sq
                    - torch.arange(sk, device="cuda")[None]).abs().float()
            bias = -alibi[:, None, None] * dist
            m4 = torch.where(m4, bias, float("-inf")).to(q.dtype)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=m4)
        lib_fwd = _time_ms(torch, lambda i: sdpa(), reps)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

        def fwd_bwd(i):
            res = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
            torch.autograd.grad(res, (qg, kg, vg), dot)
        lib_all = _time_ms(torch, fwd_bwd, reps)
        out["library_fwd_ms"] = lib_fwd
        out["library_bwd_ms"] = lib_all - lib_fwd
        del qt, kt, vt, dot, qg, kg, vg
    else:
        out.update(_flex_times(torch, q, k, v, do, seg, causal, window, cap,
                               scale, o, reps))
    d = q.shape[-1]
    lib_name = ("flex_attention" if cap else "SDPA, dense float mask"
                if alibi is not None else "SDPA, dense mask")
    flops = {"fwd": 4 * d * pairs * H, "bwd_dq": 6 * d * pairs * H,
             "bwd_dkv": 8 * d * pairs * H}
    out["visible_pairs_per_head"] = pairs
    for kname in FLASH:
        tb = nbytes[kname] / PEAK_BYTES_PER_S
        tf = flops[kname] / PEAK_BF16_FLOPS
        out[f"{kname}_bytes"], out[f"{kname}_flops"] = nbytes[kname], \
            flops[kname]
        out[f"{kname}_bound_ms"] = max(tb, tf) * 1e3
        out[f"{kname}_bound_by"] = "bytes" if tb >= tf else "operations"
        # achieved rate on the algorithm's flops, and the share of the bound
        out[f"{kname}_tflops"] = flops[kname] / out[f"{kname}_ms"] / 1e9
        out[f"{kname}_bound_share"] = \
            out[f"{kname}_bound_ms"] / out[f"{kname}_ms"]
    dt = str(q.dtype).removeprefix("torch.") + ("" if d == D else
                                                 f", d {d}")
    print(f"flash train shape {dt}: visible pairs/head {pairs}; kernel ms fwd "
          f"{out['fwd_ms']:.3f} dq {out['bwd_dq_ms']:.3f} dkv "
          f"{out['bwd_dkv_ms']:.3f}; plain ms fwd {out['plain_fwd_ms']:.2f} "
          f"bwd {out['plain_bwd_ms']:.2f}; library ({lib_name}) ms fwd "
          f"{out.get('library_fwd_ms', float('nan')):.3f} bwd "
          f"{out.get('library_bwd_ms', float('nan')):.3f}; bound ms fwd "
          f"{out['fwd_bound_ms']:.4f} dq {out['bwd_dq_bound_ms']:.4f} dkv "
          f"{out['bwd_dkv_bound_ms']:.4f} ({out['fwd_bound_by']})",
          flush=True)
    print(f"flash train shape {dt}: achieved " + ", ".join(
        f"{kname} {out[f'{kname}_tflops']:.1f} TFLOP/s "
        f"({out[f'{kname}_tflops'] / (PEAK_BF16_FLOPS / 1e12):.3f} of the "
        f"{dt} peak), {out[f'{kname}_bound_share']:.3f} of its bound"
        for kname in FLASH) + f"; bwd_dq + bwd_dkv "
        f"{out['bwd_dq_ms'] + out['bwd_dkv_ms']:.3f} ms against {lib_name}'s "
        f"backward {out.get('library_bwd_ms', float('nan')):.3f} ms",
        flush=True)
    return out


# (softcap, sq, sk, causal, segments) -> _flex_fns, made once a run
_FLEX = {}


def _flex_fns(torch, cap, sq, sk, causal, seg):
    """(compiled flex_attention, score_mod, mask_mod, window): one set a
    softcap, shape and mask kind, the window (left, right; -1 none) read
    from a device tensor that the caller sets, so that a sliding and a
    global layer's calls (the same sizes) share one compile of the
    forward and one of the backward; ``seg`` is captured where given."""
    key = (cap, sq, sk, causal, seg is None)
    if seg is not None or key not in _FLEX:
        from torch.nn.attention.flex_attention import flex_attention
        win = torch.full((2,), -1, dtype=torch.int64, device="cuda")

        def mask_mod(bi, hi, qi, ki):
            qp = qi + (sk - sq)             # bottom-right aligned
            ok = qp >= ki if causal else qp >= 0
            ok = ok & ((win[0] < 0) | (qp - ki <= win[0]))
            ok = ok & ((win[1] < 0) | (ki - qp <= win[1]))
            if seg is not None:
                ok = ok & (seg[bi, qi] == seg[bi, ki])
            return ok

        def score_mod(s, bi, hi, qi, ki):
            return cap * torch.tanh(s / cap)
        fns = (torch.compile(flex_attention, dynamic=False), score_mod,
               mask_mod, win)
        if seg is not None:
            return fns
        _FLEX[key] = fns
    return _FLEX[key]


def _flex_times(torch, q, k, v, do, seg, causal, window, cap, scale, o,
                reps):
    """The library's time for a softcapped attention, which SDPA cannot
    compute: compiled flex_attention with the cap as its score_mod, the
    causal window and the documents as its block mask and the kv heads
    shared (enable_gqa), on [b, h, s, d] copies.  Forward; forward +
    backward less forward.  Its output is held against the kernel's
    ``o``; where flex_attention cannot run these shapes or disagrees,
    the times are left out and the reason printed (a yardstick only:
    the port never calls it)."""
    from torch.nn.attention.flex_attention import create_block_mask
    b, sq, _, _ = q.shape
    sk = k.shape[1]
    out = {}
    try:
        flex, score_mod, mask_mod, win = _flex_fns(torch, cap, sq, sk,
                                                   causal, seg)
        win.copy_(torch.tensor(window, device=q.device))
        bm = create_block_mask(mask_mod, None if seg is None else b, None,
                               sq, sk, device=q.device)
        bh = lambda t: t.transpose(1, 2).contiguous()
        qt, kt, vt, dot = bh(q), bh(k), bh(v), bh(do)

        def run(qq, kk, vv):
            return flex(qq, kk, vv, score_mod=score_mod, block_mask=bm,
                        scale=scale, enable_gqa=True)
        got = run(qt, kt, vt).transpose(1, 2).float()
        err = (got - o.float()).abs().max().item()
        out["library_max_abs_err"] = err
        if not torch.allclose(got, o.float(), atol=1e-2, rtol=5e-2):
            raise ValueError(f"it computes another function here: max "
                             f"|flex - kernel| {err:.3g}")
        lib_fwd = _time_ms(torch, lambda i: run(qt, kt, vt), reps)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

        def fwd_bwd(i):
            torch.autograd.grad(run(qg, kg, vg), (qg, kg, vg), dot)
        lib_all = _time_ms(torch, fwd_bwd, reps)
        out["library_fwd_ms"] = lib_fwd
        out["library_bwd_ms"] = lib_all - lib_fwd
    except Exception as e:                  # the yardstick, not the port
        out["library_error"] = f"{type(e).__name__}: {e}"[:600]
        print(f"flash library yardstick: flex_attention at {list(q.shape)}, "
              f"window {list(window)}, softcap {cap} did not run: "
              f"{out['library_error']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# context parallelism on one card
# ---------------------------------------------------------------------------

# the B-1 cases: a q chunk and a kv chunk of 2048 rows of a whole
# sequence of 8192, at their offsets.  name: (q_off, k_off, h_off, b_off,
# options)
CP_OFFSET_CASES = {
    # below the diagonal: every key visible (a large positive shift)
    "every_key_visible": (6144, 2048, 0, 0, {}),
    # documents that began in the kv chunk, an earlier one
    "segments_earlier_chunk": (4096, 2048, 0, 0, dict(segments=True)),
    # a windowed, non-causal step with a negative shift: the first rows
    # of the chunk see no key
    "negative_shift_window": (0, 2048, 0, 0,
                              dict(causal=False, window=(512, 512))),
    "alibi_window": (4096, 2048, 0, 0, dict(alibi=True, window=(3000, -1))),
    "dropout_segments": (4096, 2048, 8, 1,
                         dict(dropout_p=0.1, dropout_seed=77, segments=True)),
    "dropout_alibi_window": (6144, 4096, 16, 3,
                             dict(dropout_p=0.1, dropout_seed=5, alibi=True,
                                  window=(3000, -1))),
}
CP_CHUNK, CP_WHOLE = 2048, 8192
# the ring at full width: Llama-3-8B's attention over 32768 tokens of
# packed documents, in 4 chunks of 8192
CP_S, CP_RING = 32768, 4
# the virtual-rank schedules against one whole call through the same
# kernels (and against the plain version at 4096), bf16.  o: one bf16
# ulp plus the rounding of the steps' bf16 partials before their f32
# merge (atol 2e-3 + rtol 2e-2; read <= 0.40 of it on an H100, PERF.md).
# dq, dk, dv come through each side's own forward, and dk/dv sum the
# steps' bf16 partials, which can cancel: 1% of the largest reference
# entry plus rtol 1e-2, the card tests' tolerance for gradients through
# each path's own forward (_autograd_tol in tests/test_torch_kernels_
# cuda.py; read <= 0.33 of it, and 1.11 of the o limit).  lse f32
# (atol 1e-4, rtol 1e-5)
CP_TOL = dict(atol=2e-3, rtol=2e-2)
CP_LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def _cp_grad_tol(ref):
    return dict(atol=1e-2 * ref.float().abs().max().item(), rtol=1e-2)


def _worst(torch, a, r, tol):
    a, r = a.float(), r.float()
    err = (a - r).abs()
    return err.max().item(), (err / (tol["atol"] + tol["rtol"]
                                     * r.abs())).max().item()


def _cp_offsets(torch, fa, rng, d):
    """B1-B3 at the B-1 offsets against the plain versions at the same
    offsets, bf16, heads of ``d``; and the control, the kernels at zero
    offsets, which must part from them."""
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    tol = dict(atol=1e-3, rtol=1e-2)          # one bf16 ulp (flash phase)
    worst, errs, controls = 0.0, 0.0, []
    # documents long enough to span the chunks' distance
    seg_all = segment_ids_from_positions(torch.from_numpy(
        _packed_positions(rng, 1, CP_WHOLE, 1024, 8192))).cuda()
    slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device="cuda",
                                         dtype=torch.float32) / H)
    for name, (q_off, k_off, h_off, b_off, opts) in CP_OFFSET_CASES.items():
        opts = dict(opts)
        q, k, v, do, _ = _flash_inputs(torch, rng, 1, CP_CHUNK, CP_CHUNK,
                                       torch.bfloat16, False, d)
        kw = dict(opts, q_offset=q_off, k_offset=k_off, h_offset=h_off,
                  b_offset=b_off)
        if kw.pop("segments", False):
            kw.update(q_segment_ids=seg_all[:, q_off:q_off + CP_CHUNK]
                      .contiguous(),
                      kv_segment_ids=seg_all[:, k_off:k_off + CP_CHUNK]
                      .contiguous())
        if kw.pop("alibi", False):
            kw["alibi_slopes"] = slopes
        o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda",
                                    **kw)
        ro, rlse = fa.flash_attention(q, k, v, return_lse=True,
                                      impl="torch", **kw)
        got = (o, lse) + fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                impl="cuda", **kw)
        ref = (ro, rlse) + fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                  impl="torch", **kw)
        torch.cuda.synchronize()
        line, bad = [], []
        for key, a, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                _fail(f"cp offsets {name} d{d}: non-finite {key}")
            e, w = _worst(torch, a, r, dict(atol=1e-5, rtol=1e-5)
                          if key == "lse" else tol)
            errs, worst = max(errs, e), max(worst, w)
            line.append(f"{key} {e:.3g} ({w:.3g} of the limit)")
            if w > 1.0:
                bad.append(key)
        zero = dict(kw, q_offset=0, k_offset=0, h_offset=0, b_offset=0)
        o0 = fa.flash_attention(q, k, v, impl="cuda", **zero)
        c = _worst(torch, o0, ro, tol)[1]
        controls.append(c)
        print(f"cp offsets {name} d{d}: " + ", ".join(line)
              + f"; control at zero offsets {c:.3g} of the limit (must "
              f"exceed 1)", flush=True)
        if bad:
            _fail(f"cp offsets {name} d{d}: {bad} disagree with the plain "
                  f"version at the same offsets")
        empty = lse <= -1e29
        if name == "negative_shift_window":
            if not empty[:, :, :CP_CHUNK // 2].all() or \
                    o[:, :CP_CHUNK // 2].abs().max().item() != 0.0:
                _fail("cp offsets: the rows of a negative shift that see "
                      "no key must give o = 0 and lse = NEG_INF")
        if c <= 1.0:
            _fail(f"cp offsets {name} d{d}: the kernels at zero offsets "
                  f"stay within the limit ({c}): the check cannot see the "
                  f"offsets")
        del q, k, v, do, o, lse, ro, rlse, got, ref, o0
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "worst_over_tol": worst,
            "control_min_over_tol": min(controls)}


def _cp_schedules(torch, fa, cp, rng):
    """The ring (4 virtual ranks), Ulysses (2 head groups) and 2D (both)
    schedules of ``cp_attention`` through the package's own step, skip
    and merge functions on B1-B3, at full width and 32768 tokens, against
    one whole call at 32768; the ring again against the plain version at
    4096.  Dropout on: the same seed draws the same masks in both."""
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_cp_virtual import virtual_cp_attention
    q, k, v, do, _ = _flash_inputs(torch, rng, 1, CP_S, CP_S,
                                   torch.bfloat16, False)
    seg = segment_ids_from_positions(torch.from_numpy(
        _packed_positions(rng, 1, CP_S, 256, 4096))).cuda()
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg,
              dropout_p=0.1, dropout_seed=2024)
    whole = fa.flash_attention(q, k, v, return_lse=True, impl="cuda", **kw)
    whole = whole + fa.flash_attention_bwd(q, k, v, *whole, do, impl="cuda",
                                           **kw)
    s = CP_S // CP_RING
    kept = sum(cp.step_should_run(me, (me - i) % CP_RING, s, True, (-1, -1))
               for me in range(CP_RING) for i in range(CP_RING))
    out = {"kept_steps": kept, "steps": CP_RING * CP_RING}
    for tag, ring_n, ul_n in (("ring", CP_RING, 1), ("ulysses", 1, 2),
                              ("2d", CP_RING, 2)):
        for name in fa.launch_counts:
            fa.launch_counts[name] = 0
        got = virtual_cp_attention(q, k, v, do, ring_n=ring_n, ul_n=ul_n,
                                      impl="cuda", **kw)
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        want = (kept if ring_n > 1 else 1) * ul_n
        if launches != {"fwd": want, "bwd_dq": want, "bwd_dkv": want}:
            _fail(f"cp {tag}: launches {launches}, want {want} of each "
                  f"(the steps step_should_run keeps x head groups)")
        rec = {"launches": launches}
        rec.update(_cp_compare(torch, got, whole, f"cp {tag} ({ring_n} ring "
                               f"x {ul_n} ulysses virtual ranks, s {CP_S}; "
                               f"launches {launches}) against the whole "
                               f"call"))
        out[tag] = rec
        del got
    # device times: the ring's forward and forward + backward beside the
    # whole call's
    reps = 3
    out["whole_fwd_ms"] = _time_ms(torch, lambda i: fa.flash_attention(
        q, k, v, return_lse=True, impl="cuda", **kw), reps, warm=1)
    out["ring_fwd_ms"] = _time_ms(torch, lambda i: virtual_cp_attention(
        q, k, v, ring_n=CP_RING, impl="cuda", **kw), reps, warm=1)
    out["whole_fwd_bwd_ms"] = _time_ms(torch, lambda i: fa.flash_attention_bwd(
        q, k, v, *fa.flash_attention(q, k, v, return_lse=True, impl="cuda",
                                     **kw), do, impl="cuda", **kw),
        reps, warm=1)
    out["ring_fwd_bwd_ms"] = _time_ms(
        torch, lambda i: virtual_cp_attention(
            q, k, v, do, ring_n=CP_RING, impl="cuda", **kw), reps, warm=1)
    pairs = _flash_work(torch, q, k, seg, True, (-1, -1))[0]
    out["visible_pairs_per_head"] = pairs
    out["fwd_bound_ms"] = 4 * D * pairs * H / PEAK_BF16_FLOPS * 1e3
    print(f"cp ring at s {CP_S}: device ms forward {out['ring_fwd_ms']:.2f} "
          f"against the whole call's {out['whole_fwd_ms']:.2f} "
          f"({out['ring_fwd_ms'] / out['whole_fwd_ms']:.3f}x); forward + "
          f"backward {out['ring_fwd_bwd_ms']:.2f} against "
          f"{out['whole_fwd_bwd_ms']:.2f} "
          f"({out['ring_fwd_bwd_ms'] / out['whole_fwd_bwd_ms']:.3f}x); "
          f"visible pairs/head {pairs}, B1's bound "
          f"{out['fwd_bound_ms']:.2f} ms", flush=True)
    del q, k, v, do, seg, whole
    torch.cuda.empty_cache()
    # the ring against the plain version, at 4096 split in 4
    q, k, v, do, seg = _flash_inputs(torch, rng, 1, 4096, 4096,
                                     torch.bfloat16, True)
    kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    ref = fa.attention_reference(q, k, v, return_lse=True, **kw)
    ref = ref + fa.attention_reference_bwd(q, k, v, *ref, do, **kw)
    got = virtual_cp_attention(q, k, v, do, ring_n=CP_RING, impl="cuda",
                                  **kw)
    torch.cuda.synchronize()
    out["ring_vs_plain_4096"] = _cp_compare(
        torch, got, ref, "cp ring at s 4096 against the plain version")
    del q, k, v, do, seg, ref, got
    torch.cuda.empty_cache()
    return out


def _cp_compare(torch, got, ref, what):
    """``{key: {max_abs_err, ref_max, worst_over_tol}}`` of (o, lse, dq, dk,
    dv) against ``ref``, printed; fails past the limits."""
    rec, line = {}, []
    for key, a, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        if not torch.isfinite(a).all():
            _fail(f"{what}: non-finite {key}")
        e, w = _worst(torch, a, r, CP_LSE_TOL if key == "lse" else
                      CP_TOL if key == "o" else _cp_grad_tol(r))
        rec[key] = {"max_abs_err": e, "ref_max": r.float().abs().max().item(),
                    "worst_over_tol": w}
        line.append(f"{key} {e:.3g} (ref max {rec[key]['ref_max']:.3g}; "
                    f"{w:.3g} of the limit)")
    print(f"{what}: " + ", ".join(line), flush=True)
    bad = [key for key in rec if rec[key]["worst_over_tol"] > 1.0]
    if bad:
        _fail(f"{what}: {bad} past the limit")
    return rec


def _cp_phase(torch, args):
    """Context parallelism on one card: B-1 at heads of 128 and 64, then
    the ring, Ulysses and 2D schedules over virtual ranks."""
    import numpy as np
    import torchacc_tpu_torch.ops.context_parallel as cp
    import torchacc_tpu_torch.ops.flash_attention as fa
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 12)
    res = {"offsets": {d: _cp_offsets(torch, fa, rng, d) for d in (D, 64)}}
    res.update(_cp_schedules(torch, fa, cp, rng))
    res["seconds"] = time.perf_counter() - t0
    print(f"cp phase: {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# quantized-matmul kernel phase
# ---------------------------------------------------------------------------

def _qmm_inputs(torch, rng, m, k, n, dtype):
    """Activations ~N(0, 1) with a few outliers (what a delayed scale
    clips), a weight [N, K] (the nn.Linear layout) ~N(0, 0.02) with
    per-channel spread."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.float32)
    x[::97, ::89] *= 6.0
    w = torch.randn((n, k), generator=gen, device="cuda",
                    dtype=torch.float32) * 0.02
    w *= 1.0 + 3.0 * torch.rand((n, 1), generator=gen, device="cuda")
    return x.to(dtype), w.to(dtype)


def _qmm_phase(torch, args):
    """B5 against the plain version; times at the main path's shapes."""
    import numpy as np
    import torchacc_tpu_torch.ops.quantized_matmul as qm
    rng = np.random.default_rng(args.seed + 4)
    m = TRAIN_B * TRAIN_S
    # fp8: the kernels quantize to the same e4m3 values and sum the same
    # exact products in f32 (on the f16 tensor cores) in another order
    # than the plain f32 matmul; the output is bf16, so one bf16 ulp
    # (atol 1e-3 + rtol 1e-2); f32 outputs: 1e-4 of the value + 1e-4 (K up
    # to 14336 f32 terms).  The atol grows with the scales of x and w.
    # f16 outputs: two f16 ulps (2^-10 of the value each)
    fp8_tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
               torch.float16: dict(atol=1e-3, rtol=2e-3),
               torch.float32: dict(atol=1e-4, rtol=1e-4)}
    # name -> (m, k, n, dtype, weight layout, x and w multipliers)
    cases = {name: (m, k, n, torch.bfloat16, "nk", (1.0, 1.0))
             for name, (k, n, _) in QMM_SITES.items()}
    # the fp16 step's sites (compute.dtype float16), and the 'head' site:
    # the vocab projection of llama3-8b (K 4096 -> N 128256 = 501 tiles
    # of 256) in bf16 and f16, and GPT-2's ragged one (K 768 -> N 50257,
    # 8 x 1024 tokens) in f16
    cases.update({f"{name}_f16": (m, k, n, torch.float16, "nk", (1.0, 1.0))
                  for name, (k, n, _) in QMM_SITES.items()})
    cases["head"] = (m,) + QMM_HEAD + (torch.bfloat16, "nk", (1.0, 1.0))
    cases["head_f16"] = (m,) + QMM_HEAD + (torch.float16, "nk", (1.0, 1.0))
    cases["head_ragged_f16"] = (m, 768, 50257, torch.float16, "nk",
                                (1.0, 1.0))
    cases["ragged"] = (1000, 1111, 777, torch.bfloat16, "nk", (1.0, 1.0))
    cases["ragged_kn"] = (1000, 1111, 777, torch.bfloat16, "kn", (1.0, 1.0))
    cases["k_5_mod_16"] = (1000, 1029, 520, torch.bfloat16, "nk", (1.0, 1.0))
    cases["f32"] = (1024, 512, 768, torch.float32, "nk", (1.0, 1.0))
    cases["f32_kn"] = (1024, 512, 768, torch.float32, "kn", (1.0, 1.0))
    # scales near the ends of the f32 range take the division itself
    cases["tiny_x_huge_w"] = (512, 1111, 520, torch.bfloat16, "nk",
                              (1e-23, 1e27))
    cases["huge_x_tiny_w"] = (512, 1111, 520, torch.bfloat16, "kn",
                              (1e27, 1e-23))
    results = {fmt: {} for fmt in ("int8", "fp8")}
    one = torch.ones((), device="cuda")
    for name, (mm, k, n, dtype, layout, (mx, mw)) in cases.items():
        x, w = _qmm_inputs(torch, rng, mm, k, n, dtype)
        x, w = (x.float() * mx).to(dtype), (w.float() * mw).to(dtype)
        wt = w.t() if layout == "nk" else w.t().contiguous()   # [K, N]
        timed = name.replace("_f16", "") in QMM_SITES or name.startswith(
            "head")
        if timed:
            a = torch.empty((mm, n), device="cuda", dtype=dtype)
            bf16_ms = _time_ms(torch, lambda i: torch.matmul(x, wt, out=a),
                               args.reps)
            del a
        for fmt in ("int8", "fp8"):
            # a delayed scale below the tensor's amax: some values clip
            sx = qm.compute_scale(qm._amax(x) * 0.5, fmt)
            sw = qm.per_channel_scale(wt, fmt)
            got = qm._qmm2d_cuda(x, wt, sx, sw, fmt)
            ref = qm._qmm2d_plain(x, wt, sx, sw, fmt).to(dtype)
            plan, x2, w2, sx2, sw2 = qm._cuda_operands(x, wt, sx, sw, fmt)
            qx, qw = qm._quantize_cuda(plan, x2, w2, sx2, sw2, fmt)
            px, pw = qm._quantize_pass_plain(x, wt, sx, sw, fmt)
            torch.cuda.synchronize()
            bad = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                      for a, b in ((qx, px), (qw, pw)))
            if bad:
                _fail(f"qmm {fmt} {name}: the quantize kernel differs from "
                      f"the plain quantize pass in {bad} bytes")
            del px, pw
            if not torch.isfinite(got).all():
                _fail(f"qmm {fmt} {name}: non-finite output")
            err = (got.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            rec = {"m": mm, "k": k, "n": n, "dtype": str(dtype),
                   "layout": layout, "max_abs_err": err, "ref_max": ref_max}
            if fmt == "int8":
                if not torch.equal(got, ref):
                    _fail(f"qmm int8 {name}: the kernel is not bitwise the "
                          f"plain version (max abs err {err})")
            else:
                try:
                    torch.testing.assert_close(
                        got.float(), ref.float(), rtol=fp8_tol[dtype]["rtol"],
                        atol=fp8_tol[dtype]["atol"] * mx * mw)
                except AssertionError as e:
                    _fail(f"qmm fp8 {name} disagrees with the plain "
                          f"version: {e}")
            del got, ref
            if timed:
                ops = 2 * mm * n * k
                rec["ms"] = _time_ms(torch, lambda i: qm._qmm2d_cuda(
                    x, wt, sx, sw, fmt), args.reps)
                rec["quantize_ms"] = _time_ms(
                    torch, lambda i: qm._quantize_cuda(
                        plan, x2, w2, sx2, sw2, fmt), args.reps)
                rec["gemm_ms"] = _time_ms(torch, lambda i: qm._gemm_cuda(
                    plan, qx, qw, sx2, sw2, fmt, dtype), args.reps)
                rec["gemm_tops"] = ops / rec["gemm_ms"] / 1e9
                rec["host_ms"] = _host_ms(torch, lambda: qm._qmm2d_cuda(
                    x, wt, sx, sw, fmt))
                rec["bf16_matmul_host_ms"] = _host_ms(
                    torch, lambda: torch.matmul(x, wt))
                rec["plain_ms"] = _time_ms(torch, lambda i: qm._qmm2d_plain(
                    x, wt, sx, sw, fmt), 2, warm=1)
                rec["bf16_matmul_ms"] = bf16_ms   # the matmul in dtype
                # yardstick: one library call on operands quantized before
                lq = qm.quantize(x, sx, fmt)
                lw = qm.quantize(w, sw[:, None], fmt)        # [N, K]
                try:
                    if fmt == "int8":
                        lib = lambda i: torch._int_mm(lq, lw.t())
                    else:
                        lib = lambda i: torch._scaled_mm(
                            lq, lw.t(), scale_a=one, scale_b=one,
                            out_dtype=dtype)
                    rec["library_ms"] = _time_ms(torch, lib, args.reps)
                except Exception as e:       # the private call's signature
                    print(f"qmm {fmt} {name}: no library time "
                          f"({type(e).__name__}: {e})", flush=True)
                    rec["library_ms"] = None
                del lq, lw
                e = x.element_size()
                nbytes = (mm * k + k * n + mm * n) * e + 4 * (n + 1)
                tb, tf = nbytes / PEAK_BYTES_PER_S, ops / PEAK_8BIT_OPS
                rec.update(bytes=nbytes, ops=ops, bound_ms=max(tb, tf) * 1e3,
                           bound_by="bytes" if tb >= tf else "operations",
                           # the quantize pass: the operands read, the
                           # quantized operands written, once
                           quantize_bound_ms=(mm * k + k * n)
                           * (e + qx.element_size()) / PEAK_BYTES_PER_S * 1e3)
            del qx, qw
            results[fmt][name] = rec
            lib_ms = rec.get("library_ms")
            print(f"qmm {fmt} {name} [{mm}x{k}]x[{k}x{n}] {dtype} {layout}: "
                  f"max_abs_err {err:.3g} (ref max {ref_max:.3g})"
                  + (f"; call {rec['ms']:.4f} ms = quantize "
                     f"{rec['quantize_ms']:.4f} (bound "
                     f"{rec['quantize_bound_ms']:.4f}) + GEMM "
                     f"{rec['gemm_ms']:.4f} ms ({rec['gemm_tops']:.0f} TOP/s, "
                     + (f"{rec['gemm_tops'] * 1e12 / PEAK_8BIT_OPS:.3f} of the "
                        f"8-bit peak" if fmt == "int8" else
                        f"{rec['gemm_tops'] * 1e12 / PEAK_BF16_FLOPS:.3f} of "
                        f"the f16 peak")
                     + f"), host {rec['host_ms']:.4f} ms a call (bf16 matmul "
                     f"{rec['bf16_matmul_host_ms']:.4f}), plain "
                     f"{rec['plain_ms']:.2f} ms, library "
                     + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
                     + f", bf16 matmul {bf16_ms:.4f} ms, bound "
                     f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                     if timed else ""), flush=True)
        del x, w, wt
        torch.cuda.empty_cache()
    results["fp8_accumulation"] = _fp8_accumulation(torch, qm, rng, m)
    # per launch on the main path: the mean over one layer's 7 launches,
    # in bf16 and in f16
    for fmt in ("int8", "fp8"):
        recs = results[fmt]
        per_layer = sum(c for _, _, c in QMM_SITES.values())
        for suffix in ("", "_f16"):
            summary = {}
            for key in ("ms", "quantize_ms", "gemm_ms", "plain_ms",
                        "bound_ms", "library_ms", "bf16_matmul_ms"):
                vals = [recs[s + suffix][key] for s in QMM_SITES]
                summary[key] = (None if any(v is None for v in vals) else
                                sum(v * QMM_SITES[s][2] for v, s in
                                    zip(vals, QMM_SITES)) / per_layer)
            summary["max_abs_err"] = max(recs[s + suffix]["max_abs_err"]
                                         for s in QMM_SITES)
            summary["bound_by"] = recs["gate_up" + suffix]["bound_by"]
            recs["per_launch" + suffix] = summary
    return results


def _fp8_accumulation(torch, qm, rng, m):
    """The fp8 GEMM's sum against an f64 product of the same e4m3
    operands at down's shape (K = 14336), beside the plain f32 matmul's:
    max |err| / max |ref|, and the mean |err| / mean |ref|."""
    k, n, _ = QMM_SITES["down"]
    x, w = _qmm_inputs(torch, rng, m, k, n, torch.bfloat16)
    sx = qm.compute_scale(qm._amax(x), "fp8")
    sw = qm.per_channel_scale(w.t(), "fp8")
    plan, x2, w2, sx2, sw2 = qm._cuda_operands(x, w.t(), sx, sw, "fp8")
    qx, qw = qm._quantize_cuda(plan, x2, w2, sx2, sw2, "fp8")
    ref = (qx.double() @ qw.double().t()) * (sx2.double() * sw2.double())
    scale, mean = ref.abs().max().item(), ref.abs().mean().item()
    out = {}
    for name in ("plain_f32", "kernel"):
        if name == "plain_f32":
            got = qm._gemm_plain(qx, qw, sx2, sw2, "fp8")
        else:
            got = qm._gemm_cuda(plan, qx, qw, sx2, sw2, "fp8", torch.float32)
        d = (got.double() - ref).abs()
        out[name] = {"max_rel": d.max().item() / scale,
                     "mean_rel": d.mean().item() / mean}
        del got, d
    print("qmm fp8 accumulation at K = 14336 against an f64 product of the "
          "same e4m3 operands (max |err| / max |ref|, mean |err| / mean "
          "|ref|): " + "; ".join(
              f"{k} {v['max_rel']:.3g}, {v['mean_rel']:.3g}"
              for k, v in out.items()), flush=True)
    if out["kernel"]["max_rel"] > FP8_F64_LIMIT:
        _fail(f"qmm fp8: the kernel's sum parts from the f64 product by "
              f"{out['kernel']['max_rel']:.3g} of max |ref| > "
              f"{FP8_F64_LIMIT:g}")
    del x, w, x2, w2, qx, qw, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

def _train_batch(torch, rng, vocab):
    """One batch of TRAIN_B x TRAIN_S tokens packed from documents of
    numpy-seeded lengths, with positions and segment ids, on the card."""
    import numpy as np
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    pos = torch.from_numpy(_packed_positions(rng, TRAIN_B, TRAIN_S, 256,
                                             2048))
    ids = rng.integers(0, vocab, size=(TRAIN_B, TRAIN_S)).astype(np.int64)
    return {"input_ids": torch.from_numpy(ids).cuda(),
            "positions": pos.cuda(),
            "segment_ids": segment_ids_from_positions(pos).cuda()}


def _training_phase(torch, args, quant="none", steps=None, ref_loss=None):
    """Train llama3-8b at full width through accelerate() ->
    Trainer.step.  ``quant``: compute.quant of the run; ``ref_loss``: the
    unquantized run's first-step loss, which a quantized run's must lie
    within 2% of (the JAX package's own bar)."""
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    import torchacc_tpu_torch.ops.quantized_matmul as qm
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.train import adamw, warmup_cosine

    layers, warm = args.train_layers, 2
    steps = args.train_steps if steps is None else steps
    tag = "training" if quant == "none" else f"training[{quant}]"
    if steps < warm + 2:
        _fail(f"{tag}: at least {warm + 2} steps are needed")
    print(f"{tag}: llama3-8b at full width, depth cut to {layers} of 32 "
          f"layers", flush=True)
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(bf16_compute_params=True,
                                        quant=quant),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  seed=args.seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the schedule's length does not depend on the run, so that a
    # quantized run's steps see the unquantized run's learning rates
    trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
        warmup_cosine(3e-4, args.train_steps, warmup_steps=1)))
    state = trainer.init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"{tag}: {n_params / 1e9:.3f}B params (f32 masters, AdamW, "
          f"bf16 shadow) made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    batch = _train_batch(torch, np.random.default_rng(args.seed + 2),
                         cfg.vocab_size)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses, norms = [], []
    for counts in (fa.launch_counts, qm.launch_counts):
        for key in counts:               # counts start here ...
            counts[key] = 0
    ev[0].record()
    for i in range(steps):
        m = trainer.step(batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)    # ... and are read here
    qmm_launches = dict(qm.launch_counts)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    losses = [x.item() for x in losses]
    norms = [x.item() for x in norms]
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warm:]
    ms = sum(timed) / len(timed)
    tokens = TRAIN_B * TRAIN_S
    # bench.py:566-568: 6N per token (N = every parameter, embedding and
    # head included) + causal attention 6 * L * hidden * seq
    flops_tok = 6.0 * n_params + 6.0 * layers * cfg.hidden_size * TRAIN_S
    mfu = flops_tok * tokens / (ms / 1e3) / PEAK_BF16_FLOPS
    print(f"{tag}: losses {_fmt(losses)}; grad norms {_fmt(norms)}",
          flush=True)
    print(f"{tag}: step ms {_fmt(step_ms)} (first {warm} warm-up); "
          f"mean of the timed {ms:.1f} ms, {tokens / (ms / 1e3):.0f} "
          f"tokens/s, MFU {mfu:.4f} of the bf16 peak 989 TFLOP/s (6N + "
          f"6*L*h*s per token, N = {n_params}); peak allocated "
          f"{peak / 2**30:.2f} GiB; flash launches {launches}; quantized-"
          f"matmul launches {qmm_launches}", flush=True)
    if not all(np.isfinite(losses)):
        _fail(f"{tag}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"{tag}: the loss did not fall on the repeated batch: "
              f"{losses}")
    for key, n in launches.items():
        if n != layers * steps:
            _fail(f"{tag}: flash {key} launches {n} != layers {layers} x "
                  f"steps {steps} (a re-run forward means remat recomputed "
                  f"the attention)")
    for fmt, n in qmm_launches.items():
        want = 7 * layers * steps if fmt == quant else 0
        if n != want:
            _fail(f"{tag}: quantized-matmul {fmt} launches {n} != {want} "
                  f"(7 sites x layers {layers} x steps {steps}; more means "
                  f"remat re-ran the kernel)")
    if quant != "none":
        rel = abs(losses[0] - ref_loss) / ref_loss
        print(f"{tag}: first-step loss {losses[0]:.5f} against the "
              f"unquantized {ref_loss:.5f}: relative difference {rel:.3g} "
              f"(limit 0.02)", flush=True)
        if rel > 0.02:
            _fail(f"{tag}: the first-step loss parts from the unquantized "
                  f"one by {rel:.3g} > 0.02")
        hists = trainer.state.quant
        filled = min(steps, cfg.quant_amax_history_len)
        nonzero = torch.stack([(h > 0).sum() for h in hists.values()])
        newest = torch.stack([(h[:filled] > 0).all()
                              for h in hists.values()])
        if (len(hists) != 7 * layers
                or not bool((nonzero == filled).all())
                or not bool(newest.all())):
            _fail(f"{tag}: every one of the {7 * layers} amax histories "
                  f"must hold {filled} non-zero entries, the newest first; "
                  f"got {len(hists)} histories with {nonzero.tolist()}")
        amax = torch.stack([h[0] for h in hists.values()])
        print(f"{tag}: {len(hists)} amax histories, {filled} entries each; "
              f"newest amax {amax.min().item():.3g}..{amax.max().item():.3g}",
              flush=True)
    if args.profile:
        _profile_step(torch, trainer, batch, tag)
    del trainer, state, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "qmm_launches": qmm_launches,
            "step_ms": ms, "mfu": mfu, "losses": losses, "peak_bytes": peak,
            "tokens_per_s": tokens / (ms / 1e3), "steps": steps}


def _profile_step(torch, trainer, batch, tag="training"):
    """One more training step under torch.profiler: device time by
    kernel (the top ones on stdout, the whole table and a chrome trace
    under train_profile/), and the device's busy and idle share of the
    step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "train_profile" if tag == "training"
                           else "train_profile_" + tag[9:-1])
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern, busy_ms, groups = _device_groups(prof, lambda name: (
        "flash attention" if "::fwd_" in name or "::bwd_d" in name
        else "quantized matmul (B5)" if "qmm_" in name
        else _serving_group(name)))
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=80))
    prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    print(f"profile {tag}: one step, wall {wall_ms:.1f} ms (profiled), device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
          + "; ".join(f"{g} {ms:.1f} ms" for g, ms in sorted(
              groups.items(), key=lambda kv: -kv[1])), flush=True)
    for a in kern[:15]:
        print(f"profile {tag}: {a.self_device_time_total / 1e3:9.2f} ms "
              f"x{a.count:<5d} {a.key[:110]}", flush=True)


# ---------------------------------------------------------------------------
# data-fed training and the fp16 step
# ---------------------------------------------------------------------------

def _zipf_docs(seed, n_tokens, vocab, lo=256, hi=2048):
    """Documents of lengths in [lo, hi) made by numpy from ``seed``, their
    tokens drawn from a Zipf law (exponent 1.2) over the vocabulary: a
    low-entropy source, so that the loss on distinct batches falls."""
    import numpy as np
    rng = np.random.default_rng(seed)
    docs, total = [], 0
    while total < n_tokens:
        n = int(rng.integers(lo, hi))
        docs.append((np.minimum(rng.zipf(1.2, size=n), vocab) - 1)
                    .astype(np.int32))
        total += n
    return docs


class _StepTap:
    """Wraps ``trainer.step`` for a fit: a CUDA event before each step
    (the device's time between two is the step as the feed delivers it),
    the step's metrics kept on the device, and a hook before and after
    each step."""

    def __init__(self, torch, trainer, before=None, after=None):
        self.torch, self.trainer = torch, trainer
        self.inner = trainer.step
        self.events, self.metrics = [], []
        self.before, self.after = before, after
        trainer.step = self

    def __call__(self, batch):
        torch = self.torch
        if self.before is not None:
            self.before(len(self.metrics), batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        m = self.inner(batch)
        self.metrics.append(m)
        if self.after is not None:
            self.after(len(self.metrics) - 1, batch, m)
        return m

    def finish(self, warm):
        """(step ms of every step, mean of the steps after ``warm``)."""
        torch = self.torch
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        evs = self.events + [end]
        ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(len(self.events))]
        timed = ms[warm:]
        del self.trainer.step            # the class's step again
        return ms, sum(timed) / max(len(timed), 1)


def _witness_limit():
    """The data-fed run against its grad_accum=1 witness: the largest
    relative difference allowed between their losses at any step.  Set
    from readings (PERF.md; H100: 1.1e-3 to 1.4e-3 over 10 and 12 steps,
    2.0e-2 over 16): the two differ by the bf16 rounding of the
    micro-batches' gradients before their f32 sum, which the updates
    carry forward and the loss spikes of a fresh model at lr 3e-4
    amplify."""
    return 0.05


def _data_training_phase(torch, args, hand_fed):
    """accelerate(cfg, PackedDataset(...), Config(grad_accum=2, data=...))
    -> Trainer.fit(loader): llama3-8b at full width, --train-layers deep,
    fed by the AsyncLoader from numpy-seeded Zipf documents."""
    import numpy as np
    import torchacc_tpu_torch.data.packing as packing
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, accelerate,
                                    get_preset)
    from torchacc_tpu_torch.train import adamw, warmup_cosine

    layers, steps, warm, rows = args.train_layers, args.data_steps, 2, 4
    tag = "data-fed training"
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  data=DataConfig(max_length=TRAIN_S, prefetch=2),
                  grad_accum=2, seed=args.seed)
    docs = _zipf_docs(args.seed + 5, (steps + 1) * rows * TRAIN_S,
                      cfg.vocab_size)
    make = lambda: PackedDataset(docs, seq_len=TRAIN_S, batch_rows=rows)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, loader = accelerate(cfg, make(), conf, optimizer=adamw(
        warmup_cosine(3e-4, steps, warmup_steps=1)))
    trainer.init()
    received, waited = [], []

    def keep(i, batch):
        if not all(t.is_cuda for t in batch.values()):
            _fail(f"{tag}: the loader gave the trainer host tensors")
        received.append({k: v.clone() for k, v in batch.items()})
        waited.append(loader.wait_s)     # the host's wait up to this batch
    tap = _StepTap(torch, trainer, before=keep)
    for key in fa.launch_counts:             # counts start here ...
        fa.launch_counts[key] = 0
    trainer.fit(loader, max_steps=steps, log_every=0)
    step_ms, ms = tap.finish(warm)
    launches = dict(fa.launch_counts)        # ... and are read here
    losses = [m["loss"].item() for m in tap.metrics]
    peak = torch.cuda.max_memory_allocated()
    # the host's wait on the queue for each timed step's batch
    wait_ms = (waited[-1] - waited[warm - 1]) * 1e3 / (steps - warm)
    n_params = sum(p.numel() for p in trainer.state.params.values())
    tokens = rows * TRAIN_S
    flops_tok = 6.0 * n_params + 6.0 * layers * cfg.hidden_size * TRAIN_S
    mfu = flops_tok * tokens / (ms / 1e3) / PEAK_BF16_FLOPS
    host = list(itertools.islice(iter(make()), steps))
    mismatched = [i for i, (got, want) in enumerate(zip(received, host))
                  if sorted(got) != sorted(want) or not all(
                      np.array_equal(got[k].cpu().numpy(), want[k])
                      and got[k].dtype == getattr(torch, str(want[k].dtype))
                      for k in want)]
    print(f"{tag}: llama3-8b at full width, {layers} layers, grad_accum 2 "
          f"over {rows} x {TRAIN_S} packed tokens a step; packer "
          f"{packing.last_packer}; losses {_fmt(losses)}", flush=True)
    print(f"{tag}: step ms {_fmt(step_ms)} (first {warm} warm-up); mean of "
          f"the timed {ms:.1f} ms against the hand-fed step's "
          f"{hand_fed['step_ms']:.1f} ms (2 x 4096 tokens, one micro-batch), "
          f"{tokens / (ms / 1e3):.0f} tokens/s, MFU {mfu:.4f} of the bf16 "
          f"peak; peak allocated {peak / 2**30:.2f} GiB (with the f32 "
          f"accumulators); host wait on the loader's queue "
          f"{wait_ms:.3f} ms a timed step ({waited[warm - 1] * 1e3:.1f} ms "
          f"for the first {warm}); flash launches {launches}", flush=True)
    if packing.last_packer != "native":
        _fail(f"{tag}: the sequence packer ran {packing.last_packer!r}, "
              f"not the native one")
    if len(received) != steps or mismatched:
        _fail(f"{tag}: the batches the trainer received differ from the "
              f"PackedDataset's on the host (steps {mismatched}, "
              f"{len(received)} received)")
    for key, n in launches.items():
        if n != layers * steps * 2:
            _fail(f"{tag}: flash {key} launches {n} != layers {layers} x "
                  f"steps {steps} x 2 micro-batches")
    del trainer, loader, received, tap
    gc.collect()
    torch.cuda.empty_cache()
    # the witness: grad_accum=1 over the same batches from the same
    # weights, so that the trajectory's shape is the optimizer's and not
    # the accumulation's or the feed's
    conf1 = Config(compute=ComputeConfig(bf16_compute_params=True),
                   memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                   data=DataConfig(max_length=TRAIN_S, prefetch=2),
                   grad_accum=1, seed=args.seed)
    trainer, loader = accelerate(cfg, make(), conf1, optimizer=adamw(
        warmup_cosine(3e-4, steps, warmup_steps=1)))
    trainer.init()
    tap = _StepTap(torch, trainer)
    trainer.fit(loader, max_steps=steps, log_every=0)
    tap.finish(warm)
    one = [m["loss"].item() for m in tap.metrics]
    apart = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
    limit = _witness_limit()
    print(f"{tag}: witness grad_accum=1 on the same batches and weights: "
          f"losses {_fmt(one)}; largest relative difference from grad_accum"
          f"=2 {apart:.4g} (limit {limit:.3g})", flush=True)
    del trainer, loader, tap
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        _fail(f"{tag}: a loss is not finite: {losses}")
    if not apart <= limit:
        _fail(f"{tag}: grad_accum=2 parts from grad_accum=1 on the same "
              f"batches by {apart:.4g} > {limit:.3g}")
    if not np.mean(losses[-2:]) < losses[0]:
        _fail(f"{tag}: the loss did not fall on distinct batches: {losses}")
    return {"launches": launches, "step_ms": ms, "tokens_per_s":
            tokens / (ms / 1e3), "mfu": mfu, "peak_bytes": peak,
            "wait_ms": wait_ms, "losses": losses, "steps": steps}


def _digest(torch, tensors):
    """A bitwise digest of each tensor: the sum of its 32-bit words."""
    return torch.stack([t.view(torch.int32).sum(dtype=torch.int64)
                        for t in tensors]).cpu()


def _fp16_phase(torch, args, data_fed):
    """The fp16 step: llama3-8b at full width, --train-layers deep, f16
    compute over f32 masters with the loss scaler, 'offload_dots', fed
    by the AsyncLoader; one step forced to overflow."""
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    import torchacc_tpu_torch.utils.remat as remat
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, accelerate,
                                    get_preset)
    from torchacc_tpu_torch.models.transformer import loss_sum_count
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_cosine

    layers, steps, warm, rows = args.train_layers, args.fp16_steps, 2, 2
    bomb_at = steps - 3
    tag = "fp16 training"
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(dtype=torch.float16),
                  memory=MemoryConfig(gc=True, gc_policy="offload_dots"),
                  data=DataConfig(max_length=TRAIN_S, prefetch=2),
                  seed=args.seed)
    docs = _zipf_docs(args.seed + 6, (steps + 1) * rows * TRAIN_S,
                      cfg.vocab_size)

    def batches():
        # tests/test_amp.py's bomb: a batch field that makes the loss inf
        for i, b in enumerate(PackedDataset(docs, TRAIN_S, rows)):
            yield dict(b, bomb=np.full((rows, TRAIN_S), int(i == bomb_at),
                                       np.int32))

    def exploding_loss(logits, batch):
        labels = shift_labels(batch["input_ids"], batch["segment_ids"])
        l_sum, count = loss_sum_count(logits, labels)
        bomb = torch.where(batch["bomb"][0, 0] > 0, 3e38, 1.0)
        return l_sum * bomb * bomb, count

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, loader = accelerate(cfg, batches(), conf, optimizer=adamw(
        warmup_cosine(3e-4, steps, warmup_steps=1)), loss=exploding_loss)
    state = trainer.init()
    watch, flag_wait = {}, []

    def before(i, batch):
        # the host's time so far in the wait for the skip flag's copy
        flag_wait.append(trainer.state.opt_state.flag_wait_s)
        if i == bomb_at:
            st = trainer.state
            watch["before"] = (
                _digest(torch, list(st.params.values())),
                _digest(torch, list(st.opt_state.mu.values())),
                _digest(torch, list(st.opt_state.nu.values())),
                st.opt_state.count, st.scaler["scale"].item())

    def after(i, batch, m):
        if i == bomb_at:
            st = trainer.state
            watch["after"] = (
                _digest(torch, list(st.params.values())),
                _digest(torch, list(st.opt_state.mu.values())),
                _digest(torch, list(st.opt_state.nu.values())),
                st.opt_state.count, st.scaler["scale"].item())
    tap = _StepTap(torch, trainer, before=before, after=after)
    for key in fa.launch_counts:             # counts start here ...
        fa.launch_counts[key] = 0
    remat.offload_counts.update(to_host_bytes=0, to_device_bytes=0)
    trainer.fit(loader, max_steps=steps, log_every=0)
    step_ms, _ = tap.finish(warm)
    launches = dict(fa.launch_counts)        # ... and are read here
    moved = dict(remat.offload_counts)
    flag_wait.append(trainer.state.opt_state.flag_wait_s)
    losses = [m["loss"].item() for m in tap.metrics]
    scales = [m["loss_scale"].item() for m in tap.metrics]
    # the hooks around the overflow step wait for the card: the steps
    # on either side of it are not timed
    kept = [i for i in range(steps) if i >= warm and abs(i - bomb_at) > 1]
    timed = [step_ms[i] for i in kept]
    ms = sum(timed) / len(timed)
    wait_ms = [(flag_wait[i + 1] - flag_wait[i]) * 1e3 for i in kept]
    peak = torch.cuda.max_memory_allocated()
    tokens = rows * TRAIN_S
    want = 2 * tokens * cfg.hidden_size * 2 * layers * steps
    print(f"{tag}: llama3-8b at full width, {layers} layers, f16 compute "
          f"over f32 masters, offload_dots, {rows} x {TRAIN_S} tokens a "
          f"step; losses {_fmt(losses)}; loss scales {_fmt(scales)} (step "
          f"{bomb_at} forced to overflow)", flush=True)
    print(f"{tag}: step ms {_fmt(step_ms)}; mean {ms:.1f} ms "
          f"({tokens / (ms / 1e3):.0f} tokens/s) over the steps after "
          f"{warm} warm-up ones but the overflow step and its neighbours; "
          f"peak allocated {peak / 2**30:.2f} GiB against the "
          f"save_attn_mlp bf16 phase's {data_fed['peak_bytes'] / 2**30:.2f} "
          f"GiB (f32 gradients, no bf16 shadow); offloaded {moved} (want "
          f"2 x {tokens} tokens x {cfg.hidden_size} x 2 bytes x {layers} "
          f"layers x {steps} steps = {want} each way); flash launches "
          f"{launches}", flush=True)
    print(f"{tag}: host wait for the skip flag's copy in the timed steps "
          f"{_fmt(wait_ms)} ms (mean {sum(wait_ms) / len(wait_ms):.3f} ms "
          f"a step)", flush=True)
    b, a = watch["before"], watch["after"]
    if not (torch.equal(b[0], a[0]) and torch.equal(b[1], a[1])
            and torch.equal(b[2], a[2]) and b[3] == a[3]):
        _fail(f"{tag}: the overflow step changed the masters, the moments "
              f"or the optimizer's count (count {b[3]} -> {a[3]})")
    if a[4] != b[4] / 2:
        _fail(f"{tag}: the overflow step did not halve the scale: "
              f"{b[4]} -> {a[4]}")
    if np.isfinite(losses[bomb_at]) or not all(
            np.isfinite(x) for i, x in enumerate(losses) if i != bomb_at):
        _fail(f"{tag}: only the forced step may have a non-finite loss: "
              f"{losses}")
    if not trainer.state.opt_state.count > a[3]:
        _fail(f"{tag}: training did not go on after the overflow step")
    if moved != {"to_host_bytes": want, "to_device_bytes": want}:
        _fail(f"{tag}: offload_dots moved {moved}, want {want} each way")
    for key, n in launches.items():
        per = 2 if key == "fwd" else 1       # the recompute re-runs B1
        if n != per * layers * steps:
            _fail(f"{tag}: flash {key} launches {n} != {per} x layers "
                  f"{layers} x steps {steps}")
    del trainer, loader, state, tap
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": ms, "peak_bytes": peak,
            "offloaded": moved, "losses": losses, "steps": steps,
            "flag_wait_ms": sum(wait_ms) / len(wait_ms)}


# ---------------------------------------------------------------------------
# quantized training, the rest: the 'head' site in float16, and serving it
# ---------------------------------------------------------------------------

def _quant_rest_phase(torch, args):
    """8e: llama3-8b at full width, --train-layers deep, compute.dtype
    float16 under the loss scaler, int8 on ('attn', 'mlp', 'head') with
    the materialised head (fused_kernels=False), save_attn_mlp, 2 x 4096
    packed tokens, --quant-rest-steps steps, one forced to overflow.
    Returns the trainer (for 8f) and the readings."""
    import dataclasses
    import numpy as np
    import torchacc_tpu_torch.ops.quantized_matmul as qm
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.models.transformer import (loss_sum_count,
                                                       set_model_config)
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_cosine

    layers, steps, warm, bomb_at = (args.train_layers, args.quant_rest_steps,
                                    1, 2)
    tag = "quantized training, the rest"
    if steps < bomb_at + 2:
        _fail(f"{tag}: --quant-rest-steps must be at least {bomb_at + 2}")
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(
        dtype=torch.float16, quant="int8",
        quant_sites=("attn", "mlp", "head"), fused_kernels=False),
        memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        seed=args.seed)

    def exploding_loss(logits, batch):
        labels = shift_labels(batch["input_ids"], batch["segment_ids"])
        l_sum, count = loss_sum_count(logits, labels)
        bomb = torch.where(batch["bomb"][0, 0] > 0, 3e38, 1.0)
        return l_sum * bomb * bomb, count

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
        warmup_cosine(3e-4, steps, warmup_steps=1)), loss=exploding_loss)
    state = trainer.init()
    model = trainer.model
    if model.cfg.dtype != torch.float16 or "lm_head" not in state.quant:
        _fail(f"{tag}: the model computes in {model.cfg.dtype} with sites "
              f"{sorted(state.quant)[-2:]}")
    batch = _train_batch(torch, np.random.default_rng(args.seed + 2),
                         cfg.vocab_size)
    batches = [dict(batch, bomb=torch.full(
        (TRAIN_B, 1), int(i == bomb_at), dtype=torch.int32, device="cuda"))
        for i in range(steps)]
    # the same run unquantized: the first step's loss on the same weights
    # and batch with quant off (the plain f16 products, no kernel of B5)
    quant_cfg = model.cfg
    set_model_config(model, dataclasses.replace(quant_cfg, quant="none"))
    with torch.no_grad():
        l_sum, count = exploding_loss(model(
            batch["input_ids"], positions=batch["positions"],
            segment_ids=batch["segment_ids"]), batches[0])
        ref_loss = (l_sum / count).item()
    set_model_config(model, quant_cfg)

    def digests():
        st = trainer.state
        return [_digest(torch, list(d.values())) for d in (
            st.params, st.opt_state.mu, st.opt_state.nu, st.quant)]

    for key in qm.launch_counts:           # counts start here ...
        qm.launch_counts[key] = 0
    qm.launch_shapes.clear()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    metrics, watch = [], {}
    for i, b in enumerate(batches):
        if i == bomb_at:
            watch["before"] = (digests(), trainer.state.opt_state.count,
                               trainer.state.scaler["scale"].item())
        if i == 0:
            first = [h.clone() for h in trainer.state.quant.values()]
        ev[i][0].record()
        metrics.append(trainer.step(b))
        ev[i][1].record()
        if i == bomb_at:
            watch["after"] = (digests(), trainer.state.opt_state.count,
                              trainer.state.scaler["scale"].item())
    torch.cuda.synchronize()
    total = dict(qm.launch_counts)         # ... and are read here
    shapes = dict(qm.launch_shapes)
    step_ms = [a.elapsed_time(b) for a, b in ev]
    losses = [m["loss"].item() for m in metrics]
    scales = [m["loss_scale"].item() for m in metrics]
    peak = torch.cuda.max_memory_allocated()
    kept = [i for i in range(warm, steps) if i != bomb_at]
    ms = sum(step_ms[i] for i in kept) / len(kept)
    tokens = TRAIN_B * TRAIN_S
    head = shapes.get(("int8", torch.float16, cfg.vocab_size), 0)
    rel = abs(losses[0] - ref_loss) / ref_loss
    print(f"{tag}: llama3-8b at full width, {layers} layers, f16 compute "
          f"over f32 masters under the loss scaler, int8 on attn, mlp and "
          f"the materialised head, {TRAIN_B} x {TRAIN_S} tokens a step; "
          f"losses {_fmt(losses)}; loss scales {_fmt(scales)} (step "
          f"{bomb_at} forced to overflow); first-step loss {losses[0]:.5f} "
          f"against the unquantized {ref_loss:.5f}: relative difference "
          f"{rel:.3g} (limit 0.02)", flush=True)
    print(f"{tag}: step ms {_fmt(step_ms)}; mean {ms:.1f} ms over steps "
          f"{kept} ({tokens / (ms / 1e3):.0f} tokens/s); peak allocated "
          f"{peak / 2**30:.2f} GiB; B5 launches {total}, by (format, dtype, "
          f"N) {sorted((k[0], str(k[1]), k[2], n) for k, n in shapes.items())}",
          flush=True)
    if rel > 0.02:
        _fail(f"{tag}: the first-step loss parts from the unquantized one "
              f"by {rel:.3g} > 0.02")
    if np.isfinite(losses[bomb_at]) or not all(
            np.isfinite(x) for i, x in enumerate(losses) if i != bomb_at):
        _fail(f"{tag}: only the forced step may have a non-finite loss: "
              f"{losses}")
    (b_dig, b_count, b_scale), (a_dig, a_count, a_scale) = (
        watch["before"], watch["after"])
    names = ("masters", "first moments", "second moments", "amax histories")
    moved = [n for n, x, y in zip(names, b_dig, a_dig)
             if not torch.equal(x, y)]
    if moved or a_count != b_count:
        _fail(f"{tag}: the overflow step changed the {moved} or the "
              f"optimizer's count ({b_count} -> {a_count})")
    if a_scale != b_scale / 2:
        _fail(f"{tag}: the overflow step did not halve the scale: "
              f"{b_scale} -> {a_scale}")
    if all(torch.equal(a, b) for a, b in zip(
            first, trainer.state.quant.values())):
        _fail(f"{tag}: the applied steps recorded no amax")
    want = (7 * layers + 1) * steps
    if total != {"int8": want, "fp8": 0} or head != steps or set(
            k[1] for k in shapes) != {torch.float16}:
        _fail(f"{tag}: B5 launches {total} (head {head}, dtypes "
              f"{set(str(k[1]) for k in shapes)}) != int8 (7 x layers "
              f"{layers} + 1 head) x steps {steps} = {want}, all in f16")
    print(f"{tag}: the overflow step left the masters, both moments, the "
          f"count and all {len(trainer.state.quant)} amax histories "
          f"bitwise as they were and halved the scale; B5 in f16 launched "
          f"{want} = (7 x {layers} + 1) x {steps} times, the head's "
          f"[{tokens} x {cfg.hidden_size}] x [{cfg.hidden_size} x "
          f"{cfg.vocab_size}] {head} of them", flush=True)
    return trainer, {"launches": total["int8"], "head_launches": head,
                     "steps": steps, "step_ms": ms, "peak_bytes": peak,
                     "tokens_per_s": tokens / (ms / 1e3), "losses": losses,
                     "first_loss_rel": rel}


def _quant_rest_serving_phase(torch, args, pa, trainer):
    """8f: ServeEngine.from_train_state of 8e's trainer, served in its
    float16 compute dtype through B4's f16 bodies: 4 greedy requests,
    the launches counted, the last-prompt logits against the plain
    attention path and two controls."""
    import numpy as np
    from torchacc_tpu_torch import Request, ServeEngine

    tag = "fp16 serving"
    rng = np.random.default_rng(args.seed + 19)
    vocab = trainer.model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in (64, 300, 700, 1000)]
    max_new = 16
    eng = ServeEngine.from_train_state(trainer)
    model, cfg = eng.scheduler.decoder.model, eng.cfg
    dtypes = {p.dtype for p in model.parameters()}
    if dtypes != {torch.float16} or cfg.dtype != torch.float16:
        _fail(f"{tag}: the served model holds {dtypes}, computes in "
              f"{cfg.dtype}")
    eng.generate([Request(prompt_ids=prompts[0][:32], max_new_tokens=2)])
    eng.reset_stats()
    sched = eng.scheduler
    dec0, pre0 = sched.decode_dispatches, sched.prefill_dispatches
    for shape in pa.launch_counts:           # counts start here ...
        pa.launch_counts[shape] = 0
    res = eng.generate([Request(prompt_ids=p, max_new_tokens=max_new)
                        for p in prompts])
    torch.cuda.synchronize()
    launches = dict(pa.launch_counts)        # ... and are read here
    dispatches = {"decode": sched.decode_dispatches - dec0,
                  "prefill": sched.prefill_dispatches - pre0}
    stats = eng.stats()
    eng.close()
    for shape, n in dispatches.items():
        if n == 0 or launches[shape] != cfg.num_layers * n:
            _fail(f"{tag}: {shape} kernel launches {launches[shape]} != "
                  f"layers {cfg.num_layers} x dispatches {n}")
    streams = [r.tokens for r in res]
    if any(len(s) != max_new or not all(0 <= t < vocab for t in s)
           for s in streams):
        _fail(f"{tag}: streams of {[len(s) for s in streams]} tokens")
    ref = _prompt_logits(torch, model, cfg, prompts, "torch")
    rel = {}
    for name, attend in (("kernel", None), ("wrong_gqa", _wrong_gqa),
                         ("drop_own_key", _drop_own_key)):
        got = _prompt_logits(torch, model, cfg, prompts,
                             "cuda" if attend is None else "torch", attend)
        if not all(torch.isfinite(a).all() for a in got):
            _fail(f"{tag}: non-finite logits ({name})")
        rel[name] = [((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref)]
    limit = F16_LOGITS_LIMIT
    print(f"{tag}: {len(prompts)} greedy requests (prompts "
          f"{[len(p) for p in prompts]}, {max_new} new tokens) from 8e's "
          f"trainer in float16: {stats['tokens_per_sec']:.1f} tokens/s, "
          f"TTFT p50 {stats['ttft_s_p50'] * 1e3:.1f} ms, per-token p50 "
          f"{stats['per_token_s_p50'] * 1e3:.2f} ms; B4 launches {launches} "
          f"= {cfg.num_layers} x {dispatches}; last-prompt logits vs plain "
          f"attention: kernel {_fmt(rel['kernel'])} (limit {limit:.3g}), "
          f"controls wrong_gqa {_fmt(rel['wrong_gqa'])}, drop_own_key "
          f"{_fmt(rel['drop_own_key'])}", flush=True)
    if max(rel["kernel"]) > limit:
        _fail(f"{tag}: logits through B4 part from the plain path by "
              f"{max(rel['kernel']):.3g} > {limit:.3g}")
    for name in ("wrong_gqa", "drop_own_key"):
        if max(rel[name]) <= limit:
            _fail(f"{tag}: the {name} control stays within {limit:.3g}")
    del eng, model
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches,
            "tokens_per_s": stats["tokens_per_sec"],
            "logits_rel": rel["kernel"]}


# ---------------------------------------------------------------------------
# pipeline parallelism over virtual stages on one card
# ---------------------------------------------------------------------------

# the pipeline cases: name -> (stages, micro-batches, schedule, chunks a
# stage, attention dropout)
PP_CASES = {
    "gpipe_p4": (4, 4, "gpipe", 1, 0.0),
    "1f1b_p4": (4, 4, "1f1b", 1, 0.0),
    "1f1b_p2_v2": (2, 4, "1f1b", 2, 0.0),
    "1f1b_p4_dropout": (4, 4, "1f1b", 1, 0.1),
}
PP_ROWS = 4                             # rows of 4096 tokens a step


def _pp_decode_phase(torch, args, card):
    """The pipelined decode (A12d): llama3-8b at full width and
    PP_DECODE_LAYERS deep, bf16 from init_params(seed), split over 2
    stages that run in this process (tests/torch_pp_virtual.py's
    pipeline: each hop goes through its transport).  A ragged batch of 4
    left-padded prompts of 128 to 512 tokens decodes PP_DECODE_NEW
    tokens through generate(pipeline=): B1, counted from 0 over that
    call, must launch layers x new tokens (one prefill and new - 1
    decode steps a layer), and the greedy tokens must equal the
    unpipelined generate()'s on the same weights.  The same batch then
    runs teacher-forced with those tokens through B1 and through the
    plain attention: the ragged prefill's last-column logits and the
    last decode step's (sq = 1 against sk = 575, each row's pad run
    masked by its segment ids) must each lie within _logits_limit of
    the plain attention's.  Tokens/s of both decodes are printed beside
    the card."""
    import importlib
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import get_preset, init_params
    from torchacc_tpu_torch.models.transformer import head_logits
    gen = importlib.import_module("torchacc_tpu_torch.models.generate")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_pp_virtual import virtual_pipeline

    layers, new = PP_DECODE_LAYERS, PP_DECODE_NEW
    cfg = get_preset("llama3-8b", dtype=torch.bfloat16, num_layers=layers)
    model = init_params(cfg, seed=args.seed + 141, device="cuda",
                        dtype=torch.bfloat16)
    rng = np.random.default_rng(args.seed + 142)
    lens = (128, 512, 300, 200)
    p = max(lens)
    ids = torch.zeros((len(lens), p), dtype=torch.long)
    mask = torch.zeros((len(lens), p), dtype=torch.int32)
    for r, n in enumerate(lens):
        ids[r, p - n:] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=n))
        mask[r, p - n:] = 1
    ids, mask = ids.cuda(), mask.cuda()
    pipe = virtual_pipeline(2, 1, "gpipe", 1)
    kw = dict(prompt_mask=mask, max_new_tokens=new, attention_impl="cuda")
    out, ms = {}, {}
    # in turns, twice; the second turn's times are kept (the first pays
    # for the new shapes' cuBLAS choices)
    for _ in range(2):
        for name, extra in (("pipelined", dict(pipeline=pipe)),
                            ("unpipelined", {})):
            for key in fa.launch_counts:     # counts start here ...
                fa.launch_counts[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = gen.generate(model, ids, **kw, **extra)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            if name == "pipelined":
                launches = dict(fa.launch_counts)    # ... and read here
    want = {"fwd": layers * new, "bwd_dq": 0, "bwd_dkv": 0}
    if launches != want:
        _fail(f"pp decode: B1 launches {launches} != {want}")
    if not torch.equal(out["pipelined"], out["unpipelined"]):
        _fail("pp decode: the pipelined tokens differ from the "
              "unpipelined generate()'s")
    toks = out["pipelined"][:, p:]
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        _fail("pp decode: a token out of the vocabulary")
    # the ragged prefill's and the last decode step's logits through B1
    # against the plain attention, both fed the pipelined run's tokens
    positions, row_len, seg = gen.prompt_geometry(ids, mask)
    logits = {"prefill": {}, "decode": {}}
    with torch.no_grad():
        for impl in ("cuda", "torch"):
            dec = gen._Decoder(model, pipe, len(lens), p + new, ids.device,
                               seg, impl)
            x = dec(ids, positions, 0)
            logits["prefill"][impl] = head_logits(
                cfg, model, x[:, -1:])[:, 0].float()
            for slot in range(p, p + new - 1):
                x = dec(out["pipelined"][:, slot:slot + 1],
                        (row_len + (slot - p))[:, None], slot)
            logits["decode"][impl] = head_logits(
                cfg, model, x[:, -1:])[:, 0].float()
    limit = _logits_limit(layers)
    rel = {}
    for step, pair in logits.items():
        rel[step] = ((pair["cuda"] - pair["torch"]).abs().max()
                     / pair["torch"].abs().max()).item()
        if not math.isfinite(rel[step]) or rel[step] > limit:
            _fail(f"pp decode: ragged {step} logits part by "
                  f"{rel[step]:.3g} > {limit:.3g}")
    tps = {k: len(lens) * new / (v / 1e3) for k, v in ms.items()}
    print(f"pp decode: llama3-8b x{layers} bf16 over 2 stages, 4 ragged "
          f"prompts {lens} + {new} new tokens: pipelined "
          f"{ms['pipelined']:.1f} ms ({tps['pipelined']:.1f} tokens/s), "
          f"unpipelined {ms['unpipelined']:.1f} ms "
          f"({tps['unpipelined']:.1f} tokens/s); B1 launches {launches} "
          f"(= {layers} x {new}); tokens equal; ragged logits B1 vs "
          f"plain: prefill {rel['prefill']:.3g}, last decode step "
          f"{rel['decode']:.3g} (limit {limit:.3g}); card: {card}",
          flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "tokens_per_s": tps,
            "logits_rel": rel}


def _pp_limit():
    """The pipelined step against the unpipelined one (grad_accum = M,
    the same micro-batch rows), bf16 compute over f32 masters: the
    largest relative difference allowed (max |a - b| / max |b| over the
    loss and every gradient).  Both run the same bf16 arithmetic on the
    same rows; the chunks hand on the activations and their cotangents
    in the dtype the one graph holds them in, so only the f32
    accumulation order of the gradients may differ (GPipe backs its
    micro-batches out in reverse).  Set before the first reading."""
    return 1e-3


class _GradsOnly:
    """An optimizer with no state (the ``GradientTransformation``
    protocol): the phase compares and times the step's gradients, and
    never updates, so AdamW's moments would only take 22 GB."""

    def init(self, params):
        return None

    def update_(self, *args, **kwargs):
        raise RuntimeError("the pipeline phase takes no optimizer step")


def _pp_trainer(torch, args, micro, pp=None, dropout=0.0):
    """llama3-8b at full width and --train-layers deep, bf16 shadow over
    f32 masters, save_attn_mlp, from --seed: unpipelined with grad_accum
    = ``micro``, or over ``pp`` = (stages, micro, schedule, chunks) on
    every virtual stage of this card."""
    from torch_pp_virtual import virtual_pipeline
    from torchacc_tpu_torch import (ComputeConfig, Config, DistConfig,
                                    MemoryConfig, PPConfig, accelerate,
                                    get_preset)
    cfg = get_preset("llama3-8b", num_layers=args.train_layers,
                     attn_dropout=dropout)
    kw, dist_cfg, accum = {}, DistConfig(), micro
    if pp is not None:
        size, m, schedule, v = pp
        dist_cfg = DistConfig(pp=PPConfig(size=size, num_micro_batches=m,
                                          schedule=schedule,
                                          virtual_stages=v))
        kw["pipeline"], accum = virtual_pipeline(size, m, schedule, v), 1
    conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  dist=dist_cfg, grad_accum=accum, seed=args.seed)
    trainer, _ = accelerate(cfg, None, conf, optimizer=_GradsOnly(), **kw)
    trainer.init()
    return trainer


def _pp_grads(torch, trainer, batch, timed=2):
    """(loss, gradients by name, f32 on the card) of one step's
    gradient pass (``Trainer``'s micro-batch loop: the pipeline's
    schedule, or the unpipelined grad_accum loop), the flash launches of
    that first pass, and the mean ms of ``timed`` more passes."""
    import torchacc_tpu_torch.ops.flash_attention as fa
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    loss, grads, _ = trainer._grads_accumulated(batch, None)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    grads = {n: g.float() for n, g in grads.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(timed):
        trainer._grads_accumulated(batch, None)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / timed if timed else None
    return loss.float(), grads, launches, ms


def _pp_rel(torch, loss, grads, ref_loss, ref_grads):
    """max |a - b| / max |b| over the loss and every gradient, and the
    gradient where it is largest."""
    rel = {"loss": ((loss - ref_loss).abs() / ref_loss.abs()).item()}
    for n, g in grads.items():
        r = ref_grads[n]
        rel[n] = ((g - r).abs().max() / r.abs().max().clamp_min(
            1e-30)).item()
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def _pp_phase(torch, args, card):
    """Pipeline parallelism on one card: each case of PP_CASES runs
    parallel/pp.py's own schedule over every virtual stage
    (tests/torch_pp_virtual.py), each stage calling the model's chunks
    (``TransformerLM.forward`` with ``layers``), llama3-8b at full width
    and --train-layers deep on PP_ROWS x 4096 packed tokens, bf16 over
    f32 masters.  The loss and every gradient must lie within
    ``_pp_limit`` of the unpipelined Trainer's (grad_accum = M on the
    same weights and rows; for the dropout case each micro-batch drawing
    the 1F1B seed ``_micro_seed(step, m)``, the masks the schedule
    draws), and two controls must exceed it: 1F1B with stage 2 handed
    the previous micro-batch's activation (StaleTransport), and the
    dropout case with GPipe's seeds (every micro-batch the step's).  The
    dropout case runs twice, bitwise alike.

    Launches a step, L layers and M micro-batches (save_attn_mlp keeps
    the attention output, so no remat recompute re-runs B1): GPipe and
    the unpipelined step B1 = B2 = B3 = L x M; 1F1B re-runs every chunk
    but the last virtual stage's in its backward tick, so B1 = M x (2L -
    L / (P x V)), B2 = B3 = L x M.  One card runs every stage, so no
    bubble and no transfer can be read: the step ms beside the
    unpipelined step's is the recompute and the hand-offs."""
    import numpy as np
    import torchacc_tpu_torch.models.transformer as tm
    from torchacc_tpu_torch import get_preset
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_pp_virtual import StaleTransport, virtual_pipeline

    layers = args.train_layers
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 11)
    vocab = get_preset("llama3-8b").vocab_size
    rows = [_train_batch(torch, rng, vocab) for _ in range(PP_ROWS // 2)]
    batch = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    limit = _pp_limit()
    refs, out = {}, {}

    def reference(dropout, micro, seed_of=None):
        key = (dropout, micro)
        if key not in refs:
            # one reference's 11.2 GB of f32 gradients on the card at once
            refs.clear()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            trainer = _pp_trainer(torch, args, micro, dropout=dropout)
            if seed_of is not None:
                # each micro-batch draws the 1F1B schedule's seed
                inner = trainer._forward_sum_count

                def seeded(mb, train=True, dropout_seed=None, quant=None):
                    i = dropout_seed - trainer.state.step * micro
                    return inner(mb, train, seed_of(trainer.state.step, i),
                                 quant)
                trainer._forward_sum_count = seeded
            torch.cuda.reset_peak_memory_stats()
            loss, grads, launches, ms = _pp_grads(torch, trainer, batch)
            refs[key] = dict(loss=loss, grads=grads, launches=launches,
                             ms=ms,
                             peak=torch.cuda.max_memory_allocated() - base)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        return refs[key]

    for name, (size, micro, schedule, v, dropout) in PP_CASES.items():
        ref = reference(dropout, micro,
                        tm._micro_seed if dropout else None)
        base = torch.cuda.memory_allocated()
        trainer = _pp_trainer(torch, args, micro, (size, micro, schedule, v),
                              dropout)
        torch.cuda.reset_peak_memory_stats()
        loss, grads, launches, ms = _pp_grads(torch, trainer, batch)
        peak = torch.cuda.max_memory_allocated() - base
        live = {d: st.max_live
                for d, st in trainer._pipeline.last_run.items()}
        worst, where = _pp_rel(torch, loss, grads, ref["loss"],
                               ref["grads"])
        res = dict(loss=loss.item(), rel=worst, where=where, ms=ms,
                   peak=peak, live=live, launches=launches,
                   ref_ms=ref["ms"], ref_peak=ref["peak"])
        want_b1 = micro * (2 * layers - layers // (size * v)) \
            if schedule == "1f1b" else layers * micro
        want = {"fwd": want_b1, "bwd_dq": layers * micro,
                "bwd_dkv": layers * micro}
        if launches != want:
            _fail(f"pipeline {name}: flash launches {launches} != {want}")
        if ref["launches"] != {k: layers * micro for k in want}:
            _fail(f"pipeline {name}: the unpipelined step's launches "
                  f"{ref['launches']} != layers x micro-batches")
        if not np.isfinite(res["loss"]) or worst > limit:
            _fail(f"pipeline {name}: loss {res['loss']} parts from the "
                  f"unpipelined step by {worst:.3g} ({where}) > {limit:.3g}")
        bound = {d: min(2 * (size - 1 - d) + 1, micro) for d in live} \
            if schedule == "1f1b" and v == 1 else None
        if bound is not None and any(live[d] > bound[d] for d in live):
            _fail(f"pipeline {name}: live micro-batches {live} above the "
                  f"1F1B bound {bound}")
        if dropout:
            # the same step again: bitwise the same loss and gradients
            names = sorted(grads)
            first = _digest(torch, [grads[n] for n in names])
            grads = None
            again, grads2, _, _ = _pp_grads(torch, trainer, batch, timed=0)
            second = _digest(torch, [grads2[n] for n in names])
            res["bitwise_again"] = bool(torch.equal(first, second)
                                        and torch.equal(again, loss))
            del grads2
            if not res["bitwise_again"]:
                _fail(f"pipeline {name}: a second run of the step differs")
            # control: GPipe's seeds (every micro-batch the step's)
            seed_fn = tm._micro_seed
            tm._micro_seed = lambda base, m: base
            try:
                c_loss, c_grads, _, _ = _pp_grads(torch, trainer, batch,
                                                  timed=0)
            finally:
                tm._micro_seed = seed_fn
            res["control_gpipe_seeds"], _ = _pp_rel(
                torch, c_loss, c_grads, ref["loss"], ref["grads"])
            del c_grads
            if res["control_gpipe_seeds"] <= limit:
                _fail(f"pipeline {name}: the GPipe-seed control stays "
                      f"within {limit:.3g}")
        if name == "1f1b_p4":
            # control: stage 2 handed the previous micro-batch's input
            trainer._pipeline = virtual_pipeline(
                size, micro, schedule, v, transport=StaleTransport(2))
            c_loss, c_grads, _, _ = _pp_grads(torch, trainer, batch, timed=0)
            res["control_stale_input"], _ = _pp_rel(
                torch, c_loss, c_grads, ref["loss"], ref["grads"])
            del c_grads
            if res["control_stale_input"] <= limit:
                _fail(f"pipeline {name}: the stale-input control stays "
                      f"within {limit:.3g}")
        out[name] = res
        print(f"pipeline {name}: P {size} x V {v}, M {micro}, {schedule}"
              f"{', dropout 0.1' if dropout else ''}: loss {res['loss']:.5f}"
              f", worst relative difference from the unpipelined step "
              f"{worst:.3g} ({where}; limit {limit:.3g})"
              + "".join(f", {k} {res[k]:.3g}" for k in
                        ("control_stale_input", "control_gpipe_seeds")
                        if k in res)
              + f"; gradient pass {ms:.1f} ms against {ref['ms']:.1f} ms "
              f"unpipelined ({ms / ref['ms']:.3f}x); peak allocated above "
              f"what the phase held before the trainer {peak / 2**30:.2f} "
              f"GiB against {ref['peak'] / 2**30:.2f}; "
              f"live micro-batches by stage {live}; flash launches "
              f"{launches}; card: {card}", flush=True)
        del trainer, grads, ref
        gc.collect()
        torch.cuda.empty_cache()
    del refs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pipeline: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# model-level kernel-vs-plain check
# ---------------------------------------------------------------------------

def _grad_limit(layers):
    """Largest relative difference allowed between the loss and the
    gradients through the kernels and through the plain attention
    (max |a - b| / max |b|).  Set from readings (PERF.md)."""
    return 0.05 * max(1.0, (layers / 2) ** 0.5)


def _model_check_phase(torch, args):
    import numpy as np
    from torchacc_tpu_torch import get_preset, init_params

    layers = args.check_layers
    cfg = get_preset("llama3-8b", num_layers=layers, remat=True,
                     remat_policy="save_attn_mlp")
    model = init_params(cfg, seed=args.seed, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(True).train()
    batch = _train_batch(torch, np.random.default_rng(args.seed + 3),
                         cfg.vocab_size)
    rel = _kernels_vs_plain(torch, model, batch, f"model check ({layers} "
                            f"layers)")
    del model
    torch.cuda.empty_cache()
    return rel


def _kernels_vs_plain(torch, model, batch, tag):
    """One forward + backward of ``model`` (weights that take gradients)
    on ``batch`` through the flash kernels, through attention_impl=
    'torch', and through the control (plain attention with the segment
    mask ignored): the loss and the first layer's q/k/v-projection and
    the embedding gradients must agree within ``_grad_limit`` between
    the first two, and the control must part from the plain run by
    more.  The model's config is left as it was."""
    import dataclasses
    from torchacc_tpu_torch.models.transformer import (head_weight,
                                                      set_model_config)
    from torchacc_tpu_torch.ops.fused import fused_linear_cross_entropy
    from torchacc_tpu_torch.train import shift_labels

    cfg = model.cfg
    layers = cfg.num_layers
    labels = shift_labels(batch["input_ids"], batch["segment_ids"])
    watched = {"embed": model.embed_tokens.weight,
               **{f"layer0.{n}": getattr(model.layers[0].attn, n).weight
                  for n in ("q_proj", "k_proj", "v_proj")}}

    def run(impl, segments):
        set_model_config(model, dataclasses.replace(cfg,
                                                    attention_impl=impl))
        hidden = model(batch["input_ids"], batch["positions"],
                       batch["segment_ids"] if segments else None,
                       return_hidden=True)
        l_sum, count = fused_linear_cross_entropy(
            hidden, head_weight(model).t(), labels)
        loss = l_sum / count
        loss.backward()
        out = {"loss": loss.detach().float().reshape(1)}
        out.update({n: p.grad.float().clone() for n, p in watched.items()})
        model.zero_grad(set_to_none=True)
        return out

    ref = run("torch", True)
    rel = {}
    for name, impl, segments in (("kernel", "cuda", True),
                                 ("ignore_segments", "torch", False)):
        got = run(impl, segments)
        if not all(torch.isfinite(t).all() for t in got.values()):
            _fail(f"{tag} ({name}): non-finite loss or gradient")
        rel[name] = {n: ((got[n] - ref[n]).abs().max()
                         / ref[n].abs().max()).item() for n in ref}
    set_model_config(model, cfg)
    limit = _grad_limit(layers)
    print(f"{tag}: loss {ref['loss'].item():.5f}; "
          f"relative difference from plain attention: kernel "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in rel['kernel'].items()})}, "
          f"control (segments ignored) "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in rel['ignore_segments'].items()})}; "
          f"limit {limit:.3g}", flush=True)
    worst = max(rel["kernel"].values())
    if worst > limit:
        _fail(f"{tag}: the kernels part from the plain attention by "
              f"{worst:.3g} > {limit:.3g}")
    if max(rel["ignore_segments"].values()) <= limit:
        _fail(f"{tag}: the segments-ignored control stays within "
              f"{limit:.3g}: the check cannot tell a wrong mask apart")
    del watched
    return rel


def _quant_check_limit(fmt, layers):
    """Quantized sites, kernel against plain version, at the model level:
    the largest relative difference allowed (max |a - b| / max |b| over
    the loss and the first layer's gradients).  Set from readings
    (PERF.md) over seeds 0-2 at 2 and 4 layers.  int8: the kernel is the
    plain version bit for bit and every reading was 0.0, so nothing is
    allowed.  fp8: the f32 sums differ in order, a bf16 output flips by
    an ulp here and there, and a flipped e4m3 step downstream is 6%.
    Through the f16 tensor cores' f32 sums (on an H100, seeds 0-2):
    0.037-0.044 at 2 layers and 0.087-0.102 at 4, against 0.23-0.27 and
    0.36-0.43 for the control."""
    return 0.0 if fmt == "int8" else 0.04 * layers


def _quant_check_phase(torch, args):
    """One forward + backward of llama3-8b at full width with quantized
    sites, through quant_impl='cuda' and 'torch' from the same weights,
    batch and mid-run amax histories; and a control, the plain version
    with one per-tensor weight scale in place of the per-channel ones."""
    import dataclasses
    import numpy as np
    import torchacc_tpu_torch.ops.quantized_matmul as qm
    from torchacc_tpu_torch import get_preset, init_params
    from torchacc_tpu_torch.models.transformer import (
        head_weight, init_quant_state, set_model_config)
    from torchacc_tpu_torch.ops.fused import fused_linear_cross_entropy
    from torchacc_tpu_torch.train import shift_labels

    layers = args.check_layers
    base = get_preset("llama3-8b", num_layers=layers, remat=True,
                      remat_policy="save_attn_mlp")
    model = init_params(base, seed=args.seed, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(True).train()
    batch = _train_batch(torch, np.random.default_rng(args.seed + 3),
                         base.vocab_size)
    labels = shift_labels(batch["input_ids"], batch["segment_ids"])
    # the embedding's gradient is summed with atomics (another order
    # every run), so the first layer's projections are watched instead
    watched = {f"layer0.{n}": getattr(model.layers[0].attn, n).weight
               for n in ("q_proj", "k_proj", "v_proj")}
    watched["layer0.down_proj"] = model.layers[0].mlp.down_proj.weight
    per_channel = qm.per_channel_scale

    def per_tensor(w2d, fmt):
        return qm.compute_scale(qm._amax(w2d), fmt).expand(
            w2d.shape[1]).contiguous()

    out = {}
    for fmt in ("int8", "fp8"):
        cfg = dataclasses.replace(base, quant=fmt)

        def run(impl, hist, record=None):
            set_model_config(model, dataclasses.replace(cfg,
                                                        quant_impl=impl))
            hidden = model(batch["input_ids"], batch["positions"],
                           batch["segment_ids"], return_hidden=True,
                           quant=hist, quant_out=record)
            l_sum, count = fused_linear_cross_entropy(
                hidden, head_weight(model).t(), labels)
            loss = l_sum / count
            loss.backward()
            res = {"loss": loss.detach().float().reshape(1)}
            res.update({n: p.grad.float().clone()
                        for n, p in watched.items()})
            model.zero_grad(set_to_none=True)
            return res

        # mid-run histories: those one step through the kernel leaves
        hist = {}
        run("cuda", init_quant_state(cfg, "cuda"), hist)
        ref = run("torch", hist)
        rel = {}
        for name, impl in (("kernel", "cuda"), ("per_tensor_scale", "torch")):
            qm.per_channel_scale = (per_tensor if name == "per_tensor_scale"
                                    else per_channel)
            try:
                got = run(impl, hist)
            finally:
                qm.per_channel_scale = per_channel
            if not all(torch.isfinite(t).all() for t in got.values()):
                _fail(f"quant check {fmt} ({name}): non-finite loss or "
                      f"gradient")
            rel[name] = {n: ((got[n] - ref[n]).abs().max()
                             / ref[n].abs().max()).item() for n in ref}
        limit = _quant_check_limit(fmt, layers)
        show = lambda d: json.dumps({k: float(f"{v:.4g}")
                                     for k, v in d.items()})
        print(f"quant check {fmt} ({layers} layers): loss "
              f"{ref['loss'].item():.5f}; relative difference from the "
              f"plain quantized matmul: kernel {show(rel['kernel'])}, "
              f"control (per-tensor weight scale) "
              f"{show(rel['per_tensor_scale'])}; limit {limit:.3g}",
              flush=True)
        worst = max(rel["kernel"].values())
        if worst > limit:
            _fail(f"quant check {fmt}: the kernel parts from the plain "
                  f"version by {worst:.3g} > {limit:.3g}")
        if max(rel["per_tensor_scale"].values()) <= limit:
            _fail(f"quant check {fmt}: the per-tensor-scale control stays "
                  f"within {limit:.3g}: the check cannot tell a wrong scale "
                  f"apart")
        out[fmt] = rel
    del model, watched
    torch.cuda.empty_cache()
    return out


def _accum_limit():
    """Gradient accumulation against the unsplit batch, f32 throughout:
    the largest relative difference allowed (max |a - b| / max |b| over
    the loss and the watched gradients).  Set from readings (PERF.md):
    the two differ only by f32 summation order."""
    return 1e-4


def _accum_check_phase(torch, args):
    """grad_accum=2 over two micro-batches whose token counts differ
    against grad_accum=1 on the concatenated batch, through the kernels,
    at --check-layers depth and full width, in f32: a bf16 rounding of
    each micro-batch's gradient would be as large as what the bf16
    control below adds, so only f32 arithmetic tells f32 accumulation
    from bf16.  Controls: the mean of the micro-batches' mean losses in
    place of their summed loss over summed count, and the gradients
    summed in bf16 (accum_dtype bfloat16) in place of f32."""
    import numpy as np
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)

    layers, rows = args.check_layers, 4
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(dtype=torch.float32),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  grad_accum=2, seed=args.seed)
    trainer, _ = accelerate(cfg, None, conf)
    trainer.init()
    rng = np.random.default_rng(args.seed + 7)
    halves = [_train_batch(torch, rng, cfg.vocab_size) for _ in range(2)]
    batch = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    # the second micro-batch's rows are 3/4 padding: fewer tokens count
    pad = batch["segment_ids"][rows // 2:, TRAIN_S // 4:]
    pad.fill_(-1)
    batch["positions"][rows // 2:, TRAIN_S // 4:] = 0
    watched = ["embed_tokens.weight"] + [
        f"layers.0.attn.{n}.weight" for n in ("q_proj", "k_proj", "v_proj")]

    def pick(loss, grads):
        out = {"loss": loss.detach().float().reshape(1)}
        out.update({n: grads[n].float().clone() for n in watched})
        for p in trainer.model.parameters():
            p.grad = None
        return out

    def mean_of_means():
        micro = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
                 for i in range(2)]
        acc = {n: torch.zeros_like(p) for n, p in
               trainer.model.named_parameters() if n in watched}
        losses = []
        for mb in micro:
            l_sum, count, _ = trainer._forward_sum_count(mb)
            loss = l_sum / count
            loss.backward()
            losses.append(loss.detach())
            for n, p in trainer.model.named_parameters():
                if n in watched:
                    acc[n] += p.grad / 2
                p.grad = None
        return pick(sum(losses) / 2, acc)

    ref = pick(*trainer._grads_one(batch, None)[:2])
    runs = {"accumulated": pick(*trainer._grads_accumulated(batch, None)[:2]),
            "mean_of_micro_means": mean_of_means()}
    trainer.config.compute.accum_dtype = torch.bfloat16
    runs["bf16_grad_sum"] = pick(*trainer._grads_accumulated(batch, None)[:2])
    rel = {name: {n: ((got[n] - ref[n]).abs().max()
                      / ref[n].abs().max()).item() for n in ref}
           for name, got in runs.items()}
    limit = _accum_limit()
    show = lambda d: json.dumps({k: float(f"{v:.4g}") for k, v in d.items()})
    counts = [int((batch["segment_ids"][i * 2:(i + 1) * 2] >= 0).sum())
              for i in range(2)]
    print(f"accumulation check ({layers} layers, f32, micro-batch tokens "
          f"{counts}): loss {ref['loss'].item():.5f}; relative difference "
          f"from grad_accum=1: accumulated {show(rel['accumulated'])}, "
          f"control (mean of micro means) "
          f"{show(rel['mean_of_micro_means'])}, control (bf16 sum) "
          f"{show(rel['bf16_grad_sum'])}; limit {limit:.3g}", flush=True)
    if max(rel["accumulated"].values()) > limit:
        _fail(f"accumulation check: grad_accum=2 parts from grad_accum=1 by "
              f"{max(rel['accumulated'].values()):.3g} > {limit:.3g}")
    for name in ("mean_of_micro_means", "bf16_grad_sum"):
        if max(rel[name].values()) <= limit:
            _fail(f"accumulation check: the {name} control stays within "
                  f"{limit:.3g}: the check cannot tell it apart")
    del trainer, batch, runs, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rel


def _offload_limit():
    """'offload_dots' against 'save_attn_mlp', f16 compute: the largest
    relative difference allowed (max |a - b| / max |b| over the loss and
    the watched gradients).  Set from readings (PERF.md; H100: 0, the
    recompute reads the products' own bytes back, and the control
    0.99-1.005): three orders below the control, above the f16 rounding
    a change of GEMM algorithm between the two backward passes would
    make."""
    return 1e-3


def _offload_check_phase(torch, args):
    """'offload_dots' against 'save_attn_mlp' on the same weights and
    batch: the fp16 step's loss and gradients (the loss times the
    scaler's scale, f16 compute over f32 masters), at --check-layers
    depth and full width, through the kernels.  Control: the copies to
    host memory start late (the side stream first sleeps) and the
    backward takes them back without waiting for their events, so the
    recompute reads host buffers the copies have not reached: what a
    missing wait reads under load."""
    import dataclasses
    import numpy as np
    import torchacc_tpu_torch.utils.remat as remat
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.models.transformer import set_model_config

    layers = args.check_layers
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(dtype=torch.float16),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  seed=args.seed)
    trainer, _ = accelerate(cfg, None, conf)
    trainer.init()
    if not trainer.model.cfg.remat:
        _fail("offload check: the model does not rematerialise")
    batch = _train_batch(torch, np.random.default_rng(args.seed + 8),
                         cfg.vocab_size)
    scale = trainer.state.scaler["scale"]
    watched = ["embed_tokens.weight"] + [
        f"layers.0.attn.{n}.weight" for n in ("q_proj", "k_proj", "v_proj")]

    def run(policy):
        set_model_config(trainer.model, dataclasses.replace(
            trainer.model.cfg, remat_policy=policy))
        loss, grads, _ = trainer._grads_one(batch, scale)
        out = {"loss": loss.float().reshape(1)}
        out.update({n: grads[n].float().clone() for n in watched})
        for p in trainer.model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        return out

    def late_copies():
        save, bring_back = remat._Tape.save, remat._Tape.bring_back
        slept = []

        def late_save(tape, y):
            if not slept:
                with torch.cuda.stream(remat._offload_stream(y.device)):
                    torch.cuda._sleep(LATE_COPY_CYCLES)
                slept.append(True)
            save(tape, y)

        def no_wait(tape, device):
            tape.recording = False
            tape.back = [h.to(device, non_blocking=True)
                         for h in reversed(tape.host)]
            tape.host, tape.events = [], []
        remat._Tape.save, remat._Tape.bring_back = late_save, no_wait
        try:
            return run("offload_dots")
        finally:
            remat._Tape.save, remat._Tape.bring_back = save, bring_back

    def apart(got, ref):
        return {n: (((got[n] - ref[n]).abs().max() / ref[n].abs().max())
                    .item() if torch.isfinite(got[n]).all() else math.inf)
                for n in ref}

    ref = run("save_attn_mlp")
    # the control first: the pinned blocks it reads then hold no copy of
    # this batch's products
    control = apart(late_copies(), ref)
    remat.offload_counts.update(to_host_bytes=0, to_device_bytes=0)
    got = apart(run("offload_dots"), ref)
    moved = dict(remat.offload_counts)
    want = 2 * TRAIN_B * TRAIN_S * cfg.hidden_size * 2 * layers
    limit = _offload_limit()
    show = lambda d: json.dumps({k: float(f"{v:.4g}") for k, v in d.items()})
    print(f"offload check ({layers} layers, f16, loss scale "
          f"{scale.item():.0f}): loss {ref['loss'].item():.5f}; relative "
          f"difference from save_attn_mlp: offload_dots {show(got)}, "
          f"control (copies late, no wait) {show(control)}; limit "
          f"{limit:.3g}; offloaded {moved} (want {want} each way)",
          flush=True)
    if max(got.values()) > limit:
        _fail(f"offload check: offload_dots parts from save_attn_mlp by "
              f"{max(got.values()):.3g} > {limit:.3g}")
    if max(control.values()) <= limit:
        _fail(f"offload check: the late-copy control stays within "
              f"{limit:.3g}: the check cannot tell a missing wait apart")
    if moved != {"to_host_bytes": want, "to_device_bytes": want}:
        _fail(f"offload check: offload_dots moved {moved}, want {want} "
              f"each way")
    del trainer, batch, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"offload_dots": got, "control": control}


# ---------------------------------------------------------------------------
# Hugging Face checkpoint
# ---------------------------------------------------------------------------

# meta-llama/Llama-3.2-1B's published config.json (the source system's
# loss-parity model): 1.236 B parameters, heads of 64
LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64,
    "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rms_norm_eps": 1e-05, "tie_word_embeddings": True,
    "attention_bias": False, "mlp_bias": False, "hidden_act": "silu",
    "initializer_range": 0.02, "torch_dtype": "bfloat16",
    "bos_token_id": 128000, "eos_token_id": 128001,
}
HF_DIR = "chip_smoke_hf"                # under the checkout; git-ignored
HF_SHARDS = 4
# a tensor of more elements is drawn in parts of this many on threads of
# their own (Command-R's 2.1 B-entry table took 54 s on one)
HF_DRAW_PART = 1 << 28


def _hf_tensors(cfg, layers):
    """HF tensor name -> shape of a Llama, Gemma2, Phi, GPT-2, Phi-3
    (packed qkv_proj and gate_up_proj), OLMo2 (post-norms, flat q/k
    norms), Cohere (one norm a block) or Qwen3-MoE (per-head q/k norms,
    the router and the experts) checkpoint of ``cfg`` (untied:
    an lm_head; Gemma2's pre- and post-feedforward norms), in the order
    the shards hold them."""
    mt = cfg["model_type"]
    if mt == "phi":
        return _phi_tensors(cfg, layers)
    if mt == "gpt2":
        return _gpt2_tensors(cfg, layers)
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    d = cfg.get("head_dim") or h // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    out = {"model.embed_tokens.weight": (cfg["vocab_size"], h),
           "model.norm.weight": (h,)}
    for i in range(layers):
        p = f"model.layers.{i}."
        if mt != "olmo2":
            out[p + "input_layernorm.weight"] = (h,)
        if mt == "phi3":
            out[p + "self_attn.qkv_proj.weight"] = (q + 2 * kv, h)
        else:
            out.update({p + "self_attn.q_proj.weight": (q, h),
                        p + "self_attn.k_proj.weight": (kv, h),
                        p + "self_attn.v_proj.weight": (kv, h)})
        if mt == "olmo2":
            out.update({p + "self_attn.q_norm.weight": (q,),
                        p + "self_attn.k_norm.weight": (kv,)})
        elif mt == "qwen3_moe":
            out.update({p + "self_attn.q_norm.weight": (d,),
                        p + "self_attn.k_norm.weight": (d,)})
        out[p + "self_attn.o_proj.weight"] = (h, q)
        if mt != "cohere":
            out[p + "post_attention_layernorm.weight"] = (h,)
        if mt in ("gemma2", "olmo2"):
            if mt == "gemma2":
                out[p + "pre_feedforward_layernorm.weight"] = (h,)
            out[p + "post_feedforward_layernorm.weight"] = (h,)
        if mt == "qwen3_moe":
            # the router and every expert's gate/up/down at
            # moe_intermediate_size
            e, fe = cfg["num_experts"], cfg["moe_intermediate_size"]
            out[p + "mlp.gate.weight"] = (e, h)
            for j in range(e):
                q_ = p + f"mlp.experts.{j}."
                out.update({q_ + "gate_proj.weight": (fe, h),
                            q_ + "up_proj.weight": (fe, h),
                            q_ + "down_proj.weight": (h, fe)})
            continue
        if mt == "phi3":
            out[p + "mlp.gate_up_proj.weight"] = (2 * f, h)
        else:
            out.update({p + "mlp.gate_proj.weight": (f, h),
                        p + "mlp.up_proj.weight": (f, h)})
        out[p + "mlp.down_proj.weight"] = (h, f)
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = (cfg["vocab_size"], h)
    return out


def _phi_tensors(cfg, layers):
    """Phi-1/1.5/2's tensors: biased q/k/v, ``dense``, ``fc1``/``fc2``
    and LayerNorms, one norm a block, a biased untied head."""
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    out = {"model.embed_tokens.weight": (v, h),
           "model.final_layernorm.weight": (h,),
           "model.final_layernorm.bias": (h,),
           "lm_head.weight": (v, h), "lm_head.bias": (v,)}
    for i in range(layers):
        p = f"model.layers.{i}."
        out.update({p + "input_layernorm.weight": (h,),
                    p + "input_layernorm.bias": (h,)})
        for name in ("q_proj", "k_proj", "v_proj", "dense"):
            out.update({p + f"self_attn.{name}.weight": (h, h),
                        p + f"self_attn.{name}.bias": (h,)})
        out.update({p + "mlp.fc1.weight": (f, h), p + "mlp.fc1.bias": (f,),
                    p + "mlp.fc2.weight": (h, f), p + "mlp.fc2.bias": (h,)})
    return out


def _gpt2_tensors(cfg, layers):
    """GPT-2's tensors in its Conv1D layout (``[in, out]``, q|k|v packed
    in ``c_attn``), the position table, biased LayerNorms; tied."""
    h, v = cfg["n_embd"], cfg["vocab_size"]
    out = {"transformer.wte.weight": (v, h),
           "transformer.wpe.weight": (cfg["n_positions"], h),
           "transformer.ln_f.weight": (h,), "transformer.ln_f.bias": (h,)}
    for i in range(layers):
        p = f"transformer.h.{i}."
        out.update({p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
                    p + "attn.c_attn.weight": (h, 3 * h),
                    p + "attn.c_attn.bias": (3 * h,),
                    p + "attn.c_proj.weight": (h, h),
                    p + "attn.c_proj.bias": (h,),
                    p + "ln_2.weight": (h,), p + "ln_2.bias": (h,),
                    p + "mlp.c_fc.weight": (h, 4 * h),
                    p + "mlp.c_fc.bias": (4 * h,),
                    p + "mlp.c_proj.weight": (4 * h, h),
                    p + "mlp.c_proj.bias": (h,)})
    return out


def _layer_of(name):
    """The block index in an HF tensor name, None outside the blocks."""
    parts = name.split(".")
    return int(parts[2]) if len(parts) > 2 and parts[2].isdigit() else None


def _write_safetensors(torch, path, tensors):
    """The safetensors format, written by this script: an 8-byte
    little-endian header length, the JSON header (dtype, shape and
    data_offsets of each tensor, padded with spaces to 8 bytes), the
    tensors' bytes in the header's order."""
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + off


def _write_hf_checkpoint(torch, root, seed, layers, published=None):
    """Into the empty directory ``root``: a published config.json
    (``published``, default Llama-3.2-1B's; ``layers`` deep) and its
    weights in HF's tensor names, bf16, in HF_SHARDS safetensors files
    named by an index: matrices normal(0, initializer_range) from numpy
    generators spawned from ``seed`` (one a tensor, drawn on 8 threads),
    biases too, norm scales their init (one; zero for Gemma's 1 + w
    norms).  Returns (the HF tensors by name, bytes written)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    cfg = dict(published or LLAMA32_1B)
    cfg["n_layer" if cfg["model_type"] == "gpt2"
        else "num_hidden_layers"] = layers
    norm_init = 0.0 if cfg["model_type"].startswith("gemma") else 1.0
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    shapes = _hf_tensors(cfg, layers)
    names = list(shapes)
    gens = dict(zip(names, np.random.SeedSequence(seed).spawn(len(names))))
    std = cfg["initializer_range"]

    def draw(gen, n):
        x = np.random.default_rng(gen).standard_normal(n, dtype=np.float32)
        return torch.from_numpy(x).mul_(std).to(torch.bfloat16)

    def make(name):
        shape = shapes[name]
        if name.endswith(("norm.weight", ".ln_1.weight", ".ln_2.weight",
                          ".ln_f.weight")):
            return torch.full(shape, norm_init, dtype=torch.bfloat16)
        n = int(np.prod(shape))
        if n <= HF_DRAW_PART:
            return draw(gens[name], n).view(shape)
        # a vocabulary table: its parts drawn on threads of their own,
        # from generators spawned from the tensor's
        sizes = [min(HF_DRAW_PART, n - i) for i in range(0, n, HF_DRAW_PART)]
        with ThreadPoolExecutor(8) as parts:
            return torch.cat(list(parts.map(
                draw, gens[name].spawn(len(sizes)), sizes))).view(shape)

    # the tensors outside the blocks first, then the layers in equal
    # groups
    per = -(-layers // (HF_SHARDS - 1))
    groups = [[n for n in names if _layer_of(n) is None]] + [
        [n for n in names if _layer_of(n) is not None
         and _layer_of(n) // per == g] for g in range(HF_SHARDS - 1)]
    written, nbytes, weight_map = {}, 0, {}
    with ThreadPoolExecutor(8) as ex:
        for g, group in enumerate(groups):
            part = dict(zip(group, ex.map(make, group)))
            fname = f"model-{g + 1:05d}-of-{len(groups):05d}.safetensors"
            nbytes += _write_safetensors(torch, os.path.join(root, fname),
                                         part)
            weight_map.update((n, fname) for n in part)
            written.update(part)
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(
            t.numel() * 2 for t in written.values())},
            "weight_map": weight_map}, f, indent=2)
    return written, nbytes


def _hf_root(nbytes):
    """A new empty directory of this run's own under /dev/shm when that
    has room for twice the checkpoint (so that the run's disk writes
    stay with the checkpoint phases, and two runs on one machine never
    share it), else HF_DIR beside this script, in the checkout, made
    anew."""
    try:
        if shutil.disk_usage("/dev/shm").free > 2 * nbytes:
            return tempfile.mkdtemp(prefix=HF_DIR + "_", dir="/dev/shm")
    except OSError:
        pass
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), HF_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def _hf_phase(torch, args, pa):
    """A Llama-3.2-1B checkpoint in HF's layout through accelerate() ->
    Trainer.fit, then ServeEngine.from_train_state."""
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, ServeConfig,
                                    accelerate)
    from torchacc_tpu_torch.models.hf_stream import ingestion_plan
    from torchacc_tpu_torch.train import adamw, warmup_linear

    tag, layers, steps, warm, rows = ("hf", args.hf_layers, args.hf_steps,
                                      2, 2)
    if layers != LLAMA32_1B["num_hidden_layers"]:
        print(f"{tag}: depth cut to {layers} of "
              f"{LLAMA32_1B['num_hidden_layers']} layers (full width kept)",
              flush=True)
    est = 2 * (LLAMA32_1B["vocab_size"] * 2048 + layers * 60_821_504)
    root = _hf_root(est)
    print(f"{tag}: the checkpoint goes to {root}", flush=True)
    try:
        t0 = time.perf_counter()
        written, nbytes = _write_hf_checkpoint(torch, root, args.seed + 11,
                                               layers)
        print(f"{tag}: wrote Llama-3.2-1B's config.json and {nbytes} bytes "
              f"of bf16 safetensors in {HF_SHARDS} shards with an index to "
              f"{root} in {time.perf_counter() - t0:.1f} s", flush=True)
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                      data=DataConfig(max_length=TRAIN_S, prefetch=2),
                      serve=ServeConfig(block_size=BS, num_blocks=1024,
                                        max_slots=8, prefill_chunk=256,
                                        decode_depth=2),
                      seed=args.seed)
        docs = _zipf_docs(args.seed + 12, (steps + 1) * rows * TRAIN_S,
                          LLAMA32_1B["vocab_size"])
        eval_docs = _zipf_docs(args.seed + 13, 3 * rows * TRAIN_S,
                               LLAMA32_1B["vocab_size"])
        evals = list(itertools.islice(iter(PackedDataset(
            eval_docs, seq_len=TRAIN_S, batch_rows=rows)), 2))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer, loader = accelerate(
            root, PackedDataset(docs, seq_len=TRAIN_S, batch_rows=rows), conf,
            optimizer=adamw(warmup_linear(1e-4, steps, 1)))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = trainer.model.cfg
    n_params = sum(p.numel() for p in trainer.state.params.values())
    print(f"{tag}: accelerate({root}) in {load_s:.2f} s ({nbytes / load_s / 1e9:.3f} "
          f"GB/s of checkpoint: config, model, optimizer state and every "
          f"tensor streamed into the f32 masters); {n_params} params, "
          f"{cfg.num_layers} layers, heads {cfg.num_heads}/{cfg.kv_heads} "
          f"of {cfg.head_size}, rope_llama3 {cfg.rope_llama3}, tied "
          f"{cfg.tie_embeddings}", flush=True)
    if cfg.head_size != 64 or not cfg.tie_embeddings \
            or cfg.rope_llama3 != (32.0, 1.0, 4.0, 8192.0):
        _fail(f"{tag}: config_from_hf gave {cfg}")
    plan = ingestion_plan(cfg)
    differ = [n for n, t in written.items()
              if not torch.equal(trainer.state.params[plan[n[6:]][0]],
                                 t.cuda().float())]
    if len(written) != len(trainer.state.params) or differ:
        _fail(f"{tag}: the loaded masters differ from the written weights "
              f"({differ[:5]})")
    print(f"{tag}: the {len(written)} loaded masters equal the written "
          f"bf16 weights bitwise", flush=True)
    del written
    batch = {k: torch.as_tensor(v).cuda() for k, v in evals[0].items()}
    check = _kernels_vs_plain(torch, trainer.model, batch,
                              f"{tag} check ({cfg.num_layers} layers, the "
                              f"loaded model)")

    tap = _StepTap(torch, trainer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launch_counts:             # counts start here ...
        fa.launch_counts[key] = 0
    hist = trainer.fit(loader, max_steps=steps, eval_loader=evals,
                       eval_every=steps - 1, log_every=0)
    step_ms, _ = tap.finish(warm)
    launches = dict(fa.launch_counts)        # ... and are read here
    losses = [m["loss"].item() for m in tap.metrics]
    peak = torch.cuda.max_memory_allocated()
    # the last interval holds the evaluation pass too
    timed = step_ms[warm:-1]
    ms = sum(timed) / len(timed)
    tokens = rows * TRAIN_S
    flops_tok = 6.0 * n_params + 6.0 * layers * cfg.hidden_size * TRAIN_S
    mfu = flops_tok * tokens / (ms / 1e3) / PEAK_BF16_FLOPS
    eval_loss = [r["eval_loss"] for r in hist if "eval_loss" in r]
    want = {"fwd": layers * (steps + len(evals)), "bwd_dq": layers * steps,
            "bwd_dkv": layers * steps}
    print(f"{tag}: fit over {rows} x {TRAIN_S} packed tokens a step: losses "
          f"{_fmt(losses)}, eval_loss {_fmt(eval_loss)} ({len(evals)} "
          f"batches after step {steps - 1}); step ms {_fmt(step_ms)} (first "
          f"{warm} warm-up, the last holds the evaluation); mean of the timed "
          f"{ms:.1f} ms, {tokens / (ms / 1e3):.0f} tokens/s, MFU {mfu:.4f} "
          f"of the bf16 peak (6N + 6*L*h*s per token, N = {n_params}); peak "
          f"allocated {peak / 2**30:.2f} GiB; flash launches {launches} "
          f"(expected {want}: the evaluation runs the forward)", flush=True)
    if not all(np.isfinite(losses + eval_loss)) or len(eval_loss) != 1:
        _fail(f"{tag}: losses {losses}, eval_loss {eval_loss}")
    if not np.mean(losses[-2:]) < losses[0]:
        _fail(f"{tag}: the loss did not fall on distinct batches: {losses}")
    if launches != want:
        _fail(f"{tag}: flash launches {launches} != {want} (layers x steps, "
              f"the forward also layers x evaluation batches)")
    if args.profile:
        _profile_step(torch, trainer, batch, "training[hf]")
    del tap, loader
    gc.collect()
    torch.cuda.empty_cache()

    serving = _hf_serving(torch, args, pa, trainer, tag)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "step_ms": ms, "mfu": mfu,
            "tokens_per_s": tokens / (ms / 1e3), "peak_bytes": peak,
            "load_s": load_s, "bytes": nbytes, "check": check, **serving}


def _hf_serving(torch, args, pa, trainer, tag):
    """ServeEngine.from_train_state(trainer): greedy requests through B4
    (bf16), counted and held against the plain path's logits with its
    controls; then f32 serving token for token against generate()."""
    import dataclasses
    import numpy as np
    from torchacc_tpu_torch import Request, ServeEngine, TransformerLM
    from torchacc_tpu_torch.models.generate import generate

    rng = np.random.default_rng(args.seed + 14)
    vocab = trainer.model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in (64, 300, 700,
                                                             1000)]
    max_new = 16
    eng = ServeEngine.from_train_state(trainer)
    model, cfg = eng.scheduler.decoder.model, eng.cfg
    eng.generate([Request(prompt_ids=prompts[0][:32], max_new_tokens=2)])
    eng.reset_stats()
    sched = eng.scheduler
    dec0, pre0 = sched.decode_dispatches, sched.prefill_dispatches
    for shape in pa.launch_counts:           # counts start here ...
        pa.launch_counts[shape] = 0
    res = eng.generate([Request(prompt_ids=p, max_new_tokens=max_new)
                        for p in prompts])
    torch.cuda.synchronize()
    launches = dict(pa.launch_counts)        # ... and are read here
    dispatches = {"decode": sched.decode_dispatches - dec0,
                  "prefill": sched.prefill_dispatches - pre0}
    stats = eng.stats()
    eng.close()
    for shape, n in dispatches.items():
        if n == 0 or launches[shape] != cfg.num_layers * n:
            _fail(f"{tag} serving: {shape} kernel launches {launches[shape]} "
                  f"!= layers {cfg.num_layers} x dispatches {n}")
    streams = [r.tokens for r in res]
    if any(len(s) != max_new for s in streams):
        _fail(f"{tag} serving: streams of {[len(s) for s in streams]} tokens")
    ref = _prompt_logits(torch, model, cfg, prompts, "torch")
    rel = {}
    for name, attend in (("kernel", None), ("wrong_gqa", _wrong_gqa),
                         ("drop_own_key", _drop_own_key)):
        got = _prompt_logits(torch, model, cfg, prompts,
                             "cuda" if attend is None else "torch", attend)
        if not all(torch.isfinite(a).all() for a in got):
            _fail(f"{tag} serving: non-finite logits ({name})")
        rel[name] = [((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref)]
    limit = _logits_limit(cfg.num_layers)
    gen = [generate(model, torch.tensor([p], device="cuda"),
                    max_new_tokens=max_new)[0, len(p):].tolist()
           for p in prompts]
    firsts = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
              for a, b in zip(streams, gen)]
    print(f"{tag} serving: {len(prompts)} greedy requests (prompts "
          f"{[len(p) for p in prompts]}, {max_new} new tokens) from the "
          f"trainer's weights in bf16: {stats['tokens_per_sec']:.1f} tokens/s, "
          f"TTFT p50 {stats['ttft_s_p50'] * 1e3:.1f} ms, per-token p50 "
          f"{stats['per_token_s_p50'] * 1e3:.2f} ms; B4 launches {launches} = "
          f"{cfg.num_layers} x {dispatches}; last-prompt logits vs plain "
          f"attention: kernel {_fmt(rel['kernel'])} (limit {limit:.3g}), "
          f"controls wrong_gqa {_fmt(rel['wrong_gqa'])}, drop_own_key "
          f"{_fmt(rel['drop_own_key'])}; first greedy divergence from "
          f"generate() in bf16 (None = identical) {firsts}", flush=True)
    if max(rel["kernel"]) > limit:
        _fail(f"{tag} serving: logits through B4 part from the plain path by "
              f"{max(rel['kernel']):.3g} > {limit:.3g}")
    for name in ("wrong_gqa", "drop_own_key"):
        if max(rel[name]) <= limit:
            _fail(f"{tag} serving: the {name} control stays within "
                  f"{limit:.3g}")
    del eng, model
    torch.cuda.empty_cache()
    # f32 compute: B4's and B1's f32 bodies at heads of 64, whose sums
    # differ in the last bits only, so that no greedy choice flips
    # between serving and generate()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = TransformerLM(cfg32, device="meta", dtype=torch.float32)
    model32 = model32.to_empty(device="cuda").requires_grad_(False).eval()
    with torch.no_grad():
        for n, p in model32.named_parameters():
            p.copy_(trainer.state.params[n])
    eng = ServeEngine(model32, trainer.config)
    res = eng.generate([Request(prompt_ids=p, max_new_tokens=8)
                        for p in prompts[:2]])
    gen = [generate(model32, torch.tensor([p], device="cuda"),
                    max_new_tokens=8)[0, len(p):].tolist()
           for p in prompts[:2]]
    eng.close()
    print(f"{tag} serving f32: streams {[r.tokens for r in res]}, "
          f"generate() {gen}", flush=True)
    if [r.tokens for r in res] != gen:
        _fail(f"{tag} serving f32: the served greedy streams differ from "
              f"generate() on the same weights")
    del eng, model32
    return {"paged_launches": launches, "paged_dispatches": dispatches,
            "serve_tokens_per_s": stats["tokens_per_sec"],
            "logits_rel": rel["kernel"], "first_divergence_bf16": firsts}


# ---------------------------------------------------------------------------
# the Gemma family: heads of 256 (B-2)
# ---------------------------------------------------------------------------

# google/gemma-2-2b's published config.json: 2.6 B parameters, 8/4 heads
# of 256, a 4096-key window on every other layer, softcaps 50 and 30
GEMMA2_2B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 2304, "intermediate_size": 9216,
    "num_hidden_layers": 26, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-06, "query_pre_attn_scalar": 256,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True,
    "attention_bias": False, "attention_dropout": 0.0,
    "initializer_range": 0.02, "torch_dtype": "float32",
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
    "cache_implementation": "hybrid",
}
GEMMA2_S = 8192                  # tokens a training row, one document
GEMMA2_STEPS = 6                 # fit steps (the first 2 are warm-up)
# the first-batch loss through B1 against the plain attention's, relative:
# read 1.8e-5 at 8 layers on an H100 (PERF.md), and 4.5e-4 for its
# control, the plain attention with every window lifted
GEMMA2_LOSS_LIMIT = 1e-4
# the served gemma-2b's first layers whose q heads project as their kv
# head does, so that a row attends to its own key (_gemma_serving_phase).
# Over seeds 0-2 on an H100 with 1 (2, 3) such layers the kernel read
# <= 0.023 (0.015, 0.015) of the logits, the 64-key window's largest
# reading a seed >= 0.26 (0.18, 0.155), the own key's >= 0.98 (1.09,
# 1.08), against the limit 0.127: more tied layers leave fewer whose
# near-uniform attention the window moves
GEMMA_TIED_LAYERS = 1
# the kernels' heads at 256 on this slice's paths: gemma2-2b's 8/4
# (training, B1-B3) and gemma-2b's 8 over 1 (serving, B4)
GEMMA_FLASH_HEADS, GEMMA_PAGED_HEADS = (8, 4), (8, 1)


def _gemma_kernel_phase(torch, args, pa):
    """B4 and B1-B3 at heads of 256 against their plain versions: B4 at
    gemma-2b's heads (decode, prefill, softcap, window, long decode),
    B1-B3 at gemma2-2b's in bf16 at the training shape of both layer
    kinds (a sliding layer's 4095-key window and a global layer, softcap
    50, one 8192-token row), timed beside compiled flex_attention, and
    again without the softcap beside SDPA; f16 and f32 cases with the
    window, the softcap and packed documents; rows that see no key.  q
    is scaled by SOFTCAP_Q_MUL wherever the cap is on, so that the cap
    bends the scores that carry the softmax."""
    kern = _kernel_phase(torch, args, pa, d=256, heads=GEMMA_PAGED_HEADS,
                         only=("decode", "prefill", "decode_softcap",
                               "prefill_window", "decode_long"))
    bf, win = torch.bfloat16, (GEMMA2_2B["sliding_window"] - 1, -1)
    big = dict(q_mul=SOFTCAP_Q_MUL)
    cases = {   # b, sq, sk, dtype, segments, causal, window, softcap, more
        "sliding": (1, GEMMA2_S, GEMMA2_S, bf, False, True, win, 50.0, big),
        "global": (1, GEMMA2_S, GEMMA2_S, bf, False, True, (-1, -1), 50.0,
                   big),
        "sliding_no_cap": (1, GEMMA2_S, GEMMA2_S, bf, False, True, win, 0.0,
                           {}),
        "f16_window_softcap": (1, 2048, 2048, torch.float16, True, True,
                               (1023, -1), 50.0, big),
        "f32_window_softcap": (1, 1024, 1024, torch.float32, True, True,
                               (255, -1), 50.0, big),
        "sq_ne_sk_empty_rows": (1, 1536, 512, bf, False, True, (-1, -1), 0.0,
                                {}),
    }
    flash = _flash_phase(torch, args, d=256, heads=GEMMA_FLASH_HEADS,
                         cases=cases,
                         timed=("sliding", "global", "sliding_no_cap"))
    return kern, flash


def _gemma2_training_phase(torch, args):
    """google/gemma-2-2b's config.json at --gemma-layers with seeded bf16
    weights in HF's layout through accelerate(path) -> Trainer.fit on
    rows of one 8192-token document, so that the sliding layers' window
    masks: the first batch's loss through B1-B3 against the plain
    attention's, then the run's losses, step time, MFU and launches."""
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, accelerate)
    from torchacc_tpu_torch.models.transformer import (head_weight,
                                                      set_model_config)
    from torchacc_tpu_torch.ops.fused import fused_linear_cross_entropy
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_linear
    import dataclasses

    tag, layers, steps, warm = ("gemma2", args.gemma_layers, GEMMA2_STEPS,
                                2)
    if layers % 2 or layers < 2:
        _fail(f"--gemma-layers must be a positive multiple of the pattern's "
              f"period 2, got {layers}")
    print(f"{tag}: depth cut to {layers} of "
          f"{GEMMA2_2B['num_hidden_layers']} layers (full width kept)",
          flush=True)
    per_layer = 2 * 2304 * 2048 + 2 * 2304 * 1024 + 3 * 2304 * 9216
    root = _hf_root(2 * (256000 * 2304 + layers * per_layer))
    try:
        t0 = time.perf_counter()
        _, nbytes = _write_hf_checkpoint(torch, root, args.seed + 21, layers,
                                         GEMMA2_2B)
        print(f"{tag}: wrote gemma-2-2b's config.json and {nbytes} bytes of "
              f"bf16 safetensors to {root} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                      data=DataConfig(max_length=GEMMA2_S, prefetch=2),
                      seed=args.seed)
        docs = _zipf_docs(args.seed + 22, (steps + 1) * GEMMA2_S,
                          GEMMA2_2B["vocab_size"], lo=GEMMA2_S,
                          hi=GEMMA2_S + 1)
        first = next(iter(PackedDataset(docs, seq_len=GEMMA2_S,
                                        batch_rows=1)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer, loader = accelerate(
            root, PackedDataset(docs, seq_len=GEMMA2_S, batch_rows=1), conf,
            optimizer=adamw(warmup_linear(1e-4, steps, 1)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = trainer.model.cfg
    if (cfg.head_size, cfg.layer_pattern, cfg.window, cfg.attn_logit_softcap,
            cfg.logit_softcap, cfg.norm) != (256, ("sliding", "global"),
                                             (4095, -1), 50.0, 30.0,
                                             "rmsnorm1p"):
        _fail(f"{tag}: config_from_hf gave {cfg}")
    n_params = sum(p.numel() for p in trainer.state.params.values())

    # the first batch's loss through the kernels and through the plain
    # attention, from the same weights; a control lifts every window
    batch = {k: torch.as_tensor(v).cuda() for k, v in first.items()}
    labels = shift_labels(batch["input_ids"], batch["segment_ids"])
    model = trainer.model

    @torch.no_grad()
    def loss(**fields):
        set_model_config(model, dataclasses.replace(cfg, **fields))
        hidden = model(batch["input_ids"], batch["positions"],
                       batch["segment_ids"], return_hidden=True)
        l_sum, count = fused_linear_cross_entropy(
            hidden, head_weight(model).t(), labels,
            logit_softcap=cfg.logit_softcap)
        return (l_sum / count).item()
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    got = loss(attention_impl="cuda")
    if fa.launch_counts["fwd"] != layers:
        _fail(f"{tag}: the check's forward launched B1 "
              f"{fa.launch_counts['fwd']} times, not {layers}")
    ref = loss(attention_impl="torch")
    no_window = loss(attention_impl="torch", window=(-1, -1))
    set_model_config(model, cfg)
    rel = abs(got - ref) / abs(ref)
    rel_control = abs(no_window - ref) / abs(ref)
    limit = GEMMA2_LOSS_LIMIT
    print(f"{tag} check: first-batch loss through B1 {got:.6f}, plain "
          f"attention {ref:.6f}, relative {rel:.3g} (limit {limit:.3g}); "
          f"control, plain with every window lifted, {no_window:.6f} "
          f"(relative {rel_control:.3g}, must exceed the limit)", flush=True)
    if not math.isfinite(got) or rel > limit:
        _fail(f"{tag}: the first-batch loss through the kernels parts from "
              f"the plain attention's by {rel:.3g} > {limit:.3g}")
    if rel_control <= limit:
        _fail(f"{tag}: the window-lifted control stays within {limit:.3g}: "
              f"the check cannot tell whether the window bites")

    tap = _StepTap(torch, trainer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launch_counts:             # counts start here ...
        fa.launch_counts[key] = 0
    trainer.fit(loader, max_steps=steps, log_every=0)
    step_ms, ms = tap.finish(warm)
    launches = dict(fa.launch_counts)        # ... and are read here
    losses = [m["loss"].item() for m in tap.metrics]
    peak = torch.cuda.max_memory_allocated()
    attn = cfg.num_heads * cfg.head_size
    flops_tok = 6.0 * n_params + 6.0 * layers * attn * GEMMA2_S
    mfu = flops_tok * GEMMA2_S / (ms / 1e3) / PEAK_BF16_FLOPS
    want = {k: layers * steps for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(f"{tag}: fit over 1 x {GEMMA2_S} tokens a step (one document a "
          f"row: the 4095-key window masks on the {layers // 2} sliding "
          f"layers): losses {_fmt(losses)}; step ms {_fmt(step_ms)} (first "
          f"{warm} warm-up), mean {ms:.1f} ms, {GEMMA2_S / (ms / 1e3):.0f} "
          f"tokens/s, MFU {mfu:.4f} of the bf16 peak (6N + 6*L*heads*d*s "
          f"per token, N = {n_params}, causal pairs counted whole); peak "
          f"allocated {peak / 2**30:.2f} GiB; B1/B2/B3 launches at d 256 "
          f"{launches} (expected {want}: layers x steps)", flush=True)
    if not all(np.isfinite(losses)):
        _fail(f"{tag}: losses {losses}")
    if not np.mean(losses[-2:]) < losses[0]:
        _fail(f"{tag}: the loss did not fall on distinct batches: {losses}")
    if launches != want:
        _fail(f"{tag}: flash launches {launches} != {want}")
    del tap, loader, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "layers": layers,
            "step_ms": ms, "mfu": mfu, "tokens_per_s": GEMMA2_S / (ms / 1e3),
            "peak_bytes": peak, "losses": losses, "check_rel": rel}


def _gemma3_generate_phase(torch, args):
    """gemma3-1b at full width and one pattern period (5 sliding layers
    with a 512-key window and the local rope base, 1 global) through
    generate() on prompts of 1024 tokens, so that the window bites:
    bf16 through B1 (counted) beside the plain attention, then f32
    token for token against the plain attention."""
    import dataclasses
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import get_preset, init_params
    from torchacc_tpu_torch.models.generate import generate

    tag, layers, max_new = "gemma3 generate", 6, 16
    cfg = get_preset("gemma3-1b", dtype=torch.bfloat16, num_layers=layers)
    model = init_params(cfg, seed=args.seed + 31, device="cuda",
                        dtype=torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 32).integers(
        0, cfg.vocab_size, (2, 1024))).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag}: gemma3-1b x{layers} layers of 26 (one pattern period, "
          f"full width), {n_params / 1e9:.3f}B params bf16; 2 prompts of "
          f"1024 tokens, window {cfg.window}", flush=True)
    generate(model, prompts[:, :64], max_new_tokens=2)   # warm-up
    out, ms = {}, {}
    for impl in ("cuda", "torch"):
        for key in fa.launch_counts:         # counts start here ...
            fa.launch_counts[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[impl] = generate(model, prompts, max_new_tokens=max_new,
                             attention_impl=impl)
        torch.cuda.synchronize()
        ms[impl] = (time.perf_counter() - t0) * 1e3
        if impl == "cuda":
            launches = dict(fa.launch_counts)    # ... and are read here
    want = {"fwd": layers * max_new, "bwd_dq": 0, "bwd_dkv": 0}
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(out["cuda"][:, 1024:].tolist(),
                             out["torch"][:, 1024:].tolist())]
    print(f"{tag}: bf16 {max_new} new tokens x 2 rows in {ms['cuda']:.1f} ms "
          f"through B1 ({ms['torch']:.1f} ms plain); B1 launches {launches} "
          f"(expected {want}: layers x (the prefill + {max_new - 1} decode "
          f"steps)); first greedy divergence from the plain path in bf16 "
          f"(None = identical) {first}", flush=True)
    if launches != want:
        _fail(f"{tag}: launches {launches} != {want}")
    # f32 compute: B1's f32 body, whose sums differ from the plain
    # version's in the last bits only, so no greedy choice may flip
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    from torchacc_tpu_torch import TransformerLM
    model32 = TransformerLM(cfg32, device="meta", dtype=torch.float32)
    model32 = model32.to_empty(device="cuda").requires_grad_(False).eval()
    with torch.no_grad():
        for (_, p32), (_, p) in zip(model32.named_parameters(),
                                    model.named_parameters()):
            p32.copy_(p)
    toks = {impl: generate(model32, prompts, max_new_tokens=max_new,
                           attention_impl=impl)[:, 1024:].tolist()
            for impl in ("cuda", "torch")}
    print(f"{tag} f32: through B1 {toks['cuda']}, plain {toks['torch']}",
          flush=True)
    if toks["cuda"] != toks["torch"]:
        _fail(f"{tag} f32: the greedy tokens through B1 differ from the "
              f"plain attention's")
    # the prompts' last-position logits (bf16) through B1 against the
    # plain attention, and a control with every window lifted: the 512-key
    # window must move them by more than the kernel does
    from torchacc_tpu_torch.models.transformer import (head_logits,
                                                      set_model_config)

    @torch.no_grad()
    def last_logits(**fields):
        set_model_config(model, dataclasses.replace(cfg, **fields))
        hidden = model(prompts, return_hidden=True)
        set_model_config(model, cfg)
        return head_logits(cfg, model, hidden[:, -1:])[:, 0]
    ref = last_logits(attention_impl="torch")
    rel = {name: ((got - ref).abs().max() / ref.abs().max()).item()
           for name, got in (
               ("kernel", last_logits(attention_impl="cuda")),
               ("no_window", last_logits(attention_impl="torch",
                                         window=(-1, -1))))}
    limit = _logits_limit(layers)
    print(f"{tag}: last-prompt logits vs plain attention: kernel "
          f"{rel['kernel']:.4g} (limit {limit:.3g}), control with every "
          f"window lifted {rel['no_window']:.4g}", flush=True)
    if rel["kernel"] > limit or rel["no_window"] <= limit:
        _fail(f"{tag}: logits {rel} against the limit {limit:.3g}")
    del model, model32
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms["cuda"], "plain_ms": ms["torch"],
            "first_divergence_bf16": first}


def _gemma_serving_phase(torch, args, pa):
    """gemma-2b at full width and depth (18 layers, MQA: 8 q heads over
    one kv head of 256) from init_params(seed), bf16, served through
    ServeEngine: B4 at d 256 launches layers x dispatches, and the
    last-prompt logits lie within _logits_limit of the plain attention
    while two controls do not: a 64-key window the model does not have,
    and the last row not seeing its own key.  Random weights attend
    near-uniformly over hundreds of keys, where one key dropped moves
    the output too little to read; so in the first GEMMA_TIED_LAYERS
    layers each q head's projection is its kv head's (q_i . k_i =
    |k_i|^2, about 13 after the scale, against others' ~N(0, 0.8^2)),
    and there a row attends to its own key.  The other layers keep
    their near-uniform attention, which the window control reads.  With
    one kv head a wrong GQA map cannot show."""
    import numpy as np
    from torchacc_tpu_torch import (Config, Request, ServeConfig, ServeEngine,
                                    get_preset, init_params)

    tag, max_new = "gemma serving", 16
    cfg = get_preset("gemma-2b", dtype=torch.bfloat16)
    model = init_params(cfg, seed=args.seed + 41, device="cuda",
                        dtype=torch.bfloat16)
    group = cfg.num_heads // cfg.kv_heads
    for layer in model.layers[:GEMMA_TIED_LAYERS]:
        wk = layer.attn.k_proj.weight               # [kv heads x d, hidden]
        layer.attn.q_proj.weight.copy_(wk.view(cfg.kv_heads, -1, wk.shape[1])
                                       .repeat_interleave(group, dim=0)
                                       .reshape_as(layer.attn.q_proj.weight))
    rng = np.random.default_rng(args.seed + 42)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (64, 300, 700, 1000)]
    eng = ServeEngine(model, Config(serve=ServeConfig(
        block_size=BS, num_blocks=1024, max_slots=8, prefill_chunk=256,
        decode_depth=2)))
    eng.generate([Request(prompt_ids=prompts[0][:32], max_new_tokens=2)])
    eng.reset_stats()
    sched = eng.scheduler
    dec0, pre0 = sched.decode_dispatches, sched.prefill_dispatches
    for shape in pa.launch_counts:           # counts start here ...
        pa.launch_counts[shape] = 0
    res = eng.generate([Request(prompt_ids=p, max_new_tokens=max_new)
                        for p in prompts])
    torch.cuda.synchronize()
    launches = dict(pa.launch_counts)        # ... and are read here
    dispatches = {"decode": sched.decode_dispatches - dec0,
                  "prefill": sched.prefill_dispatches - pre0}
    stats = eng.stats()
    eng.close()
    for shape, n in dispatches.items():
        if n == 0 or launches[shape] != cfg.num_layers * n:
            _fail(f"{tag}: {shape} launches {launches[shape]} != layers "
                  f"{cfg.num_layers} x dispatches {n}")
    if any(len(r.tokens) != max_new for r in res):
        _fail(f"{tag}: streams of {[len(r.tokens) for r in res]} tokens")
    ref = _prompt_logits(torch, model, cfg, prompts, "torch")
    rel = {}
    def narrow_window(*a, **kw):
        from torchacc_tpu_torch.ops.paged_attention import paged_attention
        return paged_attention(*a, **dict(kw, window=(63, -1)))
    for name, attend in (("kernel", None), ("narrow_window", narrow_window),
                         ("drop_own_key", _drop_own_key)):
        got = _prompt_logits(torch, model, cfg, prompts,
                             "cuda" if attend is None else "torch", attend)
        if not all(torch.isfinite(a).all() for a in got):
            _fail(f"{tag}: non-finite logits ({name})")
        rel[name] = [((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref)]
    limit = _logits_limit(cfg.num_layers)
    print(f"{tag}: gemma-2b x{cfg.num_layers} (full depth and width), "
          f"{len(prompts)} greedy requests (prompts "
          f"{[len(p) for p in prompts]}, {max_new} new tokens) in bf16: "
          f"{stats['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{stats['ttft_s_p50'] * 1e3:.1f} ms, per-token p50 "
          f"{stats['per_token_s_p50'] * 1e3:.2f} ms; B4 launches at d 256 "
          f"{launches} = {cfg.num_layers} x {dispatches}; last-prompt logits "
          f"vs plain attention: kernel {_fmt(rel['kernel'])} (limit "
          f"{limit:.3g}), controls narrow_window "
          f"{_fmt(rel['narrow_window'])}, drop_own_key "
          f"{_fmt(rel['drop_own_key'])}", flush=True)
    if max(rel["kernel"]) > limit:
        _fail(f"{tag}: logits through B4 part from the plain path by "
              f"{max(rel['kernel']):.3g} > {limit:.3g}")
    for name in ("narrow_window", "drop_own_key"):
        if max(rel[name]) <= limit:
            _fail(f"{tag}: the {name} control stays within {limit:.3g}")
    del eng, model
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches,
            "tokens_per_s": stats["tokens_per_sec"],
            "logits_rel": rel["kernel"]}


# ---------------------------------------------------------------------------
# the LayerNorm families: Phi-2's heads of 80 (B-2), GPT-2, ALiBi
# ---------------------------------------------------------------------------

# microsoft/phi-2's published config.json: 2.78 B parameters, 32 heads
# of 80 (MHA), partial rotary 0.4 (32 of 80 dims rotate), the parallel
# block with one LayerNorm, gelu_new, biases everywhere and on the head
PHI2 = {
    "architectures": ["PhiForCausalLM"], "model_type": "phi",
    "vocab_size": 51200, "hidden_size": 2560, "intermediate_size": 10240,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 2048,
    "partial_rotary_factor": 0.4, "rope_theta": 10000.0,
    "rope_scaling": None, "layer_norm_eps": 1e-05, "hidden_act": "gelu_new",
    "tie_word_embeddings": False, "qk_layernorm": False,
    "initializer_range": 0.02, "attention_dropout": 0.0,
    "embd_pdrop": 0.0, "resid_pdrop": 0.1, "bos_token_id": 50256,
    "eos_token_id": 50256, "torch_dtype": "float16",
}
PHI2_B, PHI2_S, PHI2_STEPS = 2, 2048, 6   # 2 x 2048 packed tokens, 6 steps
# openai-community/gpt2's published config.json: 124 M parameters, 12
# heads of 64, learned positions (1024), gelu_new, a tied head, Conv1D
# weights
GPT2 = {
    "architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
    "vocab_size": 50257, "n_embd": 768, "n_layer": 12, "n_head": 12,
    "n_positions": 1024, "n_ctx": 1024, "n_inner": None,
    "activation_function": "gelu_new", "layer_norm_epsilon": 1e-05,
    "initializer_range": 0.02, "attn_pdrop": 0.1, "embd_pdrop": 0.1,
    "resid_pdrop": 0.1, "bos_token_id": 50256, "eos_token_id": 50256,
}
GPT2_B, GPT2_S, GPT2_STEPS = 8, 1024, 6   # 8 x 1024 packed tokens, 6 steps
ALIBI_STEPS = 2
# the served gpt2's last-prompt logits through B4 against the plain
# path, relative: read <= 0.004 (one bf16 ulp of the largest logit) on an
# H100 after the 6 training steps, the 64-key window's control 0.024-
# 0.027 on the prompts it cuts, the own-key control 0.004 (attention
# near-uniform: printed only); _logits_limit's 0.104 at 12 layers, set
# from llama readings, lies above both controls
GPT2_LOGITS_LIMIT = 0.01
# the first-batch loss through B1-B3 against the plain attention's,
# relative, for Phi-2 and the ALiBi model: like GEMMA2_LOSS_LIMIT, a
# bound on bf16 rounding through every layer; each has a control (Phi-2:
# every dim rotating, partial rotary lifted to 1.0; ALiBi: the slopes
# halved) that must exceed it
LN_LOSS_LIMIT = 1e-4
PHI2_FLASH_HEADS = (32, 32)


def _phi2_kernel_phase(torch, args):
    """B1-B3 at Phi-2's heads, 32 of 80 (MHA), against the plain versions:
    b 2, s 2048, causal packed documents in bf16 (checked and timed
    beside SDPA with a dense mask at d 80), f16 (two ulps) and f32
    (1e-5), ALiBi and dropout in bf16, f16 and f32, and rows that see no
    key."""
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    slopes = 2.0 ** (-8.0 * torch.arange(1, 33, device="cuda",
                                         dtype=torch.float32) / 32)
    drop = dict(dropout_p=0.1, dropout_seed=80)
    cases = {   # b, sq, sk, dtype, segments, causal, window, softcap, more
        "train": (PHI2_B, PHI2_S, PHI2_S, bf, True, True, (-1, -1), 0.0, {}),
        "f16": (PHI2_B, PHI2_S, PHI2_S, f16, True, True, (-1, -1), 0.0, {}),
        "f32": (1, 1024, 1024, f32, True, True, (-1, -1), 0.0, {}),
        "alibi": (PHI2_B, PHI2_S, PHI2_S, bf, True, True, (-1, -1), 0.0,
                  dict(alibi_slopes=slopes)),
        "dropout": (PHI2_B, PHI2_S, PHI2_S, bf, True, True, (-1, -1), 0.0,
                    drop),
        "dropout_alibi_f16": (1, PHI2_S, PHI2_S, f16, True, True, (-1, -1),
                              0.0, dict(drop, alibi_slopes=slopes)),
        "dropout_alibi_f32": (1, 1024, 1024, f32, True, True, (-1, -1), 0.0,
                              dict(drop, alibi_slopes=slopes)),
        "window_sq_ne_sk": (1, 1536, 512, bf, False, True, (300, -1), 0.0,
                            {}),
    }
    return _flash_phase(torch, args, d=80, heads=PHI2_FLASH_HEADS,
                        cases=cases, timed=("train",))


def _gpt2_alibi_kernel_phase(torch, args):
    """B1-B3's ALiBi instantiation at GPT-2's attention, 12 heads of 64,
    8 x 1024 packed tokens, bf16, with the model's slopes
    (``alibi_slopes(12)``): checked against the plain versions and timed
    beside SDPA with the bias in a dense float mask."""
    from torchacc_tpu_torch.models.transformer import alibi_slopes
    slopes = torch.tensor(alibi_slopes(12), device="cuda")
    cases = {"alibi": (GPT2_B, GPT2_S, GPT2_S, torch.bfloat16, True, True,
                       (-1, -1), 0.0, dict(alibi_slopes=slopes))}
    return _flash_phase(torch, args, d=64, heads=(12, 12), cases=cases,
                        timed=("alibi",))["alibi"]


def _first_loss(torch, model, batch, labels, cfg, **fields):
    """The batch's loss from materialised logits (a head_bias model's
    path) under ``cfg`` with ``fields`` replaced, without gradients."""
    import dataclasses
    from torchacc_tpu_torch.models.transformer import (loss_fn,
                                                      set_model_config)
    set_model_config(model, dataclasses.replace(cfg, **fields))
    try:
        with torch.no_grad():
            logits = model(batch["input_ids"], batch["positions"],
                           batch["segment_ids"])
            return loss_fn(logits, labels).item()
    finally:
        set_model_config(model, cfg)


def _ln_fit(torch, tag, trainer, loader, layers, steps, rows, seq,
            n_params, flops=None):
    """``trainer.fit`` over ``loader`` (``rows`` x ``seq`` tokens a
    step) for ``steps`` steps with the flash launches counted from its
    start: losses, mean step ms after 2 warm-up steps (1 when there are
    2), tokens/s, MFU, peak bytes, launches.  ``flops``: the FLOPs a
    step computes (a mixture of experts', ``_moe_flops``), where 6N +
    6*L*heads*d*s a token would miscount them."""
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    cfg = trainer.model.cfg
    tap = _StepTap(torch, trainer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launch_counts:             # counts start here ...
        fa.launch_counts[key] = 0
    trainer.fit(loader, max_steps=steps, log_every=0)
    step_ms, ms = tap.finish(min(2, steps - 1))
    launches = dict(fa.launch_counts)        # ... and are read here
    wait_ms = loader.wait_s * 1e3 / steps     # the fit's iteration's
    losses = [m["loss"].item() for m in tap.metrics]
    peak = torch.cuda.max_memory_allocated()
    tokens = rows * seq
    attn = cfg.num_heads * cfg.head_size
    how = (f"6N + 6*L*heads*d*s per token, N = {n_params} by "
           f"ModelConfig.num_params" if flops is None else
           f"{flops:.6g} FLOPs a step, _moe_flops")
    if flops is None:
        flops = (6.0 * n_params + 6.0 * layers * attn * seq) * tokens
    mfu = flops / (ms / 1e3) / PEAK_BF16_FLOPS
    want = {k: layers * steps for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(f"{tag}: fit over {tokens} tokens a step: losses {_fmt(losses)}; "
          f"step ms {_fmt(step_ms)}, mean {ms:.1f} ms, "
          f"{tokens / (ms / 1e3):.0f} tokens/s, MFU {mfu:.4f} of the bf16 "
          f"peak ({how}); peak allocated {peak / 2**30:.2f} GiB; "
          f"the host waiting {wait_ms:.1f} ms a step on the loader; "
          f"B1/B2/B3 launches {launches} (expected {want}: layers x steps)",
          flush=True)
    if not all(np.isfinite(losses)):
        _fail(f"{tag}: losses {losses}")
    if launches != want:
        _fail(f"{tag}: flash launches {launches} != {want}")
    return {"losses": losses, "step_ms": ms, "tokens_per_s":
            tokens / (ms / 1e3), "mfu": mfu, "peak_bytes": peak,
            "launches": launches, "steps": steps, "layers": layers,
            "loader_wait_ms": wait_ms, "flops": flops}


def _generate_check(torch, tag, model, cfg, prompts, max_new):
    """generate() through B1 (launches counted) and through the plain
    attention, in bf16 (first divergence printed) and in f32 compute on
    the same weights (tokens identical)."""
    import dataclasses
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch.models.generate import generate
    from torchacc_tpu_torch.models.transformer import set_model_config
    p = prompts.shape[1]
    out, ms = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        set_model_config(model, dataclasses.replace(cfg, dtype=dt))
        for impl in ("cuda", "torch"):
            for key in fa.launch_counts:     # counts start here ...
                fa.launch_counts[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[dt, impl] = generate(model, prompts, max_new_tokens=max_new,
                                     attention_impl=impl)[:, p:].tolist()
            torch.cuda.synchronize()
            ms[dt, impl] = (time.perf_counter() - t0) * 1e3
            if (dt, impl) == (torch.bfloat16, "cuda"):
                launches = dict(fa.launch_counts)    # ... and read here
    set_model_config(model, cfg)
    want = {"fwd": cfg.num_layers * max_new, "bwd_dq": 0, "bwd_dkv": 0}
    bf = torch.bfloat16
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(out[bf, "cuda"], out[bf, "torch"])]
    print(f"{tag} generate: {prompts.shape[0]} prompts of {p} tokens, "
          f"{max_new} new, bf16 in {ms[bf, 'cuda']:.1f} ms through B1 "
          f"({ms[bf, 'torch']:.1f} ms plain); B1 launches {launches} "
          f"(expected {want}: layers x (the prefill + {max_new - 1} decode "
          f"steps)); first greedy divergence from the plain path in bf16 "
          f"(None = identical) {first}; f32 through B1 "
          f"{out[torch.float32, 'cuda']}, plain "
          f"{out[torch.float32, 'torch']}", flush=True)
    if launches != want:
        _fail(f"{tag} generate: launches {launches} != {want}")
    if out[torch.float32, "cuda"] != out[torch.float32, "torch"]:
        _fail(f"{tag} generate f32: the greedy tokens through B1 differ "
              f"from the plain attention's")
    return {"launches": launches, "ms": ms[bf, "cuda"],
            "plain_ms": ms[bf, "torch"], "first_divergence_bf16": first}


def _phi2_phase(torch, args):
    """microsoft/phi-2's config.json at full width and --phi2-layers with seeded
    bf16 weights in Phi's HF names, through accelerate(path) (the
    materialising converter, as in JAX) -> Trainer.fit over 2 x 2048
    packed tokens a step: the first batch's loss through B1-B3 at d 80
    against the plain attention's, with the partial-rotary-lifted
    control; the losses, step time, MFU, peak memory and launches; then
    generate() through B1 at d 80."""
    import numpy as np
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, accelerate)
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_linear

    tag, layers, steps = "phi-2", args.phi2_layers, PHI2_STEPS
    h, f, v = PHI2["hidden_size"], PHI2["intermediate_size"], \
        PHI2["vocab_size"]
    est = 2 * (2 * v * h + layers * (4 * h * h + 2 * h * f))
    root = _hf_root(est)
    try:
        t0 = time.perf_counter()
        _, nbytes = _write_hf_checkpoint(torch, root, args.seed + 51, layers,
                                         PHI2)
        print(f"{tag}: wrote phi-2's config.json and {nbytes} bytes of bf16 "
              f"safetensors to {root} in {time.perf_counter() - t0:.1f} s "
              f"(full width, {layers} of {PHI2['num_hidden_layers']} "
              f"layers)", flush=True)
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                      data=DataConfig(max_length=PHI2_S, prefetch=2),
                      seed=args.seed)
        docs = _zipf_docs(args.seed + 52, (steps + 1) * PHI2_B * PHI2_S, v)
        first = next(iter(PackedDataset(docs, seq_len=PHI2_S,
                                        batch_rows=PHI2_B)))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        # lr 2e-5: at 1e-4 the random 32-layer model's loss rose from 11.0
        # to 17.9 by the third step (an H100 run), where the 8-layer
        # llama3-8b and gemma2 phases fall at 1e-4; the same model at 8
        # layers and a fifth of the width follows JAX's Trainer step for
        # step on the CPU
        trainer, loader = accelerate(
            root, PackedDataset(docs, seq_len=PHI2_S, batch_rows=PHI2_B),
            conf, optimizer=adamw(warmup_linear(2e-5, steps, 1)))
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = trainer.model.cfg
    if (cfg.head_size, cfg.partial_rotary, cfg.parallel_block, cfg.head_bias,
            cfg.norm, cfg.activation, trainer._use_fused_ce) != (
            80, 0.4, True, True, "layernorm", "gelu", False):
        _fail(f"{tag}: config_from_hf gave {cfg}")
    n_params = cfg.num_params()
    if n_params != sum(p.numel() for p in trainer.state.params.values()):
        _fail(f"{tag}: num_params {n_params} is not the model's count")
    print(f"{tag}: accelerate(path) in {load_s:.1f} s "
          f"({nbytes / load_s / 1e9:.2f} GB/s of checkpoint), {n_params} "
          f"params", flush=True)

    import torchacc_tpu_torch.ops.flash_attention as fa
    batch = {k: torch.as_tensor(x).cuda() for k, x in first.items()}
    labels = shift_labels(batch["input_ids"], batch["segment_ids"])
    model = trainer.model
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    got = _first_loss(torch, model, batch, labels, cfg,
                      attention_impl="cuda")
    if fa.launch_counts["fwd"] != layers:
        _fail(f"{tag}: the check's forward launched B1 "
              f"{fa.launch_counts['fwd']} times, not {layers}")
    ref = _first_loss(torch, model, batch, labels, cfg, attention_impl="torch")
    control = _first_loss(torch, model, batch, labels, cfg,
                          attention_impl="torch", partial_rotary=1.0)
    rel, rel_control = abs(got - ref) / abs(ref), abs(control - ref) / abs(ref)
    print(f"{tag} check: first-batch loss through B1 at d 80 {got:.6f}, "
          f"plain attention {ref:.6f}, relative {rel:.3g} (limit "
          f"{LN_LOSS_LIMIT:.3g}); control, plain with partial rotary lifted "
          f"to 1.0, {control:.6f} (relative {rel_control:.3g}, must exceed "
          f"the limit)", flush=True)
    if not math.isfinite(got) or rel > LN_LOSS_LIMIT:
        _fail(f"{tag}: the first-batch loss through the kernels parts from "
              f"the plain attention's by {rel:.3g} > {LN_LOSS_LIMIT:.3g}")
    if rel_control <= LN_LOSS_LIMIT:
        _fail(f"{tag}: the partial-rotary control stays within "
              f"{LN_LOSS_LIMIT:.3g}")
    res = _ln_fit(torch, tag, trainer, loader, layers, steps, PHI2_B,
                  PHI2_S, n_params)
    res["check_rel"], res["control_rel"] = rel, rel_control
    del loader
    # generate() on the trained weights (the model's are the bf16 shadow)
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 53).integers(
        0, v, (2, 256))).cuda()
    res["generate"] = _generate_check(torch, tag, model, cfg, prompts, 8)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _gpt2_phase(torch, args, pa):
    """openai-community/gpt2's config.json at full width and depth with
    seeded bf16 weights in its Conv1D layout, through accelerate(path)
    -> Trainer.fit over 8 x 1024 packed tokens a step; then
    ServeEngine.from_train_state serves 4 greedy requests on B4 at d 64:
    launches layers x dispatches, and the last-prompt logits within
    _logits_limit of the plain path while a 64-key-window control is
    not."""
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, Request,
                                    ServeConfig, ServeEngine, accelerate)
    from torchacc_tpu_torch.train import adamw, warmup_linear
    import numpy as np

    tag, layers, steps = "gpt2", GPT2["n_layer"], GPT2_STEPS
    h, v = GPT2["n_embd"], GPT2["vocab_size"]
    root = _hf_root(2 * (v * h + 1024 * h + layers * 12 * h * h))
    try:
        _, nbytes = _write_hf_checkpoint(torch, root, args.seed + 61, layers,
                                         GPT2)
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                      data=DataConfig(max_length=GPT2_S, prefetch=2),
                      serve=ServeConfig(block_size=BS, num_blocks=512,
                                        max_slots=8, prefill_chunk=256,
                                        decode_depth=2),
                      seed=args.seed)
        docs = _zipf_docs(args.seed + 62, (steps + 1) * GPT2_B * GPT2_S, v,
                          lo=128, hi=GPT2_S)
        trainer, loader = accelerate(
            root, PackedDataset(docs, seq_len=GPT2_S, batch_rows=GPT2_B),
            conf, optimizer=adamw(warmup_linear(3e-4, steps, 1)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = trainer.model.cfg
    if (cfg.head_size, cfg.pos_emb, cfg.norm, cfg.tie_embeddings,
            cfg.max_seq_len) != (64, "learned", "layernorm", True, 1024):
        _fail(f"{tag}: config_from_hf gave {cfg}")
    print(f"{tag}: {nbytes} bytes of Conv1D-layout bf16 safetensors "
          f"converted by accelerate(path)", flush=True)
    res = _ln_fit(torch, tag, trainer, loader, layers, steps, GPT2_B,
                  GPT2_S, cfg.num_params())
    if not np.mean(res["losses"][-2:]) < res["losses"][0]:
        _fail(f"{tag}: the loss did not fall: {res['losses']}")
    del loader
    eng = ServeEngine.from_train_state(trainer)
    model = eng.scheduler.decoder.model
    rng = np.random.default_rng(args.seed + 63)
    prompts = [rng.integers(0, v, n).tolist() for n in (64, 300, 600, 900)]
    max_new = 16
    eng.generate([Request(prompt_ids=prompts[0][:32], max_new_tokens=2)])
    eng.reset_stats()
    sched = eng.scheduler
    dec0, pre0 = sched.decode_dispatches, sched.prefill_dispatches
    for shape in pa.launch_counts:           # counts start here ...
        pa.launch_counts[shape] = 0
    out = eng.generate([Request(prompt_ids=p, max_new_tokens=max_new)
                        for p in prompts])
    torch.cuda.synchronize()
    launches = dict(pa.launch_counts)        # ... and are read here
    dispatches = {"decode": sched.decode_dispatches - dec0,
                  "prefill": sched.prefill_dispatches - pre0}
    stats = eng.stats()
    eng.close()
    for shape, n in dispatches.items():
        if n == 0 or launches[shape] != layers * n:
            _fail(f"{tag} serving: {shape} launches {launches[shape]} != "
                  f"layers {layers} x dispatches {n}")
    if any(len(r.tokens) != max_new for r in out):
        _fail(f"{tag} serving: streams of {[len(r.tokens) for r in out]}")
    ref = _prompt_logits(torch, model, model.cfg, prompts, "torch")

    def narrow_window(*a, **kw):
        from torchacc_tpu_torch.ops.paged_attention import paged_attention
        return paged_attention(*a, **dict(kw, window=(63, -1)))
    rel = {}
    for name, attend in (("kernel", None), ("narrow_window", narrow_window),
                         ("drop_own_key", _drop_own_key)):
        got = _prompt_logits(torch, model, model.cfg, prompts,
                             "cuda" if attend is None else "torch", attend)
        if not all(torch.isfinite(a).all() for a in got):
            _fail(f"{tag} serving: non-finite logits ({name})")
        rel[name] = [((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref)]
    limit = GPT2_LOGITS_LIMIT
    print(f"{tag} serving: ServeEngine.from_train_state, {len(prompts)} "
          f"greedy requests (prompts {[len(p) for p in prompts]}, {max_new} "
          f"new tokens) in bf16: {stats['tokens_per_sec']:.1f} tokens/s, "
          f"TTFT p50 {stats['ttft_s_p50'] * 1e3:.1f} ms, per-token p50 "
          f"{stats['per_token_s_p50'] * 1e3:.2f} ms; B4 launches at d 64 "
          f"{launches} = {layers} x {dispatches}; last-prompt logits vs "
          f"plain attention: kernel {_fmt(rel['kernel'])} (limit "
          f"{limit:.3g}), control narrow_window {_fmt(rel['narrow_window'])} "
          f"(must exceed it), drop_own_key {_fmt(rel['drop_own_key'])}",
          flush=True)
    if max(rel["kernel"]) > limit:
        _fail(f"{tag} serving: logits through B4 part from the plain path "
              f"by {max(rel['kernel']):.3g} > {limit:.3g}")
    if max(rel["narrow_window"]) <= limit:
        _fail(f"{tag} serving: the narrow_window control stays within "
              f"{limit:.3g}")
    res.update(paged_launches=launches, paged_dispatches=dispatches,
               serve_tokens_per_s=stats["tokens_per_sec"],
               logits_rel=rel["kernel"])
    del eng, model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _alibi_phase(torch, args):
    """GPT-2's width and depth with pos_emb='alibi' (and biases) from
    init_params(seed), through accelerate() -> Trainer.fit for 2 steps
    of 8 x 1024 packed tokens on B1-B3's ALiBi instantiation: the first
    batch's loss against the plain attention's, with a control (the
    plain attention with the slopes halved) that must exceed the limit;
    launches layers x steps; then a short generate() through B1."""
    import numpy as np
    import torchacc_tpu_torch.models.transformer as tr
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig, PackedDataset, accelerate,
                                    get_preset)
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_linear

    tag, steps = "gpt2 alibi", ALIBI_STEPS
    mc = get_preset("gpt2", pos_emb="alibi", qkv_bias=True, o_bias=True,
                    mlp_bias=True)
    layers = mc.num_layers
    conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  data=DataConfig(max_length=GPT2_S, prefetch=2),
                  seed=args.seed + 71)
    docs = _zipf_docs(args.seed + 72, (steps + 1) * GPT2_B * GPT2_S,
                      mc.vocab_size, lo=128, hi=GPT2_S)
    first = next(iter(PackedDataset(docs, seq_len=GPT2_S, batch_rows=GPT2_B)))
    trainer, loader = accelerate(
        mc, PackedDataset(docs, seq_len=GPT2_S, batch_rows=GPT2_B), conf,
        optimizer=adamw(warmup_linear(3e-4, steps, 1)))
    trainer.init()
    cfg, model = trainer.model.cfg, trainer.model
    batch = {k: torch.as_tensor(x).cuda() for k, x in first.items()}
    labels = shift_labels(batch["input_ids"], batch["segment_ids"])
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    got = _first_loss(torch, model, batch, labels, cfg, attention_impl="cuda")
    if fa.launch_counts["fwd"] != layers:
        _fail(f"{tag}: the check's forward launched B1 "
              f"{fa.launch_counts['fwd']} times, not {layers}")
    ref = _first_loss(torch, model, batch, labels, cfg, attention_impl="torch")
    slopes = tr.alibi_slopes
    tr.alibi_slopes = lambda n: tuple(x / 2 for x in slopes(n))
    try:
        control = _first_loss(torch, model, batch, labels, cfg,
                              attention_impl="torch")
    finally:
        tr.alibi_slopes = slopes
    rel, rel_control = abs(got - ref) / abs(ref), abs(control - ref) / abs(ref)
    print(f"{tag} check: first-batch loss through B1's ALiBi instantiation "
          f"{got:.6f}, plain attention {ref:.6f}, relative {rel:.3g} (limit "
          f"{LN_LOSS_LIMIT:.3g}); control, plain with the slopes halved, "
          f"{control:.6f} (relative {rel_control:.3g}, must exceed the "
          f"limit)", flush=True)
    if not math.isfinite(got) or rel > LN_LOSS_LIMIT:
        _fail(f"{tag}: the first-batch loss through the kernels parts from "
              f"the plain attention's by {rel:.3g} > {LN_LOSS_LIMIT:.3g}")
    if rel_control <= LN_LOSS_LIMIT:
        _fail(f"{tag}: the halved-slopes control stays within "
              f"{LN_LOSS_LIMIT:.3g}")
    res = _ln_fit(torch, tag, trainer, loader, layers, steps, GPT2_B,
                  GPT2_S, cfg.num_params())
    res["check_rel"], res["control_rel"] = rel, rel_control
    del loader
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 73).integers(
        0, cfg.vocab_size, (2, 200))).cuda()
    res["generate"] = _generate_check(torch, tag, model, cfg, prompts, 8)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the rest of the dense forward: Phi-3's heads of 96 (B-2), longrope,
# OLMo2, Cohere, YaRN
# ---------------------------------------------------------------------------

# microsoft/Phi-3-mini-4k-instruct's published config.json, whose widths
# are transformers' Phi3Config() defaults: 3.82 B parameters, 32 heads
# of 96 (MHA), packed qkv_proj/gate_up_proj, a 2047-key sliding window
PHI3_MINI = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 4096,
    "original_max_position_embeddings": 4096, "rope_theta": 10000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-05, "sliding_window": 2047,
    "hidden_act": "silu", "tie_word_embeddings": False,
    "attention_bias": False, "initializer_range": 0.02,
    "attention_dropout": 0.0, "embd_pdrop": 0.0, "resid_pdrop": 0.0,
    "bos_token_id": 1, "eos_token_id": 32000, "pad_token_id": 32000,
    "torch_dtype": "bfloat16",
}
# Phi-3.5-mini-instruct's: the same widths, a 131072-token context over
# the original 4096 by longrope, whose two 48-entry factor lists are not
# on this machine: they are drawn from a seed (_phi35_config)
PHI35_MINI = dict(PHI3_MINI, max_position_embeddings=131072,
                  sliding_window=262144)
PHI3_STEPS = 6
PHI3_FLASH_HEADS = (32, 32)
LONGROPE_PROMPT, LONGROPE_NEW = 4090, 16  # crosses 4096 at the 7th token
# the last decode step's f32 logits through B1 against the plain path's,
# relative to the largest: both compute in f32 (the same weights, the
# same tokens); the control, the same step without the cache rebuild
# (keys rotated by the short factors), must exceed it
LONGROPE_LOGITS_LIMIT = 1e-3
# allenai/OLMo-2-1124-7B's published widths (post-norms, the flat
# qk-norm, 32 heads of 128, untied)
OLMO2_7B = {
    "architectures": ["Olmo2ForCausalLM"], "model_type": "olmo2",
    "vocab_size": 100352, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 4096,
    "rope_theta": 500000, "rope_scaling": None, "rms_norm_eps": 1e-06,
    "attention_bias": False, "hidden_act": "silu",
    "tie_word_embeddings": False, "initializer_range": 0.02,
    "pad_token_id": 1, "bos_token_id": None, "eos_token_id": 100257,
    "torch_dtype": "float32",
}
# Command-R's widths, transformers' CohereConfig() defaults: the parallel
# block with one biasless LayerNorm, interleaved RoPE, logit_scale
# 0.0625, 64 heads of 128, a tied 256000-token vocabulary
COMMAND_R = {
    "architectures": ["CohereForCausalLM"], "model_type": "cohere",
    "vocab_size": 256000, "hidden_size": 8192, "intermediate_size": 22528,
    "num_hidden_layers": 40, "num_attention_heads": 64,
    "num_key_value_heads": 64, "max_position_embeddings": 8192,
    "rope_theta": 10000.0, "layer_norm_eps": 1e-05, "logit_scale": 0.0625,
    "use_qk_norm": False, "tie_word_embeddings": True, "hidden_act": "silu",
    "attention_bias": False, "initializer_range": 0.02,
    "pad_token_id": 0, "bos_token_id": 5, "eos_token_id": 255001,
    "torch_dtype": "bfloat16",
}
# depths: OLMo2 4 of 32 and Command-R 1 of 40, so that the f32 masters
# and AdamW state fit one card (Command-R's tied embedding alone is 2.1 B
# parameters: 33.5 GB of master and moments)
DENSE_LAYERS = {"olmo2": 2, "cohere": 1}
DENSE_STEPS = 4
# the trained families' rows: one 4096-token document each, so that
# Phi-3's 2047-key window masks
FAMILY_B, FAMILY_S = 1, 4096
YARN_LAYERS = 4
YARN_TIED_LAYERS = 2


def _phi3_kernel_phase(torch, args):
    """B1-B3 at Phi-3-mini's heads, 32 of 96 (MHA), against the plain
    versions: b 2, s 4096, causal packed documents with and without its
    2047-key window in bf16 (one ulp; both timed beside SDPA with a
    dense mask at d 96), f16 (two ulps) and f32 (1e-5), ALiBi and
    dropout in bf16, f16 and f32, and rows that see no key."""
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    slopes = 2.0 ** (-8.0 * torch.arange(1, 33, device="cuda",
                                         dtype=torch.float32) / 32)
    drop = dict(dropout_p=0.1, dropout_seed=96)
    win = (2046, -1)
    cases = {   # b, sq, sk, dtype, segments, causal, window, softcap, more
        "train": (2, 4096, 4096, bf, True, True, (-1, -1), 0.0, {}),
        "train_window": (2, 4096, 4096, bf, False, True, win, 0.0, {}),
        "f16": (2, 4096, 4096, f16, True, True, win, 0.0, {}),
        "f32": (1, 1024, 1024, f32, True, True, (300, -1), 0.0, {}),
        "alibi": (1, 4096, 4096, bf, True, True, (-1, -1), 0.0,
                  dict(alibi_slopes=slopes)),
        "dropout": (1, 4096, 4096, bf, True, True, win, 0.0, drop),
        "dropout_alibi_f16": (1, 2048, 2048, f16, True, True, (-1, -1),
                              0.0, dict(drop, alibi_slopes=slopes)),
        "dropout_alibi_f32": (1, 1024, 1024, f32, True, True, (-1, -1), 0.0,
                              dict(drop, alibi_slopes=slopes)),
        "sq_ne_sk_empty_rows": (1, 1536, 512, bf, False, True, (-1, -1),
                                0.0, {}),
    }
    return _flash_phase(torch, args, d=96, heads=PHI3_FLASH_HEADS,
                        cases=cases, timed=("train", "train_window"))


def _final_hidden(torch, model, cfg, batch, **fields):
    """The first batch's final-normed hidden (times ``logit_scale``)
    under ``cfg`` with ``fields`` replaced, without gradients."""
    import dataclasses
    from torchacc_tpu_torch.models.transformer import set_model_config
    set_model_config(model, dataclasses.replace(cfg, **fields))
    try:
        with torch.no_grad():
            return model(batch["input_ids"], batch["positions"],
                         batch["segment_ids"], return_hidden=True).float()
    finally:
        set_model_config(model, cfg)


def _dense_family_phase(torch, args, tag, published, layers, control,
                        expect, steps, seed, on_hidden=False, lean=False,
                        capacity_factor=None):
    """``published``'s config.json at ``layers`` with seeded bf16 weights
    in its HF names, through accelerate(path) -> Trainer.fit on rows of
    one FAMILY_S-token document: the first batch's loss through
    B1-B3 against the plain attention's, and ``control`` (fields that
    undo the family's feature) above the limit; the losses, step time,
    MFU, peak memory and launches; generate() through B1.  With
    ``on_hidden`` (Command-R: its logit_scale leaves the random model's
    loss within 1e-4 of ln(vocab) whatever the attention does) the
    control is held on the final hidden instead: through B1 within
    _logits_limit of the plain attention's, the control above it.  With
    ``lean`` (Command-R: its 2.1 B-parameter tied embedding) the run
    keeps no bf16 shadow and clips no gradient: the f32 masters, moments
    and gradients of 2.92 B parameters (52.5 GB) and AdamW's two
    temporaries the size of the embedding (15.6 GB) then fit the card,
    where the shadow and the clip's scaled copy did not (an H100 run ran
    out of memory in the update).  ``capacity_factor`` (a mixture of
    experts) is ``dist.ep.capacity_factor``, which accelerate() folds
    into the model; the MFU then counts the FLOPs the experts compute
    (``_moe_flops``)."""
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    DistConfig, EPConfig, MemoryConfig,
                                    PackedDataset, accelerate)
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_linear

    full = published["num_hidden_layers"]
    v = published["vocab_size"]
    rows, seq = FAMILY_B, FAMILY_S
    est = 2 * sum(math.prod(shape) for shape in _hf_tensors(
        dict(published, num_hidden_layers=layers), layers).values())
    root = _hf_root(est)
    try:
        t0 = time.perf_counter()
        _, nbytes = _write_hf_checkpoint(torch, root, seed, layers,
                                         published)
        print(f"{tag}: wrote its config.json at {layers} of {full} layers "
              f"(full width) and {nbytes} bytes of bf16 safetensors to "
              f"{root} in {time.perf_counter() - t0:.1f} s", flush=True)
        conf = Config(compute=ComputeConfig(bf16_compute_params=not lean),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                      data=DataConfig(max_length=seq, prefetch=2),
                      dist=DistConfig(ep=EPConfig(
                          capacity_factor=capacity_factor)),
                      seed=args.seed)
        docs = _zipf_docs(seed + 1, (steps + 1) * rows * seq, v, lo=seq,
                          hi=seq + 1)
        first = next(iter(PackedDataset(docs, seq_len=seq, batch_rows=rows)))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        trainer, loader = accelerate(
            root, PackedDataset(docs, seq_len=seq, batch_rows=rows), conf,
            optimizer=adamw(warmup_linear(2e-5, steps, 1),
                            grad_clip_norm=None if lean else 1.0))
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = trainer.model.cfg
    got_fields = {k: getattr(cfg, k) for k in expect}
    if got_fields != expect:
        _fail(f"{tag}: config_from_hf gave {got_fields}, expected {expect}")
    n_params = cfg.num_params()
    if n_params != sum(p.numel() for p in trainer.state.params.values()):
        _fail(f"{tag}: num_params {n_params} is not the model's count")
    print(f"{tag}: accelerate(path) in {load_s:.1f} s "
          f"({nbytes / load_s / 1e9:.2f} GB/s of checkpoint), {n_params} "
          f"params", flush=True)
    batch = {k: torch.as_tensor(x).cuda() for k, x in first.items()}
    labels = shift_labels(batch["input_ids"], batch["segment_ids"])
    model = trainer.model
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    got = _first_loss(torch, model, batch, labels, cfg,
                      attention_impl="cuda")
    if fa.launch_counts["fwd"] != layers:
        _fail(f"{tag}: the check's forward launched B1 "
              f"{fa.launch_counts['fwd']} times, not {layers}")
    ref = _first_loss(torch, model, batch, labels, cfg,
                      attention_impl="torch")
    ctrl = _first_loss(torch, model, batch, labels, cfg,
                       attention_impl="torch", **control)
    rel, rel_control = abs(got - ref) / abs(ref), abs(ctrl - ref) / abs(ref)
    print(f"{tag} check: first-batch loss through B1 at d {cfg.head_size} "
          f"{got:.6f}, plain attention {ref:.6f}, relative {rel:.3g} (limit "
          f"{LN_LOSS_LIMIT:.3g}); control, plain with {control}, "
          f"{ctrl:.6f} (relative {rel_control:.3g}"
          f"{'' if on_hidden else ', must exceed the limit'})", flush=True)
    if not math.isfinite(got) or rel > LN_LOSS_LIMIT:
        _fail(f"{tag}: the first-batch loss through the kernels parts from "
              f"the plain attention's by {rel:.3g} > {LN_LOSS_LIMIT:.3g}")
    if on_hidden:
        ref_h = _final_hidden(torch, model, cfg, batch,
                              attention_impl="torch")
        rel_h = lambda h: ((h - ref_h).abs().max()
                           / ref_h.abs().max()).item()
        got_h = rel_h(_final_hidden(torch, model, cfg, batch,
                                    attention_impl="cuda"))
        rel_control = rel_h(_final_hidden(torch, model, cfg, batch,
                                          attention_impl="torch", **control))
        limit = _logits_limit(layers)
        del ref_h
        print(f"{tag} check: the first batch's final hidden through B1 "
              f"against the plain attention's, relative {got_h:.3g} (limit "
              f"{limit:.3g}); control, plain with {control}, "
              f"{rel_control:.3g} (must exceed it)", flush=True)
        if not math.isfinite(got_h) or got_h > limit:
            _fail(f"{tag}: the final hidden through the kernels parts from "
                  f"the plain attention's by {got_h:.3g} > {limit:.3g}")
        if rel_control <= limit:
            _fail(f"{tag}: the control {control} stays within {limit:.3g}")
    elif rel_control <= LN_LOSS_LIMIT:
        _fail(f"{tag}: the control {control} stays within "
              f"{LN_LOSS_LIMIT:.3g}")
    res = _ln_fit(torch, tag, trainer, loader, layers, steps, rows, seq,
                  n_params, _moe_flops(cfg, rows * seq, seq)
                  if cfg.num_experts else None)
    res.update(check_rel=rel, control_rel=rel_control, first_loss=got,
               first_loss_plain=ref)
    del loader
    prompts = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, v, (2, 256))).cuda()
    res["generate"] = _generate_check(torch, tag, model, cfg, prompts, 8)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _phi3_phase(torch, args):
    """Phi-3-mini-4k-instruct at full width and --phi3-layers (its 32)
    with seeded bf16 weights in its packed qkv_proj/gate_up_proj layout,
    streamed by accelerate(path) into the trainer: the first batch's loss
    through B1 at d 96 (the 2047-key window on rows of one 4096-token
    document) against the plain attention's, with the window-lifted
    control; B1/B2/B3 launch layers x steps; generate() through B1."""
    return _dense_family_phase(
        torch, args, "phi-3-mini", PHI3_MINI, args.phi3_layers,
        dict(window=(-1, -1)),
        dict(head_size=96, window=(2046, -1), num_layers=args.phi3_layers),
        PHI3_STEPS, args.seed + 91)


def _phi35_config(torch, seed):
    """Phi-3.5-mini-instruct's ModelConfig through config_from_hf, its
    two 48-entry longrope factor lists drawn from ``seed`` (short
    1.0-3.0, long 1.0-64.0, each rising with the dim, as the published
    lists do)."""
    import types
    import numpy as np
    from torchacc_tpu_torch.models.hf import config_from_hf
    rng = np.random.default_rng(seed)
    short = np.sort(rng.uniform(1.0, 3.0, 48)).tolist()
    long = np.sort(np.exp(rng.uniform(0.0, math.log(64.0), 48))).tolist()
    hf = dict(PHI35_MINI, rope_scaling={"type": "longrope",
                                        "short_factor": short,
                                        "long_factor": long})
    return config_from_hf(types.SimpleNamespace(**hf), dtype=torch.bfloat16)


def _longrope_phase(torch, args):
    """Phi-3.5-mini at full width and --phi3-layers from init_params(seed),
    bf16:
    generate() from a 4090-token prompt for 16 new tokens crosses the
    original 4096 at the 7th, where the cache is rebuilt under the long
    factors (a prefill of 4097 tokens from position 0, seen by a tap).
    B1 launches layers x 16 in bf16; in f32 compute the tokens through
    B1 equal the plain path's and the last step's logits lie within
    LONGROPE_LOGITS_LIMIT of them, while the control (the same tokens
    decoded without the rebuild, the prefix's keys left on the short
    factors) must not."""
    import dataclasses
    import importlib
    import numpy as np
    import torchacc_tpu_torch.models.transformer as tr
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import init_params
    from torchacc_tpu_torch.models.transformer import set_model_config
    gen = importlib.import_module("torchacc_tpu_torch.models.generate")

    tag = "phi-3.5 longrope"
    cfg = dataclasses.replace(_phi35_config(torch, args.seed + 95),
                              num_layers=args.phi3_layers)
    if cfg.rope_longrope is None or cfg.rope_longrope[2] != 4096.0:
        _fail(f"{tag}: config_from_hf gave rope_longrope "
              f"{cfg.rope_longrope}")
    model = init_params(cfg, seed=args.seed + 96, device="cuda",
                        dtype=torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(args.seed + 97).integers(
        0, cfg.vocab_size, (1, LONGROPE_PROMPT))).cuda()
    p, n = LONGROPE_PROMPT, LONGROPE_NEW
    calls, last = [], {}
    real_fwd, real_head = gen._cached_forward, tr.head_logits

    def fwd(m, ids, start, *a):
        calls.append((start, ids.shape[1]))
        return real_fwd(m, ids, start, *a)

    def head(*a, **kw):
        last["logits"] = real_head(*a, **kw)
        return last["logits"]
    gen._cached_forward, tr.head_logits = fwd, head
    out, logits = {}, {}
    try:
        for key in fa.launch_counts:          # counts start here ...
            fa.launch_counts[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["bf16"] = gen.generate(model, prompt, max_new_tokens=n,
                                   attention_impl="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fa.launch_counts)     # ... and are read here
        rebuilt = (0, 4097) in calls
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        set_model_config(model, f32)
        for impl in ("cuda", "torch"):
            out[impl] = gen.generate(model, prompt, max_new_tokens=n,
                                     attention_impl=impl)
            logits[impl] = last["logits"][:, 0].float()
    finally:
        gen._cached_forward, tr.head_logits = real_fwd, real_head
    # the control: the same tokens decoded on one cache, no rebuild
    toks = out["torch"]
    with torch.no_grad():
        cache = gen.KVCache(f32, range(cfg.num_layers), 1, p + n, "cuda")
        pos = torch.arange(p + n, device="cuda")[None]
        x = real_fwd(model, toks[:, :p], 0, cache, "torch", pos[:, :p])
        for j in range(p, p + n - 1):
            x = real_fwd(model, toks[:, j:j + 1], j, cache, "torch",
                         pos[:, j:j + 1])
        control = real_head(f32, model, x[:, -1:])[:, 0].float()
    set_model_config(model, cfg)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    r, rc = rel(logits["cuda"], logits["torch"]), rel(control,
                                                      logits["torch"])
    want = {"fwd": cfg.num_layers * n, "bwd_dq": 0, "bwd_dkv": 0}
    print(f"{tag}: generate() of {n} tokens after {p} in {ms:.1f} ms bf16 "
          f"through B1 (launches {launches}, expected {want}); forward "
          f"calls (start, tokens) {calls[:3]} ... {calls[-3:]}: the rebuild "
          f"at the crossing {'fired' if rebuilt else 'did NOT fire'}; f32 "
          f"tokens through B1 {'equal' if torch.equal(out['cuda'], toks) else 'differ from'} "
          f"the plain path's; last step's logits relative {r:.3g} (limit "
          f"{LONGROPE_LOGITS_LIMIT:.3g}); control without the rebuild "
          f"{rc:.3g} (must exceed it)", flush=True)
    if launches != want:
        _fail(f"{tag}: launches {launches} != {want}")
    if not rebuilt:
        _fail(f"{tag}: no prefill of 4097 tokens from position 0")
    if not torch.equal(out["cuda"], toks):
        _fail(f"{tag}: f32 tokens through B1 differ from the plain path's")
    if not math.isfinite(r) or r > LONGROPE_LOGITS_LIMIT:
        _fail(f"{tag}: last-step logits part by {r:.3g}")
    if rc <= LONGROPE_LOGITS_LIMIT:
        _fail(f"{tag}: the no-rebuild control stays within the limit")
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "logits_rel": r,
            "control_rel": rc, "layers": cfg.num_layers}


def _yarn_serving_phase(torch, args, pa):
    """Phase 6's llama3-8b at full width and YARN_LAYERS deep with a yarn
    rope_scaling (factor 4 over an original 8192), bf16 from
    init_params(seed), served through ServeEngine: B4 launches layers x
    dispatches, and the last-prompt logits lie within _logits_limit of
    the plain path while two controls do not (yarn lifted; the wrong
    GQA map).  As in the Gemma serving phase, the first
    YARN_TIED_LAYERS layers' q projections are their kv heads', so that
    rows attend peakily and the rope's scaling shows."""
    import dataclasses
    import numpy as np
    from torchacc_tpu_torch import (Config, Request, ServeConfig, ServeEngine,
                                    get_preset, init_params)
    from torchacc_tpu_torch.models.transformer import set_model_config

    tag, max_new = "yarn serving", 16
    cfg = get_preset("llama3-8b", dtype=torch.bfloat16,
                     num_layers=YARN_LAYERS,
                     rope_yarn=(4.0, 8192.0, 32.0, 1.0, None, True))
    model = init_params(cfg, seed=args.seed + 81, device="cuda",
                        dtype=torch.bfloat16)
    group = cfg.num_heads // cfg.kv_heads
    for layer in model.layers[:YARN_TIED_LAYERS]:
        wk = layer.attn.k_proj.weight
        layer.attn.q_proj.weight.copy_(wk.view(cfg.kv_heads, -1, wk.shape[1])
                                       .repeat_interleave(group, dim=0)
                                       .reshape_as(layer.attn.q_proj.weight))
    rng = np.random.default_rng(args.seed + 82)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (64, 300, 700, 1000)]
    eng = ServeEngine(model, Config(serve=ServeConfig(
        block_size=BS, num_blocks=1024, max_slots=8, prefill_chunk=256,
        decode_depth=2)))
    eng.generate([Request(prompt_ids=prompts[0][:32], max_new_tokens=2)])
    eng.reset_stats()
    sched = eng.scheduler
    dec0, pre0 = sched.decode_dispatches, sched.prefill_dispatches
    for shape in pa.launch_counts:           # counts start here ...
        pa.launch_counts[shape] = 0
    res = eng.generate([Request(prompt_ids=p, max_new_tokens=max_new)
                        for p in prompts])
    torch.cuda.synchronize()
    launches = dict(pa.launch_counts)        # ... and are read here
    dispatches = {"decode": sched.decode_dispatches - dec0,
                  "prefill": sched.prefill_dispatches - pre0}
    stats = eng.stats()
    eng.close()
    for shape, n in dispatches.items():
        if n == 0 or launches[shape] != cfg.num_layers * n:
            _fail(f"{tag}: {shape} launches {launches[shape]} != layers "
                  f"{cfg.num_layers} x dispatches {n}")
    if any(len(r.tokens) != max_new for r in res):
        _fail(f"{tag}: streams of {[len(r.tokens) for r in res]} tokens")
    ref = _prompt_logits(torch, model, cfg, prompts, "torch")
    rel = {}
    for name in ("kernel", "yarn_lifted", "wrong_gqa"):
        if name == "yarn_lifted":
            set_model_config(model, dataclasses.replace(cfg, rope_yarn=None))
        try:
            got = _prompt_logits(torch, model, cfg, prompts,
                                 "cuda" if name == "kernel" else "torch",
                                 _wrong_gqa if name == "wrong_gqa" else None)
        finally:
            set_model_config(model, cfg)
        if not all(torch.isfinite(a).all() for a in got):
            _fail(f"{tag}: non-finite logits ({name})")
        rel[name] = [((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref)]
    limit = _logits_limit(cfg.num_layers)
    print(f"{tag}: llama3-8b x{cfg.num_layers} with yarn (factor 4, "
          f"original 8192), {len(prompts)} greedy requests in bf16: "
          f"{stats['tokens_per_sec']:.1f} tokens/s; B4 launches {launches} "
          f"= {cfg.num_layers} x {dispatches}; last-prompt logits vs plain "
          f"attention: kernel {_fmt(rel['kernel'])} (limit {limit:.3g}), "
          f"controls yarn_lifted {_fmt(rel['yarn_lifted'])}, wrong_gqa "
          f"{_fmt(rel['wrong_gqa'])}", flush=True)
    if max(rel["kernel"]) > limit:
        _fail(f"{tag}: logits through B4 part from the plain path by "
              f"{max(rel['kernel']):.3g} > {limit:.3g}")
    for name in ("yarn_lifted", "wrong_gqa"):
        if max(rel[name]) <= limit:
            _fail(f"{tag}: the {name} control stays within {limit:.3g}")
    del eng, model
    torch.cuda.empty_cache()
    return {"launches": launches, "dispatches": dispatches,
            "logits_rel": rel["kernel"]}


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

CKPT_ROOT = "chip_smoke_ckpt"           # under the checkout; git-ignored


# Qwen/Qwen3-30B-A3B's published config.json (128 experts of 768, top-8
# with norm_topk_prob, 32/4 heads of 128 with per-head q/k norms)
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
    "moe_intermediate_size": 768, "num_hidden_layers": 48,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [],
    "router_aux_loss_coef": 0.001, "output_router_logits": False,
    "max_position_embeddings": 40960, "max_window_layers": 48,
    "rope_theta": 1000000.0, "rope_scaling": None, "rms_norm_eps": 1e-06,
    "sliding_window": None, "use_sliding_window": False,
    "hidden_act": "silu", "attention_bias": False, "attention_dropout": 0.0,
    "tie_word_embeddings": False, "initializer_range": 0.02,
    "bos_token_id": 151643, "eos_token_id": 151645,
    "torch_dtype": "bfloat16",
}
MOE_STEPS = 4
MOE_CF = 1.25                           # ep.capacity_factor of the phases
MIXTRAL_B, MIXTRAL_S = 2, 4096          # 2 x 4096 packed tokens a step
# Mixtral's control: the top expert alone at its full-softmax weight (the
# renormalisation lifted alone moved the random 2-layer model's first
# loss by 1.45e-4 of it, an H100 run: too near the 1e-4 limit)
MIXTRAL_CONTROL = dict(moe_renorm_topk=False, num_experts_per_tok=1)


def _moe_flops(cfg, tokens, seq):
    """The FLOPs a training step of a mixture of experts computes over
    ``tokens`` (rows of ``seq``): 6 x tokens x the parameters outside the
    experts, plus 6 x L x 3hf for every row an expert multiplies, plus
    the attention's 6 x L x heads x d x seq a token.  The rows are
    tokens x e under dense dispatch (every token through every expert)
    and e x cap under capacity dispatch (every slot, empty or not; cap
    of the step's tokens, models/moe.py ``capacity``)."""
    from torchacc_tpu_torch.models.moe import capacity
    L, e = cfg.num_layers, cfg.num_experts
    expert = 3 * cfg.hidden_size * cfg.ffn_size
    other = cfg.num_params() - L * e * expert
    rows = (tokens * e if cfg.moe_capacity_factor is None
            else e * capacity(cfg, tokens))
    attn = 6.0 * L * cfg.num_heads * cfg.head_size * seq * tokens
    return 6.0 * other * tokens + 6.0 * L * expert * rows + attn


def _mixtral_phase(torch, args):
    """mixtral-8x7b's widths (hidden 4096, 8 experts of 14336, top-2,
    32/8 heads of 128) at --mixtral-layers through accelerate(ModelConfig,
    PackedDataset) -> Trainer.fit over 2 x 4096 packed tokens a step,
    once with dense dispatch (the first batch's loss through B1 against
    the plain attention's, MIXTRAL_CONTROL as the control) and once
    with ep.capacity_factor 1.25; B1/B2/B3 launch
    layers x steps in each; the FLOPs each step computes
    (``_moe_flops``); then 8 greedy tokens of generate() through B1
    against the plain attention (capacity dispatch, the cap of each
    call's tokens)."""
    import dataclasses
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    DistConfig, EPConfig, MemoryConfig,
                                    PackedDataset, accelerate)
    from torchacc_tpu_torch.models import get_preset
    from torchacc_tpu_torch.train import adamw, shift_labels, warmup_linear

    tag, layers, steps = "mixtral", args.mixtral_layers, MOE_STEPS
    rows, seq = MIXTRAL_B, MIXTRAL_S
    mc = get_preset("mixtral-8x7b", num_layers=layers)
    v = mc.vocab_size
    docs = _zipf_docs(args.seed + 121, (steps + 1) * rows * seq, v)
    first = next(iter(PackedDataset(docs, seq_len=seq, batch_rows=rows)))
    out = {}
    for run, cf in (("dense", None), ("capacity", MOE_CF)):
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                      data=DataConfig(max_length=seq, prefetch=2),
                      dist=DistConfig(ep=EPConfig(capacity_factor=cf)),
                      seed=args.seed)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        trainer, loader = accelerate(
            mc, PackedDataset(docs, seq_len=seq, batch_rows=rows), conf,
            optimizer=adamw(warmup_linear(2e-5, steps, 1)))
        trainer.init()
        init_s = time.perf_counter() - t0
        cfg = trainer.model.cfg
        n_params = cfg.num_params()
        if (cfg.moe_capacity_factor != cf or n_params != sum(
                p.numel() for p in trainer.state.params.values())):
            _fail(f"{tag}[{run}]: capacity factor {cfg.moe_capacity_factor} "
                  f"(want {cf}), num_params {n_params}")
        print(f"{tag}[{run}]: {layers} of 32 layers at full width, "
              f"{n_params} params ({layers} x "
              f"{(n_params - 2 * v * cfg.hidden_size) // layers} a layer), "
              f"made and sharded in {init_s:.1f} s", flush=True)
        if run == "dense":
            batch = {k: torch.as_tensor(x).cuda() for k, x in first.items()}
            labels = shift_labels(batch["input_ids"], batch["segment_ids"])
            model = trainer.model
            for key in fa.launch_counts:
                fa.launch_counts[key] = 0
            got = _first_loss(torch, model, batch, labels, cfg,
                              attention_impl="cuda")
            if fa.launch_counts["fwd"] != layers:
                _fail(f"{tag}: the check's forward launched B1 "
                      f"{fa.launch_counts['fwd']} times, not {layers}")
            ref = _first_loss(torch, model, batch, labels, cfg,
                              attention_impl="torch")
            ctrl = _first_loss(torch, model, batch, labels, cfg,
                               attention_impl="torch", **MIXTRAL_CONTROL)
            rel, rel_c = abs(got - ref) / abs(ref), abs(ctrl - ref) / abs(ref)
            print(f"{tag} check: first-batch loss through B1 at d 128 "
                  f"{got:.6f}, plain attention {ref:.6f}, relative "
                  f"{rel:.3g} (limit {LN_LOSS_LIMIT:.3g}); control, plain "
                  f"with {MIXTRAL_CONTROL}, {ctrl:.6f} (relative "
                  f"{rel_c:.3g}, must exceed the limit)",
                  flush=True)
            if not math.isfinite(got) or rel > LN_LOSS_LIMIT:
                _fail(f"{tag}: the first-batch loss through the kernels "
                      f"parts from the plain attention's by {rel:.3g}")
            if rel_c <= LN_LOSS_LIMIT:
                _fail(f"{tag}: the control {MIXTRAL_CONTROL} stays within "
                      f"{LN_LOSS_LIMIT:.3g}")
            del model
        flops = _moe_flops(cfg, rows * seq, seq)
        res = _ln_fit(torch, f"{tag}[{run}]", trainer, loader, layers, steps,
                      rows, seq, n_params, flops)
        print(f"{tag}[{run}]: {flops:.6g} FLOPs a step (6 x tokens x the "
              f"{n_params - layers * 8 * 3 * cfg.hidden_size * cfg.ffn_size}"
              f" parameters outside the experts + 6 x L x 3hf x "
              f"{'tokens x e' if cf is None else 'e x cap'} rows + "
              f"6 x L x heads x d x s a token)", flush=True)
        del loader
        if run == "capacity":
            prompts = torch.from_numpy(np.random.default_rng(
                args.seed + 122).integers(0, v, (2, 256))).cuda()
            res["generate"] = _generate_check(torch, tag, trainer.model,
                                              cfg, prompts, 8)
        out[run] = res
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    dense, cap = out["dense"], out["capacity"]
    print(f"{tag}: dense dispatch {dense['step_ms']:.1f} ms a step "
          f"({dense['flops'] / dense['step_ms'] / 1e9:.1f} TFLOP/s), "
          f"capacity 1.25 {cap['step_ms']:.1f} ms "
          f"({cap['flops'] / cap['step_ms'] / 1e9:.1f} TFLOP/s); peak "
          f"{dense['peak_bytes'] / 2**30:.2f} and "
          f"{cap['peak_bytes'] / 2**30:.2f} GiB at {layers} layers",
          flush=True)
    return out


def _qwen3_moe_phase(torch, args):
    """Qwen/Qwen3-30B-A3B's config.json (128 experts, top-8 with
    norm_topk_prob, per-head q/k norms, vocab 151936) at
    --qwen3-moe-layers with seeded bf16 weights in its HF names (each
    expert a tensor), streamed by accelerate(path) into the trainer with
    ep.capacity_factor 1.25 (capacity dispatch; 'auto' picks JAX's sort
    mechanism at this size): the first batch's loss through B1 within
    1e-4 of the plain attention's, the top-k renormalisation lifted as
    the control above it;
    B1/B2/B3 launch layers x steps; the FLOPs a step
    (``_moe_flops``); generate() through B1."""
    from torchacc_tpu_torch.models.moe import capacity, dispatch_mechanism
    layers = args.qwen3_moe_layers
    res = _dense_family_phase(
        torch, args, "qwen3-30b-a3b", QWEN3_30B_A3B, layers,
        dict(moe_renorm_topk=False),
        dict(head_size=128, num_experts=128, num_experts_per_tok=8,
             moe_renorm_topk=True, moe_capacity_factor=MOE_CF,
             qk_norm=True, num_layers=layers, intermediate_size=768),
        MOE_STEPS, args.seed + 131, capacity_factor=MOE_CF)
    from torchacc_tpu_torch.models.hf import config_from_hf
    import types
    cfg = config_from_hf(types.SimpleNamespace(**dict(
        QWEN3_30B_A3B, num_hidden_layers=layers)), moe_capacity_factor=MOE_CF)
    n = FAMILY_B * FAMILY_S
    cap = capacity(cfg, n)
    mech = dispatch_mechanism(cfg, n, cap)
    print(f"qwen3-30b-a3b: capacity dispatch over {n} tokens, cap {cap} a "
          f"expert, 'auto' picks {mech!r} (n x e x cap = "
          f"{n * cfg.num_experts * cap} against 2^24); {res['flops']:.6g} "
          f"FLOPs a step (_moe_flops: e x cap rows)", flush=True)
    if mech != "sort":
        _fail(f"qwen3-30b-a3b: 'auto' picked {mech!r}, not 'sort'")
    res["cap"] = cap
    return res


def _ckpt_root():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CKPT_ROOT)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _mem_available():
    """The host memory available (bytes), from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def _state_digest(torch, state):
    """(step, AdamW count, a bitwise digest of every other leaf of the
    checkpointed state: the sum of each tensor's 32-bit words)."""
    from torchacc_tpu_torch.ops._common import to_local
    from torchacc_tpu_torch.train.state import flat_state
    flat = flat_state(state)
    step, count = int(flat.pop("step")), int(flat.pop("opt_state/count"))
    return step, count, _digest(torch, [to_local(t) for t in flat.values()])


def _same_state(a, b):
    return a[:2] == b[:2] and bool((a[2] == b[2]).all())


def _ckpt_config(seed, data=True, dist_cfg=None):
    """Phase 8b's configuration (``data``) or phase 7's, seeded."""
    from torchacc_tpu_torch import (ComputeConfig, Config, DataConfig,
                                    MemoryConfig)
    kw = dict(data=DataConfig(max_length=TRAIN_S, prefetch=2),
              grad_accum=2) if data else {}
    if dist_cfg is not None:
        kw["dist"] = dist_cfg
    return Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  seed=seed, **kw)


class _SaveTap:
    """While entered, wraps ``CheckpointManager.save``: for each call that
    writes, the step, the host ms of the call and the device memory
    allocated by it."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from torchacc_tpu_torch.checkpoint import io
        self.io, self.orig = io, io.CheckpointManager.save
        torch, tap = self.torch, self

        def save(mgr, step, state, **kw):
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            wrote = tap.orig(mgr, step, state, **kw)
            if wrote:
                tap.calls.append((step, (time.perf_counter() - t0) * 1e3,
                                  torch.cuda.memory_allocated() - before))
            return wrote
        io.CheckpointManager.save = save
        return self

    def __exit__(self, *exc):
        self.io.CheckpointManager.save = self.orig


class _CrashStep:
    """While entered, the checkpoint write of ``step`` dies after part of
    its payload is on disk, as a process killed while writing it would:
    the step stays unmarked, and with no step directory."""

    def __init__(self, step):
        self.step = step

    def __enter__(self):
        from torchacc_tpu_torch.checkpoint import io
        self.io, self.orig = io, io._write
        tmp = f"{self.step}{io.TMP_SUFFIX}"

        def write(host, path, group):
            if os.path.basename(os.path.dirname(path)) == tmp:
                os.makedirs(path, exist_ok=True)
                with open(os.path.join(path, "__0_0.distcp"), "wb") as f:
                    f.write(b"part of a payload")
                raise OSError(f"injected: the writer of {path} died")
            return self.orig(host, path, group)
        io._write = write
        return self

    def __exit__(self, *exc):
        self.io._write = self.orig


def _marked(root):
    from torchacc_tpu_torch.checkpoint.io import MANIFEST
    return sorted(int(n) for n in os.listdir(root) if n.isdigit()
                  and os.path.exists(os.path.join(root, n, MANIFEST)))


def _checkpoint_phase(torch, args, root):
    """Checkpoints and resume on the data-fed path: run A saves through
    fit(checkpoint_dir, checkpoint_every=6) for 6 steps (step 1, the
    empty directory's first save, and step 6, whose write dies,
    injected); run B, made from another seed, resumes with
    resume='auto', must take run A's batches and losses at steps 1-5
    bitwise, and saves and marks step 6; two controls (the bf16 shadow
    not made again, the loader not repositioned) must part from them."""
    import shutil
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (PackedDataset, TransformerLM,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.checkpoint.io import PAYLOAD, TMP_SUFFIX
    from torchacc_tpu_torch.data import AsyncLoader
    from torchacc_tpu_torch.errors import CheckpointError
    from torchacc_tpu_torch.train import adamw, warmup_cosine
    from torchacc_tpu_torch.utils.metrics import counters

    tag = "checkpoint"
    layers, steps, rows = args.ckpt_layers, 6, 4
    cfg = get_preset("llama3-8b", num_layers=layers)
    n_params = sum(p.numel() for p in
                   TransformerLM(cfg, device="meta").parameters())
    ckpt_bytes = 12 * n_params          # f32 masters, mu and nu
    free, ram = shutil.disk_usage(root).free, _mem_available()
    print(f"{tag}: {layers} layers at full width, {n_params / 1e9:.3f}B "
          f"params: {ckpt_bytes} bytes a checkpoint, 3 written in all "
          f"(run A's step 1, run B's step 6, the mesh trainer's); free disk "
          f"{free} bytes at {root}, host memory available {ram} bytes; "
          f"card: {_card()}", flush=True)
    if free < 3.2 * ckpt_bytes:
        _fail(f"{tag}: 3 checkpoints of {ckpt_bytes} bytes need "
              f"{int(3.2 * ckpt_bytes)} bytes of disk with room; {free} "
              f"are free at {root} (pass a smaller --ckpt-layers)")
    if ram < 1.5 * ckpt_bytes:
        _fail(f"{tag}: staging a checkpoint of {ckpt_bytes} bytes needs "
              f"{int(1.5 * ckpt_bytes)} bytes of host memory with room; "
              f"{ram} are available (pass a smaller --ckpt-layers)")
    docs = _zipf_docs(args.seed + 9, (steps + 2) * rows * TRAIN_S,
                      cfg.vocab_size)
    make = lambda: PackedDataset(docs, seq_len=TRAIN_S, batch_rows=rows)
    opt = lambda: adamw(warmup_cosine(3e-4, steps, warmup_steps=1))
    fit_kw = dict(log_every=0, checkpoint_dir=root, checkpoint_every=steps)
    keep = lambda into: (lambda i, b: into.append(
        {k: v.clone() for k, v in b.items()}))

    def payload_bytes(step):
        n = _dir_bytes(os.path.join(root, str(step), PAYLOAD))
        if not ckpt_bytes <= n <= 1.01 * ckpt_bytes + 2**20:
            _fail(f"{tag}: step {step}'s payload holds {n} bytes, not the "
                  f"state's {ckpt_bytes} (and DCP's metadata)")
        return n

    # run A: 6 steps; saves at 1 (the empty directory's first) and 6,
    # whose writer dies: the close reports it, and step 6 stays unmarked
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = _ckpt_config(args.seed)
    conf.resilience.ckpt_retries = 0    # the injected death is final
    trainer, loader = accelerate(cfg, make(), conf, optimizer=opt())
    trainer.init()
    got_a = []
    tap = _StepTap(torch, trainer, before=keep(got_a))
    crashed = None
    with _SaveTap(torch) as saves, _CrashStep(steps):
        try:
            trainer.fit(loader, max_steps=steps, **fit_kw)
        except CheckpointError as e:
            crashed = e
    step_ms, _ = tap.finish(1)
    losses_a = [m["loss"].item() for m in tap.metrics]
    peak_a = torch.cuda.max_memory_allocated()
    marked = _marked(root)
    left = sorted(os.listdir(root))
    del trainer, loader, tap
    gc.collect()
    torch.cuda.empty_cache()
    plain = step_ms[1:steps - 1]
    stall = step_ms[steps - 1] - sum(plain) / len(plain)
    print(f"{tag}[run A]: losses {_fmt(losses_a)}; marked steps {marked}, "
          f"in the directory {left}; step 6's write died: {crashed!r}; "
          f"step ms {_fmt(step_ms)} (saves after steps 0 and 5); the save "
          f"step 5 {step_ms[steps - 1]:.1f} ms against the plain steps' "
          f"{sum(plain) / len(plain):.1f}: stall {stall:.1f} ms; save() "
          f"host ms and device bytes added "
          f"{[(s, round(ms, 1), b) for s, ms, b in saves.calls]}; peak "
          f"allocated {peak_a / 2**30:.2f} GiB", flush=True)
    if crashed is None or "[6]" not in str(crashed):
        _fail(f"{tag}[run A]: the injected death of step 6's write did not "
              f"surface at the close: {crashed!r}")
    if marked != [1] or len(got_a) != steps or str(steps) in left \
            or f"{steps}{TMP_SUFFIX}" not in left:
        _fail(f"{tag}[run A]: marked steps {marked} != [1], {len(got_a)} "
              f"batches != {steps}, or not only the dead write's "
              f"leftovers for step 6: {left}")
    written = payload_bytes(1)

    # run B: a new trainer from another seed.  First control 1 on it: the
    # resume with the bf16 shadow not made again reads its own seed's
    # weights at step 1
    replayed = counters.get("resume_replayed_batches")
    trainer, loader = accelerate(cfg, make(), _ckpt_config(args.seed + 1),
                                 optimizer=opt())
    trainer.init()
    trainer._after_restore = lambda: None
    got_c = []
    tap = _StepTap(torch, trainer, before=keep(got_c))
    trainer.fit(AsyncLoader(make(), _ckpt_config(args.seed),
                            device=trainer.device),
                max_steps=2, resume="auto", **fit_kw)
    tap.finish(0)
    stale = tap.metrics[0]["loss"].item()
    del trainer._after_restore
    # run B proper: resumes from step 1 past the dead step 6 and saves it
    restore_s = []
    inner = trainer._resume

    def timed(mgr):
        t0 = time.perf_counter()
        out = inner(mgr)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        return out
    trainer._resume = timed
    got_b = []
    tap = _StepTap(torch, trainer, before=keep(got_b))
    for key in fa.launch_counts:                 # counts start here ...
        fa.launch_counts[key] = 0
    with _SaveTap(torch) as saves_b:
        trainer.fit(loader, max_steps=steps, resume="auto", **fit_kw)
    launches = dict(fa.launch_counts)            # ... and are read here
    del trainer._resume
    tap.finish(0)
    losses_b = [m["loss"].item() for m in tap.metrics]
    digest = _state_digest(torch, trainer.state)     # the state saved as 6
    marked, left = _marked(root), sorted(os.listdir(root))
    batches_same = len(got_b) == steps - 1 and all(
        torch.equal(got_b[i][k], got_a[1 + i][k])
        for i in range(len(got_b)) for k in got_a[1 + i])
    print(f"{tag}[run B]: resumed from step "
          f"{trainer.state.step - len(got_b)} in {restore_s[0] * 1e3:.1f} "
          f"ms ({written / restore_s[0] / 1e9:.2f} GB/s; the read into host "
          f"buffers and the copy to the card); losses at steps 1-5 "
          f"{_fmt(losses_b)} against run A's {_fmt(losses_a[1:])}; "
          f"batches bitwise {batches_same}; flash launches {launches}; "
          f"saved {[s for s, _, _ in saves_b.calls]}, marked steps "
          f"{marked}, in the directory {left}", flush=True)
    if trainer.state.step != steps or losses_b != losses_a[1:] \
            or not batches_same:
        _fail(f"{tag}[run B]: the resumed run is not run A's: losses "
              f"{losses_b} against {losses_a[1:]}, batches bitwise "
              f"{batches_same}, step {trainer.state.step}")
    if counters.get("resume_replayed_batches") != replayed:
        _fail(f"{tag}[run B]: the loader was replayed, not restored from "
              f"loader_state.json")
    for key, n in launches.items():
        if n != layers * (steps - 1) * 2:
            _fail(f"{tag}[run B]: flash {key} launches {n} != layers "
                  f"{layers} x steps {steps - 1} x 2 micro-batches")
    if [s for s, _, _ in saves_b.calls] != [steps] or marked != [1, steps] \
            or left != ["1", str(steps)]:
        _fail(f"{tag}[run B]: step {steps}, whose write died in run A, was "
              f"not saved and marked again: saved "
              f"{[s for s, _, _ in saves_b.calls]}, marked {marked}, in the "
              f"directory {left}")
    payload_bytes(steps)

    # control 2: step 1's state, the loader not repositioned
    trainer.restore(os.path.join(root, "1", PAYLOAD))
    fresh = AsyncLoader(make(), _ckpt_config(args.seed),
                        device=trainer.device)
    got_d = []
    tap = _StepTap(torch, trainer, before=keep(got_d))
    trainer.fit(fresh, max_steps=1, log_every=0)
    tap.finish(0)
    unaligned = tap.metrics[0]["loss"].item()
    first = all(torch.equal(got_d[0][k], got_a[0][k]) for k in got_a[0])
    same_c = all(torch.equal(got_c[0][k], got_a[1][k]) for k in got_a[1])
    del trainer, loader, fresh, tap, got_c, got_d
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag}[controls]: the shadow not made again: step 1 loss "
          f"{stale:.6g} (its batch run A's: {same_c}); the loader not "
          f"repositioned: {unaligned:.6g} (on batch 0: {first}); run A's "
          f"{losses_a[1]:.6g}", flush=True)
    if stale == losses_a[1] or unaligned == losses_a[1] \
            or not same_c or not first:
        _fail(f"{tag}[controls]: a control did not part from run A (shadow "
              f"{stale}, loader {unaligned}, run A {losses_a[1]})")
    return {"launches": launches, "losses": losses_a, "stall_ms": stall,
            "step_ms": step_ms, "saves": saves.calls + saves_b.calls,
            "bytes": written, "restore_ms": restore_s[0] * 1e3,
            "peak_bytes": peak_a, "free_disk": free, "host_ram": ram,
            "digest": digest}


def _checkpoint_mesh_phase(torch, args, root, digest):
    """Checkpoints across the world-1 NCCL mesh (phase 11's setup) and
    one device, on phase 7's configuration and batch at --ckpt-layers:
    run B's step 6 restored into a one-device trainer and into a mesh
    trainer's DTensor masters, each bitwise the saved state, the mesh's
    next loss bitwise the one device's; then the mesh trainer's state
    saved and restored into a one-device trainer, bitwise, and its next
    loss bitwise the mesh's."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torchacc_tpu_torch import DistConfig, accelerate, get_preset
    from torchacc_tpu_torch.checkpoint.io import PAYLOAD
    from torchacc_tpu_torch.parallel import initialize_distributed
    from torchacc_tpu_torch.train import adamw, warmup_cosine

    tag = "checkpoint[mesh]"
    cfg = get_preset("llama3-8b", num_layers=args.ckpt_layers)
    batch = _train_batch(torch, np.random.default_rng(args.seed + 2),
                         cfg.vocab_size)
    step6 = os.path.join(root, "6", PAYLOAD)
    mesh_dir = os.path.join(root, "mesh")

    def trainer_of(seed, dist_cfg=None):
        gc.collect()
        torch.cuda.empty_cache()
        t, _ = accelerate(cfg, None, _ckpt_config(seed, False, dist_cfg),
                          optimizer=adamw(warmup_cosine(
                              3e-4, args.train_steps, warmup_steps=1)))
        t.init()
        return t

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t1 = trainer_of(args.seed + 3)
    t1.restore(step6)
    d1 = _state_digest(torch, t1.state)
    l1 = t1.step(batch)["loss"].item()
    del t1
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    initialize_distributed()
    try:
        tm = trainer_of(args.seed + 4, DistConfig())
        if tm.mesh is None or not all(isinstance(p, DTensor) and p.is_cuda
                                      for p in tm.state.params.values()):
            _fail(f"{tag}: the trainer is not on the mesh")
        restore_ms = timed(lambda: tm.restore(step6))
        dm1 = _state_digest(torch, tm.state)
        lm = tm.step(batch)["loss"].item()
        dm = _state_digest(torch, tm.state)
        save_ms = timed(lambda: tm.save(mesh_dir))
        lm2 = tm.step(batch)["loss"].item()
        del tm
    finally:
        dist.destroy_process_group()
    nbytes = _dir_bytes(mesh_dir)
    t2 = trainer_of(args.seed + 5)
    restore2_ms = timed(lambda: t2.restore(mesh_dir))
    d2 = _state_digest(torch, t2.state)
    l2 = t2.step(batch)["loss"].item()
    del t2
    gc.collect()
    torch.cuda.empty_cache()
    ok = [_same_state(d1, digest), _same_state(dm1, digest),
          _same_state(d2, dm)]
    print(f"{tag}: run B's step 6 into one device and into the mesh: "
          f"states bitwise {ok[:2]} (step {dm1[0]}, count {dm1[1]}), next "
          f"loss on the mesh {lm:.6g} against one device's {l1:.6g}; the "
          f"mesh's state into one device: bitwise {ok[2]}, next loss "
          f"{l2:.6g} against the mesh's {lm2:.6g}", flush=True)
    print(f"{tag}: blocking save from the mesh {save_ms:.1f} ms for "
          f"{nbytes} bytes ({nbytes / save_ms / 1e6:.2f} GB/s); restore "
          f"into the mesh {restore_ms:.1f} ms "
          f"({nbytes / restore_ms / 1e6:.2f} GB/s), into one device "
          f"{restore2_ms:.1f} ms ({nbytes / restore2_ms / 1e6:.2f} GB/s); "
          f"card: {_card()}", flush=True)
    if not (all(ok) and lm == l1 and l2 == lm2):
        _fail(f"{tag}: a restore across the mesh is not bitwise: states "
              f"{ok}, losses {lm}/{l1}, {l2}/{lm2}")
    return {"save_ms": save_ms, "bytes": nbytes, "restore_ms": restore_ms,
            "restore_one_ms": restore2_ms}


# ---------------------------------------------------------------------------
# the training path on a mesh
# ---------------------------------------------------------------------------

def _mesh_limit():
    """The world-1 mesh against the one-device step, bf16 over f32
    masters: the largest relative difference of the losses allowed, at
    every step.  0: FSDP2's bf16 cast of the masters is the shadow's
    rounding, its world-1 gather and reduce are copies, and the step
    rounds the f32-reduced gradients to bf16, as the shadow's arrive, so
    the two runs are one computation (PERF.md, the mesh phase).  The
    control (f32 param_dtype) parts from step 2, the first after a real
    update (lr is 0 at step 0)."""
    return 0.0


_COLLECTIVES = ("all_reduce", "all_gather_single", "reduce_scatter_single",
                "all_gather_into_tensor", "reduce_scatter_tensor")


class _CollectiveCount:
    """Counts the calls into torch.distributed's collectives while it is
    entered (FSDP2 and the port call them through the module)."""

    def __init__(self, dist):
        self.dist, self.counts, self._orig = dist, {}, {}

    def __enter__(self):
        for name in _COLLECTIVES:
            fn = getattr(self.dist, name, None)
            if fn is None:               # not in this torch
                continue
            self._orig[name] = fn

            def counted(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.dist, name, fn)


def _mesh_run(torch, args, tag, steps, **compute):
    """``steps`` steps of phase 7's model, seed, batch and optimizer
    through accelerate() under the process group: the trainer must be
    on a CUDA mesh with FSDP2 blocks and DTensor masters."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor
    import torchacc_tpu_torch.ops.flash_attention as fa
    import torchacc_tpu_torch.ops.quantized_matmul as qm
    from torchacc_tpu_torch import (ComputeConfig, Config, DistConfig,
                                    MemoryConfig, accelerate, get_preset)
    from torchacc_tpu_torch.train import adamw, warmup_cosine

    layers, warm = args.train_layers, 2
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(**compute),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  dist=DistConfig(), seed=args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
        warmup_cosine(3e-4, args.train_steps, warmup_steps=1)))
    state = trainer.init()
    mesh = trainer.mesh
    sharded = [isinstance(m, FSDPModule)
               for m in [trainer.model] + list(trainer.model.layers)]
    on_card = [isinstance(p, DTensor) and p.device.type == "cuda"
               for p in state.params.values()]
    if mesh is None or mesh.device_type != "cuda" or not all(sharded) \
            or not all(on_card):
        _fail(f"{tag}: the trainer took another path than the mesh: mesh "
              f"{mesh}, FSDP2 modules {sharded.count(True)}/{len(sharded)}, "
              f"DTensor masters on the card {on_card.count(True)}/"
              f"{len(on_card)}")
    batch = _train_batch(torch, np.random.default_rng(args.seed + 2),
                         cfg.vocab_size)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    for counts in (fa.launch_counts, qm.launch_counts):
        for key in counts:               # counts start here ...
            counts[key] = 0
    with _CollectiveCount(dist) as coll:
        ev[0].record()
        for i in range(steps):
            losses.append(trainer.step(batch)["loss"])
            ev[i + 1].record()
        torch.cuda.synchronize()
    launches = dict(fa.launch_counts)    # ... and are read here
    qmm_launches = dict(qm.launch_counts)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    losses = [x.item() for x in losses]
    peak = torch.cuda.max_memory_allocated()
    ms = sum(step_ms[warm:]) / len(step_ms[warm:])
    n_params = sum(p.numel() for p in state.params.values())
    tokens = TRAIN_B * TRAIN_S
    flops_tok = 6.0 * n_params + 6.0 * layers * cfg.hidden_size * TRAIN_S
    mfu = flops_tok * tokens / (ms / 1e3) / PEAK_BF16_FLOPS
    per_step = {k: v / steps for k, v in sorted(coll.counts.items())}
    print(f"{tag}: losses {_fmt(losses)}; step ms {_fmt(step_ms)} (first "
          f"{warm} warm-up); mean of the timed {ms:.1f} ms, "
          f"{tokens / (ms / 1e3):.0f} tokens/s, MFU {mfu:.4f}; peak "
          f"allocated {peak / 2**30:.2f} GiB; flash launches {launches}; "
          f"quantized-matmul launches {qmm_launches}; collective calls a "
          f"step {per_step}", flush=True)
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        _fail(f"{tag}: a loss is not finite: {losses}")
    for key, n in launches.items():
        if n != layers * steps:
            _fail(f"{tag}: flash {key} launches {n} != layers {layers} x "
                  f"steps {steps}")
    return {"losses": losses, "step_ms": ms, "mfu": mfu, "peak_bytes": peak,
            "tokens_per_s": tokens / (ms / 1e3), "launches": launches,
            "qmm_launches": qmm_launches, "collectives": per_step}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_phase(torch, args, train):
    """The training path on a mesh: a world-1 NCCL process group, as
    torchrun would start it, and accelerate() with Config(dist=
    DistConfig()) (every axis 1, dp inferred), so that the trainer shards
    with FSDP2 and DTensor masters.  bf16 against phase 7's losses, its
    control, and int8."""
    import torch.distributed as dist
    from torchacc_tpu_torch.parallel import initialize_distributed

    tag = "mesh training"
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    initialize_distributed()
    try:
        if dist.get_backend() != "nccl":
            _fail(f"{tag}: the process group's backend is "
                  f"{dist.get_backend()}, not nccl")
        steps = args.train_steps
        bf16 = _mesh_run(torch, args, tag, steps, bf16_compute_params=True)
        control = _mesh_run(torch, args, f"{tag}[control: f32 param_dtype]",
                            steps)
        int8 = _mesh_run(torch, args, f"{tag}[int8]", max(4, steps // 2),
                         bf16_compute_params=True, quant="int8")
    finally:
        dist.destroy_process_group()
    rel = [abs(a - b) / abs(b)
           for a, b in zip(bf16["losses"], train["losses"])]
    c_rel = [abs(a - b) / abs(b)
             for a, b in zip(control["losses"], train["losses"])]
    limit = _mesh_limit()
    apart, c_apart = max(rel), max(c_rel)
    print(f"{tag}: relative difference from phase 7 a step {_fmt(rel)}; "
          f"the control's {_fmt(c_rel)}", flush=True)
    print(f"{tag} beside the one-device step (phase 7): "
          f"{bf16['step_ms']:.1f} ms against {train['step_ms']:.1f} ms "
          f"({bf16['step_ms'] / train['step_ms']:.3f}x), "
          f"{bf16['tokens_per_s']:.0f} against {train['tokens_per_s']:.0f} "
          f"tokens/s, MFU {bf16['mfu']:.4f} against {train['mfu']:.4f}, peak "
          f"{bf16['peak_bytes'] / 2**30:.2f} against "
          f"{train['peak_bytes'] / 2**30:.2f} GiB; losses "
          f"{_fmt(bf16['losses'])} against {_fmt(train['losses'])}: "
          f"largest relative difference {apart:.4g} (limit {limit:.3g}); "
          f"the control (f32 param_dtype, no bf16 reads of the masters) "
          f"{c_apart:.4g}", flush=True)
    if not apart <= limit:
        _fail(f"{tag}: the mesh's losses part from the one-device step's by "
              f"{apart:.4g} > {limit:.3g}")
    if not c_apart > limit:
        _fail(f"{tag}: the control (f32 param_dtype) stays within the limit "
              f"({c_apart:.4g} <= {limit:.3g}): the check cannot tell the "
              f"bf16 policy from none")
    want = 7 * args.train_layers * len(int8["losses"])
    q_rel = abs(int8["losses"][0] - bf16["losses"][0]) / bf16["losses"][0]
    print(f"{tag}[int8]: B5 launches {int8['qmm_launches']['int8']} (want "
          f"{want}); first-step loss {int8['losses'][0]:.5f} against the bf16 "
          f"mesh run's {bf16['losses'][0]:.5f}: relative difference "
          f"{q_rel:.3g} (limit 0.02); step {int8['step_ms']:.1f} ms",
          flush=True)
    if int8["qmm_launches"]["int8"] != want:
        _fail(f"{tag}[int8]: quantized-matmul launches "
              f"{int8['qmm_launches']['int8']} != {want}")
    if q_rel > 0.02:
        _fail(f"{tag}[int8]: the first-step loss parts from the bf16 mesh "
              f"run's by {q_rel:.3g} > 0.02")
    return {"bf16": bf16, "control": control, "int8": int8, "apart": apart,
            "control_apart": c_apart}


# seconds of each phase of this run (_timed)
PHASE_S = {}


def _timed(name, fn, *a, **kw):
    """``fn(*a, **kw)``, its seconds printed and kept in PHASE_S."""
    t0 = time.perf_counter()
    try:
        return fn(*a, **kw)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {PHASE_S[name]} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="depth of the served llama3-8b (width is full)")
    ap.add_argument("--train-layers", type=int, default=4,
                    help="depth of the trained llama3-8b (width is full)")
    ap.add_argument("--train-steps", type=int, default=8,
                    help="training steps on the repeated batch (the "
                         "first 2 are warm-up)")
    ap.add_argument("--quant-steps", type=int, default=6,
                    help="training steps with compute.quant='int8' (the "
                         "first 2 are warm-up); 'fp8' takes 2 fewer")
    ap.add_argument("--data-steps", type=int, default=16,
                    help="steps of the data-fed training run (grad_accum 2; "
                         "the first 2 are warm-up)")
    ap.add_argument("--fp16-steps", type=int, default=8,
                    help="steps of the fp16 run (the 3rd from last "
                         "overflows on purpose)")
    ap.add_argument("--quant-rest-steps", type=int, default=4,
                    help="steps of the float16 int8 run with the 'head' "
                         "site (the 3rd overflows on purpose)")
    ap.add_argument("--check-layers", type=int, default=2,
                    help="depth of the model-level kernel-vs-plain check")
    ap.add_argument("--ckpt-layers", type=int, default=1,
                    help="depth of the checkpoint phases' llama3-8b (width "
                         "is full): 3 checkpoints of it are written")
    ap.add_argument("--hf-layers", type=int, default=4,
                    help="depth of the Hugging Face Llama-3.2-1B checkpoint "
                         "(width is full; 16 is its published depth)")
    ap.add_argument("--hf-steps", type=int, default=8,
                    help="fit steps on the Hugging Face checkpoint (the "
                         "first 2 are warm-up, the last holds the "
                         "evaluation)")
    ap.add_argument("--gemma-layers", type=int, default=8,
                    help="depth of the trained Hugging Face gemma-2-2b "
                         "checkpoint (width is full; a multiple of its "
                         "pattern's period 2)")
    ap.add_argument("--phi2-layers", type=int, default=8,
                    help="depth of the trained phi-2 checkpoint (width is "
                         "full; 32 is its published depth)")
    ap.add_argument("--phi3-layers", type=int, default=4,
                    help="depth of the trained Phi-3-mini checkpoint (width "
                         "is full; 32 is its published depth)")
    ap.add_argument("--mixtral-layers", type=int, default=2,
                    help="depth of mixtral-8x7b's widths (1.45 B parameters "
                         "a layer)")
    ap.add_argument("--qwen3-moe-layers", type=int, default=4,
                    help="depth of the Qwen3-30B-A3B checkpoint (width is "
                         "full)")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed kernel launches per shape")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one decode iteration and one prefill "
                         "chunk of the served model and one more training "
                         "step of each run (torch.profiler)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from torchacc_tpu_torch.ops import _build
        import torchacc_tpu_torch.ops.paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the torchacc_tpu_torch package is missing "
              f"({e}); run from a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = _card()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(logs) or 'cached'} in {build_s:.1f} s", flush=True)
    # the sequence packer is host C++, built by g++ at first use: build it
    # here, so that the data-fed phase's wait on its loader is the feed's
    import numpy as np
    import torchacc_tpu_torch.data.packing as packing
    t0 = time.perf_counter()
    packing.pack_sequences([np.arange(4, dtype=np.int32)], 8)
    print(f"build: sequence packer ({packing.last_packer}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for fn, stats in _ptxas_report(log):
            print(f"build {name}: {fn}: {stats}", file=sys.stderr)

    if args.train_steps < 6:
        _fail("--train-steps must be at least 6")
    if args.hf_steps < 5:
        _fail("--hf-steps must be at least 5")
    kern = _timed('_kernel_phase', _kernel_phase, torch, args, pa)
    # heads of 64 (Llama-3.2-1B, the Hugging Face phase's model)
    kern64 = _timed("_kernel_phase[d64]", _kernel_phase, torch, args, pa,
                    d=64, only=("decode", "prefill", "decode_long"))
    # float16 (the fp16-trained model served in its compute dtype, B-3)
    kern16 = _timed("_kernel_phase[f16]", _kernel_phase, torch, args, pa,
                    only=("decode", "prefill", "decode_softcap",
                          "prefill_window", "decode_long"),
                    dtype=torch.float16)
    flash_all = _timed('_flash_phase', _flash_phase, torch, args)
    flash, flash16 = flash_all["train"], flash_all["train_f16"]
    flash64 = _timed("_flash_phase[d64]", _flash_phase, torch, args, d=64,
                     only=("train", "f32", "sq_ne_sk_empty_rows"))
    # heads of 256 (the Gemma family)
    kern256, flash256 = _timed('_gemma_kernel_phase', _gemma_kernel_phase, torch, args, pa)
    # heads of 80 (Phi-2) and the ALiBi instantiation at GPT-2's heads
    flash80 = _timed('_phi2_kernel_phase', _phi2_kernel_phase, torch, args)
    flash_alibi = _timed('_gpt2_alibi_kernel_phase', _gpt2_alibi_kernel_phase, torch, args)
    # heads of 96 (Phi-3-mini)
    flash96 = _timed('_phi3_kernel_phase', _phi3_kernel_phase, torch, args)
    cp_res = _timed('_cp_phase', _cp_phase, torch, args)
    qmm = _timed('_qmm_phase', _qmm_phase, torch, args)
    launches, dispatches = _timed('_serving_phase', _serving_phase, torch, args, pa)
    journal = _timed("_journal_phase", _journal_phase, torch, args, pa, card)
    train = _timed('_training_phase', _training_phase, torch, args)
    qtrain = {
        "int8": _timed("_training_phase[int8]", _training_phase, torch, args,
                       "int8", args.quant_steps, train["losses"][0]),
        "fp8": _timed("_training_phase[fp8]", _training_phase, torch, args,
                      "fp8", max(4, args.quant_steps - 2),
                      train["losses"][0])}
    for fmt, r in qtrain.items():
        print(f"training[{fmt}] beside the unquantized step: "
              f"{r['step_ms']:.1f} ms against {train['step_ms']:.1f} ms "
              f"({r['step_ms'] / train['step_ms']:.3f}x), "
              f"{r['tokens_per_s']:.0f} against "
              f"{train['tokens_per_s']:.0f} tokens/s, MFU (bf16 peak) "
              f"{r['mfu']:.4f} against {train['mfu']:.4f}, peak "
              f"{r['peak_bytes'] / 2**30:.2f} against "
              f"{train['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    if args.data_steps < 4 or args.fp16_steps < 6:
        _fail("--data-steps must be at least 4 and --fp16-steps at least 6")
    fed = _timed('_data_training_phase', _data_training_phase, torch, args, train)
    fp16 = _timed('_fp16_phase', _fp16_phase, torch, args, fed)
    print(f"data-fed step beside the hand-fed one: {fed['step_ms']:.1f} ms "
          f"for 4 x 4096 tokens in 2 micro-batches against "
          f"{train['step_ms']:.1f} ms for 2 x 4096 in one "
          f"({fed['tokens_per_s']:.0f} against {train['tokens_per_s']:.0f} "
          f"tokens/s); fp16 step {fp16['step_ms']:.1f} ms for 2 x 4096, "
          f"the host waiting {fp16['flag_wait_ms']:.3f} ms a step for the "
          f"skip flag", flush=True)
    qrest_trainer, qrest = _timed("_quant_rest_phase", _quant_rest_phase,
                                  torch, args)
    qserve = _timed("_quant_rest_serving_phase", _quant_rest_serving_phase,
                    torch, args, pa, qrest_trainer)
    del qrest_trainer
    gc.collect()
    torch.cuda.empty_cache()
    pp = _timed('_pp_phase', _pp_phase, torch, args, card)
    pp_decode = _timed("_pp_decode_phase", _pp_decode_phase, torch, args,
                       card)
    _timed('_model_check_phase', _model_check_phase, torch, args)
    _timed('_quant_check_phase', _quant_check_phase, torch, args)
    _timed('_accum_check_phase', _accum_check_phase, torch, args)
    _timed('_offload_check_phase', _offload_check_phase, torch, args)
    hf = _timed('_hf_phase', _hf_phase, torch, args, pa)
    gemma2 = _timed('_gemma2_training_phase', _gemma2_training_phase, torch, args)
    gen3 = _timed('_gemma3_generate_phase', _gemma3_generate_phase, torch, args)
    gserve = _timed('_gemma_serving_phase', _gemma_serving_phase, torch, args, pa)
    phi2 = _timed('_phi2_phase', _phi2_phase, torch, args)
    gpt2 = _timed('_gpt2_phase', _gpt2_phase, torch, args, pa)
    alibi = _timed('_alibi_phase', _alibi_phase, torch, args)
    phi3 = _timed('_phi3_phase', _phi3_phase, torch, args)
    longrope = _timed('_longrope_phase', _longrope_phase, torch, args)
    olmo2 = _timed(
        "_dense_family_phase[olmo2]", _dense_family_phase,
        torch, args, "olmo2", OLMO2_7B, DENSE_LAYERS["olmo2"],
        dict(norm_placement="pre"),
        dict(norm_placement="post", qk_norm_proj=True, head_size=128),
        DENSE_STEPS, args.seed + 101)
    cohere = _timed(
        "_dense_family_phase[command-r]", _dense_family_phase,
        torch, args, "command-r", COMMAND_R, DENSE_LAYERS["cohere"],
        dict(rope_interleaved=False),
        dict(rope_interleaved=True, logit_scale=0.0625, parallel_block=True,
             norm_bias=False, tie_embeddings=True, head_size=128),
        DENSE_STEPS, args.seed + 111, on_hidden=True, lean=True)
    yarn = _timed('_yarn_serving_phase', _yarn_serving_phase, torch, args, pa)
    mixtral = _timed("_mixtral_phase", _mixtral_phase, torch, args)
    qwen3_moe = _timed("_qwen3_moe_phase", _qwen3_moe_phase, torch, args)
    root = _ckpt_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ckpt = _timed('_checkpoint_phase', _checkpoint_phase, torch, args, root)
        _timed("_mesh_phase", _mesh_phase, torch, args, train)
        ckpt_mesh = _timed("_checkpoint_mesh_phase", _checkpoint_mesh_phase,
                           torch, args, root, ckpt["digest"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    saves = ckpt["saves"]
    print(f"checkpoint: {ckpt['bytes']} bytes a checkpoint at "
          f"{args.ckpt_layers} layers; blocking save "
          f"{ckpt_mesh['save_ms']:.1f} ms ({ckpt_mesh['bytes'] / ckpt_mesh['save_ms'] / 1e6:.2f} "
          f"GB/s); fit's save steps: host ms in save() "
          f"{[round(ms, 1) for _, ms, _ in saves]} (the first allocates the "
          f"pinned staging), device bytes added "
          f"{[b for _, _, b in saves]}, stall on the device {ckpt['stall_ms']:.1f} "
          f"ms against a plain step; restore {ckpt['restore_ms']:.1f} ms in "
          f"fit ({ckpt['bytes'] / ckpt['restore_ms'] / 1e6:.2f} GB/s), "
          f"{ckpt_mesh['restore_ms']:.1f} ms into the mesh; peak allocated "
          f"{ckpt['peak_bytes'] / 2**30:.2f} GiB; free disk "
          f"{ckpt['free_disk']} bytes, host memory available "
          f"{ckpt['host_ram']} bytes; card: {card}", flush=True)

    entries = []
    for shape in ("decode", "prefill"):
        k = kern[shape]
        entries.append(dict(
            KERNEL, name=f"{KERNEL['name']}[{shape}]",
            launches=launches[shape],
            launches_per_dispatch=launches[shape] / dispatches[shape],
            max_abs_err=max(kern[c]["max_abs_err"] for c in kern
                            if (kern[c]["t"] == 1) == (shape == "decode")),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            host_ms=k["host_ms"]))
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name}]", route="cuda",
            body=FLASH_BODY[name], source=FLASH_SOURCE, replaces=replaces,
            launches=train["launches"][name],
            launches_per_step=train["launches"][name] / args.train_steps,
            launches_resume=ckpt["launches"][name],
            max_abs_err=max(flash[e]["max_abs_err"] for e in errs),
            ms=flash[f"{name}_ms"], plain_ms=flash[f"plain_{part}_ms"],
            bound_ms=flash[f"{name}_bound_ms"],
            bound_by=flash[f"{name}_bound_by"],
            library_ms=flash.get(f"library_{part}_ms"),
            tflops=flash[f"{name}_tflops"],
            bound_share=flash[f"{name}_bound_share"],
            # context parallelism (B-1): the kernels at global offsets
            # against the plain versions (heads of 128 and 64), and the
            # ring's virtual ranks at s 32768 against one whole call
            cp_offsets_max_abs_err=max(
                r["max_abs_err"] for r in cp_res["offsets"].values()),
            cp_offsets_worst_over_tol=max(
                r["worst_over_tol"] for r in cp_res["offsets"].values()),
            cp_ring_max_abs_err=max(cp_res["ring"][e]["max_abs_err"]
                                    for e in errs),
            launches_cp_ring=cp_res["ring"]["launches"][name],
            launches_cp_2d=cp_res["2d"]["launches"][name],
            # pipeline parallelism over virtual stages: one step's
            # gradient pass of each schedule
            **{f"launches_pp_{case}": r["launches"][name]
               for case, r in pp.items()},
            # the mixtures of experts (Mixtral's widths, Qwen3-30B-A3B's)
            launches_mixtral_dense=mixtral["dense"]["launches"][name],
            launches_mixtral_capacity=mixtral["capacity"]["launches"][name],
            launches_mixtral_generate=mixtral["capacity"]["generate"][
                "launches"][name],
            launches_qwen3_moe=qwen3_moe["launches"][name],
            launches_qwen3_moe_generate=qwen3_moe["generate"]["launches"][
                name]))
    for shape in ("decode", "prefill"):
        k = kern64[shape]
        entries.append(dict(
            KERNEL, name=f"{KERNEL['name']}[{shape},d64]",
            launches=hf["paged_launches"][shape],
            launches_per_dispatch=(hf["paged_launches"][shape]
                                   / hf["paged_dispatches"][shape]),
            launches_gpt2=gpt2["paged_launches"][shape],
            launches_per_dispatch_gpt2=(gpt2["paged_launches"][shape]
                                        / gpt2["paged_dispatches"][shape]),
            max_abs_err=max(kern64[c]["max_abs_err"] for c in kern64
                            if (kern64[c]["t"] == 1) == (shape == "decode")),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            host_ms=k["host_ms"]))
    f64 = flash64["train"]
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name},d64]", route="cuda",
            body=FLASH_BODY[name], source=FLASH_SOURCE, replaces=replaces,
            launches=hf["launches"][name],
            launches_per_step=hf["launches"][name] / hf["steps"],
            max_abs_err=max(flash64[c][e]["max_abs_err"] for c in flash64
                            for e in errs),
            ms=f64[f"{name}_ms"], plain_ms=f64[f"plain_{part}_ms"],
            bound_ms=f64[f"{name}_bound_ms"],
            bound_by=f64[f"{name}_bound_by"],
            library_ms=f64.get(f"library_{part}_ms"),
            tflops=f64[f"{name}_tflops"],
            bound_share=f64[f"{name}_bound_share"]))
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name},f16]", route="cuda",
            body=FLASH_BODY[name], source=FLASH_SOURCE, replaces=replaces,
            launches=fp16["launches"][name],
            launches_per_step=fp16["launches"][name] / fp16["steps"],
            max_abs_err=max(flash16[e]["max_abs_err"] for e in errs),
            ms=flash16[f"{name}_ms"], plain_ms=flash16[f"plain_{part}_ms"],
            bound_ms=flash16[f"{name}_bound_ms"],
            bound_by=flash16[f"{name}_bound_by"],
            library_ms=flash16.get(f"library_{part}_ms"),
            tflops=flash16[f"{name}_tflops"],
            bound_share=flash16[f"{name}_bound_share"],
            control_bf16_worst_over_tol=max(
                flash16["control_bf16"][e] for e in errs if e != "lse")))
    for shape in ("decode", "prefill"):
        k = kern256[shape]
        entries.append(dict(
            KERNEL, name=f"{KERNEL['name']}[{shape},d256]",
            launches=gserve["launches"][shape],
            launches_per_dispatch=(gserve["launches"][shape]
                                   / gserve["dispatches"][shape]),
            max_abs_err=max(kern256[c]["max_abs_err"] for c in kern256
                            if (kern256[c]["t"] == 1) == (shape == "decode")),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            host_ms=k["host_ms"]))
    kinds = ("sliding", "global")           # half the layers each
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        mean = lambda key: sum(flash256[c][key] for c in kinds) / 2
        lib = [flash256[c].get(f"library_{part}_ms") for c in kinds]
        nocap = flash256["sliding_no_cap"]
        entries.append(dict(
            name=f"flash_attention[{name},d256]", route="cuda",
            body=FLASH_BODY[name], source=FLASH_SOURCE,
            replaces=replaces, launches=gemma2["launches"][name],
            launches_per_step=gemma2["launches"][name] / gemma2["steps"],
            launches_generate=gen3["launches"][name],
            max_abs_err=max(flash256[c][e]["max_abs_err"] for c in flash256
                            for e in errs),
            # the mean over a sliding and a global layer of gemma2's
            # training shape, softcap 50; the library is compiled
            # flex_attention (null, with its error, where it did not
            # run); SDPA's time at the sliding shape without the cap
            # beside the kernel's there
            ms=mean(f"{name}_ms"), plain_ms=mean(f"plain_{part}_ms"),
            bound_ms=mean(f"{name}_bound_ms"),
            bound_by=flash256["sliding"][f"{name}_bound_by"],
            library_ms=None if None in lib else sum(lib) / 2,
            library="flex_attention (compiled)",
            library_error={c: flash256[c]["library_error"] for c in kinds
                           if "library_error" in flash256[c]} or None,
            library_sliding_ms=lib[0], library_global_ms=lib[1],
            control_no_dcap_worst_over_tol=min(
                min(flash256[c]["control_no_dcap"].values())
                for c in flash256 if "control_no_dcap" in flash256[c]),
            ms_sliding=flash256["sliding"][f"{name}_ms"],
            ms_global=flash256["global"][f"{name}_ms"],
            ms_no_cap=nocap[f"{name}_ms"],
            library_no_cap_ms=nocap.get(f"library_{part}_ms"),
            tflops=mean(f"{name}_tflops"),
            bound_share=mean(f"{name}_bound_share")))
    f80 = flash80["train"]
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name},d80]", route="cuda",
            body=FLASH_BODY[name] + ", d 80 stored as 128",
            source=FLASH_SOURCE, replaces=replaces,
            launches=phi2["launches"][name],
            launches_per_step=phi2["launches"][name] / phi2["steps"],
            launches_generate=phi2["generate"]["launches"][name],
            max_abs_err=max(flash80[c][e]["max_abs_err"] for c in flash80
                            for e in errs),
            worst_over_tol=max(flash80[c][e]["worst_over_tol"]
                               for c in flash80 for e in errs),
            ms=f80[f"{name}_ms"], plain_ms=f80[f"plain_{part}_ms"],
            bound_ms=f80[f"{name}_bound_ms"],
            bound_by=f80[f"{name}_bound_by"],
            library_ms=f80.get(f"library_{part}_ms"),
            tflops=f80[f"{name}_tflops"],
            bound_share=f80[f"{name}_bound_share"]))
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name},alibi,d64]", route="cuda",
            body=FLASH_BODY[name] + ", the ALiBi/dropout instantiation",
            source=FLASH_SOURCE, replaces=replaces,
            launches=alibi["launches"][name],
            launches_per_step=alibi["launches"][name] / alibi["steps"],
            launches_generate=alibi["generate"]["launches"][name],
            max_abs_err=max(flash_alibi[e]["max_abs_err"] for e in errs),
            worst_over_tol=max(flash_alibi[e]["worst_over_tol"]
                               for e in errs),
            ms=flash_alibi[f"{name}_ms"],
            plain_ms=flash_alibi[f"plain_{part}_ms"],
            bound_ms=flash_alibi[f"{name}_bound_ms"],
            bound_by=flash_alibi[f"{name}_bound_by"],
            library_ms=flash_alibi.get(f"library_{part}_ms"),
            library="SDPA, the ALiBi bias in a dense float mask",
            tflops=flash_alibi[f"{name}_tflops"],
            bound_share=flash_alibi[f"{name}_bound_share"]))
    f96 = flash96["train"]
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name},d96]", route="cuda",
            body=FLASH_BODY[name] + ", d 96 stored as 128",
            source=FLASH_SOURCE, replaces=replaces,
            launches=phi3["launches"][name],
            launches_per_step=phi3["launches"][name] / phi3["steps"],
            launches_generate=phi3["generate"]["launches"][name],
            launches_longrope_generate=longrope["launches"][name],
            max_abs_err=max(flash96[c][e]["max_abs_err"] for c in flash96
                            for e in errs),
            worst_over_tol=max(flash96[c][e]["worst_over_tol"]
                               for c in flash96 for e in errs),
            ms=f96[f"{name}_ms"], plain_ms=f96[f"plain_{part}_ms"],
            bound_ms=f96[f"{name}_bound_ms"],
            bound_by=f96[f"{name}_bound_by"],
            library_ms=f96.get(f"library_{part}_ms"),
            tflops=f96[f"{name}_tflops"],
            bound_share=f96[f"{name}_bound_share"],
            ms_window=flash96["train_window"][f"{name}_ms"],
            library_window_ms=flash96["train_window"].get(
                f"library_{part}_ms"),
            bound_window_ms=flash96["train_window"][f"{name}_bound_ms"]))
    for fmt in ("int8", "fp8"):
        q, run = qmm[fmt]["per_launch"], qtrain[fmt]
        entries.append(dict(
            QMM, name=f"quantized_matmul[{fmt}]",
            launches=run["qmm_launches"][fmt],
            launches_per_step=run["qmm_launches"][fmt] / run["steps"],
            max_abs_err=q["max_abs_err"], ms=q["ms"],
            plain_ms=q["plain_ms"], bound_ms=q["bound_ms"],
            bound_by=q["bound_by"], library_ms=q["library_ms"],
            bf16_matmul_ms=q["bf16_matmul_ms"],
            per_launch="mean over the 7 calls of one layer",
            **({"accumulation_vs_f64": qmm["fp8_accumulation"]}
               if fmt == "fp8" else {}),
            per_shape={s: {k: qmm[fmt][s].get(k) for k in (
                "m", "k", "n", "ms", "quantize_ms", "quantize_bound_ms",
                "gemm_ms", "gemm_tops", "host_ms", "bf16_matmul_host_ms",
                "plain_ms", "bound_ms", "library_ms", "bf16_matmul_ms",
                "max_abs_err")}
                for s in QMM_SITES}))
    for shape in ("decode", "prefill"):
        k = kern16[shape]
        entries.append(dict(
            KERNEL, name=f"{KERNEL['name']}[{shape},f16]",
            body="paged_mma_kernel<__half> (mma.sync f16)",
            launches=qserve["launches"][shape],
            launches_per_dispatch=(qserve["launches"][shape]
                                   / qserve["dispatches"][shape]),
            max_abs_err=max(kern16[c]["max_abs_err"] for c in kern16
                            if (kern16[c]["t"] == 1) == (shape == "decode")),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            host_ms=k["host_ms"]))
    q16 = qmm["int8"]["per_launch_f16"]
    shape_keys = ("m", "k", "n", "dtype", "ms", "quantize_ms", "gemm_ms",
                  "gemm_tops", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "bf16_matmul_ms", "max_abs_err")
    entries.append(dict(
        QMM, name="quantized_matmul[int8,f16]",
        launches=qrest["launches"] - qrest["head_launches"],
        launches_per_step=(qrest["launches"] - qrest["head_launches"])
        / qrest["steps"],
        max_abs_err=q16["max_abs_err"], ms=q16["ms"],
        plain_ms=q16["plain_ms"], bound_ms=q16["bound_ms"],
        bound_by=q16["bound_by"], library_ms=q16["library_ms"],
        f16_matmul_ms=q16["bf16_matmul_ms"],
        per_launch="mean over the 7 calls of one layer, float16",
        # fp8 in float16 at the same shapes, checked and timed (no phase
        # trains fp8 in float16)
        fp8_f16=qmm["fp8"]["per_launch_f16"],
        per_shape={s: {k: qmm["int8"][s + "_f16"].get(k) for k in shape_keys}
                   for s in QMM_SITES}))
    head = qmm["int8"]["head_f16"]
    entries.append(dict(
        QMM, name="quantized_matmul[int8,head,f16]",
        launches=qrest["head_launches"],
        launches_per_step=qrest["head_launches"] / qrest["steps"],
        max_abs_err=head["max_abs_err"], ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        f16_matmul_ms=head["bf16_matmul_ms"],
        shape=[head["m"], head["k"], head["n"]],
        # the same shape in bf16 and in fp8, and GPT-2's ragged head,
        # checked and timed
        others={f"{fmt}:{c}": {k: qmm[fmt][c].get(k) for k in shape_keys}
                for fmt in ("int8", "fp8")
                for c in ("head", "head_f16", "head_ragged_f16")
                if (fmt, c) != ("int8", "head_f16")}))
    print(f"quantized training, the rest: f16 int8 step "
          f"{qrest['step_ms']:.1f} ms, {qrest['tokens_per_s']:.0f} tokens/s, "
          f"peak {qrest['peak_bytes'] / 2**30:.2f} GiB; served in f16 at "
          f"{qserve['tokens_per_s']:.1f} tokens/s; card: {card}", flush=True)
    print(f"dense families: phi-3-mini x{phi3['layers']} step "
          f"{phi3['step_ms']:.1f} ms, MFU {phi3['mfu']:.4f}, peak "
          f"{phi3['peak_bytes'] / 2**30:.2f} GiB, first loss "
          f"{phi3['first_loss']:.6f}; olmo2 x{olmo2['layers']} step "
          f"{olmo2['step_ms']:.1f} ms, peak "
          f"{olmo2['peak_bytes'] / 2**30:.2f} GiB, first loss "
          f"{olmo2['first_loss']:.6f}; command-r x{cohere['layers']} step "
          f"{cohere['step_ms']:.1f} ms, peak "
          f"{cohere['peak_bytes'] / 2**30:.2f} GiB, first loss "
          f"{cohere['first_loss']:.6f}; longrope generate "
          f"{longrope['ms']:.1f} ms; yarn served B4 launches "
          f"{yarn['launches']}; card: {card}", flush=True)
    print(f"mixtures of experts: mixtral x{args.mixtral_layers} dense "
          f"{mixtral['dense']['step_ms']:.1f} ms a step, capacity "
          f"{mixtral['capacity']['step_ms']:.1f} ms, peak "
          f"{max(r['peak_bytes'] for r in mixtral.values()) / 2**30:.2f} "
          f"GiB; qwen3-30b-a3b x{qwen3_moe['layers']} "
          f"{qwen3_moe['step_ms']:.1f} ms a step, peak "
          f"{qwen3_moe['peak_bytes'] / 2**30:.2f} GiB, first loss "
          f"{qwen3_moe['first_loss']:.6f}; card: {card}", flush=True)
    print(f"phase seconds: {json.dumps(PHASE_S)}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
