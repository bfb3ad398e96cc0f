#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchacc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--layers 32] [--train-layers 8] [--train-steps 8]
                          [--quant-steps 6] [--data-steps 16]
                          [--fp16-steps 8] [--check-layers 2] [--reps 50]
                          [--seed 0] [--profile]

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
   call;
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
   must read above that tolerance for o, dq, dk and dv;
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
   beside the plain f32 matmul's;
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
10. the mesh phase, run last: a world-1 NCCL process group as torchrun
   starts one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a free
   MASTER_PORT) and accelerate() with Config(dist=DistConfig()), whose
   trainer must hold FSDP2 blocks and DTensor masters on the card.
   Phase 7's model, seed, batch and optimizer for --train-steps steps,
   bf16 over f32 masters: every loss must equal phase 7's bitwise, and
   a control (f32 param_dtype) must not; B1-B3 launch layers x steps
   times; step ms, tokens/s, MFU, peak memory and the collective calls
   a step are printed beside phase 7's.  Then int8 on the mesh: B5
   launches 7 x layers x steps, and the first loss lies within 0.02 of
   the bf16 mesh run's.

No earlier phase was cut to make room: on an H100 the whole run takes
125-145 s (33-54 s of it the build; stderr has each kernel's registers
and spills from nvcc's -Xptxas -v).

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
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W); f16's
# dense tensor-core rate is bf16's
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# the f16 flash kernels against the plain version: two f16 ulps (2^-10 of
# the value each; both compute in f32 and round once to f16)
F16_TOL = dict(atol=2e-4, rtol=2e-3)

H, KH, D, BS = 32, 8, 128, 16           # Llama-3-8B attention geometry
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

def _paged_case(torch, rng, ctx, t, layers, dtype, q_start=None):
    """Per-layer pools with random contents and per-slot shuffled block
    tables (different per layer, so timing loops do not re-read one
    layer's pages out of L2).  Each slot's first query row sits at
    ctx - t unless ``q_start`` says otherwise."""
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
    k = torch.randn((layers, nb, BS, KH, D), generator=gen, device="cuda",
                    dtype=dtype)
    v = torch.randn((layers, nb, BS, KH, D), generator=gen, device="cuda",
                    dtype=dtype)
    q = torch.randn((s, t, H, D), generator=gen, device="cuda", dtype=dtype)
    q_start = np.asarray(q_start if q_start is not None
                         else [max(c - t, 0) for c in ctx], np.int32)
    cuda_i32 = lambda a: torch.from_numpy(a).cuda()
    return (q, k, v, cuda_i32(tables), cuda_i32(np.asarray(ctx, np.int32)),
            cuda_i32(q_start))


def _work(ctx, q_start, t, window, elem):
    """(bytes, flops) the function needs for these inputs: each input
    read once (only the K/V rows some query row can see, the block-table
    entries that name them), each output written once; 4*D flops per
    visible (row, key) pair and head."""
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
    nbytes = (2 * s * t * H * D * elem          # q in, out
              + keys * KH * D * 2 * elem        # k and v rows
              + entries * 4 + 2 * s * 4)        # table entries, ctx, q_start
    return nbytes, 4 * D * H * pairs


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


def _kernel_phase(torch, args, pa):
    import numpy as np
    import torch.nn.functional as F
    rng = np.random.default_rng(args.seed)
    # bf16 outputs from f32 accumulation: both versions compute the same
    # f32 sums in another order (relative difference ~1e-6), so after the
    # cast to bf16 they differ by at most one bf16 ulp = 2^-7 of the
    # value; rtol 1e-2 covers that, atol 1e-3 the values near zero
    tol = dict(atol=1e-3, rtol=1e-2)
    layers = 8                      # distinct pools cycled while timing
    decode_ctx = [0, 1, 17, 255, 1000, 1231, 1999, 2032]
    # long decode up to 8192: contexts on and one past where the kernel's
    # cut of a slot's keys into the plan's parts changes (the 128-key
    # minimum part; parts of two 64-key stages)
    parts = pa._paged_plan(
        (8, 1, H, D), (8 * 512 + 1, BS, KH, D), 8192 // BS, torch.bfloat16,
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
    results = {}
    for name, (ctx, t, window, cap, q0s) in cases.items():
        q, k, v, tables, lens, q_start = _paged_case(
            torch, rng, ctx, t, layers, torch.bfloat16, q0s)
        kw = dict(window=window, logit_softcap=cap)
        out = pa.paged_attention(q, k[0], v[0], tables[0], lens, q_start,
                                 impl="cuda", **kw)
        ref = pa.paged_attention(q, k[0], v[0], tables[0], lens, q_start,
                                 impl="torch", **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all():
            _fail(f"kernel case {name}: non-finite output")
        if any(c == 0 and out[i].abs().max().item() != 0.0
               for i, c in enumerate(ctx)):
            _fail(f"kernel case {name}: a ctx=0 slot is not zero")
        try:
            torch.testing.assert_close(out.float(), ref.float(), **tol)
        except AssertionError as e:
            _fail(f"kernel case {name} disagrees with the plain version: "
                  f"{e}")
        rec = {"max_abs_err": err, "tolerance": tol, "ctx": ctx, "t": t,
               "window": list(window), "softcap": cap}
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
                return (pool[tt].reshape(len(ctx), mb * BS, KH, D)
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
            nbytes, flops = _work(ctx, q0, t, window, 2)
            tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
            rec.update(bytes=nbytes, flops=flops,
                       bound_ms=max(tb, tf) * 1e3,
                       bound_by="bytes" if tb >= tf else "operations")
        results[name] = rec
        print(f"kernel {name}: max_abs_err {err:.3g} (atol {tol['atol']}, "
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


def _flash_inputs(torch, rng, b, sq, sk, dtype, segments):
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda",
                                     dtype=dtype)
    q, k, v, do = rnd(b, sq, H, D), rnd(b, sk, KH, D), rnd(b, sk, KH, D), \
        rnd(b, sq, H, D)
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
    b, sq, _, _ = q.shape
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


def _flash_phase(torch, args):
    """B1-B3 against the plain version; times at the training shape."""
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
    cases = {   # b, sq, sk, dtype, segments, causal, window, softcap, more
        "train": (TRAIN_B, TRAIN_S, TRAIN_S, torch.bfloat16, True, True,
                  (-1, -1), 0.0, {}),
        "train_f16": (TRAIN_B, TRAIN_S, TRAIN_S, torch.float16, True, True,
                      (-1, -1), 0.0, {}),
        "window_softcap": (1, 2048, 2048, torch.bfloat16, False, True,
                           (1024, -1), 50.0, {}),
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
    for name, (b, sq, sk, dtype, segments, causal, window, cap,
               more) in cases.items():
        q, k, v, do, seg = _flash_inputs(torch, rng, b, sq, sk, dtype,
                                         segments)
        scale = D ** -0.5
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
               "segments": segments, "window": list(window), "softcap": cap}
        for key in ("o", "lse", "dq", "dk", "dv"):
            a, r = got[key].float(), ref[key].float()
            if not torch.isfinite(a).all():
                _fail(f"flash case {name}: non-finite {key}")
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
                _fail(f"flash case {name}: {key} disagrees with the plain "
                      f"version: {e}")
        if name == "sq_ne_sk_empty_rows":
            blind = sq - sk                     # query i sits at i + sk - sq
            if (got["o"][:, :blind].abs().max().item() != 0.0
                    or got["lse"][:, :, :blind].max().item() > -1e29
                    or got["dq"][:, :blind].abs().max().item() != 0.0):
                _fail("flash: rows that see no key must give o = 0, "
                      "lse = NEG_INF and dq = 0")
        print(f"flash {name}: " + ", ".join(
            f"{key} err {rec[key]['max_abs_err']:.3g} (ref max "
            f"{rec[key]['ref_max']:.3g}, worst/tol "
            f"{rec[key]['worst_over_tol']:.3g})"
            for key in ("o", "lse", "dq", "dk", "dv")), flush=True)
        if name == "train_f16":
            rec["control_bf16"] = _f16_control(torch, fa, q, k, v, do, kw,
                                               ref)
        del got, ref
        if name in ("train", "train_f16"):
            rec.update(_flash_times(torch, F, fa, args, q, k, v, do, seg,
                                    scale, causal, window, cap))
        results[name] = rec
        del q, k, v, do, seg
        torch.cuda.empty_cache()
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
                 window, cap):
    """Kernel, plain, library and bound times of B1-B3 at these inputs."""
    reps = max(3, args.reps // 5)
    geo = (seg, seg, causal, window, scale, cap)
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
              q_segment_ids=seg, kv_segment_ids=seg)
    out["plain_fwd_ms"] = _time_ms(torch, lambda i: fa.attention_reference(
        q, k, v, return_lse=True, **kw), 2, warm=1)
    out["plain_bwd_ms"] = _time_ms(
        torch, lambda i: fa.attention_reference_bwd(q, k, v, o, lse, do,
                                                    **kw), 2, warm=1)
    # yardstick: SDPA with the same dense mask on BHSD copies with the kv
    # heads expanded (forward; forward+backward minus forward)
    pairs, nbytes, mask = _flash_work(torch, q, k, seg, causal, window)
    if cap == 0.0:
        bh = lambda t: t.repeat_interleave(H // t.shape[2], dim=2) \
            .transpose(1, 2).contiguous()
        qt, kt, vt, dot = bh(q), bh(k), bh(v), bh(do)
        m4 = mask[:, None] if mask.ndim == 3 else mask
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
    flops = {"fwd": 4 * D * pairs * H, "bwd_dq": 6 * D * pairs * H,
             "bwd_dkv": 8 * D * pairs * H}
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
    dt = str(q.dtype).removeprefix("torch.")
    print(f"flash train shape {dt}: visible pairs/head {pairs}; kernel ms fwd "
          f"{out['fwd_ms']:.3f} dq {out['bwd_dq_ms']:.3f} dkv "
          f"{out['bwd_dkv_ms']:.3f}; plain ms fwd {out['plain_fwd_ms']:.2f} "
          f"bwd {out['plain_bwd_ms']:.2f}; library (SDPA, dense mask) ms fwd "
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
        f"{out['bwd_dq_ms'] + out['bwd_dkv_ms']:.3f} ms against SDPA's "
        f"backward {out.get('library_bwd_ms', float('nan')):.3f} ms",
        flush=True)
    return out


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
    fp8_tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
               torch.float32: dict(atol=1e-4, rtol=1e-4)}
    # name -> (m, k, n, dtype, weight layout, x and w multipliers)
    cases = {name: (m, k, n, torch.bfloat16, "nk", (1.0, 1.0))
             for name, (k, n, _) in QMM_SITES.items()}
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
        timed = name in QMM_SITES
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
                rec["bf16_matmul_ms"] = bf16_ms
                # yardstick: one library call on operands quantized before
                lq = qm.quantize(x, sx, fmt)
                lw = qm.quantize(w, sw[:, None], fmt)        # [N, K]
                try:
                    if fmt == "int8":
                        lib = lambda i: torch._int_mm(lq, lw.t())
                    else:
                        lib = lambda i: torch._scaled_mm(
                            lq, lw.t(), scale_a=one, scale_b=one,
                            out_dtype=torch.bfloat16)
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
    # per launch on the main path: the mean over one layer's 7 launches
    for fmt in ("int8", "fp8"):
        recs = results[fmt]
        per_layer = sum(c for _, _, c in QMM_SITES.values())
        summary = {}
        for key in ("ms", "quantize_ms", "gemm_ms", "plain_ms", "bound_ms",
                    "library_ms", "bf16_matmul_ms"):
            vals = [recs[s][key] for s in QMM_SITES]
            summary[key] = (None if any(v is None for v in vals) else sum(
                v * QMM_SITES[s][2] for v, s in zip(vals, QMM_SITES))
                / per_layer)
        summary["max_abs_err"] = max(recs[s]["max_abs_err"]
                                     for s in QMM_SITES)
        summary["bound_by"] = recs["gate_up"]["bound_by"]
        recs["per_launch"] = summary
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
# model-level kernel-vs-plain check
# ---------------------------------------------------------------------------

def _grad_limit(layers):
    """Largest relative difference allowed between the loss and the
    gradients through the kernels and through the plain attention
    (max |a - b| / max |b|).  Set from readings (PERF.md)."""
    return 0.05 * max(1.0, (layers / 2) ** 0.5)


def _model_check_phase(torch, args):
    import dataclasses
    import numpy as np
    from torchacc_tpu_torch import get_preset, init_params
    from torchacc_tpu_torch.models.transformer import (head_weight,
                                                      set_model_config)
    from torchacc_tpu_torch.ops.fused import fused_linear_cross_entropy
    from torchacc_tpu_torch.train import shift_labels

    layers = args.check_layers
    cfg = get_preset("llama3-8b", num_layers=layers, remat=True,
                     remat_policy="save_attn_mlp")
    model = init_params(cfg, seed=args.seed, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(True).train()
    batch = _train_batch(torch, np.random.default_rng(args.seed + 3),
                         cfg.vocab_size)
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
            _fail(f"model check ({name}): non-finite loss or gradient")
        rel[name] = {n: ((got[n] - ref[n]).abs().max()
                         / ref[n].abs().max()).item() for n in ref}
    limit = _grad_limit(layers)
    print(f"model check ({layers} layers): loss {ref['loss'].item():.5f}; "
          f"relative difference from plain attention: kernel "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in rel['kernel'].items()})}, "
          f"control (segments ignored) "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in rel['ignore_segments'].items()})}; "
          f"limit {limit:.3g}", flush=True)
    worst = max(rel["kernel"].values())
    if worst > limit:
        _fail(f"model check: the kernels part from the plain attention by "
              f"{worst:.3g} > {limit:.3g}")
    if max(rel["ignore_segments"].values()) <= limit:
        _fail(f"model check: the segments-ignored control stays within "
              f"{limit:.3g}: the check cannot tell a wrong mask apart")
    del model, watched
    torch.cuda.empty_cache()
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the served llama3-8b (width is full)")
    ap.add_argument("--train-layers", type=int, default=8,
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
    ap.add_argument("--check-layers", type=int, default=2,
                    help="depth of the model-level kernel-vs-plain check")
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
    kern = _kernel_phase(torch, args, pa)
    flash_all = _flash_phase(torch, args)
    flash, flash16 = flash_all["train"], flash_all["train_f16"]
    qmm = _qmm_phase(torch, args)
    launches, dispatches = _serving_phase(torch, args, pa)
    train = _training_phase(torch, args)
    qtrain = {
        "int8": _training_phase(torch, args, "int8", args.quant_steps,
                                train["losses"][0]),
        "fp8": _training_phase(torch, args, "fp8",
                               max(4, args.quant_steps - 2),
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
    fed = _data_training_phase(torch, args, train)
    fp16 = _fp16_phase(torch, args, fed)
    print(f"data-fed step beside the hand-fed one: {fed['step_ms']:.1f} ms "
          f"for 4 x 4096 tokens in 2 micro-batches against "
          f"{train['step_ms']:.1f} ms for 2 x 4096 in one "
          f"({fed['tokens_per_s']:.0f} against {train['tokens_per_s']:.0f} "
          f"tokens/s); fp16 step {fp16['step_ms']:.1f} ms for 2 x 4096, "
          f"the host waiting {fp16['flag_wait_ms']:.3f} ms a step for the "
          f"skip flag", flush=True)
    _model_check_phase(torch, args)
    _quant_check_phase(torch, args)
    _accum_check_phase(torch, args)
    _offload_check_phase(torch, args)
    _mesh_phase(torch, args, train)

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
            max_abs_err=max(flash[e]["max_abs_err"] for e in errs),
            ms=flash[f"{name}_ms"], plain_ms=flash[f"plain_{part}_ms"],
            bound_ms=flash[f"{name}_bound_ms"],
            bound_by=flash[f"{name}_bound_by"],
            library_ms=flash.get(f"library_{part}_ms"),
            tflops=flash[f"{name}_tflops"],
            bound_share=flash[f"{name}_bound_share"]))
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
    print(f"total: {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
