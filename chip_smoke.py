#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchacc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--layers 32] [--train-layers 8] [--train-steps 8]
                          [--check-layers 2] [--reps 50] [--seed 0]
                          [--profile]

Phases, each of which exits non-zero when it fails:

1. the card: name and power limit as nvidia-smi reports them;
2. the build: every kernel source under torchacc_tpu_torch/csrc/ is
   compiled by nvcc for sm_90a, one process per source, all at once;
3. the paged-attention kernel phase: B4 against its plain PyTorch
   version on the same CUDA tensors (bf16, Llama-3-8B heads H=32 KH=8
   D=128, BS=16, shuffled block tables, decode S=8 T=1 with contexts
   0..~2k, a prefill chunk S=1 T=256, softcap and window cases), then
   its time beside the plain version's, one library call on
   pre-gathered K/V (F.scaled_dot_product_attention, a yardstick the
   port never calls) and the least time the card could take;
4. the flash-attention kernel phase: B1 (forward), B2 (dq) and B3
   (dk/dv) against the plain version on the same CUDA tensors — the
   training shape b=2 s=4096 H=32 KH=8 D=128 bf16, causal, packed
   documents of numpy-seeded lengths; a window (1024, -1) + softcap 50
   case, an f32 case, and an sq != sk case with empty rows — then each
   kernel's time at the training shape beside the plain version's, SDPA
   with the same dense mask (forward; forward+backward minus forward for
   the backward) and the least time the card could take;
5. the serving phase: the llama3-8b preset at full width (hidden 4096,
   32/8 heads, ffn 14336, vocab 128256) and --layers deep, bf16 weights
   from init_params(seed) on the card, served through ServeEngine —
   two waves of 4 greedy requests, prompts 64..2000 tokens, 32 new
   tokens each, the second wave submitted mid-decode.  The paged
   kernel's launch counts, kept per shape where it launches, must equal
   layers x decode iterations (T = 1) and layers x prefill dispatches
   (chunks); every request's last-prompt-position logits through the
   kernel must match the plain attention path within a bf16 tolerance,
   and two controls (plain attention with the GQA head map wrong, and
   with a chunk's last row blind to its own key) must not;
6. the training phase: llama3-8b at full width and --train-layers deep
   (the depth is the only cut: 32 layers of f32 masters and AdamW state
   need ~128 GB), through accelerate() -> Trainer.step with bf16
   compute over f32 masters and save_attn_mlp remat, stepping one
   numpy-seeded batch of 2 x 4096 packed tokens --train-steps times (the
   first 2 are warm-up).  Every loss must be finite and the last below
   the first; each flash kernel must have launched exactly layers x
   steps times (so remat never re-ran the forward kernel);
7. the model-level check: --check-layers deep at full width, one
   forward + backward through the kernels and through
   attention_impl='torch' from the same weights and batch; the loss and
   the first layer's q/k/v-projection and the embedding gradients must
   agree within a limit set from readings, and a control (plain
   attention with the segment mask ignored) must not.

The last two lines of standard output are the ``kernels`` JSON object
and the ``{"ok": true, "device": ...}`` object.  Needs one card; exits
non-zero with no result where torch.cuda.is_available() is false.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

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
TRAIN_B, TRAIN_S = 2, 4096              # tokens per training step: 8192


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


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

def _paged_case(torch, rng, ctx, t, layers, dtype):
    """Per-layer pools with random contents and per-slot shuffled block
    tables (different per layer, so timing loops do not re-read one
    layer's pages out of L2)."""
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
    q_start = np.asarray([max(c - t, 0) for c in ctx], np.int32)
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


def _time_ms(torch, fn, iters, warm=3):
    for _ in range(warm):
        fn(0)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
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
    cases = {
        "decode": (decode_ctx, 1, (-1, -1), 0.0),
        "prefill": ([1300], 256, (-1, -1), 0.0),
        "decode_softcap": (decode_ctx, 1, (-1, -1), 50.0),
        "prefill_window": ([1300], 256, (128, -1), 0.0),
    }
    results = {}
    for name, (ctx, t, window, cap) in cases.items():
        q, k, v, tables, lens, q_start = _paged_case(
            torch, rng, ctx, t, layers, torch.bfloat16)
        kw = dict(window=window, logit_softcap=cap)
        out = pa.paged_attention(q, k[0], v[0], tables[0], lens, q_start,
                                 impl="cuda", **kw)
        ref = pa.paged_attention(q, k[0], v[0], tables[0], lens, q_start,
                                 impl="torch", **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all():
            _fail(f"kernel case {name}: non-finite output")
        if ctx[0] == 0 and out[0].abs().max().item() != 0.0:
            _fail(f"kernel case {name}: the ctx=0 slot is not zero")
        try:
            torch.testing.assert_close(out.float(), ref.float(), **tol)
        except AssertionError as e:
            _fail(f"kernel case {name} disagrees with the plain version: "
                  f"{e}")
        rec = {"max_abs_err": err, "tolerance": tol, "ctx": ctx, "t": t,
               "window": list(window), "softcap": cap}
        if name in ("decode", "prefill"):
            iters = args.reps
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
                 f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
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
           torch.float32: dict(atol=1e-5, rtol=1e-5)}
    grad_tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
                torch.float32: dict(atol=1e-4, rtol=1e-4)}
    cases = {   # b, sq, sk, dtype, segments, causal, window, softcap
        "train": (TRAIN_B, TRAIN_S, TRAIN_S, torch.bfloat16, True, True,
                  (-1, -1), 0.0),
        "window_softcap": (1, 2048, 2048, torch.bfloat16, False, True,
                           (1024, -1), 50.0),
        "f32": (1, 1024, 1024, torch.float32, True, True, (-1, -1), 0.0),
        "sq_ne_sk_empty_rows": (1, 1536, 512, torch.bfloat16, False, True,
                                (-1, -1), 0.0),
    }
    results = {}
    for name, (b, sq, sk, dtype, segments, causal, window,
               cap) in cases.items():
        q, k, v, do, seg = _flash_inputs(torch, rng, b, sq, sk, dtype,
                                         segments)
        scale = D ** -0.5
        kw = dict(causal=causal, window=window, logit_softcap=cap,
                  q_segment_ids=seg, kv_segment_ids=seg)
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
        del got, ref
        if name == "train":
            rec.update(_flash_times(torch, F, fa, args, q, k, v, do, seg,
                                    scale, causal, window, cap))
        results[name] = rec
        del q, k, v, do, seg
        torch.cuda.empty_cache()
    return results


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
    print(f"flash train shape: visible pairs/head {pairs}; kernel ms fwd "
          f"{out['fwd_ms']:.3f} dq {out['bwd_dq_ms']:.3f} dkv "
          f"{out['bwd_dkv_ms']:.3f}; plain ms fwd {out['plain_fwd_ms']:.2f} "
          f"bwd {out['plain_bwd_ms']:.2f}; library (SDPA, dense mask) ms fwd "
          f"{out.get('library_fwd_ms', float('nan')):.3f} bwd "
          f"{out.get('library_bwd_ms', float('nan')):.3f}; bound ms fwd "
          f"{out['fwd_bound_ms']:.4f} dq {out['bwd_dq_bound_ms']:.4f} dkv "
          f"{out['bwd_dkv_bound_ms']:.4f} ({out['fwd_bound_by']})",
          flush=True)
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


def _training_phase(torch, args):
    import numpy as np
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.train import adamw, warmup_cosine

    layers, steps, warm = args.train_layers, args.train_steps, 2
    if steps < warm + 4:
        _fail(f"--train-steps must be at least {warm + 4}")
    print(f"training: llama3-8b at full width, depth cut to {layers} of 32 "
          f"layers", flush=True)
    cfg = get_preset("llama3-8b", num_layers=layers)
    conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  seed=args.seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
        warmup_cosine(3e-4, steps, warmup_steps=1)))
    state = trainer.init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"training: {n_params / 1e9:.3f}B params (f32 masters, AdamW, "
          f"bf16 shadow) made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    batch = _train_batch(torch, np.random.default_rng(args.seed + 2),
                         cfg.vocab_size)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses, norms = [], []
    for key in fa.launch_counts:         # counts start here ...
        fa.launch_counts[key] = 0
    ev[0].record()
    for i in range(steps):
        m = trainer.step(batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)    # ... and are read here
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
    print(f"training: losses {_fmt(losses)}; grad norms {_fmt(norms)}",
          flush=True)
    print(f"training: step ms {_fmt(step_ms)} (first {warm} warm-up); "
          f"mean of the timed {ms:.1f} ms, {tokens / (ms / 1e3):.0f} "
          f"tokens/s, MFU {mfu:.4f} of 989 TFLOP/s (6N + 6*L*h*s per token, "
          f"N = {n_params}); peak allocated {peak / 2**30:.2f} GiB; flash "
          f"launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        _fail(f"training: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"training: the loss did not fall on the repeated batch: "
              f"{losses}")
    for key, n in launches.items():
        if n != layers * steps:
            _fail(f"training: flash {key} launches {n} != layers {layers} x "
                  f"steps {steps} (a re-run forward means remat recomputed "
                  f"the attention)")
    if args.profile:
        _profile_step(torch, trainer, batch)
    del trainer, state, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": ms, "mfu": mfu,
            "losses": losses, "peak_bytes": peak}


def _profile_step(torch, trainer, batch):
    """One more training step under torch.profiler: device time by
    kernel (the top ones on stdout, the whole table and a chrome trace
    under train_profile/), and the device's busy and idle share of the
    step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "train_profile")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies, sets): an operator's row
    # repeats the time of the kernels it launched
    from torch.autograd import DeviceType
    kern = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and a.self_device_time_total > 0]
    kern.sort(key=lambda a: -a.self_device_time_total)
    busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
    groups = {}
    for a in kern:
        name = a.key
        g = ("flash attention" if "::fwd_" in name or "::bwd_d" in name
             else "GEMM (cuBLAS)" if any(t in name for t in (
                 "nvjet", "gemm", "gemv", "xmma", "cutlass"))
             else "elementwise, copy, reduce (aten)" if "at::native" in name
             or "Memcpy" in name or "Memset" in name else "other")
        groups[g] = groups.get(g, 0.0) + a.self_device_time_total / 1e3
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=80))
    prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    print(f"profile: one step, wall {wall_ms:.1f} ms (profiled), device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
          + "; ".join(f"{g} {ms:.1f} ms" for g, ms in sorted(
              groups.items(), key=lambda kv: -kv[1])), flush=True)
    for a in kern[:15]:
        print(f"profile: {a.self_device_time_total / 1e3:9.2f} ms "
              f"x{a.count:<5d} {a.key[:110]}", flush=True)


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the served llama3-8b (width is full)")
    ap.add_argument("--train-layers", type=int, default=8,
                    help="depth of the trained llama3-8b (width is full)")
    ap.add_argument("--train-steps", type=int, default=8,
                    help="training steps on the repeated batch (the "
                         "first 2 are warm-up)")
    ap.add_argument("--check-layers", type=int, default=2,
                    help="depth of the model-level kernel-vs-plain check")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed kernel launches per shape")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more training step (torch.profiler)")
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
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}", file=sys.stderr)

    kern = _kernel_phase(torch, args, pa)
    flash = _flash_phase(torch, args)["train"]
    launches, dispatches = _serving_phase(torch, args, pa)
    train = _training_phase(torch, args)
    _model_check_phase(torch, args)

    entries = []
    for shape in ("decode", "prefill"):
        k = kern[shape]
        entries.append(dict(
            KERNEL, name=f"{KERNEL['name']}[{shape}]",
            launches=launches[shape],
            launches_per_dispatch=launches[shape] / dispatches[shape],
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    for name, replaces in FLASH.items():
        part = "fwd" if name == "fwd" else "bwd"
        errs = ("o", "lse") if name == "fwd" else (
            ("dq",) if name == "bwd_dq" else ("dk", "dv"))
        entries.append(dict(
            name=f"flash_attention[{name}]", route="cuda",
            source=FLASH_SOURCE, replaces=replaces,
            launches=train["launches"][name],
            launches_per_step=train["launches"][name] / args.train_steps,
            max_abs_err=max(flash[e]["max_abs_err"] for e in errs),
            ms=flash[f"{name}_ms"], plain_ms=flash[f"plain_{part}_ms"],
            bound_ms=flash[f"{name}_bound_ms"],
            bound_by=flash[f"{name}_bound_by"],
            library_ms=flash.get(f"library_{part}_ms")))
    print(f"total: {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
