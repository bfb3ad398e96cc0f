#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchacc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--layers 32] [--reps 50] [--seed 0]

Phases, each of which exits non-zero when it fails:

1. the card: name and power limit as nvidia-smi reports them;
2. the build: every kernel source under torchacc_tpu_torch/csrc/ is
   compiled by nvcc for sm_90a, one process per source, all at once;
3. the kernel phase: the paged-attention kernel against its plain
   PyTorch version on the same CUDA tensors (bf16, Llama-3-8B heads
   H=32 KH=8 D=128, BS=16, shuffled block tables, decode S=8 T=1 with
   contexts 0..~2k, a prefill chunk S=1 T=256, softcap and window
   cases), then its time beside the plain version's, one library call
   on pre-gathered K/V (F.scaled_dot_product_attention, a yardstick the
   port never calls) and the least time the card could take;
4. the serving phase: the llama3-8b preset at full width (hidden 4096,
   32/8 heads, ffn 14336, vocab 128256) and --layers deep, bf16 weights
   from init_params(seed) on the card, served through ServeEngine —
   two waves of 4 greedy requests, prompts 64..2000 tokens, 32 new
   tokens each, the second wave submitted mid-decode.  The kernel's
   launch counts, kept per shape where it launches, must equal layers x
   decode iterations (T = 1) and layers x prefill dispatches (chunks);
   every request's last-prompt-position logits through the kernel must
   match the plain attention path within a bf16 tolerance, and two
   controls (plain attention with the GQA head map wrong, and with a
   chunk's last row blind to its own key) must not.

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


def _time_ms(torch, fn, iters):
    for _ in range(3):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the served llama3-8b (width is full)")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed kernel launches per shape")
    ap.add_argument("--seed", type=int, default=0)
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
    launches, dispatches = _serving_phase(torch, args, pa)

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
    print(f"total: {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
