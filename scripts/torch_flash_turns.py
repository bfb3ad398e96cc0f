#!/usr/bin/env python3
"""Time the flash-attention kernels of the PyTorch/CUDA port (B1 the
forward, B2 dq and B3 dk/dv, torchacc_tpu_torch/csrc/flash_attention.cu)
against another version of that source, in turns, on one NVIDIA card.

    git show <rev>:torchacc_tpu_torch/csrc/flash_attention.cu > other.cu
    python3 scripts/torch_flash_turns.py --other other.cu \
        [--kernels fwd|bwd|all] [--mask docs|causal|full] [--reps 50] \
        [--head-dim 128] [--train-layers 8] [--train-steps 4] [--seed 0] \
        [--other-without-offsets]

The other source must have the same C interface, or, with
--other-without-offsets, the interface before the global q/k/h/b
offsets (four ints before the dtype): its entry points are then called
without them, and only at offsets 0, which is all this script runs.  It is compiled by
nvcc (sm_90a, the port's flags) into a library of its own name; the
entry points that --kernels names (fwd: flash_attention_fwd; bwd:
flash_attention_bwd_dq and flash_attention_bwd_dkv; all: the three) are
swapped in under ops/flash_attention.py, so both sides run the same
wrappers, this source's other kernels and the same inputs.  Phases,
every measurement in turns (other, this, this, other):

1. kernels: chip_smoke.py's flash training shape (b 2, s 4096, 32 q /
   8 kv heads of --head-dim, 128 or 64, bf16) under --mask: docs, causal over packed
   documents from the same seed (the training step's mask); causal,
   one document; full, no mask; each side's swapped kernels against the plain version at the
   card's tolerances (o one bf16 ulp, lse 1e-5; dq, dk, dv one bf16 ulp
   against the plain backward from the same (o, lse)), then
   chip_smoke.py's _flash_times on each side: kernel ms (CUDA events),
   SDPA's forward and backward in the same call, the bound, achieved
   TFLOP/s;
2. training (--train-steps > 0): chip_smoke.py's bf16 training step
   (llama3-8b width, --train-layers deep, save_attn_mlp remat, one
   packed batch of 2 x 4096 tokens), one warm-up step and
   --train-steps timed steps a turn (CUDA events).

Prints the card's name and power limit, a line per measurement, and one
JSON object as the last line.  Needs one card.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SWAPPED = {"fwd": (0,), "bwd": (1, 2), "all": (0, 1, 2)}
MASKS = {"docs": (True, True), "causal": (False, True),   # segments, causal
         "full": (False, False)}
KEYS = {"fwd": ("fwd_ms", "library_fwd_ms", "fwd_tflops", "fwd_bound_ms",
                "fwd_bound_share"),
        "bwd": ("bwd_dq_ms", "bwd_dkv_ms", "library_bwd_ms",
                "bwd_dq_tflops", "bwd_dkv_tflops", "bwd_dq_bound_ms",
                "bwd_dkv_bound_ms", "bwd_dq_bound_share",
                "bwd_dkv_bound_share")}


def _bind(lib, offsets=True):
    """The entry points of a flash-attention library (forward, dq,
    dk/dv), typed as ops/flash_attention.py types them.  ``offsets``
    False: a library without the four offset ints, called through
    wrappers that drop them (they must be 0)."""
    fns = (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
           lib.flash_attention_bwd_dkv)
    tail = ([ctypes.c_int] * 9 + [ctypes.c_float] * 2
            + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
            + [ctypes.c_int] * (4 if offsets else 0)
            + [ctypes.c_int, ctypes.c_void_p])
    for fn, n in zip(fns, (8, 10, 11)):
        fn.argtypes = [ctypes.c_void_p] * n + tail
        fn.restype = ctypes.c_int
    if offsets:
        return fns

    def without_offsets(fn):
        def call(*a):
            if any(a[-6:-2]):
                sys.exit("the other source takes no offsets")
            return fn(*a[:-6], *a[-2:])
        return call
    return tuple(without_offsets(fn) for fn in fns)


def _build_other(path, offsets=True):
    from torchacc_tpu_torch.ops import _build
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_build.BUILD_DIR, f"libflash_other-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             out, path], capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"nvcc failed on {path}:\n{res.stdout}{res.stderr}")
        print(f"built {path} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return _bind(ctypes.CDLL(out), offsets)


def _worst(torch, got, ref, tols):
    """Worst |err| / (atol + rtol |ref|) of each named output."""
    out = {}
    for name, a, r in zip(tols, got, ref):
        a, r = a.float(), r.float()
        t = tols[name]
        out[name] = ((a - r).abs() / (t[0] + t[1] * r.abs())).max().item()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="another csrc/flash_attention.cu to time against")
    ap.add_argument("--kernels", choices=sorted(SWAPPED), default="all",
                    help="which kernels to take from the other source")
    ap.add_argument("--mask", choices=sorted(MASKS), default="docs",
                    help="the kernels' mask at the training shape")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--head-dim", type=int, default=128, choices=(64, 128),
                    help="the heads' dim at the training shape (64: "
                         "Llama-3.2-1B's)")
    ap.add_argument("--train-layers", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=4,
                    help="timed steps a turn (0: no training phase)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--other-without-offsets", action="store_true",
                    help="the other source's entry points lack the four "
                         "offset ints")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch.ops._build import build_all
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = cs._card()
    print(f"card: {card}", flush=True)
    build_all()
    this = fa._kernel_fns(args.head_dim)
    other = _build_other(args.other, not args.other_without_offsets)
    swapped = SWAPPED[args.kernels]
    sides = {"this": this,
             "other": tuple(other[i] if i in swapped else this[i]
                            for i in range(3))}
    turns = ["other", "this", "this", "other"]
    parts = [p for p in ("fwd", "bwd") if p == args.kernels
             or args.kernels == "all"]

    def use(side):
        fa._kernel_fns = lambda d: sides[side]

    # 1. kernels at the training shape, chip_smoke.py's inputs
    segments, causal = MASKS[args.mask]
    rng = np.random.default_rng(args.seed + 1)
    q, k, v, do, seg = cs._flash_inputs(torch, rng, cs.TRAIN_B, cs.TRAIN_S,
                                        cs.TRAIN_S, torch.bfloat16, segments,
                                        args.head_dim)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    result = {"card": card, "other": args.other, "kernels_swapped":
              args.kernels, "mask": args.mask, "head_dim": args.head_dim,
              "kernels": {},
              "agreement": {}}
    ref_fwd = fa.flash_attention(q, k, v, return_lse=True, impl="torch", **kw)
    use("this")
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda", **kw)
    ref_bwd = fa.flash_attention_bwd(q, k, v, o, lse, do, impl="torch", **kw)
    for side in ("other", "this"):
        use(side)
        worst = {}
        if "fwd" in parts:
            got = fa.flash_attention(q, k, v, return_lse=True, impl="cuda",
                                     **kw)
            worst.update(_worst(torch, got, ref_fwd,
                                {"o": (1e-3, 1e-2), "lse": (1e-5, 1e-5)}))
        if "bwd" in parts:
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, impl="cuda",
                                         **kw)
            worst.update(_worst(torch, got, ref_bwd, {
                "dq": (1e-3, 1e-2), "dk": (1e-3, 1e-2), "dv": (1e-3, 1e-2)}))
        torch.cuda.synchronize()
        result["agreement"][side] = worst
        print(f"{side}: worst |err| / tol against the plain version "
              f"{worst}", flush=True)
        if max(worst.values()) > 1.0:
            sys.exit(f"{side}'s kernels disagree with the plain version")
        del got
    del ref_fwd, ref_bwd
    torch.cuda.empty_cache()
    keys = [key for p in parts for key in KEYS[p]]
    for i, side in enumerate(turns):
        use(side)
        t = cs._flash_times(torch, F, fa, args, q, k, v, do, seg,
                            args.head_dim ** -0.5, causal, (-1, -1), 0.0)
        keep = {key: t[key] for key in keys}
        result["kernels"][f"{i}_{side}"] = keep
        line = []
        if "fwd" in parts:
            line.append(f"fwd {keep['fwd_ms']:.4f} ms ({keep['fwd_tflops']:.1f} "
                        f"TFLOP/s, {keep['fwd_bound_share']:.3f} of its "
                        f"bound); SDPA forward {keep['library_fwd_ms']:.4f} ms")
        if "bwd" in parts:
            line.append(f"dq {keep['bwd_dq_ms']:.4f} ms, dkv "
                        f"{keep['bwd_dkv_ms']:.4f} ms, sum "
                        f"{keep['bwd_dq_ms'] + keep['bwd_dkv_ms']:.4f} ms; "
                        f"SDPA backward {keep['library_bwd_ms']:.4f} ms")
        print(f"turn {i} ({side}): " + "; ".join(line), flush=True)
    use("this")
    del q, k, v, do, seg, o, lse
    torch.cuda.empty_cache()

    # 2. the bf16 training step, kernels swapped in turns
    if args.train_steps > 0:
        from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                        accelerate, get_preset)
        from torchacc_tpu_torch.train import adamw, warmup_cosine
        cfg = get_preset("llama3-8b", num_layers=args.train_layers)
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True,
                                          gc_policy="save_attn_mlp"),
                      seed=args.seed)
        steps = 1 + args.train_steps * len(turns)
        trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
            warmup_cosine(3e-4, steps, warmup_steps=1)))
        trainer.init()
        batch = cs._train_batch(torch, np.random.default_rng(args.seed + 2),
                                cfg.vocab_size)
        result["train_step_ms"] = {}
        for i, side in enumerate(turns):
            use(side)
            trainer.step(batch)                 # warm-up on this side
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(args.train_steps + 1)]
            ev[0].record()
            for j in range(args.train_steps):
                trainer.step(batch)
                ev[j + 1].record()
            torch.cuda.synchronize()
            ms = [ev[j].elapsed_time(ev[j + 1])
                  for j in range(args.train_steps)]
            result["train_step_ms"][f"{i}_{side}"] = ms
            print(f"train turn {i} ({side}): step ms "
                  f"{', '.join(f'{x:.1f}' for x in ms)}; mean "
                  f"{sum(ms) / len(ms):.2f}", flush=True)
        use("this")
    print(f"card: {card}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
