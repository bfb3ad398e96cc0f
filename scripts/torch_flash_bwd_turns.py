#!/usr/bin/env python3
"""Time the flash-attention backward kernels of the PyTorch/CUDA port
(B2 dq and B3 dk/dv, torchacc_tpu_torch/csrc/flash_attention.cu)
against another version of that source, in turns, on one NVIDIA card.

    git show <rev>:torchacc_tpu_torch/csrc/flash_attention.cu > other.cu
    python3 scripts/torch_flash_bwd_turns.py --other other.cu \
        [--reps 50] [--train-layers 8] [--train-steps 4] [--seed 0]

The other source must have the same C interface.  It is compiled by
nvcc (sm_90a, the port's flags) into a library of its own name; its
backward entry points are swapped in under ops/flash_attention.py, so
both sides run the same wrappers, the same forward kernel and the same
inputs.  Phases, every measurement in turns (other, this, this, other):

1. kernels: chip_smoke.py's flash training shape (b 2, s 4096, 32 q /
   8 kv heads of 128, bf16, causal, packed documents from the same
   seed), each side's B2 and B3 against the plain backward at the
   card's one-ulp bf16 tolerance, then chip_smoke.py's _flash_times on
   each side: kernel ms (CUDA events), SDPA's backward in the same call,
   the bound, achieved TFLOP/s;
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


def _bind(lib):
    """The backward entry points of a flash-attention library, typed as
    ops/flash_attention.py types them."""
    dq, dkv = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
    tail = ([ctypes.c_int] * 9 + [ctypes.c_float] * 2
            + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
            + [ctypes.c_int, ctypes.c_void_p])
    dq.argtypes = [ctypes.c_void_p] * 10 + tail
    dkv.argtypes = [ctypes.c_void_p] * 11 + tail
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _build_other(path):
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
    return _bind(ctypes.CDLL(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="another csrc/flash_attention.cu to time against")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--train-layers", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=4,
                    help="timed steps a turn (0: no training phase)")
    ap.add_argument("--seed", type=int, default=0)
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
    this = fa._kernel_fns()
    other_dq, other_dkv = _build_other(args.other)
    sides = {"this": this, "other": (this[0], other_dq, other_dkv)}
    turns = ["other", "this", "this", "other"]

    def use(side):
        fa._kernel_fns = lambda: sides[side]

    # 1. kernels at the training shape, chip_smoke.py's inputs
    rng = np.random.default_rng(args.seed + 1)
    q, k, v, do, seg = cs._flash_inputs(torch, rng, cs.TRAIN_B, cs.TRAIN_S,
                                        cs.TRAIN_S, torch.bfloat16, True)
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda", **kw)
    ref = fa.flash_attention_bwd(q, k, v, o, lse, do, impl="torch", **kw)
    result = {"card": card, "other": args.other, "kernels": {},
              "agreement": {}}
    for side in ("other", "this"):
        use(side)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, impl="cuda", **kw)
        torch.cuda.synchronize()
        worst = {}
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - r.float()).abs()
            worst[name] = (err / (1e-3 + 1e-2 * r.float().abs())).max().item()
        result["agreement"][side] = worst
        print(f"{side}: worst |err| / one-ulp tol against the plain "
              f"backward {worst}", flush=True)
        if max(worst.values()) > 1.0:
            sys.exit(f"{side}'s backward kernels disagree with the plain "
                     f"backward")
        del got
    del ref
    torch.cuda.empty_cache()
    for i, side in enumerate(turns):
        use(side)
        t = cs._flash_times(torch, F, fa, args, q, k, v, do, seg,
                            cs.D ** -0.5, True, (-1, -1), 0.0)
        keep = {key: t[key] for key in (
            "bwd_dq_ms", "bwd_dkv_ms", "library_bwd_ms", "bwd_dq_tflops",
            "bwd_dkv_tflops", "bwd_dq_bound_ms", "bwd_dkv_bound_ms",
            "bwd_dq_bound_share", "bwd_dkv_bound_share")}
        result["kernels"][f"{i}_{side}"] = keep
        print(f"turn {i} ({side}): dq {keep['bwd_dq_ms']:.4f} ms, dkv "
              f"{keep['bwd_dkv_ms']:.4f} ms, sum "
              f"{keep['bwd_dq_ms'] + keep['bwd_dkv_ms']:.4f} ms; SDPA "
              f"backward {keep['library_bwd_ms']:.4f} ms", flush=True)
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
