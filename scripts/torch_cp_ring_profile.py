#!/usr/bin/env python3
"""Split the device time of context parallelism's ring on one NVIDIA
card (the PyTorch/CUDA port, ``torchacc_tpu_torch/ops/context_parallel``).

    python3 scripts/torch_cp_ring_profile.py [--ring 4] [--seq 32768] \
        [--seed 0] [--out cp_ring_profile]

The shape is chip_smoke.py's context-parallelism phase: Llama-3-8B's
attention (32 q / 8 kv heads of 128, bf16, b 1) over --seq tokens of
packed documents of 256-4096 tokens, causal, dropout 0.1.  The ring's
schedule runs over --ring virtual ranks on the card
(``tests/torch_cp_virtual.py``: the package's ``ring_fwd``/``ring_bwd``
over a ``VirtualRing``), once to warm up and then under
``torch.profiler``, forward alone and forward + backward, beside one
whole B1 (and B2/B3) call on the same inputs.  Each part of the ring
runs under a ``record_function`` range of its own, and the device time
of the kernels that a range launched is read from the profile:

- ``cp::step_fwd`` / ``cp::step_bwd``: the steps' flash calls (B1, and
  B2 + B3 with the backward's row-sum pass);
- ``cp::merge``: ``merge_attention``, the LSE merges in f32;
- ``cp::kv_at`` / ``cp::grad_to``: the ring's moves (here indexing and
  the dk/dv sums into their source chunk; on a mesh the hops);
- the rest of ``cp::ring_fwd`` / ``cp::ring_bwd``: the loop's own work
  (the partials' casts to f32, the output's cast, dq's sum);
- outside the ring functions: the emulation's moves (head and chunk
  slices, the output written into the whole tensor), which a rank on a
  mesh does not make.

Prints the card's name and power limit, one line per split, and one
JSON object as the last line; writes the profile tables under --out.
Needs one card.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANGES = ("cp::ring_fwd", "cp::ring_bwd", "cp::step_fwd", "cp::step_bwd",
          "cp::merge", "cp::kv_at", "cp::grad_to", "cp::virtual",
          "whole::fwd", "whole::bwd")


def _ranged(torch, name, fn):
    @functools.wraps(fn)
    def run(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return run


def _patch(torch, ring_mod, virtual_mod):
    """Wrap the ring's parts in ranges (module attributes the loops call
    by name); returns a function that undoes it."""
    saved = []

    def put(mod, attr, name):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, _ranged(torch, name, fn))
    put(ring_mod, "ring_step_fwd", "cp::step_fwd")
    put(ring_mod, "ring_step_bwd", "cp::step_bwd")
    put(ring_mod, "merge_attention", "cp::merge")
    put(virtual_mod, "ring_fwd", "cp::ring_fwd")
    put(virtual_mod, "ring_bwd", "cp::ring_bwd")
    rank = ring_mod.VirtualRing.rank

    def ranged_rank(self, me):
        kv_at, grad_to = rank(self, me)
        return (_ranged(torch, "cp::kv_at", kv_at),
                _ranged(torch, "cp::grad_to", grad_to))
    ring_mod.VirtualRing.rank = ranged_rank

    def undo():
        ring_mod.VirtualRing.rank = rank
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def _kernel_ms(evt):
    """Device ms of the kernels that ``evt`` (a CPU op or range) and the
    CPU ops under it launched (the GPU-side copies of the ranges are
    not counted)."""
    from torch.autograd import DeviceType
    own = sum(k.duration for k in evt.kernels) / 1e3
    return own + sum(_kernel_ms(c) for c in evt.cpu_children
                     if c.device_type == DeviceType.CPU)


def _profiled(torch, cs, fn, out_dir, tag):
    """Run ``fn`` once under the profiler: ({range: device ms of the
    kernels launched inside it}, {kernel group: device ms}, device busy
    ms (the groups' sum), wall ms).  A range inside ``cp::ring_fwd`` or ``cp::ring_bwd`` is
    keyed ``name@ring_fwd`` / ``name@ring_bwd``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ranges = {}
    for e in prof.events():
        if e.name not in RANGES or e.device_type != DeviceType.CPU:
            continue
        key, up = e.name, e.cpu_parent
        while up is not None:
            if up.name in ("cp::ring_fwd", "cp::ring_bwd"):
                key = f"{e.name}@{up.name[4:]}"
                break
            up = up.cpu_parent
        ranges[key] = ranges.get(key, 0.0) + _kernel_ms(e)
    # device rows by kernel name; the ranges' own GPU-side rows span
    # their kernels and are left out
    _, _, groups = cs._device_groups(prof, lambda name: (
        "range" if name in RANGES
        else "flash (B1-B3)" if "::fwd_" in name or "::bwd_d" in name
        else cs._serving_group(name)))
    groups.pop("range", None)
    busy = sum(groups.values())
    with open(os.path.join(out_dir, f"{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    return ranges, groups, busy, wall


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "cp_ring_profile"))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_cp_ring_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as cs
    import torch_cp_virtual as virtual_mod
    import torchacc_tpu_torch.ops.context_parallel.ring as ring_mod
    import torchacc_tpu_torch.ops.flash_attention as fa
    from torchacc_tpu_torch.ops import _build
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(args.seed + 12)
    q, k, v, do, _ = cs._flash_inputs(torch, rng, 1, args.seq, args.seq,
                                      torch.bfloat16, False)
    seg = segment_ids_from_positions(torch.from_numpy(
        cs._packed_positions(rng, 1, args.seq, 256, 4096))).cuda()
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg,
              dropout_p=0.1, dropout_seed=2024)

    def ring(grads):
        with torch.profiler.record_function("cp::virtual"):
            virtual_mod.virtual_cp_attention(
                q, k, v, do if grads else None, ring_n=args.ring,
                impl="cuda", **kw)

    def whole(grads):
        with torch.profiler.record_function("whole::fwd"):
            o, lse = fa.flash_attention(q, k, v, return_lse=True,
                                        impl="cuda", **kw)
        if grads:
            with torch.profiler.record_function("whole::bwd"):
                fa.flash_attention_bwd(q, k, v, o, lse, do, impl="cuda",
                                       **kw)

    undo = _patch(torch, ring_mod, virtual_mod)
    result = {"card": card, "ring": args.ring, "seq": args.seq}
    try:
        for grads in (False, True):
            tag = "fwd_bwd" if grads else "fwd"
            for fn in (ring, whole):       # warm-up
                fn(grads)
            r, groups, busy, wall = _profiled(
                torch, cs, lambda: ring(grads), args.out, f"ring_{tag}")
            w, wgroups, wbusy, wwall = _profiled(
                torch, cs, lambda: whole(grads), args.out, f"whole_{tag}")
            split = {"ring_busy_ms": busy, "ring_wall_ms": wall,
                     "whole_busy_ms": wbusy, "whole_wall_ms": wwall}
            split.update({f"ring {g} ms": ms for g, ms in groups.items()})
            split.update({f"whole {g} ms": ms for g, ms in wgroups.items()})
            split.update({f"{key} ms": ms for key, ms in sorted(r.items())})
            split.update({f"{key} ms": ms for key, ms in sorted(w.items())})
            get = lambda key: r.get(key, 0.0)
            split["fwd loop rest ms"] = (
                get("cp::ring_fwd") - get("cp::step_fwd@ring_fwd")
                - get("cp::merge@ring_fwd") - get("cp::kv_at@ring_fwd"))
            split["bwd loop rest ms"] = (
                get("cp::ring_bwd") - get("cp::step_bwd@ring_bwd")
                - get("cp::kv_at@ring_bwd") - get("cp::grad_to@ring_bwd"))
            split["emulation ms"] = (get("cp::virtual") - get("cp::ring_fwd")
                                     - get("cp::ring_bwd"))
            result[tag] = split
            print(f"cp ring profile {tag}: " + ", ".join(
                f"{key} {val:.3f}" for key, val in split.items()),
                flush=True)
    finally:
        undo()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
