#!/usr/bin/env python3
"""Pipeline parallelism of the PyTorch port over NCCL, one process a card.

    python3 scripts/torch_pp_cards.py [--cards 4] [--layers 8] [--micro 8]
                                      [--steps 10] [--shard-layers 32]
                                      [--seed 0]

Starts ``--cards`` processes as torchrun would (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR=localhost and a free MASTER_PORT), each holding
one stage of llama3-8b at full width and ``--layers`` deep (bf16 over
f32 masters, save_attn_mlp, adamw), and trains ``--steps`` steps, each
on its own numpy-seeded batch of ``--micro`` rows of 4096 packed
tokens, through ``accelerate()`` -> ``Trainer.step`` under 'gpipe' and
then '1f1b' (``--micro`` micro-batches, one row each): activations and
cotangents go between the cards by NCCL P2P (``parallel/pp.py``
``ProcessGroupTransport``).  Then this process trains the same model,
weights and batches on one card unpipelined (grad_accum = ``--micro``)
as the reference.

Before that each card shards a ``meta`` llama3-8b of ``--shard-layers``
blocks (its full depth by default) the way ``Trainer.init`` does
(``shard_model`` with the seeded ``materializer``) and reads its peak:
the stage makes every block, to keep the one-device random stream, but
holds only its own and at most one other at once.  FSDP2 copies each
unit's parameters into its sharded storage, so the peak also holds one
unit twice: a block, or the root's embedding, final norm and head.

Checks: every loss finite; each schedule's losses within a relative
1e-3 of the one-card run's (bf16 compute, f32 sums over the stages'
ranks in another order); each stage's sharding peak at most the bytes
of its own parameters, plus the larger of one block's and the root's,
plus 256 MiB (a stage that held every block would exceed it at the
full depth).  Prints, beside the
card's name and power limit: each schedule's step ms (CUDA events, the
mean of the steps after the first) and peak memory of each stage, the
one-card step ms, the bubble the schedule implies, (P - 1) / (M + P -
1), and by stage the sharding peak, the peak of ``accelerate()`` and
``Trainer.init`` together and the bytes held after them.  The last line
is a JSON object of the numbers.  Needs ``--cards`` cards; exits
non-zero where there are fewer, or a check fails.
"""

import argparse
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_S = 4096


def _batch(torch, seed, rows, vocab):
    import numpy as np
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    rng = np.random.default_rng(seed)
    pos = []
    for _ in range(rows):
        p = []
        while len(p) < ROWS_S:
            p += list(range(int(rng.integers(256, 2048))))
        pos.append(p[:ROWS_S])
    pos = torch.tensor(pos, dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(0, vocab, size=(rows, ROWS_S)))
    return {"input_ids": ids.cuda(), "positions": pos.cuda(),
            "segment_ids": segment_ids_from_positions(pos).cuda()}


def _config(args, dist_cfg, grad_accum, layers=None):
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    get_preset)
    cfg = get_preset("llama3-8b", num_layers=layers or args.layers)
    conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  dist=dist_cfg, grad_accum=grad_accum, seed=args.seed)
    return cfg, conf


def _shard_peak(torch, args, dist_cfg):
    """(peak bytes while a ``meta`` model of ``--shard-layers`` blocks is
    made and sharded as ``Trainer.init`` does it, bytes of the stage's
    parameters after, f32 bytes of one block, of the root's parameters,
    of every block)."""
    from torchacc_tpu_torch.models.transformer import (TransformerLM,
                                                       materializer)
    from torchacc_tpu_torch.ops._common import to_local
    from torchacc_tpu_torch.parallel.sharding import shard_model
    from torchacc_tpu_torch.train.accelerate import apply_config_to_model
    cfg, conf = _config(args, dist_cfg, 1, layers=args.shard_layers)
    model = TransformerLM(apply_config_to_model(cfg, conf), device="meta",
                          dtype=torch.float32)
    nbytes = lambda m: sum(p.numel() * 4 for p in m.parameters())
    block, every = nbytes(model.layers[0]), nbytes(model.layers)
    root = nbytes(model) - every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shard_model(model, conf.get_mesh(), conf,
                materializer(args.seed, torch.device("cuda")))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    held = sum(to_local(p).numel() * 4 for p in model.parameters())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return peak, held, block, root, every


def _train(torch, args, dist_cfg, grad_accum):
    """(losses, step ms after the first, peak bytes of the steps, peak
    bytes of accelerate() and init, bytes held after them) of
    ``--steps`` steps."""
    from torchacc_tpu_torch import accelerate
    from torchacc_tpu_torch.train import adamw, warmup_cosine
    cfg, conf = _config(args, dist_cfg, grad_accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
        warmup_cosine(3e-4, args.steps, warmup_steps=1)))
    trainer.init()
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    init_held = torch.cuda.memory_allocated()
    batches = [_batch(torch, args.seed + 5 + i, args.micro, cfg.vocab_size)
               for i in range(args.steps)]
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(args.steps + 1)]
    losses = []
    ev[0].record()
    for i in range(args.steps):
        losses.append(trainer.step(batches[i])["loss"])
        ev[i + 1].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(args.steps)]
    out = ([x.item() for x in losses], sum(ms[1:]) / (args.steps - 1),
           torch.cuda.max_memory_allocated(), init_peak, init_held)
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank(args):
    import torch
    import torch.distributed as dist
    from torchacc_tpu_torch import DistConfig, PPConfig
    from torchacc_tpu_torch.parallel import initialize_distributed
    initialize_distributed()
    out = {}
    pp = lambda schedule: DistConfig(pp=PPConfig(
        size=args.cards, num_micro_batches=args.micro, schedule=schedule))

    def by_stage(x):
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, x)
        return got
    try:
        peak, held, block, root, every = _shard_peak(torch, args,
                                                     pp("gpipe"))
        out["shard"] = {"layers": args.shard_layers,
                        "peak_bytes_by_stage": by_stage(peak),
                        "held_bytes_by_stage": by_stage(held),
                        "block_bytes": block, "root_bytes": root,
                        "every_block_bytes": every}
        for schedule in ("gpipe", "1f1b"):
            losses, ms, peak, init_peak, init_held = _train(
                torch, args, pp(schedule), 1)
            out[schedule] = {"losses": losses, "step_ms": ms,
                             "peak_bytes_by_stage": by_stage(peak),
                             "init_peak_bytes_by_stage": by_stage(init_peak),
                             "init_held_bytes_by_stage": by_stage(init_held)}
        if dist.get_rank() == 0:
            with open(args.out, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--shard-layers", type=int, default=32,
                    help="depth of the model whose sharding peak is read")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the card processes may take")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if "RANK" in os.environ:
        _rank(args)
        return 0

    import torch
    if torch.cuda.device_count() < args.cards:
        print(f"torch_pp_cards: {args.cards} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(f"cards: {card}", flush=True)
    from torchacc_tpu_torch.ops import _build
    _build.build_all()
    # where rank 0 leaves the pipelined runs' numbers
    out_dir = tempfile.mkdtemp(prefix="pp_cards_")
    out_path = os.path.join(out_dir, "pipelined.json")
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for r in range(args.cards):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.cards),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--out", out_path]
            + [f"--{k}={v}" for k, v in (
                ("cards", args.cards), ("layers", args.layers),
                ("micro", args.micro), ("steps", args.steps),
                ("shard-layers", args.shard_layers),
                ("seed", args.seed))], env=env))
    try:
        codes = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(f"torch_pp_cards: a card process failed: exit codes {codes}",
              file=sys.stderr)
        return 1
    print(f"cards: the pipelined runs took {time.perf_counter() - t0:.1f} s",
          flush=True)
    with open(out_path) as f:
        got = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    from torchacc_tpu_torch import DistConfig
    ref_losses, ref_ms, ref_peak, ref_init_peak, _ = _train(
        torch, args, DistConfig(), args.micro)
    P, M = args.cards, args.micro
    gib = lambda xs: [round(b / 2**30, 3) for b in xs]
    shard = got.pop("shard")
    twice = max(shard["block_bytes"], shard["root_bytes"])
    limits = [h + twice + 256 * 2**20 for h in shard["held_bytes_by_stage"]]
    shard["ok"] = all(p <= lim for p, lim in
                      zip(shard["peak_bytes_by_stage"], limits))
    ok = shard["ok"]
    print(f"sharding {shard['layers']} layers on {P} cards: peak by stage "
          f"{gib(shard['peak_bytes_by_stage'])} GiB against the stage's "
          f"parameters {gib(shard['held_bytes_by_stage'])} plus "
          f"{twice / 2**30:.3f} (the larger of one block, "
          f"{shard['block_bytes'] / 2**30:.3f}, and the root, "
          f"{shard['root_bytes'] / 2**30:.3f}) and 0.25 (limit; every "
          f"block {shard['every_block_bytes'] / 2**30:.3f}): "
          f"{'ok' if shard['ok'] else 'OVER'}; cards: {card}", flush=True)
    for schedule, r in got.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                      ref_losses))
        r["max_rel_loss_diff"] = rel
        finite = all(x == x and abs(x) != float("inf") for x in r["losses"])
        ok = ok and finite and rel <= 1e-3
        print(f"pipeline on {P} cards, {schedule}, M {M}: losses "
              f"{[round(x, 5) for x in r['losses']]} against one card's "
              f"{[round(x, 5) for x in ref_losses]} (largest relative "
              f"difference {rel:.3g}, limit 1e-3); step {r['step_ms']:.1f} "
              f"ms against {ref_ms:.1f} ms on one card unpipelined "
              f"({ref_ms / r['step_ms']:.2f}x faster); peak by stage "
              f"{[round(b / 2**30, 2) for b in r['peak_bytes_by_stage']]} "
              f"GiB against {ref_peak / 2**30:.2f}; accelerate() and init "
              f"peak by stage {gib(r['init_peak_bytes_by_stage'])} GiB, "
              f"held after {gib(r['init_held_bytes_by_stage'])}, against "
              f"{ref_init_peak / 2**30:.2f} on one card; the schedule's "
              f"bubble (P-1)/(M+P-1) = {(P - 1) / (M + P - 1):.3f}; "
              f"cards: {card}", flush=True)
    print(json.dumps({"cards": card, "pp": P, "micro": M,
                      "layers": args.layers, "tokens_a_step": M * ROWS_S,
                      "one_card": {"losses": ref_losses, "step_ms": ref_ms,
                                   "peak_bytes": ref_peak,
                                   "init_peak_bytes": ref_init_peak},
                      "shard": shard, "schedules": got, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
