"""One gloo rank of a multi-rank run of the PyTorch port, for
tests/test_torch_parallel_ranks.py (run as a script, never collected).

    RANK=r WORLD_SIZE=n python tests/torch_ranks_worker.py SPEC OUT

SPEC is a pickle the test wrote: the JAX weights as numpy, the model
fields, the Config pieces, the global batches and what to run.  The
rank joins the group through a file in SPEC's directory, trains
``accelerate()`` -> ``Trainer.step`` on its rows of each global batch
(``parallel.data_shard``), and rank 0 pickles the losses, the whole
final parameters (gathered by ``params_to_jax``) and the quant
histories to OUT.  Only torch, numpy and the port are imported.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torchacc_tpu_torch as tt  # noqa: E402
from torchacc_tpu_torch.data import PackedDataset  # noqa: E402
from torchacc_tpu_torch.models import get_preset, params_from_jax  # noqa
from torchacc_tpu_torch.models.convert import (  # noqa: E402
    params_to_jax,
    quant_to_jax,
)
from torchacc_tpu_torch.models.transformer import loss_sum_count  # noqa
from torchacc_tpu_torch.ops.fused import (  # noqa: E402
    fused_linear_cross_entropy_tp,
)
from torchacc_tpu_torch.parallel import (  # noqa: E402
    data_shard,
    initialize_distributed,
)
from torchacc_tpu_torch.train import (  # noqa: E402
    accelerate,
    adamw,
    shift_labels,
    warmup_cosine,
)


def bomb_loss(logits, batch):
    """The loss times 3e38 squared (inf in f32) where any of this
    rank's rows has ``bomb`` set."""
    labels = shift_labels(batch["input_ids"], batch.get("segment_ids"))
    l_sum, count = loss_sum_count(logits, labels)
    bomb = torch.where((batch["bomb"] > 0).any(), 3e38, 1.0)
    return l_sum * bomb * bomb, count


def _local_digest(trainer):
    return [p.to_local().clone() for p in trainer.state.params.values()]


def train(spec):
    dtype = spec["dtype"]
    cfg = get_preset("llama-tiny", dtype=dtype, **spec["model"])
    model = params_from_jax(cfg, spec["params"], device="cpu",
                            trainable=True)
    d = spec["dist"]
    conf = tt.Config(
        compute=tt.ComputeConfig(dtype=dtype, **spec["compute"]),
        memory=tt.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=tt.DistConfig(dp=tt.DPConfig(d.get("dp", -1)),
                           fsdp=tt.FSDPConfig(d.get("fsdp", 1)),
                           tp=tt.TPConfig(d.get("tp", 1))),
        grad_accum=spec["grad_accum"])
    n, i = data_shard(conf.get_mesh("cpu"))
    dataset = None
    if "docs" in spec:
        # this rank's rows of the global batches, as a user feeds them
        dataset = PackedDataset(spec["docs"], num_shards=n, shard_index=i,
                                **spec["dataset"])
    trainer, loader = accelerate(
        model, dataset, conf,
        optimizer=adamw(warmup_cosine(*spec["schedule"]), **spec["opt"]),
        loss=bomb_loss if spec.get("bomb") else None)
    trainer.init()
    out = {"losses": [], "norms": [], "scales": [], "skipped": []}
    if loader is not None:
        hist = trainer.fit(loader, max_steps=spec["steps"], log_every=1)
        out["losses"] = [r["loss"] for r in hist]
        spec = dict(spec, batches=[])
    for b in spec["batches"]:
        rows = b["input_ids"].shape[0] // n
        local = {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
        before = _local_digest(trainer)
        m = trainer.step(local)
        after = _local_digest(trainer)
        out["losses"].append(m["loss"].item())
        out["norms"].append(m["grad_norm"].item())
        if "loss_scale" in m:
            out["scales"].append(m["loss_scale"].item())
        unchanged = all(torch.equal(a, c) for a, c in zip(before, after))
        flags = [None] * dist.get_world_size()
        dist.all_gather_object(flags, unchanged)
        out["skipped"].append(flags)
    out["data_shard"] = (n, i)
    out["count"] = trainer.state.opt_state.count
    out["params"] = params_to_jax(trainer.model.cfg,
                                  dict(trainer.model.named_parameters()))
    if trainer.state.quant is not None:
        out["quant"] = quant_to_jax(trainer.model.cfg, trainer.state.quant)
    return out


def fused_ce_tp(spec):
    """The vocab-parallel fused CE on this rank's head slice: the loss
    sum and count, d(hidden) and this rank's slice of d(w)."""
    tp = dist.get_world_size()
    r = dist.get_rank()
    x = torch.tensor(spec["hidden"], requires_grad=True)
    w_full = spec["w"]
    v = w_full.shape[1] // tp
    w = torch.tensor(w_full[:, r * v:(r + 1) * v], requires_grad=True)
    loss, count = fused_linear_cross_entropy_tp(
        x, w, torch.tensor(spec["labels"]), group=dist.group.WORLD,
        chunk_rows=spec["chunk_rows"], logit_softcap=spec["cap"])
    loss.backward()
    dws = [None] * tp
    dist.all_gather_object(dws, w.grad.numpy())
    return {"loss": loss.item(), "count": count.item(),
            "dx": x.grad.numpy(), "dw": np.concatenate(dws, axis=1)}


def main(spec_path, out_path):
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    store = os.path.join(os.path.dirname(spec_path), "pg_store")
    initialize_distributed(f"file://{store}", device="cpu")
    try:
        out = (fused_ce_tp if spec["kind"] == "fused_ce" else train)(spec)
        if dist.get_rank() == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
