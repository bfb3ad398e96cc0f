"""One gloo rank of a multi-rank run of the PyTorch port, for
tests/test_torch_parallel_ranks.py (run as a script, never collected).

    RANK=r WORLD_SIZE=n python tests/torch_ranks_worker.py SPEC OUT

SPEC is a pickle the test wrote: the JAX weights as numpy, the model
fields, the Config pieces, the global batches and what to run.  The
rank joins the group through a file in SPEC's directory, trains
``accelerate()`` -> ``Trainer.step`` on its rows of each global batch
(``parallel.data_shard``), and rank 0 pickles the losses, the whole
final parameters (gathered by ``params_to_jax``) and the quant
histories to OUT.  For tests/test_torch_checkpoint_ranks.py it saves
checkpoints on the mesh and resumes them by consensus
(``ckpt_save``), or restores one into another layout
(``ckpt_restore``); the ``ckpt_save`` launch also trains a Hugging Face
checkpoint directory through ``accelerate(path)`` on another layout of
the same processes (``hf_train``).  For tests/test_torch_cp_ranks.py one
launch runs several cases in turn (``cases``): ``cp_attention`` on its
chunk of seeded inputs (``cp_attn``), and context-parallel training
(``train`` with ``dist["sp"]``), which also counts the ring's forward
steps.  For tests/test_torch_pp_ranks.py the same ``cases`` launch
trains under 'pp' (``train`` with ``dist["pp"]``; the stages' blocks
put together for the result; ``eval_batch`` for an ``eval_step``;
``decode`` for the pipelined decode before the steps),
saves and resumes a pipelined run (``train`` with ``ckpt``),
streams a Hugging Face directory into the stages (``hf_train``) and
notes which blocks a stage makes while it shards (``pp_init``).  Only torch, numpy and the port are
imported.
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
    warmup_linear,
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


def _dist_config(d):
    return tt.DistConfig(dp=tt.DPConfig(d.get("dp", -1)),
                         fsdp=tt.FSDPConfig(d.get("fsdp", 1)),
                         tp=tt.TPConfig(d.get("tp", 1)),
                         sp=tt.SPConfig(**d.get("sp", {})),
                         pp=tt.PPConfig(**d.get("pp", {})),
                         ep=tt.EPConfig(**d.get("ep", {})))


class _RingSteps:
    """Counts the flash forward calls of the ring's steps."""

    def __init__(self):
        import torchacc_tpu_torch.ops.context_parallel.ring as ring
        self.ring, self.calls = ring, 0
        self.inner = ring.flash_attention

        def counted(*a, **kw):
            self.calls += 1
            return self.inner(*a, **kw)
        ring.flash_attention = counted

    def close(self):
        self.ring.flash_attention = self.inner


def train(spec):
    dtype = spec["dtype"]
    cfg = get_preset("llama-tiny", dtype=dtype, **spec["model"])
    model = params_from_jax(cfg, spec["params"], device="cpu",
                            trainable=True)
    conf = tt.Config(
        compute=tt.ComputeConfig(dtype=dtype, **spec["compute"]),
        memory=tt.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=_dist_config(spec["dist"]),
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
    if "ckpt" in spec:
        return pp_ckpt(spec, trainer, n, i)
    out = {"losses": [], "norms": [], "scales": [], "skipped": []}
    if "decode" in spec:
        out["decode"] = pp_decode(spec["decode"], trainer)
    steps = _RingSteps()
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
    if "eval_batch" in spec:
        b = spec["eval_batch"]
        rows = b["input_ids"].shape[0] // n
        out["eval"] = trainer.eval_step(
            {k: v[i * rows:(i + 1) * rows] for k, v in b.items()}
        )["loss"].item()
    steps.close()
    out["ring_fwd_calls"] = _gathered(steps.calls)
    out["data_shard"] = (n, i)
    out["count"] = trainer.state.opt_state.count
    out["params"] = _all_params(trainer)
    if trainer.state.quant is not None:
        out["quant"] = quant_to_jax(trainer.model.cfg, trainer.state.quant)
    return out


def pp_decode(spec, trainer):
    """Before any step: ``generate()`` of the ragged prompts on the
    trainer's model over its mesh, and one prefill pass of them through
    the decode's pipeline.  By rank: the stage, the tokens, the prefill
    hidden (the last stage's output, shared with every stage), the
    layers of the blocks this rank holds and of the cache it kept."""
    import importlib
    from torchacc_tpu_torch.parallel.mesh import pp_stage
    from torchacc_tpu_torch.parallel.pp import decode_pipeline
    gen = importlib.import_module("torchacc_tpu_torch.models.generate")
    model, mesh = trainer.model, trainer.mesh
    ids, mask = torch.from_numpy(spec["ids"]), torch.from_numpy(spec["mask"])
    ring = decode_pipeline(mesh, model.cfg.pp_virtual, model.device)
    toks = gen.generate(model, ids, prompt_mask=mask,
                        max_new_tokens=spec["new"], pipeline=ring)
    b, p = ids.shape
    with torch.no_grad(), gen._decode_weights(model, None) as m:
        positions, _, seg = gen.prompt_geometry(ids, mask.to(torch.int32))
        forward = gen._Decoder(m, ring, b, p + spec["new"], ids.device,
                               seg, "torch")
        hidden = forward(ids, positions, 0)
    return _gathered({"stage": pp_stage(mesh)[1], "tokens": toks.numpy(),
                      "hidden": hidden.numpy(),
                      "blocks": sorted(i for i, _ in model.layers.items()),
                      "cache": sorted(forward.cache.k)})


def _all_params(trainer):
    """The whole model's parameters in the flax layout: each rank's
    whole tensors (``full_tensor`` over its stage's data and 'tp'
    ranks), the pipeline stages' blocks put together (a collective)."""
    from torch.distributed.tensor import DTensor
    named = {n: (p.full_tensor() if isinstance(p, DTensor) else p)
             .detach().clone()
             for n, p in trainer.model.named_parameters()}
    if trainer.config.dist.pp.size > 1:
        merged = {}
        for part in _gathered(named):
            merged.update(part)
        named = merged
    return params_to_jax(trainer.model.cfg, named)


def pp_ckpt(spec, trainer, n, i):
    """Under 'pp': 3 steps with the state saved after step 2 by a
    CheckpointManager, then a trainer made from other weights restores
    step 2 and takes step 3, which must give the same bits; the same
    processes without 'pp' must refuse the checkpoint."""
    from torchacc_tpu_torch.checkpoint import CheckpointManager
    rows = lambda b: {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                      for k, v in b.items()}
    mgr = CheckpointManager(spec["ckpt"])
    losses = []
    for step, b in enumerate(spec["batches"], start=1):
        losses.append(trainer.step(rows(b))["loss"].item())
        if step == 2:
            assert mgr.save(step, trainer.state)
            mgr.wait_until_finished()
    mgr.close()
    whole = _full_state(trainer)
    other = train_like(spec, spec["params_other"], spec["dist"])
    mgr = CheckpointManager(spec["ckpt"])
    mgr.restore(other.state, step=2)
    resumed = other.step(rows(spec["batches"][2]))["loss"].item()
    same = (resumed == losses[2] and all(
        np.array_equal(a, whole[k]) for k, a in _full_state(other).items()))
    out = {"losses": losses, "resumed_equal": _gathered(same)}
    flat = train_like(spec, spec["params"], spec["other_dist"])
    try:
        CheckpointManager(spec["ckpt"]).restore(flat.state, step=2)
        out["other_layout"] = "restored"
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        out["other_layout"] = (type(e).__name__, getattr(e, "axes", None))
    return out


def train_like(spec, params, d):
    """A trainer of ``spec``'s model, config and optimizer on the layout
    ``d``, from ``params``."""
    cfg = get_preset("llama-tiny", dtype=spec["dtype"], **spec["model"])
    conf = tt.Config(
        compute=tt.ComputeConfig(dtype=spec["dtype"], **spec["compute"]),
        memory=tt.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=_dist_config(d), grad_accum=spec["grad_accum"])
    trainer, _ = accelerate(
        params_from_jax(cfg, params, device="cpu", trainable=True), None,
        conf, optimizer=adamw(warmup_cosine(*spec["schedule"]),
                              **spec["opt"]))
    trainer.init()
    return trainer


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


def cp_attn(spec):
    """``cp_attention`` of this rank's chunk (batch over the data axes,
    sequence over ('sp', 'spu'), heads over 'tp') of the seeded whole
    inputs, forward and backward; rank 0 assembles the whole output and
    gradients from every rank's chunk."""
    from torchacc_tpu_torch.ops.context_parallel import cp_attention
    from torchacc_tpu_torch.parallel import describe_mesh, seq_shard
    mesh = tt.Config(dist=_dist_config(spec["dist"])).get_mesh("cpu")
    nd, di = data_shard(mesh)
    nc, c = seq_shard(mesh)
    nt, ti = describe_mesh(mesh)["tp"], mesh.get_local_rank("tp")
    q, k, v, do = (torch.from_numpy(spec[x]) for x in ("q", "k", "v", "do"))
    bl, w = q.shape[0] // nd, q.shape[1] // nc

    def part(t, di=di, c=c, ti=ti):
        """The rows, chunk and (of a [b, s, h, d] tensor) heads of rank
        (di, c, ti)."""
        t = t[di * bl:(di + 1) * bl, c * w:(c + 1) * w]
        if t.ndim == 4:
            hl = t.shape[2] // nt
            t = t[:, :, ti * hl:(ti + 1) * hl]
        return t
    q_, k_, v_ = (part(t).contiguous().requires_grad_() for t in (q, k, v))
    kw = dict(spec["kw"])
    if "seg" in spec:
        seg = part(torch.from_numpy(spec["seg"])).contiguous()
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    if "slopes" in spec:
        # this rank's heads' slopes
        hl = q.shape[2] // nt
        kw["alibi_slopes"] = torch.from_numpy(
            spec["slopes"][ti * hl:(ti + 1) * hl])
    out = cp_attention(q_, k_, v_, mesh=mesh, impl="torch", **kw)
    out.backward(part(do).contiguous())
    mine = (di, c, ti, [t.detach().numpy() for t in
                        (out, q_.grad, k_.grad, v_.grad)])
    full = {}
    for di_, c_, ti_, arrs in _gathered(mine):
        for name, a, ref in zip(("o", "dq", "dk", "dv"), arrs,
                                (q, q, k, v)):
            whole = full.setdefault(name, np.zeros(ref.shape, np.float32))
            part(torch.from_numpy(whole), di_, c_, ti_).copy_(
                torch.from_numpy(a))
    return full


def pp_init(spec):
    """``shard_model`` of a ``meta`` model on ``spec["dist"]``'s mesh,
    with a materializer that notes, at each call, its prefix and how
    many other stages' blocks hold storage; once drawing the seeded
    weights (``draws``) and once giving storage only, as a checkpoint's
    load does.  By rank: the stage, the prefixes made, the most other
    blocks alive before a call, those alive after, and (seeded) whether
    this stage's blocks equal the one-device ``init_params``' bitwise."""
    from torch.distributed.tensor import DTensor
    from torchacc_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
        materializer,
    )
    from torchacc_tpu_torch.parallel.mesh import pp_stage
    from torchacc_tpu_torch.parallel.pp import stage_layers
    from torchacc_tpu_torch.parallel.sharding import shard_model
    from torchacc_tpu_torch.train.accelerate import apply_config_to_model
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32),
                     dist=_dist_config(spec["dist"]))
    cfg = apply_config_to_model(
        get_preset("llama-tiny", dtype=torch.float32, **spec["model"]),
        conf)
    mesh = conf.get_mesh("cpu")
    n_pp, stage = pp_stage(mesh)
    owned = {i for r in stage_layers(cfg.num_layers, n_pp, cfg.pp_virtual,
                                     stage) for i in r}
    cpu = torch.device("cpu")
    out = {"stage": stage}
    for draws in (True, False):
        model = TransformerLM(cfg, device="meta", dtype=torch.float32)
        blocks = list(model.layers)
        live = lambda: sum(1 for i, b in enumerate(blocks) if i not in owned
                           and not next(b.parameters()).is_meta)
        inner = (materializer(0, cpu) if draws else
                 lambda module, prefix: module.to_empty(device=cpu))
        made, most = [], [0]

        def make(module, prefix, inner=inner, made=made, most=most):
            most[0] = max(most[0], live())
            made.append(prefix)
            inner(module, prefix)
        shard_model(model, mesh, conf, make, draws=draws)
        got = {"made": made, "most_before": most[0], "after": live()}
        if draws:
            ref = dict(init_params(cfg, seed=0, device=cpu,
                                   dtype=torch.float32).named_parameters())
            got["equal"] = all(torch.equal(
                p.full_tensor() if isinstance(p, DTensor) else p, ref[n])
                for n, p in model.named_parameters())
        out[draws] = got
    return _gathered(out)


def cases(spec):
    """Every case of ``spec["cases"]`` in turn, on meshes of the same
    processes: name -> the case's output."""
    run = {"cp_attn": cp_attn, "train": train, "hf_train": hf_train,
           "pp_init": pp_init, "fused_ce": fused_ce_tp}
    return {name: run[case["kind"]](dict(spec, **case))
            for name, case in spec["cases"].items()}


def _ckpt_trainer(spec, params, **resilience):
    """An f32 llama-tiny trainer on ``spec["dist"]``'s mesh, from
    ``params`` (JAX weights)."""
    cfg = get_preset("llama-tiny", dtype=torch.float32, **spec["model"])
    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    d = spec["dist"]
    conf = tt.Config(
        compute=tt.ComputeConfig(dtype=torch.float32),
        dist=tt.DistConfig(dp=tt.DPConfig(d.get("dp", -1)),
                           fsdp=tt.FSDPConfig(d.get("fsdp", 1)),
                           tp=tt.TPConfig(d.get("tp", 1))),
        resilience=tt.ResilienceConfig(**resilience))
    trainer, _ = accelerate(model, None, conf,
                            optimizer=adamw(warmup_cosine(*spec["schedule"]),
                                            **spec["opt"]))
    trainer.init()
    return trainer


def _full_state(trainer):
    """Every leaf of the checkpointed state, whole, as numpy (a
    collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    from torchacc_tpu_torch.train.state import flat_state
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().numpy().copy()
            for k, v in flat_state(trainer.state).items()}


def _gathered(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def ckpt_save(spec):
    """Two steps on the mesh, each saved by a CheckpointManager (the
    markers counted on each rank), then a resume by consensus in which
    rank 1 alone finds the newest step unreadable."""
    import torchacc_tpu_torch.checkpoint.io as cio
    from torchacc_tpu_torch.checkpoint import CheckpointManager
    trainer = _ckpt_trainer(spec, spec["params"])
    n, i = data_shard(trainer.mesh)
    markers = []
    write_json = cio._write_json

    def spy(path, obj):
        if os.path.basename(path) == cio.MANIFEST:
            markers.append(path)
        return write_json(path, obj)
    cio._write_json = spy
    mgr = CheckpointManager(spec["dir"])
    full = {}
    for step, b in enumerate(spec["batches"], start=1):
        rows = b["input_ids"].shape[0] // n
        trainer.step({k: v[i * rows:(i + 1) * rows] for k, v in b.items()})
        assert mgr.save(step, trainer.state)
        full[step] = _full_state(trainer)
    mgr.close()
    cio._write_json = write_json
    out = {"full": full, "markers": _gathered(len(markers))}
    # the resume: rank 1's probe finds step 2 unreadable
    mgr = CheckpointManager(spec["dir"])
    if dist.get_rank() == 1:
        probe = mgr._probe_step
        mgr._probe_step = lambda s: ("injected: unreadable here" if s == 2
                                     else probe(s))
    other = _ckpt_trainer(spec, spec["params_other"])
    _, chosen = mgr.restore_latest_valid(other.state)
    mgr.close()
    out["chosen"] = _gathered(chosen)
    out["restored"] = _full_state(other)
    out["dirs"] = sorted(os.listdir(spec["dir"]))
    if "restore_dist" in spec:
        # the same processes on another layout of the same world
        out["restore"] = ckpt_restore(dict(spec, dist=spec["restore_dist"]))
    if "hf" in spec:
        out["hf"] = hf_train(spec["hf"])
    return out


def hf_train(spec):
    """accelerate(a Hugging Face checkpoint directory) on ``spec["dist"]``'s
    mesh, each checkpoint tensor streamed into this rank's shard, then
    steps over this rank's rows: the losses and the whole final
    parameters (flax layout)."""
    conf = tt.Config(
        compute=tt.ComputeConfig(dtype=torch.float32),
        memory=tt.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=_dist_config(spec["dist"]))
    trainer, _ = accelerate(
        spec["path"], None, conf, device="cpu",
        optimizer=adamw(warmup_linear(*spec["schedule"]), **spec["opt"]))
    n, i = data_shard(trainer.mesh)
    losses = []
    for b in spec["batches"]:
        rows = b["input_ids"].shape[0] // n
        losses.append(trainer.step(
            {k: v[i * rows:(i + 1) * rows] for k, v in b.items()})
            ["loss"].item())
    return {"losses": losses, "params": _all_params(trainer)}


def ckpt_restore(spec):
    """Step 1 of a checkpoint saved under another layout restored into
    this mesh's trainer, with elastic resume off and on: the outcome
    (the whole restored state, or the error's type and axes) and the
    schema the check judged."""
    from torchacc_tpu_torch.checkpoint import CheckpointManager
    from torchacc_tpu_torch.checkpoint.schema import state_schema
    from torchacc_tpu_torch.train.state import flat_state
    out = {}
    for elastic in (False, True):
        trainer = _ckpt_trainer(spec, spec["params_other"],
                                elastic_resume=elastic)
        out["schema"] = state_schema(flat_state(trainer.state))
        mgr = CheckpointManager(spec["dir"], elastic_resume=elastic)
        try:
            mgr.restore(trainer.state, step=1)
            out[elastic] = ("ok", _full_state(trainer))
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            out[elastic] = (type(e).__name__, getattr(e, "axes", None))
        mgr.close()
    return out


def main(spec_path, out_path):
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    store = os.path.join(os.path.dirname(spec_path), "pg_store")
    initialize_distributed(f"file://{store}", device="cpu")
    try:
        out = {"fused_ce": fused_ce_tp, "train": train,
               "ckpt_save": ckpt_save, "ckpt_restore": ckpt_restore,
               "cases": cases}[spec["kind"]](spec)
        if dist.get_rank() == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
