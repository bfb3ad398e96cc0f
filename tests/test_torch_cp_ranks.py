"""The port's context parallelism on 2 and 4 gloo ranks against the JAX
package on an emulated mesh of the same shape, on the CPU.

Two launches of ``tests/torch_ranks_worker.py`` (``kind="cases"``), one
of 2 ranks and one of 4, each run every case of their world in turn on
meshes of the same processes, as ``tests/test_torch_checkpoint_ranks.py``
shares its launch; each subprocess has a timeout of its own.

- ``cp_attention`` itself (ring, Ulysses, 2D with an intra size of 2,
  and Ulysses and the ring beside tp 2, whose ranks hold half the heads
  at their global head offset with their slopes) on each rank's chunk
  of seeded inputs, with packed segment ids, a window, GQA, dropout and
  ALiBi or a softcap, forward and gradients,
  against JAX's ``cp_attention`` (``impl='xla'``) on the mesh.  Both
  sides hash dropout at the global coordinates, so the masks are the
  same: the output and the gradients within 1e-5 of each one's largest
  entry, f32 (read <= 4.3e-7).
- ``accelerate()`` -> 3 ``Trainer.step`` s with ``dist.sp`` (ring 2, in
  f32 and with int8 quantized matmuls; 2D 4 with intra 2; Ulysses 2
  beside dp 2 and beside tp 2, both with attention dropout) and two
  cases without CP, dp 2 and tp 2 with attention dropout, which the
  batch and head offsets unblock, against the JAX Trainer on a mesh of the same shape from the
  same JAX weights.  f32: the losses rtol 1e-5 and every final
  parameter within 1e-5 of its leaf's largest entry, the tolerances of
  ``tests/test_torch_parallel_ranks.py`` (read <= 2.0e-7 and 4.3e-6).
  int8: its int8 tolerances there, the losses rtol 1e-4, the parameters
  1e-3 and the amax histories rtol 2e-4 (read 0, 1.1e-7 and 3.5e-7,
  AdamW's eps 1e-2 as there): the histories are global maxima over the
  sequence ranks, as JAX's are over the whole sequence.  The ring's
  forward steps are counted: under ``save_attn_mlp`` each rank runs
  exactly the steps ``step_should_run`` keeps, once a layer and step,
  so the remat recompute never walks the ring again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_module_env import port_module_env
from test_torch_parallel_ranks import OPT, SCHEDULE, SMALL, _batch, _launch
import torchacc_tpu as ta
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.ops.context_parallel import cp_attention as jax_cp
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu_torch.config import MESH_AXES
from torchacc_tpu_torch.ops.context_parallel import step_should_run
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions

pytestmark = pytest.mark.distributed

STEPS = 3
# the tp x sp case needs kv heads that split over both
WIDE = dict(SMALL, num_heads=8, num_kv_heads=4)
ATTN_CASES = {   # name: (world, dist, options)
    "ring_2": (2, dict(sp=dict(size=2, mode="ring")),
               dict(window=(20, -1), dropout_p=0.1, alibi=True)),
    "ulysses_2": (2, dict(sp=dict(size=2, mode="ulysses")),
                  dict(dropout_p=0.2, logit_softcap=5.0)),
    "ring_4": (4, dict(sp=dict(size=4, mode="ring")),
               dict(window=(40, -1), dropout_p=0.1, alibi=True)),
    "ulysses_4": (4, dict(sp=dict(size=4, mode="ulysses")),
                  dict(dropout_p=0.1, alibi=True)),
    "2d_4_intra_2": (4, dict(sp=dict(size=4, mode="2d", intra_size=2)),
                     dict(window=(24, -1), dropout_p=0.1,
                          logit_softcap=5.0)),
    # the 'tp' rank's head offset and its heads' slopes, under Ulysses
    # (then the inner head groups' on top) and the ring
    "tp2_ulysses_2": (4, dict(tp=2, sp=dict(size=2, mode="ulysses")),
                      dict(dropout_p=0.1, alibi=True)),
    "tp2_ring_2": (4, dict(tp=2, sp=dict(size=2, mode="ring")),
                   dict(window=(20, -1), dropout_p=0.1, alibi=True)),
}
INT8 = dict(quant="int8", quant_amax_history_len=4)
TRAIN_CASES = {  # name: (world, dist, model fields, compute)
    "sp2_ring": (2, dict(sp=dict(size=2, mode="ring")), SMALL, {}),
    "sp2_ring_int8": (2, dict(sp=dict(size=2, mode="ring")), SMALL, INT8),
    "dp2_dropout_no_cp": (2, dict(dp=2), dict(SMALL, attn_dropout=0.1), {}),
    "sp4_2d_intra_2": (4, dict(sp=dict(size=4, mode="2d", intra_size=2)),
                       SMALL, {}),
    "dp2_sp2_ulysses_dropout": (4, dict(dp=2, sp=dict(size=2)),
                                dict(SMALL, attn_dropout=0.1), {}),
    "tp2_sp2_ulysses": (4, dict(tp=2, sp=dict(size=2)),
                        dict(WIDE, attn_dropout=0.1), {}),
    "tp2_dropout_no_cp": (2, dict(tp=2), dict(WIDE, attn_dropout=0.1), {}),
}
B, S, H, KH, D = 2, 64, 8, 4, 16


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _params(fields, seed=0):
    from test_torch_model import seeded_jax_params
    return seeded_jax_params(seed, **fields)


def _attn_inputs(name, opts):
    rng = np.random.default_rng(sorted(ATTN_CASES).index(name))
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, KH, D)).astype(np.float32)
            for _ in range(2))
    pos = np.concatenate([np.arange(n) for n in (21, 30, 13)])
    seg = segment_ids_from_positions(torch.from_numpy(
        np.tile(pos, (B, 1)).astype(np.int32))).numpy()
    spec = dict(q=q, k=k, v=v, do=do, seg=seg)
    kw = dict(causal=True, window=opts.get("window", (-1, -1)),
              dropout_p=opts.get("dropout_p", 0.0), dropout_seed=11,
              logit_softcap=opts.get("logit_softcap", 0.0))
    if opts.get("alibi"):
        spec["slopes"] = (2.0 ** (-8.0 * np.arange(1, H + 1) / H)).astype(
            np.float32)
    return spec, kw


def _specs(world):
    cases = {}
    for name, (w, d, opts) in ATTN_CASES.items():
        if w == world:
            inputs, kw = _attn_inputs(name, opts)
            cases[f"attn_{name}"] = dict(kind="cp_attn", dist=d, kw=kw,
                                         **inputs)
    for name, (w, d, fields, compute) in TRAIN_CASES.items():
        if w == world:
            cases[f"train_{name}"] = dict(
                kind="train", dist=d, model=fields, params=_params(fields),
                compute=compute, grad_accum=1, dtype=torch.float32,
                batches=[_batch(50 + i) for i in range(STEPS)],
                schedule=SCHEDULE, opt=_opt(compute))
    return dict(kind="cases", cases=cases)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both launches, started together; ``ranks[world]()`` waits for one
    and returns its cases' outputs."""
    waits = {w: _launch(tmp_path_factory.mktemp(f"cp{w}"), w, _specs(w))
             for w in (2, 4)}
    got = {}

    def result(world):
        if world not in got:
            got[world] = waits[world]()
        return got[world]
    return {w: (lambda w=w: result(w)) for w in waits}


def _close(a, want, what, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(a, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_cp_attention_matches_jax_on_the_mesh(ranks, name):
    world, d, opts = ATTN_CASES[name]
    spec, kw = _attn_inputs(name, opts)
    mesh = build_mesh(ta.DistConfig(tp=ta.TPConfig(d.get("tp", 1)),
                                    sp=ta.SPConfig(**d["sp"])),
                      devices=jax.devices()[:world])
    qkv = NamedSharding(mesh, P(("dp", "fsdp"), ("sp", "spu"), "tp", None))
    segs = NamedSharding(mesh, P(("dp", "fsdp"), ("sp", "spu")))
    extra = {}
    if "slopes" in spec:
        extra["alibi_slopes"] = jnp.asarray(spec["slopes"])

    def f(q, k, v, seg):
        return jax_cp(q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
                      mesh=mesh, impl="xla", **kw, **extra)

    @jax.jit
    def fwd_bwd(q, k, v, seg, do):
        out, vjp = jax.vjp(lambda a, b, c: f(a, b, c, seg), q, k, v)
        return (out,) + vjp(do)

    with jax.sharding.set_mesh(mesh):
        args = [jax.device_put(jnp.asarray(spec[x]), qkv)
                for x in ("q", "k", "v")]
        args.append(jax.device_put(jnp.asarray(spec["seg"]), segs))
        args.append(jax.device_put(jnp.asarray(spec["do"]), qkv))
        want = jax.device_get(fwd_bwd(*args))
    got = ranks[world]()[f"attn_{name}"]
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        _close(got[key], w, key)


def _opt(compute):
    # quantized: AdamW's eps 1e-2, as tests/test_torch_parallel_ranks.py
    # takes it for int8 (an element whose gradient is near zero would
    # otherwise move by lr * sign(its rounding noise))
    return dict(OPT, eps=1e-2) if compute else OPT


def _jax_trainer(world, d, fields, compute, params):
    jcompute = dict(compute, quant_impl="xla") if compute else {}
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", attention_impl="xla",
                                 **jcompute),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=ta.DistConfig(dp=ta.DPConfig(d.get("dp", -1)),
                           tp=ta.TPConfig(d.get("tp", 1)),
                           sp=ta.SPConfig(**d.get("sp", {}))))
    jtrainer, _ = jax_accelerate(
        jax_preset("llama-tiny", **fields), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(*SCHEDULE),
                                  **_opt(compute)),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:world]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    return jtrainer


def _kept_steps(d):
    """The ring steps each rank runs a layer and step, by ring rank."""
    sp = d.get("sp", {})
    cfg = ta.SPConfig(**sp) if sp else ta.SPConfig()
    n = cfg.ring_degree
    s = S_TRAIN // n
    return [sum(step_should_run(me, (me - i) % n, s, True, (-1, -1))
                for i in range(n)) for me in range(n)]


S_TRAIN = 32     # test_torch_parallel_ranks._batch's sequence


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_cp_training_matches_the_jax_trainer(ranks, name):
    world, d, fields, compute = TRAIN_CASES[name]
    jtrainer = _jax_trainer(world, d, fields, compute, _params(fields))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    _batch(50 + i).items()})["loss"])
               for i in range(STEPS)]
    got = ranks[world]()[f"train_{name}"]
    loss_tol, param_tol = (1e-4, 1e-3) if compute else (1e-5, 1e-5)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=loss_tol)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    assert [p for p, _ in flat(got["params"])] == [p for p, _ in flat(want)]
    for (path, a), (_, w) in zip(flat(got["params"]), flat(want)):
        _close(a, w, jax.tree_util.keystr(path), param_tol)
    if compute:
        # the amax histories: global maxima over the sequence ranks
        jq = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.quant))
        for (path, a), (_, w) in zip(flat(got["quant"]), flat(jq)):
            np.testing.assert_allclose(a, w, rtol=2e-4,
                                       err_msg=jax.tree_util.keystr(path))
    # the ring's forward steps: the kept ones, once a layer and step
    # (save_attn_mlp keeps cp_fwd's outputs for the backward)
    ring_n = ta.SPConfig(**d["sp"]).ring_degree if "sp" in d else 1
    calls = got["ring_fwd_calls"]
    if ring_n == 1:
        assert calls == [0] * world
    else:
        sizes = ta.DistConfig(
            dp=ta.DPConfig(d.get("dp", -1)), tp=ta.TPConfig(d.get("tp", 1)),
            sp=ta.SPConfig(**d["sp"])).axis_sizes(world)
        per_rank = _kept_steps(d)
        layers = fields["num_layers"]
        # ranks are laid out row-major over MESH_AXES; 'sp' is the ring
        want_calls = []
        for r in range(world):
            coords = np.unravel_index(r, [sizes[a] for a in MESH_AXES])
            me = int(coords[MESH_AXES.index("sp")])
            want_calls.append(per_rank[me] * layers * STEPS)
        assert calls == want_calls
