"""The port's pipeline schedules (``torchacc_tpu_torch/parallel/pp.py``)
against the JAX package's, in one process on the CPU.

- The tick tables: every (P, M, V) of a small grid, GPipe's forward
  ticks against ``pipeline_blocks``' decode of the resident micro-batch
  (:330-357) and 1F1B's against ``pipeline_train_1f1b``'s F/B decode
  (:651-668), both evaluated with jax.numpy; each (micro, chunk) runs
  forward and backward once on its stage, a stage runs one F and one B
  a tick at most, and every action comes after the one it reads.
- A toy stack (``tests/test_pipeline.py``'s ``_toy_setup``: tanh
  layers, a squared-error head) over the virtual transport
  (``tests/torch_pp_virtual.py``): 1F1B's loss, d_stacked, d_head and
  dx against ``pipeline_train_1f1b`` on a 'pp' mesh of P emulated
  devices, GPipe's output against ``pipeline_blocks``, and the
  gradients of ``Pipeline.run(scale=k)`` (the port's form of the custom
  VJP) against ``jax.grad`` of ``k`` times ``pipeline_loss_1f1b``.
  f32: within 1e-5 of each one's largest entry.
- llama-tiny (4 layers; 8 for P 4 x V 2) over virtual stages, packed
  segment ids, gpipe, 1f1b and interleaved 1f1b (V 2), with attention
  dropout under both schedules: ``pp_forward_sum_count``'s loss sum
  and count, and every parameter's gradient, against the JAX Trainer's
  forward (``TransformerLM.__call__``'s pipeline path under gpipe,
  ``pp_1f1b_forward_sum_count`` under 1f1b) on an emulated mesh of the
  same 'pp' size, differentiated by ``jax.grad``; and a custom Trainer
  loss in 1F1B's last stage, on JAX's micro-batch view of the labels;
  and a mixture of experts under GPipe (dense dispatch) and 1F1B
  (capacity dispatch), each chunk's router losses riding its
  micro-batch with JAX's ``count_m`` weight.
  f32: the loss sum
  rtol 1e-5, the count exactly, every gradient within 1e-5 of its
  leaf's largest entry (the tolerances of
  ``tests/test_torch_parallel_ranks.py``).  Under 1F1B the dropout masks
  must differ from GPipe's (the micro seed is mixed in), so each
  schedule's convention is the one held.
- The residual bound: under 1F1B stage d holds at most
  ``min(2(P-1-d)+1, M)`` micro-batches, and exactly that where the
  stage re-runs its chunks; the evaluation schedule keeps none.
- ``PPConfig`` and ``Config`` validation, message for message with
  JAX's; ``_MicroBatchView``'s error for a custom loss under 1F1B.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchacc_tpu as ta
from test_torch_cp_ranks import _params
from test_torch_moe import SMALL as MOE
from test_torch_moe import _params as _moe_params
from test_torch_parallel_ranks import SMALL, _batch
from torch_module_env import port_module_env
from torch_pp_virtual import virtual_pipeline
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.parallel.pp import (
    pipeline_blocks,
    pipeline_loss_1f1b,
    pipeline_train_1f1b,
)
from torchacc_tpu.train import accelerate as jax_accelerate
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.transformer import (
    _MicroBatchView,
    pp_forward_sum_count,
)
from torchacc_tpu_torch.parallel.pp import (
    gpipe_ticks,
    one_f_one_b_ticks,
    tick_messages,
)
from torchacc_tpu_torch.train.trainer import shift_labels


@pytest.fixture(scope="module", autouse=True)
def _module_env():
    # JAX's compile cache stays as tests/conftest.py sets it here
    with port_module_env(compile_cache_off=False):
        yield


GRID = [(P, M, V) for P, M, V in itertools.product((2, 4), (2, 4, 8), (1, 2))
        if not (V > 1 and M % P)] + [(4, 2, 2), (2, 3, 1)]


def _close(a, want, what, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(a), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


# -- tick tables --------------------------------------------------------------

def _jax_gpipe_live(P, M, V, T):
    """``pipeline_blocks``' decode (:339-357) of every (t, d): the chunk
    it applies and its resident micro-batch, where that one is live."""
    period = M if V > 1 and M >= P else P
    t = jnp.arange(T)[:, None]
    me = jnp.arange(P)[None, :]
    c_idx = jnp.clip((t - me) // period, 0, V - 1)
    m_res = t - me - c_idx * period
    live = (t - me >= 0) & (m_res >= 0) & (m_res < M)
    return np.asarray(live), np.asarray(m_res), np.asarray(c_idx)


def _jax_1f1b(P, M, V, T):
    """``pipeline_train_1f1b``'s decode (:655-668) of every (t, d)."""
    VP = V * P
    t = jnp.arange(T)[:, None]
    me = jnp.arange(P)[None, :]
    u_f = t - me
    f = (u_f >= 0) & (u_f < V * M)
    m_f = (u_f // VP) * P + (u_f % VP) % P
    c_f = (u_f % VP) // P
    u_b = t - (VP - 1) - (P - 1 - me)
    b = (u_b >= 0) & (u_b < V * M)
    m_b = (u_b // VP) * P + (u_b % VP) % P
    c_b = (V - 1) - (u_b % VP) // P
    return [np.asarray(a) for a in (f, m_f, c_f, b, m_b, c_b)]


def _check_order(table, P, V, M):
    """Each (m, c) F and B once on its stage, one of each a tick at most,
    and every action after the one it reads (an F after the previous
    virtual stage's F, a B after the next one's B and its own F)."""
    when = {}
    for t, row in enumerate(table):
        for d in range(P):
            kinds = [k for k, _, _ in row[d]]
            assert kinds.count("F") <= 1 and kinds.count("B") <= 1
            for k, m, c in row[d]:
                assert (k, m, c * P + d) not in when
                when[(k, m, c * P + d)] = t
    VP = V * P
    assert sorted(when) == sorted((k, m, s) for k in "FB"
                                  for m in range(M) for s in range(VP))
    for m in range(M):
        for s in range(VP):
            if s:
                assert when[("F", m, s)] > when[("F", m, s - 1)]
            if s < VP - 1:
                assert when[("B", m, s)] > when[("B", m, s + 1)]
            assert when[("B", m, s)] >= when[("F", m, s)]


@pytest.mark.parametrize("P,M,V", GRID)
def test_tick_tables_are_jax_tick_formulas(P, M, V):
    table = gpipe_ticks(P, M, V)
    T = len(table) // 2
    live, m_res, c_idx = _jax_gpipe_live(P, M, V, T)
    for t in range(T):
        for d in range(P):
            fwd = [(m, c) for k, m, c in table[t][d] if k == "F"]
            assert fwd == ([(int(m_res[t, d]), int(c_idx[t, d]))]
                           if live[t, d] else [])
    _check_order(table, P, V, M)
    if V > 1 and M % P:
        return
    table = one_f_one_b_ticks(P, M, V)
    T = len(table)
    assert T == V * M + V * P + P - 2
    f, m_f, c_f, b, m_b, c_b = _jax_1f1b(P, M, V, T)
    for t in range(T):
        for d in range(P):
            want = ([("F", int(m_f[t, d]), int(c_f[t, d]))] if f[t, d]
                    else []) + ([("B", int(m_b[t, d]), int(c_b[t, d]))]
                                if b[t, d] else [])
            assert table[t][d] == want
    _check_order(table, P, V, M)
    # the activations and cotangents of a tick go to the neighbours
    for row in table:
        for kind, src, dst, m, c_src, c_dst in tick_messages(row, P, V):
            assert dst == (src + (1 if kind == "F" else -1)) % P


# -- a toy stack ----------------------------------------------------------------

def _toy(P, M, V, mb=2, D=16):
    L = P * V * 2
    rng = np.random.default_rng(P * 100 + M * 10 + V)
    stacked = (0.3 * rng.standard_normal((L, D, D))).astype(np.float32)
    head = (0.3 * rng.standard_normal((D, D))).astype(np.float32)
    x = rng.standard_normal((M * mb, D)).astype(np.float32)
    labels = rng.standard_normal((M * mb, D)).astype(np.float32)
    return stacked, head, x, labels


def _toy_port(P, M, V, schedule, stacked, head, x, labels, train=True,
              outs=None, scale=None):
    w = torch.tensor(stacked, requires_grad=True)
    h = torch.tensor(head, requires_grad=True)
    xs = torch.tensor(x, requires_grad=True)
    lab = torch.tensor(labels)
    mb = x.shape[0] // M
    per = stacked.shape[0] // (P * V)

    def call(d, c, m, xin, last):
        y = xs[m * mb:(m + 1) * mb] if xin is None else xin
        s = c * P + d
        for i in range(s * per, (s + 1) * per):
            y = torch.tanh(y @ w[i])
        if not last:
            return y
        if outs is not None:
            outs[m] = y.detach()
        return (((y @ h - lab[m * mb:(m + 1) * mb]) ** 2).sum(),
                torch.tensor(float(mb * lab.shape[1])))
    pipe = virtual_pipeline(P, M, schedule, V)
    l_sum, count = pipe.run(call, train=train, scale=scale)
    return l_sum, count, (w, h, xs), pipe


def _jax_toy_fns(P):
    def apply_block(p, carry):
        return (jnp.tanh(carry[0] @ p),)

    def head_loss(hp, y, lab):
        return jnp.sum((y @ hp - lab) ** 2), jnp.asarray(
            float(np.prod(lab.shape)), jnp.float32)
    return apply_block, head_loss, Mesh(np.array(jax.devices()[:P]),
                                        ("pp",))


TOY = [(2, 4, 1), (4, 8, 1), (4, 4, 1), (2, 4, 2), (4, 4, 2)]


@pytest.mark.parametrize("P,M,V", TOY)
def test_toy_1f1b_matches_pipeline_train_1f1b(P, M, V):
    stacked, head, x, labels = _toy(P, M, V)
    apply_block, head_loss, mesh = _jax_toy_fns(P)
    with jax.sharding.set_mesh(mesh):
        (jl, jc), (jd_s, jd_h, jdx) = pipeline_train_1f1b(
            apply_block, head_loss, jnp.asarray(stacked),
            jnp.asarray(head), (jnp.asarray(x),), jnp.asarray(labels),
            pp_size=P, num_micro=M, virtual_stages=V)
    l_sum, count, (w, h, xs), _ = _toy_port(P, M, V, "1f1b", stacked,
                                            head, x, labels)
    np.testing.assert_allclose(l_sum.item(), float(jl), rtol=1e-5)
    assert count.item() == float(jc)
    for name, a, want in (("d_stacked", w.grad, jd_s),
                          ("d_head", h.grad, jd_h), ("dx", xs.grad, jdx)):
        _close(a.numpy(), want, name)


@pytest.mark.parametrize("P,M,V", [(2, 4, 2), (4, 2, 2)])
def test_toy_gpipe_matches_pipeline_blocks(P, M, V):
    """The output (M >= P and, with (4, 2, 2), M < P: both regimes of
    the interleave) and, through the head, every gradient."""
    stacked, head, x, labels = _toy(P, M, V)
    apply_block, head_loss, mesh = _jax_toy_fns(P)

    def loss(st, hp, xx):
        y = pipeline_blocks(apply_block, st, (xx,), pp_size=P, num_micro=M,
                            remat=False, virtual_stages=V)
        return head_loss(hp, y, jnp.asarray(labels))[0], y

    with jax.sharding.set_mesh(mesh):
        (jl, jy), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
            jnp.asarray(stacked), jnp.asarray(head), jnp.asarray(x))
    outs = {}
    _toy_port(P, M, V, "gpipe", stacked, head, x, labels, train=False,
              outs=outs)
    _close(torch.cat([outs[m] for m in range(M)]).numpy(), jy, "output")
    l_sum, _, tensors, _ = _toy_port(P, M, V, "gpipe", stacked, head, x,
                                     labels)
    np.testing.assert_allclose(l_sum.item(), float(jl), rtol=1e-5)
    for name, t, want in zip(("d_stacked", "d_head", "dx"), tensors, grads):
        _close(t.grad.numpy(), want, name)


def test_pipeline_loss_1f1b_scales_by_the_cotangent():
    """``Pipeline.run(scale=k)``'s gradients against ``jax.grad`` of
    ``k * loss_sum`` through JAX's custom VJP, whose backward scales the
    schedule's gradients by the cotangent ``k``."""
    P, M, V, k = 2, 4, 1, 0.25
    stacked, head, x, labels = _toy(P, M, V)
    apply_block, head_loss, mesh = _jax_toy_fns(P)

    def loss(st, hp, xx):
        ls, _ = pipeline_loss_1f1b(apply_block, head_loss, st, hp, xx, (),
                                   jnp.asarray(labels), None, None, P, M,
                                   "pp")
        return k * ls

    with jax.sharding.set_mesh(mesh):
        jl, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(stacked), jnp.asarray(head), jnp.asarray(x))
    l_sum, _, tensors, _ = _toy_port(P, M, V, "1f1b", stacked, head, x,
                                     labels, scale=torch.tensor(k))
    np.testing.assert_allclose(k * l_sum.item(), float(jl), rtol=1e-5)
    for name, t, want in zip(("d_stacked", "d_head", "dx"), tensors, grads):
        _close(t.grad.numpy(), want, name)


@pytest.mark.parametrize("P,M", [(2, 8), (4, 8), (4, 3)])
def test_1f1b_residual_bound(P, M):
    stacked, head, x, labels = _toy(P, M, 1)
    *_, pipe = _toy_port(P, M, 1, "1f1b", stacked, head, x, labels)
    for d, stage in pipe.last_run.items():
        bound = min(2 * (P - 1 - d) + 1, M)
        assert stage.max_live <= bound
        if d < P - 1:
            assert stage.max_live == bound
        assert not stage.bank and not stage.inbox and not stage.outbox
    *_, pipe = _toy_port(P, M, 1, "gpipe", stacked, head, x, labels,
                         train=False)
    assert all(s.max_live == 0 for s in pipe.last_run.values())


# -- llama-tiny over virtual stages -----------------------------------------------

MODEL_CASES = {  # name: (P, M, schedule, V, model fields)
    "gpipe_p2": (2, 4, "gpipe", 1, dict(SMALL, num_layers=4)),
    "gpipe_p2_v2_dropout": (2, 2, "gpipe", 2,
                            dict(SMALL, num_layers=4, attn_dropout=0.2)),
    "1f1b_p2_dropout_tied": (2, 4, "1f1b", 1,
                             dict(SMALL, num_layers=4, attn_dropout=0.2,
                                  tie_embeddings=True)),
    "1f1b_p4_v2": (4, 4, "1f1b", 2, dict(SMALL, num_layers=8)),
    # a custom Trainer loss in the last stage, on its micro-batch view
    "1f1b_p2_custom_loss": (2, 2, "1f1b", 1, dict(SMALL, num_layers=4)),
    # a mixture of experts: each chunk's router losses ride their
    # micro-batch (dense dispatch; capacity, whose cap is a micro-batch's)
    "gpipe_p2_moe": (2, 2, "gpipe", 1, dict(MOE, num_layers=4,
                                            router_aux_weight=0.5)),
    "1f1b_p2_moe_capacity": (2, 2, "1f1b", 1, dict(
        MOE, num_layers=4, router_aux_weight=0.5, moe_capacity_factor=1.0)),
}
CUSTOM = ("1f1b_p2_custom_loss",)


def _port_loss(logits, batch):
    from torchacc_tpu_torch.models.transformer import loss_sum_count
    return loss_sum_count(logits, batch["labels"])


def _jax_loss(logits, batch):
    from torchacc_tpu.models.transformer import loss_sum_count
    return loss_sum_count(logits, batch["labels"])


def _jax_grads(P, M, schedule, V, fields, params, batch, seed,
               custom=False):
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", attention_impl="xla"),
        dist=ta.DistConfig(pp=ta.PPConfig(size=P, num_micro_batches=M,
                                          schedule=schedule,
                                          virtual_stages=V)))
    jt, _ = jax_accelerate(jax_preset("llama-tiny", **fields), None, jconf,
                           mesh=build_mesh(jconf.dist,
                                           devices=jax.devices()[:P]),
                           **(dict(loss=_jax_loss) if custom else {}))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        l_sum, count, _ = jt._forward_sum_count(p, jb, dropout_seed=seed)
        return l_sum, count

    with jax.sharding.set_mesh(jt.mesh):
        (l_sum, count), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
    return float(l_sum), float(count), jax.tree.map(np.asarray, g)


def _port_grads(P, M, schedule, V, fields, params, batch, seed,
                custom=False):
    cfg = get_preset("llama-tiny", dtype=torch.float32, pp_size=P,
                     pp_num_micro=M, pp_virtual=V, **fields)
    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    l_sum, count = pp_forward_sum_count(
        model, virtual_pipeline(P, M, schedule, V), tb,
        shift_labels(tb["input_ids"], tb["segment_ids"]),
        dropout_seed=seed, use_fused_ce=not custom,
        custom_loss=_port_loss if custom else None)
    return l_sum.item(), count.item(), params_to_jax(
        cfg, {n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_llama_tiny_stages_match_jax(name):
    P, M, schedule, V, fields = MODEL_CASES[name]
    params = (_moe_params(fields) if fields.get("num_experts")
              else _params(fields))
    batch = _batch(70)
    seed = 5 if fields.get("attn_dropout") else None
    custom = name in CUSTOM
    jl, jc, jg = _jax_grads(P, M, schedule, V, fields, params, batch, seed,
                            custom)
    l_sum, count, grads = _port_grads(P, M, schedule, V, fields, params,
                                      batch, seed, custom)
    np.testing.assert_allclose(l_sum, jl, rtol=1e-5)
    assert count == jc
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(grads)[0]] == [p for p, _ in flat(jg)[0]]
    for (path, a), (_, w) in zip(flat(grads)[0], flat(jg)[0]):
        _close(a, w, jax.tree_util.keystr(path))
    if schedule == "1f1b" and seed is not None:
        # 1F1B mixes the micro index into the seed: GPipe's masks differ
        other, _, _ = _port_grads(P, M, "gpipe", V, fields, params, batch,
                                  seed)
        assert abs(other - l_sum) > 1e-3 * abs(l_sum)


# -- configuration ------------------------------------------------------------------

PP_CONFIGS = [
    dict(size=2, num_micro_batches=4), dict(size=2, num_micro_batches=3),
    dict(size=0), dict(num_micro_batches=0), dict(schedule="zb"),
    dict(virtual_stages=0), dict(size=4, num_micro_batches=8,
                                 schedule="1f1b", virtual_stages=2),
    dict(size=2, num_micro_batches=2, schedule="1f1b", virtual_stages=2),
]


def _outcome(fn):
    try:
        fn()
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("fields", PP_CONFIGS)
def test_ppconfig_validates_as_jax(fields):
    assert _outcome(tt.PPConfig(**fields).validate) == \
        _outcome(ta.PPConfig(**fields).validate)


@pytest.mark.parametrize("what", ["quant", "overlap_fsdp"])
def test_pp_refusals_carry_jax_messages(what):
    def conf(pkg):
        c = pkg.Config(dist=pkg.DistConfig(pp=pkg.PPConfig(
            size=2, num_micro_batches=2)))
        if what == "quant":
            c.compute.quant = "int8"
        else:
            c.perf.overlap_fsdp = True
        return c
    want = _outcome(conf(ta).validate)
    assert want != "ok" and _outcome(conf(tt).validate) == want


def test_pp_rules_match_jax():
    """Under 'pp' JAX's ``("layers", "pp")`` rule comes first."""
    from torchacc_tpu.parallel import sharding as jax_sharding
    from torchacc_tpu_torch.parallel.sharding import make_rules, spec_for
    conf = tt.Config(dist=tt.DistConfig(pp=tt.PPConfig(
        size=2, num_micro_batches=2)))
    jconf = ta.Config(dist=ta.DistConfig(pp=ta.PPConfig(
        size=2, num_micro_batches=2)))
    assert make_rules(conf) == jax_sharding.make_rules(jconf)
    assert spec_for(("layers", "embed"), make_rules(conf)) == ("pp", "fsdp")


@pytest.mark.parametrize("fields,exc,item", [
    # a pattern runs under 'pp' (tests/test_torch_gemma.py) when its
    # period divides a stage's chunk of layers, as JAX requires
    (dict(layer_pattern=("sliding", "sliding", "global")), ValueError,
     "does not divide the per-stage chunk"),
    # experts run under 'pp' (the MoE cases above); an expert count that
    # 'ep' does not divide raises by name in the plan of a pp 2 x ep 2
    # mesh
    (dict(num_experts=3), NotImplementedError,
     "num_experts 3 is not divisible by ep 2.*A8b")])
def test_pp_patterns_and_experts_raise_by_name(fields, exc, item):
    cfg = get_preset("llama-tiny", dtype=torch.float32, pp_size=2,
                     pp_num_micro=2, **dict(SMALL, num_layers=4), **fields)
    with pytest.raises(exc, match=item):
        if cfg.num_experts:
            from torchacc_tpu_torch.parallel.sharding import (
                _check_plan,
                make_rules,
            )
            _check_plan(cfg, make_rules(), dict(dp=1, pp=2, fsdp=1, sp=1,
                                                spu=1, ep=2, tp=1))
        tt.TransformerLM(cfg, device="cpu")(torch.zeros(
            (2, 8), dtype=torch.long))


def test_micro_batch_view_raises_on_other_keys():
    view = _MicroBatchView(labels=torch.zeros(2))
    assert "labels" in view and "input_ids" not in view
    for get in (lambda: view["input_ids"], lambda: view.get("input_ids")):
        with pytest.raises(KeyError, match="pp.schedule='gpipe'"):
            get()
