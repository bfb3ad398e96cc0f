"""The port's parallel layer (``torchacc_tpu_torch.parallel``,
``config.DistConfig``, ``models/axes.py``) against the JAX package's,
in one CPU process: the config's validation and axis sizes, the mesh's
axis names and sizes, the rule table and specs, every parameter's
logical axes, what raises by name, and ``accelerate()`` without a
process group.  The multi-rank numerics are in
``tests/test_torch_parallel_ranks.py``.  A test that needs a process
group joins a world of one through a file in its ``tmp_path`` and
leaves it before it ends."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import torchacc_tpu as ta
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.axes import param_axes as jax_param_axes
from torchacc_tpu.parallel import mesh as jax_mesh
from torchacc_tpu.parallel import sharding as jax_sharding
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.config import MESH_AXES
from torchacc_tpu_torch.errors import CoordinationError
from torchacc_tpu_torch.models import get_preset
from torchacc_tpu_torch.models.axes import param_axes
from torchacc_tpu_torch.models.transformer import TransformerLM
from torchacc_tpu_torch.ops.flash_attention import flash_attention
from torchacc_tpu_torch.ops.quantized_matmul import quantized_dot
from torchacc_tpu_torch.parallel import (
    batch_spec,
    build_mesh,
    data_shard,
    describe_mesh,
    initialize_distributed,
    is_primary,
    make_rules,
    mesh_axis_size,
    spec_for,
)
from torchacc_tpu_torch.parallel import mesh as port_mesh
from torchacc_tpu_torch.parallel.sharding import _check_plan
from torchacc_tpu_torch.train import accelerate

TOPO = ("pp", "dp", "fsdp", "sp", "spu", "ep", "tp")


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


@contextlib.contextmanager
def _world_of_one(tmp_path):
    """A gloo process group of this process alone, left on exit."""
    initialize_distributed(f"file://{tmp_path / 'pg'}", 1, 0, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dist(pkg, dp=-1, fsdp=1, tp=1, pp=1, sp=1, ep=1, topology=MESH_AXES,
          num_slices=1):
    return pkg.DistConfig(
        dp=pkg.DPConfig(dp), fsdp=pkg.FSDPConfig(fsdp), tp=pkg.TPConfig(tp),
        pp=(pkg.PPConfig(pp) if pkg is tt else
            pkg.PPConfig(pp, num_micro_batches=pp)),
        sp=pkg.SPConfig(sp),
        ep=pkg.EPConfig(ep), topology=topology, num_slices=num_slices)


AXIS_CASES = [   # (dist fields, world)
    ({}, 1), ({}, 8), (dict(fsdp=2), 8), (dict(tp=2, fsdp=2), 8),
    (dict(dp=2, tp=4), 8), (dict(pp=2, tp=2), 8),
    (dict(sp=2), 4), (dict(sp=4, tp=2), 8),
    (dict(ep=2), 4), (dict(fsdp=3), 8), (dict(dp=2, fsdp=2), 8),
    (dict(dp=0), 4), (dict(tp=0), 4),
    (dict(topology=("dp", "tp")), 4),
]


@pytest.mark.parametrize("fields,world", AXIS_CASES)
def test_axis_sizes_and_validation_match_jax(fields, world):
    """``axis_sizes`` (dp inferred) and the config errors, message for
    message; pp/sp/ep above 1 validate in JAX and raise by name in the
    port.  The port's sp is JAX's default mode, 'ulysses'."""
    def run(pkg):
        try:
            d = _dist(pkg, **fields)
            for sub in (d.dp, d.tp, d.fsdp, d.pp, d.sp, d.ep):
                sub.validate()
            return d.axis_sizes(world)
        except ValueError as e:
            return f"{type(e).__name__}: {e}"
    got = run(tt)
    assert got == run(ta)
    unported = {"pp": "A12", "sp": "A12", "ep": "A10"}
    for axis, item in unported.items():
        if isinstance(got, dict) and fields.get(axis, 1) > 1:
            with pytest.raises(NotImplementedError, match=item):
                _dist(tt, **fields).validate()


MESH_CASES = [   # (dist fields, world)
    ({}, 1), ({}, 4), (dict(fsdp=2), 4), (dict(tp=2), 4),
    (dict(dp=2, fsdp=2, tp=2), 8), (dict(fsdp=4, tp=2), 8),
    (dict(tp=2, topology=TOPO), 8), (dict(dp=1, fsdp=2), 2),
]


@pytest.mark.parametrize("fields,world", MESH_CASES)
def test_mesh_axes_and_sizes_match_jax_build_mesh(fields, world):
    """``mesh_shape`` names every axis in topology order, size-1 axes
    kept, as JAX's ``build_mesh`` does on the emulated devices."""
    names, shape = port_mesh.mesh_shape(_dist(tt, **fields), world)
    jm = jax_mesh.build_mesh(_dist(ta, **fields),
                             devices=jax.devices()[:world])
    assert names == tuple(jm.axis_names)
    assert dict(zip(names, shape)) == dict(jm.shape)


def test_mesh_slices_and_topology_raise_by_name():
    """The DCN axis-order check raises JAX's error; past it, more than
    one slice and 'fsdp' before 'dp' raise NotImplementedError."""
    straddle = _dist(tt, num_slices=2)
    with pytest.raises(ValueError) as port_err:
        port_mesh.mesh_shape(straddle, 8)
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.build_mesh(_dist(ta, num_slices=2), devices=jax.devices())
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="num_slices.*A8b"):
        port_mesh.mesh_shape(_dist(tt, dp=2, tp=4, num_slices=2), 8)
    swapped = ("fsdp", "dp") + MESH_AXES[3:] + ("pp",)
    with pytest.raises(NotImplementedError, match="'fsdp' before 'dp'"):
        port_mesh.mesh_shape(_dist(tt, topology=swapped), 4)


def test_world_of_one_mesh_and_data_shard(tmp_path):
    """``Config.get_mesh`` over a world of one: a DeviceMesh with every
    axis at size 1, JAX's names and sizes, and (1, 0) as the data
    shard; a second join is success, as in JAX."""
    with _world_of_one(tmp_path):
        initialize_distributed(f"file://{tmp_path / 'other'}", 1, 0,
                               device="cpu")
        conf = tt.Config()
        mesh = conf.get_mesh("cpu")
        assert conf.get_mesh("cpu") is mesh
        jm = jax_mesh.build_mesh(ta.DistConfig(), devices=jax.devices()[:1])
        assert describe_mesh(mesh) == dict(jm.shape)
        assert mesh_axis_size(mesh, "tp") == 1 and mesh.device_type == "cpu"
        assert data_shard(mesh) == (1, 0) and is_primary()
        assert build_mesh(tt.DistConfig(), "cpu").mesh_dim_names == MESH_AXES


def test_initialize_distributed_raises_coordination_error_after_retries():
    with pytest.raises(CoordinationError, match="nosuchscheme://x") as err:
        initialize_distributed("nosuchscheme://x", 2, 1, device="cpu",
                               init_retries=2, retry_base_delay_s=0.0)
    assert "after 3 attempt(s)" in str(err.value)
    assert err.value.primitive == "initialize"
    assert not dist.is_initialized()


SPEC_CASES = [("batch", "seq"), ("embed", "mlp"), ("vocab", "embed"),
              ("heads", "kv", "embed"), ("norm",), ("embed", "heads"),
              (None, "embed"), ("expert", "embed", "expert_mlp")]


@pytest.mark.parametrize("rules_override", [None, [("mlp", None)],
                                            [("embed", ("fsdp", "dp"))]])
@pytest.mark.parametrize("axes", SPEC_CASES)
def test_rules_and_specs_match_jax(axes, rules_override):
    conf = tt.Config(dist=tt.DistConfig(fsdp=tt.FSDPConfig(
        shard_axis_rules=rules_override)))
    jconf = ta.Config(dist=ta.DistConfig(fsdp=ta.FSDPConfig(
        shard_axis_rules=rules_override)))
    assert make_rules(conf) == jax_sharding.make_rules(jconf)
    assert spec_for(axes, make_rules(conf)) == tuple(
        jax_sharding.spec_for(axes, jax_sharding.make_rules(jconf)))
    assert batch_spec(conf) == tuple(jax_sharding.batch_spec(jconf))


def _port_axes_of(path, axes):
    """The logical axes of the port parameter that ``models/convert.py``
    makes from the flax leaf at ``path``: the stacked 'layers' dim
    dropped, a kernel's [in.., out..] reversed to nn.Linear's [out, in],
    the q/k/v output (heads, kv) and the o input (heads, kv) merged."""
    axes = tuple(axes)
    if path[0] == "layers":
        axes = axes[1:]
    leaf, name = path[-1], path[-2]
    if leaf == "bias" and name in ("q_proj", "k_proj", "v_proj"):
        return ((axes[0], axes[1]),)
    if leaf != "kernel":
        return axes
    if name in ("q_proj", "k_proj", "v_proj"):
        return ((axes[1], axes[2]), axes[0])
    if name == "o_proj":
        return (axes[2], (axes[0], axes[1]))
    return tuple(reversed(axes))


def _port_name(path, layer):
    """The port parameter's name of the flax leaf at ``path``."""
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}[path[-1]]
    mod = path[-2]
    if path[0] == "layers":
        sub = "" if mod in ("ln1", "ln2") else (
            "attn." if mod.endswith(("q_proj", "k_proj", "v_proj", "o_proj"))
            else "mlp.")
        return f"layers.{layer}.{sub}{mod}.{leaf}"
    return f"{mod}.{leaf}"


@pytest.mark.parametrize("fields", [{}, dict(qkv_bias=True),
                                    dict(tie_embeddings=True)])
def test_param_axes_match_jax_for_every_parameter(fields):
    """Every port parameter of llama-tiny has the logical axes of its
    flax counterpart under the layout map of models/convert.py, and
    every flax leaf has a port counterpart."""
    jcfg = jax_preset("llama-tiny", num_layers=2, **fields)
    shapes = jax.eval_shape(lambda: JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    jaxes = jax_param_axes(shapes)
    model = TransformerLM(get_preset("llama-tiny", num_layers=2, **fields),
                          device="meta")
    port = param_axes(model.named_parameters())
    want = {}
    for path, axes in jax.tree_util.tree_flatten_with_path(
            jaxes, is_leaf=lambda x: isinstance(x, tuple))[0]:
        keys = tuple(k.key for k in path)
        for layer in range(2 if keys[0] == "layers" else 1):
            want[_port_name(keys, layer)] = _port_axes_of(keys, axes)
    assert port == want
    with pytest.raises(ValueError, match="no logical-axes rule"):
        param_axes([("layers.0.attn.rotary.inv_freq", torch.zeros(4))])


def test_unported_compositions_raise_by_name():
    mc = get_preset("llama-tiny", num_layers=1)
    sizes = dict(dp=1, pp=1, fsdp=1, sp=1, spu=1, ep=1, tp=2)
    rules = make_rules(tt.Config())
    with pytest.raises(NotImplementedError, match="compute.quant.*A8b"):
        tt.Config(compute=tt.ComputeConfig(quant="int8"),
                  dist=tt.DistConfig(tp=tt.TPConfig(2))).validate()
    for field, value in (("vocab_size", 32001), ("num_heads", 9),
                         ("num_kv_heads", 3), ("intermediate_size", 687)):
        bad = dataclasses.replace(mc, **{field: value},
                                  **({"num_kv_heads": 3}
                                     if field == "num_heads" else {}))
        with pytest.raises(NotImplementedError, match="A8b"):
            _check_plan(bad, rules, sizes)
    with pytest.raises(NotImplementedError, match="B-1"):
        _check_plan(dataclasses.replace(mc, attn_dropout=0.1), rules,
                    dict(sizes, tp=1, dp=2))
    with pytest.raises(NotImplementedError, match="rule table"):
        _check_plan(mc, (("mlp", None),) + tuple(rules), sizes)
    _check_plan(mc, rules, sizes)
    with pytest.raises(NotImplementedError, match="min_weight_size.*A8b"):
        tt.DistConfig(fsdp=tt.FSDPConfig(min_weight_size=0)).validate()
    # more than one rank asked for, and no process group
    for d in (tt.DistConfig(tp=tt.TPConfig(2)),
              tt.DistConfig(dp=tt.DPConfig(2)),
              tt.DistConfig(fsdp=tt.FSDPConfig(2))):
        with pytest.raises(tt.ConfigError, match="A8"):
            accelerate(mc, None, tt.Config(dist=d), device="cpu")
    with pytest.raises(NotImplementedError, match="overlap_fsdp"):
        accelerate(dataclasses.replace(mc, overlap_fsdp=True), None,
                   tt.Config(), device="cpu")


@pytest.mark.parametrize("dp,fsdp,grad_accum,raises", [
    (2, 2, 2, True), (1, 2, 4, True), (2, 1, 2, True), (2, 2, 1, False),
    (1, 1, 2, False)])
def test_quant_with_grad_accum_raises_on_more_than_one_data_shard(
        dp, fsdp, grad_accum, raises):
    """Each rank splits its own rows into micro-batches, where JAX splits
    the global batch: the activation amax of micro-batch i would cover
    other rows, so the combination raises by name."""
    mc = get_preset("llama-tiny", num_layers=1, quant="int8")
    sizes = dict(dp=dp, pp=1, fsdp=fsdp, sp=1, spu=1, ep=1, tp=1)
    rules = make_rules(tt.Config())
    if raises:
        with pytest.raises(NotImplementedError,
                           match="grad_accum > 1 on more than one.*A8b"):
            _check_plan(mc, rules, sizes, grad_accum)
    else:
        _check_plan(mc, rules, sizes, grad_accum)
    # without quant every composition is the same sum
    _check_plan(dataclasses.replace(mc, quant="none"), rules, sizes,
                grad_accum)


@pytest.mark.parametrize("shards", [(2, 1), (1, 0)])
def test_accelerate_checks_the_packed_dataset_shard(tmp_path, shards):
    """On a mesh a PackedDataset must yield this rank's rows
    (``data_shard``); one cut for other shards would make every data
    rank step the whole global batch, and raises."""
    mc = get_preset("llama-tiny", num_layers=1, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128)
    docs = [torch.arange(3, 20).numpy()] * 8
    ds = tt.PackedDataset(docs, seq_len=16, batch_rows=2,
                          num_shards=shards[0], shard_index=shards[1])
    with _world_of_one(tmp_path):
        if shards != (1, 0):
            with pytest.raises(tt.ConfigError, match="data_shard"):
                accelerate(mc, ds, tt.Config(), device="cpu")
        else:
            trainer, loader = accelerate(mc, ds, tt.Config(), device="cpu")
            assert trainer.mesh is not None and loader is not None


def test_accelerate_without_a_process_group_is_the_one_device_trainer():
    mc = get_preset("llama-tiny", num_layers=1, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128)
    assert not dist.is_initialized()
    trainer, _ = accelerate(mc, None, tt.Config(), device="cpu")
    state = trainer.init()
    assert trainer.mesh is None and trainer.model.tp_group is None
    assert not any(isinstance(p, dist.tensor.DTensor)
                   for p in trainer.model.parameters())
    assert type(trainer.model) is TransformerLM
    assert all(p is trainer.model.get_parameter(n)
               for n, p in state.params.items())


def test_kernel_wrappers_refuse_dtensors(tmp_path):
    """A DTensor that reaches a kernel wrapper raises; it is not
    converted inside the wrapper."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    with _world_of_one(tmp_path):
        mesh = tt.Config().get_mesh("cpu")["tp"]
        q = torch.randn(1, 8, 2, 32)
        dq = distribute_tensor(q, mesh, [Replicate()])
        with pytest.raises(TypeError, match="q is a DTensor"):
            flash_attention(dq, q, q)
        with pytest.raises(TypeError, match="kernel is a DTensor"):
            quantized_dot(q[0, :, 0], distribute_tensor(
                torch.randn(32, 4), mesh, [Replicate()]))
        out = flash_attention(dq.to_local(), q, q)
        assert out.shape == q.shape
