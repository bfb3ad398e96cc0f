"""The port's quantized-training slice against the JAX package, on the
CPU: ``ops/quantized_matmul.py`` (plain path), the quantized sites of
``models/transformer.py``, and ``accelerate()`` -> ``Trainer.step`` with
``compute.quant``.  The JAX side runs its XLA path and its Pallas kernel
B5 in interpret mode.  Every input is made from a numpy seed.

Tolerances.
- Scales, quantize, dequantize, histories: bitwise (the same f32
  operations).
- int8 ``quantized_dot``: bitwise, f32, bf16 and f16 inputs, against
  both JAX paths (both sides sum exact integers and share every
  rounding, the f16 output's overflow to inf included).
- fp8 ``quantized_dot``: the products are exact in f32 and only the
  order of the f32 sum differs: atol = rtol = 1e-6 of values of
  magnitude ~1 (JAX's own two paths differ by 6e-8 here); against the
  dequantize-then-matmul anchor ``quantized_matmul_reference`` 5e-3 of
  the output scale, the JAX package's own bar.
- Straight-through gradients: rtol 1e-5, atol 1e-6 (plain f32 matmuls).
- The model level is not bitwise: an activation that differs in the
  last f32 bits between the two frameworks (other summation orders in
  norms and attention) can land on the other side of a rounding tie, and
  one flipped int8 step is amax / 127 of that element.  llama-tiny
  logits: 3% of the largest logit; gradient leaves: 3% of each leaf's
  largest entry (measured: 1.5% and 1.2% with int8).  The 5-step loss
  trajectory (``tests/test_torch_quant_steps.py``): rtol 2e-3;
  histories rtol 2e-2 after the first step (their amax is a max over
  activations that carry such flips).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu.ops.quantized_matmul as jq
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.transformer import loss_sum_count as jax_loss
import torchacc_tpu_torch as tt
import torchacc_tpu_torch.ops.quantized_matmul as tq
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.convert import (
    params_to_jax,
    quant_from_jax,
    quant_to_jax,
)
from torchacc_tpu_torch.models.transformer import (
    TransformerLM,
    init_quant_state,
    loss_fn,
    quant_site_names,
)
from torchacc_tpu_torch.train import accelerate

FMTS = ("int8", "fp8")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _np(a):
    """A jax or torch array as f32 numpy (bf16 and fp8 widen exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# -- (1) scales, quantize, histories: bitwise ---------------------------------

@pytest.mark.parametrize("fmt", FMTS)
def test_scales_and_quantize_bitwise(fmt):
    assert tq.quant_formats() == jq.quant_formats() == FMTS
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 48)) * 3.0).astype(np.float32)
    x[5] = 0.0
    w = (rng.standard_normal((48, 40)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                                  # a channel with amax 0
    amaxes = np.asarray([0.0, 1e-30, 0.37, 2.0, 1e4], np.float32)
    np.testing.assert_array_equal(
        _np(tq.compute_scale(torch.from_numpy(amaxes), fmt)),
        _np(jq.compute_scale(jnp.asarray(amaxes), fmt)))
    assert tq.compute_scale(0.0, fmt).item() == 1.0
    sw_t = tq.per_channel_scale(torch.from_numpy(w), fmt)
    sw_j = jq.per_channel_scale(jnp.asarray(w), fmt)
    np.testing.assert_array_equal(_np(sw_t), _np(sw_j))
    assert sw_t[7].item() == 1.0
    # the nn.Linear layout: the amax runs over dim 1 of the [N, K] weight
    np.testing.assert_array_equal(
        _np(tq.per_channel_scale(torch.from_numpy(w.T.copy()).t(), fmt)),
        _np(sw_j))
    for scale in (0.013, 0.5, float(np.abs(x).max()) / 127.0):
        qt = tq.quantize(torch.from_numpy(x), scale, fmt)
        qj = jq.quantize(jnp.asarray(x), scale, fmt)
        assert qt.dtype == tq._FORMATS[fmt][0]
        np.testing.assert_array_equal(_np(qt), _np(qj))
        np.testing.assert_array_equal(_np(tq.dequantize(qt, scale)),
                                      _np(jq.dequantize(qj, scale)))
    # per-channel quantization of the weight
    np.testing.assert_array_equal(
        _np(tq.quantize(torch.from_numpy(w), sw_t[None, :], fmt)),
        _np(jq.quantize(jnp.asarray(w), sw_j[None, :], fmt)))


@pytest.mark.parametrize("fmt", FMTS)
def test_delayed_scale_and_history_bitwise(fmt):
    ht, hj = tq.amax_history_init(4), jq.amax_history_init(4)
    assert ht.dtype == torch.float32 and ht.tolist() == [0.0] * 4
    for amax in (2.0, 0.0, 100.0, 0.25, 1.0, 1.0, 1.0, 7.5):
        st = tq.delayed_scale(ht, torch.tensor(amax), fmt)
        sj = jq.delayed_scale(hj, jnp.asarray(amax, jnp.float32), fmt)
        assert st.item() == float(sj)
        prev = ht
        ht = tq.update_amax_history(ht, torch.tensor(amax))
        hj = jq.update_amax_history(hj, jnp.asarray(amax, jnp.float32))
        assert ht is not prev                     # never in place
        np.testing.assert_array_equal(_np(ht), _np(hj))
    # an empty history falls back to the current amax; a non-empty one
    # ignores it
    h0 = tq.amax_history_init(3)
    assert tq.delayed_scale(h0, 2.0, fmt).item() == \
        tq.compute_scale(2.0, fmt).item()
    h1 = tq.update_amax_history(h0, 2.0)
    assert h1.tolist() == [2.0, 0.0, 0.0]
    assert tq.delayed_scale(h1, 100.0, fmt).item() == \
        tq.compute_scale(2.0, fmt).item()


# -- (2) quantized_dot against both JAX paths ---------------------------------

DOT_CASES = {   # x shape, kernel shape, contract_ndim
    "rank3": ((4, 33, 48), (48, 40), 1),
    "ragged": ((77, 65), (65, 51), 1),
    "o_proj_two_dims": ((2, 5, 2, 16), (2, 16, 24), 2),
    "features_two_dims": ((3, 7, 32), (32, 4, 8), 1),
}


@pytest.mark.parametrize("x_scale", [None, 0.02], ids=["derived", "given"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", sorted(DOT_CASES))
def test_quantized_dot_matches_jax_xla_and_pallas(case, fmt, dt, x_scale):
    xs, ks, cd = DOT_CASES[case]
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ks) * 0.05).astype(np.float32)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    jsx = None if x_scale is None else jnp.asarray(x_scale, jnp.float32)
    tsx = None if x_scale is None else torch.tensor(x_scale)
    got = tq.quantized_dot(tx, tw, cd, fmt=fmt, x_scale=tsx)
    assert got.dtype == tdt and got.shape == xs[:len(xs) - cd] + ks[cd:]
    for impl in ("xla", "pallas"):
        want = jq.quantized_dot(jx, jw, cd, fmt=fmt, x_scale=jsx, impl=impl)
        if fmt == "int8" or dt == "bf16":
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=impl)
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-6, err_msg=impl)
    # the numerics anchor: dequantize, then a plain f32 matmul
    ref_t = tq.quantized_matmul_reference(tx, tw, cd, fmt=fmt, x_scale=tsx)
    ref_j = jq.quantized_matmul_reference(jx, jw, cd, fmt=fmt, x_scale=jsx)
    scale = np.abs(_np(ref_j)).max() + 1e-9
    np.testing.assert_allclose(_np(ref_t), _np(ref_j), atol=1e-5 * scale)
    tol = 5e-3 if dt == "f32" else 1e-2        # + one bf16 ulp of the output
    assert np.abs(_np(got) - _np(ref_t)).max() / scale < tol


# -- (2b) the two kernels' plain counterparts and the launch plan -------------

@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_pass_plain_matches_jax_quantize(fmt, dt, layout):
    """The padded K-major operands the quantize kernel writes, from JAX
    ``quantize`` bit for bit (fp8: the e4m3 values as float16, exact);
    K = 37 (5 mod 16), the pad columns zero."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    m, k, n = 19, 37, 23
    x = (rng.standard_normal((m, k)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)     # [N, K]
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    kernel = tw.t() if layout == "nk" else tw.t().contiguous()      # [K, N]
    jx, jk = jnp.asarray(x).astype(jdt), jnp.asarray(w.T).astype(jdt)
    sx = tq.compute_scale(tq._amax(tx) * 0.5, fmt)          # clips some
    sw = tq.per_channel_scale(kernel, fmt)
    qx, qw = tq._quantize_pass_plain(tx, kernel, sx, sw, fmt)
    kp = tq._qmm_plan(tx, kernel, fmt).kp
    assert kp == 48 and qx.shape == (m, kp) and qw.shape == (n, kp)
    assert qx.dtype == qw.dtype == tq._OPERAND_DTYPE[fmt]
    assert (qx[:, k:] == 0).all() and (qw[:, k:] == 0).all()
    want_x = jq.quantize(jx, jnp.asarray(sx.numpy()), fmt)
    want_w = jq.quantize(jk, jnp.asarray(sw.numpy())[None, :], fmt).T
    for got, want in ((qx, want_x), (qw, want_w)):
        # back in the format's own dtype, the bytes are JAX's
        np.testing.assert_array_equal(
            got[:, :k].to(tq._FORMATS[fmt][0]).view(torch.uint8).numpy(),
            np.asarray(want).view(np.uint8))
        np.testing.assert_array_equal(got[:, :k].float().numpy(),
                                      np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FMTS)
def test_gemm_plain_on_padded_operands_matches_jax_xla(fmt, dt):
    """The GEMM kernel's plain counterpart (the exact dot of the padded
    operands, two rounded multiplies) against JAX ``_qmm2d_xla``: int8
    bitwise, fp8 to 1e-6 (f32 summation order)."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    m, k, n = 21, 69, 30
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)     # [K, N]
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    sx = tq.compute_scale(tq._amax(tx), fmt)
    sw = tq.per_channel_scale(tw, fmt)
    got = tq._gemm_plain(*tq._quantize_pass_plain(tx, tw, sx, sw, fmt),
                         sx, sw, fmt)
    want = jq._qmm2d_xla(jnp.asarray(x).astype(jdt),
                         jnp.asarray(w).astype(jdt),
                         jnp.asarray(sx.numpy()), jnp.asarray(sw.numpy()),
                         fmt)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if fmt == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_qmm_plan_lays_out_the_launches():
    bf = torch.bfloat16
    x = torch.zeros(8192, 4096, dtype=bf)
    w_nk = torch.zeros(14336, 4096, dtype=bf)          # an nn.Linear weight
    p = tq._qmm_plan(x, w_nk.t(), "int8")
    assert (p.m, p.n, p.k, p.kp) == (8192, 14336, 4096, 4096)
    assert (p.w_layout, p.ldw, p.w_copy) == ("nk", 4096, False)
    assert p.bn == 256
    assert p.map_a == ((4096, 8192), 4096, (128, 128))
    assert p.map_b == ((4096, 14336), 4096, (128, 256))
    # fp8's operands are float16: rows of 2 Kp bytes; narrow N takes 128
    p = tq._qmm_plan(x, w_nk.t(), "fp8")
    assert (p.kp, p.bn) == (4096, 256)
    assert p.map_a == ((8192, 8192), 8192, (128, 128))
    assert p.map_b == ((8192, 14336), 8192, (128, 256))
    for fmt in FMTS:
        assert tq._qmm_plan(x, torch.zeros(1024, 4096, dtype=bf).t(),
                            fmt).bn == 128
    # [K, N] row-major, with a padded leading dimension; K padded to 16
    xs = torch.zeros(10, 37)
    w_kn = torch.zeros(37, 40)[:, :30]
    p = tq._qmm_plan(xs, w_kn, "int8")
    assert (p.kp, p.w_layout, p.ldw, p.w_copy) == (48, "kn", 40, False)
    assert p.map_a == ((48, 10), 48, (128, 128))
    assert tq._qmm_plan(torch.zeros(3, 0), torch.zeros(0, 5), "int8").kp == 16
    # neither layout: the weight is copied to [K, N]
    p = tq._qmm_plan(xs, torch.zeros(30, 37 * 2).t()[::2], "int8")
    assert (p.w_layout, p.ldw, p.w_copy) == ("kn", 30, True)
    # float16 takes the same layout (dtype code 2); the head's shapes:
    # N = llama3-8b's vocab (501 tiles of 256), over 2 'tp' ranks, and
    # the ragged vocabs of GPT-2 and Phi-2
    assert tq._DTYPE_CODE[torch.float16] == 2
    p16 = tq._qmm_plan(x.half(), w_nk.half().t(), "int8")
    assert p16 == tq._qmm_plan(x, w_nk.t(), "int8")
    for n, tiles in ((128256, 501), (128256 // 2, 251), (50257, 197),
                     (51200, 200)):
        head = torch.empty(n, 4096, dtype=torch.float16, device="meta").t()
        for fmt in FMTS:
            p = tq._qmm_plan(x.half().to("meta"), head, fmt)
            row = 4096 * tq._OPERAND_DTYPE[fmt].itemsize
            assert (p.n, p.bn, p.w_layout, p.w_copy) == (n, 256, "nk", False)
            assert p.map_b == ((row, n), row, (128, 256))
            assert -(-p.n // p.bn) == tiles
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tq._qmm_plan(xs.double(), w_kn.double(), "int8")
    with pytest.raises(ValueError, match="must match"):
        tq._qmm_plan(xs, w_kn.to(bf), "int8")
    with pytest.raises(ValueError, match="overflow the int32"):
        tq._qmm_plan(torch.zeros(1, 133_001), torch.zeros(133_001, 1), "int8")
    with pytest.raises(ValueError, match="quant format"):
        tq._qmm_plan(xs, w_kn, "int4")


def test_quantized_dot_reads_a_linear_weight_where_it_lies():
    """``weight.t()`` of an ``nn.Linear`` ([N, K] memory) gives the bits
    of the contiguous [K, N] kernel, with no copy on the way in."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((9, 24)).astype(np.float32))
    w_nk = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32))
    for fmt in FMTS:
        a = tq.quantized_dot(x, w_nk.t(), fmt=fmt)
        b = tq.quantized_dot(x, w_nk.t().contiguous(), fmt=fmt)
        assert torch.equal(a, b)


def test_quant_entry_points_default_to_the_card():
    cfg = get_preset("llama-tiny", num_layers=1, quant="int8")
    if torch.cuda.is_available():
        assert tq.QuantLinear(8, 4).weight.device.type == "cuda"
        assert all(h.device.type == "cuda"
                   for h in init_quant_state(cfg).values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tq.QuantLinear(8, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_quant_state(cfg)
    assert tq.QuantLinear(8, 4, device="cpu").init_history().device.type \
        == "cpu"
    assert len(init_quant_state(cfg, "cpu")) == 7


def test_quantized_dot_validation():
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="quant format"):
        tq.quantized_dot(x, w, fmt="int4")
    with pytest.raises(ValueError, match="impl"):
        tq.quantized_dot(x, w, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.quantized_dot(x, w, impl="cuda")
    with pytest.raises(ValueError, match="contract_ndim"):
        tq.quantized_dot(x, w, 2)
    with pytest.raises(ValueError, match="mismatch"):
        tq.quantized_dot(x, torch.zeros(7, 3))
    assert (tq.quantized_dot(x, w) == 0).all()       # amax 0 -> scale 1


# -- (3) straight-through gradients --------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
def test_straight_through_gradients_match_jax(fmt):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 12)) * 0.1).astype(np.float32)

    def jloss(w_, x_):
        return jnp.sum(jq.quantized_dot(x_, w_, 1, fmt=fmt, impl="xla") ** 2)
    gw, gx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (tq.quantized_dot(tx, tw, 1, fmt=fmt) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-6)
    # through the nn.Linear layout the weight gradient is contiguous and
    # the same numbers
    lin = torch.from_numpy(w.T.copy()).requires_grad_()
    tx2 = torch.from_numpy(x).requires_grad_()
    (tq.quantized_dot(tx2, lin.t(), 1, fmt=fmt) ** 2).sum().backward()
    assert lin.grad.is_contiguous()
    np.testing.assert_allclose(lin.grad.numpy().T, tw.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    # the scales get no gradient
    sx = torch.tensor(0.05, requires_grad=True)
    tq.quantized_dot(tx2, lin.t(), fmt=fmt, x_scale=sx).sum().backward()
    assert sx.grad is None


# -- (4) a site's history over several calls -----------------------------------

@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("fmt", FMTS)
def test_site_history_matches_quant_dense_general(fmt, bias):
    rng = np.random.default_rng(4)
    k, n, hl = 24, 20, 3
    jmod = jq.QuantDenseGeneral(features=n, use_bias=bias, quant=fmt,
                                quant_impl="xla", amax_history_len=hl)
    xs = [(rng.standard_normal((5, 6, k)) * a).astype(np.float32)
          for a in (1.0, 4.0, 0.3, 0.3, 0.3, 2.0)]
    var = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    kern = np.asarray(var["params"]["kernel"])
    b_np = (rng.standard_normal(n).astype(np.float32) if bias else None)
    params = {"kernel": jnp.asarray(kern)}
    if bias:
        params["bias"] = jnp.asarray(b_np)
    lin = tq.QuantLinear(k, n, bias=bias, quant=fmt, amax_history_len=hl,
                         device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kern.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b_np))
    assert [n_ for n_, _ in lin.named_parameters()] == \
        (["weight", "bias"] if bias else ["weight"])
    hist_j = var["quant"]
    hist_t = lin.init_history()
    assert hist_t.tolist() == [0.0] * hl
    for x in xs:
        # a mutable collection: the history advances
        yj, mut = jmod.apply({"params": params, "quant": hist_j},
                             jnp.asarray(x), mutable=["quant"])
        yt, new_t = lin(torch.from_numpy(x), hist_t)
        np.testing.assert_array_equal(_np(new_t),
                                      _np(mut["quant"]["amax_history"]))
        if fmt == "int8":
            np.testing.assert_array_equal(_np(yt), _np(yj))
        else:
            np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-6,
                                       atol=1e-6)
        # not mutable (evaluation): the same output, the history untouched
        yj_e = jmod.apply({"params": params, "quant": hist_j},
                          jnp.asarray(x))
        yt_e, same = lin(torch.from_numpy(x), hist_t, update=False)
        assert same is hist_t
        assert torch.equal(yt_e, yt)
        np.testing.assert_array_equal(_np(yj_e), _np(yj))
        hist_j, hist_t = mut["quant"], new_t
    assert (hist_t > 0).sum().item() == hl


# -- (5) llama-tiny with quantized sites ---------------------------------------

def _batch(seed, vocab=32000):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, size=(B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def tiny():
    """(jax params as numpy, a realistic 'quant' collection as numpy):
    llama-tiny in f32; the histories are those one JAX forward leaves,
    so the scales sit where training puts them."""
    from test_torch_model import seeded_jax_params
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, quant="int8",
                      quant_impl="xla", quant_amax_history_len=4)
    params = seeded_jax_params()
    cfg = get_preset("llama-tiny", quant="int8", quant_amax_history_len=4)
    _, mut = JaxLM(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, params),
         "quant": quant_to_jax(cfg, init_quant_state(cfg, "cpu"))},
        jnp.asarray(_batch(100)["input_ids"]), mutable=["quant"])
    return params, jax.tree.map(np.asarray, mut["quant"])


# the 'head' site: the materialised head's lm_head, with the blocks' sites,
# and alone on a head_bias model (its bias added after the quantized
# product); its history is a mid-run one, the blocks' fresh.  These
# cases take a narrow model, its weights the port's seeded init carried
# to JAX, and JAX's XLA paths (its Pallas kernels are the other cases'
# and the dot tests')
HEAD_HISTORY = np.asarray([3.25, 4.0, 2.5, 0.0], np.float32)
NARROW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=128)


def _narrow_params(seed=3, **fields):
    """Seeded weights of NARROW (with ``fields``) in JAX's layout."""
    from test_torch_model import seeded_jax_params
    return seeded_jax_params(seed, **NARROW, **fields)


@pytest.mark.parametrize("fmt,sites", [("int8", ("attn", "mlp")),
                                       ("fp8", ("attn", "mlp")),
                                       ("int8", ("mlp",)),
                                       ("int8", ("attn", "mlp", "head")),
                                       ("int8", ("head",))])
def test_quant_model_logits_and_gradients_match_jax(tiny, fmt, sites):
    head = "head" in sites
    head_bias = sites == ("head",)
    kw = dict(quant=fmt, quant_sites=sites, quant_amax_history_len=4,
              head_bias=head_bias, **(NARROW if head else {}))
    impl = "xla" if head else "pallas"
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32,
                      attention_impl=impl, quant_impl=impl, **kw)
    cfg = get_preset("llama-tiny", dtype=torch.float32, **kw)
    if head:
        params = _narrow_params(head_bias=head_bias)
        if head_bias:
            rng = np.random.default_rng(12)
            params["lm_head"]["bias"] = rng.standard_normal(
                NARROW["vocab_size"]).astype(np.float32)
        quant = {"lm_head": {"amax_history": HEAD_HISTORY}}
        if len(sites) > 1:
            quant["layers"] = quant_to_jax(
                cfg, init_quant_state(cfg, "cpu"))["layers"]
    else:
        params, quant = tiny
        quant = {"layers": {"block": {
            s: quant["layers"]["block"][s] for s in sites}}}
    ids = _batch(5, vocab=cfg.vocab_size)["input_ids"]
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100, np.int32)], 1)

    def jloss(p):
        logits, mut = JaxLM(jcfg).apply(
            {"params": p, "quant": jax.tree.map(jnp.asarray, quant)},
            jnp.asarray(ids), mutable=["quant"])
        s, c = jax_loss(logits, jnp.asarray(labels))
        return s / c, (logits, mut["quant"])
    (jl, (jlogits, jnew)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    # execution flips, the layout does not
    assert [n for n, _ in model.named_parameters()] == \
        [n for n, _ in params_from_jax(
            dataclasses.replace(cfg, quant="none"), params,
            device="cpu").named_parameters()]
    hist = quant_from_jax(cfg, quant, device="cpu")
    assert tuple(hist) == quant_site_names(cfg)
    assert len(hist) == (cfg.num_layers * (4 * ("attn" in sites)
                                           + 3 * ("mlp" in sites))
                         + ("head" in sites))
    assert (tuple(hist)[-1] == "lm_head") == ("head" in sites)
    new = {}
    logits = model(torch.from_numpy(ids), quant=hist, quant_out=new)
    loss = loss_fn(logits, torch.from_numpy(labels).long())
    loss.backward()

    top = np.abs(np.asarray(jlogits)).max()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=3e-2 * top)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    # the new histories: the old ones rolled by one, this call's amax
    # first; layer 0 reads the embedding itself, so its q/k/v amax is
    # exact, later ones carry the flips
    got_q = quant_to_jax(cfg, new)
    for (path, a), (path_j, b) in zip(_leaves(got_q), _leaves(
            jax.tree.map(np.asarray, jnew))):
        assert path == path_j
        np.testing.assert_allclose(a, b, rtol=2e-2,
                                   err_msg=jax.tree_util.keystr(path))
        np.testing.assert_array_equal(a[..., 1:], b[..., 1:])
    got = params_to_jax(cfg, {n: p.grad for n, p in model.named_parameters()})
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for path, g in _leaves(got):
        ref = want[path]
        np.testing.assert_allclose(g, ref, atol=3e-2 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_quant_round_trips_through_convert(tiny):
    _, quant = tiny
    cfg = get_preset("llama-tiny", quant="int8", quant_amax_history_len=4)
    back = quant_to_jax(cfg, quant_from_jax(cfg, quant, device="cpu"))
    for (pa, a), (pb, b) in zip(_leaves(back), _leaves(quant)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    # the 'head' site's lm_head history, beside the blocks' and alone
    for sites in (("attn", "mlp", "head"), ("head",)):
        c = dataclasses.replace(cfg, quant_sites=sites)
        tree = {"lm_head": {"amax_history": HEAD_HISTORY}}
        if len(sites) > 1:
            tree["layers"] = quant["layers"]
        hist = quant_from_jax(c, tree, device="cpu")
        assert list(hist)[-1] == "lm_head" and len(hist) == len(
            quant_site_names(c))
        back = quant_to_jax(c, hist)
        assert sorted(back) == sorted(tree)
        for (pa, a), (pb, b) in zip(_leaves(back), _leaves(tree)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    assert quant_from_jax(get_preset("llama-tiny"), quant,
                          device="cpu") is None
    with pytest.raises(ValueError, match="history of shape"):
        quant_from_jax(get_preset("llama-tiny", quant="int8"), quant,
                       device="cpu")


# -- (6) the trainer's trajectory ----------------------------------------------

# -- (7) remat ------------------------------------------------------------------

def test_remat_advances_each_history_once_and_saves_the_forward(
        tiny, monkeypatch):
    """Under every policy the gradients equal the no-remat ones bitwise
    and the step leaves the same histories; the plain quantized forward
    runs once per site under 'save_attn*' and twice under 'nothing' (it
    re-runs in the recompute, reads the same history and gives the same
    bits)."""
    params, quant = tiny
    blk = jax.tree.map(lambda a: a[:2], params["layers"]["block"])
    params = dict(params, layers={"block": blk})
    base = get_preset("llama-tiny", dtype=torch.float32, num_layers=2,
                      quant="int8", quant_amax_history_len=4)
    hist = quant_from_jax(base, jax.tree.map(lambda a: a[:2], quant),
                          device="cpu")
    frozen = {n: h.clone() for n, h in hist.items()}
    ids = torch.from_numpy(_batch(6)["input_ids"])
    labels = torch.roll(ids, -1, dims=1).long()
    calls = {"n": 0}
    plain = tq._qmm2d_plain

    def counting(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)
    monkeypatch.setattr(tq, "_qmm2d_plain", counting)

    grads, news, counts = {}, {}, {}
    for policy in (None, "nothing", "save_attn", "save_attn_mlp"):
        c = base if policy is None else dataclasses.replace(
            base, remat=True, remat_policy=policy)
        model = params_from_jax(c, params, device="cpu", trainable=True)
        calls["n"], new = 0, {}
        loss_fn(model(ids, quant=hist, quant_out=new), labels).backward()
        counts[policy] = calls["n"]
        grads[policy] = [p.grad for p in model.parameters()]
        news[policy] = new
        # the histories the step started with are never touched
        assert all(torch.equal(hist[n], frozen[n]) for n in hist)
    sites = 7 * 2
    # 'save_attn' recomputes the gate/up projections (2 per layer)
    assert counts == {None: sites, "nothing": 2 * sites,
                      "save_attn": sites + 2 * 2, "save_attn_mlp": sites}
    for policy in ("nothing", "save_attn", "save_attn_mlp"):
        for a, b in zip(grads[policy], grads[None]):
            assert torch.equal(a, b)
        assert news[policy].keys() == news[None].keys() == hist.keys()
        for n in hist:
            assert torch.equal(news[policy][n], news[None][n])
            # advanced exactly once: rolled by one, this step's amax first
            assert torch.equal(news[policy][n][1:], hist[n][:-1])


def test_trainer_step_commits_histories_once_under_remat():
    mc = get_preset("llama-tiny", num_layers=2, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128)
    for policy in ("nothing", "save_attn_mlp"):
        conf = tt.Config(
            compute=tt.ComputeConfig(dtype=torch.float32, quant="int8",
                                     quant_amax_history_len=3),
            memory=tt.MemoryConfig(gc=True, gc_policy=policy))
        trainer, _ = accelerate(mc, None, conf, device="cpu")
        trainer.init()
        batch = _batch(7, vocab=128)
        for step in range(1, 5):
            trainer.step(batch)
            filled = min(step, 3)
            for n, h in trainer.state.quant.items():
                assert (h > 0).sum().item() == filled, (policy, step, n)
                assert (h[:filled] > 0).all()      # the newest first


# -- (8) evaluation reads; a quant-trained model serves ------------------------

def test_eval_reads_scales_and_mutates_nothing():
    mc = get_preset("llama-tiny", num_layers=2, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128)
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32,
                                              quant="int8"))
    trainer, _ = accelerate(mc, None, conf, device="cpu")
    trainer.init()
    batch = _batch(8, vocab=128)
    for _ in range(3):
        trainer.step(batch)
    before = {n: h.clone() for n, h in trainer.state.quant.items()}
    assert all((h > 0).sum().item() == 3 for h in before.values())
    l1 = trainer.eval_step(batch)["loss"].item()
    l2 = trainer.eval_step(batch)["loss"].item()
    assert l1 == l2 and np.isfinite(l1)
    assert trainer.model.training and trainer.state.step == 3
    for n, h in trainer.state.quant.items():
        assert torch.equal(h, before[n])
    # a forward with no quant_out records nothing either
    ids = torch.from_numpy(batch["input_ids"]).long()
    with torch.no_grad():
        trainer.model.eval()
        trainer.model(ids, quant=trainer.state.quant)
        trainer.model.train()
    assert all(torch.equal(h, before[n])
               for n, h in trainer.state.quant.items())
    with pytest.raises(ValueError, match="no amax histories"):
        trainer.model(ids)


def test_quant_trained_model_serves_in_the_compute_dtype():
    """Serving treats the quant fields as inert, as the JAX scheduler
    does: a quant-trained model gives the tokens of the same weights
    served with quant off."""
    mc = get_preset("llama-tiny", num_layers=2, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128,
                    max_seq_len=128, dtype=torch.float32)
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32,
                                              quant="fp8"))
    trainer, _ = accelerate(mc, None, conf, device="cpu")
    trainer.init()
    for i in range(2):
        trainer.step(_batch(9 + i, vocab=128))
    model = trainer.model
    assert model.cfg.quant == "fp8"
    serve = tt.Config(serve=tt.ServeConfig(block_size=8, num_blocks=32,
                                           max_slots=2, prefill_chunk=16))
    reqs = [tt.Request(prompt_ids=list(range(3, 20)), max_new_tokens=6),
            tt.Request(prompt_ids=[5, 9, 2], max_new_tokens=6)]
    eng = tt.ServeEngine(model.requires_grad_(False).eval(), serve,
                         device="cpu")
    got = [r.tokens for r in eng.generate(reqs)]
    eng.close()
    plain = TransformerLM(dataclasses.replace(model.cfg, quant="none"),
                          device="cpu")
    plain.load_state_dict(model.state_dict())
    eng = tt.ServeEngine(plain.requires_grad_(False).eval(), serve,
                         device="cpu")
    want = [r.tokens for r in eng.generate(reqs)]
    eng.close()
    assert got == want and all(len(t) == 6 for t in got)


# -- (9) what is not ported raises by name; quant off changes nothing ----------

def test_unported_quant_compositions_raise():
    """What still raises, with JAX's types and messages: quant under
    'pp' (a ConfigError), the 'head' site on a tied head (a ValueError
    of the forward) and with the fused CE head (a TrainerStateError).
    The 'head' site, float16 and 'tp' run (the parity cases above,
    tests/test_torch_quant_steps.py and the ranks tests)."""
    from torchacc_tpu_torch.errors import TrainerStateError
    mc = get_preset("llama-tiny", num_layers=1)
    with pytest.raises(tt.ConfigError, match="pipeline"):
        tt.Config(compute=tt.ComputeConfig(quant="int8"),
                  dist=tt.DistConfig(pp=tt.PPConfig(
                      size=2, num_micro_batches=2))).validate()
    head = tt.ComputeConfig(quant="int8", quant_sites=("mlp", "head"))
    with pytest.raises(TrainerStateError, match="fused_kernels=False"):
        accelerate(mc, None, tt.Config(compute=head), device="cpu")
    # the materialised head (fused_kernels=False, or a head_bias model)
    # takes the site; float16 and tp validate
    accelerate(mc, None, tt.Config(compute=dataclasses.replace(
        head, fused_kernels=False)), device="cpu")
    accelerate(dataclasses.replace(mc, head_bias=True), None,
               tt.Config(compute=head), device="cpu")
    tt.Config(compute=tt.ComputeConfig(quant="int8", dtype=torch.float16),
              dist=tt.DistConfig(tp=tt.TPConfig(2))).validate()
    model = TransformerLM(dataclasses.replace(
        mc, quant="int8", quant_sites=("attn", "head"),
        tie_embeddings=True), device="cpu")
    with pytest.raises(ValueError, match="tie_embeddings"):
        model(torch.zeros((1, 4), dtype=torch.long),
              quant=init_quant_state(model.cfg, "cpu"))
    for bad, match in ((dict(quant="int4"), "none.int8.fp8"),
                       (dict(quant_impl="pallas"), "quant_impl"),
                       (dict(quant_amax_history_len=0), "history_len"),
                       (dict(quant="int8", quant_sites=()), "at least one"),
                       (dict(quant="int8", quant_sites=("ffn",)),
                        "entries must be in")):
        with pytest.raises(tt.ConfigError, match=match):
            tt.ComputeConfig(**bad).validate()
    # the sites are inert while quant is off, as in JAX
    tt.ComputeConfig(quant_sites=("head",)).validate()


def test_quant_none_leaves_state_and_results_as_they_were():
    mc = get_preset("llama-tiny", num_layers=2, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128)
    batch = _batch(11, vocab=128)
    runs = {}
    for quant in ("none", "int8"):
        conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32,
                                                  quant=quant), seed=3)
        trainer, _ = accelerate(mc, None, conf, device="cpu")
        state = trainer.init()
        runs[quant] = (state, {n: p.clone() for n, p in state.params.items()},
                       [trainer.step(batch)["loss"].item()
                        for _ in range(2)])
    assert runs["none"][0].quant is None
    assert init_quant_state(dataclasses.replace(mc, quant="none")) is None
    assert set(runs["int8"][0].quant) == set(quant_site_names(
        dataclasses.replace(mc, quant="int8")))
    # identical parameter trees: same names, shapes and init stream
    for n, p in runs["none"][1].items():
        assert torch.equal(p, runs["int8"][1][n])
    # the unquantized model ignores a quant argument's absence, and its
    # loss is what the quantized one tracks (not equals)
    l0, l8 = runs["none"][2], runs["int8"][2]
    assert l0 != l8
    np.testing.assert_allclose(l8, l0, rtol=2e-2)
