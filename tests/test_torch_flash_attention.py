"""The port's flash attention (plain path: ``ops/attention.py`` behind
the ``ops/flash_attention.py`` custom ops) against the JAX package's
Pallas kernels B1-B3, run in interpret mode on the CPU as
tests/test_flash_attention.py runs them.  Inputs come from numpy seeds;
both sides compute in f32.

Tolerances: o and lse atol = rtol = 2e-5 (the same f32 softmax, tiled
online in JAX and dense in the port); dq/dk/dv atol = rtol = 1e-4 (the
backward sums up to group x sk f32 products in another order).  The
ALiBi and dropout cases hold the same: the bias is the same f32
expression and the keep mask is bit for bit JAX's (a wrong keep bit
moves o by a whole probability).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
from torchacc_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_bwd as jax_flash_bwd,
    segment_ids_from_positions as jax_seg_from_pos,
)
from torchacc_tpu.ops._common import dropout_keep as jax_dropout_keep
from torchacc_tpu.ops._common import mix32 as jax_mix32
from torchacc_tpu_torch.ops._common import NEG_INF, dropout_keep, mix32
from torchacc_tpu_torch.ops.attention import (
    _dropped,
    _mask4,
    _repeat_kv,
    _scores,
    attention_reference,
    attention_reference_bwd,
)
from torchacc_tpu_torch.ops.attn import attention
from torchacc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    segment_ids_from_positions,
)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _packed_positions(rng, b, s):
    """Position ids of documents of random lengths packed into each row."""
    rows = []
    for _ in range(b):
        pos = []
        while len(pos) < s:
            pos += list(range(int(rng.integers(3, 30))))
        rows.append(pos[:s])
    return np.asarray(rows, np.int32)


CASES = {   # b, sq, sk, hq, hk, d, options
    "causal_gqa_8_4": (2, 64, 64, 8, 4, 32, {}),
    "causal_mqa_8_1": (1, 72, 72, 8, 1, 32, {}),
    "full_mha": (1, 48, 48, 4, 4, 32, dict(causal=False)),
    "window": (1, 96, 96, 4, 2, 32, dict(window=(20, -1))),
    "window_both_sides": (1, 64, 64, 4, 2, 32,
                          dict(causal=False, window=(9, 7))),
    "softcap": (2, 64, 64, 8, 4, 32, dict(logit_softcap=5.0)),
    "segments_gqa_8_4": (2, 80, 80, 8, 4, 32, dict(segments=True)),
    "segments_window_softcap": (1, 96, 96, 8, 1, 32,
                                dict(segments=True, window=(16, -1),
                                     logit_softcap=8.0)),
    "sk_gt_sq": (1, 40, 96, 4, 2, 32, {}),
    "sq_gt_sk_empty_rows": (1, 96, 40, 4, 2, 32, {}),
    "alibi_gqa_8_4": (2, 64, 64, 8, 4, 32, dict(alibi=True)),
    "alibi_sk_gt_sq_window_softcap": (1, 40, 96, 4, 2, 32,
                                      dict(alibi=True, window=(30, -1),
                                           logit_softcap=6.0)),
    "alibi_full_segments": (1, 80, 80, 8, 1, 32,
                            dict(alibi=True, causal=False, segments=True)),
    "dropout_gqa_8_4": (2, 64, 64, 8, 4, 32,
                        dict(dropout_p=0.1, dropout_seed=5)),
    "dropout_half_mqa_segments": (2, 80, 80, 8, 1, 32,
                                  dict(dropout_p=0.5, dropout_seed=123456789,
                                       segments=True)),
    "dropout_alibi_softcap_sk_gt_sq": (1, 40, 96, 4, 2, 32,
                                       dict(dropout_p=0.25, dropout_seed=0,
                                            alibi=True, logit_softcap=5.0)),
}


def _inputs(seed, b, sq, sk, hq, hk, d, segments):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    seg = None
    if segments:
        seg = np.array(jax_seg_from_pos(
            jnp.asarray(_packed_positions(rng, b, sq))))
    return q, k, v, do, seg


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax_kernels(case):
    b, sq, sk, hq, hk, d, opts = CASES[case]
    opts = dict(opts)
    q, k, v, do, seg = _inputs(0, b, sq, sk, hq, hk, d,
                               opts.pop("segments", False))
    jseg = {} if seg is None else dict(q_segment_ids=jnp.asarray(seg),
                                       kv_segment_ids=jnp.asarray(seg))
    tseg = {} if seg is None else dict(
        q_segment_ids=torch.from_numpy(seg),
        kv_segment_ids=torch.from_numpy(seg))
    if opts.pop("alibi", False):
        slopes = (2.0 ** (-8.0 * np.arange(1, hq + 1) / hq)).astype(
            np.float32)
        jseg["alibi_slopes"] = jnp.asarray(slopes)
        tseg["alibi_slopes"] = torch.from_numpy(slopes)
    blocks = dict(block_q=32, block_k=32)   # several tiles per side

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jo, jlse = jax_flash(jq, jk, jv, return_lse=True, **jseg, **blocks,
                         **opts)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, **jseg, **blocks,
                                                **opts), jq, jk, jv)
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to, tlse = flash_attention(tq, tk, tv, return_lse=True, **tseg, **opts)
    out = flash_attention(tq, tk, tv, **tseg, **opts)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))

    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)
    for name, a, b_ in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL,
                                   err_msg=name)
    # the standalone backward agrees with the JAX one from the same (o, lse)
    sb = flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                             to, tlse, torch.from_numpy(do), **tseg, **opts)
    jb = jax_flash_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), **jseg,
                       **blocks, **opts)
    for a, b_ in zip(sb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL)


def test_empty_rows_give_zeros_and_neg_inf_lse():
    b, sq, sk, hq, hk, d, _ = CASES["sq_gt_sk_empty_rows"]
    q, k, v, do, _ = _inputs(1, b, sq, sk, hq, hk, d, False)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention(tq, tk, tv, return_lse=True)
    empty = sq - sk          # query i sits at i + sk - sq: negative = blind
    assert (o[:, :empty] == 0).all()
    assert (lse[:, :, :empty] == -1e30).all()
    assert torch.isfinite(lse[:, :, empty:]).all()
    out = flash_attention(tq, tk, tv)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert (dq[:, :empty] == 0).all()
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_segment_ids_from_positions_matches_jax():
    pos = _packed_positions(np.random.default_rng(2), 3, 50)
    np.testing.assert_array_equal(
        segment_ids_from_positions(torch.from_numpy(pos)).numpy(),
        np.asarray(jax_seg_from_pos(jnp.asarray(pos))))


def test_dispatcher_routes_cpu_tensors_to_the_plain_path():
    q, k, v, _, _ = _inputs(3, 1, 32, 32, 4, 2, 32, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = attention(tq, tk, tv, impl="auto")
    ref = attention(tq, tk, tv, impl="torch")
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention(tq, tk, tv, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        attention(tq, tk, tv, impl="pallas")


@pytest.mark.parametrize("kw", [
    dict(q_offset=8), dict(k_offset=2), dict(h_offset=1), dict(b_offset=1)],
    ids=["q_offset", "k_offset", "h_offset", "b_offset"])
def test_unported_features_raise(kw):
    """The global offsets are ported (B-1): a host int reaches the plain
    version (``tests/test_torch_context_parallel.py`` holds it against
    JAX's kernels); what still raises is an offset that is not a host int
    (JAX also takes traced ints) or that int32 does not hold."""
    q, k, v, _, _ = _inputs(4, 1, 16, 16, 4, 2, 32, False)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    (name, off), = kw.items()
    drop = dict(dropout_p=0.1, dropout_seed=3)
    out = flash_attention(*args, **kw, **drop)
    assert torch.equal(out, attention_reference(*args, **kw, **drop))
    assert not torch.equal(out, flash_attention(*args, **drop))
    with pytest.raises(TypeError, match="host int"):
        flash_attention(*args, **{name: torch.tensor(off)})
    with pytest.raises(ValueError, match="int32"):
        flash_attention(*args, **{name: 2 ** 31})


def test_alibi_and_dropout_arguments_are_checked():
    q, k, v, _, _ = _inputs(4, 1, 16, 16, 4, 2, 32, False)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention(*args, alibi_slopes=torch.ones(3))
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention(*args, dropout_p=1.0)
    with pytest.raises(TypeError, match="host int"):
        flash_attention(*args, dropout_p=0.1, dropout_seed=torch.tensor(3))
    # the slopes are hyperparameters: no gradient reaches them
    slopes = torch.full((4,), 0.5, requires_grad=True)
    tq = args[0].clone().requires_grad_()
    flash_attention(tq, args[1], args[2], alibi_slopes=slopes).sum().backward()
    assert slopes.grad is None and tq.grad is not None
    # no seed means seed 0; p = 0 is no dropout at all
    a = flash_attention(*args, dropout_p=0.3)
    b = flash_attention(*args, dropout_p=0.3, dropout_seed=0)
    assert torch.equal(a, b)
    assert torch.equal(flash_attention(*args, dropout_p=0.0, dropout_seed=9),
                       flash_attention(*args))


@pytest.mark.parametrize("p", [0.1, 0.5, 1.0 - 2.0 ** -30],
                         ids=["p0.1", "p0.5", "p~1"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -3])
def test_dropout_keep_matches_jax_bit_for_bit(seed, p):
    """The port's int64-masked hash against the JAX uint32 one: same
    keep bits for several seeds (a negative one wraps), heads, batches
    and position offsets."""
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 2 ** 32, size=64, dtype=np.uint64)
    np.testing.assert_array_equal(
        mix32(torch.from_numpy(vals.astype(np.int64))).numpy(),
        np.asarray(jax_mix32(jnp.asarray(vals.astype(np.uint32)))))
    jseed = jnp.asarray(seed, jnp.int32)
    for b_off, h_off, q_off, k_off in ((0, 0, 0, 0), (3, 5, 4096, 17),
                                       (0, 31, 100000, 99999)):
        b_idx = (np.arange(2) + b_off)[:, None, None]
        h_idx = (np.arange(3) + h_off)[None, :, None]
        q_pos, k_pos = np.arange(37) + q_off, np.arange(29) + k_off
        want = jax_dropout_keep(
            jseed, jnp.asarray(b_idx, jnp.uint32),
            jnp.asarray(h_idx, jnp.uint32), jnp.asarray(q_pos, jnp.int32),
            jnp.asarray(k_pos, jnp.int32), p)
        got = dropout_keep(seed, torch.from_numpy(b_idx),
                           torch.from_numpy(h_idx), torch.from_numpy(q_pos),
                           torch.from_numpy(k_pos), p)
        assert got.shape == (2, 3, 37, 29) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = got.float().mean().item()
    assert abs(kept - (1 - p)) < 0.05


def test_dropout_leaves_the_lse_undropped_and_scales_pv():
    q, k, v, _, _ = _inputs(7, 2, 48, 48, 4, 2, 32, False)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    _, lse0 = flash_attention(*args, return_lse=True)
    o, lse = flash_attention(*args, return_lse=True, dropout_p=0.4,
                             dropout_seed=11)
    assert torch.equal(lse, lse0)
    # with v = 1 an output entry is the kept share of its row over 1 - p
    ones = torch.ones_like(args[2])
    o1 = flash_attention(args[0], args[1], ones, causal=False, dropout_p=0.4,
                         dropout_seed=11)
    kept = o1[..., 0] * (1 - 0.4)
    assert 0.5 < kept.mean().item() < 0.7 and kept.max().item() <= 1.0 + 1e-5


def test_mismatched_segment_ids_raise():
    q, k, v, _, _ = _inputs(5, 1, 16, 16, 4, 2, 32, False)
    with pytest.raises(ValueError, match="together"):
        flash_attention(*map(torch.from_numpy, (q, k, v)),
                        q_segment_ids=torch.zeros(1, 16, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the bf16 backward kernels' rounding, rehearsed on the CPU
# ---------------------------------------------------------------------------

# the card's tolerance for the bf16 backward kernels against the f32
# plain backward from the same (o, lse): one bf16 ulp
# (tests/test_torch_kernels_cuda.py GRAD_TOL, chip_smoke.py grad_tol)
CARD_BF16_GRAD_TOL = dict(atol=1e-3, rtol=1e-2)


def _bf16(x, dt=torch.bfloat16):
    return x.to(dt).float()


def _bwd_rounded(q, k, v, o, lse, do, split, *, causal=True, window=(-1, -1),
                 q_segment_ids=None, kv_segment_ids=None, dt=torch.bfloat16):
    """A mirror of the plain backward (``attention_reference_bwd``) that
    rounds P~ and dS to bf16 before the second products, as the bf16
    kernels feed them to the tensor cores: once (``split=False``, the JAX
    kernels' ``ds.astype(k.dtype)`` and ``p_tilde.astype(do.dtype)``) or
    as hi + lo, two bf16 values whose sum keeps ~16 bits (``split=True``,
    what B2 and B3 do).  ``dt``: the 16-bit type (bf16, or f16 for the
    fp16 step)."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    s, dcap = _scores(q, k, scale, 0.0)
    mask = _mask4(q, k, causal, window, q_segment_ids, kv_segment_ids)
    p = torch.where(mask, torch.exp(s - lse[..., None].float()), 0.0)
    p_tilde = _dropped(p, 0.0, None)
    kr, vr = _repeat_kv(k, hq).float(), _repeat_kv(v, hq).float()
    qf, dof = q.float(), do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = (p_tilde * dp - p * delta[..., None]) * dcap * scale

    def r(x):
        hi = _bf16(x, dt)
        return hi + _bf16(x - hi, dt) if split else hi

    dq = torch.einsum("bhqk,bkhd->bqhd", r(ds), kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", r(ds), qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", r(p_tilde), dof)
    if hq > hk:
        dk = dk.reshape(b, sk, hk, hq // hk, d).sum(dim=3)
        dv = dv.reshape(b, sk, hk, hq // hk, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _worst_over_tol(a, b, tol):
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max().item()


def _bf16_inputs(seed, b, s, hq, hk, d, lo, hi, dt=torch.bfloat16):
    """bf16 (or ``dt``) q, k, v, dO from numpy and packed documents of
    lengths in [lo, hi)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dt)
    q, k, v, do = f(b, s, hq, d), f(b, s, hk, d), f(b, s, hk, d), \
        f(b, s, hq, d)
    rows = []
    for _ in range(b):
        pos = []
        while len(pos) < s:
            pos += list(range(int(rng.integers(lo, hi))))
        rows.append(pos[:s])
    seg = segment_ids_from_positions(torch.from_numpy(
        np.asarray(rows, np.int32)))
    return q, k, v, do, seg


@pytest.mark.parametrize("geom", [(2, 64, 8, 4, 32), (1, 96, 8, 1, 128)],
                         ids=["gqa_d32", "mqa_d128"])
def test_single_rounding_mirror_matches_jax_bf16_kernels(geom):
    """The mirror rounding once is the JAX kernels' arithmetic: on the
    same bf16 inputs and (o, lse) it agrees with JAX's flash backward in
    interpret mode to one bf16 ulp of the outputs (both round f32 sums of
    the same bf16 products, in another order; read: at most 1.1e-6)."""
    b, s, hq, hk, d = geom
    q, k, v, do, seg = _bf16_inputs(21, b, s, hq, hk, d, 3, 40)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jseg = jnp.asarray(seg.numpy())
    segs = dict(q_segment_ids=jseg, kv_segment_ids=jseg)
    blocks = dict(block_q=32, block_k=32)
    jo, jlse = jax_flash(j(q), j(k), j(v), return_lse=True, **segs, **blocks)
    jgrads = jax_flash_bwd(j(q), j(k), j(v), jo, jlse, j(do), **segs,
                           **blocks)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse))
    mirror = _bwd_rounded(q, k, v, o, lse, do, split=False,
                          q_segment_ids=seg, kv_segment_ids=seg)
    print("max |mirror - JAX| of dq, dk, dv:",   # readings, PERF.md
          [float(np.abs(a.float().numpy()
                        - np.asarray(b_.astype(jnp.float32))).max())
           for a, b_ in zip(mirror, jgrads)])
    for name, a, b_ in zip(("dq", "dk", "dv"), mirror, jgrads):
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b_.astype(jnp.float32)),
            atol=1e-5, rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("geom", [(1, 1024, 8, 2, 128, 256, 2048),
                                  (1, 2048, 4, 1, 128, 256, 2048),
                                  (2, 512, 8, 1, 32, 3, 30)],
                         ids=["s1024_gqa", "s2048_mqa", "s512_d32_short_docs"])
def test_bf16_rounding_of_p_and_ds_against_the_f32_backward(geom):
    """Decides how B2 and B3 feed P~ and dS to the tensor cores.  Against
    the f32 plain backward from the same (o, lse), at the card's
    unchanged one-ulp tolerance and packed documents: hi + lo stays
    within it; rounding once, as the JAX kernels do, does not (every
    document's first rows see few keys, so their P and dS are large and
    one bf16 rounding of them moves dq, dk, dv by more than one ulp).
    So all three second products take hi + lo on the card."""
    b, s, hq, hk, d, lo, hi = geom
    q, k, v, do, seg = _bf16_inputs(22, b, s, hq, hk, d, lo, hi)
    segs = dict(q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = attention_reference(q, k, v, return_lse=True, **segs)
    ref = attention_reference_bwd(q, k, v, o, lse, do, **segs)
    split = _bwd_rounded(q, k, v, o, lse, do, split=True, **segs)
    once = _bwd_rounded(q, k, v, o, lse, do, split=False, **segs)
    for name, a, r in zip(("dq", "dk", "dv"), split, ref):
        torch.testing.assert_close(a.float(), r.float(), **CARD_BF16_GRAD_TOL,
                                   msg=lambda m: f"hi + lo {name}: {m}")
    worst = {kind: [_worst_over_tol(a, r, CARD_BF16_GRAD_TOL)
                    for a, r in zip(grads, ref)]
             for kind, grads in (("hi + lo", split), ("once", once))}
    print(f"worst |err| / tol of dq, dk, dv: {worst}")   # readings, PERF.md
    assert max(worst["once"]) > 1.0


# ---------------------------------------------------------------------------
# the bf16 forward kernel's rounding of P, rehearsed on the CPU
# ---------------------------------------------------------------------------

# the card's tolerance for the bf16 forward kernel's o against the f32
# plain forward: one bf16 ulp (tests/test_torch_kernels_cuda.py TOL,
# chip_smoke.py tol)
CARD_BF16_FWD_TOL = dict(atol=1e-3, rtol=1e-2)


def _fwd_rounded(q, k, v, split, *, block_k=64, causal=True,
                 window=(-1, -1), q_segment_ids=None, kv_segment_ids=None,
                 dt=torch.bfloat16):
    """A mirror of the plain forward (``attention_reference``) walked
    online over blocks of ``block_k`` keys, as the kernels walk them,
    that rounds P (taken against the running row max) to bf16 before
    P V: once (``split=False``, the JAX kernel's ``p_v.astype(v.dtype)``)
    or as hi + lo, two bf16 values whose sum keeps ~16 bits
    (``split=True``).  The row sum l and so the LSE take the unrounded
    P.  Returns ``(o, lse)``."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    s, _ = _scores(q, k, d ** -0.5, 0.0)
    mask = _mask4(q, k, causal, window, q_segment_ids,
                  kv_segment_ids).expand(s.shape)
    s = torch.where(mask, s, NEG_INF)
    vr = _repeat_kv(v, hq).float()
    m = torch.full((b, hq, sq), NEG_INF)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))

    def r(x):
        hi = _bf16(x, dt)
        return hi + _bf16(x - hi, dt) if split else hi

    for k0 in range(0, sk, block_k):
        sb, mb = s[..., k0:k0 + block_k], mask[..., k0:k0 + block_k]
        m_new = torch.maximum(m, sb.max(dim=-1).values)
        p = torch.where(mb, torch.exp(sb - m_new[..., None]), 0.0)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", r(p), vr[:, k0:k0 + block_k])
        m = m_new
    safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / safe[..., None]).transpose(1, 2).to(q.dtype)
    return o, torch.where(l == 0.0, NEG_INF, m + torch.log(safe))


@pytest.mark.parametrize("geom", [(2, 64, 8, 4, 32), (1, 96, 8, 1, 128)],
                         ids=["gqa_d32", "mqa_d128"])
def test_fwd_single_rounding_mirror_matches_jax_bf16_kernel(geom):
    """The forward mirror rounding P once, walked in JAX's blocks of 32
    keys, is the JAX kernel's arithmetic: on the same bf16 inputs it
    agrees with JAX's Pallas forward in interpret mode to one bf16 ulp
    of o, and the LSE to f32 accuracy."""
    b, s, hq, hk, d = geom
    q, k, v, _, seg = _bf16_inputs(23, b, s, hq, hk, d, 3, 40)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jseg = jnp.asarray(seg.numpy())
    jo, jlse = jax_flash(j(q), j(k), j(v), return_lse=True,
                         q_segment_ids=jseg, kv_segment_ids=jseg,
                         block_q=32, block_k=32)
    o, lse = _fwd_rounded(q, k, v, split=False, block_k=32,
                          q_segment_ids=seg, kv_segment_ids=seg)
    jo = np.asarray(jo.astype(jnp.float32))
    print("max |mirror - JAX| of o, lse:",      # readings, PERF.md
          float(np.abs(o.float().numpy() - jo).max()),
          float(np.abs(lse.numpy() - np.asarray(jlse)).max()))
    np.testing.assert_allclose(o.float().numpy(), jo, atol=1e-5, rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("geom", [(1, 1024, 8, 2, 128, 256, 2048),
                                  (1, 2048, 4, 1, 128, 256, 2048),
                                  (2, 512, 8, 1, 32, 3, 30)],
                         ids=["s1024_gqa", "s2048_mqa", "s512_d32_short_docs"])
def test_bf16_rounding_of_p_against_the_f32_forward(geom):
    """Decides how the bf16 B1 feeds P to P V.  Against the f32 plain
    forward, at the card's unchanged one-ulp tolerance on o and packed
    documents walked in the kernel's 64-key tiles: hi + lo stays within
    it; rounding once, as the JAX kernel does, does not (a document's
    first rows see few keys, so their P is large and one bf16 rounding
    of it moves o by more than an ulp).  So P V takes hi + lo on the
    card, as B2 and B3 do."""
    b, s, hq, hk, d, lo, hi = geom
    q, k, v, _, seg = _bf16_inputs(24, b, s, hq, hk, d, lo, hi)
    segs = dict(q_segment_ids=seg, kv_segment_ids=seg)
    ref_o, ref_lse = attention_reference(q, k, v, return_lse=True, **segs)
    split = _fwd_rounded(q, k, v, split=True, **segs)
    once = _fwd_rounded(q, k, v, split=False, **segs)
    worst = {kind: _worst_over_tol(o, ref_o, CARD_BF16_FWD_TOL)
             for kind, (o, _) in (("hi + lo", split), ("once", once))}
    print(f"worst |err| / tol of o: {worst}")    # readings, PERF.md
    torch.testing.assert_close(split[0].float(), ref_o.float(),
                               **CARD_BF16_FWD_TOL)
    torch.testing.assert_close(split[1], ref_lse, atol=1e-5, rtol=1e-5)
    assert worst["once"] > 1.0


# the card's tolerance for the f16 kernels against the f32 plain versions:
# two f16 ulps (tests/test_torch_kernels_cuda.py TOL, chip_smoke.py)
CARD_F16_TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("geom", [(1, 1024, 8, 2, 128, 256, 2048),
                                  (2, 512, 8, 1, 32, 3, 30)],
                         ids=["s1024_gqa", "s512_d32_short_docs"])
def test_f16_rounding_of_p_and_ds_against_the_f32_paths(geom):
    """The f16 kernels feed P, P~ and dS as hi + lo, as in bf16: on f16
    inputs at the card's two-ulp f16 tolerance hi + lo stays within it
    on o, dq, dk and dv.  Rounding once, with f16's 3 more bits, is
    printed beside it (not what the kernels do)."""
    b, s, hq, hk, d, lo, hi = geom
    q, k, v, do, seg = _bf16_inputs(25, b, s, hq, hk, d, lo, hi,
                                    dt=torch.float16)
    segs = dict(q_segment_ids=seg, kv_segment_ids=seg)
    ref_o, ref_lse = attention_reference(q, k, v, return_lse=True, **segs)
    ref = attention_reference_bwd(q, k, v, ref_o, ref_lse, do, **segs)
    worst = {}
    for kind, split in (("hi + lo", True), ("once", False)):
        o, _ = _fwd_rounded(q, k, v, split, dt=torch.float16, **segs)
        grads = _bwd_rounded(q, k, v, ref_o, ref_lse, do, split,
                             dt=torch.float16, **segs)
        worst[kind] = [_worst_over_tol(a, r, CARD_F16_TOL)
                       for a, r in zip((o,) + grads, (ref_o,) + ref)]
    print(f"worst |err| / f16 tol of o, dq, dk, dv: {worst}")  # PERF.md
    assert max(worst["hi + lo"]) <= 1.0
