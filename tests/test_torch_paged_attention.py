"""The port's plain paged attention against the JAX package's two paths
(``_paged_attention_xla`` and the Pallas kernel in interpret mode), on
random shuffled block layouts made with numpy from a seed.

Tolerance: f32 inputs, atol = rtol = 1e-5 — both sides compute f32
scores and an exact softmax, so only summation order differs.  float16
inputs (a model trained under the fp16 loss scaler serves in float16):
atol 2e-4 + rtol 2e-3, two f16 ulps — both sides compute in f32 and
round the output to f16 once.

The CUDA kernel itself needs the card: tests/test_torch_kernels_cuda.py
and ``chip_smoke.py`` hold it against this plain version on the H100.
What of it runs in Python is tested here: the launch plan
(``_paged_plan``), and the split decode's decomposition (each part's
partial o, m, l merged by LSE), mirrored in plain torch and held
against the plain version and JAX's ``_paged_attention_xla``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_module_env import port_module_env
from torchacc_tpu.ops.paged_attention import paged_attention as jax_paged
import torchacc_tpu_torch.ops.paged_attention as pa_mod
from torchacc_tpu_torch.ops._common import NEG_INF
from torchacc_tpu_torch.ops.paged_attention import paged_attention


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _case(seed, *, slots, heads, kv_heads, d, bs, mb, t=1, ctx_lens=None):
    """numpy operands: a pool with random contents, per-slot block lists
    drawn from a shuffled permutation, random q."""
    rng = np.random.default_rng(seed)
    nb = slots * mb + 1
    ctx = ctx_lens if ctx_lens is not None else [
        int(rng.integers(1, mb * bs + 1)) for _ in range(slots)]
    perm = rng.permutation(np.arange(1, nb)).tolist()
    tables = np.zeros((slots, mb), np.int32)
    for s in range(slots):
        n_blk = -(-ctx[s] // bs)
        tables[s, :n_blk] = [perm.pop() for _ in range(n_blk)]
    k_pool = rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32)
    v_pool = rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32)
    q = rng.standard_normal((slots, t, heads, d)).astype(np.float32)
    q_start = np.asarray([max(c - t, 0) for c in ctx], np.int32)
    return (q, k_pool, v_pool, tables, np.asarray(ctx, np.int32), q_start)


CASES = {
    "mha_decode": dict(seed=0, slots=4, heads=4, kv_heads=4, d=16, bs=8,
                       mb=4),
    "mha_decode_b": dict(seed=1, slots=3, heads=4, kv_heads=4, d=16, bs=8,
                         mb=5),
    "gqa_decode": dict(seed=2, slots=4, heads=8, kv_heads=2, d=16, bs=8,
                       mb=3),
    "gqa_chunk_t4": dict(seed=3, slots=3, heads=8, kv_heads=2, d=16, bs=8,
                         mb=3, t=4, ctx_lens=[5, 17, 24]),
    "mha_chunk_t4": dict(seed=4, slots=2, heads=4, kv_heads=4, d=16, bs=4,
                         mb=6, t=4, ctx_lens=[4, 21]),
    "zero_ctx_slot": dict(seed=5, slots=3, heads=4, kv_heads=2, d=16, bs=8,
                          mb=2, t=1, ctx_lens=[9, 0, 12]),
}
OPTS = {
    "plain": dict(),
    "softcap": dict(logit_softcap=30.0),
    "window": dict(window=(5, -1)),
}


def _torch_out(args, **kw):
    t = [torch.from_numpy(a) for a in args]
    return paged_attention(*t, impl="torch", **kw).numpy()


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_xla(case, opt):
    args = _case(**CASES[case])
    kw = OPTS[opt]
    ref = np.asarray(jax_paged(*[jnp.asarray(a) for a in args], impl="xla",
                               **kw))
    out = _torch_out(args, **kw)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["gqa_chunk_t4", "mha_decode",
                                  "zero_ctx_slot"])
def test_plain_matches_jax_pallas_interpret(case):
    # small grids only: interpret mode walks the TPU grid step by step
    cfg = dict(CASES[case])
    args = _case(**cfg)
    ref = np.asarray(jax_paged(*[jnp.asarray(a) for a in args],
                               impl="pallas"))
    np.testing.assert_allclose(_torch_out(args), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_xla_in_float16(case):
    args = _case(**CASES[case])
    f16 = [a.astype(np.float16) if a.dtype == np.float32 else a
           for a in args]
    ref = np.asarray(jax_paged(*[jnp.asarray(a) for a in f16], impl="xla",
                               logit_softcap=30.0))
    t = [torch.from_numpy(a) for a in f16]
    out = paged_attention(*t, impl="torch", logit_softcap=30.0)
    assert out.dtype == torch.float16 and ref.dtype == np.float16
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                               atol=2e-4, rtol=2e-3)


def test_zero_context_slot_outputs_zeros():
    q, kp, vp, tables, ctx, q_start = _case(**CASES["zero_ctx_slot"])
    tables[1, :] = 0                         # parked on the null block
    out = _torch_out((q, kp, vp, tables, ctx, q_start))
    assert np.all(out[1] == 0.0)
    assert np.all(np.isfinite(out))


def test_auto_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _case(**CASES["gqa_decode"])]
    before = dict(pa_mod.launch_counts)
    out = paged_attention(*args)
    assert pa_mod.launch_counts == before    # no kernel launch on the CPU
    np.testing.assert_array_equal(
        out.numpy(), paged_attention(*args, impl="torch").numpy())


def test_cuda_impl_on_cpu_tensors_raises():
    args = [torch.from_numpy(a) for a in _case(**CASES["mha_decode"])]
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention(*args, impl="cuda")


def test_validation_errors():
    q = torch.zeros((2, 1, 4, 8))
    kp = torch.zeros((4, 8, 2, 8))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):          # 3 q heads, 2 kv heads
        paged_attention(torch.zeros((2, 1, 3, 8)), kp, kp, tables, lens,
                        lens)
    with pytest.raises(ValueError):          # k/v pool mismatch
        paged_attention(q, kp, torch.zeros((4, 8, 4, 8)), tables, lens, lens)
    with pytest.raises(ValueError):          # slot-count mismatch
        paged_attention(q, kp, kp, tables[:1], lens, lens)
    with pytest.raises(ValueError):          # q not 4-D
        paged_attention(q[0], kp, kp, tables, lens, lens)
    with pytest.raises(ValueError):
        paged_attention(q, kp, kp, tables, lens, lens, impl="pallas")



# ---------------------------------------------------------------------------
# the launch plan of the CUDA kernels (_paged_plan) and the split decode's
# decomposition, mirrored in plain torch
# ---------------------------------------------------------------------------

# (slots, heads, kv_heads, d, bs, max_blocks, sms): llama3-8b serving
# (table width 513 blocks of 16), the smoke decode case, a long table, a
# tiny MHA geometry, a wide block, and a card of another size
PLAN_GEOMS = {
    "serving": (8, 32, 8, 128, 16, 513, 132),
    "smoke_decode": (8, 32, 8, 128, 16, 127, 132),
    "long_table": (2, 32, 8, 128, 16, 8192, 132),
    "mha_d32": (3, 4, 4, 32, 8, 20, 132),
    "bs64_group16": (4, 64, 4, 128, 64, 300, 132),
    "small_card": (1, 8, 2, 128, 16, 64, 16),
    # the Gemma family's heads of 256: gemma-2b's MQA group of 8 and
    # gemma2-2b's 8 q heads over 4 kv heads
    "gemma_mqa_d256": (8, 8, 1, 256, 16, 513, 132),
    "gemma2_gqa_d256": (4, 8, 4, 256, 16, 300, 132),
}


STAGE_KEYS = 64      # keys a stage of the tensor-core bodies (kKeys)


def _parts(span, splits, stage=STAGE_KEYS,
           min_keys=pa_mod._MIN_SPLIT_KEYS):
    """The kernel's cut of a tile's ``span`` visible keys into at most
    ``splits`` parts (paged_mma_kernel): (keys a part, parts used)."""
    per = -(-span // splits)
    chunk = max(min_keys, -(-per // stage) * stage)
    return chunk, -(-span // chunk)


@pytest.mark.parametrize("geom", sorted(PLAN_GEOMS))
def test_decode_plan_grid_from_shapes(geom):
    s, h, kh, d, bs, mb, sms = PLAN_GEOMS[geom]
    plan = pa_mod._paged_plan((s, 1, h, d), (s * mb + 1, bs, kh, d), mb,
                              torch.bfloat16, sms)
    assert plan.body == "decode_split"
    assert plan.grid == (plan.splits, kh, s)
    assert plan.rows == pa_mod._DECODE_ROWS >= h // kh
    # about _CTAS_PER_SM CTAs an SM (one at head dim 256), unless a full
    # table could not fill that many parts
    full = min(pa_mod._MAX_SPLITS, -(-mb * bs // pa_mod._MIN_SPLIT_KEYS))
    per_sm = 1 if d == 256 else pa_mod._CTAS_PER_SM
    assert pa_mod._ctas_per_sm(True, d) == per_sm
    assert plan.splits == min(full, -(-per_sm * sms // (s * kh)))
    assert plan.splits >= 1


@pytest.mark.parametrize("geom", sorted(PLAN_GEOMS))
def test_float16_plan_is_the_bfloat16_plan(geom):
    """The tensor-core bodies are one template on the 16-bit type: a
    float16 call is laid out as a bfloat16 one (decode and prefill) and
    launches the f16 instantiation of the same body."""
    s, h, kh, d, bs, mb, sms = PLAN_GEOMS[geom]
    for t in (1, 37, 256):
        args = ((s, t, h, d), (s * mb + 1, bs, kh, d), mb)
        p16 = pa_mod._paged_plan(*args, torch.float16, sms)
        assert p16 == pa_mod._paged_plan(*args, torch.bfloat16, sms)
        assert p16.body == ("decode_split" if t == 1 else "prefill_mma")
        assert pa_mod._BODY_CODE[p16.body, torch.float16] == \
            pa_mod._BODY_CODE[p16.body, torch.bfloat16] + 2
    assert torch.float16 in pa_mod._KERNEL_DTYPES


@pytest.mark.parametrize("splits", [1, 2, 3, 9, 32])
def test_parts_cover_every_key_once(splits):
    """Every span a tile can have, cut as the kernel cuts it: parts of
    whole stages (so of whole blocks for BS dividing 64), at least the
    minimum, no more than the grid has, tiling the span exactly once."""
    for span in list(range(1, 700)) + [2031, 2032, 8191, 8192, 8208]:
        chunk, active = _parts(span, splits)
        assert chunk % STAGE_KEYS == 0 and chunk >= pa_mod._MIN_SPLIT_KEYS
        assert 1 <= active <= splits
        covered = [k for p in range(splits)
                   for k in range(p * chunk, min(span, (p + 1) * chunk))]
        assert covered == list(range(span))


@pytest.mark.parametrize("geom", sorted(PLAN_GEOMS))
def test_plan_depends_on_table_width_not_contexts(geom):
    """The grid comes from shapes alone: the plan takes no context
    lengths, the same shapes give the same plan, and a wider table
    never gives fewer parts."""
    s, h, kh, d, bs, mb, sms = PLAN_GEOMS[geom]
    args = ((s, 1, h, d), (s * mb + 1, bs, kh, d))
    p1 = pa_mod._paged_plan(*args, mb, torch.bfloat16, sms)
    pa_mod._paged_plan.cache_clear()
    assert pa_mod._paged_plan(*args, mb, torch.bfloat16, sms) == p1
    wider = pa_mod._paged_plan(*args, 2 * mb, torch.bfloat16, sms)
    assert wider.splits >= p1.splits


@pytest.mark.parametrize("t,dtype,body,rows,splits", [
    (256, torch.bfloat16, "prefill_mma", 64, 1),    # 16 x 8 x 3 = 384 CTAs
    (64, torch.bfloat16, "prefill_mma", 64, 2),     # 96 CTAs: 264 // 96
    # 72 and 24 CTAs: 3 and 11 parts, capped at the 3 a 320-key table fills
    (37, torch.bfloat16, "prefill_mma", 64, 3),
    (9, torch.bfloat16, "prefill_mma", 64, 3),
    (256, torch.float32, "f32", 32, 1),
    (1, torch.float32, "f32", 32, 1),
])
def test_plan_prefill_and_f32_row_tiles(t, dtype, body, rows, splits):
    plan = pa_mod._paged_plan((3, t, 32, 128), (100, 16, 8, 128), 20, dtype,
                              132)
    assert (plan.body, plan.rows, plan.splits) == (body, rows, splits)
    tiles = -(-4 * t // rows)                        # group 4 x T rows
    assert plan.grid == (tiles * splits, 8, 3)
    # prefill parts only fill the two CTAs an SM the tiles leave idle
    assert tiles * splits * 8 * 3 <= max(2 * 132, tiles * 8 * 3)


@pytest.mark.parametrize("t,splits", [
    (256, 1),    # 32 tiles x 3 slots = 96 CTAs: 132 // 96 = 1 part
    (64, 5),     # 8 x 3 = 24 CTAs: 132 // 24 = 5 parts (11 at d 128)
    (16, 22)])   # 2 x 3 = 6 CTAs: 22 parts (44, capped at 25, at d 128)
def test_plan_prefill_at_head_dim_256_fills_one_cta_an_sm(t, splits):
    """At 256 the prefill body's 165 KB of shared memory leaves one CTA
    an SM: the parts fill that one, where at 128 they fill two (group
    8 over one kv head, a 3200-key table: at most 25 parts)."""
    plan = pa_mod._paged_plan((3, t, 8, 256), (700, 16, 1, 256), 200,
                              torch.bfloat16, 132)
    tiles = -(-8 * t // 64)                          # group 8 x T rows
    assert (plan.body, plan.rows, plan.splits) == ("prefill_mma", 64, splits)
    assert plan.grid == (tiles * splits, 1, 3)
    d128 = pa_mod._paged_plan((3, t, 8, 128), (700, 16, 1, 128), 200,
                              torch.bfloat16, 132)
    assert d128.splits == min(25, max(1, 264 // (3 * tiles)))


def test_plan_refuses_what_the_decode_kernel_does_not_take():
    with pytest.raises(ValueError, match="q heads per kv head"):
        pa_mod._paged_plan((2, 1, 64, 128), (10, 16, 2, 128), 4,
                           torch.bfloat16, 132)     # group 32
    with pytest.raises(ValueError, match="slots"):
        pa_mod._paged_plan((70000, 1, 8, 128), (10, 16, 8, 128), 4,
                           torch.bfloat16, 132)


def _split_decode_mirror(q, k_pool, v_pool, tables, ctx, q_start, *, scale,
                         splits, stage=STAGE_KEYS,
                         min_keys=pa_mod._MIN_SPLIT_KEYS, window=(-1, -1),
                         logit_softcap=0.0):
    """The split decode (T = 1) as the kernel decomposes it: each slot's
    visible keys cut into ``splits`` parts (``_parts``), the partial (o,
    m, l) of every part, then the LSE merge over all parts in part
    order.  Parts past the used ones carry (0, NEG_INF, 0) and merge to
    nothing; a slot that sees no key gives zeros."""
    s_, _, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    g = h // kh
    left = window[0]
    out = torch.zeros_like(q)
    for s in range(s_):
        c = min(int(ctx[s]), tables.shape[1] * bs)
        q0 = int(q_start[s])
        end = min(c, q0 + 1)
        begin = max(0, q0 - left) if left >= 0 else 0
        if end <= begin:
            continue
        chunk, _ = _parts(end - begin, splits, stage, min_keys)
        qs = q[s, 0].reshape(kh, g, d)
        parts = []
        for i in range(splits):
            lo, hi = begin + i * chunk, min(end, begin + (i + 1) * chunk)
            if hi <= lo:
                parts.append((torch.zeros(kh, g, d),
                              torch.full((kh, g), NEG_INF), torch.zeros(kh, g)))
                continue
            pos = torch.arange(lo, hi)
            blk = tables[s, pos // bs].long()
            k = k_pool[blk, pos % bs]                    # [n, kh, d]
            v = v_pool[blk, pos % bs]
            sc = torch.einsum("kgd,nkd->kgn", qs, k) * scale
            if logit_softcap > 0.0:
                sc = logit_softcap * torch.tanh(sc / logit_softcap)
            m = sc.max(dim=-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((torch.einsum("kgn,nkd->kgd", p, v), m, p.sum(-1)))
        mx = torch.stack([m for _, m, _ in parts]).max(dim=0).values
        num = torch.zeros(kh, g, d)
        den = torch.zeros(kh, g)
        for o, m, l in parts:
            w = torch.exp(m - mx)
            num = num + w[..., None] * o
            den = den + w * l
        out[s, 0] = (num / den[..., None]).reshape(h, d)
    return out


SPLIT_CASES = {
    "gqa_long": dict(seed=10, slots=4, heads=8, kv_heads=2, d=16, bs=8,
                     mb=12, ctx_lens=[96, 24, 25, 1]),
    "zero_and_long": dict(seed=11, slots=3, heads=4, kv_heads=2, d=16, bs=4,
                          mb=20, ctx_lens=[0, 80, 33]),
    "mha": dict(seed=12, slots=2, heads=4, kv_heads=4, d=16, bs=8, mb=6,
                ctx_lens=[48, 7]),
}


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("stage,min_keys,splits", [
    (4, 8, 2), (4, 8, 5), (8, 8, 40), (64, 128, 4)])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_decode_mirror_matches_plain_and_jax(case, stage, min_keys,
                                                   splits, opt):
    """The decomposition at small stages (many parts, empty ones among
    them, a window's left edge inside a part) and at the kernel's own
    stage and minimum (one part for these contexts), in f32."""
    cfg = SPLIT_CASES[case]
    args = _case(**cfg)
    kw = OPTS[opt]
    t = [torch.from_numpy(a) for a in args]
    got = _split_decode_mirror(*t, scale=cfg["d"] ** -0.5, splits=splits,
                               stage=stage, min_keys=min_keys, **kw)
    plain = paged_attention(*t, impl="torch", **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    ref = np.asarray(jax_paged(*[jnp.asarray(a) for a in args], impl="xla",
                               **kw))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    for s, c in enumerate(cfg["ctx_lens"]):
        if c == 0:
            assert np.all(got[s].numpy() == 0.0)


def test_split_decode_mirror_at_the_kernel_plan():
    """The mirror at the kernel's stage, minimum and the plan's parts
    for a long-context geometry: several parts are used."""
    cfg = dict(seed=13, slots=2, heads=8, kv_heads=2, d=16, bs=16, mb=64,
               ctx_lens=[1000, 257])
    args = _case(**cfg)
    plan = pa_mod._paged_plan((2, 1, 8, 16), (129, 16, 2, 16), 64,
                              torch.bfloat16, 132)
    assert _parts(1000, plan.splits)[1] > 1
    t = [torch.from_numpy(a) for a in args]
    for window in ((-1, -1), (300, -1)):
        got = _split_decode_mirror(*t, scale=0.25, splits=plan.splits,
                                   window=window)
        np.testing.assert_allclose(
            got.numpy(),
            paged_attention(*t, impl="torch", window=window).numpy(),
            atol=1e-5, rtol=1e-5)
