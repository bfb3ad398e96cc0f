"""The port's plain paged attention against the JAX package's two paths
(``_paged_attention_xla`` and the Pallas kernel in interpret mode), on
random shuffled block layouts made with numpy from a seed.

Tolerance: f32 inputs, atol = rtol = 1e-5 — both sides compute f32
scores and an exact softmax, so only summation order differs.

The CUDA kernel itself needs the card: tests/test_torch_kernels_cuda.py
and ``chip_smoke.py`` hold it against this plain version on the H100.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchacc_tpu.ops.paged_attention import paged_attention as jax_paged
import torchacc_tpu_torch.ops.paged_attention as pa_mod
from torchacc_tpu_torch.ops.paged_attention import paged_attention


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


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

