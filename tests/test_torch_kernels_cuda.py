"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  jax-free, so that it runs on a machine with a
GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Every
test skips where ``torch.cuda.is_available()`` is false; the decision
is made inside the test, never at import.

Tolerances: f32 inputs, atol = rtol = 1e-5 (same f32 arithmetic in
another order); bf16 inputs, atol 1e-3 + rtol 1e-2 (both versions
accumulate in f32 and round the output to bf16, so they differ by at
most one bf16 ulp, 2^-7 of the value).
"""

import numpy as np
import pytest
import torch

import torchacc_tpu_torch.ops.paged_attention as pa
from torchacc_tpu_torch.ops._build import build_all

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    build_all()
    return torch.device("cuda")


def _case(seed, device, dtype, *, slots, heads, kv_heads, d, bs, t,
          ctx_lens):
    rng = np.random.default_rng(seed)
    mb = max(1, -(-max(ctx_lens) // bs)) + 1      # one spare table column
    nb = slots * mb + 1
    perm = rng.permutation(np.arange(1, nb)).tolist()
    tables = np.zeros((slots, mb), np.int32)
    for s, c in enumerate(ctx_lens):
        n = -(-c // bs)
        tables[s, :n] = [perm.pop() for _ in range(n)]
    kp = rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32)
    q = rng.standard_normal((slots, t, heads, d)).astype(np.float32)
    q_start = np.asarray([max(c - t, 0) for c in ctx_lens], np.int32)
    f = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return f(q), f(kp), f(vp), i(tables), i(ctx_lens), i(q_start)


GEOMS = {
    "decode_gqa_d128": dict(slots=5, heads=32, kv_heads=8, d=128, bs=16,
                            t=1, ctx_lens=[0, 1, 16, 17, 300]),
    "chunk_gqa_d128": dict(slots=2, heads=32, kv_heads=8, d=128, bs=16,
                           t=37, ctx_lens=[37, 200]),
    "decode_mha_d32_bs8": dict(slots=3, heads=4, kv_heads=4, d=32, bs=8,
                               t=1, ctx_lens=[5, 130, 64]),
    "chunk_mqa_d128_bs32": dict(slots=2, heads=4, kv_heads=1, d=128, bs=32,
                                t=9, ctx_lens=[9, 100]),
}
OPTS = {"plain": {}, "softcap": dict(logit_softcap=30.0),
        "window": dict(window=(20, -1))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_paged_attention_kernel_matches_plain(card, geom, opt, dtype):
    args = _case(0, card, dtype, **GEOMS[geom])
    shape = "decode" if GEOMS[geom]["t"] == 1 else "prefill"
    before = dict(pa.launch_counts)
    out = pa.paged_attention(*args, impl="cuda", **OPTS[opt])
    ref = pa.paged_attention(*args, impl="torch", **OPTS[opt])
    torch.cuda.synchronize()
    before[shape] += 1
    assert pa.launch_counts == before
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    ctx = args[4].cpu().tolist()
    for s, c in enumerate(ctx):
        if c == 0:
            assert (out[s] == 0).all()


def test_auto_launches_kernel_for_cuda_tensors(card):
    args = _case(1, card, torch.bfloat16, **GEOMS["decode_gqa_d128"])
    before = pa.launch_counts["decode"]
    pa.paged_attention(*args)
    assert pa.launch_counts["decode"] == before + 1


def test_kernel_rejects_what_it_does_not_take(card):
    q, kp, vp, tables, ctx, q0 = _case(2, card, torch.bfloat16,
                                       **GEOMS["decode_gqa_d128"])
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, kp.float(), vp.float(), tables, ctx, q0,
                           impl="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :48].contiguous(),
                           kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), tables, ctx, q0,
                           impl="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), kp.half(), vp.half(), tables, ctx, q0,
                           impl="cuda")
    with pytest.raises(ValueError, match="q_start"):
        pa.paged_attention(q, kp, vp, tables, ctx, q0[:1], impl="cuda")


def test_engine_paths_on_card_match_plain_attention(card):
    """ServeEngine on the card through every scheduler path — chunked
    and batched prefill, prefix hits with copy-on-write, sampled and
    greedy slots, the lagged ring — gives the same tokens with the
    kernel as with the plain attention (f32, so the two differ by
    summation order only), and launches the kernel once per layer per
    dispatch."""
    from torchacc_tpu_torch import (Config, Request, ServeConfig,
                                    ServeEngine, get_preset, init_params)
    cfg = get_preset("llama-tiny", dtype=torch.float32, num_layers=2,
                     vocab_size=512, max_seq_len=256)   # head_dim 32
    model = init_params(cfg, seed=0, device=card)
    rng = np.random.default_rng(0)
    sys_p = rng.integers(0, 512, size=32).tolist()
    prompts = [sys_p + rng.integers(0, 512, size=n).tolist()
               for n in (5, 40, 0, 17)] + [rng.integers(0, 512,
                                                        size=70).tolist()]
    reqs = [Request(prompt_ids=p, max_new_tokens=12,
                    temperature=0.7 if i % 2 else 0.0, top_k=40, top_p=0.9,
                    seed=i) for i, p in enumerate(prompts)]
    serve = ServeConfig(block_size=16, num_blocks=64, max_slots=3,
                        prefill_chunk=16, prefill_batch=2, decode_depth=2,
                        prefix_cache=True)
    streams = {}
    for impl in ("cuda", "torch"):
        eng = ServeEngine(model, Config(serve=serve), attention_impl=impl)
        eng.generate(reqs[:1])                   # warm the prefix cache
        before = dict(pa.launch_counts)
        d0 = eng.scheduler.decode_dispatches
        p0 = eng.scheduler.prefill_dispatches
        res = eng.generate(reqs)
        launched = {k: pa.launch_counts[k] - before[k] for k in before}
        # a COW re-run or a chunk's one-token tail is a prefill dispatch
        # that launches the kernel at the decode shape (T == 1)
        n = cfg.num_layers if impl == "cuda" else 0
        decodes = eng.scheduler.decode_dispatches - d0
        prefills = eng.scheduler.prefill_dispatches - p0
        assert sum(launched.values()) == n * (decodes + prefills)
        assert launched["decode"] >= n * decodes
        assert eng.stats()["cow_copies"] >= 1
        streams[impl] = [r.tokens for r in res]
        eng.close()
    assert streams["cuda"] == streams["torch"]
    assert all(len(t) == 12 for t in streams["cuda"])
