"""The port's hand-written CUDA kernels (paged attention B4, flash
attention B1-B3) against their plain PyTorch versions, on the card.  jax-free, so that it runs on a machine with a
GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Every
test skips where ``torch.cuda.is_available()`` is false; the decision
is made inside the test, never at import.

Tolerances: f32 inputs, atol = rtol = 1e-5 (same f32 arithmetic in
another order); bf16 inputs, atol 1e-3 + rtol 1e-2 (both versions
accumulate in f32 and round the output to bf16, so they differ by at
most one bf16 ulp, 2^-7 of the value).  The flash backward kernels
against the plain backward from the same (o, lse): bf16 one ulp as
above, f32 atol = rtol = 1e-4 (dk and dv sum group x sk products of f32
terms in another order than the plain einsums).  Gradients through each
path's own forward: see ``_autograd_tol``.
"""

import numpy as np
import pytest
import torch

import torchacc_tpu_torch.ops.flash_attention as fa
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


# ---------------------------------------------------------------------------
# flash attention (B1 forward, B2 dq, B3 dk/dv)
# ---------------------------------------------------------------------------

GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}


def _autograd_tol(dtype, ref):
    """Gradients through each path's own forward: a one-ulp difference
    in a bf16 o moves delta = rowsum(dO * O) and so every dS of its row,
    so bf16 adds 1% of the largest reference entry to one ulp."""
    if dtype == torch.float32:
        return GRAD_TOL[dtype]
    return dict(atol=1e-2 * ref.abs().max().item(), rtol=1e-2)


FLASH_GEOMS = {   # b, sq, sk, hq, hk, d
    "gqa_d128": (2, 200, 200, 8, 2, 128),
    "mha_d32": (1, 130, 130, 4, 4, 32),
    "mqa_d32_sk_gt_sq": (2, 70, 150, 4, 1, 32),
    "sq_gt_sk_d128": (1, 100, 40, 4, 2, 128),      # leading rows see no key
}
FLASH_OPTS = {
    "causal": {},
    "full": dict(causal=False),
    "window": dict(window=(30, -1)),
    "softcap": dict(logit_softcap=20.0),
    "segments": dict(segments=True),
    "segments_window_softcap": dict(segments=True, window=(17, 5),
                                    logit_softcap=10.0),
}


def _flash_case(seed, device, dtype, b, sq, sk, hq, hk, d, segments=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
    q, k, v, do = f(b, sq, hq, d), f(b, sk, hk, d), f(b, sk, hk, d), \
        f(b, sq, hq, d)
    segs = {}
    if segments:
        def seg(n):      # packed documents of random lengths, -1 = padding
            ids, doc = [], 0
            while len(ids) < n:
                ids += [doc] * int(rng.integers(1, 60))
                doc += 1
            out = np.asarray(ids[:n], np.int32)
            out[n - n // 10:] = -1
            return out
        qs = np.stack([seg(sq) for _ in range(b)])
        ks = qs[:, :sk] if sk <= sq else np.concatenate(
            [np.full((b, sk - sq), 0, np.int32), qs], axis=1)
        to = lambda a: torch.from_numpy(a).to(device)
        segs = dict(q_segment_ids=to(qs), kv_segment_ids=to(ks))
    return q, k, v, do, segs


def _flash_run(q, k, v, do, segs, impl, **kw):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl=impl,
                                **segs, **kw)
    out = fa.flash_attention(q, k, v, impl=impl, **segs, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    return out, o, lse, dq, dk, dv


def _close(a, b, tol, name):
    assert torch.isfinite(a).all(), name
    torch.testing.assert_close(a.float(), b.float(), **tol,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("opt", sorted(FLASH_OPTS))
@pytest.mark.parametrize("geom", sorted(FLASH_GEOMS))
def test_flash_kernels_match_plain(card, geom, opt, dtype):
    kw = dict(FLASH_OPTS[opt])
    q, k, v, do, segs = _flash_case(0, card, dtype, *FLASH_GEOMS[geom],
                                    segments=kw.pop("segments", False))
    before = dict(fa.launch_counts)
    got = _flash_run(q, k, v, do, segs, "cuda", **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts == {"fwd": before["fwd"] + 2,
                                "bwd_dq": before["bwd_dq"] + 1,
                                "bwd_dkv": before["bwd_dkv"] + 1}
    ref = _flash_run(q, k, v, do, segs, "torch", **kw)
    assert fa.launch_counts["fwd"] == before["fwd"] + 2
    out, o, lse = got[:3]
    _close(out, ref[0], TOL[dtype], "out")
    _close(o, ref[1], TOL[dtype], "o")
    _close(lse, ref[2], TOL[torch.float32], "lse")
    for name, a, b in zip(("dq", "dk", "dv"), got[3:], ref[3:]):
        _close(a, b, _autograd_tol(dtype, b), f"autograd {name}")
    # the backward kernels against the plain backward from the same
    # (o, lse): one ulp in bf16
    bwd = [fa.flash_attention_bwd(q, k, v, o, lse, do, impl=impl, **segs,
                                  **kw) for impl in ("cuda", "torch")]
    for name, a, b in zip(("dq", "dk", "dv"), *bwd):
        _close(a, b, GRAD_TOL[dtype], name)
    # rows that see no key: o = 0, lse = NEG_INF, zero dq
    empty = lse <= -1e29                           # [b, h, sq]
    if empty.any():
        rows = empty.transpose(1, 2)               # [b, sq, h]
        assert (o[rows] == 0).all() and (got[3][rows] == 0).all()


def test_flash_gradient_matches_autograd_of_plain_ops(card):
    """The full gradient through the kernels against autograd through
    the plain attention's own ops (not the plain backward formula)."""
    from torchacc_tpu_torch.ops.attention import attention_reference
    q, k, v, do, segs = _flash_case(3, card, torch.float32,
                                    *FLASH_GEOMS["gqa_d128"], segments=True)
    got = _flash_run(q, k, v, do, segs, "cuda", logit_softcap=15.0)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = attention_reference(q, k, v, logit_softcap=15.0, **segs)
    ref = torch.autograd.grad(out, (q, k, v), do)
    for a, b in zip(got[3:], ref):
        torch.testing.assert_close(a, b, **GRAD_TOL[torch.float32])


def test_flash_auto_launches_and_rejects(card):
    q, k, v, do, _ = _flash_case(4, card, torch.bfloat16,
                                 *FLASH_GEOMS["gqa_d128"])
    before = fa.launch_counts["fwd"]
    fa.flash_attention(q, k, v)
    assert fa.launch_counts["fwd"] == before + 1
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.float(), v.float(), impl="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48],
                           impl="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), impl="cuda")
    for kw in (dict(alibi_slopes=torch.ones(8, device=card)),
               dict(dropout_p=0.1), dict(q_offset=3)):
        with pytest.raises(NotImplementedError):
            fa.flash_attention(q, k, v, **kw)
