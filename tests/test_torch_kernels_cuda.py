"""The port's hand-written CUDA kernels (paged attention B4, flash
attention B1-B3, quantized matmul B5) against their plain PyTorch
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
most one bf16 ulp, 2^-7 of the value).  The flash backward kernels
against the plain backward from the same (o, lse): bf16 one ulp as
above, f32 atol = rtol = 1e-4 (dk and dv sum group x sk products of f32
terms in another order than the plain einsums).  Gradients through each
path's own forward: see ``_autograd_tol``.  The quantized matmul: int8
bitwise (both sides sum exact integers and share every rounding); fp8
see ``FP8_ATOL``.  The flash kernels in f16: atol 2e-4 + rtol 2e-3, two
f16 ulps (2^-10 of the value each); the same inputs through the bf16
kernels read above it (chip_smoke.py's control).  B4 and B5 in f16
(B-3: an fp16-trained model quantized and served in its compute dtype)
likewise, B5's fp8 in f16 at atol 1e-3 + rtol 2e-3; B5 at the head's
vocab widths (128256, over 2 'tp' ranks, and the ragged 50257 and
51200) in bf16 and f16.

B1-B4 at the Gemma family's head dim 256 (B-2) as at the others: B1-B3
in f32, bf16 and f16 (with a window, the softcap and segment ids), B4
decode with a group of 8 and prefill, in f32 and bf16.  B1-B3 at Phi-2's
head dim 80 and Phi-3's 96 (stored as 128 in the wgmma kernels), every
option of ``FLASH_OPTS`` (ALiBi and dropout among them), at the tile
edges and at the context-parallel offsets.

B1-B3 at the context-parallel global offsets (B-1) against the plain
versions at the same offsets, at heads of 64, 128 and 256, in f32 and bf16,
with a control at zero offsets that must part; the ring and Ulysses
schedules over virtual ranks on the kernels against one whole call.

Also on the card: the ``AsyncLoader`` yields CUDA tensors equal to the
host batches, 'offload_dots' moves the bytes it counts, the
training step on a world-1 NCCL mesh (FSDP2, DTensor masters) equals
the one-device step bitwise, and checkpoints: a state saved and
restored keeps its device and its bits (an asynchronous save holds the
values of its step while the next step updates in place), and a step
after a restore through B1-B3 (with the bf16 shadow, on a world-1 NCCL
mesh, and with int8 histories through B5) equals the uninterrupted one
bitwise.  The pipeline's schedule over virtual stages on the kernels
against the unpipelined step (1F1B bitwise, GPipe within its f32
summation order).
"""

import numpy as np
import pytest
import torch

import torchacc_tpu_torch.ops.flash_attention as fa
import torchacc_tpu_torch.ops.paged_attention as pa
import torchacc_tpu_torch.ops.quantized_matmul as qm
from torchacc_tpu_torch.ops._build import build_all

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
       torch.float16: dict(atol=2e-4, rtol=2e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    build_all()
    return torch.device("cuda")


def _case(seed, device, dtype, *, slots, heads, kv_heads, d, bs, t,
          ctx_lens, q_starts=None):
    """Random pools and shuffled block tables; each slot's first query
    row sits at ctx - t (a chunk that ends the context) unless
    ``q_starts`` says otherwise (a batched prefill whose short chunks
    leave pad rows past their context)."""
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
    q_start = np.asarray(q_starts if q_starts is not None
                         else [max(c - t, 0) for c in ctx_lens], np.int32)
    f = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return f(q), f(kp), f(vp), i(tables), i(ctx_lens), i(q_start)


def _decode_splits(device, slots, heads, kv_heads, d, bs, max_ctx):
    """The parts the decode plan cuts each slot's keys into for this
    geometry on this card (the table width is _case's: max_ctx rounded
    up to blocks, plus one)."""
    mb = -(-max_ctx // bs) + 1
    plan = pa._paged_plan((slots, 1, heads, d), (slots * mb + 1, bs,
                                                 kv_heads, d), mb,
                          torch.bfloat16,
                          torch.cuda.get_device_properties(device)
                          .multi_processor_count)
    return plan.splits


def _around_split(parts):
    """Contexts on and one either side of where the kernel's cut of a
    slot's keys changes: the 128-key minimum part, and parts of exactly
    two 64-key stages each; a slot that sees nothing; the longest
    context the geometry takes."""
    return [127, 128, 129, 0, 128 * parts - 1, 128 * parts,
            128 * parts + 1, 8192]


GEOMS = {
    "decode_gqa_d128": dict(slots=5, heads=32, kv_heads=8, d=128, bs=16,
                            t=1, ctx_lens=[0, 1, 16, 17, 300]),
    "chunk_gqa_d128": dict(slots=2, heads=32, kv_heads=8, d=128, bs=16,
                           t=37, ctx_lens=[37, 200]),
    "decode_mha_d32_bs8": dict(slots=3, heads=4, kv_heads=4, d=32, bs=8,
                               t=1, ctx_lens=[5, 130, 64]),
    "chunk_mqa_d128_bs32": dict(slots=2, heads=4, kv_heads=1, d=128, bs=32,
                                t=9, ctx_lens=[9, 100]),
    # long decode, contexts around the kernel's part boundaries
    # (ctx_lens from _around_split at the card's parts)
    "decode_long_d128": dict(slots=8, heads=32, kv_heads=8, d=128, bs=16,
                             t=1, ctx_lens=_around_split),
    "decode_zero_beside_long": dict(slots=4, heads=32, kv_heads=8, d=128,
                                    bs=16, t=1, ctx_lens=[0, 5000, 0, 3001]),
    "decode_long_d32": dict(slots=3, heads=8, kv_heads=2, d=32, bs=16, t=1,
                            ctx_lens=[4097, 0, 1234]),
    # batched prefill: chunks of 256, 100 and 1 tokens padded to 256 rows
    "prefill_batched_pad": dict(slots=3, heads=32, kv_heads=8, d=128, bs=16,
                                t=256, ctx_lens=[256, 800, 1501],
                                q_starts=[0, 700, 1500]),
    "chunk_gqa_d32": dict(slots=2, heads=8, kv_heads=2, d=32, bs=16, t=70,
                          ctx_lens=[70, 300]),
    # Llama-3.2-1B's attention: 32 q heads over 8 kv heads of 64
    "decode_gqa_d64": dict(slots=5, heads=32, kv_heads=8, d=64, bs=16,
                           t=1, ctx_lens=[0, 1, 16, 17, 300]),
    "chunk_gqa_d64": dict(slots=2, heads=32, kv_heads=8, d=64, bs=16, t=70,
                          ctx_lens=[70, 300]),
    "decode_long_d64": dict(slots=8, heads=32, kv_heads=8, d=64, bs=16,
                            t=1, ctx_lens=_around_split),
    # the Gemma family's heads of 256: gemma-2b's MQA (group 8) and
    # gemma2-2b's 8 q heads over 4 kv heads
    "decode_mqa_g8_d256": dict(slots=5, heads=8, kv_heads=1, d=256, bs=16,
                               t=1, ctx_lens=[0, 1, 16, 17, 300]),
    "chunk_mqa_g8_d256": dict(slots=2, heads=8, kv_heads=1, d=256, bs=16,
                              t=70, ctx_lens=[70, 300]),
    "decode_long_d256": dict(slots=8, heads=8, kv_heads=1, d=256, bs=16,
                             t=1, ctx_lens=_around_split),
    "chunk_gqa_d256": dict(slots=2, heads=8, kv_heads=4, d=256, bs=16,
                           t=37, ctx_lens=[37, 200]),
}
OPTS = {"plain": {}, "softcap": dict(logit_softcap=30.0),
        "window": dict(window=(20, -1)),
        # a left edge that cuts the long decodes' splits
        "wide_window": dict(window=(1000, -1))}


def _geom(name, device):
    g = dict(GEOMS[name])
    if callable(g["ctx_lens"]):
        g["ctx_lens"] = g["ctx_lens"](_decode_splits(
            device, g["slots"], g["heads"], g["kv_heads"], g["d"], g["bs"],
            8192))
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_paged_attention_kernel_matches_plain(card, geom, opt, dtype):
    args = _case(0, card, dtype, **_geom(geom, card))
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


def test_split_decode_is_bitwise_repeatable(card):
    """The merge walks the splits in a fixed order, whichever CTA of a
    (slot, kv head) finishes last: two calls give the same bits."""
    args = _case(5, card, torch.bfloat16, **_geom("decode_long_d128", card))
    for opt in ({}, dict(window=(1000, -1))):
        first = pa.paged_attention(*args, impl="cuda", **opt)
        for _ in range(3):
            again = pa.paged_attention(*args, impl="cuda", **opt)
            assert torch.equal(first, again)


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
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        pa.paged_attention(q.double(), kp.double(), vp.double(), tables,
                           ctx, q0, impl="cuda")
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
            torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
            torch.float16: dict(atol=2e-4, rtol=2e-3)}


def _autograd_tol(dtype, ref):
    """Gradients through each path's own forward: a one-ulp difference
    in a bf16 o moves delta = rowsum(dO * O) and so every dS of its row,
    so bf16 adds 1% of the largest reference entry to one ulp (f16,
    with 3 more bits, 0.2%)."""
    if dtype == torch.float32:
        return GRAD_TOL[dtype]
    rel = 2e-3 if dtype == torch.float16 else 1e-2
    return dict(atol=rel * ref.abs().max().item(), rtol=rel)


FLASH_GEOMS = {   # b, sq, sk, hq, hk, d
    "gqa_d128": (2, 200, 200, 8, 2, 128),
    "mha_d32": (1, 130, 130, 4, 4, 32),
    "mqa_d32_sk_gt_sq": (2, 70, 150, 4, 1, 32),
    "sq_gt_sk_d128": (1, 100, 40, 4, 2, 128),      # leading rows see no key
    "mqa_group8_d128": (1, 200, 200, 8, 1, 128),   # one kv head for 8 q heads
    "gqa_d64": (2, 200, 200, 8, 2, 64),            # Llama-3.2-1B's head dim
    "sq_gt_sk_d64": (1, 100, 40, 4, 2, 64),
    "mqa_d64_sk_gt_sq": (2, 70, 150, 4, 1, 64),
    "gqa_d256": (2, 200, 200, 8, 4, 256),          # gemma2-2b's heads
    "mqa_group8_d256": (1, 200, 200, 8, 1, 256),   # gemma-2b's heads
    "sq_gt_sk_d256": (1, 100, 40, 4, 2, 256),
    "mha_d80": (2, 200, 200, 4, 4, 80),            # Phi-2's heads (MHA)
    "sq_gt_sk_d80": (1, 100, 40, 4, 2, 80),
    "mqa_d80_sk_gt_sq": (2, 70, 150, 4, 1, 80),
    "mha_d96": (2, 200, 200, 4, 4, 96),            # Phi-3-mini's heads (MHA)
    "sq_gt_sk_d96": (1, 100, 40, 4, 2, 96),
    "mqa_d96_sk_gt_sq": (2, 70, 150, 4, 1, 96),
}
FLASH_OPTS = {
    "alibi": dict(alibi=True),
    "alibi_window_softcap": dict(alibi=True, window=(40, -1),
                                 logit_softcap=10.0),
    "dropout": dict(dropout_p=0.1, dropout_seed=7),
    "dropout_segments_alibi": dict(dropout_p=0.3, dropout_seed=-5,
                                   segments=True, alibi=True),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("opt", sorted(FLASH_OPTS))
@pytest.mark.parametrize("geom", sorted(FLASH_GEOMS))
def test_flash_kernels_match_plain(card, geom, opt, dtype):
    kw = dict(FLASH_OPTS[opt])
    q, k, v, do, segs = _flash_case(0, card, dtype, *FLASH_GEOMS[geom],
                                    segments=kw.pop("segments", False))
    if kw.pop("alibi", False):
        hq = q.shape[2]
        kw["alibi_slopes"] = 2.0 ** (-8.0 * torch.arange(
            1, hq + 1, device=card, dtype=torch.float32) / hq)
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
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fa.flash_attention(q.double(), k.double(), v.double(), impl="cuda")
    with pytest.raises(TypeError, match="host int"):
        fa.flash_attention(q, k, v, q_offset=torch.tensor(3))
    with pytest.raises(ValueError, match="alibi_slopes"):
        fa.flash_attention(q, k, v, alibi_slopes=torch.ones(3, device=card))


def test_flash_dropout_fraction_and_seed(card):
    """With v = 1 every output entry is the kept share of its row's
    probabilities over 1 - p: its mean over many rows reads the dropped
    fraction.  Another seed gives another mask, the same seed the same."""
    p = 0.1
    b, s, h, d = 2, 512, 8, 128
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device=card,
                    dtype=torch.bfloat16) * 0.05      # near-uniform rows
    k = torch.randn((b, s, 2, d), generator=gen, device=card,
                    dtype=torch.bfloat16) * 0.05
    v = torch.ones_like(k)
    o = fa.flash_attention(q, k, v, causal=False, dropout_p=p,
                           dropout_seed=3).float()
    kept = o[..., 0] * (1 - p)                 # [b, s, h], each over s keys
    n = b * s * h * s
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs((1 - kept.mean().item()) - p) < 3 * sigma + 2e-3
    same = fa.flash_attention(q, k, v, causal=False, dropout_p=p,
                              dropout_seed=3).float()
    other = fa.flash_attention(q, k, v, causal=False, dropout_p=p,
                               dropout_seed=4).float()
    assert torch.equal(o, same) and not torch.equal(o, other)


# sq / sk on both sides of the bf16 kernels' tile edges (64-row
# streamed tiles, 128-row CTA blocks)
FLASH_EDGE_SIZES = [(1, 1), (63, 63), (64, 64), (65, 65), (127, 127),
                    (129, 129), (1, 129), (129, 1), (63, 129), (129, 65),
                    (65, 127)]
FLASH_EDGE_OPTS = {
    "causal": {},
    "full": dict(causal=False),
    "segments_window_both": dict(segments=True, causal=False,
                                 window=(40, 9)),
}


def _bwd_pair(q, k, v, do, segs, **kw):
    """B2/B3 from the forward kernel's (o, lse) and the plain backward
    from the same (o, lse)."""
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda",
                                **segs, **kw)
    return [fa.flash_attention_bwd(q, k, v, o, lse, do, impl=impl, **segs,
                                   **kw) for impl in ("cuda", "torch")]


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("opt", sorted(FLASH_EDGE_OPTS))
@pytest.mark.parametrize("sq,sk", FLASH_EDGE_SIZES,
                         ids=[f"sq{a}_sk{b}" for a, b in FLASH_EDGE_SIZES])
def test_flash_bwd_kernels_at_tile_edges(card, sq, sk, opt, d):
    kw = dict(FLASH_EDGE_OPTS[opt])
    segments = kw.pop("segments", False) and sq == sk
    q, k, v, do, segs = _flash_case(11, card, torch.bfloat16, 2, sq, sk, 8,
                                    2, d, segments=segments)
    got, ref = _bwd_pair(q, k, v, do, segs, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b, GRAD_TOL[torch.bfloat16], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
def test_flash_kernels_gemma2_sliding_layer_d256(card, dtype):
    """A Gemma2 sliding layer at heads of 256: 8 q heads over 4 kv
    heads, a 1023-key window that masks inside 2048-token rows, the
    score softcap 50 and packed documents, forward and both backward
    kernels against the plain versions.  q is 8x, so that the scores the
    softmax picks reach the cap's bend (1 - tanh^2 well below 1) and a
    backward without the cap's derivative would not pass."""
    q, k, v, do, segs = _flash_case(16, card, dtype, 1, 2048, 2048, 8, 4,
                                    256, segments=True)
    q = q * 8
    kw = dict(window=(1023, -1), logit_softcap=50.0,
              scale=256 ** -0.5)
    before = dict(fa.launch_counts)
    got = _flash_run(q, k, v, do, segs, "cuda", **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts["bwd_dkv"] == before["bwd_dkv"] + 1
    ref = _flash_run(q, k, v, do, segs, "torch", **kw)
    _close(got[1], ref[1], TOL[dtype], "o")
    _close(got[2], ref[2], TOL[torch.float32], "lse")
    bwd = [fa.flash_attention_bwd(q, k, v, got[1], got[2], do, impl=impl,
                                  **segs, **kw) for impl in ("cuda", "torch")]
    for name, a, b in zip(("dq", "dk", "dv"), *bwd):
        _close(a, b, GRAD_TOL[dtype], name)


def test_flash_bwd_kernels_4096_packed_documents_group8(card):
    """The training length with packed documents of 256-2047 tokens and
    8 q heads on one kv head."""
    rng = np.random.default_rng(12)
    b, s, hq, hk, d = 1, 4096, 8, 1, 128
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(card, torch.bfloat16)
    q, k, v, do = f(b, s, hq, d), f(b, s, hk, d), f(b, s, hk, d), \
        f(b, s, hq, d)
    pos = []
    while len(pos) < s:
        pos += list(range(int(rng.integers(256, 2048))))
    seg = fa.segment_ids_from_positions(
        torch.tensor([pos[:s]], dtype=torch.int32)).to(card)
    segs = dict(q_segment_ids=seg, kv_segment_ids=seg)
    got, ref = _bwd_pair(q, k, v, do, segs)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b_, GRAD_TOL[torch.bfloat16], name)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_bwd_kernels_repeat_bit_for_bit(card, dtype, d):
    """Each CTA owns its output and writes it once (no atomics): B2 and
    B3 give the same bits on every call."""
    q, k, v, do, segs = _flash_case(13, card, dtype, 2, 700, 700, 8, 2, d,
                                    segments=True)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda",
                                **segs)
    runs = [fa.flash_attention_bwd(q, k, v, o, lse, do, impl="cuda", **segs)
            for _ in range(4)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("opt", sorted(FLASH_EDGE_OPTS))
@pytest.mark.parametrize("sq,sk", FLASH_EDGE_SIZES,
                         ids=[f"sq{a}_sk{b}" for a, b in FLASH_EDGE_SIZES])
def test_flash_fwd_kernel_at_tile_edges(card, sq, sk, opt, d):
    kw = dict(FLASH_EDGE_OPTS[opt])
    segments = kw.pop("segments", False) and sq == sk
    q, k, v, _, segs = _flash_case(14, card, torch.bfloat16, 2, sq, sk, 8,
                                   2, d, segments=segments)
    got, ref = (fa.flash_attention(q, k, v, return_lse=True, impl=impl,
                                   **segs, **kw) for impl in ("cuda", "torch"))
    _close(got[0], ref[0], TOL[torch.bfloat16], "o")
    _close(got[1], ref[1], TOL[torch.float32], "lse")


def test_flash_fwd_kernel_4096_packed_documents_group8(card):
    """The training length with packed documents of 256-2047 tokens and
    8 q heads on one kv head."""
    rng = np.random.default_rng(15)
    b, s, hq, hk, d = 1, 4096, 8, 1, 128
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(card, torch.bfloat16)
    q, k, v = f(b, s, hq, d), f(b, s, hk, d), f(b, s, hk, d)
    pos = []
    while len(pos) < s:
        pos += list(range(int(rng.integers(256, 2048))))
    seg = fa.segment_ids_from_positions(
        torch.tensor([pos[:s]], dtype=torch.int32)).to(card)
    segs = dict(q_segment_ids=seg, kv_segment_ids=seg)
    got, ref = (fa.flash_attention(q, k, v, return_lse=True, impl=impl,
                                   **segs) for impl in ("cuda", "torch"))
    _close(got[0], ref[0], TOL[torch.bfloat16], "o")
    _close(got[1], ref[1], TOL[torch.float32], "lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_fwd_kernel_repeats_bit_for_bit(card, dtype):
    """Each CTA owns its rows and writes them once: B1 gives the same
    bits on every call."""
    q, k, v, _, segs = _flash_case(16, card, dtype, 2, 700, 700, 8, 2, 128,
                                   segments=True)
    runs = [fa.flash_attention(q, k, v, return_lse=True, impl="cuda", **segs)
            for _ in range(4)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


# the global offsets (B-1): q chunk and kv chunk of a whole sequence of
# 1024 rows at their offsets, head and batch offsets for dropout.
# name: (sq, sk, q_off, k_off, h_off, b_off, options)
FLASH_OFFSET_CASES = {
    # below the diagonal: every key of the chunk visible
    "causal_every_key_visible": (256, 256, 768, 256, 0, 0, {}),
    "causal_diagonal_segments": (256, 256, 512, 512, 0, 0,
                                 dict(segments=True)),
    # documents that began in an earlier chunk
    "causal_segments_below_diagonal": (256, 256, 768, 384, 0, 0,
                                       dict(segments=True)),
    # a windowed non-causal step with a negative shift: rows see no key
    "window_negative_shift": (256, 256, 0, 256, 0, 0,
                              dict(causal=False, window=(64, 64))),
    "window_positive_shift": (256, 256, 512, 256, 0, 0,
                              dict(window=(300, -1))),
    "alibi_softcap": (256, 256, 768, 512, 0, 0,
                      dict(alibi=True, logit_softcap=10.0)),
    "dropout_all_offsets": (256, 256, 512, 256, 8, 3,
                            dict(dropout_p=0.1, dropout_seed=21)),
    "dropout_alibi_segments_window": (256, 200, 768, 640, 4, 1,
                                      dict(dropout_p=0.2, dropout_seed=9,
                                           alibi=True, segments=True,
                                           window=(200, -1))),
}


def _offset_case(card, name, dtype, d):
    sq, sk, q_off, k_off, h_off, b_off, opts = FLASH_OFFSET_CASES[name]
    b, hq, hk = 2, 8, 2
    rng = np.random.default_rng(sorted(FLASH_OFFSET_CASES).index(name))
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(card, dtype)
    q, k, v, do = f(b, sq, hq, d), f(b, sk, hk, d), f(b, sk, hk, d), \
        f(b, sq, hq, d)
    kw = dict(opts, q_offset=q_off, k_offset=k_off, h_offset=h_off,
              b_offset=b_off)
    if kw.pop("segments", False):
        # the documents from a generator of their own, so that every head
        # dim sees the layout the case is named for (drawn after q, k, v
        # and do, whose sizes follow d, one layout at d 80 shared no
        # document between the chunks)
        seg_rng = np.random.default_rng(
            1000 + sorted(FLASH_OFFSET_CASES).index(name))
        ids = []
        while len(ids) < 1024:
            ids += [len(set(ids))] * int(seg_rng.integers(100, 700))
        seg = torch.tensor(ids[:1024], dtype=torch.int32,
                           device=card).repeat(b, 1)
        kw.update(q_segment_ids=seg[:, q_off:q_off + sq].contiguous(),
                  kv_segment_ids=seg[:, k_off:k_off + sk].contiguous())
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = 2.0 ** (-8.0 * torch.arange(
            1, hq + 1, device=card, dtype=torch.float32) / hq)
    return q, k, v, do, kw


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FLASH_OFFSET_CASES))
def test_flash_kernels_at_offsets_match_plain(card, name, dtype, d):
    """B1-B3 at non-zero q/k/h/b offsets against the plain versions at
    the same offsets (every instantiation: f32 on CUDA cores, bf16 on
    wgmma, with and without the ALiBi/dropout EXTRA), and a control at
    zero offsets that must part from them."""
    q, k, v, do, kw = _offset_case(card, name, dtype, d)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda", **kw)
    ref = fa.flash_attention(q, k, v, return_lse=True, impl="torch", **kw)
    _close(o, ref[0], TOL[dtype], "o")
    _close(lse, ref[1], TOL[torch.float32], "lse")
    bwd = [fa.flash_attention_bwd(q, k, v, o, lse, do, impl=impl, **kw)
           for impl in ("cuda", "torch")]
    for gname, a, b in zip(("dq", "dk", "dv"), *bwd):
        _close(a, b, GRAD_TOL[dtype], gname)
    empty = lse <= -1e29
    if empty.any():
        rows = empty.transpose(1, 2)
        assert (o[rows] == 0).all() and (bwd[0][0][rows] == 0).all()
    if name == "window_negative_shift":
        assert empty[:, :, :128].all()
    if kw["q_offset"] != kw["k_offset"] or kw.get("dropout_p"):
        zero = dict(kw, q_offset=0, k_offset=0, h_offset=0, b_offset=0)
        o0 = fa.flash_attention(q, k, v, impl="cuda", **zero)
        with pytest.raises(AssertionError):
            _close(o0, ref[0], TOL[dtype], "control o")


@pytest.mark.parametrize("ring_n,ul_n", [(4, 1), (2, 2)])
def test_virtual_ring_on_the_kernels_matches_one_call(card, ring_n, ul_n):
    """The context-parallel schedule over virtual ranks (ring steps at
    global offsets, skips, LSE merges; head groups at their offsets),
    through B1-B3, against one whole call, dropout included: the merge
    adds f32 rounding only, so one bf16 ulp holds, and B1 launches on
    exactly the steps step_should_run keeps."""
    from torchacc_tpu_torch.ops.context_parallel import step_should_run
    from torch_cp_virtual import virtual_cp_attention
    q, k, v, do, kw = _offset_case(card, "dropout_all_offsets",
                                   torch.bfloat16, 128)
    # the heads of 'tp' rank 1 and the rows of data shard 2
    kw.update(q_offset=0, k_offset=0, window=(300, -1),
              h_offset=q.shape[2], b_offset=2 * q.shape[0])
    seq = torch.arange(4 * 64, device=card).div(64, rounding_mode="floor")
    seg = seq.to(torch.int32).repeat(q.shape[0], 1)
    kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, impl="cuda", **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, impl="cuda", **kw)
    kw = {n: x for n, x in kw.items() if not n.endswith("_offset")}
    before = dict(fa.launch_counts)
    got = virtual_cp_attention(q, k, v, do, ring_n=ring_n, ul_n=ul_n,
                               tp_rank=1, data_pos=2, impl="cuda", **kw)
    torch.cuda.synchronize()
    s = q.shape[1] // ring_n
    kept = sum(step_should_run(me, src, s, True, kw["window"])
               for me in range(ring_n) for src in range(ring_n))
    assert fa.launch_counts["fwd"] - before["fwd"] == kept * ul_n
    assert fa.launch_counts["bwd_dq"] - before["bwd_dq"] == kept * ul_n
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got,
                          (o, lse) + grads):
        _close(a, b, TOL[torch.float32] if name == "lse"
               else GRAD_TOL[torch.bfloat16], name)


# ---------------------------------------------------------------------------
# quantized matmul (B5)
# ---------------------------------------------------------------------------

# fp8: the kernels quantize to the same e4m3 values as the plain version
# and sum the same exact products in f32 (on the f16 tensor cores) in
# another order than the plain f32 matmul.  bf16 outputs: one bf16 ulp.
# f32 outputs: 2e-5 of the value plus 2e-5 (K up to 1029 f32 terms of a
# few hundredths; the atol grows with the scales of x and w)
FP8_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
           torch.float16: dict(atol=1e-3, rtol=2e-3)}
# the fp8 result against an f64 product of its e4m3 operands at K = 14336,
# relative to max |ref| (read on an H100: 1.9e-6; the plain f32 matmul
# 1.7e-7)
FP8_F64_LIMIT = 4e-6

QMM_SHAPES = {   # M, K, N
    "tile": (128, 128, 128),
    "ragged": (200, 300, 136),
    "odd": (77, 65, 51),              # K, N odd: scalar loads and stores
    "tall": (1024, 512, 96),
    "k_lt_tile": (33, 16, 40),
    "k_5_mod_16": (96, 1029, 72),     # K padded to 1040 for TMA
}


def _fp8_close(got, ref, dtype, scale=1.0):
    tol = FP8_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _qmm_case(seed, device, dtype, m, k, n):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05
                          * (1 + rng.random((n, 1)) * 4)).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", sorted(QMM_SHAPES))
def test_quantized_matmul_kernel_matches_plain(card, shape, fmt, dtype,
                                               layout):
    x, w = _qmm_case(0, card, dtype, *QMM_SHAPES[shape])
    # 'nk': the nn.Linear weight read where it lies; 'kn': the flax layout
    kernel = w.t() if layout == "nk" else w.t().contiguous()
    before = dict(qm.launch_counts)
    for x_scale in (None, torch.tensor(0.011, device=card)):   # clips some
        got = qm.quantized_dot(x, kernel, 1, fmt=fmt, x_scale=x_scale,
                               impl="cuda")
        ref = qm.quantized_dot(x, kernel, 1, fmt=fmt, x_scale=x_scale,
                               impl="torch")
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all()
        if fmt == "int8":
            assert torch.equal(got, ref), (got.float() - ref.float()
                                           ).abs().max().item()
        else:
            _fp8_close(got, ref, dtype)
    before[fmt] += 2
    assert qm.launch_counts == before


# scales at the ends of the f32 range take the division (quant4_div)
SCALE_CASES = {"plain": (1.0, 1.0), "tiny_x_huge_w": (1e-23, 1e27),
               "huge_x_tiny_w": (1e27, 1e-23)}


@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", sorted(QMM_SHAPES))
def test_quantize_kernel_is_the_plain_quantize_pass(card, shape, fmt, dtype,
                                                    layout):
    """The quantize pass writes the plain pass's padded K-major bytes bit
    for bit, for normal and range-end scales; the GEMM on them gives the
    plain result (int8 bitwise)."""
    x, w = _qmm_case(2, card, dtype, *QMM_SHAPES[shape])
    # signed zeros (an f16 value that underflowed): fp8 keeps the sign
    x[0, 0], w[-1, -1] = -0.0, -0.0
    for case, (mx, mw) in SCALE_CASES.items():
        if dtype == torch.float16 and case != "plain":
            # f16 holds 6e-8..65504: such operands are zeros and infs
            continue
        xs, ws = (x.float() * mx).to(dtype), (w.float() * mw).to(dtype)
        kernel = ws.t() if layout == "nk" else ws.t().contiguous()
        sx = qm.compute_scale(qm._amax(xs) * 0.5, fmt)
        sw = qm.per_channel_scale(kernel, fmt)
        plan, x2, w2, sx2, sw2 = qm._cuda_operands(xs, kernel, sx, sw, fmt)
        qx, qw = qm._quantize_cuda(plan, x2, w2, sx2, sw2, fmt)
        px, pw = qm._quantize_pass_plain(xs, kernel, sx, sw, fmt)
        torch.cuda.synchronize()
        for got, want, name in ((qx, px, "qx"), (qw, pw, "qw")):
            assert got.dtype == want.dtype == qm._OPERAND_DTYPE[fmt]
            bad = (got.view(torch.uint8) != want.view(torch.uint8)).sum()
            assert bad.item() == 0, f"{case}: {name} differs in {bad} bytes"
        got = qm._gemm_cuda(plan, qx, qw, sx2, sw2, fmt, dtype)
        ref = qm._gemm_plain(px, pw, sx, sw, fmt).to(dtype)
        torch.cuda.synchronize()
        if fmt == "int8":
            assert torch.equal(got, ref), case
        else:
            _fp8_close(got, ref, dtype, mx * mw)


# the 'head' site's widths: llama3-8b's vocab, over 2 'tp' ranks, and the
# ragged vocabularies of GPT-2 and Phi-2 (M, K, N)
HEAD_SHAPES = {"llama3_vocab": (256, 4096, 128256),
               "llama3_vocab_tp2": (256, 4096, 64128),
               "gpt2_vocab": (300, 768, 50257),
               "phi2_vocab": (128, 2560, 51200)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", sorted(HEAD_SHAPES))
def test_quantized_matmul_at_the_vocab_width(card, shape, fmt, dtype):
    """B5 at the head's N (hundreds of 256-column tiles, a ragged last
    one): the nn.Linear weight read where it lies, int8 bitwise, fp8
    within FP8_TOL; an f16 value past 65504 is inf on both sides."""
    m, k, n = HEAD_SHAPES[shape]
    x, w = _qmm_case(4, card, dtype, m, k, n)
    w[:2] *= 1e4          # two vocab rows whose f16 logits pass 65504
    before = dict(qm.launch_counts)
    got = qm.quantized_dot(x, w.t(), 1, fmt=fmt, impl="cuda")
    ref = qm.quantized_dot(x, w.t(), 1, fmt=fmt, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    if fmt == "int8":
        assert torch.equal(got, ref)
    else:
        fin = torch.isfinite(ref)
        _fp8_close(got[fin], ref[fin], dtype)
    before[fmt] += 1
    assert qm.launch_counts == before
    assert qm.launch_shapes[(fmt, dtype, n)] >= 1


def test_fp8_sum_against_an_f64_product_at_k_14336(card):
    """The fp8 GEMM against an f64 product of the same e4m3 operands, at
    down's depth: within FP8_F64_LIMIT of max |ref|, an f32 sum's level."""
    x, w = _qmm_case(3, card, torch.bfloat16, 256, 14336, 512)
    sx = qm.compute_scale(qm._amax(x), "fp8")
    sw = qm.per_channel_scale(w.t(), "fp8")
    plan, x2, w2, sx2, sw2 = qm._cuda_operands(x, w.t(), sx, sw, "fp8")
    qx, qw = qm._quantize_cuda(plan, x2, w2, sx2, sw2, "fp8")
    got = qm._gemm_cuda(plan, qx, qw, sx2, sw2, "fp8", torch.float32)
    ref = (qx.double() @ qw.double().t()) * (sx2.double() * sw2.double())
    err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    assert err < FP8_F64_LIMIT, err


def test_quantized_matmul_zero_rows_and_grads(card):
    """All-zero inputs go through scale 1; the gradient is the
    straight-through one; auto launches the kernel; CPU tensors and
    wrong dtypes are refused."""
    x, w = _qmm_case(1, card, torch.bfloat16, 64, 96, 80)
    z = qm.quantized_dot(torch.zeros_like(x), w.t(), fmt="int8")
    assert (z == 0).all()
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = qm.launch_counts["fp8"]
    y = qm.quantized_dot(xg, wg.t(), fmt="fp8")
    assert qm.launch_counts["fp8"] == before + 1
    g = torch.randn_like(y)
    y.backward(g)
    torch.testing.assert_close(xg.grad, g @ w, atol=1e-2, rtol=2e-2)
    torch.testing.assert_close(wg.grad, g.t() @ x, atol=1e-2, rtol=2e-2)
    assert wg.grad.is_contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        qm.quantized_dot(x.cpu(), w.cpu().t(), impl="cuda")
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        qm.quantized_dot(x.double(), w.double().t(), impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        qm.quantized_dot(x, w.t(), impl="pallas")


def test_quantized_model_on_card_matches_plain_path(card):
    """llama-tiny (head_dim 32) with quant='int8' under save_attn_mlp
    remat: the loss through the kernel equals the plain path's bitwise
    and every gradient agrees (the backward matmuls are the same calls),
    the kernel launches 7 per layer and step, not again in the
    recompute, and each history advances once."""
    import dataclasses
    from torchacc_tpu_torch import get_preset, init_params
    from torchacc_tpu_torch.models.transformer import (
        init_quant_state, loss_fn, set_model_config)
    cfg = get_preset("llama-tiny", dtype=torch.float32, num_layers=2,
                     vocab_size=512, quant="int8", remat=True,
                     remat_policy="save_attn_mlp", attention_impl="torch")
    model = init_params(cfg, seed=0, device=card).requires_grad_(True).train()
    ids = torch.randint(0, 512, (2, 48), device=card,
                        generator=torch.Generator(device=card).manual_seed(1))
    labels = torch.roll(ids, -1, dims=1)
    results = {}
    for impl in ("cuda", "torch"):
        set_model_config(model, dataclasses.replace(cfg, quant_impl=impl))
        quant, new = init_quant_state(cfg, card), {}
        before = qm.launch_counts["int8"]
        loss = loss_fn(model(ids, quant=quant, quant_out=new), labels)
        loss.backward()
        launched = qm.launch_counts["int8"] - before
        assert launched == (7 * cfg.num_layers if impl == "cuda" else 0)
        assert all((h > 0).sum().item() == 1 and h[0] > 0
                   for h in new.values()) and len(new) == 14
        assert all((h == 0).all() for h in quant.values())
        results[impl] = (loss.detach(), [p.grad.clone()
                                         for p in model.parameters()])
        model.zero_grad(set_to_none=True)
    # the forward is bitwise; the embedding gradient is summed with
    # atomics, in an order that changes from run to run
    assert torch.equal(results["cuda"][0], results["torch"][0])
    for a, b in zip(results["cuda"][1], results["torch"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the data feed and host offload on the card
# ---------------------------------------------------------------------------

def test_async_loader_on_the_card_yields_the_host_batches(card):
    import torchacc_tpu_torch as tt
    from torchacc_tpu_torch.data import AsyncLoader, PackedDataset
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, 1000, size=int(rng.integers(5, 300)))
            .astype(np.int32) for _ in range(200)]
    host = list(PackedDataset(docs, 256, 4, buffer_docs=32))
    loader = AsyncLoader(PackedDataset(docs, 256, 4, buffer_docs=32),
                         tt.Config(data=tt.DataConfig(prefetch=2)))
    got = []
    for batch in loader:
        assert all(t.device.type == "cuda" for t in batch.values())
        # a step's worth of work on the consumer stream between batches
        torch.cuda._sleep(1_000_000)
        got.append({k: v.cpu().numpy() for k, v in batch.items()})
    assert len(got) == len(host) > 5
    for a, b in zip(got, host):
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_offload_dots_moves_the_counted_bytes_and_matches(card):
    """'offload_dots' on the card: two products a layer (attn_out and
    mlp_out, tokens x hidden x 2 bytes each) go to pinned host memory
    and back, and the gradients equal the no-remat ones."""
    import dataclasses
    import torchacc_tpu_torch.utils.remat as remat
    from torchacc_tpu_torch.models import get_preset
    from torchacc_tpu_torch.models.transformer import init_params, loss_fn
    from torchacc_tpu_torch.train import shift_labels
    cfg = get_preset("llama-tiny", num_layers=3, dtype=torch.bfloat16)
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 512))
                           .astype(np.int32)).to(card)
    labels = shift_labels(ids)
    grads = {}
    for policy in (None, "offload_dots"):
        c = cfg if policy is None else dataclasses.replace(
            cfg, remat=True, remat_policy=policy)
        model = init_params(c, seed=0, device=card).requires_grad_(True)
        remat.offload_counts.update(to_host_bytes=0, to_device_bytes=0)
        loss_fn(model(ids), labels).backward()
        grads[policy] = [p.grad for p in model.parameters()]
    want = 2 * ids.numel() * cfg.hidden_size * 2 * cfg.num_layers
    assert remat.offload_counts == {"to_host_bytes": want,
                                    "to_device_bytes": want}
    for a, b in zip(grads["offload_dots"], grads[None]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the training step on a mesh
# ---------------------------------------------------------------------------

def test_world_of_one_nccl_mesh_step_equals_the_one_device_step(card,
                                                               tmp_path):
    """llama-tiny (2 layers) in bf16 over f32 masters, save_attn_mlp,
    through the flash kernels: 3 steps under a world-1 NCCL group
    (accelerate() shards with FSDP2; the masters are DTensors) against
    the one-device step (the bf16 shadow) on the same weights and batch.
    Bitwise: FSDP2's bf16 cast is the shadow's rounding, its world-1
    gather and reduce are copies, and the step rounds the f32-reduced
    gradients to bf16, as the shadow's arrive, so AdamW's global-norm
    clip (which clips every step here) scales the same bf16 values.
    4096 tokens a step, so that the embedding's backward takes torch's
    sorted (deterministic) path."""
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    from torchacc_tpu_torch.parallel import initialize_distributed
    from torchacc_tpu_torch.train import adamw

    cfg = get_preset("llama-tiny", num_layers=2)
    clip = 0.05
    rng = np.random.default_rng(3)
    pos = np.concatenate([np.arange(n) for n in rng.integers(
        64, 512, size=40)])[:2 * 2048].reshape(2, 2048)
    pos = torch.from_numpy(pos.astype(np.int32))
    batch = {"input_ids": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, size=(2, 2048))).to(card),
             "positions": pos.to(card),
             "segment_ids": segment_ids_from_positions(pos).to(card)}

    def run():
        conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                      memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"))
        trainer, _ = accelerate(cfg, None, conf, optimizer=adamw(
            3e-3, grad_clip_norm=clip))
        state = trainer.init()
        out = [trainer.step(batch) for _ in range(3)]
        assert all(m["grad_norm"].item() > clip for m in out)
        losses = [m["loss"] for m in out]
        masters = {n: (p.to_local() if isinstance(p, DTensor) else p).clone()
                   for n, p in state.params.items()}
        return trainer, torch.stack(losses), masters

    _, one_losses, one_masters = run()
    initialize_distributed(f"file://{tmp_path / 'pg'}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        trainer, losses, masters = run()
        assert trainer.mesh is not None
        assert all(isinstance(m, FSDPModule) for m in trainer.model.layers)
        assert all(isinstance(p, DTensor) and p.is_cuda
                   for p in trainer.state.params.values())
    finally:
        dist.destroy_process_group()
    assert torch.equal(losses, one_losses), (losses, one_losses)
    for n, m in masters.items():
        assert torch.equal(m, one_masters[n]), n


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_batch(card, vocab):
    from torchacc_tpu_torch.ops.flash_attention import (
        segment_ids_from_positions)
    rng = np.random.default_rng(5)
    pos = np.concatenate([np.arange(n) for n in rng.integers(
        64, 512, size=40)])[:2 * 2048].reshape(2, 2048)
    pos = torch.from_numpy(pos.astype(np.int32))
    return {"input_ids": torch.from_numpy(rng.integers(
                0, vocab, size=(2, 2048))).to(card),
            "positions": pos.to(card),
            "segment_ids": segment_ids_from_positions(pos).to(card)}


def _ckpt_trainer(seed, **compute):
    """llama-tiny (2 layers), bf16 over f32 masters, save_attn_mlp,
    made from ``seed``: on the mesh when a process group is up."""
    from torchacc_tpu_torch import (ComputeConfig, Config, MemoryConfig,
                                    accelerate, get_preset)
    from torchacc_tpu_torch.train import adamw, warmup_cosine
    conf = Config(compute=ComputeConfig(bf16_compute_params=True, **compute),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  seed=seed)
    trainer, _ = accelerate(get_preset("llama-tiny", num_layers=2), None,
                            conf, optimizer=adamw(warmup_cosine(3e-3, 10, 1)))
    trainer.init()
    return trainer


def _flat_copy(state):
    from torchacc_tpu_torch.ops._common import to_local
    from torchacc_tpu_torch.train.state import flat_state
    return {k: to_local(v).clone() for k, v in flat_state(state).items()}


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device == w.device and got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k


def test_checkpoint_round_trip_on_the_card_keeps_device_and_bits(card,
                                                                 tmp_path):
    """A trainer's state after 2 steps, saved and restored into a
    trainer made from another seed: every leaf (masters, moments, the
    count, the step) bitwise, on the card; an asynchronous save followed
    by a step that updates in place still holds its own step's values."""
    a = _ckpt_trainer(0)
    batch = _ckpt_batch(card, a.model.cfg.vocab_size)
    for _ in range(2):
        a.step(batch)
    want = _flat_copy(a.state)
    assert all(v.is_cuda for k, v in want.items()
               if k not in ("step", "opt_state/count"))
    a.save(str(tmp_path / "sync"))
    handle = a.save(str(tmp_path / "async"), blocking=False)
    a.step(batch)                        # in place, behind the staging
    handle.wait()
    for name in ("sync", "async"):
        b = _ckpt_trainer(1)
        b.restore(str(tmp_path / name))
        _assert_flat_equal(_flat_copy(b.state), want)
        for n, p in b.model.named_parameters():   # the shadow, made again
            assert torch.equal(p, b.state.params[n].to(torch.bfloat16)), n


def _resumed_step(card, tmp_path, **compute):
    """(the uninterrupted run's third loss and state, the resumed run's,
    launches of the resumed step): run A takes 2 steps, saves, takes a
    third; run B, made from another seed, restores and takes the third."""
    a = _ckpt_trainer(0, **compute)
    batch = _ckpt_batch(card, a.model.cfg.vocab_size)
    for _ in range(2):
        a.step(batch)
    a.save(str(tmp_path / "ckpt"))
    want_loss = a.step(batch)["loss"]
    want = _flat_copy(a.state)
    del a
    b = _ckpt_trainer(1, **compute)
    b.restore(str(tmp_path / "ckpt"))
    counts = (fa.launch_counts, qm.launch_counts)
    for c in counts:
        for key in c:
            c[key] = 0
    loss = b.step(batch)["loss"]
    torch.cuda.synchronize()
    launches = {**fa.launch_counts, **qm.launch_counts}
    return want_loss, want, loss, _flat_copy(b.state), launches


@pytest.mark.parametrize("on_mesh", [False, True],
                         ids=["one_device_shadow", "world_of_one_nccl_mesh"])
def test_resumed_step_through_the_kernels_is_bitwise(card, tmp_path,
                                                     on_mesh):
    """The step after a restore, through B1-B3, equals the step of the
    run that never stopped, bitwise (loss and every leaf after it): with
    the bf16 shadow made again from the restored masters, and on a
    world-1 NCCL mesh, where the load lands in the DTensor masters."""
    import torch.distributed as dist
    from torchacc_tpu_torch.parallel import initialize_distributed
    if on_mesh:
        initialize_distributed(f"file://{tmp_path / 'pg'}", 1, 0)
    try:
        want_loss, want, loss, got, launches = _resumed_step(card, tmp_path)
        if on_mesh:
            assert dist.get_backend() == "nccl"
    finally:
        if on_mesh:
            dist.destroy_process_group()
    assert torch.equal(loss, want_loss), (loss, want_loss)
    _assert_flat_equal(got, want)
    for key in ("fwd", "bwd_dq", "bwd_dkv"):
        assert launches[key] == 2, launches      # 2 layers, one step


def test_int8_run_resumed_with_its_histories_is_bitwise(card, tmp_path):
    """int8 through B5: the amax histories ride the checkpoint, so the
    resumed step's loss, histories and every other leaf equal the
    uninterrupted run's bitwise."""
    want_loss, want, loss, got, launches = _resumed_step(
        card, tmp_path, quant="int8")
    assert torch.equal(loss, want_loss), (loss, want_loss)
    _assert_flat_equal(got, want)
    assert any(k.startswith("quant/") for k in want)
    assert launches["int8"] == 7 * 2, launches


def _pp_grads(card, batch, pp=None):
    """(loss, f32 gradients, flash launches) of one step's gradient pass
    of llama-tiny (4 layers), bf16 over f32 masters, save_attn_mlp:
    unpipelined with grad_accum 2, or over ``pp`` = (stages, schedule)
    with 2 micro-batches on every virtual stage of the card."""
    from torch_pp_virtual import virtual_pipeline
    from torchacc_tpu_torch import (ComputeConfig, Config, DistConfig,
                                    MemoryConfig, PPConfig, accelerate,
                                    get_preset)
    kw, dist_cfg, accum = {}, DistConfig(), 2
    if pp is not None:
        dist_cfg = DistConfig(pp=PPConfig(size=pp[0], num_micro_batches=2,
                                          schedule=pp[1]))
        kw["pipeline"], accum = virtual_pipeline(pp[0], 2, pp[1]), 1
    conf = Config(compute=ComputeConfig(bf16_compute_params=True),
                  memory=MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
                  dist=dist_cfg, grad_accum=accum, seed=3)
    trainer, _ = accelerate(get_preset("llama-tiny", num_layers=4), None,
                            conf, **kw)
    trainer.init()
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    loss, grads, _ = trainer._grads_accumulated(batch, None)
    torch.cuda.synchronize()
    return loss, {n: g.float() for n, g in grads.items()}, dict(
        fa.launch_counts)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_over_virtual_stages_on_the_kernels(card, schedule):
    """parallel/pp.py's schedule over 2 virtual stages on the card
    (tests/torch_pp_virtual.py) against the unpipelined grad_accum step
    on the same rows: 1F1B bitwise (the same bf16 arithmetic, the
    gradients summed in the same micro-batch order), GPipe within a
    relative 1e-6 of each gradient's largest entry (its backward takes
    the micro-batches in reverse, so the f32 sums reorder); B2/B3 launch
    layers x micro-batches, and B1 as often under GPipe and 2 x 4 x 2 -
    2 x 2 under 1F1B (every chunk but the last re-run in its backward
    tick)."""
    from torchacc_tpu_torch import get_preset
    batch = _ckpt_batch(card, get_preset("llama-tiny").vocab_size)
    ref_loss, ref, ref_launch = _pp_grads(card, batch)
    loss, grads, launches = _pp_grads(card, batch, (2, schedule))
    assert ref_launch == {"fwd": 8, "bwd_dq": 8, "bwd_dkv": 8}
    assert launches == {"fwd": 8 if schedule == "gpipe" else 12,
                        "bwd_dq": 8, "bwd_dkv": 8}
    assert sorted(grads) == sorted(ref)
    if schedule == "1f1b":
        assert torch.equal(loss, ref_loss)
        for n in ref:
            assert torch.equal(grads[n], ref[n]), n
        return
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=0)
    for n in ref:
        err = ((grads[n] - ref[n]).abs().max() / ref[n].abs().max()).item()
        assert err <= 1e-6, (n, err)
