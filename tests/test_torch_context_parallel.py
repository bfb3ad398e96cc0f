"""The port's context parallelism in one CPU process against the JAX
package: the global offsets of the flash attention (B-1) on the plain
path, the LSE merge, the ring's skip rule, ``SPConfig``, and the ring,
Ulysses and 2D schedules over virtual ranks against JAX's
``cp_attention`` on the emulated mesh.  The multi-rank runs are in
``tests/test_torch_cp_ranks.py``.

Tolerances, set from readings.  The flash cases hold the port's plain
flash (``impl='torch'``) at non-zero q/k/h/b offsets against JAX's
Pallas kernels B1-B3 in interpret mode at the same offsets, as
``tests/test_torch_flash_attention.py`` holds them without: o and lse
atol = rtol = 2e-5, the standalone backward's dq/dk/dv atol = rtol =
1e-4 (read <= 1.9e-6 and 3.9e-6).  The dropout keep masks at offsets
are compared bitwise.  ``merge_attention`` against JAX's: atol = rtol =
1e-6 (read 2.4e-7).  The virtual-rank schedules
(``tests/torch_cp_virtual.py``: the package's ring steps, skips and
merges, and its head groups' offsets) against JAX's ``cp_attention`` (``impl='xla'``) on 4
devices: the output and the gradients within 1e-5 of each one's
largest entry (read <= 3.2e-7), dropout included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.ops.attention import _dropout_keep_dense
from torchacc_tpu.ops.context_parallel import cp_attention as jax_cp
from torchacc_tpu.ops.context_parallel import merge_attention as jax_merge
from torchacc_tpu.ops.context_parallel.ring import (
    _step_should_run as jax_step_should_run,
)
from torchacc_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_bwd as jax_flash_bwd,
)
from torchacc_tpu.parallel.mesh import build_mesh
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models import get_preset
from torchacc_tpu_torch.models.transformer import check_training_supported
from torchacc_tpu_torch.ops._common import NEG_INF
from torchacc_tpu_torch.ops.attention import _dropped
from torchacc_tpu_torch.ops.context_parallel import (
    merge_attention,
    step_should_run,
)
from torchacc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    segment_ids_from_positions,
)
from torchacc_tpu_torch.serve.scheduler import _check_supported
from torch_cp_virtual import virtual_cp_attention

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _global_segments(rng, b, s):
    """Segment ids of packed documents over a whole sequence of s."""
    rows = []
    for _ in range(b):
        pos = []
        while len(pos) < s:
            pos += list(range(int(rng.integers(10, 90))))
        rows.append(pos[:s])
    return segment_ids_from_positions(
        torch.tensor(rows, dtype=torch.int32)).numpy()


# name: (sq, sk, q_off, k_off, h_off, b_off, options); the chunks lie at
# their offsets in a whole sequence of 256
OFFSET_CASES = {
    # a ring step below the diagonal: every key of the chunk visible
    "causal_every_key_visible": (64, 64, 192, 64, 0, 0, {}),
    "causal_diagonal_chunk_segments": (64, 64, 128, 128, 0, 0,
                                       dict(segments=True)),
    # a chunk whose first document began in an earlier chunk
    "causal_below_diagonal_segments": (64, 64, 192, 96, 0, 0,
                                       dict(segments=True)),
    # a windowed non-causal step whose shift is negative: the first rows
    # see no key
    "window_negative_shift_empty_rows": (64, 64, 0, 64, 0, 0,
                                         dict(causal=False,
                                              window=(16, 16))),
    "window_positive_shift": (64, 64, 128, 64, 0, 0,
                              dict(window=(80, -1))),
    "alibi_softcap": (64, 64, 192, 128, 0, 0,
                      dict(alibi=True, logit_softcap=5.0)),
    "dropout_all_offsets": (64, 64, 128, 64, 4, 2,
                            dict(dropout_p=0.2, dropout_seed=77)),
    "dropout_alibi_segments_window": (64, 48, 192, 160, 8, 1,
                                      dict(dropout_p=0.3, dropout_seed=5,
                                           alibi=True, segments=True,
                                           window=(40, -1))),
}
B, HQ, HK, D = 2, 8, 4, 32


def _offset_inputs(name):
    sq, sk, q_off, k_off, h_off, b_off, opts = OFFSET_CASES[name]
    rng = np.random.default_rng(sorted(OFFSET_CASES).index(name))
    q, do = (rng.standard_normal((B, sq, HQ, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, sk, HK, D)).astype(np.float32)
            for _ in range(2))
    opts = dict(opts)
    kw = dict(q_offset=q_off, k_offset=k_off, h_offset=h_off,
              b_offset=b_off)
    arrays = {}
    if opts.pop("segments", False):
        seg = _global_segments(rng, B, 256)
        arrays["q_segment_ids"] = seg[:, q_off:q_off + sq]
        arrays["kv_segment_ids"] = seg[:, k_off:k_off + sk]
    if opts.pop("alibi", False):
        arrays["alibi_slopes"] = (2.0 ** (-8.0 * np.arange(1, HQ + 1)
                                          / HQ)).astype(np.float32)
    kw.update(opts)
    return (q, k, v, do), arrays, kw


@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_flash_at_offsets_matches_jax_kernels(case):
    (q, k, v, do), arrays, kw = _offset_inputs(case)
    blocks = dict(block_q=32, block_k=32)    # several tiles per side
    jarr = {n: jnp.asarray(a) for n, a in arrays.items()}
    tarr = {n: torch.from_numpy(a) for n, a in arrays.items()}
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jo, jlse = jax_flash(jq, jk, jv, return_lse=True, **jarr, **blocks, **kw)
    jgrads = jax_flash_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), **jarr,
                           **blocks, **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    to, tlse = flash_attention(tq, tk, tv, return_lse=True, impl="torch",
                               **tarr, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)
    tgrads = flash_attention_bwd(tq, tk, tv, to, tlse, torch.from_numpy(do),
                                 impl="torch", **tarr, **kw)
    for name, a, b_ in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **GRAD_TOL,
                                   err_msg=name)
    if kw["q_offset"] != kw["k_offset"] or kw.get("dropout_p"):
        # the offsets move the result: at 0 it differs (the control; on
        # the diagonal without dropout they cancel)
        zero = dict(kw, q_offset=0, k_offset=0, h_offset=0, b_offset=0)
        o0 = flash_attention(tq, tk, tv, impl="torch", **tarr, **zero)
        assert not np.allclose(o0.numpy(), np.asarray(jo), **FWD_TOL)
    if case == "window_negative_shift_empty_rows":
        assert (to[:, :32] == 0).all() and (tlse[:, :, :32] == NEG_INF).all()


@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (4096, 1024, 8, 3),
                                     (2 ** 20 - 64, 2 ** 19, 0, 7)])
def test_dropout_masks_at_offsets_bitwise_jax(offsets):
    """The plain version's keep mask at the global coordinates is JAX's,
    bit for bit, up to a 1 M-token context."""
    q_off, k_off, h_off, b_off = offsets
    b, h, sq, sk, p, seed = 2, 4, 48, 40, 0.3, 123456789
    kept = _dropped(torch.ones(b, h, sq, sk), p, seed, offsets) != 0
    want = _dropout_keep_dense(
        seed, b, h, jnp.arange(sq, dtype=jnp.int32) + q_off,
        jnp.arange(sk, dtype=jnp.int32) + k_off, p, h_offset=h_off,
        b_offset=b_off)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want))


def test_merge_attention_matches_jax():
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 16, 4, 8
    oa, ob = (rng.standard_normal((b, s, h, d)).astype(np.float32)
              for _ in range(2))
    la, lb = (rng.standard_normal((b, h, s)).astype(np.float32) * 3
              for _ in range(2))
    la[0, 0, :4] = NEG_INF            # rows empty in one partial
    lb[0, 1, 2:6] = NEG_INF
    la[1, 2, :3] = lb[1, 2, :3] = NEG_INF   # and in both
    oa[1, :3, 2] = ob[1, :3, 2] = 0.0
    got = merge_attention(*(torch.from_numpy(x) for x in (oa, la, ob, lb)))
    want = jax_merge(*(jnp.asarray(x) for x in (oa, la, ob, lb)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    assert (got[1][1, 2, :3] == NEG_INF).all()
    assert (got[0][1, :3, 2] == 0).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [(-1, -1), (5, -1), (40, 3), (-1, 12)])
def test_step_should_run_matches_jax(causal, window):
    for n, s in ((4, 16), (8, 8)):
        for me in range(n):
            for src in range(n):
                want = bool(jax_step_should_run(me, src, s, causal, window))
                assert step_should_run(me, src, s, causal, window) == want


@pytest.mark.parametrize("fields", [
    dict(size=4), dict(size=4, mode="ring"),
    dict(size=8, mode="2d", intra_size=2), dict(size=4, mode="2d"),
    dict(size=6, mode="2d", intra_size=4), dict(size=2, mode="zigzag"),
])
def test_sp_config_matches_jax(fields):
    def run(pkg):
        try:
            d = pkg.DistConfig(sp=pkg.SPConfig(**fields))
            d.sp.validate()
            return (d.sp.ulysses_degree, d.sp.ring_degree, d.axis_sizes(8))
        except ValueError as e:
            return f"{type(e).__name__}: {e}"
    got = run(tt)
    assert got == run(ta)


VIRTUAL_CASES = {   # name: (sp config, ring_n, ul_n, options)
    "ring_4": (dict(size=4, mode="ring"), 4, 1,
               dict(window=(40, -1), dropout_p=0.1, alibi=True)),
    "ulysses_4": (dict(size=4, mode="ulysses"), 1, 4,
                  dict(dropout_p=0.2, logit_softcap=5.0)),
    "2d_4_intra_2": (dict(size=4, mode="2d", intra_size=2), 2, 2,
                     dict(window=(24, -1), dropout_p=0.1, alibi=True)),
}


@pytest.mark.parametrize("name", sorted(VIRTUAL_CASES))
def test_virtual_ranks_match_jax_cp_attention(name):
    sp, ring_n, ul_n, opts = VIRTUAL_CASES[name]
    rng = np.random.default_rng(sorted(VIRTUAL_CASES).index(name))
    b, s, h, kh, d = 2, 64, 8, 4, 16
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32)
            for _ in range(2))
    seg = _global_segments(rng, b, s)
    kw = dict(causal=True, window=opts.get("window", (-1, -1)),
              dropout_p=opts.get("dropout_p", 0.0), dropout_seed=11,
              logit_softcap=opts.get("logit_softcap", 0.0))
    slopes = ((2.0 ** (-8.0 * np.arange(1, h + 1) / h)).astype(np.float32)
              if opts.get("alibi") else None)
    got = virtual_cp_attention(
        *(torch.from_numpy(x) for x in (q, k, v, do)), ring_n=ring_n,
        ul_n=ul_n, q_segment_ids=torch.from_numpy(seg),
        kv_segment_ids=torch.from_numpy(seg),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        impl="torch", **kw)
    mesh = build_mesh(ta.DistConfig(sp=ta.SPConfig(**sp)),
                      devices=jax.devices()[:4])
    assert (mesh.shape["sp"], mesh.shape["spu"]) == (ring_n, ul_n)
    qkv = NamedSharding(mesh, P(("dp", "fsdp"), ("sp", "spu"), "tp", None))
    segs = NamedSharding(mesh, P(("dp", "fsdp"), ("sp", "spu")))
    extra = {} if slopes is None else dict(alibi_slopes=jnp.asarray(slopes))

    @jax.jit
    def fwd_bwd(q_, k_, v_, seg_, do_):
        out, vjp = jax.vjp(lambda a, b_, c: jax_cp(
            a, b_, c, q_segment_ids=seg_, kv_segment_ids=seg_, mesh=mesh,
            impl="xla", **kw, **extra), q_, k_, v_)
        return (out,) + vjp(do_)

    with jax.sharding.set_mesh(mesh):
        args = [jax.device_put(jnp.asarray(x), qkv) for x in (q, k, v)]
        args += [jax.device_put(jnp.asarray(seg), segs),
                 jax.device_put(jnp.asarray(do), qkv)]
        want = jax.device_get(fwd_bwd(*args))
    for key, a, w in zip(("o", "dq", "dk", "dv"),
                         (got[0],) + tuple(got[2:]), want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def test_serving_refuses_a_context_parallel_model_by_name():
    """Training takes ``context_parallel``; serving refuses it by name, as
    the JAX scheduler does (torchacc_tpu/serve/scheduler.py:137-138)."""
    cfg = get_preset("llama-tiny", num_layers=1, context_parallel=True)
    check_training_supported(cfg)
    with pytest.raises(NotImplementedError, match="context_parallel=True"):
        _check_supported(cfg)
