"""The port's ServeEngine (device='cpu', greedy) against the JAX
package's ``models.generate.generate`` through the ragged left-padded
recipe of tests/test_serving.py: the token streams must be IDENTICAL.

The weights are the JAX model's own (``params_from_jax``) in f32, so
the two packages compute the same function and only summation order
differs.  Sampled streams cannot be compared with JAX (its PRNG keys do
not exist in torch); they are held to determinism within the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_module_env import port_module_env
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.generate import generate
from torchacc_tpu_torch.config import Config, ServeConfig
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.serve import Request, ServeEngine

VOCAB = 257
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
            intermediate_size=128, vocab_size=VOCAB, max_seq_len=128)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxLM(jax_preset("llama-tiny", dtype=jnp.float32, **TINY))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_preset("llama-tiny", dtype=torch.float32, **TINY)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jmodel, params, model


def _conf(**kw):
    base = dict(block_size=8, num_blocks=64, max_slots=4, prefill_chunk=8,
                decode_depth=2)
    base.update(kw)
    return Config(serve=ServeConfig(**base))


def _engine(model, **kw):
    return ServeEngine(model, _conf(**kw), device="cpu")


def _prompts(rng, lens):
    return [rng.integers(1, VOCAB, size=n).tolist() for n in lens]


def _ref_generate(jmodel, params, prompts, max_new, eos_id=None):
    """ONE ragged left-padded generate() call over every prompt."""
    p_max = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), p_max), np.int32)
    mask = np.zeros((len(prompts), p_max), np.int32)
    for i, p in enumerate(prompts):
        ids[i, p_max - len(p):] = p
        mask[i, p_max - len(p):] = 1
    out = np.asarray(generate(
        jmodel, params, jnp.asarray(ids), max_new_tokens=max_new,
        prompt_mask=jnp.asarray(mask), eos_id=eos_id))
    return [out[i, p_max:].tolist() for i in range(len(prompts))]


def test_mixed_lengths_token_identical(tiny):
    # lengths span 25/3 > 8x; 6 requests > 4 slots so the queue runs;
    # chunk 8 < 25 so long prompts take several interleaved chunks
    jmodel, params, model = tiny
    prompts = _prompts(np.random.default_rng(0), [3, 25, 7, 16, 4, 11])
    eng = _engine(model)
    results = eng.generate(
        [Request(prompt_ids=p, max_new_tokens=6) for p in prompts])
    refs = _ref_generate(jmodel, params, prompts, 6)
    for r, ref in zip(results, refs):
        assert r.tokens == ref
        assert r.finish_reason == "length"
        assert 0.0 <= r.queue_wait_s <= r.ttft_s <= r.total_s
        assert len(r.token_latencies_s) == len(r.tokens) - 1
    stats = eng.stats()
    assert stats["requests"] == 6 and stats["tokens"] == 36
    assert eng.scheduler.pool.available == 63      # every block returned
    eng.close()


def test_staggered_arrivals_token_identical(tiny):
    # the second wave arrives mid-decode of the first
    jmodel, params, model = tiny
    rng = np.random.default_rng(1)
    first, second = _prompts(rng, [3, 25, 7]), _prompts(rng, [24, 4, 12])
    eng = _engine(model)
    ids = [eng.submit(Request(prompt_ids=p, max_new_tokens=5))
           for p in first]
    for _ in range(6):
        eng.step()
    ids += [eng.submit(Request(prompt_ids=p, max_new_tokens=5))
            for p in second]
    eng.run()
    refs = _ref_generate(jmodel, params, first + second, 5)
    for rid, ref in zip(ids, refs):
        assert eng.result(rid).tokens == ref
    eng.close()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_decode_depth_token_identical(tiny, depth):
    # the lagged ring changes timing, never tokens; a tiny pool forces
    # block reuse under the deferred-free rule
    jmodel, params, model = tiny
    prompts = _prompts(np.random.default_rng(7), [3, 18, 9, 6, 5])
    eng = _engine(model, decode_depth=depth, block_size=4, num_blocks=20,
                  max_slots=3, prefill_chunk=4)
    ids = [eng.submit(Request(prompt_ids=p, max_new_tokens=6))
           for p in prompts]
    sched = eng.scheduler
    while eng.step():
        live = [b for s in sched.slot_seq if s is not None
                for b in s.blocks]
        deferred = [b for _, blks in sched._deferred for b in blks]
        assert len(live) == len(set(live)), "live block aliased"
        assert 0 not in live + deferred, "null block allocated"
        assert set(live).isdisjoint(deferred)
    refs = _ref_generate(jmodel, params, prompts, 6)
    for rid, ref in zip(ids, refs):
        assert eng.result(rid).tokens == ref
    assert sched.pool.available == 19
    eng.close()


def test_eos_truncates_like_generate(tiny):
    jmodel, params, model = tiny
    prompts = _prompts(np.random.default_rng(3), [5, 13])
    free = _ref_generate(jmodel, params, prompts, 8)
    eos = free[0][2]                 # a token the greedy stream emits
    eng = _engine(model)
    results = eng.generate(
        [Request(prompt_ids=p, max_new_tokens=8, eos_id=eos)
         for p in prompts])
    for r, ref in zip(results, free):
        if eos in ref:
            assert r.tokens == ref[:ref.index(eos) + 1]
            assert r.finish_reason == "eos"
        else:
            assert r.tokens == ref
            assert r.finish_reason == "length"
    eng.close()


def test_prefix_cache_hits_and_cow_token_identical(tiny):
    """Cold -> partial hit -> full match (COW) -> COW off blocks a live
    sequence still reads, all token-identical to generate()."""
    jmodel, params, model = tiny
    rng = np.random.default_rng(5)
    sys_a = rng.integers(1, VOCAB, size=16).tolist()   # 2 full blocks
    prompts = [
        sys_a + rng.integers(1, VOCAB, size=5).tolist(),   # cold
        sys_a + rng.integers(1, VOCAB, size=9).tolist(),   # partial hit
        list(sys_a),                                       # full match: COW
    ]
    max_new = 6
    eng = _engine(model, prefix_cache=True, max_slots=3)
    ids = []
    for p in prompts:                        # each wave completes first
        ids.append(eng.submit(Request(prompt_ids=p, max_new_tokens=max_new)))
        eng.run()
    # a COW admission and a sharing one while the owner still decodes
    live = sys_a + rng.integers(1, VOCAB, size=7).tolist()
    ids.append(eng.submit(Request(prompt_ids=live, max_new_tokens=10)))
    for _ in range(4):
        eng.step()
    ids.append(eng.submit(Request(prompt_ids=list(sys_a),
                                  max_new_tokens=10)))
    eng.run()
    refs = (_ref_generate(jmodel, params, prompts, max_new)
            + _ref_generate(jmodel, params, [live, list(sys_a)], 10))
    res = [eng.result(r) for r in ids]
    for r, ref in zip(res, refs):
        assert r.tokens == ref
    assert [r.cached_prompt_tokens for r in res] == [0, 16, 15, 16, 15]
    st = eng.stats()
    assert st["cow_copies"] == 2 and st["prefix_hits"] == 4
    pool = eng.scheduler.pool
    assert pool.available + pool.in_use == 63
    eng.close()


def test_batched_prefill_token_identical(tiny):
    jmodel, params, model = tiny
    prompts = _prompts(np.random.default_rng(6), [6, 19, 11, 25, 9, 14])
    eng = _engine(model, prefill_batch=2)
    batched = []
    orig = eng.scheduler._prefill_batched
    eng.scheduler._prefill_batched = \
        lambda seqs: (batched.append(len(seqs)), orig(seqs))[1]
    ids = [eng.submit(Request(prompt_ids=p, max_new_tokens=6))
           for p in prompts[:4]]
    for _ in range(3):                       # second wave mid-flight
        eng.step()
    ids += [eng.submit(Request(prompt_ids=p, max_new_tokens=6))
            for p in prompts[4:]]
    eng.run()
    assert batched and max(batched) == 2     # the batched path ran
    refs = _ref_generate(jmodel, params, prompts, 6)
    for rid, ref in zip(ids, refs):
        assert eng.result(rid).tokens == ref
    eng.close()


def test_sampled_serving_deterministic_within_port(tiny):
    # fixed per-request seeds: two fresh engines, and the same request
    # served beside different batch-mates, give identical streams
    _, _, model = tiny
    prompts = _prompts(np.random.default_rng(8), [4, 11, 9])
    reqs = [Request(prompt_ids=p, max_new_tokens=5, temperature=0.8,
                    top_k=7, top_p=0.9, seed=i)
            for i, p in enumerate(prompts)]
    outs = [[r.tokens for r in _engine(model).generate(reqs)]
            for _ in range(2)]
    assert outs[0] == outs[1]
    alone = _engine(model).generate([reqs[1]])[0].tokens
    assert alone == outs[0][1]
    for toks in outs[0]:
        assert len(toks) == 5 and all(0 <= t < VOCAB for t in toks)
    # a different seed gives a different stream
    other = _engine(model).generate(
        [Request(prompt_ids=prompts[1], max_new_tokens=5, temperature=0.8,
                 top_k=7, top_p=0.9, seed=99)])[0].tokens
    assert other != outs[0][1]


def test_greedy_unchanged_when_batched_with_sampled(tiny):
    jmodel, params, model = tiny
    g_prompt, s_prompt = _prompts(np.random.default_rng(13), [10, 4])
    eng = _engine(model)
    rid_g = eng.submit(Request(prompt_ids=g_prompt, max_new_tokens=8))
    rid_s = eng.submit(Request(prompt_ids=s_prompt, max_new_tokens=2,
                               temperature=0.8, top_k=5, seed=3))
    eng.run()
    assert eng.result(rid_g).tokens == _ref_generate(
        jmodel, params, [g_prompt], 8)[0]
    assert len(eng.result(rid_s).tokens) == 2


def test_stream_and_callback_deliver_exactly_result_tokens(tiny):
    _, _, model = tiny
    prompts = _prompts(np.random.default_rng(9), [6, 12])
    eng = _engine(model)
    seen = []
    rid_cb = eng.submit(Request(prompt_ids=prompts[0], max_new_tokens=5),
                        on_token=lambda tok, t: seen.append(tok))
    rid = eng.submit(Request(prompt_ids=prompts[1], max_new_tokens=5))
    streamed = list(eng.stream(rid))
    eng.run()
    assert streamed == eng.result(rid).tokens
    assert seen == eng.result(rid_cb).tokens


def test_admission_rejects_unservable_and_full_queue(tiny):
    _, _, model = tiny
    eng = _engine(model, num_blocks=8, max_queue=2)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(Request(prompt_ids=[1] * 40, max_new_tokens=32))
    with pytest.raises(ValueError):
        eng.submit(Request(prompt_ids=[]))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(prompt_ids=[1, 2], max_new_tokens=0))
    with pytest.raises(ValueError, match="prompt_ids must lie"):
        eng.submit(Request(prompt_ids=[1, VOCAB], max_new_tokens=2))
    eng.submit(Request(prompt_ids=[1, 2], max_new_tokens=2))
    eng.submit(Request(prompt_ids=[3, 4], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="queue full"):
        eng.submit(Request(prompt_ids=[5, 6], max_new_tokens=2))
    eng.run()
    assert eng.stats()["requests"] == 2


def test_sjf_policy_admits_short_first(tiny):
    _, _, model = tiny
    long_p, short_p = _prompts(np.random.default_rng(5), [20, 3])
    eng = _engine(model, max_slots=1, policy="sjf")
    rid_long = eng.submit(Request(prompt_ids=long_p, max_new_tokens=3))
    rid_short = eng.submit(Request(prompt_ids=short_p, max_new_tokens=3))
    eng.run()
    assert eng._all[rid_short].t_admit < eng._all[rid_long].t_admit


def test_engine_defaults_to_cuda_and_raises_without_it(tiny):
    _, _, model = tiny
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, _conf())
    with pytest.raises(ValueError, match="weights are on"):
        ServeEngine(model, _conf(), device="meta")


def test_per_request_metrics_written(tiny, tmp_path):
    import json
    _, _, model = tiny
    prompts = _prompts(np.random.default_rng(6), [4, 9])
    eng = ServeEngine(model, _conf(), device="cpu",
                      metrics_dir=str(tmp_path))
    eng.generate([Request(prompt_ids=p, max_new_tokens=3) for p in prompts])
    eng.close()
    recs = [json.loads(line)
            for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 2
    for r in recs:
        assert r["serve/tokens"] == 3 and r["serve/ttft_s"] >= 0


def test_table_width_bounded_by_position_reach_not_pool(tiny):
    # per-token attention cost tracks the table width, so the width is
    # the longest admissible sequence, not the pool size
    _, _, model = tiny
    eng = _engine(model, num_blocks=4096)
    expect = -(-(model.cfg.max_seq_len + 2) // 8)          # 17, not 4095
    assert eng.scheduler.max_blocks_per_seq == expect
    assert eng.scheduler.tables.shape[1] == expect
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(Request(prompt_ids=[1] * 120, max_new_tokens=64))
