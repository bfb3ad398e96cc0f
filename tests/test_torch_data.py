"""The port's input pipeline against the JAX package's, on the CPU:
``pack_sequences`` (native and NumPy plans), ``closest_bucket`` and
``pad_batch``, ``PackedDataset`` (shuffle, shards, pad_final, two
epochs, state cross-loaded between the packages) and ``AsyncLoader``
(the same batches, state and ``skip_batches``, early break).  Every
document is made by numpy from a seed; every comparison is bitwise
(values and dtypes)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.data import AsyncLoader as JaxLoader
from torchacc_tpu.data import PackedDataset as JaxDataset
from torchacc_tpu.data import closest_bucket as jax_closest_bucket
from torchacc_tpu.data import pack_sequences as jax_pack
from torchacc_tpu.data import pad_batch as jax_pad_batch
from torchacc_tpu.parallel.mesh import build_mesh
import torchacc_tpu_torch as tt
import torchacc_tpu_torch.data.packing as packing
from torchacc_tpu_torch.data import (
    AsyncLoader,
    DataLoaderError,
    PackedDataset,
    closest_bucket,
    pack_sequences,
    pad_batch,
)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _docs(seed, n=60, lo=1, hi=90, vocab=1000):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _same(a, b):
    """Two dicts of arrays, bitwise (values, shapes and dtypes)."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _same_stream(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys) and xs
    for x, y in zip(xs, ys):
        _same(x, y)


@pytest.mark.parametrize("seed,seq_len", [(0, 64), (1, 48), (2, 128)])
def test_pack_sequences_native_numpy_and_jax_bitwise(seed, seq_len,
                                                    monkeypatch):
    """Documents up to 1.5x seq_len (the longer ones are cut)."""
    docs = _docs(seed, hi=seq_len * 3 // 2)
    native = pack_sequences(docs, seq_len, pad_id=7)
    assert packing.last_packer == "native"
    # without the native library pack_sequences runs the NumPy plan
    monkeypatch.setattr(packing, "_load_native", lambda: None)
    plain = pack_sequences(docs, seq_len, pad_id=7)
    assert packing.last_packer == "numpy"
    ref = jax_pack(docs, seq_len, pad_id=7)
    _same(native, ref)
    _same(plain, ref)
    assert any(len(d) > seq_len for d in docs)


@pytest.mark.parametrize("case", ["pad", "truncate", "one_d_and_custom",
                                  "exact", "no_buckets"])
def test_closest_bucket_and_pad_batch_match_jax(case):
    rng = np.random.default_rng(3)
    seq = {"pad": 37, "truncate": 300, "one_d_and_custom": 20,
           "exact": 64, "no_buckets": 37}[case]
    batch = {"input_ids": rng.integers(0, 100, (4, seq)).astype(np.int32),
             "labels": rng.integers(0, 100, (4, seq)).astype(np.int32),
             "segment_ids": np.zeros((4, seq), np.int32),
             "positions": np.tile(np.arange(seq, dtype=np.int32), (4, 1))}
    pad_values = None
    if case == "one_d_and_custom":
        batch["weight"] = rng.random(4).astype(np.float32)
        batch["scalar"] = np.asarray(3.0, np.float32)
        pad_values = {"input_ids": 5, "positions": -7}
    buckets = None if case == "no_buckets" else [16, 32, 64, 128]
    got = pad_batch(batch, buckets, pad_values)
    ref = jax_pad_batch(batch, buckets, pad_values)
    _same(got, ref)
    # torch tensors in, numpy out, as JAX's
    _same(pad_batch({k: torch.from_numpy(np.array(v))
                     for k, v in batch.items()}, buckets, pad_values), ref)
    for length in (1, 16, 17, 128, 129, 500):
        assert closest_bucket([16, 32, 64, 128], length) == \
            jax_closest_bucket([16, 32, 64, 128], length)


_DATASETS = {   # name: PackedDataset kwargs beside seq_len 32
    "plain": dict(batch_rows=4),
    "shuffled": dict(batch_rows=4, shuffle_seed=11),
    "shard1of2_pad_final": dict(batch_rows=4, num_shards=2, shard_index=1,
                                pad_final=True, shuffle_seed=5),
    "small_buffer_pad_id": dict(batch_rows=2, buffer_docs=7, pad_id=3,
                                pad_final=True),
}


@pytest.mark.parametrize("name", sorted(_DATASETS))
def test_packed_dataset_matches_jax_over_two_epochs(name):
    docs = _docs(4, n=80, hi=40)
    kw = dict(_DATASETS[name])
    kw.setdefault("buffer_docs", 16)
    port, ref = PackedDataset(docs, 32, **kw), JaxDataset(docs, 32, **kw)
    first = list(port)
    _same_stream(first, list(ref))
    second = list(port)
    _same_stream(second, list(ref))
    assert port.state_dict() == ref.state_dict()
    if "shuffle_seed" in kw:
        assert any(not np.array_equal(a["input_ids"], b["input_ids"])
                   for a, b in zip(first, second))


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("cut", [1, 5])
def test_packed_dataset_state_resumes_in_the_other_package(saver, cut):
    """A state taken mid-epoch by either package, through JSON, resumes
    in the other onto the same remaining batches."""
    import json
    docs = _docs(6, n=90, hi=40)
    kw = dict(batch_rows=4, buffer_docs=16, shuffle_seed=2)
    make = {"jax": JaxDataset, "port": PackedDataset}
    src = make[saver](docs, 32, **kw)
    it = iter(src)
    for _ in range(cut):
        next(it)
    state = json.loads(json.dumps(src.state_dict()))
    rest = list(it)
    dst = make["port" if saver == "jax" else "jax"](docs, 32, **kw)
    dst.load_state_dict(state)
    _same_stream(list(dst), rest)


def test_packed_dataset_refuses_another_stream():
    docs = _docs(7)
    state = PackedDataset(docs, 32, 4).state_dict()
    other = PackedDataset(docs, 64, 4)
    with pytest.raises(DataLoaderError, match="seq_len"):
        other.load_state_dict(state)


def _loaders(docs, data=None, **kw):
    """(port AsyncLoader on the CPU, JAX AsyncLoader on one device) over
    two PackedDatasets of the same documents."""
    kw = dict(dict(batch_rows=4, buffer_docs=16), **kw)
    conf = tt.Config(data=data or tt.DataConfig())
    jconf = ta.Config(data=ta.DataConfig(**vars(conf.data)))
    mesh = build_mesh(jconf.dist, devices=jax.devices()[:1])
    return (AsyncLoader(PackedDataset(docs, 32, **kw), conf, device="cpu"),
            JaxLoader(JaxDataset(docs, 32, **kw), jconf, mesh=mesh))


def _np(batches):
    out = []
    for b in batches:
        for v in b.values():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        out.append({k: v.numpy() for k, v in b.items()})
    return out


@pytest.mark.parametrize("data", [
    tt.DataConfig(),
    tt.DataConfig(buckets=[16, 40, 64], prefetch=1),
    tt.DataConfig(max_length=48, num_buckets=2, prefetch=3,
                  pad_value_dict={"input_ids": 9}),
])
def test_async_loader_cpu_matches_jax(data):
    port, ref = _loaders(_docs(8, n=70, hi=40), data)
    _same_stream(_np(port), [jax.tree.map(np.asarray, b) for b in ref])


@pytest.mark.parametrize("mode", ["state", "skip"])
def test_async_loader_state_and_skip_match_jax(mode):
    docs = _docs(9, n=90, hi=40)
    port, ref = _loaders(docs, shuffle_seed=4)
    if mode == "skip":
        got = _np(port.skip_batches(3))
        want = [jax.tree.map(np.asarray, b) for b in ref.skip_batches(3)]
        _same_stream(got, want)
        return
    states = []
    for loader in (port, ref):
        it = iter(loader)
        for _ in range(2):
            next(it)
        states.append(loader.state_dict())
        it.close()
    # the source's own count is the producer's, which runs ahead by as
    # much as the thread got to; the consumer-side fields must agree
    for key in ("version", "kind", "batches_consumed", "source_position"):
        assert states[0][key] == states[1][key], key
    assert states[0]["batches_consumed"] == 2
    geometry = ("seq_len", "batch_rows", "buffer_docs", "shuffle_seed",
                "epoch", "kind")
    assert ({k: states[0]["source"][k] for k in geometry}
            == {k: states[1]["source"][k] for k in geometry})
    # each package resumes from the other's state
    port2, ref2 = _loaders(docs, shuffle_seed=4)
    port2.load_state_dict(states[1])
    ref2.load_state_dict(states[0])
    _same_stream(_np(port2), [jax.tree.map(np.asarray, b) for b in ref2])


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "async-loader"]


def test_async_loader_early_break_leaves_no_thread():
    docs = _docs(10, n=200, hi=40)
    loader = AsyncLoader(PackedDataset(docs, 32, 2, buffer_docs=16),
                         tt.Config(data=tt.DataConfig(prefetch=1)),
                         device="cpu")
    for i, _ in enumerate(loader):
        if i == 1:
            break
    deadline = time.time() + 5
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _loader_threads()
    assert loader.state_dict()["batches_consumed"] == 2


def test_async_loader_raises_on_a_failing_source_and_without_a_card():
    def bad():
        yield {"input_ids": np.zeros((2, 8), np.int32)}
        raise OSError("disk gone")
    assert len(AsyncLoader([{}] * 3, tt.Config(), device="cpu")) == 3
    loader = AsyncLoader(bad(), tt.Config(), device="cpu")
    with pytest.raises(DataLoaderError) as e:
        list(loader)
    assert isinstance(e.value.__cause__, OSError)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncLoader([], tt.Config())
