"""PyTorch port: the sharded data pipeline (`horovod_tpu_torch.data`)
against the JAX package's `horovod_tpu.data`.

The same shard files, seed, world and rank go through both packages:
the shuffle permutation, the resize remainder, token packing and every
batch of `ShardedDataset`'s stream must be bitwise equal, for the
port's native loader (``csrc/data_loader.cc``, built with the host's
``c++``) and its Python reader alike, mid-epoch restarts, cursor
snapshots, world migration and in-place rebalance included. Inputs come
from numpy with a seed; tolerance: none (bitwise).
"""

import numpy as np
import pytest

from horovod_tpu import data as jd
from horovod_tpu.runtime.config import config as j_config
from horovod_tpu_torch import data as td
from horovod_tpu_torch.runtime import config as t_config_mod
from horovod_tpu_torch.runtime.config import config as t_config

SPEC = [("x", "float32", (3,)), ("y", "int32", ())]
LOADERS = ["native", "python"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """57 records over 5 shards (uneven: 12 or 11 a shard), written by
    the JAX package; the port reads the same files."""
    d = tmp_path_factory.mktemp("shards")
    rs = np.random.RandomState(0)
    arrays = {"x": rs.randn(57, 3).astype(np.float32),
              "y": np.arange(57, dtype=np.int32)}
    return jd.write_shards(str(d), "t", SPEC, arrays, 5)


def _port_ds(paths, loader, monkeypatch, **kw):
    monkeypatch.setattr(t_config, "use_native", loader == "native")
    ds = td.ShardedDataset(paths, SPEC, **kw)
    assert ds.native == (loader == "native")
    return ds


def _jax_ds(paths, monkeypatch, **kw):
    monkeypatch.setattr(j_config, "use_native", False)
    return jd.ShardedDataset(paths, SPEC, **kw)


def _stream(ds, epoch, start_batch=0):
    return [{k: v.copy() for k, v in b.items()}
            for b in ds.epoch(epoch, start_batch=start_batch)]


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert sorted(ba) == sorted(bb)
        for k in ba:
            assert ba[k].dtype == bb[k].dtype
            np.testing.assert_array_equal(ba[k], bb[k])


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (57, 3, 2),
                                          (1000, 9, 1), (64, 2**40, 5)])
def test_shuffle_perm_and_mix64_equal_reference(n, seed, epoch):
    np.testing.assert_array_equal(td.shuffle_perm(n, seed, epoch),
                                  jd.shuffle_perm(n, seed, epoch))
    x = np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(td._mix64(x), jd._mix64(x))


@pytest.mark.parametrize("history,drop", [
    ([(4, 2)], False), ([(4, 2)], True), ([(4, 1), (3, 2)], False),
    ([(2, 3), (5, 0), (3, 1)], True)])
def test_remainder_after_equals_reference(history, drop):
    counts = [12, 12, 11, 11, 11]
    kw = dict(batch_size=4, seed=3, epoch=1, shuffle=True,
              drop_remainder=drop)
    assert (td.remainder_after(counts, history, **kw)
            == jd.remainder_after(counts, history, **kw))


def test_records_and_token_packing_equal_reference(tmp_path):
    rs = np.random.RandomState(1)
    arrays = {"x": rs.randn(7, 3).astype(np.float32),
              "y": rs.randint(0, 9, 7).astype(np.int32)}
    assert td.record_bytes(SPEC) == jd.record_bytes(SPEC)
    buf = td.pack_records(SPEC, arrays)
    assert buf == jd.pack_records(SPEC, arrays)
    got = td.unpack_records(SPEC, np.frombuffer(buf, np.uint8), 7)
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
    docs = [rs.randint(2, 50, rs.randint(1, 40)) for _ in range(30)]
    for eos in (None, 1):
        np.testing.assert_array_equal(
            td.pack_tokens(docs, 16, eos_id=eos),
            jd.pack_tokens(docs, 16, eos_id=eos))
    assert td.lm_spec(16) == jd.lm_spec(16)
    tp = td.write_token_shards(str(tmp_path / "t"), "c", docs, 16, 3,
                               eos_id=1)
    jp = jd.write_token_shards(str(tmp_path / "j"), "c", docs, 16, 3,
                               eos_id=1)
    assert [p.rsplit("/", 1)[1] for p in tp] == [p.rsplit("/", 1)[1]
                                                 for p in jp]
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="no full rows"):
        td.write_token_shards(str(tmp_path / "e"), "c", [[1, 2]], 16, 1)


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("world,shuffle,drop", [
    (1, True, False), (2, True, True), (3, False, False)])
def test_stream_equals_reference(shards, monkeypatch, loader, world,
                                 shuffle, drop):
    """Every rank's epochs 0 and 1, and a mid-epoch restart of epoch 1,
    bitwise the JAX package's stream for the same files and cursor."""
    for rank in range(world):
        kw = dict(batch_size=5, shuffle=shuffle, seed=7, rank=rank,
                  world=world, drop_remainder=drop)
        with _port_ds(shards, loader, monkeypatch, **kw) as ds, \
                _jax_ds(shards, monkeypatch, **kw) as ref:
            assert ds.num_records() == ref.num_records()
            assert ds.steps_per_epoch() == ref.steps_per_epoch()
            for epoch in (0, 1):
                _assert_streams_equal(_stream(ds, epoch),
                                      _stream(ref, epoch))
            _assert_streams_equal(_stream(ds, 1, 2), _stream(ref, 1, 2))
            assert ds.cursor == ref.cursor == (2, 0)


@pytest.mark.parametrize("loader", LOADERS)
def test_state_restore_and_cursor_equal_reference(shards, monkeypatch,
                                                  loader):
    """A cursor cut mid-epoch has the reference's JSON form, and the
    reference's snapshot restores onto the port (and back) to the same
    remaining batches."""
    kw = dict(batch_size=4, shuffle=True, seed=5, rank=1, world=2)
    with _port_ds(shards, loader, monkeypatch, **kw) as ds, \
            _jax_ds(shards, monkeypatch, **kw) as ref:
        it, rit = ds.epoch(1), ref.epoch(1)
        for _ in range(3):
            next(it), next(rit)
        assert ds.state() == ref.state()
        saved = ref.state()
        del it, rit
    with _port_ds(shards, loader, monkeypatch, **kw) as ds2, \
            _jax_ds(shards, monkeypatch, **kw) as ref2:
        ds2.restore(saved)
        ref2.restore(saved)
        assert ds2.cursor == ref2.cursor == (1, 3)
        _assert_streams_equal(_stream(ds2, *ds2.cursor),
                              _stream(ref2, *ref2.cursor))
        with pytest.raises(td.DataStateError, match="migrate=True"):
            ds2.restore(dict(saved, world=3))
        with pytest.raises(td.DataStateError, match="schema"):
            ds2.restore(dict(saved, schema=99))


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("old_world,new_world", [(4, 3), (2, 5)])
def test_migrate_and_rebalance_equal_reference(shards, monkeypatch,
                                               loader, old_world,
                                               new_world):
    """`restore(migrate=True)` of a world-``old_world`` cursor onto each
    rank of ``new_world``, and `rebalance` in place: the same report
    and the same migrated batches as the reference, and a snapshot cut
    mid-migrated-epoch round-trips."""
    kw = dict(batch_size=3, shuffle=True, seed=11)
    with _jax_ds(shards, monkeypatch, rank=0, world=old_world,
                 **kw) as ref:
        it = ref.epoch(0)
        next(it), next(it)
        saved = ref.state()
        del it
    for rank in range(new_world):
        with _port_ds(shards, loader, monkeypatch, rank=rank,
                      world=new_world, **kw) as ds, \
                _jax_ds(shards, monkeypatch, rank=rank, world=new_world,
                        **kw) as r:
            ds.restore(saved, migrate=True)
            r.restore(saved, migrate=True)
            assert ds.last_rebalance == r.last_rebalance
            assert ds.migration == r.migration
            a = ds.epoch(*ds.cursor)
            b = r.epoch(*r.cursor)
            first_a, first_b = next(a, None), next(b, None)
            assert (first_a is None) == (first_b is None)
            mid_a, mid_b = ds.state(), r.state()
            assert mid_a == mid_b
            rest_a, rest_b = list(a), list(b)
            _assert_streams_equal(rest_a, rest_b)
            del a, b
            with _port_ds(shards, loader, monkeypatch, rank=rank,
                          world=new_world, **kw) as again:
                again.restore(mid_a)
                _assert_streams_equal(_stream(again, *again.cursor),
                                      rest_b)
    with _port_ds(shards, loader, monkeypatch, rank=0, world=old_world,
                  **kw) as ds, \
            _jax_ds(shards, monkeypatch, rank=0, world=old_world,
                    **kw) as r:
        for d in (ds, r):
            it = d.epoch(0)
            next(it)
            del it
        assert ds.rebalance(1, new_world) == r.rebalance(1, new_world)
        _assert_streams_equal(_stream(ds, *ds.cursor),
                              _stream(r, *r.cursor))


def test_native_build_failure_warns_and_falls_back(shards, monkeypatch):
    """A native build that fails degrades to the Python reader, loudly;
    HOROVOD_NO_NATIVE selects the Python reader without a warning."""
    from horovod_tpu_torch.ops import _build

    def broken(name):
        raise _build.KernelBuildError("no compiler")
    monkeypatch.setattr(_build, "build_host", broken)
    monkeypatch.setattr(t_config, "use_native", True)
    with pytest.warns(UserWarning, match="falling back to the Python"):
        ds = td.ShardedDataset(shards, SPEC, 4, rank=0, world=1)
    assert not ds.native
    assert sum(len(b["y"]) for b in ds.epoch(0)) == 57
    monkeypatch.setenv("HOROVOD_NO_NATIVE", "1")
    assert t_config.refresh().use_native is False
    knob = t_config_mod.KNOBS["HOROVOD_NO_NATIVE"]
    assert (knob.kind, knob.consumer) == ("flag", "data/__init__.py")
    monkeypatch.delenv("HOROVOD_NO_NATIVE")
    t_config.refresh()


def test_data_read_fail_site_retried(shards):
    """The ``data_read_fail`` chaos site fires on read-mode shard opens
    only, and the shared IO retry policy absorbs one injected fault."""
    from horovod_tpu_torch.resilience import chaos
    with chaos.armed("data_read_fail:1") as monkey:
        td.write_shards(str(shards[0]) + ".w", "w", SPEC,
                        {"x": np.zeros((2, 3), np.float32),
                         "y": np.zeros(2, np.int32)}, 1)
        assert monkey.fired("data_read_fail") == 0
        ds = td.ShardedDataset(shards, SPEC, 8, rank=0, world=1)
        ds._impl = td._PythonLoader(shards, ds._rb, 8, False, 0, 0, 1,
                                    False)
        assert sum(len(b["y"]) for b in ds.epoch(0)) == 57
    assert monkey.fired("data_read_fail") == 1
