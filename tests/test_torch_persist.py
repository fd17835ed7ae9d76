"""Durability parity of the port (repro_torch.persist, repro_torch.checkpoint)
with the reference's persist and checkpoint packages, on the CPU.

* WAL: each package replays the other's log — every record's seq, kind,
  array names, dtypes and values equal — across segment rotation; a torn
  tail (an injected crash mid-append) ends both packages' replays at the
  same record, and the port truncates it and compacts sealed segments.
* Checkpoints: the port saves and the reference restores, and the other way
  round, for S-ANN, RACE and SW-AKDE states: keys, numpy dtype names and
  values equal.
* Faults: one `FaultPlan` fires at the same site strings, the same number
  of times, in both packages' WALs; `seeded_plan` draws the same specs.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import race as jrace
from repro.core import sann as jsann
from repro.core import swakde as jswakde
from repro.persist import faults as jfaults
from repro.persist import snapshot as jsnapshot
from repro.persist.wal import WriteAheadLog as JWAL
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import race as trace
from repro_torch.core import sann as tsann
from repro_torch.core import swakde as tswakde
from repro_torch.persist import faults as tfaults
from repro_torch.persist import snapshot as tsnapshot
from repro_torch.persist.wal import (KIND_CHUNK, KIND_CLOCK, KIND_DELETE,
                                     WriteAheadLog as TWAL)

WALS = {"port": TWAL, "reference": JWAL}
FAULTS = {"port": tfaults, "reference": jfaults}


def _records(seed=0):
    """Chunks, a delete and a clock advance, as the services log them."""
    rng = np.random.default_rng(seed)
    recs = [(i, KIND_CHUNK, {"xs": rng.normal(size=(16, 8)).astype(np.float32)})
            for i in range(5)]
    recs.append((5, KIND_DELETE, {"x": rng.normal(size=8).astype(np.float32)}))
    recs.append((6, KIND_CLOCK, {"t": np.asarray(123, np.int32)}))
    return recs


def _write(wal_cls, root, recs):
    wal = wal_cls(root)
    for j, rec in enumerate(recs):
        wal.append([rec])
        if j in (1, 3):
            wal.rotate()        # three segments
    wal.close()


def _assert_records_equal(got, want):
    assert [(r.seq, r.kind) for r in got] == [(s, k) for s, k, _ in want]
    for r, (_, _, arrays) in zip(got, want):
        assert sorted(r.arrays) == sorted(arrays)
        for name, a in arrays.items():
            assert r.arrays[name].dtype == a.dtype, name
            np.testing.assert_array_equal(r.arrays[name], a)


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_wal_each_package_replays_the_others_log(tmp_path, writer, reader):
    recs = _records()
    _write(WALS[writer], tmp_path, recs)
    assert len(list(tmp_path.glob("wal_*.log"))) == 3
    wal = WALS[reader](tmp_path)
    _assert_records_equal(wal.replay(), recs)
    _assert_records_equal(list(wal.iter_replay(after=4)), recs[5:])
    wal.close()


def test_wal_torn_tail_is_read_alike_then_truncated_and_compacted(tmp_path):
    """A crash mid-append (``torn_tail`` at the port's ``wal.append``)
    leaves a half record: both packages replay the intact prefix; the port
    truncates the garbage, appends after it, and compacts the sealed
    segments a snapshot covers."""
    recs = _records(1)
    wal = TWAL(tmp_path)
    wal.append(recs[:2])
    wal.rotate()
    wal.append(recs[2:4])
    plan = tfaults.FaultPlan([tfaults.FaultSpec("wal.append", "torn_tail",
                                                hit=2)])
    with tfaults.installed(plan):
        wal.append([recs[4]])
        with pytest.raises(tfaults.FaultError):
            wal.append([recs[5]])
    wal.close()
    assert plan.fired == [{"site": "wal.append", "hit": 2, "mode": "torn_tail"}]
    _assert_records_equal(JWAL(tmp_path).replay(), recs[:5])
    wal = TWAL(tmp_path)
    _assert_records_equal(wal.replay(), recs[:5])
    wal.truncate_torn_tail()
    wal.append([recs[5]])
    _assert_records_equal(JWAL(tmp_path).replay(), recs[:6])
    wal.rotate()
    assert wal.compact(upto=1) == 1            # the segment of seqs 0-1
    _assert_records_equal(wal.replay(), recs[2:6])
    _assert_records_equal(JWAL(tmp_path).replay(), recs[2:6])
    assert wal.compact(upto=5) == 1            # seqs 2-5; the active stays
    assert not wal.has_records()
    wal.close()


def _np_states(seed=0):
    """S-ANN, RACE and SW-AKDE states of small configs with random leaves,
    as dicts of numpy arrays (shapes and dtypes of each package's init)."""
    rng = np.random.default_rng(seed)
    scfg = tsann.SANNConfig(dim=8, n_max=400, eta=0.3, r=3.0, c=1.5, L=4, k=2,
                            bucket_cap=4).resolved()
    sann = {k: v.numpy() for k, v in
            tsann.sann_empty_state(scfg, "cpu")._asdict().items()}
    race = {k: v.numpy() for k, v in trace.race_init(4, 16, "cpu")._asdict().items()}
    wcfg = tswakde.SWAKDEConfig(L=3, W=8, window=100, eh_eps=0.2)
    sw = {k: v.numpy() for k, v in
          tswakde.swakde_init(wcfg, "cpu")._asdict().items()}
    out = {}
    for name, d in (("sann", sann), ("race", race), ("swakde", sw)):
        filled = {}
        for k, v in d.items():
            if v.dtype == np.bool_:
                filled[k] = rng.random(v.shape) < 0.5
            elif v.dtype == np.float32:
                filled[k] = rng.normal(size=v.shape).astype(np.float32)
            else:
                filled[k] = rng.integers(-1, 1000, size=v.shape).astype(v.dtype)
        out[name] = filled
    return out


_CLASSES = {"sann": (tsann.SANNState, jsann.SANNState),
            "race": (trace.RACEState, jrace.RACEState),
            "swakde": (tswakde.SWAKDEState, jswakde.SWAKDEState)}


@pytest.mark.parametrize("kind", ["sann", "race", "swakde"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_each_package_restores_the_others(tmp_path, kind, writer):
    arrays = _np_states()[kind]
    tcls, jcls = _CLASSES[kind]
    port = tcls(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    ref = jcls(**{k: jnp.asarray(v) for k, v in arrays.items()})
    if writer == "port":
        tsnapshot.save(tmp_path, 7, port)
        got = jsnapshot.load(tmp_path, 7, jcls(*ref))
    else:
        jsnapshot.save(tmp_path, 7, ref)
        got = tsnapshot.load(tmp_path, 7, port, device="cpu")
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["keys"] == [f"state/{f}" for f in tcls._fields]
    assert manifest["dtypes"] == [str(v.dtype) for v in arrays.values()]
    assert manifest["step"] == 7 and tsnapshot.latest_seq(tmp_path) == 7
    assert type(got) is (jcls if writer == "port" else tcls)
    for f, v in arrays.items():
        g = np.asarray(getattr(got, f))
        assert g.dtype == v.dtype and g.shape == v.shape, f
        np.testing.assert_array_equal(g, v, err_msg=f)


def test_checkpoint_keys_follow_the_reference_flattening(tmp_path):
    """Nested dicts (keys sorted), NamedTuples (field names), lists and
    tuples (indices) and None (no leaf) give the reference's key strings;
    bfloat16 is stored widened and restored narrow; the async writer gives
    the same files."""
    st = trace.RACEState(counts=torch.arange(6, dtype=torch.int32).reshape(2, 3),
                         n=torch.tensor(5, dtype=torch.int32))
    tree = {"b": [st, None, (torch.ones(2, dtype=torch.bfloat16),)],
            "a": torch.zeros(3)}
    tckpt.save(tmp_path / "sync", tree, step=3)
    ack = tckpt.AsyncCheckpointer()
    ack.save(tmp_path / "async", tree, step=3)
    ack.wait()
    jtree = {"b": [jrace.RACEState(counts=jnp.zeros((2, 3), jnp.int32),
                                   n=jnp.int32(0)), None,
                   (jnp.zeros(2, jnp.bfloat16),)], "a": jnp.ones(3)}
    for d in ("sync", "async"):
        m = json.loads((tmp_path / d / "manifest.json").read_text())
        assert m["keys"] == ["a", "b/0/counts", "b/0/n", "b/2/0"]
        assert m["dtypes"] == ["float32", "int32", "int32", "bfloat16"]
        got, step = jckpt.restore(tmp_path / d, jtree)
        assert step == 3
        np.testing.assert_array_equal(np.asarray(got["b"][0].counts),
                                      st.counts.numpy())
        assert got["b"][2][0].dtype == jnp.bfloat16
    back, _ = tckpt.restore(tmp_path / "sync", tree, device="cpu")
    assert back["b"][1] is None and back["b"][2][0].dtype == torch.bfloat16
    assert torch.equal(back["b"][0].counts, st.counts)
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore(tmp_path / "sync", {"a": torch.zeros(3)}, device="cpu")


def _wal_workload(pkg, root):
    wal = WALS[pkg](root, fault_scope="worker_1/")
    recs = _records(2)
    wal.append(recs[:3])
    wal.rotate()
    wal.append(recs[3:5])
    wal.rotate()
    wal.compact(upto=2)
    wal.close()


def test_fault_plan_fires_at_the_same_sites_in_both_packages(tmp_path):
    specs = [("worker_1/wal.rotate", "crash", 2, 1, False),
             ("*/wal.append", "delay", 1, 5, False)]
    hits, fired = {}, {}
    for pkg in ("port", "reference"):
        f = FAULTS[pkg]
        plan = f.FaultPlan([f.FaultSpec(s, m, hit=h, count=c, transient=t)
                            for s, m, h, c, t in specs])
        with f.installed(plan):
            with pytest.raises(f.FaultError, match="worker_1/wal.rotate"):
                _wal_workload(pkg, tmp_path / pkg)
        hits[pkg], fired[pkg] = plan.hits, plan.fired
        assert f.is_transient(f.InjectedIOError("x", transient=True))
    assert hits["port"] == hits["reference"] == {
        "worker_1/wal.append": 2, "worker_1/wal.rotate": 2}
    assert fired["port"] == fired["reference"]
    a = tfaults.seeded_plan(7, ["worker_0/", "worker_1/", ""])
    b = jfaults.seeded_plan(7, ["worker_0/", "worker_1/", ""])
    assert a.report()["specs"] == b.report()["specs"]
