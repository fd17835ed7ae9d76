"""The training data stream and its SW-AKDE drift monitor
(repro_torch.data.pipeline) against the reference's, on the CPU.

* `TokenStream` batches are bit-identical to the reference's over several
  (seed, shard_id) pairs, with and without a drift point, across
  ``state()`` / ``restore``; `batches` yields the same tokens as tensors;
* the `DriftMonitor`, given the reference's SRP params, feeds each batch as
  one chunk where the reference feeds its examples one by one: after every
  batch of a 24-batch stream with a drift at batch 12 (window 64 examples,
  so the window expires) the SW-AKDE state (``ts``, ``num``, ``t``) is
  bit-identical to the reference's, the density and z-score equal within
  1e-6 relative (both read the same integer cells; only the float mean may
  round differently), and the drift and near-duplicate flags are equal.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch import convert
from repro_torch.data import pipeline as tpipe

from torch_parity import assert_state_equal, fields


@pytest.mark.parametrize("seed,shard_id,drift_at", [(0, 0, None), (3, 1, 2),
                                                   (11, 2, 0)])
def test_token_stream_matches_reference(seed, shard_id, drift_at):
    kw = dict(vocab=509, batch=3, seq=17, seed=seed, n_shards=3,
              shard_id=shard_id)
    ours = tpipe.TokenStream(tpipe.DataConfig(**kw), drift_at=drift_at)
    ref = jpipe.TokenStream(jpipe.DataConfig(**kw), drift_at=drift_at)
    for _ in range(4):
        a, b = ours.next_batch(), ref.next_batch()
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    saved = ours.state()
    assert saved == ref.state()
    after = [ours.next_batch() for _ in range(2)]
    resumed = tpipe.TokenStream(tpipe.DataConfig(**kw), drift_at=drift_at)
    resumed.restore({"i": torch.tensor(saved["i"])})
    for want in after:
        np.testing.assert_array_equal(resumed.next_batch(), want)
    it = tpipe.batches(tpipe.DataConfig(**kw), drift_at=drift_at, device="cpu")
    first = next(it)["tokens"]
    assert first.dtype == torch.int32
    np.testing.assert_array_equal(
        first.numpy(),
        jpipe.TokenStream(jpipe.DataConfig(**kw), drift_at=drift_at).next_batch())


def test_drift_monitor_matches_reference_per_example_loop():
    dcfg = dict(vocab=1024, batch=4, seq=32, seed=5, drift_window=64,
                drift_rows=8, drift_width=64)
    ref = jpipe.DriftMonitor(jpipe.DataConfig(**dcfg))
    ours = tpipe.DriftMonitor(
        tpipe.DataConfig(**dcfg), device="cpu",
        params=convert.params_from_numpy(fields(ref.params), "cpu"))
    stream = jpipe.TokenStream(jpipe.DataConfig(**dcfg), drift_at=12)
    flags = []
    for i in range(24):
        toks = stream.next_batch()
        want = ref.observe(toks)
        got = ours.observe(toks)
        assert_state_equal(ours.state, ref.state)
        for k in ("density", "z"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"batch {i}: {k}")
        assert got["drift"] == want["drift"], i
        assert got["dup_flood"] == want["dup_flood"], i
        flags.append(got["drift"])
    assert int(ours.state.t) == 24 * dcfg["batch"]
    assert any(flags[12:]) and not any(flags[:12])
