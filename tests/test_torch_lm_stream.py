"""The causal-LM stream made on the device (training/data.py
`SyntheticData.device_batch_fn` for "lm") and the rows a data-parallel
rank keeps (`local_rows`, `shard_batch`).

Parity contract (d): JAX draws the stream with threefry and the port with
torch's generator, so the two streams are held by their law, not their
bits: ids uniform over [0, vocab) (a chi-square test at p = 1e-4 over
the vocabulary, and over (id mod 7) across positions), an all-ones
mask, int64 as `to_device` gives host batches, and a pure function of
(seed, step)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from scipy import stats  # noqa: E402

from kubeflow_tpu.training.data import SyntheticData as JSyntheticData  # noqa: E402
from kubeflow_tpu_torch.training.data import (  # noqa: E402
    SyntheticData,
    local_rows,
    row_indices,
    shard_batch,
)

B, S, V = 64, 128, 97


def _fn(seed=0, batch=B, seq=S, vocab=V):
    return SyntheticData("lm", batch, seed=seed, seq_len=seq,
                         vocab_size=vocab).device_batch_fn("cpu")


def test_deterministic_by_seed_and_step():
    fn = _fn(seed=3)
    a = fn(5)
    for k, t in fn(5).items():
        assert torch.equal(t, a[k])
    assert torch.equal(_fn(seed=3)(5)["input_ids"], a["input_ids"])
    assert not torch.equal(fn(6)["input_ids"], a["input_ids"])
    assert not torch.equal(_fn(seed=4)(5)["input_ids"], a["input_ids"])


def test_dtype_range_shape_and_all_ones_mask():
    batch = _fn()(0)
    assert set(batch) == set(JSyntheticData("lm", 2, seq_len=4,
                                            vocab_size=V).batch_at(0))
    ids, mask = batch["input_ids"], batch["attention_mask"]
    assert ids.shape == mask.shape == (B, S)
    assert ids.dtype == mask.dtype == torch.int64
    assert int(ids.min()) >= 0 and int(ids.max()) < V
    assert bool((mask == 1).all())
    # both ends of V are reached
    assert int(ids.min()) == 0 and int(ids.max()) == V - 1


@pytest.mark.parametrize("step", [0, 1, 7])
def test_ids_are_uniform_over_the_vocabulary(step):
    ids = _fn(seed=11)(step)["input_ids"].numpy()
    counts = np.bincount(ids.ravel(), minlength=V)
    _, p = stats.chisquare(counts)
    assert p > 1e-4, p
    # and no position pattern: (id mod 7) is uniform-like at every 8th
    # position as well
    sub = ids[:, ::8].ravel() % 7
    expected = np.bincount(np.arange(V) % 7, minlength=7) / V * sub.size
    _, p = stats.chisquare(np.bincount(sub, minlength=7), expected)
    assert p > 1e-4, p


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("accum", [1, 2])
def test_a_ranks_rows_are_the_world_1_rows(world, accum):
    batch = _fn()(3)
    got = [shard_batch(batch, local_rows(B, r, world, accum))
           for r in range(world)]
    for r, part in enumerate(got):
        idx = torch.from_numpy(row_indices(local_rows(B, r, world, accum)))
        for k in batch:
            assert torch.equal(part[k], batch[k][idx])
            assert part[k].shape[0] == B // world
    # every row once across the ranks
    rows = np.concatenate([row_indices(local_rows(B, r, world, accum))
                           for r in range(world)])
    assert sorted(rows.tolist()) == list(range(B))
    if accum > 1:
        # microbatch i of every rank is its share of global microbatch i
        micro, share = B // accum, B // accum // world
        r1 = row_indices(local_rows(B, 1 % world, world, accum))
        assert r1[share:2 * share].tolist() == list(
            range(micro + (1 % world) * share, micro + (1 % world + 1) * share))


def test_host_rows_are_the_same_rows():
    data = SyntheticData("lm", 8, seq_len=16, vocab_size=V)
    host = data.batch_at(2)
    part = shard_batch(host, local_rows(8, 1, 2))
    np.testing.assert_array_equal(part["input_ids"], host["input_ids"][4:])


def test_an_indivisible_batch_is_refused():
    with pytest.raises(ValueError, match="not divisible"):
        local_rows(6, 0, 4)
