"""The port's real-data pipeline (kubeflow_tpu_torch/training/
datasets.py, native/shard_prefetch.py) against the JAX package's on the
CPU: every batch, permutation, split, mask and decoded array equal bit
for bit (both are numpy), over the cases of the reference's
`test_datasets.py`; the native shard reader built from native/
shard_loader/ yields the JAX reader's (path, bytes) sequence, and so does
its Python fallback."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu.config.platform import (  # noqa: E402
    DataConfig as JDataConfig,
    TrainingConfig as JTrainingConfig,
)
from kubeflow_tpu.native.shard_prefetch import (  # noqa: E402
    ShardPrefetcher as JShardPrefetcher,
)
from kubeflow_tpu.training import datasets as jds  # noqa: E402
from kubeflow_tpu.training.tasks import (  # noqa: E402
    ImageClassificationTask as JImageTask,
)
from kubeflow_tpu_torch.config.platform import TrainingConfig  # noqa: E402
from kubeflow_tpu_torch.native import shard_prefetch  # noqa: E402
from kubeflow_tpu_torch.training import datasets as ds  # noqa: E402
from kubeflow_tpu_torch.training.tasks import (  # noqa: E402
    CausalLmTask,
    ImageClassificationTask,
)


def arrays(n=37, size=4, seed=0, uint8=False):
    rng = np.random.default_rng(seed)
    image = (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) if uint8
             else rng.standard_normal((n, size, size, 3)).astype(np.float32))
    return {"image": image, "label": rng.integers(0, 10, (n,)).astype(np.int32)}


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("uint8", [False, True])
def test_array_dataset_batches_equal(shuffle, uint8):
    a = arrays(uint8=uint8)
    port = ds.ArrayDataset(a, 8, seed=3, shuffle=shuffle)
    ref = jds.ArrayDataset(a, 8, seed=3, shuffle=shuffle)
    assert port.steps_per_epoch == ref.steps_per_epoch == 4
    for step in (0, 1, 3, 4, 5, 11, 40):
        assert_batches_equal(port.batch_at(step), ref.batch_at(step))
        lazy = {k: np.asarray(v) for k, v in port.lazy_batch_at(step).items()}
        assert_batches_equal(lazy, ref.batch_at(step))


@pytest.mark.parametrize("batch_size,pad", [(8, 1), (8, 3), (5, 4), (37, 1)])
def test_eval_batches_pad_and_mask_equal(batch_size, pad):
    a = arrays(uint8=True)
    port = list(ds.ArrayDataset(a, 4).eval_batches(batch_size, pad))
    ref = list(jds.ArrayDataset(a, 4).eval_batches(batch_size, pad))
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert_batches_equal(p, r)
    assert sum(b[ds.EVAL_MASK].sum() for b in port) == 37


@pytest.mark.parametrize("kwargs", [dict(arrays={"a": np.zeros(4),
                                                 "b": np.zeros(5)}),
                                    dict(arrays={"a": np.zeros(4)}),
                                    dict(arrays={})])
def test_rejects_ragged_small_and_empty_alike(kwargs):
    for mod in (ds, jds):
        with pytest.raises(ValueError):
            mod.ArrayDataset(kwargs["arrays"], 8)


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5])
def test_split_eval_equal(fraction):
    a = arrays(n=50)
    (pt, pe), (rt, re) = ds.split_eval(a, fraction, 7), jds.split_eval(
        a, fraction, 7)
    assert_batches_equal(pt, rt)
    assert_batches_equal(pe, re)


@pytest.mark.parametrize("n,size,classes,seed", [(64, 8, 10, 0),
                                                 (100, 32, 3, 5)])
def test_make_blobs_equal(n, size, classes, seed):
    assert_batches_equal(ds.make_blobs(n, size, classes, seed),
                         jds.make_blobs(n, size, classes, seed))


def _write_shards(root, a, prefix, count):
    per = -(-len(a["label"]) // count)
    for i in range(count):
        np.savez(os.path.join(root, f"{prefix}-{i}.npz"),
                 **{k: v[i * per:(i + 1) * per] for k, v in a.items()})


def test_load_npz_shards_and_single_file_equal(tmp_path):
    a = arrays(n=40, uint8=True)
    _write_shards(tmp_path, a, "train", 3)
    _write_shards(tmp_path, arrays(n=9, seed=1), "val", 1)
    for split in ("train", "val"):
        assert_batches_equal(ds.load_npz(str(tmp_path), split),
                             jds.load_npz(str(tmp_path), split))
    single = os.path.join(tmp_path, "train-0.npz")
    assert_batches_equal(ds.load_npz(single), jds.load_npz(single))
    assert ds.load_npz(single, "val") is jds.load_npz(single, "val") is None


def test_load_npy_mmap_lazy_uint8_and_lazy_split_equal(tmp_path):
    a = arrays(n=30, uint8=True)
    for k, v in a.items():
        np.save(os.path.join(tmp_path, f"train_{k}.npy"), v)
    port, ref = (ds.load_npy_mmap(str(tmp_path)),
                 jds.load_npy_mmap(str(tmp_path)))
    assert isinstance(port["image"], np.memmap)
    pt, pe = ds.split_eval(port, 0.2, 1)
    rt, re = jds.split_eval(ref, 0.2, 1)
    assert not isinstance(pt["image"], np.ndarray)
    for p, r in ((pt, rt), (pe, re)):
        for step in range(4):
            assert_batches_equal(ds.ArrayDataset(p, 4, seed=2).batch_at(step),
                                 jds.ArrayDataset(r, 4, seed=2).batch_at(step))
    assert ds.load_npy_mmap(str(tmp_path), "val") is None
    assert ds.load_npy_mmap(str(tmp_path / "nope")) is None


DATA_CASES = [
    dict(name="blobs", num_examples=200, eval_fraction=0.2),
    dict(name="blobs", num_examples=128, shuffle=False),
    dict(name="npz", eval_every_steps=5),
    dict(name="npz", eval_fraction=0.25, target_accuracy=0.5, mmap_train=True),
    dict(name="npz", eval_batch_size=500, no_val=True, eval_fraction=0.1),
]


@pytest.mark.parametrize("case", DATA_CASES, ids=[str(c) for c in DATA_CASES])
def test_build_data_equal(case, tmp_path):
    case = dict(case)
    no_val, mmap = case.pop("no_val", False), case.pop("mmap_train", False)
    if case["name"] == "npz":
        case["path"] = str(tmp_path)
        train = arrays(n=64, size=8, uint8=True)
        if mmap:
            for k, v in train.items():
                np.save(os.path.join(tmp_path, f"train_{k}.npy"), v)
        else:
            _write_shards(tmp_path, train, "train", 2)
        if not no_val and not case.get("eval_fraction"):
            _write_shards(tmp_path, arrays(n=21, size=8, seed=4), "val", 1)
    common = dict(model="mlp", global_batch_size=16, seed=3)
    cfg = TrainingConfig(**common, data=case)
    jcfg = JTrainingConfig(**common, data=JDataConfig(**case))
    port, port_eval = ds.build_data(cfg, ImageClassificationTask(
        cfg, image_size=8, num_classes=10))
    ref, ref_eval = jds.build_data(jcfg, JImageTask(jcfg, image_size=8,
                                                    num_classes=10))
    for step in range(6):
        assert_batches_equal(port.batch_at(step), ref.batch_at(step))
    assert (port_eval is None) == (ref_eval is None)
    if port_eval is not None:
        assert port_eval.global_batch_size == ref_eval.global_batch_size
        for p, r in zip(port_eval.eval_batches(), ref_eval.eval_batches()):
            assert_batches_equal(p, r)


def test_build_data_refusals_equal(tmp_path):
    common = dict(global_batch_size=4)
    cfg = TrainingConfig(model="gpt_tiny", **common, data={"name": "blobs"})
    jcfg = JTrainingConfig(model="gpt_tiny", **common,
                           data=JDataConfig(name="blobs"))
    with pytest.raises(ValueError, match="image-classification"):
        ds.build_data(cfg, CausalLmTask(cfg))
    with pytest.raises(ValueError, match="image-classification"):
        from kubeflow_tpu.training.tasks import CausalLmTask as JCausalLmTask

        jds.build_data(jcfg, JCausalLmTask(jcfg))
    _write_shards(tmp_path, arrays(n=16), "train", 1)
    data = dict(name="npz", path=str(tmp_path), eval_every_steps=2)
    for mod, c in ((ds, TrainingConfig(model="mlp", **common, data=data)),
                   (jds, JTrainingConfig(model="mlp", **common,
                                         data=JDataConfig(**data)))):
        with pytest.raises(FileNotFoundError, match="no val split"):
            mod.build_data(c, None)
    empty = dict(name="npz", path=str(tmp_path / "empty"))
    os.makedirs(empty["path"])
    for mod, c in ((ds, TrainingConfig(model="mlp", **common, data=empty)),
                   (jds, JTrainingConfig(model="mlp", **common,
                                         data=JDataConfig(**empty)))):
        with pytest.raises(FileNotFoundError, match="no train data"):
            mod.build_data(c, None)


def _shards(tmp_path, count=5):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(count):
        p = os.path.join(tmp_path, f"shard-{i}.bin")
        with open(p, "wb") as f:
            f.write(rng.bytes(1000 * (i + 1) + 7))
        paths.append(p)
    return paths


@pytest.mark.parametrize("depth,threads", [(1, 1), (2, 2), (4, 3)])
def test_shard_prefetcher_yields_the_jax_readers_sequence(tmp_path, depth,
                                                         threads):
    paths = _shards(tmp_path)
    with JShardPrefetcher(paths, prefetch_depth=depth,
                          n_threads=threads) as s:
        want = list(s)
    with shard_prefetch.ShardPrefetcher(paths, prefetch_depth=depth,
                                        n_threads=threads) as s:
        assert s.native and shard_prefetch.native_loaded()
        got = list(s)
    assert got == want and [p for p, _ in got] == paths
    with shard_prefetch.ShardPrefetcher(paths, force_python=True) as s:
        assert not s.native
        assert list(s) == want


def test_shard_prefetcher_read_failure_and_double_close(tmp_path):
    paths = _shards(tmp_path, 2) + [os.path.join(tmp_path, "missing.bin")]
    s = shard_prefetch.ShardPrefetcher(paths)
    with pytest.raises(OSError, match="missing.bin"):
        with s:
            list(s)
    s.close()  # idempotent after the error path closed it
    with pytest.raises(RuntimeError, match="with ShardPrefetcher"):
        list(shard_prefetch.ShardPrefetcher(paths[:1]))


def test_shard_loader_builds_apart_from_the_jax_build(tmp_path):
    from kubeflow_tpu_torch.native import build

    path = build.shard_loader_lib_path()
    assert os.path.dirname(path) == build.NATIVE_BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "native_torch"
    assert build.shard_loader_lib_path() == path  # built once, then found
