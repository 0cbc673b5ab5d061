"""training/prefetch.py `DevicePrefetcher` and its use by `Trainer.fit`,
tests/test_prefetch.py's cases on the port (CPU): any `prefetch_depth`
trains on the bitwise-identical batch sequence, worker exceptions
surface in `fit`, and no exit path (normal, early stop, a non-finite
loss, a data error) leaves the worker thread alive."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu.training.data import batch_spec as jbatch_spec  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    DataConfig,
    TrainingConfig,
)
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.training.data import batch_spec, to_device  # noqa: E402
from kubeflow_tpu_torch.training.prefetch import DevicePrefetcher  # noqa: E402
from kubeflow_tpu_torch.training.tasks import ImageClassificationTask  # noqa: E402
from kubeflow_tpu_torch.training.trainer import Trainer  # noqa: E402
from kubeflow_tpu_torch.utils.metrics import (  # noqa: E402
    prefetch_queue_depth_gauge,
)


class HostFed:
    """Strip device_batch_fn so fit takes the host-fed (prefetchable)
    path, exactly like a real dataset (blobs/npz) does."""

    def __init__(self, inner):
        self._inner = inner

    def batch_at(self, step):
        return self._inner.batch_at(step)


def tiny_trainer(depth: int, steps: int = 4, **data_kw) -> Trainer:
    cfg = TrainingConfig(model="mlp", global_batch_size=16, steps=steps,
                         warmup_steps=1, learning_rate=0.01, dtype="float32",
                         checkpoint={"enabled": False},
                         data=DataConfig(prefetch_depth=depth, **data_kw))
    model = get_model("mlp", device="cpu", dtype=torch.float32,
                      in_features=8 * 8 * 3, num_classes=4)
    return Trainer(cfg, model=model, device="cpu",
                   task=ImageClassificationTask(cfg, image_size=8,
                                                num_classes=4))


def nondaemon_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and not t.daemon
            and t is not threading.main_thread()]


class TestDevicePrefetcherUnit:
    def _identity(self, b):
        return b

    def test_in_order_and_identical(self):
        seen = []

        def get_batch(i):
            seen.append(i)
            return {"x": np.full((4,), i, np.int32)}

        with DevicePrefetcher(get_batch, lambda b: to_device(
                b, torch.device("cpu")), 0, 6, depth=2) as pf:
            for i in range(6):
                batch_np, batch_dev = pf.get(i)
                assert batch_np["x"][0] == i
                assert isinstance(batch_dev["x"], torch.Tensor)
                assert batch_dev["x"][0] == i
        assert seen == list(range(6))

    def test_worker_exception_reaches_consumer(self):
        def get_batch(i):
            if i == 2:
                raise ValueError("bad shard")
            return {"x": np.zeros((2,), np.int32)}

        with DevicePrefetcher(get_batch, self._identity, 0, 5, depth=2) as pf:
            pf.get(0)
            pf.get(1)
            with pytest.raises(ValueError, match="bad shard"):
                pf.get(2)

    def test_close_unblocks_full_queue_and_is_idempotent(self):
        pf = DevicePrefetcher(lambda i: {"x": np.zeros((2,), np.int32)},
                              self._identity, 0, 1000, depth=2).start()
        pf.get(0)  # the worker is alive and producing
        pf.close()  # the worker is likely blocked on a full queue: joins
        pf.close()  # a double close is safe
        assert not pf._thread.is_alive()

    def test_depth_zero_rejected(self):
        with pytest.raises(ValueError):
            DevicePrefetcher(lambda i: {}, self._identity, 0, 4, depth=0)

    def test_config_rejects_negative_depth(self):
        with pytest.raises(ConfigError):
            DataConfig(prefetch_depth=-1).validate()

    def test_queue_depth_gauge_follows_the_queue(self):
        gauge = prefetch_queue_depth_gauge()
        pf = DevicePrefetcher(lambda i: {"x": np.zeros((2,), np.int32)},
                              self._identity, 0, 3, depth=2,
                              model_label="gauge-test").start()
        pf.get(0)
        assert 0 <= gauge.value(model="gauge-test") <= 2
        pf.close()
        assert gauge.value(model="gauge-test") == 0


class TestBatchLayout:
    def test_batch_spec_is_the_references(self):
        batch = {"image": np.zeros((16, 4)), "label": np.zeros((16,))}
        assert batch_spec(batch) == {k: tuple(v) for k, v in
                                     jbatch_spec(batch).items()}

    def test_assemble_gives_the_trainers_device_batch(self):
        b = {"x": np.arange(6, dtype=np.int32).reshape(3, 2),
             "y": np.ones((3,), np.float64)}
        out = to_device(b, torch.device("cpu"))
        assert out["x"].dtype == torch.int64 and out["y"].dtype == torch.float32
        assert out["x"].tolist() == b["x"].tolist()


class TestFitWithPrefetch:
    def _run(self, depth: int, steps: int = 4):
        tr = tiny_trainer(depth, steps=steps)
        data = HostFed(tr.task.synthetic_data())
        losses = []
        orig = tr.train_step

        def spy(state, batch):
            state, metrics = orig(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics

        tr.train_step = spy
        final = tr.fit(steps=steps, data=data, log_every=1)
        return losses, final

    def test_identical_trajectory_and_final_step_across_depths(self):
        # per-step losses BITWISE identical: the prefetcher changes when
        # batches are made, never what they are
        losses0, final0 = self._run(depth=0)
        losses2, final2 = self._run(depth=2)
        assert losses0 == losses2
        assert final0.step == final2.step == 4
        assert final0.loss == final2.loss

    def test_no_nondaemon_thread_survives_fit(self):
        before = set(nondaemon_threads())
        self._run(depth=2)
        assert set(nondaemon_threads()) <= before

    def test_data_exception_propagates_and_cleans_up(self):
        tr = tiny_trainer(2)

        class Exploding(HostFed):
            def batch_at(self, step):
                if step >= 2:
                    raise OSError("disk gone")
                return super().batch_at(step)

        before = set(nondaemon_threads())
        with pytest.raises(OSError, match="disk gone"):
            tr.fit(steps=4, data=Exploding(tr.task.synthetic_data()))
        assert set(nondaemon_threads()) <= before

    def test_nonfinite_loss_exit_cleans_up(self):
        tr = tiny_trainer(2, steps=2)

        class NanData(HostFed):
            def batch_at(self, step):
                b = super().batch_at(step)
                b["image"] = np.full_like(b["image"], np.nan)
                return b

        before = set(nondaemon_threads())
        with pytest.raises(FloatingPointError):
            tr.fit(steps=2, data=NanData(tr.task.synthetic_data()),
                   log_every=1)
        assert set(nondaemon_threads()) <= before

    def test_early_stop_exit_cleans_up(self):
        # blobs + eval every step + a target any classifier clears at
        # once: fit breaks out mid-range with batches still queued
        tr = tiny_trainer(2, steps=6, name="blobs", num_examples=64,
                          eval_fraction=0.5, eval_every_steps=1,
                          target_accuracy=1e-4)
        before = set(nondaemon_threads())
        final = tr.fit(steps=6, log_every=1)
        assert final.step < 6  # actually stopped early
        assert final.aux["eval_top1"] >= 1e-4
        assert set(nondaemon_threads()) <= before

    def test_resume_replays_identical_batches(self):
        # index-keyed determinism: a fit starting from a restored step
        # sees the batches the uninterrupted run saw
        tr = tiny_trainer(2, steps=4)
        data = HostFed(tr.task.synthetic_data())
        tr.fit(steps=2, data=data, log_every=1)
        mid_state = tr._final_state
        assert mid_state.step == 2
        seen = []

        class Recording(HostFed):
            def batch_at(self, step):
                seen.append(step)
                return super().batch_at(step)

        tr.fit(steps=2, data=Recording(tr.task.synthetic_data()),
               state=mid_state, log_every=1)
        assert seen == [2, 3]

    def test_depth_zero_reads_in_the_loop_thread(self):
        tr = tiny_trainer(0, steps=2)
        threads = set()

        class Where(HostFed):
            def batch_at(self, step):
                threads.add(threading.current_thread().name)
                return super().batch_at(step)

        tr.fit(steps=2, data=Where(tr.task.synthetic_data()), log_every=1)
        assert threads == {threading.current_thread().name}
        tr = tiny_trainer(2, steps=2)
        threads.clear()
        tr.fit(steps=2, data=Where(tr.task.synthetic_data()), log_every=1)
        assert threads == {"device-prefetcher"}
