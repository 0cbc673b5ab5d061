"""Checkpoints of the port's data-parallel gang (checkpointing/manager.py
under torch.distributed), on the CPU over gloo in f32.

- Rank 0 alone writes and commits a gang's checkpoint (the other rank
  writes no byte), and the manifest records the gang's process count.
- A 2-rank gang's step-2 checkpoint resumes in the port at world 1 and
  in the JAX package on a `data: 4` mesh: the step-3 loss equals the
  gang's within rel 1e-5 (f32 summation order across frameworks and
  layouts).
- A JAX `data: 4` checkpoint (the small ResNet: SGD momentum and
  BatchNorm statistics) resumes in a 2-rank gang: its step-3 loss
  equals the JAX trainer's within rel 1e-5.
- A 2-rank gang preempted after its step-2 save (every rank stops at
  that step) resumes bit for bit: the losses of steps 3-4, the final
  weights and every file of the step-4 checkpoint equal an uninterrupted
  gang's, with dropout on.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kubeflow_tpu.checkpointing import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from kubeflow_tpu.training.data import make_global_batch  # noqa: E402
from kubeflow_tpu.training.datasets import build_data as jbuild_data  # noqa: E402
from kubeflow_tpu_torch.checkpointing import layout  # noqa: E402
from test_torch_data_parallel import (  # noqa: E402
    LOSS_REL,
    RUNS,
    cfg_dict,
    data_cfg,
    jax_trainer,
    losses_of,
    run_alone,
    run_gang,
    task_kw,
)


def _job(name, data, ckpt, world, steps=3, **extra):
    return {"cfg": cfg_dict(name, data, steps=steps, mesh={"data": world},
                            checkpoint={"directory": ckpt, "interval_steps": 2,
                                        "keep": 10}),
            "model_kw": extra.pop("model_kw", RUNS[name][1]),
            "task_kw": task_kw(name), **extra}


def _only_step(src, dst, step):
    """A copy of checkpoint dir `src` holding only `step`."""
    shutil.copytree(src, dst)
    for s in layout.committed_steps(dst):
        if s != step:
            shutil.rmtree(layout.step_dir(dst, s))
    return dst


def test_rank_0_writes_and_the_checkpoint_crosses_sizes_and_packages(
        devices8, tmp_path):
    data = data_cfg("gpt_tiny", str(tmp_path / "data"))
    ckpt = str(tmp_path / "gang")
    outs = run_gang(_job("gpt_tiny", data, ckpt, 2), 2)
    assert outs[0]["ckpt_bytes"] > 0 and outs[1]["ckpt_bytes"] == 0
    assert layout.committed_steps(ckpt) == [2, 3]
    for step in (2, 3):
        manifest = layout.read_manifest(layout.step_dir(ckpt, step))
        assert manifest["process_count"] == 2
    gang_loss3 = losses_of(outs[0])[2]

    # the port at world 1, from the gang's step 2
    alone = run_alone({**_job("gpt_tiny", data, _only_step(
        ckpt, str(tmp_path / "w1"), 2), 1), "restore": True})
    assert [s for s, _ in alone["result"]["losses"]] == [3]
    np.testing.assert_allclose(losses_of(alone), [gang_loss3], rtol=LOSS_REL)

    # the JAX package on data: 4, from the same step
    jtr, mesh = jax_trainer("gpt_tiny", data, devices8)
    state = JCheckpointManager(ckpt).restore(jtr.init_state(), step=2)
    assert int(jax.device_get(state.step)) == 2
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    _, m = jtr.train_step(state, make_global_batch(train.batch_at(2), mesh),
                          jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(m["loss"]), gang_loss3, rtol=LOSS_REL)


def test_a_jax_data_4_checkpoint_resumes_in_a_port_gang(devices8, tmp_path):
    data = data_cfg("resnet18", None)
    jtr, mesh = jax_trainer("resnet18", data, devices8)
    state = jtr.init_state()
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    ckpt = str(tmp_path / "jax")
    for i in range(3):
        state, m = jtr.train_step(state, make_global_batch(train.batch_at(i),
                                                           mesh),
                                  jax.random.PRNGKey(1))
        if i == 1:
            with JCheckpointManager(ckpt, async_save=False) as mgr:
                mgr.save(2, state)
    outs = run_gang({**_job("resnet18", data, ckpt, 2), "restore": True}, 2)
    for o in outs:
        assert [s for s, _ in o["result"]["losses"]] == [3]
        np.testing.assert_allclose(losses_of(o), [float(m["loss"])],
                                   rtol=LOSS_REL)


def test_a_preempted_gang_resumes_bit_for_bit(tmp_path):
    data = data_cfg("gpt_tiny", str(tmp_path / "data"))
    drop = {"dropout_rate": 0.1}
    whole_dir, cut_dir = str(tmp_path / "whole"), str(tmp_path / "cut")
    whole = run_gang(_job("gpt_tiny", data, whole_dir, 2, steps=4,
                          model_kw=drop, out=str(tmp_path / "whole.npz")), 2)
    cut = run_gang(_job("gpt_tiny", data, cut_dir, 2, steps=4,
                        model_kw=drop, stop_after=2), 2)
    for o in cut:
        assert o["result"]["preempted"] and o["result"]["final_step"] == 2
    assert layout.committed_steps(cut_dir) == [2]
    resumed = run_gang(_job("gpt_tiny", data, cut_dir, 2, steps=4,
                            model_kw=drop, restore=True,
                            out=str(tmp_path / "resumed.npz")), 2)
    for o in resumed:
        assert o["result"]["losses"] == whole[0]["result"]["losses"][2:]
    assert cut[0]["result"]["losses"] == whole[0]["result"]["losses"][:2]
    got = np.load(str(tmp_path / "resumed.npz"))
    want = np.load(str(tmp_path / "whole.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert np.array_equal(got[k], want[k]), k
    a, b = layout.step_dir(whole_dir, 4), layout.step_dir(cut_dir, 4)
    files = sorted(f for f in os.listdir(a) if f.endswith(".bin"))
    assert files and files == sorted(f for f in os.listdir(b)
                                     if f.endswith(".bin"))
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert mismatch == [] and errors == []
