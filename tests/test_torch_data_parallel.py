"""The port's data-parallel training (parallel/, the trainer's gang step,
global BatchNorm, the rank's rows of every stream) against the JAX
`Trainer` on a `data: 4` mesh, on the CPU in f32.

A port gang is 2 or 4 processes over gloo (`render_gang_env` on
127.0.0.1, `initialize_from_env(device="cpu")`), each running
`run_training` on its rank (gpt_tiny_moe's too, whose load-balance
loss is the global batch's); the JAX trainer runs on 4 of the conftest's
8 virtual CPU devices. Both start from the JAX trainer's own init: it
saves a step-0 checkpoint, and every rank of the port gang restores it
(`restore=True`). Both read identical batches: blobs (`ArrayDataset`)
for the mlp and the small ResNet, and `.npy` files the test writes for
gpt_tiny (a ragged attention mask, so the ranks hold different
next-token counts) and bert_tiny (its random 15 % masking, dropout 0).

Bounds: losses within rel 1e-5 over three steps (f32: the two
frameworks sum the global batch in different orders, and the port's
gang also sums its ranks' partial sums in gloo's order). Parameters
after step 3 within atol 2e-5 (2 % of the lr of 1e-3 for the AdamW
models, whose per-element step divides out the gradient's own scale,
so summation noise in a tiny gradient element moves its step by a
visible fraction of lr, as tests/test_torch_train.py measured) and,
for the ResNet's SGD (lr 0.05, no normalisation of the step), atol
2e-5 too: its gradients agree to ~1e-6 relative, far below that once
multiplied by lr. The BatchNorm running averages agree within 1e-5 of
their largest magnitude. An attention key bias is not compared: softmax
is invariant to a shift of a query's scores, so its true gradient is 0
and its computed gradient is summation noise, which AdamW's per-element
normalisation turns into steps of up to lr in either direction.

Inside the port: with dropout on, a gang of 2 gives a world-1 run's
losses (rel 1e-5; masks are drawn for the global batch and sliced), and
eval top-1 and loss under 2 ranks equal world 1's (top-1 exactly; loss
rel 1e-6, summation order).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.checkpointing import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from kubeflow_tpu.config.platform import (  # noqa: E402
    DataConfig as JDataConfig,
    MeshConfig as JMeshConfig,
    TrainingConfig as JTrainingConfig,
)
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.parallel.mesh import mesh_from_config  # noqa: E402
from kubeflow_tpu.training.data import (  # noqa: E402
    SyntheticData as JSyntheticData,
    make_global_batch,
)
from kubeflow_tpu.training.datasets import build_data as jbuild_data  # noqa: E402
from kubeflow_tpu.training.tasks import (  # noqa: E402
    CausalLmTask as JCausalLmTask,
    ImageClassificationTask as JImageTask,
    MlmTask as JMlmTask,
)
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.parallel.distributed import render_gang_env  # noqa: E402
from torch_gangs import free_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL, PARAM_ATOL, BN_REL = 1e-5, 2e-5, 1e-5
# a gang rank's own time limit: a hang fails the test, not the tier
RANK_TIMEOUT_S = 240
SIZE, CLASSES, SEQ, VOCAB, BATCH, STEPS = 8, 10, 32, 512, 8, 3

# model name → (its TrainingConfig fields, model kwargs (both packages),
# the data the run reads)
RUNS = {
    "mlp": (dict(model="mlp", learning_rate=1e-3, weight_decay=1e-4),
            dict(hidden=(32,), num_classes=CLASSES), "blobs"),
    "resnet18": (dict(model="resnet18", learning_rate=0.05,
                      weight_decay=1e-4, label_smoothing=0.1),
                 dict(num_filters=8, num_classes=CLASSES), "blobs"),
    "gpt_tiny": (dict(model="gpt_tiny", learning_rate=1e-3,
                      weight_decay=0.1), {}, "lm"),
    # the load-balance loss over the global batch: each rank sums its
    # routing statistics with the others' before the product
    "gpt_tiny_moe": (dict(model="gpt_tiny_moe", learning_rate=1e-3,
                          weight_decay=0.1), {}, "lm"),
    "bert_tiny": (dict(model="bert_tiny", learning_rate=1e-3,
                       weight_decay=0.1), {}, "mlm"),
}

# One rank of a port gang (or a lone process): joins the gang its env
# renders (none: a plain single-process run), builds the job's model and
# task, runs `run_training` and prints its result, its checkpoint bytes
# written and (rank 0) saves its final state dict beside `out`.
WORKER = r'''
import json, os, sys
import numpy as np
import torch


class StopAfter:
    """A stop event that reads set once `steps` updates have run."""

    def __init__(self, steps):
        self.calls, self.steps = 0, steps

    def is_set(self):
        self.calls += 1
        return self.calls >= self.steps

    def set(self):
        pass


def run_job(job):
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.tasks import task_for_model
    from kubeflow_tpu_torch.training.trainer import Trainer
    from kubeflow_tpu_torch.utils.metrics import checkpoint_bytes_counter

    initialize_from_env(device="cpu")
    cfg = TrainingConfig.from_dict(job["cfg"])
    model = get_model(cfg.model, device="cpu", dtype=torch.float32,
                      seed=cfg.seed, **job.get("model_kw", {}))
    task = task_for_model(cfg.model, cfg, **job.get("task_kw", {}))
    trainer = Trainer(cfg, model=model, task=task, device="cpu")
    stop = StopAfter(job["stop_after"]) if job.get("stop_after") else None
    before = checkpoint_bytes_counter().value()
    res = run_training(cfg, restore=job.get("restore", False), device="cpu",
                       trainer=trainer, log_every=1, stop_event=stop)
    out = {"rank": rank(), "result": res,
           "ckpt_bytes": checkpoint_bytes_counter().value() - before,
           "backend": (torch.distributed.get_backend()
                       if torch.distributed.is_initialized() else None)}
    if rank() == 0 and job.get("out"):
        state = trainer._final_state.model.state_dict()
        np.savez(job["out"], **{k: v.detach().numpy()
                                for k, v in state.items()})
    shutdown()
    return out


def main():
    torch.set_num_threads(1)
    out = run_job(json.loads(os.environ["KFT_TEST_JOB"]))
    print("RESULT " + json.dumps(out), flush=True)
'''


def run_gang(job, world):
    """Run `job` on a port gang of `world` gloo ranks → each rank's output
    (rank order). Every rank has its own time limit; on any failure every
    rank is killed."""
    envs = render_gang_env("dp-test", ["127.0.0.1"] * world,
                           coordinator_port=free_port())
    procs = []
    try:
        for e in envs:
            env = dict(os.environ, **e, KFT_TEST_JOB=json.dumps(job),
                       OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER + "\nmain()\n"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"gang rank exited {p.returncode}:\n"
                                     f"{err[-6000:]}")
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            outs.append(json.loads(line[-1][len("RESULT "):]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_alone(job):
    """`job` in this process, with no gang (the world-1 reference)."""
    ns = {}
    exec(WORKER, ns)  # noqa: S102 - the worker source above
    return ns["run_job"](job)


def losses_of(out):
    return [loss for _, loss in out["result"]["losses"]]


# -- data both packages read ------------------------------------------------


def write_token_data(root, kind, n=BATCH * STEPS, seed=0):
    """`train_<key>.npy` files of `n` rows: gpt_tiny's with a ragged mask
    (row r keeps 4 + 7·(r mod 4) tokens), or bert_tiny's mlm stream."""
    os.makedirs(root, exist_ok=True)
    if kind == "lm":
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, VOCAB, (n, SEQ), dtype=np.int32)
        mask = np.ones((n, SEQ), np.int32)
        for r in range(n):
            mask[r, 4 + 7 * (r % 4):] = 0
        arrays = {"input_ids": ids, "attention_mask": mask}
    else:
        arrays = JSyntheticData("mlm", n, seed=seed, seq_len=SEQ,
                                vocab_size=VOCAB).batch_at(0)
    for k, v in arrays.items():
        np.save(os.path.join(root, f"train_{k}.npy"), v)
    return root


def data_cfg(name, root):
    if RUNS[name][2] == "blobs":
        return {"name": "blobs", "num_examples": 96, "eval_fraction": 0.25}
    return {"name": "npz", "path": write_token_data(root, RUNS[name][2])}


def cfg_dict(name, data, **over):
    fields = RUNS[name][0]
    return {**fields, "global_batch_size": BATCH, "steps": STEPS,
            "warmup_steps": 1, "dtype": "float32", "seed": 0, "data": data,
            **over}


def task_kw(name):
    if RUNS[name][2] == "blobs":
        return {"image_size": SIZE, "num_classes": CLASSES}
    return {"seq_len": SEQ, "vocab_size": VOCAB}


def jax_trainer(name, data, devices, world=4):
    fields = {k: v for k, v in cfg_dict(name, data).items() if k != "data"}
    cfg = JTrainingConfig(mesh=JMeshConfig(data=world),
                          data=JDataConfig(**data), **fields)
    mesh = mesh_from_config(cfg.mesh, devices=devices[:world])
    kind = RUNS[name][2]
    if kind == "blobs":
        task = JImageTask(cfg, **task_kw(name))
    elif kind == "lm":
        task = JCausalLmTask(cfg, **task_kw(name))
    else:
        task = JMlmTask(cfg, **task_kw(name))
    model = jget_model(name, dtype=jnp.float32, **RUNS[name][1])
    return JTrainer(cfg, mesh=mesh, model=model, task=task), mesh


@pytest.fixture(scope="module", params=list(RUNS))
def jax_run(request, devices8, tmp_path_factory):
    """The JAX trainer's 3 steps on `data: 4` from its own init, its
    step-0 checkpoint written first → (name, data config, ckpt dir,
    losses, final params and batch stats as numpy)."""
    name = request.param
    root = tmp_path_factory.mktemp(f"jax_{name}")
    data = data_cfg(name, str(root / "data"))
    jtr, mesh = jax_trainer(name, data, devices8)
    state = jtr.init_state()
    ckpt = str(root / "step0")
    with JCheckpointManager(ckpt, async_save=False) as mgr:
        mgr.save(0, state, force=True)
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    losses = []
    for i in range(STEPS):
        state, m = jtr.train_step(state, make_global_batch(train.batch_at(i),
                                                           mesh),
                                  jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, state)
    return name, data, ckpt, losses, final


@pytest.mark.parametrize("world", [2, 4])
def test_a_port_gang_equals_the_jax_trainer_on_a_data_4_mesh(jax_run, world,
                                                              tmp_path):
    name, data, jckpt, jlosses, jfinal = jax_run
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(jckpt, ckpt)
    job = {"cfg": cfg_dict(name, data, mesh={"data": world},
                           checkpoint={"directory": ckpt, "async_save": False}),
           "model_kw": RUNS[name][1], "task_kw": task_kw(name),
           "restore": True, "out": str(tmp_path / "final.npz")}
    outs = run_gang(job, world)
    assert [o["rank"] for o in outs] == list(range(world))
    for o in outs:
        res = o["result"]
        assert o["backend"] == "gloo" and res["world_size"] == world
        assert res["grad_allreduces"] == STEPS and res["final_step"] == STEPS
        # the ranks agree on every step's (all-reduced) loss, bit for bit
        assert res["losses"] == outs[0]["result"]["losses"]
    np.testing.assert_allclose(losses_of(outs[0]), jlosses, rtol=LOSS_REL)
    got = dict(np.load(str(tmp_path / "final.npz")))
    want = params_from_jax(jfinal.params,
                           jfinal.extra_vars.get("batch_stats"))
    assert got.keys() == want.keys()
    for n, w in want.items():
        if n.endswith("attention.key.bias"):
            continue
        w = w.numpy()
        if n.rsplit(".", 1)[1] in ("mean", "var"):
            assert np.abs(got[n] - w).max() <= BN_REL * np.abs(w).max(), n
        else:
            np.testing.assert_allclose(got[n], w, atol=PARAM_ATOL, rtol=0,
                                       err_msg=n)


def test_dropout_masks_are_the_global_batchs_in_a_gang(tmp_path):
    """gpt_tiny at dropout 0.1: a gang of 2 and a lone process on the same
    global batches take the same losses (the masks are drawn for the
    global batch and each rank keeps its rows)."""
    data = data_cfg("gpt_tiny", str(tmp_path / "data"))

    def job(world):
        return {"cfg": cfg_dict("gpt_tiny", data, mesh={"data": world},
                                checkpoint={"enabled": False}),
                "model_kw": {"dropout_rate": 0.1}, "task_kw": task_kw(
                    "gpt_tiny")}

    alone = run_alone(job(1))
    gang = run_gang(job(2), 2)
    assert alone["result"]["world_size"] == 1
    assert alone["result"]["grad_allreduces"] == 0
    np.testing.assert_allclose(losses_of(gang[0]), losses_of(alone),
                               rtol=LOSS_REL)
    # the masks matter: at dropout 0 the losses differ
    plain = run_alone({**job(1), "model_kw": {}})
    assert losses_of(plain)[0] != losses_of(alone)[0]


def test_eval_under_two_ranks_equals_one(tmp_path):
    """The mlp on blobs with a held-out split (48 rows, eval batch 20:
    a padded tail), evaluated every step: top-1 equal, loss rel 1e-6."""
    data = {"name": "blobs", "num_examples": 96, "eval_fraction": 0.5,
            "eval_every_steps": 1, "eval_batch_size": 20}

    def job(world):
        return {"cfg": cfg_dict("mlp", data, mesh={"data": world},
                                checkpoint={"enabled": False}),
                "model_kw": RUNS["mlp"][1], "task_kw": task_kw("mlp")}

    alone = run_alone(job(1))["result"]
    for o in run_gang(job(2), 2):
        res = o["result"]
        assert res["eval_top1"] == alone["eval_top1"]
        np.testing.assert_allclose(res["eval_loss"], alone["eval_loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(losses_of(o), [
            loss for _, loss in alone["losses"]], rtol=LOSS_REL)
