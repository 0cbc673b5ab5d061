"""The port's sequence-parallel training (the trainer on a `sequence` mesh
axis: ring and Ulysses attention, the shards' columns and lookahead
column, counts and gradients over data × sequence) against the JAX
`Trainer` on a `data: 2, sequence: 4` mesh, on the CPU in f32.

Port gangs of 2 (`mesh: {sequence: 2}`) and 4 (`{data: 2, sequence: 2}`)
gloo ranks (tests/torch_gangs.py), one gang a size running every case,
train gpt_tiny (ragged attention masks, so the next-token pairs that
cross a shard boundary differ from row to row) and bert_tiny (its mlm
stream) by ring and by Ulysses attention for 3 steps from the JAX
trainer's own init (its step-0 checkpoint, restored by every rank), on
the same `.npy` batches as the JAX trainer (tests/
test_torch_data_parallel.py's data). Bounds: losses within rel 1e-5
(f32; the frameworks and the gang sum in other orders). Each rank's
step-0 item counts, summed over data × sequence, equal a world-1
trainer's on the global batch (the pair into the next shard is there),
a rank's FLOP count is world 1's count of the global step over the
ranks, and the trainer turns the default attention into "ring". A
held-out split evaluates as world 1 does, and a `{sequence: 2}` gang's
step-2 checkpoint resumes at world 1 and in the
JAX trainer to the gang's own step-3 and step-4 losses. The long-context
config's step fields (two microbatches, the streamed head, no attention
mask) train in both gangs as the JAX trainer does. The last test
rehearses chip_smoke.py's phase 19 at gpt_tiny size.
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
from kubeflow_tpu.training.data import make_global_batch  # noqa: E402
from kubeflow_tpu.training.datasets import build_data as jbuild_data  # noqa: E402
from kubeflow_tpu.training.tasks import (  # noqa: E402
    CausalLmTask as JCausalLmTask,
    MlmTask as JMlmTask,
)
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.checkpointing import layout  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    TrainingConfig,
)
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
)
from kubeflow_tpu_torch.training.data import to_device  # noqa: E402
from kubeflow_tpu_torch.training.datasets import build_data  # noqa: E402
from kubeflow_tpu_torch.training.trainer import Trainer  # noqa: E402
from test_torch_data_parallel import (  # noqa: E402
    BATCH,
    LOSS_REL,
    SEQ,
    STEPS,
    cfg_dict,
    data_cfg,
    task_kw,
)
from torch_gangs import (  # noqa: E402
    REPO,
    RANK_TIMEOUT_S,
    SMOKE_SEQ,
    free_port,
    rehearse_smoke,
    run_gang,
)

MODELS = ("gpt_tiny", "bert_tiny")
IMPLS = ("ring", "ulysses")
MESHES = {2: {"sequence": 2}, 4: {"data": 2, "sequence": 2}}
CKPT_STEPS, CKPT_SAVE = 4, 2
# a held-out split evaluated after each step (a padded tail batch)
EVAL_DATA = {"eval_fraction": 0.25, "eval_every_steps": 1,
             "eval_batch_size": 5}
# configs/gpt_longcontext_v5e16.yaml's step fields at test size: two
# microbatches, the streamed head, no attention mask
LONG = dict(accum_steps=2, loss_chunk=8, assume_full_attention=True)

# One rank: every job of the gang in turn (each a fresh Trainer built by
# the trainer itself, so its attention default is the trainer's): the
# step-0 item counts summed over data x sequence, the FLOP share, then
# `run_training` restored from the job's checkpoint directory.
WORKER = r'''
import json, os
import torch


def run_job(job):
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.parallel.mesh import sequence_parallel
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.data import to_device
    from kubeflow_tpu_torch.training.datasets import build_data
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig.from_dict(job["cfg"])
    trainer = Trainer(cfg, device="cpu")
    data, _ = build_data(cfg, trainer.task)
    local = trainer.local_batch(data.batch_at(0))
    with sequence_parallel(trainer.seq):
        counts = trainer.task.item_counts(to_device(local, trainer.device))
    torch.distributed.all_reduce(counts, group=trainer._group)
    res = run_training(cfg, restore=True, device="cpu", trainer=trainer,
                       log_every=1)
    return {"result": res, "counts": counts.tolist(),
            "flops": trainer.rank_flops(local),
            "attention": trainer.model.cfg.attention_impl,
            "columns": list(local["input_ids"].shape)}


def main():
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    jobs = json.loads(os.environ["KFT_TEST_JOB"])["jobs"]
    out = {"rank": rank(), "jobs": {name: run_job(job)
                                    for name, job in jobs.items()}}
    shutdown()
    print("RESULT " + json.dumps(out), flush=True)
'''


def _jax_trainer(name, data, devices, steps=STEPS, **over):
    """The JAX trainer on data: 2, sequence: 4 (Ulysses: the heads divide
    over 4; the JAX ring computes the same function). `steps` sets the
    schedule's length; `over` are more TrainingConfig fields."""
    fields = {k: v for k, v in cfg_dict(name, data, steps=steps,
                                        **over).items() if k != "data"}
    cfg = JTrainingConfig(mesh=JMeshConfig(data=2, sequence=4),
                          data=JDataConfig(**data), **fields)
    mesh = mesh_from_config(cfg.mesh, devices=devices[:8])
    task_cls = JCausalLmTask if name.startswith("gpt") else JMlmTask
    model = jget_model(name, dtype=jnp.float32, attention_impl="ulysses")
    return JTrainer(cfg, mesh=mesh, model=model,
                    task=task_cls(cfg, **task_kw(name))), mesh


def _jax_steps(jtr, mesh, state, first, last):
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    losses = []
    for i in range(first, last):
        state, m = jtr.train_step(state, make_global_batch(train.batch_at(i),
                                                           mesh),
                                  jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def jax_runs(devices8, tmp_path_factory):
    """{model: (data config, step-0 checkpoint dir, 3 steps' losses)}."""
    runs = {}
    for name in MODELS:
        root = tmp_path_factory.mktemp(f"jax_{name}")
        data = data_cfg(name, str(root / "data"))
        jtr, mesh = _jax_trainer(name, data, devices8)
        state = jtr.init_state()
        ckpt = str(root / "step0")
        with JCheckpointManager(ckpt, async_save=False) as mgr:
            mgr.save(0, state, force=True)
        _, losses = _jax_steps(jtr, mesh, state, 0, STEPS)
        runs[name] = (data, ckpt, losses)
    return runs


@pytest.fixture(scope="module")
def jax_long_runs(jax_runs, devices8):
    """{model: 3 steps' losses} of the JAX trainer with the LONG fields,
    from the same step-0 checkpoint."""
    runs = {}
    for name in MODELS:
        data, ckpt, _ = jax_runs[name]
        jtr, mesh = _jax_trainer(name, data, devices8, **LONG)
        state = JCheckpointManager(ckpt).restore(jtr.init_state(), step=0)
        _, runs[name] = _jax_steps(jtr, mesh, state, 0, STEPS)
    return runs


def _job(data, ckpt, root, name, mesh, impl=None, steps=STEPS, extra=None,
         **ckpt_kw):
    """A gang job restoring from a copy of `ckpt` (`extra`: more
    TrainingConfig fields)."""
    own = str(root / f"{name}-{impl}-{steps}{'-x' if extra else ''}")
    shutil.copytree(ckpt, own)
    over = {} if impl is None else {"attention_impl": impl}
    return {"cfg": cfg_dict(name, data, steps=steps, mesh=mesh, checkpoint={
        "directory": own, "async_save": False, **ckpt_kw}, **over,
        **(extra or {}))}


@pytest.fixture(scope="module")
def gangs(jax_runs, tmp_path_factory):
    """world → (world, rank outputs, the checkpoint run's directory or
    None), each gang started once."""
    done = {}

    def start(world):
        if world in done:
            return done[world]
        root = tmp_path_factory.mktemp(f"sp{world}")
        jobs = {}
        for name in MODELS:
            data, ckpt, _ = jax_runs[name]
            for impl in IMPLS:
                # gpt's ring is the trainer's default: its config names none
                named = None if (name, impl) == ("gpt_tiny", "ring") else impl
                jobs[f"{name}/{impl}"] = _job(data, ckpt, root, name,
                                              MESHES[world], named)
            jobs[f"{name}/long"] = _job(data, ckpt, root, name,
                                        MESHES[world], extra=LONG)
        ckpt_dir = None
        if world == 2:
            data, ckpt, _ = jax_runs["gpt_tiny"]
            jobs["ckpt"] = _job(data, ckpt, root, "gpt_tiny", MESHES[world],
                                steps=CKPT_STEPS, interval_steps=CKPT_SAVE,
                                keep=10)
            ckpt_dir = jobs["ckpt"]["cfg"]["checkpoint"]["directory"]
            jobs["eval"] = _job(dict(data, **EVAL_DATA), ckpt, root,
                                "gpt_tiny", MESHES[world], steps=2)
        done[world] = (world, run_gang(WORKER, {"jobs": jobs}, world),
                       ckpt_dir)
        return done[world]

    return start


@pytest.fixture(params=sorted(MESHES), ids=["seq2", "data2-seq2"])
def gang(request, gangs):
    return gangs(request.param)


def _losses(res):
    return [loss for _, loss in res["result"]["losses"]]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("impl", IMPLS)
def test_a_sequence_gang_equals_the_jax_trainer(gang, jax_runs, name, impl):
    world, outs, _ = gang
    _, _, jlosses = jax_runs[name]
    results = [o["jobs"][f"{name}/{impl}"] for o in outs]
    for res in results:
        assert res["result"]["world_size"] == world
        assert res["result"]["grad_allreduces"] == STEPS
        assert res["columns"] == [BATCH * 2 // world, SEQ // 2]
        # the ranks agree on every step's (all-reduced) loss, bit for bit
        assert _losses(res) == _losses(results[0])
        assert res["attention"] == impl
    np.testing.assert_allclose(_losses(results[0]), jlosses, rtol=LOSS_REL)


@pytest.mark.parametrize("name", MODELS)
def test_the_long_context_step_fields_under_a_sequence_axis(
        gang, jax_long_runs, name):
    """accum_steps 2, loss_chunk 8 and assume_full_attention (the
    long-context config's step fields) in a sequence gang, against the
    JAX trainer with the same fields: losses within rel 1e-5, every
    rank's bit for bit equal."""
    world, outs, _ = gang
    results = [o["jobs"][f"{name}/long"] for o in outs]
    for res in results:
        assert res["result"]["world_size"] == world
        assert _losses(res) == _losses(results[0])
        assert res["columns"] == [BATCH * 2 // world, SEQ // 2]
    np.testing.assert_allclose(_losses(results[0]), jax_long_runs[name],
                               rtol=LOSS_REL)


def _world1_counts(name, data):
    cfg = TrainingConfig(**cfg_dict(name, data))
    trainer = Trainer(cfg, device="cpu")
    stream, _ = build_data(cfg, trainer.task)
    batch = to_device(stream.batch_at(0), trainer.device)
    return trainer.task.item_counts(batch).tolist(), trainer.model.cfg


@pytest.mark.parametrize("name", MODELS)
def test_item_counts_and_flops_are_world_1s(gang, jax_runs, name):
    """Summed over data x sequence, a rank's step-0 counts are world 1's
    (gpt: the valid next-token pairs, the ones across a shard boundary
    included; bert: masked positions and next-sentence rows, counted on
    sequence rank 0), and its FLOP share is world 1's count of the global
    step over the ranks."""
    world, outs, _ = gang
    want, mcfg = _world1_counts(name, jax_runs[name][0])
    count = lm_train_flops if name.startswith("gpt") else encoder_train_flops
    for impl in IMPLS:
        for o in outs:
            res = o["jobs"][f"{name}/{impl}"]
            assert res["counts"] == want
            np.testing.assert_allclose(
                res["flops"], count(mcfg, BATCH, SEQ) / world, rtol=1e-12)


def _only_step(src, dst, step):
    shutil.copytree(src, dst)
    for s in layout.committed_steps(dst):
        if s != step:
            shutil.rmtree(layout.step_dir(dst, s))
    return dst


def test_a_sequence_gang_checkpoint_resumes_at_world_1_and_in_jax(
        gangs, jax_runs, devices8, tmp_path):
    world, outs, ckpt = gangs(2)
    gang_losses = _losses(outs[0]["jobs"]["ckpt"])
    # the JAX step-0 checkpoint it restored, then its own saves
    assert layout.committed_steps(ckpt) == [0, CKPT_SAVE, CKPT_STEPS]
    manifest = layout.read_manifest(layout.step_dir(ckpt, CKPT_SAVE))
    assert manifest["process_count"] == world
    data = jax_runs["gpt_tiny"][0]
    # the port at world 1, from the gang's step 2
    only = _only_step(ckpt, str(tmp_path / "w1"), CKPT_SAVE)
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": only,
                                                "async_save": False}))
    from kubeflow_tpu_torch.runtime.train_run import run_training

    res = run_training(cfg, restore=True, device="cpu", log_every=1)
    assert [s for s, _ in res["losses"]] == [3, 4]
    np.testing.assert_allclose([loss for _, loss in res["losses"]],
                               gang_losses[CKPT_SAVE:], rtol=LOSS_REL)
    # the JAX package on data: 2, sequence: 4, from the same step
    jtr, mesh = _jax_trainer("gpt_tiny", data, devices8, steps=CKPT_STEPS)
    state = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                             step=CKPT_SAVE)
    assert int(jax.device_get(state.step)) == CKPT_SAVE
    _, jlosses = _jax_steps(jtr, mesh, state, CKPT_SAVE, CKPT_STEPS)
    np.testing.assert_allclose(jlosses, gang_losses[CKPT_SAVE:],
                               rtol=LOSS_REL)


def test_eval_under_a_sequence_axis_equals_world_1(gangs, jax_runs,
                                                   tmp_path):
    """gpt_tiny's held-out split evaluated by a `{sequence: 2}` gang (each
    rank its columns and the lookahead column, the sums over both) and
    by world 1 from the same step-0 checkpoint: top-1 equal, loss rel
    1e-6 (summation order)."""
    _, outs, _ = gangs(2)
    data, ckpt, _ = jax_runs["gpt_tiny"]
    from kubeflow_tpu_torch.runtime.train_run import run_training

    job = _job(dict(data, **EVAL_DATA), ckpt, tmp_path, "gpt_tiny", {},
               steps=2)
    alone = run_training(TrainingConfig(**job["cfg"]), restore=True,
                         device="cpu", log_every=1)
    for o in outs:
        res = o["jobs"]["eval"]["result"]
        assert res["eval_top1"] == alone["eval_top1"]
        np.testing.assert_allclose(res["eval_loss"], alone["eval_loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(_losses(o["jobs"]["eval"]), [
            loss for _, loss in alone["losses"]], rtol=LOSS_REL)


def test_a_sequence_gang_through_the_launcher_equals_world_1():
    """`python -m kubeflow_tpu_torch.runtime.launcher --device cpu` as a
    `{sequence: 2}` gang from the rendered KFT_* env (gpt_tiny, the lm
    stream made on the device, the trainer's ring default) against
    `run_training` of the same spec at world 1."""
    from kubeflow_tpu_torch.parallel.distributed import render_gang_env
    from kubeflow_tpu_torch.runtime.train_run import run_training

    spec = {"model": "gpt_tiny", "seq_len": SEQ, "global_batch_size": 4,
            "steps": 2, "dtype": "float32", "learning_rate": 1e-3,
            "warmup_steps": 1, "checkpoint": {"enabled": False}}
    envs = render_gang_env("seq-launch", ["127.0.0.1"] * 2,
                           coordinator_port=free_port())
    procs, results = [], []
    try:
        for e in envs:
            env = dict(os.environ, **e, OMP_NUM_THREADS="1",
                       KFT_TRAINING_SPEC=json.dumps(
                           {**spec, "mesh": {"sequence": 2}}))
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
                 "--device", "cpu"], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    alone = run_training(TrainingConfig(**spec), device="cpu", log_every=1)
    for res in results:
        assert res["world_size"] == 2 and res["grad_allreduces"] == 2
        assert res["losses"] == results[0]["losses"]
    np.testing.assert_allclose([loss for _, loss in results[0]["losses"]],
                               [loss for _, loss in alone["losses"]],
                               rtol=LOSS_REL)


def test_the_long_context_config_loads_with_its_sequence_axis():
    import yaml

    with open(os.path.join(REPO, "configs", "gpt_longcontext_v5e16.yaml")) as f:
        spec = yaml.safe_load(f)
    cfg = TrainingConfig.from_dict(spec["training"])
    assert (cfg.mesh.data, cfg.mesh.sequence) == (2, 8)
    assert cfg.seq_len == 32768 and cfg.attention_impl == "dense"
    # the trainer's model for it: ring attention (a meta model, no weights)
    model = get_model(cfg.model, device="meta", max_len=cfg.seq_len,
                      attention_impl="ring")
    assert model.cfg.attention_impl == "ring"


@pytest.mark.parametrize("bad,match", [
    (dict(seq_len=33), "not divisible by the sequence mesh axis"),
    (dict(attention_impl="flash"), "runs no sequence axis"),
    (dict(model="resnet18", seq_len=0), "LM models only"),
])
def test_the_config_checks_a_sequence_axis(bad, match):
    fields = dict(model="gpt_tiny", seq_len=32, global_batch_size=4,
                  mesh={"sequence": 2})
    with pytest.raises(ConfigError, match=match):
        TrainingConfig(**{**fields, **bad})


def test_a_model_refuses_a_shard_it_cannot_attend_across():
    from kubeflow_tpu_torch.parallel.mesh import (
        SequenceShard,
        sequence_parallel,
    )

    ids = torch.zeros((1, 8), dtype=torch.long)
    for name in MODELS:
        model = get_model(name, device="cpu", dtype=torch.float32,
                          attention_impl="flash")
        with sequence_parallel(SequenceShard(None, 0, 2)):
            with pytest.raises(ValueError, match="runs no sequence axis"):
                model(ids)
    gpt = get_model("gpt_tiny", device="cpu", dtype=torch.float32,
                    attention_impl="ring")
    with sequence_parallel(SequenceShard(None, 1, 2)):
        with pytest.raises(ValueError, match="run no sequence axis"):
            gpt.prefill(ids)


def test_chip_smoke_phase_19_rehearsal(tmp_path):
    """Phase 19 of chip_smoke.py on the CPU at gpt_tiny size, through
    `phase_gangs` as main runs it: 19a's and 19b's two-rank gangs (ring,
    Ulysses) against world 1 (losses, equal weights across the ranks,
    rank 0's final weights against world 1's update), 19c's ring ranks 0
    and 7 against one causal call over the whole sequence."""
    launches = rehearse_smoke(tmp_path, seq=SMOKE_SEQ)
    assert launches == {"seq": {"flash_fwd": 0, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0}}
