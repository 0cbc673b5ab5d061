"""The port's pipeline-parallel training (the trainer on a `pipeline` mesh
axis: one stage a rank, activations sent point to point, GPipe and 1F1B)
against the JAX `Trainer` on the same mesh, on the CPU in f32.

Port gangs of 4 and 2 gloo ranks (tests/torch_gangs.py), one gang a size
running every job, train gpt_tiny and bert_tiny on `{data: 2, pipeline:
2}` (world 4) and `{pipeline: 2}` (world 2) under both schedules, and
bert_tiny_moe on `{pipeline: 2, expert: 2}`, for 3 steps from the JAX
trainer's own pipelined init (its step-0 checkpoint, the stacked
`decoder|encoder/stages/layer_<j>` leaves, restored by every rank) on the
same `.npy` batches (tests/test_torch_data_parallel.py's data). The JAX
trainer runs each (model, mesh) once on the conftest's 8 CPU devices.
Bounds: losses within rel 1e-5 (f32; the frameworks and the stages sum in
other orders), every rank's losses bit for bit equal; 1F1B's gradients
within rel 1e-4, atol 1e-5·max|g| of GPipe's (tests/test_pipeline.py's
bound; here they are equal bits: both run each stage's backwards in
microbatch order).

The MoE aux under a pipeline: the JAX package sums the load-balance loss
its routers sow on every tick of its scan, the fill, drain and padding
ticks' zeroed inputs included (entries that differ between its
schedules). The port sums the real (microbatch, stage) calls: its
`moe_aux_loss` equals the JAX leaves summed over the valid (tick, stage)
entries, its loss the JAX loss less the bubble entries, and the JAX
total exceeds the valid sum by exactly those entries. The bubble entries
are not gradient-free, as the reference's comment has it: on a post-LN
layer the router reads the LayerNorm's bias, which takes their gradient,
so the two trajectories part after the first update at lr > 0; the
steps before it are held at rel 1e-5, and the gradient is shown.

Also: each rank holds only its stage's layers and the leaves its stage
owns; 1F1B's live-activation counter peaks at S − s on stage s against
GPipe's M (S = 4, M = 16, the executed schedule); dropout (with remat)
draws world 1's masks; gradient accumulation over a pipeline and the
eval pass through the stages are world 1's; the ranks' FLOP counts sum
to world 1's; a gang's
pipelined checkpoint has the JAX manifest's keys and shapes, restores in
the JAX package and at port world 1 (its layers the ranks' blocks joined,
bit for bit), and both resume to the gang's own losses. The last test
rehearses chip_smoke.py's phase 21 at gpt_tiny size.
"""

import os
import shutil

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
from kubeflow_tpu_torch.config.platform import TrainingConfig  # noqa: E402
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
)
from test_torch_data_parallel import (  # noqa: E402
    BATCH,
    LOSS_REL,
    SEQ,
    STEPS,
    VOCAB,
    write_token_data,
)
from torch_gangs import (  # noqa: E402
    SMOKE_EXPERT,
    SMOKE_FSDP,
    SMOKE_TENSOR,
    SMOKE_PIPELINE,
    SMOKE_SEQ,
    rehearse_smoke,
    run_gang,
)

STAGES = 2
MODELS = {
    "gpt_tiny": (dict(model="gpt_tiny", learning_rate=1e-3,
                      weight_decay=0.1), "lm"),
    "bert_tiny": (dict(model="bert_tiny", learning_rate=1e-3,
                       weight_decay=0.1), "mlm"),
    "bert_tiny_moe": (dict(model="bert_tiny_moe", learning_rate=1e-3,
                           weight_decay=0.1), "mlm"),
}
MESHES = {"d2p2": {"data": 2, "pipeline": 2}, "p2": {"pipeline": 2},
          "p2e2": {"pipeline": 2, "expert": 2}}
# job name → (model, mesh, schedule), each from the JAX step-0 checkpoint
JOBS = {
    4: {f"{m}/d2p2/{s}": (m, "d2p2", s) for m in ("gpt_tiny", "bert_tiny")
        for s in ("gpipe", "1f1b")}
    | {f"bert_tiny_moe/p2e2/{s}": ("bert_tiny_moe", "p2e2", s)
       for s in ("gpipe", "1f1b")},
    2: {f"{m}/p2/{s}": (m, "p2", s) for m in ("gpt_tiny", "bert_tiny")
        for s in ("gpipe", "1f1b")},
}
# the live-activation bound: S = 4 stages of gpt_tiny at 4 layers, M = 16
LIVE_S, LIVE_M = 4, 16
# the checkpoint job: gpt_tiny on d2p2 (1f1b) saving at step 2 of 4
CKPT_STEPS, CKPT_SAVE = 4, 2
DROPOUT = 0.1
# accumulation microbatches of the world-2 gang's accumulation job
ACCUM = 2
# the held-out share of the world-2 gang's eval jobs
EVAL_FRACTION = 0.25
# MoE steps run at the init params (update 0 runs at lr 0 under one
# warm-up step), before the JAX bubble aux's gradient has moved anything
# (test_the_jax_bubble_aux_has_a_gradient_through_the_layernorm_bias)
BUBBLE_FREE_STEPS = 2

# One rank: every job of the gang in turn, each a fresh Trainer (restored
# from the job's copy of the JAX step-0 checkpoint by `run_training`, or
# seeded).
WORKER = r'''
import json, os
import numpy as np
import torch


def run_job(job):
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.datasets import build_data
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig.from_dict(job["cfg"])
    if job.get("refused"):
        try:
            Trainer(cfg, device="cpu")
        except Exception as e:
            return {"refused": type(e).__name__, "message": str(e)}
        return {"refused": None}
    trainer = Trainer(cfg, device="cpu", model_kwargs=job.get("model_kw"))
    aux, grads = [], {}
    step = trainer.train_step

    def train_step(state, batch):
        state, metrics = step(state, batch)
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
        if not grads:
            grads.update({n: p.grad.numpy().copy() for n, p in
                          state.model.named_parameters()})
        return state, metrics

    trainer.train_step = train_step
    data, _ = build_data(cfg, trainer.task)
    local = trainer.local_batch(data.batch_at(0))
    res = run_training(cfg, restore=job.get("restore", True), device="cpu",
                       trainer=trainer, log_every=1)
    state = trainer._final_state
    rank = torch.distributed.get_rank()
    if job.get("out"):
        np.savez(f"{job['out']}.{rank}.npz", **{
            n: p.detach().numpy() for n, p in state.model.named_parameters()})
        np.savez(f"{job['out']}.grads.{rank}.npz", **grads)
    return {"result": res, "aux": aux,
            "names": sorted(n for n, _ in state.model.named_parameters()),
            "live": trainer.stage_live.peak,
            "order": trainer.stage_live.order,
            "flops": trainer.rank_flops(local),
            "coords": {a: trainer.mesh.get_local_rank(a)
                       for a in ("data", "pipeline", "expert")}}


def main():
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    jobs = json.loads(os.environ["KFT_TEST_JOB"])["jobs"]
    out = {"rank": rank(),
           "jobs": {name: run_job(job) for name, job in jobs.items()}}
    shutdown()
    print("RESULT " + json.dumps(out), flush=True)
'''


def cfg_dict(name, data, steps=STEPS, **over):
    return {**MODELS[name][0], "global_batch_size": BATCH, "steps": steps,
            "warmup_steps": 1, "dtype": "float32", "seed": 0, "data": data,
            **over}


def _jax_trainer(name, mesh, schedule, data, devices, steps=STEPS):
    """The JAX trainer of one job on the job's own mesh (its pipelined
    model built with the schedule, as the JAX trainer's factory kwargs
    build it)."""
    fields = {k: v for k, v in cfg_dict(name, data, steps=steps).items()
              if k != "data"}
    cfg = JTrainingConfig(mesh=JMeshConfig(**MESHES[mesh]),
                          data=JDataConfig(**data),
                          pipeline_schedule=schedule, **fields)
    jmesh = mesh_from_config(cfg.mesh,
                             devices=devices[:cfg.mesh.num_devices])
    model = jget_model(name, dtype=jnp.float32, pipeline_stages=STAGES,
                       pipeline_schedule=schedule)
    task_cls = JCausalLmTask if name.startswith("gpt") else JMlmTask
    task = task_cls(cfg, seq_len=SEQ, vocab_size=VOCAB)
    return JTrainer(cfg, mesh=jmesh, model=model, task=task), jmesh


def _valid_aux(sown, m):
    """(sum of the sown MoE aux over the valid (tick, stage) entries, over
    all of them): slot i at tick t holds microbatch t − i, real when
    0 <= t − i < M (kubeflow_tpu/models/layers.py pipeline_scan)."""
    valid = full = 0.0
    for leaf in jax.tree.leaves(sown):
        arr = np.asarray(leaf, np.float64)
        arr = arr.reshape(-1, arr.shape[-1])
        t, i = np.indices(arr.shape)
        valid += float((arr * ((t - i >= 0) & (t - i < m))).sum())
        full += float(arr.sum())
    return valid, full


def _jax_steps(jtr, jmesh, state, first, last):
    """Steps [first, last) → (losses, aux values, (valid, full) aux sums of
    the sown leaves at each step's params)."""
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    losses, aux, sown = [], [], []
    for i in range(first, last):
        batch = train.batch_at(i)
        if jtr.model.cfg.num_experts:
            _, var = jtr.model.apply(
                {"params": state.params}, jnp.asarray(batch["input_ids"]),
                attention_mask=jnp.asarray(batch["attention_mask"]),
                deterministic=True, mutable=["losses"])
            sown.append(_valid_aux(var["losses"], STAGES))
        state, m = jtr.train_step(state, make_global_batch(batch, jmesh),
                                  jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
        if "moe_aux_loss" in m:
            aux.append(float(m["moe_aux_loss"]))
    return state, losses, aux, sown


@pytest.fixture(scope="module")
def data_and_init(tmp_path_factory):
    """{model: (data config, the JAX pipelined step-0 checkpoint)}."""
    out = {}

    def get(name, devices):
        if name not in out:
            root = tmp_path_factory.mktemp(f"jax_pp_{name}")
            data = {"name": "npz",
                    "path": write_token_data(str(root / "data"),
                                             MODELS[name][1])}
            jtr, _ = _jax_trainer(name, "p2", "gpipe", data, devices)
            ckpt = str(root / "step0")
            with JCheckpointManager(ckpt, async_save=False) as mgr:
                mgr.save(0, jtr.init_state(), force=True)
            out[name] = (data, ckpt)
        return out[name]

    return get


@pytest.fixture(scope="module")
def jax_runs(data_and_init, devices8):
    """(model, mesh, schedule) → the JAX trainer's 3 steps from the
    step-0 checkpoint: (losses, aux losses, sown aux sums), each once.
    A dense model runs GPipe (both schedules compute the same function)."""
    done = {}

    def get(name, mesh, schedule):
        if not name.endswith("_moe"):
            schedule = "gpipe"
        key = (name, mesh, schedule)
        if key not in done:
            data, ckpt = data_and_init(name, devices8)
            jtr, jmesh = _jax_trainer(name, mesh, schedule, data, devices8)
            state = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                                     step=0)
            done[key] = _jax_steps(jtr, jmesh, state, 0, STEPS)[1:]
        return done[key]

    return get


def _job(data, ckpt, root, job, name, mesh, schedule, steps=STEPS,
         **ckpt_kw):
    own = str(root / job.replace("/", "-"))
    shutil.copytree(ckpt, own)
    cfg = cfg_dict(name, data, steps=steps, mesh=MESHES[mesh],
                   pipeline_schedule=schedule, checkpoint={
                       "directory": own, "async_save": False, **ckpt_kw})
    return {"cfg": cfg, "out": own + "/final"}


def _seeded_job(data, name, mesh, schedule, steps, **over):
    cfg = cfg_dict(name, data, steps=steps, mesh=mesh,
                   pipeline_schedule=schedule,
                   checkpoint={"enabled": False}, **over)
    return {"cfg": cfg, "restore": False}


@pytest.fixture(scope="module")
def gangs(data_and_init, devices8, tmp_path_factory):
    """world → (rank outputs, {job: its directory}), each gang once."""
    done = {}

    def start(world):
        if world in done:
            return done[world]
        root = tmp_path_factory.mktemp(f"pp{world}")
        jobs, dirs = {}, {}
        for job, (name, mesh, schedule) in JOBS[world].items():
            data, ckpt = data_and_init(name, devices8)
            jobs[job] = _job(data, ckpt, root, job, name, mesh, schedule)
            dirs[job] = jobs[job]["cfg"]["checkpoint"]["directory"]
        if world == 4:
            data, ckpt = data_and_init("gpt_tiny", devices8)
            jobs["ckpt"] = _job(data, ckpt, root, "ckpt", "gpt_tiny",
                                "d2p2", "1f1b", steps=CKPT_STEPS,
                                interval_steps=CKPT_SAVE, keep=10)
            dirs["ckpt"] = jobs["ckpt"]["cfg"]["checkpoint"]["directory"]
            for schedule in ("gpipe", "1f1b"):
                jobs[f"live/{schedule}"] = _seeded_job(
                    data, "gpt_tiny", {"pipeline": LIVE_S}, schedule, 1,
                    global_batch_size=LIVE_M)
                jobs[f"live/{schedule}"]["model_kw"] = {
                    "num_layers": LIVE_S, "num_microbatches": LIVE_M}
            jobs["dropout"] = _seeded_job(
                data, "gpt_tiny", MESHES["d2p2"], "1f1b", STEPS, remat=True)
            jobs["dropout"]["model_kw"] = {"dropout_rate": DROPOUT}
        else:
            data, _ = data_and_init("gpt_tiny", devices8)
            jobs["accum"] = _seeded_job(data, "gpt_tiny", MESHES["p2"],
                                        "1f1b", STEPS, accum_steps=ACCUM)
            for name in ("gpt_tiny", "bert_tiny"):
                data, _ = data_and_init(name, devices8)
                jobs[f"eval/{name}"] = _seeded_job(
                    dict(data, eval_fraction=EVAL_FRACTION), name,
                    MESHES["p2"], "gpipe", STEPS)
            jobs["refused/mlp"] = {"refused": True, "cfg": {
                "model": "mlp", "global_batch_size": 8, "steps": 1,
                "mesh": MESHES["p2"], "checkpoint": {"enabled": False}}}
        done[world] = (run_gang(WORKER, {"jobs": jobs}, world,
                                name=f"pp-test-{world}"), dirs)
        return done[world]

    return start


def _losses(res):
    return [loss for _, loss in res["result"]["losses"]]


def _cases():
    return [(world, job) for world in sorted(JOBS) for job in JOBS[world]]


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_a_pipeline_gang_equals_the_jax_trainer_on_its_mesh(gangs, jax_runs,
                                                            world, job):
    """Losses within rel 1e-5 of the JAX trainer's on the same mesh, every
    rank's bit for bit equal; an MoE job's aux is the JAX sown leaves
    summed over the valid ticks, its loss the JAX loss less the bubble
    entries, and the JAX total is the valid sum plus those entries."""
    name, mesh, schedule = JOBS[world][job]
    outs, _ = gangs(world)
    jlosses, jaux, sown = jax_runs(name, mesh, schedule)
    results = [o["jobs"][job] for o in outs]
    for res in results:
        assert res["result"]["world_size"] == world
        assert res["result"]["final_step"] == STEPS
        assert _losses(res) == _losses(results[0])
        assert res["aux"] == results[0]["aux"]
    if not name.endswith("_moe"):
        np.testing.assert_allclose(_losses(results[0]), jlosses,
                                   rtol=LOSS_REL)
        return
    valid = [v for v, _ in sown]
    bubble = [f - v for v, f in sown]
    assert len(results[0]["aux"]) == STEPS and all(b > 0 for b in bubble)
    # the JAX total is the valid sum plus the bubble entries, every step
    np.testing.assert_allclose(jaux, [f for _, f in sown], rtol=LOSS_REL)
    # the steps whose params no bubble gradient has reached (update 0 runs
    # at lr 0): the port's aux is the valid sum, its loss the JAX loss less
    # the bubble entries
    same = BUBBLE_FREE_STEPS
    np.testing.assert_allclose(results[0]["aux"][:same], valid[:same],
                               rtol=LOSS_REL)
    np.testing.assert_allclose(_losses(results[0])[:same],
                               np.subtract(jlosses, bubble)[:same],
                               rtol=LOSS_REL)
    # from the first update at lr > 0 on, the JAX bubble entries are no
    # longer their init constant: their inputs moved
    assert bubble[same] != pytest.approx(bubble[0], rel=1e-3)


def test_the_jax_bubble_aux_has_a_gradient_through_the_layernorm_bias(
        data_and_init, devices8):
    """Why the JAX trajectory leaves the port's after its first update at
    lr > 0: a bubble tick zeroes the stage's input, so the router reads a
    post-LN layer's `ln_att` output, which is that LayerNorm's bias (0 at
    init, so its logits tie and every token routes to expert 0). The
    bubble aux then has no gradient on the router's kernel (its input is
    0) but a nonzero one on the LayerNorm's bias (and what feeds it):
    the reference's "zero gradient" holds for the router only."""
    data, ckpt = data_and_init("bert_tiny_moe", devices8)
    jtr, _ = _jax_trainer("bert_tiny_moe", "p2", "gpipe", data, devices8)
    params = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                              step=0).params
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    batch = train.batch_at(0)

    def bubble(p):
        _, var = jtr.model.apply(
            {"params": p}, jnp.asarray(batch["input_ids"]),
            attention_mask=jnp.asarray(batch["attention_mask"]),
            deterministic=True, mutable=["losses"])
        total = 0.0
        for leaf in jax.tree.leaves(var["losses"]):
            arr = leaf.reshape(-1, leaf.shape[-1])
            t, i = np.indices(arr.shape)
            total = total + (arr * ~((t - i >= 0) & (t - i < STAGES))).sum()
        return total

    grads = jax.tree.map(np.asarray, jax.grad(bubble)(params))
    layer = grads["encoder"]["stages"]["layer_0"]
    assert not np.any(layer["moe"]["router"])
    assert np.any(layer["ln_att"]["bias"])


def _valid_sown_sum(sown):
    """The JAX "losses" collection summed over its valid (tick, stage)
    entries only (`_valid_aux`'s mask, traced)."""
    total = 0.0
    for leaf in jax.tree.leaves(sown.get("losses", {})):
        arr = leaf.reshape(-1, leaf.shape[-1])
        t, i = np.indices(arr.shape)
        total = total + (arr * ((t - i >= 0) & (t - i < STAGES))).sum()
    return total


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_the_moe_stages_gradients_are_the_jax_gradient_less_the_bubble(
        gangs, data_and_init, devices8, monkeypatch, schedule):
    """bert_tiny_moe on `{pipeline: 2, expert: 2}`: every rank's
    first-step gradients (each stage's own layers' aux in its backward,
    the routers' gradients reaching stage 0 through the activation
    gradient, the expert blocks on each stage) are jax.grad of the JAX
    task loss with its sown aux summed over the valid ticks only (the
    bubble entries masked out), clipped at the global norm as both
    trainers clip: within rel 1e-4, atol 1e-5·max|g| (the 1F1B-against-
    GPipe bound of tests/test_pipeline.py)."""
    from kubeflow_tpu.training import tasks as jtasks
    from kubeflow_tpu_torch.models.convert import params_from_jax
    from kubeflow_tpu_torch.training.trainer import MAX_GRAD_NORM

    job = f"bert_tiny_moe/p2e2/{schedule}"
    outs, dirs = gangs(4)
    data, ckpt = data_and_init("bert_tiny_moe", devices8)
    jtr, _ = _jax_trainer("bert_tiny_moe", "p2", "gpipe", data, devices8)
    state = JCheckpointManager(ckpt).restore(jtr.init_state(), step=0)
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    batch = {k: jnp.asarray(v) for k, v in train.batch_at(0).items()}
    monkeypatch.setattr(jtasks, "_sown_loss_sum", _valid_sown_sum)
    grads = jax.grad(lambda p: jtr.task.loss(
        jtr.model, p, state.extra_vars, batch, False, None)[0])(state.params)
    whole = {n: t.numpy() for n, t in params_from_jax(grads).items()}
    norm = np.sqrt(sum(float(np.square(g, dtype=np.float64).sum())
                       for g in whole.values()))
    if norm >= MAX_GRAD_NORM:
        whole = {n: g / norm * MAX_GRAD_NORM for n, g in whole.items()}
    gmax = max(float(np.abs(g).max()) for g in whole.values())
    experts = get_model("bert_tiny_moe", device="meta").cfg.num_experts
    seen = set()
    for o in outs:
        coords = o["jobs"][job]["coords"]
        got = np.load(f"{dirs[job]}/final.grads.{o['rank']}.npz")
        for name in got.files:
            want = whole[name]
            if name.endswith(("moe.wi", "moe.wo")):
                n = experts // MESHES["p2e2"]["expert"]
                want = want[coords["expert"] * n:(coords["expert"] + 1) * n]
            np.testing.assert_allclose(got[name], want, rtol=1e-4,
                                       atol=1e-5 * gmax,
                                       err_msg=f"rank {o['rank']} {name}")
            seen.add(name)
    # every leaf held by some stage, the routers of both stages included
    assert seen == set(whole)
    assert {n for n in seen if n.endswith("moe.router")} == {
        f"layers.{i}.moe.router" for i in range(STAGES)}


def test_the_jax_bubble_aux_differs_between_schedules_the_ports_does_not(
        gangs, jax_runs):
    """The JAX reference's bubble ticks sow constants: its gpipe and 1f1b
    aux differ on the same weights (1f1b pads its last segment); the
    port's aux and losses are the same under both schedules."""
    outs, _ = gangs(4)
    jg = jax_runs("bert_tiny_moe", "p2e2", "gpipe")
    j1 = jax_runs("bert_tiny_moe", "p2e2", "1f1b")
    assert jg[1][0] != pytest.approx(j1[1][0], rel=1e-3)
    np.testing.assert_allclose([v for v, _ in jg[2]][:1],
                               [v for v, _ in j1[2]][:1], rtol=LOSS_REL)
    g = outs[0]["jobs"]["bert_tiny_moe/p2e2/gpipe"]
    o = outs[0]["jobs"]["bert_tiny_moe/p2e2/1f1b"]
    np.testing.assert_allclose(o["aux"], g["aux"], rtol=LOSS_REL)
    np.testing.assert_allclose(_losses(o), _losses(g), rtol=LOSS_REL)


@pytest.mark.parametrize("world,model", [(2, "gpt_tiny"), (2, "bert_tiny"),
                                         (4, "gpt_tiny"), (4, "bert_tiny")])
def test_1f1b_equals_gpipe(gangs, world, model):
    """tests/test_pipeline.py test_1f1b_matches_gpipe on the gangs: the
    same losses (rel 1e-5) and each rank's first-step gradients within
    rel 1e-4, atol 1e-5·max|g| of GPipe's."""
    outs, dirs = gangs(world)
    mesh = "p2" if world == 2 else "d2p2"
    g, o = f"{model}/{mesh}/gpipe", f"{model}/{mesh}/1f1b"
    np.testing.assert_allclose(_losses(outs[0]["jobs"][o]),
                               _losses(outs[0]["jobs"][g]), rtol=1e-5)
    for rank in range(world):
        a = np.load(f"{dirs[g]}/final.grads.{rank}.npz")
        b = np.load(f"{dirs[o]}/final.grads.{rank}.npz")
        gmax = max(float(np.abs(a[k]).max()) for k in a.files)
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4,
                                       atol=1e-5 * gmax, err_msg=k)


def test_a_model_without_stages_raises_type_error_in_a_gang(gangs):
    """tests/test_pipeline.py test_unsupported_model_raises on its mesh:
    the trainer of a gang of 2 builds the mlp on `{pipeline: 2}` with the
    pipeline kwargs it passes every factory, and the mlp's factory raises
    TypeError on them, on every rank."""
    outs, _ = gangs(2)
    for o in outs:
        res = o["jobs"]["refused/mlp"]
        assert res["refused"] == "TypeError", res
        assert "pipeline_stages" in res["message"]


def test_1f1b_bounds_each_stages_live_activations(gangs):
    """S = 4, M = 16, the executed schedule: stage s's live microbatches
    peak at S − s under 1F1B, at M under GPipe; the losses agree."""
    outs, _ = gangs(4)
    by_stage = {o["jobs"]["live/1f1b"]["coords"]["pipeline"]: o
                for o in outs}
    assert [by_stage[s]["jobs"]["live/1f1b"]["live"]
            for s in range(LIVE_S)] == [LIVE_S - s for s in range(LIVE_S)]
    assert [by_stage[s]["jobs"]["live/gpipe"]["live"]
            for s in range(LIVE_S)] == [LIVE_M] * LIVE_S
    np.testing.assert_allclose(_losses(outs[0]["jobs"]["live/1f1b"]),
                               _losses(outs[0]["jobs"]["live/gpipe"]),
                               rtol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_each_stage_runs_every_microbatch_once_each_way(gangs, schedule):
    """The executed schedule (S = 4, M = 16): each stage runs every
    microbatch's forward once and its backward once after it, the
    backwards in microbatch order under both schedules (the gradients
    accumulate in the same order), and its first backward after M
    forwards under GPipe, after S − s under 1F1B."""
    outs, _ = gangs(4)
    for o in outs:
        res = o["jobs"][f"live/{schedule}"]
        s = res["coords"]["pipeline"]
        order = [tuple(a) for a in res["order"]]
        fwd = [m for k, m in order if k == "F"]
        bwd = [m for k, m in order if k == "B"]
        assert fwd == bwd == list(range(LIVE_M)), (s, order)
        assert all(order.index(("F", m)) < order.index(("B", m))
                   for m in range(LIVE_M))
        first_b = order.index(("B", 0))
        assert first_b == (LIVE_M if schedule == "gpipe" else LIVE_S - s)


def test_each_rank_holds_its_stage_only(gangs):
    """A rank's parameters are its stage's layers (flat names), plus the
    embeddings on stage 0 and the final LayerNorm and head (BERT: the MLM
    and NSP heads) on the last; together the stages hold world 1's leaves
    once each."""
    for world in (4, 2):
        outs, _ = gangs(world)
        for job, (name, _, _) in JOBS[world].items():
            whole = set(get_model(name, device="meta").state_dict())
            by_stage = {}
            for o in outs:
                res = o["jobs"][job]
                by_stage.setdefault(res["coords"]["pipeline"],
                                    set(res["names"]))
                assert set(res["names"]) == by_stage[
                    res["coords"]["pipeline"]]
            model = get_model(name, device="meta")
            for s, names in by_stage.items():
                assert {int(n.split(".")[1]) for n in names
                        if n.startswith("layers.")} == {s}, (job, s)
                tops = {n.split(".")[0] for n in names} - {"layers"}
                assert tops == set(model.FIRST_STAGE if s == 0
                                   else model.LAST_STAGE), (job, s)
            assert set().union(*by_stage.values()) == whole
            assert sum(map(len, by_stage.values())) == len(whole)


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_the_ranks_flops_sum_to_world_1s(gangs, world, job):
    name, _, _ = JOBS[world][job]
    outs, _ = gangs(world)
    count = lm_train_flops if name.startswith("gpt") else encoder_train_flops
    mcfg = get_model(name, device="meta").cfg
    np.testing.assert_allclose(sum(o["jobs"][job]["flops"] for o in outs),
                               count(mcfg, BATCH, SEQ), rtol=1e-12)


def test_pipelined_dropout_is_world_1s(gangs, data_and_init, devices8):
    """With dropout and remat, each stage draws its microbatches' rows of
    the masks a world-1 run draws (its generator advanced past the
    earlier stages' layers): the gang's losses are a world-1 port run's."""
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    outs, _ = gangs(4)
    data, _ = data_and_init("gpt_tiny", devices8)
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, remat=True,
                                    checkpoint={"enabled": False}))
    trainer = Trainer(cfg, device="cpu",
                      model_kwargs={"dropout_rate": DROPOUT})
    res = run_training(cfg, device="cpu", trainer=trainer, log_every=1)
    gang = _losses(outs[0]["jobs"]["dropout"])
    assert all(_losses(o["jobs"]["dropout"]) == gang for o in outs)
    np.testing.assert_allclose(gang, [loss for _, loss in res["losses"]],
                               rtol=LOSS_REL)
    # and dropout is on: the same run without it trains elsewhere
    plain = _losses(outs[0]["jobs"]["gpt_tiny/d2p2/1f1b"])
    assert gang[0] != pytest.approx(plain[0], rel=1e-3)


def test_accumulation_over_a_pipeline_is_world_1s(gangs, data_and_init,
                                                  devices8):
    """accum_steps = 2 on `{pipeline: 2}` (each accumulation microbatch cut
    into the pipeline's microbatches, weighted by its global valid pairs)
    gives a world-1 port run's losses with the same accumulation."""
    from kubeflow_tpu_torch.runtime.train_run import run_training

    outs, _ = gangs(2)
    data, _ = data_and_init("gpt_tiny", devices8)
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, accum_steps=ACCUM,
                                    checkpoint={"enabled": False}))
    res = run_training(cfg, device="cpu", log_every=1)
    gang = _losses(outs[0]["jobs"]["accum"])
    assert all(_losses(o["jobs"]["accum"]) == gang for o in outs)
    np.testing.assert_allclose(gang, [loss for _, loss in res["losses"]],
                               rtol=LOSS_REL)


@pytest.mark.parametrize("name", ["gpt_tiny", "bert_tiny"])
def test_evaluation_runs_through_the_stages(gangs, data_and_init, devices8,
                                            name):
    """The end-of-run eval over a held-out split, a forward-only pass
    through the stages (its sums on the last stage, summed over the
    pipeline), gives a world-1 port run's eval loss and top-1."""
    from kubeflow_tpu_torch.runtime.train_run import run_training

    outs, _ = gangs(2)
    data, _ = data_and_init(name, devices8)
    cfg = TrainingConfig(**cfg_dict(name, dict(
        data, eval_fraction=EVAL_FRACTION), checkpoint={"enabled": False}))
    want = run_training(cfg, device="cpu", log_every=1)
    for o in outs:
        got = o["jobs"][f"eval/{name}"]["result"]
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=LOSS_REL)
        assert got["eval_top1"] == pytest.approx(want["eval_top1"],
                                                 rel=LOSS_REL)
        np.testing.assert_allclose(_losses(o["jobs"][f"eval/{name}"]),
                                   [loss for _, loss in want["losses"]],
                                   rtol=LOSS_REL)


def _only_step(src, dst, step):
    shutil.copytree(src, dst)
    for s in layout.committed_steps(dst):
        if s != step:
            shutil.rmtree(layout.step_dir(dst, s))
    return dst


def test_a_pipeline_gangs_checkpoint_restores_at_world_1_and_in_jax(
        gangs, data_and_init, devices8, tmp_path):
    """The `{data: 2, pipeline: 2}` gang's checkpoints: the JAX pipelined
    trainer's manifest keys and shapes (each stacked layer leaf written as
    2 stage blocks, each owned leaf as one block); the final one restores
    at world 1 with its layers the ranks' blocks joined, bit for bit; the
    step-2 one resumes at world 1 (without stages) and in the JAX trainer
    to the gang's own step-3 and step-4 losses."""
    from kubeflow_tpu_torch.checkpointing import restore_latest
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    outs, dirs = gangs(4)
    ckpt = dirs["ckpt"]
    gang_losses = _losses(outs[0]["jobs"]["ckpt"])
    assert layout.committed_steps(ckpt) == [0, CKPT_SAVE, CKPT_STEPS]
    data, step0 = data_and_init("gpt_tiny", devices8)
    jax_keys = {e["key"]: e["shape"] for e in layout.read_manifest(
        layout.step_dir(step0, 0))["leaves"]}
    manifest = layout.read_manifest(layout.step_dir(ckpt, CKPT_SAVE))
    assert manifest["process_count"] == 4
    assert {e["key"]: e["shape"] for e in manifest["leaves"]} == jax_keys
    for e in manifest["leaves"]:
        stacked = "/stages/" in e["key"]
        assert len(e["shards"]) == (STAGES if stacked else 1), e["key"]
        if stacked:
            assert e["shape"][0] == STAGES
    # the final checkpoint at world 1 without stages: the blocks joined
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": ckpt}))
    state = restore_latest(ckpt, Trainer(cfg, device="cpu").init_state())
    assert state.step == CKPT_STEPS
    params = dict(state.model.named_parameters())
    seen = set()
    for rank in range(4):
        blocks = np.load(f"{dirs['ckpt']}/final.{rank}.npz")
        for key in blocks.files:
            np.testing.assert_array_equal(params[key].detach().numpy(),
                                          blocks[key], err_msg=key)
            seen.add(key)
    assert seen == set(params)
    # the step-2 checkpoint resumes at world 1
    only = _only_step(ckpt, str(tmp_path / "w1"), CKPT_SAVE)
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": only,
                                                "async_save": False}))
    res = run_training(cfg, restore=True, device="cpu", log_every=1)
    assert [s for s, _ in res["losses"]] == [3, 4]
    np.testing.assert_allclose([loss for _, loss in res["losses"]],
                               gang_losses[CKPT_SAVE:], rtol=LOSS_REL)
    # and in the JAX package on the gang's mesh
    jtr, jmesh = _jax_trainer("gpt_tiny", "d2p2", "1f1b", data, devices8,
                              steps=CKPT_STEPS)
    jstate = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                              step=CKPT_SAVE)
    assert int(jax.device_get(jstate.step)) == CKPT_SAVE
    _, jlosses, _, _ = _jax_steps(jtr, jmesh, jstate, CKPT_SAVE, CKPT_STEPS)
    np.testing.assert_allclose(jlosses, gang_losses[CKPT_SAVE:],
                               rtol=LOSS_REL)


def test_chip_smoke_phase_21_rehearsal(tmp_path):
    """Phases 19-21, 23 and 25 of chip_smoke.py on the CPU at gpt_tiny
    size, with the gangs main runs (`phase_gangs`: one pair of ranks
    running 19a, 19b, 25a, 25c and 20b in turn, one quartet 21a, 21b, 23a,
    23b, 25b and 20a, the two at once): 21a's `{pipeline: 4}` gang
    against world 1 (losses,
    each rank's parameter bytes by the formula, the stage blocks joined
    against world 1's weights), 21b's live counters under both schedules,
    21c's checkpoint restored at world 1 (the blocks joined, bit for
    bit); 23a's `{fsdp: 4}` and 23b's `{data: 2, fsdp: 2}` against world
    1 (losses, a rank's bytes by the specs' formula, the collectives'
    formulas, rank 0's gathered weights against world 1's), 23c's
    checkpoint restored at world 1 (the blocks joined, bit for bit); 25a's
    `{tensor: 2}`, 25b's `{data: 2, tensor: 2}` (against 23's world 1,
    the same cell) and 25c's bert_tiny `{tensor: 2}` against world 1
    (losses, replicated leaves, a rank's bytes by the specs' formula, the
    all-reduces' formulas, rank 0's joined weights against world 1's); 19
    and 20 read off the shared gangs as their own rehearsals hold them."""
    launches = rehearse_smoke(tmp_path, seq=SMOKE_SEQ, expert=SMOKE_EXPERT,
                              pipeline=SMOKE_PIPELINE, fsdp=SMOKE_FSDP,
                              tensor=SMOKE_TENSOR)
    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert launches == {"seq": zero, "expert": zero, "pipeline": zero,
                        "fsdp": zero, "tensor": {"25a": zero, "25b": zero,
                                                 "25c": zero}}
