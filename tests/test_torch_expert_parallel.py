"""The port's expert-parallel training (the trainer on an `expert` mesh
axis: each rank holds E/ep experts of every MoE stack and of its AdamW
moments, the partial outputs summed over the expert axis, the clip's norm
over the blocks, shard-writing checkpoints) and MoE under a sequence axis
(the router logits gathered over the ring, each rank routing the whole
row), against the JAX `Trainer` on the same mesh, on the CPU in f32.

Port gangs of 4 and 2 gloo ranks (tests/torch_gangs.py), one gang a size
running every job, train gpt_tiny_moe and bert_tiny_moe (and bert_tiny_moe
at top-2, and the dense gpt_tiny as replicas) for 3 steps from the JAX
trainer's own init (its step-0 checkpoint, restored by every rank), on
the same `.npy` batches as the JAX trainer (tests/
test_torch_data_parallel.py's data): `{data: 2, expert: 2}`, `{expert:
4}` and `{sequence: 2, expert: 2}` at world 4, `{expert: 2}` and
`{sequence: 2}` (ring, and Ulysses for gpt) at world 2. The JAX trainer
runs each on the same mesh of the conftest's 8 CPU devices. Bounds:
losses and `moe_aux_loss` within rel 1e-5 (f32; the frameworks and the
gang sum in other orders), every rank's losses bit for bit equal, and the
replicated leaves bit for bit equal across the ranks. Each rank holds E/ep
rows of every stack and of its moments, and the blocks joined after the
steps are the JAX trainer's stacks (rel 1e-5 of the stack's norm). A
gang's checkpoint restores at world 1 (its stacks are the ranks' blocks
joined, bit for bit) and in the JAX package, and both resume to the
gang's own losses. The ranks' FLOP counts sum to world 1's. The last test
rehearses chip_smoke.py's phase 20 at gpt_tiny_moe size.
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
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    TrainingConfig,
)
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.layers import MoeMlp  # noqa: E402
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
)
from kubeflow_tpu_torch.parallel.distributed import (  # noqa: E402
    copy_to_group,
    reduce_from_group,
)
from kubeflow_tpu_torch.parallel.mesh import ExpertShard  # noqa: E402
from test_torch_data_parallel import (  # noqa: E402
    BATCH,
    LOSS_REL,
    SEQ,
    STEPS,
    VOCAB,
    write_token_data,
)
from torch_gangs import (  # noqa: E402
    REPO,
    SMOKE_EXPERT,
    rehearse_smoke,
    run_gang,
)

# model → (TrainingConfig fields, the data stream)
MODELS = {
    "gpt_tiny_moe": (dict(model="gpt_tiny_moe", learning_rate=1e-3,
                          weight_decay=0.1), "lm"),
    "bert_tiny_moe": (dict(model="bert_tiny_moe", learning_rate=1e-3,
                           weight_decay=0.1), "mlm"),
    "gpt_tiny": (dict(model="gpt_tiny", learning_rate=1e-3,
                      weight_decay=0.1), "lm"),
}
MESHES = {"d2e2": {"data": 2, "expert": 2}, "e4": {"expert": 4},
          "s2e2": {"sequence": 2, "expert": 2}, "e2": {"expert": 2},
          "s2": {"sequence": 2}}
# job name → (model, mesh, attention (None: the trainer's), top-k)
JOBS = {
    4: {
        "gpt_tiny_moe/d2e2": ("gpt_tiny_moe", "d2e2", None, 1),
        "gpt_tiny_moe/e4": ("gpt_tiny_moe", "e4", None, 1),
        "bert_tiny_moe/d2e2": ("bert_tiny_moe", "d2e2", None, 1),
        "bert_tiny_moe/e4": ("bert_tiny_moe", "e4", None, 1),
        # tests/test_moe.py TestTopKRouting::test_top2_model_trains_ep
        "bert_tiny_moe/d2e2/top2": ("bert_tiny_moe", "d2e2", None, 2),
        "gpt_tiny_moe/s2e2": ("gpt_tiny_moe", "s2e2", "ring", 1),
        # a dense model on an expert axis: replicas
        "gpt_tiny/d2e2": ("gpt_tiny", "d2e2", None, 1),
    },
    2: {
        "gpt_tiny_moe/e2": ("gpt_tiny_moe", "e2", None, 1),
        "gpt_tiny_moe/s2": ("gpt_tiny_moe", "s2", None, 1),
        "gpt_tiny_moe/s2/ulysses": ("gpt_tiny_moe", "s2", "ulysses", 1),
        "bert_tiny_moe/s2": ("bert_tiny_moe", "s2", None, 1),
    },
}
# the checkpoint job: gpt_tiny_moe on d2e2 saving at step 2 of 4
CKPT_STEPS, CKPT_SAVE = 4, 2
STACKS = ("wi", "wo")

# One rank: the expert axis's pair of collectives on the world group,
# then every job of the gang in turn, each a fresh Trainer restored from
# the job's copy of the JAX step-0 checkpoint by `run_training`.
WORKER = r'''
import hashlib, json, os
import numpy as np
import torch


def collectives():
    """copy_to_group and reduce_from_group over the world: rank r's
    input (r + 1) * [1, 2, 3], its loss weight r + 1."""
    from kubeflow_tpu_torch.parallel.distributed import (
        copy_to_group, reduce_from_group)

    r = torch.distributed.get_rank()
    out = {}
    for name, fn in (("copy", copy_to_group), ("reduce", reduce_from_group)):
        x = (torch.tensor([1.0, 2.0, 3.0]) * (r + 1)).requires_grad_()
        y = fn(x, torch.distributed.group.WORLD)
        (y * (r + 1)).sum().backward()
        out[name] = {"y": y.tolist(), "grad": x.grad.tolist()}
    return out


def recompute_outside_the_step():
    """gpt_tiny_moe under remat on a ring of the world: the backward run
    inside the step's `sequence_parallel` and outside it (as autograd's
    device thread runs a CUDA backward, where the context is not set)
    give the same gradients: the remat recompute routes the whole row
    either way."""
    from kubeflow_tpu_torch.models.layers import MoeCollector
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel.mesh import (
        SequenceShard, sequence_parallel)

    shard = SequenceShard(torch.distributed.group.WORLD,
                          torch.distributed.get_rank(),
                          torch.distributed.get_world_size())
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(shard.rank))
    grads = []
    for inside in (True, False):
        model = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32,
                          remat=True, attention_impl="ring").trainable()
        moe = MoeCollector()
        with sequence_parallel(shard):
            loss = model(ids, moe=moe).sum() + moe.aux_loss(shard.group)
            if inside:
                loss.backward()
        if not inside:
            loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    return all(torch.equal(a, b) for a, b in zip(*grads))


def run_job(job):
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.layers import EXPERT_STACKS, MoeMlp
    from kubeflow_tpu_torch.parallel.sharding import param_specs
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.annotations import logical_axes_for
    from kubeflow_tpu_torch.training.datasets import build_data
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig.from_dict(job["cfg"])
    trainer = Trainer(cfg, device="cpu", model_kwargs=job.get("model_kw"))
    aux = []
    step = trainer.train_step

    def train_step(state, batch):
        state, metrics = step(state, batch)
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
        return state, metrics

    trainer.train_step = train_step
    data, _ = build_data(cfg, trainer.task)
    local = trainer.local_batch(data.batch_at(0))
    res = run_training(cfg, restore=True, device="cpu", trainer=trainer,
                       log_every=1)
    state = trainer._final_state
    opt = state.optimizer
    rows, stacks, digests = {}, {}, {}
    for name, p in state.model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if isinstance(state.model.get_submodule(owner), MoeMlp) \
                and leaf in EXPERT_STACKS:
            st = opt.state[p]
            rows[name] = [p.shape[0], st["exp_avg"].shape[0],
                          st["exp_avg_sq"].shape[0]]
            stacks[name] = p.detach().numpy()
        else:
            digests[name] = hashlib.sha256(
                p.detach().numpy().tobytes()).hexdigest()
    rank = torch.distributed.get_rank()
    if job.get("out"):
        np.savez(f"{job['out']}.{rank}.npz", **stacks)
    sizes = dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
    specs = param_specs(logical_axes_for(state.model,
                                         mesh_axis_sizes=sizes), mesh=sizes)
    return {"result": res, "aux": aux, "rows": rows, "digests": digests,
            "specs": {k: [list(a) if isinstance(a, tuple) else a for a in v]
                      for k, v in specs.items()},
            "flops": trainer.rank_flops(local),
            "coords": {a: trainer.mesh.get_local_rank(a)
                       for a in ("data", "expert", "sequence")},
            "attention": trainer.model.cfg.attention_impl}


def main():
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    jobs = json.loads(os.environ["KFT_TEST_JOB"])["jobs"]
    out = {"rank": rank(), "collectives": collectives(),
           "recompute": recompute_outside_the_step(),
           "jobs": {name: run_job(job) for name, job in jobs.items()}}
    shutdown()
    print("RESULT " + json.dumps(out), flush=True)
'''


def cfg_dict(name, data, steps=STEPS, **over):
    return {**MODELS[name][0], "global_batch_size": BATCH, "steps": steps,
            "warmup_steps": 1, "dtype": "float32", "seed": 0, "data": data,
            **over}


def _jax_trainer(name, mesh, impl, top_k, data, devices, steps=STEPS):
    """The JAX trainer of one job on the job's own mesh."""
    fields = {k: v for k, v in cfg_dict(name, data, steps=steps).items()
              if k != "data"}
    cfg = JTrainingConfig(mesh=JMeshConfig(**MESHES[mesh]),
                          data=JDataConfig(**data), **fields)
    jmesh = mesh_from_config(cfg.mesh,
                             devices=devices[:cfg.mesh.num_devices])
    kwargs = {}
    if cfg.mesh.sequence > 1:
        kwargs["attention_impl"] = impl or "ring"
    if top_k > 1:
        kwargs["moe_top_k"] = top_k
    task_cls = JCausalLmTask if name.startswith("gpt") else JMlmTask
    model = jget_model(name, dtype=jnp.float32, **kwargs)
    task = task_cls(cfg, seq_len=SEQ, vocab_size=VOCAB)
    return JTrainer(cfg, mesh=jmesh, model=model, task=task), jmesh


def _jax_steps(jtr, jmesh, state, first, last):
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    losses, aux = [], []
    for i in range(first, last):
        state, m = jtr.train_step(state, make_global_batch(train.batch_at(i),
                                                           jmesh),
                                  jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
        if "moe_aux_loss" in m:
            aux.append(float(m["moe_aux_loss"]))
    return state, losses, aux


@pytest.fixture(scope="module")
def data_and_init(tmp_path_factory):
    """{model: (data config, the JAX step-0 checkpoint)}, made once."""
    out = {}

    def get(name, devices):
        if name not in out:
            root = tmp_path_factory.mktemp(f"jax_{name}")
            data = {"name": "npz",
                    "path": write_token_data(str(root / "data"),
                                             MODELS[name][1])}
            jtr, _ = _jax_trainer(name, "e2", None, 1, data, devices)
            ckpt = str(root / "step0")
            with JCheckpointManager(ckpt, async_save=False) as mgr:
                mgr.save(0, jtr.init_state(), force=True)
            out[name] = (data, ckpt)
        return out[name]

    return get


@pytest.fixture(scope="module")
def jax_runs(data_and_init, devices8):
    """(model, mesh, top-k) → the JAX trainer's 3 steps from the step-0
    checkpoint: (losses, aux losses, final stacks), each run once. A
    sequence axis runs the JAX ring: Ulysses computes the same
    function."""
    done = {}

    def get(name, mesh, top_k):
        key = (name, mesh, top_k)
        if key not in done:
            data, ckpt = data_and_init(name, devices8)
            jtr, jmesh = _jax_trainer(name, mesh, None, top_k, data,
                                      devices8)
            state = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                                     step=0)
            state, losses, aux = _jax_steps(jtr, jmesh, state, 0, STEPS)
            params = params_from_jax(jax.tree.map(np.asarray, state.params))
            done[key] = (losses, aux, {
                k: v.numpy() for k, v in params.items()
                if k.endswith(tuple(f"moe.{s}" for s in STACKS))})
        return done[key]

    return get


def _job(data, ckpt, root, job, name, mesh, impl, top_k, steps=STEPS,
         **ckpt_kw):
    own = str(root / job.replace("/", "-"))
    shutil.copytree(ckpt, own)
    over = {} if impl is None else {"attention_impl": impl}
    cfg = cfg_dict(name, data, steps=steps, mesh=MESHES[mesh], checkpoint={
        "directory": own, "async_save": False, **ckpt_kw}, **over)
    out = {"cfg": cfg, "out": own + "/blocks"}
    if top_k > 1:
        out["model_kw"] = {"moe_top_k": top_k}
    return out


@pytest.fixture(scope="module")
def gangs(data_and_init, devices8, tmp_path_factory):
    """world → (rank outputs, {job: its directory}), each gang started
    once."""
    done = {}

    def start(world):
        if world in done:
            return done[world]
        root = tmp_path_factory.mktemp(f"ep{world}")
        jobs, dirs = {}, {}
        for job, (name, mesh, impl, top_k) in JOBS[world].items():
            data, ckpt = data_and_init(name, devices8)
            jobs[job] = _job(data, ckpt, root, job, name, mesh, impl, top_k)
            dirs[job] = jobs[job]["cfg"]["checkpoint"]["directory"]
        if world == 4:
            data, ckpt = data_and_init("gpt_tiny_moe", devices8)
            jobs["ckpt"] = _job(data, ckpt, root, "ckpt", "gpt_tiny_moe",
                                "d2e2", None, 1, steps=CKPT_STEPS,
                                interval_steps=CKPT_SAVE, keep=10)
            dirs["ckpt"] = jobs["ckpt"]["cfg"]["checkpoint"]["directory"]
        done[world] = (run_gang(WORKER, {"jobs": jobs}, world,
                                name=f"ep-test-{world}"), dirs)
        return done[world]

    return start


def _losses(res):
    return [loss for _, loss in res["result"]["losses"]]


def _cases():
    return [(world, job) for world in sorted(JOBS) for job in JOBS[world]]


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_an_expert_gang_equals_the_jax_trainer_on_its_mesh(gangs, jax_runs,
                                                           world, job):
    name, mesh, impl, top_k = JOBS[world][job]
    outs, _ = gangs(world)
    jlosses, jaux, _ = jax_runs(name, mesh, top_k)
    results = [o["jobs"][job] for o in outs]
    for res in results:
        assert res["result"]["world_size"] == world
        assert res["result"]["final_step"] == STEPS
        # the ranks agree on every step's loss and aux loss, bit for bit
        assert _losses(res) == _losses(results[0])
        assert res["aux"] == results[0]["aux"]
        # and on every replicated leaf
        assert res["digests"] == results[0]["digests"]
        if impl is not None:
            assert res["attention"] == impl
    np.testing.assert_allclose(_losses(results[0]), jlosses, rtol=LOSS_REL)
    if name.endswith("_moe"):
        assert len(results[0]["aux"]) == STEPS
        np.testing.assert_allclose(results[0]["aux"], jaux, rtol=LOSS_REL)


def _expert_jobs():
    return [(world, job) for world, job in _cases()
            if JOBS[world][job][0].endswith("_moe")
            and MESHES[JOBS[world][job][1]].get("expert", 1) > 1]


@pytest.mark.parametrize("world,job", _expert_jobs(),
                         ids=[f"w{w}-{j}" for w, j in _expert_jobs()])
def test_each_rank_holds_its_block_of_every_stack(gangs, jax_runs, world,
                                                  job):
    """E/ep rows of every stack and of its AdamW moments a rank, `expert`
    on the stacks' specs and nothing on the router (tests/test_moe.py
    test_expert_weights_sharded_on_expert_axis), and the blocks joined
    in expert order equal the JAX trainer's stacks (rel 1e-5 of each
    stack's norm)."""
    name, mesh, impl, top_k = JOBS[world][job]
    outs, dirs = gangs(world)
    ep = MESHES[mesh]["expert"]
    experts = get_model(name, device="meta").cfg.num_experts
    _, _, jstacks = jax_runs(name, mesh, top_k)
    by_expert = {}
    for rank, o in enumerate(outs):
        res = o["jobs"][job]
        assert res["rows"] and all(r == [experts // ep] * 3
                                   for r in res["rows"].values())
        for key, spec in res["specs"].items():
            if key.endswith(tuple(f"moe.{s}" for s in STACKS)):
                assert spec == ["expert"], key
            else:
                assert all(a is None for a in spec), key
        by_expert.setdefault(res["coords"]["expert"], rank)
    blocks = [np.load(f"{dirs[job]}/blocks.{by_expert[x]}.npz")
              for x in range(ep)]
    assert set(jstacks) == set(blocks[0].files)
    for key, want in jstacks.items():
        got = np.concatenate([b[key] for b in blocks])
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LOSS_REL, (key, rel)


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_the_ranks_flops_sum_to_world_1s(gangs, world, job):
    """Summed over the expert axis, then the data (and sequence) axes, the
    ranks' FLOP counts are world 1's count of the step."""
    name, mesh, _, top_k = JOBS[world][job]
    outs, _ = gangs(world)
    mcfg = get_model(name, device="meta", moe_top_k=top_k).cfg if \
        name.endswith("_moe") else get_model(name, device="meta").cfg
    count = lm_train_flops if name.startswith("gpt") else encoder_train_flops
    per_shard = {}
    for o in outs:
        c = o["jobs"][job]["coords"]
        key = (c["data"], c["sequence"])
        per_shard[key] = per_shard.get(key, 0.0) + o["jobs"][job]["flops"]
    np.testing.assert_allclose(sum(per_shard.values()),
                               count(mcfg, BATCH, SEQ), rtol=1e-12)


def test_the_collectives_sum_the_other_way(gangs):
    """copy_to_group: forward unchanged, backward summed over the group;
    reduce_from_group: forward summed, backward unchanged (rank r's input
    (r + 1)·[1, 2, 3], its loss weight r + 1)."""
    outs, _ = gangs(2)
    base = np.array([1.0, 2.0, 3.0])
    for r, o in enumerate(outs):
        c = o["collectives"]
        np.testing.assert_array_equal(c["copy"]["y"], base * (r + 1))
        np.testing.assert_array_equal(c["copy"]["grad"], [1.0 + 2.0] * 3)
        np.testing.assert_array_equal(c["reduce"]["y"], base * (1 + 2))
        np.testing.assert_array_equal(c["reduce"]["grad"], [r + 1.0] * 3)


def test_a_remat_recompute_outside_the_step_routes_whole_rows(gangs):
    """A CUDA backward runs on autograd's device thread, outside the
    step's `sequence_parallel`: the MoE layers take the forward's shard
    from the call's context, so the recompute routes the whole row and
    the gradients equal those of a backward inside the context."""
    outs, _ = gangs(2)
    assert all(o["recompute"] for o in outs)


def _only_step(src, dst, step):
    shutil.copytree(src, dst)
    for s in layout.committed_steps(dst):
        if s != step:
            shutil.rmtree(layout.step_dir(dst, s))
    return dst


def test_an_expert_gangs_checkpoint_restores_at_world_1_and_in_jax(
        gangs, data_and_init, devices8, tmp_path):
    """The `{data: 2, expert: 2}` gang's checkpoints (each stack written as
    2 blocks by the 2 data-rank-0 writers): the final one restores at
    world 1 with its stacks the ranks' blocks joined, bit for bit; the
    step-2 one resumes at world 1 and in the JAX trainer to the gang's
    own step-3 and step-4 losses."""
    outs, dirs = gangs(4)
    ckpt = dirs["ckpt"]
    gang_losses = _losses(outs[0]["jobs"]["ckpt"])
    assert layout.committed_steps(ckpt) == [0, CKPT_SAVE, CKPT_STEPS]
    manifest = layout.read_manifest(layout.step_dir(ckpt, CKPT_SAVE))
    assert manifest["process_count"] == 4
    leaves = {e["key"]: e for e in manifest["leaves"]}
    for key, entry in leaves.items():
        stack = key.endswith(("/moe/wi", "/moe/wo"))
        assert len(entry["shards"]) == (2 if stack else 1), key
        if stack:
            assert entry["shape"][0] == 4
            assert [s["index"][0] for s in entry["shards"]] == [[0, 2],
                                                                [2, 4]]
    data, _ = data_and_init("gpt_tiny_moe", devices8)
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    # the final checkpoint at world 1: the blocks joined, bit for bit
    cfg = TrainingConfig(**cfg_dict("gpt_tiny_moe", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": ckpt}))
    trainer = Trainer(cfg, device="cpu")
    from kubeflow_tpu_torch.checkpointing import restore_latest

    state = restore_latest(ckpt, trainer.init_state())
    assert state.step == CKPT_STEPS
    by_expert = {}
    for rank, o in enumerate(outs):
        by_expert.setdefault(o["jobs"]["ckpt"]["coords"]["expert"], rank)
    blocks = [np.load(f"{dirs['ckpt']}/blocks.{by_expert[x]}.npz")
              for x in range(2)]
    params = dict(state.model.named_parameters())
    for key in blocks[0].files:
        np.testing.assert_array_equal(
            params[key].detach().numpy(),
            np.concatenate([b[key] for b in blocks]), err_msg=key)
    for p in params.values():
        assert state.optimizer.state[p]["exp_avg"].shape == p.shape
    # the step-2 checkpoint resumes at world 1
    only = _only_step(ckpt, str(tmp_path / "w1"), CKPT_SAVE)
    cfg = TrainingConfig(**cfg_dict("gpt_tiny_moe", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": only,
                                                "async_save": False}))
    res = run_training(cfg, restore=True, device="cpu", log_every=1)
    assert [s for s, _ in res["losses"]] == [3, 4]
    np.testing.assert_allclose([loss for _, loss in res["losses"]],
                               gang_losses[CKPT_SAVE:], rtol=LOSS_REL)
    # and in the JAX package on the gang's mesh
    jtr, jmesh = _jax_trainer("gpt_tiny_moe", "d2e2", None, 1, data,
                              devices8, steps=CKPT_STEPS)
    jstate = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                              step=CKPT_SAVE)
    assert int(jax.device_get(jstate.step)) == CKPT_SAVE
    _, jlosses, _ = _jax_steps(jtr, jmesh, jstate, CKPT_SAVE, CKPT_STEPS)
    np.testing.assert_allclose(jlosses, gang_losses[CKPT_SAVE:],
                               rtol=LOSS_REL)


def test_the_moe_config_loads_as_it_is():
    """configs/gpt_moe_v5e16.yaml's training block loads unedited; an
    expert axis that does not divide the experts raises naming both
    numbers; the pipeline config loads unedited too (its axis is
    ported)."""
    import yaml

    with open(os.path.join(REPO, "configs", "gpt_moe_v5e16.yaml")) as f:
        spec = yaml.safe_load(f)
    cfg = TrainingConfig.from_dict(spec["training"])
    assert (cfg.mesh.data, cfg.mesh.expert) == (8, 4)
    assert cfg.mesh.num_devices == 32
    with pytest.raises(ConfigError, match="4 experts do not divide over "
                                          "the expert mesh axis 3"):
        TrainingConfig(model="gpt_tiny_moe", mesh={"expert": 3})
    # a dense model on an expert axis: replicas
    assert TrainingConfig(model="gpt_tiny", mesh={"expert": 3}).mesh.expert == 3
    with open(os.path.join(REPO, "configs",
                           "gpt_pipeline_1f1b_v5e16.yaml")) as f:
        spec = yaml.safe_load(f)
    cfg = TrainingConfig.from_dict(spec["training"])
    assert cfg.mesh.pipeline == 4
    assert cfg.pipeline_schedule == "1f1b"


def test_the_launcher_takes_the_moe_config_file_as_it_is():
    """`python -m kubeflow_tpu_torch.runtime.launcher --config
    configs/gpt_moe_v5e16.yaml`: the job spec file's training block is
    the run's config, and its world is the product of the mesh's axes
    (one process alone is refused, asking for the gang of 32)."""
    from kubeflow_tpu_torch.runtime import launcher

    path = os.path.join(REPO, "configs", "gpt_moe_v5e16.yaml")
    spec = launcher.load_spec(path)
    assert spec["model"] == "gpt_small_moe"
    assert spec["mesh"] == {"data": 8, "expert": 4}
    with pytest.raises(ValueError, match="needs 32 devices"):
        launcher.run(path, device="cpu")


def _tiny_moe(top_k=1, expert=None, dtype=torch.float32):
    return MoeMlp(16, 32, 4, dtype, top_k=top_k, expert=expert)


@pytest.mark.parametrize("top_k", [1, 2])
def test_a_sharded_moe_layer_sums_to_the_whole_one(top_k):
    """MoeMlp's sharded form: with a group of one (ExpertShard(None, 0,
    1)) it is the whole layer, bit for bit; the blocks of ep = 2 and 4
    (no group: each rank's partial output) sum to the whole layer's
    output and their gradients are the whole layer's, block by block
    (top-1 bitwise: one nonzero term an element; top-2 within 1e-6)."""
    gen = torch.Generator().manual_seed(3)
    whole = _tiny_moe(top_k)
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn((2, 8, 16), generator=gen)
    cot = torch.randn((2, 8, 16), generator=gen)

    def run(layer):
        xi = x.clone().requires_grad_()
        y = layer(xi)
        grads = torch.autograd.grad(y, [xi] + list(layer.parameters()), cot)
        return y.detach(), grads

    y_whole, g_whole = run(whole)
    for ep in (1, 2, 4):
        parts = []
        for r in range(ep):
            layer = _tiny_moe(top_k, ExpertShard(None, r, ep))
            with torch.no_grad():
                for name, p in layer.named_parameters():
                    p.copy_(layer.block_of(name, getattr(whole, name)))
            parts.append(run(layer))
        y = sum(p[0] for p in parts)
        tol = dict(rtol=0, atol=0) if top_k == 1 else dict(rtol=1e-6,
                                                           atol=1e-6)
        torch.testing.assert_close(y, y_whole, **tol)
        # the stacks' gradients: each rank's block of the whole layer's
        for i, leaf in ((2, "wi"), (3, "wo")):
            torch.testing.assert_close(
                torch.cat([p[1][i] for p in parts]), g_whole[i], **tol)
        # x's and the router's: the ranks' shares sum to the whole
        for i in (0, 1):
            torch.testing.assert_close(sum(p[1][i] for p in parts),
                                       g_whole[i], rtol=1e-5, atol=1e-6)


def test_the_expert_pair_is_the_identity_without_a_group():
    """Without a group both collectives are the identity both ways
    (gradcheck, f64)."""
    x = torch.randn(5, dtype=torch.float64, requires_grad=True)
    for fn in (copy_to_group, reduce_from_group):
        assert torch.autograd.gradcheck(lambda t: fn(t, None) * 2.0, (x,))
        torch.testing.assert_close(fn(x, None), x, rtol=0, atol=0)


def test_the_bridge_loads_a_whole_stack_into_a_block():
    """models/convert.py load_jax_params: a JAX tree's whole [E, ...]
    stacks land as a sharded model's blocks; a seeded init draws them as
    world 1 does."""
    from kubeflow_tpu_torch.models.convert import (
        load_jax_params,
        params_to_jax,
    )

    whole = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32,
                      seed=5)
    tree = params_to_jax(whole.state_dict())
    for r in range(2):
        part = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32,
                         seed=0, expert=ExpertShard(None, r, 2))
        load_jax_params(part, tree)
        seeded = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32,
                           seed=5, expert=ExpertShard(None, r, 2))
        for name, p in part.named_parameters():
            want = whole.get_parameter(name)
            if name.endswith(("moe.wi", "moe.wo")):
                want = want[2 * r:2 * r + 2]
            torch.testing.assert_close(p, want, rtol=0, atol=0)
            torch.testing.assert_close(seeded.get_parameter(name), want,
                                       rtol=0, atol=0)


def test_chip_smoke_phase_20_rehearsal(tmp_path):
    """Phase 20 of chip_smoke.py on the CPU at gpt_tiny_moe size, through
    `phase_gangs` as main runs it: 20a's `{expert: 4}` gang against world
    1 (losses, replicated leaves bit for bit, a quarter of the stack bytes
    a rank), 20b's `{sequence: 2}` gang (and rank 0's final weights
    against world 1's update), 20c's checkpoint restored at world 1 (the
    blocks joined)."""
    launches = rehearse_smoke(tmp_path, expert=SMOKE_EXPERT)
    assert launches == {"expert": {"flash_fwd": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0}}
