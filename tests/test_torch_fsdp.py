"""The port's fsdp mesh axis in the trainer (each rank holds its 1/fsdp
block of every leaf whose spec names `fsdp`, along that dim, and of its
AdamW moments; the block is gathered at its use and its gradient
reduce-scattered back by the gather's backward; the batch split over
data × fsdp; the clip's norm over the blocks; shard-writing
checkpoints), against the JAX `Trainer` on the same mesh, on the CPU in
f32.

Port gangs of 4 and 2 gloo ranks (tests/torch_gangs.py), one gang a size
running every job, train gpt_tiny and bert_tiny for 3 steps from the JAX
trainer's own init (its step-0 checkpoint, restored by every rank), on
the same `.npy` batches as the JAX trainer (tests/
test_torch_data_parallel.py's data): `{fsdp: 4}` and `{data: 2, fsdp:
2}` (gpt_tiny under remat there) at world 4, bert_tiny's `{fsdp: 2}` at
world 2. The JAX trainer runs each on the same mesh of the conftest's 8
CPU devices. Bounds: losses within rel 1e-5 (f32; the frameworks and
the gang sum in other orders), every rank's losses bit for bit equal,
and the leaves held whole bit for bit equal across the ranks. A rank's
blocks and moments have the shapes the JAX spec's shards have, and the
blocks joined in fsdp order are the JAX trainer's parameters (rel 1e-5
of each leaf's norm). A gang's checkpoint restores at world 1 (its
leaves the ranks' blocks joined, bit for bit) and in the JAX package,
and both resume to the gang's own losses; a world-1 checkpoint restores
into the world-2 gang and trains on to world 1's losses. The ranks'
FLOP counts sum to world 1's, and the collectives follow their formula.
The rows split over data × fsdp; with dropout on (bert_tiny on `{fsdp:
2}`) the gang's losses are the port's world-1 run's. An mlp config on
`{fsdp: 2}` trains through `python -m kubeflow_tpu_torch.runtime.launcher`.
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
from kubeflow_tpu_torch.config.platform import TrainingConfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    jax_path,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.layers import (  # noqa: E402
    fsdp_leaves,
    join_blocks,
)
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
)
from kubeflow_tpu_torch.parallel.mesh import FsdpShard  # noqa: E402
from test_torch_data_parallel import (  # noqa: E402
    BATCH,
    LOSS_REL,
    SEQ,
    STEPS,
    VOCAB,
    write_token_data,
)
from torch_gangs import REPO, RANK_TIMEOUT_S, free_port, run_gang  # noqa: E402

# model → (TrainingConfig fields, the data stream)
MODELS = {
    "gpt_tiny": (dict(model="gpt_tiny", learning_rate=1e-3,
                      weight_decay=0.1), "lm"),
    "bert_tiny": (dict(model="bert_tiny", learning_rate=1e-3,
                       weight_decay=0.1), "mlm"),
}
MESHES = {"f4": {"fsdp": 4}, "d2f2": {"data": 2, "fsdp": 2},
          "f2": {"fsdp": 2}}
# job name → (model, mesh, remat)
JOBS = {
    4: {
        "gpt_tiny/f4": ("gpt_tiny", "f4", False),
        "gpt_tiny/d2f2": ("gpt_tiny", "d2f2", True),
        "bert_tiny/d2f2": ("bert_tiny", "d2f2", False),
    },
    2: {
        "bert_tiny/f2": ("bert_tiny", "f2", False),
    },
}
# the checkpoint job: gpt_tiny on d2f2 saving at step 2 of 4; the restore
# job: world 1's step-2 checkpoint of gpt_tiny resumed on f2; the dropout
# job: bert_tiny with this dropout on f2, against world 1 in the port
CKPT_STEPS, CKPT_SAVE = 4, 2
DROPOUT = 0.1

# One rank: the fsdp pair of collectives on the world group, then every
# job of the gang in turn, each a fresh Trainer restored from the job's
# checkpoint directory by `run_training`.
WORKER = r'''
import hashlib, json, os
import numpy as np
import torch


def collectives():
    """A block gathered over the world (rank r's [r + 1, r + 1.5] along
    dim 1 of a [1, 2] block) and the gather's backward for a loss weight
    r + 1 on every element: the reduce-scatter of the ranks'
    cotangents, counted."""
    from kubeflow_tpu_torch.parallel.mesh import FsdpShard

    r = torch.distributed.get_rank()
    n = torch.distributed.get_world_size()
    shard = FsdpShard(torch.distributed.group.WORLD, r, n)
    x = torch.tensor([[r + 1.0, r + 1.5]]).requires_grad_()
    y = shard.gather(x, 1)
    (y * (r + 1)).sum().backward()
    return {"y": y.tolist(), "grad": x.grad.tolist(),
            "counts": dict(shard.counts)}


def run_job(job):
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.layers import fsdp_leaves
    from kubeflow_tpu_torch.parallel.sharding import param_specs
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.annotations import logical_axes_for
    from kubeflow_tpu_torch.training.datasets import build_data
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig.from_dict(job["cfg"])
    trainer = Trainer(cfg, device="cpu", model_kwargs=job.get("model_kw"))
    data, _ = build_data(cfg, trainer.task)
    local = trainer.local_batch(data.batch_at(0))
    res = run_training(cfg, restore=True, device="cpu", trainer=trainer,
                       log_every=1)
    state = trainer._final_state
    opt = state.optimizer
    held = fsdp_leaves(state.model)
    shapes, blocks, digests = {}, {}, {}
    for name, p in state.model.named_parameters():
        if name in held:
            st = opt.state[p]
            shapes[name] = [list(p.shape), list(st["exp_avg"].shape),
                            list(st["exp_avg_sq"].shape), held[name][2]]
            blocks[name] = p.detach().numpy()
        else:
            digests[name] = hashlib.sha256(
                p.detach().numpy().tobytes()).hexdigest()
    rank = torch.distributed.get_rank()
    if job.get("out"):
        np.savez(f"{job['out']}.{rank}.npz", **blocks)
    sizes = dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
    specs = param_specs(logical_axes_for(
        state.model, fsdp_size=sizes["fsdp"], mesh_axis_sizes=sizes),
        mesh=sizes)
    return {"result": res, "shapes": shapes, "digests": digests,
            "specs": {k: [list(a) if isinstance(a, tuple) else a for a in v]
                      for k, v in specs.items()},
            "flops": trainer.rank_flops(local),
            "rows": [trainer.data_rank, trainer.data_world],
            "coords": {a: trainer.mesh.get_local_rank(a)
                       for a in ("data", "fsdp")}}


def main():
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    jobs = json.loads(os.environ["KFT_TEST_JOB"])["jobs"]
    out = {"rank": rank(), "collectives": collectives(),
           "jobs": {name: run_job(job) for name, job in jobs.items()}}
    shutdown()
    print("RESULT " + json.dumps(out), flush=True)
'''


def cfg_dict(name, data, steps=STEPS, **over):
    return {**MODELS[name][0], "global_batch_size": BATCH, "steps": steps,
            "warmup_steps": 1, "dtype": "float32", "seed": 0, "data": data,
            **over}


def _jax_trainer(name, mesh, data, devices, steps=STEPS, remat=False):
    """The JAX trainer of one job on the job's own mesh."""
    fields = {k: v for k, v in cfg_dict(name, data, steps=steps,
                                        remat=remat).items() if k != "data"}
    cfg = JTrainingConfig(mesh=JMeshConfig(**MESHES[mesh]),
                          data=JDataConfig(**data), **fields)
    jmesh = mesh_from_config(cfg.mesh,
                             devices=devices[:cfg.mesh.num_devices])
    task_cls = JCausalLmTask if name.startswith("gpt") else JMlmTask
    model = jget_model(name, dtype=jnp.float32,
                       **({"remat": True} if remat else {}))
    task = task_cls(cfg, seq_len=SEQ, vocab_size=VOCAB)
    return JTrainer(cfg, mesh=jmesh, model=model, task=task), jmesh


def _jax_steps(jtr, jmesh, state, first, last):
    train, _ = jbuild_data(jtr.cfg, jtr.task)
    losses = []
    for i in range(first, last):
        state, m = jtr.train_step(state, make_global_batch(train.batch_at(i),
                                                           jmesh),
                                  jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return state, losses


def _jax_block_shapes(jtr):
    """{flax path: the shape of one device's shard} of the JAX trainer's
    params (`state_shardings`' NamedShardings, no program compiled)."""
    shapes, shardings = jtr.abstract_state()
    leaves = jax.tree_util.tree_leaves_with_path(shapes.params)
    shards = jax.tree.leaves(shardings.params,
                             is_leaf=lambda x: hasattr(x, "shard_shape"))
    return {"/".join(str(k.key) for k in path): tuple(sh.shard_shape(
        leaf.shape)) for (path, leaf), sh in zip(leaves, shards)}


@pytest.fixture(scope="module")
def data_and_init(tmp_path_factory, devices8):
    """{model: (data config, the JAX step-0 checkpoint)}, made once."""
    out = {}

    def get(name):
        if name not in out:
            root = tmp_path_factory.mktemp(f"jax_{name}")
            data = {"name": "npz",
                    "path": write_token_data(str(root / "data"),
                                             MODELS[name][1])}
            jtr, _ = _jax_trainer(name, "f2", data, devices8)
            ckpt = str(root / "step0")
            with JCheckpointManager(ckpt, async_save=False) as mgr:
                mgr.save(0, jtr.init_state(), force=True)
            out[name] = (data, ckpt)
        return out[name]

    return get


@pytest.fixture(scope="module")
def jax_runs(data_and_init, devices8):
    """(model, mesh, remat) → the JAX trainer's 3 steps from the step-0
    checkpoint: (losses, final params by the port's names, the params'
    shard shapes by flax path), each run once."""
    done = {}

    def get(name, mesh, remat=False):
        key = (name, mesh, remat)
        if key not in done:
            data, ckpt = data_and_init(name)
            jtr, jmesh = _jax_trainer(name, mesh, data, devices8,
                                      remat=remat)
            state = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                                     step=0)
            state, losses = _jax_steps(jtr, jmesh, state, 0, STEPS)
            params = params_from_jax(jax.tree.map(np.asarray, state.params))
            done[key] = (losses, {k: v.numpy() for k, v in params.items()},
                         _jax_block_shapes(jtr))
        return done[key]

    return get


def _job(data, ckpt, root, job, name, mesh, remat=False, steps=STEPS,
         **ckpt_kw):
    own = str(root / job.replace("/", "-"))
    shutil.copytree(ckpt, own)
    cfg = cfg_dict(name, data, steps=steps, mesh=MESHES[mesh], remat=remat,
                   checkpoint={"directory": own, "async_save": False,
                               **ckpt_kw})
    return {"cfg": cfg, "out": own + "/blocks"}


def _only_step(src, dst, step):
    shutil.copytree(src, dst)
    for s in layout.committed_steps(dst):
        if s != step:
            shutil.rmtree(layout.step_dir(dst, s))
    return dst


@pytest.fixture(scope="module")
def world1_ckpt(data_and_init, tmp_path_factory):
    """World 1's gpt_tiny run of CKPT_STEPS steps from the JAX init, saving
    every CKPT_SAVE → (its losses, a directory holding only its step-2
    checkpoint)."""
    from kubeflow_tpu_torch.runtime.train_run import run_training

    data, ckpt = data_and_init("gpt_tiny")
    root = tmp_path_factory.mktemp("fsdp_w1")
    own = str(root / "run")
    shutil.copytree(ckpt, own)
    cfg = TrainingConfig(**cfg_dict(
        "gpt_tiny", data, steps=CKPT_STEPS, checkpoint={
            "directory": own, "async_save": False,
            "interval_steps": CKPT_SAVE}))
    res = run_training(cfg, restore=True, device="cpu", log_every=1)
    return ([loss for _, loss in res["losses"]],
            _only_step(own, str(root / "step2"), CKPT_SAVE))


@pytest.fixture(scope="module")
def gangs(data_and_init, world1_ckpt, tmp_path_factory):
    """world → (rank outputs, {job: its directory}), each gang started
    once."""
    done = {}

    def start(world):
        if world in done:
            return done[world]
        root = tmp_path_factory.mktemp(f"fsdp{world}")
        jobs, dirs = {}, {}
        for job, (name, mesh, remat) in JOBS[world].items():
            data, ckpt = data_and_init(name)
            jobs[job] = _job(data, ckpt, root, job, name, mesh, remat)
        data, ckpt = data_and_init("gpt_tiny")
        if world == 4:
            jobs["ckpt"] = _job(data, ckpt, root, "ckpt", "gpt_tiny",
                                "d2f2", steps=CKPT_STEPS,
                                interval_steps=CKPT_SAVE, keep=10)
        else:
            jobs["restore"] = _job(data, world1_ckpt[1], root, "restore",
                                   "gpt_tiny", "f2", steps=CKPT_STEPS)
            data, ckpt = data_and_init("bert_tiny")
            jobs["dropout"] = _job(data, ckpt, root, "dropout", "bert_tiny",
                                   "f2")
            jobs["dropout"]["model_kw"] = {"dropout_rate": DROPOUT}
        for job, spec in jobs.items():
            dirs[job] = spec["cfg"]["checkpoint"]["directory"]
        done[world] = (run_gang(WORKER, {"jobs": jobs}, world,
                                name=f"fsdp-test-{world}"), dirs)
        return done[world]

    return start


def _losses(res):
    return [loss for _, loss in res["result"]["losses"]]


def _cases():
    return [(world, job) for world in sorted(JOBS) for job in JOBS[world]]


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_an_fsdp_gang_equals_the_jax_trainer_on_its_mesh(gangs, jax_runs,
                                                         world, job):
    name, mesh, remat = JOBS[world][job]
    outs, _ = gangs(world)
    jlosses, _, _ = jax_runs(name, mesh, remat)
    results = [o["jobs"][job] for o in outs]
    for res in results:
        assert res["result"]["world_size"] == world
        assert res["result"]["final_step"] == STEPS
        # the ranks agree on every step's loss, bit for bit
        assert _losses(res) == _losses(results[0])
        # and on every leaf held whole
        assert res["digests"] == results[0]["digests"]
    np.testing.assert_allclose(_losses(results[0]), jlosses, rtol=LOSS_REL)


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_each_rank_holds_its_block_of_every_fsdp_leaf(gangs, jax_runs,
                                                      world, job):
    """A rank's block of every leaf whose spec names fsdp, and of its two
    AdamW moments, has the shape of the JAX spec's shard (tests/
    test_trainer.py test_params_sharded's layout), every other leaf is
    whole; the blocks joined in fsdp order equal the JAX trainer's
    parameters (rel 1e-5 of each leaf's norm): the row-sharded `tok_emb`
    and, in BERT, `nsp_out`, which the fallback annotates, included."""
    name, mesh, remat = JOBS[world][job]
    outs, dirs = gangs(world)
    fsdp = MESHES[mesh]["fsdp"]
    _, jparams, jshapes = jax_runs(name, mesh, remat)
    by_block = {}
    for rank, o in enumerate(outs):
        res = o["jobs"][job]
        for key, spec in res["specs"].items():
            want = jshapes[jax_path(key)]
            if "fsdp" in spec:
                dim = spec.index("fsdp")
                got = res["shapes"][key]
                assert got[:3] == [list(want)] * 3 and got[3] == dim, key
            else:
                assert key not in res["shapes"], key
                assert want == jparams[key].shape, key
        by_block.setdefault(res["coords"]["fsdp"], rank)
    held = outs[0]["jobs"][job]["shapes"]
    assert "tok_emb.embedding" in held
    if name == "bert_tiny":
        assert "nsp_out.kernel" in held
    blocks = [np.load(f"{dirs[job]}/blocks.{by_block[f]}.npz")
              for f in range(fsdp)]
    assert set(blocks[0].files) == set(held)
    for key, (_, _, _, dim) in held.items():
        got = np.concatenate([b[key] for b in blocks], axis=dim)
        want = jparams[key]
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LOSS_REL, (key, rel)


@pytest.mark.parametrize("name,mesh", [("bert_tiny", {"data": 2, "fsdp": 4}),
                                       ("gpt_tiny", {"fsdp": 4}),
                                       ("gpt_tiny", {"fsdp": 8})])
def test_a_model_holds_the_jax_specs_shards(name, mesh, devices8):
    """A model built for an fsdp rank (`fsdp=FsdpShard(...)`, no group: its
    blocks only) holds each leaf at the shape of the JAX trainer's shard
    on the same mesh (tests/test_trainer.py fsdp_bert_trainer's `{data: 2,
    fsdp: 4}` among them): bert_tiny's 2-row `seg_emb` stays whole at
    fsdp 4, and so does every 1-D leaf; some leaf is split."""
    data = {"name": "synthetic"}
    cfg = JTrainingConfig(mesh=JMeshConfig(**mesh), data=JDataConfig(**data),
                          model=name, global_batch_size=BATCH,
                          dtype="float32")
    jmesh = mesh_from_config(cfg.mesh, devices=devices8[:cfg.mesh.num_devices])
    task_cls = JCausalLmTask if name.startswith("gpt") else JMlmTask
    jtr = JTrainer(cfg, mesh=jmesh, model=jget_model(name, dtype=jnp.float32),
                   task=task_cls(cfg, seq_len=SEQ, vocab_size=VOCAB))
    jshapes = _jax_block_shapes(jtr)
    model = get_model(name, device="meta",
                      fsdp=FsdpShard(None, 1, mesh["fsdp"]))
    params = dict(model.named_parameters())
    assert {jax_path(k) for k in params} == set(jshapes)
    for key, p in params.items():
        assert tuple(p.shape) == jshapes[jax_path(key)], key
    held = fsdp_leaves(model)
    assert held
    if name == "bert_tiny":
        assert "seg_emb.embedding" not in held
    assert not any(p.dim() == 1 for k, p in params.items() if k in held)


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_the_ranks_flops_sum_to_world_1s(gangs, world, job):
    """Summed over data × fsdp, the ranks' FLOP counts are world 1's
    count of the step."""
    name, _, _ = JOBS[world][job]
    outs, _ = gangs(world)
    mcfg = get_model(name, device="meta").cfg
    count = lm_train_flops if name.startswith("gpt") else encoder_train_flops
    total = sum(o["jobs"][job]["flops"] for o in outs)
    np.testing.assert_allclose(total, count(mcfg, BATCH, SEQ), rtol=1e-12)


@pytest.mark.parametrize("world,job", _cases(),
                         ids=[f"w{w}-{j}" for w, j in _cases()])
def test_the_collectives_follow_their_formula(gangs, world, job):
    """A step gathers every fsdp leaf once a use (a layer's leaves twice
    under remat: the recompute gathers again) and reduce-scatters each
    gathered use's gradient once; the gradient buckets take one
    all-reduce a step, two when the blocks meet a data axis above 1."""
    name, mesh, remat = JOBS[world][job]
    outs, _ = gangs(world)
    model = get_model(name, device="meta",
                      fsdp=FsdpShard(None, 0, MESHES[mesh]["fsdp"]))
    held = fsdp_leaves(model)
    layers = sum(1 for k in held if k.startswith("layers."))
    uses = len(held)
    want = {"all_gather": STEPS * (uses + layers * remat),
            "reduce_scatter": STEPS * uses}
    buckets = STEPS * (1 + (MESHES[mesh].get("data", 1) > 1))
    for o in outs:
        res = o["jobs"][job]["result"]
        assert res["fsdp_collectives"] == want
        assert res["grad_allreduces"] == buckets


def test_the_gather_reduce_scatters_its_gradient(gangs):
    """`FsdpShard.gather`: rank r's block [r + 1, r + 1.5] joined along dim
    1 in rank order; under a loss weight r + 1 on every element each
    rank's block gradient is the sum of the weights (1 + 2), counted as
    one gather and one reduce-scatter."""
    outs, _ = gangs(2)
    for o in outs:
        c = o["collectives"]
        np.testing.assert_array_equal(c["y"], [[1.0, 1.5, 2.0, 2.5]])
        np.testing.assert_array_equal(c["grad"], [[3.0, 3.0]])
        assert c["counts"] == {"all_gather": 1, "reduce_scatter": 1}


def test_an_fsdp_gangs_checkpoint_restores_at_world_1_and_in_jax(
        gangs, data_and_init, devices8, tmp_path):
    """The `{data: 2, fsdp: 2}` gang's checkpoints (each fsdp leaf written
    as 2 blocks along its dim by the 2 data-rank-0 writers, each whole
    leaf once): the final one restores at world 1 with its leaves the
    ranks' blocks joined, bit for bit, and its moments whole; the step-2
    one resumes at world 1 and in the JAX trainer to the gang's own
    step-3 and step-4 losses."""
    from kubeflow_tpu_torch.checkpointing import restore_latest
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    outs, dirs = gangs(4)
    ckpt = dirs["ckpt"]
    gang_losses = _losses(outs[0]["jobs"]["ckpt"])
    held = outs[0]["jobs"]["ckpt"]["shapes"]
    assert layout.committed_steps(ckpt) == [0, CKPT_SAVE, CKPT_STEPS]
    manifest = layout.read_manifest(layout.step_dir(ckpt, CKPT_SAVE))
    assert manifest["process_count"] == 4
    for entry in manifest["leaves"]:
        key = entry["key"]
        name = next((n for n in held if key.endswith("/" + jax_path(n))),
                    None)
        if name is None:
            assert len(entry["shards"]) == 1, key
            continue
        dim, n = held[name][3], entry["shape"][held[name][3]]
        assert [s["index"][dim] for s in entry["shards"]] == [
            [0, n // 2], [n // 2, n]], key
    data, _ = data_and_init("gpt_tiny")
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": ckpt}))
    state = restore_latest(ckpt, Trainer(cfg, device="cpu").init_state())
    assert state.step == CKPT_STEPS
    by_block = {}
    for rank, o in enumerate(outs):
        by_block.setdefault(o["jobs"]["ckpt"]["coords"]["fsdp"], rank)
    blocks = [np.load(f"{ckpt}/blocks.{by_block[f]}.npz") for f in range(2)]
    params = dict(state.model.named_parameters())
    for key in held:
        np.testing.assert_array_equal(
            params[key].detach().numpy(),
            np.concatenate([b[key] for b in blocks], axis=held[key][3]),
            err_msg=key)
    for p in params.values():
        assert state.optimizer.state[p]["exp_avg"].shape == p.shape
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
    jtr, jmesh = _jax_trainer("gpt_tiny", "d2f2", data, devices8,
                              steps=CKPT_STEPS)
    jstate = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                              step=CKPT_SAVE)
    assert int(jax.device_get(jstate.step)) == CKPT_SAVE
    _, jlosses = _jax_steps(jtr, jmesh, jstate, CKPT_SAVE, CKPT_STEPS)
    np.testing.assert_allclose(jlosses, gang_losses[CKPT_SAVE:],
                               rtol=LOSS_REL)


def test_a_world_1_checkpoint_restores_into_an_fsdp_gang(gangs,
                                                         world1_ckpt):
    """World 1's step-2 checkpoint (every leaf whole) restored into the
    `{fsdp: 2}` gang (each rank reading its blocks' regions) trains on to
    world 1's own step-3 and step-4 losses."""
    outs, _ = gangs(2)
    w1_losses, _ = world1_ckpt
    for o in outs:
        res = o["jobs"]["restore"]["result"]
        assert [s for s, _ in res["losses"]] == [3, 4]
    np.testing.assert_allclose(_losses(outs[0]["jobs"]["restore"]),
                               w1_losses[CKPT_SAVE:], rtol=LOSS_REL)


def test_the_batch_rows_split_over_data_times_fsdp(gangs, data_and_init,
                                                   jax_runs, tmp_path):
    """Rank (d, f) feeds block d·F + f of data × fsdp, so every block is
    fed once (training/data.py `local_rows`); with dropout on, the
    `{fsdp: 2}` gang keeps each rank's rows of world 1's masks: its
    losses are the port's world-1 run's (the same JAX init and batches),
    and not the dropout-free JAX trainer's."""
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    cases = [(w, j, JOBS[w][j][1]) for w, j in _cases()]
    for world, job, mesh in cases + [(2, "dropout", "f2")]:
        outs, _ = gangs(world)
        fsdp, rows = MESHES[mesh]["fsdp"], []
        for o in outs:
            res = o["jobs"][job]
            c = res["coords"]
            assert res["rows"] == [c["data"] * fsdp + c["fsdp"], world]
            rows.append(res["rows"][0])
        assert sorted(rows) == list(range(world))
    outs, _ = gangs(2)
    data, ckpt = data_and_init("bert_tiny")
    own = str(tmp_path / "w1")
    shutil.copytree(ckpt, own)
    cfg = TrainingConfig(**cfg_dict("bert_tiny", data, checkpoint={
        "directory": own, "async_save": False}))
    trainer = Trainer(cfg, device="cpu",
                      model_kwargs={"dropout_rate": DROPOUT})
    res = run_training(cfg, restore=True, device="cpu", trainer=trainer,
                       log_every=1)
    gang = _losses(outs[0]["jobs"]["dropout"])
    assert all(_losses(o["jobs"]["dropout"]) == gang for o in outs)
    np.testing.assert_allclose(gang, [loss for _, loss in res["losses"]],
                               rtol=LOSS_REL)
    jlosses, _, _ = jax_runs("bert_tiny", "f2")
    assert abs(gang[0] - jlosses[0]) > 1e-3 * abs(jlosses[0])


def test_the_bridge_loads_a_whole_leaf_into_a_block():
    """models/convert.py load_jax_params: a JAX tree's whole leaves land as
    an fsdp model's blocks (a seeded init draws them as world 1 does), and
    `join_blocks` of every rank's state dict is the whole tree
    again."""
    whole = get_model("gpt_tiny", device="cpu", dtype=torch.float32, seed=5)
    tree = params_to_jax(whole.state_dict())
    for n in (2, 4):
        parts = []
        for r in range(n):
            part = get_model("gpt_tiny", device="cpu", dtype=torch.float32,
                             seed=0, fsdp=FsdpShard(None, r, n))
            load_jax_params(part, tree)
            seeded = get_model("gpt_tiny", device="cpu", dtype=torch.float32,
                               seed=5, fsdp=FsdpShard(None, r, n))
            for name, p in part.named_parameters():
                torch.testing.assert_close(seeded.get_parameter(name), p,
                                           rtol=0, atol=0)
            assert len(fsdp_leaves(part)) == 15
            parts.append(part.state_dict())
        joined = params_to_jax(join_blocks(part, parts))
        assert set(joined) == set(tree)
        for key, want in tree.items():
            np.testing.assert_array_equal(joined[key], want, err_msg=key)


def test_an_fsdp_config_trains_through_the_launcher(tmp_path):
    """`python -m kubeflow_tpu_torch.runtime.launcher --config FILE
    --device cpu` on a config with `mesh: {fsdp: 2}` (the mlp: its three
    kernels split on their input dims) in each rank of a rendered 2-rank
    env: the ranks' losses equal and within rel 1e-5 of a world-1 run of
    the same config, each rank's result line with its gathers and
    reduce-scatters (3 a step each) and one bucket all-reduce a step."""
    from kubeflow_tpu_torch.parallel.distributed import render_gang_env
    from kubeflow_tpu_torch.runtime.train_run import run_training

    spec = {"model": "mlp", "global_batch_size": 8, "steps": STEPS,
            "dtype": "float32", "learning_rate": 0.01, "warmup_steps": 1,
            "checkpoint": {"enabled": False}}
    path = tmp_path / "fsdp.json"
    path.write_text(json.dumps({**spec, "mesh": {"fsdp": 2}}))
    envs = render_gang_env("fsdp-launch", ["127.0.0.1"] * 2,
                           coordinator_port=free_port())
    procs, results = [], []
    try:
        for e in envs:
            env = dict(os.environ, **e, OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
                 "--config", str(path), "--device", "cpu"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    one = run_training(TrainingConfig(**spec), device="cpu")
    for res in results:
        assert res["world_size"] == 2 and res["final_step"] == STEPS
        assert res["losses"] == results[0]["losses"]
        assert res["fsdp_collectives"] == {"all_gather": 3 * STEPS,
                                           "reduce_scatter": 3 * STEPS}
        assert res["grad_allreduces"] == STEPS
    np.testing.assert_allclose([loss for _, loss in results[0]["losses"]],
                               [loss for _, loss in one["losses"]],
                               rtol=LOSS_REL)
