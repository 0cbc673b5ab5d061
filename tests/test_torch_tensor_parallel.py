"""The port's tensor mesh axis in the trainer (each rank holds its 1/t
block of every leaf whose spec names `tensor`, along that dim, and of its
AdamW moments, never gathered: q/k/v and the first MLP product
column-parallel, `out` and the second row-parallel, the tables and the
head vocab-split with a vocab-parallel loss; the batch split over data
alone; the clip's norm over the blocks; shard-writing checkpoints),
against the JAX `Trainer` on the same mesh, on the CPU in f32.

Port gangs of 2 and 4 gloo ranks (tests/torch_gangs.py), one gang a size
running every job, train gpt_tiny, bert_tiny and gpt_tiny_moe for 3
steps from the JAX trainer's own init (its step-0 checkpoint, restored
by every rank), on the same `.npy` batches as the JAX trainer (tests/
test_torch_data_parallel.py's data): `{tensor: 2}` at world 2, and
`{data: 2, tensor: 2}` (gpt_tiny under remat, bert_tiny) at world 4. The
JAX trainer runs each on the same mesh of the conftest's 8 CPU devices.
Bounds: losses within rel 1e-5 (f32; the frameworks and the gang sum in
other orders), every rank's losses bit for bit equal, the replicated
leaves and their gradients bit for bit equal across the ranks (the
gradients are never all-reduced over tensor: `copy_to_group` makes them
whole). A rank's blocks and moments have the shapes the JAX spec's
shards have, and the blocks joined in tensor order are the JAX
trainer's parameters (rel 1e-5 of each leaf's norm). A gang's
checkpoint restores at world 1 (its leaves the ranks' blocks joined, bit
for bit) and in the JAX package, and both resume to the gang's own
losses; a world-1 checkpoint restores into the `{tensor: 2}` gang and
trains on to world 1's losses. The ranks' FLOP counts sum to world 1's,
the tensor all-reduces follow their formula, the vocab-parallel loss
(label smoothing, top-1) is the whole row's, and with dropout on
(bert_tiny on `{tensor: 2}`) the gang's losses are the port's world-1
run's. A `{tensor: 2}` config trains through the launcher (the last job
of the pair: `runtime/launcher.py main` leaves the group).
"""

import json
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
    MeshConfig,
    TrainingConfig,
)
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    jax_path,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.layers import (  # noqa: E402
    join_blocks,
    tensor_leaves,
)
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
)
from kubeflow_tpu_torch.parallel.mesh import TensorShard  # noqa: E402
from test_torch_data_parallel import (  # noqa: E402
    BATCH,
    LOSS_REL,
    SEQ,
    STEPS,
    VOCAB,
    write_token_data,
)
from torch_gangs import run_gang  # noqa: E402

# model → (TrainingConfig fields, the data stream)
MODELS = {
    "gpt_tiny": (dict(model="gpt_tiny", learning_rate=1e-3,
                      weight_decay=0.1), "lm"),
    "bert_tiny": (dict(model="bert_tiny", learning_rate=1e-3,
                       weight_decay=0.1), "mlm"),
    "gpt_tiny_moe": (dict(model="gpt_tiny_moe", learning_rate=1e-3,
                          weight_decay=0.1), "lm"),
}
MESHES = {"t2": {"tensor": 2}, "d2t2": {"data": 2, "tensor": 2}}
# job name → (model, mesh, remat)
JOBS = {
    2: {
        "gpt_tiny/t2": ("gpt_tiny", "t2", False),
        "bert_tiny/t2": ("bert_tiny", "t2", False),
        "gpt_tiny_moe/t2": ("gpt_tiny_moe", "t2", False),
    },
    4: {
        "gpt_tiny/d2t2": ("gpt_tiny", "d2t2", True),
        "bert_tiny/d2t2": ("bert_tiny", "d2t2", False),
    },
}
# the checkpoint job: gpt_tiny on d2t2 saving at step 2 of 4; the restore
# job: world 1's step-2 checkpoint of gpt_tiny resumed on t2; the dropout
# job: bert_tiny with this dropout on t2, against world 1 in the port
CKPT_STEPS, CKPT_SAVE = 4, 2
DROPOUT = 0.1
# the launcher's job: gpt_tiny on t2, the lm stream made on the device
LAUNCH_CFG = {"model": "gpt_tiny", "global_batch_size": 4, "steps": STEPS,
              "seq_len": SEQ, "dtype": "float32", "learning_rate": 1e-3,
              "warmup_steps": 1, "checkpoint": {"enabled": False},
              "mesh": {"tensor": 2}}

# One rank: the vocab-parallel loss on the world group, then every job of
# the gang in turn, each a fresh Trainer restored from the job's
# checkpoint directory by `run_training` (the launcher's job last: it
# leaves the group).
WORKER = r'''
import contextlib, hashlib, io, json, os
import numpy as np
import torch


def digest(t):
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def vocab_loss():
    """Seeded f32 logits [6, 10] split in column blocks over the world:
    the vocab-parallel cross-entropy (label smoothing 0.1) and top-1 of
    this rank's columns, beside the whole row's, and the logits'
    gradient block beside the whole gradient's columns."""
    from kubeflow_tpu_torch.parallel.mesh import TensorShard
    from kubeflow_tpu_torch.training.tasks import _argmax, cross_entropy

    r = torch.distributed.get_rank()
    n = torch.distributed.get_world_size()
    gen = torch.Generator().manual_seed(3)
    whole = torch.randn(6, 10 * n, generator=gen)
    labels = torch.randint(0, 10 * n, (6,), generator=gen)
    labels[0] = -100
    shard = TensorShard(torch.distributed.group.WORLD, r, n)
    mine = whole[:, 10 * r:10 * (r + 1)].clone().requires_grad_()
    loss = cross_entropy(mine, labels, ignore=-100, label_smoothing=0.1,
                         vocab=(shard, 10 * r))
    loss.backward()
    ref = whole.clone().requires_grad_()
    want = cross_entropy(ref, labels, ignore=-100, label_smoothing=0.1)
    want.backward()
    return {"loss": [loss.item(), want.item()],
            "grad_gap": float((mine.grad - ref.grad[:, 10 * r:10 * (r + 1)]
                               ).abs().max()),
            "top1": [_argmax(mine.detach(), (shard, 10 * r)).tolist(),
                     whole.argmax(-1).tolist()],
            "counts": dict(shard.counts)}


def run_job(job):
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.layers import tensor_leaves
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
    held = tensor_leaves(state.model)
    shapes, blocks, digests, grads = {}, {}, {}, {}
    for name, p in state.model.named_parameters():
        if name in held:
            st = opt.state[p]
            shapes[name] = [list(p.shape), list(st["exp_avg"].shape),
                            list(st["exp_avg_sq"].shape), held[name][2]]
            blocks[name] = p.detach().numpy()
        else:
            digests[name] = digest(p)
            grads[name] = digest(p.grad)
    rank = torch.distributed.get_rank()
    np.savez(f"{job['out']}.{rank}.npz", **blocks)
    sizes = dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
    specs = param_specs(logical_axes_for(state.model, mesh_axis_sizes=sizes),
                        mesh=sizes)
    return {"result": res, "shapes": shapes, "digests": digests,
            "grads": grads,
            "specs": {k: [list(a) if isinstance(a, tuple) else a for a in v]
                      for k, v in specs.items()},
            "flops": trainer.rank_flops(local),
            "rows": [trainer.data_rank, trainer.data_world],
            "coords": {a: trainer.mesh.get_local_rank(a)
                       for a in ("data", "tensor")}}


def launch(path):
    """`runtime/launcher.py main --config path --device cpu` in this rank
    (the gang's group is already joined; the launcher leaves it) → its
    result line."""
    from kubeflow_tpu_torch.runtime import launcher

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(["--config", path, "--device", "cpu"])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith('{"job"')]
    return {"rc": rc, "line": json.loads(lines[-1])}


def main():
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    job = json.loads(os.environ["KFT_TEST_JOB"])
    out = {"rank": rank(), "vocab": vocab_loss(),
           "jobs": {name: run_job(j) for name, j in job["jobs"].items()}}
    if job.get("launch"):
        out["launch"] = launch(job["launch"])
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
            jtr, _ = _jax_trainer(name, "t2", data, devices8)
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
    root = tmp_path_factory.mktemp("tp_w1")
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
        root = tmp_path_factory.mktemp(f"tp{world}")
        jobs, dirs, extra = {}, {}, {}
        for job, (name, mesh, remat) in JOBS[world].items():
            data, ckpt = data_and_init(name)
            jobs[job] = _job(data, ckpt, root, job, name, mesh, remat)
        data, ckpt = data_and_init("gpt_tiny")
        if world == 4:
            jobs["ckpt"] = _job(data, ckpt, root, "ckpt", "gpt_tiny",
                                "d2t2", steps=CKPT_STEPS,
                                interval_steps=CKPT_SAVE, keep=10)
        else:
            jobs["restore"] = _job(data, world1_ckpt[1], root, "restore",
                                   "gpt_tiny", "t2", steps=CKPT_STEPS)
            data, ckpt = data_and_init("bert_tiny")
            jobs["dropout"] = _job(data, ckpt, root, "dropout", "bert_tiny",
                                   "t2")
            jobs["dropout"]["model_kw"] = {"dropout_rate": DROPOUT}
            path = root / "launch.json"
            path.write_text(json.dumps(LAUNCH_CFG))
            extra["launch"] = str(path)
        for job, spec in jobs.items():
            dirs[job] = spec["cfg"]["checkpoint"]["directory"]
        done[world] = (run_gang(WORKER, {"jobs": jobs, **extra}, world,
                                name=f"tp-test-{world}"), dirs)
        return done[world]

    return start


def _losses(res):
    return [loss for _, loss in res["result"]["losses"]]


def _cases():
    return [(world, job) for world in sorted(JOBS) for job in JOBS[world]]


_IDS = [f"w{w}-{j}" for w, j in _cases()]


def _by_tensor(outs, job):
    """{tensor coordinate: the rank at data coordinate 0 holding it}."""
    by = {}
    for rank, o in enumerate(outs):
        c = o["jobs"][job]["coords"]
        if c["data"] == 0:
            by[c["tensor"]] = rank
    return by


@pytest.mark.parametrize("world,job", _cases(), ids=_IDS)
def test_a_tensor_gang_equals_the_jax_trainer_on_its_mesh(gangs, jax_runs,
                                                          world, job):
    """Losses within rel 1e-5 of the JAX trainer's; the ranks' losses,
    replicated leaves and those leaves' gradients bit for bit equal."""
    name, mesh, remat = JOBS[world][job]
    outs, _ = gangs(world)
    jlosses, _, _ = jax_runs(name, mesh, remat)
    results = [o["jobs"][job] for o in outs]
    for res in results:
        assert res["result"]["world_size"] == world
        assert res["result"]["final_step"] == STEPS
        assert _losses(res) == _losses(results[0])
        assert res["digests"] == results[0]["digests"]
        assert res["grads"] == results[0]["grads"]
    np.testing.assert_allclose(_losses(results[0]), jlosses, rtol=LOSS_REL)


@pytest.mark.parametrize("world,job", _cases(), ids=_IDS)
def test_each_rank_holds_its_block_of_every_tensor_leaf(gangs, jax_runs,
                                                        world, job):
    """A rank's block of every leaf whose spec names tensor, and of its
    two AdamW moments, has the shape of the JAX spec's shard, every
    other leaf is whole; the blocks joined in tensor order equal the JAX
    trainer's parameters (rel 1e-5 of each leaf's norm): the vocab-split
    tables and head (mlm_out in BERT) and an MoE block's stacks
    included."""
    name, mesh, remat = JOBS[world][job]
    outs, dirs = gangs(world)
    _, jparams, jshapes = jax_runs(name, mesh, remat)
    res = outs[0]["jobs"][job]
    for key, spec in res["specs"].items():
        want = jshapes[jax_path(key)]
        if "tensor" in spec:
            got = res["shapes"][key]
            assert got[:3] == [list(want)] * 3, key
            assert got[3] == spec.index("tensor"), key
        else:
            assert key not in res["shapes"], key
            assert want == jparams[key].shape, key
    held = res["shapes"]
    assert "tok_emb.embedding" in held
    assert ("mlm_out.kernel" if name.startswith("bert") else
            "head.kernel") in held
    if name.endswith("moe"):
        assert "layers.0.moe.wi" in held and "layers.0.moe.router" not in held
    by = _by_tensor(outs, job)
    blocks = [np.load(f"{dirs[job]}/blocks.{by[t]}.npz")
              for t in range(MESHES[mesh]["tensor"])]
    assert set(blocks[0].files) == set(held)
    lr = MODELS[name][0]["learning_rate"]
    for key, (_, _, _, dim) in held.items():
        got = np.concatenate([b[key] for b in blocks], axis=dim)
        want = jparams[key]
        assert got.shape == want.shape
        if key.endswith("attention.key.bias"):
            # its true gradient is 0 (softmax ignores a shift shared by a
            # query's keys): AdamW steps it from 0 on summation noise, at
            # most lr an element a step in both frameworks
            assert np.abs(got - want).max() <= 2 * lr * STEPS, key
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LOSS_REL, (key, rel)


@pytest.mark.parametrize("name,vocab", [("gpt_tiny", 512),
                                        ("bert_tiny", 512),
                                        ("gpt_tiny", 50257)])
def test_a_model_holds_the_jax_specs_shards(name, vocab, devices8):
    """A model built for a tensor rank (`tensor=TensorShard(...)`, no
    group: its blocks only) holds each leaf at the shape of the JAX
    trainer's shard on `{data: 2, tensor: 2}`: gpt_tiny's 512-row head
    and tables split, a 50,257-row head and `tok_emb` stay whole (the
    JAX degradation rule) while its 128-row `pos_emb` splits; BERT's
    2-row `seg_emb` is a row a rank."""
    cfg = JTrainingConfig(mesh=JMeshConfig(data=2, tensor=2),
                          data=JDataConfig(name="synthetic"), model=name,
                          global_batch_size=BATCH, dtype="float32")
    jmesh = mesh_from_config(cfg.mesh, devices=devices8[:4])
    task_cls = JCausalLmTask if name.startswith("gpt") else JMlmTask
    jtr = JTrainer(cfg, mesh=jmesh, model=jget_model(
        name, dtype=jnp.float32, vocab_size=vocab),
        task=task_cls(cfg, seq_len=SEQ, vocab_size=VOCAB))
    jshapes = _jax_block_shapes(jtr)
    model = get_model(name, device="meta", vocab_size=vocab,
                      tensor=TensorShard(None, 1, 2))
    params = dict(model.named_parameters())
    assert {jax_path(k) for k in params} == set(jshapes)
    for key, p in params.items():
        assert tuple(p.shape) == jshapes[jax_path(key)], key
    held = tensor_leaves(model)
    head = "mlm_out.kernel" if name.startswith("bert") else "head.kernel"
    assert (head in held) == (vocab % 2 == 0)
    assert ("tok_emb.embedding" in held) == (vocab % 2 == 0)
    assert "pos_emb.embedding" in held
    if name == "bert_tiny":
        assert tuple(params["seg_emb.embedding"].shape) == (1, 64)


@pytest.mark.parametrize("world,job", _cases(), ids=_IDS)
def test_the_ranks_flops_sum_to_world_1s(gangs, world, job):
    """Summed over data × tensor, the ranks' FLOP counts are world 1's
    count of the step."""
    name, _, _ = JOBS[world][job]
    outs, _ = gangs(world)
    mcfg = get_model(name, device="meta").cfg
    count = lm_train_flops if name.startswith("gpt") else encoder_train_flops
    total = sum(o["jobs"][job]["flops"] for o in outs)
    np.testing.assert_allclose(total, count(mcfg, BATCH, SEQ), rtol=1e-12)


def tensor_allreduces(model, steps, remat=False, chunks=0):
    """A step's all-reduces over the tensor group, from the model's split
    leaves: a layer's two column inputs (their cotangents, in the
    backward) and two row-parallel sums (again in a remat recompute), a
    vocab-split table's lookup, a vocab-split head's input cotangent and
    its loss's max and sums (each chunk's twice under the chunk's
    checkpoint), and the clip's norm."""
    held = tensor_leaves(model)
    layers = model.cfg.num_layers
    tables = sum(1 for k in held if k.endswith("emb.embedding"))
    head = "head.kernel" in held or "mlm_out.kernel" in held
    loss = 2 * (2 * chunks if chunks else 1)
    per_step = (layers * (4 + 2 * remat) + tables
                + head * (1 + loss) + 1)
    return {"all_reduce": steps * per_step}


@pytest.mark.parametrize("world,job", _cases(), ids=_IDS)
def test_the_tensor_all_reduces_follow_their_formula(gangs, world, job):
    """`TensorShard.counts` over the run against `tensor_allreduces`; one
    gradient bucket a step, over data alone."""
    name, mesh, remat = JOBS[world][job]
    outs, _ = gangs(world)
    model = get_model(name, device="meta",
                      tensor=TensorShard(None, 0, MESHES[mesh]["tensor"]))
    want = tensor_allreduces(model, STEPS, remat)
    for o in outs:
        res = o["jobs"][job]["result"]
        assert res["tensor_collectives"] == want
        assert res["grad_allreduces"] == STEPS


def test_the_vocab_parallel_loss_is_the_whole_rows(gangs):
    """`cross_entropy` with label smoothing over a vocabulary split in
    column blocks equals the whole row's (rel 1e-6), its gradient block
    the whole gradient's columns, `_argmax` the whole row's; one max and
    one sum all-reduce for the loss, two for the top-1."""
    outs, _ = gangs(2)
    for o in outs:
        v = o["vocab"]
        np.testing.assert_allclose(v["loss"][0], v["loss"][1], rtol=1e-6)
        assert v["grad_gap"] <= 1e-7
        assert v["top1"][0] == v["top1"][1]
        assert v["counts"] == {"all_reduce": 4}


def test_a_tensor_gangs_checkpoint_restores_at_world_1_and_in_jax(
        gangs, data_and_init, devices8, tmp_path):
    """The `{data: 2, tensor: 2}` gang's checkpoints (each tensor leaf
    written as 2 blocks along its dim by the 2 data-rank-0 writers, each
    replicated leaf once): the final one restores at world 1 and in the
    JAX package with its leaves the ranks' blocks joined, bit for bit,
    and at world 1 its moments whole; the step-2 one resumes at world 1
    and in the JAX trainer to the gang's own step-3 and step-4
    losses."""
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
    by = _by_tensor(outs, "ckpt")
    blocks = [np.load(f"{ckpt}/blocks.{by[t]}.npz") for t in range(2)]
    params = dict(state.model.named_parameters())
    for key in held:
        np.testing.assert_array_equal(
            params[key].detach().numpy(),
            np.concatenate([b[key] for b in blocks], axis=held[key][3]),
            err_msg=key)
    for p in params.values():
        assert state.optimizer.state[p]["exp_avg"].shape == p.shape
    only = _only_step(ckpt, str(tmp_path / "w1"), CKPT_SAVE)
    cfg = TrainingConfig(**cfg_dict("gpt_tiny", data, steps=CKPT_STEPS,
                                    checkpoint={"directory": only,
                                                "async_save": False}))
    res = run_training(cfg, restore=True, device="cpu", log_every=1)
    assert [s for s, _ in res["losses"]] == [3, 4]
    np.testing.assert_allclose([loss for _, loss in res["losses"]],
                               gang_losses[CKPT_SAVE:], rtol=LOSS_REL)
    jtr, jmesh = _jax_trainer("gpt_tiny", "d2t2", data, devices8,
                              steps=CKPT_STEPS)
    # the JAX package's restore of the final step joins the blocks too
    jfinal = params_from_jax(jax.tree.map(np.asarray, JCheckpointManager(
        ckpt).restore(jtr.init_state(), step=CKPT_STEPS).params))
    for key in held:
        np.testing.assert_array_equal(
            jfinal[key].numpy(),
            np.concatenate([b[key] for b in blocks], axis=held[key][3]),
            err_msg=key)
    jstate = JCheckpointManager(ckpt).restore(jtr.init_state(),
                                              step=CKPT_SAVE)
    assert int(jax.device_get(jstate.step)) == CKPT_SAVE
    _, jlosses = _jax_steps(jtr, jmesh, jstate, CKPT_SAVE, CKPT_STEPS)
    np.testing.assert_allclose(jlosses, gang_losses[CKPT_SAVE:],
                               rtol=LOSS_REL)


def test_a_world_1_checkpoint_restores_into_a_tensor_gang(gangs,
                                                          world1_ckpt):
    """World 1's step-2 checkpoint (every leaf whole) restored into the
    `{tensor: 2}` gang (each rank reading its blocks' regions) trains on
    to world 1's own step-3 and step-4 losses."""
    outs, _ = gangs(2)
    w1_losses, _ = world1_ckpt
    for o in outs:
        res = o["jobs"]["restore"]["result"]
        assert [s for s, _ in res["losses"]] == [3, 4]
    np.testing.assert_allclose(_losses(outs[0]["jobs"]["restore"]),
                               w1_losses[CKPT_SAVE:], rtol=LOSS_REL)


def test_the_tensor_ranks_share_rows_and_dropout_masks(gangs, data_and_init,
                                                       jax_runs, tmp_path):
    """The tensor ranks of a data shard feed its rows (data rank d of
    data world D: the data axis alone splits the batch); with dropout on,
    the `{tensor: 2}` gang draws world 1's masks on its replicated sites:
    its losses are the port's world-1 run's (the same JAX init and
    batches), and not the dropout-free JAX trainer's."""
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    for world, job in _cases() + [(2, "dropout")]:
        outs, _ = gangs(world)
        for o in outs:
            res = o["jobs"][job]
            assert res["rows"] == [res["coords"]["data"], world // 2]
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
    jlosses, _, _ = jax_runs("bert_tiny", "t2")
    assert abs(gang[0] - jlosses[0]) > 1e-3 * abs(jlosses[0])


def test_the_bridge_loads_a_whole_leaf_into_a_block():
    """models/convert.py load_jax_params: a JAX tree's whole leaves land as
    a tensor rank's blocks (a seeded init draws them as world 1 does), and
    `join_blocks` of both ranks' state dicts is the whole tree again."""
    whole = get_model("bert_tiny", device="cpu", dtype=torch.float32, seed=5)
    tree = params_to_jax(whole.state_dict())
    parts = []
    for r in range(2):
        part = get_model("bert_tiny", device="cpu", dtype=torch.float32,
                         seed=0, tensor=TensorShard(None, r, 2))
        load_jax_params(part, tree)
        seeded = get_model("bert_tiny", device="cpu", dtype=torch.float32,
                           seed=5, tensor=TensorShard(None, r, 2))
        for name, p in part.named_parameters():
            torch.testing.assert_close(seeded.get_parameter(name), p,
                                       rtol=0, atol=0)
        assert len(tensor_leaves(part)) == 25
        parts.append(part.state_dict())
    joined = params_to_jax(join_blocks(part, parts))
    assert set(joined) == set(tree)
    for key, want in tree.items():
        np.testing.assert_array_equal(joined[key], want, err_msg=key)


REFUSED = [({"tensor": 2, "fsdp": 2}, "gpt_tiny"),
           ({"tensor": 2, "sequence": 2}, "gpt_tiny"),
           ({"tensor": 2, "expert": 2}, "gpt_tiny_moe"),
           ({"tensor": 2, "pipeline": 2}, "gpt_tiny")]


@pytest.mark.parametrize("mesh,name", REFUSED,
                         ids=["-".join(m) for m, _ in REFUSED])
def test_a_tensor_pair_is_refused_naming_its_item(mesh, name):
    """The tensor axis beside fsdp, sequence, expert or pipeline raises
    naming A13 item 9; either axis alone loads, and so do `{tensor: 2}`
    and `{data: 2, tensor: 2}` for every transformer family."""
    with pytest.raises(ConfigError, match=r"A13 item 9 \(tensor with the "
                                          r"other axes\)"):
        TrainingConfig.from_dict({"model": name, "global_batch_size": 8,
                                  "mesh": mesh})
    with pytest.raises(ConfigError, match="not ported yet"):
        MeshConfig(**mesh)
    for other in mesh:
        TrainingConfig.from_dict({"model": name, "global_batch_size": 8,
                                  "mesh": {other: 2}})
    for model in ("gpt_tiny", "gpt_small", "gpt_tiny_moe", "gpt_small_moe",
                  "bert_tiny", "bert_base", "bert_tiny_moe",
                  "bert_base_moe"):
        for ok in ({"tensor": 2}, {"data": 2, "tensor": 2}):
            assert TrainingConfig.from_dict(
                {"model": model, "global_batch_size": 8,
                 "mesh": ok}).mesh.tensor == 2


@pytest.mark.parametrize("name", ["resnet50", "mlp"])
def test_an_image_model_on_the_tensor_axis_is_refused(name):
    """The image models' tensor splits (conv_out, the classifier head)
    wait for their item: `tensor: 2` raises naming A13 item 10."""
    with pytest.raises(ConfigError, match=r"A13 item 10 \(the image models "
                                          r"under the tensor axis\)"):
        TrainingConfig.from_dict({"model": name, "global_batch_size": 8,
                                  "mesh": {"tensor": 2}})


def test_a_tensor_config_trains_through_the_launcher(gangs):
    """`runtime/launcher.py main --config FILE --device cpu` on a config
    with `mesh: {tensor: 2}` (gpt_tiny, the lm stream made on the
    device) in each rank of the pair: exit 0, the ranks' losses equal
    and within rel 1e-5 of a world-1 run of the same config, each result
    line with its tensor all-reduces and one bucket all-reduce a step."""
    from kubeflow_tpu_torch.runtime.train_run import run_training

    outs, _ = gangs(2)
    lines = [o["launch"]["line"] for o in outs]
    one = run_training(TrainingConfig(**{**LAUNCH_CFG, "mesh": {}}),
                       device="cpu")
    model = get_model("gpt_tiny", device="meta",
                      tensor=TensorShard(None, 0, 2))
    for o, line in zip(outs, lines):
        assert o["launch"]["rc"] == 0
        assert line["world_size"] == 2 and line["final_step"] == STEPS
        assert line["backend"] == "gloo"
        assert line["losses"] == lines[0]["losses"]
        assert line["tensor_collectives"] == tensor_allreduces(model, STEPS)
        assert line["grad_allreduces"] == STEPS
    np.testing.assert_allclose([loss for _, loss in lines[0]["losses"]],
                               [loss for _, loss in one["losses"]],
                               rtol=LOSS_REL)

