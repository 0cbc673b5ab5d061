"""The port's mesh, sharding-rule and gang-env layer (parallel/) against
the JAX package's on the same inputs, tests/test_mesh.py's cases on the
port, and the config's mesh refusals."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from kubeflow_tpu.config.platform import MeshConfig as JMeshConfig  # noqa: E402
from kubeflow_tpu.parallel import distributed as jdist  # noqa: E402
from kubeflow_tpu.parallel import mesh as jmeshlib  # noqa: E402
from kubeflow_tpu.parallel import sharding as jsh  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    MeshConfig,
    TrainingConfig,
)
from kubeflow_tpu_torch.parallel import distributed as dist  # noqa: E402
from kubeflow_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from kubeflow_tpu_torch.parallel import sharding as sh  # noqa: E402
from kubeflow_tpu_torch.parallel.distributed import (  # noqa: E402
    ENV_COORDINATOR,
    ENV_PROCESS_ID,
    GangEnv,
    initialize_from_env,
    render_gang_env,
)

SIZES = [dict(data=8), dict(data=2, tensor=4), dict(data=2, sequence=2),
         dict(data=4, tensor=2), dict(tensor=8), dict(data=4, pipeline=2),
         dict(data=2, fsdp=2, expert=2), dict(data=3, pipeline=2)]


def _specs(sizes):
    """(port MeshSpec, JAX MeshSpec) of the same axis sizes; the port's
    built from its axis tuple (its MeshConfig refuses non-data axes)."""
    jspec = jmeshlib.MeshSpec.from_config(JMeshConfig(**sizes))
    return meshlib.MeshSpec(jspec.axis_sizes), jspec


def _as_tuple(spec: P):
    return tuple(spec)


# -- the same outputs as the JAX functions ---------------------------------


def test_constants_are_the_references():
    assert meshlib.MESH_AXIS_ORDER == jmeshlib.MESH_AXIS_ORDER
    assert meshlib.DCN_FRIENDLY_AXES == jmeshlib.DCN_FRIENDLY_AXES
    assert sh.LOGICAL_RULES == jsh.LOGICAL_RULES
    assert dist.DEFAULT_COORDINATOR_PORT == jdist.DEFAULT_COORDINATOR_PORT
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                 "ENV_SLICE_ID", "ENV_NUM_SLICES", "ENV_WORKER_HOSTNAMES",
                 "ENV_JOB_NAME"):
        assert getattr(dist, name) == getattr(jdist, name), name


@pytest.mark.parametrize("sizes", SIZES, ids=[str(s) for s in SIZES])
def test_mesh_spec_equals_the_reference(sizes):
    mine, ref = _specs(sizes)
    assert mine.axis_names == ref.axis_names
    assert mine.shape == ref.shape and mine.num_devices == ref.num_devices
    assert mine.nontrivial_axes() == ref.nontrivial_axes()
    for axis in ref.axis_names:
        assert mine.size(axis) == ref.size(axis)
    if "data" in sizes and "tensor" not in sizes:
        port = meshlib.MeshSpec.from_config(MeshConfig(data=sizes["data"]))
        want = jmeshlib.MeshSpec.from_config(JMeshConfig(data=sizes["data"]))
        assert port == meshlib.MeshSpec(want.axis_sizes)


@pytest.mark.parametrize("sizes", SIZES, ids=[str(s) for s in SIZES])
@pytest.mark.parametrize("slices", [1, 2, 3, 4])
def test_dcn_split_equals_the_reference(sizes, slices):
    mine, ref = _specs(sizes)
    try:
        want = ref.dcn_split(slices)
    except ValueError as e:
        with pytest.raises(ValueError, match="cannot lay"):
            mine.dcn_split(slices)
        assert "cannot lay" in str(e)
        return
    assert mine.dcn_split(slices) == want


LOGICAL = [("batch", "seq", "act_embed"), ("embed", "mlp"),
           ("vocab_table", None), ("heads", None, "embed"), ("nope",),
           (None, None, "conv_in", "conv_out"), ("expert", "embed", "mlp"),
           ("stage", "embed"), ("batch",), ()]


@pytest.mark.parametrize("sizes", [None] + SIZES,
                         ids=["no-mesh"] + [str(s) for s in SIZES])
def test_logical_to_spec_equals_the_reference(sizes, devices8):
    jmesh = None
    if sizes is not None:
        n = JMeshConfig(**sizes).num_devices
        jmesh = jmeshlib.mesh_from_config(JMeshConfig(**sizes),
                                          devices=devices8[:n])
    mine = None if sizes is None else dict(zip(
        jmeshlib.MESH_AXIS_ORDER, _specs(sizes)[0].shape))
    for axes in LOGICAL:
        assert sh.logical_to_spec(axes, mesh=mine) == _as_tuple(
            jsh.logical_to_spec(axes, mesh=jmesh)), axes


def test_render_gang_env_and_gang_env_equal_the_reference():
    for hosts, slices, port in ((["h0", "h1", "h2", "h3"], 1, 8476),
                                ([f"h{i}" for i in range(8)], 2, 9000),
                                (["a"], 1, 1234)):
        mine = render_gang_env("job", hosts, slices, port)
        assert mine == jdist.render_gang_env("job", hosts, slices, port)
        for env in mine:
            assert (dataclasses_tuple(GangEnv.from_env(env))
                    == dataclasses_tuple(jdist.GangEnv.from_env(env)))
    with pytest.raises(ValueError):
        render_gang_env("j", ["a", "b", "c"], num_slices=2)
    with pytest.raises(ValueError):
        render_gang_env("j", [])


def dataclasses_tuple(g):
    return (g.job_name, g.coordinator_address, g.num_processes, g.process_id,
            g.slice_id, g.num_slices, g.is_coordinator, g.single_process)


# -- tests/test_mesh.py on the port -----------------------------------------


class TestMeshSpec:
    def test_from_config_order(self):
        spec = meshlib.MeshSpec.from_config(MeshConfig(data=8))
        assert spec.axis_names == meshlib.MESH_AXIS_ORDER
        assert spec.size("data") == 8 and spec.num_devices == 8

    def test_nontrivial_axes(self):
        spec = meshlib.MeshSpec.from_config(MeshConfig(data=2))
        assert spec.nontrivial_axes() == ["data"]

    def test_dcn_split_data_axis(self):
        spec, _ = _specs(dict(data=4, tensor=2))
        ici, dcn = spec.dcn_split(num_slices=2)
        assert dcn["data"] == 2 and ici["data"] == 2
        assert ici["tensor"] == 2 and dcn["tensor"] == 1

    def test_dcn_split_rejects_tensor_spanning(self):
        spec, _ = _specs(dict(tensor=8))
        with pytest.raises(ValueError, match="cannot lay"):
            spec.dcn_split(num_slices=2)


class TestBuildMesh:
    def test_one_rank_mesh_has_every_axis(self):
        m = meshlib.single_device_mesh(device_type="cpu")
        assert m.mesh_dim_names == meshlib.MESH_AXIS_ORDER
        assert tuple(m.shape) == (1,) * 6
        assert meshlib.mesh_shape(m)["data"] == 1
        assert meshlib.data_group(m) is None  # no process group

    def test_wrong_device_count(self):
        spec = meshlib.MeshSpec.from_config(MeshConfig(data=4))
        with pytest.raises(ValueError, match="devices"):
            meshlib.build_mesh(spec, device_type="cpu")
        with pytest.raises(ValueError, match="devices"):
            meshlib.default_mesh_for(2, device_type="cpu")

    def test_multislice_layout_is_checked(self):
        spec, _ = _specs(dict(tensor=1))
        with pytest.raises(ValueError, match="cannot lay"):
            meshlib.build_mesh(spec, device_type="cpu", num_slices=2)

    def test_default_mesh_for_refuses_an_unported_axis(self):
        # every axis is ported alone; a pair not run together is refused
        with pytest.raises(ConfigError, match="A13 item 9"):
            meshlib.default_mesh_for(8, tensor=2, fsdp=2, device_type="cpu")
        m = meshlib.default_mesh_for(1, device_type="cpu")
        assert meshlib.mesh_shape(m) == dict.fromkeys(
            meshlib.MESH_AXIS_ORDER, 1)


class TestLogicalRules:
    def test_batch_maps_to_data_fsdp(self):
        spec = sh.logical_to_spec(("batch", "seq", "act_embed"))
        assert spec[0] == ("data", "fsdp")

    def test_mesh_filtering_drops_size1(self):
        spec = sh.logical_to_spec(("batch", "seq", "act_embed"),
                                  mesh={"data": 8, "fsdp": 1})
        # the fsdp axis has size 1 → dropped; trailing Nones trimmed
        assert spec == ("data",)

    def test_unknown_logical_replicated(self):
        assert sh.logical_to_spec(("nope",)) == ()
        assert sh.is_replicated(sh.logical_to_spec(("nope", None)))

    def test_shard_constraint_is_a_no_op(self):
        x = torch.ones(4, 8)
        assert sh.shard_constraint(x, ("batch", "act_embed")) is x

    def test_param_specs(self):
        specs = sh.param_specs({"w": ("embed", "mlp"), "b": ("mlp",)},
                               mesh={"data": 2, "tensor": 4})
        assert specs == {"w": (None, "tensor"), "b": ("tensor",)}


class TestGangEnv:
    def test_render_single_slice(self):
        envs = render_gang_env("job1", ["h0", "h1", "h2", "h3"])
        assert len(envs) == 4
        assert envs[0][ENV_COORDINATOR] == "h0:8476"
        assert envs[3][ENV_PROCESS_ID] == "3"
        assert all(e[ENV_COORDINATOR] == "h0:8476" for e in envs)

    def test_render_multislice_ids(self):
        envs = render_gang_env("j", [f"h{i}" for i in range(8)], num_slices=2)
        assert envs[3]["KFT_SLICE_ID"] == "0"
        assert envs[4]["KFT_SLICE_ID"] == "1"

    def test_render_rejects_ragged(self):
        with pytest.raises(ValueError):
            render_gang_env("j", ["a", "b", "c"], num_slices=2)

    def test_from_env_defaults(self):
        g = GangEnv.from_env({})
        assert g.single_process and g.is_coordinator

    def test_initialize_single_process_noop(self):
        g = initialize_from_env({}, device="cpu")
        assert g.num_processes == 1
        assert not torch.distributed.is_initialized()
        assert dist.world_size() == 1 and dist.rank() == 0

    def test_roundtrip(self):
        envs = render_gang_env("j", ["h0", "h1"], num_slices=1)
        g = GangEnv.from_env(envs[1])
        assert g.process_id == 1
        assert g.num_processes == 2
        assert not g.is_coordinator

    def test_local_rank_counts_the_ranks_of_its_host(self):
        envs = render_gang_env("j", ["a", "a", "b", "a", "b"])
        assert [dist.local_rank(e) for e in envs] == [0, 1, 0, 2, 1]
        assert dist.local_rank({}) == 0

    def test_backend_follows_the_device(self):
        assert dist.backend_for(torch.device("cpu")) == "gloo"
        assert dist.backend_for(torch.device("cuda", 0)) == "nccl"
        assert dist.gang_device("cpu") == torch.device("cpu")

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
    def test_a_rank_without_its_card_raises(self):
        env = render_gang_env("j", ["a", "a"])[1]
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.gang_device(None, env)


# -- the config's mesh --------------------------------------------------------


UNPORTED = [("fsdp", "A13 item 1 (fsdp)"), ("tensor", "A13 item 2"),
            ("expert", "A13 item 3"), ("pipeline", "A13 item 4"),
            ("sequence", "A13 item 5")]


@pytest.mark.parametrize("axis,item", UNPORTED, ids=[a for a, _ in UNPORTED])
def test_config_refuses_each_unported_axis_naming_its_item(axis, item):
    """Each axis still unported raises naming its item; the fsdp axis (A13
    item 1), the tensor axis (A13 item 2), the sequence axis (A13 item
    5), the expert axis (A13 item 3) and the pipeline axis (A13 item 4)
    are ported, so their configs are accepted: the pipeline config's
    training block loads unedited."""
    if axis in ("fsdp", "tensor", "sequence", "expert", "pipeline"):
        cfg = TrainingConfig.from_dict({"model": "gpt_tiny",
                                        "mesh": {axis: 2}})
        assert getattr(cfg.mesh, axis) == 2
        assert getattr(MeshConfig(**{axis: 2}), axis) == 2
        if axis == "pipeline":
            import yaml

            with open(os.path.join(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), "configs",
                    "gpt_pipeline_1f1b_v5e16.yaml")) as f:
                spec = yaml.safe_load(f)
            cfg = TrainingConfig.from_dict(spec["training"])
            assert cfg.mesh.pipeline == 4
            assert cfg.pipeline_schedule == "1f1b"
        return
    with pytest.raises(ConfigError, match=item.replace("(", r"\(").replace(
            ")", r"\)")):
        TrainingConfig.from_dict({"model": "gpt_tiny", "mesh": {axis: 2}})
    with pytest.raises(ConfigError, match="not ported yet"):
        MeshConfig(**{axis: 2})


FSDP_PAIRS = ["sequence", "expert", "pipeline"]


@pytest.mark.parametrize("other", FSDP_PAIRS)
def test_config_refuses_fsdp_with_another_axis_naming_its_item(other):
    """fsdp with the sequence, expert or pipeline axis is not ported yet:
    each pair raises naming A13 item 8 (each axis alone loads)."""
    with pytest.raises(ConfigError, match=r"A13 item 8 \(fsdp with the "
                                          r"other axes\)"):
        TrainingConfig.from_dict({"model": "gpt_tiny_moe",
                                  "global_batch_size": 8,
                                  "mesh": {"fsdp": 2, other: 2}})
    with pytest.raises(ConfigError, match="not ported yet"):
        MeshConfig(fsdp=2, **{other: 2})


def test_config_takes_a_data_mesh_and_checks_it():
    cfg = TrainingConfig.from_dict({"model": "gpt_tiny", "global_batch_size": 8,
                                    "mesh": {"data": 4}})
    assert cfg.mesh.data == 4 and cfg.mesh.num_devices == 4
    assert cfg.mesh.axis_sizes() == JMeshConfig(data=4).axis_sizes()
    with pytest.raises(ConfigError, match="not divisible by data\\*fsdp"):
        TrainingConfig.from_dict({"model": "gpt_tiny", "global_batch_size": 6,
                                  "mesh": {"data": 4}})
    with pytest.raises(ConfigError, match="positive int"):
        MeshConfig(data=0)
    with pytest.raises(ConfigError, match="unknown field mesh.bogus"):
        TrainingConfig.from_dict({"model": "gpt_tiny", "mesh": {"bogus": 2}})


def test_a_data_mesh_without_its_gang_is_refused():
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(model="mlp", global_batch_size=4, dtype="float32",
                         mesh={"data": 2})
    with pytest.raises(ValueError, match="mesh spec needs 2 devices"):
        Trainer(cfg, device="cpu")
    assert os.environ.get(ENV_COORDINATOR) is None
