"""The port's serving mesh (parallel/serving_mesh.py, serving/relay.py,
the DecodeEngine's `mesh_tensor|fsdp|expert`) against the port's own 1×1
engine, and in two cases against the JAX sharded engine, on the CPU in
f32 (the counterparts of tests/test_sharded_serving.py and the mesh
tests of tests/test_moe_serving.py).

Two gangs of gloo ranks (tests/torch_gangs.py), a pair and a quartet,
run every case in turn (tests/torch_serving_cases.py): rank 0 builds the
engine on the case's mesh and drives its traffic, every other rank runs
the relayed programs on its shard. The models are gpt_tiny and
gpt_tiny_moe from the conftest's shared fixtures, bridged through the numpy param
bridge. Gates: each case's greedy tokens equal the port's 1×1 engine's
BIT FOR BIT (the same case in this process at mesh 1×1×1); the 2×2
dense case and the expert-2 case equal the JAX sharded engine's on the
same mesh (the conftest's 8 virtual CPU devices). Beside the tokens:
resident weight bytes a rank by the specs' formula, gathers a step (int8
gathered as int8), pools sized per chip, the prefix hit and COW, the
rewinds, the host tier's spill and upload, an export/import handoff
with whole pages, the workers' pool resets on recovery, the stats,
debug, gauge and /statusz mesh fields and the KFT_SERVING_MESH_* chain
into the engine; every validation error of the JAX package's mesh
tests; the at-rest specs against the JAX `param_shardings`; and the
plain paged op's per-head bits (a rank's heads of the pool give the bits
the whole pool gives for them). The last test rehearses chip_smoke.py's
phase 24 at gpt_tiny size.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.serving.engine import DecodeEngine as JDecodeEngine  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    ServingConfig,
    ServingMeshConfig,
)
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine,
    resolve_num_pages,
)

import torch_serving_cases as cases  # noqa: E402
from torch_gangs import REPO, run_gang  # noqa: E402

MOE = "gpt_tiny_moe"

# the pair's cases, then the quartet's (name, kind, mesh, knobs)
PAIR = [
    dict(name="tensor2_page8", kind="rows", mesh={"tensor": 2},
         lens=(4, 7, 30), gathers=True),
    dict(name="tensor2_page16_gather", kind="rows", mesh={"tensor": 2},
         ps=16, impl="gather", lens=(4, 7)),
    dict(name="fsdp2", kind="rows", mesh={"fsdp": 2}, lens=(4, 7),
         gathers=True),
    dict(name="tensor2_prefix_cow", kind="prefix", mesh={"tensor": 2},
         slots=1),
    dict(name="tensor2_chunked", kind="rows", mesh={"tensor": 2}, slots=1,
         lens=(70,), new=5,
         kw={"prefill_buckets": [32], "prefix_cache": False}),
    dict(name="tensor2_spec", kind="rows", mesh={"tensor": 2}, slots=1,
         lens=(7,), draft="gpt_tiny", k=3, kw={"prefix_cache": False}),
    dict(name="tensor2_spec_hostile", kind="rows", mesh={"tensor": 2},
         slots=1, lens=(7,), draft="rolled", k=2,
         kw={"prefix_cache": False}),
    dict(name="tensor2_int8", kind="rows", mesh={"tensor": 2},
         lens=(9, 4), kw={"quantize": "int8"}, gathers=True),
    # bf16 compute: the attention outputs cross the gloo group in bf16
    dict(name="tensor2_bf16", kind="rows", mesh={"tensor": 2},
         lens=(4, 7), dtype="bfloat16"),
    dict(name="expert2", kind="rows", mesh={"expert": 2}, model=MOE,
         lens=(4, 7)),
    dict(name="expert2_page64", kind="rows", mesh={"expert": 2}, model=MOE,
         ps=64, lens=(4, 7)),
    dict(name="expert2_prefix_cow", kind="prefix", mesh={"expert": 2},
         model=MOE, slots=1),
    dict(name="expert2_chunked", kind="rows", mesh={"expert": 2},
         model=MOE, slots=1, lens=(70,), new=5,
         kw={"prefill_buckets": [32], "prefix_cache": False}),
    dict(name="expert2_spec", kind="rows", mesh={"expert": 2}, model=MOE,
         slots=1, lens=(7,), draft=MOE, k=2, kw={"prefix_cache": False}),
    dict(name="expert2_int8", kind="rows", mesh={"expert": 2}, model=MOE,
         lens=(9,), kw={"quantize": "int8"}),
    dict(name="tensor2_spill", kind="spill", mesh={"tensor": 2},
         kw={"num_pages": 24, "prefill_buckets": [8, 32],
             "kv_host_bytes": 64 << 20}),
    dict(name="tensor2_handoff", kind="handoff", mesh={"tensor": 2}),
    dict(name="tensor2_recover", kind="recover", mesh={"tensor": 2}),
    dict(name="tensor2_rest_env", kind="rest", mesh={"tensor": 2},
         env=ServingConfig.from_dict({"mesh": {"tensor": 2}}).mesh.env()),
]
QUARTET = [
    dict(name="tensor2_fsdp2", kind="rows", mesh={"tensor": 2, "fsdp": 2},
         lens=(4, 7), gathers=True),
    dict(name="expert4", kind="rows", mesh={"expert": 4}, model=MOE,
         lens=(4, 7)),
    dict(name="tensor2_expert2", kind="rows",
         mesh={"tensor": 2, "expert": 2}, model=MOE, lens=(7,),
         gathers=True),
]
CASES = {c["name"]: c for c in PAIR + QUARTET}

# One rank: every case of its gang in turn (tests/torch_serving_cases.py)
WORKER = r'''
import json, os, sys
import torch


def main():
    job = json.loads(os.environ["KFT_TEST_JOB"])
    sys.path.insert(0, job["tests"])
    import torch_serving_cases as cases
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank, shutdown)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    run = cases.run_case if rank() == 0 else cases.work_case
    out = {"rank": rank(), "cases": {
        case["name"]: run(case, job["weights"], case["mesh"])
        for case in job["cases"]}}
    shutdown()
    print("RESULT " + json.dumps(out, default=str), flush=True)
'''


@pytest.fixture(scope="module")
def weights(tmp_path_factory, gpt_and_params, gpt_moe_and_params):
    """{key: path of a saved port state dict}: gpt_tiny and gpt_tiny_moe
    bridged from the conftest's JAX params, and gpt_tiny with its head
    rolled one vocab column (a draft whose proposals are never the
    target's argmax), plus the handoff case's entries."""
    root = tmp_path_factory.mktemp("serving_mesh")
    out = {}
    for key, (_, params) in (("gpt_tiny", gpt_and_params),
                             (MOE, gpt_moe_and_params)):
        sd = params_from_jax(jax.tree.map(np.asarray, params))
        out[key] = str(root / f"{key}.pt")
        torch.save(sd, out[key])
        if key == "gpt_tiny":
            sd = dict(sd, **{"head.kernel": torch.roll(sd["head.kernel"], 1,
                                                       dims=-1)})
            out["rolled"] = str(root / "rolled.pt")
            torch.save(sd, out["rolled"])
    # the handoff's entries: a 1×1 engine's committed chain of the prompt
    from kubeflow_tpu_torch.serving.kv_tiers import encode_page_entries

    model = cases.load_model(out, "gpt_tiny")
    eng = DecodeEngine("src", model, device="cpu", num_slots=1,
                       page_size=cases.PS, paged_attention="kernel")
    try:
        prompt = cases.rows(28, salt=7)[0]
        eng.generate_row(prompt, 2, timeout=120)
        data = encode_page_entries(eng.export_prefix_entries(prompt),
                                   cases.PS, "none", model="src")
    finally:
        eng.close()
    out["entries"] = str(root / "entries.npz")
    with open(out["entries"], "wb") as f:
        f.write(data)
    return out


def _job(case, weights):
    if case["kind"] == "handoff":
        case = dict(case, entries=weights["entries"])
    return case


@pytest.fixture(scope="module")
def gangs(weights):
    """{case name: [rank 0's report, the other ranks' relayed calls...]}:
    the pair and the quartet, run at once."""
    out, errors = {}, []

    def run(world, group):
        try:
            job = {"cases": [_job(c, weights) for c in group],
                   "weights": weights,
                   "tests": os.path.join(REPO, "tests")}
            reps = run_gang(WORKER, job, world, name=f"serving-mesh-{world}")
            for case in group:
                out[case["name"]] = [r["cases"][case["name"]] for r in reps]
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w, g))
               for w, g in ((2, PAIR), (4, QUARTET))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# A gang whose rank 0 faults inside a relayed step after sending it:
# rank 0 reports and exits; the worker, inside the step's collectives,
# fails when rank 0's process is gone
BROKEN_WORKER = r'''
import json, os, sys
import torch


def main():
    job = json.loads(os.environ["KFT_TEST_JOB"])
    sys.path.insert(0, job["tests"])
    import torch_serving_cases as cases
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, rank)

    torch.set_num_threads(1)
    initialize_from_env(device="cpu")
    case = job["case"]
    if rank() > 0:
        cases.work_case(case, job["weights"], case["mesh"])
        return
    out = cases.broken_case(case, job["weights"])
    print("RESULT " + json.dumps(out, default=str), flush=True)
    os._exit(0)
'''


def test_a_fault_after_the_relay_fails_the_mesh_engine_fast(weights):
    """A relayed call that fails on rank 0 once sent leaves the workers
    out of step: rank 0's engine fails its requests at once (not at the
    relay's 600 s limit), refuses new ones, answers /healthz 503 and
    closes without waiting on the workers; when rank 0's process ends,
    the worker's collective fails and its process exits nonzero, so the
    gang ends instead of hanging."""
    import json
    import subprocess
    import sys
    import time

    from kubeflow_tpu_torch.parallel.distributed import render_gang_env
    from torch_gangs import RANK_TIMEOUT_S, free_port

    case = dict(name="tensor2_broken", kind="broken", mesh={"tensor": 2})
    job = {"case": case, "weights": weights,
           "tests": os.path.join(REPO, "tests")}
    envs = render_gang_env("serving-broken", ["127.0.0.1"] * 2,
                           coordinator_port=free_port())
    procs = []
    try:
        for e in envs:
            env = dict(os.environ, **e, KFT_TEST_JOB=json.dumps(job),
                       OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", BROKEN_WORKER + "\nmain()\n"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        out, err = procs[0].communicate(timeout=RANK_TIMEOUT_S)
        assert procs[0].returncode == 0, err[-6000:]
        t0 = time.monotonic()
        _, werr = procs[1].communicate(timeout=RANK_TIMEOUT_S)
        worker_s = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rep = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert len(rep["tokens"][0]) == 3
    assert len(rep["errors"]) == 2 and all(
        e and "serving mesh failed" in e for e in rep["errors"])
    assert rep["failed_s"] < 60
    assert rep["refused"] and "failed" in rep["refused"]
    status, body = rep["healthz"]
    assert status == 503 and body["ok"] is False
    assert rep["failed_engines"] == ["tensor2_broken"]
    assert "fault after the relayed step" in rep["broken"]
    assert rep["close_s"] < 10
    assert procs[1].returncode != 0, werr[-3000:]
    assert worker_s < 60


@pytest.fixture(scope="module")
def refs(weights):
    """{case name: the port's 1×1 engine's report of the case}."""
    return {name: cases.run_case(_job(case, weights), weights, None)
            for name, case in CASES.items()}


# -- the gangs against the 1×1 engine --------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_tokens_equal_the_1x1_engines_bit_for_bit(gangs, refs, name):
    """Every case's greedy tokens on its mesh are the 1×1 engine's, and
    its case-specific evidence shows the path it claims ran."""
    case = CASES[name]
    got, want = gangs[name][0], refs[name]
    assert got["tokens"] == want["tokens"]
    st, ref_st = got["stats"], want["stats"]
    mesh = case["mesh"]
    assert (st["mesh_tensor"], st["mesh_fsdp"], st["mesh_expert"]) == (
        mesh.get("tensor", 1), mesh.get("fsdp", 1), mesh.get("expert", 1))
    # every worker ran rank 0's program calls
    for calls in gangs[name][1:]:
        assert sum(calls.values()) > 0
    kind = case["kind"]
    if kind == "prefix":
        assert st["prefix_hit_tokens"] == ref_st["prefix_hit_tokens"] > 0
        assert st["cow_copies"] == ref_st["cow_copies"] >= 1
        assert all(calls["cow"] >= 1 for calls in gangs[name][1:])
    if case.get("k"):
        assert st["draft_proposed"] == ref_st["draft_proposed"] > 0
        assert st["draft_accepted"] == ref_st["draft_accepted"]
        assert st["rewind_pages_returned"] == ref_st["rewind_pages_returned"]
        if case["draft"] == "rolled":
            assert st["draft_accepted"] == 0
            assert st["rewind_pages_returned"] > 0
        assert st["pages_in_use"] == 0
    if kind == "spill":
        assert (st["kv_spill_pages"], st["kv_spill_hits"]) == (
            ref_st["kv_spill_pages"], ref_st["kv_spill_hits"])
        assert st["kv_spill_hits"] == 4
        assert all(calls["spill"] >= 1 and calls["upload"] >= 1
                   for calls in gangs[name][1:])
    if kind == "handoff":
        assert got["admitted"] == want["admitted"] == 3
        assert st["prefix_hit_tokens"] > 0
        # whole pages out: every rank's heads gathered
        assert got["pages"] == want["pages"] and len(got["pages"]) == 3
    if kind == "recover":
        assert got["failed"] == want["failed"] == 2
        # the reset reached the workers' pools
        assert all(calls["reset"] == 1 for calls in gangs[name][1:])
    if st["moe"] is not None:
        assert st["moe"] == ref_st["moe"]
    if "int8" in name:
        assert st["kv_pool_dtype"] == "int8"


# -- the JAX sharded engine --------------------------------------------------


@pytest.mark.parametrize("name,fixture,mesh", [
    ("tensor2_fsdp2", "gpt_and_params", {"mesh_tensor": 2, "mesh_fsdp": 2}),
    ("expert2", "gpt_moe_and_params", {"mesh_expert": 2}),
], ids=["2x2", "expert2"])
def test_meshed_tokens_equal_the_jax_sharded_engines(gangs, request, name,
                                                     fixture, mesh):
    """The JAX engine on the same mesh (8 virtual CPU devices) with the
    same geometry gives the port gang's tokens."""
    model, params = request.getfixturevalue(fixture)
    case = CASES[name]
    eng = JDecodeEngine(f"j-{name}", model, params, num_slots=cases.SLOTS,
                        max_queue=8, page_size=cases.PS, **mesh)
    try:
        futs = [eng.submit(np.asarray(r, np.int32), 6)
                for r in cases.rows(*case["lens"])]
        want = [f.wait(180)["tokens"] for f in futs]
    finally:
        eng.close()
    assert gangs[name][0]["tokens"] == want


# -- bytes, gathers and pools ------------------------------------------------


def _whole(weights, case):
    """The case's whole model as rank 0's engine holds it before the
    mesh cuts it (int8 when the case quantizes)."""
    from kubeflow_tpu_torch.models.gpt import int8_model

    model = cases.load_model(weights, case.get("model", "gpt_tiny"))
    if case.get("kw", {}).get("quantize") == "int8":
        model = int8_model(model)
    return model


def _specs(model, mesh):
    from kubeflow_tpu_torch.models.layers import QSCALE
    from kubeflow_tpu_torch.parallel.serving_mesh import serving_leaf_specs

    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()
              if not n.endswith(QSCALE)}
    return shapes, serving_leaf_specs(shapes, **mesh)


@pytest.mark.parametrize("name", ["tensor2_page8", "fsdp2", "tensor2_fsdp2",
                                  "tensor2_int8", "expert2",
                                  "tensor2_expert2"])
def test_resident_bytes_a_rank_follow_the_specs_formula(gangs, refs,
                                                        weights, name):
    """A rank holds each leaf's bytes over the product of its spec's
    axes (the expert stacks E/ep, the odd-sized leaves whole), no
    more; the 1×1 engine holds the whole model."""
    from kubeflow_tpu_torch.parallel.serving_mesh import spec_bytes

    case = CASES[name]
    model = _whole(weights, case)
    shapes, specs = _specs(model, case["mesh"])
    sd = model.state_dict()
    itemsizes = {n: sd[n].element_size() for n in shapes}
    scales = sum(t.numel() * t.element_size() for n, t in sd.items()
                 if n not in shapes)
    want = spec_bytes(shapes, itemsizes, specs, case["mesh"]) + scales
    got = gangs[name][0]["stats"]["weight_bytes_per_chip"]
    assert got == want
    assert refs[name]["stats"]["weight_bytes_per_chip"] == sum(
        t.numel() * t.element_size() for t in sd.values()) > got


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.get("gathers")])
def test_gathers_a_step_follow_the_formula(gangs, name):
    """One decode step gathers each transformer block's split leaves at
    once, one all-gather an axis they split over (a leaf outside the
    blocks alone), each leaf bringing in its whole bytes less its block's
    (an int8 leaf as int8: a quarter of its f32 bytes), and gathers the
    attention output once a layer on a tensor axis; an expert stack is
    never gathered (chip_smoke.py `mesh_formulas`, phase 24's gate)."""
    from torch_gangs import chip_smoke

    case = CASES[name]
    model = case.get("model", "gpt_tiny")
    _, collectives, moved, _ = chip_smoke().mesh_formulas(
        torch, model, case["mesh"], case.get("kw", {}).get("quantize",
                                                           "none"),
        case.get("dtype", "float32"))
    got = gangs[name][0]["gathers"]
    assert got["all_gather"] == collectives > 0
    assert got["bytes"] == moved
    layers = get_model(model, device="meta").cfg.num_layers
    assert got["heads"] == (layers if case["mesh"].get("tensor", 1) > 1
                            else 0)
    if name == "tensor2_int8":
        _, same, f32_moved, _ = chip_smoke().mesh_formulas(
            torch, model, case["mesh"], "none", "float32")
        assert same == collectives and moved < f32_moved / 2


def test_pools_are_sized_per_chip(gangs, refs):
    """Auto sizing multiplies the pages by tensor: a rank's pool bytes
    are the 1×1 engine's (the gauge and debug_state say so), the whole
    pool tensor times them; fsdp and expert leave the pool whole on
    every rank."""
    for name in ("tensor2_page8", "tensor2_fsdp2", "tensor2_expert2"):
        st, ref = gangs[name][0], refs[name]
        assert st["stats"]["pages_total"] == 2 * ref["stats"]["pages_total"]
        assert st["stats"]["kv_pool_bytes_per_chip"] == \
            ref["stats"]["kv_pool_bytes"]
        assert st["stats"]["kv_pool_bytes"] == \
            2 * st["stats"]["kv_pool_bytes_per_chip"]
        assert st["gauge"] == st["debug_bytes_per_chip"] == \
            st["stats"]["kv_pool_bytes_per_chip"]
    for name in ("fsdp2", "expert2", "expert4"):
        st, ref = gangs[name][0]["stats"], refs[name]["stats"]
        assert st["pages_total"] == ref["pages_total"]
        assert st["kv_pool_bytes_per_chip"] == st["kv_pool_bytes"] == \
            ref["kv_pool_bytes"]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_the_tensor_rule_of_pool_sizing_is_the_jax_packages(gpt_and_params,
                                                            quantize):
    from kubeflow_tpu.serving import engine as jengine

    jcfg = gpt_and_params[0].cfg
    tcfg = get_model("gpt_tiny", dtype=torch.float32, device="meta").cfg
    for t in (1, 2, 4):
        for slots, ps in ((2, 16), (8, 8)):
            assert resolve_num_pages(0, slots, tcfg, ps, quantize, t) == \
                jengine.resolve_num_pages(0, slots, jcfg, ps, quantize, t)
    assert resolve_num_pages(40, 2, tcfg, 16, quantize, 2) == 40


# -- the operator surface ------------------------------------------------------


def test_stats_debug_gauge_and_statusz_show_the_mesh(gangs):
    """build_server on a tensor-2 gang: /statusz's engine line names the
    mesh and the bytes a chip, stats() and debug_state() carry the mesh,
    and the serving_kv_pool_bytes_per_chip gauge reads a rank's pool."""
    rep = gangs["tensor2_rest_env"][0]
    st = rep["stats"]
    assert (st["mesh_tensor"], st["mesh_fsdp"], st["mesh_expert"]) == (2, 1, 1)
    assert st["kv_pool_bytes_per_chip"] * 2 == st["kv_pool_bytes"]
    assert rep["debug_mesh"] == {"tensor": 2, "fsdp": 1, "expert": 1}
    assert rep["gauge"] == rep["debug_bytes_per_chip"] == \
        st["kv_pool_bytes_per_chip"]
    assert "mesh: tensor=2 fsdp=1 expert=1" in rep["statusz"]
    assert f"({st['kv_pool_bytes_per_chip']} B/chip)" in rep["statusz"]


def test_the_mesh_env_chain_reaches_the_engine(gangs, refs):
    """ServingConfig.mesh → its KFT_SERVING_MESH_* env → build_server (rank
    0) and serve_mesh_worker (rank 1) → an engine whose programs run on
    the mesh, answering :generate as the one-card server does."""
    rep = gangs["tensor2_rest_env"][0]
    assert rep["engine_mesh"] == [2, 1, 1] and rep["meshed"]
    assert rep["tokens"] == refs["tensor2_rest_env"]["tokens"]
    assert not refs["tensor2_rest_env"]["meshed"]
    assert gangs["tensor2_rest_env"][1]["step"] > 0


# -- validation (no gang) ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    dense = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    moe = get_model(MOE, dtype=torch.float32, device="cpu")
    return dense, moe


def _refused(model, match, **kw):
    with pytest.raises(ValueError, match=match):
        DecodeEngine("bad", model, device="cpu", num_slots=1,
                     autostart=False, **kw)


def test_tensor_must_divide_heads(tiny_models):
    _refused(tiny_models[0], "num_heads", mesh_tensor=3)  # 4 heads


def test_fsdp_must_divide_hidden(tiny_models):
    _refused(tiny_models[0], "hidden_size", mesh_fsdp=3)  # hidden 64


def test_draft_shape_validated_too(tiny_models):
    draft = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                      num_heads=1, hidden_size=16, mlp_dim=32)
    _refused(tiny_models[0], "draft", draft_model=draft, num_draft_tokens=2,
             mesh_tensor=2)


def test_mesh_needs_a_gang_of_its_size(tiny_models):
    """A mesh of 16 in a process that runs alone: no gang of 16 ranks."""
    _refused(tiny_models[0], "devices", mesh_fsdp=16)
    _refused(tiny_models[1], "devices", mesh_tensor=4, mesh_expert=4)


def test_dense_model_rejected_on_an_expert_axis(tiny_models):
    _refused(tiny_models[0], "num_experts=0", mesh_expert=2)


def test_expert_must_divide_num_experts(tiny_models):
    _refused(tiny_models[1], "num_experts", mesh_expert=3)  # 4 experts


def test_topk2_rejected_on_an_expert_axis():
    model = get_model(MOE, dtype=torch.float32, device="cpu", moe_top_k=2)
    _refused(model, "moe_top_k", mesh_expert=2)


def test_a_mesh_without_the_engine_is_refused():
    from kubeflow_tpu_torch.serving.main import build_server

    with pytest.raises(ValueError, match="num_slots"):
        build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                     num_slots=0, mesh_tensor=2)


@pytest.mark.parametrize("axis", ["tensor", "fsdp", "expert"])
def test_config_rejects_bad_mesh(axis):
    """serving.mesh takes positive ints (the JAX package's
    test_config_rejects_bad_mesh and test_config_rejects_bad_expert);
    1×1×1 and an axis alone are valid, and from_dict takes the subtree."""
    for bad in (0, -1, "2"):
        with pytest.raises(ConfigError, match="serving.mesh"):
            dataclasses.replace(ServingConfig(),
                                mesh=ServingMeshConfig(**{axis: bad}))
        with pytest.raises(ConfigError, match="serving.mesh"):
            ServingConfig.from_dict({"mesh": {axis: bad}})
    ServingConfig().validate()
    cfg = ServingConfig.from_dict({"mesh": {axis: 2}})
    assert getattr(cfg.mesh, axis) == 2
    assert cfg.mesh.env()[f"KFT_SERVING_MESH_{axis.upper()}"] == "2"
    with pytest.raises(ConfigError, match="serving.mesh.pipeline"):
        ServingConfig.from_dict({"mesh": {"pipeline": 2}})


# -- the at-rest layout against the JAX package's ---------------------------------


def _trim(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("fixture,model_name,mesh", [
    ("gpt_and_params", "gpt_tiny", {"tensor": 2, "fsdp": 2}),
    ("gpt_moe_and_params", MOE, {"tensor": 2, "expert": 2}),
], ids=["gpt_tiny-2x2", "gpt_tiny_moe-tensor2xexpert2"])
def test_leaf_specs_are_the_jax_param_shardings(request, devices8, fixture,
                                                model_name, mesh):
    """Every leaf's spec on the mesh is the JAX `param_shardings`' spec
    of its flax leaf (the expert stacks pinned to the expert spec)."""
    from kubeflow_tpu.parallel.serving_mesh import (
        build_serving_mesh as jbuild,
        param_shardings,
    )
    from kubeflow_tpu_torch.models.convert import jax_path

    _, params = request.getfixturevalue(fixture)
    jmesh = jbuild(mesh.get("tensor", 1), mesh.get("fsdp", 1),
                   mesh.get("expert", 1), devices=devices8)
    flat = jax.tree_util.tree_flatten_with_path(
        param_shardings(params, jmesh))[0]
    want = {"/".join(k.key for k in path): _trim(sh.spec)
            for path, sh in flat}
    model = get_model(model_name, dtype=torch.float32, device="meta")
    shapes, specs = _specs(model, mesh)
    got = {jax_path(n): _trim(s) for n, s in specs.items()}
    assert got == want


def test_packed_int8_leaves_are_the_jax_packages(gpt_and_params):
    """pack_quantized_params of the port's envelope equals the JAX
    function's of the JAX envelope, value and scale."""
    from kubeflow_tpu.checkpointing.quantize import (
        pack_quantized_params as jpack,
        quantize_params_int8 as jquant,
    )
    from kubeflow_tpu_torch.checkpointing.quantize import (
        pack_quantized_params,
        quantize_params_int8,
    )
    from kubeflow_tpu_torch.models.convert import jax_path

    _, params = gpt_and_params
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    got = pack_quantized_params(quantize_params_int8(sd))
    want = jpack(jquant(params))
    for name, leaf in got.items():
        node = want
        for key in jax_path(name).split("/"):
            node = node[key]
        if isinstance(leaf, dict):
            np.testing.assert_array_equal(leaf["qvalue"].numpy(),
                                          np.asarray(node["qvalue"]))
            np.testing.assert_array_equal(leaf["qscale"].numpy(),
                                          np.asarray(node["qscale"]))
        else:
            assert not isinstance(node, dict)


def test_mesh_shard_blocks_and_wholes():
    """MeshShard's blocks: a dim over one axis, another over a second, and
    one dim over a tuple of axes (the first major), as a JAX
    PartitionSpec lays them out."""
    from kubeflow_tpu_torch.parallel.mesh import AxisShard, MeshShard

    whole = torch.arange(8 * 6).reshape(8, 6)
    for rt in range(2):
        for rf in range(2):
            shard = MeshShard({"tensor": AxisShard(None, rt, 2),
                               "fsdp": AxisShard(None, rf, 2)})
            blk = shard.block(whole, ("fsdp", "tensor"))
            assert torch.equal(blk, whole[rf * 4:(rf + 1) * 4,
                                          rt * 3:(rt + 1) * 3])
            blk = shard.block(whole, (("tensor", "fsdp"),))
            i = rt * 2 + rf
            assert torch.equal(blk, whole[i * 2:(i + 1) * 2])
            # an axis the shard does not hold leaves its dim whole
            assert torch.equal(shard.block(whole, ("expert",)), whole)


# -- the plain paged op's per-head bits -------------------------------------------


@pytest.mark.parametrize("s", [1, 5], ids=["decode", "window"])
def test_a_ranks_heads_give_the_whole_pools_bits(s):
    """The paged op on the CPU (the kernels' plain version) over a rank's
    heads of q and the pool equals the same heads of the whole call, bit
    for bit, int8 pools too: attention is per head, and no head's bits
    depend on how many heads share the call."""
    from kubeflow_tpu_torch.ops.attention import quantize_kv
    from kubeflow_tpu_torch.ops.paged_attention import paged_attention

    g = torch.Generator().manual_seed(0)
    b, h, d, ps, pages, mp = 3, 4, 16, 8, 12, 4
    q = torch.randn(b, s, h, d, generator=g)
    pk = torch.randn(pages, ps, h, d, generator=g)
    pv = torch.randn(pages, ps, h, d, generator=g)
    table = torch.randperm(pages, generator=g)[:b * mp].reshape(b, mp).int()
    cursors = torch.tensor([3, 17, 25], dtype=torch.int32)
    for quantized in (False, True):
        kw, half = {}, {}
        k, v = pk, pv
        if quantized:
            (k, ks), (v, vs) = quantize_kv(pk), quantize_kv(pv)
            kw = {"k_scale": ks, "v_scale": vs}
            half = {n: t[:, :, 2:] for n, t in kw.items()}
        whole = paged_attention(q, k, v, table, cursors,
                                dtype=torch.float32, **kw)
        part = paged_attention(q[:, :, 2:].contiguous(),
                               k[:, :, 2:].contiguous(),
                               v[:, :, 2:].contiguous(), table, cursors,
                               dtype=torch.float32,
                               **{n: t.contiguous() for n, t in half.items()})
        assert torch.equal(part, whole[:, :, 2:])


# -- chip_smoke.py's phase 24 at test size ----------------------------------------


def test_chip_smoke_phase24_rehearsed_on_the_cpu(tmp_path):
    """Phase 24's cells as chip_smoke.py runs them (the pair's and the
    quartet's serving runs, then main's gates on their reports) at
    gpt_tiny size on the CPU: every cell's tokens equal its 1×1
    reference, bytes and launches their formulas."""
    from torch_gangs import SMOKE_SERVE, rehearse_smoke

    out = rehearse_smoke(tmp_path, serve=SMOKE_SERVE)
    assert set(out["serve"]) == {"24a", "24b", "24c", "24d"}
