"""The port's Ulysses attention (parallel/ulysses.py) against the JAX
package's `ulysses_attention`, on the CPU in f32: the cases of
tests/test_ulysses.py `TestUlyssesNumerics`.

The port runs in gangs of 2 and 4 gloo ranks (tests/torch_gangs.py),
one gang per size running every case and writing each rank's output
(and, where the case has one, its q/k/v gradients of a fixed
cotangent) to an npz; the JAX function runs on a `sequence: 2 | 4` mesh
of the conftest's virtual CPU devices on the same numpy inputs. Bounds:
within 1e-5 (f32, summation order). Cases: with and without a padding
mask (the local attention by the auto policy: dense off the card, in
both packages); the flash kernels forced per rank, causal and not, with
gradients; the padding mask on the flash leg; heads that do not divide
over the ring, which take the dense formulation with the reference's
warning. A global sequence that does not divide over the ring raises
the reference's message where the port splits it (training/data.py
`local_columns`), and without a sequence axis the function is dense
attention.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from kubeflow_tpu.config.platform import MeshConfig  # noqa: E402
from kubeflow_tpu.parallel.mesh import mesh_from_config, set_mesh  # noqa: E402
from kubeflow_tpu.parallel.ulysses import (  # noqa: E402
    ulysses_attention as julysses_attention,
)
from kubeflow_tpu_torch.parallel import ulysses as up  # noqa: E402
from kubeflow_tpu_torch.training.data import local_columns  # noqa: E402
from torch_gangs import run_gang  # noqa: E402

TOL = 1e-5


def _heads(world):
    """A head count the ring does not divide."""
    return 3 if world == 2 else 6


def cases(world):
    """(name, shape (b, s, h, d), padding mask, causal, impl, local_impl,
    with gradients)."""
    return [
        ("seq-mesh", (2, 32, 4, 16), False, False, "flash", None, False),
        ("seq-mesh-mask", (2, 32, 4, 16), True, False, "flash", None, False),
        ("flash-local", (2, 64, 4, 16), False, False, "flash", "flash", True),
        ("flash-local-causal", (2, 64, 4, 16), False, True, "flash", "flash",
         True),
        ("flash-local-mask", (2, 64, 4, 16), True, False, "flash", "flash",
         False),
        ("dense-causal", (2, 32, 4, 16), True, True, "dense", None, True),
        ("indivisible-heads", (2, 32, _heads(world), 16), False, False,
         "flash", None, True),
    ]


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    b, s = shape[:2]
    # row 0 sees every key, row 1 the first half (the JAX tests' mask)
    mask = np.arange(s)[None, :] < np.array([[s], [s // 2]])
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": mask}


WORKER = r'''
import json, logging, os
import numpy as np
import torch


class Keep(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def main():
    torch.set_num_threads(1)
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, shutdown)
    from kubeflow_tpu_torch.parallel.mesh import SequenceShard
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention

    job = json.loads(os.environ["KFT_TEST_JOB"])
    initialize_from_env(device="cpu")
    r = torch.distributed.get_rank()
    n = torch.distributed.get_world_size()
    keep = Keep()
    logging.getLogger("kubeflow_tpu_torch.parallel.ulysses").addHandler(keep)
    shard = SequenceShard(None, r, n)
    out, warned = {}, {}
    for i, (name, shape, masked, causal, impl, local, grads) in enumerate(
            job["cases"]):
        data = np.load(f"{job['inputs']}.{i}.npz")
        s = shape[1] // n
        cols = slice(r * s, (r + 1) * s)
        q, k, v = (torch.from_numpy(data[x][:, cols]).requires_grad_()
                   for x in "qkv")
        mask = torch.from_numpy(data["mask"][:, cols]) if masked else None
        before = len(keep.messages)
        o = ulysses_attention(q, k, v, mask=mask, dtype=torch.float32,
                              causal=causal, impl=impl, local_impl=local,
                              shard=shard)
        warned[name] = keep.messages[before:]
        out[name + "/o"] = o.detach().numpy()
        if grads:
            (o * torch.from_numpy(data["cot"][:, cols])).sum().backward()
            for x, t in zip("qkv", (q, k, v)):
                out[f"{name}/d{x}"] = t.grad.numpy()
    np.savez(f"{job['out']}.{r}.npz", **out)
    torch.distributed.barrier()
    shutdown()
    print("RESULT " + json.dumps({"rank": r, "warned": warned}), flush=True)
'''


@pytest.fixture(scope="module", params=[2, 4], ids=["seq2", "seq4"])
def gang(request, tmp_path_factory):
    """(world, {case/key: the global array}, rank 0's warnings a case)."""
    world = request.param
    root = tmp_path_factory.mktemp(f"ulysses{world}")
    for i, case in enumerate(cases(world)):
        np.savez(str(root / f"in.{i}.npz"), **_arrays(case[1], i))
    out = str(root / "out")
    results = run_gang(WORKER, {"inputs": str(root / "in"), "out": out,
                                "cases": cases(world)}, world)
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]
    return world, {key: np.concatenate([rk[key] for rk in ranks], 1)
                   for key in ranks[0]}, results[0]["warned"]


def _jax_case(world, case, seed, devices):
    name, shape, masked, causal, impl, local, grads = case
    arrays = _arrays(shape, seed)
    mesh = mesh_from_config(MeshConfig(sequence=world),
                            devices=devices[:world])
    spec = NamedSharding(mesh, P(None, "sequence"))
    mask = jnp.asarray(arrays["mask"]) if masked else None

    def f(q, k, v):
        o = julysses_attention(q, k, v, mask=mask, dtype=jnp.float32,
                               causal=causal, impl=impl, local_impl=local)
        return (o * arrays["cot"]).sum(), o

    args = [jax.device_put(arrays[x], spec) for x in "qkv"]
    with set_mesh(mesh):
        if not grads:
            return np.asarray(jax.jit(lambda *a: f(*a)[1])(*args)), None
        (_, o), g = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.mark.parametrize("index", range(len(cases(2))),
                         ids=[c[0] for c in cases(2)])
def test_the_port_ulysses_equals_the_jax_ulysses(gang, devices8, index):
    world, got, warned = gang
    case = cases(world)[index]
    name = case[0]
    o, grads = _jax_case(world, case, index, devices8)
    np.testing.assert_allclose(got[name + "/o"], o, atol=TOL, rtol=0)
    if grads is not None:
        for x, g in zip("qkv", grads):
            np.testing.assert_allclose(got[f"{name}/d{x}"], g, atol=TOL,
                                       rtol=0, err_msg=f"d{x}")
    # the reference's warning, exactly where the heads do not divide
    downgraded = [m for m in warned[name] if "not divisible by the "
                  "sequence mesh axis" in m]
    assert bool(downgraded) == (name == "indivisible-heads"), warned[name]


def test_an_indivisible_sequence_length_fails_with_the_requirement():
    with pytest.raises(ValueError, match="divisible by the sequence"):
        local_columns(30, 0, 4)
    assert local_columns(32, 3, 4) == slice(24, 32)


def test_without_a_sequence_axis_it_is_a_no_op(caplog):
    arrays = _arrays((2, 16, 4, 8), 1)
    q, k, v = (torch.from_numpy(arrays[x]) for x in "qkv")
    with caplog.at_level(logging.WARNING):
        got = up.ulysses_attention(q, k, v, dtype=torch.float32)
    want = julysses_attention(*(jnp.asarray(arrays[x]) for x in "qkv"),
                              dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert not caplog.records
