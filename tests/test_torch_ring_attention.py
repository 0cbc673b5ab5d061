"""The port's ring attention (parallel/ring_attention.py) against the JAX
package's `ring_attention` on a `sequence: 2 | 4` mesh, on the CPU in
f32 (mirrors tests/test_ring_attention.py).

The port runs in gangs of 2 and 4 gloo ranks (tests/torch_gangs.py),
one gang per size running every case; rank r holds positions [r·s,
(r+1)·s) of each sequence and writes its output and its q/k/v
gradients (of the fixed cotangent `cot`) to an npz. The JAX function
runs on the conftest's virtual CPU devices (its flash blocks in Pallas
interpret mode), on the same numpy inputs. Cases: no mask, a key mask,
causal, causal with a key mask, each by flash blocks (the kernels'
plain versions on the CPU) and by dense blocks. Bounds: outputs and
gradients within 1e-5 (f32; the two frameworks sum in other orders).

Inside the port: without a sequence axis `ring_attention` is
`dense_attention`; and one rank's block loop (`ring_pass`) run in one
process on blocks sliced from the global arrays gives the gang's
output and query gradient bit for bit, and its K/V gradients bit for
bit once summed in the order the ring's backward sums them (the owner's
use first, then each later rank's, right-nested).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from kubeflow_tpu.config.platform import MeshConfig  # noqa: E402
from kubeflow_tpu.ops.attention import (  # noqa: E402
    dense_attention as jdense_attention,
)
from kubeflow_tpu.parallel.mesh import mesh_from_config, set_mesh  # noqa: E402
from kubeflow_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention as jring_attention,
)
from kubeflow_tpu_torch.ops.attention import dense_attention  # noqa: E402
from kubeflow_tpu_torch.parallel import ring_attention as rp  # noqa: E402
from torch_gangs import run_gang  # noqa: E402

TOL = 1e-5
B, S, H, D = 2, 32, 4, 8
# (name, key mask, causal, block impl)
CASES = [(f"{'mask' if m else 'plain'}-{'causal' if c else 'full'}-{i}",
          m, c, i) for m, c, i in itertools.product(
              (False, True), (False, True), ("flash", "dense"))]

# one rank: every case on its shard, outputs and gradients to an npz
WORKER = r'''
import json, os
import numpy as np
import torch


def main():
    torch.set_num_threads(1)
    from kubeflow_tpu_torch.parallel.distributed import (
        initialize_from_env, shutdown)
    from kubeflow_tpu_torch.parallel.mesh import SequenceShard
    from kubeflow_tpu_torch.parallel.ring_attention import ring_attention

    job = json.loads(os.environ["KFT_TEST_JOB"])
    initialize_from_env(device="cpu")
    r = torch.distributed.get_rank()
    n = torch.distributed.get_world_size()
    shard = SequenceShard(None, r, n)
    data = np.load(job["inputs"])
    s = data["q"].shape[1] // n
    cols = slice(r * s, (r + 1) * s)
    out = {}
    for name, masked, causal, impl in job["cases"]:
        q, k, v = (torch.from_numpy(data[x][:, cols]).requires_grad_()
                   for x in "qkv")
        mask = torch.from_numpy(data["mask"][:, cols]) if masked else None
        o = ring_attention(q, k, v, mask, dtype=torch.float32,
                           causal=causal, impl=impl, shard=shard)
        (o * torch.from_numpy(data["cot"][:, cols])).sum().backward()
        out[name + "/o"] = o.detach().numpy()
        for x, t in zip("qkv", (q, k, v)):
            out[f"{name}/d{x}"] = t.grad.numpy()
    np.savez(f"{job['out']}.{r}.npz", **out)
    torch.distributed.barrier()
    shutdown()
    print("RESULT " + json.dumps({"rank": r}), flush=True)
'''


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, cot = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                    for _ in range(4))
    mask = rng.random((B, S)) < 0.8
    mask[:, 0] = True  # every row sees a key
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": mask}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    arrays = _inputs()
    path = str(root / "inputs.npz")
    np.savez(path, **arrays)
    return path, arrays


@pytest.fixture(scope="module", params=[2, 4], ids=["seq2", "seq4"])
def gang(request, inputs, tmp_path_factory):
    """(world, {case/key: the global array}) of one gang."""
    world = request.param
    path, _ = inputs
    out = str(tmp_path_factory.mktemp(f"ring{world}") / "out")
    run_gang(WORKER, {"inputs": path, "out": out, "cases": CASES}, world)
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]
    return world, {key: np.concatenate([rk[key] for rk in ranks], 1)
                   for key in ranks[0]}


def _jax_case(arrays, world, masked, causal, impl, devices):
    mesh = mesh_from_config(MeshConfig(sequence=world),
                            devices=devices[:world])
    spec = NamedSharding(mesh, P(None, "sequence"))
    cot = arrays["cot"]
    mask = jnp.asarray(arrays["mask"]) if masked else None

    def f(q, k, v):
        o = jring_attention(q, k, v, mask, dtype=jnp.float32, causal=causal,
                            impl=impl)
        return (o * cot).sum(), o

    with set_mesh(mesh):
        (_, o), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(
                *(jax.device_put(arrays[x], spec) for x in "qkv"))
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_port_ring_equals_the_jax_ring(gang, inputs, devices8, case):
    world, got = gang
    name, masked, causal, impl = case
    o, grads = _jax_case(inputs[1], world, masked, causal, impl, devices8)
    np.testing.assert_allclose(got[name + "/o"], o, atol=TOL, rtol=0)
    for x, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"{name}/d{x}"], g, atol=TOL, rtol=0,
                                   err_msg=f"d{x}")


def test_without_a_sequence_axis_it_is_dense_attention():
    arrays = _inputs()
    q, k, v = (torch.from_numpy(arrays[x]) for x in "qkv")
    mask = torch.from_numpy(arrays["mask"])
    for causal in (False, True):
        got = rp.ring_attention(q, k, v, mask, dtype=torch.float32,
                                causal=causal)
        want = dense_attention(q, k, v, mask=mask, dtype=torch.float32,
                               causal=causal)
        assert torch.equal(got, want)
        jwant = jdense_attention(*(jnp.asarray(arrays[x]) for x in "qkv"),
                                 mask=jnp.asarray(arrays["mask"]),
                                 dtype=jnp.float32, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                   atol=TOL, rtol=0)


def _one_process(arrays, world, masked, causal, impl):
    """Every rank's `ring_pass` in this process on sliced blocks → (o,
    dq, dk, dv) global, each block's K/V gradient summed as the ring's
    backward sums it."""
    s = S // world
    blocks = [slice(i * s, (i + 1) * s) for i in range(world)]
    cot = torch.from_numpy(arrays["cot"])
    outs, dqs, dkv = [], [], {}
    for idx in range(world):
        q = torch.from_numpy(arrays["q"][:, blocks[idx]]).requires_grad_()
        kvs = [torch.stack([torch.from_numpy(arrays["k"][:, b]),
                            torch.from_numpy(arrays["v"][:, b])])
               .requires_grad_() for b in blocks]
        masks = [torch.from_numpy(arrays["mask"][:, b]).to(torch.int32)
                 if masked else None for b in blocks]

        def rotate(t, _kv, _m, idx=idx):
            src = (idx - t - 1) % world
            return kvs[src], masks[src]

        o = rp.ring_pass(q, kvs[idx], masks[idx], idx, world, rotate,
                         dtype=torch.float32, causal=causal, impl=impl)
        grads = torch.autograd.grad(o, [q] + kvs, cot[:, blocks[idx]])
        outs.append(o.detach())
        dqs.append(grads[0])
        for src, g in enumerate(grads[1:]):
            dkv[(idx, src)] = g
    # the owner's use, plus what arrives from the next rank (its use,
    # plus what arrives from the one after), right-nested
    kv_grads = []
    for src in range(world):
        total = dkv[((src + world - 1) % world, src)]
        for hop in range(world - 2, -1, -1):
            total = dkv[((src + hop) % world, src)] + total
        kv_grads.append(total)
    return (torch.cat(outs, 1), torch.cat(dqs, 1),
            torch.cat([g[0] for g in kv_grads], 1),
            torch.cat([g[1] for g in kv_grads], 1))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_process_ring_pass_is_the_gang_bitwise(gang, case):
    world, got = gang
    name, masked, causal, impl = case
    o, dq, dk, dv = _one_process(_inputs(), world, masked, causal, impl)
    for key, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_array_equal(got[f"{name}/{key}"], t.numpy(),
                                      err_msg=key)


def test_block_kinds_follow_global_positions():
    kinds = [[rp.block_kind(i, s, True) for s in range(4)] for i in range(4)]
    assert kinds[0] == ["diagonal", "invisible", "invisible", "invisible"]
    assert kinds[2] == ["full", "full", "diagonal", "invisible"]
    assert {rp.block_kind(i, s, False) for i in range(4)
            for s in range(4)} == {"full"}


def test_the_merge_of_a_fully_masked_block_is_finite():
    """A flash block whose keys are all masked has lse about -1e30: merged
    into the running -inf and then beside a visible block, neither the
    forward nor the backward makes a NaN."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 4, 2, 8), generator=g) for _ in range(3))
    masked = torch.zeros((1, 4), dtype=torch.int32)
    q.requires_grad_()
    o = torch.zeros((1, 4, 2, 8))
    lse = torch.full((1, 2, 4), float("-inf"))
    o, lse = rp.ring_step(q, k, v, masked, o, lse, "full")
    assert (lse < -1e29).all() and not o.any()
    o, lse = rp.ring_step(q, k, v, None, o, lse, "full")
    (o.sum() + lse.sum()).backward()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert torch.isfinite(q.grad).all()
    want, _ = rp.block_attn(q.detach(), k, v, None, torch.float32)
    torch.testing.assert_close(o, want, atol=1e-6, rtol=0)
