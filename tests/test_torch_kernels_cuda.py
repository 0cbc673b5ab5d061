"""Card-only tests of the port's hand-written CUDA kernels (marked `cuda`;
each skips where there is no CUDA device). No JAX here: on the card run

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Each kernel is held against its plain PyTorch version on the same inputs:
atol 1e-5 in f32 (summation order), 2e-2 in bf16 (one bf16 ulp of a
rounded score, probability or output element). End to end, the engine's
greedy f32 tokens through the kernels equal `generate()` exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.ops import paged_attention as tpa  # noqa: E402

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MAX_LEN, PS, NUM_PAGES = 256, 16, 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(dev, s, h, d, dtype, seed=0):
    """Cursors 0, a page boundary (15, 16), max_len - 1, a parked row
    (max_len) and one mid-window row; distinct pages per slot up to its
    last live page, out-of-range garbage past it."""
    g = torch.Generator().manual_seed(seed)
    cursors = torch.tensor([0, PS - 1, PS, MAX_LEN - 1, MAX_LEN, 77],
                           dtype=torch.int32)
    b, mp = cursors.numel(), MAX_LEN // PS
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    pk = torch.randn((NUM_PAGES, PS, h, d), generator=g).to(dtype)
    pv = torch.randn((NUM_PAGES, PS, h, d), generator=g).to(dtype)
    table = torch.full((b, mp), 10**6, dtype=torch.int32)
    perm = torch.randperm(NUM_PAGES, generator=g).tolist()
    for i, cur in enumerate(cursors.tolist()):
        live = min((cur + s - 1) // PS, mp - 1) + 1
        table[i, :live] = torch.tensor(perm[:live], dtype=torch.int32)
        perm = perm[live:] or torch.randperm(NUM_PAGES, generator=g).tolist()
    return [t.to(dev) for t in (q, pk, pv, table, cursors)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 5, 16, 64])
def test_kernel_matches_plain_version(cuda, s, d, dtype):
    q, pk, pv, table, cursors = _case(cuda, s, 4, d, dtype)
    tpa.reset_launch_counts()
    got = tpa.paged_attention(q, pk, pv, table, cursors, dtype=dtype)
    want = tpa.paged_attention_reference(q, pk, pv, table, cursors,
                                         dtype=dtype)
    torch.cuda.synchronize()
    assert tpa.launch_counts[tpa.kernel_name(s)] == 1
    # parked rows included: both versions write zeros there
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[dtype], rtol=0)
    assert not got[cursors >= MAX_LEN].any()


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, pk, pv, table, cursors = _case(cuda, 1, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        tpa.paged_attention(q[..., :48].contiguous(), pk[..., :48].contiguous(),
                            pv[..., :48].contiguous(), table, cursors,
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, pk, pv, table.long(), cursors,
                            dtype=torch.float32)


def test_engine_through_the_kernels_equals_generate(cuda):
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model("gpt_tiny", dtype=torch.float32, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 512, n) for n in (4, 7, 40)]
    tpa.reset_launch_counts()
    eng = DecodeEngine("tiny", model, device=cuda, num_slots=2, page_size=8,
                       paged_attention="kernel", prefill_buckets=(8, 16))
    try:
        got = [f.wait(120)["tokens"]
               for f in [eng.submit(r, 8) for r in rows]]
        stats = eng.stats()
    finally:
        eng.close()
    for r, toks in zip(rows, got):
        assert toks == generate(model, r[None], 8)[0, len(r):].tolist()
    assert stats["attention_kernel"] == "kernel"
    assert tpa.launch_counts["paged_decode"] == 2 * stats["decode_steps"]
    assert tpa.launch_counts["paged_window"] > 0
