"""The port's sampling (kubeflow_tpu_torch/serving/sampling.py) against the
JAX package's on seeded numpy logits.

Greedy is the exact f32 argmax. The filtered logits keep JAX's -inf
pattern exactly, with finite values within 1e-6 (one division per
element). Sampled draws cannot match JAX's threefry bits: they are held
by their own determinism and by staying inside the top-k/top-p support."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.serving import sampling as jsamp  # noqa: E402
from kubeflow_tpu_torch.serving import sampling as tsamp  # noqa: E402

VOCAB = 300


def _logits(seed=0, rows=6):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, VOCAB)) * 3.0).astype(np.float32)
    logits[1, 17] = logits[1, 40] = logits[1].max() + 1.0  # an exact tie
    return logits


def test_greedy_sample_slots_matches_jax():
    logits = _logits()
    rows = logits.shape[0]
    want = np.asarray(jsamp.sample_slots(
        jnp.asarray(logits), jax.vmap(jax.random.PRNGKey)(jnp.arange(rows)),
        jnp.zeros((rows,), jnp.int32), jnp.zeros((rows,), jnp.float32),
        jnp.zeros((rows,), jnp.int32), jnp.ones((rows,), jnp.float32),
    ))
    got = tsamp.sample_slots(
        torch.from_numpy(logits), [0] * rows, [0] * rows, [0.0] * rows,
        [0] * rows, [1.0] * rows,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].item() == 17  # first index on ties, as JAX
    greedy = tsamp.sample_logits(torch.from_numpy(logits), None, 0.0)
    np.testing.assert_array_equal(greedy.numpy(), want)


KNOBS = [
    # (temps, top_ks, top_ps) per row
    ([0.7, 1.0, 1.3, 0.0, 1.0, 2.0], [0, 5, 40, 0, 1, 0],
     [1.0, 1.0, 0.9, 0.5, 0.3, 0.75]),
    ([1.0] * 6, [VOCAB, 3, 0, 10, 0, 299], [0.95, 0.2, 0.6, 1.0, 1.0, 0.99]),
]


@pytest.mark.parametrize("knobs", range(len(KNOBS)))
def test_slot_filtered_logits_matches_jax(knobs):
    temps, top_ks, top_ps = (np.asarray(k) for k in KNOBS[knobs])
    logits = _logits(seed=1 + knobs)
    want = np.asarray(jsamp.slot_filtered_logits(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_ks, jnp.int32), jnp.asarray(top_ps, jnp.float32),
    ))
    got = tsamp.slot_filtered_logits(
        torch.from_numpy(logits), torch.tensor(temps, dtype=torch.float32),
        torch.tensor(top_ks), torch.tensor(top_ps, dtype=torch.float32),
    ).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-6, rtol=1e-6)


def test_seeded_sampling_is_reproducible_and_inside_the_support():
    logits = torch.from_numpy(_logits(seed=4))
    rows = logits.shape[0]
    temps, top_ks, top_ps = [1.0] * rows, [8, 0, 3, 20, 0, 1], [1.0, 0.6, 1.0,
                                                                0.8, 0.3, 1.0]
    support = torch.isfinite(tsamp.slot_filtered_logits(
        logits, torch.tensor(temps), torch.tensor(top_ks), torch.tensor(top_ps)
    ))
    seen = set()
    for counter in range(40):
        seeds, counters = list(range(rows)), [counter] * rows
        a = tsamp.sample_slots(logits, seeds, counters, temps, top_ks, top_ps)
        b = tsamp.sample_slots(logits, seeds, counters, temps, top_ks, top_ps)
        torch.testing.assert_close(a, b)
        assert support[torch.arange(rows), a].all()
        seen.add(tuple(a.tolist()))
    assert len(seen) > 1  # the counter moves the stream
    # a top_k=1 row is its argmax whatever the draw
    assert a[5].item() == logits[5].argmax().item()


def test_sample_logits_scalar_knobs_stay_in_support():
    logits = torch.from_numpy(_logits(seed=5))
    gen = torch.Generator().manual_seed(3)
    tok = tsamp.sample_logits(logits, gen, temperature=0.8, top_k=4)
    top4 = logits.topk(4, dim=-1).indices
    assert (top4 == tok[:, None]).any(dim=-1).all()
    again = tsamp.sample_logits(
        logits, torch.Generator().manual_seed(3), temperature=0.8, top_k=4
    )
    torch.testing.assert_close(tok, again)
