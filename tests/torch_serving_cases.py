"""The serving-mesh cases of tests/test_torch_serving_mesh.py: each case
builds the port's engine with its knobs, drives its traffic and reports
what came out (tokens, and the evidence the test holds). The same case
runs on rank 0 of a CPU gang on its mesh (`run_case(..., mesh)`, every
other rank running `work_case`) and in the test's process on one card
(`run_case(..., None)`, the 1×1 reference). Imports no JAX."""

import os

import numpy as np
import torch

# page size, slots and prefill buckets of the cases (the JAX sharded
# serving tests' geometry)
PS = 8
SLOTS = 2


def rows(*lens, salt=0):
    """The JAX sharded serving tests' deterministic prompts."""
    return [((np.arange(n) * (3 + 2 * i) + i + 1 + salt) % 512).tolist()
            for i, n in enumerate(lens)]


def load_model(weights, name, key=None, device="cpu", dtype="float32"):
    """Registry model `name` computing in `dtype` with the state dict
    saved at `weights[key or name]` (the test's bridge of the JAX
    weights, f32 at rest)."""
    from kubeflow_tpu_torch.models.registry import get_model

    model = get_model(name, dtype=getattr(torch, dtype), device=device)
    model.load_state_dict(torch.load(weights[key or name], weights_only=True))
    return model


def _models(case, weights):
    dtype = case.get("dtype", "float32")
    model = load_model(weights, case.get("model", "gpt_tiny"), dtype=dtype)
    draft = None
    if case.get("draft"):
        draft = load_model(weights, case.get("model", "gpt_tiny"),
                           case["draft"], dtype=dtype)
    return model, draft


def _mesh_kw(mesh):
    mesh = mesh or {}
    return {"mesh_tensor": mesh.get("tensor", 1),
            "mesh_fsdp": mesh.get("fsdp", 1),
            "mesh_expert": mesh.get("expert", 1)}


def _engine(case, model, draft, mesh, **extra):
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    kw = dict(num_slots=case.get("slots", SLOTS), max_queue=8,
              page_size=case.get("ps", PS),
              paged_attention=case.get("impl", "kernel"),
              **case.get("kw", {}), **extra)
    if draft is not None:
        kw.update(draft_model=draft, num_draft_tokens=case["k"])
    return DecodeEngine(case["name"], model, device="cpu",
                        **kw, **_mesh_kw(mesh))


def _digest(t: torch.Tensor) -> str:
    import hashlib

    t = t.detach().cpu().contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def _evidence(eng) -> dict:
    st = eng.stats()
    dbg = eng.debug_state()
    from kubeflow_tpu_torch.utils.metrics import default_registry

    gauge = default_registry().get("serving_kv_pool_bytes_per_chip")
    return {"stats": {k: st[k] for k in (
                "mesh_tensor", "mesh_fsdp", "mesh_expert", "kv_pool_bytes",
                "kv_pool_bytes_per_chip", "weight_bytes_per_chip",
                "pages_total", "pages_in_use", "prefix_hit_tokens",
                "cow_copies", "rewind_pages_returned", "draft_proposed",
                "draft_accepted", "kv_spill_pages", "kv_spill_hits",
                "prefill_compute_tokens", "moe", "kv_pool_dtype")},
            "debug_mesh": dbg["mesh"],
            "debug_bytes_per_chip": dbg["kv_pool_bytes_per_chip"],
            "gauge": gauge.value(model=eng.name)}


def _rows_case(case, eng):
    futs = [eng.submit(r, case.get("new", 6)) for r in rows(*case["lens"])]
    return {"tokens": [f.wait(120)["tokens"] for f in futs]}


def _prefix_case(case, eng):
    base = rows(20)[0]
    div = list(base)
    div[18:] = [(t + 101) % 512 for t in div[18:]]
    return {"tokens": [eng.generate_row(r, 6, timeout=120)["tokens"]
                       for r in (base, base, div, base)]}


def _spill_traffic():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 24)
    row_a = np.concatenate([shared, rng.integers(0, 512, 8)])
    row_b = np.concatenate([shared, rng.integers(0, 512, 8)])
    fills = [rng.integers(0, 512, 32) for _ in range(6)]
    return [(row_a, 6), *((f, 4) for f in fills), (row_b, 6), (row_a, 6)]


def _spill_case(case, eng):
    return {"tokens": [eng.generate_row(r, n, timeout=120)["tokens"]
                       for r, n in _spill_traffic()]}


def _handoff_case(case, eng):
    """Import the entries the test exported from a 1×1 engine (each rank
    writes its heads), serve their prompt (a hit on them), then export
    the chain again (every rank's heads gathered): tokens and the
    exported pages' digests."""
    from kubeflow_tpu_torch.serving.kv_tiers import decode_page_entries

    with open(case["entries"], "rb") as f:
        _, entries = decode_page_entries(f.read())
    admitted = eng.import_page_entries(entries)
    prompt = rows(28, salt=7)[0]
    tokens = eng.generate_row(prompt, 6, timeout=120)["tokens"]
    pages = [{name: _digest(t) for name, t in sorted(target.items())}
             for _, target, _, _ in eng.export_prefix_entries(prompt)]
    return {"tokens": [tokens], "admitted": admitted, "pages": pages}


def _recover_case(case, eng):
    """An engine.step fault with two requests resident (rank 0's chaos
    point fires before the step is relayed), then the same requests
    again on the reset pools."""
    from kubeflow_tpu_torch.chaos import default_chaos, parse_point

    default_chaos().arm([parse_point("engine.step:after=2,once")])
    try:
        futs = [eng.submit(r, 6) for r in rows(4, 7)]
        failed = 0
        for f in futs:
            try:
                f.wait(120)
            except RuntimeError:
                failed += 1
    finally:
        default_chaos().disarm()
    out = _rows_case({"lens": (4, 7)}, eng)
    out["failed"] = failed
    return out


def broken_case(case, weights):
    """Rank 0's side of a fault inside its own run of a relayed decode
    step, after the step was sent: the workers are then inside the
    step's collectives, out of step, and no reset can reach them. One
    request served first, then two whose step fails → the tokens, each
    failed request's error and how long they took, the refusal of a new
    request, /healthz, the relay's state and how long close() took."""
    import time

    from kubeflow_tpu_torch.serving.server import ModelServer

    model, draft = _models(case, weights)
    eng = _engine(case, model, draft, case["mesh"])
    server = ModelServer(statusz_enabled=False)
    server.add_engine(eng)
    first = eng.generate_row(rows(4)[0], 3, timeout=120)["tokens"]

    def step(*args, **kwargs):
        raise RuntimeError("a fault after the relayed step was sent")

    eng.programs._programs.step = step
    t0 = time.monotonic()
    errors = []
    for fut in [eng.submit(r, 6) for r in rows(4, 7)]:
        try:
            fut.wait(120)
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    failed_s = time.monotonic() - t0
    try:
        eng.submit(rows(4)[0], 2)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    status, body, _ = server.app.handle_full("GET", "/healthz")
    t0 = time.monotonic()
    eng.close()
    return {"tokens": [first], "errors": errors, "failed_s": failed_s,
            "refused": refused, "healthz": [status, body],
            "failed_engines": server.failed_engines(),
            "broken": repr(eng.programs.broken),
            "close_s": time.monotonic() - t0}


def _rest_case(case, weights, mesh):
    """build_server with the mesh from KFT_SERVING_MESH_* (the env a
    ServingConfig's `mesh.env()` renders): :generate, /statusz's mesh
    line and the per-chip gauge."""
    from kubeflow_tpu_torch.serving.main import build_server

    os.environ.update(case["env"] if mesh else {})
    try:
        params = torch.load(weights["gpt_tiny"], weights_only=True)
        server = build_server("gpt_tiny", params=params, device="cpu",
                              dtype=torch.float32, num_slots=SLOTS,
                              page_size=PS, batch_window_ms=0,
                              paged_attention="kernel")
    finally:
        for key in case["env"]:
            os.environ.pop(key, None)
    try:
        engine = server.engine("gpt_tiny")
        tokens = []
        for row in rows(4, 7):
            status, resp, _ = server.app.handle_full(
                "POST", "/v1/models/gpt_tiny:generate",
                {"prompt_ids": [row], "max_new_tokens": 6})
            assert status == 200, (status, resp)
            body = resp if isinstance(resp, dict) else resp.body
            tokens.append(body["sequences"][0][len(row):])
        status, resp, _ = server.app.handle_full("GET", "/statusz")
        statusz = resp.body.decode() if hasattr(resp, "body") else str(resp)
        out = {"tokens": tokens, "statusz": statusz,
               "engine_mesh": [engine.mesh_tensor, engine.mesh_fsdp,
                               engine.mesh_expert],
               "meshed": engine.mesh is not None}
        out.update(_evidence(engine))
        return out
    finally:
        server.close()


KINDS = {"rows": _rows_case, "prefix": _prefix_case, "spill": _spill_case,
         "handoff": _handoff_case, "recover": _recover_case}


def run_case(case, weights, mesh):
    """The case on rank 0 of `mesh` (None: one card) → its report."""
    if case["kind"] == "rest":
        return _rest_case(case, weights, mesh)
    model, draft = _models(case, weights)
    eng = _engine(case, model, draft, mesh)
    try:
        out = KINDS[case["kind"]](case, eng)
        out.update(_evidence(eng))
        if case.get("gathers"):
            from torch_gangs import chip_smoke

            out["gathers"] = chip_smoke().step_gathers(torch, eng)
    finally:
        eng.close()
    return out


def work_case(case, weights, mesh):
    """A rank above 0's side of the case → its relayed calls."""
    if case["kind"] == "rest":
        from kubeflow_tpu_torch.serving.main import serve_mesh_worker

        os.environ.update(case["env"])
        try:
            params = torch.load(weights["gpt_tiny"], weights_only=True)
            return serve_mesh_worker("gpt_tiny", params=params, device="cpu",
                                     dtype=torch.float32)
        finally:
            for key in case["env"]:
                os.environ.pop(key, None)
    from kubeflow_tpu_torch.serving.engine import serve_worker

    model, draft = _models(case, weights)
    return serve_worker(model, draft, device="cpu", **_mesh_kw(mesh))
