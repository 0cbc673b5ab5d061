"""The port's page handoff between replicas (kubeflow_tpu_torch/serving/
kv_tiers.py's envelope, the engine's export/import, the server's
`/v1/kv/pages`, `:prefill` and `/v1/kv/handoff`) on the CPU, at
tests/test_disagg.py's replica-side geometry: gpt_tiny from the session
weights, page 8, 24 pages, prefill buckets (8, 32).

Across the packages, the envelope both ways: a JAX engine's exported
pages, packed by JAX `encode_page_entries`, decode in the port and land
in its pool bit for bit; a port envelope decodes through JAX
`decode_page_entries` and `tree_from_flat` against the JAX engine's page
template, and lands in the JAX pool bit for bit; at bf16 (npz's 2-byte
void words) and int8 with its bf16 scales, in both leaf layouts. The
split path across the packages (a JAX prefill engine's pages into a port
decode server, and the reverse) gives the JAX unified engine's and
`generate()`'s tokens. Port-internal: the split path's tokens equal the
unified server's (f32 and int8), a shipment of another geometry is
rejected whole with 400 and a binary body on a JSON route too, `:prefill`
while draining is 429 with Retry-After, and a drain-window handoff lands
each chain at its first page's rendezvous home. Tolerance: tokens
identical, pages equal bit for bit."""

import functools
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request
from collections.abc import Mapping

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.config.platform import DisaggConfig as JDisaggConfig  # noqa: E402
from kubeflow_tpu.models.gpt import stack_layer_params  # noqa: E402
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
import kubeflow_tpu.routing as jrouting  # noqa: E402
from kubeflow_tpu.routing import affinity as jaffinity  # noqa: E402
from kubeflow_tpu.serving import engine as jengine  # noqa: E402
from kubeflow_tpu.serving import kv_tiers as jtiers  # noqa: E402
from kubeflow_tpu.serving.generate import generate as jgenerate  # noqa: E402
from kubeflow_tpu.serving.server import ModelServer as JModelServer  # noqa: E402
from kubeflow_tpu_torch.api.wsgi import Server  # noqa: E402
from kubeflow_tpu_torch.config.platform import ConfigError, DisaggConfig  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch import routing  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.routing.affinity import (  # noqa: E402
    first_page_key,
    rendezvous_rank,
)
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402
from kubeflow_tpu_torch.serving.kv_tiers import (  # noqa: E402
    decode_page_entries,
    encode_page_entries,
)
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402

PS = 8
OCTET = {"content-type": "application/octet-stream"}
LAYOUTS = ["named", "scan"]


def _engine(tmodel, name, **kw):
    return DecodeEngine(name, tmodel, device="cpu", num_slots=2,
                        page_size=PS, num_pages=24, prefill_buckets=(8, 32),
                        paged_attention="kernel", **kw)


def _jengine(model, params, name, **kw):
    return jengine.DecodeEngine(name, model, params, num_slots=2,
                                page_size=PS, num_pages=24,
                                prefill_buckets=(8, 32), **kw)


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8).tobytes()


def _flat(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested page tree (a JAX export) or a
    flat one (the port's)."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            out.update(_flat(sub, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = sub
    return out


def _assert_entries_bitwise(a, b):
    assert [tuple(int(t) for t in e[0]) for e in a] == \
        [tuple(int(t) for t in e[0]) for e in b]
    for (_, ta, _, _), (_, tb, _, _) in zip(a, b):
        fa, fb = _flat(ta), _flat(tb)
        assert sorted(fa) == sorted(fb)
        for key in fa:
            assert _bits(fa[key]) == _bits(fb[key]), key


def _as_bytes(resp) -> bytes:
    """A handle_full body as the bytes a wire transport returns."""
    if isinstance(resp, (bytes, bytearray)):
        return bytes(resp)
    body = getattr(resp, "body", None)
    return body if body is not None else json.dumps(resp).encode()


def _transport_to(app):
    """A page transport that POSTs into `app` in process."""
    def transport(url, data):
        assert url.endswith("/v1/kv/pages")
        status, resp, _ = app.handle_full("POST", "/v1/kv/pages", body=data,
                                          headers=dict(OCTET))
        return status, _as_bytes(resp)
    return transport


def _row(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


@pytest.fixture(scope="module")
def sides(gpt_and_params):
    """The JAX and the port model of the session weights, by (dtype,
    layout): JAX models in the named layout (the session model) or the
    scan one (stacked params); port models loaded from the same params."""
    jmodel, params = gpt_and_params
    run = jax.jit(functools.partial(jgenerate, jmodel), static_argnums=(2,))

    def ref(row, n):
        out = run(params, jnp.asarray(row, jnp.int32)[None], n)
        return np.asarray(out)[0, len(row):].tolist()

    cache = {}

    def get(dtype, kv_layout):
        if (dtype, kv_layout) not in cache:
            jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
            jm = jget_model("gpt_tiny", dtype=jdt,
                            scan_layers=kv_layout == "scan")
            jp = (params if kv_layout == "named" else
                  stack_layer_params(params, jmodel.cfg.num_layers))
            tm = get_model("gpt_tiny", dtype=getattr(torch, dtype),
                           device="cpu")
            load_jax_params(tm, jax.tree.map(np.asarray, params))
            cache[dtype, kv_layout] = (jm, jp, tm)
        return cache[dtype, kv_layout]

    return get, ref


# -- the envelope across the packages --------------------------------------


@pytest.fixture(scope="module")
def jax_engines(sides):
    """One JAX engine for each (kind, layout), shared by both directions."""
    get, _ = sides
    made = {}

    def engine(kind, kv_layout):
        if (kind, kv_layout) not in made:
            dtype = "bfloat16" if kind == "bf16" else "float32"
            jm, jp, _ = get(dtype, kv_layout)
            kw = {"quantize": "int8"} if kind == "int8" else {}
            made[kind, kv_layout] = _jengine(jm, jp, f"j-{kind}-{kv_layout}",
                                             **kw)
        return made[kind, kv_layout]

    yield engine
    for eng in made.values():
        eng.close()


@pytest.mark.parametrize("kv_layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_jax_envelope_lands_bitwise_in_the_port_pool(sides, jax_engines,
                                                     kind, kv_layout):
    """A JAX engine's exported pages, packed by JAX encode_page_entries,
    are admitted by the port's /v1/kv/pages and read back from the port
    pool bit for bit (bf16 arrives as npz void words; int8 with its bf16
    scales)."""
    get, _ = sides
    tm = get("bfloat16" if kind == "bf16" else "float32", kv_layout)[2]
    quantize = "int8" if kind == "int8" else "none"
    jeng = jax_engines(kind, kv_layout)
    row = _row(11, 3 * PS)
    jeng.submit(np.asarray(row, np.int32), 2).wait(120)
    sent = jeng.export_prefix_entries(row)
    assert len(sent) == 3
    data = jtiers.encode_page_entries(sent, PS, quantize, model="dst")
    dst = _engine(tm, "dst", quantize=quantize, kv_layout=kv_layout)
    server = ModelServer()
    server.add_engine(dst)
    try:
        status, doc, _ = server.app.handle_full("POST", "/v1/kv/pages",
                                                body=data, headers=OCTET)
        assert (status, doc["admitted"]) == (200, 3), doc
        _assert_entries_bitwise(sent, dst.export_prefix_entries(row))
    finally:
        server.close()
    dtypes = {np.asarray(v).dtype.name for v in _flat(sent[0][1]).values()}
    assert dtypes == ({"bfloat16"} if kind == "bf16" else {"int8", "bfloat16"})


@pytest.mark.parametrize("kv_layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_port_envelope_lands_bitwise_in_the_jax_pool(sides, jax_engines,
                                                     kind, kv_layout):
    """A port engine's exported pages, packed by the port's
    encode_page_entries, decode through JAX decode_page_entries and
    tree_from_flat against the JAX engine's page template, are admitted
    by the JAX server's /v1/kv/pages and read back from the JAX pool bit
    for bit."""
    get, _ = sides
    tm = get("bfloat16" if kind == "bf16" else "float32", kv_layout)[2]
    quantize = "int8" if kind == "int8" else "none"
    jeng = jax_engines(kind, kv_layout)
    src = _engine(tm, "src", quantize=quantize, kv_layout=kv_layout)
    row = _row(12, 3 * PS)
    try:
        src.submit(row, 2).wait(120)
        sent = src.export_prefix_entries(row)
    finally:
        src.close()
    assert len(sent) == 3
    data = encode_page_entries(sent, PS, quantize, model=jeng.name)
    manifest, decoded = jtiers.decode_page_entries(data)
    assert (manifest["page_size"], manifest["quantize"]) == (PS, quantize)
    template = jeng._page_template(jeng._pool)
    for (tokens, target, _, _), ent in zip(sent, decoded):
        assert tuple(ent["tokens"]) == tuple(tokens) and ent["draft"] is None
        tree = jtiers.tree_from_flat(template, ent["target"])
        _assert_entries_bitwise([(tokens, target, None, 0)],
                                [(tokens, tree, None, 0)])
    server = JModelServer(statusz_enabled=False)
    server.add_engine(jeng)
    status, doc, _ = server.app.handle_full("POST", "/v1/kv/pages", body=data,
                                            headers=OCTET)
    assert (status, doc["admitted"]) == (200, 3), doc
    _assert_entries_bitwise(sent, jeng.export_prefix_entries(row))


# -- geometry and body checks ----------------------------------------------


@pytest.mark.parametrize("defect", ["quantize", "page_size", "leaf_shape"])
def test_mismatched_geometry_is_rejected_whole(sides, defect):
    """A shipment of another quantize mode, page size or leaf shape is a
    400 and admits nothing, not even its entries that would fit."""
    tm = sides[0]("float32", "scan")[2]
    src = _engine(tm, "src", quantize="int8" if defect == "quantize" else
                  "none")
    row = _row(6, 2 * PS)
    try:
        src.submit(row, 2).wait(120)
        entries = src.export_prefix_entries(row)
    finally:
        src.close()
    assert len(entries) == 2
    page_size = PS * 2 if defect == "page_size" else PS
    if defect == "leaf_shape":
        tokens, target, draft, hits = entries[1]
        target = {k: v[..., :-1] for k, v in target.items()}
        entries[1] = (tokens, target, draft, hits)
    data = encode_page_entries(entries, page_size, src.quantize, model="dst")
    dst = _engine(tm, "dst")
    server = ModelServer()
    server.add_engine(dst)
    try:
        status, doc, _ = server.app.handle_full("POST", "/v1/kv/pages",
                                                body=data, headers=OCTET)
        assert status == 400, doc
        assert dst.export_prefix_entries(row) == []
        assert dst.stats()["pages_in_use"] == 0
    finally:
        server.close()


def test_binary_bodies_only_reach_binary_routes(sides):
    """Over a real socket: an octet-stream body on :generate is a 400, a
    JSON body or a torn envelope on /v1/kv/pages is a 400."""
    tm = sides[0]("float32", "scan")[2]
    server = ModelServer()
    server.add_engine(_engine(tm, "m"))
    httpd = Server(server.app, port=0)
    httpd.start()

    def post(path, data, ctype):
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}{path}", data=data, method="POST",
            headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, doc = post("/v1/models/m:generate", b"\x00\x01",
                           "application/octet-stream")
        assert status == 400 and "binary body" in doc["log"]
        status, doc = post("/v1/kv/pages", b'{"a": 1}', "application/json")
        assert status == 400 and "octet-stream" in doc["log"]
        status, doc = post("/v1/kv/pages", b"torn", "application/octet-stream")
        assert status == 400 and "bad page envelope" in doc["log"]
    finally:
        httpd.stop()
        server.close()


# -- the split path ---------------------------------------------------------


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_split_path_equals_the_unified_server(sides, quantize):
    """:prefill ships the prompt's pages to the decode server, whose
    :generate is a prefix hit with the unified server's tokens (and JAX
    generate()'s in f32)."""
    get, ref = sides
    tm = get("float32", "scan")[2]
    kw = {"quantize": quantize}
    pre, dec, uni = (_engine(tm, "pf", **kw) for _ in range(3))
    sd = ModelServer()
    sd.add_engine(dec)
    sp = ModelServer(page_transport=_transport_to(sd.app))
    sp.add_engine(pre)
    su = ModelServer()
    su.add_engine(uni)
    row = _row(7, 2 * PS + 4)
    try:
        status, doc, _ = sp.app.handle_full(
            "POST", "/v1/models/pf:prefill",
            body={"prompt_ids": [row], "handoff_url": "http://d/v1/kv/pages"})
        assert status == 200, doc
        assert (doc["pages"], doc["handoff"]["admitted"]) == (2, 2)
        gen = {"prompt_ids": [row], "max_new_tokens": 8}
        status, split, _ = sd.app.handle_full("POST", "/v1/models/pf:generate",
                                              body=gen)
        assert status == 200
        status, unified, _ = su.app.handle_full(
            "POST", "/v1/models/pf:generate", body=gen)
        assert status == 200
        assert dec.stats()["prefix_hit_tokens"] == 2 * PS
        assert split["sequences"] == unified["sequences"]
        if quantize == "none":
            assert split["sequences"][0][len(row):] == ref(row, 8)
    finally:
        for s in (sp, sd, su):
            s.close()


@pytest.mark.parametrize("direction", ["jax_prefill_port_decode",
                                       "port_prefill_jax_decode"])
def test_split_path_crosses_packages(sides, direction):
    """One package's prefill server ships the prompt's pages to the other
    package's decode server over /v1/kv/pages (named leaves, the session
    model's layout); the decode server's :generate is a prefix hit whose
    tokens equal the JAX unified engine's and JAX generate()'s."""
    get, ref = sides
    jm, jp, tm = get("float32", "named")
    row = _row(8, 3 * PS + 3)
    uni = _jengine(jm, jp, "pf")
    try:
        want = uni.submit(np.asarray(row, np.int32), 8).wait(120)["tokens"]
    finally:
        uni.close()
    assert want == ref(row, 8)
    port = _engine(tm, "pf", kv_layout="named")
    jax_eng = _jengine(jm, jp, "pf")
    if direction == "jax_prefill_port_decode":
        pre, dec = jax_eng, port
        sd = ModelServer()
        sp = JModelServer(statusz_enabled=False,
                          page_transport=_transport_to(sd.app))
    else:
        pre, dec = port, jax_eng
        sd = JModelServer(statusz_enabled=False)
        sp = ModelServer(page_transport=_transport_to(sd.app))
    sd.add_engine(dec)
    sp.add_engine(pre)
    try:
        status, doc, _ = sp.app.handle_full(
            "POST", "/v1/models/pf:prefill",
            body={"prompt_ids": [row], "handoff_url": "http://d/v1/kv/pages"})
        assert status == 200, doc
        assert (doc["pages"], doc["handoff"]["admitted"]) == (3, 3)
        status, out, _ = sd.app.handle_full(
            "POST", "/v1/models/pf:generate",
            body={"prompt_ids": [row], "max_new_tokens": 8})
        assert status == 200, out
        assert dec.stats()["prefix_hit_tokens"] == 3 * PS
        assert out["sequences"][0][len(row):] == want
    finally:
        sp.close()
        sd.close()
        pre.close()
        dec.close()


def test_prefill_while_draining_is_429_with_retry_after(sides):
    tm = sides[0]("float32", "scan")[2]
    eng = _engine(tm, "pf")
    server = ModelServer()
    server.add_engine(eng)
    with eng._cv:  # flip the admission gate as drain() does
        eng._draining = True
    try:
        status, doc, headers = server.app.handle_full(
            "POST", "/v1/models/pf:prefill",
            body={"prompt_ids": [_row(9, 2 * PS)]})
        assert status == 429 and "draining" in doc["log"]
        assert int(dict(headers)["Retry-After"]) >= 1
    finally:
        server.close()


# -- the drain-window handoff ----------------------------------------------


def test_drain_handoff_lands_chains_at_rendezvous_homes(sides):
    """A draining replica's /v1/kv/handoff ships each committed chain to
    its first-page key's rendezvous home among the peers: the pages land
    there bit for bit and nowhere else, and the next request there is a
    prefix hit with the draining replica's tokens."""
    tm = sides[0]("float32", "scan")[2]
    drain = _engine(tm, "hd0")
    survivors = {"s1": _engine(tm, "hd1"), "s2": _engine(tm, "hd2")}
    servers = {rid: ModelServer() for rid in survivors}
    for rid, eng in survivors.items():
        servers[rid].add_engine(eng)

    def transport(url, data):
        rid = url[len("http://"):].split("/")[0]
        return _transport_to(servers[rid].app)(url, data)

    msd = ModelServer(page_transport=transport)
    msd.add_engine(drain)
    try:
        rows, seed = {}, 0
        while len(rows) < 2:
            row = _row(100 + seed, 2 * PS)
            rows.setdefault(rendezvous_rank(first_page_key(row, PS),
                                            list(survivors))[0], row)
            seed += 1
        want = {rid: drain.submit(row, 2).wait(120)["tokens"]
                for rid, row in rows.items()}
        exported = {rid: drain.export_prefix_entries(row)
                    for rid, row in rows.items()}
        assert all(len(e) == 2 for e in exported.values())
        status, doc, _ = msd.app.handle_full(
            "POST", "/v1/kv/handoff",
            body={"peers": {rid: f"http://{rid}" for rid in survivors},
                  "chains": 8})
        assert status == 200
        for rid in survivors:
            assert doc["peers"][rid] == {"pages": 2, "admitted": 2}
        for rid, row in rows.items():
            other = next(o for o in survivors if o != rid)
            _assert_entries_bitwise(exported[rid],
                                    survivors[rid].export_prefix_entries(row))
            assert survivors[other].export_prefix_entries(row) == []
            got = survivors[rid].submit(row, 2).wait(120)["tokens"]
            assert got == want[rid]
            assert survivors[rid].stats()["prefix_hit_tokens"] == 2 * PS - 1
        status, doc, _ = msd.app.handle_full("POST", "/v1/kv/handoff",
                                             body={"peers": {}})
        assert status == 400
    finally:
        msd.close()
        for srv in servers.values():
            srv.close()


def test_affinity_and_handoff_budget_are_the_jax_packages():
    """The port's first_page_key / rendezvous_rank give the JAX
    package's keys and homes, and the default handoff budget is its."""
    replicas = ["r0", "r1", "r2", "r3"]
    for seed in range(8):
        row = _row(seed, 21)
        for ps in (1, 8, 16, 64):
            key = first_page_key(row, ps)
            assert key == jaffinity.first_page_key(row, ps)
            assert rendezvous_rank(key, replicas) == \
                jaffinity.rendezvous_rank(key, replicas)
    assert DisaggConfig().handoff_chains == JDisaggConfig().handoff_chains
    with pytest.raises(ConfigError, match="handoff_chains"):
        DisaggConfig(handoff_chains=0)


# -- the router's steering, the per-tier autoscaler, the render -------------
#
# tests/test_disagg.py's TestSteeringTable, TestPerTierAutoscale and
# TestDisaggRender, each run on both packages with the same inputs: the
# verdicts, the hops, the counts and the resize sequences must be equal.

STEER_PAGE = list(range(100, 116))  # one full page at the router's 16


def _steer_body(extra=0):
    return {"prompt_ids": [STEER_PAGE + list(range(extra))],
            "max_new_tokens": 2}


class _TierFleet:
    """A scripted tiered fleet behind the router's transport: every call
    is recorded as (replica id, path); `:prefill` answers the prefill
    contract, `/v1/kv/handoff` a shipment to d2, anything else a healthy
    :generate; replicas in `fail` answer 500."""

    def __init__(self, fail=()):
        self.calls = []
        self.fail = set(fail)
        self.handoffs = []
        self.lock = threading.Lock()

    def transport(self, method, url, body, headers):
        rid, _, path = url[len("http://"):].partition("/")
        path = "/" + path
        with self.lock:
            self.calls.append((rid, path))
        if rid in self.fail:
            return 500, b"{}", {}
        if path == "/v1/kv/handoff":
            with self.lock:
                self.handoffs.append(json.loads(body))
            return 200, json.dumps({"peers": {"d2": {
                "pages": 1, "admitted": 1}}}).encode(), {}
        if path.endswith(":prefill"):
            row = (json.loads(body) if body else {}).get("prompt_ids") or []
            return 200, json.dumps({"model": "m", "pages": len(row) // 16,
                                    "handoff": {"admitted": len(row) // 16}}
                                   ).encode(), {}
        return 200, json.dumps({"sequences": [[1, 2]]}).encode(), {
            "x-ttft-ms": "1.00"}

    def hops(self, suffix):
        with self.lock:
            return [(rid, p) for rid, p in self.calls if p.endswith(suffix)]


def _steer_case(pkg, bodies, roles=("p1:prefill", "d1:decode", "d2:decode"),
                fail=(), **kw):
    """Route `bodies` through a disagg router of `pkg` → (hops, statuses,
    steer counts, the router_tier_steer deltas)."""
    mod = jrouting if pkg == "jax" else routing
    fleet = _TierFleet(fail)
    reps = [mod.Replica(r.split(":")[0], f"http://{r.split(':')[0]}",
                        r.split(":")[1]) for r in roles]
    router = mod.FleetRouter(tuple(reps), transport=fleet.transport,
                             page_size=16, disagg=True, **kw)
    steers = (("prefill", "cold"), ("decode", "page-complete"),
              ("unified", "tier-down"))
    before = [router._tier_steer.value(tier=t, reason=r) for t, r in steers]
    statuses = [router.app.handle("POST", "/v1/models/m:generate",
                                  body=b)[0] for b in bodies]
    after = [router._tier_steer.value(tier=t, reason=r) for t, r in steers]
    return {"prefill": fleet.hops(":prefill"),
            "generate": fleet.hops(":generate"), "statuses": statuses,
            "steer_counts": dict(router._steer_counts),
            "series": [a - b for a, b in zip(after, before)]}


def _steer_both(bodies, **kw):
    got = {pkg: _steer_case(pkg, bodies, **kw) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    return got["port"]


def _steer_home():
    return rendezvous_rank(first_page_key(STEER_PAGE, 16), ["d1", "d2"])[0]


class TestSteeringTable:
    def test_cold_key_detours_through_prefill(self):
        got = _steer_both([_steer_body()])
        assert got["prefill"] == [("p1", "/v1/models/m:prefill")]
        assert got["generate"] == [(_steer_home(), "/v1/models/m:generate")]
        assert got["steer_counts"] == {("prefill", "cold"): 1}
        assert got["series"] == [1, 0, 0]

    def test_seen_key_goes_straight_to_decode(self):
        got = _steer_both([_steer_body(), _steer_body()])
        assert len(got["prefill"]) == 1
        assert [r for r, _ in got["generate"]] == [_steer_home()] * 2
        assert got["steer_counts"] == {("prefill", "cold"): 1,
                                       ("decode", "page-complete"): 1}

    def test_low_home_hit_rate_re_steers_cold(self):
        got = _steer_both([_steer_body(), _steer_body()],
                          signals=lambda rid: {"prefix_hit_rate": 0.0})
        assert got["steer_counts"] == {("prefill", "cold"): 2}
        assert len(got["prefill"]) == 2

    def test_no_prefill_tier_falls_back_unified(self):
        got = _steer_both([_steer_body()], roles=("d1:decode", "d2:decode"))
        assert got["prefill"] == [] and got["statuses"] == [200]
        assert got["steer_counts"] == {("unified", "tier-down"): 1}

    def test_prefill_failure_falls_back_unified(self):
        got = _steer_both([_steer_body()], fail={"p1"})
        assert got["statuses"] == [200] and len(got["generate"]) == 1
        assert got["steer_counts"] == {("unified", "tier-down"): 1}

    def test_prefill_never_serves_generate(self):
        bodies = [{"prompt_ids": [[1000 * (i + 1) + t for t in range(16)]],
                   "max_new_tokens": 2} for i in range(8)]
        got = _steer_both(bodies)
        assert all(rid != "p1" for rid, _ in got["generate"])
        assert got["steer_counts"] == {("prefill", "cold"): 8}

    def test_drain_fires_one_handoff_per_window(self):
        """The first real drain of a decode replica fires one background
        /v1/kv/handoff naming the surviving decode peers; the same window
        does not fire again, a recovery re-arms it."""
        import time

        got = {}
        for pkg, mod in (("jax", jrouting), ("port", routing)):
            fleet = _TierFleet()
            reps = tuple(mod.Replica(r, f"http://{r}", role) for r, role in
                         (("p1", "prefill"), ("d1", "decode"),
                          ("d2", "decode")))
            router = mod.FleetRouter(reps, transport=fleet.transport,
                                     page_size=16, disagg=True,
                                     handoff_chains=7)

            def fired(n):
                deadline = time.monotonic() + 10
                while len(fleet.handoffs) < n and time.monotonic() < deadline:
                    time.sleep(0.01)
                time.sleep(0.1)
                return len(fleet.handoffs)

            seen = []
            router._note_draining("d1", 5.0, draining=True)
            seen.append(fired(1))
            router._note_draining("d1", 5.0, draining=True)
            seen.append(fired(1))
            router._note_ok("d1")
            router._note_draining("d1", 5.0, draining=True)
            seen.append(fired(2))
            router._note_draining("d2", 5.0, draining=False)  # queue-full
            seen.append(fired(2))
            got[pkg] = (seen, fleet.handoffs)
        assert got["port"] == got["jax"]
        seen, handoffs = got["port"]
        assert seen == [1, 1, 2, 2]
        assert handoffs[0] == {"peers": {"d2": "http://d2"}, "chains": 7}


def _per_tier_trajectory(pkg, dsigs, sigs=None, serving=None, replicas=1,
                         reconciles=3):
    """Reconcile a disaggregated service `reconciles` times on a scripted
    fleet → [(prefill replicas, decode replicas, prefill Deployment
    replicas)] and the resize events."""
    if pkg == "jax":
        from kubeflow_tpu.cluster.store import StateStore as Store
        from kubeflow_tpu.controllers.inference import (
            InferenceServiceController as Ctrl,
        )
        from kubeflow_tpu.controllers.inference import new_inference_service
        from kubeflow_tpu.observability.fleet import (
            DisaggSignals,
            FleetSignals,
        )
    else:
        from kubeflow_tpu_torch.cluster.store import StateStore as Store
        from kubeflow_tpu_torch.controllers.inference import (
            InferenceServiceController as Ctrl,
        )
        from kubeflow_tpu_torch.controllers.inference import (
            new_inference_service,
        )
        from kubeflow_tpu_torch.observability.fleet import (
            DisaggSignals,
            FleetSignals,
        )

    class _TieredFleet:
        """Row `step` of the scripts (the last row past their end); a
        None row of `dsigs` is a signal outage."""

        step = 0

        def serving_signals(self, namespace, name):
            rows = sigs or [(0.0, 0.5)]
            queue, occ = rows[min(self.step, len(rows) - 1)]
            return FleetSignals(replicas=1, queue_depth=queue,
                                occupancy=occ, num_slots=8.0,
                                rate_429_per_s=0.0)

        def disagg_signals(self, namespace, name):
            row = dsigs[min(self.step, len(dsigs) - 1)]
            if row is None:
                return None
            ttft, cold, queue, occ = row
            return DisaggSignals(prefill_replicas=1, decode_replicas=1,
                                 ttft_p99_s=ttft, cold_per_s=cold,
                                 decode_queue_depth=queue,
                                 decode_num_slots=8.0, decode_occupancy=occ)

    base = {"autoscale": {"enabled": True, "min_replicas": 1,
                          "max_replicas": 3, "breach_cycles": 1,
                          "cooldown_cycles": 0},
            "router": {"enabled": True},
            "disagg": {"enabled": True, "min_prefill_replicas": 1,
                       "max_prefill_replicas": 3}}
    for k, v in (serving or {}).items():
        base.setdefault(k, {}).update(v)
    store = Store()
    fleet = _TieredFleet()
    ctrl = Ctrl(fleet=fleet)
    store.create(new_inference_service("svc1", model="gpt_tiny",
                                       replicas=replicas, serving=base))
    out = []
    for step in range(reconciles):
        fleet.step = step
        ctrl.reconcile(store, "default", "svc1")
        spec = store.get("InferenceService", "svc1")["spec"]
        out.append((spec["serving"]["disagg"].get("prefill_replicas", 1),
                    spec["replicas"],
                    store.get("Deployment", "svc1-prefill")["spec"][
                        "replicas"]))
    events = sorted(e["reason"] for e in store.events_for(
        store.get("InferenceService", "svc1")))
    return out, events


class TestPerTierAutoscale:
    CASES = {
        # (DisaggSignals rows (ttft, cold/s, decode queue, decode occ),
        #  serving overrides, the prefill trajectory the JAX test pins)
        "ttft_pressure": ([(5.0, 0.0, 0.0, 0.5)], None, [2, 3, 3]),
        "cold_arrivals": ([(0.5, 9.0, 0.0, 0.5)], None, [2, 3, 3]),
        "headroom": ([(0.1, 0.0, 0.0, 0.5)],
                     {"disagg": {"prefill_replicas": 2}}, [1, 1, 1]),
        "hold": ([(1.5, 0.0, 0.0, 0.5)],
                 {"disagg": {"prefill_replicas": 2}}, [2, 2, 2]),
        "outage_then_burst": ([None, (0.2, 5.0, 0.0, 0.5),
                               (0.2, 5.0, 0.0, 0.5), (0.2, 0.0, 0.0, 0.5)],
                              {"autoscale": {"breach_cycles": 2,
                                             "cooldown_cycles": 1}},
                              [1, 1, 2, 2, 2]),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_prefill_trajectory_is_the_jax_controllers(self, case):
        dsigs, serving, want = self.CASES[case]
        got = {pkg: _per_tier_trajectory(pkg, dsigs, serving=serving,
                                         reconciles=len(want))
               for pkg in ("jax", "port")}
        assert got["port"] == got["jax"]
        traj, _ = got["port"]
        assert [t[0] for t in traj] == want
        # same-pass render: the prefill Deployment carries each resize
        assert all(t[0] == t[2] for t in traj)

    def test_decode_reads_decode_tier_occupancy(self):
        """Idle prefill slots must not mask decode pressure: the fleet
        mean looks calm, the decode tier is saturated: decode scales."""
        got = {pkg: _per_tier_trajectory(pkg, [(None, 0.0, 30.0, 1.0)],
                                         reconciles=1)
               for pkg in ("jax", "port")}
        assert got["port"] == got["jax"]
        assert got["port"][0][0][1] == 2

    def test_prefill_noop_without_disagg_signals(self):
        from kubeflow_tpu_torch.cluster.store import StateStore as Store
        from kubeflow_tpu_torch.controllers.inference import (
            InferenceServiceController,
            new_inference_service,
        )
        from kubeflow_tpu_torch.observability.fleet import FleetSignals

        class _Plain:
            def serving_signals(self, namespace, name):
                return FleetSignals(replicas=1, queue_depth=0.0,
                                    occupancy=0.5, num_slots=8.0,
                                    rate_429_per_s=0.0)

        store = Store()
        ctrl = InferenceServiceController(fleet=_Plain())
        store.create(new_inference_service("svc1", model="gpt_tiny", serving={
            "autoscale": {"enabled": True, "max_replicas": 3},
            "router": {"enabled": True},
            "disagg": {"enabled": True, "max_prefill_replicas": 3}}))
        ctrl.reconcile(store, "default", "svc1")
        assert store.get("InferenceService", "svc1")["spec"]["serving"][
            "disagg"].get("prefill_replicas", 1) == 1


def _render(pkg, serving, replicas=2, mutate=None):
    if pkg == "jax":
        from kubeflow_tpu.cluster.store import StateStore as Store
        from kubeflow_tpu.controllers.inference import (
            InferenceServiceController as Ctrl,
        )
        from kubeflow_tpu.controllers.inference import new_inference_service
    else:
        from kubeflow_tpu_torch.cluster.store import StateStore as Store
        from kubeflow_tpu_torch.controllers.inference import (
            InferenceServiceController as Ctrl,
        )
        from kubeflow_tpu_torch.controllers.inference import (
            new_inference_service,
        )
    store = Store()
    ctrl = Ctrl()
    store.create(new_inference_service("svc1", model="gpt_tiny",
                                       replicas=replicas, serving=serving))
    ctrl.reconcile(store, "default", "svc1")
    if mutate is not None:
        cr = store.get("InferenceService", "svc1")
        mutate(cr)
        store.update(cr)
        ctrl.reconcile(store, "default", "svc1")
    out = {}
    for kind, name in (("Deployment", "svc1"), ("Deployment", "svc1-prefill"),
                       ("Service", "svc1"), ("Deployment", "svc1-router")):
        obj = store.try_get(kind, name)
        if obj is None:
            out[name, kind] = None
            continue
        spec = dict(obj["spec"])
        if kind == "Deployment":
            tmpl = spec["template"]
            c = tmpl["spec"]["containers"][0]
            spec = {"replicas": spec["replicas"],
                    "labels": tmpl["metadata"]["labels"],
                    "env": {e["name"]: e["value"] for e in c["env"]
                            if e["name"].startswith("KFT_ROUTER")
                            or e["name"] == "KFT_SERVING_DISAGG_HANDOFF_CHAINS"}}
        out[name, kind] = spec
    return out


class TestDisaggRender:
    def test_two_deployments_one_vip_and_router_contract(self):
        serving = {"router": {"enabled": True},
                   "disagg": {"enabled": True, "prefill_replicas": 2,
                              "cold_hit_rate": 0.35, "handoff_chains": 9}}
        got = {pkg: _render(pkg, serving) for pkg in ("jax", "port")}
        assert got["port"] == got["jax"]
        got = got["port"]
        assert got["svc1", "Deployment"]["labels"][
            "inferenceservice-tier"] == "decode"
        pre = got["svc1-prefill", "Deployment"]
        assert pre["replicas"] == 2
        assert pre["labels"]["inferenceservice-tier"] == "prefill"
        assert got["svc1", "Service"]["selector"][
            "inferenceservice-tier"] == "decode"
        env = got["svc1-router", "Deployment"]["env"]
        assert env["KFT_ROUTER_DISAGG"] == "1"
        assert env["KFT_ROUTER_DISAGG_COLD_HIT_RATE"] == "0.35"
        assert env["KFT_SERVING_DISAGG_HANDOFF_CHAINS"] == "9"
        assert env["KFT_ROUTER_REPLICAS"] == (
            "svc1-0=http://svc1-0:8500#decode,"
            "svc1-1=http://svc1-1:8500#decode,"
            "svc1-prefill-0=http://svc1-prefill-0:8500#prefill,"
            "svc1-prefill-1=http://svc1-prefill-1:8500#prefill")

    def test_disabling_disagg_tears_down_prefill(self):
        def off(cr):
            cr["spec"]["serving"]["disagg"]["enabled"] = False

        serving = {"router": {"enabled": True}, "disagg": {"enabled": True}}
        got = {pkg: _render(pkg, serving, replicas=1, mutate=off)
               for pkg in ("jax", "port")}
        assert got["port"] == got["jax"]
        assert got["port"]["svc1-prefill", "Deployment"] is None
        assert "inferenceservice-tier" not in got["port"][
            "svc1", "Service"]["selector"]
        assert "KFT_ROUTER_DISAGG" not in got["port"][
            "svc1-router", "Deployment"]["env"]


def test_chip_smoke_kv_tier_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 13 on the CPU at gpt_tiny size: 13a's token
    gates (tiered == always-resident, bf16 and int8) with spills and
    re-admissions, 13b's restart, 13c's split path and handoff over
    localhost HTTP. CPU tensors take the plain versions: no launches."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.phase_kv_tiers(
        torch, model="gpt_tiny", device="cpu",
        spill=dict(pool_pages=8, shared_len=48, tail_len=8, fills=4,
                   max_new=8),
        restart=dict(short=(3, 5, 9, 17, 30), long_len=90, hit_len=40,
                     max_new=16, buckets="8,16,32"),
        handoff=dict(prompt_len=40, max_new=8),
    )
    assert not any(launches.values())
