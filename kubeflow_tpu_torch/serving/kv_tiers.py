"""Tiered KV storage under the decode engine: host-RAM spill and an
on-disk prefix store (port of kubeflow_tpu/serving/kv_tiers.py).

The paged KV pool (serving/engine.py) lives on the card and dies with
the engine; the radix prefix index only maps pages still in the pool.
This module adds the two colder tiers, the wire envelope that moves
pages between replicas, and the telemetry feed that sizes the pool:

  card page pool  --evict-->  HostKVTier  --persist-->  PersistentPrefixStore
    (PagePool)    <--upload--  (host RAM)  <--preload--      (on disk)

* `HostKVTier`: a bounded LRU pool of page contents in host RAM. When
  radix eviction is about to free the last reference to a committed
  page, the engine copies the page to the host (an int8 page with its
  bf16 scales) and parks it here, keyed by the chain's page-aligned
  token tuple. A later admission for the same prefix uploads it instead
  of prefilling it again. The engine keeps the pages in a
  `HostPageArena` of preallocated (on the card, pinned) page slots.
* `PersistentPrefixStore`: the hottest committed chains on disk, under
  the checkpoint layout's two-phase commit (checkpointing/layout.py):
  entry files first, one directory fsync, the manifest last. A
  generation is committed iff its manifest exists, and any defect
  (missing file, bad JSON, shape mismatch) gives a cold start, never a
  crash loop.
* `encode_page_entries` / `decode_page_entries`: the npz envelope of
  `POST /v1/kv/pages` (the prefill → decode handoff and the scale-down
  handoff).
* `pool_sizing_telemetry`: the pool pressure the previous engine of this
  process reported, which `resolve_num_pages` sizes the next pool from.

The files are the JAX package's: the same npz keys, manifest and store
layout, so a store or an envelope written by either package loads in
the other. Leaves are keyed by the flax path of the JAX pool: one
`cached_key` / `cached_value` leaf per block in the named layout
(`layer_<i>/attention/cached_key`, [page_size, H, D]) or one stacked
leaf in the scan layout (`layers/block/attention/cached_key`, [L,
page_size, H, D]), with `*_scale` siblings in an int8 pool. The port's
pool is one stacked [L, P, page_size, H, D] tensor a field, so its page
(`models/gpt.py gather_pool_page`, {"k", "v", "k_scale", "v_scale"})
maps onto either layout (`page_to_flat`, `page_from_flat`). bf16 leaves
travel as npz's raw 2-byte void words, which the JAX package writes for
ml_dtypes' bfloat16; the port reads and writes them through int16 views
of torch.bfloat16 and needs no ml_dtypes.

Parity: every move is data movement, so pages come back bit for bit and
greedy decode after a spill, a restart or a handoff equals the
always-resident engine's (tests/test_torch_kv_tiers.py,
tests/test_torch_disagg.py).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.checkpointing import layout
from kubeflow_tpu_torch.models.convert import SCAN_BLOCK, jax_path
from kubeflow_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# token-tuple key of one page-aligned prefix chain
TokenKey = Tuple[int, ...]

STORE_KIND = "kv-prefix-store"
WIRE_KIND = "kv-page-envelope"
_MANIFEST_KEY = "__manifest__"

# the JAX pool's leaf layouts: a leaf per block, or one stacked leaf
KV_LAYOUTS = ("scan", "named")
# the JAX serving entrypoint builds its models with scan_layers=True
DEFAULT_KV_LAYOUT = "scan"
# KVPool field -> the flax leaf name of the JAX attention cache
_JAX_LEAF = {
    "k": "cached_key", "v": "cached_value",
    "k_scale": "cached_key_scale", "v_scale": "cached_value_scale",
}


def page_leaf_path(field: str, layer: Optional[int], kv_layout: str) -> str:
    """The JAX pool leaf path of one page field: per block in the named
    layout (`layer` counts from 0), stacked in the scan layout (`layer`
    unused)."""
    leaf = _JAX_LEAF[field]
    if kv_layout == "scan":
        return f"{SCAN_BLOCK}/attention/{leaf}"
    if kv_layout == "named":
        return jax_path(f"layers.{int(layer)}.attention.{leaf}")
    raise ValueError(f"kv_layout {kv_layout!r} must be one of {KV_LAYOUTS}")


def page_to_flat(page: Mapping[str, torch.Tensor],
                 kv_layout: str) -> Dict[str, torch.Tensor]:
    """A port page ({field: [L, page_size, H, D]}) as the JAX pool's
    page leaves in `kv_layout`: {flax path: tensor} (views, not
    copies)."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout {kv_layout!r} must be one of {KV_LAYOUTS}")
    out: Dict[str, torch.Tensor] = {}
    for field, t in page.items():
        if kv_layout == "scan":
            out[page_leaf_path(field, None, "scan")] = t
        else:
            for i in range(t.shape[0]):
                out[page_leaf_path(field, i, "named")] = t[i]
    return out


def flat_layout(flat: Mapping[str, Any]) -> str:
    """Which JAX layout a flat page's leaf paths are in."""
    scan = any(k.startswith(SCAN_BLOCK + "/") for k in flat)
    return "scan" if scan else "named"


def page_from_flat(template: Mapping[str, torch.Tensor],
                   flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Rebuild a port page shaped like `template` (a page of the
    receiving pool; meta tensors do) from JAX page leaves in either
    layout. Raises KeyError/ValueError on a missing leaf or a
    shape/dtype mismatch (`tree_from_flat`): callers treat that as a torn
    or foreign entry."""
    kv_layout = flat_layout(flat)
    got = tree_from_flat(page_to_flat(template, kv_layout), flat)
    out: Dict[str, torch.Tensor] = {}
    for field, t in template.items():
        if kv_layout == "scan":
            out[field] = got[page_leaf_path(field, None, "scan")]
        else:
            out[field] = torch.stack([
                got[page_leaf_path(field, i, "named")]
                for i in range(t.shape[0])
            ])
    return out


def _host_array(leaf) -> np.ndarray:
    """A leaf as the host array npz stores: torch bf16 becomes 2-byte void
    words, the bytes ml_dtypes' bfloat16 leaves as in an npz."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _tree_host_arrays(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flat page tree ({leaf path: leaf}) as host arrays."""
    return {key: _host_array(leaf) for key, leaf in tree.items()}


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def tree_from_flat(template: Mapping[str, torch.Tensor],
                   flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{path: CPU tensor} shaped like the flat `template` ({path: tensor}
    of the receiving pool's page), from a flat leaf dict of host arrays.

    Raises KeyError on a missing leaf and ValueError on a shape/dtype
    mismatch: callers treat either as a torn entry and fall back cold.
    npz keeps bf16 as raw 2-byte void words; those become torch.bfloat16
    with the same bits."""
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in template.items():
        arr = np.asarray(flat[key])
        shape = tuple(leaf.shape)
        if leaf.dtype == torch.bfloat16:
            ok = arr.dtype.kind == "V" and arr.dtype.itemsize == 2
            stored = arr.dtype.name if arr.dtype.kind != "V" else "bfloat16"
        else:
            ok = arr.dtype == _numpy_dtype(leaf.dtype)
            stored = arr.dtype.name
        if not ok or tuple(arr.shape) != shape:
            raise ValueError(
                f"leaf {key!r}: stored {tuple(arr.shape)}/{stored} does not "
                f"match engine {shape}/{str(leaf.dtype).replace('torch.', '')}"
            )
        arr = np.ascontiguousarray(arr)
        if leaf.dtype == torch.bfloat16:
            out[key] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(arr)
    return out


def _nbytes(tree) -> int:
    """Bytes of a flat page tree's leaves (0 for None)."""
    return sum(
        leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
        else int(np.asarray(leaf).nbytes)
        for leaf in (tree or {}).values()
    )


class PageEntry:
    """One spilled page: host copies of the target pool's page (and the
    draft pool's, when the engine drafts). `target`/`draft` are page
    trees (the port's {field: CPU tensor}); an int8 page carries its
    scales as ordinary fields, so it round-trips with them. `slot` is
    the `HostPageArena` slot the trees view, when they live in one."""

    __slots__ = ("target", "draft", "hits", "nbytes", "slot")

    def __init__(self, target, draft=None, hits: int = 0,
                 slot: Optional[int] = None):
        self.target = target
        self.draft = draft
        self.hits = int(hits)
        self.nbytes = _nbytes(target) + _nbytes(draft)
        self.slot = slot


class HostPageArena:
    """Preallocated host storage for the host tier's pages: `slots` slots
    of one page each (the target pool's fields, and the draft pool's
    when the engine drafts), pinned when the pool lives on the card. A
    spill copies each page straight into a slot: the memory is mapped
    (and pinned) once, here, and nothing is allocated a page, which is
    what a host copy costs (scripts/torch_kv_copy_bench.py). The tier
    gives a slot back when it drops the page. Scheduler-thread only."""

    def __init__(self, target: Mapping[str, torch.Tensor],
                 draft: Optional[Mapping[str, torch.Tensor]], slots: int,
                 pin: bool):
        def storage(page):
            return {name: torch.empty((slots,) + tuple(t.shape),
                                      dtype=t.dtype, pin_memory=pin)
                    for name, t in page.items()}

        self.slots = int(slots)
        self._target = storage(target)
        self._draft = storage(draft) if draft is not None else None
        self._free = list(range(self.slots - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"host page arena: {n} slots asked, "
                               f"{len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def release(self, slot: int) -> None:
        self._free.append(slot)

    def pages(self, slot: int):
        """(target, draft or None) page trees viewing slot `slot`."""
        target = {name: t[slot] for name, t in self._target.items()}
        draft = (None if self._draft is None else
                 {name: t[slot] for name, t in self._draft.items()})
        return target, draft


class HostKVTier:
    """Bounded LRU pool of spilled page contents in host RAM.

    Keys are page-aligned token tuples, the radix index's identity, so
    admission probes tier chunks exactly where the radix match ran out.
    `budget_bytes` bounds the sum of entry sizes: a put past it evicts
    the least recently used entries, and an entry larger than the whole
    budget is rejected (a tier that thrashes one oversized page is worse
    than none).

    Every method takes the tier lock: the engine puts (after radix
    eviction) and takes (admission) on its scheduler thread, and stats()
    readers peek from others. `on_drop` is called with every entry the
    tier evicts, replaces, discards or clears (not with one `take` hands
    out): the engine gives its arena slot back."""

    def __init__(self, budget_bytes: int, on_drop=None):
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[TokenKey, PageEntry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._on_drop = on_drop or (lambda entry: None)
        self.spilled_pages_total = 0
        self.hit_pages_total = 0
        self.evicted_pages_total = 0
        self.rejected_pages_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: TokenKey) -> bool:
        with self._lock:
            return tuple(key) in self._entries

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes

    def put(self, key: TokenKey, entry: PageEntry) -> bool:
        """Park one page. Returns False when the entry cannot fit even
        after evicting everything else (rejected, not stored)."""
        key = tuple(int(t) for t in key)
        with self._lock:
            if entry.nbytes > self.budget_bytes:
                self.rejected_pages_total += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._on_drop(old)
            self._evict_locked(entry.nbytes)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self.spilled_pages_total += 1
            return True

    def _evict_locked(self, nbytes: int) -> None:
        while self._entries and self._bytes + nbytes > self.budget_bytes:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= victim.nbytes
            self.evicted_pages_total += 1
            self._on_drop(victim)

    def make_room(self, nbytes: int) -> None:
        """Evict least recently used entries until `nbytes` more fit: the
        evictions the puts of that many bytes would make, made first."""
        with self._lock:
            self._evict_locked(nbytes)

    def discard(self, key: TokenKey) -> None:
        """Drop the entry for `key`, if any, without counting a hit: a put
        of the same key replaces it."""
        key = tuple(int(t) for t in key)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._on_drop(old)

    def take(self, key: TokenKey) -> Optional[PageEntry]:
        """Remove and return the entry for `key`: admission promotes the
        page back into the pool and the radix index, so the host copy's
        job is done."""
        key = tuple(int(t) for t in key)
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            self._bytes -= entry.nbytes
            self.hit_pages_total += 1
            return entry

    def get(self, key: TokenKey) -> Optional[PageEntry]:
        """Peek (refreshing its recency) without removing: the COW
        boundary page's upload is a private copy, so the shared entry
        stays parked for other requests."""
        key = tuple(int(t) for t in key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hit_pages_total += 1
            return entry

    def keys(self) -> List[TokenKey]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            for entry in self._entries.values():
                self._on_drop(entry)
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes_in_use": self._bytes,
                "budget_bytes": self.budget_bytes,
                "spilled_pages_total": self.spilled_pages_total,
                "hit_pages_total": self.hit_pages_total,
                "evicted_pages_total": self.evicted_pages_total,
                "rejected_pages_total": self.rejected_pages_total,
            }


class PersistentPrefixStore:
    """On-disk store of hot prefix chains, committed two-phase. The
    layout is the checkpoint subsystem's (one generation is one
    `step_NNNNNNNN` directory, committed iff `manifest.json` exists):

        <directory>/
          step_00000003/
            e00000.npz        # one page: target (+draft) leaves by path
            e00001.npz
            manifest.json     # written LAST: the commit record

    `persist` prunes older generations and torn or in-flight directories
    after committing, so the store holds one committed generation.
    `load` reads the latest committed generation and returns None on
    any defect: the caller starts cold."""

    def __init__(self, directory: str):
        self.directory = layout.local_checkpoint_dir(directory)

    # -- write path ---------------------------------------------------

    def persist(self, entries: Sequence[Tuple[TokenKey, Any, Any, int]],
                page_size: int, quantize: str, model: str = "") -> int:
        """Commit one generation of (tokens, target_tree, draft_tree or
        None, hits) entries (flat trees of {flax path: leaf}). Returns
        the new generation number."""
        prior = layout.committed_steps(self.directory)
        generation = (prior[-1] + 1) if prior else 1
        gen_dir = layout.step_dir(self.directory, generation)
        os.makedirs(gen_dir, exist_ok=True)

        manifest_entries = []
        for i, (tokens, target, draft, hits) in enumerate(entries):
            flat = {f"t/{k}": v for k, v in _tree_host_arrays(target).items()}
            if draft is not None:
                flat.update(
                    {f"d/{k}": v for k, v in _tree_host_arrays(draft).items()}
                )
            buf = io.BytesIO()
            np.savez(buf, **flat)
            fname = f"e{i:05d}.npz"
            layout.atomic_write_bytes(os.path.join(gen_dir, fname),
                                      buf.getvalue())
            manifest_entries.append({
                "file": fname,
                "tokens": [int(t) for t in tokens],
                "hits": int(hits),
                "draft": draft is not None,
            })
        # phase boundary: every entry rename is durable BEFORE the
        # manifest can commit the generation (layout.py's ordering)
        layout.fsync_dir(gen_dir)
        layout.write_manifest(gen_dir, {
            "format": layout.FORMAT,
            "kind": STORE_KIND,
            "page_size": int(page_size),
            "quantize": str(quantize),
            "model": str(model),
            "entries": manifest_entries,
        })
        self._prune(keep=generation)
        return generation

    def _prune(self, keep: int) -> None:
        for step in layout.committed_steps(self.directory):
            if step != keep:
                shutil.rmtree(layout.step_dir(self.directory, step),
                              ignore_errors=True)
        for path in layout.uncommitted_step_dirs(self.directory):
            if layout.parse_step(os.path.basename(path)) != keep:
                shutil.rmtree(path, ignore_errors=True)

    # -- read path ----------------------------------------------------

    def load(self, page_size: int,
             quantize: str) -> Optional[List[Dict[str, Any]]]:
        """Read the latest committed generation: a list of {"tokens":
        tuple, "target": {path: ndarray}, "draft": {path: ndarray} or
        None, "hits": int} sorted by chain length (parents before
        children), or None when nothing is usable (no store, another
        page geometry, a torn entry, a corrupt manifest). Never raises:
        a defective store must give a cold start, not a crash loop."""
        try:
            steps = layout.committed_steps(self.directory)
            if not steps:
                return None
            gen_dir = layout.step_dir(self.directory, steps[-1])
            manifest = layout.read_manifest(gen_dir)
            if manifest.get("kind") != STORE_KIND:
                raise ValueError(f"manifest kind {manifest.get('kind')!r} "
                                 f"is not {STORE_KIND!r}")
            if int(manifest.get("page_size", -1)) != int(page_size):
                raise ValueError(
                    f"stored page_size {manifest.get('page_size')} does not "
                    f"match engine page_size {page_size}"
                )
            if str(manifest.get("quantize")) != str(quantize):
                raise ValueError(
                    f"stored quantize {manifest.get('quantize')!r} does not "
                    f"match engine quantize {quantize!r}"
                )
            out = []
            for ent in manifest["entries"]:
                with np.load(os.path.join(gen_dir, ent["file"]),
                             allow_pickle=False) as z:
                    flat = {k: z[k] for k in z.files}
                target = {k[2:]: v for k, v in flat.items()
                          if k.startswith("t/")}
                draft = {k[2:]: v for k, v in flat.items()
                         if k.startswith("d/")}
                if not target:
                    raise ValueError(f"entry {ent['file']} holds no target "
                                     "leaves")
                out.append({
                    "tokens": tuple(int(t) for t in ent["tokens"]),
                    "target": target,
                    "draft": draft if ent.get("draft") else None,
                    "hits": int(ent.get("hits", 0)),
                })
            out.sort(key=lambda e: len(e["tokens"]))
            return out
        except Exception as e:  # cold start beats a crash loop
            logger.warning("persistent prefix store at %s unusable (%s); "
                           "starting cold", self.directory, e)
            return None


# -- the wire envelope (disaggregated fleet) ----------------------------
#
# One npz carrying N page entries: the unit of the prefill → decode
# handoff and the scale-down handoff (POST /v1/kv/pages). Array keys are
# "e{i}/t/<leaf path>" (target pool leaves) and "e{i}/d/<leaf path>"
# (draft pool leaves), the store's per-entry layout with an entry index
# in front; "__manifest__" is the JSON header as uint8 bytes. Geometry
# (page_size, quantize, model) rides the manifest, so the receiver
# refuses a mismatched shipment instead of uploading wrong-shaped pages.


def encode_page_entries(entries: Sequence[Tuple[TokenKey, Any, Any, int]],
                        page_size: int, quantize: str,
                        model: str = "") -> bytes:
    """Pack (tokens, target_tree, draft_tree or None, hits) entries into
    one npz envelope for `POST /v1/kv/pages`."""
    flat: Dict[str, np.ndarray] = {}
    manifest_entries = []
    for i, (tokens, target, draft, hits) in enumerate(entries):
        for k, v in _tree_host_arrays(target).items():
            flat[f"e{i}/t/{k}"] = v
        if draft is not None:
            for k, v in _tree_host_arrays(draft).items():
                flat[f"e{i}/d/{k}"] = v
        manifest_entries.append({
            "tokens": [int(t) for t in tokens],
            "hits": int(hits),
            "draft": draft is not None,
        })
    manifest = {
        "kind": WIRE_KIND,
        "page_size": int(page_size),
        "quantize": str(quantize),
        "model": str(model),
        "entries": manifest_entries,
    }
    flat[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                        np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def decode_page_entries(
    data: bytes,
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Unpack an `encode_page_entries` envelope into (manifest, entries):
    each entry {"tokens": tuple, "target": {path: ndarray}, "draft":
    {path: ndarray} or None, "hits": int}, sorted by chain length
    (parents before children, the store's admit order). Raises
    ValueError on any defect: the endpoint answers a torn or mismatched
    shipment with 400 instead of admitting it."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(f"unreadable page envelope: {e}") from e
    raw = flat.pop(_MANIFEST_KEY, None)
    if raw is None:
        raise ValueError("page envelope has no manifest")
    try:
        manifest = json.loads(bytes(raw.tobytes()).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt page-envelope manifest: {e}") from e
    if manifest.get("kind") != WIRE_KIND:
        raise ValueError(
            f"envelope kind {manifest.get('kind')!r} is not {WIRE_KIND!r}"
        )
    out: List[Dict[str, Any]] = []
    for i, ent in enumerate(manifest.get("entries", [])):
        t_prefix, d_prefix = f"e{i}/t/", f"e{i}/d/"
        target = {k[len(t_prefix):]: v for k, v in flat.items()
                  if k.startswith(t_prefix)}
        draft = {k[len(d_prefix):]: v for k, v in flat.items()
                 if k.startswith(d_prefix)}
        if not target:
            raise ValueError(f"envelope entry {i} holds no target leaves")
        if bool(ent.get("draft")) != bool(draft):
            raise ValueError(f"envelope entry {i}: manifest draft flag does "
                             "not match shipped leaves")
        out.append({
            "tokens": tuple(int(t) for t in ent["tokens"]),
            "target": target,
            "draft": draft or None,
            "hits": int(ent.get("hits", 0)),
        })
    out.sort(key=lambda e: len(e["tokens"]))
    return manifest, out


def pool_sizing_telemetry(registry=None) -> Optional[Dict[str, float]]:
    """Live pool-pressure signals for `resolve_num_pages`, read from the
    process metrics registry (an earlier engine in this process wrote
    them): {"pages_utilization", "prefix_hit_rate"}, or None when no
    engine has reported yet (the caller keeps the static rule)."""
    from kubeflow_tpu_torch.utils.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    in_use = reg.get("serving_kv_pages_in_use")
    total = reg.get("serving_kv_pages_total")
    if in_use is None or total is None:
        return None
    totals = total.values_snapshot()
    uses = in_use.values_snapshot()
    utils = [uses.get(k, 0.0) / v for k, v in totals.items() if v > 0]
    if not utils:
        return None
    hit_rate = 0.0
    hits = reg.get("serving_prefix_cache_hit_tokens_total")
    lookups = reg.get("serving_prefix_cache_lookups_total")
    if hits is not None and lookups is not None:
        h = sum(hits.values_snapshot().values())
        n = sum(lookups.values_snapshot().values())
        # hit tokens a lookup, squashed to [0, 1] against a nominal
        # 64-token prefix (CHUNK_MIN_TOKENS): a coarse reuse signal
        if n > 0:
            hit_rate = min(1.0, (h / n) / 64.0)
    return {"pages_utilization": max(utils), "prefix_hit_rate": hit_rate}
