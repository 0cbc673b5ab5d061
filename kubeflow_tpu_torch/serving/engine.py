"""Continuous-batching decode engine over a block-paged KV pool with a
radix prefix cache (port of kubeflow_tpu/serving/engine.py, the parts
the `:generate` slice runs).

- The resident KV cache is a fixed POOL of `num_pages × page_size`
  blocks per layer (models/gpt.py `make_paged_pool`); each slot maps its
  logical positions onto pool pages through a host-owned page table.
- A reference-counted RADIX PREFIX INDEX (host side) remembers committed
  token sequences page by page: a new request whose prompt shares a
  committed prefix maps those pages copy-free, copies the one partially
  matched boundary page (copy-on-write), and prefills only the tail.
- CHUNKED PREFILL feeds prefix tails and prompts past the largest
  bucket through page-aligned multi-token windows over the paged cache,
  so any prompt with prompt + max_new_tokens <= max_len rides the engine.
- Admission is RESERVATION-GATED: a request is admitted only when the
  pool can cover its worst-case page demand, so decode never runs out of
  pages mid-request; overload waits in the bounded queue (429 past it).
- Decode is ONE single-token step over ALL slots per iteration. Page
  tables and cursors are host numpy shipped per dispatch; parked slots
  (cursor = max_len) write nothing.
- SPECULATIVE DECODING (`num_draft_tokens` K > 0 with a `draft_model`):
  each iteration runs K+1 one-token draft steps over all slots on the
  draft's own pool (same page ids, same page table), then ONE target
  forward over all slots × (K+1) positions that keeps each slot's
  longest accepted prefix plus one replacement token. Rollback is host
  cursor arithmetic: the rejected tail stays past the rewound cursor,
  invisible, and the pages only it claimed go back to the pool. Every
  greedy token is the target's argmax, whatever the draft proposes.
- DRAIN flips admission to `EngineDrainingError` (429 + Retry-After at
  the server) while every accepted request, queued or resident, drafted
  or not, runs to completion under a deadline; stragglers then fail
  fast.

- TIERED KV (serving/kv_tiers.py): with `kv_host_bytes` > 0, radix
  eviction parks the last reference's page contents in a host-RAM LRU
  tier instead of dropping them, and an admission whose prompt
  continues the radix match into parked chunks uploads them instead of
  prefilling them. With `kv_persist_dir`, the hottest committed chains
  are written to a two-phase on-disk store (every
  `kv_persist_interval_s`, and once as the scheduler stops) and a new
  engine on the same directory preloads them before its first request.
  The same pages move between replicas: `export_prefix_entries`,
  `export_hot_entries` and `import_page_entries` (the server's
  `/v1/kv/pages`, `:prefill` and `/v1/kv/handoff`). Every move is data
  movement, so greedy output equals the always-resident engine's.

`paged_attention` selects the read path: "gather" (a per-slot view plus
dense attention) or "kernel" (the CUDA page-walk kernels of
ops/paged_attention.py — the counterpart of the JAX engine's "pallas"):
the decode kernel serves every one-token step (the draft's included),
the window kernel every chunk window and the K+1 verify window.
`quantize="int8"` serves int8 weights (dequantized at each use) over
int8 KV pages with bf16 per-vector scales, read through the kernels'
int8 variants (a draft model is int8 too, with its own int8 pool); auto
pool sizing then holds ~2x the pages in the same bytes. The JAX programs
donate the pool; here the pool tensors are updated in place. Greedy
engine output equals `generate()` (serving/generate.py) over the same
weights.

- OBSERVABILITY AND RECOVERY: every request carries a trace id (the
  server's X-Request-Id or traceparent, else one minted) through its
  kft-trace spans (`request.queue_wait` across threads, then
  `request.prefill`, `request.decode`, the `request.retire` event) and
  the scheduler's `engine.step` / `engine.draft` / `engine.verify` spans,
  each closed after the host has read the step's tokens. `debug_state()`
  feeds `/statusz`. The kft-chaos points `engine.prefill` (one
  admission) and `engine.step` (the decode iteration) raise where a
  device failure would; an iteration that raises runs `_recover`: the
  residents fail fast, both pools are zeroed in place, the allocator and
  the radix index start empty, the host tier stays.

- MoE TARGETS (`num_experts > 0`): every
  target program (prefill, chunk, step, verify) passes a
  `MoeCollector` down its forward and returns the folded (expert_tokens
  [E] f32, dropped) pair beside its tokens; the scheduler reads the pair
  in the same device-to-host copy as the tokens (`_fetch`), folds it
  into `stats()["moe"]` and the `serving_moe_*` series. Counts are
  router POSITIONS (idle decode slots and prefill pad tails route too):
  a load-balance signal, not token billing. Dense engines carry no MoE
  state and emit no MoE series. Capacity routing sees the engine's
  padded prefill buckets, so MoE engine tokens follow the engine's
  geometry (buckets, page size, chunking, prefix hits), as in the
  reference, not `generate()`'s.

- THE SERVING MESH (`mesh_tensor`, `mesh_fsdp`, `mesh_expert`;
  parallel/serving_mesh.py): a gang of tensor × fsdp × expert ranks, one
  process a rank. Rank 0 runs this engine and relays every program call
  to the other ranks (serving/relay.py), which run `serve_worker`: the
  same programs on their shard. Weights are held as each rank's blocks
  and gathered at use, the pools by head shard (auto sizing multiplies
  the pages by tensor, so a card's pool bytes stay the 1×1 engine's),
  the expert stacks as E/ep blocks; greedy output is the 1×1 engine's
  bit for bit. Pages leave and enter the engine whole (a spill gathers
  every rank's heads, an upload gives each rank its own).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.chaos import default_chaos
from kubeflow_tpu_torch.models.gpt import (
    PAGED_ATTENTION_IMPLS,
    QUANTIZE_CHOICES,
    KVPool,
    PagedState,
    copy_pool_page,
    gather_pool_pages,
    insert_pages,
    int8_model,
    make_paged_pool,
    pool_page_shape,
    scatter_pool_pages,
)
from kubeflow_tpu_torch.models.layers import MoeCollector
from kubeflow_tpu_torch.observability.trace import default_tracer
from kubeflow_tpu_torch.parallel.serving_mesh import (
    build_serving_mesh,
    resident_bytes,
    validate_serving_mesh,
)
from kubeflow_tpu_torch.routing.affinity import first_page_key
from kubeflow_tpu_torch.serving.batching import Completion
from kubeflow_tpu_torch.serving.relay import (
    HEARTBEAT_S,
    ProgramRelay,
    receive_geometry,
    run_worker,
)
from kubeflow_tpu_torch.serving.kv_tiers import (
    DEFAULT_KV_LAYOUT,
    KV_LAYOUTS,
    HostKVTier,
    HostPageArena,
    PageEntry,
    PersistentPrefixStore,
    page_from_flat,
    page_to_flat,
)
from kubeflow_tpu_torch.serving.sampling import (
    SALT_ACCEPT,
    SALT_CORRECT,
    SALT_DRAFT,
    draw_generator,
    sample_slots,
    sampled_rows,
    slot_probs,
    speculative_accept,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    default_registry,
    serving_engine_recoveries_counter,
    serving_kv_handoff_ms_counter,
    serving_kv_handoff_pages_counter,
    serving_kv_persisted_chains_gauge,
    serving_kv_pool_bytes_per_chip_gauge,
    serving_kv_spill_hits_counter,
    serving_kv_spill_pages_counter,
    serving_moe_capacity_overflow_counter,
    serving_moe_expert_tokens_counter,
    serving_moe_load_imbalance_gauge,
    serving_phase_histogram,
)

log = get_logger(__name__)

DEFAULT_NUM_SLOTS = 8
DEFAULT_MAX_QUEUE = 64
DEFAULT_PAGE_SIZE = 16
DEFAULT_PAGED_ATTENTION = "gather"
DEFAULT_QUANTIZE = "none"
# bound on the distinct first-page affinity keys stats() counts
FIRST_PAGE_KEYS_CAP = 4096


class QueueFullError(RuntimeError):
    """Admission queue at capacity — the server maps this to HTTP 429."""


class EngineDrainingError(QueueFullError):
    """Admission rejected because the engine is draining for shutdown. A
    QueueFullError, so every 429 mapping applies; the server adds
    Retry-After from `retry_after_s` (the client should retry against
    another replica)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineCapacityError(ValueError):
    """The request exceeds the MODEL's window: prompt + max_new_tokens >
    max_len (a 400, as on the static path)."""


def default_prefill_buckets(max_len: int, smallest: int = 8) -> Tuple[int, ...]:
    """Powers of two from `smallest` up to max_len: the prefill shapes."""
    out: List[int] = []
    b = 1
    while b < smallest:
        b *= 2
    while b <= max_len:
        out.append(b)
        b *= 2
    return tuple(out)


def bucket_for(prompt_len: int, buckets: Sequence[int]) -> int:
    """Smallest prefill bucket admitting a prompt of `prompt_len` tokens.
    Prompts past the largest bucket ride head prefill + chunk windows, so
    raising here is an internal contract, not an admission ceiling."""
    for b in buckets:
        if prompt_len <= b:
            return b
    raise EngineCapacityError(
        f"prompt length {prompt_len} exceeds the largest prefill "
        f"bucket {buckets[-1]}"
    )


def _fetch(parts: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Read device tensors to the host in ONE copy: each flattened into
    an f64 buffer (token ids and counts are exact in it), then split
    back into numpy arrays of the parts' shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in parts])
    host = flat.cpu().numpy()
    out, offset = [], 0
    for t in parts:
        n = t.numel()
        out.append(host[offset:offset + n].reshape(tuple(t.shape)))
        offset += n
    return out


def _copied(page: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {name: t.clone() for name, t in page.items()}


def _prefix_key(tokens, n: int) -> tuple:
    """The first `n` tokens (a numpy row) as the radix index's and the
    host tier's key."""
    return tuple(tokens[:n].tolist())


# Chunk-prefill window floor: windows are page-aligned but never smaller
# than this many tokens (a 16-token forward wastes most of a matmul's
# width). Pad positions past the real tail are written onto pages the
# slot owns, stay invisible, and are overwritten by decode.
CHUNK_MIN_TOKENS = 64


def auto_num_pages(num_slots: int, max_len: int, page_size: int) -> int:
    """Default pool sizing: 3/4 of the slot-row footprint (num_slots ×
    max_len), floored at one full-length request."""
    per_slot = max_len // page_size
    return max(per_slot, (num_slots * per_slot * 3) // 4)


def resolve_num_pages(num_pages, num_slots: int, model_cfg, page_size: int,
                      quantize: str = DEFAULT_QUANTIZE, mesh_tensor: int = 1,
                      telemetry=None) -> int:
    """The pool-sizing rule: explicit num_pages wins; auto sizing takes
    `auto_num_pages` and, at quantize=int8, scales it by
    `int8_page_capacity_ratio` (the same bytes hold ~2x the pages).

    `telemetry` (serving/kv_tiers.py `pool_sizing_telemetry`) feeds the
    previous engine's live pressure into the auto fraction: low observed
    utilization shrinks the pool toward 1/2 of the slot-row footprint,
    high utilization or a hot prefix cache keeps the full 3/4. The
    static 3/4 stays the ceiling and the one-full-request floor still
    applies. On a serving mesh of `mesh_tensor` > 1 every rank holds
    1/mesh_tensor of each page (the pools split on heads), so the same
    bytes a card hold mesh_tensor times the pages: auto sizing multiplies
    by it, and a card's pool bytes stay the 1×1 engine's."""
    if num_pages:
        return int(num_pages)
    pages = auto_num_pages(num_slots, model_cfg.max_len, page_size)
    if telemetry:
        util = float(telemetry.get("pages_utilization", 1.0))
        hit = float(telemetry.get("prefix_hit_rate", 0.0))
        # observed occupancy plus headroom for the reuse the prefix
        # cache turns into residency, clamped to [1/2, 3/4] of the
        # slot-row footprint
        frac = min(0.75, max(0.5, util * 1.25 + 0.25 * hit))
        per_slot = model_cfg.max_len // page_size
        pages = max(per_slot, int(num_slots * per_slot * frac))
    if quantize == "int8":
        head_dim = model_cfg.hidden_size // model_cfg.num_heads
        itemsize = torch.finfo(model_cfg.dtype).bits // 8
        pages = int(pages * int8_page_capacity_ratio(head_dim, itemsize))
    return pages * max(1, int(mesh_tensor))


def int8_page_capacity_ratio(head_dim: int, itemsize: int = 2) -> float:
    """How many int8 pages fit in one unquantized page's bytes: a cached
    K/V vector costs itemsize·D bytes unquantized and D + 2 quantized
    (int8 values, one bf16 scale): 1.94 for bf16 at D=64."""
    return (itemsize * float(head_dim)) / (head_dim + 2.0)


# ---------------------------------------------------------------------------
# Host-side page accounting: the pool allocator and the radix prefix index.
# Both are scheduler-thread-owned (no locks) — every mutation happens
# between device dispatches.
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator with reference counts. A page is held by
    each slot that maps it plus (at most once) the radix prefix index;
    it returns to the free list when the last reference drops.
    Tree-evictability is tracked incrementally (a tree flag per page and
    a count of tree pages some slot also maps)."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._tree = np.zeros((self.num_pages,), bool)
        self._tree_pages = 0
        self._tree_shared = 0  # tree pages a slot ALSO maps (unevictable)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def tree_pages(self) -> int:
        """Pages the prefix index holds a reference to."""
        return self._tree_pages

    @property
    def tree_evictable(self) -> int:
        """Pages whose ONLY reference is the prefix index."""
        return self._tree_pages - self._tree_shared

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None if the free list is
        short (the caller evicts from the prefix index and retries)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._ref[p] += 1
            if self._tree[p] and self._ref[p] == 2:
                self._tree_shared += 1

    def release(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; returns how many pages freed."""
        freed = 0
        for p in pages:
            self._ref[p] -= 1
            if self._tree[p] and self._ref[p] == 1:
                self._tree_shared -= 1
            if self._ref[p] <= 0:
                self._ref[p] = 0
                self._free.append(p)
                freed += 1
        return freed

    def mark_tree(self, page: int) -> None:
        """The prefix index adopted this page (call AFTER its retain)."""
        self._tree[page] = True
        self._tree_pages += 1
        if self._ref[page] > 1:
            self._tree_shared += 1

    def unmark_tree(self, page: int) -> None:
        """The prefix index is dropping this page (call BEFORE its
        release)."""
        self._tree[page] = False
        self._tree_pages -= 1
        if self._ref[page] > 1:
            self._tree_shared -= 1

    def reset(self) -> None:
        """Everything free again (a failed preload's cold start)."""
        self.__init__(self.num_pages)


class _RadixNode:
    __slots__ = ("chunk", "page", "children", "parent", "last_used", "hits")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk          # tuple of page_size token ids
        self.page = page            # pool page holding this chunk's K/V
        self.parent = parent
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.last_used = 0
        self.hits = 0               # full-page matches: the persist rank

    def key(self) -> tuple:
        """The page-aligned token prefix this node commits: the host
        tier's and the prefix store's entry key."""
        parts = []
        node = self
        while node.chunk is not None:
            parts.append(node.chunk)
            node = node.parent
        return tuple(t for chunk in reversed(parts) for t in chunk)


class RadixPrefixIndex:
    """Reference-counted radix tree over committed token sequences with
    PAGE-ALIGNED edges: each node is one full page, children keyed by
    their chunk's token tuple. Token-level reuse happens at the frontier:
    the longest common prefix with any child's chunk names the
    copy-on-write candidate.

    Slots commit their FULL pages at retire; eviction removes the least
    recently matched LEAVES, releasing the tree's reference. Host data
    touched only by the scheduler thread."""

    def __init__(self, page_size: int, pool: PagePool):
        self.page_size = int(page_size)
        self.pool = pool
        self.root = _RadixNode(None, -1, None)
        self.nodes = 0  # committed pages in the tree (/statusz)
        self._clock = 0
        # leaves maintained incrementally: eviction scans only these
        self._leaves: Dict[_RadixNode, None] = {}
        # called with (token key, page, hits) just before eviction drops
        # the LAST reference to a page: the engine's chance to park the
        # contents in the host tier. None = no spill.
        self.spill_hook = None

    def reset(self) -> None:
        self.root = _RadixNode(None, -1, None)
        self.nodes = 0
        self._leaves = {}

    def match(self, tokens) -> Tuple[List[int], int, Optional[Tuple[int, int]]]:
        """Longest committed prefix of `tokens`: (full-page chain,
        matched token count, partial) where partial = (page, r) names a
        frontier page whose first r tokens continue the prompt (the COW
        candidate), or None."""
        ps = self.page_size
        self._clock += 1
        node = self.root
        pages: List[int] = []
        i, n = 0, len(tokens)
        while n - i >= ps:
            chunk = tuple(int(t) for t in tokens[i : i + ps])
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = self._clock
            child.hits += 1
            pages.append(child.page)
            node = child
            i += ps
        partial = None
        rest = [int(t) for t in tokens[i:]]
        if rest:
            best, best_child = 0, None
            for chunk, child in node.children.items():
                r = 0
                for a, c in zip(rest, chunk):
                    if a != c:
                        break
                    r += 1
                if r > best:
                    best, best_child = r, child
            if best_child is not None:
                best_child.last_used = self._clock
                partial = (best_child.page, best)
        return pages, i, partial

    def insert(self, tokens, pages: Sequence[int]) -> None:
        """Commit `len(pages)` full pages of `tokens` (page-aligned). New
        chunks adopt the slot's page with a tree reference; chunks already
        committed keep the existing page (the caller's release drops the
        slot's duplicate)."""
        ps = self.page_size
        self._clock += 1
        node = self.root
        i = 0
        for pg in pages:
            chunk = tuple(int(t) for t in tokens[i : i + ps])
            i += ps
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(chunk, int(pg), node)
                if not node.children and node is not self.root:
                    del self._leaves[node]  # gained a child: not a leaf
                node.children[chunk] = child
                self._leaves[child] = None
                self.pool.retain([int(pg)])
                self.pool.mark_tree(int(pg))
                self.nodes += 1
            child.last_used = self._clock
            node = child

    def evictable_pages(self) -> int:
        return self.pool.tree_evictable

    def evict(self, need: int) -> int:
        """Remove least-recently-matched leaves until `need` pages have
        actually freed (a leaf a resident slot still maps releases the
        tree ref but frees nothing)."""
        freed = 0
        while freed < need and self._leaves:
            victim = min(self._leaves, key=lambda n: n.last_used)
            del self._leaves[victim]
            del victim.parent.children[victim.chunk]
            parent = victim.parent
            if not parent.children and parent is not self.root:
                self._leaves[parent] = None
            self.nodes -= 1
            self.pool.unmark_tree(victim.page)
            if (self.spill_hook is not None
                    and self.pool.refcount(victim.page) == 1):
                # the release below frees the page (the tree held the
                # last reference): park its contents first, keyed by
                # the whole page-aligned prefix it committed
                self.spill_hook(victim.key(), victim.page, victim.hits)
            freed += self.pool.release([victim.page])
        return freed

    def hot_chains(self, limit: int) -> List[Tuple[tuple, int, int]]:
        """The persist set: up to `limit` committed nodes as (token key,
        page, hits), ranked by hits, each with every ancestor on its
        chain, sorted parents first (the loader admits parents before
        children). Walks the whole tree: persists come seconds apart,
        not steps."""
        nodes: List[_RadixNode] = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            nodes.append(node)
            stack.extend(node.children.values())
        nodes.sort(key=lambda n: n.hits, reverse=True)
        chosen: Dict[_RadixNode, None] = {}
        for node in nodes:
            if len(chosen) >= limit:
                break
            chain = []
            walk = node
            while walk.chunk is not None and walk not in chosen:
                chain.append(walk)
                walk = walk.parent
            if len(chosen) + len(chain) > limit:
                continue
            for n in chain:
                chosen[n] = None
        out = [(n.key(), n.page, n.hits) for n in chosen]
        out.sort(key=lambda e: len(e[0]))
        return out


class EnginePrograms:
    """The engine's device programs (the JAX `EnginePrograms` bodies as
    plain methods): prefill, insert, chunk, cow and step, plus at K > 0
    the draft family (draft_prefill, draft_chunk, draft) and verify;
    `insert` and `cow` serve the draft's pool too. Every program that
    writes a pool writes it in place.

    Paged geometry (`page_size`, `num_pages`), `quantize` (int8 pools
    follow the weights) and the draft (`draft_model`, `num_draft_tokens`)
    are construction state. The draft's pool has the target's geometry:
    the engine maps one page id onto both.

    On a serving mesh (`mesh`, parallel/serving_mesh.py) the target and
    the draft are validated against the mesh and held as this rank's
    blocks (their leaves are cut in place), the pools hold this rank's
    heads, and every program runs on the shard: the page writes and the
    paged kernels on the local heads, the weights gathered at use. A
    spill gathers every rank's heads (whole pages come out on rank 0, the
    `leader`), and an upload writes each rank's heads of whole pages."""

    def __init__(self, model, *, page_size: int, num_pages: int,
                 paged_attention: str, quantize: str = DEFAULT_QUANTIZE,
                 draft_model=None, num_draft_tokens: int = 0, mesh=None):
        cfg = model.cfg
        self.model = model
        # an MoE target's programs return their (expert_tokens [E],
        # dropped) pair beside their tokens
        self.moe = getattr(cfg, "num_experts", 0) > 0
        if paged_attention not in PAGED_ATTENTION_IMPLS:
            raise ValueError(
                f"paged_attention {paged_attention!r} must be one of "
                f"{PAGED_ATTENTION_IMPLS}"
            )
        if quantize not in QUANTIZE_CHOICES:
            raise ValueError(
                f"quantize {quantize!r} must be one of {QUANTIZE_CHOICES}"
            )
        if model.quantize != quantize:
            raise ValueError(
                f"quantize={quantize!r} programs need a model whose weights "
                f"are {quantize!r}, not {model.quantize!r}"
            )
        self.num_draft_tokens = int(num_draft_tokens)
        if self.num_draft_tokens < 0:
            raise ValueError("num_draft_tokens must be >= 0")
        self.draft_model = None
        if self.num_draft_tokens > 0:
            if draft_model is None:
                raise ValueError(
                    "num_draft_tokens > 0 needs a draft_model (speculative "
                    "decoding drafts from a resident second model)"
                )
            dcfg = draft_model.cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: the verify step compares token "
                    "ids, so the models must share a vocabulary"
                )
            if dcfg.max_len < cfg.max_len:
                raise ValueError(
                    f"draft max_len {dcfg.max_len} < target max_len "
                    f"{cfg.max_len}: the draft cache tracks the same "
                    "token positions as the target's"
                )
            if draft_model.quantize != quantize:
                raise ValueError(
                    f"quantize={quantize!r} programs need a draft whose "
                    f"weights are {quantize!r}, not {draft_model.quantize!r}"
                )
            self.draft_model = draft_model
        self.paged_attention = paged_attention
        self.quantize = quantize
        self.page_size = int(page_size)
        if self.page_size < 1 or self.page_size & (self.page_size - 1):
            raise ValueError(
                f"page_size {self.page_size} must be a positive power of two"
            )
        if cfg.max_len % self.page_size:
            raise ValueError(
                f"page_size {self.page_size} must divide the model's "
                f"max_len {cfg.max_len}"
            )
        self.max_pages_per_slot = cfg.max_len // self.page_size
        # chunk windows: whole pages, floored for matmul width, capped by
        # the logical window
        self.chunk_len = min(max(self.page_size, CHUNK_MIN_TOKENS), cfg.max_len)
        self.chunk_len -= self.chunk_len % self.page_size
        self.num_pages = int(num_pages)
        if self.num_pages < self.max_pages_per_slot:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold one full-length "
                f"request ({self.max_pages_per_slot} pages of "
                f"{self.page_size})"
            )
        self.mesh = mesh
        self.heads = None if mesh is None else mesh.heads
        self.leader = mesh is None or mesh.leader
        if mesh is not None:
            # the models were validated against the mesh before it was
            # built (DecodeEngine, serve_worker)
            mesh.shard_model(model)
            if self.draft_model is not None:
                mesh.shard_model(self.draft_model)

    def _paged(self, page_table, cursors) -> PagedState:
        return PagedState(page_table, cursors, attn_impl=self.paged_attention,
                          heads=self.heads)

    def _collector(self) -> Optional[MoeCollector]:
        return MoeCollector() if self.moe else None

    def prefill(self, ids, mask, seed, temp, top_k, top_p):
        """Batch-1 bucketed prefill → (slot cache, first token[, MoE
        pair])."""
        moe = self._collector()
        logits, cache = self.model.prefill(ids, mask, moe=moe)
        last = int(mask[0].sum()) - 1
        tok = sample_slots(
            logits[:, max(last, 0)], [seed], [0], [temp], [top_k], [top_p]
        )
        if moe is None:
            return cache, tok[0]
        return cache, tok[0], moe.serving_stats()

    def make_pool(self, device) -> KVPool:
        return make_paged_pool(self.model.cfg, self.num_pages,
                               self.page_size, device, kv_quant=self.quantize,
                               heads=self.heads)

    def page_template(self, pool: KVPool) -> Dict[str, torch.Tensor]:
        """One whole page of `pool` (every head, on a mesh too), shapes
        and dtypes only (meta tensors): what a spilled, stored or shipped
        page holds."""
        return {name: torch.empty(pool_page_shape(t, self.heads),
                                  dtype=t.dtype, device="meta")
                for name, t in pool.fields().items()}

    def insert(self, pool: KVPool, cache_one, page_ids, real_len: int):
        """Copy the prefill rows into the slot's pages (quantized on the
        way into an int8 pool)."""
        return insert_pages(pool, cache_one, page_ids, real_len,
                            heads=self.heads)

    def chunk(self, pool: KVPool, ids, page_table, cursor, sample_idx: int,
              seed, temp, top_k, top_p):
        """One page-aligned prefill window through the paged path: writes
        the window's K/V into the slot's pages and samples the token after
        window position `sample_idx` (meaningful only for the chunk
        holding the prompt's last real token); an MoE target returns
        (token, MoE pair)."""
        moe = self._collector()
        logits = self.model.paged_forward(
            ids, pool, self._paged(page_table, cursor), moe=moe
        )
        tok = sample_slots(
            logits[0, sample_idx][None], [seed], [0], [temp], [top_k],
            [top_p],
        )
        return tok[0] if moe is None else (tok[0], moe.serving_stats())

    def cow(self, pool: KVPool, src: int, dst: int):
        return copy_pool_page(pool, src, dst)

    def spill(self, pool: KVPool, pages: Sequence[int],
              out: Optional[Sequence[dict]] = None) -> List[dict]:
        """Copy pages of `pool` (target's or draft's) to host memory, one
        page tree each (into `out`'s trees when given): the host tier's,
        the store's and the handoff's read. The copy is complete on
        return, so the pages may be reused right after. On a mesh the
        pages are whole: every rank's heads are gathered, and a rank but
        the leader keeps nothing."""
        if not self.leader:
            if self.heads is not None:
                gather_pool_pages(pool, pages, heads=self.heads)
            return []
        return gather_pool_pages(pool, pages, device="cpu", out=out,
                                 heads=self.heads)

    def upload(self, pool: KVPool, page_trees: Sequence[dict],
               dsts: Sequence[int]):
        """Write spilled pages onto pool pages `dsts` (in place; on a
        mesh each rank its heads of the whole pages)."""
        return scatter_pool_pages(pool, page_trees, dsts, heads=self.heads)

    def reset(self, pool: KVPool) -> None:
        """Zero `pool` in place (recovery): a fresh pool's state, int8
        scales included."""
        for t in pool.tensors():
            t.zero_()

    def heartbeat(self) -> None:
        """Nothing to keep alive in one process (`ProgramRelay` pings
        its workers)."""

    def close(self) -> None:
        """Nothing to end in one process (`ProgramRelay` ends its
        workers)."""

    def step(self, pool: KVPool, tokens, page_table, cursors, seeds,
             counters, temps, top_ks, top_ps):
        """One single-token decode step over all slots → [S] tokens (an
        MoE target: ([S] tokens, MoE pair))."""
        moe = self._collector()
        logits = self.model.paged_forward(
            tokens[:, None], pool, self._paged(page_table, cursors), moe=moe
        )
        toks = sample_slots(
            logits[:, 0], seeds, counters, temps, top_ks, top_ps
        )
        return toks if moe is None else (toks, moe.serving_stats())

    # -- the speculative draft-and-verify family (K > 0) -------------------

    def make_draft_pool(self, device) -> KVPool:
        return make_paged_pool(self.draft_model.cfg, self.num_pages,
                               self.page_size, device, kv_quant=self.quantize,
                               heads=self.heads)

    def draft_prefill(self, ids, mask):
        """Seed the draft's batch-1 cache over the same bucketed prompt
        the target prefilled. The first token comes from the target's
        prefill, so only the cache returns."""
        return self.draft_model.prefill(ids, mask)[1]

    def draft_chunk(self, dpool: KVPool, ids, page_table, cursor) -> None:
        """The draft side of a prefill chunk: the same window on the same
        pages of its own pool, so the draft's cache stays position for
        position in lockstep with the target's."""
        self.draft_model.paged_forward(
            ids, dpool, self._paged(page_table, cursor)
        )

    def draft(self, dpool: KVPool, tokens, page_table, cursors, seeds,
              counters, temps, top_ks, top_ps):
        """K+1 one-token draft steps over all slots, step j writing at
        `cursors + j` → (proposals [S, K], q [R, K, V] or None): q are
        the sampled rows' (`sampled_rows(temps)`) filtered distributions
        the proposals were drawn from, what the verify's rejection rule
        needs. The (K+1)-th step only writes d_K's K/V, so the draft pool
        ends the iteration with the same K+1 positions written as the
        target's verify window."""
        kk = self.num_draft_tokens
        tok, proposals, qs = tokens, [], []
        for j in range(kk + 1):
            logits = self.draft_model.paged_forward(
                tok[:, None], dpool, self._paged(page_table, cursors + j)
            )
            if j == kk:
                break
            tok, q = sample_slots(
                logits[:, 0], seeds, counters + j, temps, top_ks, top_ps,
                salt=SALT_DRAFT, with_probs=True,
            )
            proposals.append(tok)
            if q is not None:
                qs.append(q)
        return torch.stack(proposals, 1), (torch.stack(qs, 1) if qs else None)

    def verify(self, pool: KVPool, tokens, proposals, qs, page_table,
               cursors, seeds, counters, temps, top_ks, top_ps):
        """ONE target forward over all slots × (K+1) positions (the
        window: each slot's last emitted token `tokens`, then the draft's
        `proposals`), then each slot's longest accepted prefix plus one
        replacement → (tokens [S, K+1], lengths [S]): a slot emits
        tokens[s, :lengths[s]], 1..K+1 of them.

        Greedy slots accept while the proposal equals the target's argmax
        and replace with the argmax. Sampled slots run
        `speculative_accept` (uniforms on the SALT_ACCEPT stream at
        positions counters + j); the replacement is drawn on the
        SALT_CORRECT stream from the residual at the first rejection, or
        after a clean sweep from the (K+1)-th target distribution (the
        bonus token). Only that one draw is made: the others would be
        discarded. An MoE target appends its MoE pair."""
        window = torch.cat([tokens[:, None], proposals], dim=1)
        kk = window.shape[1] - 1
        moe = self._collector()
        logits = self.model.paged_forward(
            window, pool, self._paged(page_table, cursors), moe=moe
        )
        greedy = logits.argmax(dim=-1)  # [S, K+1]
        drafted = window[:, 1:]
        accept = drafted == greedy[:, :kk]
        replacement = greedy
        sampled = sampled_rows(temps)
        if sampled:
            dev = logits.device
            rows = torch.as_tensor(sampled, device=dev)
            vocab = logits.shape[-1]

            def per_position(knob):
                return [knob[i] for i in sampled for _ in range(kk + 1)]

            p = slot_probs(
                logits[rows].reshape(-1, vocab), per_position(temps),
                per_position(top_ks), per_position(top_ps),
            ).reshape(len(sampled), kk + 1, vocab)
            uniforms = torch.stack([torch.stack([
                torch.rand((), generator=draw_generator(
                    "cpu", seeds[i], counters[i] + j, SALT_ACCEPT))
                for j in range(kk)
            ]) for i in sampled]).to(dev)
            acc_s, residual = speculative_accept(
                p[:, :kk], qs, drafted[rows], uniforms
            )
            accept = accept.clone()
            accept[rows] = acc_s
            replacement = greedy.clone()
            first = torch.cumprod(acc_s.long(), dim=1).sum(dim=1).tolist()
            for r, (i, a) in enumerate(zip(sampled, first)):
                dist = residual[r, a] if a < kk else p[r, kk]
                gen = draw_generator(dev, seeds[i], counters[i] + a,
                                     SALT_CORRECT)
                replacement[i, a] = torch.multinomial(dist, 1,
                                                      generator=gen)[0]
        acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [S] in [0, K]
        padded = torch.cat([drafted, torch.zeros_like(drafted[:, :1])], 1)
        pos = torch.arange(kk + 1, device=acc.device)
        tokens = torch.where(pos[None, :] < acc[:, None], padded, replacement)
        if moe is None:
            return tokens, acc + 1
        return tokens, acc + 1, moe.serving_stats()


class _Request:
    """One admitted-or-queued generation request."""

    __slots__ = (
        "prompt", "max_new", "temperature", "top_k", "top_p", "eos_id",
        "seed", "t_submit", "future", "trace_id", "parent_span_id",
        "queue_span",
    )

    def __init__(self, prompt, max_new, temperature, top_k, top_p, eos_id,
                 seed, trace_id=None, parent_span_id=None):
        self.prompt = prompt  # np.int64 [P], real tokens only
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.seed = seed
        self.t_submit = time.monotonic()
        # completes with {"tokens": [...], "ttft_s": float}
        self.future = Completion()
        # kft-trace: the request's id on every span it records, the
        # remote parent of its spans (an inbound traceparent's span), and
        # the open cross-thread queue span (ended at admission)
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.queue_span = None


class _Slot:
    """Host bookkeeping for one occupied decode slot."""

    __slots__ = ("req", "tokens", "ttft_s", "queue_s", "t_admitted",
                 "decode_span")

    def __init__(self, req: _Request):
        self.req = req
        self.tokens: List[int] = []
        self.ttft_s = 0.0
        # phase accounting: submit → admission (queue), admission → first
        # token (prefill: ttft_s - queue_s), then decode until retire
        self.queue_s = 0.0
        self.t_admitted = 0.0
        self.decode_span = None


class DecodeEngine:
    """The persistent paged-KV decode engine for one causal LM.

    Thread model: `submit()` (any thread) only touches the admission queue
    under the condition lock; the scheduler thread owns the pool, all page
    accounting and the slot table, so the hot loop takes no lock around
    device work. Aggregate counters live behind their own lock.

    `device` defaults to "cuda" and raises without CUDA unless "cpu" is
    asked for; the model's weights must already live there.

    `quantize="int8"` serves the int8 model of `model`: built once here
    (`models/gpt.py int8_model`, `model` itself is left full width) unless
    `model` already is one (e.g. from an envelope).

    `num_draft_tokens` K > 0 decodes speculatively with `draft_model`
    (a model with its own weights on the engine's device, the same
    vocabulary and at least the target's max_len; at int8 it becomes an
    int8 model too). A drafted engine never runs the one-token step.

    KV tiers (serving/kv_tiers.py; both need the prefix cache):
    `kv_host_bytes` > 0 parks evicted prefix pages in a host-RAM LRU of
    that many bytes; `kv_persist_dir` keeps the `kv_persist_chains`
    hottest committed pages in an on-disk store, written every
    `kv_persist_interval_s` (0: only as the scheduler stops) and
    preloaded by the next engine on the directory. `pool_telemetry`
    (`kv_tiers.pool_sizing_telemetry()`) sizes an auto pool from an
    earlier engine's pressure. Pages leave the engine (store, export)
    as the JAX pool's leaves in `kv_layout`: "scan" (the JAX serving
    entrypoint's models) or "named"; they come in from either.

    `mesh_tensor`, `mesh_fsdp`, `mesh_expert` above 1 serve on a
    `tensor × fsdp × expert` serving mesh (parallel/serving_mesh.py): a
    gang of that many ranks, one process a rank, whose rank 0 builds
    this engine while every other rank runs `serve_worker` with the same
    model (and draft). The engine takes its model over: its leaves
    become this rank's blocks (an int8 engine's int8 model's). Every
    program call is relayed to the workers (serving/relay.py), so the
    host state (the page allocator, the radix index, the host tier, the
    slot table) stays this rank's alone, as in the JAX engine; `close()`
    ends the workers. Greedy tokens are bit for bit the 1×1 engine's."""

    def __init__(
        self,
        name: str,
        model,
        *,
        device: DeviceLike = None,
        num_slots: int = DEFAULT_NUM_SLOTS,
        prefill_buckets: Optional[Sequence[int]] = None,
        max_queue: int = DEFAULT_MAX_QUEUE,
        autostart: bool = True,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        paged_attention: Optional[str] = None,
        quantize: Optional[str] = None,
        draft_model=None,
        num_draft_tokens: int = 0,
        kv_host_bytes: int = 0,
        kv_persist_dir: Optional[str] = None,
        kv_persist_interval_s: float = 0.0,
        kv_persist_chains: int = 64,
        pool_telemetry=None,
        kv_layout: str = DEFAULT_KV_LAYOUT,
        mesh_tensor: Optional[int] = None,
        mesh_fsdp: Optional[int] = None,
        mesh_expert: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(
                f"kv_layout {kv_layout!r} must be one of {KV_LAYOUTS}"
            )
        if int(num_draft_tokens) <= 0:
            draft_model = None  # K = 0 ignores a draft, as the reference
        meshed = max(int(mesh_tensor or 1), int(mesh_fsdp or 1),
                     int(mesh_expert or 1)) > 1
        check_model_devices(self.device, meshed, model, draft_model)
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        cfg = model.cfg
        self.quantize = quantize or DEFAULT_QUANTIZE
        if self.quantize not in QUANTIZE_CHOICES:
            raise ValueError(
                f"quantize {self.quantize!r} must be one of {QUANTIZE_CHOICES}"
            )
        # the serving mesh: validated before anything is built, the
        # draft too (a dense draft rides an MoE target's expert axis whole)
        self.mesh_tensor = int(mesh_tensor or 1)
        self.mesh_fsdp = int(mesh_fsdp or 1)
        self.mesh_expert = int(mesh_expert or 1)
        mesh_sizes = {"tensor": self.mesh_tensor, "fsdp": self.mesh_fsdp,
                      "expert": self.mesh_expert}
        validate_serving_mesh(cfg, **mesh_sizes)
        if draft_model is not None:
            validate_serving_mesh(draft_model.cfg, **mesh_sizes,
                                  role="draft")
        same_draft = draft_model is model
        if self.quantize == "int8":
            # the resident weights become int8 + per-channel scales, once;
            # a draft that is the target shares the target's int8 model
            model = int8_model(model)
            if draft_model is not None:
                draft_model = model if same_draft else int8_model(
                    draft_model)
        self.name = name
        self.model = model
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.paged_attention = paged_attention or DEFAULT_PAGED_ATTENTION
        ps = int(page_size) if page_size else DEFAULT_PAGE_SIZE
        pool_pages = resolve_num_pages(num_pages, num_slots, cfg, ps,
                                       self.quantize, self.mesh_tensor,
                                       telemetry=pool_telemetry)
        # None on the 1×1 engine (no gang needed); a gang collective else
        self.mesh = build_serving_mesh(**mesh_sizes, device=self.device)
        if self.mesh is not None and not self.mesh.leader:
            raise ValueError("rank 0 of a serving mesh builds the engine; "
                             "every other rank runs serve_worker")
        self.programs = None
        try:
            self._build(name, model, cfg, ps, pool_pages, num_slots,
                        prefill_buckets, prefix_cache, draft_model,
                        num_draft_tokens, same_draft, kv_host_bytes,
                        kv_persist_dir, kv_persist_interval_s,
                        kv_persist_chains, kv_layout, autostart)
        except BaseException:
            if self.mesh is not None:
                # the workers wait for their build or their next call
                relay = self.programs
                if not isinstance(relay, ProgramRelay):
                    relay = ProgramRelay(None, self.mesh)
                relay.close()
            raise

    def _build(self, name, model, cfg, ps, pool_pages, num_slots,
               prefill_buckets, prefix_cache, draft_model, num_draft_tokens,
               same_draft, kv_host_bytes, kv_persist_dir,
               kv_persist_interval_s, kv_persist_chains, kv_layout,
               autostart) -> None:
        """The engine past its mesh: programs (on a mesh, handed to the
        workers once they are built here: a build that raises ends them
        unbuilt), pools, host state, metrics, the warm restart and the
        scheduler thread."""
        programs = EnginePrograms(
            model, page_size=ps, num_pages=pool_pages,
            paged_attention=self.paged_attention, quantize=self.quantize,
            draft_model=draft_model, num_draft_tokens=num_draft_tokens,
            mesh=self.mesh,
        )
        if self.mesh is not None:
            ProgramRelay.build(self.mesh, {
                "cfg": cfg, "page_size": ps, "num_pages": pool_pages,
                "paged_attention": self.paged_attention,
                "quantize": self.quantize,
                "num_draft_tokens": programs.num_draft_tokens,
                "draft_cfg": (None if programs.draft_model is None
                              else programs.draft_model.cfg),
                "draft_is_target": same_draft,
            })
            programs = ProgramRelay(programs, self.mesh)
        self.programs = programs
        self.num_draft_tokens = self.programs.num_draft_tokens
        self.draft_model = self.programs.draft_model
        self.page_size = ps
        self.num_pages = pool_pages
        self._max_pages = self.programs.max_pages_per_slot
        self.prefix_cache_enabled = bool(prefix_cache)
        buckets = tuple(
            sorted(prefill_buckets) if prefill_buckets
            else default_prefill_buckets(cfg.max_len)
        )
        for b in buckets:
            if b < 1 or b > cfg.max_len:
                raise ValueError(
                    f"prefill bucket {b} outside [1, max_len={cfg.max_len}]"
                )
            if b & (b - 1):
                raise ValueError(f"prefill bucket {b} not a power of two")
        self.prefill_buckets = buckets

        # -- device state (scheduler-thread-owned after start) ----------
        self._pool = self.programs.make_pool(self.device)
        # the draft's pool mirrors the target's page ids page for page
        self._draft_pool = (
            self.programs.make_draft_pool(self.device)
            if self.num_draft_tokens > 0 else None
        )
        # values and, in int8, their scales, of both pools: the bytes the
        # pools hold (on a tensor mesh every rank holds 1/tensor of each
        # page: the whole pools are tensor times this rank's)
        self.kv_pool_bytes_per_chip = self._pool.nbytes + (
            self._draft_pool.nbytes if self._draft_pool is not None else 0
        )
        self.kv_pool_bytes = self.kv_pool_bytes_per_chip * self.mesh_tensor
        # the weights this rank holds (its blocks on a mesh)
        self.weight_bytes_per_chip = resident_bytes(self.model) + (
            resident_bytes(self.draft_model)
            if self.draft_model is not None
            and self.draft_model is not self.model else 0
        )
        # -- host page accounting (scheduler-thread-owned) --------------
        self._pagepool = PagePool(self.num_pages)
        self._radix = (
            RadixPrefixIndex(ps, self._pagepool)
            if self.prefix_cache_enabled else None
        )
        # -- KV tiers (serving/kv_tiers.py): host RAM below the pool, disk
        # below that, both keyed by the radix index's token tuples; pages
        # leave the engine as the JAX pool's leaves in `kv_layout`
        self.kv_layout = kv_layout
        self.kv_host_bytes = int(kv_host_bytes or 0)
        self.kv_persist_dir = kv_persist_dir or None
        self.kv_persist_interval_s = float(kv_persist_interval_s or 0.0)
        self.kv_persist_chains = int(kv_persist_chains)
        self._host_tier: Optional[HostKVTier] = None
        self._persist_store: Optional[PersistentPrefixStore] = None
        # eviction's victims, in the hook's order, waiting for their one
        # batched device→host copy (_flush_spills)
        self._pending_spills: List[Tuple[tuple, int, int]] = []
        if self._radix is not None and self.kv_host_bytes > 0:
            # the tier's pages live in an arena of page slots, allocated
            # (and on the card pinned) once: the budget's pages, and one
            # request's more for the pages an admission has taken out of
            # the tier and is still uploading
            template = self._page_template(self._pool)
            dtemplate = (self._page_template(self._draft_pool)
                         if self._draft_pool is not None else None)
            self._host_page_bytes = sum(
                t.numel() * t.element_size()
                for page in (template, dtemplate or {}) for t in page.values()
            )
            self._host_capacity = self.kv_host_bytes // self._host_page_bytes
            if self._host_capacity < 1:
                raise ValueError(
                    f"kv_host_bytes {self.kv_host_bytes} holds no page "
                    f"({self._host_page_bytes} B a page)"
                )
            self._host_arena = HostPageArena(
                template, dtemplate, self._host_capacity + self._max_pages,
                pin=self.device.type == "cuda",
            )
            self._host_tier = HostKVTier(
                self.kv_host_bytes,
                on_drop=lambda entry: self._host_arena.release(entry.slot),
            )
            self._radix.spill_hook = self._spill_page
        if self._radix is not None and self.kv_persist_dir:
            self._persist_store = PersistentPrefixStore(self.kv_persist_dir)
        self._last_persist = time.monotonic()
        self._pt_np = np.zeros((num_slots, self._max_pages), np.int32)
        # parked cursor = max_len: the paged write drops positions past
        # the logical window, so idle/retired rows write nothing
        self._cur_np = np.full((num_slots,), cfg.max_len, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        # leading prefix pages a slot maps and does not own (never freed
        # by a rewind)
        self._slot_shared = np.zeros((num_slots,), np.int32)
        self._slot_reserve = np.zeros((num_slots,), np.int32)
        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._tok_np = np.zeros((num_slots,), np.int64)
        self._seed_np = np.zeros((num_slots,), np.int64)
        # each slot's draw counter: +1 a one-token step, +K+1 a verify
        # iteration (consumed or not)
        self._cnt_np = np.zeros((num_slots,), np.int64)
        self._temp_np = np.zeros((num_slots,), np.float32)
        self._topk_np = np.zeros((num_slots,), np.int64)
        self._topp_np = np.ones((num_slots,), np.float32)

        # -- shared state (condition-lock-guarded) ----------------------
        self._cv = threading.Condition()
        self._queue: deque = deque()
        # control jobs (the page export/import surface): closures that
        # touch scheduler-owned state, run between iterations on the
        # scheduler thread (_run_on_scheduler)
        self._control: deque = deque()
        self._stop = False
        # drain(): admission refused from here on; `_admitting` counts
        # requests popped from the queue and not yet resident, so drain's
        # idle check never misses one mid-admission
        self._draining = False
        self._admitting = 0
        # a serving mesh whose relayed call failed once sent (_fail_mesh):
        # the engine is dead for good
        self._failed: Optional[BaseException] = None

        self._stats_lock = threading.Lock()
        self._admitted = 0
        self._steps = 0
        # host wall time of the decode steps, tokens fetched included
        self._step_seconds = 0.0
        self._emitted = 0
        self._occupied_slot_steps = 0
        self._prefix_hit_tokens = 0
        self._prefix_lookups = 0
        self._cow_copies = 0
        self._prefill_compute_tokens = 0
        self._pages_allocated = 0
        # speculation: proposals, accepted proposals, verify iterations,
        # pages a rewind gave back
        self._drafted = 0
        self._accepted = 0
        self._verifies = 0
        self._rewind_pages_returned = 0
        # KV tiers: pages parked in the host tier, pages re-admitted from
        # it, pages in the last persisted (or preloaded) generation, and
        # the wall time of the last persist and of the preload
        self._spill_pages = 0
        self._spill_hits = 0
        self._persisted_chains = 0
        self._persist_seconds = 0.0
        self._preload_seconds = 0.0
        # read-path evidence: window size (query rows per pool walk) ->
        # read path that served it
        self._attn_windows: Dict[int, str] = {}
        # distinct first-page affinity keys admitted (capped): this
        # replica's slice of the router's key space
        self._first_page_keys: set = set()

        # kft-trace: request phases and scheduler iterations ride the
        # process tracer (a disabled tracer makes every span a shared
        # no-op); kft-chaos: the engine.{prefill,step} injection points
        self._tracer = default_tracer()
        self._chaos = default_chaos()
        # recent finished requests' phase breakdowns for /statusz:
        # appended by the scheduler, read by HTTP handlers
        self._recent: deque = deque(maxlen=32)

        reg = default_registry()
        self._ttft = reg.histogram(
            "serving_time_to_first_token_seconds",
            "submit to first token", ["model"],
        )
        self._decode_steps_m = reg.counter(
            "serving_decode_steps_total", "engine decode steps", ["model"]
        )
        self._tokens_m = reg.counter(
            "serving_tokens_total", "tokens emitted", ["model"]
        )
        self._attn_calls_m = reg.counter(
            "serving_paged_attention_calls_total",
            "pool-reading dispatches by read path", ["model", "variant"],
        )
        self._queue_depth_g = reg.gauge(
            "serving_queue_depth", "admission queue depth", ["model"]
        )
        self._occupancy_g = reg.gauge(
            "serving_slot_occupancy", "occupied slot fraction", ["model"]
        )
        self._pages_in_use_g = reg.gauge(
            "serving_kv_pages_in_use", "pool pages in use", ["model"]
        )
        self._draft_proposed_m = reg.counter(
            "serving_draft_proposed_total",
            "speculative tokens proposed by the draft", ["model"],
        )
        self._draft_accepted_m = reg.counter(
            "serving_draft_accepted_total",
            "speculative tokens accepted by the verify step", ["model"],
        )
        self._verify_steps_m = reg.counter(
            "serving_verify_steps_total", "speculative verify iterations",
            ["model"],
        )
        self._accept_rate_h = reg.histogram(
            "serving_accept_rate",
            "accepted / proposed drafted tokens per verify iteration",
            ["model"], buckets=tuple(i / 10 for i in range(11)),
        )
        self._phase = serving_phase_histogram()
        self._recoveries = serving_engine_recoveries_counter()
        self._first_page_keys_g = reg.gauge(
            "serving_first_page_keys",
            "distinct first-page affinity keys admitted (capped)", ["model"],
        )
        self._drain_h = reg.histogram(
            "serving_drain_seconds", "drain() start to idle or deadline",
            ["model"],
        )
        self._pages_total_g = reg.gauge(
            "serving_kv_pages_total", "configured KV pool page capacity",
            ["model"],
        )
        self._prefix_hits_m = reg.counter(
            "serving_prefix_cache_hit_tokens_total",
            "prompt tokens mapped copy-free from the prefix cache", ["model"],
        )
        self._prefix_lookups_m = reg.counter(
            "serving_prefix_cache_lookups_total",
            "prefix-cache lookups at admission", ["model"],
        )
        self._spill_pages_m = serving_kv_spill_pages_counter()
        self._spill_hits_m = serving_kv_spill_hits_counter()
        self._persisted_chains_g = serving_kv_persisted_chains_gauge()
        self._handoff_pages_m = serving_kv_handoff_pages_counter()
        self._handoff_ms_m = serving_kv_handoff_ms_counter()
        # MoE router evidence (MoE targets only): cumulative routed
        # positions an expert, capacity drops, and their series
        self._moe = self.programs.moe
        self._moe_tokens_np: Optional[np.ndarray] = None
        self._moe_dropped = 0.0
        if self._moe:
            self._moe_tokens_np = np.zeros((cfg.num_experts,), np.float64)
            self._moe_expert_tokens_m = serving_moe_expert_tokens_counter()
            self._moe_overflow_m = serving_moe_capacity_overflow_counter()
            self._moe_imbalance_g = serving_moe_load_imbalance_gauge()
            self._moe_imbalance_g.set(0.0, model=name)
        self._queue_depth_g.set(0, model=name)
        self._occupancy_g.set(0.0, model=name)
        self._pages_in_use_g.set(0, model=name)
        self._pages_total_g.set(self.num_pages, model=name)
        serving_kv_pool_bytes_per_chip_gauge().set(
            self.kv_pool_bytes_per_chip, model=name)
        self._persisted_chains_g.set(0, model=name)
        self._first_page_keys_g.set(0, model=name)

        # warm restart: the persisted hot chains land in the pool and the
        # radix index BEFORE the scheduler starts, so the first request
        # already sees them as prefix hits
        if self._persist_store is not None:
            self._preload_persisted()

        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"decode-engine-{name}"
        )
        if autostart:
            self._thread.start()

    # -- public API --------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        return bucket_for(prompt_len, self.prefill_buckets)

    def _make_request(self, prompt_ids, max_new_tokens, temperature, top_k,
                      top_p, eos_id, seed, trace_id=None) -> _Request:
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        vocab = self.model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + n > self.model.cfg.max_len:
            raise EngineCapacityError(
                f"prompt {prompt.size} + {n} new tokens exceeds "
                f"max_len {self.model.cfg.max_len}"
            )
        temperature = float(temperature)
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        top_k = int(top_k)
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        top_p = float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if eos_id is not None:
            eos_id = int(eos_id)
            if not 0 <= eos_id < vocab:
                raise ValueError(f"eos_id must be in [0, {vocab})")
        if trace_id is None and self._tracer.enabled:
            trace_id = self._tracer.new_trace_id("req")
        return _Request(prompt, n, temperature, top_k, top_p, eos_id,
                        int(seed), trace_id=trace_id,
                        parent_span_id=self._tracer.current_parent_span_id())

    def _enqueue(self, reqs: List[_Request]) -> None:
        with self._cv:
            # draining outranks closed: drain() ends in close(), and a
            # drained engine keeps answering 429 + Retry-After (retry
            # another replica) until the server stops
            if self._draining:
                raise EngineDrainingError(
                    f"engine {self.name} is draining for shutdown; "
                    f"retry against another replica"
                )
            if self._failed is not None:
                raise RuntimeError(f"engine {self.name} failed: "
                                   f"{self._failed.__cause__!r}")
            if self._stop:
                raise RuntimeError("engine is closed")
            if len(self._queue) + len(reqs) > self.max_queue:
                raise QueueFullError(
                    f"admission queue full ({len(self._queue)} waiting, "
                    f"capacity {self.max_queue})"
                )
            for req in reqs:
                # cross-thread span: starts on the submitter's thread, ends
                # when the scheduler pops the request for admission
                req.queue_span = self._tracer.start_span(
                    "request.queue_wait", trace_id=req.trace_id,
                    parent_span_id=req.parent_span_id,
                    model=self.name, prompt_len=int(req.prompt.size),
                )
            self._queue.extend(reqs)
            self._queue_depth_g.set(len(self._queue), model=self.name)
            self._cv.notify_all()
        with self._stats_lock:
            for req in reqs:
                if len(self._first_page_keys) < FIRST_PAGE_KEYS_CAP:
                    self._first_page_keys.add(
                        first_page_key(req.prompt, self.page_size)
                    )
            keys = len(self._first_page_keys)
        self._first_page_keys_g.set(keys, model=self.name)

    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: Optional[int] = None, seed: int = 0,
               trace_id: Optional[str] = None) -> Completion:
        """Enqueue one UNPADDED prompt row; returns the request future
        (completes with {"tokens", "ttft_s"}). Raises QueueFullError when
        the admission queue is at max_queue. `trace_id` tags the
        request's spans (the server passes its X-Request-Id); one is
        minted when absent and tracing is on."""
        req = self._make_request(prompt_ids, max_new_tokens, temperature,
                                 top_k, top_p, eos_id, seed,
                                 trace_id=trace_id)
        self._enqueue([req])
        return req.future

    def submit_batch(self, rows, max_new_tokens: int, *,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, eos_id: Optional[int] = None,
                     seed: int = 0,
                     trace_id: Optional[str] = None) -> List[Completion]:
        """Atomic multi-row admission: every row enters the queue, or
        none does. Row i's sampling stream is seeded `seed + i`, and its
        spans carry `<trace_id>/<i>` (one REST request's rows)."""
        reqs = [
            self._make_request(
                row, max_new_tokens, temperature, top_k, top_p, eos_id,
                int(seed) + i,
                trace_id=None if trace_id is None else f"{trace_id}/{i}",
            )
            for i, row in enumerate(rows)
        ]
        if not reqs:
            raise ValueError("submit_batch needs at least one row")
        self._enqueue(reqs)
        return [r.future for r in reqs]

    def generate_row(self, prompt_ids, max_new_tokens: int,
                     timeout: Optional[float] = 300.0, **kw) -> dict:
        """Blocking submit: {"tokens": [...], "ttft_s": float}."""
        return self.submit(prompt_ids, max_new_tokens, **kw).wait(timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            steps = self._steps
            seen = self._prefix_hit_tokens + self._prefill_compute_tokens
            return {
                "admitted": self._admitted,
                "decode_steps": steps,
                "decode_step_ms": (
                    1e3 * self._step_seconds / steps if steps else 0.0
                ),
                "tokens": self._emitted,
                "mean_occupancy": (
                    self._occupied_slot_steps / (steps * self.num_slots)
                    if steps else 0.0
                ),
                # speculation (0 at K = 0): a drafted engine's decode
                # steps are its verify iterations
                "draft_proposed": self._drafted,
                "draft_accepted": self._accepted,
                "verify_steps": self._verifies,
                "accept_rate": (
                    self._accepted / self._drafted if self._drafted else 0.0
                ),
                "prefix_lookups": self._prefix_lookups,
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "prefix_cache_hit_rate": (
                    self._prefix_hit_tokens / seen if seen else 0.0
                ),
                # distinct first-page affinity keys admitted (capped)
                "first_page_hashes": len(self._first_page_keys),
                "cow_copies": self._cow_copies,
                "prefill_compute_tokens": self._prefill_compute_tokens,
                "pages_allocated": self._pages_allocated,
                "rewind_pages_returned": self._rewind_pages_returned,
                # KV tiers (serving/kv_tiers.py): pages parked in host RAM
                # at eviction, pages re-admitted from there, the pages of
                # the last persisted (or preloaded) generation, and the
                # wall seconds of the last persist and of the preload
                "kv_spill_pages": self._spill_pages,
                "kv_spill_hits": self._spill_hits,
                "kv_host_tier": (
                    self._host_tier.stats()
                    if self._host_tier is not None else None
                ),
                "kv_persisted_chains": self._persisted_chains,
                "kv_persist_seconds": self._persist_seconds,
                "kv_preload_seconds": self._preload_seconds,
                "pages_in_use": self._pagepool.in_use,
                # pages the prefix index holds: an idle engine's
                # pages_in_use, when no page leaked
                "prefix_index_pages": self._pagepool.tree_pages,
                "pages_total": self.num_pages,
                # which read path is live: "gather" or "kernel" (the CUDA
                # page walk on a CUDA engine)
                "attention_kernel": self.paged_attention,
                # every window size (query rows per pool walk) dispatched,
                # and the read path that served it
                "paged_attention_windows": dict(
                    sorted(self._attn_windows.items())
                ),
                "quantize": self.quantize,
                "kv_pool_dtype": str(self._pool.k.dtype).replace(
                    "torch.", ""
                ),
                "kv_pool_bytes": self.kv_pool_bytes,
                # the serving mesh the programs run on, and what one rank
                # holds of the pools and the weights
                "mesh_tensor": self.mesh_tensor,
                "mesh_fsdp": self.mesh_fsdp,
                "mesh_expert": self.mesh_expert,
                "kv_pool_bytes_per_chip": self.kv_pool_bytes_per_chip,
                "weight_bytes_per_chip": self.weight_bytes_per_chip,
                "device": str(self.device),
                # MoE router evidence (None on dense engines): cumulative
                # routed positions an expert, capacity drops, and the
                # max/mean occupancy imbalance (1.0 = balanced)
                "moe": self._moe_snapshot(),
            }

    def _moe_snapshot(self) -> Optional[dict]:
        """Caller holds _stats_lock (stats() does)."""
        if not self._moe:
            return None
        tokens = self._moe_tokens_np
        mean = float(tokens.mean())
        return {
            "expert_tokens": [float(v) for v in tokens],
            "routed_positions": float(tokens.sum()),
            "dropped": float(self._moe_dropped),
            "load_imbalance": (float(tokens.max()) / mean if mean > 0.0
                               else 0.0),
        }

    def _note_moe(self, entries) -> None:
        """Fold host-read (expert_tokens [E], dropped) pairs, read in the
        copy of the tokens they came with, into the cumulative counters
        and the exported series."""
        if not entries:
            return
        with self._stats_lock:
            for tokens_e, dropped in entries:
                arr = np.asarray(tokens_e, np.float64).reshape(-1)
                self._moe_tokens_np += arr
                d = float(dropped)
                self._moe_dropped += d
                for ei in range(arr.shape[0]):
                    if arr[ei]:
                        self._moe_expert_tokens_m.inc(
                            float(arr[ei]), model=self.name, expert=str(ei))
                if d:
                    self._moe_overflow_m.inc(d, model=self.name)
            mean = float(self._moe_tokens_np.mean())
            imbalance = (float(self._moe_tokens_np.max()) / mean
                         if mean > 0.0 else 0.0)
        self._moe_imbalance_g.set(imbalance, model=self.name)

    def debug_state(self) -> dict:
        """The /statusz snapshot: the slot map (with page footprints),
        pool and prefix-cache occupancy, queue depth, the recent finished
        requests' phase breakdowns and `stats()`. Slot reads are
        lock-free snapshots of scheduler-owned state (a torn view across
        slots is acceptable for a status page; no device state is read).
        `mesh` is the serving mesh the programs run on (1 × 1 × 1 on one
        card) and `kv_pool_bytes_per_chip` what one rank holds of the
        pools."""
        slots = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                slots.append(None)
                continue
            slots.append({
                "slot": i,
                "trace_id": slot.req.trace_id or "-",
                "prompt_len": int(slot.req.prompt.size),
                "tokens": len(slot.tokens),
                "max_new": slot.req.max_new,
                "pages": len(self._slot_pages[i]),
                "shared_pages": int(self._slot_shared[i]),
            })
        with self._cv:
            depth = len(self._queue)
        with self._stats_lock:
            recent = list(self._recent)
        return {
            "name": self.name,
            "num_slots": self.num_slots,
            "queue_depth": depth,
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_in_use": self._pagepool.in_use,
            "attention_kernel": self.paged_attention,
            "quantize": self.quantize,
            "kv_pool_bytes": self.kv_pool_bytes,
            "mesh": {"tensor": self.mesh_tensor, "fsdp": self.mesh_fsdp,
                     "expert": self.mesh_expert},
            "kv_pool_bytes_per_chip": self.kv_pool_bytes_per_chip,
            "prefix_cache": self.prefix_cache_enabled,
            "prefix_nodes": self._radix.nodes if self._radix else 0,
            "kv_host_tier": (
                self._host_tier.stats()
                if self._host_tier is not None else None
            ),
            "kv_persist_dir": self.kv_persist_dir,
            "slots": slots,
            "recent": recent,
            "stats": self.stats(),
        }

    @property
    def draining(self) -> bool:
        """True once drain() flipped the admission gate (new submits get
        429 + Retry-After): the /healthz "draining, not dead" signal."""
        with self._cv:
            return self._draining

    @property
    def failed(self) -> Optional[BaseException]:
        """The error that ended a serving mesh's engine (`_fail_mesh`),
        else None: /healthz answers 503, and the serving entry point
        exits, ending the gang."""
        with self._cv:
            return self._failed

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Draining shutdown: refuse new submits (EngineDrainingError),
        let every already accepted request, queued and resident, run to
        completion, then close. Requests still live at `deadline_s` are
        failed fast by close(): a drain can time out, it never strands a
        caller. Returns True when everything finished in time."""
        t0 = time.monotonic()
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        deadline = t0 + max(0.0, float(deadline_s))
        drained = False
        while True:
            with self._cv:
                idle = (not self._queue and self._admitting == 0
                        and all(s is None for s in self._slots))
            if idle:
                drained = True
                break
            if time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        self._drain_h.observe(time.monotonic() - t0, model=self.name)
        if not drained:
            log.warning("engine %s drain deadline (%.1fs) expired; failing "
                        "the remaining requests fast", self.name, deadline_s)
        self.close()
        return drained

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=30)
        # the scheduler is down (or never started): fail whatever is still
        # queued or resident so no caller blocks forever
        err = RuntimeError("engine closed")
        with self._cv:
            leftover = list(self._queue)
            self._queue.clear()
        for req in leftover:
            req.future.fail(err)
        if self._thread.is_alive():
            log.warning("engine %s scheduler still running after close "
                        "timeout; leaving slot state to it", self.name)
            return
        # a control job queued after the scheduler's last drain runs here,
        # so its caller never waits out the job timeout
        with torch.inference_mode():
            self._drain_control()
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                slot.req.future.fail(err)
        self._occupancy_g.set(0.0, model=self.name)
        # a serving mesh's workers end with the scheduler (once)
        self.programs.close()

    # -- page accounting (scheduler thread only) ---------------------------

    def _reserve_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages one request can ever hold: its prompt (plus
        the last chunk window's pad spill) and every token it may decode,
        with the verify window's K overhang, capped at the logical
        window."""
        tokens = min(
            prompt_len + max(max_new + self.num_draft_tokens,
                             self.programs.chunk_len),
            self.model.cfg.max_len,
        )
        return -(-tokens // self.page_size)

    def _outstanding_pages(self) -> int:
        out = 0
        for i, s in enumerate(self._slots):
            if s is not None:
                out += max(
                    0, int(self._slot_reserve[i]) - len(self._slot_pages[i])
                )
        return out

    def _can_admit(self, req: _Request) -> bool:
        """The reservation gate (assumes no prefix hit — a hit only ever
        needs fewer fresh pages)."""
        need = self._reserve_pages(int(req.prompt.size), req.max_new)
        avail = self._pagepool.free_count - self._outstanding_pages()
        if self._radix is not None:
            avail += self._radix.evictable_pages()
        return avail >= need

    def _alloc_pages(self, n: int) -> List[int]:
        short = n - self._pagepool.free_count
        if short > 0 and self._radix is not None:
            self._radix.evict(short)
            # the victims' contents reach the host tier before any page
            # is handed out, so no write can race their copy
            self._flush_spills()
        pages = self._pagepool.alloc(n)
        if pages is None:
            # unreachable behind the admission gate
            raise RuntimeError(
                f"engine {self.name}: KV page pool exhausted "
                f"({self._pagepool.free_count} free of {self.num_pages})"
            )
        with self._stats_lock:
            self._pages_allocated += n
        return pages

    def _ensure_pages(self, i: int, upto_tokens: int) -> None:
        """Map enough pages onto slot i's table to cover logical positions
        [0, upto_tokens), capped at max_pages."""
        need = min(-(-upto_tokens // self.page_size), self._max_pages)
        pages = self._slot_pages[i]
        if len(pages) >= need:
            return
        for pg in self._alloc_pages(need - len(pages)):
            self._pt_np[i, len(pages)] = pg
            pages.append(pg)

    def _free_tail_pages(self, i: int) -> int:
        """Return slot i's pages past its resident ceiling to the pool
        (the rewind's page give-back: a rejected verify tail may have
        claimed a page the rewound cursor no longer reaches); a prefix
        page the slot shares is never freed. Returns the pages freed."""
        keep = max(-(-int(self._cur_np[i]) // self.page_size),
                   int(self._slot_shared[i]))
        pages = self._slot_pages[i]
        freed = 0
        while len(pages) > keep:
            freed += self._pagepool.release([pages.pop()])
        return freed

    def _release_slot_pages(self, i: int) -> None:
        pages = self._slot_pages[i]
        if pages:
            self._pagepool.release(pages)
        self._slot_pages[i] = []
        self._slot_shared[i] = 0
        self._slot_reserve[i] = 0
        self._cur_np[i] = self.model.cfg.max_len
        self._pt_np[i, :] = 0
        self._pages_in_use_g.set(self._pagepool.in_use, model=self.name)

    # -- scheduler ---------------------------------------------------------

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        out = host.to(self.device)
        if self.mesh is not None and out is not host:
            # the relay sends the host copy it came from (no copy back)
            out.relay_host = host
        return out

    def _note_attn(self, window: int) -> None:
        """Record one pool-reading dispatch at `window` query rows."""
        self._attn_calls_m.inc(model=self.name, variant=self.paged_attention)
        with self._stats_lock:
            self._attn_windows.setdefault(window, self.paged_attention)

    def _prefix_lookup(self, slot_idx: int, prompt: np.ndarray) -> int:
        """Map the prompt's committed prefix onto slot `slot_idx`: full
        pages copy-free, chunks parked in the host tier that continue the
        radix match by upload, the partially matched boundary page by a
        copy-on-write (from the host tier: by an upload, which is a
        private copy already). Returns the matched token count (0 =
        miss)."""
        ps = self.page_size
        p = int(prompt.size)
        with self._stats_lock:
            self._prefix_lookups += 1
        self._prefix_lookups_m.inc(model=self.name)
        chain, full_m, partial = self._radix.match(prompt)
        # host-tier probe: parked chunks that CONTINUE the radix match
        # (`in` leaves the LRU order alone; the entries are pulled after
        # the hit threshold's verdict)
        tier_pages = 0
        if self._host_tier is not None and len(self._host_tier):
            while (full_m + (tier_pages + 1) * ps <= p
                   and _prefix_key(prompt, full_m + (tier_pages + 1) * ps)
                   in self._host_tier):
                tier_pages += 1
        # never map the WHOLE prompt: the last real token must run through
        # a chunk window to produce the first-token logits. Tier chunks
        # reach past the radix frontier, so they supersede its partial.
        if tier_pages:
            m = min(full_m + tier_pages * ps, p - 1)
        else:
            m = min(full_m + (partial[1] if partial is not None else 0),
                    p - 1)
        largest = self.prefill_buckets[-1]
        if not (m * 2 >= p or (p > largest and m >= largest)):
            # a small hit is slower than a miss: it routes the whole tail
            # through chunk windows. Keep it only when it covers half the
            # prompt, or past the largest bucket the head prefill.
            return 0
        q, r = divmod(m, ps)
        n_radix = min(q, len(chain))
        # pull the host copies NOW, before a page alloc below can evict,
        # spill and rotate the tier under the probe: full chunks leave
        # the tier (the radix insert below commits them on the card
        # again); the boundary chunk is peeked, since its upload is a
        # private copy and the parked entry stays shared
        tier_entries: List[PageEntry] = []
        boundary = None
        if tier_pages:
            tier_entries = [
                self._host_tier.take(_prefix_key(prompt, (c + 1) * ps))
                for c in range(n_radix, q)
            ]
            if r > 0:
                shared = self._host_tier.get(_prefix_key(prompt,
                                                         (q + 1) * ps))
                # a copy: the allocs below may evict the parked entry
                # and hand its arena slot to a victim
                boundary = PageEntry(
                    _copied(shared.target),
                    None if shared.draft is None else _copied(shared.draft),
                )
        pages: List[int] = []
        for pg in chain[:n_radix]:
            self._pagepool.retain([pg])
            self._pt_np[slot_idx, len(pages)] = pg
            pages.append(pg)
        self._slot_pages[slot_idx] = pages
        if tier_entries:
            dsts = self._alloc_pages(len(tier_entries))
            self._upload_entries(tier_entries, dsts)
            # taken pages left the tier: their slots are free once copied
            for entry in tier_entries:
                self._host_arena.release(entry.slot)
            for dst in dsts:
                self._pt_np[slot_idx, len(pages)] = dst
                pages.append(dst)
            # commit the promoted chunks: radix chunks keep their page,
            # uploaded ones adopt theirs, and the next admission of this
            # prefix matches on the card
            self._radix.insert(prompt[: q * ps], pages[:q])
        self._slot_shared[slot_idx] = q
        tier_hits = len(tier_entries)
        if r > 0:
            # this slot writes into the boundary page's tail, so it gets
            # its own copy; the donor page stays untouched
            dst = self._alloc_pages(1)[0]
            if boundary is not None:
                self._upload_entries([boundary], [dst])
                tier_hits += 1
            else:
                src = chain[q] if q < len(chain) else partial[0]
                self.programs.cow(self._pool, src, dst)
                if self._draft_pool is not None:
                    # the donor page's draft K/V was written with its chain
                    self.programs.cow(self._draft_pool, src, dst)
                with self._stats_lock:
                    self._cow_copies += 1
            self._pt_np[slot_idx, len(pages)] = dst
            pages.append(dst)
        if tier_hits:
            self._spill_hits_m.inc(tier_hits, model=self.name)
        self._prefix_hits_m.inc(m, model=self.name)
        with self._stats_lock:
            self._prefix_hit_tokens += m
            self._spill_hits += tier_hits
        return m

    # -- KV tiers (serving/kv_tiers.py; scheduler thread only) -------------

    def _spill_page(self, key, page: int, hits: int) -> None:
        """Radix eviction's spill hook: the tree is about to drop the LAST
        reference to `page`. Note it; `_flush_spills` parks the contents
        of every victim of the eviction in the host tier (target and, at
        K > 0, draft pools; int8 values with their scales), keyed by the
        prefix each committed, in the hook's order."""
        self._pending_spills.append((key, page, hits))

    def _flush_spills(self) -> None:
        """Copy the pending victims' pages into host-arena slots (one
        gather a pool tensor) and park them in the host tier, in the
        hook's order. The copy is complete when this returns, so the
        pages' next writers cannot race it."""
        pending, self._pending_spills = self._pending_spills, []
        if not pending:
            return
        # a batch larger than the whole tier keeps its last victims: the
        # puts of the later ones would evict the earlier ones again
        pending = pending[-self._host_capacity:]
        # the room the puts need, made first, so the slots are free before
        # the copy: a key parked already is replaced, the rest evict the
        # least recently used entries, as the puts would
        for key, _, _ in pending:
            self._host_tier.discard(key)
        self._host_tier.make_room(len(pending) * self._host_page_bytes)
        slots = self._host_arena.alloc(len(pending))
        trees = [self._host_arena.pages(slot) for slot in slots]
        pages = [page for _, page, _ in pending]
        self.programs.spill(self._pool, pages, out=[t for t, _ in trees])
        if self._draft_pool is not None:
            self.programs.spill(self._draft_pool, pages,
                                out=[d for _, d in trees])
        parked = 0
        for (key, _, hits), slot, (target, draft) in zip(pending, slots,
                                                         trees):
            parked += self._host_tier.put(
                key, PageEntry(target, draft, hits=hits, slot=slot))
        if parked:
            with self._stats_lock:
                self._spill_pages += parked
            self._spill_pages_m.inc(parked, model=self.name)

    def _upload_entries(self, entries: Sequence[PageEntry],
                        dsts: Sequence[int]) -> None:
        """Write host-tier pages onto pool pages `dsts`, one batched copy
        a pool tensor: target and (K > 0) draft pools in lockstep, like
        every other write path."""
        self.programs.upload(self._pool, [e.target for e in entries], dsts)
        if self._draft_pool is not None:
            self.programs.upload(self._draft_pool,
                                 [e.draft for e in entries], dsts)

    def _page_template(self, pool: KVPool) -> Dict[str, torch.Tensor]:
        """One whole page of `pool`, shapes and dtypes only (meta
        tensors): what a stored or shipped page must rebuild against."""
        return self.programs.page_template(pool)

    def _page_leaves(self, page) -> Dict[str, torch.Tensor]:
        """A port page as the JAX pool's leaves in this engine's layout:
        the form the store and the wire carry."""
        return page_to_flat(page, self.kv_layout)

    def _export_entries(self, nodes) -> list:
        """Committed pages out of the pool(s), (key, page, hits) each, as
        (tokens, target, draft, hits) entries of JAX page leaves: the
        spill's batched device→host copy, so a page re-uploads with the
        same bits."""
        pages = [page for _, page, _ in nodes]
        if not pages:
            return []
        targets = self.programs.spill(self._pool, pages)
        drafts = (self.programs.spill(self._draft_pool, pages)
                  if self._draft_pool is not None else [None] * len(pages))
        return [(key, self._page_leaves(target),
                 None if draft is None else self._page_leaves(draft), hits)
                for (key, _, hits), target, draft
                in zip(nodes, targets, drafts)]

    def _decode_entries(self, entries) -> List[Tuple[tuple, dict, Optional[dict], int]]:
        """Rebuild stored or shipped entries (decode_page_entries /
        PersistentPrefixStore.load output) as port pages against this
        engine's pools: (tokens, target, draft or None, hits). Raises
        KeyError/ValueError on any leaf of any entry that does not fit,
        before anything touches the pool. An entry without draft leaves
        gets draft None (a drafted engine skips it)."""
        template = self._page_template(self._pool)
        dtemplate = (self._page_template(self._draft_pool)
                     if self._draft_pool is not None else None)
        out = []
        for ent in entries:
            target = page_from_flat(template, ent["target"])
            draft = (page_from_flat(dtemplate, ent["draft"])
                     if dtemplate is not None and ent["draft"] is not None
                     else None)
            out.append((tuple(int(t) for t in ent["tokens"]), target, draft,
                        int(ent["hits"])))
        return out

    def _admit_entries(self, entries) -> int:
        """Admit decoded entries (parents first) into the pool and the
        radix index as committed, evictable chains: each page lands
        tree-only (refcount 1) and frees under eviction like any other.
        A chain whose parent is neither in `entries` nor committed here
        is an orphan and skipped; one already committed keeps its page
        and merges the heat; a drafted engine skips entries without
        draft pages; admission stops while one full request's pages
        could not be free (the first admissions never queue behind it).
        Returns the pages admitted."""
        ps = self.page_size
        admitted = 0
        path_pages: Dict[tuple, List[int]] = {(): []}
        for tokens, target, draft, hits in entries:
            if len(tokens) < ps or len(tokens) % ps:
                continue
            parent_chain = path_pages.get(tokens[:-ps])
            if parent_chain is None:
                nodes = self._radix_walk(tokens[:-ps])
                if nodes is None:
                    continue
                parent_chain = [n.page for n in nodes]
            here = self._radix_walk(tokens)
            if here is not None:
                here[-1].hits = max(here[-1].hits, hits)
                path_pages[tokens] = parent_chain + [here[-1].page]
                continue
            if self._draft_pool is not None and draft is None:
                continue  # the sender ran no draft model: unusable here
            if self._pagepool.free_count <= self._max_pages:
                break
            pg = self._alloc_pages(1)[0]
            self._upload_entries([PageEntry(target, draft)], [pg])
            chain = parent_chain + [pg]
            self._radix.insert(np.asarray(tokens, np.int64), chain)
            # drop the alloc's reference: the tree's keeps the page
            self._pagepool.release([pg])
            self._radix_walk(tokens)[-1].hits = hits
            path_pages[tokens] = chain
            admitted += 1
        self._pages_in_use_g.set(self._pagepool.in_use, model=self.name)
        return admitted

    def _radix_walk(self, tokens):
        """The node chain committing the page-aligned `tokens`, or None
        where it breaks, without touching hits or recency (an export or
        an import is not traffic)."""
        ps = self.page_size
        node = self._radix.root
        chain = []
        for i in range(0, len(tokens), ps):
            node = node.children.get(tuple(int(t) for t in tokens[i : i + ps]))
            if node is None:
                return None
            chain.append(node)
        return chain

    def _preload_persisted(self) -> None:
        """Warm restart: load the persisted hot chains into the pool and
        the radix index before the scheduler takes traffic. ANY defect
        (a torn store, another shape, a failed upload) gives a cold
        start, never a crash loop."""
        t0 = time.monotonic()
        entries = self._persist_store.load(self.page_size, self.quantize)
        loaded = 0
        if entries:
            try:
                loaded = self._admit_entries(self._decode_entries(entries))
            except Exception:  # cold start beats a crash loop
                log.exception("engine %s: persisted prefix preload failed; "
                              "starting cold", self.name)
                self._pagepool.reset()
                self._radix.reset()
                self._pages_in_use_g.set(0, model=self.name)
                loaded = 0
            if loaded:
                log.info("engine %s: preloaded %d persisted prefix page(s)",
                         self.name, loaded)
        with self._stats_lock:
            self._persisted_chains = loaded
            self._preload_seconds = time.monotonic() - t0
        self._persisted_chains_g.set(loaded, model=self.name)

    def _maybe_persist(self, final: bool = False) -> None:
        """Persist the hottest committed chains (by hits) to the two-phase
        store: every `kv_persist_interval_s`, or now when `final` (the
        scheduler's stop). A failed persist (disk full, permissions) logs
        and keeps serving: persistence is an optimization, never a
        liveness dependency."""
        if self._persist_store is None:
            return
        now = time.monotonic()
        if not final and (self.kv_persist_interval_s <= 0 or
                          now - self._last_persist < self.kv_persist_interval_s):
            return
        self._last_persist = now
        chains = self._radix.hot_chains(self.kv_persist_chains)
        if not chains:
            return
        try:
            entries = self._export_entries(chains)
            self._persist_store.persist(entries, self.page_size,
                                        self.quantize, model=self.name)
        except Exception:  # persistence is best-effort
            log.exception("engine %s: prefix-store persist failed; "
                          "continuing without a fresh snapshot", self.name)
            return
        with self._stats_lock:
            self._persisted_chains = len(entries)
            self._persist_seconds = time.monotonic() - now
        self._persisted_chains_g.set(len(entries), model=self.name)

    # -- page handoff between replicas --------------------------------------
    # A prefill replica exports a prompt's committed chain to the
    # request's decode home; a draining replica exports its hottest
    # chains to each key's new home. Both run ON the scheduler thread
    # (_run_on_scheduler): export reads the pool, import writes it and
    # the radix index, all scheduler-owned.

    def _run_on_scheduler(self, fn, timeout_s: float = 600.0):
        """Run `fn` on the scheduler thread between iterations and return
        its result (or raise its exception). Runs inline when the
        scheduler is not running (autostart=False, after close)."""
        if not self._thread.is_alive():
            with torch.inference_mode():
                return fn()
        job = {"fn": fn, "done": threading.Event(), "result": None,
               "error": None}
        with self._cv:
            self._control.append(job)
            self._cv.notify_all()
        if not job["done"].wait(timeout_s):
            raise TimeoutError(f"engine {self.name}: scheduler control job "
                               f"did not complete within {timeout_s}s")
        if job["error"] is not None:
            raise job["error"]
        return job["result"]

    def _drain_control(self) -> None:
        """Run every pending control job (scheduler thread only). A job
        that raises fails its caller, never the loop; the pool is written
        in place and an import checks every entry before it writes, so a
        failed job leaves the pool as it was."""
        while True:
            with self._cv:
                if not self._control:
                    return
                job = self._control.popleft()
            try:
                job["result"] = job["fn"]()
            except Exception as e:  # per job: its caller gets it
                job["error"] = e
            finally:
                job["done"].set()

    def export_prefix_entries(self, prompt_ids) -> list:
        """The committed chain covering `prompt_ids`' full pages as
        (tokens, target, draft, hits) entries of JAX page leaves, parents
        first: the prefill replica's side of the handoff
        (`encode_page_entries` ships them). Empty when nothing is
        committed."""
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)

        def job():
            if self._radix is None:
                return []
            ps = self.page_size
            nodes = []
            node = self._radix.root
            for i in range(0, (prompt.size // ps) * ps, ps):
                node = node.children.get(_prefix_key(prompt[i:], ps))
                if node is None:
                    break
                nodes.append((_prefix_key(prompt, i + ps), node.page,
                              node.hits))
            return self._export_entries(nodes)

        return self._run_on_scheduler(job)

    def export_hot_entries(self, limit: int) -> list:
        """The hottest committed chains (by hits), the pool's first, then
        the host tier's, as (tokens, target, draft, hits) entries of JAX
        page leaves: what a draining replica ships to each key's new
        rendezvous home."""
        limit = int(limit)

        def job():
            out = []
            seen = set()
            if self._radix is not None:
                chains = self._radix.hot_chains(limit)
                out = self._export_entries(chains)
                seen = {key for key, _, _ in chains}
            if self._host_tier is not None:
                for key in self._host_tier.keys():
                    if len(out) >= limit or key in seen:
                        continue
                    ent = self._host_tier.get(key)
                    if ent is not None:
                        # copies: the arena slot is reused once this job
                        # returns
                        out.append((
                            key, self._page_leaves(_copied(ent.target)),
                            None if ent.draft is None
                            else self._page_leaves(_copied(ent.draft)),
                            ent.hits,
                        ))
            return out[:limit]

        return self._run_on_scheduler(job)

    def import_page_entries(self, entries) -> int:
        """Admit decoded wire entries (`decode_page_entries` output) into
        the pool and the radix index as committed, evictable chains: the
        decode replica's side of the handoff. Orphans and duplicates are
        skipped (a duplicate merges its heat) and pool headroom stops it
        early, as the preload does; an entry whose leaves do not fit the
        pools raises ValueError (the server answers 400) before any page
        is written. Returns the pages admitted."""
        return self._run_on_scheduler(lambda: self._import_entries(entries))

    def _import_entries(self, entries) -> int:
        if self._radix is None:
            raise RuntimeError(f"engine {self.name} has prefix_cache "
                               "disabled; handed-off pages have nowhere to "
                               "land")
        t0 = time.monotonic()
        try:
            decoded = self._decode_entries(entries)
        except KeyError as e:
            raise ValueError(f"missing page leaf {e}") from e
        admitted = self._admit_entries(decoded)
        if admitted:
            self._handoff_pages_m.inc(admitted, model=self.name,
                                      direction="in")
        self._handoff_ms_m.inc((time.monotonic() - t0) * 1e3,
                               model=self.name, direction="in")
        return admitted

    def _admit(self, slot_idx: int, req: _Request) -> None:
        # the queue phase ends the moment the scheduler owns the request
        t_admit = time.monotonic()
        if req.queue_span is not None:
            req.queue_span.end(slot=slot_idx)
            req.queue_span = None
        # chaos seam: a device failure during THIS request's admission,
        # failed per request by _iterate; after the queue span's end, so
        # an injected fault never loses the request's queue phase
        self._chaos.maybe_fail("engine.prefill")
        prompt = req.prompt
        p = int(prompt.size)
        prefill_span = self._tracer.start_span(
            "request.prefill", trace_id=req.trace_id,
            parent_span_id=req.parent_span_id, model=self.name,
            slot=slot_idx, prompt_len=p,
        )
        self._slot_reserve[slot_idx] = self._reserve_pages(p, req.max_new)
        matched = (
            self._prefix_lookup(slot_idx, prompt)
            if self._radix is not None else 0
        )
        self._cur_np[slot_idx] = matched
        knobs = (req.seed, req.temperature, req.top_k, req.top_p)
        largest = self.prefill_buckets[-1]
        computed = 0
        first_tok = None
        # an MoE target's (expert_tokens, dropped) pairs, read with the
        # first token in its one host copy
        moe_acc = []
        if matched == 0 and p <= largest:
            # fresh short prompt: one bucketed batch-1 prefill, copied into
            # this slot's pages at the prompt's REAL length
            bucket = self.bucket_for(p)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :p] = prompt
            mask = np.zeros((1, bucket), bool)
            mask[0, :p] = True
            ids, mask = self._to_dev(ids), self._to_dev(mask)
            cache_one, first_tok, *ms = self.programs.prefill(ids, mask,
                                                              *knobs)
            moe_acc += ms
            self._ensure_pages(slot_idx, p)
            self.programs.insert(
                self._pool, cache_one, self._slot_pages[slot_idx], p
            )
            if self._draft_pool is not None:
                self.programs.insert(
                    self._draft_pool, self.programs.draft_prefill(ids, mask),
                    self._slot_pages[slot_idx], p,
                )
            computed = p
        else:
            pos = matched
            if matched == 0:
                # long fresh prompt: the head rides ONE largest-bucket
                # prefill, the rest chunk-prefills below
                ids = self._to_dev(prompt[:largest][None])
                mask = self._to_dev(np.ones((1, largest), bool))
                cache_one, _, *ms = self.programs.prefill(ids, mask, *knobs)
                moe_acc += ms
                self._ensure_pages(slot_idx, largest)
                self.programs.insert(
                    self._pool, cache_one, self._slot_pages[slot_idx],
                    largest,
                )
                if self._draft_pool is not None:
                    self.programs.insert(
                        self._draft_pool,
                        self.programs.draft_prefill(ids, mask),
                        self._slot_pages[slot_idx], largest,
                    )
                pos = computed = largest
            # chunked prefill: page-aligned windows over the paged cache;
            # the tail attends to everything already resident, and window
            # pads past the real tail land on the slot's own pages
            clen = self.programs.chunk_len
            while pos < p:
                nreal = min(clen, p - pos)
                chunk = np.zeros((1, clen), np.int64)
                chunk[0, :nreal] = prompt[pos : pos + nreal]
                self._ensure_pages(slot_idx, pos + clen)
                final = pos + nreal >= p
                chunk = self._to_dev(chunk)
                prow = self._to_dev(self._pt_np[slot_idx][None])
                cur = self._to_dev(np.asarray([pos], np.int32))
                tok = self.programs.chunk(
                    self._pool, chunk, prow, cur,
                    (p - 1) - pos if final else 0, *knobs,
                )
                if self._moe:
                    tok, ms = tok
                    moe_acc.append(ms)
                self._note_attn(clen)
                if self._draft_pool is not None:
                    self.programs.draft_chunk(self._draft_pool, chunk, prow,
                                              cur)
                    self._note_attn(clen)
                if final:
                    first_tok = tok
                computed += nreal
                pos += clen
        self._cur_np[slot_idx] = p
        # the host read of the first token: prefill ends, and TTFT with it
        if moe_acc:
            host = _fetch([first_tok] + [t for pair in moe_acc for t in pair])
            first = int(host[0])
            self._note_moe(list(zip(host[1::2], host[2::2])))
        else:
            first = int(first_tok)
        prefill_span.end()
        slot = _Slot(req)
        slot.tokens.append(first)
        slot.ttft_s = time.monotonic() - req.t_submit
        slot.queue_s = t_admit - req.t_submit
        slot.t_admitted = t_admit
        # the rest of the request's life is its decode phase, ended by
        # _finish (possibly many iterations later)
        slot.decode_span = self._tracer.start_span(
            "request.decode", trace_id=req.trace_id,
            parent_span_id=req.parent_span_id, model=self.name,
            slot=slot_idx,
        )
        self._ttft.observe(slot.ttft_s, model=self.name)
        self._tokens_m.inc(model=self.name)
        self._tok_np[slot_idx] = slot.tokens[0]
        self._seed_np[slot_idx] = req.seed
        self._cnt_np[slot_idx] = 1  # the admission sample drew counter 0
        self._temp_np[slot_idx] = req.temperature
        self._topk_np[slot_idx] = req.top_k
        self._topp_np[slot_idx] = req.top_p
        self._slots[slot_idx] = slot
        with self._stats_lock:
            self._admitted += 1
            self._prefill_compute_tokens += computed
        self._pages_in_use_g.set(self._pagepool.in_use, model=self.name)

    def _finish(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self._temp_np[slot_idx] = 0.0  # freed slots cost only the argmax
        # commit the retired request's FULL resident pages to the prefix
        # index, then drop this slot's references
        req = slot.req
        pages = self._slot_pages[slot_idx]
        if self._radix is not None and pages:
            fullp = min(int(self._cur_np[slot_idx]) // self.page_size,
                        len(pages))
            if fullp > 0:
                seq = np.concatenate(
                    [req.prompt, np.asarray(slot.tokens[:-1], np.int64)]
                )
                self._radix.insert(
                    seq[: fullp * self.page_size], pages[:fullp]
                )
        self._release_slot_pages(slot_idx)
        # the exact phase decomposition: queue + prefill == TTFT, and
        # queue + prefill + decode == the request's wall time
        prefill_s = slot.ttft_s - slot.queue_s
        decode_s = time.monotonic() - slot.t_admitted - prefill_s
        self._phase.observe(slot.queue_s, model=self.name, phase="queue")
        self._phase.observe(prefill_s, model=self.name, phase="prefill")
        self._phase.observe(decode_s, model=self.name, phase="decode")
        if slot.decode_span is not None:
            slot.decode_span.end(tokens=len(slot.tokens))
            slot.decode_span = None
        self._tracer.event(
            "request.retire", trace_id=req.trace_id,
            parent_span_id=req.parent_span_id, model=self.name,
            slot=slot_idx, tokens=len(slot.tokens),
        )
        with self._stats_lock:
            self._recent.append({
                "trace_id": req.trace_id or "-",
                "queue_s": slot.queue_s,
                "prefill_s": prefill_s,
                "decode_s": decode_s,
                "ttft_s": slot.ttft_s,
                "tokens": len(slot.tokens),
            })
        req.future.set({"tokens": list(slot.tokens), "ttft_s": slot.ttft_s})

    @staticmethod
    def _done(slot: _Slot) -> bool:
        req = slot.req
        if len(slot.tokens) >= req.max_new:
            return True
        return req.eos_id is not None and slot.tokens[-1] == req.eos_id

    def _loop(self) -> None:
        # with the store on an interval, the idle wait is timed, so a
        # quiet engine still takes its periodic snapshot
        wait_s = (min(1.0, self.kv_persist_interval_s)
                  if self._persist_store is not None
                  and self.kv_persist_interval_s > 0 else None)
        if self.mesh is not None:
            # a serving mesh's idle workers are pinged inside the relay's
            # time limit
            wait_s = min(wait_s or HEARTBEAT_S, HEARTBEAT_S)
        # grad mode is thread-local: the scheduler thread sets its own
        with torch.inference_mode():
            while True:
                with self._cv:
                    while (
                        not self._stop and not self._queue
                        and not self._control
                        and not any(s is not None for s in self._slots)
                    ):
                        if not self._cv.wait(timeout=wait_s):
                            break  # the idle persist tick
                    stop = self._stop
                # control jobs run between iterations, and once more on
                # the way out, so a job that raced the stop still runs
                self._drain_control()
                if stop:
                    # the shutdown snapshot: drain() and close() land here
                    # with the radix warm, the set a restart preloads (a
                    # failed mesh's pools cannot be read)
                    if self._failed is None:
                        self._maybe_persist(final=True)
                    return
                try:
                    self._iterate()
                    self.programs.heartbeat()
                except Exception as e:  # the thread must live
                    self._recover(e)
                self._maybe_persist()

    def _recover(self, exc: BaseException) -> None:
        """A decode iteration raised: fail every resident request fast
        (their slot state is gone), reset both K/V pools to zeros (on a
        serving mesh every rank's: the reset is relayed), reset
        the page allocator and the radix prefix index (their page ids
        described pages the failed iteration may have been writing), and
        keep scheduling: queued requests were never admitted and stay
        servable. The host KV tier is kept: its entries are token-keyed
        host copies, independent of any pool page, and re-admit as
        before.

        The pools are zeroed in place (`zero_()`), never allocated again:
        an auto pool is sized to a planned share of the card's memory,
        and a second pool beside the live one could run out of memory
        here. Fresh pools are zeros (int8 scales included), so the state
        is a fresh engine's. The JAX engine also checks at admission for
        a pool its donating programs deleted; programs here write the
        pool in place, so there is no such pool to check for. A second
        failure inside recover (a sticky CUDA error poisons the context)
        is not caught: the JAX engine has no handling for its
        equivalent either.

        On a serving mesh whose relayed call failed once sent, no reset
        can reach the workers: the engine fails instead (`_fail_mesh`)."""
        if getattr(self.programs, "broken", None) is not None:
            self._fail_mesh(exc)
            return
        residents = sum(s is not None for s in self._slots)
        log.exception("engine %s decode iteration failed; failing %d "
                      "resident request(s) and resetting the KV pool(s)",
                      self.name, residents)
        self._tracer.event("engine.recover", model=self.name,
                           residents=residents, error=type(exc).__name__)
        self._recoveries.inc(model=self.name)
        failed = [slot for slot in self._slots if slot is not None]
        self._slots = [None] * self.num_slots
        err = RuntimeError(f"engine {self.name} decode step failed: {exc!r}")
        err.__cause__ = exc
        try:
            self._temp_np[:] = 0.0
            for pool in (self._pool, self._draft_pool):
                if pool is not None:
                    # every rank's pool on a mesh (a relayed call)
                    self.programs.reset(pool)
            self._pagepool.reset()
            if self._radix is not None:
                self._radix.reset()
            # victims noted by an eviction the failure interrupted: their
            # pages are gone with the pools
            self._pending_spills = []
            for i in range(self.num_slots):
                self._slot_pages[i] = []
            self._slot_shared[:] = 0
            self._slot_reserve[:] = 0
            self._pt_np[:] = 0
            self._cur_np[:] = self.model.cfg.max_len
            self._occupancy_g.set(0.0, model=self.name)
            self._pages_in_use_g.set(self._pagepool.in_use, model=self.name)
        finally:
            # after the reset, so a caller that sees its failure sees the
            # engine reset; and also when the reset itself raises (the
            # first zero_() on a poisoned context), so the residents fail
            # at once while that second failure ends the scheduler thread
            for slot in failed:
                slot.req.future.fail(err)

    def _fail_mesh(self, exc: BaseException) -> None:
        """A relayed call failed once sent (serving/relay.py): the
        workers may be waiting inside the program's collectives, out of
        step with rank 0, and no relayed reset can reach them. Fail
        every queued and resident request, refuse new ones and stop the
        scheduler: the engine is dead (`failed`), and the serving entry
        point exits, which fails the workers' collectives and ends the
        gang."""
        log.error("engine %s serving mesh failed in a relayed call (%r); "
                  "failing every request and stopping", self.name, exc)
        self._tracer.event("engine.mesh_failed", model=self.name,
                           error=type(exc).__name__)
        err = RuntimeError(f"engine {self.name} serving mesh failed: "
                           f"{exc!r}")
        err.__cause__ = exc
        with self._cv:
            self._failed = err
            self._stop = True
            leftover = list(self._queue)
            self._queue.clear()
            self._queue_depth_g.set(0, model=self.name)
        failed = [slot for slot in self._slots if slot is not None]
        self._slots = [None] * self.num_slots
        self._occupancy_g.set(0.0, model=self.name)
        for req in leftover:
            req.future.fail(err)
        for slot in failed:
            slot.req.future.fail(err)

    def _iterate(self) -> None:
        # retire finished slots, then refill FIFO from the queue — each
        # admission passes the page-reservation gate
        for i, slot in enumerate(self._slots):
            if slot is not None and self._done(slot):
                self._finish(i)
        for i in range(self.num_slots):
            if self._slots[i] is not None:
                continue
            with self._cv:
                if not self._queue or not self._can_admit(self._queue[0]):
                    break
                req = self._queue.popleft()
                self._admitting += 1
                self._queue_depth_g.set(len(self._queue), model=self.name)
            try:
                self._admit(i, req)
            except Exception as e:  # per-request: fail it, keep serving
                log.exception("engine %s admission failed", self.name)
                req.future.fail(e)
                self._release_slot_pages(i)
                continue
            finally:
                # resident or failed: drain's idle check sees it again
                with self._cv:
                    self._admitting -= 1
            if self._done(self._slots[i]):
                # one-token request (or instant EOS): never steps
                self._finish(i)
        active = [i for i, s in enumerate(self._slots) if s is not None]
        self._occupancy_g.set(len(active) / self.num_slots, model=self.name)
        if not active:
            return
        # chaos seam: a device failure in the decode iteration raises into
        # _loop's recovery as a real one would
        self._chaos.maybe_fail("engine.step")
        if self.num_draft_tokens > 0:
            self._iterate_spec(active)
            return
        for i in active:  # host-only page mapping
            self._ensure_pages(i, int(self._cur_np[i]) + 1)
        t0 = time.monotonic()
        # the span closes after the host has read the tokens: it covers
        # the step, not its launches
        with self._tracer.span("engine.step", model=self.name,
                               active=len(active)):
            out = self.programs.step(
                self._pool, self._to_dev(self._tok_np),
                self._to_dev(self._pt_np), self._to_dev(self._cur_np),
                self._seed_np, self._cnt_np, self._temp_np, self._topk_np,
                self._topp_np,
            )
            if self._moe:
                # one copy: the tokens and the step's MoE pair
                toks, moe_tokens, moe_dropped = _fetch([out[0], *out[1]])
                toks = toks.astype(np.int64)
                self._note_moe([(moe_tokens, moe_dropped)])
            else:
                toks = out.cpu().numpy()
        self._note_attn(1)
        self._decode_steps_m.inc(model=self.name)
        self._tokens_m.inc(len(active), model=self.name)
        with self._stats_lock:
            self._steps += 1
            self._step_seconds += time.monotonic() - t0
            self._emitted += len(active)
            self._occupied_slot_steps += len(active)
        for i in active:
            self._slots[i].tokens.append(int(toks[i]))
            self._tok_np[i] = toks[i]
            self._cnt_np[i] += 1
            self._cur_np[i] += 1

    def _iterate_spec(self, active: List[int]) -> None:
        """One draft-and-verify iteration: K+1 draft steps propose K
        tokens a slot, one verify forward over all slots × (K+1) keeps
        each slot's longest accepted prefix plus one replacement. Cursors
        are host state, so the rejected tail's rollback is arithmetic
        here, and the pages the overhang claimed go straight back to the
        pool (`_free_tail_pages`). Emits 1..K+1 tokens per active slot; a
        slot that reaches max_new_tokens or EOS inside the window keeps
        only the prefix it asked for."""
        kk = self.num_draft_tokens
        for i in active:  # host-only page mapping
            self._ensure_pages(i, int(self._cur_np[i]) + kk + 1)
        t0 = time.monotonic()
        tokens = self._to_dev(self._tok_np)
        pt, curs = self._to_dev(self._pt_np), self._to_dev(self._cur_np)
        knobs = (self._seed_np, self._cnt_np, self._temp_np, self._topk_np,
                 self._topp_np)
        # the draft span ends at its launches (the proposals stay on the
        # card); the verify span closes after the host reads its tokens
        with self._tracer.span("engine.draft", model=self.name,
                               active=len(active), k=kk):
            proposals, qs = self.programs.draft(
                self._draft_pool, tokens, pt, curs, *knobs
            )
        with self._tracer.span("engine.verify", model=self.name,
                               active=len(active), k=kk):
            out_tok, out_len, *ms = self.programs.verify(
                self._pool, tokens, proposals, qs, pt, curs, *knobs
            )
            if ms:
                # one copy: the tokens, their lengths and the MoE pair
                out_tok, out_len, moe_tokens, moe_dropped = _fetch(
                    [out_tok, out_len, *ms[0]])
                out_tok = out_tok.astype(np.int64)
                out_len = out_len.astype(np.int64)
                self._note_moe([(moe_tokens, moe_dropped)])
            else:
                out_tok, out_len = out_tok.cpu().numpy(), out_len.cpu().numpy()
        elapsed = time.monotonic() - t0
        rolled = int(sum((kk + 1) - int(out_len[i]) for i in active))
        if rolled:
            # the host cursors rewind past the rejected tails below
            self._tracer.event("engine.rewind", model=self.name,
                               tokens=rolled)
        self._cnt_np += kk + 1  # the window used K+1 draw positions
        emitted = accepted = freed = 0
        for i in active:
            slot = self._slots[i]
            req = slot.req
            budget = req.max_new - len(slot.tokens)
            toks = [int(t) for t in out_tok[i, : min(int(out_len[i]), budget)]]
            if req.eos_id is not None and req.eos_id in toks:
                toks = toks[: toks.index(req.eos_id) + 1]
            slot.tokens.extend(toks)
            self._tok_np[i] = toks[-1]
            # resident K/V = prompt + emitted - 1: the window wrote K+1
            # positions, only the kept prefix advances the cursor, the
            # rest is invisible and overwritten by the next window
            self._cur_np[i] += len(toks)
            freed += self._free_tail_pages(i)
            emitted += len(toks)
            accepted += int(out_len[i]) - 1
        proposed = kk * len(active)
        # the draft walks the pool one query row at a time (K+1 steps);
        # the verify reads it once at the K+1 window
        self._note_attn(1)
        self._note_attn(kk + 1)
        self._decode_steps_m.inc(model=self.name)
        self._verify_steps_m.inc(model=self.name)
        self._tokens_m.inc(emitted, model=self.name)
        self._draft_proposed_m.inc(proposed, model=self.name)
        self._draft_accepted_m.inc(accepted, model=self.name)
        self._accept_rate_h.observe(accepted / proposed, model=self.name)
        self._pages_in_use_g.set(self._pagepool.in_use, model=self.name)
        with self._stats_lock:
            self._steps += 1
            self._step_seconds += elapsed
            self._emitted += emitted
            self._occupied_slot_steps += len(active)
            self._drafted += proposed
            self._accepted += accepted
            self._verifies += 1
            self._rewind_pages_returned += freed


def check_model_devices(device, meshed: bool, model, draft_model) -> None:
    """Each model's weights live on the engine's `device`. On a serving
    mesh they may live on the host too: the mesh cuts each leaf there and
    copies only this rank's block to the device
    (`ServingMesh.shard_model`), so no rank's card holds the whole
    model."""
    for role, m in (("model", model), ("draft model", draft_model)):
        if m is None or m.device == device or (
                meshed and m.device.type == "cpu"):
            continue
        raise ValueError(f"{role} weights live on {m.device}, engine "
                         f"device is {device}")


def serve_worker(model, draft_model=None, *, device: DeviceLike = None,
                 mesh_tensor: int = 1, mesh_fsdp: int = 1,
                 mesh_expert: int = 1) -> Dict[str, int]:
    """A serving mesh's rank above 0 (serving/relay.py): build the mesh
    with rank 0 (every rank calls it, in the same order), take rank 0's
    engine geometry, build the same programs over `model` (and
    `draft_model`, when rank 0's engine drafts: the same models rank 0
    was given, whole, on the host or this rank's device; int8 is applied
    here as rank 0 applies it) and run every relayed call until rank 0's engine
    closes → {call: times run}. Raises when the models are not rank 0's or
    a call fails (the gang ends with it)."""
    dev = resolve_device(device)
    sizes = {"tensor": int(mesh_tensor or 1), "fsdp": int(mesh_fsdp or 1),
             "expert": int(mesh_expert or 1)}
    validate_serving_mesh(model.cfg, **sizes)
    check_model_devices(dev, True, model, draft_model)
    mesh = build_serving_mesh(**sizes, device=dev)
    if mesh is None:
        raise ValueError("serve_worker serves a mesh above 1x1x1")
    if mesh.leader:
        raise ValueError("rank 0 of a serving mesh builds the DecodeEngine; "
                         "serve_worker runs on every other rank")
    geo = receive_geometry(mesh)
    if geo["cfg"] != model.cfg:
        raise ValueError(f"this rank's model {model.cfg} is not rank 0's "
                         f"{geo['cfg']}")
    kk = int(geo["num_draft_tokens"])
    if kk <= 0:
        draft_model = None
    elif geo["draft_is_target"]:
        draft_model = model
    elif draft_model is None or draft_model.cfg != geo["draft_cfg"]:
        mine = None if draft_model is None else draft_model.cfg
        raise ValueError(f"rank 0 drafts with {geo['draft_cfg']}, this "
                         f"rank has {mine}")
    if geo["quantize"] == "int8":
        same = draft_model is model
        model = int8_model(model)
        if draft_model is not None:
            draft_model = model if same else int8_model(draft_model)
    programs = EnginePrograms(
        model, page_size=geo["page_size"], num_pages=geo["num_pages"],
        paged_attention=geo["paged_attention"], quantize=geo["quantize"],
        draft_model=draft_model, num_draft_tokens=kk, mesh=mesh,
    )
    return run_worker(programs, mesh, dev)
