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

Not ported yet: the serving mesh, MoE, the host/disk KV tiers, the
pool rebuild of recover, and chaos.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.models.gpt import (
    PAGED_ATTENTION_IMPLS,
    QUANTIZE_CHOICES,
    KVPool,
    PagedState,
    copy_pool_page,
    insert_pages,
    int8_model,
    make_paged_pool,
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
from kubeflow_tpu_torch.utils.metrics import default_registry

log = get_logger(__name__)

DEFAULT_NUM_SLOTS = 8
DEFAULT_MAX_QUEUE = 64
DEFAULT_PAGE_SIZE = 16
DEFAULT_PAGED_ATTENTION = "gather"
DEFAULT_QUANTIZE = "none"


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


class Completion:
    """One waiter's completion slot: a value or an error behind an event
    (the worker calls exactly one of set()/fail(); the caller waits)."""

    __slots__ = ("_event", "value", "error")

    def __init__(self):
        self._event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None

    def set(self, value) -> None:
        self.value = value
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"no completion within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.value


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
    Telemetry-driven sizing and the tensor-sharded mesh are not ported
    and raise."""
    if telemetry:
        raise ValueError("pool sizing from telemetry is not ported yet "
                         "(ROADMAP A10: serving/kv_tiers.py)")
    if int(mesh_tensor) > 1:
        raise ValueError("mesh_tensor > 1 is not ported yet (ROADMAP A13: "
                         "the serving mesh)")
    if num_pages:
        return int(num_pages)
    pages = auto_num_pages(num_slots, model_cfg.max_len, page_size)
    if quantize == "int8":
        head_dim = model_cfg.hidden_size // model_cfg.num_heads
        itemsize = torch.finfo(model_cfg.dtype).bits // 8
        pages = int(pages * int8_page_capacity_ratio(head_dim, itemsize))
    return pages


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


class _RadixNode:
    __slots__ = ("chunk", "page", "children", "parent", "last_used")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk          # tuple of page_size token ids
        self.page = page            # pool page holding this chunk's K/V
        self.parent = parent
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.last_used = 0


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
        self._clock = 0
        # leaves maintained incrementally: eviction scans only these
        self._leaves: Dict[_RadixNode, None] = {}

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
            self.pool.unmark_tree(victim.page)
            freed += self.pool.release([victim.page])
        return freed


class EnginePrograms:
    """The engine's device programs (the JAX `EnginePrograms` bodies as
    plain methods): prefill, insert, chunk, cow and step, plus at K > 0
    the draft family (draft_prefill, draft_chunk, draft) and verify;
    `insert` and `cow` serve the draft's pool too. Every program that
    writes a pool writes it in place.

    Paged geometry (`page_size`, `num_pages`), `quantize` (int8 pools
    follow the weights) and the draft (`draft_model`, `num_draft_tokens`)
    are construction state. The draft's pool has the target's geometry:
    the engine maps one page id onto both."""

    def __init__(self, model, *, page_size: int, num_pages: int,
                 paged_attention: str, quantize: str = DEFAULT_QUANTIZE,
                 draft_model=None, num_draft_tokens: int = 0):
        cfg = model.cfg
        self.model = model
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

    def _paged(self, page_table, cursors) -> PagedState:
        return PagedState(page_table, cursors, attn_impl=self.paged_attention)

    def prefill(self, ids, mask, seed, temp, top_k, top_p):
        """Batch-1 bucketed prefill → (slot cache, first token)."""
        logits, cache = self.model.prefill(ids, mask)
        last = int(mask[0].sum()) - 1
        tok = sample_slots(
            logits[:, max(last, 0)], [seed], [0], [temp], [top_k], [top_p]
        )
        return cache, tok[0]

    def make_pool(self, device) -> KVPool:
        return make_paged_pool(self.model.cfg, self.num_pages,
                               self.page_size, device, kv_quant=self.quantize)

    def insert(self, pool: KVPool, cache_one, page_ids, real_len: int):
        """Copy the prefill rows into the slot's pages (quantized on the
        way into an int8 pool)."""
        return insert_pages(pool, cache_one, page_ids, real_len)

    def chunk(self, pool: KVPool, ids, page_table, cursor, sample_idx: int,
              seed, temp, top_k, top_p):
        """One page-aligned prefill window through the paged path: writes
        the window's K/V into the slot's pages and samples the token after
        window position `sample_idx` (meaningful only for the chunk
        holding the prompt's last real token)."""
        logits = self.model.paged_forward(
            ids, pool, self._paged(page_table, cursor)
        )
        tok = sample_slots(
            logits[0, sample_idx][None], [seed], [0], [temp], [top_k],
            [top_p],
        )
        return tok[0]

    def cow(self, pool: KVPool, src: int, dst: int):
        return copy_pool_page(pool, src, dst)

    def step(self, pool: KVPool, tokens, page_table, cursors, seeds,
             counters, temps, top_ks, top_ps):
        """One single-token decode step over all slots → [S] tokens."""
        logits = self.model.paged_forward(
            tokens[:, None], pool, self._paged(page_table, cursors)
        )
        return sample_slots(
            logits[:, 0], seeds, counters, temps, top_ks, top_ps
        )

    # -- the speculative draft-and-verify family (K > 0) -------------------

    def make_draft_pool(self, device) -> KVPool:
        return make_paged_pool(self.draft_model.cfg, self.num_pages,
                               self.page_size, device, kv_quant=self.quantize)

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

    def verify(self, pool: KVPool, window, qs, page_table, cursors, seeds,
               counters, temps, top_ks, top_ps):
        """ONE target forward over all slots × (K+1) positions (window[:,
        0] is each slot's last emitted token, window[:, 1:] the draft's
        proposals), then each slot's longest accepted prefix plus one
        replacement → (tokens [S, K+1], lengths [S]): a slot emits
        tokens[s, :lengths[s]], 1..K+1 of them.

        Greedy slots accept while the proposal equals the target's argmax
        and replace with the argmax. Sampled slots run
        `speculative_accept` (uniforms on the SALT_ACCEPT stream at
        positions counters + j); the replacement is drawn on the
        SALT_CORRECT stream from the residual at the first rejection, or
        after a clean sweep from the (K+1)-th target distribution (the
        bonus token). Only that one draw is made: the others would be
        discarded."""
        kk = window.shape[1] - 1
        logits = self.model.paged_forward(
            window, pool, self._paged(page_table, cursors)
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
        return tokens, acc + 1


class _Request:
    """One admitted-or-queued generation request."""

    __slots__ = (
        "prompt", "max_new", "temperature", "top_k", "top_p", "eos_id",
        "seed", "t_submit", "future",
    )

    def __init__(self, prompt, max_new, temperature, top_k, top_p, eos_id,
                 seed):
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


class _Slot:
    """Host bookkeeping for one occupied decode slot."""

    __slots__ = ("req", "tokens", "ttft_s")

    def __init__(self, req: _Request):
        self.req = req
        self.tokens: List[int] = []
        self.ttft_s = 0.0


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
    int8 model too). A drafted engine never runs the one-token step."""

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
    ):
        self.device = resolve_device(device)
        if int(num_draft_tokens) <= 0:
            draft_model = None  # K = 0 ignores a draft, as the reference
        for role, m in (("model", model), ("draft model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(
                    f"{role} weights live on {m.device}, engine device is "
                    f"{self.device}"
                )
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
        if self.quantize == "int8":
            # the resident weights become int8 + per-channel scales, once;
            # a draft that is the target shares the target's int8 model
            same = draft_model is model
            model = int8_model(model)
            if draft_model is not None:
                draft_model = model if same else int8_model(draft_model)
        self.name = name
        self.model = model
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.paged_attention = paged_attention or DEFAULT_PAGED_ATTENTION
        ps = int(page_size) if page_size else DEFAULT_PAGE_SIZE
        pool_pages = resolve_num_pages(num_pages, num_slots, cfg, ps,
                                       self.quantize)
        self.programs = EnginePrograms(
            model, page_size=ps, num_pages=pool_pages,
            paged_attention=self.paged_attention, quantize=self.quantize,
            draft_model=draft_model, num_draft_tokens=num_draft_tokens,
        )
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
        # pools hold
        self.kv_pool_bytes = self._pool.nbytes + (
            self._draft_pool.nbytes if self._draft_pool is not None else 0
        )
        # -- host page accounting (scheduler-thread-owned) --------------
        self._pagepool = PagePool(self.num_pages)
        self._radix = (
            RadixPrefixIndex(ps, self._pagepool)
            if self.prefix_cache_enabled else None
        )
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
        self._stop = False
        # drain(): admission refused from here on; `_admitting` counts
        # requests popped from the queue and not yet resident, so drain's
        # idle check never misses one mid-admission
        self._draining = False
        self._admitting = 0

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
        # read-path evidence: window size (query rows per pool walk) ->
        # read path that served it
        self._attn_windows: Dict[int, str] = {}

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
        self._drain_h = reg.histogram(
            "serving_drain_seconds", "drain() start to idle or deadline",
            ["model"],
        )
        self._queue_depth_g.set(0, model=name)
        self._occupancy_g.set(0.0, model=name)
        self._pages_in_use_g.set(0, model=name)

        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"decode-engine-{name}"
        )
        if autostart:
            self._thread.start()

    # -- public API --------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        return bucket_for(prompt_len, self.prefill_buckets)

    def _make_request(self, prompt_ids, max_new_tokens, temperature, top_k,
                      top_p, eos_id, seed) -> _Request:
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
        return _Request(prompt, n, temperature, top_k, top_p, eos_id,
                        int(seed))

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
            if self._stop:
                raise RuntimeError("engine is closed")
            if len(self._queue) + len(reqs) > self.max_queue:
                raise QueueFullError(
                    f"admission queue full ({len(self._queue)} waiting, "
                    f"capacity {self.max_queue})"
                )
            self._queue.extend(reqs)
            self._queue_depth_g.set(len(self._queue), model=self.name)
            self._cv.notify_all()

    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: Optional[int] = None, seed: int = 0) -> Completion:
        """Enqueue one UNPADDED prompt row; returns the request future
        (completes with {"tokens", "ttft_s"}). Raises QueueFullError when
        the admission queue is at max_queue."""
        req = self._make_request(prompt_ids, max_new_tokens, temperature,
                                 top_k, top_p, eos_id, seed)
        self._enqueue([req])
        return req.future

    def submit_batch(self, rows, max_new_tokens: int, *,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, eos_id: Optional[int] = None,
                     seed: int = 0) -> List[Completion]:
        """Atomic multi-row admission: every row enters the queue, or
        none does. Row i's sampling stream is seeded `seed + i`."""
        reqs = [
            self._make_request(row, max_new_tokens, temperature, top_k,
                               top_p, eos_id, int(seed) + i)
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
                "cow_copies": self._cow_copies,
                "prefill_compute_tokens": self._prefill_compute_tokens,
                "pages_allocated": self._pages_allocated,
                "rewind_pages_returned": self._rewind_pages_returned,
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
                "device": str(self.device),
            }

    @property
    def draining(self) -> bool:
        """True once drain() flipped the admission gate (new submits get
        429 + Retry-After): the /healthz "draining, not dead" signal."""
        with self._cv:
            return self._draining

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
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                slot.req.future.fail(err)
        self._occupancy_g.set(0.0, model=self.name)

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
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _note_attn(self, window: int) -> None:
        """Record one pool-reading dispatch at `window` query rows."""
        self._attn_calls_m.inc(model=self.name, variant=self.paged_attention)
        with self._stats_lock:
            self._attn_windows.setdefault(window, self.paged_attention)

    def _prefix_lookup(self, slot_idx: int, prompt: np.ndarray) -> int:
        """Map the prompt's committed prefix onto slot `slot_idx`: full
        pages copy-free, the partially matched boundary page through a
        copy-on-write. Returns the matched token count (0 = miss)."""
        ps = self.page_size
        p = int(prompt.size)
        with self._stats_lock:
            self._prefix_lookups += 1
        chain, full_m, partial = self._radix.match(prompt)
        # never map the WHOLE prompt: the last real token must run through
        # a chunk window to produce the first-token logits
        m = min(full_m + (partial[1] if partial is not None else 0), p - 1)
        largest = self.prefill_buckets[-1]
        if not (m * 2 >= p or (p > largest and m >= largest)):
            # a small hit is slower than a miss: it routes the whole tail
            # through chunk windows. Keep it only when it covers half the
            # prompt, or past the largest bucket the head prefill.
            return 0
        q, r = divmod(m, ps)
        pages: List[int] = []
        for pg in chain[:q]:
            self._pagepool.retain([pg])
            self._pt_np[slot_idx, len(pages)] = pg
            pages.append(pg)
        self._slot_pages[slot_idx] = pages
        self._slot_shared[slot_idx] = q
        if r > 0:
            # copy-on-write at the divergence/extension boundary: this slot
            # will write into the page's tail, so it gets its own copy
            src = chain[q] if q < len(chain) else partial[0]
            dst = self._alloc_pages(1)[0]
            self.programs.cow(self._pool, src, dst)
            if self._draft_pool is not None:
                # the donor page's draft K/V was written with its chain
                self.programs.cow(self._draft_pool, src, dst)
            with self._stats_lock:
                self._cow_copies += 1
            self._pt_np[slot_idx, len(pages)] = dst
            pages.append(dst)
        with self._stats_lock:
            self._prefix_hit_tokens += m
        return m

    def _admit(self, slot_idx: int, req: _Request) -> None:
        prompt = req.prompt
        p = int(prompt.size)
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
        if matched == 0 and p <= largest:
            # fresh short prompt: one bucketed batch-1 prefill, copied into
            # this slot's pages at the prompt's REAL length
            bucket = self.bucket_for(p)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :p] = prompt
            mask = np.zeros((1, bucket), bool)
            mask[0, :p] = True
            ids, mask = self._to_dev(ids), self._to_dev(mask)
            cache_one, first_tok = self.programs.prefill(ids, mask, *knobs)
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
                cache_one, _ = self.programs.prefill(ids, mask, *knobs)
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
        slot = _Slot(req)
        slot.tokens.append(int(first_tok))
        slot.ttft_s = time.monotonic() - req.t_submit
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
        req.future.set({"tokens": list(slot.tokens), "ttft_s": slot.ttft_s})

    @staticmethod
    def _done(slot: _Slot) -> bool:
        req = slot.req
        if len(slot.tokens) >= req.max_new:
            return True
        return req.eos_id is not None and slot.tokens[-1] == req.eos_id

    def _loop(self) -> None:
        # grad mode is thread-local: the scheduler thread sets its own
        with torch.inference_mode():
            while True:
                with self._cv:
                    while (
                        not self._stop and not self._queue
                        and not any(s is not None for s in self._slots)
                    ):
                        self._cv.wait()
                    if self._stop:
                        return
                try:
                    self._iterate()
                except Exception as e:  # the thread must live
                    self._fail_resident(e)

    def _fail_resident(self, exc: BaseException) -> None:
        """A decode iteration failed: fail every resident request and free
        its pages, in the target's pool and (one page id each) the
        draft's; queued requests were never admitted and stay servable.
        The pools are written in place, so nothing needs rebuilding: the
        failed iteration wrote only past the residents' cursors, onto
        pages they owned."""
        log.exception("engine %s decode iteration failed", self.name)
        err = RuntimeError(f"engine {self.name} decode step failed: {exc!r}")
        err.__cause__ = exc
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                self._temp_np[i] = 0.0
                self._release_slot_pages(i)
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
        if self.num_draft_tokens > 0:
            self._iterate_spec(active)
            return
        for i in active:  # host-only page mapping
            self._ensure_pages(i, int(self._cur_np[i]) + 1)
        t0 = time.monotonic()
        toks = self.programs.step(
            self._pool, self._to_dev(self._tok_np),
            self._to_dev(self._pt_np), self._to_dev(self._cur_np),
            self._seed_np, self._cnt_np, self._temp_np, self._topk_np,
            self._topp_np,
        ).cpu().numpy()
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
        proposals, qs = self.programs.draft(
            self._draft_pool, tokens, pt, curs, *knobs
        )
        window = torch.cat([tokens[:, None], proposals], dim=1)
        out_tok, out_len = self.programs.verify(
            self._pool, window, qs, pt, curs, *knobs
        )
        out_tok, out_len = out_tok.cpu().numpy(), out_len.cpu().numpy()
        elapsed = time.monotonic() - t0
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
