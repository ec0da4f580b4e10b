"""Host-side bookkeeping for paged decode state — any backend.

The port's copy of :mod:`repro.serve.kv_pages`: the allocator and the
trie are verbatim; only the device half of ``PrefixCache.save``/``load``
is torch (same npz format).

The device tensors live behind the ``repro_torch.serve.cache.CacheBackend``
protocol (a pool of fixed-size pages shared by every sequence, stacked
over layers: KV pages for attention, recurrent-state snapshot pages for
SSM, both for hybrid). This module owns the allocator and the capacity
math: ``pages_needed(prompt + max_new)`` physical pages are allocated when
a request is admitted and returned the moment it finishes, so sequences of
different lengths share one pool with no per-slot max_len reservation.

Pages are **refcounted** so several page tables can map the same physical
page read-only (prefix sharing): ``alloc`` hands out private pages at
refcount 1, ``share`` adds readers, and ``free`` only returns a page to the
pool when its last reference dies. ``fork`` is the host half of
copy-on-write — before a slot writes into a page other readers can still
see, the scheduler forks it into a private copy (the device copy is
:func:`repro_torch.serve.cache.copy_state_page`).

:class:`PrefixCache` is a trie over *full* prompt pages (page_size tokens
per level, keyed by the page's token tuple) mapping shared prompt prefixes
to the physical pages that already hold their state. A request whose
prompt walks k trie levels maps those k pages read-only and skips
re-prefilling ``k * page_size`` tokens (on snapshot backends it resumes
from the last matched page's state snapshot). Positional-page backends
additionally get **token-granular tails**: partial pages published at
request completion and near-miss full pages are matched by longest
common token prefix (:meth:`PrefixCache.match_tail`) and copied via
``fork_partial`` so a prompt sharing only the first 37 tokens of a
64-token page still reuses them. The trie pins each cached page with one
allocator reference of its own; under pool pressure the scheduler evicts
least-recently-matched leaves.

Page ``SCRATCH_PAGE`` (id 0) is never allocated: the step routes writes
from padded prompt positions and unoccupied slots there, which keeps
every shape static regardless of occupancy.

Everything in this module is host-side: page ids are plain integers and
the only device touch is the page gather/scatter of ``save``/``load``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SCRATCH_PAGE = 0


def state_leaves(state) -> List[torch.Tensor]:
    """Pool tensors of a backend state in ``jax.tree.leaves`` order
    (dict keys sorted, depth first) — the leaf order of the npz format
    and of the spill payload."""
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in state_leaves(state[k])]
    return [state]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy for npz. numpy has no bfloat16, so bf16 pages are saved
    widened to float32 (exact); ``load`` narrows them back."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_numpy` onto ``like``'s device and dtype. A
    2-byte void array is bfloat16 saved by a numpy that knew the type
    (the JAX package's files): its bits are reinterpreted."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(like.device, like.dtype)


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Physical pages required to hold n_tokens."""
    return -(-max(int(n_tokens), 0) // page_size)


@dataclasses.dataclass
class SpilledPages:
    """Host-memory copy of a preempted slot's live pages.

    The device half is ``CacheBackend.spill`` / ``restore`` (the same
    page gather/scatter machinery :meth:`PrefixCache.save` / ``load``
    use for trie pages). ``length`` is the token count the pages cover
    — the slot's ``lengths`` entry at preemption time; ``leaves`` holds
    each pool leaf's page contents (host tensors, in
    :func:`state_leaves` order), exactly what ``restore`` scatters back
    into freshly allocated pages."""
    length: int
    leaves: List[torch.Tensor]


class PageAllocator:
    """Refcounted pool over physical page ids 1..n_pages-1 (0 is scratch).

    The free pool is a LIFO stack (hot pages get reused first) backed by a
    set, so membership checks and frees are O(1) instead of the old
    O(n_free) list scan. Refcounts detect double frees exactly: freeing a
    page whose refcount is already 0 raises.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page + scratch")
        self.n_pages = n_pages
        self._free_stack: List[int] = list(range(n_pages - 1, 0, -1))
        self._free_set = set(self._free_stack)
        self._ref = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self._free_stack)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def is_free(self, page: int) -> bool:
        return page in self._free_set

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n private pages (refcount 1 each), or None (caller waits
        for frees / evicts cached prefixes) if not available."""
        if n > len(self._free_stack):
            return None
        pages = [self._free_stack.pop() for _ in range(n)]
        for p in pages:
            self._free_set.discard(p)
            self._ref[p] = 1
        return pages

    def share(self, pages: List[int]) -> None:
        """Add one reader to each page (it must be live)."""
        for p in pages:
            self._check_id(p)
            if self._ref[p] < 1:
                raise ValueError(f"share of unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; a page returns to the pool when
        its last reference dies."""
        for p in pages:
            self._check_id(p)
            if self._ref[p] == 0:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free_stack.append(p)
                self._free_set.add(p)

    def fork(self, page: int) -> Optional[int]:
        """Copy-on-write split: detach one reference of ``page`` onto a
        private copy. Returns ``page`` itself when it is already private
        (no copy needed), a fresh page id (refcount 1 — the caller must
        copy the device KV) when other readers remain, or None when the
        pool is empty."""
        self._check_id(page)
        if self._ref[page] < 1:
            raise ValueError(f"fork of unallocated page {page}")
        if self._ref[page] == 1:
            return page
        got = self.alloc(1)
        if got is None:
            return None
        self._ref[page] -= 1
        return got[0]

    def fork_partial(self, page: int) -> Optional[int]:
        """Token-granular copy-on-write, host half: allocate a fresh
        private page (refcount 1) to receive a copy of ``page`` whose
        first ``n_valid`` tokens the caller will reuse. Unlike
        :meth:`fork`, the source keeps *all* its references — this is an
        independent new page seeded from ``page``'s content, not a
        detached reader (the caller holds its own reference on ``page``
        across the device copy, so eviction cannot free it mid-copy).
        Returns the fresh id, or None when the pool is empty."""
        self._check_id(page)
        if self._ref[page] < 1:
            raise ValueError(f"fork_partial of unallocated page {page}")
        got = self.alloc(1)
        return None if got is None else got[0]

    def _check_id(self, p: int) -> None:
        if not 0 < p < self.n_pages:
            raise ValueError(f"bad page id {p}")


class _PrefixNode:
    __slots__ = ("children", "tails", "page", "tick")

    def __init__(self, page: int, tick: int):
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.tails: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.page = page
        self.tick = tick


def _common_prefix(key: Tuple[int, ...], rest, cap: int) -> int:
    """Leading tokens ``key`` and ``rest`` agree on, capped at ``cap``."""
    n = 0
    for a, b in zip(key, rest, strict=False):
        if n >= cap or a != b:
            break
        n += 1
    return n


class PrefixCache:
    """Trie over full prompt pages -> physical pages holding their KV.

    Level d of the trie is keyed by the token tuple of prompt page d, so a
    path from the root spells out a prompt prefix in whole-page units.
    Each node pins one physical page with a trie-owned allocator reference
    (taken at :meth:`insert`); the page therefore outlives the request
    that prefilled it and later requests map it read-only via
    :meth:`match` + ``PageAllocator.share``.

    **Token-granular tails** (positional-page backends only): each node
    additionally carries *tail* entries — partial pages keyed by a token
    tuple shorter than ``page_size``, published at request completion
    (the page then also holds tokens past the prompt tail; only the
    keyed prefix is ever reused). A later prompt that shares only the
    first n tokens of a page finds the longest such entry — or the
    longest common token prefix of a full-page key — via
    :meth:`match_tail` and copies the source page with
    ``CacheBackend.fork_partial`` instead of recomputing from the page
    boundary. Tail entries pin their page like ordinary nodes and take
    part in LRU eviction; they are **not** persisted by
    :meth:`save`/:meth:`load` (a restart republishes them as requests
    complete).
    """

    def __init__(self, alloc: PageAllocator, page_size: int, stats=None):
        self.alloc = alloc
        self.page_size = page_size
        self.children: Dict[Tuple[int, ...], _PrefixNode] = {}
        self.tails: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._tick = 0
        # counters may be injected (the scheduler hands in a dict the
        # metrics registry registered under the 'trie' namespace) so the
        # registry owns them without the trie knowing about obs at all
        self.stats = {"hit_pages": 0, "miss_prompts": 0, "evicted": 0} \
            if stats is None else stats

    def _chunks(self, prompt: np.ndarray):
        ps = self.page_size
        for i in range(len(prompt) // ps):
            yield tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def match(self, prompt) -> List[int]:
        """Longest already-cached chain of the prompt's full pages.
        Returns their physical page ids in prompt order; the caller must
        ``share`` them before any allocator traffic (e.g. eviction) could
        otherwise free them."""
        self._tick += 1
        pages: List[int] = []
        children = self.children
        for key in self._chunks(prompt):
            node = children.get(key)
            if node is None:
                break
            node.tick = self._tick
            pages.append(node.page)
            children = node.children
        self.stats["hit_pages"] += len(pages)
        if not pages:
            self.stats["miss_prompts"] += 1
        return pages

    def insert(self, prompt, pages: List[int]) -> None:
        """Publish the prompt's first ``len(pages)`` full pages (already
        written physical ids, in prompt order). New nodes pin their page
        with one trie-owned reference; existing nodes keep their original
        page (concurrent prefills of the same prefix are harmless)."""
        self._tick += 1
        children = self.children
        for key, page in zip(self._chunks(prompt), pages, strict=False):
            node = children.get(key)
            if node is None:
                self.alloc.share([page])
                node = _PrefixNode(page, self._tick)
                children[key] = node
            node.tick = self._tick
            children = node.children

    def match_tail(self, prompt, matched_pages: int,
                   pending=frozenset()) -> Optional[Tuple[int, int]]:
        """Best token-granular partial match for the prompt's remainder
        after ``matched_pages`` full trie pages: the longest common token
        prefix among the stop node's tail entries *and* full-page child
        keys (a near-miss full page is just a tail with ``page_size``
        published tokens). Returns ``(src_page, n_tokens)`` with
        ``1 <= n_tokens < page_size`` and ``n_tokens`` strictly below the
        remainder length (at least one token is always recomputed for
        its logits), or None. Pages in ``pending`` — written by an
        in-flight wave, device content not landed — are skipped. The
        caller must ``share`` the source page before any allocator
        traffic (eviction) could free it, then release its reference
        after the device copy."""
        ps = self.page_size
        rest = [int(t) for t in prompt[matched_pages * ps:]]
        cap = min(len(rest) - 1, ps - 1)
        if cap < 1:
            return None
        children, tails = self.children, self.tails
        for i, key in enumerate(self._chunks(prompt)):
            if i >= matched_pages:
                break
            node = children.get(key)
            if node is None:          # caller matched deeper than us?
                return None
            children, tails = node.children, node.tails
        best: Optional[Tuple[int, _PrefixNode]] = None
        for entries in (tails, children):
            for key, node in entries.items():
                if node.page in pending:
                    continue
                n = _common_prefix(key, rest, cap)
                if n >= 1 and (best is None or n > best[0]):
                    best = (n, node)
        if best is None:
            return None
        self._tick += 1
        best[1].tick = self._tick
        return best[1].page, best[0]

    def insert_tail(self, prompt, page: int) -> bool:
        """Publish the prompt's final partial page (its last
        ``len(prompt) % page_size`` tokens live in physical ``page``) as
        a tail entry under the node chain of its full pages. No-op —
        returns False — when the prompt is page-aligned, an ancestor is
        not cached, or an existing entry already covers the same tokens
        (a longer entry subsumes a shorter one: common-prefix matching
        serves both). A strictly-shorter entry that this one extends is
        replaced. Takes one trie-owned reference on ``page``."""
        ps = self.page_size
        n = len(prompt) % ps
        if n == 0:
            return False
        children, tails = self.children, self.tails
        for key in self._chunks(prompt):
            node = children.get(key)
            if node is None:
                return False
            children, tails = node.children, node.tails
        key = tuple(int(t) for t in prompt[len(prompt) - n:])
        self._tick += 1
        for other in list(tails):
            if len(other) >= len(key) and other[:len(key)] == key:
                tails[other].tick = self._tick     # subsumed: just touch
                return False
            if len(other) < len(key) and key[:len(other)] == other:
                old = tails.pop(other)             # we extend it: replace
                self.alloc.free([old.page])
        self.alloc.share([page])
        tails[key] = _PrefixNode(page, self._tick)
        return True

    def _walk(self):
        """Yields (parent_dict, key, node) over the whole trie — full-page
        nodes and tail entries alike (tail nodes have no children)."""
        stack = [(self.children, k) for k in list(self.children)]
        stack += [(self.tails, k) for k in list(self.tails)]
        while stack:
            children, key = stack.pop()
            node = children[key]
            yield children, key, node
            stack.extend((node.children, k) for k in list(node.children))
            stack.extend((node.tails, k) for k in list(node.tails))

    @property
    def n_cached_pages(self) -> int:
        return sum(1 for _ in self._walk())

    def evict(self, n_needed: int) -> int:
        """Drop least-recently-matched leaves (full-page nodes with no
        children and no tails, or tail entries) whose page only the trie
        still references, until ``n_needed`` pages have returned to the
        pool or nothing more can be freed. Returns pages freed."""
        freed = 0
        while freed < n_needed:
            leaves = [(node.tick, key, children)
                      for children, key, node in self._walk()
                      if not node.children and not node.tails
                      and self.alloc.refcount(node.page) == 1]
            if not leaves:
                break
            leaves.sort(key=lambda t: t[0])
            for _, key, children in leaves:
                if freed >= n_needed:
                    break
                node = children.pop(key)
                self.alloc.free([node.page])
                freed += 1
                self.stats["evicted"] += 1
        return freed

    def clear(self) -> None:
        """Release every cached page (trie references only — pages still
        mapped by live requests stay allocated until those finish)."""
        for _, _, node in list(self._walk()):
            self.alloc.free([node.page])
        self.children = {}
        self.tails = {}

    # -- persistence --------------------------------------------------------
    # The trie + the device contents of its pinned pages round-trip
    # through one npz file, so a restarted engine starts warm: cached
    # prompt prefixes skip their prefill again without recomputation.
    # State leaves are saved in jax.tree order (:func:`state_leaves`,
    # page axis 1 by the CacheBackend convention) — load requires the
    # same model config. The page pools are updated in place.

    def save(self, path: str, state) -> int:
        """Write the trie structure + pinned page contents to ``path``.
        ``state`` is the backend's device state whose pages the trie
        pins. Tail entries (token-granular partial pages) ride along in
        parallel ``tail_*`` arrays, keys padded to page_size with -1.
        Returns the number of pages saved (full + tail)."""
        recs: List[Tuple[int, Tuple[int, ...], int]] = []
        tail_recs: List[Tuple[int, Tuple[int, ...], int]] = []

        def walk(children, tails, parent):
            for key, node in tails.items():
                tail_recs.append((parent, key, node.page))
            for key, node in children.items():
                recs.append((parent, key, node.page))
                walk(node.children, node.tails, len(recs) - 1)

        walk(self.children, self.tails, -1)
        ps = self.page_size
        pages = np.asarray([r[2] for r in recs], np.int32)
        tail_pages = np.asarray([r[2] for r in tail_recs], np.int32)
        tail_keys = np.full((len(tail_recs), ps), -1, np.int32)
        for i, (_, key, _) in enumerate(tail_recs):
            tail_keys[i, :len(key)] = key
        data = {
            "page_size": np.int32(ps),
            "parents": np.asarray([r[0] for r in recs], np.int32),
            "keys": np.asarray([r[1] for r in recs],
                               np.int32).reshape(len(recs), ps),
            "pages": pages,
            "tail_parents": np.asarray([r[0] for r in tail_recs],
                                       np.int32),
            "tail_keys": tail_keys,
            "tail_lens": np.asarray([len(r[1]) for r in tail_recs],
                                    np.int32),
            "tail_pages": tail_pages,
        }
        all_pages = np.concatenate([pages, tail_pages])
        for i, leaf in enumerate(state_leaves(state)):
            idx = torch.as_tensor(all_pages, dtype=torch.long,
                                  device=leaf.device)
            data[f"leaf_{i}"] = _to_numpy(leaf[:, idx])
        np.savez(path, **data)
        return len(recs) + len(tail_recs)

    def load(self, path: str, state):
        """Restore a saved cache into this (empty) trie: allocates fresh
        pages, scatters the saved contents into ``state``, and rebuilds
        the trie nodes pinning them. Nodes that no longer fit the pool —
        or whose parent was dropped — are skipped with their subtrees.
        Returns (state, n_pages_restored); ``state``'s pools are
        written in place."""
        d = np.load(path)
        if int(d["page_size"]) != self.page_size:
            raise ValueError(
                f"prefix cache was saved with page_size="
                f"{int(d['page_size'])}, engine uses {self.page_size}")
        parents = d["parents"]
        n = len(parents)
        new_ids = np.full((n,), -1, np.int32)
        nodes: Dict[int, _PrefixNode] = {}
        kept: List[int] = []
        for i in range(n):
            parent = int(parents[i])
            if parent >= 0 and parent not in nodes:
                continue                       # subtree of a dropped node
            children = self.children if parent < 0 \
                else nodes[parent].children
            key = tuple(int(t) for t in d["keys"][i])
            if key in children:                # already cached post-restart
                nodes[i] = children[key]
                continue
            got = self.alloc.alloc(1)
            if got is None:
                continue                       # pool full: drop subtree
            new_ids[i] = got[0]
            self._tick += 1
            node = _PrefixNode(got[0], self._tick)
            children[key] = node
            nodes[i] = node
            kept.append(i)
        # tail entries (absent in files saved before token-granular
        # sharing): attach to a surviving parent unless an equal-or-
        # longer entry already covers the same tokens
        m = len(d["tail_parents"]) if "tail_parents" in d.files else 0
        tail_new = np.full((m,), -1, np.int32)
        tail_kept: List[int] = []
        for i in range(m):
            parent = int(d["tail_parents"][i])
            if parent >= 0 and parent not in nodes:
                continue                       # parent node was dropped
            owner = self.tails if parent < 0 else nodes[parent].tails
            klen = int(d["tail_lens"][i])
            key = tuple(int(t) for t in d["tail_keys"][i][:klen])
            if any(len(o) >= klen and o[:klen] == key for o in owner):
                continue                       # already cached/subsumed
            got = self.alloc.alloc(1)
            if got is None:
                continue                       # pool full: drop entry
            tail_new[i] = got[0]
            self._tick += 1
            owner[key] = _PrefixNode(got[0], self._tick)
            tail_kept.append(i)
        if kept or tail_kept:
            src = kept + [n + i for i in tail_kept]
            dst = np.concatenate([new_ids[kept], tail_new[tail_kept]])
            for j, leaf in enumerate(state_leaves(state)):
                idx = torch.as_tensor(dst, dtype=torch.long,
                                      device=leaf.device)
                leaf[:, idx] = _from_numpy(d[f"leaf_{j}"][:, src], leaf)
        return state, len(kept) + len(tail_kept)
