"""Paged KV-cache page pool: the host-side allocator behind the paged
serving engine (the port's own copy of ``paddle_tpu/serving/kv_pool.py``).

A request whose prompt pads to bucket ``P`` with token budget ``B``
holds ``span = ceil((P + B) / page_size)`` pages of the per-layer
``[n_pages, page_size, H, D]`` device pools, not a worst-case row. This
module is pure host bookkeeping -- device K/V bytes never move through
it. Three cooperating structures:

- **Free list** -- page ids available for immediate allocation.
  :meth:`PagePool.acquire` takes ``span - shared`` of them (raising
  :class:`PagesExhaustedError` when reclaim cannot cover the request);
  :meth:`PagePool.release` returns a slot's non-shared tail pages.

- **Radix tree over prompt pages** -- nodes keyed by the tuple of
  ``page_size`` token ids a FULL prompt page holds (partial trailing
  pages are never shared). Admission walks the tree along the prompt:
  every node found is a physically shared page (refcount++, no
  allocation, no prefill write -- the K/V rows for position ``j``
  depend only on token ``j``). The first divergent page is where
  copy-on-write happens: the request gets a PRIVATE page and the
  prefill writes it, so divergence never touches a shared page.

- **Evictable prefix cache** -- releasing a slot decrements its chain's
  refcounts but keeps refcount-0 nodes RESIDENT: the next request with
  the same prefix re-shares them without a prefill write. Under
  allocation pressure refcount-0 leaves are reclaimed LRU-first
  (``cause="capacity"``); :meth:`PagePool.reset` drops the whole
  cache (``cause="reset"``).

A pool built with a ``model`` tag publishes its accounting as the
reference's does: the ``paddle_kv_pages_total`` / ``_free`` /
``paddle_kv_prefix_shared_pages`` gauges after every lease change and
``paddle_kv_page_evictions_total{cause}`` per reclaimed page
(``serving/metrics.py``), as the reference's does; an untagged pool
publishes nothing.

Thread discipline matches the engine: one dispatcher at a time -- no
internal locking.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.serving import metrics as smetrics


class PagesExhaustedError(RuntimeError):
    """Admission cannot be satisfied: free pages + evictable cached
    pages < the private pages the request needs."""


class _Node:
    """One full prompt page in the radix tree: ``key`` is the tuple of
    page_size token ids it stores, ``page`` the pool page holding their
    K/V rows, ``refs`` how many in-flight slots reference it."""

    __slots__ = ("key", "page", "refs", "children", "parent", "last_use")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.refs = 0
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class _SlotLease:
    __slots__ = ("pages", "nodes", "tail", "n_shared")

    def __init__(self, pages, nodes, tail, n_shared):
        self.pages = pages        # full span, logical-page order
        self.nodes = nodes        # tree nodes referenced (chain order)
        self.tail = tail          # private non-tree pages
        self.n_shared = n_shared  # leading pages found in the tree


class PagePool:
    """Free-list page allocator + prompt-prefix radix tree for one
    model's paged KV pool. Page ids index the device pools' leading
    axis; the engine turns a lease into the slot's page-table row and
    the prefill's write-row vector. ``model`` tags the published gauges
    and the eviction counter (none when empty)."""

    def __init__(self, n_pages: int, page_size: int, model: str = ""):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool geometry: n_pages={n_pages}, "
                             f"page_size={page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.model = model
        self._free: List[int] = list(range(self.n_pages))[::-1]
        self._root = _Node(None, -1, None)
        self._slots: Dict[int, _SlotLease] = {}
        self._clock = 0
        self._cached = 0          # refcount-0 nodes resident in the tree
        self._publish()

    # -- accounting -------------------------------------------------------
    def free_count(self) -> int:
        """Pages on the free list (excludes evictable cached pages)."""
        return len(self._free)

    def available_count(self) -> int:
        """Pages an admission could obtain: free + evictable cached."""
        return len(self._free) + self._cached

    def shared_count(self) -> int:
        """Pages referenced by >= 2 in-flight slots (each once)."""
        return sum(1 for nd in self._iter_nodes() if nd.refs >= 2)

    def cached_count(self) -> int:
        return self._cached

    def page_refs(self, page: int) -> int:
        """Refcount of the tree node holding ``page`` (0 if cached;
        KeyError if the page is free or privately held)."""
        for nd in self._iter_nodes():
            if nd.page == page:
                return nd.refs
        raise KeyError(f"page {page} is not in the prefix tree")

    def span_for(self, total_len: int) -> int:
        """Pages needed to hold ``total_len`` cache positions."""
        return -(-int(total_len) // self.page_size)

    def stats(self) -> dict:
        return {"pages_total": self.n_pages,
                "pages_free": self.free_count(),
                "pages_cached": self._cached,
                "pages_shared": self.shared_count(),
                "slots": len(self._slots)}

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def _publish(self):
        if not self.model:
            return
        smetrics.KV_PAGES_TOTAL.labels(model=self.model).set(self.n_pages)
        smetrics.KV_PAGES_FREE.labels(model=self.model).set(
            self.free_count())
        smetrics.KV_PREFIX_SHARED_PAGES.labels(model=self.model).set(
            self.shared_count())

    # -- eviction ---------------------------------------------------------
    def _evict_one(self, cause: str) -> bool:
        """Reclaim the LRU refcount-0 LEAF (a refcount-0 node's whole
        subtree is refcount-0 -- any slot holding a child holds the
        parent -- so leaf-first reclaim reaches every cached page)."""
        victim: Optional[_Node] = None
        for nd in self._iter_nodes():
            if nd.refs == 0 and not nd.children:
                if victim is None or nd.last_use < victim.last_use:
                    victim = nd
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self._free.append(victim.page)
        self._cached -= 1
        if self.model:
            smetrics.KV_PAGE_EVICTIONS.labels(
                model=self.model, cause=cause).inc()
        return True

    def _take_pages(self, need: int) -> List[int]:
        while len(self._free) < need:
            if not self._evict_one("capacity"):
                raise PagesExhaustedError(
                    f"need {need} pages, {len(self._free)} free and "
                    f"nothing evictable ({self.n_pages} total)")
        return [self._free.pop() for _ in range(need)]

    # -- lease lifecycle --------------------------------------------------
    def acquire(self, slot: int, tokens: Sequence[int],
                span: int) -> Tuple[List[int], int]:
        """Lease ``span`` pages to ``slot`` for a prompt of ``tokens``:
        walk the radix tree along the FULL prompt pages, share every
        node found (refcount++), allocate private pages for the rest,
        and insert the new full prompt pages so later requests share
        them. Returns ``(pages, n_shared)`` -- ``pages[p]`` backs
        logical positions ``[p*page_size, (p+1)*page_size)`` of the
        slot; the first ``n_shared * page_size`` positions are already
        resident (the prefill skips their writes)."""
        if slot in self._slots:
            raise ValueError(f"slot {slot} already holds a page lease")
        tokens = [int(t) for t in tokens]
        full = min(len(tokens) // self.page_size, int(span))
        if span < 1:
            raise ValueError(f"span {span} < 1")
        # 1) longest shared prefix of full prompt pages
        chain: List[_Node] = []
        cur = self._root
        for p in range(full):
            key = tuple(tokens[p * self.page_size:
                               (p + 1) * self.page_size])
            child = cur.children.get(key)
            if child is None:
                break
            chain.append(child)
            cur = child
        n_shared = len(chain)
        # 2) PIN the chain, THEN allocate private pages: a refcount-0
        # chain node is an eviction candidate, and _take_pages must never
        # reclaim a page this admission is about to share (it would come
        # back as a private page of the same lease, and the prefill write
        # would clobber the shared prefix). Pinning first also makes
        # available_count() exact, so the check below guarantees
        # _take_pages succeeds without partial evictions.
        need = span - n_shared
        self._clock += 1
        for nd in chain:
            if nd.refs == 0:
                self._cached -= 1     # cache hit: resident page re-shared
            nd.refs += 1
            nd.last_use = self._clock
        try:
            if need > self.available_count():
                raise PagesExhaustedError(
                    f"admission needs {need} private pages ({span}-page "
                    f"span, {n_shared} shared), only {self.free_count()} "
                    f"free + {self._cached} evictable of {self.n_pages}")
            private = self._take_pages(need)
        except PagesExhaustedError:
            for nd in chain:          # unpin: failed admission is a no-op
                nd.refs -= 1
                if nd.refs == 0:
                    self._cached += 1
            raise
        # 3) insert the remaining FULL prompt pages (they hold exactly
        # page_size token-addressed rows once this admission's prefill
        # writes them) -- the tail (partial prompt page + generation
        # pages) is private forever
        nodes = list(chain)
        k = 0
        for p in range(n_shared, full):
            key = tuple(tokens[p * self.page_size:
                               (p + 1) * self.page_size])
            nd = _Node(key, private[k], cur)
            nd.refs = 1
            nd.last_use = self._clock
            cur.children[key] = nd
            cur = nd
            nodes.append(nd)
            k += 1
        tail = private[k:]
        pages = [nd.page for nd in nodes] + tail
        self._slots[slot] = _SlotLease(pages, nodes, tail, n_shared)
        self._publish()
        return pages, n_shared

    def release(self, slot: int):
        """Return ``slot``'s lease: tail pages go straight to the free
        list; tree pages drop a refcount and STAY RESIDENT at zero (the
        evictable prefix cache)."""
        lease = self._slots.pop(slot, None)
        if lease is None:
            return
        self._clock += 1
        for nd in reversed(lease.nodes):
            nd.refs -= 1
            if nd.refs == 0:
                nd.last_use = self._clock
                self._cached += 1
        self._free.extend(lease.tail)
        self._publish()

    def abort(self, slot: int):
        """Failed-admission release: the nodes THIS lease inserted hold
        pages its prefill never wrote, so unlike :meth:`release` they
        leave the tree and their pages go straight back to the free
        list (a later request with the same prompt must not share
        garbage K/V). Pre-existing shared nodes just drop a refcount."""
        lease = self._slots.pop(slot, None)
        if lease is None:
            return
        inserted = set(lease.nodes[lease.n_shared:])
        self._clock += 1
        for nd in reversed(lease.nodes):      # deepest-first: children
            nd.refs -= 1                      # drop before parents
            if nd.refs > 0:
                continue
            if nd in inserted and not nd.children:
                del nd.parent.children[nd.key]
                self._free.append(nd.page)
            else:
                nd.last_use = self._clock
                self._cached += 1
        self._free.extend(lease.tail)
        self._publish()

    def lease(self, slot: int) -> Optional[_SlotLease]:
        return self._slots.get(slot)

    def reset(self):
        """Drop every lease AND the prefix cache (engine reset: cached
        pages would alias stale K/V)."""
        self._slots.clear()
        n = sum(1 for _ in self._iter_nodes())
        if n and self.model:
            smetrics.KV_PAGE_EVICTIONS.labels(
                model=self.model, cause="reset").inc(n)
        self._root.children.clear()
        self._cached = 0
        self._free = list(range(self.n_pages))[::-1]
        self._publish()
