"""Paged KV cache: a block-pool allocator over preallocated device arenas.

The port of paddle_tpu/serving/kv_cache.py. Requests own fixed-size
BLOCKS of one shared physical arena through per-request block tables
(PagedAttention, vLLM SOSP '23); the pool is refcounted so full prompt
blocks can be shared copy-on-write across requests and retained by the
`PrefixIndex` after their writer finished (RadixAttention, SGLang 2024).

- `BlockPool` and `PrefixIndex` are host logic, copied from the JAX
  package unchanged: LIFO free list, block 0 reserved as the null block
  (padded batch slots and masked prefill tails write their garbage
  there), holder-list refcounts, LRU eviction of refcount-0 index
  leaves, `StaleIndexError` and `BlockLeakError`.
- `PagedKVCache` holds the device arenas: per layer, K and V as
  `[num_blocks, block_size, hidden]` torch tensors (the flat [*, N*H]
  minor layout the paged kernels read) on the engine's device.

The attention over this layout is `ops.paged_attention`.
"""
import torch

from ..device import resolve_device
from ..telemetry import mem_obs

__all__ = ["BlockPool", "BlockLeakError", "PagedKVCache", "NULL_BLOCK",
           "PrefixIndex", "StaleIndexError"]


class BlockLeakError(AssertionError):
    """`BlockPool.assert_quiesced` found blocks still referenced: some
    path (cancel, deadline expiry, eviction, engine restart, finish)
    dropped a request without returning its references to the pool.
    Blocks the PrefixIndex retains at refcount 0 are the CACHE, not a
    leak — only live references count."""


class StaleIndexError(RuntimeError):
    """The `PrefixIndex` is bound to a pool that is no longer the
    scheduler's pool: physical block ids in the index are invalid
    after an arena rebuild (warm restart / drain), and serving a
    request from them would splice another tenant's K/V into its
    attention. The engine must `flush()` + `bind()` the index whenever
    it rebuilds the arenas; this error is the tripwire for the path
    that forgot."""


# physical block 0 is never allocated: it is the write target for
# padded batch slots and masked prefill tails (their values are
# garbage by construction and never read back)
NULL_BLOCK = 0

_UNSET = object()


class BlockPool:    # guarded by: ServingEngine._mu
    """Refcounted free-list allocator over `num_blocks` physical blocks
    (block 0 reserved). Any free block serves any request — paging
    means fragmentation cannot strand capacity — and the LIFO
    discipline makes allocation deterministic under a replayed
    schedule.

    Block states:
    - FREE: on the free list;
    - HELD: one or more holders (`alloc` starts a block at one
      reference; `incref` adds sharers; `free` drops one reference
      each);
    - CACHED: retained by the `PrefixIndex` (`mark_cached`), possibly
      at refcount 0 — not allocatable, not a leak, reclaimed by index
      eviction (`release_cached`).
    """

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError(
                f"BlockPool needs >= 2 blocks (one is the reserved null "
                f"block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        # LIFO stack; low ids allocated first for readable tests
        self._free = list(range(self.num_blocks - 1, NULL_BLOCK, -1))
        self._holders = {}        # block id -> [owner tag, ...] (refcount)
        self._cached = set()      # blocks the PrefixIndex retains

    @property
    def capacity(self):
        """Allocatable blocks (the null block is not capacity)."""
        return self.num_blocks - 1

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        """Blocks with at least one live reference. Cached blocks at
        refcount 0 are NOT used (they are reclaimable cache), so the
        quiesce invariant `num_used == 0` stays meaningful under
        prefix sharing."""
        return len(self._holders)

    @property
    def num_cached(self):
        """Cached blocks with no live reference (the reclaimable
        prefix-cache footprint)."""
        return sum(1 for b in self._cached if b not in self._holders)

    @property
    def num_shared(self):
        """Blocks referenced by more than one holder right now — the
        `serving.prefix_blocks_shared` gauge, and the quantity the
        quiesce record must report as zero."""
        return sum(1 for h in self._holders.values() if len(h) > 1)

    def utilization(self):
        return (self.capacity - len(self._free)) / self.capacity

    def can_alloc(self, n):
        return len(self._free) >= n

    def alloc(self, n, owner=None):
        """Allocate `n` blocks for `owner` (one reference each).
        Returns the block-id list, or None when the pool cannot satisfy
        the request (the caller decides whether to evict cache entries
        or preempt; a partial allocation is never made)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self._free) < n:
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._holders[b] = [owner]
        return blocks

    def incref(self, blocks, owner=None):
        """Add `owner` as a holder of each block — the prefix-cache hit
        path: a request referencing already-computed blocks. Blocks
        must be live (held or cached); a free block has no content to
        share."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("incref of the reserved null block")
            holders = self._holders.get(b)
            if holders is None:
                if b not in self._cached:
                    raise ValueError(
                        f"incref of free/unallocated block {b}")
                self._holders[b] = [owner]
            elif owner in holders:
                raise ValueError(
                    f"owner {owner!r} already holds block {b}")
            else:
                holders.append(owner)

    def free(self, blocks, owner=_UNSET):
        """Drop ONE reference per block (finish/eviction/cancel
        reclaim). A block's last release returns it to the free list —
        unless the PrefixIndex retains it, in which case it parks as
        reclaimable cache. `owner` names whose reference to drop; when
        omitted it defaults to the sole holder (the pre-sharing calling
        convention) and a SHARED block refuses the ambiguity."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("attempt to free the reserved null block")
            holders = self._holders.get(b)
            if holders is None:
                if b in self._free:
                    raise ValueError(f"double free of block {b}")
                raise ValueError(f"free of unallocated block {b}")
            if owner is _UNSET:
                if len(holders) > 1:
                    raise ValueError(
                        f"free of shared block {b} (holders "
                        f"{list(holders)}) needs an explicit owner")
                holders.pop()
            else:
                if owner not in holders:
                    raise ValueError(
                        f"free of block {b}: {owner!r} is not a holder "
                        f"(holders {list(holders)})")
                holders.remove(owner)
            if not holders:
                del self._holders[b]
                if b not in self._cached:
                    self._free.append(b)

    def refcount(self, block):
        return len(self._holders.get(block, ()))

    def is_cached(self, block):
        return block in self._cached

    def is_private(self, block, owner):
        """True when `owner` is the SOLE reference and the index does
        not retain the block — the write-safety predicate: only a
        private block may be written in place; anything else must be
        forked first (copy-on-write)."""
        return (self._holders.get(block) == [owner]
                and block not in self._cached)

    def holders_of(self, block):
        """The full holder set of `block` (tuple, insertion order)."""
        return tuple(self._holders.get(block, ()))

    def owner_of(self, block):
        """The holder set of `block`: None when unheld, the sole owner
        tag when exactly one holder (the pre-sharing contract), else
        the tuple of every holder — leak reports under sharing must
        name ALL of them."""
        holders = self._holders.get(block)
        if not holders:
            return None
        if len(holders) == 1:
            return holders[0]
        return tuple(holders)

    def mark_cached(self, block):
        """The PrefixIndex retains `block`: it survives its holders'
        release (at refcount 0 it parks as reclaimable cache instead of
        returning to the free list)."""
        if block == NULL_BLOCK:
            raise ValueError("cannot cache the reserved null block")
        if block not in self._holders and block not in self._cached:
            raise ValueError(
                f"mark_cached of free/unallocated block {block}")
        self._cached.add(block)

    def release_cached(self, block):
        """The PrefixIndex dropped `block` (eviction or flush): when no
        request still references it, it returns to the free list."""
        if block not in self._cached:
            raise ValueError(f"release_cached of uncached block {block}")
        self._cached.discard(block)
        if block not in self._holders:
            self._free.append(block)

    def assert_quiesced(self):
        """Every block must be unreferenced — the leak check a quiesced
        engine (all requests terminal) runs at drain end, at drill
        quiesce, and at test teardown. Blocks the PrefixIndex retains
        at refcount 0 are cache, not a leak. Raises `BlockLeakError`
        naming EVERY holder of each leaked block (a block with refs>1
        names the full holder set, so the leak report stays actionable
        under copy-on-write sharing)."""
        if not self._holders:
            return
        by_owner = {}
        for b, holders in self._holders.items():
            for owner in holders:
                by_owner.setdefault(owner, []).append(b)
        detail = "; ".join(
            f"owner {owner!r} holds blocks {sorted(blocks)}"
            for owner, blocks in sorted(by_owner.items(), key=str))
        shared = {b: tuple(h) for b, h in self._holders.items()
                  if len(h) > 1}
        if shared:
            detail += "; shared (refs>1): " + ", ".join(
                f"block {b} held by {list(h)}"
                for b, h in sorted(shared.items()))
        raise BlockLeakError(
            f"{self.num_used} KV block(s) still referenced at quiesce: "
            f"{detail}")


class _PrefixNode:
    """One cached block: the trie edge into it is `chunk` (its
    block_size token ids, possibly only partially valid for the LAST
    tokens of a prompt — sharing still only ever reads the positions
    the matching prompt covers)."""

    __slots__ = ("chunk", "block", "children", "parent", "last_used")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.children = {}        # chunk tuple -> _PrefixNode
        self.parent = parent
        self.last_used = 0


class PrefixIndex:    # guarded by: ServingEngine._mu
    """Block-granular radix index over token-id chunks.

    Each trie edge is one FULL block of token ids; the node at its end
    names the physical block whose K/V rows hold exactly those tokens
    at those positions. Matching walks full-block chunks, then — for
    the remainder — takes the child sharing the longest common token
    prefix: its block is referenced PARTIALLY (the first `t` rows),
    which is what makes "start prefill at the first uncached token"
    literal rather than block-rounded. A match is always capped at
    `len(tokens) - 1` so at least one position is computed live (the
    next-token logits must come from somewhere).

    The index holds no references of its own — it RETAINS blocks via
    `BlockPool.mark_cached`, and `evict` reclaims LRU leaves whose
    refcount is 0 (a leaf some request still references is pinned:
    evicting it mid-decode is impossible by construction).

    Every mutating/reading entry point takes the caller's pool and
    verifies it is the bound pool: after an arena rebuild the physical
    ids here are fiction, and `StaleIndexError` is the tripwire for an
    engine path that rebuilt without `flush()` + `bind()`.
    """

    def __init__(self, block_size, pool=None):
        self.block_size = int(block_size)
        self._pool = pool
        self._root_children = {}  # chunk tuple -> _PrefixNode
        self._nodes = 0
        self._clock = 0           # LRU tick

    def bind(self, pool):
        """(Re)bind to the live pool — must follow every arena
        rebuild, after `flush()`."""
        self._pool = pool

    def _check(self, pool):
        if pool is not self._pool:
            raise StaleIndexError(
                "PrefixIndex is bound to a stale BlockPool: the arenas "
                "were rebuilt without flushing the index (its physical "
                "block ids no longer name this pool's storage)")

    @property
    def num_blocks(self):
        return self._nodes

    def _touch(self, node):
        self._clock += 1
        node.last_used = self._clock

    def match(self, tokens, pool):
        """Longest cached prefix of `tokens` -> (block ids, n_cached).

        Full-chunk matches walk the trie; the remainder may match the
        leading rows of one more cached block (the partial-tail case —
        the caller's first write into that block must copy-on-write
        fork it). `n_cached <= len(tokens) - 1` always, so prefill has
        at least one live position to compute logits from. The caller
        increfs the returned blocks for the requesting owner."""
        self._check(pool)
        tokens = list(tokens)
        bs = self.block_size
        blocks = []
        children = self._root_children
        pos = 0
        limit = len(tokens) - 1
        while pos + bs <= limit:
            chunk = tuple(tokens[pos:pos + bs])
            node = children.get(chunk)
            if node is None:
                break
            blocks.append(node.block)
            self._touch(node)
            children = node.children
            pos += bs
        # partial tail: the child sharing the longest common prefix
        # with the remaining tokens (capped so >= 1 token stays live)
        remainder = tokens[pos:pos + bs]
        best, best_t = None, 0
        for chunk, node in children.items():
            t = 0
            for a, b in zip(remainder, chunk):
                if a != b:
                    break
                t += 1
            t = min(t, limit - pos)
            if t > best_t:
                best, best_t = node, t
        if best is not None:
            blocks.append(best.block)
            self._touch(best)
            pos += best_t
        return blocks, pos

    def insert(self, tokens, blocks, pool):
        """Register `blocks[i]` as the cached K/V of the i-th FULL
        chunk of `tokens`. Idempotent: an existing node for a chunk
        keeps its block (the physical copies are interchangeable — the
        K/V of a token prefix is position-determined), and the caller's
        duplicate block simply stays private to it."""
        self._check(pool)
        tokens = list(tokens)
        bs = self.block_size
        n = min(len(blocks), len(tokens) // bs)
        children = self._root_children
        parent = None
        for i in range(n):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            node = children.get(chunk)
            if node is None:
                node = _PrefixNode(chunk, blocks[i], parent)
                children[chunk] = node
                self._nodes += 1
                pool.mark_cached(blocks[i])
            self._touch(node)
            parent = node
            children = node.children

    def _leaves(self):
        out = []
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict(self, n, pool):
        """Reclaim up to `n` blocks: LRU over refcount-0 LEAVES only —
        an interior node's block backs every cached suffix under it,
        and a leaf some request references is pinned (`refcount > 0`),
        which is what makes evicting a shared leaf under a mid-decode
        reader impossible. Returns the number of blocks actually
        returned to the free list.

        One trie walk per call: the evictable leaves go into a heap,
        and dropping a leaf only re-examines its parent (the single
        node the eviction can newly expose as a leaf) — nothing else
        mutates mid-call, so the walk never repeats."""
        self._check(pool)
        import heapq
        import itertools
        tie = itertools.count()
        heap = [(leaf.last_used, next(tie), leaf)
                for leaf in self._leaves()
                if pool.refcount(leaf.block) == 0]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            _, _, leaf = heapq.heappop(heap)
            self._drop(leaf, pool)
            freed += 1
            parent = leaf.parent
            if parent is not None and not parent.children and \
                    pool.refcount(parent.block) == 0:
                heapq.heappush(heap,
                               (parent.last_used, next(tie), parent))
        return freed

    def _drop(self, node, pool):
        if node.parent is None:
            del self._root_children[node.chunk]
        else:
            del node.parent.children[node.chunk]
        self._nodes -= 1
        pool.release_cached(node.block)

    def flush(self):
        """Drop every entry, releasing the retained blocks back to the
        bound pool — MANDATORY before an arena rebuild (warm restart)
        and at drain quiesce: physical ids do not survive either."""
        pool = self._pool
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if pool is not None:
                pool.release_cached(node.block)
        self._root_children = {}
        self._nodes = 0


class PagedKVCache:
    """Per-layer K/V arenas of shape [num_blocks, block_size, hidden]
    (`hidden` is n_heads * head_dim, kept flat).

    The arenas are updated IN PLACE — `index_put_` by the engine's
    prefill/decode writes, `copy_` by `copy_block` — where the JAX engine
    computes new arrays functionally, donates the old ones to the
    compiled step and installs the result through one `swap()`. Torch
    tensors are mutable, so the engine writes straight into them and no
    second arena ever exists. Zero-initialised, so every row a kernel can
    read (the null block included) holds finite values.
    """

    def __init__(self, num_layers, num_blocks, block_size, hidden,
                 dtype=torch.bfloat16, device=None):
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.hidden = int(hidden)
        self.dtype = dtype
        device = resolve_device(device)
        shape = (self.num_blocks, self.block_size, self.hidden)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(self.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(self.num_layers)]
        # memory-observatory tagging (telemetry/mem_obs): the ledger
        # attributes these arenas to the 'kv' bucket, queried fresh at
        # each snapshot. Weakref-owned: a warm restart builds a NEW
        # cache and drops this one, which must stay collectible
        mem_obs.register_provider("kv_cache.arenas", "kv", self,
                                  lambda cache: cache.k + cache.v)

    @property
    def nbytes(self):
        return sum(a.nbytes for a in self.k + self.v)

    def copy_block(self, src, dst):
        """Copy-on-write fork: physical block `src` -> `dst` in every
        layer's K and V arenas (all rows: positions the forking request
        has not covered yet stay masked by its context length until it
        overwrites them)."""
        for a in self.k + self.v:
            a[dst].copy_(a[src])

    @staticmethod
    def blocks_for_tokens(n_tokens, block_size):
        """Blocks needed to hold `n_tokens` positions."""
        return -(-int(n_tokens) // int(block_size))
