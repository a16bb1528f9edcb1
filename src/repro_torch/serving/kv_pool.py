"""Paged KV-cache pool: one shared block pool, per-request block tables,
refcounted copy-on-write pages for prefix sharing (port of
``repro/serving/kv_pool.py``).

A fixed pool of ``page_size``-token pages (int8 codes + f32 scales per
(token, kv-head), ``pos = -1`` marking an empty slot), an allocator with a
LIFO free list, and per-request block tables ``(R, max_blocks) int32``
that the paged attention kernels walk. Page 0 is RESERVED as the trash
page: unused block-table entries and pad writes point at it, its positions
stay -1, and the allocator hands out pages [1, P).

Device layout: one tensor per leaf with a leading LAYER axis,

  k / v          (L, P, K, page, hd) int8
  k/v_scale      (L, P, K, page)     f32
  pos            (L, P, page)        int32   (-1 = empty)

so one layer's cache is a view (:meth:`device_caches`), and a scrub or a
copy-on-write page copy is one indexed op over all layers. Unlike the
reference, whose functional pool hands arrays through a jitted step and
takes new ones back (``update_from``), the port's pool is written IN PLACE
by the model (``models.layers.paged_cache_update``), by :meth:`_decref`'s
scrub and by :meth:`_copy_page`; there is no ``update_from``.

Ownership model (the refcount state machine): every non-trash page carries
a host-side refcount, held by each active slot whose table names it and by
each live :class:`SharedPrefix`::

    free ──admit/append──▶ owned (1) ──share/fork──▶ shared (≥ 2)
    shared ──decref──▶ owned ──decref──▶ free (positions scrubbed)

Writes go only into pages the writer owns exclusively: :meth:`reserve_write`
copies a shared boundary page first (copy-on-write, positions at or past
the writer's length scrubbed in the copy). A page reaching refcount 0 is
scrubbed and freed; a double free is an assert.

Preemption swap: :meth:`PagedKVPool.export_slot` copies a slot's written
pages to host memory and :meth:`PagedKVPool.restore_slot` writes them back
into fresh pages, bit-identically; ``swap_bytes`` counts the host bytes
the snapshots hold. The disaggregated deployment restores a snapshot that
another pool exported: :meth:`PagedKVPool.adopt_snapshot` moves its bytes
onto the receiving pool's account, :meth:`PagedKVPool.discard_snapshot`
off the sender's.

Speculation's rollback: :meth:`PagedKVPool.truncate` scrubs a rejected
draft tail's positions and keeps its pages.

The sharded deployment (``mesh=``, a ``("kv", "model")`` mesh from
``launch.mesh.make_serving_mesh``): the page count is rounded up to a
multiple of the ``kv`` dim's size n, and rank i of that dim stores the
pages ``[i·P/n, (i+1)·P/n)`` of every layer, so its leaves are
``(L, P/n, ...)``. The host allocator, refcounts and block tables are the
same on every rank (every rank makes the same calls in the same order)
and name GLOBAL page ids. A write to a page (a scrub, a copy-on-write
copy, a restore) lands only on the rank that stores it; a read of pages
(a copy-on-write source, a swap export, :meth:`PagedKVPool.gather_dense`)
gathers them from their ranks exactly over the ``kv`` dim, so every rank
gets the same bytes. Sharding changes where pages live, never which
request owns them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, AttnSpec
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.paged_decode_attention import TRASH_PAGE
from repro_torch.launch.collectives import all_gather_tiled
from repro_torch.models.layers import PagedKVCache

DEFAULT_PAGE_SIZE = 16


class PoolExhaustedError(RuntimeError):
    """Raised when an admit/append needs more pages than the pool has free."""


def uniform_page_count(seq_len: int, page_size: int) -> int:
    """Pages needed to hold ``seq_len`` tokens in uniform ``page_size``
    pages (at least one)."""
    return max(1, -(-seq_len // page_size))


@dataclasses.dataclass
class SharedPrefix:
    """Handle to a pinned run of pool pages holding a shared prompt prefix:
    ``pages`` cover the first ``n_tokens`` tokens, and the handle owns one
    refcount reference per page until ``PagedKVPool.release_prefix``."""

    pages: tuple
    n_tokens: int
    released: bool = False

    @property
    def num_pages(self) -> int:
        return len(self.pages)


class PagedKVPool:
    """Fixed-size paged KV pool on ``device`` (``cuda`` unless the caller
    names another; raises with no card) + host-side refcounting block
    allocator (see the module docstring).

    ``cfg`` must be an attention-only pattern without sliding windows;
    ``num_blocks`` overrides ``cfg.num_blocks``, so a split engine's cloud
    pools only its own segment's layers. ``*_tokens``/``*_len`` arguments
    count TOKENS, ``*_pages`` count PAGES, ``*_bytes`` are device bytes
    across every layer the pool covers. ``mesh=`` shards the pages over
    the mesh's ``kv`` dim (the module docstring); ``num_pages`` then
    counts the whole pool's pages, rounded up to a multiple of that dim's
    size."""

    def __init__(self, cfg: ArchConfig, *, num_pages: int,
                 page_size: int = DEFAULT_PAGE_SIZE, max_requests: int,
                 max_seq_len: int | None = None, num_blocks: int | None = None,
                 mesh=None, device=None):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.mesh = mesh
        self.kv_rank, self.kv_size, self._kv_group = 0, 1, None
        if mesh is not None:
            from repro_torch.launch.mesh import check_serving_mesh, mesh_coords

            check_serving_mesh(mesh)
            self.kv_rank, self.kv_size, self._kv_group = \
                mesh_coords(mesh)["kv"]
            # the reference's rounding: extra pages enlarge the free list
            num_pages = -(-num_pages // self.kv_size) * self.kv_size
        specs = []
        for ls in cfg.pattern:
            m = ls.mixer
            if not isinstance(m, AttnSpec):
                raise NotImplementedError(
                    f"PagedKVPool covers attention-only patterns, got "
                    f"{m.kind}")
            if m.sliding_window is not None:
                raise NotImplementedError(
                    "sliding-window layers ring-write inside their window; "
                    "paged ring-append is not supported yet")
            specs.append(m)
        if len({(m.num_kv_heads, m.head_dim) for m in specs}) != 1:
            raise NotImplementedError(
                "pattern positions must share (num_kv_heads, head_dim)")

        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_requests = max_requests
        if max_seq_len is None:
            max_seq_len = (num_pages - 1) * page_size
        self.max_blocks = uniform_page_count(max_seq_len, page_size)
        nb = cfg.num_blocks if num_blocks is None else num_blocks
        self.num_layers = nb * len(cfg.pattern)
        kh, hd = specs[0].num_kv_heads, specs[0].head_dim
        self.kv_heads, self.head_dim = kh, hd

        # this rank's pages: the whole pool unless a mesh shards it
        self.shard_pages = num_pages // self.kv_size
        self._first_page = self.kv_rank * self.shard_pages
        shape = (self.num_layers, self.shard_pages, kh, page_size)
        dev = self.device
        self.k = torch.zeros(shape + (hd,), dtype=torch.int8, device=dev)
        self.v = torch.zeros(shape + (hd,), dtype=torch.int8, device=dev)
        self.k_scale = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.v_scale = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.pos = torch.full((self.num_layers, self.shard_pages, page_size),
                              -1, dtype=torch.int32, device=dev)

        # host allocator: LIFO free list (the most recently freed page is
        # reused first), trash page 0 excluded; refcounts 0 = free,
        # 1 = exclusively owned, >= 2 = shared (copy-on-write)
        self._free = list(range(num_pages - 1, 0, -1))
        self.refcount = np.zeros((num_pages,), np.int32)
        self.block_tables = np.zeros((max_requests, self.max_blocks),
                                     np.int32)
        self.lengths = np.zeros((max_requests,), np.int64)
        self.active = np.zeros((max_requests,), bool)
        # host BYTES held by export_slot snapshots not yet restored or
        # discarded (preemption swap)
        self.swap_bytes = 0

    # ------------------------------------------------------------ allocator

    @property
    def free_pages(self) -> int:
        """PAGES on the free list."""
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Allocated PAGES, each shared page counted once."""
        return (self.num_pages - 1) - len(self._free)

    @property
    def pages_shared(self) -> int:
        """PAGES referenced by more than one owner."""
        return int(np.sum(self.refcount > 1))

    def pages_for(self, n_tokens: int) -> int:
        """PAGES needed to hold ``n_tokens`` TOKENS (>= 1)."""
        return uniform_page_count(n_tokens, self.page_size)

    def _alloc(self) -> int:
        page = self._free.pop()
        assert self.refcount[page] == 0, f"free list held live page {page}"
        self.refcount[page] = 1
        return page

    def _decref(self, pages) -> None:
        """Drop one reference per page; pages reaching zero have their
        positions scrubbed to -1 on the device (all layers, one op, on the
        rank that stores them) and go back on the free list."""
        dead = []
        for p in pages:
            p = int(p)
            assert self.refcount[p] > 0, f"double free of page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                dead.append(p)
        if dead:
            _, local = self._own(dead)
            if local:
                self.pos[:, local] = -1
            self._free.extend(reversed(dead))

    def _copy_page(self, src: int, dst: int, keep_below: int) -> None:
        """Copy-on-write copy of page ``src`` → ``dst`` across every layer,
        keeping only stored positions < ``keep_below`` (the forker's own
        history; another tenant's later tokens are scrubbed in the copy).
        Under a mesh ``src`` is read from the rank that stores it."""
        *codes, src_pos = self._read_pages([src])
        self._write_pages([dst], (*codes, torch.where(src_pos < keep_below,
                                                      src_pos, -1)))

    # ------------------------------------------------------- page placement

    def _leaves(self) -> tuple:
        return (self.k, self.v, self.k_scale, self.v_scale, self.pos)

    def _own(self, pages) -> tuple:
        """(indices into ``pages`` of the pages this rank stores, their
        local ids in its leaves)."""
        lo, n = self._first_page, self.shard_pages
        mine = [(j, int(p) - lo) for j, p in enumerate(pages)
                if lo <= int(p) < lo + n]
        return [j for j, _ in mine], [q for _, q in mine]

    def _read_pages(self, pages) -> tuple:
        """The five leaves at the GLOBAL ``pages``, (L, n, ...) each on this
        rank's device, wherever each page is stored: under a mesh each rank
        puts the pages it stores into one exact all-gather a leaf over the
        ``kv`` dim, and every rank takes each page from its owner's block
        (every rank calls this with the same pages)."""
        if self.kv_size == 1:
            idx = to_device(np.asarray(pages, np.int64), self.device)
            return tuple(leaf[:, idx] for leaf in self._leaves())
        n = len(pages)
        rows, local = self._own(pages)
        owner = to_device(np.asarray(pages, np.int64) // self.shard_pages,
                          self.device)
        col = torch.arange(n, device=self.device)
        out = []
        for leaf in self._leaves():
            buf = leaf.new_zeros((leaf.shape[0], n) + tuple(leaf.shape[2:]))
            if rows:
                buf[:, rows] = leaf[:, local]
            g = all_gather_tiled(buf, 0, self._kv_group).reshape(
                (self.kv_size,) + tuple(buf.shape))
            out.append(g[owner, :, col].movedim(0, 1))
        return tuple(out)

    def _write_pages(self, pages, data) -> None:
        """Write ``data`` (five (L, n, ...) leaves, on the host or the
        device) to those of the GLOBAL ``pages`` that this rank stores."""
        rows, local = self._own(pages)
        if not rows:
            return
        idx = to_device(np.asarray(local, np.int64), self.device)
        for leaf, saved in zip(self._leaves(), data):
            leaf[:, idx] = saved[:, rows].to(self.device)

    def _write_need(self, length: int, have: int, boundary_shared: bool,
                    n_tokens: int):
        """(cow_pages, new_pages, want_pages) for writing ``n_tokens`` past
        ``length`` with ``have`` pages allocated, the boundary page shared
        or not: the one growth formula of :meth:`reserve_write` and
        :meth:`_fork_cost`."""
        if n_tokens <= 0:
            return 0, 0, have
        want = self.pages_for(length + n_tokens)
        boundary = length // self.page_size
        cow = 1 if (boundary < have and boundary_shared) else 0
        return cow, max(0, want - have), want

    def _fork_cost(self, prefix: SharedPrefix, target_tokens: int):
        """(pages needed from the free list now, eventual table pages) to
        admit ``target_tokens`` onto ``prefix``, the CoW copy of a partial
        boundary page included."""
        cow, new, want = self._write_need(
            prefix.n_tokens, prefix.num_pages, True,
            target_tokens - prefix.n_tokens)
        return cow + new, max(want, prefix.num_pages)

    def can_admit(self, n_tokens: int,
                  prefix: SharedPrefix | None = None) -> bool:
        """Whether :meth:`admit` for ``n_tokens`` TOKENS would succeed."""
        if self.active.all():
            return False
        if prefix is not None:
            if prefix.released or n_tokens < prefix.n_tokens:
                return False
            need, want = self._fork_cost(prefix, n_tokens)
        else:
            need = want = self.pages_for(n_tokens)
        return need <= len(self._free) and want <= self.max_blocks

    def admit(self, prompt_len: int, reserve_tokens: int | None = None,
              prefix: SharedPrefix | None = None) -> int:
        """Reserve a slot row and pages for ``max(prompt_len,
        reserve_tokens)`` TOKENS; returns the slot. With ``prefix`` the
        slot's leading table entries alias the prefix's pages (one
        reference each), its length starts at ``prefix.n_tokens``, and only
        the suffix pages (plus one CoW copy of a partial boundary page) are
        allocated. Capacity is checked before any state changes."""
        if prompt_len < 1:
            raise ValueError("cannot admit an empty prompt")
        free_slots = np.flatnonzero(~self.active)
        if free_slots.size == 0:
            raise PoolExhaustedError(
                f"no free request slots (all {self.max_requests} active)")
        target = max(prompt_len, reserve_tokens or 0)
        if prefix is not None:
            if prefix.released:
                raise ValueError("cannot admit onto a released SharedPrefix")
            if prompt_len < prefix.n_tokens:
                raise ValueError(
                    f"prompt ({prompt_len} tokens) shorter than its shared "
                    f"prefix ({prefix.n_tokens} tokens)")
            need, want = self._fork_cost(prefix, target)
            if want > self.max_blocks:
                raise PoolExhaustedError(
                    f"request needs {want} pages > max_blocks "
                    f"{self.max_blocks}")
            if need > len(self._free):
                raise PoolExhaustedError(
                    f"KV pool exhausted: fork needs {need} page(s) beyond "
                    f"the {prefix.num_pages} shared, {len(self._free)} free "
                    f"of {self.num_pages - 1}")
            slot = int(free_slots[0])
            self.active[slot] = True
            for b, p in enumerate(prefix.pages):
                self.block_tables[slot, b] = p
                self.refcount[p] += 1
            self.lengths[slot] = prefix.n_tokens
            self.reserve_write(slot, target - prefix.n_tokens)
            return slot
        need = self.pages_for(target)
        if need > self.max_blocks:
            raise PoolExhaustedError(
                f"prompt needs {need} pages > max_blocks {self.max_blocks}")
        if need > len(self._free):
            raise PoolExhaustedError(
                f"KV pool exhausted: prompt needs {need} page(s), "
                f"{len(self._free)} free of {self.num_pages - 1}")
        slot = int(free_slots[0])
        self.active[slot] = True
        self.lengths[slot] = 0
        self.reserve_write(slot, target)
        return slot

    def share_prefix(self, slot: int, n_tokens: int) -> SharedPrefix:
        """Pin ``slot``'s pages covering its first ``n_tokens`` TOKENS as a
        :class:`SharedPrefix` (one new reference per page, owned by the
        handle). The caller guarantees those tokens are written."""
        assert self.active[slot], f"slot {slot} is not active"
        if n_tokens < 1:
            raise ValueError("a shared prefix must cover at least one token")
        pages = [int(p) for p in
                 self.block_tables[slot][:self.pages_for(n_tokens)]]
        if TRASH_PAGE in pages:
            raise ValueError(
                f"slot {slot} has only "
                f"{int(np.count_nonzero(self.block_tables[slot]))} pages "
                f"allocated; cannot share a {n_tokens}-token prefix")
        for p in pages:
            self.refcount[p] += 1
        return SharedPrefix(tuple(pages), int(n_tokens))

    def release_prefix(self, prefix: SharedPrefix) -> None:
        """Drop the handle's page references (idempotent)."""
        if prefix.released:
            return
        prefix.released = True
        self._decref(prefix.pages)

    def reserve_write(self, slot: int, n_tokens: int) -> None:
        """Make the next ``n_tokens`` TOKEN positions of ``slot`` writable
        without changing its length: CoW-copy a shared boundary page, then
        allocate pages out to ``pages_for(length + n_tokens)``. All checks
        come before any state change."""
        assert self.active[slot], f"slot {slot} is not active"
        if n_tokens <= 0:
            return
        length = int(self.lengths[slot])
        have = int(np.count_nonzero(self.block_tables[slot]))
        boundary = length // self.page_size
        boundary_shared = (
            boundary < have
            and self.refcount[self.block_tables[slot, boundary]] > 1)
        cow, new_pages, want = self._write_need(length, have,
                                                boundary_shared, n_tokens)
        if want > self.max_blocks:
            raise PoolExhaustedError(
                f"request needs {want} pages > max_blocks "
                f"{self.max_blocks} (max_seq_len too small)")
        if cow + new_pages > len(self._free):
            raise PoolExhaustedError(
                f"KV pool exhausted: slot {slot} needs {cow + new_pages} "
                f"more page(s), {len(self._free)} free of "
                f"{self.num_pages - 1}")
        if cow:
            old = int(self.block_tables[slot, boundary])
            new = self._alloc()
            self._copy_page(old, new, keep_below=length)
            self.block_tables[slot, boundary] = new
            self._decref([old])
        for b in range(have, want):
            self.block_tables[slot, b] = self._alloc()

    def commit_prefill(self, slot: int, n_tokens: int) -> None:
        """Record that the request's first ``n_tokens`` TOKENS were written
        by a prefill (pages were reserved at admission)."""
        assert self.active[slot], f"slot {slot} is not active"
        length = int(self.lengths[slot])
        assert length <= n_tokens, \
            f"slot {slot} already holds {length} > {n_tokens} tokens"
        if self.pages_for(n_tokens) > int(
                np.count_nonzero(self.block_tables[slot])):
            self.reserve_write(slot, n_tokens - length)
        self.lengths[slot] = n_tokens

    def append(self, slot: int, n_tokens: int = 1) -> None:
        """Account ``n_tokens`` TOKENS about to be written to ``slot``
        (CoW and page growth as needed); raises ``PoolExhaustedError`` with
        no state change when the pool is full."""
        assert self.active[slot], f"slot {slot} is not active"
        self.reserve_write(slot, n_tokens)
        self.lengths[slot] = int(self.lengths[slot]) + n_tokens

    def truncate(self, slot: int, new_len: int) -> None:
        """Roll ``slot`` back to ``new_len`` TOKENS, speculation's rejection
        step: a verify round appends its draft burst, then truncates the
        rejected tail away. Stored positions ``>= new_len`` in the pages
        that cover them are scrubbed to -1 on the device (one op over all
        layers), so no later step, history walk or swap export sees a
        rejected token. The pages stay allocated: they lie inside the
        slot's reservation and the next append rewrites them.

        Only a page this slot owns alone is scrubbed. Drafts are written
        past any shared prefix, into exclusively owned (possibly CoW
        copied) pages, so a rollback into a page of refcount > 1 is a
        caller's fault: it raises ``ValueError`` and changes nothing."""
        assert self.active[slot], f"slot {slot} is not active"
        length = int(self.lengths[slot])
        if not 0 < new_len <= length:
            raise ValueError(f"truncate to {new_len} outside (0, {length}]")
        if new_len == length:
            return
        first = new_len // self.page_size  # the boundary page keeps a head
        pages = [int(p) for p in
                 self.block_tables[slot][first:self.pages_for(length)]
                 if p != TRASH_PAGE]
        shared = [p for p in pages if self.refcount[p] > 1]
        if shared:
            raise ValueError(
                f"truncate({slot}, {new_len}) would scrub shared page(s) "
                f"{shared} (refcount > 1): CoW-shared prefixes are "
                f"immutable")
        _, local = self._own(pages)
        if local:  # the pages this rank stores
            idx = to_device(np.asarray(local, np.int64), self.device)
            held = self.pos[:, idx]
            self.pos[:, idx] = torch.where(held >= new_len, -1, held)
        self.lengths[slot] = new_len

    def free(self, slot: int) -> None:
        """Return a finished request's page references: pages it owned
        alone are scrubbed and freed, shared ones survive."""
        assert self.active[slot], f"slot {slot} is not active"
        self._decref([int(p) for p in self.block_tables[slot]
                      if p != TRASH_PAGE])
        self.block_tables[slot] = TRASH_PAGE
        self.lengths[slot] = 0
        self.active[slot] = False

    # ------------------------------------------------------ preemption swap

    def export_slot(self, slot: int, n_tokens: int | None = None) -> dict:
        """Host snapshot of ``slot``'s WRITTEN pages (the first
        ``pages_for(n_tokens)`` table entries) for evict-to-queue
        preemption: ``{"length": tokens, "data": (k, v, k_scale, v_scale,
        pos)}``, CPU tensors with a leading layer axis and a page-run axis.
        Read-only: the slot stays live until the caller frees it.
        :meth:`restore_slot` puts it back bit-identically.

        ``n_tokens`` (TOKENS, default the slot's accounted length) lets the
        caller leave out positions it has appended but not yet written."""
        assert self.active[slot], f"slot {slot} is not active"
        n = int(self.lengths[slot]) if n_tokens is None else int(n_tokens)
        assert 1 <= n <= int(self.lengths[slot]), \
            f"cannot export {n} of slot {slot}'s {int(self.lengths[slot])}"
        pages = [int(p) for p in self.block_tables[slot][:self.pages_for(n)]]
        assert TRASH_PAGE not in pages, f"slot {slot} under-allocated"
        data = tuple(t.cpu() for t in self._read_pages(pages))
        snapshot = {"length": n, "data": data}
        self.swap_bytes += self.snapshot_bytes(snapshot)
        return snapshot

    @staticmethod
    def snapshot_bytes(snapshot: dict) -> int:
        """Host BYTES one :meth:`export_slot` snapshot holds."""
        return sum(t.numel() * t.element_size() for t in snapshot["data"])

    def discard_snapshot(self, snapshot: dict) -> None:
        """Drop a snapshot that will never be restored (its request was
        aborted while swapped out): releases its ``swap_bytes``."""
        self.swap_bytes -= self.snapshot_bytes(snapshot)
        assert self.swap_bytes >= 0, "snapshot discarded twice"

    def adopt_snapshot(self, snapshot: dict) -> None:
        """Take over the account of a snapshot that ANOTHER pool exported
        (the disaggregated deployment's page stream,
        ``page_transport.PageStreamTransport``): charges this pool's
        ``swap_bytes``, so that the :meth:`restore_slot` that consumes it
        balances. The exporting pool releases its side with
        :meth:`discard_snapshot`: one pool holds a snapshot's bytes at a
        time."""
        self.swap_bytes += self.snapshot_bytes(snapshot)

    def restore_slot(self, snapshot: dict,
                     reserve_tokens: int | None = None) -> int:
        """Re-admit a preempted request from an :meth:`export_slot`
        snapshot: allocates fresh pages (plus ``reserve_tokens`` of
        headroom, in TOKENS) and writes the saved codes, scales and
        positions back, so every later decoded token is bit-identical to
        the run that was never preempted (under a mesh each rank writes the
        fresh pages it stores). Returns the new slot; raises
        ``PoolExhaustedError`` (changing nothing) when the pool cannot hold
        it yet."""
        n = int(snapshot["length"])
        slot = self.admit(n, reserve_tokens=reserve_tokens)
        self._write_pages(
            [int(p) for p in self.block_tables[slot][:self.pages_for(n)]],
            snapshot["data"])
        self.lengths[slot] = n
        # the snapshot is consumed: its host bytes are no longer held
        self.swap_bytes -= self.snapshot_bytes(snapshot)
        assert self.swap_bytes >= 0, "snapshot restored twice"
        return slot

    # ----------------------------------------------------------- device views

    def device_caches(self, rows=None) -> list:
        """One :class:`~repro_torch.models.layers.PagedKVCache` per layer,
        views of the pool's tensors, with the CURRENT block tables of
        ``rows`` (default: every slot row) uploaded once and shared by all
        layers (asynchronously: no stream sync). Under a mesh the views
        hold this rank's page shard and the tables name global pages
        (``transformer.sharded_step_fns`` takes such caches)."""
        bt = self.block_tables if rows is None else self.block_tables[rows]
        bt = to_device(bt, self.device)
        return [PagedKVCache(self.k[i], self.v[i], self.k_scale[i],
                             self.v_scale[i], self.pos[i], bt)
                for i in range(self.num_layers)]

    def gather_dense(self, slot: int) -> tuple:
        """``slot``'s cache reassembled densely from its pages (tests):
        (k_codes, k_scale, v_codes, v_scale, pos), each with a leading
        layer axis: (L, K, nb·page, hd), (L, K, nb·page), …, (L, nb·page)."""
        def g(x):  # (L, nb, K, page, ...) → (L, K, nb·page, ...)
            if x.dim() == 3:  # positions (L, nb, page)
                return x.reshape(x.shape[0], -1)
            x = x.movedim(2, 1)
            return x.reshape(x.shape[0], x.shape[1], -1, *x.shape[4:])

        k, v, ks, vs, pos = self._read_pages(
            [int(p) for p in self.block_tables[slot]])
        return g(k), g(ks), g(v), g(vs), g(pos)

    # ----------------------------------------------------------- accounting

    def page_bytes(self) -> int:
        """Device BYTES of ONE page across every layer."""
        kh, hd, ps = self.kv_heads, self.head_dim, self.page_size
        return (2 * kh * ps * hd + 2 * kh * ps * 4 + ps * 4) * self.num_layers

    def page_bytes_written(self) -> int:
        """BYTES of the distinct pages that hold at least one token: what a
        page-level KV shipment moves (reserved but empty pages left out, a
        page shared between requests counted once)."""
        written: set = set()
        for slot in np.flatnonzero(self.active):
            n = int(self.lengths[slot])
            if n > 0:
                written.update(
                    int(p) for p in self.block_tables[slot][:self.pages_for(n)]
                    if p != TRASH_PAGE)
        return self.page_bytes() * len(written)

    def page_bytes_in_use(self) -> int:
        """Page-granular occupancy in BYTES (shared pages counted once)."""
        return self.pages_in_use * self.page_bytes()

    def eq2_bytes(self, qa_bits: int = 8) -> int:
        """The paper's analytical B_kv in BYTES (Eq. 2, ``core.opsc.
        kv_cache_bytes``) summed over resident requests at the pool's int8
        width: the LOGICAL total, which counts a shared prefix once per
        request that shares it."""
        from repro_torch.core.opsc import kv_cache_bytes

        total = 0
        for slot in np.flatnonzero(self.active):
            w = int(self.lengths[slot])
            if w > 0:
                total += kv_cache_bytes(w, self.num_layers, self.num_layers,
                                        self.kv_heads * self.head_dim,
                                        qa_bits, qa_bits)
        return total

    def occupancy(self) -> float:
        """Fraction of allocatable pages in use (shared pages once)."""
        return self.pages_in_use / max(1, self.num_pages - 1)

    def gauges(self) -> dict:
        """One consistent occupancy sample: page counts, the host bytes of
        swapped-out snapshots, occupancy and the page bytes resident on the
        device, all over the whole pool. Under a mesh also this rank's
        share: the pages in use it stores, their bytes, and the bytes of
        its leaves beside the whole pool's."""
        out = {"pages_in_use": self.pages_in_use,
               "pages_shared": self.pages_shared,
               "pages_free": self.free_pages,
               "swap_bytes": self.swap_bytes,
               "occupancy": self.occupancy(),
               "page_bytes_in_use": self.page_bytes_in_use()}
        if self.mesh is not None:
            lo, n, pb = self._first_page, self.shard_pages, self.page_bytes()
            shard = int(np.count_nonzero(self.refcount[lo:lo + n]))
            out.update(shard_pages_in_use=shard,
                       shard_page_bytes_in_use=shard * pb,
                       shard_device_bytes=n * pb,
                       pool_device_bytes=self.num_pages * pb)
        return out
