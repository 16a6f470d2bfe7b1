"""Host-side paged-KV block manager.

The reference keeps allocator state in GPU tensors and mutates it with Triton
kernels to avoid host↔device syncs (swiftllm/worker/block_manager.py:13-41,
swiftllm/worker/kernels/block_mgmt.py). Here the split is the
opposite: allocation is trivially cheap on the host in numpy, and only the
dense per-batch page table is shipped to the device each step alongside the
rest of the batch metadata. No device kernels are involved in bookkeeping.

One instance manages one memory tier ("hbm" for the device cache, "cpu" for
the host swap space), mirroring the reference's two BlockManagers
(model.py:160-175).
"""

from __future__ import annotations

import numpy as np

from swiftllm_tpu_torch.utils import cdiv


class BlockManager:
    def __init__(self, tier: str, num_blocks: int, block_size: int,
                 max_seqs: int, max_blocks_per_seq: int,
                 enable_prefix_caching: bool = False):
        self.tier = tier
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq

        # Free pages kept as a LIFO stack for O(1) alloc/free.
        self._free_stack = list(range(num_blocks - 1, -1, -1))
        # Dense table: row = seq_id, cols = that sequence's page ids in order.
        self.block_table = np.zeros((max_seqs, max_blocks_per_seq), dtype=np.int32)
        self.num_seq_allocated_blocks = np.zeros(max_seqs, dtype=np.int32)

        # --- automatic prefix caching (opt-in; beyond the reference) ---------
        # Radix-style map of FULL prompt pages: key = (parent page id | -1,
        # tuple of the page's token ids) → page id. Keying on the PARENT PAGE
        # ID instead of the whole prefix keeps keys O(block_size) and
        # collision-free (a page id sits under exactly one content chain at a
        # time; its descendants' keys are dropped when it is evicted).
        # Pages carry refcounts; retired pages (rc=0) keep their KV data and
        # stay matchable in an LRU pool until allocation pressure evicts them.
        self.prefix_caching = enable_prefix_caching
        self._prefix_map: dict[tuple, int] = {}
        self._page_key: dict[int, tuple] = {}
        self._page_children: dict[int, set[int]] = {}
        self._page_rc: dict[int, int] = {}
        self._lru: dict[int, None] = {}   # insertion-ordered; oldest first

    # --- queries -------------------------------------------------------------
    @property
    def num_free_blocks(self) -> int:
        # Retired-but-cached pages are reclaimable on demand: count them free.
        return len(self._free_stack) + len(self._lru)

    def get_num_allocated_blocks(self, seq_id: int) -> int:
        return int(self.num_seq_allocated_blocks[seq_id])

    def seq_block_ids(self, seq_id: int) -> np.ndarray:
        return self.block_table[seq_id, : self.num_seq_allocated_blocks[seq_id]]

    def blocks_needed_for_len(self, seq_len: int) -> int:
        return cdiv(seq_len, self.block_size)

    # --- prefix-cache internals ------------------------------------------------
    def _unlink_key(self, page: int):
        """Drop ``page``'s map key and (iteratively — chains can be thousands
        of pages) every descendant's: a key chains through its parent's page
        id, so content below an evicted page is no longer addressable.
        Retired keyless descendants are plain free pages; move them to the
        stack."""
        stack = [page]
        while stack:
            p = stack.pop()
            key = self._page_key.pop(p, None)
            if key is not None:
                self._prefix_map.pop(key, None)
                parent = key[0]
                if parent >= 0:
                    ch = self._page_children.get(parent)
                    if ch:
                        ch.discard(p)
            for c in self._page_children.pop(p, ()):
                stack.append(c)
                if c in self._lru:
                    del self._lru[c]
                    self._free_stack.append(c)

    def _pop_free_page(self) -> int:
        if self._free_stack:
            p = self._free_stack.pop()
        else:   # reclaim the least-recently-retired cached page
            p = next(iter(self._lru))
            del self._lru[p]
            self._unlink_key(p)
        self._page_rc[p] = 1
        return p

    def _release_page(self, p: int):
        rc = self._page_rc.get(p, 1) - 1
        if rc > 0:
            self._page_rc[p] = rc
            return
        self._page_rc.pop(p, None)
        if p in self._page_key:   # retired but matchable: park in the LRU
            self._lru[p] = None
        else:
            self._free_stack.append(p)

    def match_prefix(self, seq_id: int, token_ids: list[int],
                     namespace: int = 0) -> int:
        """Install the longest cached chain of FULL prompt pages into
        ``seq_id``'s (empty) page list. Returns the number of prompt tokens
        thereby already cached — always < len(token_ids), so at least one
        token of real prefill remains to produce next-token logits.

        ``namespace`` partitions chains whose KV differs for identical tokens
        (e.g. the LoRA adapter slot — adapters change the k/v projections, so
        pages must never be shared across them). Encoded in the root parent
        id (-1 - namespace); descendants inherit it through the chain."""
        if not self.prefix_caching:
            return 0
        assert self.num_seq_allocated_blocks[seq_id] == 0
        ps = self.block_size
        usable = min((len(token_ids) - 1) // ps, self.max_blocks_per_seq)
        parent, matched = -1 - namespace, []
        for i in range(usable):
            page = self._prefix_map.get(
                (parent, tuple(token_ids[i * ps:(i + 1) * ps])))
            if page is None:
                break
            matched.append(page)
            parent = page
        if not matched:
            return 0
        for p in matched:
            rc = self._page_rc.get(p, 0)
            if rc == 0:   # retired: revive from the LRU pool
                del self._lru[p]
            self._page_rc[p] = rc + 1
        self.block_table[seq_id, :len(matched)] = matched
        self.num_seq_allocated_blocks[seq_id] = len(matched)
        return len(matched) * ps

    def register_prefix(self, seq_id: int, token_ids: list[int], upto: int,
                        namespace: int = 0):
        """Make ``seq_id``'s full prompt pages (tokens [0, upto) are written
        as of the step just dispatched) matchable by future requests. Safe
        because matching happens at ADMISSION, strictly before the next
        step's batch is built — a page is never read by one sequence in the
        same step another writes it."""
        if not self.prefix_caching:
            return
        ps = self.block_size
        full = min(upto, len(token_ids)) // ps
        pages = self.block_table[seq_id]
        parent = -1 - namespace
        for i in range(full):
            p = int(pages[i])
            if p in self._page_key:   # already registered (matched or earlier chunk)
                parent = p
                continue
            key = (parent, tuple(token_ids[i * ps:(i + 1) * ps]))
            other = self._prefix_map.get(key)
            if other is not None:
                # Identical content raced in another sequence's pages this
                # step; keep the canonical page and chain below it.
                parent = other
                continue
            self._prefix_map[key] = p
            self._page_key[p] = key
            if parent >= 0:
                self._page_children.setdefault(parent, set()).add(p)
            parent = p

    # --- mutation --------------------------------------------------------------
    def allocate_for_seq(self, seq_id: int, target_len: int):
        """Grow seq_id's page list so it can hold ``target_len`` tokens.

        Monotonic like the reference (block_manager.py:70-73): a sequence's page
        count never shrinks except via :meth:`free_seq`.
        """
        have = int(self.num_seq_allocated_blocks[seq_id])
        need = self.blocks_needed_for_len(target_len)
        grow = need - have
        if grow <= 0:
            return
        if grow > self.num_free_blocks:
            raise RuntimeError(
                f"[{self.tier}] out of KV pages: need {grow}, free {self.num_free_blocks} "
                f"(seq {seq_id}, target_len {target_len})")
        if need > self.max_blocks_per_seq:
            raise RuntimeError(
                f"[{self.tier}] seq {seq_id} needs {need} pages > max_blocks_per_seq "
                f"{self.max_blocks_per_seq}")
        for i in range(have, need):
            self.block_table[seq_id, i] = self._pop_free_page()
        self.num_seq_allocated_blocks[seq_id] = need

    def free_seq(self, seq_id: int) -> np.ndarray:
        """Release all of seq_id's pages (refcount-aware: pages shared via
        prefix caching survive until their last holder frees them); returns
        the page ids in order."""
        n = int(self.num_seq_allocated_blocks[seq_id])
        ids = self.block_table[seq_id, :n].copy()
        for b in ids:
            self._release_page(int(b))
        self.num_seq_allocated_blocks[seq_id] = 0
        return ids

    def gather_and_free(self, seq_id: int) -> np.ndarray:
        """Swap-out half: emit the page-id list and free it (reference
        block_manager.py:81-96)."""
        return self.free_seq(seq_id)

    def allocate_fresh_for_seq(self, seq_id: int, seq_len: int) -> np.ndarray:
        """Swap-in half: allocate pages for a sequence arriving from the other
        tier; returns the new page ids in order."""
        assert self.num_seq_allocated_blocks[seq_id] == 0
        self.allocate_for_seq(seq_id, seq_len)
        return self.seq_block_ids(seq_id).copy()
