"""Paged KV cache for serving: block pool, prefix trie, paged programs.

Port of ``autodist_tpu/serving/paged_kv.py``:

* **Block pool.**  K/V live in ``[L, num_blocks, block_size, H, Dh]``
  pools.  A request's cache is a *block table* — the physical blocks
  backing its logical token positions — so freed requests return blocks
  to the pool immediately and total KV memory is sized to live tokens.
* **Refcounted sharing.**  :class:`BlockPool` refcounts blocks: a
  full prompt block can back many requests at once; the trie never
  shares a request's *last* prompt block, so every write a request
  performs lands in blocks it owns alone (no copy-on-write needed).
* **Prefix trie.**  :class:`PrefixTrie` maps chains of full token blocks
  to cached pool blocks: a request whose prompt starts with a cached
  chain prefills only its suffix, attending the cached blocks through
  its block table.
* **Paged device programs.**  :func:`_paged_chunk_program` /
  :func:`_paged_prefill_program` update the token buffer and the pools
  IN PLACE (``index_put_``), where the JAX programs relied on buffer
  donation.  Per-tick K/V writes scatter through ``(table[pos // bs],
  pos % bs)``; decode attention reads K/V straight through the block
  table with the paged-attention kernel (``ops/fused_kernels.py``) on
  the card, its gather-path plain version on the CPU.  Every masked-out
  write (dead slots, pad rows) goes to the scratch block.

The block math is the shared ``TransformerLayer`` (the ``attn_fn``
seam), so greedy paged output equals the per-request ``make_generator``
output token for token.  Every ``clip`` of the JAX programs is kept:
torch raises (CPU) or asserts on the device (CUDA) where JAX clamps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from autodist_tpu_torch.models.base import layer_norm
from autodist_tpu_torch.models.generate import (_d_ff, decode_layer,
                                                unpack_lm_params)
from autodist_tpu_torch.models.quantize import embed_lookup, head_logits
from autodist_tpu_torch.ops.fused_kernels import paged_attention
from autodist_tpu_torch.serving.engine import _sample_per_slot

#: physical block 0 is reserved as the scratch target: device programs
#: redirect every masked-out write (dead slots, pad rows) there, so a
#: freed block can be handed to a new owner between dispatches without
#: any risk of a stale slot scribbling on it.
SCRATCH_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """alloc() could not be satisfied even after trie eviction."""


@dataclass
class BlockPoolStats:
    allocs: int = 0               # blocks handed out
    frees: int = 0                # blocks returned to the free list
    exhaustions: int = 0          # alloc() failures (pool dry)
    high_water: int = 0           # max blocks simultaneously in use


class BlockPool:
    """Host-side allocator over the physical KV blocks.

    Pure bookkeeping — the device arrays live with the engine; the pool
    tracks which physical block indices are free, each block's
    refcount, and the alloc/free invariants the tests pin:

    * a block is either free (refcount 0, on the free list) or held
      (refcount >= 1), never both;
    * ``release`` frees exactly when the last reference drops;
    * block 0 (:data:`SCRATCH_BLOCK`) is reserved and never allocated.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks (one is the "
                             "reserved scratch block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list: recently freed blocks are re-used first (their
        # pool regions are most likely still resident in cache).
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: List[int] = [0] * num_blocks
        self.stats = BlockPoolStats()

    # -- capacity ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the scratch block)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.capacity - self.free_count

    def occupancy(self) -> float:
        return self.used_count / self.capacity if self.capacity else 0.0

    def blocks_for_tokens(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_size)

    # -- alloc / refcount --------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` blocks (each at refcount 1) or raise
        :class:`BlockPoolExhausted` allocating NONE (all-or-nothing, so
        a failed admission never leaks a partial allocation)."""
        if n < 0:
            raise ValueError("alloc needs n >= 0")
        if n > len(self._free):
            self.stats.exhaustions += 1
            raise BlockPoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(capacity {self.capacity})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.stats.allocs += n
        self.stats.high_water = max(self.stats.high_water, self.used_count)
        return out

    def retain(self, block: int) -> None:
        if self._refs[block] < 1:
            raise ValueError(f"retain on unallocated block {block}")
        self._refs[block] += 1

    def release(self, block: int) -> bool:
        """Drop one reference; True when this freed the block."""
        if block == SCRATCH_BLOCK:
            raise ValueError("release on the reserved scratch block")
        if self._refs[block] < 1:
            raise ValueError(f"release on free block {block} "
                             "(double free)")
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)
            self.stats.frees += 1
            return True
        return False

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def verify(self) -> None:
        """Leak/corruption check: every block is exactly free or held,
        and the free list is duplicate-free.  Raises AssertionError."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate blocks on free list"
        assert SCRATCH_BLOCK not in free, "scratch block on free list"
        for b in range(1, self.num_blocks):
            if b in free:
                assert self._refs[b] == 0, \
                    f"block {b} free but refcount {self._refs[b]}"
            else:
                assert self._refs[b] >= 1, \
                    f"block {b} leaked (not free, refcount 0)"


@dataclass
class _TrieNode:
    key: Tuple[int, ...]                    # the block's tokens
    block: int
    parent: Optional["_TrieNode"]
    children: Dict[Tuple[int, ...], "_TrieNode"] = field(
        default_factory=dict)
    last_used: float = field(default_factory=time.monotonic)


@dataclass
class PrefixTrieStats:
    hit_blocks: int = 0           # cached blocks handed to requests
    hit_tokens: int = 0
    lookups: int = 0
    lookup_hits: int = 0          # lookups that matched >= 1 block
    inserts: int = 0              # blocks newly cached
    evictions: int = 0            # cached blocks dropped under pressure


class PrefixTrie:
    """Radix cache over FULL prompt blocks.

    Each node caches one block's worth of tokens; a path from the root
    is a prompt prefix whose K/V already live in the pool.  The trie
    holds one pool reference per cached block (so a cached block
    survives its computing request); a matching request retains each
    matched block again for its own lifetime.  Only chains of FULL
    blocks are cached, and a match never covers the whole prompt
    (``match`` caps at ``floor((P-1)/bs)`` blocks) so every request
    prefills at least one suffix token — which also guarantees no
    request ever WRITES a shared block: its writes start at or after
    its suffix, which begins past the shared region.

    Eviction is LRU over refcount-1 leaf nodes — blocks only the trie
    still holds ("refcount-zero" from the requests' point of view);
    interior nodes wait for their children (a chain must stay
    root-connected to be matchable).
    """

    def __init__(self, pool: BlockPool):
        self._pool = pool
        self._root_children: Dict[Tuple[int, ...], _TrieNode] = {}
        self._count = 0
        self.stats = PrefixTrieStats()

    def __len__(self) -> int:
        return self._count

    def _chunks(self, tokens, limit_blocks: int):
        bs = self._pool.block_size
        out = []
        for i in range(limit_blocks):
            out.append(tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
        return out

    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached chain covering ``tokens`` (capped to leave at
        least one suffix token uncovered).  Returns ``(n_cached_tokens,
        block_ids)`` with each returned block RETAINED for the caller —
        symmetric with the caller releasing every block of its table on
        completion."""
        bs = self._pool.block_size
        p = len(tokens)
        limit = max((p - 1) // bs, 0)
        self.stats.lookups += 1
        now = time.monotonic()
        blocks: List[int] = []
        children = self._root_children
        for key in self._chunks(tokens, limit):
            node = children.get(key)
            if node is None:
                break
            node.last_used = now
            self._pool.retain(node.block)
            blocks.append(node.block)
            children = node.children
        if blocks:
            self.stats.lookup_hits += 1
            self.stats.hit_blocks += len(blocks)
            self.stats.hit_tokens += len(blocks) * bs
        return len(blocks) * bs, blocks

    def insert(self, tokens, table: List[int]) -> int:
        """Cache the full prompt blocks of a request whose K/V for
        ``tokens`` now live in ``table`` (its block table, in logical
        order).  Blocks newly cached are retained by the trie; chunks
        already cached are skipped (first writer wins — the duplicate
        block stays owned by its request alone and frees with it).
        Returns how many blocks were newly cached."""
        limit = max((len(tokens) - 1) // self._pool.block_size, 0)
        limit = min(limit, len(table))
        added = 0
        children = self._root_children
        parent: Optional[_TrieNode] = None
        for i, key in enumerate(self._chunks(tokens, limit)):
            node = children.get(key)
            if node is None:
                node = _TrieNode(key=key, block=table[i], parent=parent)
                self._pool.retain(table[i])
                children[key] = node
                self._count += 1
                added += 1
            children = node.children
            parent = node
        self.stats.inserts += added
        return added

    def evict(self, n: int) -> int:
        """Release up to ``n`` cached blocks, LRU-first among leaf
        nodes whose block only the trie still references.  Returns how
        many blocks were actually freed to the pool."""
        freed = 0
        while freed < n:
            victim = None
            for node in self._iter_nodes():
                if node.children:
                    continue                        # interior: keep chain
                if self._pool.refcount(node.block) != 1:
                    continue                        # pinned by a request
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._remove(victim)
            self._pool.release(victim.block)
            self.stats.evictions += 1
            freed += 1
        return freed

    def cached_blocks(self) -> List[int]:
        return [node.block for node in self._iter_nodes()]

    def _iter_nodes(self):
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _remove(self, node: _TrieNode) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._root_children)
        del siblings[node.key]
        self._count -= 1


# ---------------------------------------------------------------------------
# device programs: plain functions that update tokens and pools in place
# ---------------------------------------------------------------------------

def _paged_token_step(layer_params, ln_final_scale, embed, x, kc, vc,
                      bt, blk, off, rel):
    """One decode position through all layers over the PAGED cache.

    ``kc``/``vc``: [L, NB, BS, H, Dh] pools; ``bt``: [B, MAXB] int32
    block table; ``blk``/``off``: [B] physical write coordinates for this
    tick (pre-masked: dead slots point at the scratch block); ``rel``:
    [B] int32 logical sequence position (0 for dead slots, whose output
    is thrown away).  Each layer writes this tick's
    K/V into the pool in place, then attends through the table
    (:func:`~autodist_tpu_torch.ops.fused_kernels.paged_attention`).
    Returns logits [B, V]."""
    heads, hd = kc.shape[-2], kc.shape[-1]
    layer = decode_layer(heads, hd, _d_ff(layer_params))
    x = x[:, None, :]                                   # [B, 1, D]
    for i, lp in enumerate(layer_params):

        def paged_attn(q, k, v, causal, _i=i):
            kc[_i][blk, off] = k[:, 0].to(kc.dtype)
            vc[_i][blk, off] = v[:, 0].to(vc.dtype)
            return paged_attention(q[:, 0], kc[_i], vc[_i], bt,
                                   rel)[:, None]

        x = layer(lp, x, paged_attn)
    x = layer_norm(x, ln_final_scale)
    return head_logits(embed, x[:, 0])


@torch.no_grad()
def _paged_chunk_program(n: int, knobs, params, tokens, kc, vc, bt, start,
                         p_end, end, done, active, temp, eos, tick0: int,
                         rng, any_sampled: bool):
    """``n`` decode ticks of all slots in lockstep over the paged pool.

    Positions are LOGICAL (``rel = tick - start``; the block table is the
    indirection).  Token reads/writes index each slot's row at its own
    ``rel``; K/V writes route through the table with dead slots
    redirected to the scratch block.  ``tokens``, ``kc`` and ``vc`` are
    updated in place; every other tensor argument is a per-slot [B]
    vector (``bt`` [B, MAXB] int32) on the same device.  Nothing is read
    back to the host here: returns ``(done, busy)`` device tensors, the
    new done flags and the live slot-ticks.  ``knobs`` = (top_k, top_p,
    block_size)."""
    top_k, top_p, bs = knobs
    num_layers = kc.shape[0]
    slots, w = tokens.shape
    embed, pos_embed, layer_params, ln_final = unpack_lm_params(
        params, num_layers)
    rows = torch.arange(slots, device=tokens.device)
    bt_long = bt.long()
    busy = torch.zeros((), dtype=torch.int64, device=tokens.device)
    for i in range(n):
        t = tick0 + i
        rel = torch.clamp(t - start, 0, w - 1)              # [B] logical
        tok = tokens[rows, rel]
        x = embed_lookup(embed, tok, pos_embed.dtype) + pos_embed[rel]
        live = active & ~done
        blk = torch.where(live, bt_long[rows, rel // bs], SCRATCH_BLOCK)
        # a dead slot's logits are never sampled into a row (the token
        # write and the eos test below are gated on ``live``), so it
        # attends to position 0 only: the kernel walks one block for it
        # instead of up to the whole window
        logits = _paged_token_step(layer_params, ln_final, embed, x, kc, vc,
                                   bt, blk, rel % bs,
                                   torch.where(live, rel, 0).to(torch.int32))
        raw = _sample_per_slot(logits, rng, temp, top_k, top_p, any_sampled)
        busy = busy + live.sum()
        w_pos = torch.clamp(rel + 1, 0, w - 1)
        cur = tokens[rows, w_pos]
        in_gen = (t + 1) >= p_end
        tokens[rows, w_pos] = torch.where(in_gen & live, raw, cur)
        done = done | (in_gen & live & (raw == eos)) | ((t + 2) >= end)
    return done, busy


@torch.no_grad()
def _paged_prefill_program(knobs, params, tokens, kc, vc, chunk_kpb,
                           bt_rows, slot_ids, n_shared, c_lens, is_final,
                           temp, rng, any_sampled: bool):
    """One prefill CHUNK for K rows: a [K, Pb]-parallel causal forward
    over each row's next ``c_lens[k]`` uncharged prompt tokens, with
    everything already charged — trie-cached prefix blocks AND earlier
    chunks of the same prompt, both addressed by the row's block table
    masked to ``n_shared[k]`` tokens — attended as cached context.  That
    one mask makes prefix reuse and chunked prefill the same program.

    Suffix K/V scatter into the pools in place at logical positions
    ``n_shared + j`` through the block table (pad columns to the scratch
    block); rows with ``is_final`` (their last chunk) also sample their
    first generated token from the chunk's last position and deposit it
    at ``n_shared + c_len``.  Duplicate rows (pow-2 padding repeats the
    last row) write identical K/V to the same places; the token they
    deposit is read back as ``landed`` (returned, on the device).

    Only the last position's logits are computed: the every-position
    argmax the JAX program also returns serves speculative verify, which
    this port does not have yet.  ``knobs`` = (top_k, top_p,
    block_size)."""
    top_k, top_p, bs = knobs
    num_layers = kc.shape[0]
    heads, hd = kc.shape[-2], kc.shape[-1]
    k_rows, pb = chunk_kpb.shape
    maxb = bt_rows.shape[1]
    w = maxb * bs
    dev = tokens.device
    embed, pos_embed, layer_params, ln_final = unpack_lm_params(
        params, num_layers)
    layer = decode_layer(heads, hd, _d_ff(layer_params))
    cols = torch.arange(pb, device=dev)
    pos = n_shared[:, None] + cols[None, :]                 # [K, Pb]
    pos_ids = torch.clamp(pos, 0, pos_embed.shape[0] - 1)
    x = embed_lookup(embed, chunk_kpb, pos_embed.dtype) + pos_embed[pos_ids]
    ctx_mask = torch.arange(w, device=dev)[None, None, None, :] \
        < n_shared[:, None, None, None]                     # [K,1,1,W]
    causal_m = torch.ones((pb, pb), dtype=torch.bool, device=dev).tril()
    bt_long = bt_rows.long()
    ks, vs = [], []

    def capture_attn(q, k, v, causal):
        i = len(ks)
        ks.append(k)
        vs.append(v)
        scale = q.new_tensor(float(q.shape[-1])).sqrt()
        neg = torch.finfo(q.dtype).min
        sl = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        sl = torch.where(causal_m, sl, neg)
        kb = kc[i][bt_long].reshape(k_rows, w, heads, hd).to(q.dtype)
        vb = vc[i][bt_long].reshape(k_rows, w, heads, hd).to(q.dtype)
        pl = torch.einsum("bqhd,bphd->bhqp", q, kb) / scale
        pl = torch.where(ctx_mask, pl, neg)
        probs = torch.softmax(torch.cat([pl, sl], dim=-1).float(),
                              dim=-1).to(q.dtype)
        out = torch.einsum("bhqp,bphd->bqhd", probs[..., :w], vb)
        return out + torch.einsum("bhqk,bkhd->bqhd", probs[..., w:], v)

    for lp in layer_params:
        x = layer(lp, x, capture_attn)
    x = layer_norm(x, ln_final)

    valid = cols[None, :] < c_lens[:, None]
    blk = torch.where(
        valid, bt_long.gather(1, torch.clamp(pos // bs, 0, maxb - 1)),
        SCRATCH_BLOCK)
    off = pos % bs
    kc[:, blk, off] = torch.stack(ks).to(kc.dtype)          # [L,K,Pb,H,Dh]
    vc[:, blk, off] = torch.stack(vs).to(vc.dtype)

    last = x[torch.arange(k_rows, device=dev),
             torch.clamp(c_lens - 1, 0, pb - 1)]            # [K, D]
    logits = head_logits(embed, last)                       # [K, V]
    toks = _sample_per_slot(logits, rng, temp[slot_ids], top_k, top_p,
                            any_sampled)
    w_pos = torch.clamp(n_shared + c_lens, 0, tokens.shape[1] - 1)
    cur = tokens[slot_ids, w_pos]
    tokens[slot_ids, w_pos] = torch.where(is_final, toks, cur)
    return tokens[slot_ids, w_pos]


def _commit_tokens_program(tokens, rows, pos, vals) -> None:
    """Batched point-writes into the device token buffer, in place: one
    token per ``(rows[i], pos[i])`` pair (pow-2 padded by repeating the
    last entry: duplicate writes carry the same value)."""
    tokens[rows, pos] = vals.to(tokens.dtype)
