"""Byte-level BPE tokenizer: encode, decode, a trainer and a JSON file
format.

Port of the JAX package's ``runtime/tokenizer.py``: encode runs in the
native library (``native/tokenizer.cpp``, built and bound by
:mod:`autodist_tpu_torch.runtime.native`), with the bit-identical Python
path where the library is unavailable.  A
:class:`BPETokenizer` plugs into ``serve(tokenizer=...)`` so
``{"prompt": "text"}`` round-trips.  Files are the same
``autodist-bpe-v2`` JSON, so a file written by either package loads in
the other and encodes to the same ids.

Model: the 256 single bytes are the base vocabulary (ids 0..255 — every
string is encodable, no unknown tokens); ranked pair merges apply with
repeated-best-merge semantics (global lowest rank, leftmost occurrence
first) WITHIN pretoken segments.  Pretokenization is GPT-2-style — the
contraction/space pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?L+| ?N+| ?P+|
\\s+(?!\\S)|\\s+`` — as a hand-rolled byte-class scanner (L = ASCII
letters plus every byte >= 0x80, N = ASCII digits, \\s = ASCII
whitespace, P = the rest), no Unicode tables.  ``pretokenize=False``
keeps the whole-string behavior (and loads v1 files).

Special tokens are atomic strings with ids above the merge vocab.
``encode`` never produces them from plain text; ``encode(text,
with_special=True)`` splits on them first.  ``eos_id``/``pad_id``
surface ``<eos>``/``<pad>`` when registered — ``serving.server.serve``
wires ``eos_id`` into the engine.

Encode is heap-based best-merge — a (rank, pos) priority queue with lazy
invalidation over a linked symbol list, O(n log n) per segment.
"""
from __future__ import annotations

import ctypes
import heapq
import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.runtime import native

_BASE = 256

_SPACE = frozenset(b" \t\n\r\f\v")


def _cls(b: int) -> int:
    """Byte class: 0 space, 1 letter (ASCII alpha or >= 0x80), 2 digit,
    3 punct."""
    if b in _SPACE:
        return 0
    if 97 <= b <= 122 or 65 <= b <= 90 or b >= 0x80:
        return 1
    if 48 <= b <= 57:
        return 2
    return 3


def _contraction_len(data: bytes, i: int) -> int:
    """Length of a lowercase contraction ('s 't 'm 'd 're 've 'll) at
    ``i``, else 0."""
    n = len(data)
    if data[i] != 0x27 or i + 1 >= n:   # 0x27 = apostrophe
        return 0
    c = data[i + 1:i + 2]
    if c in (b"s", b"t", b"m", b"d"):
        return 2
    if data[i + 1:i + 3] in (b"re", b"ve", b"ll"):
        return 3
    return 0


def _pretokenize(data: bytes) -> List[Tuple[int, int]]:
    """GPT-2-style pretoken boundaries as (start, end) byte offsets."""
    segs: List[Tuple[int, int]] = []
    n, i = len(data), 0
    while i < n:
        cl = _contraction_len(data, i)
        if cl:
            segs.append((i, i + cl))
            i += cl
            continue
        if _cls(data[i]) == 0:
            j = i
            while j < n and _cls(data[j]) == 0:
                j += 1
            if j == n:            # trailing whitespace run: one token
                segs.append((i, j))
                break
            if j - i > 1:         # \s+(?!\S): all but the last space
                segs.append((i, j - 1))
                i = j - 1
                continue
            if data[i] != 0x20:   # the ' ?' prefix is a LITERAL space:
                segs.append((i, j))   # lone \t or \n is its own token
                i = j
                continue
            # single literal space before non-space: falls into ' ?class+'
        start = i
        if data[i] == 0x20:
            i += 1                # the ' ?' space (literal 0x20 only)
        cls = _cls(data[i])
        i += 1
        while i < n and _cls(data[i]) == cls:
            i += 1
        segs.append((start, i))
    return segs


class BPETokenizer:
    """``merges`` is rank-ordered ``(left_id, right_id, new_id)``; new ids
    must start at 256 (the byte base vocab is implicit).
    ``special_tokens`` maps literal strings to ids at/above the merge
    vocab (dense allocation via :meth:`add_special_tokens`)."""

    def __init__(self, merges: Sequence[Tuple[int, int, int]], *,
                 pretokenize: bool = True,
                 special_tokens: Optional[Dict[str, int]] = None):
        self.merges: List[Tuple[int, int, int]] = [
            (int(a), int(b), int(c)) for a, b, c in merges]
        self.pretokenize = bool(pretokenize)
        # token id -> bytes (decode table)
        self._bytes: List[bytes] = [bytes([i]) for i in range(_BASE)]
        for left, right, out in self.merges:
            if out != len(self._bytes):
                raise ValueError(
                    f"merge output ids must be dense from {_BASE}: "
                    f"expected {len(self._bytes)}, got {out}")
            if not (0 <= left < out and 0 <= right < out):
                raise ValueError(f"merge ({left},{right})->{out} refers "
                                 f"to an id not yet defined")
            self._bytes.append(self._bytes[left] + self._bytes[right])
        # (left, right) -> (rank, new_id); first rank wins on duplicates.
        self._ranks: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (left, right, out) in enumerate(self.merges):
            self._ranks.setdefault((left, right), (rank, out))
        self.special_tokens: Dict[str, int] = {}
        self._special_by_id: Dict[int, str] = {}
        for text, sid in (special_tokens or {}).items():
            self._register_special(text, int(sid))
        self._native: Optional[int] = None
        self._native_tried = False
        # encode() runs on concurrent server handler threads: one native
        # handle per tokenizer, made once
        self._native_lock = threading.Lock()

    def _register_special(self, text: str, sid: int) -> None:
        if sid < len(self._bytes):
            raise ValueError(
                f"special token {text!r} id {sid} collides with the "
                f"merge vocab (size {len(self._bytes)})")
        if not text:
            raise ValueError("special token text must be non-empty")
        if sid in self._special_by_id or text in self.special_tokens:
            raise ValueError(f"special token {text!r}/{sid} already "
                             f"registered")
        self.special_tokens[text] = sid
        self._special_by_id[sid] = text

    def add_special_tokens(self, texts: Sequence[str]) -> Dict[str, int]:
        """Register ``texts`` as atomic special tokens with dense ids
        above the current vocab; returns {text: id} for the new ones."""
        out = {}
        nxt = self.vocab_size
        for t in texts:
            self._register_special(t, nxt)
            out[t] = nxt
            nxt += 1
        return out

    @property
    def vocab_size(self) -> int:
        ids = self._special_by_id
        return max(ids) + 1 if ids else len(self._bytes)

    @property
    def eos_id(self) -> Optional[int]:
        return self.special_tokens.get("<eos>")

    @property
    def pad_id(self) -> Optional[int]:
        return self.special_tokens.get("<pad>")

    # -- encode / decode ---------------------------------------------------

    def encode(self, text: str, *, with_special: bool = False) -> List[int]:
        """Token ids for ``text``.  Plain encode never emits special
        ids — their literal text encodes as ordinary bytes; pass
        ``with_special=True`` to split on registered special strings
        first (longest-first, leftmost occurrence)."""
        if with_special and self.special_tokens:
            out: List[int] = []
            for part, sid in self._split_special(text):
                out.extend([sid] if sid is not None
                           else self._encode_plain(part))
            return out
        return self._encode_plain(text)

    def _split_special(self, text: str):
        """Yield (segment, None) / (special_text, id) pairs, scanning
        leftmost with longest-match on ties."""
        specials = sorted(self.special_tokens, key=len, reverse=True)
        pos = 0
        while pos < len(text):
            best, best_at = None, len(text)
            for s in specials:
                at = text.find(s, pos)
                if at != -1 and (at < best_at
                                 or (at == best_at
                                     and len(s) > len(best or ""))):
                    best, best_at = s, at
            if best is None:
                yield text[pos:], None
                return
            if best_at > pos:
                yield text[pos:best_at], None
            yield best, self.special_tokens[best]
            pos = best_at + len(best)

    def _get_native(self):
        """The native encoder's handle (made at first use), or None when
        the library is unavailable or there are no merges."""
        with self._native_lock:
            if not self._native_tried:
                self._native_tried = True
                lib = native.get_lib()
                if lib is not None and self.merges:
                    flat = np.asarray(self.merges, np.int32).reshape(-1)
                    self._native = lib.ad_bpe_create_v2(
                        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        len(self.merges), int(self.pretokenize))
            return self._native

    def _encode_plain(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        if not data:
            return []
        handle = self._get_native()
        if handle is None:
            return self._encode_py(data)
        out = np.empty(len(data), np.int32)
        n = native.get_lib().ad_bpe_encode(
            handle, data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out[:n].tolist()

    def _encode_py(self, data: bytes) -> List[int]:
        """The Python path: pretokenize, then merge each segment (the
        native encode's result, id for id)."""
        segs = _pretokenize(data) if self.pretokenize \
            else [(0, len(data))]
        out: List[int] = []
        for lo, hi in segs:
            out.extend(self._merge_segment(list(data[lo:hi])))
        return out

    def _merge_segment(self, ids: List[int]) -> List[int]:
        """Heap-based best-merge (see module docstring): pop candidates
        by (rank, pos), skip stale entries, push the two pairs a merge
        creates."""
        n = len(ids)
        if n < 2:
            return ids
        ranks = self._ranks
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        heap: List[Tuple[int, int, int, int]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j == -1:
                return
            r = ranks.get((ids[i], ids[j]))
            if r is not None:
                heap.append((r[0], i, ids[i], ids[j]))

        for i in range(n - 1):
            push(i)
        heapq.heapify(heap)
        while heap:
            _, i, a, b = heapq.heappop(heap)
            j = nxt[i]
            if ids[i] != a or j == -1 or ids[j] != b:
                continue   # stale
            ids[i] = ranks[(a, b)][1]
            k = nxt[j]
            ids[j] = -1    # tombstone
            nxt[i] = k
            if k != -1:
                prv[k] = i
            p = prv[i]
            if p != -1:
                r = ranks.get((ids[p], ids[i]))
                if r is not None:
                    heapq.heappush(heap, (r[0], p, ids[p], ids[i]))
            if k != -1:
                r = ranks.get((ids[i], ids[k]))
                if r is not None:
                    heapq.heappush(heap, (r[0], i, ids[i], ids[k]))
        i, out = 0, []
        while i != -1:
            out.append(ids[i])
            i = nxt[i]
        return out

    def decode(self, ids: Iterable[int]) -> str:
        ids = list(ids)
        parts: List[bytes] = []
        for i in ids:
            if i in self._special_by_id:
                parts.append(self._special_by_id[i].encode("utf-8"))
            elif 0 <= i < len(self._bytes):
                parts.append(self._bytes[i])
            else:
                raise ValueError(
                    f"token id {i} out of range for vocab_size "
                    f"{self.vocab_size} — is the model's vocab larger "
                    f"than the tokenizer's?")
        return b"".join(parts).decode("utf-8", errors="replace")

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "autodist-bpe-v2",
                       "merges": self.merges,
                       "pretokenize": self.pretokenize,
                       "special_tokens": self.special_tokens}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            obj = json.load(f)
        fmt = obj.get("format")
        if fmt == "autodist-bpe-v1":   # pre-pretokenization files
            return cls(obj["merges"], pretokenize=False)
        if fmt != "autodist-bpe-v2":
            raise ValueError(f"{path}: not an autodist-bpe file")
        return cls(obj["merges"],
                   pretokenize=obj.get("pretokenize", True),
                   special_tokens=obj.get("special_tokens") or None)

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int, *,
              pretokenize: bool = True,
              special_tokens: Sequence[str] = ()) -> "BPETokenizer":
        """Learn merges by iterated most-frequent-pair counting (the
        classic BPE trainer) until ``vocab_size`` is reached (special
        tokens excluded) or no pair repeats.  With pretokenization the
        corpus collapses to WEIGHTED UNIQUE pretokens — counting and
        merging touch each distinct word once per iteration, which is
        what makes multi-MB corpora practical in pure Python."""
        if vocab_size < _BASE:
            raise ValueError(f"vocab_size must be >= {_BASE}")
        # word (tuple of ids) -> count
        words: Dict[Tuple[int, ...], int] = {}
        for t in texts:
            if not t:
                continue
            data = t.encode("utf-8")
            segs = _pretokenize(data) if pretokenize \
                else [(0, len(data))]
            for lo, hi in segs:
                w = tuple(data[lo:hi])
                words[w] = words.get(w, 0) + 1
        merges: List[Tuple[int, int, int]] = []
        next_id = _BASE
        while next_id < vocab_size:
            counts: Dict[Tuple[int, int], int] = {}
            for w, c in words.items():
                for i in range(len(w) - 1):
                    pair = (w[i], w[i + 1])
                    counts[pair] = counts.get(pair, 0) + c
            if not counts:
                break
            # Deterministic: max count, ties by smallest pair ids.
            pair, cnt = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            if cnt < 2:
                break
            merges.append((pair[0], pair[1], next_id))
            new_words: Dict[Tuple[int, ...], int] = {}
            for w, c in words.items():
                i, out = 0, []
                while i < len(w):
                    if i + 1 < len(w) and (w[i], w[i + 1]) == pair:
                        out.append(next_id)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                nw = tuple(out)
                new_words[nw] = new_words.get(nw, 0) + c
            words = new_words
            next_id += 1
        tok = cls(merges, pretokenize=pretokenize)
        if special_tokens:
            tok.add_special_tokens(list(special_tokens))
        return tok

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if self._native is not None:
                lib = native.get_lib()
                if lib is not None:
                    lib.ad_bpe_destroy(self._native)
        except Exception:
            pass
