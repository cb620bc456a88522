"""Paged KV layout: fixed-size token-axis blocks — the port of
``repro.serve.paging`` (block pager, block tables, frame allocator).

Every cache leaf with a token axis (logical name ``seq_kv``) is split into
``block_tokens`` spans.  Block ``k`` of session ``rid`` covers decode
positions ``[k*bt, (k+1)*bt)`` and lives in the pool as object
``kv/<rid>/b<k>``: a LIST of the per-leaf token slices, in the reference's
leaf order, so the block objects (and their frames, CRCs and manifest
entries) are the same bytes in both packages.  The cache is append-only
along the token axis, so a block is immutable once the position passes
its upper edge: a commit re-flushes only the blocks touched since the last
one.  Per-session block tables ride in the manifest meta.

The pager works on the host: ``_host_leaves`` brings each leaf of a lane
copy over with ONE ``.cpu()``, counted by the caller's D2H counter.

**Content-addressed prefix blocks.**  A prompt-pure block (entirely inside
the prompt) is a deterministic function of (model identity, prompt prefix
up to its upper edge).  ``prefix_hash`` keys it as the pool object
``kvblk/<hash>``, published once, plus a ``kvhead/<hash-of-full-prompt>``
object holding the partial tail + recurrent state + first sampled token,
so a second engine serving the same prompt restores blocks and skips the
prefill (``serve.sessions`` ``publish_prefix`` / ``load_prefix``).  The
hash is the reference's (``zlib.crc32`` over the int32 token bytes), so
for equal keys the content addresses, and the frames, are the same.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.params import TensorSpec, tree_map_descs
from repro_torch.utils.tree import tree_flatten, tree_leaves

BLOCK_TOKENS = 16
#: ordinal of the recurrent-state pseudo-block (leaves with no token axis)
STATE_BLOCK = -1


def cache_token_axes(bundle):
    """Per-leaf index of the TOKEN axis (logical name ``seq_kv``) in the
    decode-cache pytree, or -1 for leaves without one."""
    return tree_map_descs(
        lambda d: d.logical.index("seq_kv") if "seq_kv" in d.logical else -1,
        bundle.cache_descs(1, 2))


def block_object_name(rid: str, blk: int, ns: str = "") -> str:
    """Pool object name of session ``rid``'s block ``blk`` under an engine
    namespace (``e<i>/``, empty for engine 0)."""
    if blk == STATE_BLOCK:
        return f"{ns}kv/{rid}/state"
    return f"{ns}kv/{rid}/b{blk}"


def shared_block_name(h: int) -> str:
    """Content-addressed prompt-prefix block (unnamespaced: the pool is
    the shared substrate)."""
    return f"kvblk/{h:08x}"


def shared_head_name(h: int) -> str:
    """Content-addressed prefill head: partial tail block + recurrent
    state + the first sampled token, keyed by the FULL prompt hash."""
    return f"kvhead/{h:08x}"


def prefix_hash(key: str, tokens: Sequence[int], block_tokens: int) -> int:
    """Content address of a prompt prefix under one model identity
    (``key`` names the weights: reuse across engines is sound only when
    their weights are bit-identical)."""
    doc = f"{key}|bt{block_tokens}|".encode()
    return zlib.crc32(np.asarray(tokens, np.int32).tobytes(), zlib.crc32(doc))


class OutOfBlocksError(RuntimeError):
    """The pool's hot block-frame budget is exhausted."""


class BlockAllocator:
    """Free-list over ``n_blocks`` frame ids: a frame is owned by at most
    one holder at any time."""

    def __init__(self, n_blocks: int):
        assert n_blocks >= 1, n_blocks
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._owned: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> frozenset:
        return frozenset(self._owned)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocksError(
                f"all {self.n_blocks} block frames are assigned")
        bid = self._free.pop()
        self._owned.add(bid)
        return bid

    def adopt(self, bid: int):
        """Claim a SPECIFIC frame id (a recovered block table)."""
        if not (0 <= bid < self.n_blocks):
            raise ValueError(f"bid {bid} outside pool of {self.n_blocks}")
        if bid in self._owned:
            raise OutOfBlocksError(f"bid {bid} is already assigned")
        self._owned.add(bid)
        self._free.remove(bid)

    def free(self, bid: int):
        if bid not in self._owned:
            raise ValueError(f"bid {bid} is not assigned")
        self._owned.discard(bid)
        self._free.append(bid)


@dataclasses.dataclass
class BlockRef:
    """One block-table entry: where block ``blk`` of a session lives."""
    blk: int                      # ordinal (STATE_BLOCK for recurrent state)
    bid: int                      # allocator frame id
    tokens: int                   # valid tokens in the span (0 for STATE)
    name: str                     # pool object name
    entry: Optional[dict] = None  # manifest entry once durable

    def to_meta(self) -> dict:
        return {"blk": self.blk, "bid": self.bid, "tokens": self.tokens,
                "name": self.name, "entry": self.entry}

    @classmethod
    def from_meta(cls, d: dict) -> "BlockRef":
        return cls(blk=int(d["blk"]), bid=int(d["bid"]),
                   tokens=int(d["tokens"]), name=d["name"],
                   entry=d.get("entry"))


@dataclasses.dataclass
class BlockTable:
    """Per-session block map: ``refs[k]`` covers tokens
    ``[k*bt, (k+1)*bt)``."""
    refs: Dict[int, BlockRef] = dataclasses.field(default_factory=dict)

    def to_meta(self) -> dict:
        return {"blocks": [self.refs[k].to_meta()
                           for k in sorted(self.refs)]}

    @classmethod
    def from_meta(cls, d: dict) -> "BlockTable":
        t = cls()
        for bd in d.get("blocks", ()):
            ref = BlockRef.from_meta(bd)
            t.refs[ref.blk] = ref
        return t

    def bids(self) -> List[int]:
        return [r.bid for r in self.refs.values()]

    def entries(self) -> Dict[str, dict]:
        """Manifest entries of every DURABLE block."""
        return {r.name: r.entry for r in self.refs.values()
                if r.entry is not None}


class BlockPager:
    """Host-side slicing / assembly between whole slot caches and token
    blocks (host torch tensors)."""

    def __init__(self, bundle, t_max: int,
                 block_tokens: int = BLOCK_TOKENS):
        assert block_tokens >= 1, block_tokens
        self.t_max = t_max
        self.block_tokens = block_tokens
        template = bundle.abstract_caches(1, t_max)
        self._leaves, self._treedef = tree_flatten(template)
        axes = tree_leaves(cache_token_axes(bundle))
        assert len(axes) == len(self._leaves)
        self._axes = [int(a) for a in axes]
        self.tok_idx = [i for i, a in enumerate(self._axes) if a >= 0]
        self.state_idx = [i for i, a in enumerate(self._axes) if a < 0]

        def _blk_spec(i):
            l = self._leaves[i]
            shape = list(l.shape)
            shape[self._axes[i]] = block_tokens
            return TensorSpec(tuple(shape), l.dtype)

        #: template of one block object (list of token slices)
        self.block_template = [_blk_spec(i) for i in self.tok_idx]
        self.state_template = [self._leaves[i] for i in self.state_idx]
        #: head object = tail block slices + recurrent state + token0
        self.head_template = (self.block_template + self.state_template
                              + [TensorSpec((1,), torch.int32)])

    # -- geometry ------------------------------------------------------------
    @property
    def token_nbytes(self) -> int:
        """Cache bytes per decode position across every token-axis leaf."""
        per = sum(s.nbytes for s in self.block_template)
        return max(1, per // self.block_tokens)

    def n_blocks(self, pos: int) -> int:
        return -(-pos // self.block_tokens) if pos > 0 else 0

    def tokens_in_block(self, blk: int, pos: int) -> int:
        return max(0, min(self.block_tokens, pos - blk * self.block_tokens))

    # -- slicing -------------------------------------------------------------
    def _host_leaves(self, cache1: Any,
                     to_host: Callable[[Any], Any] = lambda l: l.cpu()
                     ) -> List[torch.Tensor]:
        """Each leaf on the host, one ``.cpu()`` per leaf (``to_host`` is
        the caller's counted copy, ``TierManager.to_host``)."""
        leaves = tree_leaves(cache1)
        assert len(leaves) == len(self._leaves), \
            (len(leaves), len(self._leaves))
        return [to_host(l) for l in leaves]

    def slice_block(self, host: List[torch.Tensor], blk: int
                    ) -> List[torch.Tensor]:
        """Token slices of block ``blk`` over every token-axis leaf,
        zero-padded to ``block_tokens`` (one template fits every block,
        the partial tail included)."""
        bt = self.block_tokens
        lo = blk * bt
        out = []
        for i in self.tok_idx:
            a, ax = host[i], self._axes[i]
            n = max(0, min(bt, a.shape[ax] - lo))
            shape = list(a.shape)
            shape[ax] = bt
            part = torch.zeros(shape, dtype=a.dtype)
            if n:
                part.narrow(ax, 0, n).copy_(a.narrow(ax, lo, n))
            out.append(part)
        return out

    def slice_state(self, host: List[torch.Tensor]) -> List[torch.Tensor]:
        return [host[i].contiguous() for i in self.state_idx]

    def slice_dirty(self, cache1: Any, pos: int, table: BlockTable,
                    to_host: Callable[[Any], Any] = lambda l: l.cpu()
                    ) -> Dict[int, List[torch.Tensor]]:
        """Blocks needing (re)staging for a commit at position ``pos``:
        every span the position entered or grew inside since the block was
        last durable, plus the STATE pseudo-block."""
        host = self._host_leaves(cache1, to_host)
        out: Dict[int, List[torch.Tensor]] = {}
        for blk in range(self.n_blocks(pos)):
            want = self.tokens_in_block(blk, pos)
            ref = table.refs.get(blk)
            if ref is not None and ref.entry is not None \
                    and ref.tokens >= want:
                continue
            out[blk] = self.slice_block(host, blk)
        if self.state_idx:
            out[STATE_BLOCK] = self.slice_state(host)
        return out

    # -- assembly ------------------------------------------------------------
    def assemble(self, blocks: Dict[int, List[torch.Tensor]]) -> Any:
        """Rebuild a single-slot host cache from block payloads; unfilled
        positions are zeros, as in the source cache beyond its position."""
        bt = self.block_tokens
        leaves = [torch.zeros(l.shape, dtype=l.dtype) for l in self._leaves]
        for blk, parts in blocks.items():
            if blk == STATE_BLOCK:
                for i, part in zip(self.state_idx, parts):
                    leaves[i] = part.to(leaves[i].dtype)
                continue
            lo = blk * bt
            for i, part in zip(self.tok_idx, parts):
                ax = self._axes[i]
                hi = min(lo + bt, leaves[i].shape[ax])
                if hi <= lo:
                    continue
                leaves[i].narrow(ax, lo, hi - lo).copy_(
                    part.narrow(ax, 0, hi - lo))
        return self._treedef.unflatten(leaves)

    # -- prefix-reuse payloads ----------------------------------------------
    def head_payload(self, host: List[torch.Tensor], prompt_len: int,
                     tok0: int) -> List[torch.Tensor]:
        """The ``kvhead`` object: the partial tail block of the prompt (all
        zeros when the prompt length is block-aligned) + the recurrent
        state + the first sampled token."""
        tail = prompt_len // self.block_tokens
        return (self.slice_block(host, tail) + self.slice_state(host)
                + [torch.tensor([tok0], dtype=torch.int32)])

    def split_head(self, payload: List[torch.Tensor]):
        """Inverse of ``head_payload`` -> (tail slices, state, tok0)."""
        nt = len(self.tok_idx)
        ns = len(self.state_idx)
        return (payload[:nt], payload[nt:nt + ns],
                int(payload[nt + ns][0]))

    def prompt_block_hashes(self, key: str, prompt: Sequence[int]
                            ) -> List[int]:
        """Content hashes of every FULL prompt-pure block: block k is keyed
        by the prompt prefix up to its upper edge, so two prompts sharing a
        prefix share the early block objects."""
        bt = self.block_tokens
        return [prefix_hash(key, prompt[:(k + 1) * bt], bt)
                for k in range(len(prompt) // bt)]
