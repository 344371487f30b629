"""Slot-based request scheduler for continuous batching (port of
``repro/serve/scheduler.py``; the slot protocol is documented there).

In short: a request holds one decode slot from admission to eviction, the
decode batch is always (max_slots, 1), every page a request can need
(``ceil(budget / page_size)``, budget = min(plen + max_new - 1, max_len)
KV rows) is taken at admission, so an admitted request always finishes,
and a finished slot's pages go back to the free mask inside the decode
step.  The first token is sampled from the prefill logits, so a request
emits ``max_new`` tokens; a ``max_new = 1`` request completes at
admission.

Slot and page picks are stable argsorts over integer keys, so the first
free slot and the lowest free pages are taken, as in the JAX package.
:class:`HostLedger` replays that arithmetic on the host, so admission
needs no device read.  ``SlotState`` carries the serving slice of the
telemetry registry as its counter column (``tele``), which both steps
accumulate; its random state is a ``torch.Generator`` in place of a PRNG
key.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.obs import counters as obs_counters


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving shapes and policy knobs."""
    max_slots: int = 8          # decode batch width
    page_size: int = 16         # KV rows a page
    max_len: int = 256          # per-request KV row cap (prompt + gen)
    prompt_pad: int = 32        # static prefill width (prompts padded)
    num_pages: int = 0          # pool size; 0 -> worst-case full budget
    eos_id: int = -1            # sampled token that evicts; -1 = never
    temperature: float = 0.0    # 0 = argmax decoding
    kv_int8: bool = False       # int8 page pools + per-row scales
    attn: str = "ref"           # ref | pallas (K8 on the card)

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)

    @property
    def total_pages(self) -> int:
        return self.num_pages or self.max_slots * self.pages_per_slot


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    tokens: Tuple[int, ...]     # prompt token ids (1 <= len <= prompt_pad)
    max_new: int                # tokens to generate (incl. the admit token)


class SlotState(NamedTuple):
    """Per-slot device state, updated by the admit and decode steps."""
    tok: torch.Tensor       # (S, 1) int64  last emitted token a slot
    length: torch.Tensor    # (S,)   int32  valid KV rows a slot
    budget: torch.Tensor    # (S,)   int32  KV length at which the slot ends
    active: torch.Tensor    # (S,)   fp32   1 = live request
    req_id: torch.Tensor    # (S,)   int64  owning request
    alloc: torch.Tensor     # (S,)   int32  pages owned by the slot
    table: torch.Tensor     # (S, maxp) int32  page table
    free: torch.Tensor      # (N,)   fp32   free-page mask over the pool
    tele: dict              # obs counter column (the serve/* slice)
    gen: torch.Generator    # the sampling noise's generator


def init_slot_state(scfg: ServeConfig, gen: torch.Generator, device=None,
                    tele=None) -> SlotState:
    """An empty fleet; ``tele`` defaults to a zeroed serve column."""
    s, maxp, n = scfg.max_slots, scfg.pages_per_slot, scfg.total_pages
    if tele is None:
        tele = obs_counters.init_column("serve", None, device)
    i32 = dict(dtype=torch.int32, device=device)
    return SlotState(
        tok=torch.zeros((s, 1), dtype=torch.int64, device=device),
        length=torch.zeros((s,), **i32), budget=torch.zeros((s,), **i32),
        active=torch.zeros((s,), device=device),
        req_id=torch.full((s,), -1, dtype=torch.int64, device=device),
        alloc=torch.zeros((s,), **i32), table=torch.zeros((s, maxp), **i32),
        free=torch.ones((n,), device=device), tele=tele, gen=gen)


def kv_budget(plen: int, max_new: int, scfg: ServeConfig) -> int:
    """KV rows a request can occupy."""
    return min(plen + max_new - 1, scfg.max_len)


def pages_needed(plen: int, max_new: int, scfg: ServeConfig) -> int:
    return -(-kv_budget(plen, max_new, scfg) // scfg.page_size)


def pick_free_slot(active):
    """First inactive slot by a stable argsort of integer keys;
    (slot, has_slot) as 0-d tensors."""
    s = active.shape[0]
    idx = torch.arange(s, device=active.device)
    order = torch.argsort(torch.where(active > 0, s + idx, idx), stable=True)
    return order[0], active.sum() < s


def set_masked(x, index, value, mask):
    """``x.at[where(mask, index, n)].set(value, mode="drop")`` for a (n,)
    x: a copy with the masked-in indices set (one value for all of them)."""
    n = x.shape[0]
    buf = torch.cat([x, x.new_zeros(1)])
    buf.index_fill_(0, torch.where(mask, index, n).reshape(-1).long(), value)
    return buf[:n]


def take_pages(free, need, maxp):
    """Claim ``need`` pages from the free mask: a (maxp,) page row (unused
    tail 0), the feasibility flag and the updated mask.  Nothing is taken
    when infeasible."""
    n = free.shape[0]
    idx = torch.arange(n, device=free.device)
    order = torch.argsort(torch.where(free > 0, idx, n + idx), stable=True)
    ok = need <= free.sum()
    j = torch.arange(maxp, device=free.device)
    takes = (j < need) & ok
    pages = torch.where(takes, order[j.clamp(0, n - 1)], 0).to(torch.int32)
    return pages, ok, set_masked(free, pages, 0.0, takes)


def validate_request(r: Request, scfg: ServeConfig) -> None:
    plen = len(r.tokens)
    if not 1 <= plen <= scfg.prompt_pad:
        raise ValueError(f"req {r.req_id}: prompt length {plen} outside "
                         f"[1, prompt_pad={scfg.prompt_pad}]")
    if plen > scfg.max_len:
        raise ValueError(f"req {r.req_id}: prompt longer than max_len")
    if r.max_new < 1:
        raise ValueError(f"req {r.req_id}: max_new must be >= 1")
    if pages_needed(plen, r.max_new, scfg) > scfg.total_pages:
        raise ValueError(f"req {r.req_id}: needs more pages than the pool")


class HostLedger:
    """Host mirror of the device scheduler's admit / evict bookkeeping: the
    device picks the first free slot and the lowest free pages, so the host
    replays the same arithmetic to decide whether the next request fits,
    with no device read.  The engine checks that the device's ``ok`` and
    slot agree on every admit."""

    def __init__(self, scfg: ServeConfig):
        self.scfg = scfg
        self.free_pages = scfg.total_pages
        self.slot_pages = [0] * scfg.max_slots
        self.active = [False] * scfg.max_slots

    @property
    def n_active(self) -> int:
        return sum(self.active)

    def can_admit(self, need: int) -> bool:
        return (not all(self.active)) and need <= self.free_pages

    def next_slot(self) -> int:
        return self.active.index(False)

    def admit_at(self, slot: int, need: int) -> None:
        if self.active[slot] or need > self.free_pages:
            raise RuntimeError(f"slot {slot} or {need} pages not free")
        self.active[slot] = True
        self.slot_pages[slot] = need
        self.free_pages -= need

    def evict(self, slot: int) -> None:
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        self.active[slot] = False
        self.free_pages += self.slot_pages[slot]
        self.slot_pages[slot] = 0
