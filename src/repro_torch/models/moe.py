"""Top-k MoE FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``: GShard-style dropping).

  * the router's softmax in fp32, its top-k in ``lax.top_k``'s order (a
    stable descending sort: of equal probabilities the lower expert first),
    the k weights renormalised, and the Switch load-balance loss;
  * dispatch: a stable argsort of the (token, k) pairs by expert, each
    pair's rank within its expert, capacity C = tokens * top_k *
    capacity_factor / E rounded up to 8; a pair ranked past C goes to the
    drop slot E * C;
  * the expert SwiGLU as three batched matmuls over the dense (E, C, d)
    buffer (on a placed state, each data rank's block of the C slots);
  * the combine: each routed pair's weighted expert row, gathered back to
    its (token, k) place by the inverse of the dispatch permutation, then
    summed over the k choices.  JAX adds the rows into their tokens by a
    scatter-add (``.at[tok].add``); on CUDA ``index_add_`` does that with
    atomics in no fixed order (outside deterministic mode), so a replayed
    step would not be bitwise its eager run.  The gather and the sum over
    k are deterministic on every device; the sum's order differs from
    JAX's, within rounding.

It reads nothing back to the host: the capacity is a Python int of the
static shapes, the pairs' tokens an ``arange`` repeated an int number of
times, and no boolean mask indexes a tensor, so a forward through it can
be captured as a CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding import dtensor


def init_moe(generator, cfg, lead=()):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": dense_init(generator, (d, e), lead=lead),
            "wg": dense_init(generator, (e, d, ff), in_axis=1, lead=lead),
            "wu": dense_init(generator, (e, d, ff), in_axis=1, lead=lead),
            "wo": dense_init(generator, (e, ff, d), in_axis=1, lead=lead)}


def _capacity(n_tokens, cfg):
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(params, xf, cfg):
    """The router on (N, d) tokens -> (probs (N, E) fp32, top_p (N, K)
    renormalised, top_e (N, K) int64, aux loss)."""
    E, K = cfg.n_experts, cfg.top_k
    logits = (xf @ params["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
    experts = torch.arange(E, device=xf.device)
    frac = (top_e[..., None] == experts).float().sum(1).mean(0)
    aux = E * torch.sum(frac * probs.mean(0)) * cfg.router_aux_weight
    return probs, top_p, top_e, aux


def _dispatch_parts(top_e, N, cfg):
    """The stable sort of the (N * K) routed pairs by expert -> (order, the
    pairs' tokens in that order, the sorted experts, each expert's first
    place in that order (E,), each sorted pair's rank within its expert,
    keep, dest)."""
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(N, cfg)
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    flat_tok = torch.arange(N, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.arange(N * K, device=dev) - start[sorted_e]
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)
    return order, flat_tok[order], sorted_e, start, rank, keep, dest


def dispatch(top_e, N, cfg):
    """The sort-based dispatch of the (N * K) routed pairs -> (order, the
    pairs' tokens in that order, keep, dest): ``order`` sorts the pairs by
    expert (stable), ``dest`` is each sorted pair's row of the (E * C + 1)
    buffer, E * C where it is dropped."""
    order, tok, _, _, _, keep, dest = _dispatch_parts(top_e, N, cfg)
    return order, tok, keep, dest


def placed_dispatch(top_e, N, cfg):
    """The dispatch of a placed batch: its routing keys (a DTensor, the
    rows split over the data axes) gathered whole, N * K int32s, and sorted
    on every rank, so every rank holds the whole batch's ``dispatch`` (one
    global stable sort, the global capacity, the same drops) ->
    ``_dispatch_parts``."""
    keys = dtensor.whole_local(top_e.to(torch.int32)).long()
    return _dispatch_parts(keys, N, cfg)


def moe_fwd(params, x, cfg):
    """x: (B, S, d) -> (y, aux_loss)."""
    dtype = x.dtype
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    _, top_p, top_e, aux = route(params, xf, cfg)
    # the expert matmuls: on a placed state each data rank takes its block
    # of every expert's capacity slots and each "model" rank its experts,
    # with the expert weights gathered over the data axes (FSDP)
    wg, wu, wo = (dtensor.over_data(params[k].to(dtype))
                  for k in ("wg", "wu", "wo"))
    if dtensor.is_dtensor(top_e):
        out = _moe_placed(xf, top_p, top_e, (wg, wu, wo), N, cfg)
    else:
        eb, order, keep, dest = _dispatch_rows(xf, top_e, N, cfg)
        out = _combine(_experts(eb, wg, wu, wo), top_p, order, keep, dest,
                       N, cfg)
    return out.reshape(B, S, d), aux


def _experts(eb, wg, wu, wo):
    """The expert SwiGLU on the (E, C, d) buffer: three batched matmuls."""
    h = F.silu(torch.bmm(eb, wg)) * torch.bmm(eb, wu)
    return torch.bmm(h, wo)


def _dispatch_rows(xf, top_e, N, cfg):
    """The (E, C, d) expert buffer of the routed tokens and the dispatch
    (``dispatch``'s order, keep, dest)."""
    E, d = cfg.n_experts, xf.shape[1]
    C = _capacity(N, cfg)
    order, tok, keep, dest = dispatch(top_e, N, cfg)
    buf = xf.new_zeros((E * C + 1, d))
    buf[dest] = xf[tok]             # only the drop row takes duplicates
    return buf[:E * C].reshape(E, C, d), order, keep, dest


def _combine(eo, top_p, order, keep, dest, N, cfg):
    """Each routed pair's weighted (E, C, d) expert row gathered back to its
    (token, k) place, summed over k -> (N, d).  A dropped pair reads a row
    of its own, masked to 0, not one shared drop row: the gather's backward
    (a sort, then a serial sum over each run of equal indices) then meets
    no long run, and every value is what the drop row gave."""
    d = eo.shape[-1]
    eo = eo.reshape(-1, d)
    spread = torch.arange(dest.numel(), device=dest.device) % eo.shape[0]
    w = top_p.reshape(-1)[order].to(eo.dtype)
    gathered = torch.where(keep[:, None],                # sorted pair order
                           eo[torch.where(keep, dest, spread)] * w[:, None],
                           eo.new_zeros(()))
    inv = torch.argsort(order)                        # pair -> sorted place
    return gathered[inv].reshape(N, cfg.top_k, d).sum(1)


def _moe_placed(xf, top_p, top_e, weights, N, cfg):
    """The MoE on DTensors, partitioned as GSPMD partitions the reference's:
    the dispatch and the drops are the global ones, and only the rows
    move.

      * the routing keys (N * K ints) are gathered over the data axes, and
        every rank sorts them (``dispatch``: one global stable sort, the
        global capacity C), so every rank holds the same order and drops;
      * the tokens are gathered once over the data axes (as GSPMD gathers
        the operand of a gather whose indices are global; they are whole
        over "model" already), and each rank fills only its block of the
        (E, C, d) buffer: its experts over "model" (where the expert
        weights split there) and its capacity slots over the data axes;
      * the expert matmuls run on that block (``_experts``);
      * the combine: each rank adds the weighted rows of the slots it holds
        into their tokens' rows of an (N, d) partial (``_slot_combine``,
        by the map of slots to tokens the dispatch built: nothing of size
        N * K * d), and
        one reduce-scatter over the data axes (an all-reduce over "model")
        brings each token's sum to the ranks that hold its row.  The
        expert output is never gathered.

    Where the rank holds only some of the slots, the sum over a token's k
    choices runs across ranks, in another order than the plain path's
    (within rounding).  Where it holds them all (mesh (1, 1)), the combine
    is the plain path's ``_combine``, and the step is bitwise the plain
    one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    E, K, d = cfg.n_experts, cfg.top_k, xf.shape[1]
    C = _capacity(N, cfg)
    wg = weights[0]
    mesh = top_e.device_mesh
    names = mesh.mesh_dim_names or ()
    data = [i for i, n in enumerate(names) if n in dtensor.DP_AXES]
    n_data = 1
    for i in data:
        n_data *= mesh.size(i)
    experts = ([i for i, p in enumerate(wg.placements) if p == Shard(0)]
               if dtensor.is_dtensor(wg) else [])
    slots = data if C % n_data == 0 else []
    # the buffer's layout, and the mesh dims whose ranks each hold a part of
    # the sum (there a whole input's grad is a partial sum)
    eb_pl = [Shard(1) if i in slots else Shard(0) if i in experts
             else Replicate() for i in range(mesh.ndim)]
    split = set(slots) | set(experts)
    order, tok, _, start, _, keep, dest = placed_dispatch(top_e, N, cfg)
    e_lo, e_n = dtensor.piece(mesh, eb_pl, 0, E)
    c_lo, c_n = dtensor.piece(mesh, eb_pl, 1, C)
    at, held, rows = _slot_map(start, tok, N, K, (e_lo, e_n), (c_lo, c_n))
    xa = dtensor.whole_local(xf, split)
    eb_loc = torch.where(held[:, None], xa[rows],
                         xa.new_zeros(())).reshape(e_n, c_n, d)
    eb = DTensor.from_local(eb_loc, mesh, eb_pl, run_check=False,
                            shape=torch.Size((E, C, d)),
                            stride=(C * d, d, 1))
    eo = dtensor.redistribute(_experts(eb, *weights), mesh, eb_pl)
    eo_loc = eo.to_local(grad_placements=eb_pl)
    top_p = dtensor.whole_local(top_p, split)
    if e_n * c_n < E * C:
        w = top_p.reshape(-1)[order[at]].to(eo_loc.dtype)
        part = _slot_combine(eo_loc.reshape(-1, d), w, held, rows, N)
    else:
        # this rank holds every slot: the plain path's combine, bitwise
        part = _combine(eo_loc, top_p, order, keep, dest, N, cfg)
    return dtensor.sum_partial(part, mesh, split,
                               dtensor._row_placements(xf))


def _slot_map(start, tok, N, K, experts, slots):
    """The tokens of a block of the (E, C) slots, ``experts`` and ``slots``
    each (first, count), from the dispatch (each expert's ``start`` in the
    sorted order, the sorted pairs' ``tok``) -> (at, held, rows), each of
    the block's slots flattened: the sorted pair that fills it (clamped
    where none does), whether one does, and its token.  Slot c of expert e
    holds sorted pair start[e] + c if that pair is still e's.  An empty
    slot reads a token of its own (masked to 0 by its reader): the
    backward of a gather by ``rows`` (a sort, then a serial sum over each
    run of equal indices) then meets no long run."""
    (e_lo, e_n), (c_lo, c_n) = experts, slots
    dev = tok.device
    end = torch.cat([start[1:], start.new_full((1,), N * K)])
    e_ix = torch.arange(e_lo, e_lo + e_n, device=dev)[:, None]
    c_ix = torch.arange(c_lo, c_lo + c_n, device=dev)[None, :]
    at = start[e_ix] + c_ix
    held = (at < end[e_ix]).reshape(-1)
    at = at.clamp(max=N * K - 1).reshape(-1)
    spread = torch.arange(e_n * c_n, device=dev) % N
    return at, held, torch.where(held, tok[at], spread)


def _slot_combine(eo, w, held, rows, N):
    """The combine of the slots one rank holds: (S, d) expert rows ``eo``,
    each weighted by its pair's ``w`` where ``held``, added into its
    token's row (``rows``) of an (N, d) partial.  The adds are a
    deterministic scatter (``index_put`` with accumulation sorts the
    indices and sums each run in order; ``index_add_``'s atomics would
    not), so a replayed step stays bitwise its eager run; nothing of size
    N * K * d is formed."""
    y = torch.where(held[:, None], eo * w[:, None], eo.new_zeros(()))
    return eo.new_zeros((N, eo.shape[1])).index_put((rows,), y,
                                                    accumulate=True)
