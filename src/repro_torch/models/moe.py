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


def dispatch(top_e, N, cfg):
    """The sort-based dispatch of the (N * K) routed pairs -> (order, the
    pairs' tokens in that order, keep, dest): ``order`` sorts the pairs by
    expert (stable), ``dest`` is each sorted pair's row of the (E * C + 1)
    buffer, E * C where it is dropped."""
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
    return order, flat_tok[order], keep, dest


def moe_fwd(params, x, cfg):
    """x: (B, S, d) -> (y, aux_loss)."""
    dtype = x.dtype
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    _, top_p, top_e, aux = route(params, xf, cfg)
    # the sort-based dispatch and the combine's gathers have no DTensor
    # sharding strategy: on DTensors they run on the gathered tokens, so
    # every rank routes the whole batch as the reference does (ROADMAP §3).
    # The expert matmuls are data parallel: each data rank takes its block
    # of every expert's capacity slots, with the expert weights gathered
    # over the data axes (FSDP) and split over "model" as placed
    eb, order, keep, dest = dtensor.local_op(
        lambda xs, te: _dispatch_rows(xs, te, N, cfg), xf, top_e)
    eb = dtensor.over_data(eb, 1)
    wg, wu, wo = (dtensor.over_data(params[k].to(dtype))
                  for k in ("wg", "wu", "wo"))
    h = F.silu(torch.bmm(eb, wg)) * torch.bmm(eb, wu)
    eo = torch.bmm(h, wo)
    out = dtensor.local_op(
        lambda *a: _combine(*a, N, cfg), eo, top_p, order, keep, dest)
    return out.reshape(B, S, d), aux


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
    (token, k) place, summed over k -> (N, d)."""
    d = eo.shape[-1]
    eo = torch.cat([eo.reshape(-1, d), eo.new_zeros((1, d))], dim=0)
    w = (top_p.reshape(-1)[order] * keep).to(eo.dtype)
    gathered = eo[dest] * w[:, None]                  # sorted pair order
    inv = torch.argsort(order)                        # pair -> sorted place
    return gathered[inv].reshape(N, cfg.top_k, d).sum(1)
