"""Token-choice top-k Mixture-of-Experts with sort-based capacity dispatch
(port of `repro.models.moe`).

Dispatch: flatten the (token, choice) pairs, sort them by expert id
(stably, as ``jnp.argsort`` does), rank each pair within its expert's
group, drop ranks ≥ capacity, write the kept tokens into an (E, cap, d)
buffer, run the expert SwiGLU as batched products over the experts, and
gather each token's k pairs back to weigh them by their router
probabilities and sum them in a fixed order.  Memory is O(T·k + E·cap·d).

The products are plain ``torch.bmm`` (the JAX package's are ``jnp``
einsums, no Pallas kernel); a grouped-expert kernel is later work
(ROADMAP §2).  Nothing here uses atomics: the combine is a gather and a
sum over k, so a token's output is the same run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal_init


def moe_init(gen, d_model: int, d_ff: int, num_experts: int, dtype, device,
             lead: tuple = ()) -> dict:
    """The router (f32, N(0, 1)/√d) and the E experts' SwiGLU weights,
    with ``lead`` stacked axes in front; the experts are drawn a slice at a
    time (`normal_init`)."""
    e = num_experts
    return {
        "router": dense_init(gen, d_model, e, torch.float32, device, lead),
        "w_gate": normal_init(gen, (*lead, e, d_model, d_ff),
                              d_model ** -0.5, dtype, device),
        "w_up": normal_init(gen, (*lead, e, d_model, d_ff),
                            d_model ** -0.5, dtype, device),
        "w_down": normal_init(gen, (*lead, e, d_ff, d_model),
                              d_ff ** -0.5, dtype, device),
    }


def _capacity(T: int, top_k: int, E: int, capacity_factor: float) -> int:
    """Expected load × factor, floored at min(T, 16) so that tiny batches
    (decode: T = B) are drop-free: a token loads an expert at most once,
    so cap ≥ T drops nothing whatever the routing."""
    return int(max(-(-T * top_k // E) * capacity_factor, min(T, 16), 1))


def _slots(top_e: torch.Tensor, E: int, cap: int):
    """Each (token, choice) pair's slot in its shard's flattened (E·cap)
    buffer, in the pairs' own order.  top_e: (S, Tl, k).  Returns
    ``(slot, keep)``, both (S, Tl·k): a kept pair's slot is e·cap + its
    rank among the pairs routed to e (in pair order, as JAX's stable sort
    ranks them); a dropped pair's is E·cap, a spare row."""
    S = top_e.shape[0]
    flat_e = top_e.reshape(S, -1)
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=flat_e.device).expand(S, E).contiguous()
    group_start = torch.searchsorted(se, experts)           # left side
    rank_sorted = (torch.arange(n, device=flat_e.device)
                   - torch.gather(group_start, 1, se))
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < cap
    return torch.where(keep, flat_e * cap + rank, E * cap), keep


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, shards: int = 1,
              shard_axes=None):
    """x: (T, d) -> (y (T, d), aux: the load-balance loss, f32 scalar).

    ``shards``: tokens are dispatched within T/shards groups, each with
    its own capacity, as JAX's are (it maps the groups onto its mesh's data
    axis).  ``shard_axes`` is JAX's mesh sharding hint; one card has no
    mesh, so it is taken and ignored."""
    del shard_axes
    T, d = x.shape
    E = params["router"].shape[-1]
    if T % shards != 0:
        shards = 1
    Tl = T // shards

    probs = torch.softmax(x.to(torch.float32) @ params["router"], dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)                  # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load balance: E · Σ_e fraction_e · mean prob_e.
    frac = F.one_hot(top_e, E).to(torch.float32).sum(1).mean(0)
    aux = E * torch.sum(frac * probs.mean(0))

    cap = _capacity(Tl, top_k, E, capacity_factor)
    slot, keep = _slots(top_e.reshape(shards, Tl, top_k), E, cap)
    xs = x.reshape(shards, Tl, d)
    tokens = torch.arange(Tl * top_k, device=x.device) // top_k
    buf = x.new_zeros(shards, E * cap + 1, d)
    rows = torch.arange(shards, device=x.device)[:, None]
    buf[rows, slot] = xs[:, tokens]
    xb = buf[:, :E * cap].reshape(shards, E, cap, d).transpose(0, 1)
    xb = xb.reshape(E, shards * cap, d)
    del buf

    g = F.silu(torch.bmm(xb, params["w_gate"]))
    u = torch.bmm(xb, params["w_up"])
    del xb
    h = torch.bmm(g * u, params["w_down"])                   # (E, S·cap, d)
    del g, u
    h = h.reshape(E, shards, cap, d).transpose(0, 1).reshape(
        shards, E * cap, d)

    # Combine: each pair's expert output, gathered back in pair order (a
    # dropped pair reads slot (E−1)·cap, as JAX's clipped index does, and
    # weighs 0), then the k pairs of a token summed.
    vals = h[rows, torch.where(keep, slot, (E - 1) * cap)]
    w = (top_p.reshape(shards, -1) * keep).to(vals.dtype)
    y = (vals * w[..., None]).reshape(shards, Tl, top_k, d).sum(2)
    return y.reshape(T, d).to(x.dtype), aux
