"""Feed-forward layers: dense (SwiGLU / GELU) and Mixture-of-Experts.

Port of :mod:`repro.models.ffn`.  MoE runs one of three dispatch
implementations of the same function (``MoEConfig.impl``):

* ``dense``  — every expert computes every token, combined by gate weight.
  O(E) FLOPs; only for tiny smoke configs and as the correctness oracle.
* ``gather`` — the production path: per-data-group stable sort of the
  routed slots into capacity-bounded per-expert buffers ``(G, E, C, D)``,
  batched expert GEMMs, and the slots brought back to their tokens.
* ``ep`` — expert parallelism over the registered mesh
  (:data:`repro_torch.launch.shardings.CURRENT_MESH`), ``repro``'s
  ``_moe_ep``: a :func:`~repro_torch.core.compat.shard_map` whose positions
  (threads on one device) each route their slice of the tokens, send the
  capacity-padded buffers to the experts' owners by ``all_to_all`` and take
  the outputs back the same way; each position's experts are views of the
  layer's weights, never copies.

Routing: softmax router (fp32 whatever the model's dtype), top-k with
renormalised gates (DeepSeek-style), capacity factor with token dropping,
and the standard load-balancing aux loss.  Ties in the top-k go to the
lower expert index and the sort of the slots is stable, as in ``repro``, so
both packages route and drop the same slots.  Nothing in a layer reads a
value back to the host, and the gather path moves tokens only by
permutations and exact writes, so two runs on the card give the same bits,
its backward pass included; so does ``ep``'s, whose output and input
gradient come from one position each.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.core.compat import P, all_gather, all_to_all, axis_index, axis_size, pmean, shard_map
from repro_torch.models.common import Seed, Tree, dense_init, init_stream, params


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------


def init_dense_ffn(d_model: int, d_ff: int, *, kind: str = "swiglu", bias: bool = False,
                   dtype=torch.float32, device=None,
                   generator: Seed = None) -> nn.ParameterDict:
    generator = init_stream(generator)
    kw = dict(in_axis=0, dtype=dtype, device=device, generator=generator)
    if kind == "swiglu":
        p = {
            "w_gate": dense_init((d_model, d_ff), **kw),
            "w_up": dense_init((d_model, d_ff), **kw),
            "w_down": dense_init((d_ff, d_model), **kw),
        }
    else:  # gelu MLP (starcoder2 / hubert)
        p = {
            "w_in": dense_init((d_model, d_ff), **kw),
            "w_out": dense_init((d_ff, d_model), **kw),
        }
        if bias:
            p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
            p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return params(p)


def dense_ffn(p, x: torch.Tensor, *, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    h = nn.functional.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out = h @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


class MoEConfig(NamedTuple):
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    impl: str = "gather"         # gather | dense | ep
    aux_loss_weight: float = 0.01
    data_groups: int = 1         # data-parallel groups for group-local routing


class MoE(Tree):
    """An MoE layer's parameters under ``repro``'s names: the leaves
    ``router`` (D, E; fp32), ``w_gate``/``w_up`` (E, D, F) and ``w_down``
    (E, F, D) beside the ``shared`` SwiGLU FFN (width F·n_shared) when the
    config has shared experts.  Calling it runs :func:`moe_ffn`, so a
    forward hook sees each layer's input and output."""

    def forward(self, x: torch.Tensor, cfg: MoEConfig):
        return moe_ffn(self, x, cfg)


def init_moe(cfg: MoEConfig, *, dtype=torch.float32, device=None,
             generator: Seed = None) -> MoE:
    generator = init_stream(generator)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    kw = dict(dtype=dtype, device=device, generator=generator)
    leaves = {
        "router": dense_init((D, E), in_axis=0, dtype=torch.float32, device=device,
                             generator=generator),
        "w_gate": dense_init((E, D, F), in_axis=1, **kw),
        "w_up": dense_init((E, D, F), in_axis=1, **kw),
        "w_down": dense_init((E, F, D), in_axis=1, **kw),
    }
    children = {}
    if cfg.n_shared:
        children["shared"] = init_dense_ffn(D, F * cfg.n_shared, kind="swiglu", **kw)
    return MoE(leaves, children)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no order
    among equals)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, x2d: torch.Tensor, cfg: MoEConfig):
    """x2d (T, D) -> (gates (T, k) fp32, idx (T, k) int64, aux_loss scalar)."""
    logits = (x2d.float() @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # load-balance aux loss: E * sum_e f_e * P_e
    T = x2d.shape[0]
    me = probs.mean(0)                                               # (E,)
    flat = idx.reshape(-1)
    ce = torch.zeros(cfg.n_experts, device=x2d.device).index_add(
        0, flat, torch.ones(flat.shape, device=x2d.device)) / (T * cfg.top_k)
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.aux_loss_weight
    return gates, idx, aux


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """C, the slots of each expert in each data group of ``tokens`` tokens
    (``repro``'s expression, in its order)."""
    Tg = tokens // max(1, cfg.data_groups)
    return max(1, int(math.ceil(cfg.top_k * Tg / cfg.n_experts * cfg.capacity_factor)))


def _group_counts(eid: torch.Tensor, E: int) -> torch.Tensor:
    """(G, E) slots sent to each expert by each group's slots eid (G, S);
    counted into zeros, so the output's size does not depend on the data."""
    return torch.zeros((eid.shape[0], E), dtype=torch.long, device=eid.device).scatter_add_(
        1, eid, torch.ones_like(eid))


def _moe_dense(p, x2d, gates, idx, cfg: MoEConfig):
    """Oracle: all experts on all tokens, gather the chosen ones."""
    h = torch.einsum("td,edf->tef", x2d, p["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, p["w_up"])
    eo = torch.einsum("tef,efd->ted", nn.functional.silu(h) * u, p["w_down"])  # (T, E, D)
    sel = eo.gather(1, idx[:, :, None].expand(-1, -1, eo.shape[-1]))           # (T, k, D)
    return torch.sum(sel * gates[:, :, None].to(sel.dtype), dim=1)


def _slots(idx: torch.Tensor, cfg: MoEConfig, C: int):
    """The gather path's dispatch of routed experts idx (T, k) in G groups:
    the group-local stable sort of the slots by expert (``order``; sorted
    slot j carries token ``order[j] // k``), each sorted slot's expert, its
    position within its expert (clipped to C - 1) and whether it is kept
    (position < C)."""
    G = max(1, cfg.data_groups)
    eid = idx.reshape(G, -1)                                        # expert of each slot
    order = torch.argsort(eid, dim=-1, stable=True)                 # group-local sort
    eid_s = eid.gather(-1, order)
    # position of each sorted slot within its expert
    counts = _group_counts(eid, cfg.n_experts)                      # (G, E)
    offs = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(eid.shape[1], device=idx.device)[None, :] - offs.gather(-1, eid_s)
    return order, eid_s, pos.clamp(0, C - 1), pos < C


def _moe_gather(p, x2d, gates, idx, cfg: MoEConfig):
    """Production dispatch: group-local stable sort → (G, E, C, D) buffers →
    batched GEMMs → each token's k slots gathered back and summed."""
    T, D = x2d.shape
    E, k, G = cfg.n_experts, cfg.top_k, max(1, cfg.data_groups)
    Tg = T // G
    C = capacity(cfg, T)
    dev = x2d.device

    order, eid_s, pos_c, keep = _slots(idx, cfg, C)
    gi = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    # each token repeated for its k slots, then the slots sorted: every
    # gather here and below is by a permutation, so neither pass needs
    # atomics and two runs give the same bits (x[tok_s] would scatter-add
    # each token's k slots back in the backward pass)
    x_slots = x2d.reshape(G, Tg, 1, D).expand(G, Tg, k, D).reshape(G, Tg * k, D)
    sent = x_slots.gather(1, order[:, :, None].expand(-1, -1, D)).masked_fill(
        ~keep[:, :, None], 0)                                       # (G, Tg*k, D)
    del x_slots
    # each kept slot receives exactly one token and a dropped one adds 0:
    # the accumulation is exact, whatever order it runs in
    buf = torch.zeros((G, E, C, D), dtype=x2d.dtype, device=dev).index_put(
        (gi, eid_s, pos_c), sent, accumulate=True)
    del sent

    h = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    del buf
    h = nn.functional.silu(h) * u
    del u
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    del h

    out_slots = out_buf[gi, eid_s, pos_c]                           # (G, Tg*k, D)
    del out_buf
    gat_s = gates.reshape(G, Tg * k).gather(-1, order)
    out_slots = out_slots.masked_fill(~keep[:, :, None], 0)
    out_slots = out_slots * gat_s[:, :, None].to(out_slots.dtype)
    # back to slot order (t, k) by the inverse permutation, then the sum of
    # each token's k slots
    inv = torch.argsort(order, dim=-1)
    y = out_slots.gather(1, inv[:, :, None].expand(-1, -1, D)).reshape(G, Tg, k, D).sum(2)
    return y.reshape(T, D)


def moe_ffn(p, x: torch.Tensor, cfg: MoEConfig):
    """x (B, T, D) -> (y, aux_loss)."""
    if cfg.impl not in ("gather", "dense", "ep"):
        raise ValueError(f"unknown moe impl {cfg.impl!r} (gather | dense | ep)")
    B, T, D = x.shape
    x2d = x.reshape(B * T, D)
    if cfg.impl == "ep":
        y, aux = _moe_ep(p, x2d, cfg)
        if cfg.n_shared:
            y = y + dense_ffn(p["shared"], x2d, kind="swiglu")
        return y.reshape(B, T, D), aux
    gates, idx, aux = _router(p, x2d, cfg)
    if cfg.impl == "dense":
        y = _moe_dense(p, x2d, gates, idx, cfg)
    else:
        y = _moe_gather(p, x2d, gates, idx, cfg)
    if cfg.n_shared:
        y = y + dense_ffn(p["shared"], x2d, kind="swiglu")
    return y.reshape(B, T, D), aux


# ---------------------------------------------------------------------------
# EP dispatch: shard_map all-to-all (DeepSeek-style expert parallelism)
# ---------------------------------------------------------------------------


def _moe_ep_local(p_router, w_gate, w_up, w_down, x_m, cfg: MoEConfig, ep_axis: str):
    """Per-position body (inside shard_map): x_m (chunk, D) are THIS
    position's tokens (its model-axis slice); the expert weights are its
    E_loc experts.  Dispatch = all_to_all of capacity-padded per-expert
    buffers; the slots move by permutations and exact writes, as in the
    gather path."""
    M = axis_size(ep_axis)
    chunk, D = x_m.shape
    E = cfg.n_experts
    E_loc = E // M
    k = cfg.top_k
    C = max(1, int(math.ceil(k * chunk / E * cfg.capacity_factor)))

    logits = (x_m.float() @ p_router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # --- local capacity-padded buffers, one slot group per GLOBAL expert ----
    order, eid_s, pos_c, keep = (t[0] for t in _slots(idx, cfg._replace(data_groups=1), C))
    x_slots = x_m[:, None].expand(chunk, k, D).reshape(chunk * k, D)
    sent = x_slots.gather(0, order[:, None].expand(-1, D)).masked_fill(~keep[:, None], 0)
    buf = torch.zeros((E, C, D), dtype=x_m.dtype, device=x_m.device).index_put(
        (eid_s, pos_c), sent, accumulate=True)
    del x_slots, sent

    # --- dispatch: (M, E_loc, C, D) all_to_all over the expert axis ----------
    recv = all_to_all(buf.reshape(M, E_loc, C, D), ep_axis, 0, 0)   # (M, E_loc, C, D)
    del buf

    # --- expert GEMMs on my E_loc experts (batch dim = source position × C) --
    te = recv.transpose(0, 1).reshape(E_loc, M * C, D)
    del recv
    h = torch.einsum("ecd,edf->ecf", te, w_gate)
    u = torch.einsum("ecd,edf->ecf", te, w_up)
    del te
    out = torch.einsum("ecf,efd->ecd", nn.functional.silu(h) * u, w_down)
    del h, u
    out = out.reshape(E_loc, M, C, D).transpose(0, 1)               # (M, E_loc, C, D)

    # --- return trip + combine: each token's k slots by the inverse
    # permutation, summed --------------------------------------------------
    back = all_to_all(out, ep_axis, 0, 0).reshape(E, C, D)
    del out
    slots = back[eid_s, pos_c].masked_fill(~keep[:, None], 0)
    slots = slots * gates.reshape(-1)[order][:, None].to(back.dtype)
    inv = torch.argsort(order)
    y_m = slots.gather(0, inv[:, None].expand(-1, D)).reshape(chunk, k, D).sum(1)

    # load-balance aux (local estimate; the mean over positions follows)
    me = probs.mean(0)
    flat = idx.reshape(-1)
    ce = torch.zeros(E, device=x_m.device).index_add(
        0, flat, torch.ones(flat.shape, device=x_m.device)) / (chunk * k)
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.aux_loss_weight
    return y_m, aux


def _moe_ep(p, x2d: torch.Tensor, cfg: MoEConfig):
    """Global entry: shard_map over (data, model); tokens data-sharded and
    model-replicated on entry; each model rank takes its token slice, routes,
    and exchanges with the expert owners via all_to_all.  Needs the mesh
    registered by :func:`repro_torch.launch.shardings.set_mesh_axis_sizes`
    (``build_cell`` and ``train`` register theirs)."""
    from repro_torch.launch import shardings as sh

    mesh = sh.CURRENT_MESH
    if mesh is None:
        raise RuntimeError("moe_impl='ep' needs a mesh (launch.steps.build_cell, or "
                           "launch.shardings.set_mesh_axis_sizes)")
    ep_axis = "model"
    dp = tuple(a for a in mesh.axis_names if a != ep_axis)
    M = int(mesh.shape[ep_axis])
    if cfg.n_experts % M:
        raise ValueError(f"moe_impl='ep': {cfg.n_experts} experts do not split over the "
                         f"{M} positions of the model axis")

    def body(p_router, w_gate, w_up, w_down, x_loc):
        m = axis_index(ep_axis)
        chunk = x_loc.shape[0] // M
        x_m = x_loc.narrow(0, m * chunk, chunk)
        y_m, aux = _moe_ep_local(p_router, w_gate, w_up, w_down, x_m, cfg, ep_axis)
        # republish the full token set on every model rank
        y_loc = all_gather(y_m, ep_axis, axis=0, tiled=True)
        aux = pmean(aux, ep_axis)
        return y_loc, aux[None]

    y, aux = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(ep_axis, None, None), P(ep_axis, None, None),
                  P(ep_axis, None, None), P(dp, None)),
        out_specs=(P(dp, None), P(dp)),
    )(p["router"], p["w_gate"], p["w_up"], p["w_down"], x2d)
    return y, aux.mean()


def routed_experts(p, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The experts :func:`moe_ffn` routes each token of ``x`` (B, T, D) to:
    (B·T, k), the most probable first."""
    with torch.no_grad():
        return _router(p, x.reshape(-1, x.shape[-1]), cfg)[1]


def expert_loads(p, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, int]:
    """The slots :func:`moe_ffn` sends each expert in each data group on ``x``
    (B, T, D) under ``cfg``, and the capacity C past which the gather path
    drops them: ``(loads (G, E), C)``."""
    B, T, _ = x.shape
    idx = routed_experts(p, x, cfg)
    G = max(1, cfg.data_groups)
    return _group_counts(idx.reshape(G, -1), cfg.n_experts), capacity(cfg, B * T)
