"""Top-k mixture of experts (port of ``repro/nn/moe.py``: ``MoEConfig``,
``moe_init``, ``_route``, ``_route_sparse``, ``_load_balance_loss`` and
``moe_apply`` with both dispatches), for grok-1 and mixtral.

The router is a dense float linear layer and its softmax stays float32.
Each expert's FFN goes through ``mlp_apply``, so through the backend
registry: in bika serve every expert projection is one CAC kernel launch.
The experts run in a loop, one launch per projection per expert, each on
its whole (capacity, D) queue, as the reference's ``vmap`` over the expert
axis computes every expert's queue.

Dispatch is capacity-based, exactly the reference's: each expert takes at
most ``C = max(1, int(T * top_k / E * capacity_factor))`` tokens (Python
floats), queued j-major (every token's first choice before any second
choice, tokens in order within a choice), and an assignment past C is
dropped: it lands on the sentinel slot ``E * C`` and adds nothing. At a
decode tick of 4 rows C is 1, so tokens are dropped there too, as in the
reference; pad rows of a left-padded batch are routed and take capacity
like any token.

Expert parameters are stacked on a leading expert axis: every leaf of
``params["experts"]`` is ``(E, ...)`` (``(L, E, ...)`` in a model's
stacked layers), the reference's layout.

In train form gradients flow through the gates (the softmax, the stable
top-k sort and the renormalization) into the router, through the aux loss,
and through both gathers of the scatter dispatch. Each gather's backward
is itself a gather (``_RowGather``): a token's gradient is the sum of the
at most top-k queue rows that read it, taken by its slots, and a queue
row's gradient is the one (token, choice) row that read it back, so no
scatter-add (atomic, and so not repeatable, on CUDA) runs. An empty queue
slot is a zero row that no token reads back: the gradient reaching its
output row is exactly 0, so each term it adds to the expert's weight
gradients is 0, and its input's gradient reaches no token. A dropped
assignment points at the sentinel, a zero row both ways. Under remat the
routing is recomputed from the same inputs by the same ops and takes the
same slots.
"""
from __future__ import annotations

import dataclasses
import torch
import torch.nn.functional as F

from .linear import LinearSpec, linear_apply, linear_axes, linear_init
from .mlp import mlp_apply, mlp_axes, mlp_init
from .module import stack_trees

__all__ = ["MoEConfig", "moe_axes", "moe_init", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's MoEConfig without its mesh axis (``expert_axis``:
    one card, no expert parallelism)."""

    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    gated: bool = True
    activation: str = "silu"


def moe_axes(params, prefix=()):
    """Logical axes: the router ("embed", None); the experts' MLP axes after
    the expert axis, unnamed as the reference's default (TP inside each
    expert)."""
    return {"router": linear_axes(params["router"], ("embed", None), prefix),
            "experts": mlp_axes(params["experts"], prefix + (None,))}


def moe_init(gen, d_model: int, d_ff: int, cfg: MoEConfig, spec: LinearSpec, *,
             phase: str = "serve", device=None):
    """``{"router": dense {"w"} (D, E), "experts": mlp leaves (E, ...)}``."""
    router_spec = dataclasses.replace(spec, mode="dense")
    router = linear_init(gen, d_model, cfg.n_experts, router_spec, phase="train",
                         device=device)
    experts = [mlp_init(gen, d_model, d_ff, spec, gated=cfg.gated, phase=phase, device=device)
               for _ in range(cfg.n_experts)]
    return {"router": router, "experts": stack_trees(experts)}


def _top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates a row, largest first, the
    lower index first among equal gates (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise): a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _load_balance_loss(gates: torch.Tensor, topi: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    me = torch.mean(gates, dim=0)  # router probability mass per expert
    ce = torch.mean(F.one_hot(topi[:, 0], e).to(torch.float32), dim=0)  # top-1 share
    return e * torch.sum(me * ce)


def _gates(logits: torch.Tensor, cfg: MoEConfig):
    gates = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(gates, cfg.top_k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)  # over the top k
    return gates, topw, topi


def _route(logits: torch.Tensor, cfg: MoEConfig, capacity: int):
    """Top-k routing with capacity, the one-hot form. logits (T, E) float32
    -> dispatch (T, E, C) one-hot, combine (T, E, C) gate weights, aux."""
    t, e = logits.shape
    gates, topw, topi = _gates(logits, cfg)
    dispatch = torch.zeros((t, e, capacity), dtype=logits.dtype, device=logits.device)
    combine = torch.zeros_like(dispatch)
    for j in range(cfg.top_k):
        mask_te = F.one_hot(topi[:, j], e).to(logits.dtype)  # (T, E)
        # each token's place in its expert's queue: after every earlier choice
        prev = dispatch.sum(dim=2)
        pos = torch.cumsum(mask_te, dim=0) - 1 + prev.sum(dim=0, keepdim=True)
        keep = (pos < capacity) & (mask_te > 0)
        pos_oh = F.one_hot(pos.to(torch.int64).clamp(0, capacity), capacity + 1)[..., :capacity]
        d_j = torch.where(keep[..., None], mask_te[..., None] * pos_oh.to(logits.dtype),
                          torch.zeros((), dtype=logits.dtype, device=logits.device))
        dispatch = dispatch + d_j
        combine = combine + d_j * topw[:, j][:, None, None]
    return dispatch, combine, _load_balance_loss(gates, topi, e)


def _route_sparse(logits: torch.Tensor, cfg: MoEConfig, capacity: int):
    """Top-k routing as indices. logits (T, E) float32 -> (slot (T, k)
    int32 in [0, E*C], E*C the dropped sentinel; gates (T, k) float32
    renormalized over the top k; aux loss). A (token, choice) takes its rank
    among all assignments to its expert, j-major."""
    t, e = logits.shape
    gates, topw, topi = _gates(logits, cfg)
    flat_e = topi.t().reshape(-1)  # (kT,) j-major
    onehot = F.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    flat_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < capacity
    slot = torch.where(keep, flat_e.to(torch.int32) * capacity + flat_pos,
                       torch.full((), e * capacity, dtype=torch.int32, device=logits.device))
    slot = slot.reshape(cfg.top_k, t).t()
    return slot.contiguous(), topw, _load_balance_loss(gates, topi, e)


class _RowGather(torch.autograd.Function):
    """``cat(src, zero row)[idx]``: rows of ``src`` (R, D) by ``idx`` (I,)
    int64 in [0, R], R the zero row. The backward is a gather too: ``inv``
    (R, J) int64 in [0, I] lists, for each row of ``src``, the J output rows
    that read it (I, a zero row of the gradient, where fewer do), and its
    gradient is their sum over J in order: the same bits on every run."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return torch.cat([g, g.new_zeros((1, g.shape[1]))])[inv].sum(dim=1), None, None


def _experts(params, xe: torch.Tensor, cfg: MoEConfig, spec: LinearSpec, phase: str):
    """Each expert's FFN on its (C, D) queue: (E, C, D) -> (E, C, D). The
    experts' views come from one ``torch.unbind`` a leaf, whose backward
    stacks their gradients in one op (indexing an expert would add a
    full-size zero-filled gradient per expert and leaf)."""
    views = {k: {n: torch.unbind(leaf) for n, leaf in proj.items()}
             for k, proj in params.items()}
    out = []
    for i in range(cfg.n_experts):
        ep = {k: {n: leaves[i] for n, leaves in proj.items()} for k, proj in views.items()}
        out.append(mlp_apply(ep, xe[i], spec, activation=cfg.activation, phase=phase))
    return torch.stack(out)


def capacity_of(tokens: int, cfg: MoEConfig) -> int:
    """Tokens an expert takes of ``tokens``: the reference's Python-float
    ``max(1, int(T * top_k / E * capacity_factor))``."""
    return max(1, int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, spec: LinearSpec, *,
              phase: str = "serve", dispatch: str = "scatter"):
    """x (B, S, D) -> (y (B, S, D), aux loss). ``dispatch="scatter"`` (the
    default) gathers tokens into (E, C, D) queues by index and combines
    with a (T, k) weighted gather back; ``"einsum"`` keeps the one-hot
    dispatch matmuls."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = linear_apply(params["router"], xt, dataclasses.replace(spec, mode="dense"),
                          phase=phase).to(torch.float32)
    capacity = capacity_of(t, cfg)
    if dispatch == "einsum":
        disp, comb, aux = _route(logits, cfg, capacity)
        xe = torch.einsum("tec,td->ecd", disp.to(x.dtype), xt)
        ye = _experts(params["experts"], xe, cfg, spec, phase)
        yt = torch.einsum("tec,ecd->td", comb.to(x.dtype), ye.to(x.dtype))
        return yt.reshape(b, s, d), aux
    if dispatch != "scatter":
        raise ValueError(f"unknown dispatch {dispatch!r}")
    slot, gates, aux = _route_sparse(logits, cfg, capacity)  # (T, k) each
    ec = cfg.n_experts * capacity
    kt = t * cfg.top_k
    flat_slot = slot.reshape(-1).long()
    # expert slot -> token (sentinel t: the zero row) and -> (token, choice)
    # row (sentinel kt); dropped assignments all land on slot ec, which no
    # queue reads
    slot_to_tok = torch.full((ec + 1,), t, dtype=torch.int64, device=x.device)
    slot_to_tok[flat_slot] = torch.arange(t, device=x.device).repeat_interleave(cfg.top_k)
    slot_to_row = torch.full((ec + 1,), kt, dtype=torch.int64, device=x.device)
    slot_to_row[flat_slot] = torch.arange(kt, device=x.device)
    xe = _RowGather.apply(xt, slot_to_tok[:ec], slot.long())
    ye = _experts(params["experts"], xe.reshape(cfg.n_experts, capacity, d), cfg, spec, phase)
    picked = _RowGather.apply(ye.reshape(ec, d), flat_slot, slot_to_row[:ec, None])
    picked = picked.reshape(t, cfg.top_k, d)
    yt = torch.sum(picked * gates[..., None].to(picked.dtype), dim=1)
    return yt.reshape(b, s, d), aux
