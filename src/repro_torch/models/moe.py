"""Mixture-of-Experts: top-k routing with two dispatch strategies.

Counterpart of ``repro/models/moe.py``.  :func:`moe_apply` picks, under
exactly the reference's gate, between:

* **einsum dispatch** — GShard-style one-hot dispatch and combine einsums,
  O(T·E·C) memory: with no mesh bound, a mesh without a model axis larger
  than 1, or shapes the model axis does not divide (decode's S = 1).  On
  placed activations it is split as the reference's compiled step splits
  it (:func:`_moe_einsum_placed`): each rank its rows and its experts, no
  expert weight moved.
* **all-to-all dispatch** (expert parallelism) — under a bound mesh
  (:func:`repro_torch.dist.sharding.axis_rules`) whose model axis ``m > 1``
  divides the sequence and the expert count and whose (pod ×) data axes
  divide the batch.  Tokens are cut over (pod·data) × model (batch ×
  sequence); each rank routes its own block with its own capacity, packs
  per-expert buffers, and two tiled all-to-alls over the model axis move
  them to the owners of their experts (``E/m`` each) and back.  The
  load-balance ingredients ``f`` and ``p̄`` are averaged over every rank
  before their product.  With ``moe_a2a_bits=8`` the payload is snapped to
  the ⟨4, 4⟩ grid and moved as int8 (:func:`_a2a_pack`, which rounds half
  to even as ``jnp.round`` does).  The int8 cast cuts autograd, as the
  reference's does: the expert weights get a zero gradient there.

Each (token, k) choice takes the next slot of its expert's capacity buffer
in token-major order; a choice past the buffer's ``C`` slots is dropped.
The load-balance auxiliary loss is the Switch one.

The per-rank body :func:`_moe_a2a_local` runs over a mesh's transports:
on a :class:`~repro_torch.dist.sharding.StackedMesh` every rank is in this
process (the all-to-all a permute of the stacked buffers), on a
``DeviceMesh`` one rank a process (``all_to_all_single``).

The router is an fp32 island: its weight is declared fp32 whatever the
working dtype, its logits, softmax and top-k run in fp32, and the DPS
policy leaves it unquantized (``repro_torch.core.policy``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (Placed, _axis_sizes, _is_device_mesh,
                                       axis_transport, current_mesh_rules,
                                       held_coords, is_placed, local_blocks,
                                       logical_constraint, mesh_mean,
                                       relayout, stitch_blocks)
from repro_torch.models.common import ParamDef, act_fn
from repro_torch.models.mlp import mlp_apply, mlp_defs


def moe_defs(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, ParamDef]:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        # the router stays fp32 (a policy fp32 island)
        "router": ParamDef((D, E), (None, None), dtype=torch.float32),
        "w_in": ParamDef((E, D, Fd), ("expert", "fsdp", None), dtype=dtype),
        "w_gate": ParamDef((E, D, Fd), ("expert", "fsdp", None), dtype=dtype),
        "w_out": ParamDef((E, Fd, D), ("expert", None, "fsdp"), dtype=dtype),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(D, cfg.n_shared_experts * Fd, True, dtype)
    return defs


def _router(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """fp32 top-k routing.  x: (T, D) -> (weights (T,K), idx (T,K), probs).

    ``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
    probabilities (lower index first); the two agree wherever the top
    ``K + 1`` probabilities of a token are distinct."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_i, probs


def _aux_fp(cfg: ModelConfig, probs: torch.Tensor, top_i: torch.Tensor):
    """Load-balance ingredients: f_e (dispatch fraction) and p̄_e (mean
    router probability)."""
    f = F.one_hot(top_i, cfg.n_experts).to(torch.float32).mean(dim=(0, 1))
    return f, probs.mean(dim=0)


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor, top_i: torch.Tensor):
    """Switch load-balance loss: E · Σ_e f_e · p̄_e (times top_k)."""
    f, p = _aux_fp(cfg, probs, top_i)
    return cfg.n_experts * torch.sum(f * p) * cfg.top_k


_A2A_IL, _A2A_FL = 4, 4       # int8 wire grid: range ±8, step 1/16


def _a2a_pack(x: torch.Tensor) -> torch.Tensor:
    """x on the ⟨4, 4⟩ grid as int8 grid integers: ``x·16`` clipped to
    [-128, 127] and rounded half to even (``jnp.round``'s rule, not the
    quantizer's ``floor(y + ½)``)."""
    span = float(1 << (_A2A_IL - 1 + _A2A_FL))
    y = torch.clamp(x.to(torch.float32) * (1 << _A2A_FL), -span, span - 1)
    return torch.round(y).to(torch.int8)


def _a2a_unpack(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * (1.0 / (1 << _A2A_FL))).to(dtype)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)   # static, 8-aligned


def _slots(cfg: ModelConfig, top_i: torch.Tensor, C: int):
    """Capacity slot of each (token, k) choice and whether it is kept:
    the number of earlier choices, in token-major order, of the same
    expert; kept where that is below ``C``.  Returns ((T, K), (T, K))."""
    T = top_i.shape[0]
    flat = F.one_hot(top_i, cfg.n_experts).reshape(T * cfg.top_k, -1)
    pos = torch.cumsum(flat, dim=0) - flat                        # (T*K, E)
    pos = torch.sum(pos * flat, dim=-1).reshape(T, cfg.top_k)
    return pos, pos < C


def _moe_einsum(cfg: ModelConfig, p, x2: torch.Tensor):
    T, _ = x2.shape
    E, C = cfg.n_experts, _capacity(T, cfg)
    dt = x2.dtype
    top_w, top_i, probs = _router(cfg, p["router"], x2)
    pos, keep = _slots(cfg, top_i, C)
    disp = (F.one_hot(top_i, E).to(dt)[..., :, None]
            * F.one_hot(torch.clamp(pos, max=C - 1), C).to(dt)[..., None, :]
            * keep[..., None, None].to(dt))                       # (T,K,E,C)
    comb = disp * top_w[..., None, None].to(dt)
    disp = disp.sum(dim=1)                                        # (T, E, C)
    comb = comb.sum(dim=1)

    buf = torch.einsum("tec,td->ecd", disp, x2)                   # (E, C, D)
    h = torch.einsum("ecd,edf->ecf", buf, p["w_in"])
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    h = act_fn(cfg.act, g) * h
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_out"])
    out = torch.einsum("tec,ecd->td", comb, out_buf)
    return out, _aux_loss(cfg, probs, top_i)


# ---------------------------------------------------------------------------
# All-to-all expert parallelism.
# ---------------------------------------------------------------------------

def _model_groups(mesh, coords):
    """The held ranks (indices into ``coords``) grouped by the model-axis
    group they belong to, each group in model-axis order."""
    at = list(_axis_sizes(mesh)).index("model")
    groups = {}
    for i, c in enumerate(coords):
        groups.setdefault(c[:at] + c[at + 1:], []).append(i)
    return [sorted(g, key=lambda i: coords[i][at]) for g in groups.values()]


def _a2a(transport, groups, bufs, split_axis, concat_axis):
    """Each group's tiled all-to-all over the model axis; ``bufs`` one per
    held rank, returned the same way."""
    out = [None] * len(bufs)
    for g in groups:
        moved = transport.all_to_all_tiled(torch.stack([bufs[i] for i in g]),
                                           split_axis, concat_axis)
        for i, b in zip(g, moved.unbind(0)):
            out[i] = b
    return out


def _moe_a2a_local(cfg: ModelConfig, mesh, coords, x_ls, router_w, w_in_ls,
                   w_gate_ls, w_out_ls):
    """The per-rank body, for the ranks this process holds at ``coords``
    (mesh coordinates): ``x_ls[i]`` is rank i's (B_l, S_l, D) token block
    and ``w_*_ls[i]`` its (E_l, ·, ·) expert shards.  Every rank runs the
    reference's steps with its own shapes; the ranks meet only in the mean
    of the load-balance ingredients and the two all-to-alls over the model
    axis.  Returns (the (B_l, S_l, D) outputs, the aux loss)."""
    E, K = cfg.n_experts, cfg.top_k
    model = axis_transport(mesh, "model")
    groups = _model_groups(mesh, coords)
    wire_int8 = cfg.moe_a2a_bits == 8
    dt = x_ls[0].dtype

    routed, fs, ps = [], [], []
    routers = (router_w if isinstance(router_w, (list, tuple))
               else [router_w] * len(x_ls))
    for x_l, r_w in zip(x_ls, routers):
        x2 = x_l.reshape(-1, x_l.shape[-1])
        top_w, top_i, probs = _router(cfg, r_w, x2)
        f, pbar = _aux_fp(cfg, probs, top_i)
        fs.append(f)
        ps.append(pbar)
        routed.append((x2, top_w, top_i))
    # average BEFORE the product: Σ f̄·p̄ ≠ mean(Σ f·p)
    f = mesh_mean(mesh, torch.stack(fs))
    pbar = mesh_mean(mesh, torch.stack(ps))
    aux = E * torch.sum(f * pbar) * K

    # slots (token-major priority, drop beyond capacity) and the per-expert
    # capacity buffers (E·C + 1 rows: the last swallows the drops)
    bufs, slots = [], []
    for x2, top_w, top_i in routed:
        T_l, D = x2.shape
        C = _capacity(T_l, cfg)
        pos, keep = _slots(cfg, top_i, C)
        slot = torch.where(keep, top_i * C + pos, E * C).reshape(-1)
        buf = x2.new_zeros((E * C + 1, D)).index_add(
            0, slot, x2.repeat_interleave(K, dim=0))
        buf = buf[:-1].reshape(E, C, D)
        # with moe_a2a_bits == 8 the payload moves as int8 grid integers
        bufs.append(_a2a_pack(buf) if wire_int8 else buf)
        slots.append((slot, keep, C))

    # dispatch: rank i's C-slot block of expert e goes to e's owner, which
    # holds its E_l experts' buffers from every rank: (E_l, m·C, D)
    bufs = _a2a(model, groups, bufs, 0, 1)
    outs = []
    for buf, w_in, w_gate, w_out in zip(bufs, w_in_ls, w_gate_ls, w_out_ls):
        if wire_int8:
            buf = _a2a_unpack(buf, dt)
        h = torch.einsum("ecd,edf->ecf", buf, w_in)
        g = torch.einsum("ecd,edf->ecf", buf, w_gate)
        out_buf = torch.einsum("ecf,efd->ecd", act_fn(cfg.act, g) * h, w_out)
        outs.append(_a2a_pack(out_buf) if wire_int8 else out_buf)
    outs = _a2a(model, groups, outs, 1, 0)                       # (E, C, D)

    # combine: each token's k slots, weighted, summed
    res = []
    for x_l, (x2, top_w, _), (slot, keep, C), out_buf in zip(
            x_ls, routed, slots, outs):
        if wire_int8:
            out_buf = _a2a_unpack(out_buf, dt)
        T_l, D = x2.shape
        rows = torch.cat([out_buf.reshape(E * C, D), out_buf.new_zeros(1, D)])
        gathered = rows[slot].reshape(T_l, K, D)
        w = (top_w * keep).to(dt)
        res.append(torch.einsum("tk,tkd->td", w, gathered).reshape(x_l.shape))
    return res, aux


def a2a_specs(mesh):
    """(x's spec, the expert weights' spec): batch over the (pod ×) data
    axes, sequence over the model axis; experts over the model axis."""
    names = tuple(_axis_sizes(mesh))
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return (batch_axes or None, "model", None), ("model", None, None)


def _moe_a2a(cfg: ModelConfig, p, x, mesh):
    """The all-to-all dispatch.  On placed activations (a stacked or a
    process mesh) each rank's token block — the residual's layout — and
    its experts, gathered over data from their FSDP split, go through the
    body; both results come back placed.  On whole activations over a
    stacked mesh every rank's block is cut from ``x`` and the expert
    weights by the reference's specs and the outputs stitched back."""
    x_spec, w_spec = a2a_specs(mesh)
    coords = held_coords(mesh)
    if is_placed(x):
        xb = relayout(x, x_spec)
        w = {k: relayout(p[k], w_spec).blocks
             for k in ("w_in", "w_gate", "w_out")}
        outs, aux = _moe_a2a_local(cfg, mesh, coords, xb.blocks,
                                   p["router"].blocks, w["w_in"],
                                   w["w_gate"], w["w_out"])
        return (Placed(outs, xb.spec, mesh),
                Placed([aux] * len(outs), (), mesh))
    if _is_device_mesh(mesh):
        raise NotImplementedError(
            "the MoE all-to-all over a process DeviceMesh runs on placed "
            "activations (the placed step of launch.specs.build_train_step("
            "..., mesh=...)); whole activations take a StackedMesh")
    cut = lambda t, spec: local_blocks(t, spec, mesh, coords)
    outs, aux = _moe_a2a_local(cfg, mesh, coords, cut(x, x_spec),
                               p["router"], cut(p["w_in"], w_spec),
                               cut(p["w_gate"], w_spec),
                               cut(p["w_out"], w_spec))
    return stitch_blocks(outs, x_spec, mesh, coords, x.shape), aux


def _rank_experts(top_i: torch.Tensor, pos: torch.Tensor, keep, E: int,
                  C: int, e0: int, n_e: int, dt):
    """The dispatch tensor (T, K, n_e, C) of the experts [e0, e0 + n_e)."""
    return (F.one_hot(top_i, E)[..., e0:e0 + n_e].to(dt)[..., :, None]
            * F.one_hot(torch.clamp(pos, max=C - 1), C).to(dt)[..., None, :]
            * keep[..., None, None].to(dt))


def _moe_einsum_placed(cfg: ModelConfig, p, x: Placed):
    """The einsum dispatch on placed activations, split the way the
    reference's compiled step splits it (decode, where S = 1 fails the
    all-to-all gate): each rank routes only its data rank's rows; the
    capacity slots are the global token order's against the global
    capacity (the top-k indices gathered over the rows' axes, B·K int32);
    each rank dispatches into its block of the experts (the expert
    weights' split, ``E/m`` over the model axis), the buffers summed over
    the rows' axes onto the weights' FSDP split of D; the experts run on
    that split of D, their hidden sums taken over it, and no expert
    weight moves; the expert outputs are gathered over D and combined
    into each rank's rows, summed over the expert split in rank order.
    The load-balance ingredients are averaged over the mesh before their
    product, as on the all-to-all path."""
    mesh = x.mesh
    E, K = cfg.n_experts, cfg.top_k
    xs = relayout(x, (x.spec[0], None, None))
    # the rows' axes; the expert weights' expert axis and FSDP axes of D
    w_in = p["w_in"]
    bax, (eax, dax) = sharding._entry_axes(xs.spec[0]), w_in.spec[:2]
    rows = (xs.spec[0], None)
    x2 = xs.map(lambda b: b.reshape(-1, b.shape[-1]), spec=rows)
    top_w, top_i, probs = x2.map_many(
        lambda b, r: _router(cfg, r, b), p["router"],
        specs=(rows, rows, rows))
    fs, ps = top_i.map_many(lambda i, pr: _aux_fp(cfg, pr, i), probs,
                            specs=((None,), (None,)))
    f = mesh_mean(mesh, torch.stack(fs.blocks))
    pbar = mesh_mean(mesh, torch.stack(ps.blocks))
    aux = E * torch.sum(f * pbar) * K
    with torch.no_grad():
        every = relayout(top_i.map(lambda i: i.to(torch.int32)), (None, None))
        C = _capacity(every.shape[0], cfg)
        pos, keep = every.map_many(lambda i: _slots(cfg, i.long(), C),
                                   specs=((None, None), (None, None)))
        pos, keep = relayout(pos, rows), relayout(keep, rows)
    n_e = w_in.blocks[0].shape[0]
    dt = xs.dtype

    def dispatch(i, xb, tw, ti, pb, kb):
        e0 = w_in.geometry(i)[0][0]
        disp = _rank_experts(ti, pb, kb, E, C, e0, n_e, dt)   # (T,K,n_e,C)
        comb = (disp * tw[..., None, None].to(dt)).sum(dim=1)
        buf = torch.einsum("tec,td->ecd", disp.sum(dim=1), xb)
        return buf, comb

    bufs, combs = zip(*[dispatch(i, *a) for i, a in enumerate(zip(
        x2.blocks, top_w.blocks, top_i.blocks, pos.blocks, keep.blocks))])
    w_spec = (eax, None, None)
    buf = relayout(Placed(bufs, w_spec, mesh, partial=bax), (eax, None, dax))
    up = lambda w: buf.map(lambda b, wb: torch.einsum("ecd,edf->ecf", b, wb),
                           w, spec=w_spec, partial=sharding._entry_axes(dax))
    h = relayout(up(w_in), w_spec)
    g = relayout(up(relayout(p["w_gate"], w_in.spec)), w_spec)
    h = h.map(lambda hb, gb: act_fn(cfg.act, gb) * hb, g)
    out_buf = h.map(lambda hb, wb: torch.einsum("ecf,efd->ecd", hb, wb),
                    relayout(p["w_out"], (eax, None, dax)),
                    spec=(eax, None, dax))
    out_buf = relayout(out_buf, w_spec)
    out = Placed([torch.einsum("tec,ecd->td", c, ob)
                  for c, ob in zip(combs, out_buf.blocks)], rows, mesh,
                 partial=sharding._entry_axes(eax))
    out = relayout(out, rows).map(lambda b, xb: b.reshape(xb.shape), xs,
                                  spec=xs.spec)
    return out, Placed([aux] * len(out.blocks), (), mesh)


def _moe_placed(cfg: ModelConfig, p, x: Placed):
    """:func:`moe_apply` on placed activations, on either kind of mesh:
    under the all-to-all gate :func:`_moe_a2a`; otherwise the einsum
    dispatch split over the mesh (:func:`_moe_einsum_placed`)."""
    mesh = x.mesh
    if a2a_gate(cfg, x.shape, mesh):
        DISPATCH_COUNTS["a2a"] += 1
        out, aux = _moe_a2a(cfg, p, x, mesh)
    else:
        DISPATCH_COUNTS["einsum"] += 1
        out, aux = _moe_einsum_placed(cfg, p, x)
    if cfg.n_shared_experts:
        out = relayout(out, x.spec).map(torch.add,
                                        mlp_apply(cfg, p["shared"], x))
    return logical_constraint(out, "batch", "tp_seq", "embed"), aux


def a2a_gate(cfg: ModelConfig, x_shape, mesh) -> bool:
    """Does ``moe_apply`` take the all-to-all path on (B, S, D) under
    ``mesh``?  A model axis ``m > 1`` dividing S and the expert count, and
    the (pod ×) data axes dividing B."""
    if mesh is None:
        return False
    sizes = _axis_sizes(mesh)
    if "model" not in sizes:
        return False
    B, S = x_shape[0], x_shape[1]
    m = sizes["model"]
    bsz = math.prod(n for a, n in sizes.items() if a in ("pod", "data"))
    return (m > 1 and S % m == 0 and B % max(bsz, 1) == 0
            and cfg.n_experts % m == 0)


# calls of each dispatch (a recomputing checkpoint calls again)
DISPATCH_COUNTS = {"a2a": 0, "einsum": 0}


def moe_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, D), aux_loss fp32 scalar); on placed
    activations both placed (:func:`_moe_placed`)."""
    if is_placed(x):
        return _moe_placed(cfg, p, x)
    B, S, D = x.shape
    mesh, _ = current_mesh_rules()
    if a2a_gate(cfg, x.shape, mesh):
        DISPATCH_COUNTS["a2a"] += 1
        out, aux = _moe_a2a(cfg, p, x, mesh)
    else:
        DISPATCH_COUNTS["einsum"] += 1
        out2, aux = _moe_einsum(cfg, p, x.reshape(B * S, D))
        out = out2.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], x)
    return logical_constraint(out, "batch", "tp_seq", "embed"), aux


def count_moe_params(cfg: ModelConfig) -> int:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    n = D * E + E * D * Fd * 3
    if cfg.n_shared_experts:
        n += 3 * D * cfg.n_shared_experts * Fd
    return n


def count_moe_active_params(cfg: ModelConfig) -> int:
    D, Fd = cfg.d_model, cfg.moe_d_ff
    n = D * cfg.n_experts + cfg.top_k * D * Fd * 3
    if cfg.n_shared_experts:
        n += 3 * D * cfg.n_shared_experts * Fd
    return n
