"""Expert-parallel MoE over a ``(data, model)`` rank group.

The counterpart of the reference's ``models/moe_shardmap.py``, which runs
the canonical EP flow inside ``shard_map``: tokens split over ``("data",
"model")`` → local top-k routing → per-destination capacity buffers →
``all_to_all`` over ``model`` → the E/tp resident experts' FFN →
``all_to_all`` back → local combine.  Here each device of that mesh is a
``torch.distributed`` rank, and the mesh a 2-D ``DeviceMesh`` with dims
``("data", "model")`` (``launch.mesh.MeshShape.device_mesh``):

* :func:`moe_ffn_ep` takes this rank's ``(B/dp, S/tp, d)`` tokens and
  its parameters (the replicated router, its ``E/tp`` experts) and
  returns its ``(B/dp, S/tp, d)`` outputs.  :func:`token_shard`,
  :func:`gather_tokens` and :func:`expert_shard` cut and join the global
  views as ``P("data", "model", None)`` and ``P("model", None, None)`` lay
  them out.
* The exchange is ``torch.distributed.nn.functional.all_to_all_single``
  on the ``model`` sub-group, which records its gradient (the backward is
  the reverse exchange).  Gloo takes CUDA tensors as they are, so ranks
  that share one card exchange device buffers.
* Gradients are summed as the transpose of ``shard_map`` sums them: the
  router enters replicated, so its gradient is all-reduced over every rank
  of the mesh (``data``, then ``model``); the experts are replicated over
  ``data``, so theirs is all-reduced over ``data``.  The sums run in the
  backward of :class:`_SumGrad`, an identity in the forward.

The dispatch and combine keep the reference's arithmetic: float32 router
logits, a sorted top-k, softmax over the K gates, a stable argsort of the
expert ids, the capacity ``max(1, int(cf·n·K/E), min(n, 64))`` (not
``moe_capacity``'s ``min(n, 128)``: at drops the two paths keep other
entries, as in the reference), a gather where the reference scatter-adds
into zeros (kept slots are unique: the same values), and each token's K
terms added in the order the reference's serial scatter-add meets them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ranks import all_gather_dims
from .config import ModelConfig
from .layers import gelu, silu_stepwise


def _dims(mesh) -> tuple[int, int]:
    """``(dp, tp)``: the sizes of ``mesh``'s ``data`` and ``model`` dims."""
    names = tuple(mesh.mesh_dim_names or ())
    if names != ("data", "model"):
        raise ValueError(f"expert parallelism needs a mesh with dims "
                         f"('data', 'model'), got {names}")
    return mesh.size(0), mesh.size(1)


class _SumGrad(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over each
    process group of ``groups`` in turn (``all_reduce``)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(grad, group=group)
        return grad, None


def _dispatch_local(cfg: ModelConfig, router, xf, tp: int, cap: int):
    """Route the n local tokens xf (n, d) into ``(tp, E/tp, cap, d)`` send
    buffers.  Returns the buffers and the bookkeeping ``(slot, stok, sw,
    keep)``, each (n·K,) in expert-sorted order: an entry's slot in the
    flat send layout (``E·cap``, the dump row, where dropped), its token,
    its gate weight and whether the capacity kept it."""
    n, d = xf.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    e_loc = E // tp
    dev = xf.device
    logits = torch.einsum("nd,de->ne", xf.float(), router)
    gates, idx = torch.topk(logits, K, dim=-1, sorted=True)
    weights = torch.softmax(gates, dim=-1)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    stok = order // K
    sw = weights.reshape(-1)[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev),
                                   right=False)
    pos = torch.arange(n * K, device=dev) - seg_start[se]
    keep = pos < cap
    # slot within the (tp, e_loc, cap) send layout
    dest, e_in = se // e_loc, se % e_loc
    slot = torch.where(keep, (dest * e_loc + e_in) * cap + pos, E * cap)
    # each kept entry fills its slot once; empty slots and the dump row
    # read a zero row (index n)
    src = torch.full((E * cap + 1,), n, dtype=torch.long, device=dev)
    src[slot] = torch.where(keep, stok, n)
    rows = torch.cat([xf, xf.new_zeros((1, d))])
    buf = rows[src[:-1]].reshape(tp, e_loc, cap, d)
    return buf, (slot, stok, sw, keep)


def _combine_local(n: int, d: int, out_buf, book):
    """out[t] = Σ out_buf[slot[j]] · (sw·keep)[j] over token t's K
    entries j, the weight cast to the buffer's dtype before the product,
    added one at a time in ascending expert-sorted position: the order in
    which the reference's serial ``.at[stok].add`` meets them."""
    slot, stok, sw, keep = book
    K = stok.numel() // n
    flat = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    # a stable sort by token keeps each token's entries in sorted order
    mine = torch.argsort(stok, stable=True).reshape(n, K)
    weight = (sw * keep).to(out_buf.dtype)
    terms = flat[slot[mine]] * weight[mine][..., None]      # (n, K, d)
    out = out_buf.new_zeros((n, d))
    for j in range(K):
        out = out + terms[:, j]
    return out


def ep_capacity(cfg: ModelConfig, n_loc: int,
                capacity_factor: float | None = None) -> int:
    """Slots an expert takes from each rank's ``n_loc`` tokens: the
    reference's ``max(1, int(cf·n_loc·K/E), min(n_loc, 64))``."""
    E, K = cfg.num_experts, cfg.experts_per_token
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(cf * n_loc * K / E), min(n_loc, 64))


def moe_ffn_ep(cfg: ModelConfig, params, x, mesh,
               capacity_factor: float | None = None):
    """This rank's MoE FFN outputs (B/dp, S/tp, d) for its tokens ``x``
    (B/dp, S/tp, d), the experts split over ``mesh``'s ``model`` dim.

    ``params``: ``router`` (d, E), replicated; ``w_gate``, ``w_up`` (E/tp,
    d, f) and ``w_down`` (E/tp, f, d), this rank's experts
    (:func:`expert_shard`).  Every rank of the mesh must call it together.
    Raises ``ValueError`` where the reference asserts (``E % tp``; ``B %
    dp`` and ``S % tp`` are :func:`token_shard`'s)."""
    b, s, d = x.shape
    E = cfg.num_experts
    dp, tp = _dims(mesh)
    if E % tp:
        raise ValueError(f"{E} experts do not split over model = {tp}")
    e_loc = E // tp
    if params["w_gate"].shape[0] != e_loc:
        raise ValueError(f"this rank holds {params['w_gate'].shape[0]} "
                         f"experts, the mesh gives it {e_loc}")
    n_loc = b * s
    cap = ep_capacity(cfg, n_loc, capacity_factor)
    model = mesh.get_group("model")
    data = mesh.get_group("data")
    router = _SumGrad.apply(params["router"], (data, model))
    w_gate, w_up, w_down = (_SumGrad.apply(params[k], (data,))
                            for k in ("w_gate", "w_up", "w_down"))
    send, book = _dispatch_local(cfg, router, x.reshape(n_loc, d), tp, cap)
    # recv[src]: the buffers rank src of this model group filled for my
    # experts
    recv = _exchange(send, model)
    act = silu_stepwise if cfg.mlp_type != "gelu" else gelu
    # in place: autograd saves neither act's output nor the product
    hidden = act(torch.einsum("secd,edf->secf", recv, w_gate)).mul_(
        torch.einsum("secd,edf->secf", recv, w_up))
    out = torch.einsum("secf,efd->secd", hidden, w_down)
    back = _exchange(out, model)
    return _combine_local(n_loc, d, back, book).reshape(b, s, d)


def _exchange(buf, group):
    """``all_to_all`` of ``buf`` (tp, ...) over ``group``: slice r goes to
    rank r, and slice r of the result came from rank r.  Differentiable."""
    from torch.distributed.nn.functional import all_to_all_single
    buf = buf.contiguous()
    return all_to_all_single(torch.empty_like(buf), buf, group=group)


def token_shard(x, mesh):
    """This rank's block of the global tokens x (B, S, d), as ``P("data",
    "model", None)`` lays it out: rows ``i·B/dp ...`` and positions ``j·S/tp
    ...`` at mesh coordinate (i, j)."""
    B, S, _ = x.shape
    dp, tp = _dims(mesh)
    if B % dp or S % tp:
        raise ValueError(f"tokens ({B}, {S}) do not split over (data, "
                         f"model) = ({dp}, {tp})")
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    b, s = B // dp, S // tp
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def gather_tokens(y, mesh):
    """The global (B, S, d) from every rank's (B/dp, S/tp, d) block, on
    every rank (the inverse of :func:`token_shard`).  Not
    differentiable."""
    return all_gather_dims(y, ((mesh.get_group("model"), 1),
                               (mesh.get_group("data"), 0)))


def expert_shard(params, mesh) -> dict:
    """This rank's parameters of a MoE layer's ``params`` (router (d, E),
    experts (E, ...)): the router, and the experts ``j·E/tp ...`` at
    ``model`` coordinate j, as ``P("model", None, None)`` lays them out."""
    E = params["w_gate"].shape[0]
    _, tp = _dims(mesh)
    if E % tp:
        raise ValueError(f"{E} experts do not split over model = {tp}")
    j, e = mesh.get_local_rank("model"), E // tp
    return {"router": params["router"],
            **{k: params[k][j * e:(j + 1) * e]
               for k in ("w_gate", "w_up", "w_down")}}
