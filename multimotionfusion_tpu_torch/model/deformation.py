"""Embedded deformation graph for map correction after loop closures (kernel
K23, ``csrc/deformation.cu``).

Port of the reference package's ``model/deformation.py`` (Sumner-style
embedded deformation, reference Core/Utils/DeformationGraph and
Core/Model/Deformation):

- ``sample_nodes``: at most ``max_nodes`` nodes from the live surfels at a
  rank stride (storage order, roughly temporal): a prefix sum and a scatter;
- ``deform_points``: each point blends the k nearest of the ``look_back``
  nodes around its time (the reference's binary search), with weights
  (1 - d/dmax)^2 (kernel entry ``deform.points``; it also returns the chosen
  nodes and weights);
- ``optimise``: Gauss-Newton over the [N, 12] affine parameters of the nodes
  (rotation, regularisation and constraint residuals). The reference builds
  the Jacobian with ``jax.jacfwd``; here it is built analytically: the
  rotation residuals are quadratic in A, the regularisation residuals linear
  in A and t, the constraint residuals linear in A and t once the node choice
  and weights (which depend only on node positions, times and the points) are
  fixed. Then one dense solve of J^T J + 1e-6 I per iteration
  (``torch.linalg.solve_ex``, float32, TF32 off: the reference's dense
  ``linalg.solve``);
- ``apply_to_map``: every live surfel deformed in place (kernel entry
  ``deform.apply_map``), gated by a 0-dim accept flag read on the device.

The kernel entries take their plain PyTorch versions (``*_plain``) only for
CPU tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from multimotionfusion_tpu_torch import kernels as K
from multimotionfusion_tpu_torch.config import DeformationConfig
from multimotionfusion_tpu_torch.model import surfel_map as sm

F32 = torch.float32
LOOK_BACK = 20


class DeformationGraph(NamedTuple):
    positions: torch.Tensor  # [N, 3] node positions g_k
    times: torch.Tensor  # [N] float32 node init timestamps
    A: torch.Tensor  # [N, 3, 3] per-node affine (identity at rest)
    t: torch.Tensor  # [N, 3] per-node translation
    valid: torch.Tensor  # [N] bool

    @property
    def num_nodes(self) -> int:
        return self.positions.shape[0]


class Choice(NamedTuple):
    """Each point's k chosen nodes and blend weights (fixed for fixed node
    positions and points)."""

    nid: torch.Tensor  # [P, k] int32
    wgt: torch.Tensor  # [P, k] float32


def sample_nodes(smap: sm.SurfelMap, max_nodes: int) -> DeformationGraph:
    """Systematic subsample of the live surfels, ordered by storage (~time)."""
    dev = smap.data.device
    alive = smap.alive_mask()
    n_alive = torch.clamp(alive.to(torch.int32).sum(), min=1)
    rank = torch.cumsum(alive.to(torch.int32), dim=0) - 1
    stride = torch.clamp(n_alive // max_nodes, min=1)
    take = alive & (torch.remainder(rank, stride) == 0) & (rank // stride < max_nodes)
    dest = torch.where(take, torch.clamp(rank // stride, 0, max_nodes - 1),
                       torch.full_like(rank, max_nodes)).long()
    pos = torch.zeros((max_nodes + 1, 3), dtype=F32, device=dev)
    pos.scatter_(0, dest[:, None].expand(-1, 3), smap.data[sm.PX:sm.PZ + 1].T.contiguous())
    times = torch.zeros((max_nodes + 1,), dtype=F32, device=dev)
    times.scatter_(0, dest, smap.data[sm.INIT_T].contiguous())
    valid = torch.zeros((max_nodes + 1,), dtype=torch.bool, device=dev)
    valid.scatter_(0, dest, torch.ones_like(take))
    eye = torch.eye(3, dtype=F32, device=dev).repeat(max_nodes, 1, 1)
    return DeformationGraph(positions=pos[:max_nodes].contiguous(),
                            times=times[:max_nodes].contiguous(), A=eye,
                            t=torch.zeros((max_nodes, 3), dtype=F32, device=dev),
                            valid=valid[:max_nodes].contiguous())


def search_levels(n: int) -> int:
    """Halvings of jnp.searchsorted's default ("scan") binary search."""
    return int(math.ceil(math.log2(n + 1)))


def _offsets(look_back: int):
    return range(-look_back // 2, look_back - look_back // 2)


def choose_plain(points, point_times, node_pos, node_times, node_valid, k: int,
                 look_back: int = LOOK_BACK) -> Choice:
    """The k nearest time-windowed nodes of each point and their weights."""
    n = node_pos.shape[0]
    dev = points.device
    low = torch.zeros(point_times.shape, dtype=torch.int64, device=dev)
    high = torch.full(point_times.shape, n, dtype=torch.int64, device=dev)
    for _ in range(search_levels(n)):
        mid = (low + high) // 2
        left = point_times <= node_times[mid]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    offs = torch.tensor(list(_offsets(look_back)), dtype=torch.int64, device=dev)
    cand = torch.clamp(high[:, None] + offs[None, :], 0, n - 1)  # [P, L]
    cp = node_pos[cand]  # [P, L, 3]
    dx, dy, dz = (points[:, None, i] - cp[..., i] for i in range(3))
    d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    d = torch.where(node_valid[cand], d, torch.full_like(d, float("inf")))
    dk, sel = torch.sort(d, dim=1, stable=True)  # ascending, the lower position first on ties
    dk, sel = dk[:, :k + 1], sel[:, :k + 1]
    dmax = torch.clamp(dk[:, k:k + 1], min=1e-9)
    v = 1.0 - dk[:, :k] / dmax
    v = torch.where(v < 0, torch.zeros_like(v), v)  # NaN stays NaN, as jnp.maximum
    w = v * v
    wsum = torch.zeros_like(w[:, 0])
    for q in range(k):
        wsum = wsum + w[:, q]
    wsum = wsum[:, None]
    w = torch.where(wsum > 1e-9, w / torch.clamp(wsum, min=1e-9), torch.full_like(w, 1.0 / k))
    nid = torch.gather(cand, 1, sel[:, :k]).to(torch.int32)
    return Choice(nid, w)


def blend(points, choice: Choice, node_pos, A, t) -> torch.Tensor:
    """sum_q w_q (A_q (p - g_q) + g_q + t_q), in the kernel's order."""
    nid = choice.nid.long()
    out = torch.zeros_like(points)
    for q in range(nid.shape[1]):
        n = nid[:, q]
        g, An, tn = node_pos[n], A[n], t[n]
        d0, d1, d2 = (points[:, i] - g[:, i] for i in range(3))
        m = torch.stack([An[:, i, 0] * d0 + An[:, i, 1] * d1 + An[:, i, 2] * d2 + g[:, i] + tn[:, i]
                         for i in range(3)], dim=-1)
        out = out + choice.wgt[:, q:q + 1] * m
    return out


def deform_points_plain(points, point_times, graph: DeformationGraph, k: int,
                        look_back: int = LOOK_BACK) -> Tuple[torch.Tensor, Choice]:
    ch = choose_plain(points, point_times, graph.positions, graph.times, graph.valid, k, look_back)
    return blend(points, ch, graph.positions, graph.A, graph.t), ch


def _graph_args(graph: DeformationGraph):
    for x, name in ((graph.positions, "positions"), (graph.times, "times"), (graph.A, "A"),
                    (graph.t, "t")):
        K.check(x, F32, name)
    K.check(graph.valid, torch.bool, "valid")
    n = graph.num_nodes
    return (K.ptr(graph.positions), K.ptr(graph.times), K.ptr(graph.A), K.ptr(graph.t),
            K.ptr(graph.valid), n, search_levels(n))


def deform_points_cuda(points, point_times, graph: DeformationGraph, k: int,
                       look_back: int = LOOK_BACK) -> Tuple[torch.Tensor, Choice]:
    K.check(points, F32, "points")
    K.check(point_times, F32, "point_times")
    P = points.shape[0]
    dev = points.device
    out = torch.empty((P, 3), dtype=F32, device=dev)
    ch = Choice(torch.empty((P, k), dtype=torch.int32, device=dev),
                torch.empty((P, k), dtype=F32, device=dev))
    f = K.fn("deformation", "mmf_deform_points",
             [K.P, K.P, K.I] + [K.P] * 5 + [K.I] * 4 + [K.P] * 3)
    K.call("deform.points", f, K.ptr(points), K.ptr(point_times), P, *_graph_args(graph), k,
           look_back, K.ptr(out), K.ptr(ch.nid), K.ptr(ch.wgt))
    return out, ch


def deform_points(points, point_times, graph: DeformationGraph, cfg: DeformationConfig,
                  look_back: int = LOOK_BACK) -> Tuple[torch.Tensor, Choice]:
    """(deformed points [P, 3], the chosen nodes and weights) of ``points``
    [P, 3] with init times ``point_times`` [P] under ``graph``
    (copy_unstable.vert's node sampler)."""
    K.record("deform.points", points=points, point_times=point_times, graph=graph, k=cfg.k_neighbours,
             look_back=look_back)
    impl = deform_points_cuda if points.is_cuda else deform_points_plain
    return impl(points.contiguous(), point_times.contiguous(), graph, cfg.k_neighbours, look_back)


def apply_to_map_plain(data, count, graph: DeformationGraph, k: int, gate=None,
                       look_back: int = LOOK_BACK) -> None:
    if gate is not None and not bool(gate):
        return
    pts = data[sm.PX:sm.PZ + 1].T.contiguous()
    moved, _ = deform_points_plain(pts, data[sm.INIT_T].contiguous(), graph, k, look_back)
    alive = sm.SurfelMap(data, count).alive_mask()
    data[sm.PX:sm.PZ + 1] = torch.where(alive[None], moved.T, data[sm.PX:sm.PZ + 1])


def apply_to_map_cuda(data, count, graph: DeformationGraph, k: int, gate=None,
                      look_back: int = LOOK_BACK) -> None:
    K.check(data, F32, "data", contiguous=False)
    K.check(count, torch.int32, "count")
    if data.shape[0] != sm.CHANNELS or data.stride(1) != 1:
        raise ValueError("data must be [16, B] with unit column stride")
    if gate is not None:
        K.check(gate, torch.bool, "gate")
    f = K.fn("deformation", "mmf_deform_map",
             [K.P, K.L, K.I, K.P, K.P] + [K.P] * 5 + [K.I] * 4)
    K.call("deform.apply_map", f, K.ptr(data), data.stride(0), data.shape[1], K.ptr(count),
           None if gate is None else K.ptr(gate), *_graph_args(graph), k, look_back)


def apply_to_map(smap: sm.SurfelMap, graph: DeformationGraph, cfg: DeformationConfig,
                 gate: Optional[torch.Tensor] = None) -> None:
    """Deform every live surfel's position with ``graph``, in place in
    ``smap.data``; nothing moves where the 0-dim bool ``gate`` is False."""
    K.record("deform.apply_map", data=smap.data, count=smap.count, graph=graph,
             k=cfg.k_neighbours, gate=gate)
    impl = apply_to_map_cuda if smap.data.is_cuda else apply_to_map_plain
    impl(smap.data, smap.count, graph, cfg.k_neighbours, gate)


# ---------------------------------------------------------------- Gauss-Newton

def _reg_pairs(n: int, k: int, device):
    """(loop index e, node n, neighbour j, in-range flag) of the sequential
    +-d neighbour residuals, d = 1..k/2, in the reference's order."""
    es, js, ok = [], [], []
    ar = torch.arange(n, device=device)
    for d in range(1, k // 2 + 1):
        for sgn in (-d, d):
            j = torch.clamp(ar + sgn, 0, n - 1)
            js.append(j)
            ok.append(ar + sgn == j)
    return torch.stack(js), torch.stack(ok)  # [E, N]


def residuals(params, graph: DeformationGraph, moved, cons_dst, cons_valid,
              cfg: DeformationConfig) -> torch.Tensor:
    """The stacked weighted residuals [6N | 3NE | 3C] at ``params`` [N, 12];
    ``moved`` the constraint sources deformed at ``params``."""
    n = graph.num_nodes
    A = params[:, :9].reshape(n, 3, 3)
    t = params[:, 9:12]
    g = graph.positions
    vw = graph.valid.to(F32)
    c0, c1, c2 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
    rot = torch.stack([(c0 * c1).sum(-1), (c0 * c2).sum(-1), (c1 * c2).sum(-1),
                       (c0 * c0).sum(-1) - 1.0, (c1 * c1).sum(-1) - 1.0,
                       (c2 * c2).sum(-1) - 1.0], dim=-1) * vw[:, None]
    js, ok = _reg_pairs(n, cfg.k_neighbours, params.device)
    regs = []
    for e in range(js.shape[0]):
        j = js[e]
        pred = torch.einsum("nij,nj->ni", A, g[j] - g) + g + t
        w = vw * vw[j] * ok[e].to(F32)
        regs.append((pred - (g[j] + t[j])) * w[:, None])
    con = (moved - cons_dst) * cons_valid.to(F32)[:, None]
    return torch.cat([math.sqrt(cfg.w_rot) * rot.reshape(-1),
                      math.sqrt(cfg.w_reg) * torch.cat(regs, 0).reshape(-1),
                      math.sqrt(cfg.w_con) * con.reshape(-1)])


def jacobian(params, graph: DeformationGraph, cons_src, cons_valid, choice: Choice,
             cfg: DeformationConfig) -> torch.Tensor:
    """The Jacobian [R, 12N] of ``residuals`` at ``params``, built
    analytically (columns node-major: A row-major at 0..8, t at 9..11);
    contributions of a node chosen twice for one point are summed."""
    n = graph.num_nodes
    dev = params.device
    A = params[:, :9].reshape(n, 3, 3)
    g = graph.positions
    vw = graph.valid.to(F32)
    rows, cols, vals = [], [], []
    ar = torch.arange(n, device=dev)
    # rot: r = sqrt(w_rot) vw [c0.c1, c0.c2, c1.c2, c0.c0 - 1, c1.c1 - 1, c2.c2 - 1]
    srot = math.sqrt(cfg.w_rot) * vw
    pairs = ((0, 0, 1), (1, 0, 2), (2, 1, 2), (3, 0, 0), (4, 1, 1), (5, 2, 2))
    for r, a, b in pairs:
        for i in range(3):
            if a == b:
                rows.append(ar * 6 + r)
                cols.append(ar * 12 + 3 * i + a)
                vals.append(srot * 2.0 * A[:, i, a])
            else:  # d(ca . cb)/dA[i, a] = A[i, b] and d/dA[i, b] = A[i, a]
                rows += [ar * 6 + r, ar * 6 + r]
                cols += [ar * 12 + 3 * i + a, ar * 12 + 3 * i + b]
                vals += [srot * A[:, i, b], srot * A[:, i, a]]
    # reg: r_i = sqrt(w_reg) w (sum_m A[i, m] (g_j - g_n)_m + g_n,i + t_n,i - g_j,i - t_j,i)
    js, ok = _reg_pairs(n, cfg.k_neighbours, dev)
    base = 6 * n
    for e in range(js.shape[0]):
        j = js[e]
        w = math.sqrt(cfg.w_reg) * vw * vw[j] * ok[e].to(F32)
        dg = g[j] - g
        for i in range(3):
            row = base + (e * n + ar) * 3 + i
            for m in range(3):
                rows.append(row)
                cols.append(ar * 12 + 3 * i + m)
                vals.append(w * dg[:, m])
            rows += [row, row]
            cols += [ar * 12 + 9 + i, j * 12 + 9 + i]
            vals += [w, -w]
    # con: r_i = sqrt(w_con) valid sum_q w_q (A_q (p - g_q) + g_q + t_q)_i - dst_i
    base += 3 * n * js.shape[0]
    P = cons_src.shape[0]
    pr = torch.arange(P, device=dev)
    cv = math.sqrt(cfg.w_con) * cons_valid.to(F32)
    for q in range(choice.nid.shape[1]):
        nq = choice.nid[:, q].long()
        c = cv * choice.wgt[:, q]
        dp = cons_src - g[nq]
        for i in range(3):
            row = base + pr * 3 + i
            for m in range(3):
                rows.append(row)
                cols.append(nq * 12 + 3 * i + m)
                vals.append(c * dp[:, m])
            rows.append(row)
            cols.append(nq * 12 + 9 + i)
            vals.append(c)
    R = base + 3 * P
    J = torch.zeros((R, 12 * n), dtype=F32, device=dev)
    J.index_put_((torch.cat(rows), torch.cat(cols)), torch.cat(vals), accumulate=True)
    return J


def optimise(graph: DeformationGraph, cons_src, cons_dst, cons_valid, cons_times,
             cfg: DeformationConfig) -> DeformationGraph:
    """Gauss-Newton over every node's transform, ``cfg.iterations`` steps of
    delta = solve(J^T J + 1e-6 I, -J^T r), each a dense float32 solve on the
    device (no host read)."""
    n = graph.num_nodes
    params = torch.cat([graph.A.reshape(n, 9), graph.t], dim=-1)
    eye = torch.eye(12 * n, dtype=F32, device=params.device)
    choice = None
    for _ in range(cfg.iterations):
        g = graph._replace(A=params[:, :9].reshape(n, 3, 3).contiguous(),
                           t=params[:, 9:12].contiguous())
        moved, choice = deform_points(cons_src, cons_times, g, cfg)
        r = residuals(params, graph, moved, cons_dst, cons_valid, cfg)
        J = jacobian(params, graph, cons_src, cons_valid, choice, cfg)
        JtJ = J.T @ J + 1e-6 * eye
        delta, _ = torch.linalg.solve_ex(JtJ, -(J.T @ r))
        params = params + delta.reshape(n, 12)
    return graph._replace(A=params[:, :9].reshape(n, 3, 3).contiguous(),
                          t=params[:, 9:12].contiguous())
