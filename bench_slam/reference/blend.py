"""The tile blend of the benchmark's plain reference: a frozen copy of the
port's plain PyTorch packed blend (forward and backward) in
float32, with an autograd Function over the packed pair. No kernel: every
step is a PyTorch operation, run on whatever device its inputs are on.

Layout: packed params (NB, KC, TG, 10) float32, fields [mean_x, mean_y,
conic_a, conic_b, conic_c, r, g, b, depth, opacity], chunk b holding slots [k0[b], k0[b] + KC) of the TG tiles
of group cg[b]. A tile marches its slots in order and stops once its group's
chunks run out or no pixel keeps transmittance above
T_EPS."""
from __future__ import annotations

import torch

NF = 10
TILE = 16
P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4
KC = 32  # slots per chunk of the packed layout


def _pixel_coords(T: int, ntx: int, device, tids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, P) pixel coordinates of tiles 0..T-1, or of the tile ids `tids`."""
    tids = torch.arange(T, device=device) if tids is None else tids.reshape(-1)
    lin = torch.arange(P, device=device)
    px = ((tids % ntx) * TILE)[:, None].to(torch.float32) + (lin % TILE)[None].to(torch.float32)
    py = ((tids // ntx) * TILE)[:, None].to(torch.float32) + (lin // TILE)[None].to(torch.float32)
    return px, py


def _alpha_at(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Alpha of one slot (p: (T, NF)) on the (T, P) pixel grid."""
    dx = px - p[:, 0:1]
    dy = py - p[:, 1:2]
    power = -0.5 * (p[:, 2:3] * dx * dx + p[:, 4:5] * dy * dy) - p[:, 3:4] * dx * dy
    G = torch.exp(power)
    raw = p[:, 9:10] * G
    ok = (power <= 0.0) & (raw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp(raw, max=ALPHA_MAX), torch.zeros_like(raw))
    return alpha, G, dx, dy, raw


def _slot_forward(p, px, py, alive, trans, acc):
    """One marched slot of the forward, for the tiles of the rows of p
    (those not `alive` take alpha 0). Returns (blend weights (T, P),
    trans', acc')."""
    alpha = _alpha_at(p, px, py)[0]
    alpha = torch.where(alive[:, None], alpha, torch.zeros_like(alpha))
    w = torch.where(trans > T_EPS, alpha * trans, torch.zeros_like(alpha))
    acc = acc + w[:, None, :] * p[:, 5:9, None]
    return w, trans * (1.0 - alpha), acc


def _slot_backward(p, px, py, alive, trans, prefix, acc, trans_final, dacc, dtrans):
    """One marched slot of the backward. Returns (d params (T, NF), trans', prefix')."""
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    alpha, G, dx, dy, raw = _alpha_at(p, px, py)
    alpha = torch.where(alive[:, None], alpha, zero)
    contributes = trans > T_EPS
    w = torch.where(contributes, alpha * trans, zero)
    col = p[:, 5:9, None]  # (T, 4, 1)
    prefix = prefix + w[:, None, :] * col
    one_m = 1.0 - alpha
    suffix = acc - prefix
    # dL/dalpha = <g_acc, T_k c_k - S_k/(1-alpha_k)> - g_T * T_N/(1-alpha_k)
    term = torch.where(
        contributes[:, None, :], trans[:, None, :] * col - suffix / one_m[:, None, :], zero
    )
    galpha = (dacc * term).sum(dim=1) - dtrans * trans_final / one_m
    galpha = torch.where(alpha > 0.0, galpha, zero)
    unclamped = raw < ALPHA_MAX
    d_op_px = torch.where(unclamped, galpha * G, zero)
    d_pow = torch.where(unclamped, galpha * alpha, zero)
    ca, cb, cc = p[:, 2:3], p[:, 3:4], p[:, 4:5]
    d = torch.empty((p.shape[0], NF), dtype=torch.float32, device=p.device)
    d[:, 0] = (d_pow * (ca * dx + cb * dy)).sum(dim=1)
    d[:, 1] = (d_pow * (cc * dy + cb * dx)).sum(dim=1)
    d[:, 2] = (d_pow * (-0.5 * dx * dx)).sum(dim=1)
    d[:, 3] = (d_pow * (-dx * dy)).sum(dim=1)
    d[:, 4] = (d_pow * (-0.5 * dy * dy)).sum(dim=1)
    d[:, 5:9] = (dacc * w[:, None, :]).sum(dim=2)
    d[:, 9] = d_op_px.sum(dim=1)
    return d, trans * one_m, prefix


def _group_chunks(cg: torch.Tensor, n_groups: int):
    """Per group g < n_groups: (first chunk, number of chunks) in the sorted
    chunk-group map cg (padding chunks carry cg = n_groups)."""
    g = torch.arange(n_groups + 1, dtype=cg.dtype, device=cg.device)
    bounds = torch.searchsorted(cg, g)
    return bounds[:-1], bounds[1:] - bounds[:-1]


def _packed_tiles(tp, cg, goff, tids, n_groups: int, ntx: int):
    """The (group, lane) tiles of a packed block, one row per tile in group
    order: (first chunk (G,), chunks (G,), pixel coordinates px, py
    (G*TG, P)). A group's tile ids are those of its first chunk."""
    NB, _, TG, _ = tp.shape
    start, nch = _group_chunks(cg, n_groups)
    tid = tids[start.clamp(max=NB - 1).long()] + goff.reshape(())  # (G, TG)
    px, py = _pixel_coords(n_groups * TG, ntx, tp.device, tids=tid)
    return start, nch, px, py


def _packed_slots(tp, start, nch, trans_of):
    """Slot positions of a packed march in order, for all tiles at once:
    yields (alive (G*TG,), chunk of each group (G,), `has` (G,): whether the
    group has that chunk, slot index kc). A tile stops before the slot at
    which its group has no chunk left or no pixel of it has transmittance
    above T_EPS (`trans_of()` reads the march's current (G*TG, P)
    transmittance); the march ends when every tile has stopped."""
    NB, _, TG, _ = tp.shape
    G = start.shape[0]
    alive = (nch > 0).repeat_interleave(TG)
    for c in range(int(nch.max()) if G else 0):
        has = c < nch
        b = (start + c).clamp(max=NB - 1).long()
        for kc in range(KC):
            alive = alive & has.repeat_interleave(TG) & (trans_of() > T_EPS).any(dim=1)
            if not bool(alive.any()):
                return
            yield alive, b, has, kc


def _to_group_major(x: torch.Tensor, G: int, TG: int, fill: float) -> torch.Tensor:
    """(G*TG, C, P) or (G*TG, P) tile rows -> (G+1, C, TG, P) or (G+1, TG, P),
    with row G (no tile) filled with `fill`."""
    x = x.reshape(G, TG, *x.shape[1:])
    if x.dim() == 4:
        x = x.transpose(1, 2)
    return torch.cat([x, torch.full((1, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])


def _from_group_major(x: torch.Tensor, G: int) -> torch.Tensor:
    """Inverse of _to_group_major (row G dropped)."""
    x = x[:G]
    if x.dim() == 4:
        x = x.transpose(1, 2)
    return x.reshape(G * x.shape[1], *x.shape[2:])


def packed_blend_forward_plain(tp, cg, k0, goff, tids, n_groups: int, ntx: int,
                               with_nt: bool = True, probe_wmax: bool = False):
    NB, _, TG, _ = tp.shape
    G = n_groups
    dev = tp.device
    start, nch, px, py = _packed_tiles(tp, cg, goff, tids, G, ntx)
    state = {"trans": torch.ones((G * TG, P), dtype=torch.float32, device=dev)}
    acc = torch.zeros((G * TG, 4, P), dtype=torch.float32, device=dev)
    nt = torch.zeros((NB, KC, TG), dtype=torch.int32, device=dev)
    march = torch.zeros((G + 1) * TG, dtype=torch.int32, device=dev)
    for alive, b, has, kc in _packed_slots(tp, start, nch, lambda: state["trans"]):
        march[:G * TG] += alive.to(torch.int32)
        p = tp[b, kc].reshape(G * TG, NF)
        w, state["trans"], acc = _slot_forward(p, px, py, alive, state["trans"], acc)
        if probe_wmax:
            val = torch.ceil(w.max(dim=1).values * 65536.0).to(torch.int32)
        elif with_nt:
            val = (w > 0.0).sum(dim=1).to(torch.int32)
        else:
            continue
        nt[b[has], kc] = val.reshape(G, TG)[has]
    return (_to_group_major(acc, G, TG, 0.0), _to_group_major(state["trans"], G, TG, 1.0), nt,
            march.reshape(G + 1, TG))


def packed_blend_backward_plain(tp, cg, k0, goff, tids, acc, trans_final, dacc, dtrans,
                                n_groups: int, ntx: int, march=None):
    """Marches by the stop rule itself; a given `march` (the forward's march
    lengths) must equal what it marched,
    else ValueError."""
    NB, _, TG, _ = tp.shape
    G = n_groups
    dev = tp.device
    start, nch, px, py = _packed_tiles(tp, cg, goff, tids, G, ntx)
    acc, trans_final, dacc, dtrans = (_from_group_major(x, G) for x in (acc, trans_final, dacc, dtrans))
    state = {"trans": torch.ones((G * TG, P), dtype=torch.float32, device=dev)}
    prefix = torch.zeros((G * TG, 4, P), dtype=torch.float32, device=dev)
    dtp = torch.zeros((NB, KC, TG, NF), dtype=torch.float32, device=dev)
    marched = torch.zeros((G + 1) * TG, dtype=torch.int32, device=dev)
    for alive, b, has, kc in _packed_slots(tp, start, nch, lambda: state["trans"]):
        marched[:G * TG] += alive.to(torch.int32)
        p = tp[b, kc].reshape(G * TG, NF)
        d, state["trans"], prefix = _slot_backward(p, px, py, alive, state["trans"], prefix, acc,
                                                   trans_final, dacc, dtrans)
        dtp[b[has], kc] = d.reshape(G, TG, NF)[has]
    if march is not None and not torch.equal(march.reshape(-1), marched):
        raise ValueError("march is not the march lengths of the forward on these inputs")
    return dtp



class PackedBlend(torch.autograd.Function):
    """packed_blend_forward_plain with packed_blend_backward_plain as its
    VJP (no gradient to the chunk maps or the per-slot counts)."""

    @staticmethod
    def forward(ctx, tp, cg, k0, goff, tids, n_groups, ntx, with_nt):
        acc, trans, nt, _march = packed_blend_forward_plain(tp, cg, k0, goff, tids, n_groups, ntx,
                                                            with_nt)
        ctx.save_for_backward(tp, cg, k0, goff, tids, acc, trans)
        ctx.n_groups, ctx.ntx = n_groups, ntx
        ctx.mark_non_differentiable(nt)
        return acc, trans, nt

    @staticmethod
    def backward(ctx, dacc, dtrans, _dnt):
        tp, cg, k0, goff, tids, acc, trans = ctx.saved_tensors
        dacc = torch.zeros_like(acc) if dacc is None else dacc.contiguous()
        dtrans = torch.zeros_like(trans) if dtrans is None else dtrans.contiguous()
        dtp = packed_blend_backward_plain(tp, cg, k0, goff, tids, acc, trans, dacc, dtrans,
                                          ctx.n_groups, ctx.ntx)
        return dtp, None, None, None, None, None, None, None


def blend_packed(tp, cg, k0, goff, tids, n_groups: int, ntx: int, with_nt: bool = True):
    """Differentiable (w.r.t. tp) packed blend."""
    return PackedBlend.apply(tp, cg, k0, goff, tids, n_groups, ntx, with_nt)
