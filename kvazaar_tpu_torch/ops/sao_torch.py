"""SAO search + application on the pipeline's device (PyTorch), whole
frame batched.

Search (non-normative): per-CTB statistics for all 4 edge-offset classes
(category counts / diff sums) and the 32-band histogram come from block
reductions over the full frame; offsets are the distortion-optimal
rounded estimates, rate-adjusted with a lambda in CABAC-bin units. The
type decision (off / band / edge class) is a per-CTB argmax, luma
independent, chroma joint over (Cb, Cr) because the syntax shares
sao_type_idx_chroma / sao_eo_class_chroma between them.

Integer statistics stay in int64 tensors (exact); the float32 gains are
formed in the reference's order (kvazaar_tpu/ops/sao_jax.py), and every
argmax takes the first maximum, so parameters and planes are identical.

Application is the normative spec 8.7.3 mapping, bit-exact vs the NumPy
oracle ops/sao.py::apply_sao_plane (neighbours read the pre-SAO deblocked
picture; picture-border samples with outside neighbours are skipped).
"""
from __future__ import annotations

import torch

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2

# eo class -> (neighbour a dy,dx ; neighbour b dy,dx), matching ops/sao.py
_EO_DIRS = (((0, -1), (0, 1)),
            ((-1, 0), (1, 0)),
            ((-1, -1), (1, 1)),
            ((1, -1), (-1, 1)))
# categories in offset order: cat -2 -> offsets[0] (>=0), -1 -> [1] (>=0),
# 1 -> [2] (<=0), 2 -> [3] (<=0)
_CAT_VALS = (-2, -1, 1, 2)
I32 = torch.int32
F32 = torch.float32


def _sub_mul(a, lam, b):
    """a - lam * b in float32 with one rounding, as the reference's
    compiled program computes it (the product and the difference
    contract into a fused multiply-add); float64 holds the product
    exactly."""
    return (a.to(torch.float64) - lam.to(torch.float64)
            * b.to(torch.float64)).to(F32)


def _eo_cat_maps(rec):
    """rec [H, W] int -> (cats [4, H, W] in -2..2, valid [4, H, W])."""
    h, w = rec.shape
    yy = torch.arange(h, device=rec.device)[:, None]
    xx = torch.arange(w, device=rec.device)[None, :]

    def sh(dy, dx):
        # edge-padded neighbour plane (clamped indices)
        return rec[(yy + dy).clamp(0, h - 1), (xx + dx).clamp(0, w - 1)]

    cats, valids = [], []
    for (ady, adx), (bdy, bdx) in _EO_DIRS:
        cats.append(torch.sign(rec - sh(ady, adx))
                    + torch.sign(rec - sh(bdy, bdx)))
        va = ((yy + ady >= 0) & (yy + ady < h)
              & (xx + adx >= 0) & (xx + adx < w))
        vb = ((yy + bdy >= 0) & (yy + bdy < h)
              & (xx + bdx >= 0) & (xx + bdx < w))
        valids.append(va & vb)
    return torch.stack(cats), torch.stack(valids)


def _breduce(x, n: int):
    """Block-reduce trailing [H, W] -> [H/n, W/n] (int64 sums)."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // n, n, w // n, n).sum(dim=(-3, -1),
                                                        dtype=torch.int64)


def _round_div(s, c):
    """Nearest-integer s/c (c >= 0), 0 where c == 0."""
    cs = c.clamp(min=1)
    q = torch.where(s >= 0, torch.div(2 * s + cs, 2 * cs,
                                      rounding_mode="floor"),
                    -torch.div(-2 * s + cs, 2 * cs, rounding_mode="floor"))
    return torch.where(c > 0, q, 0)


def _plane_option_stats(src, rec, n: int, lam, cats, valid,
                        bit_depth: int = 8):
    """Per-CTB rate-adjusted gains for every SAO option of one plane.

    Returns dict with: eo_net [4cls, R, C] (offset-rate-adjusted distortion
    gain), eo_offs [4cls, 4cat, R, C]; band_net [R, C], band_pos [R, C],
    band_offs [4, R, C]. Gains exclude the shared type/class/position bits
    (added by the caller's decision). lam: float32 0-d tensor."""
    cmax = (1 << (min(bit_depth, 10) - 5)) - 1
    dev = rec.device
    diff = src - rec
    # --- edge offsets ---
    eo_cnt, eo_sum = [], []
    for cv in _CAT_VALS:
        m = (cats == cv) & valid                       # [4, H, W]
        eo_cnt.append(_breduce(m, n))
        eo_sum.append(_breduce(torch.where(m, diff, 0), n))
    eo_cnt = torch.stack(eo_cnt, dim=1)                # [4cls, 4cat, R, C]
    eo_sum = torch.stack(eo_sum, dim=1)
    est = _round_div(eo_sum, eo_cnt)
    lo = torch.tensor([0, 0, -cmax, -cmax], device=dev)[None, :, None, None]
    hi = torch.tensor([cmax, cmax, 0, 0], device=dev)[None, :, None, None]
    offs = torch.minimum(torch.maximum(est, lo), hi)
    gain = 2 * offs * eo_sum - offs * offs * eo_cnt
    # drop an offset to 0 when its gain doesn't pay its extra TU bins
    keep = gain.to(F32) >= lam * offs.abs().to(F32)
    offs = torch.where(keep, offs, 0)
    gain = torch.where(keep, gain, 0)
    rate = offs.abs().sum(dim=1) + 4                   # TU bins, 4 offsets
    eo_net = _sub_mul(gain.sum(dim=1).to(F32), lam, rate)
    # --- band offsets ---
    band = rec >> (bit_depth - 5)
    b_cnt, b_sum = [], []
    for b in range(32):
        m = band == b
        b_cnt.append(_breduce(m, n))
        b_sum.append(_breduce(torch.where(m, diff, 0), n))
    b_cnt = torch.stack(b_cnt)                         # [32, R, C]
    b_sum = torch.stack(b_sum)
    boff = _round_div(b_sum, b_cnt).clamp(-cmax, cmax)
    bgain = 2 * boff * b_sum - boff * boff * b_cnt
    bkeep = bgain.to(F32) >= lam * (boff.abs() + 1).to(F32)
    boff = torch.where(bkeep, boff, 0)
    bnet = _sub_mul(torch.where(bkeep, bgain, 0).to(F32), lam,
                    boff.abs() + 1 + (boff != 0).to(boff.dtype))
    # window sums of 4 consecutive bands, added in order
    win = torch.stack([bnet[p] + bnet[p + 1] + bnet[p + 2] + bnet[p + 3]
                       for p in range(29)])
    band_pos = torch.argmax(win, dim=0)                # [R, C], first max
    band_net = torch.gather(win, 0, band_pos[None])[0]
    band_offs = torch.stack([torch.gather(boff, 0, (band_pos + i)[None])[0]
                             for i in range(4)])       # [4, R, C]
    return {"eo_net": eo_net, "eo_offs": offs,
            "band_net": band_net, "band_pos": band_pos.to(I32),
            "band_offs": band_offs}


def _select(st, typ, cls):
    """Pick per-CTB offset/pos tensors for a (typ, cls) decision."""
    eo = st["eo_offs"]
    eo_offs = torch.gather(eo, 0, cls.long()[None, None].expand(
        1, *eo.shape[1:]))[0]                          # [4cat, R, C]
    offs = torch.where(typ[None] == SAO_EDGE, eo_offs,
                       torch.where(typ[None] == SAO_BAND, st["band_offs"],
                                   0))
    pos = torch.where(typ == SAO_BAND, st["band_pos"], 0)
    return offs.to(I32), pos.to(I32)


def _expand(m, n: int):
    return m.repeat_interleave(n, 0).repeat_interleave(n, 1)


def _apply(rec, cats, valid, typ, cls, offs, pos, n: int, max_val=255,
           bit_depth=8):
    """Apply per-CTB SAO params to one plane. offs [4, R, C], rest [R, C]."""
    typ_p = _expand(typ, n)
    cls_p = _expand(cls, n).long()[None]
    cat_sel = torch.gather(cats, 0, cls_p)[0]
    val_sel = torch.gather(valid, 0, cls_p)[0]
    off_eo = torch.zeros_like(rec)
    for i, cv in enumerate(_CAT_VALS):
        off_eo = off_eo + _expand(offs[i], n) * (cat_sel == cv)
    band = rec >> (bit_depth - 5)
    pos_p = _expand(pos, n)
    off_band = torch.zeros_like(rec)
    for i in range(4):
        off_band = off_band + _expand(offs[i], n) * \
            (band == ((pos_p + i) & 31))
    out = rec + torch.where((typ_p == SAO_EDGE) & val_sel, off_eo, 0) \
        + torch.where(typ_p == SAO_BAND, off_band, 0)
    return out.clamp(0, max_val).to(rec.dtype)


def _type_bits(allow_band: bool, allow_edge: bool):
    big = 1e18
    return (0.0 if allow_band else big, 0.0 if allow_edge else big)


def _decide(eo_net, band_net, lam, band_bits: int, allow_band, allow_edge):
    """(typ, cls) per CTB: off / band / best edge class by rate-adjusted
    gain; band_bits are the band type's fixed bins beyond the offsets."""
    pen_band, pen_edge = _type_bits(allow_band, allow_edge)
    g_off = -lam * 1.0
    g_band = band_net - lam * band_bits - pen_band
    cls = torch.argmax(eo_net, dim=0)                  # first max
    g_edge = torch.gather(eo_net, 0, cls[None])[0] - lam * (2 + 2) \
        - pen_edge
    typ = torch.where((g_band > g_off) & (g_band >= g_edge), SAO_BAND,
                      torch.where(g_edge > g_off, SAO_EDGE, SAO_OFF))
    return typ.to(I32), cls.to(I32)


def sao_luma(src, rec, n: int, lam, allow_band=True, allow_edge=True,
             bit_depth=8):
    """Search + apply SAO for the luma plane (int32 [H, W] planes, lam a
    float32 0-d tensor). Returns (filtered, params) with params: typ/cls/
    pos [R, C] int32, offs [4, R, C] int32."""
    cats, valid = _eo_cat_maps(rec)
    st = _plane_option_stats(src, rec, n, lam, cats, valid, bit_depth)
    typ, cls = _decide(st["eo_net"], st["band_net"], lam, 2 + 5,
                       allow_band, allow_edge)
    offs, pos = _select(st, typ, cls)
    out = _apply(rec, cats, valid, typ, cls, offs, pos, n,
                 max_val=(1 << bit_depth) - 1, bit_depth=bit_depth)
    return out, {"typ": typ, "cls": cls, "offs": offs, "pos": pos}


def sao_chroma(src_cb, src_cr, rec_cb, rec_cr, n: int, lam,
               allow_band=True, allow_edge=True, bit_depth=8):
    """Joint Cb/Cr SAO (shared type + EO class). Returns
    (filtered_cb, filtered_cr, params) with offs/pos per component."""
    cats_b, valid_b = _eo_cat_maps(rec_cb)
    cats_r, valid_r = _eo_cat_maps(rec_cr)
    st_b = _plane_option_stats(src_cb, rec_cb, n, lam, cats_b, valid_b,
                               bit_depth)
    st_r = _plane_option_stats(src_cr, rec_cr, n, lam, cats_r, valid_r,
                               bit_depth)
    typ, cls = _decide(st_b["eo_net"] + st_r["eo_net"],
                       st_b["band_net"] + st_r["band_net"], lam,
                       2 + 5 + 5, allow_band, allow_edge)
    offs_b, pos_b = _select(st_b, typ, cls)
    offs_r, pos_r = _select(st_r, typ, cls)
    mv = (1 << bit_depth) - 1
    out_b = _apply(rec_cb, cats_b, valid_b, typ, cls, offs_b, pos_b, n,
                   max_val=mv, bit_depth=bit_depth)
    out_r = _apply(rec_cr, cats_r, valid_r, typ, cls, offs_r, pos_r, n,
                   max_val=mv, bit_depth=bit_depth)
    return out_b, out_r, {"typ": typ, "cls": cls, "offs_cb": offs_b,
                          "pos_cb": pos_b, "offs_cr": offs_r,
                          "pos_cr": pos_r}
