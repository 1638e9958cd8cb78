"""Motion-estimation kernels: `me_refine` and `me_eval`.

Each function has a plain PyTorch version (`*_plain`, the arithmetic of
the reference's XLA twins: `_me_xla_one`; `_eval_exact` for each list
of a candidate pair, each on its own reference picture, then `_bi_avg`
and `_satd_tiles` for the pair; or for the one list of a P candidate) and
a wrapper that launches a hand-written CUDA kernel (csrc/me_refine.cu,
csrc/me_eval.cu) on CUDA tensors. A CPU tensor takes the plain version;
a CUDA tensor always takes the kernel.

Both read UNPADDED [H, W] reference planes (me_eval the plane a pair's
index names in a stack [R, H, W]) and clamp every row and column index
into them, which equals edge padding for any motion vector.

The kernels are built on first use with nvcc into the package's _build/
directory and bound with ctypes (plain C launch functions returning
cudaGetLastError()).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from .mc import LUMA_FILTERS

# MV-cost prior applied during the refine (penalty = (lam64 * P) >> 8)
PRIOR_INT = (0, 2, 3, 3)        # full-pel |delta| 0..3
PRIOR_QPEL = (0, 1, 2, 2)       # quarter-pel |delta| 0..3
MV_CLAMP = 96                   # candidate full-pel MV range
REFINE = 3                      # +-3 integer refine window


def prior_int_table() -> list[int]:
    return [PRIOR_INT[abs(dy - 3)] + PRIOR_INT[abs(dx - 3)]
            for dy in range(7) for dx in range(7)]


def prior_qpel_table() -> list[int]:
    return [PRIOR_QPEL[abs(qy)] + PRIOR_QPEL[abs(qx)]
            for qy in range(-3, 4) for qx in range(-3, 4)]


# ---------------------------------------------------------------------
# shared integer helpers
# ---------------------------------------------------------------------

def _wht8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """8-point Walsh-Hadamard butterflies along `dim` (size 8)."""
    t = t.movedim(dim, -1)
    shape = t.shape
    for s in (1, 2, 4):
        v = t.reshape(*shape[:-1], 8 // (2 * s), 2, s)
        a, b = v[..., 0, :], v[..., 1, :]
        t = torch.stack([a + b, a - b], dim=-2).reshape(shape)
    return t.movedim(-1, dim)


def satd_tiles(diff: torch.Tensor) -> torch.Tensor:
    """SATD over trailing [.., h, w] (multiples of 8) via 8x8 Hadamard
    tiles, (sum|t| + 2) >> 2 per tile; exact int32."""
    mh, m = diff.shape[-2] // 8, diff.shape[-1] // 8
    d = diff.to(torch.int32).reshape(*diff.shape[:-2], mh, 8, m, 8)
    d = d.movedim(-2, -3)
    t = _wht8(_wht8(d, -1), -2)
    s = (t.abs().sum(dim=(-1, -2), dtype=torch.int32) + 2) >> 2
    return s.sum(dim=(-1, -2), dtype=torch.int32)


def _block_origins(L: int, n: int, cols: int, device) -> tuple:
    bid = torch.arange(L, device=device)
    return (bid // cols) * n, (bid % cols) * n


def clamped_window(ref: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   hh: int, ww: int, sel: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """[L, hh, ww] clamped window of ref starting at (ys, xs) [L]; ref is
    one plane [H, W], or a stack [R, H, W] with the plane of each block
    sel [L]."""
    H, W = ref.shape[-2:]
    iy = (ys[:, None] + torch.arange(hh, device=ref.device)).clamp(0, H - 1)
    ix = (xs[:, None] + torch.arange(ww, device=ref.device)).clamp(0, W - 1)
    if sel is None:
        return ref[iy[:, :, None], ix[:, None, :]]
    return ref[sel.long()[:, None, None], iy[:, :, None], ix[:, None, :]]


def _lf(device) -> torch.Tensor:
    return torch.as_tensor(LUMA_FILTERS, dtype=torch.int32, device=device)


def mc_luma_plain(ref: torch.Tensor, mv: torch.Tensor, y0: torch.Tensor,
                  x0: torch.Tensor, n: int, hi: bool = False,
                  maxv: int = 255, sel: torch.Tensor | None = None,
                  nh: int | None = None) -> torch.Tensor:
    """Exact quarter-pel HEVC luma MC of [L, nh, n] blocks (nh = n when
    None) at origins (y0, x0) with per-block qpel mv [L, 2] on ref [H, W]
    (or on plane sel [L] of a stack [R, H, W]); hi=True returns the
    14-bit intermediate for exact bi-prediction."""
    nh = n if nh is None else nh
    win = clamped_window(ref, y0 + (mv[:, 1] >> 2) - 3,
                         x0 + (mv[:, 0] >> 2) - 3, nh + 7, n + 7, sel)
    f = _lf(ref.device)
    cx = f[mv[:, 0] & 3]
    cy = f[mv[:, 1] & 3]
    h14 = sum(cx[:, k, None, None] * win[:, :, k:k + n] for k in range(8))
    v = sum(cy[:, k, None, None] * h14[:, k:k + nh, :]
            for k in range(8)) >> 6
    if hi:
        return v
    return ((v + 32) >> 6).clamp(0, maxv)


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------

def me_refine_plain(ref, src_blocks, cands, lam64, n: int, cols: int,
                    maxv: int = 255):
    """Integer +-3 SAD refine around every candidate full-pel MV (strict
    < in (cand, dy, dx) order, prior (lam64*PRIOR_INT)>>8), then SATD at
    all 49 quarter-pel offsets around the winner (strict < in (qy, qx)
    order, prior (lam64*PRIOR_QPEL)>>8). Returns (mv_q [L, 2], satd [L],
    pred [L, n, n]) — satd without the prior."""
    dev = ref.device
    L, K = cands.shape[0], cands.shape[1]
    y0, x0 = _block_origins(L, n, cols, dev)
    lam = torch.as_tensor(lam64, dtype=torch.int32, device=dev).reshape(())
    pi_tab = prior_int_table()
    W = REFINE
    best_sad = torch.full((L,), 1 << 30, dtype=torch.int32, device=dev)
    best_mv = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    for k in range(K):
        mvk = cands[:, k].clamp(-MV_CLAMP, MV_CLAMP)
        win = clamped_window(ref, y0 + mvk[:, 1] - W, x0 + mvk[:, 0] - W,
                             n + 2 * W, n + 2 * W)
        for dy in range(2 * W + 1):
            for dx in range(2 * W + 1):
                cand = win[:, dy:dy + n, dx:dx + n]
                sad = (cand - src_blocks).abs().sum(dim=(1, 2),
                                                    dtype=torch.int32)
                sad = sad + ((lam * pi_tab[dy * 7 + dx]) >> 8)
                better = sad < best_sad
                mvc = mvk + torch.tensor([dx - W, dy - W], dtype=torch.int32,
                                         device=dev)
                best_sad = torch.where(better, sad, best_sad)
                best_mv = torch.where(better[:, None], mvc, best_mv)
    mv_int = best_mv
    win = clamped_window(ref, y0 + mv_int[:, 1] - 4,
                         x0 + mv_int[:, 0] - 4, n + 8, n + 8)
    f = LUMA_FILTERS
    # the seven horizontal variants (qx = -3..3), rows 0..n+7
    h14 = []
    for qx in range(-3, 4):
        c0 = 1 + (qx >> 2)
        cf = f[qx & 3]
        h14.append(sum(int(cf[k]) * win[:, :, c0 + k:c0 + k + n]
                       for k in range(8)))
    pq_tab = prior_qpel_table()
    best_s = torch.full((L,), 1 << 30, dtype=torch.int32, device=dev)
    best_raw = torch.zeros((L,), dtype=torch.int32, device=dev)
    best_q = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    best_p = torch.zeros((L, n, n), dtype=torch.int32, device=dev)
    for qy in range(-3, 4):
        r0 = 1 + (qy >> 2)
        cf = f[qy & 3]
        for qx in range(-3, 4):
            h = h14[qx + 3]
            v = sum(int(cf[k]) * h[:, r0 + k:r0 + k + n, :]
                    for k in range(8)) >> 6
            p = ((v + 32) >> 6).clamp(0, maxv)
            raw = satd_tiles(src_blocks - p)
            s = raw + ((lam * pq_tab[(qy + 3) * 7 + qx + 3]) >> 8)
            take = s < best_s
            mvq = mv_int * 4 + torch.tensor([qx, qy], dtype=torch.int32,
                                            device=dev)
            best_s = torch.where(take, s, best_s)
            best_raw = torch.where(take, raw, best_raw)
            best_q = torch.where(take[:, None], mvq, best_q)
            best_p = torch.where(take[:, None, None], p, best_p)
    return best_q, best_raw, best_p


def eval_one_plain(ref, src_blocks, mvs, n: int, cols: int, hi: bool,
                   maxv: int = 255, sel=None):
    """SATD of one exact qpel MV per block of one list plus its
    prediction (the 14-bit intermediate when hi), on ref [H, W] or on
    plane sel [L] of a stack [R, H, W]. Returns (satd [L],
    pred [L, n, n])."""
    L = src_blocks.shape[0]
    y0, x0 = _block_origins(L, n, cols, ref.device)
    pred = mc_luma_plain(ref, mvs, y0, x0, n, hi=hi, maxv=maxv, sel=sel)
    pr = ((pred + 32) >> 6).clamp(0, maxv) if hi else pred
    return satd_tiles(src_blocks - pr), pred


def me_eval_plain(ref0, ref1, src_blocks, mv0, mv1, r0, r1, *, n: int,
                  cols: int, maxv: int = 255, want_satd: bool = True,
                  want_pred: bool = False):
    """Exact evaluation of K candidate pairs (list 0 MV and reference,
    list 1 MV and reference) per block: mv0, mv1 int32 [L, K, 2] qpel
    (x, y) on the planes r0, r1 int32 [L, K] of the stacks ref0, ref1
    [R, H, W]. Returns (satd, pred): satd = (satd0, satd1, satd_bi), each
    int32 [L, K], with want_satd, else None, satd_l being the SATD of the
    uni-prediction of list l and satd_bi that of the pair's exact
    bi-average; pred = (v0, v1), the 14-bit intermediates [L, n, n] of
    pair 0, with want_pred, else None. With ref1, mv1 and r1 None (the
    one-list mode of P slices) the candidates are list 0's alone:
    satd = (satd0,) and pred = (v0,)."""
    sat, pred = [], None
    for k in range(mv0.shape[1]):
        s0, v0 = eval_one_plain(ref0, src_blocks, mv0[:, k], n, cols, True,
                                maxv, r0[:, k])
        if ref1 is None:
            if k == 0 and want_pred:
                pred = (v0,)
            sat.append((s0,))
            continue
        s1, v1 = eval_one_plain(ref1, src_blocks, mv1[:, k], n, cols, True,
                                maxv, r1[:, k])
        if k == 0 and want_pred:
            pred = (v0, v1)
        if want_satd:
            pb = ((v0 + v1 + 64) >> 7).clamp(0, maxv)
            sat.append((s0, s1, satd_tiles(src_blocks - pb)))
    if not want_satd:
        return None, pred
    return tuple(torch.stack(c, dim=1) for c in zip(*sat)), pred


# ---------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("me_refine", "me_eval")
_libs: dict = {}


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def nvcc_command(src: str, out: str) -> list:
    """nvcc command line that builds the kernel source src (which may
    include csrc/me_common.cuh) into the shared library out, for sm_90a,
    printing ptxas's registers and spills."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", _CSRC, "-o", out, src]


def build_kernels(names=KERNELS, force: bool = False) -> None:
    """Compile the kernel sources with nvcc, one process per source, all
    started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        src = os.path.join(_CSRC, f"{name}.cu")
        so = _so_path(name)
        if (not force and os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            continue
        procs.append((name, so, subprocess.Popen(
            nvcc_command(src, so + ".tmp"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + out.decode(errors="replace"))
        os.replace(so + ".tmp", so)
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "wb") as f:
            f.write(out)


def _lib(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_kernels((name,))
    _libs[name] = lib = bind(name, _so_path(name))
    return lib


def bind(name: str, path: str):
    """Load the built library of kernel `name` from path and declare its
    C functions."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"kvz_{name}")
    if name == "me_refine":
        # ref, H, W, src, cands, K, lam, L, n, cols, maxv, mv, satd, pred,
        # stream
        fn.argtypes = [vp, ci, ci, vp, vp, ci, vp, ci, ci, ci, ci,
                       vp, vp, vp, vp]
    else:
        # ref0, ref1, H, W, src, mv0, mv1, r0, r1, K, L, n, cols, maxv,
        # satd, pred, stream
        fn.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                       ci, vp, vp, vp]
    fn.restype = ci
    info = getattr(lib, f"kvz_{name}_info")
    # me_eval's takes the number of lists between the size and the output
    info.argtypes = ([ci, ci] if name == "me_eval" else [ci]) \
        + [ctypes.POINTER(ci)]
    info.restype = ci
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(ref, src_blocks, n, cols):
    if n not in (8, 16, 32, 64):
        raise ValueError(f"block size {n} not supported")
    if ref.dim() != 2 or src_blocks.dim() != 3:
        raise ValueError("ref must be [H, W] and src_blocks [L, n, n]")
    L = src_blocks.shape[0]
    _check(ref, "ref", tuple(ref.shape), ref.device)
    _check(src_blocks, "src_blocks", (L, n, n), ref.device)
    if L % cols:
        raise ValueError("block count must be a multiple of cols")
    return L


def me_refine(ref, src_blocks, cands, lam64, *, n: int, cols: int,
              maxv: int = 255):
    """See me_refine_plain. ref int32 [H, W]; src_blocks int32 [L, n, n]
    (raster order, `cols` blocks per row); cands int32 [L, K, 2] (x, y)
    full-pel; lam64 int32 [1]."""
    L = _check_common(ref, src_blocks, n, cols)
    dev = ref.device
    K = cands.shape[1] if cands.dim() == 3 else -1
    _check(cands, "cands", (L, K, 2), dev)
    _check(lam64, "lam64", (1,), dev)
    if K * 49 > 1 << 16:
        # the kernel's argmin keys hold the scan position c * 49 + o in
        # 16 bits (cost_key in csrc/me_refine.cu)
        raise ValueError(f"me_refine takes at most {(1 << 16) // 49} "
                         f"candidates per block, got {K}")
    if dev.type == "cpu":
        return me_refine_plain(ref, src_blocks, cands, lam64, n, cols, maxv)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 0 <= maxv <= 1023:
        # the kernel's float32 sub-pel sweep is exact up to 10 bits
        raise ValueError(f"me_refine kernel takes maxv up to 1023, "
                         f"got {maxv}")
    fn = _lib("me_refine").kvz_me_refine
    mv = torch.empty((L, 2), dtype=torch.int32, device=dev)
    satd = torch.empty((L,), dtype=torch.int32, device=dev)
    pred = torch.empty((L, n, n), dtype=torch.int32, device=dev)
    H, W = ref.shape
    err = fn(ref.data_ptr(), H, W, src_blocks.data_ptr(), cands.data_ptr(),
             K, lam64.data_ptr(), L, n, cols, maxv, mv.data_ptr(),
             satd.data_ptr(), pred.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"me_refine launch failed: CUDA error {err}")
    me_refine.launches += 1
    return mv, satd, pred


def kernel_occupancy(name: str, n: int, lists: int = 2) -> dict:
    """Launch geometry of kernel `name`'s size-n kernel (me_eval's with
    `lists` lists) on the current card: blocks per SM that its launch
    achieves, threads and source blocks per block, dynamic shared bytes
    per block, registers and local (spill) bytes per thread."""
    out = (ctypes.c_int * 6)()
    fn = getattr(_lib(name), f"kvz_{name}_info")
    err = fn(n, lists, out) if name == "me_eval" else fn(n, out)
    if err != 0:
        raise RuntimeError(f"{name}_info failed: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "threads", "sources", "smem", "regs",
                     "local"), out))


def me_eval(ref0, ref1, src_blocks, mv0, mv1, r0, r1, *, n: int,
            cols: int, maxv: int = 255, want_satd: bool = True,
            want_pred: bool = False):
    """See me_eval_plain. ref0, ref1 int32 reference stacks [R0, H, W],
    [R1, H, W] (may be one tensor); src_blocks int32 [L, n, n] (raster
    order, `cols` blocks per row); mv0, mv1 int32 [L, K, 2] exact qpel
    MVs (x, y); r0, r1 int32 [L, K], each pair's plane of each stack.
    ref1, mv1 and r1 all None select the one-list mode (P slices).
    want_pred takes K = 1. Held to the kernel's limits on every device,
    the reference indices included (reading their range waits for the
    device)."""
    if ref0.dim() != 3 or ref0.shape[0] < 1:
        raise ValueError("ref0 must be a reference stack [R, H, W]")
    one = ref1 is None
    if any((a is None) != one for a in (mv1, r1)):
        raise ValueError("ref1, mv1 and r1 are all given (two lists) or "
                         "all None (one list)")
    L = _check_common(ref0[0], src_blocks, n, cols)
    dev = ref0.device
    _check(ref0, "ref0", tuple(ref0.shape), dev)
    R1 = -1 if one or ref1.dim() != 3 else ref1.shape[0]
    K = mv0.shape[1] if mv0.dim() == 3 else -1
    _check(mv0, "mv0", (L, K, 2), dev)
    _check(r0, "r0", (L, K), dev)
    if not one:
        _check(ref1, "ref1", (R1,) + tuple(ref0.shape[1:]), dev)
        _check(mv1, "mv1", (L, K, 2), dev)
        _check(r1, "r1", (L, K), dev)
    if K < 1 or not (want_satd or want_pred):
        raise ValueError("me_eval needs K >= 1 pairs and an output")
    if want_pred and K != 1:
        raise ValueError(f"me_eval writes predictions for K = 1 only, "
                         f"got K = {K}")
    if not 0 <= maxv <= 1023:
        # the kernel's float32 arithmetic is exact up to 10 bits
        raise ValueError(f"me_eval takes maxv up to 1023, got {maxv}")
    lists = (("r0", r0, ref0.shape[0]),) + (() if one else
                                            (("r1", r1, R1),))
    ranges = torch.stack([f(r) for _, r, _ in lists
                          for f in (torch.min, torch.max)]).tolist()
    for (name, _, R), lo, hi in zip(lists, ranges[::2], ranges[1::2]):
        if lo < 0 or hi >= R:
            # the kernel reads plane r of its stack unchecked
            raise ValueError(f"me_eval reference indices out of range: "
                             f"{name} in [{lo}, {hi}] of {R} planes")
    if dev.type == "cpu":
        return me_eval_plain(ref0, ref1, src_blocks, mv0, mv1, r0, r1, n=n,
                             cols=cols, maxv=maxv, want_satd=want_satd,
                             want_pred=want_pred)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return launch_eval(ref0, ref1, src_blocks, mv0, mv1, r0, r1, n=n,
                       cols=cols, maxv=maxv, want_satd=want_satd,
                       want_pred=want_pred)


def launch_eval(ref0, ref1, src_blocks, mv0, mv1, r0, r1, *, n: int,
                cols: int, maxv: int, want_satd: bool, want_pred: bool):
    """Launch the me_eval kernel on arguments that me_eval has checked
    (CUDA tensors only); no host synchronisation. Kernel timings call it
    directly, so that the index check's wait stays out of them."""
    dev = ref0.device
    L, K = mv0.shape[:2]
    lists = 1 if ref1 is None else 2
    fn = _lib("me_eval").kvz_me_eval
    satd = (torch.empty((3 if lists == 2 else 1, L, K), dtype=torch.int32,
                        device=dev) if want_satd else None)
    pred = (torch.empty((lists, L, n, n), dtype=torch.int32, device=dev)
            if want_pred else None)
    H, W = ref0.shape[1:]

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = fn(ref0.data_ptr(), ptr(ref1), H, W, src_blocks.data_ptr(),
             mv0.data_ptr(), ptr(mv1), r0.data_ptr(), ptr(r1),
             K, L, n, cols, maxv, ptr(satd), ptr(pred),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"me_eval launch failed: CUDA error {err}")
    me_eval.launches += 1
    me_eval.one_list_launches += lists == 1
    return (tuple(satd) if want_satd else None,
            tuple(pred) if want_pred else None)


# launch counts (me_eval's of both modes, and of its one-list mode alone)
me_refine.launches = 0
me_eval.launches = 0
me_eval.one_list_launches = 0
