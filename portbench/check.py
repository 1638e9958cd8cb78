"""Deciding `correct`.

After the window has closed and the program's device state is freed, the
plain reference (portbench/reference/, a frozen copy of the validation
decoder that imports nothing of the program) decodes the program's stream
in worker processes and holds it to the program's outputs and to the
configuration's guarantees. Per sampled frame, with the decode running
from the frame's IDR picture through it (every picture decoded on the way
is compared too):

- undecodable: the picture does not decode (a parse or syntax fault);
- hash_bad: its decoded-picture checksum SEI disagrees with the decode,
  or is missing (the configuration states --hash checksum);
- recon_diff: samples of the decoded picture that differ from the
  program's reconstruction (recon_out);
- qp_off: its slice QP differs from the one the configuration states for
  its place in the GOP (the configuration file's slice_qp);
- psnr_gap_db: the gap between the luma PSNR that the program reports for
  the picture (info["psnr"], from its device SSE over the coded picture,
  conformance padding included) and the reference's, of the decoded
  picture against the benchmark's own source frame padded by edge
  replication as the encoder pads it;
- mode_not_best: of a sample of the picture's intra prediction units
  (drawn from the seed), those whose signalled luma mode is not of least
  SATD among the 35 by the mode decision that the configurations state
  (reference/intra_search.py, worked out again from the source frame):
  the search's decisions, which a conformant stream does not show.

And over the run: missing, frames fed to the program that it returned no
coded picture for. Each number has its limit in limits/<cell>.json.
"""
from __future__ import annotations

import os

import numpy as np

NUMBERS = ("missing", "undecodable", "hash_bad", "recon_diff", "qp_off",
           "psnr_gap_db", "mode_not_best")
# intra prediction units checked a picture
UNITS_PER_PICTURE = 256


def nal_starts(data: bytes) -> list[tuple[int, int]]:
    """(offset of the start code, NAL unit type) of each NAL unit."""
    out = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0 and i + 3 < len(data):
        start = i - 1 if i > 0 and data[i - 1] == 0 else i
        out.append((start, (data[i + 3] >> 1) & 0x3F))
        i = data.find(b"\x00\x00\x01", i + 3)
    return out


def parameter_sets(chunk: bytes) -> bytes:
    """The bytes of an access unit before its first slice NAL unit: the
    VPS, SPS and PPS that the stream's first picture carries."""
    for off, typ in nal_starts(chunk):
        if typ < 32:
            return chunk[:off]
    return chunk


def expected_qp(slice_qp: dict, since_idr: int) -> int:
    """The slice QP that the configuration states for the picture
    since_idr pictures after its IDR picture: `intra` for the IDR, then
    `inter_cycle` repeated (the GOP's layers)."""
    if since_idr == 0:
        return int(slice_qp["intra"])
    cyc = slice_qp["inter_cycle"]
    return int(cyc[(since_idr - 1) % len(cyc)])


def pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")


def psnr_padded(full_y: np.ndarray, src_y: np.ndarray) -> float:
    """Luma PSNR of a decoded picture (conformance padding included)
    against the source padded by edge replication to its size."""
    h, w = full_y.shape
    d = full_y.astype(np.int64) - pad_edge(src_y, h, w).astype(np.int64)
    sse = np.int64((d * d).sum())
    mv = 255.0
    return 99.0 if sse == 0 else float(10.0 * np.log10(mv ** 2 * (h * w)
                                                        / sse))


def decode_chain(job: dict) -> list[dict]:
    """Worker: decode job["stream"] (the parameter sets and the access
    units of frames job["frames"], an IDR picture first) with the
    reference decoder and judge each picture. Returns one dict a frame:
    decoded, hash_ok, qp, recon_diff, psnr_gap, mode_not_best, units."""
    from portbench.reference.decoder.decoder import HEVCDecoder
    from portbench.reference.intra_search import check_modes
    dec = HEVCDecoder()
    err = None
    try:
        dec.decode(job["stream"])
    except Exception as e:        # a stream that does not parse
        err = f"{type(e).__name__}: {e}"
    pics = dec.frames
    out = []
    for j, k in enumerate(job["frames"]):
        if j >= len(pics):
            out.append({"frame": k, "decoded": False, "error": err})
            continue
        p = pics[j]
        rec = job["recon"][j]
        diff = sum(int(np.count_nonzero(a.astype(np.int32)
                                        != b.astype(np.int32)))
                   if a.shape == b.shape else int(b.size)
                   for a, b in zip(p.planes, rec))
        gap = abs(job["claimed_psnr"][j]
                  - psnr_padded(p.full_planes[0], job["src_y"][j]))
        h, w = p.full_planes[0].shape
        bad, units = check_modes(
            pad_edge(job["src_y"][j], h, w), p.pu_log2, p.intra_mode,
            np.random.default_rng([job["seed"], k, 0x3D5]),
            job["units"])
        out.append({"frame": k, "decoded": True,
                    "hash_ok": p.hash_ok is True,
                    "qp": int(p.slice_qp), "expect_qp": job["expect_qp"][j],
                    "slice_type": int(p.slice_type),
                    "recon_diff": diff, "psnr_gap": gap,
                    "mode_not_best": bad, "units": units})
    return out


def chains(idr: list[bool], sample: list[int]) -> list[list[int]]:
    """The frames to decode for a sample: each sampled frame's run from
    its IDR picture, runs that share an IDR merged."""
    ends: dict[int, int] = {}
    for k in sample:
        s = k
        while s > 0 and not idr[s]:
            s -= 1
        ends[s] = max(ends.get(s, s), k)
    return [list(range(s, e + 1)) for s, e in sorted(ends.items())]


def run_check(coded: list[dict], sources: dict, sample: list[int],
              slice_qp: dict, n_fed: int, limits: dict, seed: int = 0,
              units: int = UNITS_PER_PICTURE) -> dict:
    """coded: per coded frame, in coding order, {"chunk", "info"};
    sources: frame index -> (y, cb, cr) of every frame to decode. Returns
    {"numbers": {name: value}, "limits", "correct", "failed", "detail"}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    idr = [c["info"]["slice_type"] == 2 for c in coded]
    head = parameter_sets(coded[0]["chunk"])
    jobs = []
    for ch in chains(idr, sorted(set(sample))):
        start = ch[0]
        stream = (b"" if start == 0 else head) + b"".join(
            coded[k]["chunk"] for k in ch)
        jobs.append({
            "stream": stream, "frames": ch,
            "recon": [tuple(np.asarray(a) for a in coded[k]["info"]
                            ["recon_out"]) for k in ch],
            "claimed_psnr": [float(coded[k]["info"]["psnr"][0])
                             for k in ch],
            "src_y": [sources[k][0] for k in ch],
            "expect_qp": [expected_qp(slice_qp, k - start) for k in ch],
            "seed": int(seed) & (2 ** 63 - 1), "units": units})
    n = max(1, min(len(jobs), os.cpu_count() or 1))
    with ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = [r for rs in pool.map(decode_chain, jobs) for r in rs]
    nums = dict.fromkeys(NUMBERS, 0)
    nums["missing"] = max(0, n_fed - len(coded))
    nums["psnr_gap_db"] = 0.0
    bad = set()
    for r in results:
        if not r["decoded"]:
            nums["undecodable"] += 1
            bad.add(r["frame"])
            continue
        nums["hash_bad"] += not r["hash_ok"]
        nums["recon_diff"] += r["recon_diff"]
        nums["qp_off"] += r["qp"] != r["expect_qp"]
        nums["psnr_gap_db"] = max(nums["psnr_gap_db"], r["psnr_gap"])
        nums["mode_not_best"] += r["mode_not_best"]
        if (not r["hash_ok"] or r["recon_diff"] or r["qp"] != r["expect_qp"]
                or r["psnr_gap"] > limits["psnr_gap_db"]
                or r["mode_not_best"] > limits["mode_not_best"]):
            bad.add(r["frame"])
    correct = all(nums[k] <= limits[k] for k in NUMBERS)
    return {"numbers": nums, "limits": {k: limits[k] for k in NUMBERS},
            "correct": correct, "failed": len(bad) + nums["missing"],
            "decoded": len(results),
            "units": {t: [sum(r["units"] for r in results
                              if r.get("slice_type") == s),
                          sum(r["mode_not_best"] for r in results
                              if r.get("slice_type") == s)]
                      for t, s in (("I", 2), ("B", 0))},
            "errors": sorted({r["error"] for r in results
                              if not r["decoded"] and r.get("error")})}
