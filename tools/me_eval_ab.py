"""A/B timing of me_eval kernel sources on one NVIDIA GPU.

    python3 tools/me_eval_ab.py SRC.cu [SRC.cu ...] [--rounds R]

Builds each source (nvcc for sm_90a, one process per source, all started
together; a source may include csrc/me_common.cuh) into
kvazaar_tpu_torch/_build/ab/, binds it in place of the built me_eval and
holds it bit-exact against me_eval_plain at the 1080p shapes of the main
path (chip_smoke.eval_errors on a synthetic frame and on the tie-heavy
planes). Then, in R rounds (default 2) that take the sources in turn,
times each block size's three launches of one B frame
(chip_smoke.EVAL_CALLS: the winners' pair, the merge candidates, the
final prediction) with two reference pictures a list, list 1 being list
0, one call at a time through me.launch_eval (chip_smoke.time_calls: device
ms from CUDA events, beside the wall ms of the same calls issued from
the host). Prints each source's sha256, ptxas's registers and spills,
its blocks per SM, the ms of every call and round, and per source the
mean B-frame total beside the bound. Exits non-zero on a mismatch or
without a card.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> None:
    import numpy as np
    import torch
    from chip_smoke import (EVAL_CALLS, H, PIPE_LANES, W, bound_ms,
                            eval_errors, eval_pictures, eval_work, fail,
                            kernel_inputs,
                            open_device, synth_frames, tie_inputs,
                            tie_planes, time_calls)
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        fail("no kernel source given")
    me, _, name_limit, rates = open_device(torch)
    out_dir = os.path.join(me.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    libs, procs = {}, []
    for src in argv:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(out_dir, f"me_eval_{digest}.so")
        procs.append((src, digest, so, subprocess.Popen(
            me.nvcc_command(src, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    for src, digest, so, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            fail(f"nvcc failed for {src}:\n{out}")
        print(f"build {digest} ({src}): " + " | ".join(
            ln.strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        libs[digest] = me.bind("me_eval", so)

    hp, wp = H + (-H) % 64, W + (-W) % 64
    ref, src_plane, ref1 = (torch.from_numpy(f[0].astype(np.int32)).cuda()
                            for f in synth_frames(3, wp, hp))
    gen = torch.Generator(device="cpu").manual_seed(1)
    inputs = {n: kernel_inputs(ref, src_plane, n, 1, gen)
              for n in (8, 16, 32, 64)}
    for digest, lib in libs.items():
        me._libs["me_eval"] = lib
        for n, (blocks, _, mvs, cols) in inputs.items():
            err = eval_errors(me, ref, blocks, mvs, n, cols, ref1)
            for _, plane, _ in tie_planes(hp, wp):
                t_ref, t_blocks, _, t_mvs, _ = tie_inputs(plane, n, 2, gen,
                                                          "cuda")
                err = max(err, eval_errors(me, t_ref, t_blocks, t_mvs, n,
                                           cols,
                                           t_ref.roll(1, 1).contiguous()))
            occ = me.kernel_occupancy("me_eval", n)
            print(f"{digest} n={n}: max_abs_err {err}; "
                  f"{occ['blocks_per_sm']} blocks per SM of "
                  f"{occ['threads']} threads ({occ['sources']} source "
                  f"blocks each), {occ['smem']} B shared, {occ['regs']} "
                  f"registers, {occ['local']} B local", flush=True)
            if err:
                fail(f"{digest} differs from me_eval_plain at n={n}")

    # the timed pattern: a B frame with two reference pictures a list,
    # list 1 being list 0, each pair on its own pictures
    stack = torch.stack([ref, ref1])

    def args_of(blocks, mvs, k):
        # the indices of kernel_inputs name a stack of four: mod 2 here
        mv0, mv1, r0, r1 = mvs
        return (stack, stack, blocks) + tuple(
            a[:, :k].contiguous() for a in (mv0, mv1, r0 % 2, r1 % 2))
    bound = {}
    for n, (blocks, _, mvs, cols) in inputs.items():
        bound[n] = bound_ms([eval_work(n, blocks.shape[0], k, hp, wp,
                                       eval_pictures(args_of(blocks, mvs,
                                                             k)), s, p)
                             for k, s, p in EVAL_CALLS],
                            rates["me_eval"])[0]
    totals = {d: [] for d in libs}
    for r in range(rounds):
        for digest, lib in libs.items():
            me._libs["me_eval"] = lib
            tot = 0.0
            for n, (blocks, _, mvs, cols) in inputs.items():
                parts = []
                for k, want_satd, want_pred in EVAL_CALLS:
                    a = args_of(blocks, mvs, k)
                    parts.append(time_calls(lambda: me.launch_eval(
                        *a, n=n, cols=cols, maxv=255, want_satd=want_satd,
                        want_pred=want_pred), 20))
                size = sum(d for d, _ in parts)
                tot += size
                print(f"round {r} {digest} n={n}: " + ", ".join(
                    f"K={k}{' satd' if s else ''}{' pred' if p else ''} "
                    f"{d:.4f} (wall {w:.4f})"
                    for (k, s, p), (d, w) in zip(EVAL_CALLS, parts))
                    + f" ms; size {size:.4f} ms, bound {bound[n]:.4f} ms",
                    flush=True)
            totals[digest].append(tot)
    b = sum(bound.values())
    for digest, ts in totals.items():
        mean = sum(ts) / len(ts)
        runs = " / ".join(f"{t:.4f}" for t in ts)
        print(f"{digest}: B frame's 12 launches {runs} ms, "
              f"mean {mean:.4f} ms, bound {b:.4f} ms "
              f"({PIPE_LANES['me_eval'][0]} rate), {100 * b / mean:.1f}%",
              flush=True)
    print(name_limit)


if __name__ == "__main__":
    main(sys.argv[1:])
