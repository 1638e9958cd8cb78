"""me_refine (kvazaar_tpu_torch/csrc/me_refine.cu): per block, the
integer search's SADs over K candidates and 49 positions, the sub-pel
passes and SATDs, the winning prediction. Counts frozen from
chip_smoke.refine_work: every input read once, every output written
once, the algorithm's integer operations (a multiply-add counted as 2)."""

KERNEL_NAME = "me_refine_kernel"
WRAP = ("kvazaar_tpu_torch.models.inter_md", "me_refine")


def work_from_shapes(n: int, L: int, K: int, hp: int, wp: int):
    nbytes = 4 * (hp * wp + L * n * n + L * K * 2 + 1
                  + L * 2 + L + L * n * n)
    per_block = (K * 49 * n * n * 3             # SAD: sub, abs, add
                 + 7 * (n + 8) * n * 16         # 7 horizontal 8-tap passes
                 + 49 * n * n * (20 + 9)        # vertical pass + SATD
                 + n * n * 20)                  # winning prediction
    return nbytes, L * per_block


def work(args, kwargs):
    """me_refine(ref [H, W], src_blocks [L, n, n], cands [L, K, 2], lam64,
    *, n, cols, ...)."""
    ref, blocks, cands = args[:3]
    counts = work_from_shapes(int(kwargs["n"]), int(blocks.shape[0]),
                              int(cands.shape[1]), int(ref.shape[-2]),
                              int(ref.shape[-1]))
    return lambda: counts
