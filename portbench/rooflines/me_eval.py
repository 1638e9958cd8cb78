"""me_eval (kvazaar_tpu_torch/csrc/me_eval.cu), pair and one-list modes:
per candidate, each list's 8-tap passes and rounding; with SATDs, for
pairs the bi-average and three SATDs, for one list one SATD. Counts
frozen from chip_smoke.eval_work and eval_pictures: every input read
once (the reference planes that the call's indices name), every output
written once, a multiply-add counted as 2."""

KERNEL_NAME = "me_eval_kernel"
WRAP = ("kvazaar_tpu_torch.models.inter_md", "me_eval")


def work_from_shapes(n: int, L: int, K: int, hp: int, wp: int, planes: int,
                     want_satd: bool, want_pred: bool, lists: int = 2):
    sats = 3 if lists == 2 else 1
    nbytes = 4 * (planes * hp * wp + L * n * n + lists * L * K * 3
                  + (sats * L * K if want_satd else 0)
                  + (lists * L * n * n if want_pred else 0))
    per_pair = lists * ((n + 7) * n * 16 + n * n * 20)
    if want_satd:
        per_pair += (n * n * 4 if lists == 2 else 0) + sats * 9 * n * n
    return nbytes, L * K * per_pair


def pictures(s0, s1, r0, r1) -> int:
    """Distinct reference pictures a call reads: the planes its indices
    name, once where both lists share one stack (list 0's alone in the
    one-list mode)."""
    import torch
    if s1 is None:
        return int(r0.unique().numel())
    if s0 is s1:
        return int(torch.cat([r0.reshape(-1), r1.reshape(-1)])
                   .unique().numel())
    return int(r0.unique().numel() + r1.unique().numel())


def work(args, kwargs):
    """me_eval(ref0, ref1, src_blocks, mv0, mv1, r0, r1, *, n, cols, maxv,
    want_satd, want_pred); the planes are read from the indices once the
    stretch has ended (reading them waits for the device)."""
    s0, s1, blocks, mv0, _mv1, r0, r1 = args[:7]
    n, L, K = int(kwargs["n"]), int(blocks.shape[0]), int(mv0.shape[1])
    hp, wp = int(s0.shape[-2]), int(s0.shape[-1])
    want_satd = bool(kwargs.get("want_satd", True))
    want_pred = bool(kwargs.get("want_pred", False))
    lists = 1 if s1 is None else 2
    return lambda: work_from_shapes(n, L, K, hp, wp,
                                    pictures(s0, s1, r0, r1), want_satd,
                                    want_pred, lists)
