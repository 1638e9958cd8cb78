"""Faults planted in the program for the control and the fault tests
(never in the benchmark's own runs): each is installed on the Encoder
and its pipeline from outside, after they are built.

- control: the search's costs in a lower precision: every SATD that the
  intra and inter searches compare (exact integers in the program)
  rounded to bfloat16 before it is compared, so that near ties are
  decided another way while the stream stays conformant.
- deblock_off: the configuration's deblocking filter left out of the
  program's reconstruction, while the stream still signals it.
- stale: a step that returns its state unchanged: the pipeline's submit
  calls return the first result they gave again.
- half: half of a batch left out: submit_many codes the first half of
  its pictures and returns them for the rest as well.
- alter: an answer altered where it is produced: one byte in the middle
  of every coded frame's slice data is flipped in finalize_frame.
"""
from __future__ import annotations


def _control(enc) -> None:
    import torch
    from kvazaar_tpu_torch.models import inter_md, intra_md
    pipe = enc._pipeline

    def low(t):
        return None if t is None else t.to(torch.bfloat16).to(t.dtype)

    def scoped(method, module):
        """method with its module's satd_tiles rounded while it runs."""
        def call(*a, **kw):
            orig = module.satd_tiles
            module.satd_tiles = lambda *x, **y: low(orig(*x, **y))
            try:
                return method(*a, **kw)
            finally:
                module.satd_tiles = orig
        return call
    pipe._leaf_rd = scoped(pipe._leaf_rd, intra_md)
    if not hasattr(pipe, "_me_sizes"):
        return
    me_sizes, eval_pairs = pipe._me_sizes, pipe._eval_pairs

    def me_low(*a, **kw):
        return {n: [(mv, low(s), p, c) for mv, s, p, c in v]
                for n, v in me_sizes(*a, **kw).items()}

    def eval_low(*a, **kw):
        s, p = eval_pairs(*a, **kw)
        return (None if s is None else tuple(low(x) for x in s)), p
    pipe._me_sizes, pipe._eval_pairs = me_low, eval_low
    pipe._inter_leaf_b = scoped(pipe._inter_leaf_b, inter_md)


def _deblock_off(enc) -> None:
    enc._pipeline.deblock = False


def _stale(enc) -> None:
    pipe = enc._pipeline
    for attr in ("submit_many", "submit_inter_b", "submit_inter"):
        if not hasattr(pipe, attr):
            continue
        fn = getattr(pipe, attr)
        memo = []

        def wrapper(*a, _fn=fn, _memo=memo, **kw):
            if not _memo:
                _memo.append(_fn(*a, **kw))
            return _memo[0]
        setattr(pipe, attr, wrapper)


def _half(enc) -> None:
    pipe = enc._pipeline
    fn = pipe.submit_many

    def wrapper(ys, cbs, crs, *a, **kw):
        k = max(1, len(ys) // 2)
        outs = fn(ys[:k], cbs[:k], crs[:k], *a, **kw)
        return (outs * ((len(ys) + k - 1) // k))[:len(ys)]
    pipe.submit_many = wrapper


def _alter(enc) -> None:
    fn = enc.finalize_frame

    def wrapper(meta):
        chunk, info = fn(meta)
        b = bytearray(chunk)
        i = len(b) * 2 // 3
        b[i] ^= 0x5A
        return bytes(b), info
    enc.finalize_frame = wrapper


FAULTS = {"control": _control, "deblock_off": _deblock_off,
          "stale": _stale, "half": _half, "alter": _alter}


def install(name: str, enc) -> None:
    FAULTS[name](enc)
