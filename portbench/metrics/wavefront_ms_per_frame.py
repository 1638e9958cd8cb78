"""wavefront_ms_per_frame: the intra pipeline's self-scheduled wavefront
(MdIntraPipeline._recon_md: all-intra pictures, and the intra part of
every B frame), its span synchronized at both ends, over the pictures
each call codes (a batch's call codes all of its pictures)."""

SPANS = {"wavefront": ("pipeline", "_recon_md")}


def read(run):
    sp = run.spans("wavefront")
    pics = sum(s.pics for s in sp)
    return 1e3 * sum(s.t1 - s.t0 for s in sp) / pics if pics else None
