"""psnr_y_db: the mean luma PSNR of the quality frames, from the
program's reconstruction (recon_out, which the check holds to the
reference's decode) against the benchmark's source frame. The arithmetic
is a frozen copy of kvazaar_tpu_torch.api._psnr."""
import numpy as np


def psnr(src, rec, maxv: float = 255.0) -> float:
    mse = np.mean((src.astype(np.float64) - rec.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10.0 * np.log10(maxv ** 2 / mse))


def read(run):
    vals = [psnr(run.sources[k][0], run.coded[k]["info"]["recon_out"][0])
            for k in run.quality if k < len(run.coded)]
    return sum(vals) / len(vals) if vals else None
