"""setup_s: process start to the window's first unit (loading, the
program's build of its kernels and native coder where the checkout has
none yet, the content's set-up, the encoder and the warm-up)."""


def read(run):
    return run.setup_s
