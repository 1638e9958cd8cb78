"""The benchmark's plain reference: a frozen copy of the port's
validation HEVC decoder (decoder/decoder.py) and the host modules it
needs (bitstream, CABAC, tables, parameter sets, SEI, the spec's sample
operations, deblocking, SAO, motion compensation, residual syntax), with
imports local to this package. It imports nothing of kvazaar_tpu_torch,
kvazaar_tpu or jax, and takes nothing the program made but the stream
and the pictures it judges."""
