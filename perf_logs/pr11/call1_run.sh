#!/bin/bash
# one chip call: the smoke and the CUDA tests from the working tree
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr11
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 chip_smoke.py > chiprun_out/pr11/call1_chip_smoke.log 2>&1
echo smoke_rc=$? wall_s=$(( $(date +%s) - t0 ))
python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py > chiprun_out/pr11/call1_cuda_tests.log 2>&1
echo tests_rc=$?
tail -2 chiprun_out/pr11/call1_cuda_tests.log
grep -E "^smoke:|decode:|parity:|FAIL|WPP|LCU|QP \[|POC 0:" chiprun_out/pr11/call1_chip_smoke.log | tail -40
tail -3 chiprun_out/pr11/call1_chip_smoke.log
