#!/bin/bash
# chip call 1: phase 13 of chip_smoke.py alone (build, then selective
# encryption, field coding and tiles), then the new CUDA tests
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr13
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 perf_logs/pr13/phase13.py > chiprun_out/pr13/call1_phase13.log 2>&1
echo phase13_rc=$? wall_s=$(( $(date +%s) - t0 ))
python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py -k "crypto_field_tiles or mesh" > chiprun_out/pr13/call1_cuda_tests.log 2>&1
echo tests_rc=$?
tail -3 chiprun_out/pr13/call1_cuda_tests.log
grep -vE "^\s*$" chiprun_out/pr13/call1_phase13.log | cut -c1-400 | tail -80
