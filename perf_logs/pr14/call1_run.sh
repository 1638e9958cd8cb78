#!/bin/bash
# chip call 1: phase 14 of chip_smoke.py alone (build, then the 16x16-grid
# pipelines and the host route of CTB 32), then the new CUDA tests
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr14
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 perf_logs/pr14/phase14.py > chiprun_out/pr14/call1_phase14.log 2>&1
echo phase14_rc=$? wall_s=$(( $(date +%s) - t0 ))
python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py -k "grid" > chiprun_out/pr14/call1_cuda_tests.log 2>&1
echo tests_rc=$?
tail -3 chiprun_out/pr14/call1_cuda_tests.log
grep -vE "^\s*$" chiprun_out/pr14/call1_phase14.log | cut -c1-400 | tail -80
