#!/bin/bash
# first chip call of the working tree: phase 12 alone, then the CUDA
# tests of the variants
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr12
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 perf_logs/pr12/phase12.py > chiprun_out/pr12/call1_phase12.log 2>&1
echo phase12_rc=$? wall_s=$(( $(date +%s) - t0 ))
python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py -k variants > chiprun_out/pr12/call1_cuda_tests.log 2>&1
echo tests_rc=$?
tail -3 chiprun_out/pr12/call1_cuda_tests.log
grep -v "^  frame\|Warning\|warn" chiprun_out/pr12/call1_phase12.log | tail -40
grep "^  frame" chiprun_out/pr12/call1_phase12.log | cut -c1-400
