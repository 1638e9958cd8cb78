#!/bin/bash
# chip call 1: phase 15 alone with the mesh frame against tile by tile,
# the wave profile of two 1080p IDRs batched and unbatched, and the CUDA
# tests of the batched program and the mesh
cd "$(dirname "$0")/../.."
mkdir -p chiprun_out/pr15
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 perf_logs/pr15/phase15.py > chiprun_out/pr15/call1_phase15.log 2>&1
echo phase15_rc=$? wall_s=$(( $(date +%s) - t0 ))
t0=$(date +%s)
python3 tools/torch_profile.py --wave batch > chiprun_out/pr15/call1_profile_batch.log 2>&1
echo profile_rc=$? wall_s=$(( $(date +%s) - t0 ))
python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py -k "md_batch or mesh" > chiprun_out/pr15/call1_cuda_tests.log 2>&1
echo tests_rc=$?
tail -2 chiprun_out/pr15/call1_cuda_tests.log
grep -vE "Warning|warn" chiprun_out/pr15/call1_phase15.log | cut -c1-400 | tail -30
grep -vE "Warning|warn" chiprun_out/pr15/call1_profile_batch.log | cut -c1-300 | tail -40
